#!/usr/bin/env python3
"""H100 probe: what a plain stream of an attention call's bytes reaches on this card.

    python3 torch_tools/probe_stream.py [--iters N]

The port of ``scripts/probe_small_fp32.py``'s ``hbm_floor`` (:35, its
``pallas_call`` :43) for this card, through ``fa_probe_stream`` of
``flashattention_tpu_torch/csrc/probe_mma.cu``:

- ``hbm_floor``: the TPU probe's own shape and kernel, ``o = q + k + v`` over
  float32 (BH = 128, S = 1024, d = 64) tensors: three reads and one write
  of 33.6 MB each;
- ``page_walk``: paged decode's reads alone.  The K and V rows that
  ``paged_decode_tc`` reads (each request's live columns through its page
  table, from the window's first column), read by a streaming kernel in
  the same blocks (``ops.decode.decode_splits``) and folded into one word a
  block, beside ``paged_attention`` itself (the tensor-core form) on the
  same pools: at Gemma-2's decode shapes (8 KV heads, G = 2, d = 256,
  window 4096, softcap 50, pages of 256 rows, 24 a request; lengths 1,
  4096, 4097, 6000 as chip_smoke's windowed check, and 1537-1543 as
  serve_gemma2's profile), over bf16 and fp8 pages, and at Llama-7B's
  (32 KV heads, G = 1, d = 128, lengths 1-1088, 8 pages a request).

Each is timed with CUDA events, the L2 cache flushed before every call (a
decode step finds its pages cold).  GB/s is the bytes the call must move
(inputs read once, outputs written once; the page walk's K/V rows, the
decode's also q, o, the lengths, the table entries and, for fp8, the
scales) over its time; ``decode_over_walk`` is paged_attention's time over
the page walk's.  Every probe mode is first held against its plain version
(``ops/probes.py``; ``chip_smoke.probe_checks``: the page walk's folded
words against its plain version's, bit for bit), then these are timed beside
their plain versions (``chip_smoke.time_probe_stream``).  Prints one JSON
line with the card's name and power limit and writes it to
``chiprun_out/probe_stream.json``.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import torch

    if not torch.cuda.is_available():
        print("probe_stream: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from flashattention_tpu_torch.ops import decode, flash, probes, quant
    from flashattention_tpu_torch.utils import benchit

    torch.backends.cuda.matmul.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    report = {"checks": []}
    recs = chip_smoke.probe_checks(probes, decode, quant, gen, report)
    out = {"probe": "probe_stream", "card": name, "nvidia_smi": benchit.card_info(),
           "checks": recs, "ok": all(r["ok"] for r in recs)}
    if out["ok"]:
        out.update(chip_smoke.time_probe_stream(probes, decode, quant, benchit, gen, name, report,
                                                iters=args.iters))
        out["checks"] = report["checks"]
        out["ok"] = all(r["ok"] for r in report["checks"])
    print(json.dumps(out), flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "probe_stream.json"), "w") as fh:
        json.dump(out, fh, indent=1)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
