#!/usr/bin/env python3
"""H100 probe: convert 8-bit K/V to bf16 before the products, or multiply natively?

    python3 torch_tools/probe_int8.py [--iters N]

The port of ``scripts/probe_int8_decode.py``'s ``make`` (:35, its
``pallas_call`` :109) for this card, in its three flavors, through
``fa_probe_int8`` of ``flashattention_tpu_torch/csrc/probe_mma.cu``:

- ``bf16``: the tensor-core forward over bf16 K/V (``flash_fwd_tc``'s kernel);
- ``int8cvt``: over int8 K/V converted to bf16 in shared memory, the score
  columns times k_scale and P's columns times v_scale (``flash_fwd_tc_quant``'s
  kernel, the design the serving path runs);
- ``int8mma``: native ``wgmma`` s8 x s8 -> s32, q quantized per row in the
  kernel and p by 1 / 127, V transposed in shared memory each tile (an
  8-bit product reads K-major operands only).

At two shapes: the TPU probe's own (KVH = 8 heads of G = 8 query rows, d =
128, 16 pages of 256 rows: 4096 keys, every row sees every key; payloads
uniform in [-127, 127), every scale 0.01, no softmax scale; bf16 K/V
normal), and ``prefill_mha``'s widths (4 requests x 32 KV heads, a
512-row chunk at the longest request's context, 2048 keys, causal, scale
1/sqrt(128)) in the flat layout.  Each flavor is timed with CUDA events,
the L2 cache flushed before every call (a decode step finds its pages
cold); GB/s-equivalent is the K/V bytes (payload and scales, read once)
over the time, as the TPU probe counts them; each flavor's bound counts
its products at its own type's peak (int8's for ``int8mma``).
Every probe mode is first held against its plain version (``ops/probes.py``;
``chip_smoke.probe_checks``: ``int8mma``'s mirrors its 8-bit q and p and the
tile's largest V scale); each flavor here is timed beside its plain version
and SDPA over the K/V dequantized to bf16 (``chip_smoke.time_probe_int8``).
Prints one JSON line with the card's name and power limit and writes it to
``chiprun_out/probe_int8.json``.  Imports nothing of JAX.
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
        print("probe_int8: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from flashattention_tpu_torch.ops import decode, flash, probes, quant
    from flashattention_tpu_torch.utils import benchit

    torch.backends.cuda.matmul.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    report = {"checks": []}
    recs = chip_smoke.probe_checks(probes, decode, quant, gen, report)
    out = {"probe": "probe_int8", "card": name, "nvidia_smi": benchit.card_info(),
           "checks": recs, "ok": all(r["ok"] for r in recs)}
    if out["ok"]:
        out.update(chip_smoke.time_probe_int8(probes, benchit, gen, name, report,
                                              iters=args.iters))
        out["checks"] = report["checks"]
        out["ok"] = all(r["ok"] for r in report["checks"])
    print(json.dumps(out), flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "probe_int8.json"), "w") as fh:
        json.dump(out, fh, indent=1)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
