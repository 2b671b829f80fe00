#!/usr/bin/env python3
"""H100 probes of the online softmax's own recurrence, on one card.

    python3 torch_tools/probe_softmax.py [--iters N]

The ports of ``scripts/probe_local_softmax.py``'s ``build`` (:41) and
``scripts/probe_chain.py``'s ``build`` (:40) for this card, at their shape
(BH = 16, S = 8192, d = 64, bf16, non-causal): the kernel of
``flashattention_tpu_torch/csrc/flash_fwd_tc.cuh`` built by
``csrc/probe_mma.cu`` in its probe modes.  Mode 0 is the forward itself;
3 is the "local" softmax (each KV tile exponentiated against its own row
max, its PV part and its sum then rescaled by exp(m_tile - m_next), so that
no exponential waits for the running max); 4 and 5 deal the KV tiles
round-robin to 2 and 4 independent (m, l, O) chains, merged at the end, so
that a tile's rescale waits on the tile 2 or 4 back, not the one before.
Modes 1 (QK^T products and softmax, no PV) and 2 (PV products on a constant
P) give the split of mode 0's time at this shape.  If the softmax stalled on
its recurrence, 3-5 would run faster than 0; if they do not, its time is
the work itself.  Every probe mode is first held against its plain
version (``ops/probes.py``; ``chip_smoke.probe_checks``), then each mode
here timed with CUDA events beside its plain version, flash_fwd_tc and
SDPA (``chip_smoke.time_probe_mma``).  Prints one JSON line with the card's
name and power limit and writes it to ``chiprun_out/probe_softmax.json``.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=30)
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import torch

    if not torch.cuda.is_available():
        print("probe_softmax: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from flashattention_tpu_torch.ops import decode, flash, probes, quant
    from flashattention_tpu_torch.utils import benchit

    torch.backends.cuda.matmul.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    report = {"checks": []}
    recs = chip_smoke.probe_checks(probes, decode, quant, gen, report)
    out = {"probe": "probe_softmax", "card": name, "nvidia_smi": benchit.card_info(),
           "checks": recs, "ok": all(r["ok"] for r in recs)}
    if out["ok"]:
        out.update(chip_smoke.time_probe_mma(probes, flash, benchit, gen, name, report, 64,
                                             iters=args.iters))
        out["checks"] = report["checks"]
        out["ok"] = all(r["ok"] for r in report["checks"])
    print(json.dumps(out), flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "probe_softmax.json"), "w") as fh:
        json.dump(out, fh, indent=1)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
