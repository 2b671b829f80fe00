#!/usr/bin/env python3
"""H100 probe of the tensor-core forward's two loop bodies, on one card.

    python3 torch_tools/probe_mma.py [--iters N]

The port of ``scripts/probe_mxu.py``'s ``_qk_like`` (:38, the QK^T product
with its exp) and ``_pv_like`` (:100, the PV product) for this card: the
kernel of ``flashattention_tpu_torch/csrc/flash_fwd_tc.cuh`` built by
``csrc/probe_mma.cu`` in three modes at row 1's shape (B = 4, H = 32,
S = 1024, d = 128, causal, bf16): 0 the whole forward, 1 its QK^T products
and softmax alone (masks, exp, the running max and sum; no PV products), 2
its PV products alone on a constant P (no QK^T products, no softmax).  Each
is timed with CUDA events; TFLOP/s counts 2 d flops per live pair for each
product (4 d for the whole kernel).  The modes share the producer's TMA
loads of K and V, so modes 1 + 2 against mode 0 says how much of the
forward's time is products and how much the softmax and masks around
them.  Every probe mode is first held against its plain version
(``ops/probes.py``; ``chip_smoke.probe_checks``); each mode here is timed
beside its plain version, flash_fwd_tc and SDPA
(``chip_smoke.time_probe_mma``).  Prints one JSON line with the card's
name and power limit and writes it to ``chiprun_out/probe_mma.json``.
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
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import torch

    if not torch.cuda.is_available():
        print("probe_mma: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from flashattention_tpu_torch.ops import decode, flash, probes, quant
    from flashattention_tpu_torch.utils import benchit

    torch.backends.cuda.matmul.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    report = {"checks": []}
    recs = chip_smoke.probe_checks(probes, decode, quant, gen, report)
    out = {"probe": "probe_mma", "card": name, "nvidia_smi": benchit.card_info(),
           "checks": recs, "ok": all(r["ok"] for r in recs)}
    if out["ok"]:
        out.update(chip_smoke.time_probe_mma(probes, flash, benchit, gen, name, report, 128,
                                             iters=args.iters))
        out["checks"] = report["checks"]
        out["ok"] = all(r["ok"] for r in report["checks"])
    print(json.dumps(out), flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "probe_mma.json"), "w") as fh:
        json.dump(out, fh, indent=1)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
