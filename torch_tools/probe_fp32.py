#!/usr/bin/env python3
"""H100 probe of float32 attention as two bf16 terms, on one card.

    python3 torch_tools/probe_fp32.py [--iters N] [--check-only]

The port of ``scripts/probe_small_fp32b.py::build`` (:45, ``pallas_call``
:101) at its shape (BH = 128, S = 1024, d = 64, float32 inputs, unscaled,
non-causal), through ``ops/probes.py``'s wrapper of ``csrc/probe_fp32.cu``:
the packed float32 path's machine products built up in stages (skeleton:
S = q . k + q . k_swap over [hi | lo] rows, P = S, P's two terms against
[v_hi | v_lo | 1]; exp: P = exp(S - 5); full: the softmax) beside one bf16
S and PV (bf16_skel).  Every mode is first held against its plain version
at a small shape and over inputs whose output is S's second bf16 term alone
(chip_smoke.py's ``probe_checks``, which also hold every other probe); a
failure stops the run.  Then each mode is timed with CUDA events at the
TPU probe's shape, its output held against its plain version there, beside
its bound (the logical work, 4 d flops a pair over the bf16 peak, and the
machine work, four times that for the packed modes), SDPA in float32 and
the port's own float32 ``flash_attention`` (the scalar kernel) on the same
inputs; a failed row makes the exit code 1.  Prints one JSON line with the
card's name and power limit and writes it to ``chiprun_out/probe_fp32.json``.
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
    ap.add_argument("--check-only", action="store_true",
                    help="build the probe libraries and hold every probe mode against its plain "
                         "version, without timing")
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import torch

    if not torch.cuda.is_available():
        print("probe_fp32: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from flashattention_tpu_torch.ops import decode, flash, kernels, probes, quant
    from flashattention_tpu_torch.utils import benchit

    torch.backends.cuda.matmul.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    out = {"probe": "probe_fp32", "card": name, "nvidia_smi": benchit.card_info()}
    built = kernels.build_all(["probe_mma", "probe_d128_0", "probe_d128_1", "probe_d128_2",
                               "probe_d128t", "probe_fp32", "flash_fwd", "paged_decode",
                               "paged_decode_tc", "paged_prefill", "paged_prefill_tc"])
    out["ptxas"] = {k: chip_smoke._ptxas(v["log"]) for k, v in built.items()
                    if k.startswith("probe")}
    gen = torch.Generator(device="cuda").manual_seed(0)
    report = {"checks": []}
    recs = chip_smoke.probe_checks(probes, decode, quant, gen, report)
    out["checks"] = report["checks"]
    ok = all(r["ok"] for r in recs)
    if ok and not args.check_only:
        out["fp32"] = chip_smoke.time_probe_fp32(probes, flash, benchit, gen, name, report,
                                                 iters=args.iters)
        ok = all(r["ok"] for r in report["checks"])
    out["ok"] = ok
    print(json.dumps(out), flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "probe_fp32.json"), "w") as fh:
        json.dump(out, fh, indent=1)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
