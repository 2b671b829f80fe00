#!/usr/bin/env python3
"""H100 probes of the d = 128 forward at the Llama-7B shape, on one card.

    python3 torch_tools/probe_d128.py [pipeline|b|c|f|d|e|all] [--iters N] [--check-only]

The ports of six TPU probes of the JAX package, at their shape (BH = 128,
S = 2048, d = 128, bf16, non-causal), through ``ops/probes.py``'s wrappers of
``csrc/probe_d128.cu``, ``csrc/probe_d128t.cu`` and ``csrc/probe_mma.cu``:

- ``pipeline``: ``scripts/probe_d128.py::pipeline_decomposition`` (:69,
  ``pallas_call`` :178), the forward built up stage by stage: skeleton
  (S = QK^T, O += S V), exp, maxexp (the running row max, no rescale or
  sums), full (the kernel itself; the TPU's ``scratch`` is the same
  recurrence), split2 (two independent (m, l, O) chains, probe_mma mode 4);
- ``b``: ``scripts/probe_d128b.py::build`` (:38, :73): pcast (S as one bf16
  term), qk_heavy / pv_heavy (probe_mma modes 1 and 2: the QK^T products
  and softmax alone, the PV products alone), the block_q sweep as 64 / 128
  / 192 query rows a block, bh2 (two (head, query-block) tiles a block);
- ``c``: ``scripts/probe_d128c.py::build`` (:45, :92): PV split into 2 / 4
  accumulators, V stored transposed (PV's B operand K-major), K stored
  transposed (QK^T's B operand MN-major), V all ones;
- ``f``: ``scripts/probe_d128f.py::build`` (:35, :56): the whole kernel at
  128 / 192 query rows a block x PV split 1 / 2;
- ``d``: ``scripts/probe_d128d.py::build`` (:45, :75), unscaled, float32 O:
  base (exp(S - m) V in the normal orientation), the transposed schedule
  t_vt / t_vtk (V stored (BH, d, S) or normally), t_full, t_o_norm;
- ``e``: ``scripts/probe_d128e.py::build`` (:41, :71): t_qk_heavy,
  t_pv_heavy (one product over every pair, the other over 128 keys),
  pv_bf16out (O rounded once to bf16), and its ``xla_m`` products (:98) on
  cuBLAS as yardsticks.

The TPU probes hold a whole 2048-key row in VMEM; here K and V stream
through the kernel's TMA ring in 128-row tiles, so each variant is the
nearest streaming stage (``csrc/probe_d128.cu`` maps each).  Every mode is
first held against its plain version at a small shape and over inputs
whose output is P's second bf16 term alone (chip_smoke.py's
``probe_checks``); a failure stops the run.  Then each row is timed with
CUDA events (TF/s counts 4 d flops a pair, 2 d for the one-product rows),
beside ``flash_fwd_tc`` (``ops.flash.flash_attention``) and SDPA on the
same inputs, each (source, mode)'s plain version run and timed once and
each row's output held against it; ``d`` and ``e`` on uniform inputs
(their scripts' ``make_random``), unscaled, beside SDPA at scale 1; a failed
row makes the exit code 1.
Prints one
JSON line with the card's name and power limit and writes it to
``chiprun_out/probe_d128.json``.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("group", nargs="?", default="all",
                    choices=["pipeline", "b", "c", "f", "d", "e", "all"])
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--check-only", action="store_true",
                    help="build the probe libraries and hold every probe mode against its plain "
                         "version, without timing")
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import torch

    if not torch.cuda.is_available():
        print("probe_d128: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from flashattention_tpu_torch.ops import decode, flash, kernels, probes, quant
    from flashattention_tpu_torch.utils import benchit

    torch.backends.cuda.matmul.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    out = {"probe": "probe_d128", "card": name, "nvidia_smi": benchit.card_info()}
    built = kernels.build_all(["probe_mma", "probe_d128_0", "probe_d128_1", "probe_d128_2",
                               "probe_d128t", "probe_fp32", "flash_fwd_tc", "paged_decode",
                               "paged_decode_tc", "paged_prefill", "paged_prefill_tc"])
    out["ptxas"] = {k: chip_smoke._ptxas(v["log"]) for k, v in built.items()
                    if k.startswith("probe")}
    gen = torch.Generator(device="cuda").manual_seed(0)
    report = {"checks": []}
    recs = chip_smoke.probe_checks(probes, decode, quant, gen, report)
    out["checks"] = report["checks"]
    ok = all(r["ok"] for r in recs)
    if ok and not args.check_only:
        groups = ((*chip_smoke.PROBE_D128_ROWS, *chip_smoke.PROBE_D128DE_ROWS)
                  if args.group == "all" else (args.group,))
        old = tuple(g for g in groups if g in chip_smoke.PROBE_D128_ROWS)
        new = tuple(g for g in groups if g in chip_smoke.PROBE_D128DE_ROWS)
        if old:
            out.update(chip_smoke.time_probe_d128(probes, flash, benchit, gen, name, report,
                                                  old, iters=args.iters))
        if new:
            out["d128de"] = chip_smoke.time_probe_d128de(probes, benchit, gen, name, report, new,
                                                         iters=args.iters)
        ok = all(r["ok"] for r in report["checks"])
    out["ok"] = ok
    print(json.dumps(out), flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "probe_d128.json"), "w") as fh:
        json.dump(out, fh, indent=1)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
