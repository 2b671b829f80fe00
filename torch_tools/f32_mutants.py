#!/usr/bin/env python3
"""Mutation check of ``chip_smoke.py``'s checks of the forward's float32
form (``flash_fwd_tc_f32``), on one card.

    python3 torch_tools/f32_mutants.py [--keep]

Copies the port (``flashattention_tpu_torch/`` and ``chip_smoke.py``) into a
temporary directory once per mutant, breaks one product of the two-term
form in the copy's ``flash_fwd_tc.cuh`` (the ``kTerms`` form only; the bf16
and "bf16" forms keep theirs), builds the copy's ``flash_fwd_tc_f32`` and
``flash_fwd`` (all copies' ``nvcc`` started together) and runs chip_smoke's
``f32_form_checks`` untimed on the copy (both modes, d = 64 and 128, seven
input cases, among them ``ops.probes.lo_term_f32_qkv``'s).  The copies:

- ``unmutated``: the sources as they are; every check must pass;
- ``q_hi_k_lo_dropped`` / ``q_lo_k_hi_dropped``: one cross product of S left
  out (the product loop skips pair 1 or pair 2);
- ``p_lo_dropped``: P's second term left out of PV;
- ``v_lo_dropped``: V's second term left out of PV (only its first-term
  chunks read).

A mutant is caught when a ``"bf16_3x"`` check fails.  Prints one JSON line
per copy (its failed checks with their errors) and writes all of them to
``chiprun_out/f32_mutants.json``; exits non-zero when a mutant goes
uncaught or the unmutated copy fails a check.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join("flashattention_tpu_torch", "csrc")
SOURCE = "flash_fwd_tc.cuh"
LIBRARIES = ("flash_fwd_tc_f32", "flash_fwd")
# name -> [(text, replacement)] in SOURCE
MUTANTS = {
    "unmutated": [],
    "q_hi_k_lo_dropped": [("for (int pr = 0; pr < kQK; ++pr) {",
                           "for (int pr = 0; pr < kQK; pr += 1 + (pr == 0 && kQK > 1)) {")],
    "q_lo_k_hi_dropped": [("for (int pr = 0; pr < kQK; ++pr) {",
                           "for (int pr = 0; pr < kQK; pr += 1 + (pr == 1)) {")],
    "p_lo_dropped": [("if (p_lo) tc::wgmma_rs<1>(part, pl[kk], db, 1);",
                      "if (p_lo && kTerms < 3) tc::wgmma_rs<1>(part, pl[kk], db, 1);")],
    "v_lo_dropped": [("for (int c = 0; c < C::kChunks; ++c) {\n          const bool p_lo",
                      "for (int c = 0; c < (kTerms >= 3 ? kLC : C::kChunks); ++c) {\n"
                      "          const bool p_lo")],
}


def make_copy(dest: str, edits) -> None:
    shutil.copytree(os.path.join(REPO, "flashattention_tpu_torch"),
                    os.path.join(dest, "flashattention_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), dest)
    path = os.path.join(dest, CSRC, SOURCE)
    for text, replacement in edits:
        with open(path) as fh:
            code = fh.read()
        if code.count(text) != 1:
            raise RuntimeError(f"{SOURCE}: expected one {text!r}, found {code.count(text)}")
        with open(path, "w") as fh:
            fh.write(code.replace(text, replacement))


def run_checks(root: str) -> dict:
    """In this process: chip_smoke's float32-form checks on the copy at
    ``root``, untimed."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    import flashattention_tpu_torch as fa
    from flashattention_tpu_torch.ops import flash, probes
    from flashattention_tpu_torch.utils import benchit

    if not os.path.abspath(flash.__file__).startswith(root + os.sep):
        raise RuntimeError(f"flash came from {flash.__file__}, not {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    report = {"checks": []}
    gen = torch.Generator(device="cuda").manual_seed(0)
    cs.f32_form_checks(fa, flash, probes, benchit, gen, torch.cuda.get_device_name(0), report,
                       timed=False)
    return {c["check"]: {k: c.get(k) for k in ("ok", "rel_err", "exact_rel_err")}
            for c in report["checks"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--keep", action="store_true", help="keep the copies")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(run_checks(args.one)), flush=True)
        return 0
    tmp = tempfile.mkdtemp(prefix="f32_mutants-")
    try:
        roots = {m: os.path.join(tmp, m) for m in MUTANTS}
        for m, edits in MUTANTS.items():
            make_copy(roots[m], edits)
        builds = {
            m: subprocess.Popen([sys.executable, "-c", (
                "import sys; sys.path.insert(0, sys.argv[1]); "
                "from flashattention_tpu_torch.ops import kernels; "
                "kernels.build_all(sys.argv[2:])"), roots[m], *LIBRARIES])
            for m in MUTANTS
        }
        if any(p.wait() != 0 for p in builds.values()):
            print("f32_mutants: a build failed", file=sys.stderr)
            return 1
        results, ok = {}, True
        for m in MUTANTS:
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", roots[m]],
                                  stdout=subprocess.PIPE, text=True)
            lines = proc.stdout.strip().splitlines()
            if proc.returncode != 0 or not lines:
                print(f"f32_mutants: {m} did not run (exit {proc.returncode})", file=sys.stderr)
                return 1
            checks = json.loads(lines[-1])
            failed = {c: r for c, r in checks.items() if not r["ok"]}
            caught = None if m == "unmutated" else any(c.endswith("/bf16_3x") for c in failed)
            ok = ok and (not failed if m == "unmutated" else caught)
            rec = {"copy": m, "checks": len(checks), "failed": failed, "caught": caught}
            results[m] = {**rec, "all": checks}
            print(json.dumps(rec), flush=True)
        os.makedirs("chiprun_out", exist_ok=True)
        with open(os.path.join("chiprun_out", "f32_mutants.json"), "w") as fh:
            json.dump(results, fh, indent=1)
        print(json.dumps({"f32_mutants_ok": ok}), flush=True)
        return 0 if ok else 1
    finally:
        if not args.keep:
            shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
