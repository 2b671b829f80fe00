#!/usr/bin/env python3
"""Mutation check of ``chip_smoke.py``'s draft-form checks, on one card.

    python3 torch_tools/draft_mutants.py [--keep]

Copies the port (``flashattention_tpu_torch/`` and ``chip_smoke.py``) into a
temporary directory once per mutant, breaks one thing in the copy's
``csrc/paged_decode.cu`` draft form, builds the copy's paged decode
libraries (``paged_decode`` and ``paged_decode_draft``; one ``nvcc`` per
library and copy, all started together) and runs chip_smoke's
``draft_checks`` on the copy (k = 4 at the Llama, Mistral, Gemma-2 (q x 1
and x 8), G = 8 and window-2 shapes, bfloat16 and float32; untimed) under
``ops.flash.scalar_forms``, so that every case, float32 ones too (whose
calls otherwise take the tensor-core float32 form), runs the scalar
kernel.  The copies:

- ``unmutated``: the sources as they are; every check must pass;
- ``causal_plus_one``: row dp's causal limit is ``length - k + dp + 1``;
- ``rows_k_major``: a row's draft position is read k-major, ``r / G``,
  instead of k-minor, ``r % k``;
- ``first_page_from_last_row``: the page loop starts at the page of the
  last row's window (``length - 1 - window + 1``), not row 0's
  (``length - k - window + 1``);
- ``window_from_last_row``: every row's window starts where the last row's
  does (``length - 1 - window``).

A mutant is caught when a check fails in bfloat16 and in float32.  Prints
one JSON line per copy (its failed checks with their errors) and writes all
of them to ``chiprun_out/draft_mutants.json``; exits non-zero when a mutant
goes uncaught or the unmutated copy fails a check.  The copies live in a
temporary directory, removed at the end unless ``--keep``.  Imports nothing
of JAX.
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
LIBS = ("paged_decode", "paged_decode_draft")  # the timed k = 1 launches need the first
# name -> [(text, replacement)] in paged_decode.cu
MUTANTS = {
    "unmutated": [],
    "causal_plus_one": [("lim[g] = length - draft_k + dp;", "lim[g] = length - draft_k + dp + 1;")],
    "rows_k_major": [("const int dp = (row0 + g) % draft_k;",
                      "const int dp = (row0 + g) / (rows / draft_k);")],
    "first_page_from_last_row": [("(length - kq - window + 1) / page_size",
                                  "(length - 1 - window + 1) / page_size")],
    "window_from_last_row": [("lo[g] = windowed ? lim[g] - window : -1;",
                              "lo[g] = windowed ? length - 1 - window : -1;")],
}


def make_copy(dest: str, edits) -> None:
    shutil.copytree(os.path.join(REPO, "flashattention_tpu_torch"),
                    os.path.join(dest, "flashattention_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), dest)
    path = os.path.join(dest, CSRC, "paged_decode.cu")
    with open(path) as fh:
        code = fh.read()
    for text, replacement in edits:
        if code.count(text) != 1:
            raise RuntimeError(f"paged_decode.cu: expected one {text!r}, found {code.count(text)}")
        code = code.replace(text, replacement)
    with open(path, "w") as fh:
        fh.write(code)


def run_checks(root: str) -> dict:
    """In this process: chip_smoke's draft checks on the copy at ``root``."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from flashattention_tpu_torch.ops import decode, flash
    from flashattention_tpu_torch.utils import benchit

    if not os.path.abspath(decode.__file__).startswith(root + os.sep):
        raise RuntimeError(f"decode came from {decode.__file__}, not {root}")
    benchit.cuda_time_ms = lambda fn, *a, **kw: (fn(*a), 0.0)[1]  # checks only: one call
    card = torch.cuda.get_device_name(0)
    report = {"checks": []}
    with flash.scalar_forms():
        cs.draft_checks(decode, benchit, torch.Generator(device="cuda").manual_seed(0), card, report)
    return {c["check"]: {k: c.get(k) for k in ("ok", "max_abs_err", "elem_err")}
            for c in report["checks"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--keep", action="store_true", help="keep the copies")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(run_checks(args.one)), flush=True)
        return 0
    tmp = tempfile.mkdtemp(prefix="draft_mutants-")
    try:
        roots = {m: os.path.join(tmp, m) for m in MUTANTS}
        for m, edits in MUTANTS.items():
            make_copy(roots[m], edits)
        builds = [
            subprocess.Popen([sys.executable, "-c", (
                "import sys; sys.path.insert(0, sys.argv[1]); "
                "from flashattention_tpu_torch.ops import kernels; "
                "kernels.build_all(sys.argv[2:])"), roots[m], lib])
            for m in MUTANTS for lib in LIBS
        ]
        if any(p.wait() != 0 for p in builds):
            print("draft_mutants: a build failed", file=sys.stderr)
            return 1
        results, ok = {}, True
        for m in MUTANTS:
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", roots[m]],
                                  stdout=subprocess.PIPE, text=True)
            lines = proc.stdout.strip().splitlines()
            if proc.returncode != 0 or not lines:
                print(f"draft_mutants: {m} did not run (exit {proc.returncode})", file=sys.stderr)
                return 1
            checks = json.loads(lines[-1])
            failed = {c: r for c, r in checks.items() if not r["ok"]}
            caught = None if m == "unmutated" else {
                dt: any(c.endswith(f"/{dt}") for c in failed) for dt in ("bfloat16", "float32")}
            ok = ok and (not failed if m == "unmutated" else all(caught.values()))
            rec = {"copy": m, "checks": len(checks), "failed": failed, "caught": caught}
            results[m] = {**rec, "all": checks}
            print(json.dumps(rec), flush=True)
        os.makedirs("chiprun_out", exist_ok=True)
        with open(os.path.join("chiprun_out", "draft_mutants.json"), "w") as fh:
            json.dump(results, fh, indent=1)
        print(json.dumps({"draft_mutants_ok": ok}), flush=True)
        return 0 if ok else 1
    finally:
        if not args.keep:
            shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
