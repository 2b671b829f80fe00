#!/usr/bin/env python3
"""Mutation check of ``chip_smoke.py``'s windowed kernel checks, on one card.

    python3 torch_tools/window_mutants.py [--keep]

Copies the port (``flashattention_tpu_torch/`` and ``chip_smoke.py``) into a
temporary directory once per mutant, breaks one thing in the copy's CUDA
sources, builds the copy's kernels (one ``nvcc`` per kernel and copy, all
started together) and runs chip_smoke's windowed checks on the copy
(``flash_window_checks``, ``paged_window_checks``, ``prefill_window_checks``:
d = 256 with window 4096 and softcap 50, the same with q scaled by 8, and
d = 128 with window 4096; bfloat16 and float32).  The copies:

- ``unmutated``: the sources as they are; every check must pass;
- ``softcap_dropped``: ``fa::softcap`` returns the score uncapped
  (``common.cuh``, so all three serving kernels);
- ``window_plus_one/<kernel>``: the row mask keeps column pos - window, one
  column more than the window holds (``> win_lo`` becomes ``>= win_lo``), in
  one kernel.

A mutant is caught when a check of a kernel it changed fails, in bfloat16
(the precision the models serve in) and in float32.  Prints one
JSON line per copy (its failed checks with their errors) and writes all of
them to ``chiprun_out/window_mutants.json``; exits non-zero when a mutant
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
CHECKS = {  # kernel -> chip_smoke's windowed check of it
    "flash_fwd": "flash_window_checks",
    "paged_decode": "paged_window_checks",
    "paged_prefill": "prefill_window_checks",
}
# name -> (kernels it changes, [(source, text, replacement)])
MUTANTS = {
    "unmutated": (tuple(CHECKS), []),
    "softcap_dropped": (tuple(CHECKS), [(
        "common.cuh", "return cap > 0.f ? cap * tanhf(s / cap) : s;", "return s;")]),
    "window_plus_one/flash_fwd": (("flash_fwd",), [
        ("flash_fwd.cu", "col > win_lo", "col >= win_lo")]),
    "window_plus_one/paged_decode": (("paged_decode",), [
        ("paged_decode.cu", "col > win_lo", "col >= win_lo")]),
    "window_plus_one/paged_prefill": (("paged_prefill",), [
        ("paged_prefill.cu", "col > win_lo", "col >= win_lo")]),
}


def make_copy(dest: str, edits) -> None:
    shutil.copytree(os.path.join(REPO, "flashattention_tpu_torch"),
                    os.path.join(dest, "flashattention_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), dest)
    for source, text, replacement in edits:
        path = os.path.join(dest, CSRC, source)
        with open(path) as fh:
            code = fh.read()
        if code.count(text) != 1:
            raise RuntimeError(f"{source}: expected one {text!r}, found {code.count(text)}")
        with open(path, "w") as fh:
            fh.write(code.replace(text, replacement))


def run_checks(root: str, names) -> dict:
    """In this process: chip_smoke's windowed checks of ``names`` on the
    copy at ``root``."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    import flashattention_tpu_torch as fa
    from flashattention_tpu_torch.ops import decode, flash
    from flashattention_tpu_torch.utils import benchit

    if not os.path.abspath(decode.__file__).startswith(root + os.sep):
        raise RuntimeError(f"decode came from {decode.__file__}, not {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = torch.cuda.get_device_name(0)
    report = {"checks": []}
    for name in names:
        gen = torch.Generator(device="cuda").manual_seed(0)
        if name == "flash_fwd":  # the scalar kernel, also in bf16 (not its tensor-core form)
            with flash.scalar_forms():
                cs.flash_window_checks(fa, flash, benchit, gen, card, report)
        else:
            getattr(cs, CHECKS[name])(decode, benchit, gen, card, report)
    return {c["check"]: {k: c.get(k) for k in ("ok", "max_abs_err", "elem_err")}
            for c in report["checks"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--keep", action="store_true", help="keep the copies")
    ap.add_argument("--one", nargs="+", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(run_checks(args.one[0], args.one[1:])), flush=True)
        return 0
    tmp = tempfile.mkdtemp(prefix="window_mutants-")
    try:
        roots = {m: os.path.join(tmp, m.replace("/", "-")) for m in MUTANTS}
        for m, (_, edits) in MUTANTS.items():
            make_copy(roots[m], edits)
        builds = {
            m: subprocess.Popen([sys.executable, "-c", (
                "import sys; sys.path.insert(0, sys.argv[1]); "
                "from flashattention_tpu_torch.ops import kernels; "
                "kernels.build_all(sys.argv[2:])"), roots[m], *names])
            for m, (names, _) in MUTANTS.items()
        }
        if any(p.wait() != 0 for p in builds.values()):
            print("window_mutants: a build failed", file=sys.stderr)
            return 1
        results, ok = {}, True
        for m, (names, _) in MUTANTS.items():
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--one", roots[m], *names],
                stdout=subprocess.PIPE, text=True)
            lines = proc.stdout.strip().splitlines()
            if proc.returncode != 0 or not lines:
                print(f"window_mutants: {m} did not run (exit {proc.returncode})", file=sys.stderr)
                return 1
            checks = json.loads(lines[-1])
            failed = {c: r for c, r in checks.items() if not r["ok"]}
            caught = None if m == "unmutated" else {
                dt: any(c.endswith(f"/{dt}") for c in failed) for dt in ("bfloat16", "float32")}
            ok = ok and (not failed if m == "unmutated" else all(caught.values()))
            rec = {"copy": m, "kernels": list(names), "checks": len(checks),
                   "failed": failed, "caught": caught}
            results[m] = {**rec, "all": checks}
            print(json.dumps(rec), flush=True)
        os.makedirs("chiprun_out", exist_ok=True)
        with open(os.path.join("chiprun_out", "window_mutants.json"), "w") as fh:
            json.dump(results, fh, indent=1)
        print(json.dumps({"window_mutants_ok": ok}), flush=True)
        return 0 if ok else 1
    finally:
        if not args.keep:
            shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
