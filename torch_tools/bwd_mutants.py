#!/usr/bin/env python3
"""Mutation check of ``chip_smoke.py``'s windowed backward checks, on one card.

    python3 torch_tools/bwd_mutants.py [--keep]

Copies the port (``flashattention_tpu_torch/`` and ``chip_smoke.py``) into a
temporary directory once per mutant, breaks one thing in the backward
kernels' CUDA sources in the copy, builds what the checks launch (the
unmutated copy builds flash_fwd and the three backward kernels, each mutant
only the kernels it changed and takes the others' libraries from the
unmutated copy; one ``nvcc`` per library, all started together) and runs
chip_smoke's ``bwd_window_checks`` on the copy, untimed.  The copies:

- ``unmutated``: the sources as they are; every check must pass;
- ``window_plus_one/<kernel>``: the pair mask keeps column pos - window, one
  column more than the window holds;
- ``softcap_factor_dropped``: dS is not multiplied by the softcap's
  derivative 1 - (s_c / cap)^2 (in ``bwd_common.cuh``'s ``p_ds``, so in
  all three kernels);
- ``softcap_factor_uncapped``: the derivative is taken at the uncapped
  score s instead of the capped s_c (likewise);
- ``last_window_tile_skipped/<kernel>``: the band skip drops the last tile
  the window reaches (the query tile whose window starts in this key tile,
  or in flash_bwd_dq the key tile that holds the window's first column).

The unmutated copy runs every case of ``chip_smoke.BWD_WINDOW_CASES``; a
mutant the cases whose q is scaled by 8 (at unit scale no such mutant moves
a gradient beyond bfloat16 rounding; see chip_smoke.py).  A mutant is
caught when, in bfloat16 and in float32, a check of each kernel it changed
fails at Gemma-2's shape and, for the window and tile mutants, at
Mistral's (Mistral has no softcap).  Prints one JSON line per copy (its
failed checks with their errors) and writes all of them to
``chiprun_out/bwd_mutants.json``; exits non-zero when a mutant goes
uncaught or the unmutated copy fails a check.  The copies live in a
temporary directory, removed at the end unless ``--keep``.  Imports nothing
of JAX.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = ("flash_bwd", "flash_bwd_dq", "flash_bwd_dkv")
_SKIP = ("if (win_start > c0 + kTile - 1) continue;", "if (win_start > c0 - 1) continue;")
# kernel -> mutant -> (text, replacement) in the kernel's own source
EDITS = {
    "flash_bwd": {
        "window_plus_one": ("col >= first_t[i])", "col >= first_t[i] - 1)"),
        "last_window_tile_skipped": _SKIP,
    },
    "flash_bwd_dq": {
        "window_plus_one": ("col >= first)", "col >= first - 1)"),
        "last_window_tile_skipped": ("kv_begin -= kv_begin % kTile;",
                                     "kv_begin += kTile - kv_begin % kTile;"),
    },
    "flash_bwd_dkv": {
        "window_plus_one": ("col >= first_t[i])", "col >= first_t[i] - 1)"),
        "last_window_tile_skipped": _SKIP,
    },
}
# name -> (kernels it changes, [(source, text, replacement)]).  The softcap's
# derivative lives in one helper (bwd_common.cuh's p_ds), shared by all three.
MUTANTS = {"unmutated": ((), [])}
MUTANTS.update({f"{m}/{k}": ((k,), [(f"{k}.cu", *edit)])
                for k, muts in EDITS.items() for m, edit in muts.items()})
MUTANTS.update({
    "softcap_factor_dropped": (KERNELS, [(
        "bwd_common.cuh", "p * (dp - di) * scale * (1.f - t * t)", "p * (dp - di) * scale")]),
    "softcap_factor_uncapped": (KERNELS, [(
        "bwd_common.cuh", "const float t = s_c / cap;", "const float t = s / cap;")]),
})
# The shapes at which a mutant must fail: Gemma-2's, and Mistral's where it
# can (a softcap mutant changes nothing without a cap).
SHAPES = {"gemma2": "gemma2_", "mistral": "mistral_"}


def make_copy(dest: str, edits) -> None:
    shutil.copytree(os.path.join(REPO, "flashattention_tpu_torch"),
                    os.path.join(dest, "flashattention_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), dest)
    for source, text, replacement in edits:
        path = os.path.join(dest, "flashattention_tpu_torch", "csrc", source)
        with open(path) as fh:
            code = fh.read()
        if code.count(text) != 1:
            raise RuntimeError(f"{source}: expected one {text!r}, found {code.count(text)}")
        with open(path, "w") as fh:
            fh.write(code.replace(text, replacement))


def run_checks(root: str, names) -> dict:
    """In this process: chip_smoke's windowed backward checks (the cases
    ``names``, or all) on the copy at ``root``, untimed."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from flashattention_tpu_torch.ops import backward, flash
    from flashattention_tpu_torch.utils import benchit

    if not os.path.abspath(backward.__file__).startswith(root + os.sep):
        raise RuntimeError(f"backward came from {backward.__file__}, not {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    report = {"checks": []}
    gen = torch.Generator(device="cuda").manual_seed(0)
    cs.bwd_window_checks(backward, flash, benchit, gen, torch.cuda.get_device_name(0), report,
                         names=names or None, timed=False)
    return {c["check"]: {k: c.get(k) for k in ("ok", "max_abs_err", "elem_err")}
            for c in report["checks"]}


def caught(mutant: str, kernels, failed) -> dict:
    """{dtype: whether, for each kernel the mutant changed, a check of it
    failed at each shape it must}."""
    shapes = ("gemma2",) if mutant.startswith("softcap") else tuple(SHAPES)
    return {dt: all(any(c.startswith(f"{k}/{SHAPES[sh]}") and c.endswith(f"/{dt}")
                        for c in failed) for k in kernels for sh in shapes)
            for dt in ("bfloat16", "float32")}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--keep", action="store_true", help="keep the copies")
    ap.add_argument("--one", nargs="+", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(run_checks(args.one[0], args.one[1:])), flush=True)
        return 0
    sys.path.insert(0, REPO)
    import chip_smoke as cs

    q8_cases = [n for n, c in cs.BWD_WINDOW_CASES if c["q_mult"] > 1 and c["s_q"] > 4096]
    tmp = tempfile.mkdtemp(prefix="bwd_mutants-")
    try:
        roots = {m: os.path.join(tmp, m.replace("/", "-")) for m in MUTANTS}
        for m, (_, edits) in MUTANTS.items():
            make_copy(roots[m], edits)
        # A library's file name hashes the headers too: an edited header
        # changes flash_fwd's as well.
        builds = {
            m: subprocess.Popen([sys.executable, "-c", (
                "import sys; sys.path.insert(0, sys.argv[1]); "
                "from flashattention_tpu_torch.ops import kernels; "
                "kernels.build_all(sys.argv[2:])"), roots[m],
                *(changed or KERNELS),
                *(["flash_fwd"] if not changed or any(src.endswith(".cuh") for src, _, _ in edits)
                  else [])])
            for m, (changed, edits) in MUTANTS.items()
        }
        if any(p.wait() != 0 for p in builds.values()):
            print("bwd_mutants: a build failed", file=sys.stderr)
            return 1
        # The libraries a mutant left alone are the unmutated copy's (their
        # sources, and so their hashed file names, are the same).
        built = glob.glob(os.path.join(roots["unmutated"], "build", "torch_kernels", "*.so"))
        for m in MUTANTS:
            dest = os.path.join(roots[m], "build", "torch_kernels")
            for so in built:
                if not os.path.exists(os.path.join(dest, os.path.basename(so))):
                    shutil.copy(so, dest)
        results, ok = {}, True
        for m, (changed, _) in MUTANTS.items():
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--one", roots[m],
                 *(q8_cases if changed else [])],
                stdout=subprocess.PIPE, text=True)
            lines = proc.stdout.strip().splitlines()
            if proc.returncode != 0 or not lines:
                print(f"bwd_mutants: {m} did not run (exit {proc.returncode})", file=sys.stderr)
                return 1
            checks = json.loads(lines[-1])
            failed = {c: r for c, r in checks.items() if not r["ok"]}
            got = caught(m, changed, failed) if changed else None
            ok = ok and (all(got.values()) if changed else not failed)
            rec = {"copy": m, "kernels": list(changed), "checks": len(checks), "failed": failed,
                   "caught": got}
            results[m] = {**rec, "all": checks}
            print(json.dumps(rec), flush=True)
        os.makedirs("chiprun_out", exist_ok=True)
        with open(os.path.join("chiprun_out", "bwd_mutants.json"), "w") as fh:
            json.dump(results, fh, indent=1)
        print(json.dumps({"bwd_mutants_ok": ok}), flush=True)
        return 0 if ok else 1
    finally:
        if not args.keep:
            shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
