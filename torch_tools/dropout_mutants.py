#!/usr/bin/env python3
"""Mutation check of ``chip_smoke.py``'s dropout and block-mask checks, on one card.

    python3 torch_tools/dropout_mutants.py [--keep]

Copies the port (``flashattention_tpu_torch/`` and ``chip_smoke.py``) into a
temporary directory once per mutant, breaks one thing in the copy, builds
what the checks launch (the dropout / block-mask forms' ``*_extra``
libraries; each mutant only those whose sources it changed, the others
taken from the unmutated copy; one ``nvcc`` per library, all started
together) and runs chip_smoke's ``dropout_checks`` or ``block_mask_checks``
on the copy, untimed.  The copies:

- ``unmutated``: the sources as they are; every check must pass;
- ``fwd_row_ignores_gqa_fold``: flash_fwd draws each row's bits at its
  position in its GQA group instead of its raw folded row, so the G groups
  of a KV head share their bits;
- ``l_summed_after_drop``: flash_fwd sums the dropped p into l, so the
  softmax's normalizer (and the saved l) lose the dropped weights;
- ``dv_from_undropped_p/<kernel>``: flash_bwd or flash_bwd_dkv sums dV from
  P instead of the kept P / (1 - rate);
- ``bh_and_seed_swapped``: the hash takes the head as the seed and the seed
  as the head (``common.cuh``, so in all four kernels);
- ``partial_tile_as_full/<kernel>``: flash_fwd, flash_bwd_dq or
  flash_bwd_dkv ignores a partial block-mask tile's element bits;
- ``dead_tile_not_skipped``: the host table lists every tile a query tile's
  row of tiles holds, dead ones as partial tiles with no live bit, so the
  kernels load and compute them (``ops/flash.py``'s ``BlockMask._classify``).

A dropout mutant is caught when, in bfloat16 and in float32, a dropout check
of each kernel it changed fails; a block-mask mutant, when a block-mask
check of each kernel it changed fails in both types, or, for the dead-tile
mutant, when the NaN-poison check fails.  Prints one JSON line per copy (its
failed checks with their errors) and writes all of them to
``chiprun_out/dropout_mutants.json``; exits non-zero when a mutant goes
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
BWD = ("flash_bwd", "flash_bwd_dq", "flash_bwd_dkv")
# The libraries of the dropout / block-mask forms (built with -DFA_EXTRA),
# the only ones the untimed checks launch.
FWD_LIBS = ("flash_fwd_extra", "flash_fwd_quant_extra")
BWD_LIBS = tuple(f"{k}_extra" for k in BWD)
_DV = ("const float p = kExtra ? pd.x * z : pd.x", "const float p = pd.x")
_PARTIAL_BWD = ("if (slot >= 0) live_pair = live_pair && ", "if (false) live_pair = live_pair && ")
# name -> (checks it runs, kernels it changes, libraries to build,
#          [(path under flashattention_tpu_torch/, text, replacement)])
MUTANTS = {
    "unmutated": ("both", (), (*FWD_LIBS, *BWD_LIBS), []),
    "fwd_row_ignores_gqa_fold": ("dropout", ("flash_fwd",), FWD_LIBS, [(
        "csrc/flash_fwd.cu", "fa::dropout_row_key(ex, bh, r0 + tid, q_seq_len)",
        "fa::dropout_row_key(ex, bh, (r0 + tid) % q_seq_len, q_seq_len)")]),
    "l_summed_after_drop": ("dropout", ("flash_fwd",), FWD_LIBS, [(
        "csrc/flash_fwd.cu",
        "for (int j = 0; j < kBlockKV; ++j) s[j] = (word >> j) & 1u ? s[j] * ex.inv : 0.f;",
        "float kept_sum = 0.f;\n"
        "        for (int j = 0; j < kBlockKV; ++j) {\n"
        "          s[j] = (word >> j) & 1u ? s[j] * ex.inv : 0.f;\n"
        "          kept_sum += s[j];\n"
        "        }\n"
        "        l_run += kept_sum - p_sum;")]),
    "dv_from_undropped_p/flash_bwd": ("dropout", ("flash_bwd",), ("flash_bwd_extra",),
                                      [("csrc/flash_bwd.cu", *_DV)]),
    "dv_from_undropped_p/flash_bwd_dkv": ("dropout", ("flash_bwd_dkv",), ("flash_bwd_dkv_extra",),
                                          [("csrc/flash_bwd_dkv.cu", *_DV)]),
    "bh_and_seed_swapped": ("dropout", ("flash_fwd", *BWD), (*FWD_LIBS, *BWD_LIBS), [(
        "csrc/common.cuh", "(ex.seed * 0x9E3779B9u + static_cast<unsigned>(bh) * 0x85EBCA6Bu)",
        "(static_cast<unsigned>(bh) * 0x9E3779B9u + ex.seed * 0x85EBCA6Bu)")]),
    "partial_tile_as_full/flash_fwd": ("block_mask", ("flash_fwd",), FWD_LIBS, [(
        "csrc/flash_fwd.cu", "if (slot >= 0) bm_word = ", "if (false) bm_word = ")]),
    "partial_tile_as_full/flash_bwd_dq": ("block_mask", ("flash_bwd_dq",),
                                          ("flash_bwd_dq_extra",),
                                          [("csrc/flash_bwd_dq.cu", *_PARTIAL_BWD)]),
    "partial_tile_as_full/flash_bwd_dkv": ("block_mask", ("flash_bwd_dkv",),
                                           ("flash_bwd_dkv_extra",),
                                           [("csrc/flash_bwd_dkv.cu", *_PARTIAL_BWD)]),
    "dead_tile_not_skipped": ("block_mask", ("nan_poison",), (), [
        ("ops/flash.py", "kind[i] = np.where(full, 1, np.where(live, 2, 0))",
         "kind[i] = np.where(full, 1, 2)"),
        ("ops/flash.py", "partial = np.nonzero(live & ~full)[0]", "partial = np.nonzero(~full)[0]"),
    ]),
}


def make_copy(dest: str, edits) -> None:
    shutil.copytree(os.path.join(REPO, "flashattention_tpu_torch"),
                    os.path.join(dest, "flashattention_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), dest)
    for source, text, replacement in edits:
        path = os.path.join(dest, "flashattention_tpu_torch", source)
        with open(path) as fh:
            code = fh.read()
        if code.count(text) != 1:
            raise RuntimeError(f"{source}: expected one {text!r}, found {code.count(text)}")
        with open(path, "w") as fh:
            fh.write(code.replace(text, replacement))


def run_checks(root: str, which: str) -> dict:
    """In this process: chip_smoke's dropout and/or block-mask checks on the
    copy at ``root``, untimed."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    import flashattention_tpu_torch as fa
    from flashattention_tpu_torch.ops import backward, flash
    from flashattention_tpu_torch.utils import benchit, packing

    if not os.path.abspath(flash.__file__).startswith(root + os.sep):
        raise RuntimeError(f"flash came from {flash.__file__}, not {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    report = {"checks": []}
    gen = torch.Generator(device="cuda").manual_seed(0)
    card = torch.cuda.get_device_name(0)
    args = argparse.Namespace(seed=0)
    if which in ("dropout", "both"):
        cs.dropout_checks(fa, backward, flash, benchit, packing, args, gen, card, report,
                          timed=False)
    if which in ("block_mask", "both"):
        cs.block_mask_checks(backward, flash, benchit, gen, card, report, timed=False)
    return {c["check"]: {k: c.get(k) for k in ("ok", "max_abs_err", "elem_err", "finite")}
            for c in report["checks"]}


def caught(which: str, kernels, failed) -> dict:
    """{dtype: whether a check of the mutant's kind failed for each kernel it
    changed} (the NaN-poison check is bfloat16 only)."""
    if kernels == ("nan_poison",):
        hit = any(c.startswith("block_mask/nan_poison") for c in failed)
        return {"bfloat16": hit}
    return {dt: all(any(c.startswith(f"{k}/{which}/") and c.endswith(f"/{dt}") for c in failed)
                    for k in kernels)
            for dt in ("bfloat16", "float32")}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--keep", action="store_true", help="keep the copies")
    ap.add_argument("--one", nargs=2, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(run_checks(*args.one)), flush=True)
        return 0
    tmp = tempfile.mkdtemp(prefix="dropout_mutants-")
    try:
        roots = {m: os.path.join(tmp, m.replace("/", "-")) for m in MUTANTS}
        for m, (_, _, _, edits) in MUTANTS.items():
            make_copy(roots[m], edits)
        builds = {
            m: subprocess.Popen([sys.executable, "-c", (
                "import sys; sys.path.insert(0, sys.argv[1]); "
                "from flashattention_tpu_torch.ops import kernels; "
                "kernels.build_all(sys.argv[2:])"), roots[m], *libs])
            for m, (_, _, libs, _) in MUTANTS.items() if libs
        }
        if any(p.wait() != 0 for p in builds.values()):
            print("dropout_mutants: a build failed", file=sys.stderr)
            return 1
        # The libraries a mutant left alone are the unmutated copy's (their
        # sources, and so their hashed file names, are the same).
        built = glob.glob(os.path.join(roots["unmutated"], "build", "torch_kernels", "*.so"))
        for m in MUTANTS:
            dest = os.path.join(roots[m], "build", "torch_kernels")
            os.makedirs(dest, exist_ok=True)
            for so in built:
                if not os.path.exists(os.path.join(dest, os.path.basename(so))):
                    shutil.copy(so, dest)
        results, ok = {}, True
        for m, (which, changed, _, _) in MUTANTS.items():
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--one", roots[m], which],
                stdout=subprocess.PIPE, text=True)
            lines = proc.stdout.strip().splitlines()
            if proc.returncode != 0 or not lines:
                print(f"dropout_mutants: {m} did not run (exit {proc.returncode})", file=sys.stderr)
                return 1
            checks = json.loads(lines[-1])
            failed = {c: r for c, r in checks.items() if not r["ok"]}
            got = caught(which, changed, failed) if changed else None
            ok = ok and (all(got.values()) if changed else not failed)
            rec = {"copy": m, "checks_run": which, "kernels": list(changed),
                   "checks": len(checks), "failed": failed, "caught": got}
            results[m] = {**rec, "all": checks}
            print(json.dumps(rec), flush=True)
        os.makedirs("chiprun_out", exist_ok=True)
        with open(os.path.join("chiprun_out", "dropout_mutants.json"), "w") as fh:
            json.dump(results, fh, indent=1)
        print(json.dumps({"dropout_mutants_ok": ok}), flush=True)
        return 0 if ok else 1
    finally:
        if not args.keep:
            shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
