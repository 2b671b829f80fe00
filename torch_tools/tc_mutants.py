#!/usr/bin/env python3
"""Mutation check of ``chip_smoke.py``'s checks of the tensor-core forms, on one card.

    python3 torch_tools/tc_mutants.py [--keep]

Copies the port (``flashattention_tpu_torch/`` and ``chip_smoke.py``) into a
temporary directory once per mutant, breaks one thing in the tensor-core
kernels' CUDA sources in the copy (``csrc/flash_fwd_tc.cuh``,
``csrc/flash_bwd_tc.cu``), builds what the checks launch (the unmutated copy
every library, each mutant only the libraries its edit changes, taking the
others from the unmutated copy; one ``nvcc`` per library, all started
together) and runs chip_smoke's checks of the mutated kernel on the copy:

- ``row_map_off_by_8``: the forward's masks take each thread's row g as
  row g + 8 of its 16-row slab and the reverse (the accumulator fragment's
  row map off by 8);
- ``alpha_not_applied``: the forward does not rescale O by the running
  max's correction when the max moves;
- ``causal_off_by_one/<kernel>``: a row sees the column just past its
  position (forward: the pair mask; backward: each row's last column);
- ``ds_without_softcap``: the backward's dS lacks the softcap's derivative;
- ``dv_from_undropped_p``: the backward's dV sums P, not the dropped Z;
- ``last_tma_stage_skipped/<kernel>``: the producer and the consumers stop
  one tile early (the forward's last KV tile, the backward's last query
  tile).

Forward mutants run ``flash_checks`` and ``flash_window_checks``, backward
mutants ``bwd_checks``, ``bwd_window_checks`` (its q x 8 cases) and
``dropout_checks``, untimed where the functions allow.  The unmutated copy
runs all of them and must pass every check; a mutant is caught when a bf16
check of the kernel it changed (``flash_fwd_tc/...`` or
``flash_bwd_tc/...``) fails.  Prints one JSON line per copy and writes them
to ``chiprun_out/tc_mutants.json``; exits non-zero when a mutant goes
uncaught or the unmutated copy fails a check.  Imports nothing of JAX.
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
FWD, BWD = "flash_fwd_tc", "flash_bwd_tc"
# name -> (kernel, [(source, text, replacement)])
MUTANTS = {
    "unmutated": (None, []),
    "row_map_off_by_8": (FWD, [(
        "flash_fwd_tc.cuh", "const int pos = e < 2 ? pos_a : pos_b;",
        "const int pos = e < 2 ? pos_b : pos_a;")]),
    "alpha_not_applied": (FWD, [(
        "flash_fwd_tc.cuh", "acc[4 * j + 0] *= alpha_a;\n          acc[4 * j + 1] *= alpha_a;\n"
        "          acc[4 * j + 2] *= alpha_b;\n          acc[4 * j + 3] *= alpha_b;", "")]),
    "causal_off_by_one/flash_fwd_tc": (FWD, [(
        "flash_fwd_tc.cuh", "(!causal || col <= pos)", "(!causal || col <= pos + 1)")]),
    "causal_off_by_one/flash_bwd_tc": (BWD, [(
        "flash_bwd_tc.cu", "fa_bwd::row_limit(r, rows, kv_len, q_offset, q_seq_len, causal);",
        "min(kv_len - 1, fa_bwd::row_limit(r, rows, kv_len, q_offset, q_seq_len, causal) + 1);")]),
    "ds_without_softcap": (BWD, [(
        "flash_bwd_tc.cu", "* scale * c_fac;", "* scale;")]),
    "dv_from_undropped_p": (BWD, [(
        "flash_bwd_tc.cu", "st[4 * j + e] = dropout ? p * z : p;", "st[4 * j + e] = p;")]),
    "last_tma_stage_skipped/flash_fwd_tc": (FWD, [(
        "flash_fwd_tc.cuh", "(kv.end - kv.begin + kN - 1) / kN : 0;",
        "(kv.end - kv.begin + kN - 1) / kN - 1 : 0;")]),
    "last_tma_stage_skipped/flash_bwd_tc": (BWD, [(
        "flash_bwd_tc.cu", "(rows + kBlockM - 1) / kBlockM : 0;",
        "(rows + kBlockM - 1) / kBlockM - 1 : 0;")]),
}
# The libraries an edit of each source changes.
LIBS = {FWD: ["flash_fwd_tc", "flash_fwd_tc_extra"], BWD: ["flash_bwd_tc", "flash_bwd_tc_extra"]}


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


def run_checks(root: str, kernel) -> dict:
    """In this process: chip_smoke's checks of ``kernel`` (both with None)
    on the copy at ``root``."""
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
    if kernel in (None, FWD):
        cs.flash_checks(fa, flash, benchit, gen, card, report)
        cs.flash_window_checks(fa, flash, benchit, gen, card, report)
    if kernel in (None, BWD):
        cs.bwd_checks(backward, flash, benchit, packing, args, gen, card, report)
        q8 = [n for n, c in cs.BWD_WINDOW_CASES if c["q_mult"] > 1 and c["d"] in (64, 128)]
        cs.bwd_window_checks(backward, flash, benchit, gen, card, report, names=q8, timed=False)
        cs.dropout_checks(fa, backward, flash, benchit, packing, args, gen, card, report,
                          timed=False)
    return {c["check"]: {k: c.get(k) for k in ("ok", "max_abs_err", "elem_err")}
            for c in report["checks"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--keep", action="store_true", help="keep the copies")
    ap.add_argument("--one", nargs="+", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        kernel = args.one[1] if len(args.one) > 1 else None
        print(json.dumps(run_checks(args.one[0], kernel)), flush=True)
        return 0
    tmp = tempfile.mkdtemp(prefix="tc_mutants-")
    try:
        roots = {m: os.path.join(tmp, m.replace("/", "-")) for m in MUTANTS}
        for m, (_, edits) in MUTANTS.items():
            make_copy(roots[m], edits)
        build = ("import sys; sys.path.insert(0, sys.argv[1]); "
                 "from flashattention_tpu_torch.ops import kernels; "
                 "kernels.build_all(sys.argv[2:] or None)")
        procs = {m: subprocess.Popen([sys.executable, "-c", build, roots[m],
                                      *(LIBS[kernel] if kernel else [])])
                 for m, (kernel, _) in MUTANTS.items()}
        if any(p.wait() != 0 for p in procs.values()):
            print("tc_mutants: a build failed", file=sys.stderr)
            return 1
        # A library's file name hashes its source and headers: the ones a
        # mutant left alone are the unmutated copy's.
        built = glob.glob(os.path.join(roots["unmutated"], "build", "torch_kernels", "*.so"))
        for m in MUTANTS:
            dest = os.path.join(roots[m], "build", "torch_kernels")
            for so in built:
                if not os.path.exists(os.path.join(dest, os.path.basename(so))):
                    shutil.copy(so, dest)
        results, ok = {}, True
        for m, (kernel, _) in MUTANTS.items():
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--one", roots[m],
                 *([kernel] if kernel else [])], stdout=subprocess.PIPE, text=True)
            lines = proc.stdout.strip().splitlines()
            if proc.returncode != 0 or not lines:
                print(f"tc_mutants: {m} did not run (exit {proc.returncode})", file=sys.stderr)
                return 1
            checks = json.loads(lines[-1])
            failed = {c: r for c, r in checks.items() if not r["ok"]}
            caught = None
            if kernel:
                caught = any(c.startswith(f"{kernel}/") and c.endswith("/bfloat16") for c in failed)
            ok = ok and (caught if kernel else not failed)
            rec = {"copy": m, "kernel": kernel, "checks": len(checks), "failed": failed,
                   "caught": caught}
            results[m] = {**rec, "all": checks}
            print(json.dumps(rec), flush=True)
        os.makedirs("chiprun_out", exist_ok=True)
        with open(os.path.join("chiprun_out", "tc_mutants.json"), "w") as fh:
            json.dump(results, fh, indent=1)
        print(json.dumps({"tc_mutants_ok": ok}), flush=True)
        return 0 if ok else 1
    finally:
        if not args.keep:
            shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
