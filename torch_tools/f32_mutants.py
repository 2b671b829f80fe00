#!/usr/bin/env python3
"""Mutation check of ``chip_smoke.py``'s checks of the float32 forms: the
forward's (``flash_fwd_tc_f32``, and ``csrc/flash_fwd_f32.cuh``'s kernel in
it) and chunked prefill's over float32 pools (``paged_prefill_tc_f32``), on
one card.

    python3 torch_tools/f32_mutants.py [--keep] [--mutants NAME ...]

Copies the port (``flashattention_tpu_torch/`` and ``chip_smoke.py``) into a
temporary directory once per mutant, breaks one product, term or bound in
the copy's source, builds the copy's ``flash_fwd_tc_f32``, ``flash_fwd``
and ``paged_prefill_tc_f32`` (all copies' ``nvcc`` started together) and
runs chip_smoke's ``f32_form_checks`` untimed (three modes, d = 64, 128 and
256, the input cases among them ``ops.probes.lo_term_f32_qkv``'s,
``lo3_term_f32_qkv``'s and ``v3_term_f32_qkv``'s) and the float32 cases of
``prefill_poison_check`` on the copy.  The copies:

- ``unmutated``: the sources as they are; every check must pass;
- in the two-term form (``flash_fwd_tc.cuh``'s ``kTerms``; caught by a
  ``flash_fwd_tc_f32/.../bf16_3x`` check): ``q_hi_k_lo_dropped`` /
  ``q_lo_k_hi_dropped``, one cross product of S left out;
  ``p_lo_dropped``, P's second term left out of PV; ``v_lo_dropped``, V's;
- in the three-term form (``flash_fwd_f32.cuh``, ``kT`` 3; caught by a
  ``flash_fwd_f32/.../float32`` check): ``x1y3_dropped``,
  ``x2y2_dropped``, ``x3y1_dropped``, one third-term product left out of S
  and PV; ``v3_dropped``, V's third term left out of PV;
- in its paged form (caught by a ``paged_prefill_tc_f32/...`` check):
  ``paged_rows_unzeroed``, rows outside the block's columns split as read
  (stale pages and unloaded boxes reach the products);
  ``paged_page_off_by_one``, each box from the table's next entry.

Prints one JSON line per copy (its failed checks with their errors) and
writes all of them to ``chiprun_out/f32_mutants.json``; exits non-zero when
a mutant goes uncaught or the unmutated copy fails a check.  Imports
nothing of JAX.
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
LIBRARIES = ("flash_fwd_tc_f32", "flash_fwd", "paged_prefill_tc_f32")
TWO, THREE = "flash_fwd_tc.cuh", "flash_fwd_f32.cuh"
_S_PAIR = "tc::wgmma_ss<0, 0>(s_lo, da, db, c > 0 || pr > 0 || kk > 0);"
_PV_PAIR = "tc::wgmma_rs<1>(part, pt[pair_a(kT, pr)][kk], db, pr > 0 || kk > 0);"


def _drop_pair(i):
    """flash_fwd_f32.cuh's pair i of the three-term form left out of S and
    PV (its pairs, small first: (2,0) x3 y1, (1,1) x2 y2, (0,2) x1 y3, ...);
    the first product issued still starts each sum afresh."""
    first = f"pr > {int(i == 0)}"
    return (THREE, [
        (_S_PAIR, f"if (kT != 3 || pr != {i}) tc::wgmma_ss<0, 0>(s_lo, da, db, c > 0 || {first} "
                  "|| kk > 0);"),
        (_PV_PAIR, f"if (kT != 3 || pr != {i}) tc::wgmma_rs<1>(part, pt[pair_a(kT, pr)][kk], db, "
                   f"{first} || kk > 0);")])


# name -> (source, [(text, replacement)], the prefix and suffix of the
# checks that must catch it)
MUTANTS = {
    "unmutated": (TWO, [], None),
    "q_hi_k_lo_dropped": (TWO, [("for (int pr = 0; pr < kQK; ++pr) {",
                                 "for (int pr = 0; pr < kQK; pr += 1 + (pr == 0 && kQK > 1)) {")],
                          ("flash_fwd_tc_f32/", "/bf16_3x")),
    "q_lo_k_hi_dropped": (TWO, [("for (int pr = 0; pr < kQK; ++pr) {",
                                 "for (int pr = 0; pr < kQK; pr += 1 + (pr == 1)) {")],
                          ("flash_fwd_tc_f32/", "/bf16_3x")),
    "p_lo_dropped": (TWO, [("if (p_lo) tc::wgmma_rs<1>(part, pl[kk], db, 1);",
                            "if (p_lo && kTerms < 3) tc::wgmma_rs<1>(part, pl[kk], db, 1);")],
                     ("flash_fwd_tc_f32/", "/bf16_3x")),
    "v_lo_dropped": (TWO, [("for (int c = 0; c < C::kChunks; ++c) {\n          const bool p_lo",
                            "for (int c = 0; c < (kTerms >= 3 ? kLC : C::kChunks); ++c) {\n"
                            "          const bool p_lo")],
                     ("flash_fwd_tc_f32/", "/bf16_3x")),
    "x3y1_dropped": (*_drop_pair(0), ("flash_fwd_f32/", "/float32")),
    "x2y2_dropped": (*_drop_pair(1), ("flash_fwd_f32/", "/float32")),
    "x1y3_dropped": (*_drop_pair(2), ("flash_fwd_f32/", "/float32")),
    "v3_dropped": (THREE, [(_PV_PAIR, "if (pair_b(kT, pr) != 2) " + _PV_PAIR)],
                   ("flash_fwd_f32/", "/float32")),
    "paged_rows_unzeroed": (THREE, [("C::kCTerm, 0, kv.first - t0,\n                       kv.end - t0, tid);",
                                     "C::kCTerm, 0, kPaged ? 0 : kv.first - t0,\n"
                                     "                       kPaged ? kN : kv.end - t0, tid);")],
                            ("paged_prefill_tc_f32/", "")),
    "paged_page_off_by_one": (THREE, [("table[t / pg.page_size]);",
                                       "table[min(t / pg.page_size + 1, pg.pages_per_seq - 1)]);")],
                              ("paged_prefill_tc_f32/", "")),
}


def make_copy(dest: str, source: str, edits) -> None:
    shutil.copytree(os.path.join(REPO, "flashattention_tpu_torch"),
                    os.path.join(dest, "flashattention_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), dest)
    path = os.path.join(dest, CSRC, source)
    for text, replacement in edits:
        with open(path) as fh:
            code = fh.read()
        if code.count(text) != 1:
            raise RuntimeError(f"{source}: expected one {text!r}, found {code.count(text)}")
        with open(path, "w") as fh:
            fh.write(code.replace(text, replacement))


def run_checks(root: str) -> dict:
    """In this process: chip_smoke's float32-form checks, untimed, and its
    float32 paged-prefill poison checks on the copy at ``root``."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    import flashattention_tpu_torch as fa
    from flashattention_tpu_torch.ops import decode, flash, probes
    from flashattention_tpu_torch.utils import benchit

    if not os.path.abspath(flash.__file__).startswith(root + os.sep):
        raise RuntimeError(f"flash came from {flash.__file__}, not {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    report = {"checks": []}
    gen = torch.Generator(device="cuda").manual_seed(0)
    cs.f32_form_checks(fa, flash, probes, benchit, gen, torch.cuda.get_device_name(0), report,
                       timed=False)
    cs.prefill_poison_check(decode, gen, report, dtypes=("float32",))
    return {c["check"]: {k: c.get(k) for k in ("ok", "rel_err", "exact_rel_err", "max_abs_err",
                                               "plain_err", "bitwise_equal")}
            for c in report["checks"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--keep", action="store_true", help="keep the copies")
    ap.add_argument("--mutants", nargs="+", choices=list(MUTANTS)[1:],
                    help="run only these mutants (and the unmutated copy)")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(run_checks(args.one)), flush=True)
        return 0
    names = ["unmutated", *(args.mutants or list(MUTANTS)[1:])]
    tmp = tempfile.mkdtemp(prefix="f32_mutants-")
    try:
        roots = {m: os.path.join(tmp, m) for m in names}
        for m in names:
            make_copy(roots[m], *MUTANTS[m][:2])
        builds = {
            m: subprocess.Popen([sys.executable, "-c", (
                "import sys; sys.path.insert(0, sys.argv[1]); "
                "from flashattention_tpu_torch.ops import kernels; "
                "kernels.build_all(sys.argv[2:])"), roots[m], *LIBRARIES])
            for m in names
        }
        if any(p.wait() != 0 for p in builds.values()):
            print("f32_mutants: a build failed", file=sys.stderr)
            return 1
        results, ok = {}, True
        for m in names:
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", roots[m]],
                                  stdout=subprocess.PIPE, text=True)
            lines = proc.stdout.strip().splitlines()
            if proc.returncode != 0 or not lines:
                print(f"f32_mutants: {m} did not run (exit {proc.returncode})", file=sys.stderr)
                return 1
            checks = json.loads(lines[-1])
            failed = {c: r for c, r in checks.items() if not r["ok"]}
            want = MUTANTS[m][2]
            caught = None if want is None else any(
                c.startswith(want[0]) and c.endswith(want[1]) for c in failed)
            ok = ok and (not failed if want is None else caught)
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
