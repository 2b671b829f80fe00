#!/usr/bin/env python3
"""Mutation check of ``chip_smoke.py``'s checks of the tensor-core forms, on one card.

    python3 torch_tools/tc_mutants.py [--keep]

Copies the port (``flashattention_tpu_torch/`` and ``chip_smoke.py``) into a
temporary directory once per mutant, breaks one thing in the tensor-core
kernels' CUDA sources in the copy (``csrc/flash_fwd_tc.cuh``, whose paged
form ``csrc/paged_prefill_tc.cu`` builds, and ``csrc/flash_bwd_tc.cu``),
builds what the checks launch (the unmutated copy
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
  tile, in both backward kernels);
- ``page_index_off_by_one``: the paged form loads each box from the next
  physical page;
- ``v_tail_rows_unmasked``: the paged form leaves the V rows past the
  block's last visible column as the page holds them (the NaN-poison check);
- ``window_first_tile_late``: the KV loop starts one tile after the first
  tile a window reaches (the forward and the paged form);
- ``other_request_ctx_len``: each paged block reads the next request's
  context length;
- ``dk_dv_swapped/d256``: the d = 256 backward writes each warpgroup's
  accumulator to the other's output (dK as dV);
- ``y_read_before_barrier/d256``: its dS side reads P^T c (Y^T) from shared
  memory before the barrier that says it is written (the barrier stays, so
  the hand-offs keep their pairing);
- the 8-bit form of the forward template (``flash_fwd_tc_quant``,
  ``paged_prefill_tc_quant``): ``k_scale_dropped`` (score columns not
  multiplied by k_scale), ``v_scale_twice`` (P's columns multiplied by
  v_scale squared), ``convert_wrong_half`` (each bf16 chunk's conversion
  reads the payload bytes of the other half of its 64 columns),
  ``stale_fp8_row_not_zeroed`` (rows past the block's last visible column
  converted from the stage as it holds them: the fp8 NaN-poison check);
- the two-pass pair's tensor-core forms (``flash_bwd_dq_tc``,
  ``flash_bwd_dkv_tc``): ``segment_compare_dropped/dq`` (dQ's pairs live
  across documents), ``range_skip_off_by_one_tile`` (each tile's id range
  read from the next tile's entry, ``bwd_common.cuh``'s seg_range, in both
  kernels), ``dropout_inv_missing_from_dv`` (dV sums keep P, not keep P /
  (1 - rate); d <= 128), ``softcap_derivative_dropped_from_dk/d256`` (the
  d = 256 form's dS side takes Y^T = P, not P c) and
  ``dkv_first_gqa_group_only`` (dK/dV walk the query tiles of the first GQA
  group only);
- paged decode's tensor-core form (``paged_decode_tc``,
  ``paged_decode_tc_quant``): ``merge_empty_split_weight_one`` (the merge
  weights by 1 a split that is empty for a row: one that visited nothing,
  m = -inf, or saw only columns the row may not see, m = the mask value),
  ``v_rows_past_length_not_zeroed`` (a bf16 tile's V rows past the length
  kept as the stage holds them), ``v_scale_dropped`` (P's columns not
  multiplied by v_scale) and ``draft_row_limit_off_by_one`` (each row sees
  the column past its causal limit);
- the block-mask forms of the forward and the pair (their ``*_extra``
  libraries): ``bm_bits_ignored/<kernel>`` (a partial tile's element bits
  ignored, the tile taken as full) and ``bm_first_live_tile_skipped/<kernel>``
  (each block's walk starts at its second live tile).

Forward mutants run ``flash_checks`` and ``flash_window_checks``, paged
mutants ``prefill_checks``, ``prefill_window_checks`` and
``prefill_poison_check``, backward mutants ``bwd_checks``,
``bwd_window_checks`` (its q x 8 cases, Gemma-2's d = 256 among them) and
``dropout_checks``, untimed where the functions allow, the pair's mutants
the same with ``bwd_window_checks``' Gemma-2 packed case too, and the 8-bit
form's mutants the same forward and paged checks over int8 and fp8 K/V and
``prefill_poison_check``, paged decode's mutants ``paged_checks``,
``paged_window_checks`` and ``draft_checks`` in bf16, int8 and fp8,
``decode_poison_check`` and ``split_edge_checks``, the block-mask mutants
``block_mask_checks`` untimed.  The unmutated copy runs
the checks of every kind (of the kinds ``--mutants`` names, with it) and
must pass every check; a mutant is caught when a bf16 check of the kernel it
changed (``flash_fwd_tc/...``, ``paged_prefill_tc/...`` or
``flash_bwd_tc/...``; the 8-bit form's: ``flash_fwd_tc/quant/...`` or
``paged_prefill_tc/quant/...``; the pair's: ``flash_bwd_dq_tc/...`` or
``flash_bwd_dkv_tc/...``; paged decode's: ``paged_decode_tc/...``; the
block-mask forms': ``<kernel>/block_mask/...``) fails.  ``--mutants``
runs some of them (and the unmutated copy).  Prints one JSON line per copy and writes them
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
FWD, BWD, PP, Q8 = "flash_fwd_tc", "flash_bwd_tc", "paged_prefill_tc", "tc_quant"
PAIR, PAIR_ALL = "pair_tc", "pair_tc_common"  # the latter: an edit of bwd_common.cuh
PD = "paged_decode_tc"
# The block-mask forms of the forward and the pair (their *_extra libraries).
BM_FWD, BM_DQ, BM_DKV = "bm_flash_fwd_tc", "bm_flash_bwd_dq_tc", "bm_flash_bwd_dkv_tc"
# name -> (kernel, [(source, text, replacement)])
MUTANTS = {
    "unmutated": (None, []),
    "row_map_off_by_8": (FWD, [(
        "flash_fwd_tc.cuh", "const int pos = e < 2 ? pos_a : pos_b;",
        "const int pos = e < 2 ? pos_b : pos_a;")]),
    "alpha_not_applied": (FWD, [(
        "flash_fwd_tc.cuh", "acc[ch][4 * j + 0] *= alpha_a;\n          acc[ch][4 * j + 1] *= alpha_a;\n"
        "          acc[ch][4 * j + 2] *= alpha_b;\n          acc[ch][4 * j + 3] *= alpha_b;", "")]),
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
        "flash_bwd_tc.cu", "return make_int2(0, (rows + kRows - 1) / kRows);",
        "return make_int2(0, (rows + kRows - 1) / kRows - 1);")]),
    "page_index_off_by_one": (PP, [(
        "flash_fwd_tc.cuh", "const int page = table[t / pg.page_size];",
        "const int page = table[t / pg.page_size] + 1;")]),
    "v_tail_rows_unmasked": (PP, [(
        "flash_fwd_tc.cuh", "if (row < lo || row >= hi) vt[u]", "if (row < lo) vt[u]")]),
    "window_first_tile_late": (PP, [(
        "flash_fwd_tc.cuh", "r.begin = r.first - r.first % kN;",
        "r.begin = r.first - r.first % kN + kN;")]),
    "other_request_ctx_len": (PP, [(
        "flash_fwd_tc.cuh", "const int ctx = pg.ctx_lens[blockIdx.z];",
        "const int ctx = pg.ctx_lens[(blockIdx.z + 1) % gridDim.z];")]),
    "dk_dv_swapped/d256": (BWD, [(
        "flash_bwd_tc.cu", "OutT<kTerms>* out = p_side ? dv : dk;",
        "OutT<kTerms>* out = p_side ? dk : dv;")]),
    "y_read_before_barrier/d256": (BWD, [(
        "flash_bwd_tc.cu",
        "      tc::named_sync(1, 256);  // Y^T written\n      float y[kRows / 2];\n"
        "#pragma unroll\n      for (int j = 0; j < kRows / 2; ++j) y[j] = x_f[j * 128 + tid];\n",
        "      float y[kRows / 2];\n"
        "#pragma unroll\n      for (int j = 0; j < kRows / 2; ++j) y[j] = x_f[j * 128 + tid];\n"
        "      tc::named_sync(1, 256);  // Y^T written\n")]),
    "k_scale_dropped": (Q8, [(
        "flash_fwd_tc.cuh", "if constexpr (C::kQuant) x *= ks_t[8 * j + 2 * t + (e & 1)];", "")]),
    "v_scale_twice": (Q8, [(
        "flash_fwd_tc.cuh", "if constexpr (C::kQuant) p *= vs_t[8 * j + 2 * t + (e & 1)];",
        "if constexpr (C::kQuant) p *= vs_t[8 * j + 2 * t + (e & 1)] * vs_t[8 * j + 2 * t + (e & 1)];")]),
    "convert_wrong_half": (Q8, [(
        "flash_fwd_tc.cuh", "src + row * D + grp * 8", "src + row * D + (grp ^ 4) * 8")]),
    "stale_fp8_row_not_zeroed": (Q8, [(
        "flash_fwd_tc.cuh", "if (row >= lo && row < hi)\n      out = tc::cvt8_bf16",
        "if (row >= lo)\n      out = tc::cvt8_bf16")]),
    "segment_compare_dropped/dq": (PAIR, [(
        "flash_bwd_dq_tc.cu", "(!has_seg || seg_s[x] == (a ? seg_a : seg_b))", "true")]),
    "range_skip_off_by_one_tile": (PAIR_ALL, [(
        "bwd_common.cuh", "for (int t = r0 / kSegTile; t <",
        "for (int t = r0 / kSegTile + 1; t <")]),
    "dropout_inv_missing_from_dv": (PAIR, [(
        "flash_bwd_tc.cu", "st[4 * j + e] = dropout ? p * z : p;",
        "st[4 * j + e] = dropout && z == 0.f ? 0.f : p;")]),
    "softcap_derivative_dropped_from_dk/d256": (PAIR, [(
        "flash_bwd_tc.cu", "y[4 * j + e] = p * c_fac;", "y[4 * j + e] = p;")]),
    "dkv_first_gqa_group_only": (PAIR, [
        ("flash_bwd_tc.cu", f"{call}(ex, use_bm, kt, c0, rows, kv_len);  // the query tiles{end}",
         f"{call}(ex, use_bm, kt, c0, min(rows, q_seq_len), kv_len);  // the query tiles{end}")
        for call, end in (("walk", " to walk\n"), ("walk<kRows>", ", as above\n"))]),
    "merge_empty_split_weight_one": (PD, [(
        "paged_decode_tc.cu", "const float w = m == -INFINITY ? 0.f : tc::ex2((m - mm) * tc::kLog2e);",
        "const float w = m <= fa::kMaskValue ? 1.f : tc::ex2((m - mm) * tc::kLog2e);")]),
    "v_rows_past_length_not_zeroed": (PD, [(
        "paged_decode_tc.cu", "if (row < lo || row >= hi) vt[u]", "if (row < lo) vt[u]")]),
    "v_scale_dropped": (PD, [(
        "paged_decode_tc.cu",
        "if constexpr (C::kQuant) p[e] *= vs_t[kKeysW * warp + 8 * nb + 2 * t4 + (e & 1)];", "")]),
    "draft_row_limit_off_by_one": (PD, [(
        "paged_decode_tc.cu", "const int lim = length - draft_k + r % draft_k;",
        "const int lim = length - draft_k + r % draft_k + 1;")]),
    "bm_bits_ignored/flash_fwd_tc": (BM_FWD, [(
        "flash_fwd_tc.cuh", "bool keep = bit;", "bool keep = true;")]),
    "bm_bits_ignored/flash_bwd_dq_tc": (BM_DQ, [(
        "flash_bwd_dq_tc.cu",
        "live = a ? fa::tile_bit(bits_a, jj, e & 1) : fa::tile_bit(bits_b, jj, e & 1);",
        "live = true;")]),
    "bm_bits_ignored/flash_bwd_dkv_tc": (BM_DKV, [
        ("flash_bwd_tc.cu",
         f"\n{pad}live = e < 2 ? fa::tile_bit(bits_a, j, e & 1) : fa::tile_bit(bits_b, j, e & 1);",
         f"\n{pad}live = true;") for pad in (" " * 12, " " * 14)]),
    "bm_first_live_tile_skipped/flash_fwd_tc": (BM_FWD, [(
        "flash_fwd_tc.cuh", "bm = fa::bm_walk(ex, qt, kN, kv.end);\n    n_tiles = bm.y;",
        "bm = fa::bm_walk(ex, qt, kN, kv.end);\n    n_tiles = bm.y - 1;\n    bm.x += 1;")]),
    "bm_first_live_tile_skipped/flash_bwd_dq_tc": (BM_DQ, [(
        "flash_bwd_dq_tc.cu", "bm = fa::bm_walk(ex, qt, kN, kv.end);\n    n_tiles = bm.y;",
        "bm = fa::bm_walk(ex, qt, kN, kv.end);\n    n_tiles = bm.y - 1;\n    bm.x += 1;")]),
    "bm_first_live_tile_skipped/flash_bwd_dkv_tc": (BM_DKV, [(
        "flash_bwd_tc.cu", "if (use_bm) return fa::bm_walk(ex, kt, kRows, rows);",
        "if (use_bm) {\n    const int2 w = fa::bm_walk(ex, kt, kRows, rows);\n"
        "    return make_int2(w.x + 1, w.y - 1);\n  }")]),
}
MUTANT_SECONDS = 900  # one copy's checks; the unmutated copy's take about 4 minutes
# The libraries an edit of each kernel's source changes, that its checks launch.
_PAIR_LIBS = ["flash_bwd_dq_tc", "flash_bwd_dq_tc_extra", "flash_bwd_dkv_tc",
              "flash_bwd_dkv_tc_extra", "flash_bwd_tc", "flash_bwd_tc_extra"]
LIBS = {FWD: ["flash_fwd_tc", "flash_fwd_tc_extra"], BWD: ["flash_bwd_tc", "flash_bwd_tc_extra"],
        PP: ["paged_prefill_tc"], Q8: ["flash_fwd_tc_quant", "paged_prefill_tc_quant"],
        PAIR: _PAIR_LIBS, PD: ["paged_decode_tc", "paged_decode_tc_quant"],
        PAIR_ALL: [*_PAIR_LIBS, *(k + x for k in ("flash_bwd", "flash_bwd_dq", "flash_bwd_dkv")
                                   for x in ("", "_extra"))],
        BM_FWD: ["flash_fwd_tc_extra"], BM_DQ: ["flash_bwd_dq_tc_extra"],
        BM_DKV: ["flash_bwd_dkv_tc_extra"]}
# The check names that catch each kind's mutants (bf16 checks only).
CATCH = {FWD: ("flash_fwd_tc/",), BWD: ("flash_bwd_tc/",), PP: ("paged_prefill_tc/",),
         Q8: ("flash_fwd_tc/quant/", "paged_prefill_tc/quant/"),
         PAIR: ("flash_bwd_dq_tc/", "flash_bwd_dkv_tc/"),
         PAIR_ALL: ("flash_bwd_dq_tc/", "flash_bwd_dkv_tc/"), PD: ("paged_decode_tc/",),
         BM_FWD: ("flash_fwd_tc/block_mask/",), BM_DQ: ("flash_bwd_dq_tc/block_mask/",),
         BM_DKV: ("flash_bwd_dkv_tc/block_mask/",)}


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


def run_checks(root: str, kernel, kinds=None) -> dict:
    """In this process: chip_smoke's checks of ``kernel`` (with None, of
    every kind, or of ``kinds`` where given) on the copy at ``root``."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    import flashattention_tpu_torch as fa
    from flashattention_tpu_torch.ops import backward, decode, flash
    from flashattention_tpu_torch.utils import benchit, packing

    if not os.path.abspath(flash.__file__).startswith(root + os.sep):
        raise RuntimeError(f"flash came from {flash.__file__}, not {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    report = {"checks": []}
    gen = torch.Generator(device="cuda").manual_seed(0)
    card = torch.cuda.get_device_name(0)
    args = argparse.Namespace(seed=0)
    if kernel is None and kinds:  # the unmutated copy beside some mutants: their kinds' checks
        # Each kind's checks draw their inputs from a generator of their own
        # (seed 0); the three block-mask kinds run the same checks, once.
        for kind in dict.fromkeys(BM_FWD if k in (BM_FWD, BM_DQ, BM_DKV) else k for k in kinds):
            run_checks(root, kind)
        return _checks_so_far
    if kernel in (None, FWD):
        cs.flash_checks(fa, flash, benchit, gen, card, report)
        cs.flash_window_checks(fa, flash, benchit, gen, card, report)
    if kernel in (None, PP):
        cs.prefill_checks(decode, benchit, gen, card, report)
        cs.prefill_window_checks(decode, benchit, gen, card, report)
        cs.prefill_poison_check(decode, gen, report)
    if kernel in (None, Q8):
        for form in ("int8", "fp8"):
            cs.flash_checks(fa, flash, benchit, gen, card, report, form)
            cs.flash_window_checks(fa, flash, benchit, gen, card, report, form)
            cs.prefill_checks(decode, benchit, gen, card, report, form)
            cs.prefill_window_checks(decode, benchit, gen, card, report, form)
        if kernel:
            cs.prefill_poison_check(decode, gen, report)
    if kernel in (None, BWD, PAIR, PAIR_ALL):
        cs.bwd_checks(backward, flash, benchit, packing, args, gen, card, report)
        q8 = [n for n, c in cs.BWD_WINDOW_CASES
              if c["q_mult"] > 1 and c["d"] in (64, 128, 256)
              and ("docs" not in c or kernel in (None, PAIR, PAIR_ALL))]
        cs.bwd_window_checks(backward, flash, benchit, gen, card, report, names=q8, timed=False)
        cs.dropout_checks(fa, backward, flash, benchit, packing, args, gen, card, report,
                          timed=False)
    if kernel in (None, PD):
        for form in (None, "int8", "fp8"):
            cs.paged_checks(decode, benchit, gen, card, report, form)
            cs.paged_window_checks(decode, benchit, gen, card, report, form)
            cs.draft_checks(decode, benchit, gen, card, report, form)
        cs.decode_poison_check(decode, gen, report)
        cs.split_edge_checks(decode, gen, report)
    if kernel in (None, BM_FWD, BM_DQ, BM_DKV):
        cs.block_mask_checks(backward, flash, benchit, gen, card, report, timed=False)
    for c in report["checks"]:  # a check two kinds run fails if either run failed it
        if _checks_so_far.get(c["check"], {}).get("ok", True):
            _checks_so_far[c["check"]] = {k: c.get(k) for k in ("ok", "max_abs_err", "elem_err")}
    return _checks_so_far


_checks_so_far: dict = {}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--keep", action="store_true", help="keep the copies")
    ap.add_argument("--mutants", nargs="+", choices=[m for m in MUTANTS if m != "unmutated"],
                    help="run only these mutants (and the unmutated copy)")
    ap.add_argument("--one", nargs="+", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        sel = args.one[1] if len(args.one) > 1 else None
        kernel = None if sel is None or sel.startswith("kinds=") else sel
        kinds = sel[len("kinds="):].split(",") if sel and sel.startswith("kinds=") else None
        print(json.dumps(run_checks(args.one[0], kernel, kinds)), flush=True)
        return 0
    mutants = {m: MUTANTS[m] for m in ["unmutated", *(args.mutants or MUTANTS)] if m in MUTANTS}
    tmp = tempfile.mkdtemp(prefix="tc_mutants-")
    try:
        roots = {m: os.path.join(tmp, m.replace("/", "-")) for m in mutants}
        for m, (_, edits) in mutants.items():
            make_copy(roots[m], edits)
        build = ("import sys; sys.path.insert(0, sys.argv[1]); "
                 "from flashattention_tpu_torch.ops import kernels; "
                 "kernels.build_all(sys.argv[2:] or None)")
        procs = {m: subprocess.Popen([sys.executable, "-c", build, roots[m],
                                      *(LIBS[kernel] if kernel else [])])
                 for m, (kernel, _) in mutants.items()}
        if any(p.wait() != 0 for p in procs.values()):
            print("tc_mutants: a build failed", file=sys.stderr)
            return 1
        # A library's file name hashes its source and headers: the ones a
        # mutant left alone are the unmutated copy's.
        built = glob.glob(os.path.join(roots["unmutated"], "build", "torch_kernels", "*.so"))
        for m in mutants:
            dest = os.path.join(roots[m], "build", "torch_kernels")
            for so in built:
                if not os.path.exists(os.path.join(dest, os.path.basename(so))):
                    shutil.copy(so, dest)
        results, ok = {}, True
        # With --mutants, the unmutated copy runs the checks of their kinds only.
        kinds = sorted({k for k, _ in mutants.values() if k}) if args.mutants else []
        for m, (kernel, _) in mutants.items():
            extra = [kernel] if kernel else ([f"kinds={','.join(kinds)}"] if kinds else [])
            try:
                proc = subprocess.run(
                    [sys.executable, os.path.abspath(__file__), "--one", roots[m], *extra],
                    stdout=subprocess.PIPE, text=True, timeout=MUTANT_SECONDS)
            except subprocess.TimeoutExpired:  # a mutant that hangs is not caught by a check
                print(json.dumps({"copy": m, "kernel": kernel, "timeout_s": MUTANT_SECONDS,
                                  "caught": False}), flush=True)
                ok = False
                continue
            lines = proc.stdout.strip().splitlines()
            if proc.returncode != 0 or not lines:
                print(f"tc_mutants: {m} did not run (exit {proc.returncode})", file=sys.stderr)
                return 1
            checks = json.loads(lines[-1])
            failed = {c: r for c, r in checks.items() if not r["ok"]}
            caught = None
            if kernel:
                caught = any(c.startswith(CATCH[kernel]) and c.endswith("/bfloat16") for c in failed)
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
