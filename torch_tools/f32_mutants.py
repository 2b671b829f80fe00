#!/usr/bin/env python3
"""Mutation check of ``chip_smoke.py``'s checks of the float32 forms: the
forward's (``flash_fwd_tc_f32``, and ``csrc/flash_fwd_f32.cuh``'s kernel in
it), chunked prefill's over float32 pools (``paged_prefill_tc_f32``),
paged decode's over float32 pages (``paged_decode_tc_f32``) and float32
training's (the fused backward's ``flash_bwd_tc_f32[_extra]``, the
forward's dropout form ``flash_fwd_tc_f32_extra``), on one card.

    python3 torch_tools/f32_mutants.py [--keep] [--pair-only | --decode-only] [--mutants NAME ...]

Copies the port (``flashattention_tpu_torch/`` and ``chip_smoke.py``) into a
temporary directory once per mutant, breaks one product, term or bound in
the copy's source, builds the copy's libraries (LIBRARIES: the unmutated
copy's first, whose files every other copy starts from, so that a copy
rebuilds only what its edit changes; then all the others' ``nvcc``
together) and runs chip_smoke's ``f32_form_checks`` untimed (three modes, d
= 64, 128 and 256, the input cases among them
``ops.probes.lo_term_f32_qkv``'s, ``lo3_term_f32_qkv``'s and
``v3_term_f32_qkv``'s), the float32 cases of ``prefill_poison_check``,
``f32_train_checks`` (the backward's and the dropout forward's float32
forms, "bf16_3x" and "bf16", d = 64 and 128, the backward's at 256 too)
and ``pair_f32_checks`` (the two-pass pair's float32 forms, the same
modes, d = 64, 128 and 256) on the copy; with ``--pair-only`` ``pair_f32_checks`` alone (the pair's mutants);
with ``--decode-only`` paged decode's float32 checks alone (the decode
mutants': ``decode_f32_term_checks``, the float32 cases of
``draft_checks`` (untimed), ``decode_poison_check`` and
``split_edge_checks``, which the full run runs too), building only the
paged decode libraries.
The copies:

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
  ``paged_page_off_by_one``, each box from the table's next entry;
- in the fused backward's float32 form (``flash_bwd_tc.cu``'s ``kTerms``,
  both of its kernels: d = 64 the d <= 128 one, d = 128 the wide one;
  caught by a ``flash_bwd_tc_f32/...`` check and, where the pair's dK/dV
  pass shares the edited code, a ``flash_bwd_dkv_tc_f32/...`` one): one of
  the three products of each of the five matmuls left out,
  ``s_k_hi_q_lo_dropped`` (S^T = K Q^T), ``dp_v_lo_do_hi_dropped`` (dP^T =
  V dO^T), ``dv_z_lo_do_hi_dropped`` (dV += Z^T dO),
  ``dk_ds_hi_q_lo_dropped`` (dK += dS^T Q), ``dq_ds_lo_k_hi_dropped`` (dQ
  += dS K, the fused form's alone); ``do_lo_zeroed``, dO's lo term zeroed
  after the backward's split pass (``tc_common.cuh``'s split_bwd, which the
  pair's dQ pass runs too: caught by the pair's checks as well);
  ``z_bits_on_ds``, Z's dropout bits (keep / (1 - rate)) applied to dS;
- in the fused backward's float32 form at d = 256 over two terms (the wide
  kernel over 32-row query tiles, dQ as K^T dS^T; each mutant breaks that
  instantiation alone and must be caught by a
  ``flash_bwd_tc_f32/.../d256/bf16_3x`` check):
  ``fused256_dq_ds_hi_k_lo_dropped`` (dQ's dS hi against K's lo),
  ``fused256_dk_ds_hi_q_lo_dropped`` (dK's dS hi against Q's lo) and
  ``fused256_ds_read_before_barrier`` (the P side's dQ products read X
  before the barrier that says dS is written);
- in the pair's float32 forms (``flash_bwd_dq_tc.cu``'s ``kTerms`` and
  ``flash_bwd_tc.cu``'s ``kPair`` with ``kTerms``; caught by a
  ``flash_bwd_dq_tc_f32/...`` or ``flash_bwd_dkv_tc_f32/...`` check):
  ``dq_lolo_dropped`` / ``dkv_lolo_dropped``, the lo lo products of the d =
  64 pass left out (three products a matmul, as at d = 128: caught on the
  norm, d = 64 "bf16_3x"); one product of each of the dQ pass's matmuls left
  out, ``dq_s_q_hi_k_lo_dropped`` (S = Q K^T), ``dq_dp_do_lo_v_hi_dropped``
  (dP = dO V^T), ``dq_dq_ds_hi_k_lo_dropped`` (dQ += dS K);
  ``pair_range_skip_live_tile``, tiles whose id
  ranges only touch at one id taken as disjoint (``bwd_common.cuh``'s
  seg_meet), so live tiles across a document's boundary are skipped;
- in the pair's float32 forms at d = 256 over two terms (the dQ pass's
  64-row blocks over 32-row key tiles, the wide dK/dV kernel over 32-row
  query tiles; each mutant breaks that instantiation alone and must be
  caught by a ``.../d256/bf16_3x`` check): one product of each matmul left
  out, ``dq256_s_q_lo_k_hi_dropped`` (S), ``dq256_dp_do_hi_v_lo_dropped``
  (dP), ``dq256_dq_ds_hi_k_lo_dropped`` (dQ += dS K),
  ``dkv256_s_k_hi_q_lo_dropped`` (S^T), ``dkv256_dp_v_lo_do_hi_dropped``
  (dP^T), ``dkv256_dv_z_lo_do_hi_dropped`` (dV), ``dkv256_dk_ds_hi_q_lo_dropped``
  (dK); ``d256_do_lo_zeroed``, dO's lo term zeroed after the split pass at
  d = 256; ``d256_half_tile_range_empty``, a 32-row tile read off the
  segment range table with the 64-row bound, so that every tile that
  starts a table entry finds an empty range and is skipped;
- in paged decode's float32 form (``paged_decode_tc.cu`` built with
  ``-DFA_F32``): ``decode_x3y1_dropped``, q's third term against K's first
  left out of S (caught by a ``paged_decode_tc_f32/lo3_term/...`` check);
  ``decode_p3_dropped``, P's third term left out of P V (a
  ``paged_decode_tc_f32/p3_term/...`` check); ``decode_v_rows_unzeroed``, V
  rows outside [first, end) read as they are (a
  ``paged_decode_tc_f32/nan_poison/...`` check); ``decode_rows_k_major``, a
  row's draft position read k-major, ``r / G``, instead of k-minor, ``r %
  k`` (a ``paged_decode_tc_f32/draft_k4_...`` check).

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
LIBRARIES = ("flash_fwd_tc_f32", "flash_fwd", "paged_prefill_tc_f32", "flash_fwd_tc_f32_extra",
             "flash_bwd_tc_f32", "flash_bwd_tc_f32_extra", "flash_bwd", "flash_bwd_extra",
             "flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_dq_extra", "flash_bwd_dkv_extra",
             "flash_bwd_dq_tc_f32", "flash_bwd_dq_tc_f32_extra", "flash_bwd_dkv_tc_f32",
             "flash_bwd_dkv_tc_f32_extra")
# Paged decode's float32 form and the scalar kernels the timed draft checks'
# twins launch (all that --decode-only builds).
DECODE_LIBRARIES = ("paged_decode_tc_f32", "paged_decode", "paged_decode_draft")
LIBRARIES += DECODE_LIBRARIES
TWO, THREE, BWD = "flash_fwd_tc.cuh", "flash_fwd_f32.cuh", "flash_bwd_tc.cu"
DECODE = "paged_decode_tc.cu"
DQ, COMMON, TC_COMMON = "flash_bwd_dq_tc.cu", "bwd_common.cuh", "tc_common.cuh"
FUSED, PAIR_DQ, PAIR_DKV = ("flash_bwd_tc_f32/", ""), ("flash_bwd_dq_tc_f32/", ""), (
    "flash_bwd_dkv_tc_f32/", "")
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


# The backward's mutants: copies of its product helpers with one product
# left out, inserted before the originals' users, and the call sites of one
# matmul (in the d <= 128 kernel and, by warpgroup, in the wide one) sent
# to them.
_TERM_PRODUCTS = """template <int D, int kP, int R>
__device__ __forceinline__ void term_products_mut(float (&acc)[R], uint32_t a, uint32_t a_chunk,
                                                  uint32_t b, uint32_t b_chunk) {
  constexpr int kLC = D / tc::kChunk;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int pr = 0; pr < kP; ++pr) {
      if (pr == SKIP) continue;
      const uint32_t ac = (pr >> 1) * kLC + kk / 4, bc = (pr & 1) * kLC + kk / 4;
      tc::wgmma_ss<0, 0>(acc, tc::make_desc(a + ac * a_chunk + (kk % 4) * 32, 16, 1024),
                         tc::make_desc(b + bc * b_chunk + (kk % 4) * 32, 16, 1024),
                         kk > 0 || pr > 0);
    }
  }
}

"""
_ADD_PRODUCTS = """template <int D, int kTerms, int kRows = Cfg<D, kTerms>::kRows>
__device__ __forceinline__ void add_products_mut(float (&acc)[D / 2],
                                                 const uint32_t (&ah)[kRows / 16][4],
                                                 const uint32_t (&al)[kRows / 16][4],
                                                 uint32_t b_tile) {
  constexpr int kLC = Cfg<D, kTerms>::kLC, kQChunk = Cfg<D, kTerms>::kQChunk;
#pragma unroll
  for (int c = 0; c < kLC; ++c) {
    float part[32];
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      const uint64_t db = tc::make_desc(b_tile + c * kQChunk + kk * 2048, kQChunk, 1024);
      tc::wgmma_rs<1>(part, ah[kk], db, kk > 0);
      if (SKIP != 1) tc::wgmma_rs<1>(part, al[kk], db, 1);
      if (kTerms == 2 && SKIP != 2)
        tc::wgmma_rs<1>(part, ah[kk],
                        tc::make_desc(b_tile + (kLC + c) * kQChunk + kk * 2048, kQChunk, 1024), 1);
    }
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
    tc::fence_regs(part);
#pragma unroll
    for (int x = 0; x < 32; ++x) acc[32 * c + x] += part[x];
  }
}

"""
_TP_ANCHOR = "// Whether the block of key rows [c0, c0 + kKeys) has any live pair with"
_AP_ANCHOR = "// dQ's half of the tile's columns from chunk c0 on"
_WIDE_SP = "    term_products<D, kProducts<D, kPair, kTerms>>(st, a_base, kKVChunk, b_base, kQChunk);\n"


def _term_mutant(skip, main_call, p_side):
    """S^T's (``p_side``) or dP^T's product ``skip`` (1: A hi B lo, 2: A lo
    B hi) left out in both kernels."""
    mut = _WIDE_SP.replace("term_products", "term_products_mut")
    side = "p_side" if p_side else "!p_side"
    return (BWD, [(_TP_ANCHOR, _TERM_PRODUCTS.replace("SKIP", str(skip)) + _TP_ANCHOR),
                  (main_call, main_call.replace("term_products", "term_products_mut")),
                  (_WIDE_SP, f"    if ({side}) {mut.strip()}\n    else {_WIDE_SP.strip()}\n")],
            [FUSED, PAIR_DKV])


def _add_mutant(skip, main_edit, wide_call):
    """dV's (the wide kernel's P side) or dK's (its dS side) product
    ``skip`` (1: A's lo against B's hi, 2: A's hi against B's lo) left out
    in both kernels (``main_edit`` the d <= 128 kernel's)."""
    return (BWD, [(_AP_ANCHOR, _ADD_PRODUCTS.replace("SKIP", str(skip)) + _AP_ANCHOR), main_edit,
                  (wide_call, wide_call.replace("add_products", "add_products_mut"))],
            [FUSED, PAIR_DKV])


_BWD_MUTANTS = {
    "s_k_hi_q_lo_dropped": _term_mutant(
        1, "term_products<D, kP>(st, k_base, C::kKVChunk, q_tile, C::kQChunk);", True),
    "dp_v_lo_do_hi_dropped": _term_mutant(
        2, "term_products<D, kP>(dpt, v_base, C::kKVChunk, do_tile, C::kQChunk);", False),
    "dv_z_lo_do_hi_dropped": _add_mutant(
        1, ("          tc::wgmma_rs<1>(part, zl[kk], db, 1);\n", ""),
        "add_products<D, kTerms>(acc, ah, al, do_tile);  // dV += Z^T dO"),
    "dk_ds_hi_q_lo_dropped": _add_mutant(
        2, ("else tc::wgmma_rs<1>(part, dsa[kk], db_lo, 1);", "else {}"),
        "add_products<D, kTerms>(acc, ah, al, q_tile);  // dK += dS^T Q"),
    "dq_ds_lo_k_hi_dropped": (BWD, [
        ("          tc::wgmma_ss<1, 1>(dq, tc::make_desc(lo_base + kk * 2048, C::kDsBytes, 1024), "
         "db, 1);\n", ""),
        ("      tc::wgmma_ss<1, 1>(dq, tc::make_desc(lo_base + kk * 2048, kDsBytes, 1024), db, 1);\n",
         "")], [FUSED]),
    "do_lo_zeroed": (TC_COMMON, [(
        "  if (status == 0) status = split(dout, do2, q_rows, d, terms, stream);",
        "  if (status == 0) status = split(dout, do2, q_rows, d, terms, stream);\n"
        "  if (status == 0 && terms == 2)\n"
        "    status = static_cast<int>(cudaMemset2DAsync(static_cast<char*>(do2) + 2 * d, 4 * d, 0,"
        " 2 * d, q_rows, stream));")], [FUSED, PAIR_DQ, PAIR_DKV]),
    "z_bits_on_ds": (BWD, [
        ("          dpt[4 * j + e] = p * (dp - tf[kBlockM + x]) * scale * c_fac;",
         "          dpt[4 * j + e] = (dropout ? p * z : p) * (dp - tf[kBlockM + x]) * scale * c_fac;"),
        ("          st[4 * j + e] = y[4 * j + e] * (dp - tf[kRows + x]) * scale;",
         "          st[4 * j + e] = y[4 * j + e] * (dp - tf[kRows + x]) * scale *\n"
         "                          (dropout ? (fa::dropout_kept(static_cast<unsigned>(ti[4 * kRows + x]),\n"
         "                                                       e < 2 ? key_a : key_b, ex.threshold)\n"
         "                                          ? ex.inv : 0.f) : 1.f);")],
        [FUSED, PAIR_DKV]),
}

# The pair's dQ pass (flash_bwd_dq_tc.cu): its S and dP calls sent to a copy
# of its product helper with one product left out.
_DQ_TP = "template <int D, bool kWindowCap, bool kExtra, int kTerms>\n__global__"
_DQ_S = "term_products<D, kP>(st, q_base, C::kQChunk, k_base, C::kKVChunk);"
_DQ_DP = "term_products<D, kP>(dpt, do_base, C::kQChunk, v_base, C::kKVChunk);"


def _dq_term_mutant(skip, call):
    """The dQ pass's S (``call`` _DQ_S) or dP (_DQ_DP) product ``skip`` (1:
    A hi B lo, 2: A lo B hi) left out."""
    return (DQ, [(_DQ_TP, _TERM_PRODUCTS.replace("SKIP", str(skip)) + _DQ_TP),
                 (call, call.replace("term_products", "term_products_mut"))],
            [("flash_bwd_dq_tc_f32/", "/bf16_3x")])


# The pair at d = 256 over two terms (its 64-row dQ blocks over 32-row key
# tiles, the wide dK/dV kernel over 32-row query tiles): each mutant breaks
# that instantiation alone, so a d = 256 check must catch it.
_D256 = [("flash_bwd_dq_tc_f32/", "/d256/bf16_3x"), ("flash_bwd_dkv_tc_f32/", "/d256/bf16_3x")]
# The fused form at d = 256 over two terms (the wide kernel over 32-row
# query tiles, dQ turned over in dq_half_t): each mutant breaks it alone.
_FUSED256 = [("flash_bwd_tc_f32/", "/d256/bf16_3x")]
_DQ_T_P_SIDE = "dq_half_t<D, kTerms>(smem, dq_acc, bh, rows, r0, 0, warp, g, t);"


def _dq256_term_mutant(skip, call):
    """The d = 256 dQ pass's S or dP product ``skip`` left out."""
    mut = call.replace("term_products", "term_products_mut")
    return (DQ, [(_DQ_TP, _TERM_PRODUCTS.replace("SKIP", str(skip)) + _DQ_TP),
                 (call, f"if constexpr (D == 256) {mut} else {call}")], _D256[:1])


def _dkv256_term_mutant(skip, p_side):
    """The d = 256 pair's S^T (``p_side``) or dP^T product ``skip`` left out
    in the wide kernel."""
    mut = _WIDE_SP.replace("term_products", "term_products_mut").strip()
    side = "p_side" if p_side else "!p_side"
    return (BWD, [(_TP_ANCHOR, _TERM_PRODUCTS.replace("SKIP", str(skip)) + _TP_ANCHOR),
                  (_WIDE_SP, f"    if (kPair && D == 256 && {side}) {mut}\n"
                             f"    else {_WIDE_SP.strip()}\n")], _D256[1:])


def _dkv256_add_mutant(skip, call, pair=True):
    """The d = 256 pair's dV (``call`` its add_products call) or dK product
    ``skip`` (1: A's lo against B's hi, 2: A's hi against B's lo) left out;
    with ``pair`` False the fused form's (caught by a
    ``flash_bwd_tc_f32/.../d256/bf16_3x`` check)."""
    mut = call.replace("add_products", "add_products_mut")
    cond = "kPair" if pair else "!kPair"
    return (BWD, [(_AP_ANCHOR, _ADD_PRODUCTS.replace("SKIP", str(skip)) + _AP_ANCHOR),
                  (call, f"if constexpr ({cond} && D == 256) {mut}\n"
                         f"      else {call}")], _D256[1:] if pair else _FUSED256)


_PAIR256_MUTANTS = {
    "dq256_s_q_lo_k_hi_dropped": _dq256_term_mutant(2, _DQ_S),
    "dq256_dp_do_hi_v_lo_dropped": _dq256_term_mutant(1, _DQ_DP),
    "dq256_dq_ds_hi_k_lo_dropped": (DQ, [(
        "          tc::wgmma_rs<1>(part, dsa[kk], db_lo, 1);\n",
        "          if constexpr (D != 256) tc::wgmma_rs<1>(part, dsa[kk], db_lo, 1);\n")], _D256[:1]),
    "dkv256_s_k_hi_q_lo_dropped": _dkv256_term_mutant(1, True),
    "dkv256_dp_v_lo_do_hi_dropped": _dkv256_term_mutant(2, False),
    "dkv256_dv_z_lo_do_hi_dropped": _dkv256_add_mutant(
        1, "add_products<D, kTerms>(acc, ah, al, do_tile);  // dV += Z^T dO"),
    "dkv256_dk_ds_hi_q_lo_dropped": _dkv256_add_mutant(
        2, "add_products<D, kTerms>(acc, ah, al, q_tile);  // dK += dS^T Q"),
    "d256_do_lo_zeroed": (TC_COMMON, [(
        "  if (status == 0) status = split(dout, do2, q_rows, d, terms, stream);",
        "  if (status == 0) status = split(dout, do2, q_rows, d, terms, stream);\n"
        "  if (status == 0 && terms == 2 && d == 256)\n"
        "    status = static_cast<int>(cudaMemset2DAsync(static_cast<char*>(do2) + 2 * d, 4 * d, 0,"
        " 2 * d, q_rows, stream));")], _D256),
    # Tiles of 32 rows read the segment range table as its 64-row entries
    # that hold them; with the 64-row bound (r0 + n) / 64 a tile that starts
    # an entry finds none, an empty range, and is skipped as disjoint.
    "d256_half_tile_range_empty": (COMMON, [(
        "t < min(tiles, (r0 + n - 1) / kSegTile + 1); ++t) {",
        "t < min(tiles, (r0 + n) / kSegTile); ++t) {")], _D256),
}

_FUSED256_MUTANTS = {
    "fused256_dq_ds_hi_k_lo_dropped": (BWD, [(
        "      if constexpr (kTerms == 2)  // K's lo against dS's hi\n",
        "      if constexpr (false)\n")], _FUSED256),
    "fused256_dk_ds_hi_q_lo_dropped": _dkv256_add_mutant(
        2, "add_products<D, kTerms>(acc, ah, al, q_tile);  // dK += dS^T Q", pair=False),
    # The P side's dQ products read X right after it wrote Y^T there, before
    # barrier 2 says dS is written (the barrier stays, so the hand-offs keep
    # their pairing).
    "fused256_ds_read_before_barrier": (BWD, [
        (f"if constexpr (C::kDqT) {_DQ_T_P_SIDE}\n        else dq_half",
         "if constexpr (!C::kDqT) dq_half"),
        ("      tc::named_arrive(1, 256);  // Y^T written\n",
         "      tc::named_arrive(1, 256);  // Y^T written\n"
         f"      if constexpr (!kPair && C::kDqT) {_DQ_T_P_SIDE}\n")], _FUSED256),
}

_PAIR_MUTANTS = {
    "dq_lolo_dropped": (DQ, [("constexpr int kProducts = kTerms == 2 ? (D == 64 ? 4 : 3) : 1;",
                              "constexpr int kProducts = kTerms == 2 ? (D == 64 ? 3 : 3) : 1;")],
                        [("flash_bwd_dq_tc_f32/", "/d64/bf16_3x")]),
    "dkv_lolo_dropped": (BWD, [(
        "constexpr int kProducts = kTerms == 2 ? (kPair && D == 64 ? 4 : 3) : 1;",
        "constexpr int kProducts = kTerms == 2 ? (kPair && D == 64 ? 3 : 3) : 1;")],
        [("flash_bwd_dkv_tc_f32/", "/d64/bf16_3x")]),
    "dq_s_q_hi_k_lo_dropped": _dq_term_mutant(1, _DQ_S),
    "dq_dp_do_lo_v_hi_dropped": _dq_term_mutant(2, _DQ_DP),
    "dq_dq_ds_hi_k_lo_dropped": (DQ, [("          tc::wgmma_rs<1>(part, dsa[kk], db_lo, 1);\n", "")],
                                 [("flash_bwd_dq_tc_f32/", "/bf16_3x")]),
    "pair_range_skip_live_tile": (COMMON, [(
        "seg_meet(int2 a, int2 b) { return a.x <= b.y && b.x <= a.y; }",
        "seg_meet(int2 a, int2 b) { return a.x < b.y && b.x < a.y; }")], [PAIR_DQ, PAIR_DKV]),
}

_ZERO_TERM = "const uint32_t z[4] = {0u, 0u, 0u, 0u};"
_DECODE_MUTANTS = {
    "decode_x3y1_dropped": (DECODE, [(
        "mma6(s_lo[mb][j], sc[mb][j], qa[0][mb], qa[1][mb], qa[2][mb], b0, b1);",
        f"{{ {_ZERO_TERM} mma6(s_lo[mb][j], sc[mb][j], qa[0][mb], qa[1][mb], z, b0, b1); }}")],
        [("paged_decode_tc_f32/lo3_term/", "")]),
    "decode_p3_dropped": (DECODE, [(
        "mma6(part[mb][nb], part[mb][nb], pa[0][mb], pa[1][mb], pa[2][mb], b0, b1);",
        f"{{ {_ZERO_TERM} mma6(part[mb][nb], part[mb][nb], pa[0][mb], pa[1][mb], z, b0, b1); }}")],
        [("paged_decode_tc_f32/p3_term/", "")]),
    "decode_v_rows_unzeroed": (DECODE, [("live[e] = r >= lo && r < hi;", "live[e] = true;")],
                               [("paged_decode_tc_f32/nan_poison/", "")]),
    "decode_rows_k_major": (DECODE, [("dp = r % draft_k;", "dp = r / (rows / draft_k);")],
                            [("paged_decode_tc_f32/draft_k4_", "")]),
}

# name -> (source, [(text, replacement)], the (prefix, suffix) of the checks
# that must catch it: a list where a check of each must fail)
MUTANTS = {
    "unmutated": (TWO, [], None),
    "q_hi_k_lo_dropped": (TWO, [("for (int pr = 0; pr < kQK; ++pr) {",
                                 "for (int pr = 0; pr < kQK; pr += 1 + (pr == 0 && kQK > 1)) {")],
                          [("flash_fwd_tc_f32/", "/bf16_3x")]),
    "q_lo_k_hi_dropped": (TWO, [("for (int pr = 0; pr < kQK; ++pr) {",
                                 "for (int pr = 0; pr < kQK; pr += 1 + (pr == 1)) {")],
                          [("flash_fwd_tc_f32/", "/bf16_3x")]),
    "p_lo_dropped": (TWO, [("if (p_lo) tc::wgmma_rs<1>(part, pl[kk], db, 1);",
                            "if (p_lo && kTerms < 3) tc::wgmma_rs<1>(part, pl[kk], db, 1);")],
                     [("flash_fwd_tc_f32/", "/bf16_3x")]),
    "v_lo_dropped": (TWO, [("for (int c = 0; c < C::kChunks; ++c) {\n          const bool p_lo",
                            "for (int c = 0; c < (kTerms >= 3 ? kLC : C::kChunks); ++c) {\n"
                            "          const bool p_lo")],
                     [("flash_fwd_tc_f32/", "/bf16_3x")]),
    "x3y1_dropped": (*_drop_pair(0), [("flash_fwd_f32/", "/float32")]),
    "x2y2_dropped": (*_drop_pair(1), [("flash_fwd_f32/", "/float32")]),
    "x1y3_dropped": (*_drop_pair(2), [("flash_fwd_f32/", "/float32")]),
    "v3_dropped": (THREE, [(_PV_PAIR, "if (pair_b(kT, pr) != 2) " + _PV_PAIR)],
                   [("flash_fwd_f32/", "/float32")]),
    "paged_rows_unzeroed": (THREE, [("C::kCTerm, 0, kv.first - t0,\n                       kv.end - t0, tid);",
                                     "C::kCTerm, 0, kPaged ? 0 : kv.first - t0,\n"
                                     "                       kPaged ? kN : kv.end - t0, tid);")],
                            [("paged_prefill_tc_f32/", "")]),
    "paged_page_off_by_one": (THREE, [("table[t / pg.page_size]);",
                                       "table[min(t / pg.page_size + 1, pg.pages_per_seq - 1)]);")],
                              [("paged_prefill_tc_f32/", "")]),
    **_BWD_MUTANTS,
    **_FUSED256_MUTANTS,
    **_PAIR_MUTANTS,
    **_PAIR256_MUTANTS,
    **_DECODE_MUTANTS,
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


def run_checks(root: str, pair_only: bool = False, decode_only: bool = False) -> dict:
    """In this process: chip_smoke's float32-form checks, untimed, its
    float32 paged-prefill poison checks and its float32 training checks on
    the copy at ``root`` (``pair_only``: the pair's checks alone;
    ``decode_only``: paged decode's float32 checks alone, untimed)."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    import flashattention_tpu_torch as fa
    from flashattention_tpu_torch.ops import backward, decode, flash, probes
    from flashattention_tpu_torch.utils import benchit

    if not os.path.abspath(flash.__file__).startswith(root + os.sep):
        raise RuntimeError(f"flash came from {flash.__file__}, not {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    report = {"checks": []}
    gen = torch.Generator(device="cuda").manual_seed(0)
    card = torch.cuda.get_device_name(0)
    if not (pair_only or decode_only):
        cs.f32_form_checks(fa, flash, probes, benchit, gen, card, report, timed=False)
        cs.prefill_poison_check(decode, gen, report, dtypes=("float32",))
        cs.f32_train_checks(backward, flash, gen, report)
    if not pair_only:
        benchit.cuda_time_ms = lambda fn, *a, **kw: (fn(), 0.0)[1]  # checks only: one call
        cs.decode_f32_term_checks(decode, gen, report)
        cs.draft_checks(decode, benchit, gen, card, report, dtypes=("float32",))
        cs.decode_poison_check(decode, gen, report, dtypes=("float32",))
        cs.split_edge_checks(decode, gen, report, dtypes=("float32",))
    if not decode_only:
        cs.pair_f32_checks(backward, flash, probes, gen, report)
    keys = ("ok", "rel_err", "exact_rel_err", "max_abs_err", "plain_err", "bitwise_equal",
            "launched_its_form", "fwd_keep_equal", "bwd_keep_equal", "dk_dv_bitwise",
            "dq_max_abs_err", "norm_rel_err", "other_count_norm_rel_err", "deterministic",
            "alone_bitwise", "first_head_bitwise")
    return {c["check"]: {k: c[k] for k in keys if c.get(k) is not None} for c in report["checks"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--keep", action="store_true", help="keep the copies")
    ap.add_argument("--mutants", nargs="+", choices=list(MUTANTS)[1:],
                    help="run only these mutants (and the unmutated copy)")
    only = ap.add_mutually_exclusive_group()
    only.add_argument("--pair-only", action="store_true",
                      help="run only the pair's checks (pair_f32_checks) on each copy")
    only.add_argument("--decode-only", action="store_true",
                      help="run only paged decode's float32 checks on each copy")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(run_checks(args.one, args.pair_only, args.decode_only)), flush=True)
        return 0
    names = ["unmutated", *(args.mutants or list(MUTANTS)[1:])]
    tmp = tempfile.mkdtemp(prefix="f32_mutants-")
    try:
        roots = {m: os.path.join(tmp, m) for m in names}
        for m in names:
            make_copy(roots[m], *MUTANTS[m][:2])
        libraries = DECODE_LIBRARIES if args.decode_only else LIBRARIES

        def build(ms):
            procs = [subprocess.Popen([sys.executable, "-c", (
                "import sys; sys.path.insert(0, sys.argv[1]); "
                "from flashattention_tpu_torch.ops import kernels; "
                "kernels.build_all(sys.argv[2:])"), roots[m], *libraries]) for m in ms]
            return all(p.wait() == 0 for p in procs)

        # The unmutated copy's libraries first: the others start from them
        # (a library's file name hashes its sources), so each rebuilds only
        # what its edit changes.
        built = build(["unmutated"])
        unmutated_build = os.path.join(roots["unmutated"], "build", "torch_kernels")
        for m in names[1:]:
            shutil.copytree(unmutated_build, os.path.join(roots[m], "build", "torch_kernels"))
        if not (built and build(names[1:])):
            print("f32_mutants: a build failed", file=sys.stderr)
            return 1
        results, ok = {}, True
        for m in names:
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", roots[m],
                                   *(["--pair-only"] if args.pair_only else []),
                                   *(["--decode-only"] if args.decode_only else [])],
                                  stdout=subprocess.PIPE, text=True)
            lines = proc.stdout.strip().splitlines()
            if proc.returncode != 0 or not lines:
                print(f"f32_mutants: {m} did not run (exit {proc.returncode})", file=sys.stderr)
                return 1
            checks = json.loads(lines[-1])
            failed = {c: r for c, r in checks.items() if not r["ok"]}
            wants = MUTANTS[m][2]
            caught_by = None if wants is None else {
                prefix + "..." + suffix: any(c.startswith(prefix) and c.endswith(suffix)
                                             for c in failed) for prefix, suffix in wants}
            caught = None if wants is None else all(caught_by.values())
            ok = ok and (not failed if wants is None else caught)
            rec = {"copy": m, "checks": len(checks), "failed": failed, "caught": caught,
                   "caught_by": caught_by}
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
