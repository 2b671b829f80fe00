"""The float32 form of paged decode (``paged_decode_tc_f32``).

The JAX package computes paged decode over float32 pages at
``Precision.HIGHEST`` for both products, with p kept in float32
(``flashattention_tpu/ops/decode.py:145-156``, ``:199-208``): each float32
value as three bf16 terms and six products.  ``ops.flash.kernel_form``
sends float32 q over float32 pages at head_dim 64, 128 and 256, with at
most 32 q rows per KV head and on pages the 64-row tile's TMA boxes take,
to ``csrc/paged_decode_tc.cu`` built with ``-DFA_F32``; its plain version
(``paged_attention_plain(form="tc_f32")``, what the CPU path runs over
float32 pages) follows its splits, its running max per 64-column tile and
its six products.  Here, with numpy inputs from a seed: the choice for
every combination; the mirror against the JAX ``paged_attention`` (the
Pallas kernel in interpret mode on the CPU) within 1e-4; the mirror within
float32 rounding of a float64 oracle, where a three-product (``bf16_3x``)
variant and every variant without one of the six products of S are not;
the merge of 1, 2 and many splits against the unsplit result; and rows no
row may see, NaN, leaving the output unchanged bit for bit.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattention_tpu.ops import decode as jd
from flashattention_tpu_torch.ops import decode as td
from flashattention_tpu_torch.ops import flash as tflash
from flashattention_tpu_torch.ops import probes
from flashattention_tpu_torch.utils.testing import validate_result

torch.set_num_threads(2)

TOL = 1e-4  # the float32 tolerance of the port's other differential tests
# Two splittings of one cache differ only in where the running max restarts
# and in the merge's float32 sums: a few float32 steps of the output.
SPLIT_RTOL = 2.0**-20
# The six-product mirror against float64, relative to the output's
# magnitude: HIGHEST drops x2 y3, x3 y2 and x3 y3 (about 2^-24 of a
# product) and rounds to float32, far below what a variant without a
# product misses by (BOUND_MISSED and more).
ORACLE_BOUND = 1e-6
BOUND_MISSED = 4 * ORACLE_BOUND
PAGE_SIZES = (4, 8, 12, 16, 24, 32, 48, 64, 96, 128, 256, 1000)
ROWS = (1, 2, 4, 8, 16, 24, 32, 33, 64)


def _tile_page(ps):
    return ps % 8 == 0 and (64 % ps == 0 or ps % 64 == 0)


@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
def test_f32_decode_form_selector(d):
    """Float32 q over float32 pages at d = 64 / 128 / 256, at most 32 rows
    and a page size the 64-row tile's boxes take: the float32 form; over
    8-bit pages (float32 q taken in bf16 asks with bf16), elsewhere and
    inside scalar_forms the scalar kernel."""
    for ps, quantized, rows in itertools.product(PAGE_SIZES, (False, True), ROWS):
        taken = d in (64, 128, 256) and _tile_page(ps) and rows <= 32 and not quantized
        got = tflash.kernel_form("paged_decode", torch.float32, d, quantized=quantized,
                                 page_size=ps, rows=rows)
        assert got == ("tc_f32" if taken else "scalar"), (ps, quantized, rows)
        with tflash.scalar_forms():
            assert tflash.kernel_form("paged_decode", torch.float32, d, page_size=ps,
                                      rows=rows) == "scalar"
    assert tflash.kernel_form("paged_decode", torch.float32, d) == "scalar"


# (name, KVH, G, draft_k, d, page size, pages per request, lengths, window,
# softcap, q scale): lengths 0 and 1; lengths on the page and tile edges
# (63, 64, 65 at 64-row pages and tiles; 31, 32, 33 at 32-row pages); a
# window starting mid-page with the softcap at d = 256, G = 4; draft forms at
# k = 4 with G = 1 (R = 4), G = 2 at d = 256 with Gemma-2's window and softcap,
# G = 4 with a window (R = 16) and G = 8 (R = 32, two m-blocks).
CASES = [
    ("k1_g1_d64_ps16_len0_1", 2, 1, 1, 64, 16, 6, [0, 1, 16, 96], None, None, 1.0),
    ("k1_g2_d128_ps64_tile_edges", 1, 2, 1, 128, 64, 4, [63, 64, 65, 128], None, None, 1.0),
    ("k1_g4_d256_ps32_window_cap", 1, 4, 1, 256, 32, 6, [31, 33, 100, 192], 50, 20.0, 4.0),
    ("k4_g1_d128_ps16", 2, 1, 4, 128, 16, 8, [4, 65, 128], None, None, 1.0),
    ("k4_g2_d256_ps64_window_cap", 1, 2, 4, 256, 64, 3, [4, 130, 192], 64, 30.0, 4.0),
    ("k4_g4_d64_ps16_window", 1, 4, 4, 64, 16, 8, [5, 64, 127], 40, None, 2.0),
    ("k4_g8_d64_ps32_r32", 1, 8, 4, 64, 32, 3, [0, 50, 96], None, None, 1.0),
]


def _inputs(case, seed):
    """(q, k_pages, v_pages, table, lengths) as float32 numpy arrays (int32
    table and lengths): a pool of shuffled pages, the tables' tails other
    pool pages."""
    _, kvh, g, k, d, ps, pps, lens, _, _, qmul = case
    rng = np.random.default_rng(seed)
    b = len(lens)
    pool = b * pps + 3
    kp, vp = (rng.standard_normal((pool, kvh, ps, d)).astype(np.float32) for _ in range(2))
    q = rng.standard_normal((b, kvh, g * k, d)).astype(np.float32) * np.float32(qmul)
    table = rng.permutation(pool)[: b * pps].reshape(b, pps).astype(np.int32)
    return q, kp, vp, table, np.array(lens, np.int32)


def _kw(case):
    _, _, _, k, d, _, _, _, window, cap, _ = case
    return dict(scale=d**-0.5, draft_k=k, window=window, logit_softcap=cap)


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_f32_decode_matches_jax(case):
    """The float32 form's plain version, the CPU path over float32 pages,
    against the JAX kernel over the same pages in interpret mode, within
    1e-4 on the rows it writes (length > 0); a length-0 request gets
    zeros."""
    arrays = _inputs(case, 1)
    q, kp, vp, table, lens = _torch(*arrays)
    kw = _kw(case)
    assert tflash.kernel_form("paged_decode", q.dtype, case[4], page_size=case[5],
                              rows=q.shape[2]) == "tc_f32"
    got = td.paged_attention(q, kp, vp, lens, table, **kw)
    assert got.dtype == torch.float32
    assert torch.equal(got, td.paged_attention_plain(q, kp, vp, lens, table, form="tc_f32", **kw))
    jq_, jk, jv, jt, jl = (jnp.asarray(a) for a in arrays)
    want = np.asarray(jd.paged_attention(jq_, jk, jv, jl, jt, **kw))
    live = arrays[4] > 0
    validate_result(got[torch.from_numpy(live)], want[live], TOL, name="o")
    for i in np.nonzero(~live)[0]:
        assert torch.count_nonzero(got[i]) == 0


def _oracle(q, kp, vp, lens, table, scale, s_pairs=None, pv_pairs=None):
    """Paged decode (k = 1, no window) in float64 over one split: S and P V
    from the three bf16 terms' products ``s_pairs`` / ``pv_pairs`` ((i, j):
    term i of q or p against term j of k or v), or exactly where None; p
    rounded to float32 before its split, as the kernel holds it."""
    k, v = (td._gather(x, None, table).double() for x in (kp, vp))

    def prod(eq, x, y, pairs):
        if pairs is None:
            return torch.einsum(eq, x.double(), y.double())
        xt, yt = tflash._split3_bf16(x.float()), tflash._split3_bf16(y.float())
        return sum(torch.einsum(eq, xt[i].double(), yt[j].double()) for i, j in pairs)

    s = prod("bhrd,bhkd->bhrk", q, k, s_pairs) * scale
    cols = torch.arange(k.shape[2])[None, None, None]
    s = torch.where(cols < lens.long()[:, None, None, None], s, -float("inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True)).float()
    return prod("bhrk,bhkd->bhrd", p, v, pv_pairs) / p.double().sum(-1, keepdim=True)


SIX = [(0, 0), (0, 1), (1, 0), (0, 2), (1, 1), (2, 0)]
THREE = SIX[:3]  # bf16_3x: x1 y1, x1 y2, x2 y1


def _rel(got, want):
    return float((got.double() - want).abs().max() / want.abs().max())


def test_f32_decode_six_products_are_live():
    """On random pages, the mirror (one split, and the kernel's default
    splits) within float32 rounding of the float64 oracle and of the oracle
    over the same six products; a bf16_3x variant (three products in S and
    in P V) misses by more."""
    case = ("six", 2, 2, 1, 128, 16, 8, [37, 64, 128], None, None, 1.0)
    q, kp, vp, table, lens = _torch(*_inputs(case, 7))
    scale = case[4] ** -0.5
    exact = _oracle(q, kp, vp, lens, table, scale)
    six = _oracle(q, kp, vp, lens, table, scale, SIX, SIX)
    three = _oracle(q, kp, vp, lens, table, scale, THREE, THREE)
    for splits in (1, None):
        mirror = td.paged_attention_plain(q, kp, vp, lens, table, scale=scale, form="tc_f32",
                                          splits=splits)
        assert _rel(mirror, exact) <= ORACLE_BOUND, splits
        assert _rel(mirror, six) <= ORACLE_BOUND, splits
    assert _rel(three, exact) > BOUND_MISSED


@pytest.mark.parametrize("d", [64, 256])
def test_f32_decode_each_product_of_s_moves_the_output(d):
    """On ``probes.lo3_term_f32_qkv``'s pages (scale 1), whose third-term
    products move the scores by 2^-9 to 2^-7 while every partial sum stays
    exact in float32: the mirror within ORACLE_BOUND of the float64 oracle
    over the six products, and each variant without one of them (or the
    bf16_3x one) more than 1e-4 away."""
    b, kvh, s = 2, 2, 128
    gen = torch.Generator().manual_seed(11)
    qa, ka, va = probes.lo3_term_f32_qkv(b * kvh, s, d, generator=gen)
    ps = 16
    pps = s // ps
    # Request i's pages are pool pages i * pps .. i * pps + pps - 1.
    def pages(x):
        return x.view(b, kvh, pps, ps, d).transpose(1, 2).reshape(b * pps, kvh, ps, d)

    kp, vp = pages(ka).contiguous(), pages(va).contiguous()
    q = qa.view(b, kvh, s, d)[:, :, -1:].contiguous()
    table = torch.arange(b * pps, dtype=torch.int32).view(b, pps)
    lens = torch.tensor([s, s - 21], dtype=torch.int32)
    mirror = td.paged_attention_plain(q, kp, vp, lens, table, scale=1.0, form="tc_f32")
    six = _oracle(q, kp, vp, lens, table, 1.0, SIX, None)
    assert _rel(mirror, six) <= ORACLE_BOUND
    for dropped in [*SIX[3:], *SIX[1:3], None]:
        pairs = THREE if dropped is None else [p for p in SIX if p != dropped]
        assert float((_oracle(q, kp, vp, lens, table, 1.0, pairs, None) - six).abs().max()) > TOL, (
            dropped)


# (name, KVH, G, draft_k, d, page size, pages per request, lengths, window,
# softcap, q scale) for the merge: a window whose first tiles lie in splits
# of their own, requests far shorter than the table (splits past the length)
# and a length 0, a draft length one past a tile (the split past it holds
# only columns the first draft rows may not see).
SPLIT_CASES = [
    ("window_first_tiles", 2, 2, 1, 64, 16, 16, [200, 256, 64], 50, 20.0, 2.0),
    ("short_requests_length0", 2, 4, 1, 128, 32, 8, [0, 1, 70, 256], None, None, 1.0),
    ("draft_k4_tile_edge", 2, 2, 4, 256, 16, 12, [66, 129, 190], 100, 30.0, 2.0),
]


@pytest.mark.parametrize("case", SPLIT_CASES, ids=[c[0] for c in SPLIT_CASES])
def test_f32_decode_splits_merge_to_the_unsplit_result(case):
    """The mirror over 1 split, 2 splits and one split per 64-column tile
    (empty ones among them): the merged results equal the unsplit one within
    SPLIT_RTOL of the output's magnitude, a length-0 request gives zeros,
    every result is finite, and the unsplit one is the float32 oracle's
    within 1e-4."""
    q, kp, vp, table, lens = _torch(*_inputs(case, 3))
    kw = _kw(case)
    tiles = -(-case[5] * case[6] // 64)
    assert td.decode_splits(len(case[7]), case[1], case[6], case[5], splits=tiles) == (tiles, 1)
    outs = {n: td.paged_attention_plain(q, kp, vp, lens, table, form="tc_f32", splits=n, **kw)
            for n in (1, 2, tiles)}
    ref = outs[1]
    bound = SPLIT_RTOL * max(1.0, float(ref.abs().max()))
    for n, o in outs.items():
        assert bool(torch.isfinite(o).all()), n
        validate_result(o, ref, bound, name=f"splits={n}")
        for i in np.nonzero(np.array(case[7]) == 0)[0]:
            assert torch.count_nonzero(o[i]) == 0
    scalar = td.paged_attention_plain(q, kp, vp, lens, table, form="scalar", **kw)
    live = lens > 0
    validate_result(ref[live], scalar[live], TOL, name="unsplit vs scalar")


def test_f32_decode_ignores_rows_no_row_may_see():
    """NaN in every pool row past each length, in every page past the live
    ones and before the window leaves the float32 mirror's output unchanged,
    bit for bit, as the kernel's NaN-poison check on the card demands of the
    kernel."""
    case = ("poison", 2, 2, 4, 64, 16, 8, [4, 40, 128], 30, 20.0, 2.0)
    q, kp, vp, table, lens = _torch(*_inputs(case, 6))
    kw = _kw(case)
    clean = td.paged_attention_plain(q, kp, vp, lens, table, form="tc_f32", **kw)
    kn, vn = kp.clone(), vp.clone()
    ps = case[5]
    for i, n in enumerate(case[7]):
        first = max(0, n - 4 - 30 + 1)
        for j in range(table.shape[1]):
            page = int(table[i, j])
            lo, hi = max(0, min(ps, first - j * ps)), max(0, min(ps, n - j * ps))
            for x in (kn, vn):
                x[page, :, :lo] = float("nan")
                x[page, :, max(lo, hi):] = float("nan")
    poisoned = td.paged_attention_plain(q, kn, vn, lens, table, form="tc_f32", **kw)
    assert torch.equal(poisoned, clean)
