"""The tensor-core form of paged decode (``paged_decode_tc``).

``ops.flash.kernel_form("paged_decode", ...)`` sends bf16 q at head_dim 64,
128 and 256 with at most 32 q rows per KV head (G, or G * draft_k), over
bf16 or 8-bit pages of a size its TMA boxes take, to
``csrc/paged_decode_tc.cu``, and every other call to the scalar
``csrc/paged_decode.cu``.  The kernel splits each request's cache across
blocks and merges their partials; its plain version
(``paged_attention_plain(form="tc")``, what the CPU path runs in bf16)
mirrors its rounding: the running max per 64-column tile, P as two bf16
terms, the 8-bit order (payload, column k_scale, v_scale in P), the split
boundaries and the merge.  Here: the choice for every combination; the
mirror against the JAX package's ``paged_attention`` (the Pallas kernel in
interpret mode on the CPU) within 2e-2, the bf16 tolerance of the port's
other differential tests, and over int8 / fp8 pages within
``tests/test_quant.py``'s bound (2e-2 of the output's magnitude); the merge
of 1, 2 and many splits (empty ones among them: wholly before the window,
past the length, or holding only columns a draft row may not see) against
the unsplit result; and that the rounding moves the result, so that the
option is not dead.
"""

import ast
import itertools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattention_tpu.ops import decode as jd
from flashattention_tpu.ops import quant as jq
from flashattention_tpu_torch.ops import decode as td
from flashattention_tpu_torch.ops import flash as tflash
from flashattention_tpu_torch.utils.testing import to_torch, validate_result

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-2
QUANT_TOL = 2e-2  # tests/test_quant.py's bound, relative to the output's magnitude
# Two splittings of one cache differ only in where the running max restarts:
# each p enters the PV product as two bf16 terms, held to about 2^-17 of p,
# and the merge sums in float32; so two split counts agree to a few units of
# 2^-17 of the output's magnitude.
SPLIT_RTOL = 2.0**-15
DTYPES = (torch.float32, torch.bfloat16, torch.float16)
PAGE_SIZES = (4, 8, 12, 16, 24, 32, 48, 64, 96, 128, 256, 1000)


def _tc_page(ps):
    return ps % 8 == 0 and (64 % ps == 0 or ps % 64 == 0)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda t: str(t).split(".")[1])
@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
def test_decode_form_selector(dtype, d):
    """bf16 q, a tensor-core head_dim, a page size the boxes take and at
    most 32 rows: the tensor-core form, over bf16 and 8-bit pages alike;
    float32 q over float32 pages there: the float32 form; scalar otherwise
    (and without a page size, and inside scalar_forms)."""
    for ps, quantized, rows in itertools.product(PAGE_SIZES, (False, True),
                                                 (1, 2, 4, 8, 16, 24, 32, 33, 64)):
        taken = d in (64, 128, 256) and _tc_page(ps) and rows <= 32
        want = ("tc" if dtype == torch.bfloat16 and taken
                else "tc_f32" if dtype == torch.float32 and taken and not quantized
                else "scalar")
        got = tflash.kernel_form("paged_decode", dtype, d, quantized=quantized, page_size=ps,
                                 rows=rows)
        assert got == want, (ps, quantized, rows)
    assert tflash.kernel_form("paged_decode", dtype, d) == "scalar"
    with tflash.scalar_forms():
        assert tflash.kernel_form("paged_decode", dtype, d, page_size=256) == "scalar"


def test_decode_page_rule_is_the_decode_tile():
    """The decode tile is 64 rows at every head_dim (the forward's is 128
    below d = 256): a page of 128 rows is taken, one of 96 is not."""
    assert tflash.TC_DECODE_TILE == 64
    for d in (64, 128, 256):
        assert tflash.tc_page_size(128, d, tflash.TC_DECODE_TILE)
        assert tflash.tc_page_size(32, d, tflash.TC_DECODE_TILE)
        assert not tflash.tc_page_size(96, d, tflash.TC_DECODE_TILE)
        assert not tflash.tc_page_size(12, d, tflash.TC_DECODE_TILE)


@pytest.mark.parametrize("b,kvh,pps,ps", [(4, 32, 8, 256), (4, 8, 24, 256), (1, 1, 1, 16),
                                          (64, 32, 512, 16), (2, 4, 3, 16)])
def test_decode_splits(b, kvh, pps, ps):
    """Splits of whole 64-row tiles that cover the table once, none past
    it, at most 64, about four blocks an SM of the card."""
    tiles = -(-pps * ps // 64)
    n, per = td.decode_splits(b, kvh, pps, ps, sms=132)
    assert 1 <= n <= 64 and per >= 1
    assert (n - 1) * per < tiles <= n * per
    assert n <= min(tiles, 64, max(1, -(-4 * 132 // (b * kvh))))
    for want in (1, 2, 5, 1000):
        n2, per2 = td.decode_splits(b, kvh, pps, ps, splits=want)
        assert n2 <= max(1, min(want, tiles, 64)) and (n2 - 1) * per2 < tiles <= n2 * per2


def _bf16_pair(x):
    """The same values as a bf16 JAX array and a bf16 torch tensor."""
    j = jnp.asarray(x, jnp.bfloat16)
    return j, torch.tensor(np.asarray(j.astype(jnp.float32))).to(torch.bfloat16)


def _rows(rng, shape, decades=2.0):
    """Normal rows whose magnitudes spread over ``decades`` decades, so that
    a scale applied to the wrong row moves the result."""
    mag = 10.0 ** rng.uniform(-decades / 2, decades / 2, shape[:-1] + (1,))
    return (rng.standard_normal(shape) * mag).astype(np.float32)


def _quant_pool(rng, shape, dtype):
    """A pool (P, KVH, ps, d) quantized per row by the JAX package: its
    payload and scales, and the same bits as torch tensors."""
    jqt = jq.quantize(jnp.asarray(_rows(rng, shape).reshape(-1, shape[-2], shape[-1])), dtype)
    payload, scales = jqt.payload.reshape(shape), jqt.scales.reshape(shape[:-1])
    return (payload, scales), (to_torch(np.asarray(payload)), to_torch(np.asarray(scales)))


# (name, KVH, G, draft_k, d, page size, pages per request, lengths, window,
# softcap, q scale): lengths 0 and 1 at G = 1; the page edges 255, 256, 257
# at the engine's page; a window starting mid-page with the softcap at d =
# 256, G = 4; G = 8 over pages below the tile; draft forms at k = 2 (window
# and softcap) and k = 4 (R = 32 rows; Gemma-2's window and softcap at d =
# 256).
CASES = [
    ("g1_d64_ps16_len0_1", 2, 1, 1, 64, 16, 6, [0, 1, 63, 96], None, None, 1.0),
    ("g2_d128_ps256_page_edges", 1, 2, 1, 128, 256, 2, [255, 256, 257], None, None, 1.0),
    ("g4_d256_ps64_window_mid_page_cap", 1, 4, 1, 256, 64, 4, [70, 200, 256], 50, 20.0, 4.0),
    ("g8_d64_ps32", 2, 8, 1, 64, 32, 4, [1, 33, 128], None, None, 1.0),
    ("draft_k2_g2_d128_window_cap", 2, 2, 2, 128, 16, 8, [2, 40, 128], 30, 10.0, 2.0),
    ("draft_k4_g8_d64_r32", 1, 8, 4, 64, 16, 6, [4, 50, 96], None, None, 1.0),
    ("draft_k4_g2_d256_window_cap", 1, 2, 4, 256, 64, 3, [4, 130, 192], 64, 30.0, 4.0),
]
QUANT_CASES = [c for c in CASES if c[0] in ("g1_d64_ps16_len0_1", "g4_d256_ps64_window_mid_page_cap",
                                            "draft_k2_g2_d128_window_cap")]


def _inputs(case, seed, quant=None):
    """(q, k, v, table, lengths): q a (JAX, torch) bf16 pair; k, v (JAX,
    torch) bf16 pairs, or with ``quant`` ((payload, scales) JAX,
    (payload, scales) torch) pairs of 8-bit pools quantized by the JAX
    package."""
    _, kvh, g, k, d, ps, pps, lens, _, _, qmul = case
    rng = np.random.default_rng(seed)
    b = len(lens)
    pool = b * pps + 3
    if quant:
        kv = [_quant_pool(rng, (pool, kvh, ps, d), quant) for _ in range(2)]
    else:
        kv = [_bf16_pair(rng.standard_normal((pool, kvh, ps, d)).astype(np.float32))
              for _ in range(2)]
    q = _bf16_pair(rng.standard_normal((b, kvh, g * k, d)).astype(np.float32) * np.float32(qmul))
    table = rng.permutation(pool)[: b * pps].reshape(b, pps).astype(np.int32)
    return q, kv[0], kv[1], table, np.array(lens, np.int32)


def _kw(case):
    _, _, _, k, d, _, _, _, window, cap, _ = case
    return dict(scale=d**-0.5, draft_k=k, window=window, logit_softcap=cap)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_tc_decode_matches_jax_bf16(case):
    """The tensor-core form's plain version, the CPU path's in bf16, against
    the JAX kernel in interpret mode on the rows it writes (length > 0); a
    length-0 request gets zeros."""
    (jq_, tq_), (jk, tk), (jv, tv), table, lens = _inputs(case, 1)
    kw = _kw(case)
    assert tflash.kernel_form("paged_decode", tq_.dtype, case[4], page_size=case[5],
                              rows=tq_.shape[2]) == "tc"
    got = td.paged_attention(tq_, tk, tv, torch.from_numpy(lens), torch.from_numpy(table), **kw)
    assert torch.equal(got, td.paged_attention_plain(tq_, tk, tv, torch.from_numpy(lens),
                                                     torch.from_numpy(table), form="tc", **kw))
    want = np.asarray(jd.paged_attention(jq_, jk, jv, jnp.asarray(lens), jnp.asarray(table),
                                         **kw).astype(jnp.float32))
    live = lens > 0
    validate_result(got[torch.from_numpy(live)], want[live], TOL, name="o")
    for i in np.nonzero(~live)[0]:
        assert torch.count_nonzero(got[i]) == 0


@pytest.mark.parametrize("dtype", ["int8", "fp8"])
@pytest.mark.parametrize("case", QUANT_CASES, ids=[c[0] for c in QUANT_CASES])
def test_tc_decode_8bit_matches_jax(case, dtype):
    """The 8-bit tensor-core form's plain version against the JAX kernel
    over the same payloads and scales, within 2e-2 of the output's
    magnitude."""
    (jq_, tq_), ((jkp, jks), (tkp, tks)), ((jvp, jvs), (tvp, tvs)), table, lens = _inputs(
        case, 2, dtype)
    kw = _kw(case)
    assert tflash.kernel_form("paged_decode", tq_.dtype, case[4], quantized=True,
                              page_size=case[5], rows=tq_.shape[2]) == "tc"
    got = td.paged_attention(tq_, tkp, tvp, torch.from_numpy(lens), torch.from_numpy(table),
                             k_scales_pages=tks, v_scales_pages=tvs, **kw)
    want = np.asarray(jd.paged_attention(jq_, jkp, jvp, jnp.asarray(lens), jnp.asarray(table),
                                         k_scales_pages=jks, v_scales_pages=jvs,
                                         **kw).astype(jnp.float32))
    live = lens > 0
    validate_result(got[torch.from_numpy(live)].float(), want[live],
                    QUANT_TOL * max(1.0, float(np.abs(want[live]).max())), name="o")
    for i in np.nonzero(~live)[0]:
        assert torch.count_nonzero(got[i]) == 0


# (name, KVH, G, draft_k, d, page size, pages per request, lengths, window,
# softcap, q scale) for the merge: a window whose first tiles lie in splits
# of their own (a split wholly before the window, one holding only rows
# before it and the window's first column), requests far shorter than the
# table (splits past the length), a draft length one past a tile (the split
# past it holds only columns the first draft rows may not see), a length 0.
SPLIT_CASES = [
    ("window_first_tiles", 2, 2, 1, 64, 16, 16, [200, 256, 64], 50, 20.0, 2.0),
    ("short_requests_length0", 2, 4, 1, 128, 32, 8, [0, 1, 70, 256], None, None, 1.0),
    ("draft_k4_tile_edge", 2, 2, 4, 64, 16, 12, [66, 129, 190], None, None, 2.0),
    ("draft_k4_window_edge", 1, 2, 4, 256, 64, 4, [4, 67 + 40, 250], 40, 30.0, 2.0),
]


@pytest.mark.parametrize("case", SPLIT_CASES, ids=[c[0] for c in SPLIT_CASES])
def test_tc_decode_splits_merge_to_the_unsplit_result(case):
    """The mirror over 1 split, 2 splits and one split per 64-column tile
    (empty ones among them), with float32 q of bf16 values so that the
    output keeps float32's precision: the merged results equal the unsplit
    one within SPLIT_RTOL of the output's magnitude, a length-0 request
    gives zeros, and every result is finite; bf16 pages and fp8 pages."""
    for quant in (None, "fp8"):
        (_, tq_), k, v, table, lens = _inputs(case, 3, quant)
        kw = _kw(case)
        if quant:
            (tk, tks), (tv, tvs) = k[1], v[1]
            kw.update(k_scales_pages=tks, v_scales_pages=tvs)
        else:
            tk, tv = k[1], v[1]
        args = (tq_.float(), tk, tv, torch.from_numpy(lens), torch.from_numpy(table))
        tiles = -(-case[5] * case[6] // 64)
        outs = {n: td.paged_attention_plain(*args, form="tc", splits=n, **kw)
                for n in (1, 2, tiles)}
        assert td.decode_splits(len(lens), case[1], case[6], case[5], splits=tiles) == (tiles, 1)
        ref = outs[1]
        bound = SPLIT_RTOL * max(1.0, float(ref.abs().max()))
        for n, o in outs.items():
            assert bool(torch.isfinite(o).all()), n
            validate_result(o, ref, bound, name=f"splits={n}")
            for i in np.nonzero(lens == 0)[0]:
                assert torch.count_nonzero(o[i]) == 0
        # and the unsplit mirror against the scalar form's float32 oracle
        scalar = td.paged_attention_plain(*args, form="scalar", **kw)
        live = torch.from_numpy(lens > 0)
        validate_result(ref[live], scalar[live], TOL, name="unsplit vs scalar")


def test_tc_decode_merge_weights_a_masked_only_split_by_zero():
    """Draft row 0 of a request of length 66 at k = 4 sees columns <= 62:
    the split of the second tile (columns 64-65) holds none of them, so its
    running max there is the mask value.  Weighting that partial by 0
    gives the unsplit result."""
    case = ("edge", 1, 1, 4, 64, 16, 8, [66], None, None, 1.0)
    (_, tq_), (_, tk), (_, tv), table, lens = _inputs(case, 4)
    kw = _kw(case)
    args = (tq_.float(), tk, tv, torch.from_numpy(lens), torch.from_numpy(table))
    one = td.paged_attention_plain(*args, form="tc", splits=1, **kw)
    many = td.paged_attention_plain(*args, form="tc", splits=2, **kw)
    assert td.decode_splits(1, 1, 8, 16, splits=2) == (2, 1)
    validate_result(many, one, SPLIT_RTOL * max(1.0, float(one.abs().max())))


@pytest.mark.parametrize("case", CASES[2:5], ids=[c[0] for c in CASES[2:5]])
def test_tc_decode_rounding_moves_the_result(case):
    """The mirrored rounding is live: over float32 q of bf16 values the tc
    form differs from the scalar form by more than nothing and less than the
    bf16 tolerance; in bf16 the tc form is the default, over float32 pages
    the float32 form (tc_f32) is."""
    (_, tq_), (_, tk), (_, tv), table, lens = _inputs(case, 5)
    kw = _kw(case)
    args = (torch.from_numpy(lens), torch.from_numpy(table))
    tc = td.paged_attention_plain(tq_.float(), tk, tv, *args, form="tc", **kw)
    scalar = td.paged_attention_plain(tq_.float(), tk, tv, *args, form="scalar", **kw)
    gap = float((tc - scalar).abs().max())
    assert 0.0 < gap < TOL
    assert torch.equal(td.paged_attention_plain(tq_, tk, tv, *args, **kw),
                       td.paged_attention_plain(tq_, tk, tv, *args, form="tc", **kw))
    f32 = (tq_.float(), tk.float(), tv.float(), *args)
    assert torch.equal(td.paged_attention_plain(*f32, **kw),
                       td.paged_attention_plain(*f32, form="tc_f32", **kw))


def test_tc_decode_ignores_rows_no_row_may_see():
    """NaN in every pool row past each length, in every page past the live
    ones and before the window (fp8: the byte 0x7F, e4m3's NaN, and NaN
    scales) leaves the tensor-core mirror's output unchanged, bit for bit,
    as the kernel's NaN-poison check on the card demands of the kernel."""
    case = ("poison", 2, 2, 4, 64, 16, 8, [4, 40, 128], 30, 20.0, 2.0)
    for quant in (None, "fp8"):
        (_, tq_), k, v, table, lens = _inputs(case, 6, quant)
        kw = _kw(case)
        if quant:
            (tk, tks), (tv, tvs) = k[1], v[1]
            scales = [tks.clone(), tvs.clone()]
        else:
            (tk, tv), scales = (k[1], v[1]), []
        args = (torch.from_numpy(lens), torch.from_numpy(table))
        sk = dict(k_scales_pages=tks, v_scales_pages=tvs) if quant else {}
        clean = td.paged_attention_plain(tq_, tk, tv, *args, form="tc", **sk, **kw)
        kn, vn = tk.clone(), tv.clone()
        pools = [x.view(torch.uint8) if quant else x for x in (kn, vn)]
        ps = case[5]
        for i, n in enumerate(lens):
            first = max(0, int(n) - 4 - 30 + 1)
            for j in range(table.shape[1]):
                page = int(table[i, j])
                lo, hi = max(0, min(ps, first - j * ps)), max(0, min(ps, int(n) - j * ps))
                for x in pools:
                    x[page, :, :lo] = 0x7F if quant else float("nan")
                    x[page, :, max(lo, hi):] = 0x7F if quant else float("nan")
                for x in scales:
                    x[page, :, :lo] = float("nan")
                    x[page, :, max(lo, hi):] = float("nan")
        sn = dict(k_scales_pages=scales[0], v_scales_pages=scales[1]) if quant else {}
        poisoned = td.paged_attention_plain(tq_, kn, vn, *args, form="tc", **sn, **kw)
        assert torch.equal(poisoned, clean), quant


@pytest.mark.parametrize("script", ["probe_stream.py", "decode_ab.py"])
def test_decode_tools_import_no_jax(script):
    """The decode probe and A/B scripts drive the port alone."""
    with open(os.path.join(ROOT, "torch_tools", script)) as fh:
        tree = ast.parse(fh.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    assert not [n for n in names if n and (n.split(".")[0] in ("jax", "jaxlib")
                                           or n.split(".")[0] == "flashattention_tpu")]
