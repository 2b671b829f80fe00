"""The probes' plain versions (``ops/probes.py``) against float64 numpy.

Where a probe mode computes the function of the TPU kernel body it ports,
its plain version is held to a float64 numpy rendition of that body: the
softmax modes (the kernel, the local softmax, the chains) and the int8
flavors that convert to attention, the d = 128 stages (the skeleton's
S V, exp(S - 5) V, P cast to bf16, the whole softmax), the float32 stream.
The others are held to their own stated definition, the tile order
mirrored: the QK^T-only mode's (l, m) with O zero, the PV-only mode's
constant P over the tiles a warpgroup takes, the running max without
rescale, the native int8 products with the tile's largest V scale, the
page walk's folded words.  Tolerances: 2e-2 of the output's magnitude for
bf16 outputs, 1e-5 relative for float32 statistics and the stream.  The
inputs that isolate P's second bf16 term (``lo_term_qkv``) split exactly,
and over them a mode with its second term dropped misses by far more than
that tolerance.
"""

import dataclasses

import ml_dtypes
import numpy as np
import pytest
import torch

from flashattention_tpu_torch.ops import probes

torch.set_num_threads(2)

TOL, STATS = 2e-2, 1e-5
MASK = -0.7 * float(np.finfo(np.float32).max)


def _rel(got, want) -> float:
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    got = np.asarray(got, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _bf16(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)


def _np(x):
    return x.float().numpy().astype(np.float64)


def _scores(q, k, scale, causal, q_offset=0):
    s = np.einsum("bqd,bkd->bqk", q, k) * scale
    if causal:
        rows, cols = np.arange(q.shape[1])[:, None] + q_offset, np.arange(k.shape[1])[None, :]
        s = np.where(cols <= rows, s, -np.inf)
    return s


def _attention(q, k, v, scale, causal=False, q_offset=0):
    """Softmax attention in float64, with its row sums and maxima."""
    s = _scores(q, k, scale, causal, q_offset)
    m = s.max(-1)
    p = np.exp(s - m[..., None])
    l = p.sum(-1)
    return np.einsum("bqk,bkd->bqd", p, v) / l[..., None], l, m


@pytest.mark.parametrize("mode,d,causal", [(0, 64, False), (3, 64, False), (4, 64, False),
                                           (5, 64, False), (0, 64, True), (3, 64, True),
                                           (5, 64, True), (0, 128, True), (4, 128, True),
                                           (4, 128, False)])
def test_softmax_modes_are_attention(mode, d, causal):
    """The kernel, the local softmax (probe_local_softmax.py) and the chains
    (probe_chain.py, probe_d128.py's split2) all compute attention."""
    rng = np.random.default_rng(mode + d)
    q, k, v = (_bf16(rng, 2, 320, d) for _ in range(3))
    o, l, m = probes.probe_mma(mode, q, k, v, causal=causal)
    want, lw, mw = _attention(_np(q), _np(k), _np(v), d**-0.5, causal)
    assert _rel(o, want) <= TOL
    assert _rel(l, lw) <= STATS and _rel(m, mw) <= STATS


@pytest.mark.parametrize("causal", [False, True])
def test_qk_only_mode_keeps_o_zero(causal):
    rng = np.random.default_rng(1)
    q, k, v = (_bf16(rng, 2, 320, 128) for _ in range(3))
    o, l, m = probes.probe_mma(1, q, k, v, causal=causal)
    _, lw, mw = _attention(_np(q), _np(k), _np(v), 128**-0.5, causal)
    assert not o.any() and _rel(l, lw) <= STATS and _rel(m, mw) <= STATS


@pytest.mark.parametrize("causal", [False, True])
def test_pv_only_mode_sums_the_tiles_a_warpgroup_takes(causal):
    """P = 1/128 over every key of each 128-key tile a row's warpgroup of 64
    rows takes (all of them non-causal: probe_mxu.py's _pv_like, acc += P V
    over the tiles with a constant P); l = 0, m = -inf."""
    rng = np.random.default_rng(2)
    q, k, v = (_bf16(rng, 2, 320, 64) for _ in range(3))
    o, l, m = probes.probe_mma(2, q, k, v, causal=causal)
    vn = _np(v)
    want = np.zeros_like(vn)
    for r in range(320):
        last = min(320, (r // 64 + 1) * 64) - 1 if causal else 319
        want[:, r] = vn[:, : (last // 128 + 1) * 128].sum(1) / 128
    assert _rel(o, want) <= TOL
    assert not l.any() and bool((m == -torch.inf).all())


def _int8_inputs(rng, bh=2, rows=200, s_kv=512):
    q = _bf16(rng, bh, rows, 128)
    kb, vb = _bf16(rng, bh, s_kv, 128), _bf16(rng, bh, s_kv, 128)
    k8, v8 = (torch.from_numpy(rng.integers(-127, 127, (bh, s_kv, 128), dtype=np.int8))
              for _ in range(2))
    ks, vs = (torch.from_numpy((0.005 + 0.015 * rng.random((bh, s_kv))).astype(np.float32))
              for _ in range(2))
    return q, kb, vb, k8, v8, ks, vs


@pytest.mark.parametrize("causal", [False, True])
def test_int8_converting_flavors_are_attention(causal):
    """bf16 and int8cvt: attention over the K/V (dequantized), as
    probe_int8_decode.py's bf16 and converting flavors compute it."""
    rng = np.random.default_rng(3)
    q, kb, vb, k8, v8, ks, vs = _int8_inputs(rng)
    kw = dict(q_offset=312 if causal else 0, causal=causal, scale=128**-0.5)
    want = _attention(_np(q), _np(kb), _np(vb), 128**-0.5, causal, kw["q_offset"])[0]
    assert _rel(probes.probe_int8("bf16", q, kb, vb, **kw), want) <= TOL
    kd, vd = _np(k8) * _np(ks)[..., None], _np(v8) * _np(vs)[..., None]
    want = _attention(_np(q), kd, vd, 128**-0.5, causal, kw["q_offset"])[0]
    assert _rel(probes.probe_int8("int8cvt", q, k8, v8, ks, vs, **kw), want) <= TOL


@pytest.mark.parametrize("causal", [False, True])
def test_int8_native_flavor_follows_its_definition(causal):
    """int8mma: q by rows to int8 (absmax / 127, nearest even), integer
    scores, the online softmax over 128-key tiles, p as rint(127 p), the
    integer PV scaled by the tile's largest v_scale / 127."""
    rng = np.random.default_rng(4)
    q, _, _, k8, v8, ks, vs = _int8_inputs(rng)
    q_offset, scale = 312 if causal else 0, 128**-0.5
    got = probes.probe_int8("int8mma", q, k8, v8, ks, vs, q_offset=q_offset, causal=causal,
                            scale=scale)
    qn = _np(q)
    qs = np.abs(qn).max(-1) / 127
    q8 = np.clip(np.rint(qn / qs[..., None]), -127, 127)
    kn, vn, ksn, vsn = _np(k8), _np(v8), _np(ks), _np(vs)
    bh, rows, _ = qn.shape
    m = np.full((bh, rows), -np.inf)
    l, acc = np.zeros((bh, rows)), np.zeros(qn.shape)
    for t0 in range(0, kn.shape[1], 128):
        sl = slice(t0, t0 + 128)
        x = np.einsum("bqd,bkd->bqk", q8, kn[:, sl]) * qs[..., None] * ksn[:, None, sl] * scale
        if causal:
            cols = np.arange(t0, t0 + 128)[None, :]
            x = np.where(cols <= np.arange(rows)[:, None] + q_offset, x, MASK)
        mx = np.maximum(m, x.max(-1))
        alpha, p = np.exp(m - mx), np.exp(x - mx[..., None])
        m, l = mx, alpha * l + p.sum(-1)
        pv = np.einsum("bqk,bkd->bqd", np.rint(p * 127), vn[:, sl])
        acc = acc * alpha[..., None] + pv * (vsn[:, sl].max(-1) / 127)[:, None, None]
    assert _rel(got, acc / l[..., None]) <= TOL


def test_hbm_floor_is_the_sum():
    rng = np.random.default_rng(5)
    a, b, c = (torch.from_numpy(rng.standard_normal((3, 64, 64)).astype(np.float32))
               for _ in range(3))
    want = _np(a) + _np(b) + _np(c)
    assert _rel(probes.probe_stream_sum(a, b, c), want) <= STATS


@pytest.mark.parametrize("window", [None, 100])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float8_e4m3fn])
def test_page_walk_folds_the_rows_each_split_reads(window, dtype):
    """Each (request, KV head, split) word is the XOR of every 32-bit word of
    K ^ V over the rows the split's tiles of 64 columns hold in [first,
    end), through the page table."""
    rng = np.random.default_rng(6)
    nb, kvh, ps, pps, d = 3, 2, 64, 6, 128
    pages = nb * pps + 2
    k, v = (torch.from_numpy(rng.standard_normal((pages, kvh, ps, d)).astype(np.float32))
            .to(dtype) for _ in range(2))
    table = torch.from_numpy(rng.permutation(pages)[: nb * pps].reshape(nb, pps).astype(np.int32))
    lens = [1, 130, 300]
    splits, per = 4, 2
    got = probes.probe_page_walk(k, v, torch.tensor(lens, dtype=torch.int32), table,
                                 splits=splits, tiles_per_split=per, window=window)
    kw = k.view(torch.uint8).numpy().view(np.int32)
    vw = v.view(torch.uint8).numpy().view(np.int32)
    for b in range(nb):
        first = max(0, lens[b] - window) if window else 0
        for sp in range(splits):
            cols = range(max(sp * per * 64, first), min((sp + 1) * per * 64, lens[b]))
            for h in range(kvh):
                words = [kw[table[b, c // ps], h, c % ps] ^ vw[table[b, c // ps], h, c % ps]
                         for c in cols]
                want = np.bitwise_xor.reduce(np.concatenate(words)) if words else 0
                assert int(got[b, h, sp]) == int(want)


def _d128_want(name, q, k, v, scale):
    """probe_d128.py's bodies in float64 (k, v in (BH, S, d)): the skeleton
    S V, exp(S - 5) V, P = bf16(S) (pcast), the softmax; maxexp with the
    running max over 128-key tiles."""
    cfg = probes.D128_MODES[name]
    s = np.einsum("bqd,bkd->bqk", q, k) * scale
    if cfg.var == "full":
        return _attention(q, k, v, scale)[0]
    if cfg.var == "exp":
        p = np.exp(s - 5.0)
    elif cfg.var == "maxexp":
        m = np.maximum.accumulate(
            s.reshape(*s.shape[:2], -1, 128).max(-1), axis=-1).repeat(128, axis=-1)
        p = np.exp(s - m)
    else:
        p = s
    if cfg.terms == 1:
        p = p.astype(np.float32).astype(ml_dtypes.bfloat16).astype(np.float64)
    return np.einsum("bqk,bkd->bqd", p, v)


@pytest.mark.parametrize("name", list(probes.D128_MODES))
def test_d128_modes(name):
    rng = np.random.default_rng(7)
    q, k, v = (_bf16(rng, 2, 256, 128) for _ in range(3))
    cfg = probes.D128_MODES[name]
    kk = k.transpose(1, 2).contiguous() if cfg.kt else k
    vv = v.transpose(1, 2).contiguous() if cfg.vt else v
    got = probes.probe_d128(name, q, kk, vv)
    assert _rel(got, _d128_want(name, _np(q), _np(k), _np(v), 128**-0.5)) <= TOL


def test_d128_ones_and_one_tile_maxexp():
    """V all ones (probe_d128c.py's ``ones``); over one tile the running max
    is the row max, probe_d128.py's maxexp."""
    rng = np.random.default_rng(8)
    q, k, v = (_bf16(rng, 2, 256, 128) for _ in range(3))
    ones = torch.ones_like(v)
    want = _d128_want("skeleton", _np(q), _np(k), _np(ones), 128**-0.5)
    assert _rel(probes.probe_d128("skeleton", q, k, ones), want) <= TOL
    k1, v1 = k[:, :128].contiguous(), v[:, :128].contiguous()
    s = np.einsum("bqd,bkd->bqk", _np(q), _np(k1)) * 128**-0.5
    want = np.einsum("bqk,bkd->bqd", np.exp(s - s.max(-1, keepdims=True)), _np(v1))
    assert _rel(probes.probe_d128("maxexp", q, k1, v1), want) <= TOL


def test_lo_term_inputs_split_exactly():
    """``lo_term_qkv``: in each key pair bf16(S) is the same h and
    S - bf16(S) is +/-e, exact in bf16; the V rows are v and -v."""
    g = torch.Generator().manual_seed(3)
    q, k, v = probes.lo_term_qkv(2, 256, 64, generator=g)
    s = np.einsum("bqd,bkd->bqk", _np(q), _np(k))
    hi = s.astype(np.float32).astype(ml_dtypes.bfloat16).astype(np.float64)
    lo = s - hi
    np.testing.assert_array_equal(hi[..., 0::2], hi[..., 1::2])
    np.testing.assert_array_equal(lo[..., 0::2], -lo[..., 1::2])
    np.testing.assert_array_equal(lo.astype(ml_dtypes.bfloat16).astype(np.float64), lo)
    assert (lo != 0).all()
    np.testing.assert_array_equal(_np(v)[:, 0::2], -_np(v)[:, 1::2])


def _one_term(monkeypatch, name=None):
    """The plain versions with P's second term dropped: mode ``name`` of
    D128_MODES flipped to one term, or every probe_mma mode's split."""
    if name is None:
        monkeypatch.setattr(probes, "_two_term_bf16", lambda x: x.to(torch.bfloat16).float())
    else:
        cfg = probes.D128_MODES[name]
        monkeypatch.setitem(probes.D128_MODES, name, dataclasses.replace(cfg, terms=3 - cfg.terms))


@pytest.mark.parametrize("name", list(probes.D128_MODES))
def test_lo_term_inputs_tell_one_term_from_two_d128(name, monkeypatch):
    """Over ``lo_term_qkv``'s inputs at scale 1, the stages that feed S to
    PV give exactly sum 2 e v with two terms and 0 with one; for every mode
    dropping (or adding) the second term moves the output by far more than
    the probes' check tolerance (of the two-term skeleton's magnitude where
    the output is all 0)."""
    cfg = probes.D128_MODES[name]
    q, k, v = probes.lo_term_qkv(2, 512, 128, generator=torch.Generator().manual_seed(4))
    kk = k.transpose(1, 2).contiguous() if cfg.kt else k
    vv = v.transpose(1, 2).contiguous() if cfg.vt else v
    got = probes.probe_d128(name, q, kk, vv, scale=1.0)
    two = probes.probe_d128_plain("skeleton", q, k, v, scale=1.0).float()
    if cfg.var == "skeleton":
        s = np.einsum("bqd,bkd->bqk", _np(q), _np(k))
        lo = s - s.astype(np.float32).astype(ml_dtypes.bfloat16).astype(np.float64)
        want = np.einsum("bqk,bkd->bqd", lo, _np(v)) if cfg.terms == 2 else 0 * _np(q)
        np.testing.assert_array_equal(
            got.float().numpy(), torch.from_numpy(want).to(torch.bfloat16).float().numpy())
    _one_term(monkeypatch, name)
    flipped = probes.probe_d128(name, q, kk, vv, scale=1.0).float()
    norm = float((two if cfg.terms == 1 else got.float()).abs().max())
    assert float((flipped - got.float()).abs().max()) / norm > 5 * TOL


@pytest.mark.parametrize("mode,d", [(0, 64), (0, 128), (3, 64), (4, 64), (4, 128), (5, 64)])
def test_lo_term_inputs_tell_one_term_from_two_mma(mode, d, monkeypatch):
    """The same for ``probe_mma``'s modes that take P into PV: their
    output is the pairs' differences of P over l, and with one term it
    moves by far more than the check tolerance."""
    q, k, v = probes.lo_term_qkv(2, 512, d, generator=torch.Generator().manual_seed(5))
    got = probes.probe_mma(mode, q, k, v, scale=1.0)[0].float()
    want = _attention(_np(q), _np(k), _np(v), 1.0)[0]
    assert _rel(got, want) <= TOL
    _one_term(monkeypatch)
    flipped = probes.probe_mma(mode, q, k, v, scale=1.0)[0]
    assert _rel(flipped, got.numpy().astype(np.float64)) > 5 * TOL


# ── items 4, 5 and 7: scripts/probe_d128d.py, probe_d128e.py, probe_small_fp32b.py


def _uniform_bf16(rng, *shape):
    return torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32)).to(torch.bfloat16)


def _round_bf16(x):
    return x.astype(np.float32).astype(ml_dtypes.bfloat16).astype(np.float64)


def _d128de_want(name, q, k, v):
    """Float64 renditions of probe_d128d.py's and probe_d128e.py's kernel
    bodies, unscaled, over V stored (BH, S, d): exp(S - m) V with the
    row's max (base, t_*), divided by l (t_full), exp(S - 5) V rounded to
    bf16 (pv_bf16out), S[:, :128] V[:128] (t_qk_heavy), S_small tiled down
    the keys times V (t_pv_heavy); O in the mode's layout."""
    cfg = probes.D128DE_MODES[name]
    s = np.einsum("bqd,bkd->bqk", q, k)
    if cfg.var == "full":
        o = _attention(q, k, v, 1.0)[0]
    elif cfg.var == "rescale":
        o = np.einsum("bqk,bkd->bqd", np.exp(s - s.max(-1, keepdims=True)), v)
    elif cfg.var == "exp":
        o = _round_bf16(np.einsum("bqk,bkd->bqd", np.exp(s - 5.0), v))
    elif cfg.var == "qk_heavy":
        o = np.einsum("bqk,bkd->bqd", s[..., :128], v[:, :128])
    else:
        o = np.einsum("bqk,bkd->bqd", s[..., :128], v.reshape(v.shape[0], -1, 128, 128).sum(1))
    return o.transpose(0, 2, 1) if cfg.o_t else o


def _d128de_layout(cfg, v):
    return v.transpose(1, 2).contiguous() if cfg.vt else v


@pytest.mark.parametrize("name", list(probes.D128DE_MODES))
def test_d128de_modes(name):
    rng = np.random.default_rng(21)
    q, k, v = (_uniform_bf16(rng, 2, 256, 128) for _ in range(3))
    cfg = probes.D128DE_MODES[name]
    got = probes.probe_d128de(name, q, k, _d128de_layout(cfg, v))
    assert got.dtype == torch.float32
    assert _rel(got, _d128de_want(name, _np(q), _np(k), _np(v))) <= TOL


def _fp32_want(mode, q, k, v):
    """Float64 renditions of probe_small_fp32b.py's kernel body over the
    packed operands' values (hi + lo; bf16_skel: the bf16 values): S, P =
    S, exp(S - 5) or the softmax, P (bf16_skel: bf16(P)) times V."""
    if mode != "bf16_skel":
        q, k = q[..., :64] + q[..., 64:], k[..., :64] + k[..., 64:]
        v = v[..., :64] + v[..., 64:128]
    else:
        v = v[..., :64]
    s = np.einsum("bqd,bkd->bqk", q, k)
    if mode == "full":
        return _attention(q, k, v, 1.0)[0]
    p = np.exp(s - 5.0) if mode == "exp" else _round_bf16(s) if mode == "bf16_skel" else s
    return np.einsum("bqk,bkd->bqd", p, v)


@pytest.mark.parametrize("mode", list(probes.FP32_MODES))
def test_fp32_modes(mode):
    """Each mode over float32 inputs packed as the script packs them:
    within 1e-4 of the output's magnitude where P enters PV as two terms
    (float32 to about 2^-17), within the bf16 tolerance for bf16_skel."""
    rng = np.random.default_rng(22)
    qf, kf, vf = (torch.from_numpy(rng.uniform(-1, 1, (2, 256, 64)).astype(np.float32))
                  for _ in range(3))
    args = probes.fp32_inputs(qf, kf, vf, mode)
    assert args[2].stride(1) % 8 == 0
    got = probes.probe_fp32(mode, *args)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 256, 64)
    want = _fp32_want(mode, *(_np(x) for x in args))
    assert _rel(got, want) <= (TOL if mode == "bf16_skel" else 1e-4)


@pytest.mark.parametrize("name", list(probes.D128DE_MODES))
def test_lo_term_inputs_tell_one_term_from_two_d128de(name, monkeypatch):
    """Every mode of items 4 and 5 feeds P (or S) to PV as two bf16 terms:
    over ``lo_term_qkv``'s inputs, dropping the second term moves the
    output by far more than the probes' check tolerance."""
    cfg = probes.D128DE_MODES[name]
    q, k, v = probes.lo_term_qkv(2, 512, 128, generator=torch.Generator().manual_seed(23))
    got = probes.probe_d128de(name, q, k, _d128de_layout(cfg, v))
    assert _rel(got, _d128de_want(name, _np(q), _np(k), _np(v))) <= TOL
    _one_term(monkeypatch)
    flipped = probes.probe_d128de(name, q, k, _d128de_layout(cfg, v))
    assert _rel(flipped, got.numpy().astype(np.float64)) > 5 * TOL


@pytest.mark.parametrize("mode", [m for m in probes.FP32_MODES if m != "bf16_skel"])
def test_lo_term_inputs_tell_one_term_from_two_fp32(mode, monkeypatch):
    """The same for the packed float32 modes, over ``lo_term_qkv``'s values
    packed as float32 inputs (their second terms 0, S's second bf16 term
    carrying the output; two terms hold p to about 2^-17 of p, and the
    output here is the pairs' differences of p, about 2^-9 of p: so the
    bf16 tolerance)."""
    q, k, v = probes.lo_term_qkv(2, 512, 64, generator=torch.Generator().manual_seed(24))
    args = probes.fp32_inputs(q.float(), k.float(), v.float(), mode)
    got = probes.probe_fp32(mode, *args)
    assert _rel(got, _fp32_want(mode, *(_np(x) for x in args))) <= TOL
    _one_term(monkeypatch)
    flipped = probes.probe_fp32(mode, *args)
    assert _rel(flipped, got.numpy().astype(np.float64)) > 5 * TOL
