"""Quantized serving: the port's 8-bit paths against the JAX package.

The same numpy inputs go through the JAX function (its Pallas kernels in
interpret mode on the CPU) and its port (the kernels' plain versions on CPU
tensors):

- ``quantize``/``quantize_weight(s)`` and the int8/fp8 cache writes give the
  same payloads and scales, bit for bit;
- the attention ops over 8-bit K/V agree with the JAX kernels within 2e-2
  (``tests/test_quant.py``'s bound: the JAX kernels round p * v_scale to
  bfloat16 on the 8-bit path, the port's forms keep it as two bf16 terms or
  in float32; both take float32 q in bf16 there), and with the float32
  oracle over the dequantized K/V and q rounded to bf16 within 1e-4 (the
  JAX kernel's exact float32 path) where the tensor-core forms write O from
  their float32 sums, 2^-8 where the scalar form stores bf16, and within
  1e-5 in the exact ``"float32"`` mode of ``attention_quantized``, all
  relative to the outputs' magnitude, since K/V spread over two decades;
- the model steps and the engine serve 8-bit pools and weights: logits
  within 2e-2 of the JAX steps, greedy tokens equal to the JAX engine's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flashattention_tpu as fj
import flashattention_tpu_torch as ft
from flashattention_tpu.models import transformer as jt
from flashattention_tpu.ops import decode as jd
from flashattention_tpu.ops import quant as jq
from flashattention_tpu.ops import reference as jref
from flashattention_tpu.runtime import engine as je
from flashattention_tpu.runtime import kvcache as jk
from flashattention_tpu_torch.models import transformer as tt
from flashattention_tpu_torch.ops import decode as td
from flashattention_tpu_torch.ops import flash as tf
from flashattention_tpu_torch.ops import quant as tq
from flashattention_tpu_torch.runtime import engine as te
from flashattention_tpu_torch.runtime import kvcache as tk
from flashattention_tpu_torch.utils.testing import to_numpy, to_torch, validate_result

torch.set_num_threads(2)

QUANT_TOL = 2e-2  # vs the JAX kernels' 8-bit path (tests/test_quant.py's bound)
ORACLE_TOL = 1e-5  # vs the float32 oracle over the dequantized K/V
QDTYPES = ["int8", "fp8"]


def _vs_jax(got, want):
    """Against the JAX kernels' 8-bit path: QUANT_TOL relative to the
    output's magnitude (the bound of tests/test_quant.py, whose outputs are
    of magnitude ~1; these inputs spread K/V over two decades)."""
    want = np.asarray(want).astype(np.float32)
    validate_result(got, want, QUANT_TOL * max(1.0, float(np.abs(want).max())))


def _vs_oracle(got, want, tol=None):
    """Against a float32 oracle over the dequantized K/V: ORACLE_TOL (or
    ``tol``) relative to the output's magnitude, the order of float32 sums
    of values up to ~30."""
    want = np.asarray(want).astype(np.float32)
    validate_result(got, want, (tol or ORACLE_TOL) * max(1.0, float(np.abs(want).max())))


def _bits(t: torch.Tensor) -> np.ndarray:
    """A payload's raw bytes, for bit-for-bit comparison."""
    return t.contiguous().view(torch.uint8).numpy() if t.dtype != torch.int8 else t.numpy()


def _same_payload(j, t):
    return np.array_equal(_bits(to_torch(np.asarray(j))), _bits(t))


def _rows(rng, shape, decades=2.0):
    """Normal rows whose magnitudes spread over ``decades`` decades, so that
    a scale applied to the wrong row moves the result."""
    mag = 10.0 ** rng.uniform(-decades / 2, decades / 2, shape[:-1] + (1,))
    return (rng.standard_normal(shape) * mag).astype(np.float32)


# ── quantize / dequantize ───────────────────────────────────────────────────


@pytest.mark.parametrize("granularity", ["token", "head"])
@pytest.mark.parametrize("dtype", QDTYPES)
def test_quantize_matches_jax_bit_for_bit(dtype, granularity):
    rng = np.random.default_rng(0)
    x = _rows(rng, (3, 37, 64), decades=6.0)
    x[1, 5] = 0.0  # an all-zero row: scale 1, payload 0
    x[2] = 0.0  # an all-zero head
    a = jq.quantize(jnp.asarray(x), dtype, granularity=granularity)
    b = tq.quantize(torch.from_numpy(x), dtype, granularity=granularity)
    assert b.payload.dtype == tq.QUANT_DTYPES[dtype][0] and b.scales.dtype == torch.float32
    assert _same_payload(a.payload, b.payload)
    np.testing.assert_array_equal(np.asarray(a.scales), b.scales.numpy())
    assert torch.count_nonzero(b.payload[1, 5].float()) == 0
    assert float(b.scales[2].max()) == float(b.scales[2].min()) == 1.0
    if granularity == "token":
        assert float(b.scales[1, 5]) == 1.0
    np.testing.assert_array_equal(np.asarray(jq.dequantize(a)), tq.dequantize(b).numpy())
    ka, va = jq.quantize_kv(jnp.asarray(x), jnp.asarray(-x), dtype, granularity=granularity)
    kb, vb = tq.quantize_kv(torch.from_numpy(x), torch.from_numpy(-x), dtype,
                            granularity=granularity)
    assert _same_payload(ka.payload, kb.payload) and _same_payload(va.payload, vb.payload)


def test_quantize_refuses_bad_options():
    x = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match="dtype"):
        tq.quantize(x, "int4")
    with pytest.raises(ValueError, match="granularity"):
        tq.quantize(x, "int8", granularity="channel")
    with pytest.raises(ValueError, match="dtype"):
        tq.quantize_rows(x, "bf16")


@pytest.mark.parametrize("dtype", QDTYPES)
def test_quantize_weights_matches_jax_and_skips(dtype):
    cfg = jt.ModelConfig.tiny()
    jp = jt.init_params(jax.random.key(3), dataclasses.replace(cfg, dtype="float32"))
    jqp = jq.quantize_weights(jp, dtype)
    tp = tt.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    tqp = tq.quantize_weights(tp, dtype)
    for name in ("embed", "lm_head"):
        assert _same_payload(jqp[name].payload, tqp[name].payload)
        np.testing.assert_array_equal(np.asarray(jqp[name].scales), tqp[name].scales.numpy())
    for jl, tl in zip(jqp["layers"], tqp["layers"]):
        for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
            assert isinstance(tl[name], tq.QuantizedWeight) and tl[name].ldtype == "float32"
            assert _same_payload(jl[name].payload, tl[name].payload)
            np.testing.assert_array_equal(np.asarray(jl[name].scales), tl[name].scales.numpy())
        for name in ("attn_norm", "mlp_norm"):  # skipped: full precision
            assert torch.equal(tl[name], tp["layers"][0][name]) or tl[name].dim() == 1
            assert not isinstance(tl[name], tq.QuantizedWeight)
    assert not isinstance(tqp["final_norm"], tq.QuantizedWeight)
    # The router is skipped by name, a 2-D leaf like any projection.
    tree = {"router": torch.randn(8, 4), "w": torch.randn(8, 4), "b": torch.randn(4)}
    out = tq.quantize_weights(tree, dtype)
    assert torch.is_tensor(out["router"]) and torch.is_tensor(out["b"])
    assert isinstance(out["w"], tq.QuantizedWeight)
    # The dequantized weight is within half a step of the original.
    w = tp["lm_head"]
    step = w.abs().amax(dim=0) / 127.0
    if dtype == "int8":
        assert float((w - tq.dequantize_weight(tqp["lm_head"])).abs().sub(step / 2).max()) < 1e-6


def test_to_torch_bridges_fp8():
    x = np.asarray(jnp.asarray([1.5, -448.0, 0.0078125, 3.0], jnp.float8_e4m3fn))
    t = to_torch(x)
    assert t.dtype == torch.float8_e4m3fn
    np.testing.assert_array_equal(to_numpy(t), x.astype(np.float32))


# ── attention over quantized K/V ────────────────────────────────────────────

# (BH, S_q, S_kv, d, causal, q_seq_len, save_residuals): square, ragged S =
# 300, not causal, a GQA fold of 3 segments of 70 rows (not a tile multiple)
# with queries at the end of 100 KV rows, and residuals.
ATTN_CASES = [
    (2, 128, 128, 64, True, None, False),
    (2, 300, 300, 32, True, None, False),
    (2, 96, 160, 32, False, None, False),
    (2, 210, 100, 32, True, 70, False),
    (2, 128, 128, 64, True, None, True),
]


@pytest.mark.parametrize("dtype", QDTYPES)
@pytest.mark.parametrize("case", ATTN_CASES, ids=lambda c: "-".join(map(str, c)))
def test_attention_quantized_matches_jax(case, dtype):
    bh, s_q, s_kv, d, causal, q_seq_len, res = case
    rng = np.random.default_rng(s_q + d)
    q = rng.standard_normal((bh, s_q, d)).astype(np.float32)
    k, v = _rows(rng, (bh, s_kv, d)), _rows(rng, (bh, s_kv, d))
    rows = q_seq_len or s_q
    kw = dict(causal=causal, scale=d**-0.5, save_residuals=res)
    if causal:
        kw["q_offset"] = s_kv - rows
    if q_seq_len:
        kw["q_seq_len"] = q_seq_len
    jk_, jv = jq.quantize_kv(jnp.asarray(k), jnp.asarray(v), dtype)
    tk_, tv = tq.quantize_kv(torch.from_numpy(k), torch.from_numpy(v), dtype)
    want = jq.attention_quantized(jnp.asarray(q), jk_, jv, **kw)
    got = tq.attention_quantized(torch.from_numpy(q), tk_, tv, **kw)
    if res:
        (want, wl, wm), (got, gl, gm) = want, got
        _vs_jax(gm, wm)
        _vs_jax(gl, wl)
    assert got.shape == (bh, s_q, d) and got.dtype == torch.float32
    _vs_jax(got, want)
    # The float32 oracle over the dequantized K/V, group by group: at the
    # default precision over q rounded to bf16 where the tensor-core form
    # takes q in bf16, as the JAX kernel does (1e-4: P as two bf16 terms),
    # over q itself where the exact scalar form runs (d = 32), and exactly
    # in the "float32" mode.
    exact = tq.attention_quantized(torch.from_numpy(q), tk_, tv, precision="float32", **kw)
    exact = exact[0] if res else exact
    kd, vd = jq.dequantize(jk_), jq.dequantize(jv)
    tc = tf.f32_q_in_bf16(torch.float32, True, None, d)
    qb = np.asarray(jnp.asarray(q).astype(jnp.bfloat16).astype(jnp.float32)) if tc else q
    for g in range(s_q // rows):
        sl = slice(g * rows, (g + 1) * rows)
        for x, out, tol in ((qb, got, 1e-4 if tc else None), (q, exact, None)):
            oracle = jref.attention_reference(
                jnp.asarray(x[:, sl]), kd, vd, causal=causal, scale=d**-0.5,
                q_offset=kw.get("q_offset", 0),
            )
            _vs_oracle(out[:, sl], oracle, tol)


@pytest.mark.parametrize("dtype", QDTYPES)
def test_attention_scales_route_matches_jax(dtype):
    """``attention(k_scales=, v_scales=)`` with 4D GQA inputs (4 q / 2 KV
    heads), ragged S, the kernel route and the oracle route (xla), against
    the JAX package's, with (B, H_kv, S) and folded (B*H_kv, S) scales."""
    rng = np.random.default_rng(7)
    b, h, hkv, s, d = 2, 4, 2, 45, 32
    q = rng.standard_normal((b, h, s, d)).astype(np.float32)
    k, v = _rows(rng, (b, hkv, s, d)), _rows(rng, (b, hkv, s, d))
    jkq, jvq = jq.quantize_kv(jnp.asarray(k.reshape(b * hkv, s, d)),
                              jnp.asarray(v.reshape(b * hkv, s, d)), dtype)
    kq, vq = tq.quantize_kv(torch.from_numpy(k.reshape(b * hkv, s, d)),
                            torch.from_numpy(v.reshape(b * hkv, s, d)), dtype)
    jkw = dict(k_scales=jkq.scales.reshape(b, hkv, s), v_scales=jvq.scales.reshape(b, hkv, s))
    tkw = dict(k_scales=kq.scales.reshape(b, hkv, s), v_scales=vq.scales)
    jargs = (jnp.asarray(q), jkq.payload.reshape(b, hkv, s, d), jvq.payload.reshape(b, hkv, s, d))
    targs = (torch.from_numpy(q), kq.payload.reshape(b, hkv, s, d), vq.payload.reshape(b, hkv, s, d))
    for impl_j, impl_t in (("pallas", "cuda"), ("xla", "xla")):
        want = fj.sdpa(*jargs, causal=True, implementation=impl_j, **jkw)
        got = ft.sdpa(*targs, causal=True, implementation=impl_t, **tkw)
        assert got.shape == (b, h, s, d)
        if impl_t == "xla":
            _vs_oracle(got, want)
        else:
            _vs_jax(got, want)


def test_attention_scales_refused_under_autograd(monkeypatch):
    """Quantized K/V serve forward only: under autograd ``attention`` raises
    before the kernel's wrapper is called; with no grad it runs."""
    import flashattention_tpu_torch.ops.dispatch as dispatch

    calls = []
    real = dispatch.flash_attention
    monkeypatch.setattr(dispatch, "flash_attention", lambda *a, **k: calls.append(a) or real(*a, **k))
    kq, vq = tq.quantize_kv(torch.randn(2, 8, 32), torch.randn(2, 8, 32))
    q = torch.randn(2, 8, 32, requires_grad=True)
    with pytest.raises(NotImplementedError, match="backward"):
        ft.attention(q, kq.payload, vq.payload, causal=True, k_scales=kq.scales, v_scales=vq.scales)
    assert calls == []
    with torch.no_grad():
        ft.attention(q, kq.payload, vq.payload, causal=True, k_scales=kq.scales, v_scales=vq.scales)
    assert len(calls) == 1
    with pytest.raises(ValueError, match="together"):
        ft.attention(q.detach(), kq.payload, vq.payload, k_scales=kq.scales)
    with pytest.raises(ValueError, match="int8 or float8"):
        tf.flash_attention(q.detach(), kq.payload.float(), vq.payload.float(),
                           k_scales=kq.scales, v_scales=vq.scales)


# ── the paged ops over 8-bit pools ──────────────────────────────────────────


def _quant_pool(rng, shape, dtype):
    """A random pool ``(P, KVH, ps, d)`` quantized per row: the JAX payload
    and scales, and the port's (bit-equal), and the dequantized float32 pool."""
    x = _rows(rng, shape)
    jqt = jq.quantize(jnp.asarray(x.reshape(-1, shape[-2], shape[-1])), dtype)
    payload = jqt.payload.reshape(shape)
    scales = jqt.scales.reshape(shape[:-1])
    tp, ts = to_torch(np.asarray(payload)), to_torch(np.asarray(scales))
    return (payload, scales), (tp, ts), np.asarray(jq.dequantize(jqt)).reshape(shape)


# (d, G, window, softcap): the tiny models' width, Gemma-2's (d = 256, G = 2,
# window and softcap).
PAGED_CASES = [(32, 2, None, None), (256, 2, 20, 15.0)]


@pytest.mark.parametrize("dtype", QDTYPES)
@pytest.mark.parametrize("case", PAGED_CASES, ids=lambda c: "-".join(map(str, c)))
def test_paged_attention_quantized_matches_jax(case, dtype):
    d, g, window, cap = case
    rng = np.random.default_rng(d + g)
    b, kvh, ps, pps, pool = 5, 2, 8, 6, 34
    lengths = np.array([1, 19, 20, 21, 45], np.int32)
    table = rng.permutation(pool)[: b * pps].reshape(b, pps).astype(np.int32)
    q = rng.standard_normal((b, kvh, g, d)).astype(np.float32)
    (jkp, jks), (tkp, tks), kf = _quant_pool(rng, (pool, kvh, ps, d), dtype)
    (jvp, jvs), (tvp, tvs), vf = _quant_pool(rng, (pool, kvh, ps, d), dtype)
    kw = dict(scale=d**-0.5, window=window, logit_softcap=cap)
    args = (jnp.asarray(lengths), jnp.asarray(table))
    want = jd.paged_attention(jnp.asarray(q), jkp, jvp, *args, k_scales_pages=jks,
                              v_scales_pages=jvs, **kw)
    got = td.paged_attention(torch.from_numpy(q), tkp, tvp, torch.from_numpy(lengths),
                             torch.from_numpy(table), k_scales_pages=tks, v_scales_pages=tvs, **kw)
    _vs_jax(got, want)
    # The JAX kernel's exact float32 path over the dequantized pools, with q
    # rounded to bf16 where the tensor-core form takes it so (as the JAX
    # kernel's 8-bit path does), as it is where the exact scalar form runs
    # (d = 32).
    form = tf.kernel_form("paged_decode", torch.bfloat16, d, quantized=True, page_size=ps, rows=g)
    qo = jnp.asarray(q)
    qo = qo.astype(jnp.bfloat16).astype(jnp.float32) if form == "tc" else qo
    exact = jd.paged_attention(qo, jnp.asarray(kf), jnp.asarray(vf), *args, **kw)
    _vs_oracle(got, exact, 1e-4)
    # bfloat16 q: the output keeps q's dtype.
    got16 = td.paged_attention(torch.from_numpy(q).bfloat16(), tkp, tvp, torch.from_numpy(lengths),
                               torch.from_numpy(table), k_scales_pages=tks, v_scales_pages=tvs, **kw)
    assert got16.dtype == torch.bfloat16
    _vs_jax(got16, want)


@pytest.mark.parametrize("dtype", QDTYPES)
@pytest.mark.parametrize("case", [(64, 1, None, None), (256, 2, 20, 15.0)],
                         ids=["d64-g1", "d256-g2-window-cap"])
def test_paged_prefill_quantized_matches_jax(case, dtype):
    """A prefix + chunk, the chunk only, and a dummy ctx = 0 row (zeros in
    the port); the single-request form is the batched one with B = 1."""
    d, g, window, cap = case
    rng = np.random.default_rng(3 + d)
    kvh, ps, pps, chunk, pool, b = 2, 16, 8, 32, 32, 3
    (jkp, jks), (tkp, tks), kf = _quant_pool(rng, (pool, kvh, ps, d), dtype)
    (jvp, jvs), (tvp, tvs), vf = _quant_pool(rng, (pool, kvh, ps, d), dtype)
    q = rng.standard_normal((b, kvh, g * chunk, d)).astype(np.float32)
    table = ((np.arange(b * pps).reshape(b, pps) * 3) % pool).astype(np.int32)
    ctx = np.array([48, 32, 0], np.int32)
    kw = dict(chunk=chunk, seg=chunk, scale=d**-0.5, window=window, logit_softcap=cap)
    jargs = (jnp.asarray(table), jnp.asarray(ctx))
    want = jd.paged_prefill_attention_batched(jnp.asarray(q), jkp, jvp, *jargs,
                                              k_scales_pages=jks, v_scales_pages=jvs, **kw)
    got = td.paged_prefill_attention_batched(
        torch.from_numpy(q), tkp, tvp, torch.from_numpy(table), torch.from_numpy(ctx),
        k_scales_pages=tks, v_scales_pages=tvs, **kw)
    _vs_jax(got[:2], want[:2])
    assert torch.count_nonzero(got[2]) == 0
    # q rounded to bf16, as both kernels take it over 8-bit pages.
    qb = jnp.asarray(q).astype(jnp.bfloat16).astype(jnp.float32)
    exact = jd.paged_prefill_attention_batched(qb, jnp.asarray(kf), jnp.asarray(vf), *jargs, **kw)
    assert tf.kernel_form("paged_prefill", torch.bfloat16, d, quantized=True, page_size=ps) == "tc"
    _vs_oracle(got[:2], exact[:2], 1e-4)
    one = td.paged_prefill_attention(torch.from_numpy(q[0]), tkp, tvp, torch.from_numpy(table[0]),
                                     48, k_scales_pages=tks, v_scales_pages=tvs, **kw)
    assert torch.equal(one, got[0])


def test_paged_ops_refuse_bad_scales():
    q = torch.zeros(1, 2, 2, 32)
    pages = torch.zeros(3, 2, 8, 32, dtype=torch.int8)
    sc = torch.ones(3, 2, 8)
    lens, table = torch.ones(1, dtype=torch.int32), torch.zeros(1, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="together"):
        td.paged_attention(q, pages, pages, lens, table, k_scales_pages=sc)
    with pytest.raises(ValueError, match="float32"):
        td.paged_attention(q, pages, pages, lens, table, k_scales_pages=sc[:, :, :4],
                           v_scales_pages=sc)
    with pytest.raises(ValueError, match="dtypes differ"):  # 8-bit pages need their scales
        td.paged_attention(q, pages, pages, lens, table)


# ── the cache, the model steps, the engine ──────────────────────────────────


@pytest.mark.parametrize("dtype", QDTYPES)
def test_cache_append_matches_jax_bit_for_bit(dtype):
    rng = np.random.default_rng(11)
    cc = dict(num_layers=2, num_kv_heads=2, head_dim=32, page_size=8, num_pages=16, dtype=dtype)
    jc, tc = jk.PagedKVCache(jk.CacheConfig(**cc)), tk.PagedKVCache(tk.CacheConfig(**cc), device="cpu")
    assert tc.config.quantized and tc.k_pages.dtype == tq.QUANT_DTYPES[dtype][0]
    assert tc.k_scales.shape == (2, 16, 2, 8) and float(tc.k_scales.min()) == 1.0
    for sid, t in ((0, 11), (1, 5), (0, 6)):
        k, v = _rows(rng, (2, t, 2, 32)), _rows(rng, (2, t, 2, 32))
        jc.append(sid, jnp.asarray(k), jnp.asarray(v))
        tc.append(sid, torch.from_numpy(k), torch.from_numpy(v))
    for name in ("k_pages", "v_pages"):
        assert _same_payload(getattr(jc, name), getattr(tc, name))
    for name in ("k_scales", "v_scales"):
        np.testing.assert_array_equal(np.asarray(getattr(jc, name)), getattr(tc, name).numpy())
    assert tc.k_pages[1].shape == (16, 2, 8, 32) and tc.v_scales[1].shape == (16, 2, 8)
    assert tk.PagedKVCache(tk.CacheConfig(**{**cc, "dtype": "float32"}), device="cpu").k_scales is None


@pytest.fixture(scope="module")
def tiny32():
    cfg = dataclasses.replace(jt.ModelConfig.tiny(), dtype="float32")
    jp = jt.init_params(jax.random.key(0), cfg)
    tcfg = dataclasses.replace(tt.ModelConfig.tiny(), dtype="float32")
    return (cfg, jp), (tcfg, tt.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu"))


def _quant_pools(rng, dtype, layers=2, pool=12, kvh=2, ps=8, d=32):
    """JAX and port pools (payloads, scales) holding the same quantized rows."""
    out = []
    for _ in range(2):
        x = _rows(rng, (layers * pool * kvh, ps, d))
        qt = jq.quantize(jnp.asarray(x), dtype)
        out.append((qt.payload.reshape(layers, pool, kvh, ps, d), qt.scales.reshape(layers, pool, kvh, ps)))
    (jkp, jks), (jvp, jvs) = out
    tpools = [to_torch(np.asarray(a)).clone() for a in (jkp, jvp, jks, jvs)]
    return (jkp, jvp, jks, jvs), tpools


def _check_pools(jpools, tpools, dtype):
    """The pools after a step that wrote rows of both layers.  Layer 0's rows
    come from the embeddings alone: the same payloads and scales, but for a
    row whose value lands on the other side of a half step when the two
    frameworks' float32 projections differ in the last bit (at most 2
    elements, by one step).  Layer 1's rows see layer 0's attention, where
    the JAX kernels round to bfloat16 and the port does not: its dequantized
    rows agree within QUANT_TOL."""
    for jpay, jsc, tpay, tsc in zip(jpools[:2], jpools[2:], tpools[:2], tpools[2:]):
        a, b = np.asarray(jpay[0]).astype(np.float32), to_numpy(tpay[0])
        step = 1.0 if dtype == "int8" else np.maximum(np.abs(a), np.abs(b)) / 8  # an fp8 ulp
        assert (a != b).sum() <= 2 and np.all(np.abs(a - b) <= step), (a != b).sum()
        validate_result(tsc[0], np.asarray(jsc[0]), 1e-6 * float(np.abs(np.asarray(jsc)).max()))
        want = np.asarray(jpay).astype(np.float32) * np.asarray(jsc)[..., None]
        _vs_jax(tpay.float() * tsc[..., None], want)


@pytest.mark.parametrize("dtype", QDTYPES)
def test_decode_step_quantized_pools_matches_jax(tiny32, dtype):
    (jcfg, jp), (tcfg, tp) = tiny32
    rng = np.random.default_rng(21)
    (jkp, jvp, jks, jvs), (tkp, tvp, tks, tvs) = _quant_pools(rng, dtype)
    step = dict(
        tokens=np.array([5, 9, 0], np.int32), positions=np.array([20, 9, 0], np.int32),
        lengths=np.array([21, 10, 0], np.int32),
        table=np.array([[0, 1, 2], [3, 4, 5], [0, 0, 0]], np.int32),
        wp=np.array([2, 4, 12], np.int32), ws=np.array([4, 1, 0], np.int32),
    )
    jout = jt.decode_step(
        jp, *(jnp.asarray(step[n]) for n in ("tokens", "positions")), jkp, jvp,
        *(jnp.asarray(step[n]) for n in ("lengths", "table", "wp", "ws")), cfg=jcfg,
        k_scales=jks, v_scales=jvs,
    )
    tl = tt.decode_step(
        tp, *(torch.from_numpy(step[n]) for n in ("tokens", "positions")), tkp, tvp,
        *(torch.from_numpy(step[n]) for n in ("lengths", "table", "wp", "ws")), tcfg, tks, tvs,
    )
    _vs_jax(tl[:2], jout[0][:2])
    _check_pools(jout[1:], (tkp, tvp, tks, tvs), dtype)


@pytest.mark.parametrize("dtype", QDTYPES)
def test_prefill_chunk_batched_quantized_pools_matches_jax(tiny32, dtype):
    """Two requests' chunks of 16 (one at a 8-token prefix, one ragged with
    pad rows dropped) and a dummy row, over 8-bit pools."""
    (jcfg, jp), (tcfg, tp) = tiny32
    rng = np.random.default_rng(31)
    (jkp, jvp, jks, jvs), (tkp, tvp, tks, tvs) = _quant_pools(rng, dtype)
    chunk, ps = 16, 8
    tokens = rng.integers(1, 256, (3, chunk)).astype(np.int32)
    positions = np.stack([np.arange(8, 24), np.arange(16), np.zeros(16, np.int64)]).astype(np.int32)
    tables = np.array([[0, 1, 2], [3, 4, 0], [0, 0, 0]], np.int32)
    wp = np.full((3, chunk), 12, np.int32)
    ws = np.zeros((3, chunk), np.int32)
    for i, (base, real) in enumerate(((8, 16), (0, 11))):
        pos = np.arange(base, base + real)
        wp[i, :real], ws[i, :real] = tables[i][pos // ps], pos % ps
    ctx = np.array([24, 16, 0], np.int32)
    jl, *jpools = jt.prefill_chunk_batched(
        jp, jnp.asarray(tokens), jkp, jvp, jnp.asarray(positions), jnp.asarray(tables),
        jnp.asarray(wp), jnp.asarray(ws), cfg=jcfg, k_scales=jks, v_scales=jvs,
        ctx_lens=jnp.asarray(ctx),
    )
    tl = tt.prefill_chunk_batched(
        tp, torch.from_numpy(tokens), tkp, tvp, torch.from_numpy(positions),
        torch.from_numpy(tables), torch.from_numpy(wp), torch.from_numpy(ws), tcfg, tks, tvs,
        ctx_lens=torch.from_numpy(ctx),
    )
    _vs_jax(tl[0], jl[0])
    _vs_jax(tl[1, :11], jl[1, :11])
    _check_pools(jpools, (tkp, tvp, tks, tvs), dtype)


def _dequantized(params):
    return {
        k: (tq.dequantize_weight(v) if isinstance(v, tq.QuantizedWeight) else
            [_dequantized(x) for x in v] if isinstance(v, list) else v)
        for k, v in params.items()
    }


@pytest.mark.parametrize("wdtype", QDTYPES)
def test_weight_only_engine_same_tokens_as_dequantized_and_jax(tiny32, wdtype):
    """tests/test_quant.py:210's invariant in the port (quantized and
    dequantized parameters give the same greedy tokens), whole-prompt and
    chunked, and the JAX engine on the JAX package's quantized parameters,
    carried across by ``params_from_jax``, gives the same tokens too (in
    whole-prompt prefill: the JAX chunk step's final product,
    transformer.py:885, does not take a quantized lm_head)."""
    (jcfg, jp), (tcfg, _) = tiny32
    jqp = jq.quantize_weights(jp, wdtype)
    tqp = tt.params_from_jax(jax.tree.map(np.asarray, jqp), device="cpu")
    assert isinstance(tqp["lm_head"], tq.QuantizedWeight) and tqp["lm_head"].ldtype == "float32"
    prompts = [[3, 1, 4, 1, 5, 9, 2, 6], list(range(1, 20))]
    cc = dict(num_layers=2, num_kv_heads=2, head_dim=32, page_size=8, num_pages=64, dtype="float32")

    def gen(params, chunk, jax_side=False):
        if jax_side:
            eng = je.Engine(params, jcfg, jk.CacheConfig(**cc),
                            je.EngineConfig(max_batch=2, pages_per_seq=8, prefill_chunk=chunk))
        else:
            eng = te.Engine(params, tcfg, tk.CacheConfig(**cc),
                            te.EngineConfig(max_batch=2, pages_per_seq=8, prefill_chunk=chunk),
                            device="cpu")
        rids = [eng.add_request(p, 6) for p in prompts]
        out = eng.run()
        return [out[r] for r in rids]

    for chunk in (0, 8):
        got = gen(tqp, chunk)
        assert got == gen(_dequantized(tqp), chunk)
        if not chunk:
            assert got == gen(jqp, chunk, jax_side=True)


@pytest.mark.parametrize("dtype", QDTYPES)
def test_quantized_kv_engine_matches_jax(tiny32, dtype):
    """tests/test_runtime.py:301's int8-KV chunked engine (a 40-token prompt
    in chunks of 16), and whole-prompt prefill with an 8-bit cache: the port
    generates the JAX engine's greedy tokens."""
    (jcfg, jp), (tcfg, tp) = tiny32
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 256, size=40).tolist(), [3, 1, 4, 1, 5, 9, 2, 6]]
    cc = dict(num_layers=2, num_kv_heads=2, head_dim=32, page_size=8, num_pages=64, dtype=dtype)
    for chunk in (16, 0):
        outs = []
        for mod, params, kw in ((je, jp, {}), (te, tp, {"device": "cpu"})):
            cache_mod = jk if mod is je else tk
            eng = mod.Engine(params, jcfg if mod is je else tcfg, cache_mod.CacheConfig(**cc),
                             mod.EngineConfig(max_batch=2, pages_per_seq=16, prefill_chunk=chunk), **kw)
            rids = [eng.add_request(p, 5) for p in prompts]
            out = eng.run()
            outs.append([out[r] for r in rids])
            assert all(len(o) == 5 for o in outs[-1])
        assert outs[0] == outs[1], (chunk, outs)


@pytest.mark.parametrize("model", ["tiny", "default_float32"])
def test_int8_engine_at_the_runtime_tests_shapes_matches_jax(model):
    """``tests/test_runtime.py:301``'s engine (an int8 cache of 8-token pages,
    a 40-token prompt in chunks of 16, 5 tokens) on ``ModelConfig.tiny()`` in
    its own bfloat16 (d = 32, G = 2), and on the default ``ModelConfig()``
    (d = 64, G = 2) in float32 (in bfloat16 the two frameworks' roundings
    part ways at its third token): the port generates the JAX engine's
    greedy tokens.  On the card, paged decode's 8-bit form serves both
    shapes (``tests/test_torch_cuda.py``)."""
    jcfg, tcfg = jt.ModelConfig.tiny(), tt.ModelConfig.tiny()
    if model == "default_float32":
        jcfg = dataclasses.replace(jt.ModelConfig(), dtype="float32")
        tcfg = dataclasses.replace(tt.ModelConfig(), dtype="float32")
    jp = jt.init_params(jax.random.key(0), jcfg)
    tp = tt.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    cc = dict(num_layers=jcfg.num_layers, num_kv_heads=jcfg.num_kv_heads, head_dim=jcfg.head_dim,
              page_size=8, num_pages=64, dtype="int8")
    prompt = np.random.default_rng(1).integers(0, jcfg.vocab_size, size=40).tolist()
    outs = []
    for mod, cache_mod, params, cfg, kw in ((je, jk, jp, jcfg, {}),
                                            (te, tk, tp, tcfg, {"device": "cpu"})):
        eng = mod.Engine(params, cfg, cache_mod.CacheConfig(**cc),
                         mod.EngineConfig(max_batch=2, pages_per_seq=16, prefill_chunk=16), **kw)
        rid = eng.add_request(prompt, 5)
        outs.append(eng.run()[rid])
    assert len(outs[1]) == 5 and outs[0] == outs[1], outs
