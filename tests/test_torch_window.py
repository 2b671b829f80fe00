"""Sliding window, logit softcap and head_dim 256: the port against the JAX
package.

The same numpy inputs go through the JAX function (its Pallas kernels in
interpret mode on the CPU) and its port (the kernels' plain versions on CPU
tensors), for the three serving ops, a Gemma-shaped model (head_dim 256, so
``num_q_heads * head_dim != d_model``) and the engine on
``tests/test_runtime.py``'s windowed model (window 12, softcap 30).
Tolerances: 1e-4 in float32, 2e-2 in bfloat16 (the JAX kernels round p to
bfloat16 before PV, the port keeps it in float32); greedy tokens must be
IDENTICAL to the JAX engine's.  The training steps take such models, and
``attention`` under autograd takes both options (their gradients against
the JAX package: ``tests/test_torch_bwd_window.py``).
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
from flashattention_tpu.runtime import engine as je
from flashattention_tpu.runtime import kvcache as jk
from flashattention_tpu_torch.models import train, transformer as tt
from flashattention_tpu_torch.ops import backward, decode as td, flash as tf
from flashattention_tpu_torch.ops import reference as tref
from flashattention_tpu_torch.runtime import engine as te
from flashattention_tpu_torch.runtime import kvcache as tk
from flashattention_tpu_torch.utils.testing import validate_result

torch.set_num_threads(2)

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(x, dt):
    """The same values as a JAX array and a torch tensor of dtype ``dt``."""
    j = jnp.asarray(x, JDT[dt])
    return j, torch.tensor(np.asarray(j.astype(jnp.float32))).to(TDT[dt])


def _rand(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


# ── the forward op ──────────────────────────────────────────────────────────

# (B, H, KVH, S_q, S_kv, d, window, softcap): ragged S with a GQA fold; the
# window alone; the cap alone; queries at the end of a longer KV sequence;
# head_dim 256.
FWD_CASES = [
    (1, 4, 2, 37, 37, 32, 9, 20.0),
    (2, 2, 2, 40, 40, 32, 16, None),
    (1, 2, 1, 24, 24, 64, None, 5.0),
    (1, 4, 2, 20, 53, 32, 11, 30.0),
    (1, 4, 2, 19, 19, 256, 6, 30.0),
]


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FWD_CASES, ids=lambda c: "-".join(map(str, c)))
def test_attention_window_softcap_matches_jax(case, dt):
    b, h, hkv, s_q, s_kv, d, window, cap = case
    rng = np.random.default_rng(s_q + d)
    jq, tq = _pair(_rand(rng, (b, h, s_q, d)), dt)
    jk_, tk_ = _pair(_rand(rng, (b, hkv, s_kv, d)), dt)
    jv, tv = _pair(_rand(rng, (b, hkv, s_kv, d)), dt)
    kw = dict(causal=True, scale=d**-0.5, window=window, logit_softcap=cap)
    want = fj.attention(jq, jk_, jv, **kw)
    got = ft.attention(tq, tk_, tv, **kw)
    assert got.dtype == TDT[dt] and got.shape == tq.shape
    validate_result(got, np.asarray(want.astype(jnp.float32)), TOL[dt])
    oracle = ft.attention(tq.float(), tk_.float(), tv.float(), implementation="xla", **kw)
    validate_result(got, oracle, TOL[dt])


def test_flash_attention_q_offset_kv_len_window_matches_reference():
    """The folded op with a GQA fold, queries at q_offset 10 and a live
    length 33 of 40 columns, and its residuals, against the JAX oracle."""
    from flashattention_tpu.ops import reference as jref

    rng = np.random.default_rng(4)
    q, k, v = _rand(rng, (2, 2 * 12, 32)), _rand(rng, (2, 40, 32)), _rand(rng, (2, 40, 32))
    kw = dict(causal=True, scale=0.2, window=7, logit_softcap=15.0)
    o, l, m = tf.flash_attention(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), kv_len=33, q_offset=10,
        q_seq_len=12, save_residuals=True, **kw,
    )
    # The JAX oracle on each of the two folded groups, KV unrepeated.
    for g in range(2):
        rows = slice(12 * g, 12 * (g + 1))
        wo, wl, wm = jref.attention_reference_with_stats(
            jnp.asarray(q[:, rows]), jnp.asarray(k), jnp.asarray(v), kv_len=33, q_offset=10, **kw
        )
        validate_result(o[:, rows], np.asarray(wo), TOL["float32"])
        validate_result(l[:, rows], np.asarray(wl), 1e-5 * float(np.abs(wl).max()))
        validate_result(m[:, rows], np.asarray(wm), 1e-5 * float(np.abs(wm).max()))


def test_window_requires_causal_and_positive_options():
    x = torch.zeros(1, 8, 32)
    with pytest.raises(ValueError, match="causal"):
        tf.flash_attention(x, x, x, window=4)
    with pytest.raises(ValueError):
        tf.flash_attention(x, x, x, causal=True, window=0)
    with pytest.raises(ValueError):
        ft.attention(x, x, x, causal=True, logit_softcap=-1.0)


# ── the paged ops ───────────────────────────────────────────────────────────


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [32, 256])
def test_paged_attention_window_softcap_matches_jax(d, dt):
    """Decode over shuffled pages, lengths on both sides of the window (20):
    1, 19, 20, 21 and 45 (the first three pages of the last lie wholly
    before it)."""
    rng = np.random.default_rng(d)
    b, kvh, g, ps, pps, pool = 5, 2, 2, 8, 6, 34
    lengths = np.array([1, 19, 20, 21, 45], np.int32)
    table = rng.permutation(pool)[: b * pps].reshape(b, pps).astype(np.int32)
    jq, tq = _pair(_rand(rng, (b, kvh, g, d)), dt)
    jkp, tkp = _pair(_rand(rng, (pool, kvh, ps, d)), dt)
    jvp, tvp = _pair(_rand(rng, (pool, kvh, ps, d)), dt)
    kw = dict(scale=d**-0.5, window=20, logit_softcap=15.0)
    want = jd.paged_attention(jq, jkp, jvp, jnp.asarray(lengths), jnp.asarray(table), **kw)
    got = td.paged_attention(tq, tkp, tvp, torch.from_numpy(lengths), torch.from_numpy(table), **kw)
    validate_result(got, np.asarray(want.astype(jnp.float32)), TOL[dt])


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [64, 256])
def test_paged_prefill_window_softcap_matches_jax(d, dt):
    """``tests/test_decode.py``'s windowed case: a 16-token prefix + chunk
    (the chunk's late rows see none of the prefix), the chunk only, and a
    dummy ctx = 0 row (zeros in the port, unwritten in JAX)."""
    rng = np.random.default_rng(3 + d)
    kvh, ps, pps, chunk, pool, b = 2, 16, 8, 32, 32, 3
    jkp, tkp = _pair(_rand(rng, (pool, kvh, ps, d)), dt)
    jvp, tvp = _pair(_rand(rng, (pool, kvh, ps, d)), dt)
    jq, tq = _pair(_rand(rng, (b, kvh, chunk, d)), dt)
    table = ((np.arange(b * pps).reshape(b, pps) * 3) % pool).astype(np.int32)
    ctx = np.array([48, 32, 0], np.int32)
    kw = dict(chunk=chunk, scale=0.5, window=20, logit_softcap=15.0)
    want = jd.paged_prefill_attention_batched(jq, jkp, jvp, jnp.asarray(table), jnp.asarray(ctx), **kw)
    got = td.paged_prefill_attention_batched(
        tq, tkp, tvp, torch.from_numpy(table), torch.from_numpy(ctx), **kw
    )
    validate_result(got[:2], np.asarray(want[:2].astype(jnp.float32)), TOL[dt])
    assert torch.count_nonzero(got[2]) == 0
    one = td.paged_prefill_attention(tq[0], tkp, tvp, torch.from_numpy(table[0]), 48, **kw)
    assert torch.equal(one, got[0])


def test_paged_prefill_gqa_seg_window_matches_jax():
    """G = 2 segments of seg = 16 rows, chunk 12, window 3: live rows agree
    with the JAX kernel; pad rows p >= 14, whose window (pos - 3, pos] lies
    wholly past the context, are zeros in the port (the caller drops pad
    rows; the JAX kernel's are not compared)."""
    rng = np.random.default_rng(5)
    kvh, g, d, ps, pps, chunk, seg, pool = 2, 2, 32, 8, 6, 12, 16, 20
    jkp, tkp = _pair(_rand(rng, (pool, kvh, ps, d)), "float32")
    jvp, tvp = _pair(_rand(rng, (pool, kvh, ps, d)), "float32")
    jq, tq = _pair(_rand(rng, (2, kvh, g * seg, d)), "float32")
    table = rng.permutation(pool)[: 2 * pps].reshape(2, pps).astype(np.int32)
    ctx = np.array([36, 12], np.int32)
    kw = dict(chunk=chunk, seg=seg, scale=0.3, window=3, logit_softcap=8.0)
    want = np.asarray(jd.paged_prefill_attention_batched(
        jq, jkp, jvp, jnp.asarray(table), jnp.asarray(ctx), **kw
    ))
    got = td.paged_prefill_attention_batched(
        tq, tkp, tvp, torch.from_numpy(table), torch.from_numpy(ctx), **kw
    )
    p = np.arange(g * seg) % seg
    live = p < chunk
    validate_result(got[:, :, live], want[:, :, live], TOL["float32"])
    assert torch.count_nonzero(got[:, :, p >= 14]) == 0
    assert torch.count_nonzero(got[:, :, (p == 12) | (p == 13)]) > 0


# ── the model ───────────────────────────────────────────────────────────────


@pytest.fixture(scope="module")
def gemma_tiny():
    """A Gemma-2-shaped tiny model: head_dim 256 with 4 q / 2 KV heads
    (4 * 256 = 1024 != d_model 128), window 12, softcap 30, float32."""
    kw = dict(head_dim=256, sliding_window=12, logit_softcap=30.0, dtype="float32")
    jcfg = dataclasses.replace(jt.ModelConfig.tiny(), **kw)
    tcfg = dataclasses.replace(tt.ModelConfig.tiny(), **kw)
    jp = jt.init_params(jax.random.key(1), jcfg)
    tp = tt.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return (jcfg, jp), (tcfg, tp)


def test_gemma_shaped_params_from_jax_prefill_and_decode(gemma_tiny):
    (jcfg, jp), (tcfg, tp) = gemma_tiny
    assert tp["layers"][0]["wq"].shape == (128, 4 * 256)
    assert tp["layers"][0]["wo"].shape == (4 * 256, 128)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 256, (2, 24)).astype(np.int32)
    jl, jkr, _ = jt.prefill(jp, jnp.asarray(tokens), cfg=jcfg)
    tl, tkr, _ = tt.prefill(tp, torch.from_numpy(tokens), tcfg)
    validate_result(tl, np.asarray(jl), TOL["float32"])
    validate_result(tkr, np.asarray(jkr), TOL["float32"])
    # One decode step at position 24 over the cached rows (3 pages of 8 + 1).
    layers, pool, ps = 2, 10, 8
    kp = np.zeros((layers, pool, 2, ps, 256), np.float32)
    vp = np.zeros_like(kp)
    _, _, jvr = jt.prefill(jp, jnp.asarray(tokens), cfg=jcfg)
    kr, vr = np.asarray(jkr), np.asarray(jvr)  # (L, B, S, KVH, d)
    table = np.array([[0, 1, 2, 3], [4, 5, 6, 7]], np.int32)
    for bi in range(2):
        for t in range(24):
            kp[:, table[bi, t // ps], :, t % ps] = kr[:, bi, t]
            vp[:, table[bi, t // ps], :, t % ps] = vr[:, bi, t]
    step = dict(
        tokens=np.array([5, 9], np.int32), positions=np.array([24, 24], np.int32),
        lengths=np.array([25, 25], np.int32), table=table,
        wp=np.array([3, 7], np.int32), ws=np.array([0, 0], np.int32),
    )
    jout = jt.decode_step(
        jp, *(jnp.asarray(step[n]) for n in ("tokens", "positions")), jnp.asarray(kp),
        jnp.asarray(vp), *(jnp.asarray(step[n]) for n in ("lengths", "table", "wp", "ws")),
        cfg=jcfg,
    )
    tkp, tvp = torch.tensor(kp), torch.tensor(vp)
    tout = tt.decode_step(
        tp, *(torch.from_numpy(step[n]) for n in ("tokens", "positions")), tkp, tvp,
        *(torch.from_numpy(step[n]) for n in ("lengths", "table", "wp", "ws")), tcfg,
    )
    validate_result(tout, np.asarray(jout[0]), TOL["float32"])


def test_gemma_shaped_prefill_chunk_matches_jax(gemma_tiny):
    """One chunk of 16 tokens at positions 16-31 over a 16-token context:
    the window (12) hides the first page from the chunk's late rows."""
    (jcfg, jp), (tcfg, tp) = gemma_tiny
    rng = np.random.default_rng(12)
    layers, pool, kvh, ps, d, chunk = 2, 8, 2, 8, 256, 16
    tokens = rng.integers(1, 256, chunk).astype(np.int32)
    positions = np.arange(16, 32).astype(np.int32)
    table = np.array([6, 1, 3, 5], np.int32)
    wp = table[positions // ps].astype(np.int32)
    ws = (positions % ps).astype(np.int32)
    kp0, vp0 = _rand(rng, (layers, pool, kvh, ps, d)), _rand(rng, (layers, pool, kvh, ps, d))
    jl, jkp, _, _, _ = jt.prefill_chunk(
        jp, jnp.asarray(tokens), jnp.asarray(kp0), jnp.asarray(vp0), jnp.asarray(positions),
        jnp.asarray(table), jnp.asarray(wp), jnp.asarray(ws), cfg=jcfg,
    )
    tkp, tvp = torch.tensor(kp0), torch.tensor(vp0)
    tl = tt.prefill_chunk(
        tp, torch.from_numpy(tokens), tkp, tvp, torch.from_numpy(positions),
        torch.from_numpy(table), torch.from_numpy(wp), torch.from_numpy(ws), tcfg,
    )
    validate_result(tl, np.asarray(jl), TOL["float32"])
    validate_result(tkp, np.asarray(jkp), TOL["float32"])


# ── the engine ──────────────────────────────────────────────────────────────


@pytest.fixture(scope="module")
def windowed():
    """``tests/test_runtime.py:796``'s model: tiny, float32, window 12,
    softcap 30."""
    kw = dict(dtype="float32", sliding_window=12, logit_softcap=30.0)
    jcfg = dataclasses.replace(jt.ModelConfig.tiny(), **kw)
    tcfg = dataclasses.replace(tt.ModelConfig.tiny(), **kw)
    jp = jt.init_params(jax.random.key(2), jcfg)
    tp = tt.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return (jcfg, jp), (tcfg, tp)


def _engines(models, **ecfg):
    (jcfg, jp), (tcfg, tp) = models
    cache = dict(num_layers=2, num_kv_heads=2, head_dim=32, page_size=8, num_pages=64,
                 dtype="float32")
    return (je.Engine(jp, jcfg, jk.CacheConfig(**cache), je.EngineConfig(**ecfg)),
            te.Engine(tp, tcfg, tk.CacheConfig(**cache), te.EngineConfig(**ecfg), device="cpu"))


@pytest.mark.parametrize("chunk", [0, 8], ids=["whole", "chunked"])
def test_engine_window_softcap_matches_jax(windowed, chunk):
    """test_runtime.py:796's prompts (8 tokens, and 18, chunked at 8), and,
    chunked, a donor of 26 tokens and a prompt of 30 that adopts its first
    three pages, which lie wholly before the window of the later rows."""
    rng = np.random.default_rng(9)
    donor = rng.integers(1, 256, 26).tolist()
    prompts = [[3, 1, 4, 1, 5, 9, 2, 6], list(range(1, 19)), donor[:24] + [7, 7, 7, 7, 7, 7]]
    results = []
    for eng in _engines(windowed, max_batch=4, pages_per_seq=8, prefill_chunk=chunk):
        first = eng.add_request(donor, 6)
        eng.step()
        rids = [first] + [eng.add_request(p, 6) for p in prompts]
        out = eng.run()
        results.append(([out[r] for r in rids], eng.stats()["prefill_tokens"]))
        assert eng.cache.num_free_pages() == 64
    assert results[0] == results[1]
    if chunk:  # the last prompt prefilled only its 6 tokens past the adopted pages
        assert results[1][1] == 26 + 8 + 18 + 6


# ── training and autograd ───────────────────────────────────────────────────


def test_training_and_autograd_refuse_window_and_softcap():
    """Once refused, now taken: the training steps build for Mistral- and
    Gemma-2-class models, and ``attention`` / ``attention_vjp`` under
    autograd with a window or a softcap give the gradients of the dense
    oracle's autograd; outside autograd the forward serves, and the naive
    kernel still has neither option."""
    for cfg in (tt.ModelConfig.mistral7b(), tt.ModelConfig.gemma2_9b()):
        for make in (train.make_train_step, train.make_train_step_packed):
            assert callable(make(cfg, device="cpu"))
    rng = np.random.default_rng(11)
    q = torch.tensor(_rand(rng, (1, 4, 40, 32)) * 4, requires_grad=True)
    k = torch.tensor(_rand(rng, (1, 2, 40, 32)), requires_grad=True)
    v = torch.tensor(_rand(rng, (1, 2, 40, 32)), requires_grad=True)
    t = torch.tensor(_rand(rng, (1, 4, 40, 32)))
    for kw in (dict(window=7), dict(logit_softcap=10.0), dict(window=7, logit_softcap=10.0)):
        kw.update(causal=True, scale=32**-0.5)
        ref = tref.attention_reference(q, k.repeat_interleave(2, 1), v.repeat_interleave(2, 1), **kw)
        want = torch.autograd.grad((ref * t).sum(), (q, k, v))
        got = torch.autograd.grad((ft.attention(q, k, v, **kw) * t).sum(), (q, k, v))
        o = backward.attention_vjp(q.reshape(2, 2 * 40, 32), k[0], v[0], kw["causal"], kw["scale"],
                                   q_seq_len=40, window=kw.get("window"),
                                   logit_softcap=kw.get("logit_softcap"))
        vjp = torch.autograd.grad((o.reshape(q.shape) * t).sum(), (q, k, v))
        for name, a, b, w in zip("qkv", got, vjp, want):
            validate_result(a, w, TOL["float32"], name=f"d{name}")
            validate_result(b, w, TOL["float32"], name=f"d{name} (attention_vjp)")
    with torch.no_grad():  # serving: the forward runs
        assert ft.attention(q, k, v, causal=True, window=4).shape == q.shape
    with pytest.raises(TypeError):  # the naive kernel has neither (flash.py:1690)
        tf.flash_attention_naive(q[0], k[0], v[0], causal=True, window=4)
