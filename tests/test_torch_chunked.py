"""Chunked prefill, prefix hits and the naive kernel: the port against the
JAX package.

The same numpy inputs go through the JAX function (its Pallas kernels in
interpret mode on the CPU) and its port (the kernels' plain versions on CPU
tensors).  Tolerances: 1e-4 in float32, 2e-2 in bfloat16 (the JAX kernels
round p to bfloat16 before PV, the port keeps it in float32).  Engine
scenarios follow ``tests/test_runtime.py``; greedy tokens must be IDENTICAL
to the JAX engine's, and the prefix cache's books (refcounts, parked pages,
index) must match it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattention_tpu.models import transformer as jt
from flashattention_tpu.ops import decode as jd
from flashattention_tpu.ops import flash as jf
from flashattention_tpu.runtime import engine as je
from flashattention_tpu.runtime import kvcache as jk
from flashattention_tpu_torch.models import transformer as tt
from flashattention_tpu_torch.ops import decode as td
from flashattention_tpu_torch.ops import flash as tf
from flashattention_tpu_torch.runtime import engine as te
from flashattention_tpu_torch.runtime import kvcache as tk
from flashattention_tpu_torch.utils.testing import to_numpy, validate_result

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


# ── the paged-prefill op ────────────────────────────────────────────────────


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("ctx,chunk", [(24, 8), (32, 16), (24, 24)])
def test_paged_prefill_matches_jax(ctx, chunk, dt):
    """Single-request op over shuffled pages, the table padded past the
    context with garbage pages, GQA G=2 folded with seg = chunk."""
    rng = np.random.default_rng(ctx + chunk)
    ps, kvh, g, d = 8, 2, 2, 32
    cap = -(-ctx // ps) + 2  # capacity-padded table
    total = cap + 3
    table = rng.permutation(total)[:cap].astype(np.int32)
    jkp, tkp = _pair(_rand(rng, (total, kvh, ps, d)), dt)
    jvp, tvp = _pair(_rand(rng, (total, kvh, ps, d)), dt)
    jq, tq = _pair(_rand(rng, (kvh, g * chunk, d)), dt)
    want = jd.paged_prefill_attention(
        jq, jkp, jvp, jnp.asarray(table), jnp.int32(ctx), chunk=chunk, seg=chunk,
        scale=d**-0.5, block_q=8,
    )
    got = td.paged_prefill_attention(
        tq, tkp, tvp, torch.from_numpy(table), ctx, chunk=chunk, seg=chunk, scale=d**-0.5,
    )
    assert got.dtype == TDT[dt]
    validate_result(got, np.asarray(want.astype(jnp.float32)), TOL[dt])
    oracle = td.paged_prefill_attention_reference(
        tq[None].float(), tkp.float(), tvp.float(), torch.from_numpy(table)[None],
        torch.tensor([ctx]), chunk=chunk, seg=chunk, scale=d**-0.5,
    )[0]
    validate_result(got, oracle, TOL[dt])


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_paged_prefill_batched_matches_jax(dt):
    """Ragged contexts (a 16-token prefix + chunk, the chunk only) and a
    dummy ctx = 0 row, which the port writes as zeros (the JAX kernel leaves
    it unwritten, so it is not compared)."""
    rng = np.random.default_rng(3)
    kvh, d, ps, pps, chunk, pool, b = 2, 64, 16, 8, 32, 32, 3
    jkp, tkp = _pair(_rand(rng, (pool, kvh, ps, d)), dt)
    jvp, tvp = _pair(_rand(rng, (pool, kvh, ps, d)), dt)
    jq, tq = _pair(_rand(rng, (b, kvh, chunk, d)), dt)
    table = ((np.arange(b * pps).reshape(b, pps) * 3) % pool).astype(np.int32)
    ctx = np.array([48, 32, 0], np.int32)
    want = jd.paged_prefill_attention_batched(
        jq, jkp, jvp, jnp.asarray(table), jnp.asarray(ctx), chunk=chunk, scale=0.5
    )
    got = td.paged_prefill_attention_batched(
        tq, tkp, tvp, torch.from_numpy(table), torch.from_numpy(ctx), chunk=chunk, scale=0.5
    )
    validate_result(got[:2], np.asarray(want[:2].astype(jnp.float32)), TOL[dt])
    assert torch.count_nonzero(got[2]) == 0
    for i in range(2):  # the single-request form is the batched one
        one = td.paged_prefill_attention(
            tq[i], tkp, tvp, torch.from_numpy(table[i]), int(ctx[i]), chunk=chunk, scale=0.5
        )
        assert torch.equal(one, got[i])


def test_paged_prefill_gqa_seg_longer_than_chunk_matches_jax():
    """G = 2 segments of seg = 16 rows of which chunk = 12 are real: the live
    rows agree, the pad rows are the caller's to drop."""
    rng = np.random.default_rng(5)
    kvh, g, d, ps, pps, chunk, seg, pool = 2, 2, 32, 8, 6, 12, 16, 20
    jkp, tkp = _pair(_rand(rng, (pool, kvh, ps, d)), "float32")
    jvp, tvp = _pair(_rand(rng, (pool, kvh, ps, d)), "float32")
    jq, tq = _pair(_rand(rng, (2, kvh, g * seg, d)), "float32")
    table = rng.permutation(pool)[: 2 * pps].reshape(2, pps).astype(np.int32)
    ctx = np.array([36, 12], np.int32)
    want = np.asarray(jd.paged_prefill_attention_batched(
        jq, jkp, jvp, jnp.asarray(table), jnp.asarray(ctx), chunk=chunk, seg=seg, scale=0.3
    ))
    got = to_numpy(td.paged_prefill_attention_batched(
        tq, tkp, tvp, torch.from_numpy(table), torch.from_numpy(ctx), chunk=chunk, seg=seg,
        scale=0.3,
    ))
    live = (np.arange(g * seg) % seg) < chunk
    validate_result(got[:, :, live], want[:, :, live], TOL["float32"])


# ── the model's chunk step ──────────────────────────────────────────────────


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jt.ModelConfig.tiny(), dtype="float32")
    tcfg = dataclasses.replace(tt.ModelConfig.tiny(), dtype="float32")
    jp = jt.init_params(jax.random.key(0), jcfg)
    tp = tt.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return (jcfg, jp), (tcfg, tp)


def _chunk_inputs(rng, pool, ps, chunk, bases, reals, pps):
    """Tokens, positions, tables and write rows of one chunk round: request
    i's chunk starts at ``bases[i]`` and has ``reals[i]`` real tokens; the
    rest of the chunk is pad tail, written to the out-of-range page."""
    b = len(bases)
    perm = rng.permutation(pool)
    tables = perm[: b * pps].reshape(b, pps).astype(np.int32)
    tokens = rng.integers(1, 256, (b, chunk)).astype(np.int32)
    positions = np.stack([np.arange(base, base + chunk) for base in bases]).astype(np.int32)
    wp = np.full((b, chunk), pool, np.int32)
    ws = np.zeros((b, chunk), np.int32)
    for i, (base, real) in enumerate(zip(bases, reals)):
        for t in range(real):
            wp[i, t] = tables[i, (base + t) // ps]
            ws[i, t] = (base + t) % ps
    ctx = np.array([base + chunk if real else 0 for base, real in zip(bases, reals)], np.int32)
    return tokens, positions, tables, wp, ws, ctx


def test_prefill_chunk_batched_matches_jax(models):
    """Two requests (16-token prefix + a full chunk; no prefix + a chunk
    with a 5-token pad tail) and a dummy row: logits of the real rows agree,
    the pools equal the JAX pools, and pad-tail rows leave them untouched."""
    (jcfg, jp), (tcfg, tp) = models
    rng = np.random.default_rng(11)
    layers, pool, kvh, ps, d, chunk, pps = 2, 16, 2, 8, 32, 16, 4
    tokens, positions, tables, wp, ws, ctx = _chunk_inputs(
        rng, pool, ps, chunk, bases=[16, 0, 0], reals=[16, 11, 0], pps=pps
    )
    kp0 = _rand(rng, (layers, pool, kvh, ps, d))
    vp0 = _rand(rng, (layers, pool, kvh, ps, d))
    jl, jkp, jvp, _, _ = jt.prefill_chunk_batched(
        jp, jnp.asarray(tokens), jnp.asarray(kp0), jnp.asarray(vp0), jnp.asarray(positions),
        jnp.asarray(tables), jnp.asarray(wp), jnp.asarray(ws), cfg=jcfg,
        ctx_lens=jnp.asarray(ctx),
    )
    tkp, tvp = torch.tensor(kp0), torch.tensor(vp0)
    tl = tt.prefill_chunk_batched(
        tp, torch.from_numpy(tokens), tkp, tvp, torch.from_numpy(positions),
        torch.from_numpy(tables), torch.from_numpy(wp), torch.from_numpy(ws), tcfg,
        ctx_lens=torch.from_numpy(ctx),
    )
    validate_result(tl[0], np.asarray(jl[0]), TOL["float32"])
    validate_result(tl[1, :11], np.asarray(jl[1, :11]), TOL["float32"])
    # Written rows agree to float32 rounding (the K/V projections are
    # computed by two frameworks); every other row is untouched, exactly.
    validate_result(tkp, np.asarray(jkp), TOL["float32"])
    validate_result(tvp, np.asarray(jvp), TOL["float32"])
    written = np.zeros((pool, ps), bool)
    written[wp[wp < pool], ws[wp < pool]] = True
    assert written.sum() == 16 + 11
    untouched = lambda x: np.moveaxis(x, 3, 2)[:, ~written]  # noqa: E731  (L, n, KVH, d)
    np.testing.assert_array_equal(untouched(tkp.numpy()), untouched(kp0))
    np.testing.assert_array_equal(untouched(tvp.numpy()), untouched(vp0))


def test_prefill_chunk_matches_jax(models):
    """The single-request chunk step, with ctx_len left to the table."""
    (jcfg, jp), (tcfg, tp) = models
    rng = np.random.default_rng(12)
    layers, pool, kvh, ps, d, chunk = 2, 12, 2, 8, 32, 16
    tokens, positions, tables, wp, ws, _ = _chunk_inputs(
        rng, pool, ps, chunk, bases=[8], reals=[16], pps=3
    )
    kp0 = _rand(rng, (layers, pool, kvh, ps, d))
    vp0 = _rand(rng, (layers, pool, kvh, ps, d))
    jl, jkp, _, _, _ = jt.prefill_chunk(
        jp, jnp.asarray(tokens[0]), jnp.asarray(kp0), jnp.asarray(vp0),
        jnp.asarray(positions[0]), jnp.asarray(tables[0]), jnp.asarray(wp[0]),
        jnp.asarray(ws[0]), cfg=jcfg,
    )
    tkp, tvp = torch.tensor(kp0), torch.tensor(vp0)
    tl = tt.prefill_chunk(
        tp, torch.from_numpy(tokens[0]), tkp, tvp, torch.from_numpy(positions[0]),
        torch.from_numpy(tables[0]), torch.from_numpy(wp[0]), torch.from_numpy(ws[0]), tcfg,
    )
    validate_result(tl, np.asarray(jl), TOL["float32"])
    validate_result(tkp, np.asarray(jkp), TOL["float32"])


# ── the engine ──────────────────────────────────────────────────────────────


def _engines(models, *, page_size=8, num_pages=64, **ecfg):
    (jcfg, jp), (tcfg, tp) = models
    cache = dict(num_layers=2, num_kv_heads=2, head_dim=32, page_size=page_size,
                 num_pages=num_pages, dtype="float32")
    j = je.Engine(jp, jcfg, jk.CacheConfig(**cache), je.EngineConfig(**ecfg))
    t = te.Engine(tp, tcfg, tk.CacheConfig(**cache), te.EngineConfig(**ecfg), device="cpu")
    return j, t


def _books(cache):
    """The prefix cache's state: refcounts, parked pages, index, free count."""
    return (dict(cache._refs), list(cache._cached_free), dict(cache._prefix_index),
            cache.num_free_pages())


def test_engine_chunked_prefill_matches_whole_prompt_and_jax(models):
    rng = np.random.default_rng(0)
    long_prompt = rng.integers(0, 256, size=37).tolist()  # 3 chunks, last padded
    outs = []
    for chunk in (0, 16):
        for eng in _engines(models, max_batch=2, pages_per_seq=16, prefill_chunk=chunk):
            a = eng.add_request(long_prompt, 6)
            b = eng.add_request([3, 1, 4], 6)
            out = eng.run()
            outs.append((out[a], out[b]))
            assert eng.cache.num_free_pages() == 64
    assert outs[0] == outs[1] == outs[2] == outs[3]


def test_engine_prefix_sharing_matches_jax(models):
    """Three prompts share one or two full pages of a donor's prompt: they
    adopt them at admission, prefill only the rest, and the books match."""
    base = [7, 1, 8, 2, 8, 1, 8, 2, 3, 1, 4, 1, 5, 9, 2, 6]  # two full pages
    prompts = [base + [2, 7], base + [9, 9, 9], base[:8] + [5, 5, 5, 5]]
    results = []
    for eng in _engines(models, max_batch=4, pages_per_seq=8, prefill_chunk=8):
        r0 = eng.add_request(base + [1], 4)
        eng.step()
        before = eng.stats()["prefill_tokens"]
        rids = [eng.add_request(p, 4) for p in prompts]
        eng.step()
        shared = sorted(n for n in eng.cache._refs.values() if n > 1)
        saved = sum(len(p) for p in prompts) - (eng.stats()["prefill_tokens"] - before)
        out = eng.run()
        assert not eng.cache._refs and eng.cache.num_free_pages() == 64
        results.append(([out[r] for r in [r0, *rids]], shared, saved, _books(eng.cache)))
    assert results[0] == results[1]
    assert results[1][1] and results[1][2] == 16 + 16 + 8


def test_engine_prefix_persistence_and_lru_match_jax(models):
    """A finished prompt's pages park in the LRU and a later identical
    prompt revives them; page pressure then evicts parked pages LRU-first."""
    base = [7, 1, 8, 2, 8, 1, 8, 2, 3, 1, 4, 1, 5, 9, 2, 6]
    results = []
    for eng in _engines(models, num_pages=10, max_batch=2, pages_per_seq=6, prefill_chunk=8):
        r0 = eng.add_request(base + [1], 3)
        out0 = eng.run()[r0]
        parked = _books(eng.cache)
        r1 = eng.add_request(base + [1], 3)
        out1 = eng.run()[r1]
        assert out1 == out0
        hit = eng.stats()["prefill_tokens"]
        r2 = eng.add_request(list(range(30, 70)), 2)  # 40 tokens: evicts parked pages
        out2 = eng.run()[r2]
        results.append((out0, out2, parked, hit, _books(eng.cache)))
    assert results[0] == results[1]
    assert results[1][3] == 17 + 1  # the second prompt prefilled 1 token past the hit


def test_engine_batched_chunked_prefill_matches_jax(models, monkeypatch):
    """Ragged long prompts (3, 2 and 4 chunk rounds) prefill in lockstep:
    4 batched calls, the first two with a batch bucket of 4."""
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 256, n).tolist() for n in (17, 9, 26)]
    calls = []
    real = tt.prefill_chunk_batched

    def spy(params, tokens, *a, **kw):
        calls.append(int(tokens.shape[0]))
        return real(params, tokens, *a, **kw)

    monkeypatch.setattr(tt, "prefill_chunk_batched", spy)
    outs = []
    for eng in _engines(models, max_batch=4, pages_per_seq=8, prefill_chunk=8):
        rids = [eng.add_request(p, 4) for p in prompts]
        out = eng.run()
        outs.append([out[r] for r in rids])
    assert outs[0] == outs[1]
    assert calls == [4, 4, 2, 1]
    assert eng.stats()["chunk_rounds"] == 4


def test_engine_chunked_preemption_matches_jax(models):
    """Page pressure in decode preempts the latest-admitted request; it
    re-admits, adopts its own parked prefix page and re-prefills the rest
    on the chunked path."""
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 256, n).tolist() for n in (15, 14)]
    outs, stats = [], []
    for eng in _engines(models, num_pages=5, max_batch=2, pages_per_seq=4, prefill_chunk=8):
        rids = [eng.add_request(p, 8) for p in prompts]
        out = eng.run(max_steps=200)
        assert eng.cache.num_free_pages() == 5
        outs.append([out[r] for r in rids])
        st = eng.stats()
        stats.append((st["preemptions"], st["prefill_tokens"], _books(eng.cache)))
    assert outs[0] == outs[1]
    assert stats[0] == stats[1] and stats[1][0] > 0
    assert stats[1][1] < 2 * (15 + 14)  # the re-prefill skipped the adopted page


@pytest.mark.parametrize("case", ["misconfigured_chunk", "over_reservation"])
def test_engine_chunked_config_errors_match_jax(models, case):
    if case == "misconfigured_chunk":  # not a multiple of page_size, at init
        with pytest.raises(ValueError):
            _engines(models, num_pages=16, prefill_chunk=20)
        (_, _), (tcfg, tp) = models
        cc = tk.CacheConfig(num_layers=2, num_kv_heads=2, head_dim=32, page_size=8, num_pages=16)
        with pytest.raises(ValueError):
            te.Engine(tp, tcfg, cc, te.EngineConfig(prefill_chunk=20), device="cpu")
    else:  # a prompt that cannot fit the pool is refused at add_request
        for eng in _engines(models, num_pages=4, max_batch=1, pages_per_seq=4, prefill_chunk=16):
            eng.add_request(list(range(17)), 1)
            with pytest.raises(ValueError):
                eng.add_request(list(range(33)), 1)


# ── the naive kernel ────────────────────────────────────────────────────────


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize(
    "kw",
    [dict(causal=True, q_offset=8), dict(causal=False, kv_len=20),
     dict(causal=True, kv_len=18, q_offset=4)],
    ids=["causal", "kv_len", "causal_kv_len_q_offset"],
)
def test_flash_attention_naive_matches_jax(d, kw):
    rng = np.random.default_rng(d)
    q, k, v = _rand(rng, (2, 16, d)), _rand(rng, (2, 24, d)), _rand(rng, (2, 24, d))
    want = jf.flash_attention_naive(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=d**-0.5, block_q=8, **kw
    )
    got = tf.flash_attention_naive(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), scale=d**-0.5, block_q=8, **kw
    )
    validate_result(got, np.asarray(want), TOL["float32"])
    with pytest.raises(ValueError):
        tf.flash_attention_naive(torch.tensor(q), torch.tensor(k), torch.tensor(v), block_q=32)


def test_flash_attention_naive_row_that_sees_nothing_is_zero():
    q = torch.ones(1, 8, 32)
    k = v = torch.ones(1, 8, 32)
    assert torch.count_nonzero(tf.flash_attention_naive(q, k, v, kv_len=0, block_q=8)) == 0
    o = tf.flash_attention_naive(q, k, v, causal=True, q_offset=-4, block_q=8)
    assert torch.count_nonzero(o[:, :4]) == 0 and torch.allclose(o[:, 4:], v[:, 4:])
