"""Multi-step decode and speculative decoding: the port against the JAX
package.

The same numpy inputs go through the JAX function (its Pallas kernels in
interpret mode on the CPU) and its port (the kernels' plain versions on CPU
tensors):

- ``paged_attention(draft_k=k)``: k-minor draft rows, each at its own causal
  limit, with and without a window (one narrower than k) and softcap, on
  float pages (1e-4 in float32, 2e-2 in bfloat16: the JAX kernel rounds p
  to bfloat16 before PV) and on int8/fp8 pages (``tests/test_quant.py``'s
  bounds, as ``tests/test_torch_quant.py`` holds the decode form);
- ``verify_step`` logits (1e-4, float32) and the prefill logits at the same
  positions; ``speculative_accept`` bit for bit, ties included;
  ``decode_loop``'s greedy tokens;
- the engine's ``run(multi_step=4)`` (an eos mid-span, page pressure with
  rollback) and ``run_speculative`` (oracle and garbage drafts) give the JAX
  engine's tokens and free every page;
- sampled serving: the accept rule's first token is distributed as the
  filtered target, and a sampled ``multi_step=4`` run equals the sampled
  per-token run under one seed (a ``torch.Generator`` draws other numbers
  than a JAX key, so sampled tokens are compared within the port).

The models are ``tests/test_runtime.py``'s: ``ModelConfig.tiny()`` in
float32, 2 layers, page 8, whole-prompt prefill.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattention_tpu.models import transformer as jt
from flashattention_tpu.ops import decode as jd
from flashattention_tpu.ops import quant as jq
from flashattention_tpu.ops import sampling as js
from flashattention_tpu.runtime import engine as je
from flashattention_tpu.runtime import kvcache as jk
from flashattention_tpu_torch.models import transformer as tt
from flashattention_tpu_torch.ops import decode as td
from flashattention_tpu_torch.ops import sampling as ts
from flashattention_tpu_torch.runtime import engine as te
from flashattention_tpu_torch.runtime import kvcache as tk
from flashattention_tpu_torch.utils.testing import to_torch, validate_result

torch.set_num_threads(2)

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
QUANT_TOL = 2e-2  # vs the JAX kernel's 8-bit path (tests/test_quant.py's bound)


def _pair(x, dt):
    """The same values as a JAX array and a torch tensor of dtype ``dt``."""
    j = jnp.asarray(x, JDT[dt])
    return j, torch.tensor(np.asarray(j.astype(jnp.float32))).to(TDT[dt])


# ── the kernel's draft form ─────────────────────────────────────────────────

# (k, G, window, softcap, dtype): lengths 4-45 over page 8 cross pages and
# the window (20); a window of 3 < k = 4 leaves the later rows no column of
# the first page the loop visits.
DRAFT_CASES = [
    (2, 1, None, None, "float32"),
    (4, 2, None, None, "bfloat16"),
    (2, 2, 20, None, "float32"),
    (4, 1, 20, 15.0, "bfloat16"),
    (4, 2, 3, 15.0, "float32"),
]


def _draft_inputs(rng, k, g, d):
    b, kvh, ps, pps, pool = 5, 2, 8, 6, 34
    lengths = np.array([4, 19, 20, 21, 45], np.int32)
    table = rng.permutation(pool)[: b * pps].reshape(b, pps).astype(np.int32)
    q = rng.standard_normal((b, kvh, g * k, d)).astype(np.float32)
    return q, lengths, table, (pool, kvh, ps, d)


@pytest.mark.parametrize("case", DRAFT_CASES, ids=lambda c: "-".join(map(str, c)))
def test_paged_attention_draft_matches_jax(case):
    k, g, window, cap, dt = case
    rng = np.random.default_rng(k * 10 + g)
    q, lengths, table, pool = _draft_inputs(rng, k, g, 32)
    jqq, tq = _pair(q, dt)
    jkp, tkp = _pair(rng.standard_normal(pool), dt)
    jvp, tvp = _pair(rng.standard_normal(pool), dt)
    kw = dict(scale=32**-0.5, draft_k=k, window=window, logit_softcap=cap)
    want = jd.paged_attention(jqq, jkp, jvp, jnp.asarray(lengths), jnp.asarray(table), **kw)
    got = td.paged_attention(tq, tkp, tvp, torch.from_numpy(lengths), torch.from_numpy(table), **kw)
    assert got.dtype == TDT[dt] and got.shape == tq.shape
    validate_result(got, np.asarray(want.astype(jnp.float32)), TOL[dt])
    # Row g * k + j is the decode query of a request j + 1 - k tokens shorter.
    for j in range(k):
        one = td.paged_attention(
            tq[:, :, j::k].contiguous(), tkp, tvp, torch.from_numpy(lengths - k + 1 + j),
            torch.from_numpy(table), **{**kw, "draft_k": 1})
        validate_result(got[:, :, j::k], one.float().numpy(), TOL[dt])


@pytest.mark.parametrize("dtype", ["int8", "fp8"])
def test_paged_attention_draft_quantized_matches_jax(dtype):
    """8-bit pages at k = 4, G = 2 with window 20 and softcap: the JAX
    kernel's 8-bit path within QUANT_TOL, its exact float32 path over the
    dequantized pools within 1e-4 (both relative to the outputs' size, as
    ``tests/test_torch_quant.py``)."""
    rng = np.random.default_rng(7)
    q, lengths, table, pool = _draft_inputs(rng, 4, 2, 32)
    mag = 10.0 ** rng.uniform(-1, 1, pool[:-1] + (1,))
    pools = []
    for _ in range(2):
        x = (rng.standard_normal(pool) * mag).astype(np.float32)
        jqt = jq.quantize(jnp.asarray(x.reshape(-1, pool[-2], pool[-1])), dtype)
        payload, scales = jqt.payload.reshape(pool), jqt.scales.reshape(pool[:-1])
        pools.append(((payload, scales), (to_torch(np.asarray(payload)), to_torch(np.asarray(scales))),
                      np.asarray(jq.dequantize(jqt)).reshape(pool)))
    (jkp, jks), (tkp, tks), kf = pools[0]
    (jvp, jvs), (tvp, tvs), vf = pools[1]
    kw = dict(scale=32**-0.5, draft_k=4, window=20, logit_softcap=15.0)
    args = (jnp.asarray(lengths), jnp.asarray(table))
    got = td.paged_attention(torch.from_numpy(q), tkp, tvp, torch.from_numpy(lengths),
                             torch.from_numpy(table), k_scales_pages=tks, v_scales_pages=tvs, **kw)
    want = jd.paged_attention(jnp.asarray(q), jkp, jvp, *args, k_scales_pages=jks,
                              v_scales_pages=jvs, **kw)
    want = np.asarray(want, np.float32)
    validate_result(got, want, QUANT_TOL * max(1.0, float(np.abs(want).max())))
    exact = np.asarray(jd.paged_attention(jnp.asarray(q), jnp.asarray(kf), jnp.asarray(vf), *args, **kw))
    validate_result(got, exact, 1e-4 * max(1.0, float(np.abs(exact).max())))


def test_paged_attention_draft_refuses_bad_rows():
    q = torch.zeros(1, 2, 6, 32)
    pages = torch.zeros(3, 2, 8, 32)
    lens, table = torch.full((1,), 6, dtype=torch.int32), torch.zeros(1, 2, dtype=torch.int32)
    for k in (4, 0):
        with pytest.raises(ValueError, match="multiple of draft_k"):
            td.paged_attention(q, pages, pages, lens, table, draft_k=k)
    assert td.paged_attention(q, pages, pages, lens, table, draft_k=3).shape == q.shape


# ── the model steps ─────────────────────────────────────────────────────────


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jt.ModelConfig.tiny(), dtype="float32")
    tcfg = dataclasses.replace(tt.ModelConfig.tiny(), dtype="float32")
    jp = jt.init_params(jax.random.key(0), jcfg)
    tp = tt.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return (jcfg, jp), (tcfg, tp)


PROMPTS = [[3, 1, 4, 1, 5, 9, 2, 6], [6, 2, 9, 5, 1, 4, 1, 3]]


def _prefilled(models, pps):
    """Both prompts prefilled by the JAX model into fresh float32 pools
    (page 8, request b on pages b * pps ...): JAX pools, torch pools, the
    tables and the prefill's greedy next tokens."""
    (jcfg, jp), _ = models
    b, s, ps = len(PROMPTS), len(PROMPTS[0]), 8
    logits, k_rows, v_rows = jt.prefill(jp, jnp.asarray(PROMPTS, jnp.int32), cfg=jcfg)
    shape = (jcfg.num_layers, b * pps + 1, jcfg.num_kv_heads, ps, jcfg.head_dim)
    kp, vp = jnp.zeros(shape, jnp.float32), jnp.zeros(shape, jnp.float32)
    for bi in range(b):
        kp = kp.at[:, bi * pps, :, :s, :].set(jnp.moveaxis(k_rows[:, bi], 2, 1))
        vp = vp.at[:, bi * pps, :, :s, :].set(jnp.moveaxis(v_rows[:, bi], 2, 1))
    table = np.arange(b * pps, dtype=np.int32).reshape(b, pps)
    first = np.asarray(jnp.argmax(logits[:, s - 1], axis=-1)).astype(np.int32)
    pools = (torch.from_numpy(np.array(kp)), torch.from_numpy(np.array(vp)))
    return (kp, vp), pools, table, first


def test_verify_step_matches_jax_and_prefill(models):
    (jcfg, jp), (tcfg, tp) = models
    s, kk, ps = len(PROMPTS[0]), 4, 8
    (jkp, jvp), (tkp, tvp), table, first = _prefilled(models, 2)
    fed = np.concatenate([first[:, None], np.array([[7, 7, 7], [1, 2, 3]], np.int32)], axis=1)
    pos = np.arange(s, s + kk)
    wp = np.stack([table[bi, pos // ps] for bi in range(2)]).astype(np.int32)
    ws = np.broadcast_to(pos % ps, (2, kk)).astype(np.int32)
    want, jkp2, *_ = jt.verify_step(jp, jnp.asarray(fed), jnp.full((2,), s, jnp.int32), jkp, jvp,
                                    jnp.asarray(table), jnp.asarray(wp), jnp.asarray(ws), cfg=jcfg)
    got = tt.verify_step(tp, torch.from_numpy(fed).long(), torch.full((2,), s), tkp, tvp,
                         torch.from_numpy(table), torch.from_numpy(wp), torch.from_numpy(ws), tcfg)
    assert got.shape == (2, kk, tcfg.vocab_size)
    validate_result(got, np.asarray(want), 1e-4)
    validate_result(tkp, np.asarray(jkp2), 1e-5)  # the fed tokens' K rows, written in place
    # Logits j are the prefill's at position s + j of prompt + fed tokens.
    full = torch.from_numpy(np.concatenate([np.asarray(PROMPTS), fed], axis=1)).long()
    ref, _, _ = tt.prefill(tp, full, tcfg)
    validate_result(got, ref[:, s:].numpy(), 2e-3)


def test_speculative_accept_matches_jax_with_ties():
    """Bit for bit, where two entries of a row tie for the maximum (the
    first wins, as ``jnp.argmax``): all accepted, a mismatch at 0 and at 1."""
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((6, 4, 9)).astype(np.float32)
    logits[:, :, 5] = logits.max(-1) + 1.0
    logits[:, :, 2] = logits[:, :, 5]  # tie: token 2 is the argmax
    logits[3, 1, 7] = 9.0
    drafts = np.full((6, 3), 2, np.int32)
    drafts[1, 0] = 5  # the other tied token: rejected
    drafts[2, 1] = 0
    drafts[3, 1] = 7
    drafts[4] = [2, 2, 1]
    n_j, e_j = jt.speculative_accept(jnp.asarray(drafts), jnp.asarray(logits))
    n_t, e_t = tt.speculative_accept(torch.from_numpy(drafts).long(), torch.from_numpy(logits))
    np.testing.assert_array_equal(n_t.numpy(), np.asarray(n_j))
    np.testing.assert_array_equal(e_t.numpy(), np.asarray(e_j))
    assert n_t.tolist() == [4, 1, 2, 4, 3, 4]


def test_decode_loop_matches_jax(models):
    (jcfg, jp), (tcfg, tp) = models
    s, n = len(PROMPTS[0]), 5
    (jkp, jvp), (tkp, tvp), table, first = _prefilled(models, 4)
    want, jkp2, *_ = jt.decode_loop(jp, jnp.asarray(first), jnp.full((2,), s, jnp.int32), jkp, jvp,
                                    jnp.asarray(table), cfg=jcfg, n_steps=n)
    got = tt.decode_loop(tp, torch.from_numpy(first).long(), torch.full((2,), s), tkp, tvp,
                         torch.from_numpy(table), tcfg, n)
    assert got.tolist() == np.asarray(want).tolist()
    validate_result(tkp, np.asarray(jkp2), 1e-5)
    # An inactive row writes nothing: its pages stay as they were.
    (_, _), (tkp3, tvp3), _, _ = _prefilled(models, 4)
    before = tkp3[:, 4:8].clone()
    got1 = tt.decode_loop(tp, torch.from_numpy(first).long(), torch.full((2,), s), tkp3, tvp3,
                          torch.from_numpy(table), tcfg, n, active=torch.tensor([True, False]))
    assert got1[0].tolist() == got[0].tolist()
    assert torch.equal(tkp3[:, 4:8], before)


# ── the engine ──────────────────────────────────────────────────────────────


def _engines(models, num_pages, **ecfg):
    (jcfg, jp), (tcfg, tp) = models
    cache = dict(num_layers=2, num_kv_heads=2, head_dim=32, page_size=8,
                 num_pages=num_pages, dtype="float32")
    ecfg = dict(prefill_chunk=0, **ecfg)
    j = je.Engine(jp, jcfg, jk.CacheConfig(**cache), je.EngineConfig(**ecfg))
    t = te.Engine(tp, tcfg, tk.CacheConfig(**cache), te.EngineConfig(**ecfg), device="cpu")
    return j, t


def _greedy_third(models):
    _, t = _engines(models, 64, max_batch=4, pages_per_seq=8)
    rid = t.add_request([1, 2, 3], 10)
    return t.run()[rid][2]


@pytest.mark.parametrize("eos", [None, "third"])
def test_engine_multi_step_matches_jax(models, eos):
    """run(multi_step=4) gives the JAX engine's tokens and the port's own
    per-token run's, with 9 new tokens (9 % 4: a per-token tail) and, with
    an eos mid-span, surplus tokens dropped and every page freed."""
    eos_token = _greedy_third(models) if eos else None
    outs = []
    for ms in (1, 4):
        for eng in _engines(models, 64, max_batch=4, pages_per_seq=8, eos_token=eos_token):
            for p in ([1, 2, 3], [9, 8, 7, 6]):
                eng.add_request(p, 9)
            outs.append(eng.run(multi_step=ms))
            assert eng.cache.num_free_pages() == 64
            if ms == 4 and isinstance(eng, te.Engine):
                st = eng.stats()
                assert st["decode_tokens"] == sum(map(len, outs[-1].values())) - 2
                assert st["decode_batches"] < st["decode_tokens"]  # the loop ran
    assert outs[0] == outs[1] == outs[2] == outs[3]
    if eos_token is not None:
        assert any(o and o[-1] == eos_token and len(o) < 9 for o in outs[0].values())


def test_engine_multi_step_rollback_under_page_pressure(models):
    """4 pages of 8 for two 8-token prompts: the 8-slot reservation fails,
    rolls back and steps per token; the tokens are the JAX engine's."""
    outs = []
    for eng in _engines(models, 4, max_batch=4, pages_per_seq=2):
        for p in PROMPTS:
            eng.add_request(p, 8)
        outs.append(eng.run(max_steps=200, multi_step=8))
        assert eng.cache.num_free_pages() == 4
    assert outs[0] == outs[1]
    assert all(len(o) == 8 for o in outs[1].values())


def test_engine_multi_step_per_request_params_fall_back(models):
    _, t = _engines(models, 64, max_batch=4, pages_per_seq=8)
    want = _engines(models, 64, max_batch=4, pages_per_seq=8)[1]
    rid = t.add_request(PROMPTS[0], 6, sampling=te.SamplingParams(greedy=True))
    wid = want.add_request(PROMPTS[0], 6)
    assert t.run(multi_step=4)[rid] == want.run()[wid]
    assert t.stats()["decode_batches"] == 5  # per token


def test_engine_speculative_matches_jax(models):
    """run_speculative(k=4) with oracle drafts (all accepted) and garbage
    drafts (all rejected) gives the plain run's tokens, on both engines."""
    plain = {}
    for eng in _engines(models, 64, max_batch=4, pages_per_seq=8):
        ids = [eng.add_request(p, 9) for p in ([1, 2, 3], [9, 8, 7, 6])]
        plain[type(eng)] = eng.run()
    assert plain[je.Engine] == plain[te.Engine]
    want = plain[te.Engine]
    truth = {rid: p + want[rid] for rid, p in zip(ids, ([1, 2, 3], [9, 8, 7, 6]))}

    def oracle(req, n):
        return truth[req.req_id][req.length : req.length + n]

    def garbage(req, n):
        return [(req.length * 7 + j) % 256 for j in range(n)]

    for fn in (oracle, garbage):
        for eng in _engines(models, 64, max_batch=4, pages_per_seq=8):
            for p in ([1, 2, 3], [9, 8, 7, 6]):
                eng.add_request(p, 9)
            assert eng.run_speculative(fn, k=4) == want, fn.__name__
            assert eng.cache.num_free_pages() == 64
            if isinstance(eng, te.Engine):
                st = eng.stats()
                assert st["decode_tokens"] == 16
                if fn is oracle:
                    assert st["steps"] <= 5 and st["spec_accepted"] >= 8
                else:
                    assert st["spec_accepted"] == 0 and st["spec_steps"] >= 8


def test_engine_speculative_int8_cache_matches_jax(models):
    outs = []
    for eng in _engines(models, 64, max_batch=2, pages_per_seq=8):
        eng.cache = type(eng.cache)(dataclasses.replace(eng.cache.config, dtype="int8"),
                                    **({"device": "cpu"} if isinstance(eng, te.Engine) else {}))
        for p in PROMPTS:
            eng.add_request(p, 6)
        outs.append(eng.run_speculative(lambda req, n: [req.length % 256] * n, k=3))
        assert eng.cache.num_free_pages() == 64
    assert outs[0] == outs[1]


def test_step_speculative_refuses_k1(models):
    _, t = _engines(models, 8, max_batch=2, pages_per_seq=4)
    t.add_request([1, 2, 3], 3)
    with pytest.raises(ValueError, match="k >= 2"):
        t.step_speculative(lambda req, n: [], 1)


# ── sampled serving ─────────────────────────────────────────────────────────


def test_speculative_accept_sampled_marginal_is_exact():
    """The first emitted token is distributed as the filtered target over
    4096 draws of one generator (JAX: tests/test_runtime.py:866), and the
    accepted prefix is the drafts."""
    logits = torch.tensor([[[2.0, 1.0, 0.5, -0.5, 0.0], [0.0, 2.0, 1.0, 0.0, -1.0],
                            [1.0, 0.0, 0.0, 2.0, 0.5]]]).expand(4096, 3, 5)
    drafts = torch.tensor([[2, 1]]).expand(4096, 2)
    kw = dict(temperature=0.7, top_k=4, top_p=0.95)
    gen = torch.Generator().manual_seed(7)
    n, emitted = ts.speculative_accept_sampled(gen, drafts, logits, **kw)
    want = np.asarray(jax.nn.softmax(js.filter_logits(jnp.asarray(logits[:1].numpy()), **kw),
                                     axis=-1)[0, 0])
    got = np.bincount(emitted[:, 0].numpy(), minlength=5) / 4096
    np.testing.assert_allclose(got, want, atol=0.03)
    assert int(n.min()) >= 1 and int(n.max()) <= 3
    for i in range(4096):
        assert emitted[i, : n[i] - 1].tolist() == drafts[0, : n[i] - 1].tolist()


def _sampled_engine(models, **ecfg):
    (_, _), (tcfg, tp) = models
    cache = tk.CacheConfig(num_layers=2, num_kv_heads=2, head_dim=32, page_size=8,
                           num_pages=64, dtype="float32")
    return te.Engine(tp, tcfg, cache, te.EngineConfig(max_batch=4, pages_per_seq=8,
                                                      prefill_chunk=0, **ecfg),
                     device="cpu", seed=3)


def test_engine_sampled_multi_step_matches_per_token(models):
    outs = []
    for ms in (1, 4):
        eng = _sampled_engine(models, greedy=False, temperature=0.8, top_k=24)
        for p in ([3, 1, 4, 1], [5, 9, 2, 6, 5, 3]):
            eng.add_request(p, 8)
        outs.append(eng.run(multi_step=ms))
    assert outs[0] == outs[1]
    assert all(len(o) == 8 for o in outs[0].values())


def test_engine_speculative_sampled_near_greedy_limit(models):
    """At temperature 1e-4 the sampled accept rule reproduces the greedy
    speculative engine (JAX: tests/test_runtime.py:901)."""
    runs = []
    for kw in ({}, dict(greedy=False, temperature=1e-4)):
        eng = _sampled_engine(models, **kw)
        for p in ([1, 2, 3], [9, 8, 7, 6]):
            eng.add_request(p, 9)
        runs.append(eng.run_speculative(lambda req, n: [(req.length * 3 + j) % 256 for j in range(n)], k=3))
        assert eng.cache.num_free_pages() == 64
    assert runs[0] == runs[1]
