"""The port's serving engine against the JAX package's.

Both engines run ``ModelConfig.tiny()`` in float32 from the same parameters
(JAX ``init_params`` crossed through numpy) with whole-prompt prefill
(``prefill_chunk=0``; the chunked path is in ``tests/test_torch_chunked.py``); greedy tokens must be IDENTICAL, in the
continuous-batching and page-pressure preemption scenarios of
``tests/test_runtime.py``, and every page must be free afterwards.  The page
allocator and admission scheduler, on the C++ core and in their pure-Python
copies, are held to the JAX package's ``runtime/native.py`` op for op.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from flashattention_tpu.models import transformer as jt
from flashattention_tpu.runtime import engine as je
from flashattention_tpu.runtime import kvcache as jk
from flashattention_tpu.runtime import native as jn
from flashattention_tpu_torch.models import transformer as tt
from flashattention_tpu_torch.runtime import engine as te
from flashattention_tpu_torch.runtime import kvcache as tk
from flashattention_tpu_torch.runtime import native as tn

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jt.ModelConfig.tiny(), dtype="float32")
    tcfg = dataclasses.replace(tt.ModelConfig.tiny(), dtype="float32")
    jp = jt.init_params(jax.random.key(0), jcfg)
    tp = tt.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return (jcfg, jp), (tcfg, tp)


def _engines(models, num_pages, **ecfg):
    (jcfg, jp), (tcfg, tp) = models
    cache = dict(num_layers=2, num_kv_heads=2, head_dim=32, page_size=8,
                 num_pages=num_pages, dtype="float32")
    ecfg = dict(prefill_chunk=0, **ecfg)
    j = je.Engine(jp, jcfg, jk.CacheConfig(**cache), je.EngineConfig(**ecfg))
    t = te.Engine(tp, tcfg, tk.CacheConfig(**cache), te.EngineConfig(**ecfg), device="cpu")
    return j, t


def test_engine_continuous_batching_matches_jax(models):
    outs = []
    for eng in _engines(models, 64, max_batch=4, pages_per_seq=8):
        a = eng.add_request([1, 2, 3], 5)
        b = eng.add_request([7, 7, 7, 7, 7, 7], 3)
        eng.step()  # the first two are admitted and prefilled
        c = eng.add_request([9, 8], 4)
        out = eng.run()
        assert [len(out[r]) for r in (a, b, c)] == [5, 3, 4]
        assert eng.cache.num_free_pages() == 64
        outs.append(out)
    assert outs[0] == outs[1]


def test_engine_preemption_matches_jax(models):
    outs, stats = [], []
    for eng in _engines(models, 3, max_batch=4, pages_per_seq=2):
        r1 = eng.add_request([1, 2, 3, 4, 5, 6, 7, 8], 4)
        r2 = eng.add_request([5] * 8, 4)
        out = eng.run(max_steps=100)
        assert len(out[r1]) == 4 and len(out[r2]) == 4
        assert eng.cache.num_free_pages() == 3
        outs.append(out)
        stats.append(eng.stats()["preemptions"])
    assert outs[0] == outs[1]
    assert stats[0] == stats[1] > 0


def test_engine_eos_and_logprobs_match_jax(models):
    """Stop conditions and per-request greedy params with logprobs."""
    outs, lps = [], []
    for eng in _engines(models, 64, max_batch=2, pages_per_seq=8):
        sp_cls = je.SamplingParams if isinstance(eng, je.Engine) else te.SamplingParams
        r1 = eng.add_request([4, 4, 2], 6, sampling=sp_cls(logprobs=True))
        r2 = eng.add_request([3, 1, 4, 1, 5, 9, 2, 6, 5], 6)
        r3 = eng.add_request([2, 7, 1, 8], 6)
        out = eng.run()
        outs.append(out)
        lps.append(eng.requests[r1].logprobs)
    assert outs[0] == outs[1]
    np.testing.assert_allclose(lps[1], lps[0], atol=1e-4)

    # Stop on the third token the unstopped run produced for r2.
    stop = outs[0][r2][2]
    stopped = []
    for eng in _engines(models, 64, max_batch=2, pages_per_seq=8, eos_token=stop):
        eng.add_request([4, 4, 2], 6)
        r = eng.add_request([3, 1, 4, 1, 5, 9, 2, 6, 5], 6)
        stopped.append(eng.run()[r])
    assert stopped[0] == stopped[1]
    assert stopped[1][-1] == stop and len(stopped[1]) <= 3


def test_engine_cancel_frees_pages(models):
    _, eng = _engines(models, 16, max_batch=1, pages_per_seq=4)
    r1 = eng.add_request([1, 2, 3], 10)
    r2 = eng.add_request([4, 5], 10)
    eng.step()
    assert eng.cancel(r2) and eng.cancel(r1)
    assert not eng.cancel(r1)
    assert not eng.has_work() and eng.cache.num_free_pages() == 16
    assert eng.requests[r1].state == "cancelled" and len(eng.requests[r1].output) == 2


def test_engine_sampled_is_seeded(models):
    def run(seed):
        (_, _), (tcfg, tp) = models
        eng = te.Engine(
            tp, tcfg,
            tk.CacheConfig(num_layers=2, num_kv_heads=2, head_dim=32, page_size=8,
                           num_pages=32, dtype="float32"),
            te.EngineConfig(max_batch=2, pages_per_seq=4, prefill_chunk=0,
                            greedy=False, temperature=0.8, top_k=20),
            device="cpu", seed=seed,
        )
        a = eng.add_request([1, 2, 3], 6)
        b = eng.add_request([4, 5], 6, sampling=te.SamplingParams(greedy=False, seed=7))
        out = eng.run()
        return out[a], out[b]

    first, second = run(0), run(0)
    assert first == second
    assert run(1)[1] == first[1]  # a seeded request ignores the engine seed


def test_engine_unported_paths_raise(models):
    """The default EngineConfig() (prefill_chunk=512) builds and serves, per
    token and with multi-step decode (ported, with speculative decoding,
    since the two paths were the last of this engine to raise); a
    speculative step with k < 2 raises ``ValueError``."""
    (_, _), (tcfg, tp) = models
    cc = tk.CacheConfig(num_layers=2, num_kv_heads=2, head_dim=32, page_size=8, num_pages=8,
                        dtype="float32")
    eng = te.Engine(tp, tcfg, cc, device="cpu")
    assert eng.cfg == te.EngineConfig() and eng.cfg.prefill_chunk == 512
    rid = eng.add_request([1, 2, 3], 3)
    want = eng.run()[rid]
    assert len(want) == 3 and eng.cache.num_free_pages() == 8
    rid = eng.add_request([1, 2, 3], 9)
    out = eng.run(multi_step=4)[rid]
    assert out[:3] == want and len(out) == 9 and eng.cache.num_free_pages() == 8
    eng.add_request([1, 2, 3], 3)
    with pytest.raises(ValueError, match="k >= 2"):
        eng.step_speculative(lambda req, n: [], 1)


# ── allocator / scheduler parity ────────────────────────────────────────────


def _native_cases(name, values):
    """``(value, native)`` cases: the C++ core under the value's own id, the
    pure-Python copy (``native=False``) under ``<id>-plain``."""
    return pytest.mark.parametrize(f"{name},native", [
        pytest.param(v, native, id=str(v) if native else f"{v}-plain")
        for v in values for native in (True, False)])


@_native_cases("seed", [0, 1, 2])
def test_page_allocator_matches_jax(seed, native):
    rng = np.random.default_rng(seed)
    a, b = jn.PageAllocator(16), tn.PageAllocator(16, native=native)
    assert a.native and b.native == native
    held = []
    for _ in range(60):
        if held and rng.random() < 0.4:
            i = int(rng.integers(len(held)))
            pages = held.pop(i)
            a.free(pages)
            b.free(pages)
        else:
            n = int(rng.integers(0, 6))
            got_a, got_b = a.alloc(n), b.alloc(n)
            assert got_a == got_b
            if got_a:
                held.append(got_a)
        assert a.num_free() == b.num_free()


@_native_cases("reserve", [False, True])
def test_scheduler_matches_jax(reserve, native):
    rng = np.random.default_rng(int(reserve))
    a = jn.Scheduler(3, 8, reserve_worst_case=reserve)
    b = tn.Scheduler(3, 8, reserve_worst_case=reserve, native=native)
    assert a.native and b.native == native
    running = []
    for rid in range(40):
        plen, new = int(rng.integers(1, 40)), int(rng.integers(1, 20))
        a.add_request(rid, plen, new)
        b.add_request(rid, plen, new)
        op = rng.random()
        if op < 0.5:
            budget = int(rng.integers(0, 12))
            got = a.admit(budget)
            assert got == b.admit(budget)
            running += got
        elif running and op < 0.8:
            r = running.pop(int(rng.integers(len(running))))
            a.finish(r)
            b.finish(r)
        else:
            r = int(rng.integers(0, rid + 1))
            assert a.cancel(r) == b.cancel(r)
            if r in running:
                running.remove(r)
        assert (a.num_waiting(), a.num_running()) == (b.num_waiting(), b.num_running())


def test_kvcache_append_and_view_layout():
    """append() writes (L, T, KVH, d) rows head-major, like the JAX cache."""
    cfg = dict(num_layers=2, num_kv_heads=2, head_dim=16, page_size=4, num_pages=16, dtype="float32")
    x = np.random.default_rng(0).standard_normal((2, 6, 2, 16)).astype(np.float32)
    jc, tc = jk.PagedKVCache(jk.CacheConfig(**cfg)), tk.PagedKVCache(tk.CacheConfig(**cfg), device="cpu")
    jc.append(7, x, x)
    tc.append(7, torch.tensor(x), torch.tensor(x))
    np.testing.assert_array_equal(tc.k_pages.numpy(), np.asarray(jc.k_pages))
    for got, want in zip(tc.batch_view([7, -1], 4), jc.batch_view([7, -1], 4)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(MemoryError):
        tc.append(8, torch.zeros(2, 61, 2, 16), torch.zeros(2, 61, 2, 16))


@pytest.mark.parametrize("seed", [0, 1])
def test_kvcache_prefix_bookkeeping_matches_jax(seed):
    """Register / match / adopt / free / trim under page pressure (parking
    and LRU eviction of prefix pages) give the JAX cache's page ids."""
    cfg = dict(num_layers=1, num_kv_heads=1, head_dim=32, page_size=4, num_pages=10, dtype="float32")
    jc, tc = jk.PagedKVCache(jk.CacheConfig(**cfg)), tk.PagedKVCache(tk.CacheConfig(**cfg), device="cpu")
    rng = np.random.default_rng(seed)
    prompts = [[1, 2, 3, 4, 5, 6, 7, 8, 9], [1, 2, 3, 4, 5, 6, 7, 8, 2, 2], [4, 4, 4, 4, 4]]
    live = []
    for sid in range(30):
        op = rng.random()
        if live and op < 0.35:
            victim = live.pop(int(rng.integers(len(live))))
            jc.free_sequence(victim)
            tc.free_sequence(victim)
        elif live and op < 0.45:
            sid_t = live[int(rng.integers(len(live)))]
            n = int(rng.integers(0, jc.length(sid_t) + 1))
            jc.trim(sid_t, n)
            tc.trim(sid_t, n)
        else:
            toks = prompts[int(rng.integers(len(prompts)))]
            got = tc.match_prefix(toks)
            assert got == jc.match_prefix(toks)
            n_sh, pages = got
            if n_sh:
                jc.adopt_prefix(sid, pages, n_sh)
                tc.adopt_prefix(sid, pages, n_sh)
            rest = len(toks) - n_sh
            x = np.zeros((1, rest, 1, 32), np.float32)
            try:
                jc.append(sid, x, x)
            except MemoryError:
                with pytest.raises(MemoryError):
                    tc.append(sid, torch.tensor(x), torch.tensor(x))
                jc.free_sequence(sid)
                tc.free_sequence(sid)
                continue
            tc.append(sid, torch.tensor(x), torch.tensor(x))
            jc.register_prefix(sid, toks)
            tc.register_prefix(sid, toks)
            live.append(sid)
        assert tc.num_free_pages() == jc.num_free_pages()
        for s in live:
            assert tc.pages(s) == jc.pages(s) and tc.length(s) == jc.length(s)


def test_engine_stop_conditions_and_streaming_match_jax(models):
    """Per-request stop tokens and stop sequences, and the streaming hooks."""
    (jcfg, jp), (tcfg, tp) = models
    free_run = _engines(models, 64, max_batch=2, pages_per_seq=8)[1]
    rid = free_run.add_request([6, 1, 6], 8)
    ref = free_run.run()[rid]
    outs, streamed = [], []
    for eng in _engines(models, 64, max_batch=2, pages_per_seq=8):
        sp = je.SamplingParams if isinstance(eng, je.Engine) else te.SamplingParams
        seen = []
        eng.on_token = lambda req, tok, seen=seen: seen.append((req.req_id, tok))
        a = eng.add_request([6, 1, 6], 8, sampling=sp(stop_tokens=(ref[4],)))
        b = eng.add_request([6, 1, 6], 8, sampling=sp(stop_sequences=(tuple(ref[1:3]),)))
        c = eng.add_request([6, 1, 6], 8, on_token=lambda req, tok: None)
        out = eng.run()
        outs.append((out[a], out[b], out[c]))
        streamed.append(seen)
    assert outs[0] == outs[1]
    assert outs[1][0] == ref[: ref.index(ref[4]) + 1] and outs[1][1] == ref[:3] and outs[1][2] == ref
    assert streamed[0] == streamed[1]
