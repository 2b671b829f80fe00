"""The JAX package's keywords on the port's entry points, and the paged
cache's ``can_append`` / ``layer_pages``, against the JAX package.

The same numpy inputs go through each JAX entry point (Pallas kernels in
interpret mode on the CPU) called with its TPU keywords (``precision`` in
every valid mode, ``interpret``, ``implementation="pallas"``, positional
8-bit scales, ``pages_per_compute_block``) and through the port's entry
point called with the same keywords, where each precision mode runs its
form (``tests/test_torch_precision.py``).  Tolerances: 1e-4 where the JAX side computes float32
products exactly or as three bf16 passes (``"float32"``, ``"bf16_3x"``, the
default), 2e-2 for its one-pass ``"bf16"`` mode and for bf16 inputs, and
2e-2 of the output's magnitude over 8-bit K/V (``tests/test_quant.py``'s
bound).  A bad ``precision`` raises the JAX package's ``ValueError``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flashattention_tpu as fj
import flashattention_tpu_torch as ft
from flashattention_tpu.models import transformer as jtransformer
from flashattention_tpu.ops import decode as jdecode
from flashattention_tpu.ops import flash as jflash
from flashattention_tpu.ops import quant as jquant
from flashattention_tpu.runtime import kvcache as jk
from flashattention_tpu_torch.models import transformer as ttransformer
from flashattention_tpu_torch.ops import backward as tbackward
from flashattention_tpu_torch.ops import decode as tdecode
from flashattention_tpu_torch.ops import flash as tflash
from flashattention_tpu_torch.ops import quant as tquant
from flashattention_tpu_torch.runtime import kvcache as tk
from flashattention_tpu_torch.utils.testing import to_numpy, validate_result

torch.set_num_threads(2)

# The JAX side's error by mode over float32 inputs: exact, three bf16
# passes (the default), one bf16 pass.
MODE_TOL = {"float32": 1e-4, "bf16_3x": 1e-4, None: 1e-4, "auto": 1e-4, "bf16": 2e-2}
QUANT_TOL = 2e-2  # of the output's magnitude, tests/test_quant.py's bound


def _rand(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("precision", list(MODE_TOL), ids=str)
def test_attention_precision_modes_match_jax(precision):
    """``attention(precision=)`` on float32 GQA inputs with a ragged S,
    through the default implementation and ``interpret=True``."""
    q, k, v = _rand(1, (1, 4, 100, 64), (1, 2, 100, 64), (1, 2, 100, 64))
    want = fj.attention(*map(jnp.asarray, (q, k, v)), causal=True, scale=0.125,
                        precision=precision, interpret=True)
    got = ft.attention(*map(torch.tensor, (q, k, v)), causal=True, scale=0.125,
                       precision=precision, interpret=True)
    validate_result(got, np.asarray(want), MODE_TOL[precision])


@pytest.mark.parametrize("implementation", ["pallas", "cuda", None], ids=str)
def test_implementation_pallas_is_the_kernel(implementation):
    """``implementation="pallas"`` (the JAX default, and the port's) runs
    the kernel route, as does its alias ``"cuda"``; ``sdpa`` passes the
    keywords on."""
    q, k, v = _rand(2, (2, 2, 64, 32), (2, 2, 64, 32), (2, 2, 64, 32))
    kw = {} if implementation is None else {"implementation": implementation}
    want = fj.sdpa(*map(jnp.asarray, (q, k, v)), causal=True, precision="float32",
                   interpret=True, **({} if implementation is None else {"implementation": "pallas"}))
    got = ft.sdpa(*map(torch.tensor, (q, k, v)), causal=True, precision="float32",
                  interpret=True, **kw)
    validate_result(got, np.asarray(want), 1e-4)
    xla = ft.sdpa(*map(torch.tensor, (q, k, v)), causal=True, implementation="xla")
    validate_result(got, to_numpy(xla), 1e-5)


def test_attention_precision_under_autograd_matches_jax():
    """The keywords reach ``attention_vjp``: gradients through
    ``attention(precision="float32", interpret=True)`` against ``jax.grad``."""
    q, k, v, t = _rand(3, *[(1, 2, 64, 32)] * 4)

    def jloss(q, k, v):
        return jnp.sum(fj.attention(q, k, v, causal=True, scale=0.2, precision="float32",
                                    interpret=True) * jnp.asarray(t))

    jg = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk_, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    o = ft.attention(tq, tk_, tv, causal=True, scale=0.2, precision="float32", interpret=True)
    (o * torch.tensor(t)).sum().backward()
    for got, want in zip((tq.grad, tk_.grad, tv.grad), jg):
        validate_result(got, np.asarray(want), 5e-4)
    o2 = tbackward.attention_vjp(*(x.reshape(2, 64, 32) for x in (tq, tk_, tv)), True, 0.2,
                                 None, "bf16_3x", True)
    validate_result(o2.reshape(o.shape), to_numpy(o), 1e-6)


@pytest.mark.parametrize("form", ["int8", "fp8"])
def test_flash_attention_positional_scales_match_jax(form):
    """``flash_attention(q, k, v, k_scales, v_scales)``, the JAX order, with
    bf16 q over 8-bit K/V; the keywords give the same output."""
    q, k, v = _rand(4, (2, 128, 64), (2, 128, 64), (2, 128, 64))
    jkq, jvq = (jquant.quantize(jnp.asarray(x), form) for x in (k, v))
    want = jflash.flash_attention(jnp.asarray(q, jnp.bfloat16), jkq.payload, jvq.payload,
                                  jkq.scales, jvq.scales, causal=True, scale=0.125,
                                  precision="bf16", interpret=True)
    tkq, tvq = (tquant.quantize(torch.tensor(x), form) for x in (k, v))
    tq = torch.tensor(q).to(torch.bfloat16)
    got = tflash.flash_attention(tq, tkq.payload, tvq.payload, tkq.scales, tvq.scales,
                                 causal=True, scale=0.125, precision="bf16", interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    validate_result(got, want, QUANT_TOL * float(np.abs(want).max()))
    kw = tflash.flash_attention(tq, tkq.payload, tvq.payload, k_scales=tkq.scales,
                                v_scales=tvq.scales, causal=True, scale=0.125)
    assert torch.equal(kw, got)


def test_quantized_and_naive_take_the_jax_keywords():
    """``attention_quantized(precision=, interpret=)`` and
    ``flash_attention_naive(interpret=)`` against the JAX calls."""
    q, k, v = _rand(5, (2, 128, 32), (2, 128, 32), (2, 128, 32))
    jkq, jvq = (jquant.quantize(jnp.asarray(x), "int8") for x in (k, v))
    want = jquant.attention_quantized(jnp.asarray(q), jkq, jvq, causal=True, scale=0.2,
                                      precision="float32", interpret=True)
    tkq, tvq = (tquant.quantize(torch.tensor(x), "int8") for x in (k, v))
    got = tquant.attention_quantized(torch.tensor(q), tkq, tvq, causal=True, scale=0.2,
                                     precision="float32", interpret=True)
    want = np.asarray(want)
    validate_result(got, want, QUANT_TOL * float(np.abs(want).max()))
    want = jflash.flash_attention_naive(*map(jnp.asarray, (q, k, v)), causal=True, scale=0.2,
                                        interpret=True)
    got = tflash.flash_attention_naive(*map(torch.tensor, (q, k, v)), causal=True, scale=0.2,
                                       interpret=True)
    validate_result(got, np.asarray(want), 1e-4)


def test_paged_ops_take_the_jax_keywords():
    """``paged_attention(pages_per_compute_block=, interpret=)`` and both
    paged prefills with ``interpret=True`` against the JAX calls."""
    rng = np.random.default_rng(6)
    b, kvh, g, d, ps, pps, pool = 3, 2, 2, 32, 8, 4, 16
    q, kp, vp = (rng.standard_normal(s).astype(np.float32)
                 for s in ((b, kvh, g, d), (pool, kvh, ps, d), (pool, kvh, ps, d)))
    lens = np.array([1, 9, 32], np.int32)
    table = rng.permutation(pool)[: b * pps].reshape(b, pps).astype(np.int32)
    kw = dict(scale=0.3, pages_per_compute_block=2, interpret=True)
    want = jdecode.paged_attention(*map(jnp.asarray, (q, kp, vp, lens, table)), **kw)
    got = tdecode.paged_attention(*map(torch.tensor, (q, kp, vp, lens, table)), **kw)
    validate_result(got, np.asarray(want), 1e-4)

    chunk = 16
    qc = rng.standard_normal((2, kvh, chunk, d)).astype(np.float32)
    ctx = np.array([32, 16], np.int32)
    pkw = dict(chunk=chunk, scale=0.3, interpret=True)
    want = jdecode.paged_prefill_attention_batched(
        *map(jnp.asarray, (qc, kp, vp, table[:2], ctx)), **pkw)
    got = tdecode.paged_prefill_attention_batched(
        *map(torch.tensor, (qc, kp, vp, table[:2], ctx)), **pkw)
    validate_result(got, np.asarray(want), 1e-4)
    want = jdecode.paged_prefill_attention(*map(jnp.asarray, (qc[0], kp, vp, table[0])),
                                           int(ctx[0]), **pkw)
    got = tdecode.paged_prefill_attention(*map(torch.tensor, (qc[0], kp, vp, table[0])),
                                          int(ctx[0]), **pkw)
    validate_result(got, np.asarray(want), 1e-4)


def test_model_and_engine_take_interpret():
    """``prefill(interpret=)`` logits against the JAX prefill's, and
    ``Engine(interpret=True)`` greedy tokens against the JAX engine's."""
    fields = dict(vocab_size=64, num_layers=2, d_model=64, num_q_heads=4, num_kv_heads=2,
                  head_dim=32, intermediate=64, dtype="float32")
    jcfg = jtransformer.ModelConfig(**fields)
    jparams = jtransformer.init_params(jax.random.key(0), jcfg)
    tcfg = ttransformer.ModelConfig(**fields)
    tparams = ttransformer.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    tokens = np.random.default_rng(7).integers(0, 64, (1, 24)).astype(np.int32)
    want = jtransformer.prefill(jparams, jnp.asarray(tokens), jcfg, interpret=True)[0]
    got = ttransformer.prefill(tparams, torch.tensor(tokens), tcfg, interpret=True)[0]
    validate_result(got, np.asarray(want), 1e-4)

    from flashattention_tpu.runtime import engine as jengine
    from flashattention_tpu_torch.runtime import engine as tengine

    cache = dict(num_layers=2, num_kv_heads=2, head_dim=32, page_size=8, num_pages=16,
                 dtype="float32")
    prompt = tokens[0, :11].tolist()
    jeng = jengine.Engine(jparams, jcfg, jk.CacheConfig(**cache),
                          jengine.EngineConfig(max_batch=2, pages_per_seq=4, prefill_chunk=0),
                          interpret=True)
    teng = tengine.Engine(tparams, tcfg, tk.CacheConfig(**cache),
                          tengine.EngineConfig(max_batch=2, pages_per_seq=4, prefill_chunk=0),
                          interpret=True, device="cpu")
    jr, tr = jeng.add_request(prompt, 5), teng.add_request(prompt, 5)
    assert teng.run()[tr] == jeng.run()[jr]


@pytest.mark.parametrize("entry", ["attention", "sdpa", "flash_attention", "attention_vjp",
                                   "attention_quantized", "flash_attention_bwd"])
def test_bad_precision_raises_the_jax_error(entry):
    x = torch.zeros(1, 8, 16)
    with pytest.raises(ValueError) as want:
        jflash.resolve_precision("fp16", jnp.float32)
    calls = {
        "attention": lambda: ft.attention(x, x, x, precision="fp16"),
        "sdpa": lambda: ft.sdpa(x, x, x, precision="fp16"),
        "flash_attention": lambda: tflash.flash_attention(x, x, x, precision="fp16"),
        "attention_vjp": lambda: tbackward.attention_vjp(x, x, x, False, 1.0, None, "fp16"),
        "attention_quantized": lambda: tquant.attention_quantized(
            x, tquant.quantize(x), tquant.quantize(x), precision="fp16"),
        "flash_attention_bwd": lambda: tbackward.flash_attention_bwd(
            x, x, x, x, x[..., 0], x, precision="fp16"),
    }
    with pytest.raises(ValueError) as got:
        calls[entry]()
    assert str(got.value) == str(want.value)
    for mode in (*tflash.PRECISIONS, None, "auto"):
        for dt in (torch.float32, torch.bfloat16):
            jdt = jnp.float32 if dt == torch.float32 else jnp.bfloat16
            assert tflash.resolve_precision(mode, dt) == jflash.resolve_precision(mode, jdt)
    assert tflash.PRECISIONS == jflash.PRECISIONS


def _drive_caches(form):
    """The JAX and the port's caches through the same appends, a published
    prefix and its release (parked pages), returning both and a probe."""
    cfg = dict(num_layers=2, num_kv_heads=2, head_dim=16, page_size=4, num_pages=6, dtype=form)
    jc, tc = jk.PagedKVCache(jk.CacheConfig(**cfg)), tk.PagedKVCache(tk.CacheConfig(**cfg),
                                                                     device="cpu")
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 9, 2, 16)).astype(np.float32)
    for c, conv in ((jc, jnp.asarray), (tc, torch.tensor)):
        c.append(1, conv(x), conv(x * 0.5))
        c.register_prefix(1, list(range(9)))
    return jc, tc, x


@pytest.mark.parametrize("form", ["bfloat16", "int8"])
def test_can_append_and_layer_pages_match_jax(form):
    """A full cache, then one whose prefix pages are parked: ``can_append``
    (parked pages count as free) and each layer's pools as the JAX
    cache's."""
    jc, tc, x = _drive_caches(form)

    def same_pages():
        for layer in range(2):
            want, got = jc.layer_pages(layer), tc.layer_pages(layer)
            assert len(got) == 4
            for g, w in zip(got, want):
                if w is None:
                    assert g is None
                    continue
                w = np.asarray(w)
                g = g.view(torch.int8).numpy() if g.dtype == torch.int8 else g.float().numpy()
                np.testing.assert_array_equal(g, w.astype(g.dtype))

    probes = [(1, 0), (1, 3), (1, 4), (1, 12), (1, 13), (2, 12), (2, 13), (2, 24), (2, 25)]
    for sid, n in probes:
        assert tc.can_append(sid, n) == jc.can_append(sid, n), (sid, n)
    same_pages()
    y = np.concatenate([x, x[:, :3]], axis=1)  # 12 rows: the pool's last 3 pages
    for c, conv in ((jc, jnp.asarray), (tc, torch.tensor)):
        c.append(2, conv(y), conv(y))
    assert tc.num_free_pages() == jc.num_free_pages() == 0
    for sid, n in probes:
        assert tc.can_append(sid, n) == jc.can_append(sid, n), (sid, n)
    assert tc.can_append(1, 3) and not tc.can_append(3, 1)
    jc.free_sequence(1)  # its two full pages park as prefix pages, the last is freed
    tc.free_sequence(1)
    assert tc.num_free_pages() == jc.num_free_pages() == 3
    assert tc.allocator.num_free() == jc.allocator.num_free() == 1
    for sid, n in probes + [(3, 12), (3, 13)]:
        assert tc.can_append(sid, n) == jc.can_append(sid, n), (sid, n)
    assert tc.can_append(3, 12) and not tc.can_append(3, 13)
    same_pages()
