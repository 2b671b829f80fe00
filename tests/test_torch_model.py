"""Differential tests of the port's model against the JAX package's.

The JAX parameters (from ``init_params`` on a seed) cross to the port through
numpy with ``params_from_jax``; the same tokens then go through both
``prefill`` and ``decode_step`` at ``ModelConfig.tiny()`` in float32.  The
JAX side's flash kernel runs in interpret mode at its default fp32 precision
(bf16_3x, ~1e-5), so logits agree to 1e-3 and K/V rows to 1e-4; the port's
RMSNorm and RoPE agree with the JAX ones to 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattention_tpu.models import transformer as jt
from flashattention_tpu_torch.models import transformer as tt
from flashattention_tpu_torch.utils.testing import to_numpy, validate_result

torch.set_num_threads(2)

LOGIT_TOL = 1e-3
KV_TOL = 1e-4


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jt.ModelConfig.tiny(), dtype="float32")
    tcfg = dataclasses.replace(tt.ModelConfig.tiny(), dtype="float32")
    jp = jt.init_params(jax.random.key(0), jcfg)
    tp = tt.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def test_configs_match():
    for name in ("tiny", "llama7b_attention", "mistral7b", "gemma2_9b", "mixtral8x7b"):
        j = dataclasses.asdict(getattr(jt.ModelConfig, name)())
        t = dataclasses.asdict(getattr(tt.ModelConfig, name)())
        assert j == t, name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_jax_is_a_copy(dtype):
    cfg = dataclasses.replace(jt.ModelConfig.tiny(), dtype=dtype)
    jp = jt.init_params(jax.random.key(1), cfg)
    tp = tt.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    pairs = [("embed", jp["embed"], tp["embed"]), ("lm_head", jp["lm_head"], tp["lm_head"])]
    for i, (jl, tl) in enumerate(zip(jp["layers"], tp["layers"])):
        assert set(jl) == set(tl)
        pairs += [(f"layers.{i}.{n}", jl[n], tl[n]) for n in jl]
    for name, j, t in pairs:
        assert tuple(t.shape) == j.shape, name
        assert t.dtype == {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype], name
        np.testing.assert_array_equal(to_numpy(t), np.asarray(j, np.float32), err_msg=name)


def test_init_params_shapes_and_seed():
    cfg = tt.ModelConfig.tiny()
    a = tt.init_params(3, cfg, device="cpu")
    b = tt.init_params(3, cfg, device="cpu")
    ref = jt.init_params(jax.random.key(0), jt.ModelConfig.tiny())
    assert set(a) == set(ref) and len(a["layers"]) == len(ref["layers"])
    for n, w in ref["layers"][0].items():
        assert tuple(a["layers"][0][n].shape) == w.shape and a["layers"][0][n].dtype == torch.bfloat16
    assert torch.equal(a["embed"], b["embed"])


def test_rmsnorm_and_rope_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 32)).astype(np.float32)
    w = rng.standard_normal(32).astype(np.float32)
    pos = rng.integers(0, 4000, (2, 5)).astype(np.int32)
    validate_result(
        tt._rmsnorm(torch.tensor(x), torch.tensor(w)),
        np.asarray(jt._rmsnorm(jnp.asarray(x), jnp.asarray(w))), 1e-6,
    )
    validate_result(
        tt._rope(torch.tensor(x), torch.tensor(pos), 10000.0),
        np.asarray(jt._rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)), 2e-6,
    )


@pytest.mark.parametrize("shape", [(1, 8), (3, 19)])
def test_prefill_matches_jax(models, shape):
    jcfg, tcfg, jp, tp = models
    toks = np.random.default_rng(shape[1]).integers(0, 256, shape).astype(np.int32)
    lj, kj, vj = jt.prefill(jp, jnp.asarray(toks), cfg=jcfg)
    lt, kt, vt = tt.prefill(tp, torch.tensor(toks), tcfg)
    validate_result(lt, np.asarray(lj), LOGIT_TOL, name="logits")
    validate_result(kt, np.asarray(kj), KV_TOL, name="k_rows")
    validate_result(vt, np.asarray(vj), KV_TOL, name="v_rows")


def test_decode_step_matches_jax(models):
    """Two requests (prompts of 5 and 11 tokens) and one inactive slot decode
    one token over pools holding their prefill K/V."""
    jcfg, tcfg, jp, tp = models
    L, kvh, d, ps, pages, pps = jcfg.num_layers, jcfg.num_kv_heads, jcfg.head_dim, 4, 9, 4
    rng = np.random.default_rng(5)
    lens = [5, 11]
    pools = rng.standard_normal((2, L, pages, kvh, ps, d)).astype(np.float32)
    table = np.array([[3, 7, 0, 0], [1, 8, 2, 0], [0, 0, 0, 0]], np.int32)
    tokens = np.array([17, 201, 0], np.int32)
    positions = np.array([lens[0], lens[1], 0], np.int32)  # the new token's slot
    lengths = np.array([lens[0] + 1, lens[1] + 1, 0], np.int32)
    write_pages = np.array([table[0, lens[0] // ps], table[1, lens[1] // ps], pages], np.int32)
    write_slots = np.array([lens[0] % ps, lens[1] % ps, 0], np.int32)
    args = (tokens, positions)
    tail = (lengths, table, write_pages, write_slots)
    lj, kpj, vpj, _, _ = jt.decode_step(
        jp, *map(jnp.asarray, args), jnp.asarray(pools[0]), jnp.asarray(pools[1]),
        *map(jnp.asarray, tail), cfg=jcfg,
    )
    kpt, vpt = torch.tensor(pools[0]), torch.tensor(pools[1])
    lt = tt.decode_step(tp, *map(torch.tensor, args), kpt, vpt, *map(torch.tensor, tail), tcfg)
    validate_result(lt[:2], np.asarray(lj)[:2], LOGIT_TOL, name="logits")
    # The pools were updated in place: the new rows match, the rest is untouched.
    validate_result(kpt, np.asarray(kpj), KV_TOL, name="k_pages")
    validate_result(vpt, np.asarray(vpj), KV_TOL, name="v_pages")
    assert not np.array_equal(kpt.numpy(), pools[0])


def test_bf16_prefill_close_to_jax():
    """bf16 end to end: both sides round activations to bf16 at the same
    places; the gap is bf16 rounding of ~1e-2 on logits of magnitude ~1."""
    jcfg = jt.ModelConfig.tiny()
    jp = jt.init_params(jax.random.key(2), jcfg)
    tp = tt.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.random.default_rng(2).integers(0, 256, (2, 16)).astype(np.int32)
    lj, _, _ = jt.prefill(jp, jnp.asarray(toks), cfg=jcfg)
    lt, _, _ = tt.prefill(tp, torch.tensor(toks), tt.ModelConfig.tiny())
    validate_result(lt, np.asarray(lj, np.float32), 1e-1, name="logits")


def test_unported_model_features_raise():
    """Every preset is ported: ``mixtral8x7b`` (MoE, 8 experts, top-2; its
    MLP held to the JAX package's in ``tests/test_torch_moe.py``) inits and
    runs a prefill, here cut to a small width on the CPU, and the windowed
    and softcapped presets serve (``tests/test_torch_window.py``) and train
    (``tests/test_torch_train.py``): the steps build for all three."""
    from flashattention_tpu_torch.models import train

    cfg = dataclasses.replace(tt.ModelConfig.mixtral8x7b(num_layers=1), vocab_size=256,
                              d_model=64, num_q_heads=4, num_kv_heads=1, head_dim=16,
                              intermediate=96, dtype="float32")
    params = tt.init_params(0, cfg, device="cpu")
    assert tuple(params["layers"][0]["w_gate"].shape) == (8, 64, 96)
    toks = torch.tensor(np.random.default_rng(3).integers(0, 256, (2, 12)))
    logits, k, v = tt.prefill(params, toks, cfg)
    assert logits.shape == (2, 12, 256) and bool(torch.isfinite(logits).all())
    assert k.shape == v.shape == (1, 2, 12, 1, 16)
    for name in ("mistral7b", "gemma2_9b", "mixtral8x7b"):
        cfg = getattr(tt.ModelConfig, name)(num_layers=1)
        assert callable(train.make_train_step(cfg, device="cpu"))
