"""Differential tests of the port's LoRA fine-tuning against the JAX package.

A tiny float32 model (``tests/test_train.py``'s LoRA model: 2 layers,
d_model 64, 4 q / 2 KV heads) with the JAX package's random parameters and
adapters, carried across with ``params_from_jax`` / ``lora_from_jax``; the
same numpy tokens through the JAX ``make_train_step_lora`` on a 1x1 CPU mesh
(Pallas kernels in interpret mode) and through the port's step (the
kernels' plain versions on the CPU).  Tolerances: losses within 2e-4
relative and adapters within 3e-5 absolute (``tests/test_torch_train.py``'s
bounds), 1e-5 with AdamW (``tests/test_torch_checkpoint.py``'s), the merge
within 1e-6 in float32 and one bf16 unit in the last place of the weight
in bfloat16; the chain rule within ``tests/test_train.py``'s 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from flashattention_tpu.models import transformer as jt
from flashattention_tpu.models.train import init_lora as j_init_lora
from flashattention_tpu.models.train import make_train_step_lora as j_make_train_step_lora
from flashattention_tpu.models.train import merge_lora as j_merge_lora
from flashattention_tpu.models.train import shard_params
from flashattention_tpu.ops import quant as jquant
from flashattention_tpu.runtime import engine as je
from flashattention_tpu.runtime import kvcache as jk
from flashattention_tpu_torch.models import train as ttrain
from flashattention_tpu_torch.models import transformer as tt
from flashattention_tpu_torch.ops import quant as tquant
from flashattention_tpu_torch.runtime import engine as te
from flashattention_tpu_torch.runtime import kvcache as tk
from flashattention_tpu_torch.utils.testing import validate_result

torch.set_num_threads(2)

LOSS_RTOL = 2e-4
LORA_TOL = 3e-5
OPT_TOL = 1e-5
STEPS = 3
LR = 5e-2
FIELDS = dict(vocab_size=64, num_layers=2, d_model=64, num_q_heads=4, num_kv_heads=2,
              head_dim=32, intermediate=64, dtype="float32")
ADAMW = dict(learning_rate=1e-3, b1=0.9, b2=0.95, eps=1e-4, weight_decay=1e-4)


def _models(fields=FIELDS, targets=("wq", "wv"), shift=0.01):
    """The JAX base, sharded on a 1x1 mesh, and adapters (B shifted off
    zero, so that they shape the forward), with the port's copies."""
    jcfg = jt.ModelConfig(**fields)
    base = jt.init_params(jax.random.key(0), jcfg)
    lora = j_init_lora(jax.random.key(1), base, rank=4, targets=targets)
    lora = jax.tree.map(lambda a: a + shift, lora)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("dp", "tp"))
    tbase = tt.params_from_jax(jax.tree.map(np.asarray, base), device="cpu")
    tlora = tt.lora_from_jax(jax.tree.map(np.asarray, lora), device="cpu")
    return jcfg, mesh, base, shard_params(base, mesh, jcfg), lora, tbase, tlora


def _tokens(seed, mesh):
    x = np.random.default_rng(seed).integers(0, FIELDS["vocab_size"], (2, 128)).astype(np.int32)
    return jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("dp", None))), torch.tensor(x)


def _same_lora(tlora, jlora, tol):
    assert len(tlora) == len(jlora)
    for i, (tl, jl) in enumerate(zip(tlora, jlora)):
        assert sorted(tl) == sorted(jl)
        for t in tl:
            for k in ("a", "b"):
                validate_result(tl[t][k], np.asarray(jl[t][k]), tol, name=f"{i}.{t}.{k}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_merge_lora_matches_jax(dtype):
    """``merge_lora`` against the JAX merge, targets wq and wo, alpha 8;
    the tensors it does not merge are the base's own."""
    fields = dict(FIELDS, dtype=dtype)
    _, _, base, _, lora, tbase, tlora = _models(fields, ("wq", "wo"), 0.02)
    want = j_merge_lora(base, lora, alpha=8.0)
    got = ttrain.merge_lora(tbase, tlora, alpha=8.0)
    for i, (gl, wl) in enumerate(zip(got["layers"], want["layers"])):
        for name in gl:
            w = np.asarray(wl[name].astype(jnp.float32))
            tol = 1e-6 if dtype == "float32" else float(np.abs(w).max()) * 2.0**-7
            validate_result(gl[name], w, tol, name=f"{i}.{name}")
            if name not in ("wq", "wo"):
                assert gl[name] is tbase["layers"][i][name]
        assert gl["wq"].dtype == tbase["layers"][i]["wq"].dtype
    assert got["embed"] is tbase["embed"] and got["lm_head"] is tbase["lm_head"]


@pytest.mark.parametrize("kind", ["plain", "remat", "dropout", "adamw"])
def test_lora_step_matches_jax(kind):
    """STEPS steps of ``make_train_step_lora``: plain SGD, with remat, with
    seeded attention dropout (0.1, seed = step index) and with AdamW
    (``optax.adamw`` against ``train.adamw``): losses and adapters."""
    jcfg, mesh, _, jbase, jlora, tbase, tlora = _models()
    tcfg = tt.ModelConfig(**FIELDS)
    jtok, ttok = _tokens(2, mesh)
    kw = dict(remat=kind == "remat", attn_dropout=0.1 if kind == "dropout" else None)
    before = [t.clone() for t in ttrain.leaves(tbase)]
    if kind == "adamw":
        jopt, topt = optax.adamw(**ADAMW), ttrain.adamw(**ADAMW)
        jstep = j_make_train_step_lora(mesh, jcfg, lr=LR, optimizer=jopt)
        tstep = ttrain.make_train_step_lora(tcfg, lr=LR, optimizer=topt, device="cpu")
        jstate, tstate = jopt.init(jlora), ttrain.init_opt_state(topt, tlora)
    else:
        jstep = j_make_train_step_lora(mesh, jcfg, lr=LR, **kw)
        tstep = ttrain.make_train_step_lora(tcfg, lr=LR, device="cpu", **kw)
    for i in range(STEPS):
        if kind == "adamw":
            jloss, jlora, jstate = jstep(jbase, jlora, jstate, jtok, i)
            tloss, out, tstate = tstep(tbase, tlora, tstate, ttok, i)
        else:
            jloss, jlora = jstep(jbase, jlora, jtok, i)
            tloss, out = tstep(tbase, tlora, ttok, i)
        assert out is tlora
        assert abs(float(tloss) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    _same_lora(tlora, jlora, OPT_TOL if kind == "adamw" else LORA_TOL)
    assert all(torch.equal(a, b) for a, b in zip(before, ttrain.leaves(tbase)))


def test_init_lora_shapes_and_errors():
    """A ~ N(0, 1/d_in) in the weight's dtype, B = 0, per layer and target,
    drawn from the seed's generator (the same seed, the same A); an MoE
    expert stack or another non-2-D target raises the JAX ``ValueError``."""
    cfg = tt.ModelConfig(**dict(FIELDS, dtype="bfloat16", d_model=256))
    params = tt.init_params(0, cfg, device="cpu")
    lora = ttrain.init_lora(3, params, rank=8, targets=("wq", "wv", "w_down"))
    assert len(lora) == cfg.num_layers
    for layer, adapters in zip(params["layers"], lora):
        assert list(adapters) == ["wq", "wv", "w_down"]
        for t, ab in adapters.items():
            d_in, d_out = layer[t].shape
            assert ab["a"].shape == (d_in, 8) and ab["b"].shape == (8, d_out)
            assert ab["a"].dtype == ab["b"].dtype == torch.bfloat16
            assert not ab["b"].any()
            assert abs(float(ab["a"].float().std()) - d_in**-0.5) < 0.2 * d_in**-0.5
    again = ttrain.init_lora(torch.Generator().manual_seed(3), params, rank=8,
                             targets=("wq", "wv", "w_down"))
    assert all(torch.equal(a, b) for a, b in zip(ttrain.leaves(lora), ttrain.leaves(again)))
    moe = tt.ModelConfig(**dict(FIELDS, num_experts=4))
    with pytest.raises(ValueError, match="must be 2-D"):
        ttrain.init_lora(0, tt.init_params(0, moe, device="cpu"), targets=("wq", "w_up"))
    jmoe = jt.init_params(jax.random.key(0), jt.ModelConfig(**dict(FIELDS, num_experts=4)))
    with pytest.raises(ValueError, match="must be 2-D"):
        j_init_lora(jax.random.key(1), jmoe, targets=("wq", "w_up"))


def test_b_zero_is_the_base_and_the_base_stays_frozen():
    """With B = 0 (the port's own ``init_lora``) the first LoRA loss is the
    base model's (``tests/test_train.py:1004``) and the JAX step's; steps
    move the loss through the adapters alone, and every base tensor keeps
    its bits."""
    jcfg, mesh, _, jbase, jlora, tbase, _ = _models(shift=0.0)
    tcfg = tt.ModelConfig(**FIELDS)
    jtok, ttok = _tokens(3, mesh)
    tlora = ttrain.init_lora(1, tbase, rank=4)
    before = [t.clone() for t in ttrain.leaves(tbase)]
    base_loss = ttrain.make_train_step(tcfg, lr=0.0, device="cpu")(tbase, ttok)[0]
    step = ttrain.make_train_step_lora(tcfg, lr=LR, device="cpu")
    losses = [float(step(tbase, tlora, ttok)[0]) for _ in range(5)]
    assert losses[0] == pytest.approx(float(base_loss), rel=1e-6)
    jloss = j_make_train_step_lora(mesh, jcfg, lr=LR)(jbase, jlora, jtok)[0]
    assert losses[0] == pytest.approx(float(jloss), rel=LOSS_RTOL)
    assert losses[-1] < losses[0]
    assert any(ab["b"].any() for adapters in tlora for ab in adapters.values())
    assert all(torch.equal(a, b) for a, b in zip(before, ttrain.leaves(tbase)))


def test_lora_grads_are_exact_chain_rule():
    """``tests/test_train.py:955`` on the port: dA = dW B^T (alpha/r) and
    dB = A^T dW (alpha/r), dW the full fine-tune gradient of the merged
    model (both read off SGD steps at lr 1)."""
    fields = dict(FIELDS, num_layers=1)
    _, _, _, _, _, tbase, tlora = _models(fields)
    cfg = tt.ModelConfig(**fields)
    r, alpha = 4, 16.0
    _, ttok = _tokens(4, Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("dp", "tp")))
    old = [t.clone() for t in ttrain.leaves(tlora)]
    a0, b0 = tlora[0]["wq"]["a"].clone(), tlora[0]["wq"]["b"].clone()
    merged = ttrain.merge_lora(tbase, tlora, alpha)
    merged = {**merged, "layers": [{k: v.clone() for k, v in lay.items()}
                                   for lay in merged["layers"]]}
    w0 = merged["layers"][0]["wq"].clone()
    loss_l = ttrain.make_train_step_lora(cfg, alpha=alpha, lr=1.0, device="cpu")(
        tbase, tlora, ttok)[0]
    loss_f = ttrain.make_train_step(cfg, lr=1.0, device="cpu")(merged, ttok)[0]
    assert float(loss_l) == pytest.approx(float(loss_f), rel=1e-6)
    d_a, d_b = a0 - tlora[0]["wq"]["a"], b0 - tlora[0]["wq"]["b"]
    d_w = w0 - merged["layers"][0]["wq"]
    s = alpha / r
    np.testing.assert_allclose(d_a.numpy(), (d_w @ b0.T * s).numpy(), atol=1e-5)
    np.testing.assert_allclose(d_b.numpy(), (a0.T @ d_w * s).numpy(), atol=1e-5)
    assert any(not torch.equal(a, b) for a, b in zip(old, ttrain.leaves(tlora)))


def test_merge_then_quantize_serves_as_jax():
    """``tests/test_quant.py:247``'s export path: merge, quantize to int8
    weight-only, serve whole-prompt; greedy tokens equal the JAX engine's
    on the same adapters."""
    jcfg, _, base, _, lora, tbase, tlora = _models(shift=0.02)
    tcfg = tt.ModelConfig(**FIELDS)
    jq = jquant.quantize_weights(j_merge_lora(base, lora))
    tq = tquant.quantize_weights(ttrain.merge_lora(tbase, tlora))
    cache = dict(num_layers=2, num_kv_heads=2, head_dim=32, page_size=8, num_pages=64,
                 dtype="float32")
    prompt = [5, 4, 3, 2, 1]
    jeng = je.Engine(jq, jcfg, jk.CacheConfig(**cache),
                     je.EngineConfig(max_batch=2, pages_per_seq=8, prefill_chunk=0))
    teng = te.Engine(tq, tcfg, tk.CacheConfig(**cache),
                     te.EngineConfig(max_batch=2, pages_per_seq=8, prefill_chunk=0), device="cpu")
    jr, tr = jeng.add_request(prompt, 6), teng.add_request(prompt, 6)
    want = jeng.run()[jr]
    assert teng.run()[tr] == want and len(want) == 6


def test_lora_step_device_and_state_checks():
    """The step refuses adapters on another device than the step's, and an
    optimizer state built over other tensors."""
    cfg = tt.ModelConfig(**FIELDS)
    params = tt.init_params(0, cfg, device="cpu")
    lora = ttrain.init_lora(0, params, rank=2)
    opt = ttrain.adamw(1e-3)
    step = ttrain.make_train_step_lora(cfg, optimizer=opt, device="cpu")
    tokens = torch.zeros((1, 16), dtype=torch.int32)
    with pytest.raises(ValueError, match="opt_state"):
        step(params, lora, ttrain.init_opt_state(opt, ttrain.init_lora(0, params, rank=2)),
             tokens)
    loss, out, state = step(params, lora, ttrain.init_opt_state(opt, lora), tokens)
    assert out is lora and torch.isfinite(loss)
    meta = [{t: {k: v.to("meta") for k, v in ab.items()} for t, ab in adapters.items()}
            for adapters in lora]
    with pytest.raises(ValueError, match="runs on cpu"):
        ttrain.make_train_step_lora(cfg, device="cpu")(params, meta, tokens)
