"""Checkpoint and resume, and the optimizer step, against the JAX package.

- ``Engine.state_dict`` / ``Engine.from_state`` and
  ``utils.checkpoint.save_checkpoint`` / ``load_checkpoint``: the ports of
  ``tests/test_runtime.py``'s ``test_engine_checkpoint_resume`` (:235),
  ``test_durable_checkpoint_roundtrip`` (:756) and
  ``test_sampling_params_survive_checkpoint`` (:1198).  Greedy tokens after
  save -> load -> ``from_state`` -> ``run`` equal the uninterrupted port run
  and the JAX engine's (``ModelConfig.tiny()`` and the MoE model, float32);
  seeded and engine-default sampled streams and logprobs survive a JSON
  round trip.
- Trees with int8, fp8 and bfloat16 leaves and a ``torch.optim`` state dict
  round-trip bit for bit; a second save over a path replaces the first.
- The optimizer step: three AdamW steps against ``optax.adamw`` with the
  same hyperparameters, plain and packed, on the MoE and the dense model
  (the one-card half of ``tests/test_moe.py:213``): losses and parameters
  within 1e-5 in float32 (eps 1e-4, see ADAMW); at optax's defaults, the
  port's step tail fed the JAX step's gradients against optax's update.  A
  training run resumed from a checkpoint after two steps takes the
  uninterrupted run's third step, bit for bit.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from flashattention_tpu.models import transformer as jt
from flashattention_tpu.models.train import make_train_step_optax as j_make_train_step_optax
from flashattention_tpu.models.train import make_train_step_packed as j_make_train_step_packed
from flashattention_tpu.models.train import shard_params
from flashattention_tpu.models.train.forward import _make_grad_map
from flashattention_tpu.runtime import engine as je
from flashattention_tpu.runtime import kvcache as jk
from flashattention_tpu_torch.models import train as ttrain
from flashattention_tpu_torch.models.train.common import _make_step
from flashattention_tpu_torch.models import transformer as tt
from flashattention_tpu_torch.ops import quant as tquant
from flashattention_tpu_torch.runtime import engine as te
from flashattention_tpu_torch.runtime import kvcache as tk
from flashattention_tpu_torch.utils import packing as tpacking
from flashattention_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from flashattention_tpu_torch.utils.testing import validate_result

torch.set_num_threads(2)

OPT_TOL = 1e-5
# eps 1e-4: at optax's 1e-8, Adam divides a few gradients of 1e-7-1e-6 by
# their own magnitude, and the JAX kernels' float32 products in interpret
# mode (bf16_3x) leave gradients about 3e-6 of their tensor's largest off
# the port's; those few parameters then move up to 8e-5 apart in three
# steps.  With eps 1e-4 an update moves at most lr * |dg| / eps, well under
# OPT_TOL, and eps takes part in every update.  optax's defaults are held
# on equal gradients in test_adamw_update_matches_optax.
ADAMW = dict(learning_rate=1e-3, b1=0.9, b2=0.95, eps=1e-4, weight_decay=1e-4)
MOE = dict(vocab_size=64, num_layers=2, d_model=64, num_q_heads=4, num_kv_heads=2, head_dim=32,
           intermediate=64, dtype="float32", num_experts=4, experts_per_token=2)
DENSE = {**MOE, "num_experts": None}
PROMPTS = ([1, 2, 3], [9, 8, 7, 6], [5, 5])


def _models(fields=None):
    if fields is None:
        jcfg = dataclasses.replace(jt.ModelConfig.tiny(), dtype="float32")
        tcfg = dataclasses.replace(tt.ModelConfig.tiny(), dtype="float32")
    else:
        jcfg, tcfg = jt.ModelConfig(**fields), tt.ModelConfig(**fields)
    jp = jt.init_params(jax.random.key(0), jcfg)
    tp = tt.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module", params=["tiny", "moe"])
def models(request):
    return _models(None if request.param == "tiny" else MOE)


def _cache(cfg, mod):
    return mod.CacheConfig(num_layers=cfg.num_layers, num_kv_heads=cfg.num_kv_heads,
                           head_dim=cfg.head_dim, page_size=8, num_pages=64, dtype="float32")


def _port_engine(tcfg, tp):
    return te.Engine(tp, tcfg, _cache(tcfg, tk), te.EngineConfig(max_batch=4, pages_per_seq=8),
                     device="cpu")


def _jax_run(jcfg, jp, prompts, budget, sampling=None):
    eng = je.Engine(jp, jcfg, _cache(jcfg, jk), je.EngineConfig(max_batch=4, pages_per_seq=8))
    for p in prompts:
        eng.add_request(p, budget, sampling=sampling)
    return eng.run()


def _equal(a, b) -> bool:
    """Bit for bit, dtype and shape included."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    return torch.equal(tquant.byte_view(a).cpu(), tquant.byte_view(b).cpu())


def test_engine_checkpoint_resume(models):
    """Snapshot mid-generation, restore into a fresh engine: the outputs are
    the uninterrupted engine's and the JAX engine's."""
    jcfg, tcfg, jp, tp = models
    full = _port_engine(tcfg, tp)
    for p in PROMPTS:
        full.add_request(p, 10)
    want = full.run()
    assert want == _jax_run(jcfg, jp, PROMPTS, 10)

    half = _port_engine(tcfg, tp)
    for p in PROMPTS:
        half.add_request(p, 10)
    for _ in range(4):
        half.step()
    state = half.state_dict()
    assert {r["state"] for r in state["requests"]} == {"running"}
    assert all(0 < len(r["output"]) < 10 for r in state["requests"])
    resumed = te.Engine.from_state(state, tp, tcfg, _cache(tcfg, tk),
                                   te.EngineConfig(max_batch=4, pages_per_seq=8), device="cpu")
    assert resumed.run() == want
    assert resumed.cache.num_free_pages() == 64


def test_durable_checkpoint_roundtrip(models, tmp_path):
    """Parameters and the engine state through ``save_checkpoint`` and
    ``load_checkpoint(device="cpu")``: every tensor bit for bit, and a
    process restored from them continues as the uninterrupted one and the
    JAX engine do."""
    jcfg, tcfg, jp, tp = models
    want = _jax_run(jcfg, jp, [[3, 1, 4, 1]], 8)
    eng = _port_engine(tcfg, tp)
    eng.add_request([3, 1, 4, 1], 8)
    for _ in range(3):
        eng.step()
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, tp, engine_state=eng.state_dict())
    assert sorted(os.listdir(path)) == ["engine_state.json", "tensors.pt", "tree.json"]
    params, engine_state = load_checkpoint(path, device="cpu")
    flat = ttrain.leaves(params)
    assert len(flat) == len(ttrain.leaves(tp))
    assert all(_equal(a, b) for a, b in zip(flat, ttrain.leaves(tp)))
    assert list(params["layers"][0]) == list(tp["layers"][0])
    resumed = te.Engine.from_state(engine_state, params, tcfg, _cache(tcfg, tk),
                                   te.EngineConfig(max_batch=4, pages_per_seq=8), device="cpu")
    assert resumed.run() == want == eng.run()


def test_sampling_params_survive_checkpoint(models):
    """Seeded sampled requests with logprobs, and engine-default sampling
    (the engine generator's state), resume through a JSON round trip on the
    draws the uninterrupted engine makes."""
    _, tcfg, _, tp = models
    sp = te.SamplingParams(greedy=False, temperature=0.8, seed=7, stop_tokens=(99999,),
                           stop_sequences=((99998, 99997),), logprobs=True)
    ecfg = te.EngineConfig(max_batch=4, pages_per_seq=8, greedy=False, temperature=0.9)
    prompt = [3, 1, 4, 1, 5, 9, 2, 6]

    def engine():
        eng = te.Engine(tp, tcfg, _cache(tcfg, tk), ecfg, device="cpu", seed=11)
        return eng, [eng.add_request(prompt, 6, sampling=sp), eng.add_request(prompt[:5], 6)]

    full, ids = engine()
    want = full.run()
    eng, _ = engine()
    for _ in range(3):
        eng.step()
    snap = json.loads(json.dumps(eng.state_dict()))
    resumed = te.Engine.from_state(snap, tp, tcfg, _cache(tcfg, tk), ecfg, device="cpu")
    got = resumed.run()
    assert got == want
    seeded = resumed.requests[ids[0]]
    assert seeded.sampling == sp  # tuples restored from JSON lists
    assert len(seeded.logprobs) == len(got[ids[0]]) == 6
    # The stored ones exactly; those after the restore within float32 noise
    # (the restored context was prefilled where the uninterrupted run decoded).
    n = len(snap["requests"][0]["logprobs"])
    assert 0 < n < 6 and seeded.logprobs[:n] == full.requests[ids[0]].logprobs[:n]
    np.testing.assert_allclose(seeded.logprobs, full.requests[ids[0]].logprobs, atol=1e-4)


def _quantized_tree():
    g = torch.Generator().manual_seed(3)
    w = torch.randn((4, 16, 8), generator=g)
    return {
        "int8": tquant.quantize_weight(w.to(torch.bfloat16), "int8"),
        "fp8": tquant.quantize_weight(w, "fp8"),
        "bf16": w.to(torch.bfloat16),
        "fp8_raw": w.to(torch.float8_e4m3fn),
        "ids": torch.arange(5, dtype=torch.int32),
        "meta": {"step": 3, "name": "moe", "lr": 1e-3, "betas": (0.9, 0.95), "none": None,
                 7: [True, False]},
    }


def test_tree_roundtrip_is_bitwise(tmp_path):
    """int8, fp8 and bfloat16 leaves (quantized and not), integer tensors,
    scalars, tuples and integer keys, and an AdamW state dict after a step
    of bf16 parameters: bit for bit, with the leaves' types and dtypes."""
    tree = _quantized_tree()
    params = [torch.randn((8, 8), generator=torch.Generator().manual_seed(i)).to(torch.bfloat16)
              for i in range(3)]
    opt = ttrain.adamw(1e-2)(params)
    for p in params:
        p.grad = torch.ones_like(p)
    opt.step()
    tree["opt_state"] = opt.state_dict()
    path = str(tmp_path / "tree")
    save_checkpoint(path, tree)
    got, engine_state = load_checkpoint(path, device="cpu")
    assert engine_state is None

    def same(a, b):
        if torch.is_tensor(b):
            assert torch.is_tensor(a) and _equal(a, b), (a, b)
        elif isinstance(b, tquant.QuantizedWeight):
            assert isinstance(a, tquant.QuantizedWeight) and a.ldtype == b.ldtype
            assert _equal(a.payload, b.payload) and _equal(a.scales, b.scales)
        elif isinstance(b, dict):
            assert list(a) == list(b)
            for k in b:
                same(a[k], b[k])
        elif isinstance(b, (list, tuple)):
            assert type(a) is type(b) and len(a) == len(b)
            for x, y in zip(a, b):
                same(x, y)
        else:
            assert a == b and type(a) is type(b)

    same(got, tree)
    assert got["int8"].ldtype == "bfloat16" and got["fp8"].payload.dtype == torch.float8_e4m3fn
    fresh = ttrain.adamw(1e-2)([p.clone() for p in params])
    fresh.load_state_dict(got["opt_state"])
    same(fresh.state_dict(), tree["opt_state"])


def test_save_over_an_existing_checkpoint_replaces_it(tmp_path):
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, {"a": torch.ones(3), "b": [1, 2]}, engine_state={"next_id": 1})
    save_checkpoint(path, {"c": torch.zeros(2, dtype=torch.int8)})
    tree, engine_state = load_checkpoint(path, device="cpu")
    assert list(tree) == ["c"] and _equal(tree["c"], torch.zeros(2, dtype=torch.int8))
    assert engine_state is None  # the old sidecar went with the old checkpoint
    assert os.listdir(tmp_path) == ["ckpt"]  # no temporary directory left
    with pytest.raises(TypeError, match="cannot store"):
        save_checkpoint(path, {"bad": object()})
    assert load_checkpoint(path, device="cpu")[0].keys() == {"c"}  # a failed save leaves it
    assert os.listdir(tmp_path) == ["ckpt"]


def _jax_mesh_model(fields):
    jcfg = jt.ModelConfig(**fields)
    raw = jt.init_params(jax.random.key(0), jcfg)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("dp", "tp"))
    tp = tt.params_from_jax(jax.tree.map(np.asarray, raw), device="cpu")
    return jcfg, mesh, shard_params(raw, mesh, jcfg), tp


def _check_params(jparams, tparams, tol):
    for name in ("embed", "final_norm", "lm_head"):
        validate_result(tparams[name], np.asarray(jparams[name]), tol, name=name)
    for i, (tl, jl) in enumerate(zip(tparams["layers"], jparams["layers"])):
        assert sorted(tl) == sorted(jl)
        for name in tl:
            validate_result(tl[name], np.asarray(jl[name]), tol, name=f"layers.{i}.{name}")


def _step_args(packed, seed):
    rng = np.random.default_rng(seed)
    if packed:
        return tpacking.pack_documents([rng.integers(0, 64, n) for n in (50, 30, 20, 60)], 128)
    return (rng.integers(0, 64, (2, 128)).astype(np.int32),)


@pytest.mark.parametrize("packed", [False, True], ids=["plain", "packed"])
@pytest.mark.parametrize("fields", [MOE, DENSE], ids=["moe", "dense"])
def test_adamw_step_matches_optax(fields, packed):
    """Three AdamW steps: the port's ``make_train_step_optax`` (or
    ``make_train_step_packed(optimizer=)``) with ``train.adamw`` against the
    JAX steps with ``optax.adamw``, the same lr, b1, b2, eps and weight
    decay: losses and parameters within 1e-5."""
    jcfg, mesh, jparams, tparams = _jax_mesh_model(fields)
    tcfg = tt.ModelConfig(**fields)
    args = _step_args(packed, 8)
    sharding = NamedSharding(mesh, P("dp", None))
    jargs = [jax.device_put(jnp.asarray(a), sharding) for a in args]
    targs = [torch.from_numpy(np.asarray(a)) for a in args]
    jopt = optax.adamw(**ADAMW)
    topt = ttrain.adamw(**ADAMW)
    if packed:
        jstep = j_make_train_step_packed(mesh, jcfg, optimizer=jopt)
        tstep = ttrain.make_train_step_packed(tcfg, optimizer=topt, device="cpu")
    else:
        jstep = j_make_train_step_optax(mesh, jcfg, jopt)
        tstep = ttrain.make_train_step_optax(tcfg, topt, device="cpu")
    jstate = jax.jit(jopt.init)(jparams)
    tstate = ttrain.init_opt_state(topt, tparams)
    for _ in range(3):
        jloss, jparams, jstate = jstep(jparams, jstate, *jargs)
        tloss, tparams, tstate = tstep(tparams, tstate, *targs)
        assert abs(float(tloss) - float(jloss)) <= OPT_TOL * abs(float(jloss))
    _check_params(jparams, tparams, OPT_TOL)
    assert all(s["step"] == 3 for s in tstate.state.values())


def test_adamw_update_matches_optax():
    """``optax.adamw(1e-3)`` at its defaults (b1 0.9, b2 0.999, eps 1e-8,
    weight decay 1e-4) against ``train.adamw(1e-3)``: three steps of the
    port's step tail (``common._make_step``) fed, at each step, the
    gradients of the JAX step at the JAX parameters, against optax's
    update of them; the parameters within 1e-5."""
    jcfg, mesh, jparams, tparams = _jax_mesh_model(MOE)
    args = _step_args(False, 8)
    jargs = [jax.device_put(jnp.asarray(a), NamedSharding(mesh, P("dp", None))) for a in args]
    grad_map = jax.jit(_make_grad_map(mesh, jcfg, dp="dp", tp="tp"))
    jopt, topt = optax.adamw(1e-3), ttrain.adamw(1e-3)
    fed = {}
    tstep = _make_step(lambda params, *args: (fed["loss"], fed["grads"]), None, topt)
    jstate, tstate = jopt.init(jparams), ttrain.init_opt_state(topt, tparams)
    for _ in range(3):
        loss, grads = grad_map(jparams, *jargs, jnp.int32(0))
        fed["loss"] = float(loss)
        fed["grads"] = ttrain.leaves(tt.params_from_jax(jax.tree.map(np.asarray, grads),
                                                        device="cpu"))
        updates, jstate = jopt.update(grads, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        assert tstep(tparams, tstate, torch.from_numpy(args[0]))[0] == fed["loss"]
    _check_params(jparams, tparams, OPT_TOL)


def test_optimizer_state_must_be_the_params():
    tcfg = tt.ModelConfig(**MOE)
    params = tt.init_params(0, tcfg, device="cpu")
    other = tt.init_params(0, tcfg, device="cpu")
    opt = ttrain.adamw(1e-3)
    step = ttrain.make_train_step_optax(tcfg, opt, device="cpu")
    tokens = torch.zeros((1, 16), dtype=torch.int32)
    with pytest.raises(ValueError, match="not built over these parameters"):
        step(params, ttrain.init_opt_state(opt, other), tokens)
    with pytest.raises(ValueError, match="runs on cpu"):
        step(params, ttrain.init_opt_state(opt, params), tokens.to("meta"))


@pytest.mark.parametrize("packed", [False, True], ids=["plain", "packed"])
def test_training_resumes_from_a_checkpoint(tmp_path, packed):
    """Two AdamW steps, ``{params, opt_state}`` saved and loaded, the third
    step from the restored state: bit for bit the uninterrupted run's."""
    tcfg = tt.ModelConfig(**MOE)
    opt = ttrain.adamw(**ADAMW)
    make = ttrain.make_train_step_packed if packed else ttrain.make_train_step_optax
    step = make(tcfg, optimizer=opt, device="cpu") if packed else make(tcfg, opt, device="cpu")
    args = [torch.from_numpy(np.asarray(a)) for a in _step_args(packed, 9)]

    def run(n, params=None, state=None):
        params = params or tt.init_params(0, tcfg, device="cpu")
        state = state or ttrain.init_opt_state(opt, params)
        losses = [float(step(params, state, *args)[0]) for _ in range(n)]
        return losses, params, state

    want_losses, want, _ = run(3)
    _, params, state = run(2)
    path = str(tmp_path / "train")
    save_checkpoint(path, {"params": params, "opt_state": state.state_dict()})
    tree, _ = load_checkpoint(path, device="cpu")
    assert all(_equal(a, b) for a, b in zip(ttrain.leaves(tree["params"]), ttrain.leaves(params)))
    restored = ttrain.init_opt_state(opt, tree["params"])
    restored.load_state_dict(tree["opt_state"])
    losses, got, _ = run(1, tree["params"], restored)
    assert losses == want_losses[2:]
    assert all(_equal(a, b) for a, b in zip(ttrain.leaves(got), ttrain.leaves(want)))
