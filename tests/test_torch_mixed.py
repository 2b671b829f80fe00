"""Differential tests of mixed precision (``compute_dtype``) on the port's
three training steps against the JAX package.

A tiny model (``tests/test_train.py:899``'s: 2 layers, d_model 64, 4 q / 2 KV heads)
with float32 masters from the JAX package's random parameters, trained with
``compute_dtype="bfloat16"`` through the JAX ``make_train_step``,
``make_train_step_optax`` (AdamW) and ``make_train_step_packed`` on a 1x1
CPU mesh (Pallas kernels in interpret mode) and through the port's steps
(the kernels' plain versions on the CPU), with and without remat.  Both
compute every layer in bf16, so the two differ by bf16 rounding: losses
within 2e-3 relative (half of bf16's unit roundoff, 2^-8), the SGD masters'
updates within 2e-2 of the largest update (the repo's bf16 gate), and the
AdamW masters within 2 lr a step (AdamW normalizes each gradient element,
so an element whose bf16 gradient is near zero can take a step of up to lr
either way in either package).  ``tests/test_train.py:899``'s checks are
ported: the first loss equals a bf16-parameter model's bit for bit, the
masters stay float32 and move, and remat with dropout stays finite.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from flashattention_tpu.models import transformer as jt
from flashattention_tpu.models.train import make_train_step as j_make_train_step
from flashattention_tpu.models.train import make_train_step_optax as j_make_train_step_optax
from flashattention_tpu.models.train import make_train_step_packed as j_make_train_step_packed
from flashattention_tpu.models.train import shard_params
from flashattention_tpu_torch.models import train as ttrain
from flashattention_tpu_torch.models import transformer as tt
from flashattention_tpu_torch.models.train.common import _cast_floats, torch_dtype
from flashattention_tpu_torch.utils import packing as tpacking

torch.set_num_threads(2)

LOSS_RTOL = 2e-3
UPDATE_RTOL = 2e-2
LR = 5e-2
STEPS = 3
FIELDS = dict(vocab_size=64, num_layers=2, d_model=64, num_q_heads=4, num_kv_heads=2,
              head_dim=32, intermediate=64, dtype="float32")
ADAMW = dict(learning_rate=1e-3, b1=0.9, b2=0.95, eps=1e-4, weight_decay=1e-4)


def _models():
    jcfg = jt.ModelConfig(**FIELDS)
    raw = jt.init_params(jax.random.key(0), jcfg)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("dp", "tp"))
    tparams = tt.params_from_jax(jax.tree.map(np.asarray, raw), device="cpu")
    return jcfg, mesh, shard_params(raw, mesh, jcfg), tparams


def _data(packed):
    rng = np.random.default_rng(1)
    if packed:
        return tpacking.pack_documents([rng.integers(0, 64, n) for n in (50, 30, 20, 60)], 128)
    return (rng.integers(0, 64, (2, 128)).astype(np.int32),)


@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
@pytest.mark.parametrize("kind", ["sgd", "adamw", "packed"])
def test_compute_dtype_step_matches_jax(kind, remat):
    """STEPS steps with ``compute_dtype="bfloat16"`` over float32 masters:
    the losses and the updated masters against the JAX step's."""
    jcfg, mesh, jparams, tparams = _models()
    tcfg = tt.ModelConfig(**FIELDS)
    start = [t.clone() for t in ttrain.leaves(tparams)]
    args = _data(kind == "packed")
    sharding = NamedSharding(mesh, P("dp", None))
    jargs = [jax.device_put(jnp.asarray(a), sharding) for a in args]
    targs = [torch.from_numpy(np.asarray(a)) for a in args]
    kw = dict(compute_dtype="bfloat16", remat=remat)
    if kind == "adamw":
        jopt, topt = optax.adamw(**ADAMW), ttrain.adamw(**ADAMW)
        jstep = j_make_train_step_optax(mesh, jcfg, jopt, **kw)
        tstep = ttrain.make_train_step_optax(tcfg, topt, device="cpu", **kw)
        jstate, tstate = jax.jit(jopt.init)(jparams), ttrain.init_opt_state(topt, tparams)
    else:
        make_j = j_make_train_step_packed if kind == "packed" else j_make_train_step
        make_t = ttrain.make_train_step_packed if kind == "packed" else ttrain.make_train_step
        jstep, tstep = make_j(mesh, jcfg, lr=LR, **kw), make_t(tcfg, lr=LR, device="cpu", **kw)
    for _ in range(STEPS):
        if kind == "adamw":
            jloss, jparams, jstate = jstep(jparams, jstate, *jargs)
            tloss, tparams, tstate = tstep(tparams, tstate, *targs)
        else:
            jloss, jparams = jstep(jparams, *jargs)
            tloss, tparams = tstep(tparams, *targs)
        assert abs(float(tloss) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    want = ttrain.leaves(tt.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu"))
    got = ttrain.leaves(tparams)
    assert all(t.dtype == torch.float32 for t in got)
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    update = max(float((w - s).abs().max()) for w, s in zip(want, start))
    bound = 2 * ADAMW["learning_rate"] * STEPS if kind == "adamw" else UPDATE_RTOL * update
    assert err <= bound, (err, bound, update)


@pytest.mark.parametrize("kind", ["sgd", "adamw", "packed"])
def test_mixed_precision_master_weights(kind):
    """``tests/test_train.py:899`` on each step: the first loss of float32
    masters with ``compute_dtype="bfloat16"`` equals, bit for bit, that of
    the same parameters cast to bf16 through the bf16 step; the masters
    stay float32 and move; more steps, and remat with dropout 0.1, stay
    finite."""
    cfg32 = tt.ModelConfig(**FIELDS)
    cfg16 = dataclasses.replace(cfg32, dtype="bfloat16")
    params = tt.init_params(0, cfg32, device="cpu")
    params16 = _cast_floats(params, "bfloat16")
    data = [torch.from_numpy(np.asarray(a)) for a in _data(kind == "packed")]

    def make(cfg, **kw):
        if kind == "adamw":
            opt = ttrain.adamw(1e-2)
            step = ttrain.make_train_step_optax(cfg, opt, device="cpu", **kw)
            states = {}
            return lambda p, *a: step(p, states.setdefault(id(p), ttrain.init_opt_state(opt, p)),
                                      *a)[:2]
        maker = ttrain.make_train_step_packed if kind == "packed" else ttrain.make_train_step
        return maker(cfg, lr=1e-2, device="cpu", **kw)

    before = params["layers"][0]["wq"].clone()
    loss_mp, new = make(cfg32, compute_dtype="bfloat16")(params, *data)
    loss_16, _ = make(cfg16)(params16, *data)
    assert torch.equal(loss_mp, loss_16)
    assert all(t.dtype == torch.float32 for t in ttrain.leaves(new))
    assert not torch.equal(new["layers"][0]["wq"], before)
    step = make(cfg32, compute_dtype="bfloat16")
    for _ in range(3):
        assert torch.isfinite(step(new, *data)[0])
    loss_all, _ = make(cfg32, compute_dtype=torch.bfloat16, remat=True, attn_dropout=0.1)(
        new, *data, 3)
    assert torch.isfinite(loss_all)


def test_cast_floats_and_dtype_names():
    """``_cast_floats`` casts every floating leaf (norms and a router
    included) and leaves integer leaves alone; the dtype is a
    ``torch.dtype`` or the JAX name."""
    cfg = tt.ModelConfig(**dict(FIELDS, num_experts=4))
    tree = tt.init_params(0, cfg, device="cpu")
    tree["layers"][0]["ids"] = torch.arange(3)
    out = _cast_floats(tree, "bfloat16")
    assert out["layers"][0]["ids"] is tree["layers"][0]["ids"]
    assert out["layers"][0]["router"].dtype == torch.bfloat16
    assert all(t.dtype == torch.bfloat16 for t in ttrain.leaves(out) if t.is_floating_point())
    assert tree["embed"].dtype == torch.float32
    assert torch_dtype("bfloat16") is torch.bfloat16 is torch_dtype(torch.bfloat16)
    with pytest.raises(ValueError, match="not a dtype"):
        torch_dtype("Tensor")
