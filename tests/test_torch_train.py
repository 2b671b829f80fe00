"""Differential tests of the port's training steps against the JAX package.

A tiny float32 model (``tests/test_train.py``'s, at tp = 1) with the JAX
package's random parameters, carried across with ``params_from_jax``; the
same numpy tokens through JAX ``make_train_step`` on a 1x1 CPU mesh (Pallas
kernels in interpret mode) and through the port's step (the kernels' plain
versions on the CPU).  Tolerances: losses within 2e-4 relative and updated
parameters within 3e-5 absolute, ``tests/test_train.py``'s bounds between
two device layouts of the same step.  A Gemma-2-style variant of the model
(head_dim 16, a sliding window of 24 over 128-token rows, logit softcap 30)
also holds the first step's gradients to JAX's, within 5e-4 (the float32
gradient bound of ``tests/test_torch_backward.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from flashattention_tpu.models import transformer as jtransformer
from flashattention_tpu.models.train import common as jcommon
from flashattention_tpu.models.train import make_train_step as j_make_train_step
from flashattention_tpu.models.train import make_train_step_packed as j_make_train_step_packed
from flashattention_tpu.models.train import shard_params
from flashattention_tpu.models.train.forward import _make_grad_map
from flashattention_tpu.utils import packing as jpacking
from flashattention_tpu_torch.models import transformer as ttransformer
from flashattention_tpu_torch.models.train import (
    make_train_step,
    make_train_step_packed,
    packed_positions,
)
from flashattention_tpu_torch.models.train.common import leaves, with_leaves
from flashattention_tpu_torch.models.train.forward import make_grad_fn
from flashattention_tpu_torch.utils import packing as tpacking
from flashattention_tpu_torch.utils.testing import validate_result

torch.set_num_threads(2)

LOSS_RTOL = 2e-4
PARAM_TOL = 3e-5
GRAD_TOL = 5e-4
LR = 5e-2
STEPS = 3
FIELDS = dict(vocab_size=64, num_layers=2, d_model=64, num_q_heads=2, num_kv_heads=1,
              head_dim=32, intermediate=32, dtype="float32")
# Gemma-2's attention options at a tiny size: the window bites within a row.
WFIELDS = dict(FIELDS, head_dim=16, sliding_window=24, logit_softcap=30.0)


def _jax_model(fields=FIELDS):
    cfg = jtransformer.ModelConfig(**fields)
    params = jtransformer.init_params(jax.random.key(0), cfg)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("dp", "tp"))
    return cfg, mesh, shard_params(params, mesh, cfg), params


def _port_params(jparams):
    tree = jax.tree.map(np.asarray, jparams)
    return ttransformer.params_from_jax(tree, device="cpu")


def _tokens(seed, b=2, s=128):
    return np.random.default_rng(seed).integers(0, FIELDS["vocab_size"], (b, s)).astype(np.int32)


def _packed_rows(seed):
    """Documents of 10-90 tokens packed into 128-token rows, first fit."""
    rng = np.random.default_rng(seed)
    docs = [rng.integers(0, FIELDS["vocab_size"], n) for n in rng.integers(10, 91, 5)]
    return docs, tpacking.pack_documents(docs, 128)


def _check_same(j_losses, t_losses, jparams, tparams):
    np.testing.assert_allclose(t_losses, j_losses, rtol=LOSS_RTOL)
    for name in ("embed", "final_norm", "lm_head"):
        validate_result(tparams[name], np.asarray(jparams[name]), PARAM_TOL, name=name)
    for i, (tl, jl) in enumerate(zip(tparams["layers"], jparams["layers"])):
        assert sorted(tl) == sorted(jl)
        for name in tl:
            validate_result(tl[name], np.asarray(jl[name]), PARAM_TOL, name=f"layers.{i}.{name}")


def test_train_step_matches_jax():
    cfg, mesh, jparams, raw = _jax_model()
    tparams = _port_params(raw)
    tokens = _tokens(1)
    jstep = j_make_train_step(mesh, cfg, lr=LR)
    jt = jax.device_put(jnp.asarray(tokens), NamedSharding(mesh, P("dp", None)))
    tstep = make_train_step(ttransformer.ModelConfig(**FIELDS), lr=LR, device="cpu")
    j_losses, t_losses = [], []
    for _ in range(STEPS):
        loss, jparams = jstep(jparams, jt)
        j_losses.append(float(loss))
        loss, tparams = tstep(tparams, torch.tensor(tokens))
        t_losses.append(float(loss))
    _check_same(j_losses, t_losses, jparams, tparams)


def test_train_step_packed_matches_jax():
    cfg, mesh, jparams, raw = _jax_model()
    tparams = _port_params(raw)
    docs, (tokens, segs) = _packed_rows(2)
    j_tokens, j_segs = jpacking.pack_documents(docs, 128)
    np.testing.assert_array_equal(tokens, j_tokens)
    np.testing.assert_array_equal(segs, j_segs)
    assert (segs == tpacking.PAD_SEGMENT).any() and segs.max() >= 1
    sharding = NamedSharding(mesh, P("dp", None))
    jstep = j_make_train_step_packed(mesh, cfg, lr=LR)
    tstep = make_train_step_packed(ttransformer.ModelConfig(**FIELDS), lr=LR, device="cpu")
    j_losses, t_losses = [], []
    for _ in range(STEPS):
        loss, jparams = jstep(jparams, jax.device_put(jnp.asarray(tokens), sharding),
                              jax.device_put(jnp.asarray(segs), sharding))
        j_losses.append(float(loss))
        loss, tparams = tstep(tparams, torch.tensor(tokens), torch.tensor(segs))
        t_losses.append(float(loss))
    _check_same(j_losses, t_losses, jparams, tparams)


@pytest.mark.parametrize("packed", [False, True], ids=["plain", "packed"])
def test_windowed_softcapped_train_step_matches_jax(packed):
    """The window + softcap model: the first step's gradients, then the
    losses and updated parameters of STEPS steps, against the JAX steps."""
    cfg, mesh, jparams, raw = _jax_model(WFIELDS)
    tcfg = ttransformer.ModelConfig(**WFIELDS)
    tparams = _port_params(raw)
    if packed:
        _, (tokens, segs) = _packed_rows(6)
        args = (tokens, segs)
    else:
        args = (_tokens(7),)
    sharding = NamedSharding(mesh, P("dp", None))
    jargs = [jax.device_put(jnp.asarray(x), sharding) for x in args]
    targs = [torch.tensor(x) for x in args]
    _, jgrads = jax.jit(_make_grad_map(mesh, cfg, dp="dp", tp="tp", packed=packed))(
        jparams, *jargs, jnp.int32(0))
    _, tgrads = make_grad_fn(tcfg, packed=packed)(tparams, *targs)
    tgrads = with_leaves(tparams, list(tgrads))
    for name in ("embed", "final_norm", "lm_head"):
        validate_result(tgrads[name], np.asarray(jgrads[name]), GRAD_TOL, name=f"d{name}")
    for i, (tl, jl) in enumerate(zip(tgrads["layers"], jgrads["layers"])):
        for name in tl:
            validate_result(tl[name], np.asarray(jl[name]), GRAD_TOL, name=f"d layers.{i}.{name}")
    make_j = j_make_train_step_packed if packed else j_make_train_step
    make_t = make_train_step_packed if packed else make_train_step
    jstep, tstep = make_j(mesh, cfg, lr=LR), make_t(tcfg, lr=LR, device="cpu")
    j_losses, t_losses = [], []
    for _ in range(STEPS):
        loss, jparams = jstep(jparams, *jargs)
        j_losses.append(float(loss))
        loss, tparams = tstep(tparams, *targs)
        t_losses.append(float(loss))
    _check_same(j_losses, t_losses, jparams, tparams)


@pytest.mark.parametrize("packed", [False, True], ids=["plain", "packed"])
def test_remat_is_bitwise_no_remat(packed):
    """Recomputing each layer in the backward changes nothing on the CPU
    (``tests/test_train.py:593`` pins the same for JAX)."""
    _check_remat_bitwise(packed, FIELDS)


@pytest.mark.parametrize("packed", [False, True], ids=["plain", "packed"])
def test_remat_is_bitwise_no_remat_window_softcap(packed):
    _check_remat_bitwise(packed, WFIELDS)


def _check_remat_bitwise(packed, fields):
    cfg = ttransformer.ModelConfig(**fields)
    tokens = torch.tensor(_tokens(3))
    segs = torch.tensor(_packed_rows(4)[1][1][:1].repeat(2, 0)) if packed else None
    results = []
    for remat in (False, True):
        params = ttransformer.init_params(0, cfg, device="cpu")
        make = make_train_step_packed if packed else make_train_step
        step = make(cfg, lr=LR, remat=remat, device="cpu")
        args = (tokens, segs) if packed else (tokens,)
        losses = [step(params, *args)[0] for _ in range(2)]
        results.append((losses, leaves(params)))
    (l0, p0), (l1, p1) = results
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))


def test_packed_positions_and_packing_match_jax():
    docs, (tokens, segs) = _packed_rows(5)
    j_tokens, j_segs = jpacking.pack_documents(docs, 128)
    np.testing.assert_array_equal(tokens, j_tokens)
    np.testing.assert_array_equal(segs, j_segs)
    assert tpacking.PAD_SEGMENT == jpacking.PAD_SEGMENT
    ids = np.array([[0, 0, 1, 1, 1, 2, -1, -1], [3, 3, 3, 3, 0, 0, 0, 0]], np.int32)
    for x in (segs, ids):
        want = np.asarray(jcommon.packed_positions(jnp.asarray(x)))
        got = packed_positions(torch.tensor(x))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="row_len"):
        tpacking.pack_documents([[1, 2, 3]], 2)


def test_bf16_step_runs():
    cfg = dataclasses.replace(ttransformer.ModelConfig(**FIELDS), dtype="bfloat16")
    params = ttransformer.init_params(0, cfg, device="cpu")
    before = params["layers"][0]["wq"].clone()
    loss, out = make_train_step(cfg, lr=LR, device="cpu")(params, torch.tensor(_tokens(6)))
    assert out is params and params["embed"].dtype == torch.bfloat16
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
    assert not torch.equal(before, params["layers"][0]["wq"])
