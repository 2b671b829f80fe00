"""Attention dropout in the port against the JAX package.

The keep mask bit for bit against the JAX package's ``dropout_keep_mask``;
then the same numpy inputs through the JAX function (its Pallas kernels in
interpret mode on the CPU, ``precision="float32"``) and through the port (on
CPU tensors, each kernel's plain version): the forward and ``attention_vjp``
gradients, causal and not, with the GQA row fold, with window and softcap,
with segment ids (the two-pass backward), the backward's fused and two-pass
forms on the same saved statistics, and a ragged GQA ``attention()`` call
(S_q = 200: the JAX package pads each group to 256 rows, which moves the
folded groups' dropout rows).  Then both training steps with
``attn_dropout=0.1`` against the JAX steps on a 1x1 mesh, and remat against
no remat.  Tolerances: forward 2e-5 in float32 (the JAX block-mask and
backward suites' float32 bound) and 2e-2 in bfloat16; gradients 5e-4
(``tests/test_torch_backward.py``'s float32 bound); training as in
``tests/test_torch_train.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import flashattention_tpu as fj
import flashattention_tpu_torch as ft
from flashattention_tpu.models.train import make_train_step as j_make_train_step
from flashattention_tpu.models.train import make_train_step_packed as j_make_train_step_packed
from flashattention_tpu.ops import backward as jbwd
from flashattention_tpu.ops import flash as jflash
from flashattention_tpu_torch.models import transformer as ttransformer
from flashattention_tpu_torch.models.train import make_train_step, make_train_step_packed
from flashattention_tpu_torch.models.train.common import leaves
from flashattention_tpu_torch.models.train.forward import dropout_seeds
from flashattention_tpu_torch.ops import backward as tbwd
from flashattention_tpu_torch.ops import flash as tflash
from flashattention_tpu_torch.utils.packing import PAD_SEGMENT
from flashattention_tpu_torch.utils.testing import to_numpy, validate_result

from test_torch_train import FIELDS, LR, STEPS, _check_same, _jax_model, _packed_rows, _port_params, _tokens

torch.set_num_threads(2)

FWD_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
GRAD_TOL = {"float32": 5e-4, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JBLOCKS = jflash.BlockSizes(128, 128, 128)


def _rand(rng, shape, dt, mult=1.0):
    x = rng.standard_normal(shape).astype(np.float32) * np.float32(mult)
    return to_numpy(torch.tensor(x).to(TDT[dt]).float())


# A layer seed as the training steps fold it (step 3, layer 1).
FOLDED = dropout_seeds(3, 2)[1]


@pytest.mark.parametrize("seed", [0, 1, -1, 2**31 - 1, FOLDED])
def test_keep_mask_matches_jax(seed):
    for bh in (0, 5, 4097):
        for row, col in ((0, 0), (128, 384), (1000, 33)):
            for rate in (0.1, 1 / 3, 0.5, 0.9):
                want = np.asarray(jflash.dropout_keep_mask(
                    jnp.int32(seed), jnp.int32(bh), row, col, (24, 40), rate))
                got = tflash.dropout_keep_mask(seed, bh, row, col, (24, 40), rate)
                np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{bh} {row} {col} {rate}")
    assert tflash.dropout_threshold(0.5) == 1 << 23


def test_dropout_seeds_fold_as_jax():
    """The per-layer seeds: JAX's int32 arithmetic on the 1x1 mesh."""
    for seed in (0, 1, 7, -5, 2**31 - 1):
        fold = jnp.int32(seed) * jnp.int32(-1640531527) + jnp.int32(0) * 7919 + jnp.int32(0) * 104729
        want = [int(fold * jnp.int32(-1640531527) + jnp.int32(li + 1)) for li in range(3)]
        assert dropout_seeds(seed, 3) == want


# (name, BH, G, S per group, d, causal, window, softcap, q scale, segments, dtype)
CASES = [
    ("causal", 2, 1, 256, 32, True, None, None, 1.0, False, "float32"),
    ("noncausal", 2, 1, 128, 32, False, None, None, 1.0, False, "float32"),
    ("gqa_fold", 2, 2, 128, 32, True, None, None, 1.0, False, "float32"),
    ("window_softcap", 1, 2, 128, 64, True, 40, 30.0, 8.0, False, "float32"),
    ("segments", 2, 2, 128, 32, True, None, None, 1.0, True, "float32"),
    ("gqa_bf16", 2, 2, 128, 32, True, None, None, 1.0, False, "bfloat16"),
]
RATE, SEED = 0.25, 1234


def _case_inputs(case, seed=0):
    _, bh, g, s, d, causal, window, cap, qmul, segments, dt = case
    rng = np.random.default_rng(seed)
    q = _rand(rng, (bh, g * s, d), dt, qmul)
    k, v = _rand(rng, (bh, s, d), dt), _rand(rng, (bh, s, d), dt)
    do = _rand(rng, (bh, g * s, d), dt, 1.0 / qmul)
    seg = (None, None)
    if segments:
        ids = np.full((bh, s), PAD_SEGMENT, np.int32)
        ids[:, :100] = 0
        ids[0, 60:110] = 1
        seg = (np.tile(ids, (1, g)), ids)
    kw = dict(causal=causal, scale=d**-0.5, q_seq_len=s if g > 1 else None, window=window,
              logit_softcap=cap)
    return q, k, v, do, seg, kw, dt


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_forward_and_vjp_match_jax(case):
    q, k, v, do, (sq, skv), kw, dt = _case_inputs(case)
    prec = "float32" if dt == "float32" else None

    def j_out(q, k, v):
        return jbwd.attention_vjp(
            q, k, v, kw["causal"], kw["scale"], JBLOCKS, prec, True, kw["q_seq_len"],
            kw["window"], kw["logit_softcap"], RATE, SEED,
            None if sq is None else jnp.asarray(sq), None if skv is None else jnp.asarray(skv))

    jargs = [jnp.asarray(x, JDT[dt]) for x in (q, k, v)]
    jo, jvjp = jax.vjp(j_out, *jargs)
    jgrads = jvjp(jnp.asarray(do, JDT[dt]))
    targs = [torch.tensor(x).to(TDT[dt]).requires_grad_() for x in (q, k, v)]
    seg = {} if sq is None else dict(q_segment_ids=torch.tensor(sq), kv_segment_ids=torch.tensor(skv))
    # Both sides in the same mode: float32 dropout at d = 64 / 128 has a
    # float32 form in "bf16_3x" (tests/test_torch_bwd_f32.py), so the exact
    # comparison names "float32" on the port's side too.
    to = tbwd.attention_vjp(*targs, kw["causal"], kw["scale"], None, prec, None, kw["q_seq_len"],
                            kw["window"], kw["logit_softcap"], RATE, SEED, **seg)
    validate_result(to, np.asarray(jo, np.float32), FWD_TOL[dt], name="o")
    tgrads = torch.autograd.grad(to, targs, torch.tensor(do).to(TDT[dt]))
    for name, g_, w in zip(("dq", "dk", "dv"), tgrads, jgrads):
        validate_result(g_, np.asarray(w, np.float32), GRAD_TOL[dt], name=name)
    # Dropout moved the output: it differs from the undropped one.
    undropped = tflash.flash_attention(*(t.detach() for t in targs), causal=kw["causal"],
                                       scale=kw["scale"], q_seq_len=kw["q_seq_len"],
                                       window=kw["window"], logit_softcap=kw["logit_softcap"],
                                       **seg)
    assert (to.detach().float() - undropped.float()).abs().max() > 0.05


# One process's float32 plain forward and backward with dropout, on the
# "causal" case's inputs: the hash of every output's bytes.
_PROCESS_DIGEST = """
import hashlib, sys
import numpy as np, torch
sys.path.insert(0, sys.argv[1])
torch.set_num_threads(2)
from test_torch_dropout import CASES, RATE, SEED, _case_inputs
from flashattention_tpu_torch.ops import backward, flash
q, k, v, do, _, kw, _ = _case_inputs(CASES[0])
q, k, v, do = (torch.tensor(x) for x in (q, k, v, do))
kw = dict(causal=kw["causal"], scale=kw["scale"], dropout_rate=RATE, dropout_seed=SEED)
o, l, m = flash.flash_attention_plain(q, k, v, save_residuals=True, **kw)
grads = backward.flash_attention_bwd_plain(q, k, v, o, m + torch.log(l), do, **kw)
h = hashlib.sha256()
for t in (o, l, m, *grads):
    h.update(t.numpy().tobytes())
print(h.hexdigest())
"""


def test_plain_dropout_is_the_same_in_every_process():
    """The float32 plain forward and backward with dropout give the same
    bytes in 4 fresh processes started together.  torch's float32 exp on
    the CPU (MKL's vector math) once varied in its last bit between
    processes over masked scores, which moved test_forward_and_vjp_match_jax
    [causal] by 7e-5 in some runs (ops/flash.py::_exp)."""
    import os
    import subprocess
    import sys

    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([here, os.path.dirname(here)]))
    procs = [subprocess.Popen([sys.executable, "-c", _PROCESS_DIGEST, os.path.dirname(here)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
                              cwd=here)
             for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [err[-2000:] for _, err in outs]
    digests = {out.strip() for out, _ in outs}
    assert len(digests) == 1, digests


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "two_pass"])
def test_bwd_forms_match_jax(fused):
    """flash_attention_bwd on the same saved statistics, each form against
    the JAX package's same form, over the GQA fold with window and softcap."""
    q, k, v, do, _, kw, dt = _case_inputs(CASES[3], seed=3)
    o, l, m = tflash.flash_attention(*(torch.tensor(x) for x in (q, k, v)), save_residuals=True,
                                     dropout_rate=RATE, dropout_seed=SEED, **kw)
    lse = (m + torch.log(l)).numpy()
    want = jbwd.flash_attention_bwd(
        *(jnp.asarray(x) for x in (q, k, v, o.numpy(), lse, do)), block_sizes=JBLOCKS,
        precision="float32", interpret=True, fused=fused, dropout_rate=RATE, dropout_seed=SEED,
        **kw)
    got = tbwd.flash_attention_bwd(*(torch.tensor(x) for x in (q, k, v, o.numpy(), lse, do)),
                                   fused=fused, dropout_rate=RATE, dropout_seed=SEED, **kw)
    for name, g_, w in zip(("dq", "dk", "dv"), got, want):
        validate_result(g_, np.asarray(w), GRAD_TOL["float32"], name=name)


def test_ragged_gqa_attention_matches_jax():
    """attention() with G = 2 and S_q = 200: the JAX package pads each group
    to 256 rows, so the second group draws rows 256-455; the port passes
    that stride to the kernels.  Forward and gradients under autograd."""
    rng = np.random.default_rng(9)
    b, hkv, g, s, d = 1, 2, 2, 200, 32
    q = _rand(rng, (b, hkv * g, s, d), "float32")
    k, v = _rand(rng, (b, hkv, s, d), "float32"), _rand(rng, (b, hkv, s, d), "float32")
    do = _rand(rng, (b, hkv * g, s, d), "float32")
    kw = dict(causal=True, scale=d**-0.5, dropout_rate=0.3, dropout_seed=-77)

    def j_loss(q, k, v):
        o = fj.attention(q, k, v, precision="float32", interpret=True, **kw)
        return jnp.sum(o * do), o

    (_, jo), jgrads = jax.value_and_grad(j_loss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(x) for x in (q, k, v)))
    targs = [torch.tensor(x).requires_grad_() for x in (q, k, v)]
    to = ft.attention(*targs, **kw)
    validate_result(to, np.asarray(jo), FWD_TOL["float32"], name="o")
    for name, g_, w in zip(("dq", "dk", "dv"), torch.autograd.grad(to, targs, torch.tensor(do)),
                           jgrads):
        validate_result(g_, np.asarray(w), GRAD_TOL["float32"], name=name)


def test_rate_zero_is_identity():
    rng = np.random.default_rng(1)
    q, k, v = (torch.tensor(_rand(rng, (2, 64, 32), "float32")) for _ in range(3))
    for rate in (0.0, None):
        o = tflash.flash_attention(q, k, v, causal=True, dropout_rate=rate, dropout_seed=5)
        torch.testing.assert_close(o, tflash.flash_attention(q, k, v, causal=True), rtol=0, atol=0)


@pytest.mark.parametrize("packed", [False, True], ids=["plain", "packed"])
def test_dropout_train_step_matches_jax(packed):
    """Three steps with attn_dropout=0.1 and seed = step index: losses and
    updated parameters against the JAX steps on a 1x1 mesh."""
    cfg, mesh, jparams, raw = _jax_model()
    tparams = _port_params(raw)
    tcfg = ttransformer.ModelConfig(**FIELDS)
    sharding = NamedSharding(mesh, P("dp", None))
    args = _packed_rows(2)[1] if packed else (_tokens(1),)
    jargs = [jax.device_put(jnp.asarray(x), sharding) for x in args]
    targs = [torch.tensor(x) for x in args]
    make_j = j_make_train_step_packed if packed else j_make_train_step
    make_t = make_train_step_packed if packed else make_train_step
    jstep = make_j(mesh, cfg, lr=LR, attn_dropout=0.1)
    tstep = make_t(tcfg, lr=LR, attn_dropout=0.1, device="cpu")
    j_losses, t_losses = [], []
    for step in range(STEPS):
        loss, jparams = jstep(jparams, *jargs, step)
        j_losses.append(float(loss))
        loss, tparams = tstep(tparams, *targs, step)
        t_losses.append(float(loss))
    _check_same(j_losses, t_losses, jparams, tparams)
    # ... and the dropout moved the losses from the undropped step's.
    cfg_params = _port_params(raw)
    plain = make_t(tcfg, lr=LR, device="cpu")(cfg_params, *targs)[0]
    assert abs(float(plain) - t_losses[0]) > 1e-4


@pytest.mark.parametrize("packed", [False, True], ids=["plain", "packed"])
def test_dropout_remat_is_bitwise_no_remat(packed):
    """A recomputed layer draws the same keep bits: remat changes nothing.
    Deterministic algorithms fix the order in which the embedding's backward
    adds the rows of repeated tokens (on the CPU it may vary between runs,
    remat or not)."""
    cfg = ttransformer.ModelConfig(**FIELDS)
    args = _packed_rows(4)[1] if packed else (_tokens(3),)
    args = [torch.tensor(x) for x in args]
    results = []
    torch.use_deterministic_algorithms(True)
    try:
        for remat in (False, True):
            params = ttransformer.init_params(0, cfg, device="cpu")
            make = make_train_step_packed if packed else make_train_step
            step = make(cfg, lr=LR, remat=remat, attn_dropout=0.1, device="cpu")
            losses = [step(params, *args, seed)[0] for seed in (11, 12)]
            results.append((losses, leaves(params)))
    finally:
        torch.use_deterministic_algorithms(False)
    (l0, p0), (l1, p1) = results
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
