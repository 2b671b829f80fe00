"""The JAX precision modes in the port's float32 fused backward and in its
float32 forward with dropout.

The JAX package resolves ``precision`` for float32 inputs to ``"bf16_3x"``
by default (``flashattention_tpu/ops/flash.py:119-134``), and its fused
backward (``ops/backward.py::_fused_bwd_kernel``) computes each of its five
products (S = Q K^T, dP = dO V^T, dV += Z^T dO, dK += dS^T Q, dQ += dS K) as
``_dot_g`` does: both operands split into bf16 hi + lo, ``hi hi + hi lo +
lo hi`` summed in float32 (flash.py:149-181).  The port's fused backward
computes the same in its float32 form (``kernel_form`` ``"tc_f32"``,
``csrc/flash_bwd_tc.cu`` built with ``-DFA_F32``) at head_dim 64, 128 and
256; on the CPU its plain version mirrors that form.  Its float32 forward
with dropout at head_dim 64 and 128 (``flash_fwd_tc_f32_extra``) drops P before its
two terms meet V's, as the Pallas forward does.

Here, with numpy inputs from a seed, against the JAX functions in interpret
mode: the routes; the fused backward in ``"bf16_3x"`` and ``"bf16"`` over
causal rows, the GQA fold, kv_len with q_offset, a window with a softcap
and dropout, both fed the same o and lse; the forward's dropout form; and
float32 gradients of ``attention()`` under autograd against ``jax.grad``.

Tolerances, of each gradient's magnitude.  ``"bf16_3x"`` drops the lo lo
product, about 2^-17 of each product, and summed over a row that moves a
gradient by 5.8e-6 to 2e-5 of its norm from exact float32.  Two correct
``"bf16_3x"`` implementations part less: their float32 sums run in other
orders (about 1e-6 of the norm), and where an ulp of P or dS differs
between them the bf16 rounding of its lo term can fall the other way,
which moves that one product by 2^-16 of it (measured over 36 seeded draws
of these shapes: up to 2.0e-6 of the norm, and one element up to 1.1e-5 of
the largest magnitude).  So the mode is held on the norm: the port within
5e-6 of JAX's "bf16_3x" in ``||got - want|| / ||want||``, and the exact
route outside that bound on the same inputs; each element within 2e-5 of
the gradient's largest magnitude.  ``"bf16"`` (one bf16 product; JAX's
interpret mode computes its DEFAULT products in float32 on the CPU) within
2e-2 of the largest magnitude.  The forward within 1e-4 absolutely
(``tests/test_torch_precision.py``'s gate), 2e-2 in ``"bf16"``.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flashattention_tpu as fj
import flashattention_tpu_torch as ft
from flashattention_tpu.ops import backward as jbwd
from flashattention_tpu.ops import flash as jflash
from flashattention_tpu_torch.ops import backward as tbwd
from flashattention_tpu_torch.ops import flash as tflash
from flashattention_tpu_torch.utils.testing import validate_result

torch.set_num_threads(2)

JBLOCKS = jflash.BlockSizes(128, 128, 128)
NORM_TOL = 5e-6  # "bf16_3x": ||got - want|| / ||want||, per gradient
ELEM_TOL = 2e-5  # "bf16_3x": max |got - want| / max |want|, per gradient
BF16_TOL = 2e-2  # "bf16": max |got - want| / max |want|
FWD_TOL = {"bf16_3x": 1e-4, "bf16": 2e-2}
SEED = 1234

# (BH, G, S_q per group, S_kv, kwargs): folded q (BH, G S_q, d)
CASES = {
    "causal": (2, 1, 256, 256, dict(causal=True)),
    "gqa_fold": (2, 2, 128, 128, dict(causal=True)),
    "kv_len_q_offset": (2, 1, 128, 256, dict(causal=True, kv_len=200, q_offset=100)),
    "window_softcap": (2, 1, 256, 256, dict(causal=True, window=100, logit_softcap=5.0)),
    "dropout": (2, 1, 256, 256, dict(causal=True, dropout_rate=0.1, dropout_seed=SEED)),
}


def _case(case, d, seed=0):
    """numpy q, k, v, dO of a case and its keywords (``q_seq_len`` with
    the GQA fold)."""
    bh, g, s_q, s_kv, kw = CASES[case]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((bh, g * s_q, d)).astype(np.float32)
    k, v = (rng.standard_normal((bh, s_kv, d)).astype(np.float32) for _ in range(2))
    do = rng.standard_normal(q.shape).astype(np.float32)
    kw = dict(kw, scale=d**-0.5)
    if g > 1:
        kw["q_seq_len"] = s_q
    return q, k, v, do, kw


def _rel(got, want):
    """(norm, elementwise) error of ``got`` against ``want``, each over
    ``want``'s: ``||got - want|| / ||want||``, ``max |got - want| / max
    |want|``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    diff = got - want
    return (float(np.linalg.norm(diff) / np.linalg.norm(want)),
            float(np.abs(diff).max() / np.abs(want).max()))


@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
def test_routes(d):
    """The fused backward's float32 form and the two-pass pair's
    (tests/test_torch_pair_f32.py) at d = 64, 128 and 256 in "bf16_3x" (the
    default) and "bf16", dropout or not; "float32", the other head_dims and
    scalar_forms keep the exact scalar kernels.  The forward with dropout
    takes its float32 form at d = 64 and 128."""
    f32 = torch.float32
    q = torch.zeros(1, 8, d)
    for mode in (None, "auto", *tflash.PRECISIONS):
        want = "tc_f32" if d in (64, 128, 256) and mode != "float32" else "scalar"
        assert tflash.kernel_form("flash_bwd", f32, d, precision=mode) == want, mode
        assert tflash.kernel_form("flash_bwd", f32, d, precision=mode, dropout=True) == want
        assert tbwd.bwd_form(q, True, precision=mode) == want
        fwd = "tc_f32" if d in (64, 128) and mode != "float32" else "scalar"
        assert tflash.kernel_form("flash_fwd", f32, d, precision=mode, dropout=True) == fwd
        assert tbwd.bwd_form(q, False, precision=mode) == want
        assert tflash.kernel_form("flash_fwd", f32, d, precision=mode, dropout=True,
                                  block_mask=True) == "scalar"
        with tflash.scalar_forms():
            assert tbwd.bwd_form(q, True, precision=mode) == "scalar"
            assert tbwd.bwd_form(q, False, precision=mode) == "scalar"
            assert tflash.kernel_form("flash_fwd", f32, d, precision=mode,
                                      dropout=True) == "scalar"
    with pytest.raises(ValueError, match="precision"):
        tbwd.flash_attention_bwd(*[torch.zeros(1, 8, d)] * 4, torch.zeros(1, 8),
                                 torch.zeros(1, 8, d), precision="fp16")


def _bwd(case, d, mode):
    """The port's fused backward in ``mode``, its exact route
    (``precision="float32"``) and the JAX fused backward in ``mode``
    (interpret mode), from the same o and lse (the port's exact plain
    forward): ``(got, exact, want)``, numpy."""
    q, k, v, do, kw = _case(case, d)
    o, l, m = tflash.flash_attention_plain(*map(torch.tensor, (q, k, v)), save_residuals=True,
                                           form="scalar", **kw)
    lse = (m + torch.log(torch.where(l == 0, 1.0, l))).numpy()
    arrays = (q, k, v, o.numpy(), lse, do)
    want = jbwd.flash_attention_bwd(*map(jnp.asarray, arrays), block_sizes=JBLOCKS,
                                    precision=mode, interpret=True, fused=True, **kw)
    t = [torch.tensor(x) for x in arrays]
    got = tbwd.flash_attention_bwd(*t, fused=True, precision=mode, **kw)
    exact = tbwd.flash_attention_bwd(*t, fused=True, precision="float32", **kw)
    return ([x.numpy() for x in got], [x.numpy() for x in exact],
            [np.asarray(x, np.float32) for x in want])


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("case", list(CASES))
def test_bf16_3x_backward_matches_jax(d, case):
    """Each gradient within NORM_TOL of JAX's "bf16_3x" in norm and
    ELEM_TOL elementwise; the exact route misses NORM_TOL, so the test
    fails a backward that does not compute the mode."""
    assert tbwd.bwd_form(torch.zeros(1, 8, d), True) == "tc_f32"
    got, exact, want = _bwd(case, d, "bf16_3x")
    for name, a, e, w in zip(("dq", "dk", "dv"), got, exact, want):
        (norm, elem), (exact_norm, _) = _rel(a, w), _rel(e, w)
        print(f"d={d} {case} {name}: bf16_3x {norm:.3g} (max {elem:.3g}), exact {exact_norm:.3g}")
        assert a.dtype == np.float32
        assert norm <= NORM_TOL, name
        assert elem <= ELEM_TOL, name
        assert exact_norm > NORM_TOL, name


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("case", list(CASES))
def test_bf16_backward_matches_jax(d, case):
    """The one-pass "bf16" mode (q, k, v and dO rounded to bf16 once)
    within BF16_TOL of JAX's, and not the exact route."""
    got, exact, want = _bwd(case, d, "bf16")
    for name, a, e, w in zip(("dq", "dk", "dv"), got, exact, want):
        _, elem = _rel(a, w)
        print(f"d={d} {case} {name}: bf16 {elem:.3g}")
        assert elem <= BF16_TOL, name
        assert _rel(a, e)[1] > 1e-4, name


@pytest.mark.parametrize("d,mode", list(itertools.product([64, 128], ["bf16_3x", "bf16"])))
def test_dropout_forward_matches_jax(d, mode):
    """The float32 forward with dropout 0.1 (and its residuals), the GQA
    fold included, against the JAX forward in interpret mode with the same
    seed: FWD_TOL absolutely; l and m within 1e-5 of their magnitude
    (bf16: 2e-2)."""
    q, k, v, _, kw = _case("gqa_fold", d, seed=1)
    kw = dict(kw, dropout_rate=0.1, dropout_seed=SEED)
    assert tflash.kernel_form("flash_fwd", torch.float32, d, dropout=True,
                              precision=mode) == "tc_f32"
    want = jflash.flash_attention(*map(jnp.asarray, (q, k, v)), precision=mode, interpret=True,
                                  block_sizes=JBLOCKS, save_residuals=True, **kw)
    got = tflash.flash_attention(*map(torch.tensor, (q, k, v)), precision=mode,
                                 save_residuals=True, **kw)
    rtol = 2e-2 if mode == "bf16" else 1e-5
    for name, a, b in zip(("l", "m"), got[1:], want[1:]):
        b = np.asarray(b).reshape(a.shape)
        validate_result(a, b, rtol * float(np.abs(b).max()), name=name)
    undropped = tflash.flash_attention(*map(torch.tensor, (q, k, v)), precision=mode,
                                       **{n: x for n, x in kw.items() if "dropout" not in n})
    e = float((got[0] - torch.tensor(np.asarray(want[0]))).abs().max())
    print(f"d={d} {mode}: max abs err vs JAX {e:.3g}")
    validate_result(got[0], np.asarray(want[0]), FWD_TOL[mode], name="o")
    assert float((got[0] - undropped).abs().max()) > 0.05  # the dropout ran


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dropout", [None, 0.1], ids=["plain", "dropout"])
def test_attention_grads_match_jax_default(d, dropout):
    """float32 GQA attention() under autograd at the default precision
    (the float32 forms both ways) against ``jax.grad`` through the JAX
    attention at its default "bf16_3x": each gradient within NORM_TOL in
    norm and ELEM_TOL elementwise."""
    rng = np.random.default_rng(5 + d)
    q = rng.standard_normal((1, 4, 128, d)).astype(np.float32)
    k, v = (rng.standard_normal((1, 2, 128, d)).astype(np.float32) for _ in range(2))
    t = rng.standard_normal(q.shape).astype(np.float32)
    kw = dict(causal=True, scale=d**-0.5)
    if dropout:
        kw.update(dropout_rate=dropout, dropout_seed=SEED)

    def loss(q, k, v):
        return jnp.sum(fj.attention(q, k, v, interpret=True, block_sizes=JBLOCKS, **kw) * t)

    jgrads = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk_, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    (ft.attention(tq, tk_, tv, **kw) * torch.tensor(t)).sum().backward()
    for name, a, b in zip(("dq", "dk", "dv"), (tq.grad, tk_.grad, tv.grad), jgrads):
        norm, elem = _rel(a.numpy(), b)
        print(f"d={d} dropout={dropout} {name}: {norm:.3g} (max {elem:.3g})")
        assert norm <= NORM_TOL, name
        assert elem <= ELEM_TOL, name
