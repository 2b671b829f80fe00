"""The JAX precision ladder in the port's float32 forward.

The JAX package resolves ``precision`` for float32 inputs to ``"bf16_3x"``
by default (``flashattention_tpu/ops/flash.py:119-133``): each operand split
into bf16 hi + lo, S the sum of hi hi, hi lo and lo hi in float32 (all four
products at d <= 64, where it streams ``[hi | lo]`` pairs, :1433-1441), P's
two terms against V's; ``"bf16"`` is one pass, ``"float32"`` exact.  The
port's flash forward computes the same modes in its float32 tensor-core form
(``kernel_form`` ``"tc_f32"``, ``csrc/flash_fwd_tc.cu`` built with
``-DFA_F32``) at head_dims 64 and 128; on the CPU its plain version mirrors
that form's rounding.  Here, with numpy inputs from a seed: the resolution
and the form for every mode, dtype and 8-bit K/V against JAX's resolution;
``flash_attention`` at d = 64 and 128 in every mode against the JAX kernel
in interpret mode (1e-4 for ``"bf16_3x"`` and ``"float32"``, 2e-2 for
``"bf16"``), over causal masking, the GQA row fold with kv_len / q_offset, a
window with a softcap, segment ids and the residuals; the default within
1e-4 of exact float32 but not equal to it; on ``probes.lo_term_f32_qkv``'s
inputs, copies of the form with one cross product or one second term
dropped missing by far more than 1e-4; and float32 gradients of
``attention()`` under autograd against ``jax.grad`` at the default
precision within the self-test's 5e-4.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flashattention_tpu as fj
import flashattention_tpu_torch as ft
from flashattention_tpu.ops import flash as jflash
from flashattention_tpu_torch.ops import flash as tflash
from flashattention_tpu_torch.ops import probes
from flashattention_tpu_torch.utils.testing import validate_result

torch.set_num_threads(2)

MODES = (None, "auto", "bf16", "bf16_3x", "float32")
MODE_TOL = {"bf16_3x": 1e-4, "float32": 1e-4, "bf16": 2e-2}
GRAD_TOL = 5e-4  # utils/selftest.py's gradient tolerance
JBLOCKS = jflash.BlockSizes(128, 128, 128)


def _jax_mode(mode, dtype, quantized):
    """The mode the JAX flash_attention computes: its wrapper's one-pass
    default over 8-bit K/V (flash.py:1352-1360), then resolve_precision."""
    if quantized and mode in (None, "auto"):
        mode = "bf16"
    return jflash.resolve_precision(mode, dtype)


@pytest.mark.parametrize("mode,quantized", list(itertools.product(MODES, (False, True))),
                         ids=str)
@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
def test_resolution_and_form_follow_jax(mode, quantized, d):
    """float32 q, k, v at d = 64, 128 and 256 take the float32 form in
    every mode, "float32" (XLA's HIGHEST) included; float32 q over 8-bit
    K/V and the other head_dims keep the exact kernel (more exact than
    asked); bf16 inputs resolve to "bf16" and keep their form.  The
    four-product form is where JAX packs, six products are "float32"'s."""
    for tdt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        want = _jax_mode(mode, jdt, quantized)
        if not quantized:
            assert tflash.resolve_precision(mode, tdt) == want
        form = tflash.kernel_form("flash_fwd", tdt, d, quantized=quantized, precision=mode)
        if tdt == torch.bfloat16:
            assert want == "bf16"
            assert form == ("tc" if d in (64, 128, 256) else "scalar")
        elif d in (64, 128, 256) and not quantized:
            assert form == "tc_f32"
        else:
            assert form == "scalar"
    assert (tflash.f32_products(d) == 4) == (2 * d <= jflash.NUM_LANES)
    assert tflash.f32_products(d, "float32") == 6


def test_scalar_forms_and_options_keep_the_exact_kernel():
    """A block mask and scalar_forms keep the exact kernel; dropout and the
    fused backward take their float32 forms in the default mode and keep
    the exact kernel in "float32" (tests/test_torch_bwd_f32.py)."""
    f32 = torch.float32
    assert tflash.kernel_form("flash_fwd", f32, 64, block_mask=True) == "scalar"
    assert tflash.kernel_form("flash_fwd", f32, 64, dropout=True) == "tc_f32"
    assert tflash.kernel_form("flash_fwd", f32, 64, dropout=True, precision="float32") == "scalar"
    assert tflash.kernel_form("flash_bwd", f32, 64) == "tc_f32"
    assert tflash.kernel_form("flash_bwd", f32, 64, precision="float32") == "scalar"
    with tflash.scalar_forms():
        assert tflash.kernel_form("flash_fwd", f32, 128) == "scalar"
    assert tflash.kernel_form("flash_fwd", f32, 128) == "tc_f32"


# (name, G, S, d, kwargs): folded (BH, G * S, d) against (BH, S_kv, d)
CASES = {
    "causal": (1, 256, dict(causal=True)),
    "gqa_kv_len": (2, 128, dict(causal=True, kv_len=200, q_offset=72)),
    "window_softcap": (1, 256, dict(causal=True, window=100, logit_softcap=5.0)),
    "segments": (1, 256, dict(causal=False, segments=True)),
    "residuals": (1, 256, dict(causal=True, save_residuals=True)),
}


def _inputs(seed, g, s, d, s_kv=256):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, g * s, d)).astype(np.float32)
    k, v = (rng.standard_normal((2, s_kv, d)).astype(np.float32) for _ in range(2))
    return q, k, v


def _segments(seed, rows, s_kv):
    rng = np.random.default_rng(seed)
    return (np.sort(rng.integers(0, 3, (2, rows)), -1).astype(np.int32),
            np.sort(rng.integers(0, 3, (2, s_kv)), -1).astype(np.int32))


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("mode", ["bf16_3x", "bf16", "float32"])
@pytest.mark.parametrize("case", list(CASES))
def test_flash_attention_matches_jax_mode(d, mode, case):
    g, s, kw = CASES[case]
    kw = dict(kw, scale=d**-0.5)
    q, k, v = _inputs(1, g, s, d)
    if g > 1:
        kw["q_seq_len"] = s
    if kw.pop("segments", False):
        kw["q_segment_ids"], kw["kv_segment_ids"] = _segments(2, g * s, k.shape[1])
    want = jflash.flash_attention(*map(jnp.asarray, (q, k, v)), precision=mode, interpret=True,
                                  block_sizes=JBLOCKS,
                                  **{n: jnp.asarray(x) if isinstance(x, np.ndarray) else x
                                     for n, x in kw.items()})
    got = tflash.flash_attention(*map(torch.tensor, (q, k, v)), precision=mode,
                                 **{n: torch.tensor(x) if isinstance(x, np.ndarray) else x
                                    for n, x in kw.items()})
    assert tflash.kernel_form("flash_fwd", torch.float32, d, precision=mode) == "tc_f32"
    if kw.get("save_residuals"):  # of their magnitude: 1e-5, and bf16's 2e-2 in "bf16"
        rtol = 2e-2 if mode == "bf16" else 1e-5
        for name, a, b in zip(("l", "m"), got[1:], want[1:]):
            validate_result(a, np.asarray(b).reshape(a.shape), rtol * float(np.abs(b).max()),
                            name=name)
        got, want = got[0], want[0]
    e = float((got - torch.tensor(np.asarray(want))).abs().max())
    print(f"d={d} {mode} {case}: max abs err vs JAX {e:.3g}")
    assert got.dtype == torch.float32
    validate_result(got, np.asarray(want), MODE_TOL[mode])


@pytest.mark.parametrize("d", [64, 128])
def test_default_is_not_exact_float32(d):
    """The default mode really runs: within 1e-4 of exact float32, not
    equal to it."""
    q, k, v = map(torch.tensor, _inputs(3, 1, 256, d))
    got = tflash.flash_attention(q, k, v, causal=True, scale=d**-0.5)
    exact = tflash.flash_attention(q, k, v, causal=True, scale=d**-0.5, precision="float32")
    e = float((got - exact).abs().max())
    print(f"d={d}: bf16_3x against exact float32 {e:.3g}")
    assert 0.0 < e < 1e-4


def _mirror(q, k, v, drop=None):
    """The "bf16_3x" form over one KV tile's worth of keys (every row sees
    at most the tile, so no rescale): S from the terms' products, P's two
    terms against V's; ``drop`` names one product or term left out."""
    d = q.shape[-1]
    (qh, ql), (kh, kl) = tflash._split_bf16(q), tflash._split_bf16(k)
    terms = {"qh_kh": (qh, kh), "qh_kl": (qh, kl), "ql_kh": (ql, kh), "ql_kl": (ql, kl)}
    s = sum(torch.einsum("bqd,bkd->bqk", a, b)
            for name, (a, b) in list(terms.items())[:tflash.f32_products(d)] if name != drop)
    rows, s_kv = s.shape[1:]
    mask = torch.arange(s_kv)[None, :] <= torch.arange(rows)[:, None]
    s = torch.where(mask, s, float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    (ph, pl), (vh, vl) = tflash._split_bf16(p), tflash._split_bf16(v)
    pv = {"ph_vh": (ph, vh), "pl_vh": (pl, vh), "ph_vl": (ph, vl), "pl_vl": (pl, vl)}
    n = tflash.f32_products(d)
    o = sum(torch.einsum("bqk,bkd->bqd", a, b)
            for name, (a, b) in list(pv.items())[:n] if name != drop)
    return o / l


@pytest.mark.parametrize("d", [64, 128])
def test_a_form_missing_a_product_fails_on_lo_term_inputs(d):
    """On ``lo_term_f32_qkv``'s inputs (causal rows of one KV tile) the
    mirror equals the port's plain form, and each copy with one cross
    product of S or PV dropped (q's or k's second term in S, P's or V's in
    PV) misses by more than 5x the 1e-4 gate of the output's magnitude
    (P's second term, the smallest, about 2^-9 of p: 9x at d = 64)."""
    tile = tflash.TC_F32_KV_TILE[d]
    q, k, v = probes.lo_term_f32_qkv(2, tile, d, generator=torch.Generator().manual_seed(4))
    port = tflash.flash_attention(q, k, v, causal=True)
    norm = float(port.abs().max())
    assert float((_mirror(q, k, v) - port).abs().max()) <= 1e-6 * norm
    drops = ["qh_kl", "ql_kh", "pl_vh", "ph_vl"]
    for drop in drops:
        miss = float((_mirror(q, k, v, drop) - port).abs().max()) / norm
        print(f"d={d} without {drop}: {miss:.3g} of the output's magnitude")
        assert miss > 5e-4, drop


def test_attention_grad_matches_jax_default():
    """float32 GQA attention() under autograd at the default precision:
    forward residuals from the float32 form, the backward's float32 form
    (both "bf16_3x"), against ``jax.grad`` through the JAX attention at its
    default ("bf16_3x")."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((1, 4, 128, 64)).astype(np.float32)
    k, v = (rng.standard_normal((1, 2, 128, 64)).astype(np.float32) for _ in range(2))
    t = rng.standard_normal(q.shape).astype(np.float32)

    def loss(q, k, v):
        return jnp.sum(fj.attention(q, k, v, causal=True, scale=0.125, interpret=True,
                                    block_sizes=JBLOCKS) * t)

    jgrads = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk_, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    n = tflash.flash_attention.launches_tc_f32  # on the CPU: the plain version, uncounted
    (ft.attention(tq, tk_, tv, causal=True, scale=0.125) * torch.tensor(t)).sum().backward()
    assert tflash.flash_attention.launches_tc_f32 == n
    for name, a, b in zip(("dq", "dk", "dv"), (tq.grad, tk_.grad, tv.grad), jgrads):
        validate_result(a, np.asarray(b), GRAD_TOL, name=name)
