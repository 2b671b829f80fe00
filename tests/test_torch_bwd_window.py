"""Sliding window, logit softcap and head_dim 16 / 256 in the backward: the
port against the JAX package.

The same numpy inputs go through the JAX function (its Pallas kernels in
interpret mode on the CPU, ``precision="float32"`` for the fp32 cases) and
its port (on CPU tensors, the plain version of each backward kernel):
``flash_attention_bwd`` fused and two-pass, ``attention_vjp`` and the public
``attention`` under autograd.  Cases: the window alone, the softcap alone,
both; the GQA fold; segment ids; a window shorter than the CUDA kernels'
32-row tile and one that crosses tile edges; queries at an offset into a
longer KV sequence with a live length; head_dim 16 and 256; q scaled by 8
so that the scores reach the cap (and dO scaled down with it, so that the
gradients stay of order 1).  Tolerances: ``tests/test_torch_backward.py``'s,
5e-4 for float32 gradients and 2e-2 in bfloat16.
"""

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
from flashattention_tpu_torch.utils.packing import PAD_SEGMENT
from flashattention_tpu_torch.utils.testing import to_numpy, validate_result

torch.set_num_threads(2)

GRAD_TOL = {"float32": 5e-4, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JBLOCKS = jflash.BlockSizes(128, 128, 128)  # the JAX kernels' tile; S is a multiple


def _rand(rng, shape, dt, mult=1.0):
    """A float32 numpy array (times ``mult``) rounded to ``dt``, so both
    sides see the same values."""
    x = rng.standard_normal(shape).astype(np.float32) * np.float32(mult)
    return to_numpy(torch.tensor(x).to(TDT[dt]).float())


def _segments(bh, s, g):
    """Documents of 70 and 40 tokens in row 0, one of 100 in the others,
    PAD_SEGMENT to the end: folded q ids ``(BH, G*S)``, KV ids ``(BH, S)``."""
    ids = np.full((bh, s), PAD_SEGMENT, np.int32)
    ids[:, :100] = 0
    ids[0, 70:110] = 1
    return np.tile(ids, (1, g)), ids


# (name, BH, G, S_q per group, S_kv, d, window, softcap, q scale, kv_len,
#  q_offset, segments, dtype)
CASES = [
    ("window_short", 2, 1, 128, 128, 32, 24, None, 1.0, None, 0, False, "float32"),
    ("softcap_reached", 2, 1, 128, 128, 32, None, 20.0, 8.0, None, 0, False, "float32"),
    ("both_gqa", 2, 2, 128, 128, 32, 100, 30.0, 1.0, None, 0, False, "float32"),
    ("both_gqa_reached", 2, 2, 128, 128, 64, 40, 30.0, 8.0, None, 0, False, "float32"),
    ("segments_window", 2, 2, 128, 128, 32, 40, 30.0, 1.0, None, 0, True, "float32"),
    ("kv_len_q_offset_window", 2, 1, 128, 256, 32, 64, 15.0, 1.0, 200, 100, False, "float32"),
    ("d16", 2, 2, 128, 128, 16, 24, 20.0, 8.0, None, 0, False, "float32"),
    ("d256", 1, 2, 128, 128, 256, 50, 50.0, 8.0, None, 0, False, "float32"),
    ("both_gqa_bf16", 2, 2, 128, 128, 64, 40, 30.0, 8.0, None, 0, False, "bfloat16"),
]


def _inputs(case, seed=0):
    _, bh, g, s_q, s_kv, d, window, cap, qmul, kv_len, q_offset, segments, dt = case
    rng = np.random.default_rng(seed)
    q = _rand(rng, (bh, g * s_q, d), dt, qmul)
    k, v = _rand(rng, (bh, s_kv, d), dt), _rand(rng, (bh, s_kv, d), dt)
    do = _rand(rng, (bh, g * s_q, d), dt, 1.0 / qmul)  # gradients of order 1
    kw = dict(causal=True, scale=d**-0.5, kv_len=kv_len, q_offset=q_offset,
              q_seq_len=s_q if g > 1 else None, window=window, logit_softcap=cap)
    seg = _segments(bh, s_q, g) if segments else (None, None)
    # o and lse from the port's plain float32 forward, handed to both sides.
    tseg = [None if x is None else torch.tensor(x) for x in seg]
    o, l, m = tflash.flash_attention_plain(
        *(torch.tensor(x) for x in (q, k, v)), save_residuals=True,
        q_segment_ids=tseg[0], kv_segment_ids=tseg[1], **kw,
    )
    o = to_numpy(o.to(TDT[dt]).float())
    lse = to_numpy(m + torch.log(torch.where(l == 0, 1.0, l)))
    return (q, k, v, o, lse, do), seg, kw, dt


@pytest.mark.parametrize(
    "case,fused",
    [(c, f) for c in CASES for f in (True, False) if not (f and c[11])],
    ids=lambda x: x[0] if isinstance(x, tuple) else ("fused" if x else "two_pass"),
)
def test_flash_attention_bwd_window_softcap_matches_jax(case, fused):
    arrays, seg, kw, dt = _inputs(case)
    jargs = [jnp.asarray(x, JDT[dt]) for x in arrays]
    jargs[4] = jnp.asarray(arrays[4], jnp.float32)  # lse stays float32
    jseg = [None if x is None else jnp.asarray(x) for x in seg]
    want = jbwd.flash_attention_bwd(
        *jargs, block_sizes=JBLOCKS, fused=fused, q_segment_ids=jseg[0], kv_segment_ids=jseg[1],
        precision="float32" if dt == "float32" else None, **kw,
    )
    targs = [torch.tensor(x).to(TDT[dt]) for x in arrays]
    targs[4] = torch.tensor(arrays[4])
    tseg = [None if x is None else torch.tensor(x) for x in seg]
    got = tbwd.flash_attention_bwd(
        *targs, fused=fused, q_segment_ids=tseg[0], kv_segment_ids=tseg[1], **kw
    )
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == TDT[dt]
        validate_result(a, np.asarray(b, np.float32), GRAD_TOL[dt], name=name)


@pytest.mark.parametrize("case", [CASES[3], CASES[4], CASES[7]], ids=lambda c: c[0])
def test_attention_vjp_window_softcap_grads_match_jax(case):
    """Gradients of sum(o * t) through each package's differentiable op: the
    forward saves the capped, windowed lse that the backward reads."""
    (q, k, v, _, _, t), seg, kw, _ = _inputs(case, seed=1)
    jseg = [None if x is None else jnp.asarray(x) for x in seg]

    def jloss(q, k, v):
        o = jbwd.attention_vjp(
            q, k, v, kw["causal"], kw["scale"], JBLOCKS, "float32", None, kw["q_seq_len"],
            kw["window"], kw["logit_softcap"], None, 0, jseg[0], jseg[1], None, kw["kv_len"],
            kw["q_offset"],
        )
        return jnp.sum(o * t)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    tseg = [None if x is None else torch.tensor(x) for x in seg]
    o = tbwd.attention_vjp(
        tq, tk, tv, kw["causal"], kw["scale"], None, None, None, kw["q_seq_len"],
        kw["window"], kw["logit_softcap"], q_segment_ids=tseg[0], kv_segment_ids=tseg[1],
        kv_len=kw["kv_len"], q_offset=kw["q_offset"],
    )
    got = torch.autograd.grad((o * torch.tensor(t)).sum(), (tq, tk, tv))
    for name, a, b in zip("qkv", got, want):
        validate_result(a, np.asarray(b), GRAD_TOL["float32"], name=f"d{name}")


# (B, H, KVH, S, d, window, softcap): head_dim 16 plain (what the backward
# took no head_dim of before), with a window, and Gemma-2's d = 256 with both.
ATTN_CASES = [
    (2, 4, 2, 128, 16, None, None),
    (1, 4, 2, 128, 16, 24, 20.0),
    (1, 2, 1, 128, 256, 40, 50.0),
]


@pytest.mark.parametrize("case", ATTN_CASES, ids=lambda c: "-".join(map(str, c)))
def test_attention_autograd_matches_jax(case):
    """``attention()`` under autograd (4D GQA, the dispatch's fold) against
    ``jax.grad`` of the JAX package's ``attention``."""
    b, h, hkv, s, d, window, cap = case
    rng = np.random.default_rng(s + d)
    q, k, v, t = (rng.standard_normal(shape).astype(np.float32) * mult for shape, mult in (
        ((b, h, s, d), 4.0), ((b, hkv, s, d), 1.0), ((b, hkv, s, d), 1.0), ((b, h, s, d), 0.25)))
    kw = dict(causal=True, scale=d**-0.5, window=window, logit_softcap=cap)

    def jloss(q, k, v):
        return jnp.sum(fj.attention(q, k, v, precision="float32", **kw) * t)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    o = ft.attention(tq, tk, tv, **kw)
    assert o.grad_fn is not None
    got = torch.autograd.grad((o * torch.tensor(t)).sum(), (tq, tk, tv))
    for name, a, w in zip("qkv", got, want):
        validate_result(a, np.asarray(w), GRAD_TOL["float32"], name=f"d{name}")


def test_backward_checks_window_options():
    """A window needs causal masking and a softcap must be positive, in the
    backward's entry points as in the forward's."""
    x = torch.zeros(1, 8, 32)
    lse = torch.zeros(1, 8)
    with pytest.raises(ValueError, match="causal"):
        tbwd.flash_attention_bwd(x, x, x, x, lse, x, window=4)
    with pytest.raises(ValueError, match="softcap"):
        tbwd.flash_attention_bwd(x, x, x, x, lse, x, causal=True, logit_softcap=0.0)
    with pytest.raises(ValueError, match="causal"):
        tbwd.attention_vjp(x, x, x, False, 1.0, window=4)
    with pytest.raises(ValueError, match="causal"):
        tbwd.dq_kernel(x, x, x, x, lse, lse, window=4)
