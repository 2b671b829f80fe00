"""Differential tests of the port's backward and segment-id forward against
the JAX package.

The same inputs, made from a seed with numpy, go through the JAX function
(Pallas kernels in interpret mode on the CPU, ``precision="float32"`` for the
fp32 cases) and through its ``flashattention_tpu_torch`` counterpart, which
on CPU tensors runs the plain PyTorch version of each CUDA kernel.
Tolerances: 5e-4 in float32 for gradients (``tests/test_backward.py``'s own
accumulation tolerance), 1e-4 for float32 forward outputs, 2e-2 in bfloat16.
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
from flashattention_tpu_torch.ops import reference as tref
from flashattention_tpu_torch.utils.packing import PAD_SEGMENT
from flashattention_tpu_torch.utils.testing import to_numpy, validate_result

torch.set_num_threads(2)

GRAD_TOL = {"float32": 5e-4, "bfloat16": 2e-2}
FWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JBLOCKS = jflash.BlockSizes(128, 128, 128)  # the JAX kernels' tile; S is a multiple


def _rand(rng, shape, dt):
    """A float32 numpy array rounded to ``dt``, so both sides see the same values."""
    x = rng.standard_normal(shape).astype(np.float32)
    return to_numpy(torch.tensor(x).to(TDT[dt]).float())


def _segments(bh, s, g):
    """Per-row segment ids: documents of 40, 60 and 20 tokens in row 0, one of
    100 in the others, and PAD_SEGMENT padding to the end.  Returns the
    folded q ids ``(BH, G*S)`` and KV ids ``(BH, S)``."""
    ids = np.full((bh, s), PAD_SEGMENT, np.int32)
    ids[:, :100] = 0
    ids[0, 40:100], ids[0, 100:120] = 1, 2
    return np.tile(ids, (1, g)), ids


# (name, BH, G, S_q per group, S_kv, d, causal, kv_len, q_offset, segments, dtype)
BWD_CASES = [
    ("full", 2, 1, 256, 256, 64, False, None, 0, False, "float32"),
    ("causal", 2, 1, 256, 256, 64, True, None, 0, False, "float32"),
    ("gqa_fold", 2, 2, 128, 128, 32, True, None, 0, False, "float32"),
    ("kv_len_q_offset", 2, 1, 128, 256, 32, True, 200, 100, False, "float32"),
    ("segments_pad", 2, 2, 128, 128, 32, True, None, 0, True, "float32"),
    ("causal_bf16", 2, 1, 128, 128, 64, True, None, 0, False, "bfloat16"),
]


def _bwd_inputs(case, seed=0):
    _, bh, g, s_q, s_kv, d, causal, kv_len, q_offset, segments, dt = case
    rng = np.random.default_rng(seed)
    q = _rand(rng, (bh, g * s_q, d), dt)
    k, v = _rand(rng, (bh, s_kv, d), dt), _rand(rng, (bh, s_kv, d), dt)
    do = _rand(rng, (bh, g * s_q, d), dt)
    kw = dict(causal=causal, scale=d**-0.5, kv_len=kv_len, q_offset=q_offset,
              q_seq_len=s_q if g > 1 else None)
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


# Segment ids take the two-pass kernels in both packages.
@pytest.mark.parametrize(
    "case,fused",
    [(c, f) for c in BWD_CASES for f in (True, False) if not (f and c[9])],
    ids=lambda x: x[0] if isinstance(x, tuple) else ("fused" if x else "two_pass"),
)
def test_flash_attention_bwd_matches_jax(case, fused):
    arrays, seg, kw, dt = _bwd_inputs(case)
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


def test_fused_with_segment_ids_raises():
    arrays, seg, kw, _ = _bwd_inputs(BWD_CASES[4])
    t = [torch.tensor(x) for x in arrays]
    with pytest.raises(ValueError, match="fused"):
        tbwd.flash_attention_bwd(*t, fused=True, q_segment_ids=torch.tensor(seg[0]),
                                 kv_segment_ids=torch.tensor(seg[1]), **kw)
    with pytest.raises(ValueError, match="together"):
        tbwd.flash_attention_bwd(*t, q_segment_ids=torch.tensor(seg[0]), **kw)


@pytest.mark.parametrize("case", [BWD_CASES[2], BWD_CASES[4]], ids=lambda c: c[0])
def test_attention_vjp_grads_match_jax(case):
    """Gradients of sum(o * t) through each package's differentiable op."""
    (q, k, v, _, _, t), seg, kw, _ = _bwd_inputs(case, seed=1)
    jseg = [None if x is None else jnp.asarray(x) for x in seg]

    def jloss(q, k, v):
        o = jbwd.attention_vjp(
            q, k, v, kw["causal"], kw["scale"], JBLOCKS, "float32", None, kw["q_seq_len"],
            None, None, None, 0, jseg[0], jseg[1], None, kw["kv_len"], kw["q_offset"],
        )
        return jnp.sum(o * t)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    tseg = [None if x is None else torch.tensor(x) for x in seg]
    o = tbwd.attention_vjp(
        tq, tk, tv, kw["causal"], kw["scale"], None, None, None, kw["q_seq_len"],
        q_segment_ids=tseg[0], kv_segment_ids=tseg[1], kv_len=kw["kv_len"],
        q_offset=kw["q_offset"],
    )
    got = torch.autograd.grad((o * torch.tensor(t)).sum(), (tq, tk, tv))
    for name, a, b in zip("qkv", got, want):
        validate_result(a, np.asarray(b), GRAD_TOL["float32"], name=f"d{name}")


@pytest.mark.parametrize(
    "b,h,hkv,s_q,s_kv", [(2, 4, 2, 40, 40), (1, 2, 2, 24, 57), (2, 2, 1, 33, 33)],
    ids=["gqa", "suffix_aligned", "ragged_gqa"],
)
def test_autograd_through_attention_matches_reference_autograd(b, h, hkv, s_q, s_kv):
    """torch.autograd through the public attention() (the kernels' plain
    versions behind attention_vjp) against autograd of the dense oracle."""
    rng = np.random.default_rng(2)
    d = 32
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((b, h, s_q, d), (b, hkv, s_kv, d), (b, hkv, s_kv, d), (b, h, s_q, d))]
    q, k, v = (torch.tensor(x, requires_grad=True) for x in arrays[:3])
    t = torch.tensor(arrays[3])
    o = ft.attention(q, k, v, causal=True, scale=d**-0.5)
    got = torch.autograd.grad((o * t).sum(), (q, k, v))
    g = h // hkv
    ref = tref.attention_reference(
        q, k.repeat_interleave(g, 1), v.repeat_interleave(g, 1), causal=True,
        scale=d**-0.5, q_offset=s_kv - s_q,
    )
    want = torch.autograd.grad((ref * t).sum(), (q, k, v))
    for name, a, w in zip("qkv", got, want):
        validate_result(a, w, 1e-4, name=f"d{name}")


def test_attention_without_grad_takes_the_forward_kernel_only():
    """Outside autograd the dispatch calls the forward directly (no
    residuals), as the JAX custom_vjp runs its primal."""
    x = torch.zeros(1, 2, 8, 32)
    o = ft.attention(x, x, x, causal=True)
    assert o.grad_fn is None
    xg = x.clone().requires_grad_()
    assert ft.attention(xg, xg, xg, causal=True).grad_fn is not None
    with torch.no_grad():
        assert ft.attention(xg, xg, xg, causal=True).grad_fn is None


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_forward_segment_ids_match_jax(dt):
    """The folded forward with segment ids and a GQA fold, residuals too."""
    rng = np.random.default_rng(3)
    bh, g, s, d = 2, 2, 128, 32
    q = _rand(rng, (bh, g * s, d), dt)
    k, v = _rand(rng, (bh, s, d), dt), _rand(rng, (bh, s, d), dt)
    seg_q, seg_kv = _segments(bh, s, g)
    kw = dict(causal=True, scale=d**-0.5, q_seq_len=s, save_residuals=True)
    want = jflash.flash_attention(
        *(jnp.asarray(x, JDT[dt]) for x in (q, k, v)), q_segment_ids=jnp.asarray(seg_q),
        kv_segment_ids=jnp.asarray(seg_kv), precision="float32" if dt == "float32" else None,
        block_sizes=JBLOCKS, **kw,
    )
    got = tflash.flash_attention(
        *(torch.tensor(x).to(TDT[dt]) for x in (q, k, v)), q_segment_ids=torch.tensor(seg_q),
        kv_segment_ids=torch.tensor(seg_kv), **kw,
    )
    validate_result(got[0], np.asarray(want[0], np.float32), FWD_TOL[dt])
    # m is the row max of the scaled scores; l sums exp(s - m) over visible
    # columns (each package may add masked columns' exp(mask - m) = 0).
    validate_result(got[2], np.asarray(want[2]), 1e-4, name="m")
    validate_result(got[1], np.asarray(want[1]), 1e-3, name="l")


def test_dispatch_segment_ids_match_jax():
    """4D GQA through the public attention(): (B, S) ids broadcast over
    heads and, on the q side, over the folded groups (g-major)."""
    rng = np.random.default_rng(4)
    b, h, hkv, s, d = 2, 4, 2, 100, 32
    q = rng.standard_normal((b, h, s, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, hkv, s, d)).astype(np.float32) for _ in range(2))
    ids = np.zeros((b, s), np.int32)
    ids[0, 30:80], ids[0, 80:] = 1, PAD_SEGMENT
    ids[1, 60:] = 1
    want = fj.attention(
        *(jnp.asarray(x) for x in (q, k, v)), causal=True, scale=d**-0.5, precision="float32",
        q_segment_ids=jnp.asarray(ids), kv_segment_ids=jnp.asarray(ids),
    )
    tid = torch.tensor(ids)
    got = ft.attention(*(torch.tensor(x) for x in (q, k, v)), causal=True, scale=d**-0.5,
                       q_segment_ids=tid, kv_segment_ids=tid)
    validate_result(got, np.asarray(want), 1e-4)
    with pytest.raises(NotImplementedError, match="xla"):
        ft.attention(*(torch.tensor(x) for x in (q, k, v)), causal=True, implementation="xla",
                     q_segment_ids=tid, kv_segment_ids=tid)
