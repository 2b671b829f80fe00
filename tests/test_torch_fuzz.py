"""Seeded randomized differential sweep of the port's public entry points.

The port of ``tests/test_fuzz.py``: the same configurations (drawn from the
same seeds: shape, dtype, causal, GQA, ragged and cross lengths, window,
softcap, head_dim 32/64/80/128; and the quantized cases' int8/fp8) go
through the port's ``attention`` and ``attention_quantized`` on CPU tensors,
and the JAX package's jnp oracle (``attention_reference``) gives the answer,
at that file's tolerances.  The inputs are drawn with numpy from the case's
seed and fed to both.  ``attention`` pads a head_dim the kernels are not
built for (80, 96) to the next one that is, on every device, so these cases
run the route the card takes; the gradients at d = 80 and 96 are held to
``jax.vjp`` of the same oracle.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattention_tpu.ops.reference import attention_reference
import flashattention_tpu_torch as ft
from flashattention_tpu_torch.ops import dispatch
from flashattention_tpu_torch.ops import quant as tq
from flashattention_tpu_torch.utils.testing import validate_result

torch.set_num_threads(2)

CASES = list(range(12))


def sample_config(rng):
    """``tests/test_fuzz.py``'s draw, call for call."""
    b = int(rng.integers(1, 4))
    hkv = int(rng.choice([1, 2, 4]))
    g = int(rng.choice([1, 1, 2, 4]))
    hq = hkv * g
    d = int(rng.choice([32, 64, 80, 128]))
    s_q = int(rng.integers(16, 400))
    cross = rng.random() < 0.3
    s_kv = int(rng.integers(s_q, 512)) if cross else s_q
    causal = bool(rng.random() < 0.6)
    dtype = "float32" if rng.random() < 0.5 else "bfloat16"
    scale = float(rng.choice([1.0, d**-0.5]))
    window = int(rng.integers(8, s_kv + 1)) if causal and rng.random() < 0.4 else None
    cap = float(rng.choice([20.0, 50.0])) if rng.random() < 0.3 else None
    return b, hq, hkv, d, s_q, s_kv, causal, dtype, scale, window, cap


def _inputs(seed, shapes, dtype):
    """Uniform(-1, 1) float32 arrays (``make_random``'s distribution), each
    rounded to ``dtype``: the torch tensors and their exact float32 values."""
    rng = np.random.default_rng(seed)
    out = []
    for shape in shapes:
        t = torch.from_numpy(rng.uniform(-1.0, 1.0, shape).astype(np.float32))
        t = t.to(getattr(torch, dtype))
        out.append((t, t.float().numpy()))
    return out


def _oracle(q, k, v, **kw):
    """The JAX oracle over (B, H, S, d) float32 arrays, K/V repeated to q's
    heads: (B * H, S_q, d)."""
    b, hq, s_q, d = q.shape
    g = hq // k.shape[1]
    kr = jnp.repeat(jnp.asarray(k), g, axis=1).reshape(b * hq, -1, d)
    vr = jnp.repeat(jnp.asarray(v), g, axis=1).reshape(b * hq, -1, d)
    return attention_reference(jnp.asarray(q).reshape(b * hq, s_q, d), kr, vr, **kw)


def test_the_sweep_covers_head_dim_80():
    """The draw reaches the head_dim no kernel is built for, padded."""
    ds = [sample_config(np.random.default_rng(1000 + c))[3] for c in CASES]
    assert 80 in ds and dispatch.padded_head_dim(80) == 128


@pytest.mark.parametrize("case", CASES)
def test_fuzz_attention_vs_oracle(case):
    b, hq, hkv, d, s_q, s_kv, causal, dtype, scale, window, cap = sample_config(
        np.random.default_rng(1000 + case))
    (q, qf), (k, kf), (v, vf) = _inputs(case, [(b, hq, s_q, d), (b, hkv, s_kv, d),
                                               (b, hkv, s_kv, d)], dtype)
    o = ft.attention(q, k, v, causal=causal, scale=scale, window=window, logit_softcap=cap)
    assert o.shape == q.shape and o.dtype == q.dtype
    want = _oracle(qf, kf, vf, causal=causal, scale=scale, q_offset=s_kv - s_q if causal else 0,
                   window=window, logit_softcap=cap)
    tol = 1e-3 if dtype == "float32" else 5e-2
    validate_result(o.float().reshape(b * hq, s_q, d), np.asarray(want), tol,
                    name=f"case {case}: b={b} hq={hq} hkv={hkv} d={d} s_q={s_q} s_kv={s_kv} "
                         f"causal={causal} {dtype} scale={scale} window={window} cap={cap}")


@pytest.mark.parametrize("case", range(6))
def test_fuzz_quantized_vs_oracle(case):
    rng = np.random.default_rng(2000 + case)
    bh = int(rng.integers(1, 6))
    d = int(rng.choice([32, 64, 128]))
    s = int(rng.integers(16, 300))
    causal = bool(rng.random() < 0.5)
    qdtype = "int8" if rng.random() < 0.7 else "fp8"
    (q, qf), (k, kf), (v, vf) = _inputs(case + 77, [(bh, s, d)] * 3, "float32")
    kq, vq = tq.quantize_kv(k, v, qdtype)
    o = tq.attention_quantized(q, kq, vq, causal=causal)
    want = attention_reference(jnp.asarray(qf), jnp.asarray(kf), jnp.asarray(vf), causal=causal)
    tol = 5e-2 if qdtype == "int8" else 2e-1
    validate_result(o, np.asarray(want), tol,
                    name=f"case {case}: bh={bh} d={d} s={s} causal={causal} {qdtype}")


# (d, dtype, causal, window, softcap, GQA groups): head_dims the kernels are
# not built for, under autograd.
GRAD_CASES = [
    (80, "float32", True, None, None, 2),
    (96, "float32", False, None, 30.0, 1),
    (80, "bfloat16", True, 40, None, 4),
    (96, "bfloat16", True, None, None, 1),
]


@pytest.mark.parametrize("case", GRAD_CASES, ids=lambda c: "-".join(map(str, c)))
def test_padded_head_dim_gradients_vs_oracle(case):
    """``sdpa`` at d = 80 / 96 (scale 1 / sqrt(d), not the padded size's):
    o and the gradients of q, k, v against ``jax.vjp`` of the oracle."""
    d, dtype, causal, window, cap, g = case
    b, hkv, s = 2, 2, 150
    (q, qf), (k, kf), (v, vf), (do, dof) = _inputs(
        d, [(b, hkv * g, s, d), (b, hkv, s, d), (b, hkv, s, d), (b, hkv * g, s, d)], dtype)
    ins = [x.clone().requires_grad_() for x in (q, k, v)]
    o = ft.sdpa(*ins, causal=causal, window=window, logit_softcap=cap)
    grads = torch.autograd.grad(o, ins, do)

    def f(q_, k_, v_):
        return _oracle(q_, k_, v_, causal=causal, scale=d**-0.5, window=window,
                       logit_softcap=cap).reshape(q_.shape)

    want, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (qf, kf, vf)))
    wgrads = vjp(jnp.asarray(dof))
    tol = 1e-3 if dtype == "float32" else 5e-2
    validate_result(o.float(), np.asarray(want), tol, name="o")
    for name, got, w in zip(("dq", "dk", "dv"), grads, wgrads):
        assert got.shape == (ins["qkv".index(name[1])].shape) and got.dtype == q.dtype
        validate_result(got.float(), np.asarray(w), tol, name=name)


@pytest.mark.parametrize("qdtype", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_padded_head_dim_8bit_kv_vs_oracle(qdtype, dtype):
    """``attention(k_scales=, v_scales=)`` at d = 80: the 8-bit payloads
    padded with zero bytes, the scales as they are, against the oracle over
    the dequantized K/V and q as the kernels take it over 8-bit K/V, in bf16
    (1e-4 in float32, whose O comes from the float32 sums; the bf16 class's
    5e-2 in bf16)."""
    b, h, hkv, s, d = 2, 4, 2, 120, 80
    (q, qf), (k, _), (v, _) = _inputs(80, [(b, h, s, d), (b * hkv, s, d), (b * hkv, s, d)], dtype)
    kq, vq = tq.quantize_kv(k.float(), v.float(), qdtype)
    o = ft.attention(q, kq.payload.reshape(b, hkv, s, d), vq.payload.reshape(b, hkv, s, d),
                     causal=True, scale=d**-0.5, k_scales=kq.scales.reshape(b, hkv, s),
                     v_scales=vq.scales.reshape(b, hkv, s))
    assert o.shape == q.shape and o.dtype == q.dtype
    kd, vd = (tq.dequantize(x).reshape(b, hkv, s, d).numpy() for x in (kq, vq))
    qb = torch.from_numpy(qf).to(torch.bfloat16).float().numpy()
    want = _oracle(qb, kd, vd, causal=True, scale=d**-0.5)
    validate_result(o.float().reshape(b * h, s, d), np.asarray(want),
                    1e-4 if dtype == "float32" else 5e-2)


def test_head_dim_above_256_is_refused():
    q = torch.zeros(1, 2, 8, 288)
    with pytest.raises(ValueError, match="head_dim <= 256"):
        ft.attention(q, q, q)
