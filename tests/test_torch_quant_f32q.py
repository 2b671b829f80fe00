"""Float32 q over 8-bit (int8, fp8) K/V and pages, at the JAX package's
default precision.

The JAX kernels take float32 q in bf16 over 8-bit K/V: the flash forward in
its quantized default mode, ``"bf16"`` (``flashattention_tpu/ops/flash.py``
:1352-1360, q cast at :825, p times v_scale at :971-976), the paged kernels
over every page that is not float32 (``ops/decode.py:145-150``, :202,
:440-445, :481-483); their output is q's type.  The port does the same: q
cast to bf16, the bf16 call's form (the tensor-core 8-bit forms
``flash_fwd_tc_quant``, ``paged_decode_tc_quant`` and
``paged_prefill_tc_quant`` where they take the call; on the CPU their plain
versions), O in float32, straight from the float32 sums; where the
tensor-core 8-bit form does not take the call (head_dim 32 here) q stays
float32 on the exact scalar 8-bit form.  Here, on the
same numpy inputs (the Pallas kernels in interpret mode on the CPU): each
entry point against the JAX function within 2e-2 of the output's magnitude
(``tests/test_quant.py``'s bound); the output float32; the CPU path the
plain version of the bf16 form over q's bf16 values; and the explicit
``"bf16_3x"`` and ``"float32"`` modes of the flash forward on the exact
scalar form, q kept in float32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattention_tpu.ops import decode as jd
from flashattention_tpu.ops import flash as jflash
from flashattention_tpu.ops import quant as jq
from flashattention_tpu_torch.ops import decode as td
from flashattention_tpu_torch.ops import flash as tflash
from flashattention_tpu_torch.ops import quant as tq
from flashattention_tpu_torch.utils.testing import to_torch, validate_result

torch.set_num_threads(2)

QUANT_TOL = 2e-2  # tests/test_quant.py's bound, relative to the output's magnitude
QDTYPES = ["int8", "fp8"]


def _vs_jax(got, want):
    want = np.asarray(want).astype(np.float32)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    validate_result(got, want, QUANT_TOL * max(1.0, float(np.abs(want).max())))


def _rows(rng, shape):
    """Normal rows whose magnitudes spread over two decades."""
    mag = 10.0 ** rng.uniform(-1.0, 1.0, shape[:-1] + (1,))
    return (rng.standard_normal(shape) * mag).astype(np.float32)


def _quantized(rng, shape, dtype):
    """8-bit rows of ``shape`` quantized per row by the JAX package, and the
    port's tensors of the same payload and scales."""
    jqt = jq.quantize(jnp.asarray(_rows(rng, shape).reshape(-1, *shape[-2:])), dtype)
    payload, scales = jqt.payload.reshape(shape), jqt.scales.reshape(shape[:-1])
    return (payload, scales), (to_torch(np.asarray(payload)), to_torch(np.asarray(scales)))


def _q(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _bf16_valued(x):
    return torch.equal(x.to(torch.bfloat16).float(), x)


def _same(got, want):
    """The same computation: equal up to the CPU sums' order (2^-20 of the
    output's magnitude; the forms differ by far more, bf16's store by 2^-9
    of each element)."""
    assert bool(((got - want).abs() <= 2.0**-20 * max(1.0, float(want.abs().max()))).all())


# (name, BH, S_q, S_kv, d, causal, q_seq_len, window, softcap): the
# tensor-core 8-bit form at d = 128 and, GQA-folded with a window and
# softcap, at d = 64; the exact scalar 8-bit form (float32 q) at d = 32.
FLASH_CASES = [
    ("tc_d128_causal", 2, 128, 128, 128, True, None, None, None),
    ("tc_d64_gqa_window_cap", 2, 256, 128, 64, True, 128, 48, 20.0),
    ("scalar_d32", 2, 128, 128, 32, True, None, None, None),
]


def _flash_setup(case, dtype, seed):
    name, bh, s_q, s_kv, d, causal, q_seq_len, window, cap = case
    rng = np.random.default_rng(seed)
    jq_, tq_ = _q(rng, (bh, s_q, d))
    (jk, jks), (tk, tks) = _quantized(rng, (bh, s_kv, d), dtype)
    (jv, jvs), (tv, tvs) = _quantized(rng, (bh, s_kv, d), dtype)
    kw = dict(causal=causal, scale=d**-0.5, q_seq_len=q_seq_len, window=window,
              logit_softcap=cap)
    return (jq_, jk, jv, jks, jvs), (tq_, tk, tv, tks, tvs), kw


@pytest.mark.parametrize("dtype", QDTYPES)
@pytest.mark.parametrize("case", FLASH_CASES, ids=[c[0] for c in FLASH_CASES])
def test_flash_f32_q_over_8bit_kv(case, dtype):
    jargs, targs, kw = _flash_setup(case, dtype, 21)
    got = tflash.flash_attention(*targs, **kw)
    want = jflash.flash_attention(*jargs, **kw, interpret=True)
    _vs_jax(got, want)
    d = case[4]
    form = tflash.kernel_form("flash_fwd", torch.bfloat16, d, quantized=True)
    assert form == case[0].split("_")[0]
    assert tflash.f32_q_in_bf16(torch.float32, True, None, d) == (form == "tc")
    tq_, tk, tv, tks, tvs = targs
    sc = dict(k_scales=tks, v_scales=tvs)
    if form == "tc":  # the tc mirror over q's bf16 values, O from the float32 sums
        qb = tq_.to(torch.bfloat16).float()
        _same(got, tflash.flash_attention_plain(qb, tk, tv, form="tc", **sc, **kw))
    else:  # the exact scalar form, q in float32
        _same(got, tflash.flash_attention_plain(tq_, tk, tv, form="scalar", **sc, **kw))
    assert not _bf16_valued(got)


@pytest.mark.parametrize("mode", ["bf16_3x", "float32"])
@pytest.mark.parametrize("dtype", QDTYPES)
def test_flash_f32_q_explicit_modes_stay_exact(dtype, mode):
    """``"bf16_3x"`` and ``"float32"`` keep q in float32 on the scalar form
    (more exact than JAX's, which splits q or upcasts the payload)."""
    case = FLASH_CASES[1]
    jargs, targs, kw = _flash_setup(case, dtype, 22)
    tq_, tk, tv, tks, tvs = targs
    assert not tflash.f32_q_in_bf16(torch.float32, True, mode, case[4])
    assert tflash.kernel_form("flash_fwd", torch.float32, case[4], quantized=True,
                              precision=mode) == "scalar"
    got = tflash.flash_attention(*targs, precision=mode, **kw)
    exact = tflash.flash_attention_plain(tq_, tk, tv, k_scales=tks, v_scales=tvs, form="scalar",
                                         precision=mode, **kw)
    assert got.dtype == torch.float32
    _same(got, exact)
    assert not torch.equal(got, tflash.flash_attention(*targs, **kw))
    _vs_jax(got, jflash.flash_attention(*jargs, precision=mode, **kw, interpret=True))


@pytest.mark.parametrize("dtype", QDTYPES)
def test_attention_quantized_f32_q(dtype):
    """``attention_quantized`` at its default precision, ragged S with a GQA
    fold, against the JAX function (which pads to its tiles)."""
    rng = np.random.default_rng(23)
    bh, rows, s_kv, d, seg = 2, 2 * 90, 200, 128, 90
    jq_, tq_ = _q(rng, (bh, rows, d))
    x, y = _rows(rng, (bh, s_kv, d)), _rows(rng, (bh, s_kv, d))
    jk, jv = jq.quantize_kv(jnp.asarray(x), jnp.asarray(y), dtype)
    tk, tv = tq.quantize_kv(torch.from_numpy(x), torch.from_numpy(y), dtype)
    kw = dict(causal=True, scale=d**-0.5, q_offset=s_kv - seg, q_seq_len=seg)
    got = tq.attention_quantized(tq_, tk, tv, **kw)
    _vs_jax(got, jq.attention_quantized(jq_, jk, jv, **kw))
    sc = dict(k_scales=tk.scales, v_scales=tv.scales)
    _same(got, tflash.flash_attention_plain(
        tq_.to(torch.bfloat16).float(), tk.payload, tv.payload, form="tc", **sc, **kw))


# (name, KVH, G, draft_k, d, page size, pages per request, lengths, window,
# softcap): the tensor-core 8-bit form (k = 1; the draft form at k = 2 with a
# window and softcap); the exact scalar 8-bit form (float32 q) at d = 32.
DECODE_CASES = [
    ("tc_g2_d128_ps16", 2, 2, 1, 128, 16, 4, [1, 17, 50], None, None),
    ("tc_draft_k2_d64_ps32_window_cap", 1, 2, 2, 64, 32, 3, [2, 40, 90], 30, 15.0),
    ("scalar_g2_d32_ps8", 2, 2, 1, 32, 8, 4, [5, 20, 31], None, None),
]


@pytest.mark.parametrize("dtype", QDTYPES)
@pytest.mark.parametrize("case", DECODE_CASES, ids=[c[0] for c in DECODE_CASES])
def test_decode_f32_q_over_8bit_pages(case, dtype):
    name, kvh, g, k, d, ps, pps, lens, window, cap = case
    rng = np.random.default_rng(24)
    b, pool = len(lens), len(lens) * pps + 2
    (jk, jks), (tk, tks) = _quantized(rng, (pool, kvh, ps, d), dtype)
    (jv, jvs), (tv, tvs) = _quantized(rng, (pool, kvh, ps, d), dtype)
    jq_, tq_ = _q(rng, (b, kvh, g * k, d))
    table = rng.permutation(pool)[: b * pps].reshape(b, pps).astype(np.int32)
    kw = dict(scale=d**-0.5, draft_k=k, window=window, logit_softcap=cap)
    args = (torch.tensor(lens, dtype=torch.int32), torch.from_numpy(table))
    sc = dict(k_scales_pages=tks, v_scales_pages=tvs)
    got = td.paged_attention(tq_, tk, tv, *args, **sc, **kw)
    want = jd.paged_attention(jq_, jk, jv, jnp.asarray(lens, jnp.int32), jnp.asarray(table),
                              k_scales_pages=jks, v_scales_pages=jvs, **kw)
    _vs_jax(got, want)
    form = tflash.kernel_form("paged_decode", torch.bfloat16, d, quantized=True, page_size=ps,
                              rows=g * k)
    assert form == name.split("_")[0]
    q = tq_.to(torch.bfloat16).float() if form == "tc" else tq_  # the exact scalar form: float32
    _same(got, td.paged_attention_plain(q, tk, tv, *args, form=form, **sc, **kw))
    assert not _bf16_valued(got)


# (name, KVH, G, d, page size, pages per request, chunk, seg, ctx lens,
# window, softcap)
PREFILL_CASES = [
    ("tc_g2_d64_ps16", 2, 2, 64, 16, 6, 20, 24, [20, 57], None, None),
    ("tc_g1_d128_ps32_window_cap", 1, 1, 128, 32, 4, 32, 32, [32, 100], 40, 20.0),
    ("scalar_g2_d32_ps16", 2, 2, 32, 16, 4, 16, 16, [16, 50], None, None),
]


@pytest.mark.parametrize("dtype", QDTYPES)
@pytest.mark.parametrize("case", PREFILL_CASES, ids=[c[0] for c in PREFILL_CASES])
def test_prefill_f32_q_over_8bit_pages(case, dtype):
    name, kvh, g, d, ps, pps, chunk, seg, ctx, window, cap = case
    rng = np.random.default_rng(25)
    b, pool = len(ctx), len(ctx) * pps + 2
    (jk, jks), (tk, tks) = _quantized(rng, (pool, kvh, ps, d), dtype)
    (jv, jvs), (tv, tvs) = _quantized(rng, (pool, kvh, ps, d), dtype)
    jq_, tq_ = _q(rng, (b, kvh, g * seg, d))
    table = rng.permutation(pool)[: b * pps].reshape(b, pps).astype(np.int32)
    kw = dict(chunk=chunk, seg=seg, scale=d**-0.5, window=window, logit_softcap=cap)
    sc = dict(k_scales_pages=tks, v_scales_pages=tvs)
    jsc = dict(k_scales_pages=jks, v_scales_pages=jvs)
    targs = (torch.from_numpy(table), torch.tensor(ctx, dtype=torch.int32))
    got = td.paged_prefill_attention_batched(tq_, tk, tv, *targs, **sc, **kw)
    want = np.asarray(jd.paged_prefill_attention_batched(
        jq_, jk, jv, jnp.asarray(table), jnp.asarray(ctx, jnp.int32), **jsc, **kw))
    live = torch.from_numpy((np.arange(g * seg) % seg) < chunk)
    _vs_jax(got[:, :, live], want[:, :, live.numpy()])
    form = tflash.kernel_form("paged_prefill", torch.bfloat16, d, quantized=True, page_size=ps)
    assert form == name.split("_")[0]
    q = tq_.to(torch.bfloat16).float() if form == "tc" else tq_  # the exact scalar form: float32
    _same(got, td.paged_prefill_attention_plain(q, tk, tv, *targs, form=form, **sc, **kw))
    assert not _bf16_valued(got)
    # One request through paged_prefill_attention: the batched call's row.
    one = td.paged_prefill_attention(tq_[1], tk, tv, targs[0][1], ctx[1], **sc, **kw)
    assert one.dtype == torch.float32 and torch.equal(one, got[1])
    want_one = np.asarray(jd.paged_prefill_attention(
        jq_[1], jk, jv, jnp.asarray(table[1]), int(ctx[1]), **jsc, **kw))
    _vs_jax(one[:, live], want_one[:, live.numpy()])
