"""The tensor-core forms over 8-bit K/V: chunked prefill over int8 / fp8
pages (``paged_prefill_tc_quant``) and the flash forward over int8 / fp8
K/V (``flash_fwd_tc_quant``).

``ops.flash.kernel_form`` sends bf16 q over 8-bit K/V at head_dim 64, 128
and 256 to the tensor-core forms (paged prefill only on a page size their
TMA boxes take), float32 q over 8-bit K/V there too (taken in bf16, as the
JAX kernels' default takes it: ``tests/test_torch_quant_f32q.py``), and
8-bit K/V with dropout or a block mask, or float32 q in the exact
precision modes, to the scalar kernels' 8-bit forms.  The tensor-core forms compute what the
Pallas kernels compute, in their order: the payload converted to bf16
(exact), the bf16 QK^T product in float32, score column j times
``k_scale[j]``, then the scale, softcap and masks; ``v_scale[j]`` folded into
P's column j before P's two-term bf16 split.  Their plain versions
(``form="tc"``) mirror that rounding.  Here: those mirrors (what the CPU
path runs in bf16) against the JAX package's 8-bit functions (the Pallas
kernels in interpret mode on the CPU) within ``tests/test_quant.py``'s
bound, 2e-2 of the output's magnitude, for int8 and fp8, MHA, GQA, Gemma-2's
window and softcap at d = 256 and a ``ctx_len = 0`` request; and that the
mirrored rounding differs from the scalar form's, so that the option is not
dead.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattention_tpu.ops import decode as jd
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
    validate_result(got.float(), want, QUANT_TOL * max(1.0, float(np.abs(want).max())))


def _rows(rng, shape, decades=2.0):
    """Normal rows whose magnitudes spread over ``decades`` decades, so that
    a scale applied to the wrong row moves the result."""
    mag = 10.0 ** rng.uniform(-decades / 2, decades / 2, shape[:-1] + (1,))
    return (rng.standard_normal(shape) * mag).astype(np.float32)


def _bf16_pair(x):
    """The same values as a bf16 JAX array and a bf16 torch tensor."""
    j = jnp.asarray(x, jnp.bfloat16)
    return j, torch.tensor(np.asarray(j.astype(jnp.float32))).to(torch.bfloat16)


def _quant_pool(rng, shape, dtype):
    """A pool (P, KVH, ps, d) quantized per row by the JAX package: its
    payload and scales, and the same bits as torch tensors."""
    jqt = jq.quantize(jnp.asarray(_rows(rng, shape).reshape(-1, shape[-2], shape[-1])), dtype)
    payload, scales = jqt.payload.reshape(shape), jqt.scales.reshape(shape[:-1])
    return (payload, scales), (to_torch(np.asarray(payload)), to_torch(np.asarray(scales)))


# ── the form selector ───────────────────────────────────────────────────────


@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_8bit_forms_selector(d):
    tc_dims = (64, 128, 256)
    for dtype in (torch.float32, torch.bfloat16):
        want = "tc" if dtype == torch.bfloat16 and d in tc_dims else "scalar"
        assert tflash.kernel_form("flash_fwd", dtype, d, quantized=True) == want
        assert tflash.kernel_form("paged_prefill", dtype, d, quantized=True, page_size=256) == want
        # dropout or a block mask over 8-bit K/V: the scalar 8-bit form
        assert tflash.kernel_form("flash_fwd", dtype, d, quantized=True, dropout=True) == "scalar"
        assert tflash.kernel_form("flash_fwd", dtype, d, quantized=True,
                                  block_mask=True) == "scalar"
        # a page size the boxes do not take
        assert tflash.kernel_form("paged_prefill", dtype, d, quantized=True,
                                  page_size=12) == "scalar"
    with tflash.scalar_forms():
        assert tflash.kernel_form("flash_fwd", torch.bfloat16, 128, quantized=True) == "scalar"


# ── chunked prefill over 8-bit pages ────────────────────────────────────────

# (name, KVH, G, d, page size, pages per request, chunk, seg, ctx_lens,
# window, softcap, q scale): MHA at d = 128 with a prefix; GQA with seg >
# chunk and a ctx = 0 request at d = 64 on pages below the KV tile;
# Gemma-2's window and softcap at d = 256 (the pad rows past their window).
PREFILL_CASES = [
    ("mha_d128_ps16", 2, 1, 128, 16, 8, 32, 32, [48, 32, 120], None, None, 1.0),
    ("gqa_seg_ctx0_d64_ps16", 2, 2, 64, 16, 8, 20, 24, [0, 20, 57, 110], None, None, 1.0),
    ("gemma2_window_cap_d256_ps64", 2, 2, 256, 64, 4, 40, 48, [40, 130, 250], 60, 15.0, 4.0),
]


def _prefill_inputs(case, dtype, seed):
    _, kvh, g, d, ps, pps, _, seg, ctx, _, _, qmul = case
    rng = np.random.default_rng(seed)
    b = len(ctx)
    pool = b * pps + 3
    k, v = (_quant_pool(rng, (pool, kvh, ps, d), dtype) for _ in range(2))
    q = _bf16_pair(rng.standard_normal((b, kvh, g * seg, d)).astype(np.float32) * np.float32(qmul))
    table = rng.permutation(pool)[: b * pps].reshape(b, pps).astype(np.int32)
    return q, k, v, table, np.array(ctx, np.int32)


def _prefill_kw(case):
    _, _, _, d, _, _, chunk, seg, _, window, cap, _ = case
    return dict(chunk=chunk, seg=seg, scale=d**-0.5, window=window, logit_softcap=cap)


@pytest.mark.parametrize("dtype", QDTYPES)
@pytest.mark.parametrize("case", PREFILL_CASES, ids=[c[0] for c in PREFILL_CASES])
def test_tc_prefill_8bit_matches_jax(case, dtype):
    """The 8-bit tensor-core form's plain version against the JAX kernel on
    the rows it writes (ctx > 0; the chunk's rows, not the pad rows); a ctx
    = 0 request gets zeros."""
    (jq_, tq_), ((jkp, jks), (tkp, tks)), ((jvp, jvs), (tvp, tvs)), table, ctx = _prefill_inputs(
        case, dtype, 1)
    kw = _prefill_kw(case)
    d, ps, chunk, seg = case[3], case[4], case[6], case[7]
    assert tflash.kernel_form("paged_prefill", tq_.dtype, d, quantized=True, page_size=ps) == "tc"
    got = td.paged_prefill_attention_batched(tq_, tkp, tvp, torch.from_numpy(table),
                                             torch.from_numpy(ctx), k_scales_pages=tks,
                                             v_scales_pages=tvs, **kw)
    want = np.asarray(jd.paged_prefill_attention_batched(
        jq_, jkp, jvp, jnp.asarray(table), jnp.asarray(ctx), k_scales_pages=jks,
        v_scales_pages=jvs, **kw).astype(jnp.float32))
    live = (np.arange(got.shape[2]) % seg) < chunk
    req = ctx > 0
    _vs_jax(got[torch.from_numpy(req)][:, :, torch.from_numpy(live)], want[req][:, :, live])
    for i in np.nonzero(~req)[0]:
        assert torch.count_nonzero(got[i]) == 0


@pytest.mark.parametrize("dtype", QDTYPES)
@pytest.mark.parametrize("case", PREFILL_CASES, ids=[c[0] for c in PREFILL_CASES])
def test_tc_prefill_8bit_rounding_moves_the_result(case, dtype):
    """The tc mirror (scales on the score columns and on P, P as two bf16
    terms) differs from the scalar form's (rows dequantized first, P in
    float32) by no more than the bound; it is the default for bf16 q, and
    float32 q is taken in bf16 by the same form, O in float32."""
    (_, tq_), (_, (tkp, tks)), (_, (tvp, tvs)), table, ctx = _prefill_inputs(case, dtype, 2)
    kw = dict(_prefill_kw(case), k_scales_pages=tks, v_scales_pages=tvs)
    args = (tq_, tkp, tvp, torch.from_numpy(table), torch.from_numpy(ctx))
    tc = td.paged_prefill_attention_plain(*args, form="tc", **kw)
    scalar = td.paged_prefill_attention_plain(*args, form="scalar", **kw)
    gap = float((tc.float() - scalar.float()).abs().max())
    assert 0.0 < gap < QUANT_TOL * max(1.0, float(scalar.float().abs().max()))
    assert torch.equal(td.paged_prefill_attention_plain(*args, **kw), tc)
    f32 = (tq_.float(), *args[1:])
    got = td.paged_prefill_attention_plain(*f32, **kw)
    assert got.dtype == torch.float32 and torch.equal(got.to(torch.bfloat16), tc)


def test_tc_prefill_8bit_is_the_forward_mirror_over_payloads():
    """One request of the paged tc mirror is the flat tc mirror over its
    gathered payloads and scales (no dequantization first)."""
    case = PREFILL_CASES[1]
    (_, tq_), (_, (tkp, tks)), (_, (tvp, tvs)), table, ctx = _prefill_inputs(case, "fp8", 3)
    kw = _prefill_kw(case)
    got = td.paged_prefill_attention_plain(tq_, tkp, tvp, torch.from_numpy(table),
                                           torch.from_numpy(ctx), k_scales_pages=tks,
                                           v_scales_pages=tvs, form="tc", **kw)
    i, n = 3, int(ctx[3])
    idx = torch.from_numpy(table[i]).long()
    kvh, ps, d = tkp.shape[1:]

    def rows(pool):
        return pool.view(torch.uint8)[idx].view(pool.dtype).transpose(0, 1).reshape(kvh, -1, d)

    def scales(pool):
        return pool[idx].transpose(0, 1).reshape(kvh, -1)

    want = tflash.flash_attention_plain(
        tq_[i], rows(tkp), rows(tvp), causal=True, scale=kw["scale"], kv_len=n,
        q_offset=n - kw["chunk"], q_seq_len=kw["seg"], form="tc", k_scales=scales(tks),
        v_scales=scales(tvs))
    assert torch.equal(got[i], want)


# ── the flash forward over 8-bit K/V ────────────────────────────────────────

# (name, BH, S_q, S_kv, d, causal, q_seq_len, window, softcap, q scale):
# MHA causal at d = 128 with a ragged S; a GQA fold of 2 segments with
# queries at the end of the KV rows at d = 64; Gemma-2's window and softcap
# at d = 256 (q x 4 so the scores reach the cap).
FLASH_CASES = [
    ("mha_causal_d128_s200", 2, 200, 200, 128, True, None, None, None, 1.0),
    ("gqa_fold_d64", 2, 160, 100, 64, True, 80, None, None, 1.0),
    ("gemma2_window_cap_d256", 1, 256, 256, 256, True, 128, 48, 15.0, 4.0),
]


def _flash_inputs(case, dtype, seed):
    _, bh, s_q, s_kv, d, _, _, _, _, qmul = case
    rng = np.random.default_rng(seed)
    q = _bf16_pair(rng.standard_normal((bh, s_q, d)).astype(np.float32) * np.float32(qmul))
    k, v = _rows(rng, (bh, s_kv, d)), _rows(rng, (bh, s_kv, d))
    jk, jv = jq.quantize_kv(jnp.asarray(k), jnp.asarray(v), dtype)
    tk, tv = (tq.QuantizedTensor(to_torch(np.asarray(x.payload)), to_torch(np.asarray(x.scales)))
              for x in (jk, jv))
    return q, (jk, jv), (tk, tv)


def _flash_kw(case):
    _, _, s_q, s_kv, d, causal, q_seq_len, window, cap, _ = case
    rows = q_seq_len or s_q
    return dict(causal=causal, scale=d**-0.5, q_offset=s_kv - rows if causal else 0,
                q_seq_len=q_seq_len, window=window, logit_softcap=cap)


@pytest.mark.parametrize("dtype", QDTYPES)
@pytest.mark.parametrize("case", FLASH_CASES, ids=[c[0] for c in FLASH_CASES])
def test_tc_flash_8bit_matches_jax(case, dtype):
    """``attention_quantized`` with bf16 q (its CPU path: the tc mirror)
    against the JAX package's, whose Pallas kernel runs in interpret mode."""
    (jq_, tq_), (jk, jv), (tk, tv) = _flash_inputs(case, dtype, 4)
    kw = _flash_kw(case)
    assert tflash.kernel_form("flash_fwd", tq_.dtype, case[4], quantized=True) == "tc"
    got = tq.attention_quantized(tq_, tk, tv, **kw)
    want = jq.attention_quantized(jq_, jk, jv, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == tq_.shape
    _vs_jax(got, want.astype(jnp.float32))


@pytest.mark.parametrize("dtype", QDTYPES)
@pytest.mark.parametrize("case", FLASH_CASES, ids=[c[0] for c in FLASH_CASES])
def test_tc_flash_8bit_rounding_moves_the_result(case, dtype):
    (_, tq_), _, (tk, tv) = _flash_inputs(case, dtype, 5)
    kw = {k: v for k, v in _flash_kw(case).items()}
    args = (tq_, tk.payload, tv.payload)
    sc = dict(k_scales=tk.scales, v_scales=tv.scales)
    tc = tflash.flash_attention_plain(*args, form="tc", **sc, **kw)
    scalar = tflash.flash_attention_plain(*args, form="scalar", **sc, **kw)
    gap = float((tc.float() - scalar.float()).abs().max())
    assert 0.0 < gap < QUANT_TOL * max(1.0, float(scalar.float().abs().max()))
    assert torch.equal(tflash.flash_attention(*args, **sc, **kw), tc)
    assert torch.equal(tflash.flash_attention_plain(*args, **sc, **kw), tc)
    # The scalar form is the float32 one over the rows dequantized first.
    deq = [x.payload.float() * x.scales[..., None] for x in (tk, tv)]
    assert torch.equal(scalar, tflash.flash_attention_plain(tq_, *deq, form="scalar", **kw))
    # float32 q over 8-bit K/V: taken in bf16 by the tc form (the JAX
    # default "bf16" mode), O in float32; the "float32" mode: the scalar form.
    f32 = (tq_.float(), *args[1:])
    got = tflash.flash_attention(*f32, **sc, **kw)
    assert got.dtype == torch.float32 and torch.equal(got.to(torch.bfloat16), tc)
    assert torch.equal(tflash.flash_attention(*f32, precision="float32", **sc, **kw),
                       tflash.flash_attention_plain(*f32, form="scalar", precision="float32",
                                                    **sc, **kw))
