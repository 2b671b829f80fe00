"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips where no card exists.  This file
imports neither JAX nor the JAX package, so it runs on a GPU host that has
only PyTorch::

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

(``--noconftest``: the suite's conftest sets up JAX's CPU devices).  Each
kernel is held, for every head_dim and group size it is instantiated for, to
its plain version run on the CPU: 1e-4 in float32, 2e-2 in bfloat16 (one
bf16 rounding of outputs of magnitude ~1); ``attention`` at head_dims 80 and
96 (padded to 128) with its gradients; the serving kernels' 8-bit forms
(int8 and fp8 K/V with per-row scales; in bf16 the forwards' tensor-core
8-bit forms) likewise, and the dropout and
block-mask forms of the flash forward and the backward kernels (the same
keep bits and element masks as the plain versions); float32 training's
forms (the fused backward's float32 form and the forward's dropout form in
"bf16_3x" and "bf16": against their plain versions, their keep bits, NaN
past kv_len and behind a ragged S); the d = 128 probe modes
(``ops/probes.py``) against their plain versions, on random inputs and on
inputs whose output is P's second bf16 term alone, the self-test's 21 checks
on the card, and a CLI's rows carrying the card's line.
"""

import dataclasses

import numpy as np
import pytest
import torch

import flashattention_tpu_torch as ft_attention
from flashattention_tpu_torch.models import train, transformer
from flashattention_tpu_torch.ops import backward, decode, flash, probes, quant
from flashattention_tpu_torch.runtime import engine, kvcache
from flashattention_tpu_torch.utils.packing import pack_documents
from flashattention_tpu_torch.utils.testing import validate_result

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture(autouse=True)
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False


def _randn(shape, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
@pytest.mark.parametrize(
    "kw",
    [
        dict(s_kv=250, causal=False),
        dict(s_kv=250, causal=True),
        dict(s_kv=100, causal=True, q_seq_len=70, q_offset=30),  # GQA fold, 3 groups
        dict(s_kv=100, causal=True, kv_len=77, q_offset=60, save_residuals=True),
    ],
    ids=["full", "causal", "gqa_fold", "kv_len_residuals"],
)
def test_flash_kernel_matches_plain(dtype, d, kw):
    kw = dict(kw)
    s_kv = kw.pop("s_kv")
    q = _randn((3, 210, d), dtype, 0)
    k, v = _randn((3, s_kv, d), dtype, 1), _randn((3, s_kv, d), dtype, 2)
    got = flash.flash_attention(q.cuda(), k.cuda(), v.cuda(), scale=d**-0.5, **kw)
    want = flash.flash_attention(q, k, v, scale=d**-0.5, **kw)
    torch.cuda.synchronize()
    if kw.get("save_residuals"):
        for g, w in zip(got[1:], want[1:]):
            validate_result(g, w, 1e-5 * float(w.abs().max()))
        got, want = got[0], want[0]
    validate_result(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("d", [80, 96])
def test_attention_padded_head_dim_matches_cpu(dtype, d):
    """``sdpa`` at a head_dim no kernel is built for (zero-padded to 128 on
    every device, 1 / sqrt(d) kept), causal GQA, under autograd: o and the
    gradients on the card against the same call on the CPU (the plain
    versions)."""
    q, k, v = _randn((2, 4, 150, d), dtype, 90), _randn((2, 2, 150, d), dtype, 91), \
        _randn((2, 2, 150, d), dtype, 92)
    do = _randn((2, 4, 150, d), dtype, 93) * 0.25
    outs = []
    for dev in ("cuda", "cpu"):
        ins = [x.to(dev).requires_grad_() for x in (q, k, v)]
        o = ft_attention.sdpa(*ins, causal=True)
        outs.append((o, *torch.autograd.grad(o, ins, do.to(dev))))
    torch.cuda.synchronize()
    for name, got, want in zip(("o", "dq", "dk", "dv"), *outs):
        assert got.shape == want.shape and got.dtype == dtype
        validate_result(got.detach().cpu(), want.detach(), TOL[dtype], name=name)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
def test_flash_kernel_segment_ids_match_plain(dtype, d):
    """Segment ids in the forward kernel: two packed documents and
    PAD_SEGMENT padding per row, GQA fold of 2 groups, with residuals."""
    ids = torch.full((3, 90), -1, dtype=torch.int32)
    ids[:, :40], ids[:, 40:75] = 0, 1
    ids[2, :] = 5
    seg = dict(q_segment_ids=ids.repeat(1, 2), kv_segment_ids=ids)
    q = _randn((3, 180, d), dtype, 14)
    k, v = _randn((3, 90, d), dtype, 15), _randn((3, 90, d), dtype, 16)
    kw = dict(causal=True, scale=d**-0.5, q_seq_len=90, save_residuals=True)
    got = flash.flash_attention(q.cuda(), k.cuda(), v.cuda(), **kw,
                                **{n: t.cuda() for n, t in seg.items()})
    want = flash.flash_attention(q, k, v, **kw, **seg)
    torch.cuda.synchronize()
    for g, w in zip(got[1:], want[1:]):
        validate_result(g, w, 1e-5 * float(w.abs().max()))
    validate_result(got[0], want[0], TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("g", [1, 2, 4, 8])
def test_paged_kernel_matches_plain(dtype, d, g):
    kvh, ps, pages, pps = 2, 16, 30, 5
    lengths = torch.tensor([0, 1, 16, 17, 80], dtype=torch.int32)
    table = torch.randperm(pages, generator=torch.Generator().manual_seed(3))[: 5 * pps]
    table = table.reshape(5, pps).to(torch.int32).contiguous()
    q = _randn((5, kvh, g, d), dtype, 4)
    kp, vp = _randn((pages, kvh, ps, d), dtype, 5), _randn((pages, kvh, ps, d), dtype, 6)
    args = (q, kp, vp, lengths, table)
    got = decode.paged_attention(*(a.cuda() for a in args), scale=d**-0.5)
    want = decode.paged_attention(*args, scale=d**-0.5)
    torch.cuda.synchronize()
    assert torch.count_nonzero(got[0]) == 0  # length 0: zeros
    validate_result(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("g", [1, 2, 4, 8])
def test_paged_prefill_kernel_matches_plain(dtype, d, g):
    """A dummy ctx = 0 row, a chunk-only row, a ragged context and a full
    table; seg = 24 > chunk = 20, so 32-row tiles cross segments."""
    kvh, ps, pages, pps, chunk, seg = 2, 16, 40, 6, 20, 24
    ctx = torch.tensor([0, 20, 37, 96], dtype=torch.int32)
    table = torch.randperm(pages, generator=torch.Generator().manual_seed(7))[: 4 * pps]
    table = table.reshape(4, pps).to(torch.int32).contiguous()
    q = _randn((4, kvh, g * seg, d), dtype, 8)
    kp, vp = _randn((pages, kvh, ps, d), dtype, 9), _randn((pages, kvh, ps, d), dtype, 10)
    args = (q, kp, vp, table, ctx)
    kw = dict(chunk=chunk, seg=seg, scale=d**-0.5)
    got = decode.paged_prefill_attention_batched(*(a.cuda() for a in args), **kw)
    want = decode.paged_prefill_attention_batched(*args, **kw)
    one = decode.paged_prefill_attention(q[2].cuda(), kp.cuda(), vp.cuda(), table[2].cuda(), 37, **kw)
    torch.cuda.synchronize()
    assert torch.count_nonzero(got[0]) == 0  # ctx = 0: zeros
    validate_result(got, want, TOL[dtype])
    validate_result(one, want[2], TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize(
    "kw",
    [dict(causal=False), dict(causal=True, q_offset=54), dict(causal=True, kv_len=77, q_offset=30)],
    ids=["full", "causal", "kv_len_q_offset"],
)
def test_naive_kernel_matches_plain_and_flash(dtype, d, kw):
    q = _randn((3, 96, d), dtype, 11)
    k, v = _randn((3, 150, d), dtype, 12), _randn((3, 150, d), dtype, 13)
    got = flash.flash_attention_naive(q.cuda(), k.cuda(), v.cuda(), scale=d**-0.5, block_q=32, **kw)
    want = flash.flash_attention_naive(q, k, v, scale=d**-0.5, block_q=32, **kw)
    fwd = flash.flash_attention(q.cuda(), k.cuda(), v.cuda(), scale=d**-0.5, **kw)
    torch.cuda.synchronize()
    validate_result(got, want, TOL[dtype])
    validate_result(got, fwd, TOL[dtype])  # two kernels, two softmax routes


# Sliding window and softcap in the three serving kernels.
WINDOW_CASES = {
    # GQA fold of 3 groups of 70 rows at q_offset 30: tiles cross segments.
    "gqa_window": dict(s_kv=100, causal=True, q_seq_len=70, q_offset=30, window=17),
    "softcap": dict(s_kv=250, causal=True, logit_softcap=5.0),
    # Every row sees a column (the kernel and the plain version give a row
    # that sees none different junk).
    "window_softcap_kv_len": dict(s_kv=260, causal=True, kv_len=240, q_offset=20,
                                  window=40, logit_softcap=20.0, save_residuals=True),
}


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("d", [32, 128, 256])
@pytest.mark.parametrize("case", list(WINDOW_CASES))
def test_flash_kernel_window_softcap_matches_plain(dtype, d, case):
    kw = dict(WINDOW_CASES[case])
    s_kv = kw.pop("s_kv")
    q = _randn((3, 210, d), dtype, 30)
    k, v = _randn((3, s_kv, d), dtype, 31), _randn((3, s_kv, d), dtype, 32)
    got = flash.flash_attention(q.cuda(), k.cuda(), v.cuda(), scale=d**-0.5, **kw)
    want = flash.flash_attention(q, k, v, scale=d**-0.5, **kw)
    torch.cuda.synchronize()
    if kw.get("save_residuals"):
        for g, w in zip(got[1:], want[1:]):
            validate_result(g, w, 1e-5 * float(w.abs().max()))
        got, want = got[0], want[0]
    validate_result(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("d", [64, 256])
@pytest.mark.parametrize("g", [1, 2, 4, 8])
def test_paged_kernel_window_softcap_matches_plain(dtype, d, g):
    """Lengths on both sides of a window of 20 (16-token pages): the last
    request's first two pages lie wholly before it."""
    kvh, ps, pages, pps = 2, 16, 30, 5
    lengths = torch.tensor([0, 1, 20, 21, 60], dtype=torch.int32)
    table = torch.randperm(pages, generator=torch.Generator().manual_seed(33))[: 5 * pps]
    table = table.reshape(5, pps).to(torch.int32).contiguous()
    q = _randn((5, kvh, g, d), dtype, 34)
    kp, vp = _randn((pages, kvh, ps, d), dtype, 35), _randn((pages, kvh, ps, d), dtype, 36)
    args = (q, kp, vp, lengths, table)
    kw = dict(scale=d**-0.5, window=20, logit_softcap=10.0)
    got = decode.paged_attention(*(a.cuda() for a in args), **kw)
    want = decode.paged_attention(*args, **kw)
    torch.cuda.synchronize()
    assert torch.count_nonzero(got[0]) == 0  # length 0: zeros
    validate_result(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("d", [64, 256])
@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("window", [3, 30])
def test_paged_prefill_kernel_window_softcap_matches_plain(dtype, d, g, window):
    """A dummy ctx = 0 row, a chunk-only row and contexts past the window;
    seg = 24 > chunk = 20, so query tiles cross segments; with window 3 the
    pad rows p >= 22 see nothing (zeros in both)."""
    kvh, ps, pages, pps, chunk, seg = 2, 16, 40, 6, 20, 24
    ctx = torch.tensor([0, 20, 57, 96], dtype=torch.int32)
    table = torch.randperm(pages, generator=torch.Generator().manual_seed(37))[: 4 * pps]
    table = table.reshape(4, pps).to(torch.int32).contiguous()
    q = _randn((4, kvh, g * seg, d), dtype, 38)
    kp, vp = _randn((pages, kvh, ps, d), dtype, 39), _randn((pages, kvh, ps, d), dtype, 40)
    args = (q, kp, vp, table, ctx)
    kw = dict(chunk=chunk, seg=seg, scale=d**-0.5, window=window, logit_softcap=10.0)
    got = decode.paged_prefill_attention_batched(*(a.cuda() for a in args), **kw)
    want = decode.paged_prefill_attention_batched(*args, **kw)
    torch.cuda.synchronize()
    assert torch.count_nonzero(got[0]) == 0  # ctx = 0: zeros
    validate_result(got, want, TOL[dtype])


# 8-bit K/V: int8 and fp8 payloads with float32 per-row scales, the rows'
# magnitudes spread over two decades (0.01-1) so that a scale applied to
# the wrong row moves the output.  Held to the plain version on the CPU,
# which dequantizes in float32, at TOL (outputs are of magnitude <= ~3).
QDTYPES = ["int8", "fp8"]


def _quant_rows(shape, qdtype, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g) * 10.0 ** -(2 * torch.rand(shape[:-1] + (1,), generator=g))
    return quant.quantize_rows(x, qdtype)


@pytest.mark.parametrize("qdtype", QDTYPES)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize(
    "kw",
    [
        dict(s_kv=250, causal=True),
        dict(s_kv=100, causal=True, q_seq_len=70, q_offset=30),  # GQA fold, 3 groups
        dict(s_kv=260, causal=True, kv_len=240, q_offset=20, window=40, logit_softcap=20.0,
             save_residuals=True),
    ],
    ids=["causal", "gqa_fold", "window_softcap_kv_len_residuals"],
)
def test_quant_flash_kernel_matches_plain(qdtype, dtype, d, kw):
    kw = dict(kw)
    s_kv = kw.pop("s_kv")
    q = _randn((3, 210, d), dtype, 50)
    (k, ks), (v, vs) = _quant_rows((3, s_kv, d), qdtype, 51), _quant_rows((3, s_kv, d), qdtype, 52)
    args = (q, k, v)
    got = flash.flash_attention(*(a.cuda() for a in args), k_scales=ks.cuda(), v_scales=vs.cuda(),
                                scale=d**-0.5, **kw)
    want = flash.flash_attention(*args, k_scales=ks, v_scales=vs, scale=d**-0.5, **kw)
    torch.cuda.synchronize()
    if kw.get("save_residuals"):
        for g, w in zip(got[1:], want[1:]):
            validate_result(g, w, 1e-5 * float(w.abs().max()))
        got, want = got[0], want[0]
    assert got.dtype == dtype
    validate_result(got, want, TOL[dtype])


@pytest.mark.parametrize("qdtype", QDTYPES)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", [(d, g) for d in decode._HEAD_DIMS for g in decode._GROUPS],
                         ids=lambda s: f"d{s[0]}-g{s[1]}")
@pytest.mark.parametrize("window", [None, 20], ids=["full", "window_softcap"])
def test_quant_paged_kernel_matches_plain(qdtype, dtype, shape, window):
    d, g = shape
    kvh, ps, pages, pps = 2, 16, 30, 5
    lengths = torch.tensor([0, 1, 16, 21, 80], dtype=torch.int32)
    table = torch.randperm(pages, generator=torch.Generator().manual_seed(53))[: 5 * pps]
    table = table.reshape(5, pps).to(torch.int32).contiguous()
    q = _randn((5, kvh, g, d), dtype, 54)
    (kp, ks), (vp, vs) = (_quant_rows((pages, kvh, ps, d), qdtype, s) for s in (55, 56))
    kw = dict(scale=d**-0.5, window=window, logit_softcap=10.0 if window else None)
    args = (q, kp, vp, lengths, table)
    got = decode.paged_attention(*(a.cuda() for a in args), k_scales_pages=ks.cuda(),
                                 v_scales_pages=vs.cuda(), **kw)
    want = decode.paged_attention(*args, k_scales_pages=ks, v_scales_pages=vs, **kw)
    torch.cuda.synchronize()
    assert torch.count_nonzero(got[0]) == 0  # length 0: zeros
    validate_result(got, want, TOL[dtype])


@pytest.mark.parametrize("qdtype", QDTYPES)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("window", [None, 30], ids=["full", "window_softcap"])
def test_quant_paged_prefill_kernel_matches_plain(qdtype, dtype, d, g, window):
    kvh, ps, pages, pps, chunk, seg = 2, 16, 40, 6, 20, 24
    ctx = torch.tensor([0, 20, 57, 96], dtype=torch.int32)
    table = torch.randperm(pages, generator=torch.Generator().manual_seed(57))[: 4 * pps]
    table = table.reshape(4, pps).to(torch.int32).contiguous()
    q = _randn((4, kvh, g * seg, d), dtype, 58)
    (kp, ks), (vp, vs) = (_quant_rows((pages, kvh, ps, d), qdtype, s) for s in (59, 60))
    kw = dict(chunk=chunk, seg=seg, scale=d**-0.5, window=window,
              logit_softcap=10.0 if window else None)
    args = (q, kp, vp, table, ctx)
    got = decode.paged_prefill_attention_batched(*(a.cuda() for a in args), k_scales_pages=ks.cuda(),
                                                 v_scales_pages=vs.cuda(), **kw)
    want = decode.paged_prefill_attention_batched(*args, k_scales_pages=ks, v_scales_pages=vs, **kw)
    torch.cuda.synchronize()
    assert torch.count_nonzero(got[0]) == 0  # ctx = 0: zeros
    validate_result(got, want, TOL[dtype])


# Backward cases: (BH, G, S_q per group, S_kv) and the masks; "segments"
# packs two documents and PAD_SEGMENT (-1) padding into each row.  The
# windowed cases scale q by 8 (and dO down by as much) so that the scores
# reach the softcap: a window shorter than the kernels' tiles with a cap, a
# window across tiles with segment ids, a window at a q_offset into a
# longer KV sequence with a live length (every row still sees a column).
BWD_CASES = {
    "full": dict(bh=3, g=1, s_q=96, s_kv=150, causal=False),
    "causal_gqa": dict(bh=2, g=3, s_q=70, s_kv=100, causal=True, q_offset=30),
    "kv_len_q_offset": dict(bh=2, g=2, s_q=50, s_kv=130, causal=True, kv_len=77, q_offset=60),
    "segments": dict(bh=2, g=2, s_q=80, s_kv=80, causal=True, segments=True),
    "window_softcap": dict(bh=2, g=3, s_q=100, s_kv=100, causal=True, window=13,
                           logit_softcap=20.0, qmul=8.0),
    "segments_window": dict(bh=2, g=2, s_q=80, s_kv=80, causal=True, segments=True, window=37,
                            logit_softcap=30.0, qmul=8.0),
    "kv_len_q_offset_window": dict(bh=2, g=2, s_q=50, s_kv=130, causal=True, kv_len=100,
                                   q_offset=60, window=70),
}


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("d", [32, 64, 128, 16, 256])
@pytest.mark.parametrize("case", list(BWD_CASES))
def test_bwd_kernels_match_plain(dtype, d, case):
    """The fused kernel (no segment ids) and the two-pass dQ and dK/dV
    kernels against the plain backward on the CPU, computed in float32 from
    the same (dtype-rounded) inputs: the tolerance covers the kernel's one
    rounding of each output to ``dtype`` and the order of its sums (dQ's
    float32 atomics in the fused kernel)."""
    c = BWD_CASES[case]
    rows = c["g"] * c["s_q"]
    qmul = c.get("qmul", 1.0)
    q = _randn((c["bh"], rows, d), torch.float32, 20).mul(qmul).to(dtype)
    k, v = _randn((c["bh"], c["s_kv"], d), dtype, 21), _randn((c["bh"], c["s_kv"], d), dtype, 22)
    do = _randn((c["bh"], rows, d), dtype, 23) * (0.25 / qmul)  # gradients below 4: see chip_smoke.py
    kw = dict(causal=c["causal"], scale=d**-0.5, kv_len=c.get("kv_len"),
              q_offset=c.get("q_offset", 0), q_seq_len=c["s_q"], window=c.get("window"),
              logit_softcap=c.get("logit_softcap"))
    seg = {}
    if c.get("segments"):
        ids = torch.full((c["bh"], c["s_q"]), -1, dtype=torch.int32)
        ids[0, :30], ids[0, 30:70] = 0, 1
        ids[1, :50], ids[1, 50:] = 0, 1
        seg = dict(q_segment_ids=ids.repeat(1, c["g"]), kv_segment_ids=ids)
    o, l, m = flash.flash_attention_plain(
        q.float(), k.float(), v.float(), save_residuals=True, **kw, **seg
    )
    o = o.to(dtype)
    lse = m + torch.log(torch.where(l == 0, 1.0, l))
    args = (q, k, v, o, lse, do)
    want = backward.flash_attention_bwd_plain(*(a.float() for a in args), **kw, **seg)
    seg_cuda = {n: t.cuda() for n, t in seg.items()}
    runs = [backward.flash_attention_bwd(*(a.cuda() for a in args), fused=False, **kw, **seg_cuda)]
    if not seg:
        runs.append(backward.flash_attention_bwd(*(a.cuda() for a in args), fused=True, **kw))
    torch.cuda.synchronize()
    for got in runs:
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            assert g.dtype == dtype
            validate_result(g, w, TOL[dtype], name=name)


def test_engine_on_card_matches_cpu():
    """Greedy tokens of the tiny float32 model, served on the card with the
    kernels, equal the CPU engine's (plain versions)."""
    cfg = dataclasses.replace(transformer.ModelConfig.tiny(), dtype="float32")
    params = transformer.init_params(0, cfg, device="cpu")
    outs = []
    for dev in ("cpu", "cuda"):
        p = {k: (v.to(dev) if torch.is_tensor(v) else [{n: w.to(dev) for n, w in lay.items()} for lay in v])
             for k, v in params.items()}
        cc = kvcache.CacheConfig(num_layers=2, num_kv_heads=2, head_dim=32, page_size=8,
                                 num_pages=6, dtype="float32")
        eng = engine.Engine(p, cfg, cc, engine.EngineConfig(max_batch=3, pages_per_seq=3,
                                                            prefill_chunk=0), device=dev)
        rng = np.random.default_rng(0)
        for n in (3, 9, 17, 5):
            eng.add_request(rng.integers(0, 256, n).tolist(), 6)
        outs.append(eng.run())
        assert eng.cache.num_free_pages() == 6
    assert outs[0] == outs[1]


def test_chunked_engine_on_card_matches_cpu():
    """The same with chunked prefill and a prefix hit: one donor prompt,
    then two prompts sharing its first two pages."""
    cfg = dataclasses.replace(transformer.ModelConfig.tiny(), dtype="float32")
    params = transformer.init_params(0, cfg, device="cpu")
    base = np.random.default_rng(1).integers(0, 256, 16).tolist()
    outs = []
    for dev in ("cpu", "cuda"):
        p = {k: (v.to(dev) if torch.is_tensor(v) else [{n: w.to(dev) for n, w in lay.items()} for lay in v])
             for k, v in params.items()}
        cc = kvcache.CacheConfig(num_layers=2, num_kv_heads=2, head_dim=32, page_size=8,
                                 num_pages=16, dtype="float32")
        eng = engine.Engine(p, cfg, cc, engine.EngineConfig(max_batch=4, pages_per_seq=5,
                                                            prefill_chunk=8), device=dev)
        eng.add_request(base + [3, 4, 5], 6)
        eng.step()
        for tail in ([9], [1, 2, 3, 4, 5, 6, 7, 8, 9, 10]):
            eng.add_request(base + tail, 6)
        outs.append((eng.run(), eng.stats()["prefill_tokens"]))
        assert eng.cache.num_free_pages() == 16
    assert outs[0] == outs[1]


@pytest.mark.parametrize("chunk", [0, 8], ids=["whole", "chunked"])
@pytest.mark.parametrize("head_dim", [32, 256])
def test_windowed_engine_on_card_matches_cpu(chunk, head_dim):
    """A windowed, softcapped tiny float32 model (window 12, softcap 30;
    head_dim 256 is the Gemma-2 shape), whole-prompt and chunked with a
    prefix hit past the window: greedy tokens on the card equal the CPU's."""
    cfg = dataclasses.replace(transformer.ModelConfig.tiny(), dtype="float32", head_dim=head_dim,
                              sliding_window=12, logit_softcap=30.0)
    params = transformer.init_params(0, cfg, device="cpu")
    base = np.random.default_rng(2).integers(0, 256, 26).tolist()
    outs = []
    for dev in ("cpu", "cuda"):
        p = {k: (v.to(dev) if torch.is_tensor(v) else [{n: w.to(dev) for n, w in lay.items()} for lay in v])
             for k, v in params.items()}
        cc = kvcache.CacheConfig(num_layers=2, num_kv_heads=2, head_dim=head_dim, page_size=8,
                                 num_pages=24, dtype="float32")
        eng = engine.Engine(p, cfg, cc, engine.EngineConfig(max_batch=4, pages_per_seq=6,
                                                            prefill_chunk=chunk), device=dev)
        eng.add_request(base, 6)
        eng.step()
        for tail in ([9], [1, 2, 3, 4, 5, 6, 7, 8, 9, 10]):
            eng.add_request(base[:24] + tail, 6)
        eng.add_request([3, 1, 4, 1, 5], 6)
        outs.append((eng.run(), eng.stats()["prefill_tokens"]))
        assert eng.cache.num_free_pages() == 24
    assert outs[0] == outs[1]


@pytest.mark.parametrize("chunk", [0, 8], ids=["whole", "chunked"])
@pytest.mark.parametrize("kv", ["int8", "fp8"])
@pytest.mark.parametrize("head_dim", [128, 256, 32, 64])
def test_quantized_engine_on_card_matches_cpu(head_dim, kv, chunk):
    """An 8-bit KV cache and int8 weights: float32 models at several of the
    8-bit decode's (head_dim, G): tiny with head_dim 128 and 4 KV heads
    (G = 1) and with head_dim 256 (G = 2, window 12, softcap 30), tiny as it
    is (head_dim 32, G = 2) and the default ``ModelConfig()`` (head_dim 64,
    G = 2); whole-prompt and chunked with a prefix hit: greedy tokens on the
    card equal the CPU's."""
    kw = {128: dict(head_dim=128, num_kv_heads=4), 32: {},
          256: dict(head_dim=256, sliding_window=12, logit_softcap=30.0)}.get(head_dim)
    model = transformer.ModelConfig() if head_dim == 64 else transformer.ModelConfig.tiny()
    cfg = dataclasses.replace(model, dtype="float32", **(kw or {}))
    params = quant.quantize_weights(transformer.init_params(0, cfg, device="cpu"), "int8")
    base = np.random.default_rng(3).integers(0, 256, 26).tolist()
    outs = []
    for dev in ("cpu", "cuda"):
        p = {k: (v.to(dev) if not isinstance(v, list) else [{n: w.to(dev) for n, w in lay.items()} for lay in v])
             for k, v in params.items()}
        cc = kvcache.CacheConfig(num_layers=2, num_kv_heads=cfg.num_kv_heads, head_dim=head_dim,
                                 page_size=8, num_pages=24, dtype=kv)
        eng = engine.Engine(p, cfg, cc, engine.EngineConfig(max_batch=4, pages_per_seq=6,
                                                            prefill_chunk=chunk), device=dev)
        eng.add_request(base, 6)
        eng.step()
        for tail in ([9], [1, 2, 3, 4, 5, 6, 7, 8, 9, 10]):
            eng.add_request(base[:24] + tail, 6)
        eng.add_request([3, 1, 4, 1, 5], 6)
        outs.append((eng.run(), eng.stats()["prefill_tokens"]))
        assert eng.cache.num_free_pages() == 24
    assert outs[0] == outs[1]


@pytest.mark.parametrize("packed", [False, True], ids=["plain", "packed"])
def test_train_step_on_card_matches_cpu(packed):
    """Three SGD steps of the tiny float32 model (GQA 4q/2kv, d = 32) on the
    card (the fused or two-pass backward kernels) and on the CPU (plain
    versions): losses within 1e-5 relative, parameters within 1e-5."""
    _check_train_card_vs_cpu(dataclasses.replace(transformer.ModelConfig.tiny(), dtype="float32"),
                             packed)


@pytest.mark.parametrize("packed", [False, True], ids=["plain", "packed"])
@pytest.mark.parametrize("head_dim", [16, 256])
def test_windowed_train_step_on_card_matches_cpu(head_dim, packed):
    """The same with Gemma-2's attention options, a sliding window of 24
    over 96-token rows and softcap 30, at head_dim 16 and 256."""
    cfg = dataclasses.replace(transformer.ModelConfig.tiny(), dtype="float32", head_dim=head_dim,
                              sliding_window=24, logit_softcap=30.0)
    _check_train_card_vs_cpu(cfg, packed)


@pytest.mark.parametrize("packed", [False, True], ids=["plain", "packed"])
@pytest.mark.parametrize("window", [None, 24], ids=["full", "window_softcap"])
def test_dropout_train_step_on_card_matches_cpu(window, packed):
    """The same with attn_dropout=0.1 and seed = step index: the card's
    keep bits are the plain version's (also with window and softcap)."""
    cfg = dataclasses.replace(transformer.ModelConfig.tiny(), dtype="float32",
                              sliding_window=window, logit_softcap=window and 30.0)
    _check_train_card_vs_cpu(cfg, packed, attn_dropout=0.1)


def _check_train_card_vs_cpu(cfg, packed, attn_dropout=None):
    rng = np.random.default_rng(5)
    if packed:  # two rows of two documents each and PAD_SEGMENT padding
        docs = [rng.integers(0, 256, n) for n in (30, 50, 20, 60, 40)]
        tokens, segs = (x[:2] for x in pack_documents(docs, 96))
    else:
        tokens, segs = rng.integers(0, 256, (2, 96)).astype(np.int32), None
    out = {}
    for dev in ("cpu", "cuda"):
        params = transformer.init_params(0, cfg, device="cpu")
        params = {k: (v.to(dev) if torch.is_tensor(v) else [{n: w.to(dev) for n, w in lay.items()} for lay in v])
                  for k, v in params.items()}
        make = train.make_train_step_packed if packed else train.make_train_step
        step = make(cfg, lr=0.1, attn_dropout=attn_dropout, device=dev)
        data = [torch.tensor(x, device=dev) for x in ((tokens, segs) if packed else (tokens,))]
        losses = [float(step(params, *data, seed)[0]) for seed in range(3)]
        out[dev] = (losses, [p.cpu() for p in train.common.leaves(params)])
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5)
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        validate_result(a, b, 1e-5)


# The paged decode kernel's draft form (speculative verification): G * k
# rows per KV head, k-minor, each at its own causal limit; lengths past
# every row's k; a window of 2 < k and one of 20 across the 16-token pages.
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("g", [1, 2, 4, 8])
@pytest.mark.parametrize("k", [2, 3, 4])
@pytest.mark.parametrize("window", [None, 2, 20], ids=["full", "window2_softcap", "window20_softcap"])
def test_paged_kernel_draft_matches_plain(dtype, d, g, k, window):
    kvh, ps, pages, pps = 2, 16, 30, 5
    lengths = torch.tensor([4, 16, 20, 21, 80], dtype=torch.int32)
    table = torch.randperm(pages, generator=torch.Generator().manual_seed(63))[: 5 * pps]
    table = table.reshape(5, pps).to(torch.int32).contiguous()
    q = _randn((5, kvh, g * k, d), dtype, 64)
    kp, vp = _randn((pages, kvh, ps, d), dtype, 65), _randn((pages, kvh, ps, d), dtype, 66)
    kw = dict(scale=d**-0.5, draft_k=k, window=window, logit_softcap=10.0 if window else None)
    args = (q, kp, vp, lengths, table)
    before = decode.paged_attention.launches_draft
    got = decode.paged_attention(*(a.cuda() for a in args), **kw)
    want = decode.paged_attention(*args, **kw)
    torch.cuda.synchronize()
    assert decode.paged_attention.launches_draft == before + 1
    validate_result(got, want, TOL[dtype])


@pytest.mark.parametrize("qdtype", QDTYPES)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", [(d, g) for d in decode._HEAD_DIMS for g in decode._GROUPS],
                         ids=lambda s: f"d{s[0]}-g{s[1]}")
@pytest.mark.parametrize("window", [None, 20], ids=["full", "window_softcap"])
def test_quant_paged_kernel_draft_matches_plain(qdtype, dtype, shape, window):
    d, g = shape
    kvh, ps, pages, pps = 2, 16, 30, 5
    lengths = torch.tensor([4, 16, 21, 37, 80], dtype=torch.int32)
    table = torch.randperm(pages, generator=torch.Generator().manual_seed(73))[: 5 * pps]
    table = table.reshape(5, pps).to(torch.int32).contiguous()
    q = _randn((5, kvh, g * 4, d), dtype, 74)
    (kp, ks), (vp, vs) = (_quant_rows((pages, kvh, ps, d), qdtype, s) for s in (75, 76))
    kw = dict(scale=d**-0.5, draft_k=4, window=window, logit_softcap=10.0 if window else None)
    args = (q, kp, vp, lengths, table)
    got = decode.paged_attention(*(a.cuda() for a in args), k_scales_pages=ks.cuda(),
                                 v_scales_pages=vs.cuda(), **kw)
    want = decode.paged_attention(*args, k_scales_pages=ks, v_scales_pages=vs, **kw)
    torch.cuda.synchronize()
    validate_result(got, want, TOL[dtype])


def test_paged_kernel_never_runs_plain_on_card(monkeypatch):
    """A CUDA call launches a kernel form (k = 1 or draft) or raises; the
    plain version is never its way out."""

    def refuse(*args, **kw):
        raise AssertionError("the plain version ran on a CUDA call")

    monkeypatch.setattr(decode, "paged_attention_plain", refuse)
    q = _randn((2, 2, 8, 64), torch.bfloat16, 80).cuda()
    kp = _randn((6, 2, 16, 64), torch.bfloat16, 81).cuda()
    lengths = torch.tensor([5, 30], dtype=torch.int32, device="cuda")
    table = torch.arange(6, dtype=torch.int32, device="cuda").reshape(2, 3)
    for k in (1, 4):
        decode.paged_attention(q, kp, kp, lengths, table, draft_k=k)
    with pytest.raises(ValueError, match="multiple of draft_k"):
        decode.paged_attention(q, kp, kp, lengths, table, draft_k=3)
    torch.cuda.synchronize()


@pytest.mark.parametrize("cache", ["float32", "int8"])
def test_speculative_and_multi_step_engine_on_card_match_cpu(cache):
    """Greedy tokens of the tiny float32 model with run(multi_step=4) and
    run_speculative(k=3) on the card equal the CPU engine's, which equal
    its per-token run's."""
    cfg = dataclasses.replace(transformer.ModelConfig.tiny(), dtype="float32")
    params = transformer.init_params(0, cfg, device="cpu")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 256, n).tolist() for n in (3, 9, 17)]
    outs = []
    for dev in ("cpu", "cuda"):
        p = {k: (v.to(dev) if torch.is_tensor(v) else [{n: w.to(dev) for n, w in lay.items()} for lay in v])
             for k, v in params.items()}
        for how in ("plain", "multi_step", "speculative"):
            cc = kvcache.CacheConfig(num_layers=2, num_kv_heads=2, head_dim=32, page_size=8,
                                     num_pages=16, dtype=cache)
            eng = engine.Engine(p, cfg, cc, engine.EngineConfig(max_batch=3, pages_per_seq=4,
                                                                prefill_chunk=0), device=dev)
            for pr in prompts:
                eng.add_request(pr, 9)
            if how == "speculative":
                outs.append(eng.run_speculative(lambda req, n: [req.length % 256] * n, k=3))
            else:
                outs.append(eng.run(multi_step=4 if how == "multi_step" else 1))
            assert eng.cache.num_free_pages() == 16
    assert all(o == outs[0] for o in outs)


# Attention dropout in the forward and the three backward kernels: each
# against its plain version on the CPU (the same keep bits, from the same
# hash), at every head_dim, with the GQA fold (and a raw row stride past the
# group length, as attention() passes for a ragged S), a window with a
# softcap, and segment ids for the two-pass pair.
DROPOUT_CASES = {
    "full": dict(bh=3, g=1, s=96, causal=False),
    "causal_gqa_stride": dict(bh=2, g=3, s=70, causal=True, row_stride=128),
    "window_softcap": dict(bh=2, g=2, s=100, causal=True, window=13, logit_softcap=20.0, qmul=8.0),
    "segments": dict(bh=2, g=2, s=80, causal=True, segments=True),
}


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("case", list(DROPOUT_CASES))
def test_dropout_kernels_match_plain(dtype, d, rate, case):
    c = DROPOUT_CASES[case]
    rows, qmul = c["g"] * c["s"], c.get("qmul", 1.0)
    q = _randn((c["bh"], rows, d), torch.float32, 30).mul(qmul).to(dtype)
    k, v = _randn((c["bh"], c["s"], d), dtype, 31), _randn((c["bh"], c["s"], d), dtype, 32)
    do = _randn((c["bh"], rows, d), dtype, 33) * (0.25 / qmul)
    kw = dict(causal=c["causal"], scale=d**-0.5, q_seq_len=c["s"], window=c.get("window"),
              logit_softcap=c.get("logit_softcap"), dropout_rate=rate, dropout_seed=-12345,
              dropout_row_stride=c.get("row_stride"))
    seg = {}
    if c.get("segments"):
        ids = torch.full((c["bh"], c["s"]), -1, dtype=torch.int32)
        ids[0, :30], ids[0, 30:70] = 0, 1
        ids[1, :50], ids[1, 50:] = 0, 1
        seg = dict(q_segment_ids=ids.repeat(1, c["g"]), kv_segment_ids=ids)
    seg_cuda = {n: t.cuda() for n, t in seg.items()}
    o, l, m = flash.flash_attention(q.cuda(), k.cuda(), v.cuda(), save_residuals=True, **kw,
                                    **seg_cuda)
    wo, wl, wm = flash.flash_attention_plain(q.float(), k.float(), v.float(), save_residuals=True,
                                             **kw, **seg)
    torch.cuda.synchronize()
    validate_result(o, wo, TOL[dtype], name="o")
    validate_result(l, wl, 1e-5 * float(wl.abs().max()), name="l (undropped)")
    lse = (m + torch.log(torch.where(l == 0, 1.0, l))).cpu()
    args = (q, k, v, o.cpu(), lse, do)
    want = backward.flash_attention_bwd_plain(*(a.float() for a in args), **kw, **seg)
    runs = [backward.flash_attention_bwd(*(a.cuda() for a in args), fused=False, **kw, **seg_cuda)]
    if not seg:
        runs.append(backward.flash_attention_bwd(*(a.cuda() for a in args), fused=True, **kw))
    torch.cuda.synchronize()
    for got in runs:
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            validate_result(g, w, TOL[dtype], name=name)


def _mask_fns():
    return {
        "prefix_lm": lambda r, c: (c < 96) | (c <= r),
        "documents": lambda r, c: r // 64 == c // 64,
        "strided": lambda r, c: (abs(r - c) < 20) | (c % 50 == 0),
    }


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("family", ["prefix_lm", "documents", "strided"])
@pytest.mark.parametrize("s", [256, 200], ids=["s256", "ragged_s200"])
def test_block_mask_kernels_match_plain(dtype, d, family, s):
    """flash_fwd, flash_bwd_dq and flash_bwd_dkv with a block mask (built at
    S rounded up to 128 for the ragged case) against the plain versions,
    with dropout in the ragged case."""
    bm = flash.BlockMask.from_mask_fn(_mask_fns()[family], 256, 256, block_q=128, block_kv=128)
    q, k, v = (_randn((2, s, d), dtype, 40 + i) for i in range(3))
    do = _randn((2, s, d), dtype, 43) * 0.25
    kw = dict(scale=d**-0.5, block_mask=bm)
    if s == 200:
        kw.update(dropout_rate=0.2, dropout_seed=3)
    o, l, m = flash.flash_attention(q.cuda(), k.cuda(), v.cuda(), save_residuals=True, **kw)
    wo = flash.flash_attention_plain(q.float(), k.float(), v.float(), **kw)
    torch.cuda.synchronize()
    validate_result(o, wo, TOL[dtype], name="o")
    lse = (m + torch.log(torch.where(l == 0, 1.0, l))).cpu()
    args = (q, k, v, o.cpu(), lse, do)
    want = backward.flash_attention_bwd_plain(*(a.float() for a in args), **kw)
    got = backward.flash_attention_bwd(*(a.cuda() for a in args), **kw)
    torch.cuda.synchronize()
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        validate_result(g, w, TOL[dtype], name=name)


@pytest.mark.parametrize("d", [16, 128, 256])
def test_block_mask_kernels_skip_dead_tiles(d):
    """K/V rows that only dead tiles touch hold NaN: the kernels never load
    them, so every output is finite and equals the unpoisoned run's."""
    s = 512
    fn = lambda r, c: (c < 384) & ((r // 128 == c // 128) | (c < 128))  # noqa: E731
    bm = flash.BlockMask.from_mask_fn(fn, s, s, block_q=128, block_kv=128)
    q, k, v, do = (_randn((2, s, d), torch.float32, 50 + i).cuda() for i in range(4))
    outs = []
    for poison in (False, True):
        kk, vv = k.clone(), v.clone()
        if poison:
            kk[:, 384:], vv[:, 384:] = float("nan"), float("nan")
        o, l, m = flash.flash_attention(q, kk, vv, save_residuals=True, block_mask=bm)
        lse = m + torch.log(l)
        outs.append((o, *backward.flash_attention_bwd(q, kk, vv, o, lse, do, block_mask=bm)))
    torch.cuda.synchronize()
    for clean, poisoned in zip(*outs):
        assert torch.isfinite(poisoned).all()
        assert torch.equal(clean, poisoned)


# ── the measurement path: probes, the self-test, the CLIs ──────────────────


def _uniform(shape, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(shape, generator=g) * 2 - 1


@pytest.mark.parametrize("name", list(probes.D128DE_MODES))
@pytest.mark.parametrize("inputs", ["uniform", "lo_term"])
def test_probe_d128de_modes_against_plain(name, inputs):
    """The transposed-schedule and thin-shape modes (scripts/probe_d128d.py,
    probe_d128e.py) on the card against their plain versions on the CPU,
    within 2e-2 of the output's magnitude, on uniform inputs and on
    ``lo_term_qkv``'s, whose output is P's (S's) second bf16 term alone."""
    if inputs == "uniform":
        q, k, v = (_uniform((2, 384, 128), s).to(torch.bfloat16) for s in (1, 2, 3))
    else:
        q, k, v = probes.lo_term_qkv(2, 512, 128, generator=torch.Generator().manual_seed(7))
    if probes.D128DE_MODES[name].vt:
        v = v.transpose(1, 2).contiguous()
    got = probes.probe_d128de(name, q.cuda(), k.cuda(), v.cuda())
    want = probes.probe_d128de_plain(name, q, k, v)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert float((got.cpu() - want).abs().max()) <= 2e-2 * float(want.abs().max())


@pytest.mark.parametrize("mode", list(probes.FP32_MODES))
@pytest.mark.parametrize("inputs", ["uniform", "lo_term"])
def test_probe_fp32_modes_against_plain(mode, inputs):
    """Float32 as two bf16 terms (scripts/probe_small_fp32b.py) on the card
    against the plain version on the CPU: within 1e-4 of the output's
    magnitude on uniform inputs (bf16_skel: 2e-2), within 2e-2 on
    ``lo_term_qkv``'s values (the output about 2^-9 of p there; bf16_skel,
    all 0 there, of the packed skeleton's magnitude)."""
    if inputs == "uniform":
        q, k, v = (_uniform((2, 384, 64), s) for s in (4, 5, 6))
        tol = 2e-2 if mode == "bf16_skel" else 1e-4
    else:
        q, k, v = (x.float() for x in probes.lo_term_qkv(
            2, 512, 64, generator=torch.Generator().manual_seed(8)))
        tol = 2e-2
    args = probes.fp32_inputs(q, k, v, mode)
    got = probes.probe_fp32(mode, *probes.fp32_inputs(q.cuda(), k.cuda(), v.cuda(), mode))
    want = probes.probe_fp32_plain(mode, *args)
    norm = want if mode != "bf16_skel" or inputs == "uniform" else probes.probe_fp32_plain(
        "skeleton", *probes.fp32_inputs(q, k, v, "skeleton"))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert float((got.cpu() - want).abs().max()) <= tol * float(norm.abs().max())


@pytest.mark.parametrize("entry", ["decode", "prefill_batched", "prefill"])
@pytest.mark.parametrize("d,ps", [(128, 256), (64, 16), (32, 16)])
def test_f32_q_over_bf16_pages_matches_plain(entry, d, ps):
    """C4: float32 q over bf16 pages through the three paged entry points on
    the card, against the CPU path (the plain version of the bf16 form over
    q's bf16 values): float32 out, within 2e-2 of its magnitude; the
    tensor-core forms' O from float32 sums (not all bf16 values), the scalar
    form's (d = 32) through a bf16 store."""
    g = torch.Generator().manual_seed(d + ps)
    kvh, b, lens = 2, 3, [5, 200, 300]
    pps = -(-max(lens) // ps)
    pool = b * pps + 1
    kp, vp = (torch.randn((pool, kvh, ps, d), generator=g).to(torch.bfloat16) for _ in range(2))
    table = torch.randperm(pool, generator=g)[: b * pps].reshape(b, pps).to(torch.int32)
    lengths = torch.tensor(lens, dtype=torch.int32)
    if entry == "decode":
        q = torch.randn((b, kvh, 4, d), generator=g)
        run = lambda *a: decode.paged_attention(*a, scale=d**-0.5)
        args = (q, kp, vp, lengths, table)
        tc = flash.kernel_form("paged_decode", torch.bfloat16, d, page_size=ps, rows=4)
    else:
        kw = dict(chunk=5, seg=8, scale=d**-0.5)
        q = torch.randn((b, kvh, 16, d), generator=g)
        if entry == "prefill":
            run = lambda *a: decode.paged_prefill_attention(*a, **kw)
            args = (q[1], kp, vp, table[1], lengths[1])
        else:
            run = lambda *a: decode.paged_prefill_attention_batched(*a, **kw)
            args = (q, kp, vp, table, lengths)
        tc = flash.kernel_form("paged_prefill", torch.bfloat16, d, page_size=ps)
    got = run(*(x.cuda() for x in args)).cpu()
    want = run(*args)
    assert got.dtype == want.dtype == torch.float32
    assert float((got - want).abs().max()) <= 2e-2 * float(want.abs().max())
    assert torch.equal(got.to(torch.bfloat16).float(), got) == (tc == "scalar")


@pytest.mark.parametrize("name", ["mma0", "mma1", "mma2", "mma4", *probes.D128_MODES])
def test_probe_modes_against_plain(name):
    """Every d = 128 probe mode on the card against its plain version on the
    CPU, within 2e-2 of the output's magnitude."""
    q, k, v = (_randn((2, 384, 128), torch.bfloat16, s) for s in (1, 2, 3))
    if name.startswith("mma"):
        mode = int(name[3:])
        got = probes.probe_mma(mode, q.cuda(), k.cuda(), v.cuda(), causal=True)[0]
        want = probes.probe_mma_plain(mode, q, k, v, causal=True, scale=128**-0.5)[0]
    else:
        cfg = probes.D128_MODES[name]
        kk = k.transpose(1, 2).contiguous() if cfg.kt else k
        vv = v.transpose(1, 2).contiguous() if cfg.vt else v
        got = probes.probe_d128(name, q.cuda(), kk.cuda(), vv.cuda())
        want = probes.probe_d128_plain(name, q, kk, vv, scale=128**-0.5)
    err = float((got.cpu().float() - want.float()).abs().max())
    assert err <= 2e-2 * max(float(want.float().abs().max()), 1.0)


@pytest.mark.parametrize("name", ["mma0", "mma4", *probes.D128_MODES])
def test_probe_modes_keep_the_second_term(name):
    """Over ``lo_term_qkv``'s inputs at scale 1, whose output is P's second
    bf16 term alone, every d = 128 mode that feeds P (or S) to PV on the
    card against its plain version on the CPU: within 2e-2 of the output's
    magnitude (the one-term modes' all-0 output: of the two-term
    skeleton's)."""
    q, k, v = probes.lo_term_qkv(2, 512, 128, generator=torch.Generator().manual_seed(6))
    if name.startswith("mma"):
        mode = int(name[3:])
        got = probes.probe_mma(mode, q.cuda(), k.cuda(), v.cuda(), scale=1.0)[0]
        want = norm_of = probes.probe_mma_plain(mode, q, k, v, scale=1.0)[0]
    else:
        cfg = probes.D128_MODES[name]
        kk = k.transpose(1, 2).contiguous() if cfg.kt else k
        vv = v.transpose(1, 2).contiguous() if cfg.vt else v
        got = probes.probe_d128(name, q.cuda(), kk.cuda(), vv.cuda(), scale=1.0)
        want = norm_of = probes.probe_d128_plain(name, q, kk, vv, scale=1.0)
        if cfg.terms == 1:
            norm_of = probes.probe_d128_plain("skeleton", q, k, v, scale=1.0)
    norm = float(norm_of.float().abs().max())
    assert float((got.cpu().float() - want.float()).abs().max()) <= 2e-2 * norm
    from flashattention_tpu_torch.utils import selftest

    recs = []
    assert selftest.run(verbose=False, records=recs) == (21, 0, [])
    assert all(r["launches"] for r in recs)


def test_cli_rows_carry_the_card(capsys):
    import json

    from flashattention_tpu_torch.cli import bench_decode
    from flashattention_tpu_torch.utils import benchit

    bench_decode.main(["--batch", "2", "--seq_len", "512", "--kv_dtypes", "bfloat16,int8"])
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert [r["card"] for r in rows] == [benchit.card_info()] * 2
    assert all(r["valid"] and r["hbm_frac"] > 0 for r in rows)


# The float32 form (``flash_fwd_tc_f32``; in "float32" and at d = 256 in
# "bf16_3x" csrc/flash_fwd_f32.cuh's kernel): float32 q, k, v at d = 64, 128
# and 256 in the "bf16_3x" (default), "bf16" and "float32" modes, against
# its plain version on the CPU (1e-4 of the output's magnitude; "bf16":
# 2e-2) and, but in "bf16", within 1e-4 of the scalar kernel's exact
# float32.
F32_CASES = {
    "causal": dict(causal=True),
    "full": dict(causal=False),
    "gqa_fold": dict(causal=True, q_seq_len=70, q_offset=30),
    "kv_len_residuals": dict(causal=True, kv_len=177, q_offset=150, save_residuals=True),
    "window_softcap": dict(causal=True, window=50, logit_softcap=5.0),
    "segments": dict(causal=False, segments=True),
}


def _f32_case(d, case, inputs, s_kv=250):
    kw = dict(F32_CASES[case])
    rows = 210
    if inputs == "lo_term":
        q, k, v = probes.lo_term_f32_qkv(3, max(rows, s_kv), d,
                                         generator=torch.Generator().manual_seed(9))
        q, k, v = q[:, :rows].contiguous(), k[:, :s_kv].contiguous(), v[:, :s_kv].contiguous()
        scale = 1.0
    else:
        q = _randn((3, rows, d), torch.float32, 0)
        k, v = _randn((3, s_kv, d), torch.float32, 1), _randn((3, s_kv, d), torch.float32, 2)
        scale = d**-0.5
    if kw.pop("segments", False):
        g = torch.Generator().manual_seed(3)
        kw["q_segment_ids"] = torch.randint(0, 3, (3, rows), generator=g).sort(-1).values
        kw["kv_segment_ids"] = torch.randint(0, 3, (3, s_kv), generator=g).sort(-1).values
    return q, k, v, dict(scale=scale, **kw)


def _on(kw, dev):
    return {k: x.to(dev) if torch.is_tensor(x) else x for k, x in kw.items()}


def _f32_err(got, want):
    return float((got.cpu() - want).abs().max()) / float(want.abs().max())


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("mode", ["bf16_3x", "bf16", "float32"])
@pytest.mark.parametrize("case", list(F32_CASES))
@pytest.mark.parametrize("inputs", ["random", "lo_term"])
def test_f32_form_matches_plain(d, mode, case, inputs):
    q, k, v, kw = _f32_case(d, case, inputs)
    assert flash.kernel_form("flash_fwd", torch.float32, d, precision=mode) == "tc_f32"
    n = flash.flash_attention.launches_tc_f32
    got = flash.flash_attention(q.cuda(), k.cuda(), v.cuda(), precision=mode, **_on(kw, "cuda"))
    want = flash.flash_attention(q, k, v, precision=mode, **kw)
    torch.cuda.synchronize()
    assert flash.flash_attention.launches_tc_f32 == n + 1
    if kw.get("save_residuals"):
        for g, w in zip(got[1:], want[1:]):
            assert _f32_err(g, w) <= 1e-5
        got, want = got[0], want[0]
    assert got.dtype == torch.float32
    assert _f32_err(got, want) <= (2e-2 if mode == "bf16" else 1e-4)
    if mode != "bf16":  # and within 1e-4 of the scalar kernel's exact float32
        with flash.scalar_forms():
            exact = flash.flash_attention(q.cuda(), k.cuda(), v.cuda(), precision="float32",
                                          **_on(kw, "cuda"))
        exact = exact[0] if kw.get("save_residuals") else exact
        assert _f32_err(got.cuda(), exact.cpu()) <= 1e-4


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("mode", ["bf16_3x", "bf16", "float32"])
def test_f32_form_ignores_poisoned_rows(d, mode):
    """K/V rows past kv_len NaN, and a second head all NaN behind a ragged
    S (rows past S in memory): the first head's output bit for bit the
    clean inputs'."""
    q, k, v, kw = _f32_case(d, "kv_len_residuals", "random")
    kw.pop("save_residuals")
    q, k, v = (x.cuda() for x in (q, k, v))
    clean = flash.flash_attention(q, k, v, precision=mode, **kw)
    kp, vp = k.clone(), v.clone()
    kp[:, kw["kv_len"]:] = float("nan")
    vp[:, kw["kv_len"]:] = float("nan")
    qp = q.clone()
    qp[1:], kp[1:], vp[1:] = float("nan"), float("nan"), float("nan")
    got = flash.flash_attention(qp, kp, vp, precision=mode, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[0], clean[0])


def test_f32_modes_launch_their_forms():
    """Every mode launches the float32 form; "float32" (and "bf16_3x" at
    d = 256) csrc/flash_fwd_f32.cuh's kernel; the scalar kernel only under
    scalar_forms."""
    counts = lambda: (flash.flash_attention.launches,  # noqa: E731
                      flash.flash_attention.launches_tc_f32,
                      flash.flash_attention.launches_tc_f32_bf16,
                      flash.flash_attention.launches_tc_f32_split)
    for d in (64, 256):
        q = _randn((2, 128, d), torch.float32, 0).cuda()
        for mode, step in ((None, (1, 1, 0, int(d == 256))), ("bf16", (1, 1, 1, 0)),
                           ("float32", (1, 1, 0, 1))):
            before = counts()
            flash.flash_attention(q, q, q, precision=mode)
            assert tuple(a - b for a, b in zip(counts(), before)) == step, (d, mode)
        before = counts()
        with flash.scalar_forms():
            flash.flash_attention(q, q, q, precision="float32")
        assert tuple(a - b for a, b in zip(counts(), before)) == (1, 0, 0, 0)


@pytest.mark.parametrize("d,ps", [(64, 16), (128, 256), (256, 256), (256, 32)])
def test_paged_prefill_f32_form_matches_plain(d, ps):
    """Float32 q over float32 pools: chunked prefill's float32 form (GQA
    with seg > chunk, a ctx = 0 request, window + softcap at d = 256)
    against its plain version on the CPU within 1e-4, one launch counted;
    NaN in every pool row no query row may see leaves the output bitwise
    the clean pools'."""
    kvh, g, chunk, seg = 2, 2, 48, 64
    ctx_list = [0, chunk, 3 * ps + 5 if ps < 64 else 300]
    pps = -(-max(ctx_list) // ps) + 1
    pool = len(ctx_list) * pps + 2
    kp = _randn((pool, kvh, ps, d), torch.float32, 0)
    vp = _randn((pool, kvh, ps, d), torch.float32, 1)
    q = _randn((len(ctx_list), kvh, g * seg, d), torch.float32, 2)
    table = torch.randperm(pool, generator=torch.Generator().manual_seed(3))[
        : len(ctx_list) * pps].reshape(len(ctx_list), pps).int()
    ctx = torch.tensor(ctx_list, dtype=torch.int32)
    kw = dict(chunk=chunk, seg=seg, scale=d**-0.5)
    if d == 256:
        kw.update(window=40, logit_softcap=20.0)
    assert flash.kernel_form("paged_prefill", torch.float32, d, page_size=ps) == "tc_f32"
    n = decode.paged_prefill_attention_batched.launches_tc_f32
    args = (q.cuda(), kp.cuda(), vp.cuda(), table.cuda(), ctx.cuda())
    got = decode.paged_prefill_attention_batched(*args, **kw)
    want = decode.paged_prefill_attention_batched(q, kp, vp, table, ctx, **kw)
    torch.cuda.synchronize()
    assert decode.paged_prefill_attention_batched.launches_tc_f32 == n + 1
    assert got.dtype == torch.float32 and _f32_err(got, want) <= 1e-4
    used = torch.zeros(pool, dtype=torch.bool)
    for b, c in enumerate(ctx_list):
        used[table[b, : -(-c // ps)].long()] = True
    kn, vn = kp.clone(), vp.clone()
    kn[~used], vn[~used] = float("nan"), float("nan")
    for b, c in enumerate(ctx_list):  # rows past ctx_len in the last live page
        if c % ps:
            last = int(table[b, c // ps])
            kn[last, :, c % ps:], vn[last, :, c % ps:] = float("nan"), float("nan")
    poisoned = decode.paged_prefill_attention_batched(q.cuda(), kn.cuda(), vn.cuda(),
                                                      *args[3:], **kw)
    torch.cuda.synchronize()
    assert torch.equal(poisoned, got)


# Paged decode's float32 form (paged_decode_tc_f32): (G, draft_k, d, page
# size, lengths, window, softcap): a length 0 and page edges at k = 1; the
# draft form at R = 4, 8 (Gemma-2's window and softcap at d = 256) and 32.
F32_DECODE_CASES = {
    "k1_g1_d64_ps16": (1, 1, 64, 16, [0, 1, 16, 97], None, None),
    "k1_g4_d128_ps256": (4, 1, 128, 256, [255, 256, 257, 600], None, None),
    "k4_g1_d128_ps64": (1, 4, 128, 64, [4, 64, 65, 300], None, None),
    "k4_g2_d256_ps32_window_cap": (2, 4, 256, 32, [4, 100, 250, 400], 64, 30.0),
    "k4_g8_d64_ps256": (8, 4, 64, 256, [4, 70, 256, 513], None, None),
}


@pytest.mark.parametrize("case", list(F32_DECODE_CASES))
def test_paged_decode_f32_form_matches_plain(case):
    """Float32 q over float32 pages: paged decode's float32 form against its
    plain version on the CPU within 1e-4, one launch counted (and a draft
    one with k > 1), none of the scalar kernel; NaN in every pool row no
    query row may see leaves the output bitwise the clean pools'."""
    g, k, d, ps, lens, window, cap = F32_DECODE_CASES[case]
    kvh, b = 2, len(lens)
    pps = -(-max(lens) // ps) + 1
    pool = b * pps + 2
    kp = _randn((pool, kvh, ps, d), torch.float32, 0)
    vp = _randn((pool, kvh, ps, d), torch.float32, 1)
    q = _randn((b, kvh, g * k, d), torch.float32, 2)
    table = torch.randperm(pool, generator=torch.Generator().manual_seed(3))[: b * pps].reshape(
        b, pps).int()
    lengths = torch.tensor(lens, dtype=torch.int32)
    kw = dict(scale=d**-0.5, draft_k=k, window=window, logit_softcap=cap)
    assert flash.kernel_form("paged_decode", torch.float32, d, page_size=ps, rows=g * k) == "tc_f32"
    pa = decode.paged_attention
    n = (pa.launches, pa.launches_tc_f32, pa.launches_tc_f32_draft, pa.launches_tc)
    args = (q.cuda(), kp.cuda(), vp.cuda(), lengths.cuda(), table.cuda())
    got = decode.paged_attention(*args, **kw)
    want = decode.paged_attention(q, kp, vp, lengths, table, **kw)
    torch.cuda.synchronize()
    assert (pa.launches, pa.launches_tc_f32, pa.launches_tc_f32_draft, pa.launches_tc) == (
        n[0] + 1, n[1] + 1, n[2] + (k > 1), n[3])
    assert got.dtype == torch.float32 and _f32_err(got, want) <= 1e-4
    kn, vn = kp.clone(), vp.clone()
    used = torch.zeros(pool, dtype=torch.bool)
    for i, n_i in enumerate(lens):
        first = max(0, n_i - k - window + 1) if window else 0
        for j in range(pps):
            lo, hi = max(0, min(ps, first - j * ps)), max(0, min(ps, n_i - j * ps))
            page = int(table[i, j])
            used[page] = True
            for x in (kn, vn):
                x[page, :, :lo] = float("nan")
                x[page, :, max(lo, hi):] = float("nan")
    kn[~used], vn[~used] = float("nan"), float("nan")
    poisoned = decode.paged_attention(args[0], kn.cuda(), vn.cuda(), *args[3:], **kw)
    torch.cuda.synchronize()
    assert torch.equal(poisoned, got)


def test_paged_decode_f32_scalar_forms():
    """Under scalar_forms float32 pages take the exact scalar kernel, which
    agrees with the float32 form within 1e-4."""
    g = torch.Generator().manual_seed(5)
    kp, vp = (torch.randn((9, 2, 64, 128), generator=g) for _ in range(2))
    q = torch.randn((2, 2, 4, 128), generator=g)
    table = torch.arange(8, dtype=torch.int32).view(2, 4)
    lengths = torch.tensor([100, 256], dtype=torch.int32)
    args = (q.cuda(), kp.cuda(), vp.cuda(), lengths.cuda(), table.cuda())
    pa = decode.paged_attention
    tc = decode.paged_attention(*args, scale=0.1)
    n = (pa.launches, pa.launches_tc_f32)
    with flash.scalar_forms():
        exact = decode.paged_attention(*args, scale=0.1)
    torch.cuda.synchronize()
    assert (pa.launches, pa.launches_tc_f32) == (n[0] + 1, n[1])
    assert _f32_err(tc, exact.cpu()) <= 1e-4


# Float32 training's forms: the fused backward's float32 form
# (flash_bwd_tc_f32[_extra]) and the forward's dropout form
# (flash_fwd_tc_f32_extra), at d = 64 and 128 in "bf16_3x" and "bf16".
F32_TRAIN_CASES = {
    "causal_gqa": dict(bh=2, g=3, s=70, s_kv=70, causal=True),
    "full": dict(bh=3, g=1, s=96, s_kv=150, causal=False),
    "kv_len_q_offset": dict(bh=2, g=2, s=50, s_kv=130, causal=True, kv_len=77, q_offset=60),
    "window_softcap": dict(bh=2, g=3, s=100, s_kv=100, causal=True, window=13,
                           logit_softcap=20.0, qmul=8.0),
    "dropout": dict(bh=2, g=3, s=70, s_kv=70, causal=True, dropout_rate=0.1, row_stride=128),
    "dropout_window_softcap": dict(bh=2, g=2, s=100, s_kv=100, causal=True, window=13,
                                   logit_softcap=20.0, qmul=8.0, dropout_rate=0.5),
}


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("mode", ["bf16_3x", "bf16"])
@pytest.mark.parametrize("case", list(F32_TRAIN_CASES))
def test_f32_training_forms_match_plain(d, mode, case):
    """The float32 forward (its dropout form with dropout) and the fused
    backward's float32 form against their plain versions on the CPU in
    the same mode: the forward within 1e-4 of its magnitude (2e-2 in
    "bf16"), l within 1e-5 of its, the gradients within 1e-4 (below 4);
    each call launching its form once."""
    c = F32_TRAIN_CASES[case]
    rows, qmul = c["g"] * c["s"], c.get("qmul", 1.0)
    q = _randn((c["bh"], rows, d), torch.float32, 40) * qmul
    k, v = _randn((c["bh"], c["s_kv"], d), torch.float32, 41), _randn((c["bh"], c["s_kv"], d),
                                                                      torch.float32, 42)
    do = _randn((c["bh"], rows, d), torch.float32, 43) * (0.25 / qmul)
    kw = dict(causal=c["causal"], scale=d**-0.5, kv_len=c.get("kv_len"),
              q_offset=c.get("q_offset", 0), q_seq_len=c["s"], window=c.get("window"),
              logit_softcap=c.get("logit_softcap"), dropout_rate=c.get("dropout_rate"),
              dropout_seed=-12345, dropout_row_stride=c.get("row_stride"), precision=mode)
    dropout = kw["dropout_rate"] is not None
    assert backward.bwd_form(q, True, precision=mode) == "tc_f32"
    # The forward's dropout form takes d = 64 and 128; at 256 the scalar kernel.
    fwd_f32 = flash.kernel_form("flash_fwd", torch.float32, d, dropout=True,
                                precision=mode) == "tc_f32"
    fa_, fb = flash.flash_attention, backward.fused_bwd_kernel
    n = (fa_.launches_tc_f32_dropout, fb.launches, fb.launches_tc_f32, fb.launches_tc_f32_dropout)
    o, l, m = flash.flash_attention(q.cuda(), k.cuda(), v.cuda(), save_residuals=True, **kw)
    wo, wl, _ = flash.flash_attention(q, k, v, save_residuals=True, **kw)
    lse = m + torch.log(torch.where(l == 0, 1.0, l))
    args = (q, k, v, o.cpu(), lse.cpu(), do)
    got = backward.flash_attention_bwd(*(a.cuda() for a in args), fused=True, **kw)
    want = backward.flash_attention_bwd(*args, fused=True, **kw)
    torch.cuda.synchronize()
    assert (fa_.launches_tc_f32_dropout, fb.launches, fb.launches_tc_f32,
            fb.launches_tc_f32_dropout) == (n[0] + (dropout and fwd_f32), n[1] + 1, n[2] + 1,
                                             n[3] + dropout)
    assert _f32_err(o, wo) <= (2e-2 if mode == "bf16" else 1e-4)
    assert _f32_err(l, wl) <= 1e-5
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32
        validate_result(g, w, 1e-4, name=name)


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("mode", ["bf16_3x", "bf16"])
def test_f32_training_forms_keep_bits(d, mode):
    """With V and dO the identity (S = d, no mask) the forward's zeros and
    dV^T's are exactly the plain version's dropped pairs (rate 0.5)."""
    bh, rate, seed = 3, 0.5, 987
    q, k = (_randn((bh, d, d), torch.float32, s).cuda() for s in (50, 51))
    eye = torch.eye(d, device="cuda").expand(bh, d, d).contiguous()
    kw = dict(scale=d**-0.5, dropout_rate=rate, dropout_seed=seed, precision=mode)
    o, l, m = flash.flash_attention(q, k, eye, save_residuals=True, **kw)
    _, _, dv = backward.flash_attention_bwd(q, k, eye, o, m + torch.log(l), eye, **kw)
    keep = flash.dense_keep(seed, rate, range(bh), d, d, d, None, "cuda")
    torch.cuda.synchronize()
    assert torch.equal(o != 0, keep)
    assert torch.equal(dv.transpose(1, 2) != 0, keep)


@pytest.mark.parametrize("d", [64, 128, 256])
def test_f32_backward_ignores_poisoned_rows(d):
    """K/V rows past kv_len NaN, and a second head all NaN behind a ragged
    S: the first head's dK and dV bit for bit the clean inputs', dQ (float32
    atomics) within 1e-6."""
    q = _randn((2, 100, d), torch.float32, 60).cuda()
    k, v = (_randn((2, 230, d), torch.float32, s).cuda() for s in (61, 62))
    do = 0.25 * _randn((2, 100, d), torch.float32, 63).cuda()
    kw = dict(causal=True, scale=d**-0.5, kv_len=180, q_offset=80, dropout_rate=0.1,
              dropout_seed=7)
    outs = []
    for poison in (False, True):
        qp, kp, vp, dop = (x.clone() for x in (q, k, v, do))
        if poison:
            kp[:, kw["kv_len"]:], vp[:, kw["kv_len"]:] = float("nan"), float("nan")
            for x in (qp, kp, vp, dop):
                x[1:] = float("nan")
        o, l, m = flash.flash_attention(qp, kp, vp, save_residuals=True, **kw)
        outs.append(backward.flash_attention_bwd(qp, kp, vp, o, m + torch.log(l), dop, **kw))
    torch.cuda.synchronize()
    (dq0, dk0, dv0), (dq1, dk1, dv1) = outs
    assert torch.equal(dk1[0], dk0[0]) and torch.equal(dv1[0], dv0[0])
    assert float((dq1[0] - dq0[0]).abs().max()) <= 1e-6


# The two-pass pair's float32 forms (flash_bwd_dq_tc_f32, flash_bwd_dkv_tc_f32):
# (BH, G, S per group, S_kv, segment ids, kwargs); documents of 90, 150 and
# 60 tokens meet inside 64-row tiles.
PAIR_F32_CASES = {
    "segments_gqa": (2, 2, 300, 300, True, dict(causal=True)),
    "kv_len_q_offset": (2, 1, 128, 250, False, dict(causal=True, kv_len=200, q_offset=100)),
    "window_softcap_segments": (2, 1, 300, 300, True, dict(causal=True, window=100,
                                                           logit_softcap=30.0)),
    "dropout_segments": (2, 2, 300, 300, True, dict(causal=True, dropout_rate=0.1,
                                                    dropout_seed=-12345)),
    "lolo_terms": (2, 1, 256, 256, False, dict(causal=True, scale=1.0)),
}


def _pair_f32_inputs(d, case):
    bh, g, s, s_kv, segments, kw = PAIR_F32_CASES[case]
    if case == "lolo_terms":
        g = torch.Generator().manual_seed(74)
        return (*probes.lolo_term_f32_qkvdo(bh, s, d, generator=g), {}, dict(kw))
    q = _randn((bh, g * s, d), torch.float32, 70)
    k, v = _randn((bh, s_kv, d), torch.float32, 71), _randn((bh, s_kv, d), torch.float32, 72)
    do = 0.25 * _randn((bh, g * s, d), torch.float32, 73)
    kw = dict(kw, scale=d**-0.5, q_seq_len=s)
    segs = {}
    if segments:
        ids = torch.repeat_interleave(torch.arange(3, dtype=torch.int32),
                                      torch.tensor([90, 150, 60]))[:s]
        segs = dict(q_segment_ids=ids.repeat(bh, g), kv_segment_ids=ids.repeat(bh, 1))
    return q, k, v, do, segs, kw


@pytest.mark.parametrize("case", list(PAIR_F32_CASES))
@pytest.mark.parametrize("mode", ["bf16_3x", "bf16"])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_f32_pair_forms_match_plain(d, mode, case):
    """Each kernel of the pair's float32 forms against its plain version on
    the CPU in the same mode (four products a matmul at d = 64 in
    "bf16_3x", three at 128 and 256): the gradients within 1e-4 and, on
    ``probes.lolo_term_f32_qkvdo``'s inputs in "bf16_3x" (where lo lo moves
    each gradient by 2.5e-3 of its norm and more), within 1e-4 of each
    gradient's norm; each launch in its float32 form; dQ twice on its own
    bit for bit the same."""
    q, k, v, do, segs, kw = _pair_f32_inputs(d, case)
    assert backward.bwd_form(q, False, precision=mode) == "tc_f32"
    o, l, m = flash.flash_attention(q, k, v, save_residuals=True, precision=mode, **kw, **segs)
    lse = m + torch.log(torch.where(l == 0, 1.0, l))
    di = (o * do).sum(dim=-1)
    cuda = [x.cuda() for x in (q, k, v, do, lse, di)]
    csegs = {n: x.cuda() for n, x in segs.items()}
    fns = (backward.dq_kernel, backward.dkv_kernel)
    n = [(f.launches_tc_f32, f.launches_tc_f32_dropout) for f in fns]
    dq = backward.dq_kernel(*cuda, precision=mode, **kw, **csegs)
    dk, dv = backward.dkv_kernel(*cuda, precision=mode, **kw, **csegs)
    want = (backward.dq_kernel(q, k, v, do, lse, di, precision=mode, **kw, **segs),
            *backward.dkv_kernel(q, k, v, do, lse, di, precision=mode, **kw, **segs))
    again = backward.dq_kernel(*cuda, precision=mode, **kw, **csegs)
    torch.cuda.synchronize()
    drop = int("dropout_rate" in kw)
    assert [(f.launches_tc_f32, f.launches_tc_f32_dropout) for f in fns] == [
        (n[0][0] + 2, n[0][1] + 2 * drop), (n[1][0] + 1, n[1][1] + drop)]
    assert torch.equal(dq, again)
    for name, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert g.dtype == torch.float32
        validate_result(g, w, 1e-4, name=name)
        if mode == "bf16_3x" and case == "lolo_terms":
            rel = float((g.cpu().double() - w.double()).norm() / w.double().norm())
            assert rel <= 1e-4, (name, rel)


@pytest.mark.parametrize("d", [64, 128])
def test_f32_pair_ignores_poisoned_rows(d):
    """K/V rows past kv_len NaN, and a second head all NaN behind a ragged
    S, with dropout, through the pair (flash_attention_bwd(fused=False)):
    the first head's dQ, dK and dV bit for bit the clean inputs'."""
    q = _randn((2, 100, d), torch.float32, 80).cuda()
    k, v = (_randn((2, 230, d), torch.float32, s).cuda() for s in (81, 82))
    do = 0.25 * _randn((2, 100, d), torch.float32, 83).cuda()
    kw = dict(causal=True, scale=d**-0.5, kv_len=180, q_offset=80, dropout_rate=0.1,
              dropout_seed=7)
    outs = []
    for poison in (False, True):
        qp, kp, vp, dop = (x.clone() for x in (q, k, v, do))
        if poison:
            kp[:, kw["kv_len"]:], vp[:, kw["kv_len"]:] = float("nan"), float("nan")
            for x in (qp, kp, vp, dop):
                x[1:] = float("nan")
        o, l, m = flash.flash_attention(qp, kp, vp, save_residuals=True, **kw)
        outs.append(backward.flash_attention_bwd(qp, kp, vp, o, m + torch.log(l), dop,
                                                 fused=False, **kw))
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        assert torch.equal(b[0], a[0])
