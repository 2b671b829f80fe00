"""The kernel differential battery, run on the card's kernels.

Counterpart of ``flashattention_tpu/utils/selftest.py`` (``CHECKS`` :463,
``run`` :490): the same 21 checks, with the same names, shapes, seeds and
tolerances (``TOL_FP32`` 1e-4, ``TOL_BF16`` 2e-2, 5e-4 for gradients, 5e-2
over int8 K/V), each holding a hand-written kernel against a dense oracle
(``ops.reference``) or against another launch.  The JAX battery re-runs the
interpreter-tested Pallas kernels compiled; this one runs the CUDA kernels,
which the CPU suite reaches only through their plain versions.

Every check takes ``device`` (the card by default, ``"cpu"`` for the plain
versions).  On the card it also asserts that the kernel it is named for was
launched (the ops' launch counters, the ones ``chip_smoke.py`` reads), so a
plain version can never pass for the kernel.

Some checks name a TPU form: ``lane_packed_d32`` / ``_d64`` (float32 as
bf16 hi/lo pairs in idle MXU lanes), ``block_h_batched`` (several heads a
grid step), ``windowed_tri_grid`` / ``tri_grid_deep`` (the triangular pair
grid), ``one_shot_stateless`` (one KV block, no scratch) and
``traced_offsets`` (scalar-prefetched q_offset / kv_len).  Each keeps its
function and shape, and the H100 kernel runs it in whichever form it takes:
float32 at d = 64 and 128 runs the JAX default precision, ``"bf16_3x"``, on
the forward's float32 tensor-core form (``fwd_fp32_default`` and
``lane_packed_d64`` assert that form's launch), float32 at d = 32 the exact
kernel, the forward has one tile shape (the TPU block sizes are not
passed), a causal grid skips the tiles past the diagonal, and q_offset /
kv_len are launch arguments.
``one_shot_stateless`` and ``block_h_batched`` therefore compare two
launches of one kernel at the same inputs (equal bits), where the TPU
compares two block configurations.  ``traced_offsets`` asks for kv_len =
700 over 512 keys, which in the JAX check masks nothing (and poisons
nothing); the port's ``flash_attention`` takes kv_len up to S_kv, so the
check passes S_kv, the same function.
"""

from __future__ import annotations

import contextlib

import torch

from flashattention_tpu_torch.utils.device import resolve_device
from flashattention_tpu_torch.utils.testing import (
    TOL_BF16,
    TOL_FP32,
    make_random,
    validate_result,
)

__all__ = ["run", "CHECKS"]


def _counters():
    """Launch counters by kernel name: ``(wrapper, attribute)``."""
    from flashattention_tpu_torch.ops import backward, decode, flash

    return {
        "flash_fwd": (flash.flash_attention, "launches"),
        "flash_fwd_quant": (flash.flash_attention, "launches_quantized"),
        "flash_fwd_dropout": (flash.flash_attention, "launches_dropout"),
        "flash_fwd_block_mask": (flash.flash_attention, "launches_block_mask"),
        "flash_fwd_tc_f32": (flash.flash_attention, "launches_tc_f32"),
        "flash_bwd": (backward.fused_bwd_kernel, "launches"),
        "flash_bwd_dq": (backward.dq_kernel, "launches"),
        "flash_bwd_dkv": (backward.dkv_kernel, "launches"),
        "paged_decode": (decode.paged_attention, "launches"),
        "paged_decode_quant": (decode.paged_attention, "launches_quantized"),
        "paged_prefill": (decode.paged_prefill_attention_batched, "launches"),
    }


def _read(name):
    fn, attr = _counters()[name]
    return getattr(fn, attr)


@contextlib.contextmanager
def _launches(device, *names):
    """On the card, assert that each kernel in ``names`` was launched
    inside the block."""
    before = {n: _read(n) for n in names}
    yield
    if device.type == "cuda":
        missing = [n for n in names if _read(n) == before[n]]
        if missing:
            raise AssertionError(f"kernel(s) {missing} not launched")


def _gen(seed, device):
    return torch.Generator(device=device).manual_seed(seed)


def _qkv(shape, dtype=torch.float32, seed=0, n=3, device=None):
    g = _gen(seed, device)
    return tuple(make_random(g, shape, dtype) for _ in range(n))


def _ops():
    from flashattention_tpu_torch.ops import backward, decode, flash, quant, reference

    return flash, backward, decode, quant, reference


def check_fwd_fp32_default(device=None):
    """fp32 at the JAX default precision ("bf16_3x": the float32
    tensor-core form), non-causal."""
    dev = resolve_device(device)
    flash, _, _, _, ref = _ops()
    q, k, v = _qkv((4, 1024, 64), seed=1, device=dev)
    with _launches(dev, "flash_fwd_tc_f32"):
        o = flash.flash_attention(q, k, v)
    validate_result(o, ref.attention_reference(q, k, v), TOL_FP32)


def check_fwd_bf16_causal(device=None):
    """Native bf16, causal (the tensor-core kernel, tiles past the diagonal
    skipped)."""
    dev = resolve_device(device)
    flash, _, _, _, ref = _ops()
    q, k, v = _qkv((4, 1024, 64), torch.bfloat16, seed=2, device=dev)
    with _launches(dev, "flash_fwd"):
        o = flash.flash_attention(q, k, v, causal=True)
    validate_result(o, ref.attention_reference(q, k, v, causal=True), TOL_BF16)


def check_fwd_window_softcap_gqa(device=None):
    """Sliding window + logit softcap + GQA row folding, one kernel."""
    dev = resolve_device(device)
    flash, _, _, _, ref = _ops()
    b, kvh, g, s, d = 1, 2, 2, 512, 64
    q = make_random(_gen(3, dev), (b * kvh, g * s, d))
    k, v = _qkv((b * kvh, s, d), seed=4, n=2, device=dev)
    with _launches(dev, "flash_fwd"):
        o = flash.flash_attention(q, k, v, causal=True, window=200, logit_softcap=30.0,
                                  q_seq_len=s)
    want = ref.attention_reference(
        q.reshape(b * kvh * g, s, d), k.repeat_interleave(g, dim=0),
        v.repeat_interleave(g, dim=0), causal=True, window=200, logit_softcap=30.0)
    validate_result(o.reshape(b * kvh * g, s, d), want, TOL_FP32)


def check_fwd_traced_offsets(device=None):
    """q_offset and kv_len as launch arguments, padding poisoned with NaN."""
    dev = resolve_device(device)
    flash, _, _, _, ref = _ops()
    q, k, v = _qkv((2, 512, 64), seed=5, device=dev)
    kv_len, q_offset = 700, 444
    kbad, vbad = k.clone(), v.clone()
    kbad[:, kv_len:] = float("nan")  # past S: poisons nothing, as in the JAX check
    vbad[:, kv_len:] = float("nan")
    with _launches(dev, "flash_fwd"):
        o = flash.flash_attention(q[:, :256].contiguous(), kbad, vbad, causal=True,
                                  q_offset=q_offset, kv_len=min(kv_len, k.shape[1]))
    want = ref.attention_reference(q[:, :256], k[:, :kv_len], v[:, :kv_len], causal=True,
                                   q_offset=q_offset)
    validate_result(o, want, TOL_FP32)


def check_fwd_lane_packed_d32(device=None):
    """fp32 at d = 32 (the TPU's lane-packed hi/lo form; here the exact
    kernel, the float32 tensor-core form being built at d = 64 and 128)."""
    dev = resolve_device(device)
    flash, _, _, _, ref = _ops()
    q, k, v = _qkv((4, 1024, 32), seed=6, device=dev)
    with _launches(dev, "flash_fwd"):
        o = flash.flash_attention(q, k, v)
    validate_result(o, ref.attention_reference(q, k, v), TOL_FP32)


def check_fwd_block_h_batched(device=None):
    """16 heads at a small S (the TPU's block_h head batching): the oracle,
    and two launches with equal bits (the TPU compares block_h 8 and 1)."""
    dev = resolve_device(device)
    flash, _, _, _, ref = _ops()
    q, k, v = _qkv((16, 512, 64), seed=10, device=dev)
    with _launches(dev, "flash_fwd"):
        o = flash.flash_attention(q, k, v)
        o1 = flash.flash_attention(q, k, v)
    validate_result(o, ref.attention_reference(q, k, v), TOL_FP32)
    assert torch.equal(o, o1), "two launches of one head batch diverged"


def check_fwd_windowed_tri_grid(device=None):
    """Sliding-window causal: each query tile starts at its first in-window
    KV tile (the TPU's triangular pair grid)."""
    dev = resolve_device(device)
    flash, _, _, _, ref = _ops()
    q, k, v = _qkv((2, 1024, 64), seed=11, device=dev)
    with _launches(dev, "flash_fwd"):
        o = flash.flash_attention(q, k, v, causal=True, window=256)
    want = ref.attention_reference(q, k, v, causal=True, window=256)
    validate_result(o, want, TOL_FP32)


def check_fwd_dropout(device=None):
    """Attention dropout: the kernel's keep bits must be the oracle mask's
    bit for bit (``dropout_keep_mask``, the JAX package's hash)."""
    dev = resolve_device(device)
    flash, _, _, _, _ = _ops()
    q, k, v = _qkv((4, 512, 64), seed=13, device=dev)
    rate, seed = 0.2, 77
    with _launches(dev, "flash_fwd_dropout"):
        o = flash.flash_attention(q, k, v, causal=True, dropout_rate=rate, dropout_seed=seed)
    s_ = torch.einsum("bqd,bkd->bqk", q, k)
    mask = torch.arange(512, device=dev)[:, None] >= torch.arange(512, device=dev)[None, :]
    s_ = torch.where(mask[None], s_, -1e30)
    p = torch.softmax(s_, dim=-1)
    keeps = torch.stack([flash.dropout_keep_mask(seed, b, 0, 0, (512, 512), rate, device=dev)
                         for b in range(4)])
    z = torch.where(keeps, p, 0.0) / (1 - rate)
    validate_result(o, torch.einsum("bqk,bkd->bqd", z, v), TOL_FP32)


def check_fwd_segments(device=None):
    """Packed-sequence segment masking: packed row slices == each document
    attended alone."""
    dev = resolve_device(device)
    flash, _, _, _, _ = _ops()
    q, k, v = _qkv((2, 512, 64), seed=14, device=dev)
    seg = torch.cat([torch.zeros(256, dtype=torch.int32), torch.ones(256, dtype=torch.int32)])
    segs = seg.to(dev).expand(2, 512).contiguous()
    with _launches(dev, "flash_fwd"):
        packed = flash.flash_attention(q, k, v, causal=True, q_segment_ids=segs,
                                       kv_segment_ids=segs)
    for sl in (slice(0, 256), slice(256, 512)):
        solo = flash.flash_attention(q[:, sl].contiguous(), k[:, sl].contiguous(),
                                     v[:, sl].contiguous(), causal=True)
        validate_result(packed[:, sl], solo, TOL_FP32, name=f"slice {sl}")


def check_backward_dropout_segments(device=None):
    """The two-pass backward regenerates the dropout and segment masks:
    gradients against autograd through the explicit-mask oracle."""
    dev = resolve_device(device)
    flash, backward, _, _, _ = _ops()
    s, d, rate, seed = 256, 64, 0.15, 5
    q, k, v = _qkv((2, s, d), seed=15, device=dev)
    t = make_random(_gen(16, dev), (2, s, d))
    seg = torch.cat([torch.zeros(128, dtype=torch.int32),
                     torch.ones(128, dtype=torch.int32)]).to(dev)
    segs = seg.expand(2, s).contiguous()
    keeps = torch.stack([flash.dropout_keep_mask(seed, b, 0, 0, (s, s), rate, device=dev)
                         for b in range(2)])

    def loss_fa(q, k, v):
        o = backward.attention_vjp(q, k, v, True, 1.0, None, None, False, None, None, None,
                                   rate, seed, segs, segs)
        return (o * t).sum()

    def loss_or(q, k, v):
        sc = torch.einsum("bqd,bkd->bqk", q, k)
        m = (seg[:, None] == seg[None, :]) & (
            torch.arange(s, device=dev)[:, None] >= torch.arange(s, device=dev)[None, :])
        sc = torch.where(m[None], sc, -1e30)
        z = torch.where(keeps, torch.softmax(sc, dim=-1), 0.0) / (1 - rate)
        return (torch.einsum("bqk,bkd->bqd", z, v) * t).sum()

    with _launches(dev, "flash_bwd_dq", "flash_bwd_dkv"):
        g_fa = _grad(loss_fa, q, k, v)
    g_or = _grad(loss_or, q, k, v)
    for name, a, b in zip(("dq", "dk", "dv"), g_fa, g_or):
        validate_result(a, b, 5e-4, name=name)


def _grad(loss, q, k, v):
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    return torch.autograd.grad(loss(*leaves), leaves)


def _backward_vs_oracle(dev, d, seed, t_seed):
    flash, backward, _, _, ref = _ops()
    q, k, v = _qkv((2, 512, d), seed=seed, device=dev)
    t = make_random(_gen(t_seed, dev), (2, 512, d))
    with _launches(dev, "flash_fwd", "flash_bwd"):
        o, l, m = flash.flash_attention(q, k, v, causal=True, save_residuals=True)
        lse = m + torch.log(l)
        dq, dk, dv = backward.flash_attention_bwd(q, k, v, o, lse, t, causal=True)
    want = _grad(lambda q, k, v: (ref.attention_reference(q, k, v, causal=True) * t).sum(),
                 q, k, v)
    validate_result(dq, want[0], 5e-4, name="dq")
    validate_result(dk, want[1], 5e-4, name="dk")
    validate_result(dv, want[2], 5e-4, name="dv")


def check_backward(device=None):
    """The backward dQ/dK/dV (the fused kernel, the default without
    segment ids) against autograd of the oracle, causal fp32."""
    _backward_vs_oracle(resolve_device(device), 64, 7, 8)


def check_paged_prefill_batched(device=None):
    """Batched chunked prefill == per-request launches, bit for bit."""
    dev = resolve_device(device)
    _, _, decode, _, _ = _ops()
    kvh, d, ps, pps, chunk, P = 2, 64, 64, 4, 128, 16
    g = _gen(12, dev)
    kp = make_random(g, (P, kvh, ps, d), torch.bfloat16)
    vp = make_random(g, (P, kvh, ps, d), torch.bfloat16)
    q = make_random(g, (3, kvh, chunk, d), torch.bfloat16)
    ctx = torch.tensor([256, 128, 0], dtype=torch.int32, device=dev)  # prefix+chunk, chunk, dummy
    pi = ((torch.arange(3 * pps, dtype=torch.int32, device=dev).reshape(3, pps) * 5) % P)
    with _launches(dev, "paged_prefill"):
        ob = decode.paged_prefill_attention_batched(q, kp, vp, pi, ctx, chunk=chunk, scale=0.5)
    for b in range(2):
        o1 = decode.paged_prefill_attention(q[b], kp, vp, pi[b], int(ctx[b]), chunk=chunk,
                                            scale=0.5)
        assert torch.equal(ob[b], o1), f"batched row {b} diverged"


def check_paged_decode_int8(device=None):
    """Paged decode over int8 pages with per-row scales against the dense
    paged oracle over the dequantized pages."""
    dev = resolve_device(device)
    _, _, decode, quant, _ = _ops()
    b, kvh, g, d, ps, pps = 2, 2, 2, 128, 256, 2
    gen = _gen(9, dev)
    q = make_random(gen, (b, kvh, g, d))
    kq = quant.quantize(make_random(gen, (b * pps + 1, kvh, ps, d)), "int8")
    vq = quant.quantize(make_random(gen, (b * pps + 1, kvh, ps, d)), "int8")
    lengths = torch.tensor([ps * pps, ps + 17], dtype=torch.int32, device=dev)
    pi = torch.arange(b * pps, dtype=torch.int32, device=dev).reshape(b, pps)
    with _launches(dev, "paged_decode_quant"):
        o = decode.paged_attention(q, kq.payload, vq.payload, lengths, pi,
                                   k_scales_pages=kq.scales, v_scales_pages=vq.scales)
    want = decode.paged_attention_reference(q, quant.dequantize(kq), quant.dequantize(vq),
                                            lengths, pi)
    validate_result(o, want, 5e-2)


def check_fwd_tri_grid_deep(device=None):
    """Causal bf16 at depth (S = 4096; the TPU's triangular grid)."""
    dev = resolve_device(device)
    flash, _, _, _, ref = _ops()
    q, k, v = _qkv((2, 4096, 64), torch.bfloat16, seed=20, device=dev)
    with _launches(dev, "flash_fwd"):
        o = flash.flash_attention(q, k, v, causal=True)
    validate_result(o, ref.attention_reference(q, k, v, causal=True), TOL_BF16)


def check_backward_d128(device=None):
    """The backward at the flagship head_dim (d = 128), causal fp32."""
    _backward_vs_oracle(resolve_device(device), 128, 21, 22)


def check_fwd_block_mask(device=None):
    """Block-sparse masks: a prefix-LM family with partial tiles."""
    dev = resolve_device(device)
    flash, _, _, _, ref = _ops()

    def prefix_lm(r, c):
        return (c < 192) | (c <= r)

    q, k, v = _qkv((2, 512, 64), seed=23, device=dev)
    bm = flash.BlockMask.from_mask_fn(prefix_lm, 512, 512, block_q=128, block_kv=128)
    with _launches(dev, "flash_fwd_block_mask"):
        o = flash.flash_attention(q, k, v, block_mask=bm)
    sc = torch.einsum("bqd,bkd->bqk", q, k)
    rows = torch.arange(512, device=dev)[:, None]
    cols = torch.arange(512, device=dev)[None, :]
    sc = torch.where(prefix_lm(rows, cols)[None], sc, ref.DEFAULT_MASK_VALUE)
    want = torch.einsum("bqk,bkd->bqd", torch.softmax(sc, -1), v)
    validate_result(o, want, TOL_FP32)


def check_fwd_quantized_kv(device=None):
    """int8 K/V with the dequantization fused == attention over the
    dequantized K/V."""
    dev = resolve_device(device)
    flash, _, _, quant, ref = _ops()
    q, k, v = _qkv((2, 512, 64), seed=24, device=dev)
    kq, vq = quant.quantize_kv(k, v, "int8")
    with _launches(dev, "flash_fwd_quant"):
        o = flash.flash_attention(q, kq.payload, vq.payload, kq.scales, vq.scales, causal=True)
    want = ref.attention_reference(q, quant.dequantize(kq), quant.dequantize(vq), causal=True)
    validate_result(o, want, 5e-2)  # int8 payload noise dominates


def check_fwd_one_shot_stateless(device=None):
    """bf16 at S = 1024 (the TPU's one-KV-block path): the oracle, and a
    second launch within the bf16 gate."""
    dev = resolve_device(device)
    flash, _, _, _, ref = _ops()
    q, k, v = _qkv((4, 1024, 64), torch.bfloat16, seed=25, device=dev)
    with _launches(dev, "flash_fwd"):
        one = flash.flash_attention(q, k, v)
        again = flash.flash_attention(q, k, v)
    validate_result(one, ref.attention_reference(q, k, v), TOL_BF16)
    validate_result(one, again, TOL_BF16, name="one_shot vs scratch")


def check_fwd_lane_packed_d64(device=None):
    """fp32 at d = 64 with the softmax statistics (the TPU's 2-pass hi/lo
    packing and its MXU row sum; here the float32 tensor-core form's
    four-product "bf16_3x")."""
    dev = resolve_device(device)
    flash, _, _, _, ref = _ops()
    q, k, v = _qkv((4, 1024, 64), seed=26, device=dev)
    with _launches(dev, "flash_fwd_tc_f32"):
        o, l, m = flash.flash_attention(q, k, v, save_residuals=True)
    want, lw, mw = ref.attention_reference_with_stats(q, k, v)
    validate_result(o, want, TOL_FP32)
    validate_result(l, lw, 1e-3, name="l")
    validate_result(m, mw, 1e-4, name="m")


def check_decode_bf16(device=None):
    """Paged decode over bf16 pages (the plain payload path and the GQA
    head layout)."""
    dev = resolve_device(device)
    _, _, decode, _, _ = _ops()
    b, kvh, g, d, ps, pps = 2, 2, 4, 128, 256, 2
    gen = _gen(27, dev)
    q = make_random(gen, (b, kvh, g, d), torch.bfloat16)
    kp = make_random(gen, (b * pps + 1, kvh, ps, d), torch.bfloat16)
    vp = make_random(gen, (b * pps + 1, kvh, ps, d), torch.bfloat16)
    lengths = torch.tensor([ps * pps, ps + 31], dtype=torch.int32, device=dev)
    pi = torch.arange(b * pps, dtype=torch.int32, device=dev).reshape(b, pps)
    with _launches(dev, "paged_decode"):
        o = decode.paged_attention(q, kp, vp, lengths, pi)
    want = decode.paged_attention_reference(q, kp, vp, lengths, pi)
    validate_result(o, want, TOL_BF16)


def check_fwd_large_head_dim(device=None):
    """d = 256 (the wide-head path), causal bf16."""
    dev = resolve_device(device)
    flash, _, _, _, ref = _ops()
    q, k, v = _qkv((2, 512, 256), torch.bfloat16, seed=28, device=dev)
    with _launches(dev, "flash_fwd"):
        o = flash.flash_attention(q, k, v, causal=True)
    validate_result(o, ref.attention_reference(q, k, v, causal=True), TOL_BF16)


CHECKS = [
    check_fwd_fp32_default,
    check_fwd_bf16_causal,
    check_fwd_window_softcap_gqa,
    check_fwd_traced_offsets,
    check_fwd_lane_packed_d32,
    check_fwd_block_h_batched,
    check_fwd_windowed_tri_grid,
    check_fwd_dropout,
    check_fwd_segments,
    check_backward_dropout_segments,
    check_backward,
    check_paged_prefill_batched,
    check_paged_decode_int8,
    check_fwd_tri_grid_deep,
    check_backward_d128,
    check_fwd_block_mask,
    check_fwd_quantized_kv,
    check_fwd_one_shot_stateless,
    check_fwd_lane_packed_d64,
    check_decode_bf16,
    check_fwd_large_head_dim,
]


def run(verbose: bool = True, *, device=None, records: list | None = None):
    """Run the battery on ``device`` (the card by default); returns
    ``(passed, failed, [(name, error), ...])``, every failure by name.
    ``records``, if given, gets one dict a check: its name, ``ok``, the
    error, and the launches of each kernel counter during it."""
    dev = resolve_device(device)
    counters = _counters()
    passed, failures = 0, []
    for fn in CHECKS:
        name = fn.__name__
        before = {k: getattr(f, a) for k, (f, a) in counters.items()}
        error = None
        try:
            fn(dev)
            passed += 1
            if verbose:
                print(f"  selftest {name}: PASS", flush=True)
        except Exception as e:  # noqa: BLE001 — report, don't mask, any failure
            error = f"{type(e).__name__}: {e}"
            failures.append((name, error))
            if verbose:
                print(f"  selftest {name}: FAIL {error}", flush=True)
        if records is not None:
            launched = {k: getattr(f, a) - before[k] for k, (f, a) in counters.items()}
            records.append({"check": name, "ok": error is None, "error": error,
                            "launches": {k: n for k, n in launched.items() if n}})
    return passed, len(failures), failures


if __name__ == "__main__":
    import sys

    p, f, errs = run()
    print(f"selftest on the card: {p} passed, {f} failed")
    sys.exit(1 if f else 0)
