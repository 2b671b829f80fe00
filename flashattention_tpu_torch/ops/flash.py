"""Flash-attention forward on folded ``(BH, R, d)`` tensors.

Counterpart of ``flashattention_tpu/ops/flash.py::flash_attention`` (:1127).
On a CUDA tensor it launches the hand-written kernel in
``csrc/flash_fwd.cu``, which replaces the Pallas ``_kernel`` (:628); on a CPU
tensor it runs :func:`flash_attention_plain`, the same function in plain
PyTorch.  There is no fallback between the two: a CUDA call either launches
the kernel or raises.

Supported: causal masking at absolute query position
``q_offset + (r mod q_seq_len)`` (the GQA row fold), a sliding window (a row
at position ``pos`` sees columns ``c > pos - window``), a logit softcap
(``s -> cap * tanh(s / cap)`` after the scale, before the masks), a live KV
length ``kv_len`` (ragged S is masked in the kernel, never padded), a score
scale, segment ids (packed rows: row r sees column c only where their ids are
equal; ``PAD_SEGMENT`` padding rows attend each other, as in the JAX
kernel), ``save_residuals``, and 8-bit K/V: int8 or fp8 payloads with
float32 per-row scales ``(BH, S_kv)`` (``k_scales``/``v_scales``), which a
form of the kernel built for them dequantizes as it stages each tile
(:func:`ops.quant.attention_quantized` is the public entry point).  The TPU tile-fitting regimes of
``BlockSizes.fit`` are not ported: the CUDA kernel has one tile shape.

:func:`flash_attention_naive` is the counterpart of the JAX package's naive
Pallas kernel (``_naive_kernel``, :1690): dense softmax over the whole KV
stripe, float32 throughout, the independent cross-check of the flash kernel.
On a CUDA tensor it launches ``csrc/flash_naive.cu``; on a CPU tensor it runs
:func:`flash_attention_naive_plain`.
"""

from __future__ import annotations

import dataclasses

import torch

from flashattention_tpu_torch.ops import kernels
from flashattention_tpu_torch.ops.reference import (
    DEFAULT_MASK_VALUE,
    attention_reference,
    dequantize_rows,
    softcap,
)

__all__ = [
    "BlockSizes",
    "flash_attention",
    "flash_attention_naive",
    "flash_attention_naive_plain",
    "flash_attention_plain",
]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# K/V payload type codes of the C interface: q's own type, or 8-bit payloads
# with float32 scales.
KV_DTYPES = {**_DTYPES, torch.int8: 2, torch.float8_e4m3fn: 3}
_HEAD_DIMS = (16, 32, 64, 128, 256)


@dataclasses.dataclass(frozen=True)
class BlockSizes:
    """Tile shape of the CUDA kernel: ``block_q`` query rows per block and
    ``block_kv`` KV rows per shared-memory tile.  The kernel is compiled for
    this one shape (``kBlockQ``/``kBlockKV`` in ``csrc/flash_fwd.cu``)."""

    block_q: int = 64
    block_kv: int = 32


def _unsupported(feature: str, slice_: str):
    raise NotImplementedError(f"{feature} is not ported yet: it comes with {slice_}")


def check_ported(*, dropout_rate=None, block_mask=None):
    """Raise ``NotImplementedError`` for an option of the JAX package that
    the forward kernel does not have yet."""
    if dropout_rate:
        _unsupported("attention dropout", "the attention-dropout slice (bit-for-bit keep masks)")
    if block_mask is not None:
        _unsupported("block-sparse masks", "the block-sparse slice")


def check_kv(q, k, v, k_scales, v_scales, scales_shape) -> bool:
    """Check the K/V payload types against q and the scales, and return
    whether K/V are quantized: 8-bit (int8 or fp8) payloads of one type with
    float32 scales of ``scales_shape``, both given; or q's type and no
    scales."""
    if (k_scales is None) != (v_scales is None):
        raise ValueError("k_scales and v_scales must be given together")
    if k_scales is None:
        if not (q.dtype == k.dtype == v.dtype):
            raise ValueError(f"q/k/v dtypes differ: {q.dtype} {k.dtype} {v.dtype}")
        return False
    if k.dtype != v.dtype or k.dtype not in (torch.int8, torch.float8_e4m3fn):
        raise ValueError(f"quantized K/V must be int8 or float8_e4m3fn, got {k.dtype} / {v.dtype}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"q must be float32 or bfloat16 with quantized K/V, got {q.dtype}")
    for name, sc in (("k_scales", k_scales), ("v_scales", v_scales)):
        if tuple(sc.shape) != tuple(scales_shape) or sc.dtype != torch.float32:
            raise ValueError(
                f"{name} must be float32 {tuple(scales_shape)}, got {sc.dtype} {tuple(sc.shape)}"
            )
    return True


def fold_segment_ids(q_segment_ids, kv_segment_ids, bh, rows, s_kv, device):
    """Check the ``(BH, R)`` and ``(BH, S_kv)`` segment ids of a folded
    call (flash.py:1295-1309) and return them as contiguous int32 tensors on
    ``device``, or ``(None, None)``."""
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError("q_segment_ids and kv_segment_ids must be given together")
    if q_segment_ids is None:
        return None, None
    if tuple(q_segment_ids.shape) != (bh, rows):
        raise ValueError(
            f"q_segment_ids must be (BH, S_q)=({bh}, {rows}), got {tuple(q_segment_ids.shape)}"
        )
    if tuple(kv_segment_ids.shape) != (bh, s_kv):
        raise ValueError(
            f"kv_segment_ids must be (BH, S_kv)=({bh}, {s_kv}), got {tuple(kv_segment_ids.shape)}"
        )
    return (
        q_segment_ids.to(device=device, dtype=torch.int32).contiguous(),
        kv_segment_ids.to(device=device, dtype=torch.int32).contiguous(),
    )


def check_window(window, logit_softcap, causal):
    """Raise ``ValueError`` for a window without causal masking (flash.py:1159)
    or a window or softcap that is not positive."""
    if window is not None and (not causal or int(window) < 1):
        raise ValueError(f"window ({window}) must be >= 1 and requires causal=True")
    if logit_softcap is not None and not logit_softcap > 0:
        raise ValueError(f"logit_softcap must be > 0, got {logit_softcap}")


def kernel_options(window, logit_softcap):
    """The C interface's window (-1: none) and softcap (0: none)."""
    return (-1 if window is None else int(window),
            0.0 if logit_softcap is None else float(logit_softcap))


def visible(rows, s_kv, *, causal, kv_len, q_offset, q_seq_len, q_segment_ids=None,
            kv_segment_ids=None, window=None, device=None):
    """Boolean mask of the (query row, key column) pairs the kernels keep:
    ``(R, S_kv)``, or ``(BH, R, S_kv)`` with segment ids."""
    cols = torch.arange(s_kv, device=device)
    mask = (cols < kv_len)[None, :]
    if causal:
        pos = q_offset + torch.arange(rows, device=device) % q_seq_len
        mask = mask & (cols[None, :] <= pos[:, None])
        if window is not None:
            mask = mask & (cols[None, :] > pos[:, None] - window)
    if q_segment_ids is not None:
        mask = mask & (q_segment_ids[:, :, None] == kv_segment_ids[:, None, :])
    return mask


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    scale: float = 1.0,
    kv_len: int | None = None,
    q_offset: int = 0,
    q_seq_len: int | None = None,
    save_residuals: bool = False,
    block_sizes: BlockSizes | None = None,
    window: int | None = None,
    logit_softcap: float | None = None,
    dropout_rate: float | None = None,
    q_segment_ids=None,
    kv_segment_ids=None,
    k_scales=None,
    v_scales=None,
    block_mask=None,
):
    """Fused attention forward ``O = softmax(scale * Q K^T) V``.

    Args:
      q: ``(BH, R, d)``; k, v: ``(BH, S_kv, d)``, one dtype (float32 or
        bfloat16), contiguous.
      causal: query row r sits at position ``q_offset + (r mod q_seq_len)``
        and attends KV columns at or before it.
      kv_len: KV columns at or past it are masked (None: all ``S_kv``).
      q_seq_len: GQA row fold — q holds ``R // q_seq_len`` query-head groups
        stacked along the rows, all attending the same K/V.
      save_residuals: also return ``(l, m)``, float32, each ``(BH, R)``.
      window: sliding window (causal only): row r sees columns
        ``c > pos - window``.
      logit_softcap: scores become ``cap * tanh(s / cap)`` before the masks.
      q_segment_ids, kv_segment_ids: integer ``(BH, R)`` and ``(BH, S_kv)``,
        given together: row r sees column c only where the ids are equal.
      k_scales, v_scales: float32 ``(BH, S_kv)``, given together, for int8 or
        fp8 k/v payloads: row j of K is ``k[:, j].float() * k_scales[:, j]``.

    Returns ``o`` like q, or ``(o, l, m)``.
    """
    check_ported(dropout_rate=dropout_rate, block_mask=block_mask)
    check_window(window, logit_softcap, causal)
    if block_sizes is not None and block_sizes != BlockSizes():
        raise ValueError(f"the kernel is compiled for {BlockSizes()}, got {block_sizes}")

    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"expected (BH, S, d) tensors, got {q.shape} {k.shape} {v.shape}")
    bh, rows, d = q.shape
    if k.shape != v.shape:
        raise ValueError(f"k/v shape mismatch: {k.shape} vs {v.shape}")
    if k.shape[0] != bh or k.shape[2] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree on BH or d")
    s_kv = k.shape[1]
    quantized = check_kv(q, k, v, k_scales, v_scales, (bh, s_kv))
    kv_len = s_kv if kv_len is None else int(kv_len)
    if not 0 <= kv_len <= s_kv:
        raise ValueError(f"kv_len {kv_len} outside [0, {s_kv}]")
    q_seq_len = rows if q_seq_len is None else int(q_seq_len)
    if q_seq_len <= 0 or rows % q_seq_len:
        raise ValueError(f"q_seq_len ({q_seq_len}) must divide the rows ({rows})")
    seg_q, seg_kv = fold_segment_ids(q_segment_ids, kv_segment_ids, bh, rows, s_kv, q.device)

    scales = (k_scales, v_scales) if quantized else ()
    if not all(t.is_contiguous() for t in (q, k, v, *scales)):
        raise ValueError("flash_attention takes contiguous q, k, v and scales")
    if q.device.type == "cpu":
        if quantized:  # the plain version of the 8-bit form: dequantize first
            k, v = dequantize_rows(k, k_scales), dequantize_rows(v, v_scales)
        return flash_attention_plain(
            q, k, v, causal=causal, scale=scale, kv_len=kv_len,
            q_offset=q_offset, q_seq_len=q_seq_len, save_residuals=save_residuals,
            q_segment_ids=seg_q, kv_segment_ids=seg_kv, window=window,
            logit_softcap=logit_softcap,
        )
    if q.device.type != "cuda" or any(t.device != q.device for t in (k, v, *scales)):
        raise ValueError(f"flash_attention: tensors on {q.device}/{k.device}/{v.device}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention kernel takes float32 or bfloat16, got {q.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim in {_HEAD_DIMS}, got {d}")
    if bh > 65535:
        raise ValueError(f"flash_attention kernel takes BH <= 65535, got {bh}")
    if quantized:
        kernels.check_aligned("flash_attention", k, v)
    o = torch.empty_like(q)
    l = m = None
    if save_residuals:
        l = torch.empty((bh, rows), dtype=torch.float32, device=q.device)
        m = torch.empty((bh, rows), dtype=torch.float32, device=q.device)
    name = "flash_fwd_quant" if quantized else "flash_fwd"
    status = kernels.library(name).fa_flash_fwd(
        _DTYPES[q.dtype], KV_DTYPES[k.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        *(t.data_ptr() if quantized else None for t in (k_scales, v_scales)), o.data_ptr(),
        None if l is None else l.data_ptr(), None if m is None else m.data_ptr(),
        None if seg_q is None else seg_q.data_ptr(),
        None if seg_kv is None else seg_kv.data_ptr(), bh, rows, s_kv, d, kv_len,
        int(q_offset), q_seq_len, int(bool(causal)), float(scale),
        *kernel_options(window, logit_softcap), torch.cuda.current_stream(q.device).cuda_stream,
    )
    kernels.check_launch(name, status, f"q {tuple(q.shape)} {q.dtype}, k {k.dtype}")
    flash_attention.launches += 1
    flash_attention.launches_quantized += quantized
    return (o, l, m) if save_residuals else o


# Kernel launches, for the chip run's path check: all forms, and the 8-bit one.
flash_attention.launches = 0
flash_attention.launches_quantized = 0


def flash_attention_plain(
    q, k, v, *, causal=False, scale=1.0, kv_len=None, q_offset=0,
    q_seq_len=None, save_residuals=False, q_segment_ids=None, kv_segment_ids=None,
    window=None, logit_softcap=None,
):
    """The kernel's function in plain PyTorch, float32 throughout: the CPU
    path of :func:`flash_attention` and its yardstick on the card."""
    bh, rows, _ = q.shape
    s_kv = k.shape[1]
    kv_len = s_kv if kv_len is None else kv_len
    q_seq_len = rows if q_seq_len is None else q_seq_len
    s = softcap(torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale, logit_softcap)
    mask = visible(
        rows, s_kv, causal=causal, kv_len=kv_len, q_offset=q_offset, q_seq_len=q_seq_len,
        q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids, window=window,
        device=q.device,
    )
    s = torch.where(mask, s, torch.tensor(DEFAULT_MASK_VALUE, device=q.device))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bqk,bkd->bqd", p, v.float())
    o = (o / torch.where(l == 0, 1.0, l)[..., None]).to(q.dtype)
    return (o, l, m) if save_residuals else o


_NAIVE_HEAD_DIMS = (32, 64, 128)


def flash_attention_naive(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    scale: float = 1.0,
    block_q: int = 128,
    kv_len: int | None = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Naive attention: each query row's dense softmax over the whole KV
    stripe, float32 throughout.

    Args:
      q: ``(BH, S_q, d)``; k, v: ``(BH, S_kv, d)``, one dtype, contiguous.
      causal: query row r sits at position ``q_offset + r``.
      block_q: the JAX kernel's q tile; ``S_q`` must be a multiple of it, as
        there.  The CUDA tile is the kernel's own (32 rows).
      kv_len: KV columns at or past it are masked (None: all ``S_kv``).

    A row that sees no column gets zeros.  Returns ``o`` like q.
    """
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"expected (BH, S, d) tensors, got {q.shape} {k.shape} {v.shape}")
    bh, s_q, d = q.shape
    s_kv = k.shape[1]
    if s_q % block_q:
        raise ValueError(f"s_q ({s_q}) must be a multiple of block_q ({block_q})")
    if k.shape != v.shape or k.shape[0] != bh or k.shape[2] != d:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q/k/v dtypes differ: {q.dtype} {k.dtype} {v.dtype}")
    kv_len = s_kv if kv_len is None else max(0, min(int(kv_len), s_kv))
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention_naive takes contiguous q, k, v")
    if q.device.type == "cpu":
        return flash_attention_naive_plain(
            q, k, v, causal=causal, scale=scale, kv_len=kv_len, q_offset=q_offset
        )
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention_naive: tensors on {q.device}/{k.device}/{v.device}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention_naive kernel takes float32 or bfloat16, got {q.dtype}")
    if d not in _NAIVE_HEAD_DIMS:
        raise ValueError(f"flash_attention_naive kernel takes head_dim in {_NAIVE_HEAD_DIMS}, got {d}")
    if bh > 65535:
        raise ValueError(f"flash_attention_naive kernel takes BH <= 65535, got {bh}")
    kernels.check_aligned("flash_attention_naive", q, k, v)
    o = torch.empty_like(q)
    lib = kernels.library("flash_naive")
    status = lib.fa_flash_naive(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        bh, s_q, s_kv, d, kv_len, int(q_offset), int(bool(causal)), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    kernels.check_launch("flash_naive", status, f"q {tuple(q.shape)} {q.dtype}")
    flash_attention_naive.launches += 1
    return o


flash_attention_naive.launches = 0  # kernel launches, for the chip run's path check


def flash_attention_naive_plain(q, k, v, *, causal=False, scale=1.0, kv_len=None, q_offset=0):
    """The naive kernel's function in plain PyTorch: the dense oracle
    (:func:`ops.reference.attention_reference`), with zeros for a row that
    sees no column, as the kernel writes them."""
    s_q, s_kv = q.shape[1], k.shape[1]
    kv_len = s_kv if kv_len is None else max(0, min(int(kv_len), s_kv))
    o = attention_reference(
        q, k, v, causal=causal, scale=scale, kv_len=kv_len, q_offset=q_offset
    )
    seen = torch.full((s_q,), kv_len > 0, device=q.device)
    if causal:
        seen &= q_offset + torch.arange(s_q, device=q.device) >= 0
    return torch.where(seen[None, :, None], o, torch.zeros_like(o))
