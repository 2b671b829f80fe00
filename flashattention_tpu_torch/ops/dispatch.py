"""Public attention API: layouts, the GQA fold and kernel dispatch.

Counterpart of ``flashattention_tpu/ops/dispatch.py``: :func:`attention`
takes ``(B, H, S, d)`` or folded ``(B*H, S, d)`` tensors, folds grouped-query
heads into the rows of their KV head (g-major, ``h = kvh * G + g``) so no
repeated K/V is made, aligns causal queries to the end of the KV sequence,
folds segment ids into the same layout, and calls
:func:`ops.flash.flash_attention`.  Where autograd is recording and an input
requires a gradient (and no residuals are asked for), the call goes through
:func:`ops.backward.attention_vjp` instead, so ``torch.autograd`` works
through this public entry point (dispatch.py:295-308), sliding window and
logit softcap, attention dropout and block-sparse masks included.  8-bit K/V (int8 or fp8
payloads with per-token scales ``k_scales``/``v_scales``) go to the forward
kernel's 8-bit form only, as in the JAX package (dispatch.py:288-295); under
autograd they raise before any launch.  Unlike the TPU
package it does not pad ragged lengths to the tile: the CUDA kernels mask
the ragged edge.  It pads the head_dim instead, on every device, so that the
CPU runs the route the card takes: the kernels are built for head_dims 16,
32, 64, 128 and 256, and any other d up to 256 is zero-padded to the next of
them (80 and 96 to 128, 48 to 64; 8-bit payloads with zeros, their scales
as they are), with the caller's scale; zero columns add nothing to Q K^T or
to O, whose pad columns are sliced off (and their gradients dropped).  A
head_dim above 256 is refused by name.  ``implementation="pallas"`` (the
default, as in the JAX package) and its alias ``"cuda"`` run the kernel;
``implementation="xla"`` keeps the JAX package's name for its oracle path
and runs the plain reference (:mod:`ops.reference`) instead.  The JAX
keywords ``precision`` (the JAX package's modes for float32 inputs: the
default ``"bf16_3x"`` and ``"bf16"`` run the forward's float32 tensor-core
form at head_dims 64 and 128, ``"float32"`` the exact kernel;
:func:`ops.flash.kernel_form`) and ``interpret`` (ignored) are accepted.
"""

from __future__ import annotations

import torch

from flashattention_tpu_torch.ops import reference
from flashattention_tpu_torch.ops.backward import attention_vjp
from flashattention_tpu_torch.ops.quant import byte_view
from flashattention_tpu_torch.ops.reference import dequantize_rows
from flashattention_tpu_torch.ops.flash import (
    _HEAD_DIMS,
    MIN_BLOCK,
    BlockMask,
    BlockSizes,
    _round_up,
    check_dropout,
    check_window,
    flash_attention,
)

__all__ = ["attention", "sdpa"]


def attention(
    q,
    k,
    v,
    *,
    causal: bool = False,
    scale: float = 1.0,
    block_sizes: BlockSizes | None = None,
    save_residuals: bool = False,
    implementation: str = "pallas",
    precision: str | None = None,
    interpret: bool | None = None,
    kv_len: int | None = None,
    q_offset: int | None = None,
    q_segment_ids=None,
    kv_segment_ids=None,
    window: int | None = None,
    logit_softcap: float | None = None,
    k_scales=None,
    v_scales=None,
    dropout_rate: float | None = None,
    dropout_seed=0,
    block_mask: BlockMask | None = None,
):
    """Fused attention ``O = softmax(scale * Q K^T) V``.

    Args:
      q, k, v: ``(B, H, S, d)`` or ``(B*H, S, d)``; k/v may have another
        sequence length than q, and (4D only) fewer heads: grouped-query
        attention.
      causal: lower-triangular masking, queries aligned to the end of the KV
        sequence (``q_offset`` defaults to ``S_kv - S_q``).
      implementation: ``"pallas"``, the JAX package's default and name for
        its kernel, or its alias ``"cuda"``: the hand-written kernel (plain
        PyTorch on CPU tensors); or ``"xla"`` (the dense oracle, the JAX
        package's name for it).
      precision: the JAX package's matmul precision mode for float32 inputs
        (``"bf16"``, ``"bf16_3x"``, ``"float32"``, None or ``"auto"``),
        resolved on the kernel route as the JAX package resolves it
        (:func:`ops.flash.resolve_precision`; None is ``"bf16_3x"``, and
        ``"bf16"`` over 8-bit K/V, where the tensor-core 8-bit form takes
        float32 q in bf16 and O comes back in float32:
        :func:`ops.flash.f32_q_in_bf16`) and
        passed to the forward (:func:`ops.flash.kernel_form`: the float32
        tensor-core form computes ``"bf16_3x"`` and ``"bf16"`` at head_dims
        64 and 128, the exact kernel ``"float32"`` and the rest); the
        backward computes float32 exactly in every mode.
      interpret: the JAX package's Pallas interpreter switch, accepted and
        ignored.
      kv_len: live KV length; columns at or past it are masked.
      save_residuals: also return the softmax stats ``(l, m)`` shaped like
        ``q[..., 0]``.
      q_segment_ids, kv_segment_ids: integer ``(B, S)`` (broadcast over
        heads; with GQA the q ids serve all folded group rows, g-major) or
        folded ``(B*H, S)``: a query sees a key only where the ids are equal.
      window: sliding window (causal only): query i attends keys in
        ``(i - window, i]`` (Mistral-style local attention).
      logit_softcap: scores become ``cap * tanh(s / cap)`` (Gemma-2).
      k_scales, v_scales: float32 per-token dequant scales of int8 / fp8 k,
        v payloads, given together: ``(B, H_kv, S_kv)`` for 4D inputs or
        ``(B*H_kv, S_kv)``.  Forward only: under autograd they raise.
      dropout_rate, dropout_seed: attention dropout on the softmax weights,
        inverted ``1 / (1 - rate)`` scaling; the keep bits are the JAX
        package's at the same seed (with GQA, at its padded row layout).
        The seed is an int (a tensor is read once on the host).
      block_mask: a :class:`ops.flash.BlockMask` built at the lengths the JAX
        package pads to (``S`` rounded up to the mask's blocks); not with
        ``causal`` or GQA.

    Returns ``o`` with q's shape and dtype, or ``(o, l, m)``.
    """
    dropout_rate = check_dropout(dropout_rate)
    check_window(window, logit_softcap, causal)
    q_shape = q.shape
    groups = 1
    b_lead = None
    if q.dim() == 4:
        b, h, s_q, d = q.shape
        b_lead = b
        hkv = k.shape[1]
        if h != hkv:
            if h % hkv:
                raise ValueError(f"q heads ({h}) not a multiple of kv heads ({hkv})")
            groups = h // hkv
        # (B, H, S, d) -> (B*KVH, G*S, d): g-major rows, each S-row segment
        # position-contiguous (dispatch.py:157-159).
        # contiguous(): a transposed (B, S, H, d) input reshapes to a strided
        # view when B == 1, and the kernel takes dense rows.
        q3 = q.reshape(b * hkv, groups * s_q, d).contiguous()
        k3 = k.reshape(k.shape[0] * k.shape[1], *k.shape[2:]).contiguous()
        v3 = v.reshape(v.shape[0] * v.shape[1], *v.shape[2:]).contiguous()
    elif q.dim() == 3:
        q3, k3, v3 = q, k, v
        if k3.shape[0] != q3.shape[0]:
            raise ValueError(
                f"3D GQA not supported; fold groups yourself or pass 4D "
                f"(got q {tuple(q3.shape)}, k {tuple(k3.shape)})"
            )
    else:
        raise ValueError(f"expected 3D or 4D q, got shape {tuple(q_shape)}")

    bh, rows, d = q3.shape
    s_q = rows // groups
    s_kv = k3.shape[1]
    if q_offset is None:
        q_offset = s_kv - s_q if causal else 0
    if causal and s_kv < s_q:
        raise ValueError(f"causal attention requires S_kv >= S_q, got {s_kv} < {s_q}")
    if block_mask is not None:
        if causal:
            raise ValueError("block_mask and causal are mutually exclusive; encode "
                             "causality in the mask_fn instead")
        padded = (_round_up(s_q, block_mask.block_q), _round_up(s_kv, block_mask.block_kv))
        if (block_mask.s_q, block_mask.s_kv) != padded:
            raise ValueError(
                f"block_mask covers (S_q, S_kv)=({block_mask.s_q}, {block_mask.s_kv}) but "
                f"the padded inputs are {padded}; build the mask at the padded lengths (its "
                "mask_fn decides what padding rows may attend)"
            )

    # Segment ids in the folded layout (dispatch.py:186-203).
    if q_segment_ids is not None and groups > 1:
        if tuple(q_segment_ids.shape) != (b_lead, s_q):
            raise ValueError(
                f"q_segment_ids with GQA must be (B, S_q)=({b_lead}, {s_q}), "
                f"got {tuple(q_segment_ids.shape)}"
            )
        seg_q3 = q_segment_ids[:, None, None, :].expand(b_lead, k.shape[1], groups, s_q)
        seg_q3 = seg_q3.reshape(bh, groups * s_q)
    else:
        seg_q3 = _fold_side_input(q_segment_ids, b_lead, bh, s_q, "q_segment_ids")
    seg_kv3 = _fold_side_input(kv_segment_ids, b_lead, k3.shape[0], s_kv, "kv_segment_ids")
    if (k_scales is None) != (v_scales is None):
        raise ValueError("k_scales and v_scales must be given together")
    ks3 = _fold_scales(k_scales, b_lead, k3.shape[0], s_kv, "k_scales")
    vs3 = _fold_scales(v_scales, b_lead, k3.shape[0], s_kv, "v_scales")

    if implementation == "xla":
        if dropout_rate is not None:
            raise NotImplementedError(
                "dropout is kernel-PRNG-defined; implementation='xla' has no matching "
                "oracle (tests regenerate masks via dropout_keep_mask)"
            )
        if seg_q3 is not None or block_mask is not None:
            raise NotImplementedError(
                "segment ids / block_mask via implementation='xla': use ops.reference "
                "directly with an explicit mask"
            )
        if ks3 is not None:  # the oracle over the dequantized K/V
            k3, v3 = dequantize_rows(k3, ks3), dequantize_rows(v3, vs3)
        if groups > 1:  # the oracle wants equal heads: repeat KV
            k3 = k3.repeat_interleave(groups, dim=0)
            v3 = v3.repeat_interleave(groups, dim=0)
            q3 = q3.reshape(bh * groups, s_q, d)
        o, l, m = reference.attention_reference_with_stats(
            q3, k3, v3, causal=causal, scale=scale, kv_len=kv_len, q_offset=q_offset,
            window=window, logit_softcap=logit_softcap,
        )
    elif implementation in ("pallas", "cuda"):
        d_pad = padded_head_dim(d)
        if d_pad != d:
            q3, k3, v3 = (_pad_head_dim(x, d_pad) for x in (q3, k3, v3))
        q_seq_len = s_q if groups > 1 else None
        # Dropout draws its bits at the JAX package's raw rows, where each
        # GQA segment is padded to a multiple of its smallest tile.
        extra = dict(dropout_rate=dropout_rate, dropout_seed=dropout_seed, block_mask=block_mask,
                     dropout_row_stride=_round_up(s_q, MIN_BLOCK) if groups > 1 else None)
        differentiable = torch.is_grad_enabled() and any(
            t.requires_grad for t in (q3, k3, v3)
        )
        if differentiable and ks3 is not None:
            raise NotImplementedError(
                "quantized K/V (k/v scales) have no backward kernel: they serve "
                "forward only, as in the JAX package"
            )
        if differentiable and not save_residuals:
            o = attention_vjp(
                q3, k3, v3, causal, scale, block_sizes, precision, interpret, q_seq_len,
                window, logit_softcap, q_segment_ids=seg_q3, kv_segment_ids=seg_kv3,
                kv_len=kv_len, q_offset=q_offset, **extra,
            )
            l = m = None
        else:
            out = flash_attention(
                q3, k3, v3, causal=causal, scale=scale, kv_len=kv_len,
                q_offset=q_offset, q_seq_len=q_seq_len, save_residuals=save_residuals,
                block_sizes=block_sizes, q_segment_ids=seg_q3, kv_segment_ids=seg_kv3,
                window=window, logit_softcap=logit_softcap, k_scales=ks3, v_scales=vs3,
                precision=precision, interpret=interpret, **extra,
            )
            o, l, m = out if save_residuals else (out, None, None)
        o = o[..., :d]
    else:
        raise ValueError(f"unknown implementation: {implementation!r}")

    o = o.reshape(q_shape)
    if save_residuals:
        stat_shape = q_shape[:-1]
        return o, l.reshape(stat_shape), m.reshape(stat_shape)
    return o


def padded_head_dim(d: int) -> int:
    """The head_dim the kernels run a call of head_dim ``d`` at: the
    smallest built one at or above ``d``.  Raises for ``d`` above 256."""
    for size in _HEAD_DIMS:
        if d <= size:
            return size
    raise ValueError(f"attention takes head_dim <= {_HEAD_DIMS[-1]}, got {d}")


def _pad_head_dim(x, d_pad):
    """``x`` with its last dim zero-padded to ``d_pad`` (an fp8 payload
    through its bytes: a zero byte is 0 in e4m3, as in int8)."""
    pad = (0, d_pad - x.shape[-1])
    if x.dtype == torch.float8_e4m3fn:
        return torch.nn.functional.pad(byte_view(x), pad).view(x.dtype)
    return torch.nn.functional.pad(x, pad)


def _fold_side_input(ids, b_lead, bh, s, name):
    """(B, S) per-batch ids -> (BH, S) folded, or pass (BH, S) through
    (dispatch.py:379)."""
    if ids is None:
        return None
    if ids.dim() != 2:
        raise ValueError(f"{name} must be 2D (B, S) or (B*H, S), got {tuple(ids.shape)}")
    if tuple(ids.shape) == (bh, s):
        return ids
    if b_lead is not None and tuple(ids.shape) == (b_lead, s):
        return ids[:, None, :].expand(b_lead, bh // b_lead, s).reshape(bh, s)
    raise ValueError(
        f"{name} shape {tuple(ids.shape)} matches neither (B, S)=({b_lead}, {s}) "
        f"nor (B*H, S)=({bh}, {s})"
    )


def _fold_scales(scales, b_lead, bh_kv, s_kv, name):
    """(B, H_kv, S) scales -> (B*H_kv, S), or pass (B*H_kv, S) through
    (dispatch.py:396-411)."""
    if scales is None:
        return None
    if scales.dim() == 3:
        if b_lead is None or scales.shape[0] * scales.shape[1] != bh_kv:
            raise ValueError(
                f"{name} shape {tuple(scales.shape)} does not fold to (B*H_kv, S)=({bh_kv}, {s_kv})"
            )
        scales = scales.reshape(bh_kv, scales.shape[2])
    if tuple(scales.shape) != (bh_kv, s_kv):
        raise ValueError(f"{name} must be (B*H_kv, S_kv)=({bh_kv}, {s_kv}), got {tuple(scales.shape)}")
    return scales.contiguous()


def sdpa(q, k, v, *, causal=False, **kwargs):
    """Scaled dot-product attention: :func:`attention` with scale = 1/sqrt(d)."""
    return attention(q, k, v, causal=causal, scale=q.shape[-1] ** -0.5, **kwargs)
