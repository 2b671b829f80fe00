"""Public attention API: layouts, the GQA fold and kernel dispatch.

Counterpart of ``flashattention_tpu/ops/dispatch.py``: :func:`attention`
takes ``(B, H, S, d)`` or folded ``(B*H, S, d)`` tensors, folds grouped-query
heads into the rows of their KV head (g-major, ``h = kvh * G + g``) so no
repeated K/V is made, aligns causal queries to the end of the KV sequence,
and calls :func:`ops.flash.flash_attention`.  Unlike the TPU package it does
not pad ragged lengths to the tile: the CUDA kernel masks the ragged edge.
``implementation="xla"`` keeps the JAX package's name for its oracle path
and runs the plain reference (:mod:`ops.reference`) instead of the kernel.
"""

from __future__ import annotations

from flashattention_tpu_torch.ops import reference
from flashattention_tpu_torch.ops.flash import BlockSizes, check_ported, flash_attention

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
    implementation: str = "cuda",
    kv_len: int | None = None,
    q_offset: int | None = None,
    **unported,
):
    """Fused attention ``O = softmax(scale * Q K^T) V``.

    Args:
      q, k, v: ``(B, H, S, d)`` or ``(B*H, S, d)``; k/v may have another
        sequence length than q, and (4D only) fewer heads: grouped-query
        attention.
      causal: lower-triangular masking, queries aligned to the end of the KV
        sequence (``q_offset`` defaults to ``S_kv - S_q``).
      implementation: ``"cuda"`` (the kernel; plain PyTorch on CPU tensors)
        or ``"xla"`` (the dense oracle, the JAX package's name for it).
      kv_len: live KV length; columns at or past it are masked.
      save_residuals: also return the softmax stats ``(l, m)`` shaped like
        ``q[..., 0]``.
      unported: the JAX package's other options (window, logit_softcap,
        dropout, segment ids, KV scales, block_mask) raise
        ``NotImplementedError`` in :func:`flash_attention`.

    Returns ``o`` with q's shape and dtype, or ``(o, l, m)``.
    """
    q_shape = q.shape
    groups = 1
    if q.dim() == 4:
        b, h, s_q, d = q.shape
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

    if implementation == "xla":
        check_ported(**unported)
        if groups > 1:  # the oracle wants equal heads: repeat KV
            k3 = k3.repeat_interleave(groups, dim=0)
            v3 = v3.repeat_interleave(groups, dim=0)
            q3 = q3.reshape(bh * groups, s_q, d)
        o, l, m = reference.attention_reference_with_stats(
            q3, k3, v3, causal=causal, scale=scale, kv_len=kv_len, q_offset=q_offset
        )
    elif implementation == "cuda":
        out = flash_attention(
            q3, k3, v3, causal=causal, scale=scale, kv_len=kv_len,
            q_offset=q_offset, q_seq_len=s_q if groups > 1 else None,
            save_residuals=save_residuals, block_sizes=block_sizes, **unported,
        )
        o, l, m = out if save_residuals else (out, None, None)
    else:
        raise ValueError(f"unknown implementation: {implementation!r}")

    o = o.reshape(q_shape)
    if save_residuals:
        stat_shape = q_shape[:-1]
        return o, l.reshape(stat_shape), m.reshape(stat_shape)
    return o


def sdpa(q, k, v, *, causal=False, **kwargs):
    """Scaled dot-product attention: :func:`attention` with scale = 1/sqrt(d)."""
    return attention(q, k, v, causal=causal, scale=q.shape[-1] ** -0.5, **kwargs)
