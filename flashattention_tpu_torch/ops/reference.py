"""Plain PyTorch reference attention: the oracles the kernels are held to.

Counterpart of ``flashattention_tpu/ops/reference.py``: dense
``softmax(scale * Q K^T) V`` in float32 whatever the input dtype, with causal,
sliding-window and live-length masking by the same finite mask value and an
optional logit softcap, returning the online softmax statistics ``(l, m)`` on
request.  Runs on any device.  8-bit K/V (int8 or fp8 payloads with per-row
float32 scales) are held to the same oracle after :func:`dequantize_rows`,
which the plain versions of the kernels' 8-bit forms and the dispatch's
oracle route share.
"""

from __future__ import annotations

import torch

__all__ = [
    "attention_reference",
    "dequantize_rows",
    "attention_reference_with_stats",
    "causal_mask",
    "softcap",
    "DEFAULT_MASK_VALUE",
]

# Large-negative instead of -inf so exp(mask - max) never hits exp(-inf - (-inf)).
DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


def causal_mask(s_q: int, s_kv: int, *, q_offset: int = 0, device=None) -> torch.Tensor:
    """Boolean (s_q, s_kv) mask, True where query i may attend to key j
    (query i sits at position ``q_offset + i``)."""
    q_ids = torch.arange(s_q, device=device)[:, None] + q_offset
    kv_ids = torch.arange(s_kv, device=device)[None, :]
    return kv_ids <= q_ids


def softcap(s, logit_softcap):
    """Gemma-2's score cap ``cap * tanh(s / cap)``; ``s`` itself when
    ``logit_softcap`` is None."""
    return s if logit_softcap is None else logit_softcap * torch.tanh(s / logit_softcap)


def attention_reference(
    q, k, v, *, causal=False, scale=1.0, kv_len=None, q_offset=0, window=None,
    logit_softcap=None,
):
    """Dense reference attention on ``(..., S, d)`` tensors; see
    :func:`attention_reference_with_stats`."""
    o, _, _ = attention_reference_with_stats(
        q, k, v, causal=causal, scale=scale, kv_len=kv_len, q_offset=q_offset,
        window=window, logit_softcap=logit_softcap,
    )
    return o


def attention_reference_with_stats(
    q, k, v, *, causal=False, scale=1.0, kv_len=None, q_offset=0, window=None,
    logit_softcap=None,
):
    """Reference attention returning ``(o, l, m)``.

    ``m`` is the per-row max of the scaled, masked scores and ``l`` the
    per-row sum of ``exp(s - m)``, both float32; ``o`` has q's dtype.
    ``kv_len`` masks KV columns at or past it.  ``logit_softcap`` maps each
    scaled score to ``cap * tanh(s / cap)`` before the masks; ``window``
    (causal only) lets query i see keys in ``(i - window, i]``.
    """
    if window is not None and not causal:
        raise ValueError("window (sliding-window attention) requires causal=True")
    qf, kf, vf = q.float(), k.float(), v.float()
    s = softcap(torch.einsum("...qd,...kd->...qk", qf, kf) * scale, logit_softcap)
    s_q, s_kv = s.shape[-2], s.shape[-1]
    mask = None
    if causal:
        mask = causal_mask(s_q, s_kv, q_offset=q_offset, device=s.device)
        if window is not None:
            q_ids = torch.arange(s_q, device=s.device)[:, None] + q_offset
            mask = mask & (torch.arange(s_kv, device=s.device)[None, :] > q_ids - window)
    if kv_len is not None:
        len_mask = torch.arange(s_kv, device=s.device)[None, :] < kv_len
        mask = len_mask if mask is None else (mask & len_mask)
    if mask is not None:
        s = torch.where(mask, s, torch.tensor(DEFAULT_MASK_VALUE, device=s.device))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("...qk,...kd->...qd", p, vf) / l[..., None]
    return o.to(q.dtype), l, m


def dequantize_rows(payload, scales):
    """8-bit rows ``(..., d)`` times their scales ``(...)``, in float32."""
    return payload.float() * scales.float()[..., None]
