"""Decode attention over a paged KV cache (one query token per request).

Counterpart of ``flashattention_tpu/ops/decode.py``: the physical pool is
head-major, ``(P, KVH, page_size, d)`` (one page holds a token range of all
KV heads), q is ``(B, KVH, G, d)`` with the G query heads of each KV head
together, and a request's page-table row maps its logical pages to physical
ones.  On a CUDA tensor :func:`paged_attention` launches the hand-written
kernel in ``csrc/paged_decode.cu`` (replacing the Pallas ``_paged_kernel``,
:89); on a CPU tensor it runs :func:`paged_attention_plain`.  A CUDA call
launches the kernel or raises; there is no fallback.
"""

from __future__ import annotations

import torch

from flashattention_tpu_torch.ops import kernels
from flashattention_tpu_torch.ops.reference import DEFAULT_MASK_VALUE

__all__ = ["paged_attention", "paged_attention_plain", "paged_attention_reference"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)
_GROUPS = (1, 2, 4, 8)


def paged_attention_reference(q, k_pages, v_pages, lengths, page_indices, *, scale=1.0):
    """Dense oracle: gather every page of the table, mask by length, attend.

    A row of length 0 has every column masked, so like the JAX oracle it
    returns the mean of the gathered V rows (not zeros; see
    :func:`paged_attention`)."""
    b, kvh, g, d = q.shape
    page_size = k_pages.shape[2]
    s_max = page_indices.shape[1] * page_size
    idx = page_indices.long()
    # (B, pps, KVH, ps, d) -> (B, KVH, S_max, d)
    k = k_pages[idx].transpose(1, 2).reshape(b, kvh, s_max, d)
    v = v_pages[idx].transpose(1, 2).reshape(b, kvh, s_max, d)
    s = torch.einsum("bhgd,bhkd->bhgk", q.float(), k.float()) * scale
    mask = torch.arange(s_max, device=q.device)[None, :] < lengths.long()[:, None]
    s = torch.where(mask[:, None, None, :], s, torch.tensor(DEFAULT_MASK_VALUE, device=q.device))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    o = torch.einsum("bhgk,bhkd->bhgd", p, v.float()) / p.sum(dim=-1, keepdim=True)
    return o.to(q.dtype)


def paged_attention_plain(q, k_pages, v_pages, lengths, page_indices, *, scale=1.0):
    """The kernel's function in plain PyTorch: the oracle, with zeros for
    rows of length 0 as the kernel writes them."""
    o = paged_attention_reference(q, k_pages, v_pages, lengths, page_indices, scale=scale)
    return torch.where((lengths > 0)[:, None, None, None].to(o.device), o, torch.zeros_like(o))


def paged_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    lengths: torch.Tensor,
    page_indices: torch.Tensor,
    *,
    k_scales_pages=None,
    v_scales_pages=None,
    scale: float = 1.0,
    draft_k: int = 1,
    window: int | None = None,
    logit_softcap: float | None = None,
) -> torch.Tensor:
    """Decode attention over a paged KV cache.

    Args:
      q: ``(B, KVH, G, d)`` current-token queries, grouped by KV head.
      k_pages, v_pages: ``(P, KVH, page_size, d)`` head-major page pools.
      lengths: ``(B,)`` int32, tokens valid per request (q attends to
        ``[0, len)``).  A row of length 0 gets zeros; the JAX kernel leaves
        it unwritten (``decode.py:258``).
      page_indices: ``(B, pages_per_seq)`` int32 logical -> physical pages;
        only the first ``ceil(len / page_size)`` entries of a row are read.

    Returns ``(B, KVH, G, d)`` in q's dtype.
    """
    if draft_k != 1:
        raise NotImplementedError(
            "draft_k > 1 (speculative verification) is not ported yet: it "
            "comes with the speculative-decoding slice"
        )
    if window is not None or logit_softcap is not None:
        raise NotImplementedError(
            "window / logit_softcap in paged_attention are not ported yet: "
            "they come with the Mistral and Gemma-2 slices"
        )
    if k_scales_pages is not None or v_scales_pages is not None:
        raise NotImplementedError(
            "quantized pages (k/v scales) are not ported yet: they come with "
            "the quantized-KV slice"
        )
    if q.dim() != 4 or k_pages.dim() != 4:
        raise ValueError(f"expected q (B,KVH,G,d), pages (P,KVH,ps,d): {q.shape} {k_pages.shape}")
    b, kvh, g, d = q.shape
    _, kvh2, page_size, d2 = k_pages.shape
    if (kvh2, d2) != (kvh, d):
        raise ValueError(f"q/k_pages mismatch: {tuple(q.shape)} vs {tuple(k_pages.shape)}")
    if k_pages.shape != v_pages.shape:
        raise ValueError(f"k/v pages mismatch: {tuple(k_pages.shape)} vs {tuple(v_pages.shape)}")
    if lengths.shape != (b,) or page_indices.dim() != 2 or page_indices.shape[0] != b:
        raise ValueError(
            f"lengths {tuple(lengths.shape)} / page_indices {tuple(page_indices.shape)} "
            f"do not match batch {b}"
        )
    if not (q.dtype == k_pages.dtype == v_pages.dtype):
        raise ValueError(f"q/pages dtypes differ: {q.dtype} {k_pages.dtype} {v_pages.dtype}")

    if not all(t.is_contiguous() for t in (q, k_pages, v_pages, lengths, page_indices)):
        raise ValueError("paged_attention takes contiguous tensors")
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, lengths, page_indices, scale=scale)
    devs = {t.device for t in (q, k_pages, v_pages, lengths, page_indices)}
    if q.device.type != "cuda" or len(devs) != 1:
        raise ValueError(f"paged_attention: tensors on {sorted(map(str, devs))}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"paged_attention kernel takes float32 or bfloat16, got {q.dtype}")
    if d not in _HEAD_DIMS or g not in _GROUPS:
        raise ValueError(
            f"paged_attention kernel takes head_dim in {_HEAD_DIMS} and G in "
            f"{_GROUPS}, got d={d}, G={g}"
        )
    if lengths.dtype != torch.int32 or page_indices.dtype != torch.int32:
        raise ValueError("paged_attention kernel takes int32 lengths and page_indices")
    if b > 65535:
        raise ValueError(f"paged_attention kernel takes B <= 65535, got {b}")
    o = torch.empty_like(q)
    lib = kernels.library("paged_decode")
    status = lib.fa_paged_decode(
        _DTYPES[q.dtype], q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        lengths.data_ptr(), page_indices.data_ptr(), o.data_ptr(),
        b, kvh, g, d, page_size, page_indices.shape[1], float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    kernels.check_launch("paged_decode", status, f"q {tuple(q.shape)} {q.dtype}")
    paged_attention.launches += 1
    return o


paged_attention.launches = 0  # kernel launches, for the chip run's path check
