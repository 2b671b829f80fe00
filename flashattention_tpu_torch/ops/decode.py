"""Attention over a paged KV cache: decode (one query token per request)
and chunked prefill (a chunk of query rows per request).

Counterpart of ``flashattention_tpu/ops/decode.py``: the physical pool is
head-major, ``(P, KVH, page_size, d)`` (one page holds a token range of all
KV heads), q is ``(B, KVH, G, d)`` with the G query heads of each KV head
together, and a request's page-table row maps its logical pages to physical
ones.  On a CUDA tensor :func:`paged_attention` launches a hand-written
kernel that replaces the Pallas ``_paged_kernel`` (:89), in the form
``ops.flash.kernel_form`` picks: for bf16 q (float32 q over bf16 or 8-bit
pages is taken in bf16, as the Pallas kernels take it) at head_dim 64, 128
or 256 with at most 32 q rows per KV head, over bf16 or 8-bit pages of a
size its TMA boxes take, the tensor-core kernel in ``csrc/paged_decode_tc.cu``
(``paged_decode_tc``, for 8-bit pages ``paged_decode_tc_quant``: the cache
split across blocks, pages staged by TMA, products by ``mma.sync``, the
splits' partials merged by a second kernel), for float32 q over float32
pages at those head_dims, rows and page sizes the same source's float32
form (``paged_decode_tc_f32``: each value as three bf16 terms split in
registers, six products, as the Pallas kernel's HIGHEST), otherwise the
float32 CUDA-core kernel in ``csrc/paged_decode.cu``; on a CPU tensor it
runs :func:`paged_attention_plain` with the chosen form's rounding.  A CUDA call
launches the kernel or raises; there is no fallback.  With ``draft_k = k >
1`` (speculative verification) q holds k rows per query head, k-minor, each
at its own causal limit, and the kernel's draft form runs.

:func:`paged_prefill_attention_batched` (and its single-request form
:func:`paged_prefill_attention`) is the chunked-prefill counterpart: q holds a
chunk of rows per request, GQA-folded into ``(B, KVH, G * seg, d)``, that
attend their context straight off the pool.  On a CUDA tensor it launches a
kernel that replaces the Pallas ``_paged_prefill_kernel`` (:375), in the form
``ops.flash.kernel_form`` picks: for bf16 q (float32 q over bf16 or 8-bit
pages taken in bf16) at head_dim 64, 128 or 256 over
bf16 or 8-bit pages of a size it takes (``ops.flash.tc_page_size``) the
tensor-core kernel in ``csrc/paged_prefill_tc.cu`` (``paged_prefill_tc``, and
for 8-bit pages ``paged_prefill_tc_quant``), for float32 q over float32
pools at those head_dims the same source's float32 form
(``paged_prefill_tc_f32``: each value as three bf16 terms split in shared
memory, six products, as the Pallas kernel's HIGHEST), otherwise the float32
CUDA-core kernel in ``csrc/paged_prefill.cu``; on a CPU tensor it runs
:func:`paged_prefill_attention_plain` with the chosen form's rounding.

Both take a sliding window (a query at position ``pos`` sees columns
``c > pos - window``) and a logit softcap (``s -> cap * tanh(s / cap)`` after
the scale, before the masks), as the Pallas kernels do, and 8-bit pages:
int8 or fp8 payload pools with float32 scale pools ``(P, KVH, page_size)``,
one scale per K/V row (``k_scales_pages``/``v_scales_pages``).  Those launch
the kernels' 8-bit forms (the same sources built with ``FA_QUANT``): the
scalar ones dequantize each row as they load it, and their plain versions
dequantize the gathered pages in float32 and attend as for float pages;
chunked prefill's tensor-core form converts each staged tile to bf16 and
scales the score columns and P, and its plain version mirrors that.
"""

from __future__ import annotations

import torch

from flashattention_tpu_torch.ops import kernels
from flashattention_tpu_torch.ops.flash import (
    KV_DTYPES,
    TC_DECODE_TILE,
    _exp,
    _highest,
    _two_term_bf16,
    check_kv,
    check_window,
    flash_attention_plain,
    kernel_form,
    kernel_options,
)
from flashattention_tpu_torch.ops.quant import byte_view
from flashattention_tpu_torch.ops.reference import DEFAULT_MASK_VALUE, dequantize_rows, softcap

__all__ = [
    "decode_splits",
    "paged_attention",
    "paged_attention_plain",
    "paged_attention_reference",
    "paged_prefill_attention",
    "paged_prefill_attention_batched",
    "paged_prefill_attention_plain",
    "paged_prefill_attention_reference",
]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128, 256)
_GROUPS = (1, 2, 4, 8)
# paged_decode_tc: at most this many splits of a request's cache (the merge
# kernel's table), and the SM count the splits are sized for where no card
# is asked (the plain version on the CPU): an H100's.
_TC_MAX_SPLITS = 64
H100_SMS = 132
_SMS: dict = {}


def _sm_count(device) -> int:
    """SMs of the card ``device`` lies on (H100_SMS off the card)."""
    if device.type != "cuda":
        return H100_SMS
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def decode_splits(b, kvh, pages_per_seq, page_size, *, sms=H100_SMS, splits=None):
    """``(splits, tiles_per_split)`` of ``paged_decode_tc``: each request's
    table, ``pages_per_seq * page_size`` columns in tiles of
    ``TC_DECODE_TILE``, cut into splits of whole tiles, each a block of its
    own.  From host-known numbers only (never the lengths, which would
    sync): ``splits`` blocks per (request, KV head) (default: enough for
    four blocks an SM over ``sms`` SMs, since the splits past a request's
    length exit at once), at most one per tile and ``_TC_MAX_SPLITS``."""
    tiles = max(1, -(-pages_per_seq * page_size // TC_DECODE_TILE))
    if splits is None:
        splits = -(-4 * sms // max(1, b * kvh))
    n = max(1, min(tiles, int(splits), _TC_MAX_SPLITS))
    per = -(-tiles // n)
    return -(-tiles // per), per


def _gather(pages, scales, page_indices):
    """(B, KVH, S_max, d) float32 rows of every page of each table row,
    dequantized when ``scales`` (the 8-bit pages' scale pool) is given."""
    _, kvh, ps, d = pages.shape
    b, pps = page_indices.shape
    idx = page_indices.long()
    rows = byte_view(pages)[idx].view(pages.dtype)
    if scales is not None:
        rows = dequantize_rows(rows, scales[idx])
    # (B, pps, KVH, ps, d) -> (B, KVH, S_max, d)
    return rows.float().transpose(1, 2).reshape(b, kvh, pps * ps, d)


def _f32_q_in_bf16(q, k_pages, kernel: str, rows: int = 1) -> bool:
    """Whether a call of ``kernel`` (``"paged_decode"`` with ``rows`` q rows
    per KV head, or ``"paged_prefill"``) takes float32 q in bf16, as the
    Pallas kernels take q over every page that is not float32
    (decode.py:145-150, :440-445; p times v_scale rounded to bf16 too, :202,
    :481-483), with O in float32, their ``out_shape`` being q's type (:359,
    :637, :773): over bf16 pages always (a call whose bf16 form is scalar
    stores bf16 and casts it); over 8-bit pages where the tensor-core 8-bit
    form takes the bf16 call, which writes O straight from its float32
    sums.  Elsewhere (head_dim 32, a page size the TMA boxes do not take,
    more than 32 decode rows per KV head, ``ops.flash.scalar_forms``) the
    scalar 8-bit form keeps float32 q, exact."""
    if q.dtype != torch.float32 or k_pages.dtype == torch.float32:
        return False
    return k_pages.dtype == torch.bfloat16 or kernel_form(
        kernel, torch.bfloat16, q.shape[-1], quantized=True, page_size=k_pages.shape[2],
        rows=rows) == "tc"


def _plain_f32_q(q, k_pages, form, kernel: str, rows: int = 1) -> bool:
    """Whether a plain version of ``form`` (None: the kernel's own) takes
    float32 q in bf16: the tensor-core forms and bf16 pages always, the
    kernel's own form as :func:`_f32_q_in_bf16` says."""
    if q.dtype != torch.float32 or k_pages.dtype == torch.float32:
        return False
    return (form == "tc" or k_pages.dtype == torch.bfloat16
            or (form is None and _f32_q_in_bf16(q, k_pages, kernel, rows)))


def _row_limits(lengths, rows, draft_k, device):
    """(B, rows) last column each q row sees: ``length - k + r % k`` (k-minor
    draft rows; every row ``length - 1`` when k = 1)."""
    dp = torch.arange(rows, device=device) % draft_k
    return lengths.to(device).long()[:, None] - draft_k + dp[None, :]


def paged_attention_reference(
    q, k_pages, v_pages, lengths, page_indices, *, scale=1.0, draft_k=1, window=None,
    logit_softcap=None, k_scales_pages=None, v_scales_pages=None,
):
    """Dense oracle: gather every page of the table (dequantized in float32
    for 8-bit pages), mask each row by its causal limit (``length - 1``, or
    ``length - k + r % k`` for draft row r) and window, attend.

    A row of length 0 has every column masked, so like the JAX oracle it
    returns the mean of the gathered V rows (not zeros; see
    :func:`paged_attention`)."""
    page_size = k_pages.shape[2]
    s_max = page_indices.shape[1] * page_size
    k = _gather(k_pages, k_scales_pages, page_indices)
    v = _gather(v_pages, v_scales_pages, page_indices)
    s = softcap(torch.einsum("bhgd,bhkd->bhgk", q.float(), k) * scale, logit_softcap)
    cols = torch.arange(s_max, device=q.device)[None, None, :]
    lim = _row_limits(lengths, q.shape[2], draft_k, q.device)[:, :, None]  # (B, rows, 1)
    mask = cols <= lim
    if window is not None:
        mask = mask & (cols > lim - window)
    s = torch.where(mask[:, None], s, torch.tensor(DEFAULT_MASK_VALUE, device=q.device))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    o = torch.einsum("bhgk,bhkd->bhgd", p, v) / p.sum(dim=-1, keepdim=True)
    return o.to(q.dtype)


def paged_attention_plain(
    q, k_pages, v_pages, lengths, page_indices, *, scale=1.0, draft_k=1, window=None,
    logit_softcap=None, k_scales_pages=None, v_scales_pages=None, form=None, splits=None,
):
    """The kernel's function in plain PyTorch: the oracle, with zeros for
    rows of length 0 as the kernel writes them.

    ``form`` (default: ``ops.flash.kernel_form`` of these inputs) mirrors
    the kernel form's rounding: ``"tc"`` that of ``paged_decode_tc``
    (:func:`_paged_attention_tc_plain`; ``splits`` the split count to ask
    :func:`decode_splits` for, by default the one the kernel takes on the
    card the inputs lie on); ``"tc_f32"`` that of its float32 form over
    float32 pages, the same with S and P V as XLA's HIGHEST computes them
    (``ops.flash._highest``: three bf16 terms, six products); ``"scalar"``
    attends in float32 over 8-bit rows dequantized in float32.  Float32 q
    that the kernel takes in bf16 (:func:`_f32_q_in_bf16`) is taken so
    here: the form is the bf16 call's, and O comes back in float32, from the
    float32 sums (tc) or through a bf16 store (scalar, bf16 pages)."""
    kw = dict(scale=scale, draft_k=draft_k, window=window, logit_softcap=logit_softcap,
              k_scales_pages=k_scales_pages, v_scales_pages=v_scales_pages)
    if _plain_f32_q(q, k_pages, form, "paged_decode", q.shape[2]):
        qb = q.to(torch.bfloat16)
        if form is None:
            form = kernel_form("paged_decode", qb.dtype, q.shape[3],
                               quantized=k_scales_pages is not None, page_size=k_pages.shape[2],
                               rows=q.shape[2])
        if form == "tc":
            return _paged_attention_tc_plain(qb.float(), k_pages, v_pages, lengths, page_indices,
                                             splits=splits, highest=False, **kw)
        return paged_attention_plain(qb, k_pages, v_pages, lengths, page_indices, form=form,
                                     **kw).float()
    if form is None:
        form = kernel_form("paged_decode", q.dtype, q.shape[3], quantized=k_scales_pages is not None,
                           page_size=k_pages.shape[2], rows=q.shape[2])
    if form in ("tc", "tc_f32"):
        return _paged_attention_tc_plain(q, k_pages, v_pages, lengths, page_indices,
                                         splits=splits, highest=form == "tc_f32", **kw)
    o = paged_attention_reference(q, k_pages, v_pages, lengths, page_indices, **kw)
    return torch.where((lengths > 0)[:, None, None, None].to(o.device), o, torch.zeros_like(o))


def _pad_cols(x, width, dim):
    """``x`` zero-padded along ``dim`` to ``width`` columns."""
    pad = [0, 0] * (x.dim() - 1 - dim) + [0, width - x.shape[dim]]
    return torch.nn.functional.pad(x, pad)


def _paged_attention_tc_plain(
    q, k_pages, v_pages, lengths, page_indices, *, scale, draft_k, window, logit_softcap,
    k_scales_pages, v_scales_pages, splits, highest,
):
    """``paged_decode_tc``'s function and rounding in plain PyTorch (with
    ``highest``, its float32 form's).

    Each request's table is cut into the kernel's splits
    (:func:`decode_splits`) of ``TC_DECODE_TILE``-column tiles aligned to
    column 0; a split visits the tiles that hold a column in [first, end)
    (first: the first column of row 0's window; end: the length).  Per
    split: the scores (8-bit pages: the payload's values, exact in bf16,
    times the column's k_scale) scaled, softcapped and masked (a masked
    column's score is the finite mask value, a column of a tile the split
    does not visit -inf), p against the running max of the visited tiles,
    l the sum of the float32 p, P (times the column's v_scale) as two bf16
    terms, V rows and the scales outside [first, end) as zeros (with
    ``highest``: S as XLA's HIGHEST computes it, and P's three terms, the
    rescale applied, against V's, ``ops.flash._highest``); then the
    partials merged, each weighted by ``exp(m_split - M)`` (0 for a split
    that visits nothing), O times ``1 / L`` (zeros where L is 0: a length-0
    request)."""
    b, kvh, rows, d = q.shape
    ps, pps = k_pages.shape[2], page_indices.shape[1]
    dev = q.device
    n, per = decode_splits(b, kvh, pps, ps, sms=_sm_count(dev), splits=splits)
    tile, s_max = TC_DECODE_TILE, pps * ps
    width = n * per * tile
    cols = torch.arange(width, device=dev)
    length = lengths.to(dev).long()
    end = length.clamp(max=s_max)
    first = (length - draft_k - window + 1).clamp(min=0) if window else torch.zeros_like(length)
    live = (cols[None] >= first[:, None]) & (cols[None] < end[:, None])  # (B, width)
    visited = ((cols[None] // tile >= (first // tile)[:, None])
               & (cols[None] // tile < ((end + tile - 1) // tile)[:, None]))
    k = _pad_cols(_gather(k_pages, None, page_indices), width, 2)
    v = _pad_cols(_gather(v_pages, None, page_indices), width, 2)
    v = torch.where(live[:, None, :, None], v, 0.0)
    s = (_highest("bhrd,bhkd->bhrk", q, k) if highest
         else torch.einsum("bhrd,bhkd->bhrk", q.float(), k))
    vs = None
    if k_scales_pages is not None:  # (B, KVH, width) per-row scales, 0 outside [first, end)
        ks, vs = (torch.where(live[:, None], _pad_cols(
            sc[page_indices.long()].transpose(1, 2).reshape(b, kvh, s_max), width, 2), 0.0)
                  for sc in (k_scales_pages, v_scales_pages))
        s = s * ks[:, :, None, :]
    s = softcap(s * scale, logit_softcap)
    lim = _row_limits(length, rows, draft_k, dev)  # (B, rows)
    hi = torch.minimum(lim, end[:, None] - 1)
    lo = lim - window if window else torch.full_like(lim, -1)
    seen = (cols[None, None] <= hi[..., None]) & (cols[None, None] > lo[..., None])
    s = torch.where(seen[:, None], s, torch.tensor(DEFAULT_MASK_VALUE, device=dev))
    s = torch.where(visited[:, None, None], s, torch.tensor(-float("inf"), device=dev))
    s = s.view(b, kvh, rows, n, per, tile)
    m_run = s.amax(-1).cummax(-1).values  # (B, KVH, rows, n, per)
    m_split = m_run[..., -1]
    vis = visited.view(b, 1, 1, n, per, tile)
    p = torch.where(vis, _exp(s - m_run[..., None]), 0.0)
    resc = torch.where(vis[..., 0], _exp(m_run - m_split[..., None]), 0.0)
    l_split = (p.sum(-1) * resc).sum(-1)  # (B, KVH, rows, n)
    v = v.view(b, kvh, n, per, tile, d)
    if highest:
        acc = _highest("bhrnpk,bhnpkd->bhrnd", p, v, resc[..., None])
    else:
        if vs is not None:
            p = p * vs.view(b, kvh, 1, n, per, tile)
        p = _two_term_bf16(p) * resc[..., None]
        acc = torch.einsum("bhrnpk,bhnpkd->bhrnd", p, v)
    if n == 1:
        l, o = l_split[..., 0], acc[..., 0, :]
    else:
        top = m_split.amax(-1, keepdim=True)
        w = torch.where(m_split == -float("inf"), 0.0, _exp(m_split - top))
        l, o = (w * l_split).sum(-1), (w[..., None] * acc).sum(-2)
    return (o * torch.where(l == 0, 1.0, 1.0 / l)[..., None]).to(q.dtype)


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
    pages_per_compute_block: int = 1,
    draft_k: int = 1,
    window: int | None = None,
    logit_softcap: float | None = None,
    interpret: bool | None = None,
) -> torch.Tensor:
    """Decode attention over a paged KV cache.

    Args:
      q: ``(B, KVH, G, d)`` current-token queries, grouped by KV head.  With
        ``draft_k = k > 1`` (speculative verification) its G rows are
        ``G_heads * k`` rows laid out k-minor: row ``g * k + j`` is query
        head g at draft position j, attending columns ``c <= len - k + j``.
      k_pages, v_pages: ``(P, KVH, page_size, d)`` head-major page pools, of
        q's dtype or (with the scale pools) int8 / fp8 payloads.
      k_scales_pages, v_scales_pages: float32 ``(P, KVH, page_size)``, given
        together for 8-bit pools: row j of a page is its payload times its
        scale.
      lengths: ``(B,)`` int32, tokens valid per request (q attends to
        ``[0, len)``; with drafts they include all k fed tokens).  A row of
        length 0 gets zeros; the JAX kernel leaves it unwritten
        (``decode.py:258``).
      page_indices: ``(B, pages_per_seq)`` int32 logical -> physical pages;
        only the first ``ceil(len / page_size)`` entries of a row are read
        (with a window, none before the page of column ``len - k - window +
        1``).
      draft_k: k query rows per head, each at its own position (see q).
      window: the query at position ``pos`` (``len - 1``, or ``len - k +
        j``) sees columns ``c > pos - window``.
      logit_softcap: scores become ``cap * tanh(s / cap)`` before the masks.
      pages_per_compute_block, interpret: the JAX package's keywords,
        accepted and ignored (its kernel ignores the first too; the CUDA
        kernels choose their own tiles, and a CPU tensor runs the plain
        version).

    Returns ``(B, KVH, G, d)`` in q's dtype.  Float32 q over bf16 or 8-bit
    pages is taken in bf16, as the JAX kernel takes it, where
    :func:`_f32_q_in_bf16` says so, and O comes back in float32.  The launch count is kept on
    this function (``.launches``; ``.launches_quantized`` and
    ``.launches_draft`` count the 8-bit and draft launches among them,
    ``.launches_tc``, ``.launches_tc_quantized`` and ``.launches_tc_draft``
    the tensor-core form's, and ``.launches_tc_f32`` and
    ``.launches_tc_f32_draft`` its float32 form's).
    """
    check_window(window, logit_softcap, causal=True)
    if q.dim() != 4 or k_pages.dim() != 4:
        raise ValueError(f"expected q (B,KVH,G,d), pages (P,KVH,ps,d): {q.shape} {k_pages.shape}")
    b, kvh, g, d = q.shape
    draft_k = int(draft_k)
    if draft_k < 1 or g % draft_k:
        raise ValueError(f"q group rows ({g}) must be a multiple of draft_k ({draft_k})")
    f32_q = _f32_q_in_bf16(q, k_pages, "paged_decode", g)
    qk = q.to(torch.bfloat16) if f32_q else q  # the q the kernel takes
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
    quantized = _check_pages(qk, k_pages, v_pages, k_scales_pages, v_scales_pages)
    scales = (k_scales_pages, v_scales_pages) if quantized else ()

    if not all(t.is_contiguous() for t in (q, k_pages, v_pages, lengths, page_indices, *scales)):
        raise ValueError("paged_attention takes contiguous tensors")
    form = kernel_form("paged_decode", qk.dtype, d, quantized=quantized, page_size=page_size,
                       rows=g)
    if q.device.type == "cpu":
        return paged_attention_plain(
            q, k_pages, v_pages, lengths, page_indices, scale=scale, draft_k=draft_k,
            window=window, logit_softcap=logit_softcap, k_scales_pages=k_scales_pages,
            v_scales_pages=v_scales_pages, form=form,
        )
    devs = {t.device for t in (q, k_pages, v_pages, lengths, page_indices, *scales)}
    if q.device.type != "cuda" or len(devs) != 1:
        raise ValueError(f"paged_attention: tensors on {sorted(map(str, devs))}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"paged_attention kernel takes float32 or bfloat16, got {q.dtype}")
    if d not in _HEAD_DIMS or (draft_k == 1 and g not in _GROUPS):
        raise ValueError(
            f"paged_attention kernel takes head_dim in {_HEAD_DIMS} and G in "
            f"{_GROUPS}, got d={d}, G={g}"
        )
    if lengths.dtype != torch.int32 or page_indices.dtype != torch.int32:
        raise ValueError("paged_attention kernel takes int32 lengths and page_indices")
    if b > 65535:
        raise ValueError(f"paged_attention kernel takes B <= 65535, got {b}")
    tc = form in ("tc", "tc_f32")
    if quantized or tc:
        kernels.check_aligned("paged_attention", *((qk, k_pages, v_pages) if tc
                                                   else (k_pages, v_pages)))
    # The tensor-core forms write float32 O themselves for float32 q.
    o = torch.empty_like(q if tc else qk)
    what = f"q {tuple(q.shape)} {q.dtype}, pages {k_pages.dtype}, draft_k {draft_k}"
    stream = torch.cuda.current_stream(q.device).cuda_stream
    scale_ptrs = [t.data_ptr() if quantized else None for t in (k_scales_pages, v_scales_pages)]
    if tc:
        # The splits' partials, O then (m, l) (none with one split: the
        # kernel writes O itself).
        pps = page_indices.shape[1]
        n, per = decode_splits(b, kvh, pps, page_size, sms=_sm_count(q.device))
        part = torch.empty(b * kvh * n * g * (d + 2) if n > 1 else 0, dtype=torch.float32,
                           device=q.device)
        part_o = part.data_ptr() or None
        part_ml = part_o and part_o + 4 * b * kvh * n * g * d
        ptrs = (qk.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr())
        tail = (lengths.data_ptr(), page_indices.data_ptr(), o.data_ptr(), part_o, part_ml, b,
                kvh, g, d, k_pages.shape[0], page_size, pps, n, per, draft_k, float(scale),
                *kernel_options(window, logit_softcap))
        if form == "tc_f32":  # float32 q over float32 pages, three bf16 terms
            name = "paged_decode_tc_f32"
            status = kernels.library(name).fa_paged_decode_tc_f32(*ptrs, *tail, stream)
        else:
            name = "paged_decode_tc" + ("_quant" if quantized else "")
            status = kernels.library(name).fa_paged_decode_tc(
                KV_DTYPES[k_pages.dtype], *ptrs, *scale_ptrs, *tail, int(f32_q), stream)
        kernels.check_launch(name, status, what)
    else:
        # The draft form and the 8-bit pages' forms (a library per d) build apart.
        name = "paged_decode" + ("_draft" if draft_k > 1 else "") + (f"_quant_d{d}" if quantized else "")
        status = kernels.library(name).fa_paged_decode(
            _DTYPES[qk.dtype], KV_DTYPES[k_pages.dtype], qk.data_ptr(), k_pages.data_ptr(),
            v_pages.data_ptr(), *scale_ptrs, lengths.data_ptr(), page_indices.data_ptr(),
            o.data_ptr(), b, kvh, g, d, page_size, page_indices.shape[1], draft_k, float(scale),
            *kernel_options(window, logit_softcap), stream,
        )
        kernels.check_launch(name, status, what)
    bf16_tc, f32_tc = form == "tc", form == "tc_f32"
    paged_attention.launches += 1
    paged_attention.launches_quantized += quantized
    paged_attention.launches_draft += draft_k > 1
    paged_attention.launches_tc += bf16_tc
    paged_attention.launches_tc_quantized += bf16_tc and quantized
    paged_attention.launches_tc_draft += bf16_tc and draft_k > 1
    paged_attention.launches_tc_f32 += f32_tc
    paged_attention.launches_tc_f32_draft += f32_tc and draft_k > 1
    return o.to(q.dtype)


# Kernel launches, for the chip run's path check: all forms, the 8-bit ones
# and the draft ones, the tensor-core form's (all, 8-bit, draft) and its
# float32 form's (all, draft) among them.
paged_attention.launches = 0
paged_attention.launches_quantized = 0
paged_attention.launches_draft = 0
paged_attention.launches_tc = 0
paged_attention.launches_tc_quantized = 0
paged_attention.launches_tc_draft = 0
paged_attention.launches_tc_f32 = 0
paged_attention.launches_tc_f32_draft = 0


# ── chunked prefill ──────────────────────────────────────────────────────────


def _segment_positions(ctx_lens, rows, chunk, seg, device):
    """(B, R) absolute position of each q row: ``ctx_len - chunk + r % seg``."""
    ctx = ctx_lens.to(device).long()
    return ctx[:, None] - chunk + (torch.arange(rows, device=device) % seg)[None, :]


def _prefill_mask(ctx_lens, rows, chunk, seg, s_max, window, device):
    """(B, R, S_max): row r at ``pos = ctx_len - chunk + r % seg`` sees
    ``col <= pos``, ``col < ctx_len`` and, with a window, ``col > pos - window``."""
    pos = _segment_positions(ctx_lens, rows, chunk, seg, device)[:, :, None]
    cols = torch.arange(s_max, device=device)[None, None, :]
    mask = (cols <= pos) & (cols < ctx_lens.to(device).long()[:, None, None])
    if window is not None:
        mask = mask & (cols > pos - window)
    return mask


def paged_prefill_attention_reference(
    q, k_pages, v_pages, page_indices, ctx_lens, *, chunk, seg=None, scale=1.0,
    window=None, logit_softcap=None, k_scales_pages=None, v_scales_pages=None,
):
    """Dense oracle of the batched layout: gather every page of each table
    (dequantized in float32 for 8-bit pages), anchor row r at
    ``ctx_len - chunk + r % seg``, mask ``col <= pos``, ``col < ctx_len`` and
    the window, attend in float32.  A row that sees no column gets the mean
    of the gathered V rows, as the JAX oracles give."""
    rows = q.shape[2]
    s_max = page_indices.shape[1] * k_pages.shape[2]
    k = _gather(k_pages, k_scales_pages, page_indices)
    v = _gather(v_pages, v_scales_pages, page_indices)
    s = softcap(torch.einsum("bhrd,bhkd->bhrk", q.float(), k) * scale, logit_softcap)
    mask = _prefill_mask(ctx_lens, rows, chunk, seg or rows, s_max, window, q.device)
    s = torch.where(mask[:, None], s, torch.tensor(DEFAULT_MASK_VALUE, device=q.device))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o = torch.einsum("bhrk,bhkd->bhrd", p, v) / p.sum(dim=-1, keepdim=True)
    return o.to(q.dtype)


def paged_prefill_attention_plain(
    q, k_pages, v_pages, page_indices, ctx_lens, *, chunk, seg=None, scale=1.0,
    window=None, logit_softcap=None, k_scales_pages=None, v_scales_pages=None, form=None,
):
    """The kernel's function in plain PyTorch: the oracle, with zeros for a
    row that sees no column (every row of a ``ctx_len == 0`` request, and a
    pad row whose window lies past the context), as the kernel writes them.

    ``form`` (default: ``ops.flash.kernel_form`` of these inputs) mirrors
    the kernel form's rounding: ``"tc"`` attends each request's gathered
    context through the tensor-core forward's plain version
    (``ops.flash.flash_attention_plain(form="tc")``: p as two bf16 terms
    against the running max of ``TC_KV_TILE`` columns, tiles aligned to
    column 0, as the paged kernel's are; 8-bit pages as payloads with their
    gathered scales), its chunk's rows at ``ctx_len - chunk + r % seg``;
    ``"tc_f32"`` (float32 pools) the same through the forward's float32
    form in the ``"float32"`` mode (three bf16 terms, six products, p
    against the running max of ``TC_F32_SPLIT_KV_TILE`` columns);
    ``"scalar"`` attends in float32.  Float32 q that the kernel takes in
    bf16 (:func:`_f32_q_in_bf16`) is taken so here: the form is the bf16
    call's, and O comes back in float32, from the float32 sums (tc) or
    through a bf16 store (scalar, bf16 pages)."""
    seg = seg or q.shape[2]
    args = (k_pages, v_pages, page_indices, ctx_lens)
    kw = dict(chunk=chunk, seg=seg, scale=scale, window=window, logit_softcap=logit_softcap,
              k_scales_pages=k_scales_pages, v_scales_pages=v_scales_pages)
    f32_q = _plain_f32_q(q, k_pages, form, "paged_prefill")
    if form is None:
        form = kernel_form("paged_prefill", torch.bfloat16 if f32_q else q.dtype, q.shape[3],
                           quantized=k_scales_pages is not None, page_size=k_pages.shape[2])
    if f32_q:
        qb = q.to(torch.bfloat16)
        return _paged_prefill_plain(qb.float() if form == "tc" else qb, *args, form=form,
                                    **kw).float()
    return _paged_prefill_plain(q, *args, form=form, **kw)


def _paged_prefill_plain(q, k_pages, v_pages, page_indices, ctx_lens, *, chunk, seg, scale,
                         window, logit_softcap, k_scales_pages, v_scales_pages, form):
    """:func:`paged_prefill_attention_plain` in the form ``form``."""
    s_max = page_indices.shape[1] * k_pages.shape[2]
    rows = q.shape[2]
    if form in ("tc", "tc_f32"):
        k = _gather(k_pages, None, page_indices)
        v = _gather(v_pages, None, page_indices)
        ks = vs = [None] * len(k)
        if k_scales_pages is not None:  # (B, KVH, S_max) per-row scales
            ks, vs = (sc[page_indices.long()].transpose(1, 2).reshape(*k.shape[:3])
                      for sc in (k_scales_pages, v_scales_pages))
        o = torch.stack([
            flash_attention_plain(
                q[b], k[b], v[b], causal=True, scale=scale, kv_len=min(n, s_max),
                q_offset=n - chunk, q_seq_len=seg, window=window, logit_softcap=logit_softcap,
                form=form, k_scales=ks[b], v_scales=vs[b],
                precision="float32" if form == "tc_f32" else None)
            for b, n in enumerate(ctx_lens.tolist())])
    else:
        o = paged_prefill_attention_reference(
            q, k_pages, v_pages, page_indices, ctx_lens, chunk=chunk, seg=seg, scale=scale,
            window=window, logit_softcap=logit_softcap, k_scales_pages=k_scales_pages,
            v_scales_pages=v_scales_pages)
    seen = _prefill_mask(ctx_lens, rows, chunk, seg, s_max, window, q.device).any(-1)
    return torch.where(seen[:, None, :, None], o, torch.zeros_like(o))


def _check_pages(q, k_pages, v_pages, k_scales_pages, v_scales_pages) -> bool:
    """Check the pools' types and scale pools (:func:`ops.flash.check_kv`);
    True for 8-bit pages."""
    try:
        return check_kv(q, k_pages, v_pages, k_scales_pages, v_scales_pages, k_pages.shape[:3])
    except ValueError as e:
        raise ValueError(f"pages: {e}") from None


def paged_prefill_attention_batched(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    page_indices: torch.Tensor,
    ctx_lens: torch.Tensor,
    *,
    chunk: int,
    seg: int | None = None,
    k_scales_pages=None,
    v_scales_pages=None,
    scale: float = 1.0,
    block_q: int = 512,
    window: int | None = None,
    logit_softcap: float | None = None,
    interpret: bool | None = None,
) -> torch.Tensor:
    """Chunked-prefill attention straight off the paged pool, many requests
    in one launch.

    Args:
      q: ``(B, KVH, R, d)``: ``R = G * seg`` rows, G query heads per KV head,
        each a ``seg``-row segment whose row p sits at absolute position
        ``ctx_lens[b] - chunk + p``; rows ``p >= chunk`` are padding, their
        outputs are the caller's to drop.  ``seg=None``: one segment.
      k_pages, v_pages: ``(P, KVH, page_size, d)`` head-major pools, of q's
        dtype or (with the scale pools) int8 / fp8 payloads.
      k_scales_pages, v_scales_pages: float32 ``(P, KVH, page_size)``, given
        together for 8-bit pools.
      page_indices: ``(B, pps)`` int32 per-request tables; entries past the
        live pages may be any page (their columns are masked).
      ctx_lens: ``(B,)`` int32 live context tokens including this chunk.  A
        request with ``ctx_lens[b] == 0`` (batch padding) gets zeros; the
        JAX kernel leaves it unwritten.
      block_q: the JAX kernel's q tile, accepted for parity; the CUDA tile is
        the kernel's own (the tensor-core form's 128 rows; the scalar
        form's 32, 16 at d = 256).
      interpret: the JAX package's Pallas interpreter switch, accepted and
        ignored.
      window: row p sees columns ``c > pos - window``; no table entry of a
        page wholly before a tile's window is read.
      logit_softcap: scores become ``cap * tanh(s / cap)`` before the masks.

    Returns ``(B, KVH, R, d)`` in q's dtype (float32 q over bf16 or 8-bit
    pages is taken in bf16, as the JAX kernel takes it, where
    :func:`_f32_q_in_bf16` says so).  The
    launch count is kept on this function (``.launches``; ``.launches_tc``, ``.launches_quantized``
    and ``.launches_tc_quantized`` count the tensor-core, the 8-bit and the
    tensor-core 8-bit forms' among them, ``.launches_tc_f32`` the float32
    form's); :func:`paged_prefill_attention` launches through it.
    """
    check_window(window, logit_softcap, causal=True)
    if q.dim() != 4 or k_pages.dim() != 4:
        raise ValueError(f"expected q (B,KVH,R,d), pages (P,KVH,ps,d): {q.shape} {k_pages.shape}")
    b, kvh, rows, d = q.shape
    num_pages, kvh2, page_size, d2 = k_pages.shape
    if (kvh2, d2) != (kvh, d):
        raise ValueError(f"q/k_pages mismatch: {tuple(q.shape)} vs {tuple(k_pages.shape)}")
    if k_pages.shape != v_pages.shape:
        raise ValueError(f"k/v pages mismatch: {tuple(k_pages.shape)} vs {tuple(v_pages.shape)}")
    if ctx_lens.shape != (b,) or page_indices.dim() != 2 or page_indices.shape[0] != b:
        raise ValueError(
            f"ctx_lens {tuple(ctx_lens.shape)} / page_indices {tuple(page_indices.shape)} "
            f"do not match batch {b}"
        )
    seg = rows if seg is None else int(seg)
    if seg <= 0 or rows % seg:
        raise ValueError(f"q rows ({rows}) must be a multiple of seg ({seg})")
    if not 0 < chunk <= seg:
        raise ValueError(f"chunk ({chunk}) must lie in [1, seg={seg}]")
    f32_q = _f32_q_in_bf16(q, k_pages, "paged_prefill")
    qk = q.to(torch.bfloat16) if f32_q else q  # the q the kernel takes
    quantized = _check_pages(qk, k_pages, v_pages, k_scales_pages, v_scales_pages)
    scales = (k_scales_pages, v_scales_pages) if quantized else ()

    args = (q, k_pages, v_pages, page_indices, ctx_lens)
    if not all(t.is_contiguous() for t in (*args, *scales)):
        raise ValueError("paged_prefill_attention takes contiguous tensors")
    form = kernel_form("paged_prefill", qk.dtype, d, quantized=quantized, page_size=page_size)
    if q.device.type == "cpu":
        return paged_prefill_attention_plain(
            *args, chunk=chunk, seg=seg, scale=scale, window=window, logit_softcap=logit_softcap,
            k_scales_pages=k_scales_pages, v_scales_pages=v_scales_pages, form=form,
        )
    devs = {t.device for t in (*args, *scales)}
    if q.device.type != "cuda" or len(devs) != 1:
        raise ValueError(f"paged_prefill_attention: tensors on {sorted(map(str, devs))}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"paged_prefill_attention kernel takes float32 or bfloat16, got {q.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"paged_prefill_attention kernel takes head_dim in {_HEAD_DIMS}, got d={d}")
    if ctx_lens.dtype != torch.int32 or page_indices.dtype != torch.int32:
        raise ValueError("paged_prefill_attention kernel takes int32 ctx_lens and page_indices")
    if b > 65535 or kvh > 65535:
        raise ValueError(f"paged_prefill_attention kernel takes B, KVH <= 65535, got {b}, {kvh}")
    kernels.check_aligned("paged_prefill_attention", qk, k_pages, v_pages)
    # The tensor-core forms write float32 O themselves for float32 q.
    o = torch.empty_like(q if form in ("tc", "tc_f32") else qk)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if form == "tc_f32":  # float32 q over float32 pools, three bf16 terms
        status = kernels.library("paged_prefill_tc_f32").fa_paged_prefill_tc_f32(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), page_indices.data_ptr(),
            ctx_lens.data_ptr(), o.data_ptr(), b, kvh, rows, d, num_pages, page_size,
            page_indices.shape[1], int(chunk), seg, float(scale),
            *kernel_options(window, logit_softcap), stream,
        )
        kernels.check_launch("paged_prefill_tc_f32", status,
                             f"q {tuple(q.shape)}, float32 pages {page_size}")
        paged_prefill_attention_batched.launches += 1
        paged_prefill_attention_batched.launches_tc_f32 += 1
        return o
    if form == "tc":
        name, quant = "paged_prefill_tc", ()
        if quantized:  # the 8-bit form: the payload's type code and the scale pools
            name = "paged_prefill_tc_quant"
            quant = (KV_DTYPES[k_pages.dtype], k_scales_pages.data_ptr(), v_scales_pages.data_ptr())
        status = getattr(kernels.library(name), kernels.KERNELS[name][1])(
            *quant, qk.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), page_indices.data_ptr(),
            ctx_lens.data_ptr(), o.data_ptr(), b, kvh, rows, d, num_pages, page_size,
            page_indices.shape[1], int(chunk), seg, float(scale),
            *kernel_options(window, logit_softcap), int(f32_q), stream,
        )
        kernels.check_launch(name, status, f"q {tuple(q.shape)}, pages {k_pages.dtype} {page_size}")
        paged_prefill_attention_batched.launches += 1
        paged_prefill_attention_batched.launches_tc += 1
        paged_prefill_attention_batched.launches_quantized += quantized
        paged_prefill_attention_batched.launches_tc_quantized += quantized
        return o
    name = "paged_prefill_quant" if quantized else "paged_prefill"
    status = kernels.library(name).fa_paged_prefill(
        _DTYPES[qk.dtype], KV_DTYPES[k_pages.dtype], qk.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), *(t.data_ptr() if quantized else None for t in (k_scales_pages, v_scales_pages)),
        page_indices.data_ptr(), ctx_lens.data_ptr(), o.data_ptr(),
        b, kvh, rows, d, num_pages, page_size, page_indices.shape[1], int(chunk),
        seg, float(scale), *kernel_options(window, logit_softcap), stream,
    )
    kernels.check_launch(name, status, f"q {tuple(q.shape)} {q.dtype}, pages {k_pages.dtype}")
    paged_prefill_attention_batched.launches += 1
    paged_prefill_attention_batched.launches_quantized += quantized
    return o.to(q.dtype)


# Kernel launches, for the chip run's path check: all forms, and the
# tensor-core, 8-bit, tensor-core 8-bit and float32 tensor-core ones among
# them.
paged_prefill_attention_batched.launches = 0
paged_prefill_attention_batched.launches_tc = 0
paged_prefill_attention_batched.launches_tc_f32 = 0
paged_prefill_attention_batched.launches_quantized = 0
paged_prefill_attention_batched.launches_tc_quantized = 0


def paged_prefill_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    page_indices: torch.Tensor,
    ctx_len,
    *,
    chunk: int,
    seg: int | None = None,
    k_scales_pages=None,
    v_scales_pages=None,
    scale: float = 1.0,
    block_q: int = 512,
    window: int | None = None,
    logit_softcap: float | None = None,
    interpret: bool | None = None,
) -> torch.Tensor:
    """Chunked-prefill attention for one request: q ``(KVH, R, d)``,
    page_indices ``(pps,)``, ctx_len an int or a one-element int32 tensor.
    It is :func:`paged_prefill_attention_batched` with B = 1 (one launch).
    Returns ``(KVH, R, d)``."""
    if torch.is_tensor(ctx_len):
        ctx = ctx_len.reshape(1).to(device=q.device, dtype=torch.int32)
    else:
        ctx = torch.tensor([int(ctx_len)], dtype=torch.int32, device=q.device)
    if q.dim() != 3 or page_indices.dim() != 1:
        raise ValueError(
            f"expected q (KVH,R,d) and page_indices (pps,): {tuple(q.shape)} "
            f"{tuple(page_indices.shape)}"
        )
    return paged_prefill_attention_batched(
        q[None], k_pages, v_pages, page_indices[None], ctx, chunk=chunk, seg=seg,
        k_scales_pages=k_scales_pages, v_scales_pages=v_scales_pages, scale=scale,
        block_q=block_q, window=window, logit_softcap=logit_softcap,
    )[0]
