"""Flash-attention backward: dQ, dK, dV from the saved statistics, and the
differentiable attention op.

Counterpart of ``flashattention_tpu/ops/backward.py``.  With
``lse_i = m_i + log l_i``, the score ``s_ij = scale * q_i . k_j`` (capped to
``cap * tanh(s_ij / cap)`` with a logit softcap) and ``P_ij = exp(s_ij -
lse_i)`` (backward.py:8-13, :216-249)::

    dV_j = sum_i P_ij dO_i        dP_ij = dO_i . V_j
    dS_ij = P_ij (dP_ij - D_i) scale c_ij,   D_i = dO_i . O_i
    dQ_i = sum_j dS_ij K_j        dK_j = sum_i dS_ij Q_i

where ``c_ij = 1 - (s_ij / cap)^2``, the softcap's derivative at the capped
score (1 without a cap).  A masked ``P`` (causal, sliding window, kv_len,
segment ids, a block mask's dead pairs) is exactly 0.  With attention
dropout at rate r and the forward's keep bits M (regenerated from the same
seed and coordinates, ``ops.flash.dropout_keep_mask``), dV sums
``Z = M P / (1 - r)`` and ``dP = M (dO_i . V_j) / (1 - r)``; D and dS keep
their form (backward.py:238-246, :353-378, :487-498).  On CUDA tensors
:func:`flash_attention_bwd` launches hand-written kernels: the fused
one-pass kernel (replaces ``_fused_bwd_kernel``, backward.py:401) by
default, in bf16 at head_dim 64, 128 or 256 its tensor-core form
``csrc/flash_bwd_tc.cu``, in float32 at head_dim 64, 128 or 256 in the JAX
modes ``"bf16_3x"`` (the default) and ``"bf16"`` its float32 form (the same
source built with ``-DFA_F32``: the five products over bf16 terms, as the JAX
``_dot_g`` computes them), else ``csrc/flash_bwd.cu``
(``ops.flash.kernel_form``); and the two-pass pair (replaces ``_dq_kernel``
:146 and ``_dkv_kernel`` :269) with segment ids, a block mask or
``fused=False``, as the JAX package chooses (backward.py:610-615): in bf16
at head_dim 64, 128 or 256 its tensor-core forms ``csrc/flash_bwd_dq_tc.cu``
and ``csrc/flash_bwd_tc.cu`` built with ``-DFA_PAIR``, which skip the pairs
of tiles whose segment ids never meet (:func:`seg_tile_ranges`) and a block
mask's dead tiles (its table over their own tiles, :data:`TC_DQ_TILE` and
:func:`tc_dkv_tile`), in float32 at head_dim 64, 128 or 256 in ``"bf16_3x"``
and ``"bf16"`` their float32 forms (the same sources built with ``-DFA_F32``:
q, k, v and dO split once into bf16 terms for both passes, each product
three of them at d = 128 and 256 as ``_dot_g`` and four at d = 64 as the
JAX pair's lane-packed products, backward.py:57-93), else ``csrc/flash_bwd_dq.cu`` +
``csrc/flash_bwd_dkv.cu``.  On CPU tensors it runs
:func:`flash_attention_bwd_plain`, the same function written from the
formulas above in plain PyTorch.  There is no fallback between the two.

:func:`attention_vjp` is the differentiable entry: a
``torch.autograd.Function`` whose forward is the flash forward kernel saving
``(o, lse)`` and whose backward is :func:`flash_attention_bwd`.

Not carried over: the TPU's lane packing of fp32 operands as a layout (its
four products are kept) and its accumulation-chain splits
(backward.py:49-119), MXU techniques with no counterpart here, and the 32
MB VMEM gate on the fused kernel's dQ scratch (backward.py:614, :785): the
fused CUDA kernel adds dQ into a float32 buffer in device memory.
"""

from __future__ import annotations

import torch

from flashattention_tpu_torch.ops import kernels
from flashattention_tpu_torch.ops.flash import (
    _DTYPES,
    _HEAD_DIMS,
    check_block_mask,
    check_dropout,
    check_window,
    dense_keep,
    dropout_options,
    flash_attention,
    _exp,
    _split_bf16,
    _two_term_bf16,
    fold_segment_ids,
    head_chunks,
    kernel_form,
    kernel_options,
    resolve_precision,
    visible,
    wrap_int32,
)
from flashattention_tpu_torch.ops.reference import softcap

__all__ = [
    "attention_vjp",
    "dkv_kernel",
    "dq_kernel",
    "flash_attention_bwd",
    "flash_attention_bwd_plain",
    "fused_bwd_kernel",
    "seg_tile_ranges",
]

def _check_tpu_options(dtype, block_sizes=None, precision=None, interpret=None):
    """The JAX signature's TPU knobs: ``precision`` is resolved as the JAX
    package resolves it (:func:`ops.flash.resolve_precision`) and returned;
    the float32 forms of the fused backward and the pair compute
    ``"bf16_3x"`` and ``"bf16"`` where they are built (:func:`bwd_form`),
    the scalar kernels float32 exactly.  ``interpret`` is accepted and
    ignored, and ``block_sizes`` has no counterpart: the CUDA kernels have
    their own tiles."""
    if block_sizes is not None:
        raise ValueError(
            "block_sizes is a TPU option; the CUDA backward kernels have their own tiles"
        )
    return resolve_precision(precision, dtype)


def flash_attention_bwd(
    q, k, v, o, lse, do, *, causal=False, scale=1.0, block_sizes=None, kv_len=None,
    q_offset=0, precision=None, q_seq_len=None, interpret=None, fused=None,
    window=None, logit_softcap=None, dropout_rate=None, dropout_seed=0,
    q_segment_ids=None, kv_segment_ids=None, block_mask=None, dropout_row_stride=None,
):
    """dQ, dK, dV from the saved output and logsumexp.

    Args:
      q, o, do: ``(BH, R, d)``; k, v: ``(BH, S_kv, d)``; one dtype (float32
        or bfloat16), contiguous.  lse: ``(BH, R)`` float32, ``m + log l``
        of the forward's statistics.
      causal, scale, kv_len, q_offset, q_seq_len, window, logit_softcap: as
        in the forward, whose ``lse`` this must be.
      fused: the one-pass kernel (default without segment ids or a block
        mask) or the two-pass kernels (``False``; the default with either).
      q_segment_ids, kv_segment_ids: integer ``(BH, R)``, ``(BH, S_kv)``.
      dropout_rate, dropout_seed, dropout_row_stride, block_mask: as in the
        forward (:func:`ops.flash.flash_attention`), whose output this is.
      precision: the JAX package's mode for float32 inputs (default
        ``"bf16_3x"``): the float32 forms of the fused backward and of the
        pair compute it at head_dim 64, 128 and 256 (:func:`bwd_form`), else
        float32 is exact.

    ``D = rowsum(O dO)`` is computed here in float32, outside the kernels
    (backward.py:707-709).  Returns ``(dq, dk, dv)`` in the input dtypes.
    """
    precision = _check_tpu_options(q.dtype, block_sizes, precision, interpret)
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"expected (BH, S, d) tensors, got {q.shape} {k.shape} {v.shape}")
    bh, rows, d = q.shape
    s_kv = k.shape[1]
    if k.shape != v.shape or k.shape[0] != bh or k.shape[2] != d:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} and do {tuple(do.shape)} must be shaped like q")
    if tuple(lse.shape) != (bh, rows):
        raise ValueError(f"lse must be (BH, R)=({bh}, {rows}), got {tuple(lse.shape)}")
    if not (q.dtype == k.dtype == v.dtype == do.dtype):
        raise ValueError(f"q/k/v/do dtypes differ: {q.dtype} {k.dtype} {v.dtype} {do.dtype}")
    if block_mask is not None:
        check_block_mask(block_mask, rows, s_kv, causal=causal, window=window,
                         q_seq_len=q_seq_len)
    kw = _opts(q, k, causal, scale, kv_len, q_offset, q_seq_len, window, logit_softcap,
               dropout_rate, dropout_seed, dropout_row_stride)
    if not 0 <= kw["kv_len"] <= s_kv:
        raise ValueError(f"kv_len {kw['kv_len']} outside [0, {s_kv}]")
    if kw["q_seq_len"] <= 0 or rows % kw["q_seq_len"]:
        raise ValueError(f"q_seq_len ({kw['q_seq_len']}) must divide the rows ({rows})")
    seg_q, seg_kv = fold_segment_ids(q_segment_ids, kv_segment_ids, bh, rows, s_kv, q.device)
    if fused is None:
        fused = seg_q is None and block_mask is None
    if fused and seg_q is not None:
        raise ValueError("fused backward does not support segment ids; use fused=False")
    if fused and block_mask is not None:
        raise ValueError("fused backward does not support block_mask; use fused=False")
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(
            q, k, v, o, lse, do, q_segment_ids=seg_q, kv_segment_ids=seg_kv,
            block_mask=block_mask, form=bwd_form(q, fused, block_mask is not None, precision),
            precision=precision, fused=fused, **kw
        )
    di = (o.float() * do.float()).sum(dim=-1)
    lse = lse.float().contiguous()
    if fused:
        return fused_bwd_kernel(q, k, v, do, lse, di, precision=precision, **kw)
    two_pass = dict(q_segment_ids=seg_q, kv_segment_ids=seg_kv, block_mask=block_mask,
                    precision=precision, **kw)
    split = None
    if bwd_form(q, False, block_mask is not None, precision) == "tc_f32":
        split = _split_buffers(q, k, precision)  # filled by dQ's launch, read by dK/dV's
    dq = dq_kernel(q, k, v, do, lse, di, split_rows=split and (split, False), **two_pass)
    dk, dv = dkv_kernel(q, k, v, do, lse, di, split_rows=split and (split, True), **two_pass)
    return dq, dk, dv


def _bwd_plain(q, k, v, do, lse, di, *, causal, scale, kv_len, q_offset, q_seq_len,
               window=None, logit_softcap=None, q_segment_ids=None, kv_segment_ids=None,
               dropout_rate=None, dropout_seed=0, dropout_row_stride=None, block_mask=None,
               form="scalar", precision=None, pair=False):
    """The backward from the formulas, float32 throughout (on the CPU
    ``exp`` in float64, rounded once: see ``ops.flash._exp``): ``(dq, dk,
    dv)`` in float32, with the capped score ``s``, ``P`` recomputed as ``exp(s -
    lse)`` and 0 where masked, dS times the softcap's derivative ``1 - (s /
    cap)^2``, and with dropout dV from ``Z = M P / (1 - r)`` and dS from the
    kept ``dP``.  ``form="tc"`` mirrors the tensor-core kernel: Z and dS
    fed to their products as two bfloat16 terms (``ops.flash._two_term_bf16``).
    ``form="tc_f32"`` (float32 inputs) mirrors its float32 form in the mode
    ``precision`` resolves to: in ``"bf16_3x"`` each of the five products
    as the JAX ``_dot_g`` computes it (flash.py:149-181), hi hi + hi lo + lo
    hi over both operands' bf16 terms (:func:`_dot3`), and in the two-pass
    pair (``pair``) at ``2 d <= 128``, where the JAX pair is lane-packed
    (backward.py:713-729), ``+ lo lo`` too (:func:`_dot4`: its
    ``_packed_nt`` and ``_packed_fold``, :57-93); in ``"bf16"`` the ``"tc"``
    form over q, k, v and dO rounded to bf16 once.  Head by head in chunks,
    to bound the temporaries."""
    mm = torch.einsum
    if form == "tc_f32":
        mm = _dot4 if pair and 2 * q.shape[2] <= 128 else _dot3
        if resolve_precision(precision, torch.float32) == "bf16":
            q, k, v, do = (x.to(torch.bfloat16).float() for x in (q, k, v, do))
            form, mm = "tc", torch.einsum
    bh, rows, s_kv = q.shape[0], q.shape[1], k.shape[1]
    mask = visible(
        rows, s_kv, causal=causal, kv_len=kv_len, q_offset=q_offset, q_seq_len=q_seq_len,
        window=window, block_mask=block_mask, device=q.device,
    )
    outs = []
    for heads in head_chunks(bh, rows * s_kv):
        sl = slice(heads.start, heads.stop)
        seg_mask = mask
        if q_segment_ids is not None:
            seg_mask = mask & (q_segment_ids[sl, :, None] == kv_segment_ids[sl, None, :])
        keep = None
        if dropout_rate:
            keep = dense_keep(dropout_seed, dropout_rate, heads, rows, s_kv, q_seq_len,
                              dropout_row_stride, q.device)
        outs.append(_bwd_plain_heads(q[sl], k[sl], v[sl], do[sl], lse[sl], di[sl], seg_mask, keep,
                                     scale=scale, logit_softcap=logit_softcap,
                                     dropout_rate=dropout_rate, form=form, mm=mm))
    return tuple(torch.cat(x) for x in zip(*outs))


def _dot3(eq, a, b):
    """``einsum(eq, a, b)`` at the JAX package's ``"bf16_3x"``
    (``_dot_g``, flash.py:165-181): both operands split into bf16 terms
    (``ops.flash._split_bf16``), ``hi hi + hi lo + lo hi`` summed in float32
    in that order."""
    (ah, al), (bh, bl) = _split_bf16(a), _split_bf16(b)
    return torch.einsum(eq, ah, bh) + torch.einsum(eq, ah, bl) + torch.einsum(eq, al, bh)


def _dot4(eq, a, b):
    """``einsum(eq, a, b)`` as the JAX pair's lane-packed products compute
    it (``_packed_nt``, ``_packed_fold``, backward.py:57-93): :func:`_dot3`'s
    three products and ``lo lo``, summed in float32 in that order."""
    (ah, al), (bh, bl) = _split_bf16(a), _split_bf16(b)
    return (torch.einsum(eq, ah, bh) + torch.einsum(eq, ah, bl) + torch.einsum(eq, al, bh)
            + torch.einsum(eq, al, bl))


def _bwd_plain_heads(q, k, v, do, lse, di, mask, keep, *, scale, logit_softcap, dropout_rate,
                     form, mm):
    """_bwd_plain over some heads, each product by ``mm``."""
    qf, kf, dof = q.float(), k.float(), do.float()
    s = softcap(mm("bqd,bkd->bqk", qf, kf) * scale, logit_softcap)
    p = torch.where(mask, _exp(s - lse.float()[..., None]), 0.0)
    del mask
    cap_factor = None if logit_softcap is None else 1.0 - (s / logit_softcap) ** 2
    del s
    z = p
    if keep is not None:
        inv = 1.0 / (1.0 - dropout_rate)
        z = torch.where(keep, p, 0.0) * inv
    dv = mm("bqk,bqd->bkd", _two_term_bf16(z) if form == "tc" else z, dof)
    del z
    ds = mm("bqd,bkd->bqk", dof, v.float())
    if keep is not None:
        ds = torch.where(keep, ds, 0.0) * inv
        del keep
    ds = p * (ds - di[..., None]) * scale
    del p
    if cap_factor is not None:
        ds *= cap_factor
        del cap_factor
    if form == "tc":
        ds = _two_term_bf16(ds)
    dq = mm("bqk,bkd->bqd", ds, kf)
    dk = mm("bqk,bqd->bkd", ds, qf)
    return dq, dk, dv


def flash_attention_bwd_plain(
    q, k, v, o, lse, do, *, causal=False, scale=1.0, kv_len=None, q_offset=0,
    q_seq_len=None, window=None, logit_softcap=None, q_segment_ids=None, kv_segment_ids=None,
    dropout_rate=None, dropout_seed=0, dropout_row_stride=None, block_mask=None, form=None,
    precision=None, fused=None,
):
    """The backward kernels' function in plain PyTorch: the CPU path of
    :func:`flash_attention_bwd` and the kernels' yardstick on the card.
    Computed in float32; returns ``(dq, dk, dv)`` in the input dtypes.
    ``form`` mirrors the rounding of a kernel form (see :func:`_bwd_plain`;
    ``"tc_f32"`` in the mode ``precision``, of the fused kernel or, with
    ``fused=False``, of the two-pass pair); by default the form
    :func:`flash_attention_bwd` would take for these inputs: the fused
    kernel's without segment ids or a block mask, else the two-pass pair's
    (:func:`bwd_form`)."""
    rows, s_kv = q.shape[1], k.shape[1]
    if fused is None:
        fused = q_segment_ids is None and block_mask is None
    if form is None:
        form = bwd_form(q, fused, block_mask is not None, precision)
    di = (o.float() * do.float()).sum(dim=-1)
    dq, dk, dv = _bwd_plain(
        q, k, v, do, lse, di, causal=causal, scale=scale,
        kv_len=s_kv if kv_len is None else kv_len, q_offset=q_offset,
        q_seq_len=rows if q_seq_len is None else q_seq_len, window=window,
        logit_softcap=logit_softcap, q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
        dropout_rate=check_dropout(dropout_rate), dropout_seed=wrap_int32(dropout_seed),
        dropout_row_stride=dropout_row_stride, block_mask=block_mask, form=form,
        precision=precision, pair=not fused,
    )
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def bwd_form(q, fused, block_mask=False, precision=None):
    """The form of a backward call (``ops.flash.kernel_form``): the fused
    kernel's, or the two-pass pair's (``block_mask``: the call has one),
    float32 in the mode ``precision``.  Both kernels of the pair take the
    same form."""
    if fused:
        return kernel_form("flash_bwd", q.dtype, q.shape[2], precision=precision)
    return kernel_form("flash_bwd_dq", q.dtype, q.shape[2], block_mask=block_mask,
                       precision=precision)


def _terms(precision):
    """The float32 forms' bf16 terms a value: two, ``[hi | lo]``, in
    ``"bf16_3x"``; one, ``bf16(x)``, in ``"bf16"``."""
    return 2 if precision == "bf16_3x" else 1


def _split_buffers(q, k, precision):
    """The float32 forms' bf16 term buffers of q, k, v and dO (rows of
    :func:`_terms` terms), which their split pass fills."""
    bh, rows, d = q.shape
    return [torch.empty((bh, n, _terms(precision) * d), dtype=torch.bfloat16, device=q.device)
            for n in (rows, k.shape[1], k.shape[1], rows)]


# Rows per entry of the pair's segment range tables (fa_bwd::kSegTile in
# csrc/bwd_common.cuh).
SEG_TILE = 64


def seg_tile_ranges(ids, tile=SEG_TILE):
    """The ``[min, max]`` of every ``tile`` rows of folded segment ids
    ``(BH, n)``: an int32 ``(BH, ceil(n / tile), 2)`` table (the last tile
    over its existing rows).  The pair's tensor-core kernels skip a pair of
    tiles whose ranges are disjoint: they share no id, whatever the order
    of the ids, so the skip is exact."""
    bh, n = ids.shape
    pad = -n % tile
    if pad:  # repeat the last id: the range stays the existing rows'
        ids = torch.cat([ids, ids[:, -1:].expand(bh, pad)], dim=1)
    tiles = ids.reshape(bh, -1, tile)
    return torch.stack([tiles.amin(dim=2), tiles.amax(dim=2)], dim=2).to(torch.int32).contiguous()


def _launch_args(name, q, k, v, do, lse, di, seg_q=None, seg_kv=None):
    """Check what a backward kernel takes; raise on anything else."""
    tensors = (q, k, v, do, lse, di) + (() if seg_q is None else (seg_q, seg_kv))
    if seg_q is not None and (seg_q.dtype != torch.int32 or seg_kv.dtype != torch.int32):
        raise ValueError(f"{name}: segment ids must be int32, got {seg_q.dtype} {seg_kv.dtype}")
    if any(t.device != q.device for t in tensors) or q.device.type != "cuda":
        raise ValueError(f"{name}: tensors on {[str(t.device) for t in tensors]}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"{name} kernel takes float32 or bfloat16, got {q.dtype}")
    bh, rows, d = q.shape
    if d not in _HEAD_DIMS:
        raise ValueError(f"{name} kernel takes head_dim in {_HEAD_DIMS}, got {d}")
    if bh > 65535:
        raise ValueError(f"{name} kernel takes BH <= 65535, got {bh}")
    if lse.dtype != torch.float32 or di.dtype != torch.float32:
        raise ValueError(f"{name}: lse and di must be float32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} takes contiguous tensors")
    kernels.check_aligned(name, q, k, v, do)
    return _DTYPES[q.dtype], bh, rows, k.shape[1], d


def _ptr(t):
    return None if t is None else t.data_ptr()


def _opts(q, k, causal, scale, kv_len, q_offset, q_seq_len, window, logit_softcap,
          dropout_rate=None, dropout_seed=0, dropout_row_stride=None):
    """The launchers' options with kv_len, q_seq_len and the dropout seed
    defaulted (the seed as an int32)."""
    check_window(window, logit_softcap, causal)
    return dict(causal=bool(causal), scale=float(scale),
                kv_len=k.shape[1] if kv_len is None else int(kv_len), q_offset=int(q_offset),
                q_seq_len=q.shape[1] if q_seq_len is None else int(q_seq_len),
                window=None if window is None else int(window),
                logit_softcap=None if logit_softcap is None else float(logit_softcap),
                dropout_rate=check_dropout(dropout_rate), dropout_seed=wrap_int32(dropout_seed),
                dropout_row_stride=dropout_row_stride)


def _scalars(kw):
    """The C entry points' trailing options, after the tensors and shapes."""
    return (kw["kv_len"], kw["q_offset"], kw["q_seq_len"], int(kw["causal"]), kw["scale"],
            *kernel_options(kw["window"], kw["logit_softcap"]),
            *dropout_options(kw["dropout_rate"], kw["dropout_seed"], kw["dropout_row_stride"],
                             kw["q_seq_len"]))


# Rows (and key columns) per tile of the backward kernels by head_dim
# (``Layout<D>::kTile`` in csrc/bwd_common.cuh): a block mask's table is
# built over (tile, tile) tiles.
def bwd_tile(d: int) -> int:
    return 16 if d >= 256 else 64 if d <= 16 else 32


def _mask_tiles(block_mask, q, by_q):
    """A block mask's (ptr, idx, part, bits) for the C interface, by query
    tile (dQ) or by key tile (dK/dV); or four nulls."""
    if block_mask is None:
        return (None,) * 4
    tile = bwd_tile(q.shape[2])
    tiles = block_mask.tiles(tile, tile, q.device)
    return tiles.by_q() if by_q else tiles.by_kv()


# The pair's tensor-core tiles (csrc/flash_bwd_dq_tc.cu's kBlockM x kN, and
# flash_bwd_tc.cu's query tile x its block's key rows): a block mask's table
# is built over them.
TC_DQ_TILE = (128, 64)


def tc_dkv_tile(d: int) -> tuple[int, int]:
    return (64, 64 if d >= 256 else 128)


def _tc_mask_tiles(block_mask, q, by_q):
    """A block mask's (ptr, idx, part, bits) for a tensor-core form of the
    pair, by query tile (dQ) or by key tile (dK/dV, the bits by key row); or
    four nulls."""
    if block_mask is None:
        return (None,) * 4
    tile_q, tile_kv = TC_DQ_TILE if by_q else tc_dkv_tile(q.shape[2])
    tiles = block_mask.tiles(tile_q, tile_kv, q.device)
    return tiles.by_q() if by_q else tiles.tc_by_kv()


def _library(name, kw, block_mask=None):
    """The kernel's library: its dropout / block-mask form's with either."""
    extra = kw["dropout_rate"] is not None or block_mask is not None
    return name + "_extra" if extra else name


def _count(fn, kw, block_mask=None, form="scalar"):
    fn.launches += 1
    fn.launches_dropout += kw["dropout_rate"] is not None
    if form == "tc_f32":
        fn.launches_tc_f32 += 1
        fn.launches_tc_f32_dropout += kw["dropout_rate"] is not None
    if block_mask is not None:
        fn.launches_block_mask += 1
    if form == "tc":
        fn.launches_tc += 1
        fn.launches_tc_dropout += kw["dropout_rate"] is not None
        fn.launches_tc_block_mask += block_mask is not None


def fused_bwd_kernel(q, k, v, do, lse, di, *, causal=False, scale=1.0, kv_len=None,
                     q_offset=0, q_seq_len=None, window=None, logit_softcap=None,
                     dropout_rate=None, dropout_seed=0, dropout_row_stride=None, precision=None):
    """One launch of the fused one-pass kernel in the form :func:`bwd_form`
    picks (``csrc/flash_bwd_tc.cu``; float32 at head_dim 64, 128 and 256
    in ``"bf16_3x"`` and ``"bf16"`` its float32 form, the same source built
    with ``-DFA_F32``, at d = 256 over two terms with dQ computed as
    ``(K^T dS^T)^T``; else ``csrc/flash_bwd.cu``): ``(dq, dk, dv)``.  dQ is
    summed with float32 atomics into a zeroed buffer, then cast to q's
    dtype.  On CPU tensors: the plain version."""
    kw = _opts(q, k, causal, scale, kv_len, q_offset, q_seq_len, window, logit_softcap,
               dropout_rate, dropout_seed, dropout_row_stride)
    precision = resolve_precision(precision, q.dtype)
    form = bwd_form(q, True, precision=precision)
    if q.device.type == "cpu":
        dq, dk, dv = _bwd_plain(q, k, v, do, lse, di, form=form, precision=precision, **kw)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
    dtype, bh, rows, s_kv, d = _launch_args("flash_bwd", q, k, v, do, lse, di)
    dq_acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if form == "tc_f32":
        # The split pass writes q, k, v and do as bf16 rows of `terms` terms
        # (hi | lo in "bf16_3x", bf16(x) in "bf16") into these buffers.
        split = _split_buffers(q, k, precision)
        lib = _library("flash_bwd_tc_f32", kw)
        status = kernels.library(lib).fa_flash_bwd_tc_f32(
            _terms(precision), q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            *(t.data_ptr() for t in split), lse.data_ptr(), di.data_ptr(), dq_acc.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), bh, rows, s_kv, d, *_scalars(kw),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    elif form == "tc":
        lib = _library("flash_bwd_tc", kw)
        status = kernels.library(lib).fa_flash_bwd_tc(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            di.data_ptr(), dq_acc.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh, rows, s_kv, d,
            *_scalars(kw), torch.cuda.current_stream(q.device).cuda_stream,
        )
    else:
        lib = _library("flash_bwd", kw)
        status = kernels.library(lib).fa_flash_bwd(
            dtype, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            di.data_ptr(), dq_acc.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh, rows, s_kv, d,
            *_scalars(kw), torch.cuda.current_stream(q.device).cuda_stream,
        )
    kernels.check_launch(lib, status, f"q {tuple(q.shape)} {q.dtype} {precision}")
    _count(fused_bwd_kernel, kw, form=form)
    return dq_acc.to(q.dtype), dk, dv


def _pair_launch(name, q, k, v, do, lse, di, outs, kw, seg_q, seg_kv, block_mask, precision,
                 split_rows):
    """One launch of a kernel of the two-pass pair: its tensor-core form
    (``<name>_tc``: the pair's segment range tables from the ids) or its
    float32 form (``<name>_tc_f32``: over the bf16 term buffers of
    ``split_rows``, ``(buffers, filled)``, filling them first unless
    ``filled``; None: its own, filled) where :func:`bwd_form` picks it, else
    the scalar kernel.  Returns the form."""
    dtype, bh, rows, s_kv, d = _launch_args(name, q, k, v, do, lse, di, seg_q, seg_kv)
    form = bwd_form(q, False, block_mask is not None, precision)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            di.data_ptr(), _ptr(seg_q), _ptr(seg_kv))
    ranges = (None, None)
    if form != "scalar" and seg_q is not None:
        ranges = tuple(map(seg_tile_ranges, (seg_q, seg_kv)))
    if form == "tc_f32":
        split, filled = split_rows or (_split_buffers(q, k, precision), False)
        lib = _library(name + "_tc_f32", kw)
        status = getattr(kernels.library(lib), f"fa_{name}_tc_f32")(
            _terms(precision), int(not filled), *ptrs[:4], *(t.data_ptr() for t in split),
            *ptrs[4:], *map(_ptr, ranges), *(t.data_ptr() for t in outs), bh, rows, s_kv, d,
            *_scalars(kw), stream,
        )
    elif form == "tc":
        lib = _library(name + "_tc", kw, block_mask)
        status = getattr(kernels.library(lib), f"fa_{name}_tc")(
            *ptrs, *map(_ptr, ranges), *(t.data_ptr() for t in outs),
            *_tc_mask_tiles(block_mask, q, by_q=name == "flash_bwd_dq"), bh, rows, s_kv, d,
            *_scalars(kw), stream,
        )
    else:
        lib = _library(name, kw, block_mask)
        status = getattr(kernels.library(lib), f"fa_{name}")(
            dtype, *ptrs, *(t.data_ptr() for t in outs),
            *_mask_tiles(block_mask, q, by_q=name == "flash_bwd_dq"), bh, rows, s_kv, d,
            *_scalars(kw), stream,
        )
    kernels.check_launch(lib, status, f"q {tuple(q.shape)} {q.dtype} {precision}")
    return form


def dq_kernel(q, k, v, do, lse, di, *, causal=False, scale=1.0, kv_len=None, q_offset=0,
              q_seq_len=None, window=None, logit_softcap=None, q_segment_ids=None,
              kv_segment_ids=None, dropout_rate=None, dropout_seed=0,
              dropout_row_stride=None, block_mask=None, precision=None, split_rows=None):
    """One launch of the two-pass backward's dQ kernel: in bf16 at head_dim
    64, 128 or 256 its tensor-core form (``csrc/flash_bwd_dq_tc.cu``), in
    float32 at the same head_dims in the mode ``precision`` (``"bf16_3x"``
    by default, or ``"bf16"``) its float32 form (the same source built with
    ``-DFA_F32``; ``split_rows``: see :func:`_pair_launch`), else
    ``csrc/flash_bwd_dq.cu``.  On CPU tensors: the plain version, with that
    form's rounding."""
    kw = _opts(q, k, causal, scale, kv_len, q_offset, q_seq_len, window, logit_softcap,
               dropout_rate, dropout_seed, dropout_row_stride)
    precision = resolve_precision(precision, q.dtype)
    if q.device.type == "cpu":
        dq, _, _ = _bwd_plain(q, k, v, do, lse, di, q_segment_ids=q_segment_ids,
                              kv_segment_ids=kv_segment_ids, block_mask=block_mask,
                              form=bwd_form(q, False, block_mask is not None, precision),
                              precision=precision, pair=True, **kw)
        return dq.to(q.dtype)
    dq = torch.empty_like(q)
    form = _pair_launch("flash_bwd_dq", q, k, v, do, lse, di, (dq,), kw, q_segment_ids,
                        kv_segment_ids, block_mask, precision, split_rows)
    _count(dq_kernel, kw, block_mask, form)
    return dq


def dkv_kernel(q, k, v, do, lse, di, *, causal=False, scale=1.0, kv_len=None, q_offset=0,
               q_seq_len=None, window=None, logit_softcap=None, q_segment_ids=None,
               kv_segment_ids=None, dropout_rate=None, dropout_seed=0,
               dropout_row_stride=None, block_mask=None, precision=None, split_rows=None):
    """One launch of the two-pass backward's dK/dV kernel: ``(dk, dv)``, each
    KV head summed over all of its folded query rows; in bf16 at head_dim
    64, 128 or 256 its tensor-core form (``csrc/flash_bwd_tc.cu`` built
    with ``-DFA_PAIR``), in float32 at the same head_dims in the mode
    ``precision`` its float32 form (built with ``-DFA_PAIR -DFA_F32``), else
    ``csrc/flash_bwd_dkv.cu``.  On CPU tensors: the plain version, with that
    form's rounding."""
    kw = _opts(q, k, causal, scale, kv_len, q_offset, q_seq_len, window, logit_softcap,
               dropout_rate, dropout_seed, dropout_row_stride)
    precision = resolve_precision(precision, q.dtype)
    if q.device.type == "cpu":
        _, dk, dv = _bwd_plain(q, k, v, do, lse, di, q_segment_ids=q_segment_ids,
                               kv_segment_ids=kv_segment_ids, block_mask=block_mask,
                               form=bwd_form(q, False, block_mask is not None, precision),
                               precision=precision, pair=True, **kw)
        return dk.to(k.dtype), dv.to(v.dtype)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    form = _pair_launch("flash_bwd_dkv", q, k, v, do, lse, di, (dk, dv), kw, q_segment_ids,
                        kv_segment_ids, block_mask, precision, split_rows)
    _count(dkv_kernel, kw, block_mask, form)
    return dk, dv


# Kernel launches, for the chip run's path check: all forms, and the dropout
# and block-mask ones among them, and the tensor-core forms' among them (with
# dropout and with a block mask among those); the float32 forms' (with
# dropout among them) apart from the tensor-core forms'.
for _fn in (fused_bwd_kernel, dq_kernel, dkv_kernel):
    _fn.launches = _fn.launches_dropout = _fn.launches_block_mask = 0
    _fn.launches_tc = _fn.launches_tc_dropout = _fn.launches_tc_block_mask = 0
    _fn.launches_tc_f32 = _fn.launches_tc_f32_dropout = 0
del _fn


class _FlashAttention(torch.autograd.Function):
    """The flash forward kernel saving ``(o, lse)``; its backward is
    :func:`flash_attention_bwd` (backward.py:1014-1053)."""

    @staticmethod
    def forward(ctx, q, k, v, q_segment_ids, kv_segment_ids, opts, block_sizes):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, l, m = flash_attention(
            q, k, v, save_residuals=True, block_sizes=block_sizes,
            q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids, **opts,
        )
        lse = m + torch.log(torch.where(l == 0.0, 1.0, l))  # the l == 0 guard
        ctx.save_for_backward(q, k, v, o, lse, q_segment_ids, kv_segment_ids)
        ctx.opts = opts  # the dropout seed with them: the backward draws the same bits
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, seg_q, seg_kv = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(
            q, k, v, o, lse, do.contiguous(), q_segment_ids=seg_q, kv_segment_ids=seg_kv,
            **ctx.opts,
        )
        return dq, dk, dv, None, None, None, None


def attention_vjp(
    q, k, v, causal=False, scale=1.0, block_sizes=None, precision=None, interpret=None,
    q_seq_len=None, window=None, logit_softcap=None, dropout_rate=None, dropout_seed=0,
    q_segment_ids=None, kv_segment_ids=None, block_mask=None, kv_len=None, q_offset=0,
    *, dropout_row_stride=None,
):
    """Differentiable fused attention on ``(BH, R, d)``, with the JAX
    package's positional signature (backward.py:966-985).

    ``q_seq_len`` folds GQA groups into the rows (q is ``(B*KVH, G*S, d)``
    against k/v ``(B*KVH, S_kv, d)``); the backward sums dK/dV over all G
    groups' rows.  ``block_sizes`` is the forward kernel's tile
    (``BlockSizes()`` or None); ``precision`` goes to the forward
    (:func:`ops.flash.flash_attention`: its residuals come from the form the
    mode takes) and to the backward (:func:`flash_attention_bwd`: the
    float32 forms of the fused kernel and the pair compute it at head_dim 64
    and 128, the scalar kernels float32 exactly); ``interpret`` is ignored.
    ``window`` and ``logit_softcap`` go to the forward (whose lse then holds
    the capped, windowed scores) and to the backward.  ``dropout_rate`` / ``dropout_seed`` drop the softmax weights
    with inverted scaling; both passes regenerate the keep bits from the
    seed, which is an int (a tensor is read once on the host, one sync).
    ``block_mask`` is a :class:`ops.flash.BlockMask` (not with causal,
    window or the GQA fold); the backward then runs the two-pass kernels.
    ``dropout_row_stride``: see :func:`ops.flash.flash_attention`.
    """
    _check_tpu_options(q.dtype, None, precision, interpret)
    opts = dict(causal=bool(causal), scale=float(scale), q_seq_len=q_seq_len, kv_len=kv_len,
                q_offset=int(q_offset), window=window, logit_softcap=logit_softcap,
                precision=precision,
                dropout_rate=check_dropout(dropout_rate), dropout_seed=wrap_int32(dropout_seed),
                dropout_row_stride=dropout_row_stride, block_mask=block_mask)
    return _FlashAttention.apply(q, k, v, q_segment_ids, kv_segment_ids, opts, block_sizes)
