"""Flash-attention forward on folded ``(BH, R, d)`` tensors.

Counterpart of ``flashattention_tpu/ops/flash.py::flash_attention`` (:1127).
On a CUDA tensor it launches a hand-written kernel that replaces the Pallas
``_kernel`` (:628), in the form :func:`kernel_form` picks: for bf16 q at
head_dim 64, 128 or 256 the tensor-core kernel in ``csrc/flash_fwd_tc.cu``
(over 8-bit K/V without dropout or a block mask, its 8-bit form,
``flash_fwd_tc_quant``, which also takes float32 q over 8-bit K/V in bf16,
as the Pallas kernel's quantized default takes it, with O in float32 from
the float32 sums: :func:`f32_q_in_bf16`); for float32 q, k and v at head_dim
64, 128 or 256 with no block mask or dropout, in each of the JAX package's
precision modes, its float32 form ``flash_fwd_tc_f32``: in ``"bf16"`` the
same kernel over each value's one bf16 term, in ``"bf16_3x"`` over its two
(at d = 256 ``csrc/flash_fwd_f32.cuh``'s kernel, which splits them in
shared memory), and in ``"float32"`` (XLA's HIGHEST) that kernel over three
terms and six products; with dropout at head_dim 64 or 128 in ``"bf16_3x"``
and ``"bf16"`` its split-pass form's dropout form, ``flash_fwd_tc_f32_extra``;
otherwise the float32 CUDA-core kernel in
``csrc/flash_fwd.cu``; on a CPU tensor it runs :func:`flash_attention_plain`,
the same function in plain PyTorch, with the chosen form's rounding.  There
is no fallback between the two, or between the forms: a CUDA call either
launches the chosen kernel or raises.

Supported: causal masking at absolute query position
``q_offset + (r mod q_seq_len)`` (the GQA row fold), a sliding window (a row
at position ``pos`` sees columns ``c > pos - window``), a logit softcap
(``s -> cap * tanh(s / cap)`` after the scale, before the masks), a live KV
length ``kv_len`` (ragged S is masked in the kernel, never padded), a score
scale, segment ids (packed rows: row r sees column c only where their ids are
equal; ``PAD_SEGMENT`` padding rows attend each other, as in the JAX
kernel), ``save_residuals``, 8-bit K/V: int8 or fp8 payloads with
float32 per-row scales ``(BH, S_kv)`` (``k_scales``/``v_scales``): the
scalar kernel's 8-bit form dequantizes each row as it stages its tile, the
tensor-core form converts each staged tile to bf16 and applies the scales
to the score columns and to P as the Pallas kernel does
(:func:`ops.quant.attention_quantized` is the public entry point), attention
dropout and block-sparse masks.  Dropout (``dropout_rate``,
``dropout_seed``) keeps each (head, row, column) pair by
:func:`dropout_keep_mask`, a hash of its absolute coordinates that is bit for
bit the JAX package's (flash.py:577), so the forward and both backward
kernels regenerate the same bits and the JAX steps' losses are reproduced.
A :class:`BlockMask` (flash.py:445) is classified on the host over the CUDA
kernels' own tiles, once per mask and tile shape, and cached on the device
with it: the kernels never load or compute a dead tile and apply element
bits only in partial ones.  The TPU tile-fitting regimes of
``BlockSizes.fit`` are not ported: the CUDA kernel has one tile shape.

:func:`flash_attention_naive` is the counterpart of the JAX package's naive
Pallas kernel (``_naive_kernel``, :1690): dense softmax over the whole KV
stripe, float32 throughout, the independent cross-check of the flash kernel.
On a CUDA tensor it launches ``csrc/flash_naive.cu``; on a CPU tensor it runs
:func:`flash_attention_naive_plain`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any

import numpy as np
import torch

from flashattention_tpu_torch.ops import kernels
from flashattention_tpu_torch.ops.reference import (
    DEFAULT_MASK_VALUE,
    attention_reference,
    dequantize_rows,
    softcap,
)

__all__ = [
    "BlockMask",
    "BlockSizes",
    "PRECISIONS",
    "dropout_keep_mask",
    "flash_attention",
    "flash_attention_naive",
    "flash_attention_naive_plain",
    "flash_attention_plain",
    "kernel_form",
    "resolve_precision",
    "scalar_forms",
]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# K/V payload type codes of the C interface: q's own type, or 8-bit payloads
# with float32 scales.
KV_DTYPES = {**_DTYPES, torch.int8: 2, torch.float8_e4m3fn: 3}
_HEAD_DIMS = (16, 32, 64, 128, 256)
# The JAX package's smallest tile (flash.py MIN_BLOCK): its attention() pads
# each GQA segment to a multiple of it, which sets the dropout row stride.
MIN_BLOCK = 128


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


# The JAX package's matmul precision modes for float32 inputs (flash.py:116).
PRECISIONS = ("bf16", "bf16_3x", "float32")


def quant_precision(precision: str | None, quantized: bool) -> str | None:
    """``precision`` over 8-bit K/V: None or ``"auto"`` is ``"bf16"``, the
    JAX package's quantized default (flash.py:1352-1360), whose kernel then
    takes float32 q in bf16; otherwise ``precision`` as given."""
    return "bf16" if quantized and precision in (None, "auto") else precision


def f32_q_in_bf16(dtype, quantized: bool, precision: str | None, head_dim: int, *,
                  block_mask: bool = False, dropout: bool = False) -> bool:
    """Whether the flash forward takes float32 q over 8-bit K/V in bf16, as
    the Pallas kernel does in its ``"bf16"`` mode (flash.py:825, :971-976;
    the default there, :func:`quant_precision`): where the bf16 call's form
    is the tensor-core 8-bit form, it runs over ``q.to(bfloat16)`` and
    writes O in float32 from its float32 sums.  Elsewhere (dropout, a block
    mask, head_dim 16 or 32, :func:`scalar_forms`) and in the explicit
    ``"bf16_3x"`` and ``"float32"`` modes, q stays float32, on the exact
    scalar kernel."""
    return (quantized and dtype == torch.float32
            and resolve_precision(quant_precision(precision, quantized), dtype) == "bf16"
            and kernel_form("flash_fwd", torch.bfloat16, head_dim, quantized=True,
                            block_mask=block_mask, dropout=dropout) == "tc")


def resolve_precision(precision: str | None, dtype) -> str:
    """The mode ``precision`` names for inputs of ``dtype``, validated as
    the JAX ``resolve_precision`` (flash.py:119) does: None or ``"auto"``
    is ``"bf16_3x"`` for float32 and ``"bf16"`` otherwise, any other value
    outside :data:`PRECISIONS` raises ``ValueError``, and inputs below
    float32 always resolve to ``"bf16"``.  For float32 inputs the flash
    forward computes the mode (:func:`kernel_form`'s ``"tc_f32"``) where
    its float32 tensor-core form is built, and exact float32 elsewhere."""
    if precision in (None, "auto"):
        return "bf16_3x" if dtype == torch.float32 else "bf16"
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    if dtype != torch.float32:
        return "bf16"
    return precision


# The tensor-core forms (csrc/flash_fwd_tc.cu, csrc/flash_bwd_tc.cu,
# csrc/paged_prefill_tc.cu, csrc/paged_decode_tc.cu, and the two-pass pair's
# csrc/flash_bwd_dq_tc.cu and flash_bwd_tc.cu built with -DFA_PAIR): bf16 q
# at these head_dims; the two forwards and paged decode also over 8-bit K/V
# (without dropout or a block mask).  The flash forward and the pair also
# take block masks (TC_BLOCK_MASK).  The forward's KV tile (kBlockN,
# also the paged form's) sets where its online softmax rescales, which the
# plain versions mirror; paged decode's tile is 64 rows at every head_dim
# (TC_DECODE_TILE), and it takes at most TC_DECODE_ROWS q rows per KV head,
# as does its float32 form (csrc/paged_decode_tc.cu built with -DFA_F32,
# float32 q over float32 pages at TC_F32_HEAD_DIMS, XLA's HIGHEST).
TC_HEAD_DIMS = {"flash_fwd": (64, 128, 256), "flash_bwd": (64, 128, 256),
                "flash_bwd_dq": (64, 128, 256), "flash_bwd_dkv": (64, 128, 256),
                "paged_prefill": (64, 128, 256), "paged_decode": (64, 128, 256)}
TC_KV_TILE = {64: 128, 128: 128, 256: 64}
# The tensor-core forms that take a block mask, and the query rows of the
# forward's and dQ's blocks: a mask's table is built over the forward's
# (TC_BLOCK_Q, TC_KV_TILE[d]) tiles (dQ's and dK/dV's: ops/backward.py).
TC_BLOCK_MASK = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
TC_BLOCK_Q = 128
TC_DECODE_TILE = 64
TC_DECODE_ROWS = 32
# The forward's float32 form (csrc/flash_fwd_tc.cu built with -DFA_F32):
# float32 q, k and v at these head_dims in every precision mode.  In
# "bf16_3x" at d = 64 and 128 its ring carries rows of two bf16 terms, twice
# as wide, so its KV tile is the bf16 form's at 2 d (TC_F32_KV_TILE); in
# "bf16" it is the bf16 form over one term (TC_KV_TILE); in "float32", and
# in "bf16_3x" at d = 256, it is csrc/flash_fwd_f32.cuh's kernel, which
# splits float32 tiles into bf16 terms in shared memory, over 64 query rows
# and TC_F32_SPLIT_KV_TILE KV rows.  The same kernel is chunked prefill's
# form over float32 pools (csrc/paged_prefill_tc.cu built with -DFA_F32,
# "float32" always, as the Pallas kernel computes them).
TC_F32_HEAD_DIMS = (64, 128, 256)
TC_F32_KV_TILE = {64: 128, 128: 64, 256: 32}
TC_F32_SPLIT_KV_TILE = {64: 64, 128: 64, 256: 32}
# The head_dims in "bf16_3x" and "bf16" of the forward's dropout form
# (flash_fwd_tc.cu built with -DFA_F32 -DFA_EXTRA, a split-pass form), and
# of the backward's float32 forms: the fused backward's (csrc/flash_bwd_tc.cu
# built with -DFA_F32; at d = 256 over two terms, 32-row query tiles) and
# the two-pass pair's (csrc/flash_bwd_dq_tc.cu and csrc/flash_bwd_tc.cu built
# with -DFA_PAIR, each with -DFA_F32; at d = 256 over 64-row query blocks and
# 32-row key tiles (dQ) and 32-row query tiles (dK/dV)).
TC_F32_SPLIT_PASS_HEAD_DIMS = (64, 128)
TC_F32_BWD_HEAD_DIMS = (64, 128, 256)


def f32_products(d: int, precision: str = "bf16_3x") -> int:
    """The products of the float32 form's S and PV at head_dim ``d`` in
    ``precision``: in ``"bf16_3x"`` all four of the two terms' at d = 64,
    where the JAX package streams ``[hi | lo]`` pairs (its lane-packed form,
    flash.py:1433-1441), above hi hi + hi lo + lo hi, as its ``_dot_g``
    (flash.py:150-181); in ``"float32"`` the six of XLA's HIGHEST over three
    terms (flash.py:40), x1 y1, x1 y2, x2 y1, x1 y3, x2 y2, x3 y1."""
    if precision == "float32":
        return 6
    return 4 if 2 * d <= 128 else 3


def f32_split(d: int, precision: str) -> bool:
    """Whether the float32 form in the mode ``precision`` (resolved) runs
    ``csrc/flash_fwd_f32.cuh``'s kernel, which splits float32 tiles into
    bf16 terms in shared memory: in ``"float32"`` at every head_dim, in
    ``"bf16_3x"`` at d = 256 (two terms of a 128-row block of Q would take
    128 KB of shared memory in the split-pass form)."""
    return precision == "float32" or (precision == "bf16_3x" and d == 256)


def f32_kv_tile(d: int, precision: str) -> int:
    """The KV tile of the float32 form's online softmax at head_dim ``d``
    in the mode ``precision`` (resolved): where it rescales, which the plain
    mirror follows."""
    if precision == "bf16":
        return TC_KV_TILE[d]
    return TC_F32_SPLIT_KV_TILE[d] if f32_split(d, precision) else TC_F32_KV_TILE[d]


def tc_page_size(page_size, head_dim: int, tile: int | None = None) -> bool:
    """Whether a paged tensor-core form takes pages of ``page_size`` rows
    at ``head_dim``: a multiple of 8 that divides the KV tile (``tile``;
    by default the forward's, ``TC_KV_TILE``) or that the tile divides, so
    that each TMA box of ``min(tile, page_size)`` rows lies in one page and
    on a swizzle atom."""
    tile = tile or TC_KV_TILE.get(head_dim)
    return (page_size is not None and tile is not None and page_size > 0 and page_size % 8 == 0
            and (tile % page_size == 0 or page_size % tile == 0))


def kernel_form(kernel: str, dtype, head_dim: int, *, quantized: bool = False,
                block_mask: bool = False, dropout: bool = False,
                page_size: int | None = None, rows: int = 1,
                precision: str | None = None) -> str:
    """The form a call of ``kernel`` (``"flash_fwd"``, ``"flash_bwd"`` for
    the fused backward, ``"flash_bwd_dq"`` / ``"flash_bwd_dkv"`` for the
    two-pass pair, ``"paged_prefill"`` or ``"paged_decode"``) takes:
    ``"tc"``, the tensor-core kernel, for bfloat16 q at
    ``TC_HEAD_DIMS[kernel]``, over 16-bit K/V or, in the two forwards
    without dropout or a block mask and in paged decode, over 8-bit K/V
    (``quantized``); with a block mask only the kernels of
    ``TC_BLOCK_MASK`` (over 16-bit K/V); the paged kernels only on pages of
    a ``page_size`` that :func:`tc_page_size` takes (paged decode's at ``TC_DECODE_TILE``), paged
    decode only with at most ``TC_DECODE_ROWS`` q ``rows`` per KV head (G,
    or G * draft_k).  ``"tc_f32"``, the flash forward's float32 form, for
    float32 q, k and v at ``TC_F32_HEAD_DIMS`` with no block mask, dropout or
    8-bit K/V, in the mode ``precision`` resolves to (:func:`resolve_precision`:
    by default ``"bf16_3x"``), and with dropout at
    ``TC_F32_SPLIT_PASS_HEAD_DIMS`` in ``"bf16_3x"`` and ``"bf16"``; the
    float32 forms of the backward, the fused one's and the two-pass pair's,
    at ``TC_F32_BWD_HEAD_DIMS`` in those two modes, dropout or not; and
    chunked prefill's over float32
    pools at ``TC_F32_HEAD_DIMS``, on pages :func:`tc_page_size` takes at
    ``TC_F32_SPLIT_KV_TILE``; and paged decode's over float32 pages at
    ``TC_F32_HEAD_DIMS``, on pages :func:`tc_page_size` takes at
    ``TC_DECODE_TILE``, with at most ``TC_DECODE_ROWS`` q ``rows`` per KV
    head (XLA's HIGHEST, as the Pallas kernel computes float32 pages).
    Else ``"scalar"``, the float32 CUDA-core kernel (float32 or 8-bit K/V
    with a block mask, 8-bit K/V with dropout, float32 q over 8-bit K/V that
    the tensor-core form does not take in bf16 or in the exact modes, the
    float32 backward, fused or the pair, in ``"float32"`` and at d = 16 /
    32, the float32 pair with a block mask, and paged decode at d = 32,
    with more than 32 rows or on pages its boxes refuse).
    ``dtype`` is q's type as the kernel takes it: float32 q over 8-bit K/V
    (:func:`f32_q_in_bf16`) or pages (``ops.decode._f32_q_in_bf16``) taken
    in bf16 asks for the bf16 form.  Inside :func:`scalar_forms`, always
    ``"scalar"``."""
    if (dtype == torch.float32 and not _SCALAR_ONLY[0] and head_dim in TC_F32_HEAD_DIMS
            and not (quantized or block_mask)):
        mode = resolve_precision(precision, dtype)  # raises on an unknown mode
        if (kernel in ("flash_bwd", "flash_bwd_dq", "flash_bwd_dkv") and mode != "float32"
                and head_dim in TC_F32_BWD_HEAD_DIMS):
            return "tc_f32"
        if dropout:
            if (kernel == "flash_fwd" and mode != "float32"
                    and head_dim in TC_F32_SPLIT_PASS_HEAD_DIMS):
                return "tc_f32"
        elif kernel == "flash_fwd" or (kernel == "paged_prefill" and tc_page_size(
                page_size, head_dim, TC_F32_SPLIT_KV_TILE[head_dim])) or (
                kernel == "paged_decode" and rows <= TC_DECODE_ROWS
                and tc_page_size(page_size, head_dim, TC_DECODE_TILE)):
            return "tc_f32"
    if (_SCALAR_ONLY[0] or dtype != torch.bfloat16
            or (block_mask and (quantized or kernel not in TC_BLOCK_MASK))
            or head_dim not in TC_HEAD_DIMS.get(kernel, ())
            or (quantized and (kernel.startswith("flash_bwd") or dropout))
            or (kernel == "paged_prefill" and not tc_page_size(page_size, head_dim))
            or (kernel == "paged_decode"
                and (not tc_page_size(page_size, head_dim, TC_DECODE_TILE)
                     or rows > TC_DECODE_ROWS))):
        return "scalar"
    return "tc"


_SCALAR_ONLY = [False]


@contextlib.contextmanager
def scalar_forms():
    """Within the block every call, and every plain version by default,
    takes the scalar form: a way to time and check the scalar kernels in
    bf16 beside the tensor-core ones (chip_smoke.py, the scalar kernels'
    mutation tools).  Not thread-safe."""
    _SCALAR_ONLY[0] = True
    try:
        yield
    finally:
        _SCALAR_ONLY[0] = False


def _exp(x):
    """``exp`` of the plain versions.  On the CPU in float64 through
    ``exp2``, rounded to float32 once: torch's float32 ``exp`` there goes to
    MKL's vector math, which, over inputs that hold masked scores (``s - m``
    near -0.7 FLT_MAX), returns a last bit that varies from process to
    process, and dropout's sparse 1 / (1 - rate) weights carry such a bit up
    to 7e-5 into the output.  ``exp2`` does not go there, the clamp keeps
    the masked scores in range, and a float64 result almost never differs in
    float32 from one process to the next.  On the card torch's float32
    ``exp``, as the kernels compute it."""
    if x.device.type != "cpu":
        return torch.exp(x)
    return torch.exp2(x.double().clamp_min(-1e4) * _LOG2E).float()


_LOG2E = 1.4426950408889634


def _split_bf16(x):
    """``x`` as two bfloat16 terms, ``hi = bf16(x)`` and ``lo = bf16(x -
    hi)`` (nearest even), as float32 tensors: the JAX package's
    ``_split_bf16`` (flash.py:136) and the float32 form's split pass."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _split3_bf16(x):
    """``x`` as three bfloat16 terms, ``x1 = bf16(x)``, ``x2 = bf16(x -
    x1)``, ``x3 = bf16(x - x1 - x2)`` (nearest even; :func:`_split_bf16`
    twice), as float32 tensors: the float32 form's split in the
    ``"float32"`` mode, XLA's HIGHEST as the JAX package documents it
    (flash.py:40)."""
    x1 = x.to(torch.bfloat16).float()
    return (x1, *_split_bf16(x - x1))


def _highest(eq, x, y, fx=None):
    """``torch.einsum(eq, x, y)`` as XLA's HIGHEST computes it on bf16
    terms (:func:`_split3_bf16`): the six products x1 y1, x1 y2, x2 y1, x1
    y3, x2 y2, x3 y1, as (x1 + x2 + x3) y1 + (x1 + x2) y2 + x1 y3 (y, the
    larger operand where one is, is only split), summed exactly (in
    float64) and rounded to float32 once; ``fx`` (broadcast against ``x``)
    multiplies each of x's terms first, in float64."""
    f = 1.0 if fx is None else fx.double()
    x1, x2, x3 = (t.double() * f for t in _split3_bf16(x))
    return sum(torch.einsum(eq, a, b.double())
               for a, b in zip((x1 + x2 + x3, x1 + x2, x1), _split3_bf16(y))).float()


def _two_term_bf16(x):
    """``x`` as the tensor-core forms feed it to a product: its two bfloat16
    terms (:func:`_split_bf16`) summed in float32."""
    hi, lo = _split_bf16(x)
    return hi + lo


def head_chunks(bh: int, per_head: int, budget: int = 1 << 27):
    """Ranges of heads whose ``per_head``-element temporaries together stay
    near ``budget`` elements: the plain versions run chunk by chunk."""
    step = max(1, budget // max(per_head, 1))
    return [range(i, min(bh, i + step)) for i in range(0, bh, step)]


def fwd_tile(d: int) -> int:
    """Query rows per block of the forward kernel at head_dim ``d``
    (``block_q<D>()`` in ``csrc/flash_fwd.cu``; its KV tile is 32)."""
    return 32 if d >= 256 else 64


@dataclasses.dataclass(frozen=True)
class BlockSizes:
    """Tile shape of the CUDA kernel: ``block_q`` query rows per block and
    ``block_kv`` KV rows per shared-memory tile.  The kernel is compiled for
    this one shape (``kBlockQ``/``kBlockKV`` in ``csrc/flash_fwd.cu``)."""

    block_q: int = 64
    block_kv: int = 32


_U32 = 0xFFFFFFFF


def wrap_int32(x) -> int:
    """``x`` as the int32 it wraps to (the JAX steps' int32 seed arithmetic)."""
    return (int(x) + 2**31) % 2**32 - 2**31


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``a * c mod 2**32`` for int64 ``a`` in [0, 2**32) and a constant
    ``c`` < 2**32: ``c`` in 16-bit halves, so no product leaves int64
    (torch has no uint32 shifts on the CPU)."""
    return (a * (c & 0xFFFF) + (((a * (c >> 16)) & 0xFFFF) << 16)) & _U32


def dropout_threshold(rate: float) -> int:
    """Keep iff the hash's top 24 bits are at or above this:
    ``ceil(float32(rate) * 2**24)``, at most ``2**24`` (flash.py:607-612)."""
    rate32 = float(np.float32(rate))
    return min(math.ceil(rate32 * (1 << 24)), 1 << 24)


def _keep_bits(seed, bh, rows: torch.Tensor, cols: torch.Tensor, threshold: int):
    """The keep bits of (rows x cols) int64 coordinates, broadcast, for one
    seed and head: uint32 arithmetic held in int64."""
    h = (_mul32(torch.tensor(wrap_int32(seed) & _U32), 0x9E3779B9)
         + _mul32(torch.tensor(int(bh) & _U32), 0x85EBCA6B)) & _U32
    x = _mul32(rows & _U32, 0xCC9E2D51) ^ _mul32(cols & _U32, 0x1B873593) ^ h.to(rows.device)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return (x >> 8) >= threshold


def dropout_keep_mask(seed, bh_idx, row_start, col_start, shape, rate: float, *, device=None):
    """The keep mask of attention dropout (flash.py:577-613, bit for bit):
    a bool ``shape`` tile, True = keep (probability ``1 - rate``), of head
    ``bh_idx`` at rows ``row_start + i`` and columns ``col_start + j``.

    A counter-based hash of the absolute coordinates (seed, batch x head,
    query row, key column) with murmur3's fmix32, so the forward and
    backward kernels regenerate every bit and no mask is stored.  The seed
    is taken as an int32 (a negative one wraps) and then as uint32.
    """
    rows = torch.arange(shape[0], dtype=torch.int64, device=device)[:, None] + int(row_start)
    cols = torch.arange(shape[1], dtype=torch.int64, device=device)[None, :] + int(col_start)
    return _keep_bits(seed, bh_idx, rows, cols, dropout_threshold(rate))


def check_dropout(rate):
    """The dropout rate a kernel takes: None for no dropout (rate 0 is the
    identity), else a rate in (0, 1) (flash.py:1232-1236)."""
    if rate is None or rate == 0.0:
        return None
    if not 0.0 < rate < 1.0:
        raise ValueError(f"dropout_rate must be in (0, 1) or None (got {rate})")
    return float(rate)


def dropout_options(rate, seed, row_stride, q_seq_len):
    """The C interface's dropout arguments: the raw row stride, the int32
    seed, the keep threshold (0: no dropout) and ``1 / (1 - rate)``."""
    if rate is None:
        return (q_seq_len, 0, 0, 0.0)
    stride = q_seq_len if row_stride is None else int(row_stride)
    return (stride, wrap_int32(seed), dropout_threshold(rate), 1.0 / (1.0 - rate))


def dense_keep(seed, rate, heads, rows, s_kv, q_seq_len, row_stride, device):
    """The keep bits of every (head, row, column): ``(len(heads), rows,
    s_kv)`` bool for the heads in ``heads`` (a range, or a count from 0),
    rows at their raw folded coordinate ``(r // q_seq_len) * row_stride + r
    % q_seq_len``; one head at a time, to bound the int64 temporaries."""
    heads = range(heads) if isinstance(heads, int) else heads
    r = torch.arange(rows, dtype=torch.int64, device=device)
    stride = q_seq_len if row_stride is None else row_stride
    raw = ((r // q_seq_len) * stride + r % q_seq_len)[:, None]
    cols = torch.arange(s_kv, dtype=torch.int64, device=device)[None, :]
    threshold = dropout_threshold(rate)
    return torch.stack([_keep_bits(seed, b, raw, cols, threshold) for b in heads])


@dataclasses.dataclass(frozen=True)
class MaskTiles:
    """A :class:`BlockMask` over a kernel's ``(tile_q, tile_kv)`` tiles, on
    one device: for each query tile, ``row_ptr[i]:row_ptr[i + 1]`` of
    ``row_idx`` (its live KV tiles, ascending) and ``row_part`` (each one's
    partial slot, -1 for a full tile); the same by KV tile in ``col_*``
    (the transposed table, for the key-row backward kernel); ``bits``,
    int32 words of the partial tiles' element bits, ``(slots, tile_q,
    words)`` with ``words = ceil(tile_kv / 32)``, and ``bits_t`` the same
    by KV row, ``(slots, tile_kv, ceil(tile_q / 32))`` (the tensor-core
    dK/dV form reads its key rows' words)."""

    row_ptr: torch.Tensor
    row_idx: torch.Tensor
    row_part: torch.Tensor
    col_ptr: torch.Tensor
    col_idx: torch.Tensor
    col_part: torch.Tensor
    bits: torch.Tensor
    bits_t: torch.Tensor

    def by_q(self):
        """The C interface's (ptr, idx, part, bits) by query tile."""
        return tuple(t.data_ptr() for t in (self.row_ptr, self.row_idx, self.row_part, self.bits))

    def by_kv(self):
        """The same by KV tile."""
        return tuple(t.data_ptr() for t in (self.col_ptr, self.col_idx, self.col_part, self.bits))

    def tc_by_kv(self):
        """The same by KV tile with the bits by KV row (``bits_t``), as the
        tensor-core dK/dV form reads them."""
        return (*self.by_kv()[:3], self.bits_t.data_ptr())



_BIT_WEIGHTS = np.left_shift(np.uint64(1), np.arange(32, dtype=np.uint64))


def _pack_bits(m):
    """Boolean ``(n, rows, cols)`` as uint32 ``(n, rows, ceil(cols /
    32))``: column c is bit c % 32 of word c // 32."""
    n, rows, cols = m.shape
    words = -(-cols // 32)
    x = np.zeros((n, rows, words * 32), np.uint64)
    x[..., :cols] = m
    return (x.reshape(n, rows, words, 32) * _BIT_WEIGHTS).sum(-1).astype(np.uint32)


def _csr(kind, part):
    """(ptr, idx, part) of the live entries of each row of ``kind``."""
    rows, cols = np.nonzero(kind)
    ptr = np.zeros(kind.shape[0] + 1, np.int32)
    np.add.at(ptr, rows + 1, 1)
    return np.cumsum(ptr).astype(np.int32), cols.astype(np.int32), part[rows, cols]


@dataclasses.dataclass(frozen=True)
class BlockMask:
    """Block-sparse attention mask (flash.py:445-575): the JAX package's
    container, its pair tables at its own blocks, and the CUDA kernels'.

    Built from a position-level predicate by :meth:`from_mask_fn`.
    ``mask_fn(q_pos, kv_pos) -> bool`` is dual-use: evaluated on numpy int
    arrays to classify blocks and tiles on the host, and on torch int
    tensors by the plain versions; plain comparisons, arithmetic and logic
    satisfy both.  ``qi``, ``kj``, ``first_kj``, ``last_kj``,
    ``needs_element_mask`` and the fractions are the JAX package's, at its
    blocks.  The kernels run on their own tiles instead: :meth:`tiles`
    classifies them (dead, full or partial, with a partial tile's element
    bits) once per tile shape, and caches the table on the device.
    """

    s_q: int
    s_kv: int
    block_q: int
    block_kv: int
    qi: tuple[int, ...]
    kj: tuple[int, ...]
    first_kj: tuple[int, ...]
    last_kj: tuple[int, ...]
    needs_element_mask: bool
    mask_fn: Any
    element_live_fraction: float = 1.0
    _tiles: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    @classmethod
    def from_mask_fn(cls, mask_fn, s_q: int, s_kv: int, *, block_q: int = 1024,
                     block_kv: int = 1024) -> "BlockMask":
        """Classify every (q, kv) block of ``mask_fn`` as dead, full or
        partial (flash.py:474-560).  Raises if the lengths are not multiples
        of the blocks, if ``mask_fn`` does not broadcast to a block, or if a
        query row attends no key (its softmax is undefined)."""
        block_q = min(block_q, _round_up(s_q, MIN_BLOCK))
        block_kv = min(block_kv, _round_up(s_kv, MIN_BLOCK))
        if s_q % block_q or s_kv % block_kv:
            raise ValueError(
                f"sequence lengths ({s_q}, {s_kv}) must be multiples of the "
                f"mask block sizes ({block_q}, {block_kv})"
            )
        nq, nkv = s_q // block_q, s_kv // block_kv
        qi, kj = [], []
        first_kj = [-1] * nq
        last_kj = [0] * nq
        needs_element_mask = False
        n_live_elements = 0
        for i in range(nq):
            rows = np.arange(i * block_q, (i + 1) * block_q)[:, None]
            row_live = np.zeros(block_q, bool)
            for j in range(nkv):
                cols = np.arange(j * block_kv, (j + 1) * block_kv)[None, :]
                m = np.asarray(mask_fn(rows, cols), bool)
                if m.shape != (block_q, block_kv):
                    raise ValueError(
                        f"mask_fn must broadcast to (block_q, block_kv)="
                        f"({block_q}, {block_kv}), got {m.shape}"
                    )
                if not m.any():
                    continue
                qi.append(i)
                kj.append(j)
                if first_kj[i] < 0:
                    first_kj[i] = j
                last_kj[i] = j
                row_live |= m.any(axis=1)
                n_live_elements += int(m.sum())
                if not m.all():
                    needs_element_mask = True
            if not row_live.all():
                bad = int(np.argmin(row_live)) + i * block_q
                raise ValueError(
                    f"mask_fn leaves query row {bad} with no live key — its "
                    "softmax is undefined; give every query at least one key"
                )
        return cls(
            s_q=s_q, s_kv=s_kv, block_q=block_q, block_kv=block_kv, qi=tuple(qi),
            kj=tuple(kj), first_kj=tuple(first_kj), last_kj=tuple(last_kj),
            needs_element_mask=needs_element_mask, mask_fn=mask_fn,
            element_live_fraction=n_live_elements / (s_q * s_kv),
        )

    @property
    def num_pairs(self) -> int:
        return len(self.qi)

    @property
    def live_fraction(self) -> float:
        """Fraction of the dense block grid with a live element."""
        return self.num_pairs / ((self.s_q // self.block_q) * (self.s_kv // self.block_kv))

    @property
    def occupancy(self) -> float:
        """Live elements over the elements of live blocks (1.0: no partial
        block)."""
        return self.element_live_fraction / max(self.live_fraction, 1e-12)

    def element_mask(self, rows: int, s_kv: int, device=None) -> torch.Tensor:
        """``mask_fn`` over query rows ``[0, rows)`` and key columns
        ``[0, s_kv)``: ``(rows, s_kv)`` bool, from torch ints."""
        r = torch.arange(rows, device=device)[:, None]
        c = torch.arange(s_kv, device=device)[None, :]
        return torch.as_tensor(self.mask_fn(r, c), dtype=torch.bool).expand(rows, s_kv)

    def _classify(self, tile_q: int, tile_kv: int):
        """Host classification over (tile_q, tile_kv) tiles: per tile 0
        (dead), 1 (full) or 2 (partial), each partial tile's slot, and the
        slots' element bits, uint32 ``(slots, tile_q, words)``, and by KV
        row, ``(slots, tile_kv, words_q)``."""
        nq, nk = -(-self.s_q // tile_q), -(-self.s_kv // tile_kv)
        cols = np.arange(nk * tile_kv)[None, :]
        kind = np.zeros((nq, nk), np.int8)
        part = np.full((nq, nk), -1, np.int32)
        bits, bits_t = [], []
        for i in range(nq):
            rows = np.arange(i * tile_q, (i + 1) * tile_q)[:, None]
            m = np.broadcast_to(np.asarray(self.mask_fn(rows, cols), bool),
                                (tile_q, nk * tile_kv)) & (rows < self.s_q) & (cols < self.s_kv)
            t = m.reshape(tile_q, nk, tile_kv)
            live, full = t.any(axis=(0, 2)), t.all(axis=(0, 2))
            kind[i] = np.where(full, 1, np.where(live, 2, 0))
            partial = np.nonzero(live & ~full)[0]
            if len(partial):
                part[i, partial] = len(bits) + np.arange(len(partial))
                tiles = t[:, partial, :].transpose(1, 0, 2)
                bits.extend(_pack_bits(tiles))
                bits_t.extend(_pack_bits(tiles.transpose(0, 2, 1)))
        if not bits:  # no partial tile: one zero slot, so that no table is empty
            bits = [np.zeros((tile_q, -(-tile_kv // 32)), np.uint32)]
            bits_t = [np.zeros((tile_kv, -(-tile_q // 32)), np.uint32)]
        return kind, part, np.stack(bits), np.stack(bits_t)

    def tiles(self, tile_q: int, tile_kv: int, device) -> MaskTiles:
        """The kernels' table over (tile_q, tile_kv) tiles on ``device``,
        classified on the host once per tile shape and cached."""
        device = torch.device(device)
        key = (tile_q, tile_kv, str(device))
        if key not in self._tiles:
            kind, part, bits, bits_t = self._classify(tile_q, tile_kv)
            rows = _csr(kind, part)
            cols = _csr(kind.T, part.T)

            def put(a):
                return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(device)

            self._tiles[key] = MaskTiles(*(put(a) for a in (*rows, *cols, bits, bits_t)))
        return self._tiles[key]


def check_block_mask(block_mask, rows, s_kv, *, causal, window, q_seq_len):
    """Raise ``ValueError`` for a block mask with causal masking, a window
    or the GQA row fold, or built for other lengths than ``(rows, s_kv)``
    rounded up to its blocks (the port never pads: the kernels mask the
    ragged edge, and a mask built at the JAX package's padded lengths
    serves as it is) (flash.py:1311-1340)."""
    if causal or window is not None:
        raise ValueError(
            "block_mask is mutually exclusive with causal/window — encode them in the mask_fn"
        )
    if q_seq_len is not None:
        raise ValueError(
            "block_mask with the GQA row fold (q_seq_len) is not supported; un-fold or "
            "bake the fold into the mask"
        )
    padded = (_round_up(rows, block_mask.block_q), _round_up(s_kv, block_mask.block_kv))
    if (block_mask.s_q, block_mask.s_kv) != padded:
        raise ValueError(
            f"block_mask built for (S_q, S_kv)=({block_mask.s_q}, {block_mask.s_kv}) "
            f"but inputs are ({rows}, {s_kv})"
        )


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
            kv_segment_ids=None, window=None, block_mask=None, device=None):
    """Boolean mask of the (query row, key column) pairs the kernels keep:
    ``(R, S_kv)``, or ``(BH, R, S_kv)`` with segment ids."""
    cols = torch.arange(s_kv, device=device)
    mask = (cols < kv_len)[None, :]
    if causal:
        pos = q_offset + torch.arange(rows, device=device) % q_seq_len
        mask = mask & (cols[None, :] <= pos[:, None])
        if window is not None:
            mask = mask & (cols[None, :] > pos[:, None] - window)
    if block_mask is not None:
        mask = mask & block_mask.element_mask(rows, s_kv, device)
    if q_segment_ids is not None:
        mask = mask & (q_segment_ids[:, :, None] == kv_segment_ids[:, None, :])
    return mask


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    k_scales=None,
    v_scales=None,
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
    dropout_seed=0,
    q_segment_ids=None,
    kv_segment_ids=None,
    block_mask: BlockMask | None = None,
    dropout_row_stride: int | None = None,
    precision: str | None = None,
    interpret: bool | None = None,
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
      dropout_rate, dropout_seed: attention dropout on the softmax weights
        with inverted ``1 / (1 - rate)`` scaling, keep bits from
        :func:`dropout_keep_mask` at ``(dropout_seed, bh, raw row, column)``;
        ``l`` and ``m`` stay the undropped statistics.  The seed is an int
        (a tensor is read once on the host).
      block_mask: a :class:`BlockMask` built for ``(R, S_kv)`` rounded up to
        its blocks; not with causal, window or ``q_seq_len``.
      dropout_row_stride: the raw row coordinate of folded row r is
        ``(r // q_seq_len) * dropout_row_stride + r % q_seq_len``; default
        ``q_seq_len`` (:func:`ops.dispatch.attention` passes the JAX
        package's padded segment length).
      precision: the JAX package's mode for float32 inputs, resolved by
        :func:`resolve_precision` (default ``"bf16_3x"``), computed by the
        float32 form where :func:`kernel_form` takes it (``"float32"``:
        three bf16 terms and six products, XLA's HIGHEST), else by the exact
        float32 kernel.
      interpret: the JAX package's Pallas interpreter switch, accepted and
        ignored (a CPU tensor runs the plain version).

    Returns ``o`` like q, or ``(o, l, m)``.
    """
    precision = resolve_precision(quant_precision(precision, k_scales is not None), q.dtype)
    dropout_rate = check_dropout(dropout_rate)
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
    if block_mask is not None:
        check_block_mask(block_mask, rows, s_kv, causal=causal, window=window,
                         q_seq_len=q_seq_len)
    q_seq_len = rows if q_seq_len is None else int(q_seq_len)
    if q_seq_len <= 0 or rows % q_seq_len:
        raise ValueError(f"q_seq_len ({q_seq_len}) must divide the rows ({rows})")
    seg_q, seg_kv = fold_segment_ids(q_segment_ids, kv_segment_ids, bh, rows, s_kv, q.device)
    dropout = dict(dropout_rate=dropout_rate, dropout_seed=wrap_int32(dropout_seed),
                   dropout_row_stride=dropout_row_stride)

    scales = (k_scales, v_scales) if quantized else ()
    if not all(t.is_contiguous() for t in (q, k, v, *scales)):
        raise ValueError("flash_attention takes contiguous q, k, v and scales")
    f32_q = f32_q_in_bf16(q.dtype, quantized, precision, d, block_mask=block_mask is not None,
                          dropout=dropout_rate is not None)
    qk = q.to(torch.bfloat16) if f32_q else q  # the q the kernel takes
    form = kernel_form("flash_fwd", qk.dtype, d, quantized=quantized,
                       block_mask=block_mask is not None, dropout=dropout_rate is not None,
                       precision=precision)
    if q.device.type == "cpu":
        return flash_attention_plain(
            q, k, v, causal=causal, scale=scale, kv_len=kv_len,
            q_offset=q_offset, q_seq_len=q_seq_len, save_residuals=save_residuals,
            q_segment_ids=seg_q, kv_segment_ids=seg_kv, window=window,
            logit_softcap=logit_softcap, block_mask=block_mask, form=form,
            k_scales=k_scales, v_scales=v_scales, precision=precision, **dropout,
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
    o = torch.empty_like(q)  # the tensor-core forms write float32 O for float32 q
    l = m = None
    if save_residuals:
        l = torch.empty((bh, rows), dtype=torch.float32, device=q.device)
        m = torch.empty((bh, rows), dtype=torch.float32, device=q.device)
    if form == "tc":
        tiles = None
        if block_mask is not None:
            tiles = block_mask.tiles(TC_BLOCK_Q, TC_KV_TILE[d], q.device).by_q()
        _flash_fwd_tc(qk, k, v, o, l, m, seg_q, seg_kv, scales, tiles, kv_len=kv_len,
                      q_offset=int(q_offset), q_seq_len=q_seq_len, causal=bool(causal),
                      scale=float(scale), window=window, logit_softcap=logit_softcap,
                      dropout_rate=dropout_rate, dropout_seed=dropout["dropout_seed"],
                      dropout_row_stride=dropout_row_stride)
        flash_attention.launches_tc += 1
        flash_attention.launches += 1
        flash_attention.launches_quantized += quantized
        flash_attention.launches_tc_quantized += quantized
        flash_attention.launches_tc_quantized_f32q += f32_q
        flash_attention.launches_dropout += dropout_rate is not None
        flash_attention.launches_block_mask += block_mask is not None
        flash_attention.launches_tc_block_mask += block_mask is not None
        return (o, l, m) if save_residuals else o
    if form == "tc_f32":
        _flash_fwd_tc_f32(q, k, v, o, l, m, seg_q, seg_kv, precision, kv_len=kv_len,
                          q_offset=int(q_offset), q_seq_len=q_seq_len, causal=bool(causal),
                          scale=float(scale), window=window, logit_softcap=logit_softcap,
                          **dropout)
        flash_attention.launches_tc_f32 += 1
        flash_attention.launches_tc_f32_bf16 += precision == "bf16"
        flash_attention.launches_tc_f32_split += f32_split(d, precision)
        flash_attention.launches_tc_f32_dropout += dropout_rate is not None
        flash_attention.launches_dropout += dropout_rate is not None
        flash_attention.launches += 1
        return (o, l, m) if save_residuals else o
    name = "flash_fwd_quant" if quantized else "flash_fwd"
    if dropout_rate is not None or block_mask is not None:
        name += "_extra"  # the dropout / block-mask form's library
    tiles = (None,) * 4
    if block_mask is not None:
        tiles = block_mask.tiles(fwd_tile(d), 32, q.device).by_q()
    status = kernels.library(name).fa_flash_fwd(
        _DTYPES[q.dtype], KV_DTYPES[k.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        *(t.data_ptr() if quantized else None for t in (k_scales, v_scales)), o.data_ptr(),
        None if l is None else l.data_ptr(), None if m is None else m.data_ptr(),
        None if seg_q is None else seg_q.data_ptr(),
        None if seg_kv is None else seg_kv.data_ptr(), *tiles, bh, rows, s_kv, d, kv_len,
        int(q_offset), q_seq_len, int(bool(causal)), float(scale),
        *kernel_options(window, logit_softcap),
        *dropout_options(dropout_rate, dropout["dropout_seed"], dropout_row_stride, q_seq_len),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    kernels.check_launch(name, status, f"q {tuple(q.shape)} {q.dtype}, k {k.dtype}")
    flash_attention.launches += 1
    flash_attention.launches_quantized += quantized
    flash_attention.launches_dropout += dropout_rate is not None
    flash_attention.launches_block_mask += block_mask is not None
    return (o, l, m) if save_residuals else o


def _flash_fwd_tc(q, k, v, o, l, m, seg_q, seg_kv, scales, tiles, *, kv_len, q_offset,
                  q_seq_len, causal, scale, window, logit_softcap, dropout_rate, dropout_seed,
                  dropout_row_stride):
    """One launch of the tensor-core forward (``csrc/flash_fwd_tc.cu``),
    into ``o`` (and ``l``, ``m`` unless None); ``scales`` ``(k_scales,
    v_scales)`` for 8-bit K/V (its ``flash_fwd_tc_quant`` form), else ``()``;
    ``tiles`` a block mask's table (:meth:`MaskTiles.by_q`) or None; a
    float32 ``o`` (the 8-bit form over float32 q taken in bf16) is written
    straight from the float32 sums.  Its TMA loads take 16-byte aligned
    tensors."""
    kernels.check_aligned("flash_attention", q, k, v)
    bh, rows, d = q.shape
    extra = dropout_rate is not None or tiles is not None
    name = "flash_fwd_tc_extra" if extra else "flash_fwd_tc"
    quant, table = (), tiles or (None,) * 4  # the bf16 form takes the block mask's table
    if scales:  # the 8-bit form: the payload's type code, float32 O, the two scale arrays, no table
        name = "flash_fwd_tc_quant"
        quant = (KV_DTYPES[k.dtype], int(o.dtype == torch.float32), *(t.data_ptr() for t in scales))
        table = ()
    status = getattr(kernels.library(name), kernels.KERNELS[name][1])(
        *quant, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        None if l is None else l.data_ptr(), None if m is None else m.data_ptr(),
        None if seg_q is None else seg_q.data_ptr(),
        None if seg_kv is None else seg_kv.data_ptr(), *table, bh, rows, k.shape[1], d, kv_len,
        q_offset, q_seq_len, int(causal), scale, *kernel_options(window, logit_softcap),
        *dropout_options(dropout_rate, dropout_seed, dropout_row_stride, q_seq_len),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    kernels.check_launch(name, status, f"q {tuple(q.shape)} {q.dtype}")


def _flash_fwd_tc_f32(q, k, v, o, l, m, seg_q, seg_kv, precision, *, kv_len, q_offset,
                      q_seq_len, causal, scale, window, logit_softcap, dropout_rate=None,
                      dropout_seed=0, dropout_row_stride=None):
    """One call of the float32 form (``csrc/flash_fwd_tc.cu`` built with
    ``-DFA_F32``) into float32 ``o``: in ``"float32"`` (three bf16 terms)
    and in ``"bf16_3x"`` at d = 256 (two) ``csrc/flash_fwd_f32.cuh``'s
    kernel over q, k and v themselves, split in shared memory; else a split
    pass writes them as rows of two bf16 terms (``"bf16_3x"``) or one
    (``"bf16"``) into buffers made here, which the tensor-core forward
    reads.  With dropout (d = 64 and 128, split pass only) its dropout form,
    ``flash_fwd_tc_f32_extra`` (``-DFA_F32 -DFA_EXTRA``)."""
    kernels.check_aligned("flash_attention", q, k, v)
    bh, rows, d = q.shape
    terms = {"bf16": 1, "bf16_3x": 2, "float32": 3}[precision]
    split = ()
    if not f32_split(d, precision):
        split = tuple(torch.empty((bh, x.shape[1], terms * d), dtype=torch.bfloat16,
                                  device=q.device) for x in (q, k, v))
    name = "flash_fwd_tc_f32" if dropout_rate is None else "flash_fwd_tc_f32_extra"
    status = kernels.library(name).fa_flash_fwd_tc_f32(
        terms, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        *([t.data_ptr() for t in split] if split else [None] * 3), o.data_ptr(),
        None if l is None else l.data_ptr(), None if m is None else m.data_ptr(),
        None if seg_q is None else seg_q.data_ptr(),
        None if seg_kv is None else seg_kv.data_ptr(), bh, rows, k.shape[1], d, kv_len,
        q_offset, q_seq_len, int(causal), scale, *kernel_options(window, logit_softcap),
        *dropout_options(dropout_rate, dropout_seed, dropout_row_stride, q_seq_len),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    kernels.check_launch(name, status, f"q {tuple(q.shape)} {precision}")


# Kernel launches, for chip_smoke.py's path check: all forms, and the
# tensor-core, 8-bit, tensor-core 8-bit, dropout, block-mask and tensor-core
# block-mask ones among them; the tensor-core 8-bit form's over float32 q
# taken in bf16 among those; the float32 form's, and its "bf16" mode's and
# its split-in-shared-memory kernel's (csrc/flash_fwd_f32.cuh,
# :func:`f32_split`) and its dropout form's among those.
flash_attention.launches = 0
flash_attention.launches_tc = 0
flash_attention.launches_tc_f32 = 0
flash_attention.launches_tc_f32_bf16 = 0
flash_attention.launches_tc_f32_split = 0
flash_attention.launches_tc_f32_dropout = 0
flash_attention.launches_quantized = 0
flash_attention.launches_tc_quantized = 0
flash_attention.launches_tc_quantized_f32q = 0
flash_attention.launches_dropout = 0
flash_attention.launches_block_mask = 0
flash_attention.launches_tc_block_mask = 0


def flash_attention_plain(
    q, k, v, *, causal=False, scale=1.0, kv_len=None, q_offset=0,
    q_seq_len=None, save_residuals=False, q_segment_ids=None, kv_segment_ids=None,
    window=None, logit_softcap=None, block_mask=None, dropout_rate=None, dropout_seed=0,
    dropout_row_stride=None, form=None, k_scales=None, v_scales=None, precision=None,
):
    """The kernel's function in plain PyTorch, float32 throughout (on the
    CPU ``exp`` in float64, rounded once: see :func:`_exp`): the CPU path of
    :func:`flash_attention` and its yardstick on the card.  The block mask's
    element predicate and the dropout keep bits are computed densely from
    the same functions the kernel's tables and hash come from.

    ``form`` (default: :func:`kernel_form` of these inputs; K/V of another
    type than q without scales count as 8-bit rows the scalar form
    dequantized) mirrors the kernel form's rounding: ``"tc"`` feeds the PV
    product each p as the tensor-core kernel does, as two bfloat16 terms
    (:func:`_two_term_bf16`) against the running max of its online softmax
    (the row's max over the KV tiles of ``TC_KV_TILE[d]`` columns up to p's
    own), then rescaled by ``exp(m_tile - m)``; ``"scalar"`` keeps p in
    float32.  With ``k_scales``/``v_scales`` (float32 ``(BH, S_kv)``) k and
    v hold 8-bit payloads (int8 or fp8, or their values in float32): the
    scalar form dequantizes the rows first; the tc form takes the payload's
    values as they are (exact in bf16), multiplies score column j by
    ``k_scales[j]`` before the scale, softcap and masks, and folds
    ``v_scales[j]`` into p's column j before its two-term split, as the
    Pallas kernel orders them (flash.py:816-828, 968-978).  ``"tc_f32"``
    (float32 inputs) computes the mode ``precision`` resolves to as the
    float32 form does: in ``"bf16_3x"`` S is the sum of the products of q's
    and k's bf16 terms (:func:`_split_bf16`; :func:`f32_products` of them),
    p (against the running max of :func:`f32_kv_tile`-column tiles) enters
    PV as its two terms against V's, ``(p_hi + p_lo) v_hi + p_hi v_lo`` (+
    ``p_lo v_lo`` at four products), and l sums the float32 p; in
    ``"float32"`` each value is three terms (:func:`_split3_bf16`), S and PV
    sum the six products x1 y1, x1 y2, x2 y1, x1 y3, x2 y2, x3 y1 exactly
    (float64, rounded once to float32); in ``"bf16"``
    q, k and v are rounded to bf16 once and the ``"tc"`` form follows, its O
    in float32.  Float32 q over 8-bit K/V in the ``"tc"`` form (by default
    where the kernel takes it in bf16, :func:`f32_q_in_bf16`) runs over q's
    bf16 values, O in float32."""
    bh, rows, d = q.shape
    s_kv = k.shape[1]
    if k_scales is not None and q.dtype == torch.float32 and (form == "tc" or (
            form is None and f32_q_in_bf16(q.dtype, True, precision, d,
                                           block_mask=block_mask is not None,
                                           dropout=bool(dropout_rate)))):
        q, form = q.to(torch.bfloat16).float(), "tc"  # bf16 values; O stays float32
    if form is None:
        if k_scales is None and k.dtype != q.dtype:
            form = "scalar"
        else:
            form = kernel_form("flash_fwd", q.dtype, d, quantized=k_scales is not None,
                               block_mask=block_mask is not None, dropout=bool(dropout_rate),
                               precision=precision)
    products = 0
    if form == "tc_f32":
        mode = resolve_precision(precision, q.dtype)
        if mode == "bf16":
            q, k, v = (x.to(torch.bfloat16).float() for x in (q, k, v))
            form = "tc"
        else:
            products = f32_products(d, mode)
    if k_scales is not None and form != "tc":  # the scalar form: dequantize first
        k, v = dequantize_rows(k, k_scales), dequantize_rows(v, v_scales)
        k_scales = v_scales = None
    kv_len = s_kv if kv_len is None else kv_len
    q_seq_len = rows if q_seq_len is None else q_seq_len
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
        kv_scales = None if k_scales is None else (k_scales[sl], v_scales[sl])
        outs.append(_fwd_plain_heads(q[sl], k[sl], v[sl], seg_mask, keep, kv_scales, scale=scale,
                                     logit_softcap=logit_softcap, dropout_rate=dropout_rate,
                                     form=form, products=products,
                                     tile=f32_kv_tile(d, mode) if products else None))
    o, l, m = (torch.cat(x) for x in zip(*outs))
    return (o, l, m) if save_residuals else o


def _fwd_plain_heads(q, k, v, mask, keep, kv_scales, *, scale, logit_softcap, dropout_rate,
                     form, products=0, tile=None):
    """flash_attention_plain over some heads: ``(o, l, m)``; ``kv_scales``
    the 8-bit tc form's ``(k_scales, v_scales)`` of these heads, or None;
    ``products`` the float32 form's (3 or 4 in "bf16_3x", 6 in "float32";
    0 otherwise); ``tile`` the float32 form's KV tile (:func:`f32_kv_tile`;
    default the tensor-core forms', ``TC_KV_TILE``)."""
    bh, rows, d = q.shape
    s_kv = k.shape[1]
    if products == 6:
        s = _highest("bqd,bkd->bqk", q, k)
    elif products:  # S from the terms' products: hi hi, hi lo, lo hi (, lo lo)
        (qh, ql), (kh, kl) = _split_bf16(q), _split_bf16(k)
        pairs = ((qh, kh), (qh, kl), (ql, kh), (ql, kl))[:products]
        s = sum(torch.einsum("bqd,bkd->bqk", a, b) for a, b in pairs)
        del qh, ql, kh, kl, pairs
    else:
        # The tensor-core forms' S as their float32 accumulator holds it: the
        # bf16 products (exact) summed, rounded to float32 once.  A float32
        # product rounds every partial sum in an order of its own, which
        # moves s by a few ulps and p with it, and where p's second bf16
        # term lies near a rounding boundary that term by a unit, a step
        # the two-term P resolves (torch_tools/c5_oracle.py measures it).
        x = torch.float64 if form == "tc" else torch.float32
        s = torch.einsum("bqd,bkd->bqk", q.to(x), k.to(x)).float()
    if kv_scales is not None:
        s = s * kv_scales[0][:, None, :]
    s = softcap(s * scale, logit_softcap)
    s = torch.where(mask, s, torch.tensor(DEFAULT_MASK_VALUE, device=q.device))
    del mask
    m = s.amax(dim=-1)
    p = _exp(s - m[..., None])
    l = p.sum(dim=-1)
    if form in ("tc", "tc_f32"):  # p against the running max, as bf16 terms, rescaled
        tile = tile or TC_KV_TILE[d]
        nt = -(-s_kv // tile)
        padded = torch.nn.functional.pad(s, (0, nt * tile - s_kv), value=DEFAULT_MASK_VALUE)
        m_run = padded.view(bh, rows, nt, tile).amax(dim=-1).cummax(dim=-1).values
        del padded
        m_run = m_run.repeat_interleave(tile, dim=-1)[..., :s_kv]
        p = _exp(s - m_run)
        m_run = _exp(m_run - m[..., None])
    del s
    if dropout_rate:  # l stays the undropped sum (flash.py:931-937)
        p = torch.where(keep, p * (1.0 / (1.0 - dropout_rate)), 0.0)
    if products == 6:  # P's three terms (times the rescale) against V's
        o = _highest("bqk,bkd->bqd", p, v, m_run)
        del m_run
    elif products:  # P's two terms against V's: (p_hi + p_lo) v_hi + p_hi v_lo (+ p_lo v_lo)
        ph, pl = _split_bf16(p)
        vh, vl = _split_bf16(v)
        o = (torch.einsum("bqk,bkd->bqd", (ph + pl) * m_run, vh)
             + torch.einsum("bqk,bkd->bqd", (ph + pl if products == 4 else ph) * m_run, vl))
        del ph, pl, m_run
    else:
        if form == "tc":
            if kv_scales is not None:
                p = p * kv_scales[1][:, None, :]
            p = _two_term_bf16(p) * m_run
            del m_run
        o = torch.einsum("bqk,bkd->bqd", p, v.float())
    o = (o / torch.where(l == 0, 1.0, l)[..., None]).to(q.dtype)
    return o, l, m


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
    interpret: bool | None = None,
) -> torch.Tensor:
    """Naive attention: each query row's dense softmax over the whole KV
    stripe, float32 throughout.  ``interpret``, the JAX package's Pallas
    interpreter switch, is accepted and ignored.

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
