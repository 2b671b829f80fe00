"""8-bit quantization: int8 / fp8 K/V payloads with per-row scales, and
weight-only quantized parameters.

Counterpart of ``flashattention_tpu/ops/quant.py``.  The same float32 input
gives the same payloads and scales, bit for bit, in both packages: the
payload is one IEEE float32 division by the scale, ``torch.round`` rounds
half to even as ``jnp.round`` does, and fp8 payloads are
``torch.float8_e4m3fn``, rounded to nearest even as ``ml_dtypes`` rounds.
The scale is ``absmax / qmax`` in :func:`quantize` and
:func:`quantize_weight`, which the JAX package runs eagerly; its KV cache
and model steps quantize under ``jit``, where XLA compiles the division by
the constant ``qmax`` into a product with its float32 reciprocal, so
:func:`quantize_rows`, which the port's cache and model steps use, computes
that product.

:func:`attention_quantized` attends a float32 or bfloat16 q to quantized
K/V.  On CUDA tensors it launches the 8-bit form of the flash kernel
(``csrc/flash_fwd.cu`` built with ``FA_QUANT``), which dequantizes each K/V
row as it stages its tile; on CPU tensors it runs the plain version.  The JAX
function pads a ragged S, and each GQA segment, to its tile: that is a TPU
tiling need, and the CUDA kernel masks the ragged edge instead, with the same
outputs.

The containers are plain dataclasses (the JAX package's are pytrees).
"""

from __future__ import annotations

import dataclasses

import torch

from flashattention_tpu_torch.ops.flash import BlockSizes, flash_attention

__all__ = [
    "QuantizedTensor",
    "quantize",
    "dequantize",
    "quantize_kv",
    "attention_quantized",
    "QuantizedWeight",
    "quantize_weight",
    "quantize_weights",
    "dequantize_weight",
    "QUANT_DTYPES",
]

QUANT_DTYPES = {
    "int8": (torch.int8, 127.0),
    "fp8": (torch.float8_e4m3fn, 448.0),
}
# float32(1 / qmax), as a Python float that holds it exactly (a product with
# a float32 tensor rounds it to itself, so no device copy is needed).
_RECIPROCALS = {k: float(torch.tensor(1.0) / qmax) for k, (_, qmax) in QUANT_DTYPES.items()}


def byte_view(t: torch.Tensor) -> torch.Tensor:
    """An fp8 tensor as its uint8 bytes (any other as it is): gathers and
    scatters of 8-bit pools and tables move the same bits through the
    integer indexing kernels."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def _payload(scaled: torch.Tensor, dtype: str) -> torch.Tensor:
    """float32 values already divided by their scale -> the 8-bit payload."""
    qdtype, qmax = QUANT_DTYPES[dtype]
    if qdtype == torch.int8:
        return torch.clamp(torch.round(scaled), -qmax, qmax).to(torch.int8)
    return scaled.to(qdtype)


def _quantize(xf, absmax, dtype, *, folded):
    """``(payload, scales)`` of float32 rows ``xf`` with absmax ``absmax``:
    ``scales = absmax / qmax`` (``folded``: ``absmax * float32(1 / qmax)``),
    1 for an all-zero row."""
    if dtype not in QUANT_DTYPES:
        raise ValueError(f"dtype must be one of {list(QUANT_DTYPES)}, got {dtype!r}")
    if folded:
        scaled = absmax * _RECIPROCALS[dtype]
    else:
        scaled = absmax / QUANT_DTYPES[dtype][1]
    scales = torch.where(absmax == 0.0, 1.0, scaled)
    return _payload(xf / scales[..., None], dtype), scales


def quantize_rows(x: torch.Tensor, dtype: str = "int8"):
    """Per-row absmax quantization over the last axis, as the JAX package's
    KV cache (``_quantize_rows``) and model steps (``_quantize_row``) compute
    it under ``jit``: ``(payload, scales)`` with
    ``scales = absmax * float32(1 / qmax)`` (1 for an all-zero row)."""
    xf = x.float()
    return _quantize(xf, xf.abs().amax(dim=-1), dtype, folded=True)


@dataclasses.dataclass
class QuantizedTensor:
    """Quantized payload + float32 scales.

    payload: ``(BH, S, d)`` int8 or fp8; scales: ``(BH, S)`` float32 such
    that ``dequantized = payload.float() * scales[..., None]``.
    """

    payload: torch.Tensor
    scales: torch.Tensor

    @property
    def shape(self):
        return self.payload.shape

    @property
    def dtype(self):
        return self.payload.dtype


def quantize(x: torch.Tensor, dtype: str = "int8", *, granularity: str = "token") -> QuantizedTensor:
    """Quantize ``(BH, S, d)`` to int8/fp8 with absmax scaling: one scale per
    row (``"token"``), or one per BH replicated over S (``"head"``)."""
    xf = x.float()
    if granularity == "token":
        absmax = xf.abs().amax(dim=-1)
    elif granularity == "head":
        absmax = xf.abs().amax(dim=(-2, -1), keepdim=True)[..., 0].expand(xf.shape[:-1])
    else:
        raise ValueError(f"granularity must be 'token' or 'head', got {granularity!r}")
    payload, scales = _quantize(xf, absmax.contiguous(), dtype, folded=False)
    return QuantizedTensor(payload, scales)


def dequantize(qt: QuantizedTensor, dtype=torch.float32) -> torch.Tensor:
    return (qt.payload.float() * qt.scales[..., None]).to(dtype)


def quantize_kv(k, v, dtype: str = "int8", *, granularity: str = "token"):
    return (
        quantize(k, dtype, granularity=granularity),
        quantize(v, dtype, granularity=granularity),
    )


def attention_quantized(
    q: torch.Tensor,
    k: QuantizedTensor,
    v: QuantizedTensor,
    *,
    causal: bool = False,
    scale: float = 1.0,
    block_sizes: BlockSizes | None = None,
    kv_len: int | None = None,
    q_offset: int = 0,
    save_residuals: bool = False,
    precision: str | None = None,
    q_seq_len: int | None = None,
    interpret: bool | None = None,
    window: int | None = None,
    logit_softcap: float | None = None,
):
    """Flash attention of q ``(BH, S_q, d)`` over a quantized K/V pair, with
    the dequantization fused into the kernel.  Any S_q and S_kv; with
    ``q_seq_len``, q holds ``S_q // q_seq_len`` GQA segments of that many
    rows (any length).  ``precision`` and ``interpret`` as in
    :func:`ops.flash.flash_attention`: by default ``"bf16"``, float32 q
    taken in bf16 as the JAX kernel takes it where the tensor-core 8-bit
    form takes the call, O in float32; ``"bf16_3x"`` and ``"float32"`` keep
    q in float32 (the exact scalar form).  Returns ``o`` like q, or
    ``(o, l, m)``."""
    if q_seq_len is not None and q.shape[1] % q_seq_len:
        raise ValueError(f"q_seq_len ({q_seq_len}) must divide s_q ({q.shape[1]})")
    return flash_attention(
        q, k.payload, v.payload, k_scales=k.scales, v_scales=v.scales, causal=causal,
        scale=scale, block_sizes=block_sizes, kv_len=kv_len, q_offset=q_offset,
        save_residuals=save_residuals, q_seq_len=q_seq_len, window=window,
        logit_softcap=logit_softcap, precision=precision, interpret=interpret,
    )


@dataclasses.dataclass
class QuantizedWeight:
    """Weight-only quantization: int8/fp8 payload + per-output-channel
    scales.

    payload: ``(..., d_in, d_out)`` int8/fp8; scales: ``(..., d_out)``
    float32 such that ``dequantized = payload.float() * scales[..., None, :]``.
    The model's matrix products apply the scale to the output,
    ``(x @ payload) * scales``; ``ldtype`` is the original weight's dtype.
    """

    payload: torch.Tensor
    scales: torch.Tensor
    ldtype: str = "float32"

    @property
    def shape(self):
        return self.payload.shape

    @property
    def dtype(self) -> torch.dtype:  # the logical dtype callers see
        return getattr(torch, self.ldtype)

    def to(self, device) -> "QuantizedWeight":
        return QuantizedWeight(self.payload.to(device), self.scales.to(device), self.ldtype)


def quantize_weight(w: torch.Tensor, dtype: str = "int8") -> QuantizedWeight:
    """Per-output-channel absmax quantization of a ``(..., d_in, d_out)`` weight."""
    qmax = QUANT_DTYPES[dtype][1]
    wf = w.float()
    scales = torch.clamp_min(wf.abs().amax(dim=-2), 1e-30) / qmax
    return QuantizedWeight(_payload(wf / scales[..., None, :], dtype), scales,
                           str(w.dtype).removeprefix("torch."))


def dequantize_weight(qw: QuantizedWeight, dtype=None) -> torch.Tensor:
    return (qw.payload.float() * qw.scales[..., None, :]).to(dtype or qw.dtype)


# Leaves that stay full precision: norms are 1-D (no contraction dim) and
# the router's logits feed a top-k (quantization would flip routings).
_WEIGHT_QUANT_SKIP = ("attn_norm", "mlp_norm", "final_norm", "router")


def quantize_weights(params, dtype: str = "int8", skip=_WEIGHT_QUANT_SKIP):
    """Quantize a transformer parameter tree for weight-only serving.

    Every >= 2-D floating leaf (projections, MLP stacks, embedding table,
    lm_head) becomes a :class:`QuantizedWeight`; ``skip``-named and 1-D
    leaves stay as they are.  The result serves through the same prefill,
    decode and engine paths.
    """

    def walk(node, name=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, name) for v in node)
        if name not in skip and torch.is_tensor(node) and node.dim() >= 2 and node.is_floating_point():
            return quantize_weight(node, dtype)
        return node

    return walk(params)
