"""Attention ops: oracles, the flash, naive, paged-decode and paged-prefill
kernels, the backward kernels, dispatch, 8-bit quantization, sampling."""

from flashattention_tpu_torch.ops.backward import attention_vjp, flash_attention_bwd
from flashattention_tpu_torch.ops.dispatch import attention, sdpa
from flashattention_tpu_torch.ops.flash import (
    BlockMask,
    BlockSizes,
    flash_attention,
    flash_attention_naive,
)
from flashattention_tpu_torch.ops.quant import attention_quantized, quantize_kv, quantize_weights
from flashattention_tpu_torch.ops.reference import (
    attention_reference,
    attention_reference_with_stats,
)
