"""flashattention_tpu_torch — the PyTorch and CUDA port of flashattention_tpu.

It keeps the JAX package's layout and names (``ops/``, ``models/``,
``runtime/``, ``utils/``, ``csrc/``) so each module's counterpart is easy to
find; every Pallas kernel it has ported is a CUDA C++ kernel for Hopper
(``sm_90a``) in ``csrc/``, with a plain PyTorch version of the same function
beside it for CPU tensors.  It imports neither JAX nor the JAX package.
"""

from flashattention_tpu_torch.ops.backward import attention_vjp, flash_attention_bwd
from flashattention_tpu_torch.ops.decode import (
    paged_attention,
    paged_prefill_attention,
    paged_prefill_attention_batched,
)
from flashattention_tpu_torch.ops.dispatch import attention, sdpa
from flashattention_tpu_torch.ops.flash import (
    BlockMask,
    BlockSizes,
    flash_attention,
    flash_attention_naive,
)
from flashattention_tpu_torch.ops.quant import (
    QuantizedTensor,
    QuantizedWeight,
    attention_quantized,
    dequantize,
    dequantize_weight,
    quantize,
    quantize_kv,
    quantize_weight,
    quantize_weights,
)
from flashattention_tpu_torch.ops.reference import (
    attention_reference,
    attention_reference_with_stats,
)

__version__ = "0.1.0"

__all__ = [
    "attention",
    "sdpa",
    "BlockMask",
    "BlockSizes",
    "flash_attention",
    "flash_attention_naive",
    "attention_vjp",
    "flash_attention_bwd",
    "paged_attention",
    "paged_prefill_attention",
    "paged_prefill_attention_batched",
    "attention_reference",
    "attention_reference_with_stats",
    "QuantizedTensor",
    "QuantizedWeight",
    "attention_quantized",
    "dequantize",
    "dequantize_weight",
    "quantize",
    "quantize_kv",
    "quantize_weight",
    "quantize_weights",
]
