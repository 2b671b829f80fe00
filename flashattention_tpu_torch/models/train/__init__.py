"""Training steps on one device (counterpart of
``flashattention_tpu/models/train``): the causal-LM loss through the
transformer with :func:`~flashattention_tpu_torch.ops.backward.attention_vjp`
(the flash forward kernel and the hand-written backward kernels behind a
``torch.autograd.Function``), plain and packed-sequence steps, SGD or a
``torch.optim`` optimizer threaded as the JAX steps thread optax state,
mixed precision (``compute_dtype``) on all three, and LoRA fine-tuning
(:func:`init_lora`, :func:`merge_lora`, :func:`make_train_step_lora`).
The sharded step families come with the multi-device slice.
"""

from flashattention_tpu_torch.models.train.common import (
    adamw,
    init_opt_state,
    leaves,
    packed_positions,
    token_nll,
)
from flashattention_tpu_torch.models.train.lora import (
    init_lora,
    make_train_step_lora,
    merge_lora,
)
from flashattention_tpu_torch.models.train.steps_core import (
    make_train_step,
    make_train_step_optax,
    make_train_step_packed,
)

__all__ = ["adamw", "init_lora", "init_opt_state", "leaves", "make_train_step",
           "make_train_step_lora", "make_train_step_optax", "make_train_step_packed",
           "merge_lora", "packed_positions", "token_nll"]
