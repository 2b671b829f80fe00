"""Training steps on one device (counterpart of
``flashattention_tpu/models/train``): the causal-LM loss through the
transformer with :func:`~flashattention_tpu_torch.ops.backward.attention_vjp`
(the flash forward kernel and the hand-written backward kernels behind a
``torch.autograd.Function``), plain and packed-sequence SGD.  The sharded
step families come with the multi-device slice.
"""

from flashattention_tpu_torch.models.train.common import packed_positions, token_nll
from flashattention_tpu_torch.models.train.steps_core import make_train_step, make_train_step_packed

__all__ = ["make_train_step", "make_train_step_packed", "packed_positions", "token_nll"]
