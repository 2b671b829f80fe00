"""Training steps on one device: plain and packed-sequence, SGD or an
optimizer.

Counterpart of ``flashattention_tpu/models/train/steps_core.py``
(``make_train_step`` :16, ``make_train_step_optax`` :57,
``make_train_step_packed`` :101) without a mesh: the data-parallel and
tensor-parallel axes and vocab-parallel logits come with the multi-device
slice.  ``compute_dtype`` is mixed precision, as in the JAX steps: the
masters keep their dtype and take the update there, and each layer computes
in ``compute_dtype`` (``forward.forward_logits``).  Where the JAX step
returns new parameters (and optimizer state), this one updates the caller's
tensors (and ``torch.optim`` state) in place and returns them.  The steps
run on the card unless the caller asks for the CPU (``device="cpu"``), and
refuse parameters or tokens elsewhere.
"""

from __future__ import annotations

import torch

from flashattention_tpu_torch.models.train.common import _make_step, leaves
from flashattention_tpu_torch.models.train.forward import make_grad_fn
from flashattention_tpu_torch.models.transformer import ModelConfig
from flashattention_tpu_torch.utils.device import resolve_device

__all__ = ["make_train_step", "make_train_step_optax", "make_train_step_packed"]


def _on_device(step, device, n_state=0):
    """Check the configuration's device once, and each call's tensors: the
    parameters, the ``n_state`` arguments after them (a LoRA tree's tensors
    too; an optimizer state is not checked) and the data."""
    dev = resolve_device(device)

    def checked(params, *rest):
        state, (tokens, *rest) = rest[:n_state], rest[n_state:]
        where = {params["embed"].device.type, tokens.device.type}
        where.update(t.device.type for t in rest if torch.is_tensor(t))
        where.update(t.device.type for s in state if isinstance(s, list) for t in leaves(s))
        if where != {dev.type}:
            raise ValueError(f"the step runs on {dev.type}; got tensors on {sorted(where)}")
        return step(params, *state, tokens, *rest)

    return checked


def make_train_step(cfg: ModelConfig, *, lr: float = 1e-3, remat: bool = False,
                    attn_dropout: float | None = None, compute_dtype=None, device=None):
    """``step(params, tokens, seed=0) -> (loss, params)``: one SGD step of
    next-token causal-LM cross-entropy.

    tokens: (B, S) integer tensor on the parameters' device.  ``remat=True``
    recomputes each layer in the backward: activation memory O(1) in depth,
    the same loss and update.  ``attn_dropout`` drops attention weights at
    that rate; ``seed`` (an int, the step counter; a tensor is read once on
    the host, one sync per step) sets the keep bits as the JAX step's does,
    and a recomputed layer draws the same ones.  ``compute_dtype`` (e.g.
    ``"bfloat16"`` over float32 parameters) casts each layer's weights just
    in time; the gradients come back in the parameters' dtype, and the
    update ``p - lr * g`` is made there.
    """
    grad_fn = make_grad_fn(cfg, remat=remat, attn_dropout=attn_dropout,
                           compute_dtype=compute_dtype)
    return _on_device(_make_step(grad_fn, lr), device)


def make_train_step_optax(cfg: ModelConfig, optimizer, *, remat: bool = False,
                          attn_dropout: float | None = None, compute_dtype=None, device=None):
    """``step(params, opt_state, tokens, seed=0) -> (loss, params,
    opt_state)``: :func:`make_train_step`'s loss and gradients, the update
    made by an optimizer.

    ``optimizer`` builds a ``torch.optim.Optimizer`` over a list of tensors
    (``train.adamw(...)``, or e.g. ``functools.partial(torch.optim.SGD,
    lr=...)``); ``opt_state = train.init_opt_state(optimizer, params)``
    builds it over the parameters, as ``optimizer.init(params)`` does in
    optax; with ``compute_dtype`` it updates the full-precision masters.
    Usage::

        opt = train.adamw(3e-4, weight_decay=0.01)
        step = train.make_train_step_optax(cfg, opt)
        opt_state = train.init_opt_state(opt, params)
        loss, params, opt_state = step(params, opt_state, tokens)
    """
    grad_fn = make_grad_fn(cfg, remat=remat, attn_dropout=attn_dropout,
                           compute_dtype=compute_dtype)
    return _on_device(_make_step(grad_fn, None, optimizer), device, n_state=1)


def make_train_step_packed(cfg: ModelConfig, *, lr: float = 1e-3, remat: bool = False,
                           attn_dropout: float | None = None, optimizer=None,
                           compute_dtype=None, device=None):
    """``step(params, tokens, segment_ids, seed=0) -> (loss, params)`` over
    packed rows: each row holds several documents marked by ``segment_ids``
    (negative = padding, see :func:`utils.packing.pack_documents`).
    Attention stays within documents, RoPE restarts per document, and the
    loss is the mean over valid next-token targets; ``attn_dropout``,
    ``seed`` and ``compute_dtype`` as in :func:`make_train_step`.  With ``optimizer`` (as in
    :func:`make_train_step_optax`) the update is the optimizer's and the
    step threads its state: ``step(params, opt_state, tokens, segment_ids,
    seed=0) -> (loss, params, opt_state)``."""
    grad_fn = make_grad_fn(cfg, packed=True, remat=remat, attn_dropout=attn_dropout,
                           compute_dtype=compute_dtype)
    return _on_device(_make_step(grad_fn, lr, optimizer), device,
                      n_state=int(optimizer is not None))
