"""Shared training-step plumbing for one device.

Counterpart of ``flashattention_tpu/models/train/common.py``: the per-token
NLL (:194), per-document RoPE positions for packed rows (:164) and the step
tail (:205), plain SGD or an optimizer.  The Megatron f/g collective pair,
the vocab-parallel NLL and the parameter sharding specs come with the
multi-device slice.
"""

from __future__ import annotations

import functools

import torch

__all__ = ["adamw", "init_opt_state", "leaves", "packed_positions", "token_nll"]


def packed_positions(segment_ids: torch.Tensor) -> torch.Tensor:
    """Per-document RoPE positions for packed rows: index within segment.

    segment_ids: (B, S) integer, padding marked with a negative id.  Returns
    (B, S) int32 positions restarting at 0 on every segment change, so that
    packed documents see exactly the rotary phases they would see alone.
    """
    b, s = segment_ids.shape
    idx = torch.arange(s, dtype=torch.int32, device=segment_ids.device).expand(b, s)
    change = torch.ones((b, s), dtype=torch.bool, device=segment_ids.device)
    change[:, 1:] = segment_ids[:, 1:] != segment_ids[:, :-1]
    start = torch.cummax(torch.where(change, idx, 0), dim=1).values
    return idx - start


def token_nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-token NLL in float32: ``-log p(targets)`` under ``logits``."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, targets.long()[..., None])[..., 0]


def leaves(params: dict) -> list:
    """The parameter tensors of a model tree, in a fixed order."""
    out = [params["embed"], params["final_norm"], params["lm_head"]]
    for layer in params["layers"]:
        out.extend(layer.values())
    return out


def with_leaves(params: dict, new: list) -> dict:
    """The tree of ``params`` with its tensors replaced, in :func:`leaves`
    order, by ``new``."""
    it = iter(new)
    tree = {"embed": next(it), "final_norm": next(it), "lm_head": next(it), "layers": []}
    for layer in params["layers"]:
        tree["layers"].append({name: next(it) for name in layer})
    return tree


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4):
    """An AdamW optimizer for :func:`init_opt_state` and the optimizer
    steps, with ``optax.adamw``'s arguments and defaults (its weight decay
    of 1e-4, where ``torch.optim.AdamW`` defaults to 1e-2): a factory of
    ``torch.optim.AdamW`` over a list of tensors."""
    return functools.partial(torch.optim.AdamW, lr=learning_rate, betas=(b1, b2), eps=eps,
                             weight_decay=weight_decay)


def init_opt_state(optimizer, params: dict) -> torch.optim.Optimizer:
    """The optimizer state of ``params`` (``optimizer.init(params)`` in
    optax): ``optimizer``, a factory such as :func:`adamw` or
    ``functools.partial(torch.optim.SGD, lr=...)``, built over the tree's
    tensors in :func:`leaves` order.  Its ``state_dict()`` is what a
    checkpoint stores; ``load_state_dict`` restores it."""
    return optimizer(leaves(params))


def _make_step(grad_call, lr: float | None, optimizer=None):
    """The step around ``grad_call(params, *args) -> (loss, grads)``.

    ``optimizer`` None: SGD, ``p - lr * g`` in the parameter's dtype
    (steps_core.py:49-51); ``step(params, *args) -> (loss, params)``.
    Otherwise the step threads the optimizer state as its second argument,
    as the JAX step threads ``opt_state`` (common.py:205):
    ``step(params, opt_state, *args) -> (loss, params, opt_state)``, where
    ``opt_state`` is the ``torch.optim.Optimizer`` that
    :func:`init_opt_state` built over these parameters.  Either way the
    update is made in place on the caller's tensors, where the JAX step
    returns new ones."""
    if optimizer is None:

        def step(params, *args):
            loss, grads = grad_call(params, *args)
            with torch.no_grad():
                for p, g in zip(leaves(params), grads):
                    p.sub_(lr * g.to(p.dtype))
            return loss, params

        return step

    def opt_step(params, opt_state, *args):
        tensors = leaves(params)
        held = [p for group in opt_state.param_groups for p in group["params"]]
        if len(held) != len(tensors) or any(a is not b for a, b in zip(held, tensors)):
            raise ValueError("opt_state was not built over these parameters "
                             "(init_opt_state(optimizer, params))")
        loss, grads = grad_call(params, *args)
        for p, g in zip(tensors, grads):
            p.grad = g.to(p.dtype)
        opt_state.step()
        opt_state.zero_grad(set_to_none=True)
        return loss, params, opt_state

    return opt_step
