"""Shared training-step plumbing for one device.

Counterpart of ``flashattention_tpu/models/train/common.py``: the per-token
NLL (:194), per-document RoPE positions for packed rows (:164) and the SGD
step tail (:205).  The Megatron f/g collective pair, the vocab-parallel NLL
and the parameter sharding specs come with the multi-device slice.
"""

from __future__ import annotations

import torch

__all__ = ["packed_positions", "token_nll"]


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


def _make_step(grad_call, lr: float):
    """SGD step around ``grad_call(params, *args) -> (loss, grads)``:
    ``p - lr * g`` in the parameter's dtype (steps_core.py:49-51).  The
    update is made in place on the caller's tensors, where the JAX step
    returns new ones; the step returns ``(loss, params)``."""

    def step(params, *args):
        loss, grads = grad_call(params, *args)
        with torch.no_grad():
            for p, g in zip(leaves(params), grads):
                p.sub_(lr * g.to(p.dtype))
        return loss, params

    return step
