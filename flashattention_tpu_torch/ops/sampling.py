"""Token sampling: temperature, top-k and top-p (nucleus) filtering.

Counterpart of ``flashattention_tpu/ops/sampling.py:27-58``.  The random
draw uses a ``torch.Generator`` where the JAX package takes a PRNG key; the
two give different numbers from one seed, so the tests compare the
deterministic filtering, not the sampled tokens.
"""

from __future__ import annotations

import torch

__all__ = ["filter_logits", "sample_logits"]


def filter_logits(logits, *, temperature, top_k, top_p):
    """Temperature + top-k + top-p filtering over the last axis, in float32.

    Top-k first, then the nucleus over the survivors; filtered-out logits
    become -inf so a categorical draw renormalizes over the kept set."""
    logits = logits.float() / temperature
    if top_k is not None and top_k < logits.shape[-1]:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, float("-inf"), logits)
    if top_p is not None and top_p < 1.0:
        desc = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(desc, dim=-1)
        # Keep a sorted token iff the mass strictly before it is < top_p; the
        # top-1 token is always kept (its exclusive prefix mass is 0).
        keep = (torch.cumsum(probs, dim=-1) - probs) < top_p
        cutoff = torch.where(keep, desc, float("inf")).amin(dim=-1, keepdim=True)
        logits = torch.where(logits < cutoff, float("-inf"), logits)
    return logits


def sample_logits(generator: torch.Generator, logits, *, temperature, top_k, top_p):
    """One categorical draw per row of ``logits`` (``(V,)`` or ``(B, V)``)
    from the filtered distribution, on the generator's device."""
    probs = torch.softmax(
        filter_logits(logits, temperature=temperature, top_k=top_k, top_p=top_p), dim=-1
    )
    flat = probs.reshape(-1, probs.shape[-1])
    out = torch.multinomial(flat, 1, generator=generator)[:, 0]
    return out.reshape(probs.shape[:-1])
