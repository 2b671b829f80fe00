"""Token sampling: temperature, top-k and top-p (nucleus) filtering, and
the sampled accept rule of speculative decoding.

Counterpart of ``flashattention_tpu/ops/sampling.py``.  The random draws
use a ``torch.Generator`` where the JAX package takes a PRNG key; the two
give different numbers from one seed, so the tests compare the
deterministic filtering and the distributions, not the sampled tokens.
"""

from __future__ import annotations

import torch

__all__ = ["filter_logits", "sample_logits", "speculative_accept_sampled"]


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


def speculative_accept_sampled(generator: torch.Generator, drafts, logits, *, temperature, top_k,
                               top_p):
    """Rejection-sampling accept of speculative decoding under sampled
    serving, for deterministic drafts (a point-mass draft distribution):
    draft j is accepted with probability ``p_j(d_j)`` of the filtered
    target; at the first rejection the correction is drawn from ``p_j``
    with ``d_j`` removed and renormalized; when every draft is accepted a
    bonus token is drawn from the last position.  Each emitted token is then
    distributed exactly as a per-token sample from the filtered logits.

    drafts ``(B, k - 1)``; logits ``(B, k, V)`` from ``verify_step``.  Takes
    one uniform draw ``(B, k - 1)`` for the acceptance tests and one
    categorical draw ``(B,)`` for the corrections, from ``generator``.
    Returns ``(n_emitted (B,), emitted (B, k))`` as the greedy
    ``transformer.speculative_accept`` does."""
    b, km1 = drafts.shape
    filt = filter_logits(logits, temperature=temperature, top_k=top_k, top_p=top_p)
    probs = torch.softmax(filt, dim=-1)
    p_d = torch.gather(probs[:, :km1], 2, drafts.long()[..., None])[..., 0]  # (B, k - 1)
    u = torch.rand((b, km1), generator=generator, device=generator.device)
    acc = u < p_d  # a filtered-out draft has p = 0: always rejected
    n_accept = torch.cumprod(acc.long(), dim=1).sum(dim=1)
    # The correction (or bonus) position: the first rejected draft, or k - 1.
    corr_logits = torch.gather(
        filt, 1, n_accept[:, None, None].expand(b, 1, filt.shape[-1]))[:, 0]  # (B, V)
    rejected = n_accept < km1
    d_rej = torch.gather(drafts.long(), 1, n_accept.clamp(max=km1 - 1)[:, None])[:, 0]
    vocab = torch.arange(filt.shape[-1], device=filt.device)[None]
    corr_logits = torch.where(rejected[:, None] & (vocab == d_rej[:, None]), float("-inf"),
                              corr_logits)
    corr = torch.multinomial(torch.softmax(corr_logits, dim=-1), 1, generator=generator)[:, 0]
    idx = torch.arange(km1 + 1, device=drafts.device)[None]
    emitted = torch.where(idx < n_accept[:, None], torch.nn.functional.pad(drafts, (0, 1)),
                          corr[:, None].to(drafts.dtype))
    return n_accept + 1, emitted
