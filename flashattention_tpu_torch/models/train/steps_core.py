"""Training steps on one device: plain and packed-sequence SGD.

Counterpart of ``flashattention_tpu/models/train/steps_core.py``
(``make_train_step`` :16, ``make_train_step_packed`` :101) without a mesh:
the data-parallel and tensor-parallel axes, the optax step, vocab-parallel
logits and mixed precision come with later slices.  Where the JAX step
returns new parameters, this one updates the caller's tensors in place
(and returns them).  The steps run on the card unless the caller asks for
the CPU (``device="cpu"``), and refuse parameters or tokens elsewhere.
"""

from __future__ import annotations

from flashattention_tpu_torch.models.train.common import _make_step
from flashattention_tpu_torch.models.train.forward import make_grad_fn
from flashattention_tpu_torch.models.transformer import ModelConfig
from flashattention_tpu_torch.utils.device import resolve_device

__all__ = ["make_train_step", "make_train_step_packed"]


def _on_device(step, device):
    """Check the configuration's device once, and each call's tensors."""
    dev = resolve_device(device)

    def checked(params, tokens, *rest):
        where = {params["embed"].device.type, tokens.device.type}
        where.update(t.device.type for t in rest)
        if where != {dev.type}:
            raise ValueError(f"the step runs on {dev.type}; got tensors on {sorted(where)}")
        return step(params, tokens, *rest)

    return checked


def _check(cfg: ModelConfig, attn_dropout):
    cfg.check_ported()
    if attn_dropout:
        raise NotImplementedError(
            "attention dropout is not ported yet: it comes with the attention-dropout "
            "slice (bit-for-bit keep masks)"
        )


def make_train_step(cfg: ModelConfig, *, lr: float = 1e-3, remat: bool = False,
                    attn_dropout: float | None = None, device=None):
    """``step(params, tokens) -> (loss, params)``: one SGD step of
    next-token causal-LM cross-entropy.

    tokens: (B, S) integer tensor on the parameters' device.  ``remat=True``
    recomputes each layer in the backward: activation memory O(1) in depth,
    the same loss and update.  (The JAX step's ``seed`` argument drives
    attention dropout, which is not ported.)
    """
    _check(cfg, attn_dropout)
    return _on_device(_make_step(make_grad_fn(cfg, remat=remat), lr), device)


def make_train_step_packed(cfg: ModelConfig, *, lr: float = 1e-3, remat: bool = False,
                           attn_dropout: float | None = None, device=None):
    """``step(params, tokens, segment_ids) -> (loss, params)`` over
    packed rows: each row holds several documents marked by ``segment_ids``
    (negative = padding, see :func:`utils.packing.pack_documents`).
    Attention stays within documents, RoPE restarts per document, and the
    loss is the mean over valid next-token targets."""
    _check(cfg, attn_dropout)
    return _on_device(_make_step(make_grad_fn(cfg, packed=True, remat=remat), lr), device)
