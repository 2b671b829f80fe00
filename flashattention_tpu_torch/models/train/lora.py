"""LoRA fine-tuning on one device: adapters merged just in time, per layer.

Counterpart of ``flashattention_tpu/models/train/lora.py`` without a mesh:
:func:`init_lora` (:16), :func:`merge_lora` (:58) and
:func:`make_train_step_lora` (:75).  A LoRA tree is a list, one entry per
layer, of ``{target: {"a": A (d_in, r), "b": B (r, d_out)}}``; the adapted
weight is ``w + (alpha / r) A @ B``.  The training step merges each layer's
targets inside the (checkpointed) layer through ``forward_logits``'
``layer_transform``, so the merged weight exists one layer at a time and
never as a second parameter tree; only the adapters take gradients, and the
base is never written.  ``lora_param_specs`` (:42), the tensor-parallel
sharding of the adapters, comes with the multi-device slice.
"""

from __future__ import annotations

import functools

import torch

from flashattention_tpu_torch.models.train.common import _make_step, leaves, token_nll, with_leaves
from flashattention_tpu_torch.models.train.forward import forward_logits
from flashattention_tpu_torch.models.train.steps_core import _on_device
from flashattention_tpu_torch.models.transformer import ModelConfig
from flashattention_tpu_torch.ops.flash import check_dropout

__all__ = ["init_lora", "make_train_step_lora", "merge_lora"]


def init_lora(gen_or_seed, params, rank: int = 8, targets=("wq", "wv")) -> list:
    """Per-layer adapters for ``targets``: A ~ N(0, 1/d_in), drawn in
    float32 and cast to the weight's dtype, and B = 0, so that the adapted
    model is the base at first.  ``gen_or_seed`` is a ``torch.Generator``
    on the parameters' device, or a seed for one.  Every target must be a
    2-D weight (an MoE expert stack is not): ``ValueError`` otherwise."""
    for layer in params["layers"]:
        for t in targets:
            if layer[t].dim() != 2:
                raise ValueError(f"LoRA target {t!r} must be 2-D, got {tuple(layer[t].shape)}")
    dev = params["embed"].device
    gen = gen_or_seed
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=dev).manual_seed(int(gen_or_seed))
    out = []
    for layer in params["layers"]:
        adapters = {}
        for t in targets:
            w = layer[t]
            d_in, d_out = w.shape
            a = torch.randn((d_in, rank), generator=gen, device=dev, dtype=torch.float32)
            adapters[t] = {"a": (a * d_in**-0.5).to(w.dtype),
                           "b": torch.zeros((rank, d_out), dtype=w.dtype, device=dev)}
        out.append(adapters)
    return out


def _merge_layer(layer, alpha):
    """A layer's tree with its ``"lora"`` adapters merged into their targets,
    ``w + (A @ B) * (alpha / r)``, the product rounded to w's dtype before
    the scale, as the JAX package rounds it (lora.py:67-70, :108-116)."""
    out = {k: v for k, v in layer.items() if k != "lora"}
    for t, ab in layer["lora"].items():
        r = ab["a"].shape[-1]
        out[t] = out[t] + (ab["a"] @ ab["b"]).to(out[t].dtype) * (alpha / r)
    return out


def merge_lora(params, lora, alpha: float = 16.0) -> dict:
    """The model with every adapter merged into its target, for serving: a
    new tree whose other tensors are the base's own."""
    layers = [_merge_layer({**layer, "lora": adapters}, alpha)
              for layer, adapters in zip(params["layers"], lora)]
    return {**params, "layers": layers}


def _lora_logits(base, lora, tokens, cfg: ModelConfig, *, alpha: float, **kw):
    """``forward_logits`` of the base with each layer's adapters merged
    inside the layer (``layer_transform``); ``kw`` go to it (``remat``,
    ``attn_dropout``, ``seed``)."""
    tree = {**base, "layers": [{**layer, "lora": adapters}
                               for layer, adapters in zip(base["layers"], lora)]}
    return forward_logits(tree, tokens, cfg,
                          layer_transform=functools.partial(_merge_layer, alpha=alpha), **kw)


def make_train_step_lora(cfg: ModelConfig, *, alpha: float = 16.0, lr: float = 1e-3,
                         optimizer=None, attn_dropout: float | None = None,
                         remat: bool = False, device=None):
    """``step(base, lora, tokens, seed=0) -> (loss, lora)``: one SGD step
    (``a - lr * g`` in the adapter's dtype) of next-token cross-entropy
    that trains the adapters alone; or with ``optimizer`` (as in
    ``make_train_step_optax``; ``opt_state = train.init_opt_state(
    optimizer, lora)``) ``step(base, lora, opt_state, tokens, seed=0) ->
    (loss, lora, opt_state)``.

    The adapters are updated in place and returned; the base is only read.
    ``attn_dropout`` and ``seed`` as in ``make_train_step`` (the seed folds
    as the JAX step's on a 1x1 mesh, ``forward.dropout_seeds``);
    ``remat`` recomputes each layer, its merge included, in the backward.
    The step runs on the card unless ``device="cpu"``.
    """
    attn_dropout = check_dropout(attn_dropout)

    def grad_call(lora, base, tokens, seed=0):
        flat = [t.detach().requires_grad_() for t in leaves(lora)]
        logits = _lora_logits(base, with_leaves(lora, flat), tokens, cfg, alpha=alpha,
                              remat=remat, attn_dropout=attn_dropout, seed=seed)
        loss = token_nll(logits[:, :-1], tokens[:, 1:]).mean()
        return loss.detach(), torch.autograd.grad(loss, flat)

    inner = _make_step(grad_call, lr, optimizer)
    if optimizer is None:
        def step(base, lora, *args):
            return inner(lora, base, *args)
    else:
        def step(base, lora, opt_state, *args):
            return inner(lora, opt_state, base, *args)
    return _on_device(step, device, n_state=1 if optimizer is None else 2)
