"""Transformer forward for training, and its loss-and-gradients function.

Counterpart of ``flashattention_tpu/models/train/forward.py`` on one device
(``tp_size = 1``, so the f/g collectives are identities): token lookup,
RMSNorm, RoPE (per document for packed rows), GQA folded into the rows of
each KV head (g-major), attention through the differentiable
:func:`~flashattention_tpu_torch.ops.backward.attention_vjp`, SwiGLU, the
final norm and the LM head.  ``remat`` recomputes each layer in the backward
(``torch.utils.checkpoint``, non-reentrant), so the flash forward kernel
runs twice per layer and step.  Attention dropout folds the step's seed as
the JAX package's one-device mesh does, and each layer's index into it, so
each layer draws its own keep bits, the same in a recomputed layer.
``layer_transform`` (LoRA's per-layer merge) and ``compute_dtype`` (mixed
precision: each layer's weights cast just in time) run inside the layer, in
that order, so that under ``remat`` no merged or cast weight outlives its
layer.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from flashattention_tpu_torch.models.train.common import (
    _cast_floats,
    leaves,
    packed_positions,
    token_nll,
    torch_dtype,
    with_leaves,
)
from flashattention_tpu_torch.models.transformer import ModelConfig, _lookup, _mlp, _rmsnorm, _rope
from flashattention_tpu_torch.ops.backward import attention_vjp
from flashattention_tpu_torch.ops.flash import check_dropout, wrap_int32

__all__ = ["dropout_seeds", "forward_logits", "make_grad_fn"]

_GOLDEN = -1640531527  # the JAX steps' odd seed multiplier, 0x9E3779B9 as an int32


def dropout_seeds(seed, num_layers: int) -> list[int]:
    """Each layer's dropout seed for a step's ``seed``, with the int32 wrap
    of every operation written out: the step folds its data- and
    tensor-parallel ranks (0 on one device) into ``seed * GOLDEN``
    (forward.py:241-251), and layer ``li`` takes ``fold * GOLDEN + li + 1``
    (:126-129)."""
    fold = wrap_int32(wrap_int32(seed) * _GOLDEN + 0 * 7919 + 0 * 104729)
    return [wrap_int32(fold * _GOLDEN + li + 1) for li in range(num_layers)]


def forward_logits(params, tokens, cfg: ModelConfig, *, segment_ids=None, remat=False,
                   attn_dropout=None, seed=0, layer_transform=None, compute_dtype=None):
    """Logits ``(B, S, V)`` of ``tokens`` ``(B, S)`` (forward.py:16).

    With ``segment_ids`` (B, S), each row packs several documents: RoPE
    positions restart per document and attention stays within it (segment
    ids folded like the q rows, g-major per KV head; forward.py:73-86).
    ``attn_dropout`` drops attention weights at that rate, layer by layer
    from :func:`dropout_seeds` of ``seed`` (an int: no host sync).
    ``layer_transform`` maps each layer's tree to the one it computes with,
    inside the (checkpointed) layer.  ``compute_dtype`` (a ``torch.dtype``
    or its JAX name) is mixed precision (forward.py:69-72, :91-92,
    :134-136): the embedding rows after the lookup, each layer's floating
    leaves after ``layer_transform``, and the final norm and ``lm_head`` are
    cast to it; the masters keep their dtype, and so do their gradients.
    """
    b, s = tokens.shape
    hq, hkv, g, hd = cfg.num_q_heads, cfg.num_kv_heads, cfg.group_size, cfg.head_dim
    if compute_dtype is not None:
        compute_dtype = torch_dtype(compute_dtype)
    x = _lookup(params["embed"], tokens)
    if compute_dtype is not None:
        x = x.to(compute_dtype)  # the rows, never the table
    if segment_ids is not None:
        positions = packed_positions(segment_ids)
        seg = segment_ids.to(torch.int32)
        seg_qf = seg[:, None, None, :].expand(b, hkv, g, s).reshape(b * hkv, g * s)
        seg_kvf = seg[:, None, :].expand(b, hkv, s).reshape(b * hkv, s)
    else:
        positions = torch.arange(s, device=tokens.device).expand(b, s)
        seg_qf = seg_kvf = None

    layers = params["layers"]
    attn_dropout = check_dropout(attn_dropout)
    seeds = dropout_seeds(seed, len(layers)) if attn_dropout else [0] * len(layers)

    def one_layer(x, layer, lseed):
        if layer_transform is not None:
            layer = layer_transform(layer)
        if compute_dtype is not None:
            layer = _cast_floats(layer, compute_dtype)
        h = _rmsnorm(x, layer["attn_norm"])
        q = (h @ layer["wq"]).reshape(b, s, hq, hd)
        k = (h @ layer["wk"]).reshape(b, s, hkv, hd)
        v = (h @ layer["wv"]).reshape(b, s, hkv, hd)
        q = _rope(q, positions, cfg.rope_theta)
        k = _rope(k, positions, cfg.rope_theta)
        # Native GQA (forward.py:99-110): the G query heads of each KV head
        # (h = kvh * G + g) fold into its rows, so no K/V head is repeated.
        qf = q.transpose(1, 2).reshape(b * hkv, g * s, hd)
        kf = k.transpose(1, 2).reshape(b * hkv, s, hd)
        vf = v.transpose(1, 2).reshape(b * hkv, s, hd)
        o = attention_vjp(
            qf, kf, vf, True, hd**-0.5, None, None, None, s if g > 1 else None,
            cfg.sliding_window, cfg.logit_softcap, attn_dropout, lseed, seg_qf, seg_kvf,
        )
        o = o.reshape(b, hq, s, hd).transpose(1, 2).reshape(b, s, hq * hd)
        x = x + o @ layer["wo"]
        return x + _mlp(_rmsnorm(x, layer["mlp_norm"]), layer, cfg.experts_per_token)

    for layer, lseed in zip(layers, seeds):
        if remat:
            x = checkpoint(one_layer, x, layer, lseed, use_reentrant=False)
        else:
            x = one_layer(x, layer, lseed)
    fn_w, head_w = params["final_norm"], params["lm_head"]
    if compute_dtype is not None:
        fn_w, head_w = fn_w.to(compute_dtype), head_w.to(compute_dtype)
    return _rmsnorm(x, fn_w) @ head_w


def make_grad_fn(cfg: ModelConfig, *, packed=False, remat=False, attn_dropout=None,
                 compute_dtype=None):
    """``(params, tokens[, seed]) -> (loss, grads)``, or with ``packed``
    ``(params, tokens, segment_ids[, seed]) -> (loss, grads)``; the stand-in
    for ``_make_grad_map`` (forward.py:198) on one device.  ``seed`` (an
    int, default 0) drives ``attn_dropout``.

    The loss is the mean next-token NLL (forward.py:289-300), or for packed
    rows the sum over valid next-token targets (same document, not padding)
    over their count (:260-284).  ``grads`` follow
    :func:`~flashattention_tpu_torch.models.train.common.leaves` order, in
    the parameters' dtypes; ``compute_dtype`` as in :func:`forward_logits`.
    """
    attn_dropout = check_dropout(attn_dropout)

    def loss_of(tree, tokens, segment_ids, seed):
        logits = forward_logits(tree, tokens, cfg, segment_ids=segment_ids, remat=remat,
                                attn_dropout=attn_dropout, seed=seed,
                                compute_dtype=compute_dtype)
        nll = token_nll(logits[:, :-1], tokens[:, 1:])
        if segment_ids is None:
            return nll.mean()
        valid = (segment_ids[:, 1:] == segment_ids[:, :-1]) & (segment_ids[:, 1:] >= 0)
        return torch.where(valid, nll, 0.0).sum() / valid.sum().clamp(min=1)

    def grad_fn(params, tokens, *rest):
        segment_ids, rest = (rest[0], rest[1:]) if packed else (None, rest)
        seed = rest[0] if rest else 0
        flat = [p.detach().requires_grad_() for p in leaves(params)]
        loss = loss_of(with_leaves(params, flat), tokens, segment_ids, seed)
        grads = torch.autograd.grad(loss, flat)
        return loss.detach(), grads

    return grad_fn
