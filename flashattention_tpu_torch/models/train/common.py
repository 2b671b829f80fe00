"""Shared training-step plumbing for one device.

Counterpart of ``flashattention_tpu/models/train/common.py``: the per-token
NLL (:194), per-document RoPE positions for packed rows (:164), the
floating-leaf cast of mixed precision (:184) and the step tail (:205), plain
SGD or an optimizer, over a model tree or a LoRA adapter tree; and the
Megatron column/row split of the parameters over tensor-parallel ranks
(``param_specs`` :108, ``shard_params`` :153), which sharded serving
(``parallel/serving.py``) runs on.  The Megatron f/g collective pair, the
vocab-parallel NLL and ``vocab_parallel`` come with the multi-device
training slice.
"""

from __future__ import annotations

import functools

import torch

from flashattention_tpu_torch.ops.quant import QuantizedWeight

__all__ = ["adamw", "init_opt_state", "leaves", "packed_positions", "param_specs", "shard_params",
           "split_dim", "token_nll", "torch_dtype"]


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


def torch_dtype(dtype) -> torch.dtype:
    """``dtype`` as a ``torch.dtype``: one already, or the JAX package's
    name of one (``"bfloat16"``, ``"float32"``, ...)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    out = getattr(torch, str(dtype), None)
    if not isinstance(out, torch.dtype):
        raise ValueError(f"not a dtype: {dtype!r}")
    return out


def _cast_floats(tree, dtype):
    """``tree`` (dicts, lists and tensors) with every floating tensor cast
    to ``dtype`` (a ``torch.dtype`` or its JAX name) and every other leaf
    as it is (common.py:184): mixed precision's just-in-time weight cast,
    whose autograd returns the gradient in the master's dtype."""
    dtype = torch_dtype(dtype)
    if isinstance(tree, dict):
        return {k: _cast_floats(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cast_floats(v, dtype) for v in tree)
    if torch.is_tensor(tree) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


def leaves(params) -> list:
    """The tensors of a model tree, in a fixed order; or of a LoRA tree (a
    list of ``{target: {"a": A, "b": B}}``, one per layer), layer by layer,
    each target's A then B."""
    if isinstance(params, list):
        return [ab[k] for adapters in params for ab in adapters.values() for k in ("a", "b")]
    out = [params["embed"], params["final_norm"], params["lm_head"]]
    for layer in params["layers"]:
        out.extend(layer.values())
    return out


def with_leaves(params, new: list):
    """The tree of ``params`` (a model or a LoRA tree) with its tensors
    replaced, in :func:`leaves` order, by ``new``."""
    it = iter(new)
    if isinstance(params, list):
        return [{t: {"a": next(it), "b": next(it)} for t in adapters} for adapters in params]
    tree = {"embed": next(it), "final_norm": next(it), "lm_head": next(it), "layers": []}
    for layer in params["layers"]:
        tree["layers"].append({name: next(it) for name in layer})
    return tree


def param_specs(cfg) -> dict:
    """The Megatron column/row split of every leaf over the tensor-parallel
    ranks: the dim a leaf splits on, or None where every rank holds it
    whole (the JAX ``param_specs``' ``P(None, tp)`` is 1, ``P(tp, None)``
    0, ``P()`` None).  ``wq``, ``wk``, ``wv``, ``w_gate`` and ``w_up``
    split their output dim (columns: each rank computes its own heads and
    its slice of the intermediate), ``wo`` and ``w_down`` their input dim
    (rows: each rank's product is a partial sum that the ranks
    all-reduce).  An MoE layer's expert stacks ``(E, d, f)`` / ``(E, f, d)``
    split their intermediate dim the same way and its router is whole; so
    are the norms, ``embed`` and ``lm_head``."""
    layer = {"attn_norm": None, "wq": 1, "wk": 1, "wv": 1, "wo": 0, "mlp_norm": None}
    if cfg.num_experts is None:
        layer.update(w_gate=1, w_up=1, w_down=0)
    else:
        layer.update(router=None, w_gate=2, w_up=2, w_down=1)
    return {"embed": None, "final_norm": None, "lm_head": None,
            "layers": [dict(layer) for _ in range(cfg.num_layers)]}


def split_dim(x, dim: int | None, index: int, count: int):
    """Part ``index`` of ``count`` equal parts of ``x`` along ``dim`` (a
    contiguous copy; ``x`` itself for ``dim=None``).  A
    :class:`~flashattention_tpu_torch.ops.quant.QuantizedWeight` splits its
    payload, and its per-column scales with it where ``dim`` is the output
    dim."""
    if dim is None:
        return x
    if isinstance(x, QuantizedWeight):
        last = x.payload.dim() - 1
        scales = split_dim(x.scales, x.scales.dim() - 1, index, count) if dim == last else x.scales
        return QuantizedWeight(split_dim(x.payload, dim, index, count), scales, x.ldtype)
    n = x.shape[dim]
    if n % count:
        raise ValueError(f"{count} parts do not divide dim {dim} of {tuple(x.shape)}")
    return x.narrow(dim, index * (n // count), n // count).contiguous()


def shard_params(params, cfg, tp_rank: int, tp_size: int) -> dict:
    """Tensor-parallel rank ``tp_rank``'s parameters out of the whole tree:
    each leaf split by :func:`param_specs` into ``tp_size`` parts (the
    shard that the JAX ``shard_params`` puts on that rank's devices); the
    whole leaves are the same tensors, not copies."""
    specs = param_specs(cfg)
    out = {k: split_dim(params[k], specs[k], tp_rank, tp_size)
           for k in ("embed", "final_norm", "lm_head")}
    out["layers"] = [{name: split_dim(w, spec[name], tp_rank, tp_size) for name, w in layer.items()}
                     for layer, spec in zip(params["layers"], specs["layers"])]
    return out


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4):
    """An AdamW optimizer for :func:`init_opt_state` and the optimizer
    steps, with ``optax.adamw``'s arguments and defaults (its weight decay
    of 1e-4, where ``torch.optim.AdamW`` defaults to 1e-2): a factory of
    ``torch.optim.AdamW`` over a list of tensors."""
    return functools.partial(torch.optim.AdamW, lr=learning_rate, betas=(b1, b2), eps=eps,
                             weight_decay=weight_decay)


def init_opt_state(optimizer, params) -> torch.optim.Optimizer:
    """The optimizer state of ``params`` (``optimizer.init(params)`` in
    optax), a model tree or a LoRA tree: ``optimizer``, a factory such as
    :func:`adamw` or ``functools.partial(torch.optim.SGD, lr=...)``, built
    over the tree's tensors in :func:`leaves` order.  Its ``state_dict()``
    is what a checkpoint stores; ``load_state_dict`` restores it."""
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
