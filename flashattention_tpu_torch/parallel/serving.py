"""Sharded decode serving: DP x TP paged attention and the model decode step.

Counterpart of ``flashattention_tpu/parallel/serving.py`` on
``torch.distributed``.  Where the JAX functions are jitted ``shard_map``s
over a (dp, tp) mesh, these return functions that every rank calls with its
own shards, in the same layout:

- **TP over KV heads**: the page pools ``(L, P, KVH, ps, d)`` split their
  KVH axis; every rank runs the paged decode kernel on its local heads for
  its whole batch with no communication at attention time, and the
  row-parallel output products (``wo``, the MLP's ``w_down``) are
  all-reduced over the TP group (Megatron), twice a layer;
- **DP over requests**: the batch, its page table and the pool's *page*
  axis split together, each DP slice owning a private slice of the pool
  whose page ids are local to it.  DP slices never communicate.

Shapes on each rank: q ``(B_local, KVH/tp, G, d)``; pools ``(L, P_local,
KVH/tp, ps, d)``, with scale pools ``(L, P_local, KVH/tp, ps)`` when
quantized; lengths, tokens, positions, write pages and slots
``(B_local,)``; the page table ``(B_local, pps)``.  :func:`local_shard`
cuts a rank's shard out of a global tensor by one of the specs below (the
counterpart of ``jax.device_put`` with a ``NamedSharding``), and
``train.common.shard_params`` its parameters.  The functions run on the
group and the device of the tensors the caller gives them; they choose no
backend and no device.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from flashattention_tpu_torch.models.train.common import split_dim
from flashattention_tpu_torch.models.transformer import ModelConfig, decode_step_impl
from flashattention_tpu_torch.ops.decode import paged_attention

__all__ = [
    "LOGITS_SPEC", "POOL_SPEC", "POOLS_SPEC", "Q_SPEC", "SCALE_SPEC", "SCALES_SPEC", "TABLE_SPEC",
    "VEC_SPEC", "local_shard", "make_sharded_decode_step", "make_sharded_paged_attention",
    "tp_groups",
]

# The split of each tensor, dim by dim: a mesh axis name or None (the JAX
# PartitionSpecs of serving.py:60-64 and :127-130).
Q_SPEC = ("dp", "tp", None, None)  # (B, KVH, G, d)
POOL_SPEC = ("dp", "tp", None, None)  # one layer's (P, KVH, ps, d)
SCALE_SPEC = ("dp", "tp", None)  # one layer's (P, KVH, ps)
POOLS_SPEC = (None, "dp", "tp", None, None)  # (L, P, KVH, ps, d)
SCALES_SPEC = (None, "dp", "tp", None)  # (L, P, KVH, ps)
VEC_SPEC = ("dp",)  # tokens, positions, lengths, write pages and slots
TABLE_SPEC = ("dp", None)  # (B, pps), page ids local to the dp slice
LOGITS_SPEC = ("dp", None)  # (B, V), whole on every TP rank


def local_shard(x: torch.Tensor, spec, coords: dict) -> torch.Tensor:
    """The shard of global tensor ``x`` that a rank holds: along each dim
    whose ``spec`` entry names an axis, part ``index`` of ``size`` equal
    parts, ``coords[axis] = (index, size)`` (a contiguous copy)."""
    for dim, axis in enumerate(spec):
        if axis is not None:
            x = split_dim(x, dim, *coords[axis])
    return x


def tp_groups(dp: int, tp: int):
    """The TP groups of a world of ``dp * tp`` ranks, rank ``i * tp + j``
    being tensor-parallel rank j of DP slice i.  Every rank makes every
    group, as ``torch.distributed.new_group`` requires, on the world's
    backend.  Returns ``(dp index, tp index, this rank's TP group)``."""
    if dist.get_world_size() != dp * tp:
        raise ValueError(f"a world of {dist.get_world_size()} ranks is not dp={dp} x tp={tp}")
    groups = [dist.new_group(list(range(i * tp, (i + 1) * tp))) for i in range(dp)]
    rank = dist.get_rank()
    return rank // tp, rank % tp, groups[rank // tp]


def make_sharded_paged_attention(*, scale: float = 1.0, quantized: bool = False):
    """Paged decode attention on a rank's shards: ``fn(q, k_pages, v_pages,
    lengths, page_indices)`` (with ``quantized=True`` also the two ``(P,
    KVH, ps)`` scale pools, shard like the payload pools) -> the output
    ``(B_local, KVH/tp, G, d)``, sharded like q.  No communication at all."""
    if quantized:

        def attend(q, k_pages, v_pages, lengths, page_indices, k_scales, v_scales):
            return paged_attention(q, k_pages, v_pages, lengths, page_indices,
                                   k_scales_pages=k_scales, v_scales_pages=v_scales, scale=scale)
    else:

        def attend(q, k_pages, v_pages, lengths, page_indices):
            return paged_attention(q, k_pages, v_pages, lengths, page_indices, scale=scale)

    return attend


def make_sharded_decode_step(cfg: ModelConfig, *, tp_group, quantized: bool = False):
    """One decode token for a rank's share of a DP x TP batch:
    ``step(params, tokens, positions, k_pages, v_pages, lengths,
    page_indices, write_pages, write_slots[, k_scales, v_scales]) ->
    logits (B_local, V)``, every tensor the rank's shard, ``params`` its
    ``shard_params``.  The body is the single-device one
    (``transformer.decode_step_impl``) at the TP-local head counts, its two
    row-parallel products a layer all-reduced over ``tp_group`` (None: no
    TP).  The pools (and scale pools) are updated in place, as by
    ``decode_step``; the JAX step donates them and returns new ones.
    Raises ValueError when the group's size does not divide
    ``cfg.num_kv_heads``."""
    tp = 1 if tp_group is None else dist.get_world_size(tp_group)
    if cfg.num_kv_heads % tp:
        raise ValueError(f"tp={tp} must divide num_kv_heads={cfg.num_kv_heads}")
    local_cfg = dataclasses.replace(
        cfg, num_q_heads=cfg.num_q_heads // tp, num_kv_heads=cfg.num_kv_heads // tp)

    @torch.no_grad()
    def step(params, tokens, positions, k_pages, v_pages, lengths, page_indices, write_pages,
             write_slots, k_scales=None, v_scales=None):
        if quantized != (k_scales is not None):
            raise ValueError(f"a step made with quantized={quantized} was "
                             f"{'given' if k_scales is not None else 'not given'} scale pools")
        return decode_step_impl(params, tokens, positions, k_pages, v_pages, lengths,
                                page_indices, write_pages, write_slots, local_cfg, k_scales,
                                v_scales, tp_group=tp_group)

    return step
