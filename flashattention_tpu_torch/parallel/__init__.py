"""Multi-rank serving on ``torch.distributed`` (counterpart of
``flashattention_tpu/parallel``): DP x TP sharded paged attention and decode
step (``serving.py``).  Ring, Ulysses and context parallelism come with a
later slice."""

from flashattention_tpu_torch.parallel.serving import (
    local_shard,
    make_sharded_decode_step,
    make_sharded_paged_attention,
    tp_groups,
)

__all__ = ["local_shard", "make_sharded_decode_step", "make_sharded_paged_attention", "tp_groups"]
