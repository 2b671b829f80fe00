"""Timing on the card and the least time the card could take.

Counterpart of ``flashattention_tpu/utils/benchit.py``: CUDA-event timing in
place of the TPU's chained-loop timer, the same :func:`attention_flops`, and
card peaks chosen by the name ``nvidia-smi`` reports (not the TPU tables).
"""

from __future__ import annotations

import subprocess

import torch

__all__ = [
    "CARD_PEAKS",
    "attention_flops",
    "bound_ms",
    "card_info",
    "card_peaks",
    "cuda_time_ms",
]

# Dense peaks from NVIDIA's data sheets at the full power limit: TFLOP/s by
# operand type, device-memory TB/s.  Keys match `nvidia-smi` names.
CARD_PEAKS = {
    "H100 80GB HBM3": {"bfloat16": 989.0, "float32": 67.0, "tf32": 495.0, "int8": 1979.0,
                       "tb_s": 3.35},
    "H100 SXM": {"bfloat16": 989.0, "float32": 67.0, "tf32": 495.0, "int8": 1979.0, "tb_s": 3.35},
    "H100 PCIe": {"bfloat16": 756.0, "float32": 51.0, "tf32": 378.0, "int8": 1513.0, "tb_s": 2.0},
    "H100 NVL": {"bfloat16": 835.0, "float32": 60.0, "tf32": 417.0, "tb_s": 3.9},
    "H200": {"bfloat16": 989.0, "float32": 67.0, "tf32": 495.0, "tb_s": 4.8},
}


def attention_flops(bh: int, s_q: int, s_kv: int, d: int, *, causal: bool = False) -> int:
    """FLOPs of attention forward: 2 matmuls of 2*S_q*S_kv*d each per (b, h)."""
    f = 4 * bh * s_q * s_kv * d
    return f // 2 if causal else f


def card_info() -> str:
    """``name, power.limit`` of card 0 as ``nvidia-smi`` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def card_peaks(name: str) -> dict:
    """Peak rates of the card called ``name``; raises for a card not in the
    table, so that no bound is ever computed from another card's rates."""
    for key, peaks in CARD_PEAKS.items():
        if key in name:
            return peaks
    raise KeyError(f"no peak rates known for card {name!r}")


def bound_ms(name: str, *, bytes_moved: float, flops: float, dtype: str) -> dict:
    """Least time (ms) the card could take for the work: the larger of the
    bytes over the memory rate (``bytes_ms``) and the flops over the peak
    rate of ``dtype`` ("bfloat16", "float32" or "int8") (``ops_ms``), and which of
    the two bounds it (``bound_by``)."""
    peaks = card_peaks(name)
    t_bytes = bytes_moved / (peaks["tb_s"] * 1e12) * 1e3
    t_ops = flops / (peaks[dtype] * 1e12) * 1e3
    return {
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes_ms": t_bytes,
        "ops_ms": t_ops,
    }


# Device-side wait enqueued before the timed calls: about 50 ms at the H100's
# 1.98 GHz, longer than the host takes to enqueue the calls of one timing.
_SLEEP_CYCLES = 100_000_000


def cuda_time_ms(fn, *args, warmup: int = 3, iters: int = 20, flush_bytes: int = 0) -> float:
    """Mean milliseconds per call of ``fn(*args)`` on the card, from a pair
    of CUDA events around each of ``iters`` calls after ``warmup``.  All
    calls are enqueued behind a device-side sleep and read after one
    synchronise, so the host's time to launch a call (its Python wrapper,
    which a loaded host can slow by tenths of a millisecond) does not show
    between the events as idle device time.  With ``flush_bytes``, a buffer
    that large is rewritten before every call (outside the events) so that
    each call finds the L2 cache cold."""
    flush = torch.empty(flush_bytes // 4, dtype=torch.float32, device="cuda") if flush_bytes else None
    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(iters)]
    torch.cuda._sleep(_SLEEP_CYCLES)
    for start, end in events:
        if flush is not None:
            flush.zero_()
        start.record()
        fn(*args)
        end.record()
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in events) / iters
