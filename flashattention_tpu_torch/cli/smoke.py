"""Standalone smoke and speed harness: deterministic inputs, one timed causal run.

Counterpart of the root ``smoke.py`` (the reference's ``test.cu``): batch 8,
S = 8192, d = 64, Q = K = an iota pattern scaled by 1e-5, V = ones, the
causal kernel, float32.  With V all ones every output element must be
exactly 1.0, so the run checks itself.

    python -m flashattention_tpu_torch.cli.smoke [--batch 8] [--seq_len 8192] [--d 64]
        [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import torch

from flashattention_tpu_torch.cli import add_device, card_of, parse


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device(p)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq_len", type=int, default=8192)
    p.add_argument("--d", type=int, default=64)
    args, dev = parse(p, argv)

    from flashattention_tpu_torch.ops.flash import flash_attention
    from flashattention_tpu_torch.utils.benchit import attention_flops, devtime_ms

    b, s, d = args.batch, args.seq_len, args.d
    qk = (torch.arange(s * d, dtype=torch.float32, device=dev) * 1e-5).reshape(1, s, d)
    q = qk.expand(b, s, d).contiguous()
    k = q
    v = torch.ones((b, s, d), dtype=torch.float32, device=dev)

    def fn(q, k, v):
        return flash_attention(q, k, v, causal=True)

    t0 = time.perf_counter()
    out = fn(q, k, v)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    first = time.perf_counter() - t0
    ms = devtime_ms(fn, (q, k, v))
    max_dev = float((out - 1.0).abs().max())
    flops = attention_flops(b, s, s, d, causal=True)
    print(f"card: {card_of(dev)}")
    print(f"first call (build+run): {first:.3f} s")
    print(f"Time: {ms / 1e3:.6f} s  ({flops / ms / 1e9:.1f} TFLOP/s)")
    print(f"max |out - 1.0| = {max_dev:.2e}")
    if max_dev > 1e-5:
        raise SystemExit("FAIL: output deviates from the analytic result")
    print("PASS")


if __name__ == "__main__":
    main()
