"""Benchmark and correctness harness against the eager reference.

Counterpart of the root ``bench_flashattention.py``: the reference harness's
flags (--batch_size, --seq_len, --masking) and contract: (B*H, S, d) inputs
with heads folded into the batch, the eager reference
(``ops.reference.attention_reference``, plain PyTorch) and the fused kernel
(``ops.dispatch.attention``) run and timed, gated by allclose at atol 1e-1.
n_head = 8, d = 64 and scale = 1.0 by default, as there.  ``--profile DIR``
writes a ``torch.profiler`` Chrome trace of one kernel call into DIR.
Prints JSON rows with TFLOP/s and, on the card, the roofline fraction over
its peak: the reference's over the card's peak for the dtype, the fused
kernel's over the ceiling of the form it runs (``form``; float32 inputs take
the JAX default precision, ``"bf16_3x"``, on the float32 tensor-core form at
d = 64 and 128: ``utils.benchit.attention_ceiling_tflops``).

    python -m flashattention_tpu_torch.cli.bench_flashattention [--device cpu] ...
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from flashattention_tpu_torch.cli import add_device, card_of, make_random, parse


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device(p)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--seq_len", type=int, default=1024)
    p.add_argument("--masking", action="store_true", help="causal masking")
    p.add_argument("--n_head", type=int, default=8)
    p.add_argument("--d", type=int, default=64)
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default="float32")
    p.add_argument("--scale", type=float, default=1.0,
                   help="score scale; reference parity is 1.0 (no 1/sqrt(d))")
    p.add_argument("--repeats", type=int, default=9)
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of one kernel call into DIR")
    args, dev = parse(p, argv)

    from flashattention_tpu_torch.ops.dispatch import attention
    from flashattention_tpu_torch.ops.reference import attention_reference
    from flashattention_tpu_torch.ops.dispatch import padded_head_dim
    from flashattention_tpu_torch.ops.flash import kernel_form, resolve_precision
    from flashattention_tpu_torch.utils.benchit import (attention_ceiling_tflops, attention_flops,
                                                        chip_peak, devtime_ms)

    dtype = torch.float32 if args.dtype == "float32" else torch.bfloat16
    bh = args.batch_size * args.n_head
    q, k, v = (make_random(i, (bh, args.seq_len, args.d), dtype, dev) for i in range(3))

    def ours(q, k, v):
        return attention(q, k, v, causal=args.masking, scale=args.scale)

    def ref(q, k, v):
        return attention_reference(q, k, v, causal=args.masking, scale=args.scale)

    out, want = ours(q, k, v).float(), ref(q, k, v).float()
    ok = bool(torch.allclose(out, want, rtol=0, atol=1e-1))
    max_err = float((out - want).abs().max())
    flops = attention_flops(bh, args.seq_len, args.seq_len, args.d, causal=args.masking)
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        with profile(activities=acts) as prof:
            ours(q, k, v)
            if dev.type == "cuda":
                torch.cuda.synchronize()
        os.makedirs(args.profile, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile, "trace.json"))
        print(json.dumps({"profile_dir": args.profile}))
    ms_ours = devtime_ms(ours, (q, k, v), n_hi=args.repeats, trials=3)
    ms_ref = devtime_ms(ref, (q, k, v), n_hi=args.repeats, trials=3)
    peak = chip_peak(16 if dtype == torch.bfloat16 else 32, device=dev)
    mode, d_run = resolve_precision(None, dtype), padded_head_dim(args.d)
    form = kernel_form("flash_fwd", dtype, d_run, precision=mode)
    ceiling = attention_ceiling_tflops(d_run, mode, device=dev)
    card = card_of(dev)
    for name, ms in (("torch_reference", ms_ref), ("flash_cuda", ms_ours)):
        row = {
            "impl": name,
            "batch_size": args.batch_size,
            "n_head": args.n_head,
            "seq_len": args.seq_len,
            "d": args.d,
            "dtype": args.dtype,
            "causal": args.masking,
            "ms": round(ms, 3),
            "tflops_per_s": round(flops / ms / 1e9, 2),
            "card": card,
        }
        if name == "flash_cuda":
            row["form"] = f"{form}, {mode}"
        top = ceiling if name == "flash_cuda" else peak and peak[0]
        if top:
            row["roofline_frac"] = round(flops / ms / 1e9 / top, 3)
        print(json.dumps(row))
    print(json.dumps({"speedup_vs_reference": round(ms_ref / ms_ours, 2),
                      "max_abs_err": max_err, "allclose_atol_1e-1": ok}))
    if not ok:
        print("attention output incorrect (atol=1e-1 gate)")
        raise SystemExit(1)
    print("attention output correct")


if __name__ == "__main__":
    main()
