"""Kernel lab: the attention-implementation ladder behind one benchmark CLI.

Counterpart of the root ``lab.py`` (:1-28), the llm.c kernel lab's ladder
(versions selected by argv, validated against a float32 golden, then
timed):

  1  naive-torch    the (S, S) scores materialized in torch (~ llm.c v1)
  2  torch-sdpa     ``scaled_dot_product_attention`` (a yardstick, ~ v3)
  3  naive-cuda     ``flash_attention_naive``, the whole-KV-stripe kernel (B3)
  4  flash          ``flash_attention``, the port's flash kernel (B1)
  5  flash-int8     ``attention_quantized`` over int8 K/V
  6  flash-fp8      ``attention_quantized`` over fp8 (e4m3) K/V
  7  sdpa-flash     SDPA restricted to its FlashAttention backend (the
                    external tuned kernel, a yardstick; it takes 16-bit
                    inputs, so float32 inputs run it in bf16, as the JAX
                    rung's external kernel runs one-pass bf16 products)

Each rung is validated against ``ops.reference``'s float32 golden at the JAX
gate (1e-4 for float32 dense rungs, 5e-2 for bf16 and int8, 2e-1 for fp8,
5e-2 for rung 7).  The card's kernels have one tile shape, so the JAX
``BLOCK_CONFIGS`` sweep runs once and prints the tile it ran (``blocks``).

    python -m flashattention_tpu_torch.cli.lab <kernel_num> [--all] [--device cpu] ...
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from flashattention_tpu_torch.cli import add_device, card_of, make_random, parse


def naive_torch(q, k, v, causal, scale):
    """Materializes the scores matrix (the llm.c v1 baseline), products in
    the operands' dtype."""
    s = torch.einsum("bqd,bkd->bqk", q, k).float() * scale
    if causal:
        mask = torch.ones(s.shape[-2:], dtype=torch.bool, device=s.device).tril()
        s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p.to(q.dtype), v)


def torch_sdpa(q, k, v, causal, scale, flash_only=False):
    """SDPA on (BH, S, d) folded as (BH, 1, S, d); ``flash_only``: its
    FlashAttention backend alone, in bf16."""
    f = torch.nn.functional.scaled_dot_product_attention
    q4, k4, v4 = (x[:, None] for x in (q, k, v))
    if not flash_only:
        return f(q4, k4, v4, is_causal=causal, scale=scale)[:, 0]
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        o = f(*(x.to(torch.bfloat16) for x in (q4, k4, v4)), is_causal=causal, scale=scale)
    return o[:, 0].to(q.dtype)


def build(kernel_num, causal, scale, kq=None, vq=None):
    from flashattention_tpu_torch.ops.flash import flash_attention, flash_attention_naive
    from flashattention_tpu_torch.ops.quant import attention_quantized

    if kernel_num == 1:
        return lambda q, k, v: naive_torch(q, k, v, causal, scale)
    if kernel_num == 2:
        return lambda q, k, v: torch_sdpa(q, k, v, causal, scale)
    if kernel_num == 3:
        return lambda q, k, v: flash_attention_naive(q, k, v, causal=causal, scale=scale)
    if kernel_num == 4:
        return lambda q, k, v: flash_attention(q, k, v, causal=causal, scale=scale)
    if kernel_num in (5, 6):
        return lambda q, k, v: attention_quantized(q, kq, vq, causal=causal, scale=scale)
    if kernel_num == 7:
        return lambda q, k, v: torch_sdpa(q, k, v, causal, scale, flash_only=True)
    raise SystemExit(f"unknown kernel {kernel_num}; choose 1-7")


def _tile(q, kernel_num) -> str:
    """The tile a rung of the port's flash kernel runs: the tensor-core
    form's (128 query rows by its KV tile; float32 inputs in the default
    "bf16_3x" mode: the float32 form's, over two bf16 terms) or the scalar
    kernel's ``BlockSizes``; "auto" for the other rungs."""
    from flashattention_tpu_torch.ops.flash import (TC_F32_KV_TILE, TC_KV_TILE, BlockSizes,
                                                    f32_split, kernel_form)

    if kernel_num not in (4, 5, 6):
        return "auto"
    d = q.shape[-1]
    form = kernel_form("flash_fwd", q.dtype, d, quantized=kernel_num != 4)
    if form == "tc":
        return f"tensor cores: 128 query rows x {TC_KV_TILE[d]} KV rows"
    if form == "tc_f32":
        rows = 64 if f32_split(d, "bf16_3x") else 128
        return f"tensor cores, float32 as bf16_3x: {rows} query rows x {TC_F32_KV_TILE[d]} KV rows"
    return str(BlockSizes())


def run_rung(args, kernel_num, q, k, v, golden, flops, card):
    """Validate and time one rung; True iff it passed its gate."""
    from flashattention_tpu_torch.ops.quant import quantize_kv
    from flashattention_tpu_torch.utils.benchit import devtime_ms

    kq = vq = None
    if kernel_num in (5, 6):
        kq, vq = quantize_kv(k, v, "int8" if kernel_num == 5 else "fp8")
    if kernel_num == 6:
        tol = 2e-1  # e4m3: 3 mantissa bits ~6% relative
    elif kernel_num == 7:
        tol = 5e-2  # the external kernel runs bf16 products
    elif q.dtype == torch.float32 and kernel_num != 5:
        tol = 1e-4
    else:
        tol = 5e-2
    fn = build(kernel_num, args.masking, args.scale, kq, vq)
    err = float((fn(q, k, v).float() - golden).abs().max())
    ok = err <= tol
    ms = devtime_ms(fn, (q, k, v))
    print(json.dumps({
        "kernel": kernel_num,
        "blocks": _tile(q, kernel_num),
        "max_abs_err": err,
        "tol": tol,
        "valid": "OK" if ok else "FAIL",
        "ms": round(ms, 3),
        "tflops_per_s": round(flops / ms / 1e9, 2),
        "card": card,
    }), flush=True)
    return ok


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device(p)
    p.add_argument("kernel_num", type=int, nargs="?", default=4)
    p.add_argument("--all", action="store_true",
                   help="run every ladder rung 1-7 at this config, one JSON line each")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--n_head", type=int, default=16)
    p.add_argument("--seq_len", type=int, default=1024)
    p.add_argument("--d", type=int, default=64)
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default="float32")
    p.add_argument("--masking", action="store_true")
    p.add_argument("--scale", type=float, default=1.0)
    args, dev = parse(p, argv)

    from flashattention_tpu_torch.ops.reference import attention_reference
    from flashattention_tpu_torch.utils.benchit import attention_flops

    dtype = torch.float32 if args.dtype == "float32" else torch.bfloat16
    bh = args.batch * args.n_head
    q, k, v = (make_random(i, (bh, args.seq_len, args.d), dtype, dev) for i in range(3))
    golden = attention_reference(q.float(), k.float(), v.float(), causal=args.masking,
                                 scale=args.scale)
    flops = attention_flops(bh, args.seq_len, args.seq_len, args.d, causal=args.masking)
    card = card_of(dev)
    rungs = range(1, 8) if args.all else (args.kernel_num,)
    ok = all([run_rung(args, kn, q, k, v, golden, flops, card) for kn in rungs])
    if not ok:
        sys.exit(1)


if __name__ == "__main__":
    main()
