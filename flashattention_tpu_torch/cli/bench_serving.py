"""End-to-end serving throughput: the full model decode step, not the kernel.

Counterpart of the root ``bench_serving.py``: times
:func:`models.transformer.decode_loop` (embed, QKV, rope, KV quantize and
scatter, paged attention, projections, MLP, lm_head, the greedy token fed
back; a Python loop with no host sync in it), so the number holds everything
the engine runs per token but its host-side scheduling.

Model: the 7B-class slice, d_model 4096, 32 q / 8 KV heads, d = 128, SwiGLU
intermediate 11008, vocab 32k, bf16, at ``--layers`` layers (default 4, as
the JAX bench, which a v5e's 16 GB bounds; the card holds the published 32:
11.9 GB of bf16 weights beside the cache); the widths are ``WIDTHS``, read
when :func:`main` runs.  One JSON row per (KV dtype, weight dtype): step ms,
decode tokens/s for the batch, per-layer ms, and the weights' and cache's
size.

    python -m flashattention_tpu_torch.cli.bench_serving [--device cpu] [--layers 32] ...
"""

from __future__ import annotations

import argparse
import json

import torch

from flashattention_tpu_torch.cli import add_device, card_of, parse

WIDTHS = dict(vocab_size=32000, d_model=4096, num_q_heads=32, num_kv_heads=8, head_dim=128,
              intermediate=11008)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device(p)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--seq_len", type=int, default=2048, help="context length")
    p.add_argument("--page_size", type=int, default=256)
    p.add_argument("--steps", type=int, default=32, help="loop steps per timing")
    p.add_argument("--kv_dtypes", default="bfloat16,int8")
    p.add_argument("--weight_dtypes", default="bfloat16,int8",
                   help="comma list: bfloat16 (native) and/or int8 (weight-only quantized)")
    args, dev = parse(p, argv)

    from flashattention_tpu_torch.models import transformer
    from flashattention_tpu_torch.models.train.common import leaves
    from flashattention_tpu_torch.ops.quant import QuantizedWeight, quantize_weights
    from flashattention_tpu_torch.utils.benchit import devtime_ms

    cfg = transformer.ModelConfig(num_layers=args.layers, dtype="bfloat16", **WIDTHS)
    b, s, ps = args.batch, args.seq_len, args.page_size
    pps = (s + args.steps) // ps + 1
    num_pages = b * pps + 1
    params = transformer.init_params(0, cfg, device=dev)
    n_param = sum(x.numel() for x in leaves(params))

    page_indices = torch.arange(b * pps, dtype=torch.int32, device=dev).reshape(b, pps)
    tokens = torch.arange(b, dtype=torch.int32, device=dev) % cfg.vocab_size
    positions = torch.full((b,), s, dtype=torch.int32, device=dev)

    variants = {}
    for wname in args.weight_dtypes.split(","):
        variants[wname] = quantize_weights(params) if wname == "int8" else params
    card = card_of(dev)
    for name in args.kv_dtypes.split(","):
        pool_dtype = {"bfloat16": torch.bfloat16, "int8": torch.int8}[name]
        shape = (cfg.num_layers, num_pages, cfg.num_kv_heads, ps, cfg.head_dim)
        kp = torch.zeros(shape, dtype=pool_dtype, device=dev)
        vp = torch.zeros(shape, dtype=pool_dtype, device=dev)
        quant = name == "int8"
        ks = torch.ones(shape[:4], dtype=torch.float32, device=dev) if quant else None
        vs = torch.ones(shape[:4], dtype=torch.float32, device=dev) if quant else None

        def run(tokens, params, kp, vp, ks, vs):
            out = transformer.decode_loop(params, tokens, positions, kp, vp, page_indices,
                                          cfg=cfg, n_steps=args.steps, k_scales=ks, v_scales=vs)
            return out[:, -1] % cfg.vocab_size

        for wname, pvariant in variants.items():
            ms = devtime_ms(run, (tokens, pvariant, kp, vp, ks, vs), n_hi=5,
                            min_window_ms=20.0) / args.steps
            kv_bytes = 2 * b * cfg.num_kv_heads * s * cfg.head_dim * (
                1 if quant else 2) * cfg.num_layers
            w_bytes = sum(t.numel() * t.element_size() for leaf in leaves(pvariant)
                          for t in ((leaf.payload, leaf.scales)
                                    if isinstance(leaf, QuantizedWeight) else (leaf,)))
            print(json.dumps({
                "bench": "decode_loop_e2e",
                "kv_dtype": name,
                "weight_dtype": wname,
                "batch": b,
                "layers": cfg.num_layers,
                "seq_len": s,
                "steps_per_loop": args.steps,
                "step_ms": round(ms, 4),
                "per_layer_ms": round(ms / cfg.num_layers, 4),
                "decode_tokens_per_s": round(b / ms * 1e3),
                "params_M": round(n_param / 1e6),
                "weights_gb": round(w_bytes / 1e9, 2),
                "kv_cache_gb": round(kv_bytes / 1e9, 2),
                "card": card,
            }), flush=True)
        del kp, vp, ks, vs
        if dev.type == "cuda":
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
