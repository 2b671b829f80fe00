#!/usr/bin/env python3
"""How far ``verify_step``'s logits lie from the per-token ``decode_step``
logits on the same cache, by depth and dtype, on one card.

    python3 torch_tools/spec_drift.py [--seed N] [--int8-cache]

Llama-7B's attention width (random weights from --seed), cut to 2, 8 and 32
layers, in bfloat16 and float32 (with ``--int8-cache``: float32 over an int8
cache, as chip_smoke's serve_speculative ``int8_cache`` cell serves it,
paged attention taking q in bf16): four prompts of 100-1000 tokens (the
prompts of chip_smoke's serve_multistep and serve_speculative) are
prefilled into a paged cache; four per-token decode steps then feed each
request its own greedy tokens, and one verify step (k = 4) feeds the same
tokens from the same cache state.  Prints, per (dtype, depth), the largest
and mean |logit difference|, how many of the 16 greedy tokens agree, and the
smallest and median gap between the per-token steps' top two logits: a
greedy token can part where the gap is below the difference.  One JSON line
each, and all of them in ``chiprun_out/spec_drift.json``.  Imports nothing
of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from flashattention_tpu_torch.models import transformer as T  # noqa: E402
from flashattention_tpu_torch.runtime import kvcache  # noqa: E402

K = 4


def drift(params, cfg, prompts, cache_dtype=None) -> dict:
    cache = kvcache.PagedKVCache(kvcache.CacheConfig(
        num_layers=cfg.num_layers, num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
        page_size=256, num_pages=24, dtype=cache_dtype or cfg.dtype))
    scales = (cache.k_scales, cache.v_scales)
    b = len(prompts)
    fed = []
    for i, prompt in enumerate(prompts):
        logits, k, v = T.prefill(params, torch.tensor(prompt[None], device="cuda"), cfg)
        cache.append(i, k[:, 0], v[:, 0])
        fed.append([int(logits[0, -1].float().argmax())])
    start = [cache.length(i) for i in range(b)]
    per_token = []
    for j in range(K):  # each request fed its own greedy tokens
        slots = [cache.reserve_slot(i) for i in range(b)]
        lengths, table = cache.batch_view(list(range(b)), 8)
        logits = T.decode_step(
            params, torch.tensor([f[j] for f in fed], device="cuda"),
            torch.tensor([s + j for s in start], device="cuda"), cache.k_pages, cache.v_pages,
            lengths, table, torch.tensor([p for p, _ in slots]), torch.tensor([s for _, s in slots]),
            cfg, *scales).float()
        per_token.append(logits)
        for i in range(b):
            fed[i].append(int(logits[i].argmax()))
    for i in range(b):
        cache.trim(i, start[i])
    slots = [[cache.reserve_slot(i) for _ in range(K)] for i in range(b)]
    _, table = cache.batch_view(list(range(b)), 8)
    verify = T.verify_step(
        params, torch.tensor([f[:K] for f in fed], device="cuda"), torch.tensor(start, device="cuda"),
        cache.k_pages, cache.v_pages, table, torch.tensor([[p for p, _ in r] for r in slots]),
        torch.tensor([[s for _, s in r] for r in slots]), cfg, *scales).float()
    per_token = torch.stack(per_token, 1)  # (B, K, V)
    diff = (verify - per_token).abs().amax(-1)
    top2 = per_token.topk(2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]
    agree = verify.argmax(-1) == per_token.argmax(-1)
    return {"max_diff": float(diff.max()), "mean_diff": float(diff.mean()),
            "logit_absmax": float(per_token.abs().max()), "agree": int(agree.sum()),
            "of": agree.numel(), "min_gap": float(gap.min()), "median_gap": float(gap.median())}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--int8-cache", action="store_true",
                    help="float32 over an int8 cache only")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("spec_drift: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    lens = np.random.default_rng(args.seed + 51).integers(100, 1001, size=4)
    rng = np.random.default_rng(args.seed + 50)
    prompts = [rng.integers(0, 32000, size=int(n)) for n in lens]
    out = {"card": torch.cuda.get_device_name(0)}
    runs = [("float32", "int8")] if args.int8_cache else [("bfloat16", None), ("float32", None)]
    for dtype, cache_dtype in runs:
        full = dataclasses.replace(T.ModelConfig.llama7b_attention(), num_layers=32, dtype=dtype)
        params = T.init_params(args.seed, full)
        for layers in (2, 8, 32):
            cfg = dataclasses.replace(full, num_layers=layers)
            rec = drift({**params, "layers": params["layers"][:layers]}, cfg, prompts, cache_dtype)
            tag = dtype + (f"_{cache_dtype}_cache" if cache_dtype else "")
            out[f"{tag}_L{layers}"] = rec
            print(json.dumps({"dtype": dtype, "cache": cache_dtype or dtype, "layers": layers,
                              **rec}), flush=True)
            torch.cuda.empty_cache()
        del params
        torch.cuda.empty_cache()
    os.makedirs("chiprun_out", exist_ok=True)
    name = "spec_drift_int8.json" if args.int8_cache else "spec_drift.json"
    with open(os.path.join("chiprun_out", name), "w") as fh:
        json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
