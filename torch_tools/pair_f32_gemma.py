#!/usr/bin/env python3
"""Time the two-pass backward pair over float32 at Gemma-2-9B's packed
training layer, on one card.

    python3 torch_tools/pair_f32_gemma.py [--forms scalar tc_f32] [--rates 0 0.1]

The layer is ``chip_smoke.py``'s ``gemma2_packed_w4096_cap50_q8`` case: B =
1, 8 KV heads x G = 2, S = 8192, d = 256, causal, window 4096, softcap 50,
segment ids from documents of 5000, 2100 and 1000 tokens and 92 of padding;
float32 q, k, v and dO from seed 0 (q x 8, dO x 1/32).  For each form
(``scalar``: the exact scalar pair under ``ops.flash.scalar_forms``;
``tc_f32``: the pair in the form ``ops.flash.kernel_form`` picks in the
default "bf16_3x") and each dropout rate, it times ``dq_kernel`` and
``dkv_kernel`` alone (``benchit.cuda_time_ms``: 1 warm-up, 5 calls) and
prints one JSON line with the card's name and power limit, the form each
launched (its launch counters) and the live pairs.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--forms", nargs="+", choices=("scalar", "tc_f32"), default=["scalar"])
    ap.add_argument("--rates", nargs="+", type=float, default=[0.0])
    args = ap.parse_args()
    import contextlib

    import torch

    import chip_smoke as cs
    from flashattention_tpu_torch.ops import backward, flash
    from flashattention_tpu_torch.utils import benchit

    if not torch.cuda.is_available():
        print("pair_f32_gemma: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    c = dict(cs._GEMMA_LAYER, docs=(5000, 2100, 1000))
    bh, rows, s, d = c["b"] * c["kvh"], c["g"] * c["s_q"], c["s_kv"], c["d"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    q = 8.0 * torch.randn((bh, rows, d), generator=gen, device="cuda")
    k, v = (torch.randn((bh, s, d), generator=gen, device="cuda") for _ in range(2))
    do = torch.randn((bh, rows, d), generator=gen, device="cuda") / 32
    ids = torch.full((1, s), -1, dtype=torch.int32, device="cuda")
    start = 0
    for i, n in enumerate(c["docs"]):
        ids[0, start:start + n] = i
        start += n
    seg_q, seg_kv = cs._fold_ids(ids, c["kvh"], c["g"])
    segs = dict(q_segment_ids=seg_q, kv_segment_ids=seg_kv)
    kw = dict(causal=True, scale=d**-0.5, q_seq_len=c["s_q"], window=c["window"],
              logit_softcap=c["cap"])
    o, l, m = flash.flash_attention(q, k, v, save_residuals=True, **kw, **segs)
    lse = m + torch.log(torch.where(l == 0, 1.0, l))
    di = (o * do).sum(dim=-1)
    pairs = cs._live_pairs(flash, bh, rows, s, dict(kw, kv_len=None, q_offset=0), segs)
    out = {"card": benchit.card_info(), "shape": {**c, "dtype": "float32"}, "live_pairs": pairs,
           "rows": []}
    for form in args.forms:
        for rate in args.rates:
            kwr = dict(kw, **(dict(dropout_rate=rate, dropout_seed=cs.DROPOUT_SEED) if rate else {}))
            with flash.scalar_forms() if form == "scalar" else contextlib.nullcontext():
                row = {"form": form, "rate": rate}
                for name, fn in (("dq", backward.dq_kernel), ("dkv", backward.dkv_kernel)):
                    n0 = fn.launches_tc_f32
                    row[f"{name}_ms"] = benchit.cuda_time_ms(
                        lambda: fn(q, k, v, do, lse, di, **kwr, **segs), warmup=1, iters=5)
                    row[f"{name}_tc_f32_launches"] = fn.launches_tc_f32 - n0
            out["rows"].append(row)
            print(json.dumps(row), flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
