#!/usr/bin/env python3
"""Check the fused backward's float32 form at head_dim 256 and time it at
Gemma-2-9B's training layer, on one card.

    python3 torch_tools/fused_f32_gemma.py [--check] [--forms scalar tc_f32]

Builds the fused backward's libraries (``flash_bwd_tc_f32[_extra]``, the
scalar ``flash_bwd[_extra]``) and prints the registers and spill bytes
ptxas reports for each instantiation of the float32 form.  With
``--check`` it then runs ``chip_smoke.py``'s float32 training checks at d =
256 alone (``_f32_train_hold`` over ``F32_TRAIN_CASES``, the NaN-poison and
keep-bit checks, "bf16_3x" and "bf16") and stops with exit code 1 if one
fails.  Then, at chip_smoke's ``gemma2_d256_w4096_cap50`` layer (B = 1, 8 KV
heads x G = 2, S = 8192, d = 256, causal, window 4096, softcap 50; float32
q, k, v and dO from seed 0, dO x 1/4), for each form (``scalar``: the exact
scalar kernel under ``ops.flash.scalar_forms``; ``tc_f32``: the float32
form in "bf16_3x", in "bf16" and in "bf16_3x" with dropout at rate 0.1) it
times ``flash_attention_bwd(fused=True)`` (``benchit.cuda_time_ms``: 1
warm-up, 5 calls) with ``chip_smoke._time_bwd``'s bound (the float32 form:
15 bf16 products of 2 d flops a live pair) and prints one JSON line each,
with the card's name and power limit and the launches of each form; the
last line holds them all.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

LIBS = ("flash_bwd_tc_f32", "flash_bwd_tc_f32_extra", "flash_bwd", "flash_bwd_extra")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--check", action="store_true", help="run the d = 256 checks first")
    ap.add_argument("--forms", nargs="*", choices=("scalar", "tc_f32"), default=["scalar"])
    args = ap.parse_args()
    import torch

    import chip_smoke as cs
    from flashattention_tpu_torch.ops import backward, flash, kernels
    from flashattention_tpu_torch.utils import benchit

    if not torch.cuda.is_available():
        print("fused_f32_gemma: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = benchit.card_info()
    built = kernels.build_all(LIBS)
    ptxas = {name: [r for r in cs._ptxas(info["log"]) if "256" in r["kernel"]]
             for name, info in built.items() if name.startswith("flash_bwd_tc_f32")}
    print(json.dumps({"card": card, "ptxas": ptxas}), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    if args.check:
        recs = []
        for mode in cs.F32_TRAIN_MODES:
            for case in cs.F32_TRAIN_CASES:
                q, k, v, do, kw = cs._f32_train_inputs(gen, 256, case)
                recs += cs._f32_train_hold(flash, backward, q, k, v, do, kw, mode,
                                           f"{case}/d256/{mode}")
            recs += cs._f32_train_poison(flash, backward, gen, 256, mode)
            recs.append(cs._f32_keep_bits(flash, backward, gen, 256, mode))
        for rec in recs:
            print(json.dumps(rec), flush=True)
        failed = [r["check"] for r in recs if not r["ok"]]
        print(json.dumps({"checks": len(recs), "failed": failed}), flush=True)
        if failed:
            return 1
    c = dict(cs._GEMMA_LAYER)
    bh, rows, s, d = c["b"] * c["kvh"], c["g"] * c["s_q"], c["s_kv"], c["d"]
    q = torch.randn((bh, rows, d), generator=gen, device="cuda")
    k, v = (torch.randn((bh, s, d), generator=gen, device="cuda") for _ in range(2))
    do = 0.25 * torch.randn((bh, rows, d), generator=gen, device="cuda")
    kw = dict(causal=True, scale=d**-0.5, kv_len=None, q_offset=0, q_seq_len=c["s_q"],
              window=c["window"], logit_softcap=c["cap"])
    o, l, m = flash.flash_attention(q, k, v, save_residuals=True, **kw)
    ins = (q, k, v, o, m + torch.log(torch.where(l == 0, 1.0, l)), do)
    fn = backward.fused_bwd_kernel
    out = {"card": card, "shape": {**c, "dtype": "float32"}, "rows": []}
    for form in args.forms:
        runs = {"scalar": [("float32", {})]}.get(form, [
            ("bf16_3x", {}), ("bf16", dict(precision="bf16")),
            ("bf16_3x_dropout_0.1", dict(dropout_rate=0.1, dropout_seed=cs.DROPOUT_SEED))])
        for label, extra in runs:
            with flash.scalar_forms() if form == "scalar" else contextlib.nullcontext():
                n0 = (fn.launches, fn.launches_tc_f32)
                if extra:
                    row = {"kernel_ms": benchit.cuda_time_ms(
                        lambda: backward.flash_attention_bwd(*ins, fused=True, **kw, **extra),
                        warmup=1, iters=5)}
                else:
                    kname = "flash_bwd_tc_f32" if form == "tc_f32" else "flash_bwd"
                    row = cs._time_bwd(backward, flash, benchit, card, kname, ins, kw, {}, c, {},
                                       "float32")
            row = {"form": form, "mode": label, **row, "launches": fn.launches - n0[0],
                   "tc_f32_launches": fn.launches_tc_f32 - n0[1]}
            out["rows"].append(row)
            print(json.dumps(row), flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
