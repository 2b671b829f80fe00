#!/usr/bin/env python3
"""Compare flash_fwd and the backward kernels between checkouts of the
port, on one card.

    python3 torch_tools/fwd_bwd_ab.py ROOT [ROOT ...]

Each ROOT is a checkout of the repo: this one (``.``), or another commit
unpacked with ``git archive`` into an ignored directory such as ``build/``.
Each runs in a process of its own, in the order given, so that an order
like "parent change change parent" cancels drift between runs.  In each,
ROOT's own ``flashattention_tpu_torch`` builds flash_fwd and the backward
kernels and times, in bfloat16 with random inputs from seed 0: flash_fwd at
its prefill check shape (B = 4, 32 heads, S = 1024, d = 128, causal);
flash_bwd, flash_bwd_dq and flash_bwd_dkv at the training layer (B = 8, 8
KV heads x G = 4, S = 2048, d = 128, causal), each in the form ROOT picks
(since the pair's tensor-core forms, the pair's is theirs: the fused form
beside the pair, the counterpart of the JAX package's
``scripts/probe_fused_bwd.py``); and the pair at the packed layer (the same
with segment ids from packed documents, ``chip_smoke._packed_ids``) in the
form ROOT picks and in the scalar form (``ops.flash.scalar_forms``); and
flash_fwd, flash_bwd_dq and flash_bwd_dkv at ``chip_smoke.block_mask_checks``'
shape (B = 4, 32 heads, S = 4096, d = 128, not causal) with no mask and under
each of ``chip_smoke.BM_MASKS`` (prefix-LM, 512-token documents, strided),
each in the form ROOT picks (``kernel_form``: before the tensor-core forms
took block masks, the masked calls ran the scalar kernels); and the
forward's tensor-core 8-bit form (bf16 q over int8 K/V) at the prefill
shape.  It reads each library's ptxas registers and spill bytes for the
timed instantiations without dropout or block masks, and for every d = 128
instantiation of the two 8-bit tensor-core forms' libraries (the libraries
ROOT has, when this process built them).  One JSON line per ROOT, and all of them in
``chiprun_out/fwd_bwd_ab.json``.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

# The instantiations timed: bf16, head_dim 128, neither window nor softcap
# (ROOT's own chip_smoke._ptxas labels; the extra form's flag is absent here).
PTXAS = {
    "flash_fwd": "flash_fwd_kernel<bf16,128>",
    "flash_bwd": "flash_bwd_kernel<bf16,128>",
    "flash_bwd_dq": "flash_bwd_dq_kernel<bf16,128>",
    "flash_bwd_dkv": "flash_bwd_dkv_kernel<bf16,128>",
    "flash_fwd_tc": "flash_fwd_tc_kernel<128>",
    "flash_bwd_tc": "flash_bwd_tc_kernel<128>",
    "flash_bwd_dq_tc": "flash_bwd_dq_tc_kernel<128>",
    "flash_bwd_dkv_tc": "flash_bwd_tc_kernel<128,pair>",
}
# The 8-bit tensor-core forms' libraries: each d = 128 instantiation.
PTXAS_8BIT = ("flash_fwd_tc_quant", "paged_prefill_tc_quant")


def one(root: str) -> dict:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from flashattention_tpu_torch.ops import backward, flash, kernels
    from flashattention_tpu_torch.utils import benchit

    for mod in (cs, flash, backward):
        if not os.path.abspath(mod.__file__).startswith(root + os.sep):
            raise RuntimeError(f"{mod.__name__} came from {mod.__file__}, not {root}")
    t0 = time.perf_counter()
    built = kernels.build_all([n for n in (*PTXAS, *PTXAS_8BIT) if n in kernels.KERNELS])
    build_s = time.perf_counter() - t0
    ptxas = {}
    for name, info in built.items():
        for rec in cs._ptxas(info["log"]):
            regs = {k: rec.get(k) for k in ("registers", "spill_stores", "spill_loads")}
            if name in PTXAS_8BIT and "<128" in rec["kernel"]:
                ptxas.setdefault(name, {})[rec["kernel"]] = regs
            elif rec["kernel"] == PTXAS.get(name):
                ptxas[name] = regs
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(shape, mult=1.0):
        return (mult * torch.randn(shape, generator=gen, device="cuda")).to(torch.bfloat16)

    q, k, v = rand((4 * 32, 1024, 128)), rand((4 * 32, 1024, 128)), rand((4 * 32, 1024, 128))
    fwd_ms = benchit.cuda_time_ms(lambda: flash.flash_attention(q, k, v, causal=True,
                                                                scale=128**-0.5))
    (k8, ks), (v8, vs) = (cs._kv(gen, (4 * 32, 1024, 128), None, "int8") for _ in range(2))
    fwd_q8_ms = benchit.cuda_time_ms(lambda: flash.flash_attention(
        q, k8, v8, ks, vs, causal=True, scale=128**-0.5))
    bh, s, g = 8 * 8, 2048, 4
    q, k, v = rand((bh, g * s, 128)), rand((bh, s, 128)), rand((bh, s, 128))
    do = rand((bh, g * s, 128), 0.25)
    kw = dict(causal=True, scale=128**-0.5, q_seq_len=s)
    o, l, m = flash.flash_attention(q, k, v, save_residuals=True, **kw)
    lse = m + torch.log(l)
    di = (o.float() * do.float()).sum(dim=-1)
    times = {
        "flash_bwd": lambda: backward.flash_attention_bwd(q, k, v, o, lse, do, fused=True, **kw),
        "flash_bwd_dq": lambda: backward.dq_kernel(q, k, v, do, lse, di, **kw),
        "flash_bwd_dkv": lambda: backward.dkv_kernel(q, k, v, do, lse, di, **kw),
    }
    out = {"root": root, "card": benchit.card_info(), "build_s": build_s,
           "flash_fwd_ms": fwd_ms, "flash_fwd_int8_kv_ms": fwd_q8_ms,
           "pair_form": flash.kernel_form("flash_bwd_dq", torch.bfloat16, 128)}
    out.update({f"{n}_ms": benchit.cuda_time_ms(fn, warmup=1, iters=5) for n, fn in times.items()})
    # The pair at the packed layer, in ROOT's form and in the scalar one.
    from flashattention_tpu_torch.utils import packing

    _, ids = cs._packed_ids(packing, 5, 8, s)
    seg_q, seg_kv = cs._fold_ids(torch.tensor(ids, device="cuda"), 8, g)
    segs = dict(q_segment_ids=seg_q, kv_segment_ids=seg_kv)
    o, l, m = flash.flash_attention(q, k, v, save_residuals=True, **kw, **segs)
    lse = m + torch.log(torch.where(l == 0, 1.0, l))
    di = (o.float() * do.float()).sum(dim=-1)
    packed = {
        "packed_dq": lambda: backward.dq_kernel(q, k, v, do, lse, di, **kw, **segs),
        "packed_dkv": lambda: backward.dkv_kernel(q, k, v, do, lse, di, **kw, **segs),
    }
    out.update({f"{n}_ms": benchit.cuda_time_ms(fn, warmup=1, iters=5) for n, fn in packed.items()})
    with flash.scalar_forms():
        out.update({f"{n}_scalar_ms": benchit.cuda_time_ms(fn, warmup=1, iters=5)
                    for n, fn in packed.items()})
    # Block masks at S = 4096, and no mask on the same inputs.
    del q, k, v, do, o, l, m, lse, di
    bh, s, d = 4 * 32, 4096, 128
    q, k, v, do = rand((bh, s, d)), rand((bh, s, d)), rand((bh, s, d)), rand((bh, s, d), 0.25)
    base = dict(causal=False, scale=d**-0.5)
    o, l, m = flash.flash_attention(q, k, v, save_residuals=True, **base)
    lse = m + torch.log(l)
    di = (o.float() * do.float()).sum(dim=-1)
    out["block_mask_form"] = flash.kernel_form("flash_fwd", torch.bfloat16, d, block_mask=True)
    masks = {"no_mask": None, **{n: flash.BlockMask.from_mask_fn(fn, s, s)
                                 for n, fn in cs.BM_MASKS.items()}}
    for name, bm in masks.items():
        kw = dict(base, block_mask=bm)
        calls = {"flash_fwd": lambda: flash.flash_attention(q, k, v, **kw),
                 "flash_bwd_dq": lambda: backward.dq_kernel(q, k, v, do, lse, di, **kw),
                 "flash_bwd_dkv": lambda: backward.dkv_kernel(q, k, v, do, lse, di, **kw)}
        out[f"s4096_{name}_ms"] = {n: benchit.cuda_time_ms(fn, warmup=1, iters=5)
                                   for n, fn in calls.items()}
    out["ptxas"] = ptxas
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(one(args.one)), flush=True)
        return 0
    results, failed = [], False
    for root in args.roots:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root],
                              stdout=subprocess.PIPE, text=True)
        lines = proc.stdout.strip().splitlines()
        if proc.returncode != 0 or not lines:
            print(f"fwd_bwd_ab: {root} failed (exit {proc.returncode})", file=sys.stderr)
            failed = True
            continue
        rec = json.loads(lines[-1])
        rec["order"] = len(results)
        results.append(rec)
        print(json.dumps(rec), flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "fwd_bwd_ab.json"), "w") as fh:
        json.dump(results, fh, indent=1)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
