#!/usr/bin/env python3
"""Compare flash_fwd and the backward kernels without dropout or a block
mask between checkouts of the port, on one card.

    python3 torch_tools/fwd_bwd_ab.py ROOT [ROOT ...]

Each ROOT is a checkout of the repo: this one (``.``), or another commit
unpacked with ``git archive`` into an ignored directory such as ``build/``.
Each runs in a process of its own, in the order given, so that an order
like "parent change change parent" cancels drift between runs.  In each,
ROOT's own ``flashattention_tpu_torch`` builds flash_fwd and the three
backward kernels and times, in bfloat16 with random inputs from seed 0:
flash_fwd at its prefill check shape (B = 4, 32 heads, S = 1024, d = 128,
causal) and flash_bwd, flash_bwd_dq and flash_bwd_dkv at the training layer
(B = 8, 8 KV heads x G = 4, S = 2048, d = 128, causal); and reads each
library's ptxas registers and spill bytes for those instantiations (the
forms without dropout or block masks).  One JSON line per ROOT, and all of
them in ``chiprun_out/fwd_bwd_ab.json``.  Imports nothing of JAX.
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
}


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
    built = kernels.build_all(list(PTXAS))
    build_s = time.perf_counter() - t0
    ptxas = {}
    for name, info in built.items():
        for rec in cs._ptxas(info["log"]):
            if rec["kernel"] == PTXAS[name]:
                ptxas[name] = {k: rec.get(k) for k in ("registers", "spill_stores", "spill_loads")}
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(shape, mult=1.0):
        return (mult * torch.randn(shape, generator=gen, device="cuda")).to(torch.bfloat16)

    q, k, v = rand((4 * 32, 1024, 128)), rand((4 * 32, 1024, 128)), rand((4 * 32, 1024, 128))
    fwd_ms = benchit.cuda_time_ms(lambda: flash.flash_attention(q, k, v, causal=True,
                                                                scale=128**-0.5))
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
           "flash_fwd_ms": fwd_ms}
    out.update({f"{n}_ms": benchit.cuda_time_ms(fn, warmup=1, iters=5) for n, fn in times.items()})
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
