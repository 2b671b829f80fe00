#!/usr/bin/env python3
"""H100 probe of the tensor-core forward's two loop bodies, on one card.

    python3 torch_tools/probe_mma.py [--iters N]

The port of ``scripts/probe_mxu.py``'s ``_qk_like`` (:38, the QK^T product
with its exp) and ``_pv_like`` (:100, the PV product) for this card: the
kernel of ``flashattention_tpu_torch/csrc/flash_fwd_tc.cuh`` built by
``csrc/probe_mma.cu`` in three modes at row 1's shape (B = 4, H = 32,
S = 1024, d = 128, causal, bf16): 0 the whole forward, 1 its QK^T products
and softmax alone (masks, exp, the running max and sum; no PV products), 2
its PV products alone on a constant P (no QK^T products, no softmax).  Each
is timed with CUDA events; TFLOP/s counts 2 d flops per live pair for each
product (4 d for the whole kernel).  The modes share the producer's TMA
loads of K and V, so modes 1 + 2 against mode 0 says how much of the
forward's time is products and how much the softmax and masks around
them.  Prints one JSON line with the card's name and power limit and
writes it to ``chiprun_out/probe_mma.json``.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = {0: "whole forward", 1: "QK^T + softmax (qk_like)", 2: "PV on constant P (pv_like)"}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import torch

    if not torch.cuda.is_available():
        print("probe_mma: no CUDA device", file=sys.stderr)
        return 2
    from flashattention_tpu_torch.ops import kernels
    from flashattention_tpu_torch.utils import benchit

    b, h, s, d = 4, 32, 1024, 128
    bh = b * h
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((bh, s, d), generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    o = torch.empty_like(q)
    l = torch.empty((bh, s), dtype=torch.float32, device="cuda")
    m = torch.empty_like(l)
    lib = kernels.library("probe_mma")
    stream = torch.cuda.current_stream().cuda_stream

    def run(mode):
        status = lib.fa_probe_mma(mode, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                  l.data_ptr(), m.data_ptr(), bh, s, s, 1, d**-0.5, stream)
        kernels.check_launch("probe_mma", status, f"mode {mode}")

    pairs = bh * s * (s + 1) // 2  # live (row, column) pairs, causal
    card = torch.cuda.get_device_name(0)
    power = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True).stdout.strip()
    out = {"probe": "probe_mma", "card": card, "nvidia_smi": power,
           "shape": f"B={b} H={h} S={s} d={d} causal bf16", "live_pairs": pairs, "modes": {}}
    for mode, what in MODES.items():
        ms = benchit.cuda_time_ms(lambda: run(mode), warmup=3, iters=args.iters)
        flops = (4 if mode == 0 else 2) * d * pairs
        out["modes"][str(mode)] = {
            "what": what, "ms": ms, "tflop_s": flops / ms / 1e9,
            **benchit.bound_ms(card, bytes_moved=4 * q.numel() * 2, flops=flops, dtype="bfloat16"),
        }
    t = {mm: out["modes"][str(mm)]["ms"] for mm in MODES}
    out["products_share"] = t[2] / t[0]
    out["softmax_share"] = (t[0] - t[2]) / t[0]
    out["qk_softmax_share"] = t[1] / t[0]
    print(json.dumps(out), flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "probe_mma.json"), "w") as fh:
        json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
