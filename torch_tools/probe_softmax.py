#!/usr/bin/env python3
"""H100 probes of the online softmax's own recurrence, on one card.

    python3 torch_tools/probe_softmax.py [--iters N]

The ports of ``scripts/probe_local_softmax.py``'s ``build`` (:41) and
``scripts/probe_chain.py``'s ``build`` (:40) for this card, at their shape
(BH = 16, S = 8192, d = 64, bf16, non-causal): the kernel of
``flashattention_tpu_torch/csrc/flash_fwd_tc.cuh`` built by
``csrc/probe_mma.cu`` in its probe modes.  Mode 0 is the forward itself;
3 is the "local" softmax (each KV tile exponentiated against its own row
max, its PV part and its sum then rescaled by exp(m_tile - m_next), so that
no exponential waits for the running max); 4 and 5 deal the KV tiles
round-robin to 2 and 4 independent (m, l, O) chains, merged at the end, so
that a tile's rescale waits on the tile 2 or 4 back, not the one before.
Modes 1 (QK^T products and softmax, no PV) and 2 (PV products on a constant
P) give the split of mode 0's time at this shape.  If the softmax stalled on
its recurrence, 3-5 would run faster than 0; if they do not, its time is
the work itself.  Each mode is timed with CUDA events and its output held
against the plain forward (``ops.flash.flash_attention_plain``, float32
p) by max abs error.  Prints one JSON line with the card's name and power
limit and writes it to ``chiprun_out/probe_softmax.json``.  Imports nothing
of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = {0: "whole forward", 1: "QK^T + softmax, no PV", 2: "PV on constant P",
         3: "local softmax (probe_local_softmax)", 4: "2 chains (probe_chain)",
         5: "4 chains (probe_chain)"}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=30)
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import torch

    if not torch.cuda.is_available():
        print("probe_softmax: no CUDA device", file=sys.stderr)
        return 2
    from flashattention_tpu_torch.ops import flash, kernels
    from flashattention_tpu_torch.utils import benchit

    bh, s, d = 16, 8192, 64
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((bh, s, d), generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    o = torch.empty_like(q)
    l = torch.empty((bh, s), dtype=torch.float32, device="cuda")
    m = torch.empty_like(l)
    want = flash.flash_attention_plain(q, k, v, scale=d**-0.5, form="scalar").float()
    lib = kernels.library("probe_mma")
    stream = torch.cuda.current_stream().cuda_stream

    def run(mode):
        status = lib.fa_probe_mma(mode, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                  l.data_ptr(), m.data_ptr(), bh, s, s, d, 0, d**-0.5, stream)
        kernels.check_launch("probe_mma", status, f"mode {mode}")

    pairs = bh * s * s  # live (row, column) pairs, non-causal
    card = torch.cuda.get_device_name(0)
    power = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True).stdout.strip()
    out = {"probe": "probe_softmax", "card": card, "nvidia_smi": power,
           "shape": f"BH={bh} S={s} d={d} non-causal bf16", "live_pairs": pairs, "modes": {}}
    for mode, what in MODES.items():
        run(mode)
        torch.cuda.synchronize()
        err = float((o.float() - want).abs().max()) if mode not in (1, 2) else None
        ms = benchit.cuda_time_ms(lambda: run(mode), warmup=3, iters=args.iters)
        flops = (2 if mode in (1, 2) else 4) * d * pairs
        out["modes"][str(mode)] = {
            "what": what, "ms": ms, "tflop_s": flops / ms / 1e9, "max_abs_err": err,
            **benchit.bound_ms(card, bytes_moved=4 * q.numel() * 2, flops=flops, dtype="bfloat16"),
        }
    t = {mm: out["modes"][str(mm)]["ms"] for mm in MODES}
    out["vs_forward"] = {str(mm): t[mm] / t[0] for mm in (1, 2, 3, 4, 5)}
    print(json.dumps(out), flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "probe_softmax.json"), "w") as fh:
        json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
