#!/usr/bin/env python3
"""H100 probe: convert 8-bit K/V to bf16 before the products, or multiply natively?

    python3 torch_tools/probe_int8.py [--iters N]

The port of ``scripts/probe_int8_decode.py``'s ``make`` (:35, its
``pallas_call`` :109) for this card, in its three flavors, through
``fa_probe_int8`` of ``flashattention_tpu_torch/csrc/probe_mma.cu``:

- ``bf16``: the tensor-core forward over bf16 K/V (``flash_fwd_tc``'s kernel);
- ``int8cvt``: over int8 K/V converted to bf16 in shared memory, the score
  columns times k_scale and P's columns times v_scale (``flash_fwd_tc_quant``'s
  kernel, the design the serving path runs);
- ``int8mma``: native ``wgmma`` s8 x s8 -> s32, q quantized per row in the
  kernel and p by 1 / 127, V transposed in shared memory each tile (an
  8-bit product reads K-major operands only).

At two shapes: the TPU probe's own (KVH = 8 heads of G = 8 query rows, d =
128, 16 pages of 256 rows: 4096 keys, every row sees every key; payloads
uniform in [-127, 127), every scale 0.01, no softmax scale; bf16 K/V
normal), and ``prefill_mha``'s widths (4 requests x 32 KV heads, a
512-row chunk at the longest request's context, 2048 keys, causal, scale
1/sqrt(128)) in the flat layout.  Each flavor is timed with CUDA events,
the L2 cache flushed before every call (a decode step finds its pages
cold); GB/s-equivalent is the K/V bytes (payload and scales, read once)
over the time, as the TPU probe counts them; each flavor's bound counts
its products at its own type's peak (int8's for ``int8mma``).
``int8mma`` computes another function (8-bit q and p): its max abs error
against ``int8cvt``'s output is reported, and ``int8cvt`` is held to its plain version
(``ops.flash.flash_attention_plain(form="tc")``).  Prints one JSON line with
the card's name and power limit and writes it to
``chiprun_out/probe_int8.json``.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAVORS = ("bf16", "int8cvt", "int8mma")
D = 128
# name -> (BH, rows, S_kv, causal, scale)
SHAPES = {
    "decode_tpu_probe": (8, 8, 16 * 256, False, 1.0),
    "prefill_mha": (4 * 32, 512, 2048, True, D**-0.5),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import torch

    if not torch.cuda.is_available():
        print("probe_int8: no CUDA device", file=sys.stderr)
        return 2
    from flashattention_tpu_torch.ops import flash, kernels
    from flashattention_tpu_torch.utils import benchit

    lib = kernels.library("probe_mma")
    fn = lib.fa_probe_int8
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [i, p, p, p, p, p, p, i, i, i, i, i, i, f, p]
    fn.restype = ctypes.c_int
    card = benchit.card_info()
    name = torch.cuda.get_device_name(0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"probe": "probe_int8", "card": name, "nvidia_smi": card, "shapes": {}}
    ok = True
    for shape, (bh, rows, s_kv, causal, scale) in SHAPES.items():
        q = torch.randn((bh, rows, D), generator=gen, device="cuda").to(torch.bfloat16)
        kb, vb = (torch.randn((bh, s_kv, D), generator=gen, device="cuda").to(torch.bfloat16)
                  for _ in range(2))
        k8, v8 = (torch.randint(-127, 127, (bh, s_kv, D), generator=gen, device="cuda",
                                dtype=torch.int8) for _ in range(2))
        sc = torch.full((bh, s_kv), 0.01, dtype=torch.float32, device="cuda")
        q_offset = s_kv - rows if causal else 0
        outs = {fl: torch.empty_like(q) for fl in FLAVORS}

        def run(fl, outs=outs, q=q, kb=kb, vb=vb, k8=k8, v8=v8, sc=sc, bh=bh, rows=rows,
                s_kv=s_kv, causal=causal, scale=scale, q_offset=q_offset):
            k, v = (kb, vb) if fl == "bf16" else (k8, v8)
            status = fn(FLAVORS.index(fl), q.data_ptr(), k.data_ptr(), v.data_ptr(), sc.data_ptr(),
                        sc.data_ptr(), outs[fl].data_ptr(), bh, rows, s_kv, s_kv, q_offset,
                        int(causal), scale, torch.cuda.current_stream().cuda_stream)
            kernels.check_launch("probe_mma", status, f"fa_probe_int8 {fl}")

        for fl in FLAVORS:
            run(fl)
        torch.cuda.synchronize()
        want = flash.flash_attention_plain(q, k8, v8, causal=causal, scale=scale,
                                           q_offset=q_offset, k_scales=sc, v_scales=sc, form="tc")
        cvt_err = float((outs["int8cvt"].float() - want.float()).abs().max())
        mma_err = float((outs["int8mma"].float() - outs["int8cvt"].float()).abs().max())
        pairs = bh * (rows * s_kv if not causal else sum(
            min(s_kv, q_offset + r + 1) for r in range(rows)))
        rec = {"shape": f"BH={bh} rows={rows} S_kv={s_kv} d={D} "
                        f"{'causal' if causal else 'non-causal'} scale={scale:.6g}",
               "live_pairs": pairs, "out_absmax": float(outs["int8cvt"].float().abs().max()),
               "int8cvt_vs_plain_max_abs_err": cvt_err,
               "int8mma_vs_int8cvt_max_abs_err": mma_err, "flavors": {}}
        ok = ok and cvt_err <= 2e-2 * max(1.0, rec["out_absmax"])
        for fl in FLAVORS:
            ms = benchit.cuda_time_ms(lambda fl=fl: run(fl), warmup=3, iters=args.iters,
                                      flush_bytes=256 << 20)
            elem = 2 if fl == "bf16" else 1
            kv_bytes = 2 * bh * s_kv * (D * elem + (0 if fl == "bf16" else 4))
            rec["flavors"][fl] = {
                "ms": ms, "gb_s_equiv": kv_bytes / (ms * 1e-3) / 1e9, "kv_bytes": kv_bytes,
                **benchit.bound_ms(name, bytes_moved=kv_bytes + 4 * q.numel(),
                                   flops=4 * D * pairs,
                                   dtype="int8" if fl == "int8mma" else "bfloat16"),
            }
        t = {fl: rec["flavors"][fl]["ms"] for fl in FLAVORS}
        rec["int8cvt_over_bf16"] = t["int8cvt"] / t["bf16"]
        rec["int8mma_over_int8cvt"] = t["int8mma"] / t["int8cvt"]
        out["shapes"][shape] = rec
        del q, kb, vb, k8, v8, sc, outs, want
        torch.cuda.empty_cache()
    out["ok"] = ok
    print(json.dumps(out), flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "probe_int8.json"), "w") as fh:
        json.dump(out, fh, indent=1)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
