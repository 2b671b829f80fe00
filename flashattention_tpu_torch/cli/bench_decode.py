"""Decode-attention benchmark: tokens/s over a paged KV cache.

Counterpart of the root ``bench_decode.py``.  Decode attention is bound by
the bytes of the KV cache it streams, so each KV dtype's row gives the step
latency, decode tokens/s for the batch, the KV bytes moved over the time,
and ``hbm_frac``: that rate over the card's data-sheet memory rate (as the
JAX bench takes it over the chip's spec, bench_decode.py:97-98), with the
measured rate of a plain stream (``benchit.measured_hbm_gbps``) beside it.
q is made in float32, as the JAX bench makes it, and taken in bf16 over
16- and 8-bit pages, as the Pallas kernel computes there (decode.py:150);
over float32 pages it stays float32.  Each row is held against the dense
float32 oracle at its dtype's tolerance.

    python -m flashattention_tpu_torch.cli.bench_decode [--device cpu] ...
"""

from __future__ import annotations

import argparse
import json

import torch

from flashattention_tpu_torch.cli import add_device, card_of, make_random, parse

KV_DTYPES = ("bfloat16", "float32", "int8", "fp8")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device(p)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--kv_heads", type=int, default=8)
    p.add_argument("--group", type=int, default=4, help="q heads per KV head (GQA)")
    p.add_argument("--d", type=int, default=128)
    p.add_argument("--seq_len", type=int, default=2048, help="context length")
    p.add_argument("--page_size", type=int, default=256)
    p.add_argument("--kv_dtypes", default="bfloat16,int8,fp8", help="comma list to sweep")
    args, dev = parse(p, argv)

    from flashattention_tpu_torch.ops.decode import paged_attention, paged_attention_reference
    from flashattention_tpu_torch.ops.quant import quantize
    from flashattention_tpu_torch.utils.benchit import chip_peak, devtime_ms, measured_hbm_gbps

    b, kvh, g, d, s, ps = (args.batch, args.kv_heads, args.group, args.d, args.seq_len,
                           args.page_size)
    pps = s // ps
    total_pages = b * pps + 8
    q = make_random(0, (b, kvh, g, d), torch.float32, dev)
    kf = make_random(1, (total_pages, kvh, ps, d), torch.float32, dev)
    vf = make_random(2, (total_pages, kvh, ps, d), torch.float32, dev)
    lengths = torch.full((b,), s, dtype=torch.int32, device=dev)
    page_indices = torch.arange(b * pps, dtype=torch.int32, device=dev).reshape(b, pps)
    want = paged_attention_reference(q, kf, vf, lengths, page_indices)
    peak = chip_peak(16, device=dev)
    measured = measured_hbm_gbps(device=dev)
    card = card_of(dev)

    for name in args.kv_dtypes.split(","):
        if name not in KV_DTYPES:
            raise SystemExit(f"unknown kv dtype {name!r}; choose from {KV_DTYPES}")
        if name in ("bfloat16", "float32"):
            dt = torch.bfloat16 if name == "bfloat16" else torch.float32
            kp, vp = kf.to(dt), vf.to(dt)
            extra = {}
            kv_bytes = 2 * b * kvh * s * d * kp.element_size()
            tol = 2e-2 if name == "bfloat16" else 1e-4
        else:
            kq, vq = quantize(kf, name), quantize(vf, name)
            kp, vp = kq.payload, vq.payload
            extra = dict(k_scales_pages=kq.scales, v_scales_pages=vq.scales)
            kv_bytes = 2 * b * kvh * s * (d * 1 + 4)  # payload + f32 scale
            tol = 5e-2 if name == "int8" else 2e-1  # e4m3: 3 mantissa bits
        # float32 q, as the JAX bench passes it: over bf16 pages the entry
        # point takes it in bf16, as the Pallas kernel does.  Over 8-bit pages
        # float32 q runs the scalar 8-bit form (q kept in float32), so there
        # q is taken in bf16 here, as the Pallas kernel takes it.
        qk = q if name in ("float32", "bfloat16") else q.to(torch.bfloat16)

        def fn(q, kp=kp, vp=vp, extra=extra):
            return paged_attention(q, kp, vp, lengths, page_indices, **extra)

        err = float((fn(qk).float() - want).abs().max())
        ms = devtime_ms(fn, (qk,), n_hi=257)
        gbps = kv_bytes / (ms * 1e-3) / 1e9
        row = {
            "kv_dtype": name,
            "batch": b,
            "kv_heads": kvh,
            "q_heads": kvh * g,
            "d": d,
            "seq_len": s,
            "page_size": ps,
            "step_ms": round(ms, 4),
            "decode_tokens_per_s": round(b / ms * 1e3),
            "kv_gb_per_s": round(gbps, 1),
            "max_abs_err": err,
            "valid": err <= tol,
            "card": card,
        }
        if peak:
            row["hbm_frac"] = round(gbps / peak[1], 3)
            row["measured_hbm_gbps"] = round(measured, 1)
            row["measured_hbm_frac"] = round(gbps / measured, 3)
        print(json.dumps(row))
        if err > tol:
            raise SystemExit(f"{name}: err {err} > tol {tol}")


if __name__ == "__main__":
    main()
