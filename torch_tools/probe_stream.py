#!/usr/bin/env python3
"""H100 probe: what a plain stream of an attention call's bytes reaches on this card.

    python3 torch_tools/probe_stream.py [--iters N]

The port of ``scripts/probe_small_fp32.py``'s ``hbm_floor`` (:35, its
``pallas_call`` :43) for this card, through ``fa_probe_stream`` of
``flashattention_tpu_torch/csrc/probe_mma.cu``:

- ``hbm_floor``: the TPU probe's own shape and kernel, ``o = q + k + v`` over
  float32 (BH = 128, S = 1024, d = 64) tensors: three reads and one write
  of 33.6 MB each;
- ``page_walk``: paged decode's reads alone.  The K and V rows that
  ``paged_decode_tc`` reads (each request's live columns through its page
  table, from the window's first column), read by a streaming kernel in
  the same blocks (``ops.decode.decode_splits``) and folded into one word a
  block, beside ``paged_attention`` itself (the tensor-core form) on the
  same pools: at Gemma-2's decode shapes (8 KV heads, G = 2, d = 256,
  window 4096, softcap 50, pages of 256 rows, 24 a request; lengths 1,
  4096, 4097, 6000 as chip_smoke's windowed check, and 1537-1543 as
  serve_gemma2's profile), over bf16 and fp8 pages, and at Llama-7B's
  (32 KV heads, G = 1, d = 128, lengths 1-1088, 8 pages a request).

Each is timed with CUDA events, the L2 cache flushed before every call (a
decode step finds its pages cold).  GB/s is the bytes the call must move
(inputs read once, outputs written once; the page walk's K/V rows, the
decode's also q, o, the lengths, the table entries and, for fp8, the
scales) over its time; ``decode_over_walk`` is paged_attention's time over
the page walk's.  Prints one JSON line with the card's name and power
limit and writes it to ``chiprun_out/probe_stream.json``.  Imports nothing
of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HBM_FLOOR = dict(bh=128, s=1024, d=64)
# name -> (KV heads, G, d, pages per request, lengths, window, softcap)
WALKS = {
    "gemma2_window_check": (8, 2, 256, 24, [1, 4096, 4097, 6000], 4096, 50.0),
    "gemma2_serve_profile": (8, 2, 256, 24, [1537, 1539, 1541, 1543], 4096, 50.0),
    "llama_mha": (32, 1, 128, 8, [1, 256, 257, 1088], None, None),
}
PAGE = 256


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import torch

    if not torch.cuda.is_available():
        print("probe_stream: no CUDA device", file=sys.stderr)
        return 2
    from flashattention_tpu_torch.ops import decode, kernels, quant
    from flashattention_tpu_torch.utils import benchit

    fn = kernels.library("probe_mma").fa_probe_stream
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [i, p, p, p, p, p, p, ctypes.c_longlong, *[i] * 8, p]
    fn.restype = ctypes.c_int
    name = torch.cuda.get_device_name(0)
    out = {"probe": "probe_stream", "card": name, "nvidia_smi": benchit.card_info()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def timed(f):
        return benchit.cuda_time_ms(f, warmup=3, iters=args.iters, flush_bytes=256 << 20)

    # hbm_floor: o = q + k + v at the TPU probe's shape.
    c = HBM_FLOOR
    q, k, v = (torch.randn((c["bh"], c["s"], c["d"]), generator=gen, device="cuda")
               for _ in range(3))
    o = torch.empty_like(q)

    def floor():
        st = fn(0, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), None, None, q.numel(),
                0, 0, 0, 0, 0, 0, 0, 0, stream())
        kernels.check_launch("probe_mma", st, "fa_probe_stream hbm_floor")

    floor()
    torch.cuda.synchronize()
    ok = bool(torch.equal(o, q + k + v))
    ms = timed(floor)
    nbytes = 4 * q.numel() * 4
    out["hbm_floor"] = {"shape": f"BH={c['bh']} S={c['s']} d={c['d']} float32, o = q + k + v",
                        "ms": ms, "bytes": nbytes, "gb_s": nbytes / (ms * 1e-3) / 1e9,
                        "equal_to_torch": ok,
                        **benchit.bound_ms(name, bytes_moved=nbytes, flops=0, dtype="float32")}
    del q, k, v, o
    # page_walk beside paged_attention on the same pools.
    out["page_walk"] = {}
    for shape, (kvh, g, d, pps, lens, window, cap) in WALKS.items():
        for form in (None, "fp8") if shape.startswith("gemma2") else (None,):
            b = len(lens)
            pages = b * pps + 4
            pools = [torch.randn((pages, kvh, PAGE, d), generator=gen, device="cuda")
                     for _ in range(2)]
            if form:
                (kp, ks), (vp, vs) = (quant.quantize_rows(x, form) for x in pools)
                sc = dict(k_scales_pages=ks, v_scales_pages=vs)
            else:
                kp, vp = (x.to(torch.bfloat16) for x in pools)
                sc = {}
            del pools
            perm = torch.randperm(pages, generator=gen, device="cuda")
            table = perm[: b * pps].reshape(b, pps).to(torch.int32).contiguous()
            lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
            qd = torch.randn((b, kvh, g, d), generator=gen, device="cuda").to(torch.bfloat16)
            n, per = decode.decode_splits(b, kvh, pps, PAGE, sms=decode._sm_count(qd.device))
            words = torch.zeros((b, kvh, n), dtype=torch.int32, device="cuda")
            row_bytes = d * kp.element_size()

            def walk(kp=kp, vp=vp, table=table, lengths=lengths, words=words, b=b, kvh=kvh,
                     row_bytes=row_bytes, pps=pps, n=n, per=per, window=window):
                st = fn(1, kp.data_ptr(), vp.data_ptr(), None, words.data_ptr(),
                        lengths.data_ptr(), table.data_ptr(), 0, b, kvh, row_bytes, PAGE, pps, n,
                        per, window or 0, stream())
                kernels.check_launch("probe_mma", st, "fa_probe_stream page_walk")

            kw = dict(scale=d**-0.5, window=window, logit_softcap=cap, **sc)
            dec = lambda: decode.paged_attention(qd, kp, vp, lengths, table, **kw)  # noqa: E731
            walk()
            dec()
            torch.cuda.synchronize()
            live = sum(min(x, window) if window else x for x in lens)
            walk_bytes = 2 * live * kvh * row_bytes
            dec_bytes = (walk_bytes + 2 * qd.numel() * 2 + (2 * live * kvh * 4 if form else 0)
                         + 4 * (b + sum(-(-x // PAGE) for x in lens)))
            walk_ms, dec_ms = timed(walk), timed(dec)
            out["page_walk"][f"{shape}/{form or 'bf16'}"] = {
                "shape": f"B={b} KVH={kvh} G={g} d={d} ps={PAGE} pps={pps} window={window} "
                         f"cap={cap} lengths={lens}",
                "splits": [n, per], "walk_ms": walk_ms, "walk_bytes": walk_bytes,
                "walk_gb_s": walk_bytes / (walk_ms * 1e-3) / 1e9,
                "paged_decode_tc_ms": dec_ms, "paged_decode_tc_bytes": dec_bytes,
                "paged_decode_tc_gb_s": dec_bytes / (dec_ms * 1e-3) / 1e9,
                "decode_over_walk": dec_ms / walk_ms,
                "walk_bound_ms": benchit.bound_ms(name, bytes_moved=walk_bytes, flops=0,
                                                  dtype="bfloat16")["bound_ms"],
            }
            del kp, vp, sc, table, lengths, qd, words
            torch.cuda.empty_cache()
    out["ok"] = ok
    print(json.dumps(out), flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "probe_stream.json"), "w") as fh:
        json.dump(out, fh, indent=1)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
