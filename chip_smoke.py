#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``flashattention_tpu_torch``) on one card.

    python3 chip_smoke.py [--seed N] [--layers L]

Phases, each of which must pass (any failure exits non-zero):

1. build   - compile every CUDA kernel from ``flashattention_tpu_torch/csrc``
             (one nvcc per source, in parallel) and print the build seconds;
2. kernels - hold each kernel against its plain PyTorch version on the card,
             in bfloat16 and float32, at the serving path's shapes, and time
             kernel, plain version and (where one exists) the library call;
3. serve   - run the engine at Llama-7B width (32 layers unless --layers):
             8 greedy requests, 64-1024 token prompts from --seed, 32 new
             tokens each, max_batch 4, so requests wait and join the batch;
             the kernels' launch counters must match the batches served;
             then 4 more requests, timed untraced and then under
             torch.profiler, give the device's busy share and top kernels;
4. parity  - one 64-token request through prefill and 4 decode steps on a
             2-layer float32 cut at the same width, on the card (kernels) and
             on the CPU (plain versions); the logits must agree.

It prints one JSON line per check, a ``{"kernels": [...]}`` summary, the
card's name and power limit, and last ``{"ok": true, "device": {...}}``.
Details go to ``chiprun_out/chip_smoke.json``.  It needs one CUDA card and
imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

FLASH_TOL = {"bfloat16": 2e-2, "float32": 1e-4}  # kernel vs plain, max abs
PAGED_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
STATS_RTOL = 1e-5  # l, m residuals: max abs error over max |value|
PARITY_TOL = 1e-3  # float32 logits, card kernels vs CPU plain versions
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def phase_build(kernels, report):
    t0 = time.perf_counter()
    built = kernels.build_all()
    seconds = time.perf_counter() - t0
    for name, info in built.items():
        regs = [ln.strip() for ln in info["log"].splitlines() if "registers" in ln]
        report["build"][name] = {"seconds": info["seconds"], "ptxas": regs}
    emit({"phase": "build", "seconds": seconds, "kernels": sorted(built),
          "card": report["card"]})


def flash_checks(fa, flash, benchit, gen, card, report):
    """Flash forward: the prefill shape, GQA 32q/8kv, ragged S, residuals."""
    out = {}

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    cases = [
        ("prefill", dict(b=4, h=32, hkv=32, s_q=1024, s_kv=1024, d=128)),
        ("gqa_32q8kv", dict(b=2, h=32, hkv=8, s_q=512, s_kv=512, d=128)),
        ("ragged_s300", dict(b=2, h=8, hkv=8, s_q=300, s_kv=300, d=128)),
    ]
    for name, c in cases:
        for dt in ("bfloat16", "float32"):
            q = rand((c["b"], c["h"], c["s_q"], c["d"]), DTYPES[dt])
            k = rand((c["b"], c["hkv"], c["s_kv"], c["d"]), DTYPES[dt])
            v = rand((c["b"], c["hkv"], c["s_kv"], c["d"]), DTYPES[dt])
            scale = c["d"] ** -0.5
            o = fa.attention(q, k, v, causal=True, scale=scale)
            g = c["h"] // c["hkv"]
            q3 = q.reshape(c["b"] * c["hkv"], g * c["s_q"], c["d"])
            k3 = k.reshape(-1, c["s_kv"], c["d"])
            v3 = v.reshape(-1, c["s_kv"], c["d"])
            plain = lambda: flash.flash_attention_plain(  # noqa: E731
                q3, k3, v3, causal=True, scale=scale, q_offset=c["s_kv"] - c["s_q"],
                q_seq_len=c["s_q"],
            )
            want = plain().reshape(q.shape)
            torch.cuda.synchronize()
            e = err(o, want)
            rec = {"check": f"flash_fwd/{name}/{dt}", "max_abs_err": e,
                   "tol": FLASH_TOL[dt], "ok": e <= FLASH_TOL[dt]}
            if name == "prefill" and dt == "bfloat16":
                kernel = lambda: fa.attention(q, k, v, causal=True, scale=scale)  # noqa: E731
                rec["kernel_ms"] = benchit.cuda_time_ms(kernel)
                rec["plain_ms"] = benchit.cuda_time_ms(plain)
                rec["library_ms"] = benchit.cuda_time_ms(
                    lambda: torch.nn.functional.scaled_dot_product_attention(
                        q, k, v, is_causal=True, scale=scale
                    )
                )
                s = c["s_q"]
                bh = c["b"] * c["h"]
                pairs = s * (s + 1) // 2  # live (query, key) pairs per head
                nbytes = 4 * q.numel() * q.element_size()  # q, k, v read; o written
                rec.update(benchit.bound_ms(
                    card, bytes_moved=nbytes, flops=4 * bh * pairs * c["d"], dtype=dt
                ))
                out["main"] = rec
            emit(rec)
            report["checks"].append(rec)
    # save_residuals with a live length: cross-attention rows at the end of
    # a 300-row KV buffer of which 250 rows are live.
    for dt in ("bfloat16", "float32"):
        q = rand((16, 128, 128), DTYPES[dt])
        k = rand((16, 300, 128), DTYPES[dt])
        v = rand((16, 300, 128), DTYPES[dt])
        kw = dict(causal=True, scale=128**-0.5, kv_len=250, q_offset=122)
        o, l, m = flash.flash_attention(q, k, v, save_residuals=True, **kw)
        wo, wl, wm = flash.flash_attention_plain(q, k, v, save_residuals=True, **kw)
        torch.cuda.synchronize()
        e_l = err(l, wl) / float(wl.abs().max())
        e_m = err(m, wm) / float(wm.abs().max())
        e = err(o, wo)
        ok = e <= FLASH_TOL[dt] and e_l <= STATS_RTOL and e_m <= STATS_RTOL
        rec = {"check": f"flash_fwd/save_residuals_kvlen/{dt}", "max_abs_err": e,
               "tol": FLASH_TOL[dt], "l_rel_err": e_l, "m_rel_err": e_m,
               "stats_rtol": STATS_RTOL, "ok": ok}
        emit(rec)
        report["checks"].append(rec)
    return out["main"]


def paged_checks(decode, benchit, gen, card, report):
    """Paged decode: MHA (32 KV heads, G=1) and GQA (8 KV heads, G=4)."""
    out = {}
    ps, pps, pages = 256, 8, 64
    cases = [
        ("decode_mha", dict(kvh=32, g=1, lengths=[1, 256, 257, 1088])),
        ("decode_gqa_g4", dict(kvh=8, g=4, lengths=[0, 255, 512, 2048])),
    ]
    for name, c in cases:
        b = len(c["lengths"])
        lengths = torch.tensor(c["lengths"], dtype=torch.int32, device="cuda")
        perm = torch.randperm(pages, generator=gen, device="cuda")[: b * pps]
        table = perm.reshape(b, pps).to(torch.int32).contiguous()
        for dt in ("bfloat16", "float32"):
            q = torch.randn((b, c["kvh"], c["g"], 128), generator=gen, device="cuda").to(DTYPES[dt])
            kp = torch.randn((pages, c["kvh"], ps, 128), generator=gen, device="cuda").to(DTYPES[dt])
            vp = torch.randn((pages, c["kvh"], ps, 128), generator=gen, device="cuda").to(DTYPES[dt])
            scale = 128**-0.5
            o = decode.paged_attention(q, kp, vp, lengths, table, scale=scale)
            plain = lambda: decode.paged_attention_plain(  # noqa: E731
                q, kp, vp, lengths, table, scale=scale
            )
            want = plain()
            torch.cuda.synchronize()
            e = err(o, want)
            rec = {"check": f"paged_decode/{name}/{dt}", "max_abs_err": e,
                   "tol": PAGED_TOL[dt], "ok": e <= PAGED_TOL[dt],
                   "lengths": c["lengths"]}
            if name == "decode_mha" and dt == "bfloat16":
                kernel = lambda: decode.paged_attention(q, kp, vp, lengths, table, scale=scale)  # noqa: E731
                # The pool (2 x 0.5 GB) is larger than L2, but this call's
                # pages were just read: flush so each call finds them cold.
                rec["kernel_ms"] = benchit.cuda_time_ms(kernel, flush_bytes=256 << 20)
                rec["plain_ms"] = benchit.cuda_time_ms(plain, flush_bytes=256 << 20)
                rec["library_ms"] = None
                live = sum(c["lengths"])
                n_pages = sum(-(-n // ps) for n in c["lengths"])
                nbytes = (
                    2 * q.numel() * q.element_size()  # q read, o written
                    + 2 * live * c["kvh"] * 128 * kp.element_size()  # live K, V rows
                    + 4 * (b + n_pages)  # lengths, the table entries read
                )
                flops = 4 * live * c["kvh"] * c["g"] * 128
                rec.update(benchit.bound_ms(card, bytes_moved=nbytes, flops=flops, dtype=dt))
                out["main"] = rec
            emit(rec)
            report["checks"].append(rec)
    return out["main"]


def phase_serve(args, transformer, engine_mod, kvcache, flash, decode, report):
    cfg = dataclasses.replace(
        transformer.ModelConfig.llama7b_attention(), num_layers=args.layers
    )
    t0 = time.perf_counter()
    params = transformer.init_params(args.seed, cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ccfg = kvcache.CacheConfig(
        num_layers=cfg.num_layers, num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim, page_size=256, num_pages=64, dtype="bfloat16",
    )
    eng = engine_mod.Engine(
        params, cfg, ccfg,
        engine_mod.EngineConfig(max_batch=4, pages_per_seq=8, prefill_chunk=0),
    )
    rng = np.random.default_rng(args.seed)
    lens = rng.integers(64, 1025, size=8)
    budget = 32
    ids = [
        eng.add_request(rng.integers(0, cfg.vocab_size, size=int(n)).tolist(), budget)
        for n in lens
    ]
    flash.flash_attention.launches = 0
    decode.paged_attention.launches = 0
    t0 = time.perf_counter()
    outs = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {
        "flash_fwd": flash.flash_attention.launches,
        "paged_decode": decode.paged_attention.launches,
    }
    st = eng.stats()
    full = all(
        len(outs[i]) == budget and eng.requests[i].state == "finished" for i in ids
    )
    want = {
        "flash_fwd": cfg.num_layers * st["prefill_batches"],
        "paged_decode": cfg.num_layers * st["decode_batches"],
    }
    ok = (
        full
        and all(launches[k] > 0 and launches[k] == want[k] for k in launches)
        and st["free_pages"] == ccfg.num_pages
    )
    rec = {
        "phase": "serve", "model": "llama7b_attention", "layers": cfg.num_layers,
        "prompt_lens": lens.tolist(), "new_tokens": budget,
        "all_finished_full_budget": full, "stats": st, "launches": launches,
        "launches_expected": want, "init_s": init_s, "wall_s": wall,
        "prefill_tok_s": st["prefill_tokens"] / st["prefill_s"],
        "decode_tok_s": st["decode_tokens"] / st["decode_s"],
        "decode_step_ms": 1e3 * st["decode_s"] / st["decode_batches"],
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30, "ok": ok,
    }
    emit(rec)
    report["serve"] = rec
    report["profile"] = phase_profile(args, eng, cfg)
    del eng, params
    torch.cuda.empty_cache()
    return rec


def phase_profile(args, eng, cfg):
    """Where the serving time goes: 4 more requests (512-token prompts, 8 new
    tokens) through the same engine after the counted run, once untraced for
    the wall time and once under torch.profiler (device activity only, so
    the host is not slowed by op tracing).  Reports the device's busy share
    of the untraced wall time and the kernels that took the most device
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def workload():
        rng = np.random.default_rng(args.seed + 2)
        for _ in range(4):
            eng.add_request(rng.integers(0, cfg.vocab_size, size=512).tolist(), 8)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e6

    wall_us = workload()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        traced_us = workload()
    spans = sorted(
        (e.time_range.start, e.time_range.end, e.name)
        for e in prof.events() if e.device_type == DeviceType.CUDA
    )
    busy, end = 0.0, float("-inf")
    by_name: dict[str, list] = {}
    for s, e, n in spans:
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
        agg = by_name.setdefault(n, [0, 0.0])
        agg[0] += 1
        agg[1] += e - s
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    ours = {
        k: sum(t for n, (_, t) in by_name.items() if f"{k}_kernel" in n) / 1e3
        for k in ("flash_fwd", "paged_decode")
    }
    rec = {
        "phase": "profile", "requests": 4, "prompt_len": 512, "new_tokens": 8,
        "wall_ms": wall_us / 1e3, "traced_wall_ms": traced_us / 1e3,
        "device_busy_ms": busy / 1e3 if spans else "not measured",
        "device_idle_share": 1 - busy / wall_us if spans else "not measured",
        "kernel_device_ms": ours,
        "top_kernels": [
            {"name": n[:80], "calls": c, "ms": t / 1e3} for n, (c, t) in top
        ],
    }
    emit(rec)
    return rec


def phase_parity(args, transformer, kvcache, report):
    cfg = dataclasses.replace(
        transformer.ModelConfig.llama7b_attention(), num_layers=2, dtype="float32"
    )
    cpu_params = transformer.init_params(args.seed, cfg, device="cpu")
    gpu_params = {
        k: (v.cuda() if torch.is_tensor(v) else [{n: w.cuda() for n, w in lay.items()} for lay in v])
        for k, v in cpu_params.items()
    }
    prompt = np.random.default_rng(args.seed + 1).integers(0, cfg.vocab_size, size=64)

    def run(params, device, feed):
        cache = kvcache.PagedKVCache(kvcache.CacheConfig(
            num_layers=2, num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
            page_size=256, num_pages=2, dtype="float32",
        ), device=device)
        logits, k, v = transformer.prefill(
            params, torch.tensor(prompt[None], device=device), cfg
        )
        cache.append(0, k[:, 0], v[:, 0])
        rows = [logits[0, -1]]
        toks = []
        for step in range(4):
            tok = feed[step] if feed else int(rows[-1].argmax())
            toks.append(tok)
            pos = cache.length(0)
            page, slot = cache.reserve_slot(0)
            lengths, table = cache.batch_view([0], 2)
            as_t = lambda x: torch.tensor([x], device=device)  # noqa: E731
            rows.append(transformer.decode_step(
                params, as_t(tok), as_t(pos), cache.k_pages, cache.v_pages,
                lengths, table, as_t(page), as_t(slot), cfg,
            )[0])
        return torch.stack(rows).cpu(), toks

    want, toks = run(cpu_params, "cpu", None)
    got, _ = run(gpu_params, "cuda", toks)  # the CPU's tokens, so inputs match
    e = err(got, want)
    rec = {"phase": "parity", "layers": 2, "dtype": "float32", "prompt_len": 64,
           "decode_steps": 4, "max_abs_err": e, "tol": PARITY_TOL,
           "logit_absmax": float(want.abs().max()), "ok": e <= PARITY_TOL}
    emit(rec)
    report["parity"] = rec
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=32, help="serve depth (published: 32)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from flashattention_tpu_torch.models import transformer
    from flashattention_tpu_torch.ops import decode, flash, kernels
    from flashattention_tpu_torch.runtime import engine as engine_mod
    from flashattention_tpu_torch.runtime import kvcache
    from flashattention_tpu_torch.utils import benchit
    import flashattention_tpu_torch as fa

    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in float32
    torch.backends.cudnn.allow_tf32 = False
    card = benchit.card_info()
    name = torch.cuda.get_device_name(0)
    report = {"card": card, "device": name, "build": {}, "checks": []}

    phase_build(kernels, report)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    flash_main = flash_checks(fa, flash, benchit, gen, name, report)
    paged_main = paged_checks(decode, benchit, gen, name, report)
    serve = phase_serve(args, transformer, engine_mod, kvcache, flash, decode, report)
    parity = phase_parity(args, transformer, kvcache, report)

    summary = []
    for kname, main_rec, source, replaces in (
        ("flash_fwd", flash_main, "flashattention_tpu_torch/csrc/flash_fwd.cu",
         "flashattention_tpu/ops/flash.py:628"),
        ("paged_decode", paged_main, "flashattention_tpu_torch/csrc/paged_decode.cu",
         "flashattention_tpu/ops/decode.py:89"),
    ):
        summary.append({
            "name": kname, "route": "cuda", "source": source, "replaces": replaces,
            "launches": serve["launches"][kname], "max_abs_err": main_rec["max_abs_err"],
            "tol": main_rec["tol"], "shape": main_rec["check"],
            "ms": main_rec["kernel_ms"], "kernel_ms": main_rec["kernel_ms"],
            "plain_ms": main_rec["plain_ms"], "bound_ms": main_rec["bound_ms"],
            "bound_by": main_rec["bound_by"], "bytes_ms": main_rec["bytes_ms"],
            "ops_ms": main_rec["ops_ms"], "library_ms": main_rec["library_ms"],
        })
    report["kernels"] = summary
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as fh:
        json.dump(report, fh, indent=1)

    failed = [c["check"] for c in report["checks"] if not c["ok"]]
    failed += [p for p in ("serve", "parity") if not report[p]["ok"]]
    emit({"kernels": summary})
    print(card, flush=True)
    if failed:
        print(f"chip_smoke: FAILED {failed}", file=sys.stderr)
        return 1
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
