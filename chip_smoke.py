#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``flashattention_tpu_torch``) on one card.

    python3 chip_smoke.py [--seed N] [--layers L]

Phases, each of which must pass (any failure exits non-zero):

1. build     - compile every CUDA kernel from ``flashattention_tpu_torch/csrc``
               (one nvcc per source, in parallel) and print the build seconds;
2. kernels   - hold each kernel against its plain PyTorch version on the card,
               in bfloat16 and float32, at the serving path's shapes, and time
               kernel, plain version and (where one exists) the library call;
               hold the naive kernel against the flash kernel (cross-check);
3. serve     - run the engine with whole-prompt prefill (prefill_chunk=0) at
               Llama-7B width (32 layers unless --layers): 8 greedy requests,
               64-1024 token prompts from --seed, 32 new tokens each,
               max_batch 4, so requests wait and join the batch; the kernels'
               launch counters must match the batches served; then 4 more
               requests, timed untraced and then under torch.profiler, give
               the device's busy share and top kernels;
4. serve_chunked - the same model with the default chunked prefill
               (prefill_chunk=512): a donor prompt with a 1024-token prefix,
               three prompts that share it (prefix hits), three long unique
               prompts and one short one; the paged-prefill launches must be
               layers x chunk rounds and prefill_tokens must show the three
               hits; then a profile of 4 requests with 1536-token prompts;
5. crosscheck - the naive kernel's path: ``flash_attention_naive`` and the
               flash kernel through the public entry points on the same
               inputs, each launched once, agreeing;
6. parity    - one 64-token request through prefill and 4 decode steps on a
               2-layer float32 cut at the same width, on the card (kernels)
               and on the CPU (plain versions); and the same cut through the
               chunked engine (a 600-token prompt, then one sharing its first
               256 tokens); the logits must agree.

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
PREFILL_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
NAIVE_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
CROSS_TOL = 2e-2  # naive vs flash kernel, bfloat16 inputs and outputs
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


def _paged_pool(gen, ctx_lens, pps, pages, shape_tail, dtype):
    """Pools of ``pages`` random pages and tables whose first
    ``ceil(ctx / ps)`` entries are distinct shuffled pages and whose tail
    entries are other pool pages (garbage the kernel must not use)."""
    b = len(ctx_lens)
    assert b * pps <= pages
    perm = torch.randperm(pages, generator=gen, device="cuda")
    table = perm[: b * pps].reshape(b, pps).to(torch.int32).contiguous()
    kp = torch.randn((pages, *shape_tail), generator=gen, device="cuda").to(dtype)
    vp = torch.randn((pages, *shape_tail), generator=gen, device="cuda").to(dtype)
    return kp, vp, table


def _prefill_work(ctx_lens, chunk, seg, g, kvh, d):
    """Live (row, column) pairs and their flops: row p of a segment sees
    ``min(ctx - chunk + p + 1, ctx)`` columns (pad rows p >= chunk see all
    ``ctx``); a ctx = 0 request sees none."""
    pairs = 0
    for c in ctx_lens:
        if c:
            pairs += sum(min(c - chunk + p + 1, c) for p in range(seg))
    return pairs * g * kvh, 4 * pairs * g * kvh * d


def prefill_checks(decode, benchit, gen, card, report):
    """Paged prefill: MHA (32 KV heads, G=1) at the engine's chunk, GQA
    (8 KV heads, G=4) with seg > chunk and a ctx = 0 row, the single form."""
    out = {}
    ps, pps, pages, d = 256, 8, 64, 128
    cases = [
        ("prefill_mha", dict(kvh=32, g=1, chunk=512, seg=512, ctx=[512, 1024, 1536, 2048])),
        ("prefill_gqa_g4", dict(kvh=8, g=4, chunk=200, seg=256, ctx=[0, 200, 713, 1480])),
    ]
    for name, c in cases:
        b = len(c["ctx"])
        ctx = torch.tensor(c["ctx"], dtype=torch.int32, device="cuda")
        for dt in ("bfloat16", "float32"):
            kp, vp, table = _paged_pool(gen, c["ctx"], pps, pages, (c["kvh"], ps, d), DTYPES[dt])
            q = torch.randn((b, c["kvh"], c["g"] * c["seg"], d), generator=gen, device="cuda").to(DTYPES[dt])
            kw = dict(chunk=c["chunk"], seg=c["seg"], scale=d**-0.5)
            o = decode.paged_prefill_attention_batched(q, kp, vp, table, ctx, **kw)
            plain = lambda: decode.paged_prefill_attention_plain(q, kp, vp, table, ctx, **kw)  # noqa: E731
            want = plain()
            torch.cuda.synchronize()
            e = err(o, want)
            zero_rows = [i for i, n in enumerate(c["ctx"]) if n == 0]
            zeros_ok = all(int(torch.count_nonzero(o[i])) == 0 for i in zero_rows)
            rec = {"check": f"paged_prefill/{name}/{dt}", "max_abs_err": e,
                   "tol": PREFILL_TOL[dt], "ctx_lens": c["ctx"], "chunk": c["chunk"],
                   "seg": c["seg"], "ctx0_rows_zero": zeros_ok,
                   "ok": e <= PREFILL_TOL[dt] and zeros_ok}
            if name == "prefill_mha":
                one = decode.paged_prefill_attention(q[3], kp, vp, table[3], c["ctx"][3], **kw)
                torch.cuda.synchronize()
                rec["single_form_err"] = err(one, want[3])
                rec["ok"] = rec["ok"] and rec["single_form_err"] <= PREFILL_TOL[dt]
            if name == "prefill_mha" and dt == "bfloat16":
                kernel = lambda: decode.paged_prefill_attention_batched(q, kp, vp, table, ctx, **kw)  # noqa: E731
                rec["kernel_ms"] = benchit.cuda_time_ms(kernel, flush_bytes=256 << 20)
                rec["plain_ms"] = benchit.cuda_time_ms(plain, flush_bytes=256 << 20)
                # Library yardstick: SDPA over the context gathered densely
                # beforehand (the gather is not timed), with an explicit
                # bottom-right causal mask per request.
                s_max = pps * ps
                idx = table.long()
                kd = kp[idx].transpose(1, 2).reshape(b, c["kvh"], s_max, d)
                vd = vp[idx].transpose(1, 2).reshape(b, c["kvh"], s_max, d)
                cols = torch.arange(s_max, device="cuda")
                pos = ctx[:, None] - c["chunk"] + torch.arange(c["seg"], device="cuda")[None]
                mask = (cols[None, None] <= pos[:, :, None]) & (cols[None, None] < ctx[:, None, None])
                sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
                    q, kd, vd, attn_mask=mask[:, None], scale=kw["scale"]
                )
                rec["library_ms"] = benchit.cuda_time_ms(sdpa, flush_bytes=256 << 20)
                rec["library"] = "scaled_dot_product_attention on the pre-gathered dense context, boolean causal mask, gather not timed"
                pairs, flops = _prefill_work(c["ctx"], c["chunk"], c["seg"], c["g"], c["kvh"], d)
                live_pages = sum(-(-n // ps) for n in c["ctx"])
                nbytes = (
                    2 * q.numel() * q.element_size()  # q read, o written
                    + 2 * sum(c["ctx"]) * c["kvh"] * d * kp.element_size()  # live K, V rows
                    + 4 * (b + live_pages)  # ctx_lens, the table entries read
                )
                rec["live_pairs"] = pairs
                rec.update(benchit.bound_ms(card, bytes_moved=nbytes, flops=flops, dtype=dt))
                out["main"] = rec
            emit(rec)
            report["checks"].append(rec)
            del kp, vp, q, o, want
    torch.cuda.empty_cache()
    return out["main"]


def naive_checks(flash, benchit, gen, card, report):
    """Naive kernel: B*H = 128, S = 1024, d = 128, causal; and a kv_len /
    q_offset case (256 query rows at positions 600.., 900 live KV rows)."""
    out = {}
    cases = [
        ("causal_s1024", dict(bh=128, s_q=1024, s_kv=1024, kw=dict(causal=True))),
        ("kvlen_qoffset", dict(bh=16, s_q=256, s_kv=1024, kw=dict(causal=True, kv_len=900, q_offset=600))),
    ]
    for name, c in cases:
        for dt in ("bfloat16", "float32"):
            q = torch.randn((c["bh"], c["s_q"], 128), generator=gen, device="cuda").to(DTYPES[dt])
            k = torch.randn((c["bh"], c["s_kv"], 128), generator=gen, device="cuda").to(DTYPES[dt])
            v = torch.randn((c["bh"], c["s_kv"], 128), generator=gen, device="cuda").to(DTYPES[dt])
            kw = dict(c["kw"], scale=128**-0.5)
            o = flash.flash_attention_naive(q, k, v, **kw)
            plain = lambda: flash.flash_attention_naive_plain(q, k, v, **kw)  # noqa: E731
            want = plain()
            torch.cuda.synchronize()
            e = err(o, want)
            rec = {"check": f"flash_naive/{name}/{dt}", "max_abs_err": e,
                   "tol": NAIVE_TOL[dt], "ok": e <= NAIVE_TOL[dt]}
            if name == "causal_s1024" and dt == "bfloat16":
                kernel = lambda: flash.flash_attention_naive(q, k, v, **kw)  # noqa: E731
                rec["kernel_ms"] = benchit.cuda_time_ms(kernel)
                rec["plain_ms"] = benchit.cuda_time_ms(plain)
                q4, k4, v4 = (x.reshape(4, 32, c["s_q"], 128) for x in (q, k, v))
                rec["library_ms"] = benchit.cuda_time_ms(
                    lambda: torch.nn.functional.scaled_dot_product_attention(
                        q4, k4, v4, is_causal=True, scale=kw["scale"]
                    )
                )
                s = c["s_q"]
                pairs = s * (s + 1) // 2
                nbytes = 4 * q.numel() * q.element_size()  # q, k, v read; o written
                rec.update(benchit.bound_ms(
                    card, bytes_moved=nbytes, flops=4 * c["bh"] * pairs * 128, dtype=dt
                ))
                out["main"] = rec
            emit(rec)
            report["checks"].append(rec)
    return out["main"]


def phase_crosscheck(fa, flash, gen, report):
    """The naive kernel's path: the public ``flash_attention_naive`` and
    ``attention`` (the flash kernel) on the same bfloat16 inputs, B*H = 128,
    S = 1024, causal; each launches once and the two agree."""
    q, k, v = (
        torch.randn((128, 1024, 128), generator=gen, device="cuda").to(torch.bfloat16)
        for _ in range(3)
    )
    flash.flash_attention_naive.launches = 0
    flash.flash_attention.launches = 0
    o_naive = fa.flash_attention_naive(q, k, v, causal=True, scale=128**-0.5)
    o_flash = fa.attention(q, k, v, causal=True, scale=128**-0.5)
    torch.cuda.synchronize()
    launches = {"flash_naive": flash.flash_attention_naive.launches,
                "flash_fwd": flash.flash_attention.launches}
    e = err(o_naive, o_flash)
    rec = {"phase": "crosscheck", "shape": "BH=128 S=1024 d=128 causal bf16",
           "max_abs_err": e, "tol": CROSS_TOL, "launches": launches,
           "ok": e <= CROSS_TOL and launches == {"flash_naive": 1, "flash_fwd": 1}}
    emit(rec)
    report["crosscheck"] = rec
    return rec


def _counters(flash, decode):
    return {
        "flash_fwd": flash.flash_attention,
        "paged_decode": decode.paged_attention,
        "paged_prefill": decode.paged_prefill_attention_batched,
        "flash_naive": flash.flash_attention_naive,
    }


def _drive(counters, drive):
    """Call ``drive()`` with every launch counter set to 0 just before and
    read just after; return (wall seconds, launches)."""
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    drive()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, {k: fn.launches for k, fn in counters.items()}


def _finished(eng, ids, budget):
    return all(
        len(eng.requests[i].output) == budget and eng.requests[i].state == "finished"
        for i in ids
    )


def _serve_rec(phase, cfg, st, full, wall, launches, want, extra):
    return {
        "phase": phase, "model": "llama7b_attention", "layers": cfg.num_layers, **extra,
        "all_finished_full_budget": full, "stats": st, "launches": launches,
        "launches_expected": want, "wall_s": wall,
        "prefill_tok_s": st["prefill_tokens"] / st["prefill_s"],
        "decode_tok_s": st["decode_tokens"] / st["decode_s"],
        "decode_step_ms": 1e3 * st["decode_s"] / st["decode_batches"],
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
    }


def phase_serve(args, cfg, params, engine_mod, kvcache, counters, report):
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
    torch.cuda.reset_peak_memory_stats()
    wall, launches = _drive(counters, eng.run)
    full = _finished(eng, ids, budget)
    st = eng.stats()
    want = {
        "flash_fwd": cfg.num_layers * st["prefill_batches"],
        "paged_decode": cfg.num_layers * st["decode_batches"],
        "paged_prefill": 0, "flash_naive": 0,
    }
    rec = _serve_rec("serve", cfg, st, full, wall, launches, want,
                     {"prompt_lens": lens.tolist(), "new_tokens": budget})
    rec["ok"] = (
        full and launches == want and launches["flash_fwd"] > 0
        and launches["paged_decode"] > 0 and st["free_pages"] == ccfg.num_pages
    )
    emit(rec)
    report["serve"] = rec
    report["profile"] = phase_profile(args, eng, cfg, prompt_len=512, tag="serve")
    del eng
    torch.cuda.empty_cache()
    return rec


def phase_serve_chunked(args, cfg, params, engine_mod, kvcache, counters, report):
    """The default configuration's path: chunked prefill and prefix hits."""
    ccfg = kvcache.CacheConfig(
        num_layers=cfg.num_layers, num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim, page_size=256, num_pages=64, dtype="bfloat16",
    )
    eng = engine_mod.Engine(
        params, cfg, ccfg,
        engine_mod.EngineConfig(max_batch=4, pages_per_seq=12, prefill_chunk=512),
    )
    rng = np.random.default_rng(args.seed + 10)
    tok = lambda n: rng.integers(0, cfg.vocab_size, size=int(n)).tolist()  # noqa: E731
    budget, shared = 32, 1024
    prefix = tok(shared)
    prompts = [prefix + tok(100)]  # the donor
    prompts += [prefix + tok(n) for n in rng.integers(64, 401, size=3)]  # prefix hits
    prompts += [tok(n) for n in rng.integers(513, 2049, size=3)]  # long, unique
    prompts += [tok(rng.integers(64, 513))]  # short: whole-prompt on flash_fwd
    ids = []

    def drive():
        ids.append(eng.add_request(prompts[0], budget))
        eng.step()  # the donor prefills and publishes its full prompt pages
        ids.extend(eng.add_request(p, budget) for p in prompts[1:])
        eng.run()

    torch.cuda.reset_peak_memory_stats()
    wall, launches = _drive(counters, drive)
    full = _finished(eng, ids, budget)
    st = eng.stats()
    want = {
        "flash_fwd": cfg.num_layers * st["prefill_batches"],
        "paged_decode": cfg.num_layers * st["decode_batches"],
        "paged_prefill": cfg.num_layers * st["chunk_rounds"],
        "flash_naive": 0,
    }
    want_prefill = sum(len(p) for p in prompts) - 3 * shared
    rec = _serve_rec("serve_chunked", cfg, st, full, wall, launches, want, {
        "prompt_lens": [len(p) for p in prompts], "shared_prefix": shared,
        "new_tokens": budget, "prefill_tokens_expected": want_prefill,
    })
    rec["ok"] = (
        full and launches == want
        and all(launches[k] > 0 for k in ("flash_fwd", "paged_decode", "paged_prefill"))
        and st["free_pages"] == ccfg.num_pages and st["preemptions"] == 0
        and st["prefill_tokens"] == want_prefill
    )
    emit(rec)
    report["serve_chunked"] = rec
    report["profile_chunked"] = phase_profile(args, eng, cfg, prompt_len=1536, tag="serve_chunked")
    del eng
    torch.cuda.empty_cache()
    return rec


def phase_profile(args, eng, cfg, *, prompt_len, tag):
    """Where the serving time goes: 4 more requests (``prompt_len``-token
    prompts, 8 new tokens) through the same engine after the counted run,
    once untraced for the wall time and once under torch.profiler (device
    activity only, so the host is not slowed by op tracing).  The two runs
    draw different prompts, so the second finds no prefix of the first.
    Reports the device's busy share of the untraced wall time and the
    kernels that took the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def workload(seed):
        rng = np.random.default_rng(seed)
        for _ in range(4):
            eng.add_request(rng.integers(0, cfg.vocab_size, size=prompt_len).tolist(), 8)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e6

    wall_us = workload(args.seed + 2)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        traced_us = workload(args.seed + 3)
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
        for k in ("flash_fwd", "paged_decode", "paged_prefill", "flash_naive")
    }
    rec = {
        "phase": f"profile/{tag}", "requests": 4, "prompt_len": prompt_len, "new_tokens": 8,
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


def phase_parity(args, transformer, kvcache, engine_mod, report):
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
    report["parity_chunked"] = parity_chunked(
        args, cfg, cpu_params, gpu_params, kvcache, engine_mod
    )
    return rec


def parity_chunked(args, cfg, cpu_params, gpu_params, kvcache, engine_mod):
    """The chunked engine on the 2-layer float32 cut: a 600-token prompt in
    three 256-token chunk rounds, then a prompt that shares its first 256
    tokens (a prefix hit) and prefills the rest in one round; 4 decode steps
    each.  Every logits row the engine samples from, card against CPU."""

    class Recording(engine_mod.Engine):
        def _sample_rows(self, reqs, logits):
            self.rows.append(logits.float().cpu())
            return super()._sample_rows(reqs, logits)

    rng = np.random.default_rng(args.seed + 4)
    first = rng.integers(0, cfg.vocab_size, size=600).tolist()
    second = first[:256] + rng.integers(0, cfg.vocab_size, size=100).tolist()

    def run(params, device):
        eng = Recording(params, cfg, kvcache.CacheConfig(
            num_layers=2, num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
            page_size=128, num_pages=16, dtype="float32",
        ), engine_mod.EngineConfig(max_batch=2, pages_per_seq=8, prefill_chunk=256),
            device=device)
        eng.rows, outs = [], []
        for p in (first, second):
            rid = eng.add_request(p, 5)
            outs.append(eng.run()[rid])
        st = eng.stats()
        return torch.cat(eng.rows), outs, st["chunk_rounds"], st["prefill_tokens"]

    want, want_toks, rounds, tokens = run(cpu_params, "cpu")
    got, got_toks, _, _ = run(gpu_params, "cuda")
    same = got_toks == want_toks
    e = err(got, want) if same else float("inf")
    rec = {"phase": "parity_chunked", "layers": 2, "dtype": "float32", "page_size": 128,
           "chunk": 256, "prompt_lens": [len(first), len(second)], "shared_prefix": 256,
           "decode_steps": 4, "chunk_rounds": rounds, "prefill_tokens": tokens,
           "tokens_equal": same, "max_abs_err": e, "tol": PARITY_TOL,
           "logit_absmax": float(want.abs().max()),
           "ok": same and e <= PARITY_TOL and tokens == len(first) + len(second) - 256}
    emit(rec)
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
    counters = _counters(flash, decode)

    phase_build(kernels, report)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    mains = {
        "flash_fwd": flash_checks(fa, flash, benchit, gen, name, report),
        "paged_decode": paged_checks(decode, benchit, gen, name, report),
        "paged_prefill": prefill_checks(decode, benchit, gen, name, report),
        "flash_naive": naive_checks(flash, benchit, gen, name, report),
    }
    cfg = dataclasses.replace(
        transformer.ModelConfig.llama7b_attention(), num_layers=args.layers
    )
    t0 = time.perf_counter()
    params = transformer.init_params(args.seed, cfg)
    torch.cuda.synchronize()
    report["init_s"] = time.perf_counter() - t0
    serve = phase_serve(args, cfg, params, engine_mod, kvcache, counters, report)
    chunked = phase_serve_chunked(args, cfg, params, engine_mod, kvcache, counters, report)
    del params
    torch.cuda.empty_cache()
    cross = phase_crosscheck(fa, flash, gen, report)
    phase_parity(args, transformer, kvcache, engine_mod, report)

    paths = {"serve": serve["launches"], "serve_chunked": chunked["launches"],
             "crosscheck": cross["launches"]}
    summary = []
    for kname, source, replaces in (
        ("flash_fwd", "flashattention_tpu_torch/csrc/flash_fwd.cu",
         "flashattention_tpu/ops/flash.py:628"),
        ("paged_decode", "flashattention_tpu_torch/csrc/paged_decode.cu",
         "flashattention_tpu/ops/decode.py:89"),
        ("paged_prefill", "flashattention_tpu_torch/csrc/paged_prefill.cu",
         "flashattention_tpu/ops/decode.py:375"),
        ("flash_naive", "flashattention_tpu_torch/csrc/flash_naive.cu",
         "flashattention_tpu/ops/flash.py:1690"),
    ):
        main_rec = mains[kname]
        by_path = {p: n[kname] for p, n in paths.items() if n.get(kname)}
        summary.append({
            "name": kname, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": main_rec["max_abs_err"],
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
    failed += [p for p in ("serve", "serve_chunked", "crosscheck", "parity", "parity_chunked")
               if not report[p]["ok"]]
    failed += [k["name"] for k in summary if k["launches"] == 0]
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
