#!/usr/bin/env python3
"""Compare paged decode and the Llama-7B serve phases between checkouts of
the port, on one card.

    python3 torch_tools/decode_ab.py ROOT [ROOT ...]

Each ROOT is a checkout of the repo: this one (``.``), or another commit
unpacked with ``git archive`` into an ignored directory such as ``build/``.
Each runs in a process of its own, in the order given, so that an order
like "parent change change parent" cancels drift between runs.  In each,
ROOT's own ``chip_smoke.py`` and ``flashattention_tpu_torch`` build the
serving kernels the phases launch (their tensor-core forms where ROOT has
them), time paged_decode at its d = 128 check shape (``paged_checks``: B =
4, 32 KV heads, G = 1, page 256, lengths 1/256/257/1088, bfloat16, L2
flushed between calls; the form a bf16 call takes in ROOT, which is the
tensor-core ``paged_decode_tc`` where ROOT has it) and run the ``serve``
and ``serve_chunked`` phases at Llama-7B width (32 layers, bfloat16, random
weights from seed 0), whose profiles give paged decode's device time in
the engine (224 calls each; both forms' kernels, the merge kernel
included).  One JSON line per ROOT, and all of them in
``chiprun_out/decode_ab.json``.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time


def one(root: str) -> dict:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from flashattention_tpu_torch.models import transformer
    from flashattention_tpu_torch.ops import backward, decode, flash, kernels
    from flashattention_tpu_torch.runtime import engine as engine_mod
    from flashattention_tpu_torch.runtime import kvcache
    from flashattention_tpu_torch.utils import benchit

    for mod in (cs, decode):
        if not os.path.abspath(mod.__file__).startswith(root + os.sep):
            raise RuntimeError(f"{mod.__name__} came from {mod.__file__}, not {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    report = {"card": benchit.card_info(), "device": name, "build": {}, "checks": []}
    t0 = time.perf_counter()
    kernels.build_all([k for k in ("flash_fwd", "flash_fwd_tc", "paged_decode", "paged_decode_tc",
                                   "paged_prefill", "paged_prefill_tc") if k in kernels.KERNELS])
    build_s = time.perf_counter() - t0
    gen = torch.Generator(device="cuda").manual_seed(0)
    dec = cs.paged_checks(decode, benchit, gen, name, report)
    dec = report.get("tc_timed", {}).get("paged_decode_tc", dec)  # the form bf16 takes
    counters = cs._counters(flash, decode, backward)
    args = argparse.Namespace(seed=0, layers=32)
    cfg = dataclasses.replace(transformer.ModelConfig.llama7b_attention(), num_layers=32)
    params = transformer.init_params(0, cfg)
    serve = cs.phase_serve(args, cfg, params, engine_mod, kvcache, counters, report)
    chunked = cs.phase_serve_chunked(args, cfg, params, engine_mod, kvcache, counters, report)
    prof = {tag: report[key] for tag, key in (("serve", "profile"), ("serve_chunked", "profile_chunked"))}
    return {
        "root": root, "card": report["card"], "build_s": build_s,
        "checks_ok": all(c["ok"] for c in report["checks"]),
        "paged_decode_check": dec["check"],
        "paged_decode_ms": dec["kernel_ms"], "paged_decode_plain_ms": dec["plain_ms"],
        **{f"{tag}_ok": rec["ok"] for tag, rec in (("serve", serve), ("serve_chunked", chunked))},
        **{f"{tag}_decode_step_ms": rec["decode_step_ms"]
           for tag, rec in (("serve", serve), ("serve_chunked", chunked))},
        **{f"{tag}_profile": {
            "wall_ms": p["wall_ms"], "device_busy_ms": p["device_busy_ms"],
            "device_idle_share": p["device_idle_share"],
            "paged_decode_device_ms": sum(p["kernel_device_ms"].get(k, 0.0)
                                          for k in ("paged_decode", "paged_decode_tc")),
            "top_kernels": p["top_kernels"],
        } for tag, p in prof.items()},
    }


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
            print(f"decode_ab: {root} failed (exit {proc.returncode})", file=sys.stderr)
            failed = True
            continue
        rec = json.loads(lines[-1])
        rec["order"] = len(results)
        results.append(rec)
        brief = {k: v for k, v in rec.items() if not isinstance(v, dict)}
        brief.update({f"{t}_paged_decode_device_ms": rec[f"{t}_profile"]["paged_decode_device_ms"]
                      for t in ("serve", "serve_chunked")})
        print(json.dumps(brief), flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "decode_ab.json"), "w") as fh:
        json.dump(results, fh, indent=1)
    ok = not failed and all(r["checks_ok"] and r["serve_ok"] and r["serve_chunked_ok"]
                            for r in results)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
