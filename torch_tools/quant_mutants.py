#!/usr/bin/env python3
"""Mutation check of ``chip_smoke.py``'s 8-bit kernel checks, on one card.

    python3 torch_tools/quant_mutants.py [--keep]

Copies the port (``flashattention_tpu_torch/`` and ``chip_smoke.py``) into a
temporary directory once per mutant, breaks one thing in the 8-bit form of
one serving kernel in the copy's CUDA sources, builds the copy's 8-bit
kernel libraries (``*_quant``, paged decode's one per head_dim; one
``nvcc`` per library and copy, all started together) and runs chip_smoke's checks of that kernel on the copy
over int8 and fp8 K/V, q in bfloat16 and float32, at every shape they hold,
under ``ops.flash.scalar_forms`` so that they hold the scalar 8-bit forms
this tool mutates (float32 q over 8-bit K/V is taken in bf16 there too, as
on the serving route)
(the main shapes, and the windowed models': Gemma-2's d = 256 with window
4096 and softcap 50, Mistral's d = 128 with window 4096).  The copies of the
paged kernels, and the unmutated one, also run chip_smoke's parity_quant
phase (int8 weights and cache, card against CPU, whole-prompt and chunked)
and report its logits error against PARITY_QUANT_TOL.  The copies:

- ``unmutated``: the sources as they are; every check must pass;
- ``v_scale_dropped/<kernel>``: V rows are used unscaled (the raw payload);
- ``k_scale_neighbour/<kernel>``: each K row takes the scale of the next
  token's row;
- ``kv_scales_swapped/<kernel>``: K rows take the V scales and V rows the K
  scales.

A mutant is caught when, in bfloat16 and in float32, a check of the kernel
it changed fails at a main shape and one fails at Gemma-2's shape.  Prints
one JSON line per copy (its failed checks with their errors, its parity
readings) and writes all of them to ``chiprun_out/quant_mutants.json``;
exits non-zero when a mutant goes uncaught or the unmutated copy fails a
check or its parity.
The copies live in a temporary directory, removed at the end unless
``--keep``.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKS = {  # kernel -> chip_smoke's checks of it: main shapes, windowed models'
    "flash_fwd": ("flash_checks", "flash_window_checks"),
    "paged_decode": ("paged_checks", "paged_window_checks"),
    "paged_prefill": ("prefill_checks", "prefill_window_checks"),
}
PARITY = ("paged_decode", "paged_prefill")  # the kernels parity_quant runs 8-bit
SOURCES = {k: f"{k}.cu" for k in CHECKS}
# kernel -> mutant -> [(text, replacement)] in the kernel's source
EDITS = {
    "flash_fwd": {
        "v_scale_dropped": [("vx = fa::scale4(fa::load4(v_head + off), vs_head[col]);",
                             "vx = fa::load4(v_head + off);")],
        "k_scale_neighbour": [("fa::load4(k_head + off), ks_head[col])",
                               "fa::load4(k_head + off), ks_head[col + 1])")],
        "kv_scales_swapped": [(
            "const float* ks_head = kQuant ? k_scales + static_cast<size_t>(bh) * s_kv : nullptr;\n"
            "  const float* vs_head = kQuant ? v_scales + static_cast<size_t>(bh) * s_kv : nullptr;",
            "const float* ks_head = kQuant ? v_scales + static_cast<size_t>(bh) * s_kv : nullptr;\n"
            "  const float* vs_head = kQuant ? k_scales + static_cast<size_t>(bh) * s_kv : nullptr;")],
    },
    "paged_decode": {
        "v_scale_dropped": [("kQuant ? vs[j] : 1.f", "1.f")],
        "k_scale_neighbour": [("kQuant ? ks[j] : 1.f", "kQuant ? ks[j + 1] : 1.f")],
        "kv_scales_swapped": [(
            "const float* ks = kQuant ? k_scales + scale_row : nullptr;\n"
            "    const float* vs = kQuant ? v_scales + scale_row : nullptr;",
            "const float* ks = kQuant ? v_scales + scale_row : nullptr;\n"
            "    const float* vs = kQuant ? k_scales + scale_row : nullptr;")],
    },
    "paged_prefill": {
        "v_scale_dropped": [("vx = fa::scale4(vx, col_vs[j]);", "(void)col_vs;")],
        "k_scale_neighbour": [("col_ks[tid] = off >= 0 ? k_scales[off / D] : 0.f;",
                               "col_ks[tid] = off >= 0 ? k_scales[off / D + 1] : 0.f;")],
        "kv_scales_swapped": [(
            "col_ks[tid] = off >= 0 ? k_scales[off / D] : 0.f;\n"
            "        col_vs[tid] = off >= 0 ? v_scales[off / D] : 0.f;",
            "col_ks[tid] = off >= 0 ? v_scales[off / D] : 0.f;\n"
            "        col_vs[tid] = off >= 0 ? k_scales[off / D] : 0.f;")],
    },
}
# name -> (kernels it changes, [(source, text, replacement)])
MUTANTS = {"unmutated": (tuple(CHECKS), [])}
MUTANTS.update({
    f"{m}/{k}": ((k,), [(SOURCES[k], t, r) for t, r in edits])
    for k, muts in EDITS.items() for m, edits in muts.items()
})


def make_copy(dest: str, edits) -> None:
    shutil.copytree(os.path.join(REPO, "flashattention_tpu_torch"),
                    os.path.join(dest, "flashattention_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), dest)
    for source, text, replacement in edits:
        path = os.path.join(dest, "flashattention_tpu_torch", "csrc", source)
        with open(path) as fh:
            code = fh.read()
        if code.count(text) != 1:
            raise RuntimeError(f"{source}: expected one {text!r}, found {code.count(text)}")
        with open(path, "w") as fh:
            fh.write(code.replace(text, replacement))


def _group(check: str) -> str:
    """Which shape a check holds: Gemma-2's, Mistral's or a main one."""
    return "gemma2" if "gemma2_d256" in check else "mistral" if "mistral" in check else "main"


def run_checks(root: str, names, parity: bool) -> dict:
    """In this process: chip_smoke's 8-bit checks of ``names`` on the copy
    at ``root``, and with ``parity`` its parity_quant phase."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    import flashattention_tpu_torch as fa
    from flashattention_tpu_torch.models import transformer
    from flashattention_tpu_torch.ops import decode, flash, quant
    from flashattention_tpu_torch.runtime import engine, kvcache
    from flashattention_tpu_torch.utils import benchit

    if not os.path.abspath(decode.__file__).startswith(root + os.sep):
        raise RuntimeError(f"decode came from {decode.__file__}, not {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = torch.cuda.get_device_name(0)
    report = {"checks": []}
    for name in names:
        mods = (fa, flash) if name == "flash_fwd" else (decode,)
        for form in cs.QUANT_FORMS:
            for fn in CHECKS[name]:
                gen = torch.Generator(device="cuda").manual_seed(0)
                with flash.scalar_forms():
                    getattr(cs, fn)(*mods, benchit, gen, card, report, form)
    out = {"checks": {c["check"]: {k: c.get(k) for k in ("ok", "max_abs_err", "elem_err")}
                      for c in report["checks"]}}
    if parity:
        cs.phase_parity_quant(argparse.Namespace(seed=0), transformer, quant, kvcache, engine, report)
        out["parity"] = {p: {k: report[p][k] for k in ("ok", "max_abs_err", "tol")}
                         for p in ("parity_quant", "parity_quant_chunked")}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--keep", action="store_true", help="keep the copies")
    ap.add_argument("--one", nargs="+", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        root, parity, *names = args.one
        print(json.dumps(run_checks(root, names, parity == "parity")), flush=True)
        return 0
    tmp = tempfile.mkdtemp(prefix="quant_mutants-")
    try:
        roots = {m: os.path.join(tmp, m.replace("/", "-")) for m in MUTANTS}
        parity = {m: any(n in PARITY for n in names) for m, (names, _) in MUTANTS.items()}
        for m, (_, edits) in MUTANTS.items():
            make_copy(roots[m], edits)
        builds = {  # parity's whole-prompt prefill runs flash_fwd's unquantized form
            m: subprocess.Popen([sys.executable, "-c", (
                "import re, sys; sys.path.insert(0, sys.argv[1]); "
                "from flashattention_tpu_torch.ops import kernels; "
                "kernels.build_all([k for k in kernels.KERNELS "
                "if any(re.fullmatch(n + r'(_d\\d+)?', k) for n in sys.argv[2:])])"),
                roots[m], *(f"{n}_quant" for n in names), *(["flash_fwd"] if parity[m] else [])])
            for m, (names, _) in MUTANTS.items()
        }
        if any(p.wait() != 0 for p in builds.values()):
            print("quant_mutants: a build failed", file=sys.stderr)
            return 1
        results, ok = {}, True
        for m, (names, _) in MUTANTS.items():
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--one", roots[m],
                 "parity" if parity[m] else "-", *names],
                stdout=subprocess.PIPE, text=True)
            lines = proc.stdout.strip().splitlines()
            if proc.returncode != 0 or not lines:
                print(f"quant_mutants: {m} did not run (exit {proc.returncode})", file=sys.stderr)
                return 1
            res = json.loads(lines[-1])
            checks = res["checks"]
            failed = {c: r for c, r in checks.items() if not r["ok"]}
            caught = None if m == "unmutated" else {
                dt: all(any(c.endswith(f"/{dt}") and _group(c) == g for c in failed)
                        for g in ("main", "gemma2"))
                for dt in ("bfloat16", "float32")}
            readings = res.get("parity")
            parity_ok = readings is None or all(r["ok"] for r in readings.values())
            if m == "unmutated":
                ok = ok and not failed and parity_ok
            else:
                ok = ok and all(caught.values())
            rec = {"copy": m, "kernels": list(names), "checks": len(checks),
                   "failed": failed, "caught": caught, "parity": readings,
                   "parity_caught": None if readings is None or m == "unmutated" else not parity_ok}
            results[m] = {**rec, "all": checks}
            print(json.dumps(rec), flush=True)
        os.makedirs("chiprun_out", exist_ok=True)
        with open(os.path.join("chiprun_out", "quant_mutants.json"), "w") as fh:
            json.dump(results, fh, indent=1)
        print(json.dumps({"quant_mutants_ok": ok}), flush=True)
        return 0 if ok else 1
    finally:
        if not args.keep:
            shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
