#!/usr/bin/env python3
"""Hold the tensor-core forward and its plain mirror against a float64
oracle on the inputs of ``flash_fwd_tc/d128_s1000_w300_cap30_q8/bfloat16``,
on one card.

    python3 torch_tools/c5_oracle.py [--variants NAME ...]
    python3 torch_tools/c5_oracle.py --sweep N

The check is ``chip_smoke.bwd_window_checks``' forward check at d = 128,
window 300, softcap 30, q x 8 (B = 1, 8 KV heads x G = 2, S = 1000).  Its
inputs are drawn as ``torch_tools/tc_mutants.py``'s unmutated copy draws
them beside a mutant of the two-pass pair: ``tc_mutants.run_checks`` of the
pair's kind from a fresh generator (seed 0), stopped at that check.  On
them, in a copy of the port (and in one copy per variant, each a different
summation of the PV product in ``csrc/flash_fwd_tc.cuh``):

- the check itself: the kernel's bf16 O against ``flash_attention_plain``'s
  (``chip_smoke.elem_err`` under ``BF16_ELEM_TOL``; it passes at <= 1);
- the kernel's O in float32 (the paged form of the same template,
  ``paged_prefill_tc``, over pages holding the same rows, with float32 q
  of the same bf16 values: O straight from its float32 sums) and the
  mirror's in float32, each against ``tc64``, the mirror's terms (p against
  the running max of 128-column tiles, as two bf16 terms, times the rescale)
  summed in float64, and against the exact softmax in float64; the errors
  over the row's mass ``sum_j p_j |v_j| / l``, the largest and their mean
  signed toward zero (negative: sums that shrink toward zero);
- row 1's ``flash_fwd_tc`` time (B = 4, 32 heads, S = 1024, d = 128,
  causal, bf16) and the registers and spills of its d = 128 instantiation.

One JSON line per copy; all in ``chiprun_out/c5_oracle.json``, and the
inputs with the unvaried kernel's float32 O in ``chiprun_out/c5_inputs.pt``.

``--sweep N``: N fresh draws of the check's inputs (seeds 0 .. N-1, q x 8,
bf16), each held kernel against mirror under the check's gate, with the
mirror's S summed two ways: in float32 (torch's einsum, its own order) and
exactly (float64, rounded once to float32, as the tensor cores' float32
accumulator holds the exact products' sum; ``flash_attention_plain``'s
since this measurement); also against ``flash_attention_plain`` as this
tree has it.  Writes
``chiprun_out/c5_sweep.json``.  Imports nothing of JAX.
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
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import tc_mutants  # noqa: E402

CHECK = "flash_fwd_tc/d128_s1000_w300_cap30_q8/bfloat16"
_DB = ("const uint64_t db = tc::make_desc(\n"
       "                v_base + c * C::kKVChunk + kk * 16 * tc::kChunkRowBytes, C::kKVChunk, 1024);")
_ADD = ("#pragma unroll\n"
        "          for (int x = 0; x < 32; ++x) {\n"
        "            const int at = 32 * (c % kLC) + x;\n"
        "            if constexpr (kLocal) acc[ch][at] += part[x] * (x % 4 < 2 ? beta_a : beta_b);\n"
        "            else acc[ch][at] += part[x];\n"
        "          }\n")
_PV = ("          float part[32];\n"
       "          tc::wgmma_fence();\n"
       "#pragma unroll\n"
       "          for (int kk = 0; kk < kN / 16; ++kk) {\n"
       f"            {_DB}\n"
       "            tc::wgmma_rs<1>(part, pa[kk], db, kk > 0);\n"
       "            if (p_lo) tc::wgmma_rs<1>(part, pl[kk], db, 1);\n"
       "          }\n"
       "          tc::wgmma_commit();\n"
       "          tc::wgmma_wait<0>();\n"
       "          tc::fence_regs(part);\n" + _ADD)
_WAIT = "          tc::wgmma_commit();\n          tc::wgmma_wait<0>();\n          tc::fence_regs(part);\n"
# name -> the PV block that replaces _PV
VARIANTS = {
    # P's second terms first, into the part while it is small, then the first terms.
    "lo_first": (
        "          float part[32];\n          tc::wgmma_fence();\n#pragma unroll\n"
        "          for (int kk = 0; kk < kN / 16; ++kk) {\n"
        f"            {_DB}\n"
        "            if (p_lo) tc::wgmma_rs<1>(part, pl[kk], db, kk > 0);\n          }\n"
        "#pragma unroll\n          for (int kk = 0; kk < kN / 16; ++kk) {\n"
        f"            {_DB}\n"
        "            tc::wgmma_rs<1>(part, pa[kk], db, p_lo || kk > 0);\n          }\n"
        + _WAIT + _ADD),
    # p_lo V into an accumulator of its own, both added to O in float32.
    "lo_own": (
        "          float part[32], part_lo[32];\n          tc::wgmma_fence();\n#pragma unroll\n"
        "          for (int kk = 0; kk < kN / 16; ++kk) {\n"
        f"            {_DB}\n"
        "            tc::wgmma_rs<1>(part, pa[kk], db, kk > 0);\n"
        "            if (p_lo) tc::wgmma_rs<1>(part_lo, pl[kk], db, kk > 0);\n          }\n"
        + _WAIT + "          if (p_lo) tc::fence_regs(part_lo);\n"
        + _ADD.replace("+= part[x] *", "+= (p_lo ? part[x] + part_lo[x] : part[x]) *")
        .replace("+= part[x];", "+= p_lo ? part[x] + part_lo[x] : part[x];")),
    # The tile's k-steps in two halves, each summed afresh and added to O.
    "halves": (
        "#pragma unroll\n          for (int h = 0; h < 2; ++h) {\n"
        "          float part[32];\n          tc::wgmma_fence();\n#pragma unroll\n"
        "          for (int kk = h * kN / 32; kk < (h + 1) * kN / 32; ++kk) {\n"
        f"            {_DB}\n"
        "            tc::wgmma_rs<1>(part, pa[kk], db, kk > h * kN / 32);\n"
        "            if (p_lo) tc::wgmma_rs<1>(part, pl[kk], db, 1);\n          }\n"
        + _WAIT + _ADD + "          }\n"),
    # Both: second terms first, in two halves.
    "lo_first_halves": (
        "#pragma unroll\n          for (int h = 0; h < 2; ++h) {\n"
        "          float part[32];\n          tc::wgmma_fence();\n"
        "          const int k0 = h * kN / 32, k1 = (h + 1) * kN / 32;\n#pragma unroll\n"
        "          for (int kk = k0; kk < k1; ++kk) {\n"
        f"            {_DB}\n"
        "            if (p_lo) tc::wgmma_rs<1>(part, pl[kk], db, kk > k0);\n          }\n"
        "#pragma unroll\n          for (int kk = k0; kk < k1; ++kk) {\n"
        f"            {_DB}\n"
        "            tc::wgmma_rs<1>(part, pa[kk], db, p_lo || kk > k0);\n          }\n"
        + _WAIT + _ADD + "          }\n"),
}
LIBS = ["flash_fwd_tc", "paged_prefill_tc"]
PTXAS = "flash_fwd_tc_kernel<128>"


def capture(root: str, path: str) -> None:
    """The check's inputs, drawn as tc_mutants' unmutated copy draws them."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs

    class Done(Exception):
        pass

    fwd_rec, got = cs._fwd_rec, {}

    def spy(check, flash, q, k, v, kw, segs, dt, **extra):
        rec, plain = fwd_rec(check, flash, q, k, v, kw, segs, dt, **extra)
        if check == CHECK:
            got.update(q=q.cpu(), k=k.cpu(), v=v.cpu(), kw=kw, rec=rec)
            raise Done
        return rec, plain

    cs._fwd_rec = spy
    try:
        tc_mutants.run_checks(root, tc_mutants.PAIR)
    except Done:
        pass
    if not got:
        raise RuntimeError(f"{CHECK} was not reached")
    torch.save(got, path)
    print(json.dumps({"captured": CHECK, "rec": got["rec"]}), flush=True)


def _paged_f32(decode, q, k, v, kw, ps=128):
    """The forward's O in float32 from the paged form of the same template:
    pages of ``ps`` rows holding k and v (zeros past S), one request whose
    chunk is all of q's rows, float32 q of q's bf16 values."""
    import torch

    bh, s, d = k.shape
    npg = -(-s // ps)

    def pool(x):
        x = torch.nn.functional.pad(x, (0, 0, 0, npg * ps - s))
        return x.view(bh, npg, ps, d).transpose(0, 1).contiguous()

    table = torch.arange(npg, dtype=torch.int32, device=q.device)[None]
    ctx = torch.tensor([s], dtype=torch.int32, device=q.device)
    return decode.paged_prefill_attention_batched(
        q.float()[None], pool(k), pool(v), table, ctx, chunk=s, seg=kw["q_seq_len"],
        scale=kw["scale"], window=kw["window"], logit_softcap=kw["logit_softcap"])[0]


def _oracles(flash, q, k, v, kw):
    """(exact, tc64, mass, terms) in float64: the exact softmax's O; the
    mirror's own float32 terms (``flash._fwd_plain_heads``, form "tc": p
    against the running max of the KV tiles as two bf16 terms, the rescale,
    l) summed in float64; sum_j p_j |v_j| / l; and those terms."""
    import torch

    from flashattention_tpu_torch.ops.reference import DEFAULT_MASK_VALUE, softcap

    bh, rows, d = q.shape
    s_kv = k.shape[1]
    mask = flash.visible(rows, s_kv, causal=True, kv_len=s_kv, q_offset=0,
                         q_seq_len=kw["q_seq_len"], window=kw["window"], device=q.device)
    s = softcap(torch.einsum("bqd,bkd->bqk", q.double(), k.double()).float() * kw["scale"],
                kw["logit_softcap"])
    s = torch.where(mask, s, torch.tensor(DEFAULT_MASK_VALUE, device=q.device))
    m = s.amax(-1)
    l = flash._exp(s - m[..., None]).double().sum(-1, keepdim=True)
    tile = flash.TC_KV_TILE[d]
    nt = -(-s_kv // tile)
    padded = torch.nn.functional.pad(s, (0, nt * tile - s_kv), value=DEFAULT_MASK_VALUE)
    m_run = padded.view(bh, rows, nt, tile).amax(-1).cummax(-1).values
    m_run = m_run.repeat_interleave(tile, dim=-1)[..., :s_kv]
    p = flash._exp(s - m_run)
    resc = flash._exp(m_run - m[..., None])
    w = flash._two_term_bf16(p).double() * resc.double()
    v64 = v.double()
    tc64 = w @ v64 / l
    s64 = torch.einsum("bqd,bkd->bqk", q.double(), k.double()) * kw["scale"]
    s64 = kw["logit_softcap"] * torch.tanh(s64 / kw["logit_softcap"])
    p64 = torch.exp(s64.masked_fill(~mask, -float("inf")) - s64.masked_fill(~mask, -float("inf"))
                    .amax(-1, keepdim=True))
    l64 = p64.sum(-1, keepdim=True)
    exact, mass = p64 @ v64 / l64, p64 @ v64.abs() / l64
    return exact, tc64, mass, dict(p=p, resc=resc, l=l)


def _one_column(diff, v, terms, b, r):
    """The key column whose V row best explains ``diff`` (a (d,) float64
    difference of two O rows): least squares of diff on each V row, the
    share of diff's norm left over, and that column's p (float32, against
    the running max), its bf16 terms and the unit of its second term."""
    import torch

    V = v[b].double()
    coef = V @ diff / (V * V).sum(-1).clamp_min(1e-30)
    left = (diff[None] - coef[:, None] * V).norm(dim=-1) / diff.norm().clamp_min(1e-30)
    j = int(left.argmin())
    pj = terms["p"][b, r, j]
    hi = pj.to(torch.bfloat16).float()
    lo = (pj - hi).to(torch.bfloat16).float()
    unit = 2.0 ** (float(torch.floor(torch.log2(lo.abs().clamp_min(1e-38)))) - 7)
    scale = float(terms["resc"][b, r, j] / terms["l"][b, r, 0])
    return {"column": j, "coef": float(coef[j]), "left_share": float(left[j]),
            "p": float(pj), "p_hi": float(hi), "p_lo": float(lo), "lo_unit": unit,
            "coef_in_lo_units": float(coef[j]) / (unit * scale)}


def _against(x, ref, mass, cs):
    import torch

    e = x.double() - ref
    toward = e * torch.sign(ref)  # negative: |x| below |ref|
    atol, rtol = cs.BF16_ELEM_TOL
    return {"max_abs": float(e.abs().max()), "max_over_mass": float((e.abs() / mass).max()),
            "mean_toward_over_mass": float((toward / mass).mean()),
            "elem_err": float((e.abs() / (atol + rtol * ref.abs())).max())}


def evaluate(root: str, path: str, keep: str | None) -> dict:
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from flashattention_tpu_torch.ops import decode, flash, kernels
    from flashattention_tpu_torch.utils import benchit

    torch.backends.cuda.matmul.allow_tf32 = False
    built = kernels.build_all(LIBS)
    ptxas = [r for r in cs._ptxas(built["flash_fwd_tc"]["log"]) if r["kernel"] == PTXAS]
    d = torch.load(path)
    q, k, v, kw = d["q"].cuda(), d["k"].cuda(), d["v"].cuda(), d["kw"]
    got = flash.flash_attention(q, k, v, **kw)
    want = flash.flash_attention_plain(q, k, v, **kw)
    worst = int(((got.float() - want.float()).abs()
                 / (cs.BF16_ELEM_TOL[0] + cs.BF16_ELEM_TOL[1] * want.float().abs())).argmax())
    o32 = _paged_f32(decode, q, k, v, kw)
    mirror = flash.flash_attention_plain(q.float(), k.float(), v.float(), form="tc", **kw)
    exact, tc64, mass, terms = _oracles(flash, q, k, v, kw)
    torch.cuda.synchronize()
    b, r, c = (int(i) for i in torch.unravel_index(torch.tensor(worst), got.shape))
    at = {n: float(x.reshape(-1)[worst]) for n, x in (
        ("want", want), ("got", got), ("kernel_f32", o32), ("mirror_f32", mirror),
        ("tc64", tc64), ("exact", exact), ("mass", mass))}
    rec = {
        "gate_elem_err": cs.elem_err(got, want), "worst": worst, "at_worst": at,
        "paged_bf16_differs_from_flat": int((o32.to(torch.bfloat16) != got).sum()),
        "kernel_vs_tc64": _against(o32, tc64, mass, cs),
        "mirror_vs_tc64": _against(mirror, tc64, mass, cs),
        "kernel_vs_exact": _against(o32, exact, mass, cs),
        "mirror_vs_exact": _against(mirror, exact, mass, cs),
        "ptxas": ptxas,
        "worst_row_kernel_minus_mirror": _one_column(
            (o32 - mirror)[b, r].double(), v, terms, b, r),
        "worst_row_mirror_minus_tc64": _one_column(
            mirror[b, r].double() - tc64[b, r], v, terms, b, r),
        "worst_row_kernel_minus_tc64": _one_column(
            o32[b, r].double() - tc64[b, r], v, terms, b, r),
    }
    gen = torch.Generator(device="cuda").manual_seed(0)
    r1 = [torch.randn((128, 1024, 128), generator=gen, device="cuda").to(torch.bfloat16)
          for _ in range(3)]
    run = lambda: flash.flash_attention(*r1, causal=True, scale=128**-0.5)  # noqa: E731
    rec["row1_ms"] = min(benchit.cuda_time_ms(run, warmup=5, iters=200) for _ in range(3))
    rec["card"] = torch.cuda.get_device_name(0)
    if keep:
        torch.save({"q": q.cpu(), "k": k.cpu(), "v": v.cpu(), "kw": kw,
                    "kernel_f32": o32.cpu(), "got": got.cpu(), "want": want.cpu()}, keep)
    return rec


def _mirror(flash, q, k, v, kw, exact_s):
    """The ``"tc"`` mirror of these inputs (no segment ids, dropout or
    block mask), S summed in float32 or exactly (float64, rounded once)."""
    import torch

    from flashattention_tpu_torch.ops.reference import DEFAULT_MASK_VALUE, softcap

    bh, rows, d = q.shape
    s_kv = k.shape[1]
    mask = flash.visible(rows, s_kv, causal=True, kv_len=s_kv, q_offset=0,
                         q_seq_len=kw["q_seq_len"], window=kw["window"], device=q.device)
    x = torch.float64 if exact_s else torch.float32
    s = torch.einsum("bqd,bkd->bqk", q.to(x), k.to(x)).float()
    s = softcap(s * kw["scale"], kw["logit_softcap"])
    s = torch.where(mask, s, torch.tensor(DEFAULT_MASK_VALUE, device=q.device))
    m = s.amax(-1)
    l = flash._exp(s - m[..., None]).sum(-1)
    tile = flash.TC_KV_TILE[d]
    nt = -(-s_kv // tile)
    padded = torch.nn.functional.pad(s, (0, nt * tile - s_kv), value=DEFAULT_MASK_VALUE)
    m_run = padded.view(bh, rows, nt, tile).amax(-1).cummax(-1).values
    m_run = m_run.repeat_interleave(tile, dim=-1)[..., :s_kv]
    p = flash._two_term_bf16(flash._exp(s - m_run)) * flash._exp(m_run - m[..., None])
    return torch.einsum("bqk,bkd->bqd", p, v.float()) / l[..., None]


def sweep(n: int) -> dict:
    import torch

    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from flashattention_tpu_torch.ops import decode, flash

    torch.backends.cuda.matmul.allow_tf32 = False
    name, c = next(x for x in cs.BWD_WINDOW_CASES if x[0] == CHECK.split("/")[1])
    bh, rows, s, d = c["b"] * c["kvh"], c["g"] * c["s_q"], c["s_kv"], c["d"]
    kw = dict(causal=True, scale=d**-0.5, kv_len=None, q_offset=0, q_seq_len=c["s_q"],
              window=c["window"], logit_softcap=c["cap"])
    recs = []
    for seed in range(n):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        q, k, v = ((mult * torch.randn(shape, generator=gen, device="cuda")).to(torch.bfloat16)
                   for shape, mult in (((bh, rows, d), c["q_mult"]), ((bh, s, d), 1.0),
                                       ((bh, s, d), 1.0)))
        got = flash.flash_attention(q, k, v, **kw)
        o32 = _paged_f32(decode, q, k, v, kw)
        rec = {"seed": seed, "tree": cs.elem_err(got, flash.flash_attention_plain(q, k, v, **kw))}
        for key, exact in (("float32_sum", False), ("exact_sum", True)):
            want = _mirror(flash, q, k, v, kw, exact)
            rec[key] = cs.elem_err(got, want.to(torch.bfloat16))
            rec[key + "_f32"] = cs.elem_err(o32, want)
        recs.append(rec)
        print(json.dumps(rec), flush=True)
    out = {"card": torch.cuda.get_device_name(0), "draws": recs}
    for key in ("tree", "float32_sum", "exact_sum", "float32_sum_f32", "exact_sum_f32"):
        vals = sorted(r[key] for r in recs)
        out[key] = {"max": vals[-1], "median": vals[len(vals) // 2],
                    "over_gate": sum(x > 1.0 for x in vals)}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", nargs="*", choices=list(VARIANTS), default=list(VARIANTS))
    ap.add_argument("--sweep", type=int, help="draws of the check's inputs to hold (see above)")
    ap.add_argument("--capture", nargs=2, help=argparse.SUPPRESS)
    ap.add_argument("--eval", nargs="+", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.capture:
        capture(*args.capture)
        return 0
    if args.sweep:
        out = sweep(args.sweep)
        os.makedirs("chiprun_out", exist_ok=True)
        with open(os.path.join("chiprun_out", "c5_sweep.json"), "w") as fh:
            json.dump(out, fh, indent=1)
        print(json.dumps({k: v for k, v in out.items() if k != "draws"}), flush=True)
        return 0
    if args.eval:
        print(json.dumps(evaluate(args.eval[0], args.eval[1], (args.eval[2:] or [None])[0])),
              flush=True)
        return 0
    tmp = tempfile.mkdtemp(prefix="c5_oracle-")
    os.makedirs("chiprun_out", exist_ok=True)
    try:
        copies = {"as_is": []}
        copies.update({n: [("flash_fwd_tc.cuh", _PV, VARIANTS[n])] for n in args.variants})
        roots = {}
        for name, edits in copies.items():
            roots[name] = os.path.join(tmp, name)
            tc_mutants.make_copy(roots[name], edits)
        build = ("import sys; sys.path.insert(0, sys.argv[1]); "
                 "from flashattention_tpu_torch.ops import kernels; "
                 "kernels.build_all(sys.argv[2:] or None)")
        procs = [subprocess.Popen([sys.executable, "-c", build, roots[n], *([] if n == "as_is" else LIBS)])
                 for n in copies]
        if any(p.wait() != 0 for p in procs):
            print("c5_oracle: a build failed", file=sys.stderr)
            return 1
        inputs = os.path.join(tmp, "inputs.pt")
        me = os.path.abspath(__file__)
        subprocess.run([sys.executable, me, "--capture", roots["as_is"], inputs], check=True)
        out = {}
        for name in copies:
            keep = [os.path.abspath("chiprun_out/c5_inputs.pt")] if name == "as_is" else []
            proc = subprocess.run([sys.executable, me, "--eval", roots[name], inputs, *keep],
                                  stdout=subprocess.PIPE, text=True, check=True)
            out[name] = json.loads(proc.stdout.strip().splitlines()[-1])
            print(json.dumps({"copy": name, **out[name]}), flush=True)
        with open(os.path.join("chiprun_out", "c5_oracle.json"), "w") as fh:
            json.dump(out, fh, indent=1)
        return 0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
