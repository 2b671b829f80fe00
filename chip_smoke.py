#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``flashattention_tpu_torch``) on one card.

    python3 chip_smoke.py [--seed N] [--layers L]

Phases, each of which must pass (any failure exits non-zero):

1. build     - compile every CUDA kernel from ``flashattention_tpu_torch/csrc``
               (one nvcc per source, in parallel) and print the build seconds;
2. kernels   - hold each kernel against its plain PyTorch version on the card,
               in bfloat16 and float32, at the serving and training paths'
               shapes, and time kernel, plain version and (where one exists)
               the library call; the three backward kernels at the training
               layer's shape (Mistral-7B width: 32 q / 8 KV heads, d = 128,
               B = 8, S = 2048), with segment ids from packed documents for
               the two-pass pair, a ragged S and a kv_len / q_offset case;
               and the three serving kernels with the sliding window at the
               windowed models' shapes: d = 256 with window 4096 and softcap
               50 (Gemma-2-9B-class, G = 2; timed, with SDPA under the
               window mask as the library yardstick; again with q scaled
               by 8 so that the scores reach the cap) and d = 128 with
               window 4096 (Mistral-7B-class, G = 4), at lengths that cross
               the window (flash_fwd S = 5000; paged_decode lengths 1, 4096,
               4097, 6000; paged_prefill a 512-row chunk at contexts
               4608-6144); each bfloat16 element of the serving kernels'
               checks within two units in the last place (BF16_ELEM_TOL);
               ``torch_tools/window_mutants.py`` shows that these checks
               fail a kernel whose window is off by one or whose softcap is
               dropped; and the same checks of the serving kernels, every
               shape above, over their 8-bit forms (int8 and fp8 K/V with
               per-row scales, K/V row magnitudes spread over two decades;
               flash_fwd through ``attention(k_scales=, v_scales=)``),
               timed against SDPA over the K/V dequantized to bfloat16;
               ``torch_tools/quant_mutants.py`` shows that they fail a
               kernel with a dropped, shifted or swapped scale, at the
               main shapes and at Gemma-2's; and the three backward kernels
               at the windowed models' training layers (B = 1, S = 8192):
               Gemma-2's (d = 256, window 4096, softcap 50; timed, with
               SDPA's backward under the window mask) and Mistral's (d =
               128, window 4096; timed), each again with q scaled by 8, the
               Gemma-2 layer with segment ids for the two-pass pair, and d =
               16 over a ragged S = 300 with a window of 100, bfloat16
               elements within BF16_ELEM_TOL; ``torch_tools/bwd_mutants.py``
               shows that these fail a backward kernel whose window is off
               by one, whose softcap derivative is dropped or taken at the
               uncapped score, or that skips the last query tile a window
               reaches; and paged_decode's draft form (speculative
               verification, k = 4 rows per query head, k-minor) at the
               Llama (G = 1), Mistral (G = 4, window 4096), Gemma-2 (G = 2,
               d = 256, window 4096, softcap 50, also with q x 8), G = 8
               (32 rows per KV head) and window-2 shapes, lengths 4, 256,
               260, 4100 and 6000, its 8-bit forms at the Llama and Gemma-2
               shapes; timed there against its plain version, SDPA under an
               (R x S) mask and k launches of the k = 1 kernel;
               ``torch_tools/draft_mutants.py`` shows that these checks fail
               a draft form whose causal limit, row order, first page or
               per-row window is wrong; and attention dropout in the four
               kernels at rates 0.1 and 0.5 (``dropout_checks``: the
               training and packed layers, a ragged GQA S = 1000 through
               ``attention()``, Gemma-2's windowed layer, the int8 form;
               timed against the same kernel without dropout and SDPA with
               dropout_p) and block masks in flash_fwd and the two-pass
               backward (``block_mask_checks``: prefix-LM, 512-token
               documents and strided masks at Llama-7B's layer, S = 4096,
               and built at 4096 for S = 4000; timed against no mask and
               SDPA with the boolean mask; the documents mask within a
               quarter of the no-mask time; K/V rows only dead tiles touch
               poisoned with NaN); ``torch_tools/dropout_mutants.py`` shows
               that these fail each of nine dropout and block-mask mutants;
               in bf16 the flash forward (d = 64, 128, 256), the fused
               backward (d = 64, 128, 256) and paged prefill (d = 64, 128,
               256 on pages of 256 rows) run their tensor-core forms
               (``flash_fwd_tc``, ``flash_bwd_tc``, ``paged_prefill_tc``;
               ``ops.flash.kernel_form``), whose checks (named
               ``flash_fwd_tc/...``, ``flash_bwd_tc/...``,
               ``paged_prefill_tc/...``) hold them against plain versions
               that feed P, Z and dS to their products as the kernels do
               (two bf16 terms each) at every bf16 shape above,
               plus the forward at the training and packed layers (segment
               ids), and both with a window and a softcap at d = 128 over a
               ragged S = 1000; the timed ones carry
               the scalar form's time on the same inputs (``scalar_ms``,
               under ``ops.flash.scalar_forms``), and the scalar form's own
               check at row 1's shape, the training layer and paged
               prefill's MHA and Gemma-2 shapes keeps the scalar rows;
               ``prefill_poison_check`` fills every pool row no query row
               may see (past each ctx_len, pages past the live ones, rows
               before the window) with NaN, at Gemma-2's shape, GQA with
               seg > chunk and a 32-row page, and the tensor-core paged
               prefill's output must equal the clean pool's bit for bit
               (again over fp8 pools, the 8-bit form, whose such bytes are
               0x7F, e4m3's NaN, and scales NaN); in bf16 the 8-bit K/V of
               the flash forward and of paged prefill run the tensor-core
               forms' 8-bit forms (``flash_fwd_tc_quant``,
               ``paged_prefill_tc_quant``; checks ``flash_fwd_tc/quant/...``
               and ``paged_prefill_tc/quant/...``) at every 8-bit shape
               above, int8 and fp8, against the plain versions with their
               rounding, the timed ones beside the scalar 8-bit form, SDPA
               over the dequantized K/V and the bound;
               in bf16 the two-pass pair (d = 64, 128, 256, no block mask)
               runs its tensor-core forms (``flash_bwd_dq_tc``,
               ``flash_bwd_dkv_tc``: checks ``flash_bwd_dq_tc/...``,
               ``flash_bwd_dkv_tc/...``) at every bf16 pair shape above
               (the packed layer, the ragged S = 300 with PAD rows, kv_len /
               q_offset, d = 64 with segment ids, the windowed layers,
               Gemma-2's packed layer, dropout), each beside the scalar
               pair's check on the same inputs under
               ``ops.flash.scalar_forms``, with every element within
               BF16_ELEM_TOL; the pair's dQ must give the same bits in two
               launches; timed at the packed layer, Gemma-2's packed layer
               and with dropout beside the scalar pair and SDPA's masked
               backward, and at the plain training layer beside the fused
               form (``pair_vs_fused``, the JAX package's
               scripts/probe_fused_bwd.py A/B);
               ``torch_tools/tc_mutants.py`` shows that they fail each of
               twenty-three tensor-core mutants; ``head_dim_pad_check``: ``sdpa``
               at head_dim 80 (zero-padded to 128 by ``attention``),
               forward and gradients under autograd, against the same call
               on the CPU; the float32 forms the float32 paths launch
               (flash_fwd at row 1, paged prefill at its MHA shape, the
               fused backward at the training layer at B = 2) timed against
               their plain versions, SDPA in float32 and their bound;
   attention_block_mask - ``attention(block_mask=, dropout_rate=0.1)``
               under autograd at that layer, the launches counted;
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
5. serve_gemma2 - Gemma-2-9B-class (``ModelConfig.gemma2_9b``) at full
               width and its published 42 layers, bf16, on the default
               chunked engine (prefill_chunk=512, page_size 256, max_batch 4,
               24 pages per request, 80 pages): a donor with a 1024-token
               prefix and one prompt sharing it, two unique prompts of
               4600-5800 tokens, one short prompt; 32 new tokens each; all
               three serving kernels must launch layers x batches, rounds and
               steps; then a profile of 4 requests with 1536-token prompts;
   serve_gemma2_whole - the same model with whole-prompt prefill: two
               prompts of 4600-5000 tokens through flash_fwd's window;
   serve_int8 - serve_chunked's engine and prompts on int8 weights
               (quantized in place, layer by layer) and an int8 KV cache:
               the 8-bit forms of paged_prefill and paged_decode must
               launch; one layer's weight products timed against bf16
               weights; then a profile;
   serve_gemma2_fp8 - serve_gemma2 on an fp8 KV cache;
   serve_multistep - serve's model with ``run(multi_step=8)``: 4 prompts of
               100-1000 tokens, 33 new tokens (4 loops of 8), greedy and
               sampled, each equal to its ``multi_step=1`` run; the greedy
               loops run under ``torch.cuda.set_sync_debug_mode("error")``,
               so a host sync inside ``decode_loop`` fails the phase;
   serve_speculative - the same model and prompts with
               ``run_speculative(k=4)`` and oracle (all accepted), garbage
               (all rejected) and half-right drafts, then oracle drafts on
               an int8 cache; tokens equal to the plain run's, the draft
               form launched layers x verify steps;
               serve_speculative_gemma2 - Gemma-2-9B-class at 42 layers,
               two prompts past the window, oracle drafts;
6. crosscheck - the naive kernel's path: ``flash_attention_naive`` and the
               flash kernel through the public entry points on the same
               inputs, each launched once, agreeing; quant_ops - the same
               for ``attention_quantized`` and ``attention(k_scales=,
               v_scales=)``, the path of flash_fwd's 8-bit form;
7. parity    - one 64-token request through prefill and 4 decode steps on a
               2-layer float32 cut at the same width, on the card (kernels)
               and on the CPU (plain versions); and the same cut through the
               chunked engine (a 600-token prompt, then one sharing its first
               256 tokens); the logits must agree; parity_gemma2 does the
               same for Gemma-2-9B-class at full width in 2 float32 layers,
               its window cut to 128 so that a 300-token prompt crosses it;
               parity_quant (int8 weights and cache) and parity_quant_gemma2
               (fp8 cache) within PARITY_QUANT_TOL, reporting how many pool
               elements the two sides round to neighbouring steps;
               parity_speculative: ``verify_step`` logits at k = 4 on the
               2-layer float32 Llama and Gemma-2 (window 128) cuts, card
               against CPU and against the prefill logits at the fed
               positions, within PARITY_TOL;
8. train     - ``make_train_step`` at ``bench_train.py``'s configuration
               (Mistral-7B width, 2 layers, sliding_window=None, bf16, B = 8,
               S = 2048, random tokens from --seed, lr 1e-3), with remat off
               (train) and on (train_remat): one warm-up step, then 3 timed
               steps; step ms, tokens/s, model TFLOP/s and MFU by
               ``bench_train.py``'s accounting, peak memory; the launches
               must be the fused backward's (flash_bwd L per step, flash_fwd
               L, or 2 L with remat); then a profile of one step;
9. train_packed - ``make_train_step_packed`` on the same model over 8 rows
               packed from random documents of 64-2048 tokens: the two-pass
               backward (flash_bwd_dq and flash_bwd_dkv L per step, in
               their tensor-core forms);
   train_dropout, train_packed_dropout - train and train_packed with
               ``attn_dropout=0.1``, seed = step index: the kernels' dropout
               forms launch L times per step;
   train_mistral, train_gemma2 - the plain step on ``mistral7b`` (its
               window 4096) and ``gemma2_9b`` (window 4096, softcap 50,
               head_dim 256, vocab 256128) at full width in 2 layers, bf16,
               B = 1, S = 8192, so that the window bites; as train, with the
               attention flops counted over the window's live pairs, and a
               profile of one Gemma-2 step; train_gemma2_packed - the packed
               step on Gemma-2 over documents of 5000, 2100 and 1000 tokens;
10. train_parity - a 2-layer float32 cut at the same width (B = 1, S = 256):
               plain and packed steps, remat off and on, two steps each, on
               the card and on the CPU (plain versions) from the same
               parameters; losses, updated parameters and the first step's
               gradients must agree; train_parity_mistral_w128 and
               train_parity_gemma2_w128 the same for the windowed models at
               full width, their window cut to 128 (about 120 s of CPU work
               for Gemma-2's 256128-wide logits), and train_parity_dropout
               with ``attn_dropout=0.1``; one CPU run without remat is the
               reference of both card runs.

The serve and train phases' launch counts include the tensor-core forms':
every bf16 flash forward, fused backward and two-pass pair launch at their
head_dims (but the block-mask ones), and every paged prefill launch of a
bf16 model, goes through them (``launches_tc``; the pair's with dropout
also ``launches_tc_dropout``); the 8-bit caches' paged prefill (serve_int8,
serve_gemma2_fp8) and quant_ops' 8-bit flash forward through their 8-bit
forms (``launches_tc_quantized``).  The float32 train_parity phases' card launches are
counted as paths too (float32 training runs the scalar kernels).  It prints one JSON line per check, the
total seconds, a ``{"kernels": [...]}`` summary (with a ``quantized`` entry
for each serving kernel's 8-bit form, ``dropout`` and ``block_mask`` entries
for flash_fwd and the backward kernels, paged_decode's draft form and the
tensor-core forms and their 8-bit forms as entries of their own, each
entry counting its own launches only, the scalar ones a ``float32`` entry
where the float32 paths launch them), the card's name
and power limit, and last ``{"ok": true, "device": {...}}``.
Details go to ``chiprun_out/chip_smoke.json``.  It needs one CUDA card and
imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import re
import sys
import time

import numpy as np
import torch

FLASH_TOL = {"bfloat16": 2e-2, "float32": 1e-4}  # kernel vs plain, max abs
PAGED_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
PREFILL_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
NAIVE_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# Backward kernels vs the plain backward computed in float32 from the same
# (dtype-rounded) inputs: one rounding of each output, and the sums' order.
BWD_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
CROSS_TOL = 2e-2  # naive vs flash kernel, bfloat16 inputs and outputs
STATS_RTOL = 1e-5  # l, m residuals: max abs error over max |value|
# The bfloat16 checks of the serving kernels (_rec) also hold each element:
# |got - want| <= atol + rtol |want|.  At S ~ 5000 a row averages ~4096
# values of V, so its outputs are ~0.026 and the max-abs bound of 2e-2 alone
# would pass a wrong kernel; 8-bit rows of magnitude 0.01 give outputs as small.
# rtol is two units in the last place (the kernel and the plain version each
# round one float32 result); atol covers outputs near zero.  float32 keeps
# its max-abs bound of 1e-4, far below what a wrong window or softcap moves
# (torch_tools/window_mutants.py); an element bound there would have to
# admit ~3e-5 anyway, the order of the float32 sums at scores near 30.
BF16_ELEM_TOL = (1e-5, 2.0**-6)
PARITY_TOL = 1e-3  # float32 logits, card kernels vs CPU plain versions
# With 8-bit pages the card and the CPU can round a K/V value that lies at a
# half step to neighbouring steps (their float32 sums run in other orders),
# which moves the logits by more than float32 rounding: on the H100 the four
# 8-bit parity runs read 3.4e-4 to 1.0e-3 (one int8 step, at most 11 fp8
# codes apart), so the bound is 5x the largest.  Both sides are the port in
# float32, so the JAX suite's 8-bit bound (2e-2, tests/test_quant.py, which
# covers its kernels' bfloat16 rounding of q and p) would be 20x too loose.
# The runs report how many pool elements differ, and by how many steps.
PARITY_QUANT_TOL = 5e-3
# Training parity, float32, card vs CPU after two SGD steps: losses (relative)
# and updated parameters (absolute, tests/test_train.py's bound between two
# device layouts); and the first step's gradients, per tensor max error over
# max |gradient| (at lr 1e-3 the parameter bound alone would pass a wrong
# gradient; comparing updates instead would measure the rounding of p - lr g
# at |p| ~ 1, where one float32 ulp is 6e-8).
TRAIN_LOSS_RTOL = 1e-4
TRAIN_PARAM_TOL = 3e-5
TRAIN_GRAD_RTOL = 1e-3
TRAIN_B, TRAIN_S, TRAIN_STEPS = 8, 2048, 3
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

# (name, source in flashattention_tpu_torch/csrc/, the TPU kernel it
# replaces in flashattention_tpu/)
KERNELS = (
    ("flash_fwd", "flash_fwd.cu", "ops/flash.py:628"),
    ("paged_decode", "paged_decode.cu", "ops/decode.py:89"),
    ("paged_prefill", "paged_prefill.cu", "ops/decode.py:375"),
    ("flash_naive", "flash_naive.cu", "ops/flash.py:1690"),
    ("flash_bwd", "flash_bwd.cu", "ops/backward.py:401"),
    ("flash_bwd_dq", "flash_bwd_dq.cu", "ops/backward.py:146"),
    ("flash_bwd_dkv", "flash_bwd_dkv.cu", "ops/backward.py:269"),
    # The tensor-core forms (bf16 at their head_dims, 16-bit K/V, no block mask).
    ("flash_fwd_tc", "flash_fwd_tc.cu", "ops/flash.py:628"),
    ("flash_bwd_tc", "flash_bwd_tc.cu", "ops/backward.py:401"),
    ("paged_prefill_tc", "paged_prefill_tc.cu", "ops/decode.py:375"),
    # The two-pass pair's (the dK/dV pass: the fused source built with -DFA_PAIR).
    ("flash_bwd_dq_tc", "flash_bwd_dq_tc.cu", "ops/backward.py:146"),
    ("flash_bwd_dkv_tc", "flash_bwd_tc.cu", "ops/backward.py:269"),
    # Their 8-bit forms (bf16 q over int8 / fp8 K/V), built with -DFA_QUANT.
    ("flash_fwd_tc_quant", "flash_fwd_tc.cu", "ops/flash.py:628"),
    ("paged_prefill_tc_quant", "paged_prefill_tc.cu", "ops/decode.py:375"),
)
TC_KERNELS = {"flash_fwd": "flash_fwd_tc", "flash_bwd": "flash_bwd_tc",
              "paged_prefill": "paged_prefill_tc", "flash_bwd_dq": "flash_bwd_dq_tc",
              "flash_bwd_dkv": "flash_bwd_dkv_tc"}
PAIR = ("flash_bwd_dq", "flash_bwd_dkv")
TC_QUANT_KERNELS = {"flash_fwd": "flash_fwd_tc_quant", "paged_prefill": "paged_prefill_tc_quant"}
PAGE_SIZE = 256  # the serving phases' and the paged kernel checks' page


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def elem_err(got, want) -> float:
    """Largest |got - want| / (atol + rtol |want|) under BF16_ELEM_TOL; the
    check passes at <= 1."""
    atol, rtol = BF16_ELEM_TOL
    w = want.float()
    return float(((got.float() - w).abs() / (atol + rtol * w.abs())).max())


def _rec(check, got, want, dt, tol, **extra):
    """A kernel check's record: max abs error within ``tol`` and, in
    bfloat16, every element within BF16_ELEM_TOL."""
    e = err(got, want)
    rec = {"check": check, "max_abs_err": e, "tol": tol, "ok": e <= tol}
    if dt == "bfloat16":
        rec["elem_err"] = elem_err(got, want)
        rec["elem_tol"] = list(BF16_ELEM_TOL)
        rec["ok"] = rec["ok"] and rec["elem_err"] <= 1.0
    return {**rec, **extra}


_MANGLED_TYPES = {"13__nv_bfloat16": "bf16", "f": "f32", "a": "int8", "13__nv_fp8_e4m3": "fp8"}
# Each kernel's bool template arguments, in order (the others': window_cap, extra).
_FLAGS = {"paged_decode_kernel": ("window_cap", "draft"), "flash_fwd_kernel": ("extra",),
          "flash_fwd_tc_kernel": ("window_cap", "extra", "paged"),
          "flash_bwd_tc_kernel": ("window_cap", "extra", "pair"),
          "flash_bwd_tc_d256_kernel": ("window_cap", "extra", "pair")}


def _ptxas(log):
    """Registers and spill bytes of each kernel instantiation, from nvcc's
    ``-Xptxas -v`` report (``name<dtype[,payload],D[,G][,flags]>`` read off
    the mangled name: the payload type where it differs from q's, an 8-bit
    form's, and for the tensor-core forward its 8-bit payload; ``window_cap``
    marks a window/softcap form, ``draft``
    paged_decode's draft form, whose G is its tile of rows, and ``extra`` the
    dropout / block-mask form of flash_fwd and the backward kernels)."""
    out, spills = [], (0, 0)
    types = "|".join(["S\\d*_", *_MANGLED_TYPES])
    for ln in log.splitlines():
        m = re.search(rf"Compiling entry function '\w*?\d+(flash_bwd_tc_d256_kernel|[a-z_]+_kernel)I"
                      rf"((?:{types})*)((?:L[ib]\d+E)+)", ln)
        if m:
            args = [_MANGLED_TYPES[t] for t in re.findall("|".join(_MANGLED_TYPES), m.group(2))]
            args = args[:1] if args[1:] == args[:1] else args  # the payload is q's type
            flags = iter(_FLAGS.get(m.group(1), ("window_cap", "extra")))
            for kind, n in re.findall(r"L([ib])(\d+)E", m.group(3)):
                flag = next(flags) if kind == "b" else None
                args += [n] if kind == "i" else [flag] if n == "1" else []
            if m.group(1) == "flash_fwd_tc_kernel":  # its last int: the K/V payload form
                args = args[:-1] + {"1": ["int8"], "2": ["fp8"]}.get(args[-1], [])
            out.append({"kernel": f"{m.group(1)}<{','.join(args)}>"})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and out:
            out[-1].update(registers=int(m.group(1)), spill_stores=spills[0], spill_loads=spills[1])
    return out


def phase_build(kernels, report):
    t0 = time.perf_counter()
    built = kernels.build_all()
    seconds = time.perf_counter() - t0
    for name, info in built.items():
        report["build"][name] = {"seconds": info["seconds"], "ptxas": _ptxas(info["log"])}
    emit({"phase": "build", "seconds": seconds, "kernels": sorted(built),
          "card": report["card"]})


QUANT_FORMS = ("int8", "fp8")
# The library yardsticks of the 8-bit forms run on bfloat16 K/V.
_DEQUANT_NOTE = "; over K/V dequantized to bfloat16, dequantization not timed"


def _kv(gen, shape, dtype, form=None):
    """Random K or V rows of ``shape``: ``(rows in dtype, None)``; or, with
    ``form`` int8 or fp8, rows whose magnitudes spread over two decades
    (0.01-1), so that a scale applied to the wrong row, or K's and V's
    scales swapped, moves the output, quantized per row: ``(8-bit payload,
    float32 scales)``."""
    x = torch.randn(shape, generator=gen, device="cuda")
    if form is None:
        return x.to(dtype), None
    from flashattention_tpu_torch.ops import quant

    x *= 10.0 ** -(2 * torch.rand(shape[:-1] + (1,), generator=gen, device="cuda"))
    return quant.quantize_rows(x, form)


def _plain_kv(kv, scales):
    """The plain versions' K/V: as they are, or 8-bit rows dequantized in
    float32, as the wrappers do on the CPU."""
    from flashattention_tpu_torch.ops.reference import dequantize_rows

    return kv if scales is None else dequantize_rows(kv, scales)


def _plain_scales(kv3):
    """The plain forward's K/V arguments from ``[(k, k_scales), (v,
    v_scales)]``: 8-bit payloads with their scales (the plain version
    mirrors the form the kernel takes), or K/V as they are."""
    (k, ks), (v, vs) = kv3
    return (k, v), ({} if ks is None else dict(k_scales=ks, v_scales=vs))


def _bf16(kv, scales):
    """The library yardsticks' K/V: bfloat16 rows as they are, 8-bit rows
    dequantized to bfloat16."""
    return kv if scales is None else (kv.float() * scales[..., None]).to(torch.bfloat16)


def _row_bytes(kv, d, form):
    """Bytes of one K or V row: its d elements, and an 8-bit row's scale."""
    return d * kv.element_size() + (4 if form else 0)


def _check_name(kernel, case, dt, form):
    return f"{kernel}/{case}/{dt}" if form is None else f"{kernel}/quant/{case}/{form}/{dt}"


def _kname(kernel, q, quantized=False, block_mask=False, page_size=PAGE_SIZE):
    """The kernel a call of ``kernel`` on ``q`` launches: its tensor-core
    form's name where ``ops.flash.kernel_form`` picks it (bf16 at its
    head_dims, no block mask, 8-bit K/V in the forwards too; paged prefill:
    a page size it takes), else ``kernel``.  A check of an 8-bit form is
    named ``<kernel>/quant/...`` (``_check_name``), so the tensor-core 8-bit
    forms' checks read ``flash_fwd_tc/quant/...``, ``paged_prefill_tc/quant/...``."""
    from flashattention_tpu_torch.ops import flash

    tc = TC_KERNELS.get(kernel)
    if tc and flash.kernel_form(kernel, q.dtype, q.shape[-1], quantized=quantized,
                                block_mask=block_mask, page_size=page_size) == "tc":
        return tc
    return kernel


def _tc_key(kernel, case, form):
    """The key of a timed tensor-core check in ``report["tc_timed"]``."""
    return "/".join(x for x in (kernel, case, form) if x)


_TIMED_KEYS = ("library_ms", "library", "bound_ms", "bound_by", "bytes_ms", "ops_ms")


def _scalar_twin(flash, benchit, rec, run, plain, dt, tol):
    """The scalar form of a timed tensor-core check, at the same inputs and
    in the same call (``ops.flash.scalar_forms``): ``rec`` gains its time
    (``scalar_ms``), and the scalar form's own check (against the scalar
    plain version), with the same yardsticks, is returned under the scalar
    kernel's name."""
    with flash.scalar_forms():
        got, want = run(), plain()
        torch.cuda.synchronize()
        twin = _rec(rec["check"].replace("_tc/", "/", 1), got, want, dt, tol,
                    form="scalar (ops.flash.scalar_forms)",
                    **{k: rec[k] for k in ("shape", "live_pairs") if k in rec})
        twin["kernel_ms"] = benchit.cuda_time_ms(run, warmup=1, iters=5)
        twin["plain_ms"] = benchit.cuda_time_ms(plain, warmup=1, iters=3)
    twin.update({k: rec[k] for k in _TIMED_KEYS if k in rec})
    rec["scalar_ms"] = twin["kernel_ms"]
    return twin


def _page_scales(ks, vs):
    """The paged wrappers' scale arguments: none for unquantized pages."""
    return {} if ks is None else dict(k_scales_pages=ks, v_scales_pages=vs)


def flash_checks(fa, flash, benchit, gen, card, report, form=None):
    """Flash forward: the prefill shape, GQA 32q/8kv, ragged S, residuals.
    With ``form`` (int8 or fp8) over 8-bit K/V with per-row scales
    (``attention(k_scales=, v_scales=)``)."""
    out = {}
    cases = [
        ("prefill", dict(b=4, h=32, hkv=32, s_q=1024, s_kv=1024, d=128)),
        ("gqa_32q8kv", dict(b=2, h=32, hkv=8, s_q=512, s_kv=512, d=128)),
        ("ragged_s300", dict(b=2, h=8, hkv=8, s_q=300, s_kv=300, d=128)),
    ]
    for name, c in cases:
        b, h, hkv, s_q, s_kv, d = (c[x] for x in ("b", "h", "hkv", "s_q", "s_kv", "d"))
        scale = d**-0.5
        for dt in ("bfloat16", "float32"):
            q = torch.randn((b, h, s_q, d), generator=gen, device="cuda").to(DTYPES[dt])
            (k, ks), (v, vs) = (_kv(gen, (b, hkv, s_kv, d), DTYPES[dt], form) for _ in range(2))
            sk = {} if form is None else dict(k_scales=ks, v_scales=vs)
            o = fa.attention(q, k, v, causal=True, scale=scale, **sk)
            q3 = q.reshape(b * hkv, (h // hkv) * s_q, d)
            kv3 = [(x.reshape(-1, s_kv, d), None if sc is None else sc.reshape(-1, s_kv))
                   for x, sc in ((k, ks), (v, vs))]
            (k3, v3), sk3 = _plain_scales(kv3)
            plain = lambda: flash.flash_attention_plain(  # noqa: E731
                q3, k3, v3, causal=True, scale=scale, q_offset=s_kv - s_q, q_seq_len=s_q, **sk3,
            )
            want = plain().reshape(q.shape)
            torch.cuda.synchronize()
            kname = _kname("flash_fwd", q, form is not None)
            rec = _rec(_check_name(kname, name, dt, form), o, want, dt, FLASH_TOL[dt],
                       shape=f"B={b} H={h} KVH={hkv} S_q={s_q} S_kv={s_kv} d={d} causal")
            if name == "prefill" and dt == "bfloat16":
                kernel = lambda: fa.attention(q, k, v, causal=True, scale=scale, **sk)  # noqa: E731
                rec["kernel_ms"] = benchit.cuda_time_ms(kernel)
                rec["plain_ms"] = benchit.cuda_time_ms(plain)
                kd, vd = _bf16(k, ks), _bf16(v, vs)
                rec["library_ms"] = benchit.cuda_time_ms(
                    lambda: torch.nn.functional.scaled_dot_product_attention(
                        q, kd, vd, is_causal=True, scale=scale
                    )
                )
                rec["library"] = "scaled_dot_product_attention, is_causal" + (_DEQUANT_NOTE if form else "")
                pairs = s_q * (s_q + 1) // 2  # live (query, key) pairs per head
                nbytes = (2 * q.numel() * q.element_size()  # q read, o written
                          + 2 * b * hkv * s_kv * _row_bytes(k, d, form))  # K, V rows read
                rec.update(benchit.bound_ms(
                    card, bytes_moved=nbytes, flops=4 * b * h * pairs * d, dtype=dt
                ))
                out["main"] = rec
                if kname == "flash_fwd_tc":  # the scalar form beside it: the scalar row
                    run = lambda: fa.attention(q, k, v, causal=True, scale=scale, **sk)  # noqa: E731
                    twin = _scalar_twin(flash, benchit, rec, run, lambda: plain().reshape(q.shape),
                                        dt, FLASH_TOL[dt])
                    report.setdefault("tc_timed", {})[_tc_key(kname, None, form)] = rec
                    emit(twin)
                    report["checks"].append(twin)
                    out["main"] = twin
            if name == "prefill" and dt == "float32" and form is None:  # the float32 paths' form
                kernel = lambda: fa.attention(q, k, v, causal=True, scale=scale)  # noqa: E731
                rec.update(kernel_ms=benchit.cuda_time_ms(kernel, warmup=1, iters=5),
                           plain_ms=benchit.cuda_time_ms(plain, warmup=1, iters=3),
                           library_ms=benchit.cuda_time_ms(
                               lambda: torch.nn.functional.scaled_dot_product_attention(
                                   q, k, v, is_causal=True, scale=scale), warmup=1, iters=5),
                           library="scaled_dot_product_attention, is_causal, float32")
                rec.update(benchit.bound_ms(card, bytes_moved=4 * q.numel() * 4,
                                            flops=4 * b * h * (s_q * (s_q + 1) // 2) * d, dtype=dt))
                report.setdefault("float32_timed", {})["flash_fwd"] = rec
            emit(rec)
            report["checks"].append(rec)
    # save_residuals with a live length: cross-attention rows at the end of
    # a 300-row KV buffer of which 250 rows are live.
    for dt in ("bfloat16", "float32"):
        q = torch.randn((16, 128, 128), generator=gen, device="cuda").to(DTYPES[dt])
        (k, ks), (v, vs) = (_kv(gen, (16, 300, 128), DTYPES[dt], form) for _ in range(2))
        sk = {} if form is None else dict(k_scales=ks, v_scales=vs)
        kw = dict(causal=True, scale=128**-0.5, kv_len=250, q_offset=122)
        o, l, m = flash.flash_attention(q, k, v, save_residuals=True, **kw, **sk)
        wo, wl, wm = flash.flash_attention_plain(q, k, v, save_residuals=True, **kw, **sk)
        torch.cuda.synchronize()
        e_l = err(l, wl) / float(wl.abs().max())
        e_m = err(m, wm) / float(wm.abs().max())
        kname = _kname("flash_fwd", q, form is not None)
        rec = _rec(_check_name(kname, "save_residuals_kvlen", dt, form), o, wo, dt,
                   FLASH_TOL[dt], l_rel_err=e_l, m_rel_err=e_m, stats_rtol=STATS_RTOL)
        rec["ok"] = rec["ok"] and e_l <= STATS_RTOL and e_m <= STATS_RTOL
        emit(rec)
        report["checks"].append(rec)
    return out["main"]


def _paged_pool(gen, ctx_lens, pps, pages, shape_tail, dtype, form=None):
    """Pools of ``pages`` random pages (8-bit with their scales if ``form``,
    see :func:`_kv`) and tables whose first ``ceil(ctx / ps)`` entries are
    distinct shuffled pages and whose tail entries are other pool pages
    (garbage the kernel must not use): ``(kp, ks), (vp, vs), table``."""
    b = len(ctx_lens)
    assert b * pps <= pages
    perm = torch.randperm(pages, generator=gen, device="cuda")
    table = perm[: b * pps].reshape(b, pps).to(torch.int32).contiguous()
    k, v = (_kv(gen, (pages, *shape_tail), dtype, form) for _ in range(2))
    return k, v, table


def paged_checks(decode, benchit, gen, card, report, form=None):
    """Paged decode: MHA (32 KV heads, G=1) and GQA (8 KV heads, G=4); with
    ``form`` (int8 or fp8) over 8-bit pages with per-row scales."""
    out = {}
    ps, pps, pages, d = 256, 8, 64, 128
    cases = [
        ("decode_mha", dict(kvh=32, g=1, lengths=[1, 256, 257, 1088])),
        ("decode_gqa_g4", dict(kvh=8, g=4, lengths=[0, 255, 512, 2048])),
    ]
    for name, c in cases:
        b, kvh = len(c["lengths"]), c["kvh"]
        lengths = torch.tensor(c["lengths"], dtype=torch.int32, device="cuda")
        for dt in ("bfloat16", "float32"):
            (kp, ks), (vp, vs), table = _paged_pool(gen, c["lengths"], pps, pages, (kvh, ps, d),
                                                    DTYPES[dt], form)
            q = torch.randn((b, kvh, c["g"], d), generator=gen, device="cuda").to(DTYPES[dt])
            kw = dict(scale=d**-0.5, **_page_scales(ks, vs))
            o = decode.paged_attention(q, kp, vp, lengths, table, **kw)
            plain = lambda: decode.paged_attention_plain(  # noqa: E731
                q, kp, vp, lengths, table, **kw
            )
            want = plain()
            torch.cuda.synchronize()
            rec = _rec(_check_name("paged_decode", name, dt, form), o, want, dt, PAGED_TOL[dt],
                       lengths=c["lengths"], shape=f"B={b} KVH={kvh} G={c['g']} d={d} ps={ps}")
            if name == "decode_mha" and dt == "bfloat16":
                kernel = lambda: decode.paged_attention(q, kp, vp, lengths, table, **kw)  # noqa: E731
                # The pool (2 x 0.5 GB in bf16) is larger than L2, but this
                # call's pages were just read: flush so each call finds them cold.
                rec["kernel_ms"] = benchit.cuda_time_ms(kernel, flush_bytes=256 << 20)
                rec["plain_ms"] = benchit.cuda_time_ms(plain, flush_bytes=256 << 20)
                rec.update(_decode_library(benchit, q, _bf16(kp, ks), _bf16(vp, vs), lengths, table,
                                           kw["scale"]))
                rec["library"] += _DEQUANT_NOTE if form else ""
                live = sum(c["lengths"])
                n_pages = sum(-(-n // ps) for n in c["lengths"])
                nbytes = (
                    2 * q.numel() * q.element_size()  # q read, o written
                    + 2 * live * kvh * _row_bytes(kp, d, form)  # live K, V rows
                    + 4 * (b + n_pages)  # lengths, the table entries read
                )
                flops = 4 * live * kvh * c["g"] * d
                rec.update(benchit.bound_ms(card, bytes_moved=nbytes, flops=flops, dtype=dt))
                out["main"] = rec
            emit(rec)
            report["checks"].append(rec)
            del kp, vp, ks, vs, q, o, want
    torch.cuda.empty_cache()
    return out["main"]


def _prefill_work(ctx_lens, chunk, seg, g, kvh, d, window=None):
    """Live (row, column) pairs and their flops: row p of a segment, at
    ``pos = ctx - chunk + p``, sees columns ``max(0, pos - window + 1)``
    through ``min(pos, ctx - 1)`` (pad rows p >= chunk see up to ``ctx``);
    a ctx = 0 request sees none."""
    pairs = 0
    for c in ctx_lens:
        for p in range(seg if c else 0):
            pos = c - chunk + p
            lo = 0 if window is None else max(0, pos - window + 1)
            pairs += max(0, min(pos, c - 1) - lo + 1)
    return pairs * g * kvh, 4 * pairs * g * kvh * d


def prefill_checks(decode, benchit, gen, card, report, form=None):
    """Paged prefill: MHA (32 KV heads, G=1) at the engine's chunk, GQA
    (8 KV heads, G=4) with seg > chunk and a ctx = 0 row, the single form;
    with ``form`` (int8 or fp8) over 8-bit pages with per-row scales.  In
    bf16 the tensor-core form runs (``paged_prefill_tc/...``, against the
    plain version with its rounding); at the MHA shape the scalar form is
    timed and checked beside it."""
    from flashattention_tpu_torch.ops import flash

    out = {}
    ps, pps, pages, d = PAGE_SIZE, 8, 64, 128
    cases = [
        ("prefill_mha", dict(kvh=32, g=1, chunk=512, seg=512, ctx=[512, 1024, 1536, 2048])),
        ("prefill_gqa_g4", dict(kvh=8, g=4, chunk=200, seg=256, ctx=[0, 200, 713, 1480])),
    ]
    for name, c in cases:
        b, kvh = len(c["ctx"]), c["kvh"]
        ctx = torch.tensor(c["ctx"], dtype=torch.int32, device="cuda")
        for dt in ("bfloat16", "float32"):
            (kp, ks), (vp, vs), table = _paged_pool(gen, c["ctx"], pps, pages, (kvh, ps, d),
                                                    DTYPES[dt], form)
            q = torch.randn((b, kvh, c["g"] * c["seg"], d), generator=gen, device="cuda").to(DTYPES[dt])
            kw = dict(chunk=c["chunk"], seg=c["seg"], scale=d**-0.5, **_page_scales(ks, vs))
            o = decode.paged_prefill_attention_batched(q, kp, vp, table, ctx, **kw)
            plain = lambda: decode.paged_prefill_attention_plain(q, kp, vp, table, ctx, **kw)  # noqa: E731
            want = plain()
            torch.cuda.synchronize()
            zero_rows = [i for i, n in enumerate(c["ctx"]) if n == 0]
            zeros_ok = all(int(torch.count_nonzero(o[i])) == 0 for i in zero_rows)
            kname = _kname("paged_prefill", q, form is not None)
            rec = _rec(_check_name(kname, name, dt, form), o, want, dt, PREFILL_TOL[dt],
                       ctx_lens=c["ctx"], chunk=c["chunk"], seg=c["seg"], ctx0_rows_zero=zeros_ok,
                       shape=f"B={b} KVH={kvh} G={c['g']} d={d} ps={ps}")
            rec["ok"] = rec["ok"] and zeros_ok
            if name == "prefill_mha":
                one = decode.paged_prefill_attention(q[3], kp, vp, table[3], c["ctx"][3], **kw)
                torch.cuda.synchronize()
                rec["single_form_err"] = err(one, want[3])
                rec["ok"] = rec["ok"] and rec["single_form_err"] <= PREFILL_TOL[dt]
            if name == "prefill_mha" and (dt == "bfloat16" or form is None):
                # bf16, and float32 (the float32 paths' form) unquantized
                kernel = lambda: decode.paged_prefill_attention_batched(q, kp, vp, table, ctx, **kw)  # noqa: E731
                rec["kernel_ms"] = benchit.cuda_time_ms(kernel, flush_bytes=256 << 20)
                rec["plain_ms"] = benchit.cuda_time_ms(plain, flush_bytes=256 << 20)
                # Library yardstick: SDPA over the pre-gathered context, with
                # an explicit bottom-right causal mask per request.
                cols = torch.arange(pps * ps, device="cuda")
                pos = ctx[:, None] - c["chunk"] + torch.arange(c["seg"], device="cuda")[None]
                mask = (cols[None, None] <= pos[:, :, None]) & (cols[None, None] < ctx[:, None, None])
                rec["library_ms"] = _gathered_sdpa_ms(benchit, q, _bf16(kp, ks), _bf16(vp, vs), table,
                                                      mask, kw["scale"])
                rec["library"] = ("scaled_dot_product_attention on the pre-gathered dense context, "
                                  "boolean causal mask, gather not timed" + (_DEQUANT_NOTE if form else ""))
                pairs, flops = _prefill_work(c["ctx"], c["chunk"], c["seg"], c["g"], kvh, d)
                live_pages = sum(-(-n // ps) for n in c["ctx"])
                nbytes = (
                    2 * q.numel() * q.element_size()  # q read, o written
                    + 2 * sum(c["ctx"]) * kvh * _row_bytes(kp, d, form)  # live K, V rows
                    + 4 * (b + live_pages)  # ctx_lens, the table entries read
                )
                rec["live_pairs"] = pairs
                rec.update(benchit.bound_ms(card, bytes_moved=nbytes, flops=flops, dtype=dt))
                if dt == "float32":
                    report.setdefault("float32_timed", {})["paged_prefill"] = rec
                else:
                    out["main"] = rec
                if kname == "paged_prefill_tc":
                    twin = _scalar_twin(flash, benchit, rec, kernel, plain, dt, PREFILL_TOL[dt])
                    report.setdefault("tc_timed", {})[_tc_key(kname, None, form)] = rec
                    emit(twin)
                    report["checks"].append(twin)
                    out["main"] = twin
            emit(rec)
            report["checks"].append(rec)
            del kp, vp, ks, vs, q, o, want
    torch.cuda.empty_cache()
    return out["main"]


def prefill_poison_check(decode, gen, report):
    """The tensor-core paged prefill reads no K/V row that no query row may
    see: at the Gemma-2 window shape, GQA with seg > chunk, and a page size
    below the KV tile (the tile built from several pages), every pool row
    past each request's ctx_len, every page its table names past the live
    ones and every row before the first column any row's window reaches are
    filled with NaN; the output must equal the clean pool's, bit for bit
    (and be finite).  The fp8 cases do the same over fp8 pages, through the
    8-bit form: those rows' payload bytes are 0x7F (NaN in e4m3) and their
    scales NaN."""
    cases = (
        ("gemma2_d256_w4096_cap50", dict(kvh=8, g=2, d=256, ps=PAGE_SIZE, pps=24, chunk=512,
                                         seg=512, window=4096, cap=50.0,
                                         ctx=[4608, 5000, 5633, 6100])),
        ("gqa_g4_d128_seg256", dict(kvh=8, g=4, d=128, ps=PAGE_SIZE, pps=8, chunk=200, seg=256,
                                    window=None, cap=None, ctx=[0, 200, 713, 1480])),
        ("page32_d64_w100", dict(kvh=4, g=2, d=64, ps=32, pps=40, chunk=96, seg=128, window=100,
                                 cap=None, ctx=[96, 300, 777, 1270])),
    )
    cases += tuple((name, {**c, "form": "fp8"}) for name, c in cases
                   if name in ("gemma2_d256_w4096_cap50", "page32_d64_w100"))
    recs = []
    for name, c in cases:
        b, ps, pps, d = len(c["ctx"]), c["ps"], c["pps"], c["d"]
        form = c.get("form")
        pages = b * pps + 4
        ctx = torch.tensor(c["ctx"], dtype=torch.int32, device="cuda")
        (kp, ks), (vp, vs), table = _paged_pool(gen, c["ctx"], pps, pages, (c["kvh"], ps, d),
                                                torch.bfloat16, form)
        q = torch.randn((b, c["kvh"], c["g"] * c["seg"], d), generator=gen,
                        device="cuda").to(torch.bfloat16)
        kw = dict(chunk=c["chunk"], seg=c["seg"], scale=d**-0.5, window=c["window"],
                  logit_softcap=c["cap"])
        clean = decode.paged_prefill_attention_batched(q, kp, vp, table, ctx, **kw,
                                                       **_page_scales(ks, vs))
        kn, vn = kp.clone(), vp.clone()
        sn = [None if x is None else x.clone() for x in (ks, vs)]
        # The poison: NaN, or in an fp8 pool the byte 0x7F (e4m3's NaN).
        pools = [x.view(torch.uint8) if form else x for x in (kn, vn)]
        nan = 0x7F if form else float("nan")
        for i, n in enumerate(c["ctx"]):
            # Columns [first, n) are the only ones some row sees.
            first = 0 if c["window"] is None else max(0, n - c["chunk"] - c["window"] + 1)
            for j in range(pps):
                page = int(table[i, j])
                lo, hi = max(0, min(ps, first - j * ps)), max(0, min(ps, n - j * ps))
                for pool in pools:
                    pool[page, :, :lo] = nan
                    pool[page, :, max(lo, hi):] = nan
                for sc in sn if form else ():
                    sc[page, :, :lo] = float("nan")
                    sc[page, :, max(lo, hi):] = float("nan")
        poisoned = decode.paged_prefill_attention_batched(q, kn, vn, table, ctx, **kw,
                                                          **_page_scales(*sn))
        torch.cuda.synchronize()
        equal = bool(torch.equal(poisoned, clean))
        finite = bool(torch.isfinite(poisoned).all())
        check = _check_name(_kname("paged_prefill", q, form is not None, page_size=ps),
                            f"nan_poison/{name}", "bfloat16", form)
        rec = {"check": check,
               "shape": f"B={b} KVH={c['kvh']} G={c['g']} d={d} ps={ps} chunk={c['chunk']} "
                        f"seg={c['seg']} window={c['window']} cap={c['cap']}",
               "ctx_lens": c["ctx"], "bitwise_equal": equal, "finite": finite,
               "max_abs_err": err(poisoned.nan_to_num(), clean), "ok": equal and finite}
        emit(rec)
        report["checks"].append(rec)
        recs.append(rec)
        del kp, vp, ks, vs, kn, vn, sn, pools, q, clean, poisoned
    torch.cuda.empty_cache()
    return recs


# attention() at a head_dim no kernel is built for: B = 1, 16 q / 4 KV heads
# (G = 4), a ragged S = 1000, d = 80 (padded to 128 on every device).
HEAD_DIM_PAD = dict(b=1, h=16, hkv=4, s=1000, d=80)


def head_dim_pad_check(fa, flash, backward, gen, report):
    """``sdpa`` (``attention`` with its default scale, 1 / sqrt(80)) at
    head_dim 80, causal GQA, bf16, forward and gradients under autograd on
    the card, where the call zero-pads q/k/v to 128 and slices O, against
    the same call on float32 CPU copies of the inputs, which runs the plain
    versions; max abs error within FLASH_TOL (BWD_TOL for the gradients)
    times the larger of 1 and the reference's largest magnitude (the bf16
    outputs' rounding), each bf16 element's error against BF16_ELEM_TOL
    reported.  The forward's and the fused backward's tensor-core forms
    must launch once each."""
    c = HEAD_DIM_PAD
    b, h, hkv, s, d = (c[x] for x in ("b", "h", "hkv", "s", "d"))
    q = torch.randn((b, h, s, d), generator=gen, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn((b, hkv, s, d), generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    do = torch.randn((b, h, s, d), generator=gen, device="cuda").to(torch.bfloat16)
    flash.flash_attention.launches_tc = backward.fused_bwd_kernel.launches_tc = 0
    ins = [x.clone().requires_grad_() for x in (q, k, v)]
    o = fa.sdpa(*ins, causal=True)
    grads = torch.autograd.grad(o, ins, do)
    torch.cuda.synchronize()
    launches = {"flash_fwd_tc": flash.flash_attention.launches_tc,
                "flash_bwd_tc": backward.fused_bwd_kernel.launches_tc}
    cpu = [x.detach().float().cpu().requires_grad_() for x in (q, k, v)]
    wo = fa.sdpa(*cpu, causal=True)
    wgrads = torch.autograd.grad(wo, cpu, do.float().cpu())
    recs = []
    for name, got, want, tol in (("o", o, wo, FLASH_TOL["bfloat16"]),
                                 *((f"d{n}", g_, w, BWD_TOL["bfloat16"])
                                   for n, g_, w in zip("qkv", grads, wgrads))):
        want = want.detach().to("cuda")
        bound = tol * max(1.0, float(want.abs().max()))
        e = err(got.detach(), want)
        recs.append({"what": name, "max_abs_err": e, "bound": bound, "ok": e <= bound,
                     "elem_err": elem_err(got.detach(), want)})
    rec = {"check": f"attention/head_dim_80/{_kname('flash_fwd', q.new_empty(1, 128))}/bfloat16",
           "shape": f"B={b} H={h} KVH={hkv} S={s} d={d} (padded to 128) causal, sdpa's scale",
           "max_abs_err": max(r["max_abs_err"] for r in recs), "parts": recs,
           "launches": launches,
           "ok": all(r["ok"] for r in recs) and launches == {"flash_fwd_tc": 1, "flash_bwd_tc": 1}}
    emit(rec)
    report["checks"].append(rec)
    del q, k, v, do, ins, o, grads, cpu, wo, wgrads
    torch.cuda.empty_cache()
    return rec


# Gemma-2-9B-class attention: 16 q / 8 KV heads (G = 2), d = 256, window
# 4096, softcap 50 (the first case is the timed one); Mistral-7B-class: 32 q /
# 8 KV heads (G = 4), d = 128, window 4096, no softcap.  With q ~ N(0, 1) the
# scores are ~N(0, 1), where cap * tanh(s / cap) ~ s; the "q8" case scales q
# by 8 so that the scores reach ~30 and the cap bends them.
WINDOW_CASES = (
    ("gemma2_d256_w4096_cap50", dict(g=2, d=256, window=4096, cap=50.0, q_mult=1.0)),
    ("gemma2_d256_w4096_cap50_q8", dict(g=2, d=256, window=4096, cap=50.0, q_mult=8.0)),
    ("mistral_d128_w4096", dict(g=4, d=128, window=4096, cap=None, q_mult=1.0)),
)
TIMED_WINDOW_CASE = WINDOW_CASES[0][0]


def _window_pairs(s, window):
    """Live (query, key) pairs of one causal S-row segment under a window:
    row p sees min(p + 1, window) columns."""
    w = min(s, window)
    return w * (w + 1) // 2 + (s - w) * window


def _gathered_sdpa_ms(benchit, q4, kp, vp, table, mask, scale):
    """Library yardstick of the paged kernels: one scaled_dot_product_attention
    call over the context gathered densely beforehand (K/V repeated to the q
    heads; the gather is not timed).  q4 (B, H, rows, d); mask boolean, (B,
    rows, pages_per_seq * page_size), the same for every head."""
    b, h = q4.shape[:2]
    _, kvh, ps, d = kp.shape
    s_max = table.shape[1] * ps
    idx = table.long()
    kd = kp[idx].transpose(1, 2).reshape(b, kvh, s_max, d).repeat_interleave(h // kvh, dim=1)
    vd = vp[idx].transpose(1, 2).reshape(b, kvh, s_max, d).repeat_interleave(h // kvh, dim=1)
    return benchit.cuda_time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q4, kd, vd, attn_mask=mask[:, None], scale=scale),
        flush_bytes=256 << 20,
    )


def _decode_library(benchit, q, kp, vp, lengths, table, scale, window=None):
    """SDPA yardstick of paged decode, with a boolean length (and window)
    mask.  It cannot express the softcap."""
    b, kvh, g, d = q.shape
    cols = torch.arange(table.shape[1] * kp.shape[2], device="cuda")[None]
    lens = lengths.long()[:, None]
    mask = cols < lens
    if window is not None:
        mask &= cols > lens - 1 - window
    ms = _gathered_sdpa_ms(benchit, q.reshape(b, kvh * g, 1, d), kp, vp, table,
                           mask[:, None], scale)
    return {"library_ms": ms, "library": (
        "scaled_dot_product_attention on the pre-gathered dense context (K/V repeated "
        "to the q heads), boolean length" + (" and window" if window else "")
        + " mask, gather not timed; no softcap (SDPA cannot express it)")}


def flash_window_checks(fa, flash, benchit, gen, card, report, form=None):
    """Flash forward at the windowed models' prefill: B = 1, S = 5000 (past
    the window of 4096; 5000 rows per segment, so 32-row tiles cross GQA
    segments), causal; with ``form`` (int8 or fp8) over 8-bit K/V.  Timed
    at Gemma's shape in bfloat16: kernel, plain version, and SDPA with the
    window as a boolean mask and no softcap."""
    out = {}
    b, s = 1, 5000
    for name, c in WINDOW_CASES:
        g, d, kvh = c["g"], c["d"], 8
        kw = dict(causal=True, scale=d**-0.5, window=c["window"], logit_softcap=c["cap"])
        for dt in ("bfloat16", "float32"):
            q = (c["q_mult"] * torch.randn((b, kvh * g, s, d), generator=gen, device="cuda")).to(DTYPES[dt])
            (k, ks), (v, vs) = (_kv(gen, (b, kvh, s, d), DTYPES[dt], form) for _ in range(2))
            sk = {} if form is None else dict(k_scales=ks, v_scales=vs)
            o = fa.attention(q, k, v, **kw, **sk)
            q3 = q.reshape(b * kvh, g * s, d)
            kv3 = [(x.reshape(b * kvh, s, d), None if sc is None else sc.reshape(b * kvh, s))
                   for x, sc in ((k, ks), (v, vs))]
            (k3, v3), sk3 = _plain_scales(kv3)
            plain = lambda: flash.flash_attention_plain(q3, k3, v3, q_seq_len=s, **kw, **sk3)  # noqa: E731
            want = plain().reshape(q.shape)
            torch.cuda.synchronize()
            rec = _rec(_check_name(_kname("flash_fwd", q, form is not None), name, dt, form), o,
                       want, dt, FLASH_TOL[dt], shape=f"B={b} H={kvh * g} KVH={kvh} S={s} d={d}")
            if dt == "bfloat16" and name == TIMED_WINDOW_CASE:
                rec["kernel_ms"] = benchit.cuda_time_ms(lambda: fa.attention(q, k, v, **kw, **sk))
                rec["plain_ms"] = benchit.cuda_time_ms(plain, warmup=1, iters=5)
                pos = torch.arange(s, device="cuda")
                mask = (pos[None] <= pos[:, None]) & (pos[None] > pos[:, None] - c["window"])
                kr, vr = (_bf16(x, sc).repeat_interleave(g, dim=1) for x, sc in ((k, ks), (v, vs)))
                rec["library_ms"] = benchit.cuda_time_ms(
                    lambda: torch.nn.functional.scaled_dot_product_attention(
                        q, kr, vr, attn_mask=mask, scale=kw["scale"]))
                rec["library"] = ("scaled_dot_product_attention, boolean causal+window mask, "
                                  "K/V repeated to 16 heads untimed; no softcap (SDPA cannot express it)"
                                  + (_DEQUANT_NOTE if form else ""))
                pairs = b * kvh * g * _window_pairs(s, c["window"])
                nbytes = (2 * q.numel() * q.element_size()  # q read, o written
                          + 2 * b * kvh * s * _row_bytes(k, d, form))  # K, V rows read
                rec["live_pairs"] = pairs
                rec.update(benchit.bound_ms(card, bytes_moved=nbytes, flops=4 * d * pairs, dtype=dt))
                out["main"] = rec
                if rec["check"].startswith("flash_fwd_tc/"):
                    twin = _scalar_twin(flash, benchit, rec, lambda: fa.attention(q, k, v, **kw, **sk),
                                        lambda: plain().reshape(q.shape), dt, FLASH_TOL[dt])
                    report.setdefault("tc_timed", {})[
                        _tc_key("flash_fwd_tc", "d256_window_softcap", form)] = rec
                    emit(twin)
                    report["checks"].append(twin)
                    out["main"] = twin
                del kr, vr, mask
            emit(rec)
            report["checks"].append(rec)
            del q, k, v, ks, vs, o, want, q3, kv3, k3, v3, sk3
            torch.cuda.empty_cache()
    return out["main"]


def paged_window_checks(decode, benchit, gen, card, report, form=None):
    """Paged decode with the window: lengths 1, 4096, 4097 and 6000 (the
    last reads 16 of its 24 pages), page_size 256, 24 pages per request;
    with ``form`` (int8 or fp8) over 8-bit pages."""
    out = {}
    ps, pps, pages = 256, 24, 100
    lens = [1, 4096, 4097, 6000]
    b = len(lens)
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    for name, c in WINDOW_CASES:
        g, d, kvh, w = c["g"], c["d"], 8, c["window"]
        for dt in ("bfloat16", "float32"):
            (kp, ks), (vp, vs), table = _paged_pool(gen, lens, pps, pages, (kvh, ps, d), DTYPES[dt], form)
            kw = dict(scale=d**-0.5, window=w, logit_softcap=c["cap"], **_page_scales(ks, vs))
            q = (c["q_mult"] * torch.randn((b, kvh, g, d), generator=gen, device="cuda")).to(DTYPES[dt])
            o = decode.paged_attention(q, kp, vp, lengths, table, **kw)
            plain = lambda: decode.paged_attention_plain(q, kp, vp, lengths, table, **kw)  # noqa: E731
            want = plain()
            torch.cuda.synchronize()
            rec = _rec(_check_name("paged_decode", name, dt, form), o, want, dt, PAGED_TOL[dt],
                       lengths=lens, shape=f"KVH={kvh} G={g} d={d} ps={ps}")
            if dt == "bfloat16" and name == TIMED_WINDOW_CASE:
                kernel = lambda: decode.paged_attention(q, kp, vp, lengths, table, **kw)  # noqa: E731
                rec["kernel_ms"] = benchit.cuda_time_ms(kernel, flush_bytes=256 << 20)
                rec["plain_ms"] = benchit.cuda_time_ms(plain, flush_bytes=256 << 20)
                rec.update(_decode_library(benchit, q, _bf16(kp, ks), _bf16(vp, vs), lengths, table,
                                           kw["scale"], w))
                rec["library"] += _DEQUANT_NOTE if form else ""
                live = sum(min(n, w) for n in lens)  # K/V rows inside each window
                n_pages = sum(-(-n // ps) - max(0, (n - w) // ps) for n in lens)
                nbytes = (
                    2 * q.numel() * q.element_size()  # q read, o written
                    + 2 * live * kvh * _row_bytes(kp, d, form)  # live K, V rows
                    + 4 * (b + n_pages)  # lengths, the table entries read
                )
                rec["live_rows"] = live
                rec.update(benchit.bound_ms(card, bytes_moved=nbytes, flops=4 * live * kvh * g * d,
                                            dtype=dt))
                out["main"] = rec
            emit(rec)
            report["checks"].append(rec)
            del kp, vp, ks, vs, q, o, want
    torch.cuda.empty_cache()
    return out["main"]


def prefill_window_checks(decode, benchit, gen, card, report, form=None):
    """Paged prefill with the window: a 512-row chunk (the engine's) at
    contexts 4608-6144, page_size 256, 24 pages per request; the chunk's
    tiles start past the first 0-7 pages; with ``form`` (int8 or fp8) over
    8-bit pages.  In bf16 the tensor-core form runs; at Gemma-2's shape the
    scalar form is timed and checked beside it."""
    from flashattention_tpu_torch.ops import flash

    out = {}
    ps, pps, pages, chunk = PAGE_SIZE, 24, 100, 512
    ctxs = [4608, 5120, 5632, 6144]
    b = len(ctxs)
    ctx = torch.tensor(ctxs, dtype=torch.int32, device="cuda")
    for name, c in WINDOW_CASES:
        g, d, kvh, w = c["g"], c["d"], 8, c["window"]
        for dt in ("bfloat16", "float32"):
            (kp, ks), (vp, vs), table = _paged_pool(gen, ctxs, pps, pages, (kvh, ps, d), DTYPES[dt], form)
            kw = dict(chunk=chunk, seg=chunk, scale=d**-0.5, window=w, logit_softcap=c["cap"],
                      **_page_scales(ks, vs))
            q = (c["q_mult"] * torch.randn((b, kvh, g * chunk, d), generator=gen, device="cuda")).to(DTYPES[dt])
            o = decode.paged_prefill_attention_batched(q, kp, vp, table, ctx, **kw)
            plain = lambda: decode.paged_prefill_attention_plain(q, kp, vp, table, ctx, **kw)  # noqa: E731
            want = plain()
            torch.cuda.synchronize()
            kname = _kname("paged_prefill", q, form is not None)
            rec = _rec(_check_name(kname, name, dt, form), o, want, dt, PREFILL_TOL[dt],
                       ctx_lens=ctxs, chunk=chunk, shape=f"KVH={kvh} G={g} d={d} ps={ps}")
            if dt == "bfloat16" and name == TIMED_WINDOW_CASE:
                kernel = lambda: decode.paged_prefill_attention_batched(q, kp, vp, table, ctx, **kw)  # noqa: E731
                rec["kernel_ms"] = benchit.cuda_time_ms(kernel, flush_bytes=256 << 20)
                rec["plain_ms"] = benchit.cuda_time_ms(plain, warmup=1, iters=5, flush_bytes=256 << 20)
                cols = torch.arange(pps * ps, device="cuda")[None, None]
                pos = (ctx[:, None] - chunk + torch.arange(chunk, device="cuda")[None])[:, :, None]
                mask = (cols <= pos) & (cols < ctx[:, None, None]) & (cols > pos - w)
                rec["library_ms"] = _gathered_sdpa_ms(
                    benchit, q.reshape(b, kvh * g, chunk, d), _bf16(kp, ks), _bf16(vp, vs), table, mask,
                    kw["scale"])
                rec["library"] = ("scaled_dot_product_attention on the pre-gathered dense context "
                                  "(K/V repeated to 16 heads), boolean causal+window mask, gather "
                                  "not timed; no softcap (SDPA cannot express it)"
                                  + (_DEQUANT_NOTE if form else ""))
                pairs, flops = _prefill_work(ctxs, chunk, chunk, g, kvh, d, window=w)
                rows = sum(n - max(0, n - chunk - w + 1) for n in ctxs)  # K/V rows any row sees
                pages_read = sum(-(-n // ps) - max(0, n - chunk - w + 1) // ps for n in ctxs)
                nbytes = (
                    2 * q.numel() * q.element_size()  # q read, o written
                    + 2 * rows * kvh * _row_bytes(kp, d, form)  # live K, V rows
                    + 4 * (b + pages_read)  # ctx_lens, the table entries read
                )
                rec["live_pairs"] = pairs
                rec.update(benchit.bound_ms(card, bytes_moved=nbytes, flops=flops, dtype=dt))
                out["main"] = rec
                if kname == "paged_prefill_tc":
                    twin = _scalar_twin(flash, benchit, rec, kernel, plain, dt, PREFILL_TOL[dt])
                    report.setdefault("tc_timed", {})[
                        _tc_key(kname, "d256_window_softcap", form)] = rec
                    emit(twin)
                    report["checks"].append(twin)
                    out["main"] = twin
                del mask
            emit(rec)
            report["checks"].append(rec)
            del kp, vp, ks, vs, q, o, want
            torch.cuda.empty_cache()
    return out["main"]


def serving_checks(fa, flash, decode, benchit, gen, card, report, form=None):
    """The three serving kernels' checks at their main shapes and at the
    windowed models' (d = 256 with window 4096 and softcap 50, Gemma-2;
    d = 128 with window 4096, Mistral), unquantized or over ``form`` (int8
    or fp8) K/V: {kernel: (main shape's timed check, Gemma-2's)}."""
    return {
        "flash_fwd": (flash_checks(fa, flash, benchit, gen, card, report, form),
                      flash_window_checks(fa, flash, benchit, gen, card, report, form)),
        "paged_decode": (paged_checks(decode, benchit, gen, card, report, form),
                         paged_window_checks(decode, benchit, gen, card, report, form)),
        "paged_prefill": (prefill_checks(decode, benchit, gen, card, report, form),
                          prefill_window_checks(decode, benchit, gen, card, report, form)),
    }

# The paged decode kernel's draft form (speculative verification) at the
# engine's k = 4: q holds G * k rows per KV head, k-minor.  (name, KV heads,
# G, d, window, softcap, q multiplier): Llama-7B's attention (G = 1, R = 4
# rows per head), Mistral-7B's (G = 4, R = 16, window 4096), Gemma-2-9B's
# (G = 2, R = 8, d = 256, window 4096, softcap 50; again with q x 8 so that
# scores reach the cap), G = 8 (R = 32) and a window of 2 < k.  Lengths
# cross a page and the window; the 8-bit forms run at the Llama and Gemma-2
# shapes.  Timed in bfloat16 at those two: kernel, plain version, SDPA over
# the gathered context with an (R x S) mask, and k launches of the k = 1
# kernel on the same rows.
DRAFT_K = 4
DRAFT_LENGTHS = [4, 256, 260, 4100, 6000]
DRAFT_CASES = (
    ("llama", dict(kvh=32, g=1, d=128, window=None, cap=None, q_mult=1.0)),
    ("mistral", dict(kvh=8, g=4, d=128, window=4096, cap=None, q_mult=1.0)),
    ("gemma2", dict(kvh=8, g=2, d=256, window=4096, cap=50.0, q_mult=1.0)),
    ("gemma2_q8", dict(kvh=8, g=2, d=256, window=4096, cap=50.0, q_mult=8.0)),
    ("g8", dict(kvh=8, g=8, d=128, window=None, cap=None, q_mult=1.0)),
    ("window2", dict(kvh=8, g=2, d=128, window=2, cap=50.0, q_mult=1.0)),
)
TIMED_DRAFT_CASES = ("llama", "gemma2")


def _draft_limits(lengths, k, window):
    """Per request: the K/V rows some draft row sees (from the first column
    of row 0's window), and each row's visible columns."""
    rows, seen = [], []
    for n in lengths:
        lims = [n - k + dp for dp in range(k)]
        lo = 0 if window is None else max(0, n - k - window + 1)
        rows.append(n - lo)
        seen.append([lim + 1 if window is None else min(lim + 1, window) for lim in lims])
    return rows, seen


def draft_checks(decode, benchit, gen, card, report, form=None):
    """Paged decode's draft form against its plain version in bfloat16 and
    float32 (with ``form`` int8 or fp8: over 8-bit pages, at the timed
    shapes only): {case: timed check} for TIMED_DRAFT_CASES."""
    out = {}
    ps, pps, pages, k = 256, 24, 128, DRAFT_K
    lens = DRAFT_LENGTHS
    b = len(lens)
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    for name, c in DRAFT_CASES:
        if form is not None and name not in TIMED_DRAFT_CASES:
            continue
        kvh, g, d, w = c["kvh"], c["g"], c["d"], c["window"]
        rows = g * k
        for dt in ("bfloat16", "float32"):
            (kp, ks), (vp, vs), table = _paged_pool(gen, lens, pps, pages, (kvh, ps, d), DTYPES[dt], form)
            kw = dict(scale=d**-0.5, draft_k=k, window=w, logit_softcap=c["cap"], **_page_scales(ks, vs))
            q = (c["q_mult"] * torch.randn((b, kvh, rows, d), generator=gen, device="cuda")).to(DTYPES[dt])
            o = decode.paged_attention(q, kp, vp, lengths, table, **kw)
            plain = lambda: decode.paged_attention_plain(q, kp, vp, lengths, table, **kw)  # noqa: E731
            want = plain()
            torch.cuda.synchronize()
            rec = _rec(_check_name("paged_decode", f"draft_k{k}_{name}", dt, form), o, want, dt,
                       PAGED_TOL[dt], lengths=lens, draft_k=k, window=w, softcap=c["cap"],
                       shape=f"B={b} KVH={kvh} G={g} R={rows} d={d} ps={ps}")
            if dt == "bfloat16" and name in TIMED_DRAFT_CASES:
                kernel = lambda: decode.paged_attention(q, kp, vp, lengths, table, **kw)  # noqa: E731
                rec["kernel_ms"] = benchit.cuda_time_ms(kernel, flush_bytes=256 << 20)
                rec["plain_ms"] = benchit.cuda_time_ms(plain, warmup=1, iters=5, flush_bytes=256 << 20)
                # k launches of the k = 1 kernel, row j of each head at length n - k + 1 + j.
                ones = [(q[:, :, j::k].contiguous(), lengths - (k - 1 - j)) for j in range(k)]
                one_kw = {**kw, "draft_k": 1}
                rec["k_times_k1_ms"] = benchit.cuda_time_ms(
                    lambda: [decode.paged_attention(qj, kp, vp, lj, table, **one_kw) for qj, lj in ones],
                    flush_bytes=256 << 20)
                cols = torch.arange(pps * ps, device="cuda")[None, None]
                lim = (lengths.long()[:, None] - k + torch.arange(k, device="cuda")[None])[:, :, None]
                mask = (cols <= lim) & (cols > lim - w) if w else cols <= lim
                rec["library_ms"] = _gathered_sdpa_ms(
                    benchit, q.reshape(b, kvh * g, k, d), _bf16(kp, ks), _bf16(vp, vs), table, mask,
                    kw["scale"])
                rec["library"] = (
                    "scaled_dot_product_attention on the pre-gathered dense context (K/V repeated "
                    "to the q heads), boolean (k x S) causal" + (" and window" if w else "")
                    + " mask, gather not timed" + ("; no softcap (SDPA cannot express it)" if c["cap"] else "")
                    + (_DEQUANT_NOTE if form else ""))
                live, seen = _draft_limits(lens, k, w)
                n_pages = sum(-(-n // ps) - (max(0, n - k - w + 1) // ps if w else 0) for n in lens)
                kv_bytes = 2 * sum(live) * kvh * _row_bytes(kp, d, form)  # live K, V rows, once
                nbytes = 2 * q.numel() * q.element_size() + kv_bytes + 4 * (b + n_pages)
                tiles = rows // next(t for t in (8, 4, 2, 1) if rows % t == 0)
                rec.update(live_rows=sum(live), row_tiles=tiles,
                           kv_bytes_as_read=tiles * kv_bytes)  # each tile reads them again
                rec.update(benchit.bound_ms(card, bytes_moved=nbytes,
                                            flops=4 * d * kvh * g * sum(map(sum, seen)), dtype=dt))
                out[name] = rec
                del ones, mask
            emit(rec)
            report["checks"].append(rec)
            del kp, vp, ks, vs, q, o, want
            torch.cuda.empty_cache()
    return out


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


# The 8-bit forms of the serving kernels: their wrappers count those
# launches apart (``launches_quantized``) as well as with all the others.
QUANT_KERNELS = ("flash_fwd", "paged_decode", "paged_prefill")
# The kernels with dropout (all four) and block masks (all but flash_bwd).
EXTRA_KERNELS = ("flash_fwd", "flash_bwd", "flash_bwd_dq", "flash_bwd_dkv")


def _counters(flash, decode, backward):
    """Launch counters by name: ``(wrapper, attribute)``; ``<kernel>_quant``
    counts the 8-bit form's launches, ``paged_decode_draft`` the draft
    form's, ``<kernel>_dropout`` and ``<kernel>_block_mask`` the launches
    with dropout and with a block mask, ``flash_fwd_tc``, ``flash_bwd_tc``
    and ``paged_prefill_tc`` the tensor-core forms', which ``<kernel>``
    counts too, and ``flash_fwd_tc_quant`` and ``paged_prefill_tc_quant``
    their 8-bit forms', which ``<kernel>_quant`` and the tensor-core counter
    count too."""
    fns = {
        "flash_fwd": flash.flash_attention,
        "paged_decode": decode.paged_attention,
        "paged_prefill": decode.paged_prefill_attention_batched,
        "flash_naive": flash.flash_attention_naive,
        "flash_bwd": backward.fused_bwd_kernel,
        "flash_bwd_dq": backward.dq_kernel,
        "flash_bwd_dkv": backward.dkv_kernel,
    }
    out = {k: (fn, "launches") for k, fn in fns.items()}
    out.update({f"{k}_quant": (fns[k], "launches_quantized") for k in QUANT_KERNELS})
    out["paged_decode_draft"] = (decode.paged_attention, "launches_draft")
    out.update({f"{k}_dropout": (fns[k], "launches_dropout") for k in EXTRA_KERNELS})
    out.update({f"{k}_block_mask": (fns[k], "launches_block_mask") for k in EXTRA_KERNELS
                if k != "flash_bwd"})
    out.update({tc: (fns[k], "launches_tc") for k, tc in TC_KERNELS.items()})
    out.update({f"{TC_KERNELS[k]}_dropout": (fns[k], "launches_tc_dropout") for k in PAIR})
    out.update({tc: (fns[k], "launches_tc_quantized") for k, tc in TC_QUANT_KERNELS.items()})
    return out


def _tc_expect(want, cfg, page_size=PAGE_SIZE):
    """``want`` with the tensor-core forms' expected launches: every
    flash_fwd launch of a bf16 model at their head_dims but the block-mask
    ones (the 8-bit ones, none with dropout on these paths, in its 8-bit
    form too), every fused backward launch at theirs, every launch of the
    two-pass pair at theirs but the block-mask ones, and every paged
    prefill launch of a bf16 model on pages of ``page_size`` rows (on 8-bit
    pages in its 8-bit form too)."""
    from flashattention_tpu_torch.ops import flash

    dt = DTYPES[cfg.dtype]
    if flash.kernel_form("flash_fwd", dt, cfg.head_dim) == "tc":
        want["flash_fwd_tc"] = want["flash_fwd"] - want.get("flash_fwd_block_mask", 0)
        want["flash_fwd_tc_quant"] = want.get("flash_fwd_quant", 0)
    if flash.kernel_form("flash_bwd", dt, cfg.head_dim) == "tc":
        want["flash_bwd_tc"] = want["flash_bwd"]
    for k in PAIR:  # the two-pass pair's, but the block-mask launches
        if flash.kernel_form(k, dt, cfg.head_dim) == "tc":
            want[f"{k}_tc"] = want.get(k, 0) - want.get(f"{k}_block_mask", 0)
            want[f"{k}_tc_dropout"] = want.get(f"{k}_dropout", 0)
    if flash.kernel_form("paged_prefill", dt, cfg.head_dim, page_size=page_size) == "tc":
        want["paged_prefill_tc"] = want.get("paged_prefill", 0)
        want["paged_prefill_tc_quant"] = want.get("paged_prefill_quant", 0)
    return want


def _drive(counters, drive):
    """Call ``drive()`` with every launch counter set to 0 just before and
    read just after; return (wall seconds, launches)."""
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    drive()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}


def _finished(eng, ids, budget):
    return all(
        len(eng.requests[i].output) == budget and eng.requests[i].state == "finished"
        for i in ids
    )


def _serve_rec(phase, cfg, st, full, wall, launches, want, extra, model="llama7b_attention"):
    _tc_expect(want, cfg)
    return {
        "phase": phase, "model": model, "layers": cfg.num_layers, **extra,
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
    want = dict.fromkeys(counters, 0)
    want.update(flash_fwd=cfg.num_layers * st["prefill_batches"],
                paged_decode=cfg.num_layers * st["decode_batches"])
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


def _quant_launches(want, launches, cache_quantized):
    """Expected 8-bit launches: every paged launch with an 8-bit cache (the
    whole-prompt flash_fwd launches attend unquantized K/V), none without;
    and whether the 8-bit forms did launch where they must."""
    for k in ("paged_decode", "paged_prefill"):
        want[f"{k}_quant"] = want[k] if cache_quantized else 0
    return not cache_quantized or all(
        launches[f"{k}_quant"] > 0 for k in ("paged_decode", "paged_prefill"))


def phase_serve_chunked(args, cfg, params, engine_mod, kvcache, counters, report, *,
                        cache_dtype="bfloat16", phase="serve_chunked", extra=None):
    """The default configuration's path: chunked prefill and prefix hits.
    With ``cache_dtype`` int8 or fp8, an 8-bit KV cache (the serve_int8
    phase, on int8 weights)."""
    ccfg = kvcache.CacheConfig(
        num_layers=cfg.num_layers, num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim, page_size=256, num_pages=64, dtype=cache_dtype,
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
    want = dict.fromkeys(counters, 0)
    want.update(flash_fwd=cfg.num_layers * st["prefill_batches"],
                paged_decode=cfg.num_layers * st["decode_batches"],
                paged_prefill=cfg.num_layers * st["chunk_rounds"])
    quant_ok = _quant_launches(want, launches, ccfg.quantized)
    want_prefill = sum(len(p) for p in prompts) - 3 * shared
    rec = _serve_rec(phase, cfg, st, full, wall, launches, want, {
        "prompt_lens": [len(p) for p in prompts], "shared_prefix": shared,
        "new_tokens": budget, "prefill_tokens_expected": want_prefill,
        "cache_dtype": cache_dtype, "cache_pages": ccfg.num_pages, "cache_gb": _cache_gb(eng),
        **(extra or {}),
    })
    rec["ok"] = (
        full and launches == want and quant_ok
        and all(launches[k] > 0 for k in ("flash_fwd", "paged_decode", "paged_prefill"))
        and st["free_pages"] == ccfg.num_pages and st["preemptions"] == 0
        and st["prefill_tokens"] == want_prefill
    )
    emit(rec)
    report[phase] = rec
    profile_key = "profile_chunked" if phase == "serve_chunked" else f"profile_{phase}"
    report[profile_key] = phase_profile(args, eng, cfg, prompt_len=1536, tag=phase)
    del eng
    torch.cuda.empty_cache()
    return rec


def _serve_prompts(rng, vocab, lens):
    return [rng.integers(0, vocab, size=int(n)).tolist() for n in lens]


MULTI_STEP = 8
SAMPLED = dict(greedy=False, temperature=0.8, top_k=50)


def phase_serve_multistep(args, cfg, params, engine_mod, kvcache, counters, report):
    """``run(multi_step=8)`` on the serve phase's model: 4 requests of
    100-1000 prompt tokens (all admitted at once, so nothing waits and the
    loop runs), 33 new tokens (the prefill's, then 4 loops of 8); whole-
    prompt prefill.  Greedy and sampled (temperature 0.8, top-k 50, seed
    --seed), each against ``multi_step=1`` on the same prompts: equal
    tokens, decode ms per token of both.  The greedy multi-step run has
    ``torch.cuda.set_sync_debug_mode("error")`` on around each
    ``decode_loop`` call, so a host sync inside the loop fails the phase.
    paged_decode must launch layers x steps, the loops' steps included."""
    transformer = engine_mod.transformer
    ccfg = kvcache.CacheConfig(
        num_layers=cfg.num_layers, num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim, page_size=256, num_pages=64, dtype="bfloat16",
    )
    prompts = _serve_prompts(np.random.default_rng(args.seed + 50), cfg.vocab_size,
                             np.random.default_rng(args.seed + 51).integers(100, 1001, size=4))
    budget = 1 + 4 * MULTI_STEP
    loop = transformer.decode_loop

    def no_sync_loop(*a, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return loop(*a, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    runs, ok = {}, True
    for mode in ("greedy", "sampled"):
        for ms in (1, MULTI_STEP):
            eng = engine_mod.Engine(params, cfg, ccfg, engine_mod.EngineConfig(
                max_batch=4, pages_per_seq=8, prefill_chunk=0, **({} if mode == "greedy" else SAMPLED)),
                seed=args.seed)
            ids = [eng.add_request(p, budget) for p in prompts]
            guard = mode == "greedy" and ms > 1
            transformer.decode_loop = no_sync_loop if guard else loop
            try:
                wall, launches = _drive(counters, lambda: eng.run(multi_step=ms))
            finally:
                transformer.decode_loop = loop
            st = eng.stats()
            want = dict.fromkeys(counters, 0)
            want.update(flash_fwd=cfg.num_layers * st["prefill_batches"],
                        paged_decode=cfg.num_layers * st["decode_batches"])
            _tc_expect(want, cfg)
            rec = {
                "multi_step": ms, "wall_s": wall, "stats": st, "launches": launches,
                "launches_expected": want, "sync_debug_error_mode": guard,
                "decode_ms_per_token": 1e3 * st["decode_s"] / st["decode_tokens"],
                "decode_tok_s": st["decode_tokens"] / st["decode_s"],
                "tokens": [eng.requests[i].output for i in ids],
            }
            rec["ok"] = (
                _finished(eng, ids, budget) and launches == want
                and st["decode_batches"] == budget - 1 and st["free_pages"] == ccfg.num_pages
                and st["steps"] == (budget - 1 if ms == 1 else (budget - 1) // ms)
            )
            ok = ok and rec["ok"]
            runs[f"{mode}_ms{ms}"] = rec
            del eng
    same = {m: runs[f"{m}_ms1"]["tokens"] == runs[f"{m}_ms{MULTI_STEP}"]["tokens"]
            for m in ("greedy", "sampled")}
    rec = {"phase": "serve_multistep", "model": "llama7b_attention", "layers": cfg.num_layers,
           "prompt_lens": [len(p) for p in prompts], "new_tokens": budget,
           "tokens_equal": same, "sampling": SAMPLED,
           **{k: {x: v for x, v in r.items() if x != "tokens"} for k, r in runs.items()},
           "ok": ok and all(same.values())}
    emit(rec)
    report["serve_multistep"] = rec
    torch.cuda.empty_cache()
    return rec


SPEC_K = 4


def _spec_drafts(truth, vocab):
    """The three draft sources of serve_speculative, over ``truth`` (req id
    -> prompt + the plain run's output): the true continuation (all
    accepted), tokens it never has at that position (all rejected), and the
    first true token then garbage."""

    def oracle(req, n):
        return truth[req.req_id][req.length: req.length + n]

    def garbage(req, n):
        nxt = truth[req.req_id][req.length: req.length + n]
        return [(t + 1 + j) % vocab for j, t in enumerate(nxt + [0] * (n - len(nxt)))]

    def half(req, n):
        return oracle(req, n)[: n // 2] + garbage(req, n)[n // 2:]

    return {"oracle": oracle, "garbage": garbage, "half": half}


def _spec_run(counters, cfg, eng, prompts, budget, drafts=None, k=SPEC_K):
    """One counted run: per token (``drafts`` None) or run_speculative."""
    ids = [eng.add_request(p, budget) for p in prompts]
    drive = eng.run if drafts is None else (lambda: eng.run_speculative(drafts, k=k))
    wall, launches = _drive(counters, drive)
    st = eng.stats()
    want = dict.fromkeys(counters, 0)
    steps = st["decode_batches"] + st["spec_steps"]
    want.update(flash_fwd=cfg.num_layers * st["prefill_batches"],
                paged_prefill=cfg.num_layers * st["chunk_rounds"],
                paged_decode=cfg.num_layers * steps,
                paged_decode_draft=cfg.num_layers * st["spec_steps"])
    quantized = eng.cache.config.quantized
    for kname in ("paged_decode", "paged_prefill"):
        want[f"{kname}_quant"] = want[kname] if quantized else 0
    _tc_expect(want, cfg)
    rec = {"wall_s": wall, "stats": st, "launches": launches, "launches_expected": want,
           "tokens": {i: eng.requests[i].output for i in ids}}
    if drafts is not None:
        rec.update(
            accepted_per_verify_step=st["spec_accepted"] / max(1, st["spec_steps"]),
            # the requests run in lockstep, all to the same budget
            accepted_per_request_step=st["spec_accepted"] / max(1, st["spec_steps"]) / len(ids),
            ms_per_verify_step=1e3 * st["spec_s"] / max(1, st["spec_steps"]),
            decode_tok_s=st["decode_tokens"] / (st["decode_s"] + st["spec_s"]),
        )
    else:
        rec.update(ms_per_step=1e3 * st["decode_s"] / st["decode_batches"],
                   decode_tok_s=st["decode_tokens"] / st["decode_s"])
    rec["ok"] = (_finished(eng, ids, budget) and launches == want
                 and st["free_pages"] == eng.cache.config.num_pages
                 and (drafts is None or launches["paged_decode_draft"] > 0))
    return rec


def _spec_cell(counters, cfg, make_engine, prompts, budget, kinds):
    """A plain run, then run_speculative with each draft source of
    ``kinds``; every run's tokens must equal the plain run's."""
    plain = _spec_run(counters, cfg, make_engine(), prompts, budget)
    truth = {i: p + plain["tokens"][i] for i, p in enumerate(prompts)}
    sources = _spec_drafts(truth, cfg.vocab_size)
    out = {"plain": plain}
    for kind in kinds:
        r = _spec_run(counters, cfg, make_engine(), prompts, budget, sources[kind])
        r["tokens_equal"] = r["tokens"] == plain["tokens"]
        r["ok"] = r["ok"] and r["tokens_equal"]
        out[kind] = r
    for r in out.values():
        del r["tokens"]
    return out


# The speculative phases serve float32 models, so that their tokens can be
# held equal to the plain run's.  A verify step computes the products of
# B * k rows where the plain run computes B rows, and cuBLAS sums them in
# another order: in bfloat16 the verify logits of the 32-layer Llama-7B-width
# model differ from the per-token ones by up to ~0.1, where bfloat16 often
# ties the top two logits exactly, and greedy tokens part; in float32 they
# differ by ~1e-5 against top-two gaps of ~1e-2 and more
# (torch_tools/spec_drift.py measures both).  serve_multistep's loop
# computes the per-token step's own products, so it serves bfloat16.


def phase_serve_speculative(args, transformer, engine_mod, kvcache, counters, report):
    """``run_speculative(k=4)`` on Llama-7B's width and 32 layers in float32
    (serve_multistep's prompts, whole-prompt prefill, 33 new tokens): oracle
    drafts (the plain run's own continuation: all accepted), garbage (all
    rejected) and half right; then on an int8 KV cache with oracle drafts
    (the 8-bit draft form).  Tokens must equal the plain run's each time;
    the draft form must launch layers x verify steps."""
    cfg = dataclasses.replace(transformer.ModelConfig.llama7b_attention(), num_layers=args.layers,
                              dtype="float32")
    params = transformer.init_params(args.seed, cfg)
    prompts = _serve_prompts(np.random.default_rng(args.seed + 50), cfg.vocab_size,
                             np.random.default_rng(args.seed + 51).integers(100, 1001, size=4))
    budget = 33

    def make(dtype):
        return lambda: engine_mod.Engine(params, cfg, kvcache.CacheConfig(
            num_layers=cfg.num_layers, num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
            page_size=256, num_pages=24, dtype=dtype,
        ), engine_mod.EngineConfig(max_batch=4, pages_per_seq=8, prefill_chunk=0))

    torch.cuda.reset_peak_memory_stats()
    cells = {
        "f32_cache": _spec_cell(counters, cfg, make("float32"), prompts, budget,
                                ("oracle", "garbage", "half")),
        "int8_cache": _spec_cell(counters, cfg, make("int8"), prompts, budget, ("oracle",)),
    }
    rec = {"phase": "serve_speculative", "model": "llama7b_attention", "dtype": "float32",
           "layers": cfg.num_layers, "k": SPEC_K, "prompt_lens": [len(p) for p in prompts],
           "new_tokens": budget, **cells, "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
           "ok": all(r["ok"] for c in cells.values() for r in c.values())}
    emit(rec)
    report["serve_speculative"] = rec
    del params
    torch.cuda.empty_cache()
    return rec


def phase_serve_speculative_gemma2(args, transformer, engine_mod, kvcache, counters, report):
    """Gemma-2-9B-class at full width and 42 layers in float32 (40.6 GB) on
    the chunked engine: two prompts of 4600-5000 tokens (past the window),
    17 new tokens, plain and with oracle drafts at k = 4, so the draft form
    runs with the window and softcap at d = 256; tokens must equal."""
    cfg = dataclasses.replace(transformer.ModelConfig.gemma2_9b(num_layers=42), dtype="float32")
    params = transformer.init_params(args.seed, cfg)
    rng = np.random.default_rng(args.seed + 52)
    prompts = _serve_prompts(rng, cfg.vocab_size, rng.integers(4600, 5001, size=2))
    budget = 17

    def make():
        return engine_mod.Engine(params, cfg, _gemma_cache(kvcache, cfg, 44, "float32"),
                                 engine_mod.EngineConfig(max_batch=4, pages_per_seq=24,
                                                         prefill_chunk=512))

    torch.cuda.reset_peak_memory_stats()
    cell = _spec_cell(counters, cfg, make, prompts, budget, ("oracle",))
    rec = {"phase": "serve_speculative_gemma2", "model": GEMMA_MODEL, "dtype": "float32",
           "layers": cfg.num_layers, "k": SPEC_K, "prompt_lens": [len(p) for p in prompts],
           "new_tokens": budget, **cell, "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
           "ok": all(r["ok"] for r in cell.values())}
    emit(rec)
    report["serve_speculative_gemma2"] = rec
    del params
    torch.cuda.empty_cache()
    return rec


GEMMA_MODEL = "gemma2_9b: 16 q / 8 KV heads, d=256, window 4096, softcap 50"


def _gemma_cache(kvcache, cfg, num_pages, dtype="bfloat16"):
    return kvcache.CacheConfig(
        num_layers=cfg.num_layers, num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim, page_size=256, num_pages=num_pages, dtype=dtype,
    )


def phase_serve_gemma2(args, cfg, params, engine_mod, kvcache, counters, report, *,
                       cache_dtype="bfloat16", phase="serve_gemma2"):
    """Gemma-2-9B-class at full width on the default chunked engine: a donor
    with a 1024-token prefix and one prompt sharing it, two unique prompts
    of 4600-5800 tokens (past the window), one short prompt (whole, on
    flash_fwd); 32 greedy new tokens each.  Then a profile.  With
    ``cache_dtype="fp8"`` (serve_gemma2_fp8) the paged kernels' 8-bit forms
    run with the window, the softcap and d = 256."""
    ccfg = _gemma_cache(kvcache, cfg, 80, cache_dtype)
    eng = engine_mod.Engine(
        params, cfg, ccfg,
        engine_mod.EngineConfig(max_batch=4, pages_per_seq=24, prefill_chunk=512),
    )
    rng = np.random.default_rng(args.seed + 40)
    tok = lambda n: rng.integers(0, cfg.vocab_size, size=int(n)).tolist()  # noqa: E731
    budget, shared = 32, 1024
    prefix = tok(shared)
    prompts = [prefix + tok(100), prefix + tok(rng.integers(64, 401))]  # donor, prefix hit
    prompts += [tok(n) for n in rng.integers(4600, 5801, size=2)]  # long, past the window
    prompts += [tok(rng.integers(64, 512))]  # short: whole-prompt on flash_fwd
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
    want = dict.fromkeys(counters, 0)
    want.update(flash_fwd=cfg.num_layers * st["prefill_batches"],
                paged_decode=cfg.num_layers * st["decode_batches"],
                paged_prefill=cfg.num_layers * st["chunk_rounds"])
    quant_ok = _quant_launches(want, launches, ccfg.quantized)
    want_prefill = sum(len(p) for p in prompts) - shared
    rec = _serve_rec(phase, cfg, st, full, wall, launches, want, {
        "prompt_lens": [len(p) for p in prompts], "shared_prefix": shared,
        "new_tokens": budget, "prefill_tokens_expected": want_prefill, "cache_dtype": cache_dtype,
        "cache_pages": ccfg.num_pages, "cache_gb": _cache_gb(eng),
    }, model=GEMMA_MODEL)
    rec["ok"] = (
        full and launches == want and quant_ok
        and all(launches[k] > 0 for k in ("flash_fwd", "paged_decode", "paged_prefill"))
        and st["free_pages"] == ccfg.num_pages and st["preemptions"] == 0
        and st["prefill_tokens"] == want_prefill
    )
    emit(rec)
    report[phase] = rec
    profile_key = "profile_gemma2" if phase == "serve_gemma2" else f"profile_{phase}"
    report[profile_key] = phase_profile(args, eng, cfg, prompt_len=1536, tag=phase)
    del eng
    torch.cuda.empty_cache()
    return rec


def phase_serve_gemma2_whole(args, cfg, params, engine_mod, kvcache, counters, report):
    """The same model with whole-prompt prefill (prefill_chunk=0): two
    prompts of 4600-5000 tokens, one prefill batch padded to the 8192 bucket
    (logits 2 x 8192 x 256128 bf16 = 8.4 GB), so flash_fwd's window masks on
    the serving path; 32 greedy new tokens each."""
    ccfg = _gemma_cache(kvcache, cfg, 48)
    eng = engine_mod.Engine(
        params, cfg, ccfg,
        engine_mod.EngineConfig(max_batch=4, pages_per_seq=24, prefill_chunk=0),
    )
    rng = np.random.default_rng(args.seed + 41)
    lens = rng.integers(4600, 5001, size=2)
    budget = 32
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).tolist() for n in lens]
    ids = []

    def drive():
        ids.extend(eng.add_request(p, budget) for p in prompts)
        eng.run()

    torch.cuda.reset_peak_memory_stats()
    wall, launches = _drive(counters, drive)
    full = _finished(eng, ids, budget)
    st = eng.stats()
    want = dict.fromkeys(counters, 0)
    want.update(flash_fwd=cfg.num_layers * st["prefill_batches"],
                paged_decode=cfg.num_layers * st["decode_batches"])
    rec = _serve_rec("serve_gemma2_whole", cfg, st, full, wall, launches, want, {
        "prompt_lens": lens.tolist(), "new_tokens": budget, "cache_pages": ccfg.num_pages,
        "cache_gb": _cache_gb(eng),
    }, model=GEMMA_MODEL)
    rec["ok"] = (
        full and launches == want and launches["flash_fwd"] > 0
        and launches["paged_decode"] > 0 and st["free_pages"] == ccfg.num_pages
        and st["prefill_tokens"] == int(lens.sum())
    )
    emit(rec)
    report["serve_gemma2_whole"] = rec
    del eng
    torch.cuda.empty_cache()
    return rec


def _cache_gb(eng):
    """The pools' size: K and V payloads, and their scales for an 8-bit cache."""
    c = eng.cache
    return sum(t.numel() * t.element_size()
               for t in (c.k_pages, c.v_pages, c.k_scales, c.v_scales) if t is not None) / 1e9


def phase_profile(args, eng, cfg, *, prompt_len, tag):
    """Where the serving time goes: 4 more requests (``prompt_len``-token
    prompts, 8 new tokens) through the same engine after the counted run.
    The two runs of :func:`_profile` draw different prompts, so the second
    finds no prefix of the first."""

    def workload(seed):
        rng = np.random.default_rng(seed)
        for _ in range(4):
            eng.add_request(rng.integers(0, cfg.vocab_size, size=prompt_len).tolist(), 8)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e6

    return _profile(
        lambda run: workload(args.seed + 2 + run), f"profile/{tag}",
        {"requests": 4, "prompt_len": prompt_len, "new_tokens": 8},
    )


def _kernel_of(name):
    """The KERNELS entry a profiled device kernel belongs to, or None: the
    forward template's paged form (its fifth template argument, kPaged,
    true) is paged_prefill_tc, and its 8-bit form (the sixth, kKV, not 0)
    the ``_quant`` one; the d = 256 backward kernel is flash_bwd_tc's."""
    m = re.search(r"flash_fwd_tc_kernel<([^<>]*)>", name)
    if m:
        args = [a.strip() for a in m.group(1).split(",")]
        paged = args[4] in ("true", "1", "(bool)1")
        quant = len(args) > 5 and args[5] not in ("0", "(int)0")
        return ("paged_prefill_tc" if paged else "flash_fwd_tc") + ("_quant" if quant else "")
    if "flash_bwd_tc_d256_kernel" in name:
        return "flash_bwd_tc"
    return next((k for k, _, _ in KERNELS if f"{k}_kernel" in name), None)


def _profile(workload, phase, extra):
    """Run ``workload(run)`` (returns its wall microseconds) once untraced
    for the wall time (run 0) and once under torch.profiler (run 1; device
    activity only, so the host is not slowed by op tracing).  Reports the
    device's busy share of the untraced wall time and the kernels that took
    the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    wall_us = workload(0)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        traced_us = workload(1)
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
    ours = dict.fromkeys((k for k, _, _ in KERNELS), 0.0)
    for n, (_, t) in by_name.items():
        k = _kernel_of(n)
        if k:
            ours[k] += t / 1e3
    # cuBLAS matrix products (the model's projections, MLP and LM head).
    gemm = sum(t for n, (_, t) in by_name.items() if any(g in n for g in ("nvjet", "gemm", "xmma")))
    # Copies and dtype casts (on the int8-weight path: each weight's upcast
    # to bfloat16 before its product).
    copies = sum(t for n, (_, t) in by_name.items() if "copy" in n)
    rec = {
        "phase": phase, **extra,
        "wall_ms": wall_us / 1e3, "traced_wall_ms": traced_us / 1e3,
        "kernels_total_ms": sum(t for _, t in by_name.values()) / 1e3,
        "gemm_device_ms": gemm / 1e3,
        "copy_device_ms": copies / 1e3,
        "device_busy_ms": busy / 1e3 if spans else "not measured",
        "device_idle_share": 1 - busy / wall_us if spans else "not measured",
        "kernel_device_ms": ours,
        "top_kernels": [
            {"name": n[:80], "calls": c, "ms": t / 1e3} for n, (c, t) in top
        ],
    }
    emit(rec)
    return rec


def _to_card(params, device="cuda"):
    """A parameter tree on ``device``: tensors and quantized leaves alike."""
    return {k: ([{n: w.to(device) for n, w in lay.items()} for lay in v] if isinstance(v, list)
                else v.to(device)) for k, v in params.items()}


def _pool_steps(a, b):
    """(elements that differ, most steps between them) of two 8-bit pools:
    int8 values, or fp8 codes (neighbouring e4m3 values of one sign differ
    by one in their low 7 bits)."""
    a, b = a.cpu(), b.cpu()
    if a.dtype == torch.int8:
        ai, bi = a.int(), b.int()
    else:
        ai, bi = (x.view(torch.uint8).int() for x in (a, b))
        ai, bi = (torch.where(x >= 128, 128 - x, x) for x in (ai, bi))
    diff = (ai - bi).abs()
    return int((diff > 0).sum()), int(diff.max())


def _cache_diff(cpu_cache, gpu_cache):
    """How the card's 8-bit pools differ from the CPU's: a K/V value at a
    half step can round to neighbouring steps on the two sides, since their
    float32 sums run in other orders."""
    out = {"elements": cpu_cache.k_pages.numel() * 2}
    for name, sc in (("k_pages", "k_scales"), ("v_pages", "v_scales")):
        a, b = getattr(cpu_cache, name), getattr(gpu_cache, name)
        n, steps = _pool_steps(a, b)
        # The largest difference of the dequantized values, over the row's
        # absmax (an fp8 code step is finest near zero).
        sa, sb = getattr(cpu_cache, sc), getattr(gpu_cache, sc).cpu()
        qmax = 127.0 if a.dtype == torch.int8 else 448.0
        deq = (a.float() * sa[..., None] - b.cpu().float() * sb[..., None]).abs()
        out[name] = {"differ": n, "max_steps": steps,
                     "max_err_over_absmax": float((deq / (qmax * sa[..., None])).max())}
    for name in ("k_scales", "v_scales"):
        a, b = getattr(cpu_cache, name), getattr(gpu_cache, name).cpu()
        out[f"{name}_max_rel_err"] = float(((a - b).abs() / a.abs()).max())
    return out


def _parity_whole(transformer, kvcache, cfg, cpu_params, gpu_params, prompt, cache_dtype="float32"):
    """One request through whole-prompt prefill and 4 decode steps, on the
    CPU (plain versions) and on the card (kernels) with the CPU's tokens:
    (max abs error of every logits row, the rows' largest magnitude, how
    the 8-bit pools differ or None)."""

    def run(params, device, feed):
        cache = kvcache.PagedKVCache(kvcache.CacheConfig(
            num_layers=2, num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
            page_size=256, num_pages=2, dtype=cache_dtype,
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
                lengths, table, as_t(page), as_t(slot), cfg, cache.k_scales, cache.v_scales,
            )[0])
        return torch.stack(rows).cpu(), toks, cache

    want, toks, cpu_cache = run(cpu_params, "cpu", None)
    got, _, gpu_cache = run(gpu_params, "cuda", toks)  # the CPU's tokens, so inputs match
    diff = _cache_diff(cpu_cache, gpu_cache) if cpu_cache.config.quantized else None
    return err(got, want), float(want.abs().max()), diff


def phase_parity(args, transformer, kvcache, engine_mod, report):
    cfg = dataclasses.replace(
        transformer.ModelConfig.llama7b_attention(), num_layers=2, dtype="float32"
    )
    cpu_params = transformer.init_params(args.seed, cfg, device="cpu")
    gpu_params = _to_card(cpu_params)
    prompt = np.random.default_rng(args.seed + 1).integers(0, cfg.vocab_size, size=64)
    e, absmax, _ = _parity_whole(transformer, kvcache, cfg, cpu_params, gpu_params, prompt)
    rec = {"phase": "parity", "layers": 2, "dtype": "float32", "prompt_len": 64,
           "decode_steps": 4, "max_abs_err": e, "tol": PARITY_TOL,
           "logit_absmax": absmax, "ok": e <= PARITY_TOL}
    emit(rec)
    report["parity"] = rec
    rng = np.random.default_rng(args.seed + 4)
    first = rng.integers(0, cfg.vocab_size, size=600).tolist()
    second = first[:256] + rng.integers(0, cfg.vocab_size, size=100).tolist()
    report["parity_chunked"] = parity_chunked(
        cfg, cpu_params, gpu_params, kvcache, engine_mod, first, second, "parity_chunked"
    )
    return rec


def phase_parity_quant(args, transformer, quant, kvcache, engine_mod, report):
    """The same 2-layer float32 cut at Llama width with int8 weights and an
    int8 KV cache: whole-prompt prefill with 4 decode steps, and the chunked
    engine with a prefix hit, card against CPU within PARITY_QUANT_TOL.  The
    weights are quantized once on the CPU and moved, so both sides hold the
    same payloads; the K/V payloads each side writes are compared too."""
    cfg = dataclasses.replace(
        transformer.ModelConfig.llama7b_attention(), num_layers=2, dtype="float32"
    )
    cpu_params = quant.quantize_weights(transformer.init_params(args.seed, cfg, device="cpu"), "int8")
    gpu_params = _to_card(cpu_params)
    prompt = np.random.default_rng(args.seed + 1).integers(0, cfg.vocab_size, size=64)
    e, absmax, diff = _parity_whole(transformer, kvcache, cfg, cpu_params, gpu_params, prompt, "int8")
    rec = {"phase": "parity_quant", "layers": 2, "dtype": "float32", "weights": "int8",
           "cache_dtype": "int8", "prompt_len": 64, "decode_steps": 4, "max_abs_err": e,
           "tol": PARITY_QUANT_TOL, "logit_absmax": absmax, "pool_diff": diff,
           "ok": e <= PARITY_QUANT_TOL}
    emit(rec)
    report["parity_quant"] = rec
    rng = np.random.default_rng(args.seed + 4)
    first = rng.integers(0, cfg.vocab_size, size=600).tolist()
    second = first[:256] + rng.integers(0, cfg.vocab_size, size=100).tolist()
    report["parity_quant_chunked"] = parity_chunked(
        cfg, cpu_params, gpu_params, kvcache, engine_mod, first, second, "parity_quant_chunked",
        "int8", PARITY_QUANT_TOL,
    )
    return rec


def phase_quant_ops(fa, flash, quant, gen, report):
    """The public 8-bit attention entry points: ``attention_quantized`` on
    folded (B*H, S, d) tensors and ``attention(k_scales=, v_scales=)`` on
    (B, H, S, d) ones with (B, H_kv, S) scales, B = 4, H = 32, S = 1024,
    d = 128, causal, bfloat16 q, int8 K/V; each launches the flash
    kernel's tensor-core 8-bit form once and the two agree."""
    b, h, s, d = 4, 32, 1024, 128
    kq, vq = (_kv(gen, (b * h, s, d), None, "int8") for _ in range(2))
    q = torch.randn((b * h, s, d), generator=gen, device="cuda").to(torch.bfloat16)
    flash.flash_attention.launches = flash.flash_attention.launches_quantized = 0
    flash.flash_attention.launches_tc = flash.flash_attention.launches_tc_quantized = 0
    o1 = fa.attention_quantized(q, quant.QuantizedTensor(*kq), quant.QuantizedTensor(*vq),
                                causal=True, scale=d**-0.5)
    o2 = fa.attention(q.reshape(b, h, s, d), kq[0].reshape(b, h, s, d), vq[0].reshape(b, h, s, d),
                      causal=True, scale=d**-0.5, k_scales=kq[1].reshape(b, h, s),
                      v_scales=vq[1].reshape(b, h, s))
    torch.cuda.synchronize()
    launches = {"flash_fwd": flash.flash_attention.launches,
                "flash_fwd_quant": flash.flash_attention.launches_quantized,
                "flash_fwd_tc": flash.flash_attention.launches_tc,
                "flash_fwd_tc_quant": flash.flash_attention.launches_tc_quantized}
    e = err(o1.reshape(o2.shape), o2)
    rec = {"phase": "quant_ops", "shape": f"B={b} H={h} S={s} d={d} causal, bf16 q, int8 K/V",
           "max_abs_err": e, "tol": 0.0, "launches": launches,
           "ok": e == 0.0 and launches == {"flash_fwd": 2, "flash_fwd_quant": 2, "flash_fwd_tc": 2,
                                           "flash_fwd_tc_quant": 2}}
    emit(rec)
    report["quant_ops"] = rec
    return rec


def _mm_times(transformer, benchit, layer, rows):
    """One layer's seven weight products at ``rows`` activation rows, bf16:
    the int8 path (``transformer._mm``: upcast, product, scale), the upcasts
    alone, and the products on bfloat16 weights (dequantized beforehand),
    each summed over the seven matrices (ms)."""
    out = {"rows": rows, "int8_mm_ms": 0.0, "upcast_ms": 0.0, "bf16_mm_ms": 0.0}
    for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        w = layer[name]
        x = torch.randn((rows, w.shape[0]), device="cuda").to(torch.bfloat16)
        wb = (w.payload.float() * w.scales).to(torch.bfloat16)
        out["int8_mm_ms"] += benchit.cuda_time_ms(lambda: transformer._mm(x, w))
        out["upcast_ms"] += benchit.cuda_time_ms(lambda: w.payload.to(torch.bfloat16))
        out["bf16_mm_ms"] += benchit.cuda_time_ms(lambda: x @ wb)
        del wb
    return out


def phase_serve_int8(args, cfg, params, transformer, quant, engine_mod, kvcache, benchit, counters,
                     report):
    """Llama-7B width at its published depth with int8 weights and an int8
    KV cache (page 256, 64 pages) on serve_chunked's engine and prompts.
    The bfloat16 parameters are quantized in place, layer by layer, so that
    each layer's bfloat16 leaves are freed as its int8 ones are made.  Also
    times one layer's weight products on the int8 path against bfloat16
    weights."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for layer in params["layers"]:
        layer.update(quant.quantize_weights(layer, "int8"))
    params.update(quant.quantize_weights({k: v for k, v in params.items() if k != "layers"}, "int8"))
    qparams = params
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    weights_gb = sum(
        t.numel() * t.element_size()
        for leaf in [qparams["embed"], qparams["lm_head"], qparams["final_norm"],
                     *(w for lay in qparams["layers"] for w in lay.values())]
        for t in ((leaf.payload, leaf.scales) if isinstance(leaf, quant.QuantizedWeight) else (leaf,))
    ) / 1e9
    extra = {"weights": "int8", "weights_gb": weights_gb, "quantize_s": quantize_s,
             "quantize_peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
             "mm_decode": _mm_times(transformer, benchit, qparams["layers"][0], 4),
             "mm_chunk": _mm_times(transformer, benchit, qparams["layers"][0], 2048)}
    rec = phase_serve_chunked(args, cfg, qparams, engine_mod, kvcache, counters, report,
                              cache_dtype="int8", phase="serve_int8", extra=extra)
    torch.cuda.empty_cache()
    return rec


def parity_chunked(cfg, cpu_params, gpu_params, kvcache, engine_mod, first, second, phase,
                   cache_dtype="float32", tol=None):
    """The chunked engine on a 2-layer float32 cut (page_size 128, chunk
    256): ``first`` in chunk rounds, then ``second``, which shares its first
    256 tokens (a prefix hit) and prefills the rest; 4 decode steps each.
    Every logits row the engine samples from, card against CPU, within
    ``tol`` (PARITY_TOL); with an 8-bit cache, how its pools differ."""
    tol = tol or PARITY_TOL

    class Recording(engine_mod.Engine):
        def _sample_rows(self, reqs, logits):
            self.rows.append(logits.float().cpu())
            return super()._sample_rows(reqs, logits)

    def run(params, device):
        eng = Recording(params, cfg, kvcache.CacheConfig(
            num_layers=2, num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
            page_size=128, num_pages=16, dtype=cache_dtype,
        ), engine_mod.EngineConfig(max_batch=2, pages_per_seq=8, prefill_chunk=256),
            device=device)
        eng.rows, outs = [], []
        for p in (first, second):
            rid = eng.add_request(p, 5)
            outs.append(eng.run()[rid])
        st = eng.stats()
        return torch.cat(eng.rows), outs, st["chunk_rounds"], st["prefill_tokens"], eng.cache

    want, want_toks, rounds, tokens, cpu_cache = run(cpu_params, "cpu")
    got, got_toks, _, _, gpu_cache = run(gpu_params, "cuda")
    same = got_toks == want_toks
    e = err(got, want) if same else float("inf")
    rec = {"phase": phase, "layers": 2, "dtype": "float32", "page_size": 128,
           "chunk": 256, "prompt_lens": [len(first), len(second)], "shared_prefix": 256,
           "decode_steps": 4, "chunk_rounds": rounds, "prefill_tokens": tokens,
           "cache_dtype": cache_dtype, "tokens_equal": same, "max_abs_err": e, "tol": tol,
           "logit_absmax": float(want.abs().max()),
           "ok": same and e <= tol and tokens == len(first) + len(second) - 256}
    if cpu_cache.config.quantized:
        rec["pool_diff"] = _cache_diff(cpu_cache, gpu_cache)
    emit(rec)
    return rec


def phase_parity_gemma2(args, transformer, kvcache, engine_mod, report):
    """Gemma-2-9B-class at full width, cut to 2 float32 layers, with the
    window cut from 4096 to 128 so that a 300-token prompt crosses it (the
    CPU side computes 256128-wide logits for every prompt row) and the
    softcap kept at 50: whole-prompt prefill with 4 decode steps, and the
    chunked engine with a prefix hit; card against CPU, logits within
    PARITY_TOL.  Then the same with fp8 pages (parity_quant_gemma2), within
    PARITY_QUANT_TOL.  The parameters are drawn on the card and copied."""
    cfg = dataclasses.replace(
        transformer.ModelConfig.gemma2_9b(num_layers=2), dtype="float32", sliding_window=128
    )
    gpu_params = transformer.init_params(args.seed, cfg)
    cpu_params = {k: (v.cpu() if torch.is_tensor(v) else [{n: w.cpu() for n, w in lay.items()} for lay in v])
                  for k, v in gpu_params.items()}
    rng = np.random.default_rng(args.seed + 42)
    prompt = rng.integers(0, cfg.vocab_size, size=300)
    first = prompt.tolist()
    second = first[:256] + rng.integers(0, cfg.vocab_size, size=100).tolist()
    # float32 pages (parity_gemma2), then fp8 pages (parity_quant_gemma2).
    for phase, cache_dtype, tol in (("parity_gemma2", "float32", PARITY_TOL),
                                    ("parity_quant_gemma2", "fp8", PARITY_QUANT_TOL)):
        t0 = time.perf_counter()
        e, absmax, diff = _parity_whole(transformer, kvcache, cfg, cpu_params, gpu_params, prompt,
                                        cache_dtype)
        rec = {"phase": phase, "layers": 2, "dtype": "float32", "cache_dtype": cache_dtype,
               "window": cfg.sliding_window, "logit_softcap": cfg.logit_softcap, "prompt_len": 300,
               "decode_steps": 4, "max_abs_err": e, "tol": tol,
               "logit_absmax": absmax, "ok": e <= tol}
        if diff is not None:
            rec["pool_diff"] = diff
        report[f"{phase}_chunked"] = parity_chunked(
            cfg, cpu_params, gpu_params, kvcache, engine_mod, first, second, f"{phase}_chunked",
            cache_dtype, tol,
        )
        rec["seconds"] = time.perf_counter() - t0
        emit(rec)
        report[phase] = rec
    del gpu_params, cpu_params
    torch.cuda.empty_cache()
    return rec


def _verify_logits(transformer, kvcache, cfg, params, device, prompt, drafts):
    """Whole-prompt prefill of ``prompt`` into a fresh float32 cache, then
    one ``verify_step`` of [the prefill's greedy token, *drafts]: (verify
    logits (k, V) on the CPU, the fed tokens)."""
    cache = kvcache.PagedKVCache(kvcache.CacheConfig(
        num_layers=cfg.num_layers, num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
        page_size=256, num_pages=4, dtype="float32",
    ), device=device)
    logits, k, v = transformer.prefill(params, torch.tensor(prompt[None], device=device), cfg)
    cache.append(0, k[:, 0], v[:, 0])
    fed = [int(logits[0, -1].argmax())] + list(drafts)
    start = cache.length(0)
    slots = [cache.reserve_slot(0) for _ in fed]
    _, table = cache.batch_view([0], 4)
    out = transformer.verify_step(
        params, torch.tensor([fed], device=device), torch.tensor([start], device=device),
        cache.k_pages, cache.v_pages, table, torch.tensor([[p for p, _ in slots]]),
        torch.tensor([[s for _, s in slots]]), cfg)
    return out[0].float().cpu(), fed


def phase_parity_speculative(args, transformer, kvcache, report):
    """``verify_step`` on 2-layer float32 cuts at full width, k = 4, the
    card (the draft form) against the CPU (plain versions) and against the
    card's prefill logits of prompt + fed tokens at the fed positions
    (JAX's test_verify_step_matches_prefill_logits), each within
    PARITY_TOL: Llama-7B's attention after a 64-token prompt, and
    Gemma-2-9B-class with its window cut to 128 after a 300-token prompt
    (as parity_gemma2), so that the fed rows' windows start past column 0."""
    recs = {}
    for name, cfg, n in (
        ("llama", dataclasses.replace(transformer.ModelConfig.llama7b_attention(), num_layers=2,
                                      dtype="float32"), 64),
        ("gemma2", dataclasses.replace(transformer.ModelConfig.gemma2_9b(num_layers=2),
                                       dtype="float32", sliding_window=PARITY_WINDOW), 300),
    ):
        t0 = time.perf_counter()
        gpu_params = transformer.init_params(args.seed, cfg)
        cpu_params = _to_card(gpu_params, "cpu")
        rng = np.random.default_rng(args.seed + 60)
        prompt = rng.integers(0, cfg.vocab_size, size=n)
        drafts = rng.integers(0, cfg.vocab_size, size=SPEC_K - 1).tolist()
        want, fed = _verify_logits(transformer, kvcache, cfg, cpu_params, "cpu", prompt, drafts)
        got, fed_card = _verify_logits(transformer, kvcache, cfg, gpu_params, "cuda", prompt, drafts)
        full = torch.tensor(np.concatenate([prompt, fed])[None], device="cuda")
        ref = transformer.prefill(gpu_params, full, cfg)[0][0, n:].float().cpu()
        e_cpu, e_prefill = err(got, want), err(got, ref)
        recs[name] = {"prompt_len": n, "k": SPEC_K, "window": cfg.sliding_window,
                      "logit_softcap": cfg.logit_softcap, "fed_equal": fed == fed_card,
                      "max_abs_err_vs_cpu": e_cpu, "max_abs_err_vs_prefill": e_prefill,
                      "logit_absmax": float(want.abs().max()), "seconds": time.perf_counter() - t0,
                      "ok": fed == fed_card and e_cpu <= PARITY_TOL and e_prefill <= PARITY_TOL}
        del gpu_params, cpu_params
        torch.cuda.empty_cache()
    rec = {"phase": "parity_speculative", "layers": 2, "dtype": "float32", "tol": PARITY_TOL,
           **recs, "ok": all(r["ok"] for r in recs.values())}
    emit(rec)
    report["parity_speculative"] = rec
    return rec


def _packed_ids(packing, seed, b, s, vocab=32000, lo=64, hi=2048):
    """(tokens, segment ids) of ``b`` rows of ``s`` tokens, packed first fit
    from random documents of ``lo``-``hi`` tokens; the first ``b`` rows."""
    rng = np.random.default_rng(seed)
    docs = []
    while True:
        docs += [rng.integers(0, vocab, size=int(n)) for n in rng.integers(lo, hi + 1, size=8)]
        tokens, segs = packing.pack_documents(docs, s)
        if len(tokens) >= 2 * b:  # later rows are the least filled; keep the first
            return tokens[:b], segs[:b]


def _fold_ids(seg, kvh, g):
    """(B, S) ids -> the (B*KVH, G*S) q and (B*KVH, S) KV layouts of the
    training forward (g-major rows per KV head)."""
    b, s = seg.shape
    return (seg[:, None, None, :].expand(b, kvh, g, s).reshape(b * kvh, g * s).contiguous(),
            seg[:, None, :].expand(b, kvh, s).reshape(b * kvh, s).contiguous())


def _live_pairs(flash, bh, rows, s_kv, kw, segs):
    """(query row, key column) pairs the kernels compute, summed over the
    ``bh`` heads (segment ids: ``(bh, rows)`` and ``(bh, s_kv)``; a sliding
    window: ``kw["window"]``)."""
    mask = flash.visible(rows, s_kv, causal=kw["causal"], kv_len=kw["kv_len"] or s_kv,
                         q_offset=kw["q_offset"], q_seq_len=kw["q_seq_len"],
                         window=kw.get("window"), device="cuda", **segs)
    return int(mask.sum()) * (1 if segs else bh)


def _bwd_got(q, kw, runs, wants):
    """``{kernel: (gradients, plain gradients)}`` of a ``_bwd_case``: the
    fused kernel's (dq, dk, dv), and each kernel of the pair its own (dq;
    dk, dv), the scalar pair's beside the tensor-core form's."""
    bm = kw.get("block_mask") is not None
    got = {}
    if "fused" in runs:
        got[_kname("flash_bwd", q)] = (runs["fused"], wants["fused"])
    for run in ("two_pass", "two_pass_scalar"):
        if run in runs:
            for k, part in zip(PAIR, (slice(0, 1), slice(1, 3))):
                kname = _kname(k, q, block_mask=bm) if run == "two_pass" else k
                got[kname] = (runs[run][part], wants[run][part])
    return got


def _bwd_rec(check, got, want, dt, **extra):
    """A backward kernel check's record over the gradients it returns:
    ``_rec``'s max-abs bound (BWD_TOL) on each, and in bfloat16 each element
    within BF16_ELEM_TOL."""
    recs = [_rec(check, g_, w, dt, BWD_TOL[dt]) for g_, w in zip(got, want)]
    rec = {"check": check, "max_abs_err": max(r["max_abs_err"] for r in recs),
           "tol": BWD_TOL[dt], "ok": all(r["ok"] for r in recs)}
    if dt == "bfloat16":
        rec.update(elem_err=max(r["elem_err"] for r in recs), elem_tol=list(BF16_ELEM_TOL))
    return {**rec, **extra}


def _bwd_case(backward, flash, q, k, v, do, kw, segs):
    """One backward case: o and lse from the forward kernel, the plain
    backward (float32 from the same inputs) and the kernels' gradients.
    Returns (ins, plain, wants, runs): ``runs`` holds the two-pass pair's
    (``two_pass``; where that is its tensor-core form, the scalar pair's
    beside it under ``ops.flash.scalar_forms``, ``two_pass_scalar``) and,
    without segment ids or a block mask, the fused kernel's ``(dq, dk,
    dv)``; ``wants`` the plain backward's for each, with the rounding of the
    form that ran (the tensor-core forms split Z and dS into two bf16
    terms); ``plain`` computes the fused one's where it ran, else the
    pair's."""
    o, l, m = flash.flash_attention(q, k, v, save_residuals=True, **kw, **segs)
    lse = m + torch.log(torch.where(l == 0, 1.0, l))
    ins = (q, k, v, o, lse, do)
    fp32 = [x.float() for x in ins]

    def plain_of(form):
        return lambda: backward.flash_attention_bwd_plain(*fp32, form=form, **kw, **segs)

    pair = backward.bwd_form(q, False, kw.get("block_mask") is not None)
    plain = plain_of(pair)
    wants = {"two_pass": plain()}
    runs = {"two_pass": backward.flash_attention_bwd(*ins, fused=False, **kw, **segs)}
    if pair != "scalar":
        wants["two_pass_scalar"] = plain_of("scalar")()
        with flash.scalar_forms():
            runs["two_pass_scalar"] = backward.flash_attention_bwd(*ins, fused=False, **kw, **segs)
    if not segs and kw.get("block_mask") is None:
        runs["fused"] = backward.flash_attention_bwd(*ins, fused=True, **kw)
        form = backward.bwd_form(q, True)
        plain = plain_of(form)
        wants["fused"] = wants["two_pass"] if form == pair else plain()
    torch.cuda.synchronize()
    return ins, plain, wants, runs


def bwd_checks(backward, flash, benchit, packing, args, gen, card, report):
    """The three backward kernels against the plain backward (float32 from
    the same inputs).  Cases: the training layer (B=8, 8 KV heads x G=4,
    S=2048, d=128, causal; float32 at B=2), the packed training layer (the
    same with segment ids from packed documents), a ragged S=300 with and
    without segment ids (PAD_SEGMENT rows included), kv_len / q_offset, and
    head_dim 64 with segment ids (B=2, 4 KV heads x G=2, S=1000, documents
    of 64-600 tokens and padding).  The fused kernel runs every case
    without segment ids, the two-pass pair every case (in bf16 its
    tensor-core form, and the scalar pair beside it under
    ``ops.flash.scalar_forms``); each gradient within BWD_TOL and, in bf16,
    each element within BF16_ELEM_TOL (``_bwd_rec``).  o and lse come from
    the forward kernel; do is drawn at a quarter of the scale of q, k, v
    (see below), and each record carries the gradients' largest magnitudes.
    Timed at the bf16 training shapes: the fused backward
    (``flash_attention_bwd``, which computes di and casts dQ too) on the
    plain layer with the pair beside it (``report["pair_vs_fused"]``), each
    two-pass kernel, both forms, on the packed layer."""
    mains, yardsticks = {}, {}
    _, seg_np = _packed_ids(packing, args.seed + 5, TRAIN_B, TRAIN_S)
    packed = torch.tensor(seg_np, device="cuda")
    short = torch.full((1, 300), -1, dtype=torch.int32, device="cuda")
    short[0, :120], short[0, 120:270] = 0, 1
    _, seg64 = _packed_ids(packing, args.seed + 6, 2, 1000, lo=64, hi=600)
    train = dict(kvh=8, g=4, s_q=TRAIN_S, s_kv=TRAIN_S, d=128)
    cases = [
        ("train_layer", dict(train, b=TRAIN_B), "bfloat16"),
        ("train_layer_b2", dict(train, b=2), "float32"),
        ("packed_layer", dict(train, b=TRAIN_B, seg=packed), "bfloat16"),
        ("packed_layer_b2", dict(train, b=2, seg=packed[:2]), "float32"),
    ]
    for dt in ("bfloat16", "float32"):
        cases += [
            ("ragged_s300", dict(b=1, kvh=8, g=4, s_q=300, s_kv=300, d=128), dt),
            ("segments_s300", dict(b=1, kvh=8, g=4, s_q=300, s_kv=300, d=128, seg=short), dt),
            ("kvlen_qoffset", dict(b=2, kvh=8, g=1, s_q=256, s_kv=1024, d=128, kv_len=900,
                                   q_offset=600), dt),
            ("segments_d64_s1000", dict(b=2, kvh=4, g=2, s_q=1000, s_kv=1000, d=64,
                                        seg=torch.tensor(seg64, device="cuda")), dt),
        ]
    for name, c, dt in cases:
        bh, rows, d = c["b"] * c["kvh"], c["g"] * c["s_q"], c["d"]
        def rand(shape, dt=dt):
            return torch.randn(shape, generator=gen, device="cuda").to(DTYPES[dt])

        q, k, v = rand((bh, rows, d)), rand((bh, c["s_kv"], d)), rand((bh, c["s_kv"], d))
        # do at a quarter of the scale (exact in bf16) keeps every gradient
        # below 4, where one bf16 rounding costs at most 2^-7: with unit do,
        # dV of the first key columns (seen with P near 1 by the first row
        # of each of the G groups) reaches 10, whose rounding alone is 0.03.
        do = rand((bh, rows, d)) * 0.25
        kw = dict(causal=True, scale=d**-0.5, kv_len=c.get("kv_len"), q_offset=c.get("q_offset", 0),
                  q_seq_len=c["s_q"])
        segs = {}
        if "seg" in c:
            seg_q, seg_kv = _fold_ids(c["seg"], c["kvh"], c["g"])
            segs = dict(q_segment_ids=seg_q, kv_segment_ids=seg_kv)
        if (name, dt) in (("train_layer", "bfloat16"), ("packed_layer", "bfloat16")):
            # The forward at the training layers (packed: segment ids).
            rec, _ = _fwd_rec(f"{_kname('flash_fwd', q)}/{name}/{dt}", flash, q, k, v, kw, segs,
                              dt, shape={**{n: x for n, x in c.items() if n != "seg"},
                                         "segment_ids": "seg" in c})
            emit(rec)
            report["checks"].append(rec)
        ins, plain, wants, runs = _bwd_case(backward, flash, q, k, v, do, kw, segs)
        shape = {**{n: x for n, x in c.items() if n != "seg"}, "segment_ids": "seg" in c}
        absmax = [float(w.abs().max()) for w in wants["two_pass"]]
        fused = _kname("flash_bwd", q)
        recs = {kname: _bwd_rec(f"{kname}/{name}/{dt}", gots, wants_k, dt, grad_absmax=absmax,
                                shape=shape)
                for kname, (gots, wants_k) in _bwd_got(q, kw, runs, wants).items()}
        # Timed in bf16: at the training layer the fused kernel and, beside
        # it, the pair's tensor-core form (fused=False: the JAX package's
        # scripts/probe_fused_bwd.py A/B); at the packed layer the pair, both
        # forms.
        timed = {("train_layer", "bfloat16"): (fused, *(_kname(k, q) for k in PAIR)),
                 ("packed_layer", "bfloat16"): tuple(_kname(k, q) for k in PAIR),
                 }.get((name, dt), ())
        if (name, dt) == ("train_layer_b2", "float32"):
            # the float32 paths' form (float32 training runs the scalar kernel)
            yard = _bwd_yardsticks(benchit, ins, kw, c, plain)
            recs[fused].update(_time_bwd(backward, flash, benchit, card, fused, ins, kw, segs, c,
                                         yard, dt))
            report.setdefault("float32_timed", {})["flash_bwd"] = recs[fused]
        dq_tc = _kname("flash_bwd_dq", q)
        if dq_tc != "flash_bwd_dq" and "seg" in c and dt == "bfloat16":
            # The pair's dQ takes no atomics: two launches give the same bits.
            q_, k_, v_, o_, lse_, do_ = ins
            di_ = (o_.float() * do_.float()).sum(dim=-1)
            twice = [backward.dq_kernel(q_, k_, v_, do_, lse_, di_, **kw, **segs) for _ in range(2)]
            recs[dq_tc]["deterministic"] = bool(torch.equal(*twice))
            recs[dq_tc]["ok"] = recs[dq_tc]["ok"] and recs[dq_tc]["deterministic"]
        for kname in timed:
            if kname not in recs:
                continue
            if name not in yardsticks:
                yardsticks[name] = _bwd_yardsticks(benchit, ins, kw, c, plain)
            rec = recs[kname]
            rec.update(_time_bwd(backward, flash, benchit, card, kname, ins, kw, segs, c,
                                 yardsticks[name], dt))
            if name == "train_layer" and kname != fused:  # the pair beside the fused form
                report.setdefault("pair_vs_fused", {})[kname] = rec
                rec["fused_ms"] = recs[fused]["kernel_ms"]
                continue
            mains[kname] = rec
            if kname in TC_KERNELS.values() and kname != fused:  # the scalar pair beside it
                scalar = kname.removesuffix("_tc")
                with flash.scalar_forms():
                    recs[scalar].update(_time_bwd(backward, flash, benchit, card, scalar, ins, kw,
                                                  segs, c, yardsticks[name], dt))
                rec["scalar_ms"] = recs[scalar]["kernel_ms"]
                mains[scalar] = recs[scalar]
            if kname == "flash_bwd_tc":  # the scalar form beside it: the scalar row
                with flash.scalar_forms():
                    got = backward.flash_attention_bwd(*ins, fused=True, **kw)
                    twin = _bwd_rec(f"flash_bwd/{name}/{dt}", got,
                                    wants.get("two_pass_scalar", wants["two_pass"]), dt,
                                    grad_absmax=absmax, shape=shape,
                                    form="scalar (ops.flash.scalar_forms)")
                    twin.update(_time_bwd(backward, flash, benchit, card, "flash_bwd", ins, kw,
                                          segs, c, yardsticks[name], dt))
                rec["scalar_ms"] = twin["kernel_ms"]
                mains["flash_bwd"] = twin
                recs["flash_bwd"] = twin
        for rec in recs.values():
            emit(rec)
            report["checks"].append(rec)
        del q, k, v, do, ins, plain, runs
        torch.cuda.empty_cache()
    return mains


# The backward kernels at the windowed models' training layers, B = 1 and
# S = 8192, so that half of each segment's rows are windowed: Gemma-2-9B-class
# (8 KV heads x G = 2, d = 256, window 4096, softcap 50) and Mistral-7B-class
# (8 KV x G = 4, d = 128, window 4096).  At unit scale the scores are ~N(0, 1)
# and every pair carries ~1/4096 of its row: a window one column too wide, a
# dropped softcap derivative or a skipped query tile moves the gradients by
# less than bf16 rounding.  So each runs again with q scaled by 8 (and dO by
# 1/8, so that the gradients stay below 4): the scores reach ~30, single
# pairs carry much of a row's weight and the cap's derivative is far from 1
# (torch_tools/bwd_mutants.py shows these checks fail each such mutant).
# Then Gemma-2's layer with segment ids (documents of 5000, 2100 and 1000
# tokens and 92 of padding: the window bites in the first) for the two-pass
# pair, head_dim 16 with a window of 100 over a ragged S = 300, and head_dim
# 128 with a window of 300 and a softcap of 30 over a ragged S = 1000 (the
# fused backward's tensor-core form takes d <= 128 only).
_GEMMA_LAYER = dict(b=1, kvh=8, g=2, s_q=8192, s_kv=8192, d=256, window=4096, cap=50.0)
_MISTRAL_LAYER = dict(b=1, kvh=8, g=4, s_q=8192, s_kv=8192, d=128, window=4096, cap=None)
BWD_WINDOW_CASES = (
    ("gemma2_d256_w4096_cap50", dict(_GEMMA_LAYER, q_mult=1.0)),
    ("gemma2_d256_w4096_cap50_q8", dict(_GEMMA_LAYER, q_mult=8.0)),
    ("mistral_d128_w4096", dict(_MISTRAL_LAYER, q_mult=1.0)),
    ("mistral_d128_w4096_q8", dict(_MISTRAL_LAYER, q_mult=8.0)),
    ("gemma2_packed_w4096_cap50_q8", dict(_GEMMA_LAYER, q_mult=8.0, docs=(5000, 2100, 1000))),
    ("d16_s300_w100_cap30_q8", dict(b=1, kvh=8, g=4, s_q=300, s_kv=300, d=16, window=100,
                                    cap=30.0, q_mult=8.0)),
    # The tensor-core backward with a softcap (d <= 128), over a ragged S.
    ("d128_s1000_w300_cap30_q8", dict(b=1, kvh=8, g=2, s_q=1000, s_kv=1000, d=128, window=300,
                                      cap=30.0, q_mult=8.0)),
)
TIMED_BWD_WINDOW_CASES = ("gemma2_d256_w4096_cap50", "mistral_d128_w4096",
                          "gemma2_packed_w4096_cap50_q8")


def bwd_window_checks(backward, flash, benchit, gen, card, report, names=None, timed=True):
    """The three backward kernels at BWD_WINDOW_CASES (``names``: a subset),
    each gradient against the plain backward (float32 from the same inputs)
    within BWD_TOL and, in bfloat16, each element within BF16_ELEM_TOL.  o
    and lse come from the forward kernel.  Timed at the bfloat16 Gemma-2 and
    Mistral layers (unless not ``timed``): each kernel, the plain backward,
    and SDPA's backward under a boolean causal+window mask (no softcap).
    Returns
    ``{kernel: {case: timed record}}``."""
    timed_recs = {"flash_bwd": {}, "flash_bwd_dq": {}, "flash_bwd_dkv": {}}
    for name, c in BWD_WINDOW_CASES:
        if names is not None and name not in names:
            continue
        bh, rows, s, d = c["b"] * c["kvh"], c["g"] * c["s_q"], c["s_kv"], c["d"]
        kw = dict(causal=True, scale=d**-0.5, kv_len=None, q_offset=0, q_seq_len=c["s_q"],
                  window=c["window"], logit_softcap=c["cap"])
        segs = {}
        if "docs" in c:
            ids = torch.full((1, s), -1, dtype=torch.int32, device="cuda")
            ends = np.cumsum((0,) + c["docs"])
            for i, (a, e) in enumerate(zip(ends[:-1], ends[1:])):
                ids[0, a:e] = i
            c = dict(c, seg=ids)
            seg_q, seg_kv = _fold_ids(ids, c["kvh"], c["g"])
            segs = dict(q_segment_ids=seg_q, kv_segment_ids=seg_kv)
        for dt in ("bfloat16", "float32"):
            def rand(shape, mult=1.0):
                return (mult * torch.randn(shape, generator=gen, device="cuda")).to(DTYPES[dt])

            q, k, v = rand((bh, rows, d), c["q_mult"]), rand((bh, s, d)), rand((bh, s, d))
            do = rand((bh, rows, d), 0.25 / c["q_mult"])  # gradients below 4: see bwd_checks
            shape = {**{n: x for n, x in c.items() if n not in ("seg", "docs")},
                     "segment_ids": list(c["docs"]) if "docs" in c else None}
            if dt == "bfloat16" and name.startswith("d128_"):
                # The tensor-core forward with the softcap at d = 128.
                rec, _ = _fwd_rec(f"{_kname('flash_fwd', q)}/{name}/{dt}", flash, q, k, v, kw,
                                  segs, dt, shape=shape)
                emit(rec)
                report["checks"].append(rec)
            ins, plain, wants, runs = _bwd_case(backward, flash, q, k, v, do, kw, segs)
            recs = {kname: _bwd_rec(f"{kname}/{name}/{dt}", gots, wants_k, dt, shape=shape,
                                    grad_absmax=[float(w.abs().max()) for w in wants_k])
                    for kname, (gots, wants_k) in _bwd_got(q, kw, runs, wants).items()}
            if timed and dt == "bfloat16" and name in TIMED_BWD_WINDOW_CASES:
                yard = _bwd_yardsticks(benchit, ins, kw, c, plain)
                for kname, rec in recs.items():
                    # The scalar pair beside the tensor-core pair: under scalar_forms.
                    scalar = kname in PAIR and "two_pass_scalar" in runs
                    with flash.scalar_forms() if scalar else contextlib.nullcontext():
                        rec.update(_time_bwd(backward, flash, benchit, card, kname, ins, kw, segs,
                                             c, yard, dt))
                    if kname == "flash_bwd_tc":  # the scalar form's time beside it
                        with flash.scalar_forms():
                            rec["scalar_ms"] = _time_bwd(backward, flash, benchit, card,
                                                         "flash_bwd", ins, kw, segs, c, yard,
                                                         dt)["kernel_ms"]
                    timed_recs.setdefault(kname, {})[name] = rec
                for k in PAIR:
                    if TC_KERNELS[k] in recs and k in recs:
                        recs[TC_KERNELS[k]]["scalar_ms"] = recs[k]["kernel_ms"]
            for rec in recs.values():
                emit(rec)
                report["checks"].append(rec)
            del q, k, v, do, ins, plain, runs
            torch.cuda.empty_cache()
    return timed_recs


def _bwd_yardsticks(benchit, ins, kw, c, plain, dropout_p=0.0):
    """The plain backward's time and the library yardstick's: the backward
    of one scaled_dot_product_attention call, timed alone
    (torch.autograd.grad on a kept graph).  Causal with native GQA for a
    plain layer; with segment ids or a window, a boolean mask (causal, and
    same segment or inside the window) over K/V repeated to the q heads
    beforehand, untimed, since the masked kernels take no GQA.  SDPA has no
    softcap; with ``dropout_p`` it drops weights with its own random bits."""
    q, k, v, o, lse, do = ins
    out = {"plain_ms": benchit.cuda_time_ms(plain, warmup=1, iters=3)}
    b, kvh, g, s, d = c["b"], c["kvh"], c["g"], c["s_q"], c["d"]
    q4 = q.reshape(b, kvh * g, s, d).detach().requires_grad_()
    k4 = k.reshape(b, kvh, s, d).detach()
    v4 = v.reshape(b, kvh, s, d).detach()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    window = kw.get("window")
    if "seg" in c or window:
        pos = torch.arange(s, device="cuda")
        mask = pos[None] <= pos[:, None]
        if window:
            mask &= pos[None] > pos[:, None] - window
        if "seg" in c:
            seg = c["seg"]
            mask = ((seg[:, :, None] == seg[:, None, :]) & mask)[:, None]
        k4 = k4.repeat_interleave(g, dim=1).requires_grad_()
        v4 = v4.repeat_interleave(g, dim=1).requires_grad_()
        res = sdpa(q4, k4, v4, attn_mask=mask, scale=kw["scale"], dropout_p=dropout_p)
        parts = "+".join(["causal"] + ["window"] * bool(window) + ["segment"] * ("seg" in c))
        out["library"] = (f"scaled_dot_product_attention backward, boolean {parts} mask, K/V "
                          f"repeated to {kvh * g} heads untimed")
    else:
        k4, v4 = k4.requires_grad_(), v4.requires_grad_()
        res = sdpa(q4, k4, v4, is_causal=True, scale=kw["scale"], enable_gqa=True,
                   dropout_p=dropout_p)
        out["library"] = "scaled_dot_product_attention backward, is_causal, enable_gqa"
    if kw.get("logit_softcap"):
        out["library"] += "; no softcap (SDPA cannot express it)"
    if dropout_p:
        out["library"] += f"; dropout_p={dropout_p} (its own random bits)"
    do4 = do.reshape(res.shape)
    out["library_ms"] = benchit.cuda_time_ms(
        lambda: torch.autograd.grad(res, (q4, k4, v4), do4, retain_graph=True), warmup=1, iters=5
    )
    return out


def _time_bwd(backward, flash, benchit, card, kname, ins, kw, segs, c, yardsticks, dt):
    """One backward kernel's time beside its case's ``_bwd_yardsticks``,
    and its bound from this case's live pairs."""
    q, k, v, o, lse, do = ins
    di = (o.float() * do.float()).sum(dim=-1)
    kname = kname.removesuffix("_tc")  # the form that runs is the caller's choice
    if kname == "flash_bwd":
        kernel = lambda: backward.flash_attention_bwd(*ins, fused=True, **kw)  # noqa: E731
        reads, writes, per_pair = (q, k, v, o, do, lse), (q, k, v), 10
    elif kname == "flash_bwd_dq":
        kernel = lambda: backward.dq_kernel(q, k, v, do, lse, di, **kw, **segs)  # noqa: E731
        reads, writes, per_pair = (q, k, v, do, lse, di, *segs.values()), (q,), 6
    else:
        kernel = lambda: backward.dkv_kernel(q, k, v, do, lse, di, **kw, **segs)  # noqa: E731
        reads, writes, per_pair = (q, k, v, do, lse, di, *segs.values()), (k, v), 8
    out = {"kernel_ms": benchit.cuda_time_ms(kernel, warmup=1, iters=5), **yardsticks}
    pairs = _live_pairs(flash, q.shape[0], q.shape[1], k.shape[1], kw, segs)
    nbytes = sum(t.numel() * t.element_size() for t in reads + writes)
    out["live_pairs"] = pairs
    out.update(benchit.bound_ms(card, bytes_moved=nbytes, flops=per_pair * c["d"] * pairs, dtype=dt))
    return out


# Attention dropout in the four kernels: each against its plain version (the
# same keep bits, from the same hash) at rates 0.1 and 0.5, in bfloat16 and
# float32 (float32 at B = 2): flash_fwd and flash_bwd at the training layer
# (B = 8, 8 KV heads x G = 4, S = 2048, d = 128, causal), flash_bwd_dq and
# flash_bwd_dkv at the packed layer (the same with segment ids from packed
# documents); at rate 0.1, a ragged GQA S = 1000 through attention() (which
# draws the JAX package's bits at rows padded to 1024 per group), Gemma-2's
# windowed layer (d = 256, window 4096, softcap 50, S = 8192) and the 8-bit
# form (int8 K/V) at the prefill shape.  Timed at rate 0.1 in bfloat16
# against the plain version, the same kernel without dropout, and SDPA with
# dropout_p = 0.1 forward and backward (a time yardstick only: its random
# bits are its own).
DROPOUT_RATES = (0.1, 0.5)
DROPOUT_SEED = 1234567
DROPOUT_RAGGED_S = 1000


def _no_dropout(kw):
    return {k: v for k, v in kw.items() if not k.startswith("dropout")}


def _sdpa_fwd_ms(benchit, q4, k4, v4, **kw):
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return benchit.cuda_time_ms(lambda: sdpa(q4, k4, v4, **kw), warmup=1, iters=5)


def _fwd_rec(check, flash, q, k, v, kw, segs, dt, **extra):
    """The forward kernel against its plain version (o, and l, m relative):
    ``(record, plain)``."""
    o, l, m = flash.flash_attention(q, k, v, save_residuals=True, **kw, **segs)
    plain = lambda: flash.flash_attention_plain(q, k, v, save_residuals=True, **kw, **segs)  # noqa: E731
    wo, wl, wm = plain()
    torch.cuda.synchronize()
    e_l = err(l, wl) / float(wl.abs().max())
    e_m = err(m, wm) / float(wm.abs().max())
    rec = _rec(check, o, wo, dt, FLASH_TOL[dt], l_rel_err=e_l, m_rel_err=e_m,
               stats_rtol=STATS_RTOL, **extra)
    rec["ok"] = rec["ok"] and e_l <= STATS_RTOL and e_m <= STATS_RTOL
    return rec, plain


def _fwd_bound(benchit, card, q, k, v, d, pairs, dt, form=None):
    nbytes = 2 * q.numel() * q.element_size() + 2 * k.shape[0] * k.shape[1] * _row_bytes(k, d, form)
    return benchit.bound_ms(card, bytes_moved=nbytes, flops=4 * d * pairs, dtype=dt)


def dropout_checks(fa, backward, flash, benchit, packing, args, gen, card, report, timed=True):
    """The four kernels with dropout (see above), timed unless not ``timed``.
    Returns ``{kernel: timed record}`` and, under ``"flash_fwd_quant"``, the
    8-bit form's check."""
    mains = {}
    _, seg_np = _packed_ids(packing, args.seed + 5, TRAIN_B, TRAIN_S)
    packed = torch.tensor(seg_np, device="cuda")
    train = dict(kvh=8, g=4, s_q=TRAIN_S, s_kv=TRAIN_S, d=128)
    cases = [("train_layer", dict(train, b=TRAIN_B), "bfloat16", DROPOUT_RATES),
             ("train_layer_b2", dict(train, b=2), "float32", DROPOUT_RATES),
             ("packed_layer", dict(train, b=TRAIN_B, seg=packed), "bfloat16", DROPOUT_RATES),
             ("packed_layer_b2", dict(train, b=2, seg=packed[:2]), "float32", DROPOUT_RATES)]
    cases += [("gemma2_d256_w4096_cap50", dict(_GEMMA_LAYER), dt, (0.1,))
              for dt in ("bfloat16", "float32")]
    for name, c, dt, rates in cases:
        bh, rows, d = c["b"] * c["kvh"], c["g"] * c["s_q"], c["d"]
        for rate in rates:
            def rand(shape, mult=1.0):
                return (mult * torch.randn(shape, generator=gen, device="cuda")).to(DTYPES[dt])

            q, k, v = rand((bh, rows, d)), rand((bh, c["s_kv"], d)), rand((bh, c["s_kv"], d))
            do = rand((bh, rows, d), 0.25)  # gradients below 4: see bwd_checks
            kw = dict(causal=True, scale=d**-0.5, kv_len=None, q_offset=0, q_seq_len=c["s_q"],
                      window=c.get("window"), logit_softcap=c.get("cap"), dropout_rate=rate,
                      dropout_seed=DROPOUT_SEED)
            segs = {}
            if "seg" in c:
                seg_q, seg_kv = _fold_ids(c["seg"], c["kvh"], c["g"])
                segs = dict(q_segment_ids=seg_q, kv_segment_ids=seg_kv)
            shape = {**{n: x for n, x in c.items() if n != "seg"}, "segment_ids": "seg" in c,
                     "rate": rate}
            timing = (timed and dt == "bfloat16" and rate == 0.1
                      and name in ("train_layer", "packed_layer"))
            if "seg" not in c:
                rec, fwd_plain = _fwd_rec(f"{_kname('flash_fwd', q)}/dropout/{name}/{rate}/{dt}",
                                          flash, q, k, v, kw, segs, dt, shape=shape)
                if timing:
                    rec.update(_time_dropout_fwd(flash, benchit, card, q, k, v, kw, c, fwd_plain))
                    if rec["check"].startswith("flash_fwd_tc/"):
                        with flash.scalar_forms():
                            rec["scalar_ms"] = benchit.cuda_time_ms(
                                lambda: flash.flash_attention(q, k, v, **kw), warmup=1, iters=5)
                    mains["flash_fwd"] = rec
                emit(rec)
                report["checks"].append(rec)
            ins, plain, wants, runs = _bwd_case(backward, flash, q, k, v, do, kw, segs)
            fused = _kname("flash_bwd", q)
            yard = None
            recs = {}
            for kname, (gots, wants_k) in _bwd_got(q, kw, runs, wants).items():
                rec = _bwd_rec(f"{kname}/dropout/{name}/{rate}/{dt}", gots, wants_k, dt,
                               shape=shape, grad_absmax=[float(w.abs().max()) for w in wants_k])
                recs[kname] = rec
                if timing and (kname == fused) == (name == "train_layer"):
                    if yard is None:
                        yard = _bwd_yardsticks(benchit, ins, kw, c, plain, dropout_p=rate)
                    # The scalar pair beside the tensor-core pair: under scalar_forms.
                    scalar = kname in PAIR and "two_pass_scalar" in runs
                    with flash.scalar_forms() if scalar else contextlib.nullcontext():
                        rec.update(_time_bwd(backward, flash, benchit, card, kname, ins, kw, segs,
                                             c, yard, dt))
                        rec["no_dropout_ms"] = _time_bwd(backward, flash, benchit, card, kname,
                                                         ins, _no_dropout(kw), segs, c, yard,
                                                         dt)["kernel_ms"]
                    if kname == "flash_bwd_tc":
                        with flash.scalar_forms():
                            rec["scalar_ms"] = _time_bwd(backward, flash, benchit, card,
                                                         "flash_bwd", ins, kw, segs, c, yard,
                                                         dt)["kernel_ms"]
                    if scalar:
                        recs[TC_KERNELS[kname]]["scalar_ms"] = rec["kernel_ms"]
                    mains["flash_bwd" if kname == fused else kname] = rec
            for rec in recs.values():
                emit(rec)
                report["checks"].append(rec)
            del q, k, v, do, ins, plain, runs
            torch.cuda.empty_cache()
    for dt in ("bfloat16", "float32"):
        rec = _ragged_gqa_dropout(fa, backward, flash, gen, dt)
        emit(rec)
        report["checks"].append(rec)
    # The 8-bit form (int8 K/V with per-row scales) at the prefill shape.
    b, h, hkv, s, d = 4, 32, 32, 1024, 128
    for dt in ("bfloat16", "float32"):
        q = torch.randn((b * h, s, d), generator=gen, device="cuda").to(DTYPES[dt])
        (k, ks), (v, vs) = (_kv(gen, (b * hkv, s, d), DTYPES[dt], "int8") for _ in range(2))
        kw = dict(causal=True, scale=d**-0.5, dropout_rate=0.1, dropout_seed=DROPOUT_SEED)
        o = flash.flash_attention(q, k, v, k_scales=ks, v_scales=vs, **kw)
        plain = lambda: flash.flash_attention_plain(  # noqa: E731
            q, _plain_kv(k, ks), _plain_kv(v, vs), **kw)
        rec = _rec(f"flash_fwd/dropout/quant/prefill/int8/{dt}", o, plain(), dt, FLASH_TOL[dt],
                   shape=f"BH={b * h} S={s} d={d} causal, int8 K/V, rate 0.1")
        if timed and dt == "bfloat16":
            rec["kernel_ms"] = benchit.cuda_time_ms(
                lambda: flash.flash_attention(q, k, v, k_scales=ks, v_scales=vs, **kw), warmup=1,
                iters=5)
            rec["no_dropout_ms"] = benchit.cuda_time_ms(
                lambda: flash.flash_attention(q, k, v, k_scales=ks, v_scales=vs,
                                              **_no_dropout(kw)), warmup=1, iters=5)
            rec["plain_ms"] = benchit.cuda_time_ms(plain, warmup=1, iters=3)
            q4, kd, vd = (x.reshape(b, -1, s, d) for x in (q, _bf16(k, ks), _bf16(v, vs)))
            rec["library_ms"] = _sdpa_fwd_ms(benchit, q4, kd, vd, is_causal=True, scale=d**-0.5,
                                             dropout_p=0.1)
            rec["library"] = "scaled_dot_product_attention, is_causal, dropout_p=0.1" + _DEQUANT_NOTE
            rec.update(_fwd_bound(benchit, card, q, k, v, d, b * h * s * (s + 1) // 2, dt, "int8"))
            mains["flash_fwd_quant"] = rec
        emit(rec)
        report["checks"].append(rec)
    return mains


def _time_dropout_fwd(flash, benchit, card, q, k, v, kw, c, plain):
    """The forward kernel with dropout, without, its plain version and SDPA
    with dropout_p (causal, native GQA), and its bound over live pairs."""
    b, kvh, g, s, d = c["b"], c["kvh"], c["g"], c["s_q"], c["d"]
    out = {
        "kernel_ms": benchit.cuda_time_ms(lambda: flash.flash_attention(q, k, v, **kw),
                                          warmup=1, iters=5),
        "no_dropout_ms": benchit.cuda_time_ms(
            lambda: flash.flash_attention(q, k, v, **_no_dropout(kw)), warmup=1, iters=5),
        "plain_ms": benchit.cuda_time_ms(plain, warmup=1, iters=3),
    }
    q4, k4, v4 = q.reshape(b, kvh * g, s, d), k.reshape(b, kvh, s, d), v.reshape(b, kvh, s, d)
    out["library_ms"] = _sdpa_fwd_ms(benchit, q4, k4, v4, is_causal=True, scale=kw["scale"],
                                     dropout_p=kw["dropout_rate"], enable_gqa=True)
    out["library"] = (f"scaled_dot_product_attention, is_causal, enable_gqa, "
                      f"dropout_p={kw['dropout_rate']} (its own random bits)")
    pairs = _live_pairs(flash, q.shape[0], q.shape[1], k.shape[1], kw, {})
    out["live_pairs"] = pairs
    out.update(_fwd_bound(benchit, card, q, k, v, d, pairs, "bfloat16"))
    return out


def _ragged_gqa_dropout(fa, backward, flash, gen, dt):
    """attention() with dropout over a ragged GQA S (32 q / 8 KV heads, d =
    128): the forward and the gradients under autograd against the plain
    versions at the raw row stride round_up(S, 128)."""
    b, h, hkv, s, d = 1, 32, 8, DROPOUT_RAGGED_S, 128
    g, stride = h // hkv, -(-DROPOUT_RAGGED_S // 128) * 128
    q4 = torch.randn((b, h, s, d), generator=gen, device="cuda").to(DTYPES[dt]).requires_grad_()
    k4, v4 = (torch.randn((b, hkv, s, d), generator=gen, device="cuda").to(DTYPES[dt])
              .requires_grad_() for _ in range(2))
    do4 = (0.25 * torch.randn((b, h, s, d), generator=gen, device="cuda")).to(DTYPES[dt])
    kw = dict(causal=True, scale=d**-0.5, dropout_rate=0.1, dropout_seed=DROPOUT_SEED)
    o4 = fa.attention(q4, k4, v4, **kw)
    got = torch.autograd.grad(o4, (q4, k4, v4), do4)
    q3, k3, v3, do3 = (x.detach().reshape(b * hkv, -1, d).float() for x in (q4, k4, v4, do4))
    pkw = dict(kw, q_seq_len=s, dropout_row_stride=stride)
    # The plain versions in float32 with the rounding of the forms that ran.
    wo, wl, wm = flash.flash_attention_plain(q3, k3, v3, save_residuals=True,
                                             form=flash.kernel_form("flash_fwd", q4.dtype, d), **pkw)
    want = backward.flash_attention_bwd_plain(q3, k3, v3, wo, wm + torch.log(wl), do3,
                                              form=backward.bwd_form(q4, True), **pkw)
    torch.cuda.synchronize()
    # The plain gradients start from the plain forward's float32 o and lse,
    # the kernels' from their own (o rounded to dt): max-abs bounds only.
    e_o = err(o4.detach().reshape(wo.shape), wo)
    e_g = max(err(x.reshape(w.shape), w) for x, w in zip(got, want))
    return {"check": f"{_kname('flash_fwd', q4)}+bwd/dropout/ragged_gqa_s{s}/attention/{dt}",
            "o_max_abs_err": e_o, "o_tol": FLASH_TOL[dt], "max_abs_err": e_g, "tol": BWD_TOL[dt],
            "shape": f"B={b} H={h} KVH={hkv} S={s} d={d} causal, rate 0.1, row stride {stride}",
            "ok": e_o <= FLASH_TOL[dt] and e_g <= BWD_TOL[dt]}


# Block-sparse masks in flash_fwd, flash_bwd_dq and flash_bwd_dkv at
# Llama-7B's layer (B = 4, 32 heads, S = 4096, d = 128; bfloat16 and float32):
# a prefix-LM mask, 512-token documents and a strided mask, each also built
# at the padded length (4096) of a ragged S = 4000; each against its plain
# version.  Timed in bfloat16 at S = 4096 against the same kernels with no
# mask and SDPA with the boolean mask; under the documents mask (live
# fraction 1/8, no partial tile) each kernel must take at most a quarter of
# its no-mask time, which shows dead tiles are skipped, not masked.  Then a
# NaN-poison check: K/V rows that only dead tiles touch hold NaN, and every
# output must be finite and equal the clean run's.
BM_B, BM_H, BM_S, BM_D, BM_RAGGED_S = 4, 32, 4096, 128, 4000
BM_SKIP_RATIO = 0.25


def bm_prefix_lm(r, c):
    return (c < 1024) | (c <= r)


def bm_documents(r, c):
    return r // 512 == c // 512


def bm_strided(r, c):
    return (abs(r - c) < 128) | (c % 256 == 0)


def bm_poison(r, c):
    # Columns 3072+ are seen by no row: only dead tiles touch them.
    return (c < 3072) & ((r // 512 == c // 512) | (c < 512))


BM_MASKS = {"prefix_lm": bm_prefix_lm, "documents": bm_documents, "strided": bm_strided}


def block_mask_checks(backward, flash, benchit, gen, card, report, timed=True):
    """The three kernels with block masks (see above), timed unless not
    ``timed``.  Returns ``{kernel: {mask: timed record}}``."""
    timed_recs = {"flash_fwd": {}, "flash_bwd_dq": {}, "flash_bwd_dkv": {}}
    masks = {n: flash.BlockMask.from_mask_fn(fn, BM_S, BM_S) for n, fn in BM_MASKS.items()}
    for dt in ("bfloat16", "float32"):
        def rand(shape, mult=1.0):
            return (mult * torch.randn(shape, generator=gen, device="cuda")).to(DTYPES[dt])

        for s in (BM_S, BM_RAGGED_S):
            bh = BM_B * BM_H
            q, k, v = (rand((bh, s, BM_D)) for _ in range(3))
            do = rand((bh, s, BM_D), 0.25)
            base = dict(causal=False, scale=BM_D**-0.5, kv_len=None, q_offset=0, q_seq_len=None)
            no_mask = None
            for mname, bm in masks.items():
                kw = dict(base, block_mask=bm)
                shape = f"B={BM_B} H={BM_H} S={s} d={BM_D}, {mname} mask built at {BM_S}"
                fwd, fwd_plain = _fwd_rec(f"flash_fwd/block_mask/{mname}/s{s}/{dt}", flash, q, k, v,
                                          kw, {}, dt, shape=shape)
                ins, plain, wants, runs = _bwd_case(backward, flash, q, k, v, do, kw, {})
                want = wants["two_pass"]
                recs = {"flash_fwd": fwd}
                for kname, gots, wants in (("flash_bwd_dq", runs["two_pass"][:1], want[:1]),
                                           ("flash_bwd_dkv", runs["two_pass"][1:], want[1:])):
                    recs[kname] = _bwd_rec(f"{kname}/block_mask/{mname}/s{s}/{dt}", gots, wants,
                                           dt, shape=shape,
                                           grad_absmax=[float(w.abs().max()) for w in wants])
                if timed and dt == "bfloat16" and s == BM_S:
                    if no_mask is None:
                        no_mask = _bm_no_mask_times(backward, flash, benchit, ins, base)
                    _time_block_mask(backward, flash, benchit, card, recs, ins, kw, fwd_plain,
                                     plain, no_mask)
                    for kname, rec in recs.items():
                        timed_recs[kname][mname] = rec
                for rec in recs.values():
                    emit(rec)
                    report["checks"].append(rec)
                del ins, plain, want, runs
                torch.cuda.empty_cache()
            del q, k, v, do
            torch.cuda.empty_cache()
    checks = [_bm_skip_check(timed_recs, masks)] if timed else []
    checks.append(_bm_poison_check(backward, flash, gen))
    for rec in checks:
        emit(rec)
        report["checks"].append(rec)
    return timed_recs


def _bm_skip_check(timed_recs, masks):
    """Under the documents mask each kernel takes at most BM_SKIP_RATIO of
    its no-mask time."""
    docs = {k: timed_recs[k]["documents"] for k in timed_recs}
    fwd_ratio = docs["flash_fwd"]["kernel_ms"] / docs["flash_fwd"]["no_mask_ms"]
    bwd_ratio = ((docs["flash_bwd_dq"]["kernel_ms"] + docs["flash_bwd_dkv"]["kernel_ms"])
                 / (docs["flash_bwd_dq"]["no_mask_ms"] + docs["flash_bwd_dkv"]["no_mask_ms"]))
    rec = {"check": "block_mask/documents/dead_tiles_skipped", "flash_fwd_ratio": fwd_ratio,
           "dq_plus_dkv_ratio": bwd_ratio, "max_ratio": BM_SKIP_RATIO,
           "live_fraction": masks["documents"].element_live_fraction,
           "ok": fwd_ratio <= BM_SKIP_RATIO and bwd_ratio <= BM_SKIP_RATIO}
    return rec


def _bm_no_mask_times(backward, flash, benchit, ins, base):
    """The three kernels with no mask on the same inputs, and SDPA's
    forward and backward with a boolean mask (filled in per mask).  All
    three in their scalar forms, the ones a block mask runs, so that the
    ratio measures the skipped tiles."""
    q, k, v, o, lse, do = ins
    di = (o.float() * do.float()).sum(dim=-1)
    with flash.scalar_forms():
        return {
            "flash_fwd": benchit.cuda_time_ms(lambda: flash.flash_attention(q, k, v, **base),
                                              warmup=1, iters=3),
            "flash_bwd_dq": benchit.cuda_time_ms(
                lambda: backward.dq_kernel(q, k, v, do, lse, di, **base), warmup=1, iters=3),
            "flash_bwd_dkv": benchit.cuda_time_ms(
                lambda: backward.dkv_kernel(q, k, v, do, lse, di, **base), warmup=1, iters=3),
        }


def _time_block_mask(backward, flash, benchit, card, recs, ins, kw, fwd_plain, bwd_plain, no_mask):
    """Each kernel's time with the mask, beside its no-mask time, the plain
    versions' and SDPA's with the boolean mask, and its bound over the
    mask's live pairs."""
    q, k, v, o, lse, do = ins
    di = (o.float() * do.float()).sum(dim=-1)
    bm = kw["block_mask"]
    dense = bm.element_mask(BM_S, BM_S, "cuda")
    pairs = int(dense.sum()) * q.shape[0]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q4, k4, v4, do4 = (x.reshape(BM_B, BM_H, BM_S, BM_D).detach() for x in (q, k, v, do))
    fwd_lib = benchit.cuda_time_ms(lambda: sdpa(q4, k4, v4, attn_mask=dense, scale=kw["scale"]),
                                   warmup=1, iters=3)
    q4g, k4g, v4g = (x.clone().requires_grad_() for x in (q4, k4, v4))
    res = sdpa(q4g, k4g, v4g, attn_mask=dense, scale=kw["scale"])
    bwd_lib = benchit.cuda_time_ms(
        lambda: torch.autograd.grad(res, (q4g, k4g, v4g), do4, retain_graph=True), warmup=1, iters=3)
    bwd_plain_ms = benchit.cuda_time_ms(bwd_plain, warmup=1, iters=2)
    calls = {
        "flash_fwd": (lambda: flash.flash_attention(q, k, v, **kw), (q, k, v), (q,), 4, fwd_lib,
                      benchit.cuda_time_ms(fwd_plain, warmup=1, iters=2)),
        "flash_bwd_dq": (lambda: backward.dq_kernel(q, k, v, do, lse, di, **kw),
                         (q, k, v, do, lse, di), (q,), 6, bwd_lib, bwd_plain_ms),
        "flash_bwd_dkv": (lambda: backward.dkv_kernel(q, k, v, do, lse, di, **kw),
                          (q, k, v, do, lse, di), (k, v), 8, bwd_lib, bwd_plain_ms),
    }
    for kname, (fn, reads, writes, per_pair, lib, plain_ms) in calls.items():
        nbytes = sum(t.numel() * t.element_size() for t in reads + writes)
        recs[kname].update(
            kernel_ms=benchit.cuda_time_ms(fn, warmup=1, iters=3), no_mask_ms=no_mask[kname],
            plain_ms=plain_ms, library_ms=lib, live_pairs=pairs,
            live_fraction=bm.element_live_fraction,
            library=("scaled_dot_product_attention" + (" backward" if kname != "flash_fwd" else "")
                     + ", boolean (S, S) mask"),
            **benchit.bound_ms(card, bytes_moved=nbytes, flops=per_pair * BM_D * pairs,
                               dtype="bfloat16"))


def _bm_poison_check(backward, flash, gen):
    """NaN in the K/V rows only dead tiles touch (bm_poison: columns 3072+):
    every output finite and equal to the clean run's (bf16, B = 1)."""
    bm = flash.BlockMask.from_mask_fn(bm_poison, BM_S, BM_S)
    shape = (BM_H, BM_S, BM_D)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16) for _ in range(3))
    do = (0.25 * torch.randn(shape, generator=gen, device="cuda")).to(torch.bfloat16)
    outs = []
    for poison in (False, True):
        kk, vv = k.clone(), v.clone()
        if poison:
            kk[:, 3072:], vv[:, 3072:] = float("nan"), float("nan")
        o, l, m = flash.flash_attention(q, kk, vv, save_residuals=True, block_mask=bm)
        lse = m + torch.log(l)
        outs.append((o, *backward.flash_attention_bwd(q, kk, vv, o, lse, do, block_mask=bm)))
    torch.cuda.synchronize()
    finite = all(bool(torch.isfinite(x).all()) for x in outs[1])
    equal = all(torch.equal(a, b) for a, b in zip(*outs))
    return {"check": "block_mask/nan_poison_dead_tiles/bfloat16", "outputs": ["o", "dq", "dk", "dv"],
            "poisoned_kv_rows": f"3072-{BM_S - 1}", "finite": finite, "equal_to_clean": equal,
            "ok": finite and equal}


def phase_attention_block_mask(fa, counters, gen, report):
    """The block-mask path a user calls: attention() under autograd with
    the documents mask and dropout at Llama-7B's layer (bf16), forward and
    backward, with the launch counters zeroed just before."""
    bm = fa.BlockMask.from_mask_fn(bm_documents, BM_S, BM_S)
    q, k, v = (torch.randn((BM_B, BM_H, BM_S, BM_D), generator=gen, device="cuda")
               .to(torch.bfloat16).requires_grad_() for _ in range(3))
    do = torch.randn((BM_B, BM_H, BM_S, BM_D), generator=gen, device="cuda").to(torch.bfloat16)
    grads = []

    def drive():
        o = fa.attention(q, k, v, scale=BM_D**-0.5, block_mask=bm, dropout_rate=0.1,
                         dropout_seed=DROPOUT_SEED)
        grads.extend(torch.autograd.grad(o, (q, k, v), do))

    wall, launches = _drive(counters, drive)
    want = dict.fromkeys(counters, 0)
    want.update({f"{k}{f}": 1 for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
                 for f in ("", "_dropout", "_block_mask")})
    finite = all(bool(torch.isfinite(g_).all()) for g_ in grads)
    rec = {"phase": "attention_block_mask", "shape": f"B={BM_B} H={BM_H} S={BM_S} d={BM_D}",
           "mask": "documents (512)", "dropout_rate": 0.1, "wall_ms": 1e3 * wall,
           "launches": launches, "launches_expected": want, "finite": finite,
           "ok": finite and launches == want}
    emit(rec)
    report["attention_block_mask"] = rec
    return rec


def _train_cfg(transformer, dtype="bfloat16"):
    """bench_train.py's configuration: Mistral-7B width in 2 layers, no window."""
    return dataclasses.replace(
        transformer.ModelConfig.mistral7b(num_layers=2), sliding_window=None, dtype=dtype
    )


TRAIN_MODEL = "mistral7b(num_layers=2), sliding_window=None"
# The windowed models' training phases: one row of 8192 tokens, so that the
# window of 4096 bites on half of its positions; their published configs.
WTRAIN_B, WTRAIN_S = 1, 8192
WTRAIN_MODELS = {
    "train_mistral": "mistral7b(num_layers=2): 32 q / 8 KV heads, d=128, window 4096",
    "train_gemma2": "gemma2_9b(num_layers=2): " + GEMMA_MODEL.split(": ")[1],
}
# The packed Gemma-2 row: documents of 5000, 2100 and 1000 tokens, 92 of
# padding (the window bites in the first).
WTRAIN_DOCS = (5000, 2100, 1000)


def _matmul_params(cfg):
    """bench_train.py's count: matmul parameters, lm_head in, embedding out."""
    per_layer = (
        cfg.d_model * cfg.num_q_heads * cfg.head_dim
        + 2 * cfg.d_model * cfg.num_kv_heads * cfg.head_dim
        + cfg.num_q_heads * cfg.head_dim * cfg.d_model
        + 3 * cfg.d_model * cfg.intermediate
    )
    return cfg.num_layers * per_layer + cfg.d_model * cfg.vocab_size


def _train_rec(phase, cfg, benchit, card, wall, steps, losses, launches, want, attn_fwd, extra,
               model=TRAIN_MODEL, batch=TRAIN_B, seq=TRAIN_S):
    """bench_train.py's accounting: 6 N_matmul tokens + 3.5 x attention forward."""
    _tc_expect(want, cfg)
    tokens = batch * seq
    flops = 6 * _matmul_params(cfg) * tokens + 3.5 * attn_fwd
    tflops = flops * steps / wall / 1e12
    finite = all(np.isfinite(x) for x in losses)
    return {
        "phase": phase, "model": model, "dtype": cfg.dtype,
        "batch": batch, "seq": seq, "steps": steps, **extra, "losses": losses,
        "step_ms": 1e3 * wall / steps, "tokens_per_s": tokens * steps / wall,
        "model_tflop_per_step": flops / 1e12, "model_tflops": tflops,
        "mfu": tflops / benchit.card_peaks(card)["bfloat16"],
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
        "launches": launches, "launches_expected": want,
        "ok": finite and launches == want,
    }


def _attn_fwd_flops(benchit, cfg, batch, seq):
    """Attention forward flops of a step's layers: 4 d per live pair and q
    head; with a window, the pairs it leaves live (``_window_pairs``)."""
    if cfg.sliding_window is None:
        return cfg.num_layers * benchit.attention_flops(batch * cfg.num_q_heads, seq, seq,
                                                        cfg.head_dim, causal=True)
    return (cfg.num_layers * 4 * cfg.head_dim * batch * cfg.num_q_heads
            * _window_pairs(seq, cfg.sliding_window))


def _seeded(attn_dropout, seed):
    """A step's trailing arguments: with dropout, its seed (the step index)."""
    return (seed,) if attn_dropout else ()


def phase_train(args, cfg, params, train, benchit, counters, card, report, *, remat,
                phase=None, model=TRAIN_MODEL, batch=TRAIN_B, seq=TRAIN_S, profile=None,
                attn_dropout=None):
    """The plain step: one warm-up step, then TRAIN_STEPS counted steps; a
    profile of one more step (by default, without remat).  With
    ``attn_dropout``, seed = step index (the warm-up's 0)."""
    rng = np.random.default_rng(args.seed + 20)
    tokens = torch.tensor(rng.integers(0, cfg.vocab_size, (batch, seq)), dtype=torch.int32,
                          device="cuda")
    step = train.make_train_step(cfg, lr=1e-3, remat=remat, attn_dropout=attn_dropout)
    step(params, tokens, *_seeded(attn_dropout, 0))  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = []
    wall, launches = _drive(counters, lambda: out.extend(
        step(params, tokens, *_seeded(attn_dropout, i + 1))[0] for i in range(TRAIN_STEPS)))
    layers = cfg.num_layers
    want = dict.fromkeys(counters, 0)
    want.update(flash_fwd=(2 if remat else 1) * layers * TRAIN_STEPS, flash_bwd=layers * TRAIN_STEPS)
    if attn_dropout:
        want.update(flash_fwd_dropout=want["flash_fwd"], flash_bwd_dropout=want["flash_bwd"])
    phase = phase or ("train_remat" if remat else "train")
    rec = _train_rec(phase, cfg, benchit, card, wall, TRAIN_STEPS, [float(x) for x in out],
                     launches, want, _attn_fwd_flops(benchit, cfg, batch, seq),
                     {"remat": remat, "attn_dropout": attn_dropout}, model, batch, seq)
    emit(rec)
    report[phase] = rec
    if profile is None:
        profile = not remat
    if profile:

        def one_step(run):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(params, tokens)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e6

        report[f"profile_{phase}"] = _profile(one_step, f"profile/{phase}",
                                              {"steps": 1, "remat": remat})
    return rec


def phase_train_packed(args, cfg, params, train, packing, flash, benchit, counters, card, report,
                       *, phase="train_packed", model=TRAIN_MODEL, batch=TRAIN_B, seq=TRAIN_S,
                       docs=None, attn_dropout=None):
    """The packed step over ``batch`` rows packed from random documents of
    64-2048 tokens, or with ``docs`` one row of documents of those lengths;
    ``attn_dropout`` as in phase_train."""
    if docs is None:
        tok_np, seg_np = _packed_ids(packing, args.seed + 21, batch, seq, cfg.vocab_size)
    else:
        rng = np.random.default_rng(args.seed + 21)
        tok_np, seg_np = packing.pack_documents(
            [rng.integers(0, cfg.vocab_size, size=n) for n in docs], seq)
    tokens = torch.tensor(tok_np, device="cuda")
    segs = torch.tensor(seg_np, device="cuda")
    step = train.make_train_step_packed(cfg, lr=1e-3, attn_dropout=attn_dropout)
    step(params, tokens, segs, *_seeded(attn_dropout, 0))  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = []
    wall, launches = _drive(counters, lambda: out.extend(
        step(params, tokens, segs, *_seeded(attn_dropout, i + 1))[0] for i in range(TRAIN_STEPS)))
    layers = cfg.num_layers
    want = dict.fromkeys(counters, 0)
    want.update(flash_fwd=layers * TRAIN_STEPS, flash_bwd_dq=layers * TRAIN_STEPS,
                flash_bwd_dkv=layers * TRAIN_STEPS)
    if attn_dropout:
        want.update({f"{k}_dropout": layers * TRAIN_STEPS
                     for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")})
    # Attention forward flops of this run's data: 4 d per live pair and head.
    pairs = _live_pairs(flash, batch, seq, seq,
                        dict(causal=True, kv_len=None, q_offset=0, q_seq_len=seq,
                             window=cfg.sliding_window),
                        dict(q_segment_ids=segs, kv_segment_ids=segs))
    attn_fwd = layers * 4 * cfg.head_dim * cfg.num_q_heads * pairs
    valid = int(((segs[:, 1:] == segs[:, :-1]) & (segs[:, 1:] >= 0)).sum())
    rec = _train_rec(phase, cfg, benchit, card, wall, TRAIN_STEPS, [float(x) for x in out],
                     launches, want, attn_fwd, {
                         "attn_dropout": attn_dropout,
                         "documents_per_row": [len(set(r.tolist()) - {-1}) for r in seg_np],
                         "pad_tokens": int((seg_np < 0).sum()), "valid_targets": valid,
                         "live_pairs_per_head": pairs,
                     }, model, batch, seq)
    emit(rec)
    report[phase] = rec
    return rec


def phase_train_windowed(args, transformer, train, packing, flash, benchit, counters, card,
                         report):
    """The windowed models' steps at full width, 2 layers, bf16, B = 1,
    S = 8192 (WTRAIN_B, WTRAIN_S): train_mistral (Mistral-7B-class with its
    published window 4096), train_gemma2 (Gemma-2-9B-class: window 4096,
    softcap 50, head_dim 256; with a profile of one step) and
    train_gemma2_packed (the packed step on WTRAIN_DOCS: the two-pass
    backward with segment ids and the window).  Each: one warm-up step, then
    TRAIN_STEPS counted."""
    out = {}
    for phase, make_cfg in (("train_mistral", transformer.ModelConfig.mistral7b),
                            ("train_gemma2", transformer.ModelConfig.gemma2_9b)):
        cfg = make_cfg(num_layers=2)
        params = transformer.init_params(args.seed, cfg)
        model = WTRAIN_MODELS[phase]
        out[phase] = phase_train(args, cfg, params, train, benchit, counters, card, report,
                                 remat=False, phase=phase, model=model, batch=WTRAIN_B,
                                 seq=WTRAIN_S, profile=phase == "train_gemma2")
        if phase == "train_gemma2":
            out["train_gemma2_packed"] = phase_train_packed(
                args, cfg, params, train, packing, flash, benchit, counters, card, report,
                phase="train_gemma2_packed", model=model, batch=WTRAIN_B, seq=WTRAIN_S,
                docs=WTRAIN_DOCS)
        del params
        torch.cuda.empty_cache()
    return out


def phase_train_parity(args, transformer, train, packing, counters, report, *,
                       phase="train_parity", cfg=None, docs=(70, 100, 50), attn_dropout=None):
    """Plain and packed steps, remat off and on, two steps each, on the card
    and on the CPU from the same float32 parameters (2-layer cut at the
    training width, B=1, S=256; ``cfg`` another 2-layer float32 cut, its
    parameters drawn on the card and copied, packed from ``docs``); the
    CPU's run without remat is the reference of both card runs.  With
    ``attn_dropout``, seed = step index: the card's keep bits must be the
    plain version's.  The card's launches over the phase are its record's
    (float32 training: the scalar kernels' path; the CPU runs launch
    nothing)."""
    if cfg is None:
        cfg = _train_cfg(transformer, "float32")
        base = transformer.init_params(args.seed, cfg, device="cpu")
    else:
        base = _to_card(transformer.init_params(args.seed, cfg), "cpu")
        torch.cuda.empty_cache()
    rng = np.random.default_rng(args.seed + 30)
    tokens = rng.integers(0, cfg.vocab_size, (1, 256)).astype(np.int32)
    docs = [rng.integers(0, cfg.vocab_size, int(n)) for n in docs]
    p_tokens, p_segs = packing.pack_documents(docs, 256)

    def copy_to(dev):
        return {k: (v.to(dev, copy=True) if torch.is_tensor(v)
                    else [{n: w.to(dev, copy=True) for n, w in lay.items()} for lay in v])
                for k, v in base.items()}

    def data(packed, dev):
        if packed:
            return torch.tensor(p_tokens, device=dev), torch.tensor(p_segs, device=dev)
        return (torch.tensor(tokens, device=dev),)

    cases = []
    t0 = time.perf_counter()
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    for packed in (False, True):
        grads = {}
        for dev in ("cpu", "cuda"):
            _, g = train.forward.make_grad_fn(cfg, packed=packed, attn_dropout=attn_dropout)(
                copy_to(dev), *data(packed, dev), 0)
            grads[dev] = [x.cpu() for x in g]
        grad_rel = max(err(a, b) / max(float(b.abs().max()), 1e-30)
                       for a, b in zip(grads["cuda"], grads["cpu"]))
        del grads
        def run(dev, remat):
            params = copy_to(dev)
            make = train.make_train_step_packed if packed else train.make_train_step
            step = make(cfg, lr=1e-3, remat=remat, attn_dropout=attn_dropout, device=dev)
            losses = [float(step(params, *data(packed, dev), seed)[0]) for seed in range(2)]
            return losses, [p.cpu() for p in train.common.leaves(params)]

        # One CPU run serves both card runs: on the CPU remat is bitwise the
        # step without it (tests/test_torch_train.py pins that).
        l_cpu, p_cpu = run("cpu", False)
        for remat in (False, True):
            l_gpu, p_gpu = run("cuda", remat)
            loss_rel = max(abs(a - b) / abs(b) for a, b in zip(l_gpu, l_cpu))
            param_err = max(err(a, b) for a, b in zip(p_gpu, p_cpu))
            cases.append({
                "packed": packed, "remat": remat, "losses_cpu": l_cpu, "losses_card": l_gpu,
                "loss_rel_err": loss_rel, "param_max_abs_err": param_err,
                "grad_rel_err": grad_rel,
                "ok": loss_rel <= TRAIN_LOSS_RTOL and param_err <= TRAIN_PARAM_TOL
                and grad_rel <= TRAIN_GRAD_RTOL,
            })
            del p_gpu
        del p_cpu
    rec = {"phase": phase, "layers": 2, "dtype": "float32", "batch": 1, "seq": 256,
           "attn_dropout": attn_dropout, "window": cfg.sliding_window, "logit_softcap": cfg.logit_softcap,
           "head_dim": cfg.head_dim, "d_model": cfg.d_model, "vocab": cfg.vocab_size,
           "lr": 1e-3, "steps": 2, "packed_docs": [len(d) for d in docs], "cases": cases,
           "tol": {"loss_rel": TRAIN_LOSS_RTOL, "param_abs": TRAIN_PARAM_TOL,
                   "grad_rel": TRAIN_GRAD_RTOL},
           "seconds": time.perf_counter() - t0,
           "launches": {k: getattr(fn, attr) for k, (fn, attr) in counters.items()},
           "ok": all(c["ok"] for c in cases)}
    emit(rec)
    report[phase] = rec
    del base
    return rec


# The windowed models' parity cuts (full width, 2 float32 layers), their
# window cut from 4096 to 128 so that it bites within S = 256, and packed
# from documents of 150, 70 and 30 tokens (the window bites in the first).
PARITY_WINDOW = 128
PARITY_DOCS = (150, 70, 30)


def _launch_sum(rec):
    """The launches of every run a phase's record holds, summed by kernel."""
    total: dict[str, int] = {}

    def walk(x):
        if isinstance(x, dict):
            if "launches" in x and isinstance(x["launches"], dict):
                for k, n in x["launches"].items():
                    total[k] = total.get(k, 0) + n
            for v in x.values():
                if isinstance(v, dict) and v is not x.get("launches"):
                    walk(v)

    walk(rec)
    return total


def _extra_entry(rec, paths, counter, keys, less=None):
    """A kernel summary's entry for one of its forms: the form's timed check
    and its launches, by path, from the counter ``counter`` (less those of
    the counter ``less``, a form counted within it)."""
    by_path = {p: n.get(counter, 0) - n.get(less, 0) for p, n in paths.items()}
    by_path = {p: x for p, x in by_path.items() if x}
    return {**{k: rec[k] for k in keys}, "ms": rec["kernel_ms"],
            "launches": sum(by_path.values()), "launches_by_path": by_path}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=32, help="serve depth (published: 32)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from flashattention_tpu_torch.models import train, transformer
    from flashattention_tpu_torch.ops import backward, decode, flash, kernels, quant
    from flashattention_tpu_torch.runtime import engine as engine_mod
    from flashattention_tpu_torch.runtime import kvcache
    from flashattention_tpu_torch.utils import benchit, packing
    import flashattention_tpu_torch as fa

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in float32
    torch.backends.cudnn.allow_tf32 = False
    card = benchit.card_info()
    name = torch.cuda.get_device_name(0)
    report = {"card": card, "device": name, "build": {}, "checks": []}
    counters = _counters(flash, decode, backward)

    laps, t_lap = {}, [t_start]

    def lap(name):  # seconds since the previous lap, by phase group
        now = time.perf_counter()
        laps[name], t_lap[0] = now - t_lap[0], now

    phase_build(kernels, report)
    lap("build")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    # {None, "int8", "fp8"}: {kernel: (main shape's timed check, Gemma-2 window's)}
    serving = {form: serving_checks(fa, flash, decode, benchit, gen, name, report, form)
               for form in (None, *QUANT_FORMS)}
    poison = prefill_poison_check(decode, gen, report)
    head_dim_pad_check(fa, flash, backward, gen, report)
    lap("serving_checks")
    # {None, "int8", "fp8"}: {"llama": timed draft-form check, "gemma2": ...}
    drafts = {form: draft_checks(decode, benchit, gen, name, report, form)
              for form in (None, *QUANT_FORMS)}
    lap("draft_checks")
    mains = {
        **{k: main for k, (main, _) in serving[None].items()},
        "flash_naive": naive_checks(flash, benchit, gen, name, report),
        **bwd_checks(backward, flash, benchit, packing, args, gen, name, report),
    }
    lap("naive_bwd_checks")
    # {backward kernel: {windowed case: its timed check}}
    bwd_windowed = bwd_window_checks(backward, flash, benchit, gen, name, report)
    lap("bwd_window_checks")
    # {kernel: timed dropout check}, and the 8-bit form's under "flash_fwd_quant"
    dropout = dropout_checks(fa, backward, flash, benchit, packing, args, gen, name, report)
    # {kernel: {mask: timed block-mask check}}
    masked = block_mask_checks(backward, flash, benchit, gen, name, report)
    lap("dropout_block_mask_checks")
    attn_bm = phase_attention_block_mask(fa, counters, gen, report)
    lap("attention_block_mask")
    cfg = dataclasses.replace(
        transformer.ModelConfig.llama7b_attention(), num_layers=args.layers
    )
    t0 = time.perf_counter()
    params = transformer.init_params(args.seed, cfg)
    torch.cuda.synchronize()
    report["init_s"] = time.perf_counter() - t0
    serve = phase_serve(args, cfg, params, engine_mod, kvcache, counters, report)
    chunked = phase_serve_chunked(args, cfg, params, engine_mod, kvcache, counters, report)
    multistep = phase_serve_multistep(args, cfg, params, engine_mod, kvcache, counters, report)
    speculative = phase_serve_speculative(args, transformer, engine_mod, kvcache, counters, report)
    serve_int8 = phase_serve_int8(args, cfg, params, transformer, quant, engine_mod, kvcache,
                                  benchit, counters, report)  # quantizes params in place
    del params
    torch.cuda.empty_cache()
    lap("serve_llama")
    gcfg = transformer.ModelConfig.gemma2_9b(num_layers=42)
    t0 = time.perf_counter()
    gparams = transformer.init_params(args.seed, gcfg)
    torch.cuda.synchronize()
    report["gemma2_init_s"] = time.perf_counter() - t0
    report["gemma2_weights_gb"] = sum(
        t.numel() * t.element_size() for t in train.common.leaves(gparams)) / 1e9
    gemma = phase_serve_gemma2(args, gcfg, gparams, engine_mod, kvcache, counters, report)
    gemma_whole = phase_serve_gemma2_whole(args, gcfg, gparams, engine_mod, kvcache, counters,
                                           report)
    gemma_fp8 = phase_serve_gemma2(args, gcfg, gparams, engine_mod, kvcache, counters, report,
                                   cache_dtype="fp8", phase="serve_gemma2_fp8")
    del gparams
    torch.cuda.empty_cache()
    gemma_spec = phase_serve_speculative_gemma2(args, transformer, engine_mod, kvcache, counters,
                                                report)
    lap("serve_gemma2")
    cross = phase_crosscheck(fa, flash, gen, report)
    quant_ops = phase_quant_ops(fa, flash, quant, gen, report)
    phase_parity(args, transformer, kvcache, engine_mod, report)
    phase_parity_quant(args, transformer, quant, kvcache, engine_mod, report)
    phase_parity_gemma2(args, transformer, kvcache, engine_mod, report)
    phase_parity_speculative(args, transformer, kvcache, report)

    lap("crosscheck_parity")
    tcfg = _train_cfg(transformer)
    tparams = transformer.init_params(args.seed, tcfg)
    trained = {
        "train": phase_train(args, tcfg, tparams, train, benchit, counters, name, report, remat=False),
        "train_remat": phase_train(args, tcfg, tparams, train, benchit, counters, name, report,
                                   remat=True),
        "train_packed": phase_train_packed(args, tcfg, tparams, train, packing, flash, benchit,
                                           counters, name, report),
        "train_dropout": phase_train(args, tcfg, tparams, train, benchit, counters, name, report,
                                     remat=False, phase="train_dropout", profile=False,
                                     attn_dropout=0.1),
        "train_packed_dropout": phase_train_packed(
            args, tcfg, tparams, train, packing, flash, benchit, counters, name, report,
            phase="train_packed_dropout", attn_dropout=0.1),
    }
    del tparams
    torch.cuda.empty_cache()
    trained.update(phase_train_windowed(args, transformer, train, packing, flash, benchit,
                                        counters, name, report))
    lap("train")
    # Float32 training on the card: the scalar fused backward's path.
    parity = {"train_parity": phase_train_parity(args, transformer, train, packing, counters,
                                                 report),
              "train_parity_dropout": phase_train_parity(
                  args, transformer, train, packing, counters, report,
                  phase="train_parity_dropout", attn_dropout=0.1)}
    for phase, make_cfg in (("train_parity_mistral_w128", transformer.ModelConfig.mistral7b),
                            ("train_parity_gemma2_w128", transformer.ModelConfig.gemma2_9b)):
        pcfg = dataclasses.replace(make_cfg(num_layers=2), dtype="float32",
                                   sliding_window=PARITY_WINDOW)
        parity[phase] = phase_train_parity(args, transformer, train, packing, counters, report,
                                           phase=phase, cfg=pcfg, docs=PARITY_DOCS)
    lap("train_parity")

    paths = {"serve": serve["launches"], "serve_chunked": chunked["launches"],
             "serve_int8": serve_int8["launches"],
             "serve_gemma2": gemma["launches"], "serve_gemma2_whole": gemma_whole["launches"],
             "serve_gemma2_fp8": gemma_fp8["launches"],
             "serve_multistep": _launch_sum(multistep), "serve_speculative": _launch_sum(speculative),
             "serve_speculative_gemma2": _launch_sum(gemma_spec),
             "crosscheck": cross["launches"], "quant_ops": quant_ops["launches"],
             "attention_block_mask": attn_bm["launches"],
             **{p: r["launches"] for p, r in trained.items()},
             **{p: r["launches"] for p, r in parity.items()}}
    summary = []
    tc_timed = report["tc_timed"]
    mains["flash_fwd_tc"] = tc_timed["flash_fwd_tc"]
    mains["paged_prefill_tc"] = tc_timed["paged_prefill_tc"]
    mains["flash_fwd_tc_quant"] = tc_timed["flash_fwd_tc/int8"]
    mains["paged_prefill_tc_quant"] = tc_timed["paged_prefill_tc/int8"]
    scalar_of = {tc: k for k, tc in TC_KERNELS.items()}
    scalar_of.update({tc: f"{k} (its 8-bit form, -DFA_QUANT)" for k, tc in TC_QUANT_KERNELS.items()})
    # A kernel's own launches: its counter's less those of the form counted
    # within it (the scalar kernel's wrapper counts the tensor-core form's,
    # the tensor-core form's counter its 8-bit form's).
    within = {**TC_KERNELS, **{TC_KERNELS[k]: tc for k, tc in TC_QUANT_KERNELS.items()}}
    for kname, source, replaces in KERNELS:
        main_rec = mains[kname]
        by_path = {p: n.get(kname, 0) - n.get(within.get(kname), 0) for p, n in paths.items()}
        by_path = {p: x for p, x in by_path.items() if x}
        built = (" (built with -DFA_QUANT)" if kname in TC_QUANT_KERNELS.values()
                 else " (built with -DFA_PAIR)" if kname == "flash_bwd_dkv_tc" else "")
        summary.append({
            "name": kname, "route": "cuda",
            "source": f"flashattention_tpu_torch/csrc/{source}{built}",
            "replaces": f"flashattention_tpu/{replaces}",
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": main_rec["max_abs_err"],
            "tol": main_rec["tol"], "shape": main_rec["check"],
            "ms": main_rec["kernel_ms"], "kernel_ms": main_rec["kernel_ms"],
            "plain_ms": main_rec["plain_ms"], "bound_ms": main_rec["bound_ms"],
            "bound_by": main_rec["bound_by"], "bytes_ms": main_rec["bytes_ms"],
            "ops_ms": main_rec["ops_ms"], "library_ms": main_rec["library_ms"],
        })
        if kname in report.get("float32_timed", {}):  # the float32 paths' form, timed
            rec32 = report["float32_timed"][kname]
            summary[-1]["float32"] = {k: rec32[k] for k in (
                "check", "shape", "max_abs_err", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
                "bytes_ms", "ops_ms", "library_ms", "library")}
        if kname in scalar_of:  # the tensor-core form: the scalar form's time beside it
            summary[-1]["scalar_form"] = scalar_of[kname]
            summary[-1]["scalar_ms"] = main_rec["scalar_ms"]
        timed = ("check", "shape", "max_abs_err", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
                 "bytes_ms", "ops_ms", "library_ms")
        if kname in bwd_windowed:
            summary[-1]["windowed"] = {case: {k: rec[k] for k in (*timed, "scalar_ms") if k in rec}
                                       for case, rec in bwd_windowed[kname].items()}
        if kname in EXTRA_KERNELS:  # the dropout form: its timed check and launches
            less = f"{TC_KERNELS[kname]}_dropout" if kname in PAIR else None
            summary[-1]["dropout"] = _extra_entry(dropout[kname], paths, f"{kname}_dropout",
                                                  (*timed, "no_dropout_ms"), less)
        if kname in (TC_KERNELS[k] for k in PAIR):
            # The pair's tensor-core form: its dropout form (the packed layer at
            # rate 0.1), Gemma-2's packed layer, and the training layer with
            # the fused form's time beside it.
            summary[-1]["dropout"] = _extra_entry(dropout[kname], paths, f"{kname}_dropout",
                                                  (*timed, "no_dropout_ms", "scalar_ms"))
            summary[-1]["train_layer_vs_fused"] = {
                k: report["pair_vs_fused"][kname][k] for k in (*timed, "fused_ms")}
            if kname == "flash_fwd":
                summary[-1]["dropout"]["quantized"] = {
                    k: dropout["flash_fwd_quant"][k] for k in (*timed, "no_dropout_ms")}
        if kname in masked:  # the block-mask form: the documents mask, the others beside it
            keys = (*timed, "no_mask_ms", "live_pairs", "live_fraction")
            summary[-1]["block_mask"] = _extra_entry(masked[kname]["documents"], paths,
                                                     f"{kname}_block_mask", keys)
            summary[-1]["block_mask"]["masks"] = {
                m: {k: rec[k] for k in keys} for m, rec in masked[kname].items()}
        if kname in ("paged_prefill_tc", "paged_prefill_tc_quant"):  # the NaN-poison checks
            summary[-1]["nan_poison"] = {r["check"]: r["ok"] for r in poison
                                         if ("/quant/" in r["check"]) == kname.endswith("_quant")}
        if kname in ("flash_fwd_tc", "paged_prefill_tc"):  # Gemma-2's window
            summary[-1]["d256_window_softcap"] = {
                k: tc_timed[f"{kname}/d256_window_softcap"][k] for k in (*timed, "scalar_ms")}
        if kname in TC_QUANT_KERNELS.values():  # fp8 beside int8, and Gemma-2's window
            tc = kname.removesuffix("_quant")
            summary[-1]["fp8"] = {k: tc_timed[f"{tc}/fp8"][k] for k in (*timed, "scalar_ms")}
            summary[-1]["d256_window_softcap"] = {
                f: {k: tc_timed[f"{tc}/d256_window_softcap/{f}"][k] for k in (*timed, "scalar_ms")}
                for f in QUANT_FORMS}
        if kname in QUANT_KERNELS:
            summary[-1]["d256_window_softcap"] = {k: serving[None][kname][1][k] for k in timed}
            # The 8-bit form: int8's timed check, fp8's beside it, and both
            # at the Gemma-2 window's shape; its own launches (less the
            # tensor-core 8-bit form's).
            by_path = {p: n.get(f"{kname}_quant", 0) - n.get(TC_QUANT_KERNELS.get(kname), 0)
                       for p, n in paths.items()}
            by_path = {p: x for p, x in by_path.items() if x}
            q8 = {f: serving[f][kname] for f in QUANT_FORMS}
            summary[-1]["quantized"] = {
                **{k: q8["int8"][0][k] for k in timed}, "ms": q8["int8"][0]["kernel_ms"],
                "source": f"flashattention_tpu_torch/csrc/{source} (built with -DFA_QUANT)",
                "launches": sum(by_path.values()), "launches_by_path": by_path,
                "fp8": {k: q8["fp8"][0][k] for k in timed},
                "d256_window_softcap": {f: {k: q8[f][1][k] for k in timed} for f in QUANT_FORMS},
            }
    # The draft form of paged_decode: its own entry, timed at the Llama and
    # Gemma-2 shapes, its 8-bit forms beside it.
    by_path = {p: n["paged_decode_draft"] for p, n in paths.items() if n.get("paged_decode_draft")}
    timed = ("check", "shape", "max_abs_err", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
             "bytes_ms", "ops_ms", "library_ms", "k_times_k1_ms", "row_tiles", "kv_bytes_as_read")
    main_rec = drafts[None]["llama"]
    summary.append({
        "name": "paged_decode_draft", "route": "cuda",
        "source": "flashattention_tpu_torch/csrc/paged_decode.cu (built with -DFA_DRAFT)",
        "replaces": "flashattention_tpu/ops/decode.py:89 (draft_k > 1)",
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        "max_abs_err": main_rec["max_abs_err"], "tol": main_rec["tol"], "shape": main_rec["check"],
        "ms": main_rec["kernel_ms"], **{k: main_rec[k] for k in timed if k not in ("check", "shape")},
        "gemma2": {k: drafts[None]["gemma2"][k] for k in timed},
        "forms_8bit": {f: {case: {k: drafts[f][case][k] for k in timed} for case in TIMED_DRAFT_CASES}
                       for f in QUANT_FORMS},
    })
    report["kernels"] = summary
    report["seconds"] = time.perf_counter() - t_start
    report["phase_seconds"] = laps
    emit({"phase": "total", "seconds": report["seconds"], "by_group": laps})
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as fh:
        json.dump(report, fh, indent=1)

    failed = [c["check"] for c in report["checks"] if not c["ok"]]
    failed += [p for p in ("serve", "serve_chunked", "serve_int8", "serve_gemma2",
                           "serve_gemma2_whole", "serve_gemma2_fp8", "crosscheck", "quant_ops",
                           "parity", "parity_chunked", "parity_quant", "parity_quant_chunked",
                           "serve_multistep", "serve_speculative", "serve_speculative_gemma2",
                           "parity_speculative",
                           "parity_gemma2", "parity_gemma2_chunked", "parity_quant_gemma2",
                           "parity_quant_gemma2_chunked", "train", "train_remat", "train_packed",
                           "train_mistral", "train_gemma2", "train_gemma2_packed", "train_parity",
                           "train_parity_mistral_w128", "train_parity_gemma2_w128",
                           "attention_block_mask", "train_dropout", "train_packed_dropout",
                           "train_parity_dropout")
               if not report[p]["ok"]]
    failed += [k["name"] for k in summary if k["launches"] == 0]
    # The scalar 8-bit forms of the two forwards left the paths for their
    # tensor-core forms (which must launch, above); paged_decode's must.
    failed += [f"{k['name']}/quantized" for k in summary
               if "quantized" in k and k["name"] not in TC_QUANT_KERNELS
               and k["quantized"]["launches"] == 0]
    failed += [f"{k['name']}/{form}" for k in summary for form in ("dropout", "block_mask")
               if form in k and k[form]["launches"] == 0]
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
