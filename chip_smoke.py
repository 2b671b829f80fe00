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
               and built at 4096 for S = 4000, in bf16 the tensor-core
               forms, each beside the scalar form's check under
               ``ops.flash.scalar_forms``, in float32 the scalar forms; the
               tensor-core forms also at d = 64 and 256 (B*H = 8), and with
               dropout 0.1 under the strided mask at each head_dim; timed
               in bf16 against no mask in the same form, the scalar forms
               and SDPA with the boolean mask; the documents mask within a
               quarter of the no-mask time; K/V rows only dead tiles touch
               poisoned with NaN);
               ``torch_tools/dropout_mutants.py`` shows that these fail
               each of nine dropout and block-mask mutants of the scalar
               kernels;
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
               over the dequantized K/V and the bound; in float32 the
               8-bit checks take q in bf16, as the JAX kernels do, through
               the same tensor-core 8-bit forms where they take the call
               (O float32), elsewhere the exact scalar 8-bit forms;
               in bf16 the two-pass pair (d = 64, 128, 256) runs its
               tensor-core forms (``flash_bwd_dq_tc``,
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
               in bf16 paged decode (d = 64, 128, 256, at most 32 q rows
               per KV head, bf16, int8 and fp8 pages) runs its tensor-core
               form (``paged_decode_tc``, ``paged_decode_tc_quant``:
               checks ``paged_decode_tc/...``, ``paged_decode_tc/quant/...``)
               at every paged_checks, paged_window_checks and draft_checks
               shape (the draft form's 8-bit ones at every shape in bf16),
               against the plain version with its rounding (the splits and
               their merge included), each timed one beside the scalar
               form's check and time (``scalar_ms``, cold L2), SDPA and the
               bound, and at serve_gemma2's profile decode shape
               (``decode_serve_shape_timing``: 4 requests of ~1540 tokens,
               bf16 and fp8); ``decode_poison_check`` fills every pool row
               no row may see (past each length, stale pages, before the
               window; fp8: bytes 0x7F and NaN scales) with NaN at Gemma-2's
               layer, its draft form, Llama's and a one-split page-16
               shape, output bitwise the clean pool's; ``split_edge_checks``
               puts lengths where a split boundary falls among the draft
               rows' last columns and at a window's start (a split holding
               only masked columns for some rows);
               ``torch_tools/tc_mutants.py`` shows that they fail each of
               thirty-three tensor-core mutants (six of them in the
               block-mask forms); ``head_dim_pad_check``: ``sdpa``
               at head_dim 80 (zero-padded to 128 by ``attention``),
               forward and gradients under autograd, against the same call
               on the CPU; the float32 forms the float32 paths launch
               (flash_fwd at row 1, paged prefill and paged decode at their
               MHA shapes, paged decode's draft form at the Llama and
               Gemma-2 shapes, the fused backward at the training layer at
               B = 2) timed against their plain versions, SDPA in float32
               and their bound;
               ``f32_form_checks``: the flash forward's float32 form
               (``flash_fwd_tc_f32``, the JAX modes "bf16_3x" and "bf16"
               at d = 64 and 128) against its plain version and the exact
               kernel over seven input cases, lo-term ones among them, NaN
               past kv_len and past a ragged S, timed at row 1 (beside
               the exact kernel, its "bf16" mode, SDPA float32 and its
               bound) and at ``cli/bench.py``'s headline shape;
               ``torch_tools/f32_mutants.py`` shows that they fail a form
               missing a cross product or a second term;
               ``f32_train_checks``: float32 training's forms, the fused
               backward's float32 form (``flash_bwd_tc_f32``, the five
               products over bf16 terms as the JAX ``_dot_g`` computes
               them, "bf16_3x" and "bf16") and the forward's dropout form
               (``flash_fwd_tc_f32_extra``) at d = 64 and 128, the backward
               at d = 256 too, against their plain versions over the GQA
               fold, a ragged S, kv_len / q_offset, a window with a softcap
               (q x 8) and dropout, NaN past kv_len and behind a ragged S,
               and the keep bits against the plain version's; both timed at
               the training layer (B = 2, rate 0.1 for the forward) beside
               the scalar kernels, SDPA float32 and their bound
               (``bwd_checks``, ``dropout_checks``), the backward at
               Gemma-2's windowed layer too (``bwd_window_checks``:
               "bf16_3x", "bf16" and rate 0.1); ``f32_mutants.py`` shows
               that these fail a backward missing one of the three products
               of any of its five matmuls, dO's lo term, with Z's dropout
               bits on dS, or at d = 256 with dS read before its barrier;
               ``pair_f32_checks``: the two-pass pair's float32 forms
               (``flash_bwd_dq_tc_f32``, ``flash_bwd_dkv_tc_f32``: three
               products a matmul at d = 128, four at d = 64 as the JAX
               pair's lane-packed products, "bf16_3x" and "bf16") against
               the plain pair over packed documents, the GQA fold, kv_len /
               q_offset, fused=False, a window with a softcap (q x 8) and
               dropout, on the norm too, dQ bitwise from run to run, NaN
               past kv_len and behind a ragged S, the keep bits; both timed
               at the packed layer (B = 2; with dropout at rate 0.1) beside
               the scalar pair and SDPA float32's masked backward;
               ``f32_mutants.py`` shows that these fail a pass missing one
               of its products (lo lo at d = 64 among them), dO's lo term
               or a live tile;
   attention_block_mask - ``attention(block_mask=, dropout_rate=0.1)``
               under autograd at that layer, bf16, the launches counted: one
               of each tensor-core form (forward, dQ, dK/dV), none scalar;
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
   serve_mixtral_int8 - Mixtral-8x7B-class (``ModelConfig.mixtral8x7b``,
               8 experts, top-2) at full width and its published 32 layers
               on int8 weights (46.7 GB, made and quantized one layer at a
               time) and a bf16 cache, on serve_chunked's engine and
               prompts: every logits row finite, launches and pages as in
               serve_chunked (paged decode at G = 4, d = 128), weights and
               peak GB; one layer's MoE MLP timed (upcasts, products over
               all experts and over the top-2); then a profile;
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
   serve_sharded - DP x TP sharded decode serving (``parallel/serving.py``)
               on 2 x 2 spawned gloo ranks, all on this card: Llama-7B's
               width in 8 layers, serve's 8 prompts (4 a DP slice, history
               from the unsharded whole-prompt prefill), 16 greedy steps in
               float32, bf16 and bf16 over an int8 cache against the
               unsharded ``decode_step``; every rank's paged decode in its
               tensor-core form; each serve phase's record also shows that
               its scheduler and page allocator ran on the C++ runtime core
               (``runtime/native.py``), and the build phase times that
               core's g++ build;
6. crosscheck - the naive kernel's path: ``flash_attention_naive`` and the
               flash kernel through the public entry points on the same
               inputs, each launched once, agreeing; quant_ops - the same
               for ``attention_quantized`` and ``attention(k_scales=,
               v_scales=)``, the path of flash_fwd's 8-bit form, in bf16
               and in float32 q (taken in bf16, O float32);
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
               positions, within PARITY_TOL; parity_mixtral: the MoE model
               at full width in 2 float32 layers, whole-prompt and chunked
               (a 300-token prompt, then one sharing 256 of it);
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
   train_mixtral, train_mixtral_packed - ``mixtral8x7b`` at full width
               in 2 layers, bf16, B = 1, S = 8192, with the AdamW step
               (``make_train_step_optax``, ``make_train_step_packed(
               optimizer=)``): step ms, tokens/s, peak memory, the fused
               backward's or the pair's launches, the loss falling over
               the counted steps;
   checkpoint - ``save_checkpoint`` / ``load_checkpoint`` on the card: a
               2-layer float32 Mixtral cut with int8 weights and an engine
               stopped mid-run, resumed with ``Engine.from_state`` (every
               tensor bitwise, greedy and seeded sampled tokens those of an
               uninterrupted run); a 1-layer train_mixtral cut saved with
               its AdamW state after 2 steps, the third step from the
               restored state against the uninterrupted one's;
10. train_parity - a 2-layer float32 cut at the same width (B = 1, S = 256):
               plain and packed steps, remat off and on, two steps each, on
               the card and on the CPU (plain versions) from the same
               parameters; losses, updated parameters and the first step's
               gradients must agree; train_parity_mistral_w128 and
               train_parity_gemma2_w128 the same for the windowed models at
               full width, their window cut to 128 (about 120 s of CPU work
               for Gemma-2's 256128-wide logits), and train_parity_dropout
               with ``attn_dropout=0.1``; one CPU run without remat is the
               reference of both card runs;
               train_parity_lora - the LoRA step at Mistral-7B's widths in 1
               float32 layer (B = 1, S = 256, rank 8 on wq / wv, A and B
               shifted by 0.01), two SGD steps, card against CPU; and on the
               card ``tests/test_train.py:955``'s chain rule: dA = dW B^T s
               and dB = A^T dW s, dW from the merged model's full step;
11. train_lora - LoRA fine-tuning (``make_train_step_lora``) of Mistral-7B
               at its published 32 layers, window off, bf16, B = 8, S =
               2048, remat, rank 8 on wq and wv, alpha 16, AdamW on the
               adapters: one warm-up step, 3 counted (ms, tokens/s, TFLOP/s
               and MFU by the LoRA step's own count: no base dW, plus the
               recompute; peak memory; flash_fwd 2 L and flash_bwd L per
               step), the loss falling, every base tensor's checksum
               unchanged, B moved from zero, a profile of one step;
   serve_lora_merged - ``merge_lora`` of those adapters into the 32-layer
               base, served whole-prompt (bf16 cache) on four of
               serve_chunked's prompts, 16 new tokens each, then on
               ``quantize_weights`` of the merge (serve_lora_merged_int8):
               each prompt's prefill logits against ``forward_logits`` of
               base and adapters (the training forward, merging per layer)
               within 2e-2 of their largest magnitude, the engine's first
               tokens that forward's greedy tokens;
   train_mixed, train_mixed_optax, train_mixed_packed - the train phase's
               model with float32 masters and ``compute_dtype="bfloat16"``
               through the three steps (SGD, AdamW, packed): the first loss
               bitwise that of the masters cast to bf16 through the bf16
               step, the masters float32 and moving, the tensor-core forms'
               launches; train_mixed_remat_dropout - remat with dropout 0.1,
               finite.
12. selftest  - right after the build, ``utils/selftest.py``'s 21 checks
               (the JAX battery's names, shapes and tolerances) on the
               card's kernels, each asserting that its kernel launched;
   probes    - every H100 probe mode of ``ops/probes.py`` (``probe_mma``'s
               modes, ``probe_int8``'s flavors, the stream and the page
               walk, ``probe_d128``'s stages, ``probe_d128de``'s transposed
               and thin-shape modes, ``probe_fp32``'s float32 as two bf16
               terms) at a small shape against its plain version (PROBE_TOL
               of the output's magnitude in bf16, PROBE_FP32_TOL for the
               packed float32 modes, STREAM_RTOL for the float32 stream, the
               page walk's words equal), float32 q over bf16 and 8-bit
               pages through the three paged entry points (the draft form
               too) and over 8-bit K/V through the flash forward
               (``c4_checks``), then each timed
               at its TPU probe's own shape beside its plain version and,
               where one exists, SDPA (the thin-shape group also four
               cuBLAS products; float32 as two terms also SDPA float32 and
               the port's float32 ``flash_attention``), with flash_fwd_tc
               beside the forward probes (the counted run);
   benches   - every CLI of ``flashattention_tpu_torch/cli/`` in this
               process with its defaults (``bench_serving`` at the
               published 32 layers); each must exit 0 and each of its rows
               carry the card's ``nvidia-smi`` line.

The serve and train phases' launch counts include the tensor-core forms':
every bf16 flash forward, fused backward and two-pass pair launch at their
head_dims, and every paged prefill and paged decode launch of a bf16 model,
goes through them (``launches_tc``; the pair's with dropout also
``launches_tc_dropout``, the forward's and the pair's with a block mask
``launches_tc_block_mask``); the 8-bit caches' paged
prefill and paged decode (serve_int8, serve_gemma2_fp8) and quant_ops'
8-bit flash forward through their 8-bit forms (``launches_tc_quantized``);
the float32 speculative phases keep the scalar paged decode and its draft
over float32 pages, and their int8 cache runs the tensor-core 8-bit form
(q taken in bf16), k = 1 and draft, with no scalar 8-bit launch; each
scalar 8-bit form must launch in the kernel checks (its ``quantized``
entry's ``check_launches``).  Float32 q over 8-bit K/V and pages is timed
at rows 1, 2 and 4 (``f32q_timings``, its own lap).  The float32 train_parity phases' card launches are
counted as paths too: at d = 64 and 128 float32 training runs the forward's
float32 form (its dropout form with dropout), the fused backward's float32
form and the pair's, at d = 256 (Gemma-2) the fused backward's and the
pair's float32 forms, and no scalar fused backward or pair
(``_f32_form_launched``); the scalar fused backward and pair, which then
launch on no path, must launch in the backward checks (their dropout forms
in the dropout checks).  It prints one JSON line per check, the
total seconds, a ``{"kernels": [...]}`` summary (with a ``quantized`` entry
for each serving kernel's 8-bit form, ``dropout`` entries for flash_fwd and
the backward kernels, ``block_mask`` entries for the tensor-core forms of
flash_fwd and the pair, paged_decode's draft form and the
tensor-core forms and their 8-bit forms as entries of their own, each
entry counting its own launches only, the scalar ones a ``float32`` entry
where the float32 paths launch them), the card's name
and power limit, and last ``{"ok": true, "device": {...}}``.
Details go to ``chiprun_out/chip_smoke.json``.  It needs one CUDA card and
imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import functools
import itertools
import json
import os
import re
import shutil
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
    # Paged decode's (bf16 q over bf16 pages; over 8-bit pages with -DFA_QUANT).
    ("paged_decode_tc", "paged_decode_tc.cu", "ops/decode.py:89"),
    ("paged_decode_tc_quant", "paged_decode_tc.cu", "ops/decode.py:89"),
    # The forward's float32 form (float32 q, k, v as bf16 terms: the JAX
    # precision modes "bf16_3x" and "bf16"), built with -DFA_F32.
    ("flash_fwd_tc_f32", "flash_fwd_tc.cu", "ops/flash.py:628"),
    # Float32 split into bf16 terms in shared memory (csrc/flash_fwd_f32.cuh):
    # the forward's "float32" mode (XLA's HIGHEST, six products) at d = 64,
    # 128 and 256 and its "bf16_3x" at 256, built into flash_fwd_tc_f32; and
    # chunked prefill over float32 pools, paged_prefill_tc.cu with -DFA_F32.
    ("flash_fwd_f32", "flash_fwd_f32.cuh", "ops/flash.py:628"),
    ("paged_prefill_tc_f32", "paged_prefill_tc.cu", "ops/decode.py:375"),
    # Float32 training's forms ("bf16_3x" and "bf16"; the backward at d = 64,
    # 128 and 256, the dropout forward at 64 and 128): the fused backward
    # over bf16 terms (flash_bwd_tc.cu with -DFA_F32; its dropout form with
    # -DFA_EXTRA too) and the forward's dropout form (flash_fwd_tc.cu with
    # -DFA_F32 -DFA_EXTRA).
    ("flash_bwd_tc_f32", "flash_bwd_tc.cu", "ops/backward.py:401"),
    ("flash_fwd_tc_f32_extra", "flash_fwd_tc.cu", "ops/flash.py:628"),
    # Float32 packed training's: the pair over bf16 terms (its dQ pass with
    # -DFA_F32, its dK/dV pass the fused source with -DFA_PAIR -DFA_F32; their
    # dropout forms with -DFA_EXTRA too).
    ("flash_bwd_dq_tc_f32", "flash_bwd_dq_tc.cu", "ops/backward.py:146"),
    ("flash_bwd_dkv_tc_f32", "flash_bwd_tc.cu", "ops/backward.py:269"),
    # Paged decode over float32 pages (XLA's HIGHEST, three bf16 terms split
    # in registers, six products on mma.sync), built with -DFA_F32.
    ("paged_decode_tc_f32", "paged_decode_tc.cu", "ops/decode.py:89"),
)
PAIR_F32 = {k: f"{k}_tc_f32" for k in ("flash_bwd_dq", "flash_bwd_dkv")}
TC_KERNELS = {"flash_fwd": "flash_fwd_tc", "flash_bwd": "flash_bwd_tc",
              "paged_prefill": "paged_prefill_tc", "flash_bwd_dq": "flash_bwd_dq_tc",
              "flash_bwd_dkv": "flash_bwd_dkv_tc", "paged_decode": "paged_decode_tc"}
PAIR = ("flash_bwd_dq", "flash_bwd_dkv")
TC_QUANT_KERNELS = {"flash_fwd": "flash_fwd_tc_quant", "paged_prefill": "paged_prefill_tc_quant",
                    "paged_decode": "paged_decode_tc_quant"}
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
          "flash_fwd_f32_kernel": ("window_cap", "paged"),
          "flash_bwd_tc_kernel": ("window_cap", "extra", "pair"),
          "flash_bwd_tc_wide_kernel": ("window_cap", "extra", "pair"),
          "probe_kernel": ("vt", "kt"), "probe_t_kernel": ("vt", "o_norm")}


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
        # The mangled name's length prefix must be the name's length: the
        # namespace before it may end in digits too (fwd_tc::).
        m = "Compiling entry function" in ln and next(
            (c for c in re.finditer(rf"(?=(\d+)([a-z_][a-z0-9_]*_kernel)I((?:{types})*)"
                                    rf"((?:L[ib]\d+E)+))", ln)
             if int(c.group(1)) == len(c.group(2))), None)
        if m:
            _, name, type_args, value_args = m.groups()
            args = [_MANGLED_TYPES[t] for t in re.findall("|".join(_MANGLED_TYPES), type_args)]
            args = args[:1] if args[1:] == args[:1] else args  # the payload is q's type
            flags = iter(_FLAGS.get(name, ("window_cap", "extra")))
            for kind, n in re.findall(r"L([ib])(\d+)E", value_args):
                flag = next(flags, "flag") if kind == "b" else None
                args += [n] if kind == "i" else [flag] if n == "1" else []
            if name == "flash_fwd_tc_kernel":  # its last ints: the K/V payload form, the terms
                *args, kv, terms = args
                args += {"1": ["int8"], "2": ["fp8"]}.get(kv, [])
                args += {"0": [], "1": ["f32_1_term"]}.get(terms, [f"f32_{terms}_products"])
            if name in ("flash_bwd_tc_kernel", "flash_bwd_tc_wide_kernel",
                        "flash_bwd_dq_tc_kernel"):  # its last int: terms
                *args, terms = args
                args += {"0": [], "1": ["f32_1_term"]}.get(terms, [f"f32_{terms}_terms"])
            out.append({"kernel": f"{name}<{','.join(args)}>"})
        elif "Compiling entry function" in ln:  # a kernel not reported (the split pass)
            out.append({"kernel": None})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and out:
            out[-1].update(registers=int(m.group(1)), spill_stores=spills[0], spill_loads=spills[1])
    return [x for x in out if x["kernel"]]


def phase_build(kernels, native, report):
    """Every kernel library (nvcc), then the C++ runtime core (g++): each
    one's seconds."""
    t0 = time.perf_counter()
    built = kernels.build_all()
    seconds = time.perf_counter() - t0
    for name, info in built.items():
        report["build"][name] = {"seconds": info["seconds"], "ptxas": _ptxas(info["log"])}
    report["native_build"] = native.build()
    emit({"phase": "build", "seconds": seconds, "kernels": sorted(built),
          "native_runtime": report["native_build"], "card": report["card"]})


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


def _kname(kernel, q, quantized=False, block_mask=False, page_size=PAGE_SIZE, dropout=False,
           precision=None):
    """The kernel a call of ``kernel`` on ``q`` launches: its tensor-core
    form's name where ``ops.flash.kernel_form`` picks it (bf16 at its
    head_dims, a block mask in the flash forward and the pair over 16-bit
    K/V, 8-bit K/V in the forwards and paged decode too; the paged kernels:
    a page size they take; paged decode: at most 32 q rows per KV head,
    q's second-to-last dimension), the forward's
    float32 form's for float32 q at its head_dims (``flash_fwd_f32``, the
    kernel that splits in shared memory, in ``precision`` "float32" and in
    "bf16_3x" at d = 256, else ``flash_fwd_tc_f32``; with dropout its
    dropout form ``flash_fwd_tc_f32_extra``), chunked prefill's over float32
    pools (``paged_prefill_tc_f32``), paged decode's over float32 pages
    (``paged_decode_tc_f32``), the fused backward's over float32
    (``flash_bwd_tc_f32``) and the pair's (``flash_bwd_dq_tc_f32``,
    ``flash_bwd_dkv_tc_f32``), else ``kernel``.  Float32 q over 8-bit K/V is taken in bf16 (the JAX
    kernels' default), so its form is the bf16 call's.
    A check of an 8-bit form is named ``<kernel>/quant/...``
    (``_check_name``), so the tensor-core 8-bit forms' checks read
    ``flash_fwd_tc/quant/...``, ``paged_prefill_tc/quant/...``,
    ``paged_decode_tc/quant/...``."""
    from flashattention_tpu_torch.ops import flash

    tc = TC_KERNELS.get(kernel)
    rows = q.shape[-2] if kernel == "paged_decode" else 1
    dt = torch.bfloat16 if quantized else q.dtype
    form = tc and flash.kernel_form(kernel, dt, q.shape[-1], quantized=quantized,
                                    block_mask=block_mask, page_size=page_size, rows=rows,
                                    dropout=dropout, precision=precision)
    if form == "tc_f32":
        if kernel in ("paged_prefill", "paged_decode", "flash_bwd", *PAIR):
            return f"{kernel}_tc_f32"
        if dropout:
            return "flash_fwd_tc_f32_extra"
        mode = flash.resolve_precision(precision, torch.float32)
        return "flash_fwd_f32" if flash.f32_split(q.shape[-1], mode) else "flash_fwd_tc_f32"
    return tc if form == "tc" else kernel


def _tc_key(kernel, case, form):
    """The key of a timed tensor-core check in ``report["tc_timed"]``."""
    return "/".join(x for x in (kernel, case, form) if x)


_TIMED_KEYS = ("library_ms", "library", "bound_ms", "bound_by", "bytes_ms", "ops_ms")


def _scalar_twin(flash, benchit, rec, run, plain, dt, tol, flush_bytes=0):
    """The scalar form of a timed tensor-core check, at the same inputs and
    in the same call (``ops.flash.scalar_forms``): ``rec`` gains its time
    (``scalar_ms``), and the scalar form's own check (against the scalar
    plain version), with the same yardsticks, is returned under the scalar
    kernel's name.  ``flush_bytes``: as ``benchit.cuda_time_ms``'s (the
    decode checks time each call with a cold L2, as the kernels' own)."""
    with flash.scalar_forms():
        got, want = run(), plain()
        torch.cuda.synchronize()
        twin = _rec(re.sub(r"_tc(_f32)?/", "/", rec["check"], count=1), got, want, dt, tol,
                    form="scalar (ops.flash.scalar_forms)",
                    **{k: rec[k] for k in ("shape", "live_pairs", "live_rows", "lengths")
                       if k in rec})
        twin["kernel_ms"] = benchit.cuda_time_ms(run, warmup=1, iters=5, flush_bytes=flush_bytes)
        twin["plain_ms"] = benchit.cuda_time_ms(plain, warmup=1, iters=3, flush_bytes=flush_bytes)
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
            if name == "prefill" and dt == "float32" and form is None:
                # Row 1's float32 forms: this check's (the float32 form in
                # "bf16_3x"), its "bf16" mode, the "float32" mode's
                # (flash_fwd_f32) and the scalar kernel's row.
                kw1 = dict(causal=True, scale=scale, q_offset=s_kv - s_q, q_seq_len=s_q)
                twin, exact = _f32_timed(
                    flash, benchit, card, rec,
                    lambda mode=None: fa.attention(q, k, v, causal=True, scale=scale,
                                                   precision=mode),
                    lambda mode=None: flash.flash_attention_plain(
                        q3, k3, v3, precision=mode, **kw1).reshape(q.shape),
                    lambda: flash.flash_attention_plain(q3, k3, v3, form="scalar",
                                                        **kw1).reshape(q.shape),
                    d=d, pairs=b * h * s_q * (s_q + 1) // 2,
                    nbytes=4 * (2 * q.numel() + 2 * k.numel()),
                    sdpa=lambda: torch.nn.functional.scaled_dot_product_attention(
                        q, k, v, is_causal=True, scale=scale),
                    library="scaled_dot_product_attention, float32, is_causal")
                report.setdefault("tc_timed", {})["flash_fwd_tc_f32"] = rec
                report["tc_timed"]["flash_fwd_f32"] = exact
                report.setdefault("float32_timed", {})["flash_fwd"] = twin
                for r in (twin, exact):
                    emit(r)
                    report["checks"].append(r)
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


def _f32_timed(flash, benchit, card, rec, run, plain, scalar_plain, *, d, pairs, nbytes, sdpa,
               library):
    """Times of one float32 ``attention`` call's forms on the same inputs:
    ``rec``, the default call's check (``run()``, the float32 form in
    "bf16_3x"), gains its kernel, plain (``plain()``) and ``sdpa`` times
    (``library``), its one-pass "bf16" mode's (``bf16_mode_ms``), the
    "float32" mode's (``exact_ms``), the scalar kernel's (``scalar_ms``) and
    its bound: ``nbytes`` (float32 q, k, v and o once) over the memory rate,
    or the bf16 products (``f32_products`` each for S and PV, 2 d flops a
    live pair each, over ``pairs``) over the bf16 peak.  Returns the scalar
    kernel's own check (``precision="float32"`` under
    ``ops.flash.scalar_forms`` against ``scalar_plain()``) and the
    "float32" mode's (``flash_fwd_f32``: ``run("float32")`` against
    ``plain("float32")``, six products each for S and PV over the bf16
    peak), each with its times and bound."""
    n = flash.f32_products(d)
    rec.update(kernel_ms=benchit.cuda_time_ms(run, warmup=1, iters=5),
               plain_ms=benchit.cuda_time_ms(plain, warmup=1, iters=3),
               bf16_mode_ms=benchit.cuda_time_ms(lambda: run("bf16"), warmup=1, iters=5),
               library_ms=benchit.cuda_time_ms(sdpa, warmup=1, iters=5), library=library,
               products=f"{n} for S, {n} for PV", live_pairs=pairs,
               **benchit.bound_ms(card, bytes_moved=nbytes, flops=4 * n * d * pairs,
                                  dtype="bfloat16"))
    case = rec["check"].split("/", 1)[1]
    got, want = run("float32"), plain("float32")
    torch.cuda.synchronize()
    exact = _rec(f"flash_fwd_f32/{case}/precision_float32", got, want, "float32",
                 FLASH_TOL["float32"], shape=rec.get("shape"),
                 form='the float32 form in "float32" (three bf16 terms, six products)')
    exact.update(kernel_ms=benchit.cuda_time_ms(lambda: run("float32"), warmup=1, iters=5),
                 plain_ms=benchit.cuda_time_ms(lambda: plain("float32"), warmup=1, iters=3),
                 library_ms=rec["library_ms"], library=library, products="6 for S, 6 for PV",
                 live_pairs=pairs,
                 **benchit.bound_ms(card, bytes_moved=nbytes, flops=24 * d * pairs,
                                    dtype="bfloat16"))
    with flash.scalar_forms():
        got, want = run("float32"), scalar_plain()
        torch.cuda.synchronize()
        twin = _rec(f"flash_fwd/{case}", got, want, "float32", FLASH_TOL["float32"],
                    shape=rec.get("shape"), form='exact float32 (the scalar kernel)')
        twin["kernel_ms"] = benchit.cuda_time_ms(lambda: run("float32"), warmup=1, iters=3)
    twin.update(plain_ms=benchit.cuda_time_ms(scalar_plain, warmup=1, iters=3),
                library_ms=rec["library_ms"], library=library, live_pairs=pairs,
                **benchit.bound_ms(card, bytes_moved=nbytes, flops=4 * d * pairs,
                                   dtype="float32"))
    rec["scalar_ms"] = exact["scalar_ms"] = twin["kernel_ms"]
    rec["exact_ms"] = exact["kernel_ms"]
    return twin, exact


# The forward's float32 form: float32 q, k, v in the JAX precision modes
# "bf16_3x" (the default), "bf16" and "float32" (XLA's HIGHEST), at d = 64,
# 128 and 256 (flash_fwd_tc_f32, and flash_fwd_f32 where ops.flash.f32_split
# says so), held against its plain version (F32_FORM_TOL of the output's
# magnitude) and, in "bf16_3x" and "float32", within 1e-4 of the scalar
# kernel's exact float32 output.
F32_MODES = ("bf16_3x", "bf16", "float32")
F32_FORM_TOL = {"bf16_3x": 1e-4, "bf16": 2e-2, "float32": 1e-4}
F32_EXACT_TOL = 1e-4  # against the scalar kernel ("bf16": recorded only)
# (BH, G, S_q, S_kv, kwargs): folded q (BH, G S_q, d) against (BH, S_kv, d)
F32_FORM_CASES = {
    "causal": (16, 1, 1000, 1000, dict(causal=True)),
    "full": (16, 1, 1000, 1000, dict(causal=False)),
    "gqa_fold": (8, 4, 512, 512, dict(causal=True)),
    "kv_len_residuals": (16, 1, 128, 300, dict(causal=True, kv_len=250, q_offset=122,
                                               save_residuals=True)),
    "window_softcap": (16, 1, 1000, 1000, dict(causal=True, window=300, logit_softcap=30.0)),
    "segments": (16, 1, 1000, 1000, dict(causal=False, segments=True)),
    "lo_term": (8, 1, 512, 512, dict(causal=True, lo_term=True)),
    # "float32" alone: probes.lo3_term_f32_qkv's inputs, whose third-term
    # products move the output by far more than the tolerance, and
    # probes.v3_term_f32_qkv's, whose rows are V's (a form without V's third
    # term misses by 3.7e-4, held at FLASH_TOL absolute).  The scalar kernel
    # rounds their scores near 4096 to float32 once a product (2^-12), which
    # is the size of those terms: they are not held to it.
    "lo3_term": (8, 1, 512, 512, dict(causal=True, lo3_term=True)),
    "v3_term": (16, 1, 0, 0, dict(causal=True, v3_term=True)),
}
F32_EXACT_ONLY = ("lo3_term", "v3_term")
F32_HEADLINE = dict(b=2, h=8, s=8192, d=64)  # cli/bench.py's headline, non-causal


def _f32_case(probes, gen, d, case):
    """The inputs and keywords of one F32_FORM_CASES case at head_dim d."""
    bh, g, s_q, s_kv, kw = F32_FORM_CASES[case]
    kw = dict(kw)
    if kw.pop("lo_term", False):
        q, k, v = probes.lo_term_f32_qkv(bh, s_kv, d, generator=gen, device="cuda")
        return q, k, v, dict(kw, scale=1.0)
    if kw.pop("lo3_term", False):
        q, k, v = probes.lo3_term_f32_qkv(bh, s_kv, d, generator=gen, device="cuda")
        return q, k, v, dict(kw, scale=1.0)
    if kw.pop("v3_term", False):
        q, k, v = probes.v3_term_f32_qkv(bh, d, generator=gen, device="cuda")
        return q, k, v, dict(kw, scale=1.0)
    q = torch.randn((bh, g * s_q, d), generator=gen, device="cuda")
    k, v = (torch.randn((bh, s_kv, d), generator=gen, device="cuda") for _ in range(2))
    if g > 1:
        kw["q_seq_len"] = s_q
    if kw.pop("segments", False):
        kw["q_segment_ids"], kw["kv_segment_ids"] = (
            torch.randint(0, 4, (bh, n), generator=gen, device="cuda").sort(-1).values
            for n in (g * s_q, s_kv))
    return q, k, v, dict(kw, scale=d**-0.5)


def _f32_hold(flash, check, q, k, v, mode, kw, exact_tol=F32_EXACT_TOL, abs_tol=None):
    """One call of the float32 form on the card against its plain version
    and the scalar kernel's exact float32 (``precision="float32"`` under
    ``ops.flash.scalar_forms``, which must launch it) within ``exact_tol``
    (None: recorded only; never in "bf16"), and, with ``abs_tol``, within
    that of its plain version absolutely; the call must launch the form's
    kernel (``flash_fwd_f32`` where ``ops.flash.f32_split`` says so); the
    residuals within STATS_RTOL."""
    fa_ = flash.flash_attention
    n = fa_.launches_tc_f32, fa_.launches_tc_f32_split
    got = flash.flash_attention(q, k, v, precision=mode, **kw)
    launched = fa_.launches_tc_f32 - n[0]
    split = fa_.launches_tc_f32_split - n[1] == int(flash.f32_split(q.shape[-1], mode))
    want = flash.flash_attention_plain(q, k, v, precision=mode, **kw)
    n = flash.flash_attention.launches, flash.flash_attention.launches_tc_f32
    with flash.scalar_forms():
        exact = flash.flash_attention(q, k, v, precision="float32", **kw)
    scalar = (flash.flash_attention.launches - n[0], flash.flash_attention.launches_tc_f32 - n[1])
    torch.cuda.synchronize()
    stats = {}
    if kw.get("save_residuals"):
        stats = {f"{x}_rel_err": err(a, b) / float(b.abs().max())
                 for x, a, b in zip("lm", got[1:], want[1:])}
        got, want, exact = got[0], want[0], exact[0]
    norm = float(want.abs().max())
    rec = {"check": check, "max_abs_err": err(got, want), "rel_err": err(got, want) / norm,
           "tol": F32_FORM_TOL[mode], "exact_rel_err": err(got, exact) / norm,
           "exact_tol": exact_tol if mode != "bf16" else None, "abs_tol": abs_tol,
           "launches": launched, "launched_its_kernel": split,
           "exact_launched_scalar": scalar == (1, 0), **stats,
           "tol_of": "the output's largest magnitude"}
    rec["ok"] = (launched == 1 and split and scalar == (1, 0) and rec["rel_err"] <= rec["tol"]
                 and (rec["exact_tol"] is None or rec["exact_rel_err"] <= rec["exact_tol"])
                 and (abs_tol is None or rec["max_abs_err"] <= abs_tol)
                 and all(x <= STATS_RTOL for x in stats.values()))
    return rec


def f32_form_checks(fa, flash, probes, benchit, gen, card, report, timed=True):
    """The float32 form at d = 64, 128 and 256 in the three modes over
    F32_FORM_CASES (causal and not, the GQA fold, kv_len / q_offset with
    the residuals, a window with a softcap, segment ids, and
    ``probes.lo_term_f32_qkv``'s inputs, on which a form without a cross
    product or a second term misses by far more than the tolerance; in
    "float32" also ``probes.lo3_term_f32_qkv``'s and ``v3_term_f32_qkv``'s,
    on which a form without a third-term product or V's third term misses),
    each against its plain version and the scalar kernel; NaN in K/V rows
    past kv_len, and in every row of the next head (behind kv_len; behind a
    ragged S, where the last tiles of q, K and V reach in memory), the
    first head's output bitwise the clean inputs'; then (``timed``) timed
    at cli/bench.py's headline shape beside the "float32" mode, the scalar
    kernel, SDPA float32 and the bound.  Returns the headline's record
    (None untimed); ``torch_tools/f32_mutants.py`` shows that these checks
    fail a form without one of its cross products or its terms.  A check is
    named by the kernel that runs it (``_kname``)."""
    for d, mode, case in itertools.product(flash.TC_F32_HEAD_DIMS, F32_MODES, F32_FORM_CASES):
        if case in F32_EXACT_ONLY and mode != "float32":
            continue
        q, k, v, kw = _f32_case(probes, gen, d, case)
        rec = _f32_hold(flash, f"{_kname('flash_fwd', q, precision=mode)}/{case}/d{d}/{mode}",
                        q, k, v, mode, kw,
                        exact_tol=None if case in F32_EXACT_ONLY else F32_EXACT_TOL,
                        abs_tol=FLASH_TOL["float32"] if case == "v3_term" else None)
        emit(rec)
        report["checks"].append(rec)
    for d, mode, past in itertools.product(flash.TC_F32_HEAD_DIMS, F32_MODES, ("kv_len", "s")):
        if past == "kv_len":
            q, k, v, kw = _f32_case(probes, gen, d, "kv_len_residuals")
            kw.pop("save_residuals")
        else:  # a ragged S = 200: the last 128-row tiles of q, K and V reach past it
            q, k, v = (torch.randn((4, 200, d), generator=gen, device="cuda") for _ in range(3))
            kw = dict(causal=False, scale=d**-0.5)
        clean = flash.flash_attention(q, k, v, precision=mode, **kw)
        kp, vp, qp = k.clone(), v.clone(), q.clone()
        if past == "kv_len":
            kp[:, kw["kv_len"]:] = float("nan")
            vp[:, kw["kv_len"]:] = float("nan")
        qp[1:], kp[1:], vp[1:] = float("nan"), float("nan"), float("nan")
        got = flash.flash_attention(qp, kp, vp, precision=mode, **kw)
        torch.cuda.synchronize()
        kname = _kname("flash_fwd", q, precision=mode)
        rec = {"check": f"{kname}/nan_poison/past_{past}/d{d}/{mode}",
               "ok": bool(torch.equal(got[0], clean[0]))}
        emit(rec)
        report["checks"].append(rec)
    if not timed:
        return None
    b, h, s, d = (F32_HEADLINE[x] for x in ("b", "h", "s", "d"))
    q, k, v = (torch.randn((b, h, s, d), generator=gen, device="cuda") for _ in range(3))
    kw = dict(causal=False, scale=d**-0.5)
    q3, k3, v3 = (x.reshape(b * h, s, d) for x in (q, k, v))
    plain = lambda mode=None, form=None: flash.flash_attention_plain(  # noqa: E731
        q3, k3, v3, form=form, precision=mode, **kw).reshape(q.shape)
    o = fa.attention(q, k, v, **kw)
    rec = _rec("flash_fwd_tc_f32/headline/float32", o, plain(), "float32", FLASH_TOL["float32"],
               shape=f"B={b} H={h} S={s} d={d} non-causal (cli/bench.py's headline)")
    twin, exact = _f32_timed(
        flash, benchit, card, rec, lambda mode=None: fa.attention(q, k, v, precision=mode, **kw),
        plain, lambda: plain(form="scalar"), d=d, pairs=b * h * s * s,
        nbytes=4 * 4 * q.numel(),
        sdpa=lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, scale=kw["scale"]),
        library="scaled_dot_product_attention, float32")
    for r in (rec, twin, exact):
        emit(r)
        report["checks"].append(r)
    report.setdefault("tc_timed", {})["flash_fwd_tc_f32/headline"] = rec
    report["tc_timed"]["flash_fwd_f32/headline"] = exact
    del q, k, v, q3, k3, v3
    torch.cuda.empty_cache()
    return rec


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


def _decode_twin(flash, benchit, report, rec, kernel, plain, dt, key):
    """A timed paged-decode check of the tensor-core form (``rec``): its
    scalar form beside it (``_scalar_twin``, a cold L2 for both), ``rec``
    kept in ``report["tc_timed"][key]``; returns the scalar form's check
    (the scalar kernel's row), which is emitted and recorded."""
    twin = _scalar_twin(flash, benchit, rec, kernel, plain, dt, PAGED_TOL[dt], flush_bytes=256 << 20)
    report.setdefault("tc_timed", {})[key] = rec
    emit(twin)
    report["checks"].append(twin)
    return twin


def paged_checks(decode, benchit, gen, card, report, form=None):
    """Paged decode: MHA (32 KV heads, G=1) and GQA (8 KV heads, G=4); with
    ``form`` (int8 or fp8) over 8-bit pages with per-row scales.  In bf16
    the tensor-core form runs (``paged_decode_tc/...``, against the plain
    version with its rounding), in float32 over float32 pages its float32
    form (``paged_decode_tc_f32/...``); at the MHA shape each is timed with
    the scalar form timed and checked beside it (in float32 beside SDPA in
    float32; the scalar one kept in ``report["float32_timed"]``)."""
    from flashattention_tpu_torch.ops import flash

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
            kname = _kname("paged_decode", q, form is not None)
            rec = _rec(_check_name(kname, name, dt, form), o, want, dt, PAGED_TOL[dt],
                       lengths=c["lengths"], shape=f"B={b} KVH={kvh} G={c['g']} d={d} ps={ps}")
            if name == "decode_mha" and (dt == "bfloat16" or form is None):
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
                if dt == "bfloat16":
                    out["main"] = rec
                if kname in ("paged_decode_tc", "paged_decode_tc_f32"):
                    twin = _decode_twin(flash, benchit, report, rec, kernel, plain, dt,
                                        _tc_key(kname, None, form))
                    if dt == "float32":
                        report.setdefault("float32_timed", {})["paged_decode"] = twin
                    else:
                        out["main"] = twin
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


def _prefill_bound(benchit, card, rec, kname, nbytes, flops, dt):
    """A paged-prefill record's bound: ``flops`` (one product each for S
    and PV) over ``dt``'s peak, or, for the float32 form, the six bf16
    products each that XLA's HIGHEST takes over the bf16 peak."""
    if kname == "paged_prefill_tc_f32":
        rec.update(benchit.bound_ms(card, bytes_moved=nbytes, flops=6 * flops, dtype="bfloat16"),
                   products="6 for S, 6 for PV")
    else:
        rec.update(benchit.bound_ms(card, bytes_moved=nbytes, flops=flops, dtype=dt))


def prefill_checks(decode, benchit, gen, card, report, form=None):
    """Paged prefill: MHA (32 KV heads, G=1) at the engine's chunk, GQA
    (8 KV heads, G=4) with seg > chunk and a ctx = 0 row, the single form;
    with ``form`` (int8 or fp8) over 8-bit pages with per-row scales.  In
    bf16 the tensor-core form runs (``paged_prefill_tc/...``, against the
    plain version with its rounding), over float32 pools its float32 form
    (``paged_prefill_tc_f32/...``); at the MHA shape the scalar form is
    timed and checked beside each (its float32 record is the scalar row's,
    ``float32_timed``)."""
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
                _prefill_bound(benchit, card, rec, kname, nbytes, flops, dt)
                if dt == "float32" and kname != "paged_prefill_tc_f32":
                    report.setdefault("float32_timed", {})["paged_prefill"] = rec
                elif dt == "bfloat16":
                    out["main"] = rec
                if kname in ("paged_prefill_tc", "paged_prefill_tc_f32"):
                    twin = _scalar_twin(flash, benchit, rec, kernel, plain, dt, PREFILL_TOL[dt])
                    report.setdefault("tc_timed", {})[_tc_key(kname, None, form)] = rec
                    if kname == "paged_prefill_tc_f32":  # the scalar kernel's own bound
                        twin.update(benchit.bound_ms(card, bytes_moved=nbytes, flops=flops,
                                                     dtype="float32"))
                        report.setdefault("float32_timed", {})["paged_prefill"] = twin
                    else:
                        out["main"] = twin
                    emit(twin)
                    report["checks"].append(twin)
            emit(rec)
            report["checks"].append(rec)
            del kp, vp, ks, vs, q, o, want
    torch.cuda.empty_cache()
    return out["main"]


def _poison_pool(pools, scales, table, lens, first_of, ps, nan):
    """Fill every pool row no query row may see with ``nan``: per request
    ``i``, the rows of its table's pages before ``first_of(n)`` and at or
    past its length ``n`` (whole pages past the live ones); 8-bit pools'
    ``scales`` there with NaN."""
    for i, n in enumerate(lens):
        first = first_of(n)
        for j in range(table.shape[1]):
            page = int(table[i, j])
            lo, hi = max(0, min(ps, first - j * ps)), max(0, min(ps, n - j * ps))
            for x, v in [(p, nan) for p in pools] + [(sc, float("nan")) for sc in scales]:
                x[page, :, :lo] = v
                x[page, :, max(lo, hi):] = v


def prefill_poison_check(decode, gen, report, dtypes=("bfloat16", "float32")):
    """The tensor-core paged prefill reads no K/V row that no query row may
    see: at the Gemma-2 window shape, GQA with seg > chunk, and a page size
    below the KV tile (the tile built from several pages), every pool row
    past each request's ctx_len, every page its table names past the live
    ones and every row before the first column any row's window reaches are
    filled with NaN; the output must equal the clean pool's, bit for bit
    (and be finite).  The fp8 cases do the same over fp8 pages, through the
    8-bit form: those rows' payload bytes are 0x7F (NaN in e4m3) and their
    scales NaN; the float32 cases over float32 pools and q, through the
    float32 form (``paged_prefill_tc_f32``), whose output is also held
    against its plain version.  ``dtypes``: the pools' types to run (fp8
    with "bfloat16")."""
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
    cases += tuple((name, {**c, "dtype": "float32"}) for name, c in cases[:3])
    recs = []
    for name, c in cases:
        if c.get("dtype", "bfloat16") not in dtypes:
            continue
        b, ps, pps, d = len(c["ctx"]), c["ps"], c["pps"], c["d"]
        form = c.get("form")
        pages = b * pps + 4
        ctx = torch.tensor(c["ctx"], dtype=torch.int32, device="cuda")
        dt = c.get("dtype", "bfloat16")
        (kp, ks), (vp, vs), table = _paged_pool(gen, c["ctx"], pps, pages, (c["kvh"], ps, d),
                                                DTYPES[dt], form)
        q = torch.randn((b, c["kvh"], c["g"] * c["seg"], d), generator=gen,
                        device="cuda").to(DTYPES[dt])
        kw = dict(chunk=c["chunk"], seg=c["seg"], scale=d**-0.5, window=c["window"],
                  logit_softcap=c["cap"])
        clean = decode.paged_prefill_attention_batched(q, kp, vp, table, ctx, **kw,
                                                       **_page_scales(ks, vs))
        kn, vn = kp.clone(), vp.clone()
        sn = [None if x is None else x.clone() for x in (ks, vs)]
        # The poison: NaN, or in an fp8 pool the byte 0x7F (e4m3's NaN); the
        # columns [first, n) are the only ones some row sees.
        w = c["window"]
        _poison_pool([x.view(torch.uint8) if form else x for x in (kn, vn)],
                     [x for x in sn if x is not None], table, c["ctx"],
                     lambda n: 0 if w is None else max(0, n - c["chunk"] - w + 1), ps,
                     0x7F if form else float("nan"))
        poisoned = decode.paged_prefill_attention_batched(q, kn, vn, table, ctx, **kw,
                                                          **_page_scales(*sn))
        torch.cuda.synchronize()
        equal = bool(torch.equal(poisoned, clean))
        finite = bool(torch.isfinite(poisoned).all())
        check = _check_name(_kname("paged_prefill", q, form is not None, page_size=ps),
                            f"nan_poison/{name}", dt, form)
        rec = {"check": check,
               "shape": f"B={b} KVH={c['kvh']} G={c['g']} d={d} ps={ps} chunk={c['chunk']} "
                        f"seg={c['seg']} window={c['window']} cap={c['cap']}",
               "ctx_lens": c["ctx"], "bitwise_equal": equal, "finite": finite,
               "max_abs_err": err(poisoned.nan_to_num(), clean), "ok": equal and finite}
        if dt == "float32":  # the float32 form against its plain version too
            want = decode.paged_prefill_attention_plain(q, kp, vp, table, ctx, **kw)
            rec.update(plain_err=err(clean, want), tol=PREFILL_TOL[dt])
            rec["ok"] = rec["ok"] and rec["plain_err"] <= PREFILL_TOL[dt]
        emit(rec)
        report["checks"].append(rec)
        recs.append(rec)
        del kp, vp, ks, vs, kn, vn, sn, q, clean, poisoned
    torch.cuda.empty_cache()
    return recs


# The decode NaN-poison cases: (name, KV heads, G, draft k, d, page size,
# pages per request, lengths, window, softcap).  Gemma-2's layer (window
# 4096, softcap 50, d = 256) at the serving page, its draft form (k = 4),
# Llama's MHA layer, and a page of 16 rows whose table holds one KV tile, so
# one split and the kernel's own epilogue (no merge); the Gemma-2 and page-16
# cases again over fp8 pages.
DECODE_POISON_CASES = (
    ("gemma2_d256_w4096_cap50", dict(kvh=8, g=2, k=1, d=256, ps=PAGE_SIZE, pps=24, window=4096,
                                     cap=50.0, lens=[1, 4096, 4097, 6000])),
    ("gemma2_draft_k4", dict(kvh=8, g=2, k=4, d=256, ps=PAGE_SIZE, pps=24, window=4096, cap=50.0,
                             lens=[4, 260, 4100, 6000])),
    ("mha_d128", dict(kvh=32, g=1, k=1, d=128, ps=PAGE_SIZE, pps=8, window=None, cap=None,
                      lens=[1, 255, 257, 1088])),
    ("page16_d64_one_split", dict(kvh=4, g=8, k=1, d=64, ps=16, pps=4, window=None, cap=None,
                                  lens=[0, 1, 17, 64])),
)


def decode_poison_check(decode, gen, report, dtypes=("bfloat16", "float32")):
    """The tensor-core paged decode reads no K/V row that no query row may
    see: every pool row past each request's length, every page its table
    names past the live ones and every row before the first column any
    row's window reaches are filled with NaN; the output must equal the
    clean pool's, bit for bit (and be finite).  The fp8 cases do the same
    over fp8 pages, through the 8-bit form: those rows' payload bytes are
    0x7F (NaN in e4m3) and their scales NaN.  In float32 (over float32
    pages) every case runs the float32 form."""
    cases = tuple((name, dt, c) for dt in dtypes for name, c in DECODE_POISON_CASES) + tuple(
        (name, "bfloat16", {**c, "form": "fp8"}) for name, c in DECODE_POISON_CASES
        if "bfloat16" in dtypes and name in ("gemma2_d256_w4096_cap50", "page16_d64_one_split"))
    recs = []
    for name, dt, c in cases:
        lens, ps, pps, d, k = c["lens"], c["ps"], c["pps"], c["d"], c["k"]
        b, form = len(lens), c.get("form")
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        (kp, ks), (vp, vs), table = _paged_pool(gen, lens, pps, b * pps + 4, (c["kvh"], ps, d),
                                                DTYPES[dt], form)
        q = torch.randn((b, c["kvh"], c["g"] * k, d), generator=gen, device="cuda").to(DTYPES[dt])
        kw = dict(scale=d**-0.5, draft_k=k, window=c["window"], logit_softcap=c["cap"])
        clean = decode.paged_attention(q, kp, vp, lengths, table, **kw, **_page_scales(ks, vs))
        kn, vn = kp.clone(), vp.clone()
        sn = [None if x is None else x.clone() for x in (ks, vs)]
        w = c["window"]
        _poison_pool([x.view(torch.uint8) if form else x for x in (kn, vn)],
                     [x for x in sn if x is not None], table, lens,
                     lambda n: 0 if w is None else max(0, n - k - w + 1), ps,
                     0x7F if form else float("nan"))
        poisoned = decode.paged_attention(q, kn, vn, lengths, table, **kw, **_page_scales(*sn))
        torch.cuda.synchronize()
        equal = bool(torch.equal(poisoned, clean))
        finite = bool(torch.isfinite(poisoned).all())
        rec = {"check": _check_name(_kname("paged_decode", q, form is not None, page_size=ps),
                                    f"nan_poison/{name}", dt, form),
               "shape": f"B={b} KVH={c['kvh']} G={c['g']} k={k} d={d} ps={ps} pps={pps} "
                        f"window={w} cap={c['cap']}",
               "lengths": lens, "splits": list(decode.decode_splits(
                   b, c["kvh"], pps, ps, sms=decode._sm_count(q.device))),
               "bitwise_equal": equal, "finite": finite,
               "max_abs_err": err(poisoned.nan_to_num(), clean), "ok": equal and finite}
        emit(rec)
        report["checks"].append(rec)
        recs.append(rec)
        del kp, vp, ks, vs, kn, vn, sn, q, clean, poisoned
    torch.cuda.empty_cache()
    return recs


def split_edge_checks(decode, gen, report, dtypes=("bfloat16", "float32")):
    """paged_decode_tc against its plain version where its splits meet the
    rows' edges, in bf16 and over fp8 pages, and its float32 form over
    float32 pages (``dtypes``): at Gemma-2's draft layer (k =
    4, window 4096, softcap 50; B = 4, 24 pages a request) and Llama's MHA
    layer (k = 1), with lengths placed by the split length S (``decode_splits``
    on this card): S + 1 and 2 S + 2 (a split boundary among the last k
    columns, so the split past it holds, for the first draft rows, only
    columns past their causal limits: their running max there is the mask
    value and the merge must weight that partial by 0), 3 S + k + window - 2
    (row 0's window starts on the last column before a boundary, so the
    later rows see nothing before it) and the table's end."""
    cases = (("gemma2_draft_k4", dict(kvh=8, g=2, k=4, d=256, window=4096, cap=50.0)),
             ("llama_mha", dict(kvh=32, g=1, k=1, d=128, window=None, cap=None)))
    ps, pps, b = PAGE_SIZE, 24, 4
    recs = []
    for name, c in cases:
        k, w = c["k"], c["window"]
        n, per = decode.decode_splits(b, c["kvh"], pps, ps, sms=decode._sm_count(torch.device("cuda")))
        span, cap = per * decode.TC_DECODE_TILE, pps * ps
        lens = [span + 1, 2 * span + 2, 3 * span + k + (w or 0) - 2, cap]
        lens = [min(x, cap) for x in lens]
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        runs = [(dt, form) for dt in dtypes for form in ((None, "fp8") if dt == "bfloat16" else (None,))]
        for dt, form in runs:
            (kp, ks), (vp, vs), table = _paged_pool(gen, lens, pps, b * pps + 4, (c["kvh"], ps, c["d"]),
                                                    DTYPES[dt], form)
            q = torch.randn((b, c["kvh"], c["g"] * k, c["d"]), generator=gen, device="cuda")
            q = q.to(DTYPES[dt])
            kw = dict(scale=c["d"]**-0.5, draft_k=k, window=w, logit_softcap=c["cap"],
                      **_page_scales(ks, vs))
            o = decode.paged_attention(q, kp, vp, lengths, table, **kw)
            want = decode.paged_attention_plain(q, kp, vp, lengths, table, **kw)
            torch.cuda.synchronize()
            rec = _rec(_check_name(_kname("paged_decode", q, form is not None), f"split_edges/{name}",
                                   dt, form), o, want, dt, PAGED_TOL[dt],
                       lengths=lens, splits=[n, per], draft_k=k, window=w, softcap=c["cap"])
            emit(rec)
            report["checks"].append(rec)
            recs.append(rec)
            del kp, vp, ks, vs, q, o, want
    torch.cuda.empty_cache()
    return recs


# decode_f32_term_checks: head_dims of the lo3_term case and its context
# (few keys, so that one product's share of each score moves the output
# well past the tolerance).
F32_TERM_DIMS = (64, 128, 256)
F32_TERM_S = 32


def decode_f32_term_checks(decode, gen, report):
    """Paged decode's float32 form on inputs whose small terms move the
    output by more than PAGED_TOL["float32"] (1e-4), against its plain
    version, at scale 1, B = 2, 2 KV heads, 256-row pages:
    ``lo3_term`` (d = 64 / 128 / 256): ``probes.lo3_term_f32_qkv``'s keys and
    values as the pages of two requests of 32 and 25 columns, q its last
    row, so that each third-term product of S (x1 y3, x2 y2, x3 y1) moves the
    scores by 2^-9 to 2^-7 while every partial sum stays exact in float32
    (a form without one misses by 4e-4 to 1e-3); ``v3_term`` (d = 128): row
    (b, h) is 16 e_j and key c is 16 e_c, so each row attends one key, and
    its output is V's row j, 64 (1 + 1.5 2^-9 +/- 1.5 2^-18) per value,
    whose third bf16 term a form that drops it misses by 3.7e-4;
    ``p3_term`` (d = 64, G = 4, lengths 2): key 0 scores 0 against V's row 0
    = 0, key 1 scores ln u (u in (0.5, 0.95)) against V's row 1 = +/-512,
    so the output is +/-512 u / (1 + u), and p's third bf16 term (up to
    2^-17 of p) moves it by up to 1e-3, while the kernel's ex2 (2^-22 of p)
    moves it by 2e-5.  Returns the records."""
    from flashattention_tpu_torch.ops import probes

    def pm(*shape):
        return torch.where(torch.rand(shape, generator=gen, device="cuda") < 0.5, -1.0, 1.0)

    def pages(x, b, kvh):  # (B * KVH, S, d) rows as each request's pages, in table order
        s, d = x.shape[1:]
        pps = -(-s // PAGE_SIZE)
        x = torch.nn.functional.pad(x.reshape(b, kvh, s, d), (0, 0, 0, pps * PAGE_SIZE - s))
        return x.view(b, kvh, pps, PAGE_SIZE, d).transpose(1, 2).reshape(
            -1, kvh, PAGE_SIZE, d).contiguous()

    cases = []
    for d in F32_TERM_DIMS:
        b, kvh, s = 2, 2, F32_TERM_S
        q, k, v = probes.lo3_term_f32_qkv(b * kvh, s, d, generator=gen, device="cuda")
        q = q.view(b, kvh, s, d)[:, :, -1:].contiguous()
        cases.append((f"lo3_term/d{d}", q, pages(k, b, kvh), pages(v, b, kvh), [s, s - 7]))
    b, kvh, d = 2, 2, 128
    j = torch.randint(0, d, (b, kvh), generator=gen, device="cuda")
    q = 16 * torch.nn.functional.one_hot(j, d).float()[:, :, None].contiguous()
    k = (16 * torch.eye(d, device="cuda")).expand(b * kvh, d, d)
    v = 64 * pm(b * kvh, d, d) * (1 + 1.5 * 2.0**-9 + 1.5 * pm(b * kvh, d, d) * 2.0**-18)
    cases.append(("v3_term/d128", q, pages(k, b, kvh), pages(v, b, kvh), [d, d]))
    b, kvh, g, d = 16, 2, 4, 64
    u = 0.5 + 0.45 * torch.rand((b, kvh), generator=gen, device="cuda")
    k = torch.zeros((b, kvh, PAGE_SIZE, d), device="cuda")
    k[:, :, 1, 0] = torch.log(u)
    v = torch.zeros((b, kvh, PAGE_SIZE, d), device="cuda")
    v[:, :, 1] = 512 * pm(b, kvh, d)
    q = torch.zeros((b, kvh, g, d), device="cuda")
    q[..., 0] = 1
    cases.append(("p3_term/d64", q, k.contiguous(), v.contiguous(), [2] * b))
    recs = []
    for name, q, kp, vp, lens in cases:
        b = q.shape[0]
        table = torch.arange(kp.shape[0], dtype=torch.int32, device="cuda").view(b, -1).contiguous()
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        n = decode.paged_attention.launches_tc_f32
        got = decode.paged_attention(q, kp, vp, lengths, table, scale=1.0)
        launched = decode.paged_attention.launches_tc_f32 - n
        want = decode.paged_attention_plain(q, kp, vp, lengths, table, scale=1.0)
        torch.cuda.synchronize()
        rec = _rec(_check_name(_kname("paged_decode", q), name, "float32", None), got, want,
                   "float32", PAGED_TOL["float32"], lengths=lens,
                   shape=f"B={b} KVH={q.shape[1]} R={q.shape[2]} d={q.shape[3]} ps={kp.shape[2]}",
                   output_absmax=float(want.abs().max()), launches=launched)
        rec["ok"] = rec["ok"] and launched == 1
        emit(rec)
        report["checks"].append(rec)
        recs.append(rec)
    torch.cuda.empty_cache()
    return recs


def decode_serve_shape_timing(decode, benchit, gen, card, report):
    """Paged decode at serve_gemma2's profile decode shape: 4 requests of
    about 1540 tokens (1536-token prompts and their first new tokens) on
    Gemma-2's layer (8 KV heads, G = 2, d = 256, window 4096, softcap 50),
    the engine's table (24 pages of 256 rows), bf16 and fp8 pages and
    float32 q over float32 pages; the tensor-core form (the float32 one in
    float32) beside the scalar one, SDPA (in float32 for float32) and the
    bound: {"bf16" | "fp8" | "float32": the tensor-core form's timed
    check}."""
    from flashattention_tpu_torch.ops import flash

    ps, pps, kvh, g, d, w, cap = PAGE_SIZE, 24, 8, 2, 256, 4096, 50.0
    lens = [1537, 1539, 1541, 1543]
    b = len(lens)
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    out = {}
    for dt, form in (("bfloat16", None), ("bfloat16", "fp8"), ("float32", None)):
        (kp, ks), (vp, vs), table = _paged_pool(gen, lens, pps, b * pps + 4, (kvh, ps, d),
                                                DTYPES[dt], form)
        q = torch.randn((b, kvh, g, d), generator=gen, device="cuda").to(DTYPES[dt])
        kw = dict(scale=d**-0.5, window=w, logit_softcap=cap, **_page_scales(ks, vs))
        kernel = lambda: decode.paged_attention(q, kp, vp, lengths, table, **kw)  # noqa: E731
        plain = lambda: decode.paged_attention_plain(q, kp, vp, lengths, table, **kw)  # noqa: E731
        o, want = kernel(), plain()
        torch.cuda.synchronize()
        kname = _kname("paged_decode", q, form is not None)
        rec = _rec(_check_name(kname, "serve_profile_gemma2", dt, form), o, want,
                   dt, PAGED_TOL[dt], lengths=lens,
                   shape=f"B={b} KVH={kvh} G={g} d={d} ps={ps} pps={pps} window={w} cap={cap}")
        rec["kernel_ms"] = benchit.cuda_time_ms(kernel, flush_bytes=256 << 20)
        rec["plain_ms"] = benchit.cuda_time_ms(plain, flush_bytes=256 << 20)
        rec.update(_decode_library(benchit, q, _bf16(kp, ks), _bf16(vp, vs), lengths, table,
                                   kw["scale"], w))
        rec["library"] += _DEQUANT_NOTE if form else ""
        n_pages = sum(-(-n // ps) for n in lens)
        nbytes = (2 * q.numel() * q.element_size() + 2 * sum(lens) * kvh * _row_bytes(kp, d, form)
                  + 4 * (b + n_pages))
        rec.update(live_rows=sum(lens), **benchit.bound_ms(
            card, bytes_moved=nbytes, flops=4 * sum(lens) * kvh * g * d, dtype=dt))
        _decode_twin(flash, benchit, report, rec, kernel, plain, dt,
                     _tc_key(kname, "serve_profile_gemma2", form))
        emit(rec)
        report["checks"].append(rec)
        out[form or ("float32" if dt == "float32" else "bf16")] = rec
        del kp, vp, ks, vs, q, o, want
    torch.cuda.empty_cache()
    return out


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
    window as a boolean mask and no softcap; unquantized in float32 too,
    the float32 form in "bf16_3x" (flash_fwd_f32 at d = 256) beside its
    "float32" mode and the scalar kernel (``_f32_timed``)."""
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
            if dt == "float32" and name == TIMED_WINDOW_CASE and form is None:
                pos = torch.arange(s, device="cuda")
                mask = (pos[None] <= pos[:, None]) & (pos[None] > pos[:, None] - c["window"])
                kr, vr = (x.repeat_interleave(g, dim=1) for x in (k, v))
                twin, exact = _f32_timed(
                    flash, benchit, card, rec,
                    lambda mode=None: fa.attention(q, k, v, precision=mode, **kw),
                    lambda mode=None: flash.flash_attention_plain(
                        q3, k3, v3, q_seq_len=s, precision=mode, **kw).reshape(q.shape),
                    lambda: flash.flash_attention_plain(q3, k3, v3, q_seq_len=s, form="scalar",
                                                        **kw).reshape(q.shape),
                    d=d, pairs=b * kvh * g * _window_pairs(s, c["window"]),
                    nbytes=4 * (2 * q.numel() + 2 * k.numel()),
                    sdpa=lambda: torch.nn.functional.scaled_dot_product_attention(
                        q, kr, vr, attn_mask=mask, scale=kw["scale"]),
                    library=("scaled_dot_product_attention, float32, boolean causal+window mask, "
                             "K/V repeated to 16 heads untimed; no softcap (SDPA cannot "
                             "express it)"))
                kname = _kname("flash_fwd", q)
                report.setdefault("tc_timed", {})[f"{kname}/d256_window_softcap"] = rec
                report["tc_timed"]["flash_fwd_f32/d256_window_softcap/precision_float32"] = exact
                report.setdefault("float32_timed", {})["flash_fwd/d256_window_softcap"] = twin
                for r in (twin, exact):
                    emit(r)
                    report["checks"].append(r)
                del kr, vr, mask
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
    with ``form`` (int8 or fp8) over 8-bit pages.  In bf16 the tensor-core
    form runs; at Gemma-2's shape the scalar form is timed and checked
    beside it."""
    from flashattention_tpu_torch.ops import flash

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
            kname = _kname("paged_decode", q, form is not None)
            rec = _rec(_check_name(kname, name, dt, form), o, want, dt, PAGED_TOL[dt],
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
                if kname == "paged_decode_tc":
                    out["main"] = _decode_twin(flash, benchit, report, rec, kernel, plain, dt,
                                               _tc_key(kname, "d256_window_softcap", form))
            emit(rec)
            report["checks"].append(rec)
            del kp, vp, ks, vs, q, o, want
    torch.cuda.empty_cache()
    return out["main"]


def prefill_window_checks(decode, benchit, gen, card, report, form=None):
    """Paged prefill with the window: a 512-row chunk (the engine's) at
    contexts 4608-6144, page_size 256, 24 pages per request; the chunk's
    tiles start past the first 0-7 pages; with ``form`` (int8 or fp8) over
    8-bit pages.  In bf16 the tensor-core form runs, over float32 pools its
    float32 form; at Gemma-2's shape each is timed, the scalar form checked
    and timed beside it."""
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
            if name == TIMED_WINDOW_CASE and (dt == "bfloat16" or form is None):
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
                _prefill_bound(benchit, card, rec, kname, nbytes, flops, dt)
                if dt == "bfloat16":
                    out["main"] = rec
                if kname in ("paged_prefill_tc", "paged_prefill_tc_f32"):
                    twin = _scalar_twin(flash, benchit, rec, kernel, plain, dt, PREFILL_TOL[dt])
                    report.setdefault("tc_timed", {})[
                        _tc_key(kname, "d256_window_softcap", form)] = rec
                    if dt == "float32":  # the scalar kernel's own bound
                        twin.update(benchit.bound_ms(card, bytes_moved=nbytes, flops=flops,
                                                     dtype="float32"))
                        report.setdefault("float32_timed", {})[
                            "paged_prefill/d256_window_softcap"] = twin
                    else:
                        out["main"] = twin
                    emit(twin)
                    report["checks"].append(twin)
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
# cross a page and the window; the 8-bit forms run at every shape in bf16
# and at the Llama and Gemma-2 shapes in float32 q (taken in bf16: the
# tensor-core form's there too).  Timed in bfloat16 at those two: kernel, plain version, SDPA over
# the gathered context with an (R x S) mask, and k launches of the k = 1
# kernel on the same rows; the tensor-core form beside the scalar one.
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


def draft_checks(decode, benchit, gen, card, report, form=None, dtypes=("bfloat16", "float32")):
    """Paged decode's draft form against its plain version in ``dtypes``
    (with ``form`` int8 or fp8: over 8-bit pages, float32 at the timed
    shapes only): {case: timed check} for TIMED_DRAFT_CASES, the scalar
    form's in bfloat16 (the tensor-core form's in ``report["tc_timed"]``);
    in float32 unquantized, the float32 paths' form, the float32 form's
    timed check is in ``report["tc_timed"]`` and the scalar form's beside it
    in ``report["float32_timed"]["paged_decode_draft"]``."""
    from flashattention_tpu_torch.ops import flash

    out = {}
    ps, pps, pages, k = 256, 24, 128, DRAFT_K
    lens = DRAFT_LENGTHS
    b = len(lens)
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    for name, c in DRAFT_CASES:
        kvh, g, d, w = c["kvh"], c["g"], c["d"], c["window"]
        rows = g * k
        for dt in dtypes:
            if form is not None and dt == "float32" and name not in TIMED_DRAFT_CASES:
                continue
            (kp, ks), (vp, vs), table = _paged_pool(gen, lens, pps, pages, (kvh, ps, d), DTYPES[dt], form)
            kw = dict(scale=d**-0.5, draft_k=k, window=w, logit_softcap=c["cap"], **_page_scales(ks, vs))
            q = (c["q_mult"] * torch.randn((b, kvh, rows, d), generator=gen, device="cuda")).to(DTYPES[dt])
            o = decode.paged_attention(q, kp, vp, lengths, table, **kw)
            plain = lambda: decode.paged_attention_plain(q, kp, vp, lengths, table, **kw)  # noqa: E731
            want = plain()
            torch.cuda.synchronize()
            kname = _kname("paged_decode", q, form is not None)
            rec = _rec(_check_name(kname, f"draft_k{k}_{name}", dt, form), o, want, dt,
                       PAGED_TOL[dt], lengths=lens, draft_k=k, window=w, softcap=c["cap"],
                       shape=f"B={b} KVH={kvh} G={g} R={rows} d={d} ps={ps}")
            if name in TIMED_DRAFT_CASES and (dt == "bfloat16" or form is None):
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
                # The scalar form tiles the R rows by at most 8 and reads the
                # live K/V once per tile; the tensor-core forms once.
                tc = kname in ("paged_decode_tc", "paged_decode_tc_f32")
                tiles = 1 if tc else rows // next(t for t in (8, 4, 2, 1) if rows % t == 0)
                rec.update(live_rows=sum(live), row_tiles=tiles,
                           kv_bytes_as_read=tiles * kv_bytes)
                rec.update(benchit.bound_ms(card, bytes_moved=nbytes,
                                            flops=4 * d * kvh * g * sum(map(sum, seen)), dtype=dt))
                if not tc:
                    out[name] = rec
                else:
                    twin = _decode_twin(flash, benchit, report, rec, kernel, plain, dt,
                                        _tc_key(kname, f"draft_{name}", form))
                    twin.update(row_tiles=rows // next(t for t in (8, 4, 2, 1) if rows % t == 0),
                                k_times_k1_ms=None)
                    twin["kv_bytes_as_read"] = twin["row_tiles"] * kv_bytes
                    with flash.scalar_forms():  # k launches of the scalar k = 1 form
                        twin["k_times_k1_ms"] = benchit.cuda_time_ms(
                            lambda: [decode.paged_attention(qj, kp, vp, lj, table, **one_kw)
                                     for qj, lj in ones], warmup=1, iters=5, flush_bytes=256 << 20)
                    if dt == "float32":
                        report.setdefault("float32_timed", {}).setdefault(
                            "paged_decode_draft", {})[name] = twin
                    else:
                        out[name] = twin
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


def phase_crosscheck(fa, flash, decode, gen, report):
    """Kernels held against independent kernels on the card.  The naive
    kernel's path: the public ``flash_attention_naive`` and ``attention``
    (the flash kernel's tensor-core form) on the same bfloat16 inputs, B*H
    = 128, S = 1024, causal; each launches once and the two agree.  And
    chunked prefill over float32 pools at Gemma-2's serving shape (d = 256,
    G = 2, page 256, chunk 512, window 4096, softcap 50, contexts past the
    window): its float32 form against the scalar kernel's exact float32
    (``ops.flash.scalar_forms``), the kernel it replaced on the serving
    paths, within PREFILL_TOL; each launches once."""
    q, k, v = (
        torch.randn((128, 1024, 128), generator=gen, device="cuda").to(torch.bfloat16)
        for _ in range(3)
    )
    fwd, pre = flash.flash_attention, decode.paged_prefill_attention_batched
    for fn, attr in ((flash.flash_attention_naive, "launches"), (fwd, "launches"),
                     (fwd, "launches_tc"), (pre, "launches"), (pre, "launches_tc_f32")):
        setattr(fn, attr, 0)
    o_naive = fa.flash_attention_naive(q, k, v, causal=True, scale=128**-0.5)
    o_flash = fa.attention(q, k, v, causal=True, scale=128**-0.5)
    ctxs, kvh, g, d, chunk = [4608, 5633], 8, 2, 256, 512
    ctx = torch.tensor(ctxs, dtype=torch.int32, device="cuda")
    (kp, _), (vp, _), table = _paged_pool(gen, ctxs, 24, 52, (kvh, PAGE_SIZE, d), torch.float32)
    qp = torch.randn((len(ctxs), kvh, g * chunk, d), generator=gen, device="cuda")
    kw = dict(chunk=chunk, seg=chunk, scale=d**-0.5, window=4096, logit_softcap=50.0)
    o_f32 = decode.paged_prefill_attention_batched(qp, kp, vp, table, ctx, **kw)
    with flash.scalar_forms():
        o_scalar = decode.paged_prefill_attention_batched(qp, kp, vp, table, ctx, **kw)
    torch.cuda.synchronize()
    launches = {"flash_naive": flash.flash_attention_naive.launches,
                "flash_fwd": fwd.launches, "flash_fwd_tc": fwd.launches_tc,
                "paged_prefill": pre.launches, "paged_prefill_tc_f32": pre.launches_tc_f32}
    e, e32 = err(o_naive, o_flash), err(o_f32, o_scalar)
    rec = {"phase": "crosscheck", "shape": "BH=128 S=1024 d=128 causal bf16",
           "max_abs_err": e, "tol": CROSS_TOL,
           "paged_prefill_f32": {
               "shape": f"B={len(ctxs)} KVH={kvh} G={g} d={d} ps={PAGE_SIZE} chunk={chunk} "
                        "window=4096 cap=50 float32", "ctx_lens": ctxs,
               "max_abs_err": e32, "tol": PREFILL_TOL["float32"]},
           "launches": launches,
           "ok": e <= CROSS_TOL and e32 <= PREFILL_TOL["float32"] and launches == {
               "flash_naive": 1, "flash_fwd": 1, "flash_fwd_tc": 1, "paged_prefill": 2,
               "paged_prefill_tc_f32": 1}}
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
    with dropout and with a block mask, ``flash_fwd_tc``, ``flash_bwd_tc``,
    ``paged_prefill_tc`` and ``paged_decode_tc`` the tensor-core forms',
    which ``<kernel>`` counts too (``<tc form>_block_mask`` the block-mask
    launches of the forward's and the pair's, which ``<kernel>_block_mask``
    counts too), ``paged_decode_tc_draft`` the latter's
    draft launches (``paged_decode_draft`` counts them too), and
    ``flash_fwd_tc_quant``, ``paged_prefill_tc_quant`` and
    ``paged_decode_tc_quant`` their 8-bit forms', which ``<kernel>_quant``
    and the tensor-core counter count too (``flash_fwd_tc_quant_f32q``
    those of its launches over float32 q, taken in bf16);
    ``flash_fwd_tc_f32`` the forward's float32 form's (``flash_fwd`` counts
    them too),
    ``flash_fwd_tc_f32_bf16`` its one-pass "bf16" mode's among them and
    ``flash_fwd_f32`` those of csrc/flash_fwd_f32.cuh's kernel ("float32",
    and "bf16_3x" at d = 256), ``flash_fwd_tc_f32_extra`` those of its
    dropout form; ``paged_prefill_tc_f32`` chunked prefill's float32 form's
    (``paged_prefill`` counts them too); ``flash_bwd_tc_f32`` the fused
    backward's float32 form's (``flash_bwd`` counts them too), with dropout
    among them ``flash_bwd_tc_f32_dropout``, and ``flash_bwd_dq_tc_f32`` /
    ``flash_bwd_dkv_tc_f32`` (``..._dropout``) the pair's (``flash_bwd_dq`` /
    ``flash_bwd_dkv`` count them too); ``paged_decode_tc_f32`` paged
    decode's float32 form's (``paged_decode`` counts them too) and
    ``paged_decode_tc_f32_draft`` its draft launches (``paged_decode_draft``
    counts them too)."""
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
    out["paged_decode_tc_draft"] = (decode.paged_attention, "launches_tc_draft")
    out.update({f"{k}_dropout": (fns[k], "launches_dropout") for k in EXTRA_KERNELS})
    out.update({f"{k}_block_mask": (fns[k], "launches_block_mask") for k in EXTRA_KERNELS
                if k != "flash_bwd"})
    out.update({tc: (fns[k], "launches_tc") for k, tc in TC_KERNELS.items()})
    out.update({f"{TC_KERNELS[k]}_dropout": (fns[k], "launches_tc_dropout") for k in PAIR})
    out.update({f"{TC_KERNELS[k]}_block_mask": (fns[k], "launches_tc_block_mask")
                for k in ("flash_fwd", *PAIR)})
    out.update({tc: (fns[k], "launches_tc_quantized") for k, tc in TC_QUANT_KERNELS.items()})
    out["flash_fwd_tc_quant_f32q"] = (flash.flash_attention, "launches_tc_quantized_f32q")
    out["flash_fwd_tc_f32"] = (flash.flash_attention, "launches_tc_f32")
    out["flash_fwd_tc_f32_bf16"] = (flash.flash_attention, "launches_tc_f32_bf16")
    out["flash_fwd_f32"] = (flash.flash_attention, "launches_tc_f32_split")
    out["flash_fwd_tc_f32_extra"] = (flash.flash_attention, "launches_tc_f32_dropout")
    out["paged_prefill_tc_f32"] = (decode.paged_prefill_attention_batched, "launches_tc_f32")
    out["paged_decode_tc_f32"] = (decode.paged_attention, "launches_tc_f32")
    out["paged_decode_tc_f32_draft"] = (decode.paged_attention, "launches_tc_f32_draft")
    out["flash_bwd_tc_f32"] = (backward.fused_bwd_kernel, "launches_tc_f32")
    out["flash_bwd_tc_f32_dropout"] = (backward.fused_bwd_kernel, "launches_tc_f32_dropout")
    for k, f32 in PAIR_F32.items():
        out[f32] = (fns[k], "launches_tc_f32")
        out[f"{f32}_dropout"] = (fns[k], "launches_tc_f32_dropout")
    return out


def _tc_expect(want, cfg, page_size=PAGE_SIZE, cache_dtype=None):
    """``want`` with the tensor-core forms' expected launches: every
    flash_fwd launch of a bf16 model at their head_dims (the 8-bit ones,
    none with dropout or a block mask on these paths, in its 8-bit form
    too), every fused backward launch at theirs, every launch of the
    two-pass pair at theirs (the block-mask ones of both also in their
    own count), and every paged prefill and paged decode launch of a bf16
    model on pages of
    ``page_size`` rows (on 8-bit pages in their 8-bit forms too; paged
    decode's draft launches at k = SPEC_K in the draft form's count too);
    every flash_fwd launch of a float32 model at the float32 form's
    head_dims but the block-mask, dropout and 8-bit ones, in the default
    "bf16_3x" mode (at d = 256 csrc/flash_fwd_f32.cuh's kernel's; the
    dropout ones too at d = 64 / 128, in its dropout form's count too),
    every fused backward launch of a float32 model at d = 64 / 128 / 256 in
    its float32 form (the dropout ones in that form's dropout count too), and
    every paged prefill launch of a float32 model over float32 pages in
    chunked prefill's float32 form, and every paged decode launch of one
    over float32 pages in paged decode's float32 form (the draft launches
    at k = SPEC_K in its draft count too).  A float32 model's paged launches over
    a ``cache_dtype`` that is not float32 take q in bf16, so their forms are
    the bf16 calls'."""
    from flashattention_tpu_torch.ops import flash

    dt = DTYPES[cfg.dtype]
    pdt = torch.bfloat16 if cache_dtype not in (None, "float32") else dt  # the paged kernels' q
    if flash.kernel_form("flash_fwd", dt, cfg.head_dim) == "tc":
        want["flash_fwd_tc"] = want["flash_fwd"]
        want["flash_fwd_tc_quant"] = want.get("flash_fwd_quant", 0)
        want["flash_fwd_tc_block_mask"] = want.get("flash_fwd_block_mask", 0)
    if flash.kernel_form("flash_fwd", dt, cfg.head_dim) == "tc_f32":
        f32_dropout = flash.kernel_form("flash_fwd", dt, cfg.head_dim, dropout=True) == "tc_f32"
        want["flash_fwd_tc_f32"] = want["flash_fwd"] - sum(
            want.get(f"flash_fwd_{x}", 0) for x in ("block_mask", "dropout", "quant"))
        if flash.f32_split(cfg.head_dim, "bf16_3x"):
            want["flash_fwd_f32"] = want["flash_fwd_tc_f32"]
        if f32_dropout:
            want["flash_fwd_tc_f32_extra"] = want.get("flash_fwd_dropout", 0)
            want["flash_fwd_tc_f32"] += want["flash_fwd_tc_f32_extra"]
    if flash.kernel_form("flash_bwd", dt, cfg.head_dim) == "tc":
        want["flash_bwd_tc"] = want["flash_bwd"]
    if flash.kernel_form("flash_bwd", dt, cfg.head_dim) == "tc_f32":
        want["flash_bwd_tc_f32"] = want["flash_bwd"]
        want["flash_bwd_tc_f32_dropout"] = want.get("flash_bwd_dropout", 0)
    for k in PAIR:  # the two-pass pair's
        if flash.kernel_form(k, dt, cfg.head_dim) == "tc":
            want[f"{k}_tc"] = want.get(k, 0)
            want[f"{k}_tc_dropout"] = want.get(f"{k}_dropout", 0)
            want[f"{k}_tc_block_mask"] = want.get(f"{k}_block_mask", 0)
    if flash.kernel_form("paged_prefill", pdt, cfg.head_dim, page_size=page_size) == "tc":
        want["paged_prefill_tc"] = want.get("paged_prefill", 0)
        want["paged_prefill_tc_quant"] = want.get("paged_prefill_quant", 0)
    if flash.kernel_form("paged_prefill", pdt, cfg.head_dim, page_size=page_size) == "tc_f32":
        want["paged_prefill_tc_f32"] = want.get("paged_prefill", 0)
    if flash.kernel_form("paged_decode", pdt, cfg.head_dim, page_size=page_size,
                         rows=cfg.group_size) == "tc":
        want["paged_decode_tc"] = want.get("paged_decode", 0)
        want["paged_decode_tc_quant"] = want.get("paged_decode_quant", 0)
        if flash.kernel_form("paged_decode", pdt, cfg.head_dim, page_size=page_size,
                             rows=cfg.group_size * SPEC_K) == "tc":
            want["paged_decode_tc_draft"] = want.get("paged_decode_draft", 0)
    if flash.kernel_form("paged_decode", pdt, cfg.head_dim, page_size=page_size,
                         rows=cfg.group_size) == "tc_f32":
        want["paged_decode_tc_f32"] = want.get("paged_decode", 0)
        if flash.kernel_form("paged_decode", pdt, cfg.head_dim, page_size=page_size,
                             rows=cfg.group_size * SPEC_K) == "tc_f32":
            want["paged_decode_tc_f32_draft"] = want.get("paged_decode_draft", 0)
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
                     {"prompt_lens": lens.tolist(), "new_tokens": budget,
                      "native": _engine_native(eng)})
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


def _finite_engine(engine_mod):
    """The engine with every logits row it samples from checked finite on
    the device (``eng.finite``, read once at the end: no host sync)."""

    class Checked(engine_mod.Engine):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.finite = torch.ones((), dtype=torch.bool, device=self.device)

        def _sample_rows(self, reqs, logits):
            self.finite &= torch.isfinite(logits).all()
            return super()._sample_rows(reqs, logits)

    return Checked


def _chunked_prompts(args, vocab):
    """serve_chunked's prompts from ``--seed``, and the length of the prefix
    the first four share: a donor, three prompts that share its first 1024
    tokens (prefix hits), three long unique prompts and one short one."""
    rng = np.random.default_rng(args.seed + 10)
    tok = lambda n: rng.integers(0, vocab, size=int(n)).tolist()  # noqa: E731
    shared = 1024
    prefix = tok(shared)
    prompts = [prefix + tok(100)]  # the donor
    prompts += [prefix + tok(n) for n in rng.integers(64, 401, size=3)]  # prefix hits
    prompts += [tok(n) for n in rng.integers(513, 2049, size=3)]  # long, unique
    prompts += [tok(rng.integers(64, 513))]  # short: whole-prompt on flash_fwd
    return prompts, shared


def phase_serve_chunked(args, cfg, params, engine_mod, kvcache, counters, report, *,
                        cache_dtype="bfloat16", phase="serve_chunked", extra=None,
                        model="llama7b_attention"):
    """The default configuration's path: chunked prefill and prefix hits.
    With ``cache_dtype`` int8 or fp8, an 8-bit KV cache (the serve_int8
    phase, on int8 weights).  Every logits row sampled must be finite."""
    ccfg = kvcache.CacheConfig(
        num_layers=cfg.num_layers, num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim, page_size=256, num_pages=64, dtype=cache_dtype,
    )
    eng = _finite_engine(engine_mod)(
        params, cfg, ccfg,
        engine_mod.EngineConfig(max_batch=4, pages_per_seq=12, prefill_chunk=512),
    )
    budget = 32
    prompts, shared = _chunked_prompts(args, cfg.vocab_size)
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
    finite = bool(eng.finite)
    rec = _serve_rec(phase, cfg, st, full, wall, launches, want, {
        "prompt_lens": [len(p) for p in prompts], "shared_prefix": shared,
        "new_tokens": budget, "prefill_tokens_expected": want_prefill,
        "cache_dtype": cache_dtype, "cache_pages": ccfg.num_pages, "cache_gb": _cache_gb(eng),
        "logits_finite": finite, "native": _engine_native(eng), **(extra or {}),
    }, model)
    rec["ok"] = (
        full and finite and launches == want and quant_ok
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
                "tokens": [eng.requests[i].output for i in ids], "native": _engine_native(eng),
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
           "tokens_equal": same, "sampling": SAMPLED, "native": _natives(*runs.values()),
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
    """One counted run: per token (``drafts`` None) or run_speculative;
    every paged decode launch in a tensor-core form (the float32 form over
    a float32 cache), none scalar."""
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
    _tc_expect(want, cfg, cache_dtype=eng.cache.config.dtype)
    rec = {"wall_s": wall, "stats": st, "launches": launches, "launches_expected": want,
           "tokens": {i: eng.requests[i].output for i in ids}, "native": _engine_native(eng)}
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
    rec["scalar_paged_decode_launches"] = (launches["paged_decode"] - launches["paged_decode_tc"]
                                           - launches["paged_decode_tc_f32"])
    rec["ok"] = (_finished(eng, ids, budget) and launches == want
                 and st["free_pages"] == eng.cache.config.num_pages
                 and (drafts is None or launches["paged_decode_draft"] > 0)
                 and rec["scalar_paged_decode_launches"] == 0)
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
    the draft form must launch layers x verify steps; every paged decode
    launch over the float32 cache runs the float32 form
    (paged_decode_tc_f32), none the scalar kernel."""
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
           "native": _natives(*(r for c in cells.values() for r in c.values())),
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
    runs with the window and softcap at d = 256; tokens must equal.  Every
    chunk runs chunked prefill's float32 form (paged_prefill_tc_f32) and
    every decode and verify step paged decode's (paged_decode_tc_f32), none
    the scalar kernels."""
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
    scalar_prefill = {run: r["launches"]["paged_prefill"] - r["launches"]["paged_prefill_tc"]
                      - r["launches"]["paged_prefill_tc_f32"] for run, r in cell.items()}
    rec = {"phase": "serve_speculative_gemma2", "model": GEMMA_MODEL, "dtype": "float32",
           "layers": cfg.num_layers, "k": SPEC_K, "prompt_lens": [len(p) for p in prompts],
           "new_tokens": budget, **cell, "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
           "scalar_paged_prefill_launches": scalar_prefill, "native": _natives(*cell.values()),
           "ok": all(r["ok"] and r["launches"]["paged_prefill_tc_f32"] > 0
                     and r["launches"]["paged_decode_tc_f32"] > 0 for r in cell.values())
           and not any(scalar_prefill.values())}
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
        "cache_pages": ccfg.num_pages, "cache_gb": _cache_gb(eng), "native": _engine_native(eng),
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
        "cache_gb": _cache_gb(eng), "native": _engine_native(eng),
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


# ── serve_sharded: DP x TP decode serving on torch.distributed ──────────────

SERVE_PHASES = ("serve", "serve_chunked", "serve_int8", "serve_gemma2", "serve_gemma2_whole",
                "serve_gemma2_fp8", "serve_mixtral_int8", "serve_multistep", "serve_speculative",
                "serve_speculative_gemma2", "serve_lora_merged", "serve_lora_merged_int8",
                "serve_sharded")
SHARDED_DP, SHARDED_TP = 2, 2
SHARDED_LAYERS = 8  # llama7b_attention's full width, its 32 layers cut to 8
SHARDED_STEPS = 16
SHARDED_TIMEOUT_S = 300  # the ranks' process group, and their join
SHARDED_LOGITS_TOL = 1e-3  # float32 logits (tests/test_parallel.py:208)
SHARDED_POOL_TOL = 1e-5  # float32 pool rows (tests/test_parallel.py:209)
SHARDED_BF16_RTOL = 2e-2  # bf16 logits, of their largest magnitude
SHARDED_INT8_RTOL = 2e-2  # over an int8 cache, of the logits' magnitude (tests/test_quant.py)
# run -> (model dtype, cache dtype, the counter of its paged decode form)
SHARDED_RUNS = {"float32": ("float32", "float32", "paged_decode_tc_f32"),
                "bfloat16": ("bfloat16", "bfloat16", "paged_decode_tc"),
                "int8_cache": ("bfloat16", "int8", "paged_decode_tc_quant")}
SHARDED_MODEL = "llama7b_attention: d_model 4096, 32 q / 32 KV heads, d=128, 8 of 32 layers"
_SHARDED_COUNTERS = {"paged_decode": "launches", "paged_decode_tc": "launches_tc",
                     "paged_decode_tc_f32": "launches_tc_f32",
                     "paged_decode_quant": "launches_quantized",
                     "paged_decode_tc_quant": "launches_tc_quantized"}


def _sharded_cfg(transformer, dtype):
    return dataclasses.replace(transformer.ModelConfig.llama7b_attention(),
                               num_layers=SHARDED_LAYERS, dtype=dtype)


def _sharded_params(transformer, common, seed, tp_index, tp_size):
    """TP rank ``tp_index``'s float32 parameters of serve_sharded's model
    (``tp_size=1``: the whole model), drawn on the card a layer at a time
    (layer i from ``seed + 1 + i``, the rest from ``seed``) and cut to the
    rank's shard at once, so that no rank holds the whole model."""
    cfg = _sharded_cfg(transformer, "float32")
    none, one = (dataclasses.replace(cfg, num_layers=n) for n in (0, 1))
    top = transformer.init_params(seed, none)
    out = common.shard_params(top, none, tp_index, tp_size)
    for i in range(cfg.num_layers):
        layer = transformer.init_params(seed + 1 + i, one)["layers"]
        out["layers"] += common.shard_params({**top, "layers": layer}, one, tp_index,
                                             tp_size)["layers"]
    return out


def _cast_tree(params, dtype):
    return {k: ([{n: w.to(dtype) for n, w in lay.items()} for lay in v] if isinstance(v, list)
                else v.to(dtype)) for k, v in params.items()}


def _decode_rows(pools, wp, ws):
    """The rows a step wrote at pages ``wp``, slots ``ws``, of each pool
    ``(L, P, KVH, ps[, d])``: ``(B, L, KVH[, d])``, on the host."""
    return [p[:, wp, :, ws].cpu() for p in pools]


def _sharded_steps(step, params, pools, table, lens, first, forced, ps):
    """SHARDED_STEPS decode steps of one batch from ``first``: step t at
    positions ``lens + t``, writing page ``table[b, pos // ps]``, slot ``pos
    % ps``, fed its own greedy tokens (``forced`` None) or ``forced[t]``.
    Returns logits (steps, B, V) and greedy tokens (steps, B) on the host,
    each step's ms (a device sync on each side) and the rows each step
    wrote (per pool, ``(steps, B, L, KVH[, d])``)."""
    dev = table.device
    lens = torch.as_tensor(lens, dtype=torch.int32, device=dev)
    rows = torch.arange(len(lens), device=dev)
    tokens = first.to(dev)
    logits, greedy, ms, written = [], [], [], []
    for t in range(SHARDED_STEPS):
        pos = lens + t
        wp, ws = table[rows, (pos // ps).long()], pos % ps
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(params, tokens, pos, *pools[:2], pos + 1, table, wp, ws, *pools[2:])
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        nxt = out.argmax(-1).int()
        logits.append(out.float().cpu())
        greedy.append(nxt.cpu())
        written.append(_decode_rows(pools, wp.long(), ws.long()))
        tokens = nxt if forced is None else forced[t].to(dev)
    return (torch.stack(logits), torch.stack(greedy), ms,
            [torch.stack([w[i] for w in written]) for i in range(len(pools))])


def _sharded_rank(rank, store, work, seed):
    """One rank of serve_sharded: joins the gloo group over ``store``,
    draws its TP shard of the model, and runs each of SHARDED_RUNS on the
    pool slice, page table and tokens the parent wrote into ``work``; its
    results go to ``work/out_rank<rank>.pt``, a failure's traceback to
    ``work/err_rank<rank>.txt``.  Imports the port only (a spawned child
    re-imports this script, whose ``main`` it does not run)."""
    import datetime
    import traceback

    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        from flashattention_tpu_torch.models import transformer
        from flashattention_tpu_torch.models.train import common
        from flashattention_tpu_torch.ops import decode
        from flashattention_tpu_torch.parallel import serving

        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=SHARDED_DP * SHARDED_TP,
                                timeout=datetime.timedelta(seconds=SHARDED_TIMEOUT_S))
        _, tp_index, group = serving.tp_groups(SHARDED_DP, SHARDED_TP)
        t0 = time.perf_counter()
        params = _sharded_params(transformer, common, seed, tp_index, SHARDED_TP)
        out = {"init_s": time.perf_counter() - t0,
               "weights_gb": sum(t.numel() * t.element_size() for t in common.leaves(params)) / 1e9}
        fn = decode.paged_attention
        for run, (mdt, _, _) in SHARDED_RUNS.items():
            if params["embed"].dtype != DTYPES[mdt]:
                params = _cast_tree(params, DTYPES[mdt])
            cfg = _sharded_cfg(transformer, mdt)
            inp = torch.load(os.path.join(work, f"{run}_rank{rank}.pt"), weights_only=True)
            pools = [inp[k].cuda() for k in ("k_pages", "v_pages", "k_scales", "v_scales")
                     if k in inp]
            before = [p.clone() for p in pools]
            table = inp["table"].cuda()
            step = serving.make_sharded_decode_step(cfg, tp_group=group,
                                                    quantized=len(pools) == 4)
            for attr in _SHARDED_COUNTERS.values():
                setattr(fn, attr, 0)
            logits, greedy, ms, written = _sharded_steps(
                step, params, pools, table, inp["lengths"], inp["first"], inp.get("forced"),
                PAGE_SIZE)
            launches = {k: getattr(fn, attr) for k, attr in _SHARDED_COUNTERS.items()}
            # Every pool row but those the steps wrote is the history the
            # parent wrote, bit for bit.
            lens = inp["lengths"].long().cuda()
            rows = torch.arange(len(lens), device="cuda")
            for t in range(SHARDED_STEPS):
                wp, ws = table[rows, (lens + t) // PAGE_SIZE].long(), (lens + t) % PAGE_SIZE
                for b, p in zip(before, pools):
                    b[:, wp, :, ws] = p[:, wp, :, ws]
            unchanged = all(torch.equal(b, p) for b, p in zip(before, pools))
            x = torch.randn(len(lens), 1, cfg.d_model, device="cuda").to(DTYPES[mdt])
            for _ in range(5):
                dist.all_reduce(x, group=group)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(50):
                dist.all_reduce(x, group=group)
            torch.cuda.synchronize()
            out[run] = {"logits": logits, "greedy": greedy, "step_ms": ms, "written": written,
                        "unchanged": unchanged, "launches": launches,
                        "allreduce_ms": 1e3 * (time.perf_counter() - t0) / 50,
                        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30}
            del pools, before
        torch.save(out, os.path.join(work, f"out_rank{rank}.pt"))
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(work, f"err_rank{rank}.txt"), "w") as fh:
            fh.write(traceback.format_exc())
        raise


def _spawn_sharded(work, seed):
    """Start the SHARDED_DP x SHARDED_TP ranks (``spawn``, all on card 0)
    and wait for them: their results, or the failures (a rank that exits
    non-zero, or that is still alive SHARDED_TIMEOUT_S + 60 s after the
    start, killed then with the rest)."""
    ctx = torch.multiprocessing.get_context("spawn")
    store = os.path.join(work, "store")
    procs = [ctx.Process(target=_sharded_rank, args=(r, store, work, seed))
             for r in range(SHARDED_DP * SHARDED_TP)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + SHARDED_TIMEOUT_S + 60
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    failed = {}
    for r, p in enumerate(procs):
        if p.exitcode != 0:
            path = os.path.join(work, f"err_rank{r}.txt")
            failed[r] = (open(path).read()[-4000:] if os.path.exists(path)
                         else f"exit code {p.exitcode}")
    if hung or failed:
        return None, {"hung": hung, "failed": failed}
    return [torch.load(os.path.join(work, f"out_rank{r}.pt"), weights_only=True)
            for r in range(len(procs))], None


def _engine_native(*engines):
    """Whether the engines' schedulers and page allocators ran on the C++
    runtime core (``runtime/native.py``)."""
    return {"scheduler": all(e.scheduler.native for e in engines),
            "allocator": all(e.cache.allocator.native for e in engines)}


def _natives(*recs):
    """The native flags of several runs' records, all of which must hold."""
    return {k: all(r["native"][k] for r in recs) for k in ("scheduler", "allocator")}


def _sharded_reference(transformer, kvcache, native, cfg, params, prompts, first, rows,
                       cache_dtype, work, run):
    """One run's unsharded side.  Each DP slice is a replica of its own (a
    paged cache of ``p_local`` pages and an FCFS scheduler, both on the C++
    runtime core) that admits its 4 requests, appends their history rows
    and reserves their SHARDED_STEPS slots.  The unsharded ``decode_step``
    then decodes all 8 requests greedily over a copy of the replicas' pools
    side by side (global page ids), and each rank's slice of its replica's
    pools (its TP heads), page table (local ids), lengths and first tokens
    go to ``work`` (in bf16 runs with the reference's tokens, which the
    rank is fed).  Returns the reference's logits, greedy tokens, step ms
    and written rows, and the replicas' native flags and books."""
    ps, n = PAGE_SIZE, len(prompts)
    per = n // SHARDED_DP
    need = [-(-(len(p) + SHARDED_STEPS) // ps) for p in prompts]
    p_local = max(sum(need[i * per:(i + 1) * per]) for i in range(SHARDED_DP))
    pps = max(need)
    kvh = cfg.num_kv_heads // SHARDED_TP
    names = ("k_pages", "v_pages", "k_scales", "v_scales")
    replicas, admitted = [], []
    for i in range(SHARDED_DP):
        ids = list(range(i * per, (i + 1) * per))
        cache = kvcache.PagedKVCache(kvcache.CacheConfig(
            num_layers=cfg.num_layers, num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
            page_size=ps, num_pages=p_local, dtype=cache_dtype))
        sched = native.Scheduler(per, ps, reserve_worst_case=True)
        for r in ids:
            sched.add_request(r, len(prompts[r]), SHARDED_STEPS)
        admitted.append(sched.admit(cache.num_free_pages()))
        for r in admitted[-1]:
            cache.append(r, rows[0][r], rows[1][r])
            for _ in range(SHARDED_STEPS):
                cache.reserve_slot(r)
        replicas.append((cache, sched, cache.batch_view(ids, pps)[1]))
    pools = [torch.cat([getattr(c, k) for c, _, _ in replicas], 1) for k in names
             if getattr(replicas[0][0], k) is not None]
    table = torch.cat([t + i * p_local for i, (_, _, t) in enumerate(replicas)])

    def step(*a):
        return transformer.decode_step(*a[:9], cfg, *a[9:])

    logits, greedy, ms, written = _sharded_steps(
        step, params, pools, table, [len(p) for p in prompts], first, None, ps)
    del pools
    for i, (cache, _, local) in enumerate(replicas):
        ids = slice(i * per, (i + 1) * per)
        for j in range(SHARDED_TP):
            torch.save({
                **{k: getattr(cache, k)[:, :, j * kvh:(j + 1) * kvh].contiguous().cpu()
                   for k in names if getattr(cache, k) is not None},
                "table": local.cpu(), "first": first[ids].cpu(),
                "lengths": torch.tensor([len(p) for p in prompts[ids]], dtype=torch.int32),
                **({} if run == "float32" else {"forced": greedy[:, ids].clone()}),
            }, os.path.join(work, f"{run}_rank{i * SHARDED_TP + j}.pt"))
    flags = {"scheduler": all(s.native for _, s, _ in replicas),
             "allocator": all(c.allocator.native for c, _, _ in replicas)}
    for (cache, sched, _), ids in zip(replicas, admitted):
        for r in ids:
            sched.finish(r)
            cache.free_sequence(r)
    books = {"admitted": admitted, "p_local": p_local, "pages_per_seq": pps,
             "pages_freed": all(c.num_free_pages() == p_local and s.num_running() == 0
                                for c, s, _ in replicas)}
    return {"logits": logits, "greedy": greedy, "step_ms": ms, "written": written,
            "native": flags, "books": books}


def _sharded_rank_checks(run, ref, results, cache_dtype, form):
    """Each rank's run of serve_sharded against the unsharded reference's
    requests and heads; TP peers against each other."""
    per = ref["logits"].shape[1] // SHARDED_DP
    want_n = SHARDED_LAYERS * SHARDED_STEPS
    out = []
    for rank, res in enumerate(results):
        got = res[run]
        i, j = divmod(rank, SHARDED_TP)
        kvh = got["written"][0].shape[3]
        req, heads = slice(i * per, (i + 1) * per), slice(j * kvh, (j + 1) * kvh)
        want = ref["logits"][:, req]
        scale = float(want.abs().max())
        tol = {"float32": SHARDED_LOGITS_TOL, "bfloat16": SHARDED_BF16_RTOL * scale}.get(
            run, SHARDED_INT8_RTOL * max(1.0, scale))
        rows = [w[:, req, :, heads] for w in ref["written"]]
        n = got["launches"]
        scalar = n["paged_decode"] - n["paged_decode_tc"] - n["paged_decode_tc_f32"]
        quant = want_n if cache_dtype == "int8" else 0
        c = {"rank": rank, "dp": i, "tp": j, "logits_max_abs_err": err(got["logits"], want),
             "logits_max_abs": scale, "logits_tol": tol,
             "greedy_equal_steps": int((got["greedy"] == ref["greedy"][:, req]).all(1).sum()),
             "unchanged_rows_bitwise": got["unchanged"], "launches": n,
             "scalar_paged_decode_launches": scalar,
             "step_ms": got["step_ms"], "ms_per_step": float(np.mean(got["step_ms"][1:])),
             "allreduce_ms": got["allreduce_ms"], "peak_mem_gb": got["peak_mem_gb"]}
        if cache_dtype == "int8":
            c["written_int8_steps"] = [_pool_steps(g, w) for g, w in zip(got["written"][:2], rows)]
            deq = [g.float() * s[..., None] for g, s in zip(got["written"][:2], got["written"][2:])]
            c["written_dequant_max_abs_err"] = max(
                err(d, w.float() * s[..., None]) for d, w, s in zip(deq, rows[:2], rows[2:]))
        else:
            c["written_max_abs_err"] = max(err(g, w) for g, w in zip(got["written"], rows))
        c["ok"] = (c["logits_max_abs_err"] <= tol and got["unchanged"] and scalar == 0
                   and n["paged_decode"] == want_n and n[form] == want_n
                   and n["paged_decode_quant"] == n["paged_decode_tc_quant"] == quant)
        if run == "float32":
            c["ok"] = (c["ok"] and c["greedy_equal_steps"] == SHARDED_STEPS
                       and c["written_max_abs_err"] <= SHARDED_POOL_TOL)
        out.append(c)
    peers = [bool(torch.equal(results[i * SHARDED_TP][run]["logits"],
                              results[i * SHARDED_TP + j][run]["logits"]))
             for i in range(SHARDED_DP) for j in range(1, SHARDED_TP)]
    return out, peers


def phase_serve_sharded(args, transformer, train, kvcache, counters, report):
    """DP x TP sharded decode serving on ``torch.distributed`` (the port's
    ``parallel/serving.py``): dp = 2 x tp = 2 rank processes (``spawn``) on
    this one card, all on cuda:0, in a gloo group over a FileStore (NCCL
    takes no two ranks on one GPU; gloo stages CUDA tensors through host
    memory, so the times are one-card correctness runs, no scaling figure),
    TP groups {0, 1} and {2, 3}.  Llama-7B's width in 8 layers; serve's 8
    prompts (--seed), 4 to each DP slice, their history from the unsharded
    whole-prompt ``prefill`` (flash_fwd) appended to each slice's own paged
    cache (admitted by its C++ scheduler, pages from its C++ allocator) and
    cut to each rank's slice (its TP heads, local page ids); then
    SHARDED_STEPS greedy steps of ``make_sharded_decode_step`` on every
    rank, in float32, in bf16 and in bf16 over an int8 cache, against the
    unsharded ``decode_step`` on the same card over the slices side by
    side: float32 logits within SHARDED_LOGITS_TOL, written pool rows
    within SHARDED_POOL_TOL, every other row untouched and the greedy
    tokens equal at every step; bf16 logits within SHARDED_BF16_RTOL of
    their largest magnitude and over the int8 cache within
    SHARDED_INT8_RTOL of max(1, it), both fed the reference's tokens; TP
    peers' logits bit for bit equal; every rank's paged decode launches
    layers x steps in the run's tensor-core form (tc_f32, tc, tc_quant),
    none scalar.  The path's launches: the prefills' and the ranks'."""
    import tempfile

    from flashattention_tpu_torch.runtime import native

    rng = np.random.default_rng(args.seed)  # serve's prompts
    lens = rng.integers(64, 1025, size=8)
    vocab = _sharded_cfg(transformer, "float32").vocab_size
    prompts = [rng.integers(0, vocab, size=int(n)).tolist() for n in lens]
    rec = {"phase": "serve_sharded", "model": SHARDED_MODEL, "dp": SHARDED_DP, "tp": SHARDED_TP,
           "ranks": SHARDED_DP * SHARDED_TP, "backend": "gloo (FileStore), every rank on cuda:0",
           "reduced": {"num_layers": f"32 -> {SHARDED_LAYERS}"}, "prompt_lens": lens.tolist(),
           "steps": SHARDED_STEPS, "page_size": PAGE_SIZE}
    path = dict.fromkeys(counters, 0)
    refs = {}
    work = tempfile.mkdtemp(prefix="serve_sharded_")
    try:
        t0 = time.perf_counter()
        params = _sharded_params(transformer, train.common, args.seed, 0, 1)
        rec["init_s"] = time.perf_counter() - t0
        hist = None
        for run, (mdt, cdt, _) in SHARDED_RUNS.items():
            cfg = _sharded_cfg(transformer, mdt)
            if params["embed"].dtype != DTYPES[mdt]:
                params, hist = _cast_tree(params, DTYPES[mdt]), None
            if hist is None:  # each prompt's whole-prompt prefill: the path's flash_fwd
                outs = []

                def prefill():
                    for p in prompts:
                        logits, k, v = transformer.prefill(
                            params, torch.tensor([p], dtype=torch.int32, device="cuda"), cfg)
                        outs.append((logits[0, -1].argmax().int(), k[:, 0], v[:, 0]))

                _, launches = _drive(counters, prefill)
                path = {k: path[k] + launches[k] for k in path}
                rec[f"prefill_{mdt}_launches"] = {k: x for k, x in launches.items() if x}
                hist = (torch.stack([o[0] for o in outs]), ([o[1] for o in outs],
                                                            [o[2] for o in outs]))
                del outs
            refs[run] = _sharded_reference(transformer, kvcache, native, cfg, params, prompts,
                                           *hist, cdt, work, run)
        del params, hist
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        results, failure = _spawn_sharded(work, args.seed)
        rec["ranks_s"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    rec["native"] = _natives(*refs.values())
    rec["books"] = {run: ref["books"] for run, ref in refs.items()}
    books_ok = all(b["pages_freed"] and b["admitted"] == [
        list(range(i * 4, (i + 1) * 4)) for i in range(SHARDED_DP)] for b in rec["books"].values())
    if failure is not None:
        rec.update(rank_failure=failure, launches=path, ok=False)
    else:
        rec["rank_init_s"] = [r["init_s"] for r in results]
        rec["rank_weights_gb"] = [r["weights_gb"] for r in results]
        runs = {}
        for run, (mdt, cdt, form) in SHARDED_RUNS.items():
            checks, peers = _sharded_rank_checks(run, refs[run], results, cdt, form)
            for c in checks:
                path = {k: path[k] + c["launches"].get(k, 0) for k in path}
            ref_ms = refs[run]["step_ms"]
            runs[run] = {
                "model_dtype": mdt, "cache_dtype": cdt, "form": form, "ranks": checks,
                "tp_peers_logits_bitwise": peers,
                "unsharded_ms_per_step": float(np.mean(ref_ms[1:])), "unsharded_step_ms": ref_ms,
                "sharded_ms_per_step": [c["ms_per_step"] for c in checks],
                "allreduce_ms": [c["allreduce_ms"] for c in checks],
                "ok": all(c["ok"] for c in checks) and all(peers)}
        rec.update(runs=runs, launches=path,
                   ok=all(r["ok"] for r in runs.values()) and books_ok
                   and all(rec["native"].values()))
    emit(rec)
    report["serve_sharded"] = rec
    torch.cuda.empty_cache()
    return rec


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
    the ``_quant`` one; paged_decode_tc's kernel and its merge kernel are
    paged_decode_tc's (``_quant`` where their last argument, kKV, is 1 or
    2, ``_f32`` where it is 3; the float32 form's own kernel is
    paged_decode_tc_f32_kernel); the float32 forms (the last argument, kTerms, not 0) are
    flash_fwd_tc_f32's (``_extra`` with dropout, the third argument) and
    flash_bwd_tc_f32's; the backward's two kernels (d = 256 and d = 128
    over two terms: the wide one) are flash_bwd_tc's, or flash_bwd_dkv_tc's
    in the pair's form (the fourth argument, kPair)."""
    def flag(a):
        return a in ("true", "1", "(bool)1")

    def nonzero(a):
        return a not in ("0", "(int)0")

    m = re.search(r"flash_fwd_tc_kernel<([^<>]*)>", name)
    if m:
        args = [a.strip() for a in m.group(1).split(",")]
        if len(args) > 6 and nonzero(args[6]):
            return "flash_fwd_tc_f32" + ("_extra" if flag(args[2]) else "")
        paged = flag(args[4])
        quant = len(args) > 5 and nonzero(args[5])
        return ("paged_prefill_tc" if paged else "flash_fwd_tc") + ("_quant" if quant else "")
    m = re.search(r"paged_decode_tc(?:_merge)?_kernel<([^<>]*)>", name)
    if m:
        kv = m.group(1).split(",")[-1].strip()
        if kv in ("3", "(int)3"):
            return "paged_decode_tc_f32"
        return "paged_decode_tc" + ("_quant" if nonzero(kv) else "")
    m = re.search(r"flash_bwd_tc(?:_wide)?_kernel<([^<>]*)>", name)
    if m:
        args = [a.strip() for a in m.group(1).split(",")]
        if flag(args[3]):
            return "flash_bwd_dkv_tc"
        return "flash_bwd_tc_f32" if nonzero(args[4]) else "flash_bwd_tc"
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
    d = 128, causal, int8 K/V, in bfloat16 q and in float32 q (of the same
    values, taken in bf16 at the default precision, O float32 from the
    float32 sums, so that its bf16 rounding is the bf16 call's O); each
    launches the flash kernel's tensor-core 8-bit form once and the calls
    agree."""
    b, h, s, d = 4, 32, 1024, 128
    kq, vq = (_kv(gen, (b * h, s, d), None, "int8") for _ in range(2))
    q = torch.randn((b * h, s, d), generator=gen, device="cuda").to(torch.bfloat16)
    fn = flash.flash_attention
    attrs = {"flash_fwd": "launches", "flash_fwd_quant": "launches_quantized",
             "flash_fwd_tc": "launches_tc", "flash_fwd_tc_quant": "launches_tc_quantized",
             "flash_fwd_tc_quant_f32q": "launches_tc_quantized_f32q"}
    for attr in attrs.values():
        setattr(fn, attr, 0)
    outs = {}
    for dt in ("bfloat16", "float32"):
        x = q.to(DTYPES[dt])
        outs[dt] = (
            fa.attention_quantized(x, quant.QuantizedTensor(*kq), quant.QuantizedTensor(*vq),
                                   causal=True, scale=d**-0.5),
            fa.attention(x.reshape(b, h, s, d), kq[0].reshape(b, h, s, d),
                         vq[0].reshape(b, h, s, d), causal=True, scale=d**-0.5,
                         k_scales=kq[1].reshape(b, h, s), v_scales=vq[1].reshape(b, h, s)))
    torch.cuda.synchronize()
    launches = {k: getattr(fn, attr) for k, attr in attrs.items()}
    (o1, o2), (o3, o4) = outs["bfloat16"], outs["float32"]
    e = err(o1.reshape(o2.shape), o2)
    e32 = err(o3.reshape(o4.shape), o4)
    e_rounded = err(o3.to(torch.bfloat16), o1)
    rec = {"phase": "quant_ops", "shape": f"B={b} H={h} S={s} d={d} causal, bf16 and float32 q, "
                                          "int8 K/V",
           "max_abs_err": e, "float32_q_max_abs_err": e32, "float32_q_rounded_vs_bf16": e_rounded,
           "float32_q_dtypes": [str(o3.dtype), str(o4.dtype)], "tol": 0.0, "launches": launches,
           "ok": e == 0.0 and e32 == 0.0 and e_rounded == 0.0
           and o3.dtype == o4.dtype == torch.float32
           and launches == {"flash_fwd": 4, "flash_fwd_quant": 4, "flash_fwd_tc": 4,
                            "flash_fwd_tc_quant": 4, "flash_fwd_tc_quant_f32q": 2}}
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


MIXTRAL_MODEL = ("mixtral8x7b: 32 q / 8 KV heads, d=128, 8 experts of intermediate 14336, "
                 "top-2")


def _weights_gb(params, quant):
    """Bytes of a parameter tree (payloads and scales of quantized leaves)."""
    from flashattention_tpu_torch.models.train.common import leaves

    return sum(
        t.numel() * t.element_size() for leaf in leaves(params)
        for t in ((leaf.payload, leaf.scales) if isinstance(leaf, quant.QuantizedWeight)
                  else (leaf,))) / 1e9


def _moe_times(transformer, benchit, layer, rows, top_k):
    """One MoE layer's MLP at ``rows`` bf16 activation rows on int8 expert
    stacks (ms): the whole ``_mlp``; the three stacks' upcasts to bfloat16
    alone; the expert products on bfloat16 stacks (dequantized beforehand)
    over all E experts, as the dense MoE computes them, and over top_k
    experts only (the products a routed MoE would make at most)."""
    d = layer["w_gate"].shape[1]
    x = torch.randn((rows, d), device="cuda").to(torch.bfloat16)
    out = {"rows": rows, "int8_mlp_ms": benchit.cuda_time_ms(
        lambda: transformer._mlp(x, layer, top_k))}
    stacks = [layer[n] for n in ("w_gate", "w_up", "w_down")]
    out["upcast_ms"] = sum(benchit.cuda_time_ms(lambda w=w: w.payload.to(torch.bfloat16))
                           for w in stacks)
    wb = [(w.payload.float() * w.scales[:, None, :]).to(torch.bfloat16) for w in stacks]

    def products(k):
        h = torch.matmul(x, wb[0][:k]) * torch.matmul(x, wb[1][:k])
        return torch.matmul(h, wb[2][:k])

    out["bf16_expert_mm_ms"] = benchit.cuda_time_ms(lambda: products(len(wb[0])))
    out["bf16_routed_mm_ms"] = benchit.cuda_time_ms(lambda: products(top_k))
    del wb
    torch.cuda.empty_cache()
    return out


def _mixtral_int8_params(args, cfg, transformer, quant):
    """``mixtral8x7b`` at ``cfg.num_layers`` layers with int8 weights, made
    one layer at a time: layer i drawn as the layer of a one-layer model
    from seed ``args.seed + i`` and quantized at once, so that no more than
    one layer's bfloat16 weights exist (embedding, final norm and LM head
    from the first draw)."""
    one = dataclasses.replace(cfg, num_layers=1)
    params = None
    for i in range(cfg.num_layers):
        drawn = transformer.init_params(args.seed + i, one)
        layer = quant.quantize_weights(drawn["layers"][0], "int8")
        if params is None:
            params = quant.quantize_weights({k: v for k, v in drawn.items() if k != "layers"},
                                            "int8")
            params["layers"] = []
        params["layers"].append(layer)
        del drawn
    return params


def phase_serve_mixtral_int8(args, transformer, quant, engine_mod, kvcache, benchit, counters,
                             report):
    """Mixtral-8x7B-class at full width and its published 32 layers on one
    card: int8 weights (46.7 GB; bfloat16's 93 GB would not fit), a bf16 KV
    cache, serve_chunked's engine and prompts, then a profile of 4 requests
    with 1536-token prompts.  Also times one layer's MoE MLP on the int8
    path against its upcasts and its products on bfloat16 stacks (over all
    experts and over the top-2)."""
    cfg = transformer.ModelConfig.mixtral8x7b(num_layers=args.layers)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = _mixtral_int8_params(args, cfg, transformer, quant)
    torch.cuda.synchronize()
    extra = {"weights": "int8", "weights_gb": _weights_gb(params, quant),
             "init_quantize_s": time.perf_counter() - t0,
             "init_peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
             "moe_decode": _moe_times(transformer, benchit, params["layers"][0], 4,
                                      cfg.experts_per_token),
             "moe_chunk": _moe_times(transformer, benchit, params["layers"][0], 2048,
                                     cfg.experts_per_token),
             "unrouted_expert_share": 1 - cfg.experts_per_token / cfg.num_experts}
    rec = phase_serve_chunked(args, cfg, params, engine_mod, kvcache, counters, report,
                              phase="serve_mixtral_int8", extra=extra, model=MIXTRAL_MODEL)
    del params
    torch.cuda.empty_cache()
    return rec


def phase_parity_mixtral(args, transformer, kvcache, engine_mod, report):
    """Mixtral-8x7B-class at full width, cut to 2 float32 layers (drawn on
    the card and copied): one 64-token request through whole-prompt
    prefill and 4 decode steps, and the chunked engine (a 300-token prompt,
    then one sharing its first 256 tokens), card against CPU within
    PARITY_TOL.  float32, so that no route flips on a one-ulp difference of
    the router logits."""
    cfg = dataclasses.replace(transformer.ModelConfig.mixtral8x7b(num_layers=2), dtype="float32")
    gpu_params = transformer.init_params(args.seed, cfg)
    cpu_params = _to_card(gpu_params, "cpu")
    t0 = time.perf_counter()
    prompt = np.random.default_rng(args.seed + 1).integers(0, cfg.vocab_size, size=64)
    e, absmax, _ = _parity_whole(transformer, kvcache, cfg, cpu_params, gpu_params, prompt)
    rec = {"phase": "parity_mixtral", "model": MIXTRAL_MODEL, "layers": 2, "dtype": "float32",
           "prompt_len": 64, "decode_steps": 4, "max_abs_err": e, "tol": PARITY_TOL,
           "logit_absmax": absmax, "ok": e <= PARITY_TOL}
    emit(rec)
    report["parity_mixtral"] = rec
    rng = np.random.default_rng(args.seed + 4)
    first = rng.integers(0, cfg.vocab_size, size=300).tolist()
    second = first[:256] + rng.integers(0, cfg.vocab_size, size=50).tolist()
    report["parity_mixtral_chunked"] = parity_chunked(
        cfg, cpu_params, gpu_params, kvcache, engine_mod, first, second, "parity_mixtral_chunked")
    report["parity_mixtral_chunked"]["seconds"] = rec["seconds"] = time.perf_counter() - t0
    del gpu_params, cpu_params
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

    def plain_of(form, fused):
        return lambda: backward.flash_attention_bwd_plain(*fp32, form=form, fused=fused, **kw,
                                                          **segs)

    pair = backward.bwd_form(q, False, kw.get("block_mask") is not None)
    plain = plain_of(pair, False)
    wants = {"two_pass": plain()}
    runs = {"two_pass": backward.flash_attention_bwd(*ins, fused=False, **kw, **segs)}
    if pair != "scalar":
        wants["two_pass_scalar"] = plain_of("scalar", False)()
        with flash.scalar_forms():
            runs["two_pass_scalar"] = backward.flash_attention_bwd(*ins, fused=False, **kw, **segs)
    if not segs and kw.get("block_mask") is None:
        runs["fused"] = backward.flash_attention_bwd(*ins, fused=True, **kw)
        form = backward.bwd_form(q, True)
        plain = plain_of(form, True)
        # (the pair's float32 form takes four products at d = 64, the fused three)
        same = form == pair and not (form == "tc_f32" and q.shape[-1] == 64)
        wants["fused"] = wants["two_pass"] if same else plain()
    torch.cuda.synchronize()
    return ins, plain, wants, runs


def _time_pair_f32(backward, flash, benchit, card, recs, ins, kw, segs, c, plain):
    """The pair's float32 forms in "bf16_3x" and their "bf16" mode, each
    beside the scalar pair (exact float32: its own check in ``recs``, timed
    there, the scalar rows) and SDPA float32's backward under the boolean
    mask, at one float32 case of ``_bwd_case``.  Returns ``{form: timed
    record}``."""
    yard = _bwd_yardsticks(benchit, ins, kw, c, plain)
    q, k, v, o, lse, do = ins
    di = (o.float() * do.float()).sum(dim=-1)
    out = {}
    for name, f32 in PAIR_F32.items():
        rec = recs[f32]
        rec.update(_time_bwd(backward, flash, benchit, card, f32, ins, kw, segs, c, yard,
                             "float32"))
        fn = backward.dq_kernel if name == "flash_bwd_dq" else backward.dkv_kernel
        rec["bf16_mode_ms"] = benchit.cuda_time_ms(
            lambda: fn(q, k, v, do, lse, di, precision="bf16", **kw, **segs), warmup=1, iters=5)
        with flash.scalar_forms():
            recs[name].update(_time_bwd(backward, flash, benchit, card, name, ins, kw, segs, c,
                                        yard, "float32"))
        recs[name]["form"] = "exact float32 (the scalar pair, ops.flash.scalar_forms)"
        rec["scalar_ms"] = recs[name]["kernel_ms"]
        out[f32] = rec
    return out


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
    two-pass kernel, both forms, on the packed layer; and in float32 at B =
    2: the fused backward's float32 form (its "bf16" mode too) beside the
    scalar kernel (``report["float32_timed"]["flash_bwd"]``) on the plain
    layer, the pair's float32 forms (their "bf16" mode too) beside the
    scalar pair on the packed layer."""
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
            # Row 5 in float32: the fused backward's float32 form (the float32
            # training paths' form at d = 128) in "bf16_3x" and its "bf16"
            # mode, beside the scalar kernel (exact float32; its own check,
            # timed: the scalar row) and SDPA float32's backward.
            yard = _bwd_yardsticks(benchit, ins, kw, c, plain)
            rec = recs[fused]
            rec.update(_time_bwd(backward, flash, benchit, card, fused, ins, kw, segs, c, yard, dt))
            rec["bf16_mode_ms"] = benchit.cuda_time_ms(
                lambda: backward.flash_attention_bwd(*ins, fused=True, precision="bf16", **kw),
                warmup=1, iters=5)
            with flash.scalar_forms():
                got = backward.flash_attention_bwd(*ins, fused=True, **kw)
                twin = _bwd_rec(f"flash_bwd/{name}/{dt}", got, wants["two_pass"], dt,
                                grad_absmax=absmax, shape=shape,
                                form="exact float32 (the scalar kernel, ops.flash.scalar_forms)")
                twin.update(_time_bwd(backward, flash, benchit, card, "flash_bwd", ins, kw, segs, c,
                                      yard, dt))
            rec["scalar_ms"] = twin["kernel_ms"]
            recs["flash_bwd"] = twin
            mains[fused] = rec
            report.setdefault("float32_timed", {})["flash_bwd"] = twin
        if (name, dt) == ("packed_layer_b2", "float32"):
            # Rows 6-7 in float32 (float32 packed training's forms).
            mains.update(_time_pair_f32(backward, flash, benchit, card, recs, ins, kw, segs, c,
                                        plain))
            report.setdefault("float32_timed", {}).update({k: recs[k] for k in PAIR})
        dq_tc = _kname("flash_bwd_dq", q)
        if dq_tc != "flash_bwd_dq" and "seg" in c:
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
# fused backward's bf16 tensor-core form with a softcap at d = 128).
_GEMMA_LAYER = dict(b=1, kvh=8, g=2, s_q=8192, s_kv=8192, d=256, window=4096, cap=50.0)
GEMMA_PACKED_DOCS = (5000, 2100, 1000)
_MISTRAL_LAYER = dict(b=1, kvh=8, g=4, s_q=8192, s_kv=8192, d=128, window=4096, cap=None)
BWD_WINDOW_CASES = (
    ("gemma2_d256_w4096_cap50", dict(_GEMMA_LAYER, q_mult=1.0)),
    ("gemma2_d256_w4096_cap50_q8", dict(_GEMMA_LAYER, q_mult=8.0)),
    ("mistral_d128_w4096", dict(_MISTRAL_LAYER, q_mult=1.0)),
    ("mistral_d128_w4096_q8", dict(_MISTRAL_LAYER, q_mult=8.0)),
    ("gemma2_packed_w4096_cap50_q8", dict(_GEMMA_LAYER, q_mult=8.0, docs=GEMMA_PACKED_DOCS)),
    ("d16_s300_w100_cap30_q8", dict(b=1, kvh=8, g=4, s_q=300, s_kv=300, d=16, window=100,
                                    cap=30.0, q_mult=8.0)),
    # The tensor-core backward with a softcap (d <= 128), over a ragged S.
    ("d128_s1000_w300_cap30_q8", dict(b=1, kvh=8, g=2, s_q=1000, s_kv=1000, d=128, window=300,
                                      cap=30.0, q_mult=8.0)),
)
TIMED_BWD_WINDOW_CASES = ("gemma2_d256_w4096_cap50", "mistral_d128_w4096",
                          "gemma2_packed_w4096_cap50_q8")
# Timed in float32 too: the pair's float32 forms at d = 256 (rows 6-7),
# and the fused backward's float32 form at Gemma-2's layer (row 5).
TIMED_F32_BWD_WINDOW_CASE = "gemma2_packed_w4096_cap50_q8"
TIMED_F32_FUSED_WINDOW_CASE = "gemma2_d256_w4096_cap50"


def _time_fused_f32(backward, flash, benchit, card, recs, ins, kw, c, plain, wants, name,
                    report):
    """Row 5 in float32 at one unsegmented case of ``_bwd_case``: the fused
    backward's float32 form in "bf16_3x", in its "bf16" mode and with
    dropout at rate 0.1 (the same inputs; lse does not depend on the drop),
    beside the scalar kernel under ``ops.flash.scalar_forms`` (exact
    float32: held against the exact plain backward, timed, kept in
    ``report["float32_timed"]["flash_bwd/d256_window_softcap"]``) and SDPA
    float32's backward under the boolean mask.  Returns the form's timed
    record."""
    yard = _bwd_yardsticks(benchit, ins, kw, c, plain)
    rec = recs["flash_bwd_tc_f32"]
    rec.update(_time_bwd(backward, flash, benchit, card, "flash_bwd_tc_f32", ins, kw, {}, c, yard,
                         "float32"))
    rec["bf16_mode_ms"] = benchit.cuda_time_ms(
        lambda: backward.flash_attention_bwd(*ins, fused=True, precision="bf16", **kw),
        warmup=1, iters=5)
    drop = dict(kw, dropout_rate=0.1, dropout_seed=DROPOUT_SEED)
    rec["dropout_ms"] = benchit.cuda_time_ms(
        lambda: backward.flash_attention_bwd(*ins, fused=True, **drop), warmup=1, iters=5)
    with flash.scalar_forms():
        got = backward.flash_attention_bwd(*ins, fused=True, **kw)
        twin = _bwd_rec(f"flash_bwd/{name}/float32", got, wants["two_pass_scalar"], "float32",
                        grad_absmax=[float(w.abs().max()) for w in wants["two_pass_scalar"]],
                        form="exact float32 (the scalar kernel, ops.flash.scalar_forms)")
        del got
        twin.update(_time_bwd(backward, flash, benchit, card, "flash_bwd", ins, kw, {}, c, yard,
                              "float32"))
    rec["scalar_ms"] = twin["kernel_ms"]
    recs["flash_bwd"] = twin
    report.setdefault("float32_timed", {})["flash_bwd/d256_window_softcap"] = twin
    return rec


def _padded_doc_ids(docs, s):
    """(1, s) int32 segment ids on the card: documents of ``docs`` tokens
    in order, the rest padding (-1)."""
    ids = torch.full((1, s), -1, dtype=torch.int32, device="cuda")
    ends = np.cumsum((0,) + tuple(docs))
    for i, (a, e) in enumerate(zip(ends[:-1], ends[1:])):
        ids[0, a:e] = i
    return ids


def bwd_window_checks(backward, flash, benchit, gen, card, report, names=None, timed=True):
    """The three backward kernels at BWD_WINDOW_CASES (``names``: a subset),
    each gradient against the plain backward (float32 from the same inputs)
    within BWD_TOL and, in bfloat16, each element within BF16_ELEM_TOL.  o
    and lse come from the forward kernel.  Timed at the bfloat16 Gemma-2 and
    Mistral layers (unless not ``timed``): each kernel, the plain backward,
    and SDPA's backward under a boolean causal+window mask (no softcap);
    and in float32 at Gemma-2's packed layer the pair's float32 forms
    beside the scalar pair (``_time_pair_f32``), at Gemma-2's layer the
    fused backward's float32 form beside the scalar kernel
    (``_time_fused_f32``).  Returns
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
            ids = _padded_doc_ids(c["docs"], s)
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
            if timed and dt == "float32" and name == TIMED_F32_BWD_WINDOW_CASE:
                for kname, rec in _time_pair_f32(backward, flash, benchit, card, recs, ins, kw,
                                                 segs, c, plain).items():
                    timed_recs.setdefault(kname, {})[name] = rec
            if timed and dt == "float32" and name == TIMED_F32_FUSED_WINDOW_CASE:
                timed_recs.setdefault("flash_bwd_tc_f32", {})[name] = _time_fused_f32(
                    backward, flash, benchit, card, recs, ins, kw, c, plain, wants, name, report)
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
    and its bound from this case's live pairs (the float32 forms, ``*_tc_f32``:
    their bf16 products in the default "bf16_3x", 2 d flops each over the
    bf16 peak: the fused backward's 15 a live pair, the pair's dQ pass 9 and
    dK/dV pass 12 at d = 128, 12 and 16 at d = 64)."""
    q, k, v, o, lse, do = ins
    di = (o.float() * do.float()).sum(dim=-1)
    f32_form = kname.endswith("_tc_f32")
    # The form that runs is the caller's choice.
    kname = kname.removesuffix("_tc_f32").removesuffix("_tc")
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
    if f32_form:
        per_matmul = 4 if kname != "flash_bwd" and c["d"] == 64 else 3
        n = per_pair // 2 * per_matmul  # per_pair: 2 d flops a matmul
        per_pair, dt = 2 * n, "bfloat16"
        out["products"] = f"{n} bf16 products of 2 d flops a live pair (bf16_3x)"
        # beside the bound: the split pass's float32 reads and bf16 [hi | lo] writes
        out["split_pass_bytes"] = sum(8 * t.numel() for t in (q, k, v, do))
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
    # The pair's float32 forms at d = 256: Gemma-2's packed layer (rows 6-7).
    gemma_docs = _padded_doc_ids(GEMMA_PACKED_DOCS, _GEMMA_LAYER["s_kv"])
    cases.append(("gemma2_packed_w4096_cap50", dict(_GEMMA_LAYER, seg=gemma_docs), "float32",
                  (0.1,)))
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
            # The float32 forms' dropout forms at the training layer (rows 1
            # and 5), each beside the scalar kernel's (its own check, timed).
            timing32 = timed and (name, dt, rate) == ("train_layer_b2", "float32", 0.1)
            # The pair's float32 dropout forms at the packed layers (rows 6-7;
            # d = 128 and Gemma-2's d = 256), each beside the scalar pair's.
            timing32p = timed and dt == "float32" and rate == 0.1 and name in (
                "packed_layer_b2", "gemma2_packed_w4096_cap50")
            if "seg" not in c:
                rec, fwd_plain = _fwd_rec(f"{_kname('flash_fwd', q, dropout=True)}/dropout/"
                                          f"{name}/{rate}/{dt}",
                                          flash, q, k, v, kw, segs, dt, shape=shape)
                if timing32:
                    mains["flash_fwd_tc_f32_extra"], twin = _time_f32_dropout_fwd(
                        flash, benchit, card, rec, q, k, v, kw, segs, c, fwd_plain, shape)
                    report.setdefault("float32_timed", {})["flash_fwd/dropout"] = twin
                    emit(twin)
                    report["checks"].append(twin)
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
            yard = yard32p = None
            recs = {}
            for kname, (gots, wants_k) in _bwd_got(q, kw, runs, wants).items():
                rec = _bwd_rec(f"{kname}/dropout/{name}/{rate}/{dt}", gots, wants_k, dt,
                               shape=shape, grad_absmax=[float(w.abs().max()) for w in wants_k])
                recs[kname] = rec
                if timing32 and kname == fused:
                    yard32 = _bwd_yardsticks(benchit, ins, kw, c, plain, dropout_p=rate)
                    rec.update(_time_bwd(backward, flash, benchit, card, kname, ins, kw, segs, c,
                                         yard32, dt))
                    rec["no_dropout_ms"] = _time_bwd(backward, flash, benchit, card, kname, ins,
                                                     _no_dropout(kw), segs, c, yard32,
                                                     dt)["kernel_ms"]
                    with flash.scalar_forms():
                        got = backward.flash_attention_bwd(*ins, fused=True, **kw)
                        twin = _bwd_rec(f"flash_bwd/dropout/{name}/{rate}/{dt}", got,
                                        wants["two_pass"], dt, shape=shape,
                                        form="exact float32 (the scalar kernel, "
                                             "ops.flash.scalar_forms)")
                        twin.update(_time_bwd(backward, flash, benchit, card, "flash_bwd", ins,
                                              kw, segs, c, yard32, dt))
                    rec["scalar_ms"] = twin["kernel_ms"]
                    recs["flash_bwd"] = twin
                    mains["flash_bwd_tc_f32/dropout"] = rec
                    report.setdefault("float32_timed", {})["flash_bwd/dropout"] = twin
                if timing32p and kname in PAIR_F32.values():
                    if yard32p is None:
                        yard32p = _bwd_yardsticks(benchit, ins, kw, c, plain, dropout_p=rate)
                    rec.update(_time_bwd(backward, flash, benchit, card, kname, ins, kw, segs, c,
                                         yard32p, dt))
                    rec["no_dropout_ms"] = _time_bwd(backward, flash, benchit, card, kname, ins,
                                                     _no_dropout(kw), segs, c, yard32p,
                                                     dt)["kernel_ms"]
                    with flash.scalar_forms():
                        rec["scalar_ms"] = _time_bwd(backward, flash, benchit, card,
                                                     kname.removesuffix("_tc_f32"), ins, kw, segs,
                                                     c, yard32p, dt)["kernel_ms"]
                    mains[kname if name == "packed_layer_b2" else f"{kname}/gemma2_packed"] = rec
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


def _time_f32_dropout_fwd(flash, benchit, card, rec, q, k, v, kw, segs, c, plain, shape):
    """The float32 forward's dropout form (``flash_fwd_tc_f32_extra``,
    "bf16_3x") timed as ``_time_dropout_fwd`` times a form, SDPA float32
    with dropout_p beside it, its bound over its bf16 products
    (``ops.flash.f32_products`` each for S and PV, 2 d flops a live pair
    each); and the scalar kernel's dropout form on the same inputs
    (``ops.flash.scalar_forms``: its own check, timed, bound at the float32
    rate).  Returns ``(rec, the scalar form's record)``."""
    d = c["d"]
    rec.update(_time_dropout_fwd(flash, benchit, card, q, k, v, kw, c, plain))
    rec["library"] = rec["library"].replace("scaled_dot_product_attention",
                                            "scaled_dot_product_attention float32", 1)
    n = flash.f32_products(d)
    nbytes = 4 * (2 * q.numel() + 2 * k.numel())
    rec.update(products=f"{n} for S, {n} for PV",
               **benchit.bound_ms(card, bytes_moved=nbytes, flops=4 * n * d * rec["live_pairs"],
                                  dtype="bfloat16"))
    with flash.scalar_forms():
        twin, scalar_plain = _fwd_rec(rec["check"].replace("flash_fwd_tc_f32_extra/", "flash_fwd/", 1),
                                      flash, q, k, v, kw, segs, "float32", shape=shape,
                                      form="exact float32 (the scalar kernel, ops.flash.scalar_forms)")
        twin.update(_time_dropout_fwd(flash, benchit, card, q, k, v, kw, c, scalar_plain))
    twin.update(library_ms=rec["library_ms"], library=rec["library"],
                **benchit.bound_ms(card, bytes_moved=nbytes, flops=4 * d * rec["live_pairs"],
                                   dtype="float32"))
    rec["scalar_ms"] = twin["kernel_ms"]
    return rec, twin


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


# The float32 training forms: the fused backward's float32 form
# (flash_bwd_tc_f32, its dropout form built into flash_bwd_tc_f32_extra) and
# the forward's dropout form (flash_fwd_tc_f32_extra), in the JAX modes
# "bf16_3x" and "bf16" at F32_TRAIN_DIMS (at d = 256 the forward's dropout
# launches are the scalar kernel's), over F32_TRAIN_CASES: the GQA fold
# with causal rows, a ragged S = 300 with no mask, kv_len / q_offset, a window
# with a softcap and q x 8 (scores near the cap), dropout at rates 0.1 and
# 0.5 (with the window and softcap), the forward of each dropout case against
# its plain version (F32_FORM_TOL of the output's magnitude, the residuals
# within STATS_RTOL) and the gradients against the plain backward in the same
# mode (BWD_TOL, float32: absolute, gradients below 4), each call launching
# its form once and no scalar kernel.  Then NaN in K/V rows past kv_len and
# in every row of the next heads behind a ragged S (the forward with dropout
# and the gradients of the first head as the clean inputs': o, dK and dV
# bitwise, dQ, summed by atomics, within 1e-6); and the keep bits: with V and
# dO the identity (S = d, every pair live) the forward's zeros and dV^T's are
# exactly the plain version's dropped pairs (ops.flash.dense_keep).
F32_TRAIN_MODES = ("bf16_3x", "bf16")
F32_TRAIN_DIMS = (64, 128, 256)
# (BH, G, S_q, S_kv, kwargs): folded q (BH, G S_q, d) against (BH, S_kv, d)
F32_TRAIN_CASES = {
    "causal_gqa": (4, 2, 1000, 1000, dict(causal=True)),
    "full_ragged": (4, 1, 300, 300, dict(causal=False)),
    "kv_len_q_offset": (4, 1, 128, 300, dict(causal=True, kv_len=250, q_offset=122)),
    "window_softcap_q8": (4, 2, 1000, 1000, dict(causal=True, window=300, logit_softcap=30.0,
                                                 q_mult=8.0)),
    "dropout": (4, 2, 1000, 1000, dict(causal=True, dropout_rate=0.1)),
    "dropout_window_softcap": (4, 1, 600, 600, dict(causal=True, window=100, logit_softcap=30.0,
                                                    dropout_rate=0.5)),
}


def _f32_train_inputs(gen, d, case):
    """q, k, v, dO (float32, on the card) and the keywords of one
    F32_TRAIN_CASES case at head_dim d; dO at a quarter of the scale
    (divided by q's multiplier), so the gradients stay below 4."""
    bh, g, s_q, s_kv, kw = F32_TRAIN_CASES[case]
    kw = dict(kw, scale=d**-0.5)
    mult = kw.pop("q_mult", 1.0)
    q = mult * torch.randn((bh, g * s_q, d), generator=gen, device="cuda")
    k, v = (torch.randn((bh, s_kv, d), generator=gen, device="cuda") for _ in range(2))
    do = (0.25 / mult) * torch.randn(q.shape, generator=gen, device="cuda")
    if g > 1:
        kw["q_seq_len"] = s_q
    if "dropout_rate" in kw:
        kw["dropout_seed"] = DROPOUT_SEED
    return q, k, v, do, kw


def _f32_train_counts(flash, backward):
    fa_, fb = flash.flash_attention, backward.fused_bwd_kernel
    return (fa_.launches, fa_.launches_tc_f32, fa_.launches_tc_f32_dropout, fb.launches,
            fb.launches_tc_f32, fb.launches_tc_f32_dropout)


def _f32_train_hold(flash, backward, q, k, v, do, kw, mode, check):
    """One case's records: the forward (with dropout) and the gradients
    against their plain versions in ``mode``, and each call's launches."""
    recs = []
    dropout = "dropout_rate" in kw
    fwd_name = _kname("flash_fwd", q, dropout=True, precision=mode)
    n0 = _f32_train_counts(flash, backward)
    o, l, m = flash.flash_attention(q, k, v, save_residuals=True, precision=mode, **kw)
    n1 = _f32_train_counts(flash, backward)
    lse = m + torch.log(torch.where(l == 0, 1.0, l))
    got = backward.flash_attention_bwd(q, k, v, o, lse, do, precision=mode, **kw)
    n2 = _f32_train_counts(flash, backward)
    want = backward.flash_attention_bwd_plain(q, k, v, o, lse, do, precision=mode, **kw)
    if dropout:
        wo, wl, wm = flash.flash_attention_plain(q, k, v, save_residuals=True, precision=mode,
                                                 **kw)
        torch.cuda.synchronize()
        norm = float(wo.abs().max())
        stats = {f"{x}_rel_err": err(a, b) / float(b.abs().max())
                 for x, a, b in zip("lm", (l, m), (wl, wm))}
        f32_form = int(fwd_name == "flash_fwd_tc_f32_extra")
        fwd_launched = [b - a for a, b in zip(n0[:3], n1[:3])] == [1, f32_form, f32_form]
        rec = {"check": f"{fwd_name}/{check}", "max_abs_err": err(o, wo),
               "rel_err": err(o, wo) / norm, "tol": F32_FORM_TOL[mode],
               "tol_of": "the output's largest magnitude", **stats, "stats_rtol": STATS_RTOL,
               "launched_its_form": fwd_launched}
        rec["ok"] = (rec["rel_err"] <= rec["tol"] and fwd_launched
                     and all(x <= STATS_RTOL for x in stats.values()))
        recs.append(rec)
    bwd_launched = [b - a for a, b in zip(n1[3:], n2[3:])] == [1, 1, int(dropout)]
    rec = _bwd_rec(f"flash_bwd_tc_f32/{check}", got, want, "float32",
                   grad_absmax=[float(w.abs().max()) for w in want],
                   launched_its_form=bwd_launched)
    rec["ok"] = rec["ok"] and bwd_launched and all(g.dtype == torch.float32 for g in got)
    recs.append(rec)
    return recs


def _f32_train_poison(flash, backward, gen, d, mode):
    """NaN past kv_len, and in the next heads behind a ragged S: the first
    head's o (with dropout), dK and dV bitwise the clean inputs', dQ within
    1e-6 and finite."""
    recs = []
    for past in ("kv_len", "s"):
        if past == "kv_len":
            q, k, v, do, kw = _f32_train_inputs(gen, d, "kv_len_q_offset")
        else:
            q, k, v, do = (torch.randn((4, 200, d), generator=gen, device="cuda") for _ in range(4))
            do *= 0.25
            kw = dict(causal=False, scale=d**-0.5)
        kw.update(dropout_rate=0.1, dropout_seed=DROPOUT_SEED)
        outs = []
        for poison in (False, True):
            qp, kp, vp, dop = (x.clone() for x in (q, k, v, do))
            if poison:
                if past == "kv_len":
                    kp[:, kw["kv_len"]:] = float("nan")
                    vp[:, kw["kv_len"]:] = float("nan")
                for x in (qp, kp, vp, dop):
                    x[1:] = float("nan")
            o, l, m = flash.flash_attention(qp, kp, vp, save_residuals=True, precision=mode, **kw)
            lse = m + torch.log(torch.where(l == 0, 1.0, l))
            outs.append((o, *backward.flash_attention_bwd(qp, kp, vp, o, lse, dop,
                                                          precision=mode, **kw)))
        torch.cuda.synchronize()
        (o0, dq0, dk0, dv0), (o1, dq1, dk1, dv1) = outs
        rec = {"check": f"flash_bwd_tc_f32/nan_poison/past_{past}/d{d}/{mode}",
               "o_bitwise": bool(torch.equal(o1[0], o0[0])),
               "dk_dv_bitwise": bool(torch.equal(dk1[0], dk0[0]) and torch.equal(dv1[0], dv0[0])),
               "dq_max_abs_err": err(dq1[0], dq0[0]), "dq_tol": 1e-6}
        rec["ok"] = (rec["o_bitwise"] and rec["dk_dv_bitwise"]
                     and rec["dq_max_abs_err"] <= rec["dq_tol"])
        recs.append(rec)
    return recs


def _f32_keep_bits(flash, backward, gen, d, mode):
    """With V and dO the identity (S_q = S_kv = d, no mask) the forward's
    o[i, j] is P's kept (i, j) and dV[j, i] is Z's: their zeros must be
    exactly the plain version's dropped pairs."""
    bh, rate = 4, 0.5
    q, k = (torch.randn((bh, d, d), generator=gen, device="cuda") for _ in range(2))
    eye = torch.eye(d, device="cuda").expand(bh, d, d).contiguous()
    kw = dict(causal=False, scale=d**-0.5, dropout_rate=rate, dropout_seed=DROPOUT_SEED)
    o, l, m = flash.flash_attention(q, k, eye, save_residuals=True, precision=mode, **kw)
    lse = m + torch.log(l)
    _, _, dv = backward.flash_attention_bwd(q, k, eye, o, lse, eye, precision=mode, **kw)
    keep = flash.dense_keep(DROPOUT_SEED, rate, range(bh), d, d, d, None, "cuda")
    torch.cuda.synchronize()
    fwd_name = _kname("flash_fwd", q, dropout=True, precision=mode)
    rec = {"check": f"{fwd_name}+flash_bwd_tc_f32/keep_bits/d{d}/{mode}",
           "dropped": int((~keep).sum()), "pairs": keep.numel(),
           "fwd_keep_equal": bool(torch.equal(o != 0, keep)),
           "bwd_keep_equal": bool(torch.equal(dv.transpose(1, 2) != 0, keep))}
    rec["ok"] = rec["fwd_keep_equal"] and rec["bwd_keep_equal"] and 0 < rec["dropped"] < rec["pairs"]
    return rec


def f32_train_checks(backward, flash, gen, report):
    """The float32 training forms at F32_TRAIN_DIMS in both modes (see
    above), untimed (their timed rows: bwd_checks' and dropout_checks'
    training layer at B = 2, and at d = 256 bwd_window_checks' Gemma-2
    layer); ``torch_tools/f32_mutants.py`` shows that these checks fail a
    form missing one of its products, dO's lo term, with Z's dropout bits
    on dS or, at d = 256, with dS read before its barrier."""
    recs = []
    for d, mode in itertools.product(F32_TRAIN_DIMS, F32_TRAIN_MODES):
        for case in F32_TRAIN_CASES:
            q, k, v, do, kw = _f32_train_inputs(gen, d, case)
            recs += _f32_train_hold(flash, backward, q, k, v, do, kw, mode, f"{case}/d{d}/{mode}")
            del q, k, v, do
        recs += _f32_train_poison(flash, backward, gen, d, mode)
        recs.append(_f32_keep_bits(flash, backward, gen, d, mode))
    for rec in recs:
        emit(rec)
        report["checks"].append(rec)
    torch.cuda.empty_cache()
    return recs


# The two-pass pair's float32 forms (flash_bwd_dq_tc_f32, flash_bwd_dkv_tc_f32;
# their dropout forms built into *_extra), in the JAX modes "bf16_3x" and
# "bf16" at PAIR_F32_DIMS (at d = 256 64-row dQ blocks over 32-row
# key tiles, 32-row query tiles in dK/dV), over PAIR_F32_CASES: packed documents (id
# ranges of neighbouring 64-row tiles meet at a document's boundary), the
# same with the GQA fold, kv_len / q_offset and a full ragged S with
# fused=False, a window with a softcap and q x 8 over documents, and dropout
# over documents.  Each through flash_attention_bwd(fused=False) against the
# plain pair in the same mode (four products a matmul at d = 64, three at d
# = 128 and 256) within BWD_TOL (float32, gradients below 4), each call launching
# both forms once and no scalar pair.  On such inputs the lo lo products
# move a gradient by about 5e-6 of its norm, under BWD_TOL and about twice
# the kernel's distance from its plain version (the exp of the kernel's
# rounded log2 argument against the plain version's exp: both recorded,
# ``norm_rel_err`` and ``other_count_norm_rel_err``, the distance to the
# plain pair with the other product count).  So the product count is held
# on ``probes.lolo_term_f32_qkvdo``'s inputs (case "lolo_terms"), on which
# lo lo moves S and dP by exact multiples of their float32 step and each
# gradient by 2.5e-3 to 5e-2 of its norm: there each gradient within
# PAIR_F32_LOLO_TOL of the plain pair's in ||got - want|| / ||want||.  dQ twice on its own gives the same bits, and dK/dV on its own
# (its own split pass) flash_attention_bwd's.  Then NaN in K/V rows past
# kv_len and in every row of the next heads behind a ragged S (the first
# head's dQ, dK and dV bitwise the clean inputs'), and the keep bits: with V
# and dO the identity dV^T's zeros are exactly the dropped pairs.
PAIR_F32_LOLO_TOL = 1e-4
PAIR_F32_DIMS = (64, 128, 256)
PAIR_F32_DOCS = (300, 150, 250, 90, 210)  # 1000 tokens, cut to S
# (BH, G, S_q, S_kv, segment ids, kwargs): folded q (BH, G S_q, d) against (BH, S_kv, d)
PAIR_F32_CASES = {
    "segments": (4, 1, 1000, 1000, True, dict(causal=True)),
    "segments_gqa": (4, 2, 1000, 1000, True, dict(causal=True)),
    "kv_len_q_offset": (4, 1, 128, 300, False, dict(causal=True, kv_len=250, q_offset=122)),
    "full_ragged": (4, 1, 300, 300, False, dict(causal=False)),
    "window_softcap_q8_segments": (4, 2, 1000, 1000, True,
                                   dict(causal=True, window=300, logit_softcap=30.0, q_mult=8.0)),
    "dropout_segments": (4, 2, 1000, 1000, True, dict(causal=True, dropout_rate=0.1)),
    "lolo_terms": (4, 1, 256, 256, False, dict(causal=True, scale=1.0)),
}


def _doc_ids(s):
    """Segment ids of ``s`` tokens packed from PAIR_F32_DOCS, on the card."""
    n = torch.tensor(PAIR_F32_DOCS, device="cuda")
    return torch.repeat_interleave(torch.arange(len(PAIR_F32_DOCS), device="cuda"),
                                   n)[:s].to(torch.int32)


def _pair_f32_inputs(probes, gen, d, case):
    """q, k, v, dO (float32, on the card), the folded segment ids (or none)
    and the keywords of one PAIR_F32_CASES case at head_dim d."""
    bh, g, s_q, s_kv, segments, kw = PAIR_F32_CASES[case]
    if case == "lolo_terms":
        return (*probes.lolo_term_f32_qkvdo(bh, s_q, d, generator=gen, device="cuda"), {},
                dict(kw))
    kw = dict(dict(scale=d**-0.5), **kw)
    mult = kw.pop("q_mult", 1.0)
    q = mult * torch.randn((bh, g * s_q, d), generator=gen, device="cuda")
    k, v = (torch.randn((bh, s_kv, d), generator=gen, device="cuda") for _ in range(2))
    do = (0.25 / mult) * torch.randn(q.shape, generator=gen, device="cuda")
    if g > 1:
        kw["q_seq_len"] = s_q
    if "dropout_rate" in kw:
        kw["dropout_seed"] = DROPOUT_SEED
    segs = {}
    if segments:
        ids = _doc_ids(s_q)
        segs = dict(q_segment_ids=ids.repeat(bh, g), kv_segment_ids=ids.repeat(bh, 1))
    return q, k, v, do, segs, kw


def _pair_f32_counts(backward):
    return tuple(getattr(fn, a) for fn in (backward.dq_kernel, backward.dkv_kernel)
                 for a in ("launches", "launches_tc_f32", "launches_tc_f32_dropout"))


def _norm_rel(got, want) -> float:
    want = want.double()
    return float((got.double() - want).norm() / want.norm())


@contextlib.contextmanager
def _other_product_count(backward, d):
    """The plain pair with the other product count: three at d = 64, four
    at d = 128 (``ops.backward._dot3`` / ``_dot4``)."""
    saved = backward._dot3, backward._dot4
    backward._dot3 = backward._dot4 = saved[0] if d == 64 else saved[1]
    try:
        yield
    finally:
        backward._dot3, backward._dot4 = saved


def _pair_f32_hold(flash, backward, q, k, v, do, segs, kw, mode, check):
    """One case's records, dQ's and dK/dV's, against the plain pair in
    ``mode``; with segment ids, dQ twice on its own and dK/dV on its own."""
    d = q.shape[-1]
    o, l, m = flash.flash_attention(q, k, v, save_residuals=True, precision=mode, **kw, **segs)
    lse = m + torch.log(torch.where(l == 0, 1.0, l))
    n0 = _pair_f32_counts(backward)
    got = backward.flash_attention_bwd(q, k, v, o, lse, do, fused=False, precision=mode, **kw,
                                       **segs)
    n1 = _pair_f32_counts(backward)
    plain = dict(fused=False, precision=mode, **kw, **segs)
    want = backward.flash_attention_bwd_plain(q, k, v, o, lse, do, **plain)
    with _other_product_count(backward, d):
        other = backward.flash_attention_bwd_plain(q, k, v, o, lse, do, **plain)
    drop = int("dropout_rate" in kw)
    launched = [b - a for a, b in zip(n0, n1)] == [1, 1, drop] * 2
    recs = []
    for kname, part in zip(PAIR_F32.values(), (slice(0, 1), slice(1, 3))):
        g_, w_, o_ = got[part], want[part], other[part]
        rec = _bwd_rec(f"{kname}/{check}", g_, w_, "float32",
                       grad_absmax=[float(w.abs().max()) for w in w_], launched_its_form=launched,
                       norm_rel_err=max(_norm_rel(a, b) for a, b in zip(g_, w_)),
                       other_count_norm_rel_err=min(_norm_rel(a, b) for a, b in zip(g_, o_)))
        rec["ok"] = rec["ok"] and launched and all(x.dtype == torch.float32 for x in g_)
        if check.startswith("lolo_terms/") and mode == "bf16_3x":
            rec["norm_tol"] = PAIR_F32_LOLO_TOL
            rec["ok"] = rec["ok"] and rec["norm_rel_err"] <= PAIR_F32_LOLO_TOL
        recs.append(rec)
    if segs:
        di = (o * do).sum(dim=-1)
        dq2 = [backward.dq_kernel(q, k, v, do, lse, di, precision=mode, **kw, **segs)
               for _ in range(2)]
        dkv = backward.dkv_kernel(q, k, v, do, lse, di, precision=mode, **kw, **segs)
        recs[0]["deterministic"] = bool(torch.equal(dq2[0], dq2[1]) and torch.equal(dq2[0], got[0]))
        recs[1]["alone_bitwise"] = bool(torch.equal(dkv[0], got[1]) and torch.equal(dkv[1], got[2]))
        recs[0]["ok"] = recs[0]["ok"] and recs[0]["deterministic"]
        recs[1]["ok"] = recs[1]["ok"] and recs[1]["alone_bitwise"]
    return recs


def _pair_f32_poison(flash, backward, gen, d, mode):
    """NaN past kv_len, and in the next heads behind a ragged S with
    segment ids: the first head's dQ, dK and dV bitwise the clean inputs'."""
    recs = []
    for past in ("kv_len", "s"):
        if past == "kv_len":
            q, k, v, do, segs, kw = _pair_f32_inputs(None, gen, d, "kv_len_q_offset")
        else:
            q, k, v, do = (torch.randn((4, 200, d), generator=gen, device="cuda") for _ in range(4))
            do *= 0.25
            ids = _doc_ids(200)
            segs = dict(q_segment_ids=ids.repeat(4, 1), kv_segment_ids=ids.repeat(4, 1))
            kw = dict(causal=False, scale=d**-0.5)
        kw.update(dropout_rate=0.1, dropout_seed=DROPOUT_SEED)
        outs = []
        for poison in (False, True):
            qp, kp, vp, dop = (x.clone() for x in (q, k, v, do))
            if poison:
                if past == "kv_len":
                    kp[:, kw["kv_len"]:] = float("nan")
                    vp[:, kw["kv_len"]:] = float("nan")
                for x in (qp, kp, vp, dop):
                    x[1:] = float("nan")
            o, l, m = flash.flash_attention(qp, kp, vp, save_residuals=True, precision=mode,
                                            **kw, **segs)
            lse = m + torch.log(torch.where(l == 0, 1.0, l))
            outs.append(backward.flash_attention_bwd(qp, kp, vp, o, lse, dop, fused=False,
                                                     precision=mode, **kw, **segs))
        torch.cuda.synchronize()
        (dq0, dk0, dv0), (dq1, dk1, dv1) = outs
        for kname, same in zip(PAIR_F32.values(), (
                torch.equal(dq1[0], dq0[0]),
                torch.equal(dk1[0], dk0[0]) and torch.equal(dv1[0], dv0[0]))):
            recs.append({"check": f"{kname}/nan_poison/past_{past}/d{d}/{mode}",
                         "first_head_bitwise": bool(same), "ok": bool(same)})
    return recs


def _pair_f32_keep_bits(flash, backward, gen, d, mode):
    """With V and dO the identity (S_q = S_kv = d, no mask) the pair's dV[j,
    i] is Z's (i, j): its zeros must be exactly the plain version's
    dropped pairs."""
    bh, rate = 4, 0.5
    q, k = (torch.randn((bh, d, d), generator=gen, device="cuda") for _ in range(2))
    eye = torch.eye(d, device="cuda").expand(bh, d, d).contiguous()
    kw = dict(causal=False, scale=d**-0.5, dropout_rate=rate, dropout_seed=DROPOUT_SEED)
    o, l, m = flash.flash_attention(q, k, eye, save_residuals=True, precision=mode, **kw)
    _, _, dv = backward.flash_attention_bwd(q, k, eye, o, m + torch.log(l), eye, fused=False,
                                            precision=mode, **kw)
    keep = flash.dense_keep(DROPOUT_SEED, rate, range(bh), d, d, d, None, "cuda")
    torch.cuda.synchronize()
    rec = {"check": f"flash_bwd_dkv_tc_f32/keep_bits/d{d}/{mode}",
           "dropped": int((~keep).sum()), "pairs": keep.numel(),
           "bwd_keep_equal": bool(torch.equal(dv.transpose(1, 2) != 0, keep))}
    rec["ok"] = rec["bwd_keep_equal"] and 0 < rec["dropped"] < rec["pairs"]
    return rec


def pair_f32_checks(backward, flash, probes, gen, report, dims=PAIR_F32_DIMS):
    """The pair's float32 forms at the head_dims ``dims`` in both modes (see
    above), untimed (their timed rows: bwd_checks' and dropout_checks'
    packed layer at B = 2, and at d = 256 bwd_window_checks' and
    dropout_checks' Gemma-2 packed layer); ``torch_tools/f32_mutants.py``
    shows that these checks fail a pass missing one of its products (lo lo
    at d = 64 among them), dO's lo term or a live tile."""
    recs = []
    for d, mode in itertools.product(dims, F32_TRAIN_MODES):
        for case in PAIR_F32_CASES:
            q, k, v, do, segs, kw = _pair_f32_inputs(probes, gen, d, case)
            recs += _pair_f32_hold(flash, backward, q, k, v, do, segs, kw, mode,
                                   f"{case}/d{d}/{mode}")
            del q, k, v, do
        recs += _pair_f32_poison(flash, backward, gen, d, mode)
        recs.append(_pair_f32_keep_bits(flash, backward, gen, d, mode))
    for rec in recs:
        emit(rec)
        report["checks"].append(rec)
    torch.cuda.empty_cache()
    return recs


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
# The tensor-core forms a bf16 block mask runs, and the other head_dims
# they are held at (B*H = BM_SMALL_BH).
BM_TC = ("flash_fwd_tc", "flash_bwd_dq_tc", "flash_bwd_dkv_tc")
BM_TC_DIMS = (64, 256)
BM_SMALL_BH = 8


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
    ``timed``.  Returns ``{tensor-core form: {mask: timed record}}``."""
    timed_recs = {tc: {} for tc in BM_TC}
    masks = {n: flash.BlockMask.from_mask_fn(fn, BM_S, BM_S) for n, fn in BM_MASKS.items()}
    for dt in ("bfloat16", "float32"):
        for s in (BM_S, BM_RAGGED_S):
            q, k, v, do = _bm_inputs(gen, BM_B * BM_H, s, BM_D, dt)
            base = dict(causal=False, scale=BM_D**-0.5, kv_len=None, q_offset=0, q_seq_len=None)
            no_mask = None
            cases = [(m, dict(base, block_mask=bm)) for m, bm in masks.items()]
            if dt == "bfloat16" and s == BM_S:
                cases.append(("strided_dropout", dict(base, block_mask=masks["strided"],
                                                      dropout_rate=0.1, dropout_seed=DROPOUT_SEED)))
            for mname, kw in cases:
                shape = f"B={BM_B} H={BM_H} S={s} d={BM_D}, {mname} mask built at {BM_S}"
                recs, ins, fwd_plain, plain = _bm_case(backward, flash, q, k, v, do, kw, dt,
                                                       f"{mname}/s{s}", shape)
                if timed and dt == "bfloat16" and s == BM_S and mname in masks:
                    if no_mask is None:
                        no_mask = _bm_no_mask_times(backward, flash, benchit, ins, base)
                    _time_block_mask(backward, flash, benchit, card, recs, ins, kw, fwd_plain,
                                     plain, no_mask)
                    for kname in BM_TC:
                        timed_recs[kname][mname] = recs[kname]
                for rec in recs.values():
                    emit(rec)
                    report["checks"].append(rec)
                del ins, plain, fwd_plain
                torch.cuda.empty_cache()
            del q, k, v, do
            torch.cuda.empty_cache()
    # Every instantiation of the tensor-core forms: d = 64 and 256 at B*H = 8.
    for d in BM_TC_DIMS:
        for s in (BM_S, BM_RAGGED_S):
            q, k, v, do = _bm_inputs(gen, BM_SMALL_BH, s, d, "bfloat16")
            base = dict(causal=False, scale=d**-0.5, kv_len=None, q_offset=0, q_seq_len=None)
            cases = [(m, dict(base, block_mask=bm)) for m, bm in masks.items()]
            if s == BM_S:
                cases.append(("strided_dropout", dict(base, block_mask=masks["strided"],
                                                      dropout_rate=0.1, dropout_seed=DROPOUT_SEED)))
            for mname, kw in cases:
                shape = f"B*H={BM_SMALL_BH} S={s} d={d}, {mname} mask built at {BM_S}"
                recs = _bm_case(backward, flash, q, k, v, do, kw, "bfloat16", f"{mname}/s{s}/d{d}",
                                shape)[0]
                for rec in recs.values():
                    emit(rec)
                    report["checks"].append(rec)
            del q, k, v, do
            torch.cuda.empty_cache()
    checks = [_bm_skip_check(timed_recs, masks)] if timed else []
    checks.append(_bm_poison_check(backward, flash, gen))
    for rec in checks:
        emit(rec)
        report["checks"].append(rec)
    return timed_recs


def _bm_inputs(gen, bh, s, d, dt):
    """q, k, v and do (a quarter of their scale) of a block-mask case."""
    def rand(shape, mult=1.0):
        return (mult * torch.randn(shape, generator=gen, device="cuda")).to(DTYPES[dt])

    return (*(rand((bh, s, d)) for _ in range(3)), rand((bh, s, d), 0.25))


def _bm_case(backward, flash, q, k, v, do, kw, dt, case, shape):
    """One block-mask case: the forward and the two-pass pair against their
    plain versions, each kernel's check named by the form that ran (in bf16
    the tensor-core forms, and the scalar forms beside them under
    ``ops.flash.scalar_forms``).  Returns ``(records by kernel name, the
    backward's inputs, the forward's plain version, the pair's)``."""
    fwd = _kname("flash_fwd", q, block_mask=True)
    recs = {}
    recs[fwd], fwd_plain = _fwd_rec(f"{fwd}/block_mask/{case}/{dt}", flash, q, k, v, kw, {}, dt,
                                    shape=shape)
    if fwd != "flash_fwd":
        with flash.scalar_forms():
            recs["flash_fwd"] = _fwd_rec(f"flash_fwd/block_mask/{case}/{dt}", flash, q, k, v, kw,
                                         {}, dt, shape=shape,
                                         form="scalar (ops.flash.scalar_forms)")[0]
    ins, plain, wants, runs = _bwd_case(backward, flash, q, k, v, do, kw, {})
    for kname, (gots, want) in _bwd_got(q, kw, runs, wants).items():
        recs[kname] = _bwd_rec(f"{kname}/block_mask/{case}/{dt}", gots, want, dt, shape=shape,
                               grad_absmax=[float(w.abs().max()) for w in want])
    del wants, runs
    return recs, ins, fwd_plain, plain


def _bm_skip_check(timed_recs, masks):
    """Under the documents mask each tensor-core form takes at most
    BM_SKIP_RATIO of its no-mask time."""
    docs = {k: timed_recs[k]["documents"] for k in timed_recs}
    fwd, dq, dkv = (docs[k] for k in BM_TC)
    fwd_ratio = fwd["kernel_ms"] / fwd["no_mask_ms"]
    bwd_ratio = ((dq["kernel_ms"] + dkv["kernel_ms"]) / (dq["no_mask_ms"] + dkv["no_mask_ms"]))
    rec = {"check": "block_mask/documents/dead_tiles_skipped", "forms": list(BM_TC),
           "flash_fwd_ratio": fwd_ratio, "dq_plus_dkv_ratio": bwd_ratio,
           "max_ratio": BM_SKIP_RATIO, "live_fraction": masks["documents"].element_live_fraction,
           "ok": fwd_ratio <= BM_SKIP_RATIO and bwd_ratio <= BM_SKIP_RATIO}
    return rec


def _bm_no_mask_times(backward, flash, benchit, ins, base):
    """The three kernels with no mask on the same inputs, in the forms a
    block mask runs in bf16 (the tensor-core forms), so that the ratio
    measures the skipped tiles."""
    q, k, v, o, lse, do = ins
    di = (o.float() * do.float()).sum(dim=-1)
    return {
        "flash_fwd": benchit.cuda_time_ms(lambda: flash.flash_attention(q, k, v, **base),
                                          warmup=1, iters=3),
        "flash_bwd_dq": benchit.cuda_time_ms(
            lambda: backward.dq_kernel(q, k, v, do, lse, di, **base), warmup=1, iters=3),
        "flash_bwd_dkv": benchit.cuda_time_ms(
            lambda: backward.dkv_kernel(q, k, v, do, lse, di, **base), warmup=1, iters=3),
    }


def _bm_calls(backward, q, k, v, o, lse, do, kw):
    """The three kernels' calls on a block-mask case's inputs."""
    from flashattention_tpu_torch.ops import flash

    di = (o.float() * do.float()).sum(dim=-1)
    return {"flash_fwd": lambda: flash.flash_attention(q, k, v, **kw),
            "flash_bwd_dq": lambda: backward.dq_kernel(q, k, v, do, lse, di, **kw),
            "flash_bwd_dkv": lambda: backward.dkv_kernel(q, k, v, do, lse, di, **kw)}


def _time_block_mask(backward, flash, benchit, card, recs, ins, kw, fwd_plain, bwd_plain, no_mask):
    """Each tensor-core form's time with the mask, beside its no-mask time,
    the scalar form's (``scalar_ms``), the plain versions' and SDPA's with
    the boolean mask, and its bound over the mask's live pairs."""
    q, k, v, o, lse, do = ins
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
    calls = _bm_calls(backward, q, k, v, o, lse, do, kw)
    di = (o.float() * do.float()).sum(dim=-1)
    work = {"flash_fwd": ((q, k, v), (q,), 4, fwd_lib,
                          benchit.cuda_time_ms(fwd_plain, warmup=1, iters=2)),
            "flash_bwd_dq": ((q, k, v, do, lse, di), (q,), 6, bwd_lib, bwd_plain_ms),
            "flash_bwd_dkv": ((q, k, v, do, lse, di), (k, v), 8, bwd_lib, bwd_plain_ms)}
    for kname, (reads, writes, per_pair, lib, plain_ms) in work.items():
        nbytes = sum(t.numel() * t.element_size() for t in reads + writes)
        with flash.scalar_forms():
            scalar_ms = benchit.cuda_time_ms(calls[kname], warmup=1, iters=3)
        recs[_kname(kname, q, block_mask=True)].update(
            kernel_ms=benchit.cuda_time_ms(calls[kname], warmup=1, iters=5), scalar_ms=scalar_ms,
            no_mask_ms=no_mask[kname], plain_ms=plain_ms, library_ms=lib, live_pairs=pairs,
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
    backward, with the launch counters zeroed just before: the tensor-core
    forms' dropout / block-mask builds (``*_tc_extra``) launch once each."""
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
    # One launch of each tensor-core form, with dropout and the mask; none scalar.
    want.update({f"{k}{f}": 1 for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
                 for f in ("", "_dropout", "_block_mask", "_tc", "_tc_block_mask")})
    want.update({f"{k}_tc_dropout": 1 for k in PAIR})
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


def _train_rec(phase, cfg, benchit, card, wall, steps, losses, launches, want, attn_fwd, extra,
               model=TRAIN_MODEL, batch=TRAIN_B, seq=TRAIN_S, flops=None):
    """bench_train.py's accounting: 6 N_matmul tokens + 3.5 x attention
    forward, unless the step's ``flops`` are given."""
    from flashattention_tpu_torch.cli.bench_train import matmul_params

    _tc_expect(want, cfg)
    tokens = batch * seq
    if flops is None:
        flops = 6 * matmul_params(cfg, cfg.num_experts) * tokens + 3.5 * attn_fwd
    tflops = flops * steps / wall / 1e12
    finite = all(np.isfinite(x) for x in losses)
    if cfg.num_experts is not None:  # the top-k experts' share: a routed MoE's work
        extra = {**extra, "routed_tflop_per_step": (
            6 * matmul_params(cfg, cfg.experts_per_token) * tokens + 3.5 * attn_fwd) / 1e12}
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


def _stepper(train, cfg, params, optimizer, packed, **kw):
    """``call(*data)``: the SGD step (lr 1e-3) on ``params``, or with
    ``optimizer`` the optimizer step threading its state."""
    if optimizer is None:
        make = train.make_train_step_packed if packed else train.make_train_step
        step = make(cfg, lr=1e-3, **kw)
        return lambda *data: step(params, *data)
    if packed:
        step = train.make_train_step_packed(cfg, optimizer=optimizer, **kw)
    else:
        step = train.make_train_step_optax(cfg, optimizer, **kw)
    state = train.init_opt_state(optimizer, params)
    return lambda *data: step(params, state, *data)


def _falls(rec, optimizer):
    """An optimizer phase's loss must fall over its counted steps."""
    if optimizer is not None:
        rec["loss_falls"] = rec["losses"][-1] < rec["losses"][0]
        rec["ok"] = rec["ok"] and rec["loss_falls"]


def phase_train(args, cfg, params, train, benchit, counters, card, report, *, remat,
                phase=None, model=TRAIN_MODEL, batch=TRAIN_B, seq=TRAIN_S, profile=None,
                attn_dropout=None, optimizer=None):
    """The plain step: one warm-up step, then TRAIN_STEPS counted steps; a
    profile of one more step (by default, without remat).  With
    ``attn_dropout``, seed = step index (the warm-up's 0).  With
    ``optimizer`` (``train.adamw(...)``), the optimizer step, and the loss
    must fall over the counted steps."""
    rng = np.random.default_rng(args.seed + 20)
    tokens = torch.tensor(rng.integers(0, cfg.vocab_size, (batch, seq)), dtype=torch.int32,
                          device="cuda")
    call = _stepper(train, cfg, params, optimizer, False, remat=remat, attn_dropout=attn_dropout)
    call(tokens, *_seeded(attn_dropout, 0))  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = []
    wall, launches = _drive(counters, lambda: out.extend(
        call(tokens, *_seeded(attn_dropout, i + 1))[0] for i in range(TRAIN_STEPS)))
    layers = cfg.num_layers
    want = dict.fromkeys(counters, 0)
    want.update(flash_fwd=(2 if remat else 1) * layers * TRAIN_STEPS, flash_bwd=layers * TRAIN_STEPS)
    if attn_dropout:
        want.update(flash_fwd_dropout=want["flash_fwd"], flash_bwd_dropout=want["flash_bwd"])
    phase = phase or ("train_remat" if remat else "train")
    rec = _train_rec(phase, cfg, benchit, card, wall, TRAIN_STEPS, [float(x) for x in out],
                     launches, want, _attn_fwd_flops(benchit, cfg, batch, seq),
                     {"remat": remat, "attn_dropout": attn_dropout,
                      "optimizer": None if optimizer is None else repr(optimizer)},
                     model, batch, seq)
    _falls(rec, optimizer)
    emit(rec)
    report[phase] = rec
    if profile is None:
        profile = not remat
    if profile:

        def one_step(run):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call(tokens, *_seeded(attn_dropout, TRAIN_STEPS + 1 + run))
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e6

        report[f"profile_{phase}"] = _profile(one_step, f"profile/{phase}",
                                              {"steps": 1, "remat": remat})
    return rec


def phase_train_packed(args, cfg, params, train, packing, flash, benchit, counters, card, report,
                       *, phase="train_packed", model=TRAIN_MODEL, batch=TRAIN_B, seq=TRAIN_S,
                       docs=None, attn_dropout=None, optimizer=None):
    """The packed step over ``batch`` rows packed from random documents of
    64-2048 tokens, or with ``docs`` one row of documents of those lengths;
    ``attn_dropout`` and ``optimizer`` as in phase_train."""
    if docs is None:
        tok_np, seg_np = _packed_ids(packing, args.seed + 21, batch, seq, cfg.vocab_size)
    else:
        rng = np.random.default_rng(args.seed + 21)
        tok_np, seg_np = packing.pack_documents(
            [rng.integers(0, cfg.vocab_size, size=n) for n in docs], seq)
    tokens = torch.tensor(tok_np, device="cuda")
    segs = torch.tensor(seg_np, device="cuda")
    call = _stepper(train, cfg, params, optimizer, True, attn_dropout=attn_dropout)
    call(tokens, segs, *_seeded(attn_dropout, 0))  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = []
    wall, launches = _drive(counters, lambda: out.extend(
        call(tokens, segs, *_seeded(attn_dropout, i + 1))[0] for i in range(TRAIN_STEPS)))
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
                         "optimizer": None if optimizer is None else repr(optimizer),
                     }, model, batch, seq)
    _falls(rec, optimizer)
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


MIXTRAL_ADAMW = dict(learning_rate=1e-4, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)


def phase_train_mixtral(args, transformer, train, packing, flash, benchit, counters, card,
                        report):
    """Mixtral-8x7B-class at full width in 2 layers, bf16, B = 1, S = 8192
    (train_mistral's row; the dense MoE computes all 8 experts on every
    token), with the AdamW step (``train.adamw``): train_mixtral, the plain
    step (the fused backward; a profile of one step), and
    train_mixtral_packed, the packed step on WTRAIN_DOCS (the two-pass
    pair).  Each: one warm-up step, then TRAIN_STEPS counted, over which
    the loss must fall."""
    cfg = transformer.ModelConfig.mixtral8x7b(num_layers=2)
    out = {}
    for phase in ("train_mixtral", "train_mixtral_packed"):
        params = transformer.init_params(args.seed, cfg)
        opt = train.adamw(**MIXTRAL_ADAMW)
        if phase == "train_mixtral":
            out[phase] = phase_train(args, cfg, params, train, benchit, counters, card, report,
                                     remat=False, phase=phase, model=MIXTRAL_MODEL,
                                     batch=WTRAIN_B, seq=WTRAIN_S, optimizer=opt)
        else:
            out[phase] = phase_train_packed(args, cfg, params, train, packing, flash, benchit,
                                            counters, card, report, phase=phase,
                                            model=MIXTRAL_MODEL, batch=WTRAIN_B, seq=WTRAIN_S,
                                            docs=WTRAIN_DOCS, optimizer=opt)
        del params
        torch.cuda.empty_cache()
    return out


LORA_MODEL = "mistral7b(num_layers=32), sliding_window=None; LoRA rank 8 on wq, wv, alpha 16"
LORA_RANK, LORA_ALPHA = 8, 16.0
LORA_ADAMW = dict(learning_rate=1e-3)  # optax.adamw's other defaults
LORA_SERVE_NEW = 16
LORA_LOGITS_RTOL = 2e-2  # the bf16 gate, of the logits' largest magnitude


def _lora_cfg(transformer, num_layers=32, dtype="bfloat16"):
    """Mistral-7B's published widths and depth, the window off (as the
    train phase takes it)."""
    return dataclasses.replace(transformer.ModelConfig.mistral7b(num_layers=num_layers),
                               sliding_window=None, dtype=dtype)


def _checksums(tensors):
    """Each tensor's 16-bit words summed on the card, each weighted by its
    position (mod 65521, plus one), as int64: a changed word changes its
    tensor's sum unless another change cancels it."""
    out = []
    for t in tensors:
        words = t.reshape(-1).view(torch.int16).to(torch.int64)
        pos = torch.arange(words.numel(), device=t.device) % 65521 + 1
        out.append((words * pos).sum())
        del words, pos
    return torch.stack(out).tolist()


def _lora_flops(cfg, batch, seq, targets, attn_fwd):
    """A remat LoRA step's work: the forward (2 N tokens), each layer's
    recompute (2 N_layers tokens), the products' input gradients (2 N
    tokens), the weight gradients of the targets alone (the base takes
    none), and attention 4.5 x its forward (forward, recompute, backward
    2.5); the adapters' own products (rank 8) are left out."""
    from flashattention_tpu_torch.cli.bench_train import matmul_params

    tokens = batch * seq
    n_all = matmul_params(cfg)
    n_layers = n_all - cfg.d_model * cfg.vocab_size
    widths = {"wq": cfg.num_q_heads * cfg.head_dim, "wk": cfg.num_kv_heads * cfg.head_dim,
              "wv": cfg.num_kv_heads * cfg.head_dim}
    n_targets = cfg.num_layers * sum(cfg.d_model * widths[t] for t in targets)
    return 2 * tokens * (2 * n_all + n_layers + n_targets) + 4.5 * attn_fwd


def phase_train_lora(args, transformer, train, benchit, counters, card, report):
    """LoRA fine-tuning of Mistral-7B's widths at its published 32 layers,
    bf16, B = 8, S = 2048, remat, rank 8 on wq and wv, alpha 16, AdamW on
    the adapters: one warm-up step, then TRAIN_STEPS counted, and a profile
    of one more.  The loss must fall over the four steps, every base tensor
    keep its checksum, and B move from zero.  Returns the record, the base
    and the trained adapters (for serve_lora_merged)."""
    cfg = _lora_cfg(transformer)
    t0 = time.perf_counter()
    base = transformer.init_params(args.seed, cfg)
    lora = train.init_lora(args.seed + 1, base, rank=LORA_RANK)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    sums = _checksums(train.leaves(base))
    opt = train.adamw(**LORA_ADAMW)
    state = train.init_opt_state(opt, lora)
    step = train.make_train_step_lora(cfg, alpha=LORA_ALPHA, optimizer=opt, remat=True)
    rng = np.random.default_rng(args.seed + 20)
    tokens = torch.tensor(rng.integers(0, cfg.vocab_size, (TRAIN_B, TRAIN_S)), dtype=torch.int32,
                          device="cuda")
    warm = float(step(base, lora, state, tokens)[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = []
    wall, launches = _drive(counters, lambda: out.extend(
        step(base, lora, state, tokens)[0] for _ in range(TRAIN_STEPS)))
    losses = [warm] + [float(x) for x in out]
    layers = cfg.num_layers
    want = dict.fromkeys(counters, 0)
    want.update(flash_fwd=2 * layers * TRAIN_STEPS, flash_bwd=layers * TRAIN_STEPS)
    attn_fwd = _attn_fwd_flops(benchit, cfg, TRAIN_B, TRAIN_S)
    base_same = _checksums(train.leaves(base)) == sums
    b_moved = all(bool(ab["b"].any()) for adapters in lora for ab in adapters.values())
    rec = _train_rec("train_lora", cfg, benchit, card, wall, TRAIN_STEPS, losses[1:], launches,
                     want, attn_fwd, {
                         "remat": True, "rank": LORA_RANK, "alpha": LORA_ALPHA,
                         "targets": ["wq", "wv"], "optimizer": repr(opt), "init_s": init_s,
                         "base_params": sum(t.numel() for t in train.leaves(base)),
                         "adapter_params": sum(t.numel() for t in train.leaves(lora)),
                         "base_gb": sum(t.numel() * t.element_size()
                                        for t in train.leaves(base)) / 1e9,
                         "flops_counted": "forward, each layer's recompute, input gradients, "
                                          "wq/wv weight gradients (no base dW), attention x 4.5",
                         "losses_with_warmup": losses, "base_checksums_equal": base_same,
                         "b_moved_from_zero": b_moved,
                     }, LORA_MODEL, flops=_lora_flops(cfg, TRAIN_B, TRAIN_S, ("wq", "wv"),
                                                      attn_fwd))
    rec["loss_falls"] = all(b < a for a, b in zip(losses, losses[1:]))
    rec["ok"] = rec["ok"] and rec["loss_falls"] and base_same and b_moved
    emit(rec)
    report["train_lora"] = rec

    def one_step(run):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        step(base, lora, state, tokens)
        torch.cuda.synchronize()
        return (time.perf_counter() - t1) * 1e6

    report["profile_train_lora"] = _profile(one_step, "profile/train_lora",
                                            {"steps": 1, "remat": True})
    del state
    return rec, base, lora


def phase_serve_lora_merged(args, transformer, train, quant, engine_mod, kvcache, counters,
                            report, base, lora):
    """``merge_lora`` of train_lora's adapters into its 32-layer base, served
    whole-prompt (prefill_chunk=0, bf16 cache) on four of serve_chunked's
    prompts, LORA_SERVE_NEW new tokens each; then the same on
    ``quantize_weights(merged)`` (int8, ``tests/test_quant.py:247``'s
    export path).  Each prompt's logits from the merged model's prefill
    must match ``forward_logits`` of base and adapters (the training
    forward, merging per layer) within LORA_LOGITS_RTOL of their largest
    magnitude, and the engine's first token must be that forward's greedy
    token."""
    cfg = _lora_cfg(transformer)
    t0 = time.perf_counter()
    merged = train.merge_lora(base, lora, LORA_ALPHA)
    torch.cuda.synchronize()
    merge_s = time.perf_counter() - t0
    prompts = _chunked_prompts(args, cfg.vocab_size)[0][:4]
    checks, greedy = [], []
    with torch.no_grad():
        for p in prompts:
            tokens = torch.tensor([p], dtype=torch.int32, device="cuda")
            want = train.lora._lora_logits(base, lora, tokens, cfg, alpha=LORA_ALPHA)
            got = transformer.prefill(merged, tokens, cfg)[0]
            scale = float(want.float().abs().max())
            e = err(got, want)
            greedy.append(int(want[0, -1].float().argmax()))
            checks.append({"prompt_len": len(p), "max_abs_err": e, "logits_max_abs": scale,
                           "tol": LORA_LOGITS_RTOL * scale, "bitwise": bool(torch.equal(got, want)),
                           "ok": e <= LORA_LOGITS_RTOL * scale})
            del want, got
    recs = {}
    for phase, params in (("serve_lora_merged", merged), ("serve_lora_merged_int8", None)):
        extra = {"prompt_lens": [len(p) for p in prompts], "new_tokens": LORA_SERVE_NEW,
                 "weights": "bf16, merged" if params is not None else "int8, merged"}
        if params is None:
            t0 = time.perf_counter()
            params = quant.quantize_weights(merged, "int8")
            torch.cuda.synchronize()
            extra["quantize_s"] = time.perf_counter() - t0
        ccfg = kvcache.CacheConfig(num_layers=cfg.num_layers, num_kv_heads=cfg.num_kv_heads,
                                   head_dim=cfg.head_dim, page_size=PAGE_SIZE, num_pages=64,
                                   dtype="bfloat16")
        eng = _finite_engine(engine_mod)(
            params, cfg, ccfg,
            engine_mod.EngineConfig(max_batch=4, pages_per_seq=8, prefill_chunk=0))
        ids = [eng.add_request(p, LORA_SERVE_NEW) for p in prompts]
        torch.cuda.reset_peak_memory_stats()
        wall, launches = _drive(counters, eng.run)
        full = _finished(eng, ids, LORA_SERVE_NEW)
        st = eng.stats()
        want = dict.fromkeys(counters, 0)
        want.update(flash_fwd=cfg.num_layers * st["prefill_batches"],
                    paged_decode=cfg.num_layers * st["decode_batches"])
        first = [eng.requests[i].output[0] for i in ids]
        rec = _serve_rec(phase, cfg, st, full, wall, launches, want,
                         {**extra, "first_tokens": first, "logits_finite": bool(eng.finite),
                          "native": _engine_native(eng)},
                         LORA_MODEL)
        rec["ok"] = (full and rec["logits_finite"] and launches == want
                     and st["free_pages"] == ccfg.num_pages)
        if phase == "serve_lora_merged":
            rec.update(merge_s=merge_s, logits_checks=checks, forward_first_tokens=greedy,
                       first_tokens_equal=first == greedy)
            rec["ok"] = rec["ok"] and all(c["ok"] for c in checks) and first == greedy
        emit(rec)
        report[phase] = rec
        recs[phase] = rec
        del eng
    del merged, params
    torch.cuda.empty_cache()
    return recs


def phase_train_mixed(args, transformer, train, packing, flash, benchit, counters, card, report):
    """The train phase's model (Mistral-7B widths, 2 layers, no window, B =
    8, S = 2048) with float32 masters and ``compute_dtype="bfloat16"``
    through ``make_train_step`` (SGD), ``make_train_step_optax`` (AdamW) and
    ``make_train_step_packed``: each one warm-up step, then TRAIN_STEPS
    counted.  The SGD step's first loss must equal, bit for bit, that of
    the masters cast to bf16 through the bf16 step (the same bf16 inputs
    meet the same kernels); the masters must stay float32 and move; one
    step with remat and dropout 0.1 must be finite."""
    cfg32 = _train_cfg(transformer, "float32")
    cfg16 = _train_cfg(transformer)
    params = transformer.init_params(args.seed, cfg32)
    rng = np.random.default_rng(args.seed + 20)
    tokens = torch.tensor(rng.integers(0, cfg32.vocab_size, (TRAIN_B, TRAIN_S)),
                          dtype=torch.int32, device="cuda")
    cast = train.common._cast_floats(params, "bfloat16")
    loss16 = float(train.make_train_step(cfg16, lr=1e-3)(cast, tokens)[0])
    del cast
    torch.cuda.empty_cache()
    before = params["layers"][0]["wq"].clone()
    out = {}
    for phase, kind in (("train_mixed", "sgd"), ("train_mixed_optax", "adamw"),
                        ("train_mixed_packed", "packed")):
        opt = train.adamw(1e-4) if kind == "adamw" else None
        call = _stepper(train, cfg32, params, opt, kind == "packed", compute_dtype="bfloat16")
        if kind == "packed":
            tok_np, seg_np = _packed_ids(packing, args.seed + 21, TRAIN_B, TRAIN_S,
                                         cfg32.vocab_size)
            data = (torch.tensor(tok_np, device="cuda"), torch.tensor(seg_np, device="cuda"))
        else:
            data = (tokens,)
        first = float(call(*data)[0])  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses = []
        wall, launches = _drive(counters, lambda: losses.extend(
            call(*data)[0] for _ in range(TRAIN_STEPS)))
        layers = cfg32.num_layers
        want = dict.fromkeys(counters, 0)
        if kind == "packed":
            want.update(flash_fwd=layers * TRAIN_STEPS, flash_bwd_dq=layers * TRAIN_STEPS,
                        flash_bwd_dkv=layers * TRAIN_STEPS)
            segs = data[1]
            attn_fwd = layers * 4 * cfg32.head_dim * cfg32.num_q_heads * _live_pairs(
                flash, TRAIN_B, TRAIN_S, TRAIN_S,
                dict(causal=True, kv_len=None, q_offset=0, q_seq_len=TRAIN_S, window=None),
                dict(q_segment_ids=segs, kv_segment_ids=segs))
        else:
            want.update(flash_fwd=layers * TRAIN_STEPS, flash_bwd=layers * TRAIN_STEPS)
            attn_fwd = _attn_fwd_flops(benchit, cfg32, TRAIN_B, TRAIN_S)
        # The kernels run in bf16: their tensor-core forms' launches.
        rec = _train_rec(phase, cfg16, benchit, card, wall, TRAIN_STEPS,
                         [float(x) for x in losses], launches, want, attn_fwd,
                         {"compute_dtype": "bfloat16", "masters": "float32",
                          "optimizer": repr(opt) if opt else "sgd lr 1e-3",
                          "first_loss": first}, TRAIN_MODEL + ", float32 masters")
        rec["dtype"] = "float32 masters, bfloat16 compute"
        if kind == "sgd":
            rec["bf16_model_first_loss"] = loss16
            rec["first_loss_diff"] = first - loss16
            rec["first_loss_bitwise"] = first == loss16
            rec["ok"] = rec["ok"] and first == loss16
        _falls(rec, opt)
        rec["masters_float32"] = all(t.dtype == torch.float32 for t in train.leaves(params))
        rec["masters_moved"] = not torch.equal(params["layers"][0]["wq"], before)
        rec["ok"] = rec["ok"] and rec["masters_float32"] and rec["masters_moved"]
        emit(rec)
        report[phase] = rec
        out[phase] = rec
    drop = train.make_train_step(cfg32, lr=1e-3, remat=True, attn_dropout=0.1,
                                 compute_dtype="bfloat16")
    losses = []
    wall, launches = _drive(counters, lambda: losses.extend(
        float(drop(params, tokens, i)[0]) for i in range(2)))
    rec = {"phase": "train_mixed_remat_dropout", "compute_dtype": "bfloat16",
           "attn_dropout": 0.1, "remat": True, "losses": losses, "launches": launches,
           "step_ms": 1e3 * wall / 2, "ok": all(np.isfinite(x) for x in losses)
           and launches["flash_fwd_dropout"] == 2 * 2 * cfg32.num_layers}
    emit(rec)
    report[rec["phase"]] = rec
    out[rec["phase"]] = rec
    del params
    torch.cuda.empty_cache()
    return out


def phase_train_parity_lora(args, transformer, train, counters, report):
    """The LoRA step on the card against the CPU: Mistral-7B's widths in 1
    float32 layer (window off), B = 1, S = 256, rank 8 on wq and wv with A
    and B shifted by 0.01 off their init (so that B shapes the forward), two
    SGD steps (lr 1e-3) from the same tensors: losses within TRAIN_LOSS_RTOL
    and adapters within TRAIN_PARAM_TOL.  Then on the card the chain rule of
    ``tests/test_train.py:955``: one step at lr 1 gives dA and dB, the full
    step of the merged model at lr 1 gives dW, and dA = dW B^T (alpha/r),
    dB = A^T dW (alpha/r) within TRAIN_GRAD_RTOL of their largest
    magnitude; the first LoRA loss must be the merged model's within
    TRAIN_LOSS_RTOL."""
    cfg = _lora_cfg(transformer, num_layers=1, dtype="float32")
    t0 = time.perf_counter()
    base = transformer.init_params(args.seed, cfg, device="cpu")
    lora0 = train.init_lora(args.seed + 1, base, rank=LORA_RANK)
    lora0 = [{t: {k: v + 0.01 for k, v in ab.items()} for t, ab in adapters.items()}
             for adapters in lora0]
    tokens = np.random.default_rng(args.seed + 30).integers(0, cfg.vocab_size, (1, 256))
    tokens = tokens.astype(np.int32)

    def on(dev, tree):
        if isinstance(tree, list):
            return [{t: {k: v.to(dev, copy=True) for k, v in ab.items()}
                     for t, ab in adapters.items()} for adapters in tree]
        return {k: (v.to(dev, copy=True) if torch.is_tensor(v)
                    else [{n: w.to(dev, copy=True) for n, w in lay.items()} for lay in v])
                for k, v in tree.items()}

    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    runs = {}
    for dev in ("cpu", "cuda"):
        b, lo = on(dev, base), on(dev, lora0)
        step = train.make_train_step_lora(cfg, alpha=LORA_ALPHA, lr=1e-3, device=dev)
        tok = torch.tensor(tokens, device=dev)
        losses = [float(step(b, lo, tok)[0]) for _ in range(2)]
        runs[dev] = (losses, [t.cpu() for t in train.leaves(lo)])
        del b, lo
    loss_rel = max(abs(a - c) / abs(c) for a, c in zip(runs["cuda"][0], runs["cpu"][0]))
    lora_err = max(err(a, c) for a, c in zip(runs["cuda"][1], runs["cpu"][1]))
    # The chain rule on the card.
    b, lo = on("cuda", base), on("cuda", lora0)
    tok = torch.tensor(tokens, device="cuda")
    merged = train.merge_lora(b, lo, LORA_ALPHA)
    merged = {**merged, "layers": [{k: v.clone() for k, v in lay.items()}
                                   for lay in merged["layers"]]}
    w0 = {t: merged["layers"][0][t].clone() for t in ("wq", "wv")}
    ab0 = {t: {k: v.clone() for k, v in lo[0][t].items()} for t in ("wq", "wv")}
    loss_l = float(train.make_train_step_lora(cfg, alpha=LORA_ALPHA, lr=1.0)(b, lo, tok)[0])
    loss_f = float(train.make_train_step(cfg, lr=1.0)(merged, tok)[0])
    s = LORA_ALPHA / LORA_RANK
    chain = {}
    for t in ("wq", "wv"):
        d_w = w0[t] - merged["layers"][0][t]
        d_a = ab0[t]["a"] - lo[0][t]["a"]
        d_b = ab0[t]["b"] - lo[0][t]["b"]
        want_a, want_b = d_w @ ab0[t]["b"].T * s, ab0[t]["a"].T @ d_w * s
        chain[t] = {"dA_rel_err": err(d_a, want_a) / max(float(want_a.abs().max()), 1e-30),
                    "dB_rel_err": err(d_b, want_b) / max(float(want_b.abs().max()), 1e-30)}
    chain_ok = all(v <= TRAIN_GRAD_RTOL for c in chain.values() for v in c.values())
    merged_rel = abs(loss_l - loss_f) / abs(loss_f)
    rec = {"phase": "train_parity_lora", "model": "mistral7b widths, 1 layer, no window",
           "dtype": "float32", "batch": 1, "seq": 256, "rank": LORA_RANK, "alpha": LORA_ALPHA,
           "lr": 1e-3, "steps": 2, "losses_cpu": runs["cpu"][0], "losses_card": runs["cuda"][0],
           "loss_rel_err": loss_rel, "lora_max_abs_err": lora_err,
           "chain_rule": chain, "lora_vs_merged_loss_rel": merged_rel,
           "tol": {"loss_rel": TRAIN_LOSS_RTOL, "lora_abs": TRAIN_PARAM_TOL,
                   "chain_rel": TRAIN_GRAD_RTOL},
           "seconds": time.perf_counter() - t0,
           "launches": {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}}
    rec["f32_form_ok"] = _f32_form_launched(rec["launches"], cfg)
    rec["ok"] = (loss_rel <= TRAIN_LOSS_RTOL and lora_err <= TRAIN_PARAM_TOL and chain_ok
                 and merged_rel <= TRAIN_LOSS_RTOL and rec["f32_form_ok"])
    emit(rec)
    report["train_parity_lora"] = rec
    del b, lo, merged, base
    torch.cuda.empty_cache()
    return rec


CHECKPOINT_DIR = os.path.join("build", "chip_smoke_checkpoint")


def _tree_bitwise(a, b, quant):
    """Whether two trees hold the same structure and the same bits (a
    tensor of ``a`` may lie on another device than ``b``'s)."""
    if torch.is_tensor(b):
        return (torch.is_tensor(a) and a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(quant.byte_view(a), quant.byte_view(b).to(a.device)))
    if isinstance(b, quant.QuantizedWeight):
        return (isinstance(a, quant.QuantizedWeight) and a.ldtype == b.ldtype
                and _tree_bitwise(a.payload, b.payload, quant)
                and _tree_bitwise(a.scales, b.scales, quant))
    if isinstance(b, dict):
        return (isinstance(a, dict) and list(a) == list(b)
                and all(_tree_bitwise(a[k], b[k], quant) for k in b))
    if isinstance(b, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_tree_bitwise(x, y, quant) for x, y in zip(a, b)))
    return a == b


def _save_load(ckpt, tree, engine_state=None):
    """Save then load (on the card): (tree, engine_state, record)."""
    t0 = time.perf_counter()
    ckpt.save_checkpoint(CHECKPOINT_DIR, tree, engine_state=engine_state)
    save_s = time.perf_counter() - t0
    nbytes = sum(os.path.getsize(os.path.join(CHECKPOINT_DIR, f))
                 for f in os.listdir(CHECKPOINT_DIR))
    t0 = time.perf_counter()
    got, state = ckpt.load_checkpoint(CHECKPOINT_DIR)
    torch.cuda.synchronize()
    return got, state, {"bytes": nbytes, "save_s": save_s, "load_s": time.perf_counter() - t0}


def phase_checkpoint(args, transformer, quant, train, engine_mod, kvcache, report):
    """Checkpoint and resume on the card (files under the git-ignored build
    directory, removed afterwards).

    Serving: a 2-layer float32 cut of Mixtral-8x7B-class with int8 weights;
    three requests (two greedy, one seeded sampled) run 6 engine steps,
    then ``save_checkpoint`` (weights and ``state_dict``) ->
    ``load_checkpoint`` (card) -> ``Engine.from_state`` -> ``run``: every
    tensor bitwise the saved one, the tokens those of an uninterrupted run.
    Training: a 1-layer cut of train_mixtral (bf16, B = 1, S = 8192); two
    AdamW steps, ``{params, opt_state}`` saved and loaded, step 3 from the
    restored state against step 3 of the uninterrupted run: the restored
    state bitwise, the loss within 1e-3 relative (the fused backward's dQ
    atomics vary between runs) and the parameters within BF16_ELEM_TOL."""
    from flashattention_tpu_torch.utils import checkpoint as ckpt

    os.makedirs("build", exist_ok=True)
    rec = {"phase": "checkpoint", "dir": CHECKPOINT_DIR,
           "disk_free_gb": shutil.disk_usage("build").free / 1e9}
    cfg = dataclasses.replace(transformer.ModelConfig.mixtral8x7b(num_layers=2), dtype="float32")
    params = quant.quantize_weights(transformer.init_params(args.seed, cfg), "int8")
    ccfg = kvcache.CacheConfig(num_layers=2, num_kv_heads=cfg.num_kv_heads,
                               head_dim=cfg.head_dim, page_size=PAGE_SIZE, num_pages=16,
                               dtype="float32")
    ecfg = engine_mod.EngineConfig(max_batch=4, pages_per_seq=4, prefill_chunk=512)
    rng = np.random.default_rng(args.seed + 40)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in (700, 90, 300)]
    sampled = engine_mod.SamplingParams(greedy=False, temperature=0.8, top_k=50, seed=5)

    def engine():
        eng = engine_mod.Engine(params, cfg, ccfg, ecfg)
        for i, p in enumerate(prompts):
            eng.add_request(p, 12, sampling=sampled if i == 2 else None)
        return eng

    want = engine().run()
    eng = engine()
    for _ in range(6):
        eng.step()
    state = eng.state_dict()
    got_params, got_state, io = _save_load(ckpt, params, state)
    resumed = engine_mod.Engine.from_state(got_state, got_params, cfg, ccfg, ecfg)
    got = resumed.run()
    serving = {"layers": 2, "dtype": "float32", "weights": "int8", **io,
               "tokens_at_save": [len(r["output"]) for r in state["requests"]],
               "state_equal": got_state == json.loads(json.dumps(state)),
               "tensors_bitwise": _tree_bitwise(got_params, params, quant),
               "tokens_equal": got == want}
    serving["ok"] = (serving["state_equal"] and serving["tensors_bitwise"]
                     and serving["tokens_equal"] and 0 < min(serving["tokens_at_save"]))
    rec["serving"] = serving
    del params, got_params, eng, resumed
    torch.cuda.empty_cache()

    tcfg = transformer.ModelConfig.mixtral8x7b(num_layers=1)
    params = transformer.init_params(args.seed, tcfg)
    opt = train.adamw(**MIXTRAL_ADAMW)
    step = train.make_train_step_optax(tcfg, opt)
    opt_state = train.init_opt_state(opt, params)
    tokens = torch.tensor(rng.integers(0, tcfg.vocab_size, (WTRAIN_B, WTRAIN_S)),
                          dtype=torch.int32, device="cuda")
    losses = [float(step(params, opt_state, tokens)[0]) for _ in range(2)]
    saved = {"params": params, "opt_state": opt_state.state_dict()}
    got, _, io = _save_load(ckpt, saved)
    restored_bitwise = _tree_bitwise(got, saved, quant)  # the AdamW step counts included
    restored = train.init_opt_state(opt, got["params"])
    restored.load_state_dict(got["opt_state"])
    loss3 = float(step(params, opt_state, tokens)[0])
    loss3_r = float(step(got["params"], restored, tokens)[0])
    param_err = max(elem_err(a, b) for a, b in zip(train.leaves(got["params"]),
                                                  train.leaves(params)))
    training = {"layers": 1, "dtype": "bfloat16", "batch": WTRAIN_B, "seq": WTRAIN_S,
                "adamw": MIXTRAL_ADAMW, **io, "losses": losses + [loss3],
                "loss3_restored": loss3_r, "loss_rel_err": abs(loss3_r - loss3) / abs(loss3),
                "restored_bitwise": restored_bitwise, "param_elem_err": param_err}
    training["ok"] = restored_bitwise and training["loss_rel_err"] <= 1e-3 and param_err <= 1.0
    rec["training"] = training
    del params, opt_state, saved, got, restored
    torch.cuda.empty_cache()
    shutil.rmtree(CHECKPOINT_DIR)
    rec["removed"] = not os.path.exists(CHECKPOINT_DIR)
    rec["ok"] = serving["ok"] and training["ok"] and rec["removed"]
    emit(rec)
    report["checkpoint"] = rec
    return rec


def _f32_form_launched(launches, cfg, pair=False):
    """A float32 phase's launches took their forms, in the default
    "bf16_3x": at the forward's float32 head_dims every forward launch but
    those with a block mask, and with dropout, in the float32 form (at d =
    256 csrc/flash_fwd_f32.cuh's kernel, and dropout there the exact
    kernel's; at d = 64 / 128 the dropout ones all in its dropout form);
    at d = 64 / 128 / 256 (``kernel_form``: Gemma-2's d = 256 too) every
    fused backward launch (at least one) in its float32 form, the dropout
    ones in its dropout form, and no scalar fused backward, and every
    launch of the pair (with ``pair``, a phase that
    trains packed rows: at least one) in its float32 forms, the dropout ones
    in their dropout forms, and no scalar pair; elsewhere none of them."""
    from flashattention_tpu_torch.ops import flash

    n, n_bwd = launches["flash_fwd_tc_f32"], launches["flash_bwd_tc_f32"]
    f32 = torch.float32
    bwd_ok = (n_bwd == launches["flash_bwd"] > 0
              and launches["flash_bwd_tc_f32_dropout"] == launches["flash_bwd_dropout"]
              if flash.kernel_form("flash_bwd", f32, cfg.head_dim) == "tc_f32" else n_bwd == 0)
    if flash.kernel_form("flash_bwd_dq", f32, cfg.head_dim) == "tc_f32":
        bwd_ok = bwd_ok and all(
            launches[f32k] == launches[k] >= int(pair)
            and launches[f"{f32k}_dropout"] == launches[f"{k}_dropout"]
            for k, f32k in PAIR_F32.items())
    else:
        bwd_ok = bwd_ok and not any(launches[f32k] for f32k in PAIR_F32.values())
    if flash.kernel_form("flash_fwd", f32, cfg.head_dim) != "tc_f32":
        return n == 0 and bwd_ok
    dropout_form = flash.kernel_form("flash_fwd", f32, cfg.head_dim, dropout=True) == "tc_f32"
    extra = launches["flash_fwd_dropout"] if dropout_form else 0
    rest = launches["flash_fwd_dropout"] - extra + launches["flash_fwd_block_mask"]
    split = n if flash.f32_split(cfg.head_dim, "bf16_3x") else 0
    return (bwd_ok and n == launches["flash_fwd"] - rest
            and launches["flash_fwd_tc_f32_extra"] == extra
            and launches["flash_fwd_tc_f32_bf16"] == 0
            and launches["flash_fwd_f32"] == split and (n > 0 or rest > 0))


def _parity_inputs(args, transformer, packing, cfg=None, docs=(70, 100, 50)):
    """A parity phase's float32 configuration (by default the 2-layer cut at
    the training width), its parameters on the CPU (``cfg``'s drawn on the
    card and copied; ``draw`` draws them on the card again, bit for bit)
    and its plain and packed batches (numpy, S = 256)."""
    draw = None
    if cfg is None:
        cfg = _train_cfg(transformer, "float32")
        base = transformer.init_params(args.seed, cfg, device="cpu")
    else:
        draw = functools.partial(transformer.init_params, args.seed, cfg)
        base = _to_card(draw(), "cpu")
        torch.cuda.empty_cache()
    rng = np.random.default_rng(args.seed + 30)
    tokens = rng.integers(0, cfg.vocab_size, (1, 256)).astype(np.int32)
    docs = [rng.integers(0, cfg.vocab_size, int(n)) for n in docs]
    return {"cfg": cfg, "base": base, "draw": draw, "tokens": tokens,
            "packed": packing.pack_documents(docs, 256), "docs": [len(d) for d in docs]}


def _parity_params(inputs, dev):
    """A copy of a parity phase's parameters on ``dev`` (drawn again on the
    card once the reference has let the CPU copy go)."""
    if "base" not in inputs:
        return inputs["draw"]()
    return {k: (v.to(dev, copy=True) if torch.is_tensor(v)
                else [{n: w.to(dev, copy=True) for n, w in lay.items()} for lay in v])
            for k, v in inputs["base"].items()}


def _parity_batch(inputs, packed, dev):
    if packed:
        return tuple(torch.tensor(x, device=dev) for x in inputs["packed"])
    return (torch.tensor(inputs["tokens"], device=dev),)


def _parity_grads(train, inputs, packed, dev, attn_dropout):
    """The gradients of the first step's loss on ``dev``."""
    _, g = train.forward.make_grad_fn(inputs["cfg"], packed=packed, attn_dropout=attn_dropout)(
        _parity_params(inputs, dev), *_parity_batch(inputs, packed, dev), 0)
    return list(g)


def _parity_steps(train, inputs, packed, dev, remat, attn_dropout):
    """Two SGD steps (lr 1e-3, seed = step index) on ``dev``: their losses
    and the parameters after them (on ``dev``)."""
    params = _parity_params(inputs, dev)
    make = train.make_train_step_packed if packed else train.make_train_step
    step = make(inputs["cfg"], lr=1e-3, remat=remat, attn_dropout=attn_dropout, device=dev)
    batch = _parity_batch(inputs, packed, dev)
    losses = [float(step(params, *batch, seed)[0]) for seed in range(2)]
    return losses, list(train.common.leaves(params))


def _card_errs(card, cpu):
    """Each card tensor's largest |card - cpu| and the CPU tensor's largest
    magnitude, computed on the card, the CPU tensors sent over one at a
    time: on the host the comparisons of Gemma-2's 8.9 GB of parameters
    take tens of seconds."""
    out = []
    for a, b in zip(card, cpu):
        b = b.to(a.device)
        out.append((err(a, b), float(b.abs().max())))
    return out


def parity_reference(train, inputs, attn_dropout=None, threads=None):
    """A parity phase's CPU half: for the plain and the packed batch, the
    first step's gradients and two steps' losses and parameters, without
    remat (on the CPU remat is bitwise the step without it;
    tests/test_torch_train.py pins that).  It launches nothing and reads no
    launch counter, so it may run in a worker thread beside the card's
    phases (``threads``: that thread's CPU threads).  Parameters the card
    can draw again (``inputs["draw"]``) leave the CPU when it is done: the
    results it keeps are four times their size.  Returns
    ``({packed: (grads, losses, params)}, seconds)``."""
    if threads:
        torch.set_num_threads(threads)
    t0 = time.perf_counter()
    out = {packed: (_parity_grads(train, inputs, packed, "cpu", attn_dropout),
                    *_parity_steps(train, inputs, packed, "cpu", False, attn_dropout))
           for packed in (False, True)}
    if inputs["draw"] is not None:
        del inputs["base"]
    return out, time.perf_counter() - t0


def phase_train_parity(args, transformer, train, packing, counters, report, *,
                       phase="train_parity", cfg=None, docs=(70, 100, 50), attn_dropout=None,
                       reference=None):
    """Plain and packed steps, remat off and on, two steps each, on the card
    and on the CPU from the same float32 parameters (2-layer cut at the
    training width, B=1, S=256; ``cfg`` another 2-layer float32 cut, its
    parameters drawn on the card and copied, packed from ``docs``); the
    CPU's run without remat is the reference of both card runs
    (``parity_reference``; ``reference``: ``(inputs, (runs, seconds))``
    computed beforehand, else here).  With ``attn_dropout``, seed = step
    index: the card's keep bits must be the plain version's.  The card's
    launches over the phase are its record's (float32 training, in the
    default "bf16_3x": the forward's float32 form at its head_dims, with
    dropout its dropout form at d = 64 / 128, the fused backward's and the
    pair's float32 forms at d = 64 / 128 / 256 (the pair at least
    once: the packed steps), the scalar kernels elsewhere; the CPU runs
    launch nothing; ``_f32_form_launched``)."""
    t0 = time.perf_counter()
    if reference is None:
        inputs = _parity_inputs(args, transformer, packing, cfg, docs)
        reference = (inputs, parity_reference(train, inputs, attn_dropout))
    inputs, (cpu_runs, cpu_seconds) = reference
    cfg = inputs["cfg"]
    cases = []
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    for packed in (False, True):
        g_cpu, l_cpu, p_cpu = cpu_runs[packed]
        grad_rel = max(e / max(m, 1e-30) for e, m in _card_errs(
            _parity_grads(train, inputs, packed, "cuda", attn_dropout), g_cpu))
        for remat in (False, True):
            l_gpu, p_gpu = _parity_steps(train, inputs, packed, "cuda", remat, attn_dropout)
            loss_rel = max(abs(a - b) / abs(b) for a, b in zip(l_gpu, l_cpu))
            param_err = max(e for e, _ in _card_errs(p_gpu, p_cpu))
            cases.append({
                "packed": packed, "remat": remat, "losses_cpu": l_cpu, "losses_card": l_gpu,
                "loss_rel_err": loss_rel, "param_max_abs_err": param_err,
                "grad_rel_err": grad_rel,
                "ok": loss_rel <= TRAIN_LOSS_RTOL and param_err <= TRAIN_PARAM_TOL
                and grad_rel <= TRAIN_GRAD_RTOL,
            })
            del p_gpu
    rec = {"phase": phase, "layers": 2, "dtype": "float32", "batch": 1, "seq": 256,
           "attn_dropout": attn_dropout, "window": cfg.sliding_window, "logit_softcap": cfg.logit_softcap,
           "head_dim": cfg.head_dim, "d_model": cfg.d_model, "vocab": cfg.vocab_size,
           "lr": 1e-3, "steps": 2, "packed_docs": inputs["docs"], "cases": cases,
           "tol": {"loss_rel": TRAIN_LOSS_RTOL, "param_abs": TRAIN_PARAM_TOL,
                   "grad_rel": TRAIN_GRAD_RTOL},
           "seconds": time.perf_counter() - t0, "cpu_reference_seconds": cpu_seconds,
           "launches": {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}}
    rec["f32_form_ok"] = _f32_form_launched(rec["launches"], cfg, pair=True)
    rec["ok"] = all(c["ok"] for c in cases) and rec["f32_form_ok"]
    emit(rec)
    report[phase] = rec
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


def _extra_entry(rec, paths, counter, keys, less=()):
    """A kernel summary's entry for one of its forms: the form's timed check
    and its launches, by path, from the counter ``counter`` (less those of
    the counters ``less``, forms counted within it)."""
    by_path = {p: n.get(counter, 0) - sum(n.get(x, 0) for x in less) for p, n in paths.items()}
    by_path = {p: x for p, x in by_path.items() if x}
    return {**{k: rec[k] for k in keys}, "ms": rec["kernel_ms"],
            "launches": sum(by_path.values()), "launches_by_path": by_path}


# ------------------------------------------------------------------ probes
# B8: every H100 probe (ops/probes.py) held against its plain version at a
# small shape and over inputs whose output is P's second bf16 term alone,
# then timed at its own TPU probe's shape beside its plain version and the
# library call, its output there held against the plain version's too
# (torch_tools/probe_*.py print these).
PROBE_TOL = 2e-2  # of the output's largest magnitude: bf16 outputs
PROBE_FP32_TOL = 1e-4  # of the output's largest magnitude: the packed float32 modes
STREAM_RTOL = 1e-5  # the float32 stream's, relative
PROBE_CHECK = dict(bh=4, s=512)
# probe_mma.py's shape (row 1's, causal) at d = 128; probe_softmax.py's at d = 64.
MMA_SHAPES = {128: dict(bh=128, s=1024, causal=True, modes=(0, 1, 2)),
              64: dict(bh=16, s=8192, causal=False, modes=(0, 1, 2, 3, 4, 5))}
# probe_int8.py's: name -> (BH, rows, S_kv, causal, scale)
INT8_SHAPES = {"decode_tpu_probe": (8, 8, 16 * 256, False, 1.0),
               "prefill_mha": (4 * 32, 512, 2048, True, 128**-0.5)}
# probe_stream.py's: hbm_floor's tensors, and the page walks' decode shapes:
# name -> (KV heads, G, d, pages per request, lengths, window, softcap)
HBM_FLOOR = dict(bh=128, s=1024, d=64)
WALKS = {
    "gemma2_window_check": (8, 2, 256, 24, [1, 4096, 4097, 6000], 4096, 50.0),
    "gemma2_serve_profile": (8, 2, 256, 24, [1537, 1539, 1541, 1543], 4096, 50.0),
    "llama_mha": (32, 1, 128, 8, [1, 256, 257, 1088], None, None),
}
D128_SHAPE = dict(bh=128, s=2048, d=128)  # the d = 128 probes' (Llama-7B's layer), non-causal
# torch_tools/probe_d128.py's rows by subcommand: (row, source, mode); source
# "d128" a probe_d128.cu mode, "mma" a probe_mma.cu mode at d = 128, "ones"
# the probe_d128.cu mode over an all-ones V.
PROBE_D128_ROWS = {
    "pipeline": [("skeleton", "d128", "skeleton"), ("exp", "d128", "exp"),
                 ("maxexp", "d128", "maxexp"), ("full", "mma", 0), ("split2", "mma", 4)],
    "b": [("skeleton", "d128", "skeleton"), ("skeleton2", "d128", "skeleton"),
          ("pcast", "d128", "pcast"), ("qk_heavy", "mma", 1), ("pv_heavy", "mma", 2),
          ("bq64", "d128", "bq64"), ("bq192", "d128", "bq192"), ("bh2", "d128", "bh2"),
          ("pcast_bq192", "d128", "pcast_bq192"), ("pcast_bh2", "d128", "pcast_bh2")],
    "c": [("base", "d128", "skeleton"), ("pv_split2", "d128", "pv_split2"),
          ("pv_split4", "d128", "pv_split4"), ("vt", "d128", "vt"),
          ("vt_split2", "d128", "vt_split2"), ("qk_nn", "d128", "qk_nn"),
          ("ones", "ones", "skeleton")],
    "f": [("bq128_split1", "mma", 0), ("bq128_split1_probe", "d128", "full_bq128_split1"),
          ("bq128_split2", "d128", "full_bq128_split2"),
          ("bq192_split1", "d128", "full_bq192_split1"),
          ("bq192_split2", "d128", "full_bq192_split2")],
}


# scripts/probe_d128d.py's and probe_d128e.py's rows (their shape,
# D128_SHAPE, unscaled) by subcommand of torch_tools/probe_d128.py: mode
# names of probes.D128DE_MODES; and probe_d128e.py's xla_m products (:98),
# cuBLAS here: name -> (M, K, N).
PROBE_D128DE_ROWS = {
    "d": ("base", "t_vt", "t_vtk", "t_full", "t_o_norm"),
    "e": ("t_qk_heavy", "t_pv_heavy", "pv_bf16out"),
}
CUBLAS_ROWS = {"M128_wide": (128, 2048, 4096), "M128_o_t": (128, 2048, 512),
               "M256_wide": (256, 2048, 4096), "M512_wide": (512, 2048, 4096)}
FP32_SHAPE = dict(bh=128, s=1024, d=64)  # scripts/probe_small_fp32b.py's, unscaled


def _rel(got, want) -> float:
    return err(got, want) / max(float(want.float().abs().max()), 1e-30)


def _probe_rec(report, check, got, want, tol, norm=None, **extra):
    """A probe check's record: the largest error over the largest magnitude
    of the plain version's output (or over ``norm``) within ``tol``."""
    e = err(got, want)
    rel = _rel(got, want) if norm is None else e / norm
    rec = {"check": f"probe/{check}", "max_abs_err": e, "rel_err": rel, "tol": tol, **extra}
    rec["ok"] = rec["rel_err"] <= tol and rec.get("ok", True)
    report["checks"].append(rec)
    return rec


def _mma_rec(report, check, mode, got, want):
    """``probe_mma``'s ``(o, l, m)`` against its plain version's: o within
    PROBE_TOL, l and m within STATS_RTOL (mode 2, no softmax: l all 0 and m
    all -inf, exactly)."""
    (o, l, m), (wo, wl, wm) = got, want
    if mode == 2:
        stats = dict(ok=bool(torch.equal(l, wl)) and bool(torch.equal(m, wm)))
    else:
        stats = dict(l_rel_err=_rel(l, wl), m_rel_err=_rel(m, wm), stats_rtol=STATS_RTOL)
        stats["ok"] = stats["l_rel_err"] <= STATS_RTOL and stats["m_rel_err"] <= STATS_RTOL
    return _probe_rec(report, check, o, wo, PROBE_TOL, **stats)


def _walk_rec(report, check, got, want):
    """The page walk's folded words against its plain version's, bit for bit."""
    return _probe_rec(report, check, got, want, 0.0, ok=bool(torch.equal(got, want)))


def _layouts(cfg, k, v):
    """``k, v`` as a probe_d128 mode stores them (``kt``, ``vt``: (BH, d, S))."""
    return (k.transpose(1, 2).contiguous() if cfg.kt else k,
            v.transpose(1, 2).contiguous() if cfg.vt else v)


def _bf16_qkv(gen, bh, s, d):
    return tuple(torch.randn((bh, s, d), generator=gen, device="cuda").to(torch.bfloat16)
                 for _ in range(3))


def _uniform(gen, *shape):
    """Uniform in [-1, 1), as the TPU probes draw their inputs
    (``utils/testing.make_random``), float32 on the card."""
    return torch.rand(shape, generator=gen, device="cuda") * 2 - 1


def _d128de_args(probes, name, q, k, v, vt):
    return q, k, vt if probes.D128DE_MODES[name].vt else v


def _fp32_tol(mode):
    return PROBE_TOL if mode == "bf16_skel" else PROBE_FP32_TOL


def _walk_case(decode, quant, gen, kvh, d, pps, lens, form, page=PAGE_SIZE):
    """Pools, table and lengths of a page walk, and its split count."""
    b = len(lens)
    pages = b * pps + 4
    pools = [torch.randn((pages, kvh, page, d), generator=gen, device="cuda") for _ in range(2)]
    if form:
        (kp, ks), (vp, vs) = (quant.quantize_rows(x, form) for x in pools)
        sc = dict(k_scales_pages=ks, v_scales_pages=vs)
    else:
        kp, vp = (x.to(torch.bfloat16) for x in pools)
        sc = {}
    perm = torch.randperm(pages, generator=gen, device="cuda")
    table = perm[: b * pps].reshape(b, pps).to(torch.int32).contiguous()
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    n, per = decode.decode_splits(b, kvh, pps, page, sms=decode._sm_count(kp.device))
    return kp, vp, sc, table, lengths, n, per


def lo_term_checks(probes, gen, report):
    """Every probe mode that feeds P (or S) to PV as bf16 terms, over
    ``probes.lo_term_qkv``'s inputs at scale 1, where the first terms cancel
    pair by pair: a mode that dropped the second term would give 0 (or
    whole bf16 steps) where its plain version gives the second terms' sum.
    Within PROBE_TOL of the plain version's largest magnitude; the one-term
    modes (plain output all 0) of the two-term skeleton's.  Returns the
    records."""
    recs = []
    bh, s = PROBE_CHECK["bh"], PROBE_CHECK["s"]
    for mode, (_, dims, _) in probes.MMA_MODES.items():
        for d in dims if mode not in (1, 2) else ():  # 1 and 2 take no P into PV
            q, k, v = probes.lo_term_qkv(bh, s, d, generator=gen, device="cuda")
            recs.append(_mma_rec(report, f"mma/lo_term/mode{mode}/d{d}", mode,
                                 probes.probe_mma(mode, q, k, v, scale=1.0),
                                 probes.probe_mma_plain(mode, q, k, v, scale=1.0)))
    q, k, v = probes.lo_term_qkv(bh, s, 128, generator=gen, device="cuda")
    two = float(probes.probe_d128_plain("skeleton", q, k, v, scale=1.0).float().abs().max())
    for name, cfg in probes.D128_MODES.items():
        kk, vv = _layouts(cfg, k, v)
        recs.append(_probe_rec(report, f"d128/lo_term/{name}",
                               probes.probe_d128(name, q, kk, vv, scale=1.0),
                               probes.probe_d128_plain(name, q, kk, vv, scale=1.0), PROBE_TOL,
                               norm=two if cfg.terms == 1 else None))
    vt = v.transpose(1, 2).contiguous()
    for name in probes.D128DE_MODES:  # unscaled, as lo_term_qkv's scale 1 asks
        args = _d128de_args(probes, name, q, k, v, vt)
        recs.append(_probe_rec(report, f"d128de/lo_term/{name}", probes.probe_d128de(name, *args),
                               probes.probe_d128de_plain(name, *args), PROBE_TOL))
    # float32 as two terms: lo_term_qkv's values as float32 inputs (their
    # second bf16 terms 0; S's carries the output, about 2^-9 of p, so the
    # bf16 tolerance); bf16_skel takes one term (its plain output all 0).
    q, k, v = (x.float() for x in probes.lo_term_qkv(bh, s, 64, generator=gen, device="cuda"))
    two = float(probes.probe_fp32_plain("skeleton", *probes.fp32_inputs(q, k, v, "skeleton"))
                .abs().max())
    for mode in probes.FP32_MODES:
        args = probes.fp32_inputs(q, k, v, mode)
        recs.append(_probe_rec(report, f"fp32/lo_term/{mode}", probes.probe_fp32(mode, *args),
                               probes.probe_fp32_plain(mode, *args), PROBE_TOL,
                               norm=two if mode == "bf16_skel" else None))
    return recs


def probe_checks(probes, decode, quant, gen, report):
    """Every probe mode once at a small shape against its plain version:
    outputs within PROBE_TOL of their largest magnitude (bf16; an output
    the plain version has all zero must be all zero), l and m within
    STATS_RTOL, the float32 stream within STREAM_RTOL, the page walk's
    folded words equal; then :func:`lo_term_checks`.  Returns the records."""
    recs = []
    bh, s = PROBE_CHECK["bh"], PROBE_CHECK["s"]
    for d, causal in ((128, True), (64, False)):
        q, k, v = _bf16_qkv(gen, bh, s, d)
        for mode, (_, dims, _) in probes.MMA_MODES.items():
            if d not in dims:
                continue
            recs.append(_mma_rec(report, f"mma/mode{mode}/d{d}{'/causal' if causal else ''}",
                                 mode, probes.probe_mma(mode, q, k, v, causal=causal),
                                 probes.probe_mma_plain(mode, q, k, v, causal=causal,
                                                        scale=d**-0.5)))
    q = torch.randn((bh, 256, 128), generator=gen, device="cuda").to(torch.bfloat16)
    kb, vb = (torch.randn((bh, 4 * 256, 128), generator=gen, device="cuda").to(torch.bfloat16)
              for _ in range(2))
    k8, v8 = (torch.randint(-127, 127, (bh, 4 * 256, 128), generator=gen, device="cuda",
                            dtype=torch.int8) for _ in range(2))
    ks, vs = (0.005 + 0.015 * torch.rand((bh, 4 * 256), generator=gen, device="cuda")
              for _ in range(2))
    kw = dict(q_offset=3 * 256, causal=True, scale=128**-0.5)
    for fl in probes.INT8_FLAVORS:
        k, v = (kb, vb) if fl == "bf16" else (k8, v8)
        recs.append(_probe_rec(report, f"int8/{fl}", probes.probe_int8(fl, q, k, v, ks, vs, **kw),
                               probes.probe_int8_plain(fl, q, k, v, ks, vs, **kw), PROBE_TOL))
    a, b_, c = (torch.randn((bh, s, 64), generator=gen, device="cuda") for _ in range(3))
    recs.append(_probe_rec(report, "stream/hbm_floor", probes.probe_stream_sum(a, b_, c),
                           probes.probe_stream_sum_plain(a, b_, c), STREAM_RTOL))
    for form, d in ((None, 128), ("fp8", 256)):
        for window in (None, 100):
            kp, vp, _, table, lengths, n, per = _walk_case(
                decode, quant, gen, 2, d, 6, [1, 130, 300], form, page=64)
            kw = dict(splits=n, tiles_per_split=per, window=window)
            recs.append(_walk_rec(report, f"stream/page_walk/{form or 'bf16'}/window{window}",
                                  probes.probe_page_walk(kp, vp, lengths, table, **kw),
                                  probes.probe_page_walk_plain(kp, vp, lengths, table, **kw)))
    q, k, v = _bf16_qkv(gen, bh, s, 128)
    for name, cfg in probes.D128_MODES.items():
        kk, vv = _layouts(cfg, k, v)
        recs.append(_probe_rec(report, f"d128/{name}", probes.probe_d128(name, q, kk, vv),
                               probes.probe_d128_plain(name, q, kk, vv, scale=128**-0.5),
                               PROBE_TOL))
    ones = torch.ones_like(v)
    recs.append(_probe_rec(report, "d128/ones", probes.probe_d128("skeleton", q, k, ones),
                           probes.probe_d128_plain("skeleton", q, k, ones, scale=128**-0.5),
                           PROBE_TOL))
    q, k, v = (_uniform(gen, bh, s, 128).to(torch.bfloat16) for _ in range(3))
    vt = v.transpose(1, 2).contiguous()
    for name in probes.D128DE_MODES:
        args = _d128de_args(probes, name, q, k, v, vt)
        recs.append(_probe_rec(report, f"d128de/{name}", probes.probe_d128de(name, *args),
                               probes.probe_d128de_plain(name, *args), PROBE_TOL))
    q, k, v = (_uniform(gen, bh, s, 64) for _ in range(3))
    for mode in probes.FP32_MODES:
        args = probes.fp32_inputs(q, k, v, mode)
        recs.append(_probe_rec(report, f"fp32/{mode}", probes.probe_fp32(mode, *args),
                               probes.probe_fp32_plain(mode, *args), _fp32_tol(mode)))
    recs += lo_term_checks(probes, gen, report)
    recs += c4_checks(decode, gen, report)
    emit({"phase": "probe_checks", "checks": len(recs), "ok": all(r["ok"] for r in recs),
          "failed": [r["check"] for r in recs if not r["ok"]]})
    return recs


# Float32 q over bf16 pages (C4) and over 8-bit K/V and pages: (entry point,
# head_dim, G or GQA rows, page size, lengths or ctx lens (the flash
# forward's: its S), the payload (None: bf16 pages)): the tensor-core forms
# at the serving shapes' d = 128 and page 256, the scalar form at d = 32.
C4_CASES = tuple(
    case for payload in (None, *QUANT_FORMS) for case in (
        ("decode", 128, 4, 256, [1, 300, 1100], payload),
        ("decode", 32, 2, 16, [5, 60, 200], payload),
        ("prefill_batched", 128, 2, 256, [64, 700], payload),
        ("prefill", 128, 1, 256, [300], payload),
        ("prefill_batched", 32, 2, 16, [16, 90], payload),
    )) + tuple(
    case for payload in QUANT_FORMS for case in (
        ("draft", 128, 1, 256, [4, 300, 1100], payload),
        ("flash", 128, 2, 0, [1000], payload),
        ("flash", 32, 2, 0, [300], payload),
    ))


def c4_checks(decode, gen, report):
    """Float32 q over bf16 (C4) and 8-bit pages through ``paged_attention``
    (k = 1 and the draft form, k = DRAFT_K), ``paged_prefill_attention_batched``
    and ``paged_prefill_attention``, and over 8-bit K/V through
    ``flash_attention``: the kernel takes q in bf16, as the JAX kernels do
    (the flash forward in its quantized default mode, "bf16"), and returns
    float32 (the tensor-core forms from their float32 sums: not every element
    a bf16 value; over bf16 pages the scalar form through a bf16 store; over
    8-bit K/V the scalar form keeps q float32, exact), held against the
    plain version on the card within PROBE_TOL of the output's magnitude (q
    is taken in bf16); each call's launch counted, an 8-bit one in its
    form's 8-bit count.  Returns the records."""
    from flashattention_tpu_torch.ops import flash

    fwd = flash.flash_attention
    recs = []
    kvh, chunk = 2, 64
    for entry, d, g, ps, lens, payload in C4_CASES:
        b = len(lens)
        k_draft = DRAFT_K if entry == "draft" else 1
        if entry == "flash":  # (BH, S, d) K/V, q GQA-folded: g segments of S rows
            s = lens[0]
            (k, ks), (v, vs) = (_kv(gen, (b * kvh, s, d), torch.bfloat16, payload)
                                for _ in range(2))
            q = torch.randn((b * kvh, g * s, d), generator=gen, device="cuda")
            kw = dict(causal=True, scale=d**-0.5, q_seq_len=s)
            tc = flash.kernel_form("flash_fwd", torch.bfloat16, d, quantized=True)
            counter, attr = fwd, "launches_tc_quantized_f32q"
            before = (fwd.launches, getattr(fwd, attr))
            got = fwd(q, k, v, ks, vs, **kw)
            want = flash.flash_attention_plain(q, k, v, k_scales=ks, v_scales=vs, **kw)
        else:
            pps = -(-max(lens) // ps)
            pool = b * pps + 2
            (kp, ks), (vp, vs) = (_kv(gen, (pool, kvh, ps, d), torch.bfloat16, payload)
                                  for _ in range(2))
            sc = _page_scales(ks, vs)
            table = torch.randperm(pool, generator=gen, device="cuda")[: b * pps].reshape(
                b, pps).to(torch.int32)
            lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
            if entry in ("decode", "draft"):
                tc = flash.kernel_form("paged_decode", torch.bfloat16, d, page_size=ps,
                                       rows=g * k_draft)
                q = torch.randn((b, kvh, g * k_draft, d), generator=gen, device="cuda")
                kw = dict(scale=d**-0.5, draft_k=k_draft, **sc)
                counter = decode.paged_attention
                attr = "launches_tc_draft" if entry == "draft" else "launches_tc_quantized"
                before = (counter.launches, getattr(counter, attr))
                got = decode.paged_attention(q, kp, vp, lengths, table, **kw)
                want = decode.paged_attention_plain(q, kp, vp, lengths, table, **kw)
            else:
                tc = flash.kernel_form("paged_prefill", torch.bfloat16, d, page_size=ps)
                seg = chunk if entry == "prefill_batched" else 128
                q = torch.randn((b, kvh, g * seg, d), generator=gen, device="cuda")
                kw = dict(chunk=chunk, seg=seg, scale=d**-0.5, **sc)
                counter = decode.paged_prefill_attention_batched
                attr = "launches_tc_quantized"
                before = (counter.launches, getattr(counter, attr))
                if entry == "prefill":
                    got = decode.paged_prefill_attention(q[0], kp, vp, table[0], lengths[0],
                                                         **kw)[None]
                else:
                    got = decode.paged_prefill_attention_batched(q, kp, vp, table, lengths, **kw)
                want = decode.paged_prefill_attention_plain(q, kp, vp, table, lengths, **kw)
        torch.cuda.synchronize()
        rounded = bool(torch.equal(got.to(torch.bfloat16).float(), got))
        # The scalar form stores bf16 over bf16 pages; over 8-bit K/V it keeps q float32.
        bf16_store = tc == "scalar" and payload is None
        # A tensor-core launch over 8-bit K/V (or a draft one) counts in its form's count too.
        counted = tc != "tc" or (payload is None and entry != "draft") or (
            getattr(counter, attr) == before[1] + 1)
        ok = (got.dtype == torch.float32 and counter.launches == before[0] + 1 and counted
              and rounded == bf16_store)
        name = f"c4/{entry}/d{d}_ps{ps}_{tc}" + (f"/{payload}" if payload else "")
        recs.append(_probe_rec(report, name, got, want, PROBE_TOL, ok=ok, form=tc,
                               payload=payload or "bfloat16", out_dtype=str(got.dtype),
                               bf16_valued=rounded))
    emit({"phase": "c4_checks", "checks": len(recs), "ok": all(r["ok"] for r in recs),
          "failed": [r["check"] for r in recs if not r["ok"]]})
    return recs


def _f32q_rec(flash, benchit, card, report, key, run, plain, *, lib, lib32, nbytes, flops,
              flush=0, exact=None, **extra):
    """One timed route of float32 q over 8-bit K/V or pages (``run``),
    held against its plain version within FLASH_TOL["float32"] and timed
    beside it, beside the scalar form of the same call
    (``ops.flash.scalar_forms``: the scalar 8-bit kernel over the same bf16
    q), beside ``exact`` where given (the exact float32 route the call took
    before), and beside ``lib`` (one SDPA call over q in bf16 and K/V
    dequantized to bf16: the same function) and ``lib32`` (SDPA in float32
    over float32 dequantized K/V); its bound at the bf16 rate (q is taken in
    bf16).  Recorded in ``report["f32q_timed"][key]``."""
    got, want = run(), plain()
    torch.cuda.synchronize()
    rec = _rec(key.replace("/", "/f32q/", 1) + "/float32", got, want, "float32",
               FLASH_TOL["float32"], out_dtype=str(got.dtype), **extra)
    rec["ok"] = rec["ok"] and got.dtype == torch.float32
    rec["kernel_ms"] = benchit.cuda_time_ms(run, flush_bytes=flush)
    rec["plain_ms"] = benchit.cuda_time_ms(plain, warmup=1, iters=3, flush_bytes=flush)
    with flash.scalar_forms():
        rec["scalar_ms"] = benchit.cuda_time_ms(run, warmup=1, iters=5, flush_bytes=flush)
    if exact is not None:
        rec["exact_ms"] = benchit.cuda_time_ms(exact, warmup=1, iters=5, flush_bytes=flush)
    rec["library_ms"] = lib()
    rec["library_f32_ms"] = lib32()
    rec["library"] = ("scaled_dot_product_attention over q in bf16 and K/V dequantized to bf16 "
                      "(library_f32_ms: float32, K/V dequantized to float32), q's cast and the "
                      "dequantization not timed")
    rec.update(benchit.bound_ms(card, bytes_moved=nbytes, flops=flops, dtype="bfloat16"))
    report.setdefault("f32q_timed", {})[key] = rec
    emit(rec)
    report["checks"].append(rec)
    return rec


def f32q_timings(fa, flash, decode, benchit, gen, card, report):
    """Float32 q over 8-bit K/V and pages, as the JAX kernels take it (q in
    bf16, O in float32 from the tensor-core 8-bit forms' float32 sums), at
    the rows' timed shapes: the flash forward at row 1's (B=4, H=32,
    S=1024, d=128, causal; int8 and fp8), chunked prefill at the MHA shape
    (int8 pages), paged decode at the MHA shape and its draft form (k = 4)
    at Llama's (int8 pages); each through ``_f32q_rec``.  Then float32
    under a block mask (the documents mask at the block-mask checks' shape,
    the scalar kernel: the tensor-core forms take no float32 mask) beside
    SDPA float32 with the boolean mask (``report["float32_block_mask"]``)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    bf = torch.bfloat16
    b, h, s, d = 4, 32, 1024, 128
    scale = d**-0.5
    for form in QUANT_FORMS:
        q = torch.randn((b, h, s, d), generator=gen, device="cuda")
        (k, ks), (v, vs) = (_kv(gen, (b, h, s, d), None, form) for _ in range(2))
        sk = dict(k_scales=ks, v_scales=vs)
        q3, k3, v3 = (x.reshape(b * h, s, d) for x in (q, k, v))
        sk3 = {n: x.reshape(b * h, s) for n, x in sk.items()}
        kd, vd = _plain_kv(k, ks), _plain_kv(v, vs)
        q16, kd16, vd16 = q.to(bf), kd.to(bf), vd.to(bf)
        _f32q_rec(
            flash, benchit, card, report, f"flash_fwd_tc_quant/prefill/{form}",
            lambda: fa.attention(q, k, v, causal=True, scale=scale, **sk),
            lambda: flash.flash_attention_plain(q3, k3, v3, causal=True, scale=scale,
                                                **sk3).reshape(q.shape),
            exact=lambda: fa.attention(q, k, v, causal=True, scale=scale, precision="float32",
                                       **sk),
            lib=lambda: benchit.cuda_time_ms(lambda: sdpa(q16, kd16, vd16, is_causal=True,
                                                          scale=scale)),
            lib32=lambda: benchit.cuda_time_ms(lambda: sdpa(q, kd, vd, is_causal=True,
                                                            scale=scale)),
            nbytes=2 * q.numel() * 4 + 2 * b * h * s * _row_bytes(k, d, form),
            flops=4 * b * h * (s * (s + 1) // 2) * d,
            shape=f"B={b} H={h} S={s} d={d} causal, float32 q, {form} K/V")
        del q, k, v, kd, vd, q16, kd16, vd16
    ps, d = PAGE_SIZE, 128
    # Chunked prefill at prefill_checks' MHA shape.
    kvh, chunk, ctx = 32, 512, [512, 1024, 1536, 2048]
    b, pps = len(ctx), 8
    (kp, ks), (vp, vs), table = _paged_pool(gen, ctx, pps, 64, (kvh, ps, d), None, "int8")
    q = torch.randn((b, kvh, chunk, d), generator=gen, device="cuda")
    ctx_t = torch.tensor(ctx, dtype=torch.int32, device="cuda")
    kw = dict(chunk=chunk, seg=chunk, scale=scale, **_page_scales(ks, vs))
    cols = torch.arange(pps * ps, device="cuda")
    pos = ctx_t[:, None] - chunk + torch.arange(chunk, device="cuda")[None]
    mask = (cols[None, None] <= pos[:, :, None]) & (cols[None, None] < ctx_t[:, None, None])
    kd, vd = _plain_kv(kp, ks), _plain_kv(vp, vs)
    _, flops = _prefill_work(ctx, chunk, chunk, 1, kvh, d)
    _f32q_rec(
        flash, benchit, card, report, "paged_prefill_tc_quant/prefill_mha/int8",
        lambda: decode.paged_prefill_attention_batched(q, kp, vp, table, ctx_t, **kw),
        lambda: decode.paged_prefill_attention_plain(q, kp, vp, table, ctx_t, **kw),
        lib=lambda: _gathered_sdpa_ms(benchit, q.to(bf), kd.to(bf), vd.to(bf), table, mask, scale),
        lib32=lambda: _gathered_sdpa_ms(benchit, q, kd, vd, table, mask, scale),
        nbytes=(2 * q.numel() * 4 + 2 * sum(ctx) * kvh * _row_bytes(kp, d, "int8")
                + 4 * (b + sum(-(-n // ps) for n in ctx))),
        flops=flops, flush=256 << 20, ctx_lens=ctx,
        shape=f"B={b} KVH={kvh} G=1 d={d} ps={ps}, chunk {chunk}, float32 q, int8 pages")
    del kp, vp, ks, vs, kd, vd, q, mask
    # Paged decode at paged_checks' MHA shape, and its draft form at Llama's.
    for key, kvh, lens, k_draft, pps, pages in (
            ("decode_mha", 32, [1, 256, 257, 1088], 1, 8, 64),
            ("draft_llama", 32, DRAFT_LENGTHS, DRAFT_K, 24, 128)):
        b = len(lens)
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        (kp, ks), (vp, vs), table = _paged_pool(gen, lens, pps, pages, (kvh, ps, d), None, "int8")
        q = torch.randn((b, kvh, k_draft, d), generator=gen, device="cuda")
        kw = dict(scale=scale, draft_k=k_draft, **_page_scales(ks, vs))
        cols = torch.arange(pps * ps, device="cuda")[None, None]
        lim = (lengths.long()[:, None] - k_draft + torch.arange(k_draft, device="cuda")[None])
        mask = cols <= lim[:, :, None]
        kd, vd = _plain_kv(kp, ks), _plain_kv(vp, vs)
        live, seen = _draft_limits(lens, k_draft, None)
        _f32q_rec(
            flash, benchit, card, report, f"paged_decode_tc_quant/{key}/int8",
            lambda: decode.paged_attention(q, kp, vp, lengths, table, **kw),
            lambda: decode.paged_attention_plain(q, kp, vp, lengths, table, **kw),
            lib=lambda: _gathered_sdpa_ms(benchit, q.to(bf), kd.to(bf), vd.to(bf), table, mask,
                                          scale),
            lib32=lambda: _gathered_sdpa_ms(benchit, q, kd, vd, table, mask, scale),
            nbytes=(2 * q.numel() * 4 + 2 * sum(live) * kvh * _row_bytes(kp, d, "int8")
                    + 4 * (b + sum(-(-n // ps) for n in lens))),
            flops=4 * d * kvh * sum(map(sum, seen)), flush=256 << 20, lengths=lens,
            draft_k=k_draft, shape=f"B={b} KVH={kvh} G=1 R={k_draft} d={d} ps={ps}, float32 q, "
                                   "int8 pages")
        del kp, vp, ks, vs, kd, vd, q, mask
        torch.cuda.empty_cache()
    # Float32 under the documents mask, beside SDPA float32.
    bm = flash.BlockMask.from_mask_fn(bm_documents, BM_S, BM_S)
    q, k, v = (torch.randn((BM_B * BM_H, BM_S, BM_D), generator=gen, device="cuda")
               for _ in range(3))
    kw = dict(scale=BM_D**-0.5, block_mask=bm)
    got = flash.flash_attention(q, k, v, **kw)
    plain = lambda: flash.flash_attention_plain(q, k, v, **kw)  # noqa: E731
    want = plain()
    torch.cuda.synchronize()
    dense = bm.element_mask(BM_S, BM_S, "cuda")
    pairs = int(dense.sum()) * q.shape[0]
    q4, k4, v4 = (x.reshape(BM_B, BM_H, BM_S, BM_D) for x in (q, k, v))
    rec = _rec("flash_fwd/block_mask/documents/float32_timed", got, want, "float32",
               FLASH_TOL["float32"], shape=f"B={BM_B} H={BM_H} S={BM_S} d={BM_D}, documents mask",
               form=_kname("flash_fwd", q, block_mask=True), live_pairs=pairs)
    rec["kernel_ms"] = benchit.cuda_time_ms(lambda: flash.flash_attention(q, k, v, **kw),
                                            warmup=1, iters=5)
    rec["plain_ms"] = benchit.cuda_time_ms(plain, warmup=1, iters=2)
    rec["library_ms"] = benchit.cuda_time_ms(
        lambda: sdpa(q4, k4, v4, attn_mask=dense, scale=kw["scale"]), warmup=1, iters=5)
    rec["library"] = "scaled_dot_product_attention in float32, boolean (S, S) mask"
    rec.update(benchit.bound_ms(card, bytes_moved=4 * q.numel() * 4, flops=4 * BM_D * pairs,
                                dtype="float32"))
    report["float32_block_mask"] = rec
    emit(rec)
    report["checks"].append(rec)
    del q, k, v, got, want, dense
    torch.cuda.empty_cache()
    emit({"phase": "f32q_timings", "ok": all(r["ok"] for r in report["f32q_timed"].values())
          and rec["ok"]})


def _probe_row(benchit, card, run, plain, hold, *, nbytes, flops, iters, flush=0,
               dtype="bfloat16", plain_iters=3, want=None):
    """A probe's time and rate, its bound, and its plain version's time
    (``plain`` None: the time is another row's); the probe's output at
    these inputs held against the plain version's (``want``, else
    ``plain()``) by ``hold(got, want)``, which makes the check record."""
    rec = hold(run(), plain() if want is None else want)
    ms = benchit.cuda_time_ms(run, warmup=3, iters=iters, flush_bytes=flush)
    row = {"ms": ms, "tflop_s": flops / ms / 1e9 if flops else None,
           **benchit.bound_ms(card, bytes_moved=nbytes, flops=flops, dtype=dtype),
           "check": rec["check"], "rel_err": rec["rel_err"], "check_ok": rec["ok"]}
    if plain is not None:
        row["plain_ms"] = benchit.cuda_time_ms(plain, warmup=1, iters=plain_iters)
    return row


def _sdpa_ms(benchit, q, k, v, causal, scale, flush=0):
    f = torch.nn.functional.scaled_dot_product_attention
    q4, k4, v4 = (x[None] for x in (q, k, v))
    return benchit.cuda_time_ms(lambda: f(q4, k4, v4, is_causal=causal, scale=scale),
                                warmup=3, iters=20, flush_bytes=flush)


def time_probe_mma(probes, flash, benchit, gen, card, report, d, iters=20):
    """``probe_mma``'s modes at its own shape for head_dim ``d``
    (MMA_SHAPES), each held against its plain version there, beside
    flash_fwd_tc and SDPA on the same inputs."""
    c = MMA_SHAPES[d]
    bh, s, causal = c["bh"], c["s"], c["causal"]
    q, k, v = _bf16_qkv(gen, bh, s, d)
    pairs = bh * s * (s + 1) // 2 if causal else bh * s * s
    out = {"shape": f"BH={bh} S={s} d={d} {'causal' if causal else 'non-causal'} bf16",
           "live_pairs": pairs, "modes": {}}
    sdpa = _sdpa_ms(benchit, q, k, v, causal, d**-0.5)
    for mode in c["modes"]:
        row = _probe_row(
            benchit, card, lambda mode=mode: probes.probe_mma(mode, q, k, v, causal=causal),
            lambda mode=mode: probes.probe_mma_plain(mode, q, k, v, causal=causal, scale=d**-0.5),
            lambda got, want, mode=mode: _mma_rec(report, f"mma/timed/d{d}/mode{mode}", mode,
                                                  got, want),
            nbytes=4 * q.numel() * 2, flops=(2 if mode in (1, 2) else 4) * d * pairs, iters=iters)
        out["modes"][str(mode)] = {"what": probes.MMA_MODES[mode][0],
                                   "replaces": probes.MMA_MODES[mode][2], **row,
                                   "library_ms": sdpa}
    out["flash_fwd_tc_ms"] = benchit.cuda_time_ms(
        lambda: flash.flash_attention(q, k, v, causal=causal, scale=d**-0.5), warmup=3,
        iters=iters)
    out["sdpa_ms"] = sdpa
    return out


def time_probe_int8(probes, benchit, gen, card, report, iters=20):
    """``probe_int8``'s three flavors at probe_int8.py's two shapes, each
    held against its plain version there, the L2 flushed before every call;
    SDPA over the K/V dequantized to bf16 as the library call."""
    out = {}
    for shape, (bh, rows, s_kv, causal, scale) in INT8_SHAPES.items():
        q = torch.randn((bh, rows, 128), generator=gen, device="cuda").to(torch.bfloat16)
        kb, vb = (torch.randn((bh, s_kv, 128), generator=gen, device="cuda").to(torch.bfloat16)
                  for _ in range(2))
        k8, v8 = (torch.randint(-127, 127, (bh, s_kv, 128), generator=gen, device="cuda",
                                dtype=torch.int8) for _ in range(2))
        sc = torch.full((bh, s_kv), 0.01, dtype=torch.float32, device="cuda")
        kw = dict(q_offset=s_kv - rows if causal else 0, causal=causal, scale=scale)
        pairs = bh * (rows * s_kv if not causal else sum(
            min(s_kv, kw["q_offset"] + r + 1) for r in range(rows)))
        kd, vd = ((x.float() * 0.01).to(torch.bfloat16) for x in (k8, v8))
        mask = None  # SDPA's causal mask is anchored at row 0: pass the rows' limits
        if causal:
            mask = (torch.arange(s_kv, device="cuda")[None, :]
                    <= kw["q_offset"] + torch.arange(rows, device="cuda")[:, None])
        f = torch.nn.functional.scaled_dot_product_attention
        sdpa = benchit.cuda_time_ms(lambda: f(q[None], kd[None], vd[None], attn_mask=mask,
                                              scale=scale),
                                    warmup=3, iters=iters, flush_bytes=256 << 20)
        rec = {"shape": f"BH={bh} rows={rows} S_kv={s_kv} d=128 "
                        f"{'causal' if causal else 'non-causal'} scale={scale:.6g}",
               "live_pairs": pairs, "flavors": {}, "sdpa_dequantized_ms": sdpa}
        for fl in probes.INT8_FLAVORS:
            k, v = (kb, vb) if fl == "bf16" else (k8, v8)
            kv_bytes = 2 * bh * s_kv * (128 * k.element_size() + (0 if fl == "bf16" else 4))
            row = _probe_row(
                benchit, card, lambda fl=fl, k=k, v=v: probes.probe_int8(fl, q, k, v, sc, sc, **kw),
                lambda fl=fl, k=k, v=v: probes.probe_int8_plain(fl, q, k, v, sc, sc, **kw),
                lambda got, want, fl=fl: _probe_rec(report, f"int8/timed/{shape}/{fl}", got, want,
                                                    PROBE_TOL),
                nbytes=kv_bytes + 4 * q.numel(), flops=4 * 128 * pairs, iters=iters,
                flush=256 << 20, dtype="int8" if fl == "int8mma" else "bfloat16")
            rec["flavors"][fl] = {**row, "kv_bytes": kv_bytes,
                                  "gb_s_equiv": kv_bytes / (row["ms"] * 1e-3) / 1e9,
                                  "library_ms": sdpa}
        t = {fl: rec["flavors"][fl]["ms"] for fl in probes.INT8_FLAVORS}
        rec["int8cvt_over_bf16"] = t["int8cvt"] / t["bf16"]
        rec["int8mma_over_int8cvt"] = t["int8mma"] / t["int8cvt"]
        out[shape] = rec
        del q, kb, vb, k8, v8, kd, vd
        torch.cuda.empty_cache()
    return out


def time_probe_stream(probes, decode, quant, benchit, gen, card, report, iters=20):
    """``hbm_floor`` at the TPU probe's shape and the page walk beside
    ``paged_attention`` (the tensor-core form) at the decode shapes of
    WALKS, each held against its plain version there (the walk bit for
    bit), the L2 flushed before every call."""
    c = HBM_FLOOR
    a, b_, cc = (torch.randn((c["bh"], c["s"], c["d"]), generator=gen, device="cuda")
                 for _ in range(3))
    nbytes = 4 * a.numel() * 4
    floor = _probe_row(benchit, card, lambda: probes.probe_stream_sum(a, b_, cc),
                       lambda: probes.probe_stream_sum_plain(a, b_, cc),
                       lambda got, want: _probe_rec(report, "stream/timed/hbm_floor", got, want,
                                                    STREAM_RTOL),
                       nbytes=nbytes, flops=0, iters=iters, flush=256 << 20, dtype="float32")
    out = {"hbm_floor": {"shape": f"BH={c['bh']} S={c['s']} d={c['d']} float32, o = q + k + v",
                         **floor, "bytes": nbytes, "gb_s": nbytes / (floor["ms"] * 1e-3) / 1e9,
                         "library_ms": None},
           "page_walk": {}}
    del a, b_, cc
    for shape, (kvh, g, d, pps, lens, window, cap) in WALKS.items():
        for form in (None, "fp8") if shape.startswith("gemma2") else (None,):
            kp, vp, sc, table, lengths, n, per = _walk_case(decode, quant, gen, kvh, d, pps, lens,
                                                            form)
            qd = torch.randn((len(lens), kvh, g, d), generator=gen,
                             device="cuda").to(torch.bfloat16)
            kw = dict(splits=n, tiles_per_split=per, window=window)
            live = sum(min(x, window) if window else x for x in lens)
            walk_bytes = 2 * live * kvh * d * kp.element_size()
            row = _probe_row(benchit, card, lambda: probes.probe_page_walk(kp, vp, lengths, table,
                                                                           **kw),
                             lambda: probes.probe_page_walk_plain(kp, vp, lengths, table, **kw),
                             lambda got, want: _walk_rec(
                                 report, f"stream/timed/page_walk/{shape}/{form or 'bf16'}", got,
                                 want),
                             nbytes=walk_bytes, flops=0, iters=iters, flush=256 << 20,
                             plain_iters=1)
            dec_kw = dict(scale=d**-0.5, window=window, logit_softcap=cap, **sc)
            dec_ms = benchit.cuda_time_ms(
                lambda: decode.paged_attention(qd, kp, vp, lengths, table, **dec_kw), warmup=3,
                iters=iters, flush_bytes=256 << 20)
            out["page_walk"][f"{shape}/{form or 'bf16'}"] = {
                "shape": f"B={len(lens)} KVH={kvh} G={g} d={d} ps={PAGE_SIZE} pps={pps} "
                         f"window={window} cap={cap} lengths={lens}",
                "splits": [n, per], **row, "walk_bytes": walk_bytes,
                "walk_gb_s": walk_bytes / (row["ms"] * 1e-3) / 1e9, "paged_decode_tc_ms": dec_ms,
                "decode_over_walk": dec_ms / row["ms"], "library_ms": None}
            del kp, vp, sc, table, lengths, qd
            torch.cuda.empty_cache()
    return out


def time_probe_d128(probes, flash, benchit, gen, card, report, groups=tuple(PROBE_D128_ROWS),
                    iters=20):
    """The rows of PROBE_D128_ROWS at D128_SHAPE, each row's output held
    against its plain version there, beside flash_fwd_tc and SDPA on the
    same inputs; each (source, mode)'s plain version run and timed once."""
    bh, s, d = D128_SHAPE["bh"], D128_SHAPE["s"], D128_SHAPE["d"]
    q, k, v = _bf16_qkv(gen, bh, s, d)
    kt, vt = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    ones = torch.ones_like(v)
    pairs = bh * s * s
    sdpa = _sdpa_ms(benchit, q, k, v, False, d**-0.5)
    out = {"shape": f"BH={bh} S={s} d={d} non-causal bf16", "live_pairs": pairs,
           "flash_fwd_tc_ms": benchit.cuda_time_ms(
               lambda: flash.flash_attention(q, k, v, scale=d**-0.5), warmup=3, iters=iters),
           "sdpa_ms": sdpa}
    plains = {}  # (source, mode) -> (its plain output, its plain ms)

    def fns(source, mode):
        if source == "mma":
            return (lambda: probes.probe_mma(mode, q, k, v),
                    lambda: probes.probe_mma_plain(mode, q, k, v, scale=d**-0.5))
        cfg = probes.D128_MODES[mode]
        kk = kt if cfg.kt else k
        vv = ones if source == "ones" else vt if cfg.vt else v
        return (lambda: probes.probe_d128(mode, q, kk, vv),
                lambda: probes.probe_d128_plain(mode, q, kk, vv, scale=d**-0.5))

    for group in groups:
        rows = {}
        for row, source, mode in PROBE_D128_ROWS[group]:
            run, plain_fn = fns(source, mode)
            if (source, mode) not in plains:
                plains[(source, mode)] = (plain_fn(), benchit.cuda_time_ms(plain_fn, warmup=1,
                                                                           iters=3))
            want, plain_ms = plains[(source, mode)]
            check = f"d128/timed/{group}/{row}"
            hold = ((lambda got, want, mode=mode, check=check: _mma_rec(report, check, mode, got,
                                                                        want))
                    if source == "mma" else
                    (lambda got, want, check=check: _probe_rec(report, check, got, want,
                                                               PROBE_TOL)))
            rec = _probe_row(benchit, card, run, None, hold, want=want, nbytes=4 * q.numel() * 2,
                             flops=(2 if source == "mma" and mode in (1, 2) else 4) * d * pairs,
                             iters=iters)
            form = ({"tpu": probes.MMA_MODES[mode][2]} if source == "mma"
                    else dataclasses.asdict(probes.D128_MODES[mode]))
            rows[row] = {"source": f"{source} {mode}", "form": form, **rec,
                         "plain_ms": plain_ms, "library_ms": sdpa,
                         "vs_flash_fwd_tc": rec["ms"] / out["flash_fwd_tc_ms"]}
        out[group] = rows
    return out


def _d128de_flops(cfg, bh, s, d):
    """The products' flops of a D128DE mode: both over every pair, or one
    over every pair and the other over the first 128 keys (the heavy
    modes)."""
    if cfg.var in ("qk_heavy", "pv_heavy"):
        return 2 * d * bh * s * s + 2 * d * bh * s * 128
    return 4 * d * bh * s * s


def _cublas_fn(a, b):
    """probe_d128e.py's xla_m body: a bf16 product into float32, its
    reshape-sum (N >= K) or tile to K columns, the cast to bf16."""
    try:
        out = torch.mm(a, b, out_dtype=torch.float32)
    except (TypeError, RuntimeError):  # no out_dtype here: the bf16 product, then float32
        out = torch.matmul(a, b).float()
    k = a.shape[1]
    if out.shape[1] >= k:
        out = out.reshape(a.shape[0], -1, k).sum(1)
    else:
        out = out.repeat(1, k // out.shape[1])
    return out.to(a.dtype)


def time_probe_d128de(probes, benchit, gen, card, report, groups=tuple(PROBE_D128DE_ROWS),
                      iters=20):
    """Items 4 and 5 (scripts/probe_d128d.py, probe_d128e.py) at their
    shape, unscaled, uniform inputs: each mode held against its plain
    version there, beside its bound and SDPA (scale 1); group ``e`` also
    times its xla_m products on cuBLAS (yardsticks, never a port)."""
    bh, s, d = D128_SHAPE["bh"], D128_SHAPE["s"], D128_SHAPE["d"]
    q, k, v = (_uniform(gen, bh, s, d).to(torch.bfloat16) for _ in range(3))
    vt = v.transpose(1, 2).contiguous()
    sdpa = _sdpa_ms(benchit, q, k, v, False, 1.0)
    out = {"shape": f"BH={bh} S={s} d={d} non-causal bf16 unscaled, float32 out",
           "live_pairs": bh * s * s, "sdpa_ms": sdpa}
    for group in groups:
        rows = {}
        for name in PROBE_D128DE_ROWS[group]:
            cfg = probes.D128DE_MODES[name]
            args = _d128de_args(probes, name, q, k, v, vt)
            flops = _d128de_flops(cfg, bh, s, d)
            rec = _probe_row(
                benchit, card, lambda name=name, args=args: probes.probe_d128de(name, *args),
                lambda name=name, args=args: probes.probe_d128de_plain(name, *args),
                lambda got, want, name=name: _probe_rec(report, f"d128de/timed/{group}/{name}", got,
                                                        want, PROBE_TOL),
                nbytes=3 * q.numel() * 2 + q.numel() * 4, flops=flops, iters=iters)
            rows[name] = {"tpu": cfg.item, "form": dataclasses.asdict(cfg), **rec,
                          "library_ms": sdpa}
            torch.cuda.empty_cache()
        if group == "e":
            cub = {}
            for name, (m, kk, n) in CUBLAS_ROWS.items():
                a = _uniform(gen, m, kk).to(torch.bfloat16)
                b = _uniform(gen, kk, n).to(torch.bfloat16)
                ms = benchit.cuda_time_ms(lambda a=a, b=b: _cublas_fn(a, b), warmup=3, iters=iters)
                fl = 2 * m * kk * n
                cub[name] = {"shape": f"({m},{kk})@({kk},{n})", "ms": ms, "tflop_s": fl / ms / 1e9,
                             **benchit.bound_ms(card, bytes_moved=2 * (m * kk + kk * n + m * kk),
                                                flops=fl, dtype="bfloat16")}
            rows["cublas"] = cub
        out[group] = rows
    return out


def time_probe_fp32(probes, flash, benchit, gen, card, report, iters=20):
    """Item 7 (scripts/probe_small_fp32b.py) at its shape, unscaled, uniform
    float32 inputs packed as the script packs them: each mode held against
    its plain version there, beside its bound (the logical work, 4 d flops
    a pair over the bf16 peak; ``machine_bound_ms`` beside it: the packed
    modes' products take four times that work on bf16 tensor cores), SDPA
    in float32 and the port's own float32 ``flash_attention`` on the same
    float32 inputs: its float32 form in the default "bf16_3x" (the probe's
    function with the kernel's masks and tiles), in "float32" (three bf16
    terms, six products) and the scalar kernel's exact float32."""
    bh, s, d = FP32_SHAPE["bh"], FP32_SHAPE["s"], FP32_SHAPE["d"]
    qf, kf, vf = (_uniform(gen, bh, s, d) for _ in range(3))
    f = torch.nn.functional.scaled_dot_product_attention
    sdpa = benchit.cuda_time_ms(lambda: f(qf[None], kf[None], vf[None], scale=1.0), warmup=3,
                                iters=iters)
    fwd = benchit.cuda_time_ms(
        lambda: flash.flash_attention(qf, kf, vf, scale=1.0, precision="float32"), warmup=3,
        iters=iters)
    fwd_tc = benchit.cuda_time_ms(lambda: flash.flash_attention(qf, kf, vf, scale=1.0),
                                  warmup=3, iters=iters)
    with flash.scalar_forms():
        scalar = benchit.cuda_time_ms(
            lambda: flash.flash_attention(qf, kf, vf, scale=1.0, precision="float32"), warmup=1,
            iters=5)
    logical = 4 * d * bh * s * s
    out = {"shape": f"BH={bh} S={s} d={d} non-causal float32 unscaled, as two bf16 terms",
           "live_pairs": bh * s * s, "sdpa_float32_ms": sdpa, "flash_fwd_float32_ms": fwd,
           "flash_fwd_tc_f32_ms": fwd_tc, "flash_fwd_scalar_ms": scalar, "modes": {}}
    for mode in probes.FP32_MODES:
        args = probes.fp32_inputs(qf, kf, vf, mode)
        nbytes = sum(x.numel() * 2 for x in args) + bh * s * d * 4
        rec = _probe_row(
            benchit, card, lambda mode=mode, args=args: probes.probe_fp32(mode, *args),
            lambda mode=mode, args=args: probes.probe_fp32_plain(mode, *args),
            lambda got, want, mode=mode: _probe_rec(report, f"fp32/timed/{mode}", got, want,
                                                    _fp32_tol(mode)),
            nbytes=nbytes, flops=logical, iters=iters)
        machine = benchit.bound_ms(card, bytes_moved=nbytes,
                                   flops=logical * (1 if mode == "bf16_skel" else 4),
                                   dtype="bfloat16")
        out["modes"][mode] = {**rec, "machine_bound_ms": machine["bound_ms"],
                              "library_ms": sdpa, "flash_fwd_float32_ms": fwd,
                              "flash_fwd_tc_f32_ms": fwd_tc, "flash_fwd_scalar_ms": scalar}
        del args
        torch.cuda.empty_cache()
    return out


def probe_timings(probes, flash, decode, quant, benchit, gen, card, report, iters=20):
    """Every probe group timed at its own shape, each output held against
    its plain version there (the probes phase's path)."""
    return {
        "mma": {f"d{d}": time_probe_mma(probes, flash, benchit, gen, card, report, d, iters)
                for d in MMA_SHAPES},
        "int8": time_probe_int8(probes, benchit, gen, card, report, iters),
        "stream": time_probe_stream(probes, decode, quant, benchit, gen, card, report, iters),
        "d128": time_probe_d128(probes, flash, benchit, gen, card, report, iters=iters),
        "d128de": time_probe_d128de(probes, benchit, gen, card, report, iters=iters),
        "fp32": time_probe_fp32(probes, flash, benchit, gen, card, report, iters),
    }


# The probe libraries' entries of the kernels line: (name, source, the TPU
# kernel it ports, launch counters, its representative check and timed row,
# and, where one library holds only some of the counters' modes, those).
PROBE_ENTRIES = (
    ("probe_mma", "probe_mma.cu (fa_probe_mma)",
     "scripts/probe_mxu.py:73 (_qk_like; _pv_like :114), scripts/probe_local_softmax.py:100, "
     "scripts/probe_chain.py:98, scripts/probe_d128.py:178 (split2)",
     ("probe_mma",), "probe/mma/timed/d128/mode0", ("mma", "d128", "modes", "0")),
    ("probe_int8", "probe_mma.cu (fa_probe_int8)", "scripts/probe_int8_decode.py:109",
     ("probe_int8",), "probe/int8/timed/prefill_mha/int8mma",
     ("int8", "prefill_mha", "flavors", "int8mma")),
    ("probe_stream", "probe_mma.cu (fa_probe_stream)", "scripts/probe_small_fp32.py:43",
     ("probe_stream_sum", "probe_page_walk"), "probe/stream/timed/hbm_floor",
     ("stream", "hbm_floor")),
    ("probe_d128", "probe_d128.cu (probe_d128_0, probe_d128_1)",
     "scripts/probe_d128.py:178, scripts/probe_d128b.py:73, scripts/probe_d128c.py:92, "
     "scripts/probe_d128f.py:56", ("probe_d128",), "probe/d128/timed/pipeline/skeleton",
     ("d128", "pipeline", "skeleton")),
    ("probe_d128_2", "probe_d128.cu (probe_d128_2: base, pv_bf16out)",
     "scripts/probe_d128d.py:75 (base), scripts/probe_d128e.py:71 (pv_bf16out)", ("probe_d128de",),
     "probe/d128de/timed/d/base", ("d128de", "d", "base"), ("base", "pv_bf16out")),
    ("probe_d128t", "probe_d128t.cu",
     "scripts/probe_d128d.py:75 (t_vt, t_vtk, t_full, t_o_norm), scripts/probe_d128e.py:71 "
     "(t_qk_heavy, t_pv_heavy)", ("probe_d128de",), "probe/d128de/timed/d/t_vt",
     ("d128de", "d", "t_vt"), ("t_vt", "t_vtk", "t_full", "t_o_norm", "t_qk_heavy", "t_pv_heavy")),
    ("probe_fp32", "probe_fp32.cu", "scripts/probe_small_fp32b.py:101", ("probe_fp32",),
     "probe/fp32/timed/full", ("fp32", "modes", "full")),
)
_ROW_KEYS = ("ms", "plain_ms", "bound_ms", "bound_by", "bytes_ms", "ops_ms", "library_ms")


def _probe_entries(report, launches):
    """The probes' entries of the kernels line, each with its modes' checks."""
    checks = {r["check"]: r for r in report["checks"] if r["check"].startswith("probe/")}
    out = []
    for name, source, replaces, counters, check, path, *modes in PROBE_ENTRIES:
        row = report["probes"]["timings"]
        for key in path:
            row = row[key]
        group = check.split("/")[1]
        by_mode = {m: n for c in counters
                   for m, n in report["probes"]["launches_by_mode"][c].items()
                   if not modes or m in modes[0]}
        out.append({
            "name": name, "route": "cuda", "source": f"flashattention_tpu_torch/csrc/{source}",
            "replaces": replaces,
            "launches": sum(by_mode.values()) if modes else sum(launches[c] for c in counters),
            "launches_by_mode": by_mode,
            "max_abs_err": checks[check]["max_abs_err"], "rel_err": checks[check]["rel_err"],
            "tol": checks[check]["tol"], "check": check, "shape": "/".join(path),
            **{k: row.get(k) for k in _ROW_KEYS},
            "checks": {c: {"rel_err": r["rel_err"], "ok": r["ok"]} for c, r in checks.items()
                       if c.split("/")[1] == group},
        })
    return out


def _probe_counters(probes):
    """The probe wrappers' launch counters."""
    return {"probe_mma": (probes.probe_mma, "launches"),
            "probe_int8": (probes.probe_int8, "launches"),
            "probe_stream_sum": (probes.probe_stream_sum, "launches"),
            "probe_page_walk": (probes.probe_page_walk, "launches"),
            "probe_d128": (probes.probe_d128, "launches"),
            "probe_d128de": (probes.probe_d128de, "launches"),
            "probe_fp32": (probes.probe_fp32, "launches")}


def phase_selftest(counters, report):
    """``utils/selftest.py``'s 21 checks on the card's kernels; each check
    asserts that the kernel it is named for launched, the two float32
    checks at d = 64 the float32 form (the JAX default, "bf16_3x")."""
    from flashattention_tpu_torch.utils import selftest

    recs, res = [], []
    wall, launches = _drive(counters, lambda: res.append(
        selftest.run(verbose=False, records=recs)))
    passed, failed, failures = res[0]
    # fwd_fp32_default and lane_packed_d64 run the float32 form ("bf16_3x")
    rec = {"phase": "selftest", "passed": passed, "failed": failed, "failures": failures,
           "ok": failed == 0 and passed == len(selftest.CHECKS)
           and launches["flash_fwd_tc_f32"] >= 2, "checks": recs,
           "launches": launches, "seconds": wall}
    report["selftest"] = rec
    emit({k: rec[k] for k in ("phase", "passed", "failed", "failures", "ok", "seconds")})
    return rec


# The CLIs (flashattention_tpu_torch/cli/) the benches phase runs: (module, argv).
BENCH_RUNS = (("bench", []), ("bench_flashattention", []), ("bench_decode", []),
              ("bench_serving", ["--layers", "32"]), ("bench_train", []), ("lab", ["--all"]),
              ("smoke", []))


def _run_cli(name, argv):
    """``cli.<name>.main(argv)`` in this process: its exit code, JSON rows
    and other lines."""
    import importlib
    import io

    mod = importlib.import_module(f"flashattention_tpu_torch.cli.{name}")
    buf, rc, error = io.StringIO(), 0, None
    try:
        with contextlib.redirect_stdout(buf):
            mod.main(argv)
    except SystemExit as e:
        rc = e.code if isinstance(e.code, int) else 1
        error = None if isinstance(e.code, int) else str(e.code)
    except Exception as e:  # noqa: BLE001 — reported as the CLI's failure
        rc, error = 1, f"{type(e).__name__}: {e}"
    lines = buf.getvalue().splitlines()
    rows = [json.loads(ln) for ln in lines if ln.startswith("{")]
    return rc, rows, [ln for ln in lines if not ln.startswith("{")], error


def phase_benches(card, counters, report):
    """Every CLI of ``flashattention_tpu_torch/cli/`` on the card with its
    defaults (``bench_serving`` at the published 32 layers), each row
    re-emitted; a CLI passes if it exits 0 and its rows (smoke: its text)
    carry the card's ``nvidia-smi`` line."""
    recs = {}

    def drive():
        for name, argv in BENCH_RUNS:
            t0 = time.perf_counter()
            rc, rows, text, error = _run_cli(name, argv)
            carded = [r for r in rows if "card" in r] or [{"card": t.split(": ", 1)[1]}
                                                         for t in text if t.startswith("card: ")]
            rec = {"cli": name, "argv": argv, "rc": rc, "error": error, "rows": rows,
                   "text": text, "seconds": time.perf_counter() - t0,
                   "ok": rc == 0 and bool(carded) and all(r["card"] == card for r in carded)}
            recs[name] = rec
            emit({"phase": "benches", **rec})

    wall, launches = _drive(counters, drive)
    # bench's headline, bench_flashattention and lab's rung 4 take float32's
    # default form; bench's fp32_fast its one-pass "bf16" mode.
    rec = {"ok": all(r["ok"] for r in recs.values()) and launches["flash_fwd_tc_f32"] > 0
           and launches["flash_fwd_tc_f32_bf16"] > 0, "clis": recs, "launches": launches,
           "seconds": wall}
    report["benches"] = rec
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=32, help="serve depth (published: 32)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from flashattention_tpu_torch.models import train, transformer
    from flashattention_tpu_torch.ops import backward, decode, flash, kernels, probes, quant
    from flashattention_tpu_torch.runtime import engine as engine_mod
    from flashattention_tpu_torch.runtime import kvcache, native
    from flashattention_tpu_torch.utils import benchit, packing
    import flashattention_tpu_torch as fa

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in float32
    torch.backends.cudnn.allow_tf32 = False
    card = benchit.card_info()
    name = torch.cuda.get_device_name(0)
    report = {"card": card, "device": name, "build": {}, "checks": []}
    counters = {**_counters(flash, decode, backward), **_probe_counters(probes)}

    laps, t_lap = {}, [t_start]

    def lap(name):  # seconds since the previous lap, by phase group
        now = time.perf_counter()
        laps[name], t_lap[0] = now - t_lap[0], now

    phase_build(kernels, native, report)
    lap("build")
    selftest = phase_selftest(counters, report)
    lap("selftest")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)

    def counts():
        return {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}

    before_checks = counts()
    # {None, "int8", "fp8"}: {kernel: (main shape's timed check, Gemma-2 window's)}
    serving = {form: serving_checks(fa, flash, decode, benchit, gen, name, report, form)
               for form in (None, *QUANT_FORMS)}
    poison = prefill_poison_check(decode, gen, report)
    decode_poison = decode_poison_check(decode, gen, report)
    split_edge_checks(decode, gen, report)
    decode_f32_term_checks(decode, gen, report)
    decode_serve = decode_serve_shape_timing(decode, benchit, gen, name, report)
    head_dim_pad_check(fa, flash, backward, gen, report)
    lap("serving_checks")
    f32_headline = f32_form_checks(fa, flash, probes, benchit, gen, name, report)
    lap("f32_form_checks")
    f32_train_checks(backward, flash, gen, report)
    lap("f32_train_checks")
    pair_f32_checks(backward, flash, probes, gen, report)
    lap("pair_f32_checks")
    # {None, "int8", "fp8"}: {"llama": timed draft-form check, "gemma2": ...}
    drafts = {form: draft_checks(decode, benchit, gen, name, report, form)
              for form in (None, *QUANT_FORMS)}
    lap("draft_checks")
    # The kernel checks' launches (the scalar 8-bit forms launch only there).
    check_launches = {k: n - before_checks[k] for k, n in counts().items()}
    f32q_timings(fa, flash, decode, benchit, gen, name, report)
    lap("f32q_timings")
    before_bwd = counts()
    mains = {
        **{k: main for k, (main, _) in serving[None].items()},
        "flash_naive": naive_checks(flash, benchit, gen, name, report),
        **bwd_checks(backward, flash, benchit, packing, args, gen, name, report),
    }
    lap("naive_bwd_checks")
    # {backward kernel: {windowed case: its timed check}}
    bwd_windowed = bwd_window_checks(backward, flash, benchit, gen, name, report)
    lap("bwd_window_checks")
    # The backward checks' launches (the scalar pair launches only there).
    bwd_launches = {k: n - before_bwd[k] for k, n in counts().items()}
    # {kernel: timed dropout check}, and the 8-bit form's under "flash_fwd_quant"
    before_dropout = counts()
    dropout = dropout_checks(fa, backward, flash, benchit, packing, args, gen, name, report)
    # The dropout checks' launches (the scalar pair's dropout form launches only there).
    dropout_launches = {k: n - before_dropout[k] for k, n in counts().items()}
    # {kernel: {mask: timed block-mask check}}
    masked = block_mask_checks(backward, flash, benchit, gen, name, report)
    lap("dropout_block_mask_checks")
    attn_bm = phase_attention_block_mask(fa, counters, gen, report)
    lap("attention_block_mask")
    # The probes: each held against its plain version, then timed at its
    # own shape (the counted run).
    probe_checks(probes, decode, quant, gen, report)
    probe_times = {}
    for fn, _ in _probe_counters(probes).values():
        fn.launches_by_mode = {}
    n_checks = len(report["checks"])
    wall, probe_launches = _drive(counters, lambda: probe_times.update(
        probe_timings(probes, flash, decode, quant, benchit, gen, name, report)))
    timed = report["checks"][n_checks:]
    report["probes"] = {"timings": probe_times, "launches": probe_launches, "seconds": wall,
                        "launches_by_mode": {k: dict(fn.launches_by_mode)
                                             for k, (fn, _) in _probe_counters(probes).items()}}
    emit({"phase": "probes", "seconds": wall,
          "launches": {k: probe_launches[k] for k in _probe_counters(probes)},
          "timed_checks": len(timed), "ok": all(r["ok"] for r in timed),
          "failed": [r["check"] for r in timed if not r["ok"]]})
    lap("probes")
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
    sharded = phase_serve_sharded(args, transformer, train, kvcache, counters, report)
    lap("serve_sharded")
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
    mixtral = phase_serve_mixtral_int8(args, transformer, quant, engine_mod, kvcache, benchit,
                                       counters, report)
    lap("serve_mixtral")
    benches = phase_benches(card, counters, report)
    lap("benches")
    cross = phase_crosscheck(fa, flash, decode, gen, report)
    quant_ops = phase_quant_ops(fa, flash, quant, gen, report)
    phase_parity(args, transformer, kvcache, engine_mod, report)
    phase_parity_quant(args, transformer, quant, kvcache, engine_mod, report)
    phase_parity_gemma2(args, transformer, kvcache, engine_mod, report)
    phase_parity_speculative(args, transformer, kvcache, report)
    lap("crosscheck_parity")
    phase_parity_mixtral(args, transformer, kvcache, engine_mod, report)
    lap("parity_mixtral")
    # The float32 parity phases' CPU references run in a worker thread (one
    # at a time, leaving the host two cores): Gemma-2's (the longest, and at
    # 256000 tokens of vocabulary 35 GB of results) beside the device-bound
    # training phases below (their device idle share 0.1-1.1%, PERF.md
    # section 5), awaited before the host-bound serving of the LoRA-merged
    # model; each of the others beside the card half of the phase before it.
    # All four at once would pass the host's 96 GiB.
    parity_specs = {"train_parity_gemma2_w128": {}, "train_parity": {},
                    "train_parity_dropout": dict(attn_dropout=0.1),
                    "train_parity_mistral_w128": {}}
    for phase, make_cfg in (("train_parity_mistral_w128", transformer.ModelConfig.mistral7b),
                            ("train_parity_gemma2_w128", transformer.ModelConfig.gemma2_9b)):
        parity_specs[phase] = dict(cfg=dataclasses.replace(
            make_cfg(num_layers=2), dtype="float32", sliding_window=PARITY_WINDOW),
            docs=PARITY_DOCS)
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    threads = max(1, (os.cpu_count() or 2) - 2)

    def reference(phase, inputs=None):
        spec = parity_specs[phase]
        if inputs is None:  # made in the worker, the windowed cut's parameters on the card
            inputs = _parity_inputs(args, transformer, packing, spec.get("cfg"),
                                    spec.get("docs", (70, 100, 50)))
        return inputs, parity_reference(train, inputs, spec.get("attn_dropout"), threads)

    first = next(iter(parity_specs))
    references = {first: pool.submit(reference, first, _parity_inputs(
        args, transformer, packing, parity_specs[first]["cfg"], PARITY_DOCS))}
    lap("parity_inputs")
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
    trained.update(phase_train_mixtral(args, transformer, train, packing, flash, benchit,
                                       counters, name, report))
    lap("train_mixtral")
    trained["train_lora"], base, lora = phase_train_lora(args, transformer, train, benchit,
                                                         counters, name, report)
    lap("train_lora")
    concurrent.futures.wait(references.values())
    lap("parity_reference_wait")
    lora_served = phase_serve_lora_merged(args, transformer, train, quant, engine_mod, kvcache,
                                          counters, report, base, lora)
    del base, lora
    torch.cuda.empty_cache()
    lap("serve_lora_merged")
    trained.update(phase_train_mixed(args, transformer, train, packing, flash, benchit,
                                     counters, name, report))
    lap("train_mixed")
    phase_checkpoint(args, transformer, quant, train, engine_mod, kvcache, report)
    lap("checkpoint")
    # Float32 training on the card against the CPU references, the next
    # phase's computed meanwhile.
    parity = {}
    phases = list(parity_specs)
    for i, phase in enumerate(phases):
        if i + 1 < len(phases):
            references[phases[i + 1]] = pool.submit(reference, phases[i + 1])
        parity[phase] = phase_train_parity(args, transformer, train, packing, counters, report,
                                           phase=phase, reference=references.pop(phase).result(),
                                           **parity_specs[phase])
    pool.shutdown()
    parity["train_parity_lora"] = phase_train_parity_lora(args, transformer, train, counters,
                                                          report)
    lap("train_parity")

    paths = {"serve": serve["launches"], "serve_chunked": chunked["launches"],
             "serve_int8": serve_int8["launches"], "serve_mixtral_int8": mixtral["launches"],
             "serve_gemma2": gemma["launches"], "serve_gemma2_whole": gemma_whole["launches"],
             "serve_gemma2_fp8": gemma_fp8["launches"],
             "serve_multistep": _launch_sum(multistep), "serve_speculative": _launch_sum(speculative),
             "serve_speculative_gemma2": _launch_sum(gemma_spec), "serve_sharded": sharded["launches"],
             "crosscheck": cross["launches"], "quant_ops": quant_ops["launches"],
             "attention_block_mask": attn_bm["launches"], "selftest": selftest["launches"],
             "probes": probe_launches, "benches": benches["launches"],
             **{p: r["launches"] for p, r in lora_served.items()},
             **{p: r["launches"] for p, r in trained.items()},
             **{p: r["launches"] for p, r in parity.items()}}
    summary = []
    tc_timed = report["tc_timed"]
    mains["flash_fwd_tc"] = tc_timed["flash_fwd_tc"]
    mains["paged_prefill_tc"] = tc_timed["paged_prefill_tc"]
    mains["flash_fwd_tc_quant"] = tc_timed["flash_fwd_tc/int8"]
    mains["paged_prefill_tc_quant"] = tc_timed["paged_prefill_tc/int8"]
    mains["paged_decode_tc"] = tc_timed["paged_decode_tc"]
    mains["paged_decode_tc_quant"] = tc_timed["paged_decode_tc/int8"]
    mains["flash_fwd_tc_f32"] = tc_timed["flash_fwd_tc_f32"]
    mains["flash_fwd_f32"] = tc_timed["flash_fwd_f32"]
    mains["paged_prefill_tc_f32"] = tc_timed["paged_prefill_tc_f32"]
    mains["paged_decode_tc_f32"] = tc_timed["paged_decode_tc_f32"]
    mains["flash_fwd_tc_f32_extra"] = dropout["flash_fwd_tc_f32_extra"]
    timed_keys = ("check", "shape", "max_abs_err", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
                  "bytes_ms", "ops_ms", "library_ms")
    scalar_of = {tc: k for k, tc in TC_KERNELS.items()}
    scalar_of.update({tc: f"{k} (its 8-bit form, -DFA_QUANT)" for k, tc in TC_QUANT_KERNELS.items()})
    scalar_of["flash_fwd_tc_f32"] = 'flash_fwd (exact float32, the scalar kernel)'
    scalar_of["flash_fwd_f32"] = 'flash_fwd (exact float32, the scalar kernel)'
    scalar_of["paged_prefill_tc_f32"] = "paged_prefill (exact float32, the scalar kernel)"
    scalar_of["paged_decode_tc_f32"] = "paged_decode (exact float32, the scalar kernel)"
    scalar_of["flash_bwd_tc_f32"] = "flash_bwd (exact float32, the scalar kernel)"
    scalar_of["flash_fwd_tc_f32_extra"] = "flash_fwd (exact float32, its dropout form)"
    scalar_of.update({f32: f"{k} (exact float32, the scalar kernel)" for k, f32 in PAIR_F32.items()})
    # A kernel's own launches: its counter's less those of the forms counted
    # within it (the scalar kernel's wrapper counts the tensor-core forms',
    # the tensor-core form's counter its 8-bit form's, the float32 form's
    # csrc/flash_fwd_f32.cuh's).
    within = {**{k: (tc,) for k, tc in TC_KERNELS.items()},
              **{TC_KERNELS[k]: (tc,) for k, tc in TC_QUANT_KERNELS.items()},
              "flash_fwd": ("flash_fwd_tc", "flash_fwd_tc_f32"),
              "flash_fwd_tc_f32": ("flash_fwd_f32", "flash_fwd_tc_f32_extra"),
              "flash_bwd": ("flash_bwd_tc", "flash_bwd_tc_f32"),
              **{k: (TC_KERNELS[k], f32) for k, f32 in PAIR_F32.items()},
              "paged_prefill": ("paged_prefill_tc", "paged_prefill_tc_f32"),
              "paged_decode": ("paged_decode_tc", "paged_decode_tc_f32")}
    for kname, source, replaces in KERNELS:
        main_rec = mains[kname]
        by_path = {p: n.get(kname, 0) - sum(n.get(w, 0) for w in within.get(kname, ()))
                   for p, n in paths.items()}
        by_path = {p: x for p, x in by_path.items() if x}
        built = (" (built with -DFA_QUANT)" if kname in TC_QUANT_KERNELS.values()
                 else " (built with -DFA_PAIR)" if kname == "flash_bwd_dkv_tc"
                 else " (built with -DFA_PAIR -DFA_F32)" if kname == "flash_bwd_dkv_tc_f32"
                 else " (built with -DFA_F32)" if kname in ("flash_fwd_tc_f32",
                                                           "paged_prefill_tc_f32",
                                                           "paged_decode_tc_f32",
                                                           "flash_bwd_tc_f32",
                                                           "flash_bwd_dq_tc_f32")
                 else " (built with -DFA_F32 -DFA_EXTRA)" if kname == "flash_fwd_tc_f32_extra"
                 else " (built into flash_fwd_tc_f32: csrc/flash_fwd_tc.cu with -DFA_F32)"
                 if kname == "flash_fwd_f32" else "")
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
        for key, label in ((kname, "float32"), (f"{kname}/dropout", "float32_dropout"),
                           (f"{kname}/d256_window_softcap", "float32_d256_window_softcap")):
            if key in report.get("float32_timed", {}):  # the scalar kernel in float32, timed
                rec32 = report["float32_timed"][key]
                summary[-1][label] = {k: rec32.get(k) for k in (
                    "check", "shape", "max_abs_err", "kernel_ms", "plain_ms", "bound_ms",
                    "bound_by", "bytes_ms", "ops_ms", "library_ms", "library")}
        if kname in scalar_of:  # the tensor-core form: the scalar form's time beside it
            summary[-1]["scalar_form"] = scalar_of[kname]
            summary[-1]["scalar_ms"] = main_rec["scalar_ms"]
        if kname == "flash_bwd_tc_f32":  # its "bf16" mode, and its dropout form (rate 0.1)
            summary[-1]["bf16_mode_ms"] = main_rec["bf16_mode_ms"]
            summary[-1]["products"] = main_rec["products"]
            summary[-1]["dropout"] = _extra_entry(
                dropout["flash_bwd_tc_f32/dropout"], paths, "flash_bwd_tc_f32_dropout",
                (*timed_keys, "no_dropout_ms", "scalar_ms"))
        if kname in PAIR_F32.values():  # its "bf16" mode, and its dropout form (rate 0.1)
            summary[-1].update({k: main_rec[k] for k in ("bf16_mode_ms", "products",
                                                         "split_pass_bytes", "live_pairs")})
            summary[-1]["dropout"] = _extra_entry(
                dropout[kname], paths, f"{kname}_dropout",
                (*timed_keys, "no_dropout_ms", "scalar_ms"))
        if kname == "flash_fwd_tc_f32_extra":
            summary[-1]["products"] = main_rec["products"]
            summary[-1]["no_dropout_ms"] = main_rec["no_dropout_ms"]
        if kname == "flash_fwd_tc_f32":  # its "bf16" mode, and cli/bench.py's headline shape
            summary[-1]["bf16_mode_ms"] = main_rec["bf16_mode_ms"]
            summary[-1]["bf16_mode_launches_by_path"] = {
                p: n["flash_fwd_tc_f32_bf16"] for p, n in paths.items()
                if n.get("flash_fwd_tc_f32_bf16")}
            summary[-1]["headline"] = {k: f32_headline[k] for k in (
                *timed_keys, "scalar_ms", "bf16_mode_ms", "exact_ms", "products")}
        timed = timed_keys
        if kname in bwd_windowed:
            summary[-1]["windowed"] = {case: {k: rec[k] for k in (*timed, "scalar_ms") if k in rec}
                                       for case, rec in bwd_windowed[kname].items()}
        if kname == "flash_bwd_tc_f32":  # d = 256: Gemma-2's layer, its "bf16" mode, rate 0.1
            gem, rec = (x[TIMED_F32_FUSED_WINDOW_CASE] for x in (summary[-1]["windowed"],
                                                                bwd_windowed[kname]))
            gem.update({k: rec[k] for k in ("bf16_mode_ms", "dropout_ms", "products",
                                            "live_pairs", "library")})
        if kname in PAIR_F32.values():  # d = 256: Gemma-2's packed layer, and with dropout 0.1
            gem, rec = (x[TIMED_F32_BWD_WINDOW_CASE] for x in (summary[-1]["windowed"],
                                                              bwd_windowed[kname]))
            gem.update({k: rec[k] for k in ("bf16_mode_ms", "products", "live_pairs")})
            gem["dropout"] = {k: dropout[f"{kname}/gemma2_packed"][k]
                              for k in (*timed, "no_dropout_ms", "scalar_ms")}
        if kname in (*PAIR, "flash_bwd"):  # on no path since the float32 forms take d = 256
            summary[-1]["check_launches"] = bwd_launches[kname] - sum(
                bwd_launches[x] for x in within[kname])
        if kname == "paged_decode":  # on no path since float32 pages take the float32 form
            summary[-1]["check_launches"] = check_launches[kname] - sum(
                check_launches[x] for x in within[kname])
        if kname in EXTRA_KERNELS:  # the dropout form: its timed check and launches
            less = (f"{TC_KERNELS[kname]}_dropout", f"{PAIR_F32[kname]}_dropout") if kname in PAIR else ()
            summary[-1]["dropout"] = _extra_entry(dropout[kname], paths, f"{kname}_dropout",
                                                  (*timed, "no_dropout_ms"), less)
            if kname in PAIR:  # on no path since the float32 pair's forms: the checks' launches
                summary[-1]["dropout"]["check_launches"] = (
                    dropout_launches[f"{kname}_dropout"] - sum(dropout_launches[x] for x in less))
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
            keys = (*timed, "no_mask_ms", "scalar_ms", "live_pairs", "live_fraction")
            summary[-1]["block_mask"] = _extra_entry(masked[kname]["documents"], paths,
                                                     f"{kname}_block_mask", keys)
            summary[-1]["block_mask"]["masks"] = {
                m: {k: rec[k] for k in keys} for m, rec in masked[kname].items()}
        if kname in ("paged_prefill_tc", "paged_prefill_tc_quant", "paged_prefill_tc_f32",
                     "paged_decode_tc", "paged_decode_tc_quant",
                     "paged_decode_tc_f32"):  # the NaN-poison checks
            summary[-1]["nan_poison"] = {
                r["check"]: r["ok"] for r in (decode_poison if "decode" in kname else poison)
                if ("/quant/" in r["check"]) == kname.endswith("_quant")
                and r["check"].split("/")[0] == kname.removesuffix("_quant")}
        if kname in ("flash_fwd_f32", "paged_prefill_tc_f32"):
            # Gemma-2's shape (d = 256, window 4096, softcap 50): the forward's
            # "bf16_3x" and "float32" modes, chunked prefill's float32 form,
            # each with the scalar kernel's time, SDPA float32 and the bound.
            keys = (*timed_keys, "scalar_ms", "products", "live_pairs")
            gem = {"d256_window_softcap": tc_timed[f"{kname}/d256_window_softcap"]}
            if kname == "flash_fwd_f32":
                gem["d256_window_softcap/precision_float32"] = tc_timed[
                    "flash_fwd_f32/d256_window_softcap/precision_float32"]
                summary[-1]["headline"] = {k: tc_timed["flash_fwd_f32/headline"].get(k)
                                           for k in keys}
            summary[-1].update({case: {k: rec.get(k) for k in keys} for case, rec in gem.items()})
            summary[-1]["products"] = main_rec.get("products")
        if kname in ("paged_decode_tc", "paged_decode_tc_quant"):
            # The draft form (k = 4) at the Llama and Gemma-2 shapes, and
            # serve_gemma2's profile decode shape; their launches by path.
            tc = "paged_decode_tc"
            forms = (None,) if kname == tc else QUANT_FORMS
            draft_keys = (*timed_keys, "scalar_ms", "row_tiles", "kv_bytes_as_read")
            summary[-1]["draft"] = {
                **{_tc_key(f"draft_{case}", None, f): {
                    k: tc_timed[_tc_key(tc, f"draft_{case}", f)][k] for k in draft_keys}
                   for case in TIMED_DRAFT_CASES for f in forms},
                "launches_by_path": {p: n["paged_decode_tc_draft"] for p, n in paths.items()
                                     if n.get("paged_decode_tc_draft")}}
            summary[-1]["serve_profile_gemma2"] = {
                k: decode_serve["bf16" if kname == tc else "fp8"][k]
                for k in (*timed_keys, "scalar_ms")}
        if kname == "paged_decode_tc_f32":
            # The draft form (k = 4) at the Llama and Gemma-2 shapes, Gemma-2
            # k = 1 at serve_gemma2's profile decode shape, each with the
            # scalar form's time beside it; the draft launches by path.
            draft_keys = (*timed_keys, "scalar_ms", "row_tiles", "kv_bytes_as_read", "k_times_k1_ms")
            summary[-1]["draft"] = {
                **{f"draft_{case}": {k: tc_timed[f"{kname}/draft_{case}"].get(k) for k in draft_keys}
                   for case in TIMED_DRAFT_CASES},
                "launches_by_path": {p: n["paged_decode_tc_f32_draft"] for p, n in paths.items()
                                     if n.get("paged_decode_tc_f32_draft")}}
            summary[-1]["serve_profile_gemma2"] = {
                k: decode_serve["float32"][k] for k in (*timed_keys, "scalar_ms")}
        if kname in ("flash_fwd_tc", "paged_prefill_tc", "paged_decode_tc"):  # Gemma-2's window
            summary[-1]["d256_window_softcap"] = {
                k: tc_timed[f"{kname}/d256_window_softcap"][k] for k in (*timed, "scalar_ms")}
        if kname in TC_QUANT_KERNELS.values():  # fp8 beside int8, and Gemma-2's window
            tc = kname.removesuffix("_quant")
            summary[-1]["fp8"] = {k: tc_timed[f"{tc}/fp8"][k] for k in (*timed, "scalar_ms")}
            # Float32 q over 8-bit K/V or pages, taken in bf16 (f32q_timings).
            summary[-1]["f32_q"] = {
                key.split("/", 1)[1]: {k: rec[k] for k in (
                    *timed, "scalar_ms", "exact_ms", "library_f32_ms") if k in rec}
                for key, rec in report["f32q_timed"].items() if key.startswith(kname + "/")}
            if kname == "flash_fwd_tc_quant":
                summary[-1]["f32_q"]["launches_by_path"] = {
                    p: n["flash_fwd_tc_quant_f32q"] for p, n in paths.items()
                    if n.get("flash_fwd_tc_quant_f32q")}
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
                "check_launches": (check_launches[f"{kname}_quant"]
                                   - check_launches[TC_QUANT_KERNELS[kname]]),
                "fp8": {k: q8["fp8"][0][k] for k in timed},
                "d256_window_softcap": {f: {k: q8[f][1][k] for k in timed} for f in QUANT_FORMS},
            }
    # The draft form of paged_decode: its own entry, timed at the Llama and
    # Gemma-2 shapes, its 8-bit forms beside it (the scalar form's; the
    # tensor-core forms' draft launches are in paged_decode_tc's and
    # paged_decode_tc_f32's entries).
    by_path = {p: n.get("paged_decode_draft", 0) - n.get("paged_decode_tc_draft", 0)
               - n.get("paged_decode_tc_f32_draft", 0) for p, n in paths.items()}
    by_path = {p: x for p, x in by_path.items() if x}
    timed = ("check", "shape", "max_abs_err", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
             "bytes_ms", "ops_ms", "library_ms", "k_times_k1_ms", "row_tiles", "kv_bytes_as_read")
    main_rec = drafts[None]["llama"]
    summary.append({
        "name": "paged_decode_draft", "route": "cuda",
        "source": "flashattention_tpu_torch/csrc/paged_decode.cu (built with -DFA_DRAFT)",
        "replaces": "flashattention_tpu/ops/decode.py:89 (draft_k > 1)",
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        "check_launches": (check_launches["paged_decode_draft"] - check_launches["paged_decode_tc_draft"]
                           - check_launches["paged_decode_tc_f32_draft"]),
        "max_abs_err": main_rec["max_abs_err"], "tol": main_rec["tol"], "shape": main_rec["check"],
        "ms": main_rec["kernel_ms"], **{k: main_rec[k] for k in timed if k not in ("check", "shape")},
        "gemma2": {k: drafts[None]["gemma2"][k] for k in timed},
        "forms_8bit": {f: {case: {k: drafts[f][case][k] for k in timed} for case in TIMED_DRAFT_CASES}
                       for f in QUANT_FORMS},
        "float32": {case: {k: report["float32_timed"]["paged_decode_draft"][case][k]
                           for k in (*timed, "library")} for case in TIMED_DRAFT_CASES},
    })
    summary += _probe_entries(report, probe_launches)
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
                           "train_parity_dropout", "serve_mixtral_int8", "parity_mixtral",
                           "parity_mixtral_chunked", "train_mixtral", "train_mixtral_packed",
                           "checkpoint", "train_lora", "serve_lora_merged",
                           "serve_lora_merged_int8", "train_mixed", "train_mixed_optax",
                           "train_mixed_packed", "train_mixed_remat_dropout",
                           "train_parity_lora", "selftest", "benches", "serve_sharded")
               if not report[p]["ok"]]
    # Every serve phase's allocator and scheduler ran on the C++ runtime core.
    failed += [f"{p}/native" for p in SERVE_PHASES
               if not all(report[p].get("native", {"recorded": False}).values())]
    # The scalar pair and the scalar fused backward left the paths when
    # float32 training at Gemma-2's d = 256 took the float32 forms (bf16
    # runs the tensor-core forms, float32 at d = 64 / 128 / 256 the float32
    # forms), and the scalar paged decode and its draft form when float32
    # pages took paged decode's float32 form: they must still launch in
    # their checks (ops.flash.scalar_forms).
    failed += [k["name"] for k in summary
               if k["launches"] == 0 and k.get("check_launches", 0) == 0]
    # The scalar 8-bit forms left the paths for their tensor-core forms
    # (which must launch, above): since float32 q over 8-bit pages is taken
    # in bf16, the float32 speculative phase's int8 cache runs paged
    # decode's tensor-core 8-bit form, k = 1 and draft, and no scalar 8-bit
    # form.  The scalar 8-bit forms must still launch in their kernel checks
    # (ops.flash.scalar_forms).
    failed += [f"{k['name']}/quantized" for k in summary
               if "quantized" in k and k["quantized"]["check_launches"] == 0]
    for run, rec in report["serve_speculative"]["int8_cache"].items():
        n = rec["launches"]
        if not (n["paged_decode_tc_quant"] > 0 and n["paged_decode_quant"] == n["paged_decode_tc_quant"]
                and n["paged_decode_draft"] == n["paged_decode_tc_draft"]
                and (run == "plain" or n["paged_decode_tc_draft"] > 0)):
            failed.append(f"serve_speculative/int8_cache/{run}/launches")
    failed += [f"{k['name']}/{form}" for k in summary for form in ("dropout", "block_mask")
               if form in k and k[form]["launches"] == 0 and not k[form].get("check_launches")]
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
