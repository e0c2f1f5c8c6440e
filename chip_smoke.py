#!/usr/bin/env python3
"""Smoke run of aimet_tpu_torch on one NVIDIA H100: Llama-3-8B served in
``w4``, ``w8`` and ``w4a8``, decoded layer by layer through
``fused_decode_layer`` as the JAX package's decode-step sweep does, and
calibrated in quantsim and lowered to the integer kernels in every
lowering mode; ResNet-50 and MobileNetV2 lowered the same way.

    python3 chip_smoke.py
    python3 chip_smoke.py --decode-slice     # K2 / K3 and the per-slot step
    python3 chip_smoke.py --layer-variants   # the whole-layer kernel's variants
    python3 chip_smoke.py --w4-slice         # KW4, the w4 prefill and step
    python3 chip_smoke.py --prefill-slice    # KW8 and K2 at prefill M
    python3 chip_smoke.py --lowered-slice    # KSQ and KW4G, lowered w8a8 / w4g
    python3 chip_smoke.py --q8-slice         # KQ8, K1, K2 at decode M, KGQA

1. builds the hand-written kernels from ``aimet_tpu_torch/csrc``: K1
   ``act_quant``, K2 ``w4a8_gemm``, K3 ``decode_attention``, KW4
   ``w4_gemm``, KW8 ``w8_gemm`` and KW4G ``w4_grouped_gemm``
   (``wo_gemm.cu``), KSQ ``w8a8_staticq`` (``w8a8_staticq.cu``), KQ8
   ``q8_gemm`` (``w8a8_gemm.cu``; its float entries' TMA + ``wgmma``
   tile listed as ``q8_tile``), K2's fused decode kernel ``w4a8_fusedq``
   (``w4a8_gemm.cu``: K1 folded in), KFL ``fused_wo_mlp``, KSOL
   ``sol_decode_layer`` and KDL ``fused_decode_layer`` (``fused_layer.cu``;
   KDL is KSOL's code, weight-only, counted on its own), KGQA
   ``gqa_decode_attention`` (``gqa_attention.cu``); KW8A8 ``w8a8_fusedq``
   is K1 then KQ8, counted on its own;
2. holds each kernel against its plain PyTorch version on the card at the
   main path's shapes (K1 codes, K2, KSQ, KW8A8 and KQ8 codes and outputs
   and every KV-cache byte bit-exact; KDL equal to KSOL bit for bit; the
   rest within a stated share of the plain output's max, KGQA with a bf16
   q within one bf16 ulp a prob; KW4 and KW8 on f32 x as well, the f32
   ``lm_head`` of a lowered model), and times kernel, plain version, the
   bound the card's peaks set and, beside the int8 GEMMs,
   ``torch._int_mm``; K1 at decode M (16 and 64 rows); K2 at decode M (1,
   16, 32, 64 at 4096 x 28672 and the padded ``lm_head``, bit-exact
   before timing), and K2's fused decode kernel at the same shapes with
   bf16 and f32 x (codes, scales and outputs bit-exact with K1 + K2's
   decode route and the plain version, one launch, timed beside K1 +
   K2); KQ8's tile bit-exact at 14336 x 4096 and the 3 x 3 conv patches
   with and without a bias, f32 and bf16 out, and through ``matmul_w8a8``
   at M = 4096, timed beside its block tile; KW4 on each of its routes
   at the main paths' shapes (decode M 1, 16, 32, 64 at 4096 x 28672, the padded ``lm_head`` and
   layer 0's QKV; M = 4096 at the four layer projections and the
   ``lm_head``; f32 x at the lowered ``lm_head``), each within KW4's share
   of its plain version and repeating its bits before it is timed; KW8 and
   K2 at M = 4096 on their TMA + ``wgmma`` tiles (KW8's f32 ``lm_head``
   beside ``torch._weight_int8pack_mm`` on the same f32 x); KSQ
   (bit-exact, codes and outputs, on its TMA + ``wgmma`` tile at M =
   4096) and KW4G (on its tile at M = 4096, groups 64, 128 and 256; an
   f32 x within TOL_W4G_F32, beside its block tile's error) at the
   lowered forward's shapes and dtypes, with an f32 x besides; K3 at
   B = 16, 32 and 1 with S = 1024 and at S = 16,384 (with a sweep of its
   chunk); it holds the im2col convs ``conv2d_w8`` (KW8) and ``conv2d_w4``
   (KW4) at ResNet-50 conv shapes within KW8's and KW4's share; it probes
   ``torch._weight_int8pack_mm`` and ``torch._weight_int4pack_mm`` for the
   library column of KW8, KW4 and KW4G;
3. draws ``TransformerConfig.llama3_8b()`` weights at full width and depth
   (32 layers) with ``random_quantized_weights`` on the card and drives
   each path with the launch counts set to 0 just before it and read just
   after; every kernel of that path must have launched:
   - ``w4``: a prefill of 8 x 512, 32 decode steps at batch 16 and 32
     (scalar position: KW4 + KSOL), steps at per-slot positions (launches
     counted, 4 profiled: device ms by kernel, busy share) and 32
     requests through ``ContinuousBatcher(num_slots=16, step_chunk=4)``
     (KW4 + K3 + KFL) twice, each on a fresh batcher with the C++
     scheduler: the step engine (``run_until_done``), then the pipelined
     one (``run_pipelined``: one CUDA graph replay a chunk), every
     request's tokens equal; a replayed chunk against the same chunk run
     eagerly (tokens, carry, every cache byte), and a chunk profiled as
     a replay and eagerly (``engine_pair``);
   - ``w4a8`` on the same weights: the same phases (decode through KSOL
     with int8 dots, the batcher per op through K2's fused decode kernel
     + K3, K1 + K2 in its prefills; the per-slot step must launch the
     fused kernel 4 x 32 + 1 times and K1 never);
   - the decode step of ``scripts/sweep_r5_merged.py`` (``build_step``)
     on the same w4 weights: a 512-token prefill of batch 16, then 8 steps
     of one ``fused_decode_layer`` a layer (KDL, flat caches, gate|up one
     array) with layer 0's QKV and ``lm_head`` through KW4, held against
     ``quantized_forward(mode="w4")`` (KSOL) on the same tokens: KV bytes
     and logits;
   - KGQA on a layer of that oracle's caches at Llama-3-8B decode shapes,
     bf16 and f32 q, against its plain version and against K3's context
     for the same roped q after K3's append;
   - ``bench_llama8b.continuous_batching``'s workload in ``w4a8`` (48
     requests, 16 slots, chunk 8, prompts of 32, 32-128 new tokens,
     max_len 192) through ``warm_admission(pipelined=True)`` and
     ``run_pipelined`` (``cb_bench``), and a cache-free forward of 1 x
     512 tokens (``cache_free_forward``);
   - ``w8``: a prefill, batch-16 decode and the batcher (KW8 + K3);
4. compares, in each serving mode, one prefill and decode steps of the
   whole model (``w8``: its first 4 layers, see ``main``) through the
   kernels with the same through the plain versions (logits within 5e-2
   of their max; top-1 agreement reported);
5. draws a float Llama-3-8B at full width and depth (32 layers, f32
   parameters from a seeded generator on the card), calibrates it once in
   ``QuantizationSimModel`` (sqnr, 4 batches of 2 x 512 tokens), reports
   ``quantized_fn`` against the float model, and lowers it with
   ``lower_to_int`` in ``w8``, ``w8a8``, ``w4``, ``w4a8`` and ``w4g``
   (blockwise INT4, block 128, on every layer linear; ``lm_head`` in
   ``w8a8``): one forward of 8 x 512 tokens a mode with the launch counts
   set to 0 just before and read just after (each kernel of the mode must
   launch exactly once a linear), the same forward through the plain
   versions (logits within 5e-2 of their max), the relative MSE against the
   float model, device ms by kernel and host ms;
6. draws a float ResNet-50 (1000 classes) on the card from a seeded
   generator, fits its BatchNorm statistics to a seeded batch, checks its
   f32 forward against f64 (TF32 off), calibrates it in
   ``QuantizationSimModel`` (sqnr, 4 batches of 32 images at 224 x 224)
   and lowers it in ``w8``, ``w8a8``, ``w4`` and ``w4a8``: per mode the
   lowered / skipped / downgraded ops, ``int_flops_fraction``, one forward
   of 32 images with the launch counts set to 0 just before and read just
   after (each mode's kernels, exactly), device and host ms, the same
   forward through the plain versions, and top-1 agreement and relative
   MSE against the float model; then the float ResNet-50 with every conv
   through ``conv2d_w8a8`` and the dense layer through ``matmul_w8a8``
   (the dynamic full-INT8 ops API: K1 + KQ8, equal to its plain
   version);
   then a MobileNetV2 lowered in ``w8a8`` (its depthwise convs);
7. runs the PTQ path on those two models (``ptq``): on the ResNet-50
   ``equalize_model`` (float logits held), sqnr calibration through the
   C++ search, AdaRound on all 54 layers (captured CUDA graphs; each layer
   on its grid, frozen, and no worse than round-to-nearest on its own
   batches), the captured loop held bit for bit against the eager one on a
   stride-2 3 x 3 layer and that layer timed at 10,000 iterations both
   ways, ``export`` and ``load_encodings`` (bit for bit) and the lowered
   ``w8a8`` forward of 32 images (KQ8 + KW8, against the plain versions
   and the float model, with round-to-nearest and AdaRound weights); on
   the MobileNetV2 ``equalize_model`` + ``correct_bias``, export / load
   and ``w8a8``; SeqMSE on a float Llama-3-8B at 2 layers (full width),
   lowered in ``w8``; every step's seconds beside the card's name and
   power limit;
8. runs quantization-aware training and the LLM PTQ algorithms (``qat``)
   on a float Llama-3-8B at 2 layers (full width): QAT + KD as
   ``examples/llm_qat_kd.py`` sets it up (4-bit params, 8-bit outputs,
   sqnr, 4 AdamW steps on one 2 x 256 batch; losses, step ms, peak memory;
   the range-learning gradients of two quantizers against the reference
   formula in f64), ``update_encodings_from_qat`` and the ``w4a8`` forward
   (K1 + K2); GPTQ over all 15 linears (4-bit per channel; each linear's
   reconstruction against nearest rounding), lowered in ``w4`` (KW4's
   tile), GPTVQ on layer 0's attention linears; SmoothQuant (float logits
   held), lowered in ``w8a8`` (KSQ); then BN re-estimation on the
   ResNet-50 (against f64 statistics of the captured BN inputs) and
   QuantAnalyzer on the MobileNetV2;
9. runs AMP, AutoQuant and LoRA (``amp_peft``): on the ResNet-50
   ``AutoQuantWithAutoMixedPrecision`` (4-bit per-channel weights, 8-bit
   outputs, AdaRound, AMP over fp16 / (8, 8) / (8, 4)), again from its
   stage cache (bit for bit), ``reduce_convert_ops``, ``lower_to_int``
   in ``auto`` (KQ8's int32 entry for every conv) against the plain
   versions and the sim, and ``ArchChecker``; on a float Llama-3-8B at 2
   layers LoRA adapters trained 3 steps through the adapter sim's
   ``static_grid_qat_fn``, merged, quantized for ``w4a8`` serving and
   served (prefill, a per-slot step, ``generate``: K1 + K2's tile, K2's
   fused decode kernel, K3, KSOL), held against ``quantized_lora_fn``
   and the kernels against the plain versions;
10. runs DeepSpeech2 at deepspeech.pytorch's LibriSpeech widths (161 mel
   bins, 32 conv channels, 5 bidirectional LSTM layers of 1024, 29
   characters; 16 x 1000 frames) through the QuantizationSimModel (10
   ``scan`` ops: calibration, the fake-quant forward, a QAT step) and
   ``lower_to_int`` in w8a8 (KQ8's int32 entry, KSQ) and w4a8 (KQ8, K1 +
   K2), each lowered forward held against the plain versions, and
   RecurrentQuantizer on an LSTM and a GRU; then compresses the ResNet-50
   (channel pruning with reconstruction, spatial SVD, a greedy
   selection) and lowers the result in w8a8 (KQ8)
   (``recurrent_compression``; alone: ``--recurrent-compression-slice``);
11. times the GEMM routes (KW4, KW8, KW4G, K2, KSQ, KQ8 and K2's fused
   decode kernel) alone at every shape they ran at on the main paths
   (``route_shape_gaps``) and prints the
   measurements, each kernel route's redesign score (its launches on the
   main paths, counted by the wrappers per route and shape, times its ms -
   bound there: ``route_ranking``; a graph replay passes no wrapper, so
   the pipelined phases count their warm-up and captured chunks, and the
   replays x a chunk's launches are logged beside them), the card's
   name and power limit, a ``kernels`` JSON line and, last, ``{"ok": true,
   "device": {...}}``.

Any failed phase exits non-zero. Without CUDA, or outside a checkout of the
repository, it exits non-zero before printing any result.

``--decode-slice`` runs only K2's decode rows, K3's rows and the per-slot
step's profile in each mode (``decode_slice``), with APIs a tree from
before K2's decode route and K3's split also has: copied into such a tree,
it measures that tree with the same code. ``--w4-slice`` does the same for
KW4 (``w4_slice``): its rows, K1's decode rows, KW4 at the lowered
forward's linears, the w4 prefill of 8 x 512, the w4 per-slot step and
the w4 continuous batcher; ``--prefill-slice`` for KW8 and K2 at
prefill M (``prefill_slice``): their rows at the serving prefill's
shapes, KW8's f32 lm_head, both at the lowered forward's linears, the
tiles' crossings with the block tiles (``prefill_sweep``, and KW4's
``tile_sweep``) and what the weight unpack and the register split cost
them (``tile_variants``, KSQ's and KW4G's tiles too), the w8 and w4a8
prefill of 8 x 512 and the w4a8 batcher; ``--lowered-slice`` for KSQ and
KW4G (``lowered_slice``): both at the lowered forward's linears, their
tiles' crossings with the block tiles (``new_tile_sweep``), KW8's library
column at the prefill shapes, and the lowered w8a8 and w4g forwards of a
float Llama-3-8B (32 layers, 8 x 512 tokens), 3 profiled each;
``--q8-slice`` for KQ8 and K1 / K2 at decode M (``q8_slice``, through
``matmul_q8``, ``matmul_w8a8`` and ``matmul_w4a8`` only): their rows with
digests of the outputs (and of K1's and KSOL's int8 bits) to compare two
trees, KQ8's tile crossing (``q8_tile_sweep``) and the fused decode
kernel beside K1 + K2 at the step's shapes (``fused_step_rows``) where
the tree has them, the ResNet-50 ops-API forward and the w4a8 per-slot
step (profiled, then its wall time unprofiled: ``step_ab``, the fused
route against K1 + K2 in one process where the tree has both).
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s of HBM3, int8 and bf16
# tensor-core operations/s, f32 CUDA-core FLOP/s
HBM_BPS = 3.35e12
INT8_OPS = 1979e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
TOL_ATTN = 2e-2          # K3, KFL, KSOL vs plain: max |diff| / max |plain|
TOL_INT8_DOTS = 6e-2     # KSOL with int8 dots, same measure
TOL_WO = 1e-2            # KW4 / KW8, same measure
# KW4 / KW8 on an f32 x with an f32 output, same measure: the kernels take
# x as a bf16 high part plus a bf16 residual (within ~2^-16 of the f32
# product; measured <= 1.2e-5), where an x rounded to bf16 gives ~1e-3
TOL_WO_F32 = 1e-4
TOL_LOGITS = 5e-2        # whole-model logits, same measure
TOL_GQA_F32 = 1e-4       # KGQA f32 q vs plain: f32 sums of 1024 rows
# KGQA vs K3's context on the same roped q and caches, same measure: K3
# rounds its context to bf16 (2^-9 of a value); with a bf16 q KGQA also
# rounds q * scale and the probs to bf16, and TOL_ATTN applies
TOL_GQA_K3_F32 = 1e-2
# lowered CNN logits, kernels vs plain, same measure: the integer convs'
# sums and epilogues are bit-exact, so only the dense layer's KW8 / KW4
# (weight-only, float sums in another order) differs (measured <= 3.1e-6)
TOL_CNN_LOGITS = 1e-4

SOURCES = {
    "act_quant": ("aimet_tpu_torch/csrc/act_quant.cu",
                  "aimet_tpu/ops/int_matmul.py:692"),
    "w4a8_gemm": ("aimet_tpu_torch/csrc/w4a8_gemm.cu",
                  "aimet_tpu/ops/int_matmul.py:692, "
                  "aimet_tpu/ops/int_matmul.py:767"),
    "decode_attention": ("aimet_tpu_torch/csrc/decode_attention.cu",
                         "aimet_tpu/ops/decode_attention_fused.py:280"),
    "w4_gemm": ("aimet_tpu_torch/csrc/wo_gemm.cu",
                "aimet_tpu/ops/int_matmul.py:1023"),
    "w8_gemm": ("aimet_tpu_torch/csrc/wo_gemm.cu",
                "aimet_tpu/ops/int_matmul.py:245"),
    "fused_wo_mlp": ("aimet_tpu_torch/csrc/fused_layer.cu",
                     "aimet_tpu/ops/fused_layer.py:236, "
                     "aimet_tpu/ops/fused_layer.py:264"),
    "sol_decode_layer": ("aimet_tpu_torch/csrc/fused_layer.cu",
                         "aimet_tpu/ops/decode_layer_sol.py:289"),
    "w8a8_staticq": ("aimet_tpu_torch/csrc/w8a8_staticq.cu",
                     "aimet_tpu/ops/int_matmul.py:593"),
    "w4_grouped_gemm": ("aimet_tpu_torch/csrc/wo_gemm.cu",
                        "aimet_tpu/ops/int_matmul.py:960"),
    # K1 then KQ8 (act_quant.cu, w8a8_gemm.cu): no kernel of its own
    "w8a8_fusedq": ("aimet_tpu_torch/csrc/w8a8_gemm.cu",
                    "aimet_tpu/ops/int_matmul.py:456"),
    "q8_gemm": ("aimet_tpu_torch/csrc/w8a8_gemm.cu",
                "aimet_tpu/ops/int_matmul.py:378"),
    # KQ8's float entries on the TMA + wgmma tile (kind kQ8 of
    # wgmma_wo_tile.cuh, C entry in w8a8_gemm.cu): KQ8's "tile" route,
    # listed on its own (ROUTE_KERNELS)
    "q8_tile": ("aimet_tpu_torch/csrc/w8a8_gemm.cu",
                "aimet_tpu/ops/int_matmul.py:378"),
    # K1 folded into K2's decode route (matmul_w4a8_fusedq at decode M)
    "w4a8_fusedq": ("aimet_tpu_torch/csrc/w4a8_gemm.cu",
                    "aimet_tpu/ops/int_matmul.py:692"),
    "fused_decode_layer": ("aimet_tpu_torch/csrc/fused_layer.cu",
                           "aimet_tpu/ops/fused_layer.py:457, "
                           "aimet_tpu/ops/fused_layer.py:502"),
    "gqa_decode_attention": ("aimet_tpu_torch/csrc/gqa_attention.cu",
                             "aimet_tpu/ops/decode_attention.py:78"),
}
# the CNN phase: ResNet-50 lowered per mode -> (lower_to_int mode, param
# bitwidth, the launches of one forward by kernel, c = ungrouped convs)
CNN_MODES = {
    "w8": ("w8", 8, lambda c: {"w8_gemm": 1}),
    "w8a8": ("w8a8", 8, lambda c: {"q8_gemm": c, "w8_gemm": 1}),
    "w4": ("w4", 4, lambda c: {"w4_gemm": 1}),
    "w4a8": ("w4a8", 4, lambda c: {"q8_gemm": c, "act_quant": 1,
                                   "w4a8_gemm": 1}),
}
# K2 at decode M: (M, K, N) at W_gate|up of Llama-3-8B, then its lm_head at
# the padded vocabulary width (serving pads it to a multiple of 4096)
K2_DECODE_SHAPES = ((16, 4096, 28672), (1, 4096, 28672), (32, 4096, 28672),
                    (64, 4096, 28672), (16, 4096, 131072))
K2_KERNELS = ["w4a8_gemm_kernel", "w4a8_epilogue_kernel",
              "w4a8_decode_kernel", "w4a8_tile_kernel"]
# K3: (label, B, S, positions) — the per-slot step's shape (PERF.md row
# 14), batch 32, one row, and the long cache (positions 15,985..16,000:
# S - 384 - b)
K3_SHAPES = (("B=16 S=1024", 16, 1024, "mixed"),
             ("B=32 S=1024", 32, 1024, "mixed"),
             ("B=1 S=1024", 1, 1024, "mixed"),
             ("B=16 S=16384", 16, 16384, "long"))
K3_KERNELS = ["decode_attention_kernel", "split_attention_kernel"]
# KW8's decode route, timed at 4096 x 28672 besides M = 16 (row "decode")
W8_DECODE_ROWS = (1, 32, 64)
# KSOL (w4, next QKV) at Llama-3-8B widths, S = 1024, position 700: the
# rows a launch takes besides 16
SOL_ROWS = (1, 32, 64)
# the lowered float Llama-3-8B computes its layers in bf16 and its lm_head
# in f32, so lower_to_int hands the layer linears a bf16 x and the lm_head
# an f32 one (M = 8 x 512): (K, N) of the layer linears (QKV apart, O,
# gate, up, down)
LOWERED_LAYER_KN = ((4096, 4096), (4096, 1024), (4096, 14336),
                    (14336, 4096))
# KW4G's timed rows, group 128: (tag, M, K, N, x dtype, out dtype): 4096 x
# 14336 with a bf16 x, at prefill and decode M; the lowered forward's
# layer linears as it calls them (bf16 x, f32 out), and with an f32 x
W4G_ROWS = (("prefill", 4096, 4096, 14336, "bf16", "bf16"),
            ("decode", 16, 4096, 14336, "bf16", "bf16"),
            ("decode M=32", 32, 4096, 14336, "bf16", "bf16"),
            ("decode M=64", 64, 4096, 14336, "bf16", "bf16")) + tuple(
    (f"lowered {k}x{n}", 4096, k, n, "bf16", "f32")
    for k, n in LOWERED_LAYER_KN) + (
    ("f32 4096x14336", 4096, 4096, 14336, "f32", "f32"),) + tuple(
    (f"f32 {k}x{n}", 4096, k, n, "f32", "f32")
    for k, n in LOWERED_LAYER_KN if (k, n) != (4096, 14336))
# KSQ's timed rows: (label, M, K, N, x dtype), the output in x's dtype as
# the lowering asks: the lowered forward's layer linears (bf16 x) and its
# lm_head (f32 x), an f32 x at 14336 x 4096, and decode M
KSQ_ROWS = tuple(
    (f"w8a8_staticq[{k}x{n}]", 4096, k, n, "bf16")
    for k, n in LOWERED_LAYER_KN
) + (("w8a8_staticq[lm_head]", 4096, 4096, 128256, "f32"),
     ("w8a8_staticq[f32 14336x4096]", 4096, 14336, 4096, "f32"),
     ("w8a8_staticq[decode]", 16, 4096, 14336, "bf16"))
# KW4G on an f32 x with an f32 output, same measure as TOL_WO: its tile
# and its block tile both take x as a bf16 high part plus residual
# (measured on the H100 at M = 4096 and the lowered forward's linears: the
# block tile <= 4.96e-6, the tile <= 5.03e-6)
TOL_W4G_F32 = 1e-5
# KW4 at decode M: (M, K, N) at W_gate|up of Llama-3-8B, its padded lm_head
# and layer 0's QKV (the two KW4 launches of a w4 decode step)
KW4_DECODE_SHAPES = ((16, 4096, 28672), (1, 4096, 28672), (32, 4096, 28672),
                     (64, 4096, 28672), (16, 4096, 131072), (16, 4096, 6144))
# KW4 at prefill M (8 x 512 tokens): the four layer projections (QKV, O,
# gate|up, down) and the padded lm_head
KW4_PREFILL_SHAPES = ((4096, 4096, 28672), (4096, 4096, 6144),
                      (4096, 4096, 4096), (4096, 14336, 4096),
                      (4096, 4096, 131072))
# the lowered Llama-3-8B's linears at M = 8 x 512, f32 out: (K, N, launches
# a forward, x's dtype); 7 a layer over 32 layers (bf16 x, the float
# model's Dense), then the f32 lm_head
KW4_LOWERED_SHAPES = ((4096, 4096, 64, "bf16"), (4096, 1024, 64, "bf16"),
                      (4096, 14336, 64, "bf16"), (14336, 4096, 32, "bf16"),
                      (4096, 128256, 1, "f32"))
KW4_KERNELS = ["wo_gemm_kernel", "wo_reduce_kernel", "wo_decode",
               "w4_tile", "split_pairs"]
KW8_KERNELS = ["wo_gemm_kernel", "wo_reduce_kernel", "wo_decode",
               "w8_tile", "split_pairs"]
W4G_KERNELS = ["wo_gemm_kernel", "wo_reduce_kernel", "w4g_decode_kernel",
               "w4g_tile", "split_pairs"]
# KW8 and K2 at the serving prefill (8 x 512 tokens, M = 4096): (K, N) of
# the four layer projections (QKV, O, gate|up, down) and the padded lm_head
PREFILL_KN = ((4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096),
              (4096, 131072))
# K1 at decode M (the per-op w4a8 decode step's rows): (M, K)
K1_DECODE_SHAPES = ((16, 4096), (64, 4096))
# K1 at ResNet-50's conv patch shapes at 32 images ((M, K), the patches of
# the ops API's conv2d_w8a8): the stem, 1 x 1 and 3 x 3 convs of its four
# stages
K1_CONV_SHAPES = ((401408, 147), (100352, 64), (100352, 256), (100352, 576),
                  (25088, 128), (25088, 512), (25088, 1152), (6272, 2304),
                  (1568, 4608))
# K1's kernels (narrow rows, wide rows) and KGQA's two, by name
K1_KERNELS = ["act_quant_kernel", "act_quant_rows_kernel"]
GQA_KERNELS = ["gqa_scores_kernel", "gqa_context_kernel"]
# bytes of inputs a timed call rotates through, so they come from HBM and
# not from the 50 MB L2
ROTATE_BYTES = 128e6
# the rows at the shapes that carry most of a route's launches on the main
# paths (several only where they launch equally often), by which a route
# of a kernel outside SHAPE_KERNELS is scored; the rest (sweeps of M or B)
# are not
MAIN_ROWS = {
    "w8a8_fusedq[conv 3x3]",
    "decode_attention", "fused_wo_mlp[next_qkv]",
    "sol_decode_layer[w4]", "sol_decode_layer[w4a8]",
    "fused_decode_layer[next_qkv]",
    "gqa_decode_attention[bf16]", "gqa_decode_attention[f32]",
}
# the wrappers by kernel name (gemm_row reads their route counts)
KERNEL_FNS = {}
# launches on the main paths by "kernel:route" (take_routes)
ROUTE_LAUNCHES = {}
# the kernels whose routes are scored at every shape they ran on the main
# paths (their wrappers count launches by shape: ``fn.shapes``), and those
# launches: (kernel, route, M, N, K, x dtype, out dtype, group) -> count
SHAPE_KERNELS = ("w4_gemm", "w8_gemm", "w4_grouped_gemm", "w4a8_gemm",
                 "w8a8_staticq", "q8_gemm", "w4a8_fusedq", "act_quant")
# kernels of the kernels line that are one route of a wrapper: name ->
# (the wrapper's kernel name, route); their launches are that route's
ROUTE_KERNELS = {"q8_tile": ("q8_gemm", "tile")}
ROUTE_SHAPES = {}
# the kernels each mode's main path must launch
PATH_KERNELS = {
    "w4": ("w4_gemm", "sol_decode_layer", "decode_attention",
           "fused_wo_mlp"),
    "w4a8": ("act_quant", "w4a8_gemm", "w4a8_fusedq", "sol_decode_layer",
             "decode_attention"),
    "w8": ("w8_gemm", "decode_attention"),
    "decode_step": ("w4_gemm", "fused_decode_layer"),
    "gqa": ("gqa_decode_attention",),
    "long_cache": ("sol_decode_layer", "decode_attention", "fused_wo_mlp",
                   "fused_decode_layer", "gqa_decode_attention"),
    "cb_bench": ("w4a8_fusedq", "decode_attention"),
    "cache_free": ("act_quant", "w4a8_gemm"),
    "ptq_resnet50": ("q8_gemm", "w8_gemm"),
    "ptq_mobilenet_v2": ("q8_gemm", "w8_gemm"),
    "ptq_seq_mse": ("w8_gemm",),
    "qat_kd": ("act_quant", "w4a8_gemm"),
    "gptq": ("w4_gemm",),
    "smooth_quant": ("w8a8_staticq",),
    "amp_resnet50": ("q8_gemm",),
    "peft_llm": ("act_quant", "w4a8_gemm", "w4a8_fusedq", "sol_decode_layer",
                 "decode_attention"),
    "ds2_w8a8": ("q8_gemm", "w8a8_staticq"),
    "ds2_w4a8": ("q8_gemm", "act_quant", "w4a8_gemm"),
    "compressed_resnet50": ("q8_gemm",),
}
# phase 10a: DeepSpeech2 at the widths of deepspeech.pytorch's LibriSpeech
# model (161 mel bins of a 20 ms window at 16 kHz, 32 conv channels,
# 5 bidirectional LSTM layers of 1024, 29 characters), the JAX package's
# 11 x 11 convs; batches of 16 utterances of 1000 frames (10 s)
DS2_WIDTHS = dict(n_mels=161, conv_channels=32, hidden=1024, num_layers=5,
                  vocab=29)
DS2_BATCH, DS2_FRAMES = 16, 1000
# the lowered DeepSpeech2 forwards: mode -> (param bitwidth, launches of
# one forward); the two convs and the head lower, the 20 LSTM linears
# stay in their scans
DS2_MODES = {
    "w8a8": (8, {"q8_gemm": 2, "w8a8_staticq": 1}),
    "w4a8": (4, {"q8_gemm": 2, "act_quant": 1, "w4a8_gemm": 1}),
}
# lowered DeepSpeech2 log-probs, kernels vs plain (max |diff| / max
# |plain|): the integer convs are bit-exact and the LSTMs run the same
# float ops, so only the head's kernel (KSQ, or K1 + K2) differs
TOL_DS2_LOGITS = 1e-4
# the lowered models: mode -> (lower_to_int mode, param bitwidth, the
# launches of one forward by kernel, n = linears a forward)
LOWER_MODES = {
    "w8": ("w8", 8, lambda n: {"w8_gemm": n}),
    "w8a8": ("w8a8", 8, lambda n: {"w8a8_staticq": n}),
    "w4": ("w4", 4, lambda n: {"w4_gemm": n}),
    "w4a8": ("w4a8", 4, lambda n: {"act_quant": n, "w4a8_gemm": n}),
    "w4g": ("w8a8", 8, lambda n: {"w4_grouped_gemm": n - 1,
                                  "w8a8_staticq": 1}),
}


def log(*a):
    print(*a, flush=True)


def zero_counts(counters):
    """Set every wrapper's launch count, and each of its routes' and
    shapes', to 0."""
    for fn in counters.values():
        fn.launches = 0
        for r in getattr(fn, "routes", {}):
            fn.routes[r] = 0
        if hasattr(fn, "shapes"):
            fn.shapes.clear()


def take_routes(counters):
    """Add the route and shape counts of the path just driven (since
    zero_counts) to ROUTE_LAUNCHES and ROUTE_SHAPES."""
    for k, fn in counters.items():
        for r, n in getattr(fn, "routes", {}).items():
            if n:
                ROUTE_LAUNCHES[f"{k}:{r}"] = \
                    ROUTE_LAUNCHES.get(f"{k}:{r}", 0) + n
        for key, n in getattr(fn, "shapes", {}).items():
            ROUTE_SHAPES[(k,) + key] = ROUTE_SHAPES.get((k,) + key, 0) + n


@contextlib.contextmanager
def profiled():
    """torch.profiler over the CPU and CUDA, opened with two short spinning
    kernels: in this long process the profiler drops the first kernel
    record of each session (one of 2 x 20 timed kernels, every session, in
    a run of this script's phases), so the record it drops is a spin's,
    which ``_kernel_events`` leaves out."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        torch.cuda._sleep(1000)
        yield prof


@contextlib.contextmanager
def cuda_profiled():
    """torch.profiler over the CUDA activity alone: for windows of many
    thousand small kernels (a recurrent model's per-step loop), where the
    CPU activity's events would swamp the profiler. The spins of
    ``profiled`` open it the same way."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        torch.cuda._sleep(1000)
        yield prof


def _kernel_events(prof, match=None):
    """CUDA kernel events of a profile but ``profiled``'s spins, optionally
    those whose name contains one of the strings in ``match``."""
    import torch
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "spin_kernel" not in e.name
            and (match is None or any(m in e.name for m in match))]


def timed(fn, iters, match=None, warmup=3):
    """Run fn(i) ``iters`` times under torch.profiler. Returns (device ms
    per call of the CUDA kernels named by ``match``, or of all kernels when
    ``match`` is None; host-clock ms per call, synchronised). Profiles of
    single calls count a call's kernels (the most seen in three); a
    profile of the ``iters`` calls that holds another number than
    ``iters`` times that lost events (the profiler does, in a long
    process) and is taken again. If three profiles do, the device time is
    the median of CUDA events around each call, the calls queued behind a
    spinning kernel (so the host's gaps between the calls do not count;
    all of a call's kernels do), and is said so."""
    import torch
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    per_call = 0                     # the most seen in three calls
    for _ in range(3):
        with profiled() as prof:
            fn(0)
            torch.cuda.synchronize()
        per_call = max(per_call, len(_kernel_events(prof, match)))
    wall = 0.0
    for _ in range(3 if per_call else 0):
        with profiled() as prof:
            t0 = time.perf_counter()
            for i in range(iters):
                fn(i)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        ev = _kernel_events(prof, match)
        if len(ev) == per_call * iters:
            dev_us = sum(e.time_range.elapsed_us() for e in ev)
            return dev_us / 1e3 / iters, wall * 1e3 / iters
    log(f"  (the profiler lost CUDA kernels matching {match} three times: "
        "timed with CUDA events around each call, the median)")
    return event_ms(fn, iters, wall)


def event_ms(fn, iters, wall=0.0):
    """The median device ms of fn(i) over ``iters`` calls, each between
    its own pair of CUDA events, queued behind a spinning kernel so the
    host's gaps between the calls do not count (all of a call's kernels
    do); ``wall``: the host seconds of the calls, measured here if 0.
    Returns (ms, host ms per call)."""
    import torch
    if not wall:
        t0 = time.perf_counter()
        for i in range(iters):
            fn(i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    marks = [[torch.cuda.Event(enable_timing=True) for _ in range(2)]
             for _ in range(iters)]
    # the card spins for twice the calls' host time (at 2 GHz, at most
    # 0.2 s: longer calls leave gaps too small to count) while the host
    # queues them, each between its own pair of events
    torch.cuda._sleep(int(min(2 * wall, 0.2) * 2e9))
    for i, (a, b) in enumerate(marks):
        a.record()
        fn(i)
        b.record()
    torch.cuda.synchronize()
    per = sorted(a.elapsed_time(b) for a, b in marks)
    return per[len(per) // 2], wall * 1e3 / iters


def bound_ms(nbytes, *ops_at_peak):
    """The least time for the work: the larger of the bytes at the HBM
    rate and the operations, each (count, peak rate of its type), at
    their peaks. Returns (ms, "bytes" or "operations")."""
    t_bytes = nbytes / HBM_BPS
    t_ops = sum(n / peak for n, peak in ops_at_peak)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_split(torch, flay, call, runs=10):
    """Where the whole-layer kernel's time goes: ``call(i)`` launches it
    once with ``fused_layer.STAMPS`` set, so block 0 writes %globaltimer at
    kernel start, after each grid-wide barrier and at its end. Returns the
    median over ``runs`` launches, in ms, of phase 0 (attention), the int8
    row quantization of its output, the GEMM phases and the epilogues
    (each span ends at the barrier after it), and their total."""
    st = torch.zeros(flay.N_STAMPS, dtype=torch.int64, device="cuda")
    spans = {"attention": [], "int8 rows": [], "GEMM phases": [],
             "epilogues": [], "total": []}
    flay.STAMPS = st
    try:
        for i in range(runs + 2):
            st.zero_()
            call(i)
            torch.cuda.synchronize()
            if i < 2:                       # warm-up
                continue
            t = st.tolist()
            hit = [j for j in range(len(t)) if t[j]]
            run = dict.fromkeys(spans, 0.0)
            for a, b in zip(hit, hit[1:]):
                key = ("attention" if b == flay.STAMP_ATTENTION
                       else "int8 rows" if b == flay.STAMP_INT8_ROWS
                       else "GEMM phases" if b in flay.STAMP_GEMMS
                       else "epilogues")
                run[key] += (t[b] - t[a]) / 1e6
            run["total"] = (t[hit[-1]] - t[hit[0]]) / 1e6
            for k in spans:
                spans[k].append(run[k])
    finally:
        flay.STAMPS = None
    return {k: sorted(v)[len(v) // 2] for k, v in spans.items()}


def gemm_timer(rows):
    """gemm_row(label, kernel, m, k, n, launch, plain, match, in_bytes,
    peak, out_bytes=None, vec_bytes=None, iters=20): times ``launch(i)``
    (the CUDA kernels named by ``match``) and ``plain(i)`` into
    ``rows[label]`` with the bound of the GEMM's bytes and operations, and
    the route ``launch`` took where the kernel's wrapper counts routes.
    in_bytes: the activations' and the weight codes' bytes; the output is
    bf16 and one f32 scale a column is read unless ``out_bytes`` /
    ``vec_bytes`` say otherwise."""
    def gemm_row(label, kernel, m, k, n, launch, plain, match, in_bytes,
                 peak, out_bytes=None, vec_bytes=None, iters=20):
        import torch
        fn = KERNEL_FNS.get(kernel)
        before = dict(getattr(fn, "routes", {}))
        launch(0)
        torch.cuda.synchronize()
        took = [r for r, v in getattr(fn, "routes", {}).items()
                if v != before.get(r, 0)]
        ms, call = timed(launch, iters, match)
        pms, _ = timed(plain, 3, warmup=1)
        out_bytes = m * n * 2 if out_bytes is None else out_bytes
        vec_bytes = n * 4 if vec_bytes is None else vec_bytes
        b, how = bound_ms(in_bytes + vec_bytes + out_bytes,
                          (2 * m * n * k, peak))
        rows[label] = dict(kernel=kernel, shape=f"M={m} K={k} N={n}", ms=ms,
                           call_ms=call, plain_ms=pms, bound_ms=b,
                           bound_by=how,
                           route=took[0] if len(took) == 1 else None)
    return gemm_row


def int4pack_ms(torch, tim, x, packed, sc):
    """torch._weight_int4pack_mm on KW4's operands (tinygemm's layout, the
    column scale repeated over groups of 128, zeros 0): (ms, max |diff|
    over max |KW4|), or (None, the error's text) where it does not run."""
    k, n = x.shape[1], packed.shape[1]
    try:
        u = (tim.unpack_int4(packed).to(torch.int32) + 8).t()
        u8 = ((u[:, ::2] << 4) | u[:, 1::2]).to(torch.uint8)
        wt = torch._convert_weight_to_int4pack(u8.contiguous(), 8)
        sz = torch.stack([sc.expand(k // 128, n),
                          torch.zeros((k // 128, n), device=x.device)],
                         -1).to(torch.bfloat16).contiguous()
        got = torch._weight_int4pack_mm(x, wt, 128, sz)
        err = rel_err(got, tim.matmul_w4(x, packed, sc))
        ms, _ = timed(lambda i: torch._weight_int4pack_mm(x, wt, 128, sz),
                      10)
        return ms, err
    except Exception as e:              # recorded: the row's library note
        return None, f"torch._weight_int4pack_mm: {e}"[:200]


def kw4_label(m, k, n):
    if m <= 64:
        return ("w4_gemm[decode]" if (m, n) == (16, 28672) else
                f"w4_gemm[decode M={m}]" if n == 28672 else
                f"w4_gemm[lm_head M={m}]" if n == 131072 else
                f"w4_gemm[qkv M={m}]")
    return ("w4_gemm[prefill]" if n == 28672 else
            "w4_gemm[prefill lm_head]" if n == 131072 else
            f"w4_gemm[prefill {k}x{n}]")


def kw4_rows(torch, tim, g, rows, gemm_row, note):
    """KW4 at the main paths' shapes, KW4_DECODE_SHAPES and
    KW4_PREFILL_SHAPES (bf16 x): each held against its plain version
    within TOL_WO and on a repeated call, then timed with 3 weight copies
    rotated (so the weights stream from HBM), torch._weight_int4pack_mm
    beside it (the library column)."""
    for m, k, n in KW4_DECODE_SHAPES + KW4_PREFILL_SHAPES:
        ws = [torch.randint(-128, 128, (k // 2, n), dtype=torch.int8,
                            generator=g, device="cuda") for _ in range(3)]
        sw = (torch.rand((n,), generator=g, device="cuda") + 0.5) * 0.02 \
            / k ** 0.5
        x = torch.randn((m, k), generator=g, device="cuda").to(torch.bfloat16)
        got = tim.matmul_w4(x, ws[0], sw)
        want = tim.matmul_w4_torch(x, ws[0], sw)
        note("w4_gemm", got, want)
        err = rel_err(got, want)
        assert err < TOL_WO, ("KW4", m, k, n, err)
        assert torch.equal(tim.matmul_w4(x, ws[0], sw), got), \
            ("KW4", m, k, n, "repeat")
        label = kw4_label(m, k, n)
        log(f"{label} at M={m}, K={k}, N={n}: within {err:.2e} of max (< "
            f"{TOL_WO}), repeated calls the same bits")
        del got, want
        gemm_row(label, "w4_gemm", m, k, n,
                 lambda i: tim.matmul_w4(x, ws[i % 3], sw),
                 lambda i: tim.matmul_w4_torch(x, ws[i % 3], sw),
                 KW4_KERNELS, m * k * 2 + k // 2 * n, BF16_FLOPS,
                 iters=20 if m <= 64 else 5)
        lib, what = int4pack_ms(torch, tim, x, ws[0], sw)
        if lib is None:
            rows[label]["library_note"] = what
        else:
            rows[label]["library_ms"], rows[label]["library_err"] = lib, what
        del ws, x


def k1_decode_rows(torch, tim, g, rows, note):
    """K1 at decode M (K1_DECODE_SHAPES, bf16 x): codes and scales
    bit-exact against its plain version, then timed with 4 inputs
    rotated."""
    for m, k in K1_DECODE_SHAPES:
        xs = [torch.randn((m, k), generator=g, device="cuda").to(
            torch.bfloat16) for _ in range(4)]
        q, s_ = tim.quantize_activation_per_row(xs[0])
        pq, ps = tim._quantize_activation_plain(xs[0])
        note("act_quant", q, pq)
        assert torch.equal(q, pq) and torch.equal(s_, ps), ("K1", m, k)
        ms, call = timed(lambda i: tim.quantize_activation_per_row(
            xs[i % 4]), 50, K1_KERNELS)
        pms, _ = timed(lambda i: tim._quantize_activation_plain(xs[i % 4]),
                       10)
        b, how = bound_ms(m * k * 2 + m * k + m * 4, (3 * m * k, F32_FLOPS))
        rows[f"act_quant[decode M={m}]"] = dict(
            kernel="act_quant", shape=f"x ({m},{k}) bf16", ms=ms,
            call_ms=call, plain_ms=pms, bound_ms=b, bound_by=how)
        log(f"K1 act_quant at ({m}, {k}): codes and scales bit-exact")


def rotated(x):
    """x and as many copies as make ROTATE_BYTES (at most 8), for a timed
    call to take in turn."""
    nbytes = x.numel() * x.element_size()
    n = min(8, max(1, -(-int(ROTATE_BYTES) // nbytes)))
    return [x] + [x.clone() for _ in range(n - 1)]


def k1_conv_rows(torch, tim, g, rows, note):
    """K1 at every K1_CONV_SHAPES entry, f32 and bf16 x: codes and scales
    bit-exact against its plain version and on a repeated call, then timed
    (x and copies of it rotated: ``rotated``) with the route it took."""
    fn = tim.quantize_activation_per_row
    for m, k in K1_CONV_SHAPES:
        for dt, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            x = (torch.randn((m, k), generator=g, device="cuda") * 2).to(dt)
            before = dict(fn.routes)
            q, s_ = fn(x)
            route = [r for r, v in fn.routes.items() if v != before[r]][0]
            pq, ps = tim._quantize_activation_plain(x)
            note("act_quant", q, pq)
            assert torch.equal(q, pq) and torch.equal(s_, ps), ("K1", m, k,
                                                               tag)
            q2, s2 = fn(x)
            assert torch.equal(q2, q) and torch.equal(s2, s_), ("K1 repeat",
                                                                m, k, tag)
            xs = rotated(x)
            ms, call = timed(lambda i: fn(xs[i % len(xs)]), 20, K1_KERNELS)
            pms, _ = timed(lambda i: tim._quantize_activation_plain(
                xs[i % len(xs)]), 3, warmup=1)
            b, how = bound_ms(m * k * x.element_size() + m * k + m * 4,
                              (3 * m * k, F32_FLOPS))
            rows[f"act_quant[conv ({m},{k}) {tag}]"] = dict(
                kernel="act_quant", shape=f"x ({m},{k}) {tag}", ms=ms,
                call_ms=call, plain_ms=pms, bound_ms=b, bound_by=how,
                route=route)
            del x, xs, q, pq, q2
    log("K1 act_quant at ResNet-50's conv patch shapes, f32 and bf16 x: "
        "codes and scales bit-exact, repeat bits equal")


def kw4_lowered(torch, tim, g):
    """KW4 alone at the lowered Llama-3-8B forward's linears
    (KW4_LOWERED_SHAPES, M = 4096, f32 out, as the lowering calls it):
    device ms of each and their sum over one forward's 225 launches.
    Returns a dict."""
    m, out = 4096, {}
    total = 0.0
    for k, n, count, xt in KW4_LOWERED_SHAPES:
        x = torch.randn((m, k), generator=g, device="cuda").to(
            torch.bfloat16 if xt == "bf16" else torch.float32)
        w = torch.randint(-128, 128, (k // 2, n), dtype=torch.int8,
                          generator=g, device="cuda")
        sw = torch.rand((n,), generator=g, device="cuda") * 1e-3
        ms, _ = timed(lambda i: tim.matmul_w4(x, w, sw, torch.float32), 5,
                      KW4_KERNELS)
        out[f"{k}x{n} {xt}"] = dict(ms=ms, launches=count)
        total += ms * count
        del x, w
    out["forward_ms"] = total
    log("KW4 at the lowered forward's linears (M=4096, f32 out): "
        + ", ".join(f"{s} {r['ms']:.3f} ms x {r['launches']}"
                    for s, r in out.items() if s != "forward_ms")
        + f"; {total:.2f} ms a forward")
    return out


def route_shape_gaps(torch, tim):
    """Every main-path shape of the SHAPE_KERNELS' routes (ROUTE_SHAPES),
    on seeded operands, checked to take the route it took there, then
    timed alone (``event_ms``: the median of 5 calls, 3 weight copies
    rotated so decode shapes stream their weights from HBM; K1 its x and
    copies, ``rotated``), with its bound. Returns {ROUTE_SHAPES key: (ms,
    bound ms)}."""
    g = torch.Generator(device="cuda").manual_seed(5)
    fns = {"act_quant": tim.quantize_activation_per_row,
           "w4_gemm": tim.matmul_w4, "w8_gemm": tim.matmul_w8,
           "w4_grouped_gemm": tim.matmul_w4_grouped,
           "w4a8_gemm": tim.w4a8_gemm,
           "w8a8_staticq": tim.matmul_w8a8_staticq,
           "q8_gemm": tim.matmul_q8,
           "w4a8_fusedq": tim.matmul_w4a8_fusedq}
    dt = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "int32": torch.int32}
    out = {}
    for key in sorted(k for k in ROUTE_SHAPES if k[0] in fns):
        kernel, route, m, n, k, xt, ot, group = key
        fn = fns[kernel]
        if kernel == "act_quant":
            xs = rotated(torch.randn((m, k), generator=g,
                                     device="cuda").to(dt[xt]))
            call = lambda i: fn(xs[i % len(xs)])
            before = fn.routes[route]
            call(0)
            assert fn.routes[route] == before + 1, (key, "another route")
            ms, _ = event_ms(call, 5)
            b, _ = bound_ms(m * k * (xs[0].element_size() + 1) + m * 4,
                            (3 * m * k, F32_FLOPS))
            out[key] = (ms, b)
            del xs
            continue
        odt = dt[ot]
        rows_ = (k if kernel in ("w8_gemm", "w8a8_staticq", "q8_gemm")
                 else k // 2)
        ws = [torch.randint(-128, 128, (rows_, n), dtype=torch.int8,
                            generator=g, device="cuda") for _ in range(3)]
        if kernel == "q8_gemm" and ot == "int32":
            # the int32 entry; on its K-major route in the integer conv's
            # layout (patch rows padded to 16 bytes, the weight K-major)
            x = torch.randint(-128, 128, (m, k), dtype=torch.int8,
                              generator=g, device="cuda")
            if route == "int32_kmajor":
                kp = -(-k // 16) * 16
                x = torch.zeros((m, kp), dtype=torch.int8,
                                device="cuda")[:, :k].copy_(x)
                ws = [torch.zeros((n, kp), dtype=torch.int8,
                                  device="cuda")[:, :k].copy_(w_.t()).t()
                      for w_ in ws]
            call = lambda i: tim.int8_matmul_int32(x, ws[i % 3])
            x_bytes, peak, sc = m * k, INT8_OPS, torch.empty(0)
        elif kernel == "q8_gemm":
            x = torch.randint(-127, 128, (m, k), dtype=torch.int8,
                              generator=g, device="cuda")
            sx = torch.rand((m,), generator=g, device="cuda")
            sc = torch.rand((n,), generator=g, device="cuda") * 1e-3
            call = lambda i: fn(x, sx, ws[i % 3], sc, out_dtype=odt)
            x_bytes, peak = m * k + m * 4, INT8_OPS
        elif kernel == "w4a8_fusedq":
            x = torch.randn((m, k), generator=g, device="cuda").to(dt[xt])
            sc = torch.rand((n,), generator=g, device="cuda") * 1e-3
            call = lambda i: fn(x, ws[i % 3], sc, out_dtype=odt)
            x_bytes, peak = x.numel() * x.element_size(), INT8_OPS
        elif kernel == "w8a8_staticq":
            x = torch.randn((m, k), generator=g, device="cuda").to(dt[xt])
            sc = torch.rand((2, n), generator=g, device="cuda") * 1e-3
            enc = dict(inv_delta=50.0, offset=-128.0, num_steps=255.0,
                       out_dtype=odt)
            call = lambda i: fn(x, ws[i % 3], sc[0], sc[1], **enc)
            x_bytes, peak = x.numel() * x.element_size(), INT8_OPS
        elif kernel == "w4a8_gemm":
            x = torch.randint(-127, 128, (m, k), dtype=torch.int8,
                              generator=g, device="cuda")
            sx = torch.rand((m,), generator=g, device="cuda")
            sc = torch.rand((n,), generator=g, device="cuda") * 1e-3
            call = lambda i: fn(x, sx, ws[i % 3], sc, odt)
            x_bytes, peak = m * k + m * 4, INT8_OPS
        else:
            x = torch.randn((m, k), generator=g, device="cuda").to(dt[xt])
            x_bytes = x.numel() * x.element_size()
            # an f32 x is two bf16 operands: twice the tensor-core work
            peak = BF16_FLOPS / (2 if xt == "float32" else 1)
            if group:
                sc = torch.rand((k // group, n), generator=g,
                                device="cuda") * 1e-3
                call = lambda i: fn(x, ws[i % 3], sc, group_size=group,
                                    out_dtype=odt)
            else:
                sc = torch.rand((n,), generator=g, device="cuda") * 1e-3
                call = lambda i: fn(x, ws[i % 3], sc, odt)
        before = fn.routes[route]
        call(0)
        assert fn.routes[route] == before + 1, (key, "took another route")
        ms, _ = event_ms(call, 5)
        b, _ = bound_ms(x_bytes + rows_ * n + sc.numel() * 4
                        + m * n * (2 if ot == "bfloat16" else 4),
                        (2 * m * n * k, peak))
        out[key] = (ms, b)
        del ws, x, sc
    return out


def route_ranking(rows, launches, counters, shape_gaps):
    """The redesign score of each kernel's route: its launches on the main
    paths x (ms - bound). For the SHAPE_KERNELS, the sum over every shape
    the route ran at on the main paths of its launches there x (ms -
    bound) there (``shape_gaps``); for the rest, the gap at the rows that
    carry most of its launches (MAIN_ROWS; the mean where there are
    several), else its cheapest timed row; a route with no timed row is
    listed unscored. Returns a list, highest score first."""
    out = []
    for k, fn in counters.items():
        for r in list(getattr(fn, "routes", {})) or [None]:
            n = launches.get(k, 0) if r is None else \
                ROUTE_LAUNCHES.get(f"{k}:{r}", 0)
            if k in SHAPE_KERNELS:
                at = {key: c for key, c in ROUTE_SHAPES.items()
                      if key[:2] == (k, r)}
                score = sum(c * (shape_gaps[key][0] - shape_gaps[key][1])
                            for key, c in at.items()) / 1e3
                out.append(dict(
                    kernel=k, route=r, launches=n,
                    gap_ms=score * 1e3 / n if n else None, score_s=score,
                    rows=[], shapes=len(at),
                    basis=f"every main-path shape ({len(at)})"))
                continue
            cand = {lab: x for lab, x in rows.items()
                    if x["kernel"] == k and x.get("route") == r}
            main = {lab: x for lab, x in cand.items() if lab in MAIN_ROWS}
            gaps = [x["ms"] - x["bound_ms"] for x in (main or cand).values()]
            gap = (sum(gaps) / len(gaps) if main else
                   min(gaps) if gaps else None)
            out.append(dict(
                kernel=k, route=r or "kernel", launches=n, gap_ms=gap,
                score_s=None if gap is None else n * gap / 1e3,
                rows=sorted(main or cand),
                basis="main-path shapes" if main else
                "cheapest timed shape" if cand else "not timed"))
    return sorted(out, key=lambda d: (d["score_s"] is None,
                                      -(d["score_s"] or 0.0)))


def k2_decode_rows(torch, tim, g, gemm_row, note):
    """K2 at decode M (its weight-streaming route on this tree, the split-K
    tile before): at each (M, K, N) of K2_DECODE_SHAPES held bit-exact
    against its plain version (and on a repeated call), then timed with 3
    weight copies rotated so the weights stream from HBM."""
    for m, k, n in K2_DECODE_SHAPES:
        ws = [torch.randint(-128, 128, (k // 2, n), dtype=torch.int8,
                            generator=g, device="cuda") for _ in range(3)]
        sw = (torch.rand((n,), generator=g, device="cuda") + 0.5) * 0.02 \
            / k ** 0.5
        x = torch.randn((m, k), generator=g, device="cuda").to(torch.bfloat16)
        xq, sx = tim.quantize_activation_per_row(x)
        got = tim.w4a8_gemm(xq, sx, ws[0], sw, torch.bfloat16)
        want = tim.w4a8_gemm_torch(xq, sx, ws[0], sw, torch.bfloat16)
        note("w4a8_gemm", got, want)
        assert torch.equal(got, want), ("K2 decode", m, k, n)
        assert torch.equal(tim.w4a8_gemm(xq, sx, ws[0], sw, torch.bfloat16),
                           got), ("K2 decode", m, k, n, "repeat")
        log(f"K2 w4a8_gemm at M={m}, K={k}, N={n}: bit-exact, repeated "
            "calls the same bits")
        label = ("w4a8_gemm[decode]" if (m, n) == (16, 28672) else
                 f"w4a8_gemm[decode M={m}]" if n == 28672 else
                 f"w4a8_gemm[lm_head M={m}]")
        gemm_row(label, "w4a8_gemm", m, k, n,
                 lambda i: tim.w4a8_gemm(xq, sx, ws[i % 3], sw,
                                         torch.bfloat16),
                 lambda i: tim.w4a8_gemm_torch(xq, sx, ws[i % 3], sw,
                                               torch.bfloat16),
                 K2_KERNELS, m * k + m * 4 + k // 2 * n, INT8_OPS)
        del ws, got, want


def fused_decode_rows(torch, tim, g, rows, gemm_row, note):
    """K2's fused decode kernel (``matmul_w4a8_fusedq`` at decode M) at
    each (M, K, N) of K2_DECODE_SHAPES, bf16 and f32 x: one launch, its
    codes and scales K1's and its output K2's decode route's on them and
    the plain version's, bit for bit, repeated calls the same bits; then
    timed with 3 weight copies rotated (bf16 x; f32 x at M = 16), beside
    K1 + K2's decode route on the same inputs (``k1_k2_ms``)."""
    for m, k, n in K2_DECODE_SHAPES:
        ws = [torch.randint(-128, 128, (k // 2, n), dtype=torch.int8,
                            generator=g, device="cuda") for _ in range(3)]
        sw = (torch.rand((n,), generator=g, device="cuda") + 0.5) * 0.02 \
            / k ** 0.5
        for xt in (torch.bfloat16, torch.float32):
            x = torch.randn((m, k), generator=g, device="cuda").to(xt)
            before = (tim.matmul_w4a8_fusedq.launches,
                      tim.quantize_activation_per_row.launches)
            got, q, s_ = tim.matmul_w4a8_fusedq(x, ws[0], sw,
                                                out_dtype=torch.bfloat16,
                                                return_codes=True)
            assert (tim.matmul_w4a8_fusedq.launches,
                    tim.quantize_activation_per_row.launches) == (
                        before[0] + 1, before[1]), ("fused: one launch", m)
            kq, ks = tim.quantize_activation_per_row(x)
            assert torch.equal(q, kq) and torch.equal(s_, ks), \
                ("fused codes", m, k, n, xt)
            k2 = tim.w4a8_gemm(kq, ks, ws[0], sw, torch.bfloat16)
            want = tim.matmul_w4a8_torch(x, ws[0], sw, torch.bfloat16)
            note("w4a8_fusedq", got, want)
            assert torch.equal(got, k2) and torch.equal(got, want), \
                ("fused", m, k, n, xt)
            for _ in range(2):
                assert torch.equal(tim.matmul_w4a8_fusedq(
                    x, ws[0], sw, out_dtype=torch.bfloat16), got), \
                    ("fused repeat", m, k, n, xt)
            log(f"w4a8_fusedq at M={m}, K={k}, N={n}, {xt} x: one launch; "
                "codes, scales and output bit-exact with K1 + K2's decode "
                "route and the plain version; repeated calls the same bits")
            if xt == torch.float32 and m != 16:
                continue
            tag = "" if xt == torch.bfloat16 else " f32 x"
            label = ((f"w4a8_fusedq[decode M={m}{tag}]" if n == 28672 else
                      f"w4a8_fusedq[lm_head M={m}{tag}]"))
            gemm_row(label, "w4a8_fusedq", m, k, n,
                     lambda i: tim.matmul_w4a8_fusedq(
                         x, ws[i % 3], sw, out_dtype=torch.bfloat16),
                     lambda i: tim.matmul_w4a8_torch(x, ws[i % 3], sw,
                                                     torch.bfloat16),
                     ["w4a8_fusedq_decode"], x.numel() * x.element_size()
                     + k // 2 * n, INT8_OPS)

            def k1_k2(i):
                xq, sx = tim.quantize_activation_per_row(x)
                return tim.w4a8_gemm(xq, sx, ws[i % 3], sw, torch.bfloat16)
            rows[label]["k1_k2_ms"], rows[label]["k1_k2_call_ms"] = timed(
                k1_k2, 20, K1_KERNELS + ["w4a8_decode_kernel"])
        del ws, x, got, want, k2


def attn_inputs(torch, g, B, S, pos, H=32, KH=8, D=128):
    """Decode-attention inputs at Llama-3-8B heads: random int8 caches
    (B, S, KH, D) and scales, a bf16 qkv row, rope rows at ``pos``."""
    kc = torch.randint(-127, 128, (B, S, KH, D), dtype=torch.int8,
                       generator=g, device="cuda")
    vc = torch.randint(-127, 128, (B, S, KH, D), dtype=torch.int8,
                       generator=g, device="cuda")
    ks = torch.rand((B, KH), generator=g, device="cuda") * 0.05 + 0.01
    vs = torch.rand((B, KH), generator=g, device="cuda") * 0.05 + 0.01
    qkv = torch.randn((B, (H + 2 * KH) * D), generator=g,
                      device="cuda").to(torch.bfloat16)
    ang = pos.float()[:, None] * torch.rand(D // 2, generator=g,
                                            device="cuda")
    return [qkv, torch.cos(ang), torch.sin(ang), kc, vc, ks, vs, pos]


def k3_rows(torch, dattn, g, rows, note):
    """K3 at the shapes of K3_SHAPES: held against its plain version (cache
    bytes bit-exact, output within TOL_ATTN of the max), then timed, with 4
    input sets at S = 1024 so the caches stream from HBM; returns the
    chunk sweep (ms by chunk and shape) where the tree splits the cache."""
    H, KH, D = 32, 8, 128
    sweep = {}
    for label, B, S, kind in K3_SHAPES:
        if kind == "mixed":
            pos = torch.randint(0, S, (B,), generator=g, device="cuda",
                                dtype=torch.int32)
            pos[0], pos[-1] = 0, S - 1
        else:
            pos = (S - 384 - torch.arange(B, device="cuda",
                                          dtype=torch.int32))
        nsets = 4 if S <= 1024 else 1
        sets = [attn_inputs(torch, g, B, S, pos) for _ in range(nsets)]
        b_ = [t.clone() for t in sets[0]]
        out, _, _ = dattn.fused_decode_attention(*sets[0], n_heads=H,
                                                 n_kv_heads=KH)
        ref, _, _ = dattn.fused_decode_attention_torch(*b_, n_heads=H,
                                                       n_kv_heads=KH)
        note("decode_attention", out, ref)
        assert torch.equal(sets[0][3], b_[3]) and \
            torch.equal(sets[0][4], b_[4]), ("K3 cache bytes", label)
        err = rel_err(out, ref)
        assert err < TOL_ATTN, ("K3", label, err)
        again, _, _ = dattn.fused_decode_attention(*sets[0], n_heads=H,
                                                   n_kv_heads=KH)
        assert torch.equal(again, out), ("K3 repeat", label)
        log(f"K3 decode_attention at {label}: cache bytes bit-exact, "
            f"max rel err {err:.3e} < {TOL_ATTN}, repeated launches the "
            "same bits")
        del b_, out, ref, again

        def k3(i, fn=dattn.fused_decode_attention):
            return fn(*sets[i % nsets], n_heads=H, n_kv_heads=KH)
        ms, call = timed(k3, 40 if S <= 1024 else 10, K3_KERNELS)
        pms, _ = timed(lambda i: k3(i, dattn.fused_decode_attention_torch),
                       10 if S <= 1024 else 2)
        live = int((pos.clamp(max=S - 1) + 1).sum())
        nbytes = (B * (H + 2 * KH) * D * 2 + 2 * B * D // 2 * 4
                  + 2 * live * KH * D + 4 * B * KH * 4 + 2 * B * KH * D
                  + B * H * D * 2)
        b, how = bound_ms(nbytes, (4 * live * H * D, F32_FLOPS))
        name = "decode_attention" + ("" if label == K3_SHAPES[0][0]
                                     else f"[{label}]")
        rows[name] = dict(
            kernel="decode_attention",
            shape=f"B={B} S={S} H={H} KH={KH} D={D} {kind} positions "
            f"({live} live rows)", ms=ms, call_ms=call, plain_ms=pms,
            bound_ms=b, bound_by=how)
        if hasattr(dattn, "split_chunk"):          # the split kernel
            rows[name]["chunk"] = dattn.split_chunk(B, KH, S)
            chosen = dattn.split_chunk
            try:
                for c in (32, 64, 128, 256):
                    dattn.split_chunk = lambda *a, c=c: c
                    sweep[f"{label} C={c}"], _ = timed(k3, 20, K3_KERNELS)
            finally:
                dattn.split_chunk = chosen
            log(f"K3 chunk sweep at {label} (device ms): " + ", ".join(
                f"{k.split()[-1]} {v:.5f}" for k, v in sweep.items()
                if k.startswith(label)))
        del sets
    return sweep


def profile_steps(torch, step, n=4):
    """Where a decode step's time goes: ``step()`` n times under the
    profiler. Returns (host ms a step, device busy share, device ms a step,
    {kernel: device ms a step})."""
    with profiled() as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    for e in _kernel_events(prof):
        key = e.name.replace("(anonymous namespace)::", "")
        key = key.removeprefix("void ").split("<")[0].split("(")[0]
        by_name[key] = by_name.get(key, 0.0) + \
            e.time_range.elapsed_us() / (1e3 * n)
    dev = sum(by_name.values())
    return wall * 1e3 / n, dev / (wall * 1e3 / n), dev, by_name


def slot_step_profile(torch, llm, mode, tok, caches, slots, metrics, b):
    """Profiles 4 decode steps at per-slot positions (the batcher's step)
    and logs them; returns (tok, caches, slots) after them."""
    state = [tok, caches, slots]

    def step():
        logits, state[1] = llm.decode(state[0], state[1], state[2])
        state[0] = logits[:, -1].argmax(-1)[:, None]
        state[2] = state[2] + 1
    step()                                         # warm-up
    wall, busy, dev, by_name = profile_steps(torch, step)
    metrics[f"slot_b{b}_ms_step"] = wall
    metrics[f"slot_b{b}_device_ms_step"] = dev
    metrics[f"slot_b{b}_device_busy"] = busy
    metrics[f"slot_b{b}_kernels"] = by_name
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    log(f"[{mode}] per-slot decode step at batch {b} profile: {wall:.2f} "
        f"ms/step on the host clock, {dev:.3f} device ms/step, busy "
        f"{busy:.3f}; device ms/step by kernel: "
        + ", ".join(f"{k} {v:.4f}" for k, v in top))
    return state


def rel_err(got, want):
    """max |got - want| / max |want|."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def check_kernels(torch, ops):
    """Phase 2: every kernel against its plain version, and its timing."""
    tim, dattn, flay, dsol, gqa = ops
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(1)
    rows = {}
    errs = {k: 0.0 for k in SOURCES}

    def note(name, a, b):
        e = (a.float() - b.float()).abs().max().item()
        errs[name] = max(errs[name], e)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    def codes(rows_, n):
        return torch.randint(-128, 128, (rows_, n), dtype=torch.int8,
                             generator=g, device=dev)

    def scales(k, n):
        return (torch.rand((n,), generator=g, device=dev) + 0.5) * 0.02 \
            / k ** 0.5

    # --- K1: activation quantizer at prefill and decode shapes
    for m, k in ((4096, 4096), (4096, 14336), (16, 4096)):
        x = randn(m, k)
        q, s = tim.quantize_activation_per_row(x)
        pq, ps = tim._quantize_activation_plain(x)
        note("act_quant", q, pq)
        assert torch.equal(q, pq) and torch.equal(s, ps), ("K1", m, k)
    log("K1 act_quant: codes and scales bit-exact at (4096,4096), "
        "(4096,14336), (16,4096)")
    m, k = 4096, 4096
    xs = [randn(m, k) for _ in range(4)]
    ms, call = timed(lambda i: tim.quantize_activation_per_row(xs[i % 4]),
                     50, K1_KERNELS)
    pms, _ = timed(lambda i: tim._quantize_activation_plain(xs[i % 4]), 10)
    b, how = bound_ms(m * k * 2 + m * k + m * 4, (3 * m * k, F32_FLOPS))
    rows["act_quant"] = dict(kernel="act_quant", shape=f"x ({m},{k}) bf16",
                             ms=ms, call_ms=call, plain_ms=pms, bound_ms=b,
                             bound_by=how)
    k1_decode_rows(torch, tim, g, rows, note)
    k1_conv_rows(torch, tim, g, rows, note)

    # --- K2, KW4, KW8 at every main-path (K, N), plus a ragged shape
    kn = [(4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096),
          (4096, 131072)]
    for m in (16, 2048):
        for k, n in kn:
            xq, sx = tim.quantize_activation_per_row(randn(m, k))
            w, sw = codes(k // 2, n), scales(k, n)
            got = tim.w4a8_gemm(xq, sx, w, sw, torch.bfloat16)
            want = tim.w4a8_gemm_torch(xq, sx, w, sw, torch.bfloat16)
            note("w4a8_gemm", got, want)
            assert torch.equal(got, want), ("K2", m, k, n)
            del xq, w, got, want
    x = torch.randn((37, 144), generator=g, device=dev)
    w = codes(72, 1000)
    sw = torch.rand((1000,), generator=g, device=dev)
    assert torch.equal(tim.matmul_w4a8(x, w, sw),
                       tim.matmul_w4a8_torch(x, w, sw)), "K2 ragged"
    log("K2 w4a8_gemm: bit-exact at M in {16, 2048} x (K, N) in "
        f"{kn}, and at ragged (37, 144) x (144, 1000) f32")
    wo = {"w4_gemm": (True, tim.matmul_w4, tim.matmul_w4_torch),
          "w8_gemm": (False, tim.matmul_w8, tim.matmul_w8_torch)}
    for name, (w4, fn, plain) in wo.items():
        worst = 0.0
        for m in (16, 4096):
            for k, n in kn:
                x, w, sw = randn(m, k), codes(k // 2 if w4 else k, n), \
                    scales(k, n)
                got, want = fn(x, w, sw), plain(x, w, sw)
                note(name, got, want)
                err = rel_err(got, want)
                worst = max(worst, err)
                assert err < TOL_WO, (name, m, k, n, err)
                if m == 16:
                    assert torch.equal(fn(x, w, sw), got), (name, "repeat")
                del x, w, got, want
        x, w, sw = randn(37, 144), codes(72 if w4 else 144, 1000), \
            scales(144, 1000)
        err = rel_err(fn(x, w, sw), plain(x, w, sw))
        assert err < TOL_WO, (name, "ragged", err)
        log(f"{name}: within {worst:.2e} of max (< {TOL_WO}) at M in "
            f"{{16, 4096}} x (K, N) in {kn}; ragged (37, 144) x (144, 1000) "
            f"{err:.2e}; repeated decode calls give the same bits")

    gemm_row = gemm_timer(rows)
    k2_decode_rows(torch, tim, g, gemm_row, note)
    fused_decode_rows(torch, tim, g, rows, gemm_row, note)
    kw4_rows(torch, tim, g, rows, gemm_row, note)
    for m, tag in ((16, "decode"), (4096, "prefill")):
        k, n = 4096, 28672
        # rotate 3 weight copies so the decode weights stream from HBM
        ws = [codes(k // 2, n) for _ in range(3)]
        sw = scales(k, n)
        xq, sx = tim.quantize_activation_per_row(randn(m, k))
        if m > 16:                       # K2 at decode M: k2_decode_rows
            gemm_row(f"w4a8_gemm[{tag}]", "w4a8_gemm", m, k, n,
                     lambda i: tim.w4a8_gemm(xq, sx, ws[i % 3], sw,
                                             torch.bfloat16),
                     lambda i: tim.w4a8_gemm_torch(xq, sx, ws[i % 3], sw,
                                                   torch.bfloat16),
                     K2_KERNELS, m * k + m * 4 + k // 2 * n, INT8_OPS)
        x = randn(m, k)                  # KW4's rows: kw4_rows
        ws = [codes(k, n) for _ in range(3)]
        gemm_row(f"w8_gemm[{tag}]", "w8_gemm", m, k, n,
                 lambda i: tim.matmul_w8(x, ws[i % 3], sw),
                 lambda i: tim.matmul_w8_torch(x, ws[i % 3], sw),
                 KW8_KERNELS, m * k * 2 + ws[0].numel(), BF16_FLOPS)
        del ws, xq, x
    # KW8's decode route (the w8 serving decode) at every M tile
    k, n = 4096, 28672
    ws = [codes(k, n) for _ in range(3)]
    sw = scales(k, n)
    for m in W8_DECODE_ROWS:
        x = randn(m, k)
        got = tim.matmul_w8(x, ws[0], sw)
        want = tim.matmul_w8_torch(x, ws[0], sw)
        note("w8_gemm", got, want)
        err = rel_err(got, want)
        assert err < TOL_WO, ("KW8 decode route", m, err)
        assert torch.equal(tim.matmul_w8(x, ws[0], sw), got), \
            ("KW8 decode route", m, "repeat")
        log(f"w8_gemm decode route at M={m}, K={k}, N={n}: within "
            f"{err:.2e} of max (< {TOL_WO}), repeated calls the same bits")
        del got, want
        gemm_row(f"w8_gemm[decode M={m}]", "w8_gemm", m, k, n,
                 lambda i: tim.matmul_w8(x, ws[i % 3], sw),
                 lambda i: tim.matmul_w8_torch(x, ws[i % 3], sw),
                 ["wo_decode"], m * k * 2 + ws[0].numel(), BF16_FLOPS)
    del ws, x

    # --- K3 at the per-slot step's shape, batch 32 and the long cache
    chunk_sweep = k3_rows(torch, dattn, g, rows, note)
    B, S, H, KH, D = 16, 1024, 32, 8, 128

    def attn_inputs_(pos):
        return attn_inputs(torch, g, B, S, pos)

    # --- KFL and KSOL at Llama-3-8B layer shapes, M = B = 16
    A, Dm, F, Nq = H * D, 4096, 14336, (H + 2 * KH) * D

    def layer_weights():
        return dict(
            wo_pair=(codes(A // 2, Dm), scales(A, Dm)),
            gateup_pair=(codes(Dm // 2, 2 * F), scales(Dm, 2 * F)),
            down_pair=(codes(F // 2, Dm), scales(F, Dm)),
            mlp_gamma=torch.ones(Dm, dtype=torch.bfloat16, device=dev),
            next_qkv=((codes(Dm // 2, Nq), scales(Dm, Nq)),
                      torch.ones(Dm, dtype=torch.bfloat16, device=dev)))

    lw = [layer_weights() for _ in range(2)]      # 2 x 109 MB > L2
    wbytes = sum(t[0].numel() + t[1].numel() * 4 for t in (
        lw[0]["wo_pair"], lw[0]["gateup_pair"], lw[0]["down_pair"]))
    qbytes = lw[0]["next_qkv"][0][0].numel() + Nq * 4
    gemm_ops = 2 * B * (A * Dm + 2 * Dm * F + F * Dm)
    ao, resid = randn(B, A), randn(B, Dm)
    jw = [jax_form(w) for w in lw]                # KFL's, KDL's signature
    for nxt in (False, True):
        kw = dict(jw[0], next_qkv=lw[0]["next_qkv"] if nxt else None)
        got = flay.fused_wo_mlp(ao, resid, **kw)
        want = flay.fused_wo_mlp_torch(ao, resid, **kw)
        got, want = (got, want) if nxt else ((got,), (want,))
        err = 0.0
        for gg, ww in zip(got, want):
            note("fused_wo_mlp", gg, ww)
            err = max(err, rel_err(gg, ww))
            assert err < TOL_ATTN, ("KFL", nxt, err)
        log(f"KFL fused_wo_mlp (next_qkv={nxt}): within {err:.3e} of max "
            f"(< {TOL_ATTN}) at M={B} A={A} D={Dm} F={F} Nq={Nq}")
        label = "fused_wo_mlp[next_qkv]" if nxt else "fused_wo_mlp"
        kw = [dict(w, next_qkv=w["next_qkv"] if nxt else None) for w in jw]
        ms, call = timed(lambda i: flay.fused_wo_mlp(ao, resid, **kw[i % 2]),
                         20, ["fused_layer_kernel"])
        pms, _ = timed(lambda i: flay.fused_wo_mlp_torch(ao, resid,
                                                         **kw[i % 2]), 3)
        b, how = bound_ms(wbytes + qbytes * nxt + (A + 2 * Dm) * B * 2
                          + B * Nq * 2 * nxt,
                          (gemm_ops + 2 * B * Dm * Nq * nxt, BF16_FLOPS))
        rows[label] = dict(kernel="fused_wo_mlp",
                           shape=f"M={B} A={A} D={Dm} F={F}"
                           + f" Nq={Nq}" * nxt, ms=ms, call_ms=call,
                           plain_ms=pms, bound_ms=b, bound_by=how,
                           phases=phase_split(
                               torch, flay, lambda i: flay.fused_wo_mlp(
                                   ao, resid, **kw[i % 2])))

    from aimet_tpu_torch.models.transformer import (TransformerConfig,
                                                    rope_freqs)
    pos = 700
    cos, sin = rope_freqs(TransformerConfig.llama3_8b(),
                          torch.full((B,), pos, device=dev))
    for int8_dots in (False, True):
        for nxt in (False, True):
            a = attn_inputs_(torch.full((B,), pos, device=dev,
                                        dtype=torch.int32))
            qkv, kc, vc, ks, vs = a[0], a[3], a[4], a[5], a[6]
            kc2, vc2 = kc.clone(), vc.clone()
            kc3, vc3 = kc.clone().view(B, S, -1), vc.clone().view(B, S, -1)
            kw = dict(lw[0], next_qkv=lw[0]["next_qkv"] if nxt else None,
                      n_heads=H, n_kv_heads=KH, int8_dots=int8_dots)
            got = dsol.sol_decode_layer(qkv, resid, kc, vc, ks, vs, pos, cos,
                                        sin, **kw)
            want = dsol.sol_decode_layer_torch(qkv, resid, kc2, vc2, ks, vs,
                                               pos, cos, sin, **kw)
            if not int8_dots:
                # KDL on the same inputs: flat caches, the JAX signature
                kdl = flay.fused_decode_layer(
                    qkv, resid, kc3, vc3, ks, vs, pos, cos, sin,
                    **dict(jw[0], next_qkv=kw["next_qkv"]), n_heads=H,
                    n_kv_heads=KH)
            torch.cuda.synchronize()
            assert torch.equal(kc, kc2) and torch.equal(vc, vc2), \
                ("KSOL cache bytes", int8_dots, nxt)
            tol = TOL_INT8_DOTS if int8_dots else TOL_ATTN
            err = 0.0
            for gg, ww in zip(got[:1 + nxt], want[:1 + nxt]):
                note("sol_decode_layer", gg, ww)
                err = max(err, rel_err(gg, ww))
                assert err < tol, ("KSOL", int8_dots, nxt, err)
            log(f"KSOL sol_decode_layer (int8_dots={int8_dots}, next_qkv="
                f"{nxt}): cache bytes bit-exact, within {err:.3e} of max "
                f"(< {tol}) at B={B} S={S} position {pos}, D={Dm} F={F}")
            if int8_dots:
                continue
            assert torch.equal(kc3.view(kc.shape), kc) and \
                torch.equal(vc3.view(vc.shape), vc), ("KDL cache bytes", nxt)
            for gg, ww, oo in zip(kdl[:1 + nxt], want[:1 + nxt],
                                  got[:1 + nxt]):
                note("fused_decode_layer", gg, ww)
                assert torch.equal(gg, oo), ("KDL against KSOL", nxt)
            log(f"KDL fused_decode_layer (next_qkv={nxt}, flat caches, gate|"
                f"up one array): KSOL's bits and cache bytes on its inputs, "
                f"so within {err:.3e} of the plain version's max")
        del a, kc, vc, kc2, vc2, kc3, vc3
    # timing with the next layer's QKV: 4 cache sets, 2 weight sets
    sets = [attn_inputs_(torch.full((B,), pos, device=dev,
                                    dtype=torch.int32)) for _ in range(4)]
    live = B * (pos + 1)
    kv_bytes = (2 * live * KH * D + B * (H + 2 * KH) * D * 2
                + 2 * B * D // 2 * 4 + 4 * B * KH * 4)
    for int8_dots, tag in ((False, "w4"), (True, "w4a8")):
        def sol(i, fn=dsol.sol_decode_layer):
            s_ = sets[i % 4]
            return fn(s_[0], resid, s_[3], s_[4], s_[5], s_[6], pos, cos,
                      sin, **lw[i % 2], n_heads=H, n_kv_heads=KH,
                      int8_dots=int8_dots)
        ms, call = timed(sol, 20, ["fused_layer_kernel"])
        pms, _ = timed(lambda i: sol(i, dsol.sol_decode_layer_torch), 3)
        peak = INT8_OPS if int8_dots else BF16_FLOPS
        b, how = bound_ms(wbytes + qbytes + kv_bytes + 2 * B * Dm * 2
                          + B * Nq * 2,
                          (gemm_ops + 2 * B * Dm * Nq, peak),
                          (4 * live * H * D, F32_FLOPS))
        rows[f"sol_decode_layer[{tag}]"] = dict(
            kernel="sol_decode_layer",
            shape=f"B={B} S={S} position {pos} H={H} KH={KH} D={Dm} F={F} "
            f"Nq={Nq}, int8_dots={int8_dots}", ms=ms, call_ms=call,
            plain_ms=pms, bound_ms=b, bound_by=how,
            phases=phase_split(torch, flay, sol))
    # KSOL (w4, next QKV) at the decode streaming routine's other M tiles
    for m in SOL_ROWS:
        pm = torch.full((m,), pos, device=dev, dtype=torch.int32)
        cm, sm = rope_freqs(TransformerConfig.llama3_8b(), pm)
        rm = randn(m, Dm)
        msets = [(randn(m, (H + 2 * KH) * D),
                  torch.randint(-127, 128, (m, S, KH, D), dtype=torch.int8,
                                generator=g, device=dev),
                  torch.randint(-127, 128, (m, S, KH, D), dtype=torch.int8,
                                generator=g, device=dev),
                  torch.rand((m, KH), generator=g, device=dev) * 0.05 + 0.01,
                  torch.rand((m, KH), generator=g, device=dev) * 0.05 + 0.01)
                 for _ in range(2)]

        def solm(i, fn=dsol.sol_decode_layer, caches=None):
            q_, kc_, vc_, ks_, vs_ = msets[i % 2]
            kc_, vc_ = caches or (kc_, vc_)
            return fn(q_, rm, kc_, vc_, ks_, vs_, pos, cm, sm, **lw[i % 2],
                      n_heads=H, n_kv_heads=KH)
        c1 = [t.clone() for t in msets[0][1:3]]
        c2 = [t.clone() for t in msets[0][1:3]]
        got, want = solm(0, caches=c1), solm(0, dsol.sol_decode_layer_torch,
                                            caches=c2)
        assert torch.equal(c1[0], c2[0]) and torch.equal(c1[1], c2[1]), \
            ("KSOL cache bytes", m)
        err = max(rel_err(a_, b_) for a_, b_ in zip(got[:2], want[:2]))
        for a_, b_ in zip(got[:2], want[:2]):
            note("sol_decode_layer", a_, b_)
        assert err < TOL_ATTN, ("KSOL", m, err)
        log(f"KSOL sol_decode_layer at B={m} (next_qkv): cache bytes "
            f"bit-exact, within {err:.3e} of max (< {TOL_ATTN})")
        del c1, c2, got, want
        ms, call = timed(solm, 20, ["fused_layer_kernel"])
        pms, _ = timed(lambda i: solm(i, dsol.sol_decode_layer_torch), 3)
        livem = m * (pos + 1)
        kvm = (2 * livem * KH * D + m * (H + 2 * KH) * D * 2
               + 2 * m * D // 2 * 4 + 4 * m * KH * 4)
        b, how = bound_ms(wbytes + qbytes + kvm + 2 * m * Dm * 2
                          + m * Nq * 2,
                          (gemm_ops * m // B + 2 * m * Dm * Nq, BF16_FLOPS),
                          (4 * livem * H * D, F32_FLOPS))
        rows[f"sol_decode_layer[w4 B={m}]"] = dict(
            kernel="sol_decode_layer",
            shape=f"B={m} S={S} position {pos} H={H} KH={KH} D={Dm} F={F} "
            f"Nq={Nq}, int8_dots=False", ms=ms, call_ms=call, plain_ms=pms,
            bound_ms=b, bound_by=how)
        del msets
    for nxt, tag, site in ((False, "last", 457), (True, "next_qkv", 502)):
        def kdl(i, fn=flay.fused_decode_layer):
            s_ = sets[i % 4]
            return fn(s_[0], resid, s_[3].view(B, S, KH * D),
                      s_[4].view(B, S, KH * D), s_[5], s_[6], pos, cos, sin,
                      **dict(jw[i % 2], next_qkv=jw[i % 2]["next_qkv"]
                             if nxt else None), n_heads=H, n_kv_heads=KH)
        ms, call = timed(kdl, 20, ["fused_layer_kernel"])
        pms, _ = timed(lambda i: kdl(i, flay.fused_decode_layer_torch), 3)
        b, how = bound_ms(wbytes + qbytes * nxt + kv_bytes + 2 * B * Dm * 2
                          + B * Nq * 2 * nxt,
                          (gemm_ops + 2 * B * Dm * Nq * nxt, BF16_FLOPS),
                          (4 * live * H * D, F32_FLOPS))
        rows[f"fused_decode_layer[{tag}]"] = dict(
            kernel="fused_decode_layer",
            replaces=f"aimet_tpu/ops/fused_layer.py:{site}",
            shape=f"B={B} S={S} position {pos} H={H} KH={KH} D={Dm} F={F}"
            + f" Nq={Nq}" * nxt + ", flat caches, gate|up one array",
            ms=ms, call_ms=call, plain_ms=pms, bound_ms=b, bound_by=how,
            phases=phase_split(torch, flay, kdl))
    check_gqa_kernel(torch, gqa, g, rows, note, pos)
    del sets, lw
    check_lowering_kernels(torch, tim, g, rows, errs, note, randn, codes,
                           gemm_row)
    check_w8a8_kernels(torch, tim, g, rows, note, gemm_row)
    library_probes(torch, tim, g, rows)
    for r in rows.values():
        r["max_abs_err"] = errs[r["kernel"]]
        r.setdefault("library_ms", None)
    return rows, chunk_sweep


def jax_form(w):
    """A layer's weights (``gateup_pair``: one (D/2, 2F) array) in the JAX
    signature of fused_wo_mlp / fused_decode_layer, as the sweep passes
    them: the one array as both gate and up, up located by
    ``up_block_offset`` at the sweep's default block_g of 1024."""
    w = dict(w)
    wgu, sgu = w.pop("gateup_pair")
    F = wgu.shape[1] // 2
    return dict(w, gate_pair=(wgu, sgu[:F]), up_pair=(wgu, sgu[F:]),
                block_g=1024, up_block_offset=F // 1024, n_f=F)


def gqa_flip_bound(torch, q, kc, vc, ks, vs, pos):
    """KGQA's tolerance for a bf16 q: v_scale * sum_s ulp_bf16(p_s) |v_s|,
    the context's change when every prob's bf16 rounding moves one ulp
    (the kernel's and the plain version's f32 softmaxes differ in the last
    bits), plus 1e-4 of the max for the f32 sums."""
    D = q.shape[-1]
    qs = q * (ks / D ** 0.5)[:, :, None, None].to(q.dtype)
    sc = torch.einsum("bkrd,bskd->bkrs", qs.float(), kc.float())
    live = torch.arange(kc.shape[1], device=q.device) <= pos
    p = torch.softmax(sc.masked_fill(~live, -1e30), -1)
    ulp = torch.where(p > 0, torch.exp2(torch.floor(torch.log2(
        p.clamp_min(1e-30))) - 7), torch.zeros_like(p))
    return torch.einsum("bkrs,bskd->bkrd", ulp, vc.abs().float()) \
        * vs[:, :, None, None]


def check_gqa(torch, gqa, q, kc, vc, ks, vs, pos):
    """KGQA against its plain version on one input, and a repeated call
    against the first; returns (kernel out, plain out, max |diff| / max
    |plain|). Raises beyond the tolerance or on other bits."""
    got = gqa.fused_gqa_decode_attention(q, kc, vc, ks, vs, pos)
    assert torch.equal(gqa.fused_gqa_decode_attention(q, kc, vc, ks, vs,
                                                      pos), got), \
        ("KGQA repeat", pos)
    want = gqa.fused_gqa_decode_attention_torch(q, kc, vc, ks, vs, pos)
    err = rel_err(got, want)
    if q.dtype == torch.float32:
        assert err < TOL_GQA_F32, ("KGQA f32", pos, err)
    else:
        bound = gqa_flip_bound(torch, q, kc, vc, ks, vs, pos) \
            + TOL_GQA_F32 * want.abs().max()
        assert ((got - want).abs() <= bound).all(), ("KGQA bf16", pos, err)
    return got, want, err


def check_gqa_kernel(torch, gqa, g, rows, note, pos):
    """KGQA at Llama-3-8B decode shapes (B 16, S 1024, KH 8, rep 4, D 128)
    against its plain version, f32 and bf16 q, at a live position, the
    last and first rows of a chunk, a negative position and one past S,
    and at S = 1 and 4097 (positions on and around its chunk edges, the
    last row, past S, negative); then its timings."""
    dev = "cuda"
    B, S, KH, rep, D = 16, 1024, 8, 4, 128
    zero = torch.zeros((B,), device=dev, dtype=torch.int32)
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        kc, vc, ks, vs = attn_inputs(torch, g, B, S, zero)[3:7]
        q = torch.randn((B, KH, rep, D), generator=g, device=dev).to(dtype)
        worst, tried = 0.0, []
        for s_len in (S, 1, 4097):
            if s_len != S:
                kc, vc, ks, vs = attn_inputs(torch, g, B, s_len, zero)[3:7]
            c = gqa.gqa_chunk(B, KH, s_len)
            cases = ((pos, c - 1, c, -1, S + 5) if s_len == S else
                     (0, -1, 3) if s_len == 1 else
                     (c - 1, c, 3 * c + 1, s_len - 1, -1, s_len + 7))
            for p_ in cases:
                got, want, err = check_gqa(torch, gqa, q, kc, vc, ks, vs,
                                           p_)
                note("gqa_decode_attention", got, want)
                worst = max(worst, err)
            tried.append(f"S={s_len} (chunk {c}) at "
                         + ", ".join(map(str, cases)))
        log(f"KGQA gqa_decode_attention ({tag} q): within {worst:.3e} of max "
            f"at {'; '.join(tried)} ("
            + (f"< {TOL_GQA_F32}" if tag == "f32" else
               "one bf16 ulp a prob") + "), repeat bits equal")
        # timing: 4 cache sets so reads come from HBM
        sets = [attn_inputs(torch, g, B, S, zero)[3:7] for _ in range(4)]
        ms, call = timed(lambda i: gqa.fused_gqa_decode_attention(
            q, *sets[i % 4], pos), 40, GQA_KERNELS)
        pms, _ = timed(lambda i: gqa.fused_gqa_decode_attention_torch(
            q, *sets[i % 4], pos), 10)
        live = B * (pos + 1)
        H = KH * rep
        nbytes = (q.numel() * q.element_size() + 2 * live * KH * D
                  + 2 * B * KH * 4 + B * H * D * 4)
        b, how = bound_ms(nbytes, (4 * live * H * D, F32_FLOPS))
        rows[f"gqa_decode_attention[{tag}]"] = dict(
            kernel="gqa_decode_attention",
            shape=f"B={B} S={S} KH={KH} rep={rep} D={D} position {pos}, "
            f"{tag} q", ms=ms, call_ms=call, plain_ms=pms, bound_ms=b,
            bound_by=how, chunk=gqa.gqa_chunk(B, KH, S))
        del kc, vc, sets


def check_lowering_kernels(torch, tim, g, rows, errs, note, randn, codes,
                           gemm_row):
    """KSQ, KW4G and KW4 / KW8 on f32 x against their plain versions at the
    lowered Llama-3-8B's shapes (M = 4096 and 16), and their timings."""
    dev = "cuda"
    lin_kn = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096)]
    ksq_kn = lin_kn + [(4096, 128256)]
    enc = dict(inv_delta=1 / 0.0213, offset=-119.0, num_steps=255.0)

    def ksq_inputs(m, k, n, x_dtype):
        x = (torch.randn((m, k), generator=g, device=dev) * 1.5).to(x_dtype)
        w = torch.randint(-127, 128, (k, n), dtype=torch.int8, generator=g,
                          device=dev)
        sv = (torch.rand((n,), generator=g, device=dev) + 0.5) * 1e-4
        cb = torch.randn((n,), generator=g, device=dev)
        return x, w, sv, cb

    for m in (4096, 16):
        for k, n in ksq_kn:
            # the lowered f32 model passes an f32 x (and takes an f32 out)
            # at every linear; a bf16 x besides, but at the lm_head
            for x_dtype in ((torch.float32,) if n == 128256 else
                            (torch.float32, torch.bfloat16)):
                out_dtype = x_dtype
                x, w, sv, cb = ksq_inputs(m, k, n, x_dtype)
                kw = dict(enc, out_dtype=out_dtype, return_codes=True)
                route = ("tile" if tim.w8a8_staticq_tile_route(m, n, k)
                         else "s8_tile")
                before = tim.matmul_w8a8_staticq.routes[route]
                got, q = tim.matmul_w8a8_staticq(x, w, sv, cb, **kw)
                assert tim.matmul_w8a8_staticq.routes[route] == before + 1
                want, pq = tim.matmul_w8a8_staticq_torch(x, w, sv, cb, **kw)
                note("w8a8_staticq", got, want)
                assert torch.equal(q, pq), ("KSQ codes", m, k, n, x_dtype)
                assert torch.equal(got, want), ("KSQ", m, k, n, x_dtype)
                assert torch.equal(tim.matmul_w8a8_staticq(x, w, sv, cb,
                                                           **kw)[0], got), \
                    ("KSQ repeat", m, k, n, x_dtype)
                del x, w, got, want, q, pq
    log("KSQ w8a8_staticq: codes and outputs bit-exact, repeated calls the "
        f"same bits, at M in {{4096 (its tile), 16}} x (K, N) in {ksq_kn} "
        "(f32 x at each, bf16 x too but at the lm_head)")

    worst, f32_errs = 0.0, {}
    for m in (4096, 16):
        for k, n in lin_kn:
            for x_dtype in ((torch.bfloat16, torch.float32) if m == 4096
                            or n == 14336 else (torch.bfloat16,)):
                x = torch.randn((m, k), generator=g, device=dev).to(x_dtype)
                w = torch.randn((k, n), generator=g, device=dev) * 0.02
                packed, sc = tim.quantize_weight_int4_grouped(w, 128)
                got = tim.matmul_w4_grouped(x, packed, sc, group_size=128)
                want = tim.matmul_w4_grouped_torch(x, packed, sc, 128)
                note("w4_grouped_gemm", got, want)
                err = rel_err(got, want)
                worst = max(worst, err)
                assert err < TOL_WO, ("KW4G", m, k, n, x_dtype, err)
                if m == 4096 and x_dtype == torch.float32:
                    # the tile against the block tile it replaces, f32 out
                    block = tim._launch_bf_tile(
                        "aimet_w4g_gemm", tim.matmul_w4_grouped, x, packed,
                        sc, torch.empty_like(got), 128)
                    f32_errs[f"{k}x{n}"] = (err, rel_err(block, want))
                    assert err < TOL_W4G_F32, ("KW4G f32", k, n, err)
                    del block
                del x, w, packed, got, want
    log("KW4G on f32 x, f32 out, M=4096, group 128: tile / block tile within "
        + ", ".join(f"{s_} {a:.2e} / {b:.2e}" for s_, (a, b) in
                    f32_errs.items())
        + f" of max (< {TOL_W4G_F32})")
    for m, k, grp in ((32, 4096, 128), (64, 4096, 128), (16, 4608, 8),
                      (16, 4608, 24), (16, 4608, 64), (300, 4096, 64),
                      (300, 4096, 256)):
        n = 14336
        x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
        w = torch.randn((k, n), generator=g, device=dev) * 0.02
        packed, sc = tim.quantize_weight_int4_grouped(w, grp)
        got = tim.matmul_w4_grouped(x, packed, sc, group_size=grp)
        want = tim.matmul_w4_grouped_torch(x, packed, sc, grp)
        note("w4_grouped_gemm", got, want)
        err = rel_err(got, want)
        worst = max(worst, err)
        assert err < TOL_WO, ("KW4G", m, k, n, grp, err)
        assert torch.equal(tim.matmul_w4_grouped(x, packed, sc,
                                                 group_size=grp), got), \
            ("KW4G repeat", m, grp)
        del x, w, packed, got, want
    log(f"KW4G w4_grouped_gemm: within {worst:.2e} of max (< {TOL_WO}) at M "
        f"in {{4096, 16}} x (K, N) in {lin_kn}, group 128 (bf16 x; f32 x "
        "too at M=4096 and N=14336); at M 32 and 64 (group 128), M 16 with "
        "groups 8, 24 and 64 (K 4608, N 14336) and M 300 with groups 64 and "
        "256 (the tile), repeated calls giving the same bits")

    wo = {"w4_gemm": (True, tim.matmul_w4, tim.matmul_w4_torch),
          "w8_gemm": (False, tim.matmul_w8, tim.matmul_w8_torch)}
    for name, (w4, fn, plain) in wo.items():
        worst = 0.0
        for m in (4096, 16):
            for k, n in ((4096, 128256), (4096, 4096)):
                x = torch.randn((m, k), generator=g, device=dev)
                w = codes(k // 2 if w4 else k, n)
                sw = (torch.rand((n,), generator=g, device=dev) + 0.5) \
                    * 0.02 / k ** 0.5
                got, want = fn(x, w, sw), plain(x, w, sw)
                note(name, got, want)
                err = rel_err(got, want)
                worst = max(worst, err)
                assert got.dtype == torch.float32 and err < TOL_WO_F32, \
                    (name, "f32", m, k, n, err)
                del x, w, got, want
        log(f"{name} on f32 x: within {worst:.2e} of max (< {TOL_WO_F32}) "
            "at M in {4096, 16} x (K, N) in [(4096, 128256), (4096, 4096)]")

    # timings at the lowered model's shapes
    for label, m, k, n, xt in KSQ_ROWS:
        x_dtype = torch.float32 if xt == "f32" else torch.bfloat16
        x, w, sv, cb = ksq_inputs(m, k, n, x_dtype)
        kw = dict(enc, out_dtype=x_dtype)
        esz = x.element_size()
        gemm_row(label, "w8a8_staticq", m, k, n,
                 lambda i: tim.matmul_w8a8_staticq(x, w, sv, cb, **kw),
                 lambda i: tim.matmul_w8a8_staticq_torch(x, w, sv, cb, **kw),
                 ["staticq_"], m * k * esz + k * n, INT8_OPS,
                 out_bytes=m * n * esz, vec_bytes=2 * n * 4,
                 iters=5 if n == 128256 else 20)
        # the codes kernel alone (part of the row's time)
        rows[label]["codes_ms"], _ = timed(
            lambda i: tim.matmul_w8a8_staticq(x, w, sv, cb, **kw), 5,
            ["staticq_quant"])
        # the library's int8 GEMM alone (no quantizer, no epilogue): not the
        # same function, so it stays out of library_ms
        if m > 16:
            xq = tim.quantize_static_q8_torch(x, enc["inv_delta"],
                                              enc["offset"],
                                              enc["num_steps"])
            ims, _ = timed(lambda i: torch._int_mm(xq, w), 10)
            rows[label]["int_mm_ms"] = ims
            del xq
        del x, w
    for tag, m, k, n, xt, ot in W4G_ROWS:
        f32 = xt == "f32"
        odt = torch.float32 if ot == "f32" else torch.bfloat16
        x = (torch.randn((m, k), generator=g, device=dev) if f32
             else randn(m, k))
        ws = [tim.quantize_weight_int4_grouped(
            torch.randn((k, n), generator=g, device=dev) * 0.02, 128)
            for _ in range(3)]
        # an f32 x is two bf16 operands: twice the bf16 tensor-core work
        gemm_row(f"w4_grouped_gemm[{tag}]", "w4_grouped_gemm", m, k, n,
                 lambda i: tim.matmul_w4_grouped(x, *ws[i % 3],
                                                 group_size=128,
                                                 out_dtype=odt),
                 lambda i: tim.matmul_w4_grouped_torch(x, *ws[i % 3], 128,
                                                       odt),
                 W4G_KERNELS, m * k * x.element_size() + k // 2 * n,
                 BF16_FLOPS / (2 if f32 else 1),
                 out_bytes=m * n * odt.itemsize,
                 vec_bytes=(k // 128) * n * 4, iters=5 if m > 64 else 20)
        del x, ws
    m, k, n = 4096, 4096, 128256
    x = torch.randn((m, k), generator=g, device=dev)
    w = codes(k // 2, n)
    sw = torch.rand((n,), generator=g, device=dev) * 1e-3
    # f32 x is two bf16 operands: twice the bf16 tensor-core work
    gemm_row("w4_gemm[f32 lm_head]", "w4_gemm", m, k, n,
             lambda i: tim.matmul_w4(x, w, sw),
             lambda i: tim.matmul_w4_torch(x, w, sw), KW4_KERNELS,
             m * k * 4 + w.numel(), BF16_FLOPS / 2, out_bytes=m * n * 4,
             iters=5)
    del x, w
    w8_f32_lm_head(torch, tim, g, rows, gemm_row, note)


def q8_tile_checks(torch, tim, xq, sx, w, sw, cb, note, what):
    """KQ8's float entries on its tile (the route must take it) bit-exact
    against matmul_q8_torch, with and without the column bias cb, f32 and
    bf16 out; a repeated call the same bits."""
    (m, k), n = xq.shape, w.shape[1]
    assert tim.q8_tile_route(m, n, k), ("KQ8 tile route", m, k, n)
    for bias in (None, cb):
        for out_dtype in (torch.float32, torch.bfloat16):
            tiles = tim.matmul_q8.routes["tile"]
            got = tim.matmul_q8(xq, sx, w, sw, bias, out_dtype)
            assert tim.matmul_q8.routes["tile"] == tiles + 1
            want = tim.matmul_q8_torch(xq, sx, w, sw, bias, out_dtype)
            note("q8_tile", got, want)
            assert torch.equal(got, want), ("KQ8 tile", what, bias is None,
                                            out_dtype)
            assert torch.equal(tim.matmul_q8(xq, sx, w, sw, bias, out_dtype),
                               got), ("KQ8 tile repeat", what)
    log(f"KQ8 q8_tile at {what} (M={m} K={k} N={n}): bit-exact with and "
        "without col_bias, f32 and bf16 out; repeated calls the same bits")


def q8_tile_row(torch, tim, rows, gemm_row, label, xq, sx, w, sw, out_dtype):
    """KQ8's tile timed at (xq, w) as ``label``, beside the block tile it
    replaces on the same operands (``s8_tile_ms``, with its zeroed split-K
    buffer where it splits)."""
    (m, k), n = xq.shape, w.shape[1]
    gemm_row(label, "q8_tile", m, k, n,
             lambda i: tim.matmul_q8(xq, sx, w, sw, out_dtype=out_dtype),
             lambda i: tim.matmul_q8_torch(xq, sx, w, sw,
                                           out_dtype=out_dtype),
             ["q8_"], m * k + k * n, INT8_OPS, vec_bytes=(m + n) * 4,
             out_bytes=m * n * (2 if out_dtype == torch.bfloat16 else 4))
    rows[label]["s8_tile_ms"], _ = timed(
        lambda i: tim._launch_q8_s8_tile(xq, sx, w, sw, None, out_dtype), 5,
        ["q8_", "FillFunctor"])


def check_w8a8_kernels(torch, tim, g, rows, note, gemm_row):
    """KW8A8 and KQ8 (with and without a column bias, and its int32 entry)
    against their plain versions, bit for bit, at Llama-3-8B prefill shapes
    (M = 4096: K x N of 4096 x 6144 and 4096 x 28672 through KW8A8, 14336 x
    4096 through matmul_w8a8 -> K1 + KQ8) and a ResNet-50 3x3 conv through
    conv2d_w8a8 (batch 32, 28 x 28 x 128 -> 128); then their timings, with
    torch._int_mm (the int8 GEMM alone) beside them."""
    from aimet_tpu_torch.ops import int_conv as tic
    dev = "cuda"

    def operands(m, k, n, dtype=torch.bfloat16):
        x = (torch.randn((m, k), generator=g, device=dev) * 2).to(dtype)
        w = torch.randint(-127, 128, (k, n), dtype=torch.int8, generator=g,
                          device=dev)
        sw = (torch.rand((n,), generator=g, device=dev) + 0.5) * 2e-3
        return x, w, sw

    shapes = ((4096, 4096, 6144), (4096, 4096, 28672), (4096, 14336, 4096))
    tiles = tim.matmul_q8.routes["tile"]
    for m, k, n in shapes:
        for dtype in (torch.bfloat16, torch.float32):
            x, w, sw = operands(m, k, n, dtype)
            got = tim.matmul_w8a8(x, w, sw)
            want = tim.matmul_w8a8_torch(x, w, sw)
            note("w8a8_fusedq", got, want)
            assert got.dtype == dtype and torch.equal(got, want), \
                ("matmul_w8a8", m, k, n, dtype)
            del x, w, got, want
    assert tim.matmul_q8.routes["tile"] == tiles + 2 * len(shapes), \
        "KW8A8 at M=4096 off KQ8's tile"
    log("KW8A8 w8a8_fusedq (K1 + KQ8's tile): matmul_w8a8 bit-exact at "
        f"M=4096 x (K, N) in {[s_[1:] for s_ in shapes]}, bf16 and f32 x")
    m, k, n = 4096, 14336, 4096
    xq = torch.randint(-127, 128, (m, k), dtype=torch.int8, generator=g,
                       device=dev)
    _, w, sw = operands(1, k, n)
    sx = torch.rand((m,), generator=g, device=dev) * 1e-2
    cb = torch.randn((n,), generator=g, device=dev)
    q8_tile_checks(torch, tim, xq, sx, w, sw, cb, note, "w_down")
    got, want = tim.int8_matmul_int32(xq, w), tim.int8_matmul_int32_torch(
        xq, w)
    note("q8_gemm", got, want)
    assert torch.equal(got, want), "KQ8 int32"
    log(f"KQ8 q8_gemm: its int32 entry bit-exact at M={m} K={k} N={n}")
    del xq, got
    # a ResNet-50 3x3 conv (layer2's) through conv2d_w8a8: im2col + K1 + KQ8
    x = torch.randn((32, 128, 28, 28), generator=g, device=dev)
    wq, s_ = tic.quantize_conv_weight_per_channel(
        torch.randn((128, 128, 3, 3), generator=g, device=dev) * 0.03)
    got = tic.conv2d_w8a8(x, wq, s_, (3, 3))
    want = tic._im2col_conv(tim.matmul_w8a8_torch, x, wq, s_, (3, 3),
                            (1, 1), "SAME", None, None)
    note("w8a8_fusedq", got, want)
    assert torch.equal(got, want), "conv2d_w8a8"
    p, _ = tic._patches(x, (3, 3), (1, 1), "SAME")
    pq, psx = tim.quantize_activation_per_row(p)
    assert torch.equal(tim.int8_matmul_int32(pq, wq),
                       tim.int8_matmul_int32_torch(pq, wq)), "KQ8 int32 conv"
    q8_tile_checks(torch, tim, pq, psx, wq, s_, cb[:wq.shape[1]], note,
                   "conv 3x3")
    log("conv2d_w8a8 (32 x 128 x 28 x 28, 3x3 -> 128): im2col + K1 + KQ8 "
        "bit-exact with the plain version; KQ8's int32 entry on its codes "
        "too")

    # the weight-only im2col convs at ResNet-50 conv shapes: KW8 and KW4 at
    # M up to 401,408 and K of 64 to 4608 (not multiples of 4096)
    convs = {"stem 7x7/2": ((32, 3, 224, 224), 64, 7, 2),
             "layer1 1x1": ((32, 64, 56, 56), 256, 1, 1),
             "layer2 3x3": ((32, 128, 28, 28), 128, 3, 1),
             "layer4 3x3": ((32, 512, 7, 7), 512, 3, 1)}
    for name, (quant, conv, mm) in {
            "w8_gemm": (tic.quantize_conv_weight_per_channel, tic.conv2d_w8,
                        tim.matmul_w8_torch),
            "w4_gemm": (tic.quantize_conv_weight_int4, tic.conv2d_w4,
                        tim.matmul_w4_torch)}.items():
        worst = {}
        for tag, (shape, co, k, st) in convs.items():
            if name == "w4_gemm" and shape[1] * k * k % 2:
                continue                    # INT4 packs an even K
            xc = torch.randn(shape, generator=g, device=dev)
            wq_, sc = quant(torch.randn((co, shape[1], k, k), generator=g,
                                        device=dev) * 0.03)
            got_ = conv(xc, wq_, sc, (k, k), strides=(st, st))
            want_ = tic._im2col_conv(mm, xc, wq_, sc, (k, k), (st, st),
                                     "SAME", None, None)
            note(name, got_, want_)
            worst[tag] = rel_err(got_, want_)
            assert got_.shape == want_.shape and worst[tag] < TOL_WO, \
                (name, tag, worst[tag])
            del xc, got_, want_
        log(f"{name} through conv2d_{name[:2]} at ResNet-50 convs (batch "
            f"32): within " + ", ".join(f"{t} {e:.2e}" for t, e in
                                        worst.items())
            + f" of max (< {TOL_WO})")

    def int_mm(label, a, b):
        rows[label]["int_mm_ms"], _ = timed(lambda i: torch._int_mm(a, b), 10)

    for (m, k, n), tag in zip(shapes[:2], ("wqkv", "gate_up")):
        x, w, sw = operands(m, k, n)
        label = f"w8a8_fusedq[{tag}]"
        gemm_row(label, "w8a8_fusedq", m, k, n,
                 lambda i: tim.matmul_w8a8_fusedq(x, w, sw),
                 lambda i: tim.matmul_w8a8_torch(x, w, sw),
                 K1_KERNELS + ["q8_"], m * k * 2 + k * n, INT8_OPS)
        int_mm(label, tim.quantize_activation_per_row(x)[0], w)
        del x, w
    m, k, n = 4096, 14336, 4096
    xq, sx = tim.quantize_activation_per_row(operands(m, k, 1)[0])
    _, w, sw = operands(1, k, n)
    q8_tile_row(torch, tim, rows, gemm_row, "q8_tile[w_down]", xq, sx, w, sw,
                torch.bfloat16)
    int_mm("q8_tile[w_down]", xq, w)
    del xq, w
    # the conv through conv2d_w8a8: K1 + KQ8 on its f32 patch matrix
    M, K = p.shape
    gemm_row("w8a8_fusedq[conv 3x3]", "w8a8_fusedq", M, K, wq.shape[1],
             lambda i: tim.matmul_w8a8_fusedq(p, wq, s_),
             lambda i: tim.matmul_w8a8_torch(p, wq, s_),
             K1_KERNELS + ["q8_"], M * K * 4 + wq.numel(), INT8_OPS,
             out_bytes=M * wq.shape[1] * 4)
    int_mm("w8a8_fusedq[conv 3x3]", pq, wq)
    q8_tile_row(torch, tim, rows, gemm_row, "q8_tile[conv 3x3]", pq, psx, wq,
                s_, torch.float32)
    int_mm("q8_tile[conv 3x3]", pq, wq)
    # the int32 entry at the conv's patch matrix, with the weight K-major
    # as the integer conv passes it (the TMA + wgmma route); torch._int_mm
    # computes the same function, so it is this row's library call; the
    # N-major weight's route (the mma.sync tile) beside it
    wk = wq.t().contiguous().t()     # (K, N), K-major
    label = "q8_gemm[int32, conv 3x3]"
    gemm_row(label, "q8_gemm", pq.shape[0], pq.shape[1], wq.shape[1],
             lambda i: tim.int8_matmul_int32(pq, wk),
             lambda i: tim.int8_matmul_int32_torch(pq, wk), ["q8_"],
             pq.numel() + wq.numel(), INT8_OPS,
             out_bytes=pq.shape[0] * wq.shape[1] * 4, vec_bytes=0)
    rows[label]["library_ms"], _ = timed(lambda i: torch._int_mm(pq, wq), 10)
    wn = wq.contiguous()             # the quantizer's codes are K-major
    rows[label]["nmajor_ms"], _ = timed(
        lambda i: tim.int8_matmul_int32(pq, wn), 20, ["q8_", "FillFunctor"])
    # the same call on the first 128 k of each patch row: one K step, so
    # its 12.8 MB of int32 stores, not the patch reads, set its time
    pk, wk1 = pq[:, :128], wk[:128]
    rows[label]["k128_ms"], _ = timed(
        lambda i: tim.int8_matmul_int32(pk, wk1), 20, ["q8_"])
    del p, pq, got, want


def int32_conv_sweep(torch, tim, shapes):
    """KQ8's int32 entry at every distinct conv shape (M, K, N) of a lowered
    ResNet-50 forward, ``shapes`` -> launches in that forward: the
    operands laid out as the integer conv lays them (patch rows padded to
    16 bytes, the weight K-major), bit-exact against the plain version, and
    timed beside ``torch._int_mm`` (on the same sums: K padded with zeros
    to its multiple of 8) and the plain version. Returns the rows and the
    forward's summed kernel and library ms (launches x ms)."""
    g = torch.Generator(device="cuda").manual_seed(5)
    out, tot_k, tot_l = [], 0.0, 0.0
    for (m, k, n), count in sorted(shapes.items()):
        kp = -(-k // 16) * 16
        xb = torch.randint(-128, 128, (m, kp), dtype=torch.int8,
                           generator=g, device="cuda")
        xb[:, k:] = 0
        wb = torch.zeros((n, kp), dtype=torch.int8, device="cuda")
        wb[:, :k] = torch.randint(-127, 128, (n, k), dtype=torch.int8,
                                  generator=g, device="cuda")
        x, w = xb[:, :k], wb[:, :k].t()
        got = tim.int8_matmul_int32(x, w)
        assert torch.equal(got, tim.int8_matmul_int32_torch(x, w)), \
            ("KQ8 int32 conv shape", m, k, n)
        ms, _ = timed(lambda i: tim.int8_matmul_int32(x, w), 20,
                      ["q8_", "FillFunctor"])
        k8 = -(-k // 8) * 8
        lib, _ = timed(lambda i: torch._int_mm(xb[:, :k8], wb[:, :k8].t()),
                       10)
        pms, _ = timed(lambda i: tim.int8_matmul_int32_torch(x, w), 2,
                       warmup=1)
        b, how = bound_ms(m * k + k * n + m * n * 4, (2 * m * n * k,
                                                       INT8_OPS))
        tot_k += count * ms
        tot_l += count * lib
        out.append(dict(shape=[m, k, n], launches=count, ms=ms,
                        library_ms=lib, plain_ms=pms, bound_ms=b,
                        bound_by=how))
        log(f"  int32 conv {m} x {k} x {n}: {count} launches a forward; "
            f"kernel {ms:.5f} ms, torch._int_mm {lib:.5f}, plain {pms:.4f}, "
            f"bound {b:.5f} ({how}); bit-exact")
        del xb, wb, x, w, got
    log(f"[cnn w8a8] KQ8's int32 entry over the forward's "
        f"{sum(shapes.values())} convs ({len(shapes)} shapes): kernel "
        f"{tot_k:.4f} ms against torch._int_mm's {tot_l:.4f} ms (launches x "
        "ms)")
    return out, tot_k, tot_l


def library_probes(torch, tim, g, rows):
    """The library column of KW8 and KW4G: whether PyTorch's weight-only
    int8 and int4 matmuls (torch._weight_int8pack_mm,
    torch._weight_int4pack_mm) run on this card, and their time at the
    rows' shapes where one computes the row's function (KW4's column:
    kw4_rows, int4pack_ms); then the library column of every such row."""
    dev = "cuda"
    for tag, m in (("decode", 16), ("prefill", 4096)) + tuple(
            (f"decode M={m}", m) for m in W8_DECODE_ROWS):
        k, n = 4096, 28672
        x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
        w = torch.randint(-127, 128, (k, n), dtype=torch.int8, generator=g,
                          device=dev)
        sw = torch.rand((n,), generator=g, device=dev) * 1e-3
        row = rows[f"w8_gemm[{tag}]"]
        try:
            wt = w.t().contiguous()
            got = torch._weight_int8pack_mm(x, wt, sw.to(torch.bfloat16))
            row["library_err"] = rel_err(got, tim.matmul_w8(x, w, sw))
            row["library_ms"], _ = timed(
                lambda i: torch._weight_int8pack_mm(x, wt, sw.to(
                    torch.bfloat16)), 10)
        except Exception as e:          # recorded: the row's library note
            row["library_note"] = f"torch._weight_int8pack_mm: {e}"[:200]
        del x, w
    for tag, m, k, n, xt, _ in W4G_ROWS:
        # tinygemm takes a bf16 x: an f32 x's row is timed on x in bf16
        grp = 128
        x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
        packed, sc = tim.quantize_weight_int4_grouped(
            torch.randn((k, n), generator=g, device=dev) * 0.02, grp)
        row = rows[f"w4_grouped_gemm[{tag}]"]
        if xt == "f32":
            row["library_x"] = "bf16"
        try:
            # tinygemm's layout: (N, K/2) uint8 of (q + 8), even k high,
            # and (K/grp, N, 2) bf16 of (scale, zero): w = (u - 8) * s + z
            u = (tim.unpack_int4(packed).to(torch.int32) + 8).t()
            u8 = ((u[:, ::2] << 4) | u[:, 1::2]).to(torch.uint8)
            wt = torch._convert_weight_to_int4pack(u8.contiguous(), 8)
            sz = torch.stack([sc, torch.zeros_like(sc)], -1).to(
                torch.bfloat16).contiguous()
            got = torch._weight_int4pack_mm(x, wt, grp, sz)
            row["library_err"] = rel_err(
                got, tim.matmul_w4_grouped(x, packed, sc, group_size=grp))
            row["library_ms"], _ = timed(
                lambda i: torch._weight_int4pack_mm(x, wt, grp, sz), 10)
        except Exception as e:
            row["library_note"] = f"torch._weight_int4pack_mm: {e}"[:200]
        del x, packed
    for label in ["w8_gemm[decode]", "w8_gemm[prefill]"] + [
            f"w8_gemm[decode M={m}]" for m in W8_DECODE_ROWS] + [
            kw4_label(m, k, n) for m, k, n in
            KW4_DECODE_SHAPES + KW4_PREFILL_SHAPES] + [
            f"w4_grouped_gemm[{tag}]" for tag, *_ in W4G_ROWS]:
        r = rows[label]
        log(f"  library for {label}: "
            + (f"{r['library_ms']:.4f} ms (within {r['library_err']:.2e} of "
               "the kernel's max)" if "library_ms" in r
               else r.get("library_note", "")))


def split_sweep(torch, tim):
    """The evidence for the K-split policies of KQ8's K-major route and
    KW4G's weight-streaming route: device ms of the C entries called with
    each split count on the same inputs (the policy's choice marked),
    outputs checked against the plain versions. Returns a dict."""
    from aimet_tpu_torch import _build
    g = torch.Generator(device="cuda").manual_seed(9)
    out = {}
    stream = _build.stream_ptr(torch.device("cuda"))
    for m, k, n in ((6272, 2304, 256), (1568, 4608, 512), (200, 4608, 512)):
        x = torch.randint(-128, 128, (m, k), dtype=torch.int8, generator=g,
                          device="cuda")
        w = torch.randint(-127, 128, (n, k), dtype=torch.int8, generator=g,
                          device="cuda")
        ref = tim.int8_matmul_int32_torch(x, w.t())
        res = {}
        policy = tim.q8_kmajor_splits(m, n, k)
        for sp in sorted({1, 2, 3, 4, 6, policy}):
            o = (torch.zeros if sp > 1 else torch.empty)(
                (m, n), dtype=torch.int32, device="cuda")

            def call(i, o=o, sp=sp):
                if sp > 1:
                    o.zero_()
                _build.launch("aimet_q8_int32_kmajor", x.data_ptr(), k,
                              w.data_ptr(), k, o.data_ptr(), m, n, k, sp,
                              stream)
            call(0)
            assert torch.equal(o, ref), ("KQ8 split", m, k, n, sp)
            res[sp], _ = timed(call, 20, ["q8_", "FillFunctor"])
        out[f"q8_int32 {m}x{k}x{n}"] = dict(ms=res, policy=policy)
    k, n = 4096, 14336
    for m in (16, 32, 64):
        x = torch.randn((m, k), generator=g, device="cuda").to(torch.bfloat16)
        wp, sc = tim.quantize_weight_int4_grouped(
            torch.randn((k, n), generator=g, device="cuda") * 0.02, 128)
        want = tim.matmul_w4_grouped_torch(x, wp, sc, 128)
        res = {}
        for sp in (1, 2, 3, 4, 6):
            o = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")
            ws = torch.empty((sp, m, n), dtype=torch.float32, device="cuda")

            def call(i, o=o, ws=ws, sp=sp):
                _build.launch("aimet_w4g_gemm", x.data_ptr(), wp.data_ptr(),
                              sc.data_ptr(), o.data_ptr(), ws.data_ptr(), m,
                              n, k, 128, sp, 0, 1, 1, stream)
            call(0)
            assert rel_err(o, want) < TOL_WO, ("KW4G split", m, sp)
            res[sp], _ = timed(call, 20, ["w4g_decode", "wo_reduce"])
        out[f"w4g_decode M={m} {k}x{n}"] = dict(
            ms=res, policy=tim.w4g_decode_splits(m, n, k))
    for label, r in out.items():
        log(f"  splits {label}: " + ", ".join(
            f"{sp}{'*' if sp == r['policy'] else ''} {ms:.5f}"
            for sp, ms in r["ms"].items()) + " ms (* the policy's)")
    return out


@contextlib.contextmanager
def plain_versions(qllm, ops):
    """Route the serving path through the plain versions (comparison only:
    the package itself always launches the kernels on the card)."""
    tim, dattn, flay, dsol, _ = ops
    saved = (dict(qllm._MATMUL), qllm.fused_decode_attention,
             qllm.fused_wo_mlp, qllm.sol_decode_layer)
    qllm._MATMUL.update(w8=tim.matmul_w8_torch, w4=tim.matmul_w4_torch,
                        w4a8=tim.matmul_w4a8_torch)
    qllm.fused_decode_attention = dattn.fused_decode_attention_torch
    qllm.fused_wo_mlp = flay.fused_wo_mlp_torch
    qllm.sol_decode_layer = dsol.sol_decode_layer_torch
    try:
        yield
    finally:
        qllm._MATMUL.update(saved[0])
        (qllm.fused_decode_attention, qllm.fused_wo_mlp,
         qllm.sol_decode_layer) = saved[1:]


def run_batcher(torch, llm, cfg, g):
    """32 requests (prompts of 32-256 tokens, 16-64 new tokens, drawn from
    ``g``) through the continuous batcher (16 slots, chunk 4), every one
    finished with its tokens in the vocabulary. Returns (generated tok/s
    on the host clock, seconds, engine steps, generated tokens)."""
    from aimet_tpu_torch.serving.batcher import ContinuousBatcher
    batcher = ContinuousBatcher(llm, num_slots=16, step_chunk=4)
    draw = lambda lo, hi, n: torch.randint(lo, hi, (n,), generator=g,
                                           device="cuda").tolist()
    lens, news = draw(32, 257, 32), draw(16, 65, 32)
    reqs = [batcher.submit(draw(0, cfg.vocab_size, n), max_new_tokens=m)
            for n, m in zip(lens, news)]
    torch.cuda.synchronize()
    t0 = time.time()
    steps = batcher.run_until_done(max_steps=1000)
    dt = time.time() - t0
    assert all(r.done for r in reqs), "batcher left requests unfinished"
    assert [len(r.generated) for r in reqs] == news
    assert all(0 <= t < cfg.vocab_size for r in reqs for t in r.generated)
    return sum(news) / dt, dt, steps, sum(news)


def replay_check(torch, b, counters):
    """One chunk of the pipelined batcher ``b``'s device carry run eagerly
    on copies of its carry and slot caches, then one replay of its chunk
    graph on the originals: the tokens, the carry and every cache byte
    must be equal. Returns the eager chunk's launches by kernel: what one
    replay launches (a replay does not pass through the wrappers, so
    their counts do not see it)."""
    import dataclasses
    tok, pos, out, _ = b._carry
    caches = [dataclasses.replace(c, k=c.k.clone(), v=c.v.clone())
              for c in b.caches]
    want_tok, want_pos, want = tok.clone(), pos.clone(), torch.empty_like(out)
    before = {k: fn.launches for k, fn in counters.items()}
    b._chunk_steps(want_tok, want_pos, want, caches)
    per_chunk = {k: fn.launches - before[k] for k, fn in counters.items()
                 if fn.launches != before[k]}
    b._chunk_carry()
    torch.cuda.synchronize()
    assert torch.equal(out, want), "replayed chunk: tokens differ"
    assert torch.equal(tok, want_tok) and torch.equal(pos, want_pos), \
        "replayed chunk: carry differs"
    for i, (c, w) in enumerate(zip(b.caches, caches)):
        assert torch.equal(c.k, w.k) and torch.equal(c.v, w.v), \
            f"replayed chunk: layer {i}'s cache bytes differ"
    return per_chunk


def engine_pair(torch, llm, cfg, mode, counters, g):
    """``run_batcher``'s 32 requests (drawn from ``g`` as it draws them)
    through both engines, each on a fresh ``ContinuousBatcher`` (16 slots,
    chunk 4, the C++ scheduler): ``run_until_done`` (the step engine), then
    ``run_pipelined`` (its graphs captured by ``warm_admission`` just
    before the timed run: one admission graph a padded prompt length of
    the workload, and the chunk's). Every request must get the same
    tokens from both.
    Then a chunk of the pipelined batcher's carry eagerly on copies and as
    a replay (``replay_check``), and 4 chunks profiled each way: device ms
    and busy share, graph against eager. Returns metrics."""
    from aimet_tpu_torch.serving.batcher import ContinuousBatcher
    draw = lambda lo, hi, n: torch.randint(lo, hi, (n,), generator=g,
                                           device="cuda").tolist()
    lens, news = draw(32, 257, 32), draw(16, 65, 32)
    prompts = [draw(0, cfg.vocab_size, n) for n in lens]
    out, tokens = {}, {}
    for engine in ("step", "pipelined"):
        b = ContinuousBatcher(llm, num_slots=16, step_chunk=4)
        if engine == "pipelined":
            # the graphs are captured before the timed run, as a server
            # warms its shape buckets: one admission graph a padded prompt
            # length of the workload, and the chunk's
            t0 = time.time()
            for n in sorted({b._padded_len(len(p)) for p in prompts}):
                b.warm_admission(wave_sizes=(1,), prompt_len=n,
                                 pipelined=True)
            out["cb_capture_s"] = time.time() - t0
            warm = (b.chunk_replays, b.admission_replays)
        reqs = [b.submit(p, max_new_tokens=m) for p, m in zip(prompts, news)]
        torch.cuda.synchronize()
        t0 = time.time()
        steps = (b.run_pipelined(max_steps=1000) if engine == "pipelined"
                 else b.run_until_done(max_steps=1000))
        torch.cuda.synchronize()
        dt = time.time() - t0
        assert all(r.done for r in reqs), f"{engine} engine left requests"
        assert [len(r.generated) for r in reqs] == news
        assert all(0 <= t < cfg.vocab_size for r in reqs for t in r.generated)
        tokens[engine] = [r.generated for r in reqs]
        out.update({f"cb_{engine}_tok_s": sum(news) / dt,
                    f"cb_{engine}_s": dt, f"cb_{engine}_steps": steps})
        log(f"[{mode}] continuous batcher, {engine} engine: 32 requests, "
            f"{sum(news)} tokens in {dt:.3f} s ({sum(news) / dt:.1f} tok/s), "
            f"{steps} chunks" + (
                f", {b.chunk_replays - warm[0]} chunk and "
                f"{b.admission_replays - warm[1]} admission graph replays "
                f"({len(b._admit_graphs)} admission graphs and the chunk's, "
                f"captured in {out['cb_capture_s']:.2f} s before)"
                if engine == "pipelined" else ""))
    differ = [i for i, (a, c) in enumerate(zip(tokens["step"],
                                                tokens["pipelined"]))
              if a != c]
    assert not differ, (f"[{mode}] the engines' tokens differ for requests "
                        f"{differ}")
    out["cb_tok_s"] = out["cb_step_tok_s"]
    per_chunk = replay_check(torch, b, counters)
    tok, pos, buf, _ = b._carry
    for label, fn in (("graph", b._chunk_carry),
                      ("eager", lambda: b._chunk_steps(tok, pos, buf))):
        fn()
        wall, busy, dev, by_name = profile_steps(torch, fn)
        out.update({f"chunk_{label}_ms": wall, f"chunk_{label}_busy": busy,
                    f"chunk_{label}_device_ms": dev})
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
        log(f"[{mode}] one chunk (4 steps, 16 slots), {label}: {wall:.3f} "
            f"ms on the host clock, {dev:.3f} device ms (profiler), busy "
            f"{busy:.3f}; by kernel: "
            + ", ".join(f"{k} {v:.3f}" for k, v in top))
    # a replay is one launch: CUDA events around it time the graph alone
    out["chunk_graph_event_ms"], _ = event_ms(lambda i: b._chunk_carry(), 4)
    log(f"[{mode}] one chunk graph between CUDA events: "
        f"{out['chunk_graph_event_ms']:.3f} ms")
    out["cb_chunk_replays"] = b.chunk_replays
    out["cb_admission_replays"] = b.admission_replays
    out["chunk_launches"] = per_chunk
    log(f"[{mode}] every request's tokens equal in both engines; a replayed "
        f"chunk equals the eager one (tokens, carry, cache bytes); "
        f"{b.chunk_replays} chunk replays x {per_chunk} launches a chunk "
        f"and {b.admission_replays} admission replays ran inside graphs "
        "(not in the wrappers' counts)")
    return out


def cb_bench(torch, qllm, qw, cfg, counters):
    """``bench_llama8b.continuous_batching``'s workload on the port: 48
    requests (numpy seed 0: prompts of 32 tokens, 32-128 new tokens), 16
    slots, chunk 8, max_len 192, ``w4a8``, the C++ scheduler, through
    ``warm_admission(prompt_len=32, pipelined=True)`` and
    ``run_pipelined``; every request finished at its length. Returns
    (metrics, launches)."""
    import numpy as np
    from aimet_tpu_torch.serving.batcher import ContinuousBatcher
    zero_counts(counters)
    llm = qllm.QuantizedLLM.from_quantized(qw, cfg, mode="w4a8", max_len=192)
    b = ContinuousBatcher(llm, num_slots=16, step_chunk=8)
    rng = np.random.RandomState(0)
    lens = rng.randint(32, 129, 48)
    reqs = [b.submit(list(rng.randint(0, cfg.vocab_size, 32)),
                     max_new_tokens=int(n)) for n in lens]
    t0 = time.time()
    b.warm_admission(prompt_len=32, pipelined=True)
    warm_s = time.time() - t0
    t0 = time.perf_counter()
    steps = b.run_pipelined(max_steps=4000)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    assert all(r.done for r in reqs), "the bench workload did not drain"
    assert [len(r.generated) for r in reqs] == [int(n) for n in lens]
    toks = sum(len(r.generated) for r in reqs)
    util = toks / max(steps * 8 * 16, 1)
    per_chunk = replay_check(torch, b, counters)
    launches = {k: fn.launches for k, fn in counters.items() if fn.launches}
    take_routes(counters)
    log(f"[w4a8 bench workload] 48 requests, 16 slots, chunk 8: {toks} "
        f"tokens in {dt:.3f} s ({toks / dt:.1f} tok/s), {steps} chunks, "
        f"{b.chunk_replays} chunk and {b.admission_replays} admission "
        f"replays, slot use {util:.3f}; warm_admission "
        f"{warm_s:.2f} s; launches outside graphs {launches}; a chunk "
        f"launches {per_chunk}")
    return dict(bench_cb_tok_s=toks / dt, bench_cb_s=dt, bench_cb_steps=steps,
                bench_cb_slot_util=util, bench_cb_warm_s=warm_s,
                bench_cb_chunk_replays=b.chunk_replays,
                bench_cb_admission_replays=b.admission_replays), launches


def cache_free_forward(torch, qllm, qw, cfg, counters, g):
    """A cache-free forward of 1 x 512 tokens in ``w4a8`` (causal over the
    tokens, no KV cache): finite logits of the right shape, no caches
    back, its launches; beside the prefill of the same tokens into INT8
    caches (they differ by the cache's quantization). Returns (metrics,
    launches)."""
    toks = torch.randint(0, cfg.vocab_size, (1, 512), generator=g,
                         device="cuda")
    zero_counts(counters)
    t0 = time.time()
    logits, none = qllm.quantized_forward(qw, cfg, toks, mode="w4a8")
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = {k: fn.launches for k, fn in counters.items() if fn.launches}
    take_routes(counters)
    assert none is None and logits.shape == (1, 512, cfg.vocab_size)
    assert torch.isfinite(logits).all(), "cache-free logits not finite"
    llm = qllm.QuantizedLLM.from_quantized(qw, cfg, mode="w4a8", max_len=512)
    ref, _ = llm.prefill(toks, llm.new_caches(1))
    err = rel_err(logits, ref)
    top1 = (logits.argmax(-1) == ref.argmax(-1)).float().mean().item()
    log(f"[w4a8 cache-free forward] 1 x 512: {dt * 1e3:.1f} ms; launches "
        f"{launches}; against the prefill into INT8 caches: {err:.3e} of "
        f"the max, top-1 agreement {top1:.3f}")
    return dict(cache_free_s=dt, cache_free_vs_prefill=err,
                cache_free_top1=top1), launches


def serve(torch, llm, cfg, mode, counters, g, decode_batches):
    """Phase 3 for one mode: its main path with the counts set to 0 just
    before and read just after. Returns (metrics, launches)."""
    zero_counts(counters)
    counts = lambda: {k: fn.launches for k, fn in counters.items()}
    diff = lambda a, b: {k: b[k] - a[k] for k in a if b[k] != a[k]}
    metrics = {}

    def prefill(b, t_len):
        toks = torch.randint(0, cfg.vocab_size, (b, t_len), generator=g,
                             device="cuda")
        caches = llm.new_caches(b)
        torch.cuda.synchronize()
        t0 = time.time()
        logits, caches = llm.prefill(toks, caches)
        torch.cuda.synchronize()
        dt = time.time() - t0
        assert logits.shape == (b, t_len, cfg.vocab_size)
        assert torch.isfinite(logits).all(), "prefill logits not finite"
        return logits, caches, dt

    _, _, dt = prefill(8, 512)              # first call: allocator warm-up
    c0 = counts()
    _, _, dt = prefill(8, 512)
    metrics["prefill_8x512_s"] = dt
    metrics["prefill_tok_s"] = 8 * 512 / dt
    log(f"[{mode}] prefill 8x512: {dt * 1e3:.1f} ms, {8 * 512 / dt:.0f} "
        f"tok/s; launches per prefill {diff(c0, counts())}")

    for b in decode_batches:
        logits, caches, _ = prefill(b, 512)
        tok = logits[:, -1].argmax(-1)[:, None]
        del logits
        pos = 512
        for rep in range(2):             # twice: the spread of the host clock
            logits, caches = llm.decode(tok, caches, pos)    # warm-up step
            tok = logits[:, -1].argmax(-1)[:, None]
            pos += 1
            c0 = counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(32):
                logits, caches = llm.decode(tok, caches, pos)
                tok = logits[:, -1].argmax(-1)[:, None]
                pos += 1
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            per_step = {k: v / 32 for k, v in diff(c0, counts()).items()}
            assert torch.isfinite(logits).all(), "decode logits not finite"
            assert logits.shape == (b, 1, cfg.vocab_size)
            metrics[f"decode_b{b}_ms_step"] = dt / 32 * 1e3
            metrics[f"decode_b{b}_tok_s"] = b * 32 / dt
            log(f"[{mode}] decode batch {b} (run {rep}): "
                f"{dt / 32 * 1e3:.2f} ms/step, {b * 32 / dt:.0f} tok/s; "
                f"launches per step (scalar position) {per_step}")
        if b == decode_batches[0]:
            # one step at per-slot positions (the batcher's decode)
            slots = torch.arange(b, device="cuda", dtype=torch.int32) + pos
            c0 = counts()
            logits, caches = llm.decode(tok, caches, slots)
            assert torch.isfinite(logits).all(), "per-slot logits"
            step = diff(c0, counts())
            log(f"[{mode}] launches per step at per-slot positions {step}")
            if mode == "w4a8":
                # four projections a layer and the lm_head, each one fused
                # launch at decode M: K1 never runs in the step
                assert step.get("act_quant", 0) == 0 and \
                    step.get("w4a8_fusedq") == 4 * cfg.n_layers + 1, step
            # where a decode step's time goes: device busy share and the
            # device time of each kernel, over 4 profiled steps at a scalar
            # position, then 4 at per-slot positions
            state = [tok, caches, pos]

            def step():
                logits, state[1] = llm.decode(state[0], state[1], state[2])
                state[0] = logits[:, -1].argmax(-1)[:, None]
                state[2] += 1
            wall, busy, dev, by_name = profile_steps(torch, step)
            tok, caches, pos = state
            metrics[f"decode_b{b}_device_ms_step"] = dev
            metrics[f"decode_b{b}_device_busy"] = busy
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
            log(f"[{mode}] decode batch {b} profile: {wall:.2f} "
                f"ms/step on the host clock, device busy {busy:.3f}; device "
                "ms/step by kernel: "
                + ", ".join(f"{k} {v:.3f}" for k, v in top))
            tok, caches, _ = slot_step_profile(
                torch, llm, mode, tok, caches,
                torch.arange(b, device="cuda", dtype=torch.int32) + pos,
                metrics, b)
        del caches, logits

    metrics.update(engine_pair(torch, llm, cfg, mode, counters, g))
    launches = counts()
    take_routes(counters)
    log(f"[{mode}] main-path launches: {launches}")
    for name in PATH_KERNELS[mode]:
        assert launches[name] > 0, \
            f"kernel {name} never launched on the {mode} main path"
    return metrics, launches


def compare_whole_model(torch, qllm, ops, qw, cfg, mode, g, n_layers):
    """Phase 4: one prefill, one decode step at a scalar position and one at
    per-slot positions of the first ``n_layers`` layers, through the
    kernels and through the plain versions."""
    import dataclasses
    cfg = dataclasses.replace(cfg, n_layers=n_layers)
    llm = qllm.QuantizedLLM.from_quantized(
        dict(qw, layers=qw["layers"][:n_layers]), cfg, mode=mode,
        max_len=1024)
    # both runs decode the same tokens: feeding each run its own argmax
    # would compare different inputs wherever a near tie flips the top-1
    toks = torch.randint(0, cfg.vocab_size, (2, 130), generator=g,
                         device="cuda")

    def run():
        caches = llm.new_caches(2)
        pl, caches = llm.prefill(toks[:, :128], caches)
        ds, caches = llm.decode(toks[:, 128:129], caches, 128)
        dp, _ = llm.decode(toks[:, 129:], caches,
                           torch.tensor([129, 129], device="cuda"))
        return pl, ds, dp

    kern = run()
    with plain_versions(qllm, ops):
        plain = run()
    out = {}
    for name, k, p in zip(("prefill", "decode", "decode_per_slot"), kern,
                          plain):
        out[f"{name}_logits_rel_err"] = rel_err(k, p)
        out[f"{name}_top1_agreement"] = \
            (k.argmax(-1) == p.argmax(-1)).float().mean().item()
    log(f"[{mode}] whole model ({n_layers} layers), kernels vs plain "
        "versions: " + ", ".join(f"{k} {v:.3e}" for k, v in out.items())
        + f" (errors < {TOL_LOGITS})")
    for name in ("prefill", "decode", "decode_per_slot"):
        assert out[f"{name}_logits_rel_err"] < TOL_LOGITS, (mode, name)
    return out


def decode_step_path(torch, qllm, ops, qw, cfg, counters, g):
    """Phase 3b: the JAX sweep's decode step (``build_step`` of
    scripts/sweep_r5_merged.py:29-83, without its block-size sweep) on the
    port: a 512-token prefill of batch 16 through ``quantized_forward``
    (w4), then 8 decode steps in which layer 0's QKV and the ``lm_head``
    go through ``matmul_w4`` (KW4) and every layer is one
    ``fused_decode_layer`` (KDL) on flat cache views with the concatenated
    ``w_gateup`` and ``up_block_offset``. Held against the same 8 steps of
    ``quantized_forward(mode="w4")`` at a shared position (KSOL), each run
    on its own copy of the prefilled caches, both fed the same drawn
    tokens. Returns (metrics, launches of the 8 steps, the oracle's caches,
    the last position written)."""
    tim, _, flay, _, _ = ops
    from aimet_tpu_torch.models.transformer import rope_freqs
    B, P, steps = 16, 512, 8
    H, KH, F, eps = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.norm_eps
    layers = qw["layers"]
    llm = qllm.QuantizedLLM.from_quantized(qw, cfg, mode="w4", max_len=1024)
    toks = torch.randint(0, cfg.vocab_size, (B, P + steps), generator=g,
                         device="cuda")
    caches = llm.new_caches(B)
    llm.prefill(toks[:, :P], caches)
    flat = [(c.k.clone().view(B, c.k.shape[1], -1),
             c.v.clone().view(B, c.v.shape[1], -1), c.k_scale, c.v_scale)
            for c in caches]

    def step(tokens, pos):
        """One decode step of build_step: tokens (B, 1) -> f32 logits."""
        x = qw["embed"][tokens].to(cfg.dtype)                 # (B, 1, Dm)
        cos, sin = rope_freqs(cfg, torch.full((1,), pos, device="cuda"))
        xn0 = qllm._rms_norm(x, layers[0]["attn_norm"], eps)
        qkv = tim.matmul_w4(xn0.reshape(B, -1), *layers[0]["wqkv"])
        x = x.reshape(B, -1)
        for i, (layer, (k, v, ks, vs)) in enumerate(zip(layers, flat)):
            wgu, sgu = layer["w_gateup"]
            nxt = (None if i + 1 == len(layers)
                   else (layers[i + 1]["wqkv"], layers[i + 1]["attn_norm"]))
            res = flay.fused_decode_layer(
                qkv, x, k, v, ks, vs, pos, cos, sin, layer["wo"],
                (wgu, sgu[:F]), (wgu, sgu[F:]), layer["w_down"],
                layer["mlp_norm"], eps=eps, block_g=1024,
                up_block_offset=F // 1024, n_f=F, next_qkv=nxt, n_heads=H,
                n_kv_heads=KH)
            x, qkv = res[0], (res[1] if nxt is not None else None)
        x = qllm._rms_norm(x[:, None], qw["final_norm"], eps)
        logits = tim.matmul_w4(x.reshape(B, -1), *qw["lm_head"])
        return logits[:, :cfg.vocab_size].to(torch.float32)

    def run(fn):
        """8 steps of fn(tokens, pos) -> logits, on the host clock."""
        out = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(steps):
            out.append(fn(toks[:, P + i:P + i + 1], P + i))
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) / steps * 1e3

    # warm-up: step 0 once on each side (it writes the same rows again)
    step(toks[:, P:P + 1], P)
    llm.decode(toks[:, P:P + 1], caches, P)
    zero_counts(counters)
    kdl, host_ms = run(step)
    launches = {k: fn.launches for k, fn in counters.items() if fn.launches}
    take_routes(counters)
    per_step = {k: v / steps for k, v in launches.items()}
    ref, ref_host_ms = run(lambda t, p: llm.decode(t, caches, p)[0][:, 0])
    kv_equal = all(torch.equal(k, c.k.view(k.shape))
                   and torch.equal(v, c.v.view(v.shape))
                   for (k, v, _, _), c in zip(flat, caches))
    err = max(rel_err(a, b) for a, b in zip(kdl, ref))
    same = all(torch.equal(a, b) for a, b in zip(kdl, ref))
    top1 = torch.stack([(a.argmax(-1) == b.argmax(-1)).float().mean()
                        for a, b in zip(kdl, ref)]).mean().item()
    assert all(torch.isfinite(a).all() for a in kdl), "KDL logits"
    assert kdl[0].shape == (B, cfg.vocab_size)
    assert kv_equal, "KDL step: KV bytes differ from quantized_forward's"
    assert err < TOL_LOGITS, ("KDL step logits", err)
    assert per_step == {"fused_decode_layer": cfg.n_layers, "w4_gemm": 2}, \
        per_step
    # device time: 4 more steps under the profiler
    with profiled() as prof:
        t0 = time.perf_counter()
        for i in range(4):
            step(toks[:, -1:], P + steps + i)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / 4 * 1e3
    dev_ms = sum(e.time_range.elapsed_us()
                 for e in _kernel_events(prof)) / 4e3
    m = {"decode_step_b16_host_ms": host_ms,
         "decode_step_b16_device_ms": dev_ms,
         "decode_step_b16_device_busy": dev_ms / wall,
         "decode_step_b16_oracle_host_ms": ref_host_ms,
         "decode_step_logits_rel_err": err,
         "decode_step_logits_identical": same,
         "decode_step_kv_identical": kv_equal,
         "decode_step_top1_agreement": top1,
         "decode_step_launches_per_step": per_step}
    log(f"[decode step] Llama-3-8B w4, {cfg.n_layers} layers, batch {B}, "
        f"prefill {P}: {host_ms:.2f} ms/step on the host clock (the "
        f"quantized_forward oracle {ref_host_ms:.2f}), {dev_ms:.3f} device "
        f"ms/step (busy {dev_ms / wall:.3f}, profiled); launches per step "
        f"{per_step}; against quantized_forward(mode='w4') over {steps} "
        f"steps: KV bytes identical {kv_equal}, logits identical {same} "
        f"(max rel err {err:.3e} < {TOL_LOGITS}, top-1 {top1:.3f})")
    del flat, llm
    return m, launches, caches, P + steps - 1


def gqa_on_serving_caches(torch, ops, cfg, caches, last, counters, g):
    """Phase 3c: KGQA at Llama-3-8B decode shapes (B 16, KH 8, rep 4, D 128)
    on the int8 caches the w4 serving path wrote (S 1024; a middle layer),
    at the position after their last step, with a bf16 and an f32 q:
    against its plain version, and against K3's context for the same roped
    q on the same caches after K3's append there. Returns (metrics,
    launches of the two KGQA calls)."""
    _, dattn, _, _, gqa = ops
    from aimet_tpu_torch.models.transformer import apply_rope, rope_freqs
    H, KH, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    c = caches[len(caches) // 2]
    B, S = c.k.shape[:2]
    pos = last + 1
    qkv = torch.randn((B, (H + 2 * KH) * D), generator=g,
                      device="cuda").to(torch.bfloat16)
    cos, sin = rope_freqs(cfg, torch.tensor([pos], device="cuda"))
    ctx3, _, _ = dattn.fused_decode_attention(
        qkv, cos, sin, c.k, c.v, c.k_scale, c.v_scale, pos, n_heads=H,
        n_kv_heads=KH)
    q = apply_rope(qkv[:, :H * D].reshape(B, 1, H, D), cos, sin)
    q = q.reshape(B, KH, H // KH, D)                   # f32, as K3 ropes
    ctx3 = ctx3.reshape(q.shape)
    zero_counts(counters)
    m, outs = {}, {}
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        got, _, err = check_gqa(torch, gqa, q.to(dtype), c.k, c.v,
                                c.k_scale, c.v_scale, pos)
        outs[tag] = (got, err)
    launches = {k: fn.launches for k, fn in counters.items() if fn.launches}
    take_routes(counters)
    for tag, (got, err) in outs.items():
        e3 = rel_err(got, ctx3)
        tol = TOL_GQA_K3_F32 if tag == "f32" else TOL_ATTN
        assert torch.isfinite(got).all() and e3 < tol, ("KGQA vs K3", tag,
                                                        e3)
        m[f"gqa_serving_{tag}_vs_plain_rel_err"] = err
        m[f"gqa_serving_{tag}_vs_k3_rel_err"] = e3
        log(f"[gqa] KGQA on the w4 serving caches (B={B}, S={S}, position "
            f"{pos}), {tag} q: within {err:.3e} of its plain version's max, "
            f"{e3:.3e} of K3's context (< {tol}); launches {launches}")
    return m, launches


def long_cache_path(torch, qllm, ops, cfg, counters, g):
    """Phase 3d: one decode step at a cache length whose score rows do not
    fit in shared memory (S 16,384, position 16,000): ``QuantizedLLM`` at
    Llama-3-8B width, heads and vocabulary with 2 layers in w4, its caches
    filled with seeded int8 bytes and scales (no 16k prefill), decoded at a
    shared position (KSOL) and at per-slot positions (K3 + KFL), each
    against the same step through the plain versions on copies of the
    caches (logits within 5e-2 of the max, every cache row but the
    appended ones unchanged); then, on identical inputs with cache bytes
    bit-exact, layer 1 through ``fused_decode_layer`` (KDL, flat caches)
    against KSOL's bits and its plain version, and K3 against its plain
    version; KGQA on layer 0's caches (bf16 and f32 q) against its plain
    version. Returns (metrics, launches)."""
    import dataclasses
    tim, dattn, flay, dsol, gqa = ops
    from aimet_tpu_torch.models.transformer import rope_freqs
    S, pos, B = 16384, 16000, 16
    c2 = dataclasses.replace(cfg, n_layers=2)
    H, KH, D, F = c2.n_heads, c2.n_kv_heads, c2.head_dim, c2.d_ff
    qw = qllm.random_quantized_weights(c2, mode="w4", seed=6)
    llm = qllm.QuantizedLLM.from_quantized(qw, c2, mode="w4", max_len=S)
    caches = llm.new_caches(B)
    for c in caches:
        for t in (c.k, c.v):
            t.copy_(torch.randint(-127, 128, t.shape, dtype=torch.int8,
                                  generator=g, device="cuda"))
        for t in (c.k_scale, c.v_scale):
            t.copy_(torch.rand(t.shape, generator=g, device="cuda") * 0.05
                    + 0.01)
    copy = lambda cs: [dataclasses.replace(c, k=c.k.clone(), v=c.v.clone())
                       for c in cs]
    tok = torch.randint(0, c2.vocab_size, (B, 1), generator=g,
                        device="cuda")
    slots = pos - torch.arange(B, device="cuda", dtype=torch.int32) * 97
    zero_counts(counters)
    m = {}
    rows = torch.arange(B, device="cuda")
    for tag, where in (("ksol", pos), ("k3_kfl", slots)):
        ca, cb = copy(caches), copy(caches)
        got = llm.decode(tok, ca, where)[0]
        with plain_versions(qllm, ops):
            want = llm.decode(tok, cb, where)[0]
        torch.cuda.synchronize()
        # every row but the one each slot appended stays as it was; the
        # appended rows come from each path's own (kernel or plain) qkv,
        # so they are compared by code distance, not bit for bit
        at = torch.as_tensor(where, device="cuda").long().expand(B)
        code_diff = 0
        for c0, a, b in zip(caches, ca, cb):
            for t0, ta, tb in ((c0.k, a.k, b.k), (c0.v, a.v, b.v)):
                new_a, new_b = ta[rows, at].clone(), tb[rows, at].clone()
                ta[rows, at], tb[rows, at] = t0[rows, at], t0[rows, at]
                assert torch.equal(ta, t0) and torch.equal(tb, t0), \
                    ("long cache: rows not written changed", tag)
                code_diff = max(code_diff, (new_a.int() - new_b.int())
                                .abs().max().item())
        err = rel_err(got, want)
        assert torch.isfinite(got).all() and got.shape == want.shape
        assert err < TOL_LOGITS, ("long cache logits", tag, err)
        m[f"long_cache_{tag}_logits_rel_err"] = err
        m[f"long_cache_{tag}_appended_code_diff"] = code_diff
        where_s = (f"position {pos} (KSOL)" if tag == "ksol" else
                   f"per-slot positions {int(slots[-1])}..{pos} (K3 + KFL)")
        log(f"[long cache] QuantizedLLM w4, Llama-3-8B width, 2 layers, B="
            f"{B}, max_len {S}, decode at {where_s}: rows not written "
            f"unchanged, "
            f"appended rows within {code_diff} codes of the plain run's, "
            f"logits within {err:.3e} of the max (< {TOL_LOGITS})")
        del ca, cb
    # layer 1 alone: KDL on flat views against KSOL and the plain version
    layer = qw["layers"][1]
    cos, sin = rope_freqs(c2, torch.full((1,), pos, device="cuda"))
    qkv = torch.randn((B, (H + 2 * KH) * D), generator=g,
                      device="cuda").to(torch.bfloat16)
    resid = torch.randn((B, c2.d_model), generator=g, device="cuda").to(
        torch.bfloat16)
    c = caches[1]
    kv3 = [(c.k.clone(), c.v.clone()) for _ in range(3)]
    wgu, sgu = layer["w_gateup"]
    blk = (layer["wo"], (wgu, sgu[:F]), (wgu, sgu[F:]), layer["w_down"],
           layer["mlp_norm"])
    kdl_kw = dict(eps=c2.norm_eps, block_g=1024, up_block_offset=F // 1024,
                  n_f=F, n_heads=H, n_kv_heads=KH)
    flat = lambda t: t.view(B, S, KH * D)
    kdl = flay.fused_decode_layer(qkv, resid, flat(kv3[0][0]),
                                  flat(kv3[0][1]), c.k_scale, c.v_scale, pos,
                                  cos, sin, *blk, **kdl_kw)[0]
    plain = flay.fused_decode_layer_torch(
        qkv, resid, flat(kv3[1][0]), flat(kv3[1][1]), c.k_scale, c.v_scale,
        pos, cos, sin, *blk, **kdl_kw)[0]
    sol = dsol.sol_decode_layer(
        qkv, resid, kv3[2][0], kv3[2][1], c.k_scale, c.v_scale, pos, cos,
        sin, layer["wo"], layer["w_gateup"], layer["w_down"],
        layer["mlp_norm"], eps=c2.norm_eps, n_heads=H, n_kv_heads=KH)[0]
    torch.cuda.synchronize()
    assert all(torch.equal(kv3[0][i], kv3[j][i]) for i in (0, 1)
               for j in (1, 2)), "long cache KDL cache bytes"
    assert torch.equal(kdl, sol), "long cache: KDL against KSOL"
    err = rel_err(kdl, plain)
    assert err < TOL_ATTN, ("long cache KDL", err)
    m["long_cache_kdl_rel_err"] = err
    log(f"[long cache] KDL fused_decode_layer (layer 1, flat caches, S={S}, "
        f"position {pos}): KSOL's bits and cache bytes, within {err:.3e} of "
        f"its plain version's max (< {TOL_ATTN})")
    # KGQA on layer 0's caches after the steps above
    c = caches[0]
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.randn((B, KH, H // KH, D), generator=g,
                        device="cuda").to(dtype)
        _, _, err = check_gqa(torch, gqa, q, c.k, c.v, c.k_scale, c.v_scale,
                              pos)
        worst = max(worst, err)
    m["long_cache_gqa_rel_err"] = worst
    launches = {k: fn.launches for k, fn in counters.items() if fn.launches}
    take_routes(counters)
    log(f"[long cache] KGQA at S={S}, position {pos}: within {worst:.3e} of "
        f"its plain version's max (f32 q < {TOL_GQA_F32}, bf16 q one bf16 "
        f"ulp a prob); launches {launches}")
    # K3 alone on identical inputs: cache bytes bit-exact
    a = [qkv, cos.expand(B, -1), sin.expand(B, -1), kv3[0][0], kv3[0][1],
         c.k_scale, c.v_scale, slots]
    b_ = [t.clone() for t in a]
    out3 = dattn.fused_decode_attention(*a, n_heads=H, n_kv_heads=KH)[0]
    ref3 = dattn.fused_decode_attention_torch(*b_, n_heads=H,
                                              n_kv_heads=KH)[0]
    torch.cuda.synchronize()
    assert torch.equal(a[3], b_[3]) and torch.equal(a[4], b_[4]), \
        "long cache K3 cache bytes"
    err = rel_err(out3, ref3)
    assert err < TOL_ATTN, ("long cache K3", err)
    m["long_cache_k3_rel_err"] = err
    log(f"[long cache] K3 at S={S}, per-slot positions {int(slots[-1])}.."
        f"{pos}: cache bytes bit-exact, within {err:.3e} of the plain "
        f"version's max (< {TOL_ATTN})")
    del b_, out3, ref3
    # device time of K3, KGQA and KSOL at this cache length (B 16)
    a[7] = torch.full((B,), pos, device="cuda", dtype=torch.int32)
    m["long_cache_k3_ms"], _ = timed(lambda i: dattn.fused_decode_attention(
        *a, n_heads=H, n_kv_heads=KH), 10, K3_KERNELS)
    q = torch.randn((B, KH, H // KH, D), generator=g,
                    device="cuda").to(torch.bfloat16)
    m["long_cache_gqa_ms"], _ = timed(lambda i: gqa.fused_gqa_decode_attention(
        q, c.k, c.v, c.k_scale, c.v_scale, pos), 10, GQA_KERNELS)
    m["long_cache_ksol_ms"], _ = timed(lambda i: dsol.sol_decode_layer(
        qkv, resid, kv3[2][0], kv3[2][1], c.k_scale, c.v_scale, pos, cos,
        sin, layer["wo"], layer["w_gateup"], layer["w_down"],
        layer["mlp_norm"], eps=c2.norm_eps, n_heads=H, n_kv_heads=KH), 10,
        ["fused_layer_kernel"])
    log(f"[long cache] device ms at B={B}, S={S}, position {pos}: K3 "
        f"{m['long_cache_k3_ms']:.4f}, KGQA (bf16 q) "
        f"{m['long_cache_gqa_ms']:.4f}, KSOL (one layer) "
        f"{m['long_cache_ksol_ms']:.4f}")
    del caches, kv3, llm, qw
    torch.cuda.empty_cache()
    return m, launches


def float_llama(torch, cfg, seed):
    """The float Transformer at ``cfg``, f32 parameters drawn on the card
    from a seeded generator: N(0, 1) embeddings, N(0, 1/fan_in) kernels,
    unit RMSNorm scales."""
    from aimet_tpu_torch.models.transformer import Transformer
    with torch.device("cuda"):
        model = Transformer(cfg)
    g = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".scale"):
                p.fill_(1.0)
            else:
                std = 1.0 if name.endswith("embedding") else p.shape[0] ** -.5
                p.normal_(0.0, std, generator=g)
    return model.eval()


@contextlib.contextmanager
def plain_lowering(lw, tim):
    """Route the lowered models through the plain versions (comparison
    only: on the card the package always launches the kernels)."""
    names = {"matmul_w8": tim.matmul_w8_torch,
             "matmul_w4": tim.matmul_w4_torch,
             "matmul_w4a8": tim.matmul_w4a8_torch,
             "matmul_w8a8_staticq": tim.matmul_w8a8_staticq_torch,
             "matmul_w4_grouped": tim.matmul_w4_grouped_torch}
    saved = {k: getattr(lw, k) for k in names}
    for k, v in names.items():
        setattr(lw, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(lw, k, v)


def lowering(torch, tim, counters, g, modes=tuple(LOWER_MODES),
             fake_quant=True, profiles=1):
    """Phase 5: quantsim calibration and true-INT lowering of a float
    Llama-3-8B at full width and depth (f32: 32.1 GB), in each of
    ``modes`` (LOWER_MODES' keys, in its order); ``fake_quant``: the
    quantized_fn comparison with the float model too; ``profiles``:
    profiled forwards a mode (device ms by kernel from the last, the
    device ms of each in ``device_ms_runs``). Returns (metrics, launches
    summed over the lowered forwards)."""
    from aimet_tpu_torch import QuantizationSimModel, lower_to_int
    from aimet_tpu_torch.models.transformer import TransformerConfig
    from aimet_tpu_torch.quantsim import lowering as lw
    cfg = TransformerConfig.llama3_8b()
    torch.cuda.reset_peak_memory_stats()
    t = time.time()
    model = float_llama(torch, cfg, seed=3)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[lower] float Llama-3-8B, {cfg.n_layers} layers: {n_params / 1e9:.3f}"
        f" G f32 parameters drawn in {time.time() - t:.1f} s")
    metrics = {}
    toks = lambda b: torch.randint(0, cfg.vocab_size, (b, 512), generator=g,
                                   device="cuda")
    calib = [toks(2) for _ in range(4)]

    t = time.time()
    sim = QuantizationSimModel(model, (calib[0],))
    t_trace = time.time() - t
    sim.compute_encodings(None, calib)
    torch.cuda.synchronize()
    metrics["calibrate_s"] = time.time() - t - t_trace
    n_q = len(sim.quantizers)
    log(f"[lower] QuantizationSimModel: traced in {t_trace:.1f} s, "
        f"{len(sim.graph.ops)} ops, {n_q} quantizers; compute_encodings "
        f"(sqnr, 4 x 2 x 512 tokens) {metrics['calibrate_s']:.1f} s")

    # the fake-quant forward against the float model
    with torch.no_grad():
        ref = model(calib[0])
    masked = [op.name for op in sim.graph.ops_of_type("select_n")
              if any(c.type == "softmax" for c in op.output.consumers)]
    for tag, off in (("", []), ("_masked_off", masked)) if fake_quant \
            else ():
        for name in off:
            sim.set_quantizer_enabled(name, False)
        q = sim.quantized_fn(None, calib[0])
        for name in off:
            sim.set_quantizer_enabled(name, True)
        assert torch.isfinite(q).all() and q.shape == ref.shape
        metrics[f"quantized_fn{tag}_rel_err"] = rel_err(q, ref)
        metrics[f"quantized_fn{tag}_rel_mse"] = (
            ((q - ref) ** 2).mean() / (ref ** 2).mean()).item()
        del q
    if fake_quant:
        log("[lower] quantized_fn vs the float model (2 x 512): max rel err "
            f"{metrics['quantized_fn_rel_err']:.3e}, rel MSE "
            f"{metrics['quantized_fn_rel_mse']:.3e}; with the {len(masked)} "
            "masked-score quantizers off: "
            f"{metrics['quantized_fn_masked_off_rel_err']:.3e}, "
            f"{metrics['quantized_fn_masked_off_rel_mse']:.3e}")
    del ref

    # INT4 grids: a sim whose parameter quantizers are 4-bit (the
    # activation encodings are not read by w4 / w4a8)
    sim4 = None
    if any(LOWER_MODES[m][1] == 4 for m in modes):
        sim4 = QuantizationSimModel(model, (calib[0],), default_param_bw=4)
        sim4.compute_param_encodings()
    x = toks(8)
    with torch.no_grad():
        float_logits = model(x)
    params = sim.params
    n_lin = 7 * cfg.n_layers + 1
    launches = {k: 0 for k in counters}
    for mode, (lmode, bw, expect) in LOWER_MODES.items():
        if mode not in modes:
            continue
        s_ = sim4 if bw == 4 else sim
        if mode == "w4g":      # blockwise 4-bit layer linears, block 128
            for op in sim.graph.ops_of_type("linear")[:-1]:
                sim.set_param_blockwise(
                    None, op.param_products["kernel"].param_path, 128)
        t = time.time()
        low = lower_to_int(s_, None, mode=lmode)
        torch.cuda.synchronize()
        t_lower = time.time() - t
        assert len(low.lowered_ops) == n_lin and not low.downgraded_ops, \
            (mode, low.skipped_ops, low.downgraded_ops)
        low(params, x)                    # retrace for 8 x 512, warm-up
        zero_counts(counters)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = low(params, x)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t) * 1e3
        counts = {k: fn.launches for k, fn in counters.items() if fn.launches}
        routes = {k: {r: v for r, v in fn.routes.items() if v}
                  for k, fn in counters.items()
                  if fn.launches and hasattr(fn, "routes")}
        take_routes(counters)
        for k, v in counts.items():
            launches[k] += v
        assert counts == expect(n_lin), (mode, counts)
        assert torch.isfinite(out).all() and out.shape == float_logits.shape
        runs = []
        for _ in range(profiles):
            with profiled() as prof:
                low(params, x)
                torch.cuda.synchronize()
            by_name = {}
            for e in _kernel_events(prof):
                key = e.name.replace("(anonymous namespace)::", "")
                key = key.removeprefix("void ").split("<")[0].split("(")[0]
                by_name[key] = by_name.get(key, 0.0) \
                    + e.time_range.elapsed_us() / 1e3
            runs.append(sum(by_name.values())
                        or timed(lambda i: low(params, x), 1, warmup=0)[0])
        dev_ms = runs[-1]
        with plain_lowering(lw, tim):
            plain = low(params, x)
        m = {"lower_s": t_lower, "host_ms": host_ms, "device_ms": dev_ms,
             "logits_vs_plain_rel_err": rel_err(out, plain),
             "top1_vs_plain": (out.argmax(-1) == plain.argmax(-1)).float()
             .mean().item(),
             "rel_mse_vs_float": (((out - float_logits) ** 2).mean()
                                  / (float_logits ** 2).mean()).item(),
             "top1_vs_float": (out.argmax(-1) == float_logits.argmax(-1))
             .float().mean().item(),
             "launches": counts, "routes": routes, "device_ms_runs": runs,
             "kernels_ms": by_name}
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
        log(f"[lower {mode}] lower_to_int {t_lower:.1f} s; forward 8 x 512: "
            f"{host_ms:.1f} ms host, {dev_ms:.2f} ms device ("
            + ", ".join(f"{k} {v:.2f}" for k, v in top) + "); launches "
            f"{counts}, by route {routes}; kernels vs plain "
            f"{m['logits_vs_plain_rel_err']:.3e} "
            f"(top-1 {m['top1_vs_plain']:.3f}); vs float: rel MSE "
            f"{m['rel_mse_vs_float']:.3e}, top-1 {m['top1_vs_float']:.3f}")
        assert m["logits_vs_plain_rel_err"] < TOL_LOGITS, (mode, m)
        metrics.update({f"lower_{mode}_{k}": v for k, v in m.items()})
        del low, out, plain
        torch.cuda.empty_cache()
    metrics["lower_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"[lower] peak device memory {metrics['lower_peak_gb']:.1f} GB")
    del sim, sim4, model, float_logits, params
    torch.cuda.empty_cache()
    return metrics, launches


def lowering_block8(torch, tim, counters, g):
    """Phase 5b: a blockwise 4-bit linear with block 8 (not a multiple of
    16) through lower_to_int and its forward on the card: a float
    Llama-3-8B at full width with 2 layers, calibrated (sqnr, 2 batches of
    2 x 256 tokens), every layer linear made blockwise with block 8, lowered
    in w8 (layer linears -> KW4G, lm_head -> KW8: activations stay float
    between the ops, as in a W4A16 deployment; a static-INT8 lm_head's
    input codes would flip on the kernels' last-bit differences), one
    forward of 2 x 256 tokens with the launch counts set to 0 just before
    and read just after, against the same forward through the plain
    versions (logits within 1e-2 of the max). Returns (metrics,
    launches)."""
    import dataclasses
    from aimet_tpu_torch import QuantizationSimModel, lower_to_int
    from aimet_tpu_torch.models.transformer import TransformerConfig
    from aimet_tpu_torch.quantsim import lowering as lw
    cfg = dataclasses.replace(TransformerConfig.llama3_8b(), n_layers=2)
    model = float_llama(torch, cfg, seed=7)
    toks = lambda: torch.randint(0, cfg.vocab_size, (2, 256), generator=g,
                                 device="cuda")
    calib = [toks() for _ in range(2)]
    sim = QuantizationSimModel(model, (calib[0],))
    sim.compute_encodings(None, calib)
    lin = sim.graph.ops_of_type("linear")
    for op in lin[:-1]:
        sim.set_param_blockwise(None, op.param_products["kernel"].param_path,
                                8)
    low = lower_to_int(sim, None, mode="w8")
    modes = list(low.op_modes.values())
    assert modes.count("w4_grouped") == len(lin) - 1, low.op_modes
    x = toks()
    params = sim.params
    low(params, x)                                  # warm-up
    zero_counts(counters)
    out = low(params, x)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items() if fn.launches}
    take_routes(counters)
    assert launches == {"w4_grouped_gemm": len(lin) - 1, "w8_gemm": 1}, \
        launches
    with plain_lowering(lw, tim):
        plain = low(params, x)
    err = rel_err(out, plain)
    assert torch.isfinite(out).all() and err < TOL_WO, ("block 8", err)
    log(f"[lower block 8] Llama-3-8B width, 2 layers: {len(lin) - 1} "
        f"blockwise linears (block 8) lowered to KW4G, lm_head to KW8; "
        f"forward of 2 x 256 tokens: launches {launches}; logits within "
        f"{err:.3e} of the plain versions' max (< {TOL_WO})")
    del sim, low, model, out, plain, params
    torch.cuda.empty_cache()
    return {"lower_block8_logits_rel_err": err}, launches


def resnet_inputs(torch, g, n, batch=32):
    """``n`` seeded ImageNet-shaped batches (batch, 3, 224, 224), N(0, 1)."""
    return [torch.randn((batch, 3, 224, 224), generator=g, device="cuda")
            for _ in range(n)]


def float_cnn(torch, make, x_fit, seed):
    """A CNN of the port's layers on the card: seeded random weights
    (He-normal conv kernels, LeCun-normal dense kernels, BatchNorm scale in
    [0.5, 1.5) and bias N(0, 0.1^2)), then running statistics fitted layer
    by layer to ``x_fit``: each BatchNorm takes its input's batch mean and
    variance in one forward, as a trained network's statistics describe
    its own activations."""
    from aimet_tpu_torch.models.layers import BatchNorm, Conv, Dense
    with torch.device("cuda"):
        model = make().eval()
    g = torch.Generator(device="cuda").manual_seed(seed)

    def fit(mod, args):
        (inp,) = args
        mod.mean.copy_(inp.mean(dim=(0, 2, 3)))
        mod.var.copy_(inp.var(dim=(0, 2, 3), unbiased=False))

    hooks = []
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, Conv):
                mod.kernel.normal_(0.0, (2.0 / mod.kernel[0].numel()) ** 0.5,
                                   generator=g)
            elif isinstance(mod, Dense):
                mod.kernel.normal_(0.0, mod.kernel.shape[0] ** -0.5,
                                   generator=g)
                mod.bias.zero_()
            elif isinstance(mod, BatchNorm):
                mod.scale.uniform_(0.5, 1.5, generator=g)
                mod.bias.normal_(0.0, 0.1, generator=g)
                hooks.append(mod.register_forward_pre_hook(fit))
        model(x_fit)
    for h in hooks:
        h.remove()
    return model


@contextlib.contextmanager
def ops_api_convs(torch, tim, model):
    """The CNN's forward with every conv through ``conv2d_w8a8`` (im2col,
    per-pixel dynamic INT8: K1 + KQ8) and its dense layer through
    ``matmul_w8a8``, weights quantized per channel once: the JAX package's
    dynamic full-INT8 ops API as a user calls it."""
    from aimet_tpu_torch.models.layers import Conv, Dense
    from aimet_tpu_torch.ops import int_conv as tic
    saved = []
    for mod in model.modules():
        if isinstance(mod, Conv):
            wq, s_ = tic.quantize_conv_weight_per_channel(mod.kernel.detach())

            def fwd(x, mod=mod, wq=wq, s_=s_):
                return tic.conv2d_w8a8(x, wq, s_, tuple(mod.kernel.shape[2:]),
                                       strides=mod.strides,
                                       padding=mod.pads(*x.shape[2:]))
        elif isinstance(mod, Dense):
            wq, s_ = tim.quantize_weight_per_channel(mod.kernel.detach())

            def fwd(x, mod=mod, wq=wq, s_=s_):
                return tim.matmul_w8a8(x, wq, s_) + mod.bias
        else:
            continue
        saved.append(mod)
        mod.forward = fwd
    try:
        yield
    finally:
        for mod in saved:
            del mod.forward


@contextlib.contextmanager
def plain_ops(tim, tic):
    """Route matmul_w8a8 and the int32 conv sums through the plain
    versions (comparison only)."""
    saved = (tim.matmul_w8a8, tic.matmul_w8a8, tic.int8_matmul_int32)
    tim.matmul_w8a8 = tic.matmul_w8a8 = tim.matmul_w8a8_torch
    tic.int8_matmul_int32 = tim.int8_matmul_int32_torch
    try:
        yield
    finally:
        tim.matmul_w8a8, tic.matmul_w8a8, tic.int8_matmul_int32 = saved


def forward_stats(torch, fn, counters, profiler=None, routes=None):
    """One forward with the launch counts set to 0 just before and read
    just after; then its device ms (profiler, by kernel) and host ms.
    ``profiler``: ``profiled`` by default, ``cuda_profiled`` for forwards
    of many thousand kernels; ``routes``: a dict that receives the counted
    forward's launches by route. Returns (out, counts, host_ms, device_ms,
    top kernels)."""
    fn()                                   # warm-up (and retrace)
    zero_counts(counters)
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t) * 1e3
    counts = {k: c.launches for k, c in counters.items() if c.launches}
    if routes is not None:
        routes.update({k: {r: n for r, n in getattr(counters[k], "routes",
                                                     {}).items() if n}
                       for k in counts})
    take_routes(counters)
    with (profiler or profiled)() as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in _kernel_events(prof):
        key = e.name.replace("(anonymous namespace)::", "")
        key = key.removeprefix("void ").split("<")[0].split("(")[0]
        by_name[key] = by_name.get(key, 0.0) + e.time_range.elapsed_us() / 1e3
    dev_ms = sum(by_name.values()) or timed(lambda i: fn(), 1, warmup=0)[0]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return out, counts, host_ms, dev_ms, top


def vs_float(out, ref):
    """Relative MSE and top-1 agreement of logits against the float
    model's."""
    return {"rel_mse_vs_float": (((out - ref) ** 2).mean()
                                 / (ref ** 2).mean()).item(),
            "top1_vs_float": (out.argmax(-1) == ref.argmax(-1)).float()
            .mean().item()}


@contextlib.contextmanager
def int32_shapes(tic, shapes):
    """Count the integer conv's calls of KQ8's int32 entry by (M, K, N)."""
    saved = tic.int8_matmul_int32

    def record(x, w):
        key = (x.shape[0], x.shape[1], w.shape[1])
        shapes[key] = shapes.get(key, 0) + 1
        return saved(x, w)

    tic.int8_matmul_int32 = record
    try:
        yield
    finally:
        tic.int8_matmul_int32 = saved


def lower_cnn(torch, tim, counters, model, x, calib, ref, params, grids,
              config, conv_shapes=None):
    """ResNet-50 through QuantizationSimModel (sqnr on ``calib``) and
    lower_to_int in each of CNN_MODES, with the parameter grids of
    ``config`` (None: the default, per tensor). Returns (metrics, launches
    of the measured forwards)."""
    from aimet_tpu_torch import QuantizationSimModel, lower_to_int
    from aimet_tpu_torch.ops import int_conv as tic
    from aimet_tpu_torch.quantsim import lowering as lw
    metrics, launches = {}, {k: 0 for k in counters}
    t = time.time()
    sim = QuantizationSimModel(model, (x,), config=config)
    t_trace = time.time() - t
    sim.compute_encodings(None, calib)
    torch.cuda.synchronize()
    metrics[f"resnet50_{grids}_calibrate_s"] = time.time() - t - t_trace
    sim4 = QuantizationSimModel(model, (x,), config=config,
                                default_param_bw=4)
    sim4.compute_param_encodings()
    convs = [op for op in sim.graph.ops
             if op.type in ("conv", "depthwise_conv", "conv_transpose")]
    n_conv = sum(op.type == "conv" for op in convs)
    log(f"[cnn {grids}] QuantizationSimModel: traced in {t_trace:.1f} s, "
        f"{len(sim.graph.ops)} ops ({len(convs)} convs, "
        f"{len(sim.graph.ops_of_type('linear'))} dense), "
        f"{len(sim.quantizers)} quantizers; compute_encodings (sqnr, 4 x 32 "
        f"images) {metrics[f'resnet50_{grids}_calibrate_s']:.1f} s")
    q = sim.quantized_fn(None, x)
    metrics.update({f"resnet50_{grids}_quantized_fn_{k}": v
                    for k, v in vs_float(q, ref).items()})
    del q
    for mode, (lmode, bw, expect) in CNN_MODES.items():
        t = time.time()
        low = lower_to_int(sim4 if bw == 4 else sim, None, mode=lmode)
        t_lower = time.time() - t
        assert not low.skipped_ops and len(low.lowered_ops) == len(convs) + 1
        out, counts, host_ms, dev_ms, top = forward_stats(
            torch, lambda: low(params, x), counters)
        for k, v in counts.items():
            launches[k] += v
        assert counts == expect(n_conv), (mode, counts)
        assert torch.isfinite(out).all() and out.shape == ref.shape
        if mode == "w8a8" and conv_shapes is not None:
            with int32_shapes(tic, conv_shapes):
                low(params, x)
        with plain_lowering(lw, tim), plain_ops(tim, tic):
            plain = low(params, x)
        m = {"lowered": len(low.lowered_ops),
             "skipped": len(low.skipped_ops),
             "downgraded": len(low.downgraded_ops),
             "int_flops_fraction": low.int_flops_fraction,
             "lower_s": t_lower, "host_ms": host_ms, "device_ms": dev_ms,
             "logits_vs_plain_rel_err": rel_err(out, plain),
             "top1_vs_plain": (out.argmax(-1) == plain.argmax(-1)).float()
             .mean().item(), **vs_float(out, ref), "launches": counts}
        log(f"[cnn {mode}, {grids}] lowered {m['lowered']}, skipped "
            f"{m['skipped']}, "
            f"downgraded {low.downgraded_ops}; int_flops_fraction "
            f"{m['int_flops_fraction']:.6f}; forward 32 x 224 x 224: "
            f"{host_ms:.1f} ms host, {dev_ms:.2f} ms device ("
            + ", ".join(f"{k} {v:.2f}" for k, v in top) + f"); launches "
            f"{counts}; kernels vs plain {m['logits_vs_plain_rel_err']:.3e} "
            f"(top-1 {m['top1_vs_plain']:.3f}); vs float: rel MSE "
            f"{m['rel_mse_vs_float']:.3e}, top-1 {m['top1_vs_float']:.3f}")
        assert m["logits_vs_plain_rel_err"] < TOL_CNN_LOGITS, (mode, m)
        metrics.update({f"resnet50_{grids}_{mode}_{k}": v
                        for k, v in m.items()})
        del low, out, plain
    del sim, sim4
    torch.cuda.empty_cache()
    return metrics, launches


def cnn(torch, tim, counters, g):
    """Phase 6: ResNet-50 (1000 classes, 224 x 224, batch 32, f32) through
    QuantizationSimModel and lower_to_int in w8, w8a8, w4 and w4a8, and
    through the dynamic full-INT8 ops API (conv2d_w8a8 / matmul_w8a8);
    MobileNetV2 lowered in w8a8 (its depthwise convs). Returns (metrics,
    launches summed over the measured forwards, the two float models for
    the PTQ phase)."""
    from aimet_tpu_torch import (QuantizationSimModel, QuantSimConfig,
                                 lower_to_int)
    from aimet_tpu_torch.models.layers import Conv
    from aimet_tpu_torch.models.mobilenet_v2 import MobileNetV2
    from aimet_tpu_torch.models.resnet import ResNet50
    from aimet_tpu_torch.ops import int_conv as tic
    from aimet_tpu_torch.quantsim import lowering as lw
    metrics, launches = {}, {k: 0 for k in counters}

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    xs = resnet_inputs(torch, g, 6)
    x, calib = xs[0], xs[1:5]
    t = time.time()
    model = float_cnn(torch, ResNet50, xs[5], seed=4)
    with torch.no_grad():
        ref = model(x)
        # the f32 convs run in f32: against the model in f64 on 4 images
        r64 = model.double()(x[:4].double())
        model.float()
    metrics["resnet50_f32_vs_f64_rel_err"] = rel_err(ref[:4], r64)
    assert metrics["resnet50_f32_vs_f64_rel_err"] < 1e-4, \
        ("f32 convs not in f32 (TF32?)", metrics)
    del r64
    n_par = sum(p.numel() for p in model.parameters())
    e64 = metrics["resnet50_f32_vs_f64_rel_err"]
    log(f"[cnn] ResNet-50: {n_par / 1e6:.2f} M parameters, float forward of "
        f"32 x 3 x 224 x 224 within {e64:.2e} of f64 (TF32 off); built in "
        f"{time.time() - t:.1f} s")

    params = {k: v.detach() for k, v in model.named_parameters()}
    shapes = {}
    for grids, config in (("per_tensor", None),
                          ("per_channel",
                           QuantSimConfig.per_channel_default())):
        m, counts = lower_cnn(torch, tim, counters, model, x, calib, ref,
                              params, grids, config,
                              shapes if grids == "per_tensor" else None)
        metrics.update(m)
        add(counts)
    sweep, tot_k, tot_l = int32_conv_sweep(torch, tim, shapes)
    metrics.update(resnet50_int32_convs=sweep,
                   resnet50_int32_kernel_ms=tot_k,
                   resnet50_int32_library_ms=tot_l)
    n_conv = sum(isinstance(mod, Conv) for mod in model.modules())

    # the dynamic full-INT8 ops API: every conv through conv2d_w8a8
    with torch.no_grad(), ops_api_convs(torch, tim, model):
        out, counts, host_ms, dev_ms, top = forward_stats(
            torch, lambda: model(x), counters)
        add(counts)
        assert counts == {"w8a8_fusedq": n_conv + 1, "act_quant": n_conv + 1,
                          "q8_gemm": n_conv + 1}, counts
        with plain_ops(tim, tic):
            plain = model(x)
    m = {"host_ms": host_ms, "device_ms": dev_ms,
         "logits_vs_plain_rel_err": rel_err(out, plain), **vs_float(out, ref),
         "launches": counts}
    assert torch.equal(out, plain), "ops API: kernels vs plain"
    log(f"[cnn ops API] ResNet-50 with conv2d_w8a8 / matmul_w8a8: "
        f"{host_ms:.1f} ms host, {dev_ms:.2f} ms device ("
        + ", ".join(f"{k} {v:.2f}" for k, v in top) + f"); launches {counts};"
        " logits equal to the plain versions'; vs float: rel MSE "
        f"{m['rel_mse_vs_float']:.3e}, top-1 {m['top1_vs_float']:.3f}")
    metrics.update({f"resnet50_ops_api_{k}": v for k, v in m.items()})
    resnet = model
    del out, plain, ref
    torch.cuda.empty_cache()

    # MobileNetV2 in w8a8: depthwise convs on the exact f64 route
    model = float_cnn(torch, MobileNetV2, xs[5], seed=5)
    with torch.no_grad():
        ref = model(x)
    sim = QuantizationSimModel(model, (x,))
    sim.compute_encodings(None, calib)
    low = lower_to_int(sim, None, mode="w8a8")
    dw = sum(op.type == "depthwise_conv" for op in sim.graph.ops)
    regular = sum(op.type == "conv" for op in sim.graph.ops)
    assert not low.skipped_ops
    params = sim.params
    out, counts, host_ms, dev_ms, top = forward_stats(
        torch, lambda: low(params, x), counters)
    add(counts)
    assert counts == {"q8_gemm": regular, "w8_gemm": 1}, counts
    with plain_lowering(lw, tim), plain_ops(tim, tic):
        plain = low(params, x)
    m = {"lowered": len(low.lowered_ops), "depthwise": dw,
         "downgraded": len(low.downgraded_ops),
         "int_flops_fraction": low.int_flops_fraction, "host_ms": host_ms,
         "device_ms": dev_ms, "logits_vs_plain_rel_err": rel_err(out, plain),
         **vs_float(out, ref), "launches": counts}
    assert m["logits_vs_plain_rel_err"] < TOL_CNN_LOGITS, m
    log(f"[cnn mobilenet_v2 w8a8] lowered {m['lowered']} ({dw} depthwise), "
        f"downgraded {low.downgraded_ops}; int_flops_fraction "
        f"{m['int_flops_fraction']:.6f}; {host_ms:.1f} ms host, "
        f"{dev_ms:.2f} ms device (" + ", ".join(f"{k} {v:.2f}"
                                                for k, v in top)
        + f"); launches {counts}; kernels vs plain "
        f"{m['logits_vs_plain_rel_err']:.3e}; vs float: rel MSE "
        f"{m['rel_mse_vs_float']:.3e}, top-1 {m['top1_vs_float']:.3f}")
    metrics.update({f"mobilenet_v2_w8a8_{k}": v for k, v in m.items()})
    models = {"resnet50": resnet, "mobilenet_v2": model}
    del sim, low, out, plain, ref, xs
    torch.cuda.empty_cache()
    return metrics, launches, models


# The PTQ phase: AdaRound's iterations a layer on the 54 layers (graphs of
# 25 steps, the chunk apply_adaround picks at 500 iterations); on the
# timed layer the default iterations (10,000, graphs of 100 steps), and the
# steps compared captured against eager; the steps profiled for the busy
# share
PTQ_ADA_ITERS = 500
PTQ_TIMED_ITERS = 10000
PTQ_BITWISE_STEPS = 200
PTQ_PROFILED_STEPS = 20
# the equalized ResNet-50's float logits against the original's (max
# |diff| / max |original|): BN fold and cross-layer scaling are exact up
# to rounding through ReLU (its convs have no bias: no high-bias fold).
# MobileNetV2's too once its ReLU6 is read as ReLU, as AIMET's CLE swaps
# ReLU6 for ReLU before scaling; the JAX package's CLE scales through
# ReLU6 as through ReLU and keeps the model's ReLU6, so with ReLU6 the
# equalized logits move (reported, no limit)
TOL_EQUALIZED = 1e-4
# SeqMSE's bound on the logits' mean error, tests/test_adaround_seqmse.py's
SEQ_MSE_BOUND = 1.05


def same_encodings(torch, a, b):
    """Names whose encodings differ in a field, bitwidth or grid kind."""
    bad = sorted(set(a) ^ set(b))
    for k in set(a) & set(b):
        if not all(torch.equal(getattr(a[k], f), getattr(b[k], f))
                   for f in ("min", "max", "delta", "offset")) or \
                (a[k].bitwidth, a[k].symmetric) != (b[k].bitwidth,
                                                    b[k].symmetric):
            bad.append(k)
    return bad


def export_load(torch, sim, model, x, tag):
    """``sim.export`` to a temporary directory, then ``load_encodings`` of
    the file into a fresh sim of the same model; every encoding must come
    back bit for bit. Returns (fresh sim, metrics)."""
    import tempfile
    from aimet_tpu_torch import QuantizationSimModel
    with tempfile.TemporaryDirectory() as d:
        t = time.perf_counter()
        path = sim.export(d, tag)
        t_export = time.perf_counter() - t
        size = os.path.getsize(path)
        fresh = QuantizationSimModel(model, (x,))
        t = time.perf_counter()
        with open(path) as f:
            fresh.load_encodings(json.load(f))
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t
    bad = same_encodings(torch, sim.encodings, fresh.encodings)
    assert not bad, (tag, "export / load changed encodings", bad[:5])
    return fresh, {"export_s": t_export, "load_s": t_load,
                   "encodings": len(sim.encodings), "file_bytes": size}


def ptq_lowered(torch, tim, counters, low, params, x, ref, expect):
    """One lowered forward with the launch counts read, against the plain
    versions and the float logits (``lower_cnn``'s checks)."""
    from aimet_tpu_torch.ops import int_conv as tic
    from aimet_tpu_torch.quantsim import lowering as lw
    out, counts, host_ms, dev_ms, top = forward_stats(
        torch, lambda: low(params, x), counters)
    assert counts == expect, counts
    assert torch.isfinite(out).all() and out.shape == ref.shape
    with plain_lowering(lw, tim), plain_ops(tim, tic):
        plain = low(params, x)
    m = {"host_ms": host_ms, "device_ms": dev_ms,
         "logits_vs_plain_rel_err": rel_err(out, plain), **vs_float(out, ref),
         "launches": counts}
    assert m["logits_vs_plain_rel_err"] < TOL_CNN_LOGITS, m
    return m, counts


def adaround_checked(torch, ada, records):
    """``apply_adaround`` with every layer's rounding checked: the hard
    weights on their grid, and their reconstruction loss on the layer's
    own batches against round-to-nearest's (per layer: name, AdaRound
    loss, nearest loss, seconds)."""
    from aimet_tpu_torch.quantization.affine import \
        quantize_dequantize_encoding
    from aimet_tpu_torch.quantsim.qsim import _broadcast_encoding
    orig = ada.optimize_layer_rounding

    def checked(replay, w, bias, encoding, channel_axis, xb, yb, cfg,
                out_axis, params=None):
        torch.cuda.synchronize()
        t = time.perf_counter()
        w_ada = orig(replay, w, bias, encoding, channel_axis, xb, yb, cfg,
                     out_axis, params)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        delta = _broadcast_encoding(encoding.delta, w.dim(), channel_axis)
        q = w_ada / delta
        assert (q - q.round()).abs().max().item() < 1e-3, replay.op.name
        w_rtn = quantize_dequantize_encoding(w, encoding,
                                             channel_axis=channel_axis)

        def recon(wq):
            with torch.no_grad():
                return sum(((ada._layer_apply(replay, x, wq, bias, params)
                             - y) ** 2).sum(dim=out_axis).mean().item()
                           for x, y in zip(xb, yb)) / len(xb)

        records.append((replay.op.name, recon(w_ada), recon(w_rtn), secs))
        return w_ada

    return checked


def ada_capture_check(torch, ada, sim, op, params, batches):
    """On one layer: PTQ_BITWISE_STEPS steps of the captured loop (graphs
    of the chunk run() picks) against as many eager steps
    (alpha, both Adam moments, the step counter bit for bit), then the
    layer at PTQ_TIMED_ITERS iterations both ways: seconds, and the
    device's busy share (kernel ms a step, from a profile of
    PTQ_PROFILED_STEPS steps, over the unprofiled loop's ms a step)."""
    from aimet_tpu_torch.algorithms.adaround import (AdaroundParameters,
                                                     _graph_chunk)
    from aimet_tpu_torch.graph.interpreter import OpReplay
    kpath = op.param_products["kernel"].param_path
    spec, enc = sim.quantizers[kpath], sim.encodings[kpath]
    bias = params.get(op.param_products["bias"].param_path) \
        if "bias" in op.param_products else None
    xb, yb = ada.layer_batches(sim, op, params, params, batches)

    def make(iters):
        return ada._rounding_optimizer(
            OpReplay(sim.graph, op), params[kpath], bias, enc,
            spec.channel_axis, xb, yb,
            AdaroundParameters(num_iterations=iters), 1, params)

    chunk = _graph_chunk(PTQ_BITWISE_STEPS)
    eager, graph = make(PTQ_BITWISE_STEPS), make(PTQ_BITWISE_STEPS)
    eager.run(0)
    graph.run()
    torch.cuda.synchronize()
    differ = [n for n, a, b in zip(("alpha", "m", "v", "it"),
                                   eager.state(), graph.state())
              if not torch.equal(a, b)]
    assert not differ, f"captured AdaRound loop differs from eager: {differ}"
    m = {"layer": op.name, "kernel": list(params[kpath].shape),
         "input": list(xb[0].shape), "bitwise_steps": PTQ_BITWISE_STEPS,
         "graph_chunk": chunk}
    n = PTQ_PROFILED_STEPS
    m["timed_graph_chunk"] = _graph_chunk(PTQ_TIMED_ITERS)
    for tag, c in (("eager", 0), ("graph", None)):
        opt = make(PTQ_TIMED_ITERS)
        torch.cuda.synchronize()
        t = time.perf_counter()
        opt.run(c)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        prof_opt = make(n)
        with torch.backends.cudnn.flags(enabled=True, deterministic=True,
                                        allow_tf32=False):
            steps = prof_opt.capture(n).replay if c is None else \
                (lambda: prof_opt.run_eager(n))
            steps()
            torch.cuda.synchronize()
            with profiled() as prof:
                steps()
                torch.cuda.synchronize()
        dev_ms = sum(e.time_range.elapsed_us()
                     for e in _kernel_events(prof)) / 1e3 / n
        m[f"{tag}_s"] = secs
        m[f"{tag}_device_ms_per_step"] = dev_ms
        m[f"{tag}_busy"] = dev_ms / (secs * 1e3 / PTQ_TIMED_ITERS)
    return m


def ptq(torch, tim, counters, g, models, smi):
    """Phase 7: the PTQ path of examples/ptq_quickstart.py on the card.

    ResNet-50 (the CNN phase's, 1000 classes, 224 x 224): equalize_model
    (BN fold, cross-layer scaling, high-bias fold; float logits within
    TOL_EQUALIZED), QuantizationSimModel(quant_scheme="sqnr") calibrated on
    4 batches of 8 images (the searches in the C++ host library; the other
    schemes timed on the same images), AdaRound
    over every conv and the dense layer (2 batches, PTQ_ADA_ITERS
    iterations, captured CUDA graphs of 25 steps; each layer
    on its grid, its encoding frozen, its reconstruction loss no worse
    than round-to-nearest's), the captured loop against the eager one bit
    for bit on a stride-2 3 x 3 layer and that layer timed at
    PTQ_TIMED_ITERS iterations both ways, export and load_encodings (bit
    for bit), lower_to_int in w8a8 and a forward of 32 images (KQ8 for the
    convs, KW8 for the dense layer; against the plain versions), with
    round-to-nearest and with AdaRound against the float logits.
    MobileNetV2: equalize_model (float logits within TOL_EQUALIZED with
    its ReLU6 read as ReLU, as AIMET runs CLE; the drift with ReLU6
    reported), calibration and correct_bias on 2
    batches, export / load, lowered in w8a8. A float Llama-3-8B at 2
    layers (full width): SeqMSE (20 candidates, 2 batches of 1 x 512
    tokens; per-channel grids), the logits' mean error within
    SEQ_MSE_BOUND of the error before, lowered in w8.
    Returns (metrics, launches of each measured forward by path)."""
    import dataclasses
    from aimet_tpu_torch import (QuantizationSimModel, QuantSimConfig,
                                 lower_to_int, native)
    from aimet_tpu_torch.algorithms import (AdaroundParameters,
                                            apply_adaround, apply_seq_mse,
                                            correct_bias, equalize_model)
    from aimet_tpu_torch.algorithms import adaround as ada
    from aimet_tpu_torch.graph.connected_graph import ConnectedGraph
    from aimet_tpu_torch.models import mobilenet_v2
    from aimet_tpu_torch.models.transformer import TransformerConfig
    metrics, paths = {}, {}

    def step(label, t0):
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        metrics[f"ptq_{label}_s"] = secs
        log(f"[ptq] {label}: {secs:.2f} s ({smi})")
        return time.perf_counter()

    # --- ResNet-50
    model = models["resnet50"]
    params = {k: v.detach() for k, v in model.named_parameters()}
    xs = resnet_inputs(torch, g, 4, batch=8)
    x32 = resnet_inputs(torch, g, 1)[0]
    t = time.perf_counter()
    eq = equalize_model(ConnectedGraph(model, (xs[0],)), params)
    with torch.no_grad():
        ref8 = model(xs[0])
        err = rel_err(torch.func.functional_call(model, eq, (xs[0],)), ref8)
    metrics["ptq_resnet50_equalized_rel_err"] = err
    assert err < TOL_EQUALIZED, ("equalized logits", err)
    log(f"[ptq] ResNet-50 equalized float logits within {err:.3e} of the "
        f"original's (limit {TOL_EQUALIZED})")
    t = step("resnet50_equalize", t)

    calls = {"n": 0}
    search = native.sqnr_search

    def counted(*a, **k):
        calls["n"] += 1
        return search(*a, **k)

    sim = QuantizationSimModel(model, (xs[0],), quant_scheme="sqnr")
    native.sqnr_search = counted
    try:
        sim.compute_encodings(eq, xs)
    finally:
        native.sqnr_search = search
    n_act = sum(s.kind != "param" for s in sim.quantizers.values())
    assert calls["n"] > 0, "the sqnr calibration never ran the C++ search"
    metrics["ptq_resnet50_sqnr_searches"] = calls["n"]
    t = step("resnet50_calibrate_sqnr", t)
    # the other schemes on the same images (compute_encodings alone)
    secs = {"sqnr": metrics["ptq_resnet50_calibrate_sqnr_s"]}
    for scheme in ("minmax", "percentile", "mse", "entropy"):
        other = QuantizationSimModel(model, (xs[0],), quant_scheme=scheme,
                                     percentile=99.99)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        other.compute_encodings(eq, xs)
        torch.cuda.synchronize()
        secs[scheme] = time.perf_counter() - t0
        del other
    metrics["ptq_resnet50_calibrate_s"] = secs
    log(f"[ptq] ResNet-50 calibration, 4 x 8 images, {n_act} activation "
        f"quantizers ({calls['n']} sqnr searches in C++), s by scheme: "
        + ", ".join(f"{k} {v:.2f}" for k, v in secs.items()) + f" ({smi})")
    t = time.perf_counter()

    records = []
    saved = ada.optimize_layer_rounding
    ada.optimize_layer_rounding = adaround_checked(torch, ada, records)
    try:
        ada_params = apply_adaround(sim, eq, xs[:2], AdaroundParameters(
            num_batches=2, num_iterations=PTQ_ADA_ITERS))
    finally:
        ada.optimize_layer_rounding = saved
    layers = ada.adaround_layers(sim)
    assert len(records) == len(layers) == 54, (len(records), len(layers))
    worse = [r for r in records if r[1] > r[2]]
    assert not worse, ("AdaRound worse than nearest", worse[:3])
    for op in layers:
        assert op.param_products["kernel"].param_path in sim._frozen
    opt_s = sum(r[3] for r in records)
    metrics["ptq_resnet50_adaround"] = {
        "layers": len(records), "iterations": PTQ_ADA_ITERS,
        "optimize_s": opt_s, "per_layer": [
            {"layer": n, "loss": a, "nearest_loss": b, "s": s}
            for n, a, b, s in records]}
    gain = [b / a for _, a, b, _ in records if a > 0]
    t_ada = time.perf_counter() - t
    log(f"[ptq] AdaRound, {len(records)} layers x {PTQ_ADA_ITERS} "
        f"iterations (graphs of {ada._graph_chunk(PTQ_ADA_ITERS)} steps): "
        f"{t_ada:.1f} s, "
        f"{opt_s:.1f} s of it in the loops; every layer on its grid, "
        f"frozen, nearest / AdaRound loss {min(gain):.3f}..{max(gain):.3f} "
        f"(median {sorted(gain)[len(gain) // 2]:.3f})")
    t = step("resnet50_adaround", t)

    op = next(o for o in layers if o.type == "conv"
              and tuple(o.param_products["kernel"].shape[2:]) == (3, 3)
              and list(o.nodes[0].args[3]) == [2, 2])
    m = ada_capture_check(torch, ada, sim, op, eq, xs[:2])
    metrics["ptq_resnet50_adaround_timed_layer"] = m
    log(f"[ptq] AdaRound on {op.name} (kernel {m['kernel']}, input "
        f"{m['input']}): {PTQ_BITWISE_STEPS} captured steps (graphs of "
        f"{m['graph_chunk']}) equal to eager bit for bit; {PTQ_TIMED_ITERS} "
        f"iterations eager "
        f"{m['eager_s']:.2f} s (busy {m['eager_busy']:.3f}, "
        f"{m['eager_device_ms_per_step']:.4f} device ms a step), captured "
        f"{m['graph_s']:.2f} s (graphs of {m['timed_graph_chunk']}, busy "
        f"{m['graph_busy']:.3f}, "
        f"{m['graph_device_ms_per_step']:.4f})")
    t = step("resnet50_adaround_timed_layer", t)

    fresh, m = export_load(torch, sim, model, xs[0], "resnet50_ptq")
    metrics["ptq_resnet50_export_load"] = m
    log(f"[ptq] export {m['export_s']:.3f} s ({m['encodings']} encodings, "
        f"{m['file_bytes']} bytes), load_encodings {m['load_s']:.3f} s: "
        "bit for bit")
    t = step("resnet50_export_load", t)

    with torch.no_grad():
        ref = model(x32)
    n_conv = sum(o.type == "conv" for o in sim.graph.ops)
    expect = CNN_MODES["w8a8"][2](n_conv)
    paths["ptq_resnet50"] = {}
    for tag, s_, p_ in (("nearest", sim, eq), ("adaround", fresh,
                                                ada_params)):
        low = lower_to_int(s_, p_, mode="w8a8")
        m, counts = ptq_lowered(torch, tim, counters, low, p_, x32, ref,
                                expect)
        for k, v in counts.items():
            paths["ptq_resnet50"][k] = paths["ptq_resnet50"].get(k, 0) + v
        metrics[f"ptq_resnet50_w8a8_{tag}"] = m
        log(f"[ptq] ResNet-50 w8a8 ({tag}), 32 images: {m['host_ms']:.1f} "
            f"ms host, {m['device_ms']:.2f} ms device; launches {counts}; "
            f"kernels vs plain {m['logits_vs_plain_rel_err']:.3e}; vs "
            f"float: rel MSE {m['rel_mse_vs_float']:.4e}, top-1 "
            f"{m['top1_vs_float']:.3f}")
        del low
    t = step("resnet50_lower", t)
    del sim, fresh, eq, ada_params, ref, xs, x32
    torch.cuda.empty_cache()

    # --- MobileNetV2
    model = models["mobilenet_v2"]
    params = {k: v.detach() for k, v in model.named_parameters()}
    xs = resnet_inputs(torch, g, 2, batch=8)
    x32 = resnet_inputs(torch, g, 1)[0]
    eq = equalize_model(ConnectedGraph(model, (xs[0],)), params)
    with torch.no_grad():
        metrics["ptq_mobilenet_v2_equalized_rel_err"] = rel_err(
            torch.func.functional_call(model, eq, (xs[0],)), model(xs[0]))
        relu6 = mobilenet_v2.relu6
        mobilenet_v2.relu6 = torch.relu
        try:
            err = rel_err(torch.func.functional_call(model, eq, (xs[0],)),
                          model(xs[0]))
        finally:
            mobilenet_v2.relu6 = relu6
    metrics["ptq_mobilenet_v2_equalized_relu_rel_err"] = err
    assert err < TOL_EQUALIZED, ("equalized logits, ReLU6 as ReLU", err)
    sim = QuantizationSimModel(model, (xs[0],), quant_scheme="sqnr")
    sim.compute_encodings(eq, xs)
    corrected = correct_bias(sim, eq, xs)
    changed = [k for k in eq if not torch.equal(eq[k], corrected[k])]
    assert changed, "correct_bias changed no bias"
    metrics["ptq_mobilenet_v2_corrected_biases"] = len(changed)
    t = step("mobilenet_v2_equalize_calibrate_correct_bias", t)
    fresh, m = export_load(torch, sim, model, xs[0], "mobilenet_v2_ptq")
    metrics["ptq_mobilenet_v2_export_load"] = m
    with torch.no_grad():
        ref = model(x32)
    regular = sum(o.type == "conv" for o in sim.graph.ops)
    low = lower_to_int(fresh, corrected, mode="w8a8")
    m, counts = ptq_lowered(torch, tim, counters, low, corrected, x32, ref,
                            {"q8_gemm": regular, "w8_gemm": 1})
    paths["ptq_mobilenet_v2"] = counts
    metrics["ptq_mobilenet_v2_w8a8"] = m
    log(f"[ptq] MobileNetV2: equalized logits within {err:.3e} of the "
        f"original's with ReLU6 read as ReLU (limit {TOL_EQUALIZED}), "
        f"{metrics['ptq_mobilenet_v2_equalized_rel_err']:.3e} with ReLU6 "
        "(CLE scales through ReLU6 as through ReLU, as the JAX package's "
        f"does); {len(changed)} biases corrected, export / load bit "
        f"for bit; w8a8, 32 images: {m['device_ms']:.2f} ms device, "
        f"launches {counts}, kernels vs plain "
        f"{m['logits_vs_plain_rel_err']:.3e}; vs float: rel MSE "
        f"{m['rel_mse_vs_float']:.4e}, top-1 {m['top1_vs_float']:.3f}")
    t = step("mobilenet_v2_export_load_lower", t)
    del sim, fresh, low, eq, corrected, ref, xs, x32
    torch.cuda.empty_cache()

    # --- SeqMSE on a float Llama-3-8B, 2 layers at full width
    cfg = dataclasses.replace(TransformerConfig.llama3_8b(), n_layers=2)
    model = float_llama(torch, cfg, seed=3)
    toks = [torch.randint(0, cfg.vocab_size, (1, 512), generator=g,
                          device="cuda") for _ in range(2)]
    sim = QuantizationSimModel(model, (toks[0],),
                               config=QuantSimConfig.per_channel_default())
    sim.compute_encodings(None, toks)
    # the masked-score quantizers flatten attention (ROADMAP queue C):
    # off, as in the lowering phase's comparison
    for o in sim.graph.ops_of_type("select_n"):
        if any(c.type == "softmax" for c in o.output.consumers):
            sim.set_quantizer_enabled(o.name, False)
    with torch.no_grad():
        ref = model(toks[0])
    err = lambda: (sim.quantized_fn(None, toks[0]) - ref).abs().mean().item()
    err_before = err()
    t = step("seq_mse_calibrate", t)
    done = apply_seq_mse(sim, None, toks, num_candidates=20)
    t = step("seq_mse", t)
    err_after = err()
    n_lin = 7 * cfg.n_layers + 1
    assert len(done) == n_lin, done
    assert err_after <= SEQ_MSE_BOUND * err_before, (err_after, err_before)
    low = lower_to_int(sim, None, mode="w8")
    params = sim.params
    out, counts, host_ms, dev_ms, top = forward_stats(
        torch, lambda: low(params, toks[0]), counters)
    assert counts == LOWER_MODES["w8"][2](n_lin), counts
    from aimet_tpu_torch.quantsim import lowering as lw
    with plain_lowering(lw, tim):
        plain = low(params, toks[0])
    m = {"layers": cfg.n_layers, "linears": len(done),
         "err_before": err_before, "err_after": err_after,
         "w8_device_ms": dev_ms, "w8_host_ms": host_ms,
         "logits_vs_plain_rel_err": rel_err(out, plain),
         "w8_rel_mse_vs_float": (((out - ref) ** 2).mean()
                                 / (ref ** 2).mean()).item()}
    assert m["logits_vs_plain_rel_err"] < TOL_LOGITS, m
    paths["ptq_seq_mse"] = counts
    metrics["ptq_seq_mse"] = m
    log(f"[ptq] SeqMSE on Llama-3-8B (2 layers, 20 candidates, 2 x 512 "
        f"tokens): {len(done)} linears, logits' mean error {err_before:.4e} "
        f"-> {err_after:.4e} (bound {SEQ_MSE_BOUND}x); w8 forward "
        f"{dev_ms:.2f} ms device, launches {counts}, kernels vs plain "
        f"{m['logits_vs_plain_rel_err']:.3e}")
    step("seq_mse_lower", t)
    del sim, low, model, out, plain, ref
    torch.cuda.empty_cache()
    return metrics, paths


# QAT + KD as examples/llm_qat_kd.py sets it up; its optimizer steps
QAT_STEPS = 4
QAT_LR = 1e-4
U32 = 2.0 ** -24


def lowered_vs_plain(torch, tim, counters, low, params, x, expect):
    """One lowered LLM forward with the launch counts set to 0 just before
    and read just after (exactly ``expect``), against the same forward
    through the plain versions (within TOL_LOGITS). Returns (out, metrics,
    counts)."""
    from aimet_tpu_torch.quantsim import lowering as lw
    out, counts, host_ms, dev_ms, top = forward_stats(
        torch, lambda: low(params, x), counters)
    assert counts == expect, counts
    assert torch.isfinite(out).all()
    with plain_lowering(lw, tim):
        plain = low(params, x)
    m = {"host_ms": host_ms, "device_ms": dev_ms, "launches": counts,
         "logits_vs_plain_rel_err": rel_err(out, plain),
         "top1_vs_plain": (out.argmax(-1) == plain.argmax(-1)).float()
         .mean().item(),
         "top_kernels": top}
    assert m["logits_vs_plain_rel_err"] < TOL_LOGITS, m
    return out, m, counts


def range_grad_check(torch, w, mn, mx, spec, g):
    """The Function's (min, max) gradients of sum(qdq(w) * up) on the card
    in f32 against the reference formula (aimet_tpu/quantization/
    grads.py:90-106) in f64 on the same tensors. Tolerance: sqrt(n) u
    sum m_i, the statistical bound of an f32 sum of n terms (m_i each
    term's magnitude before its own cancellation; the worst case n u is
    vacuous at n = 5e8). Returns the metrics."""
    from aimet_tpu_torch.quantization.grads import quantize_dequantize
    up = torch.randn(w.shape, generator=g, device="cuda")
    A = mn.detach().clone().requires_grad_(True)
    B = mx.detach().clone().requires_grad_(True)
    grid = dict(bitwidth=spec.bitwidth, symmetric=spec.symmetric,
                strict_symmetric=spec.strict_symmetric,
                unsigned_symmetric=spec.unsigned_symmetric)
    out = quantize_dequantize(w.detach(), A, B, learn_range=True, **grid)
    torch.autograd.backward(out, up)
    del out
    x, up = w.detach().double(), up.double()
    lo, hi = mn.detach().double(), mx.detach().double()
    ns = float(2 ** spec.bitwidth - 1 - (
        1 if spec.symmetric and spec.strict_symmetric else 0))
    if not (spec.symmetric and not spec.unsigned_symmetric):
        raise NotImplementedError("the check covers signed-symmetric grids")
    delta = hi / math.floor(ns / 2)
    offset = -float(math.ceil(ns / 2))
    xr = torch.round(x / delta) - offset
    xq = torch.clamp(xr, 0.0, ns)
    mask = ((xr >= 0) & (xr <= ns)).double()
    want = ((xq + offset) * up - mask * (x / delta) * up).sum() \
        / math.floor(ns / 2)
    mag = ((xq + offset).abs() + mask * (x / delta).abs()).mul_(
        up.abs()).sum() / math.floor(ns / 2)
    tol = math.sqrt(x.numel()) * U32 * mag.item()
    err_max = abs(B.grad.double().item() - want.item())
    err_min = abs(A.grad.double().item() + want.item())
    m = {"n": x.numel(), "dmax": B.grad.item(), "dmax_f64": want.item(),
         "err": max(err_max, err_min), "tol": tol,
         "sum_magnitudes": mag.item()}
    assert m["err"] <= tol, m
    return m


def qat_kd(torch, tim, counters, g, cfg, model, smi):
    """QAT + KD on the float Llama (``examples/llm_qat_kd.py``'s set-up):
    a sqnr sim with 4-bit parameters and 8-bit outputs calibrated on 2
    batches of 1 x 512, the student from the teacher's weights, QAT_STEPS
    AdamW steps on one 2 x 256 batch; then the encodings folded back and
    the ``w4a8`` forward of 8 x 512 through K1 + K2."""
    import functools
    from aimet_tpu_torch import QuantizationSimModel, lower_to_int
    from aimet_tpu_torch.algorithms import (KDConfig, init_kd_state,
                                            make_qat_kd_step, shift_labels)
    metrics = {}
    toks = lambda b, n: torch.randint(0, cfg.vocab_size, (b, n),
                                      generator=g, device="cuda")
    calib = [toks(1, 512) for _ in range(2)]
    train = toks(2, 256)
    kw = dict(quant_scheme="sqnr", default_param_bw=4, default_output_bw=8)
    t = time.perf_counter()
    cal = QuantizationSimModel(model, (calib[0],), **kw)
    cal.compute_encodings(None, calib)
    # the training batch's shape: a sim traces its shapes, so a second
    # sim of the same model takes the calibrated encodings by name
    sim = QuantizationSimModel(model, (train,), **kw)
    assert set(sim.quantizers) == set(cal.quantizers)
    for name, enc in cal.encodings.items():
        sim.set_encoding(name, enc)
    torch.cuda.synchronize()
    metrics["calibrate_s"] = time.perf_counter() - t

    teacher = {k: v.detach() for k, v in model.named_parameters()}
    opt = functools.partial(torch.optim.AdamW, lr=QAT_LR)
    kcfg = KDConfig(temperature=2.0, alpha=0.5, enc_lr=1e-5)
    state0, step = make_qat_kd_step(
        sim, lambda p, x: torch.func.functional_call(model, p, (x,)), opt,
        kcfg)
    state = init_kd_state(state0, teacher, opt)
    labels = shift_labels(train)
    enc0 = {k: (a.clone(), b.clone()) for k, (a, b) in state.enc.items()}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    for i in range(QAT_STEPS):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        state, loss = step(state, teacher, train, labels)
        e1.record()
        e1.synchronize()
        step_ms.append(e0.elapsed_time(e1))
        losses.append(loss.item())
        log(f"[qat] step {i}: loss {losses[-1]:.6f}, {step_ms[-1]:.1f} ms "
            "(CUDA events)")
    peak = torch.cuda.max_memory_allocated() / 1e9
    moved = max(max((a - enc0[k][0]).abs().max().item(),
                    (b - enc0[k][1]).abs().max().item())
                for k, (a, b) in state.enc.items())
    metrics.update(losses=losses, step_ms=step_ms,
                   median_step_ms=sorted(step_ms)[len(step_ms) // 2],
                   peak_gb=peak, max_encoding_move=moved,
                   quantizers=len(state.enc))
    assert all(math.isfinite(v) for v in losses), losses
    assert losses[-1] < losses[0], losses
    assert moved > 0
    log(f"[qat] QAT + KD, 2 x 256 tokens, AdamW lr {QAT_LR}: losses "
        + ", ".join(f"{v:.6f}" for v in losses)
        + f"; median step {metrics['median_step_ms']:.1f} ms (CUDA events),"
        f" peak {peak:.2f} GB allocated; largest encoding move {moved:.3e}"
        f" over {len(state.enc)} quantizers; {smi}")

    params = state.params
    enc = state.enc
    del state, step, state0, enc0
    torch.cuda.empty_cache()
    for name in ("lm_head.kernel", "layer_0.mlp.w_down.kernel"):
        m = range_grad_check(torch, params[name], *enc[name],
                             sim.quantizers[name], g)
        metrics[f"range_grad_{name}"] = m
        log(f"[qat] range-learning gradient of {name} (n {m['n']}): "
            f"d/dmax {m['dmax']:.6e} against {m['dmax_f64']:.6e} in f64, "
            f"|err| {m['err']:.3e} (tolerance {m['tol']:.3e})")
        torch.cuda.empty_cache()

    sim.update_encodings_from_qat(enc)
    n_lin = 7 * cfg.n_layers + 1
    low = lower_to_int(sim, params, mode="w4a8")
    x = toks(8, 512)
    out, m, counts = lowered_vs_plain(torch, tim, counters, low, params, x,
                                      LOWER_MODES["w4a8"][2](n_lin))
    # against the sim's forward with only the linears' weight quantizers
    # on (the same 4-bit grids; the lowered model quantizes the linears'
    # inputs per row and leaves the embedding and the norms float)
    for name, e in sim.encodings.items():
        cal.set_encoding(name, e)
    kernels = [o.param_products["kernel"].param_path
               for o in cal.graph.ops_of_type("linear")]
    q = cal.quantized_fn_subset(params, x[:1], enabled=kernels)
    m["vs_quantized_fn_rel_err"] = rel_err(out[:1], q)
    metrics["w4a8"] = m
    log(f"[qat] w4a8 forward 8 x 512 after QAT: {m['device_ms']:.2f} ms "
        f"device, launches {counts}, kernels vs plain "
        f"{m['logits_vs_plain_rel_err']:.3e}; vs the sim's forward with the "
        f"linears' weights quantized (1 x 512) "
        f"{m['vs_quantized_fn_rel_err']:.3e}")
    assert m["vs_quantized_fn_rel_err"] < TOL_LOGITS, m
    del low, out, q, params, enc, sim, cal
    torch.cuda.empty_cache()
    return metrics, counts


@contextlib.contextmanager
def f32_compute(model):
    """The model computing in f32: each module's ``dtype`` and its
    config's."""
    import dataclasses
    import torch
    saved = []
    for m in model.modules():
        for attr in ("dtype", "cfg"):
            v = getattr(m, attr, None)
            if isinstance(v, torch.dtype):
                saved.append((m, attr, v))
                setattr(m, attr, torch.float32)
            elif dataclasses.is_dataclass(v) and hasattr(v, "dtype"):
                saved.append((m, attr, v))
                setattr(m, attr, dataclasses.replace(v, dtype=torch.float32))
    try:
        yield
    finally:
        for m, attr, v in saved:
            setattr(m, attr, v)


def llm_ptq(torch, tim, counters, g, cfg, model):
    """GPTQ (4-bit per channel, all linears), GPTVQ (layer 0's attention
    linears) and SmoothQuant on the float Llama; GPTQ lowered in ``w4``
    and SmoothQuant in ``w8a8``. Returns (metrics, counts by path)."""
    from aimet_tpu_torch import (QuantizationSimModel, QuantSimConfig,
                                 lower_to_int)
    from aimet_tpu_torch.algorithms import (GPTVQParameters, apply_gptq,
                                            apply_gptvq, apply_smooth_quant)
    from aimet_tpu_torch.algorithms.gptq import _layer_input_2d
    from aimet_tpu_torch.quantization.grads import quantize_dequantize
    metrics, paths = {}, {}
    toks = lambda b: torch.randint(0, cfg.vocab_size, (b, 512), generator=g,
                                   device="cuda")
    calib, held, x8 = [toks(1) for _ in range(2)], toks(1), toks(8)
    n_lin = 7 * cfg.n_layers + 1
    params = {k: v.detach() for k, v in model.named_parameters()}

    # --- GPTQ
    t = time.perf_counter()
    sim = QuantizationSimModel(model, (calib[0],), default_param_bw=4,
                               config=QuantSimConfig.per_channel_default())
    sim.compute_encodings(None, calib)
    for o in sim.graph.ops_of_type("select_n"):     # as in SeqMSE's phase
        if any(c.type == "softmax" for c in o.output.consumers):
            sim.set_quantizer_enabled(o.name, False)
    torch.cuda.synchronize()
    t_cal = time.perf_counter() - t
    timings = {}
    t = time.perf_counter()
    new = apply_gptq(sim, params, calib, block_size=128, timings=timings)
    torch.cuda.synchronize()
    t_gptq = time.perf_counter() - t
    linears = sim.graph.ops_of_type("linear")
    assert sorted(timings) == sorted(o.name for o in linears), timings
    # each linear's output error ||X W - X Q|| against nearest rounding on
    # the same frozen grid: on the calibration batches (what GPTQ
    # minimizes: the inputs it saw) and on a held-out batch
    errs = {o.name: {"calib": [0.0, 0.0], "held_out": [0.0, 0.0]}
            for o in linears}
    names = [o.inputs[0].name for o in linears]
    for tag, batches in (("calib", calib), ("held_out", [held])):
        for b in batches:
            caps = sim.collect_activations(new, (b,), names, "quantized")
            for o in linears:
                kp = o.param_products["kernel"].param_path
                w, spec = params[kp], sim.quantizers[kp]
                e = sim.encodings[kp]
                shape = [1] * w.dim()
                shape[spec.channel_axis] = -1
                rtn = quantize_dequantize(
                    w, e.min.reshape(shape), e.max.reshape(shape),
                    bitwidth=spec.bitwidth, symmetric=spec.symmetric)
                X = _layer_input_2d(sim.graph, o, caps[o.inputs[0].name])
                for i, qw in enumerate((new[kp], rtn)):
                    errs[o.name][tag][i] += (X @ (w - qw)).square().sum() \
                        .item()
            del caps
    ratio = {k: {tag: (v[tag][0] / v[tag][1]) ** 0.5 for tag in v}
             for k, v in errs.items()}
    metrics["gptq"] = {"calibrate_s": t_cal, "gptq_s": t_gptq,
                       "linear_s": timings, "error_ratio": ratio}
    log(f"[gptq] 4-bit per channel, block 128, 2 x 512 tokens: {t_gptq:.2f}"
        f" s for {len(timings)} linears; seconds by linear: "
        + ", ".join(f"{k} {v:.2f}" for k, v in timings.items()))
    log("[gptq] ||X W - X Q|| / nearest rounding's, calibration | held-out: "
        + ", ".join(f"{k} {r['calib']:.3f} | {r['held_out']:.3f}"
                    for k, r in ratio.items()))
    bad = {k: r for k, r in ratio.items() if r["calib"] > 1.0}
    assert not bad, ("GPTQ worse than nearest rounding on its own inputs",
                     bad)
    low = lower_to_int(sim, new, mode="w4")
    _, m, counts = lowered_vs_plain(torch, tim, counters, low, new, x8,
                                    LOWER_MODES["w4"][2](n_lin))
    paths["gptq"] = counts
    metrics["gptq"]["w4"] = m
    log(f"[gptq] w4 forward 8 x 512: {m['device_ms']:.2f} ms device, "
        f"launches {counts}, kernels vs plain "
        f"{m['logits_vs_plain_rel_err']:.3e}")
    del low, new

    # --- GPTVQ on layer 0's attention linears
    t = time.perf_counter()
    attn = [o.name for o in linears[:4]]
    vq = apply_gptvq(sim, params, calib, GPTVQParameters(), op_names=attn)
    torch.cuda.synchronize()
    t_vq = time.perf_counter() - t
    with torch.no_grad():
        ref = model(calib[0])
    out = sim.fp_fn(vq, calib[0])
    rel = ((out - ref).abs().mean() / (ref.abs().mean() + 1e-9)).item()
    changed = [o.param_products["kernel"].param_path for o in linears[:4]]
    uniq = {k: torch.unique(vq[k]).numel() for k in changed}
    metrics["gptvq"] = {"s": t_vq, "rel_err": rel, "unique": uniq}
    log(f"[gptvq] {attn} (2-d vectors, 64 centroids a block of 128 "
        f"columns): {t_vq:.2f} s; float logits' mean error {rel:.4f} of "
        f"their mean; unique values {uniq}")
    assert rel < 0.5, rel
    for k in changed:
        assert not torch.equal(vq[k], params[k]), k
        assert uniq[k] < vq[k].numel() / 2, (k, uniq[k])
    del vq, out, sim
    torch.cuda.empty_cache()

    # --- SmoothQuant
    t = time.perf_counter()
    smoothed, info = apply_smooth_quant(model, (calib[0],), None, calib,
                                        alpha=0.5)
    torch.cuda.synchronize()
    t_sq = time.perf_counter() - t
    assert len(info) == 2 * cfg.n_layers + 1, list(info)
    # float exactness is a property of the parameters: held with the
    # linears computed in f32 (the model's own bf16 rounds the rescaled
    # weights apart), at tests/test_smooth_quant.py's transformer bound
    with f32_compute(model), torch.no_grad():
        ref = model(calib[0])
        got = torch.func.functional_call(model, smoothed, (calib[0],))
    excess = ((got - ref).abs() - (5e-5 + 5e-4 * ref.abs())).max().item()
    assert excess <= 0, excess
    sim = QuantizationSimModel(model, (calib[0],))
    sim.compute_encodings(smoothed, calib)
    low = lower_to_int(sim, smoothed, mode="w8a8")
    assert not low.downgraded_ops, low.downgraded_ops
    _, m, counts = lowered_vs_plain(torch, tim, counters, low, smoothed, x8,
                                    LOWER_MODES["w8a8"][2](n_lin))
    paths["smooth_quant"] = counts
    metrics["smooth_quant"] = {
        "s": t_sq, "sites": len(info), "float_rel_err": rel_err(got, ref),
        "scale_spread": {k: (v.max() / v.min()).item()
                         for k, v in info.items()}, "w8a8": m}
    log(f"[smooth_quant] {len(info)} sites in {t_sq:.2f} s; float logits "
        f"within {metrics['smooth_quant']['float_rel_err']:.3e} of their "
        f"max; w8a8 forward 8 x 512: {m['device_ms']:.2f} ms device, "
        f"launches {counts}, kernels vs plain "
        f"{m['logits_vs_plain_rel_err']:.3e}")
    del low, smoothed, sim, got, ref
    torch.cuda.empty_cache()
    return metrics, paths


def cnn_bnre_analyzer(torch, g, models):
    """BN re-estimation on the ResNet-50 (2 batches of 32 at 224 x 224,
    the quantized forward) against the same statistics in f64 of the
    captured BN inputs (tolerance: an f32 sum of n terms, n u sum|x|, and
    of x^2 for the variance); QuantAnalyzer on the MobileNetV2 (eval:
    top-1 agreement with the float logits on one batch of 32)."""
    import tempfile
    from aimet_tpu_torch import QuantizationSimModel
    from aimet_tpu_torch.algorithms import QuantAnalyzer, reestimate_bn_stats
    metrics = {}
    model = models["resnet50"]
    xs = resnet_inputs(torch, g, 2)
    sim = QuantizationSimModel(model, (xs[0],))
    sim.compute_encodings(None, xs)
    t = time.perf_counter()
    new = reestimate_bn_stats(sim, None, xs)
    torch.cuda.synchronize()
    t_bn = time.perf_counter() - t
    bns = sim.graph.ops_of_type("batchnorm")
    names = [o.inputs[0].name for o in bns]
    s1 = {n: 0.0 for n in names}
    s2, sa = dict(s1), dict(s1)
    count = 0
    for x in xs:
        caps = sim.collect_activations(None, (x,), names, "quantized")
        for n in names:
            c = caps[n].double()
            s1[n] = s1[n] + c.sum(dim=(0, 2, 3))
            s2[n] = s2[n] + c.square().sum(dim=(0, 2, 3))
            sa[n] = sa[n] + c.abs().sum(dim=(0, 2, 3))
        count += caps[names[0]].shape[0]
        del caps
    worst = 0.0
    for o, n in zip(bns, names):
        roots = o.attrs["param_roots"]
        mp = next(p for p in roots if p.endswith("mean"))
        vp = next(p for p in roots if p.endswith("var"))
        hw = new[mp].numel()
        N = count * (sim.graph.products[o.inputs[0].node].shape[2]
                     * sim.graph.products[o.inputs[0].node].shape[3])
        mean = s1[n] / N
        var = s2[n] / N - mean ** 2
        tol_m = N * U32 * sa[n] / N
        tol_v = N * U32 * s2[n] / N + 2 * tol_m * mean.abs()
        err_m = (new[mp].double() - mean).abs()
        err_v = (new[vp].double() - var).abs()
        assert (err_m <= tol_m + 1e-30).all(), (o.name, err_m.max())
        assert (err_v <= tol_v + 1e-30).all(), (o.name, err_v.max())
        worst = max(worst, (err_m / mean.abs().clamp(min=1e-12)).max()
                    .item() if hw else 0.0)
        worst = max(worst, (err_v / var.abs().clamp(min=1e-12)).max().item())
    metrics["bn_reestimation"] = {"s": t_bn, "bns": len(bns),
                                  "max_rel_err_vs_f64": worst}
    log(f"[bn re-estimation] ResNet-50, {len(bns)} BNs, 2 x 32 images: "
        f"{t_bn:.2f} s; means / variances against f64 of the captured "
        f"inputs: max relative error {worst:.3e}")
    del sim, new, xs, s1, s2, sa

    model = models["mobilenet_v2"]
    x = resnet_inputs(torch, g, 1)[0]
    sim = QuantizationSimModel(model, (x,))
    sim.compute_encodings(None, [x])
    with torch.no_grad():
        top = model(x).argmax(-1)
    t = time.perf_counter()
    res = QuantAnalyzer(sim, None, lambda f: (
        f(x).argmax(-1) == top).float().mean().item()).analyze(
        mse_batches=[x])
    t_qa = time.perf_counter() - t
    n_q = len(res.per_quantizer_sensitivity)
    assert n_q == len(sim.encodings) and res.fp_accuracy == 1.0
    assert all(0.0 <= v <= 1.0 for v in res.per_quantizer_sensitivity.values())
    with tempfile.TemporaryDirectory() as d:
        QuantAnalyzer.export_html(res, os.path.join(d, "report.html"))
        assert "Quantization analysis" in open(
            os.path.join(d, "report.html")).read()
    worst = sorted(res.per_quantizer_sensitivity.items(),
                   key=lambda kv: -kv[1])[:3]
    metrics["quant_analyzer"] = {
        "s": t_qa, "quantizers": n_q, "quantized": res.quantized_accuracy,
        "param_only": res.param_only_accuracy,
        "act_only": res.act_only_accuracy, "most_hurting": worst}
    log(f"[quant analyzer] MobileNetV2, {n_q} quantizers swept in "
        f"{t_qa:.2f} s; top-1 agreement quantized "
        f"{res.quantized_accuracy:.4f}, params only "
        f"{res.param_only_accuracy:.4f}, activations only "
        f"{res.act_only_accuracy:.4f}; best when disabled: {worst}")
    del sim
    torch.cuda.empty_cache()
    return metrics


def qat(torch, tim, counters, g, models, smi):
    """Phase 8: QAT + KD, GPTQ / GPTVQ and SmoothQuant on a float
    Llama-3-8B at 2 layers (full width, seed 3: the weights SeqMSE's phase
    draws); BN re-estimation and QuantAnalyzer on the CNN phase's models.
    Returns (metrics, launches of each measured forward by path)."""
    import dataclasses
    from aimet_tpu_torch.models.transformer import TransformerConfig
    metrics, paths = {}, {}
    cfg = dataclasses.replace(TransformerConfig.llama3_8b(), n_layers=2)
    model = float_llama(torch, cfg, seed=3)
    t = time.perf_counter()
    m, counts = qat_kd(torch, tim, counters, g, cfg, model, smi)
    metrics["qat_kd"] = m
    paths["qat_kd"] = counts
    log(f"[qat] QAT + KD took {time.perf_counter() - t:.1f} s; {smi}")
    # QAT trained copies: the float model's own weights are as drawn
    t = time.perf_counter()
    m, p = llm_ptq(torch, tim, counters, g, cfg, model)
    metrics.update(m)
    paths.update(p)
    log(f"[qat] GPTQ, GPTVQ and SmoothQuant took "
        f"{time.perf_counter() - t:.1f} s; {smi}")
    del model
    torch.cuda.empty_cache()
    t = time.perf_counter()
    metrics.update(cnn_bnre_analyzer(torch, g, models))
    log(f"[qat] BN re-estimation and QuantAnalyzer took "
        f"{time.perf_counter() - t:.1f} s; {smi}")
    return metrics, paths


# phase 9: AutoQuant + AMP on ResNet-50, PEFT on a 2-layer Llama-3-8B
AQ_ADA_ITERS = 100
# AMP's budget (-relative MSE of the logits against the float model's, on
# a held-out batch of 8): PERF.md §6 says why this value
AQ_ALLOWED_DROP = 0.05
# the lowered AutoQuant and AMP models against their sims' quantized
# forwards, as the relative MSE of the logits: the 4-bit convs lower as
# w4a8, whose activations are quantized per tensor at run time, symmetric,
# where the sim holds static asymmetric 8-bit grids. The card read
# 3.80e-2 and 3.99e-2 on the AdaRound model: 2.5 times that; a lowering
# that ignores AMP's bitwidths must read above it (PERF.md §6)
TOL_AQ_VS_SIM = 0.1
TOL_LORA_FORMS = 1e-4    # unmerged against merged LoRA forward (f32)
# LoRA: rank, alpha, AdamW's rate, steps; the adapter sim's activations at
# 16 bits (W4A16, the LLM LoRA set-up: an 8-bit staircase hides steps this
# small from the loss)
PEFT_RANK, PEFT_ALPHA, PEFT_LR, PEFT_STEPS, PEFT_OUT_BW = 8, 16.0, 3e-4, 3, 16
# the LoRA model's lowered and served logits (max |diff| / max |ref|).
# The w4 lowering (the 4-bit codes, float activations) against the float
# model on the weights the codes stand for, in f32. Against
# quantized_lora_fn: the w4a8 lowering and the served prefill quantize
# activations per row to INT8 (K1), which the sim does not: in f32 on
# the same codes that alone read 3.49e-2 on the card, the lowering
# 3.0-3.4e-2, the served prefill 3.9-4.4e-2 (PERF.md §6): both held to
# TOL_LOGITS, the limit phase 8 holds its lowered forward to
TOL_PEFT_WEIGHTS = 1e-4
TOL_PEFT_LOWERED = TOL_PEFT_SERVED = TOL_LOGITS


@contextlib.contextmanager
def stage_clock(targets, times):
    """Add each call's seconds (synchronized) to ``times[label]``;
    ``targets``: (object, attribute, label) whose callable is wrapped."""
    import torch
    saved = []
    for obj, attr, label in targets:
        fn = getattr(obj, attr)

        def wrapped(*a, fn=fn, label=label, **k):
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            times[label] = times.get(label, 0.0) + time.perf_counter() - t
            return out
        saved.append((obj, attr, fn))
        setattr(obj, attr, wrapped)
    try:
        yield times
    finally:
        for obj, attr, fn in saved:
            setattr(obj, attr, fn)


def amp_autoquant(torch, tim, counters, g, model, smi):
    """Phase 9a: AutoQuantWithAutoMixedPrecision on the CNN phase's
    ResNet-50 (1000 classes, 224 x 224): min-max, 4-bit per-channel
    parameters, 8-bit outputs, 2 calibration batches of 8 images,
    AdaRound at AQ_ADA_ITERS iterations, AMP candidates fp16 > (8, 8) > (8, 4) scored by minus the
    relative MSE of the logits against the float model's on a held-out
    batch of 8; reduce_convert_ops; lower_to_int(mode="auto") and one
    forward of the held-out batch with the launch counts read (against
    the plain versions within TOL_CNN_LOGITS, against the sim's quantized
    forward by relative MSE within TOL_AQ_VS_SIM); the same optimize
    again on the same cache directory (no AdaRound layer optimized, the
    same best stage, encodings and weights bit for bit); ArchChecker on
    the graph. Returns (metrics, launches of the lowered forward)."""
    import collections
    import dataclasses
    import shutil
    from aimet_tpu_torch import QuantSimConfig, lower_to_int
    from aimet_tpu_torch.algorithms import (AdaroundParameters, ArchChecker,
                                            AutoQuantWithAutoMixedPrecision)
    from aimet_tpu_torch.algorithms import adaround as ada
    from aimet_tpu_torch.algorithms import amp
    from aimet_tpu_torch.algorithms import auto_quant as taq
    from aimet_tpu_torch.ops import int_conv as tic
    from aimet_tpu_torch.quantsim import lowering as lw
    params = {k: v.detach() for k, v in model.named_parameters()}
    calib = resnet_inputs(torch, g, 2, batch=8)
    held = resnet_inputs(torch, g, 1, batch=8)[0]
    with torch.no_grad():
        ref = model(held)
    evals = [0]

    def eval_fn(forward):
        evals[0] += 1
        out = forward(held)
        return -(((out - ref) ** 2).mean() / (ref ** 2).mean()).item()

    cands = [amp.fp16_candidate(), amp.Candidate(8, 8), amp.Candidate(8, 4)]
    cache_dir = os.path.join(ROOT, "build", "autoquant_cache")
    shutil.rmtree(cache_dir, ignore_errors=True)

    def optimize():
        aq = AutoQuantWithAutoMixedPrecision(
            model, (calib[0],), params, calib, eval_fn,
            config=QuantSimConfig.per_channel_default(),
            quant_scheme="minmax", default_param_bw=4, default_output_bw=8,
            adaround_params=AdaroundParameters(num_batches=2,
                                               num_iterations=AQ_ADA_ITERS),
            amp_candidates=cands, cache_dir=cache_dir)
        times, evals[0] = {}, 0
        targets = [(taq, "equalize_model", "cle"),
                   (taq, "apply_adaround", "adaround"),
                   (aq, "_calibrated_eval", "calibrate_and_eval"),
                   (amp, "choose_mixed_precision", "amp")]
        layers = [0]
        run = ada._RoundingOptimizer.run

        def counted(self, *a, **k):
            layers[0] += 1
            return run(self, *a, **k)
        ada._RoundingOptimizer.run = counted
        try:
            with stage_clock(targets, times):
                t = time.perf_counter()
                res = aq.optimize(allowed_accuracy_drop=AQ_ALLOWED_DROP)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
        finally:
            ada._RoundingOptimizer.run = run
        return aq, res, wall, times, layers[0], evals[0]

    aq, res, wall, times, n_layers, n_evals = optimize()
    a = aq.amp_result
    assert a is not None and [s.name for s in res.history] == \
        ["fp32", "quantsim", "cle", "adaround", "amp"], res.history
    kinds = collections.Counter(
        f"{c.act_dtype}{c.act_bw}/{c.param_dtype}{c.param_bw}"
        for c in a.group_bitwidths.values())
    m = {"wall_s": wall, "stage_s": times, "adaround_layers": n_layers,
         "evals": n_evals, "history": [(s.name, s.accuracy)
                                       for s in res.history],
         "best_stage": res.best_stage, "amp_groups": dict(kinds),
         "amp_baseline": a.baseline_accuracy, "amp_final": a.final_accuracy,
         "pareto_points": len(a.pareto_front)}
    log(f"[amp] AutoQuant + AMP on ResNet-50: {wall:.1f} s ({smi}); stages "
        + ", ".join(f"{k} {v:.1f} s" for k, v in times.items())
        + f"; {n_layers} AdaRound layers; {n_evals} evals; history "
        + ", ".join(f"{n} {v:.5f}" for n, v in m["history"])
        + f"; best {res.best_stage}; AMP groups {dict(kinds)}, baseline "
        f"{a.baseline_accuracy:.5f} -> {a.final_accuracy:.5f}, "
        f"{len(a.pareto_front)} pareto points")
    # AdaRound froze the 4-bit weight grids, so AMP's flips of them change
    # nothing here: amp_free below runs AMP on free grids
    assert n_layers == 54, n_layers

    # the same optimize again: every stage from the cache
    aq2, res2, wall2, times2, n_layers2, n_evals2 = optimize()
    same_enc = res2.sim.export_encodings() == res.sim.export_encodings()
    same_w = res2.params.keys() == res.params.keys() and all(
        torch.equal(res2.params[k], res.params[k]) for k in res.params)
    m.update(resumed_wall_s=wall2, resumed_stage_s=times2,
             resumed_adaround_layers=n_layers2, resumed_evals=n_evals2,
             resumed_same_encodings=same_enc, resumed_same_weights=same_w)
    log(f"[amp] resumed from {cache_dir}: {wall2:.1f} s against {wall:.1f} "
        f"s ({smi}); stages " + ", ".join(f"{k} {v:.1f} s"
                                         for k, v in times2.items())
        + f"; {n_layers2} AdaRound layers optimized, {n_evals2} evals; best "
        f"{res2.best_stage}; encodings bit for bit {same_enc}, weights bit "
        f"for bit {same_w}")
    assert n_layers2 == 0 and res2.best_stage == res.best_stage
    assert same_enc and same_w
    assert {g_: dataclasses.astuple(c)
            for g_, c in aq2.amp_result.group_bitwidths.items()} == \
        {g_: dataclasses.astuple(c) for g_, c in a.group_bitwidths.items()}
    del aq2, res2

    sim, p = res.sim, res.params
    co = amp.reduce_convert_ops(sim, a, cands)
    m.update(converts_before=co.converts_before,
             converts_after=co.converts_after, cost_ratio=co.cost_ratio)
    log(f"[amp] reduce_convert_ops: {co.converts_before} -> "
        f"{co.converts_after} convert ops, bit cost {co.cost_ratio:.4f} of "
        "the highest precision's")
    assert co.converts_after <= co.converts_before

    low = lower_to_int(sim, p, mode="auto")
    modes = collections.Counter(low.op_modes.values())
    m.update(lowered=len(low.lowered_ops), skipped=len(low.skipped_ops),
             downgraded=len(low.downgraded_ops), op_modes=dict(modes),
             int_flops_fraction=low.int_flops_fraction)
    out, counts, host_ms, dev_ms, top = forward_stats(
        torch, lambda: low(p, held), counters)
    assert torch.isfinite(out).all() and out.shape == ref.shape
    assert counts.get("q8_gemm", 0) > 0, counts
    fc_mode = low.op_modes.get("linear_0")
    fc_kernels = {"w8a8": ("w8a8_staticq",), "w4a8": ("act_quant",
                                                       "w4a8_gemm")}
    for k in fc_kernels.get(fc_mode, ()):
        assert counts.get(k, 0) > 0, (fc_mode, counts)
    with plain_lowering(lw, tim), plain_ops(tim, tic):
        plain = low(p, held)
    q = sim.quantized_fn(p, held)
    m.update(host_ms=host_ms, device_ms=dev_ms, launches=counts,
             logits_vs_plain_rel_err=rel_err(out, plain),
             vs_sim_rel_mse=(((out - q) ** 2).mean() / (q ** 2).mean())
             .item(), vs_sim_rel_err=rel_err(out, q),
             top1_vs_sim=(out.argmax(-1) == q.argmax(-1)).float().mean()
             .item(), fc_mode=fc_mode, **vs_float(out, ref))
    log(f"[amp] lower_to_int(auto): lowered {m['lowered']}, skipped "
        f"{m['skipped']}, downgraded {m['downgraded']}; modes {dict(modes)};"
        f" int_flops_fraction {low.int_flops_fraction:.6f}; forward 8 x 224 "
        f"x 224: {host_ms:.1f} ms host, {dev_ms:.2f} ms device ("
        + ", ".join(f"{k} {v:.2f}" for k, v in top) + f"); launches "
        f"{counts}; kernels vs plain {m['logits_vs_plain_rel_err']:.3e}; vs "
        f"the sim's quantized forward: rel MSE {m['vs_sim_rel_mse']:.3e}, "
        f"max {m['vs_sim_rel_err']:.3e}, top-1 {m['top1_vs_sim']:.3f}; vs "
        f"float: rel MSE {m['rel_mse_vs_float']:.3e} ({smi})")
    assert m["logits_vs_plain_rel_err"] < TOL_CNN_LOGITS, m
    assert m["vs_sim_rel_mse"] < TOL_AQ_VS_SIM, m

    found = collections.Counter(r.check
                                for r in ArchChecker.check_model(sim.graph))
    m["arch_checker"] = dict(found)
    log(f"[amp] ArchChecker on the ResNet-50 graph: {sum(found.values())} "
        "findings: " + ", ".join(f"{k} {v}" for k, v in found.items()))
    del low, out, plain, q, sim, res, aq
    shutil.rmtree(cache_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    m["free"], counts_free = amp_free(torch, tim, counters, model, params,
                                      calib, held, ref, eval_fn, evals, cands,
                                      smi)
    return m, {k: counts.get(k, 0) + counts_free.get(k, 0)
               for k in set(counts) | set(counts_free)}


def amp_free(torch, tim, counters, model, params, calib, held, ref, eval_fn,
             evals, cands, smi):
    """Phase 9a, second half: AMP where the weight grids are free, on the
    quantsim stage's sim (min-max, 4-bit per-channel parameters, 8-bit
    outputs, no AdaRound): ``choose_mixed_precision`` with AQ_ALLOWED_DROP
    must end with weighted groups at 8 bits and at 4, its fp16 baseline
    above the all-4-bit sim; ``reduce_convert_ops``; then the weighted
    group AMP found most sensitive at 4 bits set to fp16, so that
    ``lower_to_int(mode="auto")`` leaves its layers float (skipped_ops).
    The lowered forward against the plain versions (TOL_CNN_LOGITS) and
    against the sim (TOL_AQ_VS_SIM), and the all-4-bit lowering made
    before AMP, which ignores its bitwidths, against the same sim: above
    TOL_AQ_VS_SIM. Returns (metrics, launches of the lowered forward)."""
    import collections
    from aimet_tpu_torch import (QuantizationSimModel, QuantSimConfig,
                                 lower_to_int)
    from aimet_tpu_torch.algorithms import amp
    from aimet_tpu_torch.ops import int_conv as tic
    from aimet_tpu_torch.quantsim import lowering as lw
    rel_mse = lambda a, b: (((a - b) ** 2).mean() / (b ** 2).mean()).item()
    t = time.perf_counter()
    sim = QuantizationSimModel(
        model, (calib[0],), quant_scheme="minmax", default_param_bw=4,
        default_output_bw=8, config=QuantSimConfig.per_channel_default())
    sim.compute_encodings(params, calib)
    all4 = eval_fn(lambda x: sim.quantized_fn(params, x))
    with torch.no_grad():
        ignoring = lower_to_int(sim, params, mode="auto")(params, held)
    evals[0] = 0
    t_amp = time.perf_counter()
    a = amp.choose_mixed_precision(sim, params, cands, eval_fn,
                                   AQ_ALLOWED_DROP)
    torch.cuda.synchronize()
    amp_s = time.perf_counter() - t_amp
    groups = {g_.name: g_ for g_ in amp.find_quantizer_groups(sim)}
    weighted = {n: c for n, c in a.group_bitwidths.items()
                if groups[n].param_quantizers}
    kind = lambda c: f"{c.act_dtype}{c.act_bw}/{c.param_dtype}{c.param_bw}"
    kinds = collections.Counter(kind(c) for c in weighted.values())
    co = amp.reduce_convert_ops(sim, a, cands)
    m = {"amp_s": amp_s, "evals": evals[0], "all4": all4,
         "baseline": a.baseline_accuracy, "final": a.final_accuracy,
         "weighted_groups": dict(kinds), "groups": len(groups),
         "pareto_points": len(a.pareto_front),
         "converts_before": co.converts_before,
         "converts_after": co.converts_after, "cost_ratio": co.cost_ratio}
    log(f"[amp] AMP on the quantsim stage's sim (free 4-bit grids): "
        f"{amp_s:.1f} s, {evals[0]} evals ({smi}); all-4-bit {all4:.5f}, "
        f"fp16 baseline {a.baseline_accuracy:.5f} -> {a.final_accuracy:.5f};"
        f" weighted groups {dict(kinds)} of {len(groups)} groups; "
        f"{len(a.pareto_front)} pareto points; reduce_convert_ops "
        f"{co.converts_before} -> {co.converts_after}, bit cost "
        f"{co.cost_ratio:.4f}")
    assert a.baseline_accuracy > all4, m
    assert kinds.get("int8/int8") and kinds.get("int8/int4"), m

    # the weighted group most sensitive at 4 bits (phase 1) to fp16
    g16 = min((n for n in weighted if (n, cands[-1]) in a.phase1_scores),
              key=lambda n: a.phase1_scores[(n, cands[-1])])
    fp16 = cands[0]
    for n in groups[g16].act_quantizers:
        sim.set_quantizer_data_type(n, fp16.act_dtype, fp16.act_bw)
    for n in groups[g16].param_quantizers:
        sim.set_quantizer_data_type(n, fp16.param_dtype, fp16.param_bw)
    float_ops = sorted(o.name for o in sim.graph.ops if any(
        p.param_path in groups[g16].param_quantizers
        for p in o.param_products.values()))
    low = lower_to_int(sim, params, mode="auto")
    modes = collections.Counter(low.op_modes.values())
    m.update(fp16_group=g16, fp16_ops=float_ops,
             lowered=len(low.lowered_ops), skipped=sorted(low.skipped_ops),
             downgraded=len(low.downgraded_ops), op_modes=dict(modes),
             int_flops_fraction=low.int_flops_fraction)
    out, counts, host_ms, dev_ms, top = forward_stats(
        torch, lambda: low(params, held), counters)
    assert torch.isfinite(out).all() and out.shape == ref.shape
    with plain_lowering(lw, tim), plain_ops(tim, tic):
        plain = low(params, held)
    q = sim.quantized_fn(params, held)
    m.update(host_ms=host_ms, device_ms=dev_ms, launches=counts,
             logits_vs_plain_rel_err=rel_err(out, plain),
             vs_sim_rel_mse=rel_mse(out, q),
             ignoring_amp_vs_sim_rel_mse=rel_mse(ignoring, q),
             top1_vs_sim=(out.argmax(-1) == q.argmax(-1)).float().mean()
             .item(), wall_s=time.perf_counter() - t, **vs_float(out, ref))
    log(f"[amp] group {g16} ({', '.join(float_ops)}) set to fp16; "
        f"lower_to_int(auto): lowered {m['lowered']}, skipped "
        f"{m['skipped']}, downgraded {m['downgraded']}; modes {dict(modes)};"
        f" int_flops_fraction {low.int_flops_fraction:.6f}; forward 8 x 224 "
        f"x 224: {host_ms:.1f} ms host, {dev_ms:.2f} ms device ("
        + ", ".join(f"{k} {v:.2f}" for k, v in top) + f"); launches "
        f"{counts}; kernels vs plain {m['logits_vs_plain_rel_err']:.3e}; vs "
        f"the sim's quantized forward: rel MSE {m['vs_sim_rel_mse']:.3e} "
        f"(limit {TOL_AQ_VS_SIM}), top-1 {m['top1_vs_sim']:.3f}; the "
        f"all-4-bit lowering, ignoring AMP, against the same sim: rel MSE "
        f"{m['ignoring_amp_vs_sim_rel_mse']:.3e}; vs float: rel MSE "
        f"{m['rel_mse_vs_float']:.3e}; {m['wall_s']:.1f} s in all ({smi})")
    assert float_ops and set(float_ops) <= set(low.skipped_ops), m
    assert modes.get("w8a8") and modes.get("w4a8"), m
    assert counts.get("q8_gemm", 0) > 0, counts
    assert m["logits_vs_plain_rel_err"] < TOL_CNN_LOGITS, m
    assert m["vs_sim_rel_mse"] < TOL_AQ_VS_SIM, m
    assert m["ignoring_amp_vs_sim_rel_mse"] > TOL_AQ_VS_SIM, m
    del low, out, plain, q, sim, ignoring
    torch.cuda.empty_cache()
    return m, counts


def peft_llm(torch, tim, counters, g, cfg, model, smi, ops, qllm):
    """Phase 9b: LoRA on the float Llama-3-8B at 2 layers (full width):
    rank PEFT_RANK, alpha PEFT_ALPHA on every attention and MLP kernel; the
    adapter sim (min-max, 4-bit per-channel symmetric parameters,
    PEFT_OUT_BW-bit outputs) with ``set_bitwidth_for_lora_adapters(16, 16)``
    and
    ``freeze_base_model``, its adapter-path activation quantizers off
    (``disable_adapter_activation_quantizers``: their ranges were
    calibrated with B = 0); PEFT_STEPS AdamW steps on the
    adapters only through ``static_grid_qat_fn`` (next-token CE on one 1 x
    256 batch; the loss must fall every step; peak memory); the unmerged
    and merged forwards within TOL_LORA_FORMS (computed in f32); then the
    merged weights
    quantized for ``w4a8`` serving, a prefill of 256 tokens, one decode
    step at per-slot positions and ``generate`` of 8 with the launch counts
    read; against ``quantized_lora_fn`` on a base sim of the same grids
    (4-bit per-channel linear kernels only) the served prefill logits
    within TOL_PEFT_SERVED and the same merged weights lowered in ``w4a8``
    within TOL_PEFT_LOWERED, with the gap split into its parts
    (``peft_gap_split``; the ``w4`` lowering against the float model on
    its codes within TOL_PEFT_WEIGHTS); and
    ``compare_whole_model``'s kernels-against-plain check (the prefill
    bit for bit). Returns (metrics, launches of the served run)."""
    from torch.nn import functional as F
    from aimet_tpu_torch import (QuantizationSimModel, QuantSimConfig,
                                 lower_to_int)
    from aimet_tpu_torch.algorithms import peft
    metrics = {}
    toks = lambda b, n: torch.randint(0, cfg.vocab_size, (b, n),
                                      generator=g, device="cuda")
    calib, train, prompt = toks(1, 256), toks(1, 256), toks(1, 256)
    params = {k: v.detach() for k, v in model.named_parameters()}
    lcfg = peft.LoraConfig(rank=PEFT_RANK, alpha=PEFT_ALPHA,
                           target_patterns=("attn", "mlp"))
    adapters = peft.init_lora_params(
        torch.Generator(device="cuda").manual_seed(3), params, lcfg)
    assert len(adapters) == 7 * cfg.n_layers
    grids = dict(quant_scheme="minmax", default_param_bw=4,
                 config=QuantSimConfig.per_channel_default())
    t = time.perf_counter()
    sim, comb = peft.PeftQuantUtils.build_adapter_sim(
        model, (train,), params, adapters, lcfg,
        default_output_bw=PEFT_OUT_BW, **grids)
    sim.compute_encodings(comb, [calib])
    peft.PeftQuantUtils.set_bitwidth_for_lora_adapters(sim, 16, 16)
    peft.PeftQuantUtils.freeze_base_model(sim)
    adapter_acts = peft.PeftQuantUtils.disable_adapter_activation_quantizers(
        sim)
    torch.cuda.synchronize()
    metrics["adapter_sim_s"] = time.perf_counter() - t
    n_ad = sum(s.kind == "param" and n.startswith(
        peft.PeftQuantUtils.ADAPTER_KEY) for n, s in sim.quantizers.items())
    log(f"[peft] adapter sim: {len(sim.graph.ops)} ops, "
        f"{len(sim.quantizers)} quantizers ({n_ad} adapter parameters, "
        f"{len(adapter_acts)} adapter activations off, {len(sim._frozen)} "
        f"frozen); built and calibrated in {metrics['adapter_sim_s']:.1f} s")

    train_ad = {k: {r: v.clone().requires_grad_(True) for r, v in ab.items()}
                for k, ab in adapters.items()}
    opt = torch.optim.AdamW([v for ab in train_ad.values()
                             for v in ab.values()], lr=PEFT_LR)
    apply = sim.static_grid_qat_fn()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    for i in range(PEFT_STEPS + 1):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        logits = apply(peft.combined_params(params, train_ad), train)
        loss = F.cross_entropy(logits[:, :-1].reshape(-1, cfg.vocab_size),
                               train[:, 1:].reshape(-1))
        if i < PEFT_STEPS:
            opt.zero_grad()
            loss.backward()
            opt.step()
        e1.record()
        e1.synchronize()
        losses.append(loss.item())
        if i < PEFT_STEPS:
            step_ms.append(e0.elapsed_time(e1))
        del logits, loss
    peak = torch.cuda.max_memory_allocated() / 1e9
    metrics.update(losses=losses, step_ms=step_ms, peak_gb=peak,
                   median_step_ms=sorted(step_ms)[len(step_ms) // 2])
    log(f"[peft] {PEFT_STEPS} AdamW steps (lr {PEFT_LR}) on the adapters "
        "through static_grid_qat_fn, 1 x 256 tokens: losses "
        + ", ".join(f"{v:.6f}" for v in losses) + f" (the last after the "
        f"last step); median step {metrics['median_step_ms']:.1f} ms (CUDA "
        f"events), peak {peak:.2f} GB allocated ({smi})")
    assert all(math.isfinite(v) for v in losses), losses
    assert all(b < a for a, b in zip(losses, losses[1:])), losses
    trained = {k: {r: v.detach() for r, v in ab.items()}
               for k, ab in train_ad.items()}
    del opt, train_ad, apply, sim, comb
    torch.cuda.empty_cache()

    # in f32: in the model's bf16 the merged kernel and the separate
    # adapter path round apart (about 1e-2 of the max)
    with torch.no_grad(), f32_compute(model):
        unmerged = peft.lora_unmerged_fn(model, (prompt,), params, lcfg)(
            {"base": params, "adapters": trained}, prompt)
        merged = peft.lora_apply_fn(
            lambda p_, *a: torch.func.functional_call(model, p_, a), params,
            trained, lcfg)(trained, prompt)
    metrics["unmerged_vs_merged_rel_err"] = rel_err(unmerged, merged)
    log(f"[peft] unmerged against merged forward (f32): "
        f"{metrics['unmerged_vs_merged_rel_err']:.3e}")
    assert metrics["unmerged_vs_merged_rel_err"] < TOL_LORA_FORMS
    del unmerged, merged

    t = time.perf_counter()
    merged_params = peft.merge_lora(params, trained, lcfg)
    qw = qllm.quantize_transformer_weights(merged_params, cfg, mode="w4a8")
    llm = qllm.QuantizedLLM.from_quantized(qw, cfg, mode="w4a8", max_len=512)
    torch.cuda.synchronize()
    metrics["quantize_s"] = time.perf_counter() - t
    pos = torch.full((1,), 256, dtype=torch.int64, device="cuda")

    def serve():
        served, caches = llm.prefill(prompt, llm.new_caches(1))
        # one step at per-slot positions (the batcher's step: K3 and K2's
        # fused decode kernel), then greedy generation (KSOL)
        step, _ = llm.decode(served[:, -1:].argmax(-1), caches, pos)
        return served, step, llm.generate(prompt, 8)
    serve()                                              # warm-up
    torch.cuda.synchronize()
    zero_counts(counters)
    t = time.perf_counter()
    served, step, out = serve()
    torch.cuda.synchronize()
    metrics["serve_s"] = time.perf_counter() - t
    counts = {k: c.launches for k, c in counters.items() if c.launches}
    take_routes(counters)
    assert out.shape == (1, 264) and torch.isfinite(served).all() \
        and torch.isfinite(step).all()

    base = QuantizationSimModel(model, (prompt,), **grids)
    base.compute_param_encodings(params)
    kernels = {o.param_products["kernel"].param_path
               for o in base.graph.ops_of_type("linear")}
    for n, s in base.quantizers.items():
        if s.kind == "param" and n not in kernels:
            base.set_quantizer_enabled(n, False)
    peft.PeftQuantUtils.freeze_base_model(base)
    q = peft.PeftQuantUtils.quantized_lora_fn(base, params, trained, lcfg)(
        trained, prompt)
    # the same merged weights through lower_to_int(w4a8) (K1 + K2 on the
    # frozen base grids): what the sim simulates, without the INT8 cache
    lowered = lower_to_int(base, merged_params, mode="w4a8")(merged_params,
                                                            prompt)
    gap = peft_gap_split(torch, qllm, cfg, model, params, trained,
                         merged_params, qw, lcfg, grids, prompt, served,
                         lowered, q, base)
    metrics.update(
        served_vs_sim_rel_err=rel_err(served, q),
        served_vs_sim_top1=(served.argmax(-1) == q.argmax(-1)).float()
        .mean().item(),
        lowered_vs_sim_rel_err=rel_err(lowered, q),
        served_vs_lowered_rel_err=rel_err(served, lowered), launches=counts,
        gap=gap)
    log(f"[peft] merged weights quantized (w4a8) in "
        f"{metrics['quantize_s']:.1f} s; prefill 1 x 256, a per-slot step "
        f"and generate 8: {metrics['serve_s']:.2f} s, launches {counts}; "
        f"against quantized_lora_fn: served prefill "
        f"{metrics['served_vs_sim_rel_err']:.3e} of the max (limit "
        f"{TOL_PEFT_SERVED}; top-1 {metrics['served_vs_sim_top1']:.3f}), "
        f"the lowered w4a8 forward {metrics['lowered_vs_sim_rel_err']:.3e} "
        f"(limit {TOL_PEFT_LOWERED}); served against lowered "
        f"{metrics['served_vs_lowered_rel_err']:.3e}; the gap split: "
        + ", ".join(f"{k} {v:.3e}" for k, v in gap.items()) + f" ({smi})")
    assert gap["lowering_f32"] < TOL_PEFT_WEIGHTS, gap
    assert metrics["lowered_vs_sim_rel_err"] < TOL_PEFT_LOWERED, metrics
    assert metrics["served_vs_sim_rel_err"] < TOL_PEFT_SERVED, metrics
    del base, q, served, step, lowered, llm
    torch.cuda.empty_cache()
    m = compare_whole_model(torch, qllm, ops, qw, cfg, "w4a8", g,
                            cfg.n_layers)
    metrics.update({f"vs_plain_{k}": v for k, v in m.items()})
    assert m["prefill_logits_rel_err"] == 0.0, m
    del qw
    torch.cuda.empty_cache()
    return metrics, counts


def peft_gap_split(torch, qllm, cfg, model, params, trained, merged_params,
                   qw, lcfg, grids, prompt, served, lowered, q, base):
    """What parts the served LoRA prefill from the sim's
    ``quantized_lora_fn`` (max |diff| / max |sim|), each pair differing in
    one thing: ``sim_bf16`` the sim in the model's bf16 against the same
    sim in f32; ``lowering_f32`` the ``w4`` lowering (KW4: the 4-bit codes,
    activations float) against the float model on the weights its codes
    stand for (each kernel through its encoding's stored step), in f32;
    ``ties_f32`` that model against the sim, in f32: the sim's fake-quant
    recomputes the step from (min, max) as the JAX package's does, so a
    bf16 weight at exactly half a step (about one a column) rounds the
    other way; ``k1_f32`` the
    ``w4a8`` lowering (K1's per-row INT8 activations + K2) against the
    ``w4`` one, both in f32; ``bf16_lowered`` the ``w4a8`` lowering in bf16
    (weights merged in bf16) against it in f32; ``route`` the serving
    route without a cache
    (``quantized_forward``: grids of the merged weights, fused qkv and
    gate|up) against the ``w4a8`` lowering; ``kv_int8`` the served prefill
    (INT8 KV cache) against that cache-free forward; ``base_gap`` the
    ``w4a8`` lowering against the sim for the base model, without
    adapters."""
    from aimet_tpu_torch import QuantizationSimModel, lower_to_int
    from aimet_tpu_torch.algorithms import peft
    from aimet_tpu_torch.quantization.affine import (
        quantize_dequantize_encoding)
    f32 = lambda d: {k: v.float() for k, v in d.items()}
    out = {}
    with torch.no_grad(), f32_compute(model):
        p32 = f32(params)
        t32 = {k: f32(ab) for k, ab in trained.items()}
        m32 = peft.merge_lora(p32, t32, lcfg)       # merged in f32, as q32
        sim32 = QuantizationSimModel(model, (prompt,), **grids)
        sim32.compute_param_encodings(p32)
        kernels = {o.param_products["kernel"].param_path
                   for o in sim32.graph.ops_of_type("linear")}
        for n, s in sim32.quantizers.items():
            if s.kind == "param" and n not in kernels:
                sim32.set_quantizer_enabled(n, False)
        peft.PeftQuantUtils.freeze_base_model(sim32)
        q32 = peft.PeftQuantUtils.quantized_lora_fn(sim32, p32, t32, lcfg)(
            t32, prompt)
        w4 = lower_to_int(sim32, m32, mode="w4")(m32, prompt)
        a8 = lower_to_int(sim32, m32, mode="w4a8")(m32, prompt)
        # the float model on the codes the lowering takes (each kernel
        # through its encoding's stored step)
        pq = dict(m32)
        for k in kernels:
            pq[k] = quantize_dequantize_encoding(
                m32[k], sim32.encodings[k],
                channel_axis=sim32.quantizers[k].channel_axis)
        codes = torch.func.functional_call(model, pq, (prompt,))
        del pq
        del sim32, p32, m32, t32
    with torch.no_grad():
        cache_free, _ = qllm.quantized_forward(qw, cfg, prompt, mode="w4a8")
        base_gap = rel_err(
            lower_to_int(base, params, mode="w4a8")(params, prompt),
            base.quantized_fn(params, prompt))
    out.update(sim_bf16=rel_err(q, q32), lowering_f32=rel_err(w4, codes),
               ties_f32=rel_err(codes, q32),
               k1_f32=rel_err(a8, w4), bf16_lowered=rel_err(lowered, a8),
               route=rel_err(cache_free, lowered),
               kv_int8=rel_err(served, cache_free), base_gap=base_gap)
    del q32, w4, a8, codes, cache_free
    torch.cuda.empty_cache()
    return out


def amp_peft(torch, tim, counters, g, models, smi, ops, qllm):
    """Phase 9: AutoQuant + AMP on the CNN phase's ResNet-50 (9a) and PEFT
    on a float Llama-3-8B at 2 layers (full width, seed 3: phase 8's
    weights) (9b). Returns (metrics, launches of each path)."""
    import dataclasses
    from aimet_tpu_torch.models.transformer import TransformerConfig
    metrics, paths = {}, {}
    t = time.perf_counter()
    m, counts = amp_autoquant(torch, tim, counters, g, models["resnet50"],
                              smi)
    metrics["amp_resnet50"] = m
    paths["amp_resnet50"] = counts
    log(f"[amp] phase 9a took {time.perf_counter() - t:.1f} s; {smi}")
    t = time.perf_counter()
    cfg = dataclasses.replace(TransformerConfig.llama3_8b(), n_layers=2)
    model = float_llama(torch, cfg, seed=3)
    m, counts = peft_llm(torch, tim, counters, g, cfg, model, smi, ops, qllm)
    metrics["peft_llm"] = m
    paths["peft_llm"] = counts
    del model
    torch.cuda.empty_cache()
    log(f"[peft] phase 9b took {time.perf_counter() - t:.1f} s; {smi}")
    return metrics, paths


def ds2_lowered(torch, tim, counters, sim, mode, expect, x, ref, params):
    """One lowered DeepSpeech2 forward (``mode``), its launches (exactly
    ``expect``) and the routes they took, against the same forward through
    the plain versions (within TOL_DS2_LOGITS) and against the float
    model. Returns (metrics, launches)."""
    from aimet_tpu_torch import lower_to_int
    from aimet_tpu_torch.ops import int_conv as tic
    from aimet_tpu_torch.quantsim import lowering as lw
    t = time.time()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        low = lower_to_int(sim, None, mode=mode)
    t_lower = time.time() - t
    scoped = [op.name for op in sim.graph.ops
              if op.scope is not None and op.type == "linear"]
    assert len(scoped) == 4 * DS2_WIDTHS["num_layers"], scoped
    assert low.lowered_ops == ["conv_0", "conv_1", "linear_0"], \
        low.lowered_ops
    assert low.skipped_ops == scoped, low.skipped_ops
    routes = {}
    out, counts, host_ms, dev_ms, top = forward_stats(
        torch, lambda: low(params, x), counters, cuda_profiled, routes)
    assert counts == expect, (mode, counts)
    assert torch.isfinite(out).all() and out.shape == ref.shape
    with plain_lowering(lw, tim), plain_ops(tim, tic):
        plain = low(params, x)
    m = {"lowered": low.lowered_ops, "skipped": len(low.skipped_ops),
         "downgraded": low.downgraded_ops,
         "warnings": len(caught), "lower_s": t_lower,
         "int_flops_fraction": low.int_flops_fraction,
         "host_ms": host_ms, "device_ms": dev_ms, "launches": counts,
         "routes": routes, "top_kernels": top,
         "logprobs_vs_plain_rel_err": rel_err(out, plain),
         "vs_float_rel_err": rel_err(out, ref)}
    log(f"[ds2 {mode}] lowered {low.lowered_ops}, {m['skipped']} scoped "
        f"linears skipped, downgraded {low.downgraded_ops}; forward "
        f"{DS2_BATCH} x {DS2_FRAMES} frames: {host_ms:.0f} ms host, "
        f"{dev_ms:.1f} ms device; launches {counts}, routes {routes}; "
        f"kernels vs plain {m['logprobs_vs_plain_rel_err']:.3e}; vs float "
        f"{m['vs_float_rel_err']:.3e}")
    assert m["logprobs_vs_plain_rel_err"] < TOL_DS2_LOGITS, (mode, m)
    del low, out, plain
    return m, counts


def deepspeech2_phase(torch, tim, counters, g, smi):
    """Phase 10a: DeepSpeech2 at DS2_WIDTHS (weights drawn from a seed, the
    LSTMs' contractive) through the one QuantizationSimModel (10 scan
    ops), calibrated (min-max) on 4 batches; its fake-quant forward; the
    device-busy share of a 100-frame calibration pass; one range-learning
    QAT step on 100 frames with the calibrated encodings; lower_to_int in
    w8a8 and, on 4-bit parameters, w4a8 (DS2_MODES); RecurrentQuantizer
    alone on one LSTM and one GRU at hidden 1024. Returns (metrics,
    launches of each lowered path)."""
    from aimet_tpu_torch import QuantizationSimModel
    from aimet_tpu_torch.models.deepspeech import init_deepspeech2
    from aimet_tpu_torch.quantsim.recurrent import (RecurrentQuantizer,
                                                    init_gru_params,
                                                    init_lstm_params)
    metrics, paths = {"card": smi}, {}
    t = time.time()
    model = init_deepspeech2(torch.Generator().manual_seed(5), **DS2_WIDTHS)
    # the JAX package's N(0, 0.1) LSTM kernels give a recurrent kernel of
    # spectral radius about 0.1 * sqrt(1024) = 3.2 at this width: a chaotic
    # recurrence, where any rounding grows with the steps. A trained
    # network's recurrence contracts: input kernels N(0, 1 / in), recurrent
    # kernels of radius about 0.5
    gl = torch.Generator(device="cuda").manual_seed(7)
    with torch.no_grad():
        for layer in model.lstm:
            for cell in (layer.fwd, layer.bwd):
                cell.kernel.normal_(0.0, cell.kernel.shape[0] ** -0.5,
                                    generator=gl)
                cell.recurrent_kernel.normal_(
                    0.0, 0.5 * cell.recurrent_kernel.shape[0] ** -0.5,
                    generator=gl)
    n_params = sum(p.numel() for p in model.parameters())
    data = [torch.randn((DS2_BATCH, DS2_FRAMES, DS2_WIDTHS["n_mels"]),
                       generator=g, device="cuda") for _ in range(5)]
    calib, x = data[:4], data[4]
    with torch.no_grad():
        model(x)                                          # warm-up
        torch.cuda.synchronize()
        t0 = time.time()
        ref = model(x)
        torch.cuda.synchronize()
    metrics.update(params=n_params, init_s=t0 - t,
                   float_forward_s=time.time() - t0)
    log(f"[ds2] {n_params / 1e6:.1f} M parameters; float forward "
        f"{DS2_BATCH} x {DS2_FRAMES} frames {metrics['float_forward_s']:.2f}"
        f" s (eager, {DS2_WIDTHS['num_layers'] * 2} x {DS2_FRAMES // 2} "
        "LSTM steps)")

    # min-max observers: every step of every scan updates each of the
    # 130 inner observers (the sqnr histograms launch ~30 kernels an update)
    t = time.time()
    sim = QuantizationSimModel(model, (x,), quant_scheme="minmax")
    metrics["trace_s"] = time.time() - t
    log(f"[ds2] traced in {metrics['trace_s']:.1f} s")
    scans = sim.graph.ops_of_type("scan")
    assert len(scans) == 2 * DS2_WIDTHS["num_layers"], len(scans)
    assert [s.attrs["reverse"] for s in scans] == \
        [False, True] * DS2_WIDTHS["num_layers"]
    inner = sum(len(v) for v in sim._sub_act_names.values())
    # how host-bound the per-step loop is: the device-busy share of one
    # calibration pass over a 100-frame batch (50 steps a scan; a sim
    # traced at that length), after a warm-up pass: the wall time
    # unprofiled, the kernels' time profiled
    short = x[:, :100].contiguous()
    sim_short = QuantizationSimModel(model, (short,), quant_scheme="minmax")
    sim_short.compute_encodings(None, [short])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim_short.compute_encodings(None, [short])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with cuda_profiled() as prof:
        sim_short.compute_encodings(None, [short])
        torch.cuda.synchronize()
    events = _kernel_events(prof)
    busy = sum(e.time_range.elapsed_us() for e in events) / 1e3
    metrics.update(calib_pass_100_frames_s=wall,
                   calib_pass_device_ms=busy,
                   calib_pass_busy_share=busy / (wall * 1e3),
                   calib_pass_kernels=len(events))
    del prof, events
    t = time.time()
    sim.compute_encodings(None, calib)         # the 1000-frame encodings
    torch.cuda.synchronize()
    metrics.update(calibrate_s=time.time() - t, scans=len(scans),
                   quantizers=len(sim.quantizers), inner_quantizers=inner)
    log(f"[ds2] QuantizationSimModel: traced in {metrics['trace_s']:.1f} s,"
        f" {len(sim.graph.ops)} ops ({len(scans)} scans), "
        f"{len(sim.quantizers)} quantizers ({inner} inside the scans); "
        f"compute_encodings (minmax, 4 batches) "
        f"{metrics['calibrate_s']:.1f} s; a 100-frame calibration pass: "
        f"{wall:.3f} s, kernels {busy:.1f} ms (busy "
        f"{metrics['calib_pass_busy_share']:.3f}), "
        f"{metrics['calib_pass_kernels']} kernels")

    log(f"[ds2] calibrated: {metrics['calibrate_s']:.1f} s")
    t = time.time()
    q = sim.quantized_fn(None, x)
    torch.cuda.synchronize()
    metrics.update(quantized_fn_s=time.time() - t,
                   quantized_vs_float_rel_err=rel_err(q, ref),
                   quantized_vs_float_rel_l2=((q - ref).norm()
                                              / ref.norm()).item(),
                   quantized_top1_vs_float=(q.argmax(-1) == ref.argmax(-1))
                   .float().mean().item())
    assert torch.isfinite(q).all() and q.shape == ref.shape
    del q
    # one range-learning QAT step: gradients through every step's
    # fake-quant to every LSTM kernel and to the encodings. On the
    # 100-frame sim with the calibrated encodings: the per-step loop is
    # host-bound, and a 500-step backward launches ~1,000 kernels a step
    for name, e in sim.encodings.items():
        sim_short.set_encoding(name, e)
    apply_fn, enc = sim_short.qat_fn()
    enc = {k: (a.requires_grad_(), b.requires_grad_())
           for k, (a, b) in enc.items()}
    params = {k: v.clone().requires_grad_()
              for k, v in sim_short.params.items()}
    opt = torch.optim.SGD(list(params.values())
                          + [t for pair in enc.values() for t in pair],
                          lr=1e-4)
    log(f"[ds2] quantized forward {metrics['quantized_fn_s']:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    t = time.time()
    with torch.no_grad():
        ref_short = model(short)
    loss = ((apply_fn(params, enc, short) - ref_short) ** 2).mean()
    loss.backward()
    opt.step()
    torch.cuda.synchronize()
    lstm = [k for k in params if k.startswith("lstm.")
            and k.endswith("kernel")]
    assert len(lstm) == 4 * DS2_WIDTHS["num_layers"]
    for k in lstm:
        gk = params[k].grad
        assert gk is not None and torch.isfinite(gk).all() \
            and gk.abs().sum() > 0, k
    n_enc = sum(1 for a, b in enc.values() if a.grad is not None
                and torch.isfinite(a.grad).all())
    metrics.update(qat_step_s=time.time() - t, qat_loss=loss.item(),
                   qat_encoding_grads=n_enc,
                   qat_peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"[ds2] quantized forward {metrics['quantized_fn_s']:.1f} s, vs "
        f"float: max rel {metrics['quantized_vs_float_rel_err']:.3e}, l2 rel "
        f"{metrics['quantized_vs_float_rel_l2']:.3e}, top-1 "
        f"{metrics['quantized_top1_vs_float']:.4f}; one QAT step (16 x "
        f"100 frames) {metrics['qat_step_s']:.1f} s (loss "
        f"{loss.item():.4e}; finite grads in all {len(lstm)} LSTM kernels "
        f"and {n_enc} encodings)")
    del apply_fn, enc, params, opt, loss, sim_short, ref_short
    torch.cuda.empty_cache()

    for mode, (bw, expect) in DS2_MODES.items():
        s = sim
        if bw == 4:
            s = QuantizationSimModel(model, (x,), default_param_bw=4)
            s.compute_param_encodings()
        m, counts = ds2_lowered(torch, tim, counters, s, mode, expect, x,
                                ref, s.params)
        metrics[f"lowered_{mode}"] = m
        paths[f"ds2_{mode}"] = counts
        del s
        torch.cuda.empty_cache()
    del sim

    # RecurrentQuantizer alone: one LSTM and one GRU at hidden 1024 on the
    # first layer's inputs (16 x 500 steps of 1312 features)
    T, I, H = DS2_FRAMES // 2, model.lstm[0].fwd.kernel.shape[0], 1024
    for cell, init in (("lstm", init_lstm_params), ("gru", init_gru_params)):
        p = init(torch.Generator().manual_seed(6), I, H, device="cuda")
        xs = [torch.randn((DS2_BATCH, T, I), generator=g, device="cuda")
              for _ in range(3)]
        rq = RecurrentQuantizer(cell)
        t = time.time()
        rq.compute_encodings(p, xs[:2])
        torch.cuda.synchronize()
        t_cal = time.time() - t
        with torch.no_grad():
            t = time.time()
            out_q, _ = rq.quantized_forward(p, xs[2])
            torch.cuda.synchronize()
            t_q = time.time() - t
            out_fp, _ = rq.fp_forward(p, xs[2])
        err = ((out_q - out_fp).abs().mean() / out_fp.abs().mean()).item()
        assert torch.isfinite(out_q).all() and 0 < err < 0.3, (cell, err)
        metrics[f"recurrent_{cell}"] = dict(
            calibrate_s=t_cal, quantized_forward_s=t_q,
            mean_abs_rel_err=err, encodings=sorted(rq.encodings))
        log(f"[ds2] RecurrentQuantizer({cell!r}) 16 x {T} x {I} -> {H}: "
            f"calibrate (2 batches) {t_cal:.1f} s, quantized forward "
            f"{t_q:.2f} s, mean |q - fp| / mean |fp| {err:.3e}")
        del p, xs, rq
    del model, data, ref
    torch.cuda.empty_cache()
    return metrics, paths


def trunk_readers(graph):
    """The convs that read a residual trunk (a relu of an add)."""
    out = []
    for op in graph.ops_of_type("conv"):
        p = op.inputs[0].producer
        if p is not None and p.type == "relu" and p.inputs \
                and p.inputs[0].producer is not None \
                and p.inputs[0].producer.type == "add":
            out.append(op.name)
    return out


def compression_phase(torch, tim, counters, g, model, smi):
    """Phase 10b: the CNN phase's ResNet-50 (224 x 224, 1000 classes)
    compressed: channel pruning at 0.5 with least-squares reconstruction
    on every conv that reads a residual trunk, then spatial SVD at 0.5 on
    the 8 heaviest remaining convs (the re-traced graph's MAC at most 0.55
    of the original); one greedy spatial-SVD selection toward 0.5 MAC
    (eval: top-1 agreement with the float model on 64 images); the
    compressed model through the sim and lower_to_int in w8a8. Returns
    (metrics, launches of the lowered forward)."""
    from aimet_tpu_torch import QuantizationSimModel, lower_to_int
    from aimet_tpu_torch.compression import (ModelCompressor, layer_cost,
                                             model_cost)
    from aimet_tpu_torch.graph.connected_graph import ConnectedGraph
    from aimet_tpu_torch.ops import int_conv as tic
    from aimet_tpu_torch.quantsim import lowering as lw
    metrics = {"card": smi}
    # 32 images a batch; a compressed model runs at the batch it was
    # traced at (its graph's views hold the shapes)
    xs = resnet_inputs(torch, g, 4)
    x, x_eval = xs[0], xs[1]
    with torch.no_grad():
        ref = model(x_eval)
    t = time.time()
    sim = QuantizationSimModel(model, (x,))
    seeds = trunk_readers(sim.graph)
    names = []
    for n in seeds:
        op = sim.graph.get_op(n)
        names += [op.inputs[0].name, op.output.name]
    caps = sim.collect_activations(None, (x,), names)
    act = {n: (caps[sim.graph.get_op(n).inputs[0].name],
               caps[sim.graph.get_op(n).output.name]) for n in seeds}
    del sim, caps
    m1, s1 = ModelCompressor.compress_model(
        model, (x,), None, "channel_pruning",
        manual_ratios={n: 0.5 for n in seeds}, act_samples=act)
    g2 = ConnectedGraph(m1, (x,))
    mac1 = model_cost(g2).mac / s1.original_cost.mac
    costs = sorted(((layer_cost(op).mac, op.name)
                    for op in g2.ops_of_type("conv")), reverse=True)
    heavy = [n for _, n in costs[:8]]
    m2, s2 = ModelCompressor.compress_model(
        m1, (x,), None, "spatial_svd", manual_ratios={n: 0.5 for n in heavy})
    g3 = ConnectedGraph(m2, (x,))
    mac2 = model_cost(g3).mac / s1.original_cost.mac
    torch.cuda.synchronize()
    with torch.no_grad():
        out = m2(x_eval)
    assert torch.isfinite(out).all() and out.shape == ref.shape
    corr = torch.corrcoef(torch.stack([ref.flatten(), out.flatten()]))[
        0, 1].item()
    metrics.update(pipeline_s=time.time() - t, seeds=seeds, svd_layers=heavy,
                   mac_after_pruning=mac1,
                   mac_stats=s2.compressed_cost.mac / s1.original_cost.mac,
                   mac_retraced=mac2, output_corr=corr,
                   top1_vs_float=(out.argmax(-1) == ref.argmax(-1)).float()
                   .mean().item())
    log(f"[compress] channel pruning (0.5, reconstructed) on {len(seeds)} "
        f"trunk-reading convs: MAC {mac1:.4f}; spatial SVD (0.5) on "
        f"{heavy}: MAC {mac2:.4f} re-traced ({metrics['mac_stats']:.4f} "
        f"by the stats); output corr with the float model {corr:.4f}, "
        f"top-1 {metrics['top1_vs_float']:.3f}; "
        f"{metrics['pipeline_s']:.1f} s")
    assert mac2 <= 0.55, mac2

    # one greedy spatial-SVD selection over the spatial (k > 1) convs
    x64 = torch.cat(xs[2:4])
    with torch.no_grad():
        ref64 = model(x64).argmax(-1)
    graph = ConnectedGraph(model, (x64,))
    ignore = [op.name for op in graph.ops_of_type("conv")
              if tuple(op.param_products["kernel"].shape[2:]) == (1, 1)]
    evals = []

    def eval_fn(m):
        with torch.no_grad():
            evals.append(1)
            return (m(x64).argmax(-1) == ref64).float().mean().item()

    t = time.time()
    _, sg = ModelCompressor.compress_model(
        model, (x64,), None, "spatial_svd", eval_fn=eval_fn,
        target_comp_ratio=0.5, num_candidates=4, ignore_layers=ignore)
    torch.cuda.synchronize()
    sel = {k: v for k, v in sg.per_layer_ratios.items() if v < 1.0}
    metrics.update(greedy_s=time.time() - t, greedy_evals=len(evals),
                   greedy_layers=len(graph.ops_of_type("conv"))
                   - len(ignore), greedy_selected=sel,
                   greedy_mac_ratio=sg.mac_compression_ratio)
    log(f"[compress] greedy spatial SVD toward 0.5 over "
        f"{metrics['greedy_layers']} spatial convs: {len(evals)} evals "
        f"(top-1 on 64 images) in {metrics['greedy_s']:.1f} s; "
        f"{len(sel)} layers compressed, model MAC ratio "
        f"{sg.mac_compression_ratio:.4f}")
    del graph

    # the compressed model lowered in w8a8: its factored and pruned
    # layers compute with constant kernels (skipped), the rest lower
    t = time.time()
    sim = QuantizationSimModel(m2, (x,))
    sim.compute_encodings(None, xs[2:4])
    low = lower_to_int(sim, None, mode="w8a8")
    const = [op.name for op in sim.graph.ops
             if op.type in ("conv", "linear")
             and "kernel" not in op.param_products]
    assert const and set(const) <= set(low.skipped_ops), (const,
                                                           low.skipped_ops)
    # the pruned trunk reaches the head: its kernel is sliced, a constant
    n_conv = sum(n.startswith("conv_") for n in low.lowered_ops)
    expect = {"q8_gemm": n_conv}
    if "linear_0" in low.lowered_ops:
        expect["w8_gemm"] = 1                    # downgraded, as phase 6
    params = sim.params
    out, counts, host_ms, dev_ms, top = forward_stats(
        torch, lambda: low(params, x_eval), counters)
    assert counts == expect, counts
    with plain_lowering(lw, tim), plain_ops(tim, tic):
        plain = low(params, x_eval)
    err = rel_err(out, plain)
    metrics["lowered_w8a8"] = dict(
        lowered=len(low.lowered_ops), skipped=len(low.skipped_ops),
        constant_kernel_layers=len(const), launches=counts,
        host_ms=host_ms, device_ms=dev_ms, top_kernels=top,
        logits_vs_plain_rel_err=err, s=time.time() - t, **vs_float(out, ref))
    log(f"[compress w8a8] lowered {len(low.lowered_ops)}, skipped "
        f"{len(low.skipped_ops)} ({len(const)} constant-kernel layers); "
        f"forward 32 x 224 x 224 {host_ms:.1f} ms host, {dev_ms:.2f} ms "
        f"device; launches {counts}; kernels vs plain {err:.3e}; vs float "
        f"{vs_float(out, ref)}")
    assert err < TOL_CNN_LOGITS, err
    del sim, low, m1, m2, out, plain, xs
    torch.cuda.empty_cache()
    return metrics, counts


def recurrent_compression(torch, tim, counters, g, model, smi):
    """Phase 10: DeepSpeech2 (10a) and compression of the CNN phase's
    ResNet-50 (10b). Returns (metrics, launches of each path)."""
    t = time.perf_counter()
    m, paths = deepspeech2_phase(torch, tim, counters, g, smi)
    metrics = {"ds2": m}
    log(f"[ds2] phase 10a took {time.perf_counter() - t:.1f} s; {smi}")
    t = time.perf_counter()
    m, counts = compression_phase(torch, tim, counters, g, model, smi)
    metrics["compression"] = m
    paths["compressed_resnet50"] = counts
    log(f"[compress] phase 10b took {time.perf_counter() - t:.1f} s; {smi}")
    return metrics, paths


# Variants of the whole-layer kernel for ``--layer-variants``: name ->
# (text, replacement, occurrences) applied to csrc/fused_layer.cu: the
# kAhead weight stages of the next GEMM phase that the producer issues
# during each epilogue, none or more than the build's 2.
LAYER_VARIANTS = {
    "as built": (),
    "kAhead 0": (("constexpr int kAhead = 2;", "constexpr int kAhead = 0;",
                  1),),
    "kAhead 4": (("constexpr int kAhead = 2;", "constexpr int kAhead = 4;",
                  1),),
}


def variant_builds(_build, variants, patched, sources, tag):
    """Builds ``sources`` (``csrc`` files) once for each entry of
    ``variants`` (name -> (text, replacement, occurrences) pairs applied in
    turn to ``patched``; occurrences None: as many as the tree has, none
    too), one nvcc a source, all started together, each variant then
    linked into one library under the git-ignored build root (``tag``);
    returns name -> the library's path."""
    import shutil
    text0 = (_build.CSRC / patched).read_text()
    nvcc = _build.find_nvcc()
    procs = {}
    for i, (name, subs) in enumerate(variants.items()):
        text = text0
        for old, new, count in subs:
            assert count is None or text.count(old) == count, \
                ("variant", name, old)
            text = text.replace(old, new)
        d = _build.BUILD_ROOT / tag / str(i)
        d.mkdir(parents=True, exist_ok=True)
        for f in list(_build.CSRC.glob("*.cuh")) + [_build.CSRC / src
                                                     for src in sources]:
            shutil.copy(f, d)
        (d / patched).write_text(text)
        procs[name] = (d, [subprocess.Popen(
            [nvcc, *_build.CFLAGS, "-c", str(d / src), "-o",
             str(d / (src + ".o"))], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for src in sources])
    paths = {}
    for name, (d, ps) in procs.items():
        for p in ps:
            out, _ = p.communicate()
            assert p.returncode == 0, ("variant build", name, out[-4000:])
        link = subprocess.run(
            [nvcc, *_build.ARCH, "-shared", "-o", str(d / "lib.so"),
             *[str(d / (src + ".o")) for src in sources]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        assert link.returncode == 0, ("variant link", name, link.stdout)
        paths[name] = str(d / "lib.so")
    return paths


def variant_libraries(_build):
    """csrc/fused_layer.cu built for each LAYER_VARIANTS entry; returns
    name -> ctypes library holding the whole-layer kernel's C entries."""
    import ctypes
    libs = {}
    for name, path in variant_builds(_build, LAYER_VARIANTS,
                                     "fused_layer.cu", ("fused_layer.cu",),
                                     "variants").items():
        lib = ctypes.CDLL(path)
        for fn in ("aimet_fused_layer_smem", "aimet_fused_layer_grid",
                   "aimet_fused_layer"):
            getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def layer_variants() -> int:
    """``python3 chip_smoke.py --layer-variants``: KSOL (w4 and w4a8, row
    13's shape: B 16, S 1024, position 700, next QKV) and KFL (next QKV)
    built as they are and with other early weight issues
    (LAYER_VARIANTS): device ms (median of 20 launches) and the phase
    split of each, in two rounds (the second in reverse order) so the
    spread between runs shows; every variant's outputs equal to the
    build's bit for bit."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from aimet_tpu_torch import _build
    from aimet_tpu_torch.models.transformer import (TransformerConfig,
                                                    rope_freqs)
    from aimet_tpu_torch.ops import decode_layer_sol as dsol
    from aimet_tpu_torch.ops import fused_layer as flay
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    t = time.time()
    libs = variant_libraries(_build)
    log(f"{smi}; {len(libs)} variants built in {time.time() - t:.1f} s")
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(3)
    B, S, H, KH, D, Dm, F, pos = 16, 1024, 32, 8, 128, 4096, 14336, 700
    A, Nq = H * D, (H + 2 * KH) * D

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    def codes(r, n):
        return torch.randint(-128, 128, (r, n), dtype=torch.int8,
                             generator=g, device=dev)

    def scales(k, n):
        return (torch.rand((n,), generator=g, device=dev) + 0.5) * 0.02 \
            / k ** 0.5

    ones = torch.ones(Dm, dtype=torch.bfloat16, device=dev)
    lw = [dict(wo_pair=(codes(A // 2, Dm), scales(A, Dm)),
               gateup_pair=(codes(Dm // 2, 2 * F), scales(Dm, 2 * F)),
               down_pair=(codes(F // 2, Dm), scales(F, Dm)),
               mlp_gamma=ones,
               next_qkv=((codes(Dm // 2, Nq), scales(Dm, Nq)), ones))
          for _ in range(2)]                  # 2 x 109 MB > L2
    jw = [jax_form(w) for w in lw]
    resid, ao = randn(B, Dm), randn(B, A)
    sets = [(randn(B, Nq),
             *(torch.randint(-127, 128, (B, S, KH, D), dtype=torch.int8,
                             generator=g, device=dev) for _ in range(2)),
             *(torch.rand((B, KH), generator=g, device=dev) * 0.05 + 0.01
               for _ in range(2)))
            for _ in range(4)]
    cos, sin = rope_freqs(TransformerConfig.llama3_8b(),
                          torch.full((B,), pos, device=dev))

    def ksol(int8_dots):
        def call(i):
            q, kc, vc, ks, vs = sets[i % 4]
            return dsol.sol_decode_layer(q, resid, kc, vc, ks, vs, pos, cos,
                                         sin, **lw[i % 2], n_heads=H,
                                         n_kv_heads=KH, int8_dots=int8_dots)
        return call

    cases = {"KSOL w4": ksol(False), "KSOL w4a8": ksol(True),
             "KFL next QKV": lambda i: flay.fused_wo_mlp(ao, resid,
                                                         **jw[i % 2])}
    built, ref, res = _build.library, {}, {}
    try:
        for rnd, order in enumerate((list(libs), list(libs)[::-1])):
            for name in order:
                _build.library = lambda lib=libs[name]: lib
                for case, call in cases.items():
                    out = [t_ for t_ in call(0) if t_ is not None]
                    torch.cuda.synchronize()
                    for a_, b_ in zip(out, ref.setdefault(case, out)):
                        assert torch.equal(a_, b_), ("variant bits", name,
                                                     case)
                    ms, _ = timed(call, 20, ["fused_layer_kernel"])
                    ph = phase_split(torch, flay, call)
                    res.setdefault(case, {}).setdefault(name, []).append(
                        dict(ms=ms, **ph))
                    log(f"round {rnd + 1} {case:13s} {name:17s} {ms:.5f} ms;"
                        " split " + ", ".join(f"{k} {v:.4f}"
                                              for k, v in ph.items()))
    finally:
        _build.library = built
    log("every variant's outputs equal to the build's, bit for bit")
    log(smi)
    log(json.dumps({"layer_variants": res, "card": smi}))
    return 0


def profile_prefill(torch, llm, cfg, g, mode):
    """A prefill of 8 x 512 tokens (after a warm-up one), 2 profiled:
    host and device ms, busy share and device ms by kernel, logged."""
    toks = torch.randint(0, cfg.vocab_size, (8, 512), generator=g,
                         device="cuda")
    llm.prefill(toks, llm.new_caches(8))              # warm-up
    wall, busy, dev, by_name = profile_steps(
        torch, lambda: llm.prefill(toks, llm.new_caches(8)), n=2)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    log(f"[{mode}] prefill 8x512 profile: {wall:.2f} ms on the host clock, "
        f"{dev:.3f} device ms, busy {busy:.3f}; device ms by kernel: "
        + ", ".join(f"{k_} {v:.3f}" for k_, v in top))
    return dict(host_ms=wall, device_ms=dev, busy=busy, kernels=by_name)


def profile_batcher(torch, llm, cfg, mode, fn):
    """The continuous batcher, the same 32 requests each run
    (``run_batcher``): timed, with the launches of ``fn`` (a GEMM wrapper)
    by route, then profiled; logged."""
    before = dict(fn.routes, all=fn.launches)
    tok_s, dt, steps, n_tok = run_batcher(
        torch, llm, cfg, torch.Generator(device="cuda").manual_seed(3))
    routes = {r: v - before[r]
              for r, v in dict(fn.routes, all=fn.launches).items()}
    wall, busy, dev, by_name = profile_steps(
        torch, lambda: run_batcher(
            torch, llm, cfg, torch.Generator(device="cuda").manual_seed(3)),
        n=1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    log(f"[{mode}] continuous batcher: {n_tok} tokens in {dt:.2f} s "
        f"({tok_s:.1f} tok/s), {steps} engine steps, launches by route "
        f"{routes}; profiled: {dev:.2f} device ms, busy {busy:.3f}; device "
        "ms by kernel: " + ", ".join(f"{k_} {v:.2f}" for k_, v in top))
    return dict(tok_s=tok_s, s=dt, steps=steps, tokens=n_tok, routes=routes,
                profiled_s=wall / 1e3, device_ms=dev, busy=busy,
                kernels=by_name)


def decode_slice() -> int:
    """``python3 chip_smoke.py --decode-slice``: the two kernels of the
    batcher's per-slot decode step and the step itself, on whatever tree
    holds this script (so a parent commit can be measured with the same
    code): K2 at decode M (K2_DECODE_SHAPES) and K3 (K3_SHAPES) held
    against their plain versions and timed, then Llama-3-8B (32 layers) in
    w4, w4a8 and w8 at batch 16: a 512-token prefill and 4 profiled steps at
    per-slot positions. Prints one JSON line of the numbers."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from aimet_tpu_torch import _build
    from aimet_tpu_torch.models.transformer import TransformerConfig
    from aimet_tpu_torch.ops import decode_attention_fused as dattn
    from aimet_tpu_torch.ops import int_matmul as tim
    from aimet_tpu_torch.serving import quantized_llm as qllm
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    log(f"decode slice of {ROOT}: torch {torch.__version__}; {smi}")
    t = time.time()
    _build.build()
    _build.library()
    log(f"build: {time.time() - t:.1f} s")
    g = torch.Generator(device="cuda").manual_seed(1)
    rows, errs = {}, {"w4a8_gemm": 0.0, "decode_attention": 0.0}

    def note(name, a, b):
        errs[name] = max(errs[name], (a.float() - b.float()).abs().max()
                         .item())
    k2_decode_rows(torch, tim, g, gemm_timer(rows), note)
    sweep = k3_rows(torch, dattn, g, rows, note)
    for name, r in rows.items():
        log(f"  {name:28s} {r['shape']}: kernel {r['ms']:.5f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms "
            f"({r['bound_by']})")
    cfg = TransformerConfig.llama3_8b()
    g = torch.Generator(device="cuda").manual_seed(2)
    metrics = {}
    for mode in ("w4", "w4a8", "w8"):
        if mode != "w4a8":
            qw = qllm.random_quantized_weights(cfg, mode=mode, seed=0)
        llm = qllm.QuantizedLLM.from_quantized(qw, cfg, mode=mode,
                                               max_len=1024)
        toks = torch.randint(0, cfg.vocab_size, (16, 512), generator=g,
                             device="cuda")
        logits, caches = llm.prefill(toks, llm.new_caches(16))
        tok = logits[:, -1].argmax(-1)[:, None]
        del logits
        m = {}
        slot_step_profile(torch, llm, mode, tok, caches,
                          torch.arange(16, device="cuda", dtype=torch.int32)
                          + 512, m, 16)
        metrics[mode] = m
        del llm, caches
        torch.cuda.empty_cache()
    log(json.dumps({"decode_slice": {"root": ROOT, "card": smi,
                                     "rows": rows, "errs": errs,
                                     "k3_chunk_sweep": sweep,
                                     "slot_step": metrics}}))
    return 0


# tile_sweep's crossing of KW4's tile and block tile: x rows, and (K, N)
# at the layer projections (QKV, O, gate|up, down) with x's dtype
TILE_SWEEP_M = (65, 128, 256, 512, 1024, 2048)
TILE_SWEEP_KN = ((4096, 6144, "bf16"), (4096, 4096, "bf16"),
                 (4096, 28672, "bf16"), (14336, 4096, "bf16"),
                 (4096, 4096, "f32"))


def tile_sweep(torch, tim):
    """The evidence for where KW4's tile takes over (this tree's, where it
    has the tile): device ms of the decode route against the tile at M =
    32, 48 and 64 at 4096 x 28672 and 4096 x 6144 (``decode``); and of the
    tile against the block tile (``bf_tile``, split K) at TILE_SWEEP_M x
    TILE_SWEEP_KN, beside the tile's output tiles (``block``: the median
    of 20 calls between CUDA events); each output checked against the
    plain version. Returns a dict."""
    g = torch.Generator(device="cuda").manual_seed(11)
    out = {"decode": {}, "block": {}}
    k = 4096
    for n, ms_ in ((28672, (64, 48, 32)), (6144, (64, 48, 32))):
        w = torch.randint(-128, 128, (k // 2, n), dtype=torch.int8,
                          generator=g, device="cuda")
        sw = (torch.rand((n,), generator=g, device="cuda") + 0.5) * 1e-3
        for m in ms_:
            x = torch.randn((m, k), generator=g, device="cuda").to(
                torch.bfloat16)
            want = tim.matmul_w4_torch(x, w, sw)
            o = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")
            calls = {"tile": lambda i: tim._launch_wo_tile(
                         tim.matmul_w4, x, w, sw, o),
                     "decode": lambda i: tim._launch_wo_decode(
                         "aimet_w4_decode_gemm", tim.matmul_w4, x, w, sw, o,
                         k // 2)}
            for tag, call in calls.items():
                call(0)
                assert rel_err(o, want) < TOL_WO, ("KW4 sweep", m, n, tag)
                ms, _ = timed(call, 20, KW4_KERNELS)
                out["decode"][f"M={m} N={n} {tag}"] = ms
            del x, want, o
        del w
    for k, n, xt in TILE_SWEEP_KN:
        w = torch.randint(-128, 128, (k // 2, n), dtype=torch.int8,
                          generator=g, device="cuda")
        sw = (torch.rand((n,), generator=g, device="cuda") + 0.5) * 1e-3
        dt = torch.bfloat16 if xt == "bf16" else torch.float32
        for m in TILE_SWEEP_M:
            x = torch.randn((m, k), generator=g, device="cuda").to(dt)
            want = tim.matmul_w4_torch(x, w, sw)
            o = torch.empty((m, n), dtype=dt, device="cuda")
            row = {"tiles": tim.tile_count(m, n, dt)}
            for tag, call in (
                    ("tile", lambda i: tim._launch_wo_tile(
                        tim.matmul_w4, x, w, sw, o)),
                    ("bf_tile", lambda i: tim._launch_bf_tile(
                        "aimet_w4_gemm", tim.matmul_w4, x, w, sw, o))):
                call(0)
                assert rel_err(o, want) < TOL_WO, ("KW4 sweep", m, k, n, tag)
                row[tag], _ = event_ms(call, 20)
            out["block"][f"M={m} K={k} N={n} {xt}"] = row
            del x, want, o
        del w
    log("  KW4 decode route against the tile (K 4096), ms: " + ", ".join(
        f"{k_} {v:.4f}" for k_, v in out["decode"].items()))
    log("  KW4 tile against the block tile, ms (output tiles): " + ", ".join(
        f"{k_}: {r['tile']:.4f} / {r['bf_tile']:.4f} ({r['tiles']})"
        for k_, r in out["block"].items()))
    return out


def w4_slice() -> int:
    """``python3 chip_smoke.py --w4-slice``: KW4 and the paths it carries,
    on whatever tree holds this script (copied into a parent tree, it
    measures that tree with the same code): KW4's rows (``kw4_rows``:
    decode M and prefill M, bf16 x, against the plain version first), its
    f32 lm_head row, K1 at decode M, KW4 alone at the lowered Llama-3-8B
    forward's linears (``kw4_lowered``) and, where the tree has the
    shared tile's helpers, ``tile_sweep``; then Llama-3-8B (32 layers) in
    w4: a prefill of 8 x 512 (2 profiled), 4 profiled per-slot decode
    steps at batch 16 and the continuous batcher (``run_batcher``, timed,
    then profiled). Prints
    one JSON line of the numbers."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from aimet_tpu_torch import _build
    from aimet_tpu_torch.models.transformer import TransformerConfig
    from aimet_tpu_torch.ops import int_matmul as tim
    from aimet_tpu_torch.serving import quantized_llm as qllm
    KERNEL_FNS.update({"w4_gemm": tim.matmul_w4,
                       "act_quant": tim.quantize_activation_per_row})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    log(f"w4 slice of {ROOT}: torch {torch.__version__}; {smi}")
    t = time.time()
    _build.build()
    _build.library()
    log(f"build: {time.time() - t:.1f} s")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(1)
    rows, errs = {}, {"w4_gemm": 0.0, "act_quant": 0.0}

    def note(name, a, b):
        errs[name] = max(errs[name], (a.float() - b.float()).abs().max()
                         .item())
    gemm_row = gemm_timer(rows)
    kw4_rows(torch, tim, g, rows, gemm_row, note)
    m, k, n = 4096, 4096, 128256
    x = torch.randn((m, k), generator=g, device="cuda")
    w = torch.randint(-128, 128, (k // 2, n), dtype=torch.int8, generator=g,
                      device="cuda")
    sw = torch.rand((n,), generator=g, device="cuda") * 1e-3
    err = rel_err(tim.matmul_w4(x, w, sw), tim.matmul_w4_torch(x, w, sw))
    assert err < TOL_WO_F32, ("KW4 f32", err)
    log(f"w4_gemm[f32 lm_head]: within {err:.2e} of max (< {TOL_WO_F32})")
    gemm_row("w4_gemm[f32 lm_head]", "w4_gemm", m, k, n,
             lambda i: tim.matmul_w4(x, w, sw),
             lambda i: tim.matmul_w4_torch(x, w, sw), KW4_KERNELS,
             m * k * 4 + w.numel(), BF16_FLOPS / 2, out_bytes=m * n * 4,
             iters=5)
    del x, w
    k1_decode_rows(torch, tim, g, rows, note)
    lowered = kw4_lowered(torch, tim, g)
    sweep = tile_sweep(torch, tim) if hasattr(tim, "tile_count") else None
    for name, r in rows.items():
        log(f"  {name:28s} {r['shape']}: kernel {r['ms']:.5f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms "
            f"({r['bound_by']}), library {r.get('library_ms')}, route "
            f"{r.get('route')}")
    cfg = TransformerConfig.llama3_8b()
    g = torch.Generator(device="cuda").manual_seed(2)
    qw = qllm.random_quantized_weights(cfg, mode="w4", seed=0)
    llm = qllm.QuantizedLLM.from_quantized(qw, cfg, mode="w4", max_len=1024)
    metrics = {"prefill_8x512": profile_prefill(torch, llm, cfg, g, "w4")}
    toks = torch.randint(0, cfg.vocab_size, (16, 512), generator=g,
                         device="cuda")
    logits, caches = llm.prefill(toks, llm.new_caches(16))
    tok = logits[:, -1].argmax(-1)[:, None]
    del logits
    slot_step_profile(torch, llm, "w4", tok, caches,
                      torch.arange(16, device="cuda", dtype=torch.int32)
                      + 512, metrics, 16)
    del caches
    metrics["cb"] = profile_batcher(torch, llm, cfg, "w4", tim.matmul_w4)
    log(json.dumps({"w4_slice": {"root": ROOT, "card": smi, "rows": rows,
                                 "errs": errs, "kw4_lowered": lowered,
                                 "tile_sweep": sweep,
                                 "e2e": metrics}}))
    return 0


def prefill_label(kernel, k, n):
    return (f"{kernel}[prefill]" if n == 28672 else
            f"{kernel}[prefill lm_head]" if n == 131072 else
            f"{kernel}[prefill {k}x{n}]")


def prefill_rows(torch, tim, g, rows, gemm_row, note):
    """KW8 and K2 at the serving prefill's shapes (M = 4096, PREFILL_KN;
    KW8 on a bf16 x, K2 on its per-row int8 codes): each held against its
    plain version (KW8 within TOL_WO, K2 bit-exact; both repeating their
    bits) before it is timed with 3 weight copies rotated."""
    m = 4096
    for k, n in PREFILL_KN:
        sw = (torch.rand((n,), generator=g, device="cuda") + 0.5) * 0.02 \
            / k ** 0.5
        x = torch.randn((m, k), generator=g, device="cuda").to(torch.bfloat16)
        ws = [torch.randint(-128, 128, (k, n), dtype=torch.int8, generator=g,
                            device="cuda") for _ in range(3)]
        got = tim.matmul_w8(x, ws[0], sw)
        want = tim.matmul_w8_torch(x, ws[0], sw)
        note("w8_gemm", got, want)
        err = rel_err(got, want)
        assert err < TOL_WO, ("KW8 prefill", k, n, err)
        assert torch.equal(tim.matmul_w8(x, ws[0], sw), got), \
            ("KW8 prefill", k, n, "repeat")
        del got, want
        gemm_row(prefill_label("w8_gemm", k, n), "w8_gemm", m, k, n,
                 lambda i: tim.matmul_w8(x, ws[i % 3], sw),
                 lambda i: tim.matmul_w8_torch(x, ws[i % 3], sw),
                 KW8_KERNELS, m * k * 2 + k * n, BF16_FLOPS, iters=5)
        del ws
        xq, sx = tim.quantize_activation_per_row(x)
        ws = [torch.randint(-128, 128, (k // 2, n), dtype=torch.int8,
                            generator=g, device="cuda") for _ in range(3)]
        got = tim.w4a8_gemm(xq, sx, ws[0], sw, torch.bfloat16)
        want = tim.w4a8_gemm_torch(xq, sx, ws[0], sw, torch.bfloat16)
        note("w4a8_gemm", got, want)
        assert torch.equal(got, want), ("K2 prefill", k, n)
        assert torch.equal(tim.w4a8_gemm(xq, sx, ws[0], sw, torch.bfloat16),
                           got), ("K2 prefill", k, n, "repeat")
        del got, want
        gemm_row(prefill_label("w4a8_gemm", k, n), "w4a8_gemm", m, k, n,
                 lambda i: tim.w4a8_gemm(xq, sx, ws[i % 3], sw,
                                         torch.bfloat16),
                 lambda i: tim.w4a8_gemm_torch(xq, sx, ws[i % 3], sw,
                                               torch.bfloat16),
                 K2_KERNELS, m * k + m * 4 + k // 2 * n, INT8_OPS, iters=5)
        log(f"KW8 and K2 at M={m}, K={k}, N={n}: KW8 within {err:.2e} of max "
            f"(< {TOL_WO}), K2 bit-exact, repeated calls the same bits")
        del ws, x, xq


def w8_f32_lm_head(torch, tim, g, rows, gemm_row, note, library=True):
    """KW8 on the lowered model's f32 lm_head (M = 4096, K = 4096, N =
    128256, f32 out) within TOL_WO_F32 of its plain version, then timed;
    with ``library``, torch._weight_int8pack_mm on the same f32 x (the
    row's library column where it takes one; else its error is the row's
    library note)."""
    m, k, n = 4096, 4096, 128256
    x = torch.randn((m, k), generator=g, device="cuda")
    w = torch.randint(-128, 128, (k, n), dtype=torch.int8, generator=g,
                      device="cuda")
    sw = torch.rand((n,), generator=g, device="cuda") * 1e-3
    got, want = tim.matmul_w8(x, w, sw), tim.matmul_w8_torch(x, w, sw)
    note("w8_gemm", got, want)
    err = rel_err(got, want)
    assert got.dtype == torch.float32 and err < TOL_WO_F32, ("KW8 f32", err)
    log(f"w8_gemm[f32 lm_head]: within {err:.2e} of max (< {TOL_WO_F32})")
    del want
    # f32 x is two bf16 operands: twice the bf16 tensor-core work
    gemm_row("w8_gemm[f32 lm_head]", "w8_gemm", m, k, n,
             lambda i: tim.matmul_w8(x, w, sw),
             lambda i: tim.matmul_w8_torch(x, w, sw), KW8_KERNELS,
             m * k * 4 + w.numel(), BF16_FLOPS / 2, out_bytes=m * n * 4,
             iters=5)
    if library:
        row = rows["w8_gemm[f32 lm_head]"]
        try:
            wt = w.t().contiguous()
            lib = torch._weight_int8pack_mm(x, wt, sw)
            row["library_err"] = rel_err(lib, got)
            del lib
            row["library_ms"], _ = event_ms(
                lambda i: torch._weight_int8pack_mm(x, wt, sw), 2)
            del wt
        except Exception as e:          # recorded: the row's library note
            row["library_note"] = f"torch._weight_int8pack_mm: {e}"[:200]
        log("  library for w8_gemm[f32 lm_head]: "
            + (f"{row['library_ms']:.3f} ms (within {row['library_err']:.2e}"
               " of the kernel's max)" if "library_ms" in row
               else row.get("library_note", "")))
    del x, w, got


def prefill_lowered(torch, tim, g):
    """KW8 and K2 alone at the lowered Llama-3-8B forward's linears
    (KW4_LOWERED_SHAPES, M = 4096, f32 out, as lower_to_int calls them in
    w8 and w4a8; K2 on the int8 codes of x): device ms of each and their
    sum over one forward's 225 launches. Returns a dict."""
    m, out = 4096, {}
    for kernel in ("w8_gemm", "w4a8_gemm"):
        total, res = 0.0, {}
        for k, n, count, xt in KW4_LOWERED_SHAPES:
            x = torch.randn((m, k), generator=g, device="cuda").to(
                torch.bfloat16 if xt == "bf16" else torch.float32)
            sw = torch.rand((n,), generator=g, device="cuda") * 1e-3
            if kernel == "w8_gemm":
                w = torch.randint(-128, 128, (k, n), dtype=torch.int8,
                                  generator=g, device="cuda")
                call = lambda i: tim.matmul_w8(x, w, sw, torch.float32)
                match = KW8_KERNELS
            else:
                w = torch.randint(-128, 128, (k // 2, n), dtype=torch.int8,
                                  generator=g, device="cuda")
                xq, sx = tim.quantize_activation_per_row(x)
                call = lambda i: tim.w4a8_gemm(xq, sx, w, sw, torch.float32)
                match = K2_KERNELS
            ms, _ = timed(call, 5, match)
            res[f"{k}x{n} {xt}"] = dict(ms=ms, launches=count)
            total += ms * count
            del x, w
        res["forward_ms"] = total
        out[kernel] = res
        log(f"{kernel} at the lowered forward's linears (M=4096, f32 out): "
            + ", ".join(f"{s_} {r['ms']:.3f} ms x {r['launches']}"
                        for s_, r in res.items() if s_ != "forward_ms")
            + f"; {total:.2f} ms a forward")
    return out


# prefill_sweep's crossing of KW8's and K2's tiles with their block
# tiles: x rows, and (K, N) at the layer projections (QKV, O, gate|up,
# down); the output tiles these give: 16 to 192 at N = 4096 and 6144
PREFILL_SWEEP_M = (65, 128, 192, 256, 384, 512, 1024)
PREFILL_SWEEP_KN = ((4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096))


def prefill_sweep(torch, tim):
    """The evidence for where KW8's and K2's tiles take over from their
    block tiles (``bf_tile`` / ``s8_tile``, split K): device ms of each
    route called directly on the same operands (the median of 20 calls
    between CUDA events) at PREFILL_SWEEP_M x PREFILL_SWEEP_KN, KW8 on a
    bf16 x (and an f32 x at 4096 x 4096), beside the tile's output tiles;
    each output checked against the plain version first (K2 bit for bit).
    Where the tree has them, KSQ's and KW4G's tiles the same way
    (``new_tile_sweep``). Returns {kernel: {...}}."""
    g = torch.Generator(device="cuda").manual_seed(12)
    out = {"w8_gemm": {}, "w4a8_gemm": {}}
    for k, n, xt in [(k, n, "bf16") for k, n in PREFILL_SWEEP_KN] + [
            (4096, 4096, "f32")]:
        dt = torch.bfloat16 if xt == "bf16" else torch.float32
        sw = (torch.rand((n,), generator=g, device="cuda") + 0.5) * 1e-3
        w8 = torch.randint(-128, 128, (k, n), dtype=torch.int8, generator=g,
                           device="cuda")
        w4 = torch.randint(-128, 128, (k // 2, n), dtype=torch.int8,
                           generator=g, device="cuda")
        for m in PREFILL_SWEEP_M:
            x = torch.randn((m, k), generator=g, device="cuda").to(dt)
            o = torch.empty((m, n), dtype=dt, device="cuda")
            want = tim.matmul_w8_torch(x, w8, sw)
            row = {"tiles": tim.tile_count(m, n, dt)}
            for tag, call in (
                    ("tile", lambda i: tim._launch_wo_tile(
                        tim.matmul_w8, x, w8, sw, o)),
                    ("bf_tile", lambda i: tim._launch_bf_tile(
                        "aimet_w8_gemm", tim.matmul_w8, x, w8, sw, o))):
                call(0)
                assert rel_err(o, want) < TOL_WO, ("KW8 sweep", m, k, n, tag)
                row[tag], _ = event_ms(call, 20)
            out["w8_gemm"][f"M={m} K={k} N={n} {xt}"] = row
            if xt == "bf16":
                xq, sx = tim.quantize_activation_per_row(x)
                o = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")
                want = tim.w4a8_gemm_torch(xq, sx, w4, sw, torch.bfloat16)
                row = {"tiles": tim.tile_count(m, n, torch.int8)}
                for tag, call in (
                        ("tile", lambda i: tim._launch_w4a8_tile(
                            xq, sx, w4, sw, o)),
                        ("s8_tile", lambda i: tim._launch_s8_tile(
                            xq, sx, w4, sw, o))):
                    call(0)
                    assert torch.equal(o, want), ("K2 sweep", m, k, n, tag)
                    row[tag], _ = event_ms(call, 20)
                out["w4a8_gemm"][f"M={m} K={k} N={n}"] = row
            del x, want, o
        del w8, w4
    for kernel, block in (("w8_gemm", "bf_tile"), ("w4a8_gemm", "s8_tile")):
        log(f"  {kernel} tile against {block}, ms (output tiles): "
            + ", ".join(f"{k_}: {r['tile']:.4f} / {r[block]:.4f} "
                        f"({r['tiles']})" for k_, r in out[kernel].items()))
    if hasattr(tim, "w4g_tile_route"):
        out.update(new_tile_sweep(torch, tim))
    return out


# new_tile_sweep's shapes: KSQ's (K, N) and KW4G's (K, N, x dtype), the
# lowered forward's linears (k / v: N = 1024) besides PREFILL_SWEEP_KN's
KSQ_SWEEP_KN = ((4096, 1024),) + PREFILL_SWEEP_KN
W4G_SWEEP_KN = ((4096, 1024, "bf16"), (4096, 4096, "bf16"),
                (4096, 14336, "bf16"), (14336, 4096, "bf16"),
                (4096, 1024, "f32"), (4096, 4096, "f32"))


# q8_tile_sweep's crossing of KQ8's tile and block tile: x rows, and (K, N)
# at ResNet-50's 3 x 3 conv patches (layer2, 1152 x 128, and wider) and at
# K 4096 and 14336 (the Llama-3-8B widths of KW8A8)
Q8_SWEEP_M = PREFILL_SWEEP_M + (2048,)
Q8_SWEEP_KN = ((1152, 128), (1152, 512), (4096, 1024), (4096, 2048),
               (14336, 1024), (14336, 4096))


def q8_tile_sweep(torch, tim):
    """Where KQ8's tile takes over from its block tile (``s8_tile``, split
    K): both routes called directly on the same int8 codes (the median of
    20 calls between CUDA events, f32 out, no bias; the block tile's
    zeroed split-K buffer included, as its route allocates it) at
    Q8_SWEEP_M x Q8_SWEEP_KN, outputs equal bit for bit, beside the tile's
    output tiles. Returns {"M=.. K=.. N=..": {"tiles", "tile",
    "s8_tile"}}."""
    g = torch.Generator(device="cuda").manual_seed(15)
    out = {}
    for k, n in Q8_SWEEP_KN:
        w = torch.randint(-127, 128, (k, n), dtype=torch.int8, generator=g,
                          device="cuda")
        sw = torch.rand((n,), generator=g, device="cuda") * 1e-3
        for m in Q8_SWEEP_M:
            xq = torch.randint(-127, 128, (m, k), dtype=torch.int8,
                               generator=g, device="cuda")
            sx = torch.rand((m,), generator=g, device="cuda")
            o = torch.empty((m, n), device="cuda")
            row = {"tiles": tim.tile_count(m, n, torch.int8)}
            got = {}
            for tag, call in (
                    ("tile", lambda i: tim._launch_q8_tile(
                        xq, sx, w, sw, None, o)),
                    ("s8_tile", lambda i: tim._launch_q8_s8_tile(
                        xq, sx, w, sw, None, torch.float32))):
                got[tag] = call(0).clone()
                row[tag], _ = event_ms(call, 20)
            assert torch.equal(got["tile"], got["s8_tile"]), \
                ("KQ8 sweep", m, k, n)
            out[f"M={m} K={k} N={n}"] = row
            del xq, o, got
        del w
    log("  q8_gemm tile against s8_tile, ms (output tiles): " + ", ".join(
        f"{k_}: {r['tile']:.4f} / {r['s8_tile']:.4f} ({r['tiles']})"
        for k_, r in out.items()))
    return out


def new_tile_sweep(torch, tim):
    """Where KSQ's, KW4G's and KQ8's tiles take over from their block tiles
    (``s8_tile`` / ``bf_tile``, split K): each route called directly on
    the same operands (the median of 20 calls between CUDA events) at
    PREFILL_SWEEP_M x KSQ_SWEEP_KN (KSQ on int8 codes, its GEMM alone; the
    two routes' outputs equal bit for bit) and x W4G_SWEEP_KN (KW4G, group
    128, f32 out for an f32 x; both within TOL_WO of the plain version),
    beside the tile's output tiles; KQ8's on a tree that has its tile
    (``q8_tile_sweep``). Returns {"w8a8_staticq": {...},
    "w4_grouped_gemm": {...}, "q8_gemm": {...} or None}."""
    g = torch.Generator(device="cuda").manual_seed(14)
    out = {"w8a8_staticq": {}, "w4_grouped_gemm": {},
           "q8_gemm": (q8_tile_sweep(torch, tim)
                       if hasattr(tim, "q8_tile_route") else None)}
    for k, n in KSQ_SWEEP_KN:
        w = torch.randint(-127, 128, (k, n), dtype=torch.int8, generator=g,
                          device="cuda")
        sv = torch.rand((n,), generator=g, device="cuda") * 1e-4
        cb = torch.randn((n,), generator=g, device="cuda")
        for m in PREFILL_SWEEP_M:
            xq = torch.randint(-128, 128, (m, k), dtype=torch.int8,
                               generator=g, device="cuda")
            o = torch.empty((m, n), device="cuda")
            row = {"tiles": tim.tile_count(m, n, torch.int8)}
            got = {}
            for tag, call in (
                    ("tile", lambda i: tim._launch_staticq_tile(
                        xq, w, sv, cb, o)),
                    ("s8_tile", lambda i: tim._launch_staticq_s8_tile(
                        xq, w, sv, cb, o))):
                got[tag] = call(0).clone()
                row[tag], _ = event_ms(call, 20)
            assert torch.equal(got["tile"], got["s8_tile"]), \
                ("KSQ sweep", m, k, n)
            out["w8a8_staticq"][f"M={m} K={k} N={n}"] = row
            del xq, o, got
        del w
    for k, n, xt in W4G_SWEEP_KN:
        dt = torch.bfloat16 if xt == "bf16" else torch.float32
        packed, sc = tim.quantize_weight_int4_grouped(
            torch.randn((k, n), generator=g, device="cuda") * 0.02, 128)
        for m in PREFILL_SWEEP_M:
            x = torch.randn((m, k), generator=g, device="cuda").to(dt)
            want = tim.matmul_w4_grouped_torch(x, packed, sc, 128)
            o = torch.empty((m, n), dtype=dt, device="cuda")
            row = {"tiles": tim.w4g_tile_count(m, n, dt)}
            for tag, call in (
                    ("tile", lambda i: tim._launch_w4g_tile(
                        x, packed, sc, o, 128)),
                    ("bf_tile", lambda i: tim._launch_bf_tile(
                        "aimet_w4g_gemm", tim.matmul_w4_grouped, x, packed,
                        sc, o, 128))):
                call(0)
                assert rel_err(o, want) < TOL_WO, ("KW4G sweep", m, k, n,
                                                   xt, tag)
                row[tag], _ = event_ms(call, 20)
            out["w4_grouped_gemm"][f"M={m} K={k} N={n} {xt}"] = row
            del x, want, o
        del packed, sc
    for kernel, block in (("w8a8_staticq", "s8_tile"),
                          ("w4_grouped_gemm", "bf_tile")):
        log(f"  {kernel} tile against {block}, ms (output tiles): "
            + ", ".join(f"{k_}: {r['tile']:.4f} / {r[block]:.4f} "
                        f"({r['tiles']})" for k_, r in out[kernel].items()))
    return out


# Variants of the prefill tile for --prefill-slice: name -> (text,
# replacement, occurrences) applied in turn to csrc/wgmma_wo_tile.cuh.
# "constant A": every weight word a constant, so the A fragments are fixed
# at compile time and no shared load or unpack runs: the MMAs and the TMA
# ring alone (the outputs are wrong there, and only timed; every kind
# the tree has); "168
# registers": the 384-thread block without setmaxnreg; "one-warp
# producer": 288 threads, 168 registers a thread, as the tile was built
# before its producer became a warpgroup.
_NREG = ("constexpr bool kSetMaxNReg = true;",
         "constexpr bool kSetMaxNReg = false;", 1)
TILE_VARIANTS = {
    "as built": (),
    "constant A": (("wv[i] = word(r);", "wv[i] = 0x11111111u * (i + 1);",
                    None),),
    "168 registers": (_NREG,),
    "one-warp producer": (_NREG, ("constexpr int kProducerWarps = 4;",
                                  "constexpr int kProducerWarps = 1;", 1)),
}


def tile_variant_child(path):
    """In a process of its own (several kernel libraries in one process
    refused launches): KW4, KW8 (bf16 x) and K2 at M = 4096, 4096 x 28672
    through the tiles of the library at ``path`` (the median of 10 calls
    between CUDA events each), and where the tree has them KSQ (its GEMM
    on int8 codes) and KW4G (bf16 x, group 128) at the same shape and
    KW4G at 4096 x 14336 with the f32 x of the lowered forward; prints
    one JSON line {case: ms}."""
    import ctypes
    import torch
    sys.path.insert(0, ROOT)
    from aimet_tpu_torch import _build
    from aimet_tpu_torch.ops import int_matmul as tim
    lib = ctypes.CDLL(path)
    for fn in ("aimet_w4_tile_gemm", "aimet_w8_tile_gemm",
               "aimet_w4a8_tile_gemm", "aimet_staticq_tile_gemm",
               "aimet_w4g_tile_gemm"):
        if fn in _build.SIGNATURES:
            getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
    _build.library = lambda: lib
    g = torch.Generator(device="cuda").manual_seed(13)
    m, k, n = 4096, 4096, 28672
    x = torch.randn((m, k), generator=g, device="cuda").to(torch.bfloat16)
    xq, sx = tim._quantize_activation_plain(x)
    sw = torch.rand((n,), generator=g, device="cuda") * 1e-3
    w8 = torch.randint(-128, 128, (k, n), dtype=torch.int8, generator=g,
                       device="cuda")
    w4 = torch.randint(-128, 128, (k // 2, n), dtype=torch.int8,
                       generator=g, device="cuda")
    o = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")
    cases = {"KW4": lambda i: tim._launch_wo_tile(tim.matmul_w4, x, w4, sw,
                                                  o),
             "KW8": lambda i: tim._launch_wo_tile(tim.matmul_w8, x, w8, sw,
                                                  o),
             "K2": lambda i: tim._launch_w4a8_tile(xq, sx, w4, sw, o)}
    if hasattr(tim, "w4g_tile_route"):
        w8q = torch.randint(-127, 128, (k, n), dtype=torch.int8, generator=g,
                            device="cuda")
        cb = torch.randn((n,), generator=g, device="cuda")
        gp, gs = tim.quantize_weight_int4_grouped(
            torch.randn((k, n), generator=g, device="cuda") * 0.02, 128)
        n2 = 14336
        gp2, gs2 = gp[:, :n2].contiguous(), gs[:, :n2].contiguous()
        xf = torch.randn((m, k), generator=g, device="cuda")
        of = torch.empty((m, n2), device="cuda")
        cases.update({
            "KSQ": lambda i: tim._launch_staticq_tile(xq, w8q, sw, cb, o),
            "KW4G": lambda i: tim._launch_w4g_tile(x, gp, gs, o, 128),
            "KW4G f32 4096x14336": lambda i: tim._launch_w4g_tile(
                xf, gp2, gs2, of, 128)})
    res = {}
    for case, call in cases.items():
        call(0)
        torch.cuda.synchronize()
        res[case], _ = event_ms(call, 10)
    print(json.dumps(res))


def tile_variants():
    """What the weight unpack and the register split cost the prefill
    tile: KW4, KW8 and K2 at M = 4096, 4096 x 28672 (bf16 out) built as
    they are and as each TILE_VARIANTS entry, each library timed in a
    process of its own (``tile_variant_child``), two rounds, the second
    in reverse order. Returns {case: {variant: [ms, ms]}}."""
    from aimet_tpu_torch import _build
    t = time.time()
    paths = variant_builds(_build, TILE_VARIANTS, "wgmma_wo_tile.cuh",
                           ("wo_gemm.cu", "w4a8_gemm.cu", "w8a8_staticq.cu"),
                           "tile_variants")
    log(f"  {len(paths)} tile variants built in {time.time() - t:.1f} s")
    res = {}
    for order in (list(paths), list(paths)[::-1]):
        for name in order:
            out = subprocess.run(
                [sys.executable, "-c", "import chip_smoke; "
                 f"chip_smoke.tile_variant_child({paths[name]!r})"],
                cwd=ROOT, capture_output=True, text=True, timeout=300)
            assert out.returncode == 0, ("variant", name, out.stderr[-2000:])
            for case, ms in json.loads(
                    out.stdout.strip().splitlines()[-1]).items():
                res.setdefault(case, {}).setdefault(name, []).append(ms)
    log("  tile variants at M=4096, K=4096, N=28672, ms (two rounds): "
        + "; ".join(f"{c} " + ", ".join(f"{v} {a[0]:.4f} / {a[1]:.4f}"
                                        for v, a in r.items())
                    for c, r in res.items()))
    return res


def prefill_slice() -> int:
    """``python3 chip_smoke.py --prefill-slice``: KW8 and K2 at prefill M
    and the paths they carry, on whatever tree holds this script (copied
    into a parent tree, it measures that tree with the same code): their
    rows at the serving prefill's shapes (``prefill_rows``, against the
    plain versions first), KW8's f32 lm_head, both alone at the lowered
    Llama-3-8B forward's linears (``prefill_lowered``) and, where the tree
    has their tiles, ``prefill_sweep`` and ``tile_variants`` (with the
    library probe of the f32 lm_head); then Llama-3-8B (32 layers) in w8
    and w4a8: a prefill of 8 x 512 (2 profiled), and in w4a8 the
    continuous batcher (timed, then profiled). Prints one JSON line of
    the numbers."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from aimet_tpu_torch import _build
    from aimet_tpu_torch.models.transformer import TransformerConfig
    from aimet_tpu_torch.ops import int_matmul as tim
    from aimet_tpu_torch.serving import quantized_llm as qllm
    KERNEL_FNS.update({"w8_gemm": tim.matmul_w8, "w4a8_gemm": tim.w4a8_gemm})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    log(f"prefill slice of {ROOT}: torch {torch.__version__}; {smi}")
    t = time.time()
    _build.build()
    _build.library()
    log(f"build: {time.time() - t:.1f} s")
    torch.backends.cuda.matmul.allow_tf32 = False
    new_tree = hasattr(tim, "w8_tile_route")
    g = torch.Generator(device="cuda").manual_seed(1)
    rows, errs = {}, {"w8_gemm": 0.0, "w4a8_gemm": 0.0}

    def note(name, a, b):
        errs[name] = max(errs[name], (a.float() - b.float()).abs().max()
                         .item())
    gemm_row = gemm_timer(rows)
    prefill_rows(torch, tim, g, rows, gemm_row, note)
    w8_f32_lm_head(torch, tim, g, rows, gemm_row, note, library=new_tree)
    lowered = prefill_lowered(torch, tim, g)
    sweep = prefill_sweep(torch, tim) if new_tree else None
    # KW4's crossing again: its tile's block changed with KW8's and K2's
    kw4_sweep = tile_sweep(torch, tim) if new_tree else None
    variants = tile_variants() if new_tree else None
    for name, r in rows.items():
        log(f"  {name:32s} {r['shape']}: kernel {r['ms']:.5f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms "
            f"({r['bound_by']}), library {r.get('library_ms')}, route "
            f"{r.get('route')}")
    cfg = TransformerConfig.llama3_8b()
    g = torch.Generator(device="cuda").manual_seed(2)
    metrics = {}
    for mode in ("w8", "w4a8"):
        qw = qllm.random_quantized_weights(
            cfg, mode="w8" if mode == "w8" else "w4", seed=0)
        llm = qllm.QuantizedLLM.from_quantized(qw, cfg, mode=mode,
                                               max_len=1024)
        metrics[f"{mode}_prefill_8x512"] = profile_prefill(torch, llm, cfg,
                                                           g, mode)
        if mode == "w4a8":
            metrics["w4a8_cb"] = profile_batcher(torch, llm, cfg, mode,
                                                 tim.w4a8_gemm)
        del llm, qw
        torch.cuda.empty_cache()
    log(json.dumps({"prefill_slice": {
        "root": ROOT, "card": smi, "rows": rows, "errs": errs,
        "lowered": lowered, "sweep": sweep, "kw4_tile_sweep": kw4_sweep,
        "tile_variants": variants,
        "e2e": metrics}}))
    return 0


def lowered_kernels(torch, tim, g):
    """KSQ (at every linear and the lm_head, as in w8a8) and KW4G (group
    128, at the layer linears, as in w4g) alone at the lowered Llama-3-8B
    forward's shapes (KW4_LOWERED_SHAPES, M = 4096) with the x dtypes it
    passes (KSQ's output in x's dtype, KW4G's f32), and with an f32 x at
    each: device ms of each (the profiler over 5 calls) and the sum over
    one forward's launches of the former. Returns a dict."""
    m, out = 4096, {}
    enc = dict(inv_delta=1 / 0.0213, offset=-119.0, num_steps=255.0)
    for kernel in ("w8a8_staticq", "w4_grouped_gemm"):
        total, res = 0.0, {}
        for k, n, count, xt in KW4_LOWERED_SHAPES:
            if kernel == "w4_grouped_gemm" and n == 128256:
                continue                      # the lm_head is KSQ's
            for x_dt in dict.fromkeys((xt, "f32")):
                x = torch.randn((m, k), generator=g, device="cuda").to(
                    torch.float32 if x_dt == "f32" else torch.bfloat16)
                if kernel == "w8a8_staticq":
                    w = torch.randint(-127, 128, (k, n), dtype=torch.int8,
                                      generator=g, device="cuda")
                    sc = torch.rand((2, n), generator=g,
                                    device="cuda") * 1e-4
                    call = lambda i: tim.matmul_w8a8_staticq(
                        x, w, sc[0], sc[1], out_dtype=x.dtype, **enc)
                    match = ["staticq_"]
                else:
                    w, sc = tim.quantize_weight_int4_grouped(
                        torch.randn((k, n), generator=g,
                                    device="cuda") * 0.02, 128)
                    call = lambda i: tim.matmul_w4_grouped(
                        x, w, sc, group_size=128, out_dtype=torch.float32)
                    match = W4G_KERNELS
                ms, _ = timed(call, 5, match)
                if x_dt == xt:
                    res[f"{k}x{n} {xt}"] = dict(ms=ms, launches=count)
                    total += ms * count
                else:
                    res[f"{k}x{n} f32"] = dict(ms=ms, launches=0)
                del x, w, sc
        res["forward_ms"] = total
        out[kernel] = res
        log(f"{kernel} at the lowered forward's linears (M=4096; launches "
            "a forward, 0: an f32 x the forward does not pass): "
            + ", ".join(f"{s_} {r['ms']:.3f} ms x {r['launches']}"
                        for s_, r in res.items() if s_ != "forward_ms")
            + f"; {total:.2f} ms a forward")
    return out


def int8pack_rows(torch, g):
    """torch._weight_int8pack_mm (KW8's library column) at the serving
    prefill's M = 4096 on a bf16 x, at PREFILL_KN but gate|up (the main
    run times that one): ms (the median of 2 calls between CUDA events).
    Returns {shape: ms, or the error's text}."""
    m, out = 4096, {}
    for k, n in PREFILL_KN:
        if n == 28672:
            continue
        x = torch.randn((m, k), generator=g, device="cuda").to(
            torch.bfloat16)
        wt = torch.randint(-127, 128, (n, k), dtype=torch.int8, generator=g,
                           device="cuda")
        sw = (torch.rand((n,), generator=g, device="cuda") * 1e-3).to(
            torch.bfloat16)
        try:
            torch._weight_int8pack_mm(x, wt, sw)
            out[f"{k}x{n}"], _ = event_ms(
                lambda i: torch._weight_int8pack_mm(x, wt, sw), 2)
        except Exception as e:          # recorded: the row's library note
            out[f"{k}x{n}"] = f"torch._weight_int8pack_mm: {e}"[:200]
        del x, wt
    log("torch._weight_int8pack_mm at M=4096 (bf16 x), ms: " + ", ".join(
        f"{s_} {v if isinstance(v, str) else f'{v:.3f}'}"
        for s_, v in out.items()))
    return out


def lowered_slice() -> int:
    """``python3 chip_smoke.py --lowered-slice``: KSQ and KW4G on the
    quantsim -> lowering path, on whatever tree holds this script (copied
    into a parent tree, it measures that tree with the same code): both
    alone at the lowered Llama-3-8B forward's linears (``lowered_kernels``),
    and where the tree has their tiles the tiles' crossings with the block
    tiles (``new_tile_sweep``) and KW8's library column at the prefill
    shapes (``int8pack_rows``); then a float Llama-3-8B (32 layers, f32)
    calibrated and lowered in w8a8 and w4g, a forward of 8 x 512 a mode
    against the plain versions, 3 profiled (device ms by kernel). Prints
    one JSON line of the numbers."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from aimet_tpu_torch import _build
    from aimet_tpu_torch.ops import int_matmul as tim
    counters = {"w8a8_staticq": tim.matmul_w8a8_staticq,
                "w4_grouped_gemm": tim.matmul_w4_grouped}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    log(f"lowered slice of {ROOT}: torch {torch.__version__}; {smi}")
    t = time.time()
    _build.build()
    _build.library()
    log(f"build: {time.time() - t:.1f} s")
    torch.backends.cuda.matmul.allow_tf32 = False
    new_tree = hasattr(tim, "w4g_tile_route")
    g = torch.Generator(device="cuda").manual_seed(1)
    kernels = lowered_kernels(torch, tim, g)
    sweep = new_tile_sweep(torch, tim) if new_tree else None
    lib8 = int8pack_rows(torch, g) if new_tree else None
    t = time.time()
    metrics, _ = lowering(torch, tim, counters,
                          torch.Generator(device="cuda").manual_seed(2),
                          modes=("w8a8", "w4g"), fake_quant=False,
                          profiles=3)
    log(f"[lower] phase took {time.time() - t:.1f} s")
    log(json.dumps({"lowered_slice": {
        "root": ROOT, "card": smi, "kernels": kernels, "sweep": sweep,
        "int8pack": lib8, "e2e": metrics}}))
    return 0


# the shapes of the w4a8 per-slot step's projections at batch 16: (label,
# K, N), Llama-3-8B (QKV, O, gate|up, down, the padded lm_head)
STEP_KN = (("qkv", 4096, 6144), ("o", 4096, 4096), ("gate_up", 4096, 28672),
           ("down", 14336, 4096), ("lm_head", 4096, 131072))


def fused_step_rows(torch, tim):
    """K2's fused decode kernel against K1 + K2's decode route at M = 16
    and each STEP_KN shape (bf16 x and out, 3 weight copies rotated),
    outputs equal bit for bit: the median span of a call between CUDA
    events (all its kernels and the gap between them, 40 calls) and the
    sum of its kernels' device times (the profiler). Returns {shape:
    {"fused" / "k1_k2": [span, sum]}}."""
    g = torch.Generator(device="cuda").manual_seed(16)
    res = {}
    for label, k, n in STEP_KN:
        ws = [torch.randint(-128, 128, (k // 2, n), dtype=torch.int8,
                            generator=g, device="cuda") for _ in range(3)]
        sw = torch.rand((n,), generator=g, device="cuda") * 1e-3
        x = torch.randn((16, k), generator=g, device="cuda").to(
            torch.bfloat16)

        def fused(i):
            return tim.matmul_w4a8_fusedq(x, ws[i % 3], sw)

        def k1_k2(i):
            xq, sx = tim.quantize_activation_per_row(x)
            return tim.w4a8_gemm(xq, sx, ws[i % 3], sw, torch.bfloat16)
        assert torch.equal(fused(0), k1_k2(0)), ("fused step row", label)
        res[label] = {name: [event_ms(call, 40)[0], timed(call, 20)[0]]
                      for name, call in (("fused", fused), ("k1_k2", k1_k2))}
        log(f"  fused / K1 + K2, M=16 {label} (span / kernel sum, ms): "
            + "; ".join(f"{a} {v[0]:.5f} / {v[1]:.5f}"
                        for a, v in res[label].items()))
        del ws, x
    return res


def step_ab(torch, tim, llm, state, rounds=160):
    """The per-slot decode step's wall ms without the profiler, one step
    (then a sync) a sample, ``rounds`` samples a path. On a tree with the
    fused decode route, that route ("fused") and K1 + K2 ("k1_k2": the
    route switched off, the parent's path) alternate step by step in ABBA
    order in the same process, so the host's load drifts out of their
    difference; else the tree's own path ("as is"). Returns {arm: [ms,
    ...]}, and on such a tree "diff": k1_k2 - fused a step pair, [mean,
    standard error of the mean]."""
    route = getattr(tim, "w4a8_fusedq_decode_route", None)
    arms = ({"fused": route, "k1_k2": lambda *a: False} if route
            else {"as is": None})
    tok, caches, slots = state
    res = {a: [] for a in arms}
    try:
        for r in range(rounds):
            for arm in (list(arms) if r % 2 == 0 else list(arms)[::-1]):
                if route:
                    tim.w4a8_fusedq_decode_route = arms[arm]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, caches = llm.decode(tok, caches, slots)
                tok = logits[:, -1].argmax(-1)[:, None]
                slots = slots + 1
                torch.cuda.synchronize()
                res[arm].append((time.perf_counter() - t0) * 1e3)
    finally:
        if route:
            tim.w4a8_fusedq_decode_route = route
    text = "; ".join(f"{a} {sorted(v)[len(v) // 2]:.3f}"
                     for a, v in res.items())
    if route:
        d = [b - a for a, b in zip(res["fused"], res["k1_k2"])]
        mean = sum(d) / len(d)
        sd = (sum((x - mean) ** 2 for x in d) / (len(d) - 1)) ** 0.5
        res["diff"] = [mean, sd / len(d) ** 0.5]
        text += f"; k1_k2 - fused {mean:.3f} +- {res['diff'][1]:.3f}"
    log(f"  step without the profiler, wall ms ({rounds} steps a path; "
        f"medians, then the mean difference +- its standard error): {text}")
    return res


def digest(t):
    """A short hash of a tensor's bytes, to hold bits across two trees."""
    import hashlib

    import torch
    raw = t.contiguous().view(-1).view(torch.uint8).cpu().numpy()
    return hashlib.sha256(raw.tobytes()).hexdigest()[:16]


def ksol_int8_digest(torch, dsol, g):
    """KSOL with int8 dots (its row quantizer) at B = 16, S = 1024,
    position 700, Llama-3-8B widths, next QKV: digests of its outputs and
    of the caches it appended to."""
    from aimet_tpu_torch.models.transformer import (TransformerConfig,
                                                    rope_freqs)
    B, S, H, KH, D, Dm, F = 16, 1024, 32, 8, 128, 4096, 14336
    A, Nq, pos = H * D, (H + 2 * KH) * D, 700

    def pair(rows_, n):
        return (torch.randint(-128, 128, (rows_, n), dtype=torch.int8,
                              generator=g, device="cuda"),
                (torch.rand((n,), generator=g, device="cuda") + 0.5) * 0.02
                / (2 * rows_) ** 0.5)
    w = dict(wo_pair=pair(A // 2, Dm), gateup_pair=pair(Dm // 2, 2 * F),
             down_pair=pair(F // 2, Dm),
             mlp_gamma=torch.ones(Dm, dtype=torch.bfloat16, device="cuda"),
             next_qkv=(pair(Dm // 2, Nq),
                       torch.ones(Dm, dtype=torch.bfloat16, device="cuda")))
    a = attn_inputs(torch, g, B, S, torch.full((B,), pos, device="cuda",
                                               dtype=torch.int32))
    resid = torch.randn((B, Dm), generator=g, device="cuda").to(
        torch.bfloat16)
    cos, sin = rope_freqs(TransformerConfig.llama3_8b(),
                          torch.full((B,), pos, device="cuda"))
    out = dsol.sol_decode_layer(a[0], resid, a[3], a[4], a[5], a[6], pos, cos,
                                sin, **w, n_heads=H, n_kv_heads=KH,
                                int8_dots=True)
    return [digest(t) for t in (out[0], out[1], a[3], a[4])]


def k1_route_sweep(torch, tim):
    """K1's two kernels on about ROTATE_BYTES of x a shape (so from HBM),
    rows of K = 64..4608 f32 and 64..8192 bf16: the wide rows' kernel and,
    up to its K = 1024, the narrow rows' kernel holding 8, 16 and 32 KB of
    x a block, codes and scales equal across them; the median device ms of
    20 calls each (CUDA events). Returns {"K dtype": {variant: ms}}."""
    g = torch.Generator(device="cuda").manual_seed(13)
    res = {}
    for xt, tag, ks_ in ((torch.float32, "f32", (64, 147, 256, 576, 1024,
                                                  1152, 2048, 4608)),
                         (torch.bfloat16, "bf16", (64, 147, 512, 1024, 2048,
                                                   4096))):
        for k in ks_:
            elem = torch.empty((), dtype=xt).element_size()
            x = torch.randn((int(ROTATE_BYTES // (k * elem)), k),
                            generator=g, device="cuda").to(xt)
            want = tim._launch_act_quant(x, None)
            r = {"wide": event_ms(lambda i: tim._launch_act_quant(x, None),
                                  20)[0]}
            for stage in (8192, 16384, 32768) if k <= 1024 else ():
                plan = tim.act_quant_plan(k, xt, narrow_max_k=1024,
                                          stage_bytes=stage)
                got = tim._launch_act_quant(x, plan)
                assert all(torch.equal(a, b) for a, b in zip(got, want)), \
                    ("K1 sweep", k, tag, stage)
                r[f"narrow {stage // 1024} KB"] = event_ms(
                    lambda i, p_=plan: tim._launch_act_quant(x, p_), 20)[0]
            res[f"{k} {tag}"] = r
            log(f"  K1 at ({x.shape[0]}, {k}) {tag}, ms: "
                + ", ".join(f"{a} {v:.5f}" for a, v in r.items()))
            del x, want
    return res


def gqa_slice_rows(torch):
    """KGQA with only the API a parent tree has too: at B = 16, S = 1024,
    position 700 with a bf16 and an f32 q, and at S = 16,384, position
    16,000 with a bf16 q, each checked against its plain version
    (``check_gqa``), then timed with 4 cache sets rotated (device ms of all
    its kernels). Where the tree has ``gqa_chunk``, every chunk of
    GQA_CHUNKS at those shapes and at B = 32 and 1 (S = 1024): each within
    the bf16 tolerance of the plain version, the median of 20 calls (CUDA
    events). Returns a dict."""
    from aimet_tpu_torch.ops import decode_attention as gqa
    g = torch.Generator(device="cuda").manual_seed(14)
    KH, rep, D = 8, 4, 128
    res = {"rows": {}, "chunks": {}}
    for B, S, pos, dts in ((16, 1024, 700, ("bf16", "f32")),
                           (16, 16384, 16000, ("bf16",)),
                           (32, 1024, 700, ()), (1, 1024, 700, ())):
        zero = torch.zeros((B,), device="cuda", dtype=torch.int32)
        sets = [attn_inputs(torch, g, B, S, zero)[3:7] for _ in range(4)]
        for tag in dts or ("bf16",):
            xt = torch.bfloat16 if tag == "bf16" else torch.float32
            q = torch.randn((B, KH, rep, D), generator=g,
                            device="cuda").to(xt)
            label = f"B={B} S={S} position {pos} {tag} q"
            want = None
            if dts:
                _, want, err = check_gqa(torch, gqa, q, *sets[0], pos)
                ms, host = timed(lambda i: gqa.fused_gqa_decode_attention(
                    q, *sets[i % 4], pos), 20)
                res["rows"][label] = dict(ms=ms, call_ms=host, rel_err=err)
                log(f"  KGQA {label}: {ms:.5f} device ms, within {err:.3e} "
                    "of the plain version's max")
            if not hasattr(gqa, "gqa_chunk") or tag != "bf16":
                continue
            if want is None:
                want = gqa.fused_gqa_decode_attention_torch(q, *sets[0],
                                                            pos)
            bound = gqa_flip_bound(torch, q, *sets[0], pos) \
                + TOL_GQA_F32 * want.abs().max()
            if dts:
                res["rows"][label]["passes_ms"] = [timed(
                    lambda i: gqa.fused_gqa_decode_attention(
                        q, *sets[i % 4], pos), 20, [name])[0]
                    for name in GQA_KERNELS]
                log(f"  KGQA {label} by launch (scores, context), ms: "
                    + ", ".join(f"{v:.5f}" for v in
                                res["rows"][label]["passes_ms"]))
            r = {}
            for c in gqa.GQA_CHUNKS:
                got = gqa._launch_gqa(q, *sets[0], pos, c)
                assert ((got - want).abs() <= bound).all(), ("KGQA chunk",
                                                             c)
                r[c] = event_ms(lambda i, c=c: gqa._launch_gqa(
                    q, *sets[i % 4], pos, c), 20)[0]
            res["chunks"][label] = r
            log(f"  KGQA {label} by chunk (default "
                f"{gqa.gqa_chunk(B, KH, S)}), ms: "
                + ", ".join(f"{c} {v:.5f}" for c, v in r.items()))
        del sets
        torch.cuda.empty_cache()
    return res


def q8_slice() -> int:
    """``python3 chip_smoke.py --q8-slice``: KQ8, K1, K2 at decode M and
    KGQA on whatever tree holds this script, with only APIs a parent tree
    has too (``matmul_q8``, ``matmul_w8a8``, ``matmul_w4a8``,
    ``fused_gqa_decode_attention``; copied into a parent tree, it measures
    that tree with the same code): KQ8 at M = 4096, 14336
    x 4096 (with and without a column bias), ``matmul_w8a8`` at 4096 x
    28672 and at ResNet-50's 3 x 3 conv patches (25088 x 1152 x 128, f32),
    ``matmul_w4a8`` at K2_DECODE_SHAPES (bf16 x; f32 x at M = 16): each
    checked against its plain version, timed (device ms of all its
    kernels, the profiler over the calls) and its output's digest (the
    same seeded inputs on both trees: the digests hold the bits across
    them), K1's codes and KSOL's int8-dot outputs as digests, K1 at
    ResNet-50's conv patch shapes (f32 and bf16 x); where the tree has
    KQ8's tile its crossing sweep (``q8_tile_sweep``) and the fused decode
    kernel at the step's shapes (``fused_step_rows``), where it has K1's
    two kernels their crossing (``k1_route_sweep``); KGQA at S = 1024 and
    16,384 (``gqa_slice_rows``, with a chunk sweep where the tree has
    one); then
    the float ResNet-50 with every conv through ``conv2d_w8a8`` (one
    forward counted, 3 profiled) and the ``w4a8`` per-slot decode step of
    Llama-3-8B (32 layers, batch 16: launches by wrapper, 4 profiled, then
    160 unprofiled steps a path, ``step_ab``). Prints one JSON line of the
    numbers."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from aimet_tpu_torch import _build
    from aimet_tpu_torch.models.resnet import ResNet50
    from aimet_tpu_torch.models.transformer import TransformerConfig
    from aimet_tpu_torch.ops import decode_layer_sol as dsol
    from aimet_tpu_torch.ops import int_matmul as tim
    from aimet_tpu_torch.serving import quantized_llm as qllm
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    log(f"q8 slice of {ROOT}: torch {torch.__version__}; {smi}")
    t = time.time()
    _build.build()
    _build.library()
    log(f"build: {time.time() - t:.1f} s")
    torch.backends.cuda.matmul.allow_tf32 = False
    counters = {k: fn for k, fn in (
        ("act_quant", tim.quantize_activation_per_row),
        ("w4a8_gemm", tim.w4a8_gemm), ("q8_gemm", tim.matmul_q8),
        ("w8a8_fusedq", tim.matmul_w8a8_fusedq),
        ("w4a8_fusedq", getattr(tim, "matmul_w4a8_fusedq", None)))
        if fn is not None and hasattr(fn, "launches")}
    g = torch.Generator(device="cuda").manual_seed(1)
    rows = {}

    def row(label, call, plain, iters):
        got = call(0)
        assert torch.equal(got, plain()), (label, "against plain")
        assert torch.equal(call(0), got), (label, "repeat")
        ms, host = timed(call, iters)
        rows[label] = dict(ms=ms, call_ms=host, digest=digest(got))
        log(f"  {label}: {ms:.5f} device ms ({host:.4f} host ms a call), "
            f"bit-exact with the plain version, digest {digest(got)}")

    m, k, n = 4096, 14336, 4096
    xq = torch.randint(-127, 128, (m, k), dtype=torch.int8, generator=g,
                       device="cuda")
    sx = torch.rand((m,), generator=g, device="cuda") * 1e-2
    w = torch.randint(-127, 128, (k, n), dtype=torch.int8, generator=g,
                      device="cuda")
    sw = (torch.rand((n,), generator=g, device="cuda") + 0.5) * 2e-3
    cb = torch.randn((n,), generator=g, device="cuda")
    for bias, tag in ((None, ""), (cb, " bias")):
        row(f"q8_gemm[w_down{tag}]",
            lambda i, b=bias: tim.matmul_q8(xq, sx, w, sw, b,
                                            torch.bfloat16),
            lambda b=bias: tim.matmul_q8_torch(xq, sx, w, sw, b,
                                               torch.bfloat16), 10)
    del xq, w
    for label, (m, k, n, xt) in {
            "w8a8_fusedq[gate_up]": (4096, 4096, 28672, torch.bfloat16),
            "w8a8_fusedq[conv 3x3 patches]": (25088, 1152, 128,
                                              torch.float32)}.items():
        x = (torch.randn((m, k), generator=g, device="cuda") * 2).to(xt)
        w = torch.randint(-127, 128, (k, n), dtype=torch.int8, generator=g,
                          device="cuda")
        sw = (torch.rand((n,), generator=g, device="cuda") + 0.5) * 2e-3
        row(label, lambda i: tim.matmul_w8a8(x, w, sw),
            lambda: tim.matmul_w8a8_torch(x, w, sw), 10)
        del x, w
    for m, k, n in K2_DECODE_SHAPES:
        ws = [torch.randint(-128, 128, (k // 2, n), dtype=torch.int8,
                            generator=g, device="cuda") for _ in range(3)]
        sw = (torch.rand((n,), generator=g, device="cuda") + 0.5) * 0.02 \
            / k ** 0.5
        for xt in (torch.bfloat16, torch.float32):
            if xt == torch.float32 and m != 16:
                continue
            x = torch.randn((m, k), generator=g, device="cuda").to(xt)
            row(f"w4a8[M={m} {k}x{n} {str(xt).split('.')[-1]}]",
                lambda i: tim.matmul_w4a8(x, ws[i % 3], sw, torch.bfloat16),
                lambda: tim.matmul_w4a8_torch(x, ws[0], sw, torch.bfloat16),
                20)
        del ws
    bits = {}
    for m, k in ((16, 4096), (4096, 4096)):
        x = torch.randn((m, k), generator=g, device="cuda").to(torch.bfloat16)
        q, sc = tim.quantize_activation_per_row(x)
        pq, ps = tim._quantize_activation_plain(x)
        assert torch.equal(q, pq) and torch.equal(sc, ps), ("K1", m, k)
        bits[f"act_quant ({m}, {k})"] = [digest(q), digest(sc)]
    bits["sol_decode_layer int8_dots"] = ksol_int8_digest(
        torch, dsol, torch.Generator(device="cuda").manual_seed(3))
    log(f"  digests: {bits}")
    for m, k in K1_CONV_SHAPES:
        for xt, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            x = (torch.randn((m, k), generator=g, device="cuda") * 2).to(xt)
            row(f"act_quant[conv ({m}, {k}) {tag}]",
                lambda i: tim.quantize_activation_per_row(x)[0],
                lambda: tim._quantize_activation_plain(x)[0], 10)
            del x
    new_tree = hasattr(tim, "q8_tile_route")
    sweep = q8_tile_sweep(torch, tim) if new_tree else None
    k1_sweep = (k1_route_sweep(torch, tim) if hasattr(tim, "act_quant_plan")
                else None)
    gqa_m = gqa_slice_rows(torch)

    # ResNet-50 through the dynamic full-INT8 ops API (K1 + KQ8 per conv)
    g = torch.Generator(device="cuda").manual_seed(4)
    xs = resnet_inputs(torch, g, 2)
    model = float_cnn(torch, ResNet50, xs[1], seed=4)
    with torch.no_grad(), ops_api_convs(torch, tim, model):
        out, counts, _, _, _ = forward_stats(
            torch, lambda: model(xs[0]), counters)
        zero_counts(counters)
        model(xs[0])
        routes = dict(tim.matmul_q8.routes)
        wall, busy, dev, by_name = profile_steps(
            torch, lambda: model(xs[0]), n=3)
    cnn_m = dict(launches=counts, q8_routes=routes, host_ms=wall,
                 device_ms=dev, busy=busy, kernels=by_name,
                 digest=digest(out))
    log(f"[q8 slice] ResNet-50 ops API (32 images): launches {counts}; "
        f"3 profiled forwards: {wall:.2f} host ms, {dev:.3f} device ms, "
        f"busy {busy:.3f}; logits digest {digest(out)}")
    del model, xs, out
    torch.cuda.empty_cache()

    # the w4a8 per-slot decode step (w4 weights, as the main run serves)
    cfg = TransformerConfig.llama3_8b()
    g = torch.Generator(device="cuda").manual_seed(2)
    qw = qllm.random_quantized_weights(cfg, mode="w4", seed=0)
    llm = qllm.QuantizedLLM.from_quantized(qw, cfg, mode="w4a8",
                                           max_len=1024)
    toks = torch.randint(0, cfg.vocab_size, (16, 512), generator=g,
                         device="cuda")
    logits, caches = llm.prefill(toks, llm.new_caches(16))
    tok = logits[:, -1].argmax(-1)[:, None]
    slots = torch.arange(16, device="cuda", dtype=torch.int32) + 512
    zero_counts(counters)
    logits, caches = llm.decode(tok, caches, slots)
    step = {k_: fn.launches for k_, fn in counters.items() if fn.launches}
    log(f"[q8 slice] w4a8 per-slot step launches by wrapper: {step}")
    slot_m = {"launches": step}
    state = slot_step_profile(torch, llm, "w4a8",
                              logits[:, -1].argmax(-1)[:, None], caches,
                              slots + 1, slot_m, 16)
    slot_m["host_ab"] = step_ab(torch, tim, llm, state)
    del llm, caches, qw, state
    torch.cuda.empty_cache()
    fused_rows = fused_step_rows(torch, tim) if new_tree else None
    log(json.dumps({"q8_slice": {"root": ROOT, "card": smi, "rows": rows,
                                 "bits": bits, "sweep": sweep,
                                 "k1_route_sweep": k1_sweep, "gqa": gqa_m,
                                 "fused_step_rows": fused_rows,
                                 "resnet50_ops_api": cnn_m,
                                 "w4a8_slot_step": slot_m}}))
    return 0


def kernel_counters(tim, dattn, flay, dsol, gqa):
    """The kernels' wrappers by kernel name: each counts its launches."""
    return {"act_quant": tim.quantize_activation_per_row,
            "w4a8_gemm": tim.w4a8_gemm,
            "decode_attention": dattn.fused_decode_attention,
            "w4_gemm": tim.matmul_w4, "w8_gemm": tim.matmul_w8,
            "fused_wo_mlp": flay.fused_wo_mlp,
            "sol_decode_layer": dsol.sol_decode_layer,
            "w8a8_staticq": tim.matmul_w8a8_staticq,
            "w4_grouped_gemm": tim.matmul_w4_grouped,
            "w8a8_fusedq": tim.matmul_w8a8_fusedq,
            "q8_gemm": tim.matmul_q8,
            "w4a8_fusedq": tim.matmul_w4a8_fusedq,
            "fused_decode_layer": flay.fused_decode_layer,
            "gqa_decode_attention": gqa.fused_gqa_decode_attention}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from aimet_tpu_torch import _build
    from aimet_tpu_torch.models.transformer import TransformerConfig
    from aimet_tpu_torch.ops import decode_attention as gqa
    from aimet_tpu_torch.ops import decode_attention_fused as dattn
    from aimet_tpu_torch.ops import decode_layer_sol as dsol
    from aimet_tpu_torch.ops import fused_layer as flay
    from aimet_tpu_torch.ops import int_matmul as tim
    from aimet_tpu_torch.serving import quantized_llm as qllm
    ops = (tim, dattn, flay, dsol, gqa)
    counters = kernel_counters(*ops)

    KERNEL_FNS.update(counters)
    KERNEL_FNS.update({name: counters[kern] for name, (kern, _) in
                       ROUTE_KERNELS.items()})

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"device {torch.cuda.get_device_name(0)}; {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False

    # --- 1. build
    t = time.time()
    lib = _build.build()
    log(f"build: {time.time() - t:.1f} s -> {lib}")
    _build.library()

    # --- 2. kernels against their plain versions
    rows, chunk_sweep = check_kernels(torch, ops)
    splits = split_sweep(torch, tim)
    for name, r in rows.items():
        log(f"  {name:24s} {r['shape']}: kernel {r['ms']:.4f} ms on the "
            f"device ({r['call_ms']:.4f} ms per wrapper call), plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']})")
        if "phases" in r:
            log(f"  {'':24s} phase split (block 0's %globaltimer, median "
                "of 10 launches, ms): " + ", ".join(
                    f"{k} {v:.4f}" for k, v in r["phases"].items()))

    # --- 3 and 4. the main path of each mode at Llama-3-8B widths
    cfg = TransformerConfig.llama3_8b()
    g = torch.Generator(device="cuda").manual_seed(2)
    metrics, launches = ({"splits": splits, "k3_chunk_sweep": chunk_sweep},
                         {k: 0 for k in counters})

    def add_path(path, counts):
        for k, v in counts.items():
            launches[k] += v
        for name in PATH_KERNELS[path]:
            assert counts.get(name, 0) > 0, \
                f"kernel {name} never launched on the {path} path"

    for mode, batches in (("w4", (16, 32)), ("w4a8", (16, 32)),
                          ("w8", (16,))):
        if mode != "w4a8":                # w4a8 serves the w4 weights
            t = time.time()
            qw = qllm.random_quantized_weights(cfg, mode=mode, seed=0)
            torch.cuda.synchronize()
            gb = qllm.quantized_weight_bytes(qw) / 1e9
            log(f"[{mode}] weights: {gb:.3f} GB drawn in "
                f"{time.time() - t:.1f} s")
        llm = qllm.QuantizedLLM.from_quantized(qw, cfg, mode=mode,
                                               max_len=1024)
        m, counts = serve(torch, llm, cfg, mode, counters, g, batches)
        del llm
        for k, v in counts.items():
            launches[k] += v
        # w8's random int8 codes (RMS ~74 against ~4.6 for INT4) make every
        # layer amplify a one-ulp bf16 difference between two correct sums,
        # so w8 is compared on its first 4 layers (32: 9.5e-2 of the max)
        m.update(compare_whole_model(torch, qllm, ops, qw, cfg, mode, g,
                                     4 if mode == "w8" else cfg.n_layers))
        metrics.update({f"{mode}_{k}": v for k, v in m.items()})
        torch.cuda.empty_cache()
        if mode == "w4a8":
            # the w4 weights are still drawn: the decode step of the JAX
            # sweep (KDL), then KGQA on the caches its oracle wrote
            t = time.time()
            m, counts, caches, last = decode_step_path(torch, qllm, ops, qw,
                                                       cfg, counters, g)
            add_path("decode_step", counts)
            metrics.update(m)
            m, counts = gqa_on_serving_caches(torch, ops, cfg, caches, last,
                                              counters, g)
            add_path("gqa", counts)
            metrics.update(m)
            del caches
            torch.cuda.empty_cache()
            log(f"[decode step, gqa] phases took {time.time() - t:.1f} s")
            t = time.time()
            m, counts = long_cache_path(torch, qllm, ops, cfg, counters, g)
            add_path("long_cache", counts)
            metrics.update(m)
            log(f"[long cache] phase took {time.time() - t:.1f} s")
            t = time.time()
            m, counts = cb_bench(torch, qllm, qw, cfg, counters)
            add_path("cb_bench", counts)
            metrics.update(m)
            m, counts = cache_free_forward(torch, qllm, qw, cfg, counters, g)
            add_path("cache_free", counts)
            metrics.update(m)
            torch.cuda.empty_cache()
            log(f"[bench workload, cache-free] phases took "
                f"{time.time() - t:.1f} s")
    del qw

    # --- 5. quantsim calibration and true-INT lowering
    t = time.time()
    m, counts = lowering(torch, tim, counters, g)
    metrics.update(m)
    for k, v in counts.items():
        launches[k] += v
    log(f"[lower] phase took {time.time() - t:.1f} s")
    t = time.time()
    m, counts = lowering_block8(torch, tim, counters, g)
    metrics.update(m)
    for k, v in counts.items():
        launches[k] += v
    log(f"[lower block 8] phase took {time.time() - t:.1f} s")

    # --- 6. CNNs: ResNet-50 lowered per mode and through the ops API,
    # MobileNetV2 in w8a8
    t = time.time()
    m, counts, cnn_models = cnn(torch, tim, counters, g)
    metrics.update(m)
    for k, v in counts.items():
        launches[k] += v
    log(f"[cnn] phase took {time.time() - t:.1f} s")

    # --- 7. the PTQ path: equalize, calibrate, AdaRound, export / load,
    # lower (ResNet-50, MobileNetV2); SeqMSE on a float Llama-3-8B
    t = time.time()
    m, path_counts = ptq(torch, tim, counters, g, cnn_models, smi)
    metrics.update(m)
    for path, counts in path_counts.items():
        add_path(path, counts)
    log(f"[ptq] phase took {time.time() - t:.1f} s; {smi}")

    # --- 8. QAT + KD, GPTQ / GPTVQ and SmoothQuant on a float Llama-3-8B
    # (2 layers); BN re-estimation and QuantAnalyzer on the CNNs
    t = time.time()
    torch.cuda.empty_cache()
    m, path_counts = qat(torch, tim, counters, g, cnn_models, smi)
    metrics.update(m)
    for path, counts in path_counts.items():
        add_path(path, counts)
    log(f"[qat] phase took {time.time() - t:.1f} s; {smi}")

    # --- 9. AutoQuant + AMP on the ResNet-50, PEFT on a float Llama-3-8B
    # (2 layers)
    t = time.time()
    torch.cuda.empty_cache()
    m, path_counts = amp_peft(torch, tim, counters, g, cnn_models, smi, ops,
                              qllm)
    metrics.update(m)
    for path, counts in path_counts.items():
        add_path(path, counts)
    log(f"[amp, peft] phase took {time.time() - t:.1f} s; {smi}")

    # --- 10. DeepSpeech2 through the sim (scans) and lowered; compression
    # of the ResNet-50
    t = time.time()
    torch.cuda.empty_cache()
    m, path_counts = recurrent_compression(torch, tim, counters, g,
                                           cnn_models["resnet50"], smi)
    del cnn_models
    metrics["recurrent_compression"] = m
    for path, counts in path_counts.items():
        add_path(path, counts)
    log(f"[recurrent, compression] phase took {time.time() - t:.1f} s; "
        f"{smi}")
    for name, (kern, route) in ROUTE_KERNELS.items():
        launches[name] = ROUTE_LAUNCHES.get(f"{kern}:{route}", 0)
    for name in SOURCES:
        assert launches[name] > 0, f"kernel {name} never launched"
    for route in ("w4_gemm:decode", "w4_gemm:tile", "w8_gemm:tile",
                  "w4a8_gemm:tile", "w8a8_staticq:tile",
                  "w4_grouped_gemm:tile", "q8_gemm:tile",
                  "w4a8_fusedq:decode"):
        assert ROUTE_LAUNCHES.get(route, 0) > 0, f"{route} never launched"

    kernels = []
    for label, r in rows.items():
        src, replaces = SOURCES[r["kernel"]]
        replaces = r.get("replaces", replaces)
        kernels.append(dict(
            name=label, route="cuda", source=src, replaces=replaces,
            launches=launches[r["kernel"]], max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            shape=r["shape"], kernel_route=r.get("route") or "kernel",
            **{k: r[k] for k in ("int_mm_ms", "library_note", "library_err",
                                 "library_x", "codes_ms", "nmajor_ms",
                                 "k128_ms", "chunk", "s8_tile_ms",
                                 "k1_k2_ms") if k in r}))
    # the order of the kernels' redesign: first those slower than one
    # PyTorch call for the same function, then each route's launches on
    # the main paths x (ms - bound) at its main-path shapes (route_ranking)
    slower = sorted(((r["ms"] / r["library_ms"], label) for label, r in
                     rows.items() if r["library_ms"] and
                     r["library_ms"] < r["ms"]), reverse=True)
    t = time.time()
    torch.cuda.empty_cache()
    shape_gaps = route_shape_gaps(torch, tim)
    log(f"[ranking] {len(shape_gaps)} main-path GEMM shapes timed in "
        f"{time.time() - t:.1f} s")
    ranked = route_ranking(rows, launches, counters, shape_gaps)
    log("slower than the library call: " + ", ".join(
        f"{label} {x:.2f}x" for x, label in slower))
    log("launches x (ms - bound) by route, s:")
    for d in ranked:
        log(f"  {d['kernel']}:{d['route']} "
            + (f"{d['score_s']:.3f}" if d["score_s"] is not None
               else "not scored")
            + f" ({d['launches']} launches"
            + (f" x {d['gap_ms']:.4f} ms" if d["gap_ms"] is not None else "")
            + f", {d['basis']}"
            + (f": {', '.join(d['rows'])})" if d["rows"] else ")"))
    metrics["route_ranking"] = ranked
    metrics["route_launches"] = dict(ROUTE_LAUNCHES)
    metrics["route_shapes"] = [
        dict(kernel=key[0], route=key[1], m=key[2], n=key[3], k=key[4],
             x=key[5], out=key[6], group=key[7], launches=c,
             ms=shape_gaps[key][0], bound_ms=shape_gaps[key][1])
        for key, c in sorted(ROUTE_SHAPES.items()) if key in shape_gaps]
    log(json.dumps({"metrics": metrics, "launches": launches, "card": smi}))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def amp_peft_slice() -> int:
    """``python3 chip_smoke.py --amp-peft-slice``: build the kernels and run
    phase 9 alone (AutoQuant + AMP on the CNN phase's ResNet-50, drawn as
    phase 6 draws it; PEFT on the 2-layer Llama-3-8B), with the same checks
    and PATH_KERNELS as the whole script."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from aimet_tpu_torch import _build
    from aimet_tpu_torch.models.resnet import ResNet50
    from aimet_tpu_torch.ops import decode_attention as gqa
    from aimet_tpu_torch.ops import decode_attention_fused as dattn
    from aimet_tpu_torch.ops import decode_layer_sol as dsol
    from aimet_tpu_torch.ops import fused_layer as flay
    from aimet_tpu_torch.ops import int_matmul as tim
    from aimet_tpu_torch.serving import quantized_llm as qllm
    counters = kernel_counters(tim, dattn, flay, dsol, gqa)
    KERNEL_FNS.update(counters)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    t = time.time()
    _build.build()
    _build.library()
    log(f"build: {time.time() - t:.1f} s")
    g = torch.Generator(device="cuda").manual_seed(2)
    xs = resnet_inputs(torch, g, 6)
    model = float_cnn(torch, ResNet50, xs[5], seed=4)
    del xs
    t = time.time()
    metrics, paths = amp_peft(torch, tim, counters, g, {"resnet50": model},
                              smi, (tim, dattn, flay, dsol, gqa), qllm)
    log(f"[amp, peft] phase took {time.time() - t:.1f} s; {smi}")
    for path, counts in paths.items():
        for name in PATH_KERNELS[path]:
            assert counts.get(name, 0) > 0, \
                f"kernel {name} never launched on the {path} path"
    log(json.dumps(metrics, default=str))
    return 0


def recurrent_compression_slice() -> int:
    """``python3 chip_smoke.py --recurrent-compression-slice``: build the
    kernels and run phase 10 alone (DeepSpeech2; compression of the CNN
    phase's ResNet-50, drawn as phase 6 draws it), with the same checks and
    PATH_KERNELS as the whole script."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from aimet_tpu_torch import _build
    from aimet_tpu_torch.models.resnet import ResNet50
    from aimet_tpu_torch.ops import decode_attention as gqa
    from aimet_tpu_torch.ops import decode_attention_fused as dattn
    from aimet_tpu_torch.ops import decode_layer_sol as dsol
    from aimet_tpu_torch.ops import fused_layer as flay
    from aimet_tpu_torch.ops import int_matmul as tim
    counters = kernel_counters(tim, dattn, flay, dsol, gqa)
    KERNEL_FNS.update(counters)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    t = time.time()
    _build.build()
    _build.library()
    log(f"build: {time.time() - t:.1f} s")
    g = torch.Generator(device="cuda").manual_seed(2)
    xs = resnet_inputs(torch, g, 6)
    model = float_cnn(torch, ResNet50, xs[5], seed=4)
    del xs
    t = time.time()
    metrics, paths = recurrent_compression(torch, tim, counters, g, model,
                                           smi)
    log(f"[recurrent, compression] phase took {time.time() - t:.1f} s; "
        f"{smi}")
    for path, counts in paths.items():
        for name in PATH_KERNELS[path]:
            assert counts.get(name, 0) > 0, \
                f"kernel {name} never launched on the {path} path"
    log(json.dumps(metrics, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(layer_variants() if sys.argv[1:] == ["--layer-variants"]
             else amp_peft_slice() if sys.argv[1:] == ["--amp-peft-slice"]
             else recurrent_compression_slice()
             if sys.argv[1:] == ["--recurrent-compression-slice"]
             else decode_slice() if sys.argv[1:] == ["--decode-slice"]
             else w4_slice() if sys.argv[1:] == ["--w4-slice"]
             else prefill_slice() if sys.argv[1:] == ["--prefill-slice"]
             else lowered_slice() if sys.argv[1:] == ["--lowered-slice"]
             else q8_slice() if sys.argv[1:] == ["--q8-slice"]
             else main())
