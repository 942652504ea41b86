"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels (K1-K4) from
`realtime_kv_cache_compression_tpu_torch/csrc`, one nvcc per source, all at
once, and logs each K1 instance's registers, shared memory and spills
(none allowed in the tensor-core instances: K1's bf16 ones at head_dim
16-256, K3's prefill tile and K4's, each of which must hold wgmma
instructions, HGMMA or IGMMA for int8, where cuobjdump runs) and the stack
frame of every K2 instance. Checks each kernel (K1 in its one-shot mode
(a), chunked mode (b), positioned mode (d), the diagonal pair and the
non-causal pair (c), K2 over tiers + ring and with the decode pool and
scale groups, at the heads of TinyLlama, Llama-2-7B, Gemma-2B and
Gemma-7B, and both at Qwen2-7B's (28 over 4, n_rep 7; K1 also at
Qwen2-0.5B's 14 over 2), with its device time per call (one launch: the
splits merge inside it); K3 and K4 at the 7B matmul shapes, each on the
route its shape takes; K3's expert-indexed GEMV at Mixtral-8x7B's expert
shapes, the expert ids on the device, one kernel per call and no host
read) against its plain PyTorch version, in bf16 and float32, with its
time, bound and library yardstick (K1: its share of the bound and its
factor against SDPA; K3 and K4 at M=1 also the GEMV's device time per
launch; K4's yardstick torch._int_mm on the weights as kept and on a
K-major copy), and K1 mode (a) on the model's own activations (TinyLlama,
2 layers, full width, prompt 1024, bf16). K1's tuning surface
(`phase_k1_tuning`): the `kernel_autotune` CLI at TinyLlama's and
Llama-2-7B's heads (every built tile of mode (a) counted, held to its
plain version and timed), every built tile of modes (b), (c), (d) and the
diagonal pair held once to its plain version at the chunked and pair
phases' shapes, and mode (a)'s fold_gqa, exp_bf16 and stats_via_mxu
variants (fold_gqa also at Qwen2-0.5B's n_rep 7) each counted, held to
its plain version and timed; the build holds every new tensor-core
instance to no spill and wgmma in SASS, and the exp_bf16 instances to
exp2 on bf16 lanes. Then it drives these paths, each with every launch
count set to 0 just before it and read just after (K1 on its default
tile and kernel: no path passes a tile or a variant):

- TinyLlama-1.1B shape (22 layers, bf16, fused raw weights): compressed
  prefill with K1 and fused decode with K2, prompt 4096, batch 1, 128 new
  tokens, tiers 8/4/2, counted once (that run timed), plus the
  uncompressed arm and a torch.profiler breakdown; then the sampled decode
  on the same prefill (temperature 0.8, top-k 50, top-p 0.9, repetition
  penalty 1.1; 127 steps through K2), with its counts and logprobs checked,
  top-k 1 held to the greedy tokens, and its tok/s beside greedy;
- TinyLlama again, on the rest of the generation surface, with the main
  run's params: beam search (README's call: W=4, 64 new tokens, EOS 2;
  one prefill at B=1 through K1, then every step one K2 launch per layer
  at B·W rows), counted once, `num_beams=1` held to `generate`, K2 held
  against its plain version on every layer of the 4-row state after 6
  beam steps and their gathers, timed in turns with greedy `generate`
  (ms per token, TTFT, peak memory, the beam reindexing alone, a profile
  of 10 beam steps); speculative
  decoding over a prompt whose second half repeats its first (128 steps,
  4 drafts: `decode_loop` through K2, speculative with oracle drafts and
  with prompt lookup, where the plain verify forward replaces K2, and the
  adaptive controller with adversarial drafts, whose plain chunks run
  K2), each arm counted and timed in turns (forwards, tokens per forward,
  ms per token, the verify forward alone, bf16 agreement with
  `decode_loop`); and `forward_logits` (SDPA route against the plain
  route and against `prefill_uncompressed`'s last logits);
- TinyLlama's sequence-parallel prefill (`parallel/`) on the main run's
  weights and prompt: 4 ranks spawned as processes on this one card over
  a gloo group (collectives staged through the host), ring attention
  through K1's diagonal pair and mode (c) (22 r launches on rank r, its
  only path), each call held to its plain version; replicated
  compression against the one-shot prefill (logits against a float32
  one-shot, tier changes as rank reversals within the measured score
  drift), fully sharded compression byte for byte against
  `compress_layer_kv_chunked`, 32 greedy tokens through K2 from each
  state (the sharded one decoded from the shards with no gather, K2's
  lse mode 22 times a rank and step, each call held to its plain
  version, against the decode from the gathered state), float32 runs at
  tiny_test_model width (query-guided, ragged) whose tokens equal the
  one-shot path's and, from the shards, the gathered state's, TTFT by
  CUDA events for the one-shot and the 4-rank prefill with each rank's
  host staging, each rank's decode steps/s and tier bytes from the
  shards and from the gathered state, and K2's lse mode timed on a
  rank's shard;
- tensor, data and expert parallelism (`parallel/sharding.py`,
  `expert_parallel.py`): 4 ranks spawned on this one card over a gloo
  group, each holding its slice of the weights, on a 1 x 4 and a 2 x 2
  (data x model) mesh: TinyLlama at full width and depth on the main
  run's weights (B=1 on 1 x 4, B=2 on 2 x 2, prompt 4096, 32 greedy
  tokens) and a Mixtral-8x7B-width model cut to 4 layers on 1 x 4
  (prompt 1024, 16 tokens, experts on the model axis), K1 mode (a) and K2
  on every rank over its heads, launches exact per rank, every K1 and K2
  call held to its plain version, selection and tokens held to the
  one-rank prefill's, a float32 run at tiny_test_model width whose tokens
  equal the one-rank path's, and each rank's TTFT, staging and decode
  rate;
- training over a sharded tree on a 2 x 2 mesh and beam search and
  speculative decoding over one on a 1 x 4 mesh (4 ranks on this one
  card, TinyLlama width at 2 layers, float32): losses and each rank's
  weights held to the one-rank trainer's, ms a step and peak MB a rank;
  beam sequences and scores and speculative tokens equal to one rank's,
  K1 mode (a) and K2 launches exact per rank;
- Llama-2-7B (BIG_RUN_LAYERS = 4 of its 32 layers, hidden 4096, 32/32
  heads, d=128), bf16 random
  weights quantized with `quantize_params_streaming(bits=4)` and fused:
  every layer matmul through K3, embed and lm_head int8 weight-only; the
  same prompt, tiers and generation, counted once (that run timed), the
  uncompressed arm, and a profile;
- the same model under `quantize_params(bits=8, act_quant=True)`: every
  layer matmul and lm_head through K4, counted by route (the prefill's 128
  layer matmuls on the int8 tensor cores, every M=1 call on the GEMV);
- TinyLlama (TINY_PATH_LAYERS = 4 of its 22 layers here and in the next
  two paths) on the ragged, chunked, long-generation path: batch 2
  with lengths (4096, 3000) right-padded to 4096,
  `prefill_compressed_chunked` in 4 chunks of 1024 (K1 mode (b)), then 383
  greedy steps over a 64-token ring and a decode pool of 4 blocks at 4
  bits, with 2 scale groups per head (K2 with the pool), so every layer
  flushes its ring 5 times and wraps the pool; counted once, timed
  REPEATS_NEW times, the uncompressed arm with the same lengths, and a
  profile;
- TinyLlama on the compressed-prefix chunked path: batch 2 uniform rows
  of 4096, `prefill_compressed_prefix_chunked` in 4 chunks of 1024 (each
  chunk attends over the compressed pools of the earlier ones: K1 mode (d)
  plus the diagonal pair, merged), then 127 greedy steps through K2 over
  the chunk-packed tiers; counted once, timed REPEATS_NEW times beside the
  full-buffer `prefill_compressed_chunked` at the same shape, and a
  profile;
- TinyLlama with query-guided importance (`importance_source` "query"
  and "both", window automatic: 256 at 4096, mass pooled over 20 keys)
  beside the prompt-scored arm: the one-shot prefill (K1 mode (a)) and
  127 greedy steps (K2) at batch 1, and the chunked prefill (K1 mode (b),
  window query rows buffered across chunks) at batch 2 with lengths (4096,
  3000), each arm counted once and timed REPEATS_NEW times in turns, the
  query mass alone per layer, and a profile of the query-scored prefill;
- Gemma-2B (18 layers, hidden 2048, 8 query heads over 1 kv head,
  head_dim 256, vocab 256000, GeGLU, (1 + w) norms, scaled embeddings,
  tied head), bf16 random weights from SEED, fused: TinyLlama's traffic
  (prompt 4096, batch 1, 128 new tokens, tiers 8/4/2), counted once (that
  run timed), the uncompressed arm, and a profile;
- Qwen2-0.5B (QWEN2_LAYERS = 6 of its 24 layers, 14 query heads over
  2, d=64, q/k/v biases, tied head), bf16 random weights from SEED written as HF-named safetensors
  shards with an index and a config.json (the port's writer), read back
  by `config_from_hf` (the preset, field by field) and
  `load_hf_checkpoint` (every tensor bit-equal), then TinyLlama's traffic
  from the loaded params, counted, timed, the uncompressed arm and a
  profile, its tokens equal to the in-memory params';
- Mixtral-8x7B int4 at full width (MIXTRAL_LAYERS = 4 of its 32 layers,
  8 experts, top 2), built layer by layer (a one-layer bf16 init from SEED + i, then
  `quantize_params_streaming(bits=4)`): TinyLlama's traffic, counted by
  kernel and by K3 route (unfused attention on the tensor cores and the
  GEMV, every routed expert projection on the expert GEMV), the counted
  run timed, the uncompressed arm and a profile; then a
  checkpoint round trip of its layer 0, embedding and head, bit-equal;
- TinyLlama served by the continuous-batching engine (`serving/`): bf16
  fused weights, 4 slots over a 4096-token bucket, decode chunks of 8,
  `warmup()`, the one-shot 4096-token prefill timed (the effective
  throughput behind `estimate_prefill_seconds`), 8 prompts of 1024-4096
  tokens with budgets of 16-64 tokens at once (launches held to the
  engine's own schedule: K1 22 a prefill, K2 22 a decode step), a step
  with an admission in flight under the profiler, exact and partial
  prefix hits (no K1), chunked admission (K1 mode (b) 22 a chunk), and
  HTTP completions (4 concurrent, one streamed) held to the engine's
  text, tokens and logprobs;
- the trainer (`models/train.py`): three float32 steps on the card (SDPA
  and its backward) against three on the CPU (the plain attention), one
  2-layer model of width 256, the global clip triggered; then TinyLlama
  at full width and depth, bf16, 4 steps on one repeated batch of B=1 x
  2048 tokens (losses finite and falling, ms per step, training tok/s,
  peak memory; no kernel of the port's launched);
- the port's quality demo at the settings of the JAX package's r4 recall
  artifact: the trainer for 2500 steps on payload recall (float32, 4
  layers, width 128, d=32), then recall through every arm at fillers 48,
  112 and 240 on K1 and K2, launches held to the demo's schedule, the
  baseline at 0.95 or more at filler 48; at filler 240, four arms' K1 and
  K2 calls each held to the plain version on its own inputs, their tokens
  to the plain path's on every row whose two prefills keep the same
  positions, and every position kept otherwise held to a swap between
  near-equal importance scores; the table printed beside the r4
  artifact's;
- the LongBench harness through the port's `run_compression_experiment`
  (TinyLlama bf16, compressed and baseline arms, synthetic narrativeqa
  and gov_report prompts of about 3.9 K tokens, one at a time and then in
  ragged batches of 2): launches held to the runners' schedule, no error
  recorded, every sample evaluated; a float32 2-layer check of batched
  against sequential and kernels against plain;
- the six-scenario benchmark suite (`CompressionBenchmark`) at TinyLlama's
  full width and depth, sequence 4096, 50 new tokens, its launches held
  to its schedule;
- the other five experiment CLIs in-process, each with its launches held
  to its own schedule and its new configurations' kernel calls held to
  the plain versions: `ablation_study` (TinyLlama bf16, the component and
  bits studies; every config once more with each K1 and K2 call held to
  its plain version: tier sets (16, 8, 4), (8, 8, 4), (4, 4, 2) and
  all-16-bit, threshold tiers; the five studies' configs against a
  hard-coded list), `hyperparameter_tuning` (the four methods on its own
  4-layer model, d=16, float32; the Bayesian method fits the port's GP),
  `serving_benchmark` (its defaults at TinyLlama width),
  `speculative_benchmark` (a recall model trained by the port: speculative
  == greedy == adaptive, asserted by the CLI) and `chunked_prefix_quality`
  (a recall model trained by the port: its three arms, K1 mode (d) and
  the diagonal pair in float32 at d=32 held to their plain versions, and
  each arm's kernel tokens held to the plain path's up to a near tie).

Before the full runs, each path's kernel path is checked against the plain
path in float32 at reduced depth (2 layers, full width; Gemma-2B too): equal
greedy tokens, for the chunked path also chunked against one-shot prefill, and
for the compressed-prefix path equal kept positions and a single chunk
against `prefill_compressed`; for the serving engine (2 layers, 4 slots,
one-shot and chunked admission, an in-batch duplicate, an exact and a
partial prefix hit) equal tokens, stop reasons and kept ratios on the
kernels, on the plain versions and for each request alone at B=1 (up to
a near tie); for query-guided scoring ("query", "both")
equal kept positions and tokens, and chunked against one-shot prefill up
to a near-tie swap; for beam search (B=1, W=4, with and without an EOS
the model emits) equal sequences and scores within 1e-4 relative; for
speculative decoding (prompt lookup, oracle and the adaptive controller
with adversarial drafts, without and with a decode pool that flushes
twice) the tokens, positions, rings and pool validity of `decode_loop`
through K2, and `extend_prefill` against teacher-forced `decode_step`s
with its input state unchanged; for `forward_logits` the SDPA route
against the plain one; for Mixtral int4 (2 layers) the prefill logits and
the tokens up to the first near tie (phase_parity_mixtral). `select_tokens` with the exact greedy scan is
timed beside the default prefix at S=4096.
Any failed check exits nonzero. The last line is the device JSON; the line
before it lists every kernel.

Needs a CUDA device and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import importlib
import importlib.metadata
import json
import math
import os
import re
import subprocess
import sys
import time
import types

import torch

from realtime_kv_cache_compression_tpu_torch.utils.timing import (
    cuda_ms, spread as _spread)

PKG = "realtime_kv_cache_compression_tpu_torch"
JAX_PKG = "realtime_kv_cache_compression_tpu"
KERNELS = {  # key: (wrapper module, wrapper name, source, TPU kernel
    #                [, the wrapper's counter when not `launches`])
    "K1": ("flash_prefill", "flash_prefill_with_prompt_mass",
           f"{PKG}/csrc/flash_prefill.cu",
           f"{JAX_PKG}/ops/pallas/flash_prefill.py:39"),
    "K1b": ("flash_prefill", "flash_chunk_attention_with_prompt_mass",
            f"{PKG}/csrc/flash_prefill.cu",
            f"{JAX_PKG}/ops/pallas/flash_prefill.py:39"),
    "K1c": ("flash_prefill", "flash_full_pair_attention",
            f"{PKG}/csrc/flash_prefill_pair.cu",
            f"{JAX_PKG}/ops/pallas/flash_prefill.py:39"),
    "K1d": ("flash_prefill", "flash_positioned_attention",
            f"{PKG}/csrc/flash_prefill_positioned.cu",
            f"{JAX_PKG}/ops/pallas/flash_prefill.py:39"),
    "K1p": ("flash_prefill", "flash_diagonal_pair_attention",
            f"{PKG}/csrc/flash_prefill.cu",
            f"{JAX_PKG}/ops/pallas/flash_prefill.py:39"),
    "K2": ("decode_attention", "fused_decode_attention",
           f"{PKG}/csrc/decode_attention.cu",
           f"{JAX_PKG}/ops/pallas/decode_attention.py:143"),
    # K2's lse mode (return_lse=True: a slot shard's partial), counted on
    # the wrapper's `lse_launches`.
    "K2l": ("decode_attention", "fused_decode_attention",
            f"{PKG}/csrc/decode_attention.cu",
            f"{JAX_PKG}/ops/pallas/decode_attention.py:143",
            "lse_launches"),
    "K3": ("int4_matmul", "int4_matmul", f"{PKG}/csrc/int4_matmul.cu",
           f"{JAX_PKG}/ops/pallas/int4_matmul.py:46"),
    "K4": ("int8_matmul", "int8_matmul", f"{PKG}/csrc/int8_matmul.cu",
           f"{JAX_PKG}/ops/pallas/int8_matmul.py:42"),
}

# Tolerances. float32 kernel vs float32 reference: summation order and
# exp2-vs-exp rounding; K1 within 1e-4, K2 within 1e-5, prompt mass within
# 1e-5, K3 within 1e-4 of max|reference| (sums over K up to 11008 in
# another order). bf16 outputs: both sides compute in float32 and round to
# bf16 once, so an element may differ by one bf16 ulp of its own magnitude;
# the limit is two ulps of |reference| per element, plus a floor for the
# float32 difference before rounding: 1e-5 for attention outputs, and for
# K3 the float32 limit itself (1e-4 of max|reference|), since an output
# near zero after cancelling large terms carries the float32 difference of
# those terms and a tiny ulp. K4 is integer arithmetic with one epilogue in
# the same order on both sides: equal bit for bit. K1's chunked mode and
# K2 with the decode pool and scale groups are held to the same limits, and
# so are K1's positioned and pair modes; their log-sum-exp within 1e-5 on
# rows that see a key (float32 on both sides), -inf on the others. A bf16
# K1 output is the exception: its tensor cores take the probabilities
# rounded to bf16 (as the TPU kernel does), so it is held against the
# plain version on float32 copies of its inputs to the port's
# `bf16_output_limit`: two ulps plus 2^-8 (sum_j p_j |v_j|) / l (the
# plain version on |v|) plus 1e-5.
TOL_K1_F32 = 1e-4
TOL_K2_F32 = 1e-5
TOL_MASS = 1e-5
TOL_LSE = 1e-5
TOL_LOGITS = 1e-4  # float32 kernel path vs plain path, prefill logits
# Calls per timed reading in the K1 phases (kernel and plain version in
# turns).
K1_REPS = 5
# K1's exp_bf16 variant against the plain version with the same rounding
# (`prefill_attention_with_prompt_mass(exp_bf16=True)`, which models the
# card's ex2.approx.ftz.bf16x2 bit for bit and rounds against the kernel's
# running maximum) on float32 copies of the inputs: the output within
# `bf16_output_limit`, the prompt mass within this, absolute. What is left
# is s - m rounding to the other bf16 neighbour where the kernel sums the
# scores in another order. The default kernel fails these limits against
# the same plain version (scripts/torch_ex2_bf16_probe.py at the card
# tests' shapes, phase_k1_tuning's log at this script's; PERF.md).
TOL_MASS_EXP_BF16 = 1e-4
TOL_K3_REL = 1e-4
BF16_ULPS = 2
BF16_FLOOR = 1e-5

# H100 SXM peaks (NVIDIA data sheet, dense) for the bounds.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12, torch.int8: 1979e12}

SEED = 0
PROMPT = 4096
NEW_TOKENS = 128
# Timed runs per path after its counted run. Each earlier path's count was
# cut by one (TinyLlama 3 -> 2, the others 2 -> 1, the uncompressed arms
# to one timed run, beam search's turns 3 -> 2) when Mixtral and Qwen2
# joined, to keep the script well inside its time limit; every check
# stays. TinyLlama's and Mixtral's counts were cut once more (2 -> 1) when the
# experiment CLIs joined, so every path now times one run after its
# counted one; the sampled decode's and beam search's turns went 2 -> 1
# when the pipeline and sharded serving joined. When the decode from the
# sequence-sharded state, sharded training and the sharded decoders
# joined, `phase_main`'s paths (TinyLlama, Gemma-2B, the 7B arms,
# Qwen2-0.5B, Mixtral) and the sampled decode stopped timing a run after
# their counted one: their counted run is timed (its first call of that
# model, so a TTFT that may carry first-call costs).
# Depth of later paths, cut to keep the script inside its limit as the
# experiment CLIs joined: every check stays at full width, and the launch
# counts follow the layer count. TinyLlama's chunked pooled,
# compressed-prefix and query-guided paths (of 22 layers), the Llama-2-7B
# int4 and W8A8 main runs (of 32; the K3 / K4 phases keep 32), Mixtral-8x7B
# (of 32) and Qwen2-0.5B loaded from disk (of 24).
# The tensor-parallel phase's ranks (its collectives staged through the
# host) cut these once more, by about half, when it joined: TinyLlama's
# paths 11 -> 6 layers (the eval harness, the benchmark suite and the
# ablation study follow them), the 7B runs 16 -> 8, Mixtral 8 -> 4,
# Qwen2-0.5B 12 -> 6. When the pipeline, sharded serving and the
# multi-process driver joined (about 65 s on a fast host, after the
# sampled decode's and beam search's timed turns went 2 -> 1),
# phase_tensor_parallel's Mixtral went 8 -> 4 layers. When the decode
# from the sequence-sharded state, sharded training and the sharded
# decoders joined (about 100 s on a slow host, whose whole run then took
# 1204 s; NVIDIA H100 80GB HBM3 at 700 W) the timed runs went first (above; the uncompressed arms decode
# BASELINE_STEPS steps, the chunked path and beam search time their
# counted runs), then TinyLlama's paths 6 -> 4 layers and the 7B runs
# 8 -> 4.
TINY_PATH_LAYERS = 4
BIG_RUN_LAYERS = 4
MIXTRAL_LAYERS = 4
QWEN2_LAYERS = 6
BASELINE_STEPS = 16  # the uncompressed arms' timed decode steps
# Llama-2-7B fused matmul shapes (K, N): wqkv, wo, w_gateup, w_down.
SHAPES_7B = ((4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096))
LM_HEAD_7B = (4096, 32000)
K3_CHECK_ROWS = 512  # K3's plain version at M=4096 is compared on a slice
# The ragged, chunked, long-generation path.
LENGTHS = (4096, 3000)
CHUNK = 1024
RING = 64
POOL_BLOCKS = 4
POOL_BITS = 4
GROUP_SIZE = 32       # 2 scale groups per head at d=64
DECODE_STEPS = 383    # flushes at steps 64, 128, ..., 320: 5 per layer
REPEATS_NEW = 1
SWAP_TOL = 1e-5       # chunked vs one-shot: a kept-token swap at a tier
                      # boundary passes only between near-equal scores
# The compressed-prefix path (the chunk = T/4 layout of
# experiments/chunked_prefix_quality.py): B uniform rows of PROMPT tokens
# in chunks of CHUNK, no decode pool.
PREFIX_BATCH = 2
# Query-guided importance: the observation window automatic (W = T/16,
# 256 at T = 4096), its mass max-pooled over 20 keys (2 * payload + 4 at
# payload 8, as experiments/quality_demo.py sets it).
QUERY_POOL = 20
QUERY_SOURCES = ("prompt", "query", "both")
# The sampled decode (top_k 1 at this temperature must give greedy tokens).
SAMPLING = dict(temperature=0.8, top_k=50, top_p=0.9, repetition_penalty=1.1)
BEAM_WIDTH = 4
BEAM_NEW_TOKENS = 64
BEAM_EOS = 2          # README's beam_search call
TOL_SCORE_REL = 1e-4  # float32 beam scores, kernel vs plain path
SPEC_STEPS = 128
N_DRAFT = 4
SPEC_CHUNK = 16       # adaptive_speculative_decode's default chunk
BEAM_K2_STEPS = 6     # beam steps (gathers) before the 4-row K2 check
# Mixtral-8x7B's routed-expert shapes (K, N): gate and up, then down.
SHAPES_EXPERT = ((4096, 14336), (14336, 4096))
MIXTRAL_PARITY_PROMPT = 512
MIXTRAL_PARITY_TOKENS = 6
# Written by the Qwen2-from-disk and checkpoint phases (git-ignored).
QWEN2_DIR = "build/qwen2_0_5b_checkpoint"
CKPT_DIR = "build/mixtral_layer0_checkpoint"
# The serving engine: SERVE_SLOTS decode slots over a PROMPT-token bucket,
# up to SERVE_NEW_TOKENS tokens per request in decode chunks of SERVE_CHUNK
# steps, SERVE_PROMPTS distinct prompts of PROMPT/4-PROMPT tokens (a first
# admission, then refills); chunked admission in chunks of
# SERVE_PREFILL_CHUNK; a registered SERVE_SHARED-token system prompt
# extended by up to SERVE_BUDGET tokens.
SERVE_SLOTS = 4
SERVE_NEW_TOKENS = 64
SERVE_CHUNK = 8
SERVE_PROMPTS = 8
SERVE_PREFILL_CHUNK = 1024
SERVE_SHARED = 3584
SERVE_BUDGET = 256
NEAR_TIE = 2 * TOL_LOGITS  # float32 serving parity: a reference top-2 gap
                           # below it may part kernel and plain paths
# The trainer: float32 card vs CPU parity (TOL_TRAIN_*: tests/
# test_torch_train.py's rule), and TinyLlama at full width: TRAIN_STEPS
# steps of B=1 x TRAIN_SEQ tokens at constant lr TRAIN_LR.
TOL_TRAIN_LOSS = 1e-5
TOL_TRAIN_PARAMS = 1e-6
TRAIN_SENSITIVE_SHARE = 1e-3
TRAIN_STEPS = 4
TRAIN_SEQ = 2048
TRAIN_LR = 2e-4
# The quality demo at the settings of the JAX package's r4 recall artifact;
# the arms whose kernel tokens are held to the plain versions' at the
# longest filler.
QUALITY_DEMO_ARGS = ["--tasks", "recall", "--steps", "2500", "--batch", "32",
                     "--fillers", "48,112,240", "--payload", "8",
                     "--lr", "3e-3", "--model-layers", "4",
                     "--model-width", "128", "--eval-samples", "64"]
QUALITY_KERNEL_ARMS = ("balanced_8_4_2", "query_guided", "quant_only_8_4_2",
                       "conservative")
QUALITY_R4_ARTIFACT = "experiments/results/quality_demo_r4/quality_demo.json"
# The LongBench harness: synthetic prompts of EVAL_CONTEXT_WORDS words
# (about 3700 bytes: ragged rows below the EVAL_MAX_LENGTH bucket).
EVAL_MAX_LENGTH = 4096
EVAL_NEW_TOKENS = 32
EVAL_CONTEXT_WORDS = 550
# The experiment CLIs (phase_ablation .. phase_chunked_prefix_quality):
# their own argv, cut for time where the phase's docstring says.
ABLATION_ARGS = ["--model", "tinyllama", "--tasks", "narrativeqa", "qasper",
                 "--max-samples", "1", "--max-length", "1024",
                 "--max-new-tokens", "16"]
ABLATION_STUDIES = ("component", "bits")
ABLATION_AUDIT_TOKENS = 4
# Each study's configs as (alpha, beta, gamma, theta_h, theta_m, early,
# middle, later ratio, high, medium, low bits, tier mode) over the
# defaults at 8/4/2 bits.
ABLATION_CONFIGS = {
    "component": {
        "full": (0.4, 0.3, 0.3, 0.7, 0.3, 0.8, 0.6, 0.4, 8, 4, 2, "quantile"),
        "no_attention": (0.0, 0.5, 0.5, 0.7, 0.3, 0.8, 0.6, 0.4, 8, 4, 2,
                         "quantile"),
        "no_position": (0.55, 0.0, 0.45, 0.7, 0.3, 0.8, 0.6, 0.4, 8, 4, 2,
                        "quantile"),
        "no_relevance": (0.55, 0.45, 0.0, 0.7, 0.3, 0.8, 0.6, 0.4, 8, 4, 2,
                         "quantile"),
        "uniform_precision": (0.4, 0.3, 0.3, 1.0, 0.0, 0.8, 0.6, 0.4, 8, 4,
                              2, "threshold"),
        "uniform_propagation": (0.4, 0.3, 0.3, 0.7, 0.3, 0.6, 0.6, 0.6, 8, 4,
                                2, "quantile"),
        "no_quantization": (0.4, 0.3, 0.3, 0.7, 0.3, 0.8, 0.6, 0.4, 16, 16,
                            16, "quantile"),
    },
    "weights": {
        f"a{a}_b{b}_g{g}": (a, b, g, 0.7, 0.3, 0.8, 0.6, 0.4, 8, 4, 2,
                            "quantile")
        for a, b, g in ((0.2, 0.2, 0.6), (0.2, 0.4, 0.4), (0.2, 0.6, 0.2),
                        (0.4, 0.2, 0.4), (0.4, 0.4, 0.2), (0.6, 0.2, 0.2))},
    "thresholds": {
        f"th{h}_tm{m}": (0.4, 0.3, 0.3, h, m, 0.8, 0.6, 0.4, 8, 4, 2,
                         "threshold")
        for h, m in ((0.5, 0.1), (0.5, 0.3), (0.7, 0.1), (0.7, 0.3),
                     (0.7, 0.5), (0.9, 0.1), (0.9, 0.3), (0.9, 0.5))},
    "ratios": {
        f"r{e}_{m}_{l}": (0.4, 0.3, 0.3, 0.7, 0.3, e, m, l, 8, 4, 2,
                          "quantile")
        for e, m, l in ((0.9, 0.7, 0.5), (0.8, 0.6, 0.4), (0.7, 0.5, 0.3),
                        (0.6, 0.4, 0.25))},
    "bits": {
        f"b{h}_{m}_{l}": (0.4, 0.3, 0.3, 0.7, 0.3, 0.8, 0.6, 0.4, h, m, l,
                          "quantile")
        for h, m, l in ((16, 8, 4), (8, 4, 2), (8, 8, 4), (4, 4, 2))},
}
# 7 trials: 4 random starts and 3 GP fits in the Bayesian method, one
# child in the genetic one (its population is 6).
TUNING_ARGS = ["--method", "compare", "--trials", "7", "--max-samples", "1"]
SPEC_BENCH_ARGS = ["--fillers", "512", "--payload", "16", "--steps", "300",
                   "--reps", "3", "--adaptive"]
PREFIX_QUALITY_ARGS = ["--contexts", "256,1024", "--steps", "300"]
SERVE_BENCH_ARGS = ["--model", "tinyllama"]  # the CLI's defaults
# Sequence-parallel prefill (phase_seq_parallel): SEQ_RANKS spawned ranks on
# this one card over a gloo group, TinyLlama at full width and depth on the
# main run's prompt, SEQ_NEW_TOKENS greedy tokens from each state; the
# deadline of the ranks and of each collective. The float32 parity run:
# SEQ_F32_LAYERS layers at tiny_test_model width, query-guided ("both",
# pool 4), ragged rows SEQ_F32_LENGTHS right-padded to SEQ_F32_PROMPT.
# bf16 ring and one-shot prefills round their attention outputs apart
# (merged partials against one pass), so their activations drift through
# the layers: their importance scores are held within BF16_SCORE_DRIFT
# instead of TOL_LOGITS: twice the worst drift measured at TinyLlama's
# depth (1.97e-4, layer 5 of 22, NVIDIA H100 80GB HBM3 at 700 W), below
# every layer's drift under a ring that scales its rotated blocks' prompt
# mass by 1 + 2^-6 (4.25e-4 to 8.45e-4), a fault that leaves the logits
# and each kernel call as they were (PERF.md, PR 14, has the readings).
SEQ_RANKS = 4
SEQ_NEW_TOKENS = 32
SEQ_TIMED_STEPS = 10  # the timed decodes, from the shards and gathered
SEQ_TIMEOUT = 600
SEQ_F32_LAYERS = 3
SEQ_F32_PROMPT = 256
SEQ_F32_LENGTHS = (256, 201)
SEQ_F32_NEW_TOKENS = 16
BF16_SCORE_DRIFT = 4e-4
# Tensor and data parallelism (phase_tensor_parallel): TP_RANKS spawned
# ranks on this one card over a gloo group, on each (data, model) mesh of
# TP_MESHES: TinyLlama at full width and depth (B=1 on 1 x 4, B=2 on
# 2 x 2), TP_NEW_TOKENS greedy tokens, and the float32 run at the SEQ_F32
# shapes; on 1 x 4 also a Mixtral-8x7B-width model cut to
# TP_MIXTRAL_LAYERS of its 32 layers, a TP_MIXTRAL_PROMPT-token prompt and
# TP_MIXTRAL_TOKENS tokens; the deadline of the ranks and of each
# collective.
TP_RANKS = 4
TP_MESHES = ((1, 4), (2, 2))
TP_NEW_TOKENS = 32
TP_MIXTRAL_LAYERS = 4  # 8 before the pipeline and sharded serving joined
TP_MIXTRAL_PROMPT = 1024
TP_MIXTRAL_TOKENS = 16
TP_TIMEOUT = 600
# bf16 importance scores of a tensor-parallel prefill against the
# one-rank prefill's (NVIDIA H100 80GB HBM3 at 700 W, PERF.md):
# TinyLlama drifts 8.0e-5 to 3.78e-4 a layer (the ranks' matmuls over
# their column blocks round apart from the whole ones), so TP_SCORE_DRIFT
# is twice the worst. In a MoE model a rounding difference flips the
# router's top-2 choice for tokens whose expert probabilities are near
# equal (7 to 55 of 1024 tokens a layer from layer 1 on at Mixtral's
# width), and such a token's hidden state moves by a whole expert's
# output: the layers after the first flip drift 2.64e-3 to 4.56e-3, so
# they are held to TP_MOE_SCORE_DRIFT, twice the worst (rounded up); the
# layers up to the first flip to TP_SCORE_DRIFT (Mixtral's layer 1:
# 8.2e-5).
TP_SCORE_DRIFT = 8e-4
TP_MOE_SCORE_DRIFT = 1e-2
# Pipeline parallelism (phase_pipeline): TinyLlama's 22 layers in
# PIPE_RANKS stages (11 a rank) spawned on this one card over gloo, on the
# main run's weights and prompt, PIPE_NEW_TOKENS greedy tokens; the
# deadline of the ranks and of each collective. The float32 pipeline at
# tiny_test_model width (4 layers) over SS_RANKS stages and the GPipe
# train step (PIPE_TRAIN_*: batch, length, microbatches, lr) run in
# phase_sharded_serving's spawn.
PIPE_RANKS = 2
PIPE_NEW_TOKENS = 32
PIPE_TIMEOUT = 600
PIPE_TRAIN_BATCH, PIPE_TRAIN_SEQ, PIPE_TRAIN_MICRO = 4, 128, 2
PIPE_TRAIN_LR = 1e-3
# Sharded serving (phase_sharded_serving): SS_RANKS spawned ranks on an
# SS_MESH (data x model) mesh. TinyLlama at full width and
# TINY_PATH_LAYERS layers (bf16, fused after sharding), SERVE_SLOTS slots
# over an SS_CONTEXT bucket, SERVE_PROMPTS prompts and budgets drawn as
# phase_serving_path draws its traffic, at SS_CONTEXT; one chunked
# admission of three prompts in chunks of SS_PREFILL_CHUNK; the float32
# run at the JAX package's sharded-serving test shape (SS_F32_DIMS,
# SS_F32_ENGINE: tests/test_serving.py:114); the deadline.
SS_RANKS = 4
SS_MESH = (2, 2)
SS_CONTEXT = 1024
SS_PREFILL_CHUNK = 256
SS_TIMEOUT = 600
SS_F32_DIMS = dict(num_layers=2, num_heads=8, num_kv_heads=4, head_dim=16,
                   hidden_size=128, intermediate_size=256)
SS_F32_ENGINE = dict(num_slots=2, context_len=64, max_new_tokens=9,
                     decode_chunk=4)
# The sharded engines' runs, (name, prefill_chunk): the main traffic and
# the three short prompts' chunked admission.
SS_RUNS = (("main", None), ("chunked", SS_PREFILL_CHUNK))
# Sharded training and the decoders over a sharded tree
# (phase_sharded_train_decoders): TSD_RANKS spawned ranks; TinyLlama width
# in float32 at TSD_LAYERS layers. Training on the TSD_TRAIN_MESH (data x
# model) mesh: TSD_TRAIN_STEPS steps of AdamW at TSD_TRAIN_LR (clip
# TSD_TRAIN_CLIP) on TSD_TRAIN_BATCH rows of TSD_TRAIN_SEQ tokens. The
# decoders on the TSD_DECODE_MESH: beam search (BEAM_WIDTH beams,
# TSD_BEAM_TOKENS tokens, B=1) and speculative decoding (TSD_SPEC_STEPS
# steps, N_DRAFT oracle drafts; the adaptive controller in chunks of
# TSD_SPEC_CHUNK with adversarial drafts) over a TSD_PROMPT-token prompt.
TSD_RANKS = 4
TSD_LAYERS = 2
TSD_TRAIN_MESH = (2, 2)
TSD_TRAIN_STEPS = 3
TSD_TRAIN_LR = 1e-3
TSD_TRAIN_CLIP = 1.0
TSD_TRAIN_BATCH, TSD_TRAIN_SEQ = 4, 512
TSD_DECODE_MESH = (1, 4)
TSD_PROMPT = 1024
TSD_BEAM_TOKENS = 16
TSD_SPEC_STEPS = 32
TSD_SPEC_CHUNK = 8
TSD_TIMEOUT = 600


def _arg(argv: list, flag: str) -> str:
    return argv[argv.index(flag) + 1]


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def wrapper(key: str):
    module, name = KERNELS[key][:2]
    return getattr(importlib.import_module(f"{PKG}.ops.cuda.{module}"), name)


def _counter(key: str) -> str:
    return KERNELS[key][4] if len(KERNELS[key]) > 4 else "launches"


def _launches() -> dict:
    """Each kernel wrapper's launch count."""
    return {key: getattr(wrapper(key), _counter(key)) for key in KERNELS}


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def bf16_share(out: torch.Tensor, ref: torch.Tensor,
               floor: float = BF16_FLOOR) -> float:
    """Largest share of its limit that any element's error uses; the limit
    is BF16_ULPS bf16 ulps of |ref| plus `floor`. Passes at <= 1."""
    ref = ref.float()
    mag = ref.abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)  # 8-bit significand
    err = (out.float() - ref).abs()
    return float((err / (BF16_ULPS * ulp + floor)).max())


def limit_share(out, ref, tol, floor: float = BF16_FLOOR,
                ref_abs=None) -> float:
    """The share of its limit that `out`'s worst element uses against
    `ref`, under `check_close`'s limits (bf16: the per-element ulp limit
    with `floor`, or with `ref_abs` given, K1's `bf16_output_limit`;
    float32: `tol` absolute). Passes at <= 1."""
    from realtime_kv_cache_compression_tpu_torch.ops.cuda.flash_prefill \
        import bf16_limit_share

    if out.dtype == torch.bfloat16 and ref_abs is not None:
        return bf16_limit_share(out, ref, ref_abs)
    if out.dtype == torch.bfloat16:
        return bf16_share(out, ref, floor)
    err = max_err(out, ref)
    return err / tol if tol > 0 else (0.0 if err == 0 else float("inf"))


def check_close(out, ref, tol, what: str, floor: float = BF16_FLOOR,
                ref_abs=None) -> float:
    """Checks `out` against `ref` under `limit_share`'s limits, logs the
    result and returns the max abs error."""
    err = max_err(out, ref)
    peak = float(ref.float().abs().max())
    share = limit_share(out, ref, tol, floor, ref_abs)
    if out.dtype == torch.bfloat16 and ref_abs is not None:
        log(f"{what}: max abs err {err:.3e}, max|ref| {peak:.3e}, worst "
            f"element at {share:.3f} of its limit ({BF16_ULPS} bf16 ulps "
            f"+ 2^-8 sum p|v|/l + {floor:.0e})")
    elif out.dtype == torch.bfloat16:
        log(f"{what}: max abs err {err:.3e}, max|ref| {peak:.3e}, worst "
            f"element at {share:.3f} of its limit ({BF16_ULPS} bf16 ulps "
            f"+ {floor:.3e})")
    else:
        log(f"{what}: max abs err {err:.3e} (tol {tol:.3e}), max|ref| "
            f"{peak:.3e}")
    check(share <= 1.0, what)
    return err


def k1_refs(plain, q, k, v, *args, **kw):
    """A K1 wrapper's plain version on float32 copies of q, k, v, and its
    output with v replaced by |v| (the sum_j p_j |v_j| / l of the bf16
    limit). Returns (result, ref_abs)."""
    f = [x.float() for x in (q, k, v)]
    return plain(*f, *args, **kw), plain(f[0], f[1], f[2].abs(), *args,
                                         **kw)[0]


def log_speed(what: str, cost: dict) -> None:
    """Logs a bf16 K1 timing: kernel, plain, bound, the kernel's share of
    its bound and its factor against SDPA (n/a where SDPA refused)."""
    lib = cost["library_ms"]
    factor = "n/a" if lib is None else f"{cost['ms'] / lib:.2f}"
    log(f"{what} bf16: kernel {cost['ms']:.4f} ms, plain "
        f"{cost['plain_ms']:.4f} ms, bound {cost['bound_ms']:.4f} ms "
        f"({cost['bound_by']}), {cost['bound_ms'] / cost['ms']:.3f} of its "
        f"bound; SDPA {lib} ms (no prompt mass), kernel/SDPA {factor}")


def kernel_and_plain_ms(kernel, plain, reps: int):
    """Mean ms per call of a kernel and of its plain version, after a
    warm-up of each, timed in turns (plain, kernel, kernel, plain)."""
    kernel(), plain()
    p1, k1, k2, p2 = (cuda_ms(f, reps)[1]
                      for f in (plain, kernel, kernel, plain))
    return (k1 + k2) / 2, (p1 + p2) / 2


def bound(n_bytes: float, ops: float, dtype) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the peak rate of their type."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def pool_bytes(pool) -> int:
    """Bytes one layer's decode pool holds."""
    return nbytes(pool.k_stored, pool.v_stored, pool.k_scale, pool.k_zp,
                  pool.v_scale, pool.v_zp, pool.positions, pool.valid,
                  pool.write_block)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def phase_environment() -> None:
    log(nvidia_smi_line())
    try:
        triton_version = importlib.metadata.version("triton")
    except importlib.metadata.PackageNotFoundError:
        triton_version = "not installed"
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"triton {triton_version}, device {torch.cuda.get_device_name(0)}, "
        f"count {torch.cuda.device_count()}")


# The tensor-core kernels phase_build holds to no spill and wgmma in SASS
# (HGMMA for bf16, IGMMA for int8): K1's bf16 instances (3 modes x 5 head
# dims by default, `flash_tc_kernel`; 16 non-default tiles and 35 mode (a)
# variants, `flash_tc_tuned_kernel`: as many as `kernel_instances()` lists
# in bf16), K3's bf16 prefill tile (one instance per k-steps per group
# partial: 1, 2, 4) and K4's int8 prefill tile (float32 and bf16 output).
TC_KERNELS = {"flash_tc_kernel": 15, "flash_tc_tuned_kernel": 51,
              "int4_tc_kernel": 3, "int8_tc_kernel": 2}


def phase_build() -> None:
    """Builds the kernels (one nvcc per source, in parallel), logs ptxas's
    registers, shared memory and spills, and every K1 instance's as the
    runtime reports them; checks that no tensor-core kernel (TC_KERNELS)
    spills and, where cuobjdump is present, that each instance holds wgmma
    instructions (HGMMA, IGMMA); logs each K2 instance's stack frame and
    spills (its parameter struct is __grid_constant__, so a runtime
    segment index reads it in place).
    """
    import shutil

    from realtime_kv_cache_compression_tpu_torch.ops.cuda import _build
    from realtime_kv_cache_compression_tpu_torch.ops.cuda.flash_prefill \
        import kernel_instances

    t0 = time.perf_counter()
    kl = _build.load_library()
    log(f"build: {kl.path.name} in {time.perf_counter() - t0:.1f} s "
        f"(nvcc, one process per source, {kl.build_seconds:.1f} s)")
    entry, spills, k2_frames = "", [], []
    for line in kl.ptxas_log.splitlines():
        if "Compiling" in line:
            entry = line
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"  ptxas: {line.strip()}")
        if "decode_attention_kernel" in entry and "stack frame" in line:
            k2_frames.append(line.strip())
        tc = [k for k in TC_KERNELS if k in entry]
        if (tc and "spill" in line
                and " 0 bytes spill stores, 0 bytes spill loads" not in line):
            spills.append(entry.split(tc[0])[1][:12] or tc[0])
    instances = kernel_instances()
    for row in instances:
        what = (f"{row['mode']} {row['dtype']} d={row['head_dim']} "
                f"{row['rows']}x{row['keys']}"
                + (f" {row['variant']}" if row["variant"] else ""))
        log(f"  K1 {what}: {row['regs']} registers, {row['local_bytes']} B "
            f"local memory, {row['static_smem'] + row['dynamic_smem']} B "
            f"shared memory, {row['threads']} threads")
        if row["dtype"] == "bfloat16" and row["local_bytes"]:
            spills.append(what)
    check(not spills, f"tensor-core instances spill: {spills}")
    check(sum(r["dtype"] == "bfloat16" for r in instances)
          == TC_KERNELS["flash_tc_kernel"]
          + TC_KERNELS["flash_tc_tuned_kernel"],
          "K1's bf16 instances listed")
    log(f"  K2 instances: {len(k2_frames)}; stack frames / spills: "
        f"{sorted(set(k2_frames))}")
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        sass = subprocess.run([cuobjdump, "-sass", str(kl.path)],
                              capture_output=True, text=True, check=True,
                              timeout=300).stdout
    except (OSError, subprocess.SubprocessError) as e:
        log(f"cuobjdump not run ({e}): wgmma not checked")
        return
    hgmma = {}
    name = None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            if any(k in name for k in TC_KERNELS):
                hgmma[name] = 0
        elif name in hgmma and "GMMA" in line:
            hgmma[name] += 1
    for name, n in sorted(hgmma.items()):
        log(f"  SASS {name}: {n} HGMMA/IGMMA instructions")
    found = {k: sum(k in name for name in hgmma) for k in TC_KERNELS}
    check(found == TC_KERNELS and all(hgmma.values()),
          f"every tensor-core instance {TC_KERNELS} holds wgmma: {found}")
    # K1's exp_bf16 instances (bit 2 of the last template argument) take
    # exp2 on bf16 lanes: MUFU.EX2.BF16 in their SASS.
    exp_bf16, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            args = re.search(r"flash_tc_tuned_kernelILi(\d+)ELi(\d+)ELi"
                             r"(\d+)ELi(\d+)ELi(\d+)E", name)
            if not (args and int(args.group(5)) & 2):
                name = None
            else:
                exp_bf16[name] = 0
        elif name and "MUFU.EX2.BF16" in line:
            exp_bf16[name] += 1
    log(f"  SASS: MUFU.EX2.BF16 in K1's exp_bf16 instances: "
        f"{sorted(exp_bf16.values())}")
    check(len(exp_bf16) == 20 and all(exp_bf16.values()),
          "every exp_bf16 instance exponentiates on bf16 lanes")


def _fused_qkv(gen, b, s, hq, hkv, d, dtype, device):
    """q, k, v as column slices of one fused projection [B, S, (Hq + 2 Hkv)
    D], strided as the main path's fused QKV hands them to K1."""
    qkv = torch.randn((b, s, (hq + 2 * hkv) * d), generator=gen,
                      device=device).to(dtype)
    q, k, v = qkv.split([hq * d, hkv * d, hkv * d], dim=-1)
    return (q.unflatten(-1, (hq, d)), k.unflatten(-1, (hkv, d)),
            v.unflatten(-1, (hkv, d)))


def phase_k1(device, shape, ragged=(2, 1000), reps: int = K1_REPS) -> dict:
    """K1 against its plain version on strided q/k/v: `shape` (B, S, Hq,
    Hkv, D) in bf16 (timed, with its bound and SDPA as the library
    yardstick) and float32, then a ragged S with per-row prompt lengths in
    both dtypes."""
    from realtime_kv_cache_compression_tpu_torch.ops.attention import (
        prefill_attention_with_prompt_mass)
    from realtime_kv_cache_compression_tpu_torch.ops.cuda.flash_prefill \
        import flash_prefill_with_prompt_mass

    gen = torch.Generator(device=device).manual_seed(SEED)
    b, s, hq, hkv, d = shape
    rb, rs = ragged
    plen = 128
    plens = torch.tensor([37, plen], dtype=torch.int32, device=device)[:rb]
    worst, timing = 0.0, None
    for (bb, ss, lens), dtype in (
            ((b, s, None), torch.bfloat16), ((b, s, None), torch.float32),
            ((rb, rs, plens), torch.bfloat16), ((rb, rs, plens),
                                                torch.float32)):
        q, k, v = _fused_qkv(gen, bb, ss, hq, hkv, d, dtype, device)
        check(not (q.is_contiguous() or v.is_contiguous()),
              "K1 inputs are strided slices")
        o, pm = flash_prefill_with_prompt_mass(q, k, v, plen,
                                               prompt_lens=lens)
        (o_ref, pm_ref), o_abs = k1_refs(prefill_attention_with_prompt_mass,
                                         q, k, v, plen, prompt_lens=lens)
        what = (f"K1 {tuple(q.shape)} {str(dtype)[6:]} plens "
                f"{plen if lens is None else lens.tolist()}")
        worst = max(worst, check_close(o, o_ref, TOL_K1_F32, what + " out",
                                       ref_abs=o_abs),
                    check_close(pm, pm_ref, TOL_MASS, what + " prompt mass"))
        del o_ref, pm_ref, o_abs
        if timing is None:  # the path's shape and dtype
            ms, plain_ms = kernel_and_plain_ms(
                lambda: flash_prefill_with_prompt_mass(q, k, v, plen),
                lambda: prefill_attention_with_prompt_mass(q, k, v, plen),
                reps)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            sdpa = torch.nn.functional.scaled_dot_product_attention
            lib = lambda: sdpa(qt, kt, vt, is_causal=True,  # noqa: E731
                               enable_gqa=hq != hkv)
            lib()
            _, lib_ms = cuda_ms(lib, reps)
            timing = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                      **bound(nbytes(q, k, v, o) + b * s * 4,
                              4 * b * hq * d * s * (s + 1) / 2, dtype)}
            log_speed(f"K1 mode a {tuple(q.shape)}", timing)
    return {"max_abs_err": worst, **timing}


# phase_k1_tuning: the TPU code each mode (a) variant of K1 replaces.
K1_VARIANTS = {
    "fold_gqa": f"{JAX_PKG}/ops/pallas/flash_prefill.py:261 "
                f"(`_flash_attention_bhsd(fold_gqa=True)`)",
    "exp_bf16": f"{JAX_PKG}/ops/pallas/flash_prefill.py:141 "
                f"(`_flash_kernel(exp_bf16=True)`)",
    "stats_via_mxu": f"{JAX_PKG}/ops/pallas/flash_prefill.py:101 "
                     f"(`_flash_kernel(stats_via_mxu=True)`)"}
TUNE_REPS = 3  # timed calls per reading of a variant and its plain version


def _tile_name(tile) -> str:
    return tile if isinstance(tile, str) else f"{tile[0]}x{tile[1]}"


def _k1_tiles(mcfg) -> dict:
    """K1 mode (a)'s launches by instance since the counts were zeroed,
    as {"rows x keys" or "float32": n}; checks that every tensor-core
    launch ran mcfg's default tile and that no variant ran (no caller in
    the port passes a tile or a variant)."""
    from realtime_kv_cache_compression_tpu_torch.ops.cuda import (
        flash_prefill as fp)

    fn = wrapper("K1")
    check(set(fn.tile_launches) <= {fp.default_tile(fp._CAUSAL,
                                                    mcfg.head_dim), "float32"}
          and not fn.variant_launches,
          f"K1 ran only its default tile and kernel: {fn.tile_launches}, "
          f"{fn.variant_launches}")
    return {_tile_name(t): n for t, n in fn.tile_launches.items()}


def phase_k1_tuning(device, tiny, big, qwen2) -> dict:
    """K1's tuning surface (the wrappers' block_q / block_k and mode (a)'s
    fold_gqa, exp_bf16, stats_via_mxu), on the card's own instances:
    - the `kernel_autotune` CLI (in-process) at TinyLlama's and
      Llama-2-7B's heads (B=1, S=PROMPT, bf16, its defaults otherwise), a
      path of its own: counts zeroed before, and every built tile of mode
      (a) launched 1 + 5 x 10 times (the CLI's check and readings), each
      held once to its plain version and timed by the CLI; mode (a)'s
      plain version and SDPA timed beside it at each heads;
    - every built tile of mode (b) and mode (d) at phase_k1_chunk's shape
      (B=2, the last CHUNK rows at q_offset PROMPT - CHUNK over PROMPT
      keys; mode (d) over the PROMPT - CHUNK earlier positions as
      unordered slots, a fifth invalid) and of the diagonal pair and mode
      (c) at phase_k1_full_pair's (B=2, S_q = S_k = CHUNK), at both heads,
      once each against its plain version (lse too);
    - each variant at both heads (mode (a), strided q/k/v as the path's
      fused QKV gives them, B=1, S=PROMPT) and fold_gqa at Qwen2-0.5B's
      n_rep 7: each call counted, held to its plain version (exp_bf16 to
      the plain version with the same rounding, its prompt mass within
      TOL_MASS_EXP_BF16, and the default kernel's share of that limit
      logged beside it) and timed in turns with it (TUNE_REPS calls a
      reading), SDPA causal as the yardstick.
    Returns {"cli": each heads' artifact, "tiles": each mode's worst
    errors, "variants": each variant's numbers, launches and worst share
    of its limit}."""
    from realtime_kv_cache_compression_tpu_torch.experiments import (
        kernel_autotune)
    from realtime_kv_cache_compression_tpu_torch.ops.attention import (
        chunk_attention_with_prompt_mass, prefill_attention_with_prompt_mass)
    from realtime_kv_cache_compression_tpu_torch.ops.cuda import (
        flash_prefill as fp)

    gen = torch.Generator(device=device).manual_seed(SEED + 18)
    heads = {"tinyllama": tiny, "llama2_7b": big}
    k1 = fp.flash_prefill_with_prompt_mass
    out = {"cli": {}, "tiles": {}, "variants": {}}
    for name, cfg in heads.items():
        hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        _zero_counts()
        art = kernel_autotune.main([
            "--seq", str(PROMPT), "--heads", str(hq), "--kv-heads", str(hkv),
            "--head-dim", str(d), "--output-dir",
            f"build/kernel_autotune/{name}", "--device", str(device)])
        built = fp.built_tiles(fp._CAUSAL, d)
        check(k1.tile_launches == {t: 51 for t in built}
              and k1.launches == 51 * len(built),
              f"kernel_autotune at {name}'s heads: every built tile "
              f"{built} launched 51 times: {k1.tile_launches}")
        q, k, v = (x.contiguous() for x in _fused_qkv(
            gen, 1, PROMPT, hq, hkv, d, torch.bfloat16, device))
        plain_ms = cuda_ms(lambda: prefill_attention_with_prompt_mass(
            q, k, v, 128), TUNE_REPS)[1]
        art["plain_ms"] = plain_ms
        art["library_ms"] = _sdpa_ms(q, k, v, TUNE_REPS, is_causal=True)
        out["cli"][name] = art
        log(f"kernel_autotune {name} (B=1 S={PROMPT} {hq}/{hkv} d={d}): "
            f"best {art['best']['block_q']}x{art['best']['block_k']} "
            f"{art['best']['ms']:.4f} ms; plain {plain_ms:.3f} ms, SDPA "
            f"{art['library_ms']} ms")

    # Every built tile of the other modes, once against the plain version.
    b, c, s_k = PREFIX_BATCH, CHUNK, PROMPT
    off = s_k - c
    for name, cfg in heads.items():
        hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        q = _fused_qkv(gen, b, c, hq, hkv, d, torch.bfloat16, device)[0]
        k, v = (torch.randn((b, s_k, hkv, d), generator=gen, device=device)
                .to(torch.bfloat16) for _ in range(2))
        plens = torch.tensor([100, 3000], dtype=torch.int32, device=device)
        slots = torch.randperm(off, generator=gen, device=device)
        kpos = torch.where(
            torch.rand((b, off), generator=gen, device=device) > 0.2,
            slots.to(torch.int32)[None].expand(b, -1),
            fp.POS_SENTINEL).to(torch.int32).contiguous()
        kp, vp = k[:, :off], v[:, :off]
        kc, vc, plen_c = k[:, :c], v[:, :c], plens.clamp(max=c)
        modes = {
            "b": (fp._CAUSAL, lambda **t: fp.flash_chunk_attention_with_prompt_mass(  # noqa: E501
                q, k, v, off, 3000, prompt_lens=plens, **t),
                lambda: k1_refs(chunk_attention_with_prompt_mass, q, k, v,
                                off, 3000, prompt_lens=plens)),
            "d": (fp._POSITIONED, lambda **t: fp.flash_positioned_attention(
                q, kp, vp, kpos, off, 3000, **t),
                lambda: k1_refs(fp.positioned_attention_plain, q, kp, vp,
                                kpos, off, 3000)),
            "pair": (fp._CAUSAL, lambda **t: fp.flash_diagonal_pair_attention(
                q, kc, vc, plen_c, **t),
                lambda: k1_refs(fp.pair_attention_plain, q, kc, vc, plen_c,
                                causal=True)),
            "c": (fp._FULL, lambda **t: fp.flash_full_pair_attention(
                q, kc, vc, plen_c, **t),
                lambda: k1_refs(fp.pair_attention_plain, q, kc, vc, plen_c,
                                causal=False)),
        }
        for mode_name, (mode, kernel, refs) in modes.items():
            ref = refs()
            worst = 0.0
            for tile in fp.built_tiles(mode, d):
                what = (f"K1 mode {mode_name} tile {_tile_name(tile)} at "
                        f"{name}'s heads")
                got = kernel(block_q=tile[0], block_k=tile[1])
                if mode_name == "b":
                    (o_ref, pm_ref), o_abs = ref
                    err = max(check_close(got[0], o_ref, TOL_K1_F32, what,
                                          ref_abs=o_abs),
                              check_close(got[1], pm_ref, TOL_MASS,
                                          what + " prompt mass"))
                else:
                    err = check_partial(got, ref, what)
                worst = max(worst, err)
            out["tiles"].setdefault(mode_name, {})[name] = {
                "tiles": [_tile_name(t) for t in fp.built_tiles(mode, d)],
                "max_abs_err": worst}
            del ref

    # The variants: counted, held to the plain version, timed.
    sdpa_ms = {}
    for name, cfg in (*heads.items(), ("qwen2_0_5b", qwen2)):
        hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        q, k, v = _fused_qkv(gen, 1, PROMPT, hq, hkv, d, torch.bfloat16,
                             device)
        plens = None
        for variant, replaces in K1_VARIANTS.items():
            if name == "qwen2_0_5b" and variant != "fold_gqa":
                continue
            flag = {variant: True}
            exp = variant == "exp_bf16"
            plain = functools.partial(
                prefill_attention_with_prompt_mass, exp_bf16=exp,
                exp_block_k=fp.exp_block_keys(
                    q.dtype, fp.default_tile(fp._CAUSAL, d)) if exp else None)
            tol_mass = TOL_MASS_EXP_BF16 if exp else TOL_MASS
            _zero_counts()
            o, pm = k1(q, k, v, 128, prompt_lens=plens, **flag)
            launches = k1.variant_launches.get(variant, 0)
            check(k1.variant_launches == {variant: 1} and k1.launches == 1,
                  f"K1 {variant} at {name}'s heads launched its instance: "
                  f"{k1.variant_launches}")
            (o_ref, pm_ref), o_abs = k1_refs(plain, q, k, v, 128)
            what = f"K1 {variant} (B=1 S={PROMPT} {hq}/{hkv} d={d})"
            err = max(check_close(o, o_ref, TOL_K1_F32, what, ref_abs=o_abs),
                      check_close(pm, pm_ref, tol_mass,
                                  what + " prompt mass"))
            share = max(limit_share(o, o_ref, TOL_K1_F32, ref_abs=o_abs),
                        limit_share(pm, pm_ref, tol_mass))
            row = {"launches": launches, "max_abs_err": err,
                   "worst_share_of_limit": share,
                   "prompt_mass_max_abs_err": max_err(pm, pm_ref)}
            if exp:
                # The check's power: the unrounded default kernel on the
                # same inputs, against the same plain version and limits.
                o_def, pm_def = k1(q, k, v, 128, prompt_lens=plens)
                o_share = limit_share(o_def, o_ref, TOL_K1_F32, ref_abs=o_abs)
                pm_share = limit_share(pm_def, pm_ref, tol_mass)
                row["default_kernel_share_of_limit"] = max(o_share, pm_share)
                log(f"{what}: the default kernel against the same plain "
                    f"version at {o_share:.3f} of the output's limit and "
                    f"{pm_share:.3f} of the prompt mass's")
                del o_def, pm_def
            del o_ref, pm_ref, o_abs
            if name != "qwen2_0_5b":
                ms, p_ms = kernel_and_plain_ms(
                    lambda: k1(q, k, v, 128, **flag),  # noqa: B023
                    lambda: plain(q, k, v, 128), TUNE_REPS)  # noqa: B023
                if name not in sdpa_ms:
                    sdpa_ms[name] = _sdpa_ms(q, k, v, TUNE_REPS,
                                             is_causal=True)
                row.update(ms=ms, plain_ms=p_ms, library_ms=sdpa_ms[name],
                           **bound(nbytes(q, k, v, o) + PROMPT * 4,
                                   4 * hq * d * PROMPT * (PROMPT + 1) / 2,
                                   torch.bfloat16))
                log_speed(what, row)
            row["shape"] = (f"B=1 S={PROMPT} Hq={hq} Hkv={hkv} d={d}, "
                            f"strided q/k/v, bf16")
            out["variants"].setdefault(variant, {"replaces": replaces})[
                name] = row
    _zero_counts()
    return out


def _sweep_entries(cli: dict) -> dict:
    """The kernels line's record of phase_k1_tuning's `kernel_autotune`
    runs, by heads."""
    note = ("kernel_autotune's sweep of every built tile of mode (a), bf16: "
            "ms the median of 5 readings of 10 calls, its spread, share of "
            "the operations bound, error against the plain version; "
            "plain_ms and library_ms (SDPA causal) at the same shape")
    fields = ("ms", "spread", "share_of_bound", "max_abs_err",
              "worst_share_of_bf16_limit", "prompt_mass_max_abs_err")
    return {"note": note, **{name: {
        "shape": "B={b} S={s} Hq={hq} Hkv={hkv} d={d}".format(
            **art["shape"]),
        "device": art["device"], "plain_ms": art["plain_ms"],
        "library_ms": art["library_ms"],
        "tiles": {f"{r['block_q']}x{r['block_k']}": {
            f: r[f] for f in fields if f in r}
            for r in art["results"] if "error" not in r}}
        for name, art in cli.items()}}


def _variant_entry(variant: str, rec: dict) -> dict:
    """The kernels line's entry of one mode (a) variant of K1 from
    phase_k1_tuning's record: the Llama-2-7B heads' numbers on top, the
    other heads beside them."""
    rows = {m: r for m, r in rec.items() if m != "replaces"}
    top = rows["llama2_7b"]
    return {"name": f"flash_prefill_with_prompt_mass({variant}=True)",
            "route": "cuda",
            "source": f"{PKG}/csrc/flash_prefill_variants.cu",
            "replaces": rec["replaces"],
            "launches": sum(r["launches"] for r in rows.values()),
            **{f: top[f] for f in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms")},
            "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
            "worst_share_of_limit": max(r["worst_share_of_limit"]
                                        for r in rows.values()),
            **({"default_kernel_share_of_limit": min(
                r["default_kernel_share_of_limit"] for r in rows.values())}
               if "default_kernel_share_of_limit" in top else {}),
            "launches_note": "the counted calls of phase_k1_tuning, one a "
                             "heads; no path of the port passes a variant "
                             "(phase_main checks K1's tiles)",
            "shape": top["shape"],
            **{m: r for m, r in rows.items() if m != "llama2_7b"}}


def phase_k1_activations(device, mcfg, prompt: int = 1024) -> float:
    """bf16 K1 on the model's own activations: `mcfg` (TinyLlama at 2
    layers, full width) with bf16 random weights from SEED, one prompt of
    `prompt` tokens through `prefill_compressed` with a recording wrapper
    around K1 mode (a). Every call's output is held against the plain
    version on float32 copies of its own q, k, v under the bf16 limit, its
    prompt mass within TOL_MASS. Then the same prefill on the plain path
    (`use_flash=False`, bf16): the kept positions per layer and tier of
    the two are logged (bf16 rounding may move a token across a tier
    boundary, so they are read, not checked). Returns the largest error."""
    from realtime_kv_cache_compression_tpu_torch import CompressionConfig
    from realtime_kv_cache_compression_tpu_torch.models import llama
    from realtime_kv_cache_compression_tpu_torch.ops.attention import (
        prefill_attention_with_prompt_mass)

    ccfg = CompressionConfig(num_layers=mcfg.num_layers)
    params = llama.fuse_params(llama.init_params(SEED, mcfg, device))
    gen = torch.Generator(device=device).manual_seed(SEED + 15)
    ids = torch.randint(0, mcfg.vocab_size, (1, prompt), generator=gen,
                        device=device)
    calls = []
    original = llama.flash_prefill_with_prompt_mass

    def recording(q, k, v, prompt_len, prompt_lens=None, group=None):
        result = original(q, k, v, prompt_len, prompt_lens=prompt_lens,
                          group=group)
        calls.append((q, k, v, prompt_len, prompt_lens, result))
        return result

    llama.flash_prefill_with_prompt_mass = recording
    try:
        _, st_kernel, _ = llama.prefill_compressed(
            params, ids, mcfg, ccfg, max_decode_len=16, use_flash=True)
    finally:
        llama.flash_prefill_with_prompt_mass = original
    check(len(calls) == mcfg.num_layers, "one K1 call per layer recorded")
    worst = 0.0
    for li, (q, k, v, plen, lens, (o, pm)) in enumerate(calls):
        check(q.dtype == torch.bfloat16, "the model's K1 calls are bf16")
        (o_ref, pm_ref), o_abs = k1_refs(prefill_attention_with_prompt_mass,
                                         q, k, v, plen, prompt_lens=lens)
        what = (f"K1 mode a on layer {li}'s own activations "
                f"{tuple(q.shape)} bf16")
        worst = max(worst, check_close(o, o_ref, TOL_K1_F32, what + " out",
                                       ref_abs=o_abs),
                    check_close(pm, pm_ref, TOL_MASS, what + " prompt mass"))
    del calls
    _, st_plain, _ = llama.prefill_compressed(
        params, ids, mcfg, ccfg, max_decode_len=16, use_flash=False)
    for li, (ck, cp) in enumerate(zip(st_kernel.caches, st_plain.caches)):
        moved = []
        for a, c in zip(ck.tiers, cp.tiers):
            ka = set(a.positions[0][a.valid[0]].tolist())
            kc = set(c.positions[0][c.valid[0]].tolist())
            moved.append(f"{len(ka - kc)} of {len(ka)}")
        log(f"bf16 prefill, K1 vs plain attention, layer {li}: kept "
            f"positions of the kernel path missing from the plain path's, "
            f"per tier (high, mid, low): {moved}")
    return worst


def phase_k2(device, mcfg, prompt: int = PROMPT, decode_steps: int = 5,
             reps: int = 20) -> dict:
    """K2 against dequantize + attention_over_tokens on real decode states:
    a full-width prefill at reduced depth, a few decode steps into the
    ring, then every layer's cache at 8/4/2 and at the anchor config's
    16/8/4 tiers, in bf16 (8/4/2 layer 0 timed, with its bound) and in
    float32. No single PyTorch call computes it (library_ms null)."""
    from realtime_kv_cache_compression_tpu_torch import (
        CompressionConfig, reference_anchor_config)
    from realtime_kv_cache_compression_tpu_torch.compression import (
        cache_storage_bytes)
    from realtime_kv_cache_compression_tpu_torch.models import llama
    from realtime_kv_cache_compression_tpu_torch.ops.cuda.decode_attention \
        import decode_attention_plain, fused_decode_attention

    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    ids = torch.randint(0, mcfg.vocab_size, (1, prompt), generator=gen,
                        device=device)
    worst, timing = 0.0, None
    for dtype in ("bfloat16", "float32"):
        mcfg_d = dataclasses.replace(mcfg, dtype=dtype)
        params = llama.fuse_params(llama.init_params(SEED, mcfg_d, device))
        for name, ccfg in (
                ("8/4/2", CompressionConfig(num_layers=mcfg.num_layers)),
                ("16/8/4", reference_anchor_config(
                    num_layers=mcfg.num_layers))):
            logits, state, _ = llama.prefill_compressed(
                params, ids, mcfg_d, ccfg, max_decode_len=NEW_TOKENS)
            _, state = llama.decode_loop(params, torch.argmax(logits, -1),
                                         state, decode_steps, mcfg_d, ccfg)
            q = torch.randn((1, 1, mcfg.num_heads, mcfg.head_dim),
                            generator=gen, device=device).to(
                                llama.model_dtype(mcfg_d))
            q_pos = state.position[:, None]
            for i, (cache, recent) in enumerate(zip(state.caches,
                                                    state.recents)):
                out = fused_decode_attention(q, cache, recent, q_pos, ccfg)
                ref = decode_attention_plain(q, cache, recent, q_pos, ccfg)
                what = (f"K2 {name} {dtype} layer {i}: ring "
                        f"{int(recent.length[0])}/{recent.capacity}, tier "
                        f"capacities {[t.capacity for t in cache.tiers]}")
                worst = max(worst, check_close(out, ref, TOL_K2_F32, what))
            if timing is None:  # the path's dtype and tiers
                cache, recent = state.caches[0], state.recents[0]
                ms, plain_ms = kernel_and_plain_ms(
                    lambda: fused_decode_attention(q, cache, recent, q_pos,
                                                   ccfg),
                    lambda: decode_attention_plain(q, cache, recent, q_pos,
                                                   ccfg), reps)
                n_ring = int(recent.length.sum())
                n_keys = sum(int(t.valid.sum()) for t in cache.tiers) + n_ring
                ring_bytes = 2 * n_ring * nbytes(recent.k[0, 0])
                timing = {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
                          **bound(cache_storage_bytes(cache) + ring_bytes
                                  + 2 * nbytes(q),
                                  4 * mcfg.num_heads * mcfg.head_dim * n_keys,
                                  torch.bfloat16),
                          "device_us": _device_us_per_call(
                              lambda: fused_decode_attention(
                                  q, cache, recent, q_pos, ccfg),
                              match="decode")}
                log(f"K2 {name} {dtype} layer 0 ({n_keys} keys): kernel "
                    f"{ms:.4f} ms per call, device {timing['device_us']:.3f}"
                    f" us per call, plain {plain_ms:.4f} ms, bound "
                    f"{timing['bound_ms']:.4f} ms ({timing['bound_by']})")
        del params
    return {"max_abs_err": worst, **timing}


def phase_k2_lse(device, mcfg, ccfg, cache, recent, s: int,
                 reps: int = 20) -> dict:
    """K2's lse mode (`return_lse=True`) timed on a slot shard: layer 0 of
    rank 0's shard of the sequence-parallel state (1/SEQ_RANKS of the
    slots of an s-token prompt) with its ring after the decode, as that
    rank calls it, bf16 q; against `decode_attention_plain(return_lse=
    True)` (o rounded to bf16 under the ulp limit, lse within TOL_LSE), its
    device time per call and its bound (the shard, the ring and q read;
    o in float32 and the lse written). No single PyTorch call computes it
    (library_ms null)."""
    from realtime_kv_cache_compression_tpu_torch.compression import (
        cache_storage_bytes)
    from realtime_kv_cache_compression_tpu_torch.models import llama
    from realtime_kv_cache_compression_tpu_torch.ops.cuda.decode_attention \
        import decode_attention_plain, fused_decode_attention

    cache = _map_tree(cache, lambda t: t.to(device))
    recent = llama._map_tensors(recent, lambda t: t.to(device))
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    q = torch.randn((1, 1, mcfg.num_heads, mcfg.head_dim), generator=gen,
                    device=device).to(torch.bfloat16)
    q_pos = torch.full((1, 1), s + int(recent.length[0]), dtype=torch.int32,
                       device=device)
    kernel = lambda: fused_decode_attention(  # noqa: E731
        q, cache, recent, q_pos, ccfg, return_lse=True)
    plain = lambda: decode_attention_plain(  # noqa: E731
        q, cache, recent, q_pos, ccfg, return_lse=True)
    (o, lse), (o_ref, lse_ref) = kernel(), plain()
    what = (f"K2 lse mode, layer 0 of a 1/{SEQ_RANKS} slot shard of an "
            f"{s}-token state, ring {int(recent.length[0])}")
    check_close(o.to(q.dtype), o_ref, TOL_K2_F32, f"{what}: o in bf16")
    lse_err = max_err(lse, lse_ref)
    check(lse_err <= TOL_LSE * max(1.0, float(lse_ref.abs().max())),
          f"{what}: lse max abs err {lse_err:.3e}")
    ms, plain_ms = kernel_and_plain_ms(kernel, plain, reps)
    n_ring = int(recent.length.sum())
    n_keys = sum(int(t.valid.sum()) for t in cache.tiers) + n_ring
    out = {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
           "max_abs_err": max_err(o, o_ref),
           **bound(cache_storage_bytes(cache)
                   + 2 * n_ring * nbytes(recent.k[0, 0]) + nbytes(q)
                   + nbytes(o, lse),
                   4 * mcfg.num_heads * mcfg.head_dim * n_keys,
                   torch.bfloat16),
           "device_us": _device_us_per_call(kernel, match="decode")}
    log(f"{what} ({n_keys} keys): kernel {ms:.4f} ms per call, device "
        f"{out['device_us']:.3f} us per call, plain {plain_ms:.4f} ms, bound "
        f"{out['bound_ms']:.4f} ms ({out['bound_by']}); o (float32) max abs "
        f"err {out['max_abs_err']:.3e}, lse max abs err {lse_err:.3e}")
    return out


def _pooled_ccfg(num_layers: int, group_size: int = GROUP_SIZE,
                 pool_bits: int = POOL_BITS,
                 blocks: int = POOL_BLOCKS):
    from realtime_kv_cache_compression_tpu_torch import CompressionConfig
    return CompressionConfig(num_layers=num_layers,
                             quant_group_size=group_size,
                             decode_pool_blocks=blocks,
                             decode_pool_bits=pool_bits)


def phase_k1_chunk(device, shape, offsets=(0, 1024, 2048, 3072),
                   chunk: int = CHUNK, reps: int = K1_REPS) -> dict:
    """K1 mode (b) against `chunk_attention_with_prompt_mass`: batch 2 with
    the chunked path's per-row prompt lengths, `chunk` query rows (strided
    slices of one fused QKV, as the path hands them over) over a
    contiguous PROMPT-row K/V buffer at each chunk offset, bf16 and
    float32. Timed in bf16 at every offset with its bound (operations:
    4 B Hq d c (q_offset + (c + 1) / 2)) and SDPA with a boolean [c, S_k]
    causal mask as the library yardstick (no prompt mass); the returned
    numbers sum the offsets, one layer's chunked prefill."""
    from realtime_kv_cache_compression_tpu_torch.models import llama
    from realtime_kv_cache_compression_tpu_torch.ops.attention import (
        chunk_attention_with_prompt_mass)
    from realtime_kv_cache_compression_tpu_torch.ops.cuda.flash_prefill \
        import flash_chunk_attention_with_prompt_mass

    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    hq, hkv, d = shape
    b, s_k = len(LENGTHS), PROMPT
    ccfg = _pooled_ccfg(1)
    plen = ccfg.prompt_length(s_k)
    plens = llama._prompt_lens(torch.tensor(LENGTHS, device=device), ccfg,
                               plen)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    worst, rows = 0.0, []
    for dtype in (torch.bfloat16, torch.float32):
        k_buf, v_buf = (torch.randn((b, s_k, hkv, d), generator=gen,
                                    device=device).to(dtype)
                        for _ in range(2))
        for off in offsets:
            q = _fused_qkv(gen, b, chunk, hq, hkv, d, dtype, device)[0]
            kernel = lambda: flash_chunk_attention_with_prompt_mass(  # noqa
                q, k_buf, v_buf, off, plen, prompt_lens=plens)
            plain = lambda: chunk_attention_with_prompt_mass(  # noqa: E731
                q, k_buf, v_buf, off, plen, prompt_lens=plens)
            # The plain version rounds probabilities to the value dtype
            # before the value product, as the reference does, so the
            # kernel is held against it on exact float32 copies of the
            # same inputs.
            o, pm = kernel()
            (o_ref, pm_ref), o_abs = k1_refs(
                chunk_attention_with_prompt_mass, q, k_buf, v_buf, off, plen,
                prompt_lens=plens)
            what = (f"K1 mode b {tuple(q.shape)} over {s_k} keys at "
                    f"q_offset {off} {str(dtype)[6:]} plens {plens.tolist()}")
            worst = max(worst, check_close(o, o_ref, TOL_K1_F32, what,
                                           ref_abs=o_abs),
                        check_close(pm, pm_ref, TOL_MASS,
                                    what + " prompt mass"))
            del o_ref, pm_ref, o_abs
            if dtype != torch.bfloat16:
                continue
            ms, plain_ms = kernel_and_plain_ms(kernel, plain, reps)
            mask = (torch.arange(s_k, device=device)[None, :]
                    <= off + torch.arange(chunk, device=device)[:, None])
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k_buf, v_buf))
            lib = lambda: sdpa(qt, kt, vt, attn_mask=mask,  # noqa: E731
                               enable_gqa=hq != hkv)
            try:
                lib()
                lib_ms = cuda_ms(lib, reps)[1]
            except RuntimeError as e:  # the yardstick only; never the port
                lib_ms = None
                log(f"SDPA refused ({str(e)[:80]})")
            keys = off + chunk  # keys this chunk's rows can see
            cost = {"q_offset": off, "ms": ms, "plain_ms": plain_ms,
                    "library_ms": lib_ms,
                    **bound(nbytes(q, o) + 2 * b * keys * hkv * d
                            * k_buf.element_size() + b * chunk * 4,
                            4 * b * hq * d * chunk * (off + (chunk + 1) / 2),
                            dtype)}
            rows.append(cost)
            log_speed(f"K1 mode b {tuple(q.shape)} q_offset {off}", cost)
    return {"max_abs_err": worst, **_per_forward(rows, 1),
            "per_offset": rows}


def check_partial(part, refs, what: str) -> float:
    """A kernel's (o, lse, pm) partial against its plain version on float32
    copies, `refs` = (partial, ref_abs) from `k1_refs`: o and pm as
    `check_close` holds K1; lse within TOL_LSE on rows that see a key and
    -inf on both sides elsewhere. Returns the largest error."""
    (o, lse, pm), ((o_ref, lse_ref, pm_ref), o_abs) = part, refs
    err = max(check_close(o, o_ref, TOL_K1_F32, what + " out",
                          ref_abs=o_abs),
              check_close(pm, pm_ref, TOL_MASS, what + " prompt mass"))
    sees = torch.isfinite(lse_ref)
    check(torch.equal(sees, torch.isfinite(lse))
          and bool((lse[~sees] == -torch.inf).all()),
          what + ": lse is -inf exactly on the rows that see no key")
    lse_err = max_err(lse[sees], lse_ref[sees]) if bool(sees.any()) else 0.0
    log(f"{what} lse: max abs err {lse_err:.3e} (tol {TOL_LSE:.0e}) on "
        f"{int(sees.sum())} rows that see a key, -inf on "
        f"{int((~sees).sum())}")
    check(lse_err <= TOL_LSE, what + " lse")
    return max(err, lse_err)


def _sdpa_ms(q, k, v, reps: int, **kw):
    """SDPA on the same inputs as the yardstick (never the port), or None
    where the installed PyTorch refuses it."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib = lambda: sdpa(qt, kt, vt, enable_gqa=qt.shape[1] != kt.shape[1],  # noqa
                       **kw)
    try:
        lib()
        return cuda_ms(lib, reps)[1]
    except RuntimeError as e:
        log(f"SDPA refused ({str(e)[:80]})")
        return None


def _prefix_pools(device, mcfg, gen):
    """Layer 0's dequantized pools and key positions (invalid slots at
    POS_SENTINEL) before each chunk of a real compressed-prefix prefill at
    mcfg's full width (its first layer, bf16 random weights from SEED,
    compressed as the path compresses layer 0: ratio 0.8, its largest
    pools): B = 2 rows of PROMPT tokens in chunks of CHUNK, tiers 8/4/2.
    Returns [(q_offset, k_pool, v_pool, kpos)]."""
    from realtime_kv_cache_compression_tpu_torch import CompressionConfig
    from realtime_kv_cache_compression_tpu_torch.compression import (
        dequantize_layer_cache)
    from realtime_kv_cache_compression_tpu_torch.models import llama
    from realtime_kv_cache_compression_tpu_torch.ops.cuda.flash_prefill \
        import POS_SENTINEL

    cfg1 = dataclasses.replace(mcfg, num_layers=1,
                               max_position_embeddings=PROMPT + 512)
    ccfg = CompressionConfig(num_layers=mcfg.num_layers)
    params = llama.fuse_params(llama.init_params(SEED, cfg1, device))
    ids = torch.randint(0, mcfg.vocab_size, (PREFIX_BATCH, PROMPT),
                        generator=gen, device=device)
    st = llama.prefill_chunked_compressed_init(PREFIX_BATCH, PROMPT, CHUNK,
                                               cfg1, ccfg, device=device)
    pools = []
    for off in range(0, PROMPT, CHUNK):
        k_p, v_p, pos_p, valid_p = dequantize_layer_cache(
            st.caches[0], ccfg, torch.bfloat16)
        pools.append((off, k_p, v_p, torch.where(valid_p, pos_p,
                                                 POS_SENTINEL)))
        st = llama.prefill_chunked_compressed_step(
            params, ids[:, off:off + CHUNK], st, cfg1, ccfg, total_len=PROMPT)
    del params, st
    return pools


def phase_k1_prefix(device, mcfg, reps: int = K1_REPS) -> dict:
    """K1 mode (d) and the diagonal pair against their plain versions at the
    compressed-prefix path's shapes: B=2, CHUNK query rows (strided slices
    of one fused QKV) at each chunk offset, mode (d) over the pools a real
    prefill at mcfg's width leaves before that chunk (`_prefix_pools`, so N
    is the real slot count), the pair over the chunk's own K/V with its
    local prompt length. bf16 and float32 (exact float32 copies); timed in
    bf16 with bounds (operations 4 B Hq d c N_visible for mode (d), 4 B Hq
    d c (c + 1) / 2 for the pair) and SDPA as the yardstick (a boolean
    [c, N] mask from the positions; causal), without prompt mass. Returns
    both kernels' numbers summed over the offsets, one layer's prefill."""
    from realtime_kv_cache_compression_tpu_torch.ops.cuda.flash_prefill \
        import (flash_diagonal_pair_attention, flash_positioned_attention,
                pair_attention_plain, positioned_attention_plain)

    gen = torch.Generator(device=device).manual_seed(SEED + 12)
    hq, hkv, d = mcfg.num_heads, mcfg.num_kv_heads, mcfg.head_dim
    b, c = PREFIX_BATCH, CHUNK
    plen = _pooled_ccfg(1).prompt_length(PROMPT)
    worst = {"positioned": 0.0, "pair": 0.0}
    rows = {"positioned": [], "pair": []}
    for off, k_p, v_p, kpos in _prefix_pools(device, mcfg, gen):
        n_vis = int((kpos <= off).sum())  # pool keys every row sees
        q, k_c, v_c = _fused_qkv(gen, b, c, hq, hkv, d, torch.bfloat16,
                                 device)
        plen_local = min(max(plen - off, 0), c)
        for dtype in (torch.bfloat16, torch.float32):
            qd, kpd, vpd, kcd, vcd = (t.to(dtype)
                                      for t in (q, k_p, v_p, k_c, v_c))
            kernels = {
                "positioned": (
                    lambda: flash_positioned_attention(  # noqa: E731
                        qd, kpd, vpd, kpos, off, plen),
                    lambda: positioned_attention_plain(  # noqa: E731
                        qd, kpd, vpd, kpos, off, plen),
                    lambda: k1_refs(  # noqa: E731
                        positioned_attention_plain, qd, kpd, vpd, kpos,
                        off, plen)),
                "pair": (
                    lambda: flash_diagonal_pair_attention(  # noqa: E731
                        qd, kcd, vcd, plen_local),
                    lambda: pair_attention_plain(  # noqa: E731
                        qd, kcd, vcd, plen_local, causal=True),
                    lambda: k1_refs(  # noqa: E731
                        pair_attention_plain, qd, kcd, vcd, plen_local,
                        causal=True)),
            }
            for name, (kernel, plain, refs) in kernels.items():
                what = (f"K1 {'mode d' if name == 'positioned' else 'pair'} "
                        f"{tuple(q.shape)} at q_offset {off} over "
                        f"{kpd.shape[1] if name == 'positioned' else c} keys "
                        f"({n_vis if name == 'positioned' else 'causal'} "
                        f"visible) {str(dtype)[6:]}")
                part = kernel()
                worst[name] = max(worst[name],
                                  check_partial(part, refs(), what))
                if dtype != torch.bfloat16:
                    continue
                ms, plain_ms = kernel_and_plain_ms(kernel, plain, reps)
                o, lse, pm = part
                if name == "positioned":
                    mask = (kpos[:, None, None, :] <= off + torch.arange(
                        c, device=device)[None, None, :, None])
                    lib_ms = _sdpa_ms(qd, kpd, vpd, reps, attn_mask=mask)
                    cost = bound(nbytes(qd, o, kpos, lse, pm)
                                 + 2 * n_vis * hkv * d * 2,
                                 4 * hq * d * c * n_vis, dtype)
                else:
                    lib_ms = _sdpa_ms(qd, kcd, vcd, reps, is_causal=True)
                    cost = bound(nbytes(qd, kcd, vcd, o, lse, pm),
                                 4 * b * hq * d * c * (c + 1) / 2, dtype)
                cost.update(q_offset=off, n_slots=kpd.shape[1],
                            n_visible=n_vis, ms=ms, plain_ms=plain_ms,
                            library_ms=lib_ms)
                rows[name].append(cost)
                log_speed(what.rsplit(" ", 1)[0], cost)
    return {name: {"max_abs_err": worst[name], **_per_forward(r, 1),
                   "per_offset": r} for name, r in rows.items()}


def phase_k1_full_pair(device, shape, s: int = CHUNK,
                       reps: int = K1_REPS) -> dict:
    """K1 mode (c), the non-causal pair (ring attention's off-diagonal
    block, not on a path the port runs yet): B=2, S_q = S_k = s, strided q
    and contiguous K/V, per-row local prompt lengths, bf16 and float32;
    timed in bf16 with its bound (operations 4 B Hq d S_q S_k) and SDPA
    without a mask as the yardstick."""
    from realtime_kv_cache_compression_tpu_torch.ops.cuda.flash_prefill \
        import flash_full_pair_attention, pair_attention_plain

    gen = torch.Generator(device=device).manual_seed(SEED + 13)
    hq, hkv, d = shape
    b = PREFIX_BATCH
    plen = torch.tensor([s // 4, 0], dtype=torch.int32, device=device)
    worst, timing = 0.0, None
    for dtype in (torch.bfloat16, torch.float32):
        q = _fused_qkv(gen, b, s, hq, hkv, d, dtype, device)[0]
        k, v = (torch.randn((b, s, hkv, d), generator=gen, device=device)
                .to(dtype) for _ in range(2))
        kernel = lambda: flash_full_pair_attention(q, k, v, plen)  # noqa
        plain = lambda: pair_attention_plain(q, k, v, plen,  # noqa: E731
                                             causal=False)
        part = kernel()
        worst = max(worst, check_partial(
            part, k1_refs(pair_attention_plain, q, k, v, plen, causal=False),
            f"K1 mode c {tuple(q.shape)} over {s} keys {str(dtype)[6:]}"))
        if dtype != torch.bfloat16:
            continue
        ms, plain_ms = kernel_and_plain_ms(kernel, plain, reps)
        o, lse, pm = part
        timing = {"ms": ms, "plain_ms": plain_ms,
                  "library_ms": _sdpa_ms(q, k, v, reps),
                  **bound(nbytes(q, k, v, o, lse, pm),
                          4 * b * hq * d * s * s, dtype)}
        log_speed(f"K1 mode c {tuple(q.shape)}", timing)
    return {"max_abs_err": worst, **timing}


def phase_k2_pool(device, mcfg, groups, prompt: int = PROMPT,
                  steps: int = 330, reps: int = 20) -> dict:
    """K2 with the decode pool and scale groups against
    `decode_attention_plain(pool=)` on real states at the chunked path's
    batch: a full-width ragged prefill of len(LENGTHS) rows with LENGTHS
    right-padded to `prompt` at reduced depth, then `steps` decode steps
    over a RING-token ring and POOL_BLOCKS pool blocks (past a pool wrap),
    so every row has its own positions and valid slots. 4- and 16-bit pools
    and each group count in `groups`, in bf16 and float32, every layer.
    The path's variant (4-bit pool, groups[-1] groups, bf16) is timed on
    layer 0 with its bound. No single PyTorch call computes it."""
    from realtime_kv_cache_compression_tpu_torch.compression import (
        cache_storage_bytes)
    from realtime_kv_cache_compression_tpu_torch.models import llama
    from realtime_kv_cache_compression_tpu_torch.ops.cuda.decode_attention \
        import decode_attention_plain, fused_decode_attention

    gen = torch.Generator(device=device).manual_seed(SEED + 8)
    b = len(LENGTHS)
    ids = torch.randint(0, mcfg.vocab_size, (b, prompt), generator=gen,
                        device=device)
    lengths = torch.tensor(LENGTHS, device=device)
    flushes = (steps - 1) // RING
    worst, timing = 0.0, None
    for dtype in ("bfloat16", "float32"):
        mcfg_d = dataclasses.replace(mcfg, dtype=dtype)
        params = llama.fuse_params(llama.init_params(SEED, mcfg_d, device))
        for bits in (POOL_BITS, 16):
            for g in reversed(groups):
                ccfg = _pooled_ccfg(mcfg.num_layers,
                                    0 if g == 1 else mcfg.head_dim // g,
                                    bits)
                logits, state, _ = llama.prefill_compressed(
                    params, ids, mcfg_d, ccfg, max_decode_len=RING,
                    lengths=lengths)
                _, state = llama.decode_loop(
                    params, torch.argmax(logits, -1), state, steps, mcfg_d,
                    ccfg)
                q = torch.randn((b, 1, mcfg.num_heads, mcfg.head_dim),
                                generator=gen, device=device).to(
                                    llama.model_dtype(mcfg_d))
                q_pos = state.position[:, None]
                check(state.position.tolist() == [n + steps
                                                  for n in LENGTHS],
                      "per-row decode positions")
                for i, (cache, recent, pool) in enumerate(zip(
                        state.caches, state.recents, state.pools)):
                    check(bool(pool.valid.all()) and pool.write_block.tolist()
                          == [flushes % POOL_BLOCKS] * b, "the pool wrapped")
                    out = fused_decode_attention(q, cache, recent, q_pos,
                                                 ccfg, pool=pool)
                    ref = decode_attention_plain(q, cache, recent, q_pos,
                                                 ccfg, pool=pool)
                    what = (f"K2 pool {bits}-bit G={g} {dtype} layer {i}, "
                            f"B={b} lengths {LENGTHS}: ring "
                            f"{recent.length.tolist()}/{RING}, pool "
                            f"{pool.capacity} tokens, {flushes} flushes")
                    worst = max(worst, check_close(out, ref, TOL_K2_F32,
                                                   what))
                if timing is not None:
                    continue
                cache, recent, pool = (state.caches[0], state.recents[0],
                                       state.pools[0])
                ms, plain_ms = kernel_and_plain_ms(
                    lambda: fused_decode_attention(q, cache, recent, q_pos,
                                                   ccfg, pool=pool),
                    lambda: decode_attention_plain(q, cache, recent, q_pos,
                                                   ccfg, pool=pool), reps)
                n_ring = int(recent.length.sum())
                n_keys = (sum(int(t.valid.sum()) for t in cache.tiers)
                          + int(pool.valid.sum()) + n_ring)
                timing = {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
                          "variant": f"B={b} lengths {LENGTHS}, {bits}-bit "
                                     f"pool, G={g}, {dtype}",
                          **bound(cache_storage_bytes(cache)
                                  + pool_bytes(pool)
                                  + 2 * n_ring * nbytes(recent.k[0, 0])
                                  + 2 * nbytes(q),
                                  4 * mcfg.num_heads * mcfg.head_dim * n_keys,
                                  torch.bfloat16),
                          "device_us": _device_us_per_call(
                              lambda: fused_decode_attention(
                                  q, cache, recent, q_pos, ccfg, pool=pool),
                              match="decode")}
                log(f"K2 pool {bits}-bit G={g} {dtype} layer 0 ({n_keys} "
                    f"keys): kernel {ms:.4f} ms per call, device "
                    f"{timing['device_us']:.3f} us per call, plain "
                    f"{plain_ms:.4f} ms, bound {timing['bound_ms']:.4f} ms "
                    f"({timing['bound_by']})")
        del params
    return {"max_abs_err": worst, **timing}


def _int4_weight(gen, k, n, device):
    from realtime_kv_cache_compression_tpu_torch.models.quantized_params \
        import quantize_tensor_int4
    w = torch.randn((k, n), generator=gen, device=device) * k ** -0.5
    return quantize_tensor_int4(w, group_size=128)


def _int8_weight(gen, k, n, device):
    from realtime_kv_cache_compression_tpu_torch.models.quantized_params \
        import quantize_tensor
    w = torch.randn((k, n), generator=gen, device=device) * k ** -0.5
    return quantize_tensor(w, axis=1, act_quant=True)


def _per_forward(rows, layers: int, lm_head=None) -> dict:
    """One forward's worth of a kernel's calls: `layers` times each
    per-layer shape's numbers, plus lm_head's once (None stays None); bound_by
    names the limit of the calls that hold most of the summed bound."""
    parts = [(layers, r) for r in rows] + ([(1, lm_head)] if lm_head else [])
    tot = {}
    for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
        vals = [(n, r[key]) for n, r in parts]
        tot[key] = (None if any(v is None for _, v in vals)
                    else sum(n * v for n, v in vals))
    by_bytes = sum(n * r["bound_ms"] for n, r in parts
                   if r["bound_by"] == "bytes")
    tot["bound_by"] = ("bytes" if by_bytes >= tot["bound_ms"] / 2
                       else "operations")
    return tot


def _int4pack_library(w):
    """K3's function as one PyTorch call, for the yardstick only (the port
    never calls it): `torch._weight_int4pack_mm` dequantises a code u as
    (u - 8) * scale + zero (the layout of `_group_quantize_tensor` in
    torch/testing/_internal/common_quantization.py, zeros = min + 8 *
    scale), so zero = 0 gives K3's q * scale; its scales are bf16, K3's
    float32. The weight is repacked once, here: codes in K order [N, K],
    two per byte, even k in the high nibble. Returns a function of bf16 x;
    raises where the installed PyTorch refuses the shape."""
    p = w.q_packed.to(torch.int32)
    u = torch.cat([p & 0xF, p >> 4]).t().contiguous()  # [N, K], u = q + 8
    w_pk = torch._convert_weight_to_int4pack(
        ((u[:, ::2] << 4) | u[:, 1::2]).to(torch.uint8), 8)
    sz = torch.stack([w.scale, torch.zeros_like(w.scale)], -1).bfloat16()
    return lambda x: torch._weight_int4pack_mm(x, w_pk, w.group_size, sz)


def _profiled_kernels(fn, calls: int, enough, what: str) -> list:
    """(name, device us) of every kernel torch.profiler records over
    `calls` calls of `fn` after a warm-up, from the first session whose
    events satisfy `enough`. The calls sit inside an idle margin of `pad`
    seconds at each end of the session: the profiler keeps only device
    events it places inside its window, and a session of a millisecond or
    two came back empty now and then after many sessions in one process
    (as if the card's clock had drifted off the host's), or with some of
    its kernels. A session that does not satisfy `enough` is run again
    with a ten times wider margin, up to three in all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt, pad in enumerate((0.1, 1.0, 10.0)):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            time.sleep(pad)
        events = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
        if enough(events):
            break
        log(f"profiler session {attempt + 1} (margin {pad} s) recorded "
            f"{len(events)} device events, not {what}: "
            f"{[n[:40] for n, _ in events[:3]]}")
    return events


def _device_us_per_call(fn, calls: int = 20, match: str = "") -> float:
    """Mean device microseconds per call of `fn` by torch.profiler: the
    kernels whose names hold `match` (every kernel with "") over `calls`
    calls after a warm-up. The CUDA-event time of back-to-back M=1 calls
    reads the host's enqueue as much as the card; this reads the card."""
    events = _profiled_kernels(
        fn, calls, lambda ev: any(match in n and t > 0 for n, t in ev),
        f"'{match}' kernels")
    us = sum(t for n, t in events if match in n)
    check(us > 0, f"the profiler saw device time of '{match}' kernels")
    return us / calls


def _kernels_per_call(fn, calls: int = 5) -> int:
    """Device kernels one call of `fn` launches (profiler, over `calls`
    calls after a warm-up)."""
    events = _profiled_kernels(
        fn, calls, lambda ev: len(ev) >= calls and len(ev) % calls == 0,
        f"a multiple of {calls} kernels")
    check(len(events) % calls == 0,
          f"{len(events)} device kernels over {calls} calls")
    return len(events) // calls


def phase_k3(device, layers: int, shapes=SHAPES_7B, prefill_m: int = PROMPT,
             reps: int = 20) -> dict:
    """K3 against its plain version at every per-layer matmul shape (K, N)
    of `shapes` (default Llama-2-7B's fused ones; a shape listed twice is
    measured once and counted twice per layer), M=1 and M=prefill_m
    (compared on the first K3_CHECK_ROWS rows), bf16 and float32, each
    call on the route its shape and type take (M=1 the GEMV, bf16
    M=prefill_m the tensor cores, float32 the scalar tile); timed in bf16
    at both M with its bound, and torch._weight_int4pack_mm on the same
    codes (bf16 scales) as the library yardstick where it takes the shape;
    at M=1 also the device time per launch of both."""
    from realtime_kv_cache_compression_tpu_torch.ops.cuda.int4_matmul import (
        int4_matmul, int4_matmul_plain, int4_matmul_tensor)

    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    worst, costs = 0.0, {}
    for k, n in dict.fromkeys(shapes):
        w = _int4_weight(gen, k, n, device)
        plain = lambda x: int4_matmul_plain(  # noqa: E731
            x, w.q_packed, w.scale)
        try:
            lib, lib_refused = _int4pack_library(w), None
        except RuntimeError as e:  # the yardstick only; never the port
            lib, lib_refused = None, f"refused ({str(e)[:80]})"
        for dtype in (torch.bfloat16, torch.float32):
            for m in (1, prefill_m):
                x = torch.randn((m, k), generator=gen, device=device).to(dtype)
                before = dict(int4_matmul.route_launches)
                out = int4_matmul_tensor(x, w)
                route = ("gemv" if m == 1 else "tensor_core"
                         if dtype == torch.bfloat16 else "tile")
                check(int4_matmul.route_launches[route] == before[route] + 1,
                      f"K3 M={m} {dtype} takes the {route} route")
                r = min(m, K3_CHECK_ROWS)
                ref = plain(x[:r])
                tol = TOL_K3_REL * float(ref.float().abs().max())
                worst = max(worst, check_close(
                    out[:r], ref, tol, f"K3 M={m} (rows checked {r}) K={k} "
                    f"N={n} {str(dtype)[6:]}", floor=tol))
                del ref
                if dtype != torch.bfloat16:
                    continue
                reps_m = reps if m == 1 else 3
                ms, plain_ms = kernel_and_plain_ms(
                    lambda: int4_matmul_tensor(x, w), lambda: plain(x),
                    reps_m)
                lib_ms, lib_note = None, lib_refused
                if lib is not None:
                    try:
                        lib_out = lib(x)
                        lib_ms = cuda_ms(lambda: lib(x), reps_m)[1]
                        lib_note = (
                            f"{lib_ms:.4f} ms, max abs diff from K3 "
                            f"{max_err(lib_out, out):.3e} (bf16 scales)")
                        del lib_out
                    except RuntimeError as e:
                        lib_note = f"refused ({str(e)[:80]})"
                cost = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                        **bound(nbytes(x, w.q_packed, w.scale, out),
                                2 * m * k * n, dtype)}
                device_note = ""
                if m == 1:
                    cost["device_us"] = _device_us_per_call(
                        lambda: int4_matmul_tensor(x, w), match="int4")
                    cost["library_device_us"] = (
                        None if lib_ms is None
                        else _device_us_per_call(lambda: lib(x)))
                    device_note = (
                        f"; device us per launch: kernel "
                        f"{cost['device_us']:.3f} (bound "
                        f"{cost['bound_ms'] * 1e3:.3f}), library "
                        f"{cost['library_device_us']}")
                costs[m, k, n] = cost
                log(f"K3 M={m} K={k} N={n} bf16: kernel {ms:.4f} ms, plain "
                    f"{plain_ms:.4f} ms, bound {cost['bound_ms']:.4f} ms "
                    f"({cost['bound_by']}, {cost['bound_ms'] / ms:.3f} of "
                    f"it reached); torch._weight_int4pack_mm {lib_note}"
                    f"{device_note}")
    rows = {m: [costs[m, k, n] for k, n in shapes] for m in (1, prefill_m)}
    decode, prefill = (_per_forward(rows[m], layers) for m in (1, prefill_m))
    device_us = {key: sum(r[key] for r in rows[1]) / len(rows[1])
                 if all(r[key] is not None for r in rows[1]) else None
                 for key in ("device_us", "library_device_us")}
    log(f"K3 per forward ({layers} layers x {len(shapes)} matmuls): decode "
        f"step {decode}; prefill {prefill}, "
        f"{prefill['bound_ms'] / prefill['ms']:.3f} of its bound; M=1 device "
        f"us per launch, mean of the {len(shapes)} matmuls: {device_us}")
    return {"max_abs_err": worst, **decode, "m1_device_us": device_us,
            "per_layer_m1": rows[1], "prefill": prefill}


def phase_k4(device, layers: int, prefill_m: int = PROMPT,
             reps: int = 20) -> dict:
    """K4 against its plain version at every fused Llama-2-7B matmul shape
    and lm_head, M=1 and M=prefill_m, bf16 and float32 outputs: equal bit
    for bit, each call on the route its shape takes (M=1 the GEMV, M >
    SMALL_M the int8 tensor cores at these shapes). Timed in bf16 at both M
    with its bound; at M=1 also the GEMV's device time per launch. The
    library yardstick is torch._int_mm plus the same scaling, timed on the
    weights as the port keeps them ([K, N], N-contiguous) and on a K-major
    copy made once outside the timing (passed as its transposed view, the
    layout cuBLAS's int8 tensor-core kernels want); library_ms is the
    faster of the two."""
    from realtime_kv_cache_compression_tpu_torch.ops.cuda.int8_matmul import (
        int8_matmul, int8_matmul_plain)

    gen = torch.Generator(device=device).manual_seed(SEED + 6)
    worst, rows = 0.0, {1: [], prefill_m: []}
    lm_head, routes = {}, {}
    for k, n in SHAPES_7B + (LM_HEAD_7B,):
        w = _int8_weight(gen, k, n, device)
        w_t = w.q.t().contiguous()  # K-major copy for the yardstick only
        for m in (1, prefill_m):
            x_q = torch.randint(-127, 128, (m, k), generator=gen,
                                device=device, dtype=torch.int8)
            x_s = torch.rand((m,), generator=gen, device=device) / 127 + 1e-4
            route = "gemv" if m == 1 else "tc"
            for dtype in (torch.bfloat16, torch.float32):
                before = dict(int8_matmul.route_launches)
                out = int8_matmul(x_q, w.q, x_s, w.scale, out_dtype=dtype)
                check(int8_matmul.route_launches[route] == before[route] + 1,
                      f"K4 M={m} K={k} N={n} {dtype} takes the {route} "
                      f"route")
                ref = int8_matmul_plain(x_q, w.q, x_s, w.scale,
                                        out_dtype=dtype)
                bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
                same = torch.equal(out.view(bits), ref.view(bits))
                err = max_err(out, ref)
                worst = max(worst, err)
                log(f"K4 M={m} K={k} N={n} {str(dtype)[6:]} ({route}): "
                    f"bit-equal {same}, max abs err {err:.3e}")
                check(same, f"K4 M={m} K={k} N={n} {dtype} bit for bit")
                del ref
            routes[f"M={m} K={k} N={n}"] = route
            reps_m = reps if m == 1 else 3
            ms, plain_ms = kernel_and_plain_ms(
                lambda: int8_matmul(x_q, w.q, x_s, w.scale),
                lambda: int8_matmul_plain(x_q, w.q, x_s, w.scale), reps_m)
            lib_ms = {}
            for layout, b_op in (("[K, N]", w.q), ("K-major", w_t.t())):
                lib = lambda: (  # noqa: E731
                    torch._int_mm(x_q, b_op).float() * x_s[:, None]
                    * w.scale[None, :]).bfloat16()
                try:
                    lib()
                    lib_ms[layout] = cuda_ms(lib, reps_m)[1]
                except RuntimeError as e:  # the yardstick only; never the port
                    lib_ms[layout] = f"refused ({str(e)[:60]})"
            timed = [v for v in lib_ms.values() if isinstance(v, float)]
            cost = {"ms": ms, "plain_ms": plain_ms,
                    "library_ms": min(timed) if timed else None,
                    "library_ms_by_layout": lib_ms, "route": route,
                    **bound(nbytes(x_q, w.q, x_s, w.scale) + m * n * 2,
                            2 * m * k * n, torch.int8)}
            device_note = ""
            if m == 1:
                cost["device_us"] = _device_us_per_call(
                    lambda: int8_matmul(x_q, w.q, x_s, w.scale),
                    match="int8")
                device_note = (f"; device us per launch {cost['device_us']:.3f}"
                               f" (bound {cost['bound_ms'] * 1e3:.3f})")
            if (k, n) == LM_HEAD_7B:
                lm_head[m] = cost
            else:
                rows[m].append(cost)
            log(f"K4 M={m} K={k} N={n} bf16 ({route}): kernel {ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms, bound {cost['bound_ms']:.4f} ms "
                f"({cost['bound_by']}, {cost['bound_ms'] / ms:.3f} of it "
                f"reached); torch._int_mm + scaling {lib_ms}{device_note}")
        del w, w_t
    # lm_head runs at M=1 in decode and in prefill (last position only).
    decode = _per_forward(rows[1], layers, lm_head[1])
    prefill = _per_forward(rows[prefill_m], layers, lm_head[1])
    lib_layouts = {
        layout: (None if any(not isinstance(r["library_ms_by_layout"][layout],
                                            float) for r in rows[prefill_m])
                 else layers * sum(r["library_ms_by_layout"][layout]
                                   for r in rows[prefill_m]))
        for layout in ("[K, N]", "K-major")}
    # library_ms of the prefill: the faster layout's layer matmuls (128
    # calls at M=prefill_m); lm_head's one M=1 call has no library call
    # (torch._int_mm refuses M=1) and is left out of it, so the kernel's
    # own time over the same 128 calls stands beside it.
    timed = [v for v in lib_layouts.values() if v is not None]
    prefill["library_ms"] = min(timed) if timed else None
    prefill["ms_layer_matmuls"] = layers * sum(r["ms"]
                                               for r in rows[prefill_m])
    gemv = [r["device_us"] for r in rows[1]] + [lm_head[1]["device_us"]]
    device_us = {"mean_4_shapes": sum(gemv[:4]) / 4, "lm_head": gemv[4],
                 "bound_mean_4_shapes": sum(r["bound_ms"] for r in rows[1])
                 * 1e3 / 4}
    log(f"K4 per forward ({layers} layers x 4 matmuls + lm_head): decode "
        f"step {decode}; prefill {prefill}, {prefill['bound_ms'] / prefill['ms']:.3f}"
        f" of its bound; library per prefill by weight layout (layer "
        f"matmuls) {lib_layouts}; GEMV device us per launch {device_us}; "
        f"lm_head at M={prefill_m} (not on the path) {lm_head[prefill_m]}")
    return {"max_abs_err": worst, **decode, "per_layer_m1": rows[1],
            "lm_head_m1": lm_head[1], "prefill": prefill,
            "prefill_library_by_layout": lib_layouts,
            "m1_device_us": device_us, "routes": routes}


def _quantized(params, arm: str):
    from realtime_kv_cache_compression_tpu_torch.models import llama
    from realtime_kv_cache_compression_tpu_torch.models.quantized_params \
        import quantize_params, quantize_params_streaming
    if arm == "int4":
        params = quantize_params_streaming(params, bits=4, group_size=128)
    elif arm == "w8a8":
        params = quantize_params(params, bits=8, act_quant=True)
    return llama.fuse_params(params)


def phase_parity(device, mcfg, arm: str = "raw", prompt: int = 1024,
                 new_tokens: int = 16):
    """Kernel path vs plain path in float32: equal greedy tokens. The raw
    arm runs its plain path on the card (use_flash / use_fused off); the
    quantized arms run theirs on the CPU, where every wrapper takes its
    plain version (the matmul wrappers have no switch)."""
    from realtime_kv_cache_compression_tpu_torch import CompressionConfig
    from realtime_kv_cache_compression_tpu_torch.models import llama
    from realtime_kv_cache_compression_tpu_torch.models.quantized_params \
        import params_to

    mcfg = dataclasses.replace(mcfg, dtype="float32")
    ccfg = CompressionConfig(num_layers=mcfg.num_layers)
    params = _quantized(llama.init_params(SEED, mcfg, device), arm)
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    ids = torch.randint(0, mcfg.vocab_size, (1, prompt), generator=gen,
                        device=device)
    runs = {}
    for kernels in (True, False):
        p, i, use = params, ids, kernels
        if arm != "raw" and not kernels:  # CPU tensors: plain versions
            p, i, use = params_to(params, "cpu"), ids.cpu(), None
        logits, state, _ = llama.prefill_compressed(
            p, i, mcfg, ccfg, max_decode_len=new_tokens, use_flash=use)
        tok = torch.argmax(logits, -1)
        toks, _ = llama.decode_loop(p, tok, state, new_tokens - 1, mcfg,
                                    ccfg, use_fused=use)
        runs[kernels] = (torch.cat([tok[:, None], toks], 1).cpu(), state,
                         logits.cpu())
    (tk, sk, lk), (tp, sp, lp) = runs[True], runs[False]
    for i, (ck, cp) in enumerate(zip(sk.caches, sp.caches)):
        agree = [float((a.positions.cpu() == b.positions.cpu()).float()
                       .mean()) if a.capacity else 1.0
                 for a, b in zip(ck.tiers, cp.tiers)]
        log(f"parity {arm} layer {i}: kept-position agreement per tier "
            f"(high, mid, low) {agree}")
    log(f"parity {arm} f32 ({mcfg.num_layers} layers, hidden "
        f"{mcfg.hidden_size}, prompt {prompt}): prefill logits max err "
        f"{max_err(lk, lp):.3e}; tokens kernel {tk.tolist()} plain "
        f"{tp.tolist()}")
    check(torch.equal(tk, tp), f"greedy tokens of kernel and plain paths "
                               f"({arm})")


def _kept_swaps(caches_a, caches_b, masses, ccfg, lengths, s,
                qmasses=None) -> list:
    """Per layer, the tokens kept (per tier and row) by one prefill and not
    the other, with their importance scores from `masses` (and `qmasses`,
    the query masses, under query-guided scoring): [(layer, tier, row,
    tokens, scores, paired)]."""
    from realtime_kv_cache_compression_tpu_torch.models import llama
    from realtime_kv_cache_compression_tpu_torch.ops.importance import (
        importance_scores)

    plens = llama._prompt_lens(lengths, ccfg, ccfg.prompt_length(s))
    swaps = []
    for li, (ca, cb) in enumerate(zip(caches_a, caches_b)):
        scores = importance_scores(
            masses[li], li, s, ccfg.prompt_length(s), ccfg, lengths=lengths,
            prompt_lens=plens,
            query_mass=None if qmasses is None else qmasses[li])
        for ti, (ta, tb) in enumerate(zip(ca.tiers, cb.tiers)):
            for r in range(lengths.shape[0]):
                ka = set(ta.positions[r][ta.valid[r]].tolist())
                kb = set(tb.positions[r][tb.valid[r]].tolist())
                if ka != kb:
                    toks = sorted(ka ^ kb)
                    swaps.append((li, ti, r, toks,
                                  scores[r, toks].tolist(),
                                  len(ka - kb) == len(kb - ka)))
    return swaps


def phase_parity_chunked(device, mcfg, prompt: int = 1024,
                         lengths=(1024, 700), chunk: int = 256,
                         ring: int = 16, blocks: int = 2, steps: int = 64):
    """The chunked, pooled path in float32 at reduced depth (full width):
    ragged `lengths`, chunks of `chunk`, a `ring`-token ring and `blocks`
    4-bit pool blocks with 2 scale groups, `steps` greedy steps (3 flushes
    per layer and a wrap). Kernel path vs plain path (both on the card):
    equal tokens. Chunked vs one-shot prefill (kernel path): equal tokens,
    and equal kept positions and validity per layer, except a swap at a
    tier boundary between tokens whose scores lie within SWAP_TOL (the two
    prefills run float32 matmuls at other shapes), which is logged."""
    from realtime_kv_cache_compression_tpu_torch.models import llama

    mcfg = dataclasses.replace(mcfg, dtype="float32")
    ccfg = _pooled_ccfg(mcfg.num_layers, mcfg.head_dim // 2, blocks=blocks)
    params = llama.fuse_params(llama.init_params(SEED, mcfg, device))
    gen = torch.Generator(device=device).manual_seed(SEED + 9)
    ids = torch.randint(0, mcfg.vocab_size, (len(lengths), prompt),
                        generator=gen, device=device)
    lens = torch.tensor(lengths, device=device)
    runs = {}
    for kernels in (True, False):
        st = llama._prefill_chunks(params, ids, mcfg, ccfg, chunk, lens,
                                   kernels)
        logits, state, _ = llama.prefill_chunked_finish(
            params, st, mcfg, ccfg, max_decode_len=ring, lengths=lens)
        masses, caches = st.masses, state.caches
        toks, state = llama.decode_loop(params, torch.argmax(logits, -1),
                                        state, steps, mcfg, ccfg,
                                        use_fused=kernels)
        check(int(state.pools[0].write_block[0])
              == ((steps - 1) // ring) % blocks, "chunked parity: pool wrap")
        runs[kernels] = (toks.cpu(), caches, masses, logits.cpu())
    (tk_, ck, mk, lk), (tp, _, _, lp) = runs[True], runs[False]
    log(f"parity chunked f32 ({mcfg.num_layers} layers, hidden "
        f"{mcfg.hidden_size}, lengths {lengths}, chunk {chunk}, ring {ring}, "
        f"{blocks} pool blocks, G=2): prefill logits max err "
        f"{max_err(lk, lp):.3e}; tokens kernel {tk_.tolist()} plain "
        f"{tp.tolist()}")
    check(torch.equal(tk_, tp), "chunked path: greedy tokens of kernel and "
                                "plain paths")
    logits, state, _ = llama.prefill_compressed(
        params, ids, mcfg, ccfg, max_decode_len=ring, lengths=lens)
    swaps = _kept_swaps(ck, state.caches, mk, ccfg, lens, prompt)
    for li, ti, r, toks, scores, paired in swaps:
        spread = max(scores) - min(scores)
        log(f"chunked vs one-shot: layer {li} tier {ti} row {r} swaps "
            f"tokens {toks} (scores {scores}, spread {spread:.3e})")
        check(paired and spread <= SWAP_TOL,
              "chunked vs one-shot kept positions (boundary swap rule)")
    t1, _ = llama.decode_loop(params, torch.argmax(logits, -1), state, steps,
                              mcfg, ccfg)
    log(f"chunked vs one-shot prefill: logits max err "
        f"{max_err(lk, logits.cpu()):.3e}, {len(swaps)} boundary swaps, "
        f"tokens "
        f"equal {torch.equal(t1.cpu(), tk_)}")
    check(torch.equal(t1.cpu(), tk_), "greedy tokens of chunked and one-shot "
                                      "prefill")


def _recording_compress(compress_layer_kv, records):
    """`compress_layer_kv` that records each call's layer, offset, mass,
    min-max and query mass (for the swap rule's scores), then compresses."""
    def compress(k, v, mass, li, ccfg, mcfg, **kw):
        records[(li, kw.get("shard_offset", 0))] = (
            mass, kw.get("minmax"), kw.get("query_mass"))
        return compress_layer_kv(k, v, mass, li, ccfg, mcfg, **kw)
    return compress


def phase_parity_prefix(device, mcfg, prompt: int = 1024, chunk: int = 256,
                        steps: int = 16):
    """The compressed-prefix path in float32 at reduced depth (full width):
    B=2, `prompt` tokens in chunks of `chunk`, `steps` greedy steps. Kernel
    path (K1 mode (d) + the diagonal pair, K2 over the chunk-packed tiers)
    vs plain path (dense positioned attention, plain decode), both on the
    card: logits within TOL_LOGITS, equal tokens, and equal kept positions
    per layer, except a swap at a tier boundary between tokens whose
    chunk-local scores lie within SWAP_TOL. Then one chunk of `prompt`
    tokens (kernel path) against `prefill_compressed`: logits within
    TOL_LOGITS and identical kept positions and validity."""
    from realtime_kv_cache_compression_tpu_torch import CompressionConfig
    from realtime_kv_cache_compression_tpu_torch.models import llama
    from realtime_kv_cache_compression_tpu_torch.ops.importance import (
        importance_scores)

    mcfg = dataclasses.replace(mcfg, dtype="float32")
    ccfg = CompressionConfig(num_layers=mcfg.num_layers)
    params = llama.fuse_params(llama.init_params(SEED, mcfg, device))
    gen = torch.Generator(device=device).manual_seed(SEED + 14)
    ids = torch.randint(0, mcfg.vocab_size, (PREFIX_BATCH, prompt),
                        generator=gen, device=device)
    plen = ccfg.prompt_length(prompt)
    runs, records = {}, {}
    original = llama.compress_layer_kv
    for kernels in (True, False):
        llama.compress_layer_kv = _recording_compress(
            original, records if kernels else {})
        try:
            logits, state, _ = llama.prefill_compressed_prefix_chunked(
                params, ids, mcfg, ccfg, chunk_size=chunk,
                max_decode_len=steps, use_flash=kernels)
        finally:
            llama.compress_layer_kv = original
        toks, _ = llama.decode_loop(params, torch.argmax(logits, -1), state,
                                    steps, mcfg, ccfg, use_fused=kernels)
        runs[kernels] = (logits, state.caches, toks)
    (lk, ck, tk), (lp, cp, tp) = runs[True], runs[False]
    n_swaps = 0
    for li, (a, c) in enumerate(zip(ck, cp)):
        for ti, (ta, tc) in enumerate(zip(a.tiers, c.tiers)):
            for r in range(PREFIX_BATCH):
                ka = set(ta.positions[r][ta.valid[r]].tolist())
                kb = set(tc.positions[r][tc.valid[r]].tolist())
                if ka == kb:
                    continue
                toks_x = sorted(ka ^ kb)
                scores = []
                for t in toks_x:
                    off = t // chunk * chunk
                    mass, mm, _ = records[(li, off)]
                    scores.append(float(importance_scores(
                        mass, li, chunk, plen, ccfg, position_offset=off,
                        total_len=prompt, minmax=mm)[r, t - off]))
                spread = max(scores) - min(scores)
                n_swaps += 1
                log(f"prefix kernel vs plain: layer {li} tier {ti} row {r} "
                    f"swaps tokens {toks_x} (scores {scores}, spread "
                    f"{spread:.3e})")
                check(len(ka - kb) == len(kb - ka) and spread <= SWAP_TOL,
                      "prefix path kept positions (boundary swap rule)")
    log(f"parity prefix f32 ({mcfg.num_layers} layers, hidden "
        f"{mcfg.hidden_size}, B={PREFIX_BATCH} x {prompt}, chunk {chunk}): "
        f"prefill logits max err {max_err(lk, lp):.3e}, {n_swaps} boundary "
        f"swaps; tokens kernel {tk.tolist()} plain {tp.tolist()}")
    check(max_err(lk, lp) <= TOL_LOGITS, "prefix path: logits of kernel and "
                                         "plain paths")
    check(torch.equal(tk, tp), "prefix path: greedy tokens of kernel and "
                               "plain paths")

    lg1, st1, _ = llama.prefill_compressed_prefix_chunked(
        params, ids, mcfg, ccfg, chunk_size=prompt, max_decode_len=steps)
    lg2, st2, _ = llama.prefill_compressed(params, ids, mcfg, ccfg,
                                           max_decode_len=steps)
    same = all(torch.equal(a.valid, c.valid) and all(
        torch.equal(torch.sort(a.positions[r][a.valid[r]])[0],
                    torch.sort(c.positions[r][c.valid[r]])[0])
        for r in range(PREFIX_BATCH))
        for x, y in zip(st1.caches, st2.caches)
        for a, c in zip(x.tiers, y.tiers))
    log(f"prefix path, one chunk of {prompt} vs prefill_compressed: logits "
        f"max err {max_err(lg1, lg2):.3e}, kept positions identical {same}")
    check(max_err(lg1, lg2) <= TOL_LOGITS and same,
          "single-chunk prefix path equals prefill_compressed")


def _query_ccfg(num_layers: int, source: str):
    from realtime_kv_cache_compression_tpu_torch import CompressionConfig
    return CompressionConfig(num_layers=num_layers, importance_source=source,
                             query_window=0, query_mass_pool=QUERY_POOL)


def _kept_positions(caches) -> list:
    """Per layer, tier and row, the sorted kept positions."""
    return [[[sorted(t.positions[r][t.valid[r]].tolist())
              for r in range(t.positions.shape[0])] for t in c.tiers]
            for c in caches]


def phase_parity_query(device, mcfg, prompt: int = 1024,
                       lengths=(1024, 700), chunk: int = 256,
                       steps: int = 16):
    """Query-guided scoring in float32 at reduced depth (full width), for
    "query" and "both", ragged rows: the kernel path (K1 mode (a), K2)
    against the plain path, both on the card: equal greedy tokens and
    equal kept positions per layer, tier and row. Then the chunked prefill
    (kernel path, chunks of `chunk`, window rows buffered in `q_tails`)
    against the one-shot prefill: equal tokens, and equal kept positions
    except a swap at a tier boundary between tokens whose scores (from the
    recorded prompt and query masses) lie within SWAP_TOL."""
    from realtime_kv_cache_compression_tpu_torch.models import llama

    mcfg = dataclasses.replace(mcfg, dtype="float32")
    params = llama.fuse_params(llama.init_params(SEED, mcfg, device))
    gen = torch.Generator(device=device).manual_seed(SEED + 15)
    ids = torch.randint(0, mcfg.vocab_size, (len(lengths), prompt),
                        generator=gen, device=device)
    lens = torch.tensor(lengths, device=device)
    for source in QUERY_SOURCES[1:]:
        ccfg = _query_ccfg(mcfg.num_layers, source)
        runs = {}
        for kernels in (True, False):
            logits, state, _ = llama.prefill_compressed(
                params, ids, mcfg, ccfg, max_decode_len=steps, lengths=lens,
                use_flash=kernels)
            kept = _kept_positions(state.caches)
            toks, _ = llama.decode_loop(params, torch.argmax(logits, -1),
                                        state, steps, mcfg, ccfg,
                                        use_fused=kernels)
            runs[kernels] = (logits, kept, toks.cpu())
        (lk, kk, tk), (lp, kp, tp) = runs[True], runs[False]
        log(f"parity {source} f32 ({mcfg.num_layers} layers, hidden "
            f"{mcfg.hidden_size}, lengths {lengths}, W "
            f"{ccfg.query_window_for(prompt)}, pool {QUERY_POOL}): prefill "
            f"logits max err {max_err(lk, lp):.3e}; kept positions equal "
            f"{kk == kp}; tokens kernel {tk.tolist()} plain {tp.tolist()}")
        check(kk == kp, f"{source}: kept positions of kernel and plain paths")
        check(torch.equal(tk, tp), f"{source}: greedy tokens of kernel and "
                                   f"plain paths")

        records = {}
        original = llama.compress_layer_kv
        llama.compress_layer_kv = _recording_compress(original, records)
        try:
            logits, state, _ = llama.prefill_compressed_chunked(
                params, ids, mcfg, ccfg, chunk_size=chunk,
                max_decode_len=steps, lengths=lens)
        finally:
            llama.compress_layer_kv = original
        masses = [records[(li, 0)][0] for li in range(mcfg.num_layers)]
        qmasses = [records[(li, 0)][2] for li in range(mcfg.num_layers)]
        one_shot = llama.prefill_compressed(params, ids, mcfg, ccfg,
                                            max_decode_len=steps,
                                            lengths=lens)[1]
        swaps = _kept_swaps(state.caches, one_shot.caches, masses, ccfg,
                            lens, prompt, qmasses)
        for li, ti, r, toks_x, scores, paired in swaps:
            spread = max(scores) - min(scores)
            log(f"{source} chunked vs one-shot: layer {li} tier {ti} row {r} "
                f"swaps tokens {toks_x} (scores {scores}, spread "
                f"{spread:.3e})")
            check(paired and spread <= SWAP_TOL,
                  f"{source}: chunked vs one-shot kept positions (boundary "
                  f"swap rule)")
        toks, _ = llama.decode_loop(params, torch.argmax(logits, -1), state,
                                    steps, mcfg, ccfg)
        log(f"{source} chunked (chunk {chunk}) vs one-shot prefill: logits "
            f"max err {max_err(logits, lk):.3e}, {len(swaps)} boundary "
            f"swaps, tokens equal {torch.equal(toks.cpu(), tk)}")
        check(torch.equal(toks.cpu(), tk), f"{source}: greedy tokens of "
                                           f"chunked and one-shot prefill")


def _uncompressed_run(params, ids, mcfg, pos, pad, steps: int,
                      lengths=None):
    """The uncompressed arm once, timed by CUDA events: its prefill (TTFT
    ms) and `steps` greedy steps over the dense cache, which `pad` widens
    (decode tok/s over every row)."""
    from realtime_kv_cache_compression_tpu_torch.models import llama

    (lo, (ks, vs)), ttft = cuda_ms(lambda: llama.prefill_uncompressed(
        params, ids, mcfg, lengths=lengths))
    tok, kv = torch.argmax(lo, -1), (pad(ks), pad(vs))
    del ks, vs
    _, dec_ms = cuda_ms(lambda: llama.decode_loop_uncompressed(
        params, tok, kv, pos, steps, mcfg))
    return ttft, ids.shape[0] * steps / (dec_ms / 1e3)


def phase_main(label: str, device, mcfg, params, expect, prompt: int = PROMPT,
               new_tokens: int = NEW_TOKENS) -> dict:
    """One path at full width: counted once (every launch count set to 0
    just before, read just after and held to `expect`, a dict of kernel
    key -> launches), that run timed by CUDA events (TTFT and decode
    tok/s); then the uncompressed arm, one run timed (its prefill and
    BASELINE_STEPS decode steps)."""
    from realtime_kv_cache_compression_tpu_torch import CompressionConfig
    from realtime_kv_cache_compression_tpu_torch.compression import (
        summarize_layer_stats)
    from realtime_kv_cache_compression_tpu_torch.models import llama
    from realtime_kv_cache_compression_tpu_torch.models.quantized_params \
        import params_bytes

    ccfg = CompressionConfig(num_layers=mcfg.num_layers)  # tiers 8/4/2
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    ids = torch.randint(0, mcfg.vocab_size, (1, prompt), generator=gen,
                        device=device)
    n_steps = new_tokens - 1
    prefill = lambda: llama.prefill_compressed(  # noqa: E731
        params, ids, mcfg, ccfg, max_decode_len=new_tokens)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    routed = [key for key in KERNELS
              if hasattr(wrapper(key), "route_launches")]
    _zero_counts()
    for key in routed:
        wrapper(key).route_launches = dict.fromkeys(
            wrapper(key).route_launches, 0)
    (logits, state, stats), ttft = cuda_ms(prefill)
    first = torch.argmax(logits, -1)
    (toks, state), dec_ms = cuda_ms(lambda: llama.decode_loop(
        params, first, state, n_steps, mcfg, ccfg))
    rate = n_steps / (dec_ms / 1e3)
    launches = _launches()
    routes = {key: dict(wrapper(key).route_launches) for key in routed}
    k1_tiles = _k1_tiles(mcfg)
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    summary = summarize_layer_stats(stats)
    log(f"{label} launches: {launches} (expect {expect}); by route "
        f"{routes}; K1 by tile {k1_tiles}")
    check(launches == expect, f"{label}: launches per kernel")
    check(toks.shape == (1, n_steps) and bool(torch.isfinite(logits).all()),
          f"{label}: output shape and finite logits")
    check(0.0 < summary["avg_compression_ratio"] < 1.0,
          "kept ratio in (0, 1)")
    log(f"{label}: kept_ratio {summary['avg_compression_ratio']:.4f}, "
        f"byte_savings {summary['avg_memory_savings']:.4f}, params "
        f"{params_bytes(params) / 2**20:.1f} MB, peak memory {peak_mb:.1f} "
        f"MB")

    log(f"{label} (compressed), the counted run timed: TTFT ms {ttft:.3f}; "
        f"decode tok/s {rate:.3f}")

    # Uncompressed arm (its prefill runs K1 as well).
    pad = lambda a: torch.nn.functional.pad(  # noqa: E731
        a, (0, 0, 0, 0, 0, new_tokens))
    pos = torch.full((1,), prompt, dtype=torch.int32, device=device)
    steps_u = min(BASELINE_STEPS, n_steps)
    ttft_u, rate_u = _uncompressed_run(params, ids, mcfg, pos, pad, steps_u)
    log(f"{label} (uncompressed arm), one run timed: TTFT ms {ttft_u:.3f}; "
        f"decode tok/s {rate_u:.3f} over {steps_u} steps")
    return {"launches": launches, "routes": routes, "params": params,
            "ids": ids, "ccfg": ccfg, "decode_tok_s": rate,
            "tokens": torch.cat([first[:, None], toks], 1).cpu()}


def _device_busy_ms(prof) -> float:
    """Milliseconds in which at least one kernel or copy ran on the card,
    from the profiler's device events (overlaps counted once)."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy / 1e3


def _profile_window(label: str, what: str, fn, top: int = 6) -> None:
    """torch.profiler over one call of `fn`: device busy time against host
    wall time (the profiler slows the host), and the kernels that take most
    device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = _device_busy_ms(prof)
    log(f"profile {label} {what}: wall {wall:.3f} ms, device busy "
        f"{busy:.3f} ms, device idle share {1 - busy / wall:.4f}")
    check(busy > 0, f"profile {label} {what} saw device time")
    kernels = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, t = kernels.get(e.name, (0, 0.0))
            kernels[e.name] = (n + 1, t + e.time_range.elapsed_us())
    for name, (n, t) in sorted(kernels.items(),
                               key=lambda kv: -kv[1][1])[:top]:
        log(f"  {t / 1e3:9.3f} ms  {n:5d} x  {name[:90]}")
    k1 = [(n, t) for name, (n, t) in kernels.items()
          if "flash_tc_" in name or "flash_prefill_kernel" in name]
    if k1:
        log(f"  K1 in {label} {what}: {sum(t for _, t in k1) / 1e3:.3f} ms "
            f"of device time over {sum(n for n, _ in k1)} launches")


def phase_profile(label: str, mcfg, main_run, decode_steps: int = 10,
                  top: int = 6) -> None:
    """Where the time goes in a main run: torch.profiler over one
    compressed prefill and over `decode_steps` decode steps; device busy
    time against host wall time (the profiler slows the host), and the
    kernels that take most device time. Then `compress_layer_kv` of one
    layer alone, on the host clock."""
    from realtime_kv_cache_compression_tpu_torch.compression import (
        compress_layer_kv)
    from realtime_kv_cache_compression_tpu_torch.models import llama

    params, ids, ccfg = main_run["params"], main_run["ids"], main_run["ccfg"]
    logits, state, _ = llama.prefill_compressed(
        params, ids, mcfg, ccfg, max_decode_len=NEW_TOKENS)
    tok = torch.argmax(logits, -1)
    _profile_window(label, "prefill", lambda: llama.prefill_compressed(
        params, ids, mcfg, ccfg, max_decode_len=NEW_TOKENS), top)
    _profile_window(label, f"decode {decode_steps} steps",
                    lambda: llama.decode_loop(params, tok, state,
                                              decode_steps, mcfg, ccfg), top)

    gen = torch.Generator(device=ids.device).manual_seed(SEED + 4)
    b, s, hkv, d = 1, ids.shape[1], mcfg.num_kv_heads, mcfg.head_dim
    dt = llama.model_dtype(mcfg)
    k, v = (torch.randn((b, s, hkv, d), generator=gen, device=ids.device)
            .to(dt) for _ in range(2))
    mass = torch.rand((b, s), generator=gen, device=ids.device)
    times = []
    for _ in range(6):  # the first is the warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        compress_layer_kv(k, v, mass, 0, ccfg, mcfg)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    log(f"compress_layer_kv alone ({label}), one layer, S={s}: host ms "
        f"{_spread(times[1:])}")


def run_7b_arm(arm: str, device, mcfg):
    """Llama-2-7B bf16 random weights from SEED, quantized for `arm`, fused;
    the main run with its launch counts, overall and by route (the prefill's
    128 layer matmuls on the tensor cores, every M=1 call on the GEMV), then
    a profile. Returns (launches, launches by route)."""
    from realtime_kv_cache_compression_tpu_torch.models import llama

    t0 = time.perf_counter()
    params = _quantized(llama.init_params(SEED, mcfg, device), arm)
    torch.cuda.synchronize()
    log(f"llama2-7b {arm}: init + quantize + fuse "
        f"{time.perf_counter() - t0:.1f} s")
    n_layers, n_steps = mcfg.num_layers, NEW_TOKENS - 1
    expect = {key: 0 for key in KERNELS}
    expect.update(K1=n_layers, K2=n_layers * n_steps)
    if arm == "int4":
        key, tc = "K3", "tensor_core"
        expect[key] = 4 * n_layers * (1 + n_steps)
        gemv = 4 * n_layers * n_steps  # lm_head is int8 weight-only
        other = {"gemv_expert": 0}
    else:
        key, tc = "K4", "tc"
        expect[key] = (4 * n_layers + 1) * (1 + n_steps)
        gemv = (4 * n_layers + 1) * n_steps + 1  # + lm_head at prefill
        other = {}
    run = phase_main(f"llama2-7b {arm} main run", device, mcfg, params,
                     expect)
    routes = run["routes"][key]
    check(routes == {"gemv": gemv, tc: 4 * n_layers, "tile": 0, **other},
          f"llama2-7b {arm}: {key} launches by route {routes}")
    phase_profile(f"llama2-7b {arm}", mcfg, run)
    launches = run["launches"]
    del run, params
    torch.cuda.empty_cache()
    return launches, routes


def run_gemma(device, mcfg) -> dict:
    """Gemma-2B at full width and depth, bf16 random weights from SEED,
    fused: the main run with its launch counts (K1 and K2 only: no
    quantized weights), then a profile."""
    from realtime_kv_cache_compression_tpu_torch.models import llama

    t0 = time.perf_counter()
    params = llama.fuse_params(llama.init_params(SEED, mcfg, device))
    torch.cuda.synchronize()
    log(f"gemma-2b: init + fuse {time.perf_counter() - t0:.1f} s")
    expect = {key: 0 for key in KERNELS}
    expect.update(K1=mcfg.num_layers, K2=mcfg.num_layers * (NEW_TOKENS - 1))
    run = phase_main("gemma-2b main run", device, mcfg, params, expect)
    phase_profile("gemma-2b", mcfg, run)
    launches = run["launches"]
    del run, params
    torch.cuda.empty_cache()
    return launches


def _expert_weight(gen, e, k, n, device):
    from realtime_kv_cache_compression_tpu_torch.models.quantized_params \
        import quantize_expert_tensor_int4
    w = torch.randn((e, k, n), generator=gen, device=device) * k ** -0.5
    return quantize_expert_tensor_int4(w, group_size=128)


def phase_k3_expert(device, num_experts: int = 8, reps: int = 20) -> dict:
    """K3's expert-indexed GEMV at Mixtral-8x7B's expert shapes (gate/up
    4096 x 14336, down 14336 x 4096, 8 experts, groups of 128): bf16 and
    float32 x at M=1 and M=2, the expert ids on the device (every expert,
    the last included), each call against `int4_matmul_plain` on that
    expert's codes and scales, one kernel per call (profiler) and no host
    read (sync debug mode). bf16 M=1 timed with its bound (one expert's
    codes and scales read once), the device time per launch, and
    torch._weight_int4pack_mm on that expert's codes repacked (bf16
    scales) as the library yardstick."""
    from realtime_kv_cache_compression_tpu_torch.ops.cuda.int4_matmul import (
        int4_matmul, int4_matmul_expert, int4_matmul_plain)

    gen = torch.Generator(device=device).manual_seed(SEED + 20)
    ids = torch.arange(num_experts, dtype=torch.int32, device=device)
    worst, rows = 0.0, []
    for k, n in SHAPES_EXPERT:
        w = _expert_weight(gen, num_experts, k, n, device)
        for dtype in (torch.bfloat16, torch.float32):
            for m in (1, 2):
                x = torch.randn((m, k), generator=gen, device=device).to(dtype)
                before = int4_matmul.route_launches["gemv_expert"]
                int4_matmul_expert(x, w.q_packed, w.scale, ids, 0)
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    outs = [int4_matmul_expert(x, w.q_packed, w.scale, ids,
                                               slot)
                            for slot in range(num_experts)]
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                check(int4_matmul.route_launches["gemv_expert"]
                      == before + 1 + num_experts,
                      "K3 expert calls take the gemv_expert route")
                for e in (0, num_experts - 1):
                    ref = int4_matmul_plain(x, w.q_packed[e], w.scale[e])
                    tol = TOL_K3_REL * float(ref.float().abs().max())
                    worst = max(worst, check_close(
                        outs[e], ref, tol, f"K3 expert {e} M={m} K={k} N={n} "
                        f"{str(dtype)[6:]}", floor=tol))
                per_call = _kernels_per_call(lambda: int4_matmul_expert(
                    x, w.q_packed, w.scale, ids, num_experts - 1))
                check(per_call == 1, f"K3 expert call: {per_call} kernels")
                if dtype != torch.bfloat16 or m != 1:
                    continue
                e = num_experts - 1
                one = w.expert(e)
                ms, plain_ms = kernel_and_plain_ms(
                    lambda: int4_matmul_expert(x, w.q_packed, w.scale, ids,
                                               e),
                    lambda: int4_matmul_plain(x, one.q_packed, one.scale),
                    reps)
                try:
                    lib = _int4pack_library(one)
                    lib(x)
                    lib_ms = cuda_ms(lambda: lib(x), reps)[1]
                    lib_us = _device_us_per_call(lambda: lib(x))
                except RuntimeError as err:  # the yardstick only
                    lib, lib_ms, lib_us = None, None, None
                    log(f"torch._weight_int4pack_mm refused ({str(err)[:80]})")
                cost = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                        **bound(nbytes(x, one.q_packed, one.scale, outs[e])
                                + 4, 2 * m * k * n, dtype),
                        "device_us": _device_us_per_call(
                            lambda: int4_matmul_expert(
                                x, w.q_packed, w.scale, ids, e),
                            match="int4"),
                        "library_device_us": lib_us}
                rows.append(cost)
                log(f"K3 expert M=1 K={k} N={n} bf16: kernel {ms:.4f} ms, "
                    f"device {cost['device_us']:.3f} us per launch, "
                    f"{cost['bound_ms'] * 1e3 / cost['device_us']:.3f} of "
                    f"its bound {cost['bound_ms'] * 1e3:.3f} us "
                    f"({cost['bound_by']}); plain {plain_ms:.4f} ms; "
                    f"torch._weight_int4pack_mm {lib_ms} ms, device {lib_us}"
                    f" us")
        del w
    # One routed expert's three projections: gate and up, then down.
    per_expert = {key: (None if any(r[key] is None for r in rows)
                        else 2 * rows[0][key] + rows[1][key])
                  for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                              "device_us", "library_device_us")}
    log(f"K3 expert per routed expert (gate, up, down at M=1): "
        f"{per_expert}")
    return {"max_abs_err": worst, **per_expert, "bound_by": "bytes",
            "per_shape_m1": rows}


def _mixtral_int4(device, mcfg):
    """Mixtral at full width, int4, built layer by layer: layer i from a
    one-layer bf16 init seeded SEED + i, quantized by
    `quantize_params_streaming(bits=4, group_size=128)` and its bf16 freed
    before the next (the whole bf16 tree would not fit the card); embed,
    lm_head and the final norm from layer 0's init. Then `fuse_params`
    (MoE layers stay unfused)."""
    from realtime_kv_cache_compression_tpu_torch.models import llama
    from realtime_kv_cache_compression_tpu_torch.models.quantized_params \
        import quantize_params_streaming

    one = dataclasses.replace(mcfg, num_layers=1)
    params = None
    for i in range(mcfg.num_layers):
        q = quantize_params_streaming(llama.init_params(SEED + i, one, device),
                                      bits=4, group_size=128)
        if params is None:
            params = q
        else:
            params["layers"].append(q["layers"][0])
        del q
        torch.cuda.empty_cache()
    return llama.fuse_params(params)


def _greedy_logits(params, ids, mcfg, ccfg, steps: int):
    """Prefill + `steps` greedy decode steps, one at a time: (tokens
    [steps + 1], logits per step [steps + 1, V]) on the host."""
    from realtime_kv_cache_compression_tpu_torch.models import llama

    logits, state, _ = llama.prefill_compressed(params, ids, mcfg, ccfg,
                                                max_decode_len=steps + 1)
    out = [logits.float().cpu()]
    for _ in range(steps):
        logits, state = llama.decode_step(params, torch.argmax(logits, -1),
                                          state, mcfg, ccfg)
        out.append(logits.float().cpu())
    logits = torch.cat(out)
    return torch.argmax(logits, -1), logits


def phase_parity_mixtral(device, mcfg, prompt: int = MIXTRAL_PARITY_PROMPT,
                         steps: int = MIXTRAL_PARITY_TOKENS - 1) -> None:
    """Mixtral int4 at 2 layers and full width in float32, kernel path (K1,
    K2, K3 on the tensor cores / GEMV / expert GEMV) against the plain path
    (CPU tensors: every wrapper's plain version). The routed experts' GEMV
    takes bf16 x on both (as the reference casts it), and the two round
    the same float32 sums in another order, so their logits differ by
    bf16 ulps of the expert outputs; the prefill (N = prompt > 16 rows,
    the ragged strategy) dequantizes the experts on both paths and runs
    no bf16 GEMV. Rule: the prefill logits within TOL_LOGITS; tokens
    equal up to the first step whose plain top-2 logits lie within twice
    the largest logit error measured so far (a near tie), where they may
    part."""
    from realtime_kv_cache_compression_tpu_torch import CompressionConfig
    from realtime_kv_cache_compression_tpu_torch.models import llama
    from realtime_kv_cache_compression_tpu_torch.models.quantized_params \
        import params_to, quantize_params_streaming

    mcfg = dataclasses.replace(mcfg, dtype="float32")
    ccfg = CompressionConfig(num_layers=mcfg.num_layers)
    params = llama.fuse_params(quantize_params_streaming(
        llama.init_params(SEED, mcfg, device), bits=4, group_size=128))
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    ids = torch.randint(0, mcfg.vocab_size, (1, prompt), generator=gen,
                        device=device)
    k_toks, k_logits = _greedy_logits(params, ids, mcfg, ccfg, steps)
    p_toks, p_logits = _greedy_logits(params_to(params, "cpu"), ids.cpu(),
                                      mcfg, ccfg, steps)
    err0 = max_err(k_logits[0], p_logits[0])
    log(f"parity mixtral int4 f32 (2 layers, prompt {prompt}): prefill "
        f"logits max err {err0:.3e} (tol {TOL_LOGITS:.0e}); tokens "
        f"kernel {k_toks.tolist()} plain {p_toks.tolist()}")
    check(err0 <= TOL_LOGITS, "mixtral f32 prefill logits")
    err, held = err0, 0
    for t in range(steps + 1):
        top2 = torch.topk(p_logits[t], 2).values
        gap = float(top2[0] - top2[1])
        if gap < 2 * err:
            log(f"parity mixtral: step {t} is a near tie (plain top-2 gap "
                f"{gap:.3e} < 2 x {err:.3e}); tokens held to step {t - 1}")
            break
        check(int(k_toks[t]) == int(p_toks[t]),
              f"mixtral f32 token {t} (top-2 gap {gap:.3e}, err {err:.3e})")
        err = max(err, max_err(k_logits[t], p_logits[t]))
        held = t + 1
    log(f"parity mixtral: {held} of {steps + 1} tokens held equal; logit "
        f"error up to {err:.3e}")
    del params
    torch.cuda.empty_cache()


def run_mixtral(device, mcfg) -> dict:
    """Mixtral-8x7B int4 at full width (built layer by layer; run_all cuts
    its depth to MIXTRAL_LAYERS):
    the main run with its launch counts, overall and by K3 route (the
    prefill's 128 unfused attention matmuls on the tensor cores; in decode
    4 attention GEMVs per layer and 6 expert GEMVs per layer and token),
    then a profile, then a checkpoint round trip of layer 0 with the
    embedding, head and final norm. Returns the launches."""
    from realtime_kv_cache_compression_tpu_torch.models import checkpoint
    from realtime_kv_cache_compression_tpu_torch.models.quantized_params \
        import params_bytes

    t0 = time.perf_counter()
    params = _mixtral_int4(device, mcfg)
    torch.cuda.synchronize()
    log(f"mixtral-8x7b int4: init + quantize layer by layer "
        f"{time.perf_counter() - t0:.1f} s, params "
        f"{params_bytes(params) / 2**20:.1f} MB")
    n_layers, n_steps = mcfg.num_layers, NEW_TOKENS - 1
    k = mcfg.num_experts_per_tok
    routes = {"tensor_core": 4 * n_layers, "gemv": 4 * n_layers * n_steps,
              "tile": 0, "gemv_expert": 3 * k * n_layers * n_steps}
    expect = {key: 0 for key in KERNELS}
    expect.update(K1=n_layers, K2=n_layers * n_steps,
                  K3=sum(routes.values()))
    run = phase_main("mixtral-8x7b int4 main run", device, mcfg, params,
                     expect)
    check(run["routes"]["K3"] == routes,
          f"mixtral: K3 launches by route {run['routes']['K3']}")
    phase_profile("mixtral-8x7b int4", mcfg, run)
    launches = run["launches"]
    del run
    torch.cuda.empty_cache()

    # Checkpoint round trip: layer 0, embed, lm_head, final norm.
    tree = {"embed": params["embed"], "lm_head": params["lm_head"],
            "final_norm": params["final_norm"],
            "layers": [params["layers"][0]]}
    t0 = time.perf_counter()
    checkpoint.save_checkpoint(CKPT_DIR, tree)
    t_save = time.perf_counter() - t0
    back = checkpoint.load_checkpoint(CKPT_DIR, template=tree, device=device)
    t_load = time.perf_counter() - t0 - t_save
    checkpoint.check_like(back, tree, exact=True)  # raises where unequal
    log(f"checkpoint round trip (mixtral layer 0 + embed + head, "
        f"{params_bytes(tree) / 2**20:.1f} MB): "
        f"bit-equal; save {t_save:.1f} s, load {t_load:.1f} s")
    del params, tree, back
    torch.cuda.empty_cache()
    return launches


def _qwen2_config_json(mcfg) -> dict:
    """Qwen2's config.json fields, from the preset."""
    return {"architectures": ["Qwen2ForCausalLM"], "model_type": "qwen2",
            "vocab_size": mcfg.vocab_size, "hidden_size": mcfg.hidden_size,
            "intermediate_size": mcfg.intermediate_size,
            "num_hidden_layers": mcfg.num_layers,
            "num_attention_heads": mcfg.num_heads,
            "num_key_value_heads": mcfg.num_kv_heads,
            "max_position_embeddings": mcfg.max_position_embeddings,
            "rope_theta": mcfg.rope_theta, "rms_norm_eps": mcfg.rms_norm_eps,
            "tie_word_embeddings": mcfg.tie_word_embeddings,
            "hidden_act": mcfg.hidden_act, "torch_dtype": mcfg.dtype}


def run_qwen2_from_disk(device, mcfg) -> dict:
    """Qwen2-0.5B at full width: bf16 params from SEED written as HF-named
    [out, in] tensors into two safetensors shards with an index, plus a
    config.json made from the preset (the port's writer), then
    `config_from_hf` (equal to the preset field by field) and
    `load_hf_checkpoint` (every tensor bit-equal to its source); the main
    path from the loaded params counted, timed and profiled, and its greedy
    tokens equal to the in-memory params'. Returns the launches."""
    import os

    from realtime_kv_cache_compression_tpu_torch.models import llama
    from realtime_kv_cache_compression_tpu_torch.models.checkpoint import (
        check_like)
    from realtime_kv_cache_compression_tpu_torch.models.tensor_files import (
        INDEX_NAME, save_tensors)
    from realtime_kv_cache_compression_tpu_torch.models.weights import (
        config_from_hf, hf_tensors, load_hf_checkpoint)

    params = llama.init_params(SEED, mcfg, device)
    tensors = hf_tensors(params, mcfg)
    os.makedirs(QWEN2_DIR, exist_ok=True)
    half = mcfg.num_layers // 2
    shards = {"model-00001-of-00002.safetensors": {},
              "model-00002-of-00002.safetensors": {}}
    first, second = shards
    for name, t in tensors.items():
        later = name == "model.norm.weight" or (
            name.startswith("model.layers.")
            and int(name.split(".")[2]) >= half)
        shards[second if later else first][name] = t
    t0 = time.perf_counter()
    for fn, part in shards.items():
        save_tensors(os.path.join(QWEN2_DIR, fn), part,
                     metadata={"format": "pt"})
    with open(os.path.join(QWEN2_DIR, INDEX_NAME), "w") as f:
        json.dump({"metadata": {"total_size": nbytes(*tensors.values())},
                   "weight_map": {n: fn for fn, part in shards.items()
                                  for n in part}}, f)
    with open(os.path.join(QWEN2_DIR, "config.json"), "w") as f:
        json.dump(_qwen2_config_json(mcfg), f)
    t_write = time.perf_counter() - t0
    got_cfg = config_from_hf(QWEN2_DIR)
    diff = {f.name: (getattr(got_cfg, f.name), getattr(mcfg, f.name))
            for f in dataclasses.fields(mcfg)
            if getattr(got_cfg, f.name) != getattr(mcfg, f.name)}
    check(not diff, f"config_from_hf gives the preset back: {diff}")
    t0 = time.perf_counter()
    loaded = load_hf_checkpoint(QWEN2_DIR, device=device)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    check_like(loaded, params, exact=True)  # raises where unequal
    log(f"qwen2-0.5b from disk: {len(tensors)} tensors, "
        f"{nbytes(*tensors.values()) / 2**20:.1f} MB in 2 shards, written "
        f"{t_write:.1f} s, loaded {t_load:.1f} s; config field for field "
        f"and every tensor bit-equal")
    del tensors
    expect = {key: 0 for key in KERNELS}
    expect.update(K1=mcfg.num_layers,
                  K2=mcfg.num_layers * (NEW_TOKENS - 1))
    run = phase_main("qwen2-0.5b (loaded) main run", device, mcfg,
                     llama.fuse_params(loaded), expect)
    # The same prompt (phase_main's) through the in-memory params.
    p, ccfg = llama.fuse_params(params), run["ccfg"]
    n_new = run["tokens"].shape[1]
    logits, state, _ = llama.prefill_compressed(p, run["ids"], mcfg, ccfg,
                                                max_decode_len=n_new)
    tok = torch.argmax(logits, -1)
    rest, _ = llama.decode_loop(p, tok, state, n_new - 1, mcfg, ccfg)
    toks = torch.cat([tok[:, None], rest], 1).cpu()
    check(torch.equal(toks, run["tokens"]),
          "qwen2: loaded and in-memory tokens equal")
    log(f"qwen2-0.5b: {toks.shape[1]} greedy tokens of the loaded params "
        f"equal the in-memory params'")
    del params, p, state
    phase_profile("qwen2-0.5b", mcfg, run)
    launches = run["launches"]
    del run, loaded
    torch.cuda.empty_cache()
    return launches


def _host_ms(fn, runs: int = 6) -> list:
    """Host milliseconds of `runs - 1` calls of `fn` after a warm-up, each
    between two synchronizes."""
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times[1:]


def phase_chunked_path(device, mcfg) -> dict:
    """The ragged, chunked, long-generation path at full width (run_all
    cuts its depth to TINY_PATH_LAYERS):
    batch 2 with LENGTHS right-padded to PROMPT, `prefill_compressed_chunked`
    in chunks of CHUNK (K1 mode (b)), DECODE_STEPS greedy steps over a
    RING-token ring and a POOL_BLOCKS x POOL_BITS-bit decode pool with 2
    scale groups (K2 with the pool). Counted once (launches and flushes per
    layer held exactly; that run timed), the uncompressed arm with the
    same lengths (one run timed), the bf16 chunked-vs-one-shot reading,
    the flush's cost alone, and a profile whose decode window holds a
    flush."""
    from realtime_kv_cache_compression_tpu_torch.compression import (
        cache_storage_bytes, flush_recent, init_decode_pool,
        init_recent_cache, summarize_layer_stats)
    from realtime_kv_cache_compression_tpu_torch.models import llama

    label = "tinyllama chunked pooled run"
    layers, n = mcfg.num_layers, DECODE_STEPS
    ccfg = _pooled_ccfg(layers)
    params = llama.fuse_params(llama.init_params(SEED, mcfg, device))
    gen = torch.Generator(device=device).manual_seed(SEED + 10)
    b = len(LENGTHS)
    ids = torch.randint(0, mcfg.vocab_size, (b, PROMPT), generator=gen,
                        device=device)
    lengths = torch.tensor(LENGTHS, device=device)
    prefill = lambda: llama.prefill_compressed_chunked(  # noqa: E731
        params, ids, mcfg, ccfg, chunk_size=CHUNK, max_decode_len=RING,
        lengths=lengths)

    flushes = {}

    def counting_flush(recent, pool, *args):
        flushes[id(pool)] = flushes.get(id(pool), 0) + 1
        return flush_recent(recent, pool, *args)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    llama.flush_recent = counting_flush
    try:
        (logits, state, stats), ttft = cuda_ms(prefill)
        (toks, state), dec_ms = cuda_ms(lambda: llama.decode_loop(
            params, torch.argmax(logits, -1), state, n, mcfg, ccfg))
    finally:
        llama.flush_recent = flush_recent
    launches = _launches()
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    expect = {key: 0 for key in KERNELS}
    expect.update(K1b=layers * PROMPT // CHUNK, K2=layers * n)
    per_layer = [flushes.get(id(p), 0) for p in state.pools]
    log(f"{label} launches: {launches} (expect {expect}); flushes per "
        f"layer {per_layer} (expect {(n - 1) // RING})")
    check(launches == expect, f"{label}: launches per kernel")
    check(per_layer == [(n - 1) // RING] * layers, f"{label}: flushes")
    check(all(bool(p.valid.all()) and int(p.write_block[0])
              == ((n - 1) // RING) % POOL_BLOCKS for p in state.pools),
          f"{label}: every pool wrapped")
    check(toks.shape == (b, n) and bool(torch.isfinite(logits).all()),
          f"{label}: output shape and finite logits")
    summary = summarize_layer_stats(stats)
    check(0.0 < summary["avg_compression_ratio"] < 1.0,
          "kept ratio in (0, 1)")
    stored = sum(cache_storage_bytes(c) + pool_bytes(p)
                 + nbytes(r.k, r.v, r.positions, r.length)
                 for c, p, r in zip(state.caches, state.pools,
                                    state.recents))
    dense = (layers * 2 * (sum(LENGTHS) + b * n) * mcfg.num_kv_heads
             * mcfg.head_dim * 2)
    log(f"{label}: kept_ratio {summary['avg_compression_ratio']:.4f}, "
        f"byte_savings (prefill tiers) {summary['avg_memory_savings']:.4f}; "
        f"after {n} steps tiers + pools + rings hold {stored / 2**20:.3f} "
        f"MB against {dense / 2**20:.3f} MB of bf16 K/V for the "
        f"{sum(LENGTHS) + b * n} tokens (savings {1 - stored / dense:.4f}); "
        f"peak memory {peak_mb:.1f} MB")

    log(f"{label} (compressed), the counted run timed: chunked-prefill "
        f"TTFT ms {ttft:.3f}; decode tok/s (both rows) "
        f"{b * n / (dec_ms / 1e3):.3f}")

    pad = lambda a: torch.nn.functional.pad(  # noqa: E731
        a, (0, 0, 0, 0, 0, BASELINE_STEPS))
    ttft_u, rate_u = _uncompressed_run(params, ids, mcfg,
                                       lengths.to(torch.int32), pad,
                                       BASELINE_STEPS, lengths=lengths)
    log(f"{label} (uncompressed arm, same lengths), one run timed: TTFT ms "
        f"{ttft_u:.3f}; decode tok/s (both rows) {rate_u:.3f} over "
        f"{BASELINE_STEPS} steps")

    # Reading, not a check: bf16 chunked vs one-shot kept positions.
    _, chunked, _ = prefill()
    _, one_shot, _ = llama.prefill_compressed(
        params, ids, mcfg, ccfg, max_decode_len=RING, lengths=lengths)
    differ = [li for li, (a, c) in enumerate(zip(chunked.caches,
                                                 one_shot.caches))
              if any(not torch.equal(ta.positions, tc.positions)
                     for ta, tc in zip(a.tiers, c.tiers))]
    log(f"{label}: bf16 chunked vs one-shot prefill, layers whose kept "
        f"positions differ: {len(differ)} of {layers} {differ}")
    del chunked, one_shot

    # The flush alone: one layer's full ring into its pool.
    recent = init_recent_cache(b, RING, mcfg, device=device)
    recent.k.normal_(generator=gen)
    recent.v.normal_(generator=gen)
    pool = init_decode_pool(b, RING, ccfg, mcfg, device=device)

    def one_flush():
        recent.length.fill_(RING)
        flush_recent(recent, pool, ccfg, mcfg)

    times = _host_ms(one_flush)
    med = sorted(times)[len(times) // 2]
    log(f"flush_recent alone, one layer (B={b}, ring {RING}, "
        f"{POOL_BITS}-bit, G=2): host ms {_spread(times)}; per decode step "
        f"over {layers} layers, one flush every {RING} steps: "
        f"{med * layers / RING:.3f} ms")

    logits, state, _ = prefill()
    tok = torch.argmax(logits, -1)
    _profile_window("tinyllama chunked", "chunked prefill", prefill)
    toks, state = llama.decode_loop(params, tok, state, RING - 4, mcfg, ccfg)
    _profile_window("tinyllama chunked",
                    "decode 10 steps (a flush at the 5th)",
                    lambda: llama.decode_loop(params, toks[:, -1], state, 10,
                                              mcfg, ccfg))
    del params, state
    torch.cuda.empty_cache()
    return launches


def _kept_and_stored(caches, layers: int, b: int, s: int, mcfg):
    """(kept ratio from the tiers' `valid`, stored tier bytes, dense bf16
    K/V bytes of the same b x s tokens)."""
    from realtime_kv_cache_compression_tpu_torch.compression import (
        cache_storage_bytes)

    kept = sum(int(t.valid.sum()) for c in caches for t in c.tiers)
    stored = sum(cache_storage_bytes(c) for c in caches)
    dense = layers * 2 * b * s * mcfg.num_kv_heads * mcfg.head_dim * 2
    return kept / (layers * b * s), stored, dense


def phase_prefix_path(device, mcfg, repeats: int = REPEATS_NEW) -> dict:
    """The compressed-prefix chunked path at full width (run_all cuts its
    depth to TINY_PATH_LAYERS):
    PREFIX_BATCH uniform rows of PROMPT tokens, `prefill_compressed_prefix_
    chunked` in chunks of CHUNK (K1 mode (d) over the pools plus the
    diagonal pair, merged), NEW_TOKENS - 1 greedy steps through K2 over the
    chunk-packed tiers, no decode pool. Counted once (launches held
    exactly), K2 held against its plain version on that state's first and
    last layers, then timed `repeats` times in turns with the full-buffer
    `prefill_compressed_chunked` at the same shape (TTFT, decode rate, kept
    ratio from the tiers' `valid`, stored bytes, peak memory of each), and
    a profile with `compress_layer_kv`'s host time per chunk and layer."""
    from realtime_kv_cache_compression_tpu_torch import CompressionConfig
    from realtime_kv_cache_compression_tpu_torch.compression import (
        compress_layer_kv)
    from realtime_kv_cache_compression_tpu_torch.models import llama
    from realtime_kv_cache_compression_tpu_torch.ops.cuda.decode_attention \
        import decode_attention_plain, fused_decode_attention

    label = "tinyllama compressed-prefix run"
    layers, n = mcfg.num_layers, NEW_TOKENS - 1
    b = PREFIX_BATCH
    ccfg = CompressionConfig(num_layers=layers)  # tiers 8/4/2
    params = llama.fuse_params(llama.init_params(SEED, mcfg, device))
    gen = torch.Generator(device=device).manual_seed(SEED + 11)
    ids = torch.randint(0, mcfg.vocab_size, (b, PROMPT), generator=gen,
                        device=device)
    forms = {
        "prefix": lambda: llama.prefill_compressed_prefix_chunked(  # noqa
            params, ids, mcfg, ccfg, chunk_size=CHUNK,
            max_decode_len=NEW_TOKENS),
        "full-buffer": lambda: llama.prefill_compressed_chunked(  # noqa
            params, ids, mcfg, ccfg, chunk_size=CHUNK,
            max_decode_len=NEW_TOKENS),
    }
    readings = {}
    for form, prefill in forms.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        logits, state, _ = prefill()
        toks, state = llama.decode_loop(params, torch.argmax(logits, -1),
                                        state, n, mcfg, ccfg)
        torch.cuda.synchronize()
        launches = _launches()
        peak_mb = torch.cuda.max_memory_allocated() / 2**20
        check(toks.shape == (b, n) and bool(torch.isfinite(logits).all()),
              f"{label} ({form}): output shape and finite logits")
        kept, stored, dense = _kept_and_stored(state.caches, layers, b,
                                               PROMPT, mcfg)
        check(0.0 < kept < 1.0, f"{form}: kept ratio in (0, 1)")
        readings[form] = {"launches": launches, "kept_ratio": kept,
                          "stored_mb": stored / 2**20, "peak_mb": peak_mb,
                          "ttft_ms": [], "tok_s": []}
        log(f"{label} ({form} prefill): launches {launches}; kept_ratio "
            f"{kept:.4f}; tiers hold {stored / 2**20:.3f} MB against "
            f"{dense / 2**20:.3f} MB of dense bf16 K/V (savings "
            f"{1 - stored / dense:.4f}); peak memory {peak_mb:.1f} MB")
        expect = {key: 0 for key in KERNELS}
        expect.update({"K1d": layers * PROMPT // CHUNK,
                       "K1p": layers * PROMPT // CHUNK} if form == "prefix"
                      else {"K1b": layers * PROMPT // CHUNK}, K2=layers * n)
        log(f"{label} ({form}) launches: expect {expect}")
        check(launches == expect, f"{label} ({form}): launches per kernel")
        if form == "prefix":
            # K2 over the chunk-packed tiers at the full shape.
            q = torch.randn((b, 1, mcfg.num_heads, mcfg.head_dim),
                            generator=gen, device=device).bfloat16()
            q_pos = state.position[:, None]
            for li in (0, layers - 1):
                cache, recent = state.caches[li], state.recents[li]
                check_close(
                    fused_decode_attention(q, cache, recent, q_pos, ccfg),
                    decode_attention_plain(q, cache, recent, q_pos, ccfg),
                    TOL_K2_F32, f"K2 over the chunk-packed tiers, layer {li} "
                                f"(tier chunks {[t.chunk for t in cache.tiers]}"
                                f", capacities "
                                f"{[t.capacity for t in cache.tiers]})")
        del logits, state, toks

    for _ in range(repeats):
        for form, prefill in forms.items():
            (logits, state, _), ms = cuda_ms(prefill)
            tok = torch.argmax(logits, -1)
            _, dec_ms = cuda_ms(lambda: llama.decode_loop(
                params, tok, state, n, mcfg, ccfg))
            readings[form]["ttft_ms"].append(ms)
            readings[form]["tok_s"].append(b * n / (dec_ms / 1e3))
            del logits, state
    for form, r in readings.items():
        log(f"{label} ({form} prefill, B={b} x {PROMPT}, chunks of {CHUNK}),"
            f" {repeats} timed runs: TTFT ms {_spread(r['ttft_ms'])}; decode "
            f"tok/s (both rows) {_spread(r['tok_s'])}")

    prefill = forms["prefix"]
    logits, state, _ = prefill()
    tok = torch.argmax(logits, -1)
    _profile_window("tinyllama prefix", "compressed-prefix prefill", prefill)
    _profile_window("tinyllama prefix", "decode 10 steps",
                    lambda: llama.decode_loop(params, tok, state, 10, mcfg,
                                              ccfg))
    hkv, d = mcfg.num_kv_heads, mcfg.head_dim
    k, v = (torch.randn((b, CHUNK, hkv, d), generator=gen, device=device)
            .bfloat16() for _ in range(2))
    mass = torch.rand((b, CHUNK), generator=gen, device=device)
    mm = (mass.amin(-1, keepdim=True), mass.amax(-1, keepdim=True))
    times = _host_ms(lambda: compress_layer_kv(
        k, v, mass, 0, ccfg, mcfg, shard_offset=3 * CHUNK, total_len=PROMPT,
        minmax=mm))
    log(f"compress_layer_kv alone (tinyllama prefix), one chunk of {CHUNK} "
        f"and one layer, B={b}: host ms {_spread(times)}")
    del params, state
    torch.cuda.empty_cache()
    return readings["prefix"]["launches"]


def _counted_run(label: str, prefill, decode, expect: dict):
    """One prefill and decode with every launch count set to 0 just before
    and read just after, held to `expect`; returns (logits, prefill stats,
    tokens, launches, peak MB, the prefill's kept positions, the decode's
    ms by CUDA events)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    logits, state, stats = prefill()
    (toks, state), dec_ms = cuda_ms(lambda: decode(logits, state))
    launches = _launches()
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    log(f"{label} launches: {launches} (expect {expect})")
    check(launches == expect, f"{label}: launches per kernel")
    check(bool(torch.isfinite(logits).all()), f"{label}: finite logits")
    return (logits, stats, toks, launches, peak_mb,
            _kept_positions(state.caches), dec_ms)


def phase_query_path(device, mcfg, repeats: int = REPEATS_NEW) -> dict:
    """Query-guided importance at full width (run_all cuts its depth to
    TINY_PATH_LAYERS), beside the
    prompt-scored arm: `importance_source` "prompt", "query" and "both"
    (window automatic, W = 256 at T = PROMPT; pool QUERY_POOL), on the
    one-shot path (prompt PROMPT, batch 1, NEW_TOKENS - 1 greedy steps;
    K1 mode (a), K2) and the chunked path (batch 2 with LENGTHS
    right-padded to PROMPT, chunks of CHUNK; K1 mode (b), K2). Each arm is
    counted once (launches held exactly; kept ratio, byte savings, peak
    memory), then timed `repeats` times with the arms in turns (TTFT, and
    on the one-shot path decode tok/s; the chunked form's decode tok/s is
    its counted run's); the query mass alone is timed per layer on the
    host clock after a sync; a profile of the query-scored one-shot
    prefill. Returns the launches per path."""
    from realtime_kv_cache_compression_tpu_torch.compression import (
        summarize_layer_stats)
    from realtime_kv_cache_compression_tpu_torch.models import llama
    from realtime_kv_cache_compression_tpu_torch.ops.attention import (
        query_attention_mass, window_attention_mass)

    layers, n = mcfg.num_layers, NEW_TOKENS - 1
    params = llama.fuse_params(llama.init_params(SEED, mcfg, device))
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    ids1 = torch.randint(0, mcfg.vocab_size, (1, PROMPT), generator=gen,
                         device=device)
    gen = torch.Generator(device=device).manual_seed(SEED + 10)
    ids2 = torch.randint(0, mcfg.vocab_size, (len(LENGTHS), PROMPT),
                         generator=gen, device=device)
    lengths = torch.tensor(LENGTHS, device=device)
    forms = {
        "one-shot": (ids1, dict(), {"K1": layers}),
        "chunked": (ids2, dict(lengths=lengths),
                    {"K1b": layers * PROMPT // CHUNK}),
    }
    launches = {}
    for form, (ids, kw, k1) in forms.items():
        b = ids.shape[0]
        arms = {}
        for source in QUERY_SOURCES:
            ccfg = _query_ccfg(layers, source)
            if form == "one-shot":
                prefill = (lambda c=ccfg: llama.prefill_compressed(
                    params, ids, mcfg, c, max_decode_len=NEW_TOKENS))
            else:
                prefill = (lambda c=ccfg: llama.prefill_compressed_chunked(
                    params, ids, mcfg, c, chunk_size=CHUNK,
                    max_decode_len=NEW_TOKENS, **kw))
            decode = (lambda lo, st, c=ccfg: llama.decode_loop(
                params, torch.argmax(lo, -1), st, n, mcfg, c))
            label = f"tinyllama {source} {form}"
            expect = {key: 0 for key in KERNELS}
            expect.update(k1, K2=layers * n)
            logits, stats, toks, counted, peak, kept, dec_ms = _counted_run(
                label, prefill, decode, expect)
            check(toks.shape == (b, n), f"{label}: output shape")
            if source == "prompt":
                kept_prompt = kept
            else:
                shared = sum(len(set(x) & set(y)) for lx, ly in zip(
                    kept, kept_prompt) for tx, ty in zip(lx, ly)
                    for x, y in zip(tx, ty))
                total = sum(len(x) for lx in kept for tx in lx for x in tx)
                log(f"{label}: {shared / total:.4f} of the kept (position, "
                    f"tier) pairs are the prompt-scored arm's")
            summary = summarize_layer_stats(stats)
            check(0.0 < summary["avg_compression_ratio"] < 1.0,
                  f"{label}: kept ratio in (0, 1)")
            if source != "prompt":
                suffix = "" if form == "one-shot" else "_chunked"
                launches[f"tinyllama_{source}{suffix}"] = counted
            arms[source] = dict(prefill=prefill, decode=decode, ttft=[],
                                rate=[b * n / (dec_ms / 1e3)],
                                summary=summary, peak=peak)
        # The arms in turns, the order reversed each time. The chunked
        # form times its prefill only: its decode tok/s is the counted
        # run's (one reading), which keeps the script near half its limit.
        timed_decode = form == "one-shot"
        for i in range(repeats):
            order = QUERY_SOURCES if i % 2 == 0 else QUERY_SOURCES[::-1]
            for source in order:
                arm = arms[source]
                (logits, state, _), ms = cuda_ms(arm["prefill"])
                arm["ttft"].append(ms)
                if timed_decode:
                    _, dec_ms = cuda_ms(lambda: arm["decode"](logits, state))
                    arm["rate"].append(b * n / (dec_ms / 1e3))
                del state
        for source in QUERY_SOURCES:
            arm = arms[source]
            rates = arm["rate"][1:] if timed_decode else arm["rate"]
            log(f"tinyllama {source} {form} (B={b}): TTFT ms "
                f"{_spread(arm['ttft'])}; decode tok/s (all rows"
                f"{'' if timed_decode else ', the counted run'}) "
                f"{_spread(rates)}; kept_ratio "
                f"{arm['summary']['avg_compression_ratio']:.4f}, "
                f"byte_savings {arm['summary']['avg_memory_savings']:.4f}, "
                f"peak memory {arm['peak']:.1f} MB")
        del arms

    # The query mass alone, one layer, on each form's shapes.
    w = _query_ccfg(layers, "query").query_window_for(PROMPT)
    dt = llama.model_dtype(mcfg)
    hq, hkv, d = mcfg.num_heads, mcfg.num_kv_heads, mcfg.head_dim
    q = torch.randn((1, PROMPT, hq, d), generator=gen, device=device).to(dt)
    k = torch.randn((1, PROMPT, hkv, d), generator=gen, device=device).to(dt)
    one = _host_ms(lambda: query_attention_mass(q, k, w, pool=QUERY_POOL))
    b = len(LENGTHS)
    tails = torch.randn((b, w, hq, d), generator=gen, device=device).to(dt)
    k_buf = torch.randn((b, PROMPT, hkv, d), generator=gen,
                        device=device).to(dt)
    tail_pos = llama._tail_positions(b, w, PROMPT, lengths, device)
    key_ok = torch.arange(PROMPT, device=device)[None] < lengths[:, None]
    fin = _host_ms(lambda: window_attention_mass(
        tails, tail_pos.clamp(min=0), tail_pos >= 0, k_buf, key_ok,
        pool=QUERY_POOL))
    log(f"query mass alone, one layer, W={w}, pool {QUERY_POOL}: one-shot "
        f"(B=1, S={PROMPT}) host ms {_spread(one)}; chunked finish (B={b}) "
        f"host ms {_spread(fin)}; per prefill over {layers} layers "
        f"{sorted(one)[len(one) // 2] * layers:.3f} / "
        f"{sorted(fin)[len(fin) // 2] * layers:.3f} ms")
    del q, k, tails, k_buf

    ccfg = _query_ccfg(layers, "query")
    _profile_window("tinyllama query", "one-shot prefill",
                    lambda: llama.prefill_compressed(
                        params, ids1, mcfg, ccfg, max_decode_len=NEW_TOKENS))
    del params
    torch.cuda.empty_cache()
    return launches


def phase_exact_greedy(device, s: int = PROMPT, layer: int = 1) -> None:
    """`select_tokens` with selection_mode "exact_greedy" (a sequential
    scan, one step per sorted column) against the default "topk_prefix" on
    one layer's scores at S=`s`, B=1, host ms after a sync (the first call
    of each is the warm-up)."""
    from realtime_kv_cache_compression_tpu_torch import CompressionConfig
    from realtime_kv_cache_compression_tpu_torch.ops.importance import (
        importance_scores)
    from realtime_kv_cache_compression_tpu_torch.ops.quantization import (
        assign_precision)
    from realtime_kv_cache_compression_tpu_torch.ops.selection import (
        select_tokens)

    gen = torch.Generator(device=device).manual_seed(SEED + 21)
    mass = torch.rand((1, s), generator=gen, device=device)
    times, kept = {}, {}
    for mode in ("topk_prefix", "exact_greedy"):
        ccfg = CompressionConfig(num_layers=22, selection_mode=mode)
        scores = importance_scores(mass, layer, s, ccfg.prompt_length(s),
                                   ccfg)
        labels, _ = assign_precision(scores, ccfg)
        times[mode] = _host_ms(
            lambda: select_tokens(scores, labels, layer, ccfg), runs=4)
        kept[mode] = int(select_tokens(scores, labels, layer,
                                       ccfg).kept_mask.sum())
    log(f"select_tokens, one layer, B=1, S={s}: topk_prefix host ms "
        f"{_spread(times['topk_prefix'])}; exact_greedy host ms "
        f"{_spread(times['exact_greedy'])}; kept {kept}")


def phase_sampled(label: str, device, mcfg, main_run) -> dict:
    """The sampled decode on the main run's prefill (its params, prompt and
    compression): SAMPLING for NEW_TOKENS - 1 steps through K2, counted
    (launches held exactly; the returned counts a bincount of the first and
    emitted tokens; every logprob finite and <= 0); top_k 1 at the same
    temperature, no penalty, against greedy (equal tokens up to an exact
    tie of two logits); greedy `decode_loop` against `decode_step` +
    argmax (equal tokens); the counted sampled decode's tok/s (CUDA
    events) beside the main run's counted greedy decode; a profile of 10
    sampled steps. Returns the sampled run's launches."""
    from realtime_kv_cache_compression_tpu_torch.models import llama
    from realtime_kv_cache_compression_tpu_torch.ops.sampling import (
        SamplingParams)

    params, ids, ccfg = main_run["params"], main_run["ids"], main_run["ccfg"]
    layers, n = mcfg.num_layers, NEW_TOKENS - 1
    sampling = SamplingParams(**SAMPLING)
    gen = torch.Generator(device=device).manual_seed(SEED + 20)
    prefill = lambda: llama.prefill_compressed(  # noqa: E731
        params, ids, mcfg, ccfg, max_decode_len=NEW_TOKENS)

    def sampled(logits, state, sp=sampling, **kw):
        return llama.decode_loop(params, torch.argmax(logits, -1), state, n,
                                 mcfg, ccfg, generator=gen, sampling=sp, **kw)

    out = {}

    def counted_decode(logits, state):
        out["first"] = torch.argmax(logits, -1)
        toks, state, out["counts"], out["lps"] = sampled(
            logits, state, return_counts=True, return_logprobs=True)
        return toks, state

    expect = {key: 0 for key in KERNELS}
    expect.update(K1=layers, K2=layers * n)
    counted = _counted_run(f"{label} sampled", prefill, counted_decode,
                           expect)
    toks, launches, sampled_ms = counted[2], counted[3], counted[6]
    emitted = torch.cat([out["first"][:, None], toks], 1)
    bincount = torch.stack([torch.bincount(row, minlength=mcfg.vocab_size)
                            for row in emitted]).to(torch.int32)
    lps = out["lps"]
    log(f"{label} sampled {SAMPLING}: tokens {toks[0, :16].tolist()}...; "
        f"distinct {int(emitted.unique().numel())} of {n + 1}; logprobs "
        f"min {float(lps.min()):.3f} max {float(lps.max()):.3f}")
    check(torch.equal(out["counts"], bincount),
          f"{label}: counts equal a bincount of the first and emitted tokens")
    check(bool(torch.isfinite(lps).all()) and bool((lps <= 0).all()),
          f"{label}: logprobs finite and <= 0")

    # top_k 1 without penalties is greedy, except where two logits tie
    # exactly (bf16 logits; top-k keeps every tied maximum, as the
    # reference's does): up to the first differing step both runs saw the
    # same logits, so the two tokens there must have equal logprobs.
    logits, state, _ = prefill()
    greedy, _, lp_greedy = llama.decode_loop(
        params, torch.argmax(logits, -1), state, n, mcfg, ccfg,
        return_logprobs=True)
    logits, state, _ = prefill()
    top1, _, lp_top1 = sampled(
        logits, state, SamplingParams(temperature=SAMPLING["temperature"],
                                      top_k=1), return_logprobs=True)
    differ = (top1 != greedy)[0].nonzero()
    first = int(differ[0]) if len(differ) else None
    tie = first is not None and bool(lp_top1[0, first] == lp_greedy[0, first])
    log(f"{label}: top_k 1 at temperature {SAMPLING['temperature']} vs "
        f"greedy, tokens equal {first is None}"
        + ("" if first is None else f"; first differing step {first}, "
           f"logprobs {float(lp_top1[0, first])} / "
           f"{float(lp_greedy[0, first])} (an exact tie: {tie})"))
    check(first is None or tie, f"{label}: top_k 1 gives greedy tokens up "
                                f"to an exact tie")
    # Greedy `decode_loop` against the loop it was before sampling came:
    # `decode_step`, then argmax, n times.
    logits, state, _ = prefill()
    tok, manual = torch.argmax(logits, -1), []
    for _ in range(n):
        step_logits, state = llama.decode_step(params, tok, state, mcfg, ccfg)
        tok = torch.argmax(step_logits, -1)
        manual.append(tok)
    check(torch.equal(torch.stack(manual, 1), greedy),
          f"{label}: greedy decode_loop equals decode_step + argmax")

    log(f"{label} decode tok/s, the counted runs timed: greedy "
        f"{main_run['decode_tok_s']:.3f} (the main run); sampled "
        f"{n / (sampled_ms / 1e3):.3f}")
    logits, state, _ = prefill()
    _profile_window(label, "sampled decode 10 steps",
                    lambda: llama.decode_loop(
                        params, torch.argmax(logits, -1), state, 10, mcfg,
                        ccfg, generator=gen, sampling=sampling))
    return launches


def phase_parity_beam(device, mcfg, prompt: int = 1024,
                      new_tokens: int = 16) -> None:
    """Beam search in float32 at reduced depth (full width), B=1,
    W=BEAM_WIDTH, without EOS and with an EOS the model emits (the best
    first token: its beam freezes at step 0 and survives): the kernel path
    (K1, K2 at B·W rows) against the plain path on the card, every beam's
    sequence equal and its score within TOL_SCORE_REL."""
    from realtime_kv_cache_compression_tpu_torch import CompressionConfig
    from realtime_kv_cache_compression_tpu_torch.models import (beam_search,
                                                                llama)

    mcfg = dataclasses.replace(mcfg, dtype="float32")
    ccfg = CompressionConfig(num_layers=mcfg.num_layers)
    params = llama.init_params(SEED, mcfg, device)
    gen = torch.Generator(device=device).manual_seed(SEED + 30)
    ids = torch.randint(0, mcfg.vocab_size, (1, prompt), generator=gen,
                        device=device)
    eos = None
    for what in ("no EOS", "EOS"):
        runs = [beam_search.beam_search(
            params, ids, mcfg, ccfg, num_beams=BEAM_WIDTH,
            max_new_tokens=new_tokens, eos_token_id=eos, use_flash=kernels,
            use_fused_decode=kernels, return_all_beams=True)[:2]
            for kernels in (True, False)]
        (seq_k, score_k), (seq_p, score_p) = runs
        rel = float(((score_k - score_p).abs() / score_p.abs()).max())
        log(f"beam parity f32 ({what}{'' if eos is None else f' {eos}'}, "
            f"W={BEAM_WIDTH}, {new_tokens} tokens, {mcfg.num_layers} layers, "
            f"prompt {prompt}): best beam {seq_k[0, 0].tolist()}; scores "
            f"kernel {score_k[0].tolist()} plain {score_p[0].tolist()}, max "
            f"rel err {rel:.3e}")
        check(torch.equal(seq_k, seq_p), f"beam ({what}): sequences of the "
                                         f"kernel and plain paths")
        check(rel <= TOL_SCORE_REL, f"beam ({what}): scores within "
                                    f"{TOL_SCORE_REL}")
        eos = int(seq_k[0, 0, 0])
    check(eos in seq_k[0, :, 0].tolist(), "beam: the EOS beam survives")


def _spec_proposers(ref: torch.Tensor, n_steps: int, vocab: int):
    """An oracle proposer (the reference tokens at the count) and an
    adversarial one (the last token + 1), as proposer(last2, count, out)."""
    def oracle(last2, count, out):
        cols = count[:, None] + torch.arange(N_DRAFT, device=ref.device)[None]
        return torch.gather(ref, 1, cols.clamp(max=n_steps - 1))

    def adversarial(last2, count, out):
        return ((last2[:, 1:2] + 1) % vocab).expand(-1, N_DRAFT)

    return oracle, adversarial


def phase_parity_speculative(device, mcfg, prompt: int = 1024,
                             n_steps: int = 40, pooled_steps: int = 150,
                             suffix: int = 64) -> None:
    """Speculative decoding in float32 at reduced depth (full width), B=1:
    `decode_loop` through K2 against `speculative_decode_loop` with prompt
    lookup and with an oracle proposer (the reference tokens), and
    `adaptive_speculative_decode` with an adversarial one: equal tokens,
    positions, ring fills and ring lengths; the oracle in ceil(n_steps /
    (N_DRAFT + 1)) forwards. Again over a RING-token ring and a
    POOL_BLOCKS-block POOL_BITS-bit pool for `pooled_steps` steps (two
    flushes): the pools' validity, positions and write blocks equal too.
    Then `extend_prefill` of a `suffix`-token suffix against teacher-forced
    plain `decode_step`s over it: last logits within TOL_LOGITS, ring
    positions and lengths equal, ring values within TOL_LOGITS, and the
    input state's tensors unchanged, byte for byte."""
    from realtime_kv_cache_compression_tpu_torch import CompressionConfig
    from realtime_kv_cache_compression_tpu_torch.models import (llama,
                                                                speculative)

    mcfg = dataclasses.replace(mcfg, dtype="float32")
    layers = mcfg.num_layers
    params = llama.init_params(SEED, mcfg, device)
    gen = torch.Generator(device=device).manual_seed(SEED + 31)
    ids = torch.randint(0, mcfg.vocab_size, (1, prompt), generator=gen,
                        device=device)

    def arms(ccfg, steps, ring, what):
        logits, state, _ = llama.prefill_compressed(
            params, ids, mcfg, ccfg, max_decode_len=ring)
        first = torch.argmax(logits, -1)
        copy = llama.clone_decode_state
        ref, ref_state = llama.decode_loop(params, first, copy(state), steps,
                                           mcfg, ccfg)
        oracle, adversarial = _spec_proposers(ref, steps, mcfg.vocab_size)
        out = {
            "lookup": speculative.speculative_decode_loop(
                params, first, copy(state), steps, mcfg, ccfg, ids,
                n_draft=N_DRAFT),
            "oracle": speculative.speculative_decode_loop(
                params, first, copy(state), steps, mcfg, ccfg, ids,
                n_draft=N_DRAFT, proposer=oracle),
            "adaptive": speculative.adaptive_speculative_decode(
                params, first, copy(state), steps, mcfg, ccfg, ids,
                n_draft=N_DRAFT, chunk=SPEC_CHUNK, proposer=adversarial)}
        for name, (toks, st, stats) in out.items():
            shown = {k: v for k, v in stats.items() if k != "arms"}
            log(f"speculative parity f32 ({what}, {name}, {steps} steps, "
                f"{layers} layers, prompt {prompt}): tokens equal "
                f"{torch.equal(toks, ref)}, {shown}")
            check(torch.equal(toks, ref), f"speculative ({what}, {name}): "
                                          f"tokens of decode_loop")
            check(torch.equal(st.position, ref_state.position)
                  and st.ring_fill == ref_state.ring_fill
                  and all(torch.equal(a.length, b.length) for a, b in zip(
                      st.recents, ref_state.recents)),
                  f"speculative ({what}, {name}): positions and rings")
            for a, b in zip(st.pools, ref_state.pools):
                check(a is None or all(torch.equal(getattr(a, f),
                                                   getattr(b, f))
                                       for f in ("valid", "positions",
                                                 "write_block")),
                      f"speculative ({what}, {name}): pool validity, "
                      f"positions and write blocks")
        return out

    out = arms(CompressionConfig(num_layers=layers), n_steps,
               n_steps + N_DRAFT + 1, "tiers + ring")
    iters = out["oracle"][2]["iterations"]
    check(iters == -(-n_steps // (N_DRAFT + 1)),
          f"speculative: the oracle's {iters} forwards")
    pooled = CompressionConfig(num_layers=layers,
                               decode_pool_blocks=POOL_BLOCKS,
                               decode_pool_bits=POOL_BITS)
    out = arms(pooled, pooled_steps, RING, f"ring {RING}, pool "
               f"{POOL_BLOCKS} x {POOL_BITS}-bit")
    check(bool(out["lookup"][1].pools[0].valid[:, :2 * RING].all()),
          "speculative: two ring flushes into the pool")

    ccfg = CompressionConfig(num_layers=layers)
    _, state, _ = llama.prefill_compressed(params, ids, mcfg, ccfg,
                                           max_decode_len=2 * suffix)
    tokens = torch.randint(0, mcfg.vocab_size, (1, suffix), generator=gen,
                           device=device)
    before = [t.clone() for t in llama.decode_state_tensors(state)]
    last, ext = speculative.extend_prefill(
        params, state, tokens, torch.full((1,), suffix, device=device), mcfg,
        ccfg)
    unchanged = all(torch.equal(a, b) for a, b in zip(
        before, llama.decode_state_tensors(state), strict=True))
    st = llama.clone_decode_state(state)
    for i in range(suffix):
        step_logits, st = llama.decode_step(params, tokens[:, i], st, mcfg,
                                            ccfg, use_fused=False)
    ring_err = max(max_err(getattr(a, f), getattr(b, f))
                   for a, b in zip(ext.recents, st.recents)
                   for f in ("k", "v"))
    log(f"extend_prefill f32 ({suffix} tokens over prompt {prompt}): last "
        f"logits vs teacher-forced decode_step max err "
        f"{max_err(last, step_logits):.3e}, ring values max err "
        f"{ring_err:.3e}; input state unchanged {unchanged}")
    check(unchanged, "extend_prefill: the input state's tensors unchanged")
    check_close(last, step_logits, TOL_LOGITS,
                "extend_prefill vs teacher-forced decode_step: last logits")
    check(ring_err <= TOL_LOGITS and ext.ring_fill == st.ring_fill
          and all(torch.equal(a.positions, b.positions)
                  and torch.equal(a.length, b.length)
                  for a, b in zip(ext.recents, st.recents))
          and torch.equal(ext.position, st.position),
          "extend_prefill: rings and positions of the decode steps")


def _zero_counts() -> None:
    for key in KERNELS:
        setattr(wrapper(key), _counter(key), 0)
        if KERNELS[key][0] == "flash_prefill":
            _init_counts(wrapper(key))


def _init_counts(fn) -> None:
    """A K1 wrapper's (or a stand-in's) counters at zero: its launches,
    and its launches by tile and by variant."""
    fn.launches = 0
    fn.tile_launches = {}
    fn.variant_launches = {}


def _add_counts(into, fn) -> None:
    """Adds a K1 stand-in's counts to the wrapper's."""
    into.launches += fn.launches
    for name in ("tile_launches", "variant_launches"):
        counts = getattr(into, name)
        for key, n in getattr(fn, name).items():
            counts[key] = counts.get(key, 0) + n


def phase_beam_path(label: str, device, mcfg, main_run) -> dict:
    """Beam search at full width and depth on the main run's params and
    prompt (PROMPT, B=1): README's call, W=BEAM_WIDTH, BEAM_NEW_TOKENS new
    tokens, eos_token_id BEAM_EOS. Counted once (K1 once per layer for the
    one prefill at B rows, K2 once per layer and step at B·W rows; peak
    memory); `num_beams=1` against `generate` (equal tokens: same kernels,
    same shapes); the counted beam and greedy `generate` calls timed (ms
    per generated token; TTFT as the call with one new token); K2 at this
    path's shape: the B·W-row state after
    BEAM_K2_STEPS beam steps, each with its gather, every layer against
    the plain version on the same q, tiers and ring (bf16 limit as in
    phase_k2); the reindexing of the rings and positions alone and the
    top-W sort per step; a profile of 10 beam steps. Returns the launches
    per path and K2's worst error at the beam shape."""
    from realtime_kv_cache_compression_tpu_torch.models import (beam_search,
                                                                llama)
    from realtime_kv_cache_compression_tpu_torch.ops.cuda.decode_attention \
        import decode_attention_plain, fused_decode_attention

    params, ids, ccfg = main_run["params"], main_run["ids"], main_run["ccfg"]
    layers, n, w = mcfg.num_layers, BEAM_NEW_TOKENS, BEAM_WIDTH

    def beam(tokens=n, width=w):
        return beam_search.beam_search(params, ids, mcfg, ccfg,
                                       num_beams=width, max_new_tokens=tokens,
                                       eos_token_id=BEAM_EOS)

    def greedy(tokens=n):
        return llama.generate(params, ids, mcfg, ccfg, max_new_tokens=tokens,
                              eos_token_id=BEAM_EOS)

    peaks, ms, ttft = {}, {}, {}
    for arm, fn in (("greedy", greedy), ("beam", beam)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        out, ms[arm] = cuda_ms(fn)
        peaks[arm] = torch.cuda.max_memory_allocated() / 2**20
    seqs, scores, _ = out
    launches = _launches()
    expect = {key: 0 for key in KERNELS}
    expect.update(K1=layers, K2=layers * (n - 1))
    log(f"{label} beam launches: {launches} (expect {expect}); best beam "
        f"{seqs[0, :16].tolist()}..., score {float(scores[0]):.4f}; peak "
        f"memory beam {peaks['beam']:.1f} MB, greedy generate "
        f"{peaks['greedy']:.1f} MB")
    check(launches == expect, f"{label} beam: launches per kernel")
    check(seqs.shape == (1, n) and bool(torch.isfinite(scores).all()),
          f"{label} beam: output shape and finite score")
    one = beam(width=1)[0]
    check(torch.equal(one, greedy()[0]),
          f"{label}: beam_search(num_beams=1) equals generate")

    for arm, fn in (("beam", beam), ("greedy", greedy)):
        ttft[arm] = cuda_ms(lambda: fn(1))[1]
    log(f"{label} beam (W={w}) vs greedy generate, {n} tokens, the counted "
        f"calls timed: ms per generated token beam {ms['beam'] / n:.3f}, "
        f"greedy {ms['greedy'] / n:.3f}; TTFT ms beam {ttft['beam']:.3f}, "
        f"greedy {ttft['greedy']:.3f}")

    logits, state, _ = llama.prefill_compressed(params, ids, mcfg, ccfg,
                                                max_decode_len=n)
    gen = torch.Generator(device=device).manual_seed(SEED + 32)
    # The search's own steps (B=1, no EOS), so each ring has been gathered
    # by its parents before K2 reads it.
    scores, tokens = beam_search._top(torch.log_softmax(logits.float(), -1),
                                      w)
    st, parents = beam_search._expand_beams(state, w), []
    for _ in range(BEAM_K2_STEPS):
        step_logits, st = llama.decode_step(params, tokens.reshape(w), st,
                                            mcfg, ccfg)
        total = scores[:, :, None] + torch.log_softmax(
            step_logits.float(), -1).reshape(1, w, -1)
        scores, flat = beam_search._top(total.reshape(1, -1), w)
        tokens, parent = flat % mcfg.vocab_size, flat[0] // mcfg.vocab_size
        parents.append(parent.tolist())
        st = beam_search._gather_beams(st, parent)
    q = torch.randn((w, 1, mcfg.num_heads, mcfg.head_dim), generator=gen,
                    device=device).to(llama.model_dtype(mcfg))
    q_pos = st.position[:, None]
    errs, shares = [], []
    for cache, recent, pool in zip(st.caches, st.recents,
                                   st.pools or (None,) * layers):
        out = fused_decode_attention(q, cache, recent, q_pos, ccfg, pool=pool)
        ref = decode_attention_plain(q, cache, recent, q_pos, ccfg, pool=pool)
        errs.append(max_err(out, ref))
        shares.append(bf16_share(out, ref))
    ring = st.recents[0]
    rows_differ = not all(torch.equal(ring.k[0], ring.k[r])
                          for r in range(1, w))
    log(f"{label} K2 at the beam shape ({w} rows after {BEAM_K2_STEPS} beam "
        f"steps, parents per step {parents}; ring {int(ring.length[0])}/"
        f"{ring.capacity}, rows' rings differ {rows_differ}; bf16), each of "
        f"{layers} layers against its plain version on the same q, tiers "
        f"and ring: max abs err {max(errs):.3e} (layer "
        f"{errs.index(max(errs))}), worst element at {max(shares):.3f} of "
        f"its limit ({BF16_ULPS} bf16 ulps + {BF16_FLOOR:.3e})")
    check(max(shares) <= 1.0, f"{label} K2 at the beam shape: every layer "
                              f"within the bf16 limit")
    check(rows_differ, f"{label} K2 at the beam shape: the beams' rings "
                       f"differ")
    del st, out, ref

    expanded = beam_search._expand_beams(state, w)
    parent = torch.randint(0, w, (w,), generator=gen, device=device)
    total = torch.randn((1, w * mcfg.vocab_size), generator=gen,
                        device=device)
    _, gather_ms = cuda_ms(lambda: beam_search._gather_beams(expanded,
                                                             parent), 20)
    gather_host = _host_ms(lambda: beam_search._gather_beams(expanded,
                                                             parent))
    _, sort_ms = cuda_ms(lambda: beam_search._top(total, w), 20)
    log(f"{label} beam reindexing alone per step ({layers} layers' rings "
        f"and positions at {w} rows): {gather_ms:.4f} ms by CUDA events "
        f"over 20 calls, host ms {_spread(gather_host)}; top-{w} sort over "
        f"{w * mcfg.vocab_size} totals {sort_ms:.4f} ms")
    _profile_window(label, "beam search 10 steps",
                    lambda: beam_search._search(params, logits, state, mcfg,
                                                ccfg, w, 11, 1.0, BEAM_EOS,
                                                None))
    return {f"{label}_beam": launches}, {
        "max_abs_err": max(errs),
        "shape": f"{w} rows (B=1 x W={w}) of a {PROMPT}-token "
                 f"{mcfg.num_layers}-layer state after {BEAM_K2_STEPS} beam "
                 f"steps with their gathers, 8/4/2, tiers + ring, bf16, "
                 f"every layer"}


def _first_divergence(ref: torch.Tensor, toks: torch.Tensor):
    """Index of the first step where `toks` leaves `ref` (row 0), or
    None."""
    differ = (toks[0] != ref[0]).nonzero()
    return int(differ[0]) if len(differ) else None


def phase_speculative_path(label: str, device, mcfg, main_run,
                           repeats: int = 1) -> dict:
    """Speculative decoding at full width and depth on the main run's
    params: a PROMPT-token prompt whose second half repeats its first (a
    span for prompt lookup to copy), B=1, SPEC_STEPS steps, N_DRAFT drafts,
    rings of SPEC_STEPS + N_DRAFT + 1. Arms: `decode_loop` (K2), and
    `speculative_decode_loop` with oracle drafts (decode_loop's tokens) and
    with prompt lookup, and `adaptive_speculative_decode` (chunks of
    SPEC_CHUNK) with adversarial drafts (the last token + 1). Each arm
    counted once and timed (launches held exactly: K1 once per layer for
    its prefill; K2 0 in the speculative arms, once per layer and plain
    token in the adaptive arm), then timed again, `repeats` runs in all,
    the arms in turns: forwards, tokens per forward, ms per emitted token.
    The oracle drafts decode_loop's tokens: once bf16 parts the arm from
    them at a near tie (the step is reported), its drafts mostly fail.
    The verify forward alone (N_DRAFT + 1 tokens). bf16 agreement with
    decode_loop, reported: the common prefix and, at the first divergence,
    the gap in decode_loop's log-probabilities between its token and the
    arm's. Returns the launches per path."""
    from realtime_kv_cache_compression_tpu_torch.models import (llama,
                                                                speculative)

    params, ccfg = main_run["params"], main_run["ccfg"]
    half = PROMPT // 2
    ids = torch.cat([main_run["ids"][:, :half]] * 2, dim=1)
    layers, n, ring = mcfg.num_layers, SPEC_STEPS, SPEC_STEPS + N_DRAFT + 1
    prefill = lambda: llama.prefill_compressed(  # noqa: E731
        params, ids, mcfg, ccfg, max_decode_len=ring)
    ref = None

    def arms():
        oracle, adversarial = _spec_proposers(ref, n, mcfg.vocab_size)
        return {
            "decode_loop": lambda f, s: (*llama.decode_loop(
                params, f, s, n, mcfg, ccfg), {"forwards": n}),
            "oracle": lambda f, s: speculative.speculative_decode_loop(
                params, f, s, n, mcfg, ccfg, ids, n_draft=N_DRAFT,
                proposer=oracle),
            "lookup": lambda f, s: speculative.speculative_decode_loop(
                params, f, s, n, mcfg, ccfg, ids, n_draft=N_DRAFT),
            "adaptive": lambda f, s: speculative.adaptive_speculative_decode(
                params, f, s, n, mcfg, ccfg, ids, n_draft=N_DRAFT,
                chunk=SPEC_CHUNK, proposer=adversarial)}

    def run(decode):
        logits, state, _ = prefill()
        (toks, _, stats), ms = cuda_ms(
            lambda: decode(torch.argmax(logits, -1), state))
        return toks, stats, ms

    launches, results, ms = {}, {}, {}
    for arm in ("decode_loop", "oracle", "lookup", "adaptive"):
        torch.cuda.synchronize()
        _zero_counts()
        toks, stats, t = run(arms()[arm])
        torch.cuda.synchronize()
        count = _launches()
        if arm == "decode_loop":
            ref = toks
        plain = {"decode_loop": n, "adaptive": SPEC_CHUNK * stats.get(
            "plain_chunks", 0)}.get(arm, 0)
        expect = {key: 0 for key in KERNELS}
        expect.update(K1=layers, K2=layers * plain)
        log(f"{label} speculative {arm} launches: {count} (expect {expect})")
        check(count == expect, f"{label} speculative {arm}: launches per "
                               f"kernel")
        check(toks.shape == (1, n), f"{label} speculative {arm}: shape")
        launches[f"{label}_speculative_{arm}"] = count
        results[arm], ms[arm] = (toks, stats), [t / n]
    for i in range(1, repeats):
        order = list(results)[::-1 if i % 2 else 1]
        for arm in order:
            ms[arm].append(run(arms()[arm])[2] / n)

    # decode_loop's log-probabilities, teacher-forced, at each arm's first
    # divergence from it.
    firsts = {arm: _first_divergence(ref, toks)
              for arm, (toks, _) in results.items()}
    needed = max((i for i in firsts.values() if i is not None), default=-1)
    lp_rows = {}
    if needed >= 0:
        logits, state, _ = prefill()
        tok = torch.argmax(logits, -1)
        for i in range(needed + 1):
            step_logits, state = llama.decode_step(params, tok, state, mcfg,
                                                   ccfg)
            lp_rows[i] = torch.log_softmax(step_logits.float(), -1)[0]
            tok = ref[:, i]
    for arm, (toks, stats) in results.items():
        forwards = stats.get("forwards", stats.get("iterations"))
        i = firsts[arm]
        gap = ("none" if i is None else
               f"{float(lp_rows[i][ref[0, i]] - lp_rows[i][toks[0, i]]):.4e}"
               f" at step {i}")
        shown = {k: v for k, v in stats.items() if k != "arms"}
        log(f"{label} speculative {arm} (bf16, {n} steps, n_draft "
            f"{N_DRAFT}): forwards {forwards}, tokens per forward "
            f"{n / forwards:.3f}, ms per emitted token {_spread(ms[arm])}; "
            f"common prefix with decode_loop {n if i is None else i} of "
            f"{n}, logprob gap at the first divergence {gap}; {shown}"
            + (f"; arms {stats['arms']}" if "arms" in stats else ""))

    logits, state, _ = prefill()
    block = torch.cat([torch.argmax(logits, -1)[:, None],
                       ref[:, :N_DRAFT]], dim=1)
    speculative.verify_forward(params, block, state, mcfg, ccfg)
    _, verify_ms = cuda_ms(lambda: speculative.verify_forward(
        params, block, state, mcfg, ccfg), 5)
    log(f"{label} verify_forward alone ({N_DRAFT + 1} tokens, {layers} "
        f"layers over a {PROMPT}-token compressed state): {verify_ms:.3f} ms")
    return launches


def phase_forward_logits(device, mcfg, main_run, prompt: int = 1024) -> None:
    """`forward_logits`: at full width and depth in bf16 on the main run's
    params and prompt, the SDPA route against the plain route and the last
    position against `prefill_uncompressed`'s logits (errors reported,
    and each route's time); at reduced depth in float32 (prompt `prompt`),
    both within TOL_LOGITS."""
    from realtime_kv_cache_compression_tpu_torch.models import llama

    params, ids = main_run["params"], main_run["ids"]
    routes = {}
    for flash in (True, False):  # a warm-up, then 2 timed calls
        llama.forward_logits(params, ids, mcfg, use_flash=flash)
        routes[flash] = cuda_ms(lambda: llama.forward_logits(
            params, ids, mcfg, use_flash=flash), 2)
    (sdpa, sdpa_ms), (plain, plain_ms) = routes[True], routes[False]
    last, _ = llama.prefill_uncompressed(params, ids, mcfg)
    log(f"forward_logits bf16 ({mcfg.num_layers} layers, S={ids.shape[1]}): "
        f"SDPA route {sdpa_ms:.3f} ms, plain route {plain_ms:.3f} ms per "
        f"call; SDPA "
        f"vs plain max err {max_err(sdpa, plain):.3e} (max|logit| "
        f"{float(plain.float().abs().max()):.3e}); last position vs "
        f"prefill_uncompressed max err {max_err(sdpa[:, -1], last):.3e}")
    check(sdpa.shape == (1, ids.shape[1], mcfg.vocab_size)
          and bool(torch.isfinite(sdpa).all()),
          "forward_logits bf16: shape and finite logits")
    del sdpa, plain, last, routes

    mcfg = dataclasses.replace(mcfg, num_layers=2, dtype="float32")
    params = llama.init_params(SEED, mcfg, device)
    gen = torch.Generator(device=device).manual_seed(SEED + 33)
    ids = torch.randint(0, mcfg.vocab_size, (1, prompt), generator=gen,
                        device=device)
    sdpa = llama.forward_logits(params, ids, mcfg, use_flash=True)
    check_close(sdpa, llama.forward_logits(params, ids, mcfg,
                                           use_flash=False), TOL_LOGITS,
                "forward_logits f32 (2 layers): SDPA vs plain route")
    check_close(sdpa[:, -1], llama.prefill_uncompressed(params, ids, mcfg)[0],
                TOL_LOGITS, "forward_logits f32 (2 layers): last position "
                            "vs prefill_uncompressed")


def _engine_calls(eng) -> dict:
    """The engine's own schedule (its calls of prefill, chunk step and
    decode chunk, `ServingEngine.model_calls`), set to 0: the launches
    follow from it."""
    eng.model_calls.update(dict.fromkeys(eng.model_calls, 0))
    return eng.model_calls


@contextlib.contextmanager
def _held_to_plain(audit: dict, stride: int = 1):
    """While active, each call the model makes to K1 mode (a), K1 mode (b),
    K1 mode (d), the diagonal pair and K2 (with `stride` > 1, each
    kernel's first call and every stride-th after it: with stride = the
    layer count, layer 0's calls of each forward) is held against its plain
    version
    on its own inputs as soon as it returns: K1 row by row (the rows are
    independent; modes (d) and the pair whole) on float32 copies under the
    bf16 limit with 2^-8 sum p|v|/l, its prompt mass within TOL_MASS
    (`k1_refs`), and for mode (d) and the pair the log-sum-exp within
    TOL_LSE on rows that see a key and -inf exactly on the others; K2
    against `decode_attention_plain` in float32 under the bf16 ulp limit,
    as in `phase_k2`. K2 is checked at the call, before the next step
    writes the ring and pool in place. Calls to the plain versions launch
    nothing. `audit` collects, per kernel, [calls, worst output max abs
    err, worst share of a limit, worst prompt mass max abs err]. A float32
    output (and the lse) is held to its tolerance (TOL_K1_F32, TOL_K2_F32,
    TOL_LSE) times max(1, max|reference|): float32 rounding grows with the
    values summed, and the tolerances were set on random-weight outputs of
    magnitude 1 or less (a trained recall model's reach 8.4). The prompt
    mass is held to TOL_MASS as an absolute limit. Under tensor
    parallelism the K1 calls carry the model axis's group: the plain
    versions take it too, so both masses are means over every rank's
    heads (each rank of the group holds the same number of calls). Mode (d) and the pair
    are wrapped where `flash_compressed_prefix_attention` finds them, in
    the kernel module; their launches there are added back to the
    wrappers' counts on exit."""
    from realtime_kv_cache_compression_tpu_torch.models import llama
    from realtime_kv_cache_compression_tpu_torch.ops.attention import (
        chunk_attention_with_prompt_mass, prefill_attention_with_prompt_mass)
    from realtime_kv_cache_compression_tpu_torch.ops.cuda import (
        flash_prefill as fp)
    from realtime_kv_cache_compression_tpu_torch.ops.cuda.decode_attention \
        import decode_attention_plain

    def note(key, pairs, what, count=True):
        rec = audit.setdefault(key, [0, 0.0, 0.0, 0.0])
        rec[0] += count
        for i, (part, (out, ref, tol, ref_abs)) in enumerate(zip(
                ("output", "prompt mass"), pairs)):
            if i == 0 and out.dtype == torch.float32:
                tol = tol * max(1.0, float(ref.abs().max()))
            share = limit_share(out, ref, tol, ref_abs=ref_abs)
            rec[1 + 2 * i] = max(rec[1 + 2 * i], max_err(out, ref))
            rec[2] = max(rec[2], share)
            check(share <= 1.0, f"{what} {part}: worst element at "
                                f"{share:.3f} of its limit (max abs err "
                                f"{max_err(out, ref):.3e}, max|ref| "
                                f"{float(ref.float().abs().max()):.3e})")

    seen = {}

    def held(key) -> bool:
        seen[key] = seen.get(key, -1) + 1
        return seen[key] % stride == 0

    def k1(key, plain, q, k, v, args, prompt_lens, result):
        if not held(key):
            return
        o, pm = result
        for b in range(q.shape[0]):
            lens = None if prompt_lens is None else prompt_lens[b:b + 1]
            (o_ref, pm_ref), o_abs = k1_refs(plain, q[b:b + 1], k[b:b + 1],
                                             v[b:b + 1], *args,
                                             prompt_lens=lens)
            note(key, [(o[b:b + 1], o_ref, TOL_K1_F32, o_abs),
                       (pm[b:b + 1], pm_ref, TOL_MASS, None)],
                 f"{key} {tuple(q.shape)} {args} row {b}", count=b == 0)

    originals = {name: getattr(llama, name) for name in (
        "flash_prefill_with_prompt_mass",
        "flash_chunk_attention_with_prompt_mass", "fused_decode_attention")}

    def prefill(q, k, v, prompt_len, prompt_lens=None, group=None):
        result = originals["flash_prefill_with_prompt_mass"](
            q, k, v, prompt_len, prompt_lens=prompt_lens, group=group)
        k1("K1", functools.partial(prefill_attention_with_prompt_mass,
                                   group=group), q, k, v, (prompt_len,),
           prompt_lens, result)
        return result

    def chunk(q, k_buf, v_buf, q_offset, prompt_len, prompt_lens=None,
              group=None):
        result = originals["flash_chunk_attention_with_prompt_mass"](
            q, k_buf, v_buf, q_offset, prompt_len, prompt_lens=prompt_lens,
            group=group)
        k1("K1b", functools.partial(chunk_attention_with_prompt_mass,
                                    group=group), q, k_buf, v_buf,
           (q_offset, prompt_len), prompt_lens, result)
        return result

    def decode(q, cache, recent, q_pos, cfg, pool=None):
        out = originals["fused_decode_attention"](q, cache, recent, q_pos,
                                                  cfg, pool=pool)
        if not held("K2"):
            return out
        ref = decode_attention_plain(q, cache, recent, q_pos, cfg, pool=pool)
        note("K2", [(out, ref, TOL_K2_F32, None)],
             f"K2 {tuple(q.shape)} at positions "
             f"{q_pos[:, 0].tolist()}, ring {recent.length.tolist()}")
        return out

    def with_lse(key, plain, q, k, v, args, result):
        """Mode (d) or the pair: `_check_partial`."""
        if not held(key):
            return
        _check_partial(key, f"{key} {tuple(q.shape)} over {k.shape[1]} "
                            f"keys", result, plain, q, k, v, args, audit)

    def positioned(q, k, v, k_pos, q_offset, prompt_len, **tile):
        result = kernels["flash_positioned_attention"](q, k, v, k_pos,
                                                       q_offset, prompt_len,
                                                       **tile)
        with_lse("K1d", fp.positioned_attention_plain, q, k, v,
                 (k_pos, q_offset, prompt_len), result)
        return result

    def pair(q, k, v, plen_local, **tile):
        result = kernels["flash_diagonal_pair_attention"](q, k, v, plen_local,
                                                          **tile)
        with_lse("K1p", lambda *a: fp.pair_attention_plain(*a, causal=True),
                 q, k, v, (plen_local,), result)
        return result

    kernels = {name: getattr(fp, name) for name in (
        "flash_positioned_attention", "flash_diagonal_pair_attention")}
    # The originals count their launches on the module's name, which is
    # the wrapper while it stands.
    for wrapped in (positioned, pair):
        _init_counts(wrapped)
    llama.flash_prefill_with_prompt_mass = prefill
    llama.flash_chunk_attention_with_prompt_mass = chunk
    llama.fused_decode_attention = decode
    fp.flash_positioned_attention = positioned
    fp.flash_diagonal_pair_attention = pair
    try:
        yield audit
    finally:
        for name, fn in originals.items():
            setattr(llama, name, fn)
        for (name, fn), wrapped in zip(kernels.items(), (positioned, pair)):
            setattr(fp, name, fn)
            _add_counts(fn, wrapped)


def _check_partial(key: str, what: str, result, plain, q, k, v, args,
                   audit: dict) -> None:
    """A K1 partial (o, lse, pm) held to its plain version on float32
    copies of its inputs: o under the bf16 limit with 2^-8 sum p|v|/l (or
    TOL_K1_F32 times max(1, max|ref|) in float32), the prompt mass within
    TOL_MASS, the lse within TOL_LSE on rows that see a key and -inf
    exactly on the others. `audit[key]` collects [calls, worst output max
    abs err, worst share of a limit, worst prompt mass max abs err]."""
    o, lse, pm = result
    (o_ref, lse_ref, pm_ref), o_abs = k1_refs(plain, q, k, v, *args)
    tol = TOL_K1_F32 * max(1.0, float(o_ref.abs().max()))
    shares = (limit_share(o, o_ref, tol, ref_abs=o_abs),
              limit_share(pm, pm_ref, TOL_MASS))
    rec = audit.setdefault(key, [0, 0.0, 0.0, 0.0])
    rec[0] += 1
    rec[1] = max(rec[1], max_err(o, o_ref))
    rec[2] = max(rec[2], *shares)
    rec[3] = max(rec[3], max_err(pm, pm_ref))
    check(max(shares) <= 1.0, f"{what}: output and prompt mass at "
                              f"{shares[0]:.3f} / {shares[1]:.3f} of their "
                              f"limits")
    sees = torch.isfinite(lse_ref)
    check(torch.equal(sees, torch.isfinite(lse))
          and bool((lse[~sees] == -torch.inf).all()),
          f"{what}: lse is -inf exactly on the rows that see no key")
    if bool(sees.any()):
        err = max_err(lse[sees], lse_ref[sees])
        tol = TOL_LSE * max(1.0, float(lse_ref[sees].abs().max()))
        check(err <= tol, f"{what} lse: max abs err {err:.3e} (tol "
                          f"{tol:.3e})")


@contextlib.contextmanager
def _ring_held_to_plain(audit: dict):
    """While active, every K1 call of ring attention (the diagonal pair,
    K1p, and mode (c), K1c) is held to `pair_attention_plain` on its own
    inputs as it returns (`_check_partial`). The wrappers are replaced
    where `ring_prefill_attention` finds them; their launches count on
    the kernel module's names as always. The plain versions launch
    nothing."""
    from realtime_kv_cache_compression_tpu_torch.ops.cuda import (
        flash_prefill as fp)
    from realtime_kv_cache_compression_tpu_torch.parallel import (
        ring_attention as ra)

    def held(key, name, causal):
        kernel = getattr(ra, name)

        def call(q, k, v, plen_local, **tile):
            result = kernel(q, k, v, plen_local, **tile)
            _check_partial(key, f"{key} {tuple(q.shape)} over {k.shape[1]} "
                                f"keys", result,
                           lambda *a: fp.pair_attention_plain(
                               *a, causal=causal), q, k, v, (plen_local,),
                           audit)
            return result
        return kernel, call

    patched = {name: held(key, name, causal) for key, name, causal in (
        ("K1p", "flash_diagonal_pair_attention", True),
        ("K1c", "flash_full_pair_attention", False))}
    for name, (_, call) in patched.items():
        setattr(ra, name, call)
    try:
        yield audit
    finally:
        for name, (kernel, _) in patched.items():
            setattr(ra, name, kernel)


@contextlib.contextmanager
def _slot_held_to_plain(audit: dict):
    """While active, every call of K2's lse mode (`return_lse=True`: a
    rank's partial over its own slots of a slot-sharded state) is held to
    `decode_attention_plain(return_lse=True)` on its own inputs as it
    returns: the lse within TOL_LSE times max(1, max|lse|) on rows that
    see a key and -inf exactly on the others; o, which the kernel keeps in
    float32, within TOL_K2_F32 times max(1, max|o|) for float32 q, and
    rounded to q's dtype under the bf16 ulp limit for bf16 q (the merged
    partials round once, to q's dtype). `audit["K2l"]` collects [calls,
    worst o max abs err, worst share of a limit, worst lse max abs err].
    The default calls pass through unchecked. The plain version launches
    nothing."""
    from realtime_kv_cache_compression_tpu_torch.models import llama
    from realtime_kv_cache_compression_tpu_torch.ops.cuda.decode_attention \
        import decode_attention_plain

    kernel = llama.fused_decode_attention

    def call(q, cache, recent, q_pos, cfg, pool=None, return_lse=False):
        result = kernel(q, cache, recent, q_pos, cfg, pool=pool,
                        return_lse=return_lse)
        if not return_lse:
            return result
        o, lse = result
        o_ref, lse_ref = decode_attention_plain(q, cache, recent, q_pos, cfg,
                                                pool=pool, return_lse=True)
        if q.dtype == torch.float32:
            share = limit_share(o, o_ref, TOL_K2_F32 * max(
                1.0, float(o_ref.abs().max())))
        else:
            share = limit_share(o.to(q.dtype), o_ref, TOL_K2_F32)
        sees = torch.isfinite(lse_ref)
        check(torch.equal(sees, torch.isfinite(lse))
              and bool((lse[~sees] == -torch.inf).all()),
              "K2 lse mode: lse is -inf exactly on the rows that see no key")
        lse_err = max_err(lse[sees], lse_ref[sees]) if bool(sees.any()) \
            else 0.0
        tol = TOL_LSE * max(1.0, float(lse_ref[sees].abs().max())
                            if bool(sees.any()) else 1.0)
        rec = audit.setdefault("K2l", [0, 0.0, 0.0, 0.0])
        rec[0] += 1
        rec[1] = max(rec[1], max_err(o, o_ref))
        rec[2] = max(rec[2], share, lse_err / tol)
        rec[3] = max(rec[3], lse_err)
        check(share <= 1.0 and lse_err <= tol,
              f"K2 lse mode {tuple(q.shape)} {q.dtype} at positions "
              f"{q_pos[:, 0].tolist()}: o at {share:.3f} of its limit, lse "
              f"max abs err {lse_err:.3e} (tol {tol:.3e})")
        return result

    llama.fused_decode_attention = call
    try:
        yield audit
    finally:
        llama.fused_decode_attention = kernel


def _tier_bytes(state) -> int:
    """Bytes of every layer's tier tensors in a decode state."""
    from realtime_kv_cache_compression_tpu_torch.compression.compressor \
        import _TIER_FIELDS

    return sum(nbytes(getattr(t, f)) for c in state.caches for t in c.tiers
               for f in _TIER_FIELDS + ("positions", "valid"))


def _params_digest(params) -> torch.Tensor:
    """Per tensor of a params tree, in a fixed order: the float64 sum of
    its values and of their squares times their flat index (a digest that
    two ranks share only if they hold the same weights)."""
    leaves = []

    def walk(x):
        if isinstance(x, dict):
            for key in sorted(x):
                walk(x[key])
        elif isinstance(x, (list, tuple)):
            for y in x:
                walk(y)
        else:
            leaves.append(x)
    walk(params)
    out = []
    for t in leaves:
        f = t.double().reshape(-1)
        idx = torch.arange(f.numel(), device=f.device, dtype=torch.float64)
        out += [f.sum(), (f * f * idx).sum()]
    return torch.stack(out).cpu()


def _rank_counted(rank: int, label: str, fn, expect: dict):
    """fn() with every launch count set to 0 just before and read just
    after (a rank's own counts); fails unless they are `expect` (0 for
    every other kernel). Returns (fn's result, the counts)."""
    _zero_counts()
    result = fn()
    torch.cuda.synchronize()
    got = _launches()
    want = {**{key: 0 for key in KERNELS}, **expect}
    check(got == want, f"rank {rank} {label}: launches {got} (expect "
                       f"{want})")
    return result, got


def _rank_timed(group, fn):
    """fn() after a barrier of `group`, timed by CUDA events and the host
    clock, with the host staging of its collectives: (result, reading)."""
    import torch.distributed as dist

    from realtime_kv_cache_compression_tpu_torch import comm

    comm.reset_stage_counts()
    torch.cuda.synchronize()
    dist.barrier(group)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    start.record()
    result = fn()
    end.record()
    torch.cuda.synchronize()
    return result, {"event_ms": start.elapsed_time(end),
                    "wall_ms": (time.perf_counter() - t0) * 1e3,
                    "staged": (comm.stage.seconds, comm.stage.bytes,
                               comm.stage.calls)}


def _seq_parallel_rank(rank: int, n: int, group, device, mcfg, ids, small,
                       small_ids, small_lengths) -> dict:
    """One rank of phase_seq_parallel, spawned on `device` (cuda:0) over a
    gloo group (`parallel.launch.run_ranks`); every failed check raises, which
    fails the phase. The float32 parity run first (`small`, query-guided,
    ragged), counted; then TinyLlama bf16 (`mcfg`) from the main run's
    seed (every rank's weights compared by digest over the group) on the
    main run's prompt `ids`: the replicated run counted and every K1 call
    held to its plain version (`_ring_held_to_plain`), its greedy decode
    through K2 counted, the same prefill timed (CUDA events and host wall,
    after a barrier; the host staging of the collectives counted), then
    the sharded run counted with each layer's compression inputs recorded,
    and the greedy decode from the gathered state through K2, counted.
    Returns host copies of what the parent compares."""
    import torch.distributed as dist

    from realtime_kv_cache_compression_tpu_torch import CompressionConfig
    from realtime_kv_cache_compression_tpu_torch.models import llama
    from realtime_kv_cache_compression_tpu_torch.parallel import (
        comm, gather_sharded_state, seq_parallel_prefill)
    from realtime_kv_cache_compression_tpu_torch.parallel import (
        seq_parallel as sp)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    host = lambda state: llama.map_decode_state(  # noqa: E731
        state, lambda t: t.cpu(), state.ring_fill)
    out = {}
    counted = functools.partial(_rank_counted, rank)

    # float32 parity at tiny_test_model width.
    sp_params = llama.init_params(SEED + 20, small, dev)
    sccfg = CompressionConfig(num_layers=small.num_layers,
                              importance_source="both", query_mass_pool=4)
    (logits, state, _), _ = counted(
        "float32 parity prefill", lambda: seq_parallel_prefill(
            sp_params, small_ids.to(dev), small, sccfg, group,
            max_decode_len=SEQ_F32_NEW_TOKENS + 4,
            lengths=small_lengths.to(dev)),
        {"K1p": small.num_layers, "K1c": small.num_layers * rank})
    toks, _ = llama.decode_loop(sp_params, torch.argmax(logits, -1), state,
                                SEQ_F32_NEW_TOKENS - 1, small, sccfg)
    out["f32"] = {"logits": logits.cpu(), "caches": host(state).caches,
                  "tokens": torch.cat([torch.argmax(logits, -1)[:, None],
                                       toks], 1).cpu()}
    # float32 sharded compression (prompt-scored), decoded from the shards
    # with no gather (K2's lse mode) and from the gathered state (K2).
    pccfg = CompressionConfig(num_layers=small.num_layers)
    f32_steps = SEQ_F32_NEW_TOKENS - 1
    (logits, state, _), _ = counted(
        "float32 sharded prefill", lambda: seq_parallel_prefill(
            sp_params, small_ids.to(dev), small, pccfg, group,
            max_decode_len=SEQ_F32_NEW_TOKENS + 4,
            lengths=small_lengths.to(dev), sharded_compression=True),
        {"K1p": small.num_layers, "K1c": small.num_layers * rank})
    full = llama.clone_decode_state(gather_sharded_state(state, group))
    f32_audit = {}
    with _slot_held_to_plain(f32_audit):
        (toks_sh, _), _ = counted(
            "float32 decode from the shards", lambda: _greedy_from(
                sp_params, logits, state, small, pccfg, f32_steps,
                kernels=True, slot_group=group),
            {"K2l": small.num_layers * f32_steps})
    (toks_full, _), _ = counted(
        "float32 decode from the gathered state", lambda: _greedy_from(
            sp_params, logits, full, small, pccfg, f32_steps, kernels=True),
        {"K2": small.num_layers * f32_steps})
    out["f32_sharded"] = {"tokens": toks_sh, "gathered_tokens": toks_full,
                          "audit": f32_audit}
    del sp_params, logits, state, full

    params = llama.fuse_params(llama.init_params(SEED, mcfg, dev))
    digests = comm.all_gather_tensors([_params_digest(params)], group)
    check(all(torch.equal(d[0], digests[0][0]) for d in digests),
          f"rank {rank}: every rank holds the same weights")
    ids = ids.to(dev)
    ccfg = CompressionConfig(num_layers=mcfg.num_layers)
    layers, steps = mcfg.num_layers, SEQ_NEW_TOKENS - 1
    ring = {"K1p": layers, "K1c": layers * rank}
    records, audit = {}, {}
    real = sp.compress_layer_kv

    def recording(k, v, mass, li, *a, **kw):
        records[li] = (mass.clone(), kw.get("query_mass"))
        return real(k, v, mass, li, *a, **kw)

    sp.compress_layer_kv = recording
    try:
        with _ring_held_to_plain(audit):
            comm.reset_stage_counts()
            (logits, state, stats), launches = counted(
                "replicated prefill", lambda: seq_parallel_prefill(
                    params, ids, mcfg, ccfg, group,
                    max_decode_len=SEQ_NEW_TOKENS + 8), ring)
    finally:
        sp.compress_layer_kv = real
    first = torch.argmax(logits, -1)
    out["replicated"] = {
        "logits": logits.float().cpu(), "caches": host(state).caches,
        "stats": [{k_: v_.cpu() for k_, v_ in st.items()} for st in stats],
        "masses": {li: (m.cpu(), None if q is None else q.cpu())
                   for li, (m, q) in records.items()},
        "audit": audit, "launches": launches,
        "staged": (comm.stage.seconds, comm.stage.bytes, comm.stage.calls)}
    (toks, _), out["replicated"]["decode_launches"] = counted(
        "replicated decode", lambda: llama.decode_loop(
            params, first, state, steps, mcfg, ccfg),
        {"K2": layers * steps})
    out["replicated"]["tokens"] = torch.cat([first[:, None], toks], 1).cpu()
    del state, stats, records

    # The same prefill timed (no audit): every rank starts after a barrier.
    comm.reset_stage_counts()
    torch.cuda.synchronize()
    dist.barrier(group)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    start.record()
    seq_parallel_prefill(params, ids, mcfg, ccfg, group,
                         max_decode_len=SEQ_NEW_TOKENS + 8)
    end.record()
    torch.cuda.synchronize()
    out["timed"] = {"event_ms": start.elapsed_time(end),
                    "wall_ms": (time.perf_counter() - t0) * 1e3,
                    "staged": (comm.stage.seconds, comm.stage.bytes,
                               comm.stage.calls)}

    inputs = []

    def recording_inputs(k, v, mass, li, *a, **kw):
        inputs.append((k.cpu(), v.cpu(), mass.cpu()))
        return real(k, v, mass, li, *a, **kw)

    sp.compress_layer_kv = recording_inputs
    try:
        (logits, state, stats), launches = counted(
            "sharded prefill", lambda: seq_parallel_prefill(
                params, ids, mcfg, ccfg, group,
                max_decode_len=SEQ_NEW_TOKENS + 8,
                sharded_compression=True), ring)
    finally:
        sp.compress_layer_kv = real
    # The gathered state (the reference), and copies of the shards for
    # the timed decodes: decode writes rings and pools in place.
    full = llama.clone_decode_state(gather_sharded_state(state, group))
    full_timed = llama.clone_decode_state(full)
    shard_timed = llama.clone_decode_state(state)
    first = torch.argmax(logits, -1)
    out["sharded"] = {
        "logits": logits.float().cpu(), "inputs": inputs,
        "full_caches": host(full).caches if rank == 0 else None,
        "shard_slots": [c.tiers[0].positions.shape[1] for c in state.caches],
        "full_slots": [c.tiers[0].positions.shape[1] for c in full.caches],
        "bytes": (_tier_bytes(state), _tier_bytes(full)),
        "stats": [{k_: v_.cpu() for k_, v_ in st.items()} for st in stats],
        "launches": launches}
    # Decode from the shards, no gather: K2's lse mode 22 times a step on
    # every rank, each call held to its plain version; then from the
    # gathered state through K2.
    audit = {}
    with _slot_held_to_plain(audit):
        (toks, step_logits), out["sharded"]["decode_launches"] = counted(
            "decode from the shards", lambda: _greedy_from(
                params, logits, state, mcfg, ccfg, steps, kernels=True,
                slot_group=group),
            {"K2l": layers * steps})
    out["sharded"].update(tokens=toks, audit=audit, slots_after=[
        c.tiers[0].positions.shape[1] for c in state.caches])
    (toks_full, logits_full), out["sharded"]["gathered_launches"] = counted(
        "decode from the gathered state", lambda: _greedy_from(
            params, logits, full, mcfg, ccfg, steps, kernels=True),
        {"K2": layers * steps})
    out["sharded"].update(gathered_tokens=toks_full,
                          gathered_logits=logits_full)
    # Both decodes timed (no audit, no host copy a step), after a barrier.
    n_timed = SEQ_TIMED_STEPS
    (toks_t, _), out["sharded"]["timed"] = _rank_timed(
        group, lambda: llama.decode_loop(params, first, shard_timed, n_timed,
                                         mcfg, ccfg, slot_group=group))
    check(torch.equal(toks_t.cpu(), toks[:, 1:n_timed + 1]),
          f"rank {rank}: the timed decode from the shards gives the "
          f"counted one's tokens")
    _, out["sharded"]["gathered_timed"] = _rank_timed(
        group, lambda: llama.decode_loop(params, first, full_timed, n_timed,
                                         mcfg, ccfg))
    if rank == 0:  # layer 0's shard and ring, for K2's lse-mode timing
        out["sharded"]["layer0"] = (host(state).caches[0],
                                    llama._map_tensors(state.recents[0],
                                                       lambda t: t.cpu()))
    return out


def _bf16_ulp(x: float) -> float:
    """The spacing of bf16 values at |x| (8 significand bits)."""
    return 2.0 ** (math.floor(math.log2(max(abs(x), 2.0 ** -126))) - 7)


def _prefilled_state(caches, s: int, mcfg, ccfg, device):
    """The decode state a B=1 prefill of s tokens leaves: `caches`, empty
    rings of SEQ_NEW_TOKENS + 8 tokens, no decode pool."""
    from realtime_kv_cache_compression_tpu_torch.models import llama

    return llama.DecodeState(
        caches=tuple(caches),
        recents=tuple(llama._decode_buffers(1, SEQ_NEW_TOKENS + 8, mcfg,
                                            ccfg, device)[0]
                      for _ in caches),
        position=torch.full((1,), s, dtype=torch.int32, device=device),
        pools=(None,) * len(caches))


def phase_seq_parallel(device, mcfg, main_run) -> dict:
    """The sequence-parallel prefill (`parallel/`) on this one card:
    SEQ_RANKS ranks spawned as processes on cuda:0 over a gloo group (the
    collectives staged through the host), the kernels built by this
    process before (phase_build), each rank's work `_seq_parallel_rank`.
    A rank that raises or hangs past SEQ_TIMEOUT fails the phase.

    Per rank, launches exact: K1's diagonal pair once a layer and mode (c)
    once a layer for every rank before it (22 r on rank r at TinyLlama's
    depth), in both compression modes, and K2 once a layer and step in
    both decodes; every K1 call of the replicated run held to its plain
    version. Against the port's one-shot `prefill_compressed` on this
    card (the main run's weights and prompt):
    - bf16, replicated: every rank's logits, kept positions and tokens the
      same; the 32 tokens through K2 equal, up to a near tie (a top-2 gap
      under BF16_ULPS bf16 ulps at the largest logit), to the plain K2
      decode over the same caches (`_greedy_from(kernels=False)`); the
      logits no further from a float32 one-shot prefill over the
      same bf16 weights than twice the bf16 one-shot's distance (plus
      1e-3); where a layer keeps other positions, each tier change a rank
      reversal between scores within 2 delta of the boundary's, delta the
      two runs' largest score difference, at most BF16_SCORE_DRIFT
      (`_selection_drift`), and otherwise equal kept counts; if every
      layer keeps the same positions, the 32 tokens equal the one-shot
      path's up to a near tie (a one-shot top-2 gap within twice the two
      prefills' logit difference);
    - bf16, sharded: each layer's gathered caches equal, byte for byte, to
      `compress_layer_kv_chunked(n_chunks=SEQ_RANKS)` on this card over
      the K/V and prompt masses the ranks compressed, the stats equal
      (counts exactly, the rest within 1e-5 relative), each rank holding
      1/SEQ_RANKS of the slots; the logits equal to the replicated run's
      bit for bit; the decode from the gathered state equal on every rank
      and to the one-shot decode over the chunked reference's caches;
    - float32 at tiny_test_model width (SEQ_F32_LAYERS layers,
      query-guided, ragged): logits within TOL_LOGITS, kept positions and
      every token equal to the one-shot path's.
    Logs TTFT by CUDA events for the one-shot and the ranks' prefill
    (with each rank's host wall and staging), and the card's nvidia-smi
    line. Returns {"launches": the replicated and sharded paths' launches
    summed over the ranks, "audit": per ring kernel [calls, worst max abs
    err, worst share of a limit, worst prompt mass err]}."""
    from realtime_kv_cache_compression_tpu_torch import (CompressionConfig,
                                                         tiny_test_model)
    from realtime_kv_cache_compression_tpu_torch.compression import (
        compress_layer_kv_chunked)
    from realtime_kv_cache_compression_tpu_torch.models import llama
    from realtime_kv_cache_compression_tpu_torch.parallel import run_ranks

    params, ids, ccfg = main_run["params"], main_run["ids"], main_run["ccfg"]
    layers, s = mcfg.num_layers, ids.shape[1]
    steps = SEQ_NEW_TOKENS - 1
    t0 = time.perf_counter()

    # The one-shot path on this card, its masses recorded.
    records, original = {}, llama.compress_layer_kv
    llama.compress_layer_kv = _recording_compress(original, records)
    try:
        logits1, state1, stats1 = llama.prefill_compressed(
            params, ids, mcfg, ccfg, max_decode_len=SEQ_NEW_TOKENS + 8)
    finally:
        llama.compress_layer_kv = original
    caches1 = state1.caches
    toks1, step_logits1 = _greedy_from(params, logits1, state1, mcfg, ccfg,
                                       steps, kernels=True)
    del state1
    _, ttft1 = cuda_ms(lambda: llama.prefill_compressed(
        params, ids, mcfg, ccfg, max_decode_len=SEQ_NEW_TOKENS + 8))
    f32 = dataclasses.replace(mcfg, dtype="float32")
    params32 = _map_tree(params, lambda t: t.float())
    logits32, _, _ = llama.prefill_compressed(params32, ids, f32, ccfg,
                                              max_decode_len=8)
    del params32

    small = tiny_test_model(num_layers=SEQ_F32_LAYERS,
                            max_position_embeddings=SEQ_F32_PROMPT + 64)
    gen = torch.Generator().manual_seed(SEED + 21)
    small_ids = torch.randint(0, small.vocab_size, (len(SEQ_F32_LENGTHS),
                                                    SEQ_F32_PROMPT),
                              generator=gen)
    small_lengths = torch.tensor(SEQ_F32_LENGTHS)
    sp_params = llama.init_params(SEED + 20, small, device)
    sccfg = CompressionConfig(num_layers=small.num_layers,
                              importance_source="both", query_mass_pool=4)
    lg, st, _ = llama.prefill_compressed(
        sp_params, small_ids.to(device), small, sccfg,
        max_decode_len=SEQ_F32_NEW_TOKENS + 4,
        lengths=small_lengths.to(device))
    tk, _ = llama.decode_loop(sp_params, torch.argmax(lg, -1), st,
                              SEQ_F32_NEW_TOKENS - 1, small, sccfg)
    f32_ref = (lg.cpu(), st.caches,
               torch.cat([torch.argmax(lg, -1)[:, None], tk], 1).cpu())
    del sp_params, lg, st
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"seq parallel: one-shot references in "
        f"{time.perf_counter() - t0:.1f} s")

    t1 = time.perf_counter()
    ranks = run_ranks(_seq_parallel_rank, SEQ_RANKS, args=(
        str(device), mcfg, ids.cpu(), small, small_ids, small_lengths),
        timeout=SEQ_TIMEOUT)
    log(f"seq parallel: {SEQ_RANKS} ranks spawned, run and joined in "
        f"{time.perf_counter() - t1:.1f} s")

    # float32 parity: every token equal.
    for r, res in enumerate(ranks):
        got = res["f32"]
        check_close(got["logits"], f32_ref[0], TOL_LOGITS,
                    f"seq parallel f32 rank {r}: logits vs one-shot")
        check(_kept_positions(got["caches"]) == _kept_positions(
            [c for c in f32_ref[1]]),
              f"seq parallel f32 rank {r}: kept positions equal")
        check(torch.equal(got["tokens"], f32_ref[2]),
              f"seq parallel f32 rank {r}: {SEQ_F32_NEW_TOKENS} tokens "
              f"equal to the one-shot path's")
    log(f"seq parallel f32 ({SEQ_F32_LAYERS} layers, d={small.head_dim}, "
        f"lengths {SEQ_F32_LENGTHS}, query-guided): logits, kept positions "
        f"and {SEQ_F32_NEW_TOKENS} tokens equal to the one-shot path's on "
        f"every rank")
    f32_steps = SEQ_F32_NEW_TOKENS - 1
    slot_audit = {"K2l": [0, 0.0, 0.0, 0.0]}
    for r, res in enumerate(ranks):
        got = res["f32_sharded"]
        check(torch.equal(got["tokens"], got["gathered_tokens"])
              and torch.equal(got["tokens"],
                              ranks[0]["f32_sharded"]["tokens"]),
              f"seq parallel f32 rank {r}: {SEQ_F32_NEW_TOKENS} tokens "
              f"decoded from the shards (no gather) equal to the gathered "
              f"state's")
        _audit_merge(slot_audit, got["audit"])
    check(slot_audit["K2l"][0] == SEQ_RANKS * SEQ_F32_LAYERS * f32_steps,
          f"seq parallel f32: every K2 lse-mode call held to its plain "
          f"version {slot_audit}")
    log(f"seq parallel f32 sharded compression: {SEQ_F32_NEW_TOKENS} tokens "
        f"from the shards with no gather equal to the gathered state's on "
        f"every rank {ranks[0]['f32_sharded']['tokens'].tolist()}; K2 lse "
        f"mode audit {slot_audit['K2l']}")

    # bf16, replicated.
    rep = [res["replicated"] for res in ranks]
    for r, res in enumerate(rep):
        check(torch.equal(res["logits"], rep[0]["logits"])
              and torch.equal(res["tokens"], rep[0]["tokens"])
              and _kept_positions(res["caches"])
              == _kept_positions(rep[0]["caches"]),
              f"seq parallel rank {r}: logits, kept positions and tokens "
              f"equal to rank 0's")
    audit = {key: [sum(res["audit"][key][0] for res in rep if key in
                       res["audit"]),
                   *(max(res["audit"].get(key, [0] * 4)[i] for res in rep)
                     for i in (1, 2, 3))] for key in ("K1p", "K1c")}
    check(audit["K1p"][0] == SEQ_RANKS * layers
          and audit["K1c"][0] == layers * SEQ_RANKS * (SEQ_RANKS - 1) // 2,
          f"seq parallel: every K1 call held to its plain version {audit}")
    one = logits1.float().cpu()
    ref32 = logits32.float().cpu()
    d_ring, d_one = max_err(rep[0]["logits"], ref32), max_err(one, ref32)
    d_pair = max_err(rep[0]["logits"], one)
    log(f"seq parallel bf16 logits: ranks vs one-shot max abs diff "
        f"{d_pair:.3e}; vs the float32 one-shot: ranks {d_ring:.3e}, "
        f"one-shot {d_one:.3e} (max|logit| {float(ref32.abs().max()):.3e})")
    check(d_ring <= 2 * d_one + 1e-3,
          "seq parallel bf16 logits no further from float32 than twice "
          "the one-shot's")
    records_ring = {(li, 0): (m.to(device), None, q)
                    for li, (m, q) in rep[0]["masses"].items()}
    caches_ring = _map_tree(rep[0]["caches"], lambda t: t.to(device))
    drift = _selection_drift("seq parallel bf16", {True: records_ring,
                                                   False: records},
                             [caches_ring, caches1], ccfg, s,
                             limit=BF16_SCORE_DRIFT)
    log(f"seq parallel bf16 selection against the one-shot prefill: "
        f"{drift['log']}")
    # K2 against its plain version over the ring's own caches.
    toks_p, logits_p = _greedy_from(
        params, rep[0]["logits"].to(device), _prefilled_state(
            _map_tree(rep[0]["caches"], lambda t: t.to(device)), s, mcfg,
            ccfg, device), mcfg, ccfg, steps, kernels=False)
    near = BF16_ULPS * _bf16_ulp(float(logits_p.abs().max()))
    held = _held_to_reference("seq parallel bf16 replicated decode",
                              rep[0]["tokens"][0], toks_p[0], logits_p[0],
                              near=near)
    log(f"seq parallel bf16 replicated decode: {held} of {SEQ_NEW_TOKENS} "
        f"tokens through K2 held to the plain decode over the same caches "
        f"(near tie: a top-2 gap under {near:.3e}, {BF16_ULPS} bf16 ulps "
        f"at the largest logit)")
    del toks_p, logits_p
    kept_ring = [st["kept_tokens"] for st in rep[0]["stats"]]
    kept_one = [st["kept_tokens"].cpu() for st in stats1]
    if not drift["rows"]:
        check(all(torch.equal(a, b) for a, b in zip(kept_ring, kept_one)),
              "seq parallel bf16: kept counts equal")
        held = _held_to_reference("seq parallel bf16",
                                  rep[0]["tokens"][0], toks1[0],
                                  step_logits1[0], near=2 * d_pair)
        log(f"seq parallel bf16: every layer keeps the one-shot prefill's "
            f"positions; {held} of {SEQ_NEW_TOKENS} tokens held equal")
    else:
        log(f"seq parallel bf16: kept positions part from the one-shot "
            f"prefill's (held by the swap rule above); tokens "
            f"{rep[0]['tokens'][0].tolist()} against "
            f"{toks1[0].tolist()}")

    # bf16, sharded: each layer against the chunked reference.
    sh = [res["sharded"] for res in ranks]
    check(all(torch.equal(res["logits"], rep[0]["logits"]) for res in sh),
          "seq parallel sharded: logits equal to the replicated run's")
    check(all(torch.equal(res["tokens"], sh[0]["tokens"]) for res in sh),
          "seq parallel sharded: every rank decodes the same tokens")
    ref_caches = []
    for li in range(layers):
        k, v, m = (torch.cat([res["inputs"][li][i] for res in sh],
                             1).to(device) for i in range(3))
        cache, stats = compress_layer_kv_chunked(k, v, m, li, ccfg, mcfg,
                                                 n_chunks=SEQ_RANKS)
        ref_caches.append(cache)
        got = sh[0]["full_caches"][li]
        for t_got, t_ref in zip(got.tiers, cache.tiers):
            check(t_got.chunk == t_ref.chunk and all(
                torch.equal(getattr(t_got, f), getattr(t_ref, f).cpu())
                for f in ("k_stored", "v_stored", "k_scale", "k_zp",
                          "v_scale", "v_zp", "positions", "valid")),
                  f"seq parallel sharded layer {li}: caches equal to "
                  f"compress_layer_kv_chunked's")
        for r, res in enumerate(sh):
            check(res["shard_slots"][li] * SEQ_RANKS
                  == res["full_slots"][li],
                  f"seq parallel sharded rank {r}: 1/{SEQ_RANKS} of the "
                  f"slots")
            for key, want in stats.items():
                g, w = res["stats"][li][key], want.cpu()
                ok = (torch.equal(g, w) if not g.is_floating_point() else
                      bool(torch.allclose(g, w.to(g.dtype), rtol=1e-5,
                                          atol=1e-6)))
                check(ok, f"seq parallel sharded rank {r} layer {li}: stat "
                          f"{key} {g.tolist()} vs {w.tolist()}")
    state_ref = _prefilled_state(ref_caches, s, mcfg, ccfg, device)
    first = sh[0]["tokens"][:, 0].to(device)
    toks_ref, _ = llama.decode_loop(params, first, state_ref, steps, mcfg,
                                    ccfg)
    check(all(torch.equal(res["gathered_tokens"][:, 1:], toks_ref.cpu())
              for res in sh),
          "seq parallel sharded: tokens from the gathered state equal the "
          "decode over the chunked reference's caches on every rank")
    del state_ref, ref_caches
    log(f"seq parallel sharded: caches of {layers} layers equal to "
        f"compress_layer_kv_chunked(n_chunks={SEQ_RANKS}), stats equal, "
        f"{SEQ_NEW_TOKENS} tokens from the gathered state on every rank "
        f"{sh[0]['gathered_tokens'][0].tolist()}")
    # The decode from the shards (no gather): K2's lse mode on each rank's
    # own slots, the partials merged over the ranks.
    for r, res in enumerate(sh):
        check(res["slots_after"] == res["shard_slots"],
              f"seq parallel sharded rank {r}: 1/{SEQ_RANKS} of the slots "
              f"after decoding")
        _audit_merge(slot_audit, {"K2l": res["audit"]["K2l"]})
    check(slot_audit["K2l"][0] == SEQ_RANKS * (
        SEQ_F32_LAYERS * f32_steps + layers * steps),
          f"seq parallel: every K2 lse-mode call held to its plain version "
          f"{slot_audit}")
    near = BF16_ULPS * _bf16_ulp(float(sh[0]["gathered_logits"].abs().max()))
    held = _held_to_reference(
        "seq parallel bf16 decode from the shards", sh[0]["tokens"][0],
        sh[0]["gathered_tokens"][0], sh[0]["gathered_logits"][0], near=near)
    same = int((sh[0]["tokens"] == sh[0]["gathered_tokens"]).sum())
    log(f"seq parallel bf16 decode from the shards, no gather: tokens the "
        f"same on every rank, {held} of {SEQ_NEW_TOKENS} held to the "
        f"gathered state's (near tie: a top-2 gap under {near:.3e}), "
        f"{same} of {SEQ_NEW_TOKENS} equal in all "
        f"{sh[0]['tokens'][0].tolist()}; K2 lse-mode audit (calls, worst o "
        f"err, worst share of a limit, worst lse err) {slot_audit['K2l']}")
    rate = lambda t: SEQ_TIMED_STEPS / (t["event_ms"] / 1e3)  # noqa: E731
    log(f"seq parallel decode ({SEQ_TIMED_STEPS} steps, {SEQ_RANKS} ranks "
        f"on one card, overheads not scaling): from the shards "
        f"{[round(rate(res['timed']), 2) for res in sh]} steps/s a rank "
        f"(CUDA events; host wall "
        f"{[round(res['timed']['wall_ms'], 1) for res in sh]} ms, staging "
        f"{[round(res['timed']['staged'][0] * 1e3, 1) for res in sh]} ms), "
        f"tiers held {[res['bytes'][0] for res in sh]} bytes a rank; from "
        f"the gathered state "
        f"{[round(rate(res['gathered_timed']), 2) for res in sh]} steps/s "
        f"a rank, tiers held {[res['bytes'][1] for res in sh]} bytes a "
        f"rank")
    k2l = phase_k2_lse(device, mcfg, ccfg, *sh[0]["layer0"], s)
    k2l["max_abs_err"] = max(k2l["max_abs_err"], slot_audit["K2l"][1])

    timed = [res["timed"] for res in ranks]
    log(f"seq parallel TTFT (bf16, S={s}, {layers} layers): one-shot "
        f"{ttft1:.3f} ms; {SEQ_RANKS} ranks on one card, CUDA events per "
        f"rank {[round(t['event_ms'], 3) for t in timed]} ms, host wall "
        f"{[round(t['wall_ms'], 3) for t in timed]} ms; host staging per "
        f"rank {[round(t['staged'][0] * 1e3, 3) for t in timed]} ms for "
        f"{[t['staged'][1] for t in timed]} bytes in "
        f"{[t['staged'][2] for t in timed]} copies")
    log(f"seq parallel audit (calls, worst max abs err, worst share of a "
        f"limit, worst prompt mass err): {audit}")
    log(nvidia_smi_line())
    paths = {}
    for path, part in (("tinyllama_seq_parallel", "replicated"),
                       ("tinyllama_seq_parallel_sharded", "sharded")):
        paths[path] = {key: sum(res[part]["launches"][key]
                                + res[part]["decode_launches"][key]
                                for res in ranks) for key in KERNELS}
        log(f"seq parallel {path} launches over the ranks: {paths[path]}; "
            f"per rank {[res[part]['launches'] for res in ranks]}")
    log(f"seq parallel phase: {time.perf_counter() - t0:.1f} s")
    return {"launches": paths, "audit": {**audit, **slot_audit}, "k2l": k2l}


def _layered_params(mcfg, device, mesh=None, group=None):
    """A `mcfg` model's bf16 weights drawn one layer at a time (layer i from
    a one-layer init at SEED + 40 + i; the embedding, norm and head from a
    zero-layer init at SEED + 39), each cut to this rank's slice on `mesh`
    (`shard_params`) before the next is drawn. The ranks of `group` (on
    one card) draw in turn, each returning its drawing's memory to the card
    before the next: one full layer is on the card at a time. Returns the
    tree (sharded: with its layout)."""
    import torch.distributed as dist

    from realtime_kv_cache_compression_tpu_torch.models import llama
    from realtime_kv_cache_compression_tpu_torch.parallel import (
        comm, shard_layout, shard_params)

    rank, n = comm.rank_and_size(group)

    def part(seed, layers):
        cfg = dataclasses.replace(mcfg, num_layers=layers)
        for turn in range(n):
            if turn == rank:
                tree = llama.init_params(seed, cfg, device)
                if mesh is not None:
                    tree = shard_params(tree, mesh, cfg)
                torch.cuda.empty_cache()
            if group is not None:
                dist.barrier(group)
        return tree

    tree = dict(part(SEED + 39, 0))
    tree["layers"] = [part(SEED + 40 + i, 1)["layers"][0]
                      for i in range(mcfg.num_layers)]
    return tree if mesh is None else shard_layout(mcfg, mesh).wrap(tree)


def _tensor_parallel_rank(rank: int, n: int, group, device, mcfg, ids_by_mesh,
                          small, small_ids, small_lengths, mixtral,
                          mix_ids) -> dict:
    """One rank of phase_tensor_parallel, spawned on `device` (cuda:0) over
    a gloo group; every failed check raises, which fails the phase. On each
    (data, model) mesh of TP_MESHES: the float32 run at tiny_test_model
    width (query-guided "both", ragged), then TinyLlama bf16 from the main
    run's seed (every rank's full tree compared by digest over the group
    first), sharded and fused, on that mesh's prompt; each prefill and its
    greedy decode counted (K1 mode (a) once a layer, K2 once a layer and
    step), timed (CUDA events and host wall, after a barrier; the host
    staging of the collectives counted), layer 0's K1 and K2 calls held to
    their plain versions (`_held_to_plain(stride=layers)`) and each
    layer's prompt mass recorded. Then the Mixtral-width model on the
    1 x 4 mesh, built a layer at a time and sharded as it is drawn
    (experts on the model axis), the same way. Returns host copies of what
    the parent compares."""
    from realtime_kv_cache_compression_tpu_torch import CompressionConfig
    from realtime_kv_cache_compression_tpu_torch.models import llama
    from realtime_kv_cache_compression_tpu_torch.parallel import (
        comm, create_mesh, shard_params)
    from realtime_kv_cache_compression_tpu_torch.parallel import (
        expert_parallel as ep)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    host = lambda state: llama.map_decode_state(  # noqa: E731
        state, lambda t: t.cpu(), state.ring_fill)
    out = {}
    counted = functools.partial(_rank_counted, rank)
    timed = functools.partial(_rank_timed, group)

    def run(label, sp, cfg, ccfg, ids, steps, lengths=None):
        layers, audit, records, reading = cfg.num_layers, {}, {}, {}
        original = llama.compress_layer_kv
        llama.compress_layer_kv = _recording_compress(original, records)
        try:
            with _held_to_plain(audit, stride=layers):
                ((logits, state, stats), reading["prefill"]), pre = counted(
                    f"{label} prefill", lambda: timed(
                        lambda: llama.prefill_compressed(
                            sp, ids, cfg, ccfg, max_decode_len=steps + 8,
                            use_flash=True, lengths=lengths,
                            mesh=sp.layout.mesh)), {"K1": layers})
                first = torch.argmax(logits, -1)
                ((toks, _), reading["decode"]), dec = counted(
                    f"{label} decode", lambda: timed(
                        lambda: llama.decode_loop(
                            sp, first, state, steps, cfg, ccfg,
                            use_fused=True)), {"K2": layers * steps})
        finally:
            llama.compress_layer_kv = original
        return {"logits": logits.float().cpu(), "caches": host(state).caches,
                "tokens": torch.cat([first[:, None], toks], 1).cpu(),
                "masses": {li: (m.cpu(), None if q is None else q.cpu())
                           for (li, _), (m, _, q) in records.items()},
                "kept": [st["kept_tokens"].cpu() for st in stats],
                "launches": pre, "decode_launches": dec, "audit": audit,
                "kv_heads": state.caches[0].tiers[0].k_scale.shape[2],
                "timed": reading}

    full = llama.init_params(SEED, mcfg, dev)
    digests = comm.all_gather_tensors([_params_digest(full)], group)
    check(all(torch.equal(d[0], digests[0][0]) for d in digests),
          f"rank {rank}: every rank holds the same weights")
    sccfg = CompressionConfig(num_layers=small.num_layers,
                              importance_source="both", query_mass_pool=4)
    ccfg = CompressionConfig(num_layers=mcfg.num_layers)
    for data, model in TP_MESHES:
        mesh = create_mesh(data, model)
        sp32 = shard_params(llama.init_params(SEED + 30, small, dev), mesh,
                            small)
        out[("f32", data, model)] = run(
            f"float32 {data}x{model}", sp32, small, sccfg, small_ids.to(dev),
            SEQ_F32_NEW_TOKENS - 1, lengths=small_lengths.to(dev))
        del sp32
        sp = llama.fuse_params(shard_params(full, mesh, mcfg))
        out[("tiny", data, model)] = run(
            f"tinyllama {data}x{model}", sp, mcfg, ccfg,
            ids_by_mesh[(data, model)].to(dev), TP_NEW_TOKENS - 1)
        del sp
    del full
    torch.cuda.empty_cache()
    out["memory_gib"] = {"before_mixtral": torch.cuda.memory_allocated()
                         / 2 ** 30}
    torch.cuda.reset_peak_memory_stats()
    sp = _layered_params(mixtral, dev, create_mesh(1, 4), group)
    out["memory_gib"]["mixtral_built"] = (torch.cuda.memory_allocated()
                                          / 2 ** 30)
    out["memory_gib"]["mixtral_build_peak"] = (
        torch.cuda.max_memory_allocated() / 2 ** 30)
    routes = []
    with _recording_routes(ep, routes, TP_MIXTRAL_PROMPT,
                           mixtral.num_layers):
        out[("mixtral", 1, 4)] = run(
            "mixtral 1x4", sp, mixtral,
            CompressionConfig(num_layers=mixtral.num_layers),
            mix_ids.to(dev), TP_MIXTRAL_TOKENS - 1)
    out[("mixtral", 1, 4)]["routes"] = routes
    del sp
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def _recording_routes(module, routes: list, tokens: int, layers: int):
    """While active, the first `layers` calls of `module.router_topk` over
    `tokens` tokens (a prefill's, one a layer) append their expert ids to
    `routes` (on the host)."""
    real = module.router_topk

    def recording(x2, gate, k, *a, **kw):
        w, ids = real(x2, gate, k, *a, **kw)
        if x2.shape[0] == tokens and len(routes) < layers:
            routes.append(ids.cpu())
        return w, ids

    module.router_topk = recording
    try:
        yield routes
    finally:
        module.router_topk = real


def _nonzero(counts: dict) -> dict:
    return {key: n for key, n in counts.items() if n}


def _stack_rows(parts, device):
    """Per layer, the tiers' positions and validity (what
    `_selection_drift` and `_kept_positions` read) of `parts`, one data
    rank's caches each, concatenated along the batch in data-rank order."""
    return [types.SimpleNamespace(tiers=[types.SimpleNamespace(**{
        f: torch.cat([getattr(p[li].tiers[ti], f) for p in parts]).to(device)
        for f in ("positions", "valid")})
        for ti in range(len(parts[0][li].tiers))])
        for li in range(len(parts[0]))]


def phase_tensor_parallel(device, mcfg, main_run, mixtral) -> dict:
    """Tensor and data parallelism (`parallel/sharding.py`,
    `expert_parallel.py`) on this one card: TP_RANKS ranks spawned as
    processes on cuda:0 over a gloo group (the collectives staged through
    the host), each rank's work `_tensor_parallel_rank`, on a 1 x 4 and a
    2 x 2 (data x model) mesh. A rank that raises or hangs past TP_TIMEOUT
    fails the phase.

    Per rank, launches exact: K1 mode (a) once a layer of each prefill
    (over the rank's 32 / m query heads) and K2 once a layer and step of
    each decode (over its kv heads: TinyLlama 8 / 1 on 1 x 4, 16 / 2 on
    2 x 2, n_rep 8; Mixtral 8 / 2, n_rep 4), and every K1 and K2 call of
    layer 0 held to its plain version on its own inputs. Against the port's one-rank
    prefill on this card, with the same weights and prompts:
    - TinyLlama bf16 (22 layers, the main run's weights), B=1 on 1 x 4 (the
      main prompt) and B=2 on 2 x 2 (the main prompt and a second seeded
      row), 32 greedy tokens: the logits, kept positions and tokens the
      same on every rank; the logits no further from a float32 one-rank
      prefill over the same bf16 weights than twice the bf16 one-rank
      prefill's distance (plus 1e-3); where a layer keeps other positions,
      each tier change a rank reversal between scores within 2 delta of
      the boundary's, delta the two runs' largest score difference, at
      most TP_SCORE_DRIFT (`_selection_drift`), and otherwise the kept
      counts equal and the 32 tokens equal the one-rank path's up to a
      near tie (a one-rank top-2 gap within twice the two prefills' logit
      difference);
    - the Mixtral-width model (32 / 8 heads, d=128, 8 experts, top 2,
      TP_MIXTRAL_LAYERS layers, weights drawn a layer at a time,
      `_layered_params`) on 1 x 4 with a TP_MIXTRAL_PROMPT-token prompt and
      TP_MIXTRAL_TOKENS tokens, experts on the model axis: the same rules,
      but for the float32 logits (a float32 one-rank model would not fit
      beside the ranks), whose distance is logged, and the score drift,
      held to TP_MOE_SCORE_DRIFT after the first layer whose router sends
      a token to another expert pair than the one-rank run's (the tokens
      so routed are counted per layer);
    - float32 at tiny_test_model width (SEQ_F32_LAYERS layers,
      query-guided, ragged B=2): logits within TOL_LOGITS, kept positions
      and every token equal to the one-rank path's.
    Logs TTFT by CUDA events for the one-rank prefill and each rank's
    counted one (with its host wall and staging), each rank's decode rate
    over the counted decode, each rank's device memory, and the card's
    nvidia-smi line. Returns {"launches": the paths' launches summed
    over the ranks, "audit": per kernel [calls, worst max abs err, worst
    share of a limit, worst prompt mass err] over every rank}."""
    from realtime_kv_cache_compression_tpu_torch import (CompressionConfig,
                                                         tiny_test_model)
    from realtime_kv_cache_compression_tpu_torch.models import llama
    from realtime_kv_cache_compression_tpu_torch.ops import moe as moe_ops
    from realtime_kv_cache_compression_tpu_torch.parallel import run_ranks

    params, ccfg = main_run["params"], main_run["ccfg"]
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED + 31)
    ids1 = main_run["ids"].cpu()
    ids_by_mesh = {(1, 4): ids1, (2, 2): torch.cat([ids1, torch.randint(
        0, mcfg.vocab_size, ids1.shape, generator=gen)])}
    mix_ids = torch.randint(0, mixtral.vocab_size, (1, TP_MIXTRAL_PROMPT),
                            generator=gen)
    small = tiny_test_model(num_layers=SEQ_F32_LAYERS,
                            max_position_embeddings=SEQ_F32_PROMPT + 64)
    small_ids = torch.randint(0, small.vocab_size, (len(SEQ_F32_LENGTHS),
                                                    SEQ_F32_PROMPT),
                              generator=gen)
    small_lengths = torch.tensor(SEQ_F32_LENGTHS)

    def reference(p, cfg, c, ids, steps, lengths=None):
        records, original = {}, llama.compress_layer_kv
        llama.compress_layer_kv = _recording_compress(original, records)
        try:
            logits, state, stats = llama.prefill_compressed(
                p, ids.to(device), cfg, c, max_decode_len=steps + 8,
                lengths=None if lengths is None else lengths.to(device))
        finally:
            llama.compress_layer_kv = original
        toks, step_logits = _greedy_from(p, logits, state, cfg, c, steps,
                                         kernels=True)
        return {"logits": logits.float().cpu(), "caches": state.caches,
                "records": records, "tokens": toks,
                "step_logits": step_logits,
                "kept": [st["kept_tokens"].cpu() for st in stats]}

    refs = {("tiny",) + key: reference(params, mcfg, ccfg, ids,
                                       TP_NEW_TOKENS - 1)
            for key, ids in ids_by_mesh.items()}
    _, ttft1 = cuda_ms(lambda: llama.prefill_compressed(
        params, ids1.to(device), mcfg, ccfg, max_decode_len=TP_NEW_TOKENS
        + 8))
    f32 = dataclasses.replace(mcfg, dtype="float32")
    params32 = _map_tree(params, lambda t: t.float())
    logits32 = {key: llama.prefill_compressed(
        params32, ids.to(device), f32, ccfg, max_decode_len=8)[0].cpu()
        for key, ids in ids_by_mesh.items()}
    del params32
    sccfg = CompressionConfig(num_layers=small.num_layers,
                              importance_source="both", query_mass_pool=4)
    small_ref = reference(llama.init_params(SEED + 30, small, device), small,
                          sccfg, small_ids, SEQ_F32_NEW_TOKENS - 1,
                          small_lengths)
    mix_params = _layered_params(mixtral, device)
    mccfg = CompressionConfig(num_layers=mixtral.num_layers)
    routes1 = []
    with _recording_routes(moe_ops, routes1, TP_MIXTRAL_PROMPT,
                           mixtral.num_layers):
        refs[("mixtral", 1, 4)] = reference(mix_params, mixtral, mccfg,
                                            mix_ids, TP_MIXTRAL_TOKENS - 1)
    _, ttft_mix = cuda_ms(lambda: llama.prefill_compressed(
        mix_params, mix_ids.to(device), mixtral, mccfg,
        max_decode_len=TP_MIXTRAL_TOKENS + 8))
    del mix_params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"tensor parallel: one-rank references in "
        f"{time.perf_counter() - t0:.1f} s; this process holds "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB")

    t1 = time.perf_counter()
    ranks = run_ranks(_tensor_parallel_rank, TP_RANKS, args=(
        str(device), mcfg, ids_by_mesh, small, small_ids, small_lengths,
        mixtral, mix_ids), timeout=TP_TIMEOUT)
    memory = [{k: round(v, 3) for k, v in r["memory_gib"].items()}
              for r in ranks]
    log(f"tensor parallel: {TP_RANKS} ranks spawned, run and joined in "
        f"{time.perf_counter() - t1:.1f} s; device memory per rank (GiB) "
        f"{memory}")

    def rows_of(key, part):
        """Rank results of one run in data-rank order (model rank 0 of
        each data rank), and all ranks' results."""
        _, data, model = key
        return [ranks[d * model][key][part] for d in range(data)]

    audit, paths = {}, {}
    for key in [("f32",) + m for m in TP_MESHES] + [
            ("tiny",) + m for m in TP_MESHES] + [("mixtral", 1, 4)]:
        kind, data, model = key
        label = f"tensor parallel {kind} {data}x{model}"
        res = [r[key] for r in ranks]
        first = res[0]
        for r, got in enumerate(res):
            check(torch.equal(got["logits"], first["logits"])
                  and torch.equal(got["tokens"], first["tokens"]),
                  f"{label} rank {r}: logits and tokens equal to rank 0's")
            same_rows = ranks[(r // model) * model][key]
            check(_kept_positions(got["caches"])
                  == _kept_positions(same_rows["caches"]),
                  f"{label} rank {r}: kept positions equal to its data "
                  f"row's model rank 0")
        for got in res:
            for k_, rec in got["audit"].items():
                agg = audit.setdefault(k_, [0, 0.0, 0.0, 0.0])
                agg[0] += rec[0]
                for i in (1, 2, 3):
                    agg[i] = max(agg[i], rec[i])
        if kind != "f32":
            paths[f"{'tinyllama' if kind == 'tiny' else 'mixtral'}"
                  f"_tensor_parallel_{data}x{model}"] = {
                k_: sum(g["launches"][k_] + g["decode_launches"][k_]
                        for g in res) for k_ in KERNELS}
        caches = _stack_rows(rows_of(key, "caches"), device)
        if kind == "f32":
            check_close(first["logits"], small_ref["logits"], TOL_LOGITS,
                        f"{label}: logits vs one-rank")
            check(_kept_positions(caches)
                  == _kept_positions(small_ref["caches"]),
                  f"{label}: kept positions equal to the one-rank path's")
            check(torch.equal(first["tokens"], small_ref["tokens"]),
                  f"{label}: {SEQ_F32_NEW_TOKENS} tokens equal to the "
                  f"one-rank path's")
            log(f"{label}: logits, kept positions and "
                f"{SEQ_F32_NEW_TOKENS} tokens equal to the one-rank "
                f"path's on every rank (kv heads a rank "
                f"{first['kv_heads']})")
            continue
        ref = refs[key]
        s = ids1.shape[1] if kind == "tiny" else TP_MIXTRAL_PROMPT
        d_pair = max_err(first["logits"], ref["logits"])
        peak = float(ref["logits"].abs().max())
        if kind == "tiny":
            ref32 = logits32[(data, model)]
            d_tp, d_one = (max_err(x, ref32) for x in (first["logits"],
                                                       ref["logits"]))
            log(f"{label} bf16 logits: ranks vs one-rank {d_pair:.3e}; vs "
                f"the float32 one-rank: ranks {d_tp:.3e}, one-rank "
                f"{d_one:.3e} (max|logit| {float(ref32.abs().max()):.3e})")
            check(d_tp <= 2 * d_one + 1e-3, f"{label}: bf16 logits no "
                  f"further from float32 than twice the one-rank's")
        else:
            check(bool(torch.isfinite(first["logits"]).all()),
                  f"{label}: logits finite")
            log(f"{label} bf16 logits: ranks vs one-rank max abs diff "
                f"{d_pair:.3e} (max|logit| {peak:.3e})")
        masses = [ranks[d * model][key]["masses"] for d in range(data)]
        records_tp = {(li, 0): (torch.cat([m[li][0] for m in masses]).to(
            device), None, None) for li in masses[0]}
        limit = TP_SCORE_DRIFT
        if kind == "mixtral":
            # Tokens routed to another expert pair than the one-rank run's,
            # per layer; past the first such layer the MoE limit applies.
            flips = [int((torch.sort(a, -1).values
                          != torch.sort(b, -1).values).any(-1).sum())
                     for a, b in zip(ranks[0][key]["routes"], routes1)]
            first_flip = next((li for li, f in enumerate(flips) if f),
                              len(flips))
            limit = [TP_SCORE_DRIFT if li <= first_flip
                     else TP_MOE_SCORE_DRIFT for li in range(len(flips))]
            log(f"{label}: tokens routed to another expert pair than the "
                f"one-rank prefill's, per layer: {flips}")
        drift = _selection_drift(label, {True: records_tp,
                                         False: ref["records"]},
                                 [caches, ref["caches"]],
                                 ccfg if kind == "tiny" else mccfg, s,
                                 limit=limit)
        log(f"{label} selection against the one-rank prefill: "
            f"{drift['log']}")
        if not drift["rows"]:
            # The stats come back with every row's (gathered over data).
            check(all(torch.equal(a, b) for a, b in zip(first["kept"],
                                                        ref["kept"])),
                  f"{label}: kept counts equal")
            for row in range(first["tokens"].shape[0]):
                held = _held_to_reference(
                    f"{label} row {row}", first["tokens"][row],
                    ref["tokens"][row], ref["step_logits"][row],
                    near=2 * d_pair)
                log(f"{label} row {row}: every layer keeps the one-rank "
                    f"prefill's positions; {held} of "
                    f"{first['tokens'].shape[1]} tokens held equal")
        else:
            log(f"{label}: kept positions part from the one-rank "
                f"prefill's (held by the swap rule above); tokens "
                f"{first['tokens'].tolist()} against "
                f"{ref['tokens'].tolist()}")
        pre, dec = ([r[key]["timed"][part] for r in ranks]
                    for part in ("prefill", "decode"))
        steps = first["tokens"].shape[1] - 1

        def ms(readings, field="event_ms"):
            return [round(t[field], 3) for t in readings]

        log(f"{label} (bf16, S={s}, B={first['tokens'].shape[0]}; the "
            f"counted runs, layer 0's kernel calls held to the plain "
            f"versions inside them): TTFT one-rank (B=1) "
            f"{ttft1 if kind == 'tiny' else ttft_mix:.3f} ms; per rank by "
            f"CUDA events {ms(pre)} ms, host wall {ms(pre, 'wall_ms')} ms, "
            f"host staging {[round(t['staged'][0] * 1e3, 3) for t in pre]} "
            f"ms for {[t['staged'][1] for t in pre]} bytes in "
            f"{[t['staged'][2] for t in pre]} copies; decode of {steps} "
            f"steps per rank {ms(dec)} ms by events "
            f"({[round(steps * 1e3 / t['event_ms'], 2) for t in dec]} "
            f"steps/s), staging "
            f"{[round(t['staged'][0] * 1e3, 3) for t in dec]} ms in "
            f"{[t['staged'][2] for t in dec]} copies; launches per rank "
            f"{[_nonzero(r[key]['launches']) for r in ranks]} (prefill), "
            f"{[_nonzero(r[key]['decode_launches']) for r in ranks]} "
            f"(decode)")
    check(audit.get("K1", [0])[0] > 0 and audit.get("K2", [0])[0] > 0,
          "tensor parallel: K1 and K2 calls held to their plain versions")
    log(f"tensor parallel audit (calls, worst max abs err, worst share of a "
        f"limit, worst prompt mass err): {audit}")
    log(nvidia_smi_line())
    log(f"tensor parallel phase: {time.perf_counter() - t0:.1f} s")
    return {"launches": paths, "audit": audit}


def _pipeline_rank(rank: int, n: int, group, device, mcfg, ids, digest,
                   steps: int) -> dict:
    """One rank of phase_pipeline, spawned on `device` (cuda:0) over a
    gloo group: stage `rank` of TinyLlama (the main run's bf16 weights from
    SEED, fused; every rank's checked against the parent's digest) through
    `PipelineInference`, which keeps the stage's layers only. Its prefill
    of the main prompt and `steps` greedy steps are counted (K1 mode (a)
    once per layer of the stage, K2 once per layer and step), audited
    (the stage's first layer's K1 and K2 calls held to their plain
    versions) and timed (CUDA events and host wall after a barrier, with
    the host staging of the hops; the audit's plain versions count in the
    times). Returns host copies of what the parent compares."""
    from realtime_kv_cache_compression_tpu_torch import CompressionConfig
    from realtime_kv_cache_compression_tpu_torch.models import llama
    from realtime_kv_cache_compression_tpu_torch.parallel import (
        PipelineInference, create_pipe_mesh)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    counted = functools.partial(_rank_counted, rank)
    timed = functools.partial(_rank_timed, group)
    params = llama.fuse_params(llama.init_params(SEED, mcfg, dev))
    check(torch.equal(_params_digest(params), digest),
          f"pipeline rank {rank}: the main run's weights")
    pipe = PipelineInference(params, mcfg,
                             CompressionConfig(num_layers=mcfg.num_layers),
                             create_pipe_mesh(n), max_decode_len=steps + 8,
                             use_flash=True, use_fused=True)
    del params
    torch.cuda.empty_cache()
    per, audit, reading = pipe.per, {}, {}
    with _held_to_plain(audit, stride=per):
        ((logits, stats), reading["prefill"]), pre = counted(
            "pipeline prefill", lambda: timed(lambda: pipe.prefill(
                ids.to(dev))), {"K1": per})
        first = torch.argmax(logits, -1)
        (toks, reading["decode"]), dec = counted(
            "pipeline decode", lambda: timed(lambda: pipe.decode(
                first, steps)), {"K2": per * steps})
    return {"logits": logits.float().cpu(),
            "tokens": torch.cat([first[:, None], toks], 1).cpu(),
            "kept": [st["kept_tokens"].cpu() for st in stats],
            "launches": pre, "decode_launches": dec, "audit": audit,
            "timed": reading, "layers": (pipe.layer_offset, per),
            "memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def _audit_merge(into: dict, audit: dict) -> None:
    """Folds one rank's `_held_to_plain` audit into `into`: calls summed,
    the worst errors and shares kept."""
    for key, rec in audit.items():
        agg = into.setdefault(key, [0, 0.0, 0.0, 0.0])
        agg[0] += rec[0]
        for i in (1, 2, 3):
            agg[i] = max(agg[i], rec[i])


def _rank_lines(readings, steps: int) -> str:
    """Per rank: TTFT by CUDA events and host wall, host staging, and the
    decode's steps per second (of `readings`, each rank's {"prefill",
    "decode"} `_rank_timed` readings)."""
    pre = [r["prefill"] for r in readings]
    dec = [r["decode"] for r in readings]
    return (f"TTFT per rank by CUDA events "
            f"{[round(t['event_ms'], 3) for t in pre]} ms, host wall "
            f"{[round(t['wall_ms'], 3) for t in pre]} ms, host staging "
            f"{[round(t['staged'][0] * 1e3, 3) for t in pre]} ms for "
            f"{[t['staged'][1] for t in pre]} bytes in "
            f"{[t['staged'][2] for t in pre]} copies; decode of {steps} "
            f"steps per rank {[round(t['event_ms'], 3) for t in dec]} ms "
            f"({[round(steps * 1e3 / t['event_ms'], 2) for t in dec]} "
            f"steps/s), staging "
            f"{[round(t['staged'][0] * 1e3, 3) for t in dec]} ms in "
            f"{[t['staged'][2] for t in dec]} copies")


def phase_pipeline(device, mcfg, main_run) -> dict:
    """Pipeline parallelism (`parallel/pipeline.py`) on this one card:
    TinyLlama (22 layers, the main run's bf16 weights and 4096-token
    prompt) over PIPE_RANKS stages of 11 layers, one spawned process each
    (`_pipeline_rank`; gloo, every hop staged through the host), and
    PIPE_NEW_TOKENS greedy tokens. Per rank, launches exact: K1 mode (a)
    11 a prefill, K2 11 a step; each stage's first layer's K1 and K2 calls
    held to their plain versions. Against the port's one-rank path on the
    same weights and prompt: the logits and tokens the same on every rank,
    and bit-equal to the one-rank path's (no matmul is split: a hop moves
    bytes), the kept counts equal. Logs TTFT by CUDA events (one-rank,
    and per rank with its host wall and staging, from the audited run),
    decode steps per second per rank, the launches and the card's
    nvidia-smi line: multi-rank times on one card are the
    overheads of ranks sharing it, not scaling. Returns {"launches",
    "audit"}."""
    from realtime_kv_cache_compression_tpu_torch.models import llama
    from realtime_kv_cache_compression_tpu_torch.parallel import run_ranks

    t0 = time.perf_counter()
    params, ccfg, ids = main_run["params"], main_run["ccfg"], main_run["ids"]
    steps = PIPE_NEW_TOKENS - 1
    logits, state, stats = llama.prefill_compressed(
        params, ids, mcfg, ccfg, max_decode_len=steps + 8)
    kept = [st["kept_tokens"].cpu() for st in stats]
    ref_toks, ref_logits = _greedy_from(params, logits, state, mcfg, ccfg,
                                        steps, kernels=True)
    del state
    _, ttft1 = cuda_ms(lambda: llama.prefill_compressed(
        params, ids, mcfg, ccfg, max_decode_len=steps + 8))
    ranks = run_ranks(_pipeline_rank, PIPE_RANKS, args=(
        str(device), mcfg, ids.cpu(), _params_digest(params), steps),
        timeout=PIPE_TIMEOUT)
    label = f"pipeline {PIPE_RANKS} stages"
    first = ranks[0]
    for r, got in enumerate(ranks):
        check(torch.equal(got["logits"], first["logits"])
              and torch.equal(got["tokens"], first["tokens"]),
              f"{label} rank {r}: logits and tokens equal to rank 0's")
        check(all(torch.equal(a, b) for a, b in zip(got["kept"], kept)),
              f"{label} rank {r}: kept counts equal to the one-rank's")
    d = max_err(first["logits"], ref_logits[:, 0])
    check(torch.equal(first["logits"], ref_logits[:, 0])
          and torch.equal(first["tokens"], ref_toks),
          f"{label}: logits and all {steps + 1} tokens bit-equal to the "
          f"one-rank path's (logits max abs diff {d:.3e})")
    log(f"{label} (TinyLlama bf16, S={ids.shape[1]}, {steps + 1} tokens; "
        f"stages hold layers {[r['layers'] for r in ranks]} as (first, "
        f"count)): logits and tokens bit-equal to the one-rank path's")
    audit = {}
    for r in ranks:
        _audit_merge(audit, r["audit"])
    check(audit.get("K1", [0])[0] > 0 and audit.get("K2", [0])[0] > 0,
          f"{label}: K1 and K2 calls held to their plain versions")
    log(f"{label} (timed on the counted run, which held each stage's first "
        f"layer's kernel calls to the plain versions; their time counts): "
        f"TTFT one-rank "
        f"{ttft1:.3f} ms; {_rank_lines([r['timed'] for r in ranks], steps)}"
        f"; launches per rank {[_nonzero(r['launches']) for r in ranks]} "
        f"(prefill), {[_nonzero(r['decode_launches']) for r in ranks]} "
        f"(decode); peak device memory per rank (GiB) "
        f"{[round(r['memory_gib'], 3) for r in ranks]}; audit (calls, "
        f"worst max abs err, worst share of a limit, worst prompt mass "
        f"err) {audit}")
    log(nvidia_smi_line())
    log(f"pipeline phase: {time.perf_counter() - t0:.1f} s")
    return {"launches": {f"tinyllama_pipeline_{PIPE_RANKS}": {
        k: sum(r["launches"][k] + r["decode_launches"][k] for r in ranks)
        for k in KERNELS}}, "audit": audit}


def _leaf_items(tree, path=()):
    """(path, tensor) of every tensor of a tree of dicts and lists, dict
    keys in sorted order."""
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaf_items(tree[key], path + (key,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaf_items(v, path + (i,))


def _serve_recorded(eng, traffic) -> dict:
    """Serve `traffic` ((prompt, token budget) pairs, submitted at once) to
    the end and record, per request in submission order: its tokens, stop
    reason, kept ratio, byte savings, TTFT, the logits of its first token,
    and the top-2 gap of the logits behind each of its tokens (the
    engine's own: on a mesh the gathered, global ones); also the host
    seconds spent in decode chunks, the run's wall and the engine's
    schedule."""
    from realtime_kv_cache_compression_tpu_torch.models import llama

    gaps, firsts, pending, chunk, activating = {}, {}, [], [], []
    decode_s = [0.0]
    real_step = llama.decode_step
    real = {n: getattr(eng, n) for n in ("_first_token", "_activate",
                                         "_deliver", "_decode")}

    def top2(logits):
        v = torch.topk(logits.float(), 2, dim=-1).values
        return (v[:, 0] - v[:, 1]).tolist()

    def step(*a, **kw):
        logits, st = real_step(*a, **kw)
        chunk.append(top2(logits))
        return logits, st

    def first(logits):
        pending.extend(zip(top2(logits), logits.float().cpu()))
        return real["_first_token"](logits)

    def activate(req, slot, tok0, lp0):
        gaps[req.rid], firsts[req.rid] = [pending[0][0]], pending[0][1]
        del pending[0]
        activating.append(req.rid)
        try:
            return real["_activate"](req, slot, tok0, lp0)
        finally:
            activating.pop()

    def deliver(slot, new, lps):
        if not activating:
            gaps[eng._slots[slot].rid].extend(chunk[t][slot]
                                              for t in range(len(new)))
        return real["_deliver"](slot, new, lps)

    def decode():
        chunk.clear()
        t = time.perf_counter()
        res = real["_decode"]()
        if eng.device.type == "cuda":
            torch.cuda.synchronize()
        decode_s[0] += time.perf_counter() - t
        return res

    llama.decode_step = step
    for name, fn in (("_first_token", first), ("_activate", activate),
                     ("_deliver", deliver), ("_decode", decode)):
        setattr(eng, name, fn)
    try:
        t0 = time.perf_counter()
        rids = [eng.submit(p, max_new_tokens=m) for p, m in traffic]
        eng.run()
        wall = time.perf_counter() - t0
    finally:
        llama.decode_step = real_step
        for name in real:
            delattr(eng, name)
    reqs = [eng.completed[r] for r in rids]
    return {"tokens": [r.tokens for r in reqs],
            "stop": [r.stop_reason for r in reqs],
            "ratio": [r.prefill_stats["avg_compression_ratio"] for r in reqs],
            "savings": [r.prefill_stats["avg_memory_savings"] for r in reqs],
            "ttft_ms": [r.ttft * 1e3 for r in reqs],
            "gaps": [gaps[r] for r in rids],
            "first": torch.stack([firsts[r] for r in rids]),
            "decode_s": decode_s[0], "wall_s": wall,
            "calls": dict(eng.model_calls)}


def _engine_counted(rank: int, label: str, eng, fn):
    """fn() with the engine's schedule and every launch count set to 0
    just before; fails unless the launches follow the schedule exactly (K1
    mode (a) once a layer per prefill, mode (b) once a layer per chunk
    step, K2 once a layer per decode step). Returns (fn's result, the
    launches)."""
    calls = _engine_calls(eng)
    torch.cuda.synchronize()
    _zero_counts()
    result = fn()
    torch.cuda.synchronize()
    got = _launches()
    layers = eng.mcfg.num_layers
    want = {**{key: 0 for key in KERNELS}, "K1": layers * calls["prefill"],
            "K1b": layers * calls["chunk_step"],
            "K2": layers * eng.decode_chunk * calls["decode"]}
    check(got == want, f"rank {rank} {label}: launches {got} (expect {want}"
                       f"; engine schedule {calls})")
    return result, got


def _sharded_serving_rank(rank: int, n: int, group, device, cfg, digest,
                          traffic, chunk_traffic, f32, f32_traffic, small,
                          small_ids, train_ids) -> dict:
    """One rank of phase_sharded_serving, spawned on `device` (cuda:0) over
    a gloo group. On a pipe mesh of the n ranks: the float32
    `PipelineInference` at tiny_test_model width (one layer a stage) and
    one `pipeline_train_step`. On the SS_MESH (data x model) mesh:
    `ServingEngine(mesh=)` in float32 at the JAX test shape, then
    TinyLlama (bf16 weights from SEED, checked against the parent's
    digest, sharded and fused) on the main traffic and on one chunked
    admission, each counted against the engine's schedule and audited
    (every layer-0 K1 and K2 call held to its plain version), with the
    rank's host staging. Returns host copies of what the parent
    compares."""
    from realtime_kv_cache_compression_tpu_torch import (CompressionConfig,
                                                         comm)
    from realtime_kv_cache_compression_tpu_torch.models import llama, train
    from realtime_kv_cache_compression_tpu_torch.parallel import (
        PipelineInference, create_mesh, create_pipe_mesh,
        pipeline_train_step, shard_params, stack_pipeline_params,
        unstack_pipeline_params)
    from realtime_kv_cache_compression_tpu_torch.serving import ServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    counted = functools.partial(_rank_counted, rank)
    out = {}

    pipe_mesh = create_pipe_mesh(n)
    ps = llama.init_params(SEED + 33, small, dev)
    sccfg = CompressionConfig(num_layers=small.num_layers)
    pipe = PipelineInference(ps, small, sccfg, pipe_mesh,
                             max_decode_len=SEQ_F32_NEW_TOKENS + 8)
    (logits, _), pre = counted(
        "float32 pipeline prefill", lambda: pipe.prefill(small_ids.to(dev)),
        {"K1": pipe.per})
    first = torch.argmax(logits, -1)
    toks, dec = counted("float32 pipeline decode", lambda: pipe.decode(
        first, SEQ_F32_NEW_TOKENS - 1),
        {"K2": pipe.per * (SEQ_F32_NEW_TOKENS - 1)})
    out["pipe_f32"] = {"logits": logits.cpu(),
                       "tokens": torch.cat([first[:, None], toks], 1).cpu(),
                       "launches": {k: pre[k] + dec[k] for k in KERNELS}}
    stacked = stack_pipeline_params(ps, pipe_mesh)
    opt = train.make_optimizer(stacked, lr=PIPE_TRAIN_LR)
    loss, _ = counted("pipeline train step", lambda: pipeline_train_step(
        stacked, opt, train_ids.to(dev), small, pipe_mesh,
        PIPE_TRAIN_MICRO), {})
    out["train"] = {"loss": float(loss), "norm": float(opt.last_grad_norm),
                    "params": _map_tree(unstack_pipeline_params(
                        stacked, pipe_mesh), lambda t: t.cpu())}
    opt.release()
    del pipe, ps, stacked, opt

    mesh = create_mesh(*SS_MESH)
    p32 = shard_params(llama.init_params(SEED + 32, f32, dev), mesh, f32)
    eng = ServingEngine(p32, f32, CompressionConfig(num_layers=f32.num_layers),
                        mesh=mesh, **SS_F32_ENGINE)
    out["f32"], out["f32_launches"] = _engine_counted(
        rank, "float32 sharded serving", eng,
        lambda: _serve_recorded(eng, f32_traffic))
    del eng, p32

    full = llama.init_params(SEED, cfg, dev)
    check(torch.equal(_params_digest(full), digest),
          f"sharded serving rank {rank}: the parent's weights")
    sp = llama.fuse_params(shard_params(full, mesh, cfg))
    del full
    torch.cuda.empty_cache()
    ccfg = CompressionConfig(num_layers=cfg.num_layers)
    kw = dict(num_slots=SERVE_SLOTS, context_len=SS_CONTEXT,
              max_new_tokens=SERVE_NEW_TOKENS, decode_chunk=SERVE_CHUNK)
    for name, chunk in SS_RUNS:
        tr = traffic if name == "main" else chunk_traffic
        eng = ServingEngine(sp, cfg, ccfg, mesh=mesh, prefill_chunk=chunk,
                            **kw)
        audit = {}
        comm.reset_stage_counts()
        with _held_to_plain(audit, stride=cfg.num_layers):
            res, launches = _engine_counted(
                rank, f"sharded serving {name}", eng,
                lambda: _serve_recorded(eng, tr))
        res.update(launches=launches, audit=audit,
                   async_admission=eng.async_admission,
                   rows=eng._state.position.shape[0],
                   staged=(comm.stage.seconds, comm.stage.bytes,
                           comm.stage.calls))
        out[name] = res
    out["memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return out


def _sharded_serving_traffic(cfg):
    """phase_serving_path's draw at SS_CONTEXT: SERVE_PROMPTS prompts of
    SS_CONTEXT/4-SS_CONTEXT tokens with budgets of
    SERVE_NEW_TOKENS/4-SERVE_NEW_TOKENS; then three prompts (full, 5/8
    and 3/8 of the bucket) with a budget of SERVE_CHUNK + 1 for the
    chunked admission; and the JAX test's four 64-token prompts with
    budgets of 6 for the float32 run."""
    import numpy as np

    gen = torch.Generator().manual_seed(SEED + 12)

    def prompt(n):
        return torch.randint(1, cfg.vocab_size, (n,), generator=gen).tolist()

    lengths = torch.randint(SS_CONTEXT // 4, SS_CONTEXT + 1, (SERVE_PROMPTS,),
                            generator=gen).tolist()
    budgets = torch.randint(SERVE_NEW_TOKENS // 4, SERVE_NEW_TOKENS + 1,
                            (SERVE_PROMPTS,), generator=gen).tolist()
    traffic = [(prompt(n), m) for n, m in zip(lengths, budgets)]
    chunk_traffic = [(prompt(n), SERVE_CHUNK + 1) for n in (
        SS_CONTEXT, SS_CONTEXT * 5 // 8, SS_CONTEXT * 3 // 8 + 1)]
    f32_traffic = [(np.random.default_rng(i).integers(1, 250, 64).tolist(),
                    6) for i in range(4)]
    return traffic, chunk_traffic, f32_traffic


def phase_sharded_serving(device, mcfg) -> dict:
    """Sharded serving (`ServingEngine(mesh=)`) and the pipeline's float32
    runs on this one card: SS_RANKS ranks spawned on cuda:0 over a gloo
    group, each rank's work `_sharded_serving_rank`, every rank running
    the same engines on the same submissions.

    On the SS_MESH mesh (slots over `data`, weights over `model`):
    - TinyLlama at full width and TINY_PATH_LAYERS layers, bf16, on
      phase_serving_path's traffic at SS_CONTEXT (SERVE_SLOTS slots,
      SERVE_PROMPTS prompts): per rank, launches exact against the
      engine's own schedule (K1 mode (a) per layer and admission over the
      rank's heads, every admission's rows whole on every data rank; K2
      per layer and step over the rank's kv heads); every rank the same
      tokens, and against the one-rank engine on the same weights: each
      request's tokens equal up to the first near tie (a one-rank top-2
      gap within twice the largest first-token logit difference, which is
      held to at most twice the one-rank engine's distance from the
      float32 one-rank engine's first tokens, plus 1e-3, as
      phase_tensor_parallel caps its own), and where they part, the
      one-rank engine's top-2 gap under that near tie; stop reasons
      equal, kept ratio and byte savings within 1e-6;
    - one chunked admission of three prompts and its decode chunk (K1
      mode (b), SS_PREFILL_CHUNK) the same way, against the one-rank
      chunked engine;
    every layer-0 K1 and K2 call held to its plain version inside the
    runs that are timed (as phase_tensor_parallel's: timed repeats cost
    the script's limit);
    - float32 at the JAX package's test shape: tokens and stop reasons
      equal to the one-rank engine's, stats within 1e-6.
    On a pipe mesh of the SS_RANKS ranks (tiny_test_model width, float32,
    one layer a stage): `PipelineInference` launches exact (K1 1, K2 1 a
    step per rank), logits within TOL_LOGITS and all SEQ_F32_NEW_TOKENS
    tokens equal to the one-rank path's; one `pipeline_train_step`
    (PIPE_TRAIN_MICRO microbatches) against one one-rank `train_step`
    with the same plain attention: loss within TOL_TRAIN_LOSS, global
    gradient norm within 1e-5 relative, parameters as phase_parity_train
    holds them. Logs per rank: TTFT, host staging, decode steps per second
    and launches, and the card's nvidia-smi line (overheads of ranks
    sharing one card, not scaling). Returns {"launches", "audit"}."""
    from realtime_kv_cache_compression_tpu_torch import (CompressionConfig,
                                                         tiny_test_model)
    from realtime_kv_cache_compression_tpu_torch.models import llama, train
    from realtime_kv_cache_compression_tpu_torch.parallel import run_ranks
    from realtime_kv_cache_compression_tpu_torch.serving import ServingEngine

    t0 = time.perf_counter()
    cfg = dataclasses.replace(mcfg, num_layers=TINY_PATH_LAYERS,
                              max_position_embeddings=SS_CONTEXT
                              + SERVE_NEW_TOKENS)
    traffic, chunk_traffic, f32_traffic = _sharded_serving_traffic(cfg)
    log(f"sharded serving traffic: prompt lengths "
        f"{[len(p) for p, _ in traffic]}, token budgets "
        f"{[m for _, m in traffic]}")
    full = llama.init_params(SEED, cfg, device)
    digest = _params_digest(full)
    params = llama.fuse_params(full)
    ccfg = CompressionConfig(num_layers=cfg.num_layers)
    # Synchronous admission: the byte savings are batch-wide, so the
    # one-rank engine must batch its admissions as the ranks' lockstep
    # engine does, whatever the events' timing.
    kw = dict(num_slots=SERVE_SLOTS, context_len=SS_CONTEXT,
              max_new_tokens=SERVE_NEW_TOKENS, decode_chunk=SERVE_CHUNK,
              async_admission=False)
    refs = {name: _serve_recorded(ServingEngine(
        params, cfg, ccfg, prefill_chunk=chunk, **kw),
        traffic if name == "main" else chunk_traffic)
        for name, chunk in SS_RUNS}
    # The float32 one-rank engine's first tokens on the same weights, which
    # cap the bf16 first-token logit difference that sets the near tie.
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = _map_tree(full, lambda t: t.float())
    firsts32 = {name: _serve_recorded(ServingEngine(
        params32, cfg32, ccfg, prefill_chunk=chunk, **kw),
        [(p, 1) for p, _ in (traffic if name == "main" else chunk_traffic)]
    )["first"] for name, chunk in SS_RUNS}
    del full, params, params32
    f32 = tiny_test_model(**SS_F32_DIMS)
    refs["f32"] = _serve_recorded(ServingEngine(
        llama.init_params(SEED + 32, f32, device), f32,
        CompressionConfig(num_layers=f32.num_layers), async_admission=False,
        **SS_F32_ENGINE), f32_traffic)
    small = tiny_test_model(max_position_embeddings=SEQ_F32_PROMPT + 64)
    sccfg = CompressionConfig(num_layers=small.num_layers)
    gen = torch.Generator().manual_seed(SEED + 34)
    small_ids = torch.randint(0, small.vocab_size, (2, SEQ_F32_PROMPT),
                              generator=gen)
    train_ids = torch.randint(0, small.vocab_size, (PIPE_TRAIN_BATCH,
                                                    PIPE_TRAIN_SEQ),
                              generator=gen)
    ps = llama.init_params(SEED + 33, small, device)
    logits, state, _ = llama.prefill_compressed(
        ps, small_ids.to(device), small, sccfg,
        max_decode_len=SEQ_F32_NEW_TOKENS + 8)
    pipe_toks, _ = _greedy_from(ps, logits, state, small, sccfg,
                                SEQ_F32_NEW_TOKENS - 1, kernels=True)
    pipe_logits = logits.float().cpu()
    opt = train.make_optimizer(ps, lr=PIPE_TRAIN_LR)
    before = {k: t.detach().clone() for k, t in _leaf_items(ps)}
    loss1 = float(train.train_step(ps, opt, train_ids.to(device), small,
                                   use_flash=False))
    norm1 = float(opt.last_grad_norm)
    log(f"sharded serving and float32 pipeline: one-rank references in "
        f"{time.perf_counter() - t0:.1f} s")

    t1 = time.perf_counter()
    ranks = run_ranks(_sharded_serving_rank, SS_RANKS, args=(
        str(device), cfg, digest, traffic, chunk_traffic, f32, f32_traffic,
        small, small_ids, train_ids), timeout=SS_TIMEOUT)
    log(f"sharded serving: {SS_RANKS} ranks spawned, run and joined in "
        f"{time.perf_counter() - t1:.1f} s; peak device memory per rank "
        f"(GiB) {[round(r['memory_gib'], 3) for r in ranks]}")

    # The float32 pipeline over SS_RANKS stages and its train step.
    label = f"float32 pipeline {SS_RANKS} stages"
    for r, got in enumerate(ranks):
        res = got["pipe_f32"]
        check(torch.equal(res["tokens"], pipe_toks),
              f"{label} rank {r}: {SEQ_F32_NEW_TOKENS} tokens equal to the "
              f"one-rank path's")
        check_close(res["logits"], pipe_logits, TOL_LOGITS,
                    f"{label} rank {r}: logits vs one-rank")
        tr = got["train"]
        check(abs(tr["loss"] - loss1) <= TOL_TRAIN_LOSS
              and abs(tr["norm"] - norm1) <= 1e-5 * norm1,
              f"pipeline train step rank {r}: loss {tr['loss']:.7f} / "
              f"{loss1:.7f}, global norm {tr['norm']:.6f} / {norm1:.6f}")
        got_p, want_p = dict(_leaf_items(tr["params"])), dict(
            _leaf_items(ps))
        check(got_p.keys() == want_p.keys(), f"pipeline train step rank "
                                             f"{r}: the tree's leaves")
        worst, off, total, moved = 0.0, 0, 0, 0.0
        for key, want_t in want_p.items():
            err = (got_p[key] - want_t.detach().cpu()).abs()
            worst = max(worst, float(err.max()))
            off += int((err > TOL_TRAIN_PARAMS).sum())
            total += err.numel()
            moved = max(moved, float((want_t.detach()
                                      - before[key]).abs().max()))
        check(worst <= PIPE_TRAIN_LR
              and off <= TRAIN_SENSITIVE_SHARE * total
              and moved > PIPE_TRAIN_LR / 2,
              f"pipeline train step rank {r}: parameters (worst {worst:.3e}"
              f", {off} of {total} beyond {TOL_TRAIN_PARAMS:.0e})")
    log(f"{label}: logits within {TOL_LOGITS:.0e} and {SEQ_F32_NEW_TOKENS} "
        f"tokens equal to the one-rank path's on every rank, launches per "
        f"rank {[_nonzero(r['pipe_f32']['launches']) for r in ranks]}; "
        f"pipeline train step ({PIPE_TRAIN_MICRO} microbatches of "
        f"{PIPE_TRAIN_BATCH // PIPE_TRAIN_MICRO} x {PIPE_TRAIN_SEQ}): loss "
        f"{ranks[0]['train']['loss']:.7f} against one rank's {loss1:.7f}, "
        f"global gradient norm {ranks[0]['train']['norm']:.6f} against "
        f"{norm1:.6f} (clip 1.0), parameters within {TOL_TRAIN_PARAMS:.0e} "
        f"but for a share at most {TRAIN_SENSITIVE_SHARE}")
    opt.release()

    # Sharded serving.
    data, model = SS_MESH
    audit, launches = {}, {}
    for name in ("f32",) + tuple(name for name, _ in SS_RUNS):
        label = f"sharded serving {name} {data}x{model}"
        ref, res = refs[name], [r[name] for r in ranks]
        for r, got in enumerate(res):
            check(got["tokens"] == res[0]["tokens"]
                  and got["stop"] == ref["stop"],
                  f"{label} rank {r}: tokens equal to rank 0's, stop "
                  f"reasons to the one-rank engine's")
            check(max(abs(a - b) for a, b in zip(
                got["ratio"] + got["savings"],
                ref["ratio"] + ref["savings"])) <= 1e-6,
                f"{label} rank {r}: kept ratio and byte savings equal to "
                f"the one-rank engine's ({got['ratio']}, {got['savings']}"
                f" against {ref['ratio']}, {ref['savings']})")
        got = res[0]
        if name == "f32":
            check(got["tokens"] == ref["tokens"], f"{label}: every token "
                  f"equal to the one-rank engine's")
            log(f"{label} (float32, JAX's test shape): every token, stop "
                f"reason and kept ratio equal to the one-rank engine's on "
                f"every rank; launches per rank "
                f"{[_nonzero(r['f32_launches']) for r in ranks]}")
            continue
        d = max_err(got["first"], ref["first"])
        d_ss, d_one = (max_err(x, firsts32[name]) for x in (got["first"],
                                                            ref["first"]))
        check(d_ss <= 2 * d_one + 1e-3, f"{label}: bf16 first-token logits "
              f"no further from float32 than twice the one-rank engine's "
              f"(ranks {d_ss:.3e}, one-rank {d_one:.3e})")
        held = [_held_to_gaps(f"{label} request {i}", t, rt, g, 2 * d)
                for i, (t, rt, g) in enumerate(zip(
                    got["tokens"], ref["tokens"], ref["gaps"]))]
        same = [next((i for i, (a, b) in enumerate(zip(t, rt)) if a != b),
                     len(rt)) for t, rt in zip(got["tokens"], ref["tokens"])]
        parting = [f"{g[k]:.3e}" if k < len(rt) else None
                   for k, g, rt in zip(same, ref["gaps"], ref["tokens"])]
        check(all(k >= len(rt) or g[k] < 2 * d for k, g, rt in zip(
            same, ref["gaps"], ref["tokens"])),
            f"{label}: tokens part from the one-rank engine's only at a "
            f"near tie (top-2 gap under {2 * d:.3e}; gaps there {parting})")
        for r in res:
            _audit_merge(audit, r["audit"])
            check(not r["async_admission"]
                  and r["rows"] == SERVE_SLOTS // data,
                  f"{label}: lockstep admission, {SERVE_SLOTS // data} "
                  f"slot rows a rank")
        launches[f"tinyllama_sharded_serving_{name}_{data}x{model}"] = {
            k: sum(r["launches"][k] for r in res) for k in KERNELS}
        steps = got["calls"]["decode"] * SERVE_CHUNK
        ttft = [round(sum(r["ttft_ms"]) / len(r["ttft_ms"]), 1)
                for r in res]
        log(f"{label} (bf16, {TINY_PATH_LAYERS} layers, {SERVE_SLOTS} "
            f"slots over {SS_CONTEXT}; first-token logits max abs diff "
            f"{d:.3e}, vs float32: ranks {d_ss:.3e}, one-rank {d_one:.3e}"
            f"): tokens held equal per request {held} of "
            f"{[len(t) for t in ref['tokens']]}, equal before the first "
            f"difference {same} (one-rank top-2 gap there {parting}); "
            f"engine schedule "
            f"{got['calls']}; per rank (the counted, audited run): "
            f"TTFT ms (mean over requests, queueing included) "
            f"{ttft} (one-rank "
            f"{sum(ref['ttft_ms']) / len(ref['ttft_ms']):.1f}), "
            f"wall {[round(r['wall_s'], 3) for r in res]} s (one-rank "
            f"{ref['wall_s']:.3f}), host staging "
            f"{[round(r['staged'][0], 3) for r in res]} s for "
            f"{[r['staged'][1] for r in res]} bytes in "
            f"{[r['staged'][2] for r in res]} copies, decode "
            f"{[round(steps / r['decode_s'], 2) for r in res]} steps/s "
            f"(one-rank {steps / ref['decode_s']:.2f}); launches per rank "
            f"{[_nonzero(r['launches']) for r in res]}")
    check(all(audit.get(k, [0])[0] > 0 for k in ("K1", "K1b", "K2")),
          "sharded serving: K1, K1 mode (b) and K2 calls held to their "
          "plain versions")
    log(f"sharded serving audit (calls, worst max abs err, worst share of a "
        f"limit, worst prompt mass err): {audit}")
    launches[f"float32_pipeline_{SS_RANKS}"] = {
        k: sum(r["pipe_f32"]["launches"][k] for r in ranks) for k in KERNELS}
    log(nvidia_smi_line())
    log(f"sharded serving phase: {time.perf_counter() - t0:.1f} s")
    return {"launches": launches, "audit": audit}


def _sharded_train_decoders_rank(rank: int, n: int, group, device, cfg,
                                 train_ids, prompt_ids, ref_tokens) -> dict:
    """One rank of phase_sharded_train_decoders, spawned on `device`
    (cuda:0) over a gloo group; every failed check raises. On the
    TSD_TRAIN_MESH: the one-rank trainer's TSD_TRAIN_STEPS steps on the
    whole float32 model (this rank's reference, cut to its slice), then
    the same steps on the rank's slice (`shard_params`), each step timed
    by CUDA events after a barrier, the peak memory of the sharded steps,
    no port kernel launched; the losses and the slice held to the
    reference's. On the TSD_DECODE_MESH: beam search and speculative
    decoding (oracle drafts: `ref_tokens`, one rank's greedy tokens, so
    that blocks of drafts commit; then the adaptive controller with
    adversarial drafts) over the rank's slice of another float32 model,
    launches exact per rank (K1 mode (a) once a layer a prefill, K2 once a
    layer and step of beam search and of the adaptive plain chunks), each
    timed. Returns host copies of what the parent compares."""
    import torch.distributed as dist

    from realtime_kv_cache_compression_tpu_torch import CompressionConfig
    from realtime_kv_cache_compression_tpu_torch.models import (
        beam_search, llama, speculative, train)
    from realtime_kv_cache_compression_tpu_torch.parallel import (
        create_mesh, shard_params)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    counted = functools.partial(_rank_counted, rank)
    train_mesh = create_mesh(*TSD_TRAIN_MESH)
    decode_mesh = create_mesh(*TSD_DECODE_MESH)
    out = {}

    # Training: the one-rank reference, then the rank's slice.
    params = llama.init_params(SEED + 50, cfg, dev)
    ids = train_ids.to(dev)
    ref = _map_tree(params, lambda t: t.clone())
    opt = train.make_optimizer(ref, lr=TSD_TRAIN_LR,
                               clip_norm=TSD_TRAIN_CLIP)
    ref_losses = [float(train.train_step(ref, opt, ids, cfg))
                  for _ in range(TSD_TRAIN_STEPS)]
    opt.release()
    ref_slice = _map_tree(dict(shard_params(ref, train_mesh, cfg)),
                          lambda t: t.detach().cpu())
    del ref, opt
    sp = shard_params(params, train_mesh, cfg)
    del params
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    opt = train.make_optimizer(sp, lr=TSD_TRAIN_LR,
                               clip_norm=TSD_TRAIN_CLIP)
    losses, norms, step_ms = [], [], []
    _zero_counts()
    for _ in range(TSD_TRAIN_STEPS):
        loss, reading = _rank_timed(group, lambda: train.train_step(
            sp, opt, ids, cfg))
        losses.append(float(loss))
        norms.append(float(opt.last_grad_norm))
        step_ms.append(reading["event_ms"])
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    launches = _launches()
    check(not any(launches.values()), f"rank {rank} sharded training: no "
                                      f"port kernel launched {launches}")
    worst, off, total = 0.0, 0, 0
    for (path, t), (ref_path, r) in zip(_leaf_items(dict(sp)),
                                        _leaf_items(ref_slice), strict=True):
        check(path == ref_path and t.shape == r.shape,
              f"rank {rank} sharded training: {path} against {ref_path}")
        err = (t.detach().cpu() - r).abs()
        worst = max(worst, float(err.max()))
        off += int((err > TOL_TRAIN_PARAMS).sum())
        total += err.numel()
    out["train"] = {"losses": losses, "ref_losses": ref_losses,
                    "norms": norms, "step_ms": step_ms, "peak_mb": peak_mb,
                    "params": (worst, off, total)}
    opt.release()
    del sp, opt
    torch.cuda.empty_cache()

    # The decoders over the rank's heads.
    layers = cfg.num_layers
    ccfg = CompressionConfig(num_layers=layers)
    sp = shard_params(llama.init_params(SEED + 51, cfg, dev), decode_mesh,
                      cfg)
    prompt = prompt_ids.to(dev)
    t = time.perf_counter()
    (seqs, scores, _), out["beam_launches"] = counted(
        "beam search", lambda: beam_search.beam_search(
            sp, prompt, cfg, ccfg, num_beams=BEAM_WIDTH,
            max_new_tokens=TSD_BEAM_TOKENS, return_all_beams=True),
        {"K1": layers, "K2": layers * (TSD_BEAM_TOKENS - 1)})
    out["beam"] = (seqs.cpu(), scores.cpu(), time.perf_counter() - t)
    (logits, state, _), pre = counted(
        "prefill", lambda: llama.prefill_compressed(
            sp, prompt, cfg, ccfg, max_decode_len=TSD_SPEC_STEPS + 16),
        {"K1": layers})
    first = torch.argmax(logits, -1)
    oracle, adversarial = _spec_proposers(ref_tokens.to(dev), TSD_SPEC_STEPS,
                                          cfg.vocab_size)
    t = time.perf_counter()
    (toks, _, stats), _ = counted(
        "speculative decoding", lambda: speculative.speculative_decode_loop(
            sp, first, llama.clone_decode_state(state), TSD_SPEC_STEPS, cfg,
            ccfg, prompt, n_draft=N_DRAFT, proposer=oracle), {})
    out["spec"] = (toks.cpu(), stats, time.perf_counter() - t)
    _zero_counts()
    toks_a, _, stats_a = speculative.adaptive_speculative_decode(
        sp, first, state, TSD_SPEC_STEPS, cfg, ccfg, prompt, n_draft=N_DRAFT,
        chunk=TSD_SPEC_CHUNK, proposer=adversarial)
    torch.cuda.synchronize()
    plain = sum(min(TSD_SPEC_CHUNK, TSD_SPEC_STEPS - i * TSD_SPEC_CHUNK)
                for i, (arm, _) in enumerate(stats_a["arms"])
                if arm == "plain")
    got = _launches()
    check(plain > 0 and got == {**{k: 0 for k in KERNELS},
                                "K2": layers * plain},
          f"rank {rank} adaptive speculative decoding: launches {got} "
          f"(K2 {layers} x {plain} plain tokens)")
    out["adaptive"] = (toks_a.cpu(), stats_a["arms"], got)
    out["decode_launches"] = {k: pre[k] + got[k] for k in KERNELS}
    dist.barrier(group)
    return out


def phase_sharded_train_decoders(device, mcfg) -> dict:
    """Training and the decoders over a sharded tree on this one card:
    TSD_RANKS ranks spawned as processes on cuda:0 over a gloo group (the
    collectives staged through the host; times measure overheads, not
    scaling), each rank's work `_sharded_train_decoders_rank`. TinyLlama's
    width (`mcfg`'s) at TSD_LAYERS layers, float32, random weights from
    SEED + 50 and SEED + 51.
    - Training on the TSD_TRAIN_MESH (data x model) mesh: TSD_TRAIN_STEPS
      `train_step`s on each rank's slice, the rows split over `data`; the
      losses the same on every rank and within TOL_TRAIN_LOSS of the
      one-rank trainer's, each rank's slice within TOL_TRAIN_PARAMS of
      the one-rank trainer's but for a TRAIN_SENSITIVE_SHARE of its
      elements and every element within one update's size (the rule of
      phase_parity_train); no port kernel launched; ms a step and peak MB
      a rank.
    - The decoders on the TSD_DECODE_MESH over each rank's heads: beam
      search (W=BEAM_WIDTH, TSD_BEAM_TOKENS tokens: K1 mode (a) once a
      layer, K2 once a layer and step), its sequences equal and scores
      within TOL_SCORE_REL relative to one rank's; speculative decoding
      with oracle drafts (one rank's greedy tokens, so that blocks of
      drafts commit; no kernel past the prefill's K1) and the
      adaptive controller with adversarial drafts (K2 once a layer and
      plain token), their tokens equal to one rank's `decode_loop`; every
      launch count exact per rank.
    Returns {"launches": per path, summed over the ranks}."""
    from realtime_kv_cache_compression_tpu_torch import CompressionConfig
    from realtime_kv_cache_compression_tpu_torch.models import (
        beam_search, llama, speculative)
    from realtime_kv_cache_compression_tpu_torch.parallel import run_ranks

    t0 = time.perf_counter()
    cfg = dataclasses.replace(
        mcfg, num_layers=TSD_LAYERS, dtype="float32",
        max_position_embeddings=TSD_PROMPT + TSD_SPEC_STEPS + 32)
    gen = torch.Generator().manual_seed(SEED + 52)
    train_ids = torch.randint(0, cfg.vocab_size,
                              (TSD_TRAIN_BATCH, TSD_TRAIN_SEQ), generator=gen)
    prompt = torch.randint(0, cfg.vocab_size, (1, TSD_PROMPT), generator=gen)

    # One rank's decoders on the whole model.
    ccfg = CompressionConfig(num_layers=TSD_LAYERS)
    params = llama.init_params(SEED + 51, cfg, device)
    p_dev = prompt.to(device)
    t = time.perf_counter()
    seqs1, scores1, _ = beam_search.beam_search(
        params, p_dev, cfg, ccfg, num_beams=BEAM_WIDTH,
        max_new_tokens=TSD_BEAM_TOKENS, return_all_beams=True)
    beam_s1 = time.perf_counter() - t
    logits, state, _ = llama.prefill_compressed(
        params, p_dev, cfg, ccfg, max_decode_len=TSD_SPEC_STEPS + 16)
    first = torch.argmax(logits, -1)
    greedy1, _ = llama.decode_loop(params, first,
                                   llama.clone_decode_state(state),
                                   TSD_SPEC_STEPS, cfg, ccfg)
    oracle, _ = _spec_proposers(greedy1, TSD_SPEC_STEPS, cfg.vocab_size)
    t = time.perf_counter()
    toks1, _, _ = speculative.speculative_decode_loop(
        params, first, state, TSD_SPEC_STEPS, cfg, ccfg, p_dev,
        n_draft=N_DRAFT, proposer=oracle)
    spec_s1 = time.perf_counter() - t
    check(torch.equal(toks1, greedy1), "one rank f32: speculative tokens "
                                       "equal to decode_loop's")
    seqs1, scores1, greedy1 = seqs1.cpu(), scores1.cpu(), greedy1.cpu()
    del params, state, logits
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    t1 = time.perf_counter()
    ranks = run_ranks(_sharded_train_decoders_rank, TSD_RANKS, args=(
        str(device), cfg, train_ids, prompt, greedy1), timeout=TSD_TIMEOUT)
    log(f"sharded training and decoders: {TSD_RANKS} ranks spawned, run "
        f"and joined in {time.perf_counter() - t1:.1f} s")

    mesh = "x".join(map(str, TSD_TRAIN_MESH))
    tr = [res["train"] for res in ranks]
    for r, res in enumerate(tr):
        check(res["losses"] == tr[0]["losses"],
              f"sharded training rank {r}: losses the same on every rank")
        for i, (got, want) in enumerate(zip(res["losses"],
                                            res["ref_losses"])):
            check(abs(got - want) <= TOL_TRAIN_LOSS,
                  f"sharded training rank {r} step {i}: loss {got:.7f} "
                  f"against one rank's {want:.7f}")
        worst, off, total = res["params"]
        check(worst <= TSD_TRAIN_LR and off <= TRAIN_SENSITIVE_SHARE * total,
              f"sharded training rank {r}: slice after {TSD_TRAIN_STEPS} "
              f"steps, worst difference {worst:.3e}, {off} of {total} "
              f"elements beyond {TOL_TRAIN_PARAMS:.0e}")
    log(f"sharded training ({mesh}, TinyLlama width, {TSD_LAYERS} layers, "
        f"float32, B={TSD_TRAIN_BATCH} x {TSD_TRAIN_SEQ}): losses "
        f"{tr[0]['losses']} against one rank's {tr[0]['ref_losses']}; "
        f"global grad norms {tr[0]['norms']} (clip {TSD_TRAIN_CLIP}); "
        f"worst parameter difference per rank "
        f"{[res['params'][0] for res in tr]}, elements beyond "
        f"{TOL_TRAIN_PARAMS:.0e} {[res['params'][1] for res in tr]} of "
        f"{[res['params'][2] for res in tr]}")
    log(f"sharded training ({TSD_RANKS} ranks on one card, overheads not "
        f"scaling): ms a step per rank (CUDA events) "
        f"{[[round(x, 2) for x in res['step_ms']] for res in tr]}; peak "
        f"{[round(res['peak_mb'], 1) for res in tr]} MB a rank")

    for r, res in enumerate(ranks):
        seqs, scores, _ = res["beam"]
        check(torch.equal(seqs, seqs1), f"sharded beam search rank {r}: "
                                        f"sequences equal to one rank's")
        rel = float(((scores - scores1).abs()
                     / scores1.abs().clamp_min(1e-30)).max())
        check(rel <= TOL_SCORE_REL, f"sharded beam search rank {r}: "
                                    f"scores within {rel:.3e} relative")
        check(torch.equal(res["spec"][0], greedy1),
              f"sharded speculative decoding rank {r}: tokens equal to one "
              f"rank's decode_loop")
        check(torch.equal(res["adaptive"][0], greedy1),
              f"sharded adaptive speculative decoding rank {r}: tokens "
              f"equal to one rank's decode_loop")
    dmesh = "x".join(map(str, TSD_DECODE_MESH))
    stats = ranks[0]["spec"][1]
    log(f"sharded decoders ({dmesh}, TinyLlama width, {TSD_LAYERS} layers, "
        f"float32, prompt {TSD_PROMPT}): beam search "
        f"W={BEAM_WIDTH} x {TSD_BEAM_TOKENS} tokens equal to one rank's on "
        f"every rank, {[round(res['beam'][2], 3) for res in ranks]} s a "
        f"rank against {beam_s1:.3f} s on one; speculative with oracle "
        f"drafts ({TSD_SPEC_STEPS} steps, {N_DRAFT} drafts, "
        f"{stats['iterations']} "
        f"forwards, draft rate {stats['draft_rate']:.3f}) equal to one "
        f"rank's decode_loop, {[round(res['spec'][2], 3) for res in ranks]} "
        f"s a rank against {spec_s1:.3f} s on one; adaptive with "
        f"adversarial drafts, arms {ranks[0]['adaptive'][1]}, K2 "
        f"{ranks[0]['adaptive'][2]['K2']} a rank")
    log(nvidia_smi_line())
    launches = {
        "tinyllama_sharded_train": {k: 0 for k in KERNELS},
        "tinyllama_sharded_decoders": {
            k: sum(res["beam_launches"][k] + res["decode_launches"][k]
                   for res in ranks) for k in KERNELS}}
    log(f"sharded decoders launches over the ranks: "
        f"{launches['tinyllama_sharded_decoders']}")
    log(f"sharded training and decoders phase: "
        f"{time.perf_counter() - t0:.1f} s")
    return {"launches": launches}


def phase_multihost(device) -> None:
    """The multi-process driver (`parallel/multihost.py`): two worker
    processes started with `subprocess` on this card, joined over a
    loopback TCP coordinator and gloo, each one rank of a 2 x 1 mesh,
    running JAX's SPMD and serving checks (tokens against the
    single-process path each computes itself, through K1 and K2)."""
    from realtime_kv_cache_compression_tpu_torch.parallel import (
        launch_local_sim)

    t0 = time.perf_counter()
    out = launch_local_sim(num_processes=2, arm="both", device=str(device),
                           timeout=300)
    check("MULTIHOST_SIM_OK" in out and out.count("token match = True") == 2,
          f"multihost: both checks passed on process 0:\n{out}")
    for line in out.splitlines():
        if line.startswith("[p0]"):
            log(f"multihost: {line}")
    log(f"multihost phase (2 processes, start to join): "
        f"{time.perf_counter() - t0:.1f} s")


def _map_tree(tree, fn):
    """`tree` with fn applied to every tensor: dicts, lists, tuples and
    dataclasses (caches, tiers) rebuilt, anything else kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(v, fn) for v in tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _map_tree(getattr(tree, f.name), fn)
            for f in dataclasses.fields(tree) if f.init})
    return tree


def _audit_serving(eng, prompts, label: str) -> dict:
    """One admission of `prompts` (ragged, padded to a power-of-two batch)
    into the engine's free slots and the one decode chunk that serves
    them (a token budget of SERVE_CHUNK + 1), every slot decoding, idle
    ones included, with each kernel call held to its plain version
    (`_held_to_plain`). Returns {kernel: worst max abs err}."""
    audit = {}
    with _held_to_plain(audit):
        rids = [eng.submit(p, max_new_tokens=SERVE_CHUNK + 1)
                for p in prompts]
        eng.run()
    check(all(len(eng.completed[r].tokens) == SERVE_CHUNK + 1 for r in rids),
          f"{label} audit: every request served")
    layers, b = eng.mcfg.num_layers, 1 << (len(prompts) - 1).bit_length()
    expect = {"K2": layers * SERVE_CHUNK,
              ("K1b" if eng.prefill_chunk else "K1"): layers * (
                  -(-max(map(len, prompts)) // eng.prefill_chunk)
                  if eng.prefill_chunk else 1)}
    check({k: v[0] for k, v in audit.items()} == expect,
          f"{label} audit: calls held to plain {audit} (expect {expect})")
    log(f"{label}: one admission of B={b} (prompts {[len(p) for p in prompts]}"
        f") and one decode chunk over {eng.num_slots} slots, every kernel "
        f"call held to its plain version: " + "; ".join(
            f"{k} {n} calls, max abs err {max(e, m):.3e}, worst element at "
            f"{s:.3f} of its limit" for k, (n, e, s, m) in audit.items()))
    return {k: max(v[1], v[3]) for k, v in audit.items()}


def _serving_parity_traffic(eng, prompts, shared, suffix) -> dict:
    """Six requests into four slots (the second and third one prompt: an
    in-batch duplicate), then the last prompt again (an exact prefix-cache
    hit) and `shared` + `suffix` after `register_prefix(shared)` (a partial
    hit); returns {label: request}."""
    rids = {f"r{i}": eng.submit(p) for i, p in enumerate(prompts)}
    eng.run()
    rids["exact"] = eng.submit(prompts[-1])
    eng.register_prefix(shared)
    rids["partial"] = eng.submit(shared + suffix)
    eng.run()
    return {k: eng.completed[r] for k, r in rids.items()}


def _standalone_serving(params, mcfg, ccfg, prompt, context: int,
                        ring_cap: int, new_tokens: int, chunk=None,
                        suffix=None):
    """One request alone at B=1 on the plain versions, as the engine serves
    it: the prompt right-padded to the `context` bucket with its length,
    `prefill_compressed` (or the chunked prefill in chunks of `chunk`),
    `extend_prefill` over `suffix` for a partial prefix hit, then greedy
    `decode_step`s. Returns (tokens, logits per token [n, V] on the host,
    kept ratio)."""
    from realtime_kv_cache_compression_tpu_torch.compression import (
        summarize_layer_stats)
    from realtime_kv_cache_compression_tpu_torch.models import (llama,
                                                                 speculative)

    dev = params["embed"].device
    ids = torch.tensor([prompt + [0] * (context - len(prompt))], device=dev)
    lens = torch.tensor([len(prompt)], dtype=torch.int32, device=dev)
    if chunk:
        logits, state, stats = llama.prefill_compressed_chunked(
            params, ids, mcfg, ccfg, chunk, max_decode_len=ring_cap,
            lengths=lens, use_flash=False)
    else:
        logits, state, stats = llama.prefill_compressed(
            params, ids, mcfg, ccfg, max_decode_len=ring_cap,
            use_flash=False, lengths=lens)
    if suffix:
        logits, state = speculative.extend_prefill(
            params, state, torch.tensor([suffix], device=dev),
            torch.tensor([len(suffix)], dtype=torch.int32, device=dev),
            mcfg, ccfg)
    out = [logits.float().cpu()]
    for _ in range(new_tokens - 1):
        logits, state = llama.decode_step(
            params, torch.argmax(logits, -1), state, mcfg, ccfg,
            use_fused=False)
        out.append(logits.float().cpu())
    logits = torch.cat(out)
    return (torch.argmax(logits, -1).tolist(), logits,
            summarize_layer_stats(stats)["avg_compression_ratio"])


def _held_to_reference(label: str, toks, ref_toks, ref_logits,
                       near: float = NEAR_TIE) -> int:
    """Tokens equal to the reference's up to its first near tie (top-2 gap
    below `near`, NEAR_TIE where float32 paths may part); returns how
    many were held."""
    top2 = torch.topk(ref_logits.float(), 2, dim=-1).values
    return _held_to_gaps(label, toks, ref_toks,
                         (top2[:, 0] - top2[:, 1]).tolist(), near)


def _held_to_gaps(label: str, toks, ref_toks, gaps, near: float) -> int:
    """`_held_to_reference` on the reference's top-2 logit gap behind each
    of its tokens."""
    for t, gap in enumerate(gaps[:len(ref_toks)]):
        if gap < near:
            log(f"{label}: step {t} is a near tie (reference top-2 gap "
                f"{gap:.3e}); tokens held to step {t - 1}")
            return t
        check(t < len(toks) and toks[t] == ref_toks[t],
              f"{label}: token {t} (reference top-2 gap {gap:.3e})")
    check(len(toks) == len(ref_toks), f"{label}: token count")
    return len(ref_toks)


def phase_parity_serving(device, mcfg, context: int = 1024,
                         new_tokens: int = 16, chunk: int = 256,
                         lengths=(300, 1000), shared: int = 900,
                         suffix: int = 40) -> None:
    """The serving engine in float32 at reduced depth (full width): 4
    slots over a `context`-token bucket, `new_tokens` tokens in decode
    chunks of 4, a prefix cache of 4 and a continuation budget of 64. The
    traffic: six requests of ragged lengths (`context` and `lengths`
    tokens; the second and third one prompt, an in-batch duplicate), then
    an exact resubmission and a prompt extending a registered
    `shared`-token prefix by `suffix` tokens. The engine on the kernels (K1, K2) against the same engine
    on the plain versions and against each request alone at B=1 on the
    plain versions (`_standalone_serving`): equal tokens up to a near tie
    of the reference, "length" stop reasons, per-row kept ratios within
    1e-6. Once one-shot, once with `prefill_chunk=chunk` (K1 mode (b); the
    references then prefill in chunks too, except the registered prefix,
    which `register_prefix` prefills in one shot)."""
    from realtime_kv_cache_compression_tpu_torch import CompressionConfig
    from realtime_kv_cache_compression_tpu_torch.models import llama
    from realtime_kv_cache_compression_tpu_torch.serving import ServingEngine

    mcfg = dataclasses.replace(mcfg, dtype="float32")
    ccfg = CompressionConfig(num_layers=mcfg.num_layers)
    params = llama.fuse_params(llama.init_params(SEED, mcfg, device))
    gen = torch.Generator().manual_seed(SEED + 11)

    def prompt(n):
        return torch.randint(1, mcfg.vocab_size, (n,), generator=gen).tolist()

    sizes = [context] + torch.randint(lengths[0], lengths[1] + 1, (4,),
                                      generator=gen).tolist()
    distinct = [prompt(n) for n in sizes]
    prompts = distinct[:2] + distinct[1:]  # the in-batch duplicate
    shared, suffix = prompt(shared), prompt(suffix)
    budget = 64
    kw = dict(num_slots=SERVE_SLOTS, context_len=context,
              max_new_tokens=new_tokens, decode_chunk=4, prefix_cache_size=4,
              prefix_continue_budget=budget)
    for prefill_chunk in (None, chunk):
        served = {}
        for kernels in (True, False):
            eng = ServingEngine(params, mcfg, ccfg, use_flash=kernels,
                                use_fused_decode=kernels,
                                prefill_chunk=prefill_chunk, **kw)
            served[kernels] = _serving_parity_traffic(eng, prompts, shared,
                                                      suffix)
            check(eng.summary()["prefix_cache"]["partial_hits"] == 1
                  and eng.prefix_hits == 2, "serving parity: prefix hits")
        mode = f"chunk {prefill_chunk}" if prefill_chunk else "one-shot"
        refs = {}
        for label, p, extra in [(f"r{i}", p, {}) for i, p in
                                enumerate(prompts)] + [
                ("exact", prompts[-1], {}),
                ("partial", shared, {"suffix": suffix})]:
            key = (tuple(p), bool(extra))
            if key not in refs:
                refs[key] = _standalone_serving(
                    params, mcfg, ccfg, p, context, new_tokens + budget,
                    new_tokens, chunk=None if extra else prefill_chunk,
                    **extra)
            ref_toks, ref_logits, ref_kept = refs[key]
            held = []
            for kernels in (True, False):
                req = served[kernels][label]
                what = (f"serving parity f32 {mode} {label} "
                        f"({'kernels' if kernels else 'plain'})")
                held.append(_held_to_reference(what, req.tokens, ref_toks,
                                               ref_logits))
                check(req.stop_reason == "length", f"{what}: stop reason")
                kept = req.prefill_stats["avg_compression_ratio"]
                check(abs(kept - ref_kept) <= 1e-6,
                      f"{what}: kept ratio {kept} vs alone {ref_kept}")
            a, b = (served[k][label].tokens for k in (True, False))
            n = min(held)
            check(a[:n] == b[:n], f"serving parity {mode} {label}: kernel "
                                  f"and plain engines")
            log(f"serving parity f32 {mode} {label} (length "
                f"{len(p) + len(extra.get('suffix', []))}): {n} of "
                f"{new_tokens} tokens held, kept ratio {ref_kept:.4f}, "
                f"engines equal {a == b}")
    del params
    torch.cuda.empty_cache()


def _serve_main(eng, traffic, label: str) -> dict:
    """Submit `traffic` ((prompt, token budget) pairs) at once and run the
    engine with every launch count
    set to 0 just before and read just after; launches held to the
    engine's schedule (K1 22 per one-shot prefill, K1 mode (b) 22 per
    chunk step, K2 22 per decode step: decode chunks x SERVE_CHUNK).
    Returns the readings (requests, launches, wall, TTFT, the largest gap
    between two deliveries to one request)."""
    calls = _engine_calls(eng)
    stamps = {}

    def on_token(req, _new):
        stamps.setdefault(req.rid, []).append(time.perf_counter())

    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    rids = [eng.submit(p, max_new_tokens=m, on_token=on_token)
            for p, m in traffic]
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    layers = eng.mcfg.num_layers
    expect = {**{key: 0 for key in KERNELS},
              "K1": layers * calls["prefill"],
              "K1b": layers * calls["chunk_step"],
              "K2": layers * SERVE_CHUNK * calls["decode"]}
    log(f"{label} launches: {launches} (expect {expect}; engine schedule "
        f"{calls})")
    check(launches == expect, f"{label}: launches per kernel")
    reqs = [eng.completed[r] for r in rids]
    check(all(len(r.tokens) == m and r.stop_reason == "length"
              for r, (_, m) in zip(reqs, traffic)),
          f"{label}: every request served in full")
    check(all(0.0 < r.prefill_stats["avg_compression_ratio"] < 1.0
              and all(-1e30 < x <= 0.0 for x in r.logprobs) for r in reqs),
          f"{label}: kept ratios in (0, 1), finite logprobs")
    ttft = sorted(r.ttft * 1e3 for r in reqs)
    gap = max(b - a for ts in stamps.values() for a, b in zip(ts, ts[1:]))
    tokens = sum(len(r.tokens) for r in reqs)
    log(f"{label}: {len(reqs)} requests, {tokens} tokens in {wall:.3f} s: "
        f"{tokens / wall:.1f} generated tok/s; TTFT ms median "
        f"{ttft[len(ttft) // 2]:.1f}, max {ttft[-1]:.1f} (in submission "
        f"order {[round(r.ttft * 1e3, 1) for r in reqs]}); largest gap "
        f"between deliveries to one request {gap * 1e3:.1f} ms")
    return {"requests": reqs, "launches": launches, "calls": calls,
            "gap_ms": gap * 1e3}


class _IdTokenizer:
    """Decodes each id to its own text, `<id>`, so that a reply's text
    stands for every token of it (the byte tokenizer drops the ids of
    TinyLlama's vocabulary above 255, most of a random model's)."""

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        return "".join(f"<{int(i)}>" for i in ids)


def phase_serving_path(device, mcfg) -> tuple:
    """The serving layer at full width and depth (bf16, fused raw weights
    from SEED): a `ServingEngine` of SERVE_SLOTS slots over a PROMPT-token
    bucket, up to SERVE_NEW_TOKENS greedy tokens in decode chunks of
    SERVE_CHUNK, a prefix cache of 8, logprobs on. `warmup()` first;
    TinyLlama's one-shot PROMPT-token prefill timed (the effective
    throughput behind `estimate_prefill_seconds`); then the main traffic
    (SERVE_PROMPTS distinct prompts of PROMPT/4-PROMPT tokens at once, token
    budgets of SERVE_NEW_TOKENS/4-SERVE_NEW_TOKENS: a first admission of
    four ragged rows, then slot refills while other slots decode) with
    exact launches; one engine step with an admission
    in flight under the profiler (host wall against device busy; the host
    time of `_start_admissions` and whether the prefill was done when it
    returned); 4 exact prefix hits (no K1, the first serving's tokens);
    one admission of three ragged prompts (B=4) and its decode chunk over
    every slot, idle ones included, with each K1 and K2 call held to its
    plain version (`_audit_serving`); a second engine with a registered SERVE_SHARED-token prefix and 4 prompts
    extending it by 64-SERVE_BUDGET tokens (4 partial hits, no K1); the
    main traffic again with `prefill_chunk=SERVE_PREFILL_CHUNK` (K1 mode
    (b), its largest delivery gap beside the one-shot engine's) and the
    same audit of one chunked admission; and a `CompletionServer` on port
    0 (`_IdTokenizer`): 4 concurrent token-id completions and one streamed,
    each reply's text, token count and logprobs those of the engine for
    the same prompt. Returns the launches of the one-shot and chunked
    main traffic, and the audits' worst error per kernel."""
    from realtime_kv_cache_compression_tpu_torch import CompressionConfig
    from realtime_kv_cache_compression_tpu_torch.models import llama
    from realtime_kv_cache_compression_tpu_torch.models.quantized_params \
        import params_num_weights
    from realtime_kv_cache_compression_tpu_torch.serving import (
        CompletionServer, ServingEngine, engine as serving_engine)
    from realtime_kv_cache_compression_tpu_torch.utils.tokenizer import (
        decode_ids)

    ccfg = CompressionConfig(num_layers=mcfg.num_layers)
    params = llama.fuse_params(llama.init_params(SEED, mcfg, device))
    gen = torch.Generator().manual_seed(SEED + 12)

    def prompt(n):
        return torch.randint(1, mcfg.vocab_size, (n,), generator=gen).tolist()

    kw = dict(num_slots=SERVE_SLOTS, context_len=PROMPT,
              max_new_tokens=SERVE_NEW_TOKENS, decode_chunk=SERVE_CHUNK,
              prefix_cache_size=8, logprobs=True)
    eng = ServingEngine(params, mcfg, ccfg, **kw)
    info = eng.warmup()
    log(f"serving warmup: batch sizes {info['batch_sizes']}, wall "
        f"{info['wall_s']:.3f} s")
    check(info["batch_sizes"] == [1, 2, 4] and eng.summary() == {
        "completed": 0} and not eng._prefix_cache, "warmup leaks nothing")

    ids = torch.tensor([prompt(PROMPT)], device=device)
    lens = torch.tensor([PROMPT], dtype=torch.int32, device=device)
    ms = sorted(_host_ms(lambda: eng._prefill(ids, lens), runs=4))
    n_weights = params_num_weights(params)
    flops = (2.0 * n_weights * PROMPT
             + 2.0 * mcfg.num_heads * PROMPT ** 2 * mcfg.head_dim)
    tf_s = flops / (ms[len(ms) // 2] / 1e3) / 1e12
    log(f"serving one-shot prefill B=1 S={PROMPT}: host ms {_spread(ms)}; "
        f"{flops / 1e12:.3f} TFLOP by estimate_prefill_seconds' formula: "
        f"effective {tf_s:.3f} TF/s (EFFECTIVE_TF_S "
        f"{serving_engine.EFFECTIVE_TF_S}); resolve_prefill_chunk at "
        f"{PROMPT}: {serving_engine.resolve_prefill_chunk(params, mcfg, PROMPT)}"
        f", at 32768: "
        f"{serving_engine.resolve_prefill_chunk(params, mcfg, 32768)}")

    lengths = torch.randint(PROMPT // 4, PROMPT + 1, (SERVE_PROMPTS,),
                            generator=gen).tolist()
    budgets = torch.randint(SERVE_NEW_TOKENS // 4, SERVE_NEW_TOKENS + 1,
                            (SERVE_PROMPTS,), generator=gen).tolist()
    traffic = [(prompt(n), m) for n, m in zip(lengths, budgets)]
    log(f"serving main traffic: prompt lengths {lengths}, token budgets "
        f"{budgets}")
    main = _serve_main(eng, traffic, "tinyllama serving")
    first = {tuple(p): r.tokens for (p, _), r in zip(traffic,
                                                     main["requests"])}

    # Exact prefix hits: four served prompts again, no prefill.
    calls = _engine_calls(eng)
    _zero_counts()
    hits_before = eng.prefix_hits
    rids = [eng.submit(p, max_new_tokens=m) for p, m in traffic[:4]]
    eng.run()
    launches = _launches()
    log(f"serving exact prefix hits launches: {launches} (schedule {calls})")
    check(eng.prefix_hits - hits_before == 4 and launches["K1"] == 0
          and launches["K2"] == mcfg.num_layers * SERVE_CHUNK
          * calls["decode"], "exact prefix hits: no K1, K2 per step")
    check(all(eng.completed[r].tokens == first[tuple(p)]
              for r, (p, _) in zip(rids, traffic)),
          "exact prefix hits: tokens of the first serving")
    audit_lengths = (PROMPT, PROMPT * 5 // 8, PROMPT * 3 // 8 + 1)
    errs = _audit_serving(eng, [prompt(n) for n in audit_lengths],
                          "tinyllama serving")

    # One engine step with one admission in flight: three slots decoding,
    # a fourth request admitted.
    for p in [prompt(PROMPT) for _ in range(SERVE_SLOTS - 1)]:
        eng.submit(p)
    eng.step()
    check(sum(eng._active_mask) == SERVE_SLOTS - 1, "three slots active")
    eng.submit(prompt(PROMPT))
    seen = {}
    start, poll = eng._start_admissions, eng._poll_inflight

    def timed_start(pairs):
        t0 = time.perf_counter()
        start(pairs)
        seen["start_ms"] = (time.perf_counter() - t0) * 1e3

    def first_poll(force=False):
        if "ready" not in seen:
            seen["ready"] = [ev is None or ev.query()
                             for *_, ev in eng._inflight]
        poll(force)

    eng._start_admissions, eng._poll_inflight = timed_start, first_poll
    _profile_window("tinyllama serving", "one engine step with an admission "
                    "in flight", eng.step)
    log(f"serving step: _start_admissions host {seen['start_ms']:.3f} ms; "
        f"prefill done at the first poll: {seen['ready']} (True: the "
        f"dispatch waited for the device, so async admission overlapped "
        f"nothing)")
    eng._start_admissions, eng._poll_inflight = start, poll
    eng.run()

    # HTTP: four concurrent completions and one streamed over this engine.
    import json
    import threading
    import urllib.request

    tok = _IdTokenizer()
    http = [prompt(PROMPT * k // 8) for k in range(2, 7)]
    replies, latency = {}, {}

    def post(i):
        body = {"prompt": http[i], "max_tokens": SERVE_NEW_TOKENS,
                "stream": i == 4}
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/v1/completions",
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=300) as r:
            if i < 4:
                replies[i] = json.loads(r.read())
            else:
                deltas = [json.loads(line[6:])["choices"][0]["text"]
                          for line in (raw.decode().strip() for raw in r)
                          if line.startswith("data: {")]
                replies[i] = "".join(deltas)
        latency[i] = (time.perf_counter() - t0) * 1e3

    with CompletionServer(eng, tok, host="127.0.0.1", port=0) as srv:
        threads = [threading.Thread(target=post, args=(i,))
                   for i in range(5)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        check(not any(t.is_alive() for t in threads) and len(replies) == 5,
              "http: every request answered")
    rids = [eng.submit(p) for p in http]  # exact hits: the served tokens
    eng.run()
    for i, r in enumerate(rids):
        req = eng.completed[r]
        text = decode_ids(tok, req.tokens)
        if i < 4:
            choice = replies[i]["choices"][0]
            check(choice["text"] == text
                  and replies[i]["usage"]["completion_tokens"]
                  == len(req.tokens) == SERVE_NEW_TOKENS
                  and choice["logprobs"]["token_logprobs"] == req.logprobs,
                  f"http request {i}: the engine's text, tokens, logprobs")
        else:
            check(replies[i] == text, "http stream: the engine's text")
    log(f"serving http: 5 requests (prompts {[len(p) for p in http]}, one "
        f"streamed), latency ms {[round(latency[i], 1) for i in range(5)]}; "
        f"text decoded id by id from {SERVE_NEW_TOKENS} tokens each")
    del eng
    torch.cuda.empty_cache()

    # Partial prefix hits: a registered shared prompt, four questions.
    eng = ServingEngine(params, mcfg, ccfg,
                        **{**kw, "prefix_continue_budget": SERVE_BUDGET})
    shared = prompt(SERVE_SHARED)
    _zero_counts()
    eng.register_prefix(shared)
    check(wrapper("K1").launches == mcfg.num_layers,
          "register_prefix: one prefill")
    calls = _engine_calls(eng)
    extend_ms = []
    cont = eng._continue_entry

    def timed_continue(rkey, key):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        entry = cont(rkey, key)
        torch.cuda.synchronize()
        extend_ms.append(round((time.perf_counter() - t0) * 1e3, 1))
        return entry

    eng._continue_entry = timed_continue
    _zero_counts()
    suffixes = [prompt(SERVE_BUDGET * k // 4) for k in range(1, 5)]
    t0 = time.perf_counter()
    rids = [eng.submit(shared + s) for s in suffixes]
    eng.run()
    wall = time.perf_counter() - t0
    launches = _launches()
    reqs = [eng.completed[r] for r in rids]
    log(f"serving partial prefix hits launches: {launches} (schedule "
        f"{calls}); TTFT ms {[round(r.ttft * 1e3, 1) for r in reqs]}, wall "
        f"{wall:.3f} s; extend_prefill host ms per suffix of "
        f"{[len(x) for x in suffixes]} tokens: {extend_ms}")
    check(eng.prefix_partial_hits == 4 and launches["K1"] == 0
          and launches["K2"] == mcfg.num_layers * SERVE_CHUNK
          * calls["decode"] and all(len(r.tokens) == SERVE_NEW_TOKENS
                                    for r in reqs),
          "partial prefix hits: no K1, K2 per step, every token")
    del eng
    torch.cuda.empty_cache()

    # Chunked admission: the main traffic in chunks of SERVE_PREFILL_CHUNK.
    eng = ServingEngine(params, mcfg, ccfg,
                        **{**kw, "prefill_chunk": SERVE_PREFILL_CHUNK})
    ends = []
    advance = eng._advance_chunked

    def recorded(rec):
        if not rec["st"].offset:
            ends.append(rec["end"] // SERVE_PREFILL_CHUNK)
        return advance(rec)

    eng._advance_chunked = recorded
    chunked = _serve_main(eng, traffic, "tinyllama serving chunked")
    check(chunked["calls"]["chunk_step"] == sum(ends),
          f"chunked admission: chunk steps cover each admission's longest "
          f"prompt ({ends})")
    for key, err in _audit_serving(
            eng, [prompt(n) for n in audit_lengths],
            "tinyllama serving chunked").items():
        errs[key] = max(errs.get(key, 0.0), err)
    log(f"serving largest gap between deliveries to one request: one-shot "
        f"{main['gap_ms']:.1f} ms, chunks of {SERVE_PREFILL_CHUNK} "
        f"{chunked['gap_ms']:.1f} ms")
    del eng, params
    torch.cuda.empty_cache()
    return {"tinyllama_serving": main["launches"],
            "tinyllama_serving_chunked": chunked["launches"]}, errs


# ---------------------------------------------------------------------------
# Training, the quality demo, the eval harness and the benchmark suite
# ---------------------------------------------------------------------------

def _check_no_kernels(label: str) -> dict:
    launches = _launches()
    log(f"{label} launches: {launches} (expect none)")
    check(not any(launches.values()), f"{label}: no kernel launched")
    return launches


def phase_parity_train(device, steps: int = 3, lr: float = 1e-3,
                       clip_norm: float = 0.5) -> None:
    """The trainer on the card against the trainer on the CPU: one float32
    2-layer model of width 256 (8 query heads over 2, d=32), the same
    params and batch, `steps` train steps at constant lr with the global
    clip triggered; the card's attention is SDPA with its backward, the
    CPU's the plain attention. Losses within TOL_TRAIN_LOSS; parameters
    within TOL_TRAIN_PARAMS but for at most a TRAIN_SENSITIVE_SHARE of
    their elements, and every element within one update's size (lr):
    Adam divides each gradient by its own running magnitude, so an element
    whose gradient sits at the rounding level of the float32 sums takes a
    step whose direction that rounding sets (tests/test_torch_train.py
    holds the port to JAX by the same share; between the card and the CPU
    such an element moved 1.7e-4 apart at lr 1e-3)."""
    from realtime_kv_cache_compression_tpu_torch import tiny_test_model
    from realtime_kv_cache_compression_tpu_torch.models import llama, train
    from realtime_kv_cache_compression_tpu_torch.models.quantized_params \
        import params_to

    mcfg = tiny_test_model(vocab_size=512, hidden_size=256,
                           intermediate_size=704, num_layers=2, num_heads=8,
                           num_kv_heads=2, head_dim=32,
                           max_position_embeddings=512)
    p_dev = llama.init_params(SEED, mcfg, device)
    p_cpu = params_to(copy.deepcopy(p_dev), "cpu")
    gen = torch.Generator(device=device).manual_seed(SEED + 11)
    ids = torch.randint(0, mcfg.vocab_size, (2, 256), generator=gen,
                        device=device)
    opt_dev = train.make_optimizer(p_dev, lr=lr, clip_norm=clip_norm)
    opt_cpu = train.make_optimizer(p_cpu, lr=lr, clip_norm=clip_norm)
    before = [t.detach().clone() for t in opt_dev.tensors]
    _zero_counts()
    for step in range(steps):
        loss_d = float(train.train_step(p_dev, opt_dev, ids, mcfg))
        loss_c = float(train.train_step(p_cpu, opt_cpu, ids.cpu(), mcfg))
        norm = float(opt_dev.last_grad_norm)
        log(f"parity train step {step}: loss card {loss_d:.7f}, cpu "
            f"{loss_c:.7f}; global grad norm {norm:.4f} (clip "
            f"{clip_norm})")
        check(abs(loss_d - loss_c) <= TOL_TRAIN_LOSS,
              f"parity train step {step}: loss")
        check(norm >= clip_norm, f"parity train step {step}: clip "
                                 f"triggered")
    _check_no_kernels("parity train")
    worst, off, total, moved = 0.0, 0, 0, 0.0
    for t_d, t_c, t0 in zip(opt_dev.tensors, opt_cpu.tensors, before):
        err = (t_d.detach().cpu() - t_c.detach()).abs()
        worst = max(worst, float(err.max()))
        off += int((err > TOL_TRAIN_PARAMS).sum())
        total += err.numel()
        moved = max(moved, float((t_d.detach() - t0).abs().max()))
    log(f"parity train: parameters after {steps} steps, worst difference "
        f"{worst:.3e}, {off} of {total} elements beyond "
        f"{TOL_TRAIN_PARAMS:.0e}; largest move {moved:.3e}")
    check(worst <= lr and off <= TRAIN_SENSITIVE_SHARE * total
          and moved > lr, "parity train: parameters")


def _sdpa_backends(mcfg, device) -> dict:
    """Which SDPA backends take TinyLlama's heads (bf16, enable_gqa) with a
    backward: forward and backward under each backend alone."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    gen = torch.Generator(device=device).manual_seed(SEED + 12)
    shape = lambda h: (1, h, 512, mcfg.head_dim)  # noqa: E731
    q = torch.randn(shape(mcfg.num_heads), generator=gen, device=device,
                    dtype=torch.bfloat16, requires_grad=True)
    k, v = (torch.randn(shape(mcfg.num_kv_heads), generator=gen,
                        device=device, dtype=torch.bfloat16,
                        requires_grad=True) for _ in range(2))
    out = {}
    for backend in (SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([backend]):
                torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True).sum().backward()
            torch.cuda.synchronize()
            out[backend.name] = "ok"
        except RuntimeError as e:
            out[backend.name] = f"refused ({str(e).splitlines()[0][:80]})"
    return out


def phase_train_path(device, mcfg, steps: int = TRAIN_STEPS) -> dict:
    """The trainer at TinyLlama's full width and depth: raw bf16 params
    from SEED, AdamW at constant lr TRAIN_LR with the global clip, `steps`
    train steps on one repeated batch of B=1 x TRAIN_SEQ tokens. Every
    loss finite and the last below the first; ms per step (CUDA events,
    the steps after the first), training tokens/s, peak MB; no kernel of
    the port's (SDPA forward and backward, cuBLAS, ATen); the last step
    under the profiler (its heaviest kernels name SDPA's backend), and
    which SDPA backends take these heads with a backward."""
    from realtime_kv_cache_compression_tpu_torch.models import llama, train

    params = llama.init_params(SEED, mcfg, device)
    gen = torch.Generator(device=device).manual_seed(SEED + 13)
    ids = torch.randint(0, mcfg.vocab_size, (1, TRAIN_SEQ), generator=gen,
                        device=device)
    opt = train.make_optimizer(params, lr=TRAIN_LR)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    losses, ms = [], []
    for step in range(steps - 1):
        loss, t = cuda_ms(lambda: train.train_step(params, opt, ids, mcfg))
        losses.append(float(loss))
        ms.append(t)
    _profile_window("tinyllama", "train step", lambda: losses.append(
        float(train.train_step(params, opt, ids, mcfg))), top=8)
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    launches = _check_no_kernels("tinyllama train")
    log(f"tinyllama train (B=1, S={TRAIN_SEQ}, bf16, lr {TRAIN_LR}): losses "
        f"{[round(x, 4) for x in losses]}; ms per step (steps 2-{steps - 1}) "
        f"{_spread(ms[1:])}; training tok/s {TRAIN_SEQ / (min(ms[1:]) / 1e3):.1f}"
        f"; peak memory {peak_mb:.1f} MB; first step {ms[0]:.1f} ms")
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          "tinyllama train: finite losses, the last below the first")
    log(f"SDPA backends with enable_gqa and a backward at TinyLlama's "
        f"heads (bf16): {_sdpa_backends(mcfg, device)}")
    opt.release()
    del params, opt
    torch.cuda.empty_cache()
    return launches


def _greedy_from(params, logits, state, mcfg, ccfg, steps: int,
                 kernels: bool, slot_group=None):
    """Greedy decode of `steps` steps from a prefill's logits and state, one
    step at a time, on K2 or on its plain version (with `slot_group`, from
    a slot-sharded state with no gather): (tokens [B, steps + 1], logits
    [B, steps + 1, V]) on the host. Updates `state` in place."""
    from realtime_kv_cache_compression_tpu_torch.models import llama

    out = [logits.float().cpu()]
    for _ in range(steps):
        logits, state = llama.decode_step(params, torch.argmax(logits, -1),
                                          state, mcfg, ccfg,
                                          use_fused=kernels,
                                          slot_group=slot_group)
        out.append(logits.float().cpu())
    logits = torch.stack(out, dim=1)
    return torch.argmax(logits, -1), logits


def _selection_drift(label: str, records: dict, caches: list, ccfg,
                     s: int, limit=TOL_LOGITS) -> dict:
    """Where the kernel prefill (records[True], caches[0]) and the plain
    prefill (records[False], caches[1]) keep other positions, holds the
    difference to the scores the compressor ranked. Per layer, the two
    runs' importance scores (from the recorded prompt and query masses)
    lie within `limit` of each other (a float, or one per layer;
    TOL_LOGITS, the limit of the two
    float32 paths' logits: their rounding drifts through the layers: layer
    0's scores agree exactly where they come from the plain query mass,
    and the query-guided scores of a trained recall model sit 1.46e-5
    apart by layer 1; bf16 paths pass their own); delta is their largest
    difference.
    The kept tokens are a prefix of one score order and the tiers are
    ranks in it, so a token changes tier only across a tier boundary, and
    then its plain score lies within 2 delta of the plain score at that
    boundary's rank (a rank reversal between near-equal scores). The tiers
    hold as many tokens in both runs, except the last where a precision
    label flips (the bytes a token costs, from theta_h and theta_m) and
    the budget's cutoff moves; that boundary is then not held. Returns
    {"rows": rows that keep other positions in some layer, "log": a
    summary}."""
    from realtime_kv_cache_compression_tpu_torch.compression.compressor \
        import identify_prompt_length
    from realtime_kv_cache_compression_tpu_torch.ops.importance import (
        importance_scores)
    from realtime_kv_cache_compression_tpu_torch.ops.quantization import (
        assign_precision)

    plen = identify_prompt_length(s, ccfg)
    rows, deltas, moves, worst, recounts = set(), [], 0, 0.0, 0
    for li, (ck, cp) in enumerate(zip(*caches)):
        sk, sp = (importance_scores(records[k][(li, 0)][0], li, s, plen,
                                    ccfg, query_mass=records[k][(li, 0)][2])
                  for k in (True, False))
        delta = float((sk.double() - sp.double()).abs().max())
        deltas.append(delta)
        lim = limit[li] if isinstance(limit, (list, tuple)) else limit
        check(delta <= lim, f"{label} layer {li}: scores of the two "
                            f"prefills {delta:.3e} apart (limit "
                            f"{lim:.1e})")
        flips = assign_precision(sk, ccfg)[0] != assign_precision(sp, ccfg)[0]
        sp = sp.double()
        for r in range(sp.shape[0]):
            tiers = [{}, {}]  # position -> tier, kernel and plain
            for c, t_of in zip((ck, cp), tiers):
                for ti, t in enumerate(c.tiers):
                    t_of.update(dict.fromkeys(
                        t.positions[r][t.valid[r]].tolist(), ti))
            if tiers[0] == tiers[1]:
                continue
            rows.add(r)
            sizes = [[int(t.valid[r].sum()) for t in c.tiers]
                     for c in (ck, cp)]
            recount = sizes[0][-1] != sizes[1][-1]
            recounts += recount
            check(sizes[0][:-1] == sizes[1][:-1]
                  and (not recount or bool(flips[r].any())),
                  f"{label} layer {li} row {r}: tier sizes {sizes} (the "
                  f"last moves only with a precision label flip)")
            order = torch.argsort(-sp[r], stable=True)
            bounds = [sum(sizes[1][:i + 1]) for i in range(len(sizes[1]))]
            dropped = len(sizes[1])
            for pos in set(tiers[0]) | set(tiers[1]):
                a, b = (t_of.get(pos, dropped) for t_of in tiers)
                for cut in bounds[min(a, b):max(a, b)]:
                    if recount and cut == bounds[-1]:
                        continue
                    gap = abs(float(sp[r, pos] - sp[r, order[cut - 1]]))
                    moves += 1
                    worst = max(worst, gap / (2 * delta) if delta
                                else float("inf"))
                    check(gap <= 2 * delta,
                          f"{label} layer {li} row {r}: position {pos} "
                          f"moves from tier {b} to {a}, its plain score "
                          f"{gap:.3e} from the boundary's (2 delta "
                          f"{2 * delta:.3e})")
    shown = (f"{limit:.1e}" if not isinstance(limit, (list, tuple)) else
             f"per layer {[f'{x:.1e}' for x in limit]}")
    return {"rows": rows, "deltas": deltas, "log": (
        f"score delta per layer {[f'{d:.2e}' for d in deltas]} (limit "
        f"{shown}), {moves} tier boundary crossings at worst "
        f"{worst:.3f} of 2 delta from the boundary's score, {recounts} "
        f"kept counts moved by a label flip")}


def phase_quality_demo(device) -> dict:
    """The port's quality demo at the JAX package's r4 recall settings
    (QUALITY_DEMO_ARGS): the port's trainer on payload recall, then recall
    through every arm at fillers 48, 112 and 240 on K1 and K2 (float32,
    d=32, n_rep 2), launches held to the demo's own schedule (one prefill
    of the 64 samples per arm and filler, `payload - 1` decode steps per
    compressed arm). The uncompressed baseline must reach 0.95 at filler
    48 (else the trainer did not learn). At filler 240, for each of
    QUALITY_KERNEL_ARMS: every K1 and K2 call of its kernel run is held to
    the plain version on its own inputs (`_held_to_plain`: float32 outputs
    scaled by the activations' magnitude, the prompt mass to TOL_MASS);
    the kernel and plain prefills' logits agree within TOL_LOGITS; on the
    kernel prefill's cache the K2 decode's tokens are held to the plain
    decode's, row by row, up to a near tie of its logits; on every row
    whose two prefills keep the same positions in every layer and tier,
    the kernel path's tokens are held to the plain path's the same way;
    and where they keep other positions, the difference is held to the
    two runs' importance scores (`_selection_drift`: scores within
    TOL_LOGITS, a token changes tier only within 2 delta of its
    boundary's score).
    The two paths' recall is printed side by side with the rows whose
    tokens part. The arm table is printed
    beside the JAX package's r4 artifact (QUALITY_R4_ARTIFACT, a CPU run
    of 2500 steps with other random draws), with every arm that differs
    by more than 0.15 named. The artifact and the trained weights are
    left in build/quality_demo (scripts/torch_quality_crosscheck.py
    evaluates those weights through both packages on the CPU)."""
    import shutil

    from realtime_kv_cache_compression_tpu_torch.experiments import (
        quality_demo)
    from realtime_kv_cache_compression_tpu_torch.models import llama

    out_dir = "build/quality_demo"  # the artifact and the trained weights
    shutil.rmtree(out_dir, ignore_errors=True)
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    run = quality_demo.main(QUALITY_DEMO_ARGS + [
        "--device", device, "--output-dir", out_dir,
        "--params-dir", f"{out_dir}/params"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    results, mcfg = run["results"], run["mcfg"]
    payload = results["meta"]["payload"]
    rows = {k: v for k, v in results.items() if k.startswith("recall_")}
    dropped = results.get("uninformative_rows", {})
    prefills = sum(len(r) for r in rows.values()) + len(dropped)
    decodes = sum(len(r) - 1 for r in rows.values())
    layers = mcfg.num_layers
    expect = {**{key: 0 for key in KERNELS}, "K1": layers * prefills,
              "K2": layers * (payload - 1) * decodes}
    log(f"quality demo launches: {launches} (expect {expect}: {prefills} "
        f"prefills, {decodes} compressed decodes of {payload - 1} steps)")
    check(launches == expect, "quality demo: launches per kernel")
    log(f"quality demo: trained in {run['train_seconds'].get('recall')} s "
        f"({results['meta']['steps']} steps), whole run {wall:.1f} s; "
        f"uninformative rows {sorted(dropped)}")
    check("recall_filler48" in rows and
          rows["recall_filler48"]["baseline_fp"]["token_accuracy"] >= 0.95,
          "quality demo: baseline_fp >= 0.95 at filler 48 (the trainer "
          "learns)")

    with open(QUALITY_R4_ARTIFACT) as f:
        r4 = json.load(f)
    apart = []
    for key, row in rows.items():
        log(f"quality demo {key}: arm, port acc / kept (card), JAX r4 acc "
            f"/ kept (CPU)")
        for arm, r in row.items():
            j = r4.get(key, {}).get(arm, {})
            ja = j.get("token_accuracy")
            flag = ""
            if ja is not None and abs(r["token_accuracy"] - ja) > 0.15:
                apart.append(f"{key}/{arm}")
                flag = "  <- differs by more than 0.15"
            log(f"  {arm:22s} {r['token_accuracy']:.3f} / "
                f"{r.get('kept_ratio', 1.0):.3f}   "
                f"{'n/a' if ja is None else f'{ja:.3f}'} / "
                f"{j.get('kept_ratio', 1.0):.3f}{flag}")
    log(f"quality demo: arms more than 0.15 from JAX's r4 numbers: "
        f"{apart or 'none'}")

    # Kernels against their plain versions on the longest filler: every
    # K1 and K2 call of each arm's kernel run held to its plain version on
    # its own inputs, then the whole path against the plain path.
    filler = max(int(x) for x in QUALITY_DEMO_ARGS[
        QUALITY_DEMO_ARGS.index("--fillers") + 1].split(","))
    n_eval = results["meta"]["eval_samples"]
    params = run["params"]["recall"]
    arms = quality_demo.arm_configs(layers, payload)
    ids, prompt_len, _ = quality_demo.eval_ids(
        mcfg, "recall", n_eval, payload, filler, device=device)
    prompt = ids[:, :prompt_len]
    for arm in QUALITY_KERNEL_ARMS:
        audit = {}
        with _held_to_plain(audit):
            kern = quality_demo.recall_accuracy(
                params, mcfg, arms[arm], "recall", n_eval, payload, filler,
                return_tokens=True)
        calls = {k: v[0] for k, v in audit.items()}
        check(calls == {"K1": layers, "K2": layers * (payload - 1)},
              f"quality demo {arm}: kernel calls held to plain {calls}")
        plain = quality_demo.recall_accuracy(
            params, mcfg, arms[arm], "recall", n_eval, payload, filler,
            use_flash=False, return_tokens=True)
        runs, records = {}, {}
        original = llama.compress_layer_kv
        for kernels in (True, False):
            records[kernels] = {}
            llama.compress_layer_kv = _recording_compress(original,
                                                          records[kernels])
            try:
                logits, state, _ = llama.prefill_compressed(
                    params, prompt, mcfg, arms[arm], max_decode_len=payload,
                    use_flash=kernels)
            finally:
                llama.compress_layer_kv = original
            runs[kernels] = (logits, state)
        err = max_err(runs[True][0], runs[False][0])
        check(err <= TOL_LOGITS, f"quality demo {arm}: prefill logits")
        ref_toks, ref_logits = _greedy_from(params, *runs[False], mcfg,
                                            arms[arm], payload - 1, False)
        check(torch.equal(ref_toks, plain["tokens"]),
              f"quality demo {arm}: the plain path's tokens")
        drift = _selection_drift(f"quality demo {arm}", records,
                                 [runs[k][1].caches for k in (True, False)],
                                 arms[arm], prompt_len)
        # K2 against its plain version on one cache: the kernel prefill's.
        shared = llama.clone_decode_state(runs[True][1])
        k2_toks, _ = _greedy_from(params, *runs[True], mcfg, arms[arm],
                                  payload - 1, True)
        check(torch.equal(k2_toks, kern["tokens"]),
              f"quality demo {arm}: the kernel path's tokens")
        p_toks, p_logits = _greedy_from(params, runs[True][0], shared, mcfg,
                                        arms[arm], payload - 1, False)
        for r in range(n_eval):
            _held_to_reference(f"quality demo {arm} row {r} (K2 on the "
                               f"kernel prefill's cache)",
                               k2_toks[r].tolist(), p_toks[r].tolist(),
                               p_logits[r])
        # The whole path where the two prefills keep the same positions.
        alike = [r for r in range(n_eval) if r not in drift["rows"]]
        for r in alike:
            _held_to_reference(f"quality demo {arm} row {r} (caches keep "
                               f"the same positions)",
                               kern["tokens"][r].tolist(),
                               ref_toks[r].tolist(), ref_logits[r])
        apart = torch.nonzero((kern["tokens"] != ref_toks).any(1))
        log(f"quality demo {arm} at filler {filler}: recall on K1/K2 "
            f"{kern['token_accuracy']:.4f}, on the plain versions "
            f"{plain['token_accuracy']:.4f} (in the run "
            f"{rows[f'recall_filler{filler}'][arm]['token_accuracy']:.4f}); "
            f"{calls} kernel calls held to their plain versions (worst "
            f"output max abs err "
            f"{({k: f'{v[1]:.3e}' for k, v in audit.items()})}, worst "
            f"share of a limit "
            f"{({k: f'{v[2]:.3f}' for k, v in audit.items()})}, K1 prompt "
            f"mass {audit['K1'][3]:.3e} against TOL_MASS {TOL_MASS:.0e}); "
            f"prefill logits max err {err:.3e}; K2 on the kernel prefill's "
            f"cache held to the plain decode on every row; {len(alike)} of "
            f"{n_eval} rows keep the same positions in every layer, their "
            f"tokens held to the plain path's; the others: {drift['log']}; "
            f"tokens apart in rows {apart.flatten().tolist()}")
    del run, params
    torch.cuda.empty_cache()
    return launches


def _eval_experiment(label: str, argv: list, layers: int) -> dict:
    """The port's run_compression_experiment in-process with every launch
    count set to 0 just before and read just after, held to its runners'
    own schedule: K1 `layers` a prefill call (warm-ups included) in both
    arms, K2 `layers` a decode step in the compressed arm."""
    from realtime_kv_cache_compression_tpu_torch.eval.longbench import (
        recorded_errors)
    from realtime_kv_cache_compression_tpu_torch.experiments import (
        run_compression_experiment)

    run, launches, _ = _cli_launches(
        label, lambda: run_compression_experiment.main(argv),
        lambda run: {"K1": layers * sum(c["prefill"] for c in
                                        run["model_calls"].values()),
                     "K2": layers
                     * run["model_calls"]["compressed"]["decode_steps"]})
    log(f"{label}: runner schedule {run['model_calls']}")
    errors = [(arm, *e) for arm, r in run["results"].items()
              for e in recorded_errors(r)]
    check(not errors, f"{label}: no evaluation error ({errors[:2]})")
    for arm, r in run["results"].items():
        for task, t in r["per_task"].items():
            check(t["num_evaluated"] == t["num_samples"] > 0,
                  f"{label} {arm} {task}: every sample evaluated")
            log(f"{label} {arm} {task}: {t['num_evaluated']} samples, "
                f"context {[d['context_length'] for d in t['details']]}, "
                f"TTFT ms {[round(d['ttft'] * 1e3, 1) for d in t['details']]}"
                f", decode tok/s "
                f"{[round(d['tokens_per_second'], 1) for d in t['details']]}"
                f", kept ratio {t.get('avg_compression_ratio')}, memory "
                f"savings {t.get('avg_memory_savings')}, quality "
                f"{t['metrics'].get('quality')}")
        log(f"{label} {arm} overall: {r['overall']}; memory monitor "
            f"{r['memory_monitor']}")
    return launches


def _eval_f32_check(device, mcfg) -> None:
    """The eval runner in float32 at 2 layers of full width: one ragged
    batch of two synthetic prompts run batched and one at a time, on K1 and
    K2 and on the plain versions, every one held to the plain batched
    path's tokens up to a near tie of its logits."""
    from realtime_kv_cache_compression_tpu_torch import CompressionConfig
    from realtime_kv_cache_compression_tpu_torch.eval import longbench
    from realtime_kv_cache_compression_tpu_torch.models import llama
    from realtime_kv_cache_compression_tpu_torch.utils import data
    from realtime_kv_cache_compression_tpu_torch.utils.tokenizer import (
        ByteTokenizer)

    tok = ByteTokenizer()
    task = data.LONGBENCH_TASKS["narrativeqa"]
    prompts = [data.truncate_middle(tok.encode(data.format_prompt(task, s)),
                                    EVAL_MAX_LENGTH)
               for s in data.synthetic_task_data(
                   "narrativeqa", 2, context_words=EVAL_CONTEXT_WORDS)]
    bucket = longbench.pick_bucket(max(map(len, prompts)), EVAL_MAX_LENGTH)
    ids = torch.tensor([p + [0] * (bucket - len(p)) for p in prompts],
                       device=device)
    lengths = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                           device=device)
    params = llama.init_params(SEED, mcfg, device)
    ccfg = CompressionConfig(num_layers=mcfg.num_layers)
    n = EVAL_NEW_TOKENS
    # The plain reference with its logits at every step.
    logits, state, _ = llama.prefill_compressed(
        params, ids, mcfg, ccfg, max_decode_len=n, use_flash=False,
        lengths=lengths)
    ref, ref_logits = _greedy_from(params, logits, state, mcfg, ccfg, n - 1,
                                   False)
    for kernels in (None, False):
        runner = longbench.ModelRunner(params, mcfg, ccfg, use_flash=kernels,
                                       max_new_tokens=n)
        batched = runner.generate(ids, lengths=lengths)["tokens"]
        for r in range(len(prompts)):
            alone = runner.generate(ids[r:r + 1, :bucket],
                                    lengths=lengths[r:r + 1])["tokens"][0]
            for what, toks in (("batched", batched[r]), ("alone", alone)):
                held = _held_to_reference(
                    f"eval f32 {'kernels' if kernels is None else 'plain'} "
                    f"{what} row {r}", toks.tolist(), ref[r].tolist(),
                    ref_logits[r])
                log(f"eval f32 ({'K1/K2' if kernels is None else 'plain'}, "
                    f"{what}, row {r}, length {len(prompts[r])}): {held} of "
                    f"{n} tokens held to the plain batched path")
    del params
    torch.cuda.empty_cache()


def phase_eval_path(device, mcfg) -> dict:
    """The LongBench harness at TinyLlama's full width (bf16; the depth of
    `mcfg`, TINY_PATH_LAYERS in the smoke):
    the port's run_compression_experiment entry point in-process
    (`--model tinyllama --baseline`, narrativeqa and gov_report, 2
    synthetic samples each of EVAL_CONTEXT_WORDS words, so the prompts are
    ragged below the EVAL_MAX_LENGTH bucket, EVAL_NEW_TOKENS new tokens),
    one sample at a time and then in ragged batches of 2. Launches held to
    the runners' schedules, no `error` detail, every sample evaluated;
    TTFT, tok/s, kept ratio and memory savings printed, with the ROUGE
    scorer that ran. The loader's HF hub branch is marked unavailable
    first, so the synthetic tasks run with no network attempt where the
    `datasets` package is installed. Then the float32 check at 2 layers
    (`_eval_f32_check`)."""
    import importlib.util
    import tempfile

    from realtime_kv_cache_compression_tpu_torch.eval import metrics
    from realtime_kv_cache_compression_tpu_torch.utils import data

    # The loader would try the HF hub where `datasets` is installed: the
    # smoke needs no network, so it marks the hub unavailable.
    data._HUB_UNAVAILABLE = True
    log(f"eval path: ROUGE scorer {metrics.rouge_backend()}; datasets "
        f"package {'present' if importlib.util.find_spec('datasets') else 'absent'}, "
        f"the HF hub not tried: synthetic LongBench tasks")
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        for batch in (1, 2):
            argv = ["--model", "tinyllama", "--layers",
                    str(mcfg.num_layers), "--device", device, "--baseline",
                    "--tasks", "narrativeqa", "gov_report",
                    "--max-samples", "2",
                    "--max-new-tokens", str(EVAL_NEW_TOKENS),
                    "--max-length", str(EVAL_MAX_LENGTH),
                    "--synthetic-context-words", str(EVAL_CONTEXT_WORDS),
                    "--eval-batch", str(batch), "--output-dir", tmp,
                    "--experiment-name", f"batch{batch}"]
            launches[f"tinyllama_eval_batch{batch}"] = _eval_experiment(
                f"eval (batch {batch})", argv, mcfg.num_layers)
    torch.cuda.empty_cache()
    _eval_f32_check(device, dataclasses.replace(mcfg, num_layers=2,
                                                dtype="float32"))
    return launches


def phase_benchmark_suite(device, mcfg) -> dict:
    """The port's CompressionBenchmark at TinyLlama's full width (the depth
    of `mcfg`, TINY_PATH_LAYERS in the smoke)
    (bf16 params from `init_params(0)`): all six named scenarios at
    sequence length PROMPT, 50 new tokens, B=1. No scenario errors; every
    record printed with the device's memory statistics; launches held to
    the suite's schedule: per scenario one warm-up and three timed
    prefills (K1), and per compressed scenario one warm-up and three timed
    decode loops of 49 steps (K2)."""
    import os
    import tempfile

    from realtime_kv_cache_compression_tpu_torch.eval import benchmark_runner
    from realtime_kv_cache_compression_tpu_torch.utils.memory import (
        device_memory_stats)

    new_tokens = 50
    scenarios = benchmark_runner.named_scenarios(mcfg.num_layers)
    with tempfile.TemporaryDirectory() as tmp:
        bench = benchmark_runner.CompressionBenchmark(
            mcfg, output_dir=tmp, seq_lens=(PROMPT,), new_tokens=new_tokens,
            device=device)
        torch.cuda.synchronize()
        _zero_counts()
        results = bench.run_full_benchmark()
        torch.cuda.synchronize()
        launches = _launches()
        artifacts = sorted(os.listdir(tmp))
    layers, runs = mcfg.num_layers, 4  # a warm-up and best of 3
    compressed = sum(c is not None for c in scenarios.values())
    expect = {**{key: 0 for key in KERNELS},
              "K1": layers * runs * len(scenarios),
              "K2": layers * runs * (new_tokens - 1) * compressed}
    log(f"benchmark suite launches: {launches} (expect {expect}); "
        f"artifacts {artifacts}; round trip {bench.rtt * 1e6:.1f} us")
    check(launches == expect, "benchmark suite: launches per kernel")
    for name, res in results.items():
        for rec in res["per_seq_len"]:
            log(f"benchmark suite {name}: {rec}")
            check("error" not in rec, f"benchmark suite {name}: no error")
    log(f"benchmark suite: device memory {device_memory_stats(device)}")
    del bench
    torch.cuda.empty_cache()
    return launches


def _cli_launches(label: str, run_cli, expect_of) -> tuple:
    """One CLI run in-process with every launch count set to 0 just before
    and read just after, held to the launches its own schedule gives
    (`expect_of(run)`: kernel -> count; the others 0). Returns (the run's
    result, the launches, wall seconds)."""
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    run = run_cli()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    expect = {**{key: 0 for key in KERNELS}, **expect_of(run)}
    log(f"{label} launches: {launches} (expect {expect}); {wall:.1f} s")
    check(launches == expect, f"{label}: launches per kernel")
    return run, launches, wall


def _audit_line(label: str, audit: dict, expect: dict) -> None:
    """Checks the calls `_held_to_plain` held against `expect` and logs
    their worst errors."""
    calls = {k: v[0] for k, v in audit.items()}
    check(calls == expect, f"{label}: kernel calls held to plain {calls} "
                           f"(expect {expect})")
    log(f"{label}: every kernel call held to its plain version: " + "; ".join(
        f"{k} {n} calls, max abs err {e:.3e}, worst element at {sh:.3f} of "
        f"its limit, prompt mass {m:.3e}"
        for k, (n, e, sh, m) in audit.items()))


def _worst(into: dict, audit: dict) -> None:
    for k, v in audit.items():
        into[k] = max(into.get(k, 0.0), v[1], v[3])


def phase_ablation(device, mcfg, errors: dict) -> dict:
    """The port's ablation_study CLI at TinyLlama's full width (the depth
    of `mcfg`, TINY_PATH_LAYERS in the smoke, through `--layers`)
    (bf16, its own `init_params(0)`): the five studies' configs held to
    ABLATION_CONFIGS; then `--study component` and `--study bits`
    (ABLATION_ARGS: narrativeqa and qasper, 1 synthetic sample each, cut
    from the CLI's 10, max length 1024, 16 new tokens), launches held to
    its runners' schedule, no error row. Then each config of both studies
    once through the runner on one synthetic prompt of the max length
    (ABLATION_AUDIT_TOKENS new tokens) with every K1 and K2 call held to
    its plain version: the tier sets (16, 8, 4), (8, 8, 4), (4, 4, 2) and
    all-16-bit, and the threshold tier mode at theta_h 1.0."""
    import tempfile

    from realtime_kv_cache_compression_tpu_torch.eval import longbench
    from realtime_kv_cache_compression_tpu_torch.experiments import (
        ablation_study)
    from realtime_kv_cache_compression_tpu_torch.models import llama
    from realtime_kv_cache_compression_tpu_torch.utils import data
    from realtime_kv_cache_compression_tpu_torch.utils.tokenizer import (
        ByteTokenizer)

    data._HUB_UNAVAILABLE = True  # synthetic tasks, no network attempt
    fields = ("alpha", "beta", "gamma", "theta_h", "theta_m",
              "early_layer_ratio", "middle_layer_ratio", "later_layer_ratio",
              "high_precision_bits", "medium_precision_bits",
              "low_precision_bits", "tier_mode")
    base = ablation_study.base_config(mcfg.num_layers)
    for study, want in ABLATION_CONFIGS.items():
        got = {n: tuple(getattr(c, f) for f in fields)
               for n, c in ablation_study.STUDIES[study](base).items()}
        check(list(got) == list(want) and all(
            g == w or (isinstance(w, float) and math.isclose(
                g, w, abs_tol=1e-12))
            for n in want for g, w in zip(got[n], want[n])),
            f"ablation {study}: configs {got}")
    layers, launches = mcfg.num_layers, {}
    with tempfile.TemporaryDirectory() as tmp:
        for study in ABLATION_STUDIES:
            run, launches[f"tinyllama_ablation_{study}"], _ = _cli_launches(
                f"ablation {study}", lambda: ablation_study.main(
                    ABLATION_ARGS + ["--device", device, "--study", study,
                                     "--layers", str(layers),
                                     "--output-dir", tmp]),
                lambda run: {
                    "K1": layers * sum(c["prefill"] for c in
                                       run["model_calls"][study].values()),
                    "K2": layers * sum(c["decode_steps"] for c in
                                       run["model_calls"][study].values())})
            rows = run["rows"][study]
            check(not any("error" in r for r in rows),
                  f"ablation {study}: no error row")
            for r in rows:
                log(f"ablation {study} {r['config']}: quality "
                    f"{r['quality']:.4f}, memory savings "
                    f"{r['memory_savings']:.4f}, kept ratio "
                    f"{r['compression_ratio']:.4f}, tok/s "
                    f"{r['tokens_per_second']:.1f}, TTFT "
                    f"{r['ttft'] * 1e3:.1f} ms, wall {r['wall_s']:.2f} s")
            log(f"ablation {study}: artifacts {sorted(os.listdir(tmp))}")
    params = llama.init_params(0, mcfg, device)
    tok = ByteTokenizer()
    task = data.LONGBENCH_TASKS["narrativeqa"]
    sample = data.synthetic_task_data("narrativeqa", 1, context_words=600)[0]
    ids = data.truncate_middle(tok.encode(data.format_prompt(task, sample)),
                               int(_arg(ABLATION_ARGS, "--max-length")))
    ids_t = torch.tensor([ids], device=device)
    lens = torch.tensor([len(ids)], dtype=torch.int32, device=device)
    n = ABLATION_AUDIT_TOKENS
    for study in ABLATION_STUDIES:
        for name, ccfg in ablation_study.STUDIES[study](base).items():
            audit = {}
            runner = longbench.ModelRunner(params, mcfg, ccfg,
                                           use_flash=True, max_new_tokens=n)
            with _held_to_plain(audit):
                out = runner.generate(ids_t, lengths=lens)
            _audit_line(f"ablation {study} {name} (prompt {len(ids)}, "
                        f"bits {ccfg.high_precision_bits}/"
                        f"{ccfg.medium_precision_bits}/"
                        f"{ccfg.low_precision_bits}, {ccfg.tier_mode})",
                        audit, {"K1": 2 * layers,
                                "K2": 2 * layers * (n - 1)})
            log(f"ablation {study} {name}: kept ratio "
                f"{out['compression']['avg_compression_ratio']:.4f}, "
                f"precision {out['compression']['precision_distribution']}")
            _worst(errors, audit)
    del params
    torch.cuda.empty_cache()
    return launches


def phase_tuning(device, errors: dict) -> dict:
    """The port's hyperparameter_tuning CLI on its own model (the JAX
    script has no other: `tiny_test_model(vocab_size=258)`, 4 layers,
    float32, d=16): `--method compare` (grid, random, Bayesian, genetic)
    with TUNING_ARGS (7 trials each, so the Bayesian method fits the
    port's GP 3 times and the genetic one makes a child; 1 sample per
    task, cut from 5), launches held to the trials' runners' schedule, no
    failed trial, the GP fits counted. Then the Bayesian method's last
    point's trial again with every K1 and K2 call held to its plain
    version."""
    import tempfile

    from realtime_kv_cache_compression_tpu_torch import tiny_test_model
    from realtime_kv_cache_compression_tpu_torch.eval import longbench
    from realtime_kv_cache_compression_tpu_torch.experiments import (
        hyperparameter_tuning as tuning)
    from realtime_kv_cache_compression_tpu_torch.models import llama
    from realtime_kv_cache_compression_tpu_torch.utils import data
    from realtime_kv_cache_compression_tpu_torch.utils.tokenizer import (
        ByteTokenizer)

    data._HUB_UNAVAILABLE = True
    mcfg = tiny_test_model(vocab_size=258, num_layers=4)  # the CLI's
    trials = int(_arg(TUNING_ARGS, "--trials"))
    with tempfile.TemporaryDirectory() as tmp:
        run, launches, _ = _cli_launches(
            "tuning", lambda: tuning.main(TUNING_ARGS + [
                "--device", device, "--output-dir", tmp]),
            lambda run: {"K1": mcfg.num_layers * sum(
                c["prefill"] for c in run["model_calls"].values()),
                "K2": mcfg.num_layers * sum(
                c["decode_steps"] for c in run["model_calls"].values())})
        log(f"tuning: artifacts {sorted(os.listdir(tmp))}")
    check(run["gp_fits"] == {"grid": 0, "random": 0, "bayesian": trials - 4,
                             "genetic": 0},
          f"tuning: GP fits {run['gp_fits']}")
    for method, hist in run["history"].items():
        check(len(hist) == trials and not any("error" in h for h in hist),
              f"tuning {method}: {trials} trials, none failed")
        best = run["comparison"][method]["best"]
        log(f"tuning {method}: best score {best['score']:.4f} (quality "
            f"{best['quality']:.4f}, savings {best['savings']:.4f}); "
            f"scores {[round(h['score'], 4) for h in hist]}; wall "
            f"{run['comparison'][method]['wall_s']:.2f} s")
    # The trial as `Tuner.objective` runs it, at the CLI's defaults.
    pt = run["history"]["bayesian"][-1]["point"]
    runner = longbench.ModelRunner(
        llama.init_params(0, mcfg, device), mcfg,
        tuning.point_to_config(pt, mcfg.num_layers), use_flash=True,
        max_new_tokens=16)
    audit = {}
    with _held_to_plain(audit):
        res = longbench.LongBenchEvaluator(
            runner, ByteTokenizer(), max_length=1024,
            synthetic_kwargs={"context_words": 600}).evaluate_all_tasks(
                ["narrativeqa", "qasper"], 1)
    check(not longbench.recorded_errors(res), "tuning audit trial")
    calls = runner.model_calls
    _audit_line(f"tuning audit (bits {pt['high_precision_bits']}/"
                f"{pt['medium_precision_bits']}/2, theta_h "
                f"{pt['theta_h']:.3f})", audit,
                {"K1": mcfg.num_layers * calls["prefill"],
                 "K2": mcfg.num_layers * calls["decode_steps"]})
    _worst(errors, audit)
    return launches


def phase_serving_benchmark(device, mcfg, errors: dict) -> dict:
    """The port's serving_benchmark CLI at its defaults (TinyLlama, 22
    layers, bf16 from `init_params(0)`, 4 slots over a 1024-token bucket,
    a warm-up of admissions at B = 1, 2, 4, then 8 requests of 512-1023
    tokens, 32 new tokens, decode chunks of 8): launches held to the
    engine's schedule (K1 22 a prefill, K2 22 x 8 a decode chunk), every
    request served; throughput, mean TTFT and mean savings printed. Then
    one admission of three ragged prompts and its decode chunk on the
    same engine with every kernel call held to its plain version."""
    from realtime_kv_cache_compression_tpu_torch.experiments import (
        serving_benchmark)

    layers = mcfg.num_layers
    run, launches, wall = _cli_launches(
        "serving benchmark", lambda: serving_benchmark.main(
            SERVE_BENCH_ARGS + ["--device", device]),
        lambda run: {"K1": layers * run["model_calls"]["prefill"],
                     "K1b": layers * run["model_calls"]["chunk_step"],
                     "K2": layers * SERVE_CHUNK
                     * run["model_calls"]["decode"]})
    s = run["summary"]
    check(s["completed"] == len(run["completed"]) == 8 and all(
        r.finished and len(r.tokens) == 32
        for r in run["completed"].values()),
        "serving benchmark: every request served its 32 tokens")
    log(f"serving benchmark: {s['completed']} requests, wall "
        f"{run['wall_s']:.3f} s, throughput "
        f"{s['total_tokens'] / run['wall_s']:.1f} generated tok/s, mean "
        f"TTFT {s['avg_ttft_s'] * 1e3:.1f} ms, mean savings "
        f"{s['avg_memory_savings']:.4f}; warm-up {run['warmup_s']:.1f} s; "
        f"engine schedule {run['model_calls']}; whole CLI {wall:.1f} s")
    gen = torch.Generator().manual_seed(SEED + 13)
    prompts = [torch.randint(1, mcfg.vocab_size, (n,),
                             generator=gen).tolist() for n in (1024, 700, 513)]
    eng = run["engine"]
    eng.use_flash = eng.use_fused_decode = True  # None's choice on the card
    for k, e in _audit_serving(eng, prompts, "serving benchmark").items():
        errors[k] = max(errors.get(k, 0.0), e)
    del run
    torch.cuda.empty_cache()
    return launches


def phase_speculative_benchmark(device, errors: dict) -> dict:
    """The port's speculative_benchmark CLI on the recall model (6 layers,
    hidden 128, 4 / 2 heads of 32, vocab 256, float32) with
    SPEC_BENCH_ARGS: filler 512 (cut from 512 and 4096), payload 16 (cut
    from 48), 300 training steps (cut from 1200), 3 timed runs, the
    adaptive arm; the CLI asserts speculative == greedy == adaptive before
    it times. Launches held to its schedule (K1 6 a prefill, K2 6 a greedy
    or plain-chunk decode step; the verify forward is plain). Then the
    trained model's prefill and 4 decode steps with every K1 and K2 call
    held to its plain version."""
    import tempfile

    from realtime_kv_cache_compression_tpu_torch.experiments import (
        speculative_benchmark as spec)
    from realtime_kv_cache_compression_tpu_torch.experiments.quality_demo \
        import make_batch
    from realtime_kv_cache_compression_tpu_torch.models import llama

    with tempfile.TemporaryDirectory() as tmp:
        run, launches, wall = _cli_launches(
            "speculative benchmark", lambda: spec.main(SPEC_BENCH_ARGS + [
                "--device", device, "--output-dir", tmp]),
            lambda run: {"K1": run["mcfg"].num_layers
                         * run["model_calls"]["prefill"],
                         "K2": run["mcfg"].num_layers
                         * run["model_calls"]["decode_steps"]})
    for row in run["results"]:
        log(f"speculative benchmark filler {row['filler']}: speculative == "
            f"greedy == adaptive ({row['n_steps']} tokens), em "
            f"{row['em']:.3f}, {row['iterations']} verify forwards, accept "
            f"rate {row['accept_rate']:.3f}; greedy ms "
            f"{row['greedy_ms_spread']}; speculative ms "
            f"{row['spec_ms_spread']} ({row['speedup']:.3f}x); adaptive ms "
            f"{row['adaptive']['ms_spread']} ({row['adaptive']['speedup']:.3f}"
            f"x, {row['adaptive']['spec_chunks']} speculative and "
            f"{row['adaptive']['plain_chunks']} plain chunks)")
    log(f"speculative benchmark: whole CLI {wall:.1f} s (training included)")
    mcfg, ccfg, params = run["mcfg"], run["ccfg"], run["params"]
    filler = int(_arg(SPEC_BENCH_ARGS, "--fillers").split(",")[0])
    payload = int(_arg(SPEC_BENCH_ARGS, "--payload"))
    gen = torch.Generator(device=device).manual_seed(7 + filler)
    ids, plen, _ = make_batch(gen, 1, payload, filler, mcfg.vocab_size,
                              "recall")
    audit = {}
    with _held_to_plain(audit):
        logits, state, _ = llama.prefill_compressed(
            params, ids[:, :plen], mcfg, ccfg, max_decode_len=payload,
            use_flash=True)
        llama.decode_loop(params, torch.argmax(logits, -1), state, 4, mcfg,
                          ccfg, use_fused=True)
    _audit_line(f"speculative benchmark audit (float32, d={mcfg.head_dim}, "
                f"prompt {plen})", audit,
                {"K1": mcfg.num_layers, "K2": 4 * mcfg.num_layers})
    _worst(errors, audit)
    del run, params
    torch.cuda.empty_cache()
    return {"recall_speculative_benchmark": launches}


def _prefix_quality_trace(params, prompt, payload: int, mcfg, ccfg,
                          chunk: int, kernels: bool) -> dict:
    """Each arm of `chunked_prefix_quality.run_arms`, step by step: {arm:
    (tokens [B, payload], logits [B, payload, V] on the host, kept
    positions per layer, tier and row, or None uncompressed)}."""
    from realtime_kv_cache_compression_tpu_torch.models import llama

    b, t = prompt.shape
    logits, (ks, vs) = llama.prefill_uncompressed(params, prompt, mcfg,
                                                  use_flash=kernels)
    kv = tuple(torch.nn.functional.pad(a, (0, 0, 0, 0, 0, payload))
               for a in (ks, vs))
    pos = torch.full((b,), t, dtype=torch.int32, device=prompt.device)
    out = [logits.float().cpu()]
    for _ in range(payload - 1):
        logits, kv, pos = llama.decode_step_uncompressed(
            params, torch.argmax(logits, -1), kv, pos, mcfg)
        out.append(logits.float().cpu())
    logits = torch.stack(out, dim=1)
    trace = {"baseline_fp": (torch.argmax(logits, -1), logits, None)}
    for arm in ("comp_oneshot", "comp_prefix"):
        if arm == "comp_oneshot":
            logits, state, _ = llama.prefill_compressed(
                params, prompt, mcfg, ccfg, max_decode_len=payload,
                use_flash=kernels)
        else:
            logits, state, _ = llama.prefill_compressed_prefix_chunked(
                params, prompt, mcfg, ccfg, chunk_size=chunk,
                max_decode_len=payload + 4, use_flash=kernels)
        kept = _kept_positions(state.caches)
        trace[arm] = (*_greedy_from(params, logits, state, mcfg, ccfg,
                                    payload - 1, kernels), kept)
    return trace


def phase_chunked_prefix_quality(device, errors: dict) -> dict:
    """The port's chunked_prefix_quality CLI on the recall model (6
    layers, hidden 128, 4 / 2 heads of 32, vocab 64, float32) with
    PREFIX_QUALITY_ARGS: contexts 256 and 1024 (cut from 256, 1024 and
    4096), 300 training steps (cut from 2400), 32 samples in batches of 8;
    launches held to its schedule (per batch: K1 6 in each of two one-shot
    prefills, K1 mode (d) and the diagonal pair 6 a chunk x 4 chunks, K2 6
    a compressed decode step x 7 x 2). Then at context 1024, on the first
    eval batch: the arms step by step (`_prefix_quality_trace`) on the
    kernels, with every K1 (modes a and d, the pair) and K2 call held to
    its plain version, their tokens those of the CLI's `run_arms`, and on
    the plain versions; each arm's kernel tokens held to
    the plain path's up to a near tie of the plain logits, on every row
    of the uncompressed arm and on every row whose two prefills keep the
    same positions in every layer and tier (the others counted: K1's
    float32 rounding can move near-equal importance scores across a tier
    boundary)."""
    import tempfile

    from realtime_kv_cache_compression_tpu_torch.experiments import (
        chunked_prefix_quality as cpq)
    from realtime_kv_cache_compression_tpu_torch.experiments.quality_demo \
        import make_batch

    with tempfile.TemporaryDirectory() as tmp:
        run, launches, wall = _cli_launches(
            "chunked-prefix quality", lambda: cpq.main(PREFIX_QUALITY_ARGS + [
                "--device", device, "--output-dir", tmp]),
            lambda run: {
                "K1": run["mcfg"].num_layers * run["model_calls"]["prefill"],
                "K1d": run["mcfg"].num_layers
                * run["model_calls"]["prefix_chunks"],
                "K1p": run["mcfg"].num_layers
                * run["model_calls"]["prefix_chunks"],
                "K2": run["mcfg"].num_layers
                * run["model_calls"]["decode_steps"]})
    res = run["results"]
    for key, row in res.items():
        if key.startswith("context"):
            log(f"chunked-prefix quality {key} (chunk {row['chunk']}): " + ", "
                .join(f"{a} acc {row[a]['token_accuracy']:.4f} em "
                      f"{row[a]['exact_match']:.4f}" for a in cpq.ARMS)
                + f"; prefix vs one-shot {row['prefix_vs_oneshot_acc_delta']}")
    log(f"chunked-prefix quality: whole CLI {wall:.1f} s (training "
        f"included)")
    mcfg, ccfg, params = run["mcfg"], run["ccfg"], run["params"]
    t = max(res["meta"]["contexts"])
    payload = 8  # the CLI's default
    gen = torch.Generator(device=device).manual_seed(123 + t - payload - 1)
    ids, plen, _ = make_batch(gen, 32, payload, t - payload - 1,
                              mcfg.vocab_size, "recall")
    prompt = ids[:8, :plen]  # the first eval batch
    audit, layers = {}, mcfg.num_layers
    with _held_to_plain(audit):
        kern = _prefix_quality_trace(params, prompt, payload, mcfg, ccfg,
                                     t // 4, True)
    _audit_line(f"chunked-prefix quality audit (float32, d={mcfg.head_dim},"
                f" T={t}, chunks of {t // 4}, B={prompt.shape[0]})", audit,
                {"K1": 2 * layers, "K1d": 4 * layers, "K1p": 4 * layers,
                 "K2": 2 * layers * (payload - 1)})
    _worst(errors, audit)
    toks = cpq.run_arms(params, prompt, payload, mcfg, ccfg, t // 4)
    plain = _prefix_quality_trace(params, prompt, payload, mcfg, ccfg,
                                  t // 4, False)
    for arm in cpq.ARMS:
        check(torch.equal(kern[arm][0], toks[arm].cpu()),
              f"chunked-prefix quality {arm}: run_arms' tokens")
        held, moved = 0, []
        for r in range(prompt.shape[0]):
            if kern[arm][2] is not None and any(
                    [tier[r] for tier in layer] != [tier[r] for tier in pl]
                    for layer, pl in zip(kern[arm][2], plain[arm][2])):
                moved.append(r)
                continue
            _held_to_reference(f"chunked-prefix quality {arm} row {r}",
                               kern[arm][0][r].tolist(),
                               plain[arm][0][r].tolist(), plain[arm][1][r])
            held += 1
        apart = torch.nonzero((kern[arm][0] != plain[arm][0]).any(1))
        log(f"chunked-prefix quality {arm} at T={t}: {held} rows held to "
            f"the plain path's tokens up to a near tie; rows whose prefills "
            f"keep other positions {moved}; rows whose tokens part "
            f"{apart.flatten().tolist()}")
    del run, params
    torch.cuda.empty_cache()
    return {"recall_chunked_prefix_quality": launches}


def run_all(device, tiny, big, gemma, gemma7, mixtral, qwen2,
            qwen2_7b) -> list:
    """Every phase, in order; returns the kernels' entries for the JSON
    line. `tiny`, `big`, `gemma`, `gemma7`, `mixtral`, `qwen2` and
    `qwen2_7b` are the TinyLlama, Llama-2-7B, Gemma-2B, Gemma-7B,
    Mixtral-8x7B, Qwen2-0.5B and Qwen2-7B configs (Gemma-7B for its heads
    only: 16 over 16 at head_dim 256; Qwen2-7B for its heads and 2 layers:
    28 over 4 at head_dim 128)."""
    from realtime_kv_cache_compression_tpu_torch.models import llama

    two = lambda cfg: dataclasses.replace(cfg, num_layers=2)  # noqa: E731
    heads = lambda cfg: (cfg.num_heads, cfg.num_kv_heads,  # noqa: E731
                         cfg.head_dim)
    t0 = time.perf_counter()

    def mark(what: str) -> None:
        log(f"elapsed {time.perf_counter() - t0:.1f} s: {what} done")

    phase_build()
    k1_tiny = phase_k1(device, (1, PROMPT, tiny.num_heads, tiny.num_kv_heads,
                                tiny.head_dim))
    k1 = phase_k1(device, (1, PROMPT, big.num_heads, big.num_kv_heads,
                           big.head_dim))
    k1b_tiny = phase_k1_chunk(device, (tiny.num_heads, tiny.num_kv_heads,
                                       tiny.head_dim))
    k1b_big = phase_k1_chunk(device, (big.num_heads, big.num_kv_heads,
                                      big.head_dim))
    k1_prefix_tiny = phase_k1_prefix(device, tiny)
    k1_prefix_big = phase_k1_prefix(device, big)
    k1c_tiny = phase_k1_full_pair(device, (tiny.num_heads, tiny.num_kv_heads,
                                           tiny.head_dim))
    k1c_big = phase_k1_full_pair(device, (big.num_heads, big.num_kv_heads,
                                          big.head_dim))
    k1_activations = phase_k1_activations(device, two(tiny))
    mark("K1 phases")
    k1_tuning = phase_k1_tuning(device, tiny, big, qwen2)
    mark("K1 tuning phase")
    k2_tiny = phase_k2(device, two(tiny))
    k2 = phase_k2(device, two(big))
    k2p_tiny = phase_k2_pool(device, two(tiny), groups=(1, 2))
    k2p_big = phase_k2_pool(device, two(big), groups=(1, 4))
    # head_dim 256: every K1 mode and K2 form at Gemma-2B's and Gemma-7B's
    # heads.
    g = {}
    for name, cfg in (("gemma_2b", gemma), ("gemma_7b", gemma7)):
        g[name] = {
            "K1": phase_k1(device, (1, PROMPT) + heads(cfg)),
            "K1b": phase_k1_chunk(device, heads(cfg)),
            "K1prefix": phase_k1_prefix(device, cfg),
            "K1c": phase_k1_full_pair(device, heads(cfg)),
            "K2": phase_k2(device, two(cfg)),
            "K2pool": phase_k2_pool(device, two(cfg), groups=(1, 4))}
    # The new runs' heads: n_rep 7 at Qwen2-0.5B's (14/2 at d=64) and
    # Qwen2-7B's (28/4 at d=128), n_rep 4 at Mixtral-8x7B's (32/8 at
    # d=128).
    q2 = {name: {"K1": phase_k1(device, (1, PROMPT) + heads(cfg)),
                 "K2": phase_k2(device, two(cfg))}
          for name, cfg in (("qwen2_0_5b", qwen2), ("qwen2_7b", qwen2_7b),
                            ("mixtral_8x7b", mixtral))}
    mark("K1 and K2 phases")
    k3_expert = phase_k3_expert(device, mixtral.num_experts)
    k3 = phase_k3(device, big.num_layers)
    # Mixtral's unfused attention matmuls: wq, wk, wv, wo.
    h, qd = mixtral.hidden_size, mixtral.num_heads * mixtral.head_dim
    kvd = mixtral.num_kv_heads * mixtral.head_dim
    k3_mixtral = phase_k3(device, mixtral.num_layers,
                          shapes=((h, qd), (h, kvd), (h, kvd), (qd, h)))
    k4 = phase_k4(device, big.num_layers)
    mark("K3 and K4 phases")
    phase_parity(device, two(tiny))
    phase_parity(device, two(gemma))
    for arm in ("int4", "w8a8"):
        phase_parity(device, two(big), arm, prompt=512, new_tokens=8)
    phase_parity_chunked(device, two(tiny))
    phase_parity_prefix(device, two(tiny))
    phase_parity_query(device, two(tiny))
    phase_exact_greedy(device)
    phase_parity_beam(device, two(tiny))
    phase_parity_speculative(device, two(tiny))
    phase_parity_mixtral(device, two(mixtral))
    mark("float32 parity phases")
    phase_parity_serving(device, two(tiny))
    mark("float32 serving parity")
    n_steps = NEW_TOKENS - 1
    tiny_run = phase_main(
        "tinyllama main run", device, tiny,
        llama.fuse_params(llama.init_params(SEED, tiny, device)),
        {**{key: 0 for key in KERNELS}, "K1": tiny.num_layers,
         "K2": tiny.num_layers * n_steps})
    phase_profile("tinyllama", tiny, tiny_run)
    launches = {"tinyllama": tiny_run["launches"],
                "tinyllama_sampled": phase_sampled("tinyllama", device, tiny,
                                                   tiny_run)}
    mark("tinyllama main and sampled runs")
    beam_launches, k2_beam = phase_beam_path("tinyllama", device, tiny,
                                             tiny_run)
    launches.update(beam_launches)
    launches.update(phase_speculative_path("tinyllama", device, tiny,
                                           tiny_run))
    phase_forward_logits(device, tiny, tiny_run)
    mark("tinyllama beam, speculative and forward_logits runs")
    seq = phase_seq_parallel(device, tiny, tiny_run)
    launches.update(seq["launches"])
    mark("tinyllama sequence-parallel runs")
    tp = phase_tensor_parallel(device, tiny, tiny_run, dataclasses.replace(
        mixtral, num_layers=TP_MIXTRAL_LAYERS))
    launches.update(tp["launches"])
    mark("tensor- and expert-parallel runs")
    pipe = phase_pipeline(device, tiny, tiny_run)
    launches.update(pipe["launches"])
    mark("tinyllama pipeline runs")
    del tiny_run
    torch.cuda.empty_cache()
    ss = phase_sharded_serving(device, tiny)
    launches.update(ss["launches"])
    mark("sharded serving and float32 pipeline runs")
    launches.update(phase_sharded_train_decoders(device, tiny)["launches"])
    mark("sharded training and decoders")
    phase_multihost(device)
    mark("multi-process driver")
    tiny_paths = dataclasses.replace(tiny, num_layers=TINY_PATH_LAYERS,
                                     max_position_embeddings=PROMPT + 512)
    launches["tinyllama_chunked"] = phase_chunked_path(device, tiny_paths)
    mark("tinyllama chunked pooled run")
    launches["tinyllama_prefix"] = phase_prefix_path(device, tiny_paths)
    mark("tinyllama compressed-prefix run")
    launches.update(phase_query_path(device, tiny_paths))
    mark("tinyllama query-guided runs")
    serving_launches, serving_err = phase_serving_path(
        device, dataclasses.replace(tiny,
                                    max_position_embeddings=PROMPT + 512))
    launches.update(serving_launches)
    mark("tinyllama serving runs")
    phase_parity_train(device)
    launches["tinyllama_train"] = phase_train_path(device, tiny)
    mark("trainer parity and tinyllama training")
    launches["quality_demo_recall"] = phase_quality_demo(device)
    mark("quality demo")
    launches.update(phase_eval_path(device, tiny_paths))
    mark("tinyllama eval harness")
    launches["tinyllama_benchmark_suite"] = phase_benchmark_suite(
        device, tiny_paths)
    mark("tinyllama benchmark suite")
    # The experiment CLIs; each audit's worst error per kernel.
    exp_err = {}
    launches.update(phase_ablation(device, tiny_paths, exp_err))
    mark("ablation study")
    launches["tuning_compare"] = phase_tuning(device, exp_err)
    mark("hyperparameter tuning")
    launches["tinyllama_serving_benchmark"] = phase_serving_benchmark(
        device, tiny, exp_err)
    mark("serving benchmark")
    launches.update(phase_speculative_benchmark(device, exp_err))
    mark("speculative benchmark")
    launches.update(phase_chunked_prefix_quality(device, exp_err))
    mark("chunked-prefix quality")
    launches["gemma_2b"] = run_gemma(device, gemma)
    mark("gemma-2b run")
    routes = {}
    for arm in ("int4", "w8a8"):
        launches[f"llama2_7b_{arm}"], routes[arm] = run_7b_arm(
            arm, device, dataclasses.replace(big, num_layers=BIG_RUN_LAYERS))
    mark("llama2-7b runs")
    launches["qwen2_0_5b_loaded"] = run_qwen2_from_disk(
        device, dataclasses.replace(qwen2, num_layers=QWEN2_LAYERS))
    mark("qwen2-0.5b run from disk")
    mixtral_run = dataclasses.replace(mixtral, num_layers=MIXTRAL_LAYERS)
    launches["mixtral_8x7b_int4"] = run_mixtral(device, mixtral_run)
    mark("mixtral-8x7b run and checkpoint round trip")
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")

    def entry(key, result, path, extra=None):
        _, name, source, replaces = KERNELS[key][:4]
        fields = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                  "library_ms")
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[path][key],
                **{f: result[f] for f in fields},
                "launches_by_path": {p: c.get(key, 0)
                                     for p, c in launches.items()},
                **({"experiments_max_abs_err": exp_err[key]}
                   if key in exp_err else {}),
                **(extra or {})}

    shape_note = ("ms, plain_ms, bound_ms, library_ms: one decode step's "
                  f"calls ({big.num_layers} layers x 4 matmuls{{}}) at M=1, "
                  "bf16")
    chunk_note = (f"B=2 c={CHUNK} over S_k={PROMPT}, Hq={{}} Hkv={{}} "
                  f"d={{}}, bf16; ms, plain_ms, bound_ms, library_ms: the "
                  f"{PROMPT // CHUNK} chunk offsets summed, one layer's "
                  f"chunked prefill")
    pool_note = (f"layer 0 of a 2-layer {{}} state, B={len(LENGTHS)} "
                 f"lengths {LENGTHS} right-padded to {PROMPT}, after 330 "
                 f"steps (ring {RING}, {POOL_BLOCKS} pool blocks, wrapped); "
                 f"{{}}")
    prefix_note = (f"B={PREFIX_BATCH} c={CHUNK} at q_offsets 0-"
                   f"{PROMPT - CHUNK}, Hq={{}} Hkv={{}} d={{}}, bf16, over "
                   f"layer 0's pools of a {PROMPT}-token compressed-prefix "
                   f"prefill; ms, plain_ms, bound_ms, library_ms: the "
                   f"{PROMPT // CHUNK} chunks summed, one layer's prefill")
    pair_note = (f"B={PREFIX_BATCH} S_q=S_k={CHUNK}, Hq={{}} Hkv={{}} d={{}}, "
                 f"bf16")
    k2_err = max(serving_err["K2"], tp["audit"]["K2"][1],
                 pipe["audit"]["K2"][1], ss["audit"]["K2"][1],
                 *(r["max_abs_err"] for r in (
                     k2, k2_tiny, k2p_tiny, k2p_big, k2_beam,
                     *(g[m][p] for m in g for p in ("K2", "K2pool")),
                     *(q2[m]["K2"] for m in q2))))
    serving_note = ("tinyllama_serving (one-shot and chunked): every call "
                    "of one admission of B=4 ragged rows over the "
                    f"{PROMPT}-token bucket and of its decode chunk over "
                    f"{SERVE_SLOTS} slots, idle ones included, against "
                    "the plain version, bf16")

    g_cfgs = {"gemma_2b": gemma, "gemma_7b": gemma7}
    q2_cfgs = {"qwen2_0_5b": qwen2, "qwen2_7b": qwen2_7b,
               "mixtral_8x7b": mixtral}

    def d256(part, note, pick=lambda r: r):
        """The d=256 readings of one kernel at Gemma-2B's and Gemma-7B's
        heads, with `note` formatted by the heads."""
        return {m: {**pick(g[m][part]),
                    "shape": note.format(*heads(g_cfgs[m]))} for m in g}

    def worst(*results, serving=None):
        return max([r["max_abs_err"] for r in results]
                   + ([serving_err[serving]] if serving else []))

    def serving_extra(key):
        return {"serving_max_abs_err": serving_err[key],
                "serving_shape": serving_note}

    k1_note = f"B=1 S={PROMPT} Hq={{}} Hkv={{}} d={{}}"

    def tp_note(rec):
        return {"calls": rec[0], "max_abs_err": rec[1],
                "worst_share_of_limit": rec[2], "prompt_mass_max_abs_err":
                rec[3], "shape": "every call of the tensor-parallel runs "
                                 "on every rank: TinyLlama bf16 on 1x4 "
                                 f"(B=1) and 2x2 (B=2) at S={PROMPT}, "
                                 f"Mixtral width on 1x4 at S="
                                 f"{TP_MIXTRAL_PROMPT}, float32 at "
                                 f"tiny_test_model width"}

    def audit_note(rec, shape):
        return {"calls": rec[0], "max_abs_err": rec[1],
                "worst_share_of_limit": rec[2],
                "prompt_mass_max_abs_err": rec[3], "shape": shape}

    pipe_shape = (f"layer 0 of each stage of tinyllama_pipeline_"
                  f"{PIPE_RANKS} ({tiny.num_layers // PIPE_RANKS} layers a "
                  f"rank): B=1 S={PROMPT}, then {PIPE_NEW_TOKENS - 1} "
                  f"decode steps, bf16")
    ss_shape = (f"layer 0 of every call of the sharded engines on "
                f"{SS_MESH[0]}x{SS_MESH[1]} (TinyLlama width, "
                f"{TINY_PATH_LAYERS} layers, {SERVE_SLOTS} slots over "
                f"{SS_CONTEXT}, each admission's rows whole over the "
                f"model rank's heads), bf16")

    def seq_note(rec):
        return {"calls": rec[0], "max_abs_err": rec[1],
                "worst_share_of_limit": rec[2], "prompt_mass_max_abs_err":
                rec[3], "shape": f"ring attention of tinyllama_seq_parallel"
                                 f" over {SEQ_RANKS} ranks: B=1, "
                                 f"{PROMPT // SEQ_RANKS} queries over "
                                 f"{PROMPT // SEQ_RANKS} keys, "
                                 f"Hq={tiny.num_heads} Hkv="
                                 f"{tiny.num_kv_heads} d={tiny.head_dim}, "
                                 f"bf16"}
    def tile_checks(mode):
        return {"tiles_held_to_plain": k1_tuning["tiles"][mode]}

    kernels = [
        entry("K1", {**k1, "max_abs_err": max(worst(
            k1, k1_tiny, *(g[m]["K1"] for m in g),
            *(q2[m]["K1"] for m in q2), serving="K1"),
            tp["audit"]["K1"][1], pipe["audit"]["K1"][1],
            ss["audit"]["K1"][1])}, "llama2_7b_int4", {
            "mode": "a (square causal)",
            "shape": "B=1 S=4096 Hq=Hkv=32 d=128 bf16",
            "library": "scaled_dot_product_attention, causal, no prompt "
                       "mass",
            "tinyllama": {**k1_tiny, "shape": "B=1 S=4096 Hq=32 Hkv=4 d=64"},
            **d256("K1", k1_note),
            **{m: {**q2[m]["K1"], "shape": k1_note.format(*heads(q2_cfgs[m]))}
               for m in q2},
            "model_activations_max_abs_err": k1_activations,
            "tensor_parallel_audit": tp_note(tp["audit"]["K1"]),
            "pipeline_audit": audit_note(pipe["audit"]["K1"], pipe_shape),
            "sharded_serving_audit": audit_note(ss["audit"]["K1"],
                                                ss_shape),
            **serving_extra("K1"),
            "tile_sweep": _sweep_entries(k1_tuning["cli"])}),
        entry("K1b", {**k1b_tiny, "max_abs_err": max(worst(
            k1b_tiny, k1b_big, *(g[m]["K1b"] for m in g), serving="K1b"),
            ss["audit"]["K1b"][1])},
              "tinyllama_chunked", {
            "mode": "b (rectangular causal at q_offset, chunked prefill)",
            "shape": chunk_note.format(tiny.num_heads, tiny.num_kv_heads,
                                       tiny.head_dim),
            "library": "scaled_dot_product_attention with a boolean "
                       "[c, S_k] causal mask, no prompt mass",
            "llama2_7b": {**k1b_big, "shape": chunk_note.format(
                big.num_heads, big.num_kv_heads, big.head_dim)},
            **d256("K1b", chunk_note), **serving_extra("K1b"),
            **tile_checks("b"),
            "sharded_serving_audit": audit_note(ss["audit"]["K1b"],
                                                ss_shape)}),
        entry("K1c", {**k1c_tiny, "max_abs_err": max(worst(
            k1c_tiny, k1c_big, *(g[m]["K1c"] for m in g)),
            seq["audit"]["K1c"][1])}, "tinyllama_seq_parallel", {
            "mode": "c (non-causal pair: ring attention's blocks of past "
                    "keys, 22 r launches on rank r of 4)",
            "seq_parallel_audit": seq_note(seq["audit"]["K1c"]),
            "shape": pair_note.format(tiny.num_heads, tiny.num_kv_heads,
                                      tiny.head_dim),
            "library": "scaled_dot_product_attention, no mask, no prompt "
                       "mass",
            "llama2_7b": {**k1c_big, "shape": pair_note.format(
                big.num_heads, big.num_kv_heads, big.head_dim)},
            **d256("K1c", pair_note), **tile_checks("c")}),
        entry("K1d", {**k1_prefix_tiny["positioned"], "max_abs_err": worst(
            k1_prefix_tiny["positioned"], k1_prefix_big["positioned"],
            *(g[m]["K1prefix"]["positioned"] for m in g))},
              "tinyllama_prefix", {
            "mode": "d (positioned keys: compressed pools)",
            "shape": prefix_note.format(tiny.num_heads, tiny.num_kv_heads,
                                        tiny.head_dim),
            "library": "scaled_dot_product_attention with a boolean [c, N] "
                       "mask from the positions, no prompt mass",
            "llama2_7b": {**k1_prefix_big["positioned"],
                          "shape": prefix_note.format(
                              big.num_heads, big.num_kv_heads,
                              big.head_dim)},
            **d256("K1prefix", prefix_note, lambda r: r["positioned"]),
            **tile_checks("d")}),
        entry("K1p", {**k1_prefix_tiny["pair"], "max_abs_err": max(worst(
            k1_prefix_tiny["pair"], k1_prefix_big["pair"],
            *(g[m]["K1prefix"]["pair"] for m in g)),
            seq["audit"]["K1p"][1])}, "tinyllama_prefix", {
            "mode": "diagonal pair (mode a with lse, local prompt length)",
            "seq_parallel_audit": seq_note(seq["audit"]["K1p"]),
            "shape": prefix_note.format(tiny.num_heads, tiny.num_kv_heads,
                                        tiny.head_dim),
            "library": "scaled_dot_product_attention, causal, no prompt "
                       "mass",
            "llama2_7b": {**k1_prefix_big["pair"],
                          "shape": prefix_note.format(
                              big.num_heads, big.num_kv_heads,
                              big.head_dim)},
            **d256("K1prefix", prefix_note, lambda r: r["pair"]),
            **tile_checks("pair")}),
        entry("K2", {**k2, "max_abs_err": k2_err}, "llama2_7b_int4", {
            "shape": "layer 0 of a 4096-token Llama-2-7B state, 8/4/2, "
                     "tiers + ring, bf16",
            "kernels_per_call": 1,
            "device_us_per_call": k2["device_us"],
            "tinyllama": k2_tiny,
            "beam": k2_beam,  # the beam path's B·W rows
            "tensor_parallel_audit": tp_note(tp["audit"]["K2"]),
            "pipeline_audit": audit_note(pipe["audit"]["K2"], pipe_shape),
            "sharded_serving_audit": audit_note(ss["audit"]["K2"],
                                                ss_shape),
            **serving_extra("K2"),
            **{m: {**g[m]["K2"], "shape": f"layer 0 of a 4096-token {m} "
                                          f"state, 8/4/2, tiers + ring, bf16"}
               for m in g},
            **{m: {**q2[m]["K2"], "shape": f"layer 0 of a 4096-token {m} "
                                           f"state, 8/4/2, tiers + ring, bf16"}
               for m in q2},
            "pool": {  # the decode-pool segment and G > 1 (chunked path)
                "tinyllama": {**k2p_tiny, "shape": pool_note.format(
                    "TinyLlama", k2p_tiny["variant"])},
                "llama2_7b": {**k2p_big, "shape": pool_note.format(
                    "Llama-2-7B", k2p_big["variant"])},
                **{m: {**g[m]["K2pool"], "shape": pool_note.format(
                    m, g[m]["K2pool"]["variant"])} for m in g}}}),
        entry("K2l", seq["k2l"], "tinyllama_seq_parallel_sharded", {
            "mode": "lse (return_lse=True): a rank's partial over its own "
                    "slots of a sequence-sharded state, o in float32 and "
                    "the log-sum-exp, merged over the ranks",
            "shape": f"ms, plain_ms, bound_ms: layer 0 of rank 0's 1/"
                     f"{SEQ_RANKS} slot shard of a {PROMPT}-token TinyLlama "
                     f"state with its ring, bf16 q",
            "kernels_per_call": 1,
            "device_us_per_call": seq["k2l"]["device_us"],
            "seq_parallel_audit": {
                "calls": seq["audit"]["K2l"][0],
                "max_abs_err": seq["audit"]["K2l"][1],
                "worst_share_of_limit": seq["audit"]["K2l"][2],
                "lse_max_abs_err": seq["audit"]["K2l"][3],
                "shape": f"every call of the decodes from the shards on "
                         f"every rank: TinyLlama bf16 over {SEQ_RANKS} "
                         f"ranks ({SEQ_NEW_TOKENS - 1} steps), float32 "
                         f"at tiny_test_model width"}}),
        entry("K3", {**k3, "max_abs_err": worst(k3, k3_mixtral, k3_expert)},
              "llama2_7b_int4", {
            "shape": shape_note.format(""), "prefill": k3["prefill"],
            "mixtral_attention": {  # unfused wq, wk, wv, wo
                **{f: k3_mixtral[f] for f in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "m1_device_us", "prefill")},
                "shape": f"one decode step's calls ({mixtral.num_layers} "
                         f"layers x wq {h}x{qd}, wk and wv {h}x{kvd}, wo "
                         f"{qd}x{h}) at M=1, bf16; prefill at M={PROMPT}"},
            "launches_by_route": routes["int4"],
            "m1_device_us_per_launch": k3["m1_device_us"],
            "library": "torch._weight_int4pack_mm, same codes, bf16 "
                       "scales",
            "expert": {  # the expert-indexed GEMV (route gemv_expert)
                **{f: k3_expert[f] for f in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "device_us", "library_device_us")},
                "per_shape_m1": k3_expert["per_shape_m1"],
                "replaces": f"{JAX_PKG}/ops/moe.py:160 (`_moe_dynslice`'s "
                            f"call of the Pallas `_kernel`, "
                            f"{JAX_PKG}/ops/pallas/int4_matmul.py:46)",
                "launches": launches["mixtral_8x7b_int4"]["K3"],
                "launches_gemv_expert": 3 * mixtral.num_experts_per_tok
                * mixtral_run.num_layers * (NEW_TOKENS - 1),
                "shape": "one routed expert's gate, up and down at M=1, "
                         "Mixtral-8x7B (4096 x 14336, 14336 x 4096, groups "
                         "of 128), bf16"}}),
        entry("K4", k4, "llama2_7b_w8a8", {
            "shape": shape_note.format(" + lm_head") + (
                f"; prefill: {big.num_layers} layers x 4 matmuls at M="
                f"{PROMPT} + lm_head at M=1, its library_ms the "
                f"{big.num_layers} x 4 layer matmuls alone (beside "
                f"ms_layer_matmuls)"),
            "prefill": k4["prefill"],
            "prefill_library_ms_by_weight_layout":
                k4["prefill_library_by_layout"],
            "m1_device_us_per_launch": k4["m1_device_us"],
            "routes": k4["routes"],
            "launches_by_route": routes["w8a8"],
            "library": "torch._int_mm + scaling, the faster of the [K, N] "
                       "weights and a K-major copy (refuses M=1)"}),
        *(_variant_entry(v, k1_tuning["variants"][v]) for v in K1_VARIANTS),
    ]
    return kernels


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from realtime_kv_cache_compression_tpu_torch import (LLAMA2_7B,
                                                         TINYLLAMA_1_1B)
    from realtime_kv_cache_compression_tpu_torch.config import (
        GEMMA_2B, GEMMA_7B, MIXTRAL_8X7B, QWEN2_0_5B, QWEN2_7B)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_environment()
    kernels = run_all(
        "cuda", dataclasses.replace(TINYLLAMA_1_1B,
                                    max_position_embeddings=PROMPT
                                    + NEW_TOKENS),
        dataclasses.replace(LLAMA2_7B,
                            max_position_embeddings=PROMPT + NEW_TOKENS),
        GEMMA_2B, GEMMA_7B,
        dataclasses.replace(MIXTRAL_8X7B,
                            max_position_embeddings=PROMPT + NEW_TOKENS),
        dataclasses.replace(QWEN2_0_5B,
                            max_position_embeddings=PROMPT + NEW_TOKENS),
        QWEN2_7B)
    log(nvidia_smi_line())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
