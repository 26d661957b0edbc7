#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port: the quickest proof that the
port builds, is right, and serves on an NVIDIA card.

    python3 chip_smoke.py            # from the repository root, one card

Phases (any failure raises and the script exits non-zero with no
result line):

1. build   — compile every CUDA kernel of the port with nvcc for sm_90a
             (one nvcc per source, all started at once) and print the
             card's name and power limit;
2. kernels — hold each kernel against its plain PyTorch version on the
             card: the chunk codec bit for bit (codes, scales,
             dequantized values) over bits {8, 4, 2}, bf16/fp32 inputs
             and four shapes, the quantize kernel also with a second
             leaf in one launch; decode_mqattn in both forms, with and
             without the mass, over five shapes, three quant shares and
             two (window, sinks) settings, the edge cases of its split
             plan (MQ_EDGE) and the other dense configs' GQA shapes
             (GQA_SHAPES: G 3 at hd 64, G 5, G 8) at (4, 512);
             attn_density in both forms, with and without the density,
             at serving's extend (seq_len 48 and 200, bucket pads,
             G 1/4/8, and the GQA shapes), a long append, the Pallas
             kernel's own setting and the edge cases of its tile plan
             (ragged tiles, hd 16/20/80, G 64), the slot engine's
             shapes (a non-contiguous recompute set, lmk's whole-context
             recompute), the new families' prefill shapes (AD_NEW:
             recurrentgemma's (1, 512 / 4096, 10, 1, 256) under its
             window of 2048, served / flash, and whisper's (1, 448, 8,
             8, 64), out only and with the density, timed with a warm
             and a cold L2 beside SDPA with the boolean mask), the
             row-stats variant (the forward of flash_attention: out, m
             and l) at STATS_SHAPES and at rows that see no key, timed
             at smollm-360m's (1, 4096, 15, 5, 64) beside SDPA
             is_causal (stats_phase), MLA's
             recompute (H = KV = 16, query/key head
             dim 192 beside value head dim 128, over S = 512 and 256 at
             the 64-row bucket, over 512 at the 16-, 32-, 128- and
             256-row buckets, 640 rows over 1024 on the kernel's 64-row
             tiles, and the reduced model's 24 / 16), causal, windowed and with
             rows that see no key; the codec at MLA's chunk leaves (16,
             13,824) and (16, 1,728), 8-bit; decode_qattn in both forms, with
             and without the mass, at two shapes and two (window, sinks)
             settings, over MQ_EDGE with every position quant and at the
             GQA shapes.  Time
             each kernel (per launch of its kernels, by name; a kernel
             the profiler does not find raises), its plain version, its
             bound and (for the attention kernels) the library's
             attention at the shapes the main path gives them; the
             decode kernels and their library rows also with a cold L2
             (a 128 MiB buffer written before every call, its kernels
             left out), and a chunk's two leaves quantized in one launch
             beside two launches;
3. serve   — llama2-7b at full width and depth (random bf16 weights from
             a seeded torch.Generator, built once) behind LLMService
             (policy llms, paged pool, decode_batch 1): 4 contexts x 3
             rounds of callLLM under a budget of about two contexts' raw
             KV, so compression, AoT swap-out, LCTRU eviction and disk
             restores all fire.  Run twice with the bf16 pool and twice
             with quant_resident=True (8-bit chunks admitted into int8
             QUANT pages and attended in place by decode_mqattn).  Every
             prefill-append attends through attn_density (one launch per
             layer).  The kernel launch counts are zeroed just before
             each run and read just after; each rerun from the same seed
             must give identical tokens and bit plans; quantize
             launches per chunk and per switch-out are reported.  Every
             paged_extend and paged_decode call is one replay of its
             bucket's CUDA graph (core/graphs.py, every bucket captured
             when the service builds its pool): replays must equal
             calls, and after each run every graph, replayed on its
             last staged inputs, must give its eager body's logits,
             density or mass and arena bytes bit for bit (graph_check,
             which prints the graphs captured per entry and bucket, the
             capture seconds and the graph pool's bytes; the peak memory
             is printed too).  Then
             the same model decodes over an all-int8 cache (decode_qattn,
             one launch per layer and token), twice, with identical
             tokens and masses, one token of the first run profiled;
3b. router — the main path through its normal entry point: the port's
             launch.serve.serve (main's serving step: service config,
             the restore pipeline's profile, trace, router, run_trace)
             replays a markov trace (trace.synth.synthesize, seed SEED;
             ROUTER) of 16 calls over 6 contexts through an inline
             ServiceRouter (2 apps at priority mix 1:1, decode_batch 4,
             slice_steps 4, next-context hints) over LLMService on the
             same llama2-7b weights, then a preemption episode (a
             background generation on every slot, a foreground call
             arriving after their second round).  With the bf16 pool and
             with quant_resident=True, each with a same-seed rerun that
             must give identical tokens, bit plans and evictions; then
             once with the service's own AoT swap-out off (llms_nolife),
             where the next-context hint must flush chunks, and once at
             decode_batch 1, whose tokens are compared with the batched
             run's (reported, not required): the share that agrees, and
             for each call the first step where the picks differ, with
             the B = 1 run's top-2 gap and the runs' logit difference
             there.  No call may fail, chunks must go to disk and come
             back, rounds must run with B >= 2, and the quant run must
             launch decode_mqattn on such a round.  Then smollm-360m at
             full width (G = 3, hd 64, tied head) serves 8 calls the
             same way, with a rerun, and once through launch.serve.main
             itself (its own seeded init, the threaded router, the
             printed JSON read back).  Kernel launch counts are zeroed
             just before each replay and read just after; every run's
             graphs are gated as the serve phase's (graph_check);
3c. slot  — the slot engine (paged_pool=False) on the same llama2-7b
             weights, the serve phase's trace (SLOT): llms with the
             card's restore profile and a rerun under that profile
             (identical tokens, bit plans and splits required), llms
             unprofiled (the heaviest half of each restore recomputed:
             the Fig.-8 layer-pipelined restore, one of them profiled),
             llms_nopipe, the whole-state baselines swap and lmk, and
             llms with quant_resident (decode_mqattn on the mixed slot
             cache); each run's tokens held against a no-pressure run
             call by call (first divergence and top-2 gap reported),
             switch_s over disk restores, the splits and each pipelined
             restore's wall time and its gates' wait for the feed
             reported; each pipelined restore is one replay of the
             slot's graph (one per token bucket and I/O bucket, captured
             when the service builds its slots), its gates launched once
             a layer.
             Kernel launch counts are zeroed just before each run and
             read just after.  The first attn_density call of each shape
             and mask in a run is kept (inputs and result) and held
             against the plain version after the run (_SlotHooks, which
             the MLA phase shares).  Then one full-width restore into a
             slot through its graph, against whole-file inserts +
             extend_nod and against the same body run eagerly on a
             private clone, which must agree bit for bit, window and
             mixed cache, with no implicit sync (pipelined_check); the
             gate kernel (csrc/feed_gate.cu) is held against its plain
             version for a published, a failed and a missing word and a
             word published while it waits (gate_phase);
3d. mla   — the earlier models freed, deepseek-v2-lite-16b at full
             width (27 layers, d 2048, 16 heads, rank 512 + rope 64, 64
             experts top-6 + 2 shared, vocab 102,400; random bf16
             weights from SEED drawn on the card) through
             launch.serve.serve (MLA: the serve phase's trace, one app,
             decode_batch 1, slot caches, 12 raw latent chunks): a
             no-pressure llms run, llms under the card's profile (one
             decode token and one recompute profiled) and its rerun
             under that profile (identical tokens, bit plans and splits
             required), llms + quant_resident (the mixed latent layout),
             swap and lmk, each against the no-pressure run call by
             call; every recompute launches attn_density once a layer,
             and each shape it ran at is held against the plain version
             on that call's own inputs.
             Kernel launch counts are zeroed just before each replay and
             read just after; the weights stay for the zoo;
3e. rwkv  — rwkv6-1.6b at full width (24 layers, d 2048, 32 heads of 64,
             d_ff 7168, vocab 65,536; random weights from SEED drawn on
             the card) through launch.serve.serve on the serve phase's
             trace (RWKV: one app, decode_batch 1, slot caches, a budget
             of two whole-state snapshots of 12,779,520 B: wkv fp32,
             tm / cm fp16): no pressure, llms and its rerun, swap and lmk.
             llms, its rerun and swap must give the no-pressure tokens
             call for call; lmk's first divergence in a call must be a
             near-tie; every snapshot keeps wkv in fp32; >= 2 disk
             restores a run; no kernel of the port may launch.  Then one
             decode token and one 64-token recompute profiled, the
             token's matmuls against the bytes floor; the weights stay;
3f. zoo   — the mixed_zoo scenario at full width: dense llama2-7b (drawn
             again), deepseek-v2-lite-16b and rwkv6-1.6b behind one
             router, one byte budget (ZOO) and one swap tier, built by
             the port's build_zoo_service and driven by run_scenario,
             one all-I/O restore profile in every member.  mixed twice
             (equal deterministic views), each family solo on its app's
             share of the events (equal tokens), the MLA quant-resident
             A/B (identical to force_dequant, fewer resident bytes than
             16-bit llms_nocomp).  Every family serves 6 calls and
             restores from disk; an eviction crosses families; mem_used
             stays within the budget; the mixed runs launch the codec,
             attn_density and decode_mqattn, never decode_qattn, and
             each run's first attn_density and decode_mqattn call of
             every shape is held against the plain version.  Kernel
             launch counts are zeroed just before each run and read
             just after;
3g. prefill — the serve phase's llama2-7b: ``prefill`` of 512 and 4096
             random tokens with the density (the served form, where the
             reference takes gqa_attention, and the flash form, where it
             takes its blocked flash functions) against the port's
             extend of the same tokens, one attn_density launch a layer,
             the prefill's own calls held against the plain version;
             attn_density at the prefill's shapes (H 32 and the VLM's
             H 64 / KV 8, 512 served and 4096 flash) against its plain
             version and timed beside it, its bound and
             scaled_dot_product_attention(is_causal=True);
3h. vlm   — every earlier model freed, llama-3.2-vision-90b at full width
             and depth 10 (two blocks of 4 self layers + a gated cross
             layer over 1601 image tokens; random weights, gates and
             patches from SEED): prefill of a 512-token prompt, 32
             greedy decode steps, twice (identical), against a prefill
             of the 544 tokens; one prefill and one token profiled;
3i. moe   — llama4-maverick-400b-a17b at full width and depth 2 (the one
             cut; 64.6 GiB of random bf16 weights drawn one expert at a
             time after the card's free memory is logged) through
             launch.serve.serve on the serve phase's trace (MOE: slot
             caches, 8 raw chunks): no pressure, llms (a decode token
             and a recompute profiled, the token's products against the
             weights' bytes floor) + rerun, quant_resident (its
             decode_mqattn calls held against the plain version), swap,
             lmk, each against the no-pressure run; every restore by
             I/O; then decode_batch 2 against 1 (_batch_divergence);
3j. encdec — whisper-base at full width and depth (6 + 6 layers, d 512,
             vocab 51,865; random weights and 1500 audio frames from
             SEED): prefill of 384 tokens with the density, 64 greedy
             tokens up to the 448-position cap, twice (identical),
             against a prefill of the 448; 6 attn_density launches a
             prefill, none a decode; one prefill and one token profiled
             (``_greedy_runs``, which the VLM phase shares);
3k. rglru  — recurrentgemma-2b at full width and depth (26 layers, 8 of
             them local MQA at (10 heads over 1, hd 256), window 2048;
             2.68 B random weights from SEED): prompts of 512 (the
             served form) and 4096 (the flash form; the window bites),
             each with the density, 32 greedy tokens, twice, against a
             prefill of prompt + 32; 8 attn_density launches a prefill;
3l. train  — the training path through launch.train.main (TRAIN):
             smollm-360m at full width and depth (random weights from
             SEED, SyntheticLM batches), each step timed between
             synchronisations with the launch counts zeroed just before
             it and read just after (_TrainSteps): (a) seq 4096 x 1, 6
             steps of fp32 AdamW (flash_attention: the row-stats
             kernel, 2 x 32 launches a step, required), a checkpoint
             every 3 steps (the step-3 one restored byte for byte),
             step 2 profiled (busy, idle, attn_density, fp32 and bf16
             products); (b) the same with --quantized-opt; (c) seq 512
             x 4, 4 steps (gqa_attention: no launch); (d) (a)'s first 3
             steps again (bit for bit or not, reported) and (a) resumed
             from its step-3 checkpoint (losses within RESUME_RTOL);
             wall per step, tokens/s, peak memory, model FLOPs a step,
             one apply_updates alone;
3m. dryrun — launch/dryrun.py's main over every cell of ASSIGNED x
             SHAPES on the meta device, single and multi-pod (no cell
             may fail; only whisper-base x long_500k is skipped), the
             per-device argument GiB of each cell printed; then the
             single-pod data-parallel shares of DRYRUN_RUNS on the card
             at full width and depth (no cut allowed but for the VLM)
             through run_cell(..., run=True), every decode and prefill
             share's last timed call bit-identical to its warm call:
             qwen2.5-14b x decode_32k and
             smollm-360m x long_500k over the all-int8 cache
             (decode_qattn once a layer, every layer's call held against
             the plain version on its own inputs, the logits against the
             plain run's, a differing greedy pick only at a near-tie),
             smollm-360m x prefill_32k (attn_density with the density
             once a layer, the first call's last 512 query rows held)
             and x train_4k (the row-stats kernel twice a layer on each
             of 2 splits, finite loss and grad norm), rwkv6-1.6b x
             long_500k (its recurrent state put back before each call;
             no kernel) and llama-3.2-vision-90b x decode_32k over its
             int8 cache without scales (the reference's dtype flow in
             plain PyTorch, no kernel; depth cut by _fit_depth, the cut
             printed); each share's wall,
             peak and launches of one call are read from its record;
             then attn_density and decode_qattn timed at those shapes
             beside their bounds, their plain versions and SDPA;
4. check   — the reduced llama2-7b and the reduced smollm-360m (G = 2,
             tied head) served teacher-forced on the card agree with the
             same port on the CPU (plain PyTorch), over the bf16 page
             view, a mixed (quant-resident) view and an all-int8 decode
             cache; the reduced llama2-7b's pipelined restore; the
             reduced deepseek-v2-lite's recompute (latents, density) and
             absorbed decode (logits, masses), window and mixed cache;
             and the reduced rwkv6's prefill, decode steps and
             recompute (logits, wkv state, _check_rwkv6); the reduced
             dense and MLA prefill in the reference's three branches
             (_check_prefill), the reduced llama4-maverick's recompute
             and decode over window and mixed caches (_check_moe) and
             the reduced VLM's prefills and decode (_check_vlm), MoE
             routing held to the CPU's at expert near-ties
             (_ExpertTies); the reduced whisper-base's prefill and
             decode (_check_encdec) and the reduced recurrentgemma's
             prefills (served under its window, flash at 2,100 tokens),
             decode and recurrent state (_check_rglru); then
             flash_attention's out and dq, dk, dv (_check_flash_grads)
             and every family's reduced loss and gradients
             (_check_train_families, MoE routing held by _ExpertTies),
             card against CPU.

The last lines are the kernel record ({"kernels": [...]}), the card's
``nvidia-smi`` name and power limit, and {"ok": true, "device": ...}.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import warnings

SEED = 0
SERVE_SHAPE = (16, 32 * 32 * 128)          # one chunk leaf of llama2-7b
CHECK_SHAPES = [SERVE_SHAPE, (16, 384), (32, 100), (4, 64)]
# decode_mqattn cases (B, S, H, KV, hd): llama2-7b's serving shape at
# batch 1 and 4, a long GQA cache, a ragged tail, a tiny GQA case
MQ_SHAPES = [(1, 512, 32, 32, 128), (4, 512, 32, 32, 128),
             (2, 4096, 32, 8, 128), (3, 4100, 4, 4, 16), (1, 16, 4, 2, 16)]
MQ_TIMED = [(1, 512, 32, 32, 128, 0.5), (1, 4096, 32, 32, 128, 0.5)]
# decode_mqattn edge cases of the split plan (B, S, H, KV, hd, n_valid per
# row, (window, sinks) settings): n_valid inside a split; splits wholly
# between the sinks and the window; rows of one batch ending in different
# splits; one split; hd not a multiple of 8 (element-wise loads)
MQ_EDGE = [((1, 512, 32, 32, 128), [100], ((0, 0), (256, 4))),
           ((1, 512, 32, 32, 128), [512], ((128, 4), (64, 0))),
           ((4, 512, 32, 32, 128), [512, 1, 200, 77], ((0, 0), (128, 4))),
           ((1, 16, 4, 2, 16), [16], ((0, 0), (8, 2))),
           ((2, 300, 8, 2, 20), [300, 131], ((0, 0), (64, 3)))]
# the other dense configs' attention shapes (name, H, KV, hd): G = 3 with
# hd 64 (attn_density's small path), G = 5 and G = 8, at S = 512
GQA_SHAPES = [("smollm-360m", 15, 5, 64), ("qwen2.5-14b", 40, 8, 128),
              ("qwen3-32b", 64, 8, 128)]
MQ_OUT_TOL = 2 ** -7                       # x max|out_plain|: two bf16 ulps
PROFILED_ROUND = 81                        # 4th decode round of the last call
MQ_MASS_TOL = 1e-6
# attn_density: out as above; the density (fp32 sums of probabilities in
# another order) within 1e-5 of the largest density
AD_DENS_TOL = 1e-5
AD_SERVE = dict(S=512, H=32, hd=128, bucket=64, pad=511)
# MoE routing on the card against the CPU: the router's fp32 softmax
# gates of inputs that differ at bf16 level may differ by this much
# (absolute) at a token whose expert choice is a near-tie
GATE_TOL = 1e-2
# the kernels' names, as the profiler reports them
AD_KERNELS = ("attn_density_tc_kernel", "attn_density_reduce_kernel",
              "attn_density_stats_kernel", "attn_flash_fwd_kernel",
              "attn_flash_bounds_kernel", "attn_flash_mass_kernel",
              "attn_flash_finish_kernel")
# of them, csrc/attn_flash.cu's density pass (the flash form at head
# dims 64 and 128)
FLASH_MASS_KERNELS = AD_KERNELS[4:]
MQ_KERNELS = ("mq_split_kernel", "mq_split_pv_kernel", "mq_combine_kernel")
DQ_KERNELS = ("dq_split_kernel", "dq_split_pv_kernel", "dq_combine_kernel")
QUANT_KERNEL = "quant_leaves_kernel<"
PROFILE_TRIES = 3                          # profiler windows before a miss
HBM_BYTES_PER_S = 3.35e12                  # H100 SXM data sheet
FP32_OPS_PER_S = 67e12                     # H100 SXM, outside tensor cores
BF16_OPS_PER_S = 989e12                    # H100 SXM, bf16 tensor cores
INT8_DECODE = dict(S=512, prompt=32, new=32)
# the router phase: launch.serve's markov trace of Table-3 lengths scaled
# by 0.1 (prompts of 1-160 tokens), 8 new tokens a call, 2 apps at 1:1,
# decode slices of 4 rounds over a batch of up to 4, a window of 512 (no
# call drops: prompt + new <= 256) and a budget of 6 raw chunks, so that
# chunks go to disk and come back; the 10th round of >= 2 rows profiled
ROUTER = dict(contexts=6, calls=16, gqa_calls=8, max_new=8,
              max_ctx=512, budget_chunks=6, decode_batch=4, slice_steps=4,
              apps=2, mix="1:1", profiled_round=10)
# the slot phase: the serve phase's trace with paged_pool=False and a
# budget of 8 raw chunks (64 MiB; a whole-state snapshot of 64 tokens
# takes 4), so that every policy restores from disk (lmk: recomputes a
# killed context) at least twice; the full-width restore check reads
# chunks SLOT["io"] at SLOT["io_bits"] and recomputes SLOT["recompute"]
# (64 query rows with the bucket pads) of a 128-token context
SLOT = dict(budget_chunks=8, max_ctx=256, n_tokens=128, io=[0, 2, 3, 6],
            io_bits=[8, 4, 2, 16], recompute=[1, 4, 5])
# the MLA phase: deepseek-v2-lite-16b at full width on the serve phase's
# trace, slot caches (its KVSpec declares no paged pool), a budget of 12
# raw latent chunks (16 x 576 x 27 bf16 = 0.47 MiB each), so that every
# policy restores at least twice
MLA = dict(tag="mla", arch="deepseek-v2-lite-16b", budget_chunks=12,
           max_ctx=256, min_bits=8, mixed_decode_kernel=False)
# its chunk leaves (T, layers x width): ckv (16, 27 x 512), kpe (16, 27 x 64)
MLA_CODEC_SHAPES = ((16, 27 * 512), (16, 27 * 64))
# attn_density at MLA's recompute: H = KV = 16, Dqk 128 + 64, Dv 128, a
# 64-row bucket over the slot cache of max_ctx_len 256 (S = 512) and 256
AD_MLA = dict(H=16, dqk=192, dv=128, S=(512, 256))
# 3g: the full-sequence prefill on the serve phase's llama2-7b: 512
# tokens (the served form: the reference's gqa_attention branch) and
# 4096 (the flash form: its flash / blocked branches), each against the
# port's extend of the same tokens
PREFILL = dict(S=(512, 4096))
# 3h: llama-3.2-vision-90b at full width and the reference's reduced
# depth of 10 (two blocks of 4 self layers + 1 cross layer; 1601 image
# tokens of 7680): a 512-token prompt with patches, 32 greedy tokens
VLM = dict(arch="llama-3.2-vision-90b", n_layers=10, prompt=512, new=32)
# the families no service takes (VLM, encdec, rglru): a greedy decode's
# last logits against a prefill of the same tokens, relative L2
DECODE_VS_PREFILL = 5e-2
# 3j: whisper-base at full width and depth (6 + 6 layers, 1500 audio
# frames): a 384-token prompt, 64 greedy tokens up to the 448 cap
ENCDEC = dict(arch="whisper-base", prompt=384, new=64)
# 3k: recurrentgemma-2b at full width and depth (26 layers, 8 of them
# local MQA at hd 256, window 2048): prompts of 512 (attn_density's served
# form) and 4096 (its flash form; the window bites), 32 greedy tokens
RGLRU = dict(arch="recurrentgemma-2b", prompts=(512, 4096), new=32)
# attn_density at those families' prefill shapes, each with the density:
# (family, S, H, KV, hd, window, form)
AD_NEW = (("rglru", 512, 10, 1, 256, 2048, "served"),
          ("rglru", 4096, 10, 1, 256, 2048, "flash"),
          ("encdec", 448, 8, 8, 64, 0, "served"))
# 3l: the training path on smollm-360m (the reference trainer's default
# --arch) at full width and depth: (seq, batch, steps) of the long runs,
# which attend through flash_attention (the attn_density row-stats
# kernel, two launches a layer and step: the forward and its
# checkpointed recompute), and of the short one (gqa_attention, no
# kernel); a checkpoint every 3 steps of the first long run, the step
# of it that is profiled
TRAIN = dict(arch="smollm-360m", long=(4096, 1, 6), short=(512, 4, 4),
             ckpt_every=3, profile_step=2)
# the row-stats variant against its plain version: (B, S, H, KV, Dqk, Dv,
# window, n_sinks), causal over S keys: smollm-360m at width, the
# reduced dense / MLA / rglru training shapes, a window with sinks on
# 16-row tiles, Sk off the tiles, HDQ 128 and 192 on 64-row tiles, and
# recurrentgemma's HDQ 256 (V in halves: half 0 writes the stats)
STATS_SHAPES = ((1, 4096, 15, 5, 64, 64, 0, 0),
                (1, 2100, 4, 2, 16, 16, 0, 0),
                (1, 2100, 4, 4, 24, 16, 0, 0),
                (1, 2100, 4, 1, 32, 32, 64, 0),
                (2, 40, 4, 1, 16, 16, 12, 2),
                (1, 37, 6, 3, 32, 32, 0, 0),
                (1, 512, 32, 32, 128, 128, 0, 0),
                (1, 1024, 16, 16, 192, 128, 0, 0),
                (1, 4096, 10, 1, 256, 256, 2048, 0))
# the stats (fp32 in both, sums in another order): m within STATS_TOL of
# max(1, max |m|), l within STATS_TOL relative
STATS_TOL = 1e-5
# the resumed run's losses against the uninterrupted run's (the embedding
# gather's backward accumulates with atomics on the card, so a rerun may
# move a last bit)
RESUME_RTOL = 1e-4
# every family's reduced loss and gradients, card against CPU (bf16
# products rounded at other places): the loss within rtol
# TRAIN_LOSS_RTOL, each gradient leaf within relative L2 TRAIN_GRAD_L2
# and max |diff| TRAIN_GRAD_MAX of its largest magnitude (the VLM's
# one-scalar-a-layer tanh gates, sums that largely cancel,
# TRAIN_GATE_TOL), as tests/test_torch_train_families.py holds them to
# the reference; flash_attention's grads within FLASH_GRAD_TOL of their
# largest value (the card's forward rounds p to bf16 before PV, the
# CPU's does not, and delta = rowsum(dout out) carries it)
TRAIN_LOSS_RTOL = 1e-3
TRAIN_GRAD_L2, TRAIN_GRAD_MAX, TRAIN_GATE_TOL = 0.05, 0.10, 0.30
FLASH_GRAD_TOL = 0.02
# 3i: llama4-maverick-400b-a17b at full width and depth 2 (its one cut:
# one layer's 128 experts are 32.2 GB, so two fit one card) on the serve
# phase's trace, slot caches (no pool in its KVSpec), a budget of 8 raw
# chunks (2 layers x 16 tokens x k+v x 8 x 128 x bf16 = 128 KiB each)
MOE = dict(tag="moe", arch="llama4-maverick-400b-a17b", n_layers=2,
           budget_chunks=8, max_ctx=256, min_bits=2,
           mixed_decode_kernel=True)
# its chunk leaves (T, layers x KV x hd): k and v (16, 2 x 8 x 128)
MOE_CODEC_SHAPES = ((16, 2 * 8 * 128), (16, 2 * 8 * 128))
# 3m: the dry run (launch/dryrun.py): every cell of ASSIGNED x SHAPES on
# the meta device on both meshes, then these cells' data-parallel shares
# on the card at full width (arch, shape, --kv-dtype), each with the
# launches of one call that the path must make: decode_qattn once a
# layer over the all-int8 cache; attn_density (with the density) once a
# layer in the 32k prefill; the row-stats kernel twice a layer (the
# forward and its checkpointed recompute) on each of n_micro = 2 splits;
# no kernel in RWKV6's decode nor in the VLM's decode over its int8
# cache, which has no scales (plain PyTorch, as the reference computes
# it in jnp)
DRYRUN_RUNS = (("qwen2.5-14b", "decode_32k", "int8"),
               ("smollm-360m", "long_500k", "int8"),
               ("smollm-360m", "prefill_32k", "bf16"),
               ("smollm-360m", "train_4k", "bf16"),
               ("rwkv6-1.6b", "long_500k", "bf16"),
               ("llama-3.2-vision-90b", "decode_32k", "int8"))
# the one share that may run cut in depth (its 176 GB of bf16 weights
# do not fit the card); its cut is printed and recorded
DRYRUN_CUT_OK = frozenset({"llama-3.2-vision-90b"})
# 3e: rwkv6-1.6b at full width (one whole-state snapshot a context:
# wkv 24 x 32 x 64 x 64 fp32 + tm / cm 2 x 24 x 2048 fp16 = 12,779,520 B)
RWKV = dict(arch="rwkv6-1.6b", budget_snapshots=2, max_ctx=256)
# 3f: the mixed_zoo scenario at full width, its budget raised from the
# reduced models' 60,000 B to 16 MiB (1.3 whole-state snapshots): at 32
# MiB the level-16 snapshots absorbed every reclaim and no dense or MLA
# chunk left memory (PERF.md); one all-I/O restore profile in every member
ZOO = dict(archs={"dense": "llama2-7b", "mla_moe": "deepseek-v2-lite-16b",
                  "rwkv6": "rwkv6-1.6b"},
           budget_mib=16,
           profile=dict(re_base=1.0, re_per_chunk=1.0, io_base=0.0,
                        io_per_byte=0.0))


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------- #
# 1. build
# --------------------------------------------------------------------- #
def _kernel_label(mangled: str) -> str:
    """A mangled kernel name's own name and template arguments, e.g.
    ``mq_split_kernelILi1ELb0E`` (the name follows its length)."""
    end = mangled.find("_kernel")
    if end < 0:
        return mangled[:72]
    end += len("_kernel")
    for start in range(end - 1, 0, -1):
        for k in (1, 2, 3):
            d = mangled[max(0, start - k):start]
            if d.isdigit() and int(d) == end - start:
                args = re.match(r"I\w*?E(?=E)", mangled[end:])
                return mangled[start:end] + (args.group(0) if args else "")
    return mangled[:72]


def build_phase():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    logs = build.build_all(build.SOURCES)
    log(f"[build] nvcc {' '.join(build.NVCC_FLAGS)}: "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        entry = "?"
        for line in text.splitlines():
            if "Compiling entry function" in line:
                # the mangled name, e.g. ..._cu_95efd00315mq_split_kernelILi1E
                # ELb0EEEvN...: the kernel's name and template arguments
                entry = _kernel_label(line.split("'")[1] if "'" in line
                                      else line)
            elif "registers" in line or "spill" in line:
                log(f"[build] {name}: {entry}: {line.strip()}")
    smi = nvidia_smi_line()
    log(f"[build] card: {smi}")
    return smi


# --------------------------------------------------------------------- #
# 2. kernels vs plain versions
# --------------------------------------------------------------------- #
def _time_ms(fn, iters=200, warmup=20):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


_FLUSH = {}


def _host_ms_pair(a, b, iters=40, warmup=5):
    """Median host time of ``a`` and of ``b``, run in turns (a, b, b, a,
    ...) so that both see the same host; each must end synchronised."""
    for _ in range(warmup):
        a()
        b()
    times = {a: [], b: []}
    for i in range(iters):
        for fn in ((a, b) if i % 2 == 0 else (b, a)):
            t0 = time.perf_counter()
            fn()
            times[fn].append((time.perf_counter() - t0) * 1e3)
    return tuple(sorted(times[f])[iters // 2] for f in (a, b))


def _l2_flush():
    """(flush, its kernels): a callable that writes 128 MiB (more than
    the card's 50 MB L2), so that the next call finds none of its inputs
    in the L2, and the names the profiler gives the flush's kernels,
    learnt once over ten flushes."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not _FLUSH:
        buf = torch.empty(16 * 2**20, dtype=torch.int64, device="cuda")
        flush = lambda: buf.fill_(7)                     # noqa: E731
        flush()
        torch.cuda.synchronize()
        for i in range(PROFILE_TRIES):      # see _device_ms
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    flush()
                torch.cuda.synchronize()
            keys = {ev.key for ev in prof.key_averages()
                    if _device_us(ev) > 0}
            if keys:
                break
            log(f"[profiler] window {i + 1} of {PROFILE_TRIES} recorded "
                "no kernel of the L2 flush; profiling it again")
        if not keys:
            raise AssertionError("the profiler recorded no kernel of the "
                                 f"L2 flush in {PROFILE_TRIES} windows")
        _FLUSH.update(fn=flush, keys=keys)
    return _FLUSH["fn"], _FLUSH["keys"]


def _device_us(ev) -> float:
    return getattr(ev, "device_time_total",
                   getattr(ev, "cuda_time_total", 0.0))


def _event_ms(fn, iters, flush=None):
    """Time per call by CUDA events (``_time_ms``); with the callable
    ``flush`` run before every call, the flush's own time taken off."""
    if flush is None:
        return _time_ms(fn, iters=iters, warmup=1)
    both = _time_ms(lambda: (flush(), fn()), iters=iters, warmup=1)
    return both - _time_ms(flush, iters=iters, warmup=1)


def _device_ms(fn, match=None, iters=50, by_kernel=None, flush=None):
    """Device time per call from the profiler's CUDA kernel records: the
    kernels whose name contains ``match`` (a string or a tuple of them;
    all kernels when None), summed and divided by ``iters``.  Raises when
    ``match`` is given and no kernel matches it although the profiler
    recorded other kernels (a kernel renamed without its match); when
    the profiler recorded no kernel at all in PROFILE_TRIES windows, the
    time per call by CUDA events instead (logged, and named so in
    ``by_kernel``), as the profiler's own failure; None when ``match`` is
    None and the profiler records no device time.  With a dict
    ``by_kernel``, also each counted kernel's time per call, by name.
    With ``flush`` (``_l2_flush()``), the flush runs before every call
    and its own kernels are left out: the call's time with a cold L2."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    flush, skip = flush if flush is not None else (None, set())
    subs = (match,) if isinstance(match, str) else match
    fn()
    torch.cuda.synchronize()
    # the profiler now and then records no kernel of a window (seen on
    # this card's machine in two runs of many): profile the window again,
    # up to PROFILE_TRIES times, before calling the kernel missing
    seen = False               # a window recorded some kernel's time
    for i in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                if flush is not None:
                    flush()
                fn()
            torch.cuda.synchronize()
        total_us, parts = 0.0, {}
        for ev in prof.key_averages():
            seen = seen or _device_us(ev) > 0
            if ev.key in skip:
                continue
            if subs is None or any(m in ev.key for m in subs):
                us = _device_us(ev)
                total_us += us
                if us > 0:
                    if subs is None:
                        name = ev.key[:96]
                    else:
                        m = next(m for m in subs if m in ev.key)
                        name = ev.key[ev.key.index(m):].split("(")[0]
                    parts[name] = us / iters / 1e3
        if subs is None or total_us > 0:
            break
        log(f"[profiler] window {i + 1} of {PROFILE_TRIES} recorded no "
            f"device time for a kernel matching {subs}; profiling it again")
    if subs is not None and total_us == 0:
        if seen:
            raise AssertionError(f"the profiler recorded no device time for "
                                 f"a kernel matching {subs} in "
                                 f"{PROFILE_TRIES} windows")
        ms = _event_ms(fn, iters, flush)
        log(f"[profiler] {PROFILE_TRIES} windows recorded no kernel at all; "
            f"{subs} timed by CUDA events instead: {ms} ms a call")
        if by_kernel is not None:
            by_kernel["CUDA events, whole call"] = ms
        return ms
    if by_kernel is not None:
        by_kernel.update(parts)
    return total_us / iters / 1e3 if total_us > 0 else None


def _device_ms_whole(fn, call_ms, iters, by_kernel):
    """``_device_ms`` over AD_KERNELS, held to the time per call: a long
    call (0.1 ms or more a call, so that back-to-back calls keep the card
    busy) whose profiled device time is below 0.8 of its time per call
    lost kernels to the profiler's window (seen on the card: a call
    with the density read below the same call without it); it is timed
    by CUDA events instead (``_event_ms``), and ``by_kernel`` keeps the
    profiler's partial reading under "profiler (short)"."""
    ms = _device_ms(fn, AD_KERNELS, iters=iters, by_kernel=by_kernel)
    if ms is not None and call_ms >= 0.1 and ms < 0.8 * call_ms:
        by_kernel["profiler (short)"] = ms
        ms = _event_ms(fn, iters)
        log(f"[profiler] {by_kernel['profiler (short)']} ms on the device "
            f"against {call_ms} ms a call: kernels missed; CUDA events: "
            f"{ms} ms a call")
    return ms


def _is_matmul(name: str) -> bool:
    return any(t in name for t in ("gemm", "gemv", "xmma", "cutlass",
                                   "nvjet"))


def _train_category(name: str) -> str:
    """A kernel's category in a profiled train step: attn_density, the
    products that read fp32 operands (sgemm, f32 x f32 xmma / nvjet
    tiles: the flash backward's) and the bf16 ones, the rest."""
    if any(t in name for t in AD_KERNELS):
        return "attn_density"
    if not _is_matmul(name):
        return "other"
    fp32 = not any(t in name for t in ("bf16", "hsh", "tst", "hgemm",
                                       "s16816", "h16816")) and any(
        t in name for t in ("sgemm", "f32f32", "sss", "simt", "gemmsn",
                            "gemv2n", "gemvx", "f32_f32"))
    return "matmul fp32" if fp32 else "matmul bf16"


def _serve_category(name: str) -> str:
    """A kernel's category in a profiled serving step."""
    return ("feed_gate (waiting for the feed)" if "feed_gate" in name
            else "decode_mqattn" if any(t in name for t in MQ_KERNELS)
            else "decode_qattn" if any(t in name for t in DQ_KERNELS)
            else "attn_density" if any(t in name for t in AD_KERNELS)
            else "indexing (page gather, scatter)" if "index" in name
            else "matmul" if _is_matmul(name) else "other")


def _profile_round(fn, top=0, category=_serve_category):
    """Run ``fn`` once under the profiler (CUDA activity only): its host
    wall time, the device time of its kernels by ``category`` (of the
    lower-cased kernel name), and the device's idle share of the wall
    time (profiler overhead included); with ``top``, also the ``top``
    kernels with the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    cats, n_kernels = {}, 0
    for ev in prof.key_averages():
        cat = category(ev.key.lower())
        cats[cat] = cats.get(cat, 0.0) + _device_us(ev) / 1e3
        n_kernels += ev.count
    busy = sum(cats.values())
    info = {"wall_ms": wall_ms, "device_ms": busy,
            "idle_share": 1.0 - busy / wall_ms, "kernels": n_kernels,
            "by_category_ms": cats}
    if top:
        evs = sorted(prof.key_averages(), key=_device_us, reverse=True)
        info["top_kernels_ms"] = [(ev.key[:80], _device_us(ev) / 1e3,
                                   ev.count) for ev in evs[:top]]
    return out, info


def _codec_bound_ms(T, F, bits, in_bytes):
    """Least time for one launch: every input byte read once and every
    output byte written once at the HBM rate, or ~8 fp32 operations per
    element at the fp32 rate, whichever is larger."""
    packed = T * bits // 8 * F + 4 * F           # codes + scales
    dense = T * F * in_bytes
    nbytes = dense + packed
    ops = 8 * T * F
    bound_s = max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)
    by = "bytes" if nbytes / HBM_BYTES_PER_S >= ops / FP32_OPS_PER_S \
        else "operations"
    return bound_s * 1e3, by


def kernel_phase():
    import torch
    from repro_torch.kernels import chunk_quant, ref
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    max_err = 0.0
    n_cases = 0
    for shape in CHECK_SHAPES:
        T, F = shape
        for dt in (torch.bfloat16, torch.float32):
            for bits in (8, 4, 2):
                x = (torch.randn(shape, generator=g, device=dev) * 3).to(dt)
                x[:, 0] = 0                      # the 1e-8 scale floor
                # a second leaf of the chunk, of another F (ragged when
                # x's F is a multiple of the 16-byte vectors)
                y = (torch.randn((T, 100 if F % 8 == 0 else 384),
                                 generator=g, device=dev) * 3).to(dt)
                p_k, s_k = chunk_quant.quantize(x, bits)
                p_r, s_r = ref.quantize_ref(x, bits)
                _, leaves = chunk_quant.quantize_leaves([x, y], bits)
                torch.cuda.synchronize()
                for label, got, want in (
                        ("quantize", (p_k, s_k), (p_r, s_r)),
                        ("one launch of two leaves, leaf 1", leaves[0],
                         (p_r, s_r)),
                        ("one launch of two leaves, leaf 2", leaves[1],
                         ref.quantize_ref(y, bits))):
                    if not (torch.equal(got[0], want[0])
                            and torch.equal(got[1], want[1])):
                        bad = int((got[0] != want[0]).sum()) + int(
                            (got[1] != want[1]).sum())
                        raise AssertionError(
                            f"{label} {shape} {dt} {bits}-bit: {bad} codes "
                            "or scales differ from the plain version")
                for out_dt in (torch.bfloat16, torch.float32):
                    d_k = chunk_quant.dequantize(p_r, s_r, bits, T, out_dt)
                    d_r = ref.dequantize_ref(p_r, s_r, bits, T, out_dt)
                    torch.cuda.synchronize()
                    err = float((d_k.float() - d_r.float()).abs().max())
                    max_err = max(max_err, err)
                    same = torch.equal(d_k.view(torch.int16), d_r.view(
                        torch.int16)) if out_dt == torch.bfloat16 else \
                        torch.equal(d_k.view(torch.int32),
                                    d_r.view(torch.int32))
                    if not same:
                        raise AssertionError(
                            f"dequantize {shape} {bits}-bit -> {out_dt}: "
                            f"max |diff| {err}")
                n_cases += 1
    log(f"[kernels] {n_cases} quantize cases (each also in one launch "
        f"with a second leaf) x 2 dequantize dtypes bit-exact vs the plain "
        f"versions (max |diff| {max_err})")

    T, F = SERVE_SHAPE
    x, x2 = ((torch.randn(SERVE_SHAPE, generator=g, device=dev) * 3
              ).to(torch.bfloat16) for _ in range(2))
    times = {}
    for bits in (8, 4, 2):
        p, s = ref.quantize_ref(x, bits)
        q = lambda: chunk_quant.quantize(x, bits)            # noqa: E731
        q_ref = lambda: ref.quantize_ref(x, bits)            # noqa: E731
        d = lambda: chunk_quant.dequantize(p, s, bits, T)    # noqa: E731
        d_ref = lambda: ref.dequantize_ref(p, s, bits, T)    # noqa: E731
        bound, by = _codec_bound_ms(T, F, bits, 2)
        for name, fn, plain, match in (
                ("quantize", q, q_ref, QUANT_KERNEL),
                ("dequantize", d, d_ref, "dequant_kernel<")):
            row = {"call_ms": _time_ms(fn),
                   "plain_call_ms": _time_ms(plain, iters=50),
                   "device_ms": _device_ms(fn, match),
                   "plain_device_ms": _device_ms(plain),
                   "bound_ms": bound, "bound_by": by}
            times.setdefault(bits, {})[name] = row
            log(f"[kernels] ({T},{F}) bf16 {bits}-bit {name}: kernel "
                f"{row['device_ms']} ms on the device, {row['call_ms']:.5f}"
                f" ms per call; plain {row['plain_device_ms']} ms on the "
                f"device, {row['plain_call_ms']:.5f} ms per call; bound "
                f"{bound:.5f} ms ({by})")
        # a chunk's two leaves (k, v) in one launch, as switch-out runs it,
        # beside two launches of one leaf each
        two = lambda: chunk_quant.quantize_leaves([x, x2], bits)  # noqa: E731
        per_leaf = lambda: (chunk_quant.quantize(x, bits),  # noqa: E731
                            chunk_quant.quantize(x2, bits))
        row = {"call_ms": _time_ms(two),
               "device_ms": _device_ms(two, QUANT_KERNEL),
               "per_leaf_call_ms": _time_ms(per_leaf),
               "per_leaf_device_ms": _device_ms(per_leaf, QUANT_KERNEL),
               "bound_ms": 2 * bound, "bound_by": by}
        times[bits]["quantize_two_leaves"] = row
        log(f"[kernels] ({T},{F}) x 2 leaves bf16 {bits}-bit quantize in one "
            f"launch: {row['device_ms']} ms on the device, "
            f"{row['call_ms']:.5f} ms per call; as two launches "
            f"{row['per_leaf_device_ms']} ms on the device, "
            f"{row['per_leaf_call_ms']:.5f} ms per call; bound "
            f"{2 * bound:.5f} ms ({by})")
    # the switch-out codec step on the host: a chunk's two leaves to a
    # host payload in one launch and one copy, beside the per-leaf form
    # (a launch and two synchronising copies per leaf)
    from repro_torch.core.chunks import ChunkCodec
    codec = ChunkCodec(("k", "v"), T, dev)
    blocks = {"k": x, "v": x2}
    one = lambda: codec.compress_blocks(blocks, 4)        # noqa: E731
    per_leaf = lambda: {                                   # noqa: E731
        n: tuple(t.cpu().numpy() for t in chunk_quant.quantize(b, 4))
        for n, b in blocks.items()}
    one_ms, per_leaf_ms = _host_ms_pair(one, per_leaf)
    times["switch_out_host_ms"] = {"one_launch_one_copy": one_ms,
                                   "per_leaf": per_leaf_ms}
    log(f"[kernels] switch-out codec step, ({T},{F}) x 2 leaves bf16 "
        f"4-bit to a host payload: {one_ms:.4f} ms host time (median) in "
        f"one launch and one copy, {per_leaf_ms:.4f} ms as a launch and two "
        f"copies per leaf")
    return max_err, times


def codec_leaves_phase(tag, shapes, bits):
    """The chunk codec at a family's chunk leaves (``shapes``, (T,
    layers x width) each): the leaves quantized in one launch (as a
    switch-out runs them) and each dequantized, bit for bit against the
    plain versions; timings of both beside their plain versions and
    bounds.  -> {"quantize_two_leaves": row, "dequantize": {shape:
    row}}."""
    import torch
    from repro_torch.kernels import chunk_quant, ref
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    xs = [(torch.randn(shape, generator=g, device=dev) * 3).bfloat16()
          for shape in shapes]
    _, leaves = chunk_quant.quantize_leaves(xs, bits)
    torch.cuda.synchronize()
    for x, (p, s) in zip(xs, leaves):
        p_r, s_r = ref.quantize_ref(x, bits)
        d_k = chunk_quant.dequantize(p_r, s_r, bits, x.shape[0])
        d_r = ref.dequantize_ref(p_r, s_r, bits, x.shape[0])
        torch.cuda.synchronize()
        if not (torch.equal(p, p_r) and torch.equal(s, s_r)
                and torch.equal(d_k.view(torch.int16),
                                d_r.view(torch.int16))):
            raise AssertionError(f"the codec at {tag}'s leaf "
                                 f"{tuple(x.shape)}, {bits}-bit, differs "
                                 "from its plain version")
    bounds = [_codec_bound_ms(T, F, bits, 2) for T, F in shapes]
    two = lambda: chunk_quant.quantize_leaves(xs, bits)       # noqa: E731
    plain = lambda: [ref.quantize_ref(x, bits) for x in xs]   # noqa: E731
    out = {"quantize_two_leaves": {
        "shape": f"{shapes} bf16 {bits}-bit, one launch",
        "call_ms": _time_ms(two), "device_ms": _device_ms(two, QUANT_KERNEL),
        "plain_call_ms": _time_ms(plain, iters=50),
        "plain_device_ms": _device_ms(plain),
        "bound_ms": sum(b for b, _ in bounds), "bound_by": bounds[0][1]},
        "dequantize": {}}
    for x, (p, s), (bound, by) in zip(xs, leaves, bounds):
        T = x.shape[0]
        d = lambda: chunk_quant.dequantize(p, s, bits, T)     # noqa: E731
        d_ref = lambda: ref.dequantize_ref(p, s, bits, T)     # noqa: E731
        out["dequantize"][str(tuple(x.shape))] = {
            "call_ms": _time_ms(d), "device_ms": _device_ms(d, "dequant_kernel<"),
            "plain_call_ms": _time_ms(d_ref, iters=50),
            "plain_device_ms": _device_ms(d_ref), "bound_ms": bound,
            "bound_by": by}
    log(f"[kernels] the codec at {tag}'s chunk leaves {shapes}, {bits}-bit: "
        f"bit-exact vs the plain versions; {json.dumps(out)}")
    return out


def _mq_case(B, S, H, KV, hd, quant_share, g, dev, full=False, cs=16,
             n_valid=None):
    """A mixed cache on the card: bf16 K/V, decode-grid int8 codes and
    scales, the quant mask on whole 16-token chunks with about the given
    share, n_valid per row from [1, S] (S in row 0, 1 in the last row of
    a batch), S everywhere with ``full``, or the given ``n_valid``."""
    import torch
    from repro_torch.kernels import ref
    r = lambda *s: torch.randn(s, generator=g, device=dev)   # noqa: E731
    q, k, v = (r(B, H, hd).bfloat16(), r(B, S, KV, hd).bfloat16(),
               r(B, S, KV, hd).bfloat16())
    k_q, k_s = ref.quantize_token_head_ref(r(B, S, KV, hd) * 2)
    v_q, v_s = ref.quantize_token_head_ref(r(B, S, KV, hd) * 2)
    chunks = torch.rand((B, -(-S // cs)), generator=g, device=dev) \
        < quant_share
    qm = chunks.repeat_interleave(cs, dim=1)[:, :S].contiguous()
    if n_valid is not None:
        nv = torch.tensor(n_valid, dtype=torch.int32, device=dev)
    elif full:
        nv = torch.full((B,), S, dtype=torch.int32, device=dev)
    else:
        nv = torch.randint(1, S + 1, (B,), generator=g, device=dev,
                           dtype=torch.int32)
        nv[0] = S
        if B > 1:
            nv[-1] = 1
    return [q, k, v, k_q, v_q, k_s, v_s, qm, nv]


def _mq_bound_ms(args, want_mass):
    """Least time for one call: the bytes this call's data needs (each
    valid key's row once: 2 hd * 2 bytes per kv-head at a bf16 position,
    2 hd + 8 at a quant position; q, the mask, n_valid, out and mass
    once) over the HBM rate, or its fp32 operations (~4 H hd per valid
    key: QK and PV multiply-adds) over the fp32 rate, the larger."""
    q, k, _, _, _, _, _, qm, nv = args
    B, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    n_q = n_b = 0
    for b in range(B):
        n = int(nv[b])
        nq = int(qm[b, :n].sum())
        n_q, n_b = n_q + nq, n_b + n - nq
    nbytes = (n_b * KV * 2 * hd * 2 + n_q * KV * (2 * hd + 8)
              + 2 * B * H * hd * 2 + B * S + 4 * B
              + (4 * B * S if want_mass else 0))
    ops = 4 * H * hd * (n_q + n_b)
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def mqattn_phase():
    """decode_mqattn against its plain version on the card, both forms,
    with and without the mass; identical reruns; timings."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_mqattn as kmq
    from repro_torch.kernels import ref
    from repro_torch.models.common import configure_numerics
    dev = torch.device("cuda")
    configure_numerics(dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    worst = {"out": 0.0, "out_rel": 0.0, "mass": 0.0}
    n_cases = 0
    cases = [(_mq_case(*shape, share, g, dev), ((0, 0), (256, 4)))
             for shape in MQ_SHAPES for share in (0.0, 0.5, 1.0)]
    cases += [(_mq_case(*shape, 0.5, g, dev, n_valid=nv), masks)
              for shape, nv, masks in MQ_EDGE]
    # the GQA shapes at the router's batch of 4
    cases += [(_mq_case(4, 512, H, KV, hd, 0.5, g, dev), ((0, 0), (256, 4)))
              for _, H, KV, hd in GQA_SHAPES]
    for args, masks in cases:
        B, H, hd = args[0].shape
        S, KV = args[1].shape[1], args[1].shape[2]
        share = round(float(args[7].float().mean()), 3)
        for window, n_sinks in masks:
            for select in (False, True):
                o_r, m_r = ref.decode_mqattn_plain(
                    *args, window, n_sinks, want_mass=True,
                    select=select)
                o_k, m_k = kmq.decode_mqattn(*args, window, n_sinks,
                                             want_mass=True,
                                             select=select)
                o_n = kmq.decode_mqattn(*args, window, n_sinks,
                                        select=select)
                o_2, m_2 = kmq.decode_mqattn(*args, window, n_sinks,
                                             want_mass=True,
                                             select=select)
                torch.cuda.synchronize()
                span = float(o_r.float().abs().max())
                d_o = float((o_k.float() - o_r.float()).abs().max())
                d_m = float((m_k - m_r).abs().max())
                case = (f"({B},{S},{H},{KV},{hd}) share {share} window "
                        f"{window} sinks {n_sinks} "
                        f"{'select' if select else 'fused'}")
                if not (torch.isfinite(o_k.float()).all()
                        and d_o <= MQ_OUT_TOL * span
                        and d_m <= MQ_MASS_TOL):
                    raise AssertionError(
                        f"decode_mqattn {case}: max |d out| {d_o} "
                        f"(range {span}), max |d mass| {d_m}")
                if not (torch.equal(o_n, o_k) and torch.equal(o_2, o_k)
                        and torch.equal(m_2, m_k)):
                    raise AssertionError(
                        f"decode_mqattn {case}: reruns differ")
                valid = ref._valid_keys(args[8], B, S, window, n_sinks, dev)
                if bool((m_k[~valid] != 0).any()):
                    raise AssertionError(
                        f"decode_mqattn {case}: mass not 0 at an invalid key")
                worst["out"] = max(worst["out"], d_o)
                worst["out_rel"] = max(worst["out_rel"],
                                       d_o / max(span, 1e-30))
                worst["mass"] = max(worst["mass"], d_m)
                n_cases += 1
    log(f"[kernels] decode_mqattn: {n_cases} cases ({len(MQ_EDGE)} edge "
        f"shapes of the split plan and the GQA shapes "
        f"{[(H, KV, hd) for _, H, KV, hd in GQA_SHAPES]} at (4, 512) among "
        f"them) x (with, without mass) "
        f"within tolerance of the plain version: max |d out| "
        f"{worst['out']} ({worst['out_rel']} of max|out|, tolerance "
        f"{MQ_OUT_TOL}), max |d mass| {worst['mass']} (tolerance "
        f"{MQ_MASS_TOL}); reruns bit-identical")

    times = []
    for B, S, H, KV, hd, share in MQ_TIMED:
        args = _mq_case(B, S, H, KV, hd, share, g, dev, full=True)
        select = S < 4096                    # the form serving runs there
        fn = lambda: kmq.decode_mqattn(*args, want_mass=True,  # noqa: E731
                                       select=select)
        plain = lambda: ref.decode_mqattn_plain(  # noqa: E731
            *args, want_mass=True, select=select)
        kb, vb = ref._mixed_kv(*args[1:8])
        q4 = args[0][:, :, None]                          # (B, H, 1, hd)
        k4 = kb.transpose(1, 2).contiguous()              # (B, KV, S, hd)
        v4 = vb.transpose(1, 2).contiguous()
        lib = lambda: F.scaled_dot_product_attention(     # noqa: E731
            q4, k4, v4)
        bound, by = _mq_bound_ms(args, True)
        parts = {}
        row = {"shape": f"({B},{S},{H},{KV},{hd})", "quant_share": share,
               "form": "select" if select else "fused",
               "call_ms": _time_ms(fn),
               "device_ms": _device_ms(fn, MQ_KERNELS, by_kernel=parts),
               "device_ms_by_kernel": parts,
               "plain_call_ms": _time_ms(plain, iters=50),
               "plain_device_ms": _device_ms(plain),
               "bound_ms": bound, "bound_by": by,
               **_cold_and_library(fn, MQ_KERNELS, lib, q4, k4, v4)}
        times.append(row)
        log(f"[kernels] decode_mqattn {row['shape']} {row['form']} + mass, "
            f"quant share {share}, n_valid = S: kernel {row['device_ms']} ms"
            f" on the device (L2 cold {row['device_ms_l2_cold']} ms), "
            f"{row['call_ms']:.5f} ms per call; plain "
            f"{row['plain_device_ms']} ms on the device, "
            f"{row['plain_call_ms']:.5f} ms per call; bound "
            f"{bound:.5f} ms ({by}); kernel by launch {parts}, L2 cold "
            f"{row['device_ms_by_kernel_l2_cold']}")
        _log_library("decode_mqattn", row, "over the pre-selected bf16 K/V "
                     "(out only: no dequant, select or mass)")
    return worst, times


def _sdpa_bound_ms(q4, k4, v4):
    """The least time of scaled_dot_product_attention over these bf16
    inputs: q, K, V read once and out written once at the HBM rate."""
    nbytes = 2 * q4.numel() * 2 + (k4.numel() + v4.numel()) * 2
    return nbytes / HBM_BYTES_PER_S * 1e3


def _cold_and_library(fn, match, lib, q4, k4, v4):
    """A decode kernel's device time with a cold L2 (a 128 MiB buffer
    written before every call, its kernels left out), by launch; the
    library call's device time with a warm and a cold L2, the kernels
    the profiler saw for it, its own bytes bound, and whether a reading
    came in below that bound (then it read from the L2, not the HBM,
    and is no yardstick)."""
    flush = _l2_flush()
    cold, lib_warm, lib_cold = {}, {}, {}
    row = {"device_ms_l2_cold": _device_ms(fn, match, iters=30,
                                           by_kernel=cold, flush=flush),
           "device_ms_by_kernel_l2_cold": cold,
           "library_call_ms": _time_ms(lib),
           "library_device_ms": _device_ms(lib, by_kernel=lib_warm),
           "library_device_ms_l2_cold": _device_ms(lib, iters=30,
                                                   by_kernel=lib_cold,
                                                   flush=flush),
           "library_kernels": lib_warm,
           "library_kernels_l2_cold": lib_cold,
           "library_bytes_bound_ms": _sdpa_bound_ms(q4, k4, v4)}
    row["library_below_its_bytes_bound"] = [
        k for k in ("library_device_ms", "library_device_ms_l2_cold")
        if row[k] is not None and row[k] < row["library_bytes_bound_ms"]]
    return row


def _log_library(kernel, row, what):
    flag = (f"; BELOW its bytes bound: {row['library_below_its_bytes_bound']}"
            f" (read from the L2, not a yardstick)"
            if row["library_below_its_bytes_bound"] else "")
    log(f"[kernels] {kernel} {row['shape']}: scaled_dot_product_attention "
        f"{what} {row['library_device_ms']} ms on the device (L2 cold "
        f"{row['library_device_ms_l2_cold']} ms), "
        f"{row['library_call_ms']:.5f} ms per call; its bytes bound "
        f"{row['library_bytes_bound_ms']:.5f} ms{flag}; kernels seen "
        f"{row['library_kernels']}, L2 cold {row['library_kernels_l2_cold']}")


def _ad_case(B, Sq, Sk, H, KV, hd, q_pos, g, dev, dv=None):
    """q (B,Sq,H,hd), k (B,Sk,KV,hd), v (B,Sk,KV,dv (default hd)) bf16 on
    the card and the (Sq,) int32 query positions."""
    import torch
    r = lambda *s: torch.randn(s, generator=g, device=dev)   # noqa: E731
    qp = torch.as_tensor(q_pos, dtype=torch.int32, device=dev)
    return [r(B, Sq, H, hd).bfloat16(), r(B, Sk, KV, hd).bfloat16(),
            r(B, Sk, KV, hd if dv is None else dv).bfloat16(), qp]


def _serve_positions(seq_len):
    """serving's bucket-padded extend positions at S = 512: a first
    prefill of 48 tokens (seq_len 48) or an append of 40 at [160, 200)
    (seq_len 200), then pads at 511 up to the 64-token bucket."""
    n = 48 if seq_len == 48 else 40
    return (list(range(seq_len - n, seq_len))
            + [AD_SERVE["pad"]] * (AD_SERVE["bucket"] - n))


def _ad_bound_ms(args, seq_len, window, n_sinks, want_density,
                 stats=False):
    """Least time for one call: q, the K (Dqk) and V (Dv) rows some query
    sees, out (Dv; and the density, or with ``stats`` the rows' m and l)
    once over the HBM rate, or 2 (Dqk + Dv) FLOPs per visible
    (query-head, key) pair (QK and PV) over the bf16 tensor-core rate,
    and with the density 2 Dqk more for the second QK (normalised p
    needs each row's final m and l), the larger (Dqk = Dv = hd: 4 hd,
    6 hd with the density)."""
    from repro_torch.kernels import ref
    q, k, v, qp = args
    B, Sq, H, dqk = q.shape
    Sk, KV, dv = k.shape[1], k.shape[2], v.shape[-1]
    vis = ref.extend_visibility(qp.long(), Sk, seq_len, window, n_sinks)
    n_pairs = int(vis.sum()) * H * B
    n_keys = int(vis.any(dim=0).sum())
    nbytes = B * (Sq * H * (dqk + dv) * 2 + n_keys * KV * (dqk + dv) * 2) \
        + 4 * Sq + (4 * B * Sk if want_density else 0) \
        + (8 * B * H * Sq if stats else 0)
    t_b = nbytes / HBM_BYTES_PER_S
    t_o = (2 * (dqk + dv) + (2 * dqk if want_density else 0)) * n_pairs \
        / BF16_OPS_PER_S
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def _mla_positions(S):
    """MLA's bucket-padded recompute positions over a slot cache of S
    positions: S = 512 (max_ctx_len 256) as ``_serve_positions(200)``,
    S = 256 an append of 40 at [108, 148) and 24 pads at 255.
    -> (positions, seq_len)."""
    if S == AD_SERVE["S"]:
        return _serve_positions(200), 200
    return list(range(108, 148)) + [S - 1] * 24, 148


def attn_phase():
    """attn_density against its plain version on the card, both forms,
    with and without the density; identical reruns; timings."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import attn_density as kad
    from repro_torch.kernels import ref
    from repro_torch.models.common import configure_numerics
    dev = torch.device("cuda")
    configure_numerics(dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    S, H, hd = AD_SERVE["S"], AD_SERVE["H"], AD_SERVE["hd"]
    cases = []        # (label, args, seq_len, (window, n_sinks) settings)
    for seq_len in (48, 200):
        for KV in (32, 8, 4):                         # G = 1, 4, 8
            cases.append((f"serve seq_len {seq_len} G {H // KV}",
                          _ad_case(1, 64, S, H, KV, hd,
                                   _serve_positions(seq_len), g, dev),
                          seq_len, ((0, 0), (512, 4), (16, 0))))
    for name, Hg, KVg, hdg in GQA_SHAPES:               # serving's extend
        cases.append((f"serve {name} ({Hg}/{KVg}, hd {hdg}) seq_len 200",
                      _ad_case(1, 64, S, Hg, KVg, hdg,
                               _serve_positions(200), g, dev),
                      200, ((0, 0), (512, 4), (16, 0))))
    # the slot engine's shapes: the pipelined restore's recompute set of
    # non-contiguous chunks (SLOT["recompute"], 48 rows padded with the
    # pad slot 511 to the 64-row bucket) in a 128-token context, and
    # lmk's whole-context recompute (200 tokens from position 0, padded
    # to the 256-row bucket), both over S = 512
    slot_pos = ([p for c in SLOT["recompute"] for p in range(16 * c,
                                                            16 * c + 16)]
                + [AD_SERVE["pad"]] * 16)
    slot_args = _ad_case(1, 64, S, H, 32, hd, slot_pos, g, dev)
    lmk_args = _ad_case(1, 256, S, H, 32, hd,
                        list(range(200)) + [AD_SERVE["pad"]] * 56, g, dev)
    cases.append(("slot recompute set", slot_args, SLOT["n_tokens"],
                  ((0, 0), (512, 4), (16, 0))))
    # MLA's recompute: Dqk 192 (nope 128 + rope 64) beside Dv 128, H = KV
    # = 16, over S = 512 and 256; and the reduced model's Dqk 24 / Dv 16
    mla_args = {}
    for S_m in AD_MLA["S"]:
        pos_m, seq_m = _mla_positions(S_m)
        mla_args[S_m] = _ad_case(1, 64, S_m, AD_MLA["H"], AD_MLA["H"],
                                 AD_MLA["dqk"], pos_m, g, dev,
                                 dv=AD_MLA["dv"])
        cases.append((f"MLA recompute over {S_m} (Dqk {AD_MLA['dqk']}, Dv "
                      f"{AD_MLA['dv']})", mla_args[S_m], seq_m,
                      ((0, 0), (512, 4), (16, 0))))
    # the other token buckets MLA's recompute fills over S = 512: one
    # restored chunk (16 rows), a first prompt of 32, a whole recompute
    # of 100 tokens (128 rows, 28 pads) and lmk's of 200 (256 rows, 56
    # pads); then 640 rows over 1024, where the plan takes 64-row tiles
    mh, mq, mv = AD_MLA["H"], AD_MLA["dqk"], AD_MLA["dv"]
    pad = AD_SERVE["pad"]
    for rows, pos_m, seq_m in (
            (16, list(range(32, 48)), 128), (32, list(range(32)), 32),
            (128, list(range(100)) + [pad] * 28, 100),
            (256, list(range(200)) + [pad] * 56, 200)):
        mla_args[rows] = _ad_case(1, rows, S, mh, mh, mq, pos_m, g, dev,
                                  dv=mv)
        cases.append((f"MLA recompute, {rows}-row bucket over {S}",
                      mla_args[rows], seq_m, ((0, 0), (512, 4), (16, 0))))
    if kad.plan(1, 640, mh, mh)[0] != 64:
        raise AssertionError("attn_density's plan keeps 16-row tiles at "
                             "640 MLA rows")
    cases.append((f"MLA 640 rows over 1024 (64-row tiles, Dqk {mq}, Dv {mv})",
                  _ad_case(1, 640, 1024, mh, mh, mq, list(range(360, 1000)),
                           g, dev, dv=mv), 1000,
                  ((0, 0), (512, 4), (16, 0))))
    cases.append(("reduced MLA (Dqk 24, Dv 16)",
                  _ad_case(1, 32, 64, 4, 4, 24, list(range(20, 48))
                           + [63] * 4, g, dev, dv=16), 48,
                  ((0, 0), (8, 0), (16, 2))))
    cases.append(("lmk whole recompute", lmk_args, 200,
                  ((0, 0), (512, 4), (16, 0))))
    long_args = _ad_case(1, 512, 4096, H, 32, hd, list(range(3584, 4096)),
                         g, dev)
    cases.append(("long append", long_args, 4096, ((0, 0), (512, 4))))
    pallas_args = _ad_case(1, 2048, 2048, H, 32, hd, list(range(2048)), g,
                           dev)
    cases.append(("Pallas setting", pallas_args, 2048, ((0, 0), (512, 4))))
    # edge cases of the tile plan: Sq G and Sk off the tiles, hd 16, 20 and
    # 80 (zero-padded in shared memory; 20 loads element by element), G 8
    # and 64, and 16-row tiles that hold rows seeing no key beside rows
    # seeing keys (the pads under window 8)
    for label, shape, q_pos, seq_len in (
            ("ragged rows and keys, hd 16", (2, 37, 100, 4, 4, 16),
             list(range(57, 90)) + [99] * 4, 90),
            ("G 8, hd 80", (1, 50, 200, 16, 2, 80),
             list(range(138, 180)) + [199] * 8, 180),
            ("G 64", (1, 24, 300, 64, 1, 64), list(range(226, 250)), 250),
            ("hd 20", (1, 10, 40, 2, 1, 20), list(range(25, 35)), 35),
            ("empty and seeing rows in a tile", (1, 20, 64, 4, 4, 32),
             list(range(30, 40)) + [63] * 10, 40)):
        cases.append((label, _ad_case(*shape, q_pos, g, dev), seq_len,
                      ((0, 0), (8, 0), (16, 2))))
    worst = {"out": 0.0, "out_rel": 0.0, "density": 0.0, "density_rel": 0.0}
    n_cases = n_empty = 0
    for label, args, seq_len, masks in cases:
        for window, n_sinks in masks:
            vis = ref.extend_visibility(args[3].long(), args[1].shape[1],
                                        seq_len, window, n_sinks)
            n_empty += int((~vis.any(dim=1)).sum())
            for form in ("served", "flash"):
                o_r, d_r = ref.attn_density_plain(*args, seq_len, window,
                                                  n_sinks, True, form)
                o_k, d_k = kad.attn_density(*args, seq_len, window, n_sinks,
                                            True, form)
                o_n, d_n = kad.attn_density(*args, seq_len, window, n_sinks,
                                            False, form)
                o_2, d_2 = kad.attn_density(*args, seq_len, window, n_sinks,
                                            True, form)
                torch.cuda.synchronize()
                span = float(o_r.float().abs().max())
                dspan = float(d_r.abs().max())
                d_o = float((o_k.float() - o_r.float()).abs().max())
                d_d = float((d_k - d_r).abs().max())
                case = (f"{label} window {window} sinks {n_sinks} {form}")
                if not (torch.isfinite(o_k.float()).all()
                        and torch.isfinite(d_k).all()
                        and d_o <= MQ_OUT_TOL * span
                        and d_d <= AD_DENS_TOL * dspan):
                    raise AssertionError(
                        f"attn_density {case}: max |d out| {d_o} (range "
                        f"{span}), max |d density| {d_d} (range {dspan})")
                if not (d_n is None and torch.equal(o_n, o_k)
                        and torch.equal(o_2, o_k) and torch.equal(d_2, d_k)):
                    raise AssertionError(f"attn_density {case}: reruns "
                                         "differ")
                worst["out"] = max(worst["out"], d_o)
                worst["out_rel"] = max(worst["out_rel"], d_o / span)
                worst["density"] = max(worst["density"], d_d)
                worst["density_rel"] = max(worst["density_rel"],
                                           d_d / dspan)
                n_cases += 1
    if n_empty == 0:
        raise AssertionError("no attn_density case had a row that sees no "
                             "key")
    log(f"[kernels] attn_density: {n_cases} cases (the GQA shapes "
        f"{[(H, KV, hd) for _, H, KV, hd in GQA_SHAPES]} at serving's "
        f"extend, the slot recompute set {SLOT['recompute']} and lmk's "
        f"whole recompute, MLA's 192/128 at every token bucket and at "
        f"64-row tiles among them) x (with, without density) "
        f"within tolerance of the plain version ({n_empty} rows that see no "
        f"key among them): max |d out| {worst['out']} ({worst['out_rel']} "
        f"of max|out|, tolerance {MQ_OUT_TOL}), max |d density| "
        f"{worst['density']} ({worst['density_rel']} of max density, "
        f"tolerance {AD_DENS_TOL}); reruns bit-identical")

    def timed(label, args, seq_len, form, want_density):
        q, k, v, qp = args
        fn = lambda: kad.attn_density(*args, seq_len, 0, 0,  # noqa: E731
                                      want_density, form)
        plain = lambda: ref.attn_density_plain(  # noqa: E731
            *args, seq_len, 0, 0, want_density, form)
        mask = ref.extend_visibility(qp.long(), k.shape[1], seq_len)
        q4, k4, v4 = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        lib = lambda: F.scaled_dot_product_attention(     # noqa: E731
            q4, k4, v4, attn_mask=mask)
        bound, by = _ad_bound_ms(args, seq_len, 0, 0, want_density)
        iters = 200 if q.shape[1] <= 64 else 20
        parts = {}
        row = {"shape": label, "form": form, "density": want_density,
               "route": kad.route(form, q.shape[-1], v.shape[-1]),
               "call_ms": _time_ms(fn, iters=iters),
               "device_ms": _device_ms(fn, AD_KERNELS, iters=min(iters, 50),
                                       by_kernel=parts),
               "device_ms_by_kernel": parts,
               "plain_call_ms": _time_ms(plain, iters=min(iters, 50)),
               "plain_device_ms": _device_ms(plain, iters=min(iters, 50)),
               "library_call_ms": _time_ms(lib, iters=iters),
               "library_device_ms": _device_ms(lib, iters=min(iters, 50)),
               "bound_ms": bound, "bound_by": by}
        log(f"[kernels] attn_density {label} {form}"
            f"{' + density' if want_density else ''}: kernel "
            f"{row['device_ms']} ms on the device, {row['call_ms']:.5f} ms "
            f"per call; plain {row['plain_device_ms']} ms on the device, "
            f"{row['plain_call_ms']:.5f} ms per call; "
            f"scaled_dot_product_attention with the boolean mask (out "
            f"only) {row['library_device_ms']} ms on the device, "
            f"{row['library_call_ms']:.5f} ms per call; bound "
            f"{bound:.5f} ms ({by}); kernel by launch {parts}")
        return row

    serve = _ad_case(1, 64, S, H, 32, hd, _serve_positions(200), g, dev)
    times = {
        "out": timed("(1,64,32,32,128) over 512, seq_len 200", serve, 200,
                     "served", False),
        "density": timed("(1,64,32,32,128) over 512, seq_len 200", serve,
                         200, "served", True),
        "long": timed("(1,512,32,32,128) at [3584,4096) over 4096",
                      long_args, 4096, "served", True),
        "pallas": timed("(1,2048,32,32,128) causal", pallas_args, 2048,
                        "flash", True),
        "slot": timed(f"(1,64,32,32,128) at chunks {SLOT['recompute']} + "
                      f"16 pads over 512, seq_len {SLOT['n_tokens']}",
                      slot_args, SLOT["n_tokens"], "served", False),
        "lmk": timed("(1,256,32,32,128) at [0,200) + 56 pads over 512, "
                     "seq_len 200", lmk_args, 200, "served", True),
    }
    for S_m in AD_MLA["S"]:
        pos_m, seq_m = _mla_positions(S_m)
        for want in (False, True):
            times[f"mla_{S_m}{'_density' if want else ''}"] = timed(
                f"(1,64,16,16,{AD_MLA['dqk']}/{AD_MLA['dv']}) over {S_m}, "
                f"seq_len {seq_m}", mla_args[S_m], seq_m, "served", want)
    times["mla_lmk_density"] = timed(
        f"(1,256,16,16,{mq}/{mv}) at [0,200) + 56 pads over {S}, seq_len "
        f"200", mla_args[256], 200, "served", True)
    times["new_families"] = _new_family_kernel_rows()
    for row in times["new_families"].values():
        worst["out"] = max(worst["out"], row["max_abs_err"])
        worst["out_rel"] = max(worst["out_rel"], row["max_err_rel"])
        worst["density_rel"] = max(worst["density_rel"],
                                   row["max_err_density_rel"])
    return worst, times


def _dq_bound_ms(args, want_mass):
    """Least time for one call: each valid key's int8 K/V row and its two
    scales (2 hd + 8 bytes per kv-head), q, n_valid, out and the mass once
    over the HBM rate, or 4 H hd FLOPs per valid key over the bf16
    tensor-core rate, the larger."""
    q, k_q, _, _, _, nv = args
    B, H, hd = q.shape
    S, KV = k_q.shape[1], k_q.shape[2]
    n = int(nv.long().clamp(max=S).sum())
    nbytes = (n * KV * (2 * hd + 8) + 2 * B * H * hd * 2 + 4 * B
              + (4 * B * S if want_mass else 0))
    t_b, t_o = nbytes / HBM_BYTES_PER_S, 4 * H * hd * n / BF16_OPS_PER_S
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


GATE = dict(layers=32, deadline_ms=20, publish_after_ms=50, iters=200)


def gate_phase():
    """The pipelined restore's gate (``csrc/feed_gate.cu``) against its
    plain version (``kernels/ref.py::feed_gate_plain``) on the same
    page-locked words (GATE["layers"] of them, llama2-7b's depth), each
    published through the library's release store: a word at the gate's
    generation (status 0), at its negative (1), at an older generation
    past a GATE["deadline_ms"] deadline (2, the wait at least the
    deadline), generation 0 on a zero word (a capture's warm-up: 0), a
    status already set (the gate passes without waiting), and a word
    published by another thread GATE["publish_after_ms"] after the gate
    began to wait while this thread waits for the card (0, the wait
    about that long: the card read the host's store, and the wait for
    the card released the GIL).  Both must give the same status in
    every case.  Times a gate on a published word by CUDA events over
    GATE["iters"] launches beside the plain version's call.  -> the
    cases and times."""
    import threading
    import numpy as np
    import torch
    from repro_torch.kernels import feed_gate as kfg
    from repro_torch.kernels.ref import feed_gate_plain
    L, gen = GATE["layers"], 7
    flags = torch.zeros((L,), dtype=torch.int32, pin_memory=True)
    publish = kfg.publisher(flags)

    def gate(on_card, layer, g, deadline_ms, status0=0, later=None):
        dev = "cuda" if on_card else "cpu"
        status = torch.full((1,), status0, dtype=torch.int32, device=dev)
        wait = torch.zeros((L,), dtype=torch.int64, device=dev)
        args = (torch.tensor(g, dtype=torch.int32, device=dev),
                torch.tensor(int(deadline_ms * 1e6), dtype=torch.int64,
                             device=dev), status, wait)
        torch.cuda.synchronize()
        if later is not None:
            t = threading.Timer(GATE["publish_after_ms"] / 1e3,
                                publish, later)
        t0 = time.perf_counter()
        if later is not None:
            t.start()
        (kfg.feed_gate if on_card else feed_gate_plain)(flags, layer,
                                                         *args)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        if later is not None:
            t.join()
        return {"status": int(status[0]), "wait_ms": int(wait[layer]) / 1e6,
                "wall_ms": wall}

    cases = {}
    for name, layer, word, g, deadline, status0 in (
            ("published", 3, gen, gen, 5000, 0),
            ("failed", 4, -gen, gen, 5000, 0),
            ("missing (an older generation)", 5, gen - 1, gen,
             GATE["deadline_ms"], 0),
            ("warm-up (generation 0)", 6, 0, 0, 0, 0),
            ("status already set", 7, gen - 1, gen, 5000, 1)):
        publish(layer, word)
        cases[name] = {"kernel": gate(True, layer, g, deadline, status0),
                       "plain": gate(False, layer, g, deadline, status0)}
    for on_card in (True, False):
        publish(8, gen - 1)
        cases.setdefault("published while it waits", {})[
            "kernel" if on_card else "plain"] = gate(
                on_card, 8, gen, 5000, later=(8, gen))
    want = {"published": 0, "failed": 1,
            "missing (an older generation)": 2,
            "warm-up (generation 0)": 0, "status already set": 1,
            "published while it waits": 0}
    for name, got in cases.items():
        if not got["kernel"]["status"] == got["plain"]["status"] == \
                want[name]:
            raise AssertionError(f"[gate] {name}: status {got}, not "
                                 f"{want[name]}")
    late = cases["published while it waits"]["kernel"]["wait_ms"]
    if not 0.5 * GATE["publish_after_ms"] <= late < 20 * \
            GATE["publish_after_ms"]:
        raise AssertionError(f"[gate] the word published while the kernel "
                             f"waited: waited {late} ms")
    if cases["missing (an older generation)"]["kernel"]["wait_ms"] < \
            GATE["deadline_ms"]:
        raise AssertionError("[gate] the missing word timed out early")
    # a gate on a published word, launch after launch (CUDA events)
    dev = torch.device("cuda")
    status = torch.zeros((1,), dtype=torch.int32, device=dev)
    wait = torch.zeros((L,), dtype=torch.int64, device=dev)
    g = torch.tensor(gen, dtype=torch.int32, device=dev)
    d = torch.tensor(5 * 10**9, dtype=torch.int64, device=dev)
    kfg.feed_gate(flags, 3, g, d, status, wait)
    ms = _event_ms(lambda: kfg.feed_gate(flags, 3, g, d, status, wait),
                   GATE["iters"])
    sc, wc = status.cpu(), wait.cpu()
    t0 = time.perf_counter()
    for _ in range(GATE["iters"]):
        feed_gate_plain(flags, 3, gen, 5 * 10**9, sc, wc)
    plain_ms = (time.perf_counter() - t0) * 1e3 / GATE["iters"]
    out = {"cases": cases, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": 12 / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
           "launches_made_here": kfg.feed_gate.launches}
    log(f"[gate] csrc/feed_gate.cu against feed_gate_plain on the same "
        f"page-locked words, statuses equal in every case: "
        f"{json.dumps(cases)}; a gate on a published word {ms * 1e3:.2f} "
        f"us a launch (CUDA events over {GATE['iters']}), the plain "
        f"version {plain_ms * 1e3:.2f} us a call; bound (4 B read, 8 B "
        f"written) {out['bound_ms'] * 1e3:.6f} us")
    return out


def qattn_phase():
    """decode_qattn against its plain version on the card, both forms,
    with and without the mass; identical reruns; timings."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_qattn as kdq
    from repro_torch.kernels import ref
    from repro_torch.models.common import configure_numerics
    dev = torch.device("cuda")
    configure_numerics(dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 3)

    def case(B, S, H, KV, hd, full=False, n_valid=None):
        a = _mq_case(B, S, H, KV, hd, 1.0, g, dev, full=full,
                     n_valid=n_valid)
        return [a[0], a[3], a[4], a[5], a[6], a[8]]

    worst = {"out": 0.0, "out_rel": 0.0, "mass": 0.0}
    n_cases = 0
    cases = [(case(*shape), ((0, 0), (256, 4)))
             for shape in ((1, 512, 32, 32, 128), (4, 4096, 32, 32, 128))]
    # the split plan's edge cases, every position quant
    cases += [(case(*shape, n_valid=nv), masks)
              for shape, nv, masks in MQ_EDGE]
    cases += [(case(4, 512, H, KV, hd), ((0, 0), (256, 4)))
              for _, H, KV, hd in GQA_SHAPES]
    for args, masks in cases:
        B, H, hd = args[0].shape
        S, KV = args[1].shape[1], args[1].shape[2]
        for window, n_sinks in masks:
            for select in (False, True):
                o_r, m_r = ref.decode_qattn_plain(*args, window, n_sinks,
                                                  True, select)
                o_k, m_k = kdq.decode_qattn(*args, window, n_sinks, True,
                                            select)
                o_n = kdq.decode_qattn(*args, window, n_sinks, False,
                                       select)
                o_2, m_2 = kdq.decode_qattn(*args, window, n_sinks, True,
                                            select)
                torch.cuda.synchronize()
                span = float(o_r.float().abs().max())
                d_o = float((o_k.float() - o_r.float()).abs().max())
                d_m = float((m_k - m_r).abs().max())
                label = (f"({B},{S},{H},{KV},{hd}) window {window} sinks "
                         f"{n_sinks} {'select' if select else 'fused'}")
                if not (torch.isfinite(o_k.float()).all()
                        and d_o <= MQ_OUT_TOL * span and d_m <= MQ_MASS_TOL):
                    raise AssertionError(
                        f"decode_qattn {label}: max |d out| {d_o} (range "
                        f"{span}), max |d mass| {d_m}")
                if not (torch.equal(o_n, o_k) and torch.equal(o_2, o_k)
                        and torch.equal(m_2, m_k)):
                    raise AssertionError(f"decode_qattn {label}: reruns "
                                         "differ")
                valid = ref._valid_keys(args[5], B, S, window, n_sinks, dev)
                if bool((m_k[~valid] != 0).any()):
                    raise AssertionError(
                        f"decode_qattn {label}: mass not 0 at an invalid key")
                worst["out"] = max(worst["out"], d_o)
                worst["out_rel"] = max(worst["out_rel"], d_o / span)
                worst["mass"] = max(worst["mass"], d_m)
                n_cases += 1
    log(f"[kernels] decode_qattn: {n_cases} cases ({len(MQ_EDGE)} edge "
        f"shapes of the split plan and the GQA shapes at (4, 512) among "
        f"them) x (with, without mass) "
        f"within tolerance of the plain version: max |d out| "
        f"{worst['out']} ({worst['out_rel']} of max|out|, tolerance "
        f"{MQ_OUT_TOL}), max |d mass| {worst['mass']} (tolerance "
        f"{MQ_MASS_TOL}); mass 0 at every invalid key; reruns "
        f"bit-identical")

    times = []
    for shape, select in (((1, 512, 32, 32, 128), True),
                          ((4, 4096, 32, 32, 128), False)):
        args = case(*shape, full=True)
        q, k_q, v_q, k_s, v_s, nv = args
        fn = lambda: kdq.decode_qattn(*args, want_mass=True,  # noqa: E731
                                      select=select)
        plain = lambda: ref.decode_qattn_plain(  # noqa: E731
            *args, want_mass=True, select=select)
        kb = ref.dequantize_token_head_ref(k_q, k_s)
        vb = ref.dequantize_token_head_ref(v_q, v_s)
        q4 = q[:, :, None]
        k4, v4 = (t.transpose(1, 2).contiguous() for t in (kb, vb))
        lib = lambda: F.scaled_dot_product_attention(     # noqa: E731
            q4, k4, v4)
        bound, by = _dq_bound_ms(args, True)
        parts = {}
        row = {"shape": str(shape).replace(" ", ""),
               "form": "select" if select else "fused",
               "call_ms": _time_ms(fn),
               "device_ms": _device_ms(fn, DQ_KERNELS, by_kernel=parts),
               "device_ms_by_kernel": parts,
               "plain_call_ms": _time_ms(plain, iters=50),
               "plain_device_ms": _device_ms(plain),
               "bound_ms": bound, "bound_by": by,
               **_cold_and_library(fn, DQ_KERNELS, lib, q4, k4, v4)}
        times.append(row)
        log(f"[kernels] decode_qattn {row['shape']} {row['form']} + mass, "
            f"n_valid = S: kernel {row['device_ms']} ms on the device (L2 "
            f"cold {row['device_ms_l2_cold']} ms), {row['call_ms']:.5f} ms "
            f"per call; plain {row['plain_device_ms']} ms on the device, "
            f"{row['plain_call_ms']:.5f} ms per call; bound {bound:.5f} ms "
            f"({by}); kernel by launch {parts}, L2 cold "
            f"{row['device_ms_by_kernel_l2_cold']}")
        _log_library("decode_qattn", row, "over the dequantized bf16 K/V "
                     "(out only)")
    return worst, times


# --------------------------------------------------------------------- #
# 3. serve llama2-7b at full width
# --------------------------------------------------------------------- #
def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def _trace(vocab, seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(3):                          # rounds
        for c in range(4):                      # contexts
            n = int(rng.integers(32, 65))
            out.append((c, rng.integers(1, vocab, n).tolist(), 8))
    return out


def build_weights(cfg, seed, device="cuda"):
    """The model and its random bf16 weights from ``seed``, built once
    and shared by every serve run."""
    import torch
    from repro_torch.models.registry import build_model
    t0 = time.perf_counter()
    model = build_model(cfg, device=device)
    params = model.init(torch.Generator(device=device).manual_seed(seed))
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    gib = sum(w.numel() * w.element_size() for w in _leaves(params)) / 2**30
    log(f"[serve] {cfg.name}: L={cfg.n_layers} d={cfg.d_model} "
        f"H={cfg.n_heads} hd={cfg.head_dim} vocab={cfg.vocab}, random bf16 "
        f"weights ({gib:.2f} GiB) in {time.perf_counter() - t0:.1f} s")
    return model, params


def _peak_memory():
    """The card's peak memory since the last reset: allocated, and
    reserved (a captured graph's temporaries are reserved in its pool,
    not allocated, between replays)."""
    import torch
    return {"allocated": torch.cuda.max_memory_allocated(),
            "reserved": torch.cuda.max_memory_reserved()}


def _same_bytes(a, b) -> bool:
    """Two tensors of one dtype and shape hold the same bytes."""
    import torch
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.reshape(-1).contiguous().view(torch.uint8),
                            b.reshape(-1).contiguous().view(torch.uint8)))


def graph_check(exe, arenas, label):
    """The graph gates of an executor after a run (serve and router
    phases over the paged pool's ``arenas``; slot, MLA, MoE, RWKV and
    zoo phases over the static slot caches, ``arenas`` None): on the
    card every ``paged_extend`` / ``paged_decode`` call and every slot
    ``extend`` / ``extend_nod`` / ``decode`` (``lmk``'s whole recompute
    included) was one replay of its CUDA graph (``core/graphs.py``:
    replays = calls), no slot entry ran eagerly on a private cache
    (``eager_calls`` 0), and every graph the executor holds, replayed
    on its entry's last staged inputs, gives the bytes of its eager
    body run on the same inputs: logits, density, mass or hidden rows,
    and every byte of the arenas and of every slot cache but a slot's
    pad position (all put back in between and after; a mismatch says
    where, and whether the eager body repeats itself there).  A slot
    graph that served no call is held on a call of its own
    (``_unserved_inputs``) rather than on the capture's all-zero inputs:
    those put every row at position 0 with ``seq_len`` 0, where a routed
    FFN (MLA, MoE) drops some of the identical rows at an expert's
    capacity, their writes race at position 0, and rows that see no key
    attend that position (measured: replay and eager differ there, on
    the card, in no call the service makes).  The launch counts are put back too: nothing
    here counts toward the run.  Logs the graphs captured per entry,
    bucket and slot, the capture seconds (and those at a key's first
    call) and the graph pool's bytes.  On the CPU (a rehearsal) the body
    runs twice.  -> the cache's stats, with the keys held ("held")."""
    import torch
    from repro_torch.kernels import launch_counts, set_launch_counts
    cache, on_card = exe.graphs, exe.device.type == "cuda"
    stats = dict(cache.stats(), eager_calls=exe.eager_calls)
    log(f"[{label}] graphs: {stats['calls']} calls, {stats['replays']} "
        f"replays, {stats['eager_calls']} eager slot calls; captured by "
        f"entry/bucket/quant[/slot] {stats['captures']} in "
        f"{stats['capture_s']:.3f} s ({stats['late_captures']} at a "
        f"key's first call, {stats['late_capture_s']:.3f} s); graph pool "
        f"{stats['pool_bytes']} B ({stats['pool_bytes'] / 2**20:.1f} MiB)"
        f"; entries held {stats['entries']} ({stats['pinned']} pinned), "
        f"drops {stats['drops']}")
    if on_card and not (stats["calls"] and
                        stats["replays"] == stats["calls"]):
        raise AssertionError(f"[{label}] {stats['replays']} graph replays "
                             f"for {stats['calls']} calls")
    if on_card and stats["eager_calls"]:
        raise AssertionError(f"[{label}] {stats['eager_calls']} slot-engine "
                             "calls ran eagerly")
    bufs = dict(arenas or {})
    seq = set()                  # slot-cache leaves with a sequence axis
    for slot, c in exe.slot_caches.items():
        for n, t in c.items():
            bufs[f"slot{slot}/{n}"] = t
            if t.dim() >= 3 and t.shape[2] == exe.s_work:
                seq.add(f"slot{slot}/{n}")
    arenas = bufs
    pad = exe.pad_slot

    def same(n, a, b):
        # a slot cache's pad position is scratch: a bucket's pad rows all
        # write there, and where a routed FFN (MLA, MoE) dropped some of
        # them at an expert's capacity their rows differ, so which one
        # lands is a race on the card, eager or replayed alike
        if n not in seq:
            return _same_bytes(a, b)
        return (_same_bytes(a[:, :, :pad], b[:, :, :pad])
                and _same_bytes(a[:, :, pad + 1:], b[:, :, pad + 1:]))

    def where(a, b):
        d = (a.float() - b.float()).abs()
        if d.dim() < 3:
            return f"max |d| {float(d.max())}"
        cols = (d.reshape(*d.shape[:3], -1).amax(-1) > 0).any(0).any(0)
        return f"positions {cols.nonzero().flatten().tolist()[:12]}"

    counts = launch_counts()
    saved = {n: t.clone() for n, t in arenas.items()}
    held = []
    try:
        for key in cache.keys():
            entry = cache.entry(key)
            pipelined = key[0] == "pipelined"
            if not entry.calls and len(key) > 3:
                entry.stage(_unserved_inputs(
                    key, pipelined and entry.inputs["io_pos"].shape[0]))
            if pipelined:
                # every layer published at a new generation: the gates
                # pass, and both runs read the rows the sink holds
                sink = exe.feed_sink()
                for layer in range(exe.n_layers):
                    sink.publish(layer, sink.gen)
                entry.inputs["gen"].fill_(sink.gen)
            got = [o.clone() for o in (entry.replay() if on_card
                                       else entry.eager())]
            after = {n: t.clone() for n, t in arenas.items()}
            for n, t in arenas.items():
                t.copy_(saved[n])
            want = entry.eager()
            # a pipelined restore's third output is its gates' waits
            n_out = 2 if pipelined else len(want)
            bad = [f"output {i} ({where(a, b)})"
                   for i, (a, b) in enumerate(zip(got[:n_out],
                                                  want[:n_out]))
                   if not _same_bytes(a, b)]
            if pipelined and int(got[1][0]):
                bad.append(f"gate status {int(got[1][0])}")
            bad += [f"{n} ({where(after[n], arenas[n])})" for n in arenas
                    if not same(n, after[n], arenas[n])]
            if bad:             # is the eager body itself repeatable here?
                for n, t in arenas.items():
                    t.copy_(saved[n])
                again = entry.eager()
                bad.append("eager twice identical: " + str(all(
                    _same_bytes(a, b) for a, b in zip(want, again)))
                    + f"; calls {entry.calls}")
            for n, t in arenas.items():
                t.copy_(saved[n])
            del after
            if bad:
                raise AssertionError(f"[{label}] graph {key}: the replay and "
                                     f"the eager body differ in {bad}")
            held.append("/".join(map(str, key)))
    finally:
        set_launch_counts(counts)
        del saved
        if on_card:
            torch.cuda.empty_cache()
    log(f"[{label}] graphs replayed against their eager bodies on the same "
        f"inputs, logits, density, mass or hidden rows, every arena byte "
        f"and every slot-cache byte but the pad position's: identical for "
        f"{held}")
    return dict(stats, held=held)


def _unserved_inputs(key, io_rows=0):
    """Host inputs of a call of the slot entry ``key`` = (name, n, quant,
    slot): for an extend or extend_nod n tokens 1 .. n at positions 0 ..
    n - 1 (``seq_len`` n, no pad row); for a decode token 1 at the slot's
    position; for a pipelined restore at n = (m, I/O bucket) m tokens at
    0 .. m - 1 and its ``io_rows`` fed rows after them (``seq_len`` m +
    io_rows), the generation 0 (the caller sets it) and a 10 s gate
    deadline."""
    import numpy as np
    name, n = key[:2]
    if name == "decode":
        return {"toks": np.ones((1, 1), np.int64)}
    if name == "pipelined":
        m = n[0]
        return {"toks": np.arange(1, m + 1)[None], "miss": np.arange(m),
                "io_pos": np.arange(m, m + io_rows),
                "seq_len": np.int32(m + io_rows), "gen": np.int32(0),
                "deadline_ns": np.int64(10 * 10**9)}
    host = {"toks": np.arange(1, n + 1)[None], "pos": np.arange(n),
            "seq_len": np.int32(n)}
    if name == "extend":
        host["last"] = np.int64([n - 1])
    return host


def serve_phase(model, params, seed, swap_root, label,
                quant_resident=False):
    """Drive LLMService over ``model`` on its device (the CPU only to
    rehearse this script at a reduced size), with the bf16 pool or with
    ``quant_resident``."""
    import numpy as np
    import torch
    from repro_torch.core import restore
    from repro_torch.core.service import LLMService, LLMSConfig
    from repro_torch.kernels import attn_density as kad
    from repro_torch.kernels import chunk_quant
    from repro_torch.kernels import decode_mqattn as kmq

    cfg, device = model.cfg, model.device
    on_card = device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    cs = 16
    raw_chunk = _raw_chunk_bytes(model, cs)
    budget = 2 * 4 * raw_chunk        # two contexts' raw KV after 1 call
    sc = LLMSConfig(policy="llms", paged_pool=True, decode_batch=1,
                    max_ctx_len=256, chunk_tokens=cs, memory_budget=budget,
                    quant_resident=quant_resident,
                    swap_dir=tempfile.mkdtemp(dir=swap_root))
    svc = LLMService(model, params, sc, device=device)
    n_logits = {"checked": 0, "quant_rounds": 0, "rounds": 0,
                "profile_extend": False}
    round_profile = {}
    exe = svc.exe
    extend, decode = exe.paged_extend, exe.paged_decode

    def checked(fn):
        def run(*a, **k):
            out = fn(*a, **k)
            logits = out[1]
            if not np.isfinite(logits).all():
                raise AssertionError(f"non-finite logits from {fn.__name__}")
            n_logits["checked"] += 1
            return out
        return run

    def decode_tally(*a, **k):
        # (arenas, toks, pos, pt16, pt8, qmask): a round whose page rows
        # hold a quant chunk, tallied on the host from pool.rows
        qmask = a[5] if len(a) > 5 else k.get("qmask")
        if qmask is not None and np.asarray(qmask).any():
            n_logits["quant_rounds"] += 1
        n_logits["rounds"] += 1
        if on_card and n_logits["rounds"] == PROFILED_ROUND:
            out, round_profile["round"] = _profile_round(
                lambda: decode(*a, **k))
            return out
        return decode(*a, **k)

    def extend_profiled(*a, **k):
        # the last call's prefill-append, once, under the profiler
        if on_card and n_logits["profile_extend"]:
            n_logits["profile_extend"] = False
            out, round_profile["extend"] = _profile_round(
                lambda: extend(*a, **k))
            return out
        return extend(*a, **k)

    exe.paged_extend = checked(extend_profiled)
    exe.paged_decode = checked(decode_tally)

    # codec launches per switch-in and per switch-out of each call
    phase = {"in": [0, 0], "out": [0, 0]}

    def tally(fn, key):
        def run(*a, **k):
            q0 = chunk_quant.quantize.launches
            d0 = chunk_quant.dequantize.launches
            try:
                return fn(*a, **k)
            finally:
                phase[key][0] += chunk_quant.quantize.launches - q0
                phase[key][1] += chunk_quant.dequantize.launches - d0
        return run

    res, pool = svc.res, svc.res.pool
    res.switch_in = tally(res.switch_in, "in")
    res.compress_and_swap_out = tally(res.compress_and_swap_out, "out")
    # chunks quantized by the storage codec (one quantize launch each)
    codec = svc.exe.codec
    compress_blocks = codec.compress_blocks
    compressed = {"chunks": 0, "switch_outs": 0, "host_ms": []}

    def counted_compress(*a, **k):
        compressed["chunks"] += 1
        t0 = time.perf_counter()
        try:
            return compress_blocks(*a, **k)
        finally:
            compressed["host_ms"].append((time.perf_counter() - t0) * 1e3)

    codec.compress_blocks = counted_compress
    alloc8 = pool.alloc8
    quant_pages = {"admitted": 0}

    def counted_alloc8(*a, **k):
        page = alloc8(*a, **k)
        quant_pages["admitted"] += 1
        return page

    pool.alloc8 = counted_alloc8
    restore.reset_io_counters()
    trace = _trace(cfg.vocab, seed)
    records = []
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    with svc:
        stubs = [svc.newLLMCtx() for _ in range(4)]
        _zero_launches()
        t_run = time.perf_counter()
        for i, (c, prompt, max_new) in enumerate(trace):
            read0 = restore.io_counters()["read"]
            mq0 = kmq.decode_mqattn.launches
            ad0 = kad.attn_density.launches
            n_logits["profile_extend"] = i == len(trace) - 1
            phase["in"][:] = phase["out"][:] = [0, 0]
            t1 = time.perf_counter()
            _, toks = svc.callLLM(stubs[c], prompt, max_new)
            sync()
            wall = time.perf_counter() - t1
            compressed["switch_outs"] += phase["out"][0] > 0
            rec = svc.records[-1]
            ctx = svc.contexts[stubs[c].ctx_id]
            bits = [m.bits for _, m in sorted(ctx.chunks.items())]
            restored = restore.io_counters()["read"] - read0
            pages8 = pool.stats()["pool_pages8_used"]
            mq = kmq.decode_mqattn.launches - mq0
            ad = kad.attn_density.launches - ad0
            records.append({"ctx": c, "tokens": list(map(int, toks)),
                            "bits": bits, "restored_bytes": restored,
                            "switch_s": rec["switch_s"],
                            "launches_in": list(phase["in"]),
                            "launches_out": list(phase["out"]),
                            "quant_pages": pages8, "mqattn_launches": mq,
                            "attn_density_launches": ad})
            log(f"[serve:{label}] call {i:2d} ctx {c} prompt {len(prompt)} "
                f"-> {len(toks)} tokens | switch {rec['switch_s'] * 1e3:.3f}"
                f" ms | restored {restored} B | wall {wall * 1e3:.1f} ms | "
                f"quantize/dequantize launches: switch-in {phase['in']}, "
                f"switch-out {phase['out']} | QUANT pages {pages8} | "
                f"decode_mqattn launches {mq} | attn_density launches {ad} "
                f"| bits {bits}")
        run_s = time.perf_counter() - t_run
        launches = _read_launches()
        peak = _peak_memory() if on_card else None
        graphs = graph_check(exe, pool.arenas, f"serve:{label}")
        stats = svc.stats()
        widths = {}
        for ctx in svc.contexts.values():
            for m in ctx.chunks.values():
                widths[m.bits] = widths.get(m.bits, 0) + 1
    log(f"[serve:{label}] {len(trace)} calls in {run_s:.2f} s; kernel "
        f"launches {launches}; logits checked finite {n_logits['checked']}"
        f" times; decode rounds with a quant chunk "
        f"{n_logits['quant_rounds']}; QUANT pages admitted "
        f"{quant_pages['admitted']}; chunk bit widths stored "
        f"{dict(sorted(widths.items()))}")
    launches["quantize_per_chunk"] = (
        launches["quantize"] / max(compressed["chunks"], 1))
    launches["quantize_per_switch_out"] = (
        sum(r["launches_out"][0] for r in records)
        / max(compressed["switch_outs"], 1))
    host = sorted(compressed["host_ms"]) or [0.0]
    log(f"[serve:{label}] storage codec: {compressed['chunks']} chunks "
        f"quantized in {launches['quantize']} launches "
        f"({launches['quantize_per_chunk']} a chunk); "
        f"{compressed['switch_outs']} calls' switch-outs quantized, "
        f"{launches['quantize_per_switch_out']} launches each; "
        f"compress_blocks host time per chunk median "
        f"{host[len(host) // 2]:.4f} ms (min {host[0]:.4f}, max "
        f"{host[-1]:.4f})")
    log(f"[serve:{label}] stats {json.dumps(stats, default=str)}")
    log(f"[serve:{label}] peak memory {peak} B (reserved includes the "
        f"graph pool)")
    if "round" in round_profile:
        log(f"[serve:{label}] decode round {PROFILED_ROUND} under the "
            f"profiler: {json.dumps(round_profile['round'])}")
    if "extend" in round_profile:
        log(f"[serve:{label}] the last call's prefill-append under the "
            f"profiler: {json.dumps(round_profile['extend'])}")

    if on_card and not (launches["quantize"] > 0
                        and launches["dequantize"] > 0):
        raise AssertionError(f"a codec kernel never ran: {launches}")
    # every prefill-append attends through attn_density, once per layer
    if on_card and any(r["attn_density_launches"] < cfg.n_layers
                       or r["attn_density_launches"] % cfg.n_layers
                       for r in records):
        raise AssertionError("a call's extend did not run attn_density once "
                             "per layer")
    if not any(b < 16 for b in widths):
        raise AssertionError("no chunk was stored below 16 bits")
    if not any(r["restored_bytes"] > 0 for r in records):
        raise AssertionError("no switch-in restored a chunk from disk")
    if stats["total_calls"] != len(trace):
        raise AssertionError("a call did not complete")
    if quant_resident:
        if on_card and launches["decode_mqattn"] == 0:
            raise AssertionError("decode_mqattn never ran")
        if n_logits["quant_rounds"] == 0:
            raise AssertionError("no decode round attended a quant chunk")
        if quant_pages["admitted"] == 0:
            raise AssertionError("no QUANT page was admitted")
    del svc, exe, extend, decode, res, pool, alloc8, codec, compress_blocks
    gc.collect()                # the logit check closes over the executor
    if on_card:
        torch.cuda.empty_cache()
    return {"records": records, "launches": launches, "stats": stats,
            "run_s": run_s, "widths": widths,
            "quant_rounds": n_logits["quant_rounds"],
            "round_profile": round_profile.get("round"),
            "extend_profile": round_profile.get("extend"),
            "quant_pages_admitted": quant_pages["admitted"],
            "graphs": graphs, "peak_bytes": peak}


def int8_decode_phase(model, params, seed, label, profiled=False):
    """The all-int8 decode cache at full width: a prompt fed through
    ``decode_step`` one token at a time (the only way the reference fills
    this cache), then greedy tokens with the per-key mass; with
    ``profiled``, the middle token runs under the profiler.  The
    decode_qattn launch count is zeroed just before and read just
    after."""
    import numpy as np
    import torch
    from repro_torch.kernels import decode_qattn as kdq
    cfg, dev = model.cfg, model.device
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    S, n_prompt, n_new = (INT8_DECODE[k] for k in ("S", "prompt", "new"))
    prompt = np.random.default_rng(seed).integers(1, cfg.vocab, n_prompt)
    cache = model.init_cache(1, S, dtype=torch.int8)
    kdq.reset_launches()
    t0 = time.perf_counter()
    for tok in prompt:
        out = model.decode_step(params, torch.tensor([[int(tok)]],
                                                     device=dev), cache)
        cache = out.cache
    sync()
    prompt_s = time.perf_counter() - t0
    logits, toks, masses, per_token_ms = out.logits, [], [], []
    profile = None
    for i in range(n_new):
        nxt = int(torch.argmax(logits[0]))
        step = lambda: model.decode_step(  # noqa: E731
            params, torch.tensor([[nxt]], device=dev), cache,
            want_density=True)
        if on_card and profiled and i == n_new // 2:
            # one token under the profiler, left out of the per-token times
            (out, mass), profile = _profile_round(step)
        else:
            t1 = time.perf_counter()
            out, mass = step()
            sync()
            per_token_ms.append((time.perf_counter() - t1) * 1e3)
        if not torch.isfinite(out.logits).all():
            raise AssertionError("non-finite logits over the int8 cache")
        cache, logits = out.cache, out.logits
        toks.append(nxt)
        masses.append(mass.float().cpu())
    launches = kdq.decode_qattn.launches
    mass = torch.stack(masses)
    if int(cache["pos"]) != n_prompt + n_new:
        raise AssertionError(f"int8 cache at {int(cache['pos'])}")
    if on_card and launches != (n_prompt + n_new) * cfg.n_layers:
        raise AssertionError(f"{launches} decode_qattn launches, not "
                             f"{(n_prompt + n_new) * cfg.n_layers}")
    sums = mass.sum(dim=-1)
    if not torch.allclose(sums, torch.ones_like(sums), atol=1e-3):
        raise AssertionError(f"int8 decode masses do not sum to 1: {sums}")
    ms = sorted(per_token_ms)
    log(f"[int8:{label}] all-int8 cache (1, {S}): {n_prompt}-token prompt "
        f"fed one token at a time in {prompt_s:.2f} s, then {n_new} greedy "
        f"tokens with the mass: per token median {ms[len(ms) // 2]:.2f} ms "
        f"(min {ms[0]:.2f}, max {ms[-1]:.2f}); decode_qattn launches "
        f"{launches} ({cfg.n_layers} a token); tokens {toks}")
    if profile is not None:
        log(f"[int8:{label}] token {n_new // 2} under the profiler: "
            f"{json.dumps(profile)}")
    return {"tokens": toks, "mass": mass, "launches": launches,
            "per_token_ms": per_token_ms, "prompt_s": prompt_s,
            "profile": profile}


# --------------------------------------------------------------------- #
# 3b. the main path through the router
# --------------------------------------------------------------------- #
def router_phase(model, params, seed, swap_root, label, n_calls,
                 quant_resident=False, policy="llms", decode_batch=None,
                 profiled=False, keep_logits=False):
    """The main path through its normal entry point: the port's
    ``launch.serve.serve`` (the serving step of ``launch.serve.main``:
    the service config, the pipeline profile under ``llms``, a markov
    trace from ``trace.synth.synthesize`` and ``run_trace``) replays the
    trace through an inline ``ServiceRouter`` (2 apps at priority mix
    1:1, decode-slice preemption, next-context hints) over
    ``LLMService`` on ``model``'s device (the CPU only to rehearse this
    script at a reduced size).  The kernel launch counts are zeroed just
    before the replay and read just after.  With ``profiled``, one
    decode round of at least two rows runs under the profiler; with
    ``keep_logits``, every greedy pick of the trace's calls keeps its
    logits row (on the CPU) and the context's bit plan at the call's
    start."""
    import numpy as np
    import torch
    from repro_torch.core import restore
    from repro_torch.kernels import decode_mqattn as kmq
    from repro_torch.launch.serve import parse_args, serve

    cfg, device = model.cfg, model.device
    on_card = device.type == "cuda"
    B = ROUTER["decode_batch"] if decode_batch is None else decode_batch
    raw_chunk = _raw_chunk_bytes(model)
    args = parse_args([
        "--policy", policy, "--pattern", "markov",
        "--contexts", str(ROUTER["contexts"]), "--calls", str(n_calls),
        "--max-ctx", str(ROUTER["max_ctx"]),
        "--budget-mib", repr(ROUTER["budget_chunks"] * raw_chunk / 2**20),
        "--max-new", str(ROUTER["max_new"]), "--seed", str(seed),
        "--concurrency", str(ROUTER["apps"]),
        "--priority-mix", ROUTER["mix"],
        "--slice-steps", str(ROUTER["slice_steps"]),
        "--decode-batch", str(B),
        "--swap-dir", tempfile.mkdtemp(dir=swap_root)]
        + (["--quant-resident"] if quant_resident else []))
    tally = {"checked": 0, "rounds": [], "profile": None}
    log_, picks, plans, run = [], [], {}, {}
    # the calls whose picks are being kept: the trace's, not the episode's
    rec = {"on": keep_logits, "rows": None, "calls": {}}

    def keep(cid, row):
        k = rec["calls"][cid] - 1
        step = sum(1 for p in picks if p[:2] == (cid, k))
        picks.append((cid, k, step, torch.as_tensor(
            np.asarray(row, np.float32)).reshape(-1).clone()))

    def on_start(svc, router):
        exe, res = svc.exe, svc.res
        extend, decode, evict = exe.paged_extend, exe.paged_decode, res.evict
        begin, decode_round = svc.begin_call, svc._decode_round_paged

        def finite(out):
            if not np.isfinite(np.asarray(out[1], np.float32)).all():
                raise AssertionError("non-finite logits in the router phase")
            tally["checked"] += 1
            return out

        def checked_extend(*a, **k):
            out = finite(extend(*a, **k))
            if rec["on"] and rec["rows"] is not None:
                keep(rec["rows"][0], out[1])
            return out

        def checked_decode(*a, **k):
            # (arenas, toks, pos, pt16, pt8, qmask): the round's rows,
            # whether a row holds a quant chunk, and its decode_mqattn
            # launches
            rows = len(a[1])
            qmask = a[5] if len(a) > 5 else k.get("qmask")
            quant_round = qmask is not None and bool(np.asarray(qmask).any())
            mq0 = kmq.decode_mqattn.launches
            if (on_card and profiled and tally["profile"] is None
                    and rows >= 2
                    and len(tally["rounds"]) >= ROUTER["profiled_round"]):
                out, tally["profile"] = _profile_round(
                    lambda: decode(*a, **k))
                tally["profile"]["rows"] = rows
            else:
                out = decode(*a, **k)
            tally["rounds"].append((rows, quant_round,
                                    kmq.decode_mqattn.launches - mq0))
            finite(out)
            if rec["on"]:
                for cid, row in zip(rec["rows"], out[1]):
                    keep(cid, row)
            return out

        def logged_evict(key):
            log_.append(("evict", tuple(int(x) for x in key)))
            return evict(key)

        def recorded_begin(stub, request):
            cid = stub.ctx_id
            if rec["on"]:
                k = rec["calls"].get(cid, 0)
                rec["calls"][cid] = k + 1
                plans[cid, k] = tuple((m.bits, m.quant) for _, m in sorted(
                    svc.contexts[cid].chunks.items()))
            rec["rows"] = [cid]
            return begin(stub, request)

        def recorded_round(live, fed):
            rec["rows"] = [st.ctx.cid for st in live]
            return decode_round(live, fed)

        exe.paged_extend, exe.paged_decode = checked_extend, checked_decode
        res.evict = logged_evict
        svc.begin_call, svc._decode_round_paged = recorded_begin, recorded_round

        def done(job, cancelled):
            cid = job["stub"].ctx_id
            chunks = sorted(svc.contexts[cid].chunks.items())
            log_.append(("done", cid, tuple(int(t) for t in
                                            job["stream"].tokens),
                         job["stream"].n_preempts,
                         tuple(m.bits for _, m in chunks),
                         tuple(m.quant for _, m in chunks)))

        router.on_complete = done
        run["read0"] = restore.io_counters()["read"]
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        _zero_launches()
        run["t0"] = time.perf_counter()

    def on_end(svc, router, events):
        rec["on"] = False
        run["trace_calls"] = len(router.call_records)
        run["episode"] = _preempt_episode(router, events)
        if on_card:
            torch.cuda.synchronize()
        run["run_s"] = time.perf_counter() - run["t0"]
        run["launches"] = _read_launches()
        run["restored"] = restore.io_counters()["read"] - run["read0"]
        run["calls"] = list(router.call_records)
        run["router"] = router.stats()
        run["pipeline"] = (dataclasses.asdict(svc.res.profile)
                           if svc.res.profiled else None)
        run["peak"] = _peak_memory() if on_card else None
        run["graphs"] = (graph_check(svc.exe, svc.res.pool.arenas,
                                     f"router:{label}")
                         if svc.exe.paged else None)

    stats = serve(model, params, args, threaded=False, on_start=on_start,
                  on_end=on_end, verbose=False)
    episode, calls, r = run["episode"], run["calls"], run["router"]
    trace_calls, launches = run["trace_calls"], run["launches"]
    run_s, restored = run["run_s"], run["restored"]
    failed = stats["failed_calls"] + sum(x.error is not None
                                         for x in episode)
    n_calls += len(episode)
    sizes = {}
    for rows, _, _ in tally["rounds"]:
        sizes[rows] = sizes.get(rows, 0) + 1
    batched_mq = sum(mq > 0 for rows, _, mq in tally["rounds"] if rows >= 2)
    done_ = [e for e in log_ if e[0] == "done"]
    bits = [b for e in done_ for b in e[4]]
    n_evict = sum(e[0] == "evict" for e in log_)
    name = f"[router:{label}]"
    for i, c in enumerate(calls):
        ttft = c.get("ttft_s")
        log(f"{name} call {i:2d} {c['app']} prio {c['priority']} ctx "
            f"{c['ctx']} | wait {c['wait_s'] * 1e3:.1f} ms | switch "
            f"{c['switch_s'] * 1e3:.3f} ms | wall (service) "
            f"{c['service_s'] * 1e3:.1f} ms | ttft "
            f"{'-' if ttft is None else f'{ttft * 1e3:.1f} ms'} | preempts "
            f"{c['n_preempts']} | tokens {list(done_[i][2])} | bits "
            f"{list(done_[i][4])}")
    walls = sorted(c["service_s"] * 1e3 for c in calls)
    switch = sorted(c["switch_s"] * 1e3 for c in calls)
    log(f"{name} {cfg.name} policy {policy}, quant_resident "
        f"{quant_resident}, decode_batch {B}: {len(calls)} calls in "
        f"{run_s:.2f} s")
    log(f"{name} per-call wall (service) median "
        f"{walls[len(walls) // 2]:.1f} ms (min {walls[0]:.1f}, max "
        f"{walls[-1]:.1f})")
    log(f"{name} switch_s median {switch[len(switch) // 2]:.3f} ms (max "
        f"{switch[-1]:.3f})")
    for prio in ("foreground", "background"):
        if prio in r:
            p = r[prio]
            log(f"{name} {prio}: {p['calls']} calls, queue wait mean "
                f"{p['wait_mean_s'] * 1e3:.1f} ms (p95 "
                f"{p['wait_p95_s'] * 1e3:.1f}), TTFT mean "
                f"{p.get('ttft_mean_s', 0) * 1e3:.1f} ms (p95 "
                f"{p.get('ttft_p95_s', 0) * 1e3:.1f}), preempts "
                f"{p['preempts']}")
    log(f"{name} preemptions {r['preemptions']} "
        f"{r['preemptions_by_priority']}")
    log(f"{name} AoT flushes {r['aot_flushes']} (prefetch hints "
        f"{r['prefetch_hints']})")
    log(f"{name} prediction accuracy {r['pred_hits']}/{r['pred_total']}")
    log(f"{name} decode-batch sizes {dict(sorted(sizes.items()))} over "
        f"{r['decode_rounds']} rounds, tokens per round "
        f"{r['tokens_per_round']:.3f}, joins mid-slice "
        f"{r['joins_mid_slice']}; rounds over a quant chunk "
        f"{sum(q for _, q, _ in tally['rounds'])}, of them with >= 2 rows "
        f"and decode_mqattn {batched_mq}")
    log(f"{name} kernel launches per call "
        f"{ {k: v / max(len(calls), 1) for k, v in launches.items()} } "
        f"(in all {launches})")
    log(f"{name} evictions {n_evict}, restored {restored} B from disk; "
        f"chunk bit widths {sorted(set(bits))}; logits checked finite "
        f"{tally['checked']} times; failed calls {failed}")
    if tally["profile"] is not None:
        log(f"{name} a decode round of {tally['profile']['rows']} rows "
            f"under the profiler: {json.dumps(tally['profile'])}")
    log(f"{name} pipeline profile (recompute s = base + per chunk * x, "
        f"read s = base + per byte * n): {run['pipeline']}")
    log(f"{name} peak memory {run['peak']} B (reserved includes the graph "
        f"pool)")

    if failed or len(done_) != n_calls:
        raise AssertionError(f"{name} {failed} failed calls, "
                             f"{len(done_)} of {n_calls} completed")
    if not (r["preemptions"] and all(x.n_preempts == 0 for x in episode[-1:])
            and any(x.n_preempts for x in episode)):
        raise AssertionError(f"{name} the foreground arrival preempted no "
                             "background generation")
    if B > 1 and not any(rows >= 2 for rows, _, _ in tally["rounds"]):
        raise AssertionError(f"{name} no decode round ran with B >= 2")
    if not (n_evict and restored > 0):
        raise AssertionError(f"{name} no chunk went to disk and came back")
    if not any(b < 16 for b in bits):
        raise AssertionError(f"{name} no chunk was stored below 16 bits")
    if not tally["checked"]:
        raise AssertionError(f"{name} no logits were checked")
    if on_card and not (launches["quantize"] and launches["dequantize"]
                        and launches["attn_density"]):
        raise AssertionError(f"{name} a kernel of the path never ran: "
                             f"{launches}")
    if quant_resident and on_card and B > 1 and not batched_mq:
        raise AssertionError(f"{name} decode_mqattn never ran on a round "
                             "of >= 2 rows")
    if policy == "llms_nolife" and not r["aot_flushes"]:
        raise AssertionError(f"{name} the next-context hint flushed nothing")
    if run["pipeline"] is None:
        raise AssertionError(f"{name} the service did not profile the "
                             "restore pipeline")
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return {"log": log_, "router": r, "calls": calls, "sizes": sizes,
            "trace_calls": trace_calls,
            "launches": launches, "run_s": run_s, "restored": restored,
            "evictions": n_evict, "batched_mq": batched_mq,
            "profile": tally["profile"], "picks": picks, "plans": plans,
            "graphs": run["graphs"], "peak_bytes": run["peak"]}


def _preempt_episode(router, events):
    """Decode-slice preemption after the trace: a background generation
    on each decode slot (fresh contexts, the trace's first prompts, three
    slices long), and a foreground call that arrives after their second
    round; at the next slice boundary the router suspends one background
    generation (``suspend_call``) for it and resumes that one later
    (``resume_call``).  Inline, so it is deterministic.  -> the streams,
    the foreground one last."""
    fg, bg = router.sessions["app0"], router.sessions["app1"]
    prompts = [ev.prompt[:64].tolist() for ev in events]
    n = router.decode_batch
    streams = [bg.stream(bg.new_ctx(), prompts[i],
                         max_new_tokens=3 * ROUTER["slice_steps"])
               for i in range(n)]
    fg_stub = fg.new_ctx()
    rounds = []

    def arrive(live):
        rounds.append(len(live))
        if len(rounds) == 2:
            streams.append(fg.stream(fg_stub, prompts[n], max_new_tokens=4))

    hook, router.on_round = router.on_round, arrive
    router.drain()
    router.on_round = hook
    return streams


def entry_point_phase(swap_root):
    """``launch.serve.main`` as a user runs it, on the card: smollm-360m
    at full width from its own seeded init, its threaded router (2 apps,
    each submitting from a thread of its own) at the router phase's
    settings.  The printed JSON must show every call served.  -> the
    stats."""
    import contextlib
    import io
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    cfg = get_config("smollm-360m")
    raw_chunk = 2 * cfg.n_layers * 16 * cfg.n_kv_heads * cfg.head_dim * 2
    argv = ["--arch", cfg.name, "--contexts", str(ROUTER["contexts"]),
            "--calls", str(ROUTER["gqa_calls"]),
            "--max-ctx", str(ROUTER["max_ctx"]),
            "--budget-mib", repr(ROUTER["budget_chunks"] * raw_chunk / 2**20),
            "--concurrency", str(ROUTER["apps"]),
            "--priority-mix", ROUTER["mix"],
            "--slice-steps", str(ROUTER["slice_steps"]),
            "--decode-batch", str(ROUTER["decode_batch"]),
            "--seed", str(SEED), "--swap-dir", tempfile.mkdtemp(dir=swap_root)]
    _zero_launches()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        stats = serve.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    text = out.getvalue()
    printed = json.loads(text[re.search(r"^\{", text, re.M).start():])
    r = printed["router"]
    n = sum(r[p]["calls"] for p in ("foreground", "background") if p in r)
    launches = _read_launches()
    log(f"[entry] python -m repro_torch.launch.serve {' '.join(argv[:-2])}: "
        f"{n} calls, failed {printed['failed_calls']}, device "
        f"{printed['device']}, wall {wall:.2f} s (model build included), "
        f"replay {printed['wall_s']:.2f} s, decode rounds "
        f"{r['decode_rounds']} at {r['tokens_per_round']:.3f} tokens a "
        f"round, preemptions {r['preemptions']}, kernel launches "
        f"{launches}")
    if printed["failed_calls"] or n != ROUTER["gqa_calls"] \
            or not printed["device"].startswith("cuda"):
        raise AssertionError(f"[entry] the entry point served {n} of "
                             f"{ROUTER['gqa_calls']} calls, "
                             f"{printed['failed_calls']} failed, on "
                             f"{printed['device']}")
    if not launches["attn_density"]:
        raise AssertionError("[entry] no prefill went through attn_density")
    return stats


def _same_run(a, b, what):
    """A rerun from the same seed must give the same completions (order,
    tokens, preemptions, bit plans, quant flags) and evictions."""
    if a["log"] != b["log"]:
        i = next((i for i, (x, y) in enumerate(zip(a["log"], b["log"]))
                  if x != y), min(len(a["log"]), len(b["log"])))
        raise AssertionError(f"{what}: the rerun differs at entry {i}: "
                             f"{a['log'][i:i + 1]} vs {b['log'][i:i + 1]}")
    n = sum(e[0] == "done" for e in a["log"])
    log(f"[router] {what}: the same-seed rerun gave identical tokens, bit "
        f"plans and evictions over {n} calls")


def _tokens_by_call(run):
    """{(ctx, k): tokens of ctx's k-th call} over a router run's trace
    calls (they complete before the preemption episode starts)."""
    seen, out = {}, {}
    done = [e for e in run["log"] if e[0] == "done"]
    for e in done[:run["trace_calls"]]:
        k = seen.get(e[1], 0)
        seen[e[1]] = k + 1
        out[e[1], k] = e[2]
    return out


def _batch_agreement(batched, serial):
    """The share of the batched run's tokens equal to the B = 1 run's,
    call by call and position by position, over the trace's calls (the
    preemption episode differs with B: one background call a slot)."""
    a, b = _tokens_by_call(batched), _tokens_by_call(serial)
    same = total = 0
    for key, toks in a.items():
        ref = b.get(key, ())
        total += len(toks)
        same += sum(x == y for x, y in zip(toks, ref))
    return same / max(total, 1), same, total


def _batch_divergence(batched, serial):
    """Where the batched run's greedy picks first leave the B = 1 run's,
    call by call, from the logits both runs kept (``keep_logits``).  A
    call whose earlier calls on its context gave other tokens, or that
    starts under another bit plan, is counted as such and not examined.
    For every other call that differs: its first differing step, the
    B = 1 row's top-2 gap there, the largest logit difference between
    the runs there (over the vocabulary and on the two picked tokens),
    the largest difference over the call's earlier steps, and whether
    the gap lies within the step's difference (a near-tie).  -> (counts,
    the examined calls)."""
    import torch

    def by_call(run):
        out = {}
        for cid, k, step, row in run["picks"]:
            out.setdefault((cid, k), {})[step] = row
        return out

    a, b = by_call(batched), by_call(serial)
    counts = {"calls": 0, "equal": 0, "near_tie": 0, "wide": 0,
              "after_a_difference": 0, "other_bit_plan": 0}
    examined, diverged = [], set()
    for key in sorted(set(a) & set(b), key=lambda x: (x[1], x[0])):
        counts["calls"] += 1
        ra, rb = a[key], b[key]
        steps = sorted(set(ra) & set(rb))
        first = next((j for j in steps
                      if int(ra[j].argmax()) != int(rb[j].argmax())), None)
        if key[0] in diverged:
            counts["after_a_difference"] += 1
            continue
        if first is None:
            counts["equal"] += 1
            continue
        diverged.add(key[0])
        if batched["plans"][key] != serial["plans"][key]:
            counts["other_bit_plan"] += 1
            continue
        t1, t4 = int(rb[first].argmax()), int(ra[first].argmax())
        top2 = torch.topk(rb[first], 2).values
        gap = float(top2[0] - top2[1])
        d = (ra[first] - rb[first]).abs()
        before = max((float((ra[j] - rb[j]).abs().max())
                      for j in steps if j < first), default=None)
        tie = gap <= float(d.max())
        counts["near_tie" if tie else "wide"] += 1
        examined.append({"ctx": key[0], "call": key[1], "step": first,
                         "tokens_b1_b4": (t1, t4), "top2_gap_b1": gap,
                         "max_abs_diff": float(d.max()),
                         "diff_on_picked": (float(d[t1]), float(d[t4])),
                         "max_abs_diff_before": before, "near_tie": tie})
    return counts, examined


# --------------------------------------------------------------------- #
# 3c. the slot engine: paged_pool=False, the Fig.-8 pipelined restore and
#     the whole-state baselines
# --------------------------------------------------------------------- #
def _zero_launches():
    """Every kernel wrapper's launch count to 0."""
    from repro_torch.kernels import reset_launch_counts
    reset_launch_counts()


def _read_launches():
    from repro_torch.kernels import launch_counts
    return launch_counts()


def _capturing() -> bool:
    """A CUDA graph capture is under way on this thread's stream."""
    import torch
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


class _KernelCalls:
    """While installed, keeps the first ``attn_density`` and
    ``decode_mqattn`` call of each shape and setting that the main path
    makes (inputs and results, cloned); ``check`` holds each against its
    plain version on its own inputs.  A graph replay runs no Python: the
    slot engines' calls are kept where ``graph_check`` runs each graph's
    eager body on its last staged inputs after the run (a capture's own
    calls are not kept).  ``close`` takes the hooks off."""

    def __init__(self, name):
        from repro_torch.kernels import ops
        self.name, self.kept = name, {}
        attn, mq = ops.attn_density, ops.decode_mqattn
        self._undo = [(ops, "attn_density", attn), (ops, "decode_mqattn", mq)]

        def kept_attn(q, k, v, q_pos, seq_len, window=0, n_sinks=0,
                      want_density=True, form="served"):
            if _capturing():
                return attn(q, k, v, q_pos, seq_len, window, n_sinks,
                            want_density, form)
            args = (q, k, v, q_pos, int(seq_len), int(window), int(n_sinks),
                    bool(want_density), form)
            out = attn(*args)
            self._keep("attn_density", args, out)
            return out

        def kept_mq(q, k, v, k_q, v_q, k_scale, v_scale, quant_mask,
                    n_valid, window=0, n_sinks=0, want_mass=False,
                    select=False):
            args = (q, k, v, k_q, v_q, k_scale, v_scale, quant_mask,
                    n_valid, window, n_sinks, want_mass, select)
            out = mq(*args)
            if not _capturing():
                self._keep("decode_mqattn", args, out)
            return out

        ops.attn_density, ops.decode_mqattn = kept_attn, kept_mq

    def _keep(self, kind, args, out):
        key = (kind,) + tuple(tuple(a.shape) if hasattr(a, "shape") else a
                              for a in args)
        if key not in self.kept:
            self.kept[key] = (
                [a.clone() if hasattr(a, "clone") else a for a in args],
                [None if t is None else t.clone() for t in
                 (out if isinstance(out, tuple) else (out,))])

    def ran(self, kind):
        return any(key[0] == kind for key in self.kept)

    def close(self):
        for obj, attr, fn in self._undo:
            setattr(obj, attr, fn)
        self._undo = []

    def check(self):
        """Each kept call against its plain version: out within
        MQ_OUT_TOL of its range, density within AD_DENS_TOL of its range,
        mass within MQ_MASS_TOL.  -> one (kind, q shape, k shape, the
        call's other settings, |d out| / range, |d density or mass|) row
        a kept call."""
        from repro_torch.kernels import ref
        rows = []
        for key, (args, outs) in self.kept.items():
            kind = key[0]
            plain = (ref.attn_density_plain(*args) if kind == "attn_density"
                     else ref.decode_mqattn_plain(*args))
            plain = plain if isinstance(plain, tuple) else (plain,)
            span = float(plain[0].float().abs().max())
            d_o = float((outs[0].float() - plain[0].float()).abs().max())
            d_x = 0.0
            if len(plain) > 1 and plain[1] is not None:
                d_x = float((outs[1] - plain[1]).abs().max())
                if kind == "attn_density":
                    d_x /= float(plain[1].abs().max())
            tol_x = AD_DENS_TOL if kind == "attn_density" else MQ_MASS_TOL
            settings = [a for a in args if not hasattr(a, "shape")]
            if not (d_o <= MQ_OUT_TOL * span and d_x <= tol_x):
                raise AssertionError(
                    f"{self.name} {kind} on the main path at {key[1:3]}, "
                    f"{settings}: |d out| {d_o} (range {span}), |d density "
                    f"or mass| {d_x}")
            rows.append((kind, key[1], key[2], settings, d_o / span, d_x))
        return rows


class _SlotHooks:
    """Hooks on one slot-engine ``LLMService`` that the slot and MLA
    phases share.  Per call (``begin``, then ``record``): the restore
    splits (chunks recomputed, read), each whole-state restore
    (resident, read or recompute), each pipelined restore's wall, its
    gates' wait for the feed (that of layer 0 apart) and the swapper
    jobs still pending when it started (an ahead-of-time write queued
    before its feed delays the first layer), the bytes read, and every
    greedy pick's logits row (on the CPU).  Over the run: the recomputes (each ``extend``,
    ``extend_nod`` and ``lmk`` whole recompute), the steps named in
    ``profile`` ("restore", "decode token", "recompute": an extend) each
    run once under the profiler after call ``profile_from``, and the
    kernel calls that ``kernels`` (``_KernelCalls``) keeps and checks.
    ``close`` takes the hooks off."""

    def __init__(self, svc, name, on_card, profile=(), profile_from=0,
                 top=0):
        import numpy as np
        import torch
        exe, res = svc.exe, svc.res
        self.name, self.on_card = name, on_card
        self.now = {"split": [], "pipelined": [], "whole": [], "rows": []}
        self.records, self.picks, self.prof = [], [], {}
        self.calls = self.n_recompute = self.read0 = self.late0 = 0
        self.graphs = exe.graphs
        plan, pipe = res._plan_restore, exe.run_pipelined
        whole = res._restore_whole_timed
        extend, decode = exe.extend, exe.decode
        nod, rewhole = exe.extend_nod, exe.recompute_whole
        self._undo = [(res, "_plan_restore", plan),
                      (res, "_restore_whole_timed", whole),
                      (exe, "run_pipelined", pipe), (exe, "extend", extend),
                      (exe, "decode", decode), (exe, "extend_nod", nod),
                      (exe, "recompute_whole", rewhole)]
        now = self.now

        def profiled(kind, fn):
            if on_card and kind in profile and kind not in self.prof \
                    and self.calls > profile_from:
                out, self.prof[kind] = _profile_round(fn, top=top)
                self.prof[kind]["call"] = self.calls - 1
                return out
            return fn()

        def logged_plan(ctx, missing):
            re_idx, io_idx = plan(ctx, missing)
            now["split"].append((list(map(int, re_idx)),
                                 list(map(int, io_idx))))
            return re_idx, io_idx

        def logged_pipe(*a, **k):
            ahead = sum(not f.done() for f in
                        list(res.swapper._pending.values()))
            out = profiled("restore", lambda: pipe(*a, **k))
            now["pipelined"].append(dict(exe.last_pipelined,
                                         jobs_ahead=ahead))
            return out

        def logged_whole(ctx, cache):
            now["whole"].append(
                "resident" if ctx.whole is not None
                else "read" if svc.cfg.use_disk
                and res.store.nbytes((ctx.cid, -1)) else "recompute")
            return whole(ctx, cache)

        def kept(fn, kind):
            def run(*a, **k):
                if kind == "recompute":
                    self.n_recompute += 1
                out = profiled(kind, lambda: fn(*a, **k))
                row = torch.as_tensor(np.asarray(out[1], np.float32)
                                      ).reshape(-1)
                if not torch.isfinite(row).all():
                    raise AssertionError(f"{name} non-finite logits")
                now["rows"].append(row.clone())
                return out
            return run

        def counted(fn):
            def run(*a, **k):
                self.n_recompute += 1
                return profiled("recompute", lambda: fn(*a, **k))
            return run

        res._plan_restore, exe.run_pipelined = logged_plan, logged_pipe
        if not svc.cfg.chunked or not exe.chunked_cache:
            res._restore_whole_timed = logged_whole
        exe.extend = kept(extend, "recompute")
        exe.decode = kept(decode, "decode token")
        exe.extend_nod = counted(nod)
        exe.recompute_whole = counted(rewhole)
        self.kernels = _KernelCalls(name)

    def begin(self):
        from repro_torch.core import restore
        for v in self.now.values():
            v.clear()
        self.calls += 1
        self.read0 = restore.io_counters()["read"]
        self.late0 = self.graphs.late_captures

    def record(self, context, toks, **extra):
        """The call that just ended on the service's ``context``."""
        from repro_torch.core import restore
        i, now = len(self.records), self.now
        if len(now["rows"]) != len(toks):
            raise AssertionError(f"{self.name} call {i}: {len(now['rows'])} "
                                 f"logits rows for {len(toks)} tokens")
        self.picks.extend((i, j, row) for j, row in enumerate(now["rows"]))
        metas = [m for _, m in sorted(context.chunks.items())]
        rec = {**extra, "tokens": list(map(int, toks)),
               "bits": [m.bits for m in metas],
               "quant": [m.quant for m in metas],
               "restored_bytes": restore.io_counters()["read"] - self.read0,
               "split": list(now["split"]),
               "pipelined": list(now["pipelined"]),
               "whole": list(now["whole"]),
               "late_captures": self.graphs.late_captures - self.late0}
        # a switch-in that brought swapped-out chunks back: read from disk
        # or, where the Eq.-4 split chose it, recomputed (the split is
        # made only for missing chunks), or a whole-state restore
        rec["disk_restore"] = bool(rec["restored_bytes"] > 0 or any(
            w in ("read", "recompute") for w in rec["whole"])
            or rec["split"])
        self.records.append(rec)
        return rec

    def close(self):
        for obj, attr, fn in self._undo:
            setattr(obj, attr, fn)
        self._undo = []
        self.kernels.close()

    def summary(self, launches, run_s, profile_used):
        """Log the run's restores, profiles and the check of its own
        kernel calls.  -> (disk-restore switch_s in ms, sorted;
        the splits; the pipelined restores; the checked calls)."""
        recs, name = self.records, self.name
        disk = sorted(r["switch_s"] * 1e3 for r in recs if r["disk_restore"])
        pipes = [p for r in recs for p in r["pipelined"]]
        splits = [s for r in recs for s in r["split"]]
        log(f"{name} {len(recs)} calls in {run_s:.2f} s; kernel launches "
            f"{launches} over {self.n_recompute} recomputes")
        log(f"{name} restore profile {profile_used}")
        if disk:
            log(f"{name} switch_s over {len(disk)} disk restores: median "
                f"{disk[len(disk) // 2]:.3f} ms, max {disk[-1]:.3f} ms")
        if splits:
            log(f"{name} chunks recomputed / read per restore: "
                f"{[(len(a), len(b)) for a, b in splits]}")
        if pipes:
            walls = sorted(p["wall_s"] * 1e3 for p in pipes)
            waits = sorted(p["feed_wait_s"] * 1e3 for p in pipes)
            first = sorted(p["first_wait_s"] * 1e3 for p in pipes)
            log(f"{name} {len(pipes)} pipelined restores: wall median "
                f"{walls[len(walls) // 2]:.2f} ms (max {walls[-1]:.2f}), "
                f"the gates' wait for the feed median "
                f"{waits[len(waits) // 2]:.2f} ms (max {waits[-1]:.2f}), "
                f"layer 0's median {first[len(first) // 2]:.2f} ms (max "
                f"{first[-1]:.2f}); {sum(p['jobs_ahead'] > 0 for p in pipes)}"
                f" started with swapper jobs pending "
                f"({[p['jobs_ahead'] for p in pipes]})")
        for kind, p in self.prof.items():
            log(f"{name} one {kind} under the profiler: {json.dumps(p)}")
        checked = self.kernels.check()
        log(f"{name} its own kernel calls against the plain versions, one "
            f"of each shape and setting (kind, q shape, k shape, settings, "
            f"|d out| / range, |d density or mass|): {checked}")
        return disk, splits, pipes, checked


def _slot_gates(name, hooks, launches, on_card, full_budget, codec):
    """The gates the slot and MLA phases share: every call gave its 8
    tokens; at the phase's own budget at least two restores brought
    swapped-out chunks back (read from disk, or recomputed where the
    Eq.-4 split chose it; under lmk, recomputed a killed context);
    attn_density ran,
    and each shape it ran at was checked; where ``codec``, both codec
    kernels ran; decode_qattn never ran (a slot cache holds no all-int8
    layout)."""
    if any(len(r["tokens"]) != 8 for r in hooks.records):
        raise AssertionError(f"{name} a call did not complete")
    n_disk = sum(r["disk_restore"] for r in hooks.records)
    if full_budget and n_disk < 2:
        raise AssertionError(f"{name} {n_disk} restores of swapped-out "
                             f"chunks (or, under lmk, recomputes of a "
                             f"killed context), not >= 2")
    if on_card and not (launches["attn_density"]
                        and hooks.kernels.ran("attn_density")):
        raise AssertionError(f"{name} attn_density never ran")
    if on_card and codec and not (launches["quantize"]
                                  and launches["dequantize"]):
        raise AssertionError(f"{name} a codec kernel never ran: {launches}")
    if launches["decode_qattn"]:
        raise AssertionError(f"{name} decode_qattn ran on the slot cache, "
                             "which holds no all-int8 layout")


def slot_phase(model, params, seed, swap_root, label, policy="llms",
               quant_resident=False, split="profiled", profile=None,
               budget_chunks=SLOT["budget_chunks"], profile_restore=False):
    """Drive LLMService over ``model`` with ``paged_pool=False`` (each
    context assembled into a slot cache) through ``callLLM``: the serve
    phase's trace (4 contexts x 3 rounds, prompts 32-64, 8 new tokens,
    decode_batch 1).  ``split``: "profiled" measures the card's §3.3.i
    profile (``profile_pipeline``) and the Eq.-4 split follows it;
    "forced" leaves the service unprofiled, so the heaviest half of
    every restore is recomputed (the Fig.-8 loop surely runs); a given
    ``profile`` (a rerun) is injected instead.  The kernel launch counts
    are zeroed just before the calls and read just after.  Every greedy
    pick keeps its logits row (on the CPU), and the run's own
    attn_density calls are held against the plain version
    (``_SlotHooks``).  With ``profile_restore``, the first pipelined
    restore runs under the profiler."""
    import torch
    from repro_torch.core.service import LLMService, LLMSConfig
    from repro_torch.kernels import attn_density as kad
    from repro_torch.kernels import decode_mqattn as kmq

    cfg, device = model.cfg, model.device
    on_card = device.type == "cuda"
    name = f"[slot:{label}]"
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    sc = LLMSConfig(policy=policy, paged_pool=False, decode_batch=1,
                    max_ctx_len=SLOT["max_ctx"], chunk_tokens=16,
                    memory_budget=budget_chunks * _raw_chunk_bytes(model),
                    quant_resident=quant_resident,
                    swap_dir=tempfile.mkdtemp(dir=swap_root))
    svc = LLMService(model, params, sc, device=device)
    res = svc.res
    if sc.use_pipeline:
        if profile is not None:
            for k, v in profile.items():
                setattr(res.profile, k, v)
            res.profiled = True
        elif split == "profiled":
            svc.profile_pipeline()
    used_profile = dataclasses.asdict(res.profile) if res.profiled else None
    # a decode token of the llms and quant runs (a replay of the slot's
    # decode graph) and the forced run's first pipelined restore
    kinds = (("restore",) if profile_restore else ()) + (
        ("decode token",) if label in ("llms", "quant") else ())
    hooks = _SlotHooks(svc, name, on_card, profile=kinds, top=8,
                       profile_from=0 if profile_restore else 4)
    trace = _trace(cfg.vocab, seed)
    with svc:
        stubs = [svc.newLLMCtx() for _ in range(4)]
        _zero_launches()
        t_run = time.perf_counter()
        for i, (c, prompt, max_new) in enumerate(trace):
            hooks.begin()
            ad0, mq0 = kad.attn_density.launches, kmq.decode_mqattn.launches
            t1 = time.perf_counter()
            _, toks = svc.callLLM(stubs[c], prompt, max_new)
            svc.exe.sync()
            wall = time.perf_counter() - t1
            rec = hooks.record(
                svc.contexts[stubs[c].ctx_id], toks, ctx=c,
                switch_s=svc.records[-1]["switch_s"], wall_s=wall,
                attn_density_launches=kad.attn_density.launches - ad0,
                mqattn_launches=kmq.decode_mqattn.launches - mq0)
            pl = ", ".join(f"{p['wall_s'] * 1e3:.1f} ms (gates waited "
                           f"{p['feed_wait_s'] * 1e3:.1f} ms)"
                           for p in rec["pipelined"])
            log(f"{name} call {i:2d} ctx {c} prompt {len(prompt)} -> "
                f"{len(toks)} tokens | switch {rec['switch_s'] * 1e3:.3f} ms "
                f"| read {rec['restored_bytes']} B | split (recompute, io) "
                f"{rec['split']} | pipelined {pl or '-'} | whole "
                f"{rec['whole'] or '-'} | wall {wall * 1e3:.1f} ms | "
                f"attn_density {rec['attn_density_launches']} | "
                f"decode_mqattn {rec['mqattn_launches']} | bits "
                f"{rec['bits']}")
        run_s = time.perf_counter() - t_run
        launches = _read_launches()
        stats = svc.stats()
        peak = _peak_memory() if on_card else None
        graphs = graph_check(svc.exe, None, f"slot:{label}")
    hooks.close()
    log(f"{name} peak memory {peak}")
    log(f"{name} {cfg.name} policy {policy}, quant_resident "
        f"{quant_resident}, split {split if profile is None else 'given'}")
    disk, splits, pipes, checked = hooks.summary(launches, run_s,
                                                 used_profile)
    log(f"{name} stats {json.dumps(stats, default=str)}")

    if stats["total_calls"] != len(trace):
        raise AssertionError(f"{name} a call did not complete")
    _slot_gates(name, hooks, launches, on_card,
                budget_chunks == SLOT["budget_chunks"], sc.chunked)
    if quant_resident and on_card and not launches["decode_mqattn"]:
        raise AssertionError(f"{name} decode_mqattn never ran on the slot "
                             "cache")
    if split == "forced" and sc.use_pipeline and budget_chunks == \
            SLOT["budget_chunks"] and not pipes:
        raise AssertionError(f"{name} no pipelined restore ran")
    # each pipelined restore replayed its graph, whose gates count once
    # a layer (graph_check: replays = calls, no eager slot call)
    if on_card and launches["feed_gate"] != cfg.n_layers * len(pipes):
        raise AssertionError(f"{name} {launches['feed_gate']} feed_gate "
                             f"launches for {len(pipes)} pipelined "
                             f"restores of {cfg.n_layers} layers")
    out = {"records": hooks.records, "launches": launches, "stats": stats,
           "run_s": run_s, "profile": used_profile, "picks": hooks.picks,
           "graphs": graphs, "peak_bytes": peak, "prof": hooks.prof,
           "restore_profile": hooks.prof.get("restore"),
           "disk_switch_ms": disk, "pipelined": pipes, "splits": splits,
           "attn_checked": checked}
    del svc, res, hooks
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return out


def _same_slot_run(a, b, what):
    """A rerun under the same profile must give the same tokens, bit
    plans and restore splits, call by call."""
    for i, (x, y) in enumerate(zip(a["records"], b["records"])):
        if (x["tokens"], x["bits"], x["split"]) != \
                (y["tokens"], y["bits"], y["split"]):
            raise AssertionError(f"{what}: the rerun differs at call {i}: "
                                 f"{x} vs {y}")
    log(f"[slot] {what}: the rerun under the same profile gave identical "
        f"tokens, bit plans and splits over {len(a['records'])} calls")


def _slot_divergence(run, base):
    """``run``'s tokens against the no-pressure run ``base``, call by
    call: equal calls, calls after an earlier difference on the same
    context, calls under another bit plan at their start, and for each
    other call that differs its first differing step, ``base``'s top-2
    gap there, the runs' largest logit difference there and whether the
    gap lies within it (a near-tie).  -> (counts, examined calls)."""
    import torch

    def rows(r):
        out = {}
        for i, j, row in r["picks"]:
            out.setdefault(i, {})[j] = row
        return out

    ra, rb = rows(run), rows(base)
    counts = {"calls": 0, "equal": 0, "after_a_difference": 0,
              "other_bit_plan": 0, "near_tie": 0, "wide": 0}
    examined, diverged, plan = [], set(), {}
    for i, (x, y) in enumerate(zip(run["records"], base["records"])):
        counts["calls"] += 1
        c = x["ctx"]
        start_a, start_b = plan.get(("a", c)), plan.get(("b", c))
        plan["a", c], plan["b", c] = x["bits"], y["bits"]
        if c in diverged:
            counts["after_a_difference"] += 1
            continue
        if x["tokens"] == y["tokens"]:
            counts["equal"] += 1
            continue
        diverged.add(c)
        if start_a != start_b:
            counts["other_bit_plan"] += 1
            continue
        j = next(j for j, (p, q) in enumerate(zip(x["tokens"], y["tokens"]))
                 if p != q)
        a, b = ra[i][j], rb[i][j]
        top2 = torch.topk(b, 2).values
        gap, d = float(top2[0] - top2[1]), float((a - b).abs().max())
        tie = gap <= d
        counts["near_tie" if tie else "wide"] += 1
        examined.append({"call": i, "ctx": c, "step": j,
                         "tokens_run_base": (x["tokens"][j], y["tokens"][j]),
                         "top2_gap_base": gap, "max_abs_diff": d,
                         "near_tie": tie})
    return counts, examined


def pipelined_check(model, params, swap_root, quant_resident=False):
    """One restore at full width, three ways, from the same prefilled
    cache (128 tokens; chunk 7 resident, as int8 segments in the mixed
    cache): chunks SLOT["io"] from chunk files (at SLOT["io_bits"]) and
    SLOT["recompute"] recomputed.  The layer-pipelined restore into slot
    0 (``run_pipelined`` over the executor's ``layer_feed``: on the card
    one replay of the slot's graph, its gates waiting on the device for
    the feed) must equal the whole-file inserts followed by the
    ``extend_nod`` graph on the scratch slot, and the same pipelined
    body run eagerly on a private clone, bit for bit over every context
    position, the quant mask and the recomputed rows' hidden state too,
    with no implicit sync inside the graphed restore, one replay, L
    attn_density and L feed_gate launches.  Then the graphed restore
    once more under the profiler.  -> its wall time (from the feed's
    start too), the gates' wait, each side alone, the launches and the
    profile."""
    import numpy as np
    import torch
    from repro_torch.core.restore import read_chunk_file, write_chunk_file
    from repro_torch.core.service import LLMService, LLMSConfig
    from repro_torch.kernels import attn_density as kad
    from repro_torch.kernels import feed_gate as kfg
    cfg, device = model.cfg, model.device
    on_card = device.type == "cuda"
    what = f"[slot] pipelined restore{' (mixed cache)' if quant_resident else ''}"
    sc = LLMSConfig(policy="llms", paged_pool=False,
                    max_ctx_len=SLOT["max_ctx"], memory_budget=1 << 40,
                    quant_resident=quant_resident,
                    swap_dir=tempfile.mkdtemp(dir=swap_root))
    out = {}
    with LLMService(model, params, sc, device=device) as svc:
        exe, res = svc.exe, svc.res
        cs, n = exe.cs, SLOT["n_tokens"]
        rng = np.random.default_rng(SEED + 7)
        toks = rng.integers(1, cfg.vocab, n).astype(np.int32)
        full, _, _ = exe.extend(exe.fresh_cache(0), toks, 0)
        last = n // cs - 1
        if quant_resident:
            qc = res._make_payload(full, last, 8, quant=True)
            exe.codec.scatter_quant(
                full, exe._t(exe.chunk_positions([last])),
                {k: torch.from_numpy(qc.data[k][0]).to(device)
                 for k in exe.codec.leaves},
                {k: torch.from_numpy(qc.data[k][1]).to(device)
                 for k in exe.codec.leaves})
        io_idx, re_idx = SLOT["io"], SLOT["recompute"]
        paths = []
        for i, bits in zip(io_idx, SLOT["io_bits"]):
            p = os.path.join(sc.swap_dir, f"check{i}.chunk")
            write_chunk_file(p, res._make_payload(full, i, bits),
                             exe.n_layers)
            paths.append(p)
        restored = exe._t(exe.chunk_positions(io_idx + re_idx))
        miss_b = exe.bucket_pad(exe.chunk_positions(re_idx), exe.pad_slot)
        toks_b = exe.bucket_pad(toks[exe.chunk_positions(re_idx)], 0)
        nio_b = next(x for x in exe.io_buckets if x >= len(io_idx))
        pad = nio_b - len(io_idx)
        io_pos_b = np.concatenate(
            [exe.chunk_positions(io_idx),
             np.full(pad * cs, exe.pad_slot, np.int32)])
        key = ("pipelined", (len(toks_b), nio_b), quant_resident, 0)

        def holes(slot=None):
            c = {k: v.clone() for k, v in full.items()}
            for k in exe.codec.leaves:
                c[k][:, :, restored] = 0
            if slot is None:
                return c
            cache = exe.fresh_cache(0, slot)
            for k, t in cache.items():
                t.copy_(c[k])
            return cache

        def pipelined(cache):
            t0 = time.perf_counter()
            feed = exe.layer_feed(paths, pad)
            _, hidden = exe.run_pipelined(feed, toks_b, miss_b, io_pos_b,
                                          cache, n)
            feed.close()
            out["restore_s"] = time.perf_counter() - t0
            return cache, hidden

        a = holes(0)
        exe.sync()
        _zero_launches()
        g0, e0 = dict(exe.graphs.stats()), exe.eager_calls
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if on_card:             # report implicit syncs of the restore
                torch.cuda.set_sync_debug_mode("warn")
            try:
                _, h_a = pipelined(a)
            finally:
                if on_card:
                    torch.cuda.set_sync_debug_mode("default")
        g1 = exe.graphs.stats()
        # each implicit sync the restore made, where (file:line), how often
        # (setting the mode warns once that it is a prototype: not a sync)
        out["sync_warnings"] = {}
        for w in caught:
            if "prototype feature" in str(w.message):
                continue
            wkey = (f"{os.path.basename(w.filename)}:{w.lineno}: "
                    f"{str(w.message).splitlines()[0][:60]}")
            out["sync_warnings"][wkey] = out["sync_warnings"].get(wkey, 0) + 1
        out["attn_density_launches"] = kad.attn_density.launches
        out["feed_gate_launches"] = kfg.feed_gate.launches
        out["graph"] = {"key": "/".join(map(str, key)),
                        "calls": g1["calls"] - g0["calls"],
                        "replays": g1["replays"] - g0["replays"],
                        "eager_calls": exe.eager_calls - e0,
                        "captured": "/".join(map(str, key))
                        in g1["captures"],
                        "pipelined_captures_ahead": g1["by_entry"].get(
                            "pipelined", {})}
        out.update(exe.last_pipelined)
        # each side alone: the feed with no compute, then the inserts and
        # the recompute (the scratch slot's extend_nod graph) with no feed
        t0 = time.perf_counter()
        feed = exe.layer_feed(paths, pad)
        for layer in range(exe.n_layers):
            feed.fetch(layer)
        feed.close()
        out["feed_alone_s"] = time.perf_counter() - t0
        b = holes(exe.scratch_slot)
        exe.sync()
        t0 = time.perf_counter()
        for i, p in zip(io_idx, paths):
            exe.codec.insert(b, i * cs, res._payload_blocks(
                read_chunk_file(p)))
        exe.sync()
        out["inserts_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        _, h_b, _ = exe.extend_nod(toks_b, miss_b, b, n)
        exe.sync()
        out["recompute_alone_s"] = time.perf_counter() - t0
        # the same body eagerly on a private clone (the gates on the card
        # too, while the host queues the rest of the restore)
        c = holes()
        e1 = exe.eager_calls
        feed = exe.layer_feed(paths, pad)
        _, h_c = exe.run_pipelined(feed, toks_b, miss_b, io_pos_b, c, n)
        feed.close()
        out["eager_wall_s"] = exe.last_pipelined["wall_s"]
        out["eager_feed_wait_s"] = exe.last_pipelined["feed_wait_s"]
        if exe.eager_calls != e1 + 1:
            raise AssertionError(f"{what}: the private clone's restore did "
                                 f"not run eagerly")
        for other, h, label in ((b, h_b, "the I/O-then-recompute restore"),
                                (c, h_c, "the eager body on a private "
                                         "clone")):
            if not torch.equal(h_a, h):
                raise AssertionError(f"{what}: the recomputed rows' hidden "
                                     f"state differs from {label}'s")
            for k in exe.codec.leaves:
                if not torch.equal(a[k][:, :, :n], other[k][:, :, :n]):
                    d = float((a[k][:, :, :n].float()
                               - other[k][:, :, :n].float()).abs().max())
                    raise AssertionError(f"{what}: leaf {k} differs from "
                                         f"{label} (max |diff| {d})")
            if quant_resident and not torch.equal(a["quant_mask"],
                                                  other["quant_mask"]):
                raise AssertionError(f"{what}: the quant masks differ from "
                                     f"{label}'s")
        if on_card:
            snap = {k: t.clone() for k, t in a.items()}
            holes(0)
            first_s = out["restore_s"]
            (_, _), out["profile"] = _profile_round(
                lambda: pipelined(exe.slot_caches[0]), top=8)
            out["restore_s"] = first_s
            prof = out["profile"]
            out["profile"]["device_ms_without_gates"] = prof["device_ms"] - \
                prof["by_category_ms"].get("feed_gate (waiting for the feed)",
                                           0.0)
            out["profiled_wall_s"] = exe.last_pipelined["wall_s"]
            if not all(torch.equal(exe.slot_caches[0][k], snap[k])
                       for k in exe.codec.leaves):
                raise AssertionError(f"{what}: the profiled rerun differs")
            g = out["graph"]
            if not (g["calls"] == g["replays"] == 1 and g["captured"]
                    and not g["eager_calls"]):
                raise AssertionError(f"{what}: not one replay of a graph "
                                     f"captured ahead: {g}")
            if out["sync_warnings"]:
                raise AssertionError(f"{what}: implicit syncs in the graphed "
                                     f"restore: {out['sync_warnings']}")
            if out["attn_density_launches"] != cfg.n_layers or \
                    out["feed_gate_launches"] != cfg.n_layers:
                raise AssertionError(
                    f"{what}: {out['attn_density_launches']} attn_density "
                    f"and {out['feed_gate_launches']} feed_gate launches, "
                    f"not {cfg.n_layers} each")
    log(f"{what}: chunks {io_idx} read at {SLOT['io_bits']} bits, "
        f"{re_idx} recomputed ({len(miss_b)} query rows incl. pads at "
        f"{exe.pad_slot}), over S = {exe.s_work}, into slot 0 through "
        f"graph {out['graph']}: equal to the I/O-then-recompute restore "
        f"and to the eager body on a private clone bit for bit; wall "
        f"{out['wall_s'] * 1e3:.2f} ms ({out['restore_s'] * 1e3:.2f} ms "
        f"from the feed's start), the gates waited for the feed "
        f"{out['feed_wait_s'] * 1e3:.2f} ms (layer 0 "
        f"{out['first_wait_s'] * 1e3:.2f} ms); alone: the feed "
        f"{out['feed_alone_s'] * 1e3:.2f} ms, the whole-file inserts "
        f"{out['inserts_s'] * 1e3:.2f} ms, the recompute (graph) "
        f"{out['recompute_alone_s'] * 1e3:.2f} ms; the eager body on a "
        f"private clone {out['eager_wall_s'] * 1e3:.2f} ms (gates waited "
        f"{out['eager_feed_wait_s'] * 1e3:.2f} ms); implicit syncs in the "
        f"restore {out['sync_warnings'] or 'none'}; attn_density launches "
        f"{out['attn_density_launches']}, feed_gate "
        f"{out['feed_gate_launches']}; under the profiler "
        f"{json.dumps(out.get('profile'))}")
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return out


def eager_entries_check(model, params, swap_root):
    """The reference's jitted entries that stay eager in the port, each
    once under the profiler at full width (llama2-7b, quant-resident;
    a warm call first): the codec's ``insert`` / ``scatter`` /
    ``scatter_quant`` and ``set_pos`` (the reference's ``setpos``) on a
    slot cache, and the paged pool's ``admit16`` / ``admit8`` /
    ``read16`` / ``zero16`` on one page.  -> {entry: its kernels, device
    and wall ms}."""
    import numpy as np
    import torch
    from repro_torch.core.service import LLMService, LLMSConfig
    device = model.device
    out = {}

    def profiled(name, fn):
        fn()
        _, prof = _profile_round(fn)
        out[name] = {k: prof[k] for k in ("kernels", "device_ms",
                                          "wall_ms")}

    kw = dict(policy="llms", max_ctx_len=SLOT["max_ctx"],
              memory_budget=1 << 40, quant_resident=True)
    with LLMService(model, params, LLMSConfig(
            paged_pool=False, swap_dir=tempfile.mkdtemp(dir=swap_root),
            **kw), device=device) as svc:
        exe = svc.exe
        cs, hd = exe.cs, exe.leaf_dims["k"][-1]
        cache = exe.fresh_cache(0, 0)
        blocks = exe.codec.extract(cache, 0, cs)
        pos = exe._t(exe.chunk_positions([1]))
        F = blocks["k"].shape[1]
        codes = {n: torch.zeros((cs, F), dtype=torch.int8, device=device)
                 for n in exe.codec.leaves}
        scales = {n: torch.ones((cs, F // hd), dtype=torch.float32,
                                device=device) for n in exe.codec.leaves}
        profiled("insert", lambda: exe.codec.insert(cache, cs, blocks))
        profiled("scatter", lambda: exe.codec.scatter(cache, pos, blocks))
        profiled("scatter_quant", lambda: exe.codec.scatter_quant(
            cache, pos, codes, scales))
        profiled("setpos", lambda: exe.set_pos(cache, 5))
    with LLMService(model, params, LLMSConfig(
            paged_pool=True, pool_pages_16=8, pool_pages_8=8,
            swap_dir=tempfile.mkdtemp(dir=swap_root), **kw),
            device=device) as svc:
        exe, pool = svc.exe, svc.res.pool
        host = {n: (np.zeros((cs, F), np.int8),
                    np.ones((cs, F // hd), np.float32))
                for n in exe.codec.leaves}
        rows = exe.read16(pool.arenas, 1)
        profiled("admit16", lambda: exe.admit16(pool.arenas, 1, rows))
        profiled("admit8", lambda: exe.admit8(
            pool.arenas, 1, {n: c for n, (c, _) in host.items()},
            {n: s for n, (_, s) in host.items()}))
        profiled("read16", lambda: exe.read16(pool.arenas, 1))
        profiled("zero16", lambda: exe.zero16(pool.arenas, 1))
    log(f"[eager] the reference's jitted entries the port runs eagerly, "
        f"one call each under the profiler (kernels, device ms, wall ms): "
        f"{json.dumps(out)}")
    gc.collect()
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------- #
# 3d. the MLA + MoE family: deepseek-v2-lite-16b at full width
# --------------------------------------------------------------------- #
def _raw_chunk_bytes(model, cs=16):
    """One raw (bf16) chunk of ``model``'s cache: ``cs`` tokens of every
    sequence leaf in every layer (llama2-7b: 8 MiB; deepseek-v2-lite's
    576-value latent: 0.47 MiB)."""
    import numpy as np
    spec = model.kv_spec()
    per_token = sum(int(np.prod(spec.leaf_dims[n])) for n in spec.seq_leaves)
    return cs * model.cfg.n_layers * per_token * 2


def _logged_replay(model, params, args, name, seed, hooks_kw,
                   prepare=None, record_extra=None):
    """``launch.serve.serve`` of ``args`` over ``model`` replaying the
    serve phase's trace (4 contexts x 3 rounds, prompts 32-64, 8 new)
    inline, logged by ``_SlotHooks(**hooks_kw)`` call by call (each
    record with its trace context, cid, cancel flag and, with
    ``record_extra(context)``, more keys; its ``switch_s`` and wall from
    the router).  ``prepare(svc, run)`` runs first in the replay's
    ``on_start``.  The kernel launch counts are zeroed just before the
    replay and read just after.  -> (serve's stats, the run: launches,
    run_s, stats, paged, ...; the hooks, taken off)."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import serve
    from repro_torch.trace.synth import TraceEvent
    on_card = model.device.type == "cuda"
    trace = _trace(model.cfg.vocab, seed)
    events = [TraceEvent(time=float(i), ctx_id=c,
                         prompt=np.asarray(p, np.int32),
                         ground_truth=np.zeros(0, np.int32), dataset="smoke",
                         max_new=n) for i, (c, p, n) in enumerate(trace)]
    run = {"trace": trace}

    def on_start(svc, router):
        if prepare is not None:
            prepare(svc, run)
        hooks = run["hooks"] = _SlotHooks(svc, name, on_card, **hooks_kw)
        begin = svc.begin_call

        def begun(stub, request):
            hooks.begin()
            return begin(stub, request)

        def done(job, cancelled):
            cid = job["stub"].ctx_id
            ctx = svc.contexts[cid]
            hooks.record(ctx, job["stream"].tokens,
                         ctx=trace[len(hooks.records)][0], cid=cid,
                         cancelled=bool(cancelled),
                         **(record_extra(ctx) if record_extra else {}))

        svc.begin_call, router.on_complete = begun, done
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        _zero_launches()
        run["t0"] = time.perf_counter()

    def on_end(svc, router, events):
        if on_card:
            torch.cuda.synchronize()
        run["run_s"] = time.perf_counter() - run["t0"]
        run["launches"] = _read_launches()
        run["paged"] = svc.paged
        run["stats"] = svc.stats()
        run["peak_bytes"] = _peak_memory() if on_card else None
        run["graphs"] = graph_check(svc.exe, None, name.strip("[]"))
        run["hooks"].close()
        for rec, c in zip(run["hooks"].records, router.call_records):
            rec["switch_s"], rec["wall_s"] = c["switch_s"], c["service_s"]

    stats = serve(model, params, args, threaded=False, on_start=on_start,
                  on_end=on_end, verbose=False, events=events)
    return stats, run, run.pop("hooks")


def family_phase(model, params, seed, swap_root, label, fam=MLA,
                 policy="llms", quant_resident=False, profile=None,
                 budget_chunks=None, profiled=False):
    """A slot-only family (``fam``: MLA, deepseek-v2-lite-16b, or MOE,
    llama4-maverick at depth 2) through the normal entry point: the
    port's ``launch.serve.serve`` replays the serve phase's trace (4
    contexts x 3 rounds, prompts 32-64, 8 new, ``decode_batch`` 1,
    ``max_ctx_len`` 256) through an inline ``ServiceRouter`` (one app)
    over ``LLMService``, which serves the family on slot caches (its
    KVSpec declares no paged pool).  Where the policy pipelines restores
    ``serve`` measures the card's §3.3.i profile (MLA; MoE declares no
    restore recompute and gets none); a given ``profile`` (a rerun)
    replaces it just before the replay.  The kernel launch counts are
    zeroed just before the replay and read just after; every recompute
    (extend and restore) must launch ``attn_density`` once a layer.
    The calls are logged by ``_SlotHooks``, as in the slot phase: every
    greedy pick keeps its logits row (on the CPU), and the run's own
    attn_density and decode_mqattn calls, one of each shape, are held
    against the plain versions.  With ``profiled``, one decode token and
    one recompute of the fifth call or later run under the profiler."""
    import torch
    from repro_torch.launch.serve import parse_args

    cfg, device = model.cfg, model.device
    on_card = device.type == "cuda"
    name = f"[{fam['tag']}:{label}]"
    if budget_chunks is None:
        budget_chunks = fam["budget_chunks"]
    raw = _raw_chunk_bytes(model)
    args = parse_args([
        "--arch", cfg.name, "--policy", policy,
        "--max-ctx", str(fam["max_ctx"]),
        "--budget-mib", repr(budget_chunks * raw / 2**20),
        "--max-new", "8", "--seed", str(seed), "--concurrency", "1",
        "--decode-batch", "1", "--swap-dir", tempfile.mkdtemp(dir=swap_root)]
        + (["--quant-resident"] if quant_resident else []))

    def prepare(svc, run):
        res = svc.res
        if profile is not None:
            for k, v in profile.items():
                setattr(res.profile, k, v)
            res.profiled = True
        run["profile"] = (dataclasses.asdict(res.profile) if res.profiled
                          else None)
        run["chunked"] = svc.cfg.chunked

    stats, run, hooks = _logged_replay(
        model, params, args, name, seed,
        dict(top=8, profile_from=4,
             profile=("decode token", "recompute") if profiled else ()),
        prepare)
    launches, records, trace = run["launches"], hooks.records, run["trace"]
    for i, r in enumerate(records):
        log(f"{name} call {i:2d} ctx {r['ctx']} prompt {len(trace[i][1])} -> "
            f"{len(r['tokens'])} tokens | switch {r['switch_s'] * 1e3:.3f} "
            f"ms | read {r['restored_bytes']} B | split (recompute, io) "
            f"{r['split']} | whole {r['whole'] or '-'} | wall "
            f"{r['wall_s'] * 1e3:.1f} ms | bits {r['bits']}"
            f"{' | quant ' + str(r['quant']) if quant_resident else ''}")
    walls = sorted(r["wall_s"] * 1e3 for r in records)
    log(f"{name} {cfg.name} policy {policy}, quant_resident "
        f"{quant_resident}, budget {budget_chunks} raw chunks of "
        f"{raw / 2**20:.3f} MiB: per-call wall median "
        f"{walls[len(walls) // 2]:.1f} ms (max {walls[-1]:.1f})")
    disk, splits, _, checked = hooks.summary(launches, run["run_s"],
                                             run["profile"])
    log(f"{name} stats {json.dumps(run['stats'], default=str)}")

    if stats["failed_calls"] or len(records) != len(trace) or any(
            r["cancelled"] for r in records):
        raise AssertionError(f"{name} a call did not complete")
    # under quant_resident every 8-bit chunk is kept on the decode grid
    # (per (token, layer) or (token, kv-head) scales, plain PyTorch as in
    # the reference), so the storage codec may have no work there
    _slot_gates(name, hooks, launches, on_card,
                budget_chunks == fam["budget_chunks"],
                run["chunked"] and not quant_resident)
    cid_of = {}
    for r in records:
        cid_of.setdefault(r["ctx"], r["cid"])
    if len(set(cid_of.values())) != 4 or any(
            cid_of[r["ctx"]] != r["cid"] for r in records):
        raise AssertionError(f"{name} the calls did not run in trace order")
    if run["paged"]:
        raise AssertionError(f"{name} the family ran on the paged pool")
    if any(b < fam["min_bits"] for r in records for b in r["bits"]):
        raise AssertionError(f"{name} a chunk went below the family's "
                             f"{fam['min_bits']}-bit floor")
    if not model.kv_spec().recomputable and any(re for re, _ in splits):
        raise AssertionError(f"{name} a restore recomputed chunks of a "
                             "family that declares no restore recompute")
    if on_card and launches["attn_density"] != \
            cfg.n_layers * hooks.n_recompute:
        raise AssertionError(f"{name} {launches['attn_density']} "
                             f"attn_density launches for "
                             f"{hooks.n_recompute} recomputes of "
                             f"{cfg.n_layers} layers")
    # the dense decode over the mixed slot cache runs decode_mqattn; MLA's
    # absorbed decode is einsums, as in the reference
    mq_expected = quant_resident and fam["mixed_decode_kernel"]
    if on_card and (bool(launches["decode_mqattn"]) != mq_expected or (
            mq_expected and not hooks.kernels.ran("decode_mqattn"))):
        raise AssertionError(f"{name} decode_mqattn launches "
                             f"{launches['decode_mqattn']}, expected "
                             f"{'some' if mq_expected else 'none'}")
    if quant_resident and budget_chunks == fam["budget_chunks"] and not any(
            q for r in records for q in r["quant"]):
        raise AssertionError(f"{name} no chunk stayed quant-resident")
    if profiled and on_card and len(hooks.prof) != 2:
        raise AssertionError(f"{name} profiled {sorted(hooks.prof)}, not a "
                             "decode token and a recompute")
    out = {"records": records, "launches": launches, "stats": run["stats"],
           "run_s": run["run_s"], "profile": run["profile"],
           "picks": hooks.picks, "prof": hooks.prof, "disk_switch_ms": disk,
           "splits": splits, "n_recompute": hooks.n_recompute,
           "wall_ms": walls, "attn_checked": checked,
           "graphs": run["graphs"], "peak_bytes": run["peak_bytes"]}
    del hooks
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return out


def _family_runs(fam, model, params, swap_root):
    """The slot-only family's runs on one set of weights: a no-pressure
    ``llms`` run, ``llms`` (under the card's profile where the family
    pipelines restores; a decode token and a recompute profiled) and a
    rerun under that same profile, ``llms`` + ``quant_resident`` (the
    mixed layout), ``swap`` and ``lmk``; each run's tokens against the
    no-pressure run's.  -> the runs by label."""
    tag = f"[{fam['tag']}]"
    runs = {"no-pressure": family_phase(model, params, SEED, swap_root,
                                        "no-pressure", fam,
                                        budget_chunks=1 << 20)}
    runs["llms"] = family_phase(model, params, SEED, swap_root, "llms", fam,
                                profiled=True)
    runs["llms-rerun"] = family_phase(model, params, SEED, swap_root,
                                      "llms-rerun", fam,
                                      profile=runs["llms"]["profile"])
    runs["quant"] = family_phase(model, params, SEED, swap_root, "quant",
                                 fam, quant_resident=True)
    for policy in ("swap", "lmk"):
        runs[policy] = family_phase(model, params, SEED, swap_root, policy,
                                    fam, policy=policy)
    _same_slot_run(runs["llms"], runs["llms-rerun"],
                   f"{fam['arch']} llms (the card's profile, if any)")
    for label, run in runs.items():
        if label == "no-pressure":
            continue
        counts, examined = _slot_divergence(run, runs["no-pressure"])
        log(f"{tag} {label} against the no-pressure run, call by call: "
            f"{counts}")
        for e in examined:
            log(f"{tag} {label} first divergence: {json.dumps(e)}")
    for label, run in runs.items():
        run.pop("picks")
        d = run["disk_switch_ms"]
        log(f"{tag} {label}: wall {run['run_s']:.2f} s for 12 calls; "
            f"switch_s over {len(d)} disk restores median "
            f"{d[len(d) // 2] if d else None} ms, max "
            f"{d[-1] if d else None} ms; splits (recomputed, read) "
            f"{[(len(a), len(b)) for a, b in run['splits']]}; launches "
            f"{run['launches']}")
    return runs


def mla_runs(swap_root):
    """deepseek-v2-lite-16b at full width (27 layers, d 2048, 16 heads,
    rank 512 + rope 64, 64 experts top-6 + 2 shared, vocab 102,400;
    random bf16 weights from SEED drawn on the card) through
    ``_family_runs``.  -> (the runs by label, (model, params)): the zoo
    phase serves the same weights."""
    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    model, params = build_weights(get_config(MLA["arch"]), SEED)
    runs = _family_runs(MLA, model, params, swap_root)
    log(f"[mla] the MLA phases took {time.perf_counter() - t0:.1f} s")
    return runs, (model, params)


# --------------------------------------------------------------------- #
# 3e. the RWKV6 family: rwkv6-1.6b at full width
# --------------------------------------------------------------------- #
def _snapshot_bytes(model):
    """One whole-state snapshot of ``model``'s context: every fp32 state
    leaf exact, every 16-bit leaf as fp16 (rwkv6-1.6b: 12,779,520 B)."""
    import torch
    cache = model.init_cache(1, 0)
    return sum(cache[n].numel() * (4 if cache[n].dtype == torch.float32
                                   else 2)
               for n in model.kv_spec().state_leaves)


def rwkv_phase(model, params, seed, swap_root, label, policy="llms",
               budget_snapshots=RWKV["budget_snapshots"]):
    """rwkv6-1.6b through the normal entry point: ``launch.serve.serve``
    replays the serve phase's trace (4 contexts x 3 rounds, prompts
    32-64, 8 new, ``decode_batch`` 1) through an inline ``ServiceRouter``
    over ``LLMService``, which serves the family on slot caches and
    moves each context's state as one whole-state snapshot (wkv fp32,
    tm / cm fp16) under every policy, at a budget of
    ``budget_snapshots`` snapshots.  The kernel launch counts are zeroed
    just before the replay and read just after: no kernel of the port
    may run (the family is attention-free).  The calls are logged by
    ``_SlotHooks``: whole-state restores (resident, read, recompute) and
    every greedy pick's logits row.  -> the run."""
    import torch
    from repro_torch.launch.serve import parse_args

    cfg, device = model.cfg, model.device
    on_card = device.type == "cuda"
    name = f"[rwkv:{label}]"
    snap = _snapshot_bytes(model)
    args = parse_args([
        "--arch", cfg.name, "--policy", policy,
        "--max-ctx", str(RWKV["max_ctx"]),
        "--budget-mib", repr(budget_snapshots * snap / 2**20),
        "--max-new", "8", "--seed", str(seed), "--concurrency", "1",
        "--decode-batch", "1", "--swap-dir", tempfile.mkdtemp(dir=swap_root)])

    def prepare(svc, run):
        run["codec"] = type(svc.exe.codec).__name__

    def snapshot(ctx):
        return {"snapshot": {k: str(v.dtype)
                             for k, v in (ctx.whole or {}).items()}}

    hooks_kw = (dict(top=8, profile_from=4, profile=("decode token",))
                if label == "llms" else {})
    stats, run, hooks = _logged_replay(model, params, args, name, seed,
                                       hooks_kw, prepare, snapshot)
    launches, records, trace = run["launches"], hooks.records, run["trace"]
    for i, r in enumerate(records):
        log(f"{name} call {i:2d} ctx {r['ctx']} prompt {len(trace[i][1])} -> "
            f"{len(r['tokens'])} tokens | switch {r['switch_s'] * 1e3:.3f} "
            f"ms | read {r['restored_bytes']} B | whole {r['whole'] or '-'} "
            f"| snapshot {r['snapshot'] or '-'} | wall "
            f"{r['wall_s'] * 1e3:.1f} ms | graphs captured at first use "
            f"{r['late_captures']}")
    walls = sorted(r["wall_s"] * 1e3 for r in records)
    warm = sorted(r["wall_s"] * 1e3 for r in records
                  if not r["late_captures"])
    log(f"{name} {cfg.name} policy {policy}, {run['codec']}, budget "
        f"{budget_snapshots} snapshots of {snap} B: per-call wall median "
        f"{walls[len(walls) // 2]:.1f} ms (max {walls[-1]:.1f}); the "
        f"{len(warm)} calls that captured no graph: median "
        f"{warm[len(warm) // 2] if warm else None} ms; "
        f"{len(walls) - len(warm)} calls with a capture at a new length: "
        f"{sorted(set(walls) - set(warm))} ms")
    disk, _, _, _ = hooks.summary(launches, run["run_s"], None)
    log(f"{name} stats {json.dumps(run['stats'], default=str)}")

    if stats["failed_calls"] or len(records) != len(trace) or any(
            r["cancelled"] or len(r["tokens"]) != 8 for r in records):
        raise AssertionError(f"{name} a call did not complete")
    if run["paged"] or run["codec"] != "WholeStateCodec":
        raise AssertionError(f"{name} served on the pool or by chunks")
    if any(launches.values()):
        raise AssertionError(f"{name} a kernel of the port ran: {launches}")
    if any(r["bits"] for r in records):
        raise AssertionError(f"{name} a context was chunked")
    snaps = [r["snapshot"] for r in records if r["snapshot"]]
    if not snaps or any(s != {"wkv": "float32", "tm": "float16",
                              "cm": "float16"} for s in snaps):
        raise AssertionError(f"{name} a snapshot went below 16 bits or "
                             f"lost its fp32 state: {snaps}")
    n_disk = sum(r["disk_restore"] for r in records)
    if budget_snapshots == RWKV["budget_snapshots"] and n_disk < 2:
        raise AssertionError(f"{name} {n_disk} restores from disk (or, "
                             "under lmk, recomputes), not >= 2")
    out = {"records": records, "launches": launches, "stats": run["stats"],
           "run_s": run["run_s"], "picks": hooks.picks,
           "disk_switch_ms": disk, "n_disk": n_disk, "wall_ms": walls,
           "prof": hooks.prof, "graphs": run["graphs"],
           "peak_bytes": run["peak_bytes"]}
    del hooks
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return out


def _rwkv_profiles(model, params):
    """One decode token and one 64-token recompute of rwkv6-1.6b under
    the profiler (after a warm-up of each), and the matmuls' device time
    of the token against the bytes floor: every layer weight and the
    head read once at the HBM rate (the embedding gives one row),
    logged."""
    import torch
    dev = model.device
    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    toks = torch.randint(1, model.cfg.vocab, (1, 64), generator=g,
                         device=dev)
    pos = torch.arange(64, device=dev)

    def recompute():
        return model.recompute(params, toks, pos, model.init_cache(1, 0), 64)

    cache = recompute()[0]
    cache["pos"] = torch.tensor(64, device=dev)
    tok = toks[:, :1]
    model.decode_step(params, tok, {k: v.clone() for k, v in cache.items()})
    _, rec = _profile_round(recompute, top=8)
    _, dec = _profile_round(lambda: model.decode_step(params, tok, cache),
                            top=8)
    weight_bytes = sum(w.numel() * w.element_size()
                       for w in _leaves(params["layers"])) \
        + params["head"].numel() * params["head"].element_size()
    floor_ms = weight_bytes / HBM_BYTES_PER_S * 1e3
    gemm_ms = dec["by_category_ms"].get("matmul", 0.0)
    log(f"[rwkv] one decode token under the profiler: {json.dumps(dec)}")
    log(f"[rwkv] one 64-token recompute under the profiler: "
        f"{json.dumps(rec)}")
    log(f"[rwkv] decode token: matmuls {gemm_ms:.3f} ms of device time "
        f"against the bytes floor {floor_ms:.3f} ms ({weight_bytes} B of "
        f"layer weights and head at {HBM_BYTES_PER_S:.3g} B/s); wall "
        f"{dec['wall_ms']:.1f} ms, idle share {dec['idle_share']:.3f}, "
        f"{dec['kernels']} kernels")


def rwkv_runs(swap_root, model, params):
    """rwkv6-1.6b (``model``, ``params``: at full width, 24 layers, d
    2048, 32 heads of 64, d_ff 7168, vocab 65,536, random weights from
    SEED drawn on the card): a no-pressure ``llms`` run, ``llms`` at two
    snapshots' budget and a rerun, ``swap`` and ``lmk``.  ``llms``, its rerun and ``swap`` must
    give the no-pressure tokens call for call (the fp32 wkv snapshot is
    exact); ``lmk``'s first divergence in each call must be a near-tie
    (its recompute runs the chunked-parallel form where the no-pressure
    run carried the state token by token).  Then one decode token and
    one 64-token recompute profiled (on the card).  -> the runs by
    label."""
    t0 = time.perf_counter()
    runs = {"no-pressure": rwkv_phase(model, params, SEED, swap_root,
                                      "no-pressure", budget_snapshots=64)}
    runs["llms"] = rwkv_phase(model, params, SEED, swap_root, "llms")
    runs["llms-rerun"] = rwkv_phase(model, params, SEED, swap_root,
                                    "llms-rerun")
    for policy in ("swap", "lmk"):
        runs[policy] = rwkv_phase(model, params, SEED, swap_root, policy,
                                  policy=policy)
    base = runs["no-pressure"]
    for label in ("llms", "llms-rerun", "swap"):
        for i, (x, y) in enumerate(zip(runs[label]["records"],
                                       base["records"])):
            if x["tokens"] != y["tokens"]:
                raise AssertionError(f"[rwkv] {label} differs from the "
                                     f"no-pressure run at call {i}: {x} "
                                     f"vs {y}")
        log(f"[rwkv] {label}: the no-pressure tokens over "
            f"{len(base['records'])} calls, {runs[label]['n_disk']} "
            "restores from disk")
    counts, examined = _slot_divergence(runs["lmk"], base)
    log(f"[rwkv] lmk against the no-pressure run, call by call: {counts}")
    for e in examined:
        log(f"[rwkv] lmk first divergence: {json.dumps(e)}")
    if counts["wide"] or counts["other_bit_plan"]:
        raise AssertionError(f"[rwkv] lmk diverged beyond a near-tie: "
                             f"{counts}")
    for label, run in runs.items():
        run.pop("picks")
        d = run["disk_switch_ms"]
        log(f"[rwkv] {label}: wall {run['run_s']:.2f} s for 12 calls; "
            f"switch_s over {len(d)} disk restores median "
            f"{d[len(d) // 2] if d else None} ms, max "
            f"{d[-1] if d else None} ms")
    if model.device.type == "cuda":
        _rwkv_profiles(model, params)
    log(f"[rwkv] the RWKV6 phases took {time.perf_counter() - t0:.1f} s")
    return runs


# --------------------------------------------------------------------- #
# 3f. the model zoo: dense + MLA + RWKV6 behind one router
# --------------------------------------------------------------------- #
class _ZooHooks:
    """Hooks on one ``ZooService`` for a run: per member, each call's
    switch-in (its ``switch_s`` and the bytes it read from disk); every
    key a member's reclaim routed to its owner (``route_evict``); the
    zoo's ``mem_used`` after every call; and the kernel calls that
    ``kernels`` (``_KernelCalls``) keeps and checks.  ``close`` takes the
    hooks off."""

    def __init__(self, zoo, name):
        from repro_torch.core import restore
        self.name, self.zoo = name, zoo
        self.calls = {fam: [] for fam in zoo.members}
        self.routed, self.mem = [], []
        self._undo = []
        for fam, svc in zoo.members.items():
            begin, finish = svc.begin_call, svc.finish_call
            route = svc.res.route_evict

            def begun(stub, request, _begin=begin, _fam=fam):
                read0 = restore.io_counters()["read"]
                st = _begin(stub, request)
                self.calls[_fam].append(
                    {"switch_s": st.t_switch,
                     "read": restore.io_counters()["read"] - read0})
                return st

            def finished(st, _finish=finish):
                out = _finish(st)
                self.mem.append(zoo.mem.used)
                return out

            def routed(key, _route=route, _fam=fam):
                owner = zoo._owner_fam.get(int(key[0]))
                self.routed.append((_fam, owner, tuple(map(int, key))))
                return _route(key)

            svc.begin_call, svc.finish_call = begun, finished
            svc.res.route_evict = routed
            self._undo += [(svc, "begin_call", begin),
                           (svc, "finish_call", finish),
                           (svc.res, "route_evict", route)]
        self.kernels = _KernelCalls(name)

    def close(self):
        for obj, attr, fn in self._undo:
            setattr(obj, attr, fn)
        self._undo = []
        self.kernels.close()


def zoo_phase(spec, members, events, vocab, label, fams=None,
              force_dequant=False):
    """One ``mixed_zoo`` run at full width: the port's
    ``build_zoo_service`` over ``members`` (family -> (model, params);
    ``fams`` of them, all by default) on the card, one all-I/O restore
    profile injected into every member, ``run_scenario`` on ``events``;
    its swap directory is removed after the run.
    The kernel launch counts are zeroed just before the run and read
    just after; ``_ZooHooks`` logs switch-ins, routed evictions, memory
    and the kernels' calls, which are held against the plain versions
    after the run.  -> the run."""
    import shutil
    import torch
    from repro_torch.loadgen import build_zoo_service, run_scenario
    name = f"[zoo:{label}]"
    fams = list(fams or members)
    device = members[fams[0]][0].device
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    zoo = build_zoo_service(spec, {f: members[f] for f in fams},
                            device=device)
    hooks = _ZooHooks(zoo, name)
    with zoo:
        for svc in zoo.members.values():
            for k, v in ZOO["profile"].items():
                setattr(svc.res.profile, k, v)
            svc.res.profiled = True
            svc.res.force_dequant = force_dequant
        _zero_launches()
        t0 = time.perf_counter()
        rep = run_scenario(spec, zoo, vocab, events=events)
        if device.type == "cuda":
            torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = _read_launches()
        stats = zoo.stats()
        peak = _peak_memory() if device.type == "cuda" else None
        graphs = {fam: graph_check(svc.exe, None, f"zoo:{label}:{fam}")
                  for fam, svc in zoo.members.items()}
    hooks.close()
    shutil.rmtree(zoo.store.root, ignore_errors=True)
    checked = hooks.kernels.check()
    per_fam = {}
    for fam, calls in hooks.calls.items():
        disk = sorted(c["switch_s"] * 1e3 for c in calls if c["read"])
        per_fam[fam] = {
            "calls": len(calls), "disk_restores": len(disk),
            "switch_ms_median": (sorted(c["switch_s"] * 1e3 for c in calls)
                                 [len(calls) // 2] if calls else None),
            "disk_switch_ms_median": disk[len(disk) // 2] if disk else None,
            "disk_switch_ms_max": disk[-1] if disk else None,
            "bytes_read": sum(c["read"] for c in calls)}
    crossing = [r for r in hooks.routed if r[1] is not None and r[0] != r[1]]
    log(f"{name} families {fams}, force_dequant {force_dequant}: wall "
        f"{run_s:.2f} s, {stats['total_calls']} calls; kernel launches "
        f"{launches}; per family {json.dumps(per_fam)}; {len(crossing)} "
        f"evictions routed across families "
        f"{sorted(set((a, b) for a, b, _ in crossing))}; mem_used max "
        f"{max(hooks.mem) if hooks.mem else 0} B of {spec.memory_budget}")
    log(f"{name} its own kernel calls against the plain versions (kind, "
        f"q shape, k shape, settings, |d out| / range, |d density or "
        f"mass|): {checked}")
    log(f"{name} tokens by app {rep['tokens_sha_by_app']}")
    if launches["decode_qattn"]:
        raise AssertionError(f"{name} decode_qattn ran: {launches}")
    if max(hooks.mem or [0]) > spec.memory_budget:
        raise AssertionError(f"{name} mem_used {max(hooks.mem)} over the "
                             f"budget {spec.memory_budget}")
    if fams == ["rwkv6"] and any(launches.values()):
        raise AssertionError(f"{name} a kernel ran for RWKV6: {launches}")
    return {"rep": rep, "stats": stats, "launches": launches,
            "run_s": run_s, "per_family": per_fam, "crossing": crossing,
            "checked": checked, "graphs": graphs, "peak_bytes": peak}


def zoo_runs(members):
    """The ``mixed_zoo`` scenario at full width: dense llama2-7b, MLA +
    MoE deepseek-v2-lite-16b and RWKV6 rwkv6-1.6b (``members``: family ->
    (model, params)) behind one router, one byte budget (ZOO) and one
    swap tier, the spec otherwise as it stands (seed 91, 9 contexts, 18
    calls, sweep, prompts 4-8, 3 new tokens, decode_batch 2,
    slice_steps 8, quant_resident, slot caches, max_ctx_len 64).  Runs,
    as the reference's benchmark does: mixed twice (equal
    deterministic views), each family solo on its app's share of the
    same bound events (equal tokens), and the MLA quant-resident A/B
    (token-identical to force_dequant; resident bytes below the 16-bit
    llms_nocomp run's).  Gates: every family serves its 6 calls and
    restores from disk at least once, at least one eviction crosses
    families, the budget holds, the mixed runs launch the codec,
    attn_density and decode_mqattn and never decode_qattn, each kept
    kernel call agrees with its plain version.  On the CPU (a rehearsal
    with the reduced models and ZOO's budget cut to match) no kernel
    runs, and the launch gates are left out.  -> the runs by label."""
    from repro_torch.loadgen import (bind_apps_by_ctx, get_scenario,
                                     make_events)
    from repro_torch.loadgen.metrics import deterministic_view
    t0 = time.perf_counter()
    spec = get_scenario("mixed_zoo").override(
        memory_budget=int(ZOO["budget_mib"] * 2**20))
    on_card = next(iter(members.values()))[0].device.type == "cuda"
    vocab = min(m.cfg.vocab for m, _ in members.values())
    events = bind_apps_by_ctx(make_events(spec, vocab), spec)
    fam_by_app = {a["name"]: a["family"] for a in spec.apps}
    runs = {"mixed": zoo_phase(spec, members, events, vocab, "mixed"),
            "mixed-rerun": zoo_phase(spec, members, events, vocab,
                                     "mixed-rerun")}
    a, b = runs["mixed"], runs["mixed-rerun"]
    if deterministic_view(a["rep"]) != deterministic_view(b["rep"]):
        raise AssertionError("[zoo] the rerun's deterministic view differs")
    served = {f: s["total_calls"] for f, s in a["stats"]["families"].items()}
    if served != {"dense": 6, "mla_moe": 6, "rwkv6": 6}:
        raise AssertionError(f"[zoo] families served {served}")
    for label in ("mixed", "mixed-rerun"):
        run = runs[label]
        if not run["crossing"]:
            raise AssertionError(f"[zoo] {label}: no eviction crossed "
                                 "families")
        missing = [f for f, p in run["per_family"].items()
                   if not p["disk_restores"]]
        if missing:
            raise AssertionError(f"[zoo] {label}: no disk restore for "
                                 f"{missing}")
        gone = [k for k in ("quantize", "dequantize", "attn_density",
                            "decode_mqattn") if not run["launches"][k]]
        if on_card and gone:
            raise AssertionError(f"[zoo] {label}: {gone} never launched")
    log(f"[zoo] mixed_zoo twice: equal deterministic views; families "
        f"served {served}")
    solo = {}
    for app, fam in fam_by_app.items():
        sub = [ev for ev in events if ev.app == app]
        solo[app] = zoo_phase(spec, members, sub, vocab, f"solo-{fam}",
                              fams=[fam])
        same = (solo[app]["rep"]["tokens_sha_by_app"][app]
                == a["rep"]["tokens_sha_by_app"][app])
        log(f"[zoo] {fam} solo against mixed: tokens identical {same}")
        if not same:
            raise AssertionError(f"[zoo] {fam}: solo tokens differ from "
                                 "the mixed run's")
        runs[f"solo-{fam}"] = solo[app]
    mla_app = next(app for app, f in fam_by_app.items() if f == "mla_moe")
    sub = [ev for ev in events if ev.app == mla_app]
    q = solo[mla_app]
    d = zoo_phase(spec, members, sub, vocab, "mla-dequant",
                  fams=["mla_moe"], force_dequant=True)
    bf = zoo_phase(spec.override(policy="llms_nocomp", quant_resident=False),
                   members, sub, vocab, "mla-bf16", fams=["mla_moe"])
    rb_q = q["stats"]["families"]["mla_moe"]["resident_bytes"]
    rb_bf = bf["stats"]["families"]["mla_moe"]["resident_bytes"]
    same = (q["rep"]["tokens_sha_by_app"][mla_app]
            == d["rep"]["tokens_sha_by_app"][mla_app])
    log(f"[zoo] MLA quant-resident A/B: tokens identical to force_dequant "
        f"{same}; resident bytes {rb_q} (quant) against {rb_bf} (16-bit "
        f"llms_nocomp)")
    if not same or not rb_q < rb_bf:
        raise AssertionError("[zoo] the MLA quant-resident A/B failed")
    runs["mla-dequant"], runs["mla-bf16"] = d, bf
    for label, run in runs.items():
        log(f"[zoo] {label}: wall {run['run_s']:.2f} s; switch_s by family "
            + json.dumps({f: (p["switch_ms_median"],
                              p["disk_switch_ms_median"],
                              p["disk_switch_ms_max"])
                          for f, p in run["per_family"].items()})
            + " (median, disk median, disk max; ms)")
    log(f"[zoo] the zoo phases took {time.perf_counter() - t0:.1f} s")
    return runs


# --------------------------------------------------------------------- #
# 3g. the full-sequence prefill of the dense model through attn_density
# --------------------------------------------------------------------- #
def _sdpa_causal(q, k, v):
    """scaled_dot_product_attention(is_causal=True) over (B, S, H, D) /
    (B, S, KV, D) bf16 inputs, K/V heads shared (``enable_gqa``).  -> the
    call (out only: no density)."""
    import torch.nn.functional as F
    q4, k4, v4 = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    return lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True, enable_gqa=k4.shape[1] != q4.shape[1])


def _ad_shape_row(tag, label, args, window, want, form, lib, iters,
                  flush=None):
    """attn_density over ``args`` (queries at arange(S) over S keys,
    seq_len S) under ``window``: against its plain version (out within
    MQ_OUT_TOL of its range, the density within AD_DENS_TOL of its
    range; the kernel's route picks it: ``attn_flash_plain`` for
    csrc/attn_flash.cu, else ``attn_density_plain``) and its rerun
    (bit-identical), then timed on the device and per call beside its
    plain version, its bound and the library call ``lib`` (out only);
    with ``flush`` (``_l2_flush()``) also with a cold L2.  A library
    reading below the bound lost kernels (the profiler's window missed
    some): read its call time then.  -> the row."""
    import torch
    from repro_torch.kernels import attn_density as kad
    from repro_torch.kernels import ref
    S = args[0].shape[1]
    route = kad.route(form, args[0].shape[-1], args[2].shape[-1])
    o_k, d_k = kad.attn_density(*args, S, window, 0, want, form)
    o_2, d_2 = kad.attn_density(*args, S, window, 0, want, form)
    if route == "wgmma":
        plain = lambda: ref.attn_flash_plain(                 # noqa: E731
            *args, S, window, 0, want)
    else:
        plain = lambda: ref.attn_density_plain(               # noqa: E731
            *args, S, window, 0, want, form)
    o_r, d_r = plain()
    torch.cuda.synchronize()
    span = float(o_r.float().abs().max())
    d_o = float((o_k.float() - o_r.float()).abs().max())
    d_d = 0.0 if d_r is None else float(
        (d_k - d_r).abs().max() / d_r.abs().max())
    if not (torch.isfinite(o_k.float()).all() and d_o <= MQ_OUT_TOL * span
            and d_d <= AD_DENS_TOL):
        raise AssertionError(f"attn_density at {label}: |d out| {d_o} "
                             f"(range {span}), |d density| / range {d_d}")
    if not (torch.equal(o_2, o_k) and (d_k is None or torch.equal(d_2, d_k))):
        raise AssertionError(f"attn_density at {label}: reruns differ")
    del o_k, d_k, o_2, d_2, o_r, d_r
    fn = lambda: kad.attn_density(*args, S, window, 0, want,  # noqa: E731
                                  form)
    bound, by = _ad_bound_ms(args, S, window, 0, want)
    parts = {}
    row = {"shape": label, "form": form, "density": want, "route": route,
           "hdq": kad.head_plan(args[0].shape[-1], args[2].shape[-1])[0],
           "rows_a_block": (kad.FLASH_ROWS if route == "wgmma" else
                            kad.plan(1, S, args[0].shape[2],
                                     args[1].shape[2])[0]),
           "max_abs_err": d_o, "max_err_rel": d_o / span,
           "max_err_density_rel": d_d,
           "call_ms": _time_ms(fn, iters=iters),
           "device_ms_by_kernel": parts,
           "plain_call_ms": _time_ms(plain, iters=3, warmup=1),
           "plain_device_ms": _device_ms(plain, iters=3),
           "library_call_ms": _time_ms(lib, iters=iters),
           "library_device_ms": _device_ms(lib, iters=iters),
           "bound_ms": bound, "bound_by": by}
    row["device_ms"] = _device_ms_whole(fn, row["call_ms"], iters, parts)
    cold = ""
    if flush is not None:
        row["device_ms_by_kernel_l2_cold"] = {}
        row["device_ms_l2_cold"] = _device_ms(
            fn, AD_KERNELS, iters=iters,
            by_kernel=row["device_ms_by_kernel_l2_cold"], flush=flush)
        cold = f" (L2 cold {row['device_ms_l2_cold']})"
    row["library_device_below_bound"] = (
        row["library_device_ms"] is not None
        and row["library_device_ms"] < bound)
    lost = (" (BELOW the bound: kernels missed)"
            if row["library_device_below_bound"] else "")
    log(f"[{tag}] attn_density {label} ({route}, HDQ {row['hdq']}, "
        f"{row['rows_a_block']}-row tiles): |d out| {d_o:.3g} (range "
        f"{span:.3g}), |d density| / range {d_d:.3g}, rerun identical; "
        f"kernel {row['device_ms']} ms on the device{cold}, "
        f"{row['call_ms']:.4f} ms per call; plain {row['plain_device_ms']} "
        f"ms; library (out only) {row['library_device_ms']} ms on the "
        f"device{lost}, {row['library_call_ms']:.4f} ms per call; bound "
        f"{bound:.4f} ms ({by}); by launch {parts}")
    torch.cuda.empty_cache()
    return row


def _prefill_kernel_rows():
    """``_ad_shape_row`` at the prefill's shapes beside
    scaled_dot_product_attention(is_causal=True): llama2-7b's (H 32, hd
    128) causal 4096 tokens in the flash form with and without the
    density and 512 in the served form with it; the VLM's (H 64, KV 8)
    at 512 (served) and 4096 (flash).  -> {label: row}."""
    import torch
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 12)
    shapes = {"dense": (32, 32), "vlm": (64, 8)}
    rows = {}
    for fam, (H, KV) in shapes.items():
        for S in PREFILL["S"]:
            args = _ad_case(1, S, S, H, KV, 128, list(range(S)), g, dev)
            form = "served" if S <= 2048 else "flash"
            for want in ((True,) if S <= 2048 and fam == "dense"
                         else (False, True)):
                label = (f"{fam} (1,{S},{H},{KV},128) causal {form}"
                         f"{' + density' if want else ''}")
                rows[label] = _ad_shape_row(
                    "prefill", label, args, 0, want, form,
                    _sdpa_causal(*args[:3]), 20 if S <= 2048 else 5)
    return rows


def _new_family_kernel_rows():
    """``_ad_shape_row`` at the prefill shapes of recurrentgemma-2b and
    whisper-base (AD_NEW, under the family's window, out only and with
    the density) with a warm and a cold L2, beside
    scaled_dot_product_attention with the boolean mask of the same
    visibility.  -> {label: row}."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 19)
    flush = _l2_flush()
    rows = {}
    for fam, S, H, KV, hd, window, form in AD_NEW:
        args = _ad_case(1, S, S, H, KV, hd, list(range(S)), g, dev)
        mask = ref.extend_visibility(args[3].long(), S, S, window)
        q4, k4, v4 = (t.transpose(1, 2).contiguous() for t in args[:3])
        lib = lambda: F.scaled_dot_product_attention(          # noqa: E731
            q4, k4, v4, attn_mask=mask, enable_gqa=KV != H)
        for want in (False, True):
            label = (f"{fam} (1,{S},{H},{KV},{hd}) window {window} {form}"
                     f"{' + density' if want else ''}")
            rows[label] = _ad_shape_row("kernels", label, args, window,
                                        want, form, lib,
                                        20 if S <= 512 else 5, flush)
        del args, q4, k4, v4, mask, lib
    return rows


def _stats_check(args, seq_len, window, n_sinks, label):
    """attn_density's row-stats variant (flash form, no density: the
    forward of flash_attention) over ``args`` (q, k, v, q_pos) bounded by
    ``seq_len`` against its plain version: out within MQ_OUT_TOL of its
    range, m within STATS_TOL of max(1, max |m|) over the rows that see
    a key (a row that sees none has m = NEG_INF in both), l within
    STATS_TOL relative; a rerun bit-identical; and the variant's out
    against the no-stats flash kernel's.  -> {"out", "m", "l" errors,
    "out_equals_no_stats"}."""
    import torch
    from repro_torch.kernels import attn_density as kad
    from repro_torch.kernels import ref
    o_s, d_s, m_k, l_k = kad.attn_density(*args, seq_len, window, n_sinks,
                                          False, "flash", True)
    o_2, _, m_2, l_2 = kad.attn_density(*args, seq_len, window, n_sinks, False,
                                        "flash", True)
    o_n, _ = kad.attn_density(*args, seq_len, window, n_sinks, False, "flash")
    o_r, _, m_r, l_r = ref.attn_density_plain(*args, seq_len, window, n_sinks,
                                              False, "flash", True)
    torch.cuda.synchronize()
    span = float(o_r.float().abs().max())
    d_o = float((o_s.float() - o_r.float()).abs().max())
    seen = m_r > ref.NEG_INF / 2
    m_span = max(1.0, float(m_r[seen].abs().max()) if seen.any() else 1.0)
    d_m = float((m_k - m_r).abs().max()) / m_span
    d_l = float(((l_k - l_r).abs() / l_r).max())
    if d_s is not None or tuple(m_k.shape) != tuple(m_r.shape):
        raise AssertionError(f"attn_density stats at {label}: shapes")
    if not (torch.isfinite(o_s.float()).all() and d_o <= MQ_OUT_TOL * span
            and d_m <= STATS_TOL and d_l <= STATS_TOL):
        raise AssertionError(
            f"attn_density stats at {label}: |d out| {d_o} (range {span}), "
            f"|d m| / max(1, |m|) {d_m}, |d l| / l {d_l}")
    if not (torch.equal(o_2, o_s) and torch.equal(m_2, m_k)
            and torch.equal(l_2, l_k)):
        raise AssertionError(f"attn_density stats at {label}: reruns differ")
    same = torch.equal(o_n, o_s)
    log(f"[stats] attn_density + row stats {label}: |d out| {d_o:.3g} (range "
        f"{span:.3g}), |d m| / max(1, |m|) {d_m:.3g}, |d l| / l {d_l:.3g}, "
        f"rerun identical; out {'equals' if same else 'DIFFERS from'} the "
        f"no-stats flash kernel's bit for bit")
    return {"out": d_o / span, "m": d_m, "l": d_l,
            "out_equals_no_stats": same}


def stats_phase():
    """The row-stats variant against its plain version at STATS_SHAPES
    and at rows that see no key (queries past seq_len under a window),
    then timed at the first of them, smollm-360m's training shape
    (1,4096,15,5,64) causal:
    on the device and per call, beside its no-stats flash kernel, its
    plain version, its bound and scaled_dot_product_attention
    (is_causal=True, out only).  -> (worst errors, the timed row)."""
    import torch
    from repro_torch.kernels import attn_density as kad
    from repro_torch.kernels import ref
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 23)
    worst = {"out": 0.0, "m": 0.0, "l": 0.0, "out_equals_no_stats": True}
    timed_args = None
    for B, S, H, KV, dqk, dv, window, n_sinks in STATS_SHAPES:
        args = _ad_case(B, S, S, H, KV, dqk, list(range(S)), g, dev, dv=dv)
        label = (f"({B},{S},{H},{KV},{dqk}/{dv}) window {window} sinks "
                 f"{n_sinks}, {kad.plan(B, S, H, KV)[0]}-row tiles")
        errs = _stats_check(args, S, window, n_sinks, label)
        for k in ("out", "m", "l"):
            worst[k] = max(worst[k], errs[k])
        worst["out_equals_no_stats"] &= errs["out_equals_no_stats"]
        if timed_args is None:          # the first: smollm-360m's shape
            timed_args = args
    # queries at 100.. over 50 keys under a window of 4: no row sees a key
    args = _ad_case(1, 20, 50, 4, 2, 16, list(range(100, 120)), g, dev)
    o_k, _, m_k, l_k = kad.attn_density(*args, 50, 4, 0, False, "flash",
                                        True)
    o_r, _, m_r, l_r = ref.attn_density_plain(*args, 50, 4, 0, False,
                                              "flash", True)
    if not (torch.equal(m_k, m_r) and torch.equal(l_k, l_r)
            and float((o_k.float() - o_r.float()).abs().max())
            <= MQ_OUT_TOL * float(o_r.float().abs().max())):
        raise AssertionError("attn_density stats at rows that see no key")
    log(f"[stats] rows that see no key: m = NEG_INF, l = "
        f"{float(l_k[0, 0, 0, 0])} (uniform over 50 keys) as the plain "
        f"version")
    return worst, _stats_row(timed_args)


def _flash_backward_times(args):
    """One ``flash_attention`` backward (``_flash_bwd``: plain fp32
    products in blocks of 1024 keys, what a training step runs once a
    layer) over ``args``' q, k, v (causal), per call from the host, beside
    scaled_dot_product_attention(is_causal=True)'s backward (its forward
    and backward less its forward) and the least time for the
    backward's work: 5 products of 2 hd FLOPs per causal (query-head,
    key) pair at the fp32 rate outside the tensor cores.  -> a dict."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.models import common as C
    q, k, v, _ = args
    B, S, H, hd = q.shape
    q_pos = torch.arange(S, device=q.device)
    out, _, m, l = ops.attn_density(q, k, v, q_pos, S, 0, 0, False,
                                    "flash", True)
    dout = torch.randn(out.shape, device=q.device).bfloat16()
    bwd = lambda: C._flash_bwd(q, k, v, out, m, l, dout, 0,  # noqa: E731
                               1024, 0, 0)
    q4, k4, v4 = (t.transpose(1, 2).contiguous().requires_grad_(True)
                  for t in (q, k, v))
    d4 = dout.transpose(1, 2).contiguous()
    fwd = lambda: F.scaled_dot_product_attention(            # noqa: E731
        q4, k4, v4, is_causal=True, enable_gqa=k4.shape[1] != q4.shape[1])
    fwd_bwd = lambda: torch.autograd.grad(  # noqa: E731
        fwd(), (q4, k4, v4), d4)
    pairs = B * H * S * (S + 1) // 2
    row = {"flash_backward_call_ms": _time_ms(bwd, iters=5, warmup=2),
           "flash_backward_bound_ms": 5 * 2 * hd * pairs / FP32_OPS_PER_S
           * 1e3,
           "library_backward_call_ms": _time_ms(fwd_bwd, iters=20)
           - _time_ms(fwd, iters=20)}
    log(f"[stats] flash_attention backward at ({B},{S},{H},"
        f"{k.shape[2]},{hd}): {row['flash_backward_call_ms']:.3f} ms a call "
        f"(bound {row['flash_backward_bound_ms']:.3f} ms, fp32 operations); "
        f"SDPA is_causal backward {row['library_backward_call_ms']:.3f} ms")
    return row


def _stats_row(args):
    """The timed row of the stats variant over ``args`` (causal flash)."""
    import torch
    from repro_torch.kernels import attn_density as kad
    from repro_torch.kernels import ref
    B, S, H, _ = args[0].shape
    KV = args[1].shape[2]
    fn = lambda: kad.attn_density(*args, S, 0, 0, False, "flash",  # noqa: E731
                                  True)
    no_stats = lambda: kad.attn_density(*args, S, 0, 0, False,    # noqa: E731
                                        "flash")
    plain = lambda: ref.attn_density_plain(                       # noqa: E731
        *args, S, 0, 0, False, "flash", True)
    lib = _sdpa_causal(*args[:3])
    bound, by = _ad_bound_ms(args, S, 0, 0, False, stats=True)
    label = f"({B},{S},{H},{KV},{args[0].shape[-1]}) causal flash + stats"
    row = {"shape": label, "form": "flash", "density": False, "stats": True,
           "call_ms": _time_ms(fn, iters=20),
           "route": kad.route("flash", args[0].shape[-1],
                              args[2].shape[-1]),
           "device_ms": _device_ms(fn, AD_KERNELS, iters=20),
           "no_stats_call_ms": _time_ms(no_stats, iters=20),
           "no_stats_device_ms": _device_ms(no_stats, AD_KERNELS, iters=20),
           "plain_call_ms": _time_ms(plain, iters=3, warmup=1),
           "plain_device_ms": _device_ms(plain, iters=3),
           "library_call_ms": _time_ms(lib, iters=20),
           "library_device_ms": _device_ms(lib, iters=20),
           "bound_ms": bound, "bound_by": by}
    row.update(_flash_backward_times(args))
    log(f"[stats] attn_density {label}: kernel {row['device_ms']} ms on the "
        f"device, {row['call_ms']:.4f} ms per call; without the stats "
        f"{row['no_stats_device_ms']} ms; plain {row['plain_device_ms']} "
        f"ms; SDPA is_causal (out only) {row['library_device_ms']} ms on "
        f"the device, {row['library_call_ms']:.4f} ms per call; bound "
        f"{bound:.4f} ms ({by})")
    torch.cuda.empty_cache()
    return row


def _extend_full(model, params, toks, form):
    """The port's extend of all of ``toks`` (``recompute`` at positions
    arange(S) over a fresh cache, with the density), its attention
    through ``attn_density`` in ``form``: "served" is the extend's own;
    "flash" the prefill's form beyond 2048 tokens.  -> (logits, cache,
    density)."""
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.models import common as C
    served = C.extend_attention
    if form == "flash":
        C.extend_attention = lambda *a: C.AttnOut(*kops.attn_density(
            *a, form="flash"))
    try:
        S = toks.shape[1]
        cache, x, dens = model.recompute(
            params, toks, torch.arange(S, device=toks.device),
            model.init_cache(1, S), S, want_density=True)
    finally:
        C.extend_attention = served
    return (x[:, -1] @ model.head_weight(params)).float(), cache, dens


def prefill_check(model, params):
    """The serve phase's llama2-7b at full width (random weights from
    SEED): ``prefill`` of 512 and 4096 random tokens with the density
    against the port's extend of the same tokens (``recompute`` over a
    fresh cache) through the same form of ``attn_density``, bit for bit
    (512: the served form, the extend's own; 4096: the flash form);
    one attn_density launch a layer, and the prefill's own calls held
    against the plain version (``_KernelCalls``).  At 4096 the extend in
    its own served form is compared too: the forms differ in rounding
    (the flash form keeps PV in fp32, the served one rounds p to bf16),
    layer 0's K/V must be equal, layer 1's within 1% relative L2 (one
    attention of the other rounding) and the density within 2%; the
    drift of every later layer and of the logits is reported.  Then
    ``_prefill_kernel_rows``.  -> {"runs": {S: ...}, "rows": {label:
    row}}."""
    import torch
    dev = model.device
    L, V = model.cfg.n_layers, model.cfg.vocab
    g = torch.Generator(device=dev).manual_seed(SEED + 13)
    runs = {}

    def rel(a, b):
        a, b = a.float(), b.float()
        return float((a - b).norm() / a.norm())

    for S in PREFILL["S"]:
        name = f"[prefill:{S}]"
        toks = torch.randint(1, V, (1, S), generator=g, device=dev)
        kc = _KernelCalls(name)
        _zero_launches()
        t0 = time.perf_counter()
        pf = model.prefill(params, {"tokens": toks}, want_density=True)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        launches = _read_launches()
        kc.close()
        if not all(torch.isfinite(t.float()).all() for t in (
                pf.logits, pf.cache["k"], pf.cache["v"], pf.density)):
            raise AssertionError(f"{name} non-finite prefill")
        form = "served" if S <= 2048 else "flash"
        logits, cache, dens = _extend_full(model, params, toks, form)
        same = (torch.equal(logits, pf.logits)
                and all(torch.equal(cache[n], pf.cache[n])
                        for n in ("k", "v"))
                and torch.equal(dens, pf.density))
        del cache, logits, dens
        drift = None
        if form == "flash":
            logits, cache, dens = _extend_full(model, params, toks, "served")
            drift = {"logits": rel(logits, pf.logits),
                     "density": rel(dens, pf.density),
                     "k_by_layer": [rel(cache["k"][l], pf.cache["k"][l])
                                    for l in range(L)],
                     "v_by_layer": [rel(cache["v"][l], pf.cache["v"][l])
                                    for l in range(L)],
                     "same_pick": int(logits.argmax()) == int(
                         pf.logits.argmax())}
            del cache, logits, dens
        del pf
        torch.cuda.empty_cache()
        checked = kc.check()
        if not same:
            raise AssertionError(f"{name} the prefill differs from the "
                                 f"extend through the same {form} form")
        if drift is not None and not (
                drift["k_by_layer"][0] == drift["v_by_layer"][0] == 0.0
                and max(drift["k_by_layer"][1], drift["v_by_layer"][1])
                <= 0.01 and drift["density"] <= 0.02):
            raise AssertionError(f"{name} flash against served form: "
                                 f"{drift}")
        flash = L if form == "flash" else 0
        if (launches["attn_density"], launches["attn_density_with_density"],
                launches["attn_flash"], launches["attn_flash_with_density"]
                ) != (L, L, flash, flash) or launches["decode_mqattn"] or \
                launches["quantize"]:
            raise AssertionError(f"{name} launches {launches}, not {L} "
                                 f"attn_density with the density ({flash} "
                                 f"through csrc/attn_flash.cu)")
        runs[S] = {"wall_ms": wall, "launches": launches, "form": form,
                   "drift_from_served": drift, "checked": checked}
        log(f"[prefill] llama2-7b prefill of {S} tokens (+ density, {form} "
            f"form) in {wall:.1f} ms, launches {launches}: bit for bit the "
            f"extend through the same form; its own attn_density calls "
            f"against the plain version: {checked}")
        if drift is not None:
            log(f"[prefill] {S} tokens, flash form against the extend's "
                f"served form, relative L2: logits {drift['logits']:.3e} "
                f"(same pick {drift['same_pick']}), density "
                f"{drift['density']:.3e}, K by layer "
                f"{[f'{r:.2e}' for r in drift['k_by_layer']]}")
    return {"runs": runs, "rows": _prefill_kernel_rows()}


# --------------------------------------------------------------------- #
# 3h. the families that no service takes: a prefill and greedy decode
# --------------------------------------------------------------------- #
def _cache_after_prefill(model, out, S, total):
    """A decode cache of ``total`` positions holding a prefill of S
    tokens: its sequence leaves (K/V) copied into the first S positions
    and its state leaves (image or audio K/V, recurrent state) taken as
    they are."""
    import torch
    spec = model.kv_spec()
    cache = model.init_cache(1, total)
    for n in spec.seq_leaves:
        cache[n][:, :, :S] = out.cache[n]
    for n in spec.state_leaves:
        cache[n] = out.cache[n]
    cache["pos"] = torch.tensor(S, device=model.device)
    return cache


def _greedy_runs(tag, model, params, prompt, batch_of, new, n_attn):
    """Twice, the second profiled (its prefill and one decode token,
    the first warms the card up): ``prefill`` of ``prompt`` (1, S) in
    ``batch_of(tokens)`` with the density, then ``new`` greedy
    ``decode_step``s over ``_cache_after_prefill``.  Launches are zeroed
    before the prefill and read after it and after the decode: n_attn
    attn_density launches with the density at the prefill, none in the
    decode; the prefill's attn_density calls are held against the plain
    version (``_KernelCalls``).  The rerun must give the same tokens and
    logits bit for bit.  Then a ``prefill`` of the prompt and the fed
    tokens must give the last decode logits within DECODE_VS_PREFILL
    relative L2 and the same greedy pick (or a near-tie: the prefill's
    top-2 gap within the largest difference); max |diff| and whether it
    is within the reduced models' rtol = atol = 5e-2
    (``tests/test_models.py``) are reported.  -> the rerun's record."""
    import torch
    dev, S = model.device, prompt.shape[1]

    def run(label, profiled):
        name = f"[{tag}:{label}]"
        prof, per_token = {}, []
        kc = _KernelCalls(name)
        _zero_launches()
        pf = lambda: model.prefill(                           # noqa: E731
            params, batch_of(prompt), want_density=True)
        t1 = time.perf_counter()
        if profiled:
            out, prof["prefill"] = _profile_round(pf, top=8)
        else:
            out = pf()
            torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t1) * 1e3
        at_prefill = _read_launches()
        kc.close()
        if not torch.isfinite(out.density).all():
            raise AssertionError(f"{name} non-finite density")
        cache = _cache_after_prefill(model, out, S, S + new)
        tok, fed, rows = out.logits.argmax(-1), [], []
        del out
        for i in range(new):
            fed.append(int(tok))
            step = lambda: model.decode_step(                 # noqa: E731
                params, tok.view(1, 1), cache)
            t1 = time.perf_counter()
            if profiled and i == new // 2:
                o, prof["decode token"] = _profile_round(step, top=8)
            else:
                o = step()
                torch.cuda.synchronize()
            per_token.append((time.perf_counter() - t1) * 1e3)
            cache = o.cache
            rows.append(o.logits.float().cpu())
            tok = o.logits.argmax(-1)
        launches = _read_launches()
        checked = kc.check()
        rec = {"fed": fed, "rows": torch.cat(rows), "prefill_ms": prefill_ms,
               "launches_prefill": at_prefill, "launches": launches,
               "per_token_ms": sorted(per_token), "prof": prof,
               "checked": checked}
        if not torch.isfinite(rec["rows"]).all():
            raise AssertionError(f"{name} non-finite logits")
        if (at_prefill["attn_density"],
                at_prefill["attn_density_with_density"]) != (n_attn, n_attn) \
                or launches != at_prefill:
            raise AssertionError(f"{name} launches {at_prefill} at the "
                                 f"prefill, {launches} after the decode: not "
                                 f"{n_attn} attn_density with the density, "
                                 "then none")
        log(f"{name} prefill of {S} tokens in {prefill_ms:.1f} ms; {new} "
            f"decode tokens, median {rec['per_token_ms'][new // 2]:.1f} ms; "
            f"tokens {fed}; launches {launches}; the prefill's attn_density "
            f"calls against the plain version: {checked}")
        for kind, p in prof.items():
            log(f"{name} one {kind} under the profiler: {json.dumps(p)}")
        return rec

    warm = run("run1", False)
    first = run("rerun", True)
    if warm["fed"] != first["fed"] or not torch.equal(warm["rows"],
                                                      first["rows"]):
        raise AssertionError(f"[{tag}] the same-seed rerun differs")
    # the decode fed fed[0..new-1] at positions S..S+new-1: the prefill of
    # prompt + fed predicts what the last decode step predicted
    full = torch.cat([prompt, torch.tensor([first["fed"]], device=dev)],
                     dim=1)
    pf = model.prefill(params, batch_of(full))
    last, ref = first["rows"][-1], pf.logits[0].float().cpu()
    del pf
    d, span = float((last - ref).abs().max()), float(ref.abs().max())
    rel = float((last - ref).norm() / ref.norm())
    within = bool(((last - ref).abs() <= 5e-2 + 5e-2 * ref.abs()).all())
    top2 = torch.topk(ref, 2).values
    gap = float(top2[0] - top2[1])
    log(f"[{tag}] the last decode logits against a prefill of the "
        f"{S + new} tokens: relative L2 {rel:.3e} (tolerance "
        f"{DECODE_VS_PREFILL}), max |diff| {d:.4g} (range {span:.4g}), "
        f"within the reduced model's rtol = atol = 5e-2: {within}; greedy "
        f"picks {int(last.argmax())} / {int(ref.argmax())} (the prefill's "
        f"top-2 gap {gap:.4g}); the rerun identical over {new} tokens")
    if not (rel <= DECODE_VS_PREFILL and (int(last.argmax()) == int(
            ref.argmax()) or gap <= d)):
        raise AssertionError(f"[{tag}] decode vs prefill: relative L2 {rel}, "
                             f"max |diff| {d}, range {span}, picks "
                             f"{int(last.argmax())} / {int(ref.argmax())}")
    first.update(decode_vs_prefill=(rel, d, span), rows=None)
    return first


def vlm_phase():
    """llama-3.2-vision-90b at full width (d 8192, 64 heads over 8, hd
    128, d_ff 28,672, vocab 128,256, 1601 image tokens of 7680) and the
    reference's reduced depth of 10 (random bf16 weights from SEED drawn
    on the card; the cross layers' tanh gates, zero in a fresh model,
    drawn from U(-1, 1) so that the cross layers count; random patches
    from the seed): ``_greedy_runs`` of a 512-token prompt with the
    patches, 32 greedy tokens, one attn_density launch a self layer.
    The decode-vs-prefill gap is bf16 level: each layer's chained
    products round at M = 1 to other ulps than at M = 544, some 0.2-0.5%
    a layer over ten layers of width 8192 (measured 2.1%; the reduced
    model's rtol = atol = 5e-2 is not met at full width: 0.17 over a
    range of 8.06).  -> the rerun's record."""
    import torch
    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    cfg = get_config(VLM["arch"]).with_overrides(n_layers=VLM["n_layers"])
    model, params = build_weights(cfg, SEED)
    dev = model.device
    n_self, n_cross, _ = model._counts()
    g = torch.Generator(device=dev).manual_seed(SEED + 11)
    for k in ("gate_attn", "gate_ffn"):
        params["cross_layers"][k] = torch.rand(n_cross, generator=g,
                                               device=dev) * 2 - 1
    vis = cfg.vision
    patches = torch.randn((1, vis.n_image_tokens, vis.d_vision),
                          generator=g, device=dev)
    prompt = torch.randint(1, cfg.vocab, (1, VLM["prompt"]), generator=g,
                           device=dev)
    first = _greedy_runs("vlm", model, params, prompt, lambda t: {
        "tokens": t, "patches": patches}, VLM["new"], n_self)
    first["phase_s"] = time.perf_counter() - t0
    del model, params, patches
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[vlm] the VLM phase took {first['phase_s']:.1f} s")
    return first


def encdec_phase():
    """whisper-base at full width and depth (6 + 6 layers, d 512, 8
    heads of 64, d_ff 2048, vocab 51,865; random bf16 weights from SEED
    drawn on the card, its fp32 biases zero as in a fresh model) over
    1500 random audio frames from the seed: ``_greedy_runs`` of a
    384-token prompt, 64 greedy tokens up to the decoder's 448-position
    cap, one attn_density launch (served form) a decoder layer; the
    encoder's and the cross attention in plain PyTorch, as the reference
    computes them.  -> the rerun's record."""
    import torch
    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    cfg = get_config(ENCDEC["arch"])
    model, params = build_weights(cfg, SEED)
    dev = model.device
    g = torch.Generator(device=dev).manual_seed(SEED + 20)
    frames = torch.randn((1, cfg.encoder.n_frames, cfg.d_model),
                         generator=g, device=dev)
    prompt = torch.randint(1, cfg.vocab, (1, ENCDEC["prompt"]), generator=g,
                           device=dev)
    if ENCDEC["prompt"] + ENCDEC["new"] != cfg.max_seq:
        raise AssertionError("[encdec] the run does not reach the "
                             f"{cfg.max_seq}-position cap")
    first = _greedy_runs("encdec", model, params, prompt, lambda t: {
        "tokens": t, "frames": frames}, ENCDEC["new"], cfg.n_layers)
    first["phase_s"] = time.perf_counter() - t0
    del model, params, frames
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[encdec] the whisper-base phase took {first['phase_s']:.1f} s")
    return first


def rglru_phase():
    """recurrentgemma-2b at full width and depth (26 layers: 18 RG-LRU
    and 8 local-attention layers, d 2560, 10 heads of 256 over one KV
    head, window 2048, d_ff 7680, vocab 256,000; random bf16 weights
    from SEED drawn on the card): ``_greedy_runs`` of a 512-token prompt
    (attn_density's served form under the window) and of a 4096-token
    one (the flash form, where the window bites), each 32 greedy tokens,
    one attn_density launch an attention layer.  -> {prompt length:
    the rerun's record}."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.rglru import _block_counts
    t0 = time.perf_counter()
    cfg = get_config(RGLRU["arch"])
    model, params = build_weights(cfg, SEED)
    n_attn = _block_counts(cfg)[1]
    g = torch.Generator(device=model.device).manual_seed(SEED + 21)
    runs = {}
    for S in RGLRU["prompts"]:
        prompt = torch.randint(1, cfg.vocab, (1, S), generator=g,
                               device=model.device)
        runs[S] = _greedy_runs(f"rglru:{S}", model, params, prompt,
                               lambda t: {"tokens": t}, RGLRU["new"],
                               n_attn)
        torch.cuda.empty_cache()
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[rglru] the recurrentgemma-2b phase took "
        f"{time.perf_counter() - t0:.1f} s")
    return runs

# --------------------------------------------------------------------- #
# 3l. the training path: smollm-360m at full width through
# launch.train.main
# --------------------------------------------------------------------- #
class _TrainSteps:
    """The step wrapper given to ``launch.train.main`` (``wrap_step``):
    each step runs between two ``torch.cuda.synchronize()`` with the
    kernel launch counts zeroed just before it and read just after; it
    records the step's wall time, launches, loss and grad norm, keeps a
    host copy of the state after step ``keep`` (1-based, as the
    checkpoints count: on the host, so that it adds nothing to the
    card's peak memory) and the last state and batch, and runs step
    ``profile`` (0-based) under the profiler (its wall time then
    includes the profiler's)."""

    def __init__(self, keep=None, profile=None):
        self.keep, self.profile = keep, profile
        self.steps, self.kept, self.state, self.batch = [], None, None, None
        self.profiled = None

    def wrap(self, step_fn):
        import torch

        def run(state, batch):
            torch.cuda.synchronize()
            _zero_launches()
            t0 = time.perf_counter()
            if len(self.steps) == self.profile:
                (new, metrics), self.profiled = _profile_round(
                    lambda: step_fn(state, batch), 15, _train_category)
            else:
                new, metrics = step_fn(state, batch)
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            self.steps.append({"wall_s": wall, "launches": _read_launches(),
                               "loss": float(metrics["loss"]),
                               "grad_norm": float(metrics["grad_norm"])})
            if int(new["step"]) == self.keep:
                from repro_torch.train.optimizer import tree_map
                self.kept = tree_map(lambda t: t.detach().cpu(), new)
            self.state, self.batch = new, batch
            return new, metrics
        return run


def _train_argv(steps, seq, batch, ckpt_dir, ckpt_every=0, *extra):
    return ["--arch", TRAIN["arch"], "--steps", str(steps), "--seq",
            str(seq), "--batch", str(batch), "--seed", str(SEED),
            "--ckpt-dir", ckpt_dir, "--ckpt-every", str(ckpt_every), *extra]


def _train_flops(cfg, S, B):
    """Model FLOPs of one step (forward + backward, 3x the forward; the
    checkpointed recompute not counted): 2 T per matmul weight (q, k, v,
    o and the three FFN projections a layer, and the tied head) and 2 x
    (QK + PV) over the causal pairs, T = B S tokens."""
    d, hd, L = cfg.d_model, cfg.head_dim, cfg.n_layers
    H, KV = cfg.n_heads, cfg.n_kv_heads
    per_layer = d * H * hd * 2 + d * KV * hd * 2 + 3 * d * cfg.d_ff
    T = B * S
    fwd = 2 * T * (L * per_layer + d * cfg.vocab) \
        + L * B * H * 4 * hd * S * (S + 1) // 2
    return 3 * fwd


def _train_run(label, argv, hooks, S, B, n_attn_layers):
    """``launch.train.main(argv)`` with ``hooks``: the peak memory, the
    attn_density launches of every step (2 a layer with the flash
    branch, none with gqa_attention), finite losses and grad norms.
    -> the run's record."""
    import numpy as np
    import torch
    from repro_torch.launch import train as ltrain
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = ltrain.main(argv, wrap_step=hooks.wrap)
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    steps = hooks.steps
    if not all(np.isfinite(s["loss"]) and np.isfinite(s["grad_norm"])
               for s in steps) or not steps:
        raise AssertionError(f"[train] {label}: non-finite loss or grad "
                             f"norm: {steps}")
    want = 2 * n_attn_layers if S > 2048 else 0
    for i, s in enumerate(steps):
        got = s["launches"]
        if not (got["attn_density_stats"] == got["attn_density"]
                == got["attn_flash"] == want):
            raise AssertionError(
                f"[train] {label} step {i}: {got['attn_density_stats']} "
                f"attn_density row-stats launches ({got['attn_density']} in "
                f"all, {got['attn_flash']} through csrc/attn_flash.cu), not "
                f"{want}")
    walls = [s["wall_s"] for i, s in enumerate(steps)
             if i != hooks.profile and i > 0]
    med = float(np.median(walls)) if walls else steps[-1]["wall_s"]
    rec = {"argv": argv[:10], "steps": steps, "losses": out["losses"],
           "run_s": run_s, "peak_gib": peak, "step_wall_s_median": med,
           "tokens_per_s": B * S / med,
           "attn_density_launches_a_step": want}
    log(f"[train] {label}: {len(steps)} steps, losses "
        f"{[round(x, 4) for x in out['losses']]}, grad norms "
        f"{[round(s['grad_norm'], 3) for s in steps]}; step wall "
        f"{[round(s['wall_s'], 3) for s in steps]} s (median after the "
        f"first {med:.3f} s, {B * S / med:.0f} tokens/s), peak "
        f"{peak:.2f} GiB; {want} attn_density launches a step")
    return rec


def _same_state(a, b):
    """Names of the leaves of two state trees that differ (bits)."""
    import torch
    bad = []

    def walk(x, y, path):
        if isinstance(x, dict):
            for k in x:
                walk(x[k], y[k], f"{path}/{k}")
        elif not (x.dtype == y.dtype and x.shape == y.shape
                  and torch.equal(x.cpu(), y.cpu())):
            bad.append(path)
    walk(a, b, "")
    return bad


def train_phase(root):
    """smollm-360m (32 layers, d 960, 15 heads over 5 KV heads of 64,
    vocab 49,152, tied head) at full width and depth through
    ``launch.train.main`` on the card: random bf16 weights from SEED
    (its seeded init), SyntheticLM batches, step by step through
    ``_TrainSteps``.  (a) seq 4096, batch 1, 6 steps of fp32 AdamW
    (flash_attention: the row-stats kernel, 2 x 32 launches a step), a
    checkpoint every 3 steps (restored byte for byte against the state
    the step returned), step 2 profiled; then, on its last state, one
    apply_updates timed alone and one step's gradients computed twice
    (the leaves that differ, if any), and every tensor of (a) freed, so
    that each run's peak memory is its own; (b) the same with
    --quantized-opt; (c) seq 512, batch 4, 4 steps (gqa_attention, no
    launch); (d) the first 3 steps of (a) again (two identical runs: bit
    for bit?), and (a) resumed from its step-3 checkpoint to step 6 (the
    losses within RESUME_RTOL of (a)'s, the final state against (a)'s
    step-6 checkpoint).  -> the record."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.train import grad_of
    from repro_torch.models.registry import build_model
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.optimizer import (OptConfig, apply_updates,
                                             init_state)
    t0 = time.perf_counter()
    cfg = get_config(TRAIN["arch"])
    L = cfg.n_layers
    S, B, n = TRAIN["long"]
    every = TRAIN["ckpt_every"]
    dirs = {k: os.path.join(root, k) for k in ("a", "d", "r")}
    rec = {"model_flops_a_step": {"long": _train_flops(cfg, S, B)}}
    hooks_a = _TrainSteps(keep=every, profile=TRAIN["profile_step"])
    rec["a"] = _train_run(f"(a) fp32 AdamW, seq {S} x {B}", _train_argv(
        n, S, B, dirs["a"], every), hooks_a, S, B, L)
    rec["a"]["profile"] = hooks_a.profiled
    log(f"[train] (a) step {TRAIN['profile_step']} profiled: "
        f"{json.dumps(hooks_a.profiled)}")
    bad = _same_state(hooks_a.kept, ckpt.restore(dirs["a"], every,
                                                 device="cpu"))
    if bad:
        raise AssertionError(f"[train] the step-{every} checkpoint differs "
                             f"from the state the step returned: {bad}")
    log(f"[train] the step-{every} checkpoint restores byte for byte")
    # one optimizer step alone, on (a)'s last state and a step's grads,
    # and the same step's gradients twice
    state_a = hooks_a.state
    model = build_model(cfg.with_overrides(max_seq=S), device="cuda")
    _, grads = grad_of(model, state_a["params"], hooks_a.batch)
    _, grads2 = grad_of(model, state_a["params"], hooks_a.batch)
    rec["grad_rerun_differs_in"] = _same_state(grads, grads2)
    opt, opt8 = OptConfig(), OptConfig(quantized=True)
    state8 = init_state(state_a["params"], opt8)
    rec["optimizer_ms"] = _time_ms(
        lambda: apply_updates(state_a, grads, opt), iters=3, warmup=1)
    rec["optimizer_8bit_ms"] = _time_ms(
        lambda: apply_updates(state8, grads, opt8), iters=3, warmup=1)
    log(f"[train] one apply_updates alone: fp32 moments "
        f"{rec['optimizer_ms']:.2f} ms, 8-bit {rec['optimizer_8bit_ms']:.2f} "
        f"ms (step wall {rec['a']['step_wall_s_median'] * 1e3:.1f} ms); one "
        f"step's gradients computed twice differ in "
        f"{rec['grad_rerun_differs_in']}")
    hooks_a.state = hooks_a.batch = None
    del model, grads, grads2, state_a, state8
    gc.collect()
    rec["b"] = _train_run(f"(b) 8-bit AdamW, seq {S} x {B}", _train_argv(
        n, S, B, dirs["d"], 0, "--quantized-opt"), _TrainSteps(), S, B, L)
    Ss, Bs, ns = TRAIN["short"]
    rec["model_flops_a_step"]["short"] = _train_flops(cfg, Ss, Bs)
    rec["c"] = _train_run(f"(c) fp32 AdamW, seq {Ss} x {Bs}", _train_argv(
        ns, Ss, Bs, dirs["d"], 0), _TrainSteps(), Ss, Bs, L)
    hooks_d = _TrainSteps(keep=every)
    rec["d_rerun"] = _train_run(f"(d) (a)'s first {every} steps again",
                                _train_argv(every, S, B, dirs["d"], 0),
                                hooks_d, S, B, L)
    diff_rerun = _same_state(hooks_a.kept, hooks_d.kept)
    same_losses = rec["d_rerun"]["losses"] == rec["a"]["losses"][:every]
    rec["rerun_bit_identical"] = not diff_rerun and same_losses
    rec["rerun_differs_in"] = diff_rerun
    log(f"[train] (d) two identical runs of {every} steps: "
        f"{'' if rec['rerun_bit_identical'] else 'NOT '}bit for bit the same"
        f" (losses {'equal' if same_losses else 'differ'}; state leaves "
        f"that differ: {diff_rerun})")
    os.makedirs(dirs["r"], exist_ok=True)
    os.link(os.path.join(dirs["a"], f"step_{every}.pkl"),
            os.path.join(dirs["r"], f"step_{every}.pkl"))
    hooks_r = _TrainSteps()
    rec["d_resume"] = _train_run(
        f"(d) (a) resumed from step {every}",
        _train_argv(n, S, B, dirs["r"], 0, "--resume"), hooks_r, S, B, L)
    want = rec["a"]["losses"][every:]
    got = rec["d_resume"]["losses"]
    err = max(abs(x - y) / abs(y) for x, y in zip(got, want))
    if len(got) != len(want) or err > RESUME_RTOL:
        raise AssertionError(f"[train] resumed losses {got} against {want}")
    diff_final = _same_state(ckpt.restore(dirs["a"], n, device="cpu"),
                             hooks_r.state)
    rec["resume"] = {"losses": got, "uninterrupted": want,
                     "max_rel_diff": err, "bit_identical": got == want
                     and not diff_final, "state_differs_in": diff_final}
    log(f"[train] (d) resumed losses {got} against {want}: max rel diff "
        f"{err:.3g} (tolerance {RESUME_RTOL}); final state "
        f"{'differs in ' + str(diff_final) if diff_final else 'bit for bit'}")
    del hooks_a, hooks_d, hooks_r
    gc.collect()
    torch.cuda.empty_cache()
    flops = rec["model_flops_a_step"]
    for k, fl in (("a", flops["long"]), ("c", flops["short"])):
        rec[k]["model_tflops_per_s"] = fl / rec[k]["step_wall_s_median"] / 1e12
    log(f"[train] model FLOPs a step: {flops['long'] / 1e12:.2f} T at "
        f"({B}, {S}), {flops['short'] / 1e12:.2f} T at ({Bs}, {Ss}); "
        f"{rec['a']['model_tflops_per_s']:.1f} / "
        f"{rec['c']['model_tflops_per_s']:.1f} TFLOP/s")
    log(f"[train] the training phase took {time.perf_counter() - t0:.1f} s")
    return rec



# --------------------------------------------------------------------- #
# 3i. the MoE family: llama4-maverick-400b-a17b at full width, depth 2
# --------------------------------------------------------------------- #
def _batch_run(model, params, seed, swap_root, fam, B):
    """``launch.serve.serve`` of the serve phase's trace (one app, all
    calls queued at once) at ``decode_batch`` B on slot caches, where a
    round's members decode one after another: every greedy pick kept by
    (cid, the context's call k, step) with the context's bit plan at the
    call's start, for ``_batch_divergence``; the completions; the round
    sizes.  Launches are zeroed just before the replay and read just
    after.  -> the run."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import parse_args, serve
    from repro_torch.trace.synth import TraceEvent
    raw = _raw_chunk_bytes(model)
    args = parse_args([
        "--arch", model.cfg.name, "--policy", "llms",
        "--max-ctx", str(fam["max_ctx"]),
        "--budget-mib", repr(fam["budget_chunks"] * raw / 2**20),
        "--max-new", "8", "--seed", str(seed), "--concurrency", "1",
        "--decode-batch", str(B), "--swap-dir",
        tempfile.mkdtemp(dir=swap_root)])
    events = [TraceEvent(time=float(i), ctx_id=c,
                         prompt=np.asarray(p, np.int32),
                         ground_truth=np.zeros(0, np.int32), dataset="smoke",
                         max_new=n)
              for i, (c, p, n) in enumerate(_trace(model.cfg.vocab, seed))]
    run = {"log": [], "picks": [], "plans": {}, "rounds": []}
    calls, owner, cur = {}, {}, {}

    def keep(cid, logits):
        k = calls[cid] - 1
        step = sum(1 for p in run["picks"] if p[:2] == (cid, k))
        row = torch.as_tensor(np.asarray(logits, np.float32)).reshape(-1)
        run["picks"].append((cid, k, step, row.clone()))

    def on_start(svc, router):
        exe = svc.exe
        begin, extend, decode = svc.begin_call, exe.extend, exe.decode
        batch = svc.decode_step_batch

        def begun(stub, request):
            cid = cur["cid"] = stub.ctx_id
            k = calls[cid] = calls.get(cid, 0) + 1
            run["plans"][cid, k - 1] = tuple(
                (m.bits, m.quant)
                for _, m in sorted(svc.contexts[cid].chunks.items()))
            st = begin(stub, request)
            owner[st.cache["k"].data_ptr()] = cid
            return st

        def kept_extend(cache, prompt, n0):
            out = extend(cache, prompt, n0)
            keep(cur["cid"], out[1])
            return out

        def kept_decode(cache, tok):
            out = decode(cache, tok)
            keep(owner[cache["k"].data_ptr()], out[1])
            return out

        def counted(sts):
            run["rounds"].append(sum(not st.done and st.next_tok is not None
                                     for st in sts))
            return batch(sts)

        def done(job, cancelled):
            cid = job["stub"].ctx_id
            run["log"].append(("done", cid, tuple(job["stream"].tokens)))

        svc.begin_call, svc.decode_step_batch = begun, counted
        exe.extend, exe.decode = kept_extend, kept_decode
        router.on_complete = done
        _zero_launches()
        run["t0"] = time.perf_counter()

    def on_end(svc, router, events):
        torch.cuda.synchronize()
        run["run_s"] = time.perf_counter() - run.pop("t0")
        run["launches"] = _read_launches()
        run["graphs"] = graph_check(svc.exe, None,
                                    f"{fam['tag']}:batch{B}")

    stats = serve(model, params, args, threaded=False, on_start=on_start,
                  on_end=on_end, verbose=False, events=events)
    sizes = {n: run["rounds"].count(n) for n in sorted(set(run["rounds"]))}
    log(f"[{fam['tag']}:batch{B}] decode_batch {B}: {len(run['log'])} calls "
        f"in {run['run_s']:.2f} s, round sizes {sizes}, launches "
        f"{run['launches']}")
    if stats["failed_calls"] or len(run["log"]) != len(events):
        raise AssertionError(f"[{fam['tag']}:batch{B}] a call did not "
                             "complete")
    if B > 1 and max(run["rounds"]) < 2:
        raise AssertionError(f"[{fam['tag']}:batch{B}] no round had two "
                             "members")
    return run


def moe_runs(swap_root):
    """llama4-maverick-400b-a17b at full width (d 5120, 40 heads over 8,
    128 experts of 8192 top-1 + a shared expert of 8192, capacity 1.25,
    groups of 1024, vocab 202,048) at depth 2, its one cut, with every
    earlier phase's weights freed (the card's free memory logged before
    the draw): ``_family_runs`` (no-pressure, ``llms`` with a decode
    token and a recompute profiled, its rerun, ``quant_resident``,
    ``swap``, ``lmk``), then ``decode_batch`` 2 against 1
    (``_batch_divergence``).  Every restore is I/O (the family declares
    no restore recompute).  Over the phase all four kernels of its path
    must run.  -> the runs by label."""
    import torch
    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    free, total = torch.cuda.mem_get_info()
    log(f"[moe] before the draw: {free / 2**30:.2f} GiB free of "
        f"{total / 2**30:.2f} GiB")
    cfg = get_config(MOE["arch"]).with_overrides(n_layers=MOE["n_layers"])
    model, params = build_weights(cfg, SEED)
    log(f"[moe] after the draw: {torch.cuda.mem_get_info()[0] / 2**30:.2f} "
        f"GiB free; peak allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    runs = _family_runs(MOE, model, params, swap_root)
    batch = {B: _batch_run(model, params, SEED, swap_root, MOE, B)
             for B in (1, 2)}
    counts, examined = _batch_divergence(batch[2], batch[1])
    log(f"[moe] decode_batch 2 against 1, call by call: {counts}")
    for e in examined:
        log(f"[moe] decode_batch 2 first divergence: {json.dumps(e)}")
    # a decode token reads every weight but the embedding (one row): the
    # dispatch gives all 128 experts capacity slots (max(4, ...))
    nbytes = sum(w.numel() * w.element_size() for w in _leaves(
        {k: v for k, v in params.items() if k != "embed"}))
    floor_ms = nbytes / HBM_BYTES_PER_S * 1e3
    token = runs["llms"]["prof"].get("decode token")
    products = None if token is None else token["by_category_ms"].get(
        "matmul")
    log(f"[moe] a decode token reads {nbytes / 1e9:.2f} GB of weights: "
        f"bytes floor {floor_ms:.2f} ms; the profiled token's products "
        f"{products} ms, busy {None if token is None else token['device_ms']}"
        f" ms, wall {None if token is None else token['wall_ms']} ms")
    ran = {k: sum(r["launches"][k] for r in runs.values())
           for k in ("quantize", "dequantize", "attn_density",
                     "decode_mqattn")}
    if not all(ran.values()):
        raise AssertionError(f"[moe] a kernel of the path never ran over the "
                             f"phase: {ran}")
    for run in batch.values():
        run.pop("picks")
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[moe] the MoE phases took {time.perf_counter() - t0:.1f} s")
    return runs


# --------------------------------------------------------------------- #
# 3m. the dry run: launch/dryrun.py on the meta device and its cells'
# shares on the card
# --------------------------------------------------------------------- #
def _dryrun_expected(one):
    """The launches of one call that a share's path must make, from its
    record's ``one_card`` block (key of ``_read_launches``: count): on a
    path with no kernel, no launch of any."""
    L, entry = one["n_layers"], one["entry"]
    if entry == "decode":
        if one["family"] == "dense" and one["kv"] == "int8":
            return {"decode_qattn": L}
        return {k: 0 for k in one["launches"]}
    if entry == "prefill":
        return {"attn_density": L, "attn_density_with_density": L,
                "attn_flash": L, "attn_flash_with_density": L}
    return {"attn_density_stats": 2 * one["n_micro"] * L,
            "attn_flash": 2 * one["n_micro"] * L}


def _dryrun_ad_row(label, args, want, stats, iters=3):
    """attn_density at a cell's shape (queries at arange(S) over S keys,
    causal flash form: out only, with the density or with the row stats)
    held against its plain version over every row (``attn_flash_plain``
    in query chunks of 512, so that no (B, H, S, S) score tensor is
    held: out within MQ_OUT_TOL of its range, the density within
    AD_DENS_TOL of its largest value, m within STATS_TOL of max(1,
    |m|) and l within STATS_TOL relative) and its rerun (bit-identical);
    then its device time and time per call, its bound, SDPA is_causal
    (out only) and the plain version, each timed on the same inputs."""
    import torch
    from repro_torch.kernels import attn_density as kad
    from repro_torch.kernels import ref
    S = args[0].shape[1]
    fn = lambda: kad.attn_density(*args, S, 0, 0, want, "flash",  # noqa: E731
                                  stats)
    plain = lambda: ref.attn_flash_plain(                        # noqa: E731
        *args, S, 0, 0, want, stats, q_chunk=512)
    got, again = fn(), fn()
    exp = plain()
    torch.cuda.synchronize()
    span = float(exp[0].float().abs().max())
    err = {"out": float((got[0].float() - exp[0].float()).abs().max())
           / span}
    if want:
        err["density"] = float((got[1] - exp[1]).abs().max()
                               / exp[1].abs().max())
    if stats:
        err["m"] = float((got[2] - exp[2]).abs().max()) / max(
            1.0, float(exp[2].abs().max()))
        err["l"] = float(((got[3] - exp[3]).abs() / exp[3]).max())
    if not (torch.isfinite(got[0].float()).all()
            and err["out"] <= MQ_OUT_TOL
            and err.get("density", 0.0) <= AD_DENS_TOL
            and max(err.get("m", 0.0), err.get("l", 0.0)) <= STATS_TOL):
        raise AssertionError(f"attn_density at {label}: against the plain "
                             f"version {err}")
    if not all(a is b or torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"attn_density at {label}: reruns differ")
    del got, again, exp
    lib = _sdpa_causal(*args[:3])
    bound, by = _ad_bound_ms(args, S, 0, 0, want, stats=stats)
    parts = {}
    row = {"shape": label, "form": "flash", "density": want, "stats": stats,
           "route": kad.route("flash", args[0].shape[-1], args[2].shape[-1]),
           "max_err_rel": err,
           "call_ms": _time_ms(fn, iters=iters, warmup=1),
           "device_ms_by_kernel": parts,
           "plain_q_chunk": 512,
           "plain_call_ms": _time_ms(plain, iters=1, warmup=0),
           "plain_device_ms": _device_ms(plain, iters=1),
           "library_call_ms": _time_ms(lib, iters=iters, warmup=1),
           "library_device_ms": _device_ms(lib, iters=iters),
           "bound_ms": bound, "bound_by": by}
    row["device_ms"] = _device_ms_whole(fn, row["call_ms"], iters, parts)
    log(f"[dryrun] attn_density {label} ({row['route']}): against the "
        f"plain version {err}, rerun identical; kernel {row['device_ms']} "
        f"ms on the device, {row['call_ms']:.4f} ms per call; plain (query "
        f"chunks of 512) {row['plain_device_ms']} ms; SDPA is_causal (out "
        f"only) {row['library_device_ms']} ms on the device, "
        f"{row['library_call_ms']:.4f} ms per call; bound {bound:.4f} ms "
        f"({by}); by launch {parts}")
    torch.cuda.empty_cache()
    return row


def _dryrun_dq_row(label, B, S, H, KV, hd, window, n_sinks, g, dev):
    """decode_qattn at a cell's shape as decode_step calls it (select
    form, no mass, every row at n_valid = S, the cell's window and
    sinks): device time and time per call, its plain version, its bound
    (the valid keys' int8 rows and scales, q and out once over the HBM
    rate, or 4 H hd FLOPs a valid key over the bf16 rate; the kernel
    loads no invalid key) and SDPA over the dequantized bf16 K/V with the
    boolean mask of the valid keys (out only)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_qattn as kdq
    from repro_torch.kernels import ref
    q = torch.randn((B, H, hd), generator=g, device=dev).bfloat16()
    k_q, v_q = (torch.randint(-127, 128, (B, S, KV, hd), generator=g,
                              device=dev, dtype=torch.int8)
                for _ in range(2))
    k_s, v_s = ((torch.rand((B, S, KV), generator=g, device=dev) + 0.5)
                / 127 for _ in range(2))
    nv = torch.full((B,), S, dtype=torch.int32, device=dev)
    args = (q, k_q, v_q, k_s, v_s, nv, window, n_sinks)
    fn = lambda: kdq.decode_qattn(*args, select=True)          # noqa: E731
    plain = lambda: ref.decode_qattn_plain(*args, select=True)  # noqa: E731
    o_k, o_r = fn(), plain()
    span = float(o_r.float().abs().max())
    d_o = float((o_k.float() - o_r.float()).abs().max())
    if not (torch.isfinite(o_k.float()).all() and d_o <= MQ_OUT_TOL * span):
        raise AssertionError(f"decode_qattn at {label}: |d out| {d_o} "
                             f"(range {span})")
    valid = ref._valid_keys(nv, B, S, window, n_sinks, dev)
    n_keys = int(valid.sum())
    kb = ref.dequantize_token_head_ref(k_q, k_s).transpose(1, 2).contiguous()
    vb = ref.dequantize_token_head_ref(v_q, v_s).transpose(1, 2).contiguous()
    mask = valid[:, None, None, :]
    lib = lambda: F.scaled_dot_product_attention(               # noqa: E731
        q[:, :, None], kb, vb, attn_mask=mask, enable_gqa=KV != H)
    nbytes = n_keys * KV * (2 * hd + 8) + 2 * B * H * hd * 2 + 4 * B
    t_b, t_o = nbytes / HBM_BYTES_PER_S, 4 * H * hd * n_keys / BF16_OPS_PER_S
    parts = {}
    row = {"shape": label, "form": "select", "window": window,
           "n_sinks": n_sinks, "valid_keys_a_row": n_keys // B,
           "max_err_rel": d_o / span,
           "call_ms": _time_ms(fn, iters=50, warmup=5),
           "device_ms": _device_ms(fn, DQ_KERNELS, iters=20,
                                   by_kernel=parts),
           "device_ms_by_kernel": parts,
           "plain_call_ms": _time_ms(plain, iters=5, warmup=1),
           "plain_device_ms": _device_ms(plain, iters=5),
           "library_call_ms": _time_ms(lib, iters=20, warmup=2),
           "library_device_ms": _device_ms(lib, iters=20),
           "bound_ms": max(t_b, t_o) * 1e3,
           "bound_by": "bytes" if t_b >= t_o else "operations"}
    log(f"[dryrun] decode_qattn {label}: |d out| {d_o:.3g} (range "
        f"{span:.3g}); {n_keys // B} valid keys a row; kernel "
        f"{row['device_ms']} ms on the device, {row['call_ms']:.5f} ms per "
        f"call; plain {row['plain_device_ms']} ms; SDPA over the "
        f"dequantized bf16 K/V with the mask (out only) "
        f"{row['library_device_ms']} ms on the device, "
        f"{row['library_call_ms']:.5f} ms per call; bound "
        f"{row['bound_ms']:.5f} ms ({row['bound_by']}); by launch {parts}")
    del args, kb, vb, k_q, v_q
    torch.cuda.empty_cache()
    return row


def dryrun_phase(root):
    """launch/dryrun.py's main over every cell of ASSIGNED x SHAPES on the
    meta device, single and multi-pod (no cell may fail, and only the
    cells ``shape_applicability`` refuses are skipped); then DRYRUN_RUNS
    through ``run_cell(..., run=True)``: each share at full width (no
    depth cut allowed but for DRYRUN_CUT_OK), its kernels' launches in
    one call required (none on a path with no kernel), a decode or
    prefill share's last timed call bit-identical to its warm call, its
    decode held against the plain version layer by layer and in its
    logits, its first attn_density call's last 512 query rows held
    against the plain version; then the kernels timed at those shapes.
    -> {"meta", "runs", "kernel_rows"}."""
    import torch
    from repro_torch.configs import ASSIGNED, SHAPES, shape_applicability
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    out = {"meta": {}, "runs": {}, "kernel_rows": {}}
    refused = {(a, s) for a in ASSIGNED for s in SHAPES
               if not shape_applicability(get_config(a), SHAPES[s])[0]}
    for multi in (False, True):
        try:
            recs = dryrun.main(["--all", "--out", os.path.join(root, "meta")]
                               + (["--multi-pod"] if multi else []))
        except SystemExit as e:
            raise AssertionError(f"[dryrun] a cell failed (exit {e.code})")
        mesh = recs[0]["mesh"]
        status = [r["status"] for r in recs]
        skipped = {(r["arch"], r["shape"]) for r in recs
                   if r["status"] == "skipped"}
        if skipped != refused:
            raise AssertionError(f"[dryrun] skipped {skipped}, not "
                                 f"{refused}")
        gib = {f"{r['arch']} x {r['shape']}":
               r["memory"]["argument_size_in_bytes"] / 2**30
               for r in recs if r["status"] == "ok"}
        out["meta"][mesh] = {k: status.count(k)
                             for k in ("ok", "skipped", "fail")}
        out["meta"][mesh]["argument_gib_a_device"] = gib
        log(f"[dryrun] {mesh} on the meta device: {out['meta'][mesh]}")
    for arch, shape, kv in DRYRUN_RUNS:
        gc.collect()
        torch.cuda.empty_cache()
        label = f"{arch} x {shape}" + (" int8" if kv == "int8" else "")
        rec = dryrun.run_cell(arch, shape, False, os.path.join(root, "run"),
                              kv_dtype=kv, run=True, device="cuda",
                              seed=SEED)
        if rec["status"] != "ok":
            raise AssertionError(f"[dryrun] {label}: {rec.get('error')}\n"
                                 f"{rec.get('traceback')}")
        one = dict(rec["one_card"], entry=rec["entry"],
                   n_micro=rec["n_micro"], window=rec["window"],
                   family=get_config(arch).family, kv=kv)
        if one["reduced"] and arch not in DRYRUN_CUT_OK:
            raise AssertionError(f"[dryrun] {label} cut: {one['reduced']}")
        if one["reduced"]:
            log(f"[dryrun] {label} cut: {one['reduced']}")
        # a train step advances its state: no repeat to hold
        if one["repeat_identical"] is not (
                None if one["entry"] == "train" else True):
            raise AssertionError(f"[dryrun] {label}: repeat identical "
                                 f"{one['repeat_identical']}")
        want = _dryrun_expected(one)
        got = {k: one["launches"][k] for k in want}
        if got != want:
            raise AssertionError(f"[dryrun] {label}: launches {got}, not "
                                 f"{want}")
        out["runs"][label] = one
        log(f"[dryrun] {label}: {json.dumps(one)}")
    gc.collect()
    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 24)
    cfg = get_config("smollm-360m")
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    for B, S, modes in ((2, 32768, ("density", "out")), (8, 4096, ("stats",))):
        args = _ad_case(B, S, S, H, KV, hd, list(range(S)), g, dev)
        for mode in modes:
            label = (f"({B},{S},{H},{KV},{hd}) causal flash "
                     + {"density": "+ density", "out": "out only",
                        "stats": "+ stats"}[mode])
            out["kernel_rows"][label] = _dryrun_ad_row(
                label, args, mode == "density", mode == "stats")
        del args
    q14 = get_config("qwen2.5-14b")
    for B, S, c, (w, ns) in (
            (8, 32768, q14, (0, 0)),
            (1, 524288, cfg, (8192, cfg.n_sink_tokens))):
        label = (f"({B},{S},{c.n_heads},{c.n_kv_heads},{c.head_dim}) select"
                 + (f", window {w} + {ns} sinks" if w else ""))
        out["kernel_rows"][label] = _dryrun_dq_row(
            label, B, S, c.n_heads, c.n_kv_heads, c.head_dim, w, ns, g, dev)
    log(f"[dryrun] the dry-run phase took {time.perf_counter() - t0:.1f} s")
    return out


def _dryrun_launches(dry, key):
    """A kernel's launches in one call of each dry-run share."""
    return {"launches_dryrun": {label: run["launches"][key]
                                for label, run in dry["runs"].items()}}


# --------------------------------------------------------------------- #
# 4. reduced model on the card vs the same port on the CPU
# --------------------------------------------------------------------- #
def _card_and_cpu(cfg, prepare=None):
    """``cfg``'s model on the CPU (weights from SEED) and on the card
    (the same weights moved there); ``prepare(params)`` edits the CPU
    weights first.  -> (cpu model, cpu params, card model, card
    params)."""
    import torch
    from repro_torch.models.registry import build_model
    cpu = build_model(cfg, device="cpu")
    params_cpu = cpu.init(torch.Generator().manual_seed(SEED))
    if prepare is not None:
        prepare(params_cpu)
    gpu = build_model(cfg, device="cuda")

    def to_card(tree):
        return {k: to_card(v) if isinstance(v, dict) else v.cuda()
                for k, v in tree.items()}
    return cpu, params_cpu, gpu, to_card(params_cpu)


def _diffs(what, ref_out, card_out, tag):
    """{name: (max |diff|, range)} over parallel tuples of CPU and card
    tensors; raises on a non-finite card value."""
    import torch
    out = {}
    for name, a, b in zip(what, ref_out, card_out):
        a, b = a.float().cpu(), b.float().cpu()
        if not torch.isfinite(b).all():
            raise AssertionError(f"{tag}: non-finite {name} on the card")
        out[name] = (float((a - b).abs().max()), float(a.abs().max()))
    return out


def _check_pipelined(name):
    """The reduced ``name``'s layer-pipelined restore on the card against
    the same port on the CPU: one prefilled cache (64 tokens) and the
    same chunk files (chunks 0 and 3 at 8 and 4 bits), chunk 2
    recomputed through ``run_pipelined``; the restored K/V and the
    logits of the recomputed rows (the last layer's attention output
    reaches only these) agree at the check phase's tolerance (2% of the
    range: bf16 products round differently), and the card launches
    attn_density once per layer."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.restore import LayerFeed, write_chunk_file
    from repro_torch.core.service import LLMService, LLMSConfig
    from repro_torch.kernels import attn_density as kad
    cfg = reduced(get_config(name))
    cpu, params_cpu, gpu, params_gpu = _card_and_cpu(cfg)
    io_idx, re_idx, n = [0, 3], [2], 64
    out, logits, paths = {}, {}, []
    with tempfile.TemporaryDirectory(prefix="llms_chip_check_") as root:
        for dev, model, params in (("cpu", cpu, params_cpu),
                                   ("cuda", gpu, params_gpu)):
            sc = LLMSConfig(policy="llms", paged_pool=False, max_ctx_len=64,
                            memory_budget=1 << 40,
                            swap_dir=tempfile.mkdtemp(dir=root))
            with LLMService(model, params, sc, device=dev) as svc:
                exe, res = svc.exe, svc.res
                if dev == "cpu":
                    rng = np.random.default_rng(SEED + 9)
                    toks = rng.integers(1, cfg.vocab, n).astype(np.int32)
                    full, _, _ = exe.extend(exe.fresh_cache(0), toks, 0)
                    for i, bits in zip(io_idx, (8, 4)):
                        p = os.path.join(root, f"check{i}.chunk")
                        write_chunk_file(p, res._make_payload(full, i, bits),
                                         exe.n_layers)
                        paths.append(p)
                    pos = torch.as_tensor(exe.chunk_positions(io_idx
                                                              + re_idx))
                    for k in exe.codec.leaves:
                        full[k][:, :, pos] = 0
                cache = {k: v.to(dev, copy=True) for k, v in full.items()}
                miss = exe.chunk_positions(re_idx)
                feed = LayerFeed(paths, exe.codec.leaves, exe.n_layers,
                                 exe.cs, exe.leaf_dims, pad_chunks=0,
                                 alloc=exe.host_alloc)
                kad.reset_launches()
                _, hidden = exe.run_pipelined(
                    feed, exe.bucket_pad(toks[miss], 0),
                    exe.bucket_pad(miss, exe.pad_slot),
                    exe.chunk_positions(io_idx), cache, n)
                feed.close()
                exe.sync()
                launches = kad.attn_density.launches
                out[dev] = {k: cache[k][:, :, :n].float().cpu()
                            for k in exe.codec.leaves}
                logits[dev] = torch.from_numpy(
                    exe.logits(hidden[0, :len(miss)]))
    span = max(float(v.abs().max()) for v in out["cpu"].values())
    worst = max(float((out["cpu"][k] - out["cuda"][k]).abs().max())
                for k in out["cpu"])
    if worst > 0.02 * span + 1e-3:
        raise AssertionError(f"[check] reduced {name} pipelined restore: the "
                             f"card's K/V differ from the CPU's by {worst} "
                             f"(range {span})")
    l_span = float(logits["cpu"].abs().max())
    l_worst = float((logits["cpu"] - logits["cuda"]).abs().max())
    if not torch.isfinite(logits["cuda"]).all() or \
            l_worst > 0.02 * l_span + 1e-3:
        raise AssertionError(f"[check] reduced {name} pipelined restore: the "
                             f"card's logits of the recomputed rows differ "
                             f"from the CPU's by {l_worst} (range {l_span})")
    if launches != cfg.n_layers:
        raise AssertionError(f"[check] reduced {name} pipelined restore: "
                             f"{launches} attn_density launches, not "
                             f"{cfg.n_layers}")
    log(f"[check] reduced {name}, layer-pipelined restore (chunks {io_idx} "
        f"fed, {re_idx} recomputed): card vs CPU max |K/V diff| "
        f"{worst:.5f} (range {span:.4f}), max |logit diff| of the "
        f"recomputed rows {l_worst:.5f} (range {l_span:.4f}), tolerance 2% "
        f"of range; attn_density launches {launches}")


def _teacher_forced(model, params, dev, arenas0, mixed):
    """Extend a prompt into row 0's pages, then four decode rounds fed
    fixed tokens.  The bf16 view: one row, pages [3, 7].  The mixed
    view: row 0 holds chunk 0 as an int8 QUANT page and appends 12
    tokens at [16, 28); the decode rounds run two rows, row 1 with its
    chunk 1 quant-resident.  -> all logits, stacked, on the CPU."""
    import numpy as np
    import torch
    rng = np.random.default_rng(SEED)
    vocab = model.cfg.vocab
    ar = {k: a.to(dev) for k, a in arenas0.items()}
    t = lambda a, dt=torch.long: torch.as_tensor(a, dtype=dt, device=dev)  # noqa: E731
    if mixed:
        pt16, lo, n, rows = [[0, 7, 0, 0], [4, 0, 5, 0]], 16, 12, 2
        quant = dict(pt8=t([[2, 0, 0, 0], [0, 3, 0, 0]]),
                     quant_chunks=t([[True, False, False, False],
                                     [False, True, False, False]],
                                    torch.bool))
        first = {k: v[:1] for k, v in quant.items()}
    else:
        pt16, lo, n, rows = [[3, 7, 0, 0]], 0, 20, 1
        quant = first = {}
    prompt = rng.integers(1, vocab, n).tolist()
    pos = t(list(range(lo, lo + n)) + [63] * (32 - n if not mixed else 4))
    toks = t(prompt + [0] * (len(pos) - n))[None]
    ar, x, _ = model.extend_paged(params, toks, pos, ar, t(pt16)[:1],
                                  lo + n, want_density=True, **first)
    logits = [(x[:, n - 1] @ model.head_weight(params)).float().cpu()]
    starts = [lo + n, 32][:rows]
    for step in range(4):
        tok = t(rng.integers(1, vocab, (rows, 1)))
        ar, lg, _ = model.decode_paged(
            params, tok, ar, t(pt16), t([p + step for p in starts]),
            want_density=True, **quant)
        logits.append(lg.float().cpu())
    return torch.cat(logits)


def _teacher_forced_int8(model, params, dev):
    """Eight decode_step rounds of two rows over an all-int8 cache, row 1
    starting at position 7, fed fixed tokens.  -> logits and masses,
    stacked, on the CPU."""
    import numpy as np
    import torch
    rng = np.random.default_rng(SEED + 4)
    cache = model.init_cache(2, 64, dtype=torch.int8)
    cache["pos"] = torch.tensor([0, 7], device=dev)
    logits, masses = [], []
    for _ in range(8):
        tok = torch.as_tensor(rng.integers(1, model.cfg.vocab, (2, 1)),
                              device=dev)
        out, mass = model.decode_step(params, tok, cache, want_density=True)
        cache = out.cache
        logits.append(out.logits.float().cpu())
        masses.append(mass.float().cpu())
    return torch.cat(logits), torch.cat(masses)


def _grad_errors(tag, cpu_grads, card_grads):
    """Each gradient leaf, card against CPU: relative L2 within
    TRAIN_GRAD_L2 and max |diff| within TRAIN_GRAD_MAX of its largest
    magnitude (TRAIN_GATE_TOL for the VLM's tanh gates).  -> the worst
    (relative L2, max share)."""
    import torch
    from repro_torch.train.optimizer import tree_leaves
    worst = [0.0, 0.0]

    def walk(a, b, path):
        if isinstance(a, dict):
            for k in a:
                walk(a[k], b[k], f"{path}/{k}")
            return
        a, b = a.double().cpu(), b.double().cpu()
        if not torch.isfinite(b).all():
            raise AssertionError(f"{tag}: non-finite gradient {path}")
        tol = (TRAIN_GATE_TOL, TRAIN_GATE_TOL) if path.split("/")[-1] in (
            "gate_attn", "gate_ffn") else (TRAIN_GRAD_L2, TRAIN_GRAD_MAX)
        scale, norm = float(a.abs().max()), float(a.norm())
        l2 = float((a - b).norm()) / (norm or 1.0)
        mx = float((a - b).abs().max()) / (scale or 1.0)
        if l2 > tol[0] or mx > tol[1]:
            raise AssertionError(f"{tag}: gradient {path} relative L2 {l2}, "
                                 f"max |diff| / max {mx} (tolerance {tol})")
        if tol[0] == TRAIN_GRAD_L2:
            worst[0], worst[1] = max(worst[0], l2), max(worst[1], mx)
    walk(cpu_grads, card_grads, "")
    assert len(tree_leaves(cpu_grads)) == len(tree_leaves(card_grads))
    return tuple(worst)


def _train_batch(cfg, B, S, seed, dev):
    """Tokens and targets (B, S) and the family's frames / patches, from
    numpy, on ``dev``."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab, (B, S + 1))
    batch = {"tokens": tok[:, :-1], "targets": tok[:, 1:]}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (B, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (B, cfg.vision.n_image_tokens, cfg.vision.d_vision)
        ).astype(np.float32)
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


# the reduced configs of every family and their training lengths: the
# dense family and recurrentgemma also above 2,048 tokens, where the
# reference's training attention takes flash_attention (the kernel)
TRAIN_CHECKS = (("smollm-360m", 24), ("smollm-360m", 2100),
                ("deepseek-v2-lite-16b", 24),
                ("llama4-maverick-400b-a17b", 24),
                ("llama-3.2-vision-90b", 24), ("whisper-base", 24),
                ("rwkv6-1.6b", 24), ("recurrentgemma-2b", 24),
                ("recurrentgemma-2b", 2100))


def _check_train_families(cases=TRAIN_CHECKS):
    """Every family's reduced ``loss`` and its gradients (``grad_of``) on
    the card against the same port on the CPU, the same weights and
    batch: the loss within TRAIN_LOSS_RTOL, each gradient leaf as
    ``_grad_errors``; MoE routing held to the CPU's at expert near-ties
    (``_ExpertTies``, the gradient through the gates kept); the
    row-stats kernel launched twice an attention layer above 2,048
    tokens (the forward and its recompute), never below.  -> {case:
    (loss diff, worst relative L2, worst max share, launches)}."""
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.train import grad_of
    from repro_torch.models.rglru import _block_counts
    out = {}
    for name, S in cases:
        cfg = reduced(get_config(name))
        cpu, p_cpu, gpu, p_gpu = _card_and_cpu(cfg)
        B = 1 if S > 2048 else 2
        b_cpu = _train_batch(cfg, B, S, SEED + 31, "cpu")
        b_gpu = {k: v.cuda() for k, v in b_cpu.items()}
        ties = _ExpertTies() if cfg.moe is not None else None
        try:
            m_cpu, g_cpu = grad_of(cpu, p_cpu, b_cpu)
            if ties is not None:
                ties.follow()
            _zero_launches()
            m_gpu, g_gpu = grad_of(gpu, p_gpu, b_gpu)
            torch.cuda.synchronize()
            launches = _read_launches()["attn_density_stats"]
        finally:
            if ties is not None:
                ties.close()
        n_attn = (_block_counts(cfg)[1] if cfg.family == "rglru_hybrid"
                  else cfg.n_layers)
        want = 2 * n_attn if S > 2048 else 0
        d_loss = abs(float(m_gpu["loss"]) - float(m_cpu["loss"]))
        if d_loss > TRAIN_LOSS_RTOL * abs(float(m_cpu["loss"])) or \
                launches != want:
            raise AssertionError(
                f"[check] train {name} S {S}: loss card {float(m_gpu['loss'])}"
                f" CPU {float(m_cpu['loss'])}; {launches} row-stats "
                f"launches, not {want}")
        l2, mx = _grad_errors(f"[check] train {name} S {S}", g_cpu, g_gpu)
        out[f"{name} S {S}"] = (d_loss, l2, mx, launches)
        log(f"[check] train {name} (reduced) S {S}: loss card "
            f"{float(m_gpu['loss']):.6f} CPU {float(m_cpu['loss']):.6f}; "
            f"gradients worst relative L2 {l2:.4f}, worst max |diff| / max "
            f"{mx:.4f}; {launches} row-stats launches"
            f"{'; forced routing ' + str(len(ties.forced)) if ties else ''}")
        del cpu, p_cpu, gpu, p_gpu, g_cpu, g_gpu
    return out


# flash_attention on the card against the CPU: (B, S, H, KV, Dqk, Dv,
# block, window, n_sinks): smollm-360m's heads over a ragged third block,
# a window with sinks on 16-row tiles, and MLA's head dims
FLASH_CHECKS = ((1, 2500, 15, 5, 64, 64, 1024, 0, 0),
                (2, 300, 4, 1, 16, 16, 128, 48, 2),
                (1, 640, 16, 16, 192, 128, 256, 0, 0))


def _check_flash_grads(cases=FLASH_CHECKS):
    """``flash_attention``'s forward and its dq, dk, dv through autograd
    on the card (the row-stats kernel forward, the plain fp32 backward)
    against the same function on the CPU (the plain forward), the same
    bf16 inputs and dout: out within MQ_OUT_TOL of its range, each
    gradient within FLASH_GRAD_TOL of its largest value.  -> {case:
    worst share}."""
    import torch
    from repro_torch.models import common as C
    out = {}
    for B, S, H, KV, dqk, dv, block, window, n_sinks in cases:
        g = torch.Generator().manual_seed(SEED + S)
        r = lambda *sh: torch.randn(sh, generator=g).bfloat16()  # noqa: E731
        xs = (r(B, S, H, dqk), r(B, S, KV, dqk), r(B, S, KV, dv))
        do = r(B, S, H, dv)
        res = {}
        for dev in ("cpu", "cuda"):
            leaves = [x.to(dev).requires_grad_(True) for x in xs]
            o = C.flash_attention(*leaves, 0, block, window, n_sinks)
            res[dev] = [o] + list(torch.autograd.grad(o, leaves, do.to(dev)))
        torch.cuda.synchronize()
        label = (f"({B},{S},{H},{KV},{dqk}/{dv}) block {block} window "
                 f"{window} sinks {n_sinks}")
        errs = []
        for i, (a, b) in enumerate(zip(res["cpu"], res["cuda"])):
            a, b = a.detach().float(), b.detach().float().cpu()
            e = float((a - b).abs().max()) / float(a.abs().max())
            tol = MQ_OUT_TOL if i == 0 else FLASH_GRAD_TOL
            if not (torch.isfinite(b).all() and e <= tol):
                raise AssertionError(f"[check] flash_attention {label}: "
                                     f"{('out', 'dq', 'dk', 'dv')[i]} "
                                     f"|diff| / max {e} (tolerance {tol})")
            errs.append(e)
        out[label] = max(errs[1:])
        log(f"[check] flash_attention {label}, card against CPU: out "
            f"{errs[0]:.3g}, dq {errs[1]:.3g}, dk {errs[2]:.3g}, dv "
            f"{errs[3]:.3g} of their largest values")
    return out


def check_phase():
    for name in ("llama2-7b", "smollm-360m"):
        _check_config(name)
    _check_pipelined("llama2-7b")
    _check_mla()
    _check_rwkv6()
    _check_prefill()
    _check_moe()
    _check_vlm()
    _check_encdec()
    _check_rglru()
    return {"flash_grads": _check_flash_grads(),
            "train_families": _check_train_families()}


def _rwkv6_teacher_forced(model, params, dev):
    """The reduced rwkv6, two rows: a 21-token prefill, 8 decode steps
    fed fixed tokens, a 12-token recompute continuing the carried state.
    -> (logits of every step, the wkv state after each phase), on the
    CPU."""
    import numpy as np
    import torch
    rng = np.random.default_rng(SEED + 8)
    toks = torch.as_tensor(rng.integers(1, model.cfg.vocab, (2, 41)),
                           dtype=torch.long, device=dev)
    out = model.prefill(params, {"tokens": toks[:, :21]})
    cache, logits, states = out.cache, [out.logits], [out.cache["wkv"]]
    for i in range(21, 29):
        step = model.decode_step(params, toks[:, i:i + 1], cache)
        logits.append(step.logits)
    states.append(cache["wkv"])
    pos = torch.arange(29, 41, device=dev)
    cache, x, _ = model.recompute(params, toks[:, 29:], pos, cache, 41)
    logits.append((x[:, -1] @ model.head_weight(params)).float())
    states.append(cache["wkv"])
    return (torch.cat([t.float().cpu() for t in logits]),
            torch.cat([t.float().cpu().reshape(-1) for t in states]))


def _check_rwkv6():
    """The reduced rwkv6 on the card against the same port on the CPU
    from the same weights: the chunked-parallel prefill, 8 sequential
    decode steps and a recompute continuing the carried state, logits
    within 2% of their range and the fp32 wkv state within 1% (bf16
    level: the projections that make r / k / v are bf16 products, which
    round differently on the card, one bf16 ulp being 2^-8 of a value);
    and the fp32 recurrence alone, ``_wkv_chunked`` on the same fp32
    inputs at the full width's heads (two rows, 32 heads of 64, a
    carried state, 37 steps: two chunks and a padded third), out and
    state within 1e-5 of their range.  A control runs that recurrence
    again with TF32 allowed in its fp32 products, the rounding
    ``configure_numerics`` keeps out: it must break the 1e-5 limit, or
    the limit could not catch it (at the reduced 16-wide heads cuBLAS's
    batched products take no TF32 path even where it is allowed)
    (``tests/test_torch_cuda.py::test_cuda_rwkv6_matches_cpu`` runs
    this check too).  No kernel of the port may launch.  -> {what:
    (max |diff|, range)}."""
    import torch
    from repro_torch.configs import get_config, reduced
    cfg = reduced(get_config(RWKV["arch"]))
    cpu, params_cpu, gpu, params_gpu = _card_and_cpu(cfg)
    _zero_launches()
    ref_out = _rwkv6_teacher_forced(cpu, params_cpu, "cpu")
    card_out = _rwkv6_teacher_forced(gpu, params_gpu, "cuda")
    g = torch.Generator().manual_seed(SEED + 10)
    full = get_config(RWKV["arch"])
    H, hd = full.n_heads, full.rwkv.head_dim
    args = [torch.randn((2, 37, H, hd), generator=g) for _ in range(3)]
    args.append(torch.clamp_min(-torch.exp(torch.randn((2, 37, H, hd),
                                                       generator=g) - 0.5),
                                -5.0))
    args += [0.3 * torch.randn((H, hd), generator=g),
             0.1 * torch.randn((2, H, hd, hd), generator=g)]
    ref_out += cpu._wkv_chunked(*args)
    card_out += tuple(t.cpu() for t in gpu._wkv_chunked(
        *[a.cuda() for a in args]))
    launches = _read_launches()
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32_out = ref_out[:2] + tuple(t.cpu() for t in gpu._wkv_chunked(
            *[a.cuda() for a in args]))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    names = ("logits", "wkv", "wkv_chunked_out", "wkv_chunked_state")
    tol = {"logits": 0.02, "wkv": 0.01, "wkv_chunked_out": 1e-5,
           "wkv_chunked_state": 1e-5}

    def against_cpu(outs):
        diffs = {}
        for what, a, b in zip(names, ref_out, outs):
            if not torch.isfinite(b).all():
                raise AssertionError(f"[check] reduced rwkv6: non-finite "
                                     f"{what} on the card")
            diffs[what] = (float((a - b).abs().max()), float(a.abs().max()))
        rel = {k: d / max(s, 1e-30) for k, (d, s) in diffs.items()}
        return diffs, [k for k in tol if rel[k] > tol[k]]

    diffs, over = against_cpu(card_out)
    if over or any(launches.values()):
        raise AssertionError(f"[check] reduced rwkv6: card vs CPU (max "
                             f"|diff|, range) {diffs}, over the tolerance "
                             f"{over}, launches {launches}")
    tf32_diffs, tf32_over = against_cpu(tf32_out)
    if not tf32_over:
        raise AssertionError(f"[check] reduced rwkv6: the TF32 control "
                             f"stays within the tolerance {tol}: "
                             f"{tf32_diffs}")
    log(f"[check] reduced {RWKV['arch']} ({cfg.n_heads} heads of "
        f"{cfg.rwkv.head_dim}), 21-token prefill + 8 decode steps + a "
        f"12-token recompute, teacher-forced, and _wkv_chunked on the same "
        f"fp32 inputs ({H} heads of {hd}): card vs CPU (max |diff|, range) {diffs}; tolerance "
        f"(of range) {tol}; the TF32 control {tf32_diffs} breaks "
        f"{tf32_over}")
    return diffs


def _mla_teacher_forced(model, params, dev, layout):
    """The reduced deepseek-v2-lite on a (1, 64) cache: a 12-token
    prompt recomputed with the density (padded to 16 rows at 63), then
    four decode steps fed fixed tokens.  The window layout starts at 0;
    the mixed one holds int8 latents at [0, 16) and appends at 16.
    -> (logits, latents of [0, 32), density, masses), on the CPU."""
    import numpy as np
    import torch
    from repro_torch.kernels import ref
    rng = np.random.default_rng(SEED + 6)
    vocab, m, L = model.cfg.vocab, model.cfg.mla, model.cfg.n_layers
    cache = model.init_cache(1, 64, layout=layout)
    lo = 0
    if layout == "mixed":
        g = torch.Generator().manual_seed(SEED + 7)
        for n, w in (("ckv", m.kv_lora_rank), ("kpe", m.qk_rope_head_dim)):
            codes, sc = ref.quantize_token_head_ref(
                torch.randn((L, 1, 16, w), generator=g))
            cache[n + "_q"][:, :, :16] = codes.to(dev)
            cache[n + "_scale"][:, :, :16] = sc.to(dev)
        cache["quant_mask"][..., :16] = True
        lo = 16
    n = 12
    t = lambda a: torch.as_tensor(a, dtype=torch.long, device=dev)  # noqa: E731
    toks = t(rng.integers(1, vocab, n).tolist() + [0] * 4)[None]
    pos = t(list(range(lo, lo + n)) + [63] * 4)
    cache, x, dens = model.recompute(params, toks, pos, cache, lo + n,
                                     want_density=True)
    logits = [(x[:, n - 1] @ model.head_weight(params)).float().cpu()]
    cache["pos"] = torch.tensor(lo + n, device=dev)
    masses = []
    for _ in range(4):
        out, mass = model.decode_step(
            params, t(rng.integers(1, vocab, (1, 1))), cache,
            want_density=True)
        cache = out.cache
        logits.append(out.logits.float().cpu())
        masses.append(mass.float().cpu())
    latents = torch.cat([cache[n][:, :, :32].float().reshape(-1).cpu()
                         for n in ("ckv", "kpe")])
    return (torch.cat(logits), latents, dens.float().cpu(),
            torch.cat(masses))


def _check_mla(layouts=("window", "mixed")):
    """The reduced deepseek-v2-lite teacher-forced on the card (the
    attn_density kernel at Dqk 24 / Dv 16 in each recompute) against the
    same port on the CPU (the plain version): recomputed latents,
    logits, the density and the decode masses, over each of ``layouts``
    (``tests/test_torch_cuda.py::test_cuda_mla_matches_cpu`` runs this
    check too).  -> {layout: {what: (max |diff|, range)}}."""
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels import attn_density as kad
    cfg = reduced(get_config(MLA["arch"]))
    cpu, params_cpu, gpu, params_gpu = _card_and_cpu(cfg)
    out = {}
    for layout in layouts:
        kad.reset_launches()
        ref_out = _mla_teacher_forced(cpu, params_cpu, "cpu", layout)
        card_out = _mla_teacher_forced(gpu, params_gpu, "cuda", layout)
        diffs = {}
        for what, a, b in zip(("logits", "latents", "density", "mass"),
                              ref_out, card_out):
            if not torch.isfinite(b).all():
                raise AssertionError(f"[check] reduced MLA {layout}: "
                                     f"non-finite {what} on the card")
            diffs[what] = (float((a - b).abs().max()), float(a.abs().max()))
        worst = {k: d / max(s, 1e-30) for k, (d, s) in diffs.items()}
        if worst["logits"] > 0.02 or worst["latents"] > 0.02 or \
                diffs["density"][0] > 1e-3 or diffs["mass"][0] > 1e-3:
            raise AssertionError(f"[check] reduced MLA {layout}: card vs CPU "
                                 f"(max |diff|, range) {diffs}")
        if kad.attn_density.launches != cfg.n_layers:
            raise AssertionError(f"[check] reduced MLA {layout}: "
                                 f"{kad.attn_density.launches} attn_density "
                                 f"launches, not {cfg.n_layers}")
        log(f"[check] reduced {MLA['arch']} ({cfg.mla.qk_nope_head_dim} + "
            f"{cfg.mla.qk_rope_head_dim} / {cfg.mla.v_head_dim} head dims, "
            f"{cfg.moe.n_experts} experts), {layout} cache, teacher-forced "
            f"recompute (attn_density on the card) + 4 absorbed decode "
            f"steps: card vs CPU (max |diff|, range) {diffs}; tolerance 2% "
            f"of range (logits, latents), 1e-3 (density, mass)")
        out[layout] = diffs
    return out


class _ExpertTies:
    """Holds the card's MoE routing to the CPU's on the same model and
    inputs.  While installed, every ``moe_dispatch`` call is recorded
    (the CPU run, first) or, after ``follow()``, compared with the
    recorded call of the same index (the card run): where the two pick
    other experts for a token, or the same in another order, that must
    be a near-tie: at the first rank where they differ, the CPU's gap
    between its pick and the card's within the two gates' differences
    (at most twice the largest difference of the token's gates), and
    that difference within GATE_TOL.  The card then dispatches that call
    with the CPU's gates (in training: its own plus the difference as a
    constant, so the gradient through the gates is kept).
    ``forced`` lists (call, group, token, gap, difference); ``close``
    takes the hook off."""

    def __init__(self):
        from repro_torch.models import moe_layer
        self.mod, self.orig = moe_layer, moe_layer.moe_dispatch
        self.seen, self.at, self.forced, self.following = [], 0, [], False
        moe_layer.moe_dispatch = self._dispatch

    def follow(self):
        self.following, self.at = True, 0

    def close(self):
        self.mod.moe_dispatch = self.orig

    def _dispatch(self, gates, top_k, cap):
        if not self.following:
            self.seen.append(gates.detach().cpu())
            return self.orig(gates, top_k, cap)
        ref = self.seen[self.at]
        self.at += 1
        mine = gates.detach().float().cpu()
        # the picks in the order the dispatch's iterated argmax takes them
        # (the order sets each token's slot in its expert)
        pr = ref.topk(top_k, dim=-1).indices
        pm = mine.topk(top_k, dim=-1).indices
        differ = (pr != pm).any(dim=-1)
        if differ.any():
            for g, s in differ.nonzero().tolist():
                r = int((pr[g, s] != pm[g, s]).nonzero()[0])
                a, b = int(pr[g, s, r]), int(pm[g, s, r])
                gap = float(ref[g, s, a] - ref[g, s, b])
                err = float((ref[g, s] - mine[g, s]).abs().max())
                if not (0.0 <= gap <= 2 * err and err <= GATE_TOL):
                    raise AssertionError(
                        f"MoE routing on the card differs from the CPU's "
                        f"beyond a near-tie: call {self.at - 1}, token "
                        f"({g}, {s}), experts {a} / {b}, gap {gap}, "
                        f"difference {err}")
                self.forced.append((self.at - 1, g, s, gap, err))
            ref = ref.to(gates.device)
            # in training the gates keep their gradient: the CPU's values
            # as a constant offset
            gates = (gates + (ref - gates).detach() if gates.requires_grad
                     else ref)
        return self.orig(gates, top_k, cap)


def _moe_teacher_forced(model, params, dev, layout):
    """The reduced llama4-maverick on a (1, 64) cache: a 12-token prompt
    recomputed with the density (padded to 16 rows at 63), then four
    decode steps fed fixed tokens; the mixed layout holds int8 K/V at
    [0, 16) and appends at 16.  -> (logits, K/V of [0, 32), density,
    masses), on the CPU."""
    import numpy as np
    import torch
    from repro_torch.kernels import ref
    rng = np.random.default_rng(SEED + 14)
    cfg = model.cfg
    cache = model.init_cache(1, 64, layout=layout)
    lo = 0
    if layout == "mixed":
        g = torch.Generator().manual_seed(SEED + 15)
        shape = (cfg.n_layers, 1, 16, cfg.n_kv_heads, cfg.head_dim)
        for n in ("k", "v"):
            codes, sc = ref.quantize_token_head_ref(torch.randn(shape,
                                                                generator=g))
            cache[n + "_q"][:, :, :16] = codes.to(dev)
            cache[n + "_scale"][:, :, :16] = sc.to(dev)
        cache["quant_mask"][..., :16] = True
        lo = 16
    n = 12
    t = lambda a: torch.as_tensor(a, dtype=torch.long, device=dev)  # noqa: E731
    toks = t(rng.integers(1, cfg.vocab, n).tolist() + [0] * 4)[None]
    pos = t(list(range(lo, lo + n)) + [63] * 4)
    cache, x, dens = model.recompute(params, toks, pos, cache, lo + n,
                                     want_density=True)
    logits = [(x[:, n - 1] @ model.head_weight(params)).float().cpu()]
    cache["pos"] = torch.tensor(lo + n, device=dev)
    masses = []
    for _ in range(4):
        out, mass = model.decode_step(
            params, t(rng.integers(1, cfg.vocab, (1, 1))), cache,
            want_density=True)
        cache = out.cache
        logits.append(out.logits.float().cpu())
        masses.append(mass.float().cpu())
    kv = torch.cat([cache[n][:, :, :32].float().reshape(-1).cpu()
                    for n in ("k", "v")])
    return torch.cat(logits), kv, dens.float().cpu(), torch.cat(masses)


def _check_moe(layouts=("window", "mixed")):
    """The reduced llama4-maverick (4 experts top-1 + a shared expert)
    teacher-forced on the card against the same port on the CPU: a
    recompute with the density (attn_density on the card, one launch a
    layer), then four decode steps (over the mixed cache: decode_mqattn,
    one launch a layer and token); routing held to the CPU's at expert
    near-ties (``_ExpertTies``).  Logits and K/V within 2% of their
    range, the density and the masses within 1e-3
    (``tests/test_torch_cuda.py::test_cuda_moe_matches_cpu`` runs this
    check too).  -> {layout: {what: (max |diff|, range)}}."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels import attn_density as kad
    from repro_torch.kernels import decode_mqattn as kmq
    cfg = reduced(get_config(MOE["arch"]))
    cpu, params_cpu, gpu, params_gpu = _card_and_cpu(cfg)
    out = {}
    for layout in layouts:
        tag = f"[check] reduced MoE {layout}"
        ties = _ExpertTies()
        try:
            ref_out = _moe_teacher_forced(cpu, params_cpu, "cpu", layout)
            ties.follow()
            kad.reset_launches()
            kmq.reset_launches()
            card_out = _moe_teacher_forced(gpu, params_gpu, gpu.device,
                                           layout)
        finally:
            ties.close()
        diffs = _diffs(("logits", "kv", "density", "mass"), ref_out,
                       card_out, tag)
        rel = {k: d / max(s, 1e-30) for k, (d, s) in diffs.items()}
        if rel["logits"] > 0.02 or rel["kv"] > 0.02 or \
                diffs["density"][0] > 1e-3 or diffs["mass"][0] > 1e-3:
            raise AssertionError(f"{tag}: card vs CPU (max |diff|, range) "
                                 f"{diffs}")
        L = cfg.n_layers
        mq = 4 * L if layout == "mixed" else 0
        if (kad.attn_density.launches, kmq.decode_mqattn.launches) != (L, mq):
            raise AssertionError(f"{tag}: {kad.attn_density.launches} "
                                 f"attn_density and "
                                 f"{kmq.decode_mqattn.launches} decode_mqattn "
                                 f"launches, not {L} and {mq}")
        log(f"{tag} cache, teacher-forced recompute + 4 decode steps: card "
            f"vs CPU (max |diff|, range) {diffs}; tolerance 2% of range "
            f"(logits, K/V), 1e-3 (density, mass); experts forced at "
            f"near-ties (call, group, token, gap, difference): "
            f"{ties.forced}")
        out[layout] = diffs
    return out


def _check_prefill(names=("llama2-7b", MLA["arch"])):
    """``prefill`` of the reduced dense (llama2-7b) and MLA
    (deepseek-v2-lite) models on the card against the same port on the
    CPU, in each of the reference's branches: 40 tokens with the density
    (the served form), and with a window of 12 and 2 sinks without and
    with the density (the flash form); MLA's routing held to the CPU's
    at expert near-ties.  Logits and every layer's K/V (latents) within
    2% of their range, the density within 1e-3; one attn_density launch
    a layer (``tests/test_torch_cuda.py::test_cuda_prefill_matches_cpu``
    runs this check too).  -> {name: {branch: {what: (max |diff|,
    range)}}}."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels import attn_density as kad
    out = {}
    for name in names:
        cfg = reduced(get_config(name))
        cpu, params_cpu, gpu, params_gpu = _card_and_cpu(cfg)
        toks = torch.as_tensor(np.random.default_rng(SEED + 16).integers(
            1, cfg.vocab, (1, 40)))
        leaves = cpu.kv_spec().seq_leaves
        out[name] = {}
        for branch, (window, dens) in {"served": (0, True),
                                       "flash": (12, False),
                                       "flash_density": (12, True)}.items():
            tag = f"[check] reduced {name} prefill, {branch}"
            ties = _ExpertTies()
            try:
                ref_pf = cpu.prefill(params_cpu, {"tokens": toks},
                                     want_density=dens, window=window,
                                     n_sinks=2)
                ties.follow()
                kad.reset_launches()
                card_pf = gpu.prefill(params_gpu,
                                      {"tokens": toks.to(gpu.device)},
                                      want_density=dens, window=window,
                                      n_sinks=2)
            finally:
                ties.close()
            what = ("logits", *leaves) + (("density",) if dens else ())
            def pick(pf):
                return (pf.logits, *(pf.cache[n] for n in leaves),
                        *((pf.density,) if dens else ()))
            diffs = _diffs(what, pick(ref_pf), pick(card_pf), tag)
            bad = [k for k, (d, s) in diffs.items()
                   if d > (1e-3 if k == "density" else 0.02 * s)]
            if bad or kad.attn_density.launches != cfg.n_layers:
                raise AssertionError(f"{tag}: card vs CPU (max |diff|, "
                                     f"range) {diffs}, attn_density launches "
                                     f"{kad.attn_density.launches}")
            log(f"{tag}: card vs CPU (max |diff|, range) {diffs}; tolerance "
                f"2% of range, density 1e-3; experts forced at near-ties "
                f"{ties.forced}")
            out[name][branch] = diffs
    return out


def _check_vlm():
    """The reduced llama-3.2-vision (two blocks of 4 self layers + 1
    cross layer, 16 image tokens of 48; the tanh gates opened to 0.5 /
    -0.75 and 0.25 / 1.0) on the card against the same port on the CPU:
    ``prefill`` of 24 tokens with patches and the density (served form)
    and with a window of 8 and 2 sinks (flash form), then 8 decode steps
    over the prefill's cache, teacher-forced.  Logits, K/V and image K/V
    within 2% of their range, the density within 1e-3; one attn_density
    launch a self layer in each prefill, none in the decode
    (``tests/test_torch_cuda.py::test_cuda_vlm_matches_cpu`` runs this
    check too).  -> {what: (max |diff|, range)}."""
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels import attn_density as kad
    cfg = reduced(get_config(VLM["arch"]))

    def open_gates(params):
        for k, v in (("gate_attn", [0.5, -0.75]), ("gate_ffn", [0.25, 1.0])):
            params["cross_layers"][k] = torch.tensor(v)

    cpu, params_cpu, gpu, params_gpu = _card_and_cpu(cfg, open_gates)
    n_self = cpu._counts()[0]
    g = torch.Generator().manual_seed(SEED + 17)
    toks = torch.randint(1, cfg.vocab, (1, 24), generator=g)
    feed = torch.randint(1, cfg.vocab, (8, 1, 1), generator=g)
    patches = torch.randn((1, cfg.vision.n_image_tokens,
                           cfg.vision.d_vision), generator=g)

    def run(model, params, dev):
        batch = {"tokens": toks.to(dev), "patches": patches.to(dev)}
        launches = []
        kad.reset_launches()
        win = model.prefill(params, batch, want_density=True, window=8,
                            n_sinks=2)
        pf = model.prefill(params, batch, want_density=True)
        launches.append(kad.attn_density.launches)
        cache = model.init_cache(1, 32)
        for n in ("k", "v"):
            cache[n][:, :, :24] = pf.cache[n]
        cache["xk"], cache["xv"] = pf.cache["xk"], pf.cache["xv"]
        cache["pos"] = torch.tensor(24, device=dev)
        logits = [pf.logits]
        for tok in feed:
            o = model.decode_step(params, tok.to(dev), cache)
            cache = o.cache
            logits.append(o.logits)
        launches.append(kad.attn_density.launches)
        return ((torch.cat(logits), cache["k"], cache["v"], pf.cache["xk"],
                 pf.cache["xv"], pf.density, win.logits, win.density),
                launches)

    ref_out, _ = run(cpu, params_cpu, cpu.device)
    card_out, launches = run(gpu, params_gpu, gpu.device)
    tag = "[check] reduced VLM"
    diffs = _diffs(("logits", "k", "v", "xk", "xv", "density",
                    "windowed_logits", "windowed_density"), ref_out,
                   card_out, tag)
    bad = [k for k, (d, s) in diffs.items()
           if d > (1e-3 if "density" in k else 0.02 * s)]
    if bad or launches != [2 * n_self, 2 * n_self]:
        raise AssertionError(f"{tag}: card vs CPU (max |diff|, range) "
                             f"{diffs}; attn_density launches {launches}, "
                             f"not {2 * n_self} in the two prefills and none "
                             "in the decode")
    log(f"{tag} (two prefills + 8 decode steps, gates opened): card vs CPU "
        f"(max |diff|, range) {diffs}; tolerance 2% of range, density 1e-3; "
        f"attn_density launches {launches[0]} in the prefills, none in the "
        f"decode")
    return diffs


def _check_encdec():
    """The reduced whisper-base (2 + 2 layers, 32 frames; biases drawn
    N(0, 0.1^2) so that they count) on the card against the same port on
    the CPU: ``prefill`` of 24 tokens with the frames and the density
    (attn_density's served form, one launch a decoder layer), then 8
    decode steps over the prefill's cache, teacher-forced.  Logits, K/V
    and the cross K/V within 2% of their range, the density within 1e-3;
    no launch in the decode (``tests/test_torch_cuda.py::
    test_cuda_encdec_matches_cpu`` runs this check too).  -> {what: (max
    |diff|, range)}."""
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels import attn_density as kad
    cfg = reduced(get_config(ENCDEC["arch"]))
    g = torch.Generator().manual_seed(SEED + 22)

    def biases(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                biases(v)
            elif k.startswith("b") or k.endswith("_b"):
                tree[k] = torch.randn(v.shape, generator=g) * 0.1

    cpu, params_cpu, gpu, params_gpu = _card_and_cpu(cfg, biases)
    toks = torch.randint(1, cfg.vocab, (1, 24), generator=g)
    feed = torch.randint(1, cfg.vocab, (8, 1, 1), generator=g)
    frames = torch.randn((1, cfg.encoder.n_frames, cfg.d_model),
                         generator=g)

    def run(model, params, dev):
        kad.reset_launches()
        pf = model.prefill(params, {"tokens": toks.to(dev),
                                    "frames": frames.to(dev)},
                           want_density=True)
        launches = [kad.attn_density.launches]
        cache = _cache_after_prefill(model, pf, 24, 32)
        logits = [pf.logits]
        for tok in feed:
            o = model.decode_step(params, tok.to(dev), cache)
            cache = o.cache
            logits.append(o.logits)
        launches.append(kad.attn_density.launches)
        return ((torch.cat(logits), cache["k"], cache["v"], pf.cache["xk"],
                 pf.cache["xv"], pf.density), launches)

    ref_out, _ = run(cpu, params_cpu, cpu.device)
    card_out, launches = run(gpu, params_gpu, gpu.device)
    tag = "[check] reduced whisper-base"
    diffs = _diffs(("logits", "k", "v", "xk", "xv", "density"), ref_out,
                   card_out, tag)
    bad = [k for k, (d, s) in diffs.items()
           if d > (1e-3 if k == "density" else 0.02 * s)]
    L = cfg.n_layers
    if bad or launches != [L, L]:
        raise AssertionError(f"{tag}: card vs CPU (max |diff|, range) "
                             f"{diffs}; attn_density launches {launches}, "
                             f"not {L} in the prefill and none in the decode")
    log(f"{tag} (prefill + 8 decode steps): card vs CPU (max |diff|, range) "
        f"{diffs}; tolerance 2% of range, density 1e-3; attn_density "
        f"launches {launches[0]} in the prefill, none in the decode")
    return diffs


def _check_rglru():
    """The reduced recurrentgemma-2b (5 layers, one of them local MQA
    with a window of 64) on the card against the same port on the CPU:
    ``prefill`` of 96 tokens with the density (attn_density's served
    form under the window, which bites) and of 2,100 (its flash form),
    then 8 decode steps over the 96-token prefill's cache,
    teacher-forced.  Logits, K/V, the conv and lru state within 2% of
    their range, the density within 1e-3; one attn_density launch an
    attention layer in each prefill, none in the decode
    (``tests/test_torch_cuda.py::test_cuda_rglru_matches_cpu`` runs this
    check too).  -> {what: (max |diff|, range)}."""
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels import attn_density as kad
    from repro_torch.models.rglru import _block_counts
    cfg = reduced(get_config(RGLRU["arch"]))
    cpu, params_cpu, gpu, params_gpu = _card_and_cpu(cfg)
    g = torch.Generator().manual_seed(SEED + 23)
    toks = torch.randint(1, cfg.vocab, (1, 2100), generator=g)
    feed = torch.randint(1, cfg.vocab, (8, 1, 1), generator=g)

    def run(model, params, dev):
        kad.reset_launches()
        long = model.prefill(params, {"tokens": toks.to(dev)},
                             want_density=True)
        pf = model.prefill(params, {"tokens": toks[:, :96].to(dev)},
                           want_density=True)
        launches = [kad.attn_density.launches]
        cache = _cache_after_prefill(model, pf, 96, 104)
        logits = [pf.logits]
        for tok in feed:
            o = model.decode_step(params, tok.to(dev), cache)
            cache = o.cache
            logits.append(o.logits)
        launches.append(kad.attn_density.launches)
        return ((torch.cat(logits), cache["k"], cache["v"], cache["conv"],
                 cache["lru"], pf.density, long.logits, long.cache["k"],
                 long.cache["lru"], long.density), launches)

    ref_out, _ = run(cpu, params_cpu, cpu.device)
    card_out, launches = run(gpu, params_gpu, gpu.device)
    tag = "[check] reduced recurrentgemma-2b"
    diffs = _diffs(("logits", "k", "v", "conv", "lru", "density",
                    "long_logits", "long_k", "long_lru", "long_density"),
                   ref_out, card_out, tag)
    bad = [k for k, (d, s) in diffs.items()
           if d > (1e-3 if "density" in k else 0.02 * s)]
    n_attn = _block_counts(cfg)[1]
    if bad or launches != [2 * n_attn, 2 * n_attn]:
        raise AssertionError(f"{tag}: card vs CPU (max |diff|, range) "
                             f"{diffs}; attn_density launches {launches}, "
                             f"not {2 * n_attn} in the two prefills and none "
                             "in the decode")
    log(f"{tag} (prefills of 96 and 2,100 tokens + 8 decode steps): card vs "
        f"CPU (max |diff|, range) {diffs}; tolerance 2% of range, density "
        f"1e-3; attn_density launches {launches[0]} in the prefills, none "
        f"in the decode")
    return diffs


def _check_config(name):
    """The reduced ``name`` teacher-forced on the card against the same
    port on the CPU, over the bf16 page view, the mixed page view and the
    all-int8 decode cache."""
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels import attn_density as kad
    from repro_torch.kernels import decode_mqattn as kmq
    from repro_torch.kernels import decode_qattn as kdq
    from repro_torch.kernels import ref

    cfg = reduced(get_config(name))
    what = (f"reduced {name} (H {cfg.n_heads} / KV {cfg.n_kv_heads}"
            f"{', tied head' if cfg.tie_embeddings else ''})")
    cpu, params_cpu, gpu, params_gpu = _card_and_cpu(cfg)
    L, KV, hd, cs = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim, 16
    g = torch.Generator().manual_seed(SEED)
    shape = (L, 10, cs, KV, hd)
    views = {"bf16": {n: torch.zeros(shape, dtype=torch.bfloat16)
                      for n in ("k16", "v16")}}
    mixed = {}
    for n in ("k", "v"):
        mixed[n + "16"] = torch.randn(shape, generator=g).bfloat16()
        mixed[n + "8"], mixed[n + "8s"] = ref.quantize_token_head_ref(
            torch.randn(shape, generator=g))
    views["mixed"] = mixed
    for view, arenas0 in views.items():
        kmq.reset_launches()
        kad.reset_launches()
        ref_l = _teacher_forced(cpu, params_cpu, "cpu", arenas0,
                                view == "mixed")
        card_l = _teacher_forced(gpu, params_gpu, "cuda", arenas0,
                                 view == "mixed")
        span = float(ref_l.abs().max())
        worst = float((ref_l - card_l).abs().max())
        if not torch.isfinite(card_l).all() or worst > 0.02 * span + 1e-3:
            raise AssertionError(
                f"{what} {view} view: card logits differ from the CPU plain "
                f"path: max |diff| {worst} over range {span}")
        if view == "mixed" and kmq.decode_mqattn.launches != 4 * L:
            raise AssertionError(
                f"{what} mixed view: {kmq.decode_mqattn.launches} "
                f"decode_mqattn launches, not {4 * L}")
        if kad.attn_density.launches != L:
            raise AssertionError(
                f"{what} {view} view: {kad.attn_density.launches} "
                f"attn_density launches in the extend, not {L}")
        log(f"[check] {what}, {view} page view, teacher-forced extend "
            f"(attn_density on the card) + 4 decode rounds: card vs CPU max "
            f"|logit diff| {worst:.5f} (range {span:.4f}, tolerance 2% of "
            f"range: bf16 matmuls round differently)")
    kdq.reset_launches()
    ref_l, ref_m = _teacher_forced_int8(cpu, params_cpu, "cpu")
    card_l, card_m = _teacher_forced_int8(gpu, params_gpu, "cuda")
    span = float(ref_l.abs().max())
    worst = float((ref_l - card_l).abs().max())
    worst_m = float((ref_m - card_m).abs().max())
    if not torch.isfinite(card_l).all() or worst > 0.02 * span + 1e-3 \
            or worst_m > 1e-3:
        raise AssertionError(
            f"{what} int8 cache: card logits differ from the CPU plain path: "
            f"max |diff| {worst} over range {span}, max |d mass| {worst_m}")
    if kdq.decode_qattn.launches != 8 * L:
        raise AssertionError(f"{what} int8 cache: "
                             f"{kdq.decode_qattn.launches} decode_qattn "
                             f"launches, not {8 * L}")
    log(f"[check] {what}, all-int8 decode cache, teacher-forced 8 rounds of "
        f"2 rows ((B,) pos): card vs CPU max |logit diff| {worst:.5f} "
        f"(range {span:.4f}, tolerance 2% of range), max |d mass| "
        f"{worst_m:.3g} (tolerance 1e-3: bf16 K/V and p upstream)")


# the L2-cold readings of the decode kernels' timed rows (kernel and
# library) and the library's own bytes bound
COLD_KEYS = ("device_ms_l2_cold", "device_ms_by_kernel_l2_cold",
             "library_device_ms_l2_cold", "library_kernels",
             "library_bytes_bound_ms", "library_below_its_bytes_bound")


def _device_or_call(row, prefix):
    """The profiler's device time where it recorded one, else the
    event-timed time per call."""
    dev = row[prefix + "device_ms"]
    return dev if dev is not None else row[prefix + "call_ms"]


def _router_launches(routed, key):
    """A kernel's launches in the router phase's runs (llama2-7b with the
    bf16 pool and quant-resident, smollm-360m), each counted from 0."""
    return {"launches_router": {label: routed[label]["launches"][key]
                                for label in ("bf16", "quant", "gqa")}}


def _slot_launches(slots, key):
    """A kernel's launches in the slot phase's runs, each counted from 0
    just before the run and read just after it."""
    return {"launches_slot": {label: run["launches"][key]
                              for label, run in slots.items()}}


def _rwkv_zoo_launches(rwkv, zoo, key):
    """A kernel's launches in the RWKV6 phase's runs (rwkv6-1.6b at full
    width: none may launch) and in the zoo phase's runs, each counted
    from 0 just before the run and read just after it."""
    return {"launches_rwkv": {label: run["launches"][key]
                              for label, run in rwkv.items()},
            "launches_zoo": {label: run["launches"][key]
                             for label, run in zoo.items()}}


def _later_launches(mla, prefill, vlm, moe, key):
    """A kernel's launches in the later slices' runs, each counted from 0
    just before the run and read just after it: the MLA phase
    (deepseek-v2-lite-16b), the prefill check (llama2-7b at 512 and 4096
    tokens), the VLM phase (its prefill, then prefill and 32 decode
    tokens) and the MoE phase (llama4-maverick at depth 2)."""
    return {"launches_mla": {label: run["launches"][key]
                             for label, run in mla.items()},
            "launches_prefill": {S: run["launches"][key]
                                 for S, run in prefill["runs"].items()},
            "launches_vlm": {"prefill": vlm["launches_prefill"][key],
                             "prefill_and_decode": vlm["launches"][key]},
            "launches_moe": {label: run["launches"][key]
                             for label, run in moe.items()}}


def _new_family_launches(encdec, rglru, key):
    """A kernel's launches in the encdec and rglru phases' reruns, each
    counted from 0 just before the prefill and read after it and after
    the decode."""
    return {"launches_encdec": {
                "prefill": encdec["launches_prefill"][key],
                "prefill_and_decode": encdec["launches"][key]},
            "launches_rglru": {
                S: {"prefill": run["launches_prefill"][key],
                    "prefill_and_decode": run["launches"][key]}
                for S, run in rglru.items()}}


def _slot_graph_summary(slots, mla, rwkv, moe, zoo):
    """Log, for the slot engines' phases, the graphs captured ahead and
    at a key's first call, their seconds (also by entry: the pipelined
    restores' apart) and the pool's bytes, summed over each phase's
    services; and the figures the slot graphs should move: each run's
    per-call wall median and the profiled decode token's wall, busy and
    idle share."""
    out = {}
    for tag, phase in (("slot", slots), ("mla", mla), ("rwkv", rwkv),
                       ("moe", moe)):
        gs = [v["graphs"] for v in phase.values()]
        out[tag] = {
            "services": len(gs),
            "captures": sum(sum(g["captures"].values()) for g in gs),
            "late_captures": sum(g["late_captures"] for g in gs),
            "capture_s": sum(g["capture_s"] for g in gs),
            "late_capture_s": sum(g["late_capture_s"] for g in gs),
            "pool_bytes_max": max(g["pool_bytes"] for g in gs),
            "peak_reserved_max": max((v["peak_bytes"] or {}).get(
                "reserved", 0) for v in phase.values()),
            "by_entry": {e: {k: sum(g["by_entry"].get(e, {}).get(k, 0)
                                    for g in gs)
                             for k in ("captures", "capture_s",
                                       "late_captures")}
                         for e in sorted({e for g in gs
                                          for e in g["by_entry"]})},
            "call_ms_median": {k: _median_of(v) for k, v in phase.items()},
            "decode_token": {k: {m: v["prof"]["decode token"].get(m)
                                 for m in ("wall_ms", "device_ms",
                                           "idle_share", "kernels")}
                             for k, v in phase.items()
                             if v.get("prof", {}).get("decode token")}}
    gs = [g for v in zoo.values() for g in v["graphs"].values()]
    out["zoo"] = {"services": len(gs),
                  "captures": sum(sum(g["captures"].values()) for g in gs),
                  "late_captures": sum(g["late_captures"] for g in gs),
                  "capture_s": sum(g["capture_s"] for g in gs),
                  "pool_bytes_max": max(g["pool_bytes"] for g in gs)}
    log("[graphs] slot engines " + json.dumps(out))


def _median_of(run):
    """A run's per-call wall median in ms (its records' ``wall_s``, else
    its ``wall_ms``)."""
    walls = sorted(r["wall_s"] * 1e3 for r in run.get("records", [])
                   if "wall_s" in r) or sorted(run.get("wall_ms") or [])
    return walls[len(walls) // 2] if walls else None


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "src"))
    import repro_torch  # noqa: F401  (fails where the repo is absent)

    t_start = time.perf_counter()
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    smi = build_phase()
    max_err, times = kernel_phase()
    mla_codec = codec_leaves_phase("MLA", MLA_CODEC_SHAPES, 8)
    moe_codec = {b: codec_leaves_phase("MoE", MOE_CODEC_SHAPES, b)
                 for b in (8, 4, 2)}
    mq_err, mq_times = mqattn_phase()
    ad_err, ad_times = attn_phase()
    st_err, st_row = stats_phase()
    dq_err, dq_times = qattn_phase()
    gate_phase()
    from repro_torch.configs import get_config
    model, params = build_weights(get_config("llama2-7b"), SEED)
    runs = {}
    with tempfile.TemporaryDirectory(prefix="llms_chip_smoke_") as root:
        for label, quant in (("run1", False), ("rerun", False),
                             ("quant1", True), ("quant-rerun", True)):
            runs[label] = serve_phase(model, params, SEED, root, label,
                                      quant_resident=quant)
    int8 = [int8_decode_phase(model, params, SEED, label,
                              profiled=label == "run1")
            for label in ("run1", "rerun")]
    t_router = time.perf_counter()
    routed = {}
    with tempfile.TemporaryDirectory(prefix="llms_chip_router_") as root:
        for label, kw in (
                ("bf16", dict(profiled=True)),
                ("bf16-rerun", dict(keep_logits=True)),
                ("quant", dict(quant_resident=True, profiled=True)),
                ("quant-rerun", dict(quant_resident=True)),
                ("aot-hint", dict(policy="llms_nolife")),
                ("serial", dict(decode_batch=1, keep_logits=True))):
            routed[label] = router_phase(model, params, SEED, root, label,
                                         ROUTER["calls"], **kw)
    t_slot = time.perf_counter()
    slots = {}
    with tempfile.TemporaryDirectory(prefix="llms_chip_slot_") as root:
        slots["no-pressure"] = slot_phase(model, params, SEED, root,
                                          "no-pressure", split="forced",
                                          budget_chunks=1 << 20)
        slots["llms"] = slot_phase(model, params, SEED, root, "llms")
        slots["llms-rerun"] = slot_phase(model, params, SEED, root,
                                         "llms-rerun",
                                         profile=slots["llms"]["profile"])
        slots["llms-forced"] = slot_phase(model, params, SEED, root,
                                          "llms-forced", split="forced",
                                          profile_restore=True)
        for policy in ("llms_nopipe", "swap", "lmk"):
            slots[policy] = slot_phase(model, params, SEED, root, policy,
                                       policy=policy)
        slots["quant"] = slot_phase(model, params, SEED, root, "quant",
                                    quant_resident=True, split="forced")
        checks = [pipelined_check(model, params, root, quant_resident=q)
                  for q in (False, True)]
        eager_entries_check(model, params, root)
    _same_slot_run(slots["llms"], slots["llms-rerun"],
                   "llms (the card's profile)")
    for label, run in slots.items():
        if label == "no-pressure":
            continue
        counts, examined = _slot_divergence(run, slots["no-pressure"])
        log(f"[slot] {label} against the no-pressure run, call by call: "
            f"{counts}")
        for e in examined:
            log(f"[slot] {label} first divergence: {json.dumps(e)}")
    for label, run in slots.items():
        run.pop("picks")
        d = run["disk_switch_ms"]
        log(f"[slot] {label}: switch_s over {len(d)} disk restores median "
            f"{d[len(d) // 2] if d else None} ms, max "
            f"{d[-1] if d else None} ms; {len(run['pipelined'])} pipelined "
            f"restores; {run['run_s']:.2f} s for 12 calls")
    log(f"[slot] the slot phases took {time.perf_counter() - t_slot:.1f} s")
    t_prefill = time.perf_counter()
    prefill = prefill_check(model, params)
    log(f"[prefill] the prefill check took "
        f"{time.perf_counter() - t_prefill:.1f} s")
    del model, params
    torch.cuda.empty_cache()
    model, params = build_weights(get_config("smollm-360m"), SEED)
    with tempfile.TemporaryDirectory(prefix="llms_chip_gqa_") as root:
        for label in ("gqa", "gqa-rerun"):
            routed[label] = router_phase(model, params, SEED, root, label,
                                         ROUTER["gqa_calls"])
        entry_point_phase(root)
    del model, params
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="llms_chip_mla_") as root:
        mla, mla_weights = mla_runs(root)
    rwkv_weights = build_weights(get_config(RWKV["arch"]), SEED)
    with tempfile.TemporaryDirectory(prefix="llms_chip_rwkv_") as root:
        rwkv = rwkv_runs(root, *rwkv_weights)
    zoo = zoo_runs({"dense": build_weights(get_config("llama2-7b"), SEED),
                    "mla_moe": mla_weights, "rwkv6": rwkv_weights})
    del mla_weights, rwkv_weights
    gc.collect()
    torch.cuda.empty_cache()
    vlm = vlm_phase()
    with tempfile.TemporaryDirectory(prefix="llms_chip_moe_") as root:
        moe = moe_runs(root)
    encdec = encdec_phase()
    rglru = rglru_phase()
    with tempfile.TemporaryDirectory(prefix="llms_chip_train_") as root:
        train = train_phase(root)
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="llms_chip_dryrun_") as root:
        dry = dryrun_phase(root)
    for a, b in (("bf16", "bf16-rerun"), ("quant", "quant-rerun"),
                 ("gqa", "gqa-rerun")):
        _same_run(routed[a], routed[b], f"{a} (llama2-7b)" if a != "gqa"
                  else "smollm-360m")
    share, same, total = _batch_agreement(routed["bf16"], routed["serial"])
    log(f"[router] decode_batch 4 against 1 on the card, bf16 pool: "
        f"{same} of {total} tokens agree ({share:.4f}); not required (the "
        f"products at M = 4 and M = 1 may round differently)")
    counts, examined = _batch_divergence(routed["bf16-rerun"],
                                         routed["serial"])
    log(f"[router] decode_batch 4 against 1, call by call: {counts}")
    for e in examined:
        log(f"[router] first divergence: {json.dumps(e)}")
    for label in ("bf16-rerun", "serial"):
        routed[label].pop("picks")
    log(f"[router] the router phases took "
        f"{time.perf_counter() - t_router:.1f} s")
    log("[graphs] summary " + json.dumps(
        {f"serve:{k}": dict(v["graphs"], peak_bytes=v["peak_bytes"])
         for k, v in runs.items()}
        | {f"router:{k}": dict(v["graphs"], peak_bytes=v["peak_bytes"])
           for k, v in routed.items()}
        | {f"{tag}:{k}": dict(v["graphs"], peak_bytes=v["peak_bytes"])
           for tag, phase in (("slot", slots), ("mla", mla), ("rwkv", rwkv),
                              ("moe", moe))
           for k, v in phase.items()}
        | {f"zoo:{k}:{fam}": dict(g, peak_bytes=v["peak_bytes"])
           for k, v in zoo.items() for fam, g in v["graphs"].items()}))
    _slot_graph_summary(slots, mla, rwkv, moe, zoo)
    for a_name, b_name in (("run1", "rerun"), ("quant1", "quant-rerun")):
        for a, b in zip(runs[a_name]["records"], runs[b_name]["records"]):
            if (a["tokens"], a["bits"]) != (b["tokens"], b["bits"]):
                raise AssertionError(f"{b_name} differs: {a} vs {b}")
        log(f"[serve] {b_name} from the same seed: identical tokens and bit "
            f"plans over {len(runs[a_name]['records'])} calls")
    if not (int8[0]["tokens"] == int8[1]["tokens"]
            and torch.equal(int8[0]["mass"], int8[1]["mass"])):
        raise AssertionError("the int8 decode rerun differs")
    log("[int8] rerun from the same seed: identical tokens and masses")
    first, quant = runs["run1"], runs["quant1"]
    train_checks = check_phase()
    log("[train] summary " + json.dumps({
        k: {f: train[k][f] for f in ("step_wall_s_median", "tokens_per_s",
                                     "peak_gib", "losses",
                                     "model_tflops_per_s") if f in train[k]}
        for k in ("a", "b", "c", "d_rerun", "d_resume")} | {
        k: train[k] for k in ("model_flops_a_step", "optimizer_ms",
                              "optimizer_8bit_ms", "rerun_bit_identical",
                              "resume")} | {"profile": train["a"]["profile"]}))

    src = "src/repro_torch/csrc/chunk_quant.cu"
    kernels = []
    for name, line in (("quantize", 88), ("dequantize", 113)):
        row = times[4][name]
        kernels.append({
            "name": f"chunk_{name}", "route": "cuda", "source": src,
            **_router_launches(routed, name), **_slot_launches(slots, name),
            "replaces": f"src/repro/kernels/chunk_quant.py:{line}",
            "launches": first["launches"][name], "max_abs_err": max_err,
            "ms": _device_or_call(row, ""),
            "plain_ms": _device_or_call(row, "plain_"),
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None,
            "shape": f"({SERVE_SHAPE[0]},{SERVE_SHAPE[1]}) bf16 4-bit",
            "call_ms": row["call_ms"], "plain_call_ms": row["plain_call_ms"],
            "ms_by_bits": {b: _device_or_call(times[b][name], "")
                           for b in (8, 4, 2)},
            "bound_ms_by_bits": {b: times[b][name]["bound_ms"]
                                 for b in (8, 4, 2)},
            "launches_quant_resident": quant["launches"][name],
            **_later_launches(mla, prefill, vlm, moe, name),
            **_new_family_launches(encdec, rglru, name),
            **_dryrun_launches(dry, name),
            **_rwkv_zoo_launches(rwkv, zoo, name),
            "mla_8bit": (mla_codec["quantize_two_leaves"] if name ==
                         "quantize" else mla_codec["dequantize"]),
            "moe_leaves_by_bits": {
                b: (moe_codec[b]["quantize_two_leaves"] if name ==
                    "quantize" else moe_codec[b]["dequantize"])
                for b in (8, 4, 2)},
        })
    kernels[0].update({
        "two_leaves_ms_by_bits": {
            b: _device_or_call(times[b]["quantize_two_leaves"], "")
            for b in (8, 4, 2)},
        "two_leaves_as_two_launches_ms_by_bits": {
            b: times[b]["quantize_two_leaves"]["per_leaf_device_ms"]
            for b in (8, 4, 2)},
        "two_leaves_bound_ms_by_bits": {
            b: times[b]["quantize_two_leaves"]["bound_ms"]
            for b in (8, 4, 2)},
        "switch_out_host_ms": times["switch_out_host_ms"],
        "launches_per_chunk": first["launches"]["quantize_per_chunk"],
        "launches_per_switch_out": first["launches"][
            "quantize_per_switch_out"],
    })
    row, long_row = mq_times
    kernels.append({
        "name": "decode_mqattn", "route": "cuda",
        "source": "src/repro_torch/csrc/decode_mqattn.cu",
        **_router_launches(routed, "decode_mqattn"),
        **_slot_launches(slots, "decode_mqattn"),
        **_later_launches(mla, prefill, vlm, moe, "decode_mqattn"),
        **_new_family_launches(encdec, rglru, "decode_mqattn"),
        **_dryrun_launches(dry, "decode_mqattn"),
        **_rwkv_zoo_launches(rwkv, zoo, "decode_mqattn"),
        "replaces": "src/repro/kernels/decode_qattn.py:183",
        "launches": quant["launches"]["decode_mqattn"],
        "max_abs_err": mq_err["out"], "max_abs_err_mass": mq_err["mass"],
        "ms": _device_or_call(row, ""),
        "plain_ms": _device_or_call(row, "plain_"),
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": _device_or_call(row, "library_"),
        "library_call": "F.scaled_dot_product_attention over the pre-"
                        "selected bf16 K/V: out only, no dequant, select "
                        "or mass",
        "shape": f"{row['shape']} {row['form']} + mass, half quant, "
                 "n_valid = S",
        "call_ms": row["call_ms"], "plain_call_ms": row["plain_call_ms"],
        **{k: row[k] for k in COLD_KEYS},
        "at_4096": {k: long_row[k] for k in (
            "shape", "form", "device_ms", "call_ms", "plain_device_ms",
            "plain_call_ms", "library_device_ms", "library_call_ms",
            "bound_ms", "bound_by", *COLD_KEYS)},
    })
    mla_keys = ("shape", "form", "density", "device_ms", "call_ms",
                "plain_device_ms", "plain_call_ms", "library_device_ms",
                "library_call_ms", "bound_ms", "bound_by")
    mla_rows = {"out": [(f"over {S_m}", f"mla_{S_m}")
                        for S_m in AD_MLA["S"]],
                "density": [(f"over {S_m}", f"mla_{S_m}_density")
                            for S_m in AD_MLA["S"]]
                + [("lmk whole recompute", "mla_lmk_density")]}
    for name, line, key, launches, err in (
            ("attn_density_out", 128, "out", first["launches"]
             ["attn_density"], ad_err["out"]),
            ("attn_density_mass", 156, "density", first["launches"]
             ["attn_density_with_density"], ad_err["density"])):
        row = ad_times[key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/attn_density.cu",
            **_router_launches(routed, "attn_density" if key == "out"
                               else "attn_density_with_density"),
            **_slot_launches(slots, "attn_density" if key == "out"
                             else "attn_density_with_density"),
            "replaces": f"src/repro/kernels/attn_density.py:{line}",
            "launches": launches, "max_abs_err": err,
            "pipelined_restore_full_width": {
                k: [c.get(k) for c in checks] for k in (
                    "wall_s", "restore_s", "feed_wait_s", "first_wait_s",
                    "feed_alone_s", "inserts_s", "recompute_alone_s",
                    "eager_wall_s", "sync_warnings", "graph",
                    "attn_density_launches", "feed_gate_launches",
                    "profile")},
            "ms": _device_or_call(row, ""),
            "plain_ms": _device_or_call(row, "plain_"),
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": (_device_or_call(row, "library_") if key == "out"
                           else None),
            "library_call": ("F.scaled_dot_product_attention with the "
                             "boolean mask: out only" if key == "out"
                             else None),
            "shape": f"{row['shape']}, {row['form']} form"
                     f"{' + density' if row['density'] else ''}",
            "call_ms": row["call_ms"], "plain_call_ms": row["plain_call_ms"],
            "launches_quant_resident": quant["launches"][
                "attn_density" if key == "out"
                else "attn_density_with_density"],
            **_later_launches(mla, prefill, vlm, moe,
                              "attn_density" if key == "out"
                              else "attn_density_with_density"),
            **_new_family_launches(encdec, rglru, "attn_density" if key ==
                                   "out" else "attn_density_with_density"),
            **_dryrun_launches(dry, "attn_density" if key == "out"
                               else "attn_density_with_density"),
            "new_family_shapes": ad_times["new_families"],
            "dryrun_shapes": {k: r for k, r in dry["kernel_rows"].items()
                              if r["form"] == "flash"
                              and r.get("route") == "mma"
                              and (key == "out" or r["density"])},
            **({"stats_shape": (st_row if st_row.get("route") == "mma"
                                else None),
                "max_err_stats": st_err,
                "launches_train_per_step": {
                    k: [st["launches"]["attn_density_stats"]
                        for st in train[k]["steps"]]
                    for k in ("a", "b", "c", "d_rerun", "d_resume")},
                "launches_train_checks": {
                    c: v[3] for c, v in
                    train_checks["train_families"].items()}}
               if key == "out" else {}),
            "library_call_new_family_shapes": "F.scaled_dot_product_"
                                              "attention with the boolean "
                                              "mask: out only",
            **_rwkv_zoo_launches(rwkv, zoo, "attn_density" if key == "out"
                                 else "attn_density_with_density"),
            "mla_shapes": {label: {k: ad_times[src][k] for k in mla_keys}
                           for label, src in mla_rows[key]},
            "prefill_shapes": {label: r for label, r in
                               prefill["rows"].items()
                               if r["density"] == (key == "density")
                               and r.get("route") == "mma"},
            "library_call_prefill": "F.scaled_dot_product_attention("
                                    "is_causal=True): out only",
            **{name: {k: ad_times[src][k] for k in (
                "shape", "form", "route", "device_ms", "call_ms",
                "plain_device_ms", "library_device_ms", "bound_ms",
                "bound_by")}
               for name, src in (("long_append", "long"),
                                 ("pallas_setting", "pallas"),
                                 ("slot_recompute_set", "slot"),
                                 ("lmk_whole_recompute", "lmk"))},
        })
    # csrc/attn_flash.cu: the flash form at head dims 64 and 128, timed at
    # llama2-7b's 4096-token prefill (out only, and with the density: the
    # forward and the density pass), launched by the 4096-token prefill
    flash_rows = {label: r for label, r in (
        list(prefill["rows"].items()) + list(dry["kernel_rows"].items())
        + [(st_row["shape"], st_row)]) if r.get("route") == "wgmma"}
    for name, line, label, key in (
            ("attn_flash_fwd", 128, "dense (1,4096,32,32,128) causal flash",
             "attn_flash"),
            ("attn_flash_mass", 156,
             "dense (1,4096,32,32,128) causal flash + density",
             "attn_flash_with_density")):
        row = prefill["rows"][label]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/attn_flash.cu",
            "replaces": f"src/repro/kernels/attn_density.py:{line}",
            "launches": prefill["runs"][4096]["launches"][key],
            "max_abs_err": row["max_abs_err"],
            "ms": _device_or_call(row, ""),
            "plain_ms": _device_or_call(row, "plain_"),
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": (_device_or_call(row, "library_")
                           if key == "attn_flash" else None),
            "library_call": ("F.scaled_dot_product_attention(is_causal="
                             "True): out only" if key == "attn_flash"
                             else None),
            "shape": f"{label} (the call: the forward"
                     f"{' and the density pass' if row['density'] else ''})",
            "call_ms": row["call_ms"], "plain_call_ms": row["plain_call_ms"],
            "ms_by_kernel": row["device_ms_by_kernel"],
            "density_pass_ms": (sum(v for k, v in
                                    row["device_ms_by_kernel"].items()
                                    if any(m in k for m in
                                           FLASH_MASS_KERNELS))
                                if row["density"] else None),
            **_later_launches(mla, prefill, vlm, moe, key),
            **_new_family_launches(encdec, rglru, key),
            **_dryrun_launches(dry, key),
            "launches_train_per_step": {
                k: [st["launches"][key] for st in train[k]["steps"]]
                for k in ("a", "b", "c", "d_rerun", "d_resume")},
            "flash_shapes": {k: {f: r.get(f) for f in (
                "density", "stats", "max_err_rel", "device_ms", "call_ms",
                "plain_device_ms", "library_device_ms", "library_call_ms",
                "bound_ms", "bound_by", "device_ms_by_kernel")}
                for k, r in flash_rows.items()
                if r["density"] == (key != "attn_flash")},
        })
    row, long_row = dq_times
    kernels.append({
        "name": "decode_qattn", "route": "cuda",
        "source": "src/repro_torch/csrc/decode_mqattn.cu",
        "replaces": "src/repro/kernels/decode_qattn.py:84",
        **_slot_launches(slots, "decode_qattn"),
        **_later_launches(mla, prefill, vlm, moe, "decode_qattn"),
        **_new_family_launches(encdec, rglru, "decode_qattn"),
        **_dryrun_launches(dry, "decode_qattn"),
        **_rwkv_zoo_launches(rwkv, zoo, "decode_qattn"),
        "launches": int8[0]["launches"],
        "max_abs_err": dq_err["out"], "max_abs_err_mass": dq_err["mass"],
        "ms": _device_or_call(row, ""),
        "plain_ms": _device_or_call(row, "plain_"),
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": _device_or_call(row, "library_"),
        "library_call": "F.scaled_dot_product_attention over the "
                        "dequantized bf16 K/V: out only, no mass",
        "shape": f"{row['shape']} {row['form']} + mass, n_valid = S",
        "call_ms": row["call_ms"], "plain_call_ms": row["plain_call_ms"],
        **{k: row[k] for k in COLD_KEYS},
        "at_4096": {k: long_row[k] for k in (
            "shape", "form", "device_ms", "call_ms", "plain_device_ms",
            "plain_call_ms", "library_device_ms", "library_call_ms",
            "bound_ms", "bound_by", *COLD_KEYS)},
        "dryrun_shapes": {k: r for k, r in dry["kernel_rows"].items()
                          if r["form"] == "select"},
        "library_call_dryrun_shapes": "F.scaled_dot_product_attention "
                                      "over the dequantized bf16 K/V with "
                                      "the boolean mask of the valid keys: "
                                      "out only",
        "int8_decode_ms_per_token": sorted(int8[0]["per_token_ms"])[
            len(int8[0]["per_token_ms"]) // 2],
        "int8_decode_profiled_token": int8[0]["profile"],
    })
    log("[dryrun] summary " + json.dumps({
        "meta": {m: {k: v for k, v in c.items()
                     if k != "argument_gib_a_device"}
                 for m, c in dry["meta"].items()},
        "runs": {label: {k: run[k] for k in (
            "batch", "seq", "n_layers", "reduced", "wall_s", "peak_bytes",
            "argument_bytes", "model_flops_per_s", "repeat_identical",
            "max_err_vs_plain")}
            for label, run in dry["runs"].items()}}))
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}), flush=True)      # the one card this run used
    return 0


if __name__ == "__main__":
    sys.exit(main())
