#!/usr/bin/env python3
"""The PyTorch/CUDA port on one NVIDIA card: build, check, serve, train.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:

  0. device: the card's name and power limit (nvidia-smi), torch and
     CUDA versions; TF32 off for matmuls and convolutions.
  1. build: every kernel of the port from ``src/repro_torch/kernels/csrc``
     (one nvcc per source, in parallel).
  2. kernels against their plain versions on the card, over a grid of
     shapes (attention: tolerance 1e-4 in float32, 2e-2 in bfloat16;
     the four coded-combine kernels: every output row within 1e-5 of
     its max |plain|; the attention grids at the GQA groups of every
     served config, G ∈ {1, 2, 3, 4, 5, 6, 8, 10, 12}, Dh up to 256 in
     both dtypes, and at gemma3's window of 1024: flash at S = 2048,
     decode over a wrapped 1024-slot ring; at recurrentgemma's window of
     2048, G 10, Kv 1, Dh 256: flash at S = 4096, decode over a wrapped
     2048-slot ring; whisper's cross-attention: flash non-causal with S
     ∈ {1, 64, 1000} queries over T ∈ {17, 1500} keys at G 1 and 6, Dh 64
     and 128, decode over a full 1500-slot cache at q_pos 1499),
     then checked and timed at the main paths' shapes (the attention
     kernels also at each served config's, beside SDPA, and at
     recurrentgemma's: decode at its served prompt, flash at the
     training shape and at S = 4096, where its window bites; whisper's
     and qwen2-vl's: flash over the encoder's 1500 frames and the
     cross-attention's 64 × 1500 (non-causal, beside SDPA without a
     mask) and at qwen2-vl's serve prompt (G 6), decode over the cross
     cache at q_pos 1499, whisper's self-attention cache and qwen2-vl's
     at its serve shape; the combine
     kernels: K = 2 pods × the 525M-value embedding
     leaf, block 64, for the int8/int4/fp8 hop; R = 8 and R = 1 by
     K = 8 × the 117M-value ``mlp.wd`` leaf for the f32 encode/decode,
     beside ``torch.mm`` with TF32 off; the f32 kernel also at its own
     edges: K ∈ {1, 13, 40, 64, 200}, F ∈ {3, 64, 4162}, rows 8 bytes
     off or padded); the flash kernel's per-row
     log-sum-exp against the plain version's, and the flash kernel timed
     at the training shape too (S = 512, with its log-sum-exp); the f32
     combine at the evaluation shape (R = 1, K = 40, F = 845,738) with
     16-byte-aligned (padded) and packed rows, beside ``torch.mm``, each
     time with its share of the bound; the four MoE shuffle passes
     (dispatch, combine and their backward passes, bf16) at granite-moe's
     training group (N 16,384, top-8 of 40 experts, cap 4,096, d 1,536)
     and maverick's served prompt (N 4,096, top-1 of 128, d 5,120), on
     a routing that drops 8-10% of the entries: the dispatch equal to
     the plain version, every other row within 2e-2 of its max |plain|,
     each timed beside the plain version (its forward ops and their
     autograd backward) and its bound; the
     decode kernel's split of the cache sweep at the serve shape is
     printed.  For attention, besides the grid's
     tolerance, every output row (the Dh features of one query and head)
     must be within a share of its own max |plain| (decode 1e-2, flash
     2e-2: one bf16 rounding is at most 2^-7 of it); timed beside the
     plain version, the least time the card could take (bound) and one
     PyTorch library call (``scaled_dot_product_attention``, timed only
     as a yardstick).  The attention kernels and SDPA are timed as
     calls captured in a CUDA graph (device time: from Python the ~20 us
     decode would time the host), the plain versions and the combine
     kernels back to back with CUDA events.  The combine kernels are
     timed in turns with ``torch.mm`` (at the evaluation shape padded,
     packed, ``torch.mm`` twice, packed, padded), each time the less of
     its two turns: the first turn after a shape's tensors are made
     can read slow.
  3. full-width parity: llama3-8b at full width cut to 2 layers, float32,
     seeded weights on the card and on the CPU; bulk prefill of 2 × 64
     tokens then 8 greedy decode steps on the card, the CPU run
     teacher-forced on the card's tokens; logits agree within
     2e-3 · max|logit|.
  4. the main path: ``repro_torch.launch.serve.main`` serves the full
     llama3-8b (32 layers, bf16, random weights from the seed) to
     4 × 1024-token prompts for 32 tokens, once to warm up and once
     counted; the kernels' launch counts over the counted run must be
     exactly 32 (flash) and 1024 (decode).  A third request runs under
     ``torch.profiler``: its device time in the prefill and in the decode
     (split by the serve CLI's profiler spans), over the counted run's
     host times, is the share of each phase the device was busy.
  4b. archs: the five configs beside llama3-8b.  Card against CPU at
     full width in float32, cut to the fewest layers that hold every kind
     of layer (granite-8b, starcoder2-3b, granite-moe, maverick 2: one
     dense and one MoE; gemma3 6: five local and a global), as phase 3,
     with each MoE routing recorded on both sides (route flips counted;
     a row whose kept experts differ is left out of the check, at most
     1%).  Each served at full width in bf16 through the serve CLI as
     phase 4 (batch 4, 32 tokens, 1024-token prompts, gemma3's 2048 so
     its window bites; ``--layers`` cuts gemma3 to 32 layers, granite-moe
     to 8 and maverick to 2, all 48 being ~800 GB): exact launches, host
     times, peak
     memory, profiled device time (the profiled request has 8 new
     tokens: reading its trace back costs seconds a decode step).
     gemma3 cut to 6 layers with a
     1088-token prompt: the bulk handoff (rings trimmed to the window)
     and the exact one, then 8 decode steps: in float32 within 2e-3 ·
     max|logit| (phase 3's gate), in bf16 within the reference's bf16
     decode tolerance on the logits' scale, 5e-2 · max|logit|.
     granite-moe at full width cut to 4 layers in coded_q int8 on the
     phase-6 cluster for 4 steps (edge 1 dropped at step 2), twice:
     exact launches per step, finite losses and aux losses, the two runs
     equal bit for bit.
  4c. recurrent: mamba2-370m (48 SSD layers) and recurrentgemma-2b (26:
     RG-LRU, RG-LRU, local attention with Dh 256 and window 2048, and 2
     rest RG-LRU layers).  Card against CPU at full width in float32, cut
     to 2 and 5 layers: the full forward of 2 × 64 tokens, then the
     exact handoff of that prompt and 8 decode steps, within 2e-3 ·
     max|logit| (phase 3's gate).  Each served at full width in bf16
     through the serve CLI (``--layers``: mamba2 24 layers,
     recurrentgemma 14) as phase 4 but for 256-token prompts (the
     exact handoff is one decode step a prompt token; a short request
     warms up): exact launches (recurrentgemma 4 × (256 + 32) decode, no
     flash; none for mamba2), host times, peak memory, profiled device
     time.  Each trained in coded_q int8 as granite-moe (mamba2 cut to 8
     of its 48 layers, recurrentgemma to 5), twice, bit for bit.
  4d. encdec_vlm: whisper-medium (24 encoder + 24 decoder layers, MHA
     Dh 64, 1500 frames) and qwen2-vl-2b (28 layers, G 6, M-RoPE).  Card
     against CPU at full width in float32 (phase 3's gate): whisper cut
     to 2 + 2 layers, a 2 × 64-token forward over seeded frames, then
     the exact handoff of a 16-token prompt (the cross cache filled
     first) and 8 decode steps; qwen2-vl cut to 2 layers, a 2 × 128-token
     forward with visual embeddings on the first 64 positions over
     Qwen2-VL's vision layout of 3-D positions (an 8 × 8 patch grid at
     t = 0, the text from max + 1 on: unequal streams, so M-RoPE's
     sections count), then the bulk prefill and 8 decode steps.  Each
     served at full width and depth in bf16 through the serve CLI:
     qwen2-vl as phase 4 (exact launches 28 flash, 28 × 32 decode);
     whisper with 1500 frames from the seed, encoded once a request
     (24 flash launches, under the ``serve.encode`` span), a 16-token
     prompt handed off token by token (a self and a cross decode launch
     per layer and token: 48 × (16 + 32)); the profiled whisper request
     16 + 8 tokens, its encoder's device time split out by the launches
     under its span.  qwen2-vl trained (14 of its 28 layers, as phase
     "pp" trains it) in coded_q int8 as granite-moe, twice, bit for
     bit; whisper cut to 2 + 2 layers through
     ``make_train_step`` (adamw, 4 × 64 tokens over 1500 frames): the
     step-0 gradients card against CPU by phase 5's rule (the encoder's
     unused cross-attention leaves zero on both), then 4 steps with
     finite losses.
  5. training parity: a small float32 config (llama3-8b smoke, 2
     layers), 4 sgd steps of ``CodedSession`` in modes off, coded and
     coded_q × {int8, int4, fp8} on the card and on the CPU from the
     same initial params: card losses within 2e-3·|loss| of the CPU's
     and trained params within 1e-4 of each leaf's largest change (a
     1e-3 share of the values may differ over a quantized hop), coded ==
     off within 5e-4, coded_q within 5e-3 of off.
  6. the training path: ``CodedSession.fit`` in mode coded_q at
     llama3-8b's full width cut to 2 layers (adamw, seq 512, the
     homogeneous 2 × 4 cluster, hgc s_e = s_w = 1: K = 8, 32 rows a
     step), int8 for 4 steps with edge 1 dropped at step 2, then int4
     and fp8 for 2 steps each: host ms per step (ending in a
     synchronize), peak memory, finite losses, exact launches per step
     (the codec's combine kernel once per param leaf, flash 8 groups ×
     2 layers × 2 for the remat); a fifth int8 step under
     ``torch.profiler`` for the device time by kernel; then the HGC
     encode → decode of the 8 per-part gradients of the full-width
     ``groups.p0.mlp.wd`` leaf under a sampled straggler pattern equals
     their sum within 1e-5 · max|Σ g|.
  7. checkpoint, kill, resume, serve, at the phase-6 config (adamw,
     coded_q int8, edge 1 dropped at step 2, total_steps 4): an
     uninterrupted run of 4 steps; a run that checkpoints at step 2
     (``keep_checkpoints=1``, on the local disk with the most free space;
     ~29.7 GB: params, adamw m and v, two pods' EF residuals) and is
     killed there (``stop_after=2``); a fresh session resumed from it,
     whose restored params, m, v, t and EF residual rows equal the
     checkpoint's arrays bit for bit (and streams and detector its JSON),
     and whose steps 2–3 equal the uninterrupted run's losses bit for
     bit; exact launches per step as in phase 6.  Then
     ``session.generate`` (batch 4, 64-token prompts, 8 new tokens):
     flash once per layer, decode once per layer per step, tokens equal
     to ``api.serving.generate`` on the same params.  The embedding
     backward (``F.embedding``, deterministic) is timed beside the
     indexing backward at one training group's shape.
  8. an orchestrated episode at the same config on ``CodedCluster.
     hetero(2, 4)`` with worker processes (spawn) and the schedule
     ``kill:w0.1@3,slow:e1@5x2:4.0`` over 8 rounds: the killed worker
     found by heartbeats alone, at least one replan, no decode fallback,
     finite losses, exact launches per trained round, and no worker
     process with torch loaded (read from its ``/proc/<pid>/maps``).
  tp. tensor parallelism at tp 2 (after 8, before 9): the parent frees
     its memory and spawns two ranks on the one card, joined over gloo
     (NCCL refuses two ranks on one device; the NCCL path is not run
     here).  (a) llama3-8b at full width cut to 2 layers in float32: a
     bulk prefill of 2 × 64 tokens and 8 greedy decode steps at tp 2
     against the same at tp 1 in the parent, from one seed: gathered
     logits within 2e-3 · max|logit| (phase 3's gate), tokens equal.
     (b) ``launch.serve.main([..., "--tp", "2", "--layers", "8"])``
     inside the ranks serves phase 4's request (llama3-8b cut to
     ``TP_SERVE_LAYERS`` 8 layers, bf16, 4 × 1024-token prompts, 32
     tokens): a warm-up, the counted request (exactly one flash and 32
     decode launches a layer on each rank), rank 0's profiled request
     of 8 new tokens with the host time inside collectives split out
     (the ``tp.collective`` profiler spans), each rank's host times and
     peak memory.
     (c) ``CodedSession`` in coded_q int8 with tp 2 at the phase-6
     settings (2 layers, adamw, seq 512, homogeneous(2, 4), hgc (1, 1),
     K 8, block 64; every (pod, data) group in turn on each rank), 4
     steps with edge 1 dropped at step 2, twice: exact launches a step
     on each rank (flash 8 × 2 × 2, ``coded_combine_q`` once per param
     leaf, on the rank's slice), finite losses, the step-0 loss within
     2e-3 · |loss| of a tp-1 session's run in the parent on the same
     weights and batches and the losses of steps 1-3 within
     ``TP_LOSS_RTOL`` · |loss| of its, adamw's first moment after step 0
     (0.1 × the decoded step-0 gradient: lr is 0 there) leaf by leaf,
     each rank's slice, within ``TP_LEAF_SHARE`` = 3/127 of the leaf's
     max |m| in the tp-1 session (its moments saved as ``.npy`` files
     that the ranks read a slice at a time), the two runs equal bit for
     bit (losses and every param leaf's bits); host ms a step and peak
     memory per rank.
     (d) the same with ``seq_shard=True`` (sequence parallelism: 256
     tokens a rank between the collective pairs), against the same tp-1
     session, with the peak memory a rank beside (c)'s.  (e)
     granite-moe-3b-a800m and llama4-maverick (2 layers, one dense and
     one MoE; 16 of its 128 experts: one float32 MoE layer of 128 is 64
     GB), mamba2-370m (2 layers), recurrentgemma-2b (5) and
     whisper-medium (2 + 2) at full width in float32: the prefill of 2
     × 64 tokens and 8 decode steps at tp 2, fed the tp-1 run's tokens,
     logits within 2e-3 · max|logit| of the tp-1 run in the parent, the
     greedy tokens' match printed; two sgd steps (lr 1e-3, no warm-up)
     of the dist train step at tp 2 with and without SP, both losses
     and gradient norms within ``TP_LOSS_RTOL`` of tp 1's.  (f) the
     serve CLI at ``--tp 2`` serves granite-moe-3b-a800m as (b) (8
     layers; exact launches, rank 0 profiled, the tokens' match with
     phase "archs"' not gated), and a ``CodedSession`` trains it (1 layer)
     in coded_q int8 at tp 2 with SP at the phase-6 settings but for 2
     steps (edge 1 dropped at step 1, so adamw's moments and the EF
     residual carry across a step; an MoE step at tp 2 takes ~10–15 s
     over gloo), twice, bit for bit (losses, aux losses, every trained
     leaf), exact launches a step; then the serve CLI serves
     llama4-maverick in bf16 at tp 2 with all 128 experts (64 a rank),
     cut to 2 layers as phase "archs" serves it, phase 4's request:
     exact launches on each rank, finite tokens.  In (b) and (f) both
     ranks must serve the same tokens.  A failing rank fails the
     phase.  Phase 2 adds the attention kernels
     at a rank's shapes (llama3-8b at tp 2: H 16, Kv 4, serve and
     training; starcoder2-3b at tp 4: H 6 over one replicated KV head;
     recurrentgemma-2b at tp 2: H 5 over its one KV head at Dh 256,
     decode at its served prompt and flash at the training shape with
     the log-sum-exp; whisper-medium at tp 2: the encoder's 1500 frames
     at H = Kv = 8, non-causal, and the cross cache's decode; granite-moe
     at tp 2: H 12, Kv 4, flash and decode) and ``coded_combine_q`` at
     K 2 × F 262,668,288 (half the embedding leaf).
  pp. pipeline parallelism at pp 2 (after "tp", before 9): the parent
     frees its memory and spawns two ranks over gloo on the one card
     (``dist.launch.run_ranks``), which run (a)'s smaller configs while
     the parent runs the pp-1 references, then the rest of (a) and (b);
     then four ranks run (c).  (a)
     llama3-8b, granite-moe-3b-a800m (one microbatch), qwen2-vl-2b (the
     vision layout), mamba2-370m (2 layers each), recurrentgemma-2b (8:
     two groups, two rest layers) and whisper-medium (2 + 2) at full
     width in float32: two sgd steps (lr 1e-3, no warm-up) of the
     pipelined dist step on two ranks, the quarter batch tiled over two
     groups with λ = 1/2, against the single-device step on the quarter
     in the parent: losses and gradient norms within ``TP_LOSS_RTOL``.
     (b) qwen2-vl-2b at 14 of its 28 layers (``PP_VLM_LAYERS``, 7 a
     stage) in coded_q int8 at the phase-6 settings with pp 2 and 2
     microbatches, 4 steps (edge 1 dropped at step 2), twice: exact
     launches a step on each rank (flash 8 groups × 2 microbatches × 7
     layers × 2 for the remat; the
     int8 combine once per leaf held), finite losses, the step-0 loss
     within 2e-3 · |loss| and steps 1–3 within ``TP_LOSS_RTOL`` of a
     pp-1 session in the parent whose gradient is summed over the same 2
     row blocks, adamw's step-0 first moment per leaf and stage block
     within ``TP_LEAF_SHARE`` of that session's, the runs bit for bit;
     rank 0's last step profiled (host ms inside ``pp.collective``, the
     device's busy share).  (c) the same model at pp 2 × tp 2 with SP on
     four ranks, one step, once: exact launches, the step-0 loss against
     the same pp-1 session, each leaf's step-0 first moment within
     ``PP_TP_LEAF_L2`` (relative L2).
     Peak memory and host ms a step per rank.  Phase 2 adds flash at the
     pipeline's microbatch (q 2 × 512 × 12 × 128, Kv 2, with the
     log-sum-exp) and ``coded_combine_q`` at K 2 × F 233,373,696 (the
     tied table every stage holds).
  shrink. ``CodedSession.shrink`` where pods and workers are ranks of
     their own (after "pp", before "dryrun"): qwen2-vl-2b at full width
     cut to 2 layers in coded_q int8 at the phase-6 settings (adamw, seq
     512, block 64) on ``CodedCluster.hetero(2, 2)`` with the fixed
     planner, one rank a (pod, data) group: four ranks spawned on the
     one card over gloo (``SHRINK_CLUSTER``), FSDP over each pod's two
     data ranks (the session's default): each rank's params, adamw state
     and EF residual (its own pod's row) equal the slice arithmetic's
     bytes, at construction and after the shrink.  3 steps, then edge 1
     shrunk away (the state gathered over the old data groups first):
     its two ranks retire (exit 0; a step there raises; the survivors'
     groups never wait on them), and on the 2 survivors each rank's own
     EF residual row (every leaf) equals its row before the shrink bit
     for bit; 2 steps, a checkpoint (written by the survivors' first
     rank), the last step; a fresh world of the survivors' size resumes
     the checkpoint and takes the last step, whose loss equals the
     uninterrupted run's bit for bit; every loss within
     ``SHRINK_LOSS_RTOL`` · |loss| of a one-card session (``OneCardMesh``,
     run in the parent while the survivors resume) that shrinks at the
     same step, and the survivors' gathered params after the last step
     within ``SHRINK_PARAM_RTOL`` of its params (per leaf, × the leaf's
     largest |value|); exact launches a step on each rank (one
     ``coded_combine_q`` a param leaf, the flash forward twice a layer);
     host ms a step before and after the shrink, and peak memory a rank;
     rank 0's step ``SHRINK_GATED_STEP`` records its own peak and, under
     a CPU profile, its ``fsdp.collective`` spans for phase "dryrun".
  dryrun. the dry run's machinery (``api.aot.count_step``, the op
     counter on the meta device) against the card: phase 4's request
     (through ``serving.token_loop``, as the server generates)
     (llama3-8b, 32 layers, bf16, 4 × 1024-token prompts, 32 tokens over
     the 1057-slot cache) and phase 6's int8 training step (2 layers, seq
     512) counted on meta: the predicted peak (arguments + the step's
     peak live bytes) within ``DRY_PEAK_RTOL`` (2%) of the
     ``max_memory_allocated`` those phases measured (``main`` hands
     their readings on); phase "tp" (b)'s
     request at tp 2 (8 layers, 8 new tokens) on a counting group: its
     collectives in the prefill and in the decode equal the
     ``tp.collective`` spans rank 0's profile recorded in each; phase
     "shrink"'s rank 0 step on a counting ``DistMesh`` (its FSDP blocks,
     the transient whole copies, its own EF row): the predicted peak
     within ``DRY_PEAK_RTOL`` of that step's ``max_memory_allocated``,
     and the FSDP gathers its data group records equal to the step's
     ``fsdp.collective`` spans; the predicted compute and memory bounds
     printed beside each phase's profiled device ms, not gated.
  9. the paper's evaluation path (``simulate_training``): the CNN under
     hgc and the logreg under greedy, 3 iterations at batch 32 per part,
     on the card and on the CPU from the same weights (times equal,
     losses within 2e-3·|loss|, accuracies within 2 / n_eval); at one
     CNN iteration's per-part gradients, every exact scheme's aggregate
     equals their plain sum within 1e-5·max|Σg|; then all nine schemes
     at the paper's sizes (K = 40, 8000 samples, batch 32 per part,
     1000 evaluation samples; MNIST/logreg 400 iterations as Table I,
     CIFAR/CNN 100 as Figs. 5/6): simulated ms per iteration and hours,
     final accuracy, hours to Table I's 0.85, host ms per iteration,
     peak memory, and exactly one combine launch per iteration and no
     other kernel; the CIFAR hgc run a second time, whose losses and
     accuracies must equal the first's bit for bit (a run computes with
     TF32 off and deterministic cuDNN algorithms, ``sim.simulator.
     repeatable``); and one hgc iteration of each model under
     ``torch.profiler``.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, bf16 tensor FLOP/s
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# the training path's shapes: llama3-8b at full width, 2 layers
EMBED_F = 128256 * 4096           # the embedding leaf, the hop's largest
WD_F = 2 * 14336 * 4096           # groups.p0.mlp.wd, the encode/decode leaf
HOP_BLOCK = 64                    # TrainConfig.grad_compression_block
TRAIN_LAYERS, TRAIN_SEQ, GROUPS = 2, 512, 8

# the serving path's shapes: llama3-8b, batch 4, 1024-token prompts, 32 new
B, PROMPT, GEN = 4, 1024, 32
H, KV, DH = 32, 8, 128

# GQA group sizes H / Kv in the phase-2 grids: llama3 and granite-8b 4,
# gemma3 2, granite-moe 3, maverick 5, qwen2-vl 6, recurrentgemma 10,
# starcoder2 12, whisper 1 (and 8)
GQA_GROUPS = [1, 2, 3, 5, 6, 8, 10, 12]
FLASH_GROUPS = [2, 3, 4, 5, 6, 10, 12]

# the served configs' attention shapes beside llama3-8b's (granite-8b's
# are llama3-8b's): label → (prompt S, H, Kv, Dh, window)
SERVE_SHAPES = {
    "starcoder2-3b": (1024, 24, 2, 128, 0),
    "granite-moe-3b-a800m": (1024, 24, 8, 64, 0),
    "llama4-maverick-400b-a17b": (1024, 40, 8, 128, 0),
    "gemma3-27b global": (2048, 32, 16, 128, 0),
    "gemma3-27b local": (2048, 32, 16, 128, 1024),
}

# recurrentgemma-2b's local attention layers (H 10, Kv 1, Dh 256, window
# 2048): the served prompt (the exact handoff: the decode kernel only),
# and the flash kernel at the training shape (S 512, with its log-sum-exp)
# and at S 4096, where the window bites
RG_SHAPE = dict(H=10, KV=1, DH=256, window=2048)
REC_PROMPT = 256
# the recurrent archs' profiled request (prompt, new tokens): their
# exact handoff makes one decode step a prompt token, each some 900-1700
# kernels, and the profiler's trace costs seconds a step to read back;
# device time is taken per token against the counted request's host time
REC_PROFILED = (16, 8)

# whisper-medium (H = Kv = 16, Dh 64) and qwen2-vl-2b (H 12, Kv 2: G 6,
# Dh 128): the encoder's frames, the served prompts (whisper's handed
# off token by token, its encoder once a request), and the training
# and parity sequence of the cross-attention's queries
ENC_LEN, WHISPER_PROMPT, XATTN_SEQ = 1500, 16, 64
WHISPER_SHAPE = dict(H=16, KV=16, DH=64)
QWEN_SHAPE = dict(H=12, KV=2, DH=128)

# the MoE shuffle kernels (csrc/moe_shuffle.cu) at granite-moe's training
# group (16,384 tokens, top-8 of 40 experts, 4,096 slots each, d 1,536)
# and llama4-maverick's served prompt (4 x 1024 tokens, top-1 of 128, d
# 5,120), bf16: label -> (N, k, E, d).  The routing's logits rise by
# MOE_SKEW from the first expert to the last, which drops 8-10% of the
# entries at capacity factor 1.25, as the trained cell's routing does
MOE_SHUFFLE_SHAPES = {"granite-moe training": (16384, 8, 40, 1536),
                      "maverick prefill": (4096, 1, 128, 5120)}
MOE_CAPACITY_FACTOR, MOE_SKEW = 1.25, 1.5
MOE_KERNELS = ("moe_dispatch", "moe_combine", "moe_dispatch_bwd",
               "moe_combine_bwd")

# the paper's evaluation path: benchmarks/bench_fig56_accuracy.py and
# bench_table1_time_to_acc.py at their FULL settings
EVAL_K, EVAL_N_DATA, EVAL_BATCH, EVAL_N_EVAL = 40, 8000, 32, 1000
EVAL_RUNS = {  # dataset → (iterations, evaluations every, seed)
    "mnist": (400, 20, 11),   # Table I: 400 iterations, 20 evaluations
    "cifar": (100, 10, 7),    # Figs. 5/6: 100 iterations, 10 evaluations
}
EVAL_TARGET = 0.85            # Table I's target accuracy
CNN_F = 845_738               # the CNN's parameters (the logreg has 7,850)

def log(*a):
    print(*a, flush=True)


def timed_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, n: int = 60, replays: int = 5) -> float:
    """Device time of one call of ``fn``: ``n`` calls captured in one CUDA
    graph and replayed, so that no host launch cost sits between the
    kernels (back to back from Python, a ~20 us kernel would time the
    host's wrapper instead)."""
    import torch

    fn()  # warm up, and allocate what the first call allocates
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * n)


def bound_ms(nbytes: float, flops: float, dtype: str):
    t_mem = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_mem, t_ops), ("bytes" if t_mem >= t_ops
                                     else "operations")


def flash_work(batch, S, T, H, KV, DH, pairs, elem=2, with_lse=False):
    """(bytes, operations) of one flash call, what its bound counts: q,
    k, v read once and the output (and the log-sum-exp) written once,
    4 · Dh operations a head for each attended (query, key) pair."""
    nbytes = (2 * batch * S * H * DH + 2 * batch * T * KV * DH) * elem \
        + (batch * S * H * 4 if with_lse else 0)
    return nbytes, 4 * batch * H * DH * pairs


def decode_work(B, H, KV, DH, n_valid, elem=2):
    """(bytes, operations) of one decode call: the ``n_valid`` attended
    slots of K and V read once, q read, the output written, ``q_pos``."""
    nbytes = (2 * B * n_valid * KV * DH + 2 * B * H * DH) * elem + 4
    return nbytes, 4 * B * H * n_valid * DH


def combine_work(R, K, F, payload_bytes, n_scales=0):
    """(bytes, operations) of one combine: the (K, F) payload, the (R, K)
    coefficients and the scales read once, the (R, F) f32 output written
    once; 2 · R · K · F operations, and K · F to dequantize."""
    nbytes = payload_bytes + R * K * 4 + R * F * 4 + n_scales * 4
    return nbytes, 2 * R * K * F + (K * F if n_scales else 0)


def moe_launches(cfg, forwards: int, backwards: int = 0) -> dict:
    """The MoE shuffle kernels' launches when every MoE layer of ``cfg``
    runs ``forwards`` forward and ``backwards`` backward passes: one
    dispatch and one combine launch a forward, one of each backward a
    backward."""
    n = sum(cfg.moe_at(i) for i in range(cfg.n_layers))
    return {"moe_dispatch": n * forwards, "moe_combine": n * forwards,
            "moe_dispatch_bwd": n * backwards,
            "moe_combine_bwd": n * backwards}


def check_rows(got, want, share: float, what: str) -> float:
    """Every output row (last axis) within ``share`` of its own max
    |want|; → the worst row's error as a share of that max."""
    worst = ((got - want).abs().amax(-1) / want.abs().amax(-1)).max().item()
    if not worst <= share:
        raise AssertionError(f"{what}: a row is off by {worst:.3g} of its "
                             f"max |plain|, limit {share}")
    return worst


# ----------------------------------------------------------------------
def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    log(smi.stdout.strip().splitlines()[0])
    log(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} device(s)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def phase_build():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    out = build.build_all()
    log(f"[build] {len(build.sources())} sources in "
        f"{time.perf_counter() - t0:.1f} s -> {out.relative_to(ROOT)}")
    for name in build.sources():  # what -Xptxas -v reported per kernel
        text = (out / f"{name}.log").read_text()
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
        spilled = [  # kernel<template args>, from the mangled names
            "{}<{}>".format(*re.search(r"\d+([a-z_]+_kernel)I(\w+?)EEv",
                                       fn).group(1, 2))
            for fn, n in re.findall(
                r"Compiling entry function '(\S+)'[^\n]*\n[^\n]*\n"
                r"\s+\d+ bytes stack frame, (\d+) bytes spill stores", text)
            if int(n) > 0]
        log(f"[build] {name}: {len(regs)} kernels, registers "
            f"{min(regs)}..{max(regs)}, {len(spilled)} with spills "
            f"{' '.join(spilled)}")
    for name in build.sources():
        build.load(name)


def _grid_decode(torch, dtype, gen):
    import itertools

    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention_fwd

    worst = 0.0
    grid = itertools.product(["empty", "partial", "full", "wrapped"],
                             [0, 8], [0.0, 30.0], GQA_GROUPS, [1, 8],
                             [16, 32, 64, 128, 256], [4, 40, 1057])
    # gemma3's local ring: window 1024 over a 1024-slot cache, wrapped
    # (1088 = the phase-"archs" handoff prompt, 2 * 1024 + 3);
    # recurrentgemma's, window 2048 over 2048 slots, G 10, Kv 1, Dh 256;
    # and whisper's static cross cache: every one of 1500 slots valid at
    # q_pos = C - 1, G 1, Kv 16, Dh 64
    ring = itertools.chain(
        itertools.product(["wrapped1088", "wrapped"], [1024], [0.0],
                          GQA_GROUPS, [1, 8], [64, 128], [1024]),
        [("wrapped", 2048, 0.0, 10, 1, 256, 2048),
         ("full", 0, 0.0, 1, 16, 64, ENC_LEN)])
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    n = 0
    for pos_kind, window, softcap, G, Kv, Dh, C in itertools.chain(grid,
                                                                   ring):
        pos = {"empty": 0, "partial": max(C // 2 - 1, 0), "full": C - 1,
               "wrapped": 2 * C + 3, "wrapped1088": 1088}[pos_kind]
        q = torch.randn(2, 1, Kv * G, Dh, generator=gen, device="cuda")
        k = torch.randn(2, C, Kv, Dh, generator=gen, device="cuda")
        v = torch.randn(2, C, Kv, Dh, generator=gen, device="cuda")
        q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
        got = decode_attention_fwd(q, k, v, pos, window=window,
                                   softcap=softcap).float()
        want = ref.decode_attention_ref(q, k, v, pos, window=window,
                                        softcap=softcap).float()
        torch.testing.assert_close(
            got, want, rtol=tol, atol=tol,
            msg=lambda m: f"decode {pos_kind} w={window} cap={softcap} "
                          f"G={G} Kv={Kv} Dh={Dh} C={C} {dtype}: {m}")
        worst = max(worst, (got - want).abs().max().item())
        n += 1
    return n, worst


def _grid_flash(torch, dtype, gen):
    import itertools

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_fwd

    worst = 0.0
    grid = itertools.product([1, 17, 64, 1000, 1024], [True, False], [0, 16],
                             [0.0, 30.0], [1] + FLASH_GROUPS,
                             [16, 32, 64, 128, 256], [2], [None])
    # gemma3's local layers at its served prompt: window 1024 at S 2048;
    # recurrentgemma's: window 2048 at S 4096, G 10, Kv 1, Dh 256
    local = itertools.chain(
        itertools.product([2048], [True], [1024], [0.0], FLASH_GROUPS,
                          [64, 128, 256], [2], [None]),
        [(4096, True, 2048, 0.0, 10, 256, 1, None)])
    # whisper's cross-attention: S queries over T keys, non-causal
    cross = itertools.product([1, 64, 1000], [False], [0], [0.0], [1, 6],
                              [64, 128], [2], [17, ENC_LEN])
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    n = 0
    for S, causal, window, softcap, G, Dh, Kv, T in itertools.chain(
            grid, local, cross):
        T = T or S
        q = torch.randn(1, S, Kv * G, Dh, generator=gen, device="cuda")
        k = torch.randn(1, T, Kv, Dh, generator=gen, device="cuda")
        v = torch.randn(1, T, Kv, Dh, generator=gen, device="cuda")
        q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
        got = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                  softcap=softcap).float()
        want = ref.flash_attention_ref(q, k, v, causal=causal,
                                       window=window,
                                       softcap=softcap).float()
        torch.testing.assert_close(
            got, want, rtol=tol, atol=tol,
            msg=lambda m: f"flash S={S} T={T} causal={causal} w={window} "
                          f"cap={softcap} G={G} Kv={Kv} Dh={Dh} {dtype}: "
                          f"{m}")
        worst = max(worst, (got - want).abs().max().item())
        n += 1
    return n, worst


def _time_decode(torch, S=PROMPT, H=H, KV=KV, DH=DH, window=0, C=None,
                 q_pos=None):
    """Decode attention at a serve path's shapes (bf16, batch 4, a
    mid-generation q_pos after an S-token prompt, the ring of a
    ``window``-token local layer or the whole cache; or a ``C``-slot
    cache read at ``q_pos``, as whisper's static cross cache at C − 1).
    Several cache copies rotate so that, as in the model where every
    layer's cache passes between two reads of one, no launch finds its
    cache in the 50 MB L2."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import (
        decode_attention_fwd,
        split_plan,
    )
    from repro_torch.models import attention as attn_lib

    dt = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(7)
    if C is None:
        q_pos = S + GEN // 2
        C = min(window, S + GEN + 1) if window else S + GEN + 1
    n_sets = 6
    qs = [torch.randn(B, 1, H, DH, generator=gen, device="cuda").to(dt)
          for _ in range(n_sets)]
    ks = [torch.randn(B, C, KV * DH, generator=gen,
                      device="cuda").to(dt).view(B, C, KV, DH)
          for _ in range(n_sets)]
    vs = [torch.randn(B, C, KV * DH, generator=gen,
                      device="cuda").to(dt).view(B, C, KV, DH)
          for _ in range(n_sets)]
    qp = torch.tensor(q_pos, dtype=torch.int32, device="cuda")
    got = decode_attention_fwd(qs[0], ks[0], vs[0], qp, window=window)
    want = ref.decode_attention_ref(qs[0], ks[0], vs[0], qp, window=window)
    got, want = got.float(), want.float()
    torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2)
    err = (got - want).abs().max().item()
    row_err = check_rows(got, want, 1e-2, "decode at the serve shapes")

    # SDPA yardstick: same function, the ring mask as a boolean mask (no
    # mask where every slot is attended, as over the cross cache)
    k_pos = attn_lib.ring_slot_positions(C, qp + 1, window or C)
    mask = attn_lib._allowed(qp.reshape(1), k_pos, True,
                             window)[None, None]
    n_valid = int(mask.sum())
    sdpa_mask = None if n_valid == C else mask

    def lib(i):
        return F.scaled_dot_product_attention(
            qs[i].transpose(1, 2), ks[i].transpose(1, 2),
            vs[i].transpose(1, 2), attn_mask=sdpa_mask, enable_gqa=True)

    torch.testing.assert_close(lib(0).transpose(1, 2).float(), want,
                               rtol=2e-2, atol=2e-2)
    it = iter(range(10 ** 9))

    def rot(f):
        return lambda: f(next(it) % n_sets)

    kernel_ms = graph_ms(rot(lambda i: decode_attention_fwd(
        qs[i], ks[i], vs[i], qp, window=window)))
    plain_ms = timed_ms(rot(lambda i: ref.decode_attention_ref(
        qs[i], ks[i], vs[i], qp, window=window)), 100)
    lib_ms = graph_ms(rot(lib))
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    n_split, chunk = split_plan(C, B * KV, n_sm)
    log(f"[kernels] decode_attention at C={C}: the sweep of each "
        f"of the {B * KV} (sequence, kv head) pairs is split {n_split} ways "
        f"({chunk} slots each): a grid of {B * KV * n_split} blocks")
    bms, by = bound_ms(*decode_work(B, H, KV, DH, n_valid), "bfloat16")
    return dict(max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=bms, bound_by=by, library_ms=lib_ms), row_err


def _time_flash(torch, S=PROMPT, H=H, KV=KV, DH=DH, window=0,
                with_lse=False, T=None, causal=True, batch=B):
    """Flash forward at a main path's shapes (bf16, batch 4, causal, over
    a ``window`` for a local layer): a prefill's (llama3's S = 1024:
    q/k/v/o are 84 MB, more than the L2 holds) or, with the log-sum-exp
    the training forward saves, one training group's (S = 512); or
    non-causal over ``T`` keys (whisper's encoder, S = T = 1500, and its
    cross-attention, S queries over T = 1500 frames); ``batch`` rows
    (a pipeline microbatch's)."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.models import attention as attn_lib

    dt = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(8)
    T = T or S
    q = torch.randn(batch, S, H, DH, generator=gen, device="cuda").to(dt)
    k = torch.randn(batch, T, KV, DH, generator=gen, device="cuda").to(dt)
    v = torch.randn(batch, T, KV, DH, generator=gen, device="cuda").to(dt)
    kw = dict(causal=causal, window=window, return_lse=with_lse)
    got = flash_attention_fwd(q, k, v, **kw)
    want = ref.flash_attention_ref(q, k, v, **kw)
    if with_lse:
        (got, lse), (want, want_lse) = got, want
        torch.testing.assert_close(lse, want_lse, rtol=2e-2, atol=2e-2)
    got, want = got.float(), want.float()
    torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2)
    err = (got - want).abs().max().item()
    row_err = check_rows(got, want, 2e-2, f"flash at S={S} T={T}")
    allowed = attn_lib._allowed(torch.arange(S, device="cuda"),
                                torch.arange(T, device="cuda"), causal,
                                window).expand(S, T)
    mask = (dict(attn_mask=allowed) if window
            else dict(is_causal=causal))

    def lib():
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            enable_gqa=True, **mask)

    torch.testing.assert_close(lib().transpose(1, 2).float(), want,
                               rtol=2e-2, atol=2e-2)
    kernel_ms = graph_ms(lambda: flash_attention_fwd(q, k, v, **kw), 20)
    plain_ms = timed_ms(lambda: ref.flash_attention_ref(q, k, v, **kw), 5)
    lib_ms = graph_ms(lib, 20)
    bms, by = bound_ms(*flash_work(batch, S, T, H, KV, DH,
                                   int(allowed.sum()), with_lse=with_lse),
                       "bfloat16")
    return dict(max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=bms, bound_by=by, library_ms=lib_ms), row_err


COMBINE = {  # kind → (kernel wrapper, plain version, replaced Pallas call)
    "f32": ("coded_combine", "coded_combine_ref",
            "src/repro/kernels/coded_combine.py:58"),
    "int8": ("coded_combine_q", "coded_combine_q_ref",
             "src/repro/kernels/coded_combine.py:110"),
    "int4": ("coded_combine_q4", "coded_combine_q4_ref",
             "src/repro/kernels/coded_combine.py:171"),
    "fp8": ("coded_combine_f8", "coded_combine_f8_ref",
            "src/repro/kernels/coded_combine.py:225"),
}


def _combine_inputs(torch, gen, kind, R, K, F, block):
    """(coeff, payload, scales) on the card in the codec's layout: F
    values per row (int4 packs two per byte); random payloads."""
    c = torch.randn(R, K, generator=gen, device="cuda")
    if kind == "f32":
        return c, torch.randn(K, F, generator=gen, device="cuda"), None
    s = torch.rand(K, F // block, generator=gen, device="cuda") + 0.1
    if kind == "int8":
        q = torch.randint(-127, 128, (K, F), generator=gen, device="cuda",
                          dtype=torch.int8)
    elif kind == "int4":
        q = torch.randint(-128, 128, (K, F // 2), generator=gen,
                          device="cuda", dtype=torch.int8)
    else:
        q = (torch.randn(K, F, generator=gen, device="cuda") * 100).clamp(
            -448, 448).to(torch.float8_e4m3fn)  # e4m3 has no inf
    return c, q, s


def _combine_calls(kind, c, q, s, block):
    """(kernel, plain version) of one combine kind, bound to its inputs."""
    from repro_torch.kernels import coded_combine as cc
    from repro_torch.kernels import ref

    kname, pname, _ = COMBINE[kind]
    kernel, plain = getattr(cc, kname), getattr(ref, pname)
    if kind == "f32":
        return (lambda: kernel(c, q)), (lambda: plain(c, q))
    return (lambda: kernel(c, q, s, block=block),
            lambda: plain(c, q, s, block))


def _row_share(got, want) -> float:
    """Worst output row's max |got − want| over that row's max |want|."""
    scale = want.abs().amax(-1).clamp_min(1e-30)
    return ((got - want).abs().amax(-1) / scale).max().item()


def _grid_combine(torch, gen):
    """The four combine kernels against their plain versions over
    R ∈ {1, 8, 13}, K ∈ {2, 8, 64}, F ∈ {64, 4160, 2^20 + 64} and, for
    the scaled payloads, block ∈ {64, 128, 256} (F rounded up to a
    multiple of the block); plus F = 4162 with block 2 and, for f32,
    F = 4161: rows that are not 16-byte aligned take the scalar path,
    and a block smaller than a thread's 16 values one scale per value.
    Then the f32 kernel's own edges: R ∈ {1, 8, 13} (one tile of 8
    rows of C, and past it), K ∈ {1, 13, 40, 64, 200} (below its 4-row
    unroll, not a multiple of it, far past it), F ∈ {3, 64, 4162} (below one thread's 4
    columns, below one warp's, not a multiple of 4), with packed rows
    (F = 4162: every odd row 8 bytes off a 16-byte boundary, scalar
    loads) and padded rows (each row's stride rounded up to 4 floats:
    vector loads)."""
    import itertools

    worst, n = 0.0, 0
    for kind, (kname, _, _) in COMBINE.items():
        blocks = [1] if kind == "f32" else [64, 128, 256]
        cases = [(R, K, -(-F // b) * b, b) for R, K, F, b in
                 itertools.product([1, 8, 13], [2, 8, 64],
                                   [64, 4160, 2 ** 20 + 64], blocks)]
        cases += [(R, K, 4162, 2) for R in (1, 13) for K in (2, 64)]
        if kind == "f32":
            cases += [(R, K, 4161, 1) for R in (1, 13) for K in (2, 64)]
        for R, K, F, block in cases:
            c, q, sc = _combine_inputs(torch, gen, kind, R, K, F, block)
            kernel, plain = _combine_calls(kind, c, q, sc, block)
            got, want = kernel(), plain()
            share = _row_share(got, want)
            if not share <= 1e-5:
                raise AssertionError(f"{kname} R={R} K={K} F={F} "
                                     f"block={block}: a row is off by "
                                     f"{share:.3g} of its max |plain|")
            worst = max(worst, share)
            n += 1
    from repro_torch.kernels import ref
    from repro_torch.kernels.coded_combine import coded_combine

    for R, K, F, padded in itertools.product([1, 8, 13],
                                             [1, 13, 40, 64, 200],
                                             [3, 64, 4162], [False, True]):
        c = torch.randn(R, K, generator=gen, device="cuda")
        g = torch.randn(K, -(-F // 4) * 4 if padded else F, generator=gen,
                        device="cuda")[:, :F]
        share = _row_share(coded_combine(c, g), ref.coded_combine_ref(c, g))
        if not share <= 1e-5:
            raise AssertionError(f"coded_combine R={R} K={K} F={F} "
                                 f"{'padded' if padded else 'packed'} rows: "
                                 f"a row is off by {share:.3g} of its max "
                                 f"|plain|")
        worst = max(worst, share)
        n += 1
    return n, worst


def _time_combine(torch, kind, R, K, F, block):
    """One combine kernel at a main path's shape: checked row-wise
    against its plain version, then timed beside it (CUDA events) and,
    for f32, beside ``torch.mm`` (TF32 off), in turns: kernel, plain,
    ``torch.mm``, kernel; the kernel's time is the less of its two (both
    are returned).  The payload is 1–4 GB, far beyond the 50 MB L2, so
    every launch reads it from HBM."""
    kname = COMBINE[kind][0]
    gen = torch.Generator(device="cuda").manual_seed(11)
    c, q, s = _combine_inputs(torch, gen, kind, R, K, F, block)
    kernel, plain = _combine_calls(kind, c, q, s, block)
    got, want = kernel(), plain()
    share = _row_share(got, want)
    if not share <= 1e-5:
        raise AssertionError(f"{kname} at R={R} K={K} F={F}: a row is off "
                             f"by {share:.3g} of its max |plain|")
    err = (got - want).abs().max().item()
    del got, want
    first_ms = timed_ms(kernel, 10, warmup=2)
    plain_ms = timed_ms(plain, 3, warmup=1)
    lib_ms = None
    if kind == "f32":
        lib_ms = timed_ms(lambda: torch.mm(c, q), 10, warmup=2)
    again_ms = timed_ms(kernel, 10, warmup=2)
    bms, by = bound_ms(*combine_work(R, K, F, q.numel() * q.element_size(),
                                     0 if s is None else s.numel()),
                       "float32")
    return dict(max_abs_err=err, ms=min(first_ms, again_ms),
                plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=lib_ms), share, (first_ms, again_ms)


def _time_combine_eval(torch):
    """The f32 combine at the evaluation path's shape (R = 1, K = 40, F =
    the CNN's 845,738 parameters) in both row layouts: the simulator's,
    each row's stride rounded up to 4 floats (16-byte rows: vector
    loads), and a packed (K, F) matrix (every odd row 8 bytes off:
    scalar loads).  Each checked row-wise against the plain version;
    kernel and ``torch.mm`` (TF32 off) timed by CUDA-graph replay (a
    ~50 us call from Python would time the host) in turns: padded,
    packed, ``torch.mm``, ``torch.mm``, packed, padded; each time is the
    less of its two turns (both are returned).  The plain version by
    CUDA events."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.coded_combine import coded_combine

    R, K, F = 1, EVAL_K, CNN_F
    gen = torch.Generator(device="cuda").manual_seed(12)
    c = torch.randn(R, K, generator=gen, device="cuda")
    padded = torch.randn(K, -(-F // 4) * 4, generator=gen,
                         device="cuda")[:, :F]
    packed = padded.contiguous()
    layouts = {"padded": padded, "packed": packed}
    checked = {}
    for layout, g in layouts.items():
        got, want = coded_combine(c, g), ref.coded_combine_ref(c, g)
        share = _row_share(got, want)
        if not share <= 1e-5:
            raise AssertionError(f"coded_combine {layout} at R={R} K={K} "
                                 f"F={F}: a row is off by {share:.3g}")
        checked[layout] = (share, (got - want).abs().max().item())
    turns = {name: [] for name in (*layouts, "torch.mm")}
    for name in ("padded", "packed", "torch.mm", "torch.mm", "packed",
                 "padded"):
        if name == "torch.mm":
            turns[name].append(graph_ms(lambda: torch.mm(c, packed)))
        else:
            g = layouts[name]
            turns[name].append(graph_ms(lambda: coded_combine(c, g)))
    plain_ms = timed_ms(lambda: ref.coded_combine_ref(c, packed), 20)
    bms, by = bound_ms(*combine_work(R, K, F, K * F * 4), "float32")
    return checked, turns, plain_ms, bms, by


def _moe_shuffle_case(torch, gen, N, k, E, d, dtype):
    """Tokens (N, d) and the plan of a routing drawn on the card (k
    distinct experts a token, Gumbel top-k over logits rising by
    ``MOE_SKEW``); slot rows, weights and the two gradients to feed."""
    from repro_torch.models import moe as moe_lib

    u = torch.rand(N, E, generator=gen, device="cuda")
    logits = torch.linspace(0.0, MOE_SKEW, E, device="cuda")
    top_e = (logits - torch.log(-torch.log(u))).argsort(
        -1, descending=True)[:, :k]
    cap = moe_lib.capacity(N, k, E, MOE_CAPACITY_FACTOR)
    order, slot, _ = moe_lib.dispatch_slots(top_e, E, cap)
    plan = moe_lib.shuffle_plan(order, slot, k, E * cap)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)
    n_slots = plan.src.numel()
    return dict(x=randn(N, d), plan=plan, rows=randn(n_slots, d),
                w=torch.rand(N, k, generator=gen, device="cuda"),
                dbuf=randn(n_slots, d), dy=randn(N, d))


def _row_worst(got, want) -> float:
    """The worst row's max |got − want| over its max |want| (rows that
    are zero in both count 0)."""
    err = (got.float() - want.float()).abs().amax(-1)
    return (err / want.float().abs().amax(-1).clamp_min(1e-30)).max().item()


def _time_moe_shuffle(torch, label, N, k, E, d, dtype):
    """The four MoE shuffle passes at one shape: each kernel against the
    plain version (its forward ops; their autograd backward), outputs
    checked (the dispatch equal; every other row within 2e-2 of its max
    |plain|: the plain version rounds the weight and each product to
    bf16, the kernel once), then timed back to back with CUDA events,
    the kernel in two turns around the plain version, beside the bound
    of the bytes it must move.  → rows by kernel name."""
    from repro_torch.kernels import moe_shuffle, ops, ref

    gen = torch.Generator(device="cuda").manual_seed(7)
    c = _moe_shuffle_case(torch, gen, N, k, E, d, dtype)
    plan, x, rows, w, dbuf, dy = (c[n] for n in ("plan", "x", "rows", "w",
                                                 "dbuf", "dy"))
    n_slots = plan.src.numel()
    filled = int((plan.src >= 0).sum())
    dropped = 1 - filled / (N * k)
    kernel = {
        "moe_dispatch": lambda: moe_shuffle.moe_dispatch(x, plan.slot_tk,
                                                         plan.src),
        "moe_combine": lambda: moe_shuffle.moe_combine(rows, w,
                                                       plan.slot_tk),
        "moe_dispatch_bwd": lambda: moe_shuffle.moe_dispatch_bwd(
            dbuf, plan.slot_tk),
        "moe_combine_bwd": lambda: moe_shuffle.moe_combine_bwd(
            dy, rows, w, plan.slot_tk, plan.src),
    }
    xg, rg, wg = (t.detach().requires_grad_(True) for t in (x, rows, w))
    buf_p = ref.moe_dispatch_ref(xg, plan.order, plan.slot, n_slots, k)
    y_p = ref.moe_combine_ref(rg, wg, plan.order, plan.slot)
    plain = {
        "moe_dispatch": lambda: ref.moe_dispatch_ref(
            x, plan.order, plan.slot, n_slots, k),
        "moe_combine": lambda: ref.moe_combine_ref(rows, w, plan.order,
                                                   plan.slot),
        "moe_dispatch_bwd": lambda: torch.autograd.grad(
            buf_p, xg, dbuf, retain_graph=True)[0],
        "moe_combine_bwd": lambda: torch.autograd.grad(
            y_p, [rg, wg], dy, retain_graph=True),
    }
    out = {}
    for name in MOE_KERNELS:
        got, want = kernel[name](), plain[name]()
        if name == "moe_combine_bwd":
            worst = max(_row_worst(got[0], want[0]),
                        _row_worst(got[1].reshape(1, -1),
                                   want[1].reshape(1, -1)))
            err = max((a.float() - b.float()).abs().max().item()
                      for a, b in zip(got, want))
        else:
            worst = _row_worst(got, want)
            err = (got.float() - want.float()).abs().max().item()
        if name == "moe_dispatch" and not torch.equal(got, want):
            raise AssertionError(f"moe_dispatch at {label}: the slots "
                                 f"differ from the plain version's")
        if not worst <= 2e-2:
            raise AssertionError(f"{name} at {label}: a row is off by "
                                 f"{worst:.3g} of its max |plain|")
        del got, want
        turns = [timed_ms(kernel[name], 20)]
        plain_ms = timed_ms(plain[name], 5, warmup=1)
        turns.append(timed_ms(kernel[name], 20))
        nbytes, flops = ops.shuffle_work(name, N, k, n_slots, d,
                                         x.element_size(), filled)
        bms, by = bound_ms(nbytes, flops, str(dtype).split(".")[-1])
        ms = min(turns)
        out[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms,
                         bound_by=by, library_ms=None, max_abs_err=err)
        log(f"[kernels] {name} at {label} (N={N} k={k} E={E} "
            f"cap={n_slots // E} d={d}, {filled:,} of {n_slots:,} slots "
            f"filled, {100 * dropped:.2f}% of entries dropped): max abs "
            f"err {err:.3g}, worst row {worst:.3g}; kernel {ms:.4f} ms "
            f"(turns {turns[0]:.4f} / {turns[1]:.4f}; "
            f"{100 * bms / ms:.1f}% of the bound), plain {plain_ms:.4f} "
            f"ms, bound {bms:.4f} ms ({by}, {nbytes / 1e6:.1f} MB), none "
            f"(index_select + index_add)")
        torch.cuda.empty_cache()
    return out


def _check_flash_lse(torch, gen):
    """The flash kernel's per-row log-sum-exp (the training forward's
    second output) against the plain version's, f32 and bf16, and at
    the training path's shapes (one group: 4 × 512, 32 heads)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_fwd

    worst = 0.0
    cases = [(1, 17, 2, 1, 64, 0, 0.0), (2, 100, 2, 4, 128, 16, 30.0),
             (4, TRAIN_SEQ, 8, 4, 128, 0, 0.0)]
    for dtype in (torch.float32, torch.bfloat16):
        for B_, S, Kv, G, Dh, window, softcap in cases:
            q = torch.randn(B_, S, Kv * G, Dh, generator=gen,
                            device="cuda").to(dtype)
            k = torch.randn(B_, S, Kv, Dh, generator=gen,
                            device="cuda").to(dtype)
            v = torch.randn(B_, S, Kv, Dh, generator=gen,
                            device="cuda").to(dtype)
            _, lse = flash_attention_fwd(q, k, v, window=window,
                                         softcap=softcap, return_lse=True)
            _, want = ref.flash_attention_ref(q, k, v, window=window,
                                              softcap=softcap,
                                              return_lse=True)
            tol = 1e-4 if dtype == torch.float32 else 2e-2
            torch.testing.assert_close(lse, want, rtol=tol, atol=tol)
            worst = max(worst, (lse - want).abs().max().item())
    return worst


def _time_encdec_vlm(torch):
    """The attention kernels at whisper's and qwen2-vl's regimes, each
    beside SDPA, its plain version and its bound: flash over the
    encoder's frames and the cross-attention's queries (non-causal),
    flash at qwen2-vl's serve shape (G 6), decode over the cross cache,
    whisper's self-attention cache and qwen2-vl's."""
    for label, timer, kw in (
            (f"whisper's encoder (S=T={ENC_LEN}, non-causal)", _time_flash,
             dict(S=ENC_LEN, causal=False, **WHISPER_SHAPE)),
            (f"whisper's cross-attention (S={XATTN_SEQ}, T={ENC_LEN}, "
             f"non-causal)", _time_flash,
             dict(S=XATTN_SEQ, T=ENC_LEN, causal=False, **WHISPER_SHAPE)),
            (f"qwen2-vl's serve shape (S={PROMPT}, causal)", _time_flash,
             dict(S=PROMPT, **QWEN_SHAPE)),
            (f"whisper's cross cache (C={ENC_LEN}, q_pos={ENC_LEN - 1})",
             _time_decode, dict(C=ENC_LEN, q_pos=ENC_LEN - 1,
                                **WHISPER_SHAPE)),
            (f"whisper's self-attention (C={WHISPER_PROMPT + GEN + 1})",
             _time_decode, dict(S=WHISPER_PROMPT, **WHISPER_SHAPE)),
            (f"qwen2-vl's serve shape (C={PROMPT + GEN + 1})", _time_decode,
             dict(S=PROMPT, **QWEN_SHAPE))):
        r, row_err = timer(torch, **kw)
        log(f"[kernels] {timer.__name__[6:]}_attention at {label} (B={B} "
            f"H={kw['H']} Kv={kw['KV']} Dh={kw['DH']}): max abs err "
            f"{r['max_abs_err']:.3g}, worst row {row_err:.3g} of its max; "
            f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
            f"{1e3 * r['bound_ms']:.2f} us ({r['bound_by']}), sdpa "
            f"{r['library_ms']:.4f} ms")
        torch.cuda.empty_cache()


def phase_kernels():
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        t0 = time.perf_counter()
        n, worst = _grid_decode(torch, dtype, gen)
        log(f"[kernels] decode_attention == plain on {n} cases, {dtype}, "
            f"max abs err {worst:.3g} ({time.perf_counter() - t0:.1f} s)")
        t0 = time.perf_counter()
        n, worst = _grid_flash(torch, dtype, gen)
        log(f"[kernels] flash_attention == plain on {n} cases, {dtype}, "
            f"max abs err {worst:.3g} ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    lse_err = _check_flash_lse(torch, gen)
    log(f"[kernels] flash_attention log-sum-exp == plain (f32, bf16, "
        f"training shape), max abs err {lse_err:.3g} "
        f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    n, worst = _grid_combine(torch, gen)
    log(f"[kernels] coded_combine/_q/_q4/_f8 == plain on {n} cases, worst "
        f"row {worst:.3g} of its max |plain| "
        f"({time.perf_counter() - t0:.1f} s)")
    torch.cuda.empty_cache()
    rows = {}
    for name, timer in (("decode_attention", _time_decode),
                        ("flash_attention", _time_flash)):
        r, row_err = timer(torch)
        rows[name] = r
        log(f"[kernels] {name} at the serve shapes: max abs err "
            f"{r['max_abs_err']:.3g}, worst row {row_err:.3g} of its max; "
            f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
            f"{1e3 * r['bound_ms']:.2f} us ({r['bound_by']}), sdpa "
            f"{r['library_ms']:.4f} ms")
    r, row_err = _time_flash(torch, S=TRAIN_SEQ, with_lse=True)
    log(f"[kernels] flash_attention at the training shapes (S={TRAIN_SEQ}, "
        f"with log-sum-exp): max abs err {r['max_abs_err']:.3g}, worst row "
        f"{row_err:.3g} of its max; kernel {r['ms']:.4f} ms, plain "
        f"{r['plain_ms']:.4f} ms, bound {1e3 * r['bound_ms']:.2f} us "
        f"({r['bound_by']}), sdpa {r['library_ms']:.4f} ms")
    torch.cuda.empty_cache()
    for label, (S, h, kv, dh, window) in SERVE_SHAPES.items():
        for name, timer in (("decode_attention", _time_decode),
                            ("flash_attention", _time_flash)):
            r, row_err = timer(torch, S=S, H=h, KV=kv, DH=dh, window=window)
            log(f"[kernels] {name} at {label}'s serve shapes (B={B} S={S} "
                f"H={h} Kv={kv} Dh={dh} window={window}): max abs err "
                f"{r['max_abs_err']:.3g}, worst row {row_err:.3g} of its max; "
                f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                f"bound {1e3 * r['bound_ms']:.2f} us ({r['bound_by']}), "
                f"sdpa {r['library_ms']:.4f} ms")
        torch.cuda.empty_cache()
    for label, timer, kw in (
            (f"serve shape (S={REC_PROMPT})", _time_decode,
             dict(S=REC_PROMPT)),
            (f"training shape (S={TRAIN_SEQ}, with log-sum-exp)",
             _time_flash, dict(S=TRAIN_SEQ, with_lse=True)),
            ("S=4096", _time_flash, dict(S=4096))):
        r, row_err = timer(torch, **RG_SHAPE, **kw)
        log(f"[kernels] {timer.__name__[6:]}_attention at recurrentgemma's "
            f"{label} (B={B} H=10 Kv=1 Dh=256 window=2048): max abs err "
            f"{r['max_abs_err']:.3g}, worst row {row_err:.3g} of its max; "
            f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
            f"{1e3 * r['bound_ms']:.2f} us ({r['bound_by']}), sdpa "
            f"{r['library_ms']:.4f} ms")
        torch.cuda.empty_cache()
    _time_encdec_vlm(torch)
    r, row_err = _time_flash(torch, **PP_FLASH)
    log(f"[kernels] flash_attention at qwen2-vl's pipeline microbatch "
        f"(B={PP_MICRO} S={TRAIN_SEQ} H=12 Kv=2 Dh=128, with log-sum-exp): "
        f"max abs err {r['max_abs_err']:.3g}, worst row {row_err:.3g} of "
        f"its max; kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
        f"bound {1e3 * r['bound_ms']:.2f} us ({r['bound_by']}), sdpa "
        f"{r['library_ms']:.4f} ms")
    torch.cuda.empty_cache()
    for label, (kind, kw) in TP_ARCH_SHAPES.items():
        timer = _time_decode if kind == "decode" else _time_flash
        r, row_err = timer(torch, **kw)
        log(f"[kernels] {kind}_attention at {label} (B={B} H={kw['H']} "
            f"Kv={kw['KV']} Dh={kw['DH']}): max abs err "
            f"{r['max_abs_err']:.3g}, worst row {row_err:.3g} of its max; "
            f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
            f"{1e3 * r['bound_ms']:.2f} us ({r['bound_by']}), sdpa "
            f"{r['library_ms']:.4f} ms")
        torch.cuda.empty_cache()
    for label, (S, h, kv, dh, window) in TP_SHAPES.items():
        for name, timer, kw in (
                ("decode_attention", _time_decode, {}),
                ("flash_attention", _time_flash, {}),
                ("flash_attention", _time_flash,
                 dict(S=TRAIN_SEQ, with_lse=True))):
            kw = dict(dict(S=S, H=h, KV=kv, DH=dh, window=window), **kw)
            r, row_err = timer(torch, **kw)
            log(f"[kernels] {name} at {label} (B={B} S={kw['S']} H={h} "
                f"Kv={kv} Dh={dh}{', with log-sum-exp' if 'with_lse' in kw else ''}"
                f"): max abs err {r['max_abs_err']:.3g}, worst row "
                f"{row_err:.3g} of its max; kernel {r['ms']:.4f} ms, plain "
                f"{r['plain_ms']:.4f} ms, bound {1e3 * r['bound_ms']:.2f} us "
                f"({r['bound_by']}), sdpa {r['library_ms']:.4f} ms")
        torch.cuda.empty_cache()
    # the hop's largest leaf at tp 2 is half the embedding (d-sharded);
    # at pp 2 (qwen2-vl) every stage's is the whole tied table
    shapes = [("f32", 8, 8, WD_F, 1), ("f32", 1, 8, WD_F, 1),
              ("int8", 1, 2, EMBED_F, HOP_BLOCK),
              ("int4", 1, 2, EMBED_F, HOP_BLOCK),
              ("fp8", 1, 2, EMBED_F, HOP_BLOCK),
              ("int8", 1, 2, EMBED_F // TP, HOP_BLOCK),
              ("int8", 1, 2, QWEN_TABLE_F, HOP_BLOCK)]
    for kind, R, K, F, block in shapes:
        r, share, turns = _time_combine(torch, kind, R, K, F, block)
        name = COMBINE[kind][0]
        lib = ("none (no single PyTorch call dequantizes and combines)"
               if r["library_ms"] is None
               else f"torch.mm {r['library_ms']:.4f} ms")
        log(f"[kernels] {name} at R={R} K={K} F={F} block={block}: max abs "
            f"err {r['max_abs_err']:.3g}, worst row {share:.3g}; kernel "
            f"{r['ms']:.4f} ms (first / last turn {turns[0]:.4f} / "
            f"{turns[1]:.4f}), plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), {lib}")
        if name not in rows:  # the first shape of each kernel is its row
            rows[name] = r
        torch.cuda.empty_cache()
    for label, (N, k, E, d) in MOE_SHUFFLE_SHAPES.items():
        r = _time_moe_shuffle(torch, label, N, k, E, d, torch.bfloat16)
        if label == "granite-moe training":
            rows.update(r)
    checked, turns, plain_ms, bms, by = _time_combine_eval(torch)
    log(f"[kernels] coded_combine at the evaluation shape R=1 K={EVAL_K} "
        f"F={CNN_F} (graph replay, in turns): " + ", ".join(
            f"{name} {min(ts):.4f} ms ({100 * bms / min(ts):.1f}% of the "
            f"bound; turns {' / '.join(f'{t:.4f}' for t in ts)})"
            for name, ts in turns.items())
        + f"; plain {plain_ms:.4f} ms, bound {bms:.4f} ms ({by}); worst "
        + ", ".join(f"{layout} row {share:.3g} (max abs err {err:.3g})"
                    for layout, (share, err) in checked.items()))
    torch.cuda.empty_cache()
    return rows


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def phase_parity():
    """llama3-8b at full width cut to 2 layers, card against CPU
    (:func:`_parity`)."""
    import torch

    _parity(torch, "llama3-8b", 2)


def device_ms_by_phase(prof):
    """Device time of one profiled serve request, by phase and name.

    The serve CLI's spans bound the phases on the host clock: the
    device is idle when "serve.prefill" starts and done when it ends, and
    done again when "serve.request" ends, so a kernel belongs to the
    phase in which it started."""
    import collections

    from torch.autograd import DeviceType

    events = prof.events()
    span = {e.name: e.time_range for e in events
            if e.device_type == DeviceType.CPU
            and e.name in ("serve.prefill", "serve.request")}
    if len(span) != 2:
        raise AssertionError(f"profiler spans missing: found {sorted(span)}")
    phases = {"prefill": (span["serve.prefill"].start,
                          span["serve.prefill"].end),
              "decode": (span["serve.prefill"].end,
                         span["serve.request"].end)}
    out = {ph: collections.Counter() for ph in phases}
    for e in events:
        if e.device_type != DeviceType.CUDA or e.is_user_annotation:
            continue
        for ph, (lo, hi) in phases.items():
            if lo <= e.time_range.start < hi:
                out[ph][e.name] += e.time_range.elapsed_us() / 1e3
    if not all(out.values()):
        raise AssertionError("the profiler saw no device work in a phase")
    return out


def phase_serve():
    """The serve CLI at full size (llama3-8b, 32 layers, 1024-token
    prompts) three times, as :func:`_serve_runs` sets out → the counted
    run's launches, and its peak memory and device ms a phase."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import serve

    argv = ["--arch", "llama3-8b", "--no-smoke", "--batch", str(B),
            "--prompt-len", str(PROMPT), "--gen", str(GEN)]
    measured = {}
    counts = _serve_runs(lambda: serve.main(argv), get_config("llama3-8b"),
                         measured=measured)
    return counts, measured


def _attn_layers(cfg) -> int:
    return sum(cfg.layer_kind(i) in ("global", "local")
               for i in range(cfg.n_layers))


def _serve_launches(cfg, prompt: int) -> dict:
    """A request's exact launches: with the bulk handoff one flash launch
    per attention layer and one decode launch per attention layer and
    new token (and a dispatch and a combine launch per MoE layer for the
    prompt and for each new token); with the exact handoff (recurrent archs) no flash launch
    and one decode launch per attention layer and token, prompt tokens
    included; an encoder–decoder model adds a flash launch per encoder
    layer and a cross decode per decoder layer and token."""
    from repro_torch.models import transformer as tf

    n = _attn_layers(cfg)
    if tf.bulk_prefill_supported(cfg):
        # the MoE layers: one forward for the prompt, one a new token
        want = {"flash_attention": n, "decode_attention": n * GEN,
                **moe_launches(cfg, 1 + GEN)}
    elif cfg.is_encdec:
        # the encoder once a request, then a self and a cross decode
        # launch per decoder layer and token
        want = {"flash_attention": cfg.n_enc_layers,
                "decode_attention": 2 * n * (prompt + GEN)}
    else:
        want = {"decode_attention": n * (prompt + GEN)}
    return {k: v for k, v in want.items() if v}


def _serve_runs(request, cfg, label="", prompt=PROMPT, warm=None,
                profiled=None, measured=None):
    """One served config, three requests: the first (``warm``, or one
    like the others) pays the one-time costs (cuBLAS heuristics, library
    loads), the second is the counted run — launch counts set to 0 just
    before it, read just after, and exactly :func:`_serve_launches` —
    and the third (``profiled``: ``(request, prompt, new tokens)``, or
    one like the others) runs under ``torch.profiler`` for the device
    time of each phase, set against the counted run's host times (the
    profiler slows the host): the bulk prefill per request, the exact
    handoff and the decode per token; the counted run's peak memory and
    the device ms of each phase go into the dict ``measured`` where one
    is given.
    → the counted run's launches."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tf

    tag = f"[serve] {label}: " if label else "[serve] "
    cold = (warm or request)()
    log(f"{tag}first request: prefill {cold['prefill_ms']:.2f} ms, "
        f"decode {cold['decode_ms_per_token']:.3f} ms/token")
    del cold
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    res = request()
    counts = {k: v for k, v in _launches().items() if v}
    want = _serve_launches(cfg, prompt)
    if counts != want:
        raise AssertionError(f"{label} launch counts {counts}, expected "
                             f"{want}")
    toks = res["tokens"]
    if toks.shape != (B, GEN) or not ((toks >= 0)
                                      & (toks < cfg.vocab)).all():
        raise AssertionError(f"{label} bad tokens {toks.shape}")
    logits = res["last_logits"]
    if tuple(logits.shape) != (B, cfg.vocab) \
            or not torch.isfinite(logits).all():
        raise AssertionError(f"{label} last logits not finite / wrong shape")
    _SERVED[label] = np.asarray(toks)
    if measured is not None:
        measured.update(peak=res["max_memory_allocated"], device_ms={})
    log(f"{tag}launches {counts}; prefill {res['prefill_ms']:.2f} ms, "
        f"decode {res['decode_ms_per_token']:.3f} ms/token, "
        f"{res['tok_per_s']:.1f} tok/s, max memory allocated "
        f"{res['max_memory_allocated'] / 2**30:.2f} GiB; "
        f"tokens[0][:8] {np.asarray(toks[0][:8]).tolist()}")
    del logits, res["last_logits"]
    torch.cuda.empty_cache()

    prof_request, p_prompt, p_gen = profiled or (request, prompt, GEN)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_res = prof_request()
    by_phase = device_ms_by_phase(prof)
    # units: the bulk prefill, or the encoder and its handoff, a request;
    # the exact handoff a prompt token
    bulk = tf.bulk_prefill_supported(cfg) or cfg.is_encdec
    n, p_n = (1, 1) if bulk else (prompt, p_prompt)
    host = {"prefill": (res["prefill_ms"] / n, prof_res["prefill_ms"] / p_n,
                        p_n, "ms" if bulk else "ms/token"),
            "decode": (res["decode_ms_per_token"],
                       prof_res["decode_ms_per_token"], p_gen, "ms/token")}
    ptag = f"[profile] {label} " if label else "[profile] "
    _, launches, missing = _device_records(prof, DeviceType)
    log(f"{ptag}{launches - missing} of {launches} launches have their "
        f"device record (a session that lacks some reads low)")
    if (p_prompt, p_gen) != (prompt, GEN):
        log(f"{ptag}profiled request: {p_prompt}-token prompts, {p_gen} "
            f"new tokens")
    for ph, (host_ms, prof_ms, per, unit) in host.items():
        dev_ms = sum(by_phase[ph].values()) / per
        if measured is not None:
            measured["device_ms"][ph] = dev_ms
        log(f"{ptag}{ph}: device {dev_ms:.3f} {unit} over the counted "
            f"run's host {host_ms:.3f} {unit}: device busy "
            f"{100 * dev_ms / host_ms:.1f}% (host under the profiler "
            f"{prof_ms:.3f} {unit})")
        if ph == "prefill" and cfg.is_encdec:
            enc_ms, enc_n = _encode_device_ms(prof, DeviceType)
            log(f"{ptag}  of which the encoder: device {enc_ms:.3f} ms "
                f"({enc_n} kernels launched under serve.encode), the "
                f"{p_prompt}-token handoff "
                f"{(dev_ms - enc_ms) / p_prompt:.3f} ms/token")
        for name, ms in by_phase[ph].most_common(8):
            log(f"{ptag}  {ms / per:9.3f} {unit}  {name[:90]}")
    del prof_res, prof
    torch.cuda.empty_cache()
    return counts


# phase "archs": the configs served beside llama3-8b.  Layers kept for
# the card-vs-CPU parity (the fewest that hold every kind of layer the
# config has) and for serving through the CLI (None: the whole config;
# gemma3 at 32 of its 62 layers, five (5 local, 1 global) groups and the
# 2 rest layers, and granite-moe at 8 of its 32 identical MoE layers:
# the script's time limit makes room for phase "pp"); the prompt length
# (gemma3's passes its 1024-token window)
ARCHS = {  # arch → (parity layers, served layers, prompt)
    "granite-8b": (2, None, PROMPT),
    "starcoder2-3b": (2, None, PROMPT),
    "gemma3-27b": (6, 32, 2048),
    "granite-moe-3b-a800m": (2, 8, PROMPT),
    "llama4-maverick-400b-a17b": (2, 2, PROMPT),  # 48 layers: ≈ 800 GB
}
HANDOFF_PROMPT = 1088   # gemma3's bulk vs exact handoff, 6 layers
# new tokens of each config's profiled request: the profiler's trace of
# a request costs seconds a decode step to read back (granite-moe's
# ~3000 kernels a step most), and device time is taken per token
ARCHS_PROFILED_GEN = 8
MOE_TRAIN_LAYERS = 4    # granite-moe's coded training


class _RouteLog:
    """Records ``models.moe.route``'s expert choices while it is entered:
    one ``(top_e, cap)`` per MoE layer call, on the host."""

    def __init__(self, moe_lib):
        self.moe_lib, self.calls = moe_lib, []

    def __enter__(self):
        route = self.orig = self.moe_lib.route

        def recorded(router, xf, top_k, *a, **kw):
            out = route(router, xf, top_k, *a, **kw)
            self.calls.append(out[2].cpu())
            return out

        self.moe_lib.route = recorded
        return self

    def __exit__(self, *exc):
        self.moe_lib.route = self.orig

    def take(self):
        calls, self.calls = self.calls, []
        return calls


def _kept_experts(moe_lib, top_e, E, cap_factor):
    """Each token's routed experts that the capacity keeps, sorted, -1
    where dropped: what its output depends on."""
    import torch

    N, k = top_e.shape
    cap = moe_lib.capacity(N, k, E, cap_factor)
    order, slot, _ = moe_lib.dispatch_slots(top_e, E, cap)
    kept = torch.empty_like(slot)
    kept[order] = slot
    return torch.where(kept.reshape(N, k) < E * cap, top_e,
                       torch.full_like(top_e, -1)).sort(-1).values


def _parity(torch, arch, n_layers, seed=0):
    """Card against CPU at full width, float32: weights made on the card
    from ``seed`` and copied to the CPU; a bulk prefill of 2 × 64 tokens
    then 8 greedy decode steps, the CPU teacher-forced on the card's
    tokens; logits within 2e-3 · max|logit|.  For MoE every routing is
    recorded on both sides: a row whose kept experts differ in a call (a
    route flip at a near-tie, or a capacity drop it moves) is counted and
    left out of that call's check and the later ones; more than 1% of
    such rows fails."""
    from repro_torch.api import serving
    from repro_torch.configs.registry import get_config
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import transformer as tf

    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers,
                              dtype="float32")
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    gpu = tf.init_params(cfg, gen, device="cuda", dtype=torch.float32)
    cpu = _to(gpu, "cpu")
    prompt = torch.randint(0, cfg.vocab, (2, 64), generator=gen,
                           device="cuda")
    max_len = 64 + 8 + 1
    worst, flips, routed, excluded = 0.0, 0, 0, set()

    def check(lg, lc, routes_g, routes_c, what, token_row):
        nonlocal worst, flips, routed
        for rg, rc in zip(routes_g, routes_c):
            kg = _kept_experts(moe_lib, rg, cfg.n_experts,
                               cfg.capacity_factor)
            kc = _kept_experts(moe_lib, rc, cfg.n_experts,
                               cfg.capacity_factor)
            diff = (kg != kc).any(-1)
            flips += int((rg.sort(-1).values != rc.sort(-1).values)
                         .any(-1).sum())
            routed += rg.shape[0]
            excluded.update(int(token_row(i))
                            for i in diff.nonzero().flatten())
        rows = [b for b in range(lg.shape[0]) if b not in excluded]
        if not rows:
            raise AssertionError(f"{arch} {what}: every row's route "
                                 f"differs card vs cpu")
        lg, lc = lg.cpu()[rows], lc[rows]
        scale = lc.abs().max().item()
        err = (lg - lc).abs().max().item()
        worst = max(worst, err / scale)
        if not err <= 2e-3 * scale:
            raise AssertionError(f"{arch} {what}: max |card - cpu| {err:.3g}"
                                 f" > 2e-3 * {scale:.3g}")

    with torch.inference_mode(), _RouteLog(moe_lib) as log_routes:
        if not tf.bulk_prefill_supported(cfg):
            # the prefill below is the exact handoff; the full forward
            # (the training path's layers: SSD chunks, the RG-LRU scan,
            # the flash kernel) is held on its own
            lg = tf.forward(gpu, cfg, prompt)[0]
            check(lg, tf.forward(cpu, cfg, prompt.cpu())[0],
                  log_routes.take(), log_routes.take(), "forward",
                  lambda i: i)
        prefill = serving.make_prefill_fn(cfg, max_len)
        decode = serving.make_decode_fn(cfg)
        lg, cg = prefill(gpu, prompt)
        rg = log_routes.take()
        lc, cc = prefill(cpu, prompt.cpu())
        check(lg, lc, rg, log_routes.take(), "prefill", lambda i: i // 64)
        for step in range(8):
            tok = torch.argmax(lg, -1)[:, None].to(torch.int32)
            lg, cg = decode(gpu, tok, cg)
            rg = log_routes.take()
            lc, cc = decode(cpu, tok.cpu(), cc)  # teacher-forced
            check(lg, lc, rg, log_routes.take(), f"decode step {step}",
                  lambda i: i)
    if flips > 0.01 * max(routed, 1) or len(excluded) > 0.01 * 2 * 9 + 1:
        raise AssertionError(f"{arch}: {flips} route flips of {routed}, "
                             f"rows left out {sorted(excluded)}")
    log(f"[parity] {arch} full width, {n_layers} layers, f32: card "
        f"== cpu over "
        + ("prefill" if tf.bulk_prefill_supported(cfg)
           else "the forward, the exact handoff")
        + f" + 8 decode steps, max err {worst:.3g} x "
        f"max|logit|" + (f"; route flips {flips} of {routed} routed tokens, "
                         f"rows left out {sorted(excluded)}"
                         if cfg.is_moe else "")
        + f" ({time.perf_counter() - t0:.1f} s)")
    del cpu, gpu, cg, cc
    torch.cuda.empty_cache()


def _handoff_pair(torch, cfg, params, prompt, tol):
    """Bulk and exact handoffs of ``prompt`` into ``max_len = S + 9``
    caches, then 8 decode steps fed the bulk run's greedy tokens: logits
    at every step and every ring within ``tol`` · max|exact| (of each
    tensor).  → (worst share of the limit, greedy tokens equal, of 16,
    exact handoff s)."""
    from repro_torch.api import serving

    max_len = prompt.shape[1] + 8 + 1
    worst = 0.0

    def close(a, b, what):
        nonlocal worst
        a, b = a.float(), b.float()
        err = (a - b).abs().max().item()
        limit = tol * b.abs().max().item()
        worst = max(worst, err / limit)
        if not err <= limit:
            raise AssertionError(f"gemma3 handoff {cfg.dtype} {what}: max "
                                 f"|bulk - exact| {err:.3g} > {limit:.3g}")

    lb, cb = serving.make_prefill_fn(cfg, max_len)(params, prompt)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    le, ce = serving.make_prefill_fn(cfg, max_len, exact=True)(params, prompt)
    torch.cuda.synchronize()
    exact_s = time.perf_counter() - t0
    close(lb, le, "prefill logits")
    ring = cb["groups"]["p0"]["k"]
    if ring.shape[-2] != cfg.window:
        raise AssertionError(f"local ring {tuple(ring.shape)}")
    decode = serving.make_decode_fn(cfg)
    same = 0
    for step in range(8):
        tok = torch.argmax(lb, -1)[:, None].to(torch.int32)
        same += int((tok == torch.argmax(le, -1)[:, None]).sum())
        lb, cb = decode(params, tok, cb)
        le, ce = decode(params, tok, ce)
        close(lb, le, f"decode step {step}")
    for part in ("groups", "rest"):
        for key, entry in cb[part].items():
            for name in ("k", "v"):
                close(entry[name], ce[part][key][name], f"{part}/{key}/{name}")
    return worst, same, exact_s


def _gemma3_handoff(torch):
    """gemma3 at full width cut to 6 layers (5 local, 1 global): a
    1088-token prompt handed off in bulk (the local rings trimmed to the
    1024-token window, so slot 64 holds position 1088) and token by
    token, then 8 decode steps.  In float32 the two agree as the card
    agrees with the CPU (2e-3 · max|logit|, phase 3's gate): the trim
    and the wrapped rings are exact.  In bf16, with the same weights
    cast, within the reference's bf16 decode tolerance
    (tests/test_decode_consistency.py: 5e-2 on smoke logits of
    max|logit| ≈ 1) taken on the logits' scale: 5e-2 · max|logit|."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as tf

    cfg = dataclasses.replace(get_config("gemma3-27b"), n_layers=6,
                              dtype="float32")
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = tf.init_params(cfg, gen, device="cuda", dtype=torch.float32)
    prompt = torch.randint(0, cfg.vocab, (2, HANDOFF_PROMPT), generator=gen,
                           device="cuda")
    out = {}
    with torch.inference_mode():
        out["float32"] = _handoff_pair(torch, cfg, params, prompt, 2e-3)
        cfg = dataclasses.replace(cfg, dtype="bfloat16")
        params = tf.cast_params(params, cfg)
        out["bfloat16"] = _handoff_pair(torch, cfg, params, prompt, 5e-2)
    log(f"[archs] gemma3 handoff, 6 layers, {HANDOFF_PROMPT}-token prompt: "
        f"bulk == exact over the prompt, 8 decode steps and every ring; "
        + "; ".join(f"{dt}: worst {w:.3g} of the limit, greedy tokens "
                    f"equal {same} of 16, exact handoff {s:.1f} s"
                    for dt, (w, same, s) in out.items())
        + f" ({time.perf_counter() - t0:.1f} s)")
    del params
    torch.cuda.empty_cache()


def _coded_twice(torch, arch, n_layers, totals, tag="[archs]"):
    """``arch`` at full width (cut to ``n_layers``, None: every layer),
    ``CodedSession.fit`` in coded_q int8 on the phase-6 cluster (adamw,
    seq 512, edge 1 dropped at step 2), 4 steps, run twice from the same
    seed: exact launches each step (the int8 combine once per param
    leaf, flash 8 groups × the attention layers × 2 for the remat),
    finite losses (and, for MoE, aux losses), and the two runs' losses
    and trained params equal bit for bit."""
    import numpy as np

    from repro_torch import _tree
    from repro_torch.configs.registry import get_config

    cfg = get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    kw = dict(_train_kw(), total_steps=CKPT_STEPS)
    fit = dict(force_drop_edge=1, force_drop_step=2)
    runs = []
    for run in range(2):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        session = _session(cfg, "coded_q", "int8", "cuda", **kw)
        leaves = _tree.leaves(session.params)
        # every group's layers run forward twice (the remat) and back once
        want = {"coded_combine_q": len(leaves),
                "flash_attention": GROUPS * _attn_layers(cfg) * 2,
                **moe_launches(cfg, 2 * GROUPS, GROUPS)}
        want = {k: v for k, v in want.items() if v}
        step_ms = _counted_steps(session, 0, CKPT_STEPS, want, totals, **fit)
        losses, aux = list(session.losses), list(session.aux_losses)
        if not (np.isfinite(losses).all() and np.isfinite(aux).all()
                and len(aux) == (CKPT_STEPS if cfg.is_moe else 0)):
            raise AssertionError(f"{arch} losses {losses}, aux {aux}")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"{tag} {arch} coded_q int8, {cfg.n_layers} layers "
            f"({sum(p.numel() for p in leaves):,} params, {len(leaves)} "
            f"leaves), run {run}: losses {[round(x, 5) for x in losses]}"
            + (f", aux {[round(x, 5) for x in aux]}" if aux else "")
            + f", host ms per step {[round(x, 1) for x in step_ms]}, peak "
            f"{peak:.2f} GiB; launches per step {want} "
            f"({time.perf_counter() - t0:.1f} s)")
        runs.append((losses, aux, [p.detach().clone() for p in leaves]))
        del session, leaves
    (l0, a0, p0), (l1, a1, p1) = runs
    same = sum(bool(torch.equal(a, b)) for a, b in zip(p0, p1))
    if l0 != l1 or a0 != a1 or same != len(p0):
        raise AssertionError(f"{arch} runs differ: losses {l0} / {l1}, "
                             f"aux {a0} / {a1}, {same} of {len(p0)} leaves "
                             f"equal")
    log(f"{tag} {arch}: the two runs' losses{', aux losses' if a0 else ''} "
        f"and {len(p0)} trained leaves equal bit for bit")
    del runs, p0, p1
    torch.cuda.empty_cache()


def phase_archs():
    """The five configs beside llama3-8b: card against CPU at full width
    (float32, cut in depth), each served at full width in bf16 through
    the serve CLI with exact launch counts (``ARCHS``' depths), gemma3's
    windowed
    bulk handoff against the exact one, and granite-moe's coded MoE
    training repeated bit for bit.  → the launches of the served
    requests and the training steps."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    totals = {name: 0 for name in ops.KERNELS}
    for arch, (layers, _, _) in ARCHS.items():
        _parity(torch, arch, layers)
    for arch, (_, served, prompt) in ARCHS.items():
        t0 = time.perf_counter()
        cfg = get_config(arch)
        argv = ["--arch", arch, "--no-smoke", "--batch", str(B),
                "--prompt-len", str(prompt)]
        label = arch
        if served is not None:
            cfg = dataclasses.replace(cfg, n_layers=served)
            argv += ["--layers", str(served)]
            label = f"{arch} ({served} layers)"

        def request(gen):
            return lambda: serve.main(argv + ["--gen", str(gen)])
        counts = _serve_runs(request(GEN), cfg, label, prompt=prompt,
                             profiled=(request(ARCHS_PROFILED_GEN), prompt,
                                       ARCHS_PROFILED_GEN))
        for k, v in counts.items():
            totals[k] += v
        log(f"[archs] served {arch}: {cfg.n_layers} layers, "
            f"{cfg.param_counts()[0]:,} params, {prompt}-token "
            f"prompts ({time.perf_counter() - t0:.1f} s)")
    _gemma3_handoff(torch)
    _coded_twice(torch, "granite-moe-3b-a800m", MOE_TRAIN_LAYERS, totals)
    return totals


# phase "recurrent": the SSD and RG-LRU archs.  Layers kept for the
# card-vs-CPU parity (mamba2 2; recurrentgemma 5: one (rec, rec, local)
# group and 2 rest layers, as its 26 = 8 x 3 + 2) and for the coded
# training and serving (mamba2 trained at 8 and served at 24 of its 48
# identical SSD layers; recurrentgemma served at 14 of its 26: four (rec,
# rec, local) groups and the 2 rest layers; the script's time limit
# makes room for phase "pp")
RECURRENT = {  # arch → (parity layers, trained layers, served layers)
    "mamba2-370m": (2, 8, 24),
    "recurrentgemma-2b": (5, 5, 14),
}


def phase_recurrent():
    """mamba2-370m and recurrentgemma-2b: card against CPU at full width
    (float32, cut in depth; the full forward, then the exact handoff of
    the prompt and 8 decode steps), each served at full width in bf16
    (``RECURRENT``'s depth) through the serve CLI as phase 4 but for
    256-token prompts
    (the exact handoff runs one decode step a prompt token; a short
    request warms up), and each trained in coded_q int8 twice, bit for
    bit.  → the launches of the served requests and the training
    steps."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    totals = {name: 0 for name in ops.KERNELS}
    for arch, (layers, _, _) in RECURRENT.items():
        _parity(torch, arch, layers)
    for arch, (_, _, served) in RECURRENT.items():
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config(arch), n_layers=served)
        argv = ["--arch", arch, "--no-smoke", "--batch", str(B),
                "--layers", str(served)]

        def request(prompt, gen):
            return lambda: serve.main(argv + ["--prompt-len", str(prompt),
                                              "--gen", str(gen)])

        counts = _serve_runs(
            request(REC_PROMPT, GEN), cfg, arch, prompt=REC_PROMPT,
            warm=request(8, 4),
            profiled=(request(*REC_PROFILED), *REC_PROFILED))
        for k, v in counts.items():
            totals[k] += v
        log(f"[recurrent] served {arch}: {cfg.n_layers} layers, "
            f"{cfg.param_counts()[0]:,} params, {REC_PROMPT}-token prompts "
            f"({time.perf_counter() - t0:.1f} s)")
    for arch, (_, trained, _) in RECURRENT.items():
        _coded_twice(torch, arch, trained, totals, tag="[recurrent]")
    return totals


# phase "encdec_vlm": whisper-medium and qwen2-vl-2b.  Layers kept for
# the card-vs-CPU parity (whisper: encoder, decoder) and the vision
# layout's patch grid (qwen2-vl: 8 × 8 patches, then as many text tokens)
ENCDEC_PARITY_LAYERS = (2, 2)
VLM_PARITY_LAYERS, VLM_GRID = 2, 8
#: qwen2-vl's coded training here: 14 of its 28 identical layers (phase
#: "pp" trains it whole, at pp 1 and at pp 2; the script's time limit)
VLM_TRAIN_LAYERS = 14


def vision_positions(torch, B, grid, n_text):
    """(3, B, grid² + n_text) M-RoPE positions as Qwen2-VL lays out an
    image then text: patch i at ``(t, h, w) = (0, i // grid, i % grid)``,
    then the text from ``max + 1`` on in all three streams."""
    i = torch.arange(grid * grid)
    vis = torch.stack([torch.zeros_like(i), i // grid, i % grid])
    start = int(vis.max()) + 1
    text = torch.arange(start, start + n_text).expand(3, n_text)
    return torch.cat([vis, text], 1)[:, None].expand(3, B, -1)


def _logits_close(torch, got, want, what):
    """``got`` (card) within 2e-3 · max|want| (CPU), phase 3's gate; →
    the error as a share of max|want|."""
    got, want = got.float().cpu(), want.float()
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    if not (torch.isfinite(got).all() and err <= 2e-3 * scale):
        raise AssertionError(f"{what}: max |card - cpu| {err:.3g} > 2e-3 * "
                             f"{scale:.3g}")
    return err / scale


def _encdec_vlm_parity(torch):
    """Card against CPU in float32 at full width, the weights made on
    the card and copied: whisper cut to 2 encoder + 2 decoder layers (a
    2 × 64-token forward over 1500 seeded frames; then the exact handoff
    of a 16-token prompt, the cross cache filled first, and 8 greedy
    decode steps, the CPU teacher-forced on the card's tokens); qwen2-vl
    cut to 2 layers (a 2 × 128-token forward with visual embeddings on
    the first 64 positions over the vision layout's 3-D positions, where
    unequal streams exercise M-RoPE's sections; then the bulk prefill
    and 8 decode steps)."""
    from repro_torch.api import serving
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as tf

    enc_layers, dec_layers = ENCDEC_PARITY_LAYERS
    runs = {
        "whisper-medium": dataclasses.replace(
            get_config("whisper-medium"), n_layers=dec_layers,
            n_enc_layers=enc_layers, dtype="float32"),
        "qwen2-vl-2b": dataclasses.replace(
            get_config("qwen2-vl-2b"), n_layers=VLM_PARITY_LAYERS,
            dtype="float32"),
    }
    for arch, cfg in runs.items():
        t0 = time.perf_counter()
        gen = torch.Generator(device="cuda").manual_seed(2)
        gpu = tf.init_params(cfg, gen, device="cuda", dtype=torch.float32)
        cpu = _to(gpu, "cpu")
        worst = 0.0
        with torch.inference_mode():
            if cfg.is_encdec:
                S, prompt_len = XATTN_SEQ, WHISPER_PROMPT
                extra = {"enc_frames": torch.randn(
                    (2, cfg.enc_len, cfg.d_model), generator=gen,
                    device="cuda")}
            else:
                n_vis = VLM_GRID * VLM_GRID
                S = prompt_len = 2 * n_vis
                extra = {"visual_embeds": torch.randn(
                    (2, n_vis, cfg.d_model), generator=gen, device="cuda"),
                    "positions": vision_positions(
                        torch, 2, VLM_GRID, S - n_vis).cuda()}
            tokens = torch.randint(0, cfg.vocab, (2, S), generator=gen,
                                   device="cuda")
            lg = tf.forward(gpu, cfg, tokens, **extra)[0]
            lc = tf.forward(cpu, cfg, tokens.cpu(),
                            **{k: v.cpu() for k, v in extra.items()})[0]
            worst = max(worst, _logits_close(torch, lg, lc,
                                             f"{arch} forward"))
            prompt = tokens[:, :prompt_len]
            frames = extra.get("enc_frames")
            args_g = (frames,) if cfg.is_encdec else ()
            args_c = (frames.cpu(),) if cfg.is_encdec else ()
            prefill = serving.make_prefill_fn(cfg, prompt_len + 9)
            decode = serving.make_decode_fn(cfg)
            lg, cg = prefill(gpu, prompt, *args_g)
            lc, cc = prefill(cpu, prompt.cpu(), *args_c)
            worst = max(worst, _logits_close(torch, lg, lc,
                                             f"{arch} prefill"))
            for step in range(8):
                tok = torch.argmax(lg, -1)[:, None].to(torch.int32)
                lg, cg = decode(gpu, tok, cg)
                lc, cc = decode(cpu, tok.cpu(), cc)
                worst = max(worst, _logits_close(
                    torch, lg, lc, f"{arch} decode step {step}"))
        how = ("the exact handoff (cross cache filled)"
               if cfg.is_encdec else "the bulk prefill")
        log(f"[encdec_vlm] parity {arch} full width, "
            + (f"{enc_layers} + {dec_layers}" if cfg.is_encdec
               else f"{cfg.n_layers}")
            + f" layers, f32: card == cpu over the {S}-token forward "
            f"({', '.join(sorted(extra))}), {how} of {prompt_len} tokens "
            f"and 8 decode steps, max err {worst:.3g} x max|logit| "
            f"({time.perf_counter() - t0:.1f} s)")
        del gpu, cpu, cg, cc
        torch.cuda.empty_cache()


def _encdec_train(torch, totals):
    """whisper at full width cut to 2 + 2 layers through
    ``make_train_step`` (adamw) on a batch of 4 × 64 tokens over 1500
    seeded frames: the step-0 gradients on the card against the CPU's
    (phase 5's rule: within 1e-4 of each leaf's largest plus two f32
    spacings of the value; the encoder's unused cross-attention leaves
    zero on both), then 4 steps on the card with finite losses."""
    import numpy as np

    from repro_torch import _tree
    from repro_torch.checkpoint.params import _flatten
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tf

    t0 = time.perf_counter()
    enc_layers, dec_layers = ENCDEC_PARITY_LAYERS
    cfg = dataclasses.replace(get_config("whisper-medium"),
                              n_layers=dec_layers, n_enc_layers=enc_layers,
                              dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(3)
    gpu = tf.init_params(cfg, gen, device="cuda", dtype=torch.float32)
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, XATTN_SEQ),
                                     generator=gen, device="cuda"),
             "targets": torch.randint(0, cfg.vocab, (B, XATTN_SEQ),
                                      generator=gen, device="cuda"),
             "weights": torch.ones((B, XATTN_SEQ), device="cuda"),
             "enc_frames": torch.randn((B, cfg.enc_len, cfg.d_model),
                                       generator=gen, device="cuda")}
    cpu = _to(gpu, "cpu")
    for tree in (gpu, cpu):
        for p in _tree.leaves(tree):
            p.requires_grad_(True)
    g_card = _flatten(_tree.unflatten_like(
        gpu, steps._grads(gpu, cfg, batch)[0]))
    g_cpu = _flatten(_tree.unflatten_like(
        cpu, steps._grads(cpu, cfg, _to(batch, "cpu"))[0]))
    off = total = zero = 0
    for key, b in g_cpu.items():
        a, b = g_card[key].cpu().numpy(), b.numpy()
        tol = 1e-4 * np.abs(b).max() + 2 * np.spacing(np.abs(b))
        off += int((np.abs(a - b) > tol).sum())
        total += b.size
        if key.startswith("encoder/groups/p0/") and (
                "/xattn/" in key or "/norm_x/" in key):
            if a.any() or b.any():
                raise AssertionError(f"{key}: an unused leaf's gradient is "
                                     f"not zero")
            zero += 1
    if off or zero != 6:
        raise AssertionError(f"whisper step-0 gradients: {off} of {total} "
                             f"values off card vs cpu; {zero} zero leaves")
    del cpu, g_cpu, g_card
    step = steps.make_train_step(cfg, TrainConfig(
        optimizer="adamw", lr=1e-3, total_steps=4, warmup_steps=1))
    state = step.optimizer.init(gpu)
    losses = []
    ops.reset_launch_counts()
    for t in range(4):
        _, _, m = step(gpu, state, batch, t + 1)
        losses.append(float(m["loss"]))
    counts = _launches()
    for k, v in counts.items():
        totals[k] += v
    if not np.isfinite(losses).all():
        raise AssertionError(f"whisper train losses {losses}")
    log(f"[encdec_vlm] whisper make_train_step, {enc_layers} + {dec_layers} "
        f"layers, batch {B} x {XATTN_SEQ} over {cfg.enc_len} frames: step-0 "
        f"gradients card == cpu ({total:,} values, the encoder's 6 unused "
        f"cross-attention leaves zero on both); adamw losses "
        f"{[round(x, 5) for x in losses]}; launches "
        f"{ {k: v for k, v in counts.items() if v} } "
        f"({time.perf_counter() - t0:.1f} s)")
    del gpu, state, batch
    torch.cuda.empty_cache()


def phase_encdec_vlm():
    """whisper-medium and qwen2-vl-2b: card against CPU at full width
    (float32, cut in depth, :func:`_encdec_vlm_parity`); each served at
    full width and depth in bf16 through the serve CLI with exact
    launches (qwen2-vl as phase 4: bulk prefill of 1024-token prompts;
    whisper: 1500 seeded frames encoded once a request, a 16-token
    prompt handed off token by token; the profiled whisper request 16 +
    8 tokens); qwen2-vl trained (``VLM_TRAIN_LAYERS``) in coded_q int8
    twice, bit for bit, and whisper through ``make_train_step``
    (:func:`_encdec_train`).
    → the launches of the served requests and the training steps."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    totals = {name: 0 for name in ops.KERNELS}
    _encdec_vlm_parity(torch)
    for arch, prompt in (("qwen2-vl-2b", PROMPT),
                         ("whisper-medium", WHISPER_PROMPT)):
        t0 = time.perf_counter()
        cfg = get_config(arch)
        argv = ["--arch", arch, "--no-smoke", "--batch", str(B)]

        def request(prompt, gen):
            return lambda: serve.main(argv + ["--prompt-len", str(prompt),
                                              "--gen", str(gen)])

        if cfg.is_encdec:
            counts = _serve_runs(
                request(prompt, GEN), cfg, arch, prompt=prompt,
                warm=request(4, 4),
                profiled=(request(prompt, REC_PROFILED[1]), prompt,
                          REC_PROFILED[1]))
        else:
            counts = _serve_runs(request(prompt, GEN), cfg, arch)
        for k, v in counts.items():
            totals[k] += v
        log(f"[encdec_vlm] served {arch}: {cfg.n_layers} layers"
            + (f" + {cfg.n_enc_layers} encoder layers over {cfg.enc_len} "
               f"frames" if cfg.is_encdec else "")
            + f", {cfg.param_counts()[0]:,} params, {prompt}-token prompts "
            f"({time.perf_counter() - t0:.1f} s)")
    _coded_twice(torch, "qwen2-vl-2b", VLM_TRAIN_LAYERS, totals,
                 tag="[encdec_vlm]")
    _encdec_train(torch, totals)
    return totals


TRAIN_RUNS = [("off", ""), ("coded", ""), ("coded_q", "int8"),
              ("coded_q", "int4"), ("coded_q", "fp8")]


def _session(cfg, mode, comp, device, **kw):
    from repro_torch.api import CodedCluster, CodedSession, planner_for_scheme

    return CodedSession(CodedCluster.homogeneous(2, 4), cfg,
                        planner=planner_for_scheme("hgc", 1, 1), mode=mode,
                        grad_compression=comp, device=device, **kw)


def _params_off(card, cpu, init):
    """Values of the trained params where the card's run and the CPU's
    differ by more than 1e-4 of the leaf's largest change since ``init``
    plus two float32 spacings of the value: ``(count, of all)``.  Over a
    quantized hop a value whose card and CPU partials differ by an ulp
    may round to the next code (error feedback carries it back), so
    there a 1e-3 share is allowed; a wrong decode (a wrong λ, a dropped
    pod, no update) moves most values."""
    import numpy as np

    off = total = 0
    for key, want in cpu.items():
        tol = (1e-4 * np.abs(want - init[key]).max()
               + 2 * np.spacing(np.abs(want)))
        off += int((np.abs(card[key] - want) > tol).sum())
        total += want.size
    return off, total


def phase_train_parity():
    """The coded session's modes on the card against the same port on
    the CPU (small float32 config, same initial params, 4 sgd steps,
    edge 1 dropped at step 2), and against each other within the
    reference's own tolerances (tests/test_dist_train_elastic.py)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.checkpoint.params import params_to_numpy
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models import transformer as tf

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_smoke_config("llama3-8b"), dtype="float32")
    init = params_to_numpy(tf.init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu",
        dtype=torch.float32))
    kw = dict(seq_len=32, optimizer="sgd", lr=0.05, total_steps=4,
              verbose=False, params=init)
    losses = {}
    for mode, comp in TRAIN_RUNS:
        trained = {}
        for dev in ("cuda", "cpu"):
            s = _session(cfg, mode, comp, dev, **kw)
            losses[mode + comp, dev] = np.asarray(
                s.fit(4, force_drop_edge=1, force_drop_step=2)["losses"])
            trained[dev] = params_to_numpy(s.params)
        card, cpu = losses[mode + comp, "cuda"], losses[mode + comp, "cpu"]
        if not (np.isfinite(card).all()
                and (np.abs(card - cpu) <= 2e-3 * np.abs(cpu)).all()):
            raise AssertionError(f"{mode}{comp}: card losses {card} vs cpu "
                                 f"{cpu}")
        # the losses alone would miss a wrong decode that moves them less
        # than their limit: the params are held leaf by leaf as well
        off, total = _params_off(trained["cuda"], trained["cpu"], init)
        allowed = 1e-3 * total if comp else 0
        log(f"[train-parity] {mode}{comp}: loss moved "
            f"{abs(cpu[-1] - cpu[0]):.4g} over 4 steps (limit card-cpu "
            f"{2e-3 * np.abs(cpu).max():.4g}); {off} of {total} param "
            f"values off by > 1e-4 of their leaf's change (allowed "
            f"{allowed:g})")
        if off > allowed:
            raise AssertionError(f"{mode}{comp}: {off} of {total} trained "
                                 f"param values differ card vs cpu")
    off = losses["off", "cuda"]
    if not np.abs(losses["coded", "cuda"] - off).max() <= 5e-4:
        raise AssertionError(f"coded {losses['coded', 'cuda']} != off {off}")
    for codec in ("int8", "int4", "fp8"):
        got = losses["coded_q" + codec, "cuda"]
        if not np.abs(got - off).max() <= 5e-3:
            raise AssertionError(f"coded_q {codec} {got} far from off {off}")
    worst = max(np.abs(losses[k, "cuda"] - losses[k, "cpu"]).max()
                / np.abs(losses[k, "cpu"]).max()
                for k in {m + c for m, c in TRAIN_RUNS})
    log(f"[train-parity] off, coded, coded_q x int8/int4/fp8: card == cpu "
        f"within {worst:.3g} x |loss|; coded - off "
        f"{np.abs(losses['coded', 'cuda'] - off).max():.3g}; off losses "
        f"{np.round(off, 5).tolist()} ({time.perf_counter() - t0:.1f} s)")


def _hgc_recovery(torch, session):
    """HGC encode → decode of one full-width leaf: the 8 per-part
    gradients of ``groups.p0.mlp.wd`` (each part's own examples, fixed
    denominator), encoded into the workers' messages (eq. 22) and
    decoded from a sampled straggler pattern's survivors (eqs. 25/27),
    must equal their sum."""
    import numpy as np

    from repro_torch.api.cluster import sample_straggler_pattern
    from repro_torch.dist import grad_sync

    from repro_torch.models import transformer as tf

    code, cfg = session.code, session.cfg
    leaf = session.params["groups"]["p0"]["mlp"]["wd"]
    parts = []
    for k in range(code.K):
        b = session.streams[k].next_batch()
        b = {"tokens": torch.as_tensor(b["tokens"]).long().to("cuda"),
             "targets": torch.as_tensor(b["targets"]).long().to("cuda"),
             "weights": torch.as_tensor(b["weights"]).to("cuda"),
             "denom": torch.tensor(float(code.K * TRAIN_SEQ), device="cuda")}
        with torch.enable_grad():
            total, _ = tf.loss_and_metrics(session.params, cfg, b)
            (g,) = torch.autograd.grad(total, [leaf])
        parts.append(g.reshape(-1))
        del g, total
    g_parts = torch.stack(parts)
    del parts
    fast_e, fast_w, _, _ = sample_straggler_pattern(
        np.random.default_rng(5), code, session.cluster.params, code.load)
    msgs = grad_sync.encode_messages(code, g_parts)
    dec = grad_sync.decode_gradient(code, msgs, fast_e, fast_w)
    want = g_parts.sum(0)
    scale = want.abs().max().item()
    err = (dec - want).abs().max().item()
    if not err <= 1e-5 * scale:
        raise AssertionError(f"HGC decode off by {err:.3g} > 1e-5 x "
                             f"{scale:.3g}")
    return dict(F=int(g_parts.shape[1]), fast_edges=fast_e,
                fast_workers=[list(w) for w in fast_w], err=err / scale)


def phase_train():
    """The training path at llama3-8b's full width, 2 layers: coded_q
    int8 for 4 steps (edge 1 dropped at step 2), a fifth step under
    ``torch.profiler``, int4 and fp8 for 2 steps each, then the HGC
    encode/decode check.  The launch counts are set to 0 before the
    path and read after it; each step's own counts are exact.  → the
    launches, and the int8 step's peak memory and profiled device ms."""
    import dataclasses

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import _tree
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops

    cfg = dataclasses.replace(get_config("llama3-8b"),
                              n_layers=TRAIN_LAYERS)
    kernel_of = {"int8": "coded_combine_q", "int4": "coded_combine_q4",
                 "fp8": "coded_combine_f8"}
    totals = {name: 0 for name in ops.KERNELS}
    result = {}
    session = None
    for codec, n_steps in (("int8", 4), ("int4", 2), ("fp8", 2)):
        del session
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        session = _session(cfg, "coded_q", codec, "cuda", seq_len=TRAIN_SEQ,
                           part_batch=1, optimizer="adamw",
                           total_steps=n_steps + 1, grad_block=HOP_BLOCK,
                           log_every=1)
        torch.cuda.synchronize()
        n_leaves = len(_tree.leaves(session.params))
        log(f"[train] {codec}: session built in "
            f"{time.perf_counter() - t0:.1f} s: {n_leaves} param leaves, "
            f"{sum(p.numel() for p in _tree.leaves(session.params)):,} "
            f"params, K={session.code.K}, load D={session.code.load}")
        want = {kernel_of[codec]: n_leaves,
                "flash_attention": GROUPS * TRAIN_LAYERS * 2}
        step_ms = []
        for step in range(n_steps):
            ops.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            session.fit(step + 1, force_drop_edge=1, force_drop_step=2)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            counts = _launches()
            got = {k: v for k, v in counts.items() if v}
            if got != want:
                raise AssertionError(f"{codec} step {step}: launches {got}, "
                                     f"expected {want}")
            for k, v in counts.items():
                totals[k] += v
        losses = session.losses
        if not np.isfinite(losses).all():
            raise AssertionError(f"{codec}: losses {losses}")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"[train] {codec}: losses {[round(x, 5) for x in losses]}, "
            f"host ms per step {[round(x, 1) for x in step_ms]}, peak "
            f"{peak:.2f} GiB allocated; launches per step {want}")
        result[codec] = dict(losses=list(losses), step_ms=step_ms,
                             peak_gib=peak)
        if codec == "int8":
            measured = dict(
                peak=torch.cuda.max_memory_allocated(),
                device_ms=_profile_step(torch, profile, ProfilerActivity,
                                        session, n_steps, step_ms))
            ops.reset_launch_counts()  # the profiled step is not counted
    ops.reset_launch_counts()
    hgc = _hgc_recovery(torch, session)
    counts = _launches()
    if counts["coded_combine"] != 2:
        raise AssertionError(f"HGC check launches {counts}")
    totals["coded_combine"] += counts["coded_combine"]
    log(f"[train] HGC encode -> decode of groups.p0.mlp.wd (F={hgc['F']}), "
        f"survivors edges {list(hgc['fast_edges'])} workers "
        f"{hgc['fast_workers']}: max |decoded - sum| {hgc['err']:.3g} x "
        f"max|sum| (limit 1e-5); coded_combine launches 2")
    del session
    torch.cuda.empty_cache()
    return totals, measured


def _profile_step(torch, profile, ProfilerActivity, session, step,
                  step_ms):
    """One more int8 step under ``torch.profiler``: its device time by
    kernel name, over the median host time of the counted steps after
    the first (the profiler slows the host).  → its device ms."""
    import collections

    from torch.autograd import DeviceType

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        session.fit(step + 1)
        torch.cuda.synchronize()
    by_name = collections.Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            by_name[e.name] += e.time_range.elapsed_us() / 1e3
    if not by_name:
        raise AssertionError("the profiler saw no device work in the step")
    host = sorted(step_ms[1:])[len(step_ms[1:]) // 2]
    dev = sum(by_name.values())
    _, launches, missing = _device_records(prof, DeviceType)
    log(f"[profile] train step: device {dev:.3f} ms over the counted "
        f"steps' median host {host:.3f} ms: device busy "
        f"{100 * dev / host:.1f}%; {launches - missing} of {launches} "
        f"launches have their device record")
    for name, ms in by_name.most_common(12):
        log(f"[profile]   {ms:9.3f} ms  {name[:90]}")
    # the port's own kernels in the step, by their source's entry names
    for label, key in (("combine kernel", "combine_kernel"),
                       ("flash forward", "flash_fwd")):
        hits = {n: ms for n, ms in by_name.items() if key in n}
        log(f"[profile]   the port's {label}: "
            f"{sum(hits.values()):.3f} ms in {len(hits)} instantiation(s)")
    return dev


CKPT_STEPS, KILL_AT = 4, 2
GEN_B, GEN_PROMPT, GEN_NEW = 4, 64, 8
ORCH_ROUNDS, ORCH_INJECT = 8, "kill:w0.1@3,slow:e1@5x2:4.0"


def _train_kw():
    """The phase-6 training settings (phases 6-8 share them)."""
    return dict(seq_len=TRAIN_SEQ, part_batch=1, optimizer="adamw",
                grad_block=HOP_BLOCK, verbose=False)


def _train_cfg():
    from repro_torch.configs.registry import get_config

    return dataclasses.replace(get_config("llama3-8b"), n_layers=TRAIN_LAYERS)


def _counted_steps(session, first, last, want, totals, **fit):
    """Steps ``first..last-1`` one ``fit`` call each (``stop_after`` the
    step's end), each with exactly ``want`` launches; → host ms each."""
    import torch

    from repro_torch.kernels import ops

    step_ms = []
    for step in range(first, last):
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        session.fit(CKPT_STEPS, stop_after=step + 1, **fit)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        counts = _launches()
        got = {k: v for k, v in counts.items() if v}
        if got != want:
            raise AssertionError(f"step {step}: launches {got}, expected "
                                 f"{want}")
        for k, v in counts.items():
            totals[k] += v
    return step_ms


def _checkpoint_dir(need: int) -> Path:
    """A fresh directory on whichever local disk has the most free space:
    the checkout's ``build/`` or the temporary directory."""
    free = {}
    for d in (ROOT / "build", Path(tempfile.gettempdir())):
        d.mkdir(parents=True, exist_ok=True)
        free[d] = shutil.disk_usage(d).free
    best = max(free, key=free.get)
    log("[ckpt] free disk: " + ", ".join(
        f"{d} {n / 1e9:.1f} GB" for d, n in free.items()))
    if free[best] < need:
        raise AssertionError(f"the checkpoint needs {need / 1e9:.1f} GB; "
                             f"the disk with the most space, {best}, has "
                             f"{free[best] / 1e9:.1f} GB free")
    return Path(tempfile.mkdtemp(prefix="ckpt.", dir=best))


def _bits_equal(torch, got, want: "np.ndarray") -> bool:
    want = torch.from_numpy(want).to(got.device)
    return (got.dtype == want.dtype and got.shape == want.shape
            and torch.equal(got.detach().reshape(-1).view(torch.uint8),
                            want.reshape(-1).view(torch.uint8)))


def _check_restored(torch, session, step_dir: Path) -> int:
    """The resumed session's state against the checkpoint's arrays, bit
    for bit, one array at a time; its streams and detector against the
    checkpoint's JSON.  → the number of arrays compared."""
    from repro_torch import _tree
    from repro_torch.checkpoint.params import _flatten
    from repro_torch.checkpoint.store import read_npz

    live = _flatten({"params": session.params,
                     "opt_state": session.opt_state})
    live.update({"ef_residual/" + k: v for k, v in _flatten(
        _tree.unflatten_like(session.params, session.residual)).items()})
    n = 0
    for name in ("state.npz", "extra.npz"):  # CRC-checked, as np.load's
        for key, arr in read_npz(str(step_dir / name)).items():
            if not _bits_equal(torch, live.pop(key), arr):
                raise AssertionError(f"restored {key} differs from the "
                                     f"checkpoint's {name}")
            n += 1
    if live:
        raise AssertionError(f"not in the checkpoint: {sorted(live)[:4]}")
    meta = json.loads((step_dir / "meta.json").read_text())["extra"]
    if [s.state_dict() for s in session.streams] != meta["streams"]:
        raise AssertionError("restored streams differ from the checkpoint")
    if session.cluster.detector.state_dict() != meta["detector"]:
        raise AssertionError("restored detector differs from the checkpoint")
    return n


def _embedding_backward(torch):
    """The embedding's backward at one training group's shape (4 × 512
    token ids into the bf16 128256 × 4096 table): ``F.embedding``, which
    the port uses, beside the indexing backward.  Distinct results over
    5 runs of each on ids where every other one repeats (what the
    accumulation order could change), and ms per call (forward +
    backward, CUDA events) on uniform ids, as the token streams draw
    them."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(3)
    uniform = torch.randint(0, 128256, (4, TRAIN_SEQ), generator=gen,
                            device="cuda")
    repeated = uniform.clone()
    repeated[:, ::2] = repeated[:, :1]
    table = torch.randn(128256, 4096, generator=gen, device="cuda").to(
        torch.bfloat16).requires_grad_(True)
    g = torch.randn(4, TRAIN_SEQ, 4096, generator=gen, device="cuda").to(
        torch.bfloat16)
    out = {}
    for name, fwd in (("F.embedding", F.embedding),
                      ("table[tokens]", lambda t, w: w[t])):
        def call(tok):
            return torch.autograd.grad(fwd(tok, table), [table], g)[0]

        fps = {int(call(repeated).view(torch.int16).long().sum())
               for _ in range(5)}
        out[name] = (len(fps), timed_ms(lambda: call(uniform), 20))
    del table, g
    torch.cuda.empty_cache()
    return out


def phase_checkpoint():
    """Train → checkpoint → kill → resume → serve (the phase-6 config);
    → the launches of its counted steps and of ``session.generate``."""
    import numpy as np
    import torch

    from repro_torch import _tree
    from repro_torch.api import serving
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tf

    cfg, kw = _train_cfg(), _train_kw()
    kw["total_steps"] = CKPT_STEPS
    fit = dict(force_drop_edge=1, force_drop_step=2)
    totals = {name: 0 for name in ops.KERNELS}
    t0 = time.perf_counter()
    whole = _session(cfg, "coded_q", "int8", "cuda", **kw)
    n_leaves = len(_tree.leaves(whole.params))
    n_params = sum(p.numel() for p in _tree.leaves(whole.params))
    want = {"coded_combine_q": n_leaves,
            "flash_attention": GROUPS * TRAIN_LAYERS * 2}
    whole_ms = _counted_steps(whole, 0, CKPT_STEPS, want, totals, **fit)
    losses = list(whole.losses)
    del whole
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[ckpt] uninterrupted: losses {losses}, host ms per step "
        f"{[round(x, 1) for x in whole_ms]} ({time.perf_counter() - t0:.1f}"
        f" s)")

    n_pods = 2  # the residual's rows: params, m, v and 2 pods' residuals
    need = int(1.1 * 4 * n_params * (3 + n_pods))
    ck = _checkpoint_dir(need)
    free_before = shutil.disk_usage(ck).free
    killed = _session(cfg, "coded_q", "int8", "cuda", checkpoint_dir=str(ck),
                      checkpoint_every=KILL_AT, keep_checkpoints=1, **kw)
    saves = []
    save = killed.save_checkpoint

    def timed_save(step=None):
        torch.cuda.synchronize()
        t = time.perf_counter()
        path = save(step)
        saves.append(time.perf_counter() - t)
        return path

    killed.save_checkpoint = timed_save
    _counted_steps(killed, 0, KILL_AT, want, totals, **fit)
    if killed.losses != losses[:KILL_AT] or len(saves) != 1:
        raise AssertionError(f"killed run: losses {killed.losses}, saves "
                             f"{saves}")
    step_dir = ck / f"step_{KILL_AT:010d}"
    nbytes = sum(f.stat().st_size for f in step_dir.iterdir())
    free_saved = shutil.disk_usage(ck).free
    del killed, save
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    resumed = _session(cfg, "coded_q", "int8", "cuda", checkpoint_dir=str(ck),
                       resume=True, **kw)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    if resumed._step != KILL_AT:
        raise AssertionError(f"resumed at step {resumed._step}")
    t0 = time.perf_counter()
    n_arrays = _check_restored(torch, resumed, step_dir)
    log(f"[ckpt] checkpoint of step {KILL_AT}: {nbytes:,} bytes in "
        f"{len(list(step_dir.iterdir()))} files; save {saves[0]:.2f} s "
        f"({nbytes / saves[0] / 1e9:.2f} GB/s), restore (a fresh session "
        f"resumed) {restore_s:.2f} s ({nbytes / restore_s / 1e9:.2f} GB/s);"
        f" {n_arrays} arrays restored bit for bit, streams and detector "
        f"equal ({time.perf_counter() - t0:.1f} s to check); free disk "
        f"{free_before / 1e9:.1f} GB before, {free_saved / 1e9:.1f} GB "
        f"with the checkpoint")
    resumed_ms = _counted_steps(resumed, KILL_AT, CKPT_STEPS, want, totals,
                                **fit)
    if resumed.losses != losses[KILL_AT:]:
        raise AssertionError(f"resumed losses {resumed.losses} != the "
                             f"uninterrupted run's {losses[KILL_AT:]}")
    log(f"[ckpt] resumed steps {KILL_AT}..{CKPT_STEPS - 1}: losses "
        f"{resumed.losses} equal the uninterrupted run's bit for bit; host "
        f"ms per step {[round(x, 1) for x in resumed_ms]}; launches per "
        f"step {want}")

    gen = np.random.default_rng(1)
    prompts = gen.integers(0, cfg.vocab, (GEN_B, GEN_PROMPT), dtype=np.int64)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = resumed.generate(prompts, GEN_NEW)
    gen_ms = 1e3 * (time.perf_counter() - t0)
    counts = {k: v for k, v in _launches().items() if v}
    want_gen = {"flash_attention": TRAIN_LAYERS,
                "decode_attention": TRAIN_LAYERS * GEN_NEW}
    if counts != want_gen:
        raise AssertionError(f"generate launches {counts}, expected "
                             f"{want_gen}")
    for k, v in counts.items():
        totals[k] += v
    with torch.inference_mode():
        served = serving.generate(tf.cast_params(resumed.params, cfg), cfg,
                                  prompts, GEN_NEW, device="cuda")
    if toks.shape != (GEN_B, GEN_NEW) or not np.array_equal(toks, served):
        raise AssertionError(f"session.generate {toks.tolist()} != "
                             f"serving.generate {served.tolist()}")
    log(f"[ckpt] session.generate on the resumed session: {GEN_B} x "
        f"{GEN_PROMPT}-token prompts, {GEN_NEW} new tokens in "
        f"{gen_ms:.1f} ms; launches {counts}; tokens equal "
        f"api.serving.generate's; tokens[0] {toks[0].tolist()}")
    del resumed
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(ck)
    emb = _embedding_backward(torch)
    for name, (distinct, ms) in emb.items():
        log(f"[ckpt] embedding backward, {name}: {distinct} distinct "
            f"result(s) over 5 runs, {ms:.4f} ms per call")
    delta = emb["F.embedding"][1] - emb["table[tokens]"][1]
    log(f"[ckpt] F.embedding costs {delta:+.4f} ms a call, "
        f"{GROUPS * delta:+.4f} ms a step ({GROUPS} groups)")
    if emb["F.embedding"][0] != 1:
        raise AssertionError("F.embedding's backward is not deterministic")
    return totals


def _torch_loaded(pid: int) -> bool:
    """Whether process ``pid`` has torch's libraries mapped; numpy's core
    extension must be (the worker is alive and the maps are readable)."""
    maps = Path(f"/proc/{pid}/maps").read_text()
    if "_multiarray_umath" not in maps:
        raise AssertionError(f"worker {pid}: numpy not in its maps")
    return "libtorch" in maps or "/torch/lib/" in maps


def phase_orchestrate():
    """An orchestrated coded_q int8 episode at the phase-6 config with
    spawned worker processes; → the launches of its trained rounds."""
    import numpy as np
    import torch

    from repro_torch import _tree
    from repro_torch.api import CodedCluster, CodedSession, planner_for_scheme
    from repro_torch.kernels import ops
    from repro_torch.orchestrator import (
        InjectionSchedule,
        Orchestrator,
        OrchestratorConfig,
    )

    t0 = time.perf_counter()
    session = CodedSession(CodedCluster.hetero(2, 4), _train_cfg(),
                           planner=planner_for_scheme("hgc", 1, 1),
                           mode="coded_q", grad_compression="int8",
                           device="cuda", total_steps=ORCH_ROUNDS,
                           **_train_kw())
    want = {"coded_combine_q": len(_tree.leaves(session.params)),
            "flash_attention": GROUPS * TRAIN_LAYERS * 2}
    orch = Orchestrator(session, OrchestratorConfig(steps=ORCH_ROUNDS,
                                                    backend="process"),
                        schedule=InjectionSchedule.parse(ORCH_INJECT))
    totals = {name: 0 for name in ops.KERNELS}
    round_ms = []
    orch.pool.start()
    try:
        log(f"[orch] session and {len(orch.pool.alive)} spawned workers up "
            f"in {time.perf_counter() - t0:.1f} s")
        for _ in range(ORCH_ROUNDS):
            ops.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rec = orch.run_round(session._step)
            torch.cuda.synchronize()
            round_ms.append(1e3 * (time.perf_counter() - t0))
            counts = _launches()
            got = {k: v for k, v in counts.items() if v}
            if got != want:
                raise AssertionError(f"round {len(round_ms) - 1}: launches "
                                     f"{got}, expected {want} ({rec})")
            for k, v in counts.items():
                totals[k] += v
        live = sorted(orch.pool.alive)
        loaded = [f for f in live
                  if _torch_loaded(orch.pool._handles[f].pid)]
    finally:
        orch.pool.close()
    summary = orch.finalize(ORCH_ROUNDS)
    c = summary["counters"]
    dead = orch.registry.dead_workers()
    n_dead = summary["event_counts"].get("worker_dead", 0)
    log(f"[orch] {ORCH_ROUNDS} rounds of {ORCH_INJECT}: counters {c}; "
        f"events {summary['event_counts']}; dead workers {dead}; losses "
        f"{[round(x, 5) for x in session.losses]}; master ms per round "
        f"{[round(x, 1) for x in round_ms]}; jit cache entries "
        f"{summary['jit_cache_entries']}; launches per round {want}")
    if dead != [1] or n_dead != 1:
        raise AssertionError(f"dead workers {dead}, {n_dead} worker_dead "
                             f"events")
    if c["replans"] < 1 or c["decode_fallbacks"] != 0:
        raise AssertionError(f"counters {c}")
    if len(session.losses) != ORCH_ROUNDS \
            or not np.isfinite(session.losses).all():
        raise AssertionError(f"losses {session.losses}")
    if loaded:
        raise AssertionError(f"workers {loaded} loaded torch")
    log(f"[orch] no worker process has torch loaded ({len(live)} live "
        f"workers' maps read)")
    del orch, session
    gc.collect()
    torch.cuda.empty_cache()
    return totals


# ----------------------------------------------------------------------
# phase "tp": tensor parallelism, two ranks sharing the card over gloo
# ----------------------------------------------------------------------
TP = 2
TP_PARITY_STEPS = 8       # greedy decode steps after the 2 × 64 prefill
TP_TRAIN_STEPS = 4        # coded_q int8, edge 1 dropped at step 2
TP_PROFILED_GEN = 8       # new tokens of rank 0's profiled request
#: the tp-2 losses of steps 1-3 against the tp-1 session's, × |loss|:
#: each rank quantizes its own slice, so the degrees part after step 0
#: (measured at most 6.9e-5; the updates of steps 1 and 2 move the tp-1
#: loss by 7.8e-3 and 4.3e-3 × |loss|: PERF.md §6)
TP_LOSS_RTOL = 5e-4
#: adamw's first moment after step 0 at tp 2 against the tp-1 session's,
#: leaf by leaf, × the leaf's max |m|: m is then 0.1 × the decoded step-0
#: gradient (lr 0 at step 0: the params have not moved).  Each of the two
#: pods' int8 partials rounds within one int8 step (block max / 127) of
#: its block at either degree, 2/127, and bf16 partial sums that differ
#: at the two degrees add a little: 3/127 (read 0.0172 at tp 2, with SP
#: too; norm scales' gradients left local under SP read 0.85).  The
#: params after the 4 steps are no yardstick: adamw's first steps move a
#: weight by about ±lr whatever its gradient's size, so an element that
#: the int8 hop rounds to 0 at one degree and to one quantum at the
#: other moves by lr (PERF.md §6)
TP_LEAF_SHARE = 3 / 127
# phase (e): the configs whose tensor-parallel branches are the MoE, SSM,
# RG-LRU and encoder–decoder ones, at full width, float32, cut to the
# depths of the parity legs of phases "archs", "recurrent" and
# "encdec_vlm": arch → (layers, further changes).  maverick keeps 16 of
# its 128 experts (d, ff, top-k and the shared expert whole): at 128, one
# float32 MoE layer is 64 GB, and both ranks share one 80 GB card
TP_ARCHS = {
    "granite-moe-3b-a800m": (2, {}),
    "llama4-maverick-400b-a17b": (2, dict(n_experts=16)),
    "mamba2-370m": (2, {}),
    "recurrentgemma-2b": (5, {}),
    "whisper-medium": (2, dict(n_enc_layers=2)),
}
TP_ARCH_SEQ = 64          # (e): the prompt and the training sequence
TP_ARCH_LR = 1e-3         # (e): sgd, no warm-up, two steps
TP_MOE = "granite-moe-3b-a800m"  # (f): served and trained at tp 2
#: (b), (f): llama3-8b and granite-moe served at tp 2 through the serve
#: CLI cut to 8 of their 32 identical layers (the gloo collectives of a
#: served layer take ~0.1-0.2 s a request; the script's time limit makes
#: room for phase "pp")
TP_SERVE_LAYERS = 8
#: (f): granite-moe's trained depth at tp 2 + SP (every layer is MoE:
#: depth adds no branch; cut from 4 to make room for phase "pp")
TP_MOE_TRAIN_LAYERS = 1
TP_MOE_STEPS = 2          # (f): each of the two runs, edge 1 dropped at
#                           step 1, so adamw's moments and the EF residual
#                           carry across a step and a drop mid-run
#: (f): maverick served in bf16 at tp 2 with all 128 experts (64 a rank)
#: at the depth phase "archs" serves it: one dense and one MoE layer
TP_MAVERICK = ("llama4-maverick-400b-a17b", 2)
TP_WARM_GEN = 2           # (f): new tokens of the warm-up requests
# phase 2: the attention kernels at a rank's shapes (S, H, Kv, Dh, window)
TP_SHAPES = {
    "llama3-8b tp 2 (a rank's heads)": (PROMPT, H // 2, KV // 2, DH, 0),
    "starcoder2-3b tp 4 (replicated KV: a rank's head)": (PROMPT, 6, 1,
                                                          128, 0),
}
#: phase 2: the new per-rank shapes of the archs at tp 2, each kernel
#: beside its plain version, SDPA and its bound: label → (timer, kwargs)
TP_ARCH_SHAPES = {
    "recurrentgemma-2b tp 2 decode (H 5 over the one KV head, the "
    f"served prompt S={REC_PROMPT})": (
        "decode", dict(S=REC_PROMPT, H=5, KV=1, DH=256, window=2048)),
    f"recurrentgemma-2b tp 2 training (S={TRAIN_SEQ}, with log-sum-exp)": (
        "flash", dict(S=TRAIN_SEQ, H=5, KV=1, DH=256, window=2048,
                      with_lse=True)),
    f"whisper-medium tp 2 encoder (S=T={ENC_LEN}, non-causal)": (
        "flash", dict(S=ENC_LEN, H=8, KV=8, DH=64, causal=False)),
    f"whisper-medium tp 2 cross cache (C={ENC_LEN}, q_pos={ENC_LEN - 1})": (
        "decode", dict(C=ENC_LEN, q_pos=ENC_LEN - 1, H=8, KV=8, DH=64)),
    f"granite-moe-3b-a800m tp 2 (S={PROMPT}, H 12, Kv 4)": (
        "flash", dict(S=PROMPT, H=12, KV=4, DH=64)),
    f"granite-moe-3b-a800m tp 2 decode (C={PROMPT + GEN + 1})": (
        "decode", dict(S=PROMPT, H=12, KV=4, DH=64)),
}
#: phase 4's greedy tokens (the tp-1 request), held against phase "tp"'s
_SERVED = {}


def _tp_arch_cfg(arch):
    """A phase-(e) config: full width, float32, the leg's depth."""
    from repro_torch.configs.registry import get_config

    layers, changes = TP_ARCHS[arch]
    return dataclasses.replace(get_config(arch), n_layers=layers,
                               dtype="float32", **changes)


def _tp_parity_run(ctx, cfg=None, feed=None):
    """``cfg`` (default llama3-8b at full width cut to 2 layers) in
    float32, weights from seed 0 (at tp > 1 this rank's slices of the
    same draws): a prefill of 2 × 64 tokens (an encoder–decoder model's
    over 2 × ``enc_len`` frames from the seed), then 8 decode steps fed
    the greedy tokens, or ``feed``'s (2, 9) where it is given (a tp-1
    run's: teacher-forced) → (this run's greedy tokens (2, 9), the 9
    steps' full logits on the host)."""
    import numpy as np
    import torch

    from repro_torch.api import serving
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as tf

    if cfg is None:
        cfg = dataclasses.replace(get_config("llama3-8b"), n_layers=2,
                                  dtype="float32")
    with torch.inference_mode():
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = tf.init_params(cfg, gen, device="cuda", tp=ctx.tp,
                                rank=ctx.axis_index())
        prompt = torch.randint(0, cfg.vocab, (2, TP_ARCH_SEQ),
                               generator=gen, device="cuda")
        frames = ()
        if cfg.is_encdec:
            frames = (torch.randn((2, cfg.enc_len, cfg.d_model),
                                  generator=gen, device="cuda"),)
        max_len = TP_ARCH_SEQ + TP_PARITY_STEPS + 1
        prefill = serving.make_prefill_fn(cfg, max_len, ctx=ctx)
        decode = serving.make_decode_fn(cfg, ctx=ctx)
        logits, cache = prefill(params, prompt, *frames)
        toks, full = [], []
        for step in range(TP_PARITY_STEPS + 1):
            if logits.shape[-1] != cfg.vocab:
                full.append(ctx.all_gather(logits, -1).cpu().numpy())
            else:
                full.append(logits.cpu().numpy())
            tok = ctx.argmax(logits, cfg.vocab)[:, None].to(torch.int32)
            toks.append(tok.cpu().numpy())
            if feed is not None:
                tok = torch.as_tensor(feed[:, step:step + 1], device="cuda")
            if step < TP_PARITY_STEPS:
                logits, cache = decode(params, tok, cache)
    del params, cache, frames
    torch.cuda.empty_cache()
    return np.concatenate(toks, 1), full


def _tp_arch_train(mesh, cfg, seq_shard):
    """Two sgd steps of the dist train step (no warm-up, no clip) on
    ``mesh`` (a ``OneCardMesh(1, 1)`` at tp 1, the world's ``DistMesh``
    at tp 2), float32, weights and a 2 × 64 batch (an encoder–decoder
    model's with its frames) from seed 1 → (the two losses, the two
    gradient norms): the second loss and both norms see the backward."""
    import numpy as np
    import torch

    from repro_torch import _tree
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tf

    ctx = getattr(mesh, "ctx", None)
    tp, rank = (ctx.tp, ctx.axis_index()) if ctx is not None else (1, 0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = tf.init_params(cfg, gen, device="cuda", dtype=torch.float32,
                            tp=tp, rank=rank)
    for p in _tree.leaves(params):
        p.requires_grad_(True)
    shape = (2, TP_ARCH_SEQ)
    batch = {"tokens": torch.randint(0, cfg.vocab, shape, generator=gen,
                                     device="cuda"),
             "targets": torch.randint(0, cfg.vocab, shape, generator=gen,
                                      device="cuda"),
             "weights": torch.ones(shape, device="cuda"),
             "denom": torch.tensor(float(shape[0] * shape[1]),
                                   device="cuda")}
    if cfg.is_encdec:
        batch["enc_frames"] = torch.randn((2, cfg.enc_len, cfg.d_model),
                                          generator=gen, device="cuda")
    tcfg = TrainConfig(optimizer="sgd", lr=TP_ARCH_LR, total_steps=10,
                       warmup_steps=0, grad_clip=0.0,
                       seq_shard_activations=seq_shard)
    step = steps._make_dist_train_step(cfg, tcfg, mesh)
    state = step.optimizer.init(params)
    losses, norms = [], []
    for s in range(2):
        params, state, _, m = step(params, state, batch,
                                   np.ones((1, 1), np.float32), [], s)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    del params, state, batch, step
    gc.collect()
    torch.cuda.empty_cache()
    return losses, norms


def _collective_ms(prof, span):
    """Host ms inside the collectives' spans and their count, by the
    serve phases (a span belongs to the phase in which it started), and
    the count of all of them."""
    from torch.autograd import DeviceType

    from repro_torch.dist.sharding import SPAN

    events = prof.events()
    out = dict.fromkeys(span, 0.0)
    count = dict.fromkeys(span, 0)
    n = 0
    for e in events:
        if e.device_type != DeviceType.CPU or e.name != SPAN:
            continue
        n += 1
        for ph, (lo, hi) in span.items():
            if lo <= e.time_range.start < hi:
                out[ph] += e.time_range.elapsed_us() / 1e3
                count[ph] += 1
    return out, n, count


def _tp_serve(rank, arch, layers, warm_gen=GEN, profiled=True):
    """Rank ``rank``'s part of the served request at tp 2: ``arch`` at
    full width cut to ``layers``, bf16, phase 4's request, through the
    serve CLI (``--tp 2`` joins this world); a warm-up
    request of ``warm_gen`` new tokens, the counted one (exactly phase
    4's launches on each rank), and, if ``profiled``, on rank 0 one
    profiled request of ``TP_PROFILED_GEN`` new tokens (every rank runs
    it: it is one program)."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    argv = ["--arch", arch, "--no-smoke", "--batch", str(B),
            "--prompt-len", str(PROMPT), "--tp", str(TP), "--layers",
            str(layers)]

    def request(gen):
        return serve.main(argv + ["--gen", str(gen)])
    request(warm_gen)
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    res = request(GEN)
    counts = _nonzero(_launches())
    want = _serve_launches(cfg, PROMPT)
    if counts != want:
        raise AssertionError(f"rank {rank} {arch}: serve launches {counts}, "
                             f"expected {want}")
    toks = res["tokens"]
    if toks.shape != (B, GEN) or not torch.isfinite(
            res["last_logits"]).all():
        raise AssertionError(f"rank {rank} {arch}: bad tokens or logits")
    out = dict(tokens=np.asarray(toks), counts=counts,
               prefill_ms=res["prefill_ms"],
               decode_ms=res["decode_ms_per_token"],
               tok_per_s=res["tok_per_s"],
               peak_gib=res["max_memory_allocated"] / 2 ** 30)
    del res
    torch.cuda.empty_cache()
    if not profiled:
        return out
    if rank != 0:
        request(TP_PROFILED_GEN)
        return out
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_res = request(TP_PROFILED_GEN)
    by_phase = device_ms_by_phase(prof)
    span = {e.name: e.time_range for e in prof.events()
            if e.device_type == DeviceType.CPU
            and e.name in ("serve.prefill", "serve.request")}
    phases = {"prefill": (span["serve.prefill"].start,
                          span["serve.prefill"].end),
              "decode": (span["serve.prefill"].end,
                         span["serve.request"].end)}
    coll, n_coll, by_phase_n = _collective_ms(prof, phases)
    host = {"prefill": prof_res["prefill_ms"],
            "decode": prof_res["decode_ms_per_token"] * TP_PROFILED_GEN}
    out["profile"] = {
        ph: dict(host_ms=host[ph], collective_ms=coll[ph],
                 device_ms=sum(by_phase[ph].values()),
                 top=by_phase[ph].most_common(6))
        for ph in phases}
    out["profile_collectives"] = n_coll
    out["profile_collectives_by_phase"] = by_phase_n
    del prof, prof_res
    torch.cuda.empty_cache()
    return out


def _param_bits(params):
    """One int64 checksum of each float32 param leaf's bits (the sum of
    its words as int32): two runs that agree bit for bit agree here."""
    import torch

    from repro_torch import _tree

    return [int(p.detach().view(-1).view(torch.int32).sum(dtype=torch.int64))
            for p in _tree.leaves(params)]


def _ref_file(ref_dir: Path, name: str, key: str) -> Path:
    return ref_dir / f"{name}.{key.replace('/', '.')}.npy"


def _leaf_diffs(leaves, axes, ref_dir: Path, name: str, rank):
    """max |this rank's slice − the same slice of the tp-1 session's leaf|
    of every leaf of ``leaves`` (flat key → this rank's tensor; ``axes``
    their split axes); the tp-1 leaves are ``.npy`` files ``name.<key>``
    in ``ref_dir``, read a slice at a time."""
    import numpy as np
    import torch

    from repro_torch.checkpoint.params import shard_array

    out = {}
    for k, p in leaves.items():
        ref = np.load(_ref_file(ref_dir, name, k), mmap_mode="r")
        want = np.array(shard_array(ref, axes.get(k), TP, rank))
        out[k] = float((p.detach() - torch.from_numpy(want).to(p.device))
                       .abs().max())
    return out


def _first_moment(session):
    """adamw's first moment by the param's flat key (this rank's slices)."""
    from repro_torch.checkpoint.params import _flatten

    return {k[2:]: v for k, v in _flatten(session.opt_state).items()
            if k.startswith("m/")}


def _tp_train(rank, cfg, seq_shard=False, ref_dir=None,
              steps=TP_TRAIN_STEPS):
    """Rank ``rank``'s coded_q int8 training of ``cfg`` at the phase-6
    settings with tp 2 (``seq_shard``: sequence-parallel too), ``steps``
    steps with edge 1 dropped at step ``min(2, steps - 1)``, twice: exact
    launches a step, finite losses, the two runs bit for bit (losses and
    every param leaf's bits); with ``ref_dir`` the first run's adamw
    first moment after step 0 against the tp-1 session's
    (:func:`_leaf_diffs`)."""
    import numpy as np
    import torch

    from repro_torch import _tree
    from repro_torch.kernels import ops

    totals = {name: 0 for name in ops.KERNELS}
    runs = []
    for run in range(2):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        session = _session(cfg, "coded_q", "int8", "cuda", tp=TP,
                           seq_shard=seq_shard, total_steps=steps,
                           **_train_kw())
        want = {"coded_combine_q": len(_tree.leaves(session.params)),
                "flash_attention": GROUPS * _attn_layers(cfg) * 2,
                **moe_launches(cfg, 2 * GROUPS, GROUPS)}
        want = {k: v for k, v in want.items() if v}
        step_ms = []
        for step in range(steps):
            ops.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            session.fit(step + 1, force_drop_edge=1,
                        force_drop_step=min(2, steps - 1))
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            counts = _launches()
            if _nonzero(counts) != want:
                raise AssertionError(f"rank {rank} run {run} step {step}: "
                                     f"launches {_nonzero(counts)}, "
                                     f"expected {want}")
            for k, v in counts.items():
                totals[k] += v
            if ref_dir is not None and run == 0 and step == 0:
                m0 = _leaf_diffs(_first_moment(session), session._axes,
                                 ref_dir, "m0", rank)
        if not np.isfinite(session.losses).all():
            raise AssertionError(f"rank {rank}: losses {session.losses}")
        runs.append(dict(losses=list(session.losses), step_ms=step_ms,
                         aux=list(session.aux_losses),
                         bits=_param_bits(session.params),
                         peak_gib=torch.cuda.max_memory_allocated()
                         / 2 ** 30, want=want))
        if ref_dir is not None and run == 0:
            runs[0]["m0"] = m0
        del session
    if runs[0]["losses"] != runs[1]["losses"] \
            or runs[0]["aux"] != runs[1]["aux"] \
            or runs[0]["bits"] != runs[1]["bits"]:
        raise AssertionError(f"rank {rank}: the two tp-2 runs differ: "
                             f"losses {runs[0]['losses']} and "
                             f"{runs[1]['losses']}")
    return runs, totals


def _tp_rank(ref):
    """One rank of phase "tp": (a) the parity run, (b) serving, (c)
    training, (d) training with SP, (e) the other archs' parity and
    training, (f) granite-moe served and trained, maverick served with
    all its experts; every rank runs every part (one program), rank 0's
    parity logits come back.  ``ref`` holds the parent's tp-1 results
    that the ranks need: the step-0 first moments' directory and phase
    (e)'s tp-1 tokens."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs.registry import get_config
    from repro_torch.dist.mesh import DistMesh
    from repro_torch.dist.sharding import model_ctx

    rank = dist.get_rank()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"backend": dist.get_backend()}
    secs = out["seconds"] = {}
    t0 = time.perf_counter()
    toks, logits = _tp_parity_run(model_ctx(TP))
    out["parity"] = (toks, logits if rank == 0 else None)
    secs["a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["serve"] = _tp_serve(rank, "llama3-8b", TP_SERVE_LAYERS)
    secs["b"] = time.perf_counter() - t0
    ref_dir = Path(ref["ref_dir"])
    for leg, sp in (("c", False), ("d", True)):
        t0 = time.perf_counter()
        out[leg] = _tp_train(rank, _train_cfg(), sp, ref_dir)
        secs[leg] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["e"] = {}
    mesh = DistMesh.for_world(1, 1, TP)
    for arch in TP_ARCHS:
        cfg = _tp_arch_cfg(arch)
        toks, logits = _tp_parity_run(mesh.ctx, cfg, feed=ref["feed"][arch])
        train = {sp: _tp_arch_train(mesh, cfg, sp) for sp in (False, True)}
        out["e"][arch] = (toks, logits if rank == 0 else None, train)
    secs["e"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["f_serve"] = _tp_serve(rank, TP_MOE, TP_SERVE_LAYERS,
                               warm_gen=TP_WARM_GEN)
    cfg = dataclasses.replace(get_config(TP_MOE),
                              n_layers=TP_MOE_TRAIN_LAYERS)
    out["f_train"] = _tp_train(rank, cfg, seq_shard=True,
                               steps=TP_MOE_STEPS)
    arch, layers = TP_MAVERICK
    out["f_maverick"] = _tp_serve(rank, arch, layers, warm_gen=TP_WARM_GEN,
                                  profiled=False)
    secs["f"] = time.perf_counter() - t0
    return out


def _close_logits(got, want, what, fail):
    """Each step's logits within 2e-3 · max|logit| (phase 3's gate) →
    the worst share."""
    import numpy as np

    worst = 0.0
    for step, (a, b) in enumerate(zip(got, want)):
        scale = float(np.abs(b).max())
        err = float(np.abs(a - b).max())
        if not err <= 2e-3 * scale:
            fail(f"{what} step {step}: max |tp2 - tp1| {err:.3g} > 2e-3 * "
                 f"{scale:.3g}")
        worst = max(worst, err / scale)
    return worst


def _log_train(leg, outs, label, key=None):
    for r, o in enumerate(outs):
        for n, run in enumerate(o[key or leg][0]):
            log(f"[tp] ({leg}) {label} rank {r} run {n}: losses "
                f"{[round(x, 5) for x in run['losses']]}"
                + (f", aux {[round(x, 5) for x in run['aux']]}"
                   if run["aux"] else "")
                + f", host ms per step {[round(x, 1) for x in run['step_ms']]}"
                f", peak {run['peak_gib']:.2f} GiB allocated; launches per "
                f"step {run['want']}")


def _gate_losses(leg, losses2, losses1, fail):
    """The tp-2 losses against the tp-1 session's: step 0 within 2e-3 ·
    |loss|, later steps within ``TP_LOSS_RTOL`` · |loss|."""
    rel = [abs(a - b) / abs(b) for a, b in zip(losses2, losses1)]
    moved = [abs(b - a) / abs(b) for a, b in zip(losses1, losses1[1:])]
    log(f"[tp] ({leg}) losses tp 2 {losses2!r} vs tp 1 {losses1!r}: "
        f"|tp2 - tp1| / |loss| by step {rel!r}; the tp-1 loss moved by "
        f"{moved!r} x |loss| a step")
    if len(losses2) != len(losses1) or not rel[0] <= 2e-3:
        fail(f"({leg}) tp-2 step-0 loss {losses2[0]!r} vs tp-1 "
             f"{losses1[0]!r}")
    elif not all(r <= TP_LOSS_RTOL for r in rel[1:]):
        fail(f"({leg}) tp-2 losses {losses2!r} vs tp-1 {losses1!r}: beyond "
             f"{TP_LOSS_RTOL} x |loss|")


def _gate_leaves(leg, outs, m0_max, fail):
    """adamw's first moment after step 0 (each rank's slice) within
    ``TP_LEAF_SHARE`` of the tp-1 leaf's max |m|, leaf by leaf."""
    worst, at = 0.0, None
    for k, m in m0_max.items():
        d = max(o[leg][0][0]["m0"][k] for o in outs)
        share = d / m if m else (0.0 if d == 0 else float("inf"))
        if share > worst:
            worst, at = share, k
    log(f"[tp] ({leg}) adamw's first moment after step 0 against the tp-1 "
        f"session's: worst leaf {worst:.4g} of its max |m| ({at}), the gate "
        f"{TP_LEAF_SHARE:.4g}")
    if not worst <= TP_LEAF_SHARE:
        fail(f"({leg}) leaf {at}: the step-0 first moment at tp 2 off tp 1's "
             f"by {worst:.4g} of its max, beyond {TP_LEAF_SHARE:.4g}")


def phase_tp():
    """Tensor and sequence parallelism at tp 2: two ranks on the one card
    over gloo (NCCL refuses two ranks on one device), spawned after the
    parent frees its memory.  (a) Card against card in float32:
    llama3-8b at full width cut to 2 layers, the tp-2 ranks against a
    tp-1 run in this process: logits within 2e-3 · max|logit|, tokens
    equal.  (b) The serve CLI at ``--tp 2`` (llama3-8b cut to
    ``TP_SERVE_LAYERS``, bf16, phase 4's request): exact launches on
    each rank, rank 0's profiled request with the host time inside
    collectives split out.  (c) coded_q int8 at the phase-6 settings with tp
    2, twice: exact launches a step, finite losses, the step-0 loss
    within 2e-3 · |loss| of a tp-1 session's in this process and the
    losses of steps 1-3 within ``TP_LOSS_RTOL`` · |loss| of it (steps
    that the decoded, clipped and applied updates decide), adamw's
    first moment after step 0 leaf by leaf within ``TP_LEAF_SHARE`` of
    the tp-1 session's, the runs bit for bit.  (d) The same with
    sequence parallelism.  (e) granite-moe, maverick (16 experts),
    mamba2, recurrentgemma and
    whisper at full width in float32 (the depths of the parity legs):
    a 2 × 64 prefill and 8 decode steps fed the tp-1 run's tokens,
    logits within 2e-3 · max|logit| of it, the greedy tokens' match
    printed; two sgd steps of the dist train step with and without SP,
    losses and gradient norms within ``TP_LOSS_RTOL`` of tp 1's.  (f)
    granite-moe served at ``--tp 2`` as (b) (its tokens' share equal to
    phase "archs"' request at the same depth printed, not gated), and
    trained in coded_q int8 at tp 2 with SP (1 layer, the phase-6
    settings but
    ``TP_MOE_STEPS`` steps, edge 1 dropped at step 1), twice, bit for
    bit; maverick served in bf16 at tp 2 with all 128 experts, cut to
    ``TP_MAVERICK``'s 2 layers, exact launches on each rank.  In (b) and
    (f) the ranks serve the same tokens.  Every gate is read before the
    phase fails.  → the launches of both ranks' counted runs, and (b)'s
    ``tp.collective`` spans a serve phase in rank 0's profile."""
    import numpy as np
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.dist.launch import run_ranks
    from repro_torch.dist.mesh import OneCardMesh
    from repro_torch.dist.sharding import NULL_CTX
    from repro_torch.kernels import ops

    gc.collect()
    torch.cuda.empty_cache()
    failures = []  # every gate is read before the phase fails
    fail = failures.append
    t0 = time.perf_counter()
    toks1, logits1 = _tp_parity_run(NULL_CTX)
    log(f"[tp] (a) tp-1 reference run: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    session = _session(_train_cfg(), "coded_q", "int8", "cuda",
                       total_steps=TP_TRAIN_STEPS, **_train_kw())
    fit = dict(force_drop_edge=1, force_drop_step=2)
    session.fit(1, **fit)
    m0 = {k: v.cpu().numpy() for k, v in _first_moment(session).items()}
    ref_dir = _checkpoint_dir(2 * sum(v.nbytes for v in m0.values()))
    for k, v in m0.items():
        np.save(_ref_file(ref_dir, "m0", k), v)
    m0_max = {k: float(np.abs(v).max()) for k, v in m0.items()}
    session.fit(TP_TRAIN_STEPS, **fit)
    losses1 = list(session.losses)
    del session, m0
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[tp] (c) tp-1 losses {losses1!r}, its {len(m0_max)} step-0 first "
        f"moments in {ref_dir} ({time.perf_counter() - t0:.1f} s)")
    ref1 = {}
    for arch in TP_ARCHS:
        t0 = time.perf_counter()
        cfg = _tp_arch_cfg(arch)
        toks, logits = _tp_parity_run(NULL_CTX, cfg)
        train = _tp_arch_train(OneCardMesh(1, 1), cfg, False)
        ref1[arch] = (toks, logits, train)
        log(f"[tp] (e) {arch} tp-1 reference ({cfg.n_layers} layers"
            + (f", {cfg.n_enc_layers} encoder layers" if cfg.is_encdec
               else "")
            + f", {cfg.n_experts} experts" * cfg.is_moe
            + f"): losses {train[0]!r}, grad norms {train[1]!r} "
            f"({time.perf_counter() - t0:.1f} s)")
    log(f"[tp] spawning {TP} ranks on cuda:0 "
        f"({torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB still "
        f"allocated here)")
    t0 = time.perf_counter()
    try:
        outs = run_ranks(_tp_rank, TP, args=(dict(
            ref_dir=str(ref_dir),
            feed={a: r[0] for a, r in ref1.items()}),), device="cuda",
            backend="gloo", timeout=900)
    finally:
        shutil.rmtree(ref_dir, ignore_errors=True)
    log(f"[tp] ranks done in {time.perf_counter() - t0:.1f} s (backend "
        f"{outs[0]['backend']}; seconds by leg on rank 0 "
        + ", ".join(f"({k}) {v:.1f}" for k, v in outs[0]["seconds"].items())
        + ")")

    # (a) parity, card against card
    toks2, logits2 = outs[0]["parity"]
    for o in outs[1:]:
        if not np.array_equal(o["parity"][0], toks2):
            fail("(a) the ranks decoded different tokens")
    if not np.array_equal(toks1, toks2):
        fail(f"(a) tp-2 tokens {toks2.tolist()} != tp-1 {toks1.tolist()}")
    worst = _close_logits(logits2, logits1, "(a) tp parity", fail)
    log(f"[tp] (a) llama3-8b full width, 2 layers, f32: tp 2 == tp 1 on "
        f"the card over the 2 x 64 prefill + {TP_PARITY_STEPS} decode "
        f"steps, max err {worst:.3g} x max|logit|, tokens equal")

    # (b) and (f) serving
    mav, mav_layers = TP_MAVERICK
    for leg, key, arch, label in (
            ("b", "serve", f"llama3-8b ({TP_SERVE_LAYERS} layers)",
             f"llama3-8b ({TP_SERVE_LAYERS} layers)"),
            ("f", "f_serve", f"{TP_MOE} ({TP_SERVE_LAYERS} layers)",
             f"{TP_MOE} ({TP_SERVE_LAYERS} layers)"),
            ("f", "f_maverick", f"{mav} ({mav_layers} layers, "
             f"{get_config(mav).n_experts} experts)",
             f"{mav} ({mav_layers} layers)")):
        want_toks = _SERVED.get(label)
        if any(not np.array_equal(o[key]["tokens"], outs[0][key]["tokens"])
               for o in outs):
            fail(f"({leg}) {arch}: the ranks served different tokens")
        for r, o in enumerate(outs):
            s = o[key]
            same = (float((s["tokens"] == want_toks).mean())
                    if want_toks is not None else float("nan"))
            log(f"[tp] ({leg}) {arch} rank {r}: launches {s['counts']}; "
                f"prefill {s['prefill_ms']:.2f} ms, decode "
                f"{s['decode_ms']:.3f} ms/token, {s['tok_per_s']:.1f} tok/s,"
                f" max memory allocated {s['peak_gib']:.2f} GiB; tokens "
                f"equal to the tp-1 request's: {100 * same:.1f}% (bf16: "
                f"not gated)")
        if "profile" not in outs[0][key]:
            continue
        prof = outs[0][key]["profile"]
        if key == "serve":
            spans = outs[0][key]["profile_collectives_by_phase"]
        log(f"[profile] tp {arch} rank 0, a {B} x {PROMPT} + "
            f"{TP_PROFILED_GEN}-token request "
            f"({outs[0][key]['profile_collectives']} collectives)")
        for ph, p in prof.items():
            per = 1 if ph == "prefill" else TP_PROFILED_GEN
            unit = "ms" if ph == "prefill" else "ms/token"
            log(f"[profile] tp {arch} {ph}: host {p['host_ms'] / per:.3f} "
                f"{unit}, of which inside collectives "
                f"{p['collective_ms'] / per:.3f} "
                f"({100 * p['collective_ms'] / p['host_ms']:.1f}%); device "
                f"{p['device_ms'] / per:.3f} {unit}")
            for name, ms in p["top"]:
                log(f"[profile]   {ms / per:9.3f} {unit}  {name[:90]}")

    # (c) and (d) training, without and with SP, against the tp-1 session
    for leg, label in (("c", "llama3-8b"), ("d", "llama3-8b SP")):
        _log_train(leg, outs, label)
        losses2 = outs[0][leg][0][0]["losses"]
        if any(o[leg][0][0]["losses"] != losses2 for o in outs):
            fail(f"({leg}) the ranks' losses differ")
        _gate_losses(leg, losses2, losses1, fail)
        _gate_leaves(leg, outs, m0_max, fail)
        log(f"[tp] ({leg}) the two tp-2 runs equal bit for bit on every "
            f"rank")
    peak = [max(run["peak_gib"] for run in o[leg][0]) for leg in "cd"
            for o in outs]
    log(f"[tp] (d) peak GiB a rank: SP {max(peak[2:]):.2f} against "
        f"{max(peak[:2]):.2f} without")

    # (e) the other archs, card against card
    for arch, (t1, l1, (loss1, norm1)) in ref1.items():
        t2, l2, train = outs[0]["e"][arch]
        for o in outs[1:]:
            if not np.array_equal(o["e"][arch][0], t2):
                fail(f"(e) {arch}: the ranks' tokens differ")
        worst = _close_logits(l2, l1, f"(e) {arch}", fail)
        for sp, (loss2, norm2) in train.items():
            rel = [abs(a - b) / abs(b) for a, b in
                   zip(loss2 + norm2, loss1 + norm1)]
            if not (np.isfinite(loss2 + norm2).all()
                    and max(rel) <= TP_LOSS_RTOL):
                fail(f"(e) {arch} sp={sp}: losses {loss2} and grad norms "
                     f"{norm2} vs tp 1's {loss1} and {norm1}")
            log(f"[tp] (e) {arch} training, tp 2{' + SP' * sp}: losses "
                f"{loss2!r}, grad norms {norm2!r}; worst |tp2 - tp1| "
                f"{max(rel):.3g} of tp 1's")
        log(f"[tp] (e) {arch} full width, f32: tp 2 == tp 1 over the "
            f"prefill + {TP_PARITY_STEPS} decode steps fed tp 1's tokens, "
            f"max err {worst:.3g} x max|logit|; greedy tokens equal "
            f"{100 * float((t2 == t1).mean()):.1f}%")

    # (f) granite-moe's training
    _log_train("f", outs, f"{TP_MOE} ({TP_MOE_TRAIN_LAYERS} layers) SP",
               "f_train")
    log(f"[tp] (f) {TP_MOE} coded_q int8 at tp 2 with SP: the two runs "
        f"equal bit for bit on every rank (losses, aux losses, every leaf)")
    totals = {name: 0 for name in ops.KERNELS}
    for o in outs:
        for counts in (o["serve"]["counts"], o["f_serve"]["counts"],
                       o["f_maverick"]["counts"],
                       o["c"][1], o["d"][1], o["f_train"][1]):
            for k, v in counts.items():
                totals[k] += v
    log(f"[tp] launches of the counted runs, both ranks: "
        f"{_nonzero(totals)}")
    if failures:
        raise AssertionError("phase tp: " + "; ".join(failures))
    return totals, spans


# ----------------------------------------------------------------------
# phase "pp": pipeline parallelism, ranks sharing the card over gloo
# ----------------------------------------------------------------------
PP = 2
PP_VLM = "qwen2-vl-2b"    # (b), (c): trained at PP_VLM_LAYERS
#: (b), (c): 14 of qwen2-vl's 28 layers (at 28 the script read 1148.7 s on
#: an H100, of its 1200 s limit, once phase "shrink" ran FSDP; (c)'s
#: TP/SP collectives and (b)'s steps shrink with the depth: PERF.md §4)
PP_VLM_LAYERS = 14
PP_MICRO = 2              # (b), (c): 4 rows a group, 2 a microbatch
PP_STEPS = 4              # (b): edge 1 dropped at step 2, twice
#: (c): one step, once (with M 2 and SP, ~2700 gloo collectives a step
#: take ~55 s on four ranks of one card: a second would bring the script
#: near its time limit); (b)'s 4 steps carry adamw's moments and the EF
#: residual across a drop at pp 2, and at pp 2 x tp 2 + SP the CPU test
#: ``tests/test_torch_pp_tp.py`` carries momentum and the EF
#: residuals across 4 steps and a drop
PP_TP_STEPS = 1
PP_REF_WAIT = 300         # the ranks' wait for the pp-1 references
PP_ARCH_SEQ = 64          # (a): the quarter's sequence (qwen2-vl: 128)
PP_ARCH_LR = 1e-3         # (a): sgd, no warm-up, two steps
#: (a): arch → (layers, microbatches, further changes); the MoE config
#: runs one microbatch (its capacity and aux depend on the token count)
PP_ARCHS = {
    "llama3-8b": (2, 2, {}),
    "granite-moe-3b-a800m": (2, 1, {}),
    "qwen2-vl-2b": (2, 2, {}),
    "mamba2-370m": (2, 2, {}),
    "recurrentgemma-2b": (8, 2, {}),
    "whisper-medium": (2, 2, dict(n_enc_layers=2)),
}
#: (a): the configs the ranks run once the parent has freed its memory
#: (their f32 tables, 2 x 2.1 GB and 2.6 GB a stage, would not fit beside
#: the parent's pp-1 session); the others run beside it
PP_ARCHS_LATE = ("llama3-8b", "recurrentgemma-2b")
#: phase 2: the pipeline's new kernel shapes
PP_FLASH = dict(S=TRAIN_SEQ, batch=PP_MICRO, with_lse=True, **QWEN_SHAPE)
QWEN_TABLE_F = 151936 * 1536      # qwen2-vl's tied table, the hop's largest


def _pp_arch_cfg(arch):
    """A phase-"pp" (a) config: full width, float32, the leg's depth."""
    from repro_torch.configs.registry import get_config

    layers, _, changes = PP_ARCHS[arch]
    return dataclasses.replace(get_config(arch), n_layers=layers,
                               dtype="float32", **changes)


def _pp_quarter(torch, cfg):
    """(a)'s quarter batch, 2 rows from seed 2 on the card: qwen2-vl's at
    the vision layout (an 8 × 8 grid of visual embeddings, then 64 text
    positions), whisper's with its frames."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    S = 2 * VLM_GRID * VLM_GRID if cfg.mrope_sections else PP_ARCH_SEQ
    shape = (2, S)
    batch = {"tokens": torch.randint(0, cfg.vocab, shape, generator=gen,
                                     device="cuda"),
             "targets": torch.randint(0, cfg.vocab, shape, generator=gen,
                                      device="cuda"),
             "weights": torch.ones(shape, device="cuda"),
             "denom": torch.tensor(float(shape[0] * shape[1]),
                                   device="cuda")}
    if cfg.is_encdec:
        batch["enc_frames"] = torch.randn((2, cfg.enc_len, cfg.d_model),
                                          generator=gen, device="cuda")
    if cfg.mrope_sections:
        n_vis = VLM_GRID * VLM_GRID
        batch["visual_embeds"] = torch.randn((2, n_vis, cfg.d_model),
                                             generator=gen, device="cuda")
        batch["positions"] = vision_positions(
            torch, 2, VLM_GRID, S - n_vis).contiguous().cuda()
    return batch


def _pp_arch_train(arch, mesh=None):
    """(a): two sgd steps (lr ``PP_ARCH_LR``, no warm-up, no clip) of
    ``arch``'s leg config, weights from seed 1 → (the two losses, the two
    gradient norms).  Without ``mesh`` the single-device step on the
    quarter; with the world's ``DistMesh`` the pipelined dist step on the
    quarter tiled over its groups, λ = 1 / groups (the CPU tests'
    construction)."""
    import numpy as np
    import torch

    from repro_torch import _tree
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tf

    cfg = _pp_arch_cfg(arch)
    gen = torch.Generator(device="cuda").manual_seed(1)
    pp, stage = (mesh.pp, mesh.stage) if mesh is not None else (1, 0)
    params = tf.init_params(cfg, gen, device="cuda", dtype=torch.float32,
                            pp=pp, stage=stage)
    for p in _tree.leaves(params):
        p.requires_grad_(True)
    batch = _pp_quarter(torch, cfg)
    tcfg = TrainConfig(optimizer="sgd", lr=PP_ARCH_LR, total_steps=10,
                       warmup_steps=0, grad_clip=0.0, pp_stages=pp,
                       microbatches=PP_ARCHS[arch][1] if pp > 1 else 0)
    if mesh is None:
        step = steps.make_train_step(cfg, tcfg)
    else:
        n = mesh.pods * mesh.data
        batch = {k: v if v.ndim == 0 else
                 (v.repeat(1, n, 1) if k == "positions"
                  else v.repeat(n, *([1] * (v.ndim - 1))))
                 for k, v in batch.items()}
        lam = np.full((mesh.pods, mesh.data), 1.0 / n, np.float32)
        dist_step = steps._make_dist_train_step(cfg, tcfg, mesh)

        def step(params, state, batch, s):
            params, state, _, m = dist_step(params, state, batch, lam, [], s)
            return params, state, m

        step.optimizer = dist_step.optimizer
    state = step.optimizer.init(params)
    losses, norms = [], []
    for s in range(2):
        params, state, m = step(params, state, batch, s)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    del params, state, batch, step
    gc.collect()
    torch.cuda.empty_cache()
    return losses, norms


@contextlib.contextmanager
def _microbatched(M):
    """While open, the dist step's gradient of a (pod, data) group is the
    sum of its ``M`` row blocks' (``launch.steps._grads`` wrapped): the
    pp-1 reference of (b) and (c) then rounds its bf16 weight gradients
    per microbatch, as the pipeline does, so the comparison isolates what
    the stages change (one session at pp 1 refuses microbatches, as the
    reference's does).  The blocks' sum is the pipeline's (two terms: the
    order of its accumulation does not matter); a dense config's."""
    from repro_torch.launch import steps

    plain = steps._grads

    def grads(params, cfg, batch, *args, **kw):
        if cfg.is_moe:
            raise ValueError("the blocks' sum of an MoE objective differs")
        B = batch["tokens"].shape[0]
        mb = B // M
        total = loss = None
        for i in range(M):
            part = steps._batch_rows(batch, B, slice(i * mb, (i + 1) * mb))
            g, m = plain(params, cfg, part, *args, **kw)
            total = g if total is None else [a + b for a, b in zip(total, g)]
            loss = m["loss"] if loss is None else loss + m["loss"]
        return total, {"loss": loss}

    steps._grads = grads
    try:
        yield
    finally:
        steps._grads = plain


def _pp_leaf_diffs(session, ref_dir: Path):
    """Of every leaf: (max |d|, Σ d², Σ ref²) where d is this rank's
    slice of the step-0 first moment less the same slice of the pp-1
    session's (its "model" slice, then its stage's block); the pp-1
    leaves are ``.npy`` files in ``ref_dir``, read a slice at a time."""
    import numpy as np
    import torch

    from repro_torch.checkpoint.params import shard_array

    out = {}
    mesh = session._mesh
    for k, m in _first_moment(session).items():
        ref = np.load(_ref_file(ref_dir, "m0", k), mmap_mode="r")
        part = shard_array(ref, session._axes.get(k), mesh.tp,
                           mesh.model_rank)
        part = np.array(shard_array(part, session._st_axes.get(k), mesh.pp,
                                    mesh.stage))
        ref = torch.from_numpy(part).to(m.device)
        d = m.detach() - ref
        out[k] = (float(d.abs().max()), float(torch.sum(d * d)),
                  float(torch.sum(ref * ref)))
    return out


def _union_ms(records):
    """The union of device intervals (ns) in ms."""
    total, end = 0, None
    for _, s, e in sorted(records, key=lambda r: r[1]):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e6


def _pp_profile(session, step):
    """Step ``step`` under ``torch.profiler`` (every rank runs it: one
    program) → host ms of the step, host ms inside the ``pp.collective``
    and ``tp.collective`` spans, the device's busy ms (the union of its
    intervals) and launches with their device record."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.dist.sharding import PP_SPAN, SPAN

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        session.fit(step + 1, force_drop_edge=1, force_drop_step=2)
        torch.cuda.synchronize()
    host = 1e3 * (time.perf_counter() - t0)
    spans = {PP_SPAN: [0.0, 0], SPAN: [0.0, 0]}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name in spans:
            spans[e.name][0] += e.time_range.elapsed_us() / 1e3
            spans[e.name][1] += 1
    records, launches, missing = _device_records(prof, DeviceType)
    del prof
    return dict(host_ms=host, pp_ms=spans[PP_SPAN][0],
                pp_n=spans[PP_SPAN][1], tp_ms=spans[SPAN][0],
                tp_n=spans[SPAN][1], busy_ms=_union_ms(records),
                launches=launches, missing=missing)


def _pp_train(rank, ref_dir, tp=1, seq_shard=False, steps=PP_STEPS,
              runs=2, profiled=True):
    """Rank ``rank``'s coded_q int8 training of qwen2-vl-2b
    (``PP_VLM_LAYERS``) at the phase-6 settings with pp 2 (``tp``,
    ``seq_shard``: composed with TP and SP), ``PP_MICRO`` microbatches, ``steps`` steps with edge 1
    dropped at step 2 (when there is one), ``runs`` times: exact launches
    a step (flash 8 groups × the microbatches × the stage's attention
    layers × 2 for the remat; the int8 combine once per leaf the rank
    holds), finite losses, the runs bit for bit; the first run's adamw
    first moment after step 0 against the pp-1 session's
    (:func:`_pp_leaf_diffs`); with ``profiled`` the last run's last step
    under the profiler (:func:`_pp_profile`)."""
    import numpy as np
    import torch

    from repro_torch import _tree
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops

    cfg = dataclasses.replace(get_config(PP_VLM), n_layers=PP_VLM_LAYERS)
    totals = {name: 0 for name in ops.KERNELS}
    out = []
    drop = 2
    for run in range(runs):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        session = _session(cfg, "coded_q", "int8", "cuda", tp=tp,
                           seq_shard=seq_shard, pp=PP,
                           microbatches=PP_MICRO, total_steps=steps,
                           **_train_kw())
        want = {"coded_combine_q": len(_tree.leaves(session.params)),
                "flash_attention": GROUPS * PP_MICRO
                * (_attn_layers(cfg) // PP) * 2}
        step_ms, prof = [], None
        for step in range(steps):
            ops.reset_launch_counts()
            if profiled and run == runs - 1 and step == steps - 1:
                prof = _pp_profile(session, step)
            else:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                session.fit(step + 1, force_drop_edge=1,
                            force_drop_step=drop)
                torch.cuda.synchronize()
                step_ms.append(1e3 * (time.perf_counter() - t0))
            counts = _launches()
            if _nonzero(counts) != want:
                raise AssertionError(f"rank {rank} run {run} step {step}: "
                                     f"launches {_nonzero(counts)}, "
                                     f"expected {want}")
            for k, v in counts.items():
                totals[k] += v
            if run == 0 and step == 0:
                m0 = _pp_leaf_diffs(session, ref_dir)
        if not np.isfinite(session.losses).all():
            raise AssertionError(f"rank {rank}: losses {session.losses}")
        out.append(dict(losses=list(session.losses), step_ms=step_ms,
                        bits=_param_bits(session.params), prof=prof,
                        peak_gib=torch.cuda.max_memory_allocated()
                        / 2 ** 30, want=want, m0=m0 if run == 0 else None,
                        params=sum(p.numel() for p in
                                   _tree.leaves(session.params))))
        del session
    for o in out[1:]:
        if o["losses"] != out[0]["losses"] or o["bits"] != out[0]["bits"]:
            raise AssertionError(
                f"rank {rank}: the pp-2 runs differ: losses "
                f"{out[0]['losses']} and {o['losses']}")
    return out, totals


def _rank_threads(torch, world):
    """The host's cores shared among the ranks of one card (gloo reduces
    on the host: oversubscribed cores slow every collective)."""
    import os

    torch.set_num_threads(max(1, (os.cpu_count() or world) // world))


def _pp_wait(ref_dir: Path):
    """Block until the parent has written the pp-1 references and freed
    its memory (``READY`` in ``ref_dir``) → seconds waited."""
    t0 = time.perf_counter()
    while not (ref_dir / "READY").exists():
        if (ref_dir / "FAILED").exists():
            raise RuntimeError("the parent's pp-1 reference failed")
        if time.perf_counter() - t0 > PP_REF_WAIT:
            raise TimeoutError(f"no pp-1 reference in {ref_dir} after "
                               f"{PP_REF_WAIT} s")
        time.sleep(0.2)
    return time.perf_counter() - t0


def _pp_rank(ref):
    """One rank of phase "pp" at pp 2 (two ranks): (a) the six configs'
    pipelined dist steps (``PP_ARCHS_LATE`` once the parent's pp-1
    references are in ``ref_dir``), then (b) qwen2-vl-2b trained whole,
    twice."""
    import torch
    import torch.distributed as dist

    from repro_torch.dist.mesh import DistMesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _rank_threads(torch, dist.get_world_size())
    out = {"backend": dist.get_backend()}
    secs = out["seconds"] = {}
    ref_dir = Path(ref["ref_dir"])
    t0 = time.perf_counter()
    mesh = DistMesh.for_world(1, 2, 1, pp=PP)
    out["a"] = {arch: _pp_arch_train(arch, mesh) for arch in PP_ARCHS
                if arch not in PP_ARCHS_LATE}
    secs["a, early"] = time.perf_counter() - t0
    secs["wait"] = _pp_wait(ref_dir)
    t0 = time.perf_counter()
    out["a"].update({arch: _pp_arch_train(arch, mesh)
                     for arch in PP_ARCHS_LATE})
    secs["a, late"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["b"] = _pp_train(dist.get_rank(), ref_dir)
    secs["b"] = time.perf_counter() - t0
    return out


def _pp_tp_rank(ref):
    """One rank of phase "pp" (c): qwen2-vl-2b (``PP_VLM_LAYERS``) at pp
    2 × tp 2 with SP (four ranks), once."""
    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _rank_threads(torch, dist.get_world_size())
    t0 = time.perf_counter()
    out = {"c": _pp_train(dist.get_rank(), Path(ref["ref_dir"]), tp=TP,
                          seq_shard=True, steps=PP_TP_STEPS, runs=1,
                          profiled=False)}
    out["seconds"] = time.perf_counter() - t0
    return out


#: (c): the relative L2 error of a leaf's step-0 first moment at pp 2 ×
#: tp 2 + SP against the pp-1 session's.  Under TP the bf16 activations
#: round otherwise (each rank's partial of a row-parallel matmul is
#: rounded to bf16 and gloo sums them in bf16), which spreads ~1% of
#: noise over every gradient element at 4 layers and 4.7% at
#: qwen2-vl's 28 (the same step in float32: 3e-4; at pp 2 without TP in
#: bf16: 1.6e-6, the tied table one int8 quantum), so single elements
#: pass ``TP_LEAF_SHARE`` (read 0.0594).  A copy whose replicated
#: leaves' gradients skip the stage sum reads 0.71 on the table and the
#: final norm (PERF.md §6)
PP_TP_LEAF_L2 = 0.1


def _pp_gate_leaves(leg, outs, m0_max, fail):
    """(b): adamw's step-0 first moment, each rank's slice, within
    ``TP_LEAF_SHARE`` of the pp-1 leaf's max |m|, leaf by leaf; (c):
    each leaf's relative L2 error (every rank's slices: a leaf's slices
    are replicated uniformly, so the ratio is the whole leaf's) within
    ``PP_TP_LEAF_L2``, the worst element reported."""
    share, l2 = {}, {}
    for k, m in m0_max.items():
        parts = [o[leg][0][0]["m0"][k] for o in outs]
        d = max(p[0] for p in parts)
        share[k] = d / m if m else (0.0 if d == 0 else float("inf"))
        ref = sum(p[2] for p in parts)
        l2[k] = (sum(p[1] for p in parts) / ref) ** 0.5 if ref else 0.0
    worst = max(share, key=share.get)
    worst_l2 = max(l2, key=l2.get)
    log(f"[pp] ({leg}) adamw's first moment after step 0 against the pp-1 "
        f"session's: worst element {share[worst]:.4g} of its leaf's max |m| "
        f"({worst}); worst relative L2 {l2[worst_l2]:.4g} ({worst_l2})")
    if leg == "b" and not share[worst] <= TP_LEAF_SHARE:
        fail(f"(b) leaf {worst}: the step-0 first moment at pp 2 off pp 1's "
             f"by {share[worst]:.4g} of its max, beyond "
             f"{TP_LEAF_SHARE:.4g}")
    if leg == "c" and not l2[worst_l2] <= PP_TP_LEAF_L2:
        fail(f"(c) leaf {worst_l2}: the step-0 first moment's relative L2 "
             f"error {l2[worst_l2]:.4g}, beyond {PP_TP_LEAF_L2}")


def _pp_log_train(leg, outs, label):
    for r, o in enumerate(outs):
        for n, run in enumerate(o[leg][0]):
            log(f"[pp] ({leg}) {label} rank {r} run {n}: losses "
                f"{[round(x, 5) for x in run['losses']]}, host ms per "
                f"counted step {[round(x, 1) for x in run['step_ms']]}, "
                f"peak {run['peak_gib']:.2f} GiB allocated, "
                f"{run['params']:,} params held; launches per step "
                f"{run['want']}")


def phase_pp():
    """Pipeline parallelism at pp 2: the ranks share the one card over
    gloo (NCCL refuses two ranks on one device).  This process frees its
    memory and spawns two ranks, which run (a)'s smaller configs while it
    runs the pp-1 references, and the rest of (a) and (b) once it has
    written them and freed its memory again; then four ranks run (c).  (a) Card against card in float32: six
    configs at full width, cut in depth (``PP_ARCHS``), two sgd steps of
    the pipelined dist step on two ranks against the single-device step
    in this process (the CPU tests' construction: the quarter tiled over
    2 groups, λ = 1/2): losses and gradient norms within
    ``TP_LOSS_RTOL``.  (b) qwen2-vl-2b (``PP_VLM_LAYERS``) in coded_q
    int8 at the phase-6 settings with pp 2 and 2 microbatches, 4 steps
    with edge 1
    dropped at step 2, twice: exact launches a step on each rank, finite
    losses, the step-0 loss within 2e-3 · |loss| of a pp-1 session's in
    this process (its gradient summed over the same row blocks as the
    microbatches: :func:`_microbatched`) and steps 1-3 within
    ``TP_LOSS_RTOL`` · |loss|, adamw's
    step-0 first moment leaf by leaf and stage block by stage block
    within ``TP_LEAF_SHARE`` of the pp-1 session's, the runs bit for
    bit; rank 0's last step profiled (host ms inside the
    ``pp.collective`` spans, the device's busy share).  (c) The same
    model at pp 2 × tp 2 with SP on four ranks, ``PP_TP_STEPS`` step,
    once: exact launches, the step-0 loss against the same pp-1
    session's, each leaf's step-0 first moment within ``PP_TP_LEAF_L2``
    (relative L2), the worst element reported.  Every
    gate is read before the phase fails.  → the launches of the ranks'
    counted runs."""
    import numpy as np
    import torch

    from repro_torch import _tree
    from repro_torch.configs.registry import get_config
    from repro_torch.dist.launch import run_ranks
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tf

    gc.collect()
    torch.cuda.empty_cache()
    failures = []
    fail = failures.append
    torch.cuda.reset_peak_memory_stats()
    vlm = dataclasses.replace(get_config(PP_VLM), n_layers=PP_VLM_LAYERS)
    ref_dir = _checkpoint_dir(2 * 4 * sum(
        p.numel() for p in _tree.leaves(tf.init_params(vlm, device="meta"))))
    spawned = {}

    def two_ranks():
        try:
            spawned["outs"] = run_ranks(
                _pp_rank, PP, args=(dict(ref_dir=str(ref_dir)),),
                device="cuda", backend="gloo", timeout=900)
        except BaseException as e:  # raised again below
            spawned["error"] = e

    # the two ranks start (a) while this process runs the pp-1
    # references (~47 GiB here); they run ``PP_ARCHS_LATE`` and (b) once
    # READY is written, after this process has freed its memory
    thread = threading.Thread(target=two_ranks, daemon=True)
    try:
        log(f"[pp] spawning {PP} ranks on cuda:0 "
            f"({torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB still "
            f"allocated here); the pp-1 references run meanwhile")
        t_ranks = time.perf_counter()
        thread.start()
        ref1 = {}
        for arch in PP_ARCHS:
            t0 = time.perf_counter()
            ref1[arch] = _pp_arch_train(arch)
            log(f"[pp] (a) {arch} pp-1 reference ({PP_ARCHS[arch][0]} "
                f"layers): losses {ref1[arch][0]!r}, grad norms "
                f"{ref1[arch][1]!r} ({time.perf_counter() - t0:.1f} s)")
        t0 = time.perf_counter()
        fit = dict(force_drop_edge=1, force_drop_step=2)
        with _microbatched(PP_MICRO):
            session = _session(vlm, "coded_q", "int8", "cuda",
                               total_steps=PP_STEPS, **_train_kw())
            session.fit(1, **fit)
            m0 = {k: v.cpu().numpy()
                  for k, v in _first_moment(session).items()}
            session.fit(PP_STEPS, **fit)
        for k, v in m0.items():
            np.save(_ref_file(ref_dir, "m0", k), v)
        m0_max = {k: float(np.abs(v).max()) for k, v in m0.items()}
        losses1 = list(session.losses)
        peak = torch.cuda.max_memory_reserved() / 2 ** 30
        del session, m0
        gc.collect()
        torch.cuda.empty_cache()
        (ref_dir / "READY").touch()
        log(f"[pp] (b), (c) {PP_VLM} pp-1 session (its step's gradient "
            f"summed over {PP_MICRO} row blocks, as the pipeline's "
            f"microbatches): losses {losses1!r} (edge 1 dropped at step "
            f"2); the {len(m0_max)} step-0 first moments in {ref_dir}; "
            f"peak {peak:.2f} GiB reserved ({time.perf_counter() - t0:.1f} "
            f"s)")
        thread.join()
        if "error" in spawned:
            raise spawned["error"]
        outs = spawned["outs"]
        log(f"[pp] ranks done in {time.perf_counter() - t_ranks:.1f} s "
            f"(backend {outs[0]['backend']}; seconds by leg on rank 0 "
            + ", ".join(f"({k}) {v:.1f}"
                        for k, v in outs[0]["seconds"].items()) + ")")
        t0 = time.perf_counter()
        outs_c = run_ranks(_pp_tp_rank, PP * TP,
                           args=(dict(ref_dir=str(ref_dir)),),
                           device="cuda", backend="gloo", timeout=900)
        log(f"[pp] (c) {PP * TP} ranks done in "
            f"{time.perf_counter() - t0:.1f} s (rank 0's leg "
            f"{outs_c[0]['seconds']:.1f} s)")
    except BaseException:
        (ref_dir / "FAILED").touch()
        if thread.is_alive():
            thread.join()
        raise
    finally:
        shutil.rmtree(ref_dir, ignore_errors=True)

    # (a) the six configs, card against card
    for arch, (loss1, norm1) in ref1.items():
        for r, o in enumerate(outs):
            loss2, norm2 = o["a"][arch]
            rel = [abs(a - b) / abs(b) for a, b in
                   zip(loss2 + norm2, loss1 + norm1)]
            if not (np.isfinite(loss2 + norm2).all()
                    and max(rel) <= TP_LOSS_RTOL):
                fail(f"(a) {arch} rank {r}: losses {loss2} and grad norms "
                     f"{norm2} vs pp 1's {loss1} and {norm1}")
        loss2, norm2 = outs[0]["a"][arch]
        rel = [abs(a - b) / abs(b) for a, b in
               zip(loss2 + norm2, loss1 + norm1)]
        log(f"[pp] (a) {arch} f32, pp 2 ({PP_ARCHS[arch][1]} "
            f"microbatches): losses {loss2!r}, grad norms {norm2!r}; worst "
            f"|pp2 - pp1| {max(rel):.3g} of pp 1's")

    # (b) and (c): qwen2-vl whole against the pp-1 session
    for leg, group, label in (("b", outs, f"{PP_VLM} pp 2"),
                              ("c", outs_c, f"{PP_VLM} pp 2 x tp 2 + SP")):
        _pp_log_train(leg, group, label)
        losses2 = group[0][leg][0][0]["losses"]
        if any(o[leg][0][0]["losses"] != losses2 for o in group):
            fail(f"({leg}) the ranks' losses differ")
        want = losses1[:PP_STEPS if leg == "b" else PP_TP_STEPS]
        rel = [abs(a - b) / abs(b) for a, b in zip(losses2, want)]
        log(f"[pp] ({leg}) losses {losses2!r} vs pp 1 {want!r}: "
            f"|pp2 - pp1| / |loss| by step {rel!r}")
        if len(losses2) != len(want) or not rel[0] <= 2e-3:
            fail(f"({leg}) step-0 loss {losses2[:1]!r} vs pp-1 "
                 f"{want[0]!r}")
        elif not all(r <= TP_LOSS_RTOL for r in rel[1:]):
            fail(f"({leg}) losses {losses2!r} vs pp-1 {want!r}: beyond "
                 f"{TP_LOSS_RTOL} x |loss|")
        _pp_gate_leaves(leg, group, m0_max, fail)
    log(f"[pp] (b) the two pp-2 runs equal bit for bit on every rank")
    prof = outs[0]["b"][0][-1]["prof"]
    log(f"[profile] pp (b) rank 0, step {PP_STEPS - 1} of run 2: host "
        f"{prof['host_ms']:.1f} ms, of which inside pp.collective "
        f"{prof['pp_ms']:.1f} ms ({prof['pp_n']} spans, "
        f"{100 * prof['pp_ms'] / prof['host_ms']:.1f}%); device busy "
        f"{prof['busy_ms']:.1f} ms ({100 * prof['busy_ms'] / prof['host_ms']:.1f}%"
        f"); {prof['launches'] - prof['missing']} of {prof['launches']} "
        f"launches have their device record")
    totals = {name: 0 for name in ops.KERNELS}
    for o in outs:
        for k, v in o["b"][1].items():
            totals[k] += v
    for o in outs_c:
        for k, v in o["c"][1].items():
            totals[k] += v
    log(f"[pp] launches of the counted runs, every rank: {_nonzero(totals)}")
    if failures:
        raise AssertionError("phase pp: " + "; ".join(failures))
    return totals


# ----------------------------------------------------------------------
# phase "shrink": a pod lost for good where pods and workers are ranks
# ----------------------------------------------------------------------
SHRINK_ARCH, SHRINK_LAYERS = "qwen2-vl-2b", 2
#: CodedCluster.hetero(2, 2): 4 ranks, a (pod, data) group each, FSDP
#: over each pod's 2 data ranks (the session's default).  Without FSDP
#: the reference test's hetero(3, 2) did not fit the card: its 6 ranks
#: ran out of its memory in their first step (a rank of hetero(2, 2)
#: peaked at 12.61 GiB; PERF.md §6)
SHRINK_CLUSTER = (2, 2)
SHRINK_BEFORE, SHRINK_AFTER = 3, 3   # steps before and after the shrink
SHRINK_DEAD_EDGE = 1
#: the ranks' losses against the one-card session's, × |loss| (phase
#: "tp"'s bound: the pod sums of 3 and 2 ranks run in another order)
SHRINK_LOSS_RTOL = TP_LOSS_RTOL
#: the survivors' params after the last step against the one-card
#: session's, per leaf, × the leaf's largest |value|: FSDP stores blocks
#: but steps on whole leaves with the fsdp=False arithmetic, and the
#: losses matched bit for bit without it (PERF.md §6)
SHRINK_PARAM_RTOL = 1e-6
#: the step (before the shrink: adamw's moments exist, no first-call
#: work) whose peak and FSDP gathers rank 0 measures for phase "dryrun"
SHRINK_GATED_STEP = 2


def _shrink_session(device, ck_dir="", resume=False):
    """qwen2-vl-2b at full width cut to 2 layers on ``SHRINK_CLUSTER``
    with the reference test's planner, in coded_q int8 at the phase-6
    settings: one rank a (pod, data) group in a world of ranks (FSDP
    over the data ranks), or every group on one card (``OneCardMesh``)
    in a single process."""
    from repro_torch.api import CodedCluster, CodedSession
    from repro_torch.configs.registry import get_config

    cfg = dataclasses.replace(get_config(SHRINK_ARCH),
                              n_layers=SHRINK_LAYERS)
    return CodedSession(CodedCluster.hetero(*SHRINK_CLUSTER), cfg,
                        planner="fixed", mode="coded_q",
                        grad_compression="int8", device=device,
                        total_steps=SHRINK_BEFORE + SHRINK_AFTER,
                        checkpoint_dir=ck_dir, resume=resume,
                        **_train_kw())


def _held_bytes(session) -> dict:
    """The bytes a rank's session holds (params, optimizer state, EF
    residual rows) and the slice arithmetic's: each leaf's whole size
    (the params' full shapes, the state made for them on ``meta``) over
    the data count on a split dim (``state_axis`` for the state), and one
    pod's row of every leaf for the residual."""
    import torch

    from repro_torch import _tree
    from repro_torch.checkpoint.params import _flatten, _unflatten
    from repro_torch.dist.sharding import _full_shapes, state_axis

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in _tree.leaves(tree))

    data = session._data.tp if session._data.active else 1
    axes = session._data_axes
    full = {k: torch.empty(v, device="meta")
            for k, v in _full_shapes(session.cfg).items()}
    state = _flatten(session._optimizer.init(_unflatten(full)))

    def want(flat, ax_of):
        return sum(v.numel() * v.element_size()
                   // (data if ax_of(k) is not None else 1)
                   for k, v in flat.items())

    return {"held": (nbytes(session.params), nbytes(session.opt_state),
                     nbytes(session.residual)),
            "want": (want(full, axes.get),
                     want(state, lambda k: state_axis(k, axes)),
                     4 * sum(v.numel() for v in full.values()))}


def _shrink_steps(session, n, out, gated=False):
    """``n`` steps, each timed (host ms, ending in a synchronize) and its
    launches exactly one ``coded_combine_q`` a param leaf and the flash
    forward twice a layer (the remat) for the rank's one group.  With
    ``gated``, step ``SHRINK_GATED_STEP`` also records its own
    ``max_memory_allocated`` and, under a CPU profile, its
    ``fsdp.collective`` spans (the FSDP gathers)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import _tree
    from repro_torch.dist.sharding import FSDP_SPAN
    from repro_torch.kernels import ops

    want = {"coded_combine_q": len(_tree.leaves(session.params)),
            "flash_attention": 2 * SHRINK_LAYERS}
    for _ in range(n):
        ops.reset_launch_counts()
        measure = gated and session._step == SHRINK_GATED_STEP
        torch.cuda.synchronize()
        if measure:
            torch.cuda.reset_peak_memory_stats()
            prof = profile(activities=[ProfilerActivity.CPU])
            prof.__enter__()
        t0 = time.perf_counter()
        session.fit(session._step + 1)
        torch.cuda.synchronize()
        out["step_ms"].append(1e3 * (time.perf_counter() - t0))
        if measure:
            prof.__exit__(None, None, None)
            out["step_peak"] = torch.cuda.max_memory_allocated()
            out["fsdp_spans"] = sum(e.name == FSDP_SPAN
                                    for e in prof.events())
            del prof
        got = _nonzero(_launches())
        if got != want:
            raise AssertionError(f"shrink step {session._step - 1}: "
                                 f"launches {got}, expected {want}")
        for k, v in got.items():
            out["counts"][k] = out["counts"].get(k, 0) + v


def _shrink_rank(ck_dir):
    """One rank of the world: 3 steps, edge 1 shrunk away, then on the
    survivors 2 steps, a checkpoint, and the last step; the survivors'
    first rank writes the gathered params beside the checkpoint.  A dead
    rank returns right after the shrink.  → this rank's record."""
    import numpy as np
    import torch
    import torch.distributed as dist

    _rank_threads(torch, dist.get_world_size())
    torch.cuda.reset_peak_memory_stats()
    s = _shrink_session("cuda", ck_dir)
    out = dict(rank=dist.get_rank(), step_ms=[], counts={},
               layout=(s._mesh.pod_rank, s._mesh.data_rank),
               fsdp=s._data.active, bytes=_held_bytes(s))
    _shrink_steps(s, SHRINK_BEFORE, out, gated=out["rank"] == 0)
    # this rank's live row (a pod rank holds only its own)
    before = [r[s._mesh.residual_row(s._mesh.pod_rank)].cpu()
              for r in s.residual]
    t0 = time.perf_counter()
    s.shrink(dead_edges=[SHRINK_DEAD_EDGE])
    out["shrink_ms"] = 1e3 * (time.perf_counter() - t0)
    out["retired"] = s._retired
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    if s._retired:
        try:
            s.step()
        except RuntimeError as err:
            out["refused"] = str(err)
        return out
    new_pod = s._mesh.pod_rank
    out["new_layout"] = (new_pod, s._mesh.data_rank)
    out["rows_equal"] = all(
        torch.equal(r[s._mesh.residual_row(new_pod)].cpu(), b)
        for r, b in zip(s.residual, before))
    del before
    out["bytes_after"] = _held_bytes(s)
    _shrink_steps(s, SHRINK_AFTER - 1, out)
    t0 = time.perf_counter()
    s.save_checkpoint()
    out["save_s"] = time.perf_counter() - t0
    _shrink_steps(s, 1, out)
    out["losses"] = list(s.losses)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    full = s.full_params()  # collective over the survivors
    if out["rank"] == s._mesh.ranks[0]:
        np.savez(Path(ck_dir) / "ranks_params.npz", **full)
    return out


def _shrink_resume_rank(ck_dir):
    """One rank of a fresh world of the survivors' size: resume the
    checkpoint and take the last step."""
    import torch
    import torch.distributed as dist

    _rank_threads(torch, dist.get_world_size())
    t0 = time.perf_counter()
    s = _shrink_session("cuda", ck_dir, resume=True)
    out = dict(rank=dist.get_rank(), step_ms=[], counts={},
               start=s._step, m=s.cluster.topo.m,
               layout=(s._mesh.pod_ranks, s._mesh.data_ranks),
               resume_s=time.perf_counter() - t0)
    _shrink_steps(s, 1, out)
    out["losses"] = list(s.losses)
    return out


def phase_shrink():
    """``CodedSession.shrink`` where pods and workers are ranks of their
    own, FSDP over the data ranks (the docstring's phase "shrink").  →
    (the launches of the ranks' counted steps, rank 0's measured step
    for phase "dryrun": its ``max_memory_allocated`` and FSDP gathers)."""
    import numpy as np
    import torch

    from repro_torch import _tree
    from repro_torch.dist.launch import run_ranks
    from repro_torch.kernels import ops

    gc.collect()
    torch.cuda.empty_cache()
    failures = []
    fail = failures.append
    gib = 2 ** 30
    meta = _shrink_session("meta")
    n_params = sum(p.numel() for p in _tree.leaves(meta.params))
    log(f"[shrink] {SHRINK_ARCH} at full width, {SHRINK_LAYERS} layers: "
        f"{n_params:,} params; hetero{SHRINK_CLUSTER}, K={meta.code.K}, "
        f"load D={meta.code.load}; coded_q int8, adamw, seq {TRAIN_SEQ}; "
        f"FSDP over each pod's data ranks")
    del meta
    pods, data = SHRINK_CLUSTER
    # the checkpoint (params, m, v, every pod's EF row) and the ranks'
    # gathered params
    ck = _checkpoint_dir(4 * n_params * (4 + pods - 1))
    n_world, n_live = pods * data, (pods - 1) * data
    try:
        t0 = time.perf_counter()
        outs = run_ranks(_shrink_rank, n_world, args=(str(ck),),
                         device="cuda", backend="gloo", timeout=900)
        log(f"[shrink] world of {n_world} ranks: "
            f"{time.perf_counter() - t0:.1f} s")
        spawned = {}

        def resume():
            try:
                spawned["outs"] = run_ranks(
                    _shrink_resume_rank, n_live, args=(str(ck),),
                    device="cuda", backend="gloo", timeout=900)
            except BaseException as e:  # raised again below
                spawned["error"] = e

        # the survivors' fresh world resumes while this process runs
        # the one-card session that shrinks at the same step
        thread = threading.Thread(target=resume, daemon=True)
        t0 = time.perf_counter()
        thread.start()
        one = _shrink_session("cuda")
        one.fit(SHRINK_BEFORE)
        one.shrink(dead_edges=[SHRINK_DEAD_EDGE])
        one.fit(SHRINK_BEFORE + SHRINK_AFTER)
        want = np.asarray(one.losses)
        ranks_params = np.load(ck / "ranks_params.npz")
        worst, worst_key = 0.0, ""
        for k, v in one.full_params().items():
            off = float(np.abs(ranks_params[k] - v).max()
                        / max(float(np.abs(v).max()), 1e-30))
            if off >= worst:
                worst, worst_key = off, k
        del one, ranks_params
        gc.collect()
        torch.cuda.empty_cache()
        thread.join()
        if "error" in spawned:
            raise spawned["error"]
        resumed = spawned["outs"]
        log(f"[shrink] one-card session and the resumed world of "
            f"{n_live}: {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    log(f"[shrink] the survivors' params after step "
        f"{SHRINK_BEFORE + SHRINK_AFTER - 1} against the one-card "
        f"session's: max |diff| / max |param| {worst:.3g} ({worst_key}; "
        f"limit {SHRINK_PARAM_RTOL:g})")
    if not worst <= SHRINK_PARAM_RTOL:
        fail(f"params off the one-card session's by {worst:.3g} x max "
             f"|param| ({worst_key})")
    for o in outs:
        for when, b in (("built", o["bytes"]),
                        ("after the shrink", o.get("bytes_after"))):
            if b is None:
                continue
            held, want_b = b["held"], b["want"]
            log(f"[shrink] rank {o['rank']} {when}: holds params "
                f"{held[0] / gib:.3f} GiB, adamw state "
                f"{held[1] / gib:.3f} GiB (slice arithmetic "
                f"{want_b[0] / gib:.3f}, {want_b[1] / gib:.3f}), EF "
                f"residual {held[2] / gib:.3f} GiB (one pod's row: "
                f"{want_b[2] / gib:.3f}); FSDP {o['fsdp']}")
            if held != want_b or not o["fsdp"]:
                fail(f"rank {o['rank']} {when}: holds {held} bytes, the "
                     f"FSDP slice arithmetic gives {want_b}")
    dead = [o for o in outs if o["retired"]]
    live = [o for o in outs if not o["retired"]]
    gone = list(range(SHRINK_DEAD_EDGE * data, (SHRINK_DEAD_EDGE + 1) * data))
    if [o["rank"] for o in dead] != gone:
        fail(f"retired ranks {[o['rank'] for o in dead]}, expected {gone}")
    for o in dead:
        log(f"[shrink] rank {o['rank']} (pod {o['layout'][0]}) retired "
            f"after its {SHRINK_BEFORE} steps, exit 0; a step there "
            f"raises: {o.get('refused', 'NOT RAISED')!r}; peak "
            f"{o['peak_gib']:.2f} GiB allocated")
        if "refused" not in o:
            fail(f"rank {o['rank']}: a step after retiring did not raise")
    for o in live:
        before, after = o["step_ms"][:SHRINK_BEFORE], \
            o["step_ms"][SHRINK_BEFORE:]
        log(f"[shrink] rank {o['rank']}: pod {o['layout'][0]} -> "
            f"{o['new_layout'][0]}, data {o['layout'][1]}; host ms a step "
            f"before the shrink {[round(x, 1) for x in before]}, after "
            f"{[round(x, 1) for x in after]}; shrink {o['shrink_ms']:.1f} "
            f"ms; checkpoint {o['save_s']:.1f} s; peak "
            f"{o['peak_gib']:.2f} GiB allocated (without FSDP: "
            f"12.61); EF rows carried bit for bit: {o['rows_equal']}")
        if not o["rows_equal"]:
            fail(f"rank {o['rank']}: its pod's EF residual row changed "
                 f"across the shrink")
        got = np.asarray(o["losses"])
        if got.shape != want.shape or not np.isfinite(got).all():
            fail(f"rank {o['rank']}: losses {got}")
            continue
        rel = np.abs(got - want) / np.abs(want)
        log(f"[shrink] rank {o['rank']} losses {got.round(5).tolist()}; "
            f"one-card {want.round(5).tolist()}: max |diff| / |loss| "
            f"{rel.max():.3g} (limit {SHRINK_LOSS_RTOL})")
        if not rel.max() <= SHRINK_LOSS_RTOL:
            fail(f"rank {o['rank']}: losses off the one-card session's by "
                 f"{rel.max():.3g} x |loss|")
    last = live[0]["losses"][-1] if live else None
    for r in resumed:
        log(f"[shrink] resumed rank {r['rank']}: layout {r['layout']} "
            f"for m={r['m']}, from step {r['start']} (built in "
            f"{r['resume_s']:.1f} s), step {r['step_ms'][0]:.1f} ms, loss "
            f"{r['losses'][-1]!r} (uninterrupted {last!r})")
        if r["start"] != SHRINK_BEFORE + SHRINK_AFTER - 1 \
                or r["losses"][-1] != last:
            fail(f"resumed rank {r['rank']}: from step {r['start']}, loss "
                 f"{r['losses'][-1]!r} against {last!r}")
    totals = {name: 0 for name in ops.KERNELS}
    for o in outs + resumed:
        for k, v in o["counts"].items():
            totals[k] += v
    log(f"[shrink] launches of the counted steps, every rank: "
        f"{_nonzero(totals)}")
    if failures:
        raise AssertionError("phase shrink: " + "; ".join(failures))
    rank0 = outs[0]
    log(f"[shrink] rank 0's step {SHRINK_GATED_STEP}: "
        f"max_memory_allocated {rank0['step_peak'] / gib:.2f} GiB, "
        f"{rank0['fsdp_spans']} fsdp.collective spans (profiled)")
    return totals, {"peak": rank0["step_peak"],
                    "fsdp_spans": rank0["fsdp_spans"]}


# ----------------------------------------------------------------------
# phase "dryrun": the dry run's predictions against the card
# ----------------------------------------------------------------------
#: predicted peak memory against ``max_memory_allocated``.  The sound
#: count read −0.77% and −0.21% (phase 4) and −0.34% (phase 6) on an
#: H100; phase 4's step makes 1.05 of its 16.1 GiB (the prefill's cache,
#: its 1057-slot copy, the activations), so a count that missed all of
#: the step's own memory would read about −7%.  2% sits between the two.
DRY_PEAK_RTOL = 0.02


def _meta_request(cfg, tp, gen):
    """Phase 4's request on the meta device at tp ``tp`` (rank 0's view,
    its collectives on a counting group of ``tp`` ranks on one host),
    through ``serving.token_loop`` → the counted records of its prefill
    and of its decode loop (the first greedy pick, then ``gen`` decode
    steps and picks), whose arguments hold the prefill's outputs: the
    request's peak is the larger of the two."""
    import torch

    from repro_torch.api import aot, serving
    from repro_torch.dist import sharding as sh
    from repro_torch.launch import op_analysis
    from repro_torch.launch.mesh import NVLINK_BW

    tallies = {ph: sh.CollectiveTally() for ph in ("prefill", "decode")}
    ctxs = {ph: sh.NULL_CTX if tp == 1 else sh.ShardCtx(
        tp=tp, rank=0, group=sh.CountingGroup(tp, tuple(range(tp)),
                                              NVLINK_BW, t))
        for ph, t in tallies.items()}
    params = aot.tf_params(cfg, tp)
    prompt = torch.empty((B, PROMPT), dtype=torch.long, device="meta")
    recs, decoding = {}, []
    prefill_fn = serving.make_prefill_fn(cfg, PROMPT + gen + 1,
                                         ctx=ctxs["prefill"])

    def prefill(params, prompt):
        out, recs["prefill"] = aot.count_step(prefill_fn, params, prompt,
                                              tally=tallies["prefill"])
        # the decode loop's counter, from the first pick on
        decoding.append(op_analysis.OpCounter((params,) + tuple(out)))
        decoding[0].__enter__()
        return out

    with torch.no_grad():  # counts as inference_mode does, faster
        serving.token_loop(params, cfg, prompt, gen, prefill_fn=prefill,
                           decode_fn=serving.make_decode_fn(
                               cfg, ctx=ctxs["decode"]),
                           ctx=ctxs["decode"])
        decoding[0].__exit__(None, None, None)
    recs["decode"] = op_analysis.analysis_record(decoding[0],
                                                 tallies["decode"])
    recs["decode"]["memory_analysis"] = decoding[0].memory_analysis()
    return recs


def _bound_ms(rec, per=1):
    """The step's predicted compute and memory bounds (the attention
    kernels' own bytes), ms."""
    from repro_torch.api import aot

    r = aot.roofline_terms(rec)
    return 1e3 * r["compute_s"] / per, 1e3 * r["memory_s_pallas"] / per


def _meta_fsdp_step():
    """Phase "shrink"'s rank 0 step on the meta device: the hetero(2, 2)
    session's state cut to rank 0's FSDP blocks and its own pod's EF
    row, its collectives on a counting ``DistMesh`` (the FSDP gathers on
    a group of their own) → (the counted record, the FSDP gathers'
    tally)."""
    from repro_torch import _tree
    from repro_torch.api import aot
    from repro_torch.dist import compression, grad_sync
    from repro_torch.dist import sharding as sh
    from repro_torch.dist.mesh import DistMesh
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch.mesh import NVLINK_BW

    s = _shrink_session("meta")
    pods, data = SHRINK_CLUSTER
    tally = sh.CollectiveTally()
    mesh = DistMesh.counting(pods, data, pod_ranks=pods, data_ranks=data,
                             tally=tally, link=NVLINK_BW)
    fsdp_tally = sh.CollectiveTally()
    mesh.data_ctx = dataclasses.replace(mesh.data_ctx, group=dataclasses
                                        .replace(mesh.data_ctx.group,
                                                 tally=fsdp_tally))
    residual = _tree.leaves(compression.init_pod_residuals(
        s.params, len(mesh.residual_rows())))
    s._slice_data(mesh.data_ctx)
    step = steps_lib._make_dist_train_step(s.cfg, s.tcfg, mesh,
                                           optimizer=s._optimizer)
    topo = s.cluster.topo
    fast_e, fast_w = tuple(range(topo.n)), [tuple(range(m))
                                            for m in topo.m]
    batch = s._to_device(s.build_batch(fast_e, fast_w))
    lam = grad_sync.lam_array_from_code(s.code, fast_e, fast_w, topo.n,
                                        topo.m[0])
    _, rec = aot.count_step(
        step, s.params, s.opt_state, batch, lam, residual,
        SHRINK_GATED_STEP,
        arguments=(s.params, s.opt_state, batch, residual), tally=tally)
    return rec, fsdp_tally


def phase_dryrun(serve, train, spans, shrink):
    """The dry run's machinery (``api.aot``, ``launch.op_analysis``) on
    the meta device against what phases 4 (``serve``: its peak and
    device ms), 6 (``train``: the same), "tp" (``spans``: (b)'s
    ``tp.collective`` spans a phase) and "shrink" (``shrink``: rank 0's
    FSDP step's peak and ``fsdp.collective`` spans) measured (the
    docstring's phase "dryrun").  No kernel runs: → no launches."""
    import torch

    from repro_torch.api import aot
    from repro_torch.configs.registry import get_config
    from repro_torch.dist import grad_sync

    failures = []
    fail = failures.append
    gib = 2 ** 30

    def gate(label, rec, measured):
        m = rec["memory_analysis"]
        pred = m["peak_bytes"]
        share = pred / measured - 1
        log(f"[dryrun] {label}: predicted peak {pred / gib:.2f} GiB "
            f"(arguments {m['argument_bytes'] / gib:.2f}, step "
            f"{(pred - m['argument_bytes']) / gib:.2f}) against "
            f"max_memory_allocated {measured / gib:.2f} GiB: "
            f"{100 * share:+.2f}% (limit ±{100 * DRY_PEAK_RTOL:.0f}%)")
        if not abs(share) <= DRY_PEAK_RTOL:
            fail(f"{label}: predicted peak off by {100 * share:+.1f}%")

    # phase 4: llama3-8b, 32 layers, bf16, B 4, 1024-token prompts, GEN
    cfg = get_config("llama3-8b")
    t0 = time.perf_counter()
    recs = _meta_request(cfg, 1, GEN)
    log(f"[dryrun] phase 4's request counted on meta in "
        f"{time.perf_counter() - t0:.1f} s")
    gate("phase 4 (serve)", max(recs.values(), key=lambda r: r[
        "memory_analysis"]["peak_bytes"]), serve["peak"])
    for ph, per, unit in (("prefill", 1, "ms"), ("decode", GEN,
                                                 "ms/token")):
        c, m = _bound_ms(recs[ph], per)
        log(f"[dryrun] phase 4 {ph}: predicted bound compute {c:.3f} "
            f"{unit}, memory {m:.3f} {unit}; profiled device "
            f"{serve['device_ms'][ph]:.3f} {unit} (not gated)")

    # phase 6: llama3-8b, 2 layers, coded_q int8 step on one card
    t0 = time.perf_counter()
    s = _session(_train_cfg(), "coded_q", "int8", "meta",
                 total_steps=5, **_train_kw())
    topo = s.cluster.topo
    fast_e, fast_w = tuple(range(topo.n)), [tuple(range(m))
                                            for m in topo.m]
    batch = s._to_device(s.build_batch(fast_e, fast_w))
    lam = grad_sync.lam_array_from_code(s.code, fast_e, fast_w, topo.n,
                                        topo.m[0])
    _, rec = aot.count_step(
        s.train_step, s.params, s.opt_state, batch, lam, s.residual, 0,
        arguments=(s.params, s.opt_state, batch, s.residual))
    del s, batch
    log(f"[dryrun] phase 6's int8 step counted on meta in "
        f"{time.perf_counter() - t0:.1f} s; its kernels "
        f"{ {k: v['calls'] for k, v in rec['kernels'].items()} }")
    gate("phase 6 (int8 train step)", rec, train["peak"])
    c, m = _bound_ms(rec)
    log(f"[dryrun] phase 6 step: predicted bound compute {c:.3f} ms, "
        f"memory {m:.3f} ms; profiled device {train['device_ms']:.3f} ms "
        f"(not gated)")

    # phase "tp" (b): llama3-8b cut to 8 layers at tp 2, its collectives
    recs = _meta_request(dataclasses.replace(cfg, n_layers=TP_SERVE_LAYERS),
                         TP, TP_PROFILED_GEN)
    for ph in ("prefill", "decode"):
        n = sum(v["count"] for v in recs[ph]["collectives"].values())
        log(f"[dryrun] tp {TP} llama3-8b ({TP_SERVE_LAYERS} layers) {ph}: "
            f"counted collectives {n} "
            f"({ {k: v['count'] for k, v in recs[ph]['collectives'].items() if v['count']} }); "
            f"phase tp (b) rank 0's profile: {spans[ph]} tp.collective "
            f"spans")
        if n != spans[ph]:
            fail(f"tp {ph}: {n} collectives counted, {spans[ph]} profiled")

    # phase "shrink": rank 0's FSDP step (blocks, whole copies, own row)
    t0 = time.perf_counter()
    rec, fsdp_tally = _meta_fsdp_step()
    log(f"[dryrun] phase shrink's rank 0 FSDP step counted on meta in "
        f"{time.perf_counter() - t0:.1f} s; collectives "
        f"{ {k: v['count'] for k, v in rec['collectives'].items() if v['count']} }")
    gate(f"phase shrink (FSDP rank 0, step {SHRINK_GATED_STEP})", rec,
         shrink["peak"])
    n = fsdp_tally.by_kind["all-gather"]["count"]
    log(f"[dryrun] FSDP gathers over data counted {n} "
        f"({fsdp_tally.total('operand_bytes') / 2 ** 30:.3f} GiB of "
        f"blocks); phase shrink rank 0's profile: {shrink['fsdp_spans']} "
        f"fsdp.collective spans")
    if n != shrink["fsdp_spans"] or fsdp_tally.total("count") != n:
        fail(f"FSDP: {n} gathers counted, {shrink['fsdp_spans']} profiled")
    if failures:
        raise AssertionError("phase dryrun: " + "; ".join(failures))
    return {}


def _launches():
    """The kernels' launch counts since the last ``reset_launch_counts``.
    ``ops.launch_counts()`` also holds the ``span.*`` and ``count.*``
    tallies of any step a profiler recorded; the checks here compare
    kernel launches alone."""
    from repro_torch.kernels import ops
    return {k: v for k, v in ops.launch_counts().items() if k in ops.KERNELS}


def _nonzero(counts):
    return {k: v for k, v in counts.items() if v}


def _eval_parity(torch, totals):
    """``simulate_training`` on the card against the CPU from the same
    initial weights: the CNN under hgc and the logreg under greedy, 3
    iterations at batch 32 per part."""
    import numpy as np

    from repro_torch.api import paper_cluster, simulate_training
    from repro_torch.kernels import ops
    from repro_torch.models import classic

    n_eval, iters = 500, 3
    for name, dataset, init in (("hgc", "cifar", classic.init_cnn),
                                ("greedy", "mnist", classic.init_logreg)):
        t0 = time.perf_counter()
        kw = dict(dataset=dataset, K=EVAL_K, batch_per_part=EVAL_BATCH,
                  n_data=2000, n_eval=n_eval, iters=iters,
                  init_params=init(0))
        ops.reset_launch_counts()
        card = simulate_training(name, paper_cluster(dataset),
                                 device="cuda", **kw)
        counts = _nonzero(_launches())
        if counts != {"coded_combine": iters}:
            raise AssertionError(f"{name} {dataset}: launches {counts}")
        totals["coded_combine"] += iters
        t_card = time.perf_counter() - t0
        cpu = simulate_training(name, paper_cluster(dataset), device="cpu",
                                **kw)
        loss_off = np.abs(card.losses - cpu.losses) / np.abs(cpu.losses)
        acc_off = np.abs(card.accuracies - cpu.accuracies)
        if not (np.array_equal(card.iter_times_ms, cpu.iter_times_ms)
                and np.isfinite(card.losses).all()
                and loss_off.max() <= 2e-3
                and acc_off.max() <= 2 / n_eval):
            raise AssertionError(
                f"{name} {dataset}: card {card} against cpu {cpu}")
        log(f"[eval] card == cpu, {name} on {dataset}: times equal, losses "
            f"{np.round(card.losses, 5).tolist()} within "
            f"{[float(f'{x:.3g}') for x in loss_off]} x |loss| (limit "
            f"2e-3), accuracies "
            f"{card.accuracies.tolist()} within {acc_off.max():.3g} (limit "
            f"{2 / n_eval:g}); card {t_card:.1f} s, cpu "
            f"{time.perf_counter() - t0 - t_card:.1f} s")


def _eval_exact(torch):
    """At one CNN iteration's per-part gradients on the card, every exact
    scheme's aggregate (one combine launch) equals the plain sum of the
    K part gradients within 1e-5·max|Σg|."""
    import numpy as np

    from repro_torch.api import paper_cluster
    from repro_torch.core.schemes import SCHEME_NAMES, make_scheme
    from repro_torch.sim.simulator import TrainingRun

    params = paper_cluster("cifar")
    run = TrainingRun("hgc", params, dataset="cifar", K=EVAL_K,
                      batch_per_part=EVAL_BATCH, n_data=2000, n_eval=10,
                      iters=1, device="cuda")
    sel = torch.arange(EVAL_BATCH, device="cuda")
    g = run.part_gradients(sel)
    want = g.sum(0)
    scale = want.abs().max().item()
    rng = np.random.default_rng(3)
    worst = {}
    for name in SCHEME_NAMES:
        scheme = make_scheme(name, params.topo, EVAL_K, params=params)
        if not scheme.exact:
            continue
        D = getattr(scheme, "load_array", scheme.load)
        outcome = scheme.iteration(params.sample_iteration(rng, D))
        err = (scheme.gradient(g, outcome) - want).abs().max().item()
        if not err <= 1e-5 * scale:
            raise AssertionError(f"{name}: aggregate off the sum by "
                                 f"{err:.3g} > 1e-5 x {scale:.3g}")
        worst[name] = err / scale
    log(f"[eval] exact schemes' aggregates == sum of the {EVAL_K} part "
        f"gradients of the CNN (F={g.shape[1]}, row stride "
        f"{g.stride(0)}), in x max|sum| (limit 1e-5): "
        + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()))


def _kernel_group(name: str) -> str:
    """The part of an evaluation iteration a device event belongs to."""
    if "combine_kernel" in name or "combine_f32_kernel" in name:
        return "the port's combine kernel"
    if name.startswith("Memcpy") or name.startswith("Memset"):
        return "copies and sets"
    if "at::native" in name:
        return "PyTorch elementwise, reductions, pooling (the update too)"
    return "cuDNN / cuBLAS (convolutions, FC products)"


# the runtime calls whose work shows on the card as one record each,
# sharing the call's correlation id
_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync")


def _device_records(prof, DeviceType):
    """The device records of a profiler session, as (name, start ns, end
    ns), and the number of its launch calls and of those among them whose
    device record the session lacks."""
    events = prof.profiler.kineto_results.events()
    records, ids = [], set()
    for e in events:
        if e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            records.append((e.name(), e.start_ns(), e.end_ns()))
            ids.add(e.correlation_id())
    launches = [e.correlation_id() for e in events
                if e.device_type() == DeviceType.CPU
                and e.name() in _LAUNCH_CALLS]
    return records, len(launches), sum(c not in ids for c in launches)


def _encode_device_ms(prof, DeviceType):
    """Device ms of the kernels launched inside the "serve.encode" span
    (by their launch call's correlation id: the span has no synchronize
    at its end, so the encoder's kernels may start on the device after
    it), and their count."""
    events = prof.profiler.kineto_results.events()
    spans = [e for e in events if e.device_type() == DeviceType.CPU
             and e.name() == "serve.encode"]
    if len(spans) != 1:
        raise AssertionError(f"{len(spans)} serve.encode spans")
    lo, hi = spans[0].start_ns(), spans[0].end_ns()
    ids = {e.correlation_id() for e in events
           if e.device_type() == DeviceType.CPU
           and e.name() in _LAUNCH_CALLS and lo <= e.start_ns() < hi}
    ns = [e.end_ns() - e.start_ns() for e in events
          if e.device_type() == DeviceType.CUDA
          and not e.is_user_annotation() and e.correlation_id() in ids]
    return sum(ns) / 1e6, len(ns)


def _eval_profile(torch, profile, ProfilerActivity, dataset):
    """One hgc iteration at the paper's sizes under ``torch.profiler``:
    device ms by kernel name and by part, busy as the union of the
    device intervals (cuDNN's kernels overlap), over the median host
    time of three unprofiled iterations (the profiler slows the host).

    On the card a profiler session now and then lacks the records of its
    first kernels, the more the longer the process has run: the first
    session after a minute without one lost from a few to all of MNIST's
    30.  So each session traces a warm-up iteration that the profiler's
    schedule discards, and the kept iteration counts only if every launch
    call in it has its device record (matched by correlation id); else
    the next pair is profiled, eight tries in all, and if none is whole
    the most nearly whole is reported as a lower bound."""
    import collections

    from torch.autograd import DeviceType
    from torch.profiler import schedule

    from repro_torch.api import paper_cluster
    from repro_torch.sim.simulator import TrainingRun

    tries = 8
    # 4 unprofiled iterations, 2 a try, and a last one (which evaluates)
    # that is never run
    run = TrainingRun("hgc", paper_cluster(dataset), dataset=dataset,
                      K=EVAL_K, batch_per_part=EVAL_BATCH,
                      n_data=EVAL_N_DATA, n_eval=EVAL_N_EVAL,
                      iters=5 + 2 * tries, eval_every=100, device="cuda")
    host = []
    for t in range(4):  # t = 0 evaluates; 1..3 are timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run.step()
        torch.cuda.synchronize()
        host.append(1e3 * (time.perf_counter() - t0))
    best = None  # (missing, records, launches, host ms, try)
    for attempt in range(1, tries + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):  # the warm-up iteration, then the kept one
                t0 = time.perf_counter()
                run.step()
                torch.cuda.synchronize()
                profiled_ms = 1e3 * (time.perf_counter() - t0)
                prof.step()
        records, launches, missing = _device_records(prof, DeviceType)
        if records and (best is None or missing < best[0]):
            best = (missing, records, launches, profiled_ms, attempt)
        if records and not missing:
            break
        log(f"[profile] {dataset} hgc iteration: {missing} of {launches} "
            f"launches have no device record (try {attempt} of {tries})")
    if best is None:
        raise AssertionError("the profiler saw no device work in the "
                             "iteration")
    missing, records, launches, profiled_ms, attempt = best
    by_name = collections.Counter()
    spans = []
    for name, start, end in records:
        by_name[name] += (end - start) / 1e6
        spans.append((start / 1e3, end / 1e3))
    log(f"[profile] {dataset} hgc iteration: "
        + (f"all {launches} launches have their device record (try "
           f"{attempt})" if not missing else
           f"{missing} of {launches} launches lack their device record in "
           f"every try: the times below are lower bounds"))
    spans.sort()
    busy_us, until = 0.0, spans[0][0]
    for start, end in spans:  # the union of the device intervals
        busy_us += max(0.0, end - max(start, until))
        until = max(until, end)
    busy = busy_us / 1e3
    median = sorted(host[1:4])[1]
    log(f"[profile] {dataset} hgc iteration: {len(spans)} device events, "
        f"{sum(by_name.values()):.3f} ms summed, {busy:.3f} ms busy (their "
        f"union), first to last {(spans[-1][1] - spans[0][0]) / 1e3:.3f} "
        f"ms; over the unprofiled iterations' median host {median:.3f} ms "
        f"({[round(x, 3) for x in host[1:4]]}): device busy "
        f"{100 * busy / median:.1f}% (host under the profiler "
        f"{profiled_ms:.3f} ms)")
    groups = collections.Counter()
    for name, ms in by_name.items():
        groups[_kernel_group(name)] += ms
    for group, ms in groups.most_common():
        log(f"[profile]   {ms:9.3f} ms  {group}")
    for name, ms in by_name.most_common(10):
        log(f"[profile]   {ms:9.3f} ms  {name[:90]}")


def _eval_run(torch, name, dataset, totals):
    """One ``TrainingRun`` at the paper's sizes: its trace, host ms per
    iteration (ending in a synchronize) and set-up s; the combine must
    launch exactly once per iteration, and nothing else."""
    import numpy as np

    from repro_torch.api import paper_cluster
    from repro_torch.kernels import ops
    from repro_torch.sim.simulator import TrainingRun

    iters, every, seed = EVAL_RUNS[dataset]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run = TrainingRun(name, paper_cluster(dataset), dataset=dataset,
                      K=EVAL_K, iters=iters, batch_per_part=EVAL_BATCH,
                      eval_every=every, n_data=EVAL_N_DATA,
                      n_eval=EVAL_N_EVAL, seed=seed, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(iters):
        run.step()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / iters
    counts = _nonzero(_launches())
    if counts != {"coded_combine": iters}:
        raise AssertionError(f"{dataset} {name}: launches {counts}, "
                             f"expected {iters} coded_combine")
    totals["coded_combine"] += iters
    tr = run.trace()
    if not (np.isfinite(tr.losses).all()
            and np.isfinite(tr.accuracies).all()):
        raise AssertionError(f"{dataset} {name}: {tr}")
    return tr, wall_ms, setup_s, counts


def phase_eval():
    """The paper's evaluation path on the card: card against CPU, the
    exact schemes' decode, every scheme at the paper's sizes (launches
    of the combine set to 0 before each run and read after it: exactly
    one per iteration, and no other kernel), the CIFAR hgc run a second
    time (losses and accuracies equal bit for bit), one profiled
    iteration of each model."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.schemes import SCHEME_NAMES
    from repro_torch.kernels import ops

    totals = {name: 0 for name in ops.KERNELS}
    _eval_parity(torch, totals)
    _eval_exact(torch)
    for dataset in EVAL_RUNS:
        for name in SCHEME_NAMES:
            tr, wall_ms, setup_s, counts = _eval_run(torch, name, dataset,
                                                     totals)
            hit = tr.time_to_accuracy(EVAL_TARGET)
            log(f"[eval] {dataset} {name}: simulated "
                f"{tr.iter_times_ms.mean():.3f} ms/iteration, "
                f"{tr.total_time_h:.4f} h; final accuracy "
                f"{tr.accuracies[-1]:.4f}; to {EVAL_TARGET}: "
                + (f"{hit:.4f} h" if hit is not None else "not reached")
                + f"; host {wall_ms:.3f} ms/iteration (set-up "
                f"{setup_s:.2f} s); peak "
                f"{torch.cuda.max_memory_allocated() / 2 ** 20:.1f} MiB; "
                f"launches {counts}")
            if (dataset, name) == ("cifar", "hgc"):
                again, wall2, _, _ = _eval_run(torch, name, dataset, totals)
                if not (np.array_equal(again.losses, tr.losses)
                        and np.array_equal(again.accuracies, tr.accuracies)):
                    raise AssertionError(
                        f"cifar hgc does not repeat: losses differ at "
                        f"{np.flatnonzero(again.losses != tr.losses)[:5]}, "
                        f"accuracies {tr.accuracies} against "
                        f"{again.accuracies}")
                log(f"[eval] cifar hgc run again: {len(tr.losses)} losses "
                    f"and {len(tr.accuracies)} accuracies equal bit for "
                    f"bit; host {wall2:.3f} ms/iteration")
    for dataset in EVAL_RUNS:
        _eval_profile(torch, profile, ProfilerActivity, dataset)
    torch.cuda.empty_cache()
    return totals


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    src = ROOT / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not under {src}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    t0 = time.perf_counter()

    def phase(fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        log(f"[phase] {fn.__name__}: {time.perf_counter() - t:.1f} s")
        return out

    phase(phase_device)
    phase(phase_build)
    rows = phase(phase_kernels)
    phase(phase_parity)
    counts, serve_measured = phase(phase_serve)
    archs_counts = phase(phase_archs)
    rec_counts = phase(phase_recurrent)
    encdec_counts = phase(phase_encdec_vlm)
    phase(phase_train_parity)
    train_counts, train_measured = phase(phase_train)
    ckpt_counts = phase(phase_checkpoint)
    orch_counts = phase(phase_orchestrate)
    tp_counts, tp_spans = phase(phase_tp)
    pp_counts = phase(phase_pp)
    shrink_counts, shrink_measured = phase(phase_shrink)
    phase(phase_dryrun, serve_measured, train_measured, tp_spans,
          shrink_measured)
    eval_counts = phase(phase_eval)
    paths = {"archs": archs_counts, "recurrent": rec_counts,
             "encdec_vlm": encdec_counts, "train": train_counts,
             "checkpoint": ckpt_counts,
             "orchestrate": orch_counts, "tp": tp_counts, "pp": pp_counts,
             "shrink": shrink_counts, "eval": eval_counts}
    log(f"[done] launches on the main paths: serve {counts}, " + ", ".join(
        f"{name} { {k: v for k, v in c.items() if v} }"
        for name, c in paths.items()))
    csrc = "src/repro_torch/kernels/csrc/"
    sources = {"decode_attention": (csrc + "decode_attention.cu",
                                    "src/repro/kernels/decode_attention.py:131"),
               "flash_attention": (csrc + "flash_attention.cu",
                                   "src/repro/kernels/flash_attention.py:100")}
    for name, _, replaces in COMBINE.values():
        sources[name] = (csrc + "coded_combine.cu", replaces)
    for name in MOE_KERNELS:  # the reference's dispatch is jnp gathers
        sources[name] = (csrc + "moe_shuffle.cu", "none")
    kernels = [dict(name=name, route="cuda", source=sources[name][0],
                    replaces=sources[name][1],
                    launches=counts.get(name, 0)
                    + sum(c.get(name, 0) for c in paths.values()), **r)
               for name, r in rows.items()]
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
