#!/usr/bin/env python3
"""Build the port's CUDA kernels and drive its fleet and serving paths on one
NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and the exit code
is non-zero:

1. the card (``nvidia-smi`` name and power limit) and the kernel build,
   with ptxas's registers, static shared memory and spills for each
   instance of ``tile_delta_gate.cu`` (B1, B5: the detector's and the
   generic instance of each), of ``tile_delta.cu`` (B10, B11), of
   ``roi_conv_entry.cu`` (B2, B7, B8: the detector's and the
   generic instance of each), of ``roi_conv_stack.cu`` (B3's ring route,
   B6), of ``roi_conv_layers.cu`` (B3's layer-by-layer route) and of B12;
2. every kernel against its plain PyTorch version on the card, at the
   main paths' shapes: the delta kernels (the canvas gate B1, the packed
   gate B5 with its windows, the per-camera tile and halo pricing B10 and
   B11) and the tile copies (the fleet scatter B4, one camera's gather and
   scatter B9) bit-exact, the convolutions (the entry B2 and its
   ReLU-free twin B7, the stack B3, each per-layer packed layer B6 over
   the fleet, one camera's B8) within 1e-4 (FMA contraction and summation
   order differ; the plain versions use no TF32); each kernel's time (CUDA
   events, median of 7) beside the plain version's and its bound.  B5's
   stats also equal B1's on the same content, B10's rows B1's body
   columns, camera by camera; ReLU of B7 is B2 and B8 is B7's rows of its
   camera, bit for bit.  B1 and B5 run the gate kernel's compiled-in
   detector instance (asserted, with the launcher's own answer); on the
   fleet's content and on content where every element changed, the
   generic instance (copies 4 bytes off an 8-byte boundary) and a compact
   launch on an eighth of the rows give their bits, and their GB/s and
   share of the bound are printed by event and device time; on small
   fleets of 0.5-grid ties with -0.0 over 0.0 and NaNs, and of changed
   content, at tiles 8x8, 16x16 and 8x7, Cin 3 and 5, qstep 1, 8 and 13,
   both are bitwise equal to their plain versions.  B10 and B11 run
   their kernel's compiled-in detector instance on the 20 cameras
   (asserted, likewise); the generic instance (copies 4 bytes off an
   8-byte boundary) and content where every element changed give their
   plain versions' bits; their event and device times, each with its
   share of the bound, are printed beside a launch of one tile a camera
   (the per-launch floor), and B11's bound also in the 32-byte sectors
   its rings touch; on small frames of 0.5-grid ties with -0.0 over 0.0,
   of NaN, +-Inf and +-3e10 deltas and of changed content at seven (th,
   tw, C), qstep 1, 8 and 13, and on one tile each past the old 48 KB
   cap, they equal their plain versions (which equal the CPU's).  Every
   device-time reading counts the profiler's kernel records and prints
   a short count as invalid.  B2, B7 and B8 run the
   entry kernel's compiled-in detector instance (asserted, likewise); on
   the fleet the generic instance (a copy of the frames 4 bytes off a 16-byte
   boundary) and a compact launch on an eighth of the rows give B2's bits;
   their achieved GB/s and share of the bound are printed, by event time
   and by the profiler's device time.  B12, the packed attention, at the
   test suite's shapes (f32 within 2e-5, bf16 within 0.05 on real rows)
   and at the serving slice's (the fleet's 9,472-token packed patch
   stream, 48 heads of 128, bf16): skipped and exhaustive walks bitwise
   equal on real rows, visited counts equal to ``attention_visit_bound``,
   an all-padding stream 0 visits and zeros; times beside the plain version
   and ``scaled_dot_product_attention`` with the boolean mask; B3's and
   B12's achieved TFLOP/s and share of the bound, B6's per layer and for
   both.  B3's layer-by-layer route: at the fleet's 2 layers bitwise equal
   to the ring route, and at 9 layers (8 -> 16, then 16 -> 16 eight times,
   past the ring's depth) one launch bitwise equal to nine B6 + ReLU
   launches and within 1e-4 of the plain version, timed.  B12 at head dim
   120 (zero-padded to 128) on the serving slice's positions, f32 and bf16,
   within the same bars, skip == exhaustive bitwise;
3. the main path at full size -- the 4-group x 5-camera fleet at the
   paper's camera sizes (four 1920x1080 legs and one 1280x960 centre
   camera per group), default detector (channels (8, 16, 16), tile 16, 2
   anchors), RoI masks at density 0.35 on the offline 64-px grid: one
   cold step, six warm steps each giving 5 cameras a fresh 64x64 patch,
   one all-static step, two lossy warm steps at threshold 40 whose
   patches change tile interiors only, and two lossy steps with whole
   tile-aligned patches, each step through a canvas-reference cache and
   (3b) a packed-reference cache in lockstep.  Every step checks the
   runtime's dispatch structure in both modes; the warm threshold-0 steps
   are bitwise equal to a cold recompute through the kernels; the cold
   step is within 1e-4 of the plain-version composition; on the cold,
   threshold-0, all-static and interior-lossy steps the two caches give
   equal ReuseStats (gate stats included) and bitwise-equal head maps;
3c. the edge rate-control loop, on both caches: one threshold-0 step to
   align the references, then a threshold-0 step whose gate stats give
   each camera's static fraction with no launch -- equal, camera by
   camera, to ``tile_static_fraction`` through B10 -- then the halo
   fractions through B11, the rate controller on seeded (20, 10) byte
   matrices behind an uplink that congests every other camera, its
   quality trace as a (20, 2) per-camera, per-tile-class threshold table,
   and one more step under that table: the unshed cameras bitwise equal to
   a cold recompute, sub-threshold changes on the congested cameras not
   recomputed, both caches equal;
3d. the per-layer and single-camera paths on the same fleet:
   ``fleet_forward_layers`` (B7, then B6 + ReLU per layer, B4) bitwise
   equal to ``fleet_forward`` (B2 + B3 + B4); for each of the 20 cameras
   ``roi_forward`` (B2 + B3 + B9's scatter, the frame padded to its grid)
   bitwise equal to ``roi_forward_layers`` (B8, B6 + ReLU, B9), to the
   one-camera ``fleet_forward`` and to the fleet's map; each path's
   dispatches as the JAX package's; ``forward`` on the RoI path at density
   0.35 and on the dense path with an all-true grid (within 1e-4 of
   ``roi_forward`` there, on the leg padded to its grid);
   ``roi_conv_batched`` over a group's four legs with one mask, one
   launch on the detector instance, bitwise equal to B8 frame by frame; B9's
   gather taking the RoI tiles of a full-frame SAME conv (``F.conv2d``,
   no TF32), within 1e-4 of B8, and of each ``roi_forward`` map, bitwise
   equal to the packed head rows;
3e. CrossRoI's offline -> online path: the 4-group x 5-camera fleet of
   ``tests/test_fleet.py``'s end-to-end test (groups uniform 21, sparse
   22, rush_hour 23, bursty 24) as 120 s scenes, through
   ``run_fleet_offline`` on the host (600 profile frames, the exact set
   cover; per group |M|, density, optimality and host seconds); each
   camera's 64-px mask expanded x4 to 16-px tiles; on those masks and
   seeded frames, ``fleet_inference_step`` and a canvas and a packed
   cache in lockstep through cold (== the inference step bitwise, within
   1e-4 of the plain composition), warm (5 of 20 cameras patched,
   threshold 0: gate stats == the plain gate bitwise, maps within 1e-4 of
   the plain composition and == a cold recompute bitwise) and all-static
   (the gate alone) steps; ``DeadlineGroupFormer`` on group 0's 5 cameras
   -- a full release, a deadline release whose straggler rides the next
   release folded, and reuse mode on a packed-reference cache in capture
   order with a folded straggler -- every released and folded head
   bitwise equal to a cold ``fleet_forward`` of its frames, those within
   1e-4 of the plain composition; one warm step and one former release
   with obs off and on: equal kernel launches, equal
   ``torch.cuda.synchronize`` calls and implicit synchronizations (torch's
   sync debug mode), equal bits, ``kernel_counts()`` equal to the
   dispatch counts, the Chrome trace written to ``build/``; the same
   step and release off and on under the profiler, with equal
   synchronize and memcpy records (a launcher's own runtime calls
   included); then ``run_fleet_online`` over frames 600-1200, analytic
   and simulated (host numbers);
3g. CrossRoI's harnesses on 3e's masks: a 6-step ``make_frame_trace``
   (5 of 20 cameras move a tile a step) moved to the card; ``drive_fleet``
   against an inline ``fleet_reuse_step`` loop (equal dispatch counters
   and profiler synchronize/memcpy records), its kept maps bitwise equal
   to a cold ``superlaunch_forward`` of each step's frames, the last
   within 1e-4 of the plain composition, its step host walls beside the
   drive's wall bounded by one synchronize; ``drive_chaos`` with no
   schedule == ``drive_fleet`` (maps bitwise, counts equal), then a
   scripted freeze, noise and blackout with a liveness monitor, the
   faulted step's gate stats bitwise equal to the plain gate on the
   injected frames; ``run_adaptive_online`` on group 0 (frames 600-800,
   coverage target 0.99) with the activation cache as mask listener: one
   invalidation per re-solve, and the next step, cold on the re-solved
   grids, == a cold recompute bitwise and within 1e-4 of the plain
   composition, with its first-step wall; ``run_point`` at one sweep
   point (dispatches == the drive's, its SLO panel); the sentinel's
   self-test; and in 3f, on its engine, ``drive_serve`` (6 requests at
   4 Hz, one 32-patch stream each);
3h. CrossRoI's sharded runtime on 3e's masks over 3g's trace plus an
   all-static step: ``ShardedSuperlaunch`` at 1, 2 and 4 shards on the
   one card (``make_fleet_mesh(n, devices=[card])``), each step through
   ``sharded_fleet_step`` bitwise equal to ``superlaunch_forward_reuse``
   with one launch of each of B1-B4 (``_build.LAUNCHES``), ``step_full``
   == ``superlaunch_forward``, the cold maps within 1e-4 of the plain
   composition, walls beside the single-device step's;
   ``AsyncShardedPipeline`` at 2 shards with 3 submits before the first
   collect == the synchronous steps, its overlap, consumer wait, p99 and
   profiler synchronize/memcpy records; ``wire_shard_invalidation`` and
   ``rebuild_group`` on a group-0 drift re-solve and ``drive_chaos_sharded``
   with a shard loss (``shard_failover``), each colding one shard while
   the others compute 0 tiles, == a cold recompute; ``drive_sharded`` ==
   ``drive_fleet``; B12 at blocks without an instance of their own (C1)
   against its plain version and the instance's launch;
3f. the serving path at full width, after the fleet's tensors are freed:
   internvl2-26b (48 layers, d_model 6144, 48/8 heads of 128, d_ff
   16384; bf16 weights drawn on the card from a seeded generator) serves
   4 requests, each one frame's fleet patch stream (9,360 tokens, 3,268
   kept by the RoI masks, packed to 9,472) through ``serve`` with 8
   greedy steps; the last kept row's logits against a dense prefill of
   the kept patches alone (the pruned-prompt identity); B12 through its
   entry point on the engine's own layer-0 and last-layer q/k/v, against
   its plain version and the engine's ``blockwise_attention``;
3i. the windowed, local/global and MoE decoders on the serving path,
   after 3f's tensors are freed, each at full width with bf16 weights
   drawn on the card: h2o-danube3-4b (24 layers, a window of 4,096 on
   every layer), gemma3-27b (62 layers, 5:1 local (window 1,024) :
   global, 2 trailing local layers), deepseek-moe-16b (28 layers, 64
   experts top-6, 2 shared, the first layer dense) and
   qwen3-moe-235b-a22b at 4 of its 94 layers (437.9 GiB of bf16 at full
   depth; 128 experts top-8, 4 KV heads).  Each serves 4 requests
   through ``serve`` with 16 greedy steps -- 2 dense prompts past the
   window (4,608 tokens for h2o, 1,536 for gemma3, 1,024 for the MoE
   models) and 2 keep-lists no longer than the window -- with each
   prefill's and decode step's host-clock ms and the peak memory; each
   group decode step's row 0 against request 0 served alone (a B = 1
   prefill and decode fed the same tokens, a MoE model routed as the
   group routed it), within 0.05 of the largest |logit|; the window
   models hold the ring identity (a dense prompt that wraps the ring, 16
   greedy decode steps, each step's logits against a fresh prefill of
   the prompt and the tokens so far, within the same bar); the MoE
   models print the served prefill's dropped share and aux loss per
   layer and hold the same teacher-forced check on the dropless
   ``capacity_factor = E / K`` -- in bf16 on every step with every real
   row of the fresh prefill routed as the decode path routed it (the
   fresh prefill on its own routing printed beside it, with each step's
   count of layers whose routing of the new token flips and the first
   flip's margin and input difference), and on every step with the same
   weights drawn in float32 on their own routing; the phase launches
   none of the kernels;
3j. the recurrent-state families on the serving path, after 3i, each at
   full width with bf16 weights drawn on the card: rwkv6-7b (32 RWKV6
   layers, d_model 4096, 64 heads of 64, d_ff 14336) and zamba2-2.7b (54
   Mamba2 blocks, 80 SSD heads of 64, state 64, a shared attention + MLP
   block of 32 heads of 80 after every 6).  Each serves 4 requests
   through ``serve`` with 16 greedy steps -- dense prompts of 4,096 and
   1,024 tokens and keep-lists of 1,024 of 2,048 and 768 of 1,536, every
   length, kept count and teacher sequence with a power-of-two factor of
   at least 16, so no scan runs one token a chunk -- with each prefill's
   and decode step's host-clock ms and the peak memory, and holds three
   identities within 0.05 of the largest |logit|: (a) each dense row's
   16 decode steps against one teacher prefill of its prompt and the 16
   tokens fed back, read at each step's row; (b) each keep-list's packed
   logits at n_kept - 1 against a dense prefill of the kept tokens alone;
   (c) each group step's row 0 against request 0 served alone -- in bf16
   printed beside a rounding floor (the teacher's rows from a prefill 16
   tokens longer), and with the weights drawn in float32 from the same
   seed held within the bar; ``drive_serve`` (the deadline former, 6
   Poisson requests of 32 tokens); the phase launches none of the
   kernels;
3k. whisper-small's encoder-decoder, after 3j, at full size (12 + 12
   layers, d_model 768, 12 heads of 64, d_ff 3072, vocab 51,865) with
   bf16 weights drawn on the card, then float32 from the same seed: 4
   requests of 1,500 seeded frames through ``prefill`` (the encoder,
   ``cross_kv`` and the decoder timed apart; the online-softmax chunk
   steps counted) and greedy ``decode_step`` on a 4-token prompt with 60
   steps and a 384-token one with 64 (to position 447, the last row of
   ``dec_pos``), each step timed, peak memory; the identities (a) each
   step's logits == one cached-path decoder pass over the prompt and the
   greedy tokens, (b) that pass == the no-cache branch projecting the
   encoder's memory, (c) the batch's row 0 == request 0 served alone,
   held within 1e-3 of the largest |logit| on the float32 pass and
   printed in bf16 beside a rounding floor; in bf16 also a prefill of
   float32 frames (jnp's promotion: float32 encoder and cross K/V); the
   phase launches none of the kernels;
3l. the one-device training step, after 3k: (a) h2o-danube3-4b at full
   width and depth (bf16 weights and float32 AdamW moments drawn on the
   card, ``TrainConfig()`` with remat, ``SyntheticLM`` markov batches of
   2 x 4,096 tokens -- the train_4k cell's global batch of 256 cut) for
   5 steps of ``train_loss`` -> ``torch.autograd.grad`` ->
   ``adamw_update``: each step's loss, grad_norm, lr and host-clock ms,
   the peak memory, the loss and every gradient finite, every weight
   matrix moved; (b) every arch at SMOKE in float32, the card's loss and
   gradients against the port's CPU path within 1e-4 of each leaf's
   largest |g| (or twice the CPU path's own rounding floor), remat on
   == off, ``causal_skip`` == the exhaustive walk (bitwise on the rows
   and the loss) and three AdamW steps == the CPU's, within 1e-6; the
   phase launches none of the kernels;
3m. the training loop, after 3l: (a) h2o-danube3-4b at full width and
   depth through ``train.loop.make_train_step`` with 2 microbatches
   (remat on) on batches of 2 x 4,096 (the train_4k cell's global batch
   of 256 cut), 3 steps without compression and 3 with int8 from the
   same seeded state: loss, grad_norm, lr, host ms, peak memory, and
   the first batch's loss without accumulation beside it; (b) at full
   width and 2 of 24 layers, the data-axis route on a one-rank NCCL
   group for tp, fsdp and dp_only, with and without int8: 3 steps ==
   ``mesh=None`` bitwise (parameters, moments, metrics) under
   deterministic algorithms; (c) the fault drill: ``train()`` 5 steps
   clean twice, then with checkpoints every 2 steps and a fault at step
   3 into a temporary directory under ``build/``: free disk, save
   (snapshot, write) and restore seconds, the checkpoint's bytes,
   restarts == 1, the final state == the clean run's bitwise (under
   deterministic algorithms if two clean runs differ), a reload
   bitwise; (d) h2o-danube3-4b, deepseek-moe-16b and zamba2-2.7b at
   SMOKE in float32: the step's gradients with 2 microbatches and with
   int8 on the card against the CPU (within max(1e-4, twice the CPU's
   rounding floor) of each leaf's largest, plus one quantization step
   under int8), ``quantize_int8`` bitwise; the phase launches none of
   the kernels;
3n. the model axis in training, after 3m: (a) h2o-danube3-4b at full
   width and 2 of 24 layers on a one-rank NCCL group under tp and fsdp,
   without compression and with int8 over 2 microbatches: 3 steps ==
   ``mesh=None`` bitwise under deterministic algorithms, ms a step and
   peak memory; (b) a probe of whether two processes on the one card
   carry the route's collectives over gloo (NCCL refuses two ranks on
   one device): each collective on CUDA tensors, in order, the first
   that fails printed with its error on its own line, and then (b) runs
   no further; where all carry, h2o-danube3-4b and deepseek-moe-16b at
   full width, 2 layers, float32, on a (1, 2) tp mesh of the two
   processes against the one-rank step on the card (rank 0, before):
   the first step's gradients within 1e-5 of each leaf's largest, 3
   steps' losses and grad norms within 1e-5 relative, the leaves
   replicated over the model axis bitwise equal on both ranks, ms a step
   and each rank's peak; a failure inside the route fails the run; the
   phase launches none of the kernels, counted in this process and in
   each rank process;
3o. the model axis in serving, after 3n: (d) h2o-danube3-4b at full
   width, 2 layers, bf16: prefill past the window and a decode step on
   a one-rank NCCL group == ``dist=None`` bitwise; then rank processes
   on the card over gloo (``--serve-rank``), each probing the
   collectives first: (a) on two, h2o-danube3-4b at full width and
   depth in bf16 served by ``ServingEngine`` at tp 2 (phase 3i's four
   prompts, 16 greedy steps; rank 0 first alone as the one-rank
   engine): prefill ms a request, decode ms a step, each rank's peak
   and tokens, both ranks' tokens equal; (b) on the same two,
   h2o-danube3-4b (a window ring), internvl2-26b (the fleet frame's
   patch stream packed by CrossRoI's keep-list) and deepseek-moe-16b
   (the expert-parallel route) at full width, 2 layers, float32:
   prefill and 6 teacher-forced decode steps at tp 2 within 1e-5 of the
   largest |logit| of the one-rank path; (c) on four, h2o-danube3-4b
   and gemma3-27b at SMOKE in float32 at tp 4, where KV heads 2 do not
   divide and the caches split their sequence (flash decoding): the
   same bar, and every rank's engine tokens equal to the one-rank
   engine's; a failed rank fails the run; the phase launches none of
   the kernels, counted in this process and in each rank process;
4. a ``kernels`` JSON line with each kernel's launches on its path (B1-B5
   on the fleet path of phases 3 and 3b, B10 and B11 on the rate-control
   loop, B6-B9 on phase 3d's paths, B12 on the engine's tensors in 3f),
   each path driven with the counts set to 0; phase 3e's path is driven
   the same way and must launch B1-B5, phases 3g's and 3h's B1-B4 (3h's
   launches are each row's ``launches_sharded``).

The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device,
or without the ``src/repro_torch`` package beside this file, it exits
non-zero and prints no result.
"""
import contextlib
import dataclasses
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

SEED = 0
TILE = 16
LEG_HW, CENTER_HW = (1080, 1920), (960, 1280)
GROUPS, CAMS = 4, 5
MASK_DENSITY = 0.35            # offline 64-px grid, expanded x4 to tiles
PATCH = 64
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
F32_FLOP_PER_S = 67e12         # float32 outside the tensor cores
BF16_FLOP_PER_S = 989e12       # bfloat16 on the tensor cores, dense
CONV_TOL = 1e-4
# B12 against its plain version on real rows, as tests/test_kernels.py
# holds the JAX kernel: f32 2e-5, bf16 0.05 (one bf16 step at |x| ~ 4-8)
ATTN_TOL = {"float32": 2e-5, "bfloat16": 0.05}
# ... and per element relative to the value it is held against, since on
# the serving slice most |out| are under 0.05: |got - want| <= 2^-7 |want|
# + 1e-3, one to two bf16 steps of |want| (both sides round one f32 value
# to bf16) plus room for f32 sums over thousands of keys
ATTN_REL, ATTN_ABS = 2.0 ** -7, 1e-3
# the pruned-prompt identity at full width, relative to the largest |logit|:
# both sides round the residual stream to bf16 at every layer, through 48
# layers with other KV chunks (4 rows for the 3,268-token prompt, 256 for
# the 9,472-row packed one); the first H100 run gave 0.0208 of a 3.95
# scale (5 bf16 steps), so the bar is 0.05
PRUNED_REL_TOL = 0.05
# the serving phase: internvl2-26b at full width, 4 fleet requests of one
# frame each (one patch token per offline 64-px cell of the 20 cameras)
ARCH = "internvl2-26b"
N_REQUESTS = 4
DECODE_STEPS = 8
SLICE_HEADS, SLICE_HEAD_DIM = 48, 128      # internvl2-26b's attention
# phase 3g's serve leg on the same engine: Poisson arrivals
SERVE_RATE_HZ, SERVE_REQUESTS, SERVE_PROMPT, SERVE_DEADLINE = 4.0, 6, 32, 0.5
PADDED_HEAD_DIM = 120          # h2o-danube3-4b's: the kernel pads it to 128
# B3's layer-by-layer route on the fleet: 9 layers (8 -> 16, then 16 -> 16
# eight times), past the ring route's depth of 8
DEEP_CHANNELS = (8,) + (16,) * 9
# the fleet's stream: 4 x (4 legs of 17 x 30 cells + one of 15 x 20) =
# 9,360 tokens, packed to 74 blocks of 128; the masks keep 52,288 / 16 =
# 3,268, so 26 q-blocks hold real rows and visit 26 * 27 / 2 block pairs
FLEET_KEPT, FLEET_PACKED, FLEET_PAIRS = 3268, 9472, 351

CSRC = "src/repro_torch/kernels/csrc/"
GATE_CU = CSRC + "tile_delta_gate.cu"
DELTA_CU = CSRC + "tile_delta.cu"
ENTRY_CU = CSRC + "roi_conv_entry.cu"
SBNET_CU = CSRC + "sbnet.cu"
KERNELS = {
    "tile_delta_gate_canvas": (GATE_CU, "src/repro/kernels/tile_delta.py:280"),
    "tile_delta_gate": (GATE_CU, "src/repro/kernels/tile_delta.py:198"),
    "tile_delta": (DELTA_CU, "src/repro/kernels/tile_delta.py:94"),
    "tile_delta_halo": (DELTA_CU, "src/repro/kernels/tile_delta.py:361"),
    "roi_conv_entry": (ENTRY_CU, "src/repro/kernels/roi_conv.py:283"),
    "roi_conv_stack": (CSRC + "roi_conv_stack.cu",
                       "src/repro/kernels/roi_conv.py:435"),
    "sbnet_scatter_fleet": (SBNET_CU, "src/repro/kernels/sbnet.py:109"),
    "roi_conv_packed": (CSRC + "roi_conv_stack.cu",
                        "src/repro/kernels/roi_conv.py:519"),
    "roi_conv_fleet": (ENTRY_CU, "src/repro/kernels/roi_conv.py:160"),
    "roi_conv": (ENTRY_CU, "src/repro/kernels/roi_conv.py:68"),
    "sbnet_gather": (SBNET_CU, "src/repro/kernels/sbnet.py:35"),
    "sbnet_scatter": (SBNET_CU, "src/repro/kernels/sbnet.py:58"),
    "roi_attention": (CSRC + "roi_attention.cu",
                      "src/repro/kernels/roi_attention.py:99"),
}


def say(*parts):
    print(*parts, flush=True)


def time_ms(torch, fn, reps=7):
    """Median CUDA-event time of ``fn`` over ``reps`` runs, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def nvidia_smi():
    """The card's name and power limit, one line per card, as
    ``nvidia-smi`` prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()


def demangle(names):
    """The kernels' C++ names through ``c++filt`` where it is installed,
    without the anonymous namespace; else as the compiler mangled them."""
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True, timeout=60)
        plain = out.stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        return names
    if out.returncode or len(plain) != len(names):
        return names
    return [n.replace("(anonymous namespace)::", "").split("(")[0]
            for n in plain]


def rate_line(name, flops, ms, b_ms, what):
    """Achieved TFLOP/s and the share of the bound for one timed kernel."""
    say(f"[kernels] {name}: {flops / ms / 1e9:.2f} TFLOP/s of {what}; "
        f"{b_ms / ms:.4f} of the bound ({b_ms:.4f} ms in {ms:.4f} ms)")


def device_ms(torch, fn, kernel, reps=7, launches=1):
    """The device time per call of the kernels named ``kernel`` that ``fn``
    launches (``launches`` of them a call): the profiler's CUDA time over
    ``reps`` calls, after a warm-up.  Unlike ``time_ms`` it leaves out the
    host's time between launches, which bounds a short kernel's event
    time.  The reading counts the profiler's records of the kernel: with
    fewer than ``launches * reps`` it missed some, and the reading is
    invalid (None), not a time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages() if kernel in e.key]
    records = sum(e.count for e in hits)
    if records < launches * reps:
        say(f"[kernels] device time of {kernel}: invalid, {records} kernel "
            f"records of {launches * reps}")
        return None
    return sum(e.device_time_total for e in hits) / reps / 1e3


def byte_line(torch, name, fn, nbytes, r, kernel="roi_conv_entry_kernel",
              launches=1):
    """Achieved GB/s and the share of the bound for one timed byte-bound
    kernel (the entry family's, or the one named ``kernel``), by event time
    and by device time (kept in ``r`` as ``device_ms``; None for an invalid
    reading)."""
    r["device_ms"] = dev = device_ms(torch, fn, kernel, launches=launches)
    ms, b_ms = r["ms"], r["bound_ms"]
    line = (f"[kernels] {name}: {nbytes / ms / 1e6:.1f} GB/s of the bytes it "
            f"must move; {b_ms / ms:.4f} of the bound ({b_ms:.4f} ms in "
            f"{ms:.4f} ms); ")
    say(line + ("device time invalid" if dev is None else
                f"device time {dev:.4f} ms: {nbytes / dev / 1e6:.1f} GB/s, "
                f"{b_ms / dev:.4f} of the bound"))


def entry_route(lib, x, w, t):
    """The instance of the entry kernel that runs on frames ``x`` with
    weights ``w``: the route function's answer, checked against the
    library's own choice."""
    from repro_torch.kernels import roi_conv
    Cin, Cout, W = x.shape[-1], w.shape[-1], x.shape[-2]
    route = roi_conv.entry_route(Cin, Cout, t, t, W, x.data_ptr())
    assert lib.roi_conv_entry_route(Cin, Cout, t, t, W, x.data_ptr()) == \
        (route == "detector"), "the launcher and entry_route disagree"
    return route


def misaligned(torch, t):
    """A copy of ``t`` whose data start 4 bytes past a 16-byte boundary:
    the entry kernel's and the gate kernel's generic instances run on it."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    return view


def gate_route(lib, name, cur_p, rw, th, tw=None):
    """The instance of the gate kernel that runs ``name`` on frames
    ``cur_p`` against the reference ``rw``: the route function's answer,
    checked against the library's own choice (B5's windows output is the
    wrapper's own allocation, on a 256-byte boundary)."""
    from repro_torch.kernels import tile_delta
    tw = th if tw is None else tw
    Cin, Wp = cur_p.shape[-1], cur_p.shape[-2]
    route = tile_delta.gate_route(Cin, th, tw, Wp, cur_p.data_ptr(),
                                  rw.data_ptr())
    assert lib.tile_delta_gate_route(Cin, th, tw, Wp, cur_p.data_ptr(),
                                     rw.data_ptr(), None) == \
        (route == "detector"), f"{name}: the launcher and gate_route disagree"
    return route


def delta_route(lib, cur, prev, th, tw):
    """The instance of B10's and B11's kernels that runs on the (H, W, C)
    frames ``cur`` and ``prev``: the route function's answer, checked
    against the library's own choice."""
    from repro_torch.kernels import tile_delta
    C, W = cur.shape[-1], cur.shape[-2]
    route = tile_delta.delta_route(C, th, tw, W, cur.data_ptr(),
                                   prev.data_ptr())
    assert lib.tile_delta_route(C, th, tw, W, cur.data_ptr(),
                                prev.data_ptr()) == (route == "detector"), \
        "the launcher and delta_route disagree"
    return route


def gate_rows(out, rows=None):
    """A gate's outputs as a tuple (its stats, and B5's windows), each cut
    to ``rows`` where given."""
    out = out if isinstance(out, tuple) else (out,)
    return tuple(o if rows is None else o[rows] for o in out)


def gate_equal(torch, got, want):
    """Two gate outputs equal bit for bit (windows holding NaNs too)."""
    return all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(gate_rows(got), gate_rows(want)))


def bound(nbytes, flops, flop_rate=F32_FLOP_PER_S):
    """(least time in ms, what bounds it) for this work on the card."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / flop_rate * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


# ---------------------------------------------------------------------------
# the fleet: masks, frames, detector
# ---------------------------------------------------------------------------

def fleet_grids(rng):
    """The fleet's tile masks: per camera a coarse 64-px grid of density
    ``MASK_DENSITY`` drawn from ``rng``, expanded x4 to 16-px tiles."""
    grids = {}
    for g in range(GROUPS):
        grids[g] = []
        for c in range(CAMS):
            h, w = CENTER_HW if c == CAMS - 1 else LEG_HW
            coarse = rng.random((-(-h // 64), -(-w // 64))) < MASK_DENSITY
            grids[g].append(np.kron(coarse, np.ones((4, 4), bool)))
    return grids


def build_fleet(torch, dev):
    rng = np.random.default_rng(SEED)
    grids = fleet_grids(rng)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    frames = {g: [torch.randn((*(CENTER_HW if c == CAMS - 1 else LEG_HW), 3),
                              generator=gen, device=dev)
                  for c in range(CAMS)] for g in range(GROUPS)}
    return rng, gen, grids, frames


def build_detector(dev):
    """The default detector with weights from a seeded numpy generator."""
    from repro_torch.serving.detector import DetectorConfig, RoIDetector
    prng = np.random.default_rng(SEED + 1)
    cfg = DetectorConfig()
    chans = (3,) + tuple(cfg.channels)
    weights = [prng.normal(size=(3, 3, ci, co)) / np.sqrt(9 * ci)
               for ci, co in zip(chans[:-1], chans[1:])]
    head = prng.normal(size=(chans[-1], cfg.num_anchors * 5)) \
        / np.sqrt(chans[-1])
    return RoIDetector.from_numpy(cfg, weights, head, device=dev)


def with_patches(torch, frames, grids, rng, gen, amplitude,
                 interior=False):
    """The next frames: 5 of the cameras with an active tile (all 20 on
    the random masks) get one fresh 64x64 patch at a random active tile
    (about one vehicle); ``amplitude`` lifts it above the gate's
    quantizer step for the lossy steps.  ``interior`` places the
    patch on the tile grid and keeps each covered tile's 2-pixel rim as it
    was: the motion stays inside tile interiors, where the canvas and
    packed reference modes agree at every threshold."""
    flat = [(g, c) for g in frames for c in range(len(frames[g]))
            if grids[g][c].any()]
    nxt = {g: list(fs) for g, fs in frames.items()}
    for k in rng.choice(len(flat), size=min(5, len(flat)), replace=False):
        g, c = flat[k]
        f = frames[g][c].clone()
        ys, xs = np.nonzero(grids[g][c])
        j = int(rng.integers(len(ys)))
        hi_y, hi_x = f.shape[0] - PATCH, f.shape[1] - PATCH
        if interior:
            hi_y, hi_x = hi_y // TILE * TILE, hi_x // TILE * TILE
        y0 = min(int(ys[j]) * TILE, hi_y)
        x0 = min(int(xs[j]) * TILE, hi_x)
        patch = amplitude + torch.randn((PATCH, PATCH, 3), generator=gen,
                                        device=f.device)
        region = f[y0:y0 + PATCH, x0:x0 + PATCH]
        if interior:
            lane = torch.arange(PATCH, device=f.device) % TILE
            keep = (lane >= 2) & (lane < TILE - 2)
            patch = torch.where((keep[:, None] & keep[None, :])[..., None],
                                patch, region)
        region.copy_(patch)
        nxt[g][c] = f
    return nxt


def flat(d):
    return [x for g in d for x in d[g]]


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version, at the main path's shapes
# ---------------------------------------------------------------------------

# the gate's hard cases: (th, tw, Cin) -- a 16x16 window row at Cin 5 is 90
# floats, two of the kernel's 64-element chunks; 8x7 rows are odd -- and
# the quantizer steps
GATE_CASES = [(th, tw, cin) for th, tw in ((8, 8), (16, 16), (8, 7))
              for cin in (3, 5)]
GATE_QSTEPS = (1.0, 8.0, 13.0)


def gate_content(rng, shape, kind):
    """(prev, cur) zero-padded (C, H+2, W+2, Cin) planes for the gate's hard
    cases.  "ties": values on a 0.5 grid, 30% moved by multiples of 0.5
    (deltas on rounding ties at every step of ``GATE_QSTEPS``), a -0.0
    over a 0.0 in each camera's first row, and NaNs in cur, in prev and in
    both at the same places.  "changed": every element, the padding too,
    moved by 16 to 32, so no body holds a zero run."""
    C, Hp, Wp, Cin = shape
    if kind == "changed":
        prev = rng.normal(size=shape).astype(np.float32)
        return prev, prev + rng.uniform(16, 32, shape).astype(np.float32)
    inner = (C, Hp - 2, Wp - 2, Cin)
    prev = (rng.integers(-40, 40, inner) * 0.5).astype(np.float32)
    cur = prev.copy()
    moved = rng.random(inner) < 0.3
    cur[moved] += (rng.integers(-60, 60, moved.sum()) * 0.5) \
        .astype(np.float32)
    cur[:, 0, :3, :] = -0.0
    prev[:, 0, :3, :] = 0.0
    spots = rng.choice(cur.size, 12, replace=False)
    cur.reshape(-1)[spots[:8]] = np.nan
    prev.reshape(-1)[spots[4:]] = np.nan
    pad = ((0, 0), (1, 1), (1, 1), (0, 0))
    return np.pad(prev, pad), np.pad(cur, pad)


def gate_hard_cases(torch, dev):
    """B1 and B5 (stats and windows) bitwise against their plain versions on
    small fleets of ``gate_content`` at each of ``GATE_CASES`` and
    ``GATE_QSTEPS``; B5's stats == B1's on the same reference; where the
    detector's instance runs, the generic one (8-byte-misaligned copies)
    gives the same bits."""
    from repro_torch.kernels import _build, ops, ref, tile_delta
    lib = _build.library()
    rng = np.random.default_rng(SEED + 11)
    shapes = ((4, 5), (3, 4), (5, 3))           # per-camera tile grids
    seen = {"detector": 0, "generic": 0}
    for kind in ("ties", "changed"):
        for th, tw, cin in GATE_CASES:
            grids = [rng.random(s) < 0.55 for s in shapes]
            for g in grids:
                g[1, 1] = True
            idx = torch.as_tensor(ops.fleet_indices(grids)[0], device=dev)
            shape = (len(shapes), max(s[0] for s in shapes) * th + 2,
                     max(s[1] for s in shapes) * tw + 2, cin)
            prev_p, cur_p = (torch.as_tensor(a, device=dev)
                             for a in gate_content(rng, shape, kind))
            ref_win = ref.gather_windows(prev_p, idx, th, tw)
            inputs = [(cur_p, prev_p, ref_win)]
            if gate_route(lib, "gate", cur_p, prev_p, th, tw) == "detector":
                inputs.append(tuple(misaligned(torch, a) for a in inputs[0]))
            for c, p, w in inputs:
                seen[gate_route(lib, "gate", c, p, th, tw)] += 1
                assert gate_route(lib, "gate", c, w, th, tw) == \
                    gate_route(lib, "gate", c, p, th, tw)
            for q in GATE_QSTEPS:
                want1 = ref.tile_delta_gate_canvas(cur_p, prev_p, idx, th,
                                                   tw, q)
                want5 = ref.tile_delta_gate(cur_p, ref_win, idx, th, tw, q)
                for c, p, w in inputs:
                    got1 = tile_delta.tile_delta_gate_canvas(c, p, idx, th,
                                                             tw, q)
                    got5 = tile_delta.tile_delta_gate(c, w, idx, th, tw, q)
                    assert gate_equal(torch, got1, want1) and gate_equal(
                        torch, got5, want5) and torch.equal(got5[0], got1), \
                        f"the gate on {kind} content at {th}x{tw}, Cin " \
                        f"{cin}, qstep {q}"
    say(f"[kernels] B1 and B5 on hard content (0.5-grid ties with -0.0 "
        f"over 0.0 and NaNs; every element changed) at (th, tw, Cin) "
        f"{GATE_CASES}, qstep {GATE_QSTEPS}: bitwise == their plain "
        f"versions and B5 == B1, on {seen['detector']} content(s) through "
        f"the detector's instance and {seen['generic']} through the generic "
        f"one")


# B10's and B11's hard cases: (th, tw, C) -- scan rows of 24 floats (a
# partial 32-lane chunk), 40, 48 (the detector's), 80 and 72 (two of the
# kernels' 64-element chunks) and 21 (odd), a 40-pixel column strip (two
# 32-pixel chunks) -- and one tile a kernel past the 48 KB of quantized
# deltas the kernels once kept in shared memory: B10 at 80x80x3 (19,200),
# B11 in the ring of 1088x1024x3 (12,672) on a 1088x1920 frame
DELTA_CASES = [(8, 8, 3), (8, 8, 5), (16, 16, 3), (16, 16, 5), (8, 7, 3),
               (16, 24, 3), (40, 8, 3)]
DELTA_PAST_CAP = (("tile_delta", 80, 80, (160, 240)),
                  ("tile_delta_halo", 1088, 1024, (1088, 1920)))


def delta_content(rng, shape, kind):
    """(prev, cur) (H, W, C) frames for B10's and B11's hard cases.
    "ties": values on a 0.5 grid, 30% moved by multiples of 0.5, a -0.0
    over a 0.0 in the first row.  "saturate": the same with NaN, +-Inf and
    +-3e10 deltas (both frames infinite at some places), whose quotients
    the quantizer's cast saturates at every step of ``GATE_QSTEPS``.
    "changed": every element moved by 16 to 32, so no row holds a zero
    run."""
    if kind == "changed":
        prev = rng.normal(size=shape).astype(np.float32)
        return prev, prev + rng.uniform(16, 32, shape).astype(np.float32)
    prev = (rng.integers(-40, 40, shape) * 0.5).astype(np.float32)
    cur = prev.copy()
    moved = rng.random(shape) < 0.3
    cur[moved] += (rng.integers(-60, 60, moved.sum()) * 0.5) \
        .astype(np.float32)
    cur[0, :3, :] = -0.0
    prev[0, :3, :] = 0.0
    if kind == "saturate":
        spots = rng.choice(cur.size, 40, replace=False)
        for k, v in enumerate((np.nan, np.inf, -np.inf, 3e10, -3e10)):
            cur.reshape(-1)[spots[8 * k:8 * k + 6]] = v
            prev.reshape(-1)[spots[8 * k + 4:8 * k + 8]] = v
    return prev, cur


def delta_hard_cases(torch, dev):
    """B10 and B11 bitwise against their plain versions on the card, which
    equal the plain versions on the CPU (both saturate the quantizer's
    cast), on frames of ``delta_content`` at each of ``DELTA_CASES`` and
    ``GATE_QSTEPS``; where the detector's instance runs, the generic one
    (8-byte-misaligned copies) gives the same bits; then the tiles of
    ``DELTA_PAST_CAP``."""
    from repro_torch.kernels import _build, ops, ref, tile_delta
    lib = _build.library()
    rng = np.random.default_rng(SEED + 12)
    names = ("tile_delta", "tile_delta_halo")
    seen = {"detector": 0, "generic": 0}
    for kind in ("ties", "saturate", "changed"):
        for th, tw, cin in DELTA_CASES:
            grid = rng.random((5, 6)) < 0.6
            grid[0, 0] = grid[-1, -1] = True
            rows = torch.as_tensor(ops.mask_to_indices(grid))
            pair = delta_content(rng, (5 * th, 6 * tw, cin), kind)
            prev, cur = (torch.as_tensor(a) for a in pair)
            inputs = [(cur.to(dev), prev.to(dev))]
            if delta_route(lib, *inputs[0], th, tw) == "detector":
                inputs.append(tuple(misaligned(torch, a) for a in inputs[0]))
            for c, p in inputs:
                seen[delta_route(lib, c, p, th, tw)] += 1
            for q in GATE_QSTEPS:
                for name in names:
                    plain, kfn = getattr(ref, name), getattr(tile_delta, name)
                    want = plain(*inputs[0], rows.to(dev), th, tw, q)
                    same = torch.equal(want.cpu(),
                                       plain(cur, prev, rows, th, tw, q))
                    for c, p in inputs:
                        same = same and torch.equal(
                            kfn(c, p, rows.to(dev), th, tw, q), want)
                    assert same, f"{name} on {kind} content at {th}x{tw}, " \
                                 f"C {cin}, qstep {q}"
    for name, th, tw, frame in DELTA_PAST_CAP:
        prev, cur = (torch.as_tensor(a, device=dev) for a in delta_content(
            rng, frame + (3,), "ties"))
        rows = torch.as_tensor(np.ascontiguousarray(np.argwhere(np.ones(
            (frame[0] // th, frame[1] // tw), bool)), dtype=np.int32),
            device=dev)
        for q in GATE_QSTEPS:
            assert torch.equal(
                getattr(tile_delta, name)(cur, prev, rows, th, tw, q),
                getattr(ref, name)(cur, prev, rows, th, tw, q)), \
                f"{name} at {th}x{tw}, qstep {q}"
    say(f"[kernels] B10 and B11 on hard content (0.5-grid ties with -0.0 "
        f"over 0.0; NaN, +-Inf and +-3e10 deltas; every element changed) at "
        f"(th, tw, C) {DELTA_CASES}, qstep {GATE_QSTEPS}: bitwise == their "
        f"plain versions on the card == the plain versions on the CPU, on "
        f"{seen['detector']} content(s) through the detector's instance and "
        f"{seen['generic']} through the generic one; past the old 48 KB cap "
        f"({', '.join(f'{n} {a}x{b}x3' for n, a, b, _ in DELTA_PAST_CAP)}): "
        f"bitwise == the plain versions")


def ring_sectors(torch, W, C, rows, t):
    """The distinct 32-byte sectors of one (H, W, C) float32 frame that the
    edge rings of the t x t tiles ``rows`` touch."""
    ty, tx = (rows[:, i:i + 1].long() * t for i in (0, 1))
    k = torch.arange(t, device=rows.device)
    ys = torch.cat([ty + 0 * k, ty + t - 1 + 0 * k, ty + k, ty + k], 1)
    xs = torch.cat([tx + k, tx + k, tx + 0 * k, tx + t - 1 + 0 * k], 1)
    first = (ys * W + xs) * C * 4
    return int(torch.cat([first // 32, (first + C * 4 - 1) // 32])
               .unique().numel())


def check_kernels(torch, det, frames, frames_next, grids):
    from repro_torch.kernels import _build, ops, ref, roi_conv, sbnet, \
        tile_delta
    from repro_torch.net.encoder import pad_to_grid
    from repro_torch.serving.detector import _head_rows

    dev = det.device
    t = TILE
    _, _, idx, nbr = det._fleet_tables(flat(grids))
    n = idx.shape[0]
    x, _, _ = det._stack_frames(flat(frames), flat(grids))
    xn, _, _ = det._stack_frames(flat(frames_next), flat(grids))
    pad = (0, 0, 1, 1, 1, 1)
    ref_c = torch.nn.functional.pad(x, pad)
    cur_p = torch.nn.functional.pad(xn, pad)
    # the distinct pixels the active tiles' haloed windows cover
    cover = torch.zeros(cur_p.shape[:3], dtype=torch.bool, device=dev)
    cover[ref.tile_index(idx, t, t, t + 2, t + 2)] = True
    win_px_padded = int(cover.sum())
    win_px_frame = int(cover[:, 1:-1, 1:-1].sum())
    w0, ws = det.weights[0], det.weights[1:]
    chans = [w0.shape[-1]] + [w.shape[-1] for w in ws]
    A = det.head.shape[-1]
    results = {}

    def record(name, err, ok, k_fn, p_fn, nbytes, flops, lib_fn=None,
               check=""):
        ms = time_ms(torch, k_fn)
        plain_ms = time_ms(torch, p_fn, reps=5)
        lib_ms = time_ms(torch, lib_fn) if lib_fn is not None else None
        b_ms, b_by = bound(nbytes, flops)
        results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                             check=check)
        say(f"[kernels] {name}: {check} max_abs_err={err} ok={ok} "
            f"ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} "
            f"({b_by}) library_ms={lib_ms} n={n}")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version")

    # B1 and B5: the gate, bit-exact on the fleet's content and on content
    # where every element changed (no zero run in any body), on the
    # detector's instance; the generic instance (tensors off an 8-byte
    # boundary), a compact launch on an eighth of the rows and, for B5, B1
    # on the same reference give its bits
    lib = _build.library()
    sub = torch.as_tensor(np.sort(np.random.default_rng(SEED + 8).choice(
        n, n // 8, replace=False)), device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    ref_d = cur_p + 16.0 + 16.0 * torch.rand(cur_p.shape, generator=gen,
                                             device=dev)
    win_bytes = n * (t + 2) ** 2 * 3 * 4
    flops = 3 * 2 * n * (t + 2) ** 2 * 3
    gate_bytes = {"tile_delta_gate_canvas":
                  2 * win_px_padded * 3 * 4 + n * (3 + 8) * 4,
                  "tile_delta_gate":
                  win_px_padded * 3 * 4 + 2 * win_bytes + n * (3 + 8) * 4}
    for content, canvas in (("fleet", ref_c), ("every element changed",
                                               ref_d)):
        packed = ref.gather_windows(canvas, idx, t, t)
        b1 = None
        for name, rw in (("tile_delta_gate_canvas", canvas),
                         ("tile_delta_gate", packed)):
            kfn = getattr(tile_delta, name)
            pfn = getattr(ref, name)
            got = kfn(cur_p, rw, idx, t, t)
            want = pfn(cur_p, rw, idx, t, t)
            torch.cuda.synchronize()
            stats = got[0] if name == "tile_delta_gate" else got
            if content != "fleet":
                assert int(stats[:, ops.GATE_WIN_EXACT].min()) == \
                    (t + 2) ** 2 * 3 and int(
                        stats[:, ops.GATE_BODY_RUNS].max()) == 0
            cm, rm = misaligned(torch, cur_p), misaligned(torch, rw)
            route = gate_route(lib, name, cur_p, rw, t)
            assert route == "detector", f"the fleet's gate takes {route}"
            assert gate_route(lib, name, cm, rm, t) == "generic"
            rs = rw[sub] if name == "tile_delta_gate" else rw
            part = kfn(cur_p, rs, idx[sub].contiguous(), t, t)
            same = {"plain": gate_equal(torch, got, want),
                    "generic": gate_equal(torch, kfn(cm, rm, idx, t, t),
                                          got),
                    "compact": gate_equal(torch, part, gate_rows(got, sub)),
                    "B1": b1 is None or torch.equal(stats, b1)}
            err = max(float((a - b).abs().max()) for a, b in
                      zip(gate_rows(got), gate_rows(want)))
            b1 = stats
            generic_ms = time_ms(torch, lambda: kfn(cm, rm, idx, t, t))
            del cm, rm, rs, part, want, got
            say(f"[kernels] {name} on {n} tiles, {content}: route {route}; "
                f"bitwise == its plain version, the generic route, a "
                f"compact launch of {n // 8} rows (and B5 == B1): {same}; "
                f"the generic route (4-byte loads, runtime extents) takes "
                f"{generic_ms:.4f} ms")
            assert all(same.values()), f"{name}, {content}: {same}"

            def k_fn(kfn=kfn, rw=rw):
                return kfn(cur_p, rw, idx, t, t)

            if content == "fleet":
                if name == "tile_delta_gate_canvas":
                    g_k = stats
                record(name, err, True, k_fn,
                       lambda pfn=pfn, rw=rw: pfn(cur_p, rw, idx, t, t),
                       gate_bytes[name], flops,
                       check=("bit-exact (stats, windows; stats == B1's)"
                              if name == "tile_delta_gate" else "bit-exact")
                       + "; route detector; == generic route and compact "
                         "launch bitwise; all-changed content bit-exact")
                r = results[name]
            else:
                r = dict(ms=time_ms(torch, k_fn),
                         bound_ms=results[name]["bound_ms"])
            byte_line(torch, f"{name} ({content})", k_fn, gate_bytes[name],
                      r, "tile_delta_gate_kernel")
            if content == "fleet":
                r["generic_ms"] = generic_ms
            else:
                results[name].update(all_changed_ms=r["ms"],
                                     all_changed_device_ms=r["device_ms"])
        del packed, b1, stats
    del ref_d, ref_c
    gate_hard_cases(torch, dev)

    # B10, B11: each camera's frame pair, padded to its grid's extent, on
    # the detector's instance: bitwise == the plain versions, == the
    # generic instance (copies 4 bytes off an 8-byte boundary), and on
    # content where every element changed; B10's rows are B1's body
    # columns on the camera's tiles.  Times by events and by device time,
    # each beside a launch of one tile a camera (the per-launch floor)
    pairs, changed, shifted = [], [], []
    for c, (fc, fp, gr) in enumerate(zip(flat(frames_next), flat(frames),
                                         flat(grids))):
        a, b = pad_to_grid(fc, fp, gr.shape, t)
        rows = torch.as_tensor(ops.mask_to_indices(gr), device=dev)
        pairs.append((a, b, rows))
        changed.append((a, a + 16.0 + 16.0 * torch.rand(
            a.shape, generator=gen, device=dev), rows))
        shifted.append((misaligned(torch, a), misaligned(torch, b), rows))
    ones = [(a, b, rows[:1]) for a, b, rows in pairs]
    cam = idx[:, 0]
    stats_kernel = "tile_delta_stats_kernel"

    def per_camera(fn, sets=pairs):
        return [fn(a, b, rows, t, t) for a, b, rows in sets]

    def equal(x, y):
        return all(torch.equal(a, b) for a, b in zip(x, y))

    routes = {delta_route(lib, a, b, t, t) for a, b, _ in pairs}
    assert routes == {"detector"}, f"the cameras take {routes}"
    assert {delta_route(lib, a, b, t, t) for a, b, _ in shifted} == \
        {"generic"}
    for name, px in (("tile_delta", t * t), ("tile_delta_halo", 4 * t - 4)):
        kfn, pfn = getattr(tile_delta, name), getattr(ref, name)
        got, want = per_camera(kfn), per_camera(pfn)
        torch.cuda.synchronize()
        same = {"plain": equal(got, want),
                "generic": equal(per_camera(kfn, shifted), got),
                "changed": equal(per_camera(kfn, changed),
                                 per_camera(pfn, changed))}
        if name == "tile_delta":
            same["B1"] = all(torch.equal(a[:, :4], g_k[cam == c, :4])
                             for c, a in enumerate(got))
        nbytes = n * (2 * px * 3 * 4 + (2 + 8) * 4)
        record(name, max(float((a - b).abs().max()) for a, b in
                         zip(got, want) if a.numel()), all(same.values()),
               lambda: per_camera(kfn), lambda: per_camera(pfn), nbytes,
               3 * n * (t * t if name == "tile_delta" else 4 * t) * 3,
               check=f"bit-exact, {len(pairs)} cameras; route detector; == "
                     f"generic route, all-changed content bit-exact"
                     + (", == B1's body columns" if name == "tile_delta"
                        else "") + f": {same}")
        r = results[name]
        byte_line(torch, name, lambda: per_camera(kfn), nbytes, r,
                  stats_kernel, launches=len(pairs))
        r["one_tile_ms"] = time_ms(torch, lambda: per_camera(kfn, ones))
        r["one_tile_device_ms"] = device_ms(
            torch, lambda: per_camera(kfn, ones), stats_kernel,
            launches=len(pairs))
        r["generic_ms"] = time_ms(torch, lambda: per_camera(kfn, shifted))
        r["generic_device_ms"] = device_ms(
            torch, lambda: per_camera(kfn, shifted), stats_kernel,
            launches=len(pairs))
        say(f"[kernels] {name}: one tile a camera (the per-launch floor) "
            f"{r['one_tile_ms']:.4f} ms by events, device time "
            f"{r['one_tile_device_ms']} ms; the generic route "
            f"(4-byte loads, runtime extents) {r['generic_ms']:.4f} ms by "
            f"events, device time {r['generic_device_ms']} ms")
        if name == "tile_delta_halo":
            sectors = sum(ring_sectors(torch, a.shape[1], 3, rows, t)
                          for a, _, rows in pairs)
            r["sector_bound_ms"] = b_sec = bound(
                2 * 32 * sectors + n * (2 + 8) * 4, 0)[0]
            dev_ms = r["device_ms"]
            share = 32 * sectors / (n * px * 3 * 4)
            say(f"[kernels] tile_delta_halo: the rings touch {sectors} "
                f"32-byte sectors of the {len(pairs)} frames ({share:.3f}x "
                f"the bytes the bound counts): a bound of {b_sec:.4f} ms "
                f"at that grain, " + ("device time invalid" if dev_ms is None
                                      else f"{b_sec / dev_ms:.4f} of the "
                                           f"device time"))
    del pairs, changed, shifted, ones, g_k
    delta_hard_cases(torch, dev)

    # B2: the entry conv, within CONV_TOL, on the detector's instance;
    # the generic instance (frames off a 16-byte boundary) gives its bits,
    # and so does a compact launch on an eighth of the rows (the warm
    # step's identity)
    route = entry_route(lib, x, w0, t)
    assert route == "detector", f"the fleet's entry takes the {route} route"
    e_k = roi_conv.roi_conv_entry(x, w0, idx, t, t)
    e_p = ref.roi_conv_entry(x, w0, idx, t, t)
    err = float((e_k - e_p).abs().max())
    xm = misaligned(torch, x)
    assert entry_route(lib, xm, w0, t) == "generic"
    generic = torch.equal(roi_conv.roi_conv_entry(xm, w0, idx, t, t), e_k)
    del xm
    compact = torch.equal(
        roi_conv.roi_conv_entry(x, w0, idx[sub].contiguous(), t, t),
        e_k[sub])
    say(f"[kernels] roi_conv_entry on {n} tiles: route {route}; == the "
        f"generic route bitwise: {generic}; a compact launch of {n // 8} "
        f"rows == the full launch's rows bitwise: {compact}")
    assert generic and compact
    entry_bytes = (win_px_frame * 3 * 4 + w0.numel() * 4 + n * 3 * 4
                   + n * t * t * chans[0] * 4)
    record("roi_conv_entry", err, err <= CONV_TOL,
           lambda: roi_conv.roi_conv_entry(x, w0, idx, t, t),
           lambda: ref.roi_conv_entry(x, w0, idx, t, t), entry_bytes,
           2 * 9 * 3 * chans[0] * t * t * n,
           check=f"atol {CONV_TOL}; route {route}; == generic route and "
                 f"compact launch bitwise")
    byte_line(torch, "roi_conv_entry",
              lambda: roi_conv.roi_conv_entry(x, w0, idx, t, t), entry_bytes,
              results["roi_conv_entry"])

    # B7: the entry without ReLU, within CONV_TOL; its ReLU is B2's bits
    f_k = roi_conv.roi_conv_fleet(x, w0, idx, t, t)
    f_p = ref.roi_conv_fleet(x, w0, idx, t, t)
    err = float((f_k - f_p).abs().max())
    same = torch.equal(torch.relu(f_k), e_k)
    del e_k, f_p
    record("roi_conv_fleet", err, err <= CONV_TOL and same,
           lambda: roi_conv.roi_conv_fleet(x, w0, idx, t, t),
           lambda: ref.roi_conv_fleet(x, w0, idx, t, t), entry_bytes,
           2 * 9 * 3 * chans[0] * t * t * n,
           check=f"atol {CONV_TOL}; route {route}; ReLU == B2 bitwise: "
                 f"{same}")
    byte_line(torch, "roi_conv_fleet",
              lambda: roi_conv.roi_conv_fleet(x, w0, idx, t, t), entry_bytes,
              results["roi_conv_fleet"])

    # B3: the layer stack on the plain entry output, within CONV_TOL
    s_k = roi_conv.roi_conv_stack(e_p, ws, nbr)
    s_p = ref.roi_conv_stack(e_p, ws, nbr)
    err = float((s_k - s_p).abs().max())
    flops = sum(2 * 9 * ci * co * t * t * n
                for ci, co in zip(chans[:-1], chans[1:]))
    record("roi_conv_stack", err, err <= CONV_TOL,
           lambda: roi_conv.roi_conv_stack(e_p, ws, nbr),
           lambda: ref.roi_conv_stack(e_p, ws, nbr),
           n * t * t * (chans[0] + chans[-1]) * 4 + n * 8 * 4
           + sum(w.numel() for w in ws) * 4, flops,
           check=f"atol {CONV_TOL}")
    # the layer-by-layer route where the ring route also applies: the same
    # bits, in one launch
    before = _build.LAUNCHES["roi_conv_stack"]
    same = torch.equal(roi_conv.roi_conv_stack_layers(e_p, ws, nbr), s_k)
    torch.cuda.synchronize()
    one = _build.LAUNCHES["roi_conv_stack"] == before + 1
    say(f"[kernels] roi_conv_stack layer-by-layer route at {len(ws)} layers "
        f"== the ring route bitwise: {same}; one launch: {one}")
    assert same and one
    del s_k
    r = results["roi_conv_stack"]
    rate_line("roi_conv_stack", flops, r["ms"], r["bound_ms"],
              "tile-body FLOPs (the recomputed ring not counted)")

    # B6: each later layer of the per-layer chain on the plain ReLU'd
    # input, within CONV_TOL; timed as the chain's launches for all of them
    # and layer by layer, each beside its own bound
    ins = [e_p]
    for w in ws[:-1]:
        ins.append(torch.relu(ref.roi_conv_packed(ins[-1], w, nbr)))
    err = 0.0
    for a, w in zip(ins, ws):
        err = max(err, float((roi_conv.roi_conv_packed(a, w, nbr)
                              - ref.roi_conv_packed(a, w, nbr)).abs().max()))
    per_layer = []
    for a, w in zip(ins, ws):
        ci, co = w.shape[2], w.shape[3]
        l_ms = time_ms(torch, lambda a=a, w=w:
                       roi_conv.roi_conv_packed(a, w, nbr))
        l_flops = 2 * 9 * ci * co * t * t * n
        l_bound, l_by = bound(n * t * t * (ci + co) * 4 + n * 8 * 4
                              + w.numel() * 4, l_flops)
        per_layer.append((ci, co, l_ms, l_bound, l_by, l_flops))
    record("roi_conv_packed", err, err <= CONV_TOL,
           lambda: [roi_conv.roi_conv_packed(a, w, nbr)
                    for a, w in zip(ins, ws)],
           lambda: [ref.roi_conv_packed(a, w, nbr) for a, w in zip(ins, ws)],
           sum(n * t * t * (ci + co) * 4 + n * 8 * 4 + w.numel() * 4
               for ci, co, w in zip(chans[:-1], chans[1:], ws)), flops,
           check=f"atol {CONV_TOL}, {len(ws)} layers "
                 f"{chans[0]}->{'->'.join(map(str, chans[1:]))}")
    for ci, co, l_ms, l_bound, l_by, l_flops in per_layer:
        rate_line(f"roi_conv_packed {ci}->{co}", l_flops, l_ms, l_bound,
                  f"one layer's FLOPs ({l_by}-bound)")
    r = results["roi_conv_packed"]
    rate_line("roi_conv_packed (both layers)", flops, r["ms"], r["bound_ms"],
              "both layers' FLOPs")
    del ins

    # B3's layer-by-layer route past the ring's depth: DEEP_CHANNELS on the
    # fleet's tiles in one launch, bitwise equal to nine B6 + ReLU launches,
    # within CONV_TOL of the plain version
    prng = np.random.default_rng(SEED + 7)
    deep = [torch.as_tensor(prng.normal(size=(3, 3, ci, co))
                            / np.sqrt(9 * ci), dtype=torch.float32,
                            device=dev)
            for ci, co in zip(DEEP_CHANNELS[:-1], DEEP_CHANNELS[1:])]
    assert roi_conv.stack_route(len(deep), t, t) == "layers"
    before = _build.LAUNCHES["roi_conv_stack"]
    d_k = roi_conv.roi_conv_stack(e_p, deep, nbr)
    torch.cuda.synchronize()
    one = _build.LAUNCHES["roi_conv_stack"] == before + 1
    chain = e_p
    for w in deep:
        chain = torch.relu(roi_conv.roi_conv_packed(chain, w, nbr))
    same = torch.equal(d_k, chain)
    del chain
    err = float((d_k - ref.roi_conv_stack(e_p, deep, nbr)).abs().max())
    del d_k
    d_ms = time_ms(torch, lambda: roi_conv.roi_conv_stack(e_p, deep, nbr))
    d_flops = sum(2 * 9 * ci * co * t * t * n for ci, co in
                  zip(DEEP_CHANNELS[:-1], DEEP_CHANNELS[1:]))
    d_bound, d_by = bound(n * t * t * (DEEP_CHANNELS[0] + DEEP_CHANNELS[-1])
                          * 4 + n * 8 * 4 + sum(w.numel() for w in deep) * 4,
                          d_flops)
    say(f"[kernels] roi_conv_stack layer-by-layer route, {len(deep)} layers "
        f"{'->'.join(map(str, DEEP_CHANNELS))} over {n} tiles: one launch "
        f"{one}; == {len(deep)} x (B6 + ReLU) bitwise {same}; max_abs_err "
        f"vs plain {err} (bar {CONV_TOL}); ms={d_ms:.4f} "
        f"bound_ms={d_bound:.4f} ({d_by})")
    rate_line("roi_conv_stack (layer by layer)", d_flops, d_ms, d_bound,
              "the layers' FLOPs")
    if not (one and same and err <= CONV_TOL):
        raise AssertionError("the layer-by-layer stack disagrees")
    del deep, e_p

    # B4: the scatter of head tiles into a fresh canvas, bit-exact; the
    # library yardstick is one index_put_ with precomputed pixel indices
    ph = _head_rows(s_p, det.head)
    del s_p
    base = torch.zeros(x.shape[:3] + (A,), device=dev)
    c_k = sbnet.sbnet_scatter_fleet(ph, idx, base.clone())
    c_p = ref.sbnet_scatter_fleet(ph, idx, base.clone())
    where = ref.tile_index(idx, t, t, t, t)
    where = tuple(w.expand(n, t, t) for w in where)
    record("sbnet_scatter_fleet", float((c_k - c_p).abs().max()),
           torch.equal(c_k, c_p),
           lambda: sbnet.sbnet_scatter_fleet(ph, idx, base),
           lambda: ref.sbnet_scatter_fleet(ph, idx, base),
           2 * n * t * t * A * 4 + n * 3 * 4, 0,
           lib_fn=lambda: base.index_put_(where, ph), check="bit-exact")
    del base, where

    # B8 and B9 on one 1920x1080 leg, padded to its grid's extent (1088
    # rows), as ``roi_forward`` hands it over
    leg, leg_grid = flat(frames)[0], flat(grids)[0]
    xl = det._stack_frames([leg], [leg_grid])[0][0]
    rows = torch.as_tensor(ops.mask_to_indices(leg_grid), device=dev)
    n1 = rows.shape[0]
    cam0 = idx[:, 0] == 0
    cover = torch.zeros((xl.shape[0] + 2, xl.shape[1] + 2), dtype=torch.bool,
                        device=dev)
    cover[ref.tile_index(torch.nn.functional.pad(rows, (1, 0)), t, t,
                         t + 2, t + 2)[1:]] = True
    leg_px = int(cover[1:-1, 1:-1].sum())
    route = entry_route(lib, xl, w0, t)
    assert route == "detector", f"the leg's B8 takes the {route} route"
    o_k = roi_conv.roi_conv(xl, w0, rows, t, t)
    err = float((o_k - ref.roi_conv(xl, w0, rows, t, t)).abs().max())
    same = torch.equal(o_k, f_k[cam0])
    del f_k
    leg_bytes = (leg_px * 3 * 4 + w0.numel() * 4 + n1 * 2 * 4
                 + n1 * t * t * chans[0] * 4)
    record("roi_conv", err, err <= CONV_TOL and same,
           lambda: roi_conv.roi_conv(xl, w0, rows, t, t),
           lambda: ref.roi_conv(xl, w0, rows, t, t), leg_bytes,
           2 * 9 * 3 * chans[0] * t * t * n1,
           check=f"atol {CONV_TOL}; route {route}; == B7's rows of camera "
                 f"0 bitwise: {same}; {n1} tiles")
    byte_line(torch, "roi_conv",
              lambda: roi_conv.roi_conv(xl, w0, rows, t, t), leg_bytes,
              results["roi_conv"])

    # B9 on the leg's plane of B4's canvas: the gather gives back B4's
    # head tiles; the library yardsticks index with precomputed pixels
    hm = c_k[0]
    where1 = tuple(w.expand(n1, t, t) for w in ref.tile_index(
        torch.nn.functional.pad(rows, (1, 0)), t, t, t, t)[1:])
    g_k = sbnet.sbnet_gather(hm, rows, t, t)
    g_p = ref.sbnet_gather(hm, rows, t, t)
    ok = torch.equal(g_k, g_p) and torch.equal(g_k, ph[cam0])
    copy_bytes = 2 * n1 * t * t * A * 4 + n1 * 2 * 4
    record("sbnet_gather", float((g_k - g_p).abs().max()), ok,
           lambda: sbnet.sbnet_gather(hm, rows, t, t),
           lambda: ref.sbnet_gather(hm, rows, t, t), copy_bytes, 0,
           lib_fn=lambda: hm[where1],
           check=f"bit-exact (== B4's head tiles); {n1} tiles")
    byte_line(torch, "sbnet_gather",
              lambda: sbnet.sbnet_gather(hm, rows, t, t), copy_bytes,
              results["sbnet_gather"], "tile_copy_kernel")
    base1 = torch.zeros_like(hm)
    s_k = sbnet.sbnet_scatter(g_k, rows, base1.clone())
    s_p = ref.sbnet_scatter(g_k, rows, base1.clone())
    record("sbnet_scatter", float((s_k - s_p).abs().max()),
           torch.equal(s_k, s_p),
           lambda: sbnet.sbnet_scatter(g_k, rows, base1),
           lambda: ref.sbnet_scatter(g_k, rows, base1), copy_bytes, 0,
           lib_fn=lambda: base1.index_put_(where1, g_k),
           check=f"bit-exact; {n1} tiles")
    return results


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

def plain_composition(torch, det, frames, grids):
    """The cold step through the plain versions: entry, stack, head, scatter."""
    from repro_torch.kernels import ref
    from repro_torch.serving.detector import _head_rows
    t = TILE
    _, _, idx, nbr = det._fleet_tables(flat(grids))
    x, _, _ = det._stack_frames(flat(frames), flat(grids))
    packed = ref.roi_conv_stack(ref.roi_conv_entry(x, det.weights[0], idx,
                                                   t, t), det.weights[1:], nbr)
    canvas = torch.zeros(x.shape[:3] + (det.head.shape[-1],), device=x.device)
    return ref.sbnet_scatter_fleet(_head_rows(packed, det.head), idx, canvas)


def plain_err(torch, det, frames, grids, outs):
    """The largest |difference| of the head maps ``outs`` from the plain
    composition on the same frames and grids."""
    want = plain_composition(torch, det, frames, grids)
    return max(float((h - want[i, :h.shape[0], :h.shape[1]]).abs().max())
               for i, h in enumerate(flat(outs)))


# (label, threshold, patch amplitude or None for no new frame, interior)
PLAN = ([("cold", 0.0, None, False)] + [("warm", 0.0, 0.0, False)] * 6
        + [("static", 0.0, None, False)]
        + [("interior", 40.0, 20.0, True)] * 2
        + [("lossy", 40.0, 20.0, False)] * 2)
# the steps on which the canvas and packed reference modes agree by
# definition: no gate, exact gates, and lossy gates on interior motion
SAME_IN_BOTH_MODES = {"cold", "warm", "static", "interior"}


def timed_step(torch, det, frames, grids, cache, thr, tag, step, label):
    """One ``fleet_reuse_step``, timed (host clock around work that ends in
    a synchronize, and CUDA events) and printed."""
    from repro_torch.fleet.runtime import fleet_reuse_step
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    outs, counts, stats = fleet_reuse_step(det, frames, grids, cache, thr)
    b.record()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    st = {k: v for k, v in dataclasses.asdict(stats).items()
          if k != "gate_stats"}
    shown = thr if np.ndim(thr) == 0 else f"table{np.shape(thr)}"
    say(f"[{tag} {step}] {label} threshold={shown} wall_ms={wall_ms:.3f} "
        f"event_ms={a.elapsed_time(b):.3f} counts={dict(counts)} "
        f"stats={st}")
    for h in flat(outs):
        assert torch.isfinite(h).all()
    return outs, counts, stats


def step_kind(stats):
    return ("cold" if stats.cold else
            "static" if stats.computed == 0 else "changed")


def check_kind(label, counts, stats):
    """The step kind the plan asks for, and its dispatch structure."""
    kind = step_kind(stats)
    if label == "cold":
        assert kind == "cold", kind
    elif label == "warm":
        assert kind == "changed", kind
    elif label == "static":
        assert counts == {"tile_delta_gate": 1}, counts
        assert stats.canvas_bytes == 0
    else:
        assert kind == "changed" and 0 < stats.raw_changed < \
            stats.total_tiles, stats
    return kind


def same_stats(a, b) -> bool:
    """Equal ReuseStats, the gate's stats rows included."""
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "gate_stats":
            if (x is None) != (y is None) or (
                    x is not None and not np.array_equal(x, y)):
                return False
        elif x != y:
            return False
    return True


def equals_recompute(torch, det, frames, grids, outs, cams=None):
    """Whether the head maps of ``cams`` (all by default) are bitwise
    equal to a cold recompute through the kernels."""
    from repro_torch.fleet.runtime import fleet_inference_step
    full, fc = fleet_inference_step(det, frames, grids)
    pairs = list(zip(flat(outs), flat(full)))
    cams = range(len(pairs)) if cams is None else cams
    return all(torch.equal(*pairs[c]) for c in cams), dict(fc)


def step_both(torch, det, frames, grids, caches, thr, tag, step, label,
              compare=True):
    """One step of the canvas and the packed cache on the same frames;
    with ``compare``, both give equal counts, ReuseStats and head maps.
    Returns {mode: (outs, counts, stats)}."""
    res = {m: timed_step(torch, det, frames, grids, c, thr, f"{tag}/{m}",
                         step, label)
           for m, c in caches.items()}
    if compare:
        (_, c_counts, c_st), (_, p_counts, p_st) = \
            res["canvas"], res["packed"]
        same = (c_counts == p_counts and same_stats(c_st, p_st)
                and torch.equal(caches["canvas"].canvas,
                                caches["packed"].canvas))
        say(f"[{tag} {step}] canvas == packed (counts, ReuseStats, head "
            f"maps bitwise): {same}")
        assert same
    return res


def drive(torch, det, rng, gen, frames, grids, caches):
    """Phases 3 and 3b: the plan's steps through the canvas and the packed
    cache in lockstep.  Returns the last frames and the step kinds."""
    kinds = []
    for step, (label, thr, amp, interior) in enumerate(PLAN):
        if amp is not None:
            frames = with_patches(torch, frames, grids, rng, gen, amp,
                                  interior)
        res = step_both(torch, det, frames, grids, caches, thr, "step", step,
                        label, compare=label in SAME_IN_BOTH_MODES)
        step_kinds = {m: check_kind(label, counts, stats)
                      for m, (_, counts, stats) in res.items()}
        assert step_kinds["canvas"] == step_kinds["packed"], step_kinds
        kinds.append(step_kinds["canvas"])
        outs = res["canvas"][0]
        if label == "cold":
            err = plain_err(torch, det, frames, grids, outs)
            say(f"[step {step}] cold maps vs plain composition: "
                f"max_abs_err={err}")
            assert err <= CONV_TOL, err
        elif label == "warm":
            same, fc = equals_recompute(torch, det, frames, grids, outs)
            say(f"[step {step}] threshold-0 reuse == cold recompute "
                f"bitwise: {same} (recompute counts {fc})")
            assert same
    return frames, kinds


def rate_control_loop(torch, det, rng, gen, frames, grids, caches):
    """Phase 3c, the edge rate-control loop on both caches."""
    from repro_torch.kernels import ops
    from repro_torch.net import (RateControlConfig, gate_threshold_schedule,
                                 rate_controlled_departures,
                                 static_fraction_from_stats,
                                 tile_halo_static_fraction,
                                 tile_static_fraction)

    def both(frames, thr, step, label):
        res = step_both(torch, det, frames, grids, caches, thr, "rate", step,
                        label)
        return res["canvas"][0], res["canvas"][2]

    # align the references: a threshold-0 step advances every row
    frames = with_patches(torch, frames, grids, rng, gen, 0.0)
    outs, st = both(frames, 0.0, 0, "align")
    assert step_kind(st) == "changed"
    same, _ = equals_recompute(torch, det, frames, grids, outs)
    say(f"[rate 0] threshold-0 reuse == cold recompute bitwise: {same}")
    assert same

    # the fractions: the gate's own stats rows (no launch) against B10
    prev = frames
    frames = with_patches(torch, frames, grids, rng, gen, 20.0)
    _, st = both(frames, 0.0, 1, "fractions")
    assert step_kind(st) == "changed"
    cam = caches["canvas"].idx_np[:, 0]
    n_cams = len(flat(grids))
    # the fleet packing is camera-major: camera c's rows are one range
    bounds = np.searchsorted(cam, np.arange(n_cams + 1))
    triples = list(zip(flat(frames), flat(prev), flat(grids)))

    def host_ms(fn):
        """Host wall of ``fn``, ending in a synchronize."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    with ops.count_kernels() as fast:
        fast_f, fast_ms = host_ms(lambda: [
            static_fraction_from_stats(st.gate_stats[bounds[c]:bounds[c + 1]],
                                       3, TILE) for c in range(n_cams)])
    with ops.count_kernels() as slow:
        body_f, body_ms = host_ms(lambda: [
            tile_static_fraction(a, b, g, TILE) for a, b, g in triples])
        halo_f, halo_ms = host_ms(lambda: [
            tile_halo_static_fraction(a, b, g, TILE) for a, b, g in triples])
    say(f"[rate 1] static fractions from the gate stats ({dict(fast)} "
        f"dispatches, {fast_ms:.3f} ms) == tile_static_fraction through "
        f"B10 ({dict(slow)}; {body_ms:.3f} ms, the halo fractions "
        f"{halo_ms:.3f} ms): {fast_f == body_f}; body "
        f"{np.round(body_f, 4)}; halo {np.round(halo_f, 4)}")
    assert sum(fast.values()) == 0 and fast_f == body_f
    assert slow == {"tile_delta": n_cams, "tile_delta_halo": n_cams}, slow
    assert min(body_f) < 1.0

    # the rate controller behind an uplink that congests every other
    # camera, and its quality trace as per-camera, per-class thresholds
    prng = np.random.default_rng(SEED + 3)
    S = 10
    body = prng.uniform(2e4, 6e4, (n_cams, S))
    halo = prng.uniform(0.1, 0.4, (n_cams, S)) * body
    headers = np.full((n_cams, S), 240.0)
    arrivals = np.arange(S)[None, :] + prng.uniform(0, 0.2, (n_cams, 1))
    congested = np.arange(n_cams) % 2 == 1
    bw = np.where(congested[:, None], 2e4, 1e7) \
        * prng.uniform(0.8, 1.2, (n_cams, S))
    rc = RateControlConfig(enabled=True, static_fraction=np.array(body_f),
                           halo_static_fraction=np.array(halo_f))
    _, sent, quality, shed_h, shed_b = rate_controlled_departures(
        arrivals, body, halo, headers, bw, rc)
    thr = gate_threshold_schedule(quality, TILE, 3, gain=0.5, halo_gain=0.25)
    unshed = np.nonzero((thr == 0).all(axis=1))[0]
    say(f"[rate 2] quality min per camera {np.round(quality.min(axis=1), 4)}"
        f"; shed bytes halo {shed_h.sum():.1f} body {shed_b.sum():.1f} of "
        f"{(body + halo + headers).sum():.1f}; thresholds {thr.shape} "
        f"{np.round(thr[congested][0], 4)} on congested cameras, 0 on "
        f"{len(unshed)} cameras")
    assert thr.shape == (n_cams, 2)
    assert (thr[congested] > 0).all() and list(unshed) == \
        list(np.nonzero(~congested)[0])

    # one more step under the table: fresh sub-threshold patches
    frames = with_patches(torch, frames, grids, rng, gen, 0.0)
    outs, st = both(frames, thr, 2, "schedule")
    exact = st.gate_stats[:, ops.GATE_WIN_EXACT] > 0
    exact_congested = int(exact[congested[cam]].sum())
    # the unshed cameras gate exactly, so every raw-changed row beyond
    # their exact changes lies on a congested camera
    raw_congested = st.raw_changed - int(exact[~congested[cam]].sum())
    same, _ = equals_recompute(torch, det, frames, grids, outs, unshed)
    say(f"[rate 2] under the schedule: {st.raw_changed} raw-changed rows "
        f"of {int(exact.sum())} that changed at all; on congested cameras "
        f"{raw_congested} raw-changed of {exact_congested} changed; the "
        f"{len(unshed)} unshed cameras == cold recompute bitwise: {same}")
    assert same
    assert exact_congested > 0 and 0 <= raw_congested < exact_congested, \
        "the congested cameras' thresholds did not take effect"


FUSED = {"roi_conv_entry": 1, "roi_conv_stack": 1}
LAYERS = {"roi_conv_packed": 2}
# each path's dispatches, as the JAX package's detector counts them
STRUCTURE = {
    "fleet_forward": {**FUSED, "sbnet_scatter_fleet": 1},
    "fleet_forward_layers": {"roi_conv_fleet": 1, **LAYERS,
                             "sbnet_scatter_fleet": 1},
    "roi_forward": {**FUSED, "sbnet_scatter": 1},
    "roi_forward_layers": {"roi_conv": 1, **LAYERS, "sbnet_scatter": 1},
}


def layer_paths(torch, det, frames, grids):
    """Phase 3d: the per-layer and single-camera paths against the fused
    ones, bitwise, with their dispatch structures; the density switch;
    the batched single-camera conv; B9's gather on B8's oracle and on the
    head maps."""
    from repro_torch.kernels import _build, ops
    from repro_torch.serving.detector import _head_rows
    t = TILE
    w0 = det.weights[0]
    walls = {}

    def run(name, fn, *args):
        """``fn(*args)`` with its dispatches (checked against the path's
        structure when it has one) and its host wall, ending in a
        synchronize."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with ops.count_kernels() as c:
            out = fn(*args)
        torch.cuda.synchronize()
        walls.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
        if name in STRUCTURE:
            assert dict(c) == STRUCTURE[name], (name, dict(c))
        return out, dict(c)

    fl_f, fl_g = flat(frames), flat(grids)
    fused, _ = run("fleet_forward", det.fleet_forward, fl_f, fl_g)
    layers, _ = run("fleet_forward_layers", det.fleet_forward_layers, fl_f,
                    fl_g)
    same = all(torch.equal(a, b) for a, b in zip(fused, layers))
    say(f"[layers] fleet_forward_layers == fleet_forward bitwise over "
        f"{sum(int(g.sum()) for g in fl_g)} tiles: {same}; walls "
        f"{walls['fleet_forward'][0]:.3f} / "
        f"{walls['fleet_forward_layers'][0]:.3f} ms")
    assert same
    del layers

    for c, (f, g) in enumerate(zip(fl_f, fl_g)):
        # the first call builds the camera's tables on the host
        one, _ = run("roi_forward", det.roi_forward, f, g)
        lay, _ = run("roi_forward_layers", det.roi_forward_layers, f, g)
        again, _ = run("roi_forward", det.roi_forward, f, g)
        solo, _ = run("fleet_forward", det.fleet_forward, [f], [g])
        same = (torch.equal(one, lay) and torch.equal(one, again)
                and torch.equal(one, solo[0]) and torch.equal(one, fused[c]))
        assert tuple(one.shape) == tuple(f.shape[:2]) + (det.head.shape[-1],)
        assert torch.isfinite(one).all()
        if not same:
            raise AssertionError(f"camera {c}: roi_forward, "
                                 f"roi_forward_layers and fleet_forward "
                                 f"differ")
    say(f"[layers] {len(fl_f)} cameras: roi_forward == roi_forward_layers == "
        f"one-camera fleet_forward == the fleet's map, bitwise: True; walls "
        f"ms roi_forward, tables built "
        f"{np.round(walls['roi_forward'][0::2], 3).tolist()}, cached "
        f"{np.round(walls['roi_forward'][1::2], 3).tolist()}; "
        f"roi_forward_layers "
        f"{np.round(walls['roi_forward_layers'], 3).tolist()}; one-camera "
        f"fleet_forward {np.round(walls['fleet_forward'][1:], 3).tolist()}")

    # the density switch, on the first leg; the dense check runs on the
    # leg padded to its grid (1088 rows), where the RoI path's tiles lie
    f0, g0 = fl_f[0], fl_g[0]
    r, rc = run("forward (RoI)", det.forward, f0, g0)
    assert rc == STRUCTURE["roi_forward"] and torch.equal(r, fused[0]), rc
    all_true = np.ones_like(g0)
    f0p = det._stack_frames([f0], [g0])[0][0]
    d, dc = run("forward (dense)", det.forward, f0p, all_true)
    want, _ = run("roi_forward", det.roi_forward, f0p, all_true)
    err = float((d - want).abs().max())
    say(f"[layers] forward: density {g0.mean():.3f} -> {rc}; all-true grid "
        f"-> dense, {dc} dispatches, max_abs_err vs roi_forward {err}")
    assert dc == {} and err <= CONV_TOL
    del fused, d, want, f0p

    # roi_conv_batched: the first group's four legs under one shared mask
    legs = frames[0][:4]
    xs, _, _ = det._stack_frames(legs, [g0] * len(legs))
    idx, idx3, nbr = det._mask_tables(g0)
    route = entry_route(_build.library(), xs, w0, t)
    assert route == "detector", f"the batched B8 takes the {route} route"
    batch, bc = run("roi_conv_batched", ops.roi_conv_batched, xs, w0, idx, t,
                    t)
    per = [run("roi_conv", ops.roi_conv, xs[b], w0, idx, t, t)[0]
           for b in range(len(legs))]
    same = all(torch.equal(batch[b], per[b]) for b in range(len(legs)))
    say(f"[layers] roi_conv_batched over {len(legs)} legs, one mask: "
        f"{bc}; route {route}; == B8 frame by frame bitwise: {same}")
    assert bc == {"roi_conv": 1} and same

    # B8's defining oracle: the RoI tiles of the full-frame SAME conv
    full = torch.nn.functional.conv2d(
        xs[0].permute(2, 0, 1)[None], w0.permute(3, 2, 0, 1), padding=1)
    full = full[0].permute(1, 2, 0).contiguous()
    tiles, gc = run("sbnet_gather", ops.sbnet_gather, full, idx, t, t)
    err = float((tiles - per[0]).abs().max())
    say(f"[layers] B9 gather of the full-frame F.conv2d (no TF32) vs B8: "
        f"{gc}, max_abs_err {err}")
    assert gc == {"sbnet_gather": 1} and err <= CONV_TOL
    del batch, per, full, tiles, xs

    # gather o scatter: each map, zero-padded to its grid, gathered at its
    # RoI tiles gives back the packed head rows (zero below the frame)
    for f, g in zip(fl_f, fl_g):
        idx, idx3, nbr = det._mask_tables(g)
        xs1, ch, cw = det._stack_frames([f], [g])
        ph = _head_rows(det._stack_chain(xs1, idx3, nbr), det.head)
        ys = idx[:, 0, None].long() * t + torch.arange(t, device=idx.device)
        ph[ys >= f.shape[0]] = 0
        hm = torch.zeros((ch, cw, ph.shape[-1]), device=ph.device)
        hm[:f.shape[0], :f.shape[1]] = det.roi_forward(f, g)
        back, _ = run("sbnet_gather", ops.sbnet_gather, hm, idx, t, t)
        if not torch.equal(back, ph):
            raise AssertionError("gather of roi_forward's map != head rows")
    say(f"[layers] {len(fl_f)} cameras: B9 gather of roi_forward's map == "
        f"the packed head rows bitwise: True")
    return walls

# ---------------------------------------------------------------------------
# B12 and the serving path: the fleet's patch stream
# ---------------------------------------------------------------------------

def fleet_keep(grids):
    """The RoI keep-list of one frame's fleet patch stream: one token per
    offline 64-px cell (the coarse grid under each camera's x4 tile
    expansion), the 20 cameras in camera order."""
    return np.concatenate([g[::4, ::4].reshape(-1) for g in flat(grids)])


def attn_err(got, want):
    """(max |got - want|, the largest share of the relative bar
    |got - want| / (ATTN_REL |want| + ATTN_ABS) -- at most 1 to pass --,
    median |want|) over the given rows."""
    g, w = got.float(), want.float()
    d = (g - w).abs()
    return (float(d.max()), float((d / (ATTN_REL * w.abs() + ATTN_ABS)).max()),
            float(w.abs().median()))


def attention_case(torch, dev, S, H, D, bq, bk, positions, dtype, seed):
    """q, k, v from a seeded generator on the card; B12 with and without
    the skip and its plain version.  Returns ((max error, share of the
    relative bar, median |want|) on real rows against the plain version,
    skip == exhaustive bitwise on real rows, visited ==
    attention_visit_bound for every head, the tensors)."""
    from repro_torch.kernels import ops, ref, roi_attention
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn((S, H, D), generator=gen, device=dev).to(dtype)
               for _ in range(3))
    pos = torch.as_tensor(positions, dtype=torch.int32, device=dev)
    n_real = int((pos != roi_attention.PAD_POS).sum())
    out, vis = roi_attention.roi_attention(q, k, v, pos, bq, bk, True)
    full, vis_full = roi_attention.roi_attention(q, k, v, pos, bq, bk, False)
    want, want_vis = ref.roi_attention(q, k, v, pos, bq, bk, True)
    torch.cuda.synchronize()
    real = pos != roi_attention.PAD_POS
    errs = attn_err(out[real], want[real]) if n_real \
        else (float(out.float().abs().max()), 0.0, 0.0)
    same = bool(torch.equal(out[real], full[real]))
    bound_rows = ops.attention_visit_bound(np.asarray(positions), bq, bk)
    vis_ok = (np.array_equal(vis.cpu().numpy(),
                             np.broadcast_to(bound_rows, (H, S // bq)))
              and torch.equal(vis, want_vis)
              and bool((vis_full == S // bk).all()))
    return errs, same, vis_ok, (q, k, v, pos, out, vis)


def check_attention(torch, dev, grids, results):
    """Phase 2 for B12: the shapes of tests/test_kernels.py and
    tests/test_packed_path.py, then the serving slice's (the fleet's
    9,472-token packed stream, 48 heads of 128, bf16) with times."""
    from repro_torch.kernels import ops, ref, roi_attention
    PAD = roi_attention.PAD_POS
    rng = np.random.default_rng(SEED + 4)
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for S, H, D, bq, bk in ((128, 2, 32, 64, 64), (256, 4, 64, 128, 128),
                                (256, 1, 128, 64, 128)):
            pos = np.full(S, PAD, np.int32)
            n = int(0.8 * S)
            pos[:n] = np.sort(rng.choice(4 * S, n, replace=False))
            cases.append((S, H, D, bq, bk, pos, dtype))
    for frac in (0.25, 0.6):                       # the block-skip tests
        pos = np.full(256, PAD, np.int32)
        n = int(frac * 256)
        pos[:n] = np.sort(rng.choice(1024, n, replace=False))
        cases.append((256, 2, 32, 32, 32, pos, torch.float32))
    pos = np.full(512, PAD, np.int32)
    pos[:128] = np.arange(128) * 3
    cases.append((512, 1, 16, 64, 64, pos, torch.float32))
    worst = {}
    for i, (S, H, D, bq, bk, pos, dtype) in enumerate(cases):
        (err, use, _), same, vis_ok, _ = attention_case(
            torch, dev, S, H, D, bq, bk, pos, dtype, SEED + 10 + i)
        tol = ATTN_TOL[str(dtype).split(".")[-1]]
        ok = err <= tol and use <= 1.0 and same and vis_ok
        w = worst.get(str(dtype), (0.0, 0.0))
        worst[str(dtype)] = (max(w[0], err), max(w[1], use))
        if not ok:
            raise AssertionError(
                f"roi_attention case {(S, H, D, bq, bk, str(dtype))}: "
                f"err {err} (tol {tol}), relative bar share {use}, skip == "
                f"exhaustive {same}, visited == bound {vis_ok}")
    # an all-padding stream visits nothing and gives exact zeros
    zpos = torch.full((128,), PAD, dtype=torch.int32, device=dev)
    zq = torch.ones((128, 1, 16), device=dev)
    zout, zvis = roi_attention.roi_attention(zq, zq, zq, zpos, 64, 64, True)
    zero_ok = int(zvis.sum()) == 0 and float(zout.abs().max()) == 0.0
    say(f"[kernels] roi_attention: {len(cases)} test shapes, (max error, "
        f"largest share of the relative bar) on real rows {worst}, skip == "
        f"exhaustive bitwise and visited == attention_visit_bound on all; "
        f"all-padding stream: 0 visits, zeros: {zero_ok}")
    assert zero_ok

    # the serving slice: the fleet stream's packed positions, in f32 at
    # 2e-5 and in bf16 (timed) at 0.05 and the relative bar
    keep = fleet_keep(grids)
    _, positions, n_kept = ops.pack_tokens(
        torch.arange(keep.size, device=dev), torch.as_tensor(keep,
                                                             device=dev))
    pos_np = positions.cpu().numpy()
    S, H, D, blk = pos_np.size, SLICE_HEADS, SLICE_HEAD_DIM, 128
    (err32, _, med32), same32, vis_ok32, _ = attention_case(
        torch, dev, S, H, D, blk, blk, pos_np, torch.float32, SEED + 6)
    say(f"[kernels] roi_attention f32 S={S} H={H} D={D} blocks {blk}: max "
        f"error on real rows {err32} (bar {ATTN_TOL['float32']}, median "
        f"|want| {med32:.5f}); skip == exhaustive bitwise {same32}; visited "
        f"== bound {vis_ok32}")
    if not (err32 <= ATTN_TOL["float32"] and same32 and vis_ok32):
        raise AssertionError("roi_attention f32 at the serving slice "
                             "disagrees with its plain version")
    (err, use, med), same, vis_ok, (q, k, v, pos, out, vis) = attention_case(
        torch, dev, S, H, D, blk, blk, pos_np, torch.bfloat16, SEED + 5)
    pairs = int(vis[0].sum())
    nq = S // blk
    ok = err <= ATTN_TOL["bfloat16"] and use <= 1.0 and same and vis_ok
    mask = pos[:, None] >= pos[None, :]
    qh, kh, vh = (t.permute(1, 0, 2)[None] for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = sdpa(qh, kh, vh, attn_mask=mask)[0].permute(1, 0, 2)
    lib_err = float((lib[:n_kept].float() - out[:n_kept].float()).abs().max())
    exhaustive_ms = time_ms(torch, lambda: roi_attention.roi_attention(
        q, k, v, pos, blk, blk, False))
    ms = time_ms(torch, lambda: roi_attention.roi_attention(
        q, k, v, pos, blk, blk, True))
    plain_ms = time_ms(torch, lambda: ref.roi_attention(
        q, k, v, pos, blk, blk, True), reps=5)
    lib_ms = time_ms(torch, lambda: sdpa(qh, kh, vh, attn_mask=mask))
    # the bound counts the work the function needs: 4*D FLOP per head for
    # each visible (real query, real key) pair, pos_k <= pos_q, and the
    # bytes of the real rows' q, k, v, the positions, and the whole output
    # and visited counts written once
    real_pos = np.sort(pos_np[pos_np != PAD])
    needed = int(np.searchsorted(real_pos, real_pos, side="right").sum())
    nbytes = ((3 * real_pos.size + S) * H * D * q.element_size() + S * 4
              + H * nq * 4)
    flops = 4 * D * H * needed
    b_ms, b_by = bound(nbytes, flops, BF16_FLOP_PER_S)
    visited_ms, _ = bound(nbytes, 4 * blk * blk * D * pairs * H,
                          BF16_FLOP_PER_S)
    check = (f"bf16 S={S} H={H} D={D} blocks {blk}, n_kept={n_kept}; atol "
             f"{ATTN_TOL['bfloat16']} and per element 2^-7|want| + 1e-3 on "
             f"real rows (largest share of that bar {use:.4f}, median |want| "
             f"{med:.5f}); skip == exhaustive bitwise {same}; visited "
             f"{pairs} of {nq * nq} block pairs per head == bound {vis_ok}; "
             f"exhaustive ms {exhaustive_ms:.4f}; SDPA (bool mask) vs kernel "
             f"on real rows {lib_err}; bound: 4*D FLOP per head for each of "
             f"the {needed} visible real (q, k) pairs per head at 989 TFLOP/s "
             f"(bf16), the {real_pos.size} real rows' q, k, v, positions, "
             f"out and visited once at 3.35 TB/s (4*bq*bk*D per visited "
             f"block pair would give {visited_ms:.4f} ms)")
    results["roi_attention"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms, check=check)
    say(f"[kernels] roi_attention: {check} max_abs_err={err} ok={ok} "
        f"ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) "
        f"library_ms={lib_ms}")
    rate_line("roi_attention", flops, ms, b_ms,
              "needed FLOPs (visible real pairs)")
    rate_line("roi_attention", 4 * blk * blk * D * pairs * H, ms, visited_ms,
              "visited-block FLOPs")
    say(f"[kernels] roi_attention: kernel {ms:.4f} ms against SDPA "
        f"{lib_ms:.4f} ms: {lib_ms / ms:.2f}x, faster: {ms < lib_ms}")
    if not ok:
        raise AssertionError("roi_attention disagrees with its plain version")
    del q, k, v, pos, out, vis, qh, kh, vh, mask, lib

    # a head dim with no instance of its own (h2o-danube3-4b's 120), which
    # the wrapper zero-pads to 128, on the same positions, in f32 and bf16
    Dp = PADDED_HEAD_DIM
    for dtype, seed in ((torch.float32, SEED + 8), (torch.bfloat16, SEED + 9)):
        (err, use, med), same, vis_ok, (q, k, v, pos, *_) = attention_case(
            torch, dev, S, H, Dp, blk, blk, pos_np, dtype, seed)
        name = str(dtype).split(".")[-1]
        ms = time_ms(torch, lambda: roi_attention.roi_attention(
            q, k, v, pos, blk, blk, True))
        ok = (err <= ATTN_TOL[name] and same and vis_ok
              and (dtype == torch.float32 or use <= 1.0))
        say(f"[kernels] roi_attention {name} S={S} H={H} D={Dp} (padded to "
            f"128) blocks {blk}: max error on real rows {err} (bar "
            f"{ATTN_TOL[name]}), largest share of the per-element bar "
            f"{use:.4f} (median |want| {med:.5f}); skip == exhaustive "
            f"bitwise {same}; visited == bound {vis_ok}; ms={ms:.4f}")
        if not ok:
            raise AssertionError(f"roi_attention at D={Dp} ({name}) "
                                 f"disagrees with its plain version")
        del q, k, v, pos
    return keep


def serve_phase(torch, dev, keep, cfg):
    """Phase 3f: internvl2-26b at full width serving the fleet's patch
    stream -- 4 requests of one frame each through ``serve`` with 8
    greedy steps; B12 on the engine's own layer-0 and last-layer q/k/v;
    the pruned-prompt identity.  Returns the engine-tensor B12 calls'
    launches, counted from 0."""
    from repro_torch.configs import ServeConfig
    from repro_torch.kernels import ops, ref
    from repro_torch.models import forward as F, layers as L, model as M
    from repro_torch.models.params import count_params, init_params
    from repro_torch.serving.engine import Request, ServingEngine

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                         dev)
    torch.cuda.synchronize()
    n_params = count_params(params)
    say(f"[serve] {cfg.name}: {cfg.num_layers} layers (full depth), d_model "
        f"{cfg.d_model}, heads {cfg.num_heads}/{cfg.num_kv_heads} of "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"frontend {cfg.frontend_dim}; {n_params / 1e9:.3f} B parameters "
        f"({torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB, {cfg.dtype}) "
        f"drawn in {time.perf_counter() - t0:.1f} s")
    S, n_kept = keep.size, int(keep.sum())
    streams = [np.random.default_rng((SEED, 100 + f)).standard_normal(
        (S, cfg.frontend_dim), dtype=np.float32) for f in range(N_REQUESTS)]
    engine = ServingEngine(cfg, ServeConfig(roi_sparsity=True), params)

    # host-clock timings of each prefill and decode step, ending in a
    # synchronize; the first prefill's logits for the identity below
    prefill_ms, decode_ms, first = [], [], {}
    roi_prefill, decode_group = engine.roi_prefill, engine._decode_group

    def timed_prefill(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = roi_prefill(*a, **kw)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t) * 1e3)
        first.setdefault("res", res)
        return res

    def timed_decode(*a):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = decode_group(*a)
        torch.cuda.synchronize()
        decode_ms.append((time.perf_counter() - t) * 1e3)
        return out

    engine.roi_prefill, engine._decode_group = timed_prefill, timed_decode
    reqs = [Request(i, tokens=x, keep=keep, max_new_tokens=DECODE_STEPS)
            for i, x in enumerate(streams)]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = engine.serve(reqs, greedy_steps=DECODE_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    res0 = first["res"]
    Sp = -(-S // 128) * 128
    ok = (res0.n_kept == n_kept and sorted(out) == list(range(N_REQUESTS))
          and all(t.shape == (DECODE_STEPS,) and (t >= 0).all()
                  and (t < cfg.vocab_size).all() for t in out.values()))
    say(f"[serve] {N_REQUESTS} requests of S={S} patch tokens, n_kept="
        f"{res0.n_kept} (packed length {Sp}): serve wall {wall * 1e3:.1f} ms;"
        f" roi_prefill ms {np.round(prefill_ms, 3).tolist()}; decode ms per "
        f"step {np.round(decode_ms, 3).tolist()}; ring_rebuilds "
        f"{engine.ring_rebuilds}; peak memory {peak:.2f} GiB; tokens "
        f"{ {k: v.tolist() for k, v in out.items()} }")
    assert ok and n_kept == FLEET_KEPT and Sp == FLEET_PACKED, (n_kept, Sp)
    assert engine.ring_rebuilds == 1 and len(decode_ms) == DECODE_STEPS

    # the pruned-prompt identity: the last kept row's logits equal a dense
    # prefill of the kept patches alone at their original positions
    kept = np.nonzero(keep)[0]
    empty = torch.zeros((1, 0), dtype=torch.long, device=dev)
    dense, _ = M.prefill(
        params, cfg, {"tokens": empty,
                      "patches": torch.as_tensor(streams[0][kept],
                                                 device=dev)[None]},
        M.init_cache(cfg, 1, n_kept, dev),
        positions=torch.as_tensor(kept, dtype=torch.int32, device=dev)[None])
    got, want = res0.logits[0, -1].float(), dense[0, -1].float()
    scale = float(want.abs().max())
    rel = float((got - want).abs().max()) / scale
    same_top = int(got.argmax()) == int(want.argmax())
    say(f"[serve] pruned-prompt identity: max |logit| {scale:.4f}, max "
        f"error {rel * scale:.5f} = {rel:.5f} of the scale; same argmax "
        f"{same_top}")
    assert torch.isfinite(got).all() and rel <= PRUNED_REL_TOL
    del dense, res0, first

    # B12 on the engine's own tensors: layer 0's and the last layer's q
    # and repeat_kv'd k, v of request 0's packed stream
    packed, positions, _ = ops.pack_tokens(
        torch.as_tensor(streams[0], device=dev), torch.as_tensor(keep,
                                                                 device=dev))
    pos = positions[None]
    x = M._front(params, cfg, {"tokens": empty, "patches": packed[None]})
    rope = F._rope(cfg, Sp, positions=pos, device=dev)
    stack = F._sub(params, "blocks_")
    G = cfg.num_heads // cfg.num_kv_heads
    taps = {}
    for i in range(cfg.num_layers):
        lp = F.layer_params(stack, i)
        if i in (0, cfg.num_layers - 1):
            h = L.rmsnorm(x, lp["ln1"], cfg.norm_eps)
            q, k, v = F.project_qkv(h, lp, cfg, rope)
            k, v = L.repeat_kv(k, G), L.repeat_kv(v, G)
            o = L.blockwise_attention(q, k, v, q_positions=pos,
                                      kv_positions=pos)
            taps[i] = [t[0].contiguous() for t in (q, k, v, o)]
        x, _ = F.dense_block(x, lp, cfg, rope_sincos=rope, positions=pos)
    del x, h, q, k, v, o, packed

    def engine_attention():
        return [ops.roi_attention(q, k, v, positions, return_stats=True)
                for q, k, v, _ in taps.values()]

    got, launches, disp, _ = run_path(torch, engine_attention)
    bound_rows = ops.attention_visit_bound(positions.cpu().numpy())
    for (layer, (q, k, v, o)), (out_k, vis) in zip(taps.items(), got):
        full = ops.roi_attention(q, k, v, positions, causal_skip=False)
        want = ref.roi_attention(q, k, v, positions)[0]
        e_plain, u_plain, med = attn_err(out_k[:n_kept], want[:n_kept])
        e_block, u_block, _ = attn_err(out_k[:n_kept], o[:n_kept])
        same = torch.equal(out_k[:n_kept], full[:n_kept])
        vis_ok = np.array_equal(vis.cpu().numpy(), np.broadcast_to(
            bound_rows, vis.shape))
        pairs = int(vis[0].sum())
        say(f"[serve] B12 on layer {layer}'s q/k/v (S={Sp}, H="
            f"{q.shape[1]}, D={q.shape[2]}, {q.dtype}), on {n_kept} real "
            f"rows (median |want| {med:.5f}): max error vs plain {e_plain} "
            f"({u_plain:.4f} of the relative bar), vs the engine's "
            f"blockwise_attention {e_block} ({u_block:.4f} of it); skip == "
            f"exhaustive bitwise {same}; visited {pairs} of "
            f"{(Sp // 128) ** 2} block pairs per head == bound {vis_ok}")
        assert e_plain <= ATTN_TOL["bfloat16"] and u_plain <= 1.0 and \
            e_block <= ATTN_TOL["bfloat16"] and u_block <= 1.0 and \
            same and vis_ok
        assert pairs == FLEET_PAIRS, pairs
    say(f"[serve] B12 entry point on the engine's tensors: dispatches "
        f"{disp}; launches {launches}")

    # phase 3g's serve leg: the deadline group former under Poisson
    # arrivals, each request one patch stream kept whole
    from repro_torch.obs.loadgen import drive_serve
    engine.roi_prefill, engine._decode_group = roi_prefill, decode_group
    panel = drive_serve(engine, SERVE_RATE_HZ, n_requests=SERVE_REQUESTS,
                        deadline_s=SERVE_DEADLINE, prompt_len=SERVE_PROMPT)
    say(f"[3g serve] drive_serve at {SERVE_RATE_HZ} Hz, {SERVE_REQUESTS} "
        f"requests of one {SERVE_PROMPT}-patch stream each, groups of 3 "
        f"over 2 camera groups, deadline {SERVE_DEADLINE} s (waits on the "
        f"stream's clock, serve_wall_s on the host's): {json.dumps(panel)}")
    assert panel["served"] == SERVE_REQUESTS
    assert panel["complete_flushes"] + panel["deadline_flushes"] > 0
    assert 0.0 <= panel["wait_p50_s"] <= panel["wait_p99_s"] \
        <= SERVE_DEADLINE + 1e-9
    return launches


# ---------------------------------------------------------------------------
# phase 3e: CrossRoI's offline -> online path on the card
# ---------------------------------------------------------------------------

# the 4x5 fleet of tests/test_fleet.py's end-to-end test, at the paper's
# 60 s profile (600 frames at 10 fps) with the quickstart's exact solver
CROSSROI_GROUPS = (("uniform", 21), ("sparse", 22), ("rush_hour", 23),
                   ("bursty", 24))
CROSSROI_SECONDS = 120
CROSSROI_PROFILE = 600
CROSSROI_SOLVER = "exact"
FORMER_DEADLINE_S = 0.5


def crossroi_offline():
    """The offline phase on the host: the fleet's scenes, then per group
    noisy ReID, the filters, the association table and the set cover."""
    from repro_torch.core.pipeline import OfflineConfig
    from repro_torch.fleet import (FleetConfig, GroupSpec, build_fleet,
                                   run_fleet_offline)
    t0 = time.perf_counter()
    fleet = build_fleet(FleetConfig(
        groups=[GroupSpec(p, seed=s) for p, s in CROSSROI_GROUPS],
        duration_s=CROSSROI_SECONDS))
    t_build = time.perf_counter() - t0
    off = run_fleet_offline(fleet, OfflineConfig(
        profile_frames=CROSSROI_PROFILE, solver=CROSSROI_SOLVER))
    for g, o in zip(fleet.groups, off.per_group):
        say(f"[crossroi] offline group {g.gid} ({g.spec.profile}, seed "
            f"{g.spec.seed}): |M| = {len(o.mask)} cells of 64 px, density "
            f"{o.fleet_density:.4f}, {o.solve.method} solver optimal="
            f"{o.solve.optimal} (nodes {o.solve.nodes}, lower bound "
            f"{o.solve.lower_bound:.1f}), host {o.wall_s:.2f} s of which "
            f"the solve {o.solve.wall_s:.2f} s")
        assert len(o.mask) > 0
    say(f"[crossroi] offline phase on the host ({CROSSROI_SECONDS} s "
        f"scenes, {CROSSROI_PROFILE} profile frames, {CROSSROI_SOLVER} "
        f"set cover): build_fleet {t_build:.2f} s, run_fleet_offline "
        f"{off.wall_s:.2f} s; fleet density {off.fleet_density:.4f}")
    return fleet, off


def crossroi_grids(fleet, off):
    """Each camera's offline mask grid expanded to ``TILE``-px tiles:
    {gid: [per-camera bool grid]}."""
    out = {}
    for g in fleet.groups:
        out[g.gid] = []
        for c in g.scene.cameras:
            k = c.tile // TILE
            out[g.gid].append(np.kron(off.per_group[g.gid].cam_grids[c.cam_id],
                                      np.ones((k, k), bool)))
    return out


def crossroi_steps(torch, det, grids, frames, rng, gen):
    """The fleet steps on the offline masks: the cold super-launch, then a
    canvas-reference and a packed-reference cache in lockstep through cold,
    warm (5 of 20 cameras patched) and all-static steps.  The cold and
    warm maps are held against the plain composition, the warm step's gate
    stats (B1's, and B5's through the lockstep) against the plain gate,
    and the warm maps bitwise against a cold recompute.  Returns the warm
    step's frames."""
    from repro_torch.fleet.runtime import fleet_inference_step
    from repro_torch.kernels import ref
    from repro_torch.serving.detector import PackedActivationCache
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cold, counts = fleet_inference_step(det, frames, grids)
    torch.cuda.synchronize()
    say(f"[crossroi] fleet_inference_step wall_ms="
        f"{(time.perf_counter() - t0) * 1e3:.3f} counts={dict(counts)}")
    caches = {"canvas": PackedActivationCache(),
              "packed": PackedActivationCache(ref_mode="packed")}

    def step(fs, n, label):
        res = step_both(torch, det, fs, grids, caches, 0.0, "crossroi", n,
                        label)
        for _, counts, stats in res.values():
            check_kind(label, counts, stats)
        return res["canvas"][0], res["canvas"][2]

    outs, _ = step(frames, 0, "cold")
    same = all(torch.equal(a, b) for a, b in zip(flat(outs), flat(cold)))
    err = plain_err(torch, det, frames, grids, outs)
    say(f"[crossroi 0] cold reuse step == fleet_inference_step bitwise: "
        f"{same}; maps vs plain composition: max_abs_err={err}")
    assert same and err <= CONV_TOL, err
    nxt = with_patches(torch, frames, grids, rng, gen, 0.0)
    outs, stats = step(nxt, 1, "warm")
    cur_p, prev_p = (torch.nn.functional.pad(
        det._stack_frames(flat(f), flat(grids))[0], (0, 0, 1, 1, 1, 1))
        for f in (nxt, frames))
    want = ref.tile_delta_gate_canvas(
        cur_p, prev_p, det._fleet_tables(flat(grids))[2], TILE, TILE)
    gate_same = np.array_equal(stats.gate_stats, want.cpu().numpy())
    del cur_p, prev_p, want
    err = plain_err(torch, det, nxt, grids, outs)
    same, fc = equals_recompute(torch, det, nxt, grids, outs)
    say(f"[crossroi 1] gate stats == the plain gate bitwise: {gate_same}; "
        f"maps vs plain composition: max_abs_err={err}; threshold-0 reuse "
        f"== cold recompute bitwise: {same} (recompute counts {fc})")
    assert gate_same and same and err <= CONV_TOL, err
    step(nxt, 2, "static")
    return nxt


def offer_all(former, t, frames, grids, cams):
    """Each camera of ``cams`` offers its frame, 10 ms apart from ``t``;
    returns the last release any offer triggered."""
    rel = None
    for i, c in enumerate(cams):
        rel = former.offer(t + 0.01 * i, c, frames[c], grids[c]) or rel
    return rel


def same_heads(torch, rel, want, folded=None):
    """A release's heads (and folded heads) bitwise equal to ``want``
    ({cam: head}, {cam: [older heads]})."""
    folded = folded or {}
    return (sorted(rel.outputs) == sorted(want)
            and all(torch.equal(rel.outputs[c], want[c]) for c in want)
            and {c: len(v) for c, v in rel.folded_outputs.items()}
            == {c: len(v) for c, v in folded.items()}
            and all(torch.equal(a, b) for c in folded
                    for a, b in zip(rel.folded_outputs[c], folded[c])))


def crossroi_former(torch, det, grids, frames, rng, gen):
    """``DeadlineGroupFormer`` on group 0's cameras: a full release, a
    deadline release whose straggler rides the next release folded, and
    reuse mode (packed references, B5) with a folded straggler in capture
    order.  Every released and folded head is held bitwise against a cold
    ``fleet_forward`` of the frames it came from (threshold 0 makes reuse
    exact), and those against the plain composition."""
    from repro_torch.kernels import ops
    from repro_torch.net.batcher import DeadlineGroupFormer
    from repro_torch.serving.detector import PackedActivationCache
    gg = grids[0]
    cams = list(range(len(gg)))
    seq = [frames[0]]
    for _ in range(2):                    # every camera of the group moves
        seq.append(with_patches(torch, {0: seq[-1]}, {0: gg}, rng, gen,
                                0.0)[0])
    f0, f1, f2 = seq
    cold = [det.fleet_forward(fs, gg) for fs in seq]
    err = max(plain_err(torch, det, {0: fs}, {0: gg}, {0: hs})
              for fs, hs in zip(seq, cold))
    say(f"[crossroi] former's frames: cold fleet_forward vs plain "
        f"composition: max_abs_err={err}")
    assert err <= CONV_TOL, err

    def want(heads, folded=None):
        """{cam: frame set} (and {cam: [older frame sets]}) as the cold
        heads those frames give."""
        return ({c: cold[k][c] for c, k in heads.items()},
                {c: [cold[k][c] for k in ks]
                 for c, ks in (folded or {}).items()})

    last = cams[-1]
    former = DeadlineGroupFormer(det, cams, FORMER_DEADLINE_S)
    with ops.count_kernels() as c1:
        full = offer_all(former, 0.0, f0, gg, cams)
    with ops.count_kernels() as c2:
        assert offer_all(former, 1.0, f1, gg, cams[:-1]) is None
        late = former.poll(1.0 + FORMER_DEADLINE_S + 0.1)
    assert former.offer(1.7, last, f1[-1], gg[-1]) is None
    with ops.count_kernels() as c3:
        assert former.offer(2.0, last, f2[-1], gg[-1]) is None
        fold = offer_all(former, 2.01, f2, gg, cams[:-1])
    checks = {
        "full": (full, c1, same_heads(torch, full, *want(
            dict.fromkeys(cams, 0))) and not full.deadline_hit),
        "deadline": (late, c2, same_heads(torch, late, *want(
            dict.fromkeys(cams[:-1], 1))) and late.deadline_hit),
        "folded straggler": (fold, c3, same_heads(torch, fold, *want(
            dict.fromkeys(cams, 2), {last: [1]}))
            and fold.straggler_cams == [last]
            and fold.folded_frames == 1 and former.reclaimed_launches == 1),
    }
    rf = DeadlineGroupFormer(det, cams, FORMER_DEADLINE_S,
                             reuse_cache=PackedActivationCache("packed"),
                             fold_gate="capture")
    with ops.count_kernels() as c4:
        r1 = offer_all(rf, 0.0, f0, gg, cams)
    with ops.count_kernels() as c5:
        assert rf.offer(1.0, last, f1[-1], gg[-1]) is None
        assert rf.offer(1.01, last, f2[-1], gg[-1]) is None
        r2 = offer_all(rf, 1.02, f1, gg, cams[:-1])
    checks["reuse"] = (r1, c4, same_heads(torch, r1, *want(
        dict.fromkeys(cams, 0))))
    checks["reuse, folded straggler"] = (r2, c5, same_heads(
        torch, r2, *want({**dict.fromkeys(cams[:-1], 1), last: 2},
                         {last: [1]}))
        and r2.straggler_cams == [] and r2.folded_frames == 1
        and rf.reuse_waves == 3)
    for label, (rel, counts, ok) in checks.items():
        say(f"[crossroi] former {label}: cams {rel.cams} stragglers "
            f"{rel.straggler_cams} folded {rel.folded_frames} deadline_hit "
            f"{rel.deadline_hit}; dispatches {dict(counts)}; heads == a cold "
            f"fleet_forward of their frames, bitwise: {ok}")
        assert ok, label
    say(f"[crossroi] former reuse waves {rf.reuse_waves}: launched "
        f"{rf.reuse_launched_tiles} of {rf.reuse_total_tiles} tiles")


def crossroi_obs(torch, det, grids, frames, nxt):
    """One warm step and one former release with obs off, then the same
    inputs with obs on: the same kernel launches, the same number of
    ``torch.cuda.synchronize`` calls and of implicit synchronizations (a
    copy to the host, ``.item()``: counted by torch's sync debug mode),
    bitwise-equal outputs, and ``kernel_counts()`` equal to the step's and
    the release's ``count_kernels`` Counters together.  A first pass with
    obs off, not compared, takes the one-time synchronizations (on the
    H100 one more, inside torch, than in later passes)."""
    import collections
    import warnings
    from repro_torch import obs
    from repro_torch.fleet.runtime import fleet_reuse_step
    from repro_torch.kernels import _build, ops
    from repro_torch.net.batcher import DeadlineGroupFormer
    from repro_torch.serving.detector import PackedActivationCache
    real_sync = torch.cuda.synchronize
    n_sync = [0]

    def counted_sync(*args, **kw):
        n_sync[0] += 1
        return real_sync(*args, **kw)

    cams = list(range(len(grids[0])))
    runs = {}
    torch.cuda.synchronize = counted_sync
    try:
        for label, on in (("first", False), ("off", False), ("on", True)):
            cache = PackedActivationCache()
            fleet_reuse_step(det, frames, grids, cache)     # cold, obs off
            real_sync()
            obs.configure(enabled=on, reset=True)
            n_sync[0] = 0
            before = collections.Counter(_build.LAUNCHES)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    with ops.count_kernels() as in_step:
                        outs, counts, _ = fleet_reuse_step(det, nxt, grids,
                                                           cache)
                        heads = [h.clone() for h in flat(outs)]
                    with ops.count_kernels() as in_release:
                        rel = offer_all(DeadlineGroupFormer(
                            det, cams, FORMER_DEADLINE_S), 0.0, nxt[0],
                            grids[0], cams)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            implicit = collections.Counter(
                f"{Path(w.filename).name}:{w.lineno}" for w in caught
                if "synchroniz" in str(w.message))
            real_sync()
            launches = collections.Counter(_build.LAUNCHES) - before
            mirror = obs.metrics.kernel_counts()
            spans = obs.trace.span_count()
            if on:
                out = ROOT / "build" / "crossroi_trace.json"
                out.parent.mkdir(parents=True, exist_ok=True)
                doc = obs.export.chrome_trace(str(out))
                names = collections.Counter(
                    e["name"] for e in doc["traceEvents"] if e["ph"] == "X")
            obs.configure(enabled=False, reset=True)
            assert in_step == counts
            runs[label] = (heads, [rel.outputs[c] for c in cams], launches,
                        (n_sync[0], implicit), dict(in_step + in_release),
                        mirror, spans)
    finally:
        torch.cuda.synchronize = real_sync
    (h0, r0, l0, s0, d0, m0, n0), (h1, r1, l1, s1, d1, m1, n1) = \
        runs["off"], runs["on"]
    same_bits = all(torch.equal(a, b) for a, b in zip(h0 + r0, h1 + r1))
    launched = sum(l1.values()) > 0 or not nxt[0][0].is_cuda
    # the warm step's gate copies its stats to the host: the sync debug
    # mode must see at least that one
    ok = (same_bits and launched and l0 == l1 and s0 == s1
          and sum(s0[1].values()) > 0
          and d0 == d1 and m0 == {} and n0 == 0 and m1 == d1 and n1 > 0)
    say(f"[crossroi] obs off/on, one warm step and one former release: "
        f"launches {dict(l0)} / {dict(l1)}; torch.cuda.synchronize calls "
        f"{s0[0]} / {s1[0]}, implicit synchronizations "
        f"{sum(s0[1].values())} / {sum(s1[1].values())} at {dict(s1[1])} "
        f"(the first pass {dict(runs['first'][3][1])}); "
        f"dispatches {d0} / {d1}; outputs bitwise equal "
        f"{same_bits}; kernel_counts() with obs on {m1}; spans {n0} / {n1} "
        f"({dict(names)}), Chrome trace written to build/"
        f"crossroi_trace.json: {ok}")
    assert ok


def crossroi_obs_records(torch, det, grids, frames, nxt):
    """The same warm step and former release with obs off and on under
    the profiler: equal synchronize and memcpy records, which count the
    runtime calls a launcher makes from its C code too (torch's sync
    debug mode sees only torch's own).  A first pass, not compared,
    takes the one-time work."""
    from repro_torch import obs
    from repro_torch.fleet.runtime import fleet_reuse_step
    from repro_torch.net.batcher import DeadlineGroupFormer
    from repro_torch.serving.detector import PackedActivationCache
    cams = list(range(len(grids[0])))
    recs = {}
    for label, on in (("first", False), ("off", False), ("on", True)):
        cache = PackedActivationCache()
        fleet_reuse_step(det, frames, grids, cache)          # cold, obs off
        torch.cuda.synchronize()

        def work():
            fleet_reuse_step(det, nxt, grids, cache)
            offer_all(DeadlineGroupFormer(det, cams, FORMER_DEADLINE_S),
                      0.0, nxt[0], grids[0], cams)

        obs.configure(enabled=on, reset=True)
        try:
            _, recs[label] = sync_records(torch, work)
        finally:
            obs.configure(enabled=False, reset=True)
    ok = recs["off"] == recs["on"] and sum(recs["off"].values()) > 0
    say(f"[crossroi] obs off/on under the profiler, one warm step and one "
        f"former release: synchronize and memcpy records {recs['off']} / "
        f"{recs['on']} (the first pass {recs['first']}): {ok}")
    assert ok


def crossroi_path(torch, det, dev, fleet, off):
    """Phase 3e on the card: the offline masks' tile grids, the fleet
    steps, the deadline former and obs on/off."""
    grids = crossroi_grids(fleet, off)
    n_tiles = sum(int(g.sum()) for g in flat(grids))
    shapes = sorted({g.shape for g in flat(grids)})
    say(f"[crossroi] tile grids: the offline masks expanded to {TILE}-px "
        f"tiles {shapes}: {n_tiles} active tiles (density "
        f"{n_tiles / sum(g.size for g in flat(grids)):.4f})")
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    rng = np.random.default_rng(SEED + 3)
    frames = {g.gid: [torch.randn((c.height, c.width, 3), generator=gen,
                                  device=dev) for c in g.scene.cameras]
              for g in fleet.groups}
    nxt = crossroi_steps(torch, det, grids, frames, rng, gen)
    crossroi_former(torch, det, grids, nxt, rng, gen)
    crossroi_obs(torch, det, grids, frames, nxt)
    crossroi_obs_records(torch, det, grids, frames, nxt)


def crossroi_online(fleet, off):
    """The online phase over frames 600-1200, analytic and with the
    simulated transport: host numpy, no card."""
    from repro_torch.core.pipeline import OnlineConfig
    from repro_torch.fleet import run_fleet_online
    t1 = CROSSROI_SECONDS * fleet.groups[0].scene.cfg.fps
    for transport in ("analytic", "simulated"):
        m = run_fleet_online(fleet, off.per_group,
                             OnlineConfig(transport=transport),
                             CROSSROI_PROFILE, t1)
        if m.transport is not None:
            tail = (f"p50 {m.transport.p50_s:.4f} s, p99 "
                    f"{m.transport.p99_s:.4f} s over "
                    f"{m.transport.latency_s.size} frames")
        else:
            tail = "p50/p99: one analytic latency per group"
        say(f"[crossroi] run_fleet_online {transport} (host numbers, "
            f"frames {CROSSROI_PROFILE}-{t1}): accuracy_mean "
            f"{m.accuracy_mean:.4f} min {m.accuracy_min:.4f}, "
            f"network_mbps_total {m.network_mbps_total:.3f}, latency_max_s "
            f"{m.latency_max_s:.4f}, {tail}; host {m.wall_s:.3f} s")
        assert 0.0 < m.accuracy_min <= m.accuracy_mean <= 1.0
        assert np.isfinite(m.network_mbps_total) and \
            m.network_mbps_total > 0
        assert np.isfinite(m.latency_max_s) and m.latency_max_s > 0


# ---------------------------------------------------------------------------
# phase 3g: CrossRoI's harnesses on the card, on the offline masks
# ---------------------------------------------------------------------------

HARNESS_STEPS = 6
HARNESS_STATIC = 0.75          # 5 of the 20 cameras move each step
# the paper's >99% accuracy target as the drift adapter's coverage target:
# on group 0 (uniform 21) over frames 600-800 the windowed coverage of the
# exact cover's mask dips below it once (it stays above the default 0.95)
DRIFT_GROUP, DRIFT_FRAMES, DRIFT_TARGET = 0, (600, 800), 0.99
SWEEP_POINT = (4, 5, "episode:0.5", 0.75, "random:3:0")
# a scripted chaos drive: a frozen camera, a noisy one, a dark one
CHAOS_EVENTS = (("freeze", 1, 5, 0, 1, 1.0), ("noise", 2, 4, 1, 2, 1.5),
                ("blackout", 1, 6, 2, 0, 1.0))
CHAOS_CHECK_STEP = 2           # every fault above is active here
SYNC_RECORDS = ("cudaStreamSynchronize", "cudaDeviceSynchronize")


def sync_records(torch, fn):
    """``fn()`` under the profiler; returns its result and the counts of
    the profiler's synchronize and memcpy records ({name: count}): the
    runtime calls a launcher makes from C are recorded too."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, {e.key: e.count for e in prof.key_averages()
                 if e.key in SYNC_RECORDS or e.key.startswith("cudaMemcpy")}


def harness_trace(torch, dev, grids):
    """``make_frame_trace`` on the offline masks' tile grids (frames of
    the grids' extent), moved to the card once."""
    from repro_torch.obs.loadgen import LoadgenConfig, make_frame_trace
    cfg = LoadgenConfig(tile=TILE, steps=HARNESS_STEPS, seed=SEED)
    t0 = time.perf_counter()
    host = make_frame_trace(cfg, grids, HARNESS_STATIC)
    t_host = time.perf_counter() - t0
    frames = [{g: [torch.as_tensor(f, device=dev) for f in fs]
               for g, fs in step.items()} for step in host]
    torch.cuda.synchronize()
    say(f"[3g loadgen] make_frame_trace: {HARNESS_STEPS} steps, static "
        f"fraction {HARNESS_STATIC}, frames of the grids' extent "
        f"{sorted({tuple(f.shape) for f in flat(frames[0])})}: {t_host:.2f} "
        f"s on the host, {time.perf_counter() - t0 - t_host:.2f} s to the "
        f"card")
    return cfg, frames


def same_maps(torch, a, b):
    return list(a) == list(b) and all(
        torch.equal(x, y) for g in b for x, y in zip(a[g], b[g]))


def harness_drive(torch, det, grids, frames):
    """``drive_fleet`` against an inline ``fleet_reuse_step`` loop: equal
    dispatch counters and profiler synchronize/memcpy records; its kept
    maps bitwise equal to a cold ``superlaunch_forward`` of each step's
    frames, the last within 1e-4 of the plain composition.  Returns the
    drive's dispatch counter and its kept maps."""
    import collections
    from repro_torch.fleet.runtime import fleet_reuse_step
    from repro_torch.obs.loadgen import drive_fleet
    from repro_torch.serving.detector import PackedActivationCache

    def inline():
        cache, total = PackedActivationCache(), collections.Counter()
        for fs in frames:
            total += fleet_reuse_step(det, fs, grids, cache)[1]
        return total

    def driven():
        return drive_fleet(det, frames, grids, PackedActivationCache())

    inline()                           # uncompared: one-time work
    want, rec_inline = sync_records(torch, inline)
    (reports, _, counts), rec_drive = sync_records(torch, driven)
    ok = (counts == want and rec_drive == rec_inline
          and sum(rec_inline.values()) > 0)
    say(f"[3g loadgen] drive_fleet == an inline fleet_reuse_step loop: "
        f"dispatches {dict(counts)} / {dict(want)}; the profiler's "
        f"synchronize and memcpy records {rec_drive} / {rec_inline}: {ok}")
    assert ok

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reports, kept, counts = drive_fleet(det, frames, grids,
                                        PackedActivationCache(),
                                        keep_outputs=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    walls = [r.wall_s * 1e3 for r in reports]
    same = [same_maps(torch, k, det.superlaunch_forward(fs, grids))
            for k, fs in zip(kept, frames)]
    err = plain_err(torch, det, frames[-1], grids, kept[-1])
    say(f"[3g loadgen] drive_fleet, kept maps: step host walls ms "
        f"{np.round(walls, 3).tolist()} (sum {sum(walls):.3f}), the drive "
        f"with its copies bounded by one synchronize {wall * 1e3:.3f} ms; "
        f"computed tiles {[r.computed_tiles for r in reports]} of "
        f"{reports[0].total_tiles}; kept maps == a cold superlaunch_forward "
        f"of their frames, bitwise: {same}; last step vs plain composition: "
        f"max_abs_err={err}")
    assert all(same) and err <= CONV_TOL, err
    assert [r.cold for r in reports] == [True] + [False] * (len(frames) - 1)
    return counts, kept


def harness_chaos(torch, det, grids, frames, counts, kept):
    """``drive_chaos``: with no schedule it is ``drive_fleet`` (maps
    bitwise, counts equal); with a scripted freeze, noise and blackout
    and a liveness monitor, one faulted step's gate stats (B1's) equal
    the plain gate on the injected frames, bitwise."""
    from repro_torch.fleet import faults, runtime
    from repro_torch.kernels import ref
    from repro_torch.serving.detector import PackedActivationCache
    _, got, total, det_none = faults.drive_chaos(
        det, frames, grids, PackedActivationCache(), keep_outputs=True)
    same = [same_maps(torch, a, b) for a, b in zip(got, kept)]
    say(f"[3g chaos] drive_chaos with no schedule == drive_fleet: maps "
        f"bitwise {same}, dispatches equal {total == counts}")
    assert all(same) and total == counts and det_none == {}
    del got

    schedule = faults.FaultSchedule(tuple(
        faults.FaultEvent(k, t0, t1, gid=g, cam=c, amp=a)
        for k, t0, t1, g, c, a in CHAOS_EVENTS))
    n_cams = len(flat(grids))
    monitor = faults.LivenessMonitor(
        n_cams, faults.LivenessConfig(freeze_window=2,
                                      min_expected_rate=0.1))
    stats_seen, real_step = [], runtime.fleet_reuse_step

    def recording_step(*args, **kw):     # keeps each step's gate stats
        out = real_step(*args, **kw)
        stats_seen.append(out[2].gate_stats)
        return out

    cache = PackedActivationCache()
    runtime.fleet_reuse_step = recording_step
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        reports, _, total, detections = faults.drive_chaos(
            det, frames, grids, cache, schedule=schedule, monitor=monitor,
            seed=SEED)
    finally:
        runtime.fleet_reuse_step = real_step
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    inj = faults.FaultInjector(schedule, seed=SEED)
    injected = [inj.apply(i, fs) for i, fs in enumerate(
        frames[:CHAOS_CHECK_STEP + 1])]
    cur_p, prev_p = (torch.nn.functional.pad(
        det._stack_frames(flat(f), flat(grids))[0], (0, 0, 1, 1, 1, 1))
        for f in (injected[-1], injected[-2]))
    want = ref.tile_delta_gate_canvas(
        cur_p, prev_p, det._fleet_tables(flat(grids))[2], TILE, TILE)
    gate_same = np.array_equal(stats_seen[CHAOS_CHECK_STEP],
                               want.cpu().numpy())
    del cur_p, prev_p, want, injected
    per_cam = faults.per_camera_changed(stats_seen[CHAOS_CHECK_STEP], 0.0,
                                        cache.idx_np[:, 0], n_cams)
    flat_of = faults.flat_cam_index(grids)
    at = {k: flat_of[(g, c)] for k, _, _, g, c, _ in CHAOS_EVENTS}
    say(f"[3g chaos] scripted faults {CHAOS_EVENTS} (kind, t0, t1, group, "
        f"camera, amplitude): step {CHAOS_CHECK_STEP}'s gate stats == the "
        f"plain gate on the injected frames, bitwise: {gate_same}; its "
        f"changed tiles per camera {per_cam.tolist()}; raw-changed tiles "
        f"per step {[r.changed_tiles for r in reports]}; detections "
        f"{detections}, confirmed dead {sorted(monitor.confirmed)} (flat "
        f"camera index of each fault {at}); dispatches {dict(total)}; "
        f"injected steps {inj.injected_steps}; step host walls ms "
        f"{np.round([r.wall_s * 1e3 for r in reports], 3).tolist()}, the "
        f"drive (injection included) bounded by one synchronize "
        f"{wall * 1e3:.3f} ms")
    assert gate_same and len(stats_seen) == HARNESS_STEPS
    # frozen and dark cameras repeat their last clean frame: no change
    assert per_cam[at["freeze"]] == 0 and per_cam[at["blackout"]] == 0
    assert per_cam[at["noise"]] > 0


def harness_drift(torch, det, fleet, off, grids, frames):
    """``run_adaptive_online`` on one group of phase 3e's scene with the
    activation cache wired as a mask listener: the re-solve invalidates
    it, and the next fleet step, cold on the re-solved grids, equals a
    cold recompute bitwise and the plain composition within 1e-4."""
    from repro_torch.fleet import DriftConfig, run_adaptive_online
    from repro_torch.fleet.runtime import fleet_reuse_step
    from repro_torch.serving.detector import PackedActivationCache
    cache = PackedActivationCache()
    fleet_reuse_step(det, frames[0], grids, cache)
    fleet_reuse_step(det, frames[1], grids, cache)
    before = cache.invalidations
    g = fleet.groups[DRIFT_GROUP]
    t0 = time.perf_counter()
    res = run_adaptive_online(g.scene, off.per_group[DRIFT_GROUP],
                              *DRIFT_FRAMES,
                              DriftConfig(coverage_target=DRIFT_TARGET),
                              listeners=[lambda _: cache.invalidate()])
    host_s = time.perf_counter() - t0
    ad = res.adapter
    k = g.scene.cameras[0].tile // TILE
    new = dict(grids)
    new[DRIFT_GROUP] = [np.kron(ad.cam_grids[c.cam_id], np.ones((k, k), bool))
                        for c in g.scene.cameras]
    added = sum(int(a.sum()) - int(b.sum())
                for a, b in zip(new[DRIFT_GROUP], grids[DRIFT_GROUP]))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    outs, counts, stats = fleet_reuse_step(det, frames[2], new, cache)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t1) * 1e3
    same, fc = equals_recompute(torch, det, frames[2], new, outs)
    err = plain_err(torch, det, frames[2], new, outs)
    ev = [(e.t, e.tiles_added, e.constraints, round(e.coverage_before, 4),
           round(e.wall_s, 4)) for e in ad.events]
    say(f"[3g drift] run_adaptive_online, group {DRIFT_GROUP} frames "
        f"{DRIFT_FRAMES[0]}-{DRIFT_FRAMES[1]}, coverage target "
        f"{DRIFT_TARGET}: re-solves (frame, cells added, constraints, "
        f"coverage before, host s) {ev}; |M| "
        f"{len(off.per_group[DRIFT_GROUP].mask)} -> {len(ad.mask)} cells "
        f"({added} more {TILE}-px tiles); the "
        f"driver's host wall {host_s:.3f} s; cache invalidations {before} "
        f"-> {cache.invalidations}; the next step: cold {stats.cold}, "
        f"first-step wall {first_ms:.3f} ms (tables built for the new "
        f"grids), dispatches {dict(counts)}; == a cold recompute bitwise "
        f"{same} (recompute counts {fc}); vs plain composition "
        f"max_abs_err={err}")
    assert res.resolves >= 1 and cache.invalidations == before + \
        res.resolves + ad.shrinks
    assert stats.cold and added > 0 and same and err <= CONV_TOL, err


def harness_point(torch, det, cfg, grids, frames, counts):
    """``run_point`` at one sweep point on the card's trace: its
    dispatches equal the drive's; prints its SLO panel."""
    from repro_torch.obs.loadgen import SweepPoint, run_point
    t0 = time.perf_counter()
    res = run_point(cfg, det, SweepPoint(*SWEEP_POINT), grids=grids,
                    frames_list=frames)
    wall = time.perf_counter() - t0
    say(f"[3g sweep] run_point {res['point']} in {wall:.2f} s (host): "
        f"drive_wall_s {res['drive_wall_s']:.4f}, dispatches "
        f"{res['dispatches']} == the drive's {res['dispatches'] == counts}, "
        f"faults {res.get('faults')}; slo {json.dumps(res['slo'])}")
    assert res["dispatches"] == dict(counts)
    slo = res["slo"]
    assert slo["n_steps"] == HARNESS_STEPS and \
        0.0 < slo["accuracy_floor"] <= slo["accuracy_mean"] <= 1.0
    assert np.isfinite(slo["p99_delay_s"]) and slo["p99_delay_s"] > 0


def harness_path(torch, det, dev, fleet, off):
    """Phase 3g on the card: the drivers, chaos, drift and a sweep point
    over the offline masks' tile grids, and the sentinel's self-test."""
    from repro_torch.obs import sentinel
    t0 = time.perf_counter()
    grids = crossroi_grids(fleet, off)
    cfg, frames = harness_trace(torch, dev, grids)
    counts, kept = harness_drive(torch, det, grids, frames)
    harness_chaos(torch, det, grids, frames, counts, kept)
    del kept
    torch.cuda.empty_cache()
    harness_drift(torch, det, fleet, off, grids, frames)
    harness_point(torch, det, cfg, grids, frames, counts)
    st = sentinel.self_test()
    say(f"[3g sentinel] self_test: {st}")
    assert all(v for k, v in st.items() if k != "flagged_metrics")
    say(f"[3g] harness phase: {time.perf_counter() - t0:.1f} s")
    return grids, frames


# ---------------------------------------------------------------------------
# phase 3h: CrossRoI's sharded fleet runtime on the card
# ---------------------------------------------------------------------------

SHARD_COUNTS = (1, 2, 4)
PIPE_SHARDS, PIPE_QUEUED = 2, 3
DRIFT_SHARDS = 4               # each group on its own shard
LOSS_SHARDS, LOST_SHARD = 4, 1
SHARDED_KERNELS = ("tile_delta_gate_canvas", "roi_conv_entry",
                   "roi_conv_stack", "sbnet_scatter_fleet")
# B12 at blocks the kernel has no instance for (C1): (S, bq, bk) on
# synthetic streams, then the serving slice's positions at two more
C1_CASES = ((96, 16, 48), (512, 256, 16), (192, 96, 64))
C1_SLICE_BLOCKS = ((16, 16), (256, 128))


def sharded_runtime(det, dev, grids, n_shards):
    from repro_torch.fleet.sharded import ShardedSuperlaunch
    from repro_torch.launch.mesh import make_fleet_mesh
    return ShardedSuperlaunch(det, grids, make_fleet_mesh(
        n_shards, devices=[dev]))


def sharded_expected(stats):
    if stats.k_max == 0:
        return {"tile_delta_gate": 1}
    return {"tile_delta_gate": 1, "roi_conv_entry": 1, "roi_conv_stack": 1,
            "sbnet_scatter_changed": 1}


def sharded_steps(torch, det, dev, grids, frames, n_shards):
    """``sharded_fleet_step`` at ``n_shards`` shards on the one card
    beside the single-device ``superlaunch_forward_reuse``, step by step:
    maps bitwise equal, dispatches and kernel launches one of each kernel
    a step; ``step_full`` == ``superlaunch_forward``; the cold maps within
    1e-4 of the plain composition.  Returns the per-step walls (host
    clock ending in a synchronize) of both."""
    from repro_torch.fleet.runtime import sharded_fleet_step
    from repro_torch.kernels import _build
    from repro_torch.serving.detector import PackedActivationCache
    t0 = time.perf_counter()
    rt = sharded_runtime(det, dev, grids, n_shards)
    t_build = time.perf_counter() - t0
    cache, pcache = rt.make_cache(), PackedActivationCache()
    walls, walls_1, kinds, same, err = [], [], [], [], None
    for i, f in enumerate(frames):
        torch.cuda.synchronize()
        a = time.perf_counter()
        want, _ = det.superlaunch_forward_reuse(f, grids, pcache)
        torch.cuda.synchronize()
        b = time.perf_counter()
        before = dict(_build.LAUNCHES)
        got, counts, stats = sharded_fleet_step(rt, f, cache)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - b) * 1e3)
        walls_1.append((b - a) * 1e3)
        launched = {k: _build.LAUNCHES[k] - before.get(k, 0)
                    for k in _build.LAUNCHES
                    if _build.LAUNCHES[k] != before.get(k, 0)}
        want_launch = {k: 1 for k in SHARDED_KERNELS} if stats.k_max \
            else {"tile_delta_gate_canvas": 1}
        assert dict(counts) == sharded_expected(stats), counts
        assert launched == want_launch, launched
        same.append(same_maps(torch, got, want))
        kinds.append("cold" if stats.cold else
                     "static" if stats.k_max == 0 else "warm")
        if i == 0:
            err = plain_err(torch, det, f, grids, got)
    full = rt.step_full(frames[0])
    full_same = same_maps(torch, full, det.superlaunch_forward(frames[0],
                                                               grids))
    say(f"[3h S={n_shards}] shard tiles {rt.plan.shard_tiles.tolist()} "
        f"(imbalance {rt.plan.imbalance:.4f}), n_max {rt.n_max}, F_max "
        f"{rt.F_max}, tables {t_build:.3f} s; steps {kinds}; == "
        f"superlaunch_forward_reuse bitwise {same}; one launch of each "
        f"kernel a step: True; step_full == superlaunch_forward bitwise "
        f"{full_same}; cold vs plain composition max_abs_err={err}; walls "
        f"ms sharded {np.round(walls, 3).tolist()}, single-device "
        f"{np.round(walls_1, 3).tolist()}")
    assert all(same) and full_same and err <= CONV_TOL, err
    assert kinds[0] == "cold" and kinds[-1] == "static" and \
        "warm" in kinds
    del cache, pcache, full
    return rt


def sharded_pipeline(torch, det, dev, grids, frames):
    """``AsyncShardedPipeline`` at ``PIPE_SHARDS`` shards with
    ``PIPE_QUEUED`` submits before the first collect: every collected
    map bitwise equal to the synchronous step's; its overlap, consumer
    wait and p99 latency; the profiler's synchronize and memcpy records
    of the same drive."""
    from repro_torch.fleet.sharded import AsyncShardedPipeline
    from repro_torch.obs.loadgen import kept_maps
    rt = sharded_runtime(det, dev, grids, PIPE_SHARDS)
    cache = rt.make_cache()
    want = [kept_maps(rt.step_reuse(f, cache)[0]) for f in frames]

    def drive():
        pipe = AsyncShardedPipeline(rt, rt.make_cache())
        for f in frames[:PIPE_QUEUED]:
            pipe.submit(f)
        outs = [pipe.collect()]
        for f in frames[PIPE_QUEUED:]:
            pipe.submit(f)
        return pipe, outs + pipe.drain()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe, outs = drive()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    same = [same_maps(torch, got, w) for (_, got, _), w in zip(outs, want)]
    del outs
    (pipe2, _), rec = sync_records(torch, drive)
    say(f"[3h pipeline] S={PIPE_SHARDS}, {PIPE_QUEUED} submits before the "
        f"first collect: collected maps == the synchronous steps bitwise "
        f"{same}; overlap_fraction {pipe.overlap_fraction:.4f}, blocked_s "
        f"{pipe.blocked_s:.6f}, p99_latency_s {pipe.p99_latency_s:.6f}, "
        f"host planning {pipe.host_s:.6f} s, the drive {wall:.3f} ms "
        f"bounded by one synchronize; under the profiler overlap "
        f"{pipe2.overlap_fraction:.4f}, synchronize and memcpy records "
        f"{rec}")
    assert all(same) and len(same) == len(frames)
    assert pipe.overlap_fraction > 0.5


def sharded_drift(torch, det, dev, fleet, off, grids, frames):
    """``wire_shard_invalidation`` on phase 3g's group-0 re-solve, with
    ``rebuild_group`` on the re-solved grids at ``TILE``-px tiles: only
    the owning shard goes cold, the other shards compute 0 tiles on their
    held frames, and every map equals a cold recompute on the new grids
    bitwise."""
    from repro_torch.fleet import DriftConfig, wire_shard_invalidation
    from repro_torch.fleet.drift import DriftAdapter
    from repro_torch.fleet.runtime import sharded_fleet_step
    rt = sharded_runtime(det, dev, grids, DRIFT_SHARDS)
    cache = rt.make_cache()
    sharded_fleet_step(rt, frames[0], cache)
    sharded_fleet_step(rt, frames[1], cache)
    g = fleet.groups[DRIFT_GROUP]
    k = g.scene.cameras[0].tile // TILE
    ad = DriftAdapter(g.scene, off.per_group[DRIFT_GROUP],
                      DriftConfig(coverage_target=DRIFT_TARGET))
    # the adapter's grids are its 64-px cells and the runtime's the
    # detector's tiles: invalidation is wired as it is, the rebuild with
    # the cells expanded to tiles
    wire_shard_invalidation({DRIFT_GROUP: ad}, cache)

    def rebuild(a):
        rt.rebuild_group(DRIFT_GROUP, [
            np.kron(a.cam_grids[c.cam_id], np.ones((k, k), bool))
            for c in a.cameras], cache=cache)

    ad.add_mask_listener(rebuild)
    t0 = time.perf_counter()
    for t in range(*DRIFT_FRAMES):         # run_adaptive_online's stream
        ad.observe(t, g.scene.detections[t])
    host_s = time.perf_counter() - t0
    res = ad
    owner = cache.owner_shard(DRIFT_GROUP)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    got, counts, stats = sharded_fleet_step(rt, frames[1], cache)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t1) * 1e3
    new = rt.grids
    want = det.superlaunch_forward(frames[1], new)
    same = same_maps(torch, got, want)
    others = [c for s, c in enumerate(stats.per_shard_computed)
              if s != owner]
    say(f"[3h drift] group {DRIFT_GROUP} re-solved {res.resolves} time(s) "
        f"({host_s:.3f} s host), owned by shard {owner} of {DRIFT_SHARDS}; "
        f"shard invalidations {cache.shard_invalidations.tolist()}; the "
        f"next step: cold shards {stats.cold_shards}, computed per shard "
        f"{stats.per_shard_computed}, dispatches {dict(counts)}, wall "
        f"{first_ms:.3f} ms; == a cold superlaunch_forward on the new "
        f"grids bitwise {same}")
    assert res.resolves >= 1 and stats.cold_shards == 1
    assert cache.shard_invalidations[owner] >= 1 and \
        cache.shard_invalidations.sum() == cache.shard_invalidations[owner]
    assert same and all(c == 0 for c in others), others


def sharded_loss(torch, det, dev, grids, frames):
    """``drive_chaos_sharded``: with no schedule it is ``drive_sharded``;
    a loss of shard ``LOST_SHARD`` at step 2 (``shard_failover``) colds
    that shard alone, the others compute 0 tiles on held frames, and
    every map equals a cold recompute bitwise."""
    from repro_torch.fleet import faults
    from repro_torch.obs.loadgen import drive_sharded
    held = [frames[0], frames[1], frames[1]]
    rt = sharded_runtime(det, dev, grids, LOSS_SHARDS)
    _, plain, plain_tot = drive_sharded(rt, held, rt.make_cache(),
                                        keep_outputs=True)
    _, none, none_tot, none_lost = faults.drive_chaos_sharded(
        rt, held, rt.make_cache(), keep_outputs=True)
    same_none = [same_maps(torch, a, b) for a, b in zip(none, plain)]
    del none
    schedule = faults.FaultSchedule((faults.FaultEvent(
        "shard", 2, 3, shard=LOST_SHARD),))
    reps, outs, tot, lost = faults.drive_chaos_sharded(
        rt, held, rt.make_cache(), schedule=schedule, keep_outputs=True)
    st = reps[2]
    want = det.superlaunch_forward(held[2], grids)
    same = same_maps(torch, outs[2], want)
    say(f"[3h shard loss] drive_chaos_sharded with no schedule == "
        f"drive_sharded: maps {same_none}, dispatches "
        f"{none_tot == plain_tot}; shard {LOST_SHARD} of {LOSS_SHARDS} "
        f"lost at step 2: groups {lost}; that step computed "
        f"{st.computed_tiles} tiles (shard {LOST_SHARD}'s "
        f"{rt.plan.shard_tiles[LOST_SHARD]}), dispatches {st.dispatches}; "
        f"== a cold recompute bitwise {same}")
    assert all(same_none) and none_tot == plain_tot and none_lost == {}
    assert lost == {2: rt.groups_on_shard(LOST_SHARD)} and st.cold
    assert st.computed_tiles == rt.plan.shard_tiles[LOST_SHARD] and same


def sharded_drivers(torch, det, dev, grids, frames):
    """``drive_sharded`` against ``drive_fleet``: kept maps bitwise equal
    at every step; the dispatches equal on every warm step, and on the
    cold step the sharded one's are the single-device cold step's plus
    the gate, its scatter counted as the changed-only one."""
    from repro_torch.obs.loadgen import drive_fleet, drive_sharded
    from repro_torch.serving.detector import PackedActivationCache
    rt = sharded_runtime(det, dev, grids, PIPE_SHARDS)
    srep, souts, stot = drive_sharded(rt, frames, rt.make_cache(),
                                      keep_outputs=True)
    frep, fouts, ftot = drive_fleet(det, frames, grids,
                                    PackedActivationCache(),
                                    keep_outputs=True)
    same = [same_maps(torch, a, b) for a, b in zip(souts, fouts)]
    del souts, fouts
    cold = dict(frep[0].dispatches)
    cold["tile_delta_gate"] = 1
    cold["sbnet_scatter_changed"] = cold.pop("sbnet_scatter_fleet")
    disp = [srep[0].dispatches == cold] + [
        a.dispatches == b.dispatches for a, b in zip(srep[1:], frep[1:])]
    say(f"[3h drivers] drive_sharded (S={PIPE_SHARDS}) vs drive_fleet: "
        f"kept maps bitwise {same}; dispatches per step as the "
        f"single-device step's (the cold step plus the gate) {disp}; "
        f"totals {dict(stot)} / {dict(ftot)}; step host walls ms "
        f"{np.round([r.wall_s * 1e3 for r in srep], 3).tolist()} / "
        f"{np.round([r.wall_s * 1e3 for r in frep], 3).tolist()}")
    assert all(same) and all(disp)


def c1_blocks(torch, dev, grids):
    """C1: B12 at blocks the kernel has no instance for, bf16: real rows
    within the bars of the plain version at those blocks, bitwise equal
    to ``kernel_blocks``' instance on the tokens padded to it, visited
    counts == the host bound; on synthetic streams and on the serving
    slice's positions (48 heads of 128)."""
    from repro_torch.kernels import ops, roi_attention
    PAD = roi_attention.PAD_POS
    rng = np.random.default_rng(SEED + 9)
    keep = fleet_keep(grids)
    _, slice_pos, _ = ops.pack_tokens(
        torch.zeros((keep.shape[0], 1)), torch.as_tensor(keep))
    cases = []
    for S, bq, bk in C1_CASES:
        pos = np.full(S, PAD, np.int32)
        n = int(0.7 * S)
        pos[:n] = np.sort(rng.choice(4 * S, n, replace=False))
        cases.append((S, 4, 64, bq, bk, pos))
    for bq, bk in C1_SLICE_BLOCKS:
        cases.append((FLEET_PACKED, SLICE_HEADS, SLICE_HEAD_DIM, bq, bk,
                      slice_pos.numpy()))
    lines = []
    for S, H, D, bq, bk, pos in cases:
        errs, skip_same, vis_ok, (q, k, v, p, out, _) = attention_case(
            torch, dev, S, H, D, bq, bk, pos, torch.bfloat16, SEED + S)
        kq, kk = roi_attention.kernel_blocks(bq, bk)
        lcm = int(np.lcm(kq, kk))
        Sp = -(-S // lcm) * lcm
        pad = [torch.nn.functional.pad(t, (0, 0, 0, 0, 0, Sp - S))
               for t in (q, k, v)]
        pp = torch.nn.functional.pad(p, (0, Sp - S), value=PAD)
        direct, _ = roi_attention.roi_attention(*pad, pp, kq, kk)
        real = p != PAD
        direct_same = bool(torch.equal(out[real], direct[:S][real]))
        lines.append((S, H, bq, bk, (kq, kk, Sp), errs[0], round(errs[1], 4),
                      skip_same, vis_ok, direct_same))
        assert errs[0] <= ATTN_TOL["bfloat16"] and errs[1] <= 1.0, errs
        assert skip_same and vis_ok and direct_same
    say(f"[3h C1] B12 at blocks outside BLOCKS_Q {roi_attention.BLOCKS_Q} "
        f"(bf16; S, H, block_q, block_k, the instance run (block_q, "
        f"block_k, padded S), max err, share of the per-element bar, skip "
        f"== exhaustive, visited == host bound, == the instance's launch "
        f"bitwise): {lines}")


def sharded_path(torch, det, dev, fleet, off, grids, frames):
    """Phase 3h on the card: the sharded runtime at 1, 2 and 4 shards on
    phase 3e's masks over phase 3g's trace plus an all-static step, the
    async pipeline, a drift re-solve, a shard loss, the drivers, and
    B12's C1 blocks."""
    t0 = time.perf_counter()
    trace = list(frames) + [frames[-1]]
    for n in SHARD_COUNTS:
        sharded_steps(torch, det, dev, grids, trace, n)
        torch.cuda.empty_cache()
    sharded_pipeline(torch, det, dev, grids, trace)
    torch.cuda.empty_cache()
    sharded_drift(torch, det, dev, fleet, off, grids, frames)
    sharded_loss(torch, det, dev, grids, frames)
    torch.cuda.empty_cache()
    sharded_drivers(torch, det, dev, grids, frames)
    torch.cuda.empty_cache()
    c1_blocks(torch, dev, grids)
    say(f"[3h] sharded phase: {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 3i: the windowed, local/global and MoE decoders on the serving path
# ---------------------------------------------------------------------------

# (arch, depth or None for full, dense prompt length): the dense prompts
# are longer than the window (4,096 for h2o, 1,024 for gemma3's local
# layers); qwen3-moe-235b-a22b's 94 layers are 437.9 GiB of bf16, so it
# runs at full width and 4 layers
DECODERS = (("h2o-danube3-4b", None, 4608), ("gemma3-27b", None, 1536),
            ("deepseek-moe-16b", None, 1024),
            ("qwen3-moe-235b-a22b", 4, 1024))
DECODER_STEPS = 16             # greedy steps served and teacher-forced
DECODER_KEEP = 0.5             # the keep-list requests' kept share
IDENTITY_REL_TOL = PRUNED_REL_TOL   # of the largest |logit|, as phase 3f


def decoder_prompts(cfg, dense_len):
    """Two dense prompts of ``dense_len`` token ids and two keep-list
    prompts no longer than the window (packed, at most the window: the
    packed-prompt ring of ROADMAP C-R4 stays out), from the seed."""
    rng = np.random.default_rng((SEED, 300))
    roi_len = min(cfg.window_size or dense_len, dense_len)
    out = []
    for i, n in enumerate((dense_len, roi_len, dense_len, roi_len)):
        keep = rng.random(n) < DECODER_KEEP if i % 2 else None
        out.append((rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                    keep))
    return out


def teacher_prefill(torch, M, params, cfg, toks):
    """The logits of a fresh prefill of ``toks`` at its last row, the
    tokens padded to a multiple of 128 with ``PAD_POS`` rows (which no
    real row sees) so that the KV chunks and query blocks stay whole."""
    from repro_torch.kernels import ops
    packed, positions, n = ops.pack_tokens(
        toks, torch.ones_like(toks, dtype=torch.bool))
    logits, _ = M.prefill(params, cfg, {"tokens": packed[None]}, None,
                          positions=positions[None], last_index=n - 1)
    return logits[0, -1].float()


@contextlib.contextmanager
def routing_tape(torch, forced=None, row=None):
    """Patch ``models.moe.router_topk`` while the block runs.  Yields a
    list with one dict a call: the call's own top-k indices (``idx``)
    and, with ``row``, that row's MoE input (``x``) and top-(k + 1)
    probabilities (``top``).  Where ``forced`` (one entry a call, in
    call order) holds a (B, n, k) index tensor, rows [0, n) take those
    experts, weighted by the call's own probabilities renormalised, as
    ``router_topk`` weights its own choice."""
    from repro_torch.models import moe
    orig = moe.router_topk
    tape = []

    def topk(x, router_w, k, dist=None):
        vals, idx, aux = orig(x, router_w, k, dist)
        rec = {"idx": idx}
        f = None if forced is None else forced[len(tape)]
        if row is not None or f is not None:
            probs = torch.softmax(torch.einsum(
                "bsd,de->bse", x.float(), router_w.float()), dim=-1)
        if row is not None:
            rec["x"] = x[0, row].float()
            rec["top"] = probs[0, row].topk(k + 1).values
        if f is not None:
            n = f.shape[1]
            v = probs[:, :n].gather(-1, f)
            vals, idx = vals.clone(), idx.clone()
            vals[:, :n] = v / torch.clamp_min(v.sum(dim=-1, keepdim=True),
                                              1e-9)
            idx[:, :n] = f
        tape.append(rec)
        return vals, idx, aux

    moe.router_topk = topk
    try:
        yield tape
    finally:
        moe.router_topk = orig
    assert forced is None or len(tape) == len(forced), (len(tape),
                                                        len(forced))


def same_experts(a, b):
    """Equal expert sets along the last dim (top-k order aside)."""
    return bool((a.sort(dim=-1).values == b.sort(dim=-1).values).all())


def decode_identity(torch, dev, M, params, cfg, prompt, force=False):
    """Prefill ``prompt`` into fresh caches, greedy-decode DECODER_STEPS
    tokens, and hold each step's logits against a fresh prefill of the
    prompt and the tokens so far.  Returns a dict: ``shares``, each
    step's largest error as a share of that step's max |logit|;
    ``scale``, the largest |logit|; ``shapes``, the caches'.  A MoE
    model adds ``flips``, each step's count of MoE layers whose top-k for
    the new token differs between the decode and the fresh prefill;
    ``first``, per step, the first such layer's (index, decode's margin
    between its k-th and (k+1)-th probability, that layer's input
    difference as a share of its largest |x|, the same share at the first
    MoE layer), or None; ``prompt_flips``, the (row, layer) pairs of the
    prompt that the fresh prefill routes otherwise than the prompt's own
    prefill did.  With ``force``, each step also runs the fresh prefill
    with every real row routed as the decode path routed it (the prompt
    as its prefill, each new token as its decode step): ``forced``, those
    steps' shares."""
    S = prompt.shape[0]
    K = cfg.experts_per_token
    toks = torch.as_tensor(prompt, dtype=torch.long, device=dev)
    caches = M.init_cache(cfg, 1, S + DECODER_STEPS, dev)
    with routing_tape(torch) as tape:
        logits, _ = M.prefill(params, cfg, {"tokens": toks[None]}, caches)
    routed = [r["idx"] for r in tape]             # per MoE layer (1, S, K)
    out = {"shares": [], "flips": [], "first": [], "forced": []}
    scale = 0.0
    for i in range(DECODER_STEPS):
        tok = logits[0, -1].argmax().reshape(1, 1)
        toks = torch.cat([toks, tok[0]])
        with routing_tape(torch, row=0) as dec:
            logits, _ = M.decode_step(params, cfg, tok, caches, S + i)
        got = logits[0, -1].float()
        assert torch.isfinite(got).all()
        row = len(toks) - 1
        with routing_tape(torch, row=row) as tea:
            want = teacher_prefill(torch, M, params, cfg, toks)
        s = float(want.abs().max())
        scale = max(scale, s)
        out["shares"].append(float((got - want).abs().max()) / s)
        if not dec:
            continue
        if i == 0:
            out["prompt_flips"] = sum(
                int((t["idx"][0, :S].sort(dim=-1).values
                     != p["idx"][0].sort(dim=-1).values).any(dim=-1).sum())
                for t, p in zip(tea, tape))
        flipped = [j for j, (d, t) in enumerate(zip(dec, tea))
                   if not same_experts(d["idx"][0, 0], t["idx"][0, row])]
        out["flips"].append(len(flipped))

        def gap(j):
            x = dec[j]["x"]
            return float((x - tea[j]["x"]).abs().max() / x.abs().max())

        if flipped:
            j = flipped[0]
            top = dec[j]["top"]
            out["first"].append((j, float(top[K - 1] - top[K]), gap(j),
                                 gap(0)))
        else:
            out["first"].append(None)
        routed = [torch.cat([r, d["idx"]], dim=1)
                  for r, d in zip(routed, dec)]
        if force:
            with routing_tape(torch, forced=routed):
                want = teacher_prefill(torch, M, params, cfg, toks)
            out["forced"].append(float((got - want).abs().max())
                                 / float(want.abs().max()))
    out["scale"] = scale
    out["shapes"] = {k: tuple(v[0].shape) for k, v in caches.items()}
    return out


def fmt(xs):
    return "[" + ", ".join(f"{x:.3g}" for x in xs) + "]"


def fmt_first(first):
    return "[" + ", ".join(
        "-" if f is None else
        f"(layer {f[0]}, margin {f[1]:.2e}, input {f[2]:.2e}; first "
        f"{f[3]:.2e})" for f in first) + "]"


def moe_layer_stats(torch, dev, F, params, cfg, prompt):
    """The served config's prefill of ``prompt``, layer by layer: each MoE
    layer's dropped share and aux loss."""
    x = F._embed(params, cfg, torch.as_tensor(prompt, device=dev)[None])
    rope = F._rope(cfg, x.shape[1], device=dev)
    dense = F._sub(params, "dense_")
    for i in range(cfg.first_dense_layers):
        x, _ = F.dense_block(x, F.layer_params(dense, i), cfg,
                             rope_sincos=rope)
    stack = F._sub(params, "blocks_")
    dropped, aux = [], []
    for i in range(cfg.num_layers - cfg.first_dense_layers):
        x, a, d, _ = F.moe_block(x, F.layer_params(stack, i), cfg,
                                 rope_sincos=rope)
        dropped.append(round(float(d), 5))
        aux.append(round(float(a), 4))
    return dropped, aux


def moe_identity_bf16(torch, dev, M, params, cfg, prompt):
    """The MoE identity on the dropless ``capacity_factor = E / K``, bf16.
    Each step's fresh prefill runs twice: with its own routing, where the
    layers whose routing of the new token flips against the decode's are
    counted and the first flip is described (bf16 rounding moves
    near-tied experts), and with every real row routed as the decode path
    routed it -- every step of that within the bar."""
    dl = cfg.replace(capacity_factor=cfg.num_experts / cfg.experts_per_token)
    n_moe = cfg.num_layers - cfg.first_dense_layers
    t0 = time.perf_counter()
    r = decode_identity(torch, dev, M, params, dl, prompt, force=True)
    say(f"[3i] {cfg.name} MoE identity, bf16, on the dropless capacity "
        f"factor {dl.capacity_factor:g} (E / K): {DECODER_STEPS} decode "
        f"steps against fresh prefills of the prompt and the tokens so far; "
        f"caches {r['shapes']}; max |logit| {r['scale']:.4f}; error per "
        f"step as a share of it, the prefill routed as the decode "
        f"{fmt(r['forced'])} (bar {IDENTITY_REL_TOL}), the prefill on its "
        f"own routing {fmt(r['shares'])}; MoE layers whose "
        f"top-{cfg.experts_per_token} for the new token differ between "
        f"decode and prefill, per step {r['flips']}; the first of them "
        f"(decode's k-th minus (k+1)-th probability there, the layer's "
        f"input difference as a share of its max |x|, the same at the first "
        f"MoE layer) {fmt_first(r['first'])}; prompt (row, layer) pairs the "
        f"fresh prefill routes otherwise than the prompt's own "
        f"{r['prompt_flips']} of {len(prompt) * n_moe}; "
        f"{time.perf_counter() - t0:.1f} s")
    assert len(r["forced"]) == DECODER_STEPS
    assert max(r["forced"]) <= IDENTITY_REL_TOL, r["forced"]


def moe_identity_f32(torch, dev, M, cfg, prompt):
    """The same identity with the weights drawn in float32 from the same
    seed (the bf16 weights are their rounding) and float32 caches, each
    fresh prefill on its own routing: every step within the bar."""
    from repro_torch.models.params import init_params
    f32 = cfg.replace(capacity_factor=cfg.num_experts / cfg.experts_per_token,
                      dtype="float32", kv_cache_dtype="float32")
    params = init_params(f32, torch.Generator(device=dev).manual_seed(SEED),
                         dev)
    t0 = time.perf_counter()
    r = decode_identity(torch, dev, M, params, f32, prompt)
    say(f"[3i] {cfg.name} MoE identity, float32 weights and caches "
        f"({torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB): max |logit| "
        f"{r['scale']:.4f}; error per step as a share of it "
        f"{fmt(r['shares'])} (bar {IDENTITY_REL_TOL}); routing flips per "
        f"step {r['flips']}; prompt (row, layer) pairs routed otherwise "
        f"{r['prompt_flips']}; {time.perf_counter() - t0:.1f} s")
    assert max(r["shares"]) <= IDENTITY_REL_TOL, r["shares"]


def engine_vs_solo(torch, dev, M, params, cfg, prompt, steps, tape):
    """Request 0 of the served group alone: a B = 1 prefill of its prompt
    into fresh caches and DECODER_STEPS decode steps fed the group's
    row-0 tokens, each step's logits against the group decode's row 0.
    ``steps``: the group decode's (row-0 token, row-0 position, row-0
    logits) per step; ``tape``: the serve's routing (request 0's prefill
    first, then the group decode's (G, 1, k) calls), which a MoE model's
    solo run follows.  Returns (each step's largest error as a share of
    the group row's max |logit|, whether the solo prefill's greedy token
    is the group's first input, the (step, layer) pairs whose own routing
    differed)."""
    S = prompt.shape[0]
    n_moe = len([r for r in tape if r["idx"].shape[0] > 1]) // len(steps)
    pre = [r["idx"] for r in tape[:n_moe]]
    dec = [r["idx"][:1] for r in tape if r["idx"].shape[0] > 1]
    assert all(p.shape[1] == S for p in pre)
    toks = torch.as_tensor(prompt, dtype=torch.long, device=dev)[None]
    caches = M.init_cache(cfg, 1, S + DECODER_STEPS, dev)
    with routing_tape(torch, forced=pre):
        logits, _ = M.prefill(params, cfg, {"tokens": toks}, caches)
    first_same = int(logits[0, -1].argmax()) == int(steps[0][0])
    shares, flips = [], 0
    for i, (tok, pos, want) in enumerate(steps):
        assert pos == S + i, (pos, S, i)
        force = dec[i * n_moe:(i + 1) * n_moe]
        with routing_tape(torch, forced=force) as own:
            logits, _ = M.decode_step(params, cfg, tok.reshape(1, 1),
                                      caches, pos)
        flips += sum(not same_experts(o["idx"], f)
                     for o, f in zip(own, force))
        got = logits[0, -1].float()
        assert torch.isfinite(got).all()
        shares.append(float((got - want).abs().max())
                      / float(want.abs().max()))
    return shares, first_same, flips


def decoder_phase(torch, dev):
    """Phase 3i: each of DECODERS at full width with bf16 weights drawn on
    the card -- ``serve`` of 2 dense prompts past the window and 2
    keep-list prompts with DECODER_STEPS greedy steps, timed per prefill
    and decode step, its row 0 against request 0 alone
    (``engine_vs_solo``); the ring identity (window models) or the MoE
    identities (``moe_identity_bf16``, ``moe_identity_f32``) over
    DECODER_STEPS teacher-forced steps; the MoE layers' dropped shares
    and aux losses at the served capacity factor; peak memory per
    model."""
    from repro_torch.configs import ServeConfig, get_config
    from repro_torch.models import forward as F, model as M
    from repro_torch.models.params import count_params, init_params
    from repro_torch.serving.engine import Request, ServingEngine

    for arch, depth, dense_len in DECODERS:
        cfg = get_config(arch)
        cut = ""
        if depth is not None:
            cut = (f" (depth cut from {cfg.num_layers} layers, "
                   f"{cfg.param_count() * 2 / 2 ** 30:.1f} GiB of bf16, to "
                   f"{depth})")
            cfg = cfg.replace(num_layers=depth)
        # the engines' timing wrappers close over the engine: collect the
        # last model's cycle before the next model is drawn
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = init_params(
            cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
        torch.cuda.synchronize()
        pattern = (f"window {cfg.window_size}" if cfg.window_size else
                   "full attention")
        if cfg.global_every > 1:
            pattern = (f"{cfg.global_every - 1}:1 local (window "
                       f"{cfg.window_size}) : global")
        if cfg.family == "moe":
            pattern += (f", {cfg.num_experts} experts top-"
                        f"{cfg.experts_per_token}, {cfg.num_shared_experts} "
                        f"shared, {cfg.first_dense_layers} dense first")
        say(f"[3i] {arch}: {cfg.num_layers} layers{cut or ' (full depth)'}"
            f", d_model {cfg.d_model}, heads {cfg.num_heads}/"
            f"{cfg.num_kv_heads} of {cfg.head_dim}, {pattern}; "
            f"{count_params(params) / 1e9:.3f} B parameters "
            f"({torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB, "
            f"{cfg.dtype}) drawn in {time.perf_counter() - t0:.1f} s")

        # serve: 2 dense prompts past the window, 2 keep-lists
        engine = ServingEngine(cfg, ServeConfig(max_batch=4,
                                                roi_sparsity=True), params)
        prefill_ms, decode_ms = [], []

        def timed(fn, into):
            def run(*a, **kw):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = fn(*a, **kw)
                torch.cuda.synchronize()
                into.append(round((time.perf_counter() - t) * 1e3, 3))
                return out
            return run

        engine.prefill = timed(engine.prefill, prefill_ms)
        engine.roi_prefill = timed(engine.roi_prefill, prefill_ms)
        group_decode = timed(engine._decode_group, decode_ms)
        row0 = []           # the group decode's row 0: token, position, logits

        def decode_group(tokens, caches, pos):
            logits, caches = group_decode(tokens, caches, pos)
            row0.append((tokens[0].clone(), int(pos[0]),
                         logits[0, -1].float().clone()))
            return logits, caches

        engine._decode_group = decode_group
        prompts = decoder_prompts(cfg, dense_len)
        reqs = [Request(i, tokens=t, keep=k, max_new_tokens=DECODER_STEPS)
                for i, (t, k) in enumerate(prompts)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with routing_tape(torch) as tape:
            out = engine.serve(reqs, greedy_steps=DECODER_STEPS)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        ring = {k: tuple(v[0].shape) for k, v in engine._ring.items()}
        kept = [None if k is None else int(k.sum()) for _, k in prompts]
        say(f"[3i] {arch} serve: requests of {[len(t) for t, _ in prompts]}"
            f" tokens ({kept} kept), {DECODER_STEPS} greedy steps: wall {wall * 1e3:.1f} "
            f"ms; prefill ms {prefill_ms}; decode ms per step {decode_ms}; "
            f"peak memory {peak:.2f} GiB; group caches {ring}; tokens "
            f"{ {k: v.tolist() for k, v in out.items()} }")
        assert sorted(out) == [0, 1, 2, 3] and len(prefill_ms) == 4
        assert len(decode_ms) == DECODER_STEPS
        assert all(t.shape == (DECODER_STEPS,) and (t >= 0).all()
                   and (t < cfg.vocab_size).all() for t in out.values())
        if cfg.window_size:
            assert all(s[2] == min(cfg.window_size, dense_len
                                   + DECODER_STEPS)
                       for k, s in ring.items() if k != "global")
        # the engine's group path (per-row slots at mixed positions, every
        # cache key's slot views, the stacked decode) against request 0
        # served alone
        t0 = time.perf_counter()
        shares, first_same, flips = engine_vs_solo(
            torch, dev, M, params, cfg, prompts[0][0], row0, tape)
        say(f"[3i] {arch} served request 0 against itself alone (a B = 1 "
            f"prefill and decode fed the group's row-0 tokens"
            f"{', routed as the group routed it' if tape else ''}): error "
            f"per step as a share of the group row's max |logit| "
            f"{fmt(shares)} (bar {IDENTITY_REL_TOL}); the solo prefill's "
            f"greedy token {'is' if first_same else 'is not'} the group's "
            f"first; (step, layer) pairs the solo would route otherwise "
            f"{flips}; {time.perf_counter() - t0:.1f} s")
        assert len(shares) == DECODER_STEPS, shares
        assert max(shares) <= IDENTITY_REL_TOL, shares
        # the wrappers hold the engine, and through it the weights
        del engine, group_decode, decode_group, row0, tape

        # the ring identity, or the MoE identity on the dropless config
        prompt = prompts[0][0]
        if cfg.family != "moe":
            t0 = time.perf_counter()
            r = decode_identity(torch, dev, M, params, cfg, prompt)
            say(f"[3i] {arch} ring identity (the prompt of {len(prompt)} "
                f"wraps the window of {cfg.window_size}): {DECODER_STEPS} "
                f"decode steps against fresh prefills of the prompt and the "
                f"tokens so far; caches {r['shapes']}; max |logit| "
                f"{r['scale']:.4f}; error per step as a share of it "
                f"{fmt(r['shares'])} (bar {IDENTITY_REL_TOL}); "
                f"{time.perf_counter() - t0:.1f} s")
            assert max(r["shares"]) <= IDENTITY_REL_TOL, r["shares"]
        else:
            dropped, aux = moe_layer_stats(torch, dev, F, params, cfg,
                                           prompt)
            say(f"[3i] {arch} served prefill (capacity factor "
                f"{cfg.capacity_factor}, S={len(prompt)}): dropped share "
                f"per MoE layer {dropped}; aux loss per layer {aux}")
            assert all(0.0 <= d < 1.0 for d in dropped)
            moe_identity_bf16(torch, dev, M, params, cfg, prompt)
            del params
            gc.collect()
            torch.cuda.empty_cache()
            moe_identity_f32(torch, dev, M, cfg, prompt)
            params = None
        del params
        torch.cuda.synchronize()
        say(f"[3i] {arch}: peak memory over the model's serve and "
            f"identities {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} "
            f"GiB")
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 3j: the recurrent-state families on the serving path
# ---------------------------------------------------------------------------

RECURRENT = ("rwkv6-7b", "zamba2-2.7b")
# requests 0 and 2 dense, 1 and 3 keep-lists of (length, kept): every
# length, kept count and teacher sequence (a dense prompt and the
# DECODER_STEPS tokens fed back) has a power-of-two factor of at least
# 16 (an odd length would run each scan one token a chunk), and the dense
# prompts are multiples of zamba2's chunk, 256
RECURRENT_DENSE = (4096, 1024)
RECURRENT_KEEP = ((2048, 1024), (1536, 768))


def recurrent_prompts(cfg):
    """The four requests' (token ids, keep-list or None), from the seed:
    the kept positions of a keep-list drawn without replacement."""
    rng = np.random.default_rng((SEED, 310))
    out = []
    for i in range(4):
        keep = None
        if i % 2:
            n, kept = RECURRENT_KEEP[i // 2]
            keep = np.zeros(n, bool)
            keep[rng.choice(n, kept, replace=False)] = True
        else:
            n = RECURRENT_DENSE[i // 2]
        out.append((rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                    keep))
    return out


def pow2_factor(n: int) -> int:
    return n & -n


def teacher_rows(torch, F, L, params, cfg, toks, rows):
    """The logits of a fresh prefill of ``toks`` (one sequence, no caches)
    at ``rows``: the trunk's rows, the final norm, the unembedding."""
    x = F._embed(params, cfg, toks[None])
    if cfg.family == "ssm":
        x, _ = F.rwkv_trunk(params, cfg, x)
    else:
        x, _, _ = F.hybrid_trunk(params, cfg, x)
    x = L.rmsnorm(x[:, rows], params["final_norm"], cfg.norm_eps)
    return F._unembed(params, cfg, x)[0].float()


def share(got, want):
    """The largest |got - want| as a share of the largest |want|."""
    return float((got - want).abs().max()) / float(want.abs().max())


def recurrent_serve(torch, dev, cfg, params, tag):
    """``serve`` of the four RECURRENT requests on ``params``, timed, then
    the identities (a), (b) and (c), each printed, and the rounding floor
    (``floor``: request 2's teacher rows from a prefill 16 tokens longer).
    Returns {"a", "b", "c", "floor": the shares of the largest |logit|,
    every step, row or request}.  The
    engine rounds zamba2's conv tail into its bfloat16 ring whatever the
    model's dtype (the JAX engine's ``_ring_write``), so (c), the one
    identity through the ring, carries that rounding in a float32 model
    too."""
    from repro_torch.configs import ServeConfig
    from repro_torch.models import forward as F, layers as L, model as M
    from repro_torch.serving.engine import Request, ServingEngine, _tree_map

    arch = f"{cfg.name} ({tag})"
    engine = ServingEngine(cfg, ServeConfig(max_batch=4, roi_sparsity=True),
                           params)
    prefill_ms, decode_ms, packed = [], [], []

    def timed(fn, into, keep=None):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            into.append(round((time.perf_counter() - t) * 1e3, 3))
            if keep is not None:
                keep.append(out.logits[0, -1].float().clone())
            return out
        return run

    engine.prefill = timed(engine.prefill, prefill_ms)
    engine.roi_prefill = timed(engine.roi_prefill, prefill_ms, packed)
    group_decode = timed(engine._decode_group, decode_ms)
    steps = []          # per group step: fed tokens, positions, logits

    def decode_group(tokens, caches, pos):
        logits, caches = group_decode(tokens, caches, pos)
        steps.append((tokens[:, 0].clone(), pos.clone(),
                      logits[:, -1].float().clone()))
        return logits, caches

    engine._decode_group = decode_group
    prompts = recurrent_prompts(cfg)
    reqs = [Request(i, tokens=t, keep=k, max_new_tokens=DECODER_STEPS)
            for i, (t, k) in enumerate(prompts)]
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = engine.serve(reqs, greedy_steps=DECODER_STEPS)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ring = _tree_map(lambda t: (tuple(t.shape), str(t.dtype)[6:]),
                     engine._ring)
    kept = [None if k is None else int(k.sum()) for _, k in prompts]
    say(f"[3j] {arch} serve: requests of {[len(t) for t, _ in prompts]}"
        f" tokens ({kept} kept), {DECODER_STEPS} greedy steps: wall "
        f"{wall * 1e3:.1f} ms; prefill ms {prefill_ms}; decode ms per "
        f"step {decode_ms}; peak memory {peak:.2f} GiB; group caches "
        f"{ring}; tokens { {k: v.tolist() for k, v in out.items()} }")
    assert sorted(out) == [0, 1, 2, 3] and len(prefill_ms) == 4
    assert len(decode_ms) == len(steps) == DECODER_STEPS
    assert all(t.shape == (DECODER_STEPS,) and (t >= 0).all()
               and (t < cfg.vocab_size).all() for t in out.values())
    del engine, group_decode, decode_group
    gc.collect()
    res = {"a": [], "c": []}

    # each dense request served alone: a B = 1 prefill and decode fed the
    # group's tokens of its row.  (a) its steps against one teacher
    # prefill of the prompt and those tokens; (c) request 0's steps
    # against the group's row 0
    for r in (0, 2):
        t0 = time.perf_counter()
        prompt = torch.as_tensor(prompts[r][0], dtype=torch.long,
                                 device=dev)
        S = prompt.shape[0]
        logits, caches = M.prefill(params, cfg, {"tokens": prompt[None]},
                                   M.init_cache(cfg, 1, S + DECODER_STEPS,
                                                dev))
        first_same = int(logits[0, -1].argmax()) == int(steps[0][0][r])
        solo = []
        for i, (tok, pos, _) in enumerate(steps):
            assert int(pos[r]) == S + i
            logits, caches = M.decode_step(params, cfg, tok[r:r + 1, None],
                                           caches, pos[r:r + 1])
            solo.append(logits[0, -1].float())
        del caches
        solo = torch.stack(solo)
        fed = torch.stack([s[0][r] for s in steps]).long()
        want = teacher_rows(torch, F, L, params, cfg, torch.cat([prompt, fed]),
                            torch.arange(S, S + DECODER_STEPS, device=dev))
        assert torch.isfinite(solo).all() and torch.isfinite(want).all()
        shares = [share(g, w) for g, w in zip(solo, want)]
        res["a"] += shares
        say(f"[3j] {arch} (a) decode == teacher prefill, request {r} ({S} "
            f"tokens, decoded alone; teacher of {S + DECODER_STEPS}): max "
            f"|logit| {float(want.abs().max()):.4f}; error per step as a "
            f"share of it {fmt(shares)} (bar {IDENTITY_REL_TOL}); "
            f"{time.perf_counter() - t0:.1f} s")
        if r == 2:
            # the rounding floor: the same rows from a prefill 16 tokens
            # longer -- the same function, other chunks and GEMM shapes
            longer = teacher_rows(
                torch, F, L, params, cfg, torch.cat([prompt, fed, fed]),
                torch.arange(S, S + DECODER_STEPS, device=dev))
            res["floor"] = [share(g, w) for g, w in zip(longer, want)]
            say(f"[3j] {arch} rounding floor: the teacher's rows from a "
                f"prefill of {S + 2 * DECODER_STEPS} tokens, error per row "
                f"as a share of the max |logit| {fmt(res['floor'])}")
        if r == 0:
            group = torch.stack([s[2][0] for s in steps])
            res["c"] = [share(g, w) for g, w in zip(solo, group)]
            say(f"[3j] {arch} (c) the group's row 0 against request 0 "
                f"served alone: max |logit| {float(group.abs().max()):.4f};"
                f" error per step as a share of the group row's max |logit|"
                f" {fmt(res['c'])} (bar {IDENTITY_REL_TOL}); the solo "
                f"prefill's greedy token {'is' if first_same else 'is not'}"
                f" the group's first")

    # (b) each keep-list's packed logits against the kept tokens alone
    res["b"] = []
    for j, r in enumerate((1, 3)):
        toks, keep = prompts[r]
        kept_toks = torch.as_tensor(toks[keep], dtype=torch.long, device=dev)
        want, _ = M.prefill(params, cfg, {"tokens": kept_toks[None]}, None)
        want = want[0, -1].float()
        res["b"].append(share(packed[j], want))
        say(f"[3j] {arch} (b) packed == kept-only, request {r} ({len(toks)} "
            f"tokens, {len(kept_toks)} kept): max |logit| "
            f"{float(want.abs().max()):.4f}; error as a share of it "
            f"{res['b'][-1]:.3g} (bar {IDENTITY_REL_TOL})")

    # the deadline former on a fresh engine: Poisson arrivals, as 3g's
    from repro_torch.obs.loadgen import drive_serve
    panel = drive_serve(ServingEngine(cfg, ServeConfig(max_batch=4), params),
                        SERVE_RATE_HZ, n_requests=SERVE_REQUESTS,
                        prompt_len=SERVE_PROMPT, deadline_s=SERVE_DEADLINE)
    say(f"[3j] {arch} drive_serve at {SERVE_RATE_HZ} Hz, {SERVE_REQUESTS} "
        f"requests of {SERVE_PROMPT} tokens: {panel}")
    assert panel["served"] == SERVE_REQUESTS
    return res


def recurrent_phase(torch, dev):
    """Phase 3j: each of RECURRENT at full width with bf16 weights drawn on
    the card -- ``serve`` of 2 dense prompts and 2 keep-lists with
    DECODER_STEPS greedy steps, timed per prefill and decode step, and
    the identities (a) decode == a teacher prefill's rows on the dense
    requests, (b) packed == a prefill of the kept tokens alone on the
    keep-lists, (c) the group's row 0 == request 0 served alone, every
    step (``recurrent_serve``); then the same with the weights drawn in
    float32 from the same seed (the bf16 weights are their rounding).
    The float32 identities are held within IDENTITY_REL_TOL; the bf16
    ones are printed: on these random-weight recurrent models bf16
    rounding alone moves the logits by more than the bar (one rounding
    of zamba2's conv tail moves its float32 logits by 0.009-0.029 of
    their scale, PERF.md).  Peak memory per model."""
    from repro_torch.configs import get_config
    from repro_torch.models.params import count_params, init_params

    failed = []
    for arch in RECURRENT:
        base = get_config(arch)
        for n in RECURRENT_DENSE:
            assert min(pow2_factor(n), pow2_factor(n + DECODER_STEPS)) >= 16
            assert base.family != "hybrid" or n % base.ssm_chunk == 0
        for n, kept in RECURRENT_KEEP:
            assert min(pow2_factor(n), pow2_factor(kept)) >= 16
        for tag, cfg in (("bf16", base),
                         ("float32", base.replace(
                             dtype="float32", kv_cache_dtype="float32"))):
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params = init_params(
                cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
            torch.cuda.synchronize()
            if cfg.family == "ssm":
                shape = (f"{cfg.num_layers} RWKV6 layers, d_model "
                         f"{cfg.d_model}, {cfg.ssm_num_heads} heads of "
                         f"{cfg.ssm_head_dim}, d_ff {cfg.d_ff}")
            else:
                shape = (f"{cfg.num_layers} Mamba2 blocks, d_model "
                         f"{cfg.d_model}, {cfg.ssm_num_heads} SSD heads of "
                         f"{cfg.ssm_head_dim}, state {cfg.ssm_state_dim}, "
                         f"{cfg.num_layers // cfg.attn_every} applications "
                         f"of {cfg.num_shared_attn_blocks} shared attention "
                         f"blocks ({cfg.num_heads} heads of {cfg.head_dim})")
            say(f"[3j] {arch}: {shape} (full depth); "
                f"{count_params(params) / 1e9:.3f} B parameters "
                f"({torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB, "
                f"{cfg.dtype}) drawn in {time.perf_counter() - t0:.1f} s")
            res = recurrent_serve(torch, dev, cfg, params, tag)
            if cfg.dtype == "float32":
                failed += [(arch, k, max(res[k])) for k in "abc"
                           if max(res[k]) > IDENTITY_REL_TOL]
            del params
            torch.cuda.synchronize()
            say(f"[3j] {arch} ({tag}): peak memory over the model's serve "
                f"and identities "
                f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    gc.collect()
    torch.cuda.empty_cache()
    assert not failed, failed


# ---------------------------------------------------------------------------
# phase 3k: whisper-small's encoder-decoder
# ---------------------------------------------------------------------------

ENCDEC = "whisper-small"
# one 30 s window after whisper's conv frontend: 1,500 frames of d_model
ENCDEC_FRAMES = 1500
# (prompt tokens, greedy decode steps) of the two prompts, each fed to
# all four requests: the second's last step sits at position 447, the
# last row of ``dec_pos`` (384 + 64 - 1)
ENCDEC_PROMPTS = ((4, 60), (384, 64))
# the float32 identities, as a share of the largest |logit|
ENCDEC_TOL = 1e-3


def softmax_steps(s_kv: int) -> int:
    """``blockwise_attention``'s online-softmax steps over ``s_kv`` keys:
    its kv_chunk of 1024 halved until it divides s_kv (1,500 -> 4, so 375
    steps)."""
    chunk = max(min(1024, s_kv), 1)
    while s_kv % chunk:
        chunk //= 2
    return s_kv // chunk


@contextlib.contextmanager
def instrumented(torch, F, L, times, outs, steps):
    """While open: every call of ``F.encoder_trunk``, ``F.cross_kv`` and
    ``F.decoder_trunk`` timed into ``times[name]`` (host clock,
    synchronized at both ends) with its last result in ``outs[name]``, and
    each ``L.blockwise_attention`` call's online-softmax steps added to
    ``steps[0]`` (whisper has no window)."""
    saved = {n: getattr(F, n) for n in ("encoder_trunk", "cross_kv",
                                        "decoder_trunk")}
    attention = L.blockwise_attention

    def timed(name, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            times.setdefault(name, []).append(
                (time.perf_counter() - t) * 1e3)
            outs[name] = out
            return out
        return run

    def counted(q, k, v, **kw):
        steps[0] += softmax_steps(k.shape[1])
        return attention(q, k, v, **kw)

    for name, fn in saved.items():
        setattr(F, name, timed(name, fn))
    L.blockwise_attention = counted
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(F, name, fn)
        L.blockwise_attention = attention


def encdec_rows(torch, F, M, params, cfg, toks, rows, memory=None,
                cross=None):
    """The logits at ``rows`` of one decoder pass over ``toks`` (B, n) from
    position 0, through the cached branch (fresh self caches, the cross
    K/V ``cross``) or, given ``memory``, the no-cache branch projecting
    the memory in every layer."""
    if memory is None:
        caches = M.init_cache(cfg, toks.shape[0], cross[0].shape[2],
                              toks.device)
        caches["cross"] = cross
        x, _ = F.decoder_trunk(params, cfg, toks, None, mode="prefill",
                               caches=caches)
    else:
        x, _ = F.decoder_trunk(params, cfg, toks, memory)
    return M._encdec_logits(params, cfg, x[:, rows]).float()


def encdec_greedy(torch, M, params, cfg, caches, logits, T, n_steps,
                  fed=None):
    """``n_steps`` decode steps from position T after a prefill's
    ``logits``: greedy, or fed ``fed`` (B, n_steps).  Returns (the logits
    of the prefill row and of every step (B, n_steps + 1, V) float32, the
    tokens fed (B, n_steps), each step's ms: host clock ending in a
    synchronize)."""
    rows, toks, ms = [logits[:, -1].float()], [], []
    for i in range(n_steps):
        tok = rows[-1].argmax(-1) if fed is None else fed[:, i]
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, caches = M.decode_step(params, cfg, tok[:, None], caches,
                                       T + i)
        torch.cuda.synchronize()
        ms.append(round((time.perf_counter() - t) * 1e3, 3))
        rows.append(logits[:, -1].float())
        toks.append(tok)
    return torch.stack(rows, 1), torch.stack(toks, 1), ms


def step_shares(got, want):
    """Per step (axis 1): the largest |got - want| over the batch as a
    share of the largest |want|."""
    scale = float(want.abs().max())
    return [float((got[:, i] - want[:, i]).abs().max()) / scale
            for i in range(got.shape[1])]


def encdec_serve(torch, dev, cfg, params, tag, smi):
    """The four requests through ``prefill`` and greedy ``decode_step`` on
    each of ENCDEC_PROMPTS, timed, then the identities; returns {"a", "b",
    "c": the shares of the largest |logit|, every step, row and prompt}.
    (a) each step's logits against one cached-path decoder pass over the
    prompt and the greedy tokens; (b) that pass against the no-cache
    branch over the memory; (c) the batch's row 0 against request 0
    served alone, fed the batch's tokens."""
    from repro_torch.models import forward as F, layers as L, model as M

    arch = f"{cfg.name} ({tag})"
    gen = torch.Generator(device=dev).manual_seed(SEED + 30)
    f32_frames = torch.randn((N_REQUESTS, ENCDEC_FRAMES, cfg.frontend_dim),
                             generator=gen, device=dev)
    frames = f32_frames.to(getattr(torch, cfg.dtype))
    res = {"a": [], "b": [], "c": []}
    for T, n_steps in ENCDEC_PROMPTS:
        toks = torch.randint(0, cfg.vocab_size, (N_REQUESTS, T),
                             generator=gen, device=dev)
        times, outs, steps = {}, {}, [0]
        torch.cuda.reset_peak_memory_stats()
        with instrumented(torch, F, L, times, outs, steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, caches = M.prefill(
                params, cfg, {"frames": frames, "tokens": toks},
                M.init_cache(cfg, N_REQUESTS, ENCDEC_FRAMES, dev))
            torch.cuda.synchronize()
            prefill_ms = (time.perf_counter() - t0) * 1e3
        memory, cross = outs["encoder_trunk"], caches["cross"]
        got, fed, decode_ms = encdec_greedy(torch, M, params, cfg, caches,
                                            logits, T, n_steps)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        assert torch.isfinite(got).all() and got.shape == (
            N_REQUESTS, n_steps + 1, cfg.vocab_size)
        last = T + n_steps - 1
        assert last < cfg.max_target_len
        split = {k: round(v[0], 3) for k, v in times.items()}
        say(f"[3k] {arch}, {N_REQUESTS} requests of {ENCDEC_FRAMES} frames "
            f"({frames.dtype}) and a {T}-token prompt, {n_steps} greedy "
            f"steps to position {last}: prefill {prefill_ms:.1f} ms "
            f"({prefill_ms / N_REQUESTS:.1f} a request), of which {split} "
            f"ms; {steps[0]} online-softmax chunk steps; decode ms per "
            f"step median {statistics.median(decode_ms):.3f}, all "
            f"{decode_ms}; peak {peak:.2f} GiB; tokens of request 0 "
            f"{fed[0].tolist()}; {smi}")
        del caches, logits

        # (a) decode == teacher-forced: one cached-path pass over the
        # prompt and the greedy tokens, read at the prefill's and each
        # step's row; (b) that pass == the no-cache branch over the memory
        seq = torch.cat([toks, fed], 1)
        rows = torch.arange(T - 1, T + n_steps, device=dev)
        want = encdec_rows(torch, F, M, params, cfg, seq, rows, cross=cross)
        res["a"] += step_shares(got, want)
        plain = encdec_rows(torch, F, M, params, cfg, seq, rows,
                            memory=memory)
        res["b"] += step_shares(want, plain)
        say(f"[3k] {arch} T={T}: max |logit| {float(want.abs().max()):.4f};"
            f" (a) decode == teacher-forced, per step as a share of it "
            f"{fmt(step_shares(got, want))}; (b) cached cross K/V == the "
            f"memory, per row {fmt(step_shares(want, plain))}")
        if T == ENCDEC_PROMPTS[0][0]:
            # the rounding floor: the same rows from a pass 16 tokens
            # longer -- the same function on other GEMM shapes
            longer = encdec_rows(torch, F, M, params, cfg,
                                 torch.cat([seq, fed[:, :16]], 1), rows,
                                 cross=cross)
            res["floor"] = step_shares(longer, want)
            scale = float(want.abs().max())
            step = torch.finfo(getattr(torch, cfg.dtype)).eps * 2.0 ** int(
                np.floor(np.log2(scale)))
            say(f"[3k] {arch} rounding floor: the teacher's rows from a "
                f"pass of {seq.shape[1] + 16} tokens, per row "
                f"{fmt(res['floor'])}; one {cfg.dtype} step at the largest "
                f"|logit| (the logits' own rounding) is {step / scale:.3g} "
                f"of it")
        del want, plain, memory, cross

        # (c) request 0 served alone, fed the batch's tokens
        logits, caches = M.prefill(
            params, cfg, {"frames": frames[:1], "tokens": toks[:1]},
            M.init_cache(cfg, 1, ENCDEC_FRAMES, dev))
        solo, _, _ = encdec_greedy(torch, M, params, cfg, caches, logits, T,
                                   n_steps, fed=fed[:1])
        res["c"] += step_shares(solo, got[:1])
        say(f"[3k] {arch} T={T}: (c) the batch's row 0 == request 0 served "
            f"alone, per step {fmt(step_shares(solo, got[:1]))}")
        del caches, logits, solo, got

    if cfg.dtype == "bfloat16":
        # jnp's promotion on the card: a float32 frame stream keeps the
        # encoder, the memory and the cross K/V in float32
        toks = torch.randint(0, cfg.vocab_size, (N_REQUESTS, 4),
                             generator=gen, device=dev)
        out = {}
        for fr in (frames, f32_frames):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, caches = M.prefill(
                params, cfg, {"frames": fr, "tokens": toks},
                M.init_cache(cfg, N_REQUESTS, ENCDEC_FRAMES, dev))
            torch.cuda.synchronize()
            out[str(fr.dtype)] = ((time.perf_counter() - t0) * 1e3,
                                  caches["cross"][0].dtype,
                                  logits[:, -1].float())
        (ms_b, dt_b, lb), (ms_f, dt_f, lf) = out.values()
        assert dt_b == torch.bfloat16 and dt_f == torch.float32
        assert torch.isfinite(lf).all()
        say(f"[3k] {arch} float32 frames: prefill {ms_f:.1f} ms against "
            f"{ms_b:.1f} for bf16 frames; cross K/V {dt_f}; logits off the "
            f"bf16 frames' by {share(lf, lb):.3g} of their scale")
    return res


def encdec_phase(torch, dev):
    """Phase 3k: whisper-small FULL (12 + 12 layers, d_model 768, 12
    heads of 64, d_ff 3072, vocab 51,865; nothing cut) with bf16 weights
    drawn on the card, then float32 from the same seed: 4 requests of
    1,500 frames through ``prefill`` (encoder, ``cross_kv``, decoder,
    timed apart) and greedy ``decode_step`` on a 4-token prompt with 60
    steps and a 384-token one with 64 (position 447, the last), with the
    identities (a) decode == teacher-forced, (b) cached cross K/V == the
    memory, (c) batch == solo (``encdec_serve``).  The float32 ones are
    held within ENCDEC_TOL of the logit scale; the bf16 ones are printed
    beside a rounding floor, as phase 3j's."""
    from repro_torch.configs import get_config
    from repro_torch.models.params import count_params, init_params

    smi = " | ".join(nvidia_smi())
    base = get_config(ENCDEC)
    failed = []
    for tag, cfg in (("bf16", base),
                     ("float32", base.replace(dtype="float32",
                                              kv_cache_dtype="float32"))):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = init_params(
            cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
        torch.cuda.synchronize()
        n = count_params(params)
        assert n == cfg.param_count(), n
        say(f"[3k] {cfg.name}: {cfg.encoder_layers} + {cfg.decoder_layers} "
            f"layers, d_model {cfg.d_model}, {cfg.num_heads} heads of "
            f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size} (full "
            f"size); {n / 1e6:.3f} M parameters "
            f"({torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB, "
            f"{cfg.dtype}) drawn in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        res = encdec_serve(torch, dev, cfg, params, tag, smi)
        worst = {k: max(v) for k, v in res.items()}
        say(f"[3k] {cfg.name} ({tag}): largest shares {worst} (float32 bar "
            f"{ENCDEC_TOL}); {time.perf_counter() - t0:.1f} s")
        if cfg.dtype == "float32":
            failed += [(k, worst[k]) for k in "abc"
                       if worst[k] > ENCDEC_TOL]
        del params
    gc.collect()
    torch.cuda.empty_cache()
    assert not failed, failed


# ---------------------------------------------------------------------------
# phase 3l: the one-device training step
# ---------------------------------------------------------------------------

TRAIN_ARCH = "h2o-danube3-4b"
TRAIN_STEPS = 5
# the train_4k cell's global batch of 256, cut to 2: at 2 the peak is
# 50.6 GiB, at 1 46.7 (profile_train_step.py, PR 31)
TRAIN_BATCH = 2
# (b) the card against the port's CPU path at SMOKE, float32: the loss and
# each gradient leaf within 1e-4 of its largest |g| (the CPU path is the
# one the tests hold against JAX), or within twice the CPU path's own
# rounding floor where that is larger: how far its gradients move when
# the embedding moves by 2^-24 of itself (rwkv6's draw: 2.1e-4-3.5e-4 in
# the first chip run, the card 2.8e-4); remat on == off, causal_skip's
# gradients == the exhaustive walk's and AdamW on the card == the CPU
# within 1e-6 of each leaf's largest
TRAIN_TOL, TRAIN_TIGHT = 1e-4, 1e-6
TRAIN_SMOKE = ["h2o-danube3-4b", "gemma3-27b", "mistral-nemo-12b",
               "deepseek-67b", "internvl2-26b", "deepseek-moe-16b",
               "qwen3-moe-235b-a22b", "rwkv6-7b", "zamba2-2.7b",
               "whisper-small"]
SKIP_ARCH, SKIP_SEQ = "mistral-nemo-12b", 2048   # 4 query blocks, 2 chunks


def loss_and_grads(torch, M, params, cfg, batch, **kw):
    """``train_loss`` and the gradient of every leaf (zeros where unused,
    as ``jax.grad`` gives): (loss, metrics, {name: grad})."""
    loss, metrics = M.train_loss(params, cfg, batch, **kw)
    names = sorted(params)
    grads = torch.autograd.grad(loss, [params[k] for k in names],
                                allow_unused=True, materialize_grads=True)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
        dict(zip(names, grads))


def leaf_share(got, want):
    """The largest of |got - want| over each leaf's largest |want|."""
    return max((got[k].float().cpu() - want[k].float().cpu()).abs().max()
               .item() / max(want[k].float().abs().max().item(), 1e-30)
               for k in want)


def train_full(torch, dev, smi):
    """(a) h2o-danube3-4b FULL (24 layers, d_model 3840, a window of
    4,096 on every layer; nothing of its width or depth cut), bf16
    weights drawn on the card, ``TrainConfig()`` (remat on), a
    ``SyntheticLM`` markov batch of TRAIN_BATCH x 4,096 tokens per step:
    TRAIN_STEPS steps of ``train_loss`` -> ``torch.autograd.grad`` ->
    ``adamw_update``, each timed on the host clock ending in a
    synchronize; the loss and every gradient finite, the parameters
    moved."""
    from repro_torch.configs import SHAPES, TrainConfig, get_config
    from repro_torch.data.lm import SyntheticLM
    from repro_torch.models import model as M
    from repro_torch.models.params import count_params, init_params
    from repro_torch.optim.adamw import adamw_init, adamw_update

    cfg, tcfg, cell = get_config(TRAIN_ARCH), TrainConfig(), \
        SHAPES["train_4k"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                         dev)
    for p in params.values():
        p.requires_grad_(True)
    state = adamw_init(params, dev)
    torch.cuda.synchronize()
    n = count_params(params)
    assert n == cfg.param_count(), n
    say(f"[3l] {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.head_dim}, d_ff "
        f"{cfg.d_ff}, window {cfg.window_size} (full size); {n / 1e9:.3f} B "
        f"parameters in {cfg.dtype} and the AdamW moments in float32: "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB, drawn in "
        f"{time.perf_counter() - t0:.1f} s")
    say(f"[3l] batch {TRAIN_BATCH} x {cell.seq_len} tokens a step: the "
        f"{cell.name} cell's global batch of {cell.global_batch} is cut "
        f"(gradient accumulation, TrainConfig.microbatch, comes with A6b); "
        f"TrainConfig() remat={tcfg.remat!r}, causal_skip="
        f"{tcfg.causal_skip}, warmup {tcfg.warmup_steps} steps")
    data = SyntheticLM(cfg.vocab_size, cell.seq_len, TRAIN_BATCH,
                       mode="markov", seed=SEED)
    # every 97th element of each leaf, to count those the steps move
    before = {k: p.detach().view(-1)[::97].clone() for k, p in
              params.items()}
    rows, losses = [], []
    for step in range(TRAIN_STEPS):
        batch = data.batch(step, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _, grads = loss_and_grads(
            torch, M, params, cfg, batch, remat=tcfg.remat != "none",
            causal_skip=tcfg.causal_skip)
        params, state, met = adamw_update(params, grads, state, tcfg)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        bad = [k for k, g in grads.items() if not bool(
            torch.isfinite(g).all())]
        assert bool(torch.isfinite(loss)) and not bad, (step, bad)
        del grads
        rows.append(ms)
        losses.append(float(loss))
        say(f"[3l] step {step + 1}: loss {float(loss):.5f} grad_norm "
            f"{float(met['grad_norm']):.5f} lr {float(met['lr']):.3e} "
            f"{ms:.1f} ms")
    moved = {k: int((p.detach().view(-1)[::97] != before[k]).sum())
             for k, p in params.items()}
    total = sum(v.numel() for v in before.values())
    say(f"[3l] {TRAIN_STEPS} steps: median {statistics.median(rows):.1f} ms "
        f"a step (first {rows[0]:.1f}; {smi}); peak "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; sampled "
        f"elements (every 97th) moved {sum(moved.values())} of {total} "
        f"({sum(moved.values()) / total:.4f}; per leaf {moved})")
    # bf16 weights without a float32 master copy, as in the JAX package:
    # an update under half a bf16 step of its weight rounds back
    assert sum(moved.values()) > 0 and all(
        moved[k] > 0 for k, p in params.items() if p.ndim >= 2), moved
    del params, state, before
    return rows, losses


def train_identities(torch, dev):
    """(b) every family at SMOKE in float32: the card's loss and gradients
    against the port's CPU path, remat on == off, causal_skip == the
    exhaustive walk (bitwise on the attention's rows and the loss, the
    gradients within TRAIN_TIGHT), three AdamW steps on the card == on
    the CPU.  Returns the largest shares."""
    from repro_torch.configs import ShapeCell, TrainConfig, get_config
    from repro_torch.models import layers as L, model as M
    from repro_torch.models.params import init_params
    from repro_torch.optim.adamw import adamw_init, adamw_update

    def case(arch, S=64):
        cfg = get_config(arch, smoke=True).replace(
            dtype="float32", kv_cache_dtype="float32")
        params = init_params(cfg, torch.Generator().manual_seed(SEED),
                             "cpu")
        b = M.make_batch(cfg, ShapeCell("smoke", S, 2, "train"),
                         torch.Generator().manual_seed(SEED + 1), "cpu")
        return cfg, params, {k: v.float() if v.is_floating_point() else v
                             for k, v in b.items()}

    def run(cfg, params, b, where, **kw):
        p = {k: v.detach().to(where).requires_grad_(True)
             for k, v in params.items()}
        return loss_and_grads(torch, M, p, cfg,
                              {k: v.to(where) for k, v in b.items()}, **kw)

    def floor(cfg, params, b, g_cpu):
        """The CPU path's own rounding floor: the largest share its
        gradients move by when the embedding moves by 2^-24 of itself
        (two draws)."""
        out = 0.0
        for i in (1, 2):
            gen = torch.Generator().manual_seed(SEED + i)
            e = params["embed"]
            e = e * (1 + 2 ** -24 * torch.randn(e.shape, generator=gen))
            out = max(out, leaf_share(
                run(cfg, dict(params, embed=e), b, "cpu")[2], g_cpu))
        return out

    worst = {"card": 0.0, "remat": 0.0, "metrics": 0.0, "floor": 0.0}
    for arch in TRAIN_SMOKE:
        cfg, params, b = case(arch)
        l_cpu, m_cpu, g_cpu = run(cfg, params, b, "cpu")
        l_dev, m_dev, g_dev = run(cfg, params, b, dev)
        l_nr, _, g_nr = run(cfg, params, b, dev, remat=False)
        card = max(abs(float(l_dev) - float(l_cpu)) / max(1.0, abs(float(
            l_cpu))), leaf_share(g_dev, g_cpu))
        fl = floor(cfg, params, b, g_cpu)
        bar = max(TRAIN_TOL, 2 * fl)
        remat = max(abs(float(l_nr) - float(l_dev)),
                    leaf_share(g_nr, g_dev))
        met = max([abs(float(m_dev[k]) - float(m_cpu[k])) for k in m_cpu],
                  default=0.0)
        say(f"[3l] (b) {arch} SMOKE f32: loss {float(l_dev):.6f}, card vs "
            f"CPU {card:.3g} (bar {bar:.3g}: the CPU's floor {fl:.3g}), "
            f"remat on vs off {remat:.3g} (bar {TRAIN_TIGHT})"
            f"{'' if not m_cpu else f', metrics {met:.3g}'}")
        assert card <= bar and remat <= TRAIN_TIGHT, arch
        assert met <= TRAIN_TIGHT, arch
        for k, v in (("card", card), ("remat", remat), ("metrics", met),
                     ("floor", fl)):
            worst[k] = max(worst[k], v)
    # causal_skip on a full-attention arch, past the default blocks
    g = torch.Generator(device=dev).manual_seed(SEED)
    q, k, v = (torch.randn((2, SKIP_SEQ, 4, 32), generator=g, device=dev)
               for _ in range(3))
    attn_same = torch.equal(L.blockwise_attention(q, k, v, causal_skip=True),
                            L.blockwise_attention(q, k, v))
    cfg, params, b = case(SKIP_ARCH, SKIP_SEQ)
    l_skip, _, g_skip = run(cfg, params, b, dev, causal_skip=True)
    l_ex, _, g_ex = run(cfg, params, b, dev)
    skip = leaf_share(g_skip, g_ex)
    say(f"[3l] (b) causal_skip at S = {SKIP_SEQ}: attention rows bitwise "
        f"the exhaustive walk's: {attn_same}; {SKIP_ARCH} loss bitwise: "
        f"{torch.equal(l_skip, l_ex)}; gradients {skip:.3g} (bar "
        f"{TRAIN_TIGHT})")
    assert attn_same and torch.equal(l_skip, l_ex) and skip <= TRAIN_TIGHT
    # AdamW: three steps on the card against the CPU (bf16 embed, f32 rest)
    cfg, params, b = case(TRAIN_ARCH)
    _, _, grads = run(cfg, params, b, "cpu")
    params["embed"] = params["embed"].bfloat16()
    tcfg = TrainConfig(warmup_steps=2, total_steps=10)
    runs = []
    for where in ("cpu", dev):
        p = {k: v.detach().clone().to(where) for k, v in params.items()}
        st = adamw_init(p, where)
        for i in range(3):
            p, st, _ = adamw_update(
                p, {k: (gr * (1 + i)).to(where, p[k].dtype)
                    for k, gr in grads.items()}, st, tcfg)
        runs.append((p, st.m, st.v))
    adam = max(leaf_share(a, c) for a, c in zip(runs[1], runs[0]))
    say(f"[3l] (b) AdamW, 3 steps on the card vs the CPU: {adam:.3g} (bar "
        f"{TRAIN_TIGHT})")
    assert adam <= TRAIN_TIGHT
    worst.update(skip=skip, adam=adam)
    return worst


def train_phase(torch, dev):
    """Phase 3l: (a) ``train_full``, (b) ``train_identities``."""
    smi = " | ".join(nvidia_smi())
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rows, losses = train_full(torch, dev, smi)
    gc.collect()
    torch.cuda.empty_cache()
    ta = time.perf_counter() - t0
    worst = train_identities(torch, dev)
    say(f"[3l] (b) largest shares {worst}; (a) {ta:.1f} s, (b) "
        f"{time.perf_counter() - t0 - ta:.1f} s ({smi})")
    return rows, losses


# ---------------------------------------------------------------------------
# phase 3m: the training loop
# ---------------------------------------------------------------------------

LOOP_STEPS = 3
# (b) and (c): h2o-danube3-4b at full width, 2 of its 24 layers
LOOP_LAYERS = 2
DRILL_STEPS, DRILL_EVERY, DRILL_FAULT = 5, 2, 3
LOOP_SMOKE = ["h2o-danube3-4b", "deepseek-moe-16b", "zamba2-2.7b"]
BUILD = ROOT / "build"        # ignored by git: rendezvous, checkpoints


@contextlib.contextmanager
def deterministic(torch):
    """``torch.use_deterministic_algorithms`` on (warnings only, for ops
    without a deterministic version) inside the block."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


@contextlib.contextmanager
def one_rank_group(torch, backend):
    """A one-rank process group (a ``file://`` rendezvous under build/)."""
    import tempfile

    import torch.distributed as dist
    BUILD.mkdir(parents=True, exist_ok=True)
    d = tempfile.mkdtemp(dir=BUILD, prefix="pg_")
    dist.init_process_group(backend, init_method=f"file://{d}/rendezvous",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def state_equal(torch, a, b):
    """Bitwise: the step count, every parameter and both moments."""
    return torch.equal(a.opt.step, b.opt.step) and all(
        torch.equal(a.params[n], b.params[n])
        and torch.equal(a.opt.m[n], b.opt.m[n])
        and torch.equal(a.opt.v[n], b.opt.v[n]) for n in b.params)


def state_spread(a, b):
    """The largest |a - b| over each leaf's largest |b|, over the
    parameters and both moments."""
    return max(leaf_share(x, y) for x, y in ((a.params, b.params),
                                             (a.opt.m, b.opt.m),
                                             (a.opt.v, b.opt.v)))


def loop_full(torch, dev, smi):
    """(a) h2o-danube3-4b FULL through ``make_train_step`` with gradient
    accumulation (``TrainConfig(microbatch=2)``, remat on) on a batch of
    TRAIN_BATCH x 4,096, LOOP_STEPS steps without compression, then
    LOOP_STEPS with int8 from the same initial state (drawn again from
    the seed); each step's loss, grad_norm, lr and host ms ending in a
    synchronize, the peak; the first batch's loss at microbatch 0 beside
    the accumulated step's."""
    from repro_torch.configs import SHAPES, TrainConfig, get_config
    from repro_torch.data.lm import SyntheticLM
    from repro_torch.train.loop import init_state, make_train_step

    cfg, cell = get_config(TRAIN_ARCH), SHAPES["train_4k"]
    data = SyntheticLM(cfg.vocab_size, cell.seq_len, TRAIN_BATCH,
                       mode="markov", seed=SEED)
    say(f"[3m] (a) {cfg.name} FULL ({cfg.num_layers} layers, d_model "
        f"{cfg.d_model}; nothing of its width or depth cut): batch "
        f"{TRAIN_BATCH} x {cell.seq_len} in 2 microbatches, the "
        f"{cell.name} cell's global batch of {cell.global_batch} cut to "
        f"{TRAIN_BATCH}; {smi}")
    out = {}
    for comp in ("none", "int8"):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tcfg = TrainConfig(microbatch=2, grad_compression=comp, seed=SEED)
        t0 = time.perf_counter()
        state = init_state(cfg, tcfg, device=dev)
        torch.cuda.synchronize()
        say(f"[3m] (a) grad_compression={comp!r}: init_state on the card "
            f"in {time.perf_counter() - t0:.1f} s, "
            f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB")
        step = make_train_step(cfg, tcfg)
        if comp == "none":
            whole = make_train_step(cfg, dataclasses.replace(tcfg,
                                                             microbatch=0))
            l0, g0 = whole.gradients(state, data.batch(0, device=dev))
            l0 = float(l0)
            del g0
            gc.collect()
            torch.cuda.empty_cache()
        rows = []
        for s in range(LOOP_STEPS):
            batch = data.batch(s, device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            loss = float(m["loss"])
            assert np.isfinite(loss) and np.isfinite(float(m["grad_norm"]))
            rows.append((loss, float(m["grad_norm"]), float(m["lr"]), ms))
            say(f"[3m] (a) {comp} step {s + 1}: loss {loss:.6f} grad_norm "
                f"{float(m['grad_norm']):.5f} lr {float(m['lr']):.3e} "
                f"{ms:.1f} ms")
            if s == 0 and comp == "none":
                say(f"[3m] (a) step 1's batch at microbatch 0: loss "
                    f"{l0:.6f}, accumulated {loss:.6f}, difference "
                    f"{loss - l0:.3e}")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        med = statistics.median(r[3] for r in rows)
        say(f"[3m] (a) {comp}: median {med:.1f} ms a step; peak "
            f"{peak:.2f} GiB ({smi})")
        assert peak < 79.0, peak
        out[comp] = (rows, peak)
        del state, step
    return out


def loop_route(torch, dev, cfg, modes=("tp", "fsdp", "dp_only"),
               tag="[3m] (b)"):
    """(b) the route on a one-rank NCCL group: for each of ``modes``,
    without compression (microbatch 0) and with int8 (microbatch 2),
    LOOP_STEPS steps on the mesh == LOOP_STEPS with ``mesh=None``,
    bitwise (the parameters, both moments, the metrics), under
    deterministic algorithms; the mesh's median ms a step and peak."""
    from repro_torch.configs import TrainConfig
    from repro_torch.data.lm import SyntheticLM
    from repro_torch.launch.mesh import make_train_mesh
    from repro_torch.train.loop import init_state, make_train_step

    data = SyntheticLM(cfg.vocab_size, 4096, TRAIN_BATCH, seed=SEED)
    smi = " | ".join(nvidia_smi())
    results = {}
    with one_rank_group(torch, "nccl"), deterministic(torch):
        mesh = make_train_mesh((1, 1), device=dev)
        for mode in modes:
            for mb, comp in ((0, "none"), (2, "int8")):
                tcfg = TrainConfig(microbatch=mb, grad_compression=comp,
                                   sharding_mode=mode, seed=SEED)
                runs = []
                for m in (None, mesh):
                    gc.collect()
                    torch.cuda.empty_cache()
                    torch.cuda.reset_peak_memory_stats()
                    state = init_state(cfg, tcfg, m, device=dev)
                    step = make_train_step(cfg, tcfg, m)
                    mets, ms = [], []
                    for s in range(LOOP_STEPS):
                        batch = data.batch(s, device=dev)
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        state, met = step(state, batch)
                        torch.cuda.synchronize()
                        ms.append((time.perf_counter() - t0) * 1e3)
                        mets.append(met)
                    runs.append((state, mets, statistics.median(ms),
                                 torch.cuda.max_memory_allocated() / 2 ** 30))
                (want, wm, _, _), (got, gm, ms, peak) = runs
                same = state_equal(torch, got, want) and all(
                    torch.equal(g[k], w[k]) for g, w in zip(gm, wm)
                    for k in w)
                say(f"{tag} {mode}, microbatch {mb}, {comp}: "
                    f"{LOOP_STEPS} steps on the one-rank NCCL mesh == "
                    f"mesh=None bitwise: {same} (losses "
                    f"{[round(float(x['loss']), 6) for x in gm]}); median "
                    f"{ms:.1f} ms a step, peak {peak:.2f} GiB ({smi})")
                assert same, (mode, comp)
                results[(mode, comp)] = (ms, peak)
                del runs, want, got
    return results


def loop_drill(torch, dev, cfg):
    """(c) the fault drill: ``train()`` DRILL_STEPS steps clean twice, then
    with checkpoints every DRILL_EVERY and a fault at step DRILL_FAULT,
    into a temporary directory under build/: restarts == 1; the final
    loss and parameters against the clean run (bitwise when the two clean
    runs agree bitwise; else the spread is printed, and the drill runs
    again under deterministic algorithms, where it must); a port
    checkpoint reloads bitwise, bf16 leaves included."""
    import shutil
    import tempfile

    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.configs import TrainConfig
    from repro_torch.distributed.fault import FaultInjector
    from repro_torch.train.loop import state_template, train

    BUILD.mkdir(parents=True, exist_ok=True)
    free = shutil.disk_usage(BUILD).free
    say(f"[3m] (c) free disk under {BUILD}: {free / 1e9:.1f} GB")
    tcfg = TrainConfig(seed=SEED)
    kw = dict(steps=DRILL_STEPS, batch_shape=(1, 4096), verbose=False,
              device=dev)

    def drill(tag):
        clean = [train(cfg, tcfg, **kw) for _ in range(2)]
        work = tempfile.mkdtemp(dir=BUILD, prefix="ckpt_")
        try:
            t0 = time.perf_counter()
            faulted = train(cfg, tcfg, workdir=work, ckpt_every=DRILL_EVERY,
                            injector=FaultInjector((DRILL_FAULT,)), **kw)
            wall = time.perf_counter() - t0
            step_dir = Path(work) / f"step_{DRILL_EVERY * 2:06d}"
            nbytes = sum(f.stat().st_size for f in step_dir.rglob("*.npy"))
            t0 = time.perf_counter()
            _, trees = load_checkpoint(work, state_template(cfg),
                                       device=dev)
            t_load = time.perf_counter() - t0
        finally:
            shutil.rmtree(work, ignore_errors=True)
        st = trees["state"]
        bf16 = [n for n, p in st["params"].items()
                if p.dtype == torch.bfloat16]
        say(f"[3m] (c) {tag}: restarts {faulted.restarts}; checkpoint "
            f"{nbytes / 1e9:.3f} GB ({len(bf16)} bf16 leaves); saves: "
            f"snapshot {fmt(faulted.ckpt_snapshot_s)} s, write "
            f"{fmt(faulted.ckpt_write_s)} s; restore "
            f"{fmt(faulted.restore_s)} s; reload {t_load:.2f} s; the "
            f"faulted run {wall:.1f} s; losses "
            f"{[round(x, 6) for x in faulted.losses]}")
        assert faulted.restarts == 1 and bf16
        twins = state_equal(torch, clean[0].final_state,
                            clean[1].final_state) and \
            clean[0].losses == clean[1].losses
        same = state_equal(torch, faulted.final_state, clean[0].final_state) \
            and faulted.final_loss == clean[0].final_loss
        spread = state_spread(clean[1].final_state, clean[0].final_state)
        dist_f = state_spread(faulted.final_state, clean[0].final_state)
        say(f"[3m] (c) {tag}: two clean runs bitwise: {twins} (spread "
            f"{spread:.3g}, final losses {clean[0].final_loss!r} / "
            f"{clean[1].final_loss!r}); the faulted run == the clean run "
            f"bitwise: {same} (spread {dist_f:.3g}, final loss "
            f"{faulted.final_loss!r})")
        return twins, same, faulted, trees, spread, dist_f

    twins, same, faulted, trees, spread, dist_f = drill("default")
    if twins:
        assert same
    else:
        with deterministic(torch):
            twins_d, same_d, faulted, trees, _, _ = drill("deterministic")
        assert twins_d and same_d
    # a port checkpoint reloads bitwise, bf16 leaves included
    from repro_torch.checkpoint import save_checkpoint
    work = tempfile.mkdtemp(dir=BUILD, prefix="ckpt_")
    try:
        save_checkpoint(work, 1, trees)
        _, again = load_checkpoint(work, state_template(cfg), device=dev)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    a, b = trees["state"], again["state"]
    reload_same = torch.equal(a["opt"].step, b["opt"].step) and all(
        torch.equal(a[g][n], b[g][n]) for g in ("params",)
        for n in a["params"]) and all(
        torch.equal(getattr(a["opt"], f)[n], getattr(b["opt"], f)[n])
        for f in ("m", "v") for n in a["params"])
    say(f"[3m] (c) a port checkpoint reloads bitwise: {reload_same}")
    assert reload_same
    return faulted, twins, spread, dist_f


def loop_identities(torch, dev):
    """(d) SMOKE in float32 on the card against the CPU: ``make_train_
    step``'s gradients (as AdamW receives them) with microbatch 2, and
    with int8, within max(TRAIN_TOL, twice the CPU's rounding floor) of
    each leaf's largest (plus one quantization step of the row's scale
    under int8), the step's loss and grad_norm within 1e-5; and
    ``quantize_int8`` on the card == the CPU's, bitwise."""
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.data.lm import SyntheticLM
    from repro_torch.distributed.compression import quantize_int8
    from repro_torch.models.params import init_params
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train.loop import TrainState, make_train_step

    def state_on(params, where):
        p = {k: v.detach().clone().to(where) for k, v in params.items()}
        return TrainState(p, adamw_init(p, where))

    def rel(a, b):
        return abs(a - b) / max(1.0, abs(b))

    worst = {}
    for arch in LOOP_SMOKE:
        cfg = get_config(arch, smoke=True).replace(dtype="float32",
                                                   kv_cache_dtype="float32")
        params = init_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
        batch = SyntheticLM(cfg.vocab_size, 64, 4, seed=SEED).batch(
            0, device="cpu")
        fl = None
        for comp in ("none", "int8"):
            tcfg = TrainConfig(microbatch=2, grad_compression=comp,
                               seed=SEED)
            step = make_train_step(cfg, tcfg)
            l_cpu, g_cpu = step.gradients(state_on(params, "cpu"), batch)
            l_dev, g_dev = step.gradients(state_on(params, dev), batch)
            if fl is None:      # the float floor, before any quantization
                fl = 0.0
                for i in (1, 2):
                    e = params["embed"]
                    e = e * (1 + 2 ** -24 * torch.randn(
                        e.shape, generator=torch.Generator().manual_seed(
                            SEED + i)))
                    fl = max(fl, leaf_share(step.gradients(
                        state_on(dict(params, embed=e), "cpu"), batch)[1],
                        g_cpu))
            bar = max(TRAIN_TOL, 2 * fl)
            share = 0.0
            for n, g in g_cpu.items():
                err = (g_dev[n].float().cpu() - g).abs()
                allow = bar * g.abs().max().clamp_min(1e-30)
                if comp == "int8":
                    allow = allow + quantize_int8(g)[1]
                assert bool((err <= allow).all()), (arch, comp, n)
                share = max(share, float((err / allow).max()))
            s_cpu, m_cpu = step(state_on(params, "cpu"), batch)
            s_dev, m_dev = step(state_on(params, dev), batch)
            dl = rel(float(m_dev["loss"]), float(m_cpu["loss"]))
            dn = rel(float(m_dev["grad_norm"]), float(m_cpu["grad_norm"]))
            say(f"[3m] (d) {arch} SMOKE f32, microbatch 2, {comp}: "
                f"gradients at {share:.3g} of the bar (bar {bar:.3g}: the "
                f"CPU's floor {fl:.3g}"
                f"{' + a quantization step' if comp == 'int8' else ''}); "
                f"loss {dl:.3g}, grad_norm {dn:.3g} (bar 1e-5)")
            assert dl <= 1e-5 and dn <= 1e-5, (arch, comp)
            worst[(arch, comp)] = share
            if comp == "int8":
                g = g_cpu["blocks_w1" if "blocks_w1" in g_cpu else "embed"]
                q_c, s_c = quantize_int8(g)
                q_d, s_d = quantize_int8(g.to(dev))
                ties = torch.tensor([[127.0, 0.5, 1.5, 2.5, -0.5, -2.5,
                                      126.5, 0.0], [0.0] * 8])
                q_t, s_t = quantize_int8(ties.to(dev))
                same = torch.equal(q_d.cpu(), q_c) and torch.equal(
                    s_d.cpu(), s_c) and torch.equal(
                    q_t.cpu(), quantize_int8(ties)[0]) and torch.equal(
                    s_t.cpu(), quantize_int8(ties)[1])
                say(f"[3m] (d) {arch}: quantize_int8 on the card == the "
                    f"CPU bitwise (a gradient leaf, .5 ties, a zero row): "
                    f"{same}")
                assert same, arch
    return worst


def loop_phase(torch, dev):
    """Phase 3m: (a) ``loop_full``, (b) ``loop_route``, (c) ``loop_drill``,
    (d) ``loop_identities``."""
    from repro_torch.configs import get_config
    smi = " | ".join(nvidia_smi())
    t0 = time.perf_counter()
    full = loop_full(torch, dev, smi)
    gc.collect()
    torch.cuda.empty_cache()
    ta = time.perf_counter() - t0
    cfg = get_config(TRAIN_ARCH).replace(num_layers=LOOP_LAYERS)
    say(f"[3m] (b), (c): {cfg.name} at full width, {LOOP_LAYERS} of 24 "
        f"layers: {cfg.param_count() / 1e9:.3f} B parameters")
    loop_route(torch, dev, cfg)
    say("[3m] (b) no route over more than one rank runs here: this "
        "machine has one card and NCCL takes one rank a card (3n (b))")
    tb = time.perf_counter() - t0 - ta
    loop_drill(torch, dev, cfg)
    tc = time.perf_counter() - t0 - ta - tb
    gc.collect()
    torch.cuda.empty_cache()
    loop_identities(torch, dev)
    say(f"[3m] (a) {ta:.1f} s, (b) {tb:.1f} s, (c) {tc:.1f} s, (d) "
        f"{time.perf_counter() - t0 - ta - tb - tc:.1f} s ({smi})")
    return full


# ---------------------------------------------------------------------------
# phase 3n: the model axis in training
# ---------------------------------------------------------------------------

TP_ARCHS = ["h2o-danube3-4b", "deepseek-moe-16b"]
TP_LAYERS = 2                  # of 24 (h2o-danube3-4b) and 28 (deepseek-moe)
TP_BATCH, TP_SEQ = 2, 256      # (b)'s global batch
TP_TIMEOUT = 600               # s, (b)'s two processes


def _tp_probe(torch, dist, dev, rank, world):
    """Each collective the route runs, on CUDA tensors over the gloo
    group, in order, its result checked: [(name, "ok" or the error)],
    stopping at the first that fails."""
    mine = torch.arange(8, dtype=torch.float32, device=dev) + 10 * rank
    every = [torch.arange(8, dtype=torch.float32) + 10 * r
             for r in range(world)]

    def all_reduce(op, want):
        t = mine.clone()
        dist.all_reduce(t, op=op)
        return torch.equal(t.cpu(), want)

    def gather():
        out = torch.empty(8 * world, device=dev)
        dist.all_gather_into_tensor(out, mine)
        return torch.equal(out.cpu(), torch.cat(every))

    def scatter():
        out = torch.empty(8 // world, device=dev)
        dist.reduce_scatter_tensor(out, mine)
        n = 8 // world
        return torch.equal(out.cpu(), sum(every)[rank * n:(rank + 1) * n])

    def int32_max():
        t = mine.to(torch.int32)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return torch.equal(t.cpu(), every[-1].to(torch.int32))

    probes = [("all_reduce(SUM)",
               lambda: all_reduce(dist.ReduceOp.SUM, sum(every))),
              ("all_reduce(MAX)",
               lambda: all_reduce(dist.ReduceOp.MAX, every[-1])),
              ("all_gather_into_tensor", gather),
              ("reduce_scatter_tensor", scatter),
              ("all_reduce(MAX) on int32", int32_max)]
    rows = []
    for name, fn in probes:
        try:
            ok = fn()
            torch.cuda.synchronize()
            rows.append((name, "ok" if ok else "wrong result"))
        except Exception as e:              # the probe's answer
            rows.append((name, f"{type(e).__name__}: "
                               f"{str(e).splitlines()[0][:300]}"))
        if rows[-1][1] != "ok":
            break
    return rows


def _tp_route(torch, dist, dev, rank, arch):
    """One arch at full width, TP_LAYERS layers, float32: rank 0's
    one-rank step on the card first (the first step's gradients and
    LOOP_STEPS steps' metrics), then both ranks on a (1, 2) tp mesh."""
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.data.lm import SyntheticLM
    from repro_torch.distributed.shardings import named
    from repro_torch.launch.mesh import make_train_mesh
    from repro_torch.train.loop import (init_state, make_train_step,
                                        state_pspecs)
    cfg = get_config(arch).replace(num_layers=TP_LAYERS, dtype="float32")
    tcfg = TrainConfig(sharding_mode="tp", seed=SEED)
    data = SyntheticLM(cfg.vocab_size, TP_SEQ, TP_BATCH, seed=SEED)

    def run(mesh):
        torch.cuda.reset_peak_memory_stats()
        state = init_state(cfg, tcfg, mesh, device=dev)
        step = make_train_step(cfg, tcfg, mesh)
        _, g = step.gradients(state, data.batch(0, device=dev))
        if mesh is not None:
            pl = named(mesh, state_pspecs(cfg, tcfg, False, mesh))
            g = {n: pl.opt.m[n].gather(v) for n, v in g.items()}
        g = {n: v.cpu() for n, v in g.items()}
        mets, ms = [], []
        for s in range(LOOP_STEPS):
            batch = data.batch(s, device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            mets.append({k: float(v) for k, v in m.items()})
        same = True
        if mesh is not None:     # replicated leaves: max == min bitwise
            for n, p in state.params.items():
                if pl.params[n].model is not None:
                    continue
                bits = p.contiguous().view(torch.int32)
                hi, lo = bits.clone(), bits.clone()
                dist.all_reduce(hi, op=dist.ReduceOp.MAX)
                dist.all_reduce(lo, op=dist.ReduceOp.MIN)
                same = same and torch.equal(hi, lo)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        del state, step
        gc.collect()
        torch.cuda.empty_cache()
        return g, mets, statistics.median(ms), peak, same

    ref = run(None) if rank == 0 else None
    dist.barrier()
    got = run(make_train_mesh((1, 2), device=dev))
    if rank != 0:
        return None
    (wg, wm, wms, wpeak, _), (gg, gm, gms, gpeak, same) = ref, got
    share = max(float((gg[n] - w).abs().max())
                / max(float(w.abs().max()), 1e-30) for n, w in wg.items())
    dl = max(abs(g["loss"] - w["loss"]) / abs(w["loss"])
             for g, w in zip(gm, wm))
    dn = max(abs(g["grad_norm"] - w["grad_norm"]) / abs(w["grad_norm"])
             for g, w in zip(gm, wm))
    return {"arch": arch, "params_b": cfg.param_count() / 1e9,
            "grad_share": share, "loss_rel": dl, "gnorm_rel": dn,
            "losses": [m["loss"] for m in gm], "replicated_equal": same,
            "ms_one_rank": wms, "ms_tp2": gms, "peak_one_rank": wpeak,
            "peak_tp2_rank0": gpeak}


def tp_rank_main(rank: int, out_dir: str) -> int:
    """One of (b)'s two processes: the probe, then, where every
    collective carries, the route for TP_ARCHS; rank 0 writes
    ``result.json`` in ``out_dir``."""
    import datetime

    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/pg",
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=120))
    res = {"probe": _tp_probe(torch, dist, dev, rank, 2), "routes": []}
    try:
        if all(r[1] == "ok" for r in res["probe"]):
            zero_counts()
            with deterministic(torch):
                for arch in TP_ARCHS:
                    res["routes"].append(_tp_route(torch, dist, dev, rank,
                                                   arch))
            write_counts(out_dir, rank)
    finally:
        if rank == 0:
            Path(out_dir, "result.json").write_text(json.dumps(res))
        dist.destroy_process_group()
    return 0


def zero_counts():
    """A rank process's kernel launch and dispatch counts set to 0, just
    before its path."""
    from repro_torch.kernels import _build, ops
    ops.KERNEL_COUNTS.clear()
    _build.LAUNCHES.clear()


def write_counts(out_dir: str, rank: int):
    """A rank process's counts since ``zero_counts``, read just after its
    path, into ``counts<rank>.json`` in ``out_dir``."""
    from repro_torch.kernels import _build, ops
    Path(out_dir, f"counts{rank}.json").write_text(json.dumps(
        {"launches": dict(_build.LAUNCHES),
         "dispatches": dict(ops.KERNEL_COUNTS)}))


def read_counts(out_dir: str, world: int):
    """Every rank process's counts (``write_counts``), by rank."""
    return [json.loads(Path(out_dir, f"counts{r}.json").read_text())
            for r in range(world)]


def tp_two_ranks(torch, smi):
    """(b): two processes on the card (``tp_rank_main``), waited on with
    TP_TIMEOUT and killed past it."""
    import tempfile
    BUILD.mkdir(parents=True, exist_ok=True)
    d = tempfile.mkdtemp(dir=BUILD, prefix="tp2_")
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                               "--tp-rank", str(r), d]) for r in (0, 1)]
    t0 = time.perf_counter()
    try:
        for p in procs:
            p.wait(timeout=max(1.0, TP_TIMEOUT - (time.perf_counter() - t0)))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    res = json.loads(Path(d, "result.json").read_text())
    for name, verdict in res["probe"]:
        say(f"[3n] (b) probe: {name} over gloo on CUDA tensors, two "
            f"processes on one card: {verdict}")
    failed = [r for r in res["probe"] if r[1] != "ok"]
    if failed:
        say(f"[3n] (b) two ranks cannot run the route on this card: "
            f"{failed[0][0]} failed ({failed[0][1]}); (b) runs no further")
        assert all(p.returncode == 0 for p in procs)
        return res
    assert all(p.returncode == 0 for p in procs), \
        [p.returncode for p in procs]
    res["counts"] = read_counts(d, 2)
    for r in res["routes"]:
        say(f"[3n] (b) {r['arch']} full width, {TP_LAYERS} layers "
            f"({r['params_b']:.3f} B parameters), float32, batch "
            f"{TP_BATCH} x {TP_SEQ}: tp=2 on two processes against the "
            f"one-rank step: first-step gradients at {r['grad_share']:.3g} "
            f"of each leaf's largest (bar 1e-5), losses {r['loss_rel']:.3g}"
            f", grad norms {r['gnorm_rel']:.3g} relative (bar 1e-5), "
            f"replicated leaves bitwise equal on both ranks: "
            f"{r['replicated_equal']}; median {r['ms_tp2']:.1f} ms a step "
            f"(one rank {r['ms_one_rank']:.1f} ms), peak rank 0 "
            f"{r['peak_tp2_rank0']:.2f} GiB (one rank "
            f"{r['peak_one_rank']:.2f} GiB) ({smi})")
        assert r["grad_share"] <= 1e-5 and r["loss_rel"] <= 1e-5 \
            and r["gnorm_rel"] <= 1e-5 and r["replicated_equal"], r
    return res


def tp_phase(torch, dev):
    """Phase 3n: (a) ``loop_route`` under tp and fsdp, (b)
    ``tp_two_ranks``."""
    from repro_torch.configs import get_config
    smi = " | ".join(nvidia_smi())
    t0 = time.perf_counter()
    cfg = get_config(TRAIN_ARCH).replace(num_layers=LOOP_LAYERS)
    say(f"[3n] (a) {cfg.name} at full width, {LOOP_LAYERS} of 24 layers: "
        f"{cfg.param_count() / 1e9:.3f} B parameters")
    loop_route(torch, dev, cfg, modes=("tp", "fsdp"), tag="[3n] (a)")
    gc.collect()
    torch.cuda.empty_cache()
    ta = time.perf_counter() - t0
    res = tp_two_ranks(torch, smi)
    say(f"[3n] (a) {ta:.1f} s, (b) {time.perf_counter() - t0 - ta:.1f} s "
        f"({smi})")
    return {"(b)": res["counts"]} if "counts" in res else {}


# ---------------------------------------------------------------------------
# phase 3o: the model axis in serving
# ---------------------------------------------------------------------------

SERVE_TP_ARCH = "h2o-danube3-4b"     # (a): full width and depth, bf16
SERVE_TP_LEN = 4608                   # (a)'s dense prompts, past the window
SERVE_ID_ARCHS = ("h2o-danube3-4b", "internvl2-26b", "deepseek-moe-16b")
SERVE_ID_LAYERS = 2                   # (b): full width, float32
SERVE_ID_LEN = {"h2o-danube3-4b": 4608, "deepseek-moe-16b": 1024}
SERVE_SEQ_ARCHS = ("h2o-danube3-4b", "gemma3-27b")   # (c): SMOKE, tp 4
SERVE_SEQ_LEN = 40                    # (c)'s prompt, past SMOKE's window 32
SERVE_ID_STEPS = 6                    # teacher-forced steps of (b), (c)
SERVE_ID_TOL = 1e-5                   # of the largest |logit|
SERVE_TP_TIMEOUT = 480                # s, each set of rank processes


def f32(cfg):
    """``cfg`` with float32 weights and caches."""
    return cfg.replace(dtype="float32", kv_cache_dtype="float32")


def shard_params(cfg, full, mesh):
    """This rank's model shard of the full parameters (``param_pspecs``'
    tp mode, as training cuts them)."""
    from repro_torch.distributed.shardings import named, param_pspecs
    from repro_torch.models.params import param_specs
    pl = named(mesh, param_pspecs(cfg, param_specs(cfg), "tp", mesh=mesh))
    return {n: pl[n].shard(v) for n, v in full.items()}


def timed_serve(torch, engine, reqs, steps):
    """``engine.serve(reqs)`` with each request's prefill and each group
    decode step timed on the host clock, each ending in a synchronize:
    (tokens {rid: list}, prefill ms, decode ms per step, wall ms)."""
    prefill_ms, decode_ms = [], []

    def timed(fn, into):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            into.append(round((time.perf_counter() - t) * 1e3, 3))
            return out
        return run

    engine.prefill = timed(engine.prefill, prefill_ms)
    engine.roi_prefill = timed(engine.roi_prefill, prefill_ms)
    engine._decode_group = timed(engine._decode_group, decode_ms)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = engine.serve(reqs, greedy_steps=steps)
    wall = (time.perf_counter() - t0) * 1e3
    return ({int(k): v.tolist() for k, v in out.items()}, prefill_ms,
            decode_ms, wall)


def _serve_full(torch, dist, dev, rank, mesh, d, cfg, prompts, steps):
    """(a): ``cfg``'s engine serving ``prompts`` at the mesh's tp, rank 0
    first alone on the full parameters (the one-rank engine); each
    rank's tokens, times and peak memory."""
    from repro_torch.configs import ServeConfig
    from repro_torch.models.params import init_params
    from repro_torch.serving.engine import Request, ServingEngine

    def reqs():
        return [Request(i, tokens=t, keep=k, max_new_tokens=steps)
                for i, (t, k) in enumerate(prompts)]

    scfg = ServeConfig(max_batch=4, roi_sparsity=True)
    full = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                       dev)
    one = None
    if rank == 0:
        torch.cuda.reset_peak_memory_stats()
        one = timed_serve(torch, ServingEngine(cfg, scfg, full), reqs(),
                          steps)
        one += (torch.cuda.max_memory_allocated() / 2 ** 30,)
    params = shard_params(cfg, full, mesh)
    del full
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    got = timed_serve(torch, ServingEngine(cfg, scfg, params, dist=d),
                      reqs(), steps)
    got += (torch.cuda.max_memory_allocated() / 2 ** 30,)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    every = [None] * mesh.size("model")
    dist.all_gather_object(every, got)
    keys = ("tokens", "prefill_ms", "decode_ms", "wall_ms", "peak_gib")
    return None if rank else {
        "one": dict(zip(keys, one)),
        "ranks": [dict(zip(keys, g)) for g in every]}


def _identity_inputs(torch, cfg, dev, length):
    """(b), (c)'s prompt: ``length`` token ids, or for vlm the fleet
    frame's patch stream packed by its RoI keep-list (CrossRoI's kept
    tokens, ``fleet_keep``); the teacher-forced tokens: (batch, prefill
    keywords, decode tokens (1, SERVE_ID_STEPS), start position,
    max_seq)."""
    from repro_torch.kernels import ops
    rng = np.random.default_rng((SEED, 340))
    teach = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                         (1, SERVE_ID_STEPS)), device=dev)
    if cfg.family == "vlm":
        keep = torch.as_tensor(fleet_keep(fleet_grids(
            np.random.default_rng(SEED))), device=dev)
        x = torch.as_tensor(rng.standard_normal(
            (keep.shape[0], cfg.frontend_dim)), dtype=torch.float32,
            device=dev)
        packed, positions, n = ops.pack_tokens(x, keep)
        batch = {"tokens": torch.zeros((1, 0), dtype=torch.long,
                                       device=dev),
                 "patches": packed[None]}
        kw = {"positions": positions[None], "last_index": n - 1}
        return batch, kw, teach, n, packed.shape[0] + SERVE_ID_STEPS
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, length)),
                           device=dev)
    return {"tokens": toks}, {}, teach, length, length + SERVE_ID_STEPS


def teacher_forced(torch, M, params, cfg, dev, inputs, d=None):
    """Prefill and SERVE_ID_STEPS teacher-forced decode steps: each
    call's last-row logits (float32, on the host) and its ms."""
    batch, kw, teach, start, max_seq = inputs
    caches = M.init_cache(cfg, 1, max_seq, dev, dist=d)
    out, ms = [], []
    for i in range(-1, SERVE_ID_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        if i < 0:
            logits, caches = M.prefill(params, cfg, batch, caches, dist=d,
                                       **kw)
        else:
            logits, caches = M.decode_step(params, cfg, teach[:, i:i + 1],
                                           caches, start + i, dist=d)
        torch.cuda.synchronize()
        ms.append(round((time.perf_counter() - t) * 1e3, 3))
        out.append(logits[0, -1].float().cpu())
    return out, ms


def _serve_identity(torch, dist, dev, rank, mesh, d, cfg, length):
    """(b), (c): rank 0's one-rank teacher-forced run on the full
    parameters, then every rank's on its shard: each call's largest
    |logit| error as a share of the one-rank call's largest |logit|."""
    from repro_torch.models import model as M
    from repro_torch.models.params import init_params
    full = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                       dev)
    inputs = _identity_inputs(torch, cfg, dev, length)
    with torch.no_grad():
        ref = teacher_forced(torch, M, full, cfg, dev, inputs) \
            if rank == 0 else None
        params = shard_params(cfg, full, mesh)
        del full
        gc.collect()
        torch.cuda.empty_cache()
        dist.barrier()
        got = teacher_forced(torch, M, params, cfg, dev, inputs, d)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    every = [None] * mesh.size("model")
    dist.all_gather_object(every, got[0])
    if rank:
        return None
    want = ref[0]
    shares = [max(float((g[i] - w).abs().max()) / float(w.abs().max())
                  for g in every) for i, w in enumerate(want)]
    return {"arch": cfg.name, "layers": cfg.num_layers,
            "params_b": cfg.param_count() / 1e9, "shares": shares,
            "scale": max(float(w.abs().max()) for w in want),
            "ms_one": ref[1], "ms_tp": got[1], "start": inputs[3],
            "kv_heads": cfg.num_kv_heads}


def _serve_seq(torch, dist, dev, rank, mesh, d, cfg):
    """(c): ``_serve_identity`` of a SMOKE config whose KV heads do not
    divide over the mesh (the sequence split), then its engine's tokens
    on every rank against the one-rank engine's."""
    from repro_torch.configs import ServeConfig
    from repro_torch.models.params import init_params
    from repro_torch.serving.engine import Request, ServingEngine
    res = _serve_identity(torch, dist, dev, rank, mesh, d, cfg,
                          SERVE_SEQ_LEN)
    rng = np.random.default_rng((SEED, 341))
    prompts = [(rng.integers(0, cfg.vocab_size, SERVE_SEQ_LEN - 3 * i)
                .astype(np.int32), None) for i in range(3)]
    reqs = [Request(i, tokens=t, max_new_tokens=SERVE_ID_STEPS)
            for i, (t, _) in enumerate(prompts)]
    full = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                       dev)
    scfg = ServeConfig(max_batch=4)
    one = ServingEngine(cfg, scfg, full).serve(
        reqs, greedy_steps=SERVE_ID_STEPS) if rank == 0 else None
    eng = ServingEngine(cfg, scfg, shard_params(cfg, full, mesh), dist=d)
    got = eng.serve(reqs, greedy_steps=SERVE_ID_STEPS)
    every = [None] * mesh.size("model")
    dist.all_gather_object(every, {k: v.tolist() for k, v in got.items()})
    if rank:
        return None
    res["tokens_one"] = {k: v.tolist() for k, v in one.items()}
    res["tokens_ranks"] = every
    res["cache"] = {k: tuple(v[0].shape) for k, v in eng._ring.items()}
    return res


def _bf16_probe(torch, dist, dev, rank, world):
    """The bfloat16 collectives of (a)'s route over the gloo group on
    CUDA tensors: [(name, "ok" or the error)]."""
    rows = []
    for name in ("all_reduce(SUM) bf16", "all_gather_into_tensor bf16"):
        try:
            t = torch.full((8,), rank + 1, dtype=torch.bfloat16, device=dev)
            if name.startswith("all_reduce"):
                dist.all_reduce(t)
                ok = bool((t == world * (world + 1) // 2).all())
            else:
                out = torch.empty(8 * world, dtype=torch.bfloat16,
                                  device=dev)
                dist.all_gather_into_tensor(out, t)
                ok = torch.equal(out.cpu(), torch.arange(
                    1, world + 1, dtype=torch.bfloat16).repeat_interleave(8))
            torch.cuda.synchronize()
            rows.append((name, "ok" if ok else "wrong result"))
        except Exception as e:              # the probe's answer
            rows.append((name, f"{type(e).__name__}: "
                               f"{str(e).splitlines()[0][:300]}"))
    return rows


def serve_rank_main(rank: int, world: int, out_dir: str) -> int:
    """One of phase 3o's rank processes on the card, on a (1, world) mesh
    over gloo: the probes, then with 2 ranks (a) and (b), with 4 (c);
    rank 0 writes ``result.json`` in ``out_dir``."""
    import datetime

    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(SRC))
    from repro_torch.distributed.shardings import make_dist
    from repro_torch.launch.mesh import make_train_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/pg",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    res = {"probe": _tp_probe(torch, dist, dev, rank, world)
           + _bf16_probe(torch, dist, dev, rank, world)}
    try:
        if all(r[1] == "ok" for r in res["probe"]):
            from repro_torch.configs import get_config
            mesh = make_train_mesh((1, world), device=dev)
            args = (torch, dist, dev, rank, mesh, make_dist(mesh))
            zero_counts()
            with deterministic(torch):
                if world == 2:
                    cfg = get_config(SERVE_TP_ARCH)
                    res["full"] = _serve_full(
                        *args, cfg, decoder_prompts(cfg, SERVE_TP_LEN),
                        DECODER_STEPS)
                    res["identities"] = [_serve_identity(
                        *args, f32(get_config(a).replace(
                            num_layers=SERVE_ID_LAYERS)),
                        SERVE_ID_LEN.get(a, 0)) for a in SERVE_ID_ARCHS]
                else:
                    res["seq"] = [_serve_seq(
                        *args, f32(get_config(a, smoke=True)))
                        for a in SERVE_SEQ_ARCHS]
            write_counts(out_dir, rank)
        res["done"] = True
    finally:
        if rank == 0:
            Path(out_dir, "result.json").write_text(json.dumps(res))
        dist.destroy_process_group()
    return 0


def spawn_ranks(world: int):
    """``world`` rank processes of ``serve_rank_main`` on the card, waited
    on with SERVE_TP_TIMEOUT and killed past it; rank 0's result."""
    import tempfile
    BUILD.mkdir(parents=True, exist_ok=True)
    d = tempfile.mkdtemp(dir=BUILD, prefix=f"serve{world}_")
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                               "--serve-rank", str(r), str(world), d])
             for r in range(world)]
    t0 = time.perf_counter()
    try:
        for p in procs:
            p.wait(timeout=max(1.0, SERVE_TP_TIMEOUT
                               - (time.perf_counter() - t0)))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), \
        [p.returncode for p in procs]
    res = json.loads(Path(d, "result.json").read_text())
    for name, verdict in res["probe"]:
        say(f"[3o] probe on {world} processes: {name} over gloo on CUDA "
            f"tensors: {verdict}")
    assert all(r[1] == "ok" for r in res["probe"]) and res.get("done"), res
    res["counts"] = read_counts(d, world)
    return res


def say_identity(tag, r, smi):
    say(f"{tag} {r['arch']} ({r['layers']} layers, {r['params_b']:.3f} B "
        f"parameters, KV heads {r['kv_heads']}), float32: prefill and "
        f"{SERVE_ID_STEPS} teacher-forced decode steps from position "
        f"{r['start']} against the one-rank path: error per call as a "
        f"share of the largest |logit| ({r['scale']:.4f}) {fmt(r['shares'])}"
        f" (bar {SERVE_ID_TOL}); ms per call one rank {r['ms_one']}, tp "
        f"{r['ms_tp']} ({smi})")
    assert max(r["shares"]) <= SERVE_ID_TOL, r["shares"]


def serve_one_rank(torch, dev, smi):
    """The route on one rank: h2o-danube3-4b at full width, 2 layers,
    bf16, prefill of a prompt past the window and one decode step on a
    one-rank NCCL group's (1, 1) mesh, against ``dist=None``: the logits
    and every cache tensor bitwise."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.shardings import make_dist
    from repro_torch.launch.mesh import make_train_mesh
    from repro_torch.models import model as M
    from repro_torch.models.params import init_params
    cfg = get_config(SERVE_TP_ARCH).replace(num_layers=2)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                         dev)
    toks = torch.as_tensor(decoder_prompts(cfg, SERVE_TP_LEN)[0][0],
                           device=dev)[None]

    def run(d):
        caches = M.init_cache(cfg, 1, SERVE_TP_LEN + 1, dev, dist=d)
        lp, caches = M.prefill(params, cfg, {"tokens": toks}, caches,
                               dist=d)
        ld, caches = M.decode_step(params, cfg, lp[:, -1].argmax(-1)[:, None],
                                   caches, SERVE_TP_LEN, dist=d)
        return [lp, ld, *caches["blocks"]]

    with torch.no_grad(), deterministic(torch):
        want = run(None)
        with one_rank_group(torch, "nccl"):
            got = run(make_dist(make_train_mesh((1, 1), device=dev)))
    same = all(torch.equal(g, w) for g, w in zip(got, want))
    say(f"[3o] (d) {cfg.name} full width, 2 layers, bf16: prefill of "
        f"{SERVE_TP_LEN} tokens and a decode step on the one-rank NCCL "
        f"mesh == dist=None bitwise (logits and caches): {same} ({smi})")
    assert same


def serve_tp_phase(torch, dev):
    """Phase 3o: (d) ``serve_one_rank``; (a) and (b) on two rank
    processes, (c) on four (``spawn_ranks``)."""
    from repro_torch.configs import get_config
    smi = " | ".join(nvidia_smi())
    t0 = time.perf_counter()
    serve_one_rank(torch, dev, smi)
    gc.collect()
    torch.cuda.empty_cache()
    td = time.perf_counter() - t0
    res = spawn_ranks(2)
    counts = {"(a)+(b)": res["counts"]}
    f = res["full"]
    lens = [len(t) for t, _ in decoder_prompts(get_config(SERVE_TP_ARCH),
                                               SERVE_TP_LEN)]
    say(f"[3o] (a) {SERVE_TP_ARCH} full width and depth, bf16, served at "
        f"tp=2 on two processes: prompts of {lens} tokens (two "
        f"keep-lists), {DECODER_STEPS} greedy steps")
    one = f["one"]
    say(f"[3o] (a) one rank: prefill ms {one['prefill_ms']}; decode ms per "
        f"step {one['decode_ms']} (median "
        f"{statistics.median(one['decode_ms']):.3f}); wall "
        f"{one['wall_ms']:.1f} ms; peak {one['peak_gib']:.2f} GiB; tokens "
        f"{one['tokens']} ({smi})")
    for r, g in enumerate(f["ranks"]):
        say(f"[3o] (a) tp=2 rank {r}: prefill ms {g['prefill_ms']}; decode "
            f"ms per step {g['decode_ms']} (median "
            f"{statistics.median(g['decode_ms']):.3f}); wall "
            f"{g['wall_ms']:.1f} ms; peak {g['peak_gib']:.2f} GiB; tokens "
            f"{g['tokens']} ({smi})")
    same = [g["tokens"] == f["ranks"][0]["tokens"] for g in f["ranks"]]
    agree = sum(a == b for rid in one["tokens"] for a, b in
                zip(one["tokens"][rid], f["ranks"][0]["tokens"][rid]))
    total = sum(len(v) for v in one["tokens"].values())
    say(f"[3o] (a) both ranks' tokens equal: {all(same)}; {agree} of {total}"
        f" tokens equal to the one-rank engine's (bf16 on random weights "
        f"flips near-ties: printed, not asserted)")
    assert all(same) and len(f["ranks"]) == 2
    assert all(len(v) == DECODER_STEPS for v in f["ranks"][0]["tokens"]
               .values())
    for r in res["identities"]:
        say_identity("[3o] (b) tp=2:", r, smi)
    ta = time.perf_counter() - t0 - td
    res = spawn_ranks(4)
    counts["(c)"] = res["counts"]
    for r in res["seq"]:
        say_identity("[3o] (c) tp=4 (the sequence split):", r, smi)
        same = all(t == r["tokens_one"] for t in r["tokens_ranks"])
        say(f"[3o] (c) {r['arch']} engine: ring caches per rank "
            f"{r['cache']}; every rank's greedy tokens equal the one-rank "
            f"engine's: {same} ({r['tokens_one']})")
        assert same
    say(f"[3o] (d) {td:.1f} s, (a)+(b) {ta:.1f} s, (c) "
        f"{time.perf_counter() - t0 - td - ta:.1f} s ({smi})")
    return counts


def say_rank_counts(tag: str, ranks):
    """Print each rank process's launches and dispatches (``ranks``: part
    -> each rank's counts, set to 0 just before the part's path and read
    just after) and fail unless every one is empty."""
    for part, every in ranks.items():
        say(f"{tag} {part}, read in each of its {len(every)} rank "
            f"processes: kernel launches "
            f"{[c['launches'] for c in every]}, dispatches "
            f"{[c['dispatches'] for c in every]}")
        assert every and all(c["launches"] == {} and c["dispatches"] == {}
                             for c in every), (part, every)


def run_path(torch, fn, *args):
    """Drive one path with every count set to 0 just before it; returns
    (its result, kernel launches, dispatches, peak GiB)."""
    from repro_torch.kernels import _build, ops
    torch.cuda.synchronize()
    ops.KERNEL_COUNTS.clear()
    _build.LAUNCHES.clear()
    torch.cuda.reset_peak_memory_stats()
    out = fn(*args)
    torch.cuda.synchronize()
    return (out, dict(_build.LAUNCHES), dict(ops.KERNEL_COUNTS),
            torch.cuda.max_memory_allocated() / 2 ** 30)


# the path each kernel's ``launches`` is read from
PATH_OF = {"tile_delta": "rate", "tile_delta_halo": "rate",
           "roi_attention": "serve",
           **{k: "layers" for k in ("roi_conv_packed", "roi_conv_fleet",
                                    "roi_conv", "sbnet_gather",
                                    "sbnet_scatter")}}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: the repro_torch package is missing under {SRC}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import _build

    # plain versions on the card never round to TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    say(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {name}; nvidia-smi: {' | '.join(smi)}")
    t0 = time.perf_counter()
    _build.library()
    say(f"[build] kernels built and loaded in "
        f"{time.perf_counter() - t0:.1f} s")
    report = _build.ptxas_report()
    names = demangle([r[0] for r in report])
    for (_, regs, smem, st, ld), kname in zip(report, names):
        say(f"[build] ptxas {kname}: {regs} registers, {smem} bytes static "
            f"shared memory, spill stores {st} B, spill loads {ld} B")

    dev = torch.device("cuda")
    rng, gen, grids, frames = build_fleet(torch, dev)
    det = build_detector(dev)
    n_tiles = sum(int(g.sum()) for g in flat(grids))
    say(f"[fleet] {GROUPS} groups x {CAMS} cameras, {n_tiles} active tiles "
        f"of {TILE}x{TILE}")

    nxt = with_patches(torch, frames, grids, np.random.default_rng(SEED + 2),
                       gen, 20.0)
    results = check_kernels(torch, det, frames, nxt, grids)
    del nxt
    torch.cuda.empty_cache()
    keep = check_attention(torch, dev, grids, results)
    torch.cuda.empty_cache()

    from repro_torch.serving.detector import PackedActivationCache
    caches = {"canvas": PackedActivationCache(),
              "packed": PackedActivationCache(ref_mode="packed")}
    launches = {}
    (frames, kinds), launches["fleet"], disp, peak = run_path(
        torch, drive, torch, det, rng, gen, frames, grids, caches)
    say(f"[main] fleet path, canvas and packed caches in lockstep: steps "
        f"{kinds}; dispatches {disp}; launches {launches['fleet']}; peak "
        f"memory {peak:.2f} GiB; ref_win "
        f"{caches['packed'].ref_win.numel() * 4 / 2 ** 30:.3f} GiB against "
        f"the reference canvas "
        f"{caches['canvas'].ref_canvas.numel() * 4 / 2 ** 30:.3f} GiB")
    torch.cuda.empty_cache()
    _, launches["rate"], disp, peak = run_path(
        torch, rate_control_loop, torch, det, rng, gen, frames, grids,
        caches)
    say(f"[main] rate-control loop: dispatches {disp}; launches "
        f"{launches['rate']}; peak memory {peak:.2f} GiB")
    del caches
    torch.cuda.empty_cache()
    _, launches["layers"], disp, peak = run_path(
        torch, layer_paths, torch, det, frames, grids)
    say(f"[main] per-layer and single-camera paths: dispatches {disp}; "
        f"launches {launches['layers']}; peak memory {peak:.2f} GiB")
    fleet, off = crossroi_offline()
    _, launches["crossroi"], disp, peak = run_path(
        torch, crossroi_path, torch, det, dev, fleet, off)
    say(f"[main] CrossRoI's offline masks on the card (fleet steps, the "
        f"deadline former, obs off/on): dispatches {disp}; launches "
        f"{launches['crossroi']}; peak memory {peak:.2f} GiB")
    for kname in ("tile_delta_gate_canvas", "tile_delta_gate",
                  "roi_conv_entry", "roi_conv_stack", "sbnet_scatter_fleet"):
        assert launches["crossroi"].get(kname, 0) > 0, kname
    crossroi_online(fleet, off)
    torch.cuda.empty_cache()
    (h_grids, h_frames), launches["harness"], disp, peak = run_path(
        torch, harness_path, torch, det, dev, fleet, off)
    say(f"[main] phase 3g, the harnesses on the offline masks: dispatches "
        f"{disp}; launches {launches['harness']}; peak memory {peak:.2f} "
        f"GiB")
    for kname in SHARDED_KERNELS:
        assert launches["harness"].get(kname, 0) > 0, kname
    torch.cuda.empty_cache()
    _, launches["sharded"], disp, peak = run_path(
        torch, sharded_path, torch, det, dev, fleet, off, h_grids, h_frames)
    say(f"[main] phase 3h, the sharded runtime on the offline masks: "
        f"dispatches {disp}; launches {launches['sharded']}; peak memory "
        f"{peak:.2f} GiB")
    for kname in SHARDED_KERNELS:
        assert launches["sharded"].get(kname, 0) > 0, kname
    del fleet, off, h_grids, h_frames
    torch.cuda.empty_cache()
    del det, frames, grids, rng, gen
    torch.cuda.empty_cache()
    from repro_torch.configs import get_config
    launches["serve"] = serve_phase(torch, dev, keep, get_config(ARCH))
    gc.collect()
    torch.cuda.empty_cache()
    say(f"[3i] after phase 3f: {torch.cuda.memory_allocated() / 2 ** 30:.2f}"
        f" GiB allocated")
    _, launches["decoders"], disp, _ = run_path(torch, decoder_phase, torch,
                                                dev)
    say(f"[main] phase 3i, the windowed, local/global and MoE decoders: "
        f"kernel launches {launches['decoders']}, dispatches {disp} (none of "
        f"the twelve kernels lies on this path)")
    assert launches["decoders"] == {} and disp == {}
    t0 = time.perf_counter()
    _, launches["recurrent"], disp, _ = run_path(torch, recurrent_phase,
                                                 torch, dev)
    say(f"[main] phase 3j, the recurrent-state families (rwkv6, the "
        f"Mamba2 hybrid): kernel launches {launches['recurrent']}, "
        f"dispatches {disp} (none of the twelve kernels lies on this path); "
        f"{time.perf_counter() - t0:.1f} s")
    assert launches["recurrent"] == {} and disp == {}
    t0 = time.perf_counter()
    _, launches["encdec"], disp, peak = run_path(torch, encdec_phase, torch,
                                                 dev)
    say(f"[main] phase 3k, whisper-small's encoder-decoder: kernel launches "
        f"{launches['encdec']}, dispatches {disp} (none of the twelve "
        f"kernels lies on this path); peak memory {peak:.2f} GiB; "
        f"{time.perf_counter() - t0:.1f} s")
    assert launches["encdec"] == {} and disp == {}
    t0 = time.perf_counter()
    _, launches["train"], disp, peak = run_path(torch, train_phase, torch,
                                                dev)
    say(f"[main] phase 3l, the one-device training step: kernel launches "
        f"{launches['train']}, dispatches {disp} (none of the twelve "
        f"kernels lies on this path); peak memory {peak:.2f} GiB; "
        f"{time.perf_counter() - t0:.1f} s")
    assert launches["train"] == {} and disp == {}
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    _, launches["train_loop"], disp, peak = run_path(torch, loop_phase,
                                                     torch, dev)
    say(f"[main] phase 3m, the training loop: kernel launches "
        f"{launches['train_loop']}, dispatches {disp} (none of the twelve "
        f"kernels lies on this path); peak memory {peak:.2f} GiB; "
        f"{time.perf_counter() - t0:.1f} s")
    assert launches["train_loop"] == {} and disp == {}
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks, launches["train_tp"], disp, peak = run_path(torch, tp_phase,
                                                       torch, dev)
    say(f"[main] phase 3n, the model axis in training: kernel launches "
        f"{launches['train_tp']}, dispatches {disp} (none of the twelve "
        f"kernels lies on this path); peak memory {peak:.2f} GiB; "
        f"{time.perf_counter() - t0:.1f} s")
    assert launches["train_tp"] == {} and disp == {}
    say_rank_counts("[main] phase 3n", ranks)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks, launches["serve_tp"], disp, peak = run_path(
        torch, serve_tp_phase, torch, dev)
    say(f"[main] phase 3o, the model axis in serving: kernel launches "
        f"{launches['serve_tp']}, dispatches {disp} (none of the twelve "
        f"kernels lies on this path); peak memory {peak:.2f} GiB; "
        f"{time.perf_counter() - t0:.1f} s")
    assert launches["serve_tp"] == {} and disp == {}
    say_rank_counts("[main] phase 3o", ranks)

    rows = []
    for kname, (source, replaces) in KERNELS.items():
        path = PATH_OF.get(kname, "fleet")
        n_launch = launches[path].get(kname, 0)
        rows.append(dict(name=kname, route="cuda", source=source,
                         replaces=replaces, launches=n_launch, path=path,
                         launches_sharded=launches["sharded"].get(kname, 0),
                         **results[kname]))
        assert n_launch > 0, f"{kname} never launched on the {path} path"
    say(json.dumps({"kernels": rows}))
    for line in smi:
        say(line)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--tp-rank":
        sys.exit(tp_rank_main(int(sys.argv[2]), sys.argv[3]))
    if len(sys.argv) == 5 and sys.argv[1] == "--serve-rank":
        sys.exit(serve_rank_main(int(sys.argv[2]), int(sys.argv[3]),
                                 sys.argv[4]))
    sys.exit(main())
