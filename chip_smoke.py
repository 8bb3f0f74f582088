#!/usr/bin/env python3
"""On-card smoke test of sav_tpu_torch, the PyTorch/CUDA port of sav_tpu.

Run from the root of the repository on a machine with one NVIDIA Hopper GPU:

    python3 chip_smoke.py

``python3 chip_smoke.py --remat-trade`` runs only the device, build and
remat-trade phases, on ViT-B/16@384's seed-0 weights, and prints the
trade's peak memories as one JSON line.

Phases, each of which exits non-zero on failure:

1. device: refuse to run without CUDA; print the card's name and power limit
   (nvidia-smi); turn TF32 off for every f32 comparison.
2. build: compile every kernel in sav_tpu_torch/csrc with nvcc, one process
   per source, all at once; check each kernel's shared-memory rules (the
   relative-position kernels' at BoTNet's grids and the band's edges, in
   both dtypes), the variant rules of the fused forward (#1), the fused
   backward (#2), the flash forward (#3), the flash dq (#4) and dk/dv (#5)
   and the relative-position forward (#6), dq (#7) and dk/dv (#8) and the
   talking-heads kernels' head counts, variant rules (#9, #10), heads per
   warp and tensor-core shared memory against the Python eligibility rules;
   print the registers, spills and tensor-core instruction count
   (HMMA/HGMMA in the built library's SASS) of every tensor-core (bf16)
   instantiation of #1-#10 (#10's two kernels, dq and dk/dv), and fail
   where one has none.
3. kernels: each kernel against its plain PyTorch version on the card. The
   fused forward at the DeiT serve and train shapes, CaiT's class-attention
   shapes, ViT-B/16@384's serve shape (kv 577), head dims 40, 128 and 256,
   one query over 577 keys, biased (bf16 and f32, (B, H) to (1, 1)),
   ragged and strided shapes, each bf16 case run twice (the same bits) and
   held to FUSED_BF16_TOL; the fused backward at
   the DeiT train shape (bf16), the serve shape (f32), CaiT's class
   attention, ragged, one-query and short-kv shapes in bf16 and f32, head
   dim 128 (one and two rounds of kv rows), two rounds at head dim 64, head
   dim 256 in bf16 (the CUDA-core variant) and strided shapes; the
   talking-heads forward and backward (dq, dk, dv, dW_pre, dW_post) at the
   CaiT-XXS train and serve shapes, in f32, ragged, on strided views and at
   every other head count they are built for (2, 3, 6, 8; 16 forward only,
   on the CUDA cores), each bf16 case held to TH_BF16_TOL beside a float64
   twin that rounds p' and dS where the plain versions do, every launch
   counted under the variant its dtype and head count take;
   the flash forward, dq and dk/dv kernels at the ViT-B/16@384 train shape
   (bf16, with the lse) and in f32, ragged, multi-tile at head dim 40, at
   head dim 128, at CaiT's class attention at 384², short-kv (Lq > Lk)
   in both dtypes, biased (forward, f32 and bf16) and on strided views,
   each bf16 backward also beside a float64 twin that rounds p and ds where
   the plain version does, and each backward launch counted under the
   variant its dtype takes; the relative-position
   forward, dq (with d_rw and d_rh) and dk/dv kernels at BoTNet-T3's
   stage-4 train shapes (L=196 and L=49, 4 heads of 128) in bf16 and f32,
   on grids of 7×9, 5×6, 2×130 and 78×78 (the f32 band's edge at head dim
   128) and on strided views, each bf16 case also beside a float64 twin and
   each backward launch counted under the variant its dtype takes; the
   shapes CvT-13 and CeiT-S give (q_len != kv_len): the flash kernels at
   stage 1's (B, 3136 queries, 784 keys, 1, 64) in bf16 and f32 and its
   serve forward, the fused forward and backward at stages 2 and 3 (784
   over 196, 3 heads; 197 over 50, 6 heads) and at CeiT-S's class
   attention (1 over 12, 6 heads), train and serve, bf16 and f32; and
   TNT's inner attention (16 pixel tokens a patch, one slice per patch:
   B·196, 4 heads of 6 for TNT-S at the train batch and the top serve
   bucket, of 10 for TNT-B at the train batch), the head dim zero-padded
   to 8 and 16 by the wrappers and held against the plain version at the
   true head dim, bf16 and f32. Each backward, and each tensor-core
   forward, runs twice on the same inputs and must give the same bits.
4. timing: each kernel, its plain version and, where one exists, one PyTorch
   library call (yardstick only) at the shapes the main paths give it,
   beside the card's bound; the talking-heads kernels also beside the port's
   dense talking-heads path; the flash forward also at DeiT's train and
   serve shapes, beside #1; the backward crossover: #2 beside #4 + #5 (and
   the whole flash backward, delta included) at the ViT-B/16@384 and DeiT
   train shapes; the relative-position kernels beside SDPA with the
   expanded relative bias as its attn_mask; CvT-13's and CeiT-S's shapes,
   and at each CvT-13 shape the forward auto does not take beside the one
   it does (#1 at stage 1, #3 at stages 2 and 3); TNT's inner shapes, the
   wrapper's whole call (pad, kernel, slice) beside the plain version and
   SDPA at the true head dim, the bound by the true head dim's work.
5. serve: ServeEngine serves deit_s_patch16, then cait_xxs_24 (bf16, random
   weights from a seed) to concurrent clients through one captured CUDA
   graph per bucket (1…32) and the double-buffered feed. The launch
   counters cannot see a replay, so: every bucket's capture must have
   recorded one forward's launches, counted from the model's attention
   modules (DeiT 12 fused; CaiT 24 talking-heads and 2 fused; no backward
   launch), the startup nothing but two warm-up forwards and one capture
   per bucket (every launch of #1-#10 on the tensor cores), serving no
   counter at all, and replays x captured must equal the batches served
   x one forward's; one replay of bucket 32 under torch.profiler must run
   exactly those kernels, by name. At every bucket the replayed logits
   equal the engine's eager infer function on the same batch, bit for
   bit; 8 rows must agree with the same weights served (also captured) on
   the dense attention paths; and at buckets 1, 8 and 32 the eager step,
   the replayed step and a replay's device time are timed. Then the serve
   bench (``python -m sav_tpu_torch.serve.bench``, through its ``run``) for
   each model: a flood of 2,048 requests, an open loop at half the flood's
   throughput, and for DeiT-S a batch-1 arm of 512 that the batched flood
   must beat in images/s; each run checked as above.
6. train: Trainer trains deit_s_patch16, then cait_xxs_24 (bf16 over f32
   parameters, global batch 256, CaiT at its recipe's stochastic depth 0.05)
   for 6 steps on synthetic learnable batches through fit(), which on the
   card replays one CUDA graph of the whole step (train/graphs.py): the
   counters must move by the two eager warm-ups and the capture alone, the
   capture must hold each forward and backward kernel once per attention
   module that takes it (#1-#10 on the tensor cores; #10 is two kernels,
   dq and dk/dv), and replays x captured must be 6 steps' launches; every
   loss must be finite, the loss must fall, and the first step's loss and
   grad norm must agree with the same step on the dense attention paths
   (f32 softmax, the same stochastic-depth masks). From the same start,
   fit runs again with the eager step (the same losses, bit for bit), and
   3 captured steps must equal 3 eager ``_train_step_impl`` steps bit for
   bit: metrics, every parameter, buffer, Adam moment, count and generator
   state. One step of each fit under torch.profiler gives the device's busy
   time by kernel group, its idle share and the attention kernels by name.
7. the run path on DeiT-S (bf16, batch 256, #1/#2): resume (uint8 batches
   mixed with cutmix_mixup and normalised inside the captured step; fit 6
   steps; fit 3 steps into a checkpoint directory; a fresh Trainer's
   restore_or_init and fit on to step 6 from the resumable feed: steps 4-6
   bit-equal to the uninterrupted run, losses, parameters, moments and
   generator state, the "mix" generator's included; one capture and 3
   replays; the save's hold on the training thread, its background write,
   the bytes and the restore time), eval (Trainer.evaluate over 1,000
   held-out images, the last batch of 232 padded, through one captured
   eval step, kernels against the dense path; fit with eval_every_epochs=1
   appends eval records at steps 3 and 6), dropout (dropout_rate 0.1 keeps
   #1/#2's launches in the captured step; attn_dropout_rate 0.1 trains on
   the dense path, launching no attention kernel, and evaluates through
   #1), device preprocessing (uint8 HWCN host batches through the feeder,
   cutmix_mixup_randaugment_405 and an EMA: 6 captured steps with a
   falling loss, 3 captured steps equal to 3 eager ones bit for bit, half
   the bytes of a bf16 batch) and the train bench (``python -m
   sav_tpu_torch.train.bench`` through its ``main`` for DeiT-S at 256,
   with bf16 batches and with ``--device-preprocess``: one JSON line each,
   with the MFU against the card's table peak). The resumed run's
   checkpoint is then served through ServeConfig.checkpoint_dir
   (params-only restore): its logits equal, bit for bit, an engine given
   the restored model, and six raw images of mixed sizes through
   submit_raw equal preprocess_request + submit.
8. fine-tune: vit_b_patch16 built at 224² is saved with the port's
   Checkpointer, its position table resized by the port's surgery (197 ->
   577 rows, every other tensor unchanged); Trainer.warm_start_from that
   checkpoint into the 384² remat model gives every tensor bit-equal to
   the surgery's, none kept fresh; it trains as in 6 for 6 steps at the
   recipe's global batch 512 in 4 micro-batches of 128: 4 x (24 flash
   forward launches (12 blocks, each recomputed once), 12 dq and 12 dk/dv)
   per captured step, no fused launch; the dense reference runs with remat
   and the same accumulation. Then one eager step of 128 with remat and one
   without give the same loss, and their peak memories, eager and captured.
9. BoTNet: botnet_t3 (full width and depth, 224²) is served and benched in
   5, after CaiT (6 relative-position forward launches per batch, no other
   kernel),
   and trained as in 6 from get_preset("botnet_t3_imagenet") at its global
   batch 2048 in 8 micro-batches of 256 (8 x (6 forward, 6 dq and 6 dk/dv)
   launches per captured step); its first step's running statistics are
   compared with the dense path's under the same accumulation too.
10. CvT and CeiT: cvt-13 and ceit_s (full width and depth, 224²) are served
   and benched in 5, after BoTNet (CvT-13: 1 flash forward for stage 1's
   3,136 queries over 784 keys and 12 fused forwards for stages 2 and 3;
   CeiT-S: 13 fused forwards, the last the class attention of one query
   over the 12 collected CLS tokens), and trained as in 6 from
   get_preset("cvt_13_imagenet") at its global batch 2048 in 8
   micro-batches of 256 (8 x (1 #3, 1 #4, 1 #5, 12 #1, 12 #2) launches per
   captured step) and from get_preset("ceit_s_imagenet") at 1024 in 4
   (4 x (13 #1, 13 #2)); their first step's running statistics (the
   depthwise convs' and LeFF's BatchNorms) are compared with the dense
   path's too. Their kernel shapes (q_len != kv_len) are checked in 3 and
   timed in 4.
11. TNT and MLP-Mixer: tnt_s_patch16 and mixer_b_patch16 (full width and
   depth, 224²) are served and benched in 5, after CeiT (TNT-S: 24 fused
   forwards, 12 at the inner shape and 12 at DeiT-S's; Mixer-B/16: no
   attention, so every counter and every capture must read 0), and trained
   as in 6 from get_preset("tnt_s_imagenet") at 1024 in 4 micro-batches (4
   x (24 #1, 24 #2) launches per captured step) and from
   get_preset("mixer_b_imagenet") at 4096 in 16 (none). Mixer has no
   attention path to hold the kernels against, so its first train step is
   held against the same step in f32 from the same weights, and its served
   logits against the same weights served in f32.
12. rotary and MoE: vit_s_patch16_rope (RoPE on q and k in every block) and
   vit_moe_s_patch16_e8 (8 experts, top 2, in blocks 1, 3, ..., 11; 62
   slots an expert and row) are served in 5, after Mixer (12 fused forwards
   a batch each), the MoE model also benched, and trained as in 6 at the
   DeiT-S recipe's 256 (12 #1, 12 #2 a step each; the MoE's balance and
   router z-losses in the loss and the aux_loss metric). Where the kernel
   path and the dense path route a token differently (a near tie the bf16
   difference tips), the count of differing (token, choice) assignments is
   printed beside each agreement. Before them, the routing on the card at
   the train cell's shape (256 rows of 197 tokens, 8 experts, 62 slots):
   a zero router's tie picks experts 0 and 1 in token order; the assignment
   of the card's router probabilities equals the CPU's on the same
   probabilities, every kept and dropped choice; an MoE block's backward
   twice gives the same bits.
13. the supervised chain (after the train bench in 7): DeiT-S (bf16, 256,
   full depth) trained by ``python -m sav_tpu_torch.train --supervise`` as
   a subprocess through a SIGKILL (a killer thread that reads the
   heartbeats), a NaN batch (debug_nans, the recorder's incident, a
   rewind-and-skip) and a hang (the watchdog's exit 4): the chain verifies
   (reasons in order, one skip, accounted_frac >= 0.99), its final state
   equals an in-process fit over the skip-applied stream bit for bit, each
   attempt's first batch is the reference's at its resume position and
   each attempt captured 12 #1 and 12 #2 on the tensor cores; its launches
   are each attempt's replay counter (as its manifest last noted it, with
   the step it was read at) × captured; then a child with no card visible
   exits 3. ``python3 chip_smoke.py
   --supervised-chain`` runs only the fused kernels' build and this phase.

Before each agreement check the head is drawn at std 0.02, every
LayerScale scale at 0.05-0.15 (CaiT's init of 1e-5 would hide a wrong trunk),
and for BoTNet every bn3 scale at 0.05-0.15 (its init of 0 would hide the
whole trunk, the attention included) and, for BoTNet, CvT and CeiT, every
BatchNorm's running mean and variance taken from a train-mode forward of
drawn images (away from their
0/1 init, and the statistics the eval forward needs to keep logits O(1)).
The line before the last is the ``{"kernels": [...]}`` record; the last line
is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
# Before CUDA starts: lets phase_resume turn on
# torch.use_deterministic_algorithms should an op break bit equality (32
# MiB of cuBLAS workspace in 8 buffers, what PyTorch takes on Hopper anyway).
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

from sav_tpu_torch.ops import launch_counts, reset_launches, variant_counts  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, and FLOP/s by the
# inputs' type (bf16 on the tensor cores, f32 outside them).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# The DeiT-S/16 serve shape at the top bucket: B=32, L=197, H=6, D=64; and
# its train shape at global batch 256.
SERVE_SHAPE = (32, 197, 197, 6, 64)
TRAIN_SHAPE = (256, 197, 197, 6, 64)
# CaiT-XXS/16 at 224²: the class attention (one query over [CLS; 196
# tokens], 4 heads of 48) and the talking-heads trunk (B, L, H, D).
CLASS_SERVE_SHAPE = (32, 1, 197, 4, 48)
CLASS_TRAIN_SHAPE = (256, 1, 197, 4, 48)
TH_SERVE_SHAPE = (32, 196, 4, 48)
TH_TRAIN_SHAPE = (256, 196, 4, 48)
# ViT-B/16 fine-tuned at 384²: L = 1 + 24² = 577, 12 heads of 64, at the
# batch the fine-tune phase trains with; and CaiT's class attention at 384²
# (one query over [CLS; 576 tokens]), which trains outside #2's band.
VIT384_MODEL = "vit_b_patch16"
VIT384_SHAPE = (128, 577, 577, 12, 64)
VIT384_BATCH = 128
# The recipes' global batch 512 (Dosovitskiy et al. 2021 App. B.1.1; Touvron
# et al. 2021 Table 7) in micro-batches of VIT384_BATCH.
VIT384_ACCUM = 4
CLASS384_SHAPE = (128, 1, 577, 4, 48)
# BoTNet-T3 at 224²: stage 4's first block attends over 14×14 (L=196), the
# other five over 7×7 (L=49), 4 heads of 128; (B, Hg, W, H, D) at the train
# batch and at the top serve bucket.
BOTNET_MODEL = "botnet_t3"
# The reference's one experiment config: global batch 2048, here in 8
# micro-batches of TRAIN_BATCH.
BOTNET_PRESET = "botnet_t3_imagenet"
BOTNET_ACCUM = 8
# The outputs each relative-position kernel's record reports the error of.
REL_ERR_KEYS = {"fwd": ("fwd", "lse"), "dq": ("dq", "d_rw", "d_rh"), "dkv": ("dk", "dv")}
REL_TRAIN_SHAPES = {"L=196": (256, 14, 14, 4, 128), "L=49": (256, 7, 7, 4, 128)}
REL_SERVE_SHAPES = {"L=196": (32, 14, 14, 4, 128), "L=49": (32, 7, 7, 4, 128)}
# CvT-13 at 224² (embed 64/192/384, 1/2/10 blocks, 1/3/6 heads of 64): each
# stage's attention at the train micro-batch and the top serve bucket, K/V
# strided 2× (B, Lq, Lkv, H, D). Stage 1 attends 56² queries over 28² keys,
# past the fused forward's band (kv 679 at head dim 64): the flash kernels;
# stages 2 and 3 the fused ones (kv 196 and 7² + CLS, within both bands).
CVT_MODEL = "cvt-13"
CVT_PRESET = "cvt_13_imagenet"
# The preset's global batch 2048 (sav_tpu/train/presets.py) in 8 micro-batches.
CVT_ACCUM = 8
CVT_TRAIN_SHAPES = {"stage 1": (256, 3136, 784, 1, 64), "stage 2": (256, 784, 196, 3, 64),
                    "stage 3": (256, 197, 50, 6, 64)}
CVT_SERVE_SHAPES = {k: (32, *v[1:]) for k, v in CVT_TRAIN_SHAPES.items()}
# The kernel family each CvT-13 attention core takes, by the first prefix
# of its module name that matches (attention_launches).
CVT_FAMILY = {"stages.0.": "flash", "": "fused"}
# CeiT-S at 224²: a DeiT-S-shaped trunk (197 tokens, 6 heads of 64:
# TRAIN_SHAPE) and the layer-wise class attention, one query over the 12
# collected CLS tokens; the preset's global batch 1024 in 4 micro-batches.
CEIT_MODEL = "ceit_s"
CEIT_PRESET = "ceit_s_imagenet"
CEIT_ACCUM = 4
LCA_TRAIN_SHAPE = (256, 1, 12, 6, 64)
LCA_SERVE_SHAPE = (32, 1, 12, 6, 64)
# TNT-S at 224²: the outer stream is DeiT-S's shape (TRAIN_SHAPE); the inner
# stream attends over each patch's 16 pixel tokens, 4 heads of 6 (TNT-B: of
# 10), one (batch, head) slice per patch: B·196 of them, the head dim
# zero-padded to 8 (16) in the wrappers. The preset's global batch 1024 in 4
# micro-batches.
TNT_MODEL = "tnt_s_patch16"
TNT_PRESET = "tnt_s_imagenet"
TNT_ACCUM = 4
TNT_TRAIN_SHAPE = (256 * 196, 16, 16, 4, 6)
TNT_SERVE_SHAPE = (32 * 196, 16, 16, 4, 6)
TNT_B_TRAIN_SHAPE = (256 * 196, 16, 16, 4, 10)
# Mixer-B/16 at 224²: no attention (every launch counter must read 0); the
# preset's global batch 4096 in 16 micro-batches.
MIXER_MODEL = "mixer_b_patch16"
MIXER_PRESET = "mixer_b_imagenet"
MIXER_ACCUM = 16
# DeiT-S's trunk with RoPE, and with 8 routed experts in every other block:
# #1/#2 at DeiT-S's shape (12 a forward, 12 a backward); trained at 256.
ROPE_MODEL = "vit_s_patch16_rope"
MOE_MODEL = "vit_moe_s_patch16_e8"
SERVE_REQUESTS = 96
CLIENTS = 4
TRAIN_BATCH = 256
TRAIN_STEPS = 6
TRAIN_DISTINCT_BATCHES = 3  # each seen twice, so the loss can fall on it
# atol = rtol: bf16 allows a few roundings of p, ds and the outputs; f32
# different summation orders.
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
# The flash kernels in bf16, absolute: twice the largest error each output
# showed over every bf16 case of phase_flash_kernels on the H100 (fwd
# 1.95e-3 at the ViT-B/16@384 train shape, dq 1.95e-3 at head dim 128 with
# the CUDA-core #4), so a cast point the kernel moved away from its plain
# version's shows as a failure, not a pass within TOL. dk and dv: twice the
# 3.9e-3 the tensor-core #5 showed (ViT-B/16@384 train dk, short-kv dv): its
# f32 sums run in another order than the plain version's, so an output in
# [0.5, 1) that sits at a bf16 rounding boundary rounds one ulp (3.9e-3)
# apart; the plain version itself lies up to 4.7e-3 from the float64 twin
# that rounds p and ds where it does (the kernel's distance from the twin
# equals the plain version's to four digits in every case).
FLASH_BF16_TOL = {"fwd": 4e-3, "dq": 4e-3, "dk": 8e-3, "dv": 8e-3}
# The fused forward in bf16, absolute: twice the largest error the CUDA-core
# #1 showed over its bf16 check cases on the H100 (6.06e-3 at the DeiT train
# shape; serve 3.12e-3, strided 2.53e-3, ragged 2.40e-3, CaiT's class
# attention 1.58e-3), each against the plain version computed in f32, so a
# cast point the tensor-core variant moved away from the reference's shows
# as a failure, not a pass within TOL. The same limit holds it against the
# plain version on the bf16 inputs, which rounds p and o where it does.
FUSED_BF16_TOL = {"fwd": 1.2e-2}
# The relative-position kernels in bf16: twice the largest error each output
# showed over every bf16 case of phase_rel_kernels on the H100 (fwd 7.8e-3
# and dv 1.56e-2 at the L=49 train shape: one bf16 ulp of outputs of 2-4;
# dq and dk 3.9e-3), absolute; d_rw and d_rh are sums of the f32 ds (6.6e-6,
# atol = rtol).
REL_BF16_TOL = {"fwd": 1.6e-2, "dq": 8e-3, "dk": 8e-3, "dv": 3.2e-2, "d_rw": 1.4e-5,
                "d_rh": 1.4e-5}
# The talking-heads kernels in bf16, absolute (dW_pre and dW_post as a
# share of their largest |plain| entry, as _within_largest holds them):
# twice the largest error each output of the CUDA-core #9/#10 showed over
# phase_th_kernels' bf16 cases on the H100 (the parent tree's run): dq, dk
# and dv 1.953e-3 (train and serve); dW_pre 2.599e-6 and dW_post 2.487e-6
# of their largest entry (train: 1.053e-3 of 405.167 and 9.155e-4 of
# 368.179, the parent's abs errors over the largest entries this script
# prints for the same plain version on the same inputs); the CUDA-core
# forward equalled its plain version to the bit. Two limits are
# reset for the tensor-core kernels, whose f32 sums (an online row sum, the
# SFU's exp2, mma accumulation) run in another order than the plain
# versions': the forward's to 4e-3, twice the 1.953e-3 it showed (one bf16
# ulp of outputs in [0.25, 0.5): a p' at a rounding boundary rounds the
# other way), and dk's to 8e-3, twice the 3.906e-3 it showed (one ulp in
# [0.5, 1), 8 heads and the train shape). Against a float64 twin that
# rounds p' and dS where the plain versions do, kernel and plain version
# lie equally far on the output, dq, dk and dv in every bf16 case, to four
# digits (up to 3.8e-3: half a bf16 ulp, the outputs' own rounding), and on
# dW_pre and dW_post the kernel lies as near or nearer (3.2e-5 against
# 3.8e-5 at the train shape); check_th_kernel prints both. The tensor-core
# dW kept within the parent's limits: 3.164e-6 and 2.762e-6 of the largest
# entry at the train shape.
TH_BF16_TOL = {"fwd": 4e-3, "dq": 3.9e-3, "dk": 8e-3, "dv": 3.9e-3, "dw_pre": 5.2e-6,
               "dw_post": 5e-6}
LSE_TOL = 2e-5
SERVE_TOL = 3e-2
# First train step, kernels vs dense attention with f32 softmax, both bf16
# over 12 (DeiT, ViT-B) or 26 (CaiT) layers: relative to the loss (~ln 1000)
# and to the grad norm.
TRAIN_REL_TOL = {"loss": 1e-2, "grad_norm": 5e-2}
# One step with remat and one without, same weights and batch: remat only
# changes what the backward recomputes, and the kernels are deterministic.
REMAT_REL_TOL = 1e-6
# The dropout rate of the remat trade's second pair of steps.
REMAT_DROPOUT = 0.1
# BoTNet's running statistics after the first step, kernels vs dense
# attention, relative to each tensor's largest entry: only the stage-4
# BatchNorms after an attention core see different (bf16-rounded) inputs,
# and the step moves each statistic by a tenth of its batch value.
BATCH_STATS_REL_TOL = 1e-2
# LayerScale scales drawn for the agreement checks; and for BoTNet, the
# zero-init bn3 scales and the BatchNorm running means and variances.
LAYERSCALE_DRAW = (0.05, 0.15)
BN3_SCALE_DRAW = (0.05, 0.15)
CALIBRATION_IMAGES = 8


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit(
            "chip_smoke: torch.cuda.is_available() is false; run it on a "
            "machine with an NVIDIA GPU"
        )
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"card: {smi} (torch {torch.__version__}, CUDA {torch.version.cuda})")
    return smi


def phase_build() -> None:
    from sav_tpu_torch.ops import _build
    from sav_tpu_torch.ops import flash_attention as flash
    from sav_tpu_torch.ops import fused_attention as fa
    from sav_tpu_torch.ops import talking_heads as th

    t0 = time.perf_counter()
    built = _build.build_all()
    log(
        f"build: {len(built)} kernel source(s) in {time.perf_counter() - t0:.1f} s "
        f"{json.dumps({k: round(v, 1) for k, v in built.items()})}"
    )
    for name, text in _build.BUILD_LOGS.items():
        for line in text.splitlines():
            log(f"  nvcc {name}: {line.strip()}")
    lib, bwd = fa._lib(), fa._bwd_lib()
    for kv_len, dim, itemsize in ((197, 64, 2), (197, 64, 4), (50, 32, 4), (1, 8, 2), (264, 64, 2),
                                  (577, 64, 2), (577, 64, 4), (197, 48, 2), (800, 64, 2),
                                  (416, 128, 2), (197, 40, 2), (40, 136, 2), (40, 256, 2)):
        rules = [
            ("forward", lib.sav_fused_attention_smem_bytes(kv_len, dim, itemsize),
             fa.fused_smem_bytes(kv_len, dim, itemsize)),
            ("forward variant", {1: fa.TENSOR_CORE, 0: fa.CUDA_CORE}[
                lib.sav_fused_attention_variant(1 if itemsize == 2 else 0, dim)],
             fa.fused_fwd_variant(dim, itemsize)),
            ("backward rows", bwd.sav_fused_attention_bwd_rows(kv_len, dim, itemsize),
             fa.fused_bwd_rows(kv_len, dim, itemsize)),
            *[(f"backward at {rows} rows",
               bwd.sav_fused_attention_bwd_smem_bytes(kv_len, dim, itemsize, rows),
               fa.fused_bwd_smem_bytes(kv_len, dim, itemsize, rows)) for rows in (1, 2, 4)],
        ]
        for what, c_value, py_value in rules:
            if c_value != py_value:
                raise AssertionError(
                    f"{what} shared-memory rule differs at kv={kv_len} d={dim} "
                    f"itemsize={itemsize}: kernel {c_value}, fused_eligible {py_value}"
                )
    # The backward's variant rule, and the tensor-core variant's shared memory
    # and rounds, at the main paths' shapes, the band's edges and past them.
    for kv_len, dim in ((197, 64), (197, 48), (197, 32), (49, 64), (1, 8), (130, 128),
                        (197, 128), (336, 128), (337, 128), (640, 64), (641, 64), (577, 48),
                        (264, 64), (100, 136), (100, 256)):
        for dtype, itemsize in ((0, 4), (1, 2)):
            c_variant = {1: fa.TENSOR_CORE, 0: fa.CUDA_CORE}[
                bwd.sav_fused_attention_bwd_variant(dtype, dim)]
            if c_variant != fa.fused_bwd_variant(dim, itemsize):
                raise AssertionError(f"backward variant rule differs at d={dim} itemsize "
                                     f"{itemsize}: kernel {c_variant}, fused_bwd_variant "
                                     f"{fa.fused_bwd_variant(dim, itemsize)}")
        for what, c_value, py_value in (
            ("tensor-core backward", bwd.sav_fused_attention_bwd_mma_smem_bytes(kv_len, kv_len, dim),
             fa.fused_bwd_mma_smem_bytes(kv_len, kv_len, dim)),
            ("tensor-core backward, one query",
             bwd.sav_fused_attention_bwd_mma_smem_bytes(1, kv_len, dim),
             fa.fused_bwd_mma_smem_bytes(1, kv_len, dim)),
            ("tensor-core backward rounds", bwd.sav_fused_attention_bwd_mma_rounds(kv_len, dim),
             fa.fused_bwd_mma_rounds(kv_len, dim)),
        ):
            if c_value != py_value:
                raise AssertionError(f"{what} rule differs at kv={kv_len} d={dim}: kernel "
                                     f"{c_value}, Python {py_value}")
    th_lib, th_bwd = th._lib(), th._bwd_lib()
    for kv_len, heads, dim, itemsize in ((196, 4, 48, 2), (196, 4, 48, 4), (196, 6, 48, 2),
                                         (196, 8, 48, 2), (196, 8, 48, 4), (196, 16, 48, 2),
                                         (50, 3, 32, 4), (577, 4, 64, 2), (2000, 4, 48, 2)):
        rules = [
            ("talking-heads rows", th_lib.sav_talking_heads_rows(kv_len, heads, dim, itemsize),
             th.th_rows(kv_len, heads, dim, itemsize)),
            ("talking-heads backward rows",
             th_bwd.sav_talking_heads_bwd_rows(kv_len, heads, dim, itemsize),
             th.th_bwd_rows(kv_len, heads, dim, itemsize)),
            *[(f"talking-heads at {rows} rows",
               th_lib.sav_talking_heads_smem_bytes(kv_len, heads, dim, itemsize, rows),
               th.th_smem_bytes(kv_len, heads, dim, itemsize, rows)) for rows in (1, 2)],
            *[(f"talking-heads backward at {rows} rows",
               th_bwd.sav_talking_heads_bwd_smem_bytes(kv_len, heads, dim, itemsize, rows),
               th.th_bwd_smem_bytes(kv_len, heads, dim, itemsize, rows)) for rows in (1, 2)],
        ]
        for what, c_value, py_value in rules:
            if c_value != py_value:
                raise AssertionError(
                    f"{what} shared-memory rule differs at kv={kv_len} h={heads} d={dim} "
                    f"itemsize={itemsize}: kernel {c_value}, Python {py_value}"
                )
    for heads in range(1, 33):
        for what, c_value, py_value in (
            ("forward", th_lib.sav_talking_heads_has_heads(heads), heads in th.HEADS),
            ("backward", th_bwd.sav_talking_heads_bwd_has_heads(heads), heads in th.BWD_HEADS),
        ):
            if bool(c_value) != py_value:
                raise AssertionError(f"talking-heads {what}: the kernel is built for {heads} "
                                     f"heads: {bool(c_value)}; the Python rule says {py_value}")
    # #9/#10's variant rule (one for both directions), and the tensor-core
    # kernels' heads per warp and shared memory, over every head count and
    # head dim the band could take; the backward's rows per block beside
    # them (the Python mirror of the dk/dv kernel's and the bound's).
    for heads in range(1, 17):
        for dim in range(8, 136, 8):
            for dtype, itemsize in ((0, 4), (1, 2)):
                c_variant = {1: th.TENSOR_CORE, 0: th.CUDA_CORE}[
                    th_lib.sav_talking_heads_variant(dtype, heads, dim)]
                if c_variant != th.th_variant(heads, dim, itemsize):
                    raise AssertionError(
                        f"talking-heads variant rule differs at h={heads} d={dim} itemsize "
                        f"{itemsize}: kernel {c_variant}, Python {th.th_variant(heads, dim, itemsize)}")
            if th.th_variant(heads, dim, 2) != th.TENSOR_CORE:
                continue
            dk = -(-dim // 16) * 16
            for kind, c_ho, c_smem, c_rows in (
                ("fwd", th_lib.sav_talking_heads_mma_heads_per_warp(heads, dk),
                 th_lib.sav_talking_heads_mma_smem_bytes(heads, dk), None),
                *[(kind, th_bwd.sav_talking_heads_bwd_mma_heads_per_warp(code, heads, dk),
                   th_bwd.sav_talking_heads_bwd_mma_smem_bytes(code, heads, dk),
                   th_bwd.sav_talking_heads_bwd_mma_rows(code, heads, dk))
                  for code, kind in ((1, "bwd_dq"), (2, "bwd_dkv"))],
            ):
                c = (c_ho, c_smem, c_rows)
                py = (th.th_mma_heads_per_warp(kind, heads, dim), th.th_mma_smem_bytes(kind, heads, dim),
                      None if c_rows is None else th.th_mma_block(kind, heads, dim)["rows"])
                if c != py or c_smem > fa.SMEM_LIMIT:
                    raise AssertionError(
                        f"talking-heads tensor-core {kind} rule differs at h={heads} d={dim}: "
                        f"kernel (heads per warp, bytes, rows) {c}, Python {py}, "
                        f"limit {fa.SMEM_LIMIT}")
    # CaiT-XXS/XS/S at 224² in bf16 take the tensor cores; CaiT-XXS's blocks
    # fit two to an SM in each kernel.
    for heads in (4, 6, 8):
        if th.th_variant(heads, 48, 2) != th.TENSOR_CORE:
            raise AssertionError(f"{heads} heads of 48 in bf16 are outside the talking-heads "
                                 "tensor-core band")
    for kind in th.MMA_KINDS:
        if th.th_mma_blocks_per_sm(kind, 4, 48) < 2:
            raise AssertionError(f"CaiT-XXS's talking-heads {kind} blocks no longer fit two to an SM")
    fl, fl_bwd = flash._lib(), flash._bwd_lib()
    rel, rel_bwd = flash._rel_lib(), flash._rel_bwd_lib()
    for dim in range(8, 136, 8):
        for itemsize in (4, 2):
            want = flash.flash_smem_bytes(dim, itemsize)
            for what, c_value in (
                ("fwd", fl.sav_flash_attention_smem_bytes(dim, itemsize)),
                ("bwd_dq", fl_bwd.sav_flash_attention_bwd_dq_smem_bytes(dim, itemsize)),
                ("bwd_dkv", fl_bwd.sav_flash_attention_bwd_dkv_smem_bytes(dim, itemsize)),
            ):
                # flash_eligible takes every such dim, so each block must fit.
                if (c_value != want[what] or c_value > fa.SMEM_LIMIT
                        or not flash.flash_eligible(dim, itemsize)):
                    raise AssertionError(
                        f"flash {what} shared-memory rule differs at d={dim} itemsize "
                        f"{itemsize}: kernel {c_value}, flash_smem_bytes {want[what]}, "
                        f"limit {fa.SMEM_LIMIT}")
    for dtype, itemsize in ((0, 4), (1, 2)):
        for what, c_rule, py_rule in (
            ("flash forward", fl.sav_flash_attention_variant, flash.flash_fwd_variant),
            ("flash backward", fl_bwd.sav_flash_attention_bwd_variant, flash.flash_bwd_variant),
            ("relative-position forward", rel.sav_rel_attention_variant, flash.rel_fwd_variant),
            ("relative-position backward", rel_bwd.sav_rel_attention_bwd_variant,
             flash.rel_bwd_variant),
        ):
            c_variant = {1: flash.TENSOR_CORE, 0: flash.CUDA_CORE}[c_rule(dtype)]
            if c_variant != py_rule(itemsize):
                raise AssertionError(f"{what} variant rule differs at itemsize {itemsize}: "
                                     f"kernel {c_variant}, Python {py_rule(itemsize)}")
    # Every main-path shape of #1 in bf16 takes the tensor-core variant; at
    # the shapes with q_len != kv_len (CvT-13's stages 2 and 3, CeiT-S's
    # class attention) #2's tensor-core shared memory holds every q row's
    # lse and delta beside the slice's K and V.
    # TNT's inner heads of 6 and 10 run zero-padded to 8 and 16.
    for q_len, kv_len, true_dim in ((197, 197, 64), (1, 197, 48), (577, 577, 64), (1, 577, 48),
                                    (784, 196, 64), (197, 50, 64), (1, 12, 64), (16, 16, 6),
                                    (16, 16, 10)):
        dim = fa.padded_dim(true_dim)
        if not (fa.fused_eligible(q_len, kv_len, true_dim, itemsize=2)
                and fa.fused_fwd_variant(dim, 2) == fa.TENSOR_CORE):
            raise AssertionError(f"#1 at ({q_len}, {kv_len}, {true_dim}) bf16 is outside the "
                                 "tensor-core band")
        c_value = bwd.sav_fused_attention_bwd_mma_smem_bytes(q_len, kv_len, dim)
        if (c_value != fa.fused_bwd_mma_smem_bytes(q_len, kv_len, dim)
                or not fa.fused_eligible(q_len, kv_len, dim, itemsize=2, backward=True)):
            raise AssertionError(f"#2 at ({q_len}, {kv_len}, {dim}) bf16: kernel {c_value} "
                                 f"bytes, Python {fa.fused_bwd_mma_smem_bytes(q_len, kv_len, dim)}, "
                                 f"or outside the backward's band")
    from sav_tpu_torch.ops.attention import resolve_attention_backend

    for dim in (6, 10):
        for dtype in (torch.bfloat16, torch.float32):
            if resolve_attention_backend(16, 16, dim, dtype=dtype, backward=True) != "fused":
                raise AssertionError(f"auto does not take #1/#2 at TNT's inner (16, 16, {dim}) "
                                     f"in {dtype}")
    log_mma_builds()
    # BoTNet's grids, the JAX tests' grids and the f32 band's edges at head
    # dims 128 and 64 (W + Hg = 156 and 284); the bf16 band contains the f32
    # one.
    for dim, height, width in ((128, 14, 14), (128, 7, 7), (16, 7, 9), (8, 5, 6), (8, 2, 130),
                               (128, 78, 78), (128, 78, 79), (64, 142, 142), (64, 142, 143)):
        for itemsize in (4, 2):
            want = flash.rel_smem_bytes(dim, height, width, itemsize)
            fits = max(want.values()) <= fa.SMEM_LIMIT
            rel_sum = height + width
            for what, c_value in (
                ("fwd", rel.sav_rel_attention_smem_bytes(dim, height, width, itemsize)),
                ("bwd_dq", rel_bwd.sav_rel_attention_bwd_dq_smem_bytes(dim, rel_sum, itemsize)),
                ("bwd_dkv", rel_bwd.sav_rel_attention_bwd_dkv_smem_bytes(dim, rel_sum, itemsize)),
            ):
                if c_value != want[what] or flash.rel_eligible(dim, height, width, itemsize) != fits:
                    raise AssertionError(
                        f"relative-position {what} shared-memory rule differs at d={dim} grid "
                        f"{height}x{width} itemsize {itemsize}: kernel {c_value}, "
                        f"rel_smem_bytes {want[what]}, limit {fa.SMEM_LIMIT}")
        if flash.rel_eligible(dim, height, width) and not flash.rel_eligible(dim, height, width, 2):
            raise AssertionError(f"d={dim} grid {height}x{width} is in the f32 relative-position "
                                 "band and not in the bf16 one")
    if not all(flash.rel_eligible(128, s, s, itemsize) for s in (14, 7) for itemsize in (2, 4)):
        raise AssertionError("BoTNet-T3's stage-4 grids are outside the relative-position band")
    for name, heads in (("CaiT-XXS", 4), ("CaiT-XS", 6), ("CaiT-S", 8)):
        for itemsize in (2, 4):
            if not (th.fused_eligible(heads, 196, 48, itemsize=itemsize)
                    and th.fused_bwd_eligible(heads, 196, 196, 48, itemsize=itemsize)):
                raise AssertionError(f"{name} at 224² (itemsize {itemsize}) is outside the "
                                     "talking-heads band")


# The tensor-core (bf16) instantiations whose build is reported: kernel
# source -> fragments of their mangled names, each of which must be found.
MMA_KERNELS = {"fused_attention": ("fused_attention_fwd_mma_kernel",),
               "fused_attention_bwd": ("fused_attention_bwd_mma_kernel",),
               "flash_attention": ("flash_attention_fwd_mma_kernel",),
               "flash_attention_bwd": ("flash_attention_bwd_dq_mma_kernel",
                                       "flash_attention_bwd_dkv_mma_kernel"),
               "rel_attention": ("rel_attention_fwd_mma_kernel",),
               "rel_attention_bwd": ("rel_attention_bwd_dq_mma_kernel",
                                     "rel_attention_bwd_dkv_mma_kernel"),
               "talking_heads": ("talking_heads_fwd_mma_kernel",),
               "talking_heads_bwd": ("talking_heads_bwd_dq_mma_kernel",
                                     "talking_heads_bwd_dkv_mma_kernel")}


def _ptxas_resources(text: str) -> dict:
    """Registers, spill bytes and shared memory of each entry function in an
    ``nvcc -Xptxas -v`` log, by mangled name."""
    out, name = {}, None
    for line in text.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            out[name] = {}
        elif name is not None and "spill stores" in line:
            words = line.replace(",", "").split()
            out[name]["spill_stores"] = int(words[words.index("spill") - 2])
            out[name]["spill_loads"] = int(words[-4])
        elif name is not None and "Used" in line and "registers" in line:
            words = line.replace(",", "").split()
            out[name]["registers"] = int(words[words.index("registers") - 1])
            if "smem" in words:
                out[name]["static_smem"] = int(words[words.index("smem") - 2])
    return out


def _sass_mma_counts(library: str) -> dict:
    """Tensor-core instructions (HMMA: mma.sync; HGMMA: wgmma) per function
    in the SASS of a built library, by mangled name."""
    from sav_tpu_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", library], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = {"HMMA": 0, "HGMMA": 0}
        elif name is not None:
            for op in ("HGMMA", "HMMA"):
                if f" {op}." in line:
                    counts[name][op] += 1
                    break
    return counts


def log_mma_builds() -> None:
    """For each tensor-core instantiation: its registers, spills and shared
    memory from ptxas, and its tensor-core instruction count from the SASS of
    the built library; fails where one has no tensor-core instruction."""
    from sav_tpu_torch.ops import _build

    for source, fragments in MMA_KERNELS.items():
        resources = _ptxas_resources(_build.BUILD_LOGS.get(source, ""))
        sass = _sass_mma_counts(str(_build.library_path(source)))
        names = []
        for fragment in fragments:
            found = sorted(n for n in sass if fragment in n)
            if not found:
                raise AssertionError(f"no {fragment} in the SASS of {source}")
            names += found
        for name in names:
            ops = sass[name]
            log(f"  sass {source}: {name}: {ops['HMMA']} HMMA, {ops['HGMMA']} HGMMA; ptxas "
                + json.dumps(resources.get(name, "not in this process's build log")))
            if ops["HMMA"] + ops["HGMMA"] == 0:
                raise AssertionError(f"{name} in {source} has no tensor-core instruction")


def _inputs(shape, dtype, seed, device, *, bias_shape=None, packed=False):
    b, lq, lk, h, d = shape
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*s):
        return torch.randn(s, generator=gen, device=device)

    if packed:  # q/k/v as strided views of one [B, L, 3, H, D] tensor
        q, k, v = randn(b, lq, 3, h, d).to(dtype).unbind(2)
    else:
        q = randn(b, lq, h, d).to(dtype)
        k = randn(b, lk, h, d).to(dtype)
        v = randn(b, lk, h, d).to(dtype)
    bias = randn(*bias_shape) if bias_shape else None
    return q, k, v, bias


def _within(got, ref, tol, rtol=None) -> float:
    """Max abs error; fails where it passes ``tol + rtol·|ref|`` (rtol
    defaults to tol)."""
    err = (got.float() - ref.float()).abs()
    bad = err > tol + (tol if rtol is None else rtol) * ref.float().abs()
    if bool(bad.any()):
        raise AssertionError(f"{int(bad.sum())} elements off, max abs err {err.max().item():.3e}")
    return err.max().item()


def check_kernel(name, shape, dtype, device, *, bias_shape=None, with_lse=False, packed=False):
    """The kernel against its plain version computed in f32 from the same
    inputs (bf16 allows one bf16 rounding of P and one of O), and in bf16
    also against the plain version on the bf16 inputs (the same roundings),
    both within FUSED_BF16_TOL (absolute); a bf16 run is repeated on the same
    inputs and must give the same bits."""
    from sav_tpu_torch.ops import fused_attention as fa

    q, k, v, bias = _inputs(shape, dtype, 7, device, bias_shape=bias_shape, packed=packed)
    bf16 = dtype == torch.bfloat16
    tol, rtol = (FUSED_BF16_TOL["fwd"], 0.0) if bf16 else (TOL[dtype], None)
    with torch.inference_mode():
        got = fa.fused_attention(q, k, v, bias, with_lse=with_lse)
        again = fa.fused_attention(q, k, v, bias, with_lse=with_lse) if bf16 else got
        ref = fa.fused_attention_reference(
            q.float(), k.float(), v.float(), bias, with_lse=with_lse
        )
        same = fa.fused_attention_reference(q, k, v, bias, with_lse=with_lse) if bf16 else None
    if with_lse:
        (got, got_lse), (ref, ref_lse), (again, _) = got, ref, again
        same = same[0] if bf16 else None
    if not torch.equal(got, again):
        raise AssertionError(f"fused forward {name}: two runs on the same inputs differ")
    err = _within(got, ref, tol, rtol)
    variant = fa.fused_fwd_variant(shape[-1], q.element_size())
    note = f" ({variant}"
    if bf16:
        note += (f"; deterministic; against the plain version in bf16 "
                 f"{_within(got, same, tol, rtol):.3e}")
    note += f"; largest |plain| {ref.float().abs().max().item():.3f})"
    if with_lse:
        note += f", lse max abs err {_within(got_lse, ref_lse, LSE_TOL):.3e}"
    log(f"kernel {name} {shape} {str(dtype)[6:]}: max abs err {err:.3e} "
        f"(tol {tol}{' absolute' if bf16 else ''}){note}")
    return err


def phase_kernels(device="cuda", serve_shape=SERVE_SHAPE, train_shape=TRAIN_SHAPE) -> dict:
    """All forward cases; returns the max abs error at the serve and the
    train shape and at CaiT's class-attention shapes, in bf16."""
    bf16, f32 = torch.bfloat16, torch.float32
    b, lq, lk, h, d = serve_shape
    train_err = check_kernel("train+lse", train_shape, bf16, device, with_lse=True)
    serve_err = check_kernel("serve", serve_shape, bf16, device)
    serve_err = max(serve_err, check_kernel("serve+lse", serve_shape, bf16, device, with_lse=True))
    check_kernel("serve-f32+lse", serve_shape, f32, device, with_lse=True)
    check_kernel("packed-qkv", serve_shape, bf16, device, packed=True)
    for bias_shape in ((2, 4, 50, 50), (1, 1, 50, 50), (1, 4, 50, 50), (2, 1, 50, 50)):
        check_kernel(f"bias{bias_shape[:2]}", (2, 50, 50, 4, 32), f32, device, bias_shape=bias_shape)
    check_kernel("ragged-50+lse", (2, 50, 50, 2, 32), bf16, device, with_lse=True)
    check_kernel("ragged-50", (2, 50, 50, 2, 32), f32, device)
    check_kernel("one-query", (2, 1, lk, 2, d), f32, device)
    check_kernel("short-kv", (2, 196, 49, 2, 64), f32, device)
    class_err = check_kernel("cait-class-attention+lse", CLASS_TRAIN_SHAPE, bf16, device, with_lse=True)
    class_err = max(class_err, check_kernel("cait-class-attention", CLASS_SERVE_SHAPE, bf16, device))
    # The tensor-core variant beyond the main paths: ViT-B/16@384's serve
    # shape (kv 577, the band's main-path top), head dims 40 (padded to the
    # MMA depth) and 128 (16 rows a warp; kv at that band's top, 416), one
    # query over 577 keys, biases of every broadcast pattern, ragged and
    # short-kv shapes, with and without the lse; and bf16 above head dim 128
    # on the CUDA cores.
    check_kernel("vit-b/16@384 serve", (8, 577, 577, 12, 64), bf16, device)
    check_kernel("vit-b/16@384 serve+lse", (8, 577, 577, 12, 64), bf16, device, with_lse=True)
    check_kernel("d40+lse", (2, 100, 150, 2, 40), bf16, device, with_lse=True)
    check_kernel("d128", (2, 197, 197, 2, 128), bf16, device)
    check_kernel("d128-kv416+lse", (2, 130, 416, 2, 128), bf16, device, with_lse=True)
    check_kernel("one-query-577+lse", (8, 1, 577, 4, 48), bf16, device, with_lse=True)
    for bias_shape in ((2, 4, 130, 150), (1, 1, 130, 150), (1, 4, 130, 150), (2, 1, 130, 150)):
        check_kernel(f"bias{bias_shape[:2]}", (2, 130, 150, 4, 32), bf16, device,
                     bias_shape=bias_shape)
    check_kernel("bias(2, 4)+lse", (2, 130, 150, 4, 32), bf16, device,
                 bias_shape=(2, 4, 130, 150), with_lse=True)
    check_kernel("ragged-50", (2, 50, 50, 2, 32), bf16, device)
    check_kernel("short-kv+lse", (2, 196, 49, 2, 64), bf16, device, with_lse=True)
    check_kernel("d256 cuda-core", (2, 40, 40, 2, 256), bf16, device)
    # CvT-13's stages 2 and 3 (q tiles over 784 and 197 rows, kv tails of 196
    # and 50) and CeiT-S's class attention (one query over 12), train and
    # serve, bf16 and f32.
    new_shapes = {}
    for key, shape in (*((f"cvt {k}", v) for k, v in CVT_TRAIN_SHAPES.items() if k != "stage 1"),
                       ("ceit lca", LCA_TRAIN_SHAPE)):
        new_shapes[key] = check_kernel(f"{key} train+lse", shape, bf16, device, with_lse=True)
        check_kernel(f"{key} train+lse", shape, f32, device, with_lse=True)
    for key, shape in (*((f"cvt {k}", v) for k, v in CVT_SERVE_SHAPES.items() if k != "stage 1"),
                       ("ceit lca", LCA_SERVE_SHAPE)):
        new_shapes[f"{key} serve"] = check_kernel(f"{key} serve", shape, bf16, device)
        check_kernel(f"{key} serve", shape, f32, device)
    # TNT's inner attention: 16 pixel tokens a patch, 4 heads of 6
    # (TNT-S, train and serve) and of 10 (TNT-B, train), zero-padded to 8
    # and 16 in the wrapper, held against the plain version at the true head
    # dim; bf16 and f32.
    for key, shape, with_lse in (("tnt-s inner", TNT_TRAIN_SHAPE, True),
                                 ("tnt-s inner serve", TNT_SERVE_SHAPE, False),
                                 ("tnt-b inner", TNT_B_TRAIN_SHAPE, True)):
        new_shapes[key] = check_kernel(key + ("+lse" if with_lse else ""), shape, bf16, device,
                                       with_lse=with_lse)
        check_kernel(key + ("+lse" if with_lse else ""), shape, f32, device, with_lse=with_lse)
    return {"serve": serve_err, "train": train_err, "cait_class": class_err, **new_shapes}


def check_bwd_kernel(name, shape, dtype, device, *, packed=False):
    """The backward kernel against its plain version on the same inputs (q,
    k, v, the forward kernel's output and lse, and dO), which repeats its
    casts; then once more on the same inputs, which must give the same bits
    (no atomics). ``packed``: q/k/v strided views of one [B, L, 3, H, D]
    tensor and a dO with a row stride of 2·H·D."""
    from sav_tpu_torch.ops import fused_attention as fa

    q, k, v, _ = _inputs(shape, dtype, 13, device, packed=packed)
    b, lq, _, h, d = shape
    gen = torch.Generator(device=device).manual_seed(17)
    if packed:
        g = torch.randn((b, lq, h, 2 * d), generator=gen, device=device).to(dtype)[..., :d]
    else:
        g = torch.randn((b, lq, h, d), generator=gen, device=device).to(dtype)
    with torch.no_grad():
        out, lse = fa.fused_attention(q, k, v, with_lse=True)
        got = fa.fused_attention_bwd(q, k, v, out, lse, g)
        again = fa.fused_attention_bwd(q, k, v, out, lse, g)
        ref = fa.fused_attention_bwd_reference(q, k, v, out, lse, g)
    errs = {n: _within(a, r, TOL[dtype]) for n, a, r in zip(("dq", "dk", "dv"), got, ref)}
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"backward kernel {name}: two runs on the same inputs differ")
    variant = fa.fused_bwd_variant(d, q.element_size())
    log(
        f"backward kernel {name} {shape} {str(dtype)[6:]} ({variant}): max abs err "
        + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
        + f" (tol {TOL[dtype]}); largest |plain| "
        + ", ".join(f"{n} {r.float().abs().max().item():.3f}" for n, r in zip(("dq", "dk", "dv"), ref))
        + "; deterministic"
    )
    return max(errs.values())


def phase_bwd_kernels(device="cuda", serve_shape=SERVE_SHAPE, train_shape=TRAIN_SHAPE) -> dict:
    """All backward cases; returns the max abs error at the DeiT train shape
    and at CaiT's class-attention shape."""
    bf16, f32 = torch.bfloat16, torch.float32
    lk, d = serve_shape[2], serve_shape[4]
    train_err = check_bwd_kernel("train", train_shape, bf16, device)
    check_bwd_kernel("serve-f32", serve_shape, f32, device)
    check_bwd_kernel("packed-qkv+strided-dO", serve_shape, bf16, device, packed=True)
    check_bwd_kernel("ragged-50", (2, 50, 50, 2, 32), bf16, device)
    check_bwd_kernel("ragged-50", (2, 50, 50, 2, 32), f32, device)
    for dtype in (f32, bf16):
        check_bwd_kernel("one-query", (2, 1, lk, 2, d), dtype, device)
        check_bwd_kernel("short-kv", (2, 196, 49, 2, 64), dtype, device)
    # bf16 at head dim 128 (8 warps; two rounds of kv rows at L=197, so dq's
    # partial sums go through the f32 scratch), two rounds at head dim 64,
    # and the CUDA-core variant bf16 takes above 128.
    check_bwd_kernel("d128", (2, 100, 100, 2, 128), bf16, device)
    check_bwd_kernel("d128-two-rounds", (2, 197, 197, 2, 128), bf16, device)
    check_bwd_kernel("two-rounds", (2, 300, 300, 2, 64), bf16, device)
    check_bwd_kernel("d256", (2, 40, 40, 2, 256), bf16, device)
    class_err = check_bwd_kernel("cait-class-attention", CLASS_TRAIN_SHAPE, bf16, device)
    # CvT-13's stages 2 and 3 and CeiT-S's class attention, bf16 and f32.
    new_shapes = {}
    for key, shape in (("cvt stage 2", CVT_TRAIN_SHAPES["stage 2"]),
                       ("cvt stage 3", CVT_TRAIN_SHAPES["stage 3"]), ("ceit lca", LCA_TRAIN_SHAPE)):
        new_shapes[key] = check_bwd_kernel(key, shape, bf16, device)
        check_bwd_kernel(key, shape, f32, device)
    # TNT-S's and TNT-B's inner attention, the head dim zero-padded.
    for key, shape in (("tnt-s inner", TNT_TRAIN_SHAPE), ("tnt-b inner", TNT_B_TRAIN_SHAPE)):
        new_shapes[key] = check_bwd_kernel(key, shape, bf16, device)
        check_bwd_kernel(key, shape, f32, device)
    return {"train": train_err, "cait_class": class_err, **new_shapes}


def _th_inputs(shape, dtype, seed, device, *, packed=False):
    """q, k, v, orthogonal f32 w_pre and w_post (TalkingHeadsBlock's init)
    and dO. ``packed``: q/k/v strided views of one [B, L, 3, H, D] tensor
    and a dO with a row stride of 2·H·D."""
    b, length, h, d = shape
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*s):
        return torch.randn(s, generator=gen, device=device)

    if packed:
        q, k, v = randn(b, length, 3, h, d).to(dtype).unbind(2)
        g = randn(b, length, h, 2 * d).to(dtype)[..., :d]
    else:
        q, k, v, g = (randn(b, length, h, d).to(dtype) for _ in range(4))
    w_pre, w_post = (torch.linalg.qr(randn(h, h))[0].contiguous() for _ in range(2))
    return q, k, v, w_pre, w_post, g


def _within_largest(got, ref, tol) -> float:
    """For the [H, H] weight gradients, each a sum over B·L·L products:
    the max abs error, held at ``tol`` times the largest |ref| entry (an
    entry near 0 is the difference of large partial sums)."""
    err = (got.float() - ref.float()).abs().max().item()
    largest = ref.float().abs().max().item()
    if err > tol * largest:
        raise AssertionError(f"max abs err {err:.3e} is {err / largest:.3e} of the largest |ref| "
                             f"{largest:.3e}, above {tol:.1e}")
    return err


def _th_f64(q, k, v, w_pre, w_post, g, scale):
    """Talking-heads attention and its gradients in float64: p' rounded
    (through f32) to the value dtype before PV and dV and dS to the key
    dtype before dq and dk, where the plain versions cast them; dW_pre and
    dW_post from the unrounded values. Returns ``(out, dq, dk, dv, dw_pre,
    dw_post)``: the plain versions' arithmetic without their f32 sums and
    their rounding of the outputs."""
    qd, kd, vd, gd = (t.double() for t in (q, k, v, g))
    wp, wq = w_pre.double(), w_post.double()
    s = torch.einsum("bqhd,bkhd->bhqk", qd, kd) * scale
    p = torch.softmax(torch.einsum("hi,bhqk->biqk", wp, s), dim=-1)
    post = torch.einsum("hi,bhqk->biqk", wq, p).float().to(v.dtype).double()
    out = torch.einsum("bhqk,bkhd->bqhd", post, vd)
    dpost = torch.einsum("bqid,bkid->biqk", gd, vd)
    dv = torch.einsum("biqk,bqid->bkid", post, gd)
    dw_post = torch.einsum("bhqk,biqk->hi", p, dpost)
    dp = torch.einsum("hi,biqk->bhqk", wq, dpost)
    dsm = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    dw_pre = torch.einsum("bhqk,biqk->hi", s, dsm)
    ds = torch.einsum("hi,biqk->bhqk", wp, dsm).float().to(k.dtype).double()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kd) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qd) * scale
    return out, dq, dk, dv, dw_pre, dw_post


TH_OUTPUTS = ("fwd", "dq", "dk", "dv", "dw_pre", "dw_post")


def check_th_kernel(name, shape, dtype, device, *, packed=False, backward=True) -> dict:
    """The talking-heads forward and backward kernels against their plain
    versions on the same inputs, each run twice, which must give the same
    bits (no atomics), every launch under the variant its dtype and head
    count take (bf16 in the band: the tensor-core forward and #10's dq and
    dk/dv kernels). bf16 is held to TH_BF16_TOL, and kernel and plain
    version are also held beside a float64 twin (the first 4 batch
    elements) that rounds p' and dS where they do. ``backward=False``: the
    forward alone, for a head count the backward is not built for."""
    from sav_tpu_torch.ops import talking_heads as th

    q, k, v, w_pre, w_post, g = _th_inputs(shape, dtype, 31, device, packed=packed)
    heads, dim = shape[2], shape[3]
    bf16 = dtype == torch.bfloat16
    tols = TH_BF16_TOL if bf16 else dict.fromkeys(TH_BF16_TOL, TOL[dtype])
    rtol = 0.0 if bf16 else None
    launched = 2 if q.is_cuda else 0
    variant = th.th_variant(heads, dim, q.element_size())
    th.reset_launches()
    with torch.no_grad():
        out = th.flash_talking_heads_attention(q, k, v, w_pre, w_post)
        again = th.flash_talking_heads_attention(q, k, v, w_pre, w_post)
        ref = th.talking_heads_reference(q, k, v, w_pre, w_post)
    _require_variant("talking-heads", name, variant, launched, (("forward", th.VARIANT_LAUNCHES),))
    if not torch.equal(out, again):
        raise AssertionError(f"talking-heads forward {name}: two runs on the same inputs differ")
    errs = {"fwd": _within(out, ref, tols["fwd"], rtol)}
    scales = {"fwd": ref.float().abs().max().item()}
    kernel, plain = [out], [ref]
    if backward:
        th.reset_launches()
        with torch.no_grad():
            got = th.talking_heads_bwd(q, k, v, w_pre, w_post, g)
            again = th.talking_heads_bwd(q, k, v, w_pre, w_post, g)
            want = th.talking_heads_bwd_reference(q, k, v, w_pre, w_post, g)
        _require_variant("talking-heads", name, variant, launched,
                         (("backward", th.BWD_VARIANT_LAUNCHES),))
        _require_variant("talking-heads", name, variant,
                         launched if variant == th.TENSOR_CORE else 0,
                         (("backward dk/dv", th.BWD_DKV_VARIANT_LAUNCHES),))
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"talking-heads backward {name}: two runs on the same inputs differ")
        for n, a, r in zip(TH_OUTPUTS[1:], got, want):
            errs[n] = (_within_largest(a, r, tols[n]) if n.startswith("dw")
                       else _within(a, r, tols[n], rtol))
            scales[n] = r.float().abs().max().item()
    note = f"forward {variant}" + (f", backward {variant}" if backward else ", forward only")
    if bf16:
        n = min(shape[0], 4)
        part = [t[:n] for t in (q, k, v, g)]
        with torch.no_grad():
            kernel = [th.flash_talking_heads_attention(*part[:3], w_pre, w_post)]
            plain = [th.talking_heads_reference(*part[:3], w_pre, w_post)]
            if backward:
                kernel += th.talking_heads_bwd(*part[:3], w_pre, w_post, part[3])
                plain += th.talking_heads_bwd_reference(*part[:3], w_pre, w_post, part[3])
            exact = _th_f64(*part[:3], w_pre, w_post, part[3], dim ** -0.5)
            twin = {who: ", ".join(f"{o} {(x.double() - e).abs().max().item():.3e}"
                                   for o, x, e in zip(TH_OUTPUTS, got_, exact))
                    for who, got_ in (("kernel", kernel), ("plain", plain))}
        del exact
        note += f"; against the float64 twin: kernel {twin['kernel']}, plain {twin['plain']}"
    shares = {f"{n} share": e / scales[n] for n, e in errs.items() if n.startswith("dw")}
    log(f"talking-heads kernels {name} {shape} {str(dtype)[6:]} ({note}): max abs err "
        + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
        + ("; dW as a share of its largest |plain| entry: "
           + ", ".join(f"{n} {x:.3e}" for n, x in shares.items()) if shares else "")
        + f" (tol {json.dumps(tols)}{'' if rtol is None else ' absolute'}, dW as a share of its "
        "largest entry); largest |plain| "
        + ", ".join(f"{n} {x:.3f}" for n, x in scales.items()) + "; deterministic")
    return {**errs, **shares}


def phase_th_kernels(device="cuda") -> dict:
    """All talking-heads cases, every head count the kernels are built for
    among them; returns the max abs errors at the CaiT-XXS serve and train
    shapes in bf16, and the largest error of each output over every bf16
    case."""
    from sav_tpu_torch.ops import talking_heads as th

    bf16, f32 = torch.bfloat16, torch.float32
    cases = [("train", TH_TRAIN_SHAPE, bf16, {}), ("serve", TH_SERVE_SHAPE, bf16, {}),
             ("serve-f32", TH_SERVE_SHAPE, f32, {}),
             ("ragged-50", (2, 50, 3, 32), bf16, {}), ("ragged-50", (2, 50, 3, 32), f32, {}),
             ("6-heads", (8, 196, 6, 48), bf16, {}),  # CaiT-XS
             ("8-heads", (8, 196, 8, 48), bf16, {}),  # CaiT-S
             ("8-heads", (8, 196, 8, 48), f32, {}),
             # CaiT-M: forward only (its backward is the dense recompute),
             # on the CUDA cores; in f32 the forward takes 1 row per warp.
             ("16-heads", (8, 196, 16, 48), bf16, {"backward": False}),
             ("16-heads", (8, 196, 16, 48), f32, {"backward": False}),
             # The small CaiT of the CPU parity tests: 16 tokens, 2 heads of 16.
             ("2-heads", (2, 16, 2, 16), bf16, {}), ("2-heads", (2, 16, 2, 16), f32, {}),
             ("packed-qkv+strided-dO", TH_SERVE_SHAPE, bf16, {"packed": True})]
    if th.fused_bwd_eligible(16, 196, 196, 48):
        raise AssertionError("CaiT-M's backward is in the talking-heads band")
    errs, largest = {}, {}
    for name, shape, dtype, kw in cases:
        e = check_th_kernel(name, shape, dtype, device, **kw)
        if dtype == bf16:
            errs[name] = e
            for n, x in e.items():
                largest[n] = max(largest.get(n, 0.0), x)
    log("talking-heads bf16, largest error of each output over every case: "
        + ", ".join(f"{n} {x:.3e}" for n, x in largest.items()))
    train, serve = errs["train"], errs["serve"]
    return {"fwd_train": train["fwd"], "fwd_serve": serve["fwd"], "train": train,
            "largest": largest}


def _p_ds_f64(q, k, v, g, lse, delta, scale, bias=None):
    """p and ds in float64 from the same lse and delta, the f64 bias (if
    any) added after the scale."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double()) * scale
    if bias is not None:
        s = s + bias
    p = torch.exp(s - lse.double()[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", g.double(), v.double())
    return p, p * (dp - delta.double()[..., None])


def _grads_f64(q, k, g, p, ds, scale):
    """dq, dk and dv in float64 from p and ds rounded (through f32) to the
    inputs' dtype where the plain versions cast them: their arithmetic
    without their f32 sums and their rounding of the outputs."""
    ds = ds.float().to(q.dtype).double()
    p = p.float().to(q.dtype).double()
    return (torch.einsum("bhqk,bkhd->bqhd", ds, k.double()) * scale,
            torch.einsum("bhqk,bqhd->bkhd", ds, q.double()) * scale,
            torch.einsum("bhqk,bqhd->bkhd", p, g.double()))


def _flash_bwd_f64(q, k, v, g, lse, delta, scale):
    """dq, dk and dv of the flash backward in float64 (:func:`_grads_f64`)."""
    return _grads_f64(q, k, g, *_p_ds_f64(q, k, v, g, lse, delta, scale), scale)


def _require_variant(family, name, variant, launched, tallies) -> None:
    """Fails unless each ``(kind, tally)`` counts ``launched`` launches, all
    under ``variant``."""
    for kind, tally in tallies:
        if tally[variant] != launched or sum(tally.values()) != launched:
            raise AssertionError(f"{family} {kind} {name}: {launched} launches did not all "
                                 f"take the {variant} variant: {json.dumps(tally)}")


def check_flash_kernels(name, shape, dtype, device, *, bias_shape=None, packed=False,
                        backward=True) -> dict:
    """The flash forward against its plain version at the kernel's kv tile on
    the same inputs, output and lse; then the dq and dk/dv kernels against
    theirs, from the kernel's output and lse, each run twice on the same
    inputs, which must give the same bits (no atomics), every launch under
    the variant its dtype takes. In bf16 both the kernels and the plain
    versions are also held beside a float64 twin (the first 4 batch
    elements) that rounds p and ds where they do, so the kernels' error
    stands beside the plain versions' own. ``packed``: q/k/v strided views
    of one [B, L, 3, H, D] tensor and a dO with a row stride of 2·H·D."""
    from sav_tpu_torch.ops import flash_attention as flash

    q, k, v, bias = _inputs(shape, dtype, 41, device, bias_shape=bias_shape, packed=packed)
    # bf16: absolute limits per output; f32: TOL.
    if dtype == torch.bfloat16:
        tols, rtol = FLASH_BF16_TOL, 0.0
    else:
        tols, rtol = dict.fromkeys(FLASH_BF16_TOL, TOL[dtype]), None
    with torch.no_grad():
        out, lse = flash.flash_attention(q, k, v, bias, with_lse=True)
        ref, ref_lse = flash.flash_attention_reference(q, k, v, bias, with_lse=True)
    errs = {"fwd": _within(out, ref, tols["fwd"], rtol), "lse": _within(lse, ref_lse, LSE_TOL)}
    scales = {"fwd": ref.float().abs().max().item()}
    note = "forward only (a biased backward is the dense recompute)"
    if backward:
        b, lq, _, h, d = shape
        gen = torch.Generator(device=device).manual_seed(43)
        width = 2 * d if packed else d
        g = torch.randn((b, lq, h, width), generator=gen, device=device).to(dtype)[..., :d]
        scale = d ** -0.5
        flash.reset_launches()
        with torch.no_grad():
            delta = flash.bwd_delta(out, g)
            runs = [
                (flash.flash_attention_bwd_dq(q, k, v, g, lse, delta, scale=scale),
                 *flash.flash_attention_bwd_dkv(q, k, v, g, lse, delta, scale=scale))
                for _ in range(2)
            ]
            want = (flash.flash_bwd_dq_reference(q, k, v, g, lse, delta, scale=scale),
                    *flash.flash_bwd_dkv_reference(q, k, v, g, lse, delta, scale=scale))
        # Two launches of each on the card, none on CPU tensors.
        variant = flash.flash_bwd_variant(q.element_size())
        _require_variant("flash", name, variant, 2 if q.is_cuda else 0,
                         (("dq", flash.BWD_DQ_VARIANT_LAUNCHES),
                          ("dk/dv", flash.BWD_DKV_VARIANT_LAUNCHES)))
        errs.update({n: _within(a, r, tols[n], rtol)
                     for n, a, r in zip(("dq", "dk", "dv"), runs[0], want)})
        scales.update({n: r.float().abs().max().item() for n, r in zip(("dq", "dk", "dv"), want)})
        if not all(torch.equal(a, b) for a, b in zip(*runs)):
            raise AssertionError(f"flash backward {name}: two runs on the same inputs differ")
        note = f"backward deterministic, {variant}"
        if dtype == torch.bfloat16:
            n = min(b, 4)
            exact = _flash_bwd_f64(*(t[:n] for t in (q, k, v, g, lse, delta)), scale)
            twin = {who: ", ".join(f"{o} {(x[:n].double() - e).abs().max().item():.3e}"
                                   for o, x, e in zip(("dq", "dk", "dv"), got, exact))
                    for who, got in (("kernel", runs[0]), ("plain", want))}
            del exact
            note += (f"; against the float64 twin: kernel {twin['kernel']}, "
                     f"plain {twin['plain']}")
    log(f"flash kernels {name} {shape} {str(dtype)[6:]}: max abs err "
        + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
        + f" (tol {json.dumps(tols)}{'' if rtol is None else ' absolute'}, lse {LSE_TOL});"
        + " largest |plain| "
        + ", ".join(f"{n} {x:.3f}" for n, x in scales.items()) + f"; {note}")
    return errs


def phase_flash_kernels(device="cuda") -> dict:
    """All flash cases; returns the max abs errors at the ViT-B/16@384 train
    shape in bf16."""
    bf16, f32 = torch.bfloat16, torch.float32
    train = check_flash_kernels("vit-b/16@384 train", VIT384_SHAPE, bf16, device)
    check_flash_kernels("vit-b/16@384", (2, 577, 577, 12, 64), f32, device)
    for dtype in (f32, bf16):
        check_flash_kernels("ragged-50", (2, 50, 50, 2, 32), dtype, device)
        check_flash_kernels("multi-tile-d40", (2, 320, 256, 2, 40), dtype, device)
        check_flash_kernels("d128", (2, 200, 200, 2, 128), dtype, device)
    check_flash_kernels("cait-class-attention@384", CLASS384_SHAPE, bf16, device)
    for dtype in (f32, bf16):
        check_flash_kernels("short-kv", (2, 196, 49, 2, 64), dtype, device)
    for dtype in (f32, bf16):
        for bias_shape in ((2, 4, 130, 150), (1, 1, 130, 150)):
            check_flash_kernels(f"bias{bias_shape[:2]}", (2, 130, 150, 4, 32), dtype, device,
                                bias_shape=bias_shape, backward=False)
    check_flash_kernels("packed-qkv+strided-dO", (8, 577, 577, 12, 64), bf16, device, packed=True)
    # CvT-13's stage 1: 49 q tiles over 13 kv tiles (the last of 16 rows),
    # train in bf16 and f32, serve forward in bf16.
    stage1 = check_flash_kernels("cvt stage 1 train", CVT_TRAIN_SHAPES["stage 1"], bf16, device)
    check_flash_kernels("cvt stage 1 train", CVT_TRAIN_SHAPES["stage 1"], f32, device)
    serve1 = check_flash_kernels("cvt stage 1 serve", CVT_SERVE_SHAPES["stage 1"], bf16, device,
                                 backward=False)
    return {"fwd": train["fwd"], "dq": train["dq"], "dkv": max(train["dk"], train["dv"]),
            "cvt stage 1": {"fwd": stage1["fwd"], "dq": stage1["dq"],
                            "dkv": max(stage1["dk"], stage1["dv"]),
                            "fwd serve": serve1["fwd"]}}


def _rel_inputs(shape, dtype, seed, device, *, packed=False):
    """q, k, v, f32 compact logits rw_abs [B, H, L, W] and rh_abs
    [B, H, L, Hg] (std 1, the scale of q·rel_emb at init) and dO for a
    ``(B, Hg, W, H, D)`` grid. ``packed``: q/k/v strided views of one
    [B, L, 3, H, D] tensor and a dO with a row stride of 2·H·D."""
    b, hg, w, h, d = shape
    length = hg * w
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*s):
        return torch.randn(s, generator=gen, device=device)

    if packed:
        q, k, v = randn(b, length, 3, h, d).to(dtype).unbind(2)
    else:
        q, k, v = (randn(b, length, h, d).to(dtype) for _ in range(3))
    rw, rh = randn(b, h, length, w), randn(b, h, length, hg)
    g = randn(b, length, h, 2 * d if packed else d).to(dtype)[..., :d]
    return q, k, v, rw, rh, g


def _rel_bwd_f64(q, k, v, rw, rh, g, lse, delta, scale):
    """dq, d_rw, d_rh, dk and dv of the relative-position backward in
    float64: dq, dk and dv as :func:`_grads_f64` forms them, d_rw and d_rh
    summed from the unrounded ds."""
    from sav_tpu_torch.ops import flash_attention as flash

    height, width = rh.shape[-1], rw.shape[-1]
    bias = flash.expand_relative_bias(rw.double(), rh.double(), height, width)
    p, ds = _p_ds_f64(q, k, v, g, lse, delta, scale, bias)
    grid = ds.reshape(*ds.shape[:3], height, width)
    dq, dk, dv = _grads_f64(q, k, g, p, ds, scale)
    return dq, grid.sum(-2), grid.sum(-1), dk, dv


def check_rel_kernels(name, shape, dtype, device, *, packed=False) -> dict:
    """Kernels #6-#8 against their plain versions on the same inputs: the
    forward's output and lse; from the kernel's output and lse, dq, d_rw,
    d_rh, dk and dv, each backward run twice on the same inputs, which must
    give the same bits (no atomics), every backward launch under the variant
    its dtype takes. In bf16 the backward kernels and their plain versions
    are also held beside a float64 twin (the first 4 batch elements) that
    rounds p and ds where they do, so the kernels' error stands beside the
    plain versions' own. ``shape`` is ``(B, Hg, W, H, D)``; ``packed``:
    q/k/v strided views of one [B, L, 3, H, D] tensor and a strided dO."""
    from sav_tpu_torch.ops import flash_attention as flash

    q, k, v, rw, rh, g = _rel_inputs(shape, dtype, 61, device, packed=packed)
    scale = shape[-1] ** -0.5
    if dtype == torch.bfloat16:
        tols, rtol = REL_BF16_TOL, 0.0
    else:
        tols, rtol = dict.fromkeys(REL_BF16_TOL, TOL[dtype]), None
    with torch.no_grad():
        out, lse = flash.rel_attention(q, k, v, rw, rh, scale=scale, with_lse=True)
        again = flash.rel_attention(q, k, v, rw, rh, scale=scale, with_lse=True)
        ref, ref_lse = flash.rel_attention_reference(q, k, v, rw, rh, scale=scale, with_lse=True)
        delta = flash.bwd_delta(out, g)
        operands = (q, k, v, rw, rh, g, lse, delta)
        flash.reset_launches()
        runs = [(*flash.rel_attention_bwd_dq(*operands, scale=scale),
                 *flash.rel_attention_bwd_dkv(*operands, scale=scale)) for _ in range(2)]
        want = (*flash.rel_bwd_dq_reference(*operands, scale=scale),
                *flash.rel_bwd_dkv_reference(*operands, scale=scale))
    # Two launches of each on the card, none on CPU tensors.
    variant = flash.rel_bwd_variant(q.element_size())
    _require_variant("relative-position", name, variant, 2 if q.is_cuda else 0,
                     (("dq", flash.REL_BWD_DQ_VARIANT_LAUNCHES),
                      ("dk/dv", flash.REL_BWD_DKV_VARIANT_LAUNCHES)))
    names = ("dq", "d_rw", "d_rh", "dk", "dv")
    errs = {"fwd": _within(out, ref, tols["fwd"], rtol), "lse": _within(lse, ref_lse, LSE_TOL)}
    errs.update({n: _within(a, r, tols[n], rtol if n in ("dq", "dk", "dv") else None)
                 for n, a, r in zip(names, runs[0], want)})
    scales = {"fwd": ref.float().abs().max().item()}
    scales.update({n: r.float().abs().max().item() for n, r in zip(names, want)})
    if not all(torch.equal(a, b) for a, b in zip(*runs)):
        raise AssertionError(f"relative-position backward {name}: two runs on the same inputs differ")
    if not (torch.equal(out, again[0]) and torch.equal(lse, again[1])):
        raise AssertionError(f"relative-position forward {name}: two runs on the same inputs differ")
    note = f"backward {variant}"
    if dtype == torch.bfloat16:
        n = min(shape[0], 4)
        with torch.no_grad():
            exact = _rel_bwd_f64(*(t[:n] for t in operands), scale)
            twin = {who: ", ".join(f"{o} {(x[:n].double() - e).abs().max().item():.3e}"
                                   for o, x, e in zip(names, got, exact))
                    for who, got in (("kernel", runs[0]), ("plain", want))}
        del exact
        note += f"; against the float64 twin: kernel {twin['kernel']}, plain {twin['plain']}"
    log(f"rel kernels {name} {shape} {str(dtype)[6:]} (forward "
        f"{flash.rel_fwd_variant(q.element_size())}, {note}): max abs err "
        + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
        + f" (tol {json.dumps(tols)}{'' if rtol is None else ' absolute, d_rw/d_rh relative too'},"
        f" lse {LSE_TOL}); largest |plain| "
        + ", ".join(f"{n} {x:.3f}" for n, x in scales.items()) + "; forward and backward "
        "deterministic")
    return errs


def phase_rel_kernels(device="cuda") -> dict:
    """All relative-position cases; returns the max abs errors at the two
    BoTNet-T3 stage-4 train shapes in bf16."""
    bf16, f32 = torch.bfloat16, torch.float32
    errs = {}
    for key, shape in REL_TRAIN_SHAPES.items():
        errs[key] = check_rel_kernels(f"botnet-t3 {key} train", shape, bf16, device)
        check_rel_kernels(f"botnet-t3 {key} train", shape, f32, device)
    for dtype in (f32, bf16):
        check_rel_kernels("grid-7x9", (2, 7, 9, 3, 16), dtype, device)
        check_rel_kernels("grid-5x6-d8", (2, 5, 6, 2, 8), dtype, device)
        check_rel_kernels("grid-2x130", (1, 2, 130, 2, 8), dtype, device)
        # The f32 band's edge at head dim 128 (W + Hg = 156).
        check_rel_kernels("grid-78x78-d128", (1, 78, 78, 1, 128), dtype, device)
    check_rel_kernels("grid-14x14-d64 strided", (8, 14, 14, 4, 64), bf16, device, packed=True)
    check_rel_kernels("botnet-t3 L=196 strided", (32, 14, 14, 4, 128), bf16, device, packed=True)
    return errs


def _median_ms(fn, iters=30, warmup=5) -> float:
    """Median device time of ``fn`` over ``iters`` launches, each after an
    L2 flush (64 MB > the 50 MB L2) and a device-side spin that keeps the
    host's enqueue time out of the measured span."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(1_000_000)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def _bound(nbytes: int, flops: dict) -> dict:
    """The least time the card could take: the largest of the bytes over HBM
    bandwidth and the operations of each type over that type's peak rate
    (``{dtype: flops}``). The types are not summed: bf16 products run on the
    tensor cores and f32 on the FMA pipes, which work at the same time."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    flops_ms = max(n / PEAK_FLOPS[dtype] for dtype, n in flops.items()) * 1e3
    return {
        "bound_ms": max(bytes_ms, flops_ms),
        "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
    }


def time_fwd(shape, *, with_lse: bool) -> dict:
    """The forward kernel, its plain version and SDPA (yardstick) in bf16."""
    import torch.nn.functional as F

    from sav_tpu_torch.ops import fused_attention as fa

    dtype = torch.bfloat16
    b, lq, lk, h, d = shape
    q, k, v, _ = _inputs(shape, dtype, 11, "cuda")
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))  # [B, H, L, D] views
    with torch.inference_mode():
        times = {
            "ms": _median_ms(lambda: fa.fused_attention(q, k, v, with_lse=with_lse)),
            "plain_ms": _median_ms(lambda: fa.fused_attention_reference(q, k, v, with_lse=with_lse)),
            "library_ms": _median_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt)),
        }
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    nbytes += b * h * lq * 4 if with_lse else 0
    flops = 4 * b * h * lq * lk * d
    times.update(_bound(nbytes, {dtype: flops}))
    log(
        f"timing forward {shape} bf16{' +lse' if with_lse else ''}, median of 30, cold L2: "
        f"kernel {times['ms']:.4f} ms, plain {times['plain_ms']:.4f} ms, "
        f"scaled_dot_product_attention {times['library_ms']:.4f} ms; bound "
        f"{times['bound_ms']:.4f} ms by {times['bound_by']} ({nbytes / 1e6:.1f} MB, "
        f"{flops / 1e9:.2f} GFLOP)"
    )
    return times


def time_bwd(shape) -> dict:
    """The backward kernel, its plain version and, as yardstick, the backward
    of scaled_dot_product_attention through torch.autograd.grad, in bf16."""
    import torch.nn.functional as F

    from sav_tpu_torch.ops import fused_attention as fa

    dtype = torch.bfloat16
    b, lq, lk, h, d = shape
    q, k, v, _ = _inputs(shape, dtype, 12, "cuda")
    g = torch.randn((b, lq, h, d), generator=torch.Generator(device="cuda").manual_seed(14),
                    device="cuda").to(dtype)
    with torch.no_grad():
        out, lse = fa.fused_attention(q, k, v, with_lse=True)
        times = {
            "ms": _median_ms(lambda: fa.fused_attention_bwd(q, k, v, out, lse, g)),
            "plain_ms": _median_ms(lambda: fa.fused_attention_bwd_reference(q, k, v, out, lse, g)),
        }
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    ot = F.scaled_dot_product_attention(qt, kt, vt)
    gt = g.transpose(1, 2)
    times["library_ms"] = _median_ms(
        lambda: torch.autograd.grad(ot, (qt, kt, vt), gt, retain_graph=True)
    )
    # In: q, k, v, o, dO and the f32 lse; out: dq, dk, dv. Five products.
    nbytes = (2 * q.numel() + k.numel() + v.numel() + g.numel()) * q.element_size()
    nbytes += b * h * lq * 4 + (q.numel() + k.numel() + v.numel()) * q.element_size()
    flops = 10 * b * h * lq * lk * d
    times.update(_bound(nbytes, {dtype: flops}))
    log(
        f"timing backward {shape} bf16, median of 30, cold L2: kernel {times['ms']:.4f} ms, "
        f"plain {times['plain_ms']:.4f} ms, scaled_dot_product_attention backward "
        f"{times['library_ms']:.4f} ms; bound {times['bound_ms']:.4f} ms by "
        f"{times['bound_by']} ({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)"
    )
    return times


def time_th_fwd(shape) -> dict:
    """The talking-heads forward kernel, its plain version and the port's
    dense talking-heads path, in bf16. No single PyTorch call computes
    talking-heads attention, so there is no library yardstick."""
    from sav_tpu_torch.ops import talking_heads as th

    dtype = torch.bfloat16
    b, length, h, d = shape
    q, k, v, w_pre, w_post, _ = _th_inputs(shape, dtype, 21, "cuda")
    with torch.inference_mode():
        times = {
            "ms": _median_ms(lambda: th.flash_talking_heads_attention(q, k, v, w_pre, w_post)),
            "plain_ms": _median_ms(lambda: th.talking_heads_reference(q, k, v, w_pre, w_post)),
            "dense_ms": _median_ms(lambda: th.dense_talking_heads(q, k, v, w_pre, w_post)),
            "library_ms": None,
        }
    # In: q, k, v and the two f32 weights; out: o. QKᵀ and PV on the inputs'
    # type, the two head mixes (2·H multiply-adds per mixed score) in f32.
    nbytes = 4 * q.numel() * q.element_size() + 2 * h * h * 4
    flops = {dtype: 4 * b * h * length * length * d, torch.float32: 2 * 2 * h * h * b * length * length}
    times.update(_bound(nbytes, flops))
    log(
        f"timing talking-heads forward {shape} bf16, median of 30, cold L2: kernel "
        f"{times['ms']:.4f} ms, plain {times['plain_ms']:.4f} ms, dense path "
        f"{times['dense_ms']:.4f} ms; bound {times['bound_ms']:.4f} ms by {times['bound_by']} "
        f"({nbytes / 1e6:.1f} MB, {flops[dtype] / 1e9:.2f} GFLOP bf16 + "
        f"{flops[torch.float32] / 1e9:.2f} GFLOP f32)"
    )
    if times["ms"] >= times["dense_ms"]:
        raise AssertionError(f"the talking-heads forward ({times['ms']:.4f} ms) is not faster "
                             f"than the dense path ({times['dense_ms']:.4f} ms) at {shape}")
    return times


def _kernel_ms(fn, fragments, iters=30, warmup=5) -> dict:
    """Median device time of each kernel whose name holds one of
    ``fragments``, over ``iters`` runs of ``fn`` under torch.profiler, each
    run after the L2 flush of :func:`_median_ms`: the time each kernel takes
    within ``fn``'s own sequence (a later kernel finds what the earlier
    ones left in L2)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    times = {f: [] for f in fragments}
    for event in prof.events():
        if event.device_type == DeviceType.CUDA:
            for f in fragments:
                if f in event.name:
                    times[f].append(event.time_range.elapsed_us() / 1e3)
    if any(len(t) != iters for t in times.values()):
        raise RuntimeError(f"the profiler did not record {iters} launches of each of "
                           f"{fragments}: {json.dumps({f: len(t) for f, t in times.items()})}")
    return {f: statistics.median(t) for f, t in times.items()}


def time_th_bwd(shape) -> dict:
    """The talking-heads backward (in bf16 #10's dq and dk/dv kernels, one
    after the other), its plain version and the backward of the dense path
    through torch.autograd.grad, in bf16; and each of the two kernels'
    own device time within the backward (torch.profiler), beside its
    bound and its own plain version's time."""
    from sav_tpu_torch.ops import talking_heads as th

    dtype = torch.bfloat16
    b, length, h, d = shape
    q, k, v, w_pre, w_post, g = _th_inputs(shape, dtype, 22, "cuda")
    with torch.no_grad():
        times = {
            "ms": _median_ms(lambda: th.talking_heads_bwd(q, k, v, w_pre, w_post, g)),
            "plain_ms": _median_ms(lambda: th.talking_heads_bwd_reference(q, k, v, w_pre, w_post, g)),
        }
        split = _kernel_ms(lambda: th.talking_heads_bwd(q, k, v, w_pre, w_post, g),
                           ("talking_heads_bwd_dq_mma_kernel", "talking_heads_bwd_dkv_mma_kernel"))
        lse, delta = th.talking_heads_bwd_dq_reference(q, k, v, w_pre, w_post, g)[3:]
        split_plain = {
            "dq": _median_ms(lambda: th.talking_heads_bwd_dq_reference(q, k, v, w_pre, w_post, g)),
            "dkv": _median_ms(lambda: th.talking_heads_bwd_dkv_reference(
                q, k, v, w_pre, w_post, g, lse, delta)),
        }
        del lse, delta
    inputs = [t.detach().requires_grad_() for t in (q, k, v, w_pre, w_post)]
    out = th.dense_talking_heads(*inputs)
    times["dense_ms"] = _median_ms(lambda: torch.autograd.grad(out, inputs, g, retain_graph=True))
    times["library_ms"] = None
    del out, inputs
    # In: q, k, v, dO and the weights; out: dq, dk, dv and the dW. Five
    # products on the inputs' type; in f32 the pre- and post-mix recompute,
    # the dP and dS mixes and the two dW reductions (2·H² per score each).
    item = q.element_size()
    nbytes = 7 * q.numel() * item + 4 * h * h * 4
    pairs = b * length * length
    flops = {dtype: 10 * b * h * length * length * d, torch.float32: 6 * 2 * h * h * pairs}
    times.update(_bound(nbytes, flops))
    # Each kernel alone, the work its function needs, each product and mix
    # once (the dq kernel's second sweep over kv recomputes S, dP', the
    # pre-mix and the dP mix; that is this design's cost, not the
    # function's). dq reads q, k, v, dO and writes dq, each row's lse and
    # delta per mixed head and the dW partials; its products are S, dP' and
    # dS.K, its f32 work the pre- and dP mixes, dW_pre, dW_post and the dS
    # mix. dk/dv reads q, k, v, dO, lse and delta and writes dk and dv; its
    # products are S, dP', P'.dO and dS.Q, its f32 work the pre-, post-, dP
    # and dS mixes.
    stats = 2 * b * h * length * 4
    q_tiles = -(-length // th.th_mma_block("bwd_dq", h, d)["rows"])
    kernels = {}
    for name, frag, nb, mm, f32 in (
        ("dq", "talking_heads_bwd_dq_mma_kernel",
         5 * q.numel() * item + stats + b * q_tiles * 2 * h * h * 4, 3, 5 * 2 * h * h * pairs),
        ("dkv", "talking_heads_bwd_dkv_mma_kernel", 6 * q.numel() * item + stats, 4,
         4 * 2 * h * h * pairs),
    ):
        entry = {"ms": split[frag], "plain_ms": split_plain[name], "library_ms": None}
        entry.update(_bound(nb, {dtype: 2 * mm * b * h * length * length * d, torch.float32: f32}))
        kernels[name] = entry
    times["kernels"] = kernels
    log(
        f"timing talking-heads backward {shape} bf16, median of 30, cold L2: kernels "
        f"{times['ms']:.4f} ms, plain {times['plain_ms']:.4f} ms, dense path backward "
        f"{times['dense_ms']:.4f} ms; bound {times['bound_ms']:.4f} ms by {times['bound_by']} "
        f"({nbytes / 1e6:.1f} MB, {flops[dtype] / 1e9:.2f} GFLOP bf16 + "
        f"{flops[torch.float32] / 1e9:.2f} GFLOP f32); within it (torch.profiler) "
        + ", ".join(f"{n} {e['ms']:.4f} ms (its plain version {e['plain_ms']:.4f} ms; bound "
                    f"{e['bound_ms']:.4f} by {e['bound_by']})" for n, e in kernels.items())
    )
    if times["ms"] >= times["dense_ms"]:
        raise AssertionError(f"the talking-heads backward ({times['ms']:.4f} ms) is not faster "
                             f"than the dense path's ({times['dense_ms']:.4f} ms) at {shape}")
    return times


def time_th_bwd_band(shapes) -> dict:
    """`auto`'s choice of #10 over the dense backward across the tensor-core
    band: the whole backward against the dense path's, in bf16, at each
    shape; fails where #10 is the slower."""
    from sav_tpu_torch.ops import talking_heads as th

    out = {}
    for shape in shapes:
        q, k, v, w_pre, w_post, g = _th_inputs(shape, torch.bfloat16, 23, "cuda")
        with torch.no_grad():
            ms = _median_ms(lambda: th.talking_heads_bwd(q, k, v, w_pre, w_post, g))
        inputs = [t.detach().requires_grad_() for t in (q, k, v, w_pre, w_post)]
        dense = th.dense_talking_heads(*inputs)
        dense_ms = _median_ms(lambda: torch.autograd.grad(dense, inputs, g, retain_graph=True))
        del dense, inputs
        out[str(shape)] = {"ms": ms, "dense_ms": dense_ms}
        log(f"timing talking-heads backward {shape} bf16 ({th.th_variant(shape[2], shape[3], 2)}), "
            f"median of 30, cold L2: kernels {ms:.4f} ms, dense path backward {dense_ms:.4f} ms")
        if ms >= dense_ms:
            raise AssertionError(f"the talking-heads backward is slower than the dense path at {shape}")
    return out


def time_flash(shape, *, backward=True) -> dict:
    """#3 (with lse) and, with ``backward``, #4 and #5 in bf16, each beside
    its plain version and as yardstick scaled_dot_product_attention: its
    forward for #3, its backward (dq, dk and dv in one call, through
    torch.autograd.grad) for #4 and #5. With ``backward`` also the whole
    flash backward as ``auto`` would run it (delta, #4 and #5) under
    ``"bwd_ms"``."""
    import torch.nn.functional as F

    from sav_tpu_torch.ops import flash_attention as flash

    dtype = torch.bfloat16
    b, lq, lk, h, d = shape
    scale = d ** -0.5
    q, k, v, _ = _inputs(shape, dtype, 51, "cuda")
    g = torch.randn((b, lq, h, d), generator=torch.Generator(device="cuda").manual_seed(53),
                    device="cuda").to(dtype)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    with torch.no_grad():
        out, lse = flash.flash_attention(q, k, v, with_lse=True)
        delta = flash.bwd_delta(out, g)
        times = {"fwd": {
            "ms": _median_ms(lambda: flash.flash_attention(q, k, v, with_lse=True)),
            "plain_ms": _median_ms(lambda: flash.flash_attention_reference(q, k, v, with_lse=True)),
            "library_ms": _median_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt)),
        }}
        if backward:
            times["dq"] = {
                "ms": _median_ms(lambda: flash.flash_attention_bwd_dq(
                    q, k, v, g, lse, delta, scale=scale)),
                "plain_ms": _median_ms(lambda: flash.flash_bwd_dq_reference(
                    q, k, v, g, lse, delta, scale=scale)),
            }
            times["dkv"] = {
                "ms": _median_ms(lambda: flash.flash_attention_bwd_dkv(
                    q, k, v, g, lse, delta, scale=scale)),
                "plain_ms": _median_ms(lambda: flash.flash_bwd_dkv_reference(
                    q, k, v, g, lse, delta, scale=scale)),
            }
    if backward:
        ot = F.scaled_dot_product_attention(qt, kt, vt)
        gt = g.transpose(1, 2)
        sdpa_bwd = _median_ms(lambda: torch.autograd.grad(ot, (qt, kt, vt), gt, retain_graph=True))
        times["dq"]["library_ms"] = times["dkv"]["library_ms"] = sdpa_bwd
        del ot
        with torch.no_grad():
            whole_bwd = _median_ms(lambda: flash.flash_attention_bwd(q, k, v, out, lse, g))
    # Each input read once, each output written once; lse and delta are f32
    # rows. Products: forward QKᵀ, PV; dq QKᵀ, dO·Vᵀ, dS·K; dk/dv those two
    # and Pᵀ·dO, dSᵀ·Q, each 2·B·H·Lq·Lk·D.
    tensor = q.numel() * q.element_size()
    kv = k.numel() * k.element_size()
    rows = b * h * lq * 4
    product = 2 * b * h * lq * lk * d
    work = {"fwd": (2 * tensor + 2 * kv + rows, 2 * product),
            "dq": (3 * tensor + 2 * kv + 2 * rows, 3 * product),
            "dkv": (2 * tensor + 4 * kv + 2 * rows, 4 * product)}
    for name, entry in times.items():
        nbytes, flops = work[name]
        entry.update(_bound(nbytes, {dtype: flops}))
        log(
            f"timing flash {name} {shape} bf16, median of 30, cold L2: kernel {entry['ms']:.4f} ms, "
            f"plain {entry['plain_ms']:.4f} ms, scaled_dot_product_attention "
            f"{'backward ' if name != 'fwd' else ''}{entry['library_ms']:.4f} ms; bound "
            f"{entry['bound_ms']:.4f} ms by {entry['bound_by']} ({nbytes / 1e6:.1f} MB, "
            f"{flops / 1e9:.2f} GFLOP)"
        )
    if backward:
        times["bwd_ms"] = whole_bwd
        log(f"timing flash backward {shape} bf16 (delta, dq and dk/dv), median of 30, cold L2: "
            f"{whole_bwd:.4f} ms")
    return times


def time_rel(shape, *, backward=True) -> dict:
    """#6 (with lse) and, with ``backward``, #7 and #8 in bf16, each beside
    its plain version and a yardstick: scaled_dot_product_attention with the
    relative bias expanded to [B, H, L, L] (bf16) as its float attn_mask,
    its forward for #6 and its backward (dq, dk and dv in one call, through
    torch.autograd.grad; the bias gradient is not asked for) for #7 and #8.
    The yardstick reads the expanded bias; building it is not timed."""
    import torch.nn.functional as F

    from sav_tpu_torch.ops import flash_attention as flash

    dtype = torch.bfloat16
    b, hg, w, h, d = shape
    length = hg * w
    scale = d ** -0.5
    q, k, v, rw, rh, g = _rel_inputs(shape, dtype, 71, "cuda")
    mask = flash.expand_relative_bias(rw, rh, hg, w).to(dtype)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    with torch.no_grad():
        out, lse = flash.rel_attention(q, k, v, rw, rh, scale=scale, with_lse=True)
        delta = flash.bwd_delta(out, g)
        operands = (q, k, v, rw, rh, g, lse, delta)
        times = {"fwd": {
            "ms": _median_ms(lambda: flash.rel_attention(q, k, v, rw, rh, scale=scale,
                                                         with_lse=True)),
            "plain_ms": _median_ms(lambda: flash.rel_attention_reference(
                q, k, v, rw, rh, scale=scale, with_lse=True)),
            "library_ms": _median_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, scale=scale)),
        }}
        if backward:
            times["dq"] = {
                "ms": _median_ms(lambda: flash.rel_attention_bwd_dq(*operands, scale=scale)),
                "plain_ms": _median_ms(lambda: flash.rel_bwd_dq_reference(*operands, scale=scale)),
            }
            times["dkv"] = {
                "ms": _median_ms(lambda: flash.rel_attention_bwd_dkv(*operands, scale=scale)),
                "plain_ms": _median_ms(lambda: flash.rel_bwd_dkv_reference(*operands, scale=scale)),
            }
    if backward:
        ot = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, scale=scale)
        gt = g.transpose(1, 2)
        sdpa_bwd = _median_ms(lambda: torch.autograd.grad(ot, (qt, kt, vt), gt, retain_graph=True))
        times["dq"]["library_ms"] = times["dkv"]["library_ms"] = sdpa_bwd
        del ot
    # Each input read once, each output written once: q/k/v/o/dO/dq/dk/dv
    # tensors, the f32 compact logits (and their gradients), f32 lse and
    # delta rows. bf16 products, each 2·B·H·L²·D: forward QKᵀ, PV; dq QKᵀ,
    # dO·Vᵀ, dS·K; dk/dv those two and Pᵀ·dO, dSᵀ·Q. f32: the two bias adds
    # per score, and in dq the two row sums of each ds.
    tensor = q.numel() * q.element_size()
    compact = (rw.numel() + rh.numel()) * 4
    rows = b * h * length * 4
    product = 2 * b * h * length * length * d
    scores = b * h * length * length
    work = {"fwd": (4 * tensor + compact + rows, 2 * product, 2 * scores),
            "dq": (5 * tensor + 2 * compact + 2 * rows, 3 * product, 4 * scores),
            "dkv": (6 * tensor + compact + 2 * rows, 4 * product, 2 * scores)}
    for name, entry in times.items():
        nbytes, flops, f32_ops = work[name]
        entry.update(_bound(nbytes, {dtype: flops, torch.float32: f32_ops}))
        log(
            f"timing rel {name} {shape} bf16, median of 30, cold L2: kernel {entry['ms']:.4f} ms, "
            f"plain {entry['plain_ms']:.4f} ms, scaled_dot_product_attention with the expanded "
            f"bias {'backward ' if name != 'fwd' else ''}{entry['library_ms']:.4f} ms; bound "
            f"{entry['bound_ms']:.4f} ms by {entry['bound_by']} ({nbytes / 1e6:.1f} MB, "
            f"{flops / 1e9:.2f} GFLOP bf16 + {f32_ops / 1e9:.3f} GFLOP f32)"
        )
    return times


def phase_timing() -> dict:
    times = {
        "fwd_serve": time_fwd(SERVE_SHAPE, with_lse=False),
        "fwd_train": time_fwd(TRAIN_SHAPE, with_lse=True),
        "bwd_train": time_bwd(TRAIN_SHAPE),
        "fwd_class_serve": time_fwd(CLASS_SERVE_SHAPE, with_lse=False),
        "fwd_class_train": time_fwd(CLASS_TRAIN_SHAPE, with_lse=True),
        "bwd_class_train": time_bwd(CLASS_TRAIN_SHAPE),
        "th_fwd_serve": time_th_fwd(TH_SERVE_SHAPE),
        "th_fwd_train": time_th_fwd(TH_TRAIN_SHAPE),
        "th_bwd_train": time_th_bwd(TH_TRAIN_SHAPE),
        # CaiT-XS and CaiT-S at batch 64, a 3-head ragged shape and the
        # serve batch: the rest of #10's tensor-core band beside the dense path.
        "th_bwd_band": time_th_bwd_band(((64, 196, 6, 48), (64, 196, 8, 48), (64, 50, 3, 32),
                                         TH_SERVE_SHAPE)),
        "flash_vit384": time_flash(VIT384_SHAPE),
        "bwd_vit384": time_bwd(VIT384_SHAPE),
        "flash_deit_train": time_flash(TRAIN_SHAPE),
        "flash_fwd_deit_serve": time_flash(SERVE_SHAPE, backward=False)["fwd"],
        **{f"rel {key}": time_rel(shape) for key, shape in REL_TRAIN_SHAPES.items()},
        **{f"rel {key} serve": time_rel(shape, backward=False)["fwd"]
           for key, shape in REL_SERVE_SHAPES.items()},
    }
    # CvT-13 (q_len != kv_len): stage 1 on the flash kernels, train and the
    # serve forward; stages 2 and 3 on the fused ones, train (forward with
    # the lse, backward) and serve; CeiT-S's class attention (one query over
    # 12) on the fused ones. At each CvT shape the forward auto did not take
    # is timed too: #1 at stage 1 (kv 784 is inside the tensor-core #1's
    # band, 800, and outside the crossover auto keeps, 679), #3 at stages 2
    # and 3.
    times["cvt stage 1"] = time_flash(CVT_TRAIN_SHAPES["stage 1"])
    times["cvt stage 1 serve"] = time_flash(CVT_SERVE_SHAPES["stage 1"], backward=False)["fwd"]
    times["cvt stage 1 fused"] = time_fwd(CVT_TRAIN_SHAPES["stage 1"], with_lse=True)
    for key in ("stage 2", "stage 3"):
        times[f"cvt {key} fwd"] = time_fwd(CVT_TRAIN_SHAPES[key], with_lse=True)
        times[f"cvt {key} bwd"] = time_bwd(CVT_TRAIN_SHAPES[key])
        times[f"cvt {key} serve"] = time_fwd(CVT_SERVE_SHAPES[key], with_lse=False)
        times[f"cvt {key} flash"] = time_flash(CVT_TRAIN_SHAPES[key], backward=False)["fwd"]
    times["ceit lca fwd"] = time_fwd(LCA_TRAIN_SHAPE, with_lse=True)
    times["ceit lca bwd"] = time_bwd(LCA_TRAIN_SHAPE)
    times["ceit lca serve"] = time_fwd(LCA_SERVE_SHAPE, with_lse=False)
    # TNT's inner attention: the wrapper's whole call (the zero pad, the
    # kernel on the padded head dim, the slice) against the plain version
    # and SDPA at the true head dim; the bound by the true head dim's bytes
    # and operations.
    times["tnt-s inner fwd"] = time_fwd(TNT_TRAIN_SHAPE, with_lse=True)
    times["tnt-s inner bwd"] = time_bwd(TNT_TRAIN_SHAPE)
    times["tnt-s inner serve"] = time_fwd(TNT_SERVE_SHAPE, with_lse=False)
    times["tnt-b inner fwd"] = time_fwd(TNT_B_TRAIN_SHAPE, with_lse=True)
    times["tnt-b inner bwd"] = time_bwd(TNT_B_TRAIN_SHAPE)
    for key, shape in CVT_TRAIN_SHAPES.items():
        fused, flash = ((times["cvt stage 1 fused"], times["cvt stage 1"]["fwd"])
                        if key == "stage 1" else (times[f"cvt {key} fwd"], times[f"cvt {key} flash"]))
        log(f"forward at CvT-13's {key} train shape {shape} bf16 (with lse): auto takes "
            f"{'#3' if key == 'stage 1' else '#1'}; #1 {fused['ms']:.4f} ms, #3 "
            f"{flash['ms']:.4f} ms, #1/#3 {fused['ms'] / flash['ms']:.2f}")
    # The forward crossover auto does not move: #1 against #3 at DeiT's shapes.
    times["flash_fwd_deit_train"] = times["flash_deit_train"]["fwd"]
    for name, shape, fused, flash in (("train", TRAIN_SHAPE, "fwd_train", "flash_fwd_deit_train"),
                                      ("serve", SERVE_SHAPE, "fwd_serve", "flash_fwd_deit_serve")):
        a, b = times[fused]["ms"], times[flash]["ms"]
        log(f"forward crossover at DeiT's {name} shape {shape} bf16: #1 {a:.4f} ms, #3 (with "
            f"lse) {b:.4f} ms, #1/#3 {a / b:.2f}")
    # The backward crossover auto does not move either: #2 against #4 + #5
    # and against the whole flash backward (delta included).
    for name, shape, fused, flash in (("ViT-B/16@384 train", VIT384_SHAPE, "bwd_vit384",
                                       "flash_vit384"),
                                      ("DeiT train", TRAIN_SHAPE, "bwd_train", "flash_deit_train")):
        a = times[fused]["ms"]
        pair = times[flash]["dq"]["ms"] + times[flash]["dkv"]["ms"]
        whole = times[flash]["bwd_ms"]
        log(f"backward crossover at the {name} shape {shape} bf16: #2 {a:.4f} ms, #4 + #5 "
            f"{pair:.4f} ms, flash backward with delta {whole:.4f} ms, #2/(#4 + #5) "
            f"{a / pair:.2f}, #2/flash backward {a / whole:.2f}")
    return times


def _serve(engine, images, clients) -> list:
    results = [None] * len(images)
    errors = []

    def client(indices):
        try:
            futures = [(i, engine.submit(images[i])) for i in indices]
            for i, future in futures:
                results[i] = future.result(timeout=300)
        except Exception as e:  # noqa: BLE001 — reported by the caller
            errors.append(e)

    threads = [
        threading.Thread(target=client, args=(range(c, len(images), clients),))
        for c in range(clients)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if errors or any(t.is_alive() for t in threads):
        raise RuntimeError(f"serving failed: {errors or 'a client did not finish'}")
    return results


# Launch counters, as launch_counts() names them.
COUNTERS = ("fused", "fused_bwd", "talking_heads", "talking_heads_bwd",
            "talking_heads_bwd_dkv", "flash", "flash_dq", "flash_dkv", "rel", "rel_dq",
            "rel_dkv")


# The counters a plain (not talking-heads) attention core adds to in the
# forward and in the backward, by the kernel family it takes.
FAMILIES = {"fused": ("fused", ("fused_bwd",)), "flash": ("flash", ("flash_dq", "flash_dkv")),
            "rel": ("rel", ("rel_dq", "rel_dkv"))}


def attention_launches(model, *, train: bool, family) -> dict:
    """Kernel launches, by counter, that one forward (``train=False``) or one
    train step (``train=True``) of ``model`` in bf16 makes: one forward and,
    in training, one backward per attention module (``AttentionBlock``,
    BoTNet's ``BoTMHSA`` or CvT's ``CvTAttentionBlock``). Talking-heads cores
    take the talking-heads kernels; every other core takes ``family``, which
    each path states (DeiT, CaiT and CeiT at 224² the fused kernels,
    ViT-B/16@384 in training the flash ones, BoTNet the relative-position
    ones; for CvT-13 a ``{module-name prefix: family}`` dict, the first
    matching prefix deciding: stage 1 flash, the rest fused) rather than
    asks of the port's dispatch rule, so a change of that rule that moves a
    path to other kernels fails the run. With remat each encoder block's
    forward runs again in the backward pass."""
    from sav_tpu_torch.models.layers import AttentionBlock, BoTMHSA, CvTAttentionBlock

    counts = dict.fromkeys(COUNTERS, 0)
    encoder = getattr(model, "encoder", None)
    forwards = 2 if train and encoder is not None and encoder.remat else 1
    for name, m in model.named_modules():
        if not isinstance(m, (AttentionBlock, BoTMHSA, CvTAttentionBlock)):
            continue
        if getattr(m, "talking_heads", False):
            # In bf16 #10 is two kernels: dq, then dk/dv.
            fwd, bwd = "talking_heads", ("talking_heads_bwd", "talking_heads_bwd_dkv")
        elif isinstance(family, str):
            fwd, bwd = FAMILIES[family]
        else:
            fwd, bwd = FAMILIES[next(f for prefix, f in family.items()
                                     if name.startswith(prefix))]
        counts[fwd] += forwards
        for kind in bwd if train else ():
            counts[kind] += 1
    return counts


def _variant_launches(launches: dict) -> dict:
    """The launches of #1 (fused forward), #2 (fused backward), #3 (flash
    forward), #4 (flash dq), #5 (flash dk/dv), #6 (relative-position
    forward), #7 (its dq), #8 (its dk/dv), #9 (talking-heads forward) and
    #10 (its dq and dk/dv kernels) by the variant that ran, after a bf16 run
    whose counts are ``launches``; fails unless every one of them ran on the
    tensor cores."""
    return _on_tensor_cores(variant_counts(), launches, "bf16")


def _on_tensor_cores(variants: dict, launches: dict, what: str) -> dict:
    """``variants`` (launches by counter and variant), after checking that
    each counter's launches, ``launches``, all ran on the tensor cores."""
    from sav_tpu_torch.ops.flash_attention import TENSOR_CORE

    for kind, by_variant in variants.items():
        if by_variant[TENSOR_CORE] != launches[kind] or sum(by_variant.values()) != launches[kind]:
            raise AssertionError(f"{what} {kind} launches {launches[kind]} did not all run on "
                                 f"the tensor cores: {json.dumps(by_variant)}")
    return variants


def _times(per: dict, n: int) -> dict:
    return {k: v * n for k, v in per.items()}


def _nonzero(counts: dict) -> dict:
    """Launch counts (or counts by variant) without the kernels that did not
    run, for the log."""
    out = {}
    for k, v in counts.items():
        if isinstance(v, dict):
            if any(v.values()):
                out[k] = {var: n for var, n in v.items() if n}
        elif v:
            out[k] = v
    return out


def _draw_for_agreement(model) -> None:
    """The head at std 0.02 (DeiT's init for linear layers), every
    LayerScale scale in LAYERSCALE_DRAW and every zero-init bn3 scale in
    BN3_SCALE_DRAW, from one generator; then, for a model with BatchNorm,
    running statistics taken from one train-mode forward of CALIBRATION_IMAGES
    drawn uint8 images, normalised as the engine normalises its requests
    (momentum 0 for that pass). A zero head makes every logit
    0, CaiT's LayerScale init (1e-5) and BoTNet's zero bn3 scales scale every
    residual branch to (almost) nothing, and running statistics at their
    0/1 init would let a serving path that skipped them pass, so each would
    make an agreement check vacuous. Drawn statistics would not do: the eval
    forward then never renormalises, and swish shrinks the residual stream
    block by block to logits of ~1e-2; nor would statistics of images unlike
    the served ones, which blow the logits up to ~40."""
    from sav_tpu_torch.models.layers import BatchNorm, LayerScaleBlock

    gen = torch.Generator().manual_seed(1)
    norms = []
    with torch.no_grad():
        torch.nn.init.normal_(model.head.weight, std=0.02, generator=gen)
        for module in model.modules():
            if isinstance(module, LayerScaleBlock):
                torch.nn.init.uniform_(module.scale, *LAYERSCALE_DRAW, generator=gen)
            elif isinstance(module, BatchNorm):
                norms.append(module)
                if module.zero_scale:
                    torch.nn.init.uniform_(module.weight, *BN3_SCALE_DRAW, generator=gen)
        if norms:
            from sav_tpu_torch.ops.preprocess import normalize_images

            size = model.image_size
            images = normalize_images(torch.randint(
                0, 256, (CALIBRATION_IMAGES, size, size, 3), generator=gen, dtype=torch.uint8),
                torch.float32)
            training, momentum = model.training, [bn.momentum for bn in norms]
            for bn in norms:
                bn.momentum = 0.0
            model.train()(images)
            for bn, m in zip(norms, momentum):
                bn.momentum = m
            model.train(training)
            means = torch.cat([bn.running_mean for bn in norms])
            variances = torch.cat([bn.running_var for bn in norms])
            log(f"running statistics of {len(norms)} BatchNorms from {CALIBRATION_IMAGES} "
                f"drawn images: means {means.min().item():.3f}..{means.max().item():.3f}, "
                f"variances {variances.min().item():.4f}..{variances.max().item():.3f}")


# The KERNEL_GROUPS group each forward counter's kernels are named under.
FORWARD_GROUPS = {"fused": "attention forward (fused_attention.cu)",
                  "talking_heads": "talking-heads forward (talking_heads.cu)",
                  "flash": "flash forward (flash_attention.cu)",
                  "rel": "rel forward (rel_attention.cu)"}
# The KERNEL_GROUPS group each counter's kernels are named under.
COUNTER_GROUPS = {**FORWARD_GROUPS,
                  "fused_bwd": "attention backward (fused_attention_bwd.cu)",
                  "talking_heads_bwd": "talking-heads backward dq (talking_heads_bwd.cu)",
                  "talking_heads_bwd_dkv": "talking-heads backward dk/dv (talking_heads_bwd.cu)",
                  "flash_dq": "flash backward dq (flash_attention_bwd.cu)",
                  "flash_dkv": "flash backward dk/dv (flash_attention_bwd.cu)",
                  "rel_dq": "rel backward dq (rel_attention_bwd.cu)",
                  "rel_dkv": "rel backward dk/dv (rel_attention_bwd.cu)"}
# Buckets whose eager step, replayed step and replay device time are timed.
SERVE_TIMED_BUCKETS = (1, 8, 32)


def _check_served_eagerly_nowhere(what: str) -> None:
    """Serving moves no launch counter: every batch ran as a replay. Read
    after a run the counters were set to 0 for."""
    if any(launch_counts().values()):
        raise AssertionError(f"{what}: serving moved a launch counter "
                             f"({json.dumps(launch_counts())}): a batch ran eagerly")


def _check_capture(report: dict, per_batch: dict, what: str) -> dict:
    """An engine's ``startup_report``, read with the launch counters set
    to 0 just before the engine was built: every bucket's capture recorded
    one forward's launches (``per_batch``), all on the tensor cores by the
    variant tallies it recorded, and the counters moved by the warm-up's
    two eager forwards and the capture's one per bucket, nothing else (so,
    read after serving, serving moved none). Returns the startup's launches
    by variant (each on the tensor cores)."""
    captured = report["captured_launches"]
    if set(captured) != {str(b) for b in report["buckets"]} or any(
            n != per_batch for n in captured.values()):
        raise AssertionError(f"{what}: captured launches {json.dumps(captured)}, expected "
                             f"{json.dumps(per_batch)} in every bucket")
    for bucket, variants in report["captured_variants"].items():
        _on_tensor_cores(variants, captured[bucket], f"{what}: bucket {bucket}'s capture,")
    startup = launch_counts()
    expected = _times(per_batch, 3 * len(captured))
    if startup != expected:
        raise AssertionError(f"{what}: startup launched {json.dumps(startup)}, expected "
                             f"{json.dumps(expected)} (two warm-up forwards and one capture "
                             f"in each of {len(captured)} buckets)")
    return _variant_launches(startup)


def _replayed(stats: dict, report: dict, per_batch: dict, what: str) -> tuple:
    """The kernels' launches while an engine served, replays × captured,
    after checking that the replays are the batches served and that they
    come to ``per_batch`` × batches; and the same by variant, replays × each
    bucket's captured tallies (on the tensor cores)."""
    captured, replays = report["captured_launches"], stats["replays"]
    batches = stats["ledger"]["batches"]
    if sum(replays.values()) != batches:
        raise AssertionError(f"{what}: {json.dumps(replays)} replays for {batches} batches")
    launches = {k: sum(replays[b] * captured[b][k] for b in captured) for k in COUNTERS}
    if launches != _times(per_batch, batches):
        raise AssertionError(f"{what}: replays x captured {json.dumps(launches)}, expected "
                             f"{json.dumps(per_batch)} x {batches}")
    tallies = report["captured_variants"]
    variants = {k: {v: sum(replays[b] * tallies[b][k][v] for b in tallies)
                    for v in next(iter(tallies.values()))[k]} for k in COUNTERS}
    return launches, _on_tensor_cores(variants, launches, f"{what}: replayed")


def _add(runs) -> dict:
    """The sum of launch counts (or of launches by variant), key by key."""
    out = {}
    for run in runs:
        for k, n in run.items():
            if isinstance(n, dict):
                out[k] = _add([out.get(k, {}), n])
            else:
                out[k] = out.get(k, 0) + n
    return out


def _serve_batch(bucket: int, size: int, seed: int):
    """A seeded uint8 batch on the card and its validity mask (the last row
    padding where the bucket has more than one)."""
    gen = torch.Generator().manual_seed(seed)
    images = torch.randint(0, 256, (bucket, size, size, 3), generator=gen, dtype=torch.uint8)
    valid = torch.ones(bucket)
    if bucket > 1:
        valid[-1] = 0.0
    return images.cuda(), valid.cuda()


def _check_replay_equals_eager(engine, what: str) -> None:
    """At every bucket, the replayed logits equal the engine's eager infer
    function on the same batch, bit for bit."""
    size = engine.config.image_size
    for bucket in engine.startup_report["buckets"]:
        images, valid = _serve_batch(bucket, size, seed=bucket)
        eager = engine.infer_fn(images, valid).cpu()
        replayed = engine.graphs.replay(bucket, images, valid).cpu()
        if not torch.equal(eager, replayed):
            raise AssertionError(f"{what} bucket {bucket}: replayed logits differ from eager "
                                 f"ones by up to {(eager - replayed).abs().max().item():.3e}")
    log(f"{what}: replayed logits equal the eager infer function's, bit for bit, at buckets "
        f"{engine.startup_report['buckets']}")


# Host time between the two runs of a profiled session.
PROFILE_GAP_S = 0.05
# The marker between them: torch.cuda._sleep's spin kernel, ~0.5 ms.
PROFILE_MARKER = "spin_kernel"
PROFILE_MARKER_CYCLES = 1_000_000
# Sessions a profiled run may take before its check's failure stands.
PROFILE_SESSIONS = 3


def _device_events(run, check) -> tuple:
    """``(wall ms, check(device events))`` of one ``run()`` under
    torch.profiler. Late in a long process the profiler loses device events
    of a session (on the card, after ~800 s, a profiled replay of a train
    step missed its first ~47 kernels, block 0's #1 among them, in every
    session; in another run an eager ViT-B/16@384 step read 69 of its 96
    flash forwards): so ``run`` goes twice in one session, the device idle
    and then torch.cuda._sleep's kernel between them, and the events that
    start after that marker ends, the second run's, are read; its wall time
    is the second run's. A session whose events ``check`` rejects (it
    raises AssertionError or RuntimeError), or that lost the marker, is
    logged and profiled again, up to PROFILE_SESSIONS in all; the last
    one's error stands."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for session in range(1, PROFILE_SESSIONS + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
            torch.cuda._sleep(PROFILE_MARKER_CYCLES)
            torch.cuda.synchronize()
            time.sleep(PROFILE_GAP_S)
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        marks = [e for e in events if PROFILE_MARKER in e.name]
        try:
            if not marks:
                raise RuntimeError(f"the profiler recorded {len(events)} device events, none "
                                   f"of them the marker {PROFILE_MARKER}")
            after = max(e.time_range.end for e in marks)
            second = sorted((e for e in events if e.time_range.start >= after),
                            key=lambda e: e.time_range.start)
            if not second:
                raise RuntimeError(f"the profiler recorded no device event after the marker, "
                                   f"{len(events)} in all")
            return wall_ms, check(second)
        except (AssertionError, RuntimeError) as err:
            if session == PROFILE_SESSIONS:
                raise
            log(f"profiler session {session} of {PROFILE_SESSIONS} rejected, profiling again: "
                f"{err}")


def _profile_replay(engine, bucket: int, per_batch: dict, what: str) -> dict:
    """One replay of ``bucket`` under torch.profiler
    (:func:`_device_events`). Counted by the names KERNEL_GROUPS uses, the
    device's attention kernels must be one forward's (``per_batch``), and
    no other attention kernel may run. Returns the device busy time and the
    count by group."""
    images, valid = _serve_batch(bucket, engine.config.image_size, seed=0)
    engine.graphs.replay(bucket, images, valid)
    torch.cuda.synchronize()
    attention = [g for g, _ in KERNEL_GROUPS if g.endswith(".cu)")]
    want = {g: 0 for g in attention}
    for kind, n in per_batch.items():
        if n:
            want[FORWARD_GROUPS[kind]] += n

    def check(events):
        counts, busy = {}, 0.0
        for event in events:
            busy += event.time_range.elapsed_us() / 1e3
            group = next((g for g, keys in KERNEL_GROUPS if any(k in event.name for k in keys)),
                         "other")
            counts[group] = counts.get(group, 0) + 1
        if busy == 0.0:
            raise RuntimeError(f"{what}: the profiler recorded no device time in a replay")
        got = {g: counts.get(g, 0) for g in attention}
        if got != want:
            raise AssertionError(f"{what}: a profiled replay of bucket {bucket} ran the "
                                 f"attention kernels {json.dumps(got)}, expected "
                                 f"{json.dumps(want)}")
        return counts, busy, got

    _, (counts, busy, got) = _device_events(
        lambda: engine.graphs.replay(bucket, images, valid), check)
    log(f"{what}: a profiled replay of bucket {bucket} ran {sum(counts.values())} device "
        f"kernels and copies, busy {busy:.3f} ms; attention kernels "
        f"{json.dumps({g: n for g, n in got.items() if n})}; by group {json.dumps(counts)}")
    return {"busy_ms": busy, "kernels": counts}


def _host_median_ms(fn, iters=30, warmup=3) -> float:
    """Median host time of ``fn`` followed by a device synchronise."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _serve_steps(engine, buckets) -> dict:
    """At each bucket: the eager step (the infer function from Python) and
    the replayed step (copy into the static buffers and one graph launch),
    host time to a synchronise, median of 30; and the device time of one
    replay (CUDA events, L2 flushed, median of 30)."""
    out = {}
    for bucket in buckets:
        images, valid = _serve_batch(bucket, engine.config.image_size, seed=bucket)

        def replay(bucket=bucket, images=images, valid=valid):
            engine.graphs.replay(bucket, images, valid)

        out[str(bucket)] = {
            "eager_ms": _host_median_ms(lambda: engine.infer_fn(images, valid)),
            "replay_ms": _host_median_ms(replay),
            "replay_device_ms": _median_ms(replay),
        }
    return out


def _moe_blocks(model) -> list:
    from sav_tpu_torch.models.layers import MoEFFBlock

    return [m for m in model.modules() if isinstance(m, MoEFFBlock)]


def _moe_block_inputs(model, images) -> list:
    """``[(block, its input)]`` for each MoE block of one no-grad forward of
    ``model`` on ``images``, in the model's mode (a model with BatchNorm
    would move its running statistics in train mode: call it only for a
    model with MoE blocks)."""
    blocks = _moe_blocks(model)
    seen = []
    hooks = [b.register_forward_pre_hook(lambda m, args: seen.append(args[0].detach().clone()))
             for b in blocks]
    try:
        with torch.no_grad():
            model(images)
    finally:
        for hook in hooks:
            hook.remove()
    return list(zip(blocks, seen))


def routing_differences(model, other, images) -> dict:
    """How the MoE blocks of ``model`` and ``other`` (the same weights, other
    attention paths) route the tokens of ``images``, each block's own input
    through its router: ``assignments``, the (token, choice) pairs in all;
    ``experts_differ``, those given another expert; ``kept_differ``, those
    kept on one side and dropped on the other (a kept choice's position in
    its expert's buffer does not change what it computes); ``cls_rows``,
    rows whose CLS token differs in either way in some block; ``dropped``,
    the choices ``model`` drops. None for a model without MoE blocks, which
    runs no forward."""
    if not _moe_blocks(model):
        return None
    ours = _moe_block_inputs(model, images)
    theirs = _moe_block_inputs(other, images)
    out = dict.fromkeys(("assignments", "experts_differ", "kept_differ", "dropped"), 0)
    cls_rows = torch.zeros(images.shape[0], dtype=torch.bool, device=images.device)
    with torch.no_grad():
        for (block, x), (_, y) in zip(ours, theirs):
            spare = block.num_experts * block.capacity(x.shape[1])
            _, _, experts, slots = block.route(x)
            _, _, other_experts, other_slots = block.route(y)
            differ = (experts != other_experts) | ((slots == spare) != (other_slots == spare))
            out["assignments"] += slots.numel()
            out["experts_differ"] += int((experts != other_experts).sum())
            out["kept_differ"] += int(((slots == spare) != (other_slots == spare)).sum())
            out["dropped"] += int((slots == spare).sum())
            cls_rows |= differ[:, 0].any(dim=-1)
    out["cls_rows"] = int(cls_rows.sum())
    return out


def phase_moe_routing(device="cuda") -> dict:
    """The MoE routing on the card at the train cell's shape (TRAIN_BATCH
    rows of 197 tokens, vit_moe_s_patch16_e8's block 1: 8 experts, top 2,
    62 slots): a zero router's tie picks experts 0 and 1 in token order,
    the first 62 tokens kept; the card's assignment of its router
    probabilities equals the CPU's assignment of the same probabilities,
    every expert, slot and kept or dropped choice; the card's probabilities
    are the CPU's softmax of the same logits within f32 rounding; and the
    block's backward run twice (bf16 input, both sown losses in the loss)
    gives the same bits."""
    from sav_tpu_torch import create_model
    from sav_tpu_torch.models.layers import sow_losses
    from sav_tpu_torch.models.layers.moe import assign, route

    block = create_model(MOE_MODEL, seed=0).encoder.blocks[1].ff.to(device).train()
    g, s, d = TRAIN_BATCH, 197, block.router.shape[0]
    e, k, c = block.num_experts, block.top_k, block.capacity(s)
    spare = e * c
    tokens = torch.arange(s, device=device)
    _, gates, experts, slots = route(torch.zeros(g, s, e, device=device), k, c)
    want = torch.stack([torch.where(tokens < c, tokens + i * c, spare) for i in range(k)], -1)
    if not (torch.equal(experts, torch.arange(k, device=device).expand(g, s, k))
            and torch.equal(slots, want.expand(g, s, k))):
        raise AssertionError("moe routing: a zero router's tie did not pick experts 0 and 1 "
                             "in token order")
    gen = torch.Generator(device=device).manual_seed(7)
    x = torch.randn(g, s, d, generator=gen, device=device).bfloat16()
    logits = block.router_logits(x)
    probs = torch.softmax(logits, dim=-1)
    card = assign(probs, k, c)
    host = assign(probs.cpu(), k, c)
    for name, got, ref in zip(("gates", "experts", "slots"), card, host):
        if not torch.equal(got.cpu(), ref):
            raise AssertionError(f"moe routing: the card's {name} differ from the CPU's at "
                                 f"{int((got.cpu() != ref).sum())} of {ref.numel()} entries")
    softmax_err = (probs.cpu() - torch.softmax(logits.cpu(), dim=-1)).abs().max().item()
    if softmax_err > 1e-6:
        raise AssertionError(f"moe routing: the card's softmax is {softmax_err:.3e} off the CPU's")
    dropped = int((card[2] == spare).sum())
    runs = []
    for _ in range(2):
        block.zero_grad()
        xg = x.clone().requires_grad_()
        with sow_losses(block) as sown:
            y = block(xg)
        ((y.float() ** 2).sum() + sum(sown)).backward()
        runs.append([xg.grad, *(p.grad.clone() for p in block.parameters())])
    if not all(torch.equal(a, b) for a, b in zip(*runs)):
        raise AssertionError("moe routing: two backward runs of the MoE block differ")
    result = {"shape": [g, s, d], "experts": e, "top_k": k, "capacity": c,
              "dropped": dropped, "assignments": g * s * k, "softmax_max_abs_err": softmax_err}
    log(f"moe routing on the card: a zero router picks experts 0 and 1 in token order, "
        f"{c} of {s} kept; the card's assignment of its router probabilities equals the "
        f"CPU's (experts, slots, gates; {dropped} of {g * s * k} choices dropped); softmax "
        f"{softmax_err:.3e} off the CPU's; two backward runs bit-equal: {json.dumps(result)}")
    return result


def _serve_routing(model, dense, requests, image_size, what):
    """For a model with MoE blocks, :func:`routing_differences` of the bf16
    kernel path and the bf16 dense path on the 8 rows the serve agreement
    compares (the same seeded images, normalised as the engine normalises
    them), eagerly on copies; None for a model without."""
    import copy

    from sav_tpu_torch.models.layers import cast_for_compute
    from sav_tpu_torch.ops.preprocess import normalize_images

    if not _moe_blocks(model):
        return None
    images = np.random.default_rng(0).integers(
        0, 256, (requests, image_size, image_size, 3), dtype=np.uint8)[:8]
    images = normalize_images(torch.from_numpy(images).cuda(), torch.bfloat16)
    ours, theirs = (cast_for_compute(copy.deepcopy(m).cuda(), torch.bfloat16).eval()
                    for m in (model, dense))
    routing = routing_differences(ours, theirs, images)
    log(f"{what}: kernel vs dense path routing on the 8 compared rows, bf16: "
        f"{json.dumps(routing)}")
    return routing


def phase_serve(device="cuda", model_name="deit_s_patch16", requests=SERVE_REQUESTS,
                max_batch=32, overrides=None, image_size=224, family="fused",
                reference="dense") -> dict:
    """Serve ``requests`` seeded images through captured programs; returns
    the kernels' launches (replays × captured). ``family``: the kernels this
    path's plain attention cores take (at 224² DeiT's and CaiT's class
    attention the fused ones, BoTNet the relative-position ones).
    ``reference``: what the served logits are held against, the same
    weights served on the dense attention paths (``"dense"``), or, for a
    model without attention, served in f32 (``"f32"``)."""
    from sav_tpu_torch import ServeConfig, ServeEngine, create_model

    overrides = overrides or {}
    model = create_model(model_name, image_size=image_size, seed=0, **overrides)
    _draw_for_agreement(model)
    dense = create_model(
        model_name, image_size=image_size, backend="xla", logits_dtype=torch.float32, **overrides
    )
    dense.load_state_dict(model.state_dict())
    per_batch = attention_launches(model, train=False, family=family)
    what = f"serve {model_name}"
    routing = _serve_routing(model, dense, requests, image_size, what)

    def config(**kw):
        # A generous deadline: admission must not shed in a smoke run.
        return ServeConfig(**{**dict(model_name=model_name, image_size=image_size,
                                     compute_dtype="bfloat16", deadline_ms=5000.0,
                                     device=device), **kw})

    images = np.random.default_rng(0).integers(
        0, 256, (requests, image_size, image_size, 3), dtype=np.uint8
    )
    reset_launches()
    engine = ServeEngine(config(max_batch=max_batch), model=model)
    startup_variants = _check_capture(engine.startup_report, per_batch, what)
    report = engine.startup_report
    log(f"{what} startup: {json.dumps(report)}")
    reset_launches()
    with engine:
        logits = np.stack(_serve(engine, images, CLIENTS))
    _check_served_eagerly_nowhere(what)
    stats = engine.stats()
    ledger = stats["ledger"]
    if stats["errors"] or ledger["requests"] != requests:
        raise AssertionError(f"serving incomplete: {json.dumps(stats)}")
    if logits.shape != (requests, model.head.out_features) or not np.isfinite(logits).all():
        raise AssertionError(f"bad logits: shape {logits.shape}, finite {np.isfinite(logits).all()}")
    launches, variants = _replayed(stats, report, per_batch, what)
    batches = ledger["batches"]
    log(
        f"{what} bf16: {requests} requests from {CLIENTS} clients in {batches} batches "
        f"{json.dumps(ledger['bucket_occupancy'])}, replays {json.dumps(stats['replays'])}; "
        f"kernel launches (replays x captured) {json.dumps(launches)} = "
        f"{json.dumps(per_batch)} x {batches}; startup launches by variant "
        f"{json.dumps(startup_variants)}; p50 {ledger['latency_ms']['p50']} ms, "
        f"p99 {ledger['latency_ms']['p99']} ms, {ledger['throughput_rps']} images/s"
    )
    _check_replay_equals_eager(engine, what)
    profile = _profile_replay(engine, max(report["buckets"]), per_batch, what)
    steps = _serve_steps(engine, SERVE_TIMED_BUCKETS)
    log(f"{what} steps by bucket (ms): {json.dumps(steps)}")
    del engine
    _release_engines()

    reset_launches()
    ref_config = (config(max_batch=8, attention_backend="xla") if reference == "dense"
                  else config(max_batch=8, compute_dtype="float32"))
    ref_engine = ServeEngine(ref_config, model=dense)
    _check_capture(ref_engine.startup_report, dict.fromkeys(COUNTERS, 0), f"{what} {reference}")
    with ref_engine:
        ref = np.stack(_serve(ref_engine, images[:8], 1))
    if any(launch_counts().values()) or sum(ref_engine.stats()["replays"].values()) == 0:
        raise AssertionError(f"the {reference} reference engine launched a kernel or replayed "
                             "nothing")
    err = _within(torch.from_numpy(logits[:8]), torch.from_numpy(ref), SERVE_TOL)
    against = ("kernels vs dense attention (f32 softmax), both replayed" if reference == "dense"
               else "no attention: bf16 vs the same weights served in f32, both replayed")
    log(
        f"serve agreement {model_name}, {against}, 8 rows: max abs err {err:.3e} (tol "
        f"{SERVE_TOL}), logits max |x| {np.abs(ref).max():.3f}, std {ref.std():.3f}"
        + ("" if routing is None else f"; routing differences {json.dumps(routing)}")
    )
    del ref_engine
    _release_engines()
    return {**launches, "variants": variants, "per_batch": per_batch, "routing": routing,
            "steps": steps, "profile": profile, "compile_s": report["compile_s"],
            "bucket_hbm_bytes": report["bucket_hbm_bytes"]}


# The serve bench's runs: a flood, an open-loop arm at half the flood's
# measured throughput, and for DeiT-S the no-batching arm.
BENCH_REQUESTS = 2048
BENCH_BATCH1_REQUESTS = 512
# The open-loop arm's deadline: the engine's default. The flood's is long
# enough that admission sheds nothing while 2,048 requests wait.
BENCH_DEADLINE_MS = 100.0
FLOOD_DEADLINE_MS = 60_000.0


def _release_engines() -> None:
    """Free the serve engines built so far. An engine and its feeder refer
    to each other, so their device memory (weights, static buffers, the
    graphs' pool) goes only with a collection; and once no engine holds a
    stream, no graph is left that kept a cuBLAS workspace, so the
    workspaces of their streams go too. Neither may count in a later
    engine's or the train phases' peak memory."""
    import gc

    from sav_tpu_torch.utils.graphs import streams_held

    gc.collect()
    if streams_held():
        raise AssertionError(f"{streams_held()} streams still held: a serve engine outlived "
                             "its phase")
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()


def _free_device_memory() -> None:
    """Collect what earlier phases left, and with no stream held by a live
    engine or trainer, the cuBLAS workspaces of their streams too: a train
    phase's peak memory counts none of it."""
    from sav_tpu_torch.utils.graphs import streams_held

    gc.collect()
    if not streams_held():
        torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()


def _bench(argv: list, per_batch: dict, what: str) -> dict:
    """One run of ``python -m sav_tpu_torch.serve.bench`` (through its
    ``run``), checked: every request offered was served, the startup's
    captures and the replays as in phase_serve."""
    from sav_tpu_torch.serve import bench

    reset_launches()
    out = bench.run(bench.parser().parse_args(argv))
    _release_engines()
    if out["outcome"] != "ok" or out["requests"] != out["offered"]:
        raise AssertionError(f"{what}: {json.dumps(out)}")
    # Read after serving: the startup's launches, and none while serving.
    _check_capture(out["startup"], per_batch, what)
    launches, variants = _replayed({"replays": out["replays"], "ledger": out["summary"]},
                                   out["startup"], per_batch, what)
    log(f"{what}: {out['serve_throughput']} images/s, p50 {out['p50_latency_ms']} ms, p95 "
        f"{out['p95_latency_ms']} ms, p99 {out['p99_latency_ms']} ms, occupancy "
        f"{json.dumps(out['bucket_occupancy'])}, padding waste {out['padding_waste_frac']}, "
        f"queue depth avg {out['queue_depth_avg']} max {out['queue_depth_max']}, schedule lag "
        f"{out['schedule_lag_ms']} ms, rejected {out['rejected_at_submit']}, startup "
        f"{out['startup']['startup_s']} s (capture {out['startup']['compile_s']} s); feeder "
        f"{json.dumps(out['feeder'])}")
    return {"result": out, "launches": launches, "variants": variants}


def phase_serve_bench(model_name: str, per_batch: dict, *, batch_1=False) -> dict:
    """``sav_tpu_torch.serve.bench`` on the card at buckets 1…32: a flood of
    BENCH_REQUESTS, then an open loop at half the flood's throughput; with
    ``batch_1``, also the ladder [1] arm of BENCH_BATCH1_REQUESTS, which the
    batched flood must beat in images/s."""
    common = ["--model", model_name, "--max-batch", "32", "--max-queue", "4096"]
    runs = {"flood": _bench(common + ["--requests", str(BENCH_REQUESTS), "--deadline-ms",
                                      str(FLOOD_DEADLINE_MS)], per_batch, f"bench {model_name} flood")}
    rate = round(runs["flood"]["result"]["serve_throughput"] / 2, 1)
    runs["open_loop"] = _bench(common + ["--requests", str(BENCH_REQUESTS), "--rate", str(rate),
                                         "--deadline-ms", str(BENCH_DEADLINE_MS)],
                               per_batch, f"bench {model_name} open loop at {rate} req/s")
    if batch_1:
        runs["batch_1"] = _bench(common + ["--batch-1", "--requests", str(BENCH_BATCH1_REQUESTS),
                                           "--deadline-ms", str(FLOOD_DEADLINE_MS)],
                                 per_batch, f"bench {model_name} batch-1 flood")
        batched = runs["flood"]["result"]["serve_throughput"]
        single = runs["batch_1"]["result"]["serve_throughput"]
        if not batched > single:
            raise AssertionError(f"bench {model_name}: the batched flood ({batched} images/s) "
                                 f"did not beat the batch-1 arm ({single} images/s)")
    launches = _add(r["launches"] for r in runs.values())
    keys = ("serve_throughput", "p50_latency_ms", "p95_latency_ms", "p99_latency_ms",
            "padding_waste_frac", "bucket_occupancy", "rejected_at_submit", "schedule_lag_ms")
    return {**launches, "variants": _add(r["variants"] for r in runs.values()), "rate": rate,
            "runs": {name: {k: r["result"][k] for k in keys} for name, r in runs.items()}}


# Raw decoded images of mixed sizes for submit_raw (height, width).
RAW_SHAPES = ((300, 451), (97, 131), (224, 224), (480, 360), (131, 97), (256, 700))


# Requests each of the two checkpoint engines serves at once: 16 batches of
# 6, so their device loops replay side by side.
CONCURRENT_REQUESTS = 96


def phase_serve_checkpoint(directory: str, per_batch: dict, device="cuda") -> dict:
    """DeiT-S served from the checkpoint directory phase_resume wrote,
    through ``checkpoint_dir`` (params-only restore), and at the same time
    by an engine given the restored model directly, each from its own
    client: the two engines hold six distinct streams and their logits are
    equal, bit for bit (graphs sharing a cuBLAS workspace would race). Then
    raw images of mixed sizes through ``submit_raw`` equal
    ``preprocess_request`` + ``submit``. Bucket 6: every batch here is full,
    so none waits out its deadline, and both sides run the same graph at
    the same rows."""
    from concurrent.futures import ThreadPoolExecutor

    from sav_tpu_torch import ServeConfig, ServeEngine, create_model
    from sav_tpu_torch.serve.preprocess import preprocess_request
    from sav_tpu_torch.train import Checkpointer

    def config(**kw):
        return ServeConfig(model_name="deit_s_patch16", compute_dtype="bfloat16", buckets=[6],
                           deadline_ms=5000.0, device=device, **kw)

    what = "serve deit_s_patch16 from a checkpoint"
    reset_launches()
    served = ServeEngine(config(checkpoint_dir=directory))
    _check_capture(served.startup_report, per_batch, what)
    report = served.startup_report
    if report["params_source"] != f"checkpoint:{directory}":
        raise AssertionError(f"{what}: params_source {report['params_source']!r}")
    raw = Checkpointer(directory, read_only=True).restore_raw()
    model = create_model("deit_s_patch16", seed=1)  # another seed: a missed restore shows
    model.load_state_dict({**raw["params"], **raw["batch_stats"]}, strict=True)
    reset_launches()
    direct = ServeEngine(config(), model=model)
    _check_capture(direct.startup_report, per_batch, f"{what}: the restored model")
    streams = [s.cuda_stream for e in (served, direct)
               for s in (e._feed_stream, e._compute_stream, e.graphs.stream)]
    if len(set(streams)) != len(streams):
        raise AssertionError(f"{what}: two live engines share a stream: {streams}")
    rng = np.random.default_rng(3)
    images = rng.integers(0, 256, (CONCURRENT_REQUESTS, 224, 224, 3), dtype=np.uint8)
    raws = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in RAW_SHAPES]
    reset_launches()
    with served, direct, ThreadPoolExecutor(2) as clients:
        both = [clients.submit(_serve, engine, images, 1) for engine in (served, direct)]
        got, want = (np.stack(f.result(timeout=600)) for f in both)
        from_raw = np.stack([f.result(timeout=300) for f in [served.submit_raw(r) for r in raws]])
        prepared = np.stack([f.result(timeout=300) for f in
                             [served.submit(preprocess_request(r, 224)) for r in raws]])
    _check_served_eagerly_nowhere(what)
    runs = [_replayed(e.stats(), e.startup_report, per_batch, f"{what}: {name}")
            for name, e in (("served", served), ("restored", direct))]
    launches, variants = _add(r[0] for r in runs), _add(r[1] for r in runs)
    del served, direct
    if not np.array_equal(got, want):
        raise AssertionError(f"{what}: logits differ from the restored model's by up to "
                             f"{np.abs(got - want).max():.3e}")
    if not np.array_equal(from_raw, prepared):
        raise AssertionError(f"{what}: submit_raw differs from preprocess_request + submit by "
                             f"up to {np.abs(from_raw - prepared).max():.3e}")
    if not (np.isfinite(got).all() and np.isfinite(from_raw).all()):
        raise AssertionError(f"{what}: non-finite logits")
    log(f"{what} (step {raw['step']}, {report['params_source']}): {CONCURRENT_REQUESTS} logits "
        f"rows, served at the same time as by an engine given the restored model (streams "
        f"{streams}), equal its rows bit for bit; {len(raws)} raw images {list(RAW_SHAPES)} "
        f"through submit_raw equal preprocess_request + submit bit for bit; launches (replays "
        f"x captured) {json.dumps({k: n for k, n in launches.items() if n})}, by variant "
        f"{json.dumps({k: v for k, v in variants.items() if launches[k]})}")
    return {**launches, "variants": variants, "step": raw["step"]}


def _train_common(model_name, batch_size, steps, image_size, num_classes, overrides) -> dict:
    return dict(
        model_name=model_name, num_classes=num_classes, image_size=image_size,
        compute_dtype="bfloat16", global_batch_size=batch_size,
        num_train_images=batch_size * steps, num_epochs=300, warmup_epochs=0,
        base_lr=2e-3, transpose_images=False, log_every_steps=steps // 2, seed=0,
        model_overrides=overrides or None,
    )


def _train_batches(batch_size, image_size, num_classes, device, num_batches) -> list:
    """``num_batches`` batches of the port's synthetic data
    (``data/synthetic.py``: standard-normal NHWC images, the class id added
    as a brightness offset), drawn on ``device`` by a generator seeded 0.
    numpy draws 256 images at 224² in ~1 s on one host core: at the
    recipes' global batches (up to 4096) tens of seconds a train phase."""
    generator = torch.Generator(device=device).manual_seed(0)
    batches = []
    for _ in range(num_batches):
        labels = torch.randint(0, num_classes, (batch_size,), generator=generator,
                               device=device, dtype=torch.int32)
        images = torch.randn((batch_size, image_size, image_size, 3), generator=generator,
                             device=device)
        images += (labels[:, None, None, None] / num_classes - 0.5) * 4.0
        batches.append({"images": images, "labels": labels})
    return batches


# Steps of the captured-equals-eager check in each train cell.
EQUAL_STEPS = 3
# The metrics a train step returns, in the order they are compared.
TRAIN_METRICS = ("loss", "top_1_acc", "top_5_acc", "learning_rate", "grad_norm", "aux_loss")


def _snapshot(trainer, state) -> dict:
    """Device copies of every tensor a train step updates in place, and the
    states of the trainer's generators."""
    with torch.no_grad():
        tensors = [t.detach().clone() for t in trainer._state_tensors(state)]
    return {"tensors": tensors,
            "generators": {k: g.get_state() for k, g in trainer.generators.items()}}


def _restore(trainer, state, snap) -> None:
    """Put ``snap`` back into the state's own tensors, in place (so the
    captured graphs stay bound to them), and into the generators."""
    with torch.no_grad():
        for live, saved in zip(trainer._state_tensors(state), snap["tensors"]):
            live.copy_(saved)
    for name, generator in trainer.generators.items():
        generator.set_state(snap["generators"][name])
    torch.cuda.synchronize()


def _check_train_capture(trainer, per_step: dict, counters: dict, what: str, *,
                         kind="train") -> dict:
    """A trainer's captured ``kind`` step, read with the launch counters set
    to 0 just before the run that captured it: one signature, whose capture
    recorded ``per_step`` launches, all on the tensor cores, and counters
    moved by the two eager warm-ups and the capture, nothing else (every
    step ran as a replay). Returns the graphs' summary."""
    graphs = trainer.train_graphs if kind == "train" else trainer.eval_graphs
    summary = graphs.summary()
    if summary["signatures"] != 1 or summary["captured_launches"] != per_step:
        raise AssertionError(f"{what}: captured {json.dumps(summary)}, expected one signature "
                             f"of {json.dumps(per_step)}")
    _on_tensor_cores(summary["captured_variants"], per_step, f"{what}: the capture,")
    expected = _times(per_step, 3)
    if counters != expected:
        raise AssertionError(f"{what}: the counters moved {json.dumps(counters)}, expected "
                             f"{json.dumps(expected)} (two warm-ups and one capture)")
    return summary


def _replay_launches(trainer, what: str, *, kind="train") -> tuple:
    """The launches the replays of a trainer's ``kind`` step ran (replays ×
    captured) and the same by variant, on the tensor cores."""
    graphs = trainer.train_graphs if kind == "train" else trainer.eval_graphs
    launches = {k: graphs.total_launches().get(k, 0) for k in COUNTERS}
    variants = graphs.total_variants()
    return launches, _on_tensor_cores({k: variants[k] for k in COUNTERS}, launches,
                                      f"{what}: replayed")


def _captured_equals_eager(trainer, state, start: dict, batches: list, what: str, *,
                           recaptures: int = 0) -> dict:
    """EQUAL_STEPS captured steps (``train_step``: replays) and
    EQUAL_STEPS calls of ``_train_step_impl`` (eager), each from ``start``
    and on the same batches: the same metrics, and after them every
    parameter, buffer (the BatchNorm statistics), Adam moment, EMA, count
    and generator state, bit for bit; the trainer has captured again
    ``recaptures`` times by then. Returns the BatchNorm statistics after
    the first captured step and the captured run's metrics."""
    runs = {}
    first_stats = {}
    for name, step in (("captured", trainer.train_step), ("eager", trainer._train_step_impl)):
        _restore(trainer, state, start)
        s, metrics = state, []
        for i, batch in enumerate(batches[:EQUAL_STEPS]):
            s, m = step(s, batch)
            metrics.append(torch.stack([m[k].float() for k in TRAIN_METRICS]).cpu())
            if i == 0 and name == "captured":
                first_stats = {k: v.clone() for k, v in s.batch_stats.items()}
        runs[name] = {"metrics": torch.stack(metrics), "state": _host_tree(s.state_dict())}
    differ = _tree_differences(runs["captured"]["state"], runs["eager"]["state"])
    if not torch.equal(runs["captured"]["metrics"], runs["eager"]["metrics"]):
        differ.append("metrics")
    if differ or trainer.recaptures != recaptures:
        raise AssertionError(f"{what}: {EQUAL_STEPS} captured steps differ from as many eager "
                             f"ones at {len(differ)} entries ({differ[:6]}); recaptures "
                             f"{trainer.recaptures}")
    state_dict = runs["eager"]["state"]
    log(f"{what}: {EQUAL_STEPS} captured steps equal {EQUAL_STEPS} eager _train_step_impl "
        f"steps bit for bit (metrics {runs['eager']['metrics'][:, 0].tolist()} losses; "
        f"{len(state_dict['params'])} parameters, {len(state_dict['batch_stats'])} buffers, "
        f"moments{', EMA' if 'ema' in state_dict['opt_state'] else ''}, count "
        f"{state_dict['opt_state']['count']}, generators {sorted(state_dict['generators'])})")
    return {"first_stats": first_stats, "metrics": runs["captured"]["metrics"]}


def phase_train(device="cuda", model_name="deit_s_patch16", batch_size=TRAIN_BATCH,
                steps=TRAIN_STEPS, image_size=224, num_classes=1000, overrides=None,
                state_dict=None, family="fused", grad_accum=1, config=None,
                warm_start=None, reference="dense") -> dict:
    """Train ``steps`` steps through Trainer.fit from seed-0 weights (or from
    ``state_dict``, or through ``Trainer.warm_start_from`` a directory,
    ``warm_start = (directory, expected state dict)``: every tensor must come
    out bit-equal to the expected one, none kept fresh), at global
    ``batch_size`` in ``grad_accum`` micro-batches: on the card fit replays
    the step captured at its first step. Then, from the same start,
    EQUAL_STEPS captured steps must equal as many eager ones bit for bit,
    and fit runs once more with the eager step for the comparison; one step
    of each is profiled. Returns the launches (replays × captured), the
    first loss, both fits' step times, peak memories and profiles. ``config``
    replaces the smoke run's recipe (a preset's TrainConfig). The first step
    is held against the same step on the dense attention paths
    (``reference="dense"``) or, for a model without attention, in f32
    (``"f32"``)."""
    from sav_tpu_torch import TrainConfig, Trainer, create_model

    _free_device_memory()
    overrides = overrides or {}
    model = create_model(model_name, num_classes=num_classes, image_size=image_size,
                         seed=0, **overrides)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    elif warm_start is None:
        # A zero head passes no gradient to the attention cores in the first step.
        _draw_for_agreement(model)
    if config is None:
        config = TrainConfig(**_train_common(model_name, batch_size, steps, image_size,
                                             num_classes, overrides))
    config = dataclasses.replace(config, grad_accum_steps=grad_accum)
    trainer = Trainer(config, model=model, device=device)
    if warm_start is not None:
        directory, expected = warm_start
        t0 = time.perf_counter()
        state = trainer.warm_start_from(directory)
        warm_s = time.perf_counter() - t0
        got = state.model.state_dict()
        differ = [k for k, v in expected.items() if not torch.equal(got[k].cpu(), v)]
        if set(got) != set(expected) or differ or trainer.last_warm_start["fresh"]:
            raise AssertionError(f"warm start from {directory}: {trainer.last_warm_start}, "
                                 f"tensors not equal to the surgery's: {differ}")
        log(f"warm start {model_name} from {directory} in {warm_s:.2f} s: "
            f"{json.dumps(trainer.last_warm_start)}, every tensor bit-equal to phase_surgery's")
    else:
        state = trainer.init_state()
    dense = create_model(model_name, num_classes=num_classes, image_size=image_size,
                         backend="xla", logits_dtype=torch.float32, **overrides)
    dense.load_state_dict(model.state_dict())
    per_step = _times(attention_launches(model, train=True, family=family), grad_accum)
    batches = _train_batches(batch_size, image_size, num_classes, device, TRAIN_DISTINCT_BATCHES)
    what = f"train {model_name}"

    # The same first step on the dense attention paths with f32 softmax (or,
    # without attention, in f32), eagerly; the stochastic-depth masks come
    # from a generator seeded from config.seed on both sides, drawn in the
    # same order, so they are the same masks.
    ref_trainer = Trainer(
        dataclasses.replace(config, attention_backend="xla", attention_logits_dtype="float32")
        if reference == "dense" else dataclasses.replace(config, compute_dtype="float32"),
        model=dense, device=device,
    )
    # Where the kernel path and the dense path route the first batch's
    # tokens differently (MoE blocks only), from the same start.
    routing = routing_differences(
        trainer.model.train(), ref_trainer.model.train(),
        batches[0]["images"][:batch_size // grad_accum].to(trainer.compute_dtype))
    if routing is not None:
        log(f"{what}: kernel vs dense path routing of step 1's first micro-batch: "
            f"{json.dumps(routing)}")
    reset_launches()
    ref_state, ref_metrics = ref_trainer._train_step_impl(ref_trainer.init_state(), batches[0])
    ref = {k: float(v) for k, v in ref_metrics.items()}
    ref_stats = {k: v.clone() for k, v in ref_state.batch_stats.items()}
    if any(launch_counts().values()):
        raise AssertionError("the dense reference trainer launched a kernel")
    del ref_trainer, ref_state, dense, ref_metrics
    torch.cuda.empty_cache()

    start, start_state = _snapshot(trainer, state), state
    runs = {}
    for mode in ("captured", "eager"):
        state = start_state
        _restore(trainer, state, start)
        if mode == "eager":
            # fit's step taken eagerly, for the comparison only.
            def eager_step(state, placed):
                trainer._await(placed)
                return trainer._train_step_impl(state, placed)

            trainer.train_step_placed = eager_step
        torch.cuda.reset_peak_memory_stats()
        windows = []
        reset_launches()
        state, history = trainer.fit(iter(batches * (steps // len(batches))), num_steps=steps,
                                     state=state, log_fn=windows.append)
        counters = launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        losses = [r["loss"] for r in history]
        if len(history) != steps or not np.isfinite(losses).all():
            raise AssertionError(f"{what} ({mode}): losses not all finite over {steps} steps: "
                                 f"{losses}")
        n = len(batches)
        if not all(losses[i + n] < losses[i] for i in range(steps - n)):
            raise AssertionError(f"{what} ({mode}): the loss did not fall on a batch seen "
                                 f"again: {losses}")
        if mode == "captured":
            capture = _check_train_capture(trainer, per_step, counters, what)
            launches, variants = _replay_launches(trainer, what)
            if capture["replays"] != steps or launches != _times(per_step, steps):
                raise AssertionError(f"{what}: {capture['replays']} replays, launches "
                                     f"{json.dumps(launches)}; expected {steps} x "
                                     f"{json.dumps(per_step)}")
            for record in history:
                log(f"{what} step {record['step']}: " + json.dumps(
                    {k: round(v, 6) for k, v in record.items() if k != "step"}))
            first = history[0]
        else:
            del trainer.train_step_placed
            if counters != _times(per_step, steps):
                raise AssertionError(f"{what} (eager): launched {json.dumps(counters)}, "
                                     f"expected {steps} x {json.dumps(per_step)}")
            if losses != [r["loss"] for r in runs["captured"]["history"]]:
                raise AssertionError(f"{what}: eager fit's losses {losses} differ from the "
                                     f"captured fit's")
        profile = profile_step(trainer, state, batches[0], per_step, eager=mode == "eager")
        steady = windows[-1]
        runs[mode] = {"history": history, "step_ms": steady["step_s"] * 1e3,
                      "images_per_sec": steady["images_per_sec"], "peak_gb": peak_gb,
                      "profile": profile, "first_window_ms": windows[0]["step_s"] * 1e3}
    sides = ("kernels", "dense") if reference == "dense" else ("bf16", "f32 (no attention)")
    for key, tol in TRAIN_REL_TOL.items():
        rel = abs(first[key] - ref[key]) / abs(ref[key])
        log(f"train step 1 {model_name} {key}: {sides[0]} {first[key]:.6f}, {sides[1]} "
            f"{ref[key]:.6f}, relative difference {rel:.3e} (tol {tol})")
        if rel > tol:
            raise AssertionError(f"train step 1 {key} disagrees with the {reference} step")
    equal = _captured_equals_eager(trainer, start_state, start, batches, what)
    if ref_stats:
        # Each running statistic after step 1, relative to its largest entry.
        first_stats = equal["first_stats"]
        worst = max(((first_stats[k] - v).abs().max().item() / v.abs().max().item(), k)
                    for k, v in ref_stats.items())
        log(f"train step 1 {model_name} running statistics ({len(ref_stats)} tensors): largest "
            f"difference from the dense path {worst[0]:.3e} of the tensor's largest entry, at "
            f"{worst[1]} (tol {BATCH_STATS_REL_TOL})")
        if worst[0] > BATCH_STATS_REL_TOL:
            raise AssertionError("train step 1 running statistics disagree with the dense path")
    cap, eag = runs["captured"], runs["eager"]
    log(
        f"train {model_name} bf16 batch {batch_size} ({grad_accum} x {batch_size // grad_accum}): "
        f"{steps} steps via fit(), losses "
        f"{[round(r['loss'], 4) for r in cap['history']]}; capture {capture['capture_s']:.2f} s "
        f"(warm-ups included) of {json.dumps(_nonzero(per_step))} per step, replays x captured "
        f"{json.dumps(_nonzero(launches))}, by variant {json.dumps(_nonzero(variants))}; steady "
        f"window (steps "
        f"{steps - steps // 2 + 1}-{steps}) captured {cap['step_ms']:.2f} ms/step, "
        f"{cap['images_per_sec']:.1f} images/s, eager {eag['step_ms']:.2f} ms/step, "
        f"{eag['images_per_sec']:.1f} images/s; first window captured "
        f"{cap['first_window_ms']:.2f}, eager {eag['first_window_ms']:.2f} ms/step; peak memory "
        f"captured {cap['peak_gb']:.2f} GiB, eager {eag['peak_gb']:.2f} GiB"
    )
    return {
        "launches": launches,
        "variants": variants,
        "first_loss": first["loss"],
        "capture_s": capture["capture_s"],
        "step_ms": cap["step_ms"],
        "images_per_sec": cap["images_per_sec"],
        "peak_gb": cap["peak_gb"],
        "profile": cap["profile"],
        "eager": {k: eag[k] for k in ("step_ms", "images_per_sec", "peak_gb", "profile")},
        "routing": routing,
        "first_aux_loss": first["aux_loss"],
    }


def phase_surgery(directory, device="cuda") -> dict:
    """The fine-tune recipe's start: ViT-B/16 built at 224² from seed 0 (head
    drawn at std 0.02), saved as step 0 with the port's Checkpointer into
    ``directory`` (the pretrain checkpoint a fine-tune warm-starts from), and
    its state dict resized by the port's surgery to the 384² model's. Every
    tensor but the position table is carried unchanged; the table goes from
    197 to 577 rows. Returns the 384² state dict."""
    from sav_tpu_torch import TrainConfig, Trainer, create_model
    from sav_tpu_torch.models.surgery import adapt_pos_embeds
    from sav_tpu_torch.train import Checkpointer

    model = create_model(VIT384_MODEL, image_size=224, seed=0)
    _draw_for_agreement(model)
    source = {k: v.clone() for k, v in model.state_dict().items()}
    trainer = Trainer(TrainConfig(**_train_common(VIT384_MODEL, VIT384_BATCH, TRAIN_STEPS, 224,
                                                  1000, {})), model=model, device=device)
    checkpointer = Checkpointer(directory)
    checkpointer.save(0, trainer.init_state())
    checkpointer.close()
    written = checkpointer.written[-1]
    log(f"pretrain checkpoint {VIT384_MODEL}@224 step 0: save held the thread "
        f"{checkpointer.last_hold_s * 1e3:.1f} ms, background write "
        f"{written['write_s'] * 1e3:.1f} ms, {written['bytes']} bytes")
    del trainer, model
    torch.cuda.empty_cache()
    target = create_model(VIT384_MODEL, image_size=384, seed=1).state_dict()
    adapted = adapt_pos_embeds(source, target)
    key = "encoder.pos_embed.pos_embed"
    if set(adapted) != set(target) or any(
        tuple(adapted[k].shape) != tuple(target[k].shape) for k in target
    ):
        raise AssertionError("the adapted state dict does not fit the 384² model")
    changed = [k for k in source if k != key and not torch.equal(adapted[k], source[k])]
    if changed or source[key].shape[1] != 197 or adapted[key].shape[1] != 577:
        raise AssertionError(f"surgery changed {changed} or resized the table wrongly: "
                             f"{tuple(source[key].shape)} -> {tuple(adapted[key].shape)}")
    if not torch.equal(adapted[key][:, 0], source[key][:, 0]):
        raise AssertionError("surgery moved the CLS position")
    log(f"surgery {VIT384_MODEL} 224² -> 384²: {len(adapted) - 1} tensors carried unchanged, "
        f"{key} {tuple(source[key].shape)} -> {tuple(adapted[key].shape)} (bicubic, antialiased)")
    return adapted


def _clone_state_in_capture() -> str:
    """Whether this torch copies a CUDA generator's state during a graph
    capture (which would let a recompute rewind without twins)."""
    generator = torch.Generator(device="cuda")
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(generator)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    try:
        with torch.cuda.graph(graph, stream=side):
            torch.rand(1024, device="cuda", generator=generator)
            generator.clone_state()
    except RuntimeError as e:
        return f"raises ({str(e).splitlines()[0][:120]})"
    finally:
        torch.cuda.synchronize()
    return "is allowed"


def phase_remat_trade(state_dict, device="cuda") -> dict:
    """One train step of the 384² ViT-B/16 from ``state_dict`` with remat on
    and one with it off, on one batch of VIT384_BATCH (the fine-tune run's
    micro-batch), each eagerly (``_train_step_impl``) and then captured
    (``train_step``: two warm-ups and the capture, then a replay), without
    dropout and with dropout_rate REMAT_DROPOUT: the same eager loss
    (within REMAT_REL_TOL), the flash forward launched twice per block with
    remat and once without, and each step's peak device memory, eager and
    captured (the graph's pool and the warm-ups' state copies come on top).
    With dropout and remat, EQUAL_STEPS captured steps also equal as many
    eager ones bit for bit: the recompute's twin generators, put where the
    forward drew before each replay, draw the forward's masks."""
    from sav_tpu_torch import TrainConfig, Trainer, create_model

    log(f"remat trade: Generator.clone_state during a capture {_clone_state_in_capture()} "
        "(so the recompute's twins are made before the capture and put in place before "
        "each replay)")
    batch = _train_batches(VIT384_BATCH, 384, 1000, device, 1)[0]
    out = {}
    for rate in (0.0, REMAT_DROPOUT):
        for remat in (True, False):
            _free_device_memory()
            overrides = {"remat": remat, "dropout_rate": rate}
            model = create_model(VIT384_MODEL, image_size=384, seed=0, **overrides)
            model.load_state_dict(state_dict, strict=True)
            blocks = len(model.encoder.blocks)
            common = _train_common(VIT384_MODEL, VIT384_BATCH, TRAIN_STEPS, 384, 1000, overrides)
            trainer = Trainer(TrainConfig(**common), model=model, device=device)
            state = trainer.init_state()
            want = {**dict.fromkeys(COUNTERS, 0), "flash": blocks * (2 if remat else 1),
                    "flash_dq": blocks, "flash_dkv": blocks}
            what = f"remat={remat} dropout_rate={rate}"
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            state, metrics = trainer._train_step_impl(state, batch)
            loss = float(metrics["loss"])
            launches = launch_counts()
            if launches != want:
                raise AssertionError(f"{what}: one step launched {json.dumps(launches)}, "
                                     f"expected {json.dumps(want)}")
            eager_gb = torch.cuda.max_memory_allocated() / 2**30
            del metrics
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            state, metrics = trainer.train_step(state, batch)
            if not np.isfinite(float(metrics["loss"])):
                raise AssertionError(f"{what}: the captured step's loss is not finite")
            _check_train_capture(trainer, want, launch_counts(), what)
            out[rate, remat] = {"loss": loss, "peak_gb": eager_gb,
                                "captured_peak_gb": torch.cuda.max_memory_allocated() / 2**30}
            if rate and remat:  # after the peaks: its copies and batches are not in them
                batches = _train_batches(VIT384_BATCH, 384, 1000, device, EQUAL_STEPS)
                _captured_equals_eager(trainer, state, _snapshot(trainer, state), batches,
                                       f"{VIT384_MODEL}@384 {what}")
                del batches
            del trainer, model, state, metrics
        with_remat, without = out[rate, True], out[rate, False]
        if abs(with_remat["loss"] - without["loss"]) > REMAT_REL_TOL * abs(without["loss"]):
            raise AssertionError(f"dropout_rate={rate}: the step with remat has loss "
                                 f"{with_remat['loss']}, the step without {without['loss']}")
        log(
            f"remat trade {VIT384_MODEL}@384 bf16 batch {VIT384_BATCH} dropout_rate {rate}, one "
            f"step: loss with remat {with_remat['loss']:.7f}, without {without['loss']:.7f} (tol "
            f"{REMAT_REL_TOL} relative); flash forward launches {2 * blocks} vs {blocks}; peak "
            f"memory eager {with_remat['peak_gb']:.2f} GiB with remat, {without['peak_gb']:.2f} "
            f"GiB without; captured (warm-ups, capture and a replay) "
            f"{with_remat['captured_peak_gb']:.2f} and {without['captured_peak_gb']:.2f} GiB"
        )
    result = {}
    for (rate, remat), r in out.items():
        suffix = ("_remat" if remat else "_no_remat") + ("_dropout" if rate else "")
        result["peak_gb" + suffix] = r["peak_gb"]
        result["captured_peak_gb" + suffix] = r["captured_peak_gb"]
    return result


def _deit_source() -> dict:
    """DeiT-S/16's seed-0 weights with the head drawn (as phase_train draws
    them), on the host."""
    from sav_tpu_torch import create_model

    model = create_model("deit_s_patch16", seed=0)
    _draw_for_agreement(model)
    return model.state_dict()


def _deit_config(**kw):
    from sav_tpu_torch import TrainConfig

    return TrainConfig(**{**_train_common("deit_s_patch16", TRAIN_BATCH, TRAIN_STEPS, 224, 1000,
                                          {}), **kw})


# The resume phase's recipe: uint8 batches mixed and normalised on the card,
# so the "mix" generator is drawn from and must resume too.
RESUME_CONFIG = {"device_preprocess": True, "augment": "cutmix_mixup_randaugment_405"}


def _resume_feed(start_step, device):
    """The resumable synthetic feed from ``start_step`` as uint8 (the
    synthetic values mapped onto 0..255): batch k is a pure function of
    (seed, k), so a resumed run reads what the uninterrupted run read."""
    from sav_tpu_torch.data.synthetic import synth_resumable_iterator

    for b in synth_resumable_iterator(seed=0, start_step=start_step, batch_size=TRAIN_BATCH,
                                      image_size=224, num_classes=1000):
        images = np.clip(b["images"] * 40.0 + 128.0, 0, 255).astype(np.uint8)
        yield {"images": torch.from_numpy(images).to(device),
               "labels": torch.from_numpy(b["labels"]).to(device)}


def _resume_run(source, directory, device) -> dict:
    """6 uninterrupted steps; 3 steps that save into ``directory``; a fresh
    Trainer that restores step 3 and runs on to 6. Returns what to compare
    and the timings."""
    from sav_tpu_torch import Trainer, create_model

    def trainer(config):
        model = create_model("deit_s_patch16", seed=0)
        model.load_state_dict(source)
        return Trainer(config, model=model, device=device)

    full = trainer(_deit_config(**RESUME_CONFIG))
    state, history = full.fit(_resume_feed(0, device), num_steps=TRAIN_STEPS,
                              state=full.init_state())
    want = {"losses": [r["loss"] for r in history][3:], "state": _host_tree(state.state_dict())}
    del full, state
    first = trainer(_deit_config(checkpoint_dir=directory, **RESUME_CONFIG))
    first.fit(_resume_feed(0, device), num_steps=3, state=first.init_state())
    hold_s, written = first.checkpointer.last_hold_s, first.checkpointer.written[-1]
    first.checkpointer.close()
    del first
    torch.cuda.empty_cache()
    second = trainer(_deit_config(checkpoint_dir=directory, **RESUME_CONFIG))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored = second.restore_or_init()
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    if restored.step != 3:
        raise AssertionError(f"restore_or_init gave step {restored.step}, expected 3")
    per_step = attention_launches(second.model, train=True, family="fused")
    reset_launches()
    state, history = second.fit(_resume_feed(restored.step, device), num_steps=TRAIN_STEPS,
                                state=restored)
    _check_train_capture(second, per_step, launch_counts(), "resumed fit")
    launches, variants = _replay_launches(second, "resumed fit")
    second.checkpointer.close()
    got = {"losses": [r["loss"] for r in history], "state": _host_tree(state.state_dict())}
    # The resumed run's own save (step 6) finds the pinned host blocks the
    # first run's save freed: the steady-state cost of a save.
    return {"want": want, "got": got, "launches": launches, "per_step": per_step,
            "steps": [r["step"] for r in history], "hold_s": hold_s, "written": written,
            "warm_hold_s": second.checkpointer.last_hold_s,
            "warm_written": second.checkpointer.written[-1],
            "restore_s": restore_s, "variants": variants,
            "generators": sorted(got["state"]["generators"])}


def _host_tree(tree):
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    return tree.detach().to("cpu", copy=True) if torch.is_tensor(tree) else tree


def _tree_differences(got, want, path="") -> list:
    if isinstance(want, dict):
        return [d for k in want for d in _tree_differences(got[k], want[k], f"{path}/{k}")]
    same = torch.equal(got, want) if torch.is_tensor(want) else got == want
    return [] if same else [path]


def phase_resume(source, directory, device="cuda") -> dict:
    """DeiT-S bf16 at batch 256 through #1/#2, on uint8 batches mixed
    (cutmix_mixup) and normalised inside the captured step
    (RESUME_CONFIG): fit 6 steps uninterrupted;
    fit 3 steps into a checkpoint directory; a fresh Trainer's
    restore_or_init (step 3) and fit on to step 6 from the resumable feed's
    position 3, its step captured anew. Steps 4-6 must match the
    uninterrupted run bit for bit: the losses and, after step 6, every
    parameter, Adam moment and generator state (the "mix" generator's
    included). Should an op outside the port's kernels break that, the phase
    runs again under torch.use_deterministic_algorithms(True), which names
    any op without a deterministic version (CUBLAS_WORKSPACE_CONFIG is set
    before CUDA starts), and the log says so. The resumed run captures one
    step's kernels and replays them 3 times. The checkpoints stay in a directory under ``directory``
    (returned as ``"directory"``) for phase_serve_checkpoint."""
    deterministic = False
    while True:
        run_dir = os.path.join(directory, "deterministic" if deterministic else "default")
        run = _resume_run(source, run_dir, device)
        differ = _tree_differences(run["got"], run["want"])
        if not differ:
            break
        if deterministic:
            raise AssertionError(f"resume under deterministic algorithms differs at {differ[:8]}")
        log(f"resume: steps 4-6 differ from the uninterrupted run at {len(differ)} entries "
            f"({differ[:4]}); running the phase again under "
            "torch.use_deterministic_algorithms(True)")
        torch.use_deterministic_algorithms(True)
        deterministic = True
    torch.use_deterministic_algorithms(False)
    expected = _times(run["per_step"], 3)
    if run["steps"] != [4, 5, 6] or run["launches"] != expected or "mix" not in run["generators"]:
        raise AssertionError(f"resumed fit ran steps {run['steps']} with launches "
                             f"{json.dumps(run['launches'])} (replays x captured), expected "
                             f"{json.dumps(expected)}; generators {run['generators']}")
    written = run["written"]
    log(
        f"resume deit_s_patch16 bf16 batch {TRAIN_BATCH}, uint8 mixed and normalised in the "
        f"captured step: steps 4-6 after a restore of step 3 "
        f"bit-equal to the uninterrupted run (losses {run['got']['losses']}, every parameter, "
        f"moment and generator state, generators {run['generators']})"
        f"{' under deterministic algorithms' if deterministic else ''}; "
        f"launches (replays x captured) {json.dumps(run['launches'])} = 3 x "
        f"{json.dumps(run['per_step'])}; the first "
        f"save held the training thread {run['hold_s'] * 1e3:.1f} ms (pinning its host "
        f"buffers), a later one {run['warm_hold_s'] * 1e3:.1f} ms; background write "
        f"{written['write_s'] * 1e3:.1f} ms (later {run['warm_written']['write_s'] * 1e3:.1f} ms) "
        f"for {written['bytes']} bytes on disk; restore {run['restore_s'] * 1e3:.1f} ms"
    )
    return {**run["launches"], "variants": run["variants"], "deterministic": deterministic,
            "directory": run_dir,
            "save_hold_ms": run["hold_s"] * 1e3, "warm_save_hold_ms": run["warm_hold_s"] * 1e3,
            "write_ms": written["write_s"] * 1e3,
            "warm_write_ms": run["warm_written"]["write_s"] * 1e3,
            "bytes": written["bytes"], "restore_ms": run["restore_s"] * 1e3}


EVAL_IMAGES = 1000


def _eval_batches(device) -> list:
    """EVAL_IMAGES held-out synthetic images (another seed than the train
    batches) in batches of TRAIN_BATCH, the last one short."""
    from sav_tpu_torch.data.synthetic import synthetic_data_iterator

    batches = []
    for b in synthetic_data_iterator(batch_size=TRAIN_BATCH, image_size=224, num_classes=1000,
                                     seed=1, num_batches=-(-EVAL_IMAGES // TRAIN_BATCH)):
        take = min(TRAIN_BATCH, EVAL_IMAGES - TRAIN_BATCH * len(batches))
        batches.append({"images": torch.from_numpy(b["images"][:take]).to(device),
                        "labels": torch.from_numpy(b["labels"][:take]).to(device)})
    return batches


def phase_eval(source, device="cuda") -> dict:
    """Trainer.evaluate of DeiT-S over EVAL_IMAGES held-out images (3 x 256
    and a short batch of 232, padded) with the kernels and on the dense path
    (f32 softmax), same weights: eval_count 1000 on both, eval_loss within
    TRAIN_REL_TOL['loss'], top-1 within one point; one captured eval step
    (the fused forward once per attention module) serves every batch, the
    padded one included, as replays. Then fit with
    eval_every_epochs=1 over two 3-step epochs appends eval records at steps
    3 and 6."""
    from sav_tpu_torch import TrainConfig, Trainer, create_model

    batches = _eval_batches(device)
    results = {}
    for backend in ("kernels", "dense"):
        kw = {} if backend == "kernels" else {"backend": "xla", "logits_dtype": torch.float32}
        model = create_model("deit_s_patch16", **kw)
        model.load_state_dict(source)
        config = _deit_config(**({} if backend == "kernels" else
                                   {"attention_backend": "xla",
                                    "attention_logits_dtype": "float32"}))
        trainer = Trainer(config, model=model, device=device)
        state = trainer.init_state()
        per_batch = (attention_launches(model, train=False, family="fused")
                     if backend == "kernels" else dict.fromkeys(COUNTERS, 0))
        reset_launches()
        trainer.evaluate(state, iter(batches[:1]))  # warm: captures the eval step
        torch.cuda.synchronize()
        _check_train_capture(trainer, per_batch, launch_counts(), f"eval ({backend})",
                             kind="eval")
        reset_launches()
        t0 = time.perf_counter()
        result = trainer.evaluate(state, iter(batches))
        seconds = time.perf_counter() - t0
        if any(launch_counts().values()) or trainer.eval_graphs.summary()["signatures"] != 1:
            raise AssertionError(f"evaluate ({backend}) ran eagerly or captured again: "
                                 f"{json.dumps(launch_counts())}")
        replays = trainer.eval_graphs.summary()["replays"] - 1
        launches = _times(per_batch, replays)
        if replays != len(batches):
            raise AssertionError(f"evaluate ({backend}) replayed {replays} times for "
                                 f"{len(batches)} batches")
        results[backend] = {**result, "images_per_sec": EVAL_IMAGES / seconds,
                            "launches": launches}
        if backend == "kernels":
            variants = {k: {v: n * replays for v, n in by.items()} for k, by in
                        trainer.eval_graphs.summary()["captured_variants"].items()}
            variants = _on_tensor_cores({k: variants[k] for k in COUNTERS}, launches,
                                        "eval replays")
        del trainer, model, state
    ours, ref = results["kernels"], results["dense"]
    loss_rel = abs(ours["eval_loss"] - ref["eval_loss"]) / abs(ref["eval_loss"])
    top1 = abs(ours["eval_top_1_acc"] - ref["eval_top_1_acc"])
    if (ours["eval_count"], ref["eval_count"]) != (EVAL_IMAGES, EVAL_IMAGES) or \
            loss_rel > TRAIN_REL_TOL["loss"] or top1 > 0.01:
        raise AssertionError(f"evaluate disagrees with the dense path: {json.dumps(results)}")
    log(f"eval deit_s_patch16 bf16, {EVAL_IMAGES} images ({len(batches)} batches, the last "
        f"{len(batches[-1]['labels'])} padded to {TRAIN_BATCH}): kernels loss "
        f"{ours['eval_loss']:.6f}, top-1 {ours['eval_top_1_acc']:.4f}, "
        f"{ours['images_per_sec']:.1f} images/s; dense loss {ref['eval_loss']:.6f} (relative "
        f"difference {loss_rel:.3e}, tol {TRAIN_REL_TOL['loss']}), top-1 "
        f"{ref['eval_top_1_acc']:.4f}, {ref['images_per_sec']:.1f} images/s; launches "
        f"(replays x captured) {json.dumps(ours['launches'])}")

    model = create_model("deit_s_patch16")
    model.load_state_dict(source)
    config = _deit_config(num_train_images=TRAIN_BATCH * 3, eval_every_epochs=1,
                            log_every_steps=3)
    trainer = Trainer(config, model=model, device=device)
    train = _train_batches(TRAIN_BATCH, 224, 1000, device, TRAIN_DISTINCT_BATCHES)
    _, history = trainer.fit(iter(train * 2), num_steps=TRAIN_STEPS, state=trainer.init_state(),
                             eval_iter_fn=lambda: iter(batches))
    evals = [r for r in history if "eval_loss" in r]
    if [r["step"] for r in evals] != [3, 6] or any(r["eval_count"] != EVAL_IMAGES for r in evals):
        raise AssertionError(f"fit's eval records: {evals}")
    log(f"fit with eval_every_epochs=1 over two 3-step epochs: eval records at steps "
        f"{[r['step'] for r in evals]}, losses {[round(r['eval_loss'], 6) for r in evals]}")
    return {**ours["launches"], "variants": variants,
            "images_per_sec": ours["images_per_sec"], "dense_images_per_sec": ref["images_per_sec"]}


def phase_dropout(source, device="cuda") -> dict:
    """DeiT-S with dropout_rate=0.1 for 2 captured steps still runs #1/#2
    (replays x captured: the launches of 2 steps; the dropout generator is
    registered with the graph); with attn_dropout_rate=0.1 under auto a
    train step launches no attention kernel (the dense path, as sav_tpu's
    kernels_ok) and the captured eval step launches the fused forward as
    before. Prints the kept share of one drawn mask."""
    from sav_tpu_torch import Trainer, create_model

    batches = _train_batches(TRAIN_BATCH, 224, 1000, device, 2)
    out = {}
    for rate_name in ("dropout_rate", "attn_dropout_rate"):
        overrides = {rate_name: 0.1}
        model = create_model("deit_s_patch16", **overrides)
        model.load_state_dict(source)
        trainer = Trainer(_deit_config(model_overrides=overrides), model=model, device=device)
        state = trainer.init_state()
        per_step = attention_launches(model, train=True, family="fused")
        reset_launches()
        if rate_name == "dropout_rate":
            state, history = trainer.fit(iter(batches), num_steps=2, state=state)
            _check_train_capture(trainer, per_step, launch_counts(), rate_name)
            launches, variants = _replay_launches(trainer, rate_name)
            expected = _times(per_step, 2)
            losses = [r["loss"] for r in history]
        else:
            state, metrics = trainer.train_step(state, batches[0])
            losses = [float(metrics["loss"])]
            launches, expected = launch_counts(), dict.fromkeys(COUNTERS, 0)
            reset_launches()
            trainer.eval_step(state, batches[1])
            eval_expected = attention_launches(model, train=False, family="fused")
            _check_train_capture(trainer, eval_expected, launch_counts(),
                                 "eval under attention dropout", kind="eval")
        if launches != expected or not np.isfinite(losses).all():
            raise AssertionError(f"{rate_name}=0.1: launches {json.dumps(launches)}, expected "
                                 f"{json.dumps(expected)}; losses {losses}")
        out[rate_name] = launches
        log(f"dropout deit_s_patch16 {rate_name}=0.1 (captured): losses "
            f"{[round(x, 6) for x in losses]}, train launches {json.dumps(launches)}")
        if rate_name == "dropout_rate":
            # One mask of the position-embedding dropout, from the trainer's generator.
            ones = torch.ones((TRAIN_BATCH, 197, 384), device=device, dtype=torch.bfloat16)
            kept = (model.encoder.pos_drop.train()(ones) != 0).float().mean().item()
            sigma = (0.9 * 0.1 / ones.numel()) ** 0.5
            if abs(kept - 0.9) > 6 * sigma:
                raise AssertionError(f"a dropout mask kept {kept} of its entries, expected 0.9")
            log(f"dropout mask at rate 0.1 over {ones.numel()} entries: kept share {kept:.6f} "
                f"(0.9 ± {sigma:.2e})")
        del trainer, model, state
    return {**out["dropout_rate"], "variants": variants, "kept_share": kept}


# The device-preprocessing phase's recipe (uint8 HWCN batches, the default
# augment string's mixes, a parameter EMA).
DEVPRE_CONFIG = {"device_preprocess": True, "augment": "cutmix_mixup_randaugment_405",
                 "transpose_images": True, "ema_decay": 0.999}


def _uint8_batches(n: int, seed: int) -> list:
    """``n`` host batches of TRAIN_BATCH uint8 HWCN images at 224², the class
    carried by the brightness (so the loss can fall), as numpy."""
    from sav_tpu_torch.data.synthetic import synthetic_data_iterator

    out = []
    for b in synthetic_data_iterator(batch_size=TRAIN_BATCH, image_size=224, num_classes=1000,
                                     seed=seed, num_batches=n, transpose=True):
        out.append({"images": np.clip(b["images"] * 40.0 + 128.0, 0, 255).astype(np.uint8),
                    "labels": b["labels"]})
    return out


def phase_device_preprocess(source, device="cuda") -> dict:
    """DeiT-S bf16 at batch 256 with ``device_preprocess`` and
    ``cutmix_mixup_randaugment_405`` (DEVPRE_CONFIG): host batches of uint8
    HWCN images go through the async feeder, and the captured step
    transposes, mixes (MixUp on one half, CutMix on the other, from the
    "mix" generator) and normalises them on the card. fit runs 6 captured
    steps (finite loss that falls from the first three steps to the last
    three; two warm-ups and one capture on the counters, 6 replays); then
    EQUAL_STEPS captured steps equal as many eager ones from the same start,
    bit for bit, the EMA and the "mix" generator included; a fresh
    ``init_state`` (new tensors) is captured again once and equals eager
    too. A batch moves half the bytes of the same batch in bf16."""
    from sav_tpu_torch import Trainer, create_model

    model = create_model("deit_s_patch16")
    model.load_state_dict(source)
    trainer = Trainer(_deit_config(**DEVPRE_CONFIG), model=model, device=device)
    state = trainer.init_state()
    per_step = attention_launches(model, train=True, family="fused")
    batches = _uint8_batches(TRAIN_DISTINCT_BATCHES, seed=2)
    what = "train deit_s_patch16 device_preprocess"
    start, start_state = _snapshot(trainer, state), state
    windows = []
    reset_launches()
    state, history = trainer.fit(iter(batches * 2), num_steps=TRAIN_STEPS, state=state,
                                 log_fn=windows.append)
    capture = _check_train_capture(trainer, per_step, launch_counts(), what)
    launches, variants = _replay_launches(trainer, what)
    losses = [r["loss"] for r in history]
    if (capture["replays"] != TRAIN_STEPS or not np.isfinite(losses).all()
            or np.mean(losses[3:]) >= np.mean(losses[:3])):
        raise AssertionError(f"{what}: {capture['replays']} replays, losses {losses}")
    _captured_equals_eager(trainer, start_state, start, batches, what)
    # A state with other tensors (init_state makes new moments): the step is
    # captured again, once, and still equals the eager one.
    fresh = trainer.init_state()
    _captured_equals_eager(trainer, fresh, _snapshot(trainer, fresh), batches,
                           f"{what} after init_state", recaptures=1)
    uint8_bytes = batches[0]["images"].nbytes
    bf16_bytes = batches[0]["images"].size * 2
    if 2 * uint8_bytes != bf16_bytes:
        raise AssertionError(f"{what}: a uint8 batch moves {uint8_bytes} bytes, bf16 {bf16_bytes}")
    last = history[-1]
    log(f"{what} (cutmix_mixup_randaugment_405, EMA 0.999): losses "
        f"{[round(x, 4) for x in losses]}; replays x captured {json.dumps(_nonzero(launches))}; "
        f"steady "
        f"window {last['step_s'] * 1e3:.2f} ms/step, {last['images_per_sec']:.1f} images/s; "
        f"images {uint8_bytes} bytes a batch (bf16: {bf16_bytes}); feeder "
        f"{json.dumps({k: v for k, v in last.items() if k.startswith('feeder_')})}")
    return {**launches, "variants": variants, "step_ms": last["step_s"] * 1e3,
            "images_per_sec": last["images_per_sec"], "transfer_bytes": uint8_bytes}


# The train bench's runs: DeiT-S at 256, bench.py's default windows.
TRAIN_BENCH_ARGS = ["--model", "deit_s_patch16", "--batch-size", str(TRAIN_BATCH)]
TRAIN_BENCH_STEPS, TRAIN_BENCH_REPS = 20, 4


def phase_train_bench() -> dict:
    """``python -m sav_tpu_torch.train.bench`` (through its ``main``, which
    prints its one JSON line) for DeiT-S at 256, with bf16 batches and with
    ``--device-preprocess``: outcome ok, an MFU against the card's table
    peak, one captured step of DeiT-S's launches, and the uint8 batch half
    the bf16 one's bytes (labels aside). Returns each run's line and the
    launches its replays ran, as the bench counted them (2 warm-ups and the
    windows)."""
    from sav_tpu_torch.train import bench

    from sav_tpu_torch import create_model

    per_step = attention_launches(create_model("deit_s_patch16"), train=True, family="fused")
    out = {}
    for name, extra in (("bf16", []), ("uint8", ["--device-preprocess"])):
        reset_launches()
        line = bench.main(TRAIN_BENCH_ARGS + extra + ["--steps", str(TRAIN_BENCH_STEPS),
                                                      "--reps", str(TRAIN_BENCH_REPS)])
        captured = {**dict.fromkeys(COUNTERS, 0), **line["captured_launches"]}
        if (line["outcome"] != "ok" or not line["mfu"] or line["platform"] != "cuda"
                or not line["peak_source"].startswith("device-table") or captured != per_step
                or launch_counts() != _times(per_step, 3)):
            raise AssertionError(f"train bench ({name}): {json.dumps(line)}; counters "
                                 f"{json.dumps(launch_counts())}")
        # The replays the bench counted where it launched them: two warm-up
        # steps and the windows'.
        replays = line["replays"]
        launches = {**dict.fromkeys(COUNTERS, 0), **line["replayed_launches"]}
        if replays != 2 + TRAIN_BENCH_STEPS * TRAIN_BENCH_REPS or launches != _times(captured,
                                                                                     replays):
            raise AssertionError(f"train bench ({name}): {replays} replays ran "
                                 f"{json.dumps(launches)}, expected "
                                 f"{2 + TRAIN_BENCH_STEPS * TRAIN_BENCH_REPS} of "
                                 f"{json.dumps(captured)}")
        # The line leaves out the variants that did not run.
        variants = {k: {v: line["replayed_variants"].get(k, {}).get(v, 0) for v in by_variant}
                    for k, by_variant in variant_counts().items()}
        out[name] = {"line": line, "launches": launches,
                     "variants": _on_tensor_cores(variants, launches, f"train bench ({name})")}
        _free_device_memory()
    labels = 4 * TRAIN_BATCH
    ratio = ((out["uint8"]["line"]["transfer_bytes_per_batch"] - labels)
             / (out["bf16"]["line"]["transfer_bytes_per_batch"] - labels))
    if ratio != 0.5:
        raise AssertionError(f"uint8 images move {ratio} of the bf16 images' bytes")
    log("train bench deit_s_patch16 256: " + json.dumps(
        {name: {k: r["line"][k] for k in ("value", "median_img_per_sec", "step_ms", "mfu",
                                          "transfer_bytes_per_batch", "capture_s")}
         for name, r in out.items()}))
    return out


# Kernel-name fragments → the group a device kernel is counted under.
KERNEL_GROUPS = (
    ("flash backward dq (flash_attention_bwd.cu)", ("flash_attention_bwd_dq_kernel",
                                                    "flash_attention_bwd_dq_mma_kernel")),
    ("flash backward dk/dv (flash_attention_bwd.cu)", ("flash_attention_bwd_dkv_kernel",
                                                       "flash_attention_bwd_dkv_mma_kernel")),
    ("flash forward (flash_attention.cu)", ("flash_attention_fwd_kernel",
                                            "flash_attention_fwd_mma_kernel")),
    ("attention backward (fused_attention_bwd.cu)", ("fused_attention_bwd_kernel",
                                                     "fused_attention_bwd_mma_kernel")),
    ("attention forward (fused_attention.cu)", ("fused_attention_fwd_kernel",
                                                "fused_attention_fwd_mma_kernel")),
    ("talking-heads backward dq (talking_heads_bwd.cu)", ("talking_heads_bwd_kernel",
                                                         "talking_heads_bwd_dq_mma_kernel")),
    ("talking-heads backward dk/dv (talking_heads_bwd.cu)", ("talking_heads_bwd_dkv_mma_kernel",)),
    ("talking-heads forward (talking_heads.cu)", ("talking_heads_fwd_kernel",
                                                  "talking_heads_fwd_mma_kernel")),
    ("rel backward dq (rel_attention_bwd.cu)", ("rel_attention_bwd_dq_kernel",
                                                "rel_attention_bwd_dq_mma_kernel")),
    ("rel backward dk/dv (rel_attention_bwd.cu)", ("rel_attention_bwd_dkv_kernel",
                                                   "rel_attention_bwd_dkv_mma_kernel")),
    ("rel forward (rel_attention.cu)", ("rel_attention_fwd_kernel",
                                        "rel_attention_fwd_mma_kernel")),
    ("batch norm", ("batch_norm", "batchnorm", "bn_fw", "bn_bw")),
    # CvT's and CeiT's f32 depthwise convs: cuDNN names its wgrad
    # "depthwise" and its forward and dgrad for one channel a group "c1_k1"
    # (PyTorch's own kernel says "depthwise" too).
    ("depthwise convolution", ("depthwise", "_c1_k1_")),
    # Before matmul: cuDNN's convolution kernels are implicit GEMMs, named
    # like cuBLAS's (xmma, cutlass) with fprop/dgrad/wgrad in the name.
    ("convolution (cuDNN)", ("conv", "cudnn", "implicit", "fprop", "wgrad", "dgrad")),
    ("matmul (cuBLAS)", ("gemm", "xmma", "nvjet", "cutlass", "splitk", "Kernel2")),
    ("optimizer (multi-tensor)", ("multi_tensor", "foreach")),
    ("layer norm", ("layer_norm", "LayerNorm")),
    ("reductions", ("reduce",)),
    ("elementwise and copies", ("elementwise", "vectorized", "copy", "Memcpy", "Memset",
                                "fill", "cat", "index")),
)


# The supervised chain (phase_supervised_chain): DeiT-S at the smoke run's
# recipe, trained by ``python -m sav_tpu_torch.train --supervise`` through
# three injected faults. Saves every 4 steps, logs every 2; the kill lands at
# a heartbeat step after the save of 4 (the killer polls the heartbeats, so
# it lands in step 6 or 7, before the save of 8); the NaN batch at schedule
# position 10 kills the attempt that resumed from 4, after its save of 8;
# the hang at position 14 (step 13 once position 10 is skipped) stalls the
# attempt that resumed from 8, after its save of 12, until the watchdog's
# exit 4; the last attempt resumes from 12 and ends at CHAIN_STEPS. Cut
# from ~32 steps to 16 and the watchdog to 10 s for the run's time limit:
# each attempt takes ~25 s to its first step (two processes reach the card:
# the backend probe's and the trainer's) and the --synth-data feed makes
# each 256-image batch on the host (Philox normals, then the recorder's
# hash), ~1.4 s a step (NVIDIA H100 80GB HBM3, 700.00 W).
CHAIN_STEPS = 16
CHAIN_LOG_EVERY, CHAIN_CKPT_EVERY = 2, 4
CHAIN_KILL_AT, CHAIN_NAN_AT, CHAIN_HANG_AT = 6, 10, 14
CHAIN_WATCHDOG_S, CHAIN_WATCHDOG_SOFT_S = 10.0, 4.0
CHAIN_BACKOFF_S = 0.25
CHAIN_SEED = 0
# The exit-3 leg's probe deadline, and its slack for the child's start.
CHAIN_BACKEND_WAIT_S, CHAIN_START_SLACK_S = 2.0, 40.0
CHAIN_REASONS = ["killed:SIGKILL", "nonfinite", "hang", None]
CHAIN_TIMEOUT_S = 600


def _chain_argv(directory: str, *extra: str) -> list:
    return [sys.executable, "-m", "sav_tpu_torch.train", "--supervise",
            "--synth-data", "-m", "deit_s_patch16", "--num-classes", "1000",
            "--image-size", "224", "--batch-size", str(TRAIN_BATCH), "--dtype", "bfloat16",
            "--seed", str(CHAIN_SEED), "-c", directory, *extra]


class ChainKiller(threading.Thread):
    """SIGKILLs the supervised run's training child once a heartbeat of
    step ``target`` or later appears (``fleet/proc_0.jsonl``, flushed per
    line and tagged with the child's pid), once: the preemption a chaos
    soak injects, at a reproducible step rather than a time."""

    def __init__(self, log_dir: str, target: int, poll_s: float = 0.2):
        super().__init__(name="chain-killer", daemon=True)
        self.log_dir, self.target, self.poll_s = log_dir, target, poll_s
        self.kills: list = []
        self.stop = threading.Event()

    def run(self) -> None:
        from sav_tpu_torch.obs.fleet import read_heartbeats

        while not self.stop.is_set() and not self.kills:
            beats = [b for b in read_heartbeats(self.log_dir).get(0, []) if b.get("kind") == "hb"]
            if beats and beats[-1]["step"] >= self.target:
                pid = beats[-1]["pid"]
                try:
                    with open(f"/proc/{pid}/cmdline", "rb") as f:
                        is_trainer = b"sav_tpu_torch.train" in f.read()
                    if is_trainer:
                        os.kill(pid, 9)
                        self.kills.append({"pid": pid, "at_step": beats[-1]["step"]})
                except (FileNotFoundError, ProcessLookupError):
                    pass  # it ended on its own first; the chain says why
            time.sleep(self.poll_s)


def _run_chain(directory: str, env: dict, log_path: str, killer=None) -> int:
    """One ``--supervise`` run as a subprocess, its output into
    ``log_path``; returns its exit code."""
    chain_dir = os.path.join(directory, "chain")
    argv = _chain_argv(
        chain_dir, "--steps", str(CHAIN_STEPS), "--log-every-steps", str(CHAIN_LOG_EVERY),
        "--checkpoint-every-steps", str(CHAIN_CKPT_EVERY), "--debug-nans", "--record",
        "--record-batches", "2", "--watchdog-secs", str(CHAIN_WATCHDOG_S),
        "--watchdog-soft-secs", str(CHAIN_WATCHDOG_SOFT_S), "--max-restarts", "4",
        "--restart-backoff", str(CHAIN_BACKOFF_S))
    with open(log_path, "w") as out:
        proc = subprocess.Popen(argv, cwd=ROOT, env=env, stdout=out, stderr=subprocess.STDOUT)
        if killer is not None:
            killer.start()
        try:
            return proc.wait(timeout=CHAIN_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            raise AssertionError(f"the supervised chain ran past {CHAIN_TIMEOUT_S} s")
        finally:
            if killer is not None:
                killer.stop.set()
                killer.join(timeout=10)


def _tail(path: str, lines: int = 40) -> str:
    with open(path, errors="replace") as f:
        return "".join(f.readlines()[-lines:])


def _reference_batches(out: list) -> None:
    """The skip-applied synthetic stream of the chain's seed, on the host
    (made on a thread while the chain runs)."""
    from sav_tpu_torch.data.synthetic import synth_resumable_iterator
    from sav_tpu_torch.train.supervisor import skip_step_batches

    stream = skip_step_batches(
        synth_resumable_iterator(seed=CHAIN_SEED, batch_size=TRAIN_BATCH, image_size=224,
                                 num_classes=1000), {CHAIN_NAN_AT})
    out.extend(next(stream) for _ in range(CHAIN_STEPS))


def _chain_reference(chain_dir: str, batches: list):
    """One in-process fit of the chain's own config (its final checkpoint's
    config.json, less the sink and the recorder) over the skip-applied
    stream, through the captured step, with cuDNN's TF32 as the children
    have it (PyTorch's default); returns its state on the host."""
    from sav_tpu_torch import TrainConfig, Trainer
    from sav_tpu_torch.train import Checkpointer

    saved = Checkpointer(chain_dir, read_only=True).restore_raw(CHAIN_STEPS)
    config = TrainConfig(**{**saved["config"], "checkpoint_dir": None, "log_dir": None,
                            "debug_nans": False, "record": False, "watchdog_secs": None,
                            "watchdog_soft_secs": None, "fleet": False})
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        trainer = Trainer(config, device="cuda")
        state, _ = trainer.fit(iter(batches), num_steps=CHAIN_STEPS, state=trainer.init_state())
        want = _host_tree(state.state_dict())
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    del trainer, state
    _free_device_memory()
    got = {k: saved[k] for k in ("step", "params", "batch_stats", "opt_state", "generators")}
    return got, want


def _check_chain(chain_dir: str, per_step: dict, device_name: str) -> dict:
    """The chain's structure (sav_tpu's checks and the faults' order) and
    each attempt's kernels note; returns the chain, its attempts' manifests
    and the launches its replays ran, from each attempt's replay counter
    (replays × captured)."""
    from sav_tpu_torch.train.supervisor import load_chain, verify_chain

    doc = load_chain(chain_dir)
    if doc is None:
        raise AssertionError(f"no supervisor.json in {chain_dir}")
    chain = doc["notes"]["chain"]
    attempts = chain["attempts"]
    problems = verify_chain(doc, min_accounted=0.99)
    reasons = [a["restart_reason"] for a in attempts]
    codes = [a["exit_code"] for a in attempts]
    if (problems or reasons != CHAIN_REASONS or codes != [-9, 1, 4, 0]
            or chain["skipped_steps"] != [CHAIN_NAN_AT]
            or [a.get("skip_decided") for a in attempts] != [None, [CHAIN_NAN_AT], None, None]):
        raise AssertionError(f"supervised chain: problems {problems}, reasons {reasons}, exit "
                             f"codes {codes}, skips {chain['skipped_steps']}: "
                             f"{json.dumps(attempts)}")
    manifests, counted, launches = [], [], dict.fromkeys(COUNTERS, 0)
    variants = {k: {} for k in COUNTERS}
    for a in attempts:
        with open(os.path.join(chain_dir, a["manifest"])) as f:
            manifests.append(json.load(f))
        note = manifests[-1]["notes"].get("kernels") or {}
        captured = {**dict.fromkeys(COUNTERS, 0), **note.get("captured_launches", {})}
        tensor_core = {k: {"tensor_core": n} for k, n in per_step.items() if n}
        by_variant = {k: nonzero for k, tally in note.get("captured_variants", {}).items()
                      if (nonzero := {v: n for v, n in tally.items() if n})}
        if (note.get("device") != device_name or captured != per_step
                or by_variant != tensor_core or note.get("launches") != _times(per_step, 3)):
            raise AssertionError(f"attempt {a['attempt']}'s kernels note {json.dumps(note)}: "
                                 f"expected {json.dumps(per_step)} a captured step on "
                                 f"{device_name}, all tensor-core, 3 x that on the counters")
        # Replays: each attempt's own counter as its manifest last noted it,
        # with the step it was read at (the final and the nonfinite attempt
        # at their close, the killed and the hung one at their last log
        # boundary); what a killed attempt ran after that is not counted.
        replays, at_step = note.get("replays"), note.get("replays_at_step")
        if (replays is None or at_step is None or replays != at_step - a["resumed_from_step"]
                or at_step < a["last_step"]
                or (a["exit_code"] == 0 and at_step != CHAIN_STEPS)
                or (a["restart_reason"] == "nonfinite" and at_step != CHAIN_NAN_AT)):
            raise AssertionError(f"attempt {a['attempt']} (resumed from "
                                 f"{a['resumed_from_step']}, last heartbeat {a['last_step']}): "
                                 f"{replays} replays noted at step {at_step}")
        counted.append({"attempt": a["attempt"], "replays": replays, "to_step": at_step})
        for k, n in captured.items():
            launches[k] += replays * n
            if n:
                variants[k]["tensor_core"] = variants[k].get("tensor_core", 0) + replays * n
    return {"doc": doc, "attempts": attempts, "manifests": manifests, "launches": launches,
            "variants": variants, "counted": counted}


def _exit_3_leg(directory: str) -> dict:
    """``--device cuda`` with no card visible (CUDA_VISIBLE_DEVICES="") and
    no restart left: the child's probe gives up after its deadline, exit 3,
    ``backend_unreachable``, and the chain exits 3."""
    from sav_tpu_torch.train.supervisor import load_chain

    leg_dir = os.path.join(directory, "no_card")
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    t0 = time.perf_counter()
    proc = subprocess.run(
        _chain_argv(leg_dir, "--steps", "2", "--max-restarts", "0",
                    "--backend-wait", str(CHAIN_BACKEND_WAIT_S)),
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    doc = load_chain(leg_dir) or {}
    attempts = (doc.get("notes") or {}).get("chain", {}).get("attempts", [])
    probes = []
    if attempts and attempts[0]["manifest"]:
        with open(os.path.join(leg_dir, attempts[0]["manifest"])) as f:
            probes = json.load(f)["notes"].get("backend_probe", {}).get("probes", [])
    # The probe gives up once its deadline is spent; its last probe's
    # timeout is clamped to at least a second.
    if (proc.returncode != 3 or [a["restart_reason"] for a in attempts] != ["backend_unreachable"]
            or doc.get("outcome") != "backend_unreachable" or not probes
            or probes[-1]["elapsed_s"] > CHAIN_BACKEND_WAIT_S + 2.0
            or attempts[0]["wall_s"] > CHAIN_BACKEND_WAIT_S + CHAIN_START_SLACK_S):
        raise AssertionError(f"exit-3 leg: rc {proc.returncode}, chain {json.dumps(doc)[:2000]}; "
                             f"probes {probes}; stderr {proc.stderr[-3000:]}")
    return {"rc": proc.returncode, "wall_s": wall, "attempt_wall_s": attempts[0]["wall_s"],
            "probe_s": probes[-1]["elapsed_s"], "probes": len(probes)}


def _telemetry_costs(manifests: list) -> dict:
    """The telemetry's cost over all the chain's attempts, from each
    attempt's ledger metrics as its manifest last noted them: the steps and
    heartbeats they cover, the recorder's training-thread seconds (its
    bookkeeping and its snapshots' enqueued copies; its two sets of pinned
    buffers, allocated once an attempt, apart) and its feeder-thread hash,
    the heartbeats' and the manifest's writes; per step, per heartbeat,
    per manifest write and per attempt, in ms, with each attempt's
    sample."""
    keys = {"steps": "goodput/recorder/steps", "recorder_s": "goodput/recorder/overhead_s",
            "snapshot_s": "goodput/recorder/snapshot_s", "hash_s": "goodput/recorder/hash_s",
            "buffers_s": "goodput/recorder/buffers_s",
            "beats": "goodput/fleet/beats", "fleet_write_s": "goodput/fleet/write_s",
            "manifest_write_s": "goodput/manifest/write_s"}
    attempts = [{k: m["metrics"].get(key, 0.0) for k, key in keys.items()} for m in manifests]
    total = {k: sum(a[k] for a in attempts) for k in keys}
    steps, beats = max(total["steps"], 1.0), max(total["beats"], 1.0)
    return {
        "steps": int(total["steps"]), "heartbeats": int(total["beats"]),
        "recorder_training_thread_ms_per_step": (total["recorder_s"] + total["snapshot_s"])
                                                * 1e3 / steps,
        "recorder_hash_feeder_thread_ms_per_step": total["hash_s"] * 1e3 / steps,
        "recorder_buffers_ms_per_attempt": total["buffers_s"] * 1e3 / len(attempts),
        "heartbeat_ms": total["fleet_write_s"] * 1e3 / beats,
        "manifest_progress_ms": total["manifest_write_s"] * 1e3 / beats,
        "by_attempt": attempts,
    }


def phase_supervised_chain(directory: str) -> dict:
    """DeiT-S (bf16, 256, 12 layers, width 384) trained by ``python -m
    sav_tpu_torch.train --supervise`` through a SIGKILL, a NaN batch and a
    hang (the CHAIN_* constants): sav_tpu's verify_chain finds no problem
    (outcome ok, accounted_frac >= 0.99), the restart reasons are the
    faults' in order, the poisoned position is skipped once; the final
    parameters, Adam moments, count and generator states equal, bit for bit,
    one in-process fit of the same config over the skip-applied stream
    through the same captured step (should they not, the chain and the
    reference run again under torch.use_deterministic_algorithms(True),
    the children through a sitecustomize.py, and the log says which entries
    differed); each attempt's first batch is the reference stream's at its
    resume position; each attempt's kernels note holds one captured step of
    12 #1 and 12 #2, all tensor-core, on this card. Then the exit-3 leg.
    Prints the chain's goodput, lost seconds, each attempt's start (spawn to
    its first step's end) and the telemetry's cost per step."""
    from sav_tpu_torch import create_model
    from sav_tpu_torch.obs.recorder import batch_fingerprint

    _free_device_memory()
    device_name = torch.cuda.get_device_name(0)
    per_step = attention_launches(create_model("deit_s_patch16"), train=True, family="fused")
    batches: list = []
    maker = threading.Thread(target=_reference_batches, args=(batches,), name="chain-batches")
    maker.start()
    deterministic = False
    while True:
        run_dir = os.path.join(directory, "deterministic" if deterministic else "default")
        os.makedirs(run_dir)
        env = {**os.environ, "SAV_CHAOS_NAN_STEP": str(CHAIN_NAN_AT),
               "SAV_CHAOS_HANG_STEP": str(CHAIN_HANG_AT),
               "SAV_CHAOS_ONCE_DIR": os.path.join(run_dir, "once")}
        if deterministic:
            hook = os.path.join(run_dir, "hook")
            os.makedirs(hook)
            with open(os.path.join(hook, "sitecustomize.py"), "w") as f:
                f.write("import os\nif os.environ.get('SAV_SUPERVISED_ATTEMPT'):\n"
                        "    import torch\n    torch.use_deterministic_algorithms(True)\n")
            env["PYTHONPATH"] = os.pathsep.join(filter(None, [hook, env.get("PYTHONPATH")]))
        chain_dir = os.path.join(run_dir, "chain")
        killer = ChainKiller(chain_dir, CHAIN_KILL_AT)
        log_path = os.path.join(run_dir, "supervise.log")
        t0 = time.perf_counter()
        rc = _run_chain(run_dir, env, log_path, killer=killer)
        chain_s = time.perf_counter() - t0
        if rc != 0 or len(killer.kills) != 1:
            raise AssertionError(f"supervised chain exited {rc}, kills {killer.kills}; log "
                                 f"tail:\n{_tail(log_path)}")
        checked = _check_chain(chain_dir, per_step, device_name)
        maker.join()
        got, want = _chain_reference(chain_dir, batches)
        differ = _tree_differences(got, want)
        if not differ:
            break
        if deterministic:
            raise AssertionError(f"supervised chain under deterministic algorithms differs from "
                                 f"its reference at {differ[:8]}")
        log(f"supervised chain: the final state differs from the reference at {len(differ)} "
            f"entries ({differ[:4]}); running the chain and the reference again under "
            "torch.use_deterministic_algorithms(True)")
        torch.use_deterministic_algorithms(True)
        deterministic = True
    torch.use_deterministic_algorithms(False)
    attempts, manifests = checked["attempts"], checked["manifests"]
    for a, m in zip(attempts, manifests):
        resume = m["notes"]["resume"]
        want_hash = batch_fingerprint(batches[a["resumed_from_step"]])["hash"]
        if resume["from_step"] != a["resumed_from_step"] or resume["next_batch_hash"] != want_hash:
            raise AssertionError(f"attempt {a['attempt']} resumed at {json.dumps(resume)}; the "
                                 f"reference's batch for step {a['resumed_from_step'] + 1} is "
                                 f"{want_hash}")
    del batches
    leg = _exit_3_leg(directory)
    metrics = checked["doc"]["metrics"]
    # Each attempt's start: spawn to the process's main, the probe's wait
    # after the imports it ran beside, and spawn to the first step's end.
    starts = [{"main_s": round(m["created_unix"] - a["start_unix"], 3),
               "probe_wait_s": m["notes"].get("backend_probe", {}).get("wait_s"),
               "first_step_s": round(m["notes"]["kernels"]["first_step_unix"]
                                     - a["start_unix"], 3)}
              for a, m in zip(attempts, manifests)]
    buckets = {k[len("goodput/"):]: v for k, v in manifests[-1]["metrics"].items()
               if k.startswith("goodput/") and k.endswith("_s") and "/" not in k[8:]}
    telemetry = _telemetry_costs(manifests)
    summary = {
        "chain_s": round(chain_s, 1), "deterministic": deterministic,
        "goodput_frac": metrics["goodput_frac"], "accounted_frac": metrics["accounted_frac"],
        "lost_s": metrics["goodput/lost_s"], "backoff_s": metrics["goodput/backoff_s"],
        "reasons": [a["restart_reason"] for a in attempts],
        "resumed_from": [a["resumed_from_step"] for a in attempts],
        "kills": killer.kills, "start_s": starts,
        "per_step_s": [a["per_step_s"] for a in attempts],
        "replays_counted": checked["counted"], "telemetry": telemetry,
        "final_attempt_buckets_s": buckets, "exit_3_leg": leg,
    }
    log(f"supervised chain deit_s_patch16 bf16 batch {TRAIN_BATCH}, {CHAIN_STEPS} steps "
        f"through a SIGKILL, a NaN batch at {CHAIN_NAN_AT} and a hang at {CHAIN_HANG_AT}: "
        f"final parameters, moments, count and generators bit-equal to one uninterrupted fit "
        f"over the skip-applied stream{' under deterministic algorithms' if deterministic else ''}"
        f"; launches (each attempt's replays x captured; the killed and the hung attempt to "
        f"their last log boundary) "
        f"{json.dumps(_nonzero(checked['launches']))}; {json.dumps(summary)}")
    return {**checked["launches"], "variants": checked["variants"], "summary": summary}


def profile_step(trainer, state, batch, per_step: dict, *, eager=False) -> dict:
    """One train step under torch.profiler (:func:`_device_events`): device
    busy time per kernel group (summed
    kernel self time) against the step's wall time. The step is the
    trainer's (a replay on the card), or with ``eager`` its eager body;
    counted by name, its attention kernels must be ``per_step``'s."""
    step = trainer._train_step_impl if eager else trainer.train_step
    step(state, batch)  # warm, outside the window
    torch.cuda.synchronize()
    attention = [g for g, _ in KERNEL_GROUPS if g.endswith(".cu)")]
    want = dict.fromkeys(attention, 0)
    for kind, n in per_step.items():
        want[COUNTER_GROUPS[kind]] += n

    def check(events):
        # Device-side events only (kernels, copies, fills): an operator's
        # row in key_averages would count its kernels a second time.
        kernels, counts = {}, {}
        for event in events:
            kernels[event.name] = (kernels.get(event.name, 0.0)
                                   + event.time_range.elapsed_us() / 1e3)
            group = next((g for g, keys in KERNEL_GROUPS if any(k in event.name for k in keys)),
                         "other")
            counts[group] = counts.get(group, 0) + 1
        if sum(kernels.values()) == 0.0:
            raise RuntimeError("the profiler recorded no device time")
        got = {g: counts.get(g, 0) for g in attention}
        if got != want:
            raise AssertionError(f"a profiled {'eager' if eager else 'captured'} step ran the "
                                 f"attention kernels {json.dumps(got)}, expected "
                                 f"{json.dumps(want)}")
        return kernels, counts, got

    wall_ms, (kernels, counts, got) = _device_events(lambda: step(state, batch), check)
    busy = sum(kernels.values())
    groups = {}
    for name, ms in kernels.items():
        group = next((g for g, keys in KERNEL_GROUPS if any(k in name for k in keys)), "other")
        groups[group] = groups.get(group, 0.0) + ms
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    log(
        f"train step profile ({'eager' if eager else 'captured'} step, torch.profiler): wall "
        f"{wall_ms:.2f} ms, device busy "
        f"{busy:.2f} ms, idle {100 * (1 - busy / wall_ms):.1f} %; by group "
        + json.dumps({g: round(ms, 3) for g, ms in sorted(groups.items(), key=lambda kv: -kv[1])})
    )
    for name, ms in top:
        log(f"  {ms:8.3f} ms  {name[:110]}")
    log(f"  attention kernels by name: {json.dumps({g: n for g, n in got.items() if n})} of "
        f"{sum(counts.values())} device kernels and copies")
    return {"wall_ms": wall_ms, "busy_ms": busy, "groups": groups,
            "idle_pct": 100 * (1 - busy / wall_ms)}


def _timed(entry: dict) -> dict:
    """A timing record, its yardstick kept as ``library_ms`` (None where no
    single PyTorch call computes the function)."""
    return {k: entry[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "dense_ms")
            if k in entry}


def main() -> None:
    start = time.perf_counter()

    def mark(what: str) -> None:
        log(f"clock: {what} done at {time.perf_counter() - start:.1f} s")

    smi = phase_device()
    phase_build()
    mark("build")
    fwd_err = phase_kernels()
    bwd_err = phase_bwd_kernels()
    th_err = phase_th_kernels()
    flash_err = phase_flash_kernels()
    rel_err = phase_rel_kernels()
    moe_routing = phase_moe_routing()
    mark("kernel checks")
    times = phase_timing()
    mark("timing")
    serve = {"deit": phase_serve(), "cait": phase_serve(model_name="cait_xxs_24"),
             "botnet": phase_serve(model_name=BOTNET_MODEL, family="rel"),
             "cvt": phase_serve(model_name=CVT_MODEL, family=CVT_FAMILY),
             "ceit": phase_serve(model_name=CEIT_MODEL),
             "tnt": phase_serve(model_name=TNT_MODEL),
             "mixer": phase_serve(model_name=MIXER_MODEL, reference="f32"),
             "rope": phase_serve(model_name=ROPE_MODEL),
             "moe": phase_serve(model_name=MOE_MODEL)}
    benches = {"deit": phase_serve_bench("deit_s_patch16", serve["deit"]["per_batch"],
                                         batch_1=True),
               "cait": phase_serve_bench("cait_xxs_24", serve["cait"]["per_batch"]),
               "botnet": phase_serve_bench(BOTNET_MODEL, serve["botnet"]["per_batch"]),
               "cvt": phase_serve_bench(CVT_MODEL, serve["cvt"]["per_batch"]),
               "ceit": phase_serve_bench(CEIT_MODEL, serve["ceit"]["per_batch"]),
               "tnt": phase_serve_bench(TNT_MODEL, serve["tnt"]["per_batch"]),
               "mixer": phase_serve_bench(MIXER_MODEL, serve["mixer"]["per_batch"]),
               "moe": phase_serve_bench(MOE_MODEL, serve["moe"]["per_batch"])}
    _release_engines()
    mark("serve and serve benches")
    train = {"deit": phase_train(), "cait": phase_train(model_name="cait_xxs_24")}
    deit_source = _deit_source()
    with tempfile.TemporaryDirectory() as checkpoints:
        resume = phase_resume(deit_source, checkpoints)
        serve_ckpt = phase_serve_checkpoint(resume["directory"], serve["deit"]["per_batch"])
    _release_engines()
    evaluation = phase_eval(deit_source)
    dropout = phase_dropout(deit_source)
    devpre = phase_device_preprocess(deit_source)
    del deit_source
    train_bench = phase_train_bench()
    mark("DeiT-S and CaiT-XXS training, the run path and the train bench")
    with tempfile.TemporaryDirectory() as runs:
        chain = phase_supervised_chain(runs)
    mark("the supervised chain")
    with tempfile.TemporaryDirectory() as pretrain:
        adapted = phase_surgery(pretrain)
        train["vit384"] = phase_train(
            model_name=VIT384_MODEL, batch_size=VIT384_ACCUM * VIT384_BATCH,
            grad_accum=VIT384_ACCUM, image_size=384, overrides={"remat": True},
            warm_start=(pretrain, adapted), family="flash")
    remat = phase_remat_trade(adapted)
    del adapted
    mark("ViT-B/16@384 fine-tune and remat trade")
    from sav_tpu_torch.train import get_preset

    preset = get_preset(BOTNET_PRESET, num_train_images=BOTNET_ACCUM * TRAIN_BATCH * TRAIN_STEPS,
                        warmup_epochs=0, transpose_images=False,
                        log_every_steps=TRAIN_STEPS // 2, seed=0)
    train["botnet"] = phase_train(model_name=BOTNET_MODEL, family="rel",
                                  batch_size=preset.global_batch_size, grad_accum=BOTNET_ACCUM,
                                  config=preset)
    mark(f"{BOTNET_MODEL} training")
    # CvT-13, CeiT-S, TNT-S and Mixer-B/16 at their recipes' global batches,
    # in micro-batches of TRAIN_BATCH; Mixer's first step against itself in
    # f32 (it has no attention path to compare).
    for key, model_name, preset_name, accum, family in (
            ("cvt", CVT_MODEL, CVT_PRESET, CVT_ACCUM, CVT_FAMILY),
            ("ceit", CEIT_MODEL, CEIT_PRESET, CEIT_ACCUM, "fused"),
            ("tnt", TNT_MODEL, TNT_PRESET, TNT_ACCUM, "fused"),
            ("mixer", MIXER_MODEL, MIXER_PRESET, MIXER_ACCUM, "fused")):
        preset = get_preset(preset_name, num_train_images=accum * TRAIN_BATCH * TRAIN_STEPS,
                            warmup_epochs=0, transpose_images=False,
                            log_every_steps=TRAIN_STEPS // 2, seed=0)
        if preset.global_batch_size != accum * TRAIN_BATCH:
            raise AssertionError(f"{preset_name}'s global batch {preset.global_batch_size} is "
                                 f"not {accum} x {TRAIN_BATCH}")
        train[key] = phase_train(model_name=model_name, family=family,
                                 batch_size=preset.global_batch_size, grad_accum=accum,
                                 config=preset,
                                 reference="f32" if key == "mixer" else "dense")
        mark(f"{model_name} training")
    mark("BoTNet-T3, CvT-13, CeiT-S, TNT-S and Mixer-B/16 training")
    # The rotary and MoE ViTs at the smoke run's DeiT-S recipe (256, no
    # accumulation): 12 #1 and 12 #2 a step each.
    train["rope"] = phase_train(model_name=ROPE_MODEL)
    train["moe"] = phase_train(model_name=MOE_MODEL)
    mark("rotary and MoE ViT training")

    def by_path(kind):
        return {
            "serve": serve["deit"][kind], "train": train["deit"]["launches"][kind],
            "serve_cait": serve["cait"][kind], "train_cait": train["cait"]["launches"][kind],
            "train_vit384": train["vit384"]["launches"][kind],
            "serve_botnet": serve["botnet"][kind], "train_botnet": train["botnet"]["launches"][kind],
            "train_resumed_deit": resume[kind], "eval_deit": evaluation[kind],
            "train_dropout_deit": dropout[kind], "train_device_preprocess_deit": devpre[kind],
            "train_bench_deit": train_bench["bf16"]["launches"][kind],
            "train_bench_uint8_deit": train_bench["uint8"]["launches"][kind],
            "serve_bench": benches["deit"][kind], "serve_bench_cait": benches["cait"][kind],
            "serve_bench_botnet": benches["botnet"][kind], "serve_checkpoint_deit": serve_ckpt[kind],
            "serve_cvt": serve["cvt"][kind], "train_cvt": train["cvt"]["launches"][kind],
            "serve_bench_cvt": benches["cvt"][kind],
            "serve_ceit": serve["ceit"][kind], "train_ceit": train["ceit"]["launches"][kind],
            "serve_bench_ceit": benches["ceit"][kind],
            "serve_tnt": serve["tnt"][kind], "train_tnt": train["tnt"]["launches"][kind],
            "serve_bench_tnt": benches["tnt"][kind],
            "serve_mixer": serve["mixer"][kind], "train_mixer": train["mixer"]["launches"][kind],
            "serve_bench_mixer": benches["mixer"][kind],
            "serve_rope": serve["rope"][kind], "train_rope": train["rope"]["launches"][kind],
            "serve_moe": serve["moe"][kind], "train_moe": train["moe"]["launches"][kind],
            "serve_bench_moe": benches["moe"][kind],
            "train_supervised_chain_deit": chain[kind],
        }

    def total(kind):
        return sum(by_path(kind).values())

    def by_variant(kind):
        out = {}
        for run in (*serve.values(), *benches.values(), *train.values(), resume, evaluation,
                    dropout, serve_ckpt, devpre, *train_bench.values(), chain):
            for variant, n in run["variants"][kind].items():
                out[variant] = out.get(variant, 0) + n
        return out

    tensor_core = ("tensor_core for bf16: mma.sync.m16n8k16, bf16 operands, f32 "
                   "accumulators; cuda_core for f32")

    fwd = {
        "name": "fused_attention_fwd",
        "route": "cuda",
        "source": "sav_tpu_torch/csrc/fused_attention.cu",
        "replaces": "sav_tpu/ops/fused_attention.py:146",
        "tpu_kernel": "_fused_kernel",
        "variant": tensor_core + " and for bf16 at head dims above 128",
        "checked": True,
        "launches": total("fused"),
        "launches_by_variant": by_variant("fused"),
        "launches_by_path": by_path("fused"),
        "max_abs_err": fwd_err["train"],
        "shape": list(TRAIN_SHAPE),
        **_timed(times["fwd_train"]),
        "at_serve_shape": {"shape": list(SERVE_SHAPE), "max_abs_err": fwd_err["serve"],
                           **_timed(times["fwd_serve"])},
        "at_cait_class_attention": {
            "shape": list(CLASS_TRAIN_SHAPE), "max_abs_err": fwd_err["cait_class"],
            **_timed(times["fwd_class_train"]),
            "at_serve_shape": {"shape": list(CLASS_SERVE_SHAPE), **_timed(times["fwd_class_serve"])},
        },
        **{f"at_cvt_{key.replace(' ', '')}": {
            "shape": list(CVT_TRAIN_SHAPES[key]), "max_abs_err": fwd_err[f"cvt {key}"],
            **_timed(times[f"cvt {key} fwd"]),
            "at_serve_shape": {"shape": list(CVT_SERVE_SHAPES[key]),
                               "max_abs_err": fwd_err[f"cvt {key} serve"],
                               **_timed(times[f"cvt {key} serve"])},
        } for key in ("stage 2", "stage 3")},
        "at_cvt_stage1_not_taken": {"shape": list(CVT_TRAIN_SHAPES["stage 1"]),
                                    **_timed(times["cvt stage 1 fused"])},
        "at_ceit_class_attention": {
            "shape": list(LCA_TRAIN_SHAPE), "max_abs_err": fwd_err["ceit lca"],
            **_timed(times["ceit lca fwd"]),
            "at_serve_shape": {"shape": list(LCA_SERVE_SHAPE),
                               "max_abs_err": fwd_err["ceit lca serve"],
                               **_timed(times["ceit lca serve"])},
        },
        "at_tnt_s_inner": {
            "shape": list(TNT_TRAIN_SHAPE), "padded_head_dim": 8,
            "max_abs_err": fwd_err["tnt-s inner"], **_timed(times["tnt-s inner fwd"]),
            "at_serve_shape": {"shape": list(TNT_SERVE_SHAPE),
                               "max_abs_err": fwd_err["tnt-s inner serve"],
                               **_timed(times["tnt-s inner serve"])},
        },
        "at_tnt_b_inner": {"shape": list(TNT_B_TRAIN_SHAPE), "padded_head_dim": 16,
                           "max_abs_err": fwd_err["tnt-b inner"],
                           **_timed(times["tnt-b inner fwd"])},
    }
    bwd = {
        "name": "fused_attention_bwd",
        "route": "cuda",
        "source": "sav_tpu_torch/csrc/fused_attention_bwd.cu",
        "replaces": "sav_tpu/ops/fused_attention.py:351",
        "tpu_kernel": "_fused_bwd_kernel",
        "variant": tensor_core + " and for bf16 at head dims above 128",
        "checked": True,
        "launches": total("fused_bwd"),
        "launches_by_variant": by_variant("fused_bwd"),
        "launches_by_path": by_path("fused_bwd"),
        "max_abs_err": bwd_err["train"],
        "shape": list(TRAIN_SHAPE),
        **_timed(times["bwd_train"]),
        "at_cait_class_attention": {
            "shape": list(CLASS_TRAIN_SHAPE), "max_abs_err": bwd_err["cait_class"],
            **_timed(times["bwd_class_train"]),
        },
        "at_vit384_train_shape": {"shape": list(VIT384_SHAPE), **_timed(times["bwd_vit384"])},
        **{f"at_cvt_{key.replace(' ', '')}": {
            "shape": list(CVT_TRAIN_SHAPES[key]), "max_abs_err": bwd_err[f"cvt {key}"],
            **_timed(times[f"cvt {key} bwd"]),
        } for key in ("stage 2", "stage 3")},
        "at_ceit_class_attention": {"shape": list(LCA_TRAIN_SHAPE), "max_abs_err": bwd_err["ceit lca"],
                                    **_timed(times["ceit lca bwd"])},
        **{f"at_tnt_{v}_inner": {"shape": list(shape), "padded_head_dim": pad,
                                 "max_abs_err": bwd_err[f"tnt-{v} inner"],
                                 **_timed(times[f"tnt-{v} inner bwd"])}
           for v, shape, pad in (("s", TNT_TRAIN_SHAPE, 8), ("b", TNT_B_TRAIN_SHAPE, 16))},
    }
    th_fwd = {
        "name": "talking_heads_fwd",
        "route": "cuda",
        "source": "sav_tpu_torch/csrc/talking_heads.cu",
        "replaces": "sav_tpu/ops/talking_heads.py:67",
        "tpu_kernel": "_th_kernel",
        "variant": tensor_core + " and for bf16 outside 2, 3, 4, 6, 8 heads of up to 48",
        "checked": True,
        "launches": total("talking_heads"),
        "launches_by_variant": by_variant("talking_heads"),
        "launches_by_path": by_path("talking_heads"),
        "max_abs_err": th_err["fwd_train"],
        "shape": list(TH_TRAIN_SHAPE),
        **_timed(times["th_fwd_train"]),
        "at_serve_shape": {"shape": list(TH_SERVE_SHAPE), "max_abs_err": th_err["fwd_serve"],
                           **_timed(times["th_fwd_serve"])},
    }
    # #10 is two kernels in bf16: dq (with the row statistics, delta and the
    # dW partials), then dk/dv; each record times its kernel within the
    # backward beside its own plain version, and keeps the whole backward's
    # times (its plain version, the dense path's backward) under
    # whole_backward.
    th_bwd_times = times["th_bwd_train"]
    th_bwd = [{
        "name": name,
        "route": "cuda",
        "source": "sav_tpu_torch/csrc/talking_heads_bwd.cu",
        "replaces": "sav_tpu/ops/talking_heads.py:183",
        "tpu_kernel": "_th_bwd_kernel",
        "variant": (tensor_core + " (the one CUDA-core kernel computes every gradient)"
                    + ("" if counter == "talking_heads_bwd" else "; not launched for f32")),
        "checked": True,
        "launches": total(counter),
        "launches_by_variant": by_variant(counter),
        "launches_by_path": by_path(counter),
        "max_abs_err": max(th_err["train"][n] for n in outputs),
        "shape": list(TH_TRAIN_SHAPE),
        **_timed(th_bwd_times["kernels"][kind]),
        "whole_backward": _timed(th_bwd_times),
    } for name, counter, kind, outputs in (
        ("talking_heads_bwd_dq", "talking_heads_bwd", "dq", ("dq", "dw_pre", "dw_post")),
        ("talking_heads_bwd_dkv", "talking_heads_bwd_dkv", "dkv", ("dk", "dv")),
    )]
    flash_times = times["flash_vit384"]
    flash_common = {"route": "cuda", "checked": True, "shape": list(VIT384_SHAPE)}
    flash_fwd = {
        "name": "flash_attention_fwd",
        **flash_common,
        "source": "sav_tpu_torch/csrc/flash_attention.cu",
        "replaces": "sav_tpu/ops/flash_attention.py:86",
        "tpu_kernel": "_kernel",
        "variant": tensor_core,
        "launches": total("flash"),
        "launches_by_variant": by_variant("flash"),
        "launches_by_path": by_path("flash"),
        "max_abs_err": flash_err["fwd"],
        **_timed(flash_times["fwd"]),
        "at_deit_train_shape": {"shape": list(TRAIN_SHAPE), **_timed(times["flash_fwd_deit_train"])},
        "at_deit_serve_shape": {"shape": list(SERVE_SHAPE), **_timed(times["flash_fwd_deit_serve"])},
        "at_cvt_stage1": {"shape": list(CVT_TRAIN_SHAPES["stage 1"]),
                          "max_abs_err": flash_err["cvt stage 1"]["fwd"],
                          **_timed(times["cvt stage 1"]["fwd"]),
                          "at_serve_shape": {"shape": list(CVT_SERVE_SHAPES["stage 1"]),
                                             "max_abs_err": flash_err["cvt stage 1"]["fwd serve"],
                                             **_timed(times["cvt stage 1 serve"])}},
        **{f"at_cvt_{key.replace(' ', '')}_not_taken": {
            "shape": list(CVT_TRAIN_SHAPES[key]), **_timed(times[f"cvt {key} flash"])}
           for key in ("stage 2", "stage 3")},
    }
    flash_dq = {
        "name": "flash_attention_bwd_dq",
        **flash_common,
        "source": "sav_tpu_torch/csrc/flash_attention_bwd.cu",
        "replaces": "sav_tpu/ops/flash_attention.py:360",
        "tpu_kernel": "_bwd_dq_kernel",
        "variant": tensor_core,
        "launches": total("flash_dq"),
        "launches_by_variant": by_variant("flash_dq"),
        "launches_by_path": by_path("flash_dq"),
        "max_abs_err": flash_err["dq"],
        **_timed(flash_times["dq"]),
        "at_deit_train_shape": {"shape": list(TRAIN_SHAPE),
                                **_timed(times["flash_deit_train"]["dq"])},
        "at_cvt_stage1": {"shape": list(CVT_TRAIN_SHAPES["stage 1"]),
                          "max_abs_err": flash_err["cvt stage 1"]["dq"],
                          **_timed(times["cvt stage 1"]["dq"])},
    }
    flash_dkv = {
        "name": "flash_attention_bwd_dkv",
        **flash_common,
        "source": "sav_tpu_torch/csrc/flash_attention_bwd.cu",
        "replaces": "sav_tpu/ops/flash_attention.py:405",
        "tpu_kernel": "_bwd_dkv_kernel",
        "variant": tensor_core,
        "launches": total("flash_dkv"),
        "launches_by_variant": by_variant("flash_dkv"),
        "launches_by_path": by_path("flash_dkv"),
        "max_abs_err": flash_err["dkv"],
        **_timed(flash_times["dkv"]),
        "at_deit_train_shape": {"shape": list(TRAIN_SHAPE),
                                **_timed(times["flash_deit_train"]["dkv"])},
        "at_cvt_stage1": {"shape": list(CVT_TRAIN_SHAPES["stage 1"]),
                          "max_abs_err": flash_err["cvt stage 1"]["dkv"],
                          **_timed(times["cvt stage 1"]["dkv"])},
    }
    def rel_timed(kind):
        return {key: {"shape": list(shape), "max_abs_err": max(
                    v for n, v in rel_err[key].items() if n in REL_ERR_KEYS[kind]),
                      **_timed(times[f"rel {key}"][kind])}
                for key, shape in REL_TRAIN_SHAPES.items()}

    rel_common = {"route": "cuda", "checked": True}
    rel_records = []
    for kind, name, source, line, tpu_kernel, counter in (
        ("fwd", "rel_attention_fwd", "rel_attention.cu", 663, "_rel_kernel", "rel"),
        ("dq", "rel_attention_bwd_dq", "rel_attention_bwd.cu", 868, "_rel_bwd_dq_kernel", "rel_dq"),
        ("dkv", "rel_attention_bwd_dkv", "rel_attention_bwd.cu", 913, "_rel_bwd_dkv_kernel",
         "rel_dkv"),
    ):
        at = rel_timed(kind)
        main_shape = at.pop("L=196")
        record = {
            "name": name, **rel_common,
            "source": f"sav_tpu_torch/csrc/{source}",
            "replaces": f"sav_tpu/ops/flash_attention.py:{line}",
            "tpu_kernel": tpu_kernel,
            "variant": tensor_core,
            "launches_by_variant": by_variant(counter),
            "launches": total(counter),
            "launches_by_path": by_path(counter),
            **main_shape,
            "at_L49": at["L=49"],
        }
        if kind == "fwd":
            record["at_serve_shapes"] = {
                key: {"shape": list(shape), **_timed(times[f"rel {key} serve"])}
                for key, shape in REL_SERVE_SHAPES.items()}
        rel_records.append(record)
    steps = {name: {mode: {"step_ms": round(run["step_ms"], 3),
                           "images_per_sec": round(run["images_per_sec"], 1),
                           "peak_gb": round(run["peak_gb"], 2),
                           "busy_ms": round(run["profile"]["busy_ms"], 3),
                           "device_idle_pct": round(run["profile"]["idle_pct"], 2)}
                     for mode, run in (("captured", r), ("eager", r["eager"]))}
             for name, r in train.items()}
    for name, r in train.items():
        steps[name]["capture_s"] = round(r["capture_s"], 3)
        if r["routing"] is not None:
            steps[name]["routing_vs_dense"] = r["routing"]
            steps[name]["first_aux_loss"] = r["first_aux_loss"]
    steps["vit384"].update({k: round(v, 2) for k, v in remat.items()})
    steps["device_preprocess_deit"] = {"step_ms": round(devpre["step_ms"], 3),
                                       "images_per_sec": round(devpre["images_per_sec"], 1)}
    log(f"train summary (fit's steady window; one profiled step each): {json.dumps(steps)}")
    log("serve summary (bf16, buckets 1-32; steps in ms by bucket; bench: images/s and ms): "
        + json.dumps({name: {"steps": serve[name]["steps"], "compile_s": serve[name]["compile_s"],
                             "replay_busy_ms_at_32": round(serve[name]["profile"]["busy_ms"], 4),
                             **({"routing_vs_dense": serve[name]["routing"]}
                                if serve[name]["routing"] else {}),
                             **({"bench_rate": benches[name]["rate"], **benches[name]["runs"]}
                                if name in benches else {})}
                      for name in serve}))
    log(f"moe routing on the card: {json.dumps(moe_routing)}")
    log(f"supervised chain summary ({smi}): {json.dumps(chain['summary'])}")
    log("checkpoint and eval summary: " + json.dumps({
        "resume": {k: resume[k] for k in ("save_hold_ms", "warm_save_hold_ms", "write_ms",
                                          "warm_write_ms", "bytes", "restore_ms",
                                          "deterministic")},
        "eval_images_per_sec": round(evaluation["images_per_sec"], 1),
        "eval_dense_images_per_sec": round(evaluation["dense_images_per_sec"], 1),
        "dropout_kept_share": dropout["kept_share"]}))
    log(f"card: {smi}")
    log(json.dumps({"kernels": [fwd, bwd, th_fwd, *th_bwd, flash_fwd, flash_dq, flash_dkv,
                                *rel_records]}))
    log(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))


def main_supervised_chain() -> None:
    """``--supervised-chain``: the build of the fused kernels and the
    supervised chain alone."""
    from sav_tpu_torch.ops import _build

    smi = phase_device()
    _build.build_all(["fused_attention", "fused_attention_bwd"])
    with tempfile.TemporaryDirectory() as runs:
        chain = phase_supervised_chain(runs)
    log(f"supervised chain summary ({smi}): {json.dumps(chain['summary'])}")


def main_remat_trade() -> None:
    """``--remat-trade``: the remat trade alone, on seed-0 weights."""
    from sav_tpu_torch import create_model

    phase_device()
    phase_build()
    state_dict = create_model(VIT384_MODEL, image_size=384, seed=0).state_dict()
    print(json.dumps({k: round(v, 4) for k, v in phase_remat_trade(state_dict).items()}),
          flush=True)


if __name__ == "__main__":
    if sys.argv[1:] == ["--remat-trade"]:
        main_remat_trade()
    elif sys.argv[1:] == ["--supervised-chain"]:
        main_supervised_chain()
    elif sys.argv[1:]:
        raise SystemExit(f"chip_smoke: unknown arguments {sys.argv[1:]}; it takes none, "
                         "--remat-trade or --supervised-chain")
    else:
        main()
