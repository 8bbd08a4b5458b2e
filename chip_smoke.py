#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root. Phases, each printing what it found; any
failure exits non-zero without the final ``ok`` line:

1. device: the card's name, and name plus power limit from nvidia-smi;
2. build: the five kernel libraries, ``vae_channel_dynamics_tpu_torch/csrc/
   flash_attention_fwd.cu``, ``csrc/flash_attention_bwd.cu``,
   ``csrc/group_norm.cu``, ``csrc/fused_resnet.cu`` and ``csrc/conv_nhwc.cu``
   (nvcc, sm_90a, one nvcc each, started together), the seconds each took,
   and ptxas's registers and spills (none, and no stack frame, in the fp32
   flash forward); for the kernels on wgmma/TMA through
   ``csrc/sm90_wgmma.cuh`` (the fp32 flash forward, #9, #10 and #12 on the
   shared loop of ``csrc/sm90_conv3x3.cuh``, #11), the HGMMA, UTMALDG and
   HMMA instructions in their SASS (cuobjdump): HGMMA and UTMALDG present,
   no HMMA;
3. flash kernel vs plain: bf16 q/k/v from a seed at the serving shapes, the
   kernel's max abs and relative L2 error against
   ``flash_attention_reference`` (and proof that the bound rejects a kernel
   that drops one key tile), and both times from CUDA events;
3'. flash training kernels vs plain at (1, 16384, 512) and (4, 4096, 512):
   the LSE forward's lse, and dQ, dK, dV from the two backward kernels,
   against their plain versions, each bound shown to reject a planted fault
   (one query tile left out of dK/dV, delta left out of dS, the row max in
   place of lse); kernel, plain and library (``scaled_dot_product_attention``
   forward and backward, the backend named) times from CUDA events; and one
   mid-block ``AttentionBlock`` forward and backward on the card, flash
   against naive, every parameter gradient non-zero and within the naive
   path's own bf16-vs-fp32 difference;
4. serving slice: a full-width SDXL VAE with seeded random weights is written
   with the port's ``save_model_dir`` and served by the port's server at 512px
   (``attention_impl=auto``, ``max_batch`` 4, an ephemeral port). A
   sustained window of ``/reconstruct?format=npy`` from 8 closed-loop
   clients gives p50/p95 latency and req/s; then concurrent ``/encode`` and
   a ``/decode``. Every answer must be 200 with finite values of the right
   shape, and the flash kernel must have been launched while serving them;
   one batch's forward with the flash kernel is held against the naive path;
5. GroupNorm kernels vs plain, bf16, at the 128-channel full-resolution
   norm and the mid-block norm of both training paths (256px batch 16 and
   1024px batch 1), with SiLU and the |z| tap: each of the four kernels
   against its plain version, then the autograd op (y, the tap, dx, dgamma,
   dbeta) against the plain GroupNorm; every bound is also shown to reject a
   planted fault; the normalize kernel's split count S at each shape, its y
   and tap bit-equal run to run, y without the SiLU bit-equal to plain, and
   its tap's bound rejecting one split's partial left out; forward and
   backward times from CUDA events;
5'. the fused resnet kernels vs plain, bf16, at the 256px fused path's
   (16, 512, 32, 32) -> 512 and at (16, 256, 64, 64) -> 512: #9 with and
   without the residual, with the |z| tap and the moments (also bit-equal
   run to run), #10 on the flipped weight (also bit-equal run to run), #11
   (also bit-equal run to run), each bound shown to reject a planted fault
   (the border mask skipped, the halo rows tapped, the moments before the
   residual, the weight not flipped, dy's last 64-channel K chunk left out,
   the last pixel chunk left out); kernel, plain, bound and cuDNN times, and
   #10's device time by kernel (torch.profiler: its NHWC copy of dy, its
   loop); then the whole fused op against the unfused sequence (pallas
   GroupNorm, cuDNN conv, add), forward and forward+backward, at 32x32,
   64x64 and 128x128;
6. training slice: the full-width SDXL VAE (seeded fp32 master weights, bf16
   compute, GroupNorm ``impl="pallas"``) trains 30 steps at 256px, batch 16,
   on seeded uint8 batches, with bench.py's four norm1 taps, AdamW as
   configs/bench_256px.yaml, and 8 channels of one norm1 planted at gamma
   0.01. At steps 10, 20 and 30 the monitor, classifier and nudger run; the
   planted channels must be classified, gamma nudged to min(1.1 gamma, 1.5)
   on exactly the classified channels and nothing else changed, and every
   GroupNorm kernel launched during the steps;
7. one step on the kernel path against one on the plain path (the same
   weights, batch and noise), held to the plain path's own bf16-vs-fp32
   difference on that step; then 10 steps of each path in turns, timed, and
   a torch.profiler breakdown of one kernel-path step;
7'. one 256px step with ``kernel_impl: fused`` against one with ``pallas``
   (9 of the 24 resnets fused), held to the plain path's bf16-vs-fp32
   difference on loss, grad_norm and four fused blocks' parameter
   gradients; 10 steps of each in turns with their peak memory; a profile
   of a fused step;
7''. the fused Trainer slice: ``configs/bench_256px.yaml`` with
   ``kernel_impl: fused`` through ``vae_channel_dynamics_tpu_torch.train.main``
   for 20 steps, a seeded model dir with 8 channels of a fused block's
   norm1 planted, taps on two fused blocks' norm outputs (kernel #9's side
   output): every step launches #9, #10 and #11 18 times and #1, #4 and #5
   for the fused convs only, 9 blocks fuse a step, the planted channels are
   classified and nudged, the CSVs and the final model are written;
8. the 1024px Trainer slice: ``configs/experiment_1024_stretch.yaml`` with
   ``attention_impl: flash``, ``kernel_impl: pallas``, a seeded full-width
   SDXL model dir with planted channels, 20 steps and a checkpoint every 10,
   run in-process through ``vae_channel_dynamics_tpu_torch.train.main``;
   then again from ``chkpt-10`` into a second directory, and for two steps
   from a copy of ``chkpt-10`` with AdamW's moments zeroed. The resumed steps
   11-20 must match the uninterrupted ones within a bound that the zeroed
   moments exceed, every step must launch each
   flash training kernel twice and the GroupNorm kernels as many times as
   the model has norms (and their recompute under ``remat: full``), the
   serving forward never; the control loop's CSVs, the final model and
   ms/step, img/s and peak memory over steps 11-20;
9. one 1024px step with flash against one with naive attention (the same
   weights, batch and noise, ``remat: none``), held to naive bf16's own
   difference from naive fp32 on that step; 10 timed steps each of naive,
   flash, and flash with ``remat: full``, in turns, with their peak memory;
   a torch.profiler breakdown of a flash step.

10. kernel #12, the NHWC conv3x3 with bias (``csrc/conv_nhwc.cu``), after
   the fused resnet kernels: against its plain version at the conv bench's
   shapes A-D, with its three planted faults (the halo's zero-fill skipped,
   one tap's K chunk left out, the bias left out), bit-equal run to run,
   kernel, plain, bound and cuDNN ``channels_last`` times; then the ported
   conv bench (``experiments/conv_bench.py``) in-process, #12's main path;
11. the fp32 flash forward (3xTF32 on wgmma) against its plain version at
   (8, 4096, 512), the fp32 evaluation's shape, TF32 off, bit-equal run to
   run, with two planted faults (a dropped key tile, and the plain version
   with TF32 on: one TF32 product, what the kernel would give without its lo
   products), and its times beside plain, SDPA at fp32 and the 3xTF32
   bound;
12. evaluation at full width, after the serving slice: the seeded SDXL VAE
   written as a model dir, ``evaluate.main`` on 32 synthetic images at
   512px, batch 8: bf16 with ``attention_impl: auto`` (the bf16 flash
   forward in every forward) and the logit lens at its two default layers,
   then bf16 naive, fp32 naive and fp32 auto (the fp32 flash forward, the
   repaired fault); each metric held to fp32 naive (bf16 flash within the
   bf16 naive control), the PNG pairs, ``out_*.png`` and the lens tree
   present, images/s and peak memory;
13. tiled inference: a 2048px image through the wrapper with
   ``enable_tiling(512, 0.25)``, tiled encode and decode with the flash
   forward once a tile, against naive within the naive bf16-vs-fp32
   control; the tiled and untiled 2048px decode's peak memory; the serve CLI
   with ``--tile_size 512`` at ``--resolution 1024``.

The last lines are a JSON object describing the thirteen kernels, the
nvidia-smi line, and ``{"ok": true, "device": {...}}``. Imports no jax.
"""

from __future__ import annotations

import importlib.util
import io
import json
import math
import os
import gc
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import warnings
from concurrent.futures import ThreadPoolExecutor

SEED = 0
KERNEL_SHAPES = ((4, 4096, 512), (1, 16384, 512))
# Kernel vs plain, bf16: both round the output to bf16 and round the
# probabilities to bf16 before the product with v, the kernel unnormalised
# and the plain version normalised, so they differ by about one bf16 ulp of
# the largest output. The bound scales with the output: max abs error at
# most KERNEL_ULPS bf16 ulps of max|plain|, and relative L2 error at most
# KERNEL_REL_L2. A kernel that skips one 64-key tile gives a relative L2
# error near 8/sqrt(N) (0.125 at N=4096, 0.0625 at N=16384); every run checks
# that the bound rejects exactly that fault.
KERNEL_ULPS = 4
KERNEL_REL_L2 = 1e-2
FAULT_TILE = 64
# Flash vs naive through the whole bf16 SDXL forward, as relative L2 error.
# The random-weight decoder amplifies bf16 rounding: on an H100 the naive
# path's own bf16 reconstruction is 5.1% (rel L2) from its fp32 one, and the
# plain PyTorch chunked path (the kernel's online softmax, unfused) is 4.6%
# from naive. So flash is held to that chunked control, within
# MODEL_CONTROL_RATIO of it, and to an absolute MODEL_REL_L2_TOL.
MODEL_REL_L2_TOL = 1e-1
MODEL_CONTROL_RATIO = 1.25
RESOLUTION = 512
MAX_BATCH = 4
# the timed load: closed loop, twice max_batch clients so that a full batch
# waits while one runs
LOAD_CONCURRENCY = 2 * MAX_BATCH
LOAD_SECONDS = 40.0
N_IMAGES = 16
N_ENCODE = 4
N_DECODE = 2
# the card the slice runs on; a CPU rehearsal of the script's logic swaps it
DEVICE = "cuda"
FLASH_FWD_SOURCE = "vae_channel_dynamics_tpu_torch/csrc/flash_attention_fwd.cu"
FLASH_BWD_SOURCE = "vae_channel_dynamics_tpu_torch/csrc/flash_attention_bwd.cu"
FLASH_SOURCES = {
    "flash_attention_fwd": FLASH_FWD_SOURCE,
    "flash_attention_fwd_lse": FLASH_FWD_SOURCE,
    "flash_attention_bwd_dkv": FLASH_BWD_SOURCE,
    "flash_attention_bwd_dq": FLASH_BWD_SOURCE,
}
FLASH_REPLACES = {
    "flash_attention_fwd": "vae_channel_dynamics_tpu/ops/pallas_attention.py:136",
    "flash_attention_fwd_lse": "vae_channel_dynamics_tpu/ops/pallas_attention.py:177",
    "flash_attention_bwd_dkv": "vae_channel_dynamics_tpu/ops/pallas_attention.py:304",
    "flash_attention_bwd_dq": "vae_channel_dynamics_tpu/ops/pallas_attention.py:284",
}
# The card's published peaks (NVIDIA H100 SXM data sheet, dense, at 700 W):
# each kernel's bound is the larger of its FLOPs over the bf16 tensor-core
# rate and its bytes (each input read once, each output written once) over
# the memory rate.
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12  # outside the tensor cores: the GroupNorm kernels' math
PEAK_TF32_FLOPS = 495e12  # three TF32 products (3xTF32) give fp32 accuracy
PEAK_BYTES_PER_S = 3.35e12

# Flash training kernels vs plain, bf16, at the 1024px mid block's shape
# (the Trainer slice's) and the 512px one at batch 4. dQ, dK and dV are bf16
# sums of N fp32 products in another order than the plain matmul's, and P
# and dS round to bf16 the other way where exp differs in its last bit:
# max|kernel - plain| <= GRAD_MAX_REL max|plain| (4 bf16 ulps at the top of
# its binade) and relative L2 <= KERNEL_REL_L2. One 32-query tile left out of
# dK/dV costs about sqrt(32/N) in relative L2 (0.044 at N = 16384). lse is
# fp32: LSE_MAX_REL of max|plain|.
BWD_SHAPES = ((1, 16384, 512), (4, 4096, 512))
GRAD_MAX_REL = 2.0 ** -6
LSE_MAX_REL = 1e-5
FAULT_QUERIES = 32
BWD_ITERS = 10
# the AttentionBlock check: flash vs naive (bf16) within this many times
# naive bf16 vs naive fp32, plus a floor, per parameter gradient
BLOCK_CONTROL_RATIO = 1.25
BLOCK_FLOOR = 1e-3
BLOCK_SHAPE = (1, 512, 128, 128)  # the 1024px mid block's input, NCHW

# The 1024px Trainer slice (configs/experiment_1024_stretch.yaml, derived).
TRAINER_CONFIG = "configs/experiment_1024_stretch.yaml"
TRAINER_STEPS = 20
TRAINER_SAVE = 10
TRAINER_PROFILE_STEP = 5  # of the uninterrupted run, before the timed steps
# The resumed run repeats steps 11-20 from the same state and data. Every
# kernel of the path is free of atomics and the losses have matched bit for
# bit on an H100, so the bound is a few fp32 ulps (relative), which leaves
# room only for a backward convolution that sums in another order. Every run
# also resumes from the step-10 checkpoint with AdamW's moments zeroed, for
# FAULTY_STEPS steps, and checks that the bound rejects it.
RESUME_LOSS_REL = 1e-6
FAULTY_STEPS = 2
TRAINER_PLANTED_NORM = "encoder.down_blocks.0.resnets.0.norm1"
CSV_COLUMNS = ["global_step", "layer_identifier", "original_metric_name", "metric_type",
               "metric_value"]
# The SDXL VAE: 52 GroupNorms a forward, 48 of them in the resnets that
# remat: full runs again in the backward; 2 mid-block attentions.
SDXL_NORMS, SDXL_RESNET_NORMS, SDXL_ATTENTIONS = 52, 48, 2
FLASH_STEP_RES = 1024
FLASH_TIMED_STEPS = 5  # per block: naive, flash, flash, naive

# GroupNorm kernels vs plain, bf16, at both training paths' 128-channel
# full-resolution norm input (encoder down block 0, decoder up block 3) and
# their mid-block norm: the 256px batch-16 slice's, then the 1024px batch-1
# Trainer's, where one block per (sample, channel) plane gives 128 blocks of
# 1M elements each. The kernels line reports GN_ROW_SHAPE, the Trainer's,
# whose launches it counts. y and dx are bf16 outputs held to GN_ULPS bf16
# ulps of max|plain|, like the flash kernel; the fp32 sums (the reduce
# outputs, the |z| tap, dgamma, dbeta) to GN_SUM_REL of max|plain|: the
# summation order differs and gives about 1e-6. The normalize kernel splits
# each plane over S blocks where the planes alone do not fill the card (S =
# 16 and 2 at the 1024px shapes, 1 at the 256px ones); its tap's planted
# fault leaves the last split's partial out.
GN_SHAPES = ((16, 128, 256, 256), (16, 512, 32, 32), (1, 128, 1024, 1024), (1, 512, 128, 128))
GN_ROW_SHAPE = (1, 128, 1024, 1024)
GN_GROUPS = 32
GN_EPS = 1e-6
GN_ULPS = 4
GN_SUM_REL = 1e-3
GN_SOURCE = "vae_channel_dynamics_tpu_torch/csrc/group_norm.cu"
GN_REPLACES = {
    "gn_fwd_reduce": "vae_channel_dynamics_tpu/ops/pallas_group_norm.py:83",
    "gn_fwd_normalize": "vae_channel_dynamics_tpu/ops/pallas_group_norm.py:126",
    "gn_bwd_reduce": "vae_channel_dynamics_tpu/ops/pallas_group_norm.py:222",
    "gn_bwd_dx": "vae_channel_dynamics_tpu/ops/pallas_group_norm.py:245",
}
GN_ITERS = 20
# fp32 operations per element of each GroupNorm kernel, for its bound: the
# sums (2: x, x^2); the affine and SiLU (8: fma, exp, add, divide, multiply,
# |z| add); SiLU' and the two sums (12); SiLU' and the dx combination (14).
# Every one of them is bound by its bytes by a factor of ten or more.
GN_OPS = {"gn_fwd_reduce": 2, "gn_fwd_normalize": 8, "gn_bwd_reduce": 12, "gn_bwd_dx": 14}
# The training slice: bench.py's four norm1 taps (bench.py:78-104), AdamW as
# configs/bench_256px.yaml (lr 5e-5, warmup 10, clip 1.0, kl 1e-6), and the
# control loop of configs/base_tpu.yaml (threshold 0.2; gentle nudge 1.1,
# cap 1.5) every 10 steps.
TRAIN_RES = 256
TRAIN_BATCH = 16
TRAIN_STEPS = 30
TRAIN_BATCHES = 6
TRACK_INTERVAL = 10
TRAIN_LR, TRAIN_WARMUP, TRAIN_CLIP, TRAIN_KL = 5e-5, 10, 1.0, 1e-6
TRAIN_TAPS = (
    "vae.encoder.down_blocks.0.resnets.0.norm1",
    "vae.encoder.down_blocks.0.resnets.1.norm1",
    "vae.decoder.up_blocks.1.resnets.0.norm1",
    "vae.decoder.up_blocks.2.resnets.0.norm1",
)
PLANTED_NORM = "encoder.down_blocks.0.resnets.0.norm1"
PLANTED_CHANNELS = tuple(range(0, 128, 16))  # 8 channels, one in each of 8 groups
PLANTED_GAMMA = 0.01
CLASSIFY_THRESHOLD = 0.2
NUDGE_FACTOR, NUDGE_CAP = 1.1, 1.5
SDXL_PARAMS = 83_653_863
# kernel path vs plain path on one step, relative differences (rel L2 for
# the tap vectors), held to the plain path's own bf16-vs-fp32 difference on
# the same step: at most STEP_CONTROL_RATIO times it, plus a floor. The tap
# vectors (128-512 channels) concentrate, so their floor is small. Loss and
# grad_norm are single numbers: the difference of two bf16 runs of one step
# is a random quantity the control sizes only roughly, so they also get one
# bf16 ulp (2^-8) relative.
STEP_CONTROL_RATIO = 1.25
STEP_FLOOR = 1e-4
STEP_SCALAR_FLOOR = 2.0 ** -8
TIMED_STEPS = 5  # per block: plain, kernel, kernel, plain

# The fused GroupNorm+SiLU+conv3x3 resnet kernels (#9-#11) against their plain
# versions, bf16: the 256px fused path's shape (the nine 512-channel 32x32
# resnets at batch 16) and an asymmetric one, 256 -> 512 channels at 64x64.
# The bf16 outputs (y, ds) round the same fp32 sum, taken in another order:
# at most FUSED_ULPS bf16 ulps of max|plain| and relative L2 FUSED_REL_L2; the
# fp32 sums (the |z| tap, the moments, dW) FUSED_SUM_REL of max|plain|. Each
# bound is shown to reject a planted fault: #9 with the border mask skipped
# (out-of-image rows and columns enter the conv as silu(o)), the tap summed
# over the halo rows too, the moments taken before the residual; #10 with
# the weight not flipped, and with dy's last 64-channel K chunk left out; #11
# with the last pixel chunk left out.
FUSED_SOURCE = "vae_channel_dynamics_tpu_torch/csrc/fused_resnet.cu"
FUSED_REPLACES = {
    "fused_gn_silu_conv3x3": "vae_channel_dynamics_tpu/ops/pallas_resnet.py:173",
    "conv3x3": "vae_channel_dynamics_tpu/ops/pallas_resnet.py:361",
    "conv3x3_dw": "vae_channel_dynamics_tpu/ops/pallas_resnet.py:423",
}
FUSED_SHAPES = (((16, 512, 32, 32), 512), ((16, 256, 64, 64), 512))
FUSED_ULPS = 4
FUSED_REL_L2 = 1e-2
FUSED_SUM_REL = 1e-3
FUSED_ITERS = 10
# the whole fused op against the unfused sequence (the pallas GroupNorm
# kernels, cuDNN's conv, the residual add), C -> C channels
FUSED_OP_SHAPES = ((16, 512, 32, 32), (16, 512, 64, 64), (16, 512, 128, 128))
# The fused Trainer slice: configs/bench_256px.yaml with kernel_impl fused,
# taps on two fused blocks' norm outputs, 8 channels of the first planted.
FUSED_TRAINER_CONFIG = "configs/bench_256px.yaml"
FUSED_TRAINER_STEPS = 20
FUSED_TAPS = ("vae.decoder.up_blocks.0.resnets.0.norm1",
              "vae.encoder.mid_block.resnets.1.norm2")
FUSED_PLANTED_NORM = "decoder.up_blocks.0.resnets.0.norm1"
# the SDXL VAE at 256px: 24 resnets, the nine 512-channel ones at 32x32 fuse
SDXL_RESNETS, SDXL_FUSED_AT_256 = 24, 9

# Kernel #12, the NHWC conv3x3 with bias (csrc/conv_nhwc.cu), against its
# plain version (the nine shifted fp32 products) at the conv bench's four
# shapes, Cout = Cin, bias 0.5 N(0, 1) so that leaving it out shows. y is
# bf16, one rounding of an fp32 sum taken in another order: at most
# CONV_ULPS bf16 ulps of max|plain| and relative L2 CONV_REL_L2. Three planted
# faults must exceed that bound: the halo's zero-fill skipped (a shifted
# column wraps into the neighbouring row), one tap's K chunk (tap (1, 1),
# channels 0-31) left out, and the bias left out. Runs must be bit-equal.
CONV_SOURCE = "vae_channel_dynamics_tpu_torch/csrc/conv_nhwc.cu"
CONV_REPLACES = ("experiments/conv_bench.py:34 _conv_kernel_v9, "
                 ":72 _conv_kernel_v3")
CONV_SHAPES = ((8, 64, 64, 512), (8, 128, 128, 256), (8, 256, 256, 128), (8, 32, 32, 512))
CONV_ULPS = 4
CONV_REL_L2 = 1e-2
CONV_ITERS = 10
# Evaluation at full width: the seeded SDXL VAE on 32 synthetic images at
# 512px, batch 8, four times through evaluate.main: bf16 with auto (the bf16
# flash forward, every forward) and the logit lens at its two default
# layers; bf16 naive; fp32 naive; fp32 auto (the fp32 flash forward, the
# repaired fault). Each metric relative to fp32 naive: bf16 flash within
# EVAL_CONTROL_RATIO x bf16 naive's own difference plus EVAL_FLOOR (one bf16
# ulp, as the step checks' scalars); fp32 flash within EVAL_F32_REL.
EVAL_RES = 512
EVAL_IMAGES = 32
EVAL_BATCH = 8
EVAL_CONTROL_RATIO = 1.25
EVAL_FLOOR = 2.0 ** -8
EVAL_F32_REL = 1e-4
EVAL_LENS_LAYERS = ("encoder.down_blocks.0.resnets.0.norm1",
                    "encoder.down_blocks.1.resnets.0.conv_shortcut")
# The fp32 flash forward (#6 at fp32) against its plain version at the shape
# the fp32 `auto` evaluation gives it, the 512px mid block at EVAL_BATCH:
# (8, 4096, 512), TF32 off. The kernel takes each fp32 product as three TF32
# products (3xTF32, about 2^-22 of the product) and sums in another order
# than the plain matmul, about 1e-6 relative L2; two planted faults exceed
# the bound: one dropped 64-key tile, about 8/sqrt(N) (0.125), and one TF32
# product (the plain version with TF32 on), about 4e-4. Its bound is the
# 3xTF32 one, three times the products at the TF32 rate; the fp32 SIMT rate's
# is logged beside it.
FLASH_F32_SHAPE = (EVAL_BATCH, 4096, 512)
FLASH_F32_REL_L2 = 1e-5
FLASH_F32_REPLACES = "vae_channel_dynamics_tpu/ops/pallas_attention.py:136 _flash_kernel (fp32)"
FLASH_F32_ITERS = 5
# The kernels this slice redesigned. The line carries only what this run
# measured; the times before the redesign stay in PERF.md's table.
REDESIGNED = {
    "conv3x3": "redesigned in this slice (NHWC copy of dy and #12's wgmma/TMA loop, "
               "was mma.sync)",
    "gn_fwd_normalize": "redesigned in this slice (each plane split over S blocks where "
                        "B x C is small, 4 loads in flight a thread, was one block a plane)",
}
# Tiled inference at full width: a 2048px image through the wrapper with
# enable_tiling(512, 0.25), bf16: 25 encoder and 25 decoder tiles, the flash
# forward once a tile (4096 tokens); flash vs naive within the naive
# bf16-vs-fp32 control (as MODEL_CONTROL_RATIO) plus TILE_FLOOR. Then the
# serve CLI tiled at 1024px on SERVE_TILED_IMAGES images.
TILE_RES, TILE_SIZE, TILE_OVERLAP = 2048, 512, 0.25
TILE_COUNT = 25
TILE_FLOOR = 1e-3
SERVE_TILED_RES, SERVE_TILED_IMAGES = 1024, 4


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def sync() -> None:
    import torch

    if DEVICE == "cuda":
        torch.cuda.synchronize()


def bf16_ulp(x: float) -> float:
    """Spacing of bf16 values (8 significant bits) at magnitude ``x``."""
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def kernel_errors(out, ref) -> tuple[float, float]:
    """Max abs and relative L2 error of ``out`` against ``ref``."""
    d = out.float() - ref.float()
    return d.abs().max().item(), (d.norm() / ref.float().norm()).item()


def percentile(sorted_values, p: float) -> float:
    """Nearest-rank percentile of an ascending list."""
    return sorted_values[max(0, math.ceil(p * len(sorted_values)) - 1)]


def phase_device():
    import torch

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{name}; count {torch.cuda.device_count()}; nvidia-smi: {smi}")
    return name, smi


def kernel_label(mangled: str) -> str:
    """``name<arg>`` of a mangled ``*_kernel`` entry point (its name is the
    ``<length><name>`` whose name ends in ``_kernel``), else the mangled
    name."""
    for m in re.finditer(r"(?=(\d+)([a-z_]\w*))", mangled):
        size, rest = int(m.group(1)), m.group(2)
        name = rest[:size]
        if len(name) == size and name.endswith("_kernel"):
            arg = re.match(r"IL[ib](\d+)E", rest[size:])
            return name + (f"<{arg.group(1)}>" if arg else "")
    return mangled


# The kernels redesigned on wgmma/TMA (csrc/sm90_wgmma.cuh): their SASS must
# hold warpgroup MMAs (HGMMA) and TMA loads (UTMALDG), and no mma.sync (HMMA).
WGMMA_KERNELS = {"conv3x3_nhwc_kernel": "conv_nhwc", "conv3x3_dw_kernel": "fused_resnet",
                 "fused_gn_silu_conv3x3_kernel": "fused_resnet",
                 "conv3x3_nchw_kernel": "fused_resnet",
                 "flash_fwd_f32_kernel": "flash_attention_fwd"}
# ptxas must report no stack frame and no spills for these
NO_STACK_KERNELS = ("flash_fwd_f32_kernel",)
NO_STACK = "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"
SASS_OPS = ("HGMMA", "UTMALDG", "HMMA")


def sass_counts(library: str) -> dict:
    """{kernel label: {op: count}} of the built library's SASS, from
    cuobjdump beside nvcc."""
    from vae_channel_dynamics_tpu_torch.ops import _cuda_build

    cuobjdump = os.path.join(os.path.dirname(_cuda_build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", _cuda_build.library_path(library)],
                          capture_output=True, text=True, timeout=120, check=True).stdout
    counts, label = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            label = kernel_label(m.group(1))
            counts[label] = dict.fromkeys(SASS_OPS, 0)
        elif label is not None:
            for op in SASS_OPS:
                counts[label][op] += len(re.findall(rf"\b{op}\b", line))
    return counts


def phase_build():
    from vae_channel_dynamics_tpu_torch.ops import _cuda_build, flash_attention
    from vae_channel_dynamics_tpu_torch.ops import conv_nhwc as cn
    from vae_channel_dynamics_tpu_torch.ops import fused_resnet as fr
    from vae_channel_dynamics_tpu_torch.ops import group_norm_kernel as gnk

    # one nvcc per library, started together
    builds = {FLASH_FWD_SOURCE: (flash_attention.FWD_LIBRARY, flash_attention.build_forward),
              FLASH_BWD_SOURCE: (flash_attention.BWD_LIBRARY, flash_attention.build_backward),
              GN_SOURCE: (gnk.LIBRARY, gnk.build),
              FUSED_SOURCE: (fr.LIBRARY, fr.build),
              CONV_SOURCE: (cn.LIBRARY, cn.build)}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(builds)) as pool:
        for fut in [pool.submit(fn) for _lib, fn in builds.values()]:
            fut.result()
    wall = time.perf_counter() - t0
    for source, (lib, _fn) in builds.items():
        # ptxas -v: "Compiling entry function '<mangled>'", then the spill
        # line, then "Used N registers"
        entries, kernel, spills = [], "?", "?"
        for line in _cuda_build.build_logs.get(lib, "").splitlines():
            if "Compiling entry function" in line:
                kernel = kernel_label(line.split("'")[1])
            elif "spill stores" in line:
                spills = line.strip()
            elif "Used" in line and "registers" in line:
                regs = line.split("Used", 1)[1].split(",")[0].strip()
                entries.append(f"{kernel}: {regs}, {spills}")
                check(kernel.split("<")[0] not in NO_STACK_KERNELS or spills == NO_STACK,
                      f"{kernel} has a stack frame or spills: {spills}")
        log(f"[build] {source}: nvcc {_cuda_build.build_seconds.get(lib, 0.0):.2f} s; "
            f"ptxas per instantiation: {entries}")
    log(f"[build] {len(builds)} libraries built and loaded in {wall:.2f} s")
    for library in sorted(set(WGMMA_KERNELS.values())):
        for label, ops in sass_counts(library).items():
            base = label.split("<")[0]
            if base not in WGMMA_KERNELS:
                continue
            log(f"[build] SASS {label}: " + ", ".join(f"{op} {ops[op]}" for op in SASS_OPS))
            check(ops["HGMMA"] > 0 and ops["UTMALDG"] > 0 and ops["HMMA"] == 0,
                  f"{label} is not on the wgmma/TMA path: {ops}")


def phase_kernel():
    import torch

    from vae_channel_dynamics_tpu_torch.ops import flash_attention as fa

    results = {}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for b, n, c in KERNEL_SHAPES:
        q, k, v = (torch.randn(b, n, c, generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        scale = c ** -0.5
        out = fa.flash_attention(q, k, v, scale=scale, out_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        ref = fa.flash_attention_reference(q, k, v, scale, torch.bfloat16)
        check(torch.isfinite(out).all().item(), f"kernel output not finite at {(b, n, c)}")
        atol = KERNEL_ULPS * bf16_ulp(ref.float().abs().max().item())
        err, rel = kernel_errors(out, ref)
        # the plain version without the last key tile: what a kernel that
        # dropped one tile would return; the bound has to reject it
        fault = fa.flash_attention_reference(q, k[:, :-FAULT_TILE].contiguous(),
                                             v[:, :-FAULT_TILE].contiguous(),
                                             scale, torch.bfloat16)
        fault_err, fault_rel = kernel_errors(fault, ref)
        del fault

        def kernel():
            fa.flash_attention(q, k, v, scale=scale, out_dtype=torch.bfloat16)

        def plain():
            fa.flash_attention_reference(q, k, v, scale, torch.bfloat16)

        iters = 20
        # in turns: plain, kernel, kernel, plain
        p1 = cuda_ms(plain, iters)
        k1 = cuda_ms(kernel, iters)
        k2 = cuda_ms(kernel, iters)
        p2 = cuda_ms(plain, iters)
        ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
        backend, lib = sdpa_times(q, k, v, None, scale, iters)
        bound_ms, bound_by = flash_bounds(b, n, c)["flash_attention_fwd"]
        flops = 4 * b * n * n * c
        log(f"[kernel] (B={b}, N={n}, C={c}) max_abs_err {err:.6g} (tol {atol:.6g}, "
            f"{KERNEL_ULPS} bf16 ulps of max|plain|), rel L2 {rel:.6g} (tol {KERNEL_REL_L2}); "
            f"one dropped {FAULT_TILE}-key tile: max abs {fault_err:.6g}, rel L2 "
            f"{fault_rel:.6g}; kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s) "
            f"[{k1:.4f}, {k2:.4f}], plain {plain_ms:.4f} ms [{p1:.4f}, {p2:.4f}], "
            f"bound {bound_ms:.4f} ms ({bound_by}), SDPA forward ({backend}) "
            f"{lib['fwd']:.4f} ms")
        check(err <= atol and rel <= KERNEL_REL_L2,
              f"kernel disagrees with plain at {(b, n, c)}: max abs {err}, rel L2 {rel}")
        check(fault_err > atol or fault_rel > KERNEL_REL_L2,
              f"the kernel bound at {(b, n, c)} does not reject a dropped key tile")
        results[(b, n, c)] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                              "bound_ms": bound_ms, "bound_by": bound_by,
                              "library_ms": lib["fwd"]}
        del q, k, v, out, ref
    return results


def roofline(flops: float, nbytes: float, rate: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    """The least time (ms) the card could take: the larger of the operations
    over their peak rate (the bf16 tensor cores' by default) and the bytes
    over the memory rate, and which of the two it is."""
    t_ops = flops / rate * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def flash_bounds(b: int, n: int, c: int) -> dict:
    """Each flash kernel's bound at (B, N, C): FLOPs of its products, and
    bytes of its bf16 (B, N, C) operands and fp32 (B, N) row vectors."""
    t, r = 2 * b * n * c, 4 * b * n
    return {
        "flash_attention_fwd": roofline(4 * b * n * n * c, 4 * t),
        "flash_attention_fwd_lse": roofline(4 * b * n * n * c, 4 * t + r),
        "flash_attention_bwd_dkv": roofline(8 * b * n * n * c, 6 * t + 2 * r),
        "flash_attention_bwd_dq": roofline(6 * b * n * n * c, 5 * t + 2 * r),
    }


_SDPA_BACKEND = []


def sdpa_backend():
    """The first of PyTorch's SDPA backends that runs a bf16 forward and
    backward at head dim 512 on this card (the library yardstick; the port
    never calls it)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    if not _SDPA_BACKEND:
        x = torch.randn(1, 1, 256, 512, device=DEVICE, dtype=torch.bfloat16,
                        requires_grad=True)
        for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                        SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
            try:
                # a refusing backend warns its reasons before it raises
                with sdpa_kernel([backend]), warnings.catch_warnings():
                    warnings.simplefilter("ignore", UserWarning)
                    F.scaled_dot_product_attention(x, x, x).sum().backward()
                sync()
            except RuntimeError as e:
                log(f"[sdpa] {backend.name} refuses head dim 512: {str(e).splitlines()[0][:120]}")
                continue
            _SDPA_BACKEND.append(backend)
            break
        check(bool(_SDPA_BACKEND), "no SDPA backend runs at head dim 512")
    return _SDPA_BACKEND[0]


def sdpa_times(q, k, v, do, scale: float, iters: int) -> tuple[str, dict]:
    """CUDA-event ms of ``scaled_dot_product_attention`` on (B, N, C) as one
    head: the forward without autograd; with ``do``, also the forward that
    keeps what its backward needs and that backward (dQ, dK, dV)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import sdpa_kernel

    backend = sdpa_backend()
    q4, k4, v4 = (t.unsqueeze(1) for t in (q, k, v))
    out = {}
    with sdpa_kernel([backend]):
        def fwd():
            with torch.no_grad():
                F.scaled_dot_product_attention(q4, k4, v4, scale=scale)

        out["fwd"] = cuda_ms(fwd, iters)
        if do is not None:
            leaves = [t.detach().requires_grad_(True) for t in (q4, k4, v4)]
            out["fwd_grad"] = cuda_ms(
                lambda: F.scaled_dot_product_attention(*leaves, scale=scale), iters)
            o = F.scaled_dot_product_attention(*leaves, scale=scale)
            g = do.unsqueeze(1)
            out["bwd"] = cuda_ms(
                lambda: torch.autograd.grad(o, leaves, g, retain_graph=True), iters)
            del o, leaves
    return backend.name, out


def rel_errors(out, ref) -> tuple[float, float, float]:
    """max|out - ref| / max|ref|, relative L2 error, and max|out - ref|."""
    d = out.float() - ref.float()
    r = ref.float()
    return ((d.abs().max() / r.abs().max()).item(), (d.norm() / r.norm()).item(),
            d.abs().max().item())


def phase_flash_bwd():
    """The flash training kernels against their plain versions at
    BWD_SHAPES, with planted faults, CUDA-event times and the SDPA
    yardstick; then one AttentionBlock forward and backward on the card."""
    import torch

    from vae_channel_dynamics_tpu_torch.ops import flash_attention as fa

    names = ("flash_attention_fwd_lse", "flash_attention_bwd_dkv", "flash_attention_bwd_dq")
    results = {name: {"max_abs_err": 0.0} for name in names}
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 10)
    for shape in BWD_SHAPES:
        b, n, c = shape
        q, k, v, do = (torch.randn(shape, generator=gen, device=DEVICE).to(torch.bfloat16)
                       for _ in range(4))
        scale = c ** -0.5
        lines = []

        def held(name, what, errs, fault_errs, max_rel_bound, rel_l2_bound=KERNEL_REL_L2):
            max_rel, rel_l2, abs_err = errs
            results[name]["max_abs_err"] = max(results[name]["max_abs_err"], abs_err)
            lines.append(f"{what}: max rel {max_rel:.3g} (bound {max_rel_bound:.3g}), rel L2 "
                         f"{rel_l2:.3g} (bound {rel_l2_bound:.3g}); "
                         + ", ".join(f"{fault}: max rel {f[0]:.3g}, rel L2 {f[1]:.3g}"
                                     for fault, f in fault_errs.items()))
            check(max_rel <= max_rel_bound and rel_l2 <= rel_l2_bound,
                  f"{what} disagrees with plain at {shape}: {errs}")
            for fault, f in fault_errs.items():
                check(f[0] > max_rel_bound or f[1] > rel_l2_bound,
                      f"the {what} bound at {shape} does not reject {fault}")

        # the training forward: o and lse; fault: the row max m in place of lse
        o, lse = fa.flash_attention_fwd_lse(q, k, v, scale=scale, out_dtype=torch.bfloat16)
        sync()
        po, plse = fa.flash_attention_fwd_lse_reference(q, k, v, scale, torch.bfloat16)
        row_max = (torch.matmul(q.float(), k.float().transpose(1, 2)) * scale).amax(dim=-1)
        held("flash_attention_fwd_lse", "lse", rel_errors(lse, plse),
             {"m in place of lse": rel_errors(row_max, plse)}, LSE_MAX_REL, LSE_MAX_REL)
        max_rel, rel_l2, abs_err = rel_errors(o, po)
        lines.append(f"o: max rel {max_rel:.3g}, rel L2 {rel_l2:.3g}")
        check(rel_l2 <= KERNEL_REL_L2 and max_rel <= GRAD_MAX_REL,
              f"the LSE forward's o disagrees with plain at {shape}")

        # the backward kernels on the kernel's own lse and delta
        delta = (do.float() * o.float()).sum(-1)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale=scale)
        dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, scale=scale)
        sync()
        pdq, pdk, pdv = fa.flash_attention_bwd_reference(q, k, v, do, lse, delta, scale)
        # faults: one query tile left out of dK/dV; delta left out of dS; m
        # in place of lse
        fs = FAULT_QUERIES
        _, tile_dk, tile_dv = fa.flash_attention_bwd_reference(
            q[:, fs:], k, v, do[:, fs:], lse[:, fs:], delta[:, fs:], scale)
        nod_dq, nod_dk, _ = fa.flash_attention_bwd_reference(
            q, k, v, do, lse, torch.zeros_like(delta), scale)
        m_dq, m_dk, m_dv = fa.flash_attention_bwd_reference(q, k, v, do, row_max, delta, scale)
        held("flash_attention_bwd_dkv", "dK", rel_errors(dk, pdk),
             {"a query tile left out": rel_errors(tile_dk, pdk),
              "delta left out": rel_errors(nod_dk, pdk), "m for lse": rel_errors(m_dk, pdk)},
             GRAD_MAX_REL)
        held("flash_attention_bwd_dkv", "dV", rel_errors(dv, pdv),
             {"a query tile left out": rel_errors(tile_dv, pdv),
              "m for lse": rel_errors(m_dv, pdv)}, GRAD_MAX_REL)
        held("flash_attention_bwd_dq", "dQ", rel_errors(dq, pdq),
             {"delta left out": rel_errors(nod_dq, pdq), "m for lse": rel_errors(m_dq, pdq)},
             GRAD_MAX_REL)
        del po, plse, row_max, pdq, pdk, pdv, tile_dk, tile_dv, nod_dq, nod_dk, m_dq, m_dk, m_dv
        release()

        # times, in turns: plain, kernel, kernel, plain
        times = {
            "flash_attention_fwd_lse": timed_pair(
                lambda: fa.flash_attention_fwd_lse(q, k, v, scale=scale,
                                                   out_dtype=torch.bfloat16),
                lambda: fa.flash_attention_fwd_lse_reference(q, k, v, scale, torch.bfloat16),
                BWD_ITERS),
            "flash_attention_bwd_dkv": timed_pair(
                lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale=scale),
                lambda: fa.flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta, scale),
                BWD_ITERS),
            "flash_attention_bwd_dq": timed_pair(
                lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, scale=scale),
                lambda: fa.flash_attention_bwd_dq_reference(q, k, v, do, lse, delta, scale),
                BWD_ITERS),
        }
        backend, lib = sdpa_times(q, k, v, do, scale, BWD_ITERS)
        bounds = flash_bounds(b, n, c)
        # SDPA's backward gives dQ, dK and dV in one call, so it stands beside
        # both backward kernels and is compared with their sum
        both = "flash_attention_bwd_dkv + flash_attention_bwd_dq"
        library = {"flash_attention_fwd_lse": (lib["fwd_grad"], "flash_attention_fwd_lse"),
                   "flash_attention_bwd_dkv": (lib["bwd"], both),
                   "flash_attention_bwd_dq": (lib["bwd"], both)}
        if shape == BWD_SHAPES[0]:
            for name in names:
                results[name].update(shape=list(shape), ms=times[name][0],
                                     plain_ms=times[name][1], bound_ms=bounds[name][0],
                                     bound_by=bounds[name][1], library_ms=library[name][0],
                                     library_covers=library[name][1])
        log(f"[flash-bwd] {shape} bf16: " + "; ".join(lines))
        log(f"[flash-bwd] {shape} ms kernel/plain/bound (CUDA events, {BWD_ITERS} calls, in "
            "turns): " + ", ".join(
                f"{name} {times[name][0]:.4f}/{times[name][1]:.4f}/{bounds[name][0]:.4f} "
                f"({100 * bounds[name][0] / times[name][0]:.1f}% of bound)" for name in names)
            + f"; SDPA ({backend}) forward {lib['fwd']:.4f}, forward for backward "
            f"{lib['fwd_grad']:.4f}, backward {lib['bwd']:.4f}, forward+backward "
            f"{lib['fwd_grad'] + lib['bwd']:.4f}; kernels forward+backward "
            f"{sum(times[name][0] for name in names):.4f}")
        del q, k, v, do, o, lse, delta, dq, dk, dv
        release()
    phase_attention_block()
    return results


def set_attention(model, impl: str):
    from vae_channel_dynamics_tpu_torch.models.vae import AttentionBlock

    for module in model.modules():
        if isinstance(module, AttentionBlock):
            module.attn_impl = impl
    return model


def phase_attention_block():
    """One mid-block AttentionBlock (C=512, 128x128 tokens: the 1024px mid
    block) forward and backward, bf16, flash against naive on the same
    weights and input; the control is naive bf16 against naive fp32."""
    import torch

    from vae_channel_dynamics_tpu_torch.models.vae import AttentionBlock, Linear
    from vae_channel_dynamics_tpu_torch.ops import flash_attention as fa

    channels = BLOCK_SHAPE[1]
    blk = AttentionBlock(channels, 32, 1e-6, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 11)
    with torch.no_grad():
        for module in blk.modules():
            if hasattr(module, "init_weights"):
                module.init_weights(gen)
        blk.group_norm.weight.add_(0.1 * torch.randn(channels, generator=gen, device=DEVICE))
    x = torch.randn(BLOCK_SHAPE, generator=gen, device=DEVICE)
    g = torch.randn(x.shape, generator=gen, device=DEVICE)

    def run(impl, dtype):
        blk.attn_impl = impl
        for module in blk.modules():
            if isinstance(module, Linear):
                module.compute_dtype = dtype
        blk.zero_grad(set_to_none=True)
        xx = x.to(dtype).requires_grad_(True)
        out = blk(xx)
        out.backward(g.to(out.dtype))
        sync()
        grads = {name: p.grad.float().clone() for name, p in blk.named_parameters()}
        grads["input"] = xx.grad.float()
        return grads

    before = dict(fa.launches)
    flash = run("flash", torch.bfloat16)
    counts = {k: fa.launches[k] - before[k] for k in fa.launches}
    naive = run("naive", torch.bfloat16)
    fp32 = run("naive", torch.float32)
    check(counts == {"flash_attention_fwd": 0, "flash_attention_fwd_f32": 0,
                     "flash_attention_fwd_lse": 1, "flash_attention_bwd_dkv": 1,
                     "flash_attention_bwd_dq": 1},
          f"the AttentionBlock's flash step launched {counts}")
    rows = []
    for name in flash:
        d = ((flash[name] - naive[name]).norm() / naive[name].norm()).item()
        control = ((naive[name] - fp32[name]).norm() / fp32[name].norm()).item()
        nonzero = flash[name].abs().max().item()
        rows.append(f"{name} {d:.3g} (control {control:.3g})")
        check(nonzero > 0, f"the flash AttentionBlock's {name} gradient is zero")
        check(d <= BLOCK_CONTROL_RATIO * control + BLOCK_FLOOR,
              f"the flash AttentionBlock's {name} gradient is {d} from naive, control {control}")
    log(f"[attention-block] 1024px mid block {BLOCK_SHAPE} bf16, flash vs naive "
        f"gradients, rel L2 (control naive bf16 vs fp32; bound {BLOCK_CONTROL_RATIO} x control "
        f"+ {BLOCK_FLOOR}); launches {counts}: " + ", ".join(rows))
    del blk, x, g, flash, naive, fp32
    release()


def _post(port: int, path: str, body: bytes):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=body, method="POST",
        headers={"Content-Type": "application/octet-stream"},
    )
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as resp:
        data = resp.read()
        return resp.status, data, time.perf_counter() - t0


def _npy(arr) -> bytes:
    import numpy as np

    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def _load_npy(data: bytes):
    import numpy as np

    return np.load(io.BytesIO(data))


def phase_slice(tmp: str):
    import numpy as np
    import torch

    from vae_channel_dynamics_tpu_torch import server as srv_mod
    from vae_channel_dynamics_tpu_torch.models import SDXLVAEWrapper, VAEConfig
    from vae_channel_dynamics_tpu_torch.models import io as model_io
    from vae_channel_dynamics_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    config = VAEConfig.sdxl()
    master = SDXLVAEWrapper(config, dtype=torch.float32, seed=SEED, device=DEVICE)
    n_params = sum(p.numel() for p in master.model.parameters())
    model_io.save_model_dir(tmp, config, master.state_dict())
    del master
    log(f"[slice] sdxl VAE, {n_params} parameters from seed {SEED}, written to a "
        f"model dir in {time.perf_counter() - t0:.1f} s")

    args = srv_mod.parse_args([
        "--checkpoint_path", tmp, "--resolution", str(RESOLUTION),
        "--max_batch", str(MAX_BATCH), "--port", "0", "--attention_impl", "auto",
        "--device", DEVICE,
    ])
    server = srv_mod.build_server(args)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        check(server.wrapper.attn_impl == "flash",
              f"auto resolved to {server.wrapper.attn_impl!r} at {RESOLUTION}px")
        t0 = time.perf_counter()
        server.warmup()
        log(f"[slice] server on port {server.port}, attention "
            f"{server.wrapper.attn_impl}, warmed up in {time.perf_counter() - t0:.1f} s")

        rng = np.random.default_rng(SEED)
        images = [rng.uniform(-1, 1, (RESOLUTION, RESOLUTION, 3)).astype(np.float32)
                  for _ in range(N_IMAGES)]
        bodies = [_npy(im) for im in images]
        latent_side = RESOLUTION // 8

        def answer(path, status, data, want):
            check(status == 200, f"{path} answered {status}")
            arr = _load_npy(data)
            check(arr.shape == want, f"{path} returned shape {arr.shape}, want {want}")
            check(bool(np.isfinite(arr).all()), f"{path} returned non-finite values")
            return arr

        # ---- the main path: counts reset, requests served, counts read ----
        for name in fa.launches:
            fa.launches[name] = 0
        # a sustained closed-loop window: each client sends its next
        # /reconstruct as soon as the last one is answered, until the window
        # closes; every request started in the window is counted
        t_start = time.perf_counter()
        deadline = t_start + LOAD_SECONDS

        def client(i):
            lat, j = [], i
            while time.perf_counter() < deadline:
                status, data, dt = _post(server.port, "/reconstruct?format=npy",
                                         bodies[j % len(bodies)])
                answer("/reconstruct", status, data, (RESOLUTION, RESOLUTION, 3))
                lat.append(dt)
                j += LOAD_CONCURRENCY
            return lat, time.perf_counter()

        with ThreadPoolExecutor(max_workers=LOAD_CONCURRENCY) as pool:
            clients = list(pool.map(client, range(LOAD_CONCURRENCY)))
        wall = max(end for _lat, end in clients) - t_start
        lat = sorted(dt for c_lat, _end in clients for dt in c_lat)
        p50_ms, p95_ms = percentile(lat, 0.50) * 1e3, percentile(lat, 0.95) * 1e3
        rps = len(lat) / wall
        log(f"[slice] sustained /reconstruct?format=npy at {RESOLUTION}px, "
            f"{LOAD_CONCURRENCY} concurrent clients, {LOAD_SECONDS:.0f} s window: "
            f"{len(lat)} requests all 200 in {wall:.3f} s, p50 {p50_ms:.1f} ms, "
            f"p95 {p95_ms:.1f} ms, {rps:.3f} req/s")

        # the other endpoints: concurrent /encode, then /decode of their latents
        with ThreadPoolExecutor(max_workers=N_ENCODE) as pool:
            encoded = list(pool.map(lambda b: _post(server.port, "/encode", b),
                                    bodies[:N_ENCODE]))
        latents = [answer("/encode", status, data, (latent_side, latent_side, 4))
                   for status, data, _dt in encoded]
        pil = importlib.util.find_spec("PIL") is not None
        for z in latents[:N_DECODE]:
            if pil:
                status, data, _dt = _post(server.port, "/decode", _npy(z))
                check(status == 200, f"/decode answered {status}")
                from PIL import Image

                img = np.asarray(Image.open(io.BytesIO(data)))
                check(img.shape == (RESOLUTION, RESOLUTION, 3),
                      f"/decode returned an image of shape {img.shape}")
            else:
                img = server.batcher.submit("decode", z)
                check(img.shape == (RESOLUTION, RESOLUTION, 3) and np.isfinite(img).all(),
                      f"decode returned shape {img.shape} or non-finite values")
        counts = dict(fa.launches)
        launches = counts.pop("flash_attention_fwd")
        check(not any(counts.values()), f"serving launched training kernels: {counts}")
        with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/healthz",
                                    timeout=60) as resp:
            health = json.loads(resp.read())
            check(resp.status == 200 and health["status"] == "ok", f"/healthz: {health}")
        log(f"[slice] {N_ENCODE} concurrent /encode all 200; {len(latents[:N_DECODE])} "
            f"/decode via {'HTTP' if pil else 'batcher.submit (no Pillow)'}; "
            f"/healthz {health}; stats {server.stats()}")
        log(f"[slice] flash kernel launches while serving: {launches}")
        check(launches > 0, "the flash kernel was not launched on the served path")
    finally:
        server.shutdown()
        thread.join(timeout=30)

    # ---- flash vs naive (and the chunked control) on one full-width batch ----
    config, state_dict = model_io.load_model_dir(tmp)
    x = torch.from_numpy(np.stack(images[:MAX_BATCH]))
    outs = {"flash": server.wrapper.forward(x, sample_posterior=False)}
    for impl in ("naive", "chunked"):
        wrapper = SDXLVAEWrapper(config, state_dict=state_dict, dtype=torch.bfloat16,
                                 attn_impl=impl, device=DEVICE)
        outs[impl] = wrapper.forward(x, sample_posterior=False)
        del wrapper

    def rel_l2(a, b):
        a, b = a.float(), b.float()
        return ((a - b).norm() / b.norm()).item()

    for key in ("latents_sampled", "reconstruction"):
        flash, naive = outs["flash"][key], outs["naive"][key]
        check(bool(torch.isfinite(flash).all()), f"flash {key} not finite")
        rel = rel_l2(flash, naive)
        control = rel_l2(outs["chunked"][key], naive)
        log(f"[slice] flash vs naive {key} {tuple(flash.shape)}: rel L2 {rel:.4g} "
            f"(chunked vs naive {control:.4g}; tol {MODEL_CONTROL_RATIO} x control "
            f"and {MODEL_REL_L2_TOL}), max abs "
            f"{(flash.float() - naive.float()).abs().max().item():.4g}, "
            f"max |naive| {naive.float().abs().max().item():.4g}")
        check(rel <= MODEL_REL_L2_TOL and rel <= MODEL_CONTROL_RATIO * control,
              f"flash and naive {key} disagree: rel L2 {rel} (control {control})")
    return launches


def sum_rel_err(out, ref) -> float:
    """Max abs error of fp32 sums relative to max|plain|."""
    ref = ref.float()
    return ((out.float() - ref).abs().max() / ref.abs().max()).item()


def max_abs_err(out, ref) -> float:
    return (out.float() - ref.float()).abs().max().item()


def bf16_err(out, ref) -> tuple[float, float]:
    """Max abs error of a bf16 output and its bound: GN_ULPS bf16 ulps of
    max|plain|."""
    return max_abs_err(out, ref), GN_ULPS * bf16_ulp(ref.float().abs().max().item())


def timed_pair(kernel, plain, iters: int = GN_ITERS) -> tuple[float, float]:
    """ms per call of ``kernel`` and ``plain`` from CUDA events, in turns:
    plain, kernel, kernel, plain."""
    p1, k1, k2, p2 = (cuda_ms(f, iters) for f in (plain, kernel, kernel, plain))
    return (k1 + k2) / 2, (p1 + p2) / 2


def phase_gn_kernels():
    """Each GroupNorm kernel against its plain version on the same inputs,
    then the autograd op against the plain GroupNorm, at GN_SHAPES in bf16;
    every bound is shown to reject a planted fault."""
    import torch

    from vae_channel_dynamics_tpu_torch.ops import group_norm_kernel as gnk
    from vae_channel_dynamics_tpu_torch.ops.group_norm import group_norm_reference

    results = {name: {"max_abs_err": 0.0} for name in gnk.KERNELS}
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    for shape in GN_SHAPES:
        b, c, h, w = shape
        x = (torch.randn(shape, generator=gen, device=DEVICE) * 2.0 + 0.5).to(torch.bfloat16)
        g = torch.randn(shape, generator=gen, device=DEVICE).to(torch.bfloat16)
        scale = 1.0 + 0.1 * torch.randn(c, generator=gen, device=DEVICE)
        bias = 0.1 * torch.randn(c, generator=gen, device=DEVICE)
        # the per-(sample, channel) coefficients from the plain sums
        sums, sqs = gnk.fwd_reduce_reference(x)
        mean, rstd = gnk._group_stats(sums, sqs, h * w, GN_GROUPS, GN_EPS)
        a, off = gnk._affine_coeffs(mean, rstd, scale, bias, GN_GROUPS)
        lines = []

        def record(name, err, bound, fault_err, what, abs_err):
            # the kernels line reports each kernel's max abs error; the bound
            # is on ``err`` (relative for the fp32 sums)
            results[name]["max_abs_err"] = max(results[name]["max_abs_err"], abs_err)
            lines.append(f"{name} {what}: err {err:.4g} (bound {bound:.4g}), "
                         f"planted fault {fault_err:.4g}")
            check(err <= bound, f"{name} {what} disagrees with plain at {shape}: {err} > {bound}")
            check(fault_err > bound, f"the {name} {what} bound at {shape} does not reject "
                                     f"its planted fault ({fault_err} <= {bound})")

        # 1. fwd reduce; fault: the last 1/128 of each plane's rows (at least
        # one) left out
        ks, kq = gnk.fwd_reduce(x)
        sync()
        fs, _fq = gnk.fwd_reduce_reference(x[:, :, :-max(1, h // 128)])
        record("gn_fwd_reduce", max(sum_rel_err(ks, sums), sum_rel_err(kq, sqs)), GN_SUM_REL,
               sum_rel_err(fs, sums), "sum x, sum x^2 (rel)",
               max(max_abs_err(ks, sums), max_abs_err(kq, sqs)))
        # 2-3. normalize with SiLU and the |z| tap; faults: b left out of y,
        # |z| taken after the SiLU
        ky, kabs = gnk.fwd_normalize(x, a, off, True, True)
        sync()
        py, pabs = gnk.fwd_normalize_reference(x, a, off, True, True)
        fy, _ = gnk.fwd_normalize_reference(x, a, torch.zeros_like(off), True, False)
        err, bound = bf16_err(ky, py)
        record("gn_fwd_normalize", err, bound, bf16_err(fy, py)[0], "y (bf16)", err)
        z = x.float() * a[:, :, None, None] + off[:, :, None, None]
        fabs = (z * torch.sigmoid(z)).abs().sum(dim=(2, 3))
        del z
        record("gn_fwd_normalize", sum_rel_err(kabs, pabs), GN_SUM_REL,
               sum_rel_err(fabs, pabs), "sum |z| tap (rel)", max_abs_err(kabs, pabs))
        # the normalize kernel's split of each plane over S blocks: y and the
        # tap bit-equal run to run (the partials are added in split order), y
        # without the SiLU bit-equal to plain (x*a + b rounded as plain
        # rounds it, then one cast); fault: the last split's partial left out
        splits = gnk.normalize_splits(b * c, h * w, x.element_size())
        ky2, kabs2 = gnk.fwd_normalize(x, a, off, True, True)
        ky0, kabs0 = gnk.fwd_normalize(x, a, off, False, True)
        sync()
        check(torch.equal(ky, ky2) and torch.equal(kabs, kabs2),
              f"gn_fwd_normalize differs between two runs at {shape}")
        py0, pabs0 = gnk.fwd_normalize_reference(x, a, off, False, True)
        check(torch.equal(ky0, py0),
              f"gn_fwd_normalize without the SiLU is not bit-equal to plain at {shape}")
        last = (splits - 1) * gnk.split_chunk(h * w, splits)
        z = x.flatten(2)[:, :, last:].float() * a[:, :, None] + off[:, :, None]
        record("gn_fwd_normalize", sum_rel_err(kabs0, pabs0), GN_SUM_REL,
               sum_rel_err(pabs0 - z.abs().sum(dim=2), pabs0),
               f"sum |z| tap without the SiLU (rel; fault: the last of S = {splits} splits' "
               "partial left out)", max_abs_err(kabs0, pabs0))
        lines.append(f"gn_fwd_normalize S = {splits} splits a plane, y and tap bit-equal run "
                     "to run, y without the SiLU bit-equal to plain")
        del z, ky2, kabs2, ky0, kabs0, py0, pabs0
        # 4. bwd reduce; fault: SiLU' left out of g_eff
        kg, kgx = gnk.bwd_reduce(x, g, a, off, True)
        sync()
        pg, pgx = gnk.bwd_reduce_reference(x, g, a, off, True)
        fg, fgx = gnk.bwd_reduce_reference(x, g, a, off, False)
        record("gn_bwd_reduce", max(sum_rel_err(kg, pg), sum_rel_err(kgx, pgx)), GN_SUM_REL,
               max(sum_rel_err(fg, pg), sum_rel_err(fgx, pgx)), "sum g_eff, sum g_eff x (rel)",
               max(max_abs_err(kg, pg), max_abs_err(kgx, pgx)))
        # 5. bwd dx with the op's own coefficients; fault: SiLU' left out
        n = h * w * (c // GN_GROUPS)
        ca = a
        cb = (-(rstd * rstd) / n).repeat_interleave(c // GN_GROUPS, dim=1).contiguous()
        cc = (0.1 * cb).contiguous()
        kdx = gnk.bwd_dx(x, g, a, off, ca, cb, cc, True)
        sync()
        pdx = gnk.bwd_dx_reference(x, g, a, off, ca, cb, cc, True)
        fdx = gnk.bwd_dx_reference(x, g, a, off, ca, cb, cc, False)
        err, bound = bf16_err(kdx, pdx)
        record("gn_bwd_dx", err, bound, bf16_err(fdx, pdx)[0], "dx (bf16)", err)
        del ks, kq, fs, ky, kabs, py, pabs, fy, fabs, kg, kgx, pg, pgx, fg, fgx, kdx, pdx, fdx

        # the autograd op (kernels) against the plain GroupNorm (autograd of
        # group_norm_reference), SiLU fused, the |z| tap from the op
        def op_grads(fn, silu=True):
            xr = x.detach().requires_grad_(True)
            sr = scale.detach().requires_grad_(True)
            br = bias.detach().requires_grad_(True)
            y = fn(xr, sr, br, silu)
            dx, ds, db = torch.autograd.grad(y, (xr, sr, br), g)
            return y.detach(), dx, ds, db

        def kernel_op(xr, sr, br, silu):
            y, _tap = gnk.group_norm_silu_with_stats(xr, sr, br, GN_GROUPS, GN_EPS, silu)
            return y

        def plain_op(xr, sr, br, silu):
            return group_norm_reference(xr, sr, br, GN_GROUPS, GN_EPS, silu)

        ky, kdx, kds, kdb = op_grads(kernel_op)
        _y, ktap = gnk.group_norm_silu_with_stats(x, scale, bias, GN_GROUPS, GN_EPS, True)
        sync()
        py, pdx, pds, pdb = op_grads(plain_op)
        _fy, _fdx, _fds, fdb = op_grads(plain_op, silu=False)
        ptap = gnk.fwd_normalize_reference(x, a, off, True, True)[1].sum(0) / (b * h * w)
        errs = [bf16_err(ky, py), bf16_err(kdx, pdx)]
        tap_err = sum_rel_err(ktap, ptap)
        ds_err, db_err = sum_rel_err(kds, pds), sum_rel_err(kdb, pdb)
        fault_db = sum_rel_err(fdb, pdb)
        lines.append(f"op: y err {errs[0][0]:.4g} (bound {errs[0][1]:.4g}), mean|z| tap rel "
                     f"{tap_err:.3g}, dx err {errs[1][0]:.4g} (bound {errs[1][1]:.4g}), dgamma "
                     f"rel {ds_err:.3g}, dbeta rel {db_err:.3g} (bound {GN_SUM_REL}; SiLU' left "
                     f"out: dbeta rel {fault_db:.3g})")
        check(all(e <= bd for e, bd in errs), f"the GroupNorm op's y or dx disagree at {shape}")
        check(max(tap_err, ds_err, db_err) <= GN_SUM_REL,
              f"the GroupNorm op's tap, dgamma or dbeta disagree at {shape}")
        check(fault_db > GN_SUM_REL, f"the dbeta bound at {shape} does not reject its fault")
        del ky, kdx, kds, kdb, py, pdx, pds, pdb, fdb, ktap, ptap

        # times: each kernel against its plain version, then the op's
        # forward and backward
        times = {
            "gn_fwd_reduce": timed_pair(lambda: gnk.fwd_reduce(x),
                                        lambda: gnk.fwd_reduce_reference(x)),
            "gn_fwd_normalize": timed_pair(
                lambda: gnk.fwd_normalize(x, a, off, True, False),
                lambda: gnk.fwd_normalize_reference(x, a, off, True, False)),
            "gn_bwd_reduce": timed_pair(lambda: gnk.bwd_reduce(x, g, a, off, True),
                                        lambda: gnk.bwd_reduce_reference(x, g, a, off, True)),
            "gn_bwd_dx": timed_pair(
                lambda: gnk.bwd_dx(x, g, a, off, ca, cb, cc, True),
                lambda: gnk.bwd_dx_reference(x, g, a, off, ca, cb, cc, True)),
        }
        stats_ms = timed_pair(lambda: gnk.fwd_normalize(x, a, off, True, True),
                              lambda: gnk.fwd_normalize_reference(x, a, off, True, True))
        # the library yardstick: F.group_norm then F.silu, forward and
        # backward; it leaves out the |z| tap and covers the (B, C) algebra
        # between the kernels, so each forward kernel shows the forward's time
        # and each backward kernel the backward's
        lib_fwd, lib_bwd = library_group_norm(x, g, scale, bias)
        elem, bc = x.numel(), b * c * 4
        e = elem * x.element_size()
        nbytes = {"gn_fwd_reduce": e + 2 * bc, "gn_fwd_normalize": 2 * e + 2 * bc,
                  "gn_bwd_reduce": 2 * e + 4 * bc, "gn_bwd_dx": 3 * e + 5 * bc}
        if shape == GN_ROW_SHAPE:
            for name, (ms, plain_ms) in times.items():
                bound_ms, bound_by = roofline(GN_OPS[name] * elem, nbytes[name],
                                              PEAK_FP32_FLOPS)
                fwd_kernel = "fwd" in name
                results[name].update(
                    shape=list(shape), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                    bound_by=bound_by, library_ms=lib_fwd if fwd_kernel else lib_bwd,
                    library_covers=("gn_fwd_reduce + gn_fwd_normalize" if fwd_kernel
                                    else "gn_bwd_reduce + gn_bwd_dx"))

        xr = x.detach().requires_grad_(True)
        sr = scale.detach().requires_grad_(True)
        br = bias.detach().requires_grad_(True)
        fwd = timed_pair(lambda: gnk.group_norm_silu(xr, sr, br, GN_GROUPS, GN_EPS, True),
                         lambda: group_norm_reference(xr, sr, br, GN_GROUPS, GN_EPS, True))
        y_k = gnk.group_norm_silu(xr, sr, br, GN_GROUPS, GN_EPS, True)
        y_p = group_norm_reference(xr, sr, br, GN_GROUPS, GN_EPS, True)
        bwd = timed_pair(
            lambda: torch.autograd.grad(y_k, (xr, sr, br), g, retain_graph=True),
            lambda: torch.autograd.grad(y_p, (xr, sr, br), g, retain_graph=True))
        del y_k, y_p, xr
        bytes_x = x.numel() * x.element_size()
        log(f"[gn] {shape} bf16: " + "; ".join(lines))
        log(f"[gn] {shape} ms kernel/plain (CUDA events, {GN_ITERS} calls, in turns): "
            + ", ".join(f"{k} {v[0]:.4f}/{v[1]:.4f}" for k, v in times.items())
            + f", gn_fwd_normalize with the tap {stats_ms[0]:.4f}/{stats_ms[1]:.4f}; "
            f"op forward {fwd[0]:.4f}/{fwd[1]:.4f}, op backward {bwd[0]:.4f}/{bwd[1]:.4f}; "
            f"x is {bytes_x / 1e6:.1f} MB, so the reduce kernel reads at "
            f"{bytes_x / times['gn_fwd_reduce'][0] / 1e6:.0f} GB/s; bounds (bytes at "
            f"{PEAK_BYTES_PER_S / 1e12} TB/s) "
            + ", ".join(f"{k} {nbytes[k] / PEAK_BYTES_PER_S * 1e3:.4f}" for k in nbytes)
            + f"; F.group_norm + F.silu forward {lib_fwd:.4f}, backward {lib_bwd:.4f}")
        del x, g, a, off, ca, cb, cc
    release()
    return results


def library_group_norm(x, g, scale, bias) -> tuple[float, float]:
    """CUDA-event ms of ``F.silu(F.group_norm(x))`` forward and its
    backward (dx, dgamma, dbeta) in x's dtype: the library yardstick of the
    GroupNorm kernels, never on the port's path."""
    import torch
    import torch.nn.functional as F

    w = scale.to(x.dtype).detach().requires_grad_(True)
    bb = bias.to(x.dtype).detach().requires_grad_(True)
    xr = x.detach().requires_grad_(True)

    def fwd():
        with torch.no_grad():
            F.silu(F.group_norm(x, GN_GROUPS, w, bb, GN_EPS))

    y = F.silu(F.group_norm(xr, GN_GROUPS, w, bb, GN_EPS))
    fwd_ms = cuda_ms(fwd, GN_ITERS)
    bwd_ms = cuda_ms(lambda: torch.autograd.grad(y, (xr, w, bb), g, retain_graph=True),
                     GN_ITERS)
    return fwd_ms, bwd_ms


def _fused_fwd_unmasked(x, a, o, w, bias, residual):
    """The plain fused forward with the border mask skipped: the zero
    padding is applied before the affine, so out-of-image rows and columns
    enter the conv as silu(o) (the planted fault of #9)."""
    import torch
    import torch.nn.functional as F

    xp = F.pad(x.float(), (1, 1, 1, 1))
    z = xp * a[:, :, None, None] + o[:, :, None, None]
    s = (z * torch.sigmoid(z)).to(x.dtype).float()
    y = F.conv2d(s, w.float()) + bias[None, :, None, None] + residual.float()
    return y.to(x.dtype)


def _halo_tap(x, a, o, tap):
    """The |z| tap with each 8-row tile's halo rows summed too: every row
    next to a tile boundary counted twice (the planted fault of the tap)."""
    h = x.shape[2]
    rows = sorted({r for b in range(8, h, 8) for r in (b - 1, b)})
    z = x[:, :, rows].float() * a[:, :, None, None] + o[:, :, None, None]
    return tap + z.abs().sum(dim=(2, 3))


def _dw_splits(n, cin, cout, h, w) -> int:
    """conv3x3_dw's split count as its wrapper chooses it: from the clusters
    this card holds at once (the default model off the card)."""
    from vae_channel_dynamics_tpu_torch.ops import fused_resnet as fr

    on_card = (lambda k: fr.dw_max_clusters(w, k)) if DEVICE == "cuda" else None
    return fr.dw_splits(n, cin, cout, h, w, on_card)


def _last_chunk_dropped(dy, n, cin, cout, h, w):
    """dy with the pixels of conv3x3_dw's last pixel chunk zeroed: what a
    kernel that left out its last split would sum (the planted fault of
    #11). Chunk k covers units [k*U//S, (k+1)*U//S) of the U = dw_units
    rows x cols pixel units, in order of (sample, unit row, unit column)."""
    from vae_channel_dynamics_tpu_torch.ops import fused_resnet as fr

    rows, cols = fr.dw_unit(w)
    units = fr.dw_units(n, h, w)
    per_image, units_w = units // n, w // cols
    splits = _dw_splits(n, cin, cout, h, w)
    out = dy.clone()
    for g in range((splits - 1) * units // splits, units):
        nn_, u = divmod(g, per_image)
        r0, c0 = (u // units_w) * rows, (u % units_w) * cols
        out[nn_, :, r0:r0 + rows, c0:c0 + cols] = 0
    return out


def fused_bounds(n, cin, cout, h, w) -> dict:
    """Each fused kernel's bound: 2 N H W 9 Cin Cout FLOPs, and the bytes of
    its bf16 activations and weight and fp32 vectors, each read or written
    once (#9 with the residual and the tap, as the path's conv2 runs it)."""
    flops = 2 * n * h * w * 9 * cin * cout
    act_in, act_out, wbytes = 2 * n * cin * h * w, 2 * n * cout * h * w, 2 * 9 * cin * cout
    vec = 4 * n * cin
    return {
        "fused_gn_silu_conv3x3": roofline(flops, act_in + 2 * act_out + wbytes + 3 * vec
                                          + 4 * cout),
        "conv3x3": roofline(flops, act_out + act_in + wbytes),
        "conv3x3_dw": roofline(flops, act_in + act_out + 2 * vec + 2 * wbytes),
    }


def device_ms_by_kernel(fn, iters: int) -> dict:
    """{kernel: device ms per call of ``fn``} from torch.profiler, each
    kernel named without its namespace and arguments; empty off the card."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if DEVICE != "cuda":
        return {}
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        key = evt.key.replace("(anonymous namespace)::", "").removeprefix("void ")
        name = re.sub(r"^(\w+::)+", "", key.split("(")[0])
        out[name] = out.get(name, 0.0) + _self_device_us(evt) / 1e3 / iters
    return out


def _self_device_us(evt) -> float:
    """A profiler event's own device time, us (its attribute's name differs
    between torch versions)."""
    us = getattr(evt, "self_device_time_total", None)
    return getattr(evt, "self_cuda_time_total", 0.0) if us is None else us


def phase_fused_kernels():
    """The three fused resnet kernels against their plain versions at
    FUSED_SHAPES, with planted faults, CUDA-event times beside their bound
    and cuDNN's yardstick; then the whole fused op against the unfused
    sequence, forward and forward+backward, at FUSED_OP_SHAPES."""
    import torch
    import torch.nn.functional as F

    from vae_channel_dynamics_tpu_torch.ops import fused_resnet as fr
    from vae_channel_dynamics_tpu_torch.ops import group_norm_kernel as gnk

    torch.backends.cudnn.allow_tf32 = False
    bf16 = torch.bfloat16
    results = {name: {"max_abs_err": 0.0} for name in fr.KERNELS}
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 20)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=DEVICE)

    for shape, cout in FUSED_SHAPES:
        n, cin, h, w = shape
        x = (randn(*shape) * 2.0 + 0.5).to(bf16)
        gamma, beta = 1.0 + 0.1 * randn(cin), 0.1 * randn(cin)
        wt = (randn(cout, cin, 3, 3) / math.sqrt(9 * cin)).to(bf16)
        bias = 0.1 * randn(cout)
        res, dy = randn(n, cout, h, w).to(bf16), randn(n, cout, h, w).to(bf16)
        sums, sqs = gnk.fwd_reduce_reference(x)
        mean, rstd = gnk._group_stats(sums, sqs, h * w, GN_GROUPS, GN_EPS)
        a, o = gnk._affine_coeffs(mean, rstd, gamma, beta, GN_GROUPS)
        lines = []

        def held_bf16(name, what, out, ref, fault):
            err, rel = kernel_errors(out, ref)
            bound = FUSED_ULPS * bf16_ulp(ref.float().abs().max().item())
            fault_err, fault_rel = kernel_errors(fault, ref)
            results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)
            lines.append(f"{what}: max abs {err:.4g} (bound {bound:.4g}), rel L2 {rel:.3g} "
                         f"(bound {FUSED_REL_L2}); planted fault max abs {fault_err:.4g}, "
                         f"rel L2 {fault_rel:.3g}")
            check(err <= bound and rel <= FUSED_REL_L2,
                  f"{what} disagrees with plain at {shape} -> {cout}: {err}, {rel}")
            check(fault_err > bound or fault_rel > FUSED_REL_L2,
                  f"the {what} bound at {shape} -> {cout} does not reject its planted fault")

        def held_sum(name, what, out, ref, fault):
            err, fault_err = sum_rel_err(out, ref), sum_rel_err(fault, ref)
            results[name]["max_abs_err"] = max(results[name]["max_abs_err"],
                                               max_abs_err(out, ref))
            lines.append(f"{what}: rel {err:.3g} (bound {FUSED_SUM_REL}); planted fault "
                         f"{fault_err:.3g}")
            check(err <= FUSED_SUM_REL, f"{what} disagrees with plain at {shape}: {err}")
            check(fault_err > FUSED_SUM_REL,
                  f"the {what} bound at {shape} does not reject its planted fault")

        # 9: without the residual (conv1), then with it, the tap and the moments
        y0, _, _ = fr.fused_fwd(x, a, o, wt, bias)
        y, tap, (ysum, ysq) = fr.fused_fwd(x, a, o, wt, bias, res, True, True)
        y2, tap2, (ysum2, ysq2) = fr.fused_fwd(x, a, o, wt, bias, res, True, True)
        sync()
        check(all(torch.equal(u, w2) for u, w2 in ((y, y2), (tap, tap2), (ysum, ysum2),
                                                    (ysq, ysq2))),
              f"#9 differs between two runs at {shape} -> {cout}")
        del y2, tap2, ysum2, ysq2
        py0, _, _ = fr.fused_fwd_reference(x, a, o, wt, bias)
        held_bf16("fused_gn_silu_conv3x3", "#9 y", y0, py0,
                  _fused_fwd_unmasked(x, a, o, wt, bias, torch.zeros_like(res)))
        del y0, py0
        py, ptap, (psum, psq) = fr.fused_fwd_reference(x, a, o, wt, bias, res, True, True)
        held_bf16("fused_gn_silu_conv3x3", "#9 y + residual", y, py,
                  _fused_fwd_unmasked(x, a, o, wt, bias, res))
        held_sum("fused_gn_silu_conv3x3", "#9 sum |z| tap", tap, ptap, _halo_tap(x, a, o, ptap))
        _, _, (fsum, fsq) = fr.fused_fwd_reference(x, a, o, wt, bias, None, False, True)
        held_sum("fused_gn_silu_conv3x3", "#9 sum y", ysum, psum, fsum)
        held_sum("fused_gn_silu_conv3x3", "#9 sum y^2", ysq, psq, fsq)
        del y, tap, ysum, ysq, py, ptap, psum, psq, fsum, fsq
        # 10: the backward's ds = conv3x3(dy, w flipped and channel-swapped)
        # (faults: the weight not flipped; dy's last 64-channel K chunk left out)
        wf = fr.flipped_weight(wt)
        ds = fr.conv3x3(dy, wf)
        ds2 = fr.conv3x3(dy, wf)
        sync()
        check(torch.equal(ds, ds2), f"#10 ds differs between two runs at {shape} -> {cout}")
        pds = fr.conv3x3_reference(dy, wf)
        held_bf16("conv3x3", "#10 ds", ds, pds, fr.conv3x3_reference(dy, wt.transpose(0, 1)))
        dy_short = dy.clone()
        dy_short[:, -64:] = 0
        held_bf16("conv3x3", "#10 ds (fault: the last K chunk)", ds, pds,
                  fr.conv3x3_reference(dy_short, wf))
        del ds, ds2, pds, dy_short
        # 11: dW, s recomputed from x
        dw = fr.conv_dw(x, a, o, dy)
        dw2 = fr.conv_dw(x, a, o, dy)
        sync()
        check(torch.equal(dw, dw2), f"#11 dW differs between two runs at {shape}")
        held_sum("conv3x3_dw", "#11 dW", dw, fr.conv_dw_reference(x, a, o, dy),
                 fr.conv_dw_reference(x, a, o, _last_chunk_dropped(dy, n, cin, cout, h, w)))
        del dw, dw2
        release()

        # times, in turns: plain, kernel, kernel, plain; the library yardsticks
        # on the pre-normalised input s
        z = x.float() * a[:, :, None, None] + o[:, :, None, None]
        s = (z * torch.sigmoid(z)).to(bf16)
        del z
        bias16 = bias.to(bf16)
        times = {
            "fused_gn_silu_conv3x3": timed_pair(
                lambda: fr.fused_fwd(x, a, o, wt, bias, res, True),
                lambda: fr.fused_fwd_reference(x, a, o, wt, bias, res, True), FUSED_ITERS),
            "conv3x3": timed_pair(lambda: fr.conv3x3(dy, wf),
                                  lambda: fr.conv3x3_reference(dy, wf), FUSED_ITERS),
            "conv3x3_dw": timed_pair(lambda: fr.conv_dw(x, a, o, dy),
                                     lambda: fr.conv_dw_reference(x, a, o, dy), FUSED_ITERS),
        }
        library = {
            "fused_gn_silu_conv3x3": (
                cuda_ms(lambda: F.conv2d(s, wt, bias16, padding=1), FUSED_ITERS),
                "F.conv2d on the pre-normalised input (the conv alone)"),
            "conv3x3": (cuda_ms(lambda: torch.nn.grad.conv2d_input(x.shape, wt, dy, padding=1),
                                FUSED_ITERS), "torch.nn.grad.conv2d_input"),
            "conv3x3_dw": (cuda_ms(lambda: torch.nn.grad.conv2d_weight(s, wt.shape, dy,
                                                                       padding=1),
                                   FUSED_ITERS),
                           "torch.nn.grad.conv2d_weight on the pre-normalised input"),
        }
        # where #10's time goes: the weight copies, the NHWC copy of dy (the
        # pre-pass in its identity mode) and the loop
        by_kernel = device_ms_by_kernel(lambda: fr.conv3x3(dy, wf), FUSED_ITERS)
        lines.append("#10 device ms a call by kernel (torch.profiler): " + (", ".join(
            f"{k[:60]} {v:.4f}" for k, v in sorted(by_kernel.items(), key=lambda kv: -kv[1]))
            or "not measured off the card"))
        bounds = fused_bounds(n, cin, cout, h, w)
        if (shape, cout) == FUSED_SHAPES[0]:
            for name in fr.KERNELS:
                results[name].update(
                    shape=[*shape, cout], ms=times[name][0], plain_ms=times[name][1],
                    bound_ms=bounds[name][0], bound_by=bounds[name][1],
                    library_ms=library[name][0], library_covers=library[name][1])
        held = ([fr.dw_max_clusters(w, k) for k in range(1, fr.DW_MAX_SPLITS + 1)]
                if DEVICE == "cuda" else "not queried off the card")
        lines.append("#9, #10 and #11 bit-equal run to run")
        lines.append(f"#11 splits {_dw_splits(n, cin, cout, h, w)} (clusters of 1-"
                     f"{fr.DW_MAX_SPLITS} blocks the card holds at once: {held})")
        log(f"[fused] {shape} -> {cout} bf16: " + "; ".join(lines))
        log(f"[fused] {shape} -> {cout} ms kernel/plain/bound/library (CUDA events, "
            f"{FUSED_ITERS} calls, in turns): " + ", ".join(
                f"{name} {times[name][0]:.4f}/{times[name][1]:.4f}/{bounds[name][0]:.4f}/"
                f"{library[name][0]:.4f} ({100 * bounds[name][0] / times[name][0]:.1f}% of "
                f"bound, {bounds[name][1]})" for name in fr.KERNELS))
        del x, res, dy, s, wf, a, o
        release()
    phase_fused_op()
    return results


def phase_fused_op():
    """The fused op (kernel #1, then #9; backward #10, #11, #4, #5) against
    the unfused sequence it replaces (the pallas GroupNorm kernels with
    SiLU, cuDNN's conv, the residual add), forward and forward+backward, at
    FUSED_OP_SHAPES, C -> C channels."""
    import torch
    import torch.nn.functional as F

    from vae_channel_dynamics_tpu_torch.ops import fused_resnet as fr
    from vae_channel_dynamics_tpu_torch.ops import group_norm_kernel as gnk

    bf16 = torch.bfloat16
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 21)
    rows = []
    for shape in FUSED_OP_SHAPES:
        c = shape[1]
        x = torch.randn(shape, generator=gen, device=DEVICE).to(bf16)
        res = torch.randn(shape, generator=gen, device=DEVICE).to(bf16)
        dy = torch.randn(shape, generator=gen, device=DEVICE).to(bf16)
        gamma = 1.0 + 0.1 * torch.randn(c, generator=gen, device=DEVICE)
        beta = 0.1 * torch.randn(c, generator=gen, device=DEVICE)
        wt = torch.randn((c, c, 3, 3), generator=gen, device=DEVICE) / math.sqrt(9 * c)
        bias = 0.1 * torch.randn(c, generator=gen, device=DEVICE)
        leaves = [t.detach().requires_grad_(True) for t in (x, gamma, beta, wt, bias, res)]

        def fused(xx, gg, bb, ww, bi, rr):
            return fr.gn_silu_conv3x3(xx, gg, bb, ww, bi, num_groups=GN_GROUPS, eps=GN_EPS,
                                      residual=rr)[0]

        def unfused(xx, gg, bb, ww, bi, rr):
            s = gnk.group_norm_silu(xx, gg, bb, GN_GROUPS, GN_EPS, True)
            return F.conv2d(s, ww.to(bf16), bi.to(bf16), padding=1) + rr

        with torch.no_grad():
            yf, yu = fused(*leaves), unfused(*leaves)
        _err, rel = kernel_errors(yf, yu)
        check(rel <= FUSED_REL_L2, f"the fused op is {rel} (rel L2) from the unfused at {shape}")

        def forward(op):
            def run():
                with torch.no_grad():
                    op(*leaves)
            return run

        def forward_backward(op):
            return lambda: torch.autograd.grad(op(*leaves), leaves, dy)

        fwd = timed_pair(forward(fused), forward(unfused), FUSED_ITERS)
        both = timed_pair(forward_backward(fused), forward_backward(unfused), FUSED_ITERS)
        rows.append(f"{shape}: forward {fwd[0]:.4f} vs {fwd[1]:.4f} "
                    f"({fwd[1] / fwd[0]:.2f}x), forward+backward {both[0]:.4f} vs "
                    f"{both[1]:.4f} ({both[1] / both[0]:.2f}x); rel L2 {rel:.3g}")
        del x, res, dy, leaves, yf, yu
        release()
    log(f"[fused-op] C -> C channels with the residual, ms fused vs unfused "
        f"(pallas GroupNorm + SiLU, cuDNN conv, add; CUDA events, {FUSED_ITERS} calls, in "
        "turns): " + "; ".join(rows))


def _train_setup():
    """The full-width SDXL VAE for training with the monitor's taps, its
    optimizer state, and seeded uint8 batches on the device."""
    import numpy as np
    import torch

    from vae_channel_dynamics_tpu_torch.models import AutoencoderKL
    from vae_channel_dynamics_tpu_torch.tracking import ActivityMonitor
    from vae_channel_dynamics_tpu_torch.training import TrainState, build_optimizer

    monitor = ActivityMonitor({
        "enabled": True, "track_interval": TRACK_INTERVAL,
        "target_layers": [{"name": n, "capture_point": "output",
                           "metrics": ["mean_abs_activation_per_channel"]} for n in TRAIN_TAPS],
    })
    model = AutoencoderKL(train_config(), impl="pallas", dtype=torch.bfloat16,
                          capture=monitor.scalar_capture_table, device=DEVICE)
    model.init_weights(torch.Generator(device=DEVICE).manual_seed(SEED))
    with torch.no_grad():
        gamma = model.get_submodule(PLANTED_NORM).weight
        gamma[list(PLANTED_CHANNELS)] = PLANTED_GAMMA
    tx, _schedule = build_optimizer(TRAIN_LR, TRAIN_WARMUP, 10_000, max_grad_norm=TRAIN_CLIP)
    state = TrainState.create(model, tx, stats_acc=monitor.init_acc(model))
    rng = np.random.default_rng(SEED)
    batches = [torch.from_numpy(rng.integers(0, 256, (TRAIN_BATCH, TRAIN_RES, TRAIN_RES, 3),
                                             dtype=np.uint8)).to(DEVICE)
               for _ in range(TRAIN_BATCHES)]
    return monitor, model, tx, state, batches


def train_config():
    from vae_channel_dynamics_tpu_torch.models import VAEConfig

    return VAEConfig.sdxl()


def phase_train():
    """The training slice: 30 steps of the full-width SDXL VAE with the
    interval control loop (monitor -> classify -> nudge -> reset)."""
    import numpy as np
    import torch

    from vae_channel_dynamics_tpu_torch.classification import RegionClassifier
    from vae_channel_dynamics_tpu_torch.intervention import InterventionHandler
    from vae_channel_dynamics_tpu_torch.ops import group_norm_kernel as gnk
    from vae_channel_dynamics_tpu_torch.tracking import ActivityMonitor
    from vae_channel_dynamics_tpu_torch.training import make_train_step

    release()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    monitor, model, tx, state, batches = _train_setup()
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == SDXL_PARAMS, f"the model has {n_params} parameters, not {SDXL_PARAMS}")
    step = make_train_step(model, tx, TRAIN_KL, stats_accumulate=ActivityMonitor.accumulate)
    layer = f"vae.{PLANTED_NORM}.output"
    classifier = RegionClassifier(model, {
        "enabled": True, "method": "threshold_groupnorm_activity",
        "threshold": CLASSIFY_THRESHOLD,
        "target_metric_key": "mean_abs_activation_per_channel",
        "layers_to_classify": [layer],
    })
    handler = InterventionHandler({
        "enabled": True, "strategy": "gentle_nudge_groupnorm_scale",
        "nudge_factor": NUDGE_FACTOR, "max_scale_value": NUDGE_CAP,
        "intervention_interval": TRACK_INTERVAL,
    })
    mask = torch.ones(TRAIN_BATCH, device=DEVICE)
    noise_gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    log(f"[train] sdxl VAE, {n_params} fp32 parameters from seed {SEED}, bf16 compute, "
        f"GroupNorm impl=pallas, gamma of {PLANTED_NORM} channels {list(PLANTED_CHANNELS)} "
        f"set to {PLANTED_GAMMA}; set up in {time.perf_counter() - t0:.1f} s")

    # ---- the main path: counts reset, 30 steps with the control loop ----
    sync()
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    for name in gnk.launches:
        gnk.launches[name] = 0
    synced, loop_end = {}, {}
    t_start = time.perf_counter()
    for i in range(TRAIN_STEPS):
        state, metrics, _maps = step(state, {"pixel_values": batches[i % len(batches)]},
                                     mask, noise_gen)
        global_step = state.step
        if global_step % TRACK_INTERVAL:
            continue
        sync()
        synced[global_step] = time.perf_counter()
        loss, grad_norm = float(metrics["train_loss_step"]), float(metrics["grad_norm"])
        check(math.isfinite(loss) and math.isfinite(grad_norm),
              f"step {global_step}: loss {loss}, grad_norm {grad_norm}")
        wandb = monitor.step(global_step, state.stats_acc, state.stats_count)
        results = classifier.classify(monitor.get_data_for_step(global_step), global_step)
        check(layer in results, f"step {global_step}: nothing classified in {layer}")
        found = results[layer]["inactive_channel_indices"]
        check(set(PLANTED_CHANNELS) <= set(found),
              f"step {global_step}: planted channels {PLANTED_CHANNELS} not all in {found}")
        before = {k: v.detach().clone() for k, v in model.state_dict().items()}
        param = f"{PLANTED_NORM}.weight"
        gamma = before[param].float().cpu().numpy()
        handler.intervene(model, results, global_step)
        after = model.state_dict()
        want = gamma.copy()
        for idx in found:
            want[idx] = min(float(gamma[idx]) * NUDGE_FACTOR, NUDGE_CAP)
        check(np.array_equal(after[param].float().cpu().numpy(), want.astype(np.float32)),
              f"step {global_step}: gamma is not min(gamma * {NUDGE_FACTOR}, {NUDGE_CAP}) on "
              "exactly the classified channels")
        check(handler.num_nudges_applied == len(found),
              f"step {global_step}: {handler.num_nudges_applied} nudges for {len(found)}")
        check(all(torch.equal(after[k], v) for k, v in before.items() if k != param),
              f"step {global_step}: the nudge changed another parameter")
        del before
        state.reset_stats()
        taps = {k.split("/")[1].removeprefix("vae.").removesuffix(".output"): v
                for k, v in wandb.items() if k.endswith("_overall_mean")}
        log(f"[train] step {global_step}: loss {loss:.6g}, grad_norm {grad_norm:.6g}; "
            f"{len(found)} channels classified below {CLASSIFY_THRESHOLD} in {PLANTED_NORM} "
            f"(planted {len(PLANTED_CHANNELS)}), nudged; planted gamma now "
            f"{float(after[param][PLANTED_CHANNELS[0]]):.6g}; tap overall means "
            + ", ".join(f"{k} {v:.4g}" for k, v in taps.items()))
        sync()
        loop_end[global_step] = time.perf_counter()
    sync()
    wall = time.perf_counter() - t_start
    launches = dict(gnk.launches)
    peak = torch.cuda.max_memory_allocated() / 1e9 if DEVICE == "cuda" else 0.0
    log(f"[train] GroupNorm kernel launches in the {TRAIN_STEPS} steps: {launches}")
    for name, count in launches.items():
        check(count > 0, f"the {name} kernel was not launched on the training path")
    # steps 11-20: from the end of step 10's control loop to the sync after
    # step 20, host clock, synchronised at both ends
    sec = synced[2 * TRACK_INTERVAL] - loop_end[TRACK_INTERVAL]
    steps_s = TRACK_INTERVAL / sec
    log(f"[train] {TRAIN_STEPS} steps with 3 control-loop visits in {wall:.3f} s; steps "
        f"{TRACK_INTERVAL + 1}-{2 * TRACK_INTERVAL}: {1e3 * sec / TRACK_INTERVAL:.2f} ms/step, "
        f"{steps_s:.4f} steps/s, {steps_s * TRAIN_BATCH:.2f} img/s at {TRAIN_RES}px batch "
        f"{TRAIN_BATCH}; peak device memory {peak:.2f} GB")
    return {"model": model, "state": state, "step": step, "batches": batches,
            "mask": mask, "launches": launches}


def _one_step(bundle, impl, dtype, batch, noise):
    """One train step from the snapshot weights with a fresh optimizer:
    loss, grad_norm and the taps' vectors."""
    import torch

    from vae_channel_dynamics_tpu_torch.tracking import ActivityMonitor
    from vae_channel_dynamics_tpu_torch.training import TrainState, build_optimizer
    from vae_channel_dynamics_tpu_torch.training import make_train_step

    model = bundle["model"]
    model.load_state_dict(bundle["snapshot"])
    model.set_impl(impl).set_compute_dtype(dtype)
    tx, _ = build_optimizer(TRAIN_LR, TRAIN_WARMUP, 10_000, max_grad_norm=TRAIN_CLIP)
    acc = {k: torch.zeros_like(v) for k, v in bundle["state"].stats_acc.items()}
    state = TrainState.create(model, tx, stats_acc=acc)
    step = make_train_step(model, tx, TRAIN_KL, stats_accumulate=ActivityMonitor.accumulate)
    _state, metrics, _maps = step(state, {"pixel_values": batch}, bundle["mask"], noise=noise)
    out = {"loss": float(metrics["train_loss_step"]), "grad_norm": float(metrics["grad_norm"]),
           "taps": {k: v.float().cpu() for k, v in state.stats_acc.items()}}
    del state, tx, _state
    release()
    return out


def phase_step_compare(bundle):
    """One step on the kernel path against one on the plain path, from the
    same weights, batch and noise, held to the plain path's own bf16-vs-fp32
    difference on the same step."""
    import torch

    bundle["snapshot"] = {k: v.detach().clone() for k, v in bundle["model"].state_dict().items()}
    batch = bundle["batches"][0]
    latent = TRAIN_RES // 2 ** (len(train_config().block_out_channels) - 1)
    noise = torch.randn((TRAIN_BATCH, latent, latent, 4),
                        generator=torch.Generator(device=DEVICE).manual_seed(SEED + 2),
                        device=DEVICE)
    runs = {
        "kernel bf16": _one_step(bundle, "pallas", torch.bfloat16, batch, noise),
        "plain bf16": _one_step(bundle, "xla", torch.bfloat16, batch, noise),
        "plain fp32": _one_step(bundle, "xla", torch.float32, batch, noise),
    }
    k, p, f = runs["kernel bf16"], runs["plain bf16"], runs["plain fp32"]

    def rel(a, b):
        if isinstance(a, float):
            return abs(a - b) / abs(b)
        return ((a - b).norm() / b.norm()).item()

    rows = [("loss", k["loss"], p["loss"], f["loss"]),
            ("grad_norm", k["grad_norm"], p["grad_norm"], f["grad_norm"])]
    rows += [(key.split(".output")[0], k["taps"][key], p["taps"][key], f["taps"][key])
             for key in sorted(k["taps"])]
    check(len(rows) == 2 + len(TRAIN_TAPS), f"{len(rows) - 2} tap vectors compared")
    for name, kv, pv, fv in rows:
        d, control = rel(kv, pv), rel(pv, fv)
        floor = STEP_SCALAR_FLOOR if isinstance(kv, float) else STEP_FLOOR
        log(f"[step] {name}: kernel vs plain (bf16) rel {d:.4g}; control plain bf16 vs fp32 "
            f"rel {control:.4g}; bound {STEP_CONTROL_RATIO} x control + {floor:.4g}")
        check(d <= STEP_CONTROL_RATIO * control + floor,
              f"{name}: the kernel path is {d} from the plain path, control {control}")
    log(f"[step] loss kernel {k['loss']:.6g}, plain bf16 {p['loss']:.6g}, plain fp32 "
        f"{f['loss']:.6g}; grad_norm {k['grad_norm']:.6g}, {p['grad_norm']:.6g}, "
        f"{f['grad_norm']:.6g}")
    model = bundle["model"]
    model.load_state_dict(bundle.pop("snapshot"))
    model.set_impl("pallas").set_compute_dtype(torch.bfloat16)


def _profile_breakdown(prof, wall_ms: float) -> None:
    """Device time of one step by kernel family, from torch.profiler."""
    from torch.autograd import DeviceType

    families = (
        ("fused resnet kernels (#9-#11)", ("conv3x3_kernel", "conv3x3_dw_kernel",
                                           "conv3x3_nchw_kernel", "silu_nhwc_kernel",
                                           "sum_tiles_kernel")),
        ("flash attention kernels (flash_*)", ("flash_fwd", "flash_bwd")),
        ("GroupNorm kernels (gn_*)", ("gn_fwd_", "gn_bwd_", "sum_splits_kernel")),
        ("convolutions (cuDNN)", ("conv", "fprop", "dgrad", "wgrad", "implicit")),
        ("layout transposes", ("nchw", "nhwc", "transpose", "permute")),
        ("matmul (cuBLAS)", ("gemm", "cublas")),
        ("optimizer (foreach)", ("foreach", "multi_tensor")),
        ("reductions", ("reduce",)),
        ("elementwise", ("elementwise", "vectorized", "unrolled")),
        ("memcpy/memset", ("memcpy", "memset")),
    )
    totals, per_kernel = {}, []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = _self_device_us(evt)
        name = evt.key
        per_kernel.append((us, name, evt.count))
        low = name.lower()
        fam = next((f for f, keys in families if any(k in low for k in keys)), "other")
        totals[fam] = totals.get(fam, 0.0) + us
    device_ms = sum(totals.values()) / 1e3
    if device_ms == 0.0:
        log("[profile] torch.profiler recorded no device time")
        return
    log(f"[profile] one kernel-path step: device {device_ms:.3f} ms, wall {wall_ms:.3f} ms, "
        f"busy {100 * device_ms / wall_ms:.1f}%")
    for fam, us in sorted(totals.items(), key=lambda kv: -kv[1]):
        log(f"[profile]   {fam}: {us / 1e3:.3f} ms ({100 * us / 1e3 / device_ms:.1f}%)")
    for us, name, count in sorted(per_kernel, reverse=True)[:12]:
        log(f"[profile]   {us / 1e3:8.3f} ms x{count:<4d} {name[:110]}")


def phase_step_times(bundle):
    """Kernel-path and plain-path steps in turns (plain, kernel, kernel,
    plain), host clock with a sync per block; then the profile of one
    kernel-path step."""
    import torch

    model, state, step = bundle["model"], bundle["state"], bundle["step"]
    batches, mask = bundle["batches"], bundle["mask"]
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 3)

    def block(impl, n):
        model.set_impl(impl)
        sync()
        t0 = time.perf_counter()
        for i in range(n):
            step(state, {"pixel_values": batches[i % len(batches)]}, mask, gen)
        sync()
        return (time.perf_counter() - t0) / n * 1e3

    block("xla", 1)  # warm-up of the plain path's allocations
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    p1 = block("xla", TIMED_STEPS)
    plain_peak = torch.cuda.max_memory_allocated() / 1e9 if DEVICE == "cuda" else 0.0
    k1, k2 = block("pallas", TIMED_STEPS), block("pallas", TIMED_STEPS)
    p2 = block("xla", TIMED_STEPS)
    kernel_ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
    log(f"[times] train step at {TRAIN_RES}px batch {TRAIN_BATCH}, {2 * TIMED_STEPS} steps "
        f"each, in turns: kernel path {kernel_ms:.2f} ms/step [{k1:.2f}, {k2:.2f}] "
        f"({TRAIN_BATCH * 1e3 / kernel_ms:.2f} img/s), plain path {plain_ms:.2f} ms/step "
        f"[{p1:.2f}, {p2:.2f}] ({TRAIN_BATCH * 1e3 / plain_ms:.2f} img/s); plain-path peak "
        f"device memory {plain_peak:.2f} GB")

    model.set_impl("pallas")
    step(state, {"pixel_values": batches[0]}, mask, gen)
    sync()
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if DEVICE == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        step(state, {"pixel_values": batches[1]}, mask, gen)
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    _profile_breakdown(prof, wall_ms)


FUSED_GRAD_BLOCKS = ("encoder.down_blocks.3.resnets.0", "encoder.mid_block.resnets.1",
                     "decoder.mid_block.resnets.0", "decoder.up_blocks.0.resnets.2")


def phase_fused_step(bundle):
    """One 256px step with ``impl="fused"`` against one with ``pallas`` (the
    same weights, batch and noise), held to the plain path's own
    bf16-vs-fp32 difference on that step: loss, grad_norm and the parameter
    gradients of four of the nine fused blocks. Then steps of both paths in
    turns, timed, with their peak memory, and a profile of a fused step."""
    import torch

    from vae_channel_dynamics_tpu_torch.models import vae as tvae
    from vae_channel_dynamics_tpu_torch.training import TrainState, make_train_step

    model = bundle["model"]
    snapshot = {k: v.detach().clone() for k, v in model.state_dict().items()}
    names = [n for n, _p in model.named_parameters()
             if any(n.startswith(f"{b}.") for b in FUSED_GRAD_BLOCKS)]
    batch = bundle["batches"][0]
    latent = TRAIN_RES // 2 ** (len(train_config().block_out_channels) - 1)
    noise = torch.randn((TRAIN_BATCH, latent, latent, 4), device=DEVICE,
                        generator=torch.Generator(device=DEVICE).manual_seed(SEED + 7))

    class GradCapture:
        """Stands in for the optimizer: keeps the named gradients and
        updates nothing."""

        grads = {}

        def init(self, params):
            return None

        def update(self, grads, opt_state, params):
            self.grads = {n: grads[n].float().clone() for n in names}
            return False

    def one_step(impl, dtype):
        model.load_state_dict(snapshot)
        model.set_impl(impl).set_compute_dtype(dtype)
        tx = GradCapture()
        before = dict(tvae.fused_blocks)
        _state, metrics, _ = make_train_step(model, tx, TRAIN_KL)(
            TrainState.create(model, tx), {"pixel_values": batch}, bundle["mask"], noise=noise)
        out = {"loss": float(metrics["train_loss_step"]),
               "grad_norm": float(metrics["grad_norm"]), **tx.grads,
               "blocks": {k: tvae.fused_blocks[k] - before[k] for k in before}}
        release()
        return out

    runs = {"fused bf16": one_step("fused", torch.bfloat16),
            "pallas bf16": one_step("pallas", torch.bfloat16),
            "plain bf16": one_step("xla", torch.bfloat16),
            "plain fp32": one_step("xla", torch.float32)}
    f, k, p, c = (runs[r] for r in ("fused bf16", "pallas bf16", "plain bf16", "plain fp32"))
    check(f["blocks"] == {"fused": SDXL_FUSED_AT_256, "unfused": SDXL_RESNETS - SDXL_FUSED_AT_256},
          f"the fused step's resnets: {f['blocks']}")

    def rel(a, b):
        if isinstance(a, float):
            return abs(a - b) / abs(b)
        return ((a - b).norm() / b.norm()).item()

    rows = []
    for key in ["loss", "grad_norm", *names]:
        d, control = rel(f[key], k[key]), rel(p[key], c[key])
        floor = STEP_SCALAR_FLOOR if key in ("loss", "grad_norm") else STEP_FLOOR
        rows.append(f"{key} {d:.3g} (control {control:.3g})")
        check(f[key] if isinstance(f[key], float) else f[key].abs().max().item() > 0,
              f"the fused step's {key} is zero")
        check(d <= STEP_CONTROL_RATIO * control + floor,
              f"256px step {key}: fused is {d} from pallas, control {control}")
    log(f"[fused-step] 256px batch {TRAIN_BATCH} step, {f['blocks']['fused']} of "
        f"{SDXL_RESNETS} resnets fused; fused vs pallas (bf16), relative (rel L2 for the "
        f"gradients of {FUSED_GRAD_BLOCKS}); control plain bf16 vs fp32; bound "
        f"{STEP_CONTROL_RATIO} x control + floor: " + "; ".join(rows))
    log(f"[fused-step] loss fused {f['loss']:.6g}, pallas {k['loss']:.6g}, plain bf16 "
        f"{p['loss']:.6g}, fp32 {c['loss']:.6g}; grad_norm {f['grad_norm']:.6g}, "
        f"{k['grad_norm']:.6g}, {p['grad_norm']:.6g}, {c['grad_norm']:.6g}")
    del runs, f, k, p, c
    model.load_state_dict(snapshot)
    del snapshot
    model.set_compute_dtype(torch.bfloat16)

    # timed steps with AdamW, in turns: pallas, fused, fused, pallas
    state, step, batches, mask = bundle["state"], bundle["step"], bundle["batches"], bundle["mask"]
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 8)
    peaks = {}

    def block(impl, n):
        model.set_impl(impl)
        sync()
        reset_peak()
        t0 = time.perf_counter()
        for i in range(n):
            step(state, {"pixel_values": batches[i % len(batches)]}, mask, gen)
        sync()
        peaks[impl] = max(peaks.get(impl, 0.0), peak_gb())
        return (time.perf_counter() - t0) / n * 1e3

    block("fused", 1)  # warm-up of the fused path's allocations
    peaks.clear()
    k1, f1, f2, k2 = (block(impl, TIMED_STEPS) for impl in ("pallas", "fused", "fused", "pallas"))
    fused_ms, pallas_ms = (f1 + f2) / 2, (k1 + k2) / 2
    log(f"[fused-step] train step at {TRAIN_RES}px batch {TRAIN_BATCH}, {2 * TIMED_STEPS} steps "
        f"each, in turns: fused {fused_ms:.2f} ms/step [{f1:.2f}, {f2:.2f}] "
        f"({TRAIN_BATCH * 1e3 / fused_ms:.2f} img/s), peak device memory {peaks['fused']:.2f} "
        f"GB; pallas {pallas_ms:.2f} ms/step [{k1:.2f}, {k2:.2f}] "
        f"({TRAIN_BATCH * 1e3 / pallas_ms:.2f} img/s), peak {peaks['pallas']:.2f} GB")

    model.set_impl("fused")
    step(state, {"pixel_values": batches[0]}, mask, gen)
    sync()
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if DEVICE == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        step(state, {"pixel_values": batches[1]}, mask, gen)
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    log("[profile] one 256px fused step:")
    _profile_breakdown(prof, wall_ms)
    model.set_impl("pallas")


def phase_fused_trainer(tmp: str):
    """The fused Trainer slice: configs/bench_256px.yaml with ``kernel_impl:
    fused``, a seeded full-width model dir with 8 planted channels in a fused
    block's norm1, taps on two fused blocks' norm outputs (kernel #9's side
    output), the control loop every 10 steps, FUSED_TRAINER_STEPS steps
    through ``vae_channel_dynamics_tpu_torch.train.main``."""
    import csv
    import logging

    import torch
    import yaml

    from vae_channel_dynamics_tpu_torch import train as train_cli
    from vae_channel_dynamics_tpu_torch.models import io as model_io
    from vae_channel_dynamics_tpu_torch.models import vae as tvae
    from vae_channel_dynamics_tpu_torch.ops import flash_attention as fa
    from vae_channel_dynamics_tpu_torch.ops import fused_resnet as fr
    from vae_channel_dynamics_tpu_torch.ops import group_norm_kernel as gnk
    from vae_channel_dynamics_tpu_torch.utils.config_utils import load_config

    root = os.path.dirname(os.path.abspath(__file__))
    model_dir = os.path.join(tmp, "planted_fused_sdxl_vae")
    t0 = time.perf_counter()
    write_planted_model_dir(model_dir, FUSED_PLANTED_NORM)
    cfg = load_config(os.path.join(root, FUSED_TRAINER_CONFIG))
    cfg["output_dir"] = tmp
    cfg["model"].update(kernel_impl="fused", pretrained_vae_name=model_dir, remat="none")
    cfg["logit_lens"]["enabled"] = False
    cfg["profiling"]["enabled"] = False
    cfg["training"]["stop_after_steps"] = FUSED_TRAINER_STEPS
    cfg["tracking"] = {"enabled": True, "track_interval": TRACK_INTERVAL, "target_layers": [
        {"name": n, "capture_point": "output", "metrics": ["mean_abs_activation_per_channel"]}
        for n in FUSED_TAPS]}
    layer = f"vae.{FUSED_PLANTED_NORM}.output"
    cfg["classification"] = {"enabled": True, "method": "threshold_groupnorm_activity",
                             "threshold": CLASSIFY_THRESHOLD,
                             "target_metric_key": "mean_abs_activation_per_channel",
                             "layers_to_classify": [layer]}
    cfg["intervention"] = {"enabled": True, "strategy": "gentle_nudge_groupnorm_scale",
                           "nudge_factor": NUDGE_FACTOR, "max_scale_value": NUDGE_CAP,
                           "intervention_interval": TRACK_INTERVAL}
    path = os.path.join(tmp, "fused.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    res, batch = int(cfg["data"]["resolution"]), int(cfg["data"]["batch_size"])
    log(f"[fused-trainer] {FUSED_TRAINER_CONFIG} with kernel_impl fused, remat none, "
        f"mixed_precision {cfg['training']['mixed_precision']}, {res}px batch {batch}, "
        f"{FUSED_TRAINER_STEPS} steps, taps {FUSED_TAPS}, gamma of {FUSED_PLANTED_NORM} "
        f"channels {list(PLANTED_CHANNELS)} at {PLANTED_GAMMA}; planted model dir written in "
        f"{time.perf_counter() - t0:.1f} s")

    package_logger = logging.getLogger("vae_channel_dynamics_tpu_torch")
    level = package_logger.level
    package_logger.setLevel(logging.WARNING)
    try:
        # ---- the main path: counts reset, the run, counts read ----
        sync()
        reset_peak()
        for counts in (fa.launches, gnk.launches, fr.launches, tvae.fused_blocks):
            for name in counts:
                counts[name] = 0
        t0 = time.perf_counter()
        check(train_cli.main(["--config_path", path, "--device", DEVICE]) == 0,
              "the fused Trainer run failed")
        wall = time.perf_counter() - t0
        launches = {**fa.launches, **gnk.launches, **fr.launches}
        blocks = dict(tvae.fused_blocks)
        peak = peak_gb()
    finally:
        package_logger.setLevel(level)
    release()

    fused_convs = 2 * SDXL_FUSED_AT_256
    want = {name: fused_convs for name in fr.KERNELS}
    want.update({"gn_fwd_reduce": fused_convs, "gn_fwd_normalize": 0,
                 "gn_bwd_reduce": fused_convs, "gn_bwd_dx": fused_convs,
                 **{name: 0 for name in fa.launches}})
    per_step = {k: v / FUSED_TRAINER_STEPS for k, v in launches.items()}
    log(f"[fused-trainer] kernel launches in the {FUSED_TRAINER_STEPS}-step run: {launches}; "
        f"resnets fused/unfused {blocks}")
    check(per_step == want, f"launches per step {per_step}, want {want}")
    check(blocks == {"fused": SDXL_FUSED_AT_256 * FUSED_TRAINER_STEPS,
                     "unfused": (SDXL_RESNETS - SDXL_FUSED_AT_256) * FUSED_TRAINER_STEPS},
          f"resnets fused/unfused {blocks}")

    run_dir = os.path.join(tmp, cfg["run_name"])
    with open(os.path.join(run_dir, "intervention_history.csv")) as f:
        interventions = [row for row in csv.reader(f)]
    check([row[0] for row in interventions] == [str(TRACK_INTERVAL), str(FUSED_TRAINER_STEPS)],
          f"intervention_history.csv rows {interventions}")
    check(all(int(row[1]) >= len(PLANTED_CHANNELS) and int(row[2]) > 0 for row in interventions),
          f"the planted channels were not classified and nudged: {interventions}")
    with open(os.path.join(run_dir, "tracked_activation_stats.csv")) as f:
        stats_rows = list(csv.reader(f))
    check(stats_rows[0] == CSV_COLUMNS, f"tracked_activation_stats.csv columns {stats_rows[0]}")
    tapped = {r[1] for r in stats_rows[1:]}
    check({r[0] for r in stats_rows[1:]} == {str(TRACK_INTERVAL), str(FUSED_TRAINER_STEPS)}
          and all(any(t in name for name in tapped) for t in FUSED_TAPS),
          f"tracked_activation_stats.csv steps or layers: {tapped}")
    final = os.path.join(run_dir, "final_model")
    _cfg, weights = model_io.load_model_dir(os.path.join(final, "vae"))
    trained = torch.load(os.path.join(final, "state", "train_state.pt"), weights_only=True)
    check(weights.keys() == trained["params"].keys()
          and all(torch.equal(weights[k], trained["params"][k]) for k in weights),
          "final_model/vae does not hold the trained weights")
    gamma = weights[f"{FUSED_PLANTED_NORM}.weight"][list(PLANTED_CHANNELS)]
    check(bool((gamma > PLANTED_GAMMA).all()), f"planted gamma not nudged: {gamma.tolist()}")
    log(f"[fused-trainer] {FUSED_TRAINER_STEPS} steps in {wall:.1f} s (model load, control loop "
        f"and final model included); peak device memory {peak:.2f} GB; interventions "
        f"{interventions}; planted gamma now {gamma.tolist()[:2]}")
    return {"launches": launches}


def write_planted_model_dir(path: str, planted_norm: str = TRAINER_PLANTED_NORM) -> None:
    """A full-width SDXL model dir from the seed, with PLANTED_CHANNELS of
    ``planted_norm`` at gamma PLANTED_GAMMA, for the control loop to find."""
    import torch

    from vae_channel_dynamics_tpu_torch.models import AutoencoderKL
    from vae_channel_dynamics_tpu_torch.models import io as model_io

    model = AutoencoderKL(train_config(), device=DEVICE)
    model.init_weights(torch.Generator(device=DEVICE).manual_seed(SEED))
    with torch.no_grad():
        model.get_submodule(planted_norm).weight[list(PLANTED_CHANNELS)] = PLANTED_GAMMA
    model_io.save_model_dir(path, model.config, model.state_dict())
    del model
    release()


def phase_trainer_1024(tmp: str):
    """The 1024px Trainer slice through the training CLI, uninterrupted for
    TRAINER_STEPS steps, then resumed from its step-TRAINER_SAVE checkpoint;
    see the module docstring (8)."""
    import csv
    import logging

    import torch
    import yaml

    from vae_channel_dynamics_tpu_torch import train as train_cli
    from vae_channel_dynamics_tpu_torch.models import io as model_io
    from vae_channel_dynamics_tpu_torch.ops import flash_attention as fa
    from vae_channel_dynamics_tpu_torch.ops import group_norm_kernel as gnk
    from vae_channel_dynamics_tpu_torch.training import loop
    from vae_channel_dynamics_tpu_torch.utils.config_utils import load_config

    root = os.path.dirname(os.path.abspath(__file__))
    model_dir = os.path.join(tmp, "planted_sdxl_vae")
    t0 = time.perf_counter()
    write_planted_model_dir(model_dir)
    cfg = load_config(os.path.join(root, TRAINER_CONFIG))
    cfg["model"].update(attention_impl="flash", kernel_impl="pallas",
                        pretrained_vae_name=model_dir)
    cfg["training"]["stop_after_steps"] = TRAINER_STEPS
    cfg["saving"]["save_interval_steps"] = TRAINER_SAVE
    configs = {}
    for run in ("uninterrupted", "resumed", "faulty"):
        cfg["output_dir"] = os.path.join(tmp, run)
        if run == "faulty":
            cfg["training"]["stop_after_steps"] = TRAINER_SAVE + FAULTY_STEPS
        configs[run] = os.path.join(tmp, f"{run}.yaml")
        with open(configs[run], "w") as f:
            yaml.safe_dump(cfg, f)
    run_name = cfg["run_name"]
    res, batch = int(cfg["data"]["resolution"]), int(cfg["data"]["batch_size"])
    log(f"[trainer] {TRAINER_CONFIG} with attention_impl flash, kernel_impl pallas, remat "
        f"{cfg['model']['remat']}, mixed_precision {cfg['training']['mixed_precision']}, "
        f"{res}px batch {batch}, {TRAINER_STEPS} steps, a checkpoint every {TRAINER_SAVE}; "
        f"planted model dir written in {time.perf_counter() - t0:.1f} s")

    # per-step losses (device tensors, read after the run) and the host clock
    # at the start of step TRAINER_SAVE + 1 and the end of step
    # TRAINER_STEPS, synchronised, through a wrapper on the Trainer's steps
    losses, marks, current = {}, {}, {}
    make_train_step = loop.make_train_step

    def timed_make_train_step(*args, **kwargs):
        step_fn = make_train_step(*args, **kwargs)

        def step(state, *a, **kw):
            if state.step == TRAINER_SAVE:
                sync()
                marks[(current["run"], "start")] = time.perf_counter()
            profiled = (current["run"] == "uninterrupted"
                        and state.step == TRAINER_PROFILE_STEP - 1)
            if profiled:
                from torch.profiler import ProfilerActivity, profile

                sync()
                activities = [ProfilerActivity.CPU]
                if DEVICE == "cuda":
                    activities.append(ProfilerActivity.CUDA)
                prof = profile(activities=activities)
                prof.__enter__()
                t0 = time.perf_counter()
            out = step_fn(state, *a, **kw)
            if profiled:
                sync()
                wall_ms = (time.perf_counter() - t0) * 1e3
                prof.__exit__(None, None, None)
                log(f"[profile] step {TRAINER_PROFILE_STEP} of the 1024px Trainer run "
                    "(flash, pallas, remat full), inside the Trainer:")
                _profile_breakdown(prof, wall_ms)
            losses[(current["run"], out[0].step)] = out[1]["train_loss_step"]
            if out[0].step == TRAINER_STEPS:
                sync()
                marks[(current["run"], "end")] = time.perf_counter()
            return out

        return step

    package_logger = logging.getLogger("vae_channel_dynamics_tpu_torch")
    level = package_logger.level
    loop.make_train_step = timed_make_train_step
    package_logger.setLevel(logging.WARNING)
    try:
        # ---- the main path: counts reset, the uninterrupted run, counts read ----
        current["run"] = "uninterrupted"
        sync()
        reset_peak()
        for counts in (fa.launches, gnk.launches):
            for name in counts:
                counts[name] = 0
        t0 = time.perf_counter()
        check(train_cli.main(["--config_path", configs["uninterrupted"],
                              "--device", DEVICE]) == 0,
              "the uninterrupted run failed")
        wall = time.perf_counter() - t0
        launches = {**fa.launches, **gnk.launches}
        peak = peak_gb()
        release()
        current["run"] = "resumed"
        run_dir = os.path.join(tmp, "uninterrupted", run_name)
        ckpt = os.path.join(run_dir, f"chkpt-{TRAINER_SAVE}")
        t1 = time.perf_counter()
        check(train_cli.main(["--config_path", configs["resumed"], "--resume_from", ckpt,
                              "--device", DEVICE]) == 0,
              "the resumed run failed")
        resumed_wall = time.perf_counter() - t1
        release()
        # the planted fault: chkpt-10 with AdamW's moments zeroed (the step
        # count, the weights and the stream position kept), resumed for
        # FAULTY_STEPS steps
        faulty = os.path.join(tmp, "faulty_chkpt")
        shutil.copytree(ckpt, faulty)
        state_file = os.path.join(faulty, "state", "train_state.pt")
        saved = torch.load(state_file, weights_only=True)
        for moment in ("mu", "nu"):
            saved["opt"][moment] = [torch.zeros_like(t) for t in saved["opt"][moment]]
        torch.save(saved, state_file)
        del saved
        current["run"] = "faulty"
        check(train_cli.main(["--config_path", configs["faulty"], "--resume_from", faulty,
                              "--device", DEVICE]) == 0,
              "the run resumed from the faulty checkpoint failed")
        release()
    finally:
        loop.make_train_step = make_train_step
        package_logger.setLevel(level)

    per_step = {k: v / TRAINER_STEPS for k, v in launches.items()}
    want = {"flash_attention_fwd": 0, "flash_attention_fwd_f32": 0,
            "flash_attention_fwd_lse": SDXL_ATTENTIONS,
            "flash_attention_bwd_dkv": SDXL_ATTENTIONS, "flash_attention_bwd_dq": SDXL_ATTENTIONS,
            "gn_fwd_reduce": SDXL_NORMS + SDXL_RESNET_NORMS,
            "gn_fwd_normalize": SDXL_NORMS + SDXL_RESNET_NORMS,
            "gn_bwd_reduce": SDXL_NORMS, "gn_bwd_dx": SDXL_NORMS}
    log(f"[trainer] kernel launches in the {TRAINER_STEPS}-step run: {launches}; per step "
        f"{per_step}")
    check(per_step == want, f"launches per step {per_step}, want {want}")

    # the resumed run: from step TRAINER_SAVE at the same stream position, its
    # losses those of the uninterrupted run
    with open(os.path.join(ckpt, "resume_meta.json")) as f:
        meta = json.load(f)
    check(meta == {"micro_step": TRAINER_SAVE, "global_step": TRAINER_SAVE, "epoch": 0,
                   "in_epoch_batches": TRAINER_SAVE}, f"chkpt-{TRAINER_SAVE} meta {meta}")
    resumed_steps = sorted(s for r, s in losses if r == "resumed")
    check(resumed_steps == list(range(TRAINER_SAVE + 1, TRAINER_STEPS + 1)),
          f"the resumed run took steps {resumed_steps}")
    rows, worst = [], 0.0
    for s in resumed_steps:
        a = float(losses[("uninterrupted", s)])
        r = float(losses[("resumed", s)])
        check(math.isfinite(a) and math.isfinite(r), f"step {s}: loss {a}, resumed {r}")
        worst = max(worst, abs(r - a) / abs(a))
        rows.append(f"{s}: {a!r}/{r!r}")
    faulty_steps = sorted(s for r, s in losses if r == "faulty")
    check(faulty_steps == list(range(TRAINER_SAVE + 1, TRAINER_SAVE + FAULTY_STEPS + 1)),
          f"the faulty resume took steps {faulty_steps}")
    fault = max(abs(float(losses[("faulty", s)]) - float(losses[("uninterrupted", s)]))
                / abs(float(losses[("uninterrupted", s)])) for s in faulty_steps)
    log(f"[trainer] losses uninterrupted/resumed, steps {TRAINER_SAVE + 1}-{TRAINER_STEPS}: "
        + ", ".join(rows) + f"; max rel difference {worst!r} (bound {RESUME_LOSS_REL}); "
        f"resumed with AdamW's moments zeroed, steps {faulty_steps}: "
        + ", ".join(f"{s}: {float(losses[('faulty', s)])!r}" for s in faulty_steps)
        + f", max rel difference {fault!r}")
    check(worst <= RESUME_LOSS_REL, f"the resumed losses are {worst} from the uninterrupted")
    check(fault > RESUME_LOSS_REL,
          f"the resume bound does not reject zeroed AdamW moments ({fault})")

    # the control loop's artifacts, in the JAX package's schema
    with open(os.path.join(run_dir, "intervention_history.csv")) as f:
        interventions = [row for row in csv.reader(f)]
    check([row[0] for row in interventions] == [str(TRAINER_SAVE), str(TRAINER_STEPS)],
          f"intervention_history.csv rows {interventions}")
    check(all(int(row[1]) >= len(PLANTED_CHANNELS) and int(row[2]) > 0 for row in interventions),
          f"the planted channels were not classified and nudged: {interventions}")
    with open(os.path.join(run_dir, "tracked_activation_stats.csv")) as f:
        stats_rows = list(csv.reader(f))
    check(stats_rows[0] == CSV_COLUMNS, f"tracked_activation_stats.csv columns {stats_rows[0]}")
    check({r[0] for r in stats_rows[1:]} == {str(TRAINER_SAVE), str(TRAINER_STEPS)},
          "tracked_activation_stats.csv does not hold the interval steps")

    # final_model/vae reloads in the port with the trained weights
    final = os.path.join(run_dir, "final_model")
    _cfg, weights = model_io.load_model_dir(os.path.join(final, "vae"))
    trained = torch.load(os.path.join(final, "state", "train_state.pt"), weights_only=True)
    check(weights.keys() == trained["params"].keys()
          and all(torch.equal(weights[k], trained["params"][k]) for k in weights),
          "final_model/vae does not hold the trained weights")
    gamma = weights[f"{TRAINER_PLANTED_NORM}.weight"][list(PLANTED_CHANNELS)]
    check(bool((gamma > PLANTED_GAMMA).all()), f"planted gamma not nudged: {gamma.tolist()}")

    timed = {}
    for run in ("uninterrupted", "resumed"):
        sec = marks[(run, "end")] - marks[(run, "start")]
        timed[run] = 1e3 * sec / (TRAINER_STEPS - TRAINER_SAVE)
    log(f"[trainer] steps {TRAINER_SAVE + 1}-{TRAINER_STEPS} (host clock, synchronised at "
        f"both ends): uninterrupted {timed['uninterrupted']:.2f} ms/step "
        f"({batch * 1e3 / timed['uninterrupted']:.4f} img/s; the step-{TRAINER_SAVE} "
        f"checkpoint's writer thread runs beside them), resumed {timed['resumed']:.2f} "
        f"ms/step ({batch * 1e3 / timed['resumed']:.4f} img/s); peak device memory "
        f"{peak:.2f} GB; whole runs {wall:.1f} s and {resumed_wall:.1f} s (model load, "
        f"checkpoints, final model); interventions {interventions}; planted gamma now "
        f"{gamma.tolist()[:2]}")
    return {"launches": launches, "model_dir": model_dir}


def phase_flash_step_1024(model_dir: str):
    """One 1024px step with flash attention against one with naive, from the
    same weights, batch and noise (remat none), held to naive bf16 against
    naive fp32; then timed steps of both in turns and a profile of a flash
    step. See the module docstring (9)."""
    import numpy as np
    import torch

    from vae_channel_dynamics_tpu_torch.models import AutoencoderKL
    from vae_channel_dynamics_tpu_torch.models import io as model_io
    from vae_channel_dynamics_tpu_torch.training import TrainState, build_optimizer
    from vae_channel_dynamics_tpu_torch.training import make_train_step

    config, weights = model_io.load_model_dir(model_dir)
    model = AutoencoderKL(config, impl="pallas", dtype=torch.bfloat16, attn_impl="flash",
                          device=DEVICE)
    model.load_state_dict(weights)
    del weights
    res = FLASH_STEP_RES
    rng = np.random.default_rng(SEED + 4)
    batches = [torch.from_numpy(rng.integers(0, 256, (1, res, res, 3), dtype=np.uint8)).to(DEVICE)
               for _ in range(2)]
    mask = torch.ones(1, device=DEVICE)
    latent = res // 2 ** (len(config.block_out_channels) - 1)
    noise = torch.randn((1, latent, latent, 4), device=DEVICE,
                        generator=torch.Generator(device=DEVICE).manual_seed(SEED + 5))
    names = [f"{part}.mid_block.attentions.0.{leaf}" for part in ("encoder", "decoder")
             for leaf in ("group_norm.weight", "to_q.weight", "to_k.weight", "to_v.weight",
                          "to_out.0.weight", "to_out.0.bias")]

    class GradCapture:
        """Stands in for the optimizer: keeps the named gradients and
        updates nothing."""

        grads = {}

        def init(self, params):
            return None

        def update(self, grads, opt_state, params):
            self.grads = {n: grads[n].float().clone() for n in names}
            return False

    def one_step(impl, dtype):
        set_attention(model, impl).set_compute_dtype(dtype)
        tx = GradCapture()
        step = make_train_step(model, tx, TRAIN_KL)
        _state, metrics, _ = step(TrainState.create(model, tx), {"pixel_values": batches[0]},
                                  mask, noise=noise)
        out = {"loss": float(metrics["train_loss_step"]),
               "grad_norm": float(metrics["grad_norm"]), **tx.grads}
        release()
        return out

    runs = {"flash bf16": one_step("flash", torch.bfloat16),
            "naive bf16": one_step("naive", torch.bfloat16),
            "naive fp32": one_step("naive", torch.float32)}
    f, n, c = runs["flash bf16"], runs["naive bf16"], runs["naive fp32"]

    def rel(a, b):
        if isinstance(a, float):
            return abs(a - b) / abs(b)
        return ((a - b).norm() / b.norm()).item()

    rows = []
    for key in ["loss", "grad_norm", *names]:
        d, control = rel(f[key], n[key]), rel(n[key], c[key])
        floor = STEP_SCALAR_FLOOR if key in ("loss", "grad_norm") else STEP_FLOOR
        rows.append(f"{key} {d:.3g} (control {control:.3g})")
        check(d <= STEP_CONTROL_RATIO * control + floor,
              f"1024px step {key}: flash is {d} from naive, control {control}")
    log(f"[flash-step] 1024px step, flash vs naive (bf16), relative (rel L2 for the mid-block "
        f"attention gradients); control naive bf16 vs fp32; bound {STEP_CONTROL_RATIO} x "
        f"control + floor: " + "; ".join(rows))
    log(f"[flash-step] loss flash {f['loss']:.6g}, naive {n['loss']:.6g}, fp32 {c['loss']:.6g}; "
        f"grad_norm {f['grad_norm']:.6g}, {n['grad_norm']:.6g}, {c['grad_norm']:.6g}")
    del runs, f, n, c

    # timed steps with AdamW from the same weights, in turns
    set_attention(model, "flash").set_compute_dtype(torch.bfloat16)
    tx, _ = build_optimizer(TRAIN_LR, TRAIN_WARMUP, 10_000, max_grad_norm=TRAIN_CLIP)
    state = TrainState.create(model, tx)
    step = make_train_step(model, tx, TRAIN_KL)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 6)
    peaks = {}

    # the paths: attention impl and remat; "flash+remat" is the Trainer
    # slice's step, here without the Trainer around it
    paths = {"naive": ("naive", "none"), "flash": ("flash", "none"),
             "flash+remat": ("flash", "full")}

    def block(path, steps):
        impl, remat = paths[path]
        set_attention(model, impl).set_remat(remat)
        sync()
        reset_peak()
        t0 = time.perf_counter()
        for i in range(steps):
            step(state, {"pixel_values": batches[i % 2]}, mask, gen)
        sync()
        peaks[path] = max(peaks.get(path, 0.0), peak_gb())
        return (time.perf_counter() - t0) / steps * 1e3

    for path in paths:  # warm-up of every path's allocations
        block(path, 1)
    peaks.clear()
    order = ("naive", "flash", "flash+remat", "flash+remat", "flash", "naive")
    times = {}
    for path in order:
        times.setdefault(path, []).append(block(path, FLASH_TIMED_STEPS))
    log(f"[flash-step] 1024px batch 1 train step, {2 * FLASH_TIMED_STEPS} steps of each path "
        f"in turns {order}: " + "; ".join(
            f"{path} {sum(t) / 2:.2f} ms/step [{t[0]:.2f}, {t[1]:.2f}] "
            f"({2e3 / sum(t):.4f} img/s), peak device memory {peaks[path]:.2f} GB"
            for path, t in times.items()))

    set_attention(model, "flash").set_remat("none")
    step(state, {"pixel_values": batches[0]}, mask, gen)
    sync()
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if DEVICE == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        step(state, {"pixel_values": batches[1]}, mask, gen)
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    log("[profile] one 1024px flash step (remat none):")
    _profile_breakdown(prof, wall_ms)
    del model, state, tx, batches
    release()


def _conv_halo_wrapped(x, w, bias):
    """The plain conv with the halo's zero-fill skipped in W: each image's
    rows laid end to end, so a column shifted past the edge reads the
    neighbouring row's end pixel instead of a zero."""
    import torch
    import torch.nn.functional as F

    n, h, wd, cin = x.shape
    rows = F.pad(x.float(), (0, 0, 0, 0, 1, 1)).reshape(n, (h + 2) * wd, cin)
    flat = F.pad(rows, (0, 0, 1, 1))
    wf = w.float()
    acc = torch.zeros((n, h * wd, w.shape[-1]), dtype=torch.float32, device=x.device)
    for dy in range(3):
        for dx in range(3):
            acc += flat[:, dy * wd + dx:dy * wd + dx + h * wd] @ wf[dy, dx]
    return (acc + bias.float()).reshape(n, h, wd, -1).to(x.dtype)


def conv_bound(n, h, w, cin, cout) -> tuple[float, str]:
    """#12's bound: 2 N H W 9 Cin Cout FLOPs; bytes of the bf16 input, weight
    and output and the fp32 bias, each once."""
    return roofline(2 * n * h * w * 9 * cin * cout,
                    2 * n * h * w * (cin + cout) + 2 * 9 * cin * cout + 4 * cout)


def phase_conv_nhwc():
    """Kernel #12 against its plain version at CONV_SHAPES, with its three
    planted faults, bit-equality run to run, and kernel, plain, bound and
    cuDNN channels_last times; then the ported conv bench in-process, whose
    launches are the main path's."""
    import torch

    from vae_channel_dynamics_tpu_torch.experiments import conv_bench
    from vae_channel_dynamics_tpu_torch.ops import conv_nhwc as cn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bf16 = torch.bfloat16
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 30)
    result = {"max_abs_err": 0.0}
    for shape in CONV_SHAPES:
        n, h, w, c = shape
        x = torch.randn(shape, generator=gen, device=DEVICE).to(bf16)
        wt = (torch.randn((3, 3, c, c), generator=gen, device=DEVICE) / math.sqrt(9 * c)).to(bf16)
        bias = 0.5 * torch.randn(c, generator=gen, device=DEVICE)
        y = cn.conv3x3_nhwc(x, wt, bias)
        y2 = cn.conv3x3_nhwc(x, wt, bias)
        sync()
        check(torch.equal(y, y2), f"#12 differs between two runs at {shape}")
        ref = cn.conv3x3_nhwc_reference(x, wt, bias)
        check(bool(torch.isfinite(y.float()).all()), f"#12 output not finite at {shape}")
        atol = CONV_ULPS * bf16_ulp(ref.float().abs().max().item())
        err, rel = kernel_errors(y, ref)
        result["max_abs_err"] = max(result["max_abs_err"], err)
        dropped = wt.clone()
        dropped[1, 1, :32] = 0
        faults = {"halo zero-fill skipped": _conv_halo_wrapped(x, wt, bias),
                  "tap (1, 1) K chunk 0-31 left out": cn.conv3x3_nhwc_reference(x, dropped, bias),
                  "bias left out": cn.conv3x3_nhwc_reference(x, wt, None)}
        fault_errs = {name: kernel_errors(f, ref) for name, f in faults.items()}
        del y2, dropped, faults
        check(err <= atol and rel <= CONV_REL_L2,
              f"#12 disagrees with plain at {shape}: max abs {err}, rel L2 {rel}")
        for name, (f_err, f_rel) in fault_errs.items():
            check(f_err > atol or f_rel > CONV_REL_L2,
                  f"the #12 bound at {shape} does not reject its planted fault: {name}")
        bias16 = bias.to(bf16)
        ms, plain_ms = timed_pair(lambda: cn.conv3x3_nhwc(x, wt, bias),
                                  lambda: cn.conv3x3_nhwc_reference(x, wt, bias), CONV_ITERS)
        lib_ms = cuda_ms(lambda: conv_bench.cudnn_conv3x3(x, wt, bias16), CONV_ITERS)
        bound_ms, bound_by = conv_bound(n, h, w, c, c)
        log(f"[conv-nhwc] {shape} -> {c} bf16: max abs {err:.4g} (bound {atol:.4g}, "
            f"{CONV_ULPS} bf16 ulps of max|plain|), rel L2 {rel:.3g} (bound {CONV_REL_L2}); "
            + ", ".join(f"{name}: max abs {f[0]:.4g}, rel L2 {f[1]:.3g}"
                        for name, f in fault_errs.items())
            + f"; bit-equal run to run; ms kernel {ms:.4f}, plain {plain_ms:.4f}, bound "
            f"{bound_ms:.4f} ({bound_by}, {100 * bound_ms / ms:.1f}% of it), cuDNN "
            f"channels_last {lib_ms:.4f}")
        if shape == CONV_SHAPES[0]:
            result.update(shape=[*shape, c], ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by, library_ms=lib_ms,
                          library_covers="F.conv2d on the channels_last view, with bias")
        del x, wt, bias, bias16, y, ref
        release()

    # ---- the main path: counts reset, the conv bench, counts read ----
    cn.launches["conv3x3_nhwc"] = 0
    t0 = time.perf_counter()
    check(conv_bench.main(["all", "--device", DEVICE]) == 0, "the conv bench failed")
    result["launches"] = cn.launches["conv3x3_nhwc"]
    log(f"[conv-nhwc] conv bench (all) in {time.perf_counter() - t0:.1f} s; "
        f"#12 launches {result['launches']}")
    check(result["launches"] > 0, "the conv bench did not launch #12")
    release()
    return result


def sdpa_fp32_ms(q, k, v, scale: float, iters: int) -> tuple[str, float]:
    """The first SDPA backend that runs an fp32 forward at head dim 512, and
    its CUDA-event ms on (B, N, C) as one head (the yardstick only)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    q4, k4, v4 = (t.unsqueeze(1) for t in (q, k, v))
    for backend in (SDPBackend.EFFICIENT_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.MATH):
        try:
            with sdpa_kernel([backend]), warnings.catch_warnings(), torch.no_grad():
                warnings.simplefilter("ignore", UserWarning)
                F.scaled_dot_product_attention(q4, k4, v4, scale=scale)
                sync()
        except RuntimeError as e:
            log(f"[sdpa] {backend.name} refuses fp32 at head dim 512: "
                f"{str(e).splitlines()[0][:120]}")
            continue
        with sdpa_kernel([backend]), torch.no_grad():
            return backend.name, cuda_ms(
                lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=scale), iters)
    raise SmokeFailure("no SDPA backend runs fp32 at head dim 512")


def phase_flash_f32():
    """The fp32 flash forward against its plain version at FLASH_F32_SHAPE,
    TF32 off, bit-equal run to run, with the dropped-tile and the one-TF32-
    product faults, and its times against plain and SDPA at fp32 beside the
    3xTF32 bound."""
    import torch

    from vae_channel_dynamics_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    b, n, c = FLASH_F32_SHAPE
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 40)
    q, k, v = (torch.randn(FLASH_F32_SHAPE, generator=gen, device=DEVICE) for _ in range(3))
    scale = c ** -0.5
    out = fa.flash_attention_fwd(q, k, v, scale=scale, out_dtype=torch.float32)
    out2 = fa.flash_attention_fwd(q, k, v, scale=scale, out_dtype=torch.float32)
    sync()
    check(out.dtype == torch.float32 and bool(torch.isfinite(out).all()),
          "the fp32 flash output is not finite fp32")
    check(torch.equal(out, out2), "the fp32 flash forward differs between two runs")
    del out2
    ref = fa.flash_attention_reference(q, k, v, scale, torch.float32)
    err, rel = kernel_errors(out, ref)
    fault = fa.flash_attention_reference(q, k[:, :-FAULT_TILE].contiguous(),
                                         v[:, :-FAULT_TILE].contiguous(), scale, torch.float32)
    fault_err, fault_rel = kernel_errors(fault, ref)
    # one TF32 product, what the kernel would give without its lo products
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        fault = fa.flash_attention_reference(q, k, v, scale, torch.float32)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    _, tf32_rel = kernel_errors(fault, ref)
    del fault
    check(rel <= FLASH_F32_REL_L2, f"the fp32 flash forward is {rel} (rel L2) from plain")
    check(fault_rel > FLASH_F32_REL_L2, "the fp32 flash bound does not reject a dropped key tile")
    check(tf32_rel > FLASH_F32_REL_L2, "the fp32 flash bound does not reject one TF32 product")
    ms, plain_ms = timed_pair(
        lambda: fa.flash_attention_fwd(q, k, v, scale=scale, out_dtype=torch.float32),
        lambda: fa.flash_attention_reference(q, k, v, scale, torch.float32), FLASH_F32_ITERS)
    backend, lib_ms = sdpa_fp32_ms(q, k, v, scale, FLASH_F32_ITERS)
    flops = 4 * b * n * n * c
    nbytes = 4 * 4 * b * n * c
    bound_ms, bound_by = roofline(3 * flops, nbytes, PEAK_TF32_FLOPS)
    simt_ms, _ = roofline(flops, nbytes, PEAK_FP32_FLOPS)
    log(f"[flash-f32] {FLASH_F32_SHAPE} fp32, TF32 off: max abs {err:.4g}, rel L2 {rel:.4g} "
        f"(bound {FLASH_F32_REL_L2}); bit-equal run to run; one dropped {FAULT_TILE}-key tile: "
        f"rel L2 {fault_rel:.4g}; one TF32 product (plain, TF32 on): rel L2 {tf32_rel:.4g}; "
        f"ms kernel {ms:.4f} ({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f}, "
        f"3xTF32 bound {bound_ms:.4f} ({bound_by}, 3 x the products at 495 TFLOP/s; "
        f"{bound_ms / ms:.1%} of it), fp32 SIMT bound {simt_ms:.4f} (67 TFLOP/s), SDPA fp32 "
        f"({backend}) {lib_ms:.4f}")
    del q, k, v, out, ref
    release()
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms,
            "library_covers": f"scaled_dot_product_attention fp32 forward ({backend})",
            "shape": list(FLASH_F32_SHAPE)}


def write_seeded_model_dir(path: str) -> None:
    """The full-width SDXL VAE from the seed, written as a model dir."""
    import torch

    from vae_channel_dynamics_tpu_torch.models import AutoencoderKL, VAEConfig
    from vae_channel_dynamics_tpu_torch.models import io as model_io

    model = AutoencoderKL(VAEConfig.sdxl(), device=DEVICE)
    model.init_weights(torch.Generator(device=DEVICE).manual_seed(SEED))
    check(sum(p.numel() for p in model.parameters()) == SDXL_PARAMS,
          "the seeded model is not the full-width SDXL VAE")
    model_io.save_model_dir(path, model.config, model.state_dict())
    del model
    release()


def phase_eval(tmp: str, model_dir: str) -> dict:
    """The evaluation CLI in-process at full width (see EVAL_*): the bf16
    auto run with the lens, then the bf16 naive, fp32 naive and fp32 auto
    controls; metrics, launches, artifacts, images/s and peak memory."""
    import logging

    import yaml

    from vae_channel_dynamics_tpu_torch import evaluate
    from vae_channel_dynamics_tpu_torch.ops import flash_attention as fa

    runs = {"bf16 auto": ("bf16", "auto", True), "bf16 naive": ("bf16", "naive", False),
            "fp32 naive": ("no", "naive", False), "fp32 auto": ("no", "auto", False)}
    package_logger = logging.getLogger("vae_channel_dynamics_tpu_torch")
    level = package_logger.level
    metrics, launches, rows = {}, {}, []
    try:
        for label, (precision, impl, lens) in runs.items():
            tag = label.replace(" ", "_")
            cfg_path = os.path.join(tmp, f"eval_{tag}.yaml")
            with open(cfg_path, "w") as f:
                yaml.safe_dump({
                    "seed": SEED,
                    "data": {"dataset_name": f"synthetic://shapes?num_samples={EVAL_IMAGES}",
                             "resolution": EVAL_RES, "batch_size": EVAL_BATCH},
                    "training": {"mixed_precision": precision},
                    "model": {"attention_impl": impl},
                }, f)
            out_dir = os.path.join(tmp, f"eval_out_{tag}")
            package_logger.setLevel(logging.WARNING)
            sync()
            reset_peak()
            # ---- the main path: counts reset, one evaluation, counts read ----
            for name in fa.launches:
                fa.launches[name] = 0
            t0 = time.perf_counter()
            check(evaluate.main(["--config_path", cfg_path, "--checkpoint_path", model_dir,
                                 "--output_dir", out_dir, "--eval_split", "test",
                                 "--enable_logit_lens", str(lens).lower(),
                                 "--device", DEVICE]) == 0, f"evaluate ({label}) failed")
            sync()
            wall = time.perf_counter() - t0
            launches[label] = dict(fa.launches)
            peak = peak_gb()
            with open(os.path.join(out_dir, "eval_metrics.json")) as f:
                metrics[label] = json.load(f)
            m = metrics[label]
            check(m["num_samples"] == EVAL_IMAGES, f"{label}: {m['num_samples']} samples")
            check(all(math.isfinite(m[key]) for key in ("mse", "kl", "psnr", "ssim")),
                  f"{label}: non-finite metrics {m}")
            rows.append(f"{label}: mse {m['mse']:.6g}, kl {m['kl']:.6g}, psnr {m['psnr']:.6g}, "
                        f"ssim {m['ssim']:.6g}; {wall:.2f} s ({EVAL_IMAGES / wall:.2f} images/s "
                        f"with PNGs{' and the lens' if lens else ''}), peak {peak:.2f} GB; "
                        f"flash launches {launches[label]}")
            if lens:
                files = set(os.listdir(out_dir))
                check({f"sample_{i}_{kind}.png" for i in range(16)
                       for kind in ("orig", "recon")} <= files, f"{label}: PNG pairs missing")
                check({f"out_{i}.png" for i in range(EVAL_BATCH)} <= files,
                      f"{label}: out_*.png missing")
                lens_root = os.path.join(out_dir, "logit_lens_visualizations_eval", "step_0")
                for layer in EVAL_LENS_LAYERS:
                    png = os.path.join(lens_root, layer.replace(".", "_"), "logit_lens_projections",
                                       "lens_sample_0_single_channel_projections_combined.png")
                    check(os.path.isfile(png), f"{label}: the lens image {png} is missing")
            shutil.rmtree(out_dir)
            release()
    finally:
        package_logger.setLevel(level)
    # every forward of the auto runs went through its flash kernel: two
    # attentions a forward, four batches, and the lens's forward
    batches = EVAL_IMAGES // EVAL_BATCH
    check(launches["bf16 auto"]["flash_attention_fwd"] == SDXL_ATTENTIONS * (batches + 1)
          and launches["bf16 auto"]["flash_attention_fwd_f32"] == 0,
          f"bf16 auto launched {launches['bf16 auto']}")
    check(launches["fp32 auto"]["flash_attention_fwd_f32"] == SDXL_ATTENTIONS * batches
          and launches["fp32 auto"]["flash_attention_fwd"] == 0,
          f"fp32 auto launched {launches['fp32 auto']}")
    check(not any(launches["bf16 naive"].values()) and not any(launches["fp32 naive"].values()),
          "a naive run launched a flash kernel")
    ref = metrics["fp32 naive"]
    diffs = []
    for key in ("mse", "kl", "psnr", "ssim"):
        def rel(label):
            return abs(metrics[label][key] - ref[key]) / abs(ref[key])
        flash, control, f32 = rel("bf16 auto"), rel("bf16 naive"), rel("fp32 auto")
        diffs.append(f"{key} bf16 flash {flash:.3g} (control bf16 naive {control:.3g}), fp32 "
                     f"flash {f32:.3g}")
        check(flash <= EVAL_CONTROL_RATIO * control + EVAL_FLOOR,
              f"bf16 flash {key} is {flash} from fp32 naive, control {control}")
        check(f32 <= EVAL_F32_REL, f"fp32 flash {key} is {f32} from fp32 naive")
    log(f"[eval] sdxl VAE, {EVAL_IMAGES} synthetic images at {EVAL_RES}px, batch {EVAL_BATCH}: "
        + "; ".join(rows))
    log(f"[eval] relative to fp32 naive (bounds {EVAL_CONTROL_RATIO} x control + {EVAL_FLOOR:.3g},"
        f" fp32 {EVAL_F32_REL}): " + "; ".join(diffs))
    return launches["fp32 auto"]["flash_attention_fwd_f32"]


def phase_tiling(tmp: str, model_dir: str) -> None:
    """Tiled encode and decode of a 2048px image through the wrapper, flash
    against naive with the naive bf16-vs-fp32 control; peak memory of the
    tiled and the untiled 2048px decode; then the serve CLI tiled at
    1024px."""
    import logging

    import numpy as np
    import torch

    from vae_channel_dynamics_tpu_torch import serve
    from vae_channel_dynamics_tpu_torch.models import SDXLVAEWrapper
    from vae_channel_dynamics_tpu_torch.models import io as model_io
    from vae_channel_dynamics_tpu_torch.ops import flash_attention as fa
    from vae_channel_dynamics_tpu_torch.server import resolve_serving_attention_impl

    config, state_dict = model_io.load_model_dir(model_dir)
    impl = resolve_serving_attention_impl("auto", TILE_SIZE, config)
    check(impl == "flash", f"auto resolved to {impl!r} at tile {TILE_SIZE}")
    rng = np.random.default_rng(SEED)
    image = torch.from_numpy(rng.uniform(-1, 1, (1, TILE_RES, TILE_RES, 3)).astype(np.float32))
    outs, peaks = {}, {}
    for label, attn, dtype in (("flash bf16", "flash", torch.bfloat16),
                               ("naive bf16", "naive", torch.bfloat16),
                               ("naive fp32", "naive", torch.float32)):
        wrapper = SDXLVAEWrapper(config, state_dict=state_dict, dtype=dtype, attn_impl=attn,
                                 device=DEVICE)
        wrapper.enable_tiling(TILE_SIZE, TILE_OVERLAP)
        for name in fa.launches:
            fa.launches[name] = 0
        t0 = time.perf_counter()
        z = wrapper.encode(image, deterministic=True)
        sync()
        reset_peak()
        img = wrapper.decode(z)
        sync()
        wall = time.perf_counter() - t0
        peaks[label] = peak_gb()
        outs[label] = (z.float(), img.float())
        log(f"[tiling] {label}: {TILE_RES}px encode+decode in {TILE_SIZE}px tiles, {wall:.2f} s, "
            f"decode peak {peaks[label]:.2f} GB; flash launches {dict(fa.launches)}")
        if label == "flash bf16":
            check(fa.launches["flash_attention_fwd"] == 2 * TILE_COUNT,
                  f"tiled flash launched {dict(fa.launches)}, want one a tile")
            # the untiled decode of the same latents, for its peak memory
            wrapper.disable_tiling()
            release()
            reset_peak()
            untiled = wrapper.decode(z)
            sync()
            peaks["untiled"] = peak_gb()
            check(bool(torch.isfinite(untiled.float()).all()), "untiled decode not finite")
            del untiled
        del wrapper, z, img
        release()
    for i, key in enumerate(("latents", "image")):
        flash, naive, f32 = (outs[k][i] for k in ("flash bf16", "naive bf16", "naive fp32"))
        check(bool(torch.isfinite(flash).all()), f"tiled flash {key} not finite")
        d = ((flash - naive).norm() / naive.norm()).item()
        control = ((naive - f32).norm() / f32.norm()).item()
        log(f"[tiling] {key} {tuple(flash.shape)}: flash vs naive rel L2 {d:.4g} (control naive "
            f"bf16 vs fp32 {control:.4g}; bound {MODEL_CONTROL_RATIO} x control + {TILE_FLOOR})")
        check(d <= MODEL_CONTROL_RATIO * control + TILE_FLOOR,
              f"tiled flash {key} is {d} from naive, control {control}")
    log(f"[tiling] peak memory of the {TILE_RES}px decode: tiled {peaks['flash bf16']:.3f} GB, "
        f"untiled {peaks['untiled']:.3f} GB")
    check(peaks["flash bf16"] < peaks["untiled"], "the tiled decode's peak is not below the "
          "untiled one's")
    del outs
    release()

    out_dir = os.path.join(tmp, "serve_tiled")
    package_logger = logging.getLogger("vae_channel_dynamics_tpu_torch")
    level = package_logger.level
    package_logger.setLevel(logging.WARNING)
    try:
        for name in fa.launches:
            fa.launches[name] = 0
        t0 = time.perf_counter()
        check(serve.main(["--checkpoint_path", model_dir, "--output", out_dir,
                          "--input", f"synthetic://shapes?num_samples={SERVE_TILED_IMAGES}",
                          "--resolution", str(SERVE_TILED_RES), "--tile_size", str(TILE_SIZE),
                          "--batch_size", "2", "--device", DEVICE]) == 0,
              "the tiled serve CLI failed")
        wall = time.perf_counter() - t0
    finally:
        package_logger.setLevel(level)
    with open(os.path.join(out_dir, "serve_metrics.json")) as f:
        served = json.load(f)
    check(served["num_images"] == SERVE_TILED_IMAGES and math.isfinite(served["avg_mse"]),
          f"serve_metrics {served}")
    check(fa.launches["flash_attention_fwd"] > 0, "the tiled serve run did not launch flash")
    log(f"[tiling] serve CLI --resolution {SERVE_TILED_RES} --tile_size {TILE_SIZE}: "
        f"{served}, {wall:.2f} s, flash launches {dict(fa.launches)}")
    release()


def reset_peak() -> None:
    import torch

    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()


def peak_gb() -> float:
    """Peak device memory since :func:`reset_peak`, GB (0 off the card)."""
    import torch

    return torch.cuda.max_memory_allocated() / 1e9 if DEVICE == "cuda" else 0.0


def release() -> None:
    import torch

    gc.collect()
    if DEVICE == "cuda":
        torch.cuda.empty_cache()


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is not importable: {e}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke test "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    try:
        name, smi = phase_device()
        phase_build()
        kernel_results = phase_kernel()
        flash_results = phase_flash_bwd()
        gn_results = phase_gn_kernels()
        fused_results = phase_fused_kernels()
        conv_result = phase_conv_nhwc()
        f32_result = phase_flash_f32()
        with tempfile.TemporaryDirectory(prefix="vcd_chip_smoke_") as tmp:
            serve_launches = phase_slice(tmp)
        release()
        with tempfile.TemporaryDirectory(prefix="vcd_chip_smoke_") as tmp:
            model_dir = os.path.join(tmp, "sdxl_seeded")
            write_seeded_model_dir(model_dir)
            f32_result["launches"] = phase_eval(tmp, model_dir)
            phase_tiling(tmp, model_dir)
        release()
        bundle = phase_train()
        phase_step_compare(bundle)
        phase_step_times(bundle)
        phase_fused_step(bundle)
        del bundle
        release()
        with tempfile.TemporaryDirectory(prefix="vcd_chip_smoke_") as tmp:
            fused_trainer = phase_fused_trainer(tmp)
        release()
        with tempfile.TemporaryDirectory(prefix="vcd_chip_smoke_") as tmp:
            trainer = phase_trainer_1024(tmp)
            phase_flash_step_1024(trainer["model_dir"])
        check("jax" not in sys.modules, "jax was imported")
    except Exception as e:  # noqa: BLE001 — every phase failure fails the run
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    # each kernel at the shape of its main path: the serving forward at
    # 512px batch 4, the flash and GroupNorm training kernels at the 1024px
    # Trainer slice's shapes (the mid-block attention, the full-resolution
    # 128-channel norm), the fused resnet kernels at the 256px fused path's
    # (16, 512, 32, 32) -> 512, #12 at the conv bench's shape A, the fp32
    # forward at the 512px mid block's batch 4; the launches are the 1024px
    # Trainer run's, the fused ones the fused Trainer run's, the serving
    # forward's the server's, #12's the conv bench's, the fp32 forward's the
    # fp32 auto evaluation's. A library call that computes more or less than one kernel's
    # work says what it covers.
    serving = dict(kernel_results[KERNEL_SHAPES[0]], shape=list(KERNEL_SHAPES[0]),
                   library_covers="flash_attention_fwd")
    serving["max_abs_err"] = max(r["max_abs_err"] for r in kernel_results.values())
    rows = {"flash_attention_fwd": serving, "flash_attention_fwd_f32": f32_result,
            **flash_results, **gn_results, **fused_results, "conv3x3_nhwc": conv_result}
    launches = dict(trainer["launches"], flash_attention_fwd=serve_launches,
                    flash_attention_fwd_f32=f32_result["launches"],
                    conv3x3_nhwc=conv_result["launches"],
                    **{k: fused_trainer["launches"][k] for k in FUSED_REPLACES})
    sources = dict(FLASH_SOURCES, flash_attention_fwd_f32=FLASH_FWD_SOURCE,
                   conv3x3_nhwc=CONV_SOURCE, **{k: GN_SOURCE for k in GN_REPLACES},
                   **{k: FUSED_SOURCE for k in FUSED_REPLACES})
    replaces = dict(FLASH_REPLACES, flash_attention_fwd_f32=FLASH_F32_REPLACES,
                    conv3x3_nhwc=CONV_REPLACES, **GN_REPLACES, **FUSED_REPLACES)
    kernels = [{
        "name": kname,
        "route": "cuda",
        "source": sources[kname],
        "replaces": replaces[kname],
        "launches": launches[kname],
        "max_abs_err": r["max_abs_err"],
        "ms": r["ms"],
        "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"],
        "library_ms": r["library_ms"],
        "library_covers": r["library_covers"],
        "shape": r["shape"],
        **({"note": REDESIGNED[kname]} if kname in REDESIGNED else {}),
    } for kname, r in rows.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
