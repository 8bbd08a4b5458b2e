#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root. Phases, each printing what it found; any
failure exits non-zero without the final ``ok`` line:

1. device: the card's name, and name plus power limit from nvidia-smi;
2. build: the six kernel libraries, ``vae_channel_dynamics_tpu_torch/csrc/
   flash_attention_fwd.cu``, ``csrc/flash_attention_bwd.cu``,
   ``csrc/flash_attention_bwd_f32.cu``, ``csrc/group_norm.cu``,
   ``csrc/fused_resnet.cu`` and ``csrc/conv_nhwc.cu`` (nvcc, sm_90a, one
   nvcc each, started together), the seconds each took, and ptxas's
   registers and spills (none, and no stack frame, in the fp32 flash
   forward, the two bf16 backward kernels and the fp32 backward; no more
   than SPILL_LIMITS pins in the bf16 forward, the bf16 dK/dV at C = 768
   and the fp32 fused resnet kernels), and the flash kernels' clusters and
   shared memory a CTA at each width (the libraries' own bytes, held to the
   Python mirrors of their layouts); for the kernels
   on wgmma/TMA through ``csrc/sm90_wgmma.cuh`` (the bf16 and fp32 flash
   forwards, the bf16 and fp32 dK/dV and dQ kernels, #9, #10 and #12 on the
   shared loop of ``csrc/sm90_conv3x3.cuh``, #9 and #10 at fp32 on its
   3xTF32 loop, #11 in bf16 and fp32), the HGMMA, UTMALDG and HMMA
   instructions in their SASS (cuobjdump): HGMMA and UTMALDG present, no
   HMMA; then
   ``tools/doctor.py --device cuda`` in-process, every check passing;
3. flash kernel vs plain: bf16 q/k/v from a seed at the serving shapes, the
   kernel's max abs and relative L2 error against
   ``flash_attention_reference``, bit-equal run to run, proof that the
   bound rejects a kernel that drops one key tile and the design's own
   faults (one warpgroup's partial logits left out; the last tile's P V,
   issued after the loop, left out of O), K and V's intake from L2 into the
   SMs, and the times from CUDA events;
3'. flash training kernels vs plain at (1, 16384, 512) and (4, 4096, 512):
   the LSE forward's lse, and dQ, dK, dV from the two backward kernels
   (bit-equal run to run), against their plain versions, each bound shown to
   reject a planted fault (one query tile left out of dK/dV, one key tile
   left out of dQ, the cluster's last rank left out of the logits' sums,
   delta left out of dS, the row max in place of lse); kernel, plain and
   library (``scaled_dot_product_attention`` forward and backward, the
   backend named) times from CUDA events; the backward kernels also at
   C = 128 and 384 (clusters of one and of three CTAs), and timed at
   (1, 16384, 128), whose CTAs do C = 512's work without traffic between
   SMs, to price the exchange; the same at fp32 (fp32 training: the fp32
   LSE forward, the fp32 backward) against fp32 plain with TF32 off, also
   rejecting one TF32 product (plain with TF32 on) and the backward's lo
   products left out (1xTF32: every tensor-core operand rounded to its TF32
   hi), bit-equal run to run, timed beside SDPA at fp32; the fp32 training
   kernels at logits of several hundred (LARGE_LOGITS_SHAPE, q and k x 8)
   within LARGE_LOGITS_REL_L2 of plain, rejecting S summed exactly and one
   TF32 product; and one mid-block ``AttentionBlock`` forward and backward on the card, flash
   against naive, every parameter gradient non-zero and within the naive
   path's own bf16-vs-fp32 difference;
3''. the flash kernels at fewer queries than keys (``phase_flash_split``:
   the 1024px mid block's N / 2 and N / 4 queries of a spatial group
   against all N keys): the serving and LSE forwards, dK/dV and dQ, bf16
   and fp32, against their plain versions with planted faults, bit-equal
   run to run, timed beside their bounds and SDPA at the same (nq, nk);
3'''. the flash kernels at heads of 640-1024 channels (``phase_flash_wide``,
   see the comment above WIDE_WIDTHS): every entry, bf16 and fp32, against
   plain with a rank's partial left out and 1xTF32 rejected, bit-equal,
   timed at 768 and 1024 beside plain, bound and SDPA; the AttentionBlock
   at 1024 and 768 under explicit flash against naive, chunked never run;
4. serving slice: a full-width SDXL VAE with seeded random weights is written
   with the port's ``save_model_dir`` and served by the port's server at 512px
   (``attention_impl=auto``, ``max_batch`` 4, an ephemeral port). A
   sustained window of ``/reconstruct?format=npy`` from 8 closed-loop
   clients gives p50/p95 latency and req/s; then concurrent ``/encode`` and
   a ``/decode``. Every answer must be 200 with finite values of the right
   shape, and the flash kernel must have been launched while serving them;
   then ``tools/serving_bench.py`` drives the same server for
   SERVING_BENCH_SECONDS (its p50 and req/s, no error);
   one batch's forward with the flash kernel is held against the naive path;
5. GroupNorm kernels vs plain, bf16, at the 128-channel full-resolution
   norm and the mid-block norm of both training paths (256px batch 16 and
   1024px batch 1), with SiLU and the |z| tap: each of the four kernels
   against its plain version, then the autograd op (y, the tap, dx, dgamma,
   dbeta) against the plain GroupNorm; every bound is also shown to reject a
   planted fault; the normalize, backward-reduce and dx kernels' split
   count S at each shape, their outputs bit-equal run to run, y without the
   SiLU bit-equal to plain, their sums' bound rejecting the last split's
   partial left out and dx's bound the last split's chunk left unwritten;
   forward and backward times from CUDA events;
5'. the fused resnet kernels vs plain, in bf16 and in fp32 (the ``_f32``
   kernels, 3xTF32), at the 256px fused path's (16, 512, 32, 32) -> 512 and
   at (16, 256, 64, 64) -> 512: #9 with and without the residual, with the
   |z| tap and the moments (also bit-equal run to run), #10 on the flipped
   weight (also bit-equal run to run), #11 (also bit-equal run to run), each
   bound shown to reject a planted fault (the border mask skipped, the halo
   rows tapped, the moments before the residual, the weight not flipped,
   dy's last 64-channel K chunk left out, the last pixel chunk left out; at
   fp32 also the lo products left out); at fp32 y, ds and dW within relative
   L2 1e-5 of the plain version in fp64; kernel, plain, bound and cuDNN
   times (TF32 off at fp32), and #10's device time by kernel
   (torch.profiler: its NHWC copy of dy, its loop); then the op at fp32,
   this slice's path: ``gn_silu_conv3x3`` forward and backward at
   (16, 512, 32, 32), every launch counter reset before and read after
   (one launch of each ``_f32`` kernel, #1, #4 and #5), against plain
   autograd in fp64 (every gradient within 1e-5); then the whole fused op
   against the unfused sequence (pallas GroupNorm, cuDNN conv, add),
   forward and forward+backward, at 32x32, 64x64 and 128x128 in bf16 and at
   32x32 in fp32;
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
   classified and nudged, the CSVs and the final model are written; the
   config's own profiling window (from step 20) writes a trace, which
   ``tools/profile_summary.py`` reads: device events, #9-#11 among them;
7'''. Adafactor: ``configs/bench_adafactor_256px.yaml`` with ``kernel_impl:
   pallas`` through ``train.main``, against the same config with ``adamw``,
   in turns (ADAFACTOR_ORDER): ms/step over the steps after the warm-up
   (host clock, synchronised), peak memory and the optimizer state's bytes
   (from the final checkpoint), every loss finite; in the timed steps each
   optimizer update (``_Optimizer.update``: the clip and the update) is
   timed on the host clock and by CUDA events around it (the span it adds
   to the device's timeline, the host's issue time where the device
   waits); one Adafactor run's
   profiling window covers its last steps, after the timed ones, and
   ``tools/profile_summary.py`` reads its trace: device events, the
   GroupNorm kernels and cuDNN's convs among them;
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
   ms/step, img/s and peak memory over steps 11-20; the profile of step 5
   with each flash and GroupNorm kernel's device time less the bounds of its
   launches at their own shapes (the redesigns' ranking); then fp32
   training through flash: the same config at ``mixed_precision: no`` for
   three steps through ``train.main``, each launching the three fp32 flash
   kernels as often as the bf16 run its bf16 ones (the fp32 kernels' main
   path: their launches in the kernels line);
9. one 1024px step with flash against one with naive attention (the same
   weights, batch and noise, ``remat: none``), held to naive bf16's own
   difference from naive fp32 on that step, and the fp32 flash step against
   naive fp32 within STEP_F32_REL; ``remat: conv`` on the flash step
   against ``none`` and ``full``: the loss, grad_norm and mid-block and
   resnet gradients within ``none``'s own run-to-run spread, as many cuDNN
   conv forwards as ``none`` and as many GroupNorm forward kernels as
   ``full``; 10 timed steps each of naive, flash, flash with ``remat:
   full`` and with ``remat: conv``, and of naive and flash at fp32 with and
   without remat, in turns, with their peak memory; a torch.profiler
   breakdown of a flash step; then a fused block at (16, 512, 32, 32)
   under ``remat`` none, conv and full: #9 launched as often under conv as
   under none, the same gradients.

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

The CLI audit (``phase_cli_audit``, after the tiling phase) runs the
training and evaluation CLIs over their impl matrix, 40 cells, none
refused. Then:

14. deployment export (``phase_export``, on the same seeded model dir): the
   SDXL VAE exported at 512px in bf16 and in fp32 through
   ``tools/export_model.main --check`` (the exported ``reconstruct`` within
   the check's bound of the live wrapper); each ``.pt2`` under 5 MB (no
   weight in it) and the export seconds; ``reconstruct`` from one artifact
   at batch 1 and 4, each call launching the flash forward (bf16 #6, or #6
   at fp32) exactly as often as the live wrapper's, twice; then the server
   from the bf16 export (``--exported_dir``) under 8 closed-loop clients
   for EXPORT_LOAD_SECONDS: p50, p95 and req/s beside the live server's
   window, every answer 200, finite, of the right shape,
   ``?deterministic=false`` refused with a 4xx, and #6's launches while
   serving on an ``[export]`` line;

after the Adafactor phase:

15. the native loader (``phase_native_loader``): ``tools/doctor.py``'s
   native check passes (g++ builds the port's ``csrc/preprocess.cpp`` and
   ``csrc/decode.cpp`` with libjpeg/libpng, or, where their headers are
   missing, ``preprocess.cpp`` alone: a warning, PIL decodes and the C++
   kernel resizes) and the build that was made is printed;
   ``tools/loader_bench.py`` in-process at 256px from 512px JPEGs and at
   1024px from 2048px JPEGs (LOADER_RUNS), workers 0 and 4: img/s for PIL
   and native, the host's cores, and every image of a native result through
   the native path its build has (none through the PIL transform);
16. the host-fed Trainer (``phase_realloader_trainer``):
   ``configs/bench_realloader.yaml`` through ``train.main`` on 240 JPEGs of
   ``make_jpegs``, under ``VCD_NATIVE_PREPROCESS`` 0 and 1 in turns, 20
   steps each: ms/step and img/s over steps 6-20, finite losses, every
   image of the native run through the native path (none through the PIL
   transform); the native run also sets
   ``saving.export_stablehlo`` and its ``final_model/exported`` (naive
   attention at 256px: no kernel) is held to the live wrapper of
   ``final_model/vae``;

and after the export phase:

17. more than one GPU (``phase_multi_gpu``, see the comment above
   MULTI_ZERO_CONFIG): every card a rank over NCCL, spawned with torchrun's
   environment; the ZeRO stack, DDP, the 1024px flash Trainer, the fused
   path with ZeRO-1 and the evaluation CLI through the CLIs, each against
   one process at the same global batch, the kernels counted on every
   rank; at W >= 2 the 1024px flash Trainer with the images' rows over
   two cards (``parallel.spatial: 2``), held to one process the same way;
   the server with one replica a card. ``multi_gpu_main`` runs it
   alone, at W = 1 and at every card of the machine, with the W = 4
   against W = 1 ratios.
 The last lines are a JSON object describing the sixteen kernels,
the nvidia-smi line, and ``{"ok": true, "device": {...}}``. Imports no jax.
"""

from __future__ import annotations

import contextlib
import ctypes
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
import urllib.error
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
SERVING_BENCH_SECONDS = 5.0  # tools/serving_bench.py against the same server
N_IMAGES = 16
N_ENCODE = 4
N_DECODE = 2
# the card the slice runs on; a CPU rehearsal of the script's logic swaps it
DEVICE = "cuda"
FLASH_FWD_SOURCE = "vae_channel_dynamics_tpu_torch/csrc/flash_attention_fwd.cu"
FLASH_BWD_SOURCE = "vae_channel_dynamics_tpu_torch/csrc/flash_attention_bwd.cu"
FLASH_BWD_F32_SOURCE = "vae_channel_dynamics_tpu_torch/csrc/flash_attention_bwd_f32.cu"
FLASH_SOURCES = {
    "flash_attention_fwd": FLASH_FWD_SOURCE,
    "flash_attention_fwd_lse": FLASH_FWD_SOURCE,
    "flash_attention_bwd_dkv": FLASH_BWD_SOURCE,
    "flash_attention_bwd_dq": FLASH_BWD_SOURCE,
    "flash_attention_fwd_lse_f32": FLASH_FWD_SOURCE,
    "flash_attention_bwd_dkv_f32": FLASH_BWD_F32_SOURCE,
    "flash_attention_bwd_dq_f32": FLASH_BWD_F32_SOURCE,
}
FLASH_REPLACES = {
    "flash_attention_fwd": "vae_channel_dynamics_tpu/ops/pallas_attention.py:136",
    "flash_attention_fwd_lse": "vae_channel_dynamics_tpu/ops/pallas_attention.py:177",
    "flash_attention_bwd_dkv": "vae_channel_dynamics_tpu/ops/pallas_attention.py:304",
    "flash_attention_bwd_dq": "vae_channel_dynamics_tpu/ops/pallas_attention.py:284",
    "flash_attention_fwd_lse_f32": "vae_channel_dynamics_tpu/ops/pallas_attention.py:177 (fp32)",
    "flash_attention_bwd_dkv_f32": "vae_channel_dynamics_tpu/ops/pallas_attention.py:304 (fp32)",
    "flash_attention_bwd_dq_f32": "vae_channel_dynamics_tpu/ops/pallas_attention.py:284 (fp32)",
}
# the fp32 training kernels: what their designs are (PERF.md section 6)
F32_NOTES = {
    "flash_attention_fwd_lse_f32": "the fp32 forward (3xTF32 on wgmma/TMA) with its lse pointer "
                                   "set; bound: 3 x its products at the TF32 rate",
    "flash_attention_bwd_dkv_f32": "redesigned for Hopper, see PERF.md section 6 (dP and the "
                                   "outputs 3xTF32 on wgmma/TMA on a cluster of C/128 CTAs, the "
                                   "outputs transposed with the streamed operand as register A; "
                                   "S by FFMA in plain's order; the logits summed in rank order "
                                   "through distributed shared memory; was plain fp32 FFMA); "
                                   "bound: 3 x its FLOPs at the TF32 rate",
    "flash_attention_bwd_dq_f32": "redesigned for Hopper, see PERF.md section 6 (dP and dQ^T "
                                  "3xTF32 on wgmma/TMA on a cluster of C/128 CTAs, K as register "
                                  "A; S by FFMA in plain's order; the logits summed in rank order "
                                  "through distributed shared memory; was plain fp32 FFMA); "
                                  "bound: 3 x its FLOPs at the TF32 rate",
}
# The card's published peaks (NVIDIA H100 SXM data sheet, dense, at 700 W):
# each kernel's bound is the larger of its FLOPs over the bf16 tensor-core
# rate and its bytes (each input read once, each output written once) over
# the memory rate.
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12  # outside the tensor cores: the GroupNorm kernels' math
PEAK_TF32_FLOPS = 495e12  # three TF32 products (3xTF32) give fp32 accuracy
PEAK_BYTES_PER_S = 3.35e12
SMS = 132

# Flash training kernels vs plain, bf16, at the 1024px mid block's shape
# (the Trainer slice's) and the 512px one at batch 4. dQ, dK and dV are bf16
# sums of N fp32 products in another order than the plain matmul's, and P
# and dS round to bf16 the other way where exp differs in its last bit:
# max|kernel - plain| <= GRAD_MAX_REL max|plain| (4 bf16 ulps at the top of
# its binade) and relative L2 <= KERNEL_REL_L2. One 32-query tile left out of
# dK/dV costs about sqrt(32/N) in relative L2 (0.044 at N = 16384). lse is
# fp32: LSE_MAX_REL of max|plain|.
BWD_SHAPES = ((1, 16384, 512), (4, 4096, 512))
# The same kernels at fp32 (fp32 training, TF32 off): o, dQ, dK and dV
# within relative L2 FLASH_F32_REL_L2 (below) of fp32 plain, lse within
# LSE_MAX_REL; each bound also rejects one TF32 product (the plain version
# with TF32 on, about 1e-3).
GRAD_MAX_REL = 2.0 ** -6
LSE_MAX_REL = 1e-5
FAULT_QUERIES = 32
BWD_ITERS = 10
# The backward kernels split the channels over a thread-block cluster of
# C / 128 CTAs: the widths of a cluster of one and of three, at a small N,
# held to the same bounds; and the main width's N at C = 128, whose CTAs do
# the same work as C = 512's without any traffic between SMs, to price the
# exchange. A rank's partial left out of the logits' sum, and one key tile
# left out of dQ, are the design's own planted faults.
BWD_SMALL_SHAPES = ((2, 1024, 128), (1, 1024, 384))
BWD_EXCHANGE_SHAPE = (1, 16384, 128)
# The fp32 backward at logits of several hundred (q and k x 8, scale 1):
# P = exp(S - lse) is never renormalised, so S's absolute error is P's
# relative one, and plain's own rounding of S (about 3 ulps at 700) only
# cancels where S is summed in plain's order. dQ, dK and dV within relative
# L2 LARGE_LOGITS_REL_L2 of plain, the bound of
# tests/test_torch_flash_kernel_cuda.py::test_fp32_training_handles_large_logits;
# it rejects S summed exactly (about 3e-4) and one TF32 product.
LARGE_LOGITS_SHAPE = (2, 256, 128)
LARGE_LOGITS_REL_L2 = 1e-4
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
# fp32 training through flash: the step with flash against the step with
# naive, both fp32 with TF32 off, within this relative difference on the
# loss, grad_norm and the mid-block attention gradients (rel L2); the two
# sum the attention in other orders, about 1e-6 apart
STEP_F32_REL = 1e-4
# the 1024px Trainer at mixed_precision "no" with flash: steps through
# train.main, each launching the fp32 flash kernels
TRAINER_F32_STEPS = 3

GN_GROUPS = 32
GN_EPS = 1e-6
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
# fault leaves the last split's partial out. The backward reduce splits the
# same way with a larger least split (S = 16 and 1 at the 1024px shapes), and
# dx with its own (S = 16 and 4); dx's fault leaves the last split's chunk
# of every plane unwritten.
GN_SHAPES = ((16, 128, 256, 256), (16, 512, 32, 32), (1, 128, 1024, 1024), (1, 512, 128, 128))
# The same checks, untimed, in bf16 and in fp32, at every channel block the
# tensor runs of phase_multi_gpu launch the kernels on: each norm's C / T
# channels with its G / T groups, (t) configs/bench_tp.yaml at 256px batch 16
# at T = 2 and 4, (st) the 1024px Trainer at 2 spatial x 2 tensor, batch 1,
# half the rows. The splits of #2, #4 and #5 follow the planes B x C / T, so
# these blocks take split counts GN_SHAPES does not. GN_LAYERS: the SDXL
# VAE's norm inputs as (channels, downscale from the image).
GN_LAYERS = ((128, 1), (128, 2), (256, 1), (256, 2), (256, 4), (512, 2), (512, 4), (512, 8))
GN_BLOCK_RUNS = ((16, 256, 1, (2, 4)), (1, 1024, 2, (2,)))  # (batch, px, spatial, T)
GN_BLOCK_SHAPES = tuple(sorted({
    ((b, c // t, px // d // s, px // d), GN_GROUPS // t)
    for b, px, s, ts in GN_BLOCK_RUNS for t in ts for c, d in GN_LAYERS}))
# fp32 bounds (tests/test_torch_group_norm_kernel_cuda.py's): y and dx of
# the kernels within GN_F32_REL of max|plain| (and 1e-5), the op's y and dx
# within GN_F32_OP_REL (the JAX tests' 2e-5 and 5e-4: the plain autograd
# and the folded dx formula round apart), the fp32 sums GN_SUM_REL_F32
GN_F32_REL = 1e-5
GN_F32_OP_REL = (2e-5, 5e-4)
GN_SUM_REL_F32 = 1e-4
GN_ROW_SHAPE = (1, 128, 1024, 1024)
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
# The kernels the 1024px Trainer step launches, by their names in a
# torch.profiler trace: its kernel losses (device time less the bounds of
# the launches at their own shapes) rank the redesigns.
TRAINER_KERNEL_EVENTS = {
    "flash_attention_fwd_lse": ("flash_fwd_kernel",),
    "flash_attention_bwd_dkv": ("flash_bwd_dkv_kernel",),
    "flash_attention_bwd_dq": ("flash_bwd_dq_kernel",),
    "gn_fwd_reduce": ("gn_fwd_reduce_kernel",),
    "gn_fwd_normalize": ("gn_fwd_normalize_kernel", "sum_splits_kernel"),
    "gn_bwd_reduce": ("gn_bwd_reduce_kernel", "sum_splits2_kernel"),
    "gn_bwd_dx": ("gn_bwd_dx_kernel",),
}
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
# The same kernels at fp32 (the _f32 kernels, 3xTF32), at FUSED_SHAPES: y, ds
# and dW within relative L2 FUSED_F32_REL_L2 of the plain version evaluated in
# fp64 (cuDNN's fp32 weight gradient with TF32 off is itself about 1.2e-5 from
# fp64 at (16, 256, 64, 64) -> 512, which the kernel is not), the fp32 sums
# within FUSED_F32_SUM_REL of max|plain|; faults as bf16, plus the lo products
# left out (1xTF32). The path of this slice: the op's entry at fp32, forward
# and backward at FUSED_OP_SHAPES[0], against plain autograd in fp64, its
# launches the kernels line's. The model fuses bf16 only (the JAX gate), so
# no Trainer run launches these.
FUSED_F32_REL_L2 = 1e-5
FUSED_F32_SUM_REL = 1e-4
FUSED_F32_REPLACES = {name + "_f32": where + " (fp32)" for name, where in FUSED_REPLACES.items()}
FUSED_F32_NOTE = ("3xTF32 on wgmma/TMA, every accumulation short (see PERF.md section 6); "
                  "launched by the op's entry at fp32 (the model fuses bf16 only); bound: 3 x "
                  "its FLOPs at the TF32 rate")
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
# the Adafactor phase: bench_adafactor_256px.yaml against the same config
# with adamw, in turns; a run's steps after the warm-up and before the
# profiled window are timed, and one Adafactor run profiles its last steps
ADAFACTOR_CONFIG = "configs/bench_adafactor_256px.yaml"
ADAFACTOR_ORDER = ("adamw", "adafactor", "adafactor", "adamw")
ADAFACTOR_STEPS = 14
ADAFACTOR_WARMUP = 2
ADAFACTOR_PROFILE_START = 13
ADAFACTOR_PROFILED_RUN = 2
# the SDXL VAE at 256px: 24 resnets, the nine 512-channel ones at 32x32 fuse
SDXL_RESNETS, SDXL_FUSED_AT_256 = 24, 9
# remat: conv against none on the 1024px step: resnet parameters' gradients
REMAT_GRADS = ["encoder.down_blocks.0.resnets.0.conv1.weight",
               "encoder.down_blocks.0.resnets.0.norm1.weight",
               "decoder.up_blocks.3.resnets.2.conv2.weight",
               "decoder.up_blocks.3.resnets.2.norm2.bias"]

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
# The kernels redesigned for Hopper after their first port: the design.
# Their times before and after are in PERF.md section 6; this run's are the
# line's own numbers.
REDESIGNED = {
    "flash_attention_fwd": "redesigned for Hopper, see PERF.md section 6 (wgmma/TMA: a producer "
                           "warpgroup and two consumer warpgroups, each half the channels, 64 "
                           "query rows a CTA, the partial logits added through shared memory, P "
                           "as wgmma's register A; was mma.sync, 32 rows a block)",
    "flash_attention_fwd_lse": "redesigned for Hopper with flash_attention_fwd, see PERF.md "
                               "section 6 (one kernel, the lse pointer set)",
    "gn_bwd_dx": "redesigned for Hopper, see PERF.md section 6 (each plane split over S "
                 "blocks where the planes do not fill the card, no partials and no second "
                 "pass, two loads of x and of g in flight a thread; was one block a plane, "
                 "one load of each in flight)",
    "gn_bwd_reduce": "redesigned for Hopper, see PERF.md section 6 (each plane split over S "
                     "blocks where the planes do not fill the card and each split reads 32 KB or "
                     "more of x, one load of x and of g in flight a thread, per-split partials "
                     "added in order; was one block a plane)",
    "flash_attention_bwd_dkv": "redesigned for Hopper, see PERF.md section 6 (channels split over "
                               "a cluster of C/128 CTAs, 64 keys a CTA, wgmma/TMA, the logits "
                               "summed in rank order through distributed shared memory; was "
                               "mma.sync, 16 keys a block)",
    "flash_attention_bwd_dq": "redesigned for Hopper, see PERF.md section 6 (channels split over "
                              "a cluster of C/128 CTAs, 64 queries a CTA, wgmma/TMA, the logits "
                              "summed in rank order through distributed shared memory; was "
                              "mma.sync, 16 queries a block)",
    "conv3x3_dw_f32": "redesigned for Hopper, see PERF.md section 6 (64 x 64 channels a block "
                      "on m64n64k8, a warpgroup's three taps in turn through one fresh "
                      "accumulator, 64-pixel units, integer hi/lo splits, the splits "
                      "independent blocks whose partials a second pass adds in order; was "
                      "64 x 32 on m64n32k8, 128-pixel units, cvt splits, splits a cluster)",
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
# The card audit of the CLIs' impl matrix: train.main over mixed_precision x
# kernel_impl x attention_impl, evaluate.main over mixed_precision x
# kernel_impl {auto, pallas} x attention_impl, the seeded full-width SDXL VAE
# at 128px (the mid block's 256 tokens at C = 512 take flash; every norm has
# a multiple of 128 channels; the 32px and 16px resnets pass the fused gate),
# batch 2, 2 training steps, 4 evaluated images, TF32 off. Each cell is held
# to the same precision's control (attention naive, kernel_impl auto: the
# plain GroupNorm): a bf16 cell within AUDIT_CONTROL_RATIO x the control's
# own bf16-vs-fp32 difference plus AUDIT_FLOOR (one bf16 ulp, as the step
# checks' scalars), an fp32 cell within AUDIT_F32_REL (the GroupNorm
# kernels and chunked attention sum in another order, about 1e-6). Every
# impl named must launch its kernels (fp32 flash its fp32 kernels); `fused`
# at fp32 fuses no block (the JAX gate fuses bf16 only) and must launch
# none. Every cell runs: any failure fails the phase.
AUDIT_RES, AUDIT_BATCH, AUDIT_STEPS, AUDIT_EVAL_IMAGES = 128, 2, 2, 4
AUDIT_PRECISIONS = ("bf16", "no")
AUDIT_TRAIN_KERNELS = ("auto", "pallas", "fused")
AUDIT_EVAL_KERNELS = ("auto", "pallas")
AUDIT_ATTENTION = ("auto", "naive", "chunked", "flash")
AUDIT_CONTROL_RATIO = 1.25
AUDIT_FLOOR = 2.0 ** -8
AUDIT_F32_REL = 1e-4
AUDIT_TAPS = ("vae.encoder.down_blocks.0.resnets.0.norm1",  # 128 channels at 128x128
              "vae.encoder.down_blocks.3.resnets.0.norm1")  # 512 at 16x16: fused in bf16

# the native loader (phase_native_loader): tools/loader_bench.py in-process,
# (label, arguments, images) at the JAX tool's defaults and at 1024px
LOADER_RUNS = (("256px from 512px JPEGs", ["--resolution", "256", "--src-size", "512",
                                           "--num-images", "256"], 256),
               ("1024px from 2048px JPEGs", ["--resolution", "1024", "--src-size", "2048",
                                             "--num-images", "32"], 32))
LOADER_WORKERS = "0,4"
# the host-fed Trainer (phase_realloader_trainer): configs/bench_realloader.yaml
# on make_jpegs' JPEGs, under VCD_NATIVE_PREPROCESS 0 and 1 in turns
REALLOADER_CONFIG = "configs/bench_realloader.yaml"
REALLOADER_IMAGES = 240
REALLOADER_SRC = 512
REALLOADER_STEPS = 20
REALLOADER_TIMED_FROM = 6  # ms/step over steps 6-20
REALLOADER_ORDER = ("0", "1")
# the deployment export (phase_export): the seeded SDXL VAE at 512px
EXPORT_RES = 512
EXPORT_MAX_BYTES = 5 << 20  # a .pt2 that held the weights would be 335 MB
EXPORT_BATCHES = (1, MAX_BATCH)
EXPORT_KERNELS = {"bf16": "flash_attention_fwd", "fp32": "flash_attention_fwd_f32"}
EXPORT_LOAD_SECONDS = 15.0
EXPORT_TIMED_CALLS = 5
# the live server's sustained window (phase_slice), beside the exported one's
SERVING_LIVE: dict = {}


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


# template arguments of a mangled kernel name: fp32, bf16, an int or a bool
_MANGLED_ARG = r"f|13__nv_bfloat16|L[ib](\d+)E"


def kernel_label(mangled: str) -> str:
    """``name<args>`` of a mangled ``*_kernel`` entry point (its name is the
    last ``<length><name>`` whose name ends in ``_kernel``: the anonymous
    namespace's hash before it, which changes with the source's path, can
    read as such a pair too; its template arguments fp32, bf16, ints and
    bools), else the mangled name."""
    label = mangled
    for m in re.finditer(r"(?=(\d+)([a-z_]\w*))", mangled):
        size, rest = int(m.group(1)), m.group(2)
        name = rest[:size]
        if len(name) == size and name.endswith("_kernel"):
            args = re.match(rf"I((?:{_MANGLED_ARG})+)", rest[size:])
            types = {"f": "fp32", "13__nv_bfloat16": "bf16"}
            label = name if not args else name + "<" + ",".join(
                types.get(a.group(0), a.group(1))
                for a in re.finditer(_MANGLED_ARG, args.group(1))) + ">"
    return label


# The kernels redesigned on wgmma/TMA (csrc/sm90_wgmma.cuh): their SASS must
# hold warpgroup MMAs (HGMMA) and TMA loads (UTMALDG), and no mma.sync (HMMA).
WGMMA_KERNELS = {"conv3x3_nhwc_kernel": "conv_nhwc", "conv3x3_dw_kernel": "fused_resnet",
                 "fused_gn_silu_conv3x3_kernel": "fused_resnet",
                 "conv3x3_nchw_kernel": "fused_resnet",
                 "fused_gn_silu_conv3x3_f32_kernel": "fused_resnet",
                 "conv3x3_nchw_f32_kernel": "fused_resnet",
                 "conv3x3_dw_f32_kernel": "fused_resnet",
                 "flash_fwd_f32_kernel": "flash_attention_fwd",
                 "flash_fwd_kernel": "flash_attention_fwd",
                 "flash_bwd_dkv_kernel": "flash_attention_bwd",
                 "flash_bwd_dq_kernel": "flash_attention_bwd",
                 "flash_bwd_f32_kernel": "flash_attention_bwd_f32"}
# ptxas must report no stack frame and no spills for these
NO_STACK_KERNELS = ("flash_fwd_f32_kernel", "flash_bwd_dkv_kernel", "flash_bwd_dq_kernel",
                    "flash_bwd_f32_kernel")
NO_STACK = "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"
# and no more spill bytes (stores, and loads) than ptxas reported when these
# were built: the bf16 forward's consumers hold O, 128 fp32 a thread at
# C = 512, in the 232 registers the producer warpgroup hands them
SPILL_LIMITS = {"flash_fwd_kernel<512>": 24, "flash_fwd_kernel<384>": 0,
                "flash_fwd_kernel<256>": 0, "flash_fwd_kernel<128>": 0,
                # past 512 a CTA of the forward's cluster holds a slice of
                # 384 (640, 768) or 512 (896, 1024) channels, as at C = 384
                # and 512, and the cluster's exchange
                "flash_fwd_kernel<640>": 0, "flash_fwd_kernel<768>": 0,
                "flash_fwd_kernel<896>": 20, "flash_fwd_kernel<1024>": 20,
                # dK/dV at a cluster of six, whose ranks own 3 or 2 of the 16
                # pairs a thread (a run length known only at run time)
                "flash_bwd_dkv_kernel<768>": 12,
                # the fp32 fused resnet kernels: 168 registers a thread, no
                # spills; fp32 #11 at 32- and 16-column units, holding 3 x 32
                # summed and 32 fresh accumulators a thread
                "fused_gn_silu_conv3x3_f32_kernel": 0, "conv3x3_nchw_f32_kernel": 0,
                "conv3x3_dw_f32_kernel<32>": 0, "conv3x3_dw_f32_kernel<16>": 0}
# fp32 #11's layout by unit width (W 16, 32: units of 16 and 32 columns), the
# built library's bytes held to the Python mirror
DW_F32_LAYOUT_WIDTHS = (16, 32)
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
              FLASH_BWD_F32_SOURCE: (flash_attention.BWD_F32_LIBRARY,
                                     flash_attention.build_backward_f32),
              GN_SOURCE: (gnk.LIBRARY, gnk.build),
              FUSED_SOURCE: (fr.LIBRARY, fr.build),
              CONV_SOURCE: (cn.LIBRARY, cn.build)}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(builds)) as pool:
        for fut in [pool.submit(fn) for _lib, fn in builds.values()]:
            fut.result()
    wall = time.perf_counter() - t0
    pinned = set()
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
                check(kernel in SPILL_LIMITS or kernel.split("<")[0] not in NO_STACK_KERNELS
                      or spills == NO_STACK, f"{kernel} has a stack frame or spills: {spills}")
                if kernel in SPILL_LIMITS:
                    pinned.add(kernel)
                    spilled = max(int(m) for m in re.findall(r"(\d+) bytes spill", spills))
                    check(spilled <= SPILL_LIMITS[kernel],
                          f"{kernel} spills more than {SPILL_LIMITS[kernel]} bytes: {spills}")
        log(f"[build] {source}: nvcc {_cuda_build.build_seconds.get(lib, 0.0):.2f} s; "
            f"ptxas per instantiation: {entries}")
    # (a library found already built prints no ptxas report)
    unreported = {kernel for kernel in set(SPILL_LIMITS) - pinned
                  if _cuda_build.build_logs.get(WGMMA_KERNELS[kernel.split("<")[0]])}
    check(not unreported, f"no ptxas report for {unreported}")
    # the flash kernels' clusters and dynamic shared memory a CTA by width,
    # from the built libraries, held to the Python mirrors of their layouts
    fa = flash_attention
    smem = {}
    for lib, fn in ((fa.FWD_LIBRARY, "vcd_flash_attention_fwd_smem"),
                    (fa.BWD_LIBRARY, "vcd_flash_attention_bwd_smem"),
                    (fa.BWD_F32_LIBRARY, "vcd_flash_attention_bwd_f32_smem")):
        smem[fn] = getattr(_cuda_build.load(lib), fn)
        smem[fn].argtypes, smem[fn].restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    layout = {}
    for c in fa.SUPPORTED_CHANNELS:
        got = {"fwd (bf16, fp32)": (smem["vcd_flash_attention_fwd_smem"](c, 0),
                                    smem["vcd_flash_attention_fwd_smem"](c, 1)),
               "bwd (dK/dV, dQ)": (smem["vcd_flash_attention_bwd_smem"](c, 1),
                                   smem["vcd_flash_attention_bwd_smem"](c, 0)),
               "bwd fp32 (dK/dV, dQ)": (smem["vcd_flash_attention_bwd_f32_smem"](c, 1),
                                        smem["vcd_flash_attention_bwd_f32_smem"](c, 0))}
        want = {"fwd (bf16, fp32)": (fa.fwd_smem_bytes(c), fa.fwd_smem_bytes(c, True)),
                "bwd (dK/dV, dQ)": (fa.bwd_smem_bytes(c, True), fa.bwd_smem_bytes(c, False)),
                "bwd fp32 (dK/dV, dQ)": (fa.bwd_smem_bytes(c, True, True),
                                         fa.bwd_smem_bytes(c, False, True))}
        check(got == want, f"the flash layouts at C={c}: the libraries give {got}, the Python "
                           f"mirrors {want}")
        layout[c] = {"fwd cluster": f"{fa.fwd_cluster_size(c)} x {fa.fwd_slice(c)}",
                     "bwd cluster": f"{fa.bwd_cluster_size(c)} x {fa.BWD_SLICE}", **got}
    log(f"[build] {len(builds)} libraries built and loaded in {wall:.2f} s; the flash "
        "kernels by width: clusters (CTAs x channels), dynamic shared memory a CTA (bytes): "
        + str(layout))
    dw_smem = {w: (fr._fn("conv3x3_dw_f32_smem")(w), fr.dw_f32_smem_bytes(w))
               for w in DW_F32_LAYOUT_WIDTHS}
    check(all(got == want for got, want in dw_smem.values()),
          f"conv3x3_dw_f32's layout: the library gives, the Python mirror wants {dw_smem}")
    log("[build] conv3x3_dw_f32 by width: unit (rows, cols), window (rows, cols), dynamic "
        "shared memory a block (bytes): " + str({
            w: (fr.dw_unit(w, True), fr.dw_f32_window(w), got)
            for w, (got, _want) in dw_smem.items()}))
    seen = set()
    for library in sorted(set(WGMMA_KERNELS.values())):
        for label, ops in sass_counts(library).items():
            base = label.split("<")[0]
            if base not in WGMMA_KERNELS:
                continue
            seen.add(base)
            log(f"[build] SASS {label}: " + ", ".join(f"{op} {ops[op]}" for op in SASS_OPS))
            check(ops["HGMMA"] > 0 and ops["UTMALDG"] > 0 and ops["HMMA"] == 0,
                  f"{label} is not on the wgmma/TMA path: {ops}")
    check(seen == set(WGMMA_KERNELS), f"no SASS for {set(WGMMA_KERNELS) - seen}")


def phase_doctor():
    """``tools/doctor.py --device cuda`` in this process, after the build: every
    check passes (the libraries are found built)."""
    from vae_channel_dynamics_tpu_torch.tools import doctor

    log("[doctor] python -m vae_channel_dynamics_tpu_torch.tools.doctor --device cuda:")
    t0 = time.perf_counter()
    rc = doctor.main(["--device", DEVICE])
    check(rc == 0, f"doctor --device {DEVICE} exited {rc}")
    log(f"[doctor] every check passed in {time.perf_counter() - t0:.1f} s")


def phase_kernel():
    import torch

    from vae_channel_dynamics_tpu_torch.ops import flash_attention as fa

    results = {}
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    for b, n, c in KERNEL_SHAPES:
        q, k, v = (torch.randn(b, n, c, generator=gen, device=DEVICE).to(torch.bfloat16)
                   for _ in range(3))
        scale = c ** -0.5
        out = fa.flash_attention(q, k, v, scale=scale, out_dtype=torch.bfloat16)
        sync()
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
        # the design's own faults: one consumer warpgroup's partial S (its
        # half of the channels) left out of the logits, and the last tile's
        # P V (issued after the loop) left out of O
        half = fa.flash_attention_reference(q[..., :c // 2].contiguous(),
                                            k[..., :c // 2].contiguous(), v, scale,
                                            torch.bfloat16)
        last_pv = fwd_last_pv_left_out(q, k, v, scale)
        design_faults = {"a warpgroup's partial S left out": kernel_errors(half, ref),
                         "the last tile's P V left out": kernel_errors(last_pv, ref)}
        del half, last_pv
        # bit-equal run to run
        again = fa.flash_attention(q, k, v, scale=scale, out_dtype=torch.bfloat16)
        sync()
        check(torch.equal(out, again), f"the flash forward differs between two runs at {(b, n, c)}")
        del again

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
        intake_tbs = fwd_intake_bytes(b, n, c) / ms / 1e9
        log(f"[kernel] (B={b}, N={n}, C={c}) max_abs_err {err:.6g} (tol {atol:.6g}, "
            f"{KERNEL_ULPS} bf16 ulps of max|plain|), rel L2 {rel:.6g} (tol {KERNEL_REL_L2}); "
            f"one dropped {FAULT_TILE}-key tile: max abs {fault_err:.6g}, rel L2 "
            f"{fault_rel:.6g}; kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s) "
            f"[{k1:.4f}, {k2:.4f}], plain {plain_ms:.4f} ms [{p1:.4f}, {p2:.4f}], "
            f"bound {bound_ms:.4f} ms ({bound_by}), SDPA forward ({backend}) "
            f"{lib['fwd']:.4f} ms; bit-equal run to run; "
            + ", ".join(f"{what}: max abs {e:.6g}, rel L2 {r:.6g}"
                        for what, (e, r) in design_faults.items())
            + f"; K and V from L2 into the SMs at {intake_tbs:.2f} TB/s "
            f"({intake_tbs / SMS * 1e3:.1f} GB/s an SM)")
        check(err <= atol and rel <= KERNEL_REL_L2,
              f"kernel disagrees with plain at {(b, n, c)}: max abs {err}, rel L2 {rel}")
        check(fault_err > atol or fault_rel > KERNEL_REL_L2,
              f"the kernel bound at {(b, n, c)} does not reject a dropped key tile")
        for what, (e, r) in design_faults.items():
            check(e > atol or r > KERNEL_REL_L2,
                  f"the kernel bound at {(b, n, c)} does not reject {what}")
        results[(b, n, c)] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                              "bound_ms": bound_ms, "bound_by": bound_by,
                              "library_ms": lib["fwd"]}
        del q, k, v, out, ref
    return results


def fwd_last_pv_left_out(q, k, v, scale: float):
    """The plain forward with the last key tile's P V left out of O, its
    probabilities still in the softmax's denominator: what a forward that
    skipped the product it issues after its loop would return."""
    import torch

    p = torch.softmax(torch.matmul(q.float(), k.float().transpose(1, 2)) * scale, dim=-1)
    return torch.matmul(p[..., :-FAULT_TILE], v[:, :-FAULT_TILE].float()).to(torch.bfloat16)


def fwd_intake_bytes(b: int, n: int, c: int) -> int:
    """Bytes of K and V the bf16 forward's CTAs bring into their SMs from L2:
    every one of the n / 64 CTAs of a batch element reads all of its K and V."""
    return b * (n // 64) * 2 * n * c * 2


def roofline(flops: float, nbytes: float, rate: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    """The least time (ms) the card could take: the larger of the operations
    over their peak rate (the bf16 tensor cores' by default) and the bytes
    over the memory rate, and which of the two it is."""
    t_ops = flops / rate * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def flash_bounds(b: int, n: int, c: int, nk: int = 0) -> dict:
    """Each flash kernel's bound at (B, N, C), or at ``n`` queries against
    ``nk`` keys: FLOPs of its products, and bytes of its operands (q, o, dO
    and dQ of ``n`` rows, k, v, dK, dV of ``nk``; bf16, or fp32 for the
    ``_f32`` kernels) and its fp32 (B, n) row vectors, each read or written
    once. The fp32 kernels' FLOPs count three times at the TF32 rate
    (3xTF32)."""
    nk = nk or n
    f, r = b * n * nk * c, 4 * b * n
    bounds = {}
    for suffix, size, scale, rate in (("", 2, 1, PEAK_BF16_FLOPS),
                                      ("_f32", 4, 3, PEAK_TF32_FLOPS)):
        tq, tk = size * b * n * c, size * b * nk * c
        bounds.update({
            f"flash_attention_fwd{suffix}": roofline(scale * 4 * f, 2 * tq + 2 * tk, rate),
            f"flash_attention_fwd_lse{suffix}": roofline(scale * 4 * f, 2 * tq + 2 * tk + r,
                                                         rate),
            f"flash_attention_bwd_dkv{suffix}": roofline(scale * 8 * f, 2 * tq + 4 * tk + 2 * r,
                                                         rate),
            f"flash_attention_bwd_dq{suffix}": roofline(scale * 6 * f, 3 * tq + 2 * tk + 2 * r,
                                                        rate),
        })
    return bounds


def gn_bound(name: str, shape, element_size: int) -> tuple[float, str]:
    """A GroupNorm kernel's bound on an NCHW input of ``shape``: GN_OPS[name]
    fp32 operations an element, and its bytes (the activations in their
    dtype, the (B, C) fp32 vectors)."""
    elem = math.prod(shape)
    e, bc = elem * element_size, shape[0] * shape[1] * 4
    nbytes = {"gn_fwd_reduce": e + 2 * bc, "gn_fwd_normalize": 2 * e + 2 * bc,
              "gn_bwd_reduce": 2 * e + 4 * bc, "gn_bwd_dx": 3 * e + 5 * bc}[name]
    return roofline(GN_OPS[name] * elem, nbytes, PEAK_FP32_FLOPS)


@contextlib.contextmanager
def launch_bounds(bounds: dict):
    """While active, adds the bound (ms) of every flash and GroupNorm kernel
    launch, at the launch's own shape, to ``bounds[kernel]``."""
    from vae_channel_dynamics_tpu_torch.ops import flash_attention as fa
    from vae_channel_dynamics_tpu_torch.ops import group_norm_kernel as gnk

    fa_launch, gn_launch = fa._launch, gnk._launch

    def fa_recorded(name, device, *args, **kw):
        b, nq, nk, c = args[-5:-1]  # each path entry ends with b, nq, nk, c, scale
        bounds[name] = bounds.get(name, 0.0) + flash_bounds(b, nq, c, nk)[name][0]
        return fa_launch(name, device, *args, **kw)

    def gn_recorded(name, x, *args):
        bounds[name] = bounds.get(name, 0.0) + gn_bound(name, tuple(x.shape),
                                                        x.element_size())[0]
        return gn_launch(name, x, *args)

    fa._launch, gnk._launch = fa_recorded, gn_recorded
    try:
        yield bounds
    finally:
        fa._launch, gnk._launch = fa_launch, gn_launch


def kernel_losses(prof, bounds: dict, steps: int) -> None:
    """Logs, for each kernel of TRAINER_KERNEL_EVENTS, its device time in the
    profiled step less the bounds of its launches there, and that times
    ``steps``: the redesigns' ranking."""
    from torch.autograd import DeviceType

    device = dict.fromkeys(TRAINER_KERNEL_EVENTS, 0.0)
    count = dict.fromkeys(TRAINER_KERNEL_EVENTS, 0)
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        for name, keys in TRAINER_KERNEL_EVENTS.items():
            if any(k in evt.key for k in keys):
                device[name] += _self_device_us(evt) / 1e3
                count[name] += evt.count if keys[0] in evt.key else 0
                break
    rows = sorted(((device[k] - bounds.get(k, 0.0), k) for k in device), reverse=True)
    log(f"[rank] kernel losses in the profiled step (device ms less the sum of its launches' "
        f"bounds at their own shapes), and x {steps} steps: " + "; ".join(
            f"{k} {device[k]:.3f} ms x{count[k]} - bounds {bounds.get(k, 0.0):.3f} = "
            f"{loss:.3f} ms a step, {loss * steps:.1f} ms over the run" for loss, k in rows))


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


def sdpa_f32_times(q, k, v, do, scale: float, iters: int) -> tuple[str, dict]:
    """The first SDPA backend that runs an fp32 forward and backward at q's
    head dim (the memory-efficient one where it takes it; each refusal
    logged), and its CUDA-event ms on (B, N, C) as one head: the forward
    that keeps what its backward needs, and that backward (dQ, dK, dV). The
    yardstick only; the port never calls it."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    leaves = [t.unsqueeze(1).detach().requires_grad_(True) for t in (q, k, v)]
    g = do.unsqueeze(1)
    for backend in (SDPBackend.EFFICIENT_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.FLASH_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([backend]), warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)
                o = F.scaled_dot_product_attention(*leaves, scale=scale)
                torch.autograd.grad(o, leaves, g)
                sync()
        except RuntimeError as e:
            log(f"[sdpa] {backend.name} refuses an fp32 forward and backward at head dim "
                f"{q.shape[-1]}: {str(e).splitlines()[0][:120]}")
            continue
        with sdpa_kernel([backend]):
            out = {"fwd_grad": cuda_ms(
                lambda: F.scaled_dot_product_attention(*leaves, scale=scale), iters)}
            o = F.scaled_dot_product_attention(*leaves, scale=scale)
            out["bwd"] = cuda_ms(lambda: torch.autograd.grad(o, leaves, g, retain_graph=True),
                                 iters)
        del o, leaves
        return backend.name, out
    raise SmokeFailure("no SDPA backend runs an fp32 forward and backward at head dim "
                       f"{q.shape[-1]}")


def rel_errors(out, ref) -> tuple[float, float, float]:
    """max|out - ref| / max|ref|, relative L2 error, and max|out - ref|."""
    d = out.float() - ref.float()
    r = ref.float()
    return ((d.abs().max() / r.abs().max()).item(), (d.norm() / r.norm()).item(),
            d.abs().max().item())


def bwd_rank_left_out(q, k, v, do, lse, delta, scale: float, rank: int):
    """(dq, dk, dv) of the plain backward with the 128 channels of cluster
    rank ``rank`` left out of the logits' sums S and dP (what a cluster that
    dropped one CTA's partial would give); the products keep every channel."""
    import torch

    keep = torch.ones(q.shape[-1], dtype=torch.bool, device=q.device)
    keep[rank * 128:(rank + 1) * 128] = False
    p = torch.exp(torch.matmul(q.float()[..., keep], k.float()[..., keep].transpose(1, 2))
                  * scale - lse[..., None])
    ds = p * (torch.matmul(do.float()[..., keep], v.float()[..., keep].transpose(1, 2))
              - delta[..., None]) * scale
    p, ds = p.to(q.dtype).float(), ds.to(q.dtype).float()
    return (torch.matmul(ds, k.float()).to(q.dtype),
            torch.matmul(ds.transpose(1, 2), q.float()).to(k.dtype),
            torch.matmul(p.transpose(1, 2), do.float()).to(v.dtype))


def tf32_hi(x):
    """fp32 ``x`` rounded to TF32 to nearest, ties away from zero (the
    kernels' ``cvt.rna``): half of TF32's last place added to the magnitude's
    bits, then the 13 bits TF32 drops cleared."""
    import torch

    return ((x.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def bwd_lo_left_out(q, k, v, do, lse, delta, scale: float):
    """(dq, dk, dv) at fp32 with the operands of every tensor-core product
    rounded to their TF32 hi (dP's, and the outputs' with P and dS; S, by
    FFMA, stays fp32): what the backward would give with its lo products
    left out (1xTF32). The products of TF32 values are exact in fp32, so
    TF32 stays off."""
    import torch

    p = torch.exp(torch.matmul(q, k.transpose(1, 2)) * scale - lse[..., None])
    ds = p * (torch.matmul(tf32_hi(do), tf32_hi(v).transpose(1, 2)) - delta[..., None]) * scale
    p, ds = tf32_hi(p), tf32_hi(ds)
    return (torch.matmul(ds, tf32_hi(k)), torch.matmul(ds.transpose(1, 2), tf32_hi(q)),
            torch.matmul(p.transpose(1, 2), tf32_hi(do)))


def phase_flash_bwd():
    """The flash training kernels against their plain versions at
    BWD_SHAPES, with planted faults, bit-equal run to run, CUDA-event times
    and the SDPA yardstick; the backward kernels also at BWD_SMALL_SHAPES
    (clusters of one and of three CTAs) and timed at BWD_EXCHANGE_SHAPE; then
    one AttentionBlock forward and backward on the card."""
    import torch

    from vae_channel_dynamics_tpu_torch.ops import flash_attention as fa

    names = ("flash_attention_fwd_lse", "flash_attention_bwd_dkv", "flash_attention_bwd_dq")
    names_f32 = tuple(f"{name}_f32" for name in names)
    results = {name: {"max_abs_err": 0.0} for name in names + names_f32}
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 10)

    def held(lines, shape, name, what, errs, fault_errs, max_rel_bound,
             rel_l2_bound=KERNEL_REL_L2):
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

    def backward(q, k, v, do, lse, delta, scale):
        """(dq, dk, dv) from the kernels (bf16 or fp32 by the operands),
        twice: bit-equal run to run."""
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale=scale)
        dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, scale=scale)
        dk2, dv2 = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale=scale)
        dq2 = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, scale=scale)
        sync()
        check(torch.equal(dq, dq2) and torch.equal(dk, dk2) and torch.equal(dv, dv2),
              f"the backward kernels are not bit-equal run to run at {tuple(q.shape)}")
        return dq, dk, dv

    def held_backward(lines, shape, q, k, v, do, lse, delta, scale, row_max=None):
        """dQ, dK, dV against plain, each bound shown to reject the planted
        faults: one query tile left out of dK/dV, one key tile left out of
        dQ, the last rank's partial left out of the logits' sums, delta left
        out of dS, and (with row_max) m in place of lse; at fp32 also one
        TF32 product (the plain version with TF32 on) and the kernels' lo
        products left out (bwd_lo_left_out), held to relative L2
        FLASH_F32_REL_L2 alone."""
        f32 = q.dtype == torch.float32
        suffix, max_rel_bound, rel_l2_bound = (("_f32", math.inf, FLASH_F32_REL_L2) if f32
                                               else ("", GRAD_MAX_REL, KERNEL_REL_L2))
        dq, dk, dv = backward(q, k, v, do, lse, delta, scale)
        pdq, pdk, pdv = fa.flash_attention_bwd_reference(q, k, v, do, lse, delta, scale)
        fs = FAULT_QUERIES
        _, tile_dk, tile_dv = fa.flash_attention_bwd_reference(
            q[:, fs:], k, v, do[:, fs:], lse[:, fs:], delta[:, fs:], scale)
        key_dq = fa.flash_attention_bwd_dq_reference(q, k[:, FAULT_TILE:], v[:, FAULT_TILE:], do,
                                                     lse, delta, scale)
        rank_dq, rank_dk, rank_dv = bwd_rank_left_out(q, k, v, do, lse, delta, scale,
                                                      fa.bwd_cluster_size(shape[2]) - 1)
        nod_dq, nod_dk, _ = fa.flash_attention_bwd_reference(
            q, k, v, do, lse, torch.zeros_like(delta), scale)
        m_faults = ({} if row_max is None else
                    dict(zip(("dq", "dk", "dv"), fa.flash_attention_bwd_reference(
                        q, k, v, do, row_max, delta, scale))))
        rank = "a rank's partial left out"
        faults_dk = {"a query tile left out": rel_errors(tile_dk, pdk), rank: rel_errors(rank_dk, pdk),
                     "delta left out": rel_errors(nod_dk, pdk)}
        faults_dv = {"a query tile left out": rel_errors(tile_dv, pdv), rank: rel_errors(rank_dv, pdv)}
        faults_dq = {"a key tile left out": rel_errors(key_dq, pdq), rank: rel_errors(rank_dq, pdq),
                     "delta left out": rel_errors(nod_dq, pdq)}
        tf32, hi_only = {}, {}
        if f32:
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                tf32 = dict(zip(("dq", "dk", "dv"), fa.flash_attention_bwd_reference(
                    q, k, v, do, lse, delta, scale)))
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
            hi_only = dict(zip(("dq", "dk", "dv"), bwd_lo_left_out(q, k, v, do, lse, delta,
                                                                    scale)))
        for faults, key in ((faults_dk, "dk"), (faults_dv, "dv"), (faults_dq, "dq")):
            plain = {"dq": pdq, "dk": pdk, "dv": pdv}[key]
            if m_faults:
                faults["m for lse"] = rel_errors(m_faults[key], plain)
            if tf32:
                faults["one TF32 product"] = rel_errors(tf32[key], plain)
                faults["the lo products left out"] = rel_errors(hi_only[key], plain)
        del m_faults, tf32, hi_only
        for name, what, errs, faults in (
                ("flash_attention_bwd_dkv", "dK", rel_errors(dk, pdk), faults_dk),
                ("flash_attention_bwd_dkv", "dV", rel_errors(dv, pdv), faults_dv),
                ("flash_attention_bwd_dq", "dQ", rel_errors(dq, pdq), faults_dq)):
            held(lines, shape, name + suffix, what, errs, faults, max_rel_bound, rel_l2_bound)
        lines.append("bit-equal run to run")

    def training_f32(shape, timed: bool):
        """The fp32 LSE forward and backward kernels against fp32 plain (TF32
        off), bit-equal run to run, each bound rejecting its planted faults;
        with ``timed``, their times in turns beside plain, the bounds and SDPA
        at fp32."""
        b, n, c = shape
        torch.backends.cuda.matmul.allow_tf32 = False
        q, k, v, do = (torch.randn(shape, generator=gen, device=DEVICE) for _ in range(4))
        scale = c ** -0.5
        lines = []
        o, lse = fa.flash_attention_fwd_lse(q, k, v, scale=scale, out_dtype=torch.float32)
        o2, lse2 = fa.flash_attention_fwd_lse(q, k, v, scale=scale, out_dtype=torch.float32)
        sync()
        check(torch.equal(o, o2) and torch.equal(lse, lse2),
              f"the fp32 LSE forward is not bit-equal run to run at {shape}")
        del o2, lse2
        po, plse = fa.flash_attention_fwd_lse_reference(q, k, v, scale, torch.float32)
        row_max = (torch.matmul(q, k.transpose(1, 2)) * scale).amax(dim=-1)
        dropped = fa.flash_attention_reference(q, k[:, :-FAULT_TILE].contiguous(),
                                               v[:, :-FAULT_TILE].contiguous(), scale,
                                               torch.float32)
        held(lines, shape, "flash_attention_fwd_lse_f32", "lse", rel_errors(lse, plse),
             {"m in place of lse": rel_errors(row_max, plse)}, LSE_MAX_REL, LSE_MAX_REL)
        held(lines, shape, "flash_attention_fwd_lse_f32", "o", rel_errors(o, po),
             {"a key tile left out": rel_errors(dropped, po)}, math.inf, FLASH_F32_REL_L2)
        del po, plse, dropped
        delta = (do * o).sum(-1)
        held_backward(lines, shape, q, k, v, do, lse, delta, scale,
                      row_max if shape in BWD_SHAPES else None)
        del row_max
        release()
        log(f"[flash-bwd] {shape} fp32 (TF32 off), a cluster of {fa.bwd_cluster_size(c)}: "
            + "; ".join(lines))
        if timed:
            times = {
                "flash_attention_fwd_lse_f32": timed_pair(
                    lambda: fa.flash_attention_fwd_lse(q, k, v, scale=scale,
                                                       out_dtype=torch.float32),
                    lambda: fa.flash_attention_fwd_lse_reference(q, k, v, scale, torch.float32),
                    BWD_ITERS),
                "flash_attention_bwd_dkv_f32": timed_pair(
                    lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale=scale),
                    lambda: fa.flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta, scale),
                    BWD_ITERS),
                "flash_attention_bwd_dq_f32": timed_pair(
                    lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, scale=scale),
                    lambda: fa.flash_attention_bwd_dq_reference(q, k, v, do, lse, delta, scale),
                    BWD_ITERS),
            }
            backend, lib = sdpa_f32_times(q, k, v, do, scale, BWD_ITERS)
            bounds = flash_bounds(b, n, c)
            both = "flash_attention_bwd_dkv_f32 + flash_attention_bwd_dq_f32"
            library = {"flash_attention_fwd_lse_f32": (lib["fwd_grad"],
                                                       "flash_attention_fwd_lse_f32"),
                       "flash_attention_bwd_dkv_f32": (lib["bwd"], both),
                       "flash_attention_bwd_dq_f32": (lib["bwd"], both)}
            if shape == BWD_SHAPES[0]:
                for name in names_f32:
                    results[name].update(shape=list(shape), ms=times[name][0],
                                         plain_ms=times[name][1], bound_ms=bounds[name][0],
                                         bound_by=bounds[name][1], library_ms=library[name][0],
                                         library_covers=f"scaled_dot_product_attention fp32 "
                                                        f"({backend}): {library[name][1]}")
            log(f"[flash-bwd] {shape} fp32 ms kernel/plain/bound (CUDA events, {BWD_ITERS} "
                "calls, in turns; the bounds 3xTF32 at 495 TFLOP/s): " + ", ".join(
                    f"{name} {times[name][0]:.4f}/{times[name][1]:.4f}/{bounds[name][0]:.4f} "
                    f"({100 * bounds[name][0] / times[name][0]:.1f}% of bound)"
                    for name in names_f32)
                + f"; SDPA fp32 ({backend}) forward for backward {lib['fwd_grad']:.4f}, backward "
                f"{lib['bwd']:.4f}; kernels forward+backward "
                f"{sum(times[name][0] for name in names_f32):.4f}")
        del q, k, v, do, o, lse, delta
        release()

    bwd_ms = {}
    for shape in BWD_SHAPES:
        b, n, c = shape
        q, k, v, do = (torch.randn(shape, generator=gen, device=DEVICE).to(torch.bfloat16)
                       for _ in range(4))
        scale = c ** -0.5
        lines = []

        # the training forward: o and lse; fault: the row max m in place of lse
        o, lse = fa.flash_attention_fwd_lse(q, k, v, scale=scale, out_dtype=torch.bfloat16)
        sync()
        po, plse = fa.flash_attention_fwd_lse_reference(q, k, v, scale, torch.bfloat16)
        row_max = (torch.matmul(q.float(), k.float().transpose(1, 2)) * scale).amax(dim=-1)
        held(lines, shape, "flash_attention_fwd_lse", "lse", rel_errors(lse, plse),
             {"m in place of lse": rel_errors(row_max, plse)}, LSE_MAX_REL, LSE_MAX_REL)
        max_rel, rel_l2, abs_err = rel_errors(o, po)
        lines.append(f"o: max rel {max_rel:.3g}, rel L2 {rel_l2:.3g}")
        check(rel_l2 <= KERNEL_REL_L2 and max_rel <= GRAD_MAX_REL,
              f"the LSE forward's o disagrees with plain at {shape}")
        del po, plse

        # the backward kernels on the kernel's own lse and delta
        delta = (do.float() * o.float()).sum(-1)
        held_backward(lines, shape, q, k, v, do, lse, delta, scale, row_max)
        del row_max
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
        bwd_ms[shape] = {name: times[name][0] for name in names[1:]}
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
            f"{sum(times[name][0] for name in names):.4f}, backward "
            f"{times[names[1]][0] + times[names[2]][0]:.4f}")
        del q, k, v, do, o, lse, delta
        release()
        training_f32(shape, timed=True)

    # clusters of one and of three CTAs; then the exchange's price: C = 128
    # at the main shape's N is the same work a CTA as C = 512's, with no
    # traffic between SMs
    for shape in BWD_SMALL_SHAPES + (BWD_EXCHANGE_SHAPE,):
        b, n, c = shape
        q, k, v, do = (torch.randn(shape, generator=gen, device=DEVICE).to(torch.bfloat16)
                       for _ in range(4))
        scale = c ** -0.5
        o, lse = fa.flash_attention_fwd_lse_reference(q, k, v, scale, torch.bfloat16)
        delta = (do.float() * o.float()).sum(-1)
        lines = []
        if shape in BWD_SMALL_SHAPES:
            held_backward(lines, shape, q, k, v, do, lse, delta, scale)
        else:
            dkv = cuda_ms(lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                             scale=scale), BWD_ITERS)
            dq = cuda_ms(lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, scale=scale),
                         BWD_ITERS)
            main = bwd_ms[BWD_SHAPES[0]]
            ranks = fa.bwd_cluster_size(BWD_SHAPES[0][2])
            lines.append(
                f"dK/dV {dkv:.4f} ms, dQ {dq:.4f} ms (a cluster of 1; x {ranks} = "
                f"{ranks * dkv:.4f} and {ranks * dq:.4f} against {BWD_SHAPES[0]}'s "
                f"{main['flash_attention_bwd_dkv']:.4f} and {main['flash_attention_bwd_dq']:.4f}: "
                f"traffic between SMs {100 * (1 - ranks * dkv / main['flash_attention_bwd_dkv']):.1f}% "
                f"and {100 * (1 - ranks * dq / main['flash_attention_bwd_dq']):.1f}% of the call)")
        log(f"[flash-bwd] {shape} bf16, a cluster of {fa.bwd_cluster_size(c)}: " + "; ".join(lines))
        del q, k, v, do, o, lse, delta
        release()
        if shape in BWD_SMALL_SHAPES:
            training_f32(shape, timed=False)
        else:
            # the fp32 backward's exchange, priced the same way
            q, k, v, do = (torch.randn(shape, generator=gen, device=DEVICE) for _ in range(4))
            o, lse = fa.flash_attention_fwd_lse_reference(q, k, v, scale, torch.float32)
            delta = (do * o).sum(-1)
            dkv = cuda_ms(lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                             scale=scale), BWD_ITERS)
            dq = cuda_ms(lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, scale=scale),
                         BWD_ITERS)
            main = {name: results[name]["ms"] for name in names_f32[1:]}
            ranks = fa.bwd_cluster_size(BWD_SHAPES[0][2])
            log(f"[flash-bwd] {shape} fp32, a cluster of 1: dK/dV {dkv:.4f} ms, dQ {dq:.4f} ms "
                f"(x {ranks} = {ranks * dkv:.4f} and {ranks * dq:.4f} against {BWD_SHAPES[0]}'s "
                f"{main['flash_attention_bwd_dkv_f32']:.4f} and "
                f"{main['flash_attention_bwd_dq_f32']:.4f}: the exchange "
                f"{100 * (1 - ranks * dkv / main['flash_attention_bwd_dkv_f32']):.1f}% and "
                f"{100 * (1 - ranks * dq / main['flash_attention_bwd_dq_f32']):.1f}% of the call)")
            del q, k, v, do, o, lse, delta
            release()
    large_logits_f32()
    phase_attention_block()
    return results


# The flash kernels at fewer queries than keys: the 1024px mid block under
# parallel.spatial 2 and 4, each rank's N / S queries against all N keys,
# (B, nq, nk, C). Each kernel (the serving forward #6, the LSE forward #6',
# dK/dV #7, dQ #8) in bf16 and fp32 against its plain version under the
# bounds of phase_flash_bwd, bit-equal run to run, rejecting a key tile
# left out of o and dQ, a query tile left out of dK/dV and the cluster's
# last rank left out of the logits' sums; timed in turns with plain, beside
# the bound at (nq, nk) and SDPA at the same shapes.
SPLIT_SHAPES = ((1, 8192, 16384, 512), (1, 4096, 16384, 512))
SPLIT_ITERS = 5
SPLIT_KERNELS = ("flash_attention_fwd", "flash_attention_fwd_lse", "flash_attention_bwd_dkv",
                 "flash_attention_bwd_dq")


def phase_flash_split() -> dict:
    """The flash kernels at SPLIT_SHAPES (see the comment above them).
    Returns {kernel name (with _f32 at fp32): its numbers at SPLIT_SHAPES[0]}."""
    import torch

    from vae_channel_dynamics_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 18)
    results = {}
    for dtype in (torch.bfloat16, torch.float32):
        f32 = dtype == torch.float32
        suffix = "_f32" if f32 else ""
        for shape in SPLIT_SHAPES:
            b, nq, nk, c = shape
            q, do = (torch.randn((b, nq, c), generator=gen, device=DEVICE).to(dtype)
                     for _ in range(2))
            k, v = (torch.randn((b, nk, c), generator=gen, device=DEVICE).to(dtype)
                    for _ in range(2))
            scale = c ** -0.5

            def kernels():
                o, lse = fa.flash_attention_fwd_lse(q, k, v, scale=scale, out_dtype=dtype)
                serving = fa.flash_attention_fwd(q, k, v, scale=scale, out_dtype=dtype)
                delta = (do.float() * o.float()).sum(-1)
                dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale=scale)
                dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, scale=scale)
                return o, lse, serving, delta, dq, dk, dv

            first, again = kernels(), kernels()
            sync()
            check(all(torch.equal(a, b_) for a, b_ in zip(first, again)),
                  f"[flash-split] the kernels are not bit-equal run to run at {shape} {dtype}")
            del again
            o, lse, serving, delta, dq, dk, dv = first
            check(torch.equal(serving, o), f"[flash-split] the serving forward's o is not the "
                                           f"LSE forward's at {shape} {dtype}")
            po, plse = fa.flash_attention_fwd_lse_reference(q, k, v, scale, dtype)
            pdq, pdk, pdv = fa.flash_attention_bwd_reference(q, k, v, do, lse, delta, scale)
            dropped = fa.flash_attention_reference(q, k[:, :-FAULT_TILE].contiguous(),
                                                   v[:, :-FAULT_TILE].contiguous(), scale, dtype)
            _, tile_dk, tile_dv = fa.flash_attention_bwd_reference(
                q[:, FAULT_QUERIES:], k, v, do[:, FAULT_QUERIES:], lse[:, FAULT_QUERIES:],
                delta[:, FAULT_QUERIES:], scale)
            key_dq = fa.flash_attention_bwd_dq_reference(q, k[:, FAULT_TILE:], v[:, FAULT_TILE:],
                                                         do, lse, delta, scale)
            rank_dq, rank_dk, rank_dv = bwd_rank_left_out(q, k, v, do, lse, delta, scale,
                                                          fa.bwd_cluster_size(c) - 1)
            max_rel_bound, rel_l2_bound = ((math.inf, FLASH_F32_REL_L2) if f32
                                           else (GRAD_MAX_REL, KERNEL_REL_L2))
            errs, lines = {}, []
            for what, got, ref, faults in (
                    ("lse", lse, plse, {}),
                    ("o", o, po, {"a key tile left out": dropped}),
                    ("dQ", dq, pdq, {"a key tile left out": key_dq, "a rank left out": rank_dq}),
                    ("dK", dk, pdk, {"a query tile left out": tile_dk,
                                     "a rank left out": rank_dk}),
                    ("dV", dv, pdv, {"a query tile left out": tile_dv,
                                     "a rank left out": rank_dv})):
                bounds_of = ((LSE_MAX_REL, LSE_MAX_REL) if what == "lse"
                             else (max_rel_bound, rel_l2_bound))
                max_rel, rel_l2, abs_err = rel_errors(got, ref)
                errs[what] = abs_err
                check(max_rel <= bounds_of[0] and rel_l2 <= bounds_of[1],
                      f"[flash-split] {what} disagrees with plain at {shape} {dtype}: max rel "
                      f"{max_rel:.3g}, rel L2 {rel_l2:.3g}")
                rejected = []
                for fault, f in faults.items():
                    fm, fl, _ = rel_errors(f, ref)
                    check(fm > bounds_of[0] or fl > bounds_of[1],
                          f"[flash-split] the {what} bound at {shape} does not reject {fault}")
                    rejected.append(f"{fault} {fl:.3g}")
                lines.append(f"{what} max rel {max_rel:.3g}, rel L2 {rel_l2:.3g}"
                             + (f" (rejects {', '.join(rejected)})" if rejected else ""))
            del po, plse, pdq, pdk, pdv, dropped, tile_dk, tile_dv, key_dq, rank_dq, rank_dk
            del rank_dv, first
            release()
            times = {
                "flash_attention_fwd": timed_pair(
                    lambda: fa.flash_attention_fwd(q, k, v, scale=scale, out_dtype=dtype),
                    lambda: fa.flash_attention_reference(q, k, v, scale, dtype), SPLIT_ITERS),
                "flash_attention_fwd_lse": timed_pair(
                    lambda: fa.flash_attention_fwd_lse(q, k, v, scale=scale, out_dtype=dtype),
                    lambda: fa.flash_attention_fwd_lse_reference(q, k, v, scale, dtype),
                    SPLIT_ITERS),
                "flash_attention_bwd_dkv": timed_pair(
                    lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale=scale),
                    lambda: fa.flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta, scale),
                    SPLIT_ITERS),
                "flash_attention_bwd_dq": timed_pair(
                    lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, scale=scale),
                    lambda: fa.flash_attention_bwd_dq_reference(q, k, v, do, lse, delta, scale),
                    SPLIT_ITERS),
            }
            if f32:
                backend, lib = sdpa_f32_times(q, k, v, do, scale, SPLIT_ITERS)
                lib["fwd"] = sdpa_fp32_ms(q, k, v, scale, SPLIT_ITERS)[1]
            else:
                backend, lib = sdpa_times(q, k, v, do, scale, SPLIT_ITERS)
            library = {"flash_attention_fwd": lib["fwd"], "flash_attention_fwd_lse": lib["fwd_grad"],
                       "flash_attention_bwd_dkv": lib["bwd"], "flash_attention_bwd_dq": lib["bwd"]}
            bounds = flash_bounds(b, nq, c, nk)
            err_of = {"flash_attention_fwd": errs["o"], "flash_attention_fwd_lse": errs["o"],
                      "flash_attention_bwd_dkv": max(errs["dK"], errs["dV"]),
                      "flash_attention_bwd_dq": errs["dQ"]}
            if shape == SPLIT_SHAPES[0]:
                for name in SPLIT_KERNELS:
                    results[name + suffix] = {
                        "shape": list(shape), "ms": times[name][0], "plain_ms": times[name][1],
                        "bound_ms": bounds[name + suffix][0],
                        "bound_by": bounds[name + suffix][1], "library_ms": library[name],
                        "max_abs_err": err_of[name]}
            log(f"[flash-split] (B={b}, nq={nq}, nk={nk}, C={c}) {'fp32' if f32 else 'bf16'}: "
                + "; ".join(lines) + "; bit-equal run to run; ms kernel/plain/bound (CUDA "
                f"events, {SPLIT_ITERS} calls, in turns): " + ", ".join(
                    f"{name}{suffix} {times[name][0]:.4f}/{times[name][1]:.4f}/"
                    f"{bounds[name + suffix][0]:.4f} "
                    f"({100 * bounds[name + suffix][0] / times[name][0]:.1f}% of bound)"
                    for name in SPLIT_KERNELS)
                + f"; SDPA{' fp32' if f32 else ''} ({backend}) forward {lib['fwd']:.4f}, forward "
                f"for backward {lib['fwd_grad']:.4f}, backward {lib['bwd']:.4f}")
            del q, k, v, do, o, lse, serving, delta, dq, dk, dv
            release()
    return results


# Flash heads wider than 512 channels (phase_flash_wide): every entry, bf16
# and fp32, at each of WIDE_WIDTHS on WIDE_CHECK_SHAPES ((B, nq, nk): nq ==
# nk and nq = nk / 2), held to its plain version with the bounds of
# phase_flash_bwd and phase_flash_split, bit-equal over two runs, rejecting
# the designs' own faults: a rank's partial left out of S (the forwards'
# second CTA of two, the backward's last of C / 128), and at fp32 1xTF32 in
# place of 3xTF32 (the forward: plain with TF32 on; the backward:
# bwd_lo_left_out). At WIDE_TIMED_WIDTHS the kernels are timed at the
# table's path shapes, (4, 4096, C) serving and (1, 16384, C) training,
# beside plain, their bound and SDPA (phase_flash_split's backends,
# named). Then the model's AttentionBlock at WIDE_BLOCK_WIDTHS under
# explicit flash: forward at N = 4096 and forward+backward at N = 16384,
# bf16 and fp32, against the naive block (bf16 within the naive block's own
# bf16-vs-fp32 difference, fp32 within STEP_F32_REL), its launches counted:
# the flash kernels ran and chunked did not.
WIDE_WIDTHS = (640, 768, 896, 1024)
WIDE_CHECK_SHAPES = ((2, 256, 256), (2, 128, 256))
WIDE_TIMED_WIDTHS = (768, 1024)
WIDE_SERVING_SHAPE = (4, 4096)
WIDE_TRAIN_SHAPE = (1, 16384)
WIDE_ITERS = 3
WIDE_BLOCK_WIDTHS = (1024, 768)
WIDE_BLOCK_SIDES = {"forward": 64, "forward+backward": 128}  # N = side^2 tokens


def fwd_rank_left_out(q, k, v, scale: float, dtype):
    """The plain forward with the forwards' last cluster rank's channels
    (from ``fwd_slice(C)`` on) left out of the logits, every channel of V
    kept: what a cluster that dropped the other CTA's partial would give."""
    import torch

    from vae_channel_dynamics_tpu_torch.ops import flash_attention as fa

    cs = fa.fwd_slice(q.shape[-1])
    p = torch.softmax(torch.matmul(q[..., :cs].float(), k[..., :cs].float().transpose(1, 2))
                      * scale, dim=-1).to(q.dtype)
    return torch.matmul(p, v).to(dtype)


def phase_flash_wide() -> dict:
    """The flash kernels at heads of 640-1024 channels (see the comment above
    WIDE_WIDTHS). Returns {kernel name (with _f32 at fp32): {C: its numbers
    at the path shape}} for WIDE_TIMED_WIDTHS."""
    import torch

    from vae_channel_dynamics_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 21)
    results: dict = {}
    for dtype in (torch.bfloat16, torch.float32):
        f32 = dtype == torch.float32
        suffix, tag = ("_f32", "fp32") if f32 else ("", "bf16")
        for c in WIDE_WIDTHS:
            lines = []
            for b, nq, nk in WIDE_CHECK_SHAPES:
                q, do = (torch.randn((b, nq, c), generator=gen, device=DEVICE).to(dtype)
                         for _ in range(2))
                k, v = (torch.randn((b, nk, c), generator=gen, device=DEVICE).to(dtype)
                        for _ in range(2))
                scale = c ** -0.5

                def kernels():
                    o, lse = fa.flash_attention_fwd_lse(q, k, v, scale=scale, out_dtype=dtype)
                    serving = fa.flash_attention_fwd(q, k, v, scale=scale, out_dtype=dtype)
                    delta = (do.float() * o.float()).sum(-1)
                    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale=scale)
                    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, scale=scale)
                    return o, lse, serving, delta, dq, dk, dv

                first, again = kernels(), kernels()
                sync()
                check(all(torch.equal(x, y) for x, y in zip(first, again)),
                      f"[flash-wide] the kernels are not bit-equal run to run at "
                      f"{(b, nq, nk, c)} {tag}")
                o, lse, serving, delta, dq, dk, dv = first
                check(torch.equal(serving, o), f"[flash-wide] the serving forward's o is not "
                                               f"the LSE forward's at {(b, nq, nk, c)} {tag}")
                po, plse = fa.flash_attention_fwd_lse_reference(q, k, v, scale, dtype)
                pdq, pdk, pdv = fa.flash_attention_bwd_reference(q, k, v, do, lse, delta, scale)
                rank_o = fwd_rank_left_out(q, k, v, scale, dtype)
                rank_dq, rank_dk, rank_dv = bwd_rank_left_out(q, k, v, do, lse, delta, scale,
                                                              fa.bwd_cluster_size(c) - 1)
                faults = {"o": {"a rank left out": rank_o}, "dQ": {"a rank left out": rank_dq},
                          "dK": {"a rank left out": rank_dk},
                          "dV": {"a rank left out": rank_dv}}
                if f32:
                    torch.backends.cuda.matmul.allow_tf32 = True
                    try:
                        faults["o"]["1xTF32"] = fa.flash_attention_reference(q, k, v, scale,
                                                                             dtype)
                    finally:
                        torch.backends.cuda.matmul.allow_tf32 = False
                    for what, f in zip(("dQ", "dK", "dV"),
                                       bwd_lo_left_out(q, k, v, do, lse, delta, scale)):
                        faults[what]["1xTF32"] = f
                bounds = ((math.inf, FLASH_F32_REL_L2) if f32 else (GRAD_MAX_REL, KERNEL_REL_L2))
                row = []
                for what, got, ref in (("lse", lse, plse), ("o", o, po), ("dQ", dq, pdq),
                                       ("dK", dk, pdk), ("dV", dv, pdv)):
                    if what == "lse":
                        bound = (LSE_MAX_REL, LSE_MAX_REL)
                    elif what == "o" and not f32:
                        # the forward's bound: KERNEL_ULPS bf16 ulps of max|plain|
                        bound = (KERNEL_ULPS * bf16_ulp(ref.float().abs().max().item())
                                 / ref.float().abs().max().item(), KERNEL_REL_L2)
                    else:
                        bound = bounds
                    max_rel, rel_l2, _abs = rel_errors(got, ref)
                    check(bool(torch.isfinite(got).all()) and max_rel <= bound[0]
                          and rel_l2 <= bound[1],
                          f"[flash-wide] {what} disagrees with plain at {(b, nq, nk, c)} {tag}: "
                          f"max rel {max_rel:.3g}, rel L2 {rel_l2:.3g}")
                    rejected = []
                    for fault, f in faults.get(what, {}).items():
                        fm, fl, _ = rel_errors(f, ref)
                        check(fm > bound[0] or fl > bound[1],
                              f"[flash-wide] the {what} bound at {(b, nq, nk, c)} {tag} does not "
                              f"reject {fault}")
                        rejected.append(f"{fault} {fl:.3g}")
                    row.append(f"{what} {max_rel:.3g}/{rel_l2:.3g}"
                               + (f" (rejects {', '.join(rejected)})" if rejected else ""))
                lines.append(f"(B={b}, nq={nq}, nk={nk}): " + ", ".join(row))
                del first, again, po, plse, pdq, pdk, pdv, faults, rank_o
                del q, k, v, do, o, lse, serving, delta, dq, dk, dv
                release()
            log(f"[flash-wide] C={c} {tag}, clusters fwd {fa.fwd_cluster_size(c)} x "
                f"{fa.fwd_slice(c)} channels, bwd {fa.bwd_cluster_size(c)} x {fa.BWD_SLICE}; "
                "max rel/rel L2 against plain; bit-equal run to run: " + "; ".join(lines))
        for c in WIDE_TIMED_WIDTHS:
            scale = c ** -0.5
            b, n = WIDE_SERVING_SHAPE
            q, k, v = (torch.randn((b, n, c), generator=gen, device=DEVICE).to(dtype)
                       for _ in range(3))
            serve = timed_pair(lambda: fa.flash_attention_fwd(q, k, v, scale=scale,
                                                              out_dtype=dtype),
                               lambda: fa.flash_attention_reference(q, k, v, scale, dtype),
                               WIDE_ITERS)
            serve_err = rel_errors(fa.flash_attention_fwd(q, k, v, scale=scale, out_dtype=dtype),
                                   fa.flash_attention_reference(q, k, v, scale, dtype))[2]
            if f32:
                backend_s, serve_lib = sdpa_fp32_ms(q, k, v, scale, WIDE_ITERS)
            else:
                backend_s, serve_lib = sdpa_times(q, k, v, None, scale, WIDE_ITERS)
                serve_lib = serve_lib["fwd"]
            intake_tbs = fwd_intake_bytes(b, n, c) / serve[0] / 1e9
            serve_bound = flash_bounds(b, n, c)["flash_attention_fwd" + suffix]
            del q, k, v
            release()
            b, n = WIDE_TRAIN_SHAPE
            q, k, v, do = (torch.randn((b, n, c), generator=gen, device=DEVICE).to(dtype)
                           for _ in range(4))
            o, lse = fa.flash_attention_fwd_lse(q, k, v, scale=scale, out_dtype=dtype)
            delta = (do.float() * o.float()).sum(-1)
            times = {
                "flash_attention_fwd": serve,
                "flash_attention_fwd_lse": timed_pair(
                    lambda: fa.flash_attention_fwd_lse(q, k, v, scale=scale, out_dtype=dtype),
                    lambda: fa.flash_attention_fwd_lse_reference(q, k, v, scale, dtype),
                    WIDE_ITERS),
                "flash_attention_bwd_dkv": timed_pair(
                    lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale=scale),
                    lambda: fa.flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta, scale),
                    WIDE_ITERS),
                "flash_attention_bwd_dq": timed_pair(
                    lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, scale=scale),
                    lambda: fa.flash_attention_bwd_dq_reference(q, k, v, do, lse, delta, scale),
                    WIDE_ITERS),
            }
            po, plse = fa.flash_attention_fwd_lse_reference(q, k, v, scale, dtype)
            refs = fa.flash_attention_bwd_reference(q, k, v, do, lse, delta, scale)
            dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale=scale)
            dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, scale=scale)
            errs = {"flash_attention_fwd": serve_err,
                    "flash_attention_fwd_lse": rel_errors(o, po)[2],
                    "flash_attention_bwd_dkv": max(rel_errors(dk, refs[1])[2],
                                                   rel_errors(dv, refs[2])[2]),
                    "flash_attention_bwd_dq": rel_errors(dq, refs[0])[2]}
            del po, plse, refs, dk, dv, dq
            release()
            backend_t, lib_t = (sdpa_f32_times if f32 else sdpa_times)(q, k, v, do, scale,
                                                                       WIDE_ITERS)
            library = {"flash_attention_fwd": (serve_lib, backend_s, "forward"),
                       "flash_attention_fwd_lse": (lib_t["fwd_grad"], backend_t,
                                                   "forward for backward"),
                       "flash_attention_bwd_dkv": (lib_t["bwd"], backend_t, "backward, #7+#8"),
                       "flash_attention_bwd_dq": (lib_t["bwd"], backend_t, "backward, #7+#8")}
            bounds = flash_bounds(b, n, c)
            bounds["flash_attention_fwd" + suffix] = serve_bound
            row = []
            for name in SPLIT_KERNELS:
                key = name + suffix
                shape = ([*WIDE_SERVING_SHAPE, c] if name == "flash_attention_fwd"
                         else [*WIDE_TRAIN_SHAPE, c])
                bound_ms, bound_by = bounds[key]
                lib_ms, backend, covers = library[name]
                results.setdefault(key, {})[c] = {
                    "shape": shape, "ms": times[name][0], "plain_ms": times[name][1],
                    "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
                    "library_covers": f"scaled_dot_product_attention {covers} ({backend})",
                    "max_abs_err": errs[name]}
                row.append(f"{key} {tuple(shape)} {times[name][0]:.4f}/{times[name][1]:.4f}/"
                           f"{bound_ms:.4f}/{lib_ms:.4f} ({100 * bound_ms / times[name][0]:.1f}%"
                           " of bound)")
            log(f"[flash-wide] C={c} {tag} ms kernel/plain/bound/SDPA (CUDA events, "
                f"{WIDE_ITERS} calls, in turns; SDPA {backend_s} serving, {backend_t} "
                f"training): " + "; ".join(row) + f"; the serving forward's K and V from L2 "
                f"into the SMs at {intake_tbs:.2f} TB/s ({intake_tbs / SMS * 1e3:.1f} GB/s an "
                f"SM; a CTA reads its {fa.fwd_slice(c)}-channel slice)")
            del q, k, v, do, o, lse, delta
            release()
    phase_wide_block()
    return results


def phase_wide_block() -> None:
    """The model's AttentionBlock at WIDE_BLOCK_WIDTHS under explicit flash
    against the naive block: forward at N = 4096 and forward+backward at N =
    16384, bf16 and fp32; the flash kernels launched, chunked never."""
    import torch

    from vae_channel_dynamics_tpu_torch.models import vae as vae_mod
    from vae_channel_dynamics_tpu_torch.models.vae import AttentionBlock, Linear
    from vae_channel_dynamics_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    chunked_calls = []
    real_chunked = vae_mod.chunked_attention

    def counted_chunked(*a, **kw):
        chunked_calls.append(a[0].shape)
        return real_chunked(*a, **kw)

    vae_mod.chunked_attention = counted_chunked
    try:
        for c in WIDE_BLOCK_WIDTHS:
            blk = AttentionBlock(c, 32, 1e-6, device=DEVICE)
            gen = torch.Generator(device=DEVICE).manual_seed(SEED + 22 + c)
            with torch.no_grad():
                for module in blk.modules():
                    if hasattr(module, "init_weights"):
                        module.init_weights(gen)
                blk.group_norm.weight.add_(0.1 * torch.randn(c, generator=gen, device=DEVICE))
            for what, side in WIDE_BLOCK_SIDES.items():
                grad = what == "forward+backward"
                x = torch.randn(1, c, side, side, generator=gen, device=DEVICE)
                g = torch.randn(x.shape, generator=gen, device=DEVICE)

                def run(impl, dtype):
                    blk.attn_impl = impl
                    for module in blk.modules():
                        if isinstance(module, Linear):
                            module.compute_dtype = dtype
                    blk.zero_grad(set_to_none=True)
                    xx = x.to(dtype).detach().requires_grad_(grad)
                    with torch.set_grad_enabled(grad):
                        out = blk(xx)
                        if grad:
                            out.backward(g.to(out.dtype))
                    sync()
                    res = {"out": out.detach().float()}
                    if grad:
                        res.update({name: p.grad.float().clone()
                                    for name, p in blk.named_parameters()})
                        res["input"] = xx.grad.float()
                    return res

                fp32_naive = run("naive", torch.float32)
                rows, launched = [], {}
                for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
                    before, calls = dict(fa.launches), len(chunked_calls)
                    flash = run("flash", dtype)
                    counts = {k: fa.launches[k] - before[k] for k in fa.launches}
                    want = (("flash_attention_fwd_lse", "flash_attention_bwd_dkv",
                             "flash_attention_bwd_dq") if grad else ("flash_attention_fwd",))
                    suffix = "_f32" if dtype == torch.float32 else ""
                    check(counts == {k: int(k in {w + suffix for w in want}) for k in fa.KERNELS}
                          and len(chunked_calls) == calls,
                          f"[flash-wide] the C={c} block's flash {what} {tag} launched {counts}, "
                          f"chunked {len(chunked_calls) - calls} times")
                    launched[tag] = {k: n for k, n in counts.items() if n}
                    naive = run("naive", dtype) if dtype == torch.bfloat16 else fp32_naive
                    for name in flash:
                        d = ((flash[name] - naive[name]).norm() / naive[name].norm()).item()
                        check(flash[name].abs().max().item() > 0,
                              f"[flash-wide] the C={c} block's {name} is zero ({what}, {tag})")
                        if dtype == torch.bfloat16:
                            control = ((naive[name] - fp32_naive[name]).norm()
                                       / fp32_naive[name].norm()).item()
                            bound = BLOCK_CONTROL_RATIO * control + BLOCK_FLOOR
                        else:
                            control, bound = None, STEP_F32_REL
                            if name == "to_k.bias":
                                # it shifts a row's logits by one amount, which
                                # the softmax cancels: its gradient is rounding
                                # in both, held against to_k.weight's
                                d = ((flash[name] - naive[name]).norm()
                                     / naive["to_k.weight"].norm()).item()
                        check(d <= bound, f"[flash-wide] the C={c} block's {name} ({what}, {tag}) "
                                          f"is {d} from naive, bound {bound}")
                        rows.append(f"{tag} {name} {d:.3g}"
                                    + (f" (control {control:.3g})" if control is not None else ""))
                    del flash, naive
                log(f"[flash-wide] AttentionBlock C={c} (1, {c}, {side}, {side}), N = {side ** 2}, "
                    f"explicit flash {what} vs naive, rel L2 (bf16 bound {BLOCK_CONTROL_RATIO} x "
                    f"naive bf16 vs fp32 + {BLOCK_FLOOR}; fp32 bound {STEP_F32_REL}); launches "
                    f"{launched}, chunked 0: " + ", ".join(rows))
                del fp32_naive, x, g
                release()
            del blk
            release()
    finally:
        vae_mod.chunked_attention = real_chunked


def large_logits_f32():
    """The fp32 training kernels at LARGE_LOGITS_SHAPE with q and k x 8 and
    scale 1 against fp32 plain, bound LARGE_LOGITS_REL_L2, which rejects two
    planted faults: S summed exactly (fp64, then rounded) and one TF32
    product (the plain version with TF32 on)."""
    import torch

    from vae_channel_dynamics_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 14)
    q, k, v, do = (torch.randn(LARGE_LOGITS_SHAPE, generator=gen, device=DEVICE)
                   for _ in range(4))
    q, k = q * 8, k * 8
    o, lse = fa.flash_attention_fwd_lse(q, k, v, scale=1.0, out_dtype=torch.float32)
    delta = (do * o).sum(-1)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale=1.0)
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, scale=1.0)
    sync()
    refs = fa.flash_attention_bwd_reference(q, k, v, do, lse, delta, 1.0)
    p = torch.exp(torch.matmul(q.double(), k.double().transpose(1, 2)).float() - lse[..., None])
    ds = p * (torch.matmul(do, v.transpose(1, 2)) - delta[..., None])
    exact = (torch.matmul(ds, k), torch.matmul(ds.transpose(1, 2), q),
             torch.matmul(p.transpose(1, 2), do))
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = fa.flash_attention_bwd_reference(q, k, v, do, lse, delta, 1.0)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    lines = []
    for name, g, r, e, t in zip(("dQ", "dK", "dV"), (dq, dk, dv), refs, exact, tf32):
        rel, rel_exact, rel_tf32 = (rel_errors(x, r)[1] for x in (g, e, t))
        lines.append(f"{name} rel L2 {rel:.3g} (bound {LARGE_LOGITS_REL_L2:.3g}); S summed "
                     f"exactly {rel_exact:.3g}, one TF32 product {rel_tf32:.3g}")
        check(torch.isfinite(g).all().item() and rel <= LARGE_LOGITS_REL_L2,
              f"the fp32 backward's {name} at large logits is {rel} (rel L2) from plain")
        check(rel_exact > LARGE_LOGITS_REL_L2 and rel_tf32 > LARGE_LOGITS_REL_L2,
              f"the large-logit bound does not reject a planted fault on {name}")
    log(f"[flash-bwd] {LARGE_LOGITS_SHAPE} fp32, q and k x 8, scale 1 (max |S| "
        f"{torch.matmul(q, k.transpose(1, 2)).abs().max().item():.0f}): " + "; ".join(lines))


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
    check(counts == {name: int(name in ("flash_attention_fwd_lse", "flash_attention_bwd_dkv",
                                        "flash_attention_bwd_dq")) for name in fa.KERNELS},
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
        SERVING_LIVE.update(p50_ms=p50_ms, p95_ms=p95_ms, rps=rps, requests=len(lat))
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

        # the HTTP load client of tools/serving_bench.py against the same server
        from vae_channel_dynamics_tpu_torch.tools import serving_bench

        bench = serving_bench.run(f"http://127.0.0.1:{server.port}", streams=LOAD_CONCURRENCY,
                                  duration_s=SERVING_BENCH_SECONDS, resolution=RESOLUTION)
        log(f"[slice] tools/serving_bench, {LOAD_CONCURRENCY} streams for "
            f"{SERVING_BENCH_SECONDS:.0f} s: {json.dumps(bench)}")
        check(bench["errors"] == 0 and bench["ok"] > 0 and bench["shed_503"] == 0,
              f"serving_bench: {bench}")
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


def _gn_check(shape, groups: int, dtype, gen, results: dict) -> tuple:
    """Each GroupNorm kernel against its plain version on the same inputs,
    then the autograd op against the plain GroupNorm, at ``shape`` with
    ``groups`` groups in ``dtype`` (bf16 or fp32); every bound is shown to
    reject a planted fault. Adds each kernel's max abs error to
    ``results``; returns (the lines to log, the inputs (x, g, scale, bias,
    a, b, ca, cb, cc) for the times)."""
    import torch

    from vae_channel_dynamics_tpu_torch.ops import group_norm_kernel as gnk
    from vae_channel_dynamics_tpu_torch.ops.group_norm import group_norm_reference

    dname = "bf16" if dtype == torch.bfloat16 else "fp32"
    sum_rel = GN_SUM_REL if dtype == torch.bfloat16 else GN_SUM_REL_F32

    def like_x(out, ref, fp32_rel=GN_F32_REL):
        # y or dx, in x's dtype: GN_ULPS bf16 ulps of max|plain| in bf16,
        # fp32_rel of max|plain| (and 1e-5) in fp32
        if dtype == torch.bfloat16:
            return bf16_err(out, ref)
        return max_abs_err(out, ref), fp32_rel * ref.float().abs().max().item() + 1e-5

    b, c, h, w = shape
    x = (torch.randn(shape, generator=gen, device=DEVICE) * 2.0 + 0.5).to(dtype)
    g = torch.randn(shape, generator=gen, device=DEVICE).to(dtype)
    scale = 1.0 + 0.1 * torch.randn(c, generator=gen, device=DEVICE)
    bias = 0.1 * torch.randn(c, generator=gen, device=DEVICE)
    # the per-(sample, channel) coefficients from the plain sums
    sums, sqs = gnk.fwd_reduce_reference(x)
    mean, rstd = gnk._group_stats(sums, sqs, h * w, groups, GN_EPS)
    a, off = gnk._affine_coeffs(mean, rstd, scale, bias, groups)
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
    record("gn_fwd_reduce", max(sum_rel_err(ks, sums), sum_rel_err(kq, sqs)), sum_rel,
           sum_rel_err(fs, sums), "sum x, sum x^2 (rel)",
           max(max_abs_err(ks, sums), max_abs_err(kq, sqs)))
    # 2-3. normalize with SiLU and the |z| tap; faults: b left out of y,
    # |z| taken after the SiLU
    ky, kabs = gnk.fwd_normalize(x, a, off, True, True)
    sync()
    py, pabs = gnk.fwd_normalize_reference(x, a, off, True, True)
    fy, _ = gnk.fwd_normalize_reference(x, a, torch.zeros_like(off), True, False)
    err, bound = like_x(ky, py)
    record("gn_fwd_normalize", err, bound, like_x(fy, py)[0], f"y ({dname})", err)
    z = x.float() * a[:, :, None, None] + off[:, :, None, None]
    fabs = (z * torch.sigmoid(z)).abs().sum(dim=(2, 3))
    del z
    record("gn_fwd_normalize", sum_rel_err(kabs, pabs), sum_rel,
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
    if dtype == torch.bfloat16:
        check(torch.equal(ky0, py0),
              f"gn_fwd_normalize without the SiLU is not bit-equal to plain at {shape}")
        plain_y0 = "bit-equal to plain"
    else:
        # fp32: the kernel may fuse x*a + b into one rounding
        err0, bound0 = like_x(ky0, py0)
        check(err0 <= bound0, f"gn_fwd_normalize without the SiLU disagrees at {shape}: "
                              f"{err0} > {bound0}")
        plain_y0 = f"err {err0:.3g} (bound {bound0:.3g})"
    last = (splits - 1) * gnk.split_chunk(h * w, splits)
    z = x.flatten(2)[:, :, last:].float() * a[:, :, None] + off[:, :, None]
    record("gn_fwd_normalize", sum_rel_err(kabs0, pabs0), sum_rel,
           sum_rel_err(pabs0 - z.abs().sum(dim=2), pabs0),
           f"sum |z| tap without the SiLU (rel; fault: the last of S = {splits} splits' "
           "partial left out)", max_abs_err(kabs0, pabs0))
    lines.append(f"gn_fwd_normalize S = {splits} splits a plane, y and tap bit-equal run "
                 f"to run, y without the SiLU {plain_y0}")
    del z, ky2, kabs2, ky0, kabs0, py0, pabs0
    # 4. bwd reduce; faults: SiLU' left out of g_eff, and the last of
    # its S splits' partials left out (its own split count); the sums
    # bit-equal run to run
    splits = gnk.reduce_splits(b * c, h * w, x.element_size())
    last = (splits - 1) * gnk.split_chunk(h * w, splits)
    kg, kgx = gnk.bwd_reduce(x, g, a, off, True)
    kg2, kgx2 = gnk.bwd_reduce(x, g, a, off, True)
    sync()
    check(torch.equal(kg, kg2) and torch.equal(kgx, kgx2),
          f"gn_bwd_reduce differs between two runs at {shape}")
    pg, pgx = gnk.bwd_reduce_reference(x, g, a, off, True)
    fg, fgx = gnk.bwd_reduce_reference(x, g, a, off, False)
    record("gn_bwd_reduce", max(sum_rel_err(kg, pg), sum_rel_err(kgx, pgx)), sum_rel,
           max(sum_rel_err(fg, pg), sum_rel_err(fgx, pgx)), "sum g_eff, sum g_eff x (rel)",
           max(max_abs_err(kg, pg), max_abs_err(kgx, pgx)))
    if splits > 1:
        lg, lgx = gnk.bwd_reduce_reference(x.flatten(2)[:, :, last:, None],
                                           g.flatten(2)[:, :, last:, None], a, off, True)
        record("gn_bwd_reduce", max(sum_rel_err(kg, pg), sum_rel_err(kgx, pgx)), sum_rel,
               max(sum_rel_err(pg - lg, pg), sum_rel_err(pgx - lgx, pgx)),
               f"sums (rel; fault: the last of S = {splits} splits' partials left out)",
               max(max_abs_err(kg, pg), max_abs_err(kgx, pgx)))
        del lg, lgx
    lines.append(f"gn_bwd_reduce S = {splits} splits a plane, bit-equal run to run")
    del kg2, kgx2
    # 5. bwd dx with the op's own coefficients, each plane split over its
    # own S blocks; faults: SiLU' left out, and the last of the S splits'
    # chunk of every plane left unwritten; dx bit-equal run to run
    n = h * w * (c // groups)
    ca = a
    cb = (-(rstd * rstd) / n).repeat_interleave(c // groups, dim=1).contiguous()
    cc = (0.1 * cb).contiguous()
    splits = gnk.dx_splits(b * c, h * w, x.element_size())
    kdx = gnk.bwd_dx(x, g, a, off, ca, cb, cc, True)
    kdx2 = gnk.bwd_dx(x, g, a, off, ca, cb, cc, True)
    sync()
    check(torch.equal(kdx, kdx2), f"gn_bwd_dx differs between two runs at {shape}")
    pdx = gnk.bwd_dx_reference(x, g, a, off, ca, cb, cc, True)
    fdx = gnk.bwd_dx_reference(x, g, a, off, ca, cb, cc, False)
    err, bound = like_x(kdx, pdx)
    record("gn_bwd_dx", err, bound, like_x(fdx, pdx)[0], f"dx ({dname})", err)
    if splits > 1:
        fdx = pdx.clone()
        fdx.flatten(2)[:, :, (splits - 1) * gnk.split_chunk(h * w, splits):] = 0
        record("gn_bwd_dx", err, bound, like_x(fdx, pdx)[0],
               f"dx ({dname}; fault: the last of S = {splits} splits' chunk left unwritten)",
               err)
    lines.append(f"gn_bwd_dx S = {splits} splits a plane, {gnk.DX_LOADS} loads of x and "
                 "of g in flight a thread, bit-equal run to run")
    del ks, kq, fs, ky, kabs, py, pabs, fy, fabs, kg, kgx, pg, pgx, fg, fgx, kdx, kdx2, pdx
    del fdx

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
        y, _tap = gnk.group_norm_silu_with_stats(xr, sr, br, groups, GN_EPS, silu)
        return y

    def plain_op(xr, sr, br, silu):
        return group_norm_reference(xr, sr, br, groups, GN_EPS, silu)

    ky, kdx, kds, kdb = op_grads(kernel_op)
    _y, ktap = gnk.group_norm_silu_with_stats(x, scale, bias, groups, GN_EPS, True)
    sync()
    py, pdx, pds, pdb = op_grads(plain_op)
    _fy, _fdx, _fds, fdb = op_grads(plain_op, silu=False)
    ptap = gnk.fwd_normalize_reference(x, a, off, True, True)[1].sum(0) / (b * h * w)
    errs = [like_x(ky, py, GN_F32_OP_REL[0]), like_x(kdx, pdx, GN_F32_OP_REL[1])]
    tap_err = sum_rel_err(ktap, ptap)
    ds_err, db_err = sum_rel_err(kds, pds), sum_rel_err(kdb, pdb)
    fault_db = sum_rel_err(fdb, pdb)
    lines.append(f"op: y err {errs[0][0]:.4g} (bound {errs[0][1]:.4g}), mean|z| tap rel "
                 f"{tap_err:.3g}, dx err {errs[1][0]:.4g} (bound {errs[1][1]:.4g}), dgamma "
                 f"rel {ds_err:.3g}, dbeta rel {db_err:.3g} (bound {sum_rel}; SiLU' left "
                 f"out: dbeta rel {fault_db:.3g})")
    check(all(e <= bd for e, bd in errs), f"the GroupNorm op's y or dx disagree at {shape}")
    check(max(tap_err, ds_err, db_err) <= sum_rel,
          f"the GroupNorm op's tap, dgamma or dbeta disagree at {shape}")
    check(fault_db > sum_rel, f"the dbeta bound at {shape} does not reject its fault")
    del ky, kdx, kds, kdb, py, pdx, pds, pdb, fdb, ktap, ptap
    return lines, (x, g, scale, bias, a, off, ca, cb, cc)


def phase_gn_kernels():
    """Each GroupNorm kernel against its plain version on the same inputs,
    then the autograd op against the plain GroupNorm (``_gn_check``), timed,
    at GN_SHAPES in bf16; then the same checks, untimed, at every channel
    block of GN_BLOCK_SHAPES in bf16 and in fp32."""
    import torch

    from vae_channel_dynamics_tpu_torch.ops import group_norm_kernel as gnk
    from vae_channel_dynamics_tpu_torch.ops.group_norm import group_norm_reference

    results = {name: {"max_abs_err": 0.0} for name in gnk.KERNELS}
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    for shape in GN_SHAPES:
        lines, (x, g, scale, bias, a, off, ca, cb, cc) = _gn_check(
            shape, GN_GROUPS, torch.bfloat16, gen, results)
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
        # kernel #3, the normalize with the |z| tap: its own bound (#2's
        # bytes and the (B, C) sums written; 10 operations an element with
        # the tap's abs and add) and library chain (F.group_norm, the tap's
        # per-channel sum of |z|, F.silu)
        elem, bc = x.numel(), shape[0] * shape[1] * 4
        stats_bound = roofline(10 * elem, 2 * elem * x.element_size() + 3 * bc, PEAK_FP32_FLOPS)
        stats_lib = library_group_norm_tap(x, scale, bias)
        if shape == GN_ROW_SHAPE:
            for name, (ms, plain_ms) in times.items():
                bound_ms, bound_by = gn_bound(name, shape, x.element_size())
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
            + f", gn_fwd_normalize with the tap (#3) {stats_ms[0]:.4f}/{stats_ms[1]:.4f} (bound "
            f"{stats_bound[0]:.4f}, {stats_bound[1]}; F.group_norm + |z| sum + F.silu "
            f"{stats_lib:.4f}); "
            f"op forward {fwd[0]:.4f}/{fwd[1]:.4f}, op backward {bwd[0]:.4f}/{bwd[1]:.4f}; "
            f"x is {bytes_x / 1e6:.1f} MB, so the reduce kernel reads at "
            f"{bytes_x / times['gn_fwd_reduce'][0] / 1e6:.0f} GB/s; bounds (gn_bound) "
            + ", ".join(f"{k} {gn_bound(k, shape, x.element_size())[0]:.4f}" for k in GN_OPS)
            + f"; F.group_norm + F.silu forward {lib_fwd:.4f}, backward {lib_bwd:.4f}")
        del x, g, a, off, ca, cb, cc
    t0 = time.perf_counter()
    for dtype in (torch.bfloat16, torch.float32):
        for shape, groups in GN_BLOCK_SHAPES:
            lines, _inputs = _gn_check(shape, groups, dtype, gen, results)
            del _inputs
            log(f"[gn] block {shape}, {groups} groups, {str(dtype)[6:]}: " + "; ".join(lines))
    log(f"[gn] {len(GN_BLOCK_SHAPES)} channel blocks of the tensor runs, bf16 and fp32, each "
        f"kernel and the op within its bound, in {time.perf_counter() - t0:.1f} s")
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


def library_group_norm_tap(x, scale, bias) -> float:
    """CUDA-event ms of kernel #3's function from library calls: z =
    ``F.group_norm(x)``, the per-channel sum of |z| in fp32 and
    ``F.silu(z)``, in x's dtype (the yardstick only)."""
    import torch
    import torch.nn.functional as F

    w, bb = scale.to(x.dtype), bias.to(x.dtype)

    def fwd():
        with torch.no_grad():
            z = F.group_norm(x, GN_GROUPS, w, bb, GN_EPS)
            z.abs().sum(dim=(2, 3), dtype=torch.float32)
            F.silu(z)

    return cuda_ms(fwd, GN_ITERS)


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


def _dw_splits(n, cin, cout, h, w, f32: bool = False) -> int:
    """conv3x3_dw's (``_f32``'s with ``f32``) split count as its wrapper
    chooses it: in bf16 from the clusters this card holds at once (the
    default model off the card); at fp32, whose splits are no cluster, from
    the blocks an H100 holds."""
    from vae_channel_dynamics_tpu_torch.ops import fused_resnet as fr

    on_card = (lambda k: fr.dw_max_clusters(w, k)) if DEVICE == "cuda" and not f32 else None
    return fr.dw_splits(n, cin, cout, h, w, on_card, f32=f32)


def _last_chunk_dropped(dy, n, cin, cout, h, w):
    """dy with the pixels of conv3x3_dw's last pixel chunk zeroed: what a
    kernel that left out its last split would sum (the planted fault of
    #11). Chunk k covers units [k*U//S, (k+1)*U//S) of the U = dw_units
    rows x cols pixel units, in order of (sample, unit row, unit column);
    at fp32 the ``_f32`` kernel's units and splits."""
    import torch

    from vae_channel_dynamics_tpu_torch.ops import fused_resnet as fr

    f32 = dy.dtype == torch.float32
    rows, cols = fr.dw_unit(w, f32)
    units = fr.dw_units(n, h, w, f32)
    per_image, units_w = units // n, w // cols
    splits = _dw_splits(n, cin, cout, h, w, f32)
    out = dy.clone()
    for g in range((splits - 1) * units // splits, units):
        nn_, u = divmod(g, per_image)
        r0, c0 = (u // units_w) * rows, (u % units_w) * cols
        out[nn_, :, r0:r0 + rows, c0:c0 + cols] = 0
    return out


def fused_bounds(n, cin, cout, h, w, f32: bool = False) -> dict:
    """Each fused kernel's bound: 2 N H W 9 Cin Cout FLOPs (three times that
    at the TF32 rate at fp32, 3xTF32), and the bytes of its activations and
    weight (bf16, or fp32) and fp32 vectors, each read or written once (#9
    with the residual and the tap, as the path's conv2 runs it)."""
    size, scale, rate = (4, 3, PEAK_TF32_FLOPS) if f32 else (2, 1, PEAK_BF16_FLOPS)
    flops = scale * 2 * n * h * w * 9 * cin * cout
    act_in, act_out = size * n * cin * h * w, size * n * cout * h * w
    wbytes, vec = size * 9 * cin * cout, 4 * n * cin
    dw_bytes = 4 * 9 * cin * cout
    sfx = "_f32" if f32 else ""
    return {
        "fused_gn_silu_conv3x3" + sfx: roofline(flops, act_in + 2 * act_out + wbytes + 3 * vec
                                                + 4 * cout, rate),
        "conv3x3" + sfx: roofline(flops, act_out + act_in + wbytes, rate),
        "conv3x3_dw" + sfx: roofline(flops, act_in + act_out + 2 * vec + dw_bytes, rate),
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


def f64_errors(out, ref64) -> tuple[float, float]:
    """Max abs and relative L2 error of an fp32 ``out`` against an fp64
    reference."""
    d = out.double() - ref64
    return d.abs().max().item(), (d.norm() / ref64.norm()).item()


def _f64(*tensors):
    return [None if t is None else t.double() for t in tensors]


def phase_fused_kernels():
    """The three fused resnet kernels against their plain versions at
    FUSED_SHAPES, in bf16 and in fp32 (the ``_f32`` kernels), with planted
    faults, CUDA-event times beside their bound and cuDNN's yardstick; then
    the whole fused op (``phase_fused_op``)."""
    import torch
    import torch.nn.functional as F

    from vae_channel_dynamics_tpu_torch.ops import fused_resnet as fr
    from vae_channel_dynamics_tpu_torch.ops import group_norm_kernel as gnk

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    results = {name: {"max_abs_err": 0.0} for name in fr.KERNELS}
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 20)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=DEVICE)

    for dtype in (torch.bfloat16, torch.float32):
        f32 = dtype == torch.float32
        sfx, tag = ("_f32", "fp32") if f32 else ("", "bf16")
        for shape, cout in FUSED_SHAPES:
            n, cin, h, w = shape
            x = (randn(*shape) * 2.0 + 0.5).to(dtype)
            gamma, beta = 1.0 + 0.1 * randn(cin), 0.1 * randn(cin)
            wt = (randn(cout, cin, 3, 3) / math.sqrt(9 * cin)).to(dtype)
            bias = 0.1 * randn(cout)
            res, dy = randn(n, cout, h, w).to(dtype), randn(n, cout, h, w).to(dtype)
            sums, sqs = gnk.fwd_reduce_reference(x)
            mean, rstd = gnk._group_stats(sums, sqs, h * w, GN_GROUPS, GN_EPS)
            a, o = gnk._affine_coeffs(mean, rstd, gamma, beta, GN_GROUPS)
            lines = []

            def held_out(name, what, out, plain, faults):
                """bf16: to plain within FUSED_ULPS bf16 ulps and FUSED_REL_L2;
                fp32: to ``plain`` evaluated in fp64 within FUSED_F32_REL_L2
                (and the fp32 plain's own distance from fp64 logged). Every
                planted fault must break the bound."""
                name += sfx
                if f32:
                    ref64 = plain(_f64)
                    err, rel = f64_errors(out, ref64)
                    bound_abs, bound_rel = math.inf, FUSED_F32_REL_L2
                    plain32 = plain(lambda *t: t)
                    note = (f" (fp32 plain: rel L2 {f64_errors(plain32, ref64)[1]:.3g} from "
                            f"fp64, the kernel {kernel_errors(out, plain32)[1]:.3g} from it)")
                    del plain32
                    fault_errs = [f64_errors(f, ref64) for _fname, f in faults]
                else:
                    ref = plain(lambda *t: t)
                    err, rel = kernel_errors(out, ref)
                    bound_abs = FUSED_ULPS * bf16_ulp(ref.float().abs().max().item())
                    bound_rel, note = FUSED_REL_L2, ""
                    fault_errs = [kernel_errors(f, ref) for _fname, f in faults]
                results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)
                lines.append(f"{what}: max abs {err:.4g}, rel L2 {rel:.3g} (bound {bound_rel})"
                             + note + "; planted faults " + ", ".join(
                                 f"{fname} rel L2 {fe[1]:.3g}"
                                 for (fname, _f), fe in zip(faults, fault_errs)))
                check(err <= bound_abs and rel <= bound_rel,
                      f"{what} disagrees with plain at {shape} -> {cout} {tag}: {err}, {rel}")
                for (fname, _f), (fe, fr_) in zip(faults, fault_errs):
                    check(fe > bound_abs or fr_ > bound_rel,
                          f"the {what} bound at {shape} -> {cout} {tag} does not reject {fname}")

            sum_bound = FUSED_F32_SUM_REL if f32 else FUSED_SUM_REL

            def held_sum(name, what, out, ref, fault):
                name += sfx
                err, fault_err = sum_rel_err(out, ref), sum_rel_err(fault, ref)
                results[name]["max_abs_err"] = max(results[name]["max_abs_err"],
                                                   max_abs_err(out, ref))
                lines.append(f"{what}: rel {err:.3g} (bound {sum_bound}); planted fault "
                             f"{fault_err:.3g}")
                check(err <= sum_bound, f"{what} disagrees with plain at {shape} {tag}: {err}")
                check(fault_err > sum_bound,
                      f"the {what} bound at {shape} {tag} does not reject its planted fault")

            def hi_only(*tensors):
                """The operands of the tensor-core products rounded to their
                TF32 hi, in fp64: the 1xTF32 fault of the fp32 kernels."""
                return [tf32_hi(t).double() for t in tensors]

            # 9: without the residual (conv1), then with it, the tap and the moments
            y0, _, _ = fr.fused_fwd(x, a, o, wt, bias)
            y, tap, (ysum, ysq) = fr.fused_fwd(x, a, o, wt, bias, res, True, True)
            y2, tap2, (ysum2, ysq2) = fr.fused_fwd(x, a, o, wt, bias, res, True, True)
            sync()
            check(all(torch.equal(u, w2) for u, w2 in ((y, y2), (tap, tap2), (ysum, ysum2),
                                                        (ysq, ysq2))),
                  f"#9 differs between two runs at {shape} -> {cout} {tag}")
            del y2, tap2, ysum2, ysq2
            z = x.float() * a[:, :, None, None] + o[:, :, None, None]
            s = (z * torch.sigmoid(z)).to(dtype)
            del z

            def hi_fwd(resid):
                sh, wh = hi_only(s, wt)
                out = F.conv2d(sh, wh, padding=1) + bias.double()[None, :, None, None]
                return out if resid is None else out + resid.double()

            faults0 = [("the border mask skipped",
                        _fused_fwd_unmasked(x, a, o, wt, bias, torch.zeros_like(res)))]
            faults = [("the border mask skipped", _fused_fwd_unmasked(x, a, o, wt, bias, res))]
            if f32:
                faults0.append(("1xTF32", hi_fwd(None)))
                faults.append(("1xTF32", hi_fwd(res)))
            held_out("fused_gn_silu_conv3x3", "#9 y", y0,
                     lambda cast: fr.fused_fwd_reference(*cast(x, a, o, wt, bias))[0], faults0)
            held_out("fused_gn_silu_conv3x3", "#9 y + residual", y,
                     lambda cast: fr.fused_fwd_reference(*cast(x, a, o, wt, bias, res))[0],
                     faults)
            del y0, faults0, faults
            _py, ptap, (psum, psq) = fr.fused_fwd_reference(x, a, o, wt, bias, res, True, True)
            held_sum("fused_gn_silu_conv3x3", "#9 sum |z| tap", tap, ptap,
                     _halo_tap(x, a, o, ptap))
            _, _, (fsum, fsq) = fr.fused_fwd_reference(x, a, o, wt, bias, None, False, True)
            held_sum("fused_gn_silu_conv3x3", "#9 sum y", ysum, psum, fsum)
            held_sum("fused_gn_silu_conv3x3", "#9 sum y^2", ysq, psq, fsq)
            del y, tap, ysum, ysq, _py, ptap, psum, psq, fsum, fsq
            # 10: the backward's ds = conv3x3(dy, w flipped and channel-swapped)
            # (faults: the weight not flipped; dy's last 64-channel K chunk left
            # out; at fp32 the lo products left out)
            wf = fr.flipped_weight(wt)
            ds = fr.conv3x3(dy, wf)
            ds2 = fr.conv3x3(dy, wf)
            sync()
            check(torch.equal(ds, ds2), f"#10 ds differs between two runs at {shape} {tag}")
            dy_short = dy.clone()
            dy_short[:, -64:] = 0
            faults = [("the weight not flipped", fr.conv3x3_reference(dy, wt.transpose(0, 1))),
                      ("the last K chunk", fr.conv3x3_reference(dy_short, wf))]
            if f32:
                faults.append(("1xTF32", F.conv2d(*hi_only(dy, wf), padding=1)))
            held_out("conv3x3", "#10 ds", ds, lambda cast: fr.conv3x3_reference(*cast(dy, wf)),
                     faults)
            del ds, ds2, dy_short, faults
            # 11: dW, s recomputed from x
            dw = fr.conv_dw(x, a, o, dy)
            dw2 = fr.conv_dw(x, a, o, dy)
            sync()
            check(torch.equal(dw, dw2), f"#11 dW differs between two runs at {shape} {tag}")
            faults = [("the last pixel chunk", fr.conv_dw_reference(
                x, a, o, _last_chunk_dropped(dy, n, cin, cout, h, w)))]
            if f32:
                faults.append(("1xTF32", torch.nn.grad.conv2d_weight(
                    hi_only(s)[0], tuple(wt.shape), hi_only(dy)[0], padding=1)))
                held_out("conv3x3_dw", "#11 dW", dw,
                         lambda cast: fr.conv_dw_reference(*cast(x, a, o, dy)), faults)
            else:
                held_sum("conv3x3_dw", "#11 dW", dw, fr.conv_dw_reference(x, a, o, dy),
                         faults[0][1])
            del dw, dw2, faults
            release()

            # times, in turns: plain, kernel, kernel, plain; the library
            # yardsticks (cuDNN, TF32 off at fp32) on the pre-normalised input s
            bias_t = bias.to(dtype)
            times = {
                "fused_gn_silu_conv3x3": timed_pair(
                    lambda: fr.fused_fwd(x, a, o, wt, bias, res, True),
                    lambda: fr.fused_fwd_reference(x, a, o, wt, bias, res, True), FUSED_ITERS),
                "conv3x3": timed_pair(lambda: fr.conv3x3(dy, wf),
                                      lambda: fr.conv3x3_reference(dy, wf), FUSED_ITERS),
                "conv3x3_dw": timed_pair(lambda: fr.conv_dw(x, a, o, dy),
                                         lambda: fr.conv_dw_reference(x, a, o, dy),
                                         FUSED_ITERS),
            }
            library = {
                "fused_gn_silu_conv3x3": (
                    cuda_ms(lambda: F.conv2d(s, wt, bias_t, padding=1), FUSED_ITERS),
                    "F.conv2d on the pre-normalised input (the conv alone)"),
                "conv3x3": (cuda_ms(lambda: torch.nn.grad.conv2d_input(x.shape, wt, dy,
                                                                       padding=1),
                                    FUSED_ITERS), "torch.nn.grad.conv2d_input"),
                "conv3x3_dw": (cuda_ms(lambda: torch.nn.grad.conv2d_weight(s, wt.shape, dy,
                                                                           padding=1),
                                       FUSED_ITERS),
                               "torch.nn.grad.conv2d_weight on the pre-normalised input"),
            }
            if f32:
                for name, (ms, covers) in library.items():
                    library[name] = (ms, covers + ", fp32 with TF32 off")
            # where #10's time goes: the weight copies, the NHWC copy of dy (the
            # pre-pass in its identity mode) and the loop; and #11's: its
            # pre-passes (s, and dy's split at fp32) against its loop
            for what, call in (("#10", lambda: fr.conv3x3(dy, wf)),
                               ("#11", lambda: fr.conv_dw(x, a, o, dy))):
                by_kernel = device_ms_by_kernel(call, FUSED_ITERS)
                lines.append(f"{what} device ms a call by kernel (torch.profiler): " + (
                    ", ".join(f"{k[:60]} {v:.4f}" for k, v in sorted(
                        by_kernel.items(), key=lambda kv: -kv[1])) or "not measured off the card"))
            bounds = fused_bounds(n, cin, cout, h, w, f32)
            if (shape, cout) == FUSED_SHAPES[0]:
                for name in fr.BF16_KERNELS:
                    results[name + sfx].update(
                        shape=[*shape, cout], ms=times[name][0], plain_ms=times[name][1],
                        bound_ms=bounds[name + sfx][0], bound_by=bounds[name + sfx][1],
                        library_ms=library[name][0], library_covers=library[name][1])
            lines.append("#9, #10 and #11 bit-equal run to run")
            splits = _dw_splits(n, cin, cout, h, w, f32)
            if f32:
                how = "independent blocks, their partials added in order"
            else:
                held = ([fr.dw_max_clusters(w, k) for k in range(1, fr.DW_MAX_SPLITS + 1)]
                        if DEVICE == "cuda" else "not queried off the card")
                how = f"clusters of 1-{fr.DW_MAX_SPLITS} blocks the card holds at once: {held}"
            lines.append(f"#11 splits {splits}, grid {fr.dw_grid(cin, cout, splits, f32)} ({how})")
            log(f"[fused] {shape} -> {cout} {tag}: " + "; ".join(lines))
            log(f"[fused] {shape} -> {cout} {tag} ms kernel/plain/bound/library (CUDA events, "
                f"{FUSED_ITERS} calls, in turns): " + ", ".join(
                    f"{name}{sfx} {times[name][0]:.4f}/{times[name][1]:.4f}/"
                    f"{bounds[name + sfx][0]:.4f}/{library[name][0]:.4f} "
                    f"({100 * bounds[name + sfx][0] / times[name][0]:.1f}% of bound, "
                    f"{bounds[name + sfx][1]})" for name in fr.BF16_KERNELS))
            del x, res, dy, s, wf, a, o
            release()
    f32_launches = phase_fused_op()
    for name, count in f32_launches.items():
        results[name]["launches"] = count
    return results


def _plain_op64(x, gamma, beta, w, bias, res):
    """conv3x3(silu(group_norm(x))) + bias + res in fp64: the fp32 op's
    reference."""
    import torch
    import torch.nn.functional as F

    z = F.group_norm(x, GN_GROUPS, gamma, beta, GN_EPS)
    return F.conv2d(z * torch.sigmoid(z), w, padding=1) + bias[None, :, None, None] + res


def phase_fused_op() -> dict:
    """The fused op (kernel #1, then #9; backward #10, #11, #4, #5): in fp32
    first, this slice's path (the op's entry at the 256px fused path's
    shape, forward and backward, every launch counter reset before and read
    after), against plain autograd in fp64; then in bf16 and in fp32 against
    the unfused sequence it replaces (the pallas GroupNorm kernels with
    SiLU, cuDNN's conv, the residual add), forward and forward+backward, at
    FUSED_OP_SHAPES (fp32 at the first), C -> C channels. Returns the fp32
    kernels' launches on the path."""
    import torch
    import torch.nn.functional as F

    from vae_channel_dynamics_tpu_torch.ops import flash_attention as fa
    from vae_channel_dynamics_tpu_torch.ops import fused_resnet as fr
    from vae_channel_dynamics_tpu_torch.ops import group_norm_kernel as gnk

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 21)

    def make(shape, dtype):
        c = shape[1]
        x = torch.randn(shape, generator=gen, device=DEVICE).to(dtype)
        res = torch.randn(shape, generator=gen, device=DEVICE).to(dtype)
        dy = torch.randn(shape, generator=gen, device=DEVICE).to(dtype)
        gamma = 1.0 + 0.1 * torch.randn(c, generator=gen, device=DEVICE)
        beta = 0.1 * torch.randn(c, generator=gen, device=DEVICE)
        wt = torch.randn((c, c, 3, 3), generator=gen, device=DEVICE) / math.sqrt(9 * c)
        bias = 0.1 * torch.randn(c, generator=gen, device=DEVICE)
        return (x, gamma, beta, wt, bias, res), dy

    def fused(xx, gg, bb, ww, bi, rr):
        return fr.gn_silu_conv3x3(xx, gg, bb, ww, bi, num_groups=GN_GROUPS, eps=GN_EPS,
                                  residual=rr)[0]

    # ---- the path: the op at fp32, counts reset, the run, counts read ----
    (x, gamma, beta, wt, bias, res), dy = make(FUSED_OP_SHAPES[0], torch.float32)
    leaves = [t.detach().requires_grad_(True) for t in (x, gamma, beta, wt, bias, res)]
    sync()
    for counts in (fa.launches, gnk.launches, fr.launches):
        for name in counts:
            counts[name] = 0
    y = fused(*leaves)
    got = [y.detach()] + list(torch.autograd.grad(y, leaves, dy))
    sync()
    launches = {**fa.launches, **gnk.launches, **fr.launches}
    f32_names = [name + "_f32" for name in fr.BF16_KERNELS]
    want = {name: int(name in f32_names) for name in (*fa.launches, *fr.launches)}
    want.update({"gn_fwd_reduce": 1, "gn_fwd_normalize": 0, "gn_bwd_reduce": 1, "gn_bwd_dx": 1})
    log(f"[fused-op] fp32 path {FUSED_OP_SHAPES[0]}: launches {launches}")
    check(launches == want, f"the fp32 op launched {launches}, want {want}")
    leaves64 = [t.detach().double().requires_grad_(True) for t in leaves]
    y64 = _plain_op64(*leaves64)
    want_grads = [y64.detach()] + list(torch.autograd.grad(y64, leaves64, dy.double()))
    rows = []
    for name, g, p in zip(("y", "dx", "dgamma", "dbeta", "dW", "db", "dres"), got, want_grads):
        err, rel = f64_errors(g, p)
        rows.append(f"{name} rel L2 {rel:.3g}")
        check(g.dtype == torch.float32 and rel <= FUSED_F32_REL_L2,
              f"the fp32 op's {name} is {rel} (rel L2) from plain autograd in fp64")
    log("[fused-op] fp32 op against plain autograd in fp64 (bound "
        f"{FUSED_F32_REL_L2}): " + ", ".join(rows))
    del x, res, dy, leaves, leaves64, y, y64, got, want_grads
    release()

    # ---- against the unfused sequence, timed ----
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for shape in FUSED_OP_SHAPES[:1] if dtype == torch.float32 else FUSED_OP_SHAPES:
            (x, gamma, beta, wt, bias, res), dy = make(shape, dtype)
            leaves = [t.detach().requires_grad_(True) for t in (x, gamma, beta, wt, bias, res)]

            def unfused(xx, gg, bb, ww, bi, rr):
                s = gnk.group_norm_silu(xx, gg, bb, GN_GROUPS, GN_EPS, True)
                return F.conv2d(s, ww.to(xx.dtype), bi.to(xx.dtype), padding=1) + rr

            with torch.no_grad():
                yf, yu = fused(*leaves), unfused(*leaves)
            _err, rel = kernel_errors(yf, yu)
            bound = FUSED_REL_L2 if dtype == torch.bfloat16 else FUSED_F32_REL_L2
            check(rel <= bound, f"the fused op is {rel} (rel L2) from the unfused at {shape}")

            def forward(op):
                def run():
                    with torch.no_grad():
                        op(*leaves)
                return run

            def forward_backward(op):
                return lambda: torch.autograd.grad(op(*leaves), leaves, dy)

            fwd = timed_pair(forward(fused), forward(unfused), FUSED_ITERS)
            both = timed_pair(forward_backward(fused), forward_backward(unfused), FUSED_ITERS)
            rows.append(f"{shape} {'bf16' if dtype == torch.bfloat16 else 'fp32'}: forward "
                        f"{fwd[0]:.4f} vs {fwd[1]:.4f} ({fwd[1] / fwd[0]:.2f}x), "
                        f"forward+backward {both[0]:.4f} vs {both[1]:.4f} "
                        f"({both[1] / both[0]:.2f}x); rel L2 {rel:.3g}")
            del x, res, dy, leaves, yf, yu
            release()
    log(f"[fused-op] C -> C channels with the residual, ms fused vs unfused "
        f"(pallas GroupNorm + SiLU, cuDNN conv with TF32 off, add; CUDA events, "
        f"{FUSED_ITERS} calls, in turns): " + "; ".join(rows))
    return {name: launches[name] for name in f32_names}


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
    """Device time of one step by kernel family (``tools/profile_summary.py``'s
    families), from torch.profiler."""
    from torch.autograd import DeviceType

    from vae_channel_dynamics_tpu_torch.tools.profile_summary import family

    totals, per_kernel = {}, []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = _self_device_us(evt)
        name = evt.key
        per_kernel.append((us, name, evt.count))
        fam = family(name)
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
    want = {name: fused_convs * (name in fr.BF16_KERNELS) for name in fr.KERNELS}
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
    # the config's own profiling window (from step 20) holds the last step
    from vae_channel_dynamics_tpu_torch.tools import profile_summary as ps

    prof = cfg["profiling"]
    families = read_trace_families(os.path.join(run_dir, prof.get("output_subdir", "profile")),
                                   "fused-trainer")
    check(families.get(ps.FUSED_RESNET, (0, 0))[1] > 0,
          f"the fused Trainer's trace holds no fused resnet kernel: {families}")
    return {"launches": launches}


def read_trace_families(trace_dir: str, tag: str) -> dict:
    """{family: (device ms, launches)} of the newest trace under
    ``trace_dir``, read by ``tools/profile_summary.py``, whose summary is
    logged; the trace must hold device events."""
    from vae_channel_dynamics_tpu_torch.tools import profile_summary as ps

    path = ps.find_trace(trace_dir)
    device = ps.device_events(ps.load_trace(path))
    check(len(device) > 0, f"{path} holds no device events")
    for line in ps.summarize(trace_dir, top_n=8, path=path).splitlines():
        log(f"[{tag}] profile_summary: {line}")
    return {fam: (us / 1e3, n) for fam, us, n in ps.family_table(device)}


def phase_adafactor_trainer(tmp: str) -> None:
    """``configs/bench_adafactor_256px.yaml`` through ``train.main`` with
    ``kernel_impl: pallas``, against the same config with ``adamw``, in turns
    (ADAFACTOR_ORDER); see the module docstring (7''')."""
    import copy
    import logging

    import torch
    import yaml

    from vae_channel_dynamics_tpu_torch import train as train_cli
    from vae_channel_dynamics_tpu_torch.tools import profile_summary as ps
    from vae_channel_dynamics_tpu_torch.training import loop
    from vae_channel_dynamics_tpu_torch.training import step as step_mod
    from vae_channel_dynamics_tpu_torch.utils.config_utils import load_config

    root = os.path.dirname(os.path.abspath(__file__))
    base = load_config(os.path.join(root, ADAFACTOR_CONFIG))
    check(base["training"]["optimizer"] == "adafactor", f"{ADAFACTOR_CONFIG} is not adafactor")
    res, batch = int(base["data"]["resolution"]), int(base["data"]["batch_size"])
    timed = ADAFACTOR_PROFILE_START - 1 - ADAFACTOR_WARMUP
    log(f"[adafactor] {ADAFACTOR_CONFIG} with kernel_impl pallas, {res}px batch {batch}, "
        f"{ADAFACTOR_STEPS} steps a run, runs {ADAFACTOR_ORDER}: steps "
        f"{ADAFACTOR_WARMUP + 1}-{ADAFACTOR_PROFILE_START - 1} timed (host clock, "
        f"synchronised), steps {ADAFACTOR_PROFILE_START}-{ADAFACTOR_STEPS} of run "
        f"{ADAFACTOR_PROFILED_RUN} profiled by the config's profiling section")

    # per-step losses and the synchronised host clock around the timed steps,
    # through a wrapper on the Trainer's steps
    losses, marks, current = {}, {}, {}
    make_train_step = loop.make_train_step
    update = step_mod._Optimizer.update
    # per run: (host seconds, start event, end event) of each timed update
    updates: dict = {}

    def timed_update(self, *a, **kw):
        if not current.get("timing"):
            return update(self, *a, **kw)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = update(self, *a, **kw)
        end.record()
        updates.setdefault(current["run"], []).append((time.perf_counter() - t0, start, end))
        return out

    def timed_make_train_step(*args, **kwargs):
        step_fn = make_train_step(*args, **kwargs)

        def step(state, *a, **kw):
            if state.step == ADAFACTOR_WARMUP:
                sync()
                marks[(current["run"], "start")] = time.perf_counter()
            current["timing"] = ADAFACTOR_WARMUP <= state.step < ADAFACTOR_PROFILE_START - 1
            out = step_fn(state, *a, **kw)
            current["timing"] = False
            losses[(current["run"], out[0].step)] = out[1]["train_loss_step"]
            if out[0].step == ADAFACTOR_PROFILE_START - 1:
                sync()
                marks[(current["run"], "end")] = time.perf_counter()
            return out

        return step

    results, families = {}, {}
    package_logger = logging.getLogger("vae_channel_dynamics_tpu_torch")
    level = package_logger.level
    package_logger.setLevel(logging.WARNING)
    loop.make_train_step = timed_make_train_step
    step_mod._Optimizer.update = timed_update
    try:
        for i, opt in enumerate(ADAFACTOR_ORDER):
            run = f"{opt}_{i}"
            cfg = copy.deepcopy(base)
            cfg["output_dir"] = os.path.join(tmp, run)
            cfg["model"].update(kernel_impl="pallas")
            cfg["training"].update(optimizer=opt, stop_after_steps=ADAFACTOR_STEPS)
            cfg["profiling"] = {"enabled": i == ADAFACTOR_PROFILED_RUN,
                                "start_step": ADAFACTOR_PROFILE_START,
                                "num_steps": ADAFACTOR_STEPS - ADAFACTOR_PROFILE_START}
            path = os.path.join(tmp, f"{run}.yaml")
            with open(path, "w") as f:
                yaml.safe_dump(cfg, f)
            current["run"] = run
            sync()
            reset_peak()
            check(train_cli.main(["--config_path", path, "--device", DEVICE]) == 0,
                  f"the {run} Trainer run failed")
            peak = peak_gb()
            run_dir = os.path.join(cfg["output_dir"], cfg["run_name"])
            saved = torch.load(os.path.join(run_dir, "final_model", "state", "train_state.pt"),
                               map_location="cpu", weights_only=True)["opt"]
            state_bytes = sum(t.numel() * t.element_size()
                              for name, values in saved.items()
                              if isinstance(values, list) and name != "acc_grads"
                              for t in values if t is not None)
            ms = (marks[(run, "end")] - marks[(run, "start")]) / timed * 1e3
            timed_updates = updates.pop(run)
            check(len(timed_updates) == timed, f"{run}: {len(timed_updates)} updates timed")
            host_ms = sum(u[0] for u in timed_updates) / timed * 1e3
            span_ms = sum(u[1].elapsed_time(u[2]) for u in timed_updates) / timed
            results.setdefault(opt, []).append((ms, peak, state_bytes, saved["kind"],
                                                host_ms, span_ms))
            if i == ADAFACTOR_PROFILED_RUN:
                families = read_trace_families(os.path.join(run_dir, "profile"), "adafactor")
            del saved
            shutil.rmtree(cfg["output_dir"], ignore_errors=True)
            release()
    finally:
        loop.make_train_step = make_train_step
        step_mod._Optimizer.update = update
        package_logger.setLevel(level)
    values = torch.stack([v.float() for v in losses.values()]).cpu()
    check(len(losses) == ADAFACTOR_STEPS * len(ADAFACTOR_ORDER)
          and bool(values.isfinite().all()),
          f"{len(losses)} losses, finite: {values.isfinite().tolist()}")
    for opt, rows in results.items():
        ms = [r[0] for r in rows]
        log(f"[adafactor] {opt} ({rows[0][3]}): {sum(ms) / len(ms):.2f} ms/step over steps "
            f"{ADAFACTOR_WARMUP + 1}-{ADAFACTOR_PROFILE_START - 1} "
            f"({', '.join(f'{t:.2f}' for t in ms)} a run; "
            f"{batch * len(ms) * 1e3 / sum(ms):.2f} img/s), peak device memory "
            f"{max(r[1] for r in rows):.2f} GB, optimizer state {rows[0][2]} bytes; "
            f"the update a step: host {', '.join(f'{r[4]:.4f}' for r in rows)} ms, "
            f"device span {', '.join(f'{r[5]:.4f}' for r in rows)} ms a run")
    check(all(r[3] == "FactoredState" for r in results["adafactor"])
          and results["adafactor"][0][2] < results["adamw"][0][2] / 10,
          f"the Adafactor runs' state: {results['adafactor']}")
    log(f"[adafactor] losses of the {len(losses)} steps all finite; adafactor/adamw ms/step "
        f"{sum(r[0] for r in results['adafactor']) / sum(r[0] for r in results['adamw']):.4f}")
    mean = {opt: [sum(r[k] for r in rows) / len(rows) for k in (0, 4, 5)]
            for opt, rows in results.items()}
    log(f"[adafactor] adafactor - adamw a step: {mean['adafactor'][0] - mean['adamw'][0]:.4f} "
        f"ms/step, the update's host time {mean['adafactor'][1] - mean['adamw'][1]:.4f} ms, "
        f"its device span {mean['adafactor'][2] - mean['adamw'][2]:.4f} ms")
    for fam in (ps.GROUPNORM, ps.CUDNN_CONVS):
        check(families.get(fam, (0, 0))[1] > 0,
              f"the profiled Adafactor steps' trace holds no {fam}: {families}")


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
                bounds = {}
                recorder = launch_bounds(bounds)
                recorder.__enter__()
                prof.__enter__()
                t0 = time.perf_counter()
            out = step_fn(state, *a, **kw)
            if profiled:
                sync()
                wall_ms = (time.perf_counter() - t0) * 1e3
                prof.__exit__(None, None, None)
                recorder.__exit__(None, None, None)
                log(f"[profile] step {TRAINER_PROFILE_STEP} of the 1024px Trainer run "
                    "(flash, pallas, remat full), inside the Trainer:")
                _profile_breakdown(prof, wall_ms)
                kernel_losses(prof, bounds, TRAINER_STEPS)
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
    want = {**dict.fromkeys(fa.KERNELS, 0),
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


def phase_trainer_1024_f32(tmp: str, model_dir: str) -> dict:
    """fp32 training through flash on the card: the 1024px Trainer config at
    ``mixed_precision: no`` with ``attention_impl: flash``, ``kernel_impl:
    pallas`` and its ``remat: full``, TRAINER_F32_STEPS steps through
    ``train.main`` from the planted model dir. Each step launches the three
    fp32 flash kernels as often as the bf16 run launches their bf16 twins,
    no bf16 flash kernel, and the GroupNorm kernels as the bf16 run does;
    its losses are finite."""
    import logging

    import yaml

    from vae_channel_dynamics_tpu_torch import train as train_cli
    from vae_channel_dynamics_tpu_torch.ops import flash_attention as fa
    from vae_channel_dynamics_tpu_torch.ops import group_norm_kernel as gnk
    from vae_channel_dynamics_tpu_torch.utils.config_utils import load_config

    root = os.path.dirname(os.path.abspath(__file__))
    cfg = load_config(os.path.join(root, TRAINER_CONFIG))
    cfg["model"].update(attention_impl="flash", kernel_impl="pallas",
                        pretrained_vae_name=model_dir)
    cfg["training"].update(mixed_precision="no", stop_after_steps=TRAINER_F32_STEPS)
    cfg["saving"]["save_interval_steps"] = 10 * TRAINER_F32_STEPS
    cfg["logging"]["log_interval"] = 1
    cfg["output_dir"] = os.path.join(tmp, "fp32")
    cfg_path = os.path.join(tmp, "fp32.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    package_logger = logging.getLogger("vae_channel_dynamics_tpu_torch")
    level = package_logger.level
    package_logger.setLevel(logging.WARNING)
    try:
        # ---- the main path of the fp32 kernels: counts reset, the run, counts read ----
        sync()
        reset_peak()
        for counts in (fa.launches, gnk.launches):
            for name in counts:
                counts[name] = 0
        t0 = time.perf_counter()
        check(train_cli.main(["--config_path", cfg_path, "--device", DEVICE]) == 0,
              "the fp32 flash Trainer run failed")
        sync()
        wall = time.perf_counter() - t0
        launches = {**fa.launches, **gnk.launches}
        peak = peak_gb()
    finally:
        package_logger.setLevel(level)
    per_step = {k: v / TRAINER_F32_STEPS for k, v in launches.items()}
    want = {**dict.fromkeys(fa.KERNELS, 0), **dict.fromkeys(F32_NOTES, SDXL_ATTENTIONS),
            "gn_fwd_reduce": SDXL_NORMS + SDXL_RESNET_NORMS,
            "gn_fwd_normalize": SDXL_NORMS + SDXL_RESNET_NORMS,
            "gn_bwd_reduce": SDXL_NORMS, "gn_bwd_dx": SDXL_NORMS}
    check(per_step == want, f"fp32 launches per step {per_step}, want {want}")
    with open(os.path.join(cfg["output_dir"], cfg["run_name"], "metrics.jsonl")) as f:
        steps = {r["step"]: r for r in map(json.loads, f) if "train_loss_step" in r}
    check(sorted(steps) == list(range(1, TRAINER_F32_STEPS + 1)), f"fp32 steps {sorted(steps)}")
    losses = [steps[s]["train_loss_step"] for s in sorted(steps)]
    check(all(math.isfinite(x) for x in losses), f"fp32 losses {losses}")
    log(f"[trainer-fp32] {TRAINER_CONFIG} at mixed_precision no, attention_impl flash, "
        f"kernel_impl pallas, remat {cfg['model']['remat']}: {TRAINER_F32_STEPS} steps through "
        f"train.main in {wall:.1f} s (model load and final model included), losses {losses}, "
        f"grad_norm {[steps[s]['grad_norm'] for s in sorted(steps)]}; launches {launches}; "
        f"peak device memory {peak:.2f} GB")
    shutil.rmtree(cfg["output_dir"], ignore_errors=True)
    release()
    return {"launches": launches}


def phase_flash_step_1024(model_dir: str):
    """One 1024px step with flash attention against one with naive, from the
    same weights, batch and noise (remat none), held to naive bf16 against
    naive fp32; then timed steps of both in turns and a profile of a flash
    step. See the module docstring (9)."""
    import numpy as np
    import torch

    from vae_channel_dynamics_tpu_torch.models import AutoencoderKL
    from vae_channel_dynamics_tpu_torch.models import io as model_io
    from vae_channel_dynamics_tpu_torch.ops import flash_attention as fa
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
    # remat: conv against none also on the rematerialised resnets' parameters
    remat_names = names + REMAT_GRADS

    class GradCapture:
        """Stands in for the optimizer: keeps the named gradients and
        updates nothing."""

        grads = {}

        def init(self, params):
            return None

        def update(self, grads, opt_state, params):
            self.grads = {n: grads[n].float().clone() for n in remat_names}
            return False

    def one_step(impl, dtype, remat="none"):
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        set_attention(model, impl).set_remat(remat).set_compute_dtype(dtype)
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
    before = dict(fa.launches)
    runs["flash fp32"] = one_step("flash", torch.float32)
    f32_counts = {name: fa.launches[name] - before[name] for name in fa.KERNELS}
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
    # fp32 training through flash: the fp32 kernels, against naive fp32
    f32 = runs["flash fp32"]
    check(f32_counts == {name: SDXL_ATTENTIONS * (name in F32_NOTES) for name in fa.KERNELS},
          f"the fp32 flash step launched {f32_counts}")
    rows = []
    for key in ["loss", "grad_norm", *names]:
        d = rel(f32[key], c[key])
        rows.append(f"{key} {d:.3g}")
        check(d <= STEP_F32_REL, f"1024px fp32 step {key}: flash is {d} from naive (bound "
                                 f"{STEP_F32_REL})")
    log(f"[flash-step] 1024px step, flash fp32 vs naive fp32 (TF32 off), relative (rel L2 for "
        f"the attention gradients), bound {STEP_F32_REL}; launches {f32_counts}: "
        + "; ".join(rows))
    del runs, f, n, c, f32
    remat_conv_step(one_step, remat_names)

    # timed steps with AdamW from the same weights, in turns
    set_attention(model, "flash").set_compute_dtype(torch.bfloat16)
    tx, _ = build_optimizer(TRAIN_LR, TRAIN_WARMUP, 10_000, max_grad_norm=TRAIN_CLIP)
    state = TrainState.create(model, tx)
    step = make_train_step(model, tx, TRAIN_KL)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 6)
    peaks = {}

    # the paths: attention impl, remat and compute dtype; "flash+remat" is
    # the Trainer slice's step, here without the Trainer around it
    bf16, fp32 = torch.bfloat16, torch.float32
    paths = {"naive": ("naive", "none", bf16), "flash": ("flash", "none", bf16),
             "flash+remat": ("flash", "full", bf16), "flash+conv": ("flash", "conv", bf16),
             "naive fp32": ("naive", "none", fp32), "naive fp32+remat": ("naive", "full", fp32),
             "flash fp32": ("flash", "none", fp32), "flash fp32+remat": ("flash", "full", fp32)}

    def block(path, steps):
        impl, remat, dtype = paths[path]
        set_attention(model, impl).set_remat(remat).set_compute_dtype(dtype)
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
    order = ("naive", "flash", "flash+remat", "flash+conv", "flash+conv", "flash+remat",
             "flash", "naive",
             "naive fp32", "flash fp32", "naive fp32+remat", "flash fp32+remat",
             "flash fp32+remat", "naive fp32+remat", "flash fp32", "naive fp32")
    times = {}
    for path in order:
        times.setdefault(path, []).append(block(path, FLASH_TIMED_STEPS))
    log(f"[flash-step] 1024px batch 1 train step, {2 * FLASH_TIMED_STEPS} steps of each path "
        f"in turns {order}: " + "; ".join(
            f"{path} {sum(t) / 2:.2f} ms/step [{t[0]:.2f}, {t[1]:.2f}] "
            f"({2e3 / sum(t):.4f} img/s), peak device memory {peaks[path]:.2f} GB"
            for path, t in times.items()))

    set_attention(model, "flash").set_remat("none").set_compute_dtype(bf16)
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
    fused_block_under_conv()


def remat_conv_step(one_step, keys) -> None:
    """``remat: conv`` on the 1024px flash step against ``none`` and
    ``full`` (bf16, the same weights, batch and noise): the loss, grad_norm
    and ``keys``' gradients within ``none``'s own run-to-run spread, as many
    conv forwards executed (``aten::_convolution``, cuDNN's on the card: a
    kept output is not computed again) as ``none`` and fewer than ``full``,
    as many GroupNorm forward kernels as ``full``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vae_channel_dynamics_tpu_torch.ops import group_norm_kernel as gnk

    forward = ("gn_fwd_reduce", "gn_fwd_normalize")
    runs, counts = {}, {}
    for run, remat in (("none", "none"), ("none again", "none"), ("conv", "conv"),
                       ("full", "full")):
        before = dict(gnk.launches)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            runs[run] = one_step("flash", torch.bfloat16, remat)
        convs = sum(e.count for e in prof.key_averages() if e.key == "aten::_convolution")
        counts[run] = {"conv forwards": convs,
                       **{k: gnk.launches[k] - before[k] for k in forward}}

    def rel(a, b):
        if isinstance(a, float):
            return abs(a - b) / abs(b)
        return ((a - b).norm() / b.norm()).item()

    rows = []
    none, again, conv = runs["none"], runs["none again"], runs["conv"]
    for key in ["loss", "grad_norm", *keys]:
        d, spread = rel(conv[key], none[key]), rel(again[key], none[key])
        rows.append(f"{key} {d:.3g} (spread {spread:.3g})")
        check(d <= STEP_CONTROL_RATIO * spread,
              f"remat conv {key}: {d} from none, whose own run-to-run spread is {spread}")
    log(f"[remat-conv] 1024px flash step, bf16, remat conv vs none (relative; rel L2 for "
        f"gradients), bound {STEP_CONTROL_RATIO} x none's run-to-run spread: "
        + "; ".join(rows))
    log(f"[remat-conv] launches a step: {counts}")
    check(counts["conv"]["conv forwards"] == counts["none"]["conv forwards"]
          < counts["full"]["conv forwards"],
          f"remat conv ran other conv forwards than none: {counts}")
    check(all(counts["conv"][k] == counts["full"][k] > counts["none"][k] for k in forward),
          f"remat conv launched other GroupNorm forwards than full: {counts}")


def fused_block_under_conv() -> None:
    """A fused block at the 256px fused path's shape, (16, 512, 32, 32),
    bf16, forward and backward under ``remat`` none, conv and full: #9
    launches as often under conv as under none (a checkpoint of the fused
    body would launch it again), and the gradients are the same."""
    import torch

    from vae_channel_dynamics_tpu_torch.models import vae as tvae
    from vae_channel_dynamics_tpu_torch.ops import fused_resnet as fr

    n, c, h, w = FUSED_SHAPES[0][0]
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 30)
    x = torch.randn((n, c, h, w), generator=gen, device=DEVICE).to(torch.bfloat16)
    blk = tvae.ResnetBlock2D(c, c, GN_GROUPS, GN_EPS, device=DEVICE)
    with torch.no_grad():
        for m in blk.modules():
            if isinstance(m, (tvae.Conv2d, tvae.GroupNorm)):
                m.init_weights(gen)
            if isinstance(m, tvae.Conv2d):
                m.compute_dtype = torch.bfloat16
    blk.impl = "fused"
    runs = {}
    for remat in ("none", "conv", "full"):
        blk.remat = remat
        blk.zero_grad(set_to_none=True)
        xr = x.clone().requires_grad_(True)
        before = dict(fr.launches)
        torch.mean(torch.square(blk(xr).float())).backward()
        sync()
        runs[remat] = ({k: fr.launches[k] - before[k] for k in fr.KERNELS},
                       [xr.grad] + [p.grad.clone() for p in blk.parameters()])
    log(f"[remat-conv] a fused block at {(n, c, h, w)}, forward and backward, launches: "
        + "; ".join(f"{remat} {counts}" for remat, (counts, _g) in runs.items()))
    check(runs["conv"][0] == runs["none"][0]
          and runs["conv"][0]["fused_gn_silu_conv3x3"] == 2
          and runs["full"][0]["fused_gn_silu_conv3x3"] == 4,
          f"the fused block under conv launched {runs['conv'][0]}, under none "
          f"{runs['none'][0]}")
    check(all(torch.equal(a, b) for a, b in zip(runs["conv"][1], runs["none"][1])),
          "the fused block's gradients under conv differ from none's")
    del blk, x, runs
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
    """The first SDPA backend that runs an fp32 forward at q's head dim, and
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
            log(f"[sdpa] {backend.name} refuses fp32 at head dim {q.shape[-1]}: "
                f"{str(e).splitlines()[0][:120]}")
            continue
        with sdpa_kernel([backend]), torch.no_grad():
            return backend.name, cuda_ms(
                lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=scale), iters)
    raise SmokeFailure(f"no SDPA backend runs fp32 at head dim {q.shape[-1]}")


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


def _audit_want(kind: str, precision: str, kernel: str, attention: str, fused: int) -> dict:
    """The launches a cell of the audit must show: each kernel of an impl
    the cell names, by its count; every other kernel none. ``fused`` is the
    resnets the fused gate admitted in the run."""
    from vae_channel_dynamics_tpu_torch.ops import flash_attention as fa
    from vae_channel_dynamics_tpu_torch.ops import fused_resnet as fr
    from vae_channel_dynamics_tpu_torch.ops import group_norm_kernel as gnk

    want = {name: 0 for name in (*fa.launches, *gnk.launches, *fr.launches)}
    train = kind == "train"
    forwards = AUDIT_STEPS if train else AUDIT_EVAL_IMAGES // AUDIT_BATCH
    if attention == "flash":
        names = (("flash_attention_fwd_lse", "flash_attention_bwd_dkv", "flash_attention_bwd_dq")
                 if train else ("flash_attention_fwd",))
        suffix = "" if precision == "bf16" else "_f32"
        want.update({name + suffix: SDXL_ATTENTIONS * forwards for name in names})
    if kernel == "pallas":
        names = gnk.KERNELS if train else ("gn_fwd_reduce", "gn_fwd_normalize")
        want.update({name: SDXL_NORMS * forwards for name in names})
    if kernel == "fused":
        # two fused convs a fused resnet, each with the reduce and, in the
        # backward, the backward reduce and dx of its norm
        want.update({name: 2 * fused for name in (*fr.BF16_KERNELS, "gn_fwd_reduce",
                                                  "gn_bwd_reduce", "gn_bwd_dx")})
    return want


def phase_cli_audit(tmp: str, model_dir: str) -> None:
    """The card audit of the CLIs' impl matrix (see AUDIT_*): each cell
    through ``train.main`` or ``evaluate.main``, finite, within its bound of
    the control, launching exactly the kernels its impls name."""
    import logging

    import torch
    import yaml

    from vae_channel_dynamics_tpu_torch import evaluate
    from vae_channel_dynamics_tpu_torch import train as train_cli
    from vae_channel_dynamics_tpu_torch.models import vae as tvae
    from vae_channel_dynamics_tpu_torch.ops import flash_attention as fa
    from vae_channel_dynamics_tpu_torch.ops import fused_resnet as fr
    from vae_channel_dynamics_tpu_torch.ops import group_norm_kernel as gnk

    counters = {"flash": fa.launches, "gn": gnk.launches, "fused": fr.launches,
                "blocks": tvae.fused_blocks}
    results, rows = {}, []
    package_logger = logging.getLogger("vae_channel_dynamics_tpu_torch")
    level = package_logger.level
    saved_tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    package_logger.setLevel(logging.WARNING)
    t_phase = time.perf_counter()
    try:
        cells = [("train", p, k, a) for p in AUDIT_PRECISIONS for k in AUDIT_TRAIN_KERNELS
                 for a in AUDIT_ATTENTION]
        cells += [("eval", p, k, a) for p in AUDIT_PRECISIONS for k in AUDIT_EVAL_KERNELS
                  for a in AUDIT_ATTENTION]
        for cell in cells:
            kind, precision, kernel, attention = cell
            tag = "_".join(cell)
            out_dir = os.path.join(tmp, f"audit_{tag}")
            cfg = {"seed": SEED, "run_name": "audit", "output_dir": out_dir,
                   "data": {"dataset_name": "synthetic://shapes?num_samples="
                                            f"{AUDIT_BATCH * AUDIT_STEPS if kind == 'train' else AUDIT_EVAL_IMAGES}",
                            "resolution": AUDIT_RES, "batch_size": AUDIT_BATCH,
                            "do_validation": False},
                   "training": {"mixed_precision": precision, "num_train_epochs": 1,
                                "learning_rate": TRAIN_LR, "lr_warmup_steps": 0,
                                "max_grad_norm": TRAIN_CLIP, "kl_weight": TRAIN_KL},
                   "model": {"pretrained_vae_name": model_dir, "kernel_impl": kernel,
                             "attention_impl": attention, "remat": "none"},
                   "logging": {"log_interval": 1, "report_to": "jsonl"},
                   "saving": {"save_interval_steps": 1000},
                   "tracking": {"enabled": True, "track_interval": AUDIT_STEPS,
                                "target_layers": [
                                    {"name": n, "capture_point": "output",
                                     "metrics": ["mean_abs_activation_per_channel"]}
                                    for n in AUDIT_TAPS]}}
            cfg_path = os.path.join(tmp, f"audit_{tag}.yaml")
            with open(cfg_path, "w") as f:
                yaml.safe_dump(cfg, f)
            sync()
            # ---- the main path: counts reset, one CLI run, counts read ----
            for counts in counters.values():
                for name in counts:
                    counts[name] = 0
            t0 = time.perf_counter()
            if kind == "train":
                rc = train_cli.main(["--config_path", cfg_path, "--device", DEVICE])
            else:
                rc = evaluate.main(["--config_path", cfg_path, "--checkpoint_path",
                                    model_dir, "--output_dir", out_dir, "--eval_split",
                                    "test", "--enable_logit_lens", "false",
                                    "--num_samples_to_save", "0", "--device", DEVICE])
            sync()
            wall = time.perf_counter() - t0
            check(rc == 0, f"{tag}: the CLI returned {rc}")
            launches = {name: n for key, counts in counters.items() if key != "blocks"
                        for name, n in counts.items()}
            fused = tvae.fused_blocks["fused"]
            want = _audit_want(kind, precision, kernel, attention, fused)
            check(launches == want, f"{tag}: launches {launches}, want {want}")
            check((fused > 0) == (kind == "train" and kernel == "fused" and precision == "bf16"),
                  f"{tag}: {fused} resnets fused")
            if kind == "train":
                with open(os.path.join(out_dir, "audit", "metrics.jsonl")) as f:
                    records = [json.loads(line) for line in f]
                steps = {r["step"]: r for r in records if "train_loss_step" in r}
                check(sorted(steps) == list(range(1, AUDIT_STEPS + 1)),
                      f"{tag}: logged steps {sorted(steps)}")
                values = {f"{key}@{step}": steps[step][key] for step in steps
                          for key in ("rec_loss", "kl_loss", "grad_norm")}
            else:
                with open(os.path.join(out_dir, "eval_metrics.json")) as f:
                    m = json.load(f)
                check(m["num_samples"] == AUDIT_EVAL_IMAGES, f"{tag}: {m['num_samples']} samples")
                values = {key: m[key] for key in ("mse", "kl", "psnr", "ssim")}
            check(all(math.isfinite(v) for v in values.values()), f"{tag}: not finite {values}")
            results[cell] = values
            rows.append(f"[audit] {tag}: {wall:.2f} s, "
                        + ", ".join(f"{k} {v:.6g}" for k, v in values.items())
                        + f"; launches {({k: v for k, v in launches.items() if v})}"
                        + (f", resnets fused {fused}" if fused else ""))
            shutil.rmtree(out_dir, ignore_errors=True)
            release()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved_tf32
        package_logger.setLevel(level)
    check(len(results) == len(cells), f"{len(results)} of {len(cells)} cells ran")

    # each cell against its precision's control: naive attention, plain GroupNorm
    worst = {}
    for cell, values in results.items():
        kind, precision, kernel, attention = cell
        control = results[(kind, precision, "auto", "naive")]
        fp32 = results[(kind, "no", "auto", "naive")]
        diffs = []
        for key, v in values.items():
            rel = abs(v - control[key]) / abs(fp32[key])
            if precision == "bf16":
                own = abs(control[key] - fp32[key]) / abs(fp32[key])
                bound = AUDIT_CONTROL_RATIO * own + AUDIT_FLOOR
            else:
                bound = AUDIT_F32_REL
            check(rel <= bound, f"{'_'.join(cell)}: {key} is {rel} from its control "
                                f"(bound {bound})")
            diffs.append(f"{key} {rel:.3g} (bound {bound:.3g})")
            worst[(kind, precision)] = max(worst.get((kind, precision), 0.0), rel / bound)
        rows.append(f"[audit] {'_'.join(cell)} vs control: " + ", ".join(diffs))
    for row in rows:
        log(row)
    log(f"[audit] {len(results)} cells ran, none refused; "
        "worst share of its bound by kind and precision: "
        + ", ".join(f"{k} {p} {v:.3g}" for (k, p), v in worst.items())
        + f"; the phase took {time.perf_counter() - t_phase:.1f} s")
    release()


def phase_native_loader() -> None:
    """The native loader on the card's host: doctor's native check (``ok``
    with the decode linked; ``warn`` for the preprocess-only build, made
    where libjpeg's and libpng's headers are missing: PIL decodes, the C++
    kernel resizes, crops and normalises), the build that was made, then
    ``tools/loader_bench.py`` in-process at LOADER_RUNS with workers
    LOADER_WORKERS; no image of a native result goes through the PIL
    transform."""
    from vae_channel_dynamics_tpu_torch.data import native
    from vae_channel_dynamics_tpu_torch.tools import doctor, loader_bench

    t_phase = time.perf_counter()
    doctor._RESULTS.clear()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        doctor.check_native()
    line = out.getvalue().strip()
    log(f"[loader] doctor's native check: {line}")
    check(doctor._RESULTS in (["ok"], ["warn"]), f"the native check failed: {line}")
    decoded = "decode" if native.build_kind == "decode" else "preprocess"
    log(f"[loader] native build: {native.build_kind} ({native.get_lib()._name}); every "
        f"native image is counted under {decoded!r}"
        + ("" if decoded == "decode" else " (PIL decodes it, the C++ kernel resizes)")
        + f"; host cores {os.cpu_count()}")
    for label, argv, images in LOADER_RUNS:
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = loader_bench.main(argv + ["--workers", LOADER_WORKERS])
        check(rc == 0, f"loader_bench {label} exited {rc}")
        result = json.loads(out.getvalue().strip().splitlines()[-1])
        log(f"[loader] {label}, workers {LOADER_WORKERS}, {images} images, "
            f"{time.perf_counter() - t0:.1f} s: {json.dumps(result)}")
        for w in LOADER_WORKERS.split(","):
            counts = result["native_counts"].get(f"native_w{w}")
            want = {"decode": 0, "preprocess": 0, "pil": 0, decoded: images}
            check(counts == want, f"{label} native workers {w}: paths {result['native_counts']}")
            log(f"[loader] {label} workers {w}: pil {result['results'][f'pil_w{w}']} img/s, "
                f"native ({native.build_kind}) {result['results'][f'native_w{w}']} img/s, "
                f"paths {counts}")
    log(f"[loader] the phase took {time.perf_counter() - t_phase:.1f} s")


def phase_realloader_trainer(tmp: str) -> None:
    """``configs/bench_realloader.yaml`` through ``train.main`` on
    REALLOADER_IMAGES JPEGs of ``loader_bench.make_jpegs``, under
    ``VCD_NATIVE_PREPROCESS`` 0 and 1 in turns: ms/step and img/s over steps
    REALLOADER_TIMED_FROM-REALLOADER_STEPS (host clock, synchronised), finite
    losses, every image of the native run decoded natively; the native run
    also writes ``final_model/exported``, whose ``reconstruct`` is held to
    the live wrapper of ``final_model/vae``."""
    import copy
    import logging

    import torch
    import yaml

    from vae_channel_dynamics_tpu_torch import train as train_cli
    from vae_channel_dynamics_tpu_torch.data import native
    from vae_channel_dynamics_tpu_torch.ops import flash_attention as fa
    from vae_channel_dynamics_tpu_torch.tools import export_model, loader_bench
    from vae_channel_dynamics_tpu_torch.training import loop
    from vae_channel_dynamics_tpu_torch.utils.config_utils import load_config

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    base = load_config(os.path.join(root, REALLOADER_CONFIG))
    res, batch = int(base["data"]["resolution"]), int(base["data"]["batch_size"])
    jpegs = os.path.join(tmp, "jpegs")
    os.makedirs(jpegs)
    t0 = time.perf_counter()
    loader_bench.make_jpegs(jpegs, REALLOADER_IMAGES, REALLOADER_SRC)
    log(f"[realloader] {REALLOADER_IMAGES} JPEGs of {REALLOADER_SRC}px written in "
        f"{time.perf_counter() - t0:.1f} s; {REALLOADER_CONFIG} at {res}px batch {batch}, "
        f"{base['data']['num_workers']} loader workers, {REALLOADER_STEPS} steps a run")

    losses, marks, current = {}, {}, {}
    make_train_step = loop.make_train_step

    def timed_make_train_step(*args, **kwargs):
        step_fn = make_train_step(*args, **kwargs)

        def step(state, *a, **kw):
            if state.step == REALLOADER_TIMED_FROM - 1:
                sync()
                marks[(current["run"], "start")] = time.perf_counter()
            out = step_fn(state, *a, **kw)
            losses[(current["run"], out[0].step)] = out[1]["train_loss_step"]
            if out[0].step == REALLOADER_STEPS:
                sync()
                marks[(current["run"], "end")] = time.perf_counter()
            return out

        return step

    timed = REALLOADER_STEPS - REALLOADER_TIMED_FROM + 1
    before = os.environ.get("VCD_NATIVE_PREPROCESS")
    package_logger = logging.getLogger("vae_channel_dynamics_tpu_torch")
    level = package_logger.level
    package_logger.setLevel(logging.WARNING)
    loop.make_train_step = timed_make_train_step
    results, export_dir, vae_dir = {}, None, None
    try:
        for flag in REALLOADER_ORDER:
            run = "native" if flag == "1" else "pil"
            cfg = copy.deepcopy(base)
            cfg["output_dir"] = os.path.join(tmp, run)
            cfg["data"]["dataset_name"] = jpegs
            cfg["training"]["stop_after_steps"] = REALLOADER_STEPS
            cfg["saving"]["export_stablehlo"] = run == "native"
            path = os.path.join(tmp, f"{run}.yaml")
            with open(path, "w") as f:
                yaml.safe_dump(cfg, f)
            os.environ["VCD_NATIVE_PREPROCESS"] = flag
            native.reset_counts()
            current["run"] = run
            t0 = time.perf_counter()
            check(train_cli.main(["--config_path", path, "--device", DEVICE]) == 0,
                  f"the {run} Trainer run failed")
            seconds = time.perf_counter() - t0
            counts = dict(native.counts)
            span = marks[(run, "end")] - marks[(run, "start")]
            run_losses = [losses[(run, i)] for i in range(1, REALLOADER_STEPS + 1)]
            check(all(math.isfinite(v) for v in run_losses), f"{run}: losses {run_losses}")
            results[run] = (span / timed * 1e3, timed * batch / span)
            log(f"[realloader] {run} loader: {results[run][0]:.1f} ms/step, "
                f"{results[run][1]:.1f} img/s over steps {REALLOADER_TIMED_FROM}-"
                f"{REALLOADER_STEPS}; the run took {seconds:.1f} s; losses from "
                f"{run_losses[0]:.5g} to {run_losses[-1]:.5g}; native paths {counts}")
            if run == "native":
                decoded = "decode" if native.build_kind == "decode" else "preprocess"
                check(counts["pil"] == 0 and counts[decoded] >= REALLOADER_STEPS * batch
                      and counts["decode"] + counts["preprocess"] == counts[decoded],
                      f"native run ({native.build_kind} build): image paths {counts}")
                final = os.path.join(cfg["output_dir"], cfg["run_name"], "final_model")
                export_dir, vae_dir = os.path.join(final, "exported"), os.path.join(final, "vae")
            else:
                check(not any(counts.values()), f"PIL run: native paths {counts}")
    finally:
        loop.make_train_step = make_train_step
        package_logger.setLevel(level)
        if before is None:
            os.environ.pop("VCD_NATIVE_PREPROCESS", None)
        else:
            os.environ["VCD_NATIVE_PREPROCESS"] = before
    manifest = export_model.read_manifest(export_dir)
    check(manifest["resolution"] == res and manifest["dtype"] == "bfloat16"
          and manifest["attention_impl"] == "auto"
          and all(not i["vcd_ops"] for i in manifest["entry_points"].values()),
          f"the Trainer's export: {manifest}")
    for name in fa.launches:
        fa.launches[name] = 0
    result = export_model.check_export(vae_dir, export_dir, DEVICE)
    check(result["err"] <= result["bound"], f"the Trainer's export against its model: {result}")
    check(not any(fa.launches.values()), f"naive export launched {fa.launches}")
    log(f"[realloader] final_model/exported ({manifest['dtype']}, attention "
        f"{manifest['attention_impl']}, .pt2 bytes "
        f"{[i['bytes'] for i in manifest['entry_points'].values()]}): reconstruct vs the "
        f"live wrapper of final_model/vae max abs {result['err']:.4g} (bound, the live "
        f"bf16-vs-fp32 difference, {result['bound']:.4g}); native/PIL ms/step "
        f"{results['native'][0] / results['pil'][0]:.3f}; the phase took "
        f"{time.perf_counter() - t_phase:.1f} s")
    release()


def _serve_window(server, seconds: float, bodies, shape):
    """Closed-loop ``/reconstruct?format=npy`` from LOAD_CONCURRENCY clients
    for ``seconds``: (sorted latencies, wall seconds); every answer is 200,
    finite and of ``shape``."""
    import numpy as np

    t_start = time.perf_counter()
    deadline = t_start + seconds

    def client(i):
        lat, j = [], i
        while time.perf_counter() < deadline:
            status, data, dt = _post(server.port, "/reconstruct?format=npy",
                                     bodies[j % len(bodies)])
            check(status == 200, f"/reconstruct answered {status}")
            arr = _load_npy(data)
            check(arr.shape == shape and bool(np.isfinite(arr).all()),
                  f"/reconstruct returned {arr.shape} or non-finite values")
            lat.append(dt)
            j += LOAD_CONCURRENCY
        return lat, time.perf_counter()

    with ThreadPoolExecutor(max_workers=LOAD_CONCURRENCY) as pool:
        clients = list(pool.map(client, range(LOAD_CONCURRENCY)))
    wall = max(end for _lat, end in clients) - t_start
    return sorted(dt for c_lat, _end in clients for dt in c_lat), wall


def phase_export(tmp: str, model_dir: str) -> None:
    """The seeded SDXL VAE exported at EXPORT_RES in bf16 and fp32 through
    ``tools/export_model.main --check``: each ``.pt2`` under EXPORT_MAX_BYTES
    (no weight in it), ``reconstruct`` from one artifact at EXPORT_BATCHES,
    each call launching the flash forward exactly as the live wrapper's
    does; then the server from the bf16 export under LOAD_CONCURRENCY
    closed-loop clients for EXPORT_LOAD_SECONDS, beside the live server's
    window, sampling refused with a 4xx."""
    import numpy as np
    import torch

    from vae_channel_dynamics_tpu_torch import server as srv_mod
    from vae_channel_dynamics_tpu_torch.models import SDXLVAEWrapper
    from vae_channel_dynamics_tpu_torch.models import io as model_io
    from vae_channel_dynamics_tpu_torch.ops import flash_attention as fa
    from vae_channel_dynamics_tpu_torch.tools import export_model

    t_phase = time.perf_counter()
    config, state = model_io.load_model_dir(model_dir)
    dirs = {}
    for dtype_name, kernel in EXPORT_KERNELS.items():
        dst = os.path.join(tmp, f"exported_{dtype_name}")
        t0 = time.perf_counter()
        try:
            rc = export_model.main(["--model_dir", model_dir, "--dst", dst, "--resolution",
                                    str(EXPORT_RES), "--dtype", dtype_name, "--check",
                                    "--device", DEVICE])
        except SystemExit as e:
            raise SmokeFailure(f"export {dtype_name}: {e}") from None
        seconds = time.perf_counter() - t0
        check(rc == 0, f"export_model {dtype_name} exited {rc}")
        manifest = export_model.read_manifest(dst)
        sizes = {name: info["bytes"] for name, info in manifest["entry_points"].items()}
        check(all(n < EXPORT_MAX_BYTES for n in sizes.values()), f".pt2 sizes {sizes}")
        check(manifest["attention_impl"] == "flash"
              and all(i["vcd_ops"] == ["vcd::flash_attention_fwd"]
                      for i in manifest["entry_points"].values()),
              f"the {dtype_name} export does not call the flash op: {manifest}")
        log(f"[export] {dtype_name} at {EXPORT_RES}px: export and --check in {seconds:.1f} s "
            f"(export seconds {[i['export_seconds'] for i in manifest['entry_points'].values()]}), "
            f".pt2 bytes {sizes}")

        exported = export_model.ExportedVAEWrapper(dst, state, DEVICE)
        live = SDXLVAEWrapper(config, state_dict=state, dtype=exported.dtype, attn_impl="flash",
                              device=DEVICE)
        rng = np.random.default_rng(SEED)
        for b in EXPORT_BATCHES:
            x = torch.from_numpy(rng.uniform(-1, 1, (b, EXPORT_RES, EXPORT_RES, 3))
                                 .astype(np.float32)).to(exported.dtype).float()
            counts, outs = [], []
            for run in (exported, live):
                for name in fa.launches:
                    fa.launches[name] = 0
                outs.append(run.forward(x, sample_posterior=False)["reconstruction"].float())
                sync()
                counts.append({k: v for k, v in fa.launches.items() if v})
            check(counts[0] == counts[1] == {kernel: 2},
                  f"{dtype_name} batch {b}: exported launched {counts[0]}, live {counts[1]}")
            check(outs[0].shape == (b, EXPORT_RES, EXPORT_RES, 3)
                  and bool(torch.isfinite(outs[0]).all()), f"{dtype_name} batch {b}: output")
            log(f"[export] {dtype_name} reconstruct at batch {b} from the one artifact: "
                f"launches {counts[0]} (live {counts[1]}), max abs vs live "
                f"{(outs[0] - outs[1]).abs().max().item():.4g}")
        if dtype_name == "bf16":
            # one reconstruct at the server's batch, host clock around a sync,
            # EXPORT_TIMED_CALLS a block, live and exported in turns
            times = {"live": [], "exported": []}
            for name in ("live", "exported", "exported", "live"):
                run = live if name == "live" else exported
                sync()
                t0 = time.perf_counter()
                for _ in range(EXPORT_TIMED_CALLS):
                    run.forward(x, sample_posterior=False)
                sync()
                times[name].append((time.perf_counter() - t0) / EXPORT_TIMED_CALLS * 1e3)
            log(f"[export] bf16 reconstruct at batch {b}, ms a call (host clock, synchronised, "
                f"{EXPORT_TIMED_CALLS} a block, in turns): live {times['live']}, exported "
                f"{times['exported']}")
        dirs[dtype_name] = dst
        del exported, live, outs
        release()

    args = srv_mod.parse_args([
        "--checkpoint_path", model_dir, "--exported_dir", dirs["bf16"], "--resolution", "256",
        "--max_batch", str(MAX_BATCH), "--port", "0", "--device", DEVICE,
    ])
    server = srv_mod.build_server(args)
    check(server.resolution == EXPORT_RES, f"served at {server.resolution}px")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        t0 = time.perf_counter()
        server.warmup()
        log(f"[export] server from the bf16 export on port {server.port}, warmed up in "
            f"{time.perf_counter() - t0:.1f} s")
        rng = np.random.default_rng(SEED)
        bodies = [_npy(rng.uniform(-1, 1, (EXPORT_RES, EXPORT_RES, 3)).astype(np.float32))
                  for _ in range(N_IMAGES)]
        for name in fa.launches:
            fa.launches[name] = 0
        lat, wall = _serve_window(server, EXPORT_LOAD_SECONDS, bodies,
                                  (EXPORT_RES, EXPORT_RES, 3))
        launches = dict(fa.launches)
        try:
            _post(server.port, "/reconstruct?format=npy&deterministic=false", bodies[0])
            refused = None
        except urllib.error.HTTPError as e:
            refused = e.code
        check(refused is not None and 400 <= refused < 500,
              f"?deterministic=false answered {refused}, want a 4xx")
    finally:
        server.shutdown()
        thread.join(timeout=30)
    p50, p95 = percentile(lat, 0.50) * 1e3, percentile(lat, 0.95) * 1e3
    log(f"[export] sustained /reconstruct?format=npy at {EXPORT_RES}px from the bf16 export, "
        f"{LOAD_CONCURRENCY} clients, {EXPORT_LOAD_SECONDS:.0f} s window: {len(lat)} requests "
        f"all 200 in {wall:.3f} s, p50 {p50:.1f} ms, p95 {p95:.1f} ms, {len(lat) / wall:.3f} "
        f"req/s; the live server ({LOAD_SECONDS:.0f} s window): p50 "
        f"{SERVING_LIVE.get('p50_ms', float('nan')):.1f} ms, p95 "
        f"{SERVING_LIVE.get('p95_ms', float('nan')):.1f} ms, "
        f"{SERVING_LIVE.get('rps', float('nan')):.3f} req/s; ?deterministic=false -> {refused}")
    check(launches["flash_attention_fwd"] > 0 and sum(launches.values())
          == launches["flash_attention_fwd"], f"exported server launches {launches}")
    log(f"[export] flash kernel launches while serving the export: "
        f"flash_attention_fwd {launches['flash_attention_fwd']}")
    log(f"[export] the phase took {time.perf_counter() - t_phase:.1f} s")


# --------------------------------------------------------------------------- #
# More than one GPU: the data axis through the CLIs, one rank a card
# --------------------------------------------------------------------------- #
# phase_multi_gpu spawns W = torch.cuda.device_count() ranks over NCCL, one a
# card (torchrun's environment, each rank in its own process), and runs in
# each, through train.main and evaluate.main: (a) configs/bench_zero3_256px.yaml
# (the ZeRO stack and the EMA) with kernel_impl pallas and the control loop on
# planted channels, at bf16 and at fp32; (a') the same at bf16 without the
# ZeRO flags (DDP); (b) configs/experiment_1024_stretch.yaml with flash,
# pallas and remat full, at bf16 and at fp32; (c) configs/bench_256px.yaml
# with kernel_impl fused and shard_optimizer (MULTI_FUSED_BATCH images a
# rank; its fp32 control runs the plain path); (d) the evaluation CLI at
# 512px (fp32, pallas, flash). Each is held to the same config in this
# process without a group at the same global batch: fp32 at W = 1 within
# MULTI_F32_REL (the losses and the gradient norm step by step, and each
# final parameter tensor within MULTI_F32_REL of its largest entry; cuDNN
# deterministic in the fp32 runs and their controls, so that its algorithms'
# own run-to-run rounding, which Adam's first step turns into lr-sized
# changes of near-zero gradients, does not hide what the data axis adds;
# the log says whether they are bit-equal), bf16 by the audit's rule
# (AUDIT_CONTROL_RATIO x the control's bf16-vs-fp32 difference +
# AUDIT_FLOOR), fp32 at W > 1 within AUDIT_F32_REL (the sums' order
# differs), the evaluation within MULTI_F32_REL. At W > 1 the controls of
# (a) and (c) run under remat full (the same arithmetic) so that 4x the
# batch fits at fp32. (e) the 512px server with use_mesh, one replica a card
# (max_batch MAX_BATCH, rounded up to the card count), MULTI_SERVE_SECONDS
# under LOAD_CONCURRENCY closed-loop clients, after one replicated forward
# is launched with the host-sync check on. Each rank counts its kernels'
# launches, its peak memory and its step times (host clock, synchronised
# after each step); a step's time and img/s are the slowest rank's mean over
# the steps after the first MULTI_WARMUP_STEPS, in runs that no profiler
# touches. At W > 1 two more runs of (a) and (a') profile step
# MULTI_PROFILE_STEP on every rank for the NCCL kernels' time (at W = 1 NCCL
# launches none); a rank's NCCL time counts its wait for the others, so the
# least over the ranks is the reading, and the profiler stretches the step.
# phase_multi_gpu(timing_only=True) runs the timed runs, the profiled runs
# and (at W > 1) the server only, without the controls and the evaluation;
# ``kinds`` picks the kinds of run (MULTI_KINDS), ("t", "st") the tensor
# runs alone.
# (s), at W >= 2 only: (b)'s config with parallel.spatial MULTI_SPATIAL (W /
# 2 data x 2 spatial ranks, each 512 of the 1024 rows, the mid block's flash
# kernels at 8192 queries against 16384 keys), at bf16 and at fp32, in a
# spawn of its own (MULTI_SPATIAL_TIMEOUT), held to one process at the same
# global batch (W / 2 images) as (b) is, its kernels counted on every rank;
# a third run profiles step MULTI_PROFILE_STEP on every rank for the NCCL
# kernels (the halo exchanges, the GroupNorm all-reduces, the K/V gathers
# and the gradient's all-reduce). At W = 1 a line says that no spatial rank
# ran.
# (t), at W >= 2 only: configs/bench_tp.yaml (256px, batch 16, EMA) at
# parallel.tensor W (one data rank: every card holds 1/W of each channel
# axis _channel_axis cuts), kernel_impl pallas and the control loop, at bf16
# and at fp32, in a spawn of its own (MULTI_TENSOR_TIMEOUT), held to one
# process at the same global batch (16 images) as (a) is; the GroupNorm
# kernels #1-#5 must launch on every rank, and only at channel blocks (C/W:
# (16, 128 / W, 256, 256) at the full-resolution norms); each rank logs its
# peak memory and its collectives a step (ops/tensor_parallel.py's count);
# a third run profiles step MULTI_PROFILE_STEP on every rank for the NCCL
# kernels (the channel gathers, the reduce-scatters of the input gradients,
# the row-parallel conv_out's sum and DDP's gradient all-reduce). The fp32
# run goes twice more on every rank and in one process: with the
# allocator's history recorded (t_fp32_mem: what is live at the peak, by the
# site that allocated it, _memory_peak) and with cuDNN free to choose
# non-deterministic algorithms (t_fp32_free: its peak). (st), at
# W >= 4 only, in the same spawn: (b)'s 1024px config at 2 spatial x 2
# tensor ranks (W / 4 data ranks), bf16 and fp32, attention_impl flash,
# which runs auto on a tensor mesh with JAX's warning (its control runs
# auto), held to one process at the same global batch. At W = 1 a line says
# that no tensor rank ran.
MULTI_ZERO_CONFIG = "configs/bench_zero3_256px.yaml"
MULTI_FUSED_CONFIG = "configs/bench_256px.yaml"
MULTI_TP_CONFIG = "configs/bench_tp.yaml"
MULTI_STEPS = {"a": 5, "b": 4, "c": 2, "s": 4, "t": 4, "st": 3}
MULTI_SPATIAL = 2
MULTI_SPATIAL_TIMEOUT = 480.0
MULTI_TENSOR_TIMEOUT = 600.0
# (st)'s spatial x tensor layout: the smallest world that holds it
MULTI_ST = {"spatial": 2, "tensor": 2}
# (c)'s images a rank: its fused path keeps 41 GB at batch 16 (PERF.md), so
# the one-process control of four ranks fits at 4 a rank
MULTI_FUSED_BATCH = 4
MULTI_EVAL_BATCH, MULTI_EVAL_BATCHES = 4, 2
MULTI_F32_REL = 1e-6
MULTI_SERVE_SECONDS = 15.0
MULTI_RANK_TIMEOUT = 900.0
MULTI_PROFILE_STEP = 3
# the first two steps still warm up (cuDNN's choices, the allocator)
MULTI_WARMUP_STEPS = 2
# a rehearsal on the CPU shrinks the runs' resolutions ({kind: px}) and runs
# MULTI_RANK_PRELUDE in each rank first (its patches); both empty on the card
MULTI_RESOLUTION: dict = {}
MULTI_RANK_PRELUDE = ""
MULTI_KERNELS = {
    "a": ("gn_fwd_reduce", "gn_fwd_normalize", "gn_bwd_reduce", "gn_bwd_dx"),
    "b": ("gn_fwd_reduce", "gn_fwd_normalize", "gn_bwd_reduce", "gn_bwd_dx",
          "flash_attention_fwd_lse", "flash_attention_bwd_dkv", "flash_attention_bwd_dq"),
    "c": ("fused_gn_silu_conv3x3", "conv3x3", "conv3x3_dw"),
    "d": ("gn_fwd_reduce", "gn_fwd_normalize", "flash_attention_fwd_f32"),
    "s": ("gn_fwd_reduce", "gn_fwd_normalize", "gn_bwd_reduce", "gn_bwd_dx",
          "flash_attention_fwd_lse", "flash_attention_bwd_dkv", "flash_attention_bwd_dq"),
    "t": ("gn_fwd_reduce", "gn_fwd_normalize", "gn_bwd_reduce", "gn_bwd_dx"),
    "st": ("gn_fwd_reduce", "gn_fwd_normalize", "gn_bwd_reduce", "gn_bwd_dx"),
}


# the kinds of run above, and the evaluation (d) and the server (e)
MULTI_KINDS = ("a", "b", "c", "s", "t", "st", "eval", "serve")
# the allocator's history kept for one traced run (t_fp32_mem)
MEMORY_TRACE_ENTRIES = 400_000


def _kind(run: str) -> str:
    """A multi run's kind: ``a`` of ``a_bf16``, ``st`` of ``st_fp32``."""
    return run.split("_")[0]


def _multi_runs(world: int, timing_only: bool = False, kinds=MULTI_KINDS) -> tuple:
    """The runs of ``phase_multi_gpu`` at ``world`` cards, of ``kinds``, in
    order: (a), (a') and (b), which alone are timed with ``timing_only``;
    (a) and (b) at fp32 and (c) otherwise; (s) and (t) at W >= 2, (st) at
    W >= 4; the evaluation (not with ``timing_only``) and the server."""
    runs = ("a_bf16", "a_ddp", "b_bf16") if timing_only else (
        "a_bf16", "a_fp32", "a_ddp", "b_bf16", "b_fp32", "c_bf16")
    if world >= MULTI_SPATIAL:
        runs += ("s_bf16",) if timing_only else ("s_bf16", "s_fp32")
    if world >= 2:
        runs += ("t_bf16",) if timing_only else ("t_bf16", "t_fp32")
    if world >= MULTI_ST["spatial"] * MULTI_ST["tensor"]:
        runs += ("st_bf16",) if timing_only else ("st_bf16", "st_fp32")
    runs += () if timing_only else ("eval",)
    return tuple(run for run in runs + ("serve",) if _kind(run) in kinds)


def _multi_configs(tmp: str, model_dir: str, world: int) -> dict:
    """{run: (config path for a rank, config path for the one-process
    control)} of the training runs, and the evaluation's config."""
    import yaml

    from vae_channel_dynamics_tpu_torch.utils.config_utils import load_config

    root = os.path.dirname(os.path.abspath(__file__))
    loop_cfg = load_config(os.path.join(root, TRAINER_CONFIG))
    out = {}

    def control_loop(cfg, steps):
        for key in ("tracking", "classification", "intervention"):
            cfg[key] = json.loads(json.dumps(loop_cfg[key]))
        cfg["tracking"]["track_interval"] = steps
        cfg["intervention"]["intervention_interval"] = steps

    spatial = (("s_bf16", TRAINER_CONFIG, "bf16"), ("s_fp32", TRAINER_CONFIG, "no"))
    tensor = tuple((run, TRAINER_CONFIG if run.startswith("st") else MULTI_TP_CONFIG,
                    "bf16" if run.endswith("bf16") else "no")
                   for run in _multi_runs(world, kinds=("t", "st")))
    for run, src, precision in (("a_bf16", MULTI_ZERO_CONFIG, "bf16"),
                                ("a_fp32", MULTI_ZERO_CONFIG, "no"),
                                ("a_ddp", MULTI_ZERO_CONFIG, "bf16"),
                                ("b_bf16", TRAINER_CONFIG, "bf16"),
                                ("b_fp32", TRAINER_CONFIG, "no"),
                                ("c_bf16", MULTI_FUSED_CONFIG, "bf16"),
                                ("c_fp32", MULTI_FUSED_CONFIG, "no")) + (
                                    spatial if world >= MULTI_SPATIAL else ()) + tensor:
        kind = _kind(run)
        steps = MULTI_STEPS[kind]
        # the batch's shards: a spatial or tensor group reads one
        shards = {"s": world // MULTI_SPATIAL, "t": 1,
                  "st": world // (MULTI_ST["spatial"] * MULTI_ST["tensor"])}.get(kind, world)
        paths = []
        for side in ("rank", "control"):
            cfg = load_config(os.path.join(root, src))
            batch = MULTI_FUSED_BATCH if kind == "c" else int(cfg["data"]["batch_size"])
            cfg["run_name"] = f"{run}_{side}"
            cfg["output_dir"] = os.path.join(tmp, f"multi_w{world}")
            cfg["data"].update(max_samples=batch * shards * steps, num_workers=0,
                               batch_size=batch * (1 if side == "rank" else shards))
            cfg["model"].update(pretrained_vae_name=model_dir)
            cfg["training"].update(mixed_precision=precision, stop_after_steps=steps)
            cfg["logging"] = {"log_interval": 1, "report_to": "jsonl"}
            cfg["saving"] = {"save_interval_steps": 1000}
            cfg["logit_lens"] = {"enabled": False}
            cfg.pop("profiling", None)
            if kind in MULTI_RESOLUTION:
                cfg["data"]["resolution"] = MULTI_RESOLUTION[kind]
            if kind in ("a", "t"):
                cfg["model"]["kernel_impl"] = "pallas"
                control_loop(cfg, steps)
                if run == "a_ddp" or (kind == "t" and side == "control"):
                    cfg["parallel"] = {}
                elif kind == "t":
                    cfg["parallel"] = {"tensor": world}
            elif kind == "st":
                # flash runs auto on a tensor mesh (JAX's warning); the
                # control runs what it resolves to
                cfg["model"].update(attention_impl="flash" if side == "rank" else "auto",
                                    kernel_impl="pallas", remat="full")
                control_loop(cfg, steps)
                cfg["parallel"] = dict(MULTI_ST) if side == "rank" else {}
            elif kind in ("b", "s"):
                cfg["model"].update(attention_impl="flash", kernel_impl="pallas", remat="full")
                control_loop(cfg, steps)
                cfg["parallel"] = ({"spatial": MULTI_SPATIAL}
                                   if kind == "s" and side == "rank" else {})
            else:
                cfg["model"]["kernel_impl"] = "fused"
                cfg["parallel"] = {"shard_optimizer": True}
            if side == "control" and world > 1 and kind in ("a", "c"):
                cfg["model"]["remat"] = "full"
            path = os.path.join(tmp, f"multi_w{world}_{run}_{side}.yaml")
            with open(path, "w") as f:
                yaml.safe_dump(cfg, f)
            paths.append(path)
            if run == "t_fp32":
                # the same run traced for its peak memory (mem), and with
                # cuDNN free to choose non-deterministic algorithms (free)
                for extra in ("mem", "free"):
                    cfg["run_name"] = f"{run}_{extra}_{side}"
                    extra_path = os.path.join(tmp, f"multi_w{world}_{run}_{extra}_{side}.yaml")
                    with open(extra_path, "w") as f:
                        yaml.safe_dump(cfg, f)
                    out[f"{run}_{extra}"] = out.get(f"{run}_{extra}", ()) + (extra_path,)
            if side == "rank" and run in ("a_bf16", "a_ddp", "s_bf16", "t_bf16") and world > 1:
                # the same run, profiled on every rank, apart from the timed one
                cfg["run_name"] = f"{run}_prof"
                cfg["data"]["max_samples"] = batch * shards * MULTI_PROFILE_STEP
                cfg["training"]["stop_after_steps"] = MULTI_PROFILE_STEP
                prof = os.path.join(tmp, f"multi_w{world}_{run}_prof.yaml")
                with open(prof, "w") as f:
                    yaml.safe_dump(cfg, f)
                out[f"{run}_prof"] = (prof, None)
        out[run] = tuple(paths)
    eval_cfg = {"seed": SEED, "data": {"dataset_name": "synthetic://shapes",
                                       "resolution": RESOLUTION},
                "training": {"mixed_precision": "no"},
                "model": {"kernel_impl": "pallas", "attention_impl": "auto"}}
    eval_path = os.path.join(tmp, f"multi_w{world}_eval.yaml")
    with open(eval_path, "w") as f:
        yaml.safe_dump(eval_cfg, f)
    out["eval"] = eval_path
    return out


def _multi_eval_argv(cfg_path: str, model_dir: str, out_dir: str, batch: int,
                     images: int) -> list:
    return ["--config_path", cfg_path, "--checkpoint_path", model_dir, "--output_dir", out_dir,
            "--eval_split", "test", "--max_eval_samples", str(images), "--batch_size",
            str(batch), "--enable_logit_lens", "false", "--num_samples_to_save", "2",
            "--device", DEVICE]


def multi_gpu_rank(args_path: str) -> None:
    """One rank of ``phase_multi_gpu``: joins the NCCL group from torchrun's
    environment and runs every job through the CLIs, counting its kernels'
    launches (and the GroupNorm kernels' input shapes), its peak memory, its
    synchronised step times and its tensor-axis collectives a step, and
    tracing step ``profile_step`` of a job that names one; writes
    ``rank<r>.json`` (and the traces) beside ``args_path``."""
    import torch

    from vae_channel_dynamics_tpu_torch import evaluate
    from vae_channel_dynamics_tpu_torch import train as train_cli
    from vae_channel_dynamics_tpu_torch.ops import flash_attention as fa
    from vae_channel_dynamics_tpu_torch.ops import fused_resnet as fr
    from vae_channel_dynamics_tpu_torch.ops import group_norm_kernel as gnk
    from vae_channel_dynamics_tpu_torch.ops import tensor_parallel as tpar
    from vae_channel_dynamics_tpu_torch.parallel.mesh import initialize_distributed, shutdown
    from vae_channel_dynamics_tpu_torch.parallel.zero import replicate_leaf
    from vae_channel_dynamics_tpu_torch.training import loop

    with open(args_path) as f:
        args = json.load(f)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    axis = initialize_distributed(DEVICE)
    ends, models, step_collectives = [], [], []
    traced = {"step": 0, "path": ""}
    make_train_step = loop.make_train_step
    gn_shapes = set()
    gn_launch = gnk._launch

    def shaped_launch(name, x, *a):
        gn_shapes.add((name,) + tuple(x.shape))
        return gn_launch(name, x, *a)

    gnk._launch = shaped_launch

    def timed_make_train_step(*a, **kw):
        step_fn = make_train_step(*a, **kw)

        def step(state, *sa, **skw):
            prof = None
            if len(ends) + 1 == traced["step"]:
                sync()
                prof = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
                prof.__enter__()
            before = sum(tpar.collectives.values())
            out = step_fn(state, *sa, **skw)
            sync()
            step_collectives.append(sum(tpar.collectives.values()) - before)
            if prof is not None:
                prof.__exit__(None, None, None)
                os.makedirs(os.path.dirname(traced["path"]), exist_ok=True)
                prof.export_chrome_trace(traced["path"])
            ends.append(time.perf_counter())
            if not models or models[-1] is not state.model:
                models.append(state.model)
            return out

        return step

    loop.make_train_step = timed_make_train_step
    results = {"nccl": (".".join(map(str, torch.cuda.nccl.version())) if DEVICE == "cuda"
                        else axis.backend),
               "device": str(axis.device), "runs": {}}
    for job in args["jobs"]:
        for counts in (fa.launches, gnk.launches, fr.launches):
            for k in counts:
                counts[k] = 0
        ends.clear()
        models.clear()
        step_collectives.clear()
        gn_shapes.clear()
        traced["step"] = job.get("profile_step", 0)
        traced["path"] = os.path.join(os.path.dirname(args_path), f"prof_{job['name']}",
                                      f"rank{axis.rank}.json")
        torch.backends.cudnn.deterministic = job.get(
            "deterministic", job["name"].endswith(("fp32", "mem")))
        sync()
        reset_peak()
        memory: dict = {}
        t0 = time.perf_counter()
        with _memory_trace(memory) if job.get("memory_trace") else contextlib.nullcontext():
            if job["kind"] == "train":
                rc = train_cli.main(["--config_path", job["config"], "--device", DEVICE])
            else:
                rc = evaluate.main(job["argv"])
        sync()
        wall = time.perf_counter() - t0
        check(rc == 0, f"rank {axis.rank}: {job['name']} returned {rc}")
        row = {"wall_s": wall, "peak_gb": peak_gb(),
               "step_ms": [1e3 * (b - a) for a, b in zip(ends, ends[1:])],
               "launches": {k: v for c in (fa.launches, gnk.launches, fr.launches)
                            for k, v in c.items() if v},
               "gn_shapes": sorted(gn_shapes), "collectives": list(step_collectives),
               "memory": memory}
        if models:
            # a bit-level checksum of the whole parameters, the same on
            # every rank after the nudges
            with torch.no_grad():
                row["checksum"] = int(sum(replicate_leaf(p).float().view(torch.int32)
                                          .to(torch.int64).sum() for p in
                                          models[-1].parameters()).item())
        results["runs"][job["name"]] = row
        del models[:]
        release()
        torch.distributed.barrier()
    with open(os.path.join(os.path.dirname(args_path), f"rank{axis.rank}.json"), "w") as f:
        json.dump(results, f)
    loop.make_train_step = make_train_step
    gnk._launch = gn_launch
    shutdown(axis)


def _spawn_ranks(tmp: str, world: int, jobs: list, tag: str = "",
                 timeout: float = MULTI_RANK_TIMEOUT) -> list:
    """Run ``multi_gpu_rank`` on ``world`` ranks, one a card, in the work
    directory ``ranks_w<world><tag>``; a rank that fails or a group that
    outlives ``timeout`` fails the phase (every process is killed first).
    Returns the ranks' result dicts."""
    import socket

    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(tmp, f"ranks_w{world}{tag}")
    os.makedirs(work, exist_ok=True)
    args_path = os.path.join(work, "args.json")
    with open(args_path, "w") as f:
        json.dump({"jobs": jobs}, f)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs, logs = [], []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
        log_f = open(os.path.join(work, f"rank{rank}.log"), "w")
        logs.append(log_f)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", "import chip_smoke\n" + MULTI_RANK_PRELUDE
             + f"\nchip_smoke.multi_gpu_rank({args_path!r})"],
            cwd=root, env=env, stdout=log_f, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    failed = None
    try:
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline:
                failed = f"the ranks outlived {timeout} s"
                break
            if any(p.poll() not in (None, 0) for p in procs):
                time.sleep(2.0)  # let the others report, then stop them
                failed = "a rank failed"
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log_f in logs:
            log_f.close()
    rcs = [p.returncode for p in procs]
    if failed or any(rcs):
        for rank in range(world):
            with open(os.path.join(work, f"rank{rank}.log")) as f:
                print(f"--- rank {rank} (rc {rcs[rank]}) ---\n{f.read()[-6000:]}",
                      file=sys.stderr)
        check(False, f"[multi] {failed or 'a rank failed'}: return codes {rcs}")
    out = []
    for rank in range(world):
        with open(os.path.join(work, f"rank{rank}.json")) as f:
            out.append(json.load(f))
    return out


def _timed_train(argv: list) -> tuple:
    """(train.main's return code, the ms of each step after the first) of a
    Trainer run in this process, synchronised after each step."""
    from vae_channel_dynamics_tpu_torch import train as train_cli
    from vae_channel_dynamics_tpu_torch.training import loop

    ends = []
    make_train_step = loop.make_train_step

    def timed_make_train_step(*a, **kw):
        step_fn = make_train_step(*a, **kw)

        def step(*sa, **skw):
            out = step_fn(*sa, **skw)
            sync()
            ends.append(time.perf_counter())
            return out

        return step

    loop.make_train_step = timed_make_train_step
    try:
        rc = train_cli.main(argv)
    finally:
        loop.make_train_step = make_train_step
    return rc, [1e3 * (b - a) for a, b in zip(ends, ends[1:])]


def _step_values(run_dir: str) -> dict:
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    return {f"{key}@{r['step']}": r[key] for r in records if "train_loss_step" in r
            for key in ("rec_loss", "kl_loss", "grad_norm")}


def _nccl_ms(path: str) -> tuple:
    """(NCCL kernels' device ms, every kernel's device ms) in one rank's
    trace of a profiled step."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel" and "dur" in e]
    check(kernels, f"[multi] no kernel in the trace {path}")
    nccl = sum(e["dur"] for e in kernels if "nccl" in e["name"].lower()) / 1e3
    total = sum(e["dur"] for e in kernels) / 1e3
    return nccl, total


def _params_rel(dir_a: str, dir_b: str) -> tuple:
    """(relative L2 of a - b over every parameter, the largest |a - b| over
    the largest |b| of one tensor and that tensor's name, bit-equal) of two
    model dirs."""
    from vae_channel_dynamics_tpu_torch.models import io as model_io

    _, a = model_io.load_model_dir(dir_a)
    _, b = model_io.load_model_dir(dir_b)
    worst, name, equal, sq, norm = 0.0, "", True, 0.0, 0.0
    for k, v in b.items():
        d = a[k].double() - v.double()
        sq += float(d.square().sum())
        norm += float(v.double().square().sum())
        rel = float(d.abs().max()) / max(float(v.double().abs().max()), 1e-30)
        if rel > worst:
            worst, name = rel, k
        equal = equal and bool((a[k] == v).all())
    return math.sqrt(sq / norm), worst, name, equal


def _frame_key(frames: list) -> str:
    """Where an allocation was made: the innermost frame of the port (or
    of this script), and the innermost frame of all when that is another."""
    def fmt(f):
        return f"{os.path.basename(f['filename'])}:{f['line']} {f['name']}"

    if not frames:
        return "(no Python frame)"
    if frames[0].get("name") == "<module>":
        frames = frames[::-1]  # innermost first
    own = next((f for f in frames if "vae_channel_dynamics_tpu_torch" in f["filename"]
                or f["filename"].endswith("chip_smoke.py")), None)
    if own is None or own is frames[0]:
        return fmt(frames[0])
    return f"{fmt(own)} (in {fmt(frames[0])})"


def _memory_peak(events: list, base: int) -> dict:
    """The allocator's history of one device (``torch.cuda.memory
    ._snapshot()``'s ``device_traces`` entry) replayed: the peak of the bytes
    allocated (``base`` were allocated when the history started), the
    allocation that reached it, the live bytes at the peak by where they were
    allocated (:func:`_frame_key`) and the largest live blocks."""
    total, peak, peak_i = base, base, -1
    for i, e in enumerate(events):
        if e["action"] == "alloc":
            total += e["size"]
            if total > peak:
                peak, peak_i = total, i
        elif e["action"] == "free_requested":
            total -= e["size"]
    live = {}
    for e in events[:peak_i + 1]:
        if e["action"] == "alloc":
            live[e["addr"]] = e
        elif e["action"] == "free_requested":
            live.pop(e["addr"], None)
    groups: dict = {}
    for e in live.values():
        key = _frame_key(e.get("frames", []))
        groups[key] = groups.get(key, 0) + e["size"]
    at = events[peak_i] if peak_i >= 0 else {"size": 0, "frames": []}
    return {"peak_gb": peak / 1e9, "base_gb": base / 1e9,
            "at": f"{at['size'] / 1e9:.3f} GB at {_frame_key(at.get('frames', []))}",
            "by_site": [(k, v / 1e9) for k, v in sorted(groups.items(), key=lambda kv: -kv[1])[:6]],
            "largest": [(_frame_key(e.get("frames", [])), e["size"] / 1e9) for e in
                        sorted(live.values(), key=lambda e: -e["size"])[:5]]}


@contextlib.contextmanager
def _memory_trace(out: dict):
    """Record the allocator's history on the card while the block runs
    (Python stacks), then put :func:`_memory_peak`'s summary into ``out``;
    nothing off the card."""
    import torch

    if DEVICE != "cuda":
        yield
        return
    base = torch.cuda.memory_allocated()
    torch.cuda.memory._record_memory_history(max_entries=MEMORY_TRACE_ENTRIES, stacks="python")
    try:
        yield
    finally:
        snapshot = torch.cuda.memory._snapshot()
        torch.cuda.memory._record_memory_history(enabled=None)
    out.update(_memory_peak(snapshot["device_traces"][torch.cuda.current_device()], base))
    del snapshot


def _memory_lines(where: str, summary: dict) -> str:
    return (f"{where}: peak {summary['peak_gb']:.2f} GB ({summary['base_gb']:.2f} before the "
            f"run), reached by {summary['at']}; live at the peak by site (GB) "
            + "; ".join(f"{k} {v:.3f}" for k, v in summary["by_site"])
            + "; largest blocks (GB) " + "; ".join(f"{k} {v:.3f}" for k, v in summary["largest"]))


def phase_multi_gpu(tmp: str, model_dir: str, world: int = 0,
                    timing_only: bool = False, kinds=MULTI_KINDS) -> dict:
    """More than one GPU; see the comment above MULTI_ZERO_CONFIG. Runs
    ``_multi_runs(world, timing_only, kinds)``. Returns this world's
    numbers: img/s of (a) and (b), peak memory a rank with and without the
    ZeRO stack, the NCCL share of a step, serving req/s and those of (s)
    and (t), of the runs that ran. ``timing_only`` runs the timed and
    profiled runs and the server, and none of the controls."""
    import numpy as np
    import torch

    from vae_channel_dynamics_tpu_torch import evaluate

    world = world or torch.cuda.device_count()
    t_phase = time.perf_counter()
    planted = os.path.join(tmp, "multi_planted_sdxl_vae")
    if not os.path.isdir(planted):
        write_planted_model_dir(planted)
    configs = _multi_configs(tmp, planted, world)
    runs = _multi_runs(world, timing_only, kinds)
    eval_images = MULTI_EVAL_BATCH * MULTI_EVAL_BATCHES * world
    rank_runs = tuple(run for run in runs if _kind(run) in ("a", "b", "c"))
    spatial_runs = tuple(run for run in runs if _kind(run) == "s")
    tensor_runs = tuple(run for run in runs if _kind(run) in ("t", "st"))
    jobs = [{"name": run, "kind": "train", "config": configs[run][0]} for run in rank_runs]
    profiled = [run for run in ("a_bf16", "a_ddp", "s_bf16", "t_bf16")
                if run in runs and f"{run}_prof" in configs]
    jobs += [{"name": f"{run}_prof", "kind": "train", "config": configs[f"{run}_prof"][0],
              "profile_step": MULTI_PROFILE_STEP} for run in profiled if _kind(run) == "a"]
    if "eval" in runs:
        jobs.append({"name": "eval", "kind": "eval", "argv": _multi_eval_argv(
            configs["eval"], model_dir, os.path.join(tmp, f"multi_w{world}", "eval_rank"),
            MULTI_EVAL_BATCH, eval_images)})
    release()
    ranks = [{"runs": {}} for _ in range(world)]
    if jobs:
        t0 = time.perf_counter()
        ranks = _spawn_ranks(tmp, world, jobs)
        spawn_s = time.perf_counter() - t0
        log(f"[multi] W = {world} ranks over NCCL {ranks[0]['nccl']} "
            f"({', '.join(r['device'] for r in ranks)}): {len(jobs)} jobs in {spawn_s:.1f} s")
    if spatial_runs:
        # the spatial runs in a spawn of their own: the first collectives of
        # a new layout, under a shorter limit
        sp_jobs = [{"name": run, "kind": "train", "config": configs[run][0]}
                   for run in spatial_runs]
        sp_jobs += [{"name": "s_bf16_prof", "kind": "train",
                     "config": configs["s_bf16_prof"][0], "profile_step": MULTI_PROFILE_STEP}]
        t0 = time.perf_counter()
        sp_ranks = _spawn_ranks(tmp, world, sp_jobs, tag="_spatial",
                                timeout=MULTI_SPATIAL_TIMEOUT)
        for rank, sp_rank in zip(ranks, sp_ranks):
            rank["runs"].update(sp_rank["runs"])
        log(f"[multi] W = {world}: {world // MULTI_SPATIAL} data x {MULTI_SPATIAL} spatial "
            f"ranks, {len(sp_jobs)} jobs in {time.perf_counter() - t0:.1f} s")
    elif "s" in kinds:
        log(f"[multi] W = {world}: no spatial ranks ran on {world} card(s): parallel.spatial "
            f"{MULTI_SPATIAL} needs {MULTI_SPATIAL} cards a group; the flash kernels at fewer "
            "queries than keys ran in phase_flash_split")
    if tensor_runs:
        # the tensor runs in a spawn of their own, as the spatial ones; at
        # fp32 also traced for the peak memory, and with cuDNN's
        # non-deterministic algorithms allowed
        tp_jobs = [{"name": run, "kind": "train", "config": configs[run][0]}
                   for run in tensor_runs]
        if "t_fp32" in tensor_runs:
            tp_jobs += [{"name": "t_fp32_mem", "kind": "train", "config": configs["t_fp32_mem"][0],
                         "memory_trace": True},
                        {"name": "t_fp32_free", "kind": "train",
                         "config": configs["t_fp32_free"][0], "deterministic": False}]
        tp_jobs += [{"name": "t_bf16_prof", "kind": "train",
                     "config": configs["t_bf16_prof"][0], "profile_step": MULTI_PROFILE_STEP}]
        t0 = time.perf_counter()
        tp_ranks = _spawn_ranks(tmp, world, tp_jobs, tag="_tensor",
                                timeout=MULTI_TENSOR_TIMEOUT)
        for rank, tp_rank in zip(ranks, tp_ranks):
            rank["runs"].update(tp_rank["runs"])
        log(f"[multi] W = {world}: 1 data x {world} tensor ranks"
            + (f", and {world // 4} data x 2 spatial x 2 tensor" if "st_bf16" in tensor_runs
               else "") + f", {len(tp_jobs)} jobs in {time.perf_counter() - t0:.1f} s")
    elif "t" in kinds:
        log(f"[multi] W = {world}: no tensor rank ran on {world} card(s): parallel.tensor "
            "needs 2 cards a group; the GroupNorm kernels on channel blocks run at W >= 2")

    # the controls: the same configs in this process, no group, W x the
    # batch, at bf16 and fp32 for each kind
    saved_tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    control_peak_gb, control_step_ms, control_memory = {}, {}, {}
    controls = () if timing_only else tuple(dict.fromkeys(
        f"{_kind(run)}_{p}" for run in rank_runs + spatial_runs + tensor_runs
        for p in ("bf16", "fp32")))
    if "t_fp32" in controls:
        controls += ("t_fp32_mem", "t_fp32_free")
    try:
        for run in controls:
            torch.backends.cudnn.deterministic = run.endswith(("fp32", "mem"))
            reset_peak()
            trace = (_memory_trace(control_memory) if run == "t_fp32_mem"
                     else contextlib.nullcontext())
            with trace:
                rc, steps = _timed_train(["--config_path", configs[run][1], "--device", DEVICE])
            check(rc == 0, f"[multi] control {run} failed")
            control_peak_gb[run] = peak_gb()
            # the steps after the warm-up, as the ranks' (step_ms below)
            control_step_ms[run] = float(np.mean(steps[MULTI_WARMUP_STEPS - 1:]))
            release()
        torch.backends.cudnn.deterministic = False
        if "eval" in runs:
            check(evaluate.main(_multi_eval_argv(
                configs["eval"], model_dir, os.path.join(tmp, f"multi_w{world}", "eval_control"),
                MULTI_EVAL_BATCH * world, eval_images)) == 0, "[multi] the control evaluation")
        release()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved_tf32
    base = os.path.join(tmp, f"multi_w{world}")

    # every run against its control
    for run in rank_runs + spatial_runs + tensor_runs:
        kind = _kind(run)
        control = "a_bf16" if run == "a_ddp" else run
        got = _step_values(os.path.join(base, f"{run}_rank"))
        check(len(got) == 3 * MULTI_STEPS[kind], f"[multi] {run}: steps {sorted(got)}")
        want = fp32 = {} if timing_only else _step_values(
            os.path.join(base, f"{control}_control"))
        if not timing_only:
            fp32 = _step_values(os.path.join(base, f"{kind}_fp32_control"))
            check(sorted(got) == sorted(want),
                  f"[multi] {run}: steps {sorted(got)} against {sorted(want)}")
        worst = 0.0
        for key, v in got.items():
            check(math.isfinite(v), f"[multi] {run}: {key} is {v}")
            if timing_only:
                continue
            rel = abs(v - want[key]) / abs(fp32[key])
            if run.endswith("fp32"):
                bound = MULTI_F32_REL if world == 1 else AUDIT_F32_REL
            else:
                own = abs(want[key] - fp32[key]) / abs(fp32[key])
                bound = AUDIT_CONTROL_RATIO * own + AUDIT_FLOOR
            check(rel <= bound, f"[multi] {run}: {key} {v} is {rel:.3g} from the control "
                                f"(bound {bound:.3g})")
            worst = max(worst, rel / bound)
        note = ""
        if run.endswith("fp32") and world == 1:
            rel, worst_rel, worst_name, equal = _params_rel(
                os.path.join(base, f"{run}_rank", "final_model", "vae"),
                os.path.join(base, f"{run}_control", "final_model", "vae"))
            check(worst_rel <= MULTI_F32_REL, f"[multi] {run}: final parameter {worst_name} "
                                              f"{worst_rel:.3g} of its largest entry from the "
                                              f"control (relative L2 {rel:.3g})")
            note = ("; final parameters bit-equal" if equal else
                    f"; final parameters {rel:.3g} (relative L2), worst tensor {worst_name} "
                    f"{worst_rel:.3g} of its largest entry")
        for r, rank in enumerate(ranks):
            launched = rank["runs"][run]["launches"]
            names = tuple(n + ("_f32" if run.endswith("fp32") and n.startswith("flash") else "")
                          for n in MULTI_KERNELS[kind])
            check(all(launched.get(n, 0) > 0 for n in names),
                  f"[multi] {run}: rank {r} launched {launched}, want each of {names}")
            if kind in ("t", "st"):
                # every GroupNorm launch on a channel block, the full-resolution
                # 128-channel norms at 128 / T channels
                t = world if kind == "t" else MULTI_ST["tensor"]
                shapes = [tuple(sh[1:]) for sh in rank["runs"][run]["gn_shapes"]]
                check(shapes and all(sh[1] in (128 // t, 256 // t, 512 // t) for sh in shapes),
                      f"[multi] {run}: rank {r} launched GroupNorm kernels at {shapes}")
                full = max(sh[2] for sh in shapes)
                check(any(sh[1] == 128 // t and sh[2] == full for sh in shapes),
                      f"[multi] {run}: rank {r} no 128/{t}-channel block at {full} rows")
        sums = {rank["runs"][run].get("checksum") for rank in ranks}
        check(len(sums) == 1, f"[multi] {run}: the ranks' parameters differ: {sums}")
        if kind in ("a", "b", "s", "t", "st") and not timing_only:
            with open(os.path.join(base, f"{run}_rank", "intervention_history.csv")) as f:
                rows = f.read().split()
            with open(os.path.join(base, f"{control}_control",
                                   "intervention_history.csv")) as f:
                check(rows == f.read().split(), f"[multi] {run}: other nudges than the control")
            check(any(int(row.split(",")[2]) > 0 for row in rows), f"[multi] {run}: no nudge")
        steps = [rank["runs"][run]["step_ms"] for rank in ranks]
        log(f"[multi] W = {world} {run}: worst share of its bound {worst:.3g}{note}; rank 0's "
            f"run {ranks[0]['runs'][run]['wall_s']:.1f} s; per rank peak GB "
            + ", ".join(f"{rank['runs'][run]['peak_gb']:.2f}" for rank in ranks)
            + "; step ms (after the first) " + "; ".join(
                ", ".join(f"{t:.1f}" for t in s) for s in steps)
            + f"; rank 0 launches {ranks[0]['runs'][run]['launches']}"
            + (f"; rank 0 GroupNorm shapes {sorted({tuple(sh[1:]) for sh in ranks[0]['runs'][run]['gn_shapes']})}"
               f", collectives a step {ranks[0]['runs'][run]['collectives']}; one process's "
               f"peak {control_peak_gb.get(run, float('nan')):.2f} GB, step "
               f"{control_step_ms.get(run, float('nan')):.1f} ms"
               if kind in ("t", "st") else ""))

    # the evaluation
    if "eval" in runs:
        with open(os.path.join(base, "eval_rank", "eval_metrics.json")) as f:
            got = json.load(f)
        with open(os.path.join(base, "eval_control", "eval_metrics.json")) as f:
            want = json.load(f)
        check(got["num_samples"] == want["num_samples"] == eval_images,
              f"[multi] evaluation: {got['num_samples']} samples")
        for key in ("mse", "kl", "psnr", "ssim"):
            rel = abs(got[key] - want[key]) / abs(want[key])
            check(rel <= MULTI_F32_REL, f"[multi] evaluation {key}: {got[key]} against "
                                        f"{want[key]} ({rel:.3g})")
        for r, rank in enumerate(ranks):
            launched = rank["runs"]["eval"]["launches"]
            check(all(launched.get(n, 0) > 0 for n in MULTI_KERNELS["d"]),
                  f"[multi] evaluation: rank {r} launched {launched}")
        log(f"[multi] W = {world} evaluation at {RESOLUTION}px fp32, {eval_images} images: "
            + ", ".join(f"{k} {got[k]:.6g} (control {want[k]:.6g})"
                        for k in ("mse", "kl", "psnr", "ssim")))

    def step_ms(run: str) -> float:
        # the slowest rank's mean over the steps after the warm-up (step_ms
        # starts at step 2; no profiler runs in these runs)
        return max(np.mean(rank["runs"][run]["step_ms"][MULTI_WARMUP_STEPS - 1:])
                   for rank in ranks)

    numbers = {}
    if {"a_bf16", "a_ddp", "b_bf16"} <= set(runs):
        numbers.update({
            "a_step_ms": step_ms("a_bf16"), "a_ddp_step_ms": step_ms("a_ddp"),
            "b_step_ms": step_ms("b_bf16"),
            "a_img_s": world * 16e3 / step_ms("a_bf16"),
            "a_ddp_img_s": world * 16e3 / step_ms("a_ddp"),
            "b_img_s": world * 1e3 / step_ms("b_bf16"),
            "peak_gb_zero": max(r["runs"]["a_bf16"]["peak_gb"] for r in ranks),
            "peak_gb_ddp": max(r["runs"]["a_ddp"]["peak_gb"] for r in ranks),
            "peak_gb_b": max(r["runs"]["b_bf16"]["peak_gb"] for r in ranks),
        })
    if spatial_runs:
        numbers.update(s_step_ms=step_ms("s_bf16"),
                       s_img_s=world // MULTI_SPATIAL * 1e3 / step_ms("s_bf16"),
                       peak_gb_spatial=max(r["runs"]["s_bf16"]["peak_gb"] for r in ranks))
    if tensor_runs:
        numbers.update(t_step_ms=step_ms("t_bf16"), t_img_s=16e3 / step_ms("t_bf16"),
                       peak_gb_tensor=max(r["runs"]["t_bf16"]["peak_gb"] for r in ranks),
                       t_collectives=float(max(max(r["runs"]["t_bf16"]["collectives"])
                                               for r in ranks)))
        if "t_bf16" in control_peak_gb:
            numbers.update(peak_gb_tensor_control=control_peak_gb["t_bf16"],
                           t_control_step_ms=control_step_ms["t_bf16"],
                           t_fp32_step_ms=step_ms("t_fp32"),
                           t_fp32_control_step_ms=control_step_ms["t_fp32"],
                           peak_gb_tensor_fp32=max(r["runs"]["t_fp32"]["peak_gb"]
                                                   for r in ranks),
                           peak_gb_tensor_fp32_control=control_peak_gb["t_fp32"],
                           peak_gb_tensor_fp32_free=max(r["runs"]["t_fp32_free"]["peak_gb"]
                                                        for r in ranks),
                           peak_gb_tensor_fp32_free_control=control_peak_gb["t_fp32_free"])
            # where the fp32 peak of a rank and of one process lies
            for r, rank in enumerate(ranks[:1]):
                if rank["runs"]["t_fp32_mem"].get("memory"):
                    log(f"[multi] W = {world} t_fp32 memory, " + _memory_lines(
                        f"rank {r} (deterministic cuDNN)", rank["runs"]["t_fp32_mem"]["memory"]))
            if control_memory:
                log(f"[multi] W = {world} t_fp32 memory, "
                    + _memory_lines("one process (deterministic cuDNN)", control_memory))
            log(f"[multi] W = {world} t_fp32 peak a rank, deterministic cuDNN / not: "
                + ", ".join(f"{r['runs']['t_fp32']['peak_gb']:.2f} / "
                            f"{r['runs']['t_fp32_free']['peak_gb']:.2f}" for r in ranks)
                + f" GB; one process {control_peak_gb['t_fp32']:.2f} / "
                  f"{control_peak_gb['t_fp32_free']:.2f} GB")
        if "st_bf16" in tensor_runs:
            numbers.update(st_step_ms=step_ms("st_bf16"),
                           peak_gb_st=max(r["runs"]["st_bf16"]["peak_gb"] for r in ranks))
    for run in profiled:
        # each rank's NCCL time in its profiled step (the least waits least
        # for the other ranks), beside how far the profiler stretched it
        work = os.path.join(tmp, f"ranks_w{world}" + {"s": "_spatial", "t": "_tensor"}.get(
            _kind(run), ""))
        per_rank = [_nccl_ms(os.path.join(work, f"prof_{run}_prof", f"rank{r}.json"))
                    for r in range(world)]
        traced_ms = max(rank["runs"][run + "_prof"]["step_ms"][-1] for rank in ranks)
        numbers[f"{run}_nccl_ms"] = min(n for n, _ in per_rank)
        log(f"[multi] W = {world} {run}: step {MULTI_PROFILE_STEP} profiled on every rank: "
            f"NCCL kernels (ms) " + ", ".join(f"{n:.2f}" for n, _ in per_rank)
            + " of kernels (ms) " + ", ".join(f"{t:.2f}" for _, t in per_rank)
            + f"; the profiled step {traced_ms:.1f} ms, {traced_ms / step_ms(run):.2f}x the "
              f"unprofiled {step_ms(run):.1f} ms")

    if "serve" in runs:
        numbers.update(_multi_serve(model_dir, world, timing_only))
    shutil.rmtree(base, ignore_errors=True)
    log(f"[multi] W = {world}: " + ", ".join(f"{k} {v:.4g}" for k, v in numbers.items())
        + f"; the phase took {time.perf_counter() - t_phase:.1f} s")
    return numbers


def _multi_serve(model_dir: str, world: int, timing_only: bool) -> dict:
    """(e) the server, one replica a card (and one replica alone); returns
    req/s by replica count."""
    import numpy as np
    import torch

    from vae_channel_dynamics_tpu_torch import server as srv
    from vae_channel_dynamics_tpu_torch.models import SDXLVAEWrapper
    from vae_channel_dynamics_tpu_torch.models import io as model_io
    from vae_channel_dynamics_tpu_torch.ops import flash_attention as fa

    numbers = {}
    config, state_dict = model_io.load_model_dir(model_dir)
    wrapper = SDXLVAEWrapper(config=config, state_dict=state_dict, dtype=torch.bfloat16,
                             attn_impl=srv.resolve_serving_attention_impl(
                                 "auto", RESOLUTION, config),
                             device=DEVICE)
    del state_dict
    rng = np.random.default_rng(SEED)
    images = rng.uniform(-1, 1, (LOAD_CONCURRENCY, RESOLUTION, RESOLUTION, 3)).astype(
        np.float32)
    bodies = [_npy(x) for x in images]
    # timing_only serves at W > 1 only, one replica and one a card, in turn
    for replicas in sorted({1, world}) if world > 1 or not timing_only else ():
        server = srv.VAEServer(wrapper, resolution=RESOLUTION, max_batch=MAX_BATCH,
                               max_wait_ms=10.0, port=0, use_mesh=replicas > 1)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            check(len(server.replicas) == replicas, f"{len(server.replicas)} replicas")
            # one replicated forward, its launches under the host-sync check
            blocks = np.split(images[:server.batcher.max_batch], replicas)
            xs = [torch.from_numpy(b).to(w.device) for b, w in zip(blocks, server.replicas)]
            sync()
            if DEVICE == "cuda":
                torch.cuda.set_sync_debug_mode("error")
            try:
                ys = [srv._call(w, "reconstruct", x, True, None)
                      for w, x in zip(server.replicas, xs)]
            finally:
                if DEVICE == "cuda":
                    torch.cuda.set_sync_debug_mode("default")
            got = torch.cat([y.float().cpu() for y in ys])
            # each block as the first card computes it at the block's own
            # batch (another batch size may take other cuDNN algorithms,
            # whose bf16 rounding a random-weight decoder amplifies to ~5%)
            want = torch.cat([wrapper.forward(torch.from_numpy(b), sample_posterior=False)
                              ["reconstruction"].float().cpu() for b in blocks])
            err = float((got - want).norm() / want.norm())
            check(err <= MULTI_F32_REL, f"[multi] {replicas} replicas: rel L2 {err:.3g} "
                                        "from the first card")
            server.warmup()
            before = fa.launches["flash_attention_fwd"]
            lat, wall = _serve_window(server, MULTI_SERVE_SECONDS, bodies,
                                      (RESOLUTION, RESOLUTION, 3))
            launched = fa.launches["flash_attention_fwd"] - before
            calls = server.batcher.batch_calls
            check(launched >= SDXL_ATTENTIONS * replicas, f"[multi] flash launched {launched}")
            rps = len(lat) / wall
            numbers[f"serve_rps_{replicas}"] = rps
            log(f"[multi] server, {replicas} replica(s) at {RESOLUTION}px, max_batch "
                f"{server.batcher.max_batch}: {len(lat)} requests in {wall:.1f} s, "
                f"{rps:.3f} req/s, p50 {1e3 * percentile(lat, 0.5):.1f} ms, p95 "
                f"{1e3 * percentile(lat, 0.95):.1f} ms; {calls} batches; the replicated "
                f"forward launched without a host sync, rel L2 {err:.3g} from the first card; "
                f"flash forward launched {launched} times")
        finally:
            server.shutdown()
            thread.join(timeout=30)
    del wrapper
    release()
    return numbers


def multi_gpu_main(timing_only: bool = False, kinds=MULTI_KINDS) -> int:
    """``phase_multi_gpu`` alone, at the fewest cards its ``kinds`` run on
    (W = 1, or 2 for (s), (t) and (st) alone) and at every card of the
    machine, with the device and build phases it needs: ``python -c "import
    chip_smoke; chip_smoke.multi_gpu_main()"`` (``timing_only=True``: the
    timed, profiled and serving runs only; ``kinds=("t", "st")``: the tensor
    runs alone, at W = 2 and at every card)."""
    import torch

    least = 1 if set(kinds) - {"s", "t", "st"} else 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < least:
        print(f"chip_smoke: these runs need {least} NVIDIA GPU(s)", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    name, smi = phase_device()
    phase_build()
    with tempfile.TemporaryDirectory(prefix="vcd_chip_smoke_") as tmp:
        model_dir = os.path.join(tmp, "sdxl_seeded")
        write_seeded_model_dir(model_dir)
        worlds = sorted({least, torch.cuda.device_count()})
        numbers = {w: phase_multi_gpu(tmp, model_dir, world=w, timing_only=timing_only,
                                      kinds=kinds) for w in worlds}
    top = worlds[-1]
    one = numbers.get(1, {})
    if top > 1 and "a_img_s" in one and f"serve_rps_{top}" in numbers[top]:
        log(f"[multi] W = {top} against W = 1 on {smi}: " + ", ".join(
            f"{k} x{numbers[top][k] / numbers[1][k]:.3f}" for k in
            ("a_img_s", "a_ddp_img_s", "b_img_s")) + "; ms a step across cards "
            + ", ".join(f"{k} +{numbers[top][k] - numbers[1][k]:.1f}" for k in
                        ("a_step_ms", "a_ddp_step_ms", "b_step_ms")) + f"; serving req/s "
            f"x{numbers[top][f'serve_rps_{top}'] / numbers[top]['serve_rps_1']:.3f} "
            "(one replica and one a card, in the same phase)")
    if top > 1 and "t_step_ms" in numbers[top]:
        log(f"[multi] tensor: configs/bench_tp.yaml at W = {top} (1 data x {top} tensor) "
            f"{numbers[top]['t_step_ms']:.1f} ms a step, {numbers[top]['t_img_s']:.3f} "
            f"img/s, peak a rank {numbers[top]['peak_gb_tensor']:.2f} GB"
            + (f" (one process {numbers[top]['peak_gb_tensor_control']:.2f} GB)"
               if "peak_gb_tensor_control" in numbers[top] else "")
            + f", {numbers[top]['t_collectives']:.0f} collectives a step"
            + (f"; NCCL kernels in a profiled tensor step "
               f"{numbers[top]['t_bf16_nccl_ms']:.2f} ms (the least over the ranks)"
               if "t_bf16_nccl_ms" in numbers[top] else ""))
    if top > 1 and "s_step_ms" in numbers[top] and "b_step_ms" in one:
        log(f"[multi] spatial: the 1024px Trainer at W = {top} ({top // MULTI_SPATIAL} data "
            f"x {MULTI_SPATIAL} spatial) {numbers[top]['s_step_ms']:.1f} ms a step, "
            f"{numbers[top]['s_img_s']:.3f} img/s, peak a rank "
            f"{numbers[top]['peak_gb_spatial']:.2f} GB, against one card (b_bf16 at W = 1) "
            f"{numbers[1]['b_step_ms']:.1f} ms, {numbers[1]['b_img_s']:.3f} img/s, "
            f"{numbers[1]['peak_gb_b']:.2f} GB"
            + (f"; NCCL kernels in a profiled spatial step {numbers[top]['s_bf16_nccl_ms']:.2f}"
               " ms (the least over the ranks)" if "s_bf16_nccl_ms" in numbers[top] else ""))
    print(smi, flush=True)
    print(json.dumps({"multi_gpu": {str(w): n for w, n in numbers.items()}}), flush=True)
    return 0


# cuDNN's workspace for the convs a tensor rank runs: every conv of the
# SDXL VAE at configs/bench_tp.yaml's shape (CONV_WS_BATCH, CONV_WS_RES)
# with its output channels cut to O / T (a column conv on the whole input;
# conv_out, whose O is 3, cut on its input channels), fp32 with TF32 off, as
# ops/tensor_parallel.py calls it: the forward and the backward's bytes
# allocated beyond their inputs and outputs (the workspace) and their ms,
# with the algorithm PyTorch picks; where a workspace passes CONV_WS_LARGE_GB,
# the same conv in channels_last, with TF32 on, and in a process of its own
# under CUDNN_CONV_WSCAP_DBG (MiB). `conv_workspace_main()`.
CONV_WS_TENSORS = (1, 2, 4)
CONV_WS_BATCH, CONV_WS_RES = 16, 256
CONV_WS_LARGE_GB = 2.0
CONV_WS_CAP_MIB = 2048


def _conv_layers(batch: int, res: int) -> list:
    """(x shape, weight shape, stride, pad (l, r, t, b)) of every distinct
    conv of the SDXL VAE at ``res``, in order of first use (one bf16
    forward under hooks)."""
    import torch

    from vae_channel_dynamics_tpu_torch.models import AutoencoderKL, VAEConfig
    from vae_channel_dynamics_tpu_torch.models.vae import Conv2d

    model = AutoencoderKL(VAEConfig.sdxl(), device=DEVICE, dtype=torch.bfloat16)
    model.init_weights(torch.Generator(device=DEVICE).manual_seed(SEED))
    layers = {}

    def hook(module, args):
        pad = module.pad if module.pad is not None else (module.padding,) * 4
        key = ((batch,) + tuple(args[0].shape[1:]), tuple(module.weight.shape),
               module.stride, tuple(pad))
        layers.setdefault(key, None)

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, Conv2d)]
    with torch.no_grad():
        model(torch.zeros(1, 3, res, res, device=DEVICE))
    for h in handles:
        h.remove()
    del model
    release()
    return list(layers)


def _conv_workspace(x_shape, w_shape, stride, pad, channels_last=False,
                    port=False) -> dict:
    """The forward's and the backward's workspace (GB) and ms of one conv
    as ``F.conv2d`` and ``convolution_backward`` run it on
    ``ops/tensor_parallel.py``'s operands; ``port``: the forward alone, as
    that module's column conv runs it (on a whole input, no collective)."""
    import torch
    import torch.nn.functional as F

    from vae_channel_dynamics_tpu_torch.ops import tensor_parallel as tpar

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    first, own = tpar._conv_padding(pad)
    x = torch.randn(x_shape, generator=gen, device=DEVICE).contiguous(memory_format=fmt)
    whole = x
    x = F.pad(x, first) if any(first) else x
    w = (0.01 * torch.randn(w_shape, generator=gen, device=DEVICE)).contiguous(memory_format=fmt)

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    def measured(fn):
        sync()
        reset_peak()
        base = torch.cuda.memory_allocated() if DEVICE == "cuda" else 0
        out = fn()
        sync()
        extra = (torch.cuda.max_memory_allocated() - base if DEVICE == "cuda" else 0)
        return out, (extra - nbytes(*out)) / 1e9, cuda_ms(fn, 3) if DEVICE == "cuda" else 0.0

    def fwd():
        if port:
            with torch.no_grad():
                return (tpar.column_conv(whole, w, None, stride, pad, x_shape[1],
                                         tpar.TensorGroup(group=None, size=2, index=0)),)
        return (F.conv2d(x, w, None, stride, own),)

    (y,), fwd_gb, fwd_ms = measured(fwd)
    if port:
        del y, x, w, whole
        release()
        return {"fwd_gb": fwd_gb, "fwd_ms": fwd_ms}
    g = torch.randn(y.shape, generator=gen, device=DEVICE).contiguous(memory_format=fmt)
    del y

    def bwd():
        dx, dw, _ = torch.ops.aten.convolution_backward(
            g, x, w, None, [stride] * 2, list(own), [1, 1], False, [0, 0], 1,
            [True, True, False])
        return dx, dw

    _grads, bwd_gb, bwd_ms = measured(bwd)
    del _grads, x, w, g
    release()
    return {"fwd_gb": fwd_gb, "fwd_ms": fwd_ms, "bwd_gb": bwd_gb, "bwd_ms": bwd_ms}


def flash_wide_main() -> int:
    """``python -c "import sys, chip_smoke; sys.exit(chip_smoke
    .flash_wide_main())"``: the device, the build and ``phase_flash_wide``
    alone (the flash kernels at heads of 640-1024 channels; see the comment
    above WIDE_WIDTHS), then their numbers as one JSON line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        _name, smi = phase_device()
        timed_phase(phase_build)
        wide = timed_phase(phase_flash_wide)
    except Exception as e:  # noqa: BLE001 — a phase failure fails the run
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"wide": wide}), flush=True)
    print(smi, flush=True)
    return 0


def conv_workspace_main(cap_child: str = "") -> int:
    """``python -c "import sys, chip_smoke; sys.exit(chip_smoke
    .conv_workspace_main())"``: see the comment above CONV_WS_TENSORS.
    ``cap_child`` (a JSON list of convs) measures those convs only, in a
    process started with CUDNN_CONV_WSCAP_DBG set."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    if cap_child:
        for conv in json.loads(cap_child):
            print(json.dumps([conv, _conv_workspace(*conv)]), flush=True)
        return 0
    name, smi = phase_device()
    large = []
    for x_shape, w_shape, stride, pad in _conv_layers(CONV_WS_BATCH, CONV_WS_RES):
        for t in CONV_WS_TENSORS:
            if w_shape[0] % t == 0:  # a column conv: the O / T block, the whole input
                conv = (x_shape, (w_shape[0] // t,) + w_shape[1:], stride, pad)
            else:  # conv_out: the I / T block of the input and the weight
                conv = ((x_shape[0], x_shape[1] // t) + x_shape[2:],
                        (w_shape[0], w_shape[1] // t) + w_shape[2:], stride, pad)
            r = _conv_workspace(*conv)
            log(f"[conv-ws] T = {t} x {conv[0]} w {conv[1]} stride {stride}: workspace GB "
                f"fwd {r['fwd_gb']:.3f}, bwd {r['bwd_gb']:.3f}; ms fwd {r['fwd_ms']:.3f}, bwd "
                f"{r['bwd_ms']:.3f}")
            if max(r["fwd_gb"], r["bwd_gb"]) > CONV_WS_LARGE_GB:
                large.append(list(conv))
    for conv in large:
        cl = _conv_workspace(*conv, channels_last=True)
        torch.backends.cudnn.allow_tf32 = True
        tf32 = _conv_workspace(*conv)
        torch.backends.cudnn.allow_tf32 = False
        port = _conv_workspace(*conv, port=True)
        log(f"[conv-ws] x {conv[0]} w {conv[1]}: channels_last workspace GB fwd "
            f"{cl['fwd_gb']:.3f}, bwd {cl['bwd_gb']:.3f}, ms fwd {cl['fwd_ms']:.3f}, bwd "
            f"{cl['bwd_ms']:.3f}; TF32 on GB fwd {tf32['fwd_gb']:.3f}, bwd {tf32['bwd_gb']:.3f}, "
            f"ms fwd {tf32['fwd_ms']:.3f}, bwd {tf32['bwd_ms']:.3f}; the port's column conv "
            f"forward (FP32_CONV_SLICE slices) GB {port['fwd_gb']:.3f}, ms {port['fwd_ms']:.3f}")
        check(port["fwd_gb"] <= CONV_WS_LARGE_GB,
              f"[conv-ws] the port's column conv forward at {conv} takes {port['fwd_gb']} GB")
    if large:
        root = os.path.dirname(os.path.abspath(__file__))
        out = subprocess.run(
            [sys.executable, "-c", "import sys, chip_smoke; sys.exit(chip_smoke"
             f".conv_workspace_main({json.dumps(json.dumps(large))}))"],
            cwd=root, env=dict(os.environ, CUDNN_CONV_WSCAP_DBG=str(CONV_WS_CAP_MIB)),
            capture_output=True, text=True, timeout=600)
        for line in out.stdout.splitlines():
            conv, r = json.loads(line)
            log(f"[conv-ws] x {conv[0]} w {conv[1]} under CUDNN_CONV_WSCAP_DBG="
                f"{CONV_WS_CAP_MIB}: workspace GB fwd {r['fwd_gb']:.3f}, bwd {r['bwd_gb']:.3f}, "
                f"ms fwd {r['fwd_ms']:.3f}, bwd {r['bwd_ms']:.3f}")
        check(out.returncode == 0, f"[conv-ws] the capped process: {out.stderr[-2000:]}")
    log(f"[conv-ws] {len(large)} conv(s) over {CONV_WS_LARGE_GB} GB of workspace on {smi}")
    return 0


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


def timed_phase(fn, *args):
    """``fn(*args)``, then a line with the seconds it took."""
    t0 = time.perf_counter()
    try:
        return fn(*args)
    finally:
        log(f"[time] {fn.__name__} {time.perf_counter() - t0:.1f} s")


def main() -> int:
    t_start = time.perf_counter()
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
        timed_phase(phase_build)
        timed_phase(phase_doctor)
        kernel_results = timed_phase(phase_kernel)
        flash_results = timed_phase(phase_flash_bwd)
        split_results = timed_phase(phase_flash_split)
        wide_results = timed_phase(phase_flash_wide)
        gn_results = timed_phase(phase_gn_kernels)
        fused_results = timed_phase(phase_fused_kernels)
        conv_result = timed_phase(phase_conv_nhwc)
        f32_result = timed_phase(phase_flash_f32)
        with tempfile.TemporaryDirectory(prefix="vcd_chip_smoke_") as tmp:
            serve_launches = timed_phase(phase_slice, tmp)
        release()
        with tempfile.TemporaryDirectory(prefix="vcd_chip_smoke_") as tmp:
            model_dir = os.path.join(tmp, "sdxl_seeded")
            write_seeded_model_dir(model_dir)
            f32_result["launches"] = timed_phase(phase_eval, tmp, model_dir)
            timed_phase(phase_tiling, tmp, model_dir)
            timed_phase(phase_cli_audit, tmp, model_dir)
            timed_phase(phase_export, tmp, model_dir)
            timed_phase(phase_multi_gpu, tmp, model_dir)
        release()
        bundle = timed_phase(phase_train)
        timed_phase(phase_step_compare, bundle)
        timed_phase(phase_step_times, bundle)
        timed_phase(phase_fused_step, bundle)
        del bundle
        release()
        with tempfile.TemporaryDirectory(prefix="vcd_chip_smoke_") as tmp:
            fused_trainer = timed_phase(phase_fused_trainer, tmp)
        release()
        with tempfile.TemporaryDirectory(prefix="vcd_chip_smoke_") as tmp:
            timed_phase(phase_adafactor_trainer, tmp)
        release()
        timed_phase(phase_native_loader)
        with tempfile.TemporaryDirectory(prefix="vcd_chip_smoke_") as tmp:
            timed_phase(phase_realloader_trainer, tmp)
        release()
        with tempfile.TemporaryDirectory(prefix="vcd_chip_smoke_") as tmp:
            trainer = timed_phase(phase_trainer_1024, tmp)
            trainer_f32 = timed_phase(phase_trainer_1024_f32, tmp, trainer["model_dir"])
            timed_phase(phase_flash_step_1024, trainer["model_dir"])
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
                    **{k: trainer_f32["launches"][k] for k in F32_NOTES},
                    flash_attention_fwd_f32=f32_result["launches"],
                    conv3x3_nhwc=conv_result["launches"],
                    **{k: fused_trainer["launches"][k] for k in FUSED_REPLACES},
                    **{k: fused_results[k]["launches"] for k in FUSED_F32_REPLACES})
    sources = dict(FLASH_SOURCES, flash_attention_fwd_f32=FLASH_FWD_SOURCE,
                   conv3x3_nhwc=CONV_SOURCE, **{k: GN_SOURCE for k in GN_REPLACES},
                   **{k: FUSED_SOURCE for k in (*FUSED_REPLACES, *FUSED_F32_REPLACES)})
    replaces = dict(FLASH_REPLACES, flash_attention_fwd_f32=FLASH_F32_REPLACES,
                    conv3x3_nhwc=CONV_REPLACES, **GN_REPLACES, **FUSED_REPLACES,
                    **FUSED_F32_REPLACES)
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
        **({"note": F32_NOTES[kname]} if kname in F32_NOTES else {}),
        **({"note": FUSED_F32_NOTE + ("; " + REDESIGNED[kname] if kname in REDESIGNED else "")}
           if kname in FUSED_F32_REPLACES else {}),
        # the same kernel at fewer queries than keys (the spatial axis)
        **({"split": split_results[kname]} if kname in split_results else {}),
        # the same kernel at heads of 768 and 1024 channels
        **({"wide": wide_results[kname]} if kname in wide_results else {}),
    } for kname, r in rows.items()]
    log(f"[total] every phase in {time.perf_counter() - t_start:.1f} s, the kernels' build "
        "included")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
