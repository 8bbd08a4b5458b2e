#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root. Phases, each printing what it found; any
failure exits non-zero without the final ``ok`` line:

1. device: the card's name, and name plus power limit from nvidia-smi;
2. build: the three kernel libraries, ``vae_channel_dynamics_tpu_torch/csrc/
   flash_attention_fwd.cu``, ``csrc/flash_attention_bwd.cu`` and
   ``csrc/group_norm.cu`` (nvcc, sm_90a, one nvcc each, started together),
   the seconds each took, and ptxas's registers and spills;
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
   planted fault; forward and backward times from CUDA events;
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

The last lines are a JSON object describing the eight kernels, the
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
# summation order differs and gives about 1e-6.
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


def phase_build():
    from vae_channel_dynamics_tpu_torch.ops import _cuda_build, flash_attention
    from vae_channel_dynamics_tpu_torch.ops import group_norm_kernel as gnk

    # one nvcc per library, started together
    builds = {FLASH_FWD_SOURCE: (flash_attention.FWD_LIBRARY, flash_attention.build_forward),
              FLASH_BWD_SOURCE: (flash_attention.BWD_LIBRARY, flash_attention.build_backward),
              GN_SOURCE: (gnk.LIBRARY, gnk.build)}
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
                mangled = line.split("'")[1]
                m = re.search(r"\d([a-z][a-z_]*_kernel)(?:ILi(\d+)E)?", mangled)
                kernel = (mangled if m is None
                          else m.group(1) + (f"<{m.group(2)}>" if m.group(2) else ""))
            elif "spill stores" in line:
                spills = line.strip()
            elif "Used" in line and "registers" in line:
                regs = line.split("Used", 1)[1].split(",")[0].strip()
                entries.append(f"{kernel}: {regs}, {spills}")
        log(f"[build] {source}: nvcc {_cuda_build.build_seconds.get(lib, 0.0):.2f} s; "
            f"ptxas per instantiation: {entries}")
    log(f"[build] {len(builds)} libraries built and loaded in {wall:.2f} s")


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
    check(counts == {"flash_attention_fwd": 0, "flash_attention_fwd_lse": 1,
                     "flash_attention_bwd_dkv": 1, "flash_attention_bwd_dq": 1},
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
        ("flash attention kernels (flash_*)", ("flash_fwd", "flash_bwd")),
        ("GroupNorm kernels (gn_*)", ("gn_fwd_", "gn_bwd_")),
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
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
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


def write_planted_model_dir(path: str) -> None:
    """A full-width SDXL model dir from the seed, with PLANTED_CHANNELS of
    TRAINER_PLANTED_NORM at gamma PLANTED_GAMMA, for the control loop to
    find."""
    import torch

    from vae_channel_dynamics_tpu_torch.models import AutoencoderKL
    from vae_channel_dynamics_tpu_torch.models import io as model_io

    model = AutoencoderKL(train_config(), device=DEVICE)
    model.init_weights(torch.Generator(device=DEVICE).manual_seed(SEED))
    with torch.no_grad():
        model.get_submodule(TRAINER_PLANTED_NORM).weight[list(PLANTED_CHANNELS)] = PLANTED_GAMMA
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
    want = {"flash_attention_fwd": 0, "flash_attention_fwd_lse": SDXL_ATTENTIONS,
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
        with tempfile.TemporaryDirectory(prefix="vcd_chip_smoke_") as tmp:
            serve_launches = phase_slice(tmp)
        release()
        bundle = phase_train()
        phase_step_compare(bundle)
        phase_step_times(bundle)
        del bundle
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
    # 512px batch 4, the training kernels at the 1024px Trainer slice's
    # shapes (the mid-block attention, the full-resolution 128-channel norm);
    # the launches are the 1024px Trainer run's, the serving forward's the
    # server's. A library call that computes more than one kernel's work
    # says which kernels it covers.
    serving = dict(kernel_results[KERNEL_SHAPES[0]], shape=list(KERNEL_SHAPES[0]),
                   library_covers="flash_attention_fwd")
    serving["max_abs_err"] = max(r["max_abs_err"] for r in kernel_results.values())
    rows = {"flash_attention_fwd": serving, **flash_results, **gn_results}
    launches = dict(trainer["launches"], flash_attention_fwd=serve_launches)
    sources = dict(FLASH_SOURCES, **{k: GN_SOURCE for k in GN_REPLACES})
    replaces = dict(FLASH_REPLACES, **GN_REPLACES)
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
    } for kname, r in rows.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
