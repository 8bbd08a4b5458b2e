#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root. Phases, each printing what it found; any
failure exits non-zero without the final ``ok`` line:

1. device: the card's name, and name plus power limit from nvidia-smi;
2. build: both kernel libraries, ``vae_channel_dynamics_tpu_torch/csrc/
   flash_attention_fwd.cu`` and ``csrc/group_norm.cu`` (nvcc, sm_90a, one
   nvcc each, started together), and the seconds each took;
3. flash kernel vs plain: bf16 q/k/v from a seed at the serving shapes, the
   kernel's max abs and relative L2 error against
   ``flash_attention_reference`` (and proof that the bound rejects a kernel
   that drops one key tile), and both times from CUDA events;
4. serving slice: a full-width SDXL VAE with seeded random weights is written
   with the port's ``save_model_dir`` and served by the port's server at 512px
   (``attention_impl=auto``, ``max_batch`` 4, an ephemeral port). A
   sustained window of ``/reconstruct?format=npy`` from 8 closed-loop
   clients gives p50/p95 latency and req/s; then concurrent ``/encode`` and
   a ``/decode``. Every answer must be 200 with finite values of the right
   shape, and the flash kernel must have been launched while serving them;
   one batch's forward with the flash kernel is held against the naive path;
5. GroupNorm kernels vs plain, bf16, at the training slice's largest and
   smallest norm shapes, with SiLU and the |z| tap: each of the four kernels
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
   a torch.profiler breakdown of one kernel-path step.

The last lines are a JSON object describing the five kernels, the nvidia-smi
line, and ``{"ok": true, "device": {...}}``. Imports no jax.
"""

from __future__ import annotations

import importlib.util
import io
import json
import math
import os
import gc
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
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
KERNEL_SOURCE = "vae_channel_dynamics_tpu_torch/csrc/flash_attention_fwd.cu"
KERNEL_REPLACES = "vae_channel_dynamics_tpu/ops/pallas_attention.py:136"

# GroupNorm kernels vs plain, bf16: the training slice's largest norm input
# (decoder up block 3 and encoder down block 0 at 256px, batch 16) and its
# smallest (the 32x32 mid block). y and dx are bf16 outputs held to
# GN_ULPS bf16 ulps of max|plain|, like the flash kernel; the fp32 sums (the
# reduce outputs, the |z| tap, dgamma, dbeta) to GN_SUM_REL of max|plain|:
# the summation order differs and gives about 1e-5.
GN_SHAPES = ((16, 128, 256, 256), (16, 512, 32, 32))
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
    builds = {KERNEL_SOURCE: (flash_attention.KERNEL_NAME, flash_attention.build),
              GN_SOURCE: (gnk.LIBRARY, gnk.build)}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(builds)) as pool:
        for fut in [pool.submit(fn) for _lib, fn in builds.values()]:
            fut.result()
    wall = time.perf_counter() - t0
    for source, (lib, _fn) in builds.items():
        regs = [line.split(":", 1)[1].strip()
                for line in _cuda_build.build_logs.get(lib, "").splitlines()
                if "Used" in line and "registers" in line]
        log(f"[build] {source}: nvcc {_cuda_build.build_seconds.get(lib, 0.0):.2f} s; "
            f"ptxas per instantiation: {regs}")
    log(f"[build] both libraries built and loaded in {wall:.2f} s")


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
        flops = 4 * b * n * n * c
        log(f"[kernel] (B={b}, N={n}, C={c}) max_abs_err {err:.6g} (tol {atol:.6g}, "
            f"{KERNEL_ULPS} bf16 ulps of max|plain|), rel L2 {rel:.6g} (tol {KERNEL_REL_L2}); "
            f"one dropped {FAULT_TILE}-key tile: max abs {fault_err:.6g}, rel L2 "
            f"{fault_rel:.6g}; kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s) "
            f"[{k1:.4f}, {k2:.4f}], plain {plain_ms:.4f} ms [{p1:.4f}, {p2:.4f}]")
        check(err <= atol and rel <= KERNEL_REL_L2,
              f"kernel disagrees with plain at {(b, n, c)}: max abs {err}, rel L2 {rel}")
        check(fault_err > atol or fault_rel > KERNEL_REL_L2,
              f"the kernel bound at {(b, n, c)} does not reject a dropped key tile")
        results[(b, n, c)] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
        del q, k, v, out, ref
    return results


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
        fa.launches = 0
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
        launches = fa.launches
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

        # 1. fwd reduce; fault: one row of each plane left out
        ks, kq = gnk.fwd_reduce(x)
        sync()
        fs, _fq = gnk.fwd_reduce_reference(x[:, :, :-1])
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
        if shape == GN_SHAPES[0]:
            for name, (ms, plain_ms) in times.items():
                results[name].update(ms=ms, plain_ms=plain_ms)

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
            f"{bytes_x / times['gn_fwd_reduce'][0] / 1e6:.0f} GB/s")
        del x, g, a, off, ca, cb, cc
    release()
    return results


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
        gn_results = phase_gn_kernels()
        with tempfile.TemporaryDirectory(prefix="vcd_chip_smoke_") as tmp:
            launches = phase_slice(tmp)
        release()
        bundle = phase_train()
        phase_step_compare(bundle)
        phase_step_times(bundle)
        gn_launches = bundle["launches"]
        del bundle
        check("jax" not in sys.modules, "jax was imported")
    except Exception as e:  # noqa: BLE001 — every phase failure fails the run
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    main_shape = KERNEL_SHAPES[0]
    res = kernel_results[main_shape]
    kernels = [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in kernel_results.values()),
        "ms": res["ms"],
        "plain_ms": res["plain_ms"],
    }]
    kernels += [{
        "name": kname,
        "route": "cuda",
        "source": GN_SOURCE,
        "replaces": GN_REPLACES[kname],
        "launches": gn_launches[kname],
        "max_abs_err": r["max_abs_err"],
        "ms": r["ms"],
        "plain_ms": r["plain_ms"],
    } for kname, r in gn_results.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
