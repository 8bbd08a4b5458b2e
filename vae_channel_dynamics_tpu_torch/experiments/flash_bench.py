"""The flash kernels' times on the card, for a checkout.

    python vae_channel_dynamics_tpu_torch/experiments/flash_bench.py \\
        [--root CHECKOUT] [--iters N] [--digest]

Times ``ops.flash_attention.flash_attention_fwd`` on fp32 q, k, v of
(8, 4096, 512), the fp32 evaluation's shape (batch 8 at 512px), TF32 off;
where the checkout has the fp32 training kernels, also the fp32 LSE forward,
dK/dV and dQ at (1, 16384, 512), the 1024px mid block; the bf16 serving
forward (#6) at (4, 4096, 512) and LSE forward (#6') at (1, 16384, 512);
and the bf16 dK/dV (#7) and dQ (#8) at (1, 16384, 512) (a cluster of four
CTAs) and at (1, 16384, 128) (a cluster of one), checking that two calls of
each are bit-equal. Each time is from CUDA events over ``--iters`` calls after one
warm-up call. It prints one JSON line: the checkout, ms per call of each,
the card's name and nvidia-smi's name and power limit. ``--root`` imports
the package of another checkout of this repository (an older commit
unpacked beside this one), whose kernel libraries build into that
checkout's ``build/``: run two checkouts in turns (A, B, B, A) in one run on
one card to compare them. Needs a GPU.

``--digest`` times nothing: it runs every flash kernel (the serving and LSE
forwards, dK/dV, dQ; bf16 and fp32) at nq == nk on seeded operands at
``DIGEST_SHAPES`` and prints one JSON line of each output's SHA-256, so two
checkouts' lines show whether their kernels give the same bits.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

SHAPE = (8, 4096, 512)
TRAIN_SHAPE = (1, 16384, 512)
SERVING_SHAPE = (4, 4096, 512)
BF16_BWD_SHAPES = ((1, 16384, 512), (1, 16384, 128))
DIGEST_SHAPES = ((1, 16384, 512), (4, 4096, 512), (2, 1024, 128), (1, 1024, 384))


def digests(torch, fa) -> dict:
    """SHA-256 of each kernel's outputs at each of DIGEST_SHAPES, bf16 and
    fp32 (TF32 off), operands from one seed."""
    import hashlib

    def sha(*ts):
        h = hashlib.sha256()
        for t in ts:
            h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
        return h.hexdigest()

    out = {}
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
        for shape in DIGEST_SHAPES:
            gen = torch.Generator(device="cuda").manual_seed(sum(shape))
            q, k, v, do = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                           for _ in range(4))
            scale = shape[-1] ** -0.5
            o, lse = fa.flash_attention_fwd_lse(q, k, v, scale=scale, out_dtype=dtype)
            delta = (do.float() * o.float()).sum(-1)
            key = f"{tag}@{'x'.join(map(str, shape))}"
            out[f"fwd_lse {key}"] = sha(o, lse)
            out[f"fwd {key}"] = sha(fa.flash_attention_fwd(q, k, v, scale=scale, out_dtype=dtype))
            out[f"bwd_dkv {key}"] = sha(*fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                                     scale=scale))
            out[f"bwd_dq {key}"] = sha(fa.flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                                                 scale=scale))
    return out


def main(argv=None) -> int:
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=here, help="the checkout whose package is timed")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--digest", action="store_true",
                    help="print the kernels' output digests at nq == nk, time nothing")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    from vae_channel_dynamics_tpu_torch.ops import flash_attention as fa

    if not torch.cuda.is_available():
        print("flash_bench: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.digest:
        print(json.dumps({"root": root, "package": os.path.dirname(fa.__file__),
                          "digests": digests(torch, fa)}), flush=True)
        return 0
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(SHAPE, generator=gen, device="cuda") for _ in range(3))
    scale = SHAPE[-1] ** -0.5

    def call():
        return fa.flash_attention_fwd(q, k, v, scale=scale, out_dtype=torch.float32)

    out = call()
    ref = fa.flash_attention_reference(q, k, v, scale, torch.float32)
    rel = ((out - ref).norm() / ref.norm()).item()

    def cuda_ms(fn):
        fn()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(args.iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / args.iters

    times = {"flash_attention_fwd_f32": cuda_ms(call)}
    if "flash_attention_bwd_dkv_f32" in fa.KERNELS:
        q, k, v, do = (torch.randn(TRAIN_SHAPE, generator=gen, device="cuda") for _ in range(4))
        scale = TRAIN_SHAPE[-1] ** -0.5
        o, lse = fa.flash_attention_fwd_lse(q, k, v, scale=scale, out_dtype=torch.float32)
        delta = (do * o).sum(-1)
        times["flash_attention_fwd_lse_f32"] = cuda_ms(
            lambda: fa.flash_attention_fwd_lse(q, k, v, scale=scale, out_dtype=torch.float32))
        times["flash_attention_bwd_dkv_f32"] = cuda_ms(
            lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale=scale))
        times["flash_attention_bwd_dq_f32"] = cuda_ms(
            lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, scale=scale))
    for name, shape in (("flash_attention_fwd", SERVING_SHAPE),
                        ("flash_attention_fwd_lse", TRAIN_SHAPE)):
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        entry = getattr(fa, name)
        times[f"{name}@{'x'.join(map(str, shape))}"] = cuda_ms(
            lambda: entry(q, k, v, scale=shape[-1] ** -0.5, out_dtype=torch.bfloat16))
    bit_equal = {}
    for shape in BF16_BWD_SHAPES:
        q, k, v, do = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
                       for _ in range(4))
        scale = shape[-1] ** -0.5
        o, lse = fa.flash_attention_fwd_lse(q, k, v, scale=scale, out_dtype=torch.bfloat16)
        delta = (do.float() * o.float()).sum(-1)

        def dkv():
            return fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale=scale)

        def dq():
            return fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, scale=scale)

        tag = "x".join(map(str, shape))
        times[f"flash_attention_bwd_dkv@{tag}"] = cuda_ms(dkv)
        times[f"flash_attention_bwd_dq@{tag}"] = cuda_ms(dq)
        bit_equal[tag] = (all(torch.equal(a, b) for a, b in zip(dkv(), dkv()))
                          and torch.equal(dq(), dq()))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"root": root, "package": os.path.dirname(fa.__file__),
                      "shape": list(SHAPE), "train_shape": list(TRAIN_SHAPE), "ms": times,
                      "rel_l2_vs_plain": rel, "bf16_bwd_bit_equal_run_to_run": bit_equal,
                      "device": torch.cuda.get_device_name(0), "nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
