"""The fused resnet kernels' times on the card, for a checkout.

    python vae_channel_dynamics_tpu_torch/experiments/fused_bench.py \\
        [--root CHECKOUT] [--iters N] [--digest]

Times the weight gradient ``ops.fused_resnet.conv_dw`` at fp32 (kernel #11,
``conv3x3_dw_f32``, its pre-passes included) at each of ``SHAPES``, the
path's (16, 512, 32, 32) -> 512 and (16, 256, 64, 64) -> 512, on seeded
operands, checking that two calls are bit-equal and holding the first to
the plain version evaluated in fp64 (relative L2). Each time is from CUDA
events over ``--iters`` calls after one warm-up call. It prints one JSON
line: the checkout, ms per call, the relative L2 from fp64, the card's name
and nvidia-smi's name and power limit. ``--root`` imports the package of
another checkout of this repository (an older commit unpacked beside this
one), whose kernel library builds into that checkout's ``build/``: run two
checkouts in turns (A, B, B, A) in one run on one card to compare them.
Needs a GPU.

``--digest`` times nothing: it runs every fused resnet kernel (#9 with the
residual, the tap and the moments; #10; #11), bf16 and fp32, at ``SHAPES``
and at ``SMALL_SHAPES`` on seeded operands and prints one JSON line of each
output's SHA-256, so two checkouts' lines show which kernels give the same
bits.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys

SHAPES = (((16, 512, 32, 32), 512), ((16, 256, 64, 64), 512))
SMALL_SHAPES = (((2, 128, 12, 32), 256), ((2, 384, 10, 48), 128))


def operands(torch, shape, cout, dtype, seed):
    """x, a, o, w, bias, residual and dy of one call, from ``seed``."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n, cin, h, w = shape
    x = (torch.randn(shape, generator=gen, device="cuda") * 2.0 + 0.5).to(dtype)
    a = 0.3 + 0.5 * torch.rand((n, cin), generator=gen, device="cuda")
    o = -0.5 + 0.8 * torch.rand((n, cin), generator=gen, device="cuda")
    wt = (torch.randn((cout, cin, 3, 3), generator=gen, device="cuda")
          / math.sqrt(9 * cin)).to(dtype)
    bias = 0.1 * torch.randn(cout, generator=gen, device="cuda")
    res = torch.randn((n, cout, h, w), generator=gen, device="cuda").to(dtype)
    dy = torch.randn((n, cout, h, w), generator=gen, device="cuda").to(dtype)
    return x, a, o, wt, bias, res, dy


def digests(torch, fr) -> dict:
    """SHA-256 of each fused kernel's outputs at SHAPES and SMALL_SHAPES,
    bf16 and fp32."""
    import hashlib

    def sha(*ts):
        h = hashlib.sha256()
        for t in ts:
            h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
        return h.hexdigest()

    out = {}
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
        for shape, cout in SHAPES + SMALL_SHAPES:
            x, a, o, wt, bias, res, dy = operands(torch, shape, cout, dtype, sum(shape) + cout)
            key = f"{tag}@{'x'.join(map(str, shape))}->{cout}"
            y, tap, (ysum, ysq) = fr.fused_fwd(x, a, o, wt, bias, res, True, True)
            out[f"fused_gn_silu_conv3x3 {key}"] = sha(y, tap, ysum, ysq)
            out[f"conv3x3 {key}"] = sha(fr.conv3x3(dy, fr.flipped_weight(wt)))
            out[f"conv3x3_dw {key}"] = sha(fr.conv_dw(x, a, o, dy))
    return out


def main(argv=None) -> int:
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=here, help="the checkout whose package is timed")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--digest", action="store_true",
                    help="print the kernels' output digests, time nothing")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    from vae_channel_dynamics_tpu_torch.ops import fused_resnet as fr

    if not torch.cuda.is_available():
        print("fused_bench: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.digest:
        print(json.dumps({"root": root, "package": os.path.dirname(fr.__file__),
                          "digests": digests(torch, fr)}), flush=True)
        return 0

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

    times, rel, bit_equal = {}, {}, {}
    for shape, cout in SHAPES:
        x, a, o, _wt, _bias, _res, dy = operands(torch, shape, cout, torch.float32, 0)
        tag = f"{'x'.join(map(str, shape))}->{cout}"
        dw = fr.conv_dw(x, a, o, dy)
        bit_equal[tag] = bool(torch.equal(dw, fr.conv_dw(x, a, o, dy)))
        ref = fr.conv_dw_reference(x.double(), a.double(), o.double(), dy.double())
        rel[tag] = ((dw.double() - ref).norm() / ref.norm()).item()
        del ref
        times[f"conv3x3_dw_f32@{tag}"] = cuda_ms(lambda: fr.conv_dw(x, a, o, dy))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"root": root, "package": os.path.dirname(fr.__file__), "ms": times,
                      "rel_l2_vs_fp64": rel, "bit_equal_run_to_run": bit_equal,
                      "device": torch.cuda.get_device_name(0), "nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
