"""Host input-pipeline throughput: images/sec through the dataloader alone.

The port of ``vae_channel_dynamics_tpu/tools/loader_bench.py``. It measures
what the port's host path sustains (JPEG decode + resize + center-crop +
normalize at a target resolution) for the PIL transform and the native C++
kernels (``data/native.py``), across worker-thread counts, so that the
loader's headroom over the device's images/sec can be stated next to the
device number (PERF.md). It writes its own JPEGs (``make_jpegs``, the JAX
tool's seed) unless ``--image-dir`` names a folder.

Prints one JSON line: the JAX tool's ``metric``, ``src_jpeg_px``,
``host_cores`` and ``results`` (img/s per ``<variant>_w<workers>``), and
``native_counts``, the path each image of the timed epoch took per native
result (``data/native.py``'s ``counts``). A native result in which any image
went through PIL is named ``native+pil_w<workers>``, not ``native_w...``.
Where the JAX tool skips the native variant when the library is missing,
this one exits 1 with the compiler's error.

Usage:
    python -m vae_channel_dynamics_tpu_torch.tools.loader_bench \\
        [--resolution 256] [--num-images 256] [--src-size 512] \\
        [--workers 0,2,4] [--batch-size 24]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time


def make_jpegs(root: str, n: int, size: int, quality: int = 90) -> None:
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(0)
    for i in range(n):
        # low-frequency content so JPEG size/decode cost is photo-like
        base = rng.uniform(0, 255, (size // 8, size // 8, 3))
        img = Image.fromarray(base.astype("uint8"), "RGB").resize(
            (size, size), Image.BILINEAR
        )
        img.save(os.path.join(root, f"img_{i:05d}.jpg"), quality=quality)


def time_epoch(loader) -> tuple[float, int]:
    n_images = 0
    t0 = time.perf_counter()
    for batch in loader:
        if batch is None:
            continue
        n_images += batch["pixel_values"].shape[0]
    return time.perf_counter() - t0, n_images


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--resolution", type=int, default=256)
    parser.add_argument("--num-images", type=int, default=256)
    parser.add_argument("--src-size", type=int, default=512)
    parser.add_argument("--batch-size", type=int, default=24)
    parser.add_argument("--workers", type=str, default="0,2,4")
    parser.add_argument("--image-dir", type=str, default=None,
                        help="existing image folder (skips JPEG generation)")
    return parser.parse_args(argv)


def _measure(root: str, args, native: bool, results: dict, counts: dict) -> None:
    from ..data import native as native_mod
    from ..data.pipeline import DataLoader, load_and_preprocess_dataset

    label = "native" if native else "pil"
    os.environ["VCD_NATIVE_PREPROCESS"] = "1" if native else "0"
    # dataset is rebuilt per variant: the transform binds the native flag at
    # construction (and raises there when the library does not build)
    dataset = load_and_preprocess_dataset(root, resolution=args.resolution)
    for workers in (int(w) for w in args.workers.split(",")):
        loader = DataLoader(dataset, batch_size=args.batch_size, num_workers=workers,
                            shuffle=False)
        time_epoch(loader)  # warm (page cache, thread pools)
        native_mod.reset_counts()
        dt, n = time_epoch(loader)
        ips = n / dt
        key = f"{label}_w{workers}"
        if native:
            seen = dict(native_mod.counts)
            if seen["pil"]:
                key = f"native+pil_w{workers}"
                print(f"# native workers={workers}: {seen['pil']} of {n} images went "
                      "through PIL", file=sys.stderr)
            counts[key] = seen
        results[key] = round(ips, 1)
        print(f"# {label} workers={workers}: {ips:.1f} img/s ({n} images in {dt:.2f}s)",
              file=sys.stderr)


def main(argv=None) -> int:
    args = parse_args(argv)
    from ..data.native import NativeBuildError

    tmp = None
    root = args.image_dir
    if root is None:
        tmp = tempfile.TemporaryDirectory(prefix="loader_bench_")
        root = tmp.name
        make_jpegs(root, args.num_images, args.src_size)

    results: dict = {}
    counts: dict = {}
    before = os.environ.get("VCD_NATIVE_PREPROCESS")
    try:
        for native in (False, True):
            _measure(root, args, native, results, counts)
    except NativeBuildError as e:
        print(f"# native: {e}", file=sys.stderr)
        return 1
    finally:
        if before is None:
            os.environ.pop("VCD_NATIVE_PREPROCESS", None)
        else:
            os.environ["VCD_NATIVE_PREPROCESS"] = before
        if tmp is not None:
            tmp.cleanup()

    print(json.dumps({
        "metric": f"loader_images_per_sec@{args.resolution}px",
        "src_jpeg_px": args.src_size,
        "host_cores": os.cpu_count(),
        "results": results,
        "native_counts": counts,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
