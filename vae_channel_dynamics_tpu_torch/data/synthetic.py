"""Deterministic synthetic image datasets.

The port's own copy of ``vae_channel_dynamics_tpu/data/synthetic.py``: the
same items, bit for bit, for the same name, seed and index.

The reference pulls everything from the HF Hub (src/data_utils.py:66-72); in
network-isolated environments (and for benchmarking, where input IO must not
confound device throughput) we need a data source with the same interface
but locally generated content. Addressed as ``synthetic://<kind>`` dataset
names, e.g. ``synthetic://shapes?num_samples=512``.

Kinds:
- ``noise``      seeded uniform noise
- ``gradients``  smooth per-sample color gradients
- ``shapes``     random rectangles/disks on gradient backgrounds (default;
                 has actual spatial structure for the VAE to reconstruct)
"""

from __future__ import annotations

from typing import Dict, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np


def parse_synthetic_name(name: str) -> Optional[Dict[str, str]]:
    """Return {kind, **query} for synthetic dataset names, else None."""
    if not name or not name.startswith("synthetic"):
        return None
    if "://" in name:
        parsed = urlparse(name)
        kind = parsed.netloc or parsed.path.lstrip("/") or "shapes"
        query = {k: v[0] for k, v in parse_qs(parsed.query).items()}
    else:
        # bare "synthetic" or "synthetic/<kind>"
        parts = name.split("/", 1)
        kind = parts[1] if len(parts) > 1 else "shapes"
        query = {}
    return {"kind": kind, **query}


class SyntheticImageDataset:
    """Map-style dataset yielding {"pixel_values": HWC float32 in [-1, 1]}.

    Fully deterministic in (seed, index): every worker/host generates
    identical content for the same index, so data-parallel sharding by index
    range is reproducible.
    """

    def __init__(
        self,
        kind: str = "shapes",
        num_samples: int = 256,
        resolution: int = 64,
        channels: int = 3,
        seed: int = 0,
        split: str = "train",
    ):
        self.kind = kind
        self.num_samples = int(num_samples)
        self.resolution = int(resolution)
        self.channels = channels
        # distinct content per split — salted via a STABLE hash: Python's
        # hash() is PYTHONHASHSEED-salted per process, which would generate
        # different data per host (and per rerun) for non-standard split
        # names, breaking the every-worker-identical determinism guarantee
        import zlib

        self.seed = seed + {"train": 0, "validation": 7919, "test": 104729}.get(
            split, zlib.crc32(split.encode("utf-8")) % 100003
        )

    def __len__(self) -> int:
        return self.num_samples

    def _rng(self, index: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, index])
        )

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        if not 0 <= index < self.num_samples:
            raise IndexError(index)
        r = self.resolution
        rng = self._rng(index)
        if self.kind == "noise":
            img = rng.uniform(-1.0, 1.0, (r, r, self.channels))
        elif self.kind == "gradients":
            img = self._gradient(rng, r)
        else:  # shapes (default)
            img = self._gradient(rng, r)
            for _ in range(int(rng.integers(2, 6))):
                self._paint_shape(rng, img)
        return {"pixel_values": img.astype(np.float32)}

    def _gradient(self, rng: np.random.Generator, r: int) -> np.ndarray:
        yy, xx = np.mgrid[0:r, 0:r].astype(np.float32) / max(r - 1, 1)
        img = np.zeros((r, r, self.channels), np.float32)
        for c in range(self.channels):
            a, b, bias = rng.uniform(-1, 1, 3)
            img[..., c] = np.clip(a * xx + b * yy + 0.5 * bias, -1.0, 1.0)
        return img

    def _paint_shape(self, rng: np.random.Generator, img: np.ndarray) -> None:
        r = img.shape[0]
        color = rng.uniform(-1.0, 1.0, self.channels).astype(np.float32)
        cy, cx = rng.integers(0, r, 2)
        size = int(rng.integers(max(2, r // 8), max(3, r // 2)))
        if rng.random() < 0.5:  # rectangle
            y0, y1 = max(0, cy - size // 2), min(r, cy + size // 2)
            x0, x1 = max(0, cx - size // 2), min(r, cx + size // 2)
            img[y0:y1, x0:x1] = color
        else:  # disk
            yy, xx = np.mgrid[0:r, 0:r]
            mask = (yy - cy) ** 2 + (xx - cx) ** 2 <= (size // 2) ** 2
            img[mask] = color
