"""Input pipeline: dataset loading, preprocessing, batching, prefetch.

The port's own copy of ``vae_channel_dynamics_tpu/data/pipeline.py``: the
same transform, sources, loader order and collate, so both packages see the
same batches for the same seed and epoch, and ``VCD_NATIVE_PREPROCESS=1``
runs the same native C++ decode and resize (``data/native.py``). Two
differences: :class:`Prefetcher` stages each batch in pinned host memory and
copies it to the device with ``non_blocking=True`` from its worker thread;
and a native library that does not build raises instead of falling back to
PIL.

Behavioral contract (reference: src/data_utils.py):
- transform = shorter-side bilinear resize -> center crop -> RGB ->
  normalize to [-1, 1] (data_utils.py:24-30), applied lazily per item
- image-column fallback ``image`` <-> ``img`` (data_utils.py:87-94)
- ``max_samples`` takes the first N (data_utils.py:97-115)
- bad records are dropped at collate; a fully-bad batch yields ``None``
  (data_utils.py:197-215)

Batches are NHWC float32 (or uint8) numpy; the device transfer is
``Prefetcher``'s. Sources are pluggable (HF datasets when reachable, local
image folders, tar shards, ``synthetic://`` names).
"""

from __future__ import annotations

import logging
import os
import threading
import queue as queue_mod
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from .synthetic import SyntheticImageDataset, parse_synthetic_name

logger = logging.getLogger(__name__)

_IMAGE_EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")


# --------------------------------------------------------------------------- #
# Transform
# --------------------------------------------------------------------------- #
def get_transform(resolution: int) -> Callable[[Any], np.ndarray]:
    """Shorter-side bilinear resize -> center crop -> RGB -> [-1, 1] HWC
    float32 (torchvision-pipeline parity, data_utils.py:24-30).

    With ``VCD_NATIVE_PREPROCESS=1`` the decode, resize, crop and normalize
    run in the fused C++ kernels (``data/native.py``), as in the JAX
    package: encoded JPEG/PNG bytes (raw, a path, or a still-lazy
    file-backed PIL image) through ``decode_preprocess``
    (``VCD_NATIVE_DCT_SCALE``, default 1, lets libjpeg decode at a reduced
    size), decoded uint8 arrays through ``preprocess_image``, and what
    neither takes (a CMYK JPEG, another container) through PIL, one image
    at a time. ``native.counts`` records each image's path. Where the
    library does not build, this raises :class:`native.NativeBuildError`
    (the JAX package warns and uses PIL)."""
    from PIL import Image

    native_mod = None
    decode = False
    if os.environ.get("VCD_NATIVE_PREPROCESS", "0") == "1":
        from . import native as native_mod

        native_mod.get_lib()  # raises NativeBuildError, naming the compiler commands
        decode = native_mod.decode_available()
    dct_scaling = os.environ.get("VCD_NATIVE_DCT_SCALE", "1") == "1"

    def _raw_bytes(img) -> Optional[bytes]:
        """Encoded JPEG/PNG bytes for the fused native decode, when the item
        is raw bytes, a path, or a still-lazy file-backed PIL image (PIL
        closes ``fp`` on load, so an open fp means the pixels are untouched
        and re-reading the file is exact)."""
        if isinstance(img, bytes):
            return img
        path = None
        if isinstance(img, str):
            path = img
        elif (
            isinstance(img, Image.Image)
            and getattr(img, "fp", None) is not None
            and getattr(img, "filename", "")
        ):
            path = img.filename
        if path and path.lower().endswith((".jpg", ".jpeg", ".png")):
            try:
                with open(path, "rb") as f:
                    return f.read()
            except OSError:
                return None
        return None

    def transform(img) -> np.ndarray:
        if native_mod is None:
            return _pil_transform(img)
        if decode:
            raw = _raw_bytes(img)
            if raw is not None:
                try:
                    out = native_mod.decode_preprocess(raw, resolution, dct_scaling=dct_scaling)
                except RuntimeError:
                    pass  # a container or colour space the decoder does not take -> PIL
                else:
                    native_mod.count("decode")
                    return out
        arr = np.asarray(img) if isinstance(img, Image.Image) else img
        if isinstance(arr, np.ndarray) and arr.dtype == np.uint8 and (
            arr.ndim == 2 or (arr.ndim == 3 and arr.shape[2] in (1, 3))
        ):
            native_mod.count("preprocess")
            return native_mod.preprocess_image(arr, resolution)
        native_mod.count("pil")
        return _pil_transform(img)

    def _pil_transform(img) -> np.ndarray:
        if isinstance(img, bytes):
            import io

            img = Image.open(io.BytesIO(img))
        elif isinstance(img, str):
            img = Image.open(img)
        if isinstance(img, np.ndarray):
            arr = img
            if arr.dtype == np.uint8:
                img = Image.fromarray(arr)
            else:  # already float, assume preprocessed HWC [-1, 1]
                return arr.astype(np.float32)
        if not isinstance(img, Image.Image):
            raise TypeError(f"Unsupported image type: {type(img)}")
        if img.mode != "RGB":
            img = img.convert("RGB")
        w, h = img.size
        short = min(w, h)
        if short != resolution:
            # torchvision T.Resize semantics (the reference transform,
            # data_utils.py:24-30): short side = resolution, long side
            # TRUNCATED via int() — round() would differ by 1px for any
            # aspect ratio whose scaled long side has fraction >= 0.5,
            # shifting the center crop off the reference's pixels
            if w <= h:
                new_w, new_h = resolution, int(resolution * h / w)
            else:
                new_w, new_h = int(resolution * w / h), resolution
            img = img.resize((new_w, new_h), Image.BILINEAR)
        w, h = img.size
        left = (w - resolution) // 2
        top = (h - resolution) // 2
        img = img.crop((left, top, left + resolution, top + resolution))
        arr = np.asarray(img, dtype=np.float32) / 255.0
        return (arr - 0.5) / 0.5  # HWC in [-1, 1]

    return transform


# --------------------------------------------------------------------------- #
# Sources
# --------------------------------------------------------------------------- #
class TransformedDataset:
    """Map-style dataset applying the transform lazily; returns ``None`` for
    items that fail to load/transform (dropped at collate)."""

    def __init__(self, source, image_column: str, transform):
        self.source = source
        self.image_column = image_column
        self.transform = transform

    def __len__(self) -> int:
        return len(self.source)

    def __getitem__(self, index: int) -> Optional[Dict[str, np.ndarray]]:
        try:
            item = self.source[index]
            img = item[self.image_column]
            return {"pixel_values": self.transform(img)}
        except Exception as e:  # noqa: BLE001 — mirror drop-bad-record behavior
            logger.warning("Dropping bad record %d: %s", index, e)
            return None


class IterableTransformedDataset:
    """Streaming (iterable-only) dataset: applies the transform on the fly;
    no ``__len__`` (the trainer then sizes epochs from
    ``training.max_steps_per_epoch_iterable``, mirroring src/train.py:188-192)."""

    def __init__(self, source, image_column: str, transform):
        self.source = source
        self.image_column = image_column
        self.transform = transform

    def __iter__(self):
        for item in self.source:
            try:
                yield {"pixel_values": self.transform(item[self.image_column])}
            except Exception as e:  # noqa: BLE001
                logger.warning("Dropping bad streamed record: %s", e)


class StreamingView:
    """Iterable (no-``__len__``) view of a map-style dataset, in index
    order. Gives ``data.streaming: true`` a deterministic offline stand-in
    for ``synthetic://`` names, so the trainer's streaming code paths —
    unknown epoch length, consume-skip resume — are exercisable without
    network access (HF streaming datasets hit the identical paths)."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __iter__(self):
        for i in range(len(self.dataset)):
            yield self.dataset[i]


class TarShardSource:
    """Map-style source over WebDataset-style tar shards.

    Production image datasets ship as tar shards, not million-file folders;
    this reads a single ``.tar`` or every ``*.tar`` under a directory.
    Member headers are indexed once at construction (one sequential pass per
    shard); items are extracted lazily as raw bytes. Extraction uses
    one open TarFile per (thread, shard) — ``tarfile`` objects are not
    thread-safe, and loader workers read concurrently."""

    def __init__(self, path: str):
        import tarfile

        if os.path.isdir(path):
            self.shards = sorted(
                os.path.join(path, f)
                for f in os.listdir(path)
                if f.endswith(".tar")
            )
        else:
            self.shards = [path]
        if not self.shards:
            raise ValueError(f"No .tar shards under {path}")
        self.index: List[tuple] = []  # (shard_idx, member_name)
        for si, shard in enumerate(self.shards):
            with tarfile.open(shard, "r") as tf:
                for member in tf:
                    if member.isfile() and member.name.lower().endswith(
                        _IMAGE_EXTENSIONS
                    ):
                        self.index.append((si, member.name))
        if not self.index:
            raise ValueError(f"No image members in shards under {path}")
        self._local = threading.local()
        logger.info(
            "Tar dataset: %d image(s) across %d shard(s)",
            len(self.index), len(self.shards),
        )

    def _open(self, shard_idx: int):
        import tarfile

        cache = getattr(self._local, "tars", None)
        if cache is None:
            cache = self._local.tars = {}
        tf = cache.get(shard_idx)
        if tf is None:
            tf = cache[shard_idx] = tarfile.open(self.shards[shard_idx], "r")
        return tf

    def __len__(self) -> int:
        return len(self.index)

    def __getitem__(self, index: int) -> Dict[str, Any]:
        shard_idx, name = self.index[index]
        fobj = self._open(shard_idx).extractfile(name)
        if fobj is None:
            raise OSError(f"unreadable tar member {name}")
        return {"image": fobj.read()}


class ImageFolderSource:
    """Local directory of images (recursive), an offline stand-in for HF
    imagefolder datasets."""

    def __init__(self, root: str):
        self.paths: List[str] = []
        for dirpath, _dirnames, filenames in os.walk(root):
            for fn in sorted(filenames):
                if fn.lower().endswith(_IMAGE_EXTENSIONS):
                    self.paths.append(os.path.join(dirpath, fn))
        if not self.paths:
            raise ValueError(f"No images found under {root}")

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, index: int) -> Dict[str, Any]:
        from PIL import Image

        return {"image": Image.open(self.paths[index])}


def quantize_uint8(x: np.ndarray) -> np.ndarray:
    """[-1, 1] float pixels -> uint8. This is the quantization the reference
    pipeline applies implicitly (PIL resize outputs uint8 images before
    ToTensor/Normalize, src/data_utils.py:24-30); with
    ``data.transfer_dtype: uint8`` batches cross host->device at 1/4 the
    bytes and the train step dequantizes on device."""
    return np.clip(np.round((x + 1.0) * 127.5), 0.0, 255.0).astype(np.uint8)


class QuantizedUint8Dataset:
    """View of a dataset whose items' pixel_values are quantized to uint8."""

    def __init__(self, inner):
        self.inner = inner

    def __len__(self) -> int:
        return len(self.inner)

    def _convert(self, item):
        if item is None or item.get("pixel_values") is None:
            return item
        return {**item, "pixel_values": quantize_uint8(item["pixel_values"])}

    def __getitem__(self, index: int):
        return self._convert(self.inner[index])

    def __iter__(self):
        for item in self.inner:
            yield self._convert(item)


def load_and_preprocess_dataset(
    dataset_name: str,
    dataset_config_name: Optional[str] = None,
    image_column: str = "image",
    resolution: int = 256,
    max_samples: Optional[int] = None,
    split: str = "train",
    streaming: bool = False,
    cache_dir: Optional[str] = None,
    seed: int = 0,
    transfer_dtype: str = "float32",
):
    """Resolve a dataset name to items of ``{"pixel_values": ...}``.

    ``transfer_dtype="uint8"`` wraps the result so pixel_values are uint8
    (4x smaller host->device transfers; the train/eval steps dequantize on
    device; numerics then match the reference's uint8-resize pipeline
    exactly)."""
    ds = _resolve_dataset(
        dataset_name,
        dataset_config_name=dataset_config_name,
        image_column=image_column,
        resolution=resolution,
        max_samples=max_samples,
        split=split,
        streaming=streaming,
        cache_dir=cache_dir,
        seed=seed,
    )
    if streaming:
        # honor data.streaming for EVERY source kind: HF streaming loads
        # are natively iterable, but synthetic://, image folders, tar
        # shards, and the offline synthetic fallback resolve map-style —
        # wrap those in the iterable view so a streaming config actually
        # exercises streaming semantics (unknown epoch length,
        # consume-skip resume) instead of silently training map-style
        try:
            len(ds)
        except TypeError:
            pass
        else:
            ds = StreamingView(ds)
    if transfer_dtype in ("uint8", "u8"):
        return QuantizedUint8Dataset(ds)
    if transfer_dtype not in ("float32", "f32", None, ""):
        raise ValueError(
            f"data.transfer_dtype must be float32 or uint8, got "
            f"{transfer_dtype!r}"
        )
    return ds


def _resolve_dataset(
    dataset_name: str,
    dataset_config_name: Optional[str] = None,
    image_column: str = "image",
    resolution: int = 256,
    max_samples: Optional[int] = None,
    split: str = "train",
    streaming: bool = False,
    cache_dir: Optional[str] = None,
    seed: int = 0,
):
    """Resolve a dataset name to a map-style dataset of
    ``{"pixel_values": HWC float32 [-1, 1]}`` items.

    Resolution order:
    1. ``synthetic://...`` names -> SyntheticImageDataset
    2. an existing local directory -> ImageFolderSource
    3. HF ``datasets.load_dataset`` (works offline only with a warm cache)

    With ``VCD_DATA_FALLBACK=synthetic`` a failed HF load falls back to
    synthetic data with a loud warning instead of raising, so reference
    configs remain runnable in network-isolated environments.
    """
    syn = parse_synthetic_name(dataset_name)
    if syn is not None:
        num = max_samples or int(syn.get("num_samples", 256))
        ds = SyntheticImageDataset(
            kind=syn["kind"],
            num_samples=num,
            resolution=resolution,
            seed=seed + int(syn.get("seed", 0)),
            split=split,
        )
        logger.info(
            "Synthetic dataset '%s': %d samples @%dpx (%s split)",
            syn["kind"], len(ds), resolution, split,
        )
        return ds

    transform = get_transform(resolution)

    is_tar = str(dataset_name).endswith(".tar") or (
        os.path.isdir(dataset_name)
        and any(f.endswith(".tar") for f in os.listdir(dataset_name))
    )
    if is_tar and (
        os.path.isfile(dataset_name) or os.path.isdir(dataset_name)
    ):
        source = TarShardSource(dataset_name)
        if max_samples is not None and max_samples < len(source):
            source.index = source.index[:max_samples]
        return TransformedDataset(source, "image", transform)

    if os.path.isdir(dataset_name):
        source = ImageFolderSource(dataset_name)
        if max_samples is not None and max_samples < len(source):
            source.paths = source.paths[:max_samples]
        logger.info("Image folder dataset: %d files", len(source))
        return TransformedDataset(source, "image", transform)

    try:
        import datasets as hf_datasets

        dataset = hf_datasets.load_dataset(
            dataset_name,
            name=dataset_config_name,
            split=split,
            streaming=streaming,
            cache_dir=cache_dir,
        )
        if image_column not in dataset.features:
            alt = "img" if image_column == "image" else "image"
            if alt in dataset.features:
                logger.warning(
                    "Image column '%s' not found; using '%s'", image_column, alt
                )
                image_column = alt
            else:
                raise ValueError(
                    f"Image column '{image_column}' not in features: "
                    f"{list(dataset.features)}"
                )
        if streaming:
            if max_samples is not None:
                dataset = dataset.take(max_samples)
            return IterableTransformedDataset(dataset, image_column, transform)
        if max_samples is not None:
            if max_samples <= len(dataset):
                dataset = dataset.select(range(max_samples))
            else:
                logger.warning(
                    "max_samples (%d) > dataset size (%d); using full dataset",
                    max_samples, len(dataset),
                )
        return TransformedDataset(dataset, image_column, transform)
    except Exception as e:  # noqa: BLE001
        fallback = os.environ.get("VCD_DATA_FALLBACK", "")
        if fallback == "synthetic":
            logger.error(
                "FALLING BACK TO SYNTHETIC DATA: failed to load '%s' (%s). "
                "Metrics will NOT be comparable to real-data runs.",
                dataset_name, e,
            )
            return SyntheticImageDataset(
                kind="shapes",
                num_samples=max_samples or 256,
                resolution=resolution,
                seed=seed,
                split=split,
            )
        raise


# --------------------------------------------------------------------------- #
# Loader
# --------------------------------------------------------------------------- #
class DataLoader:
    """Minimal epoch-aware batching loader over a map-style dataset.

    Collate semantics mirror safe_collate (data_utils.py:197-215): bad items
    are dropped; a fully-bad batch yields ``None``. Shuffling reshuffles
    every epoch with a per-epoch seed. ``num_workers`` threads overlap the
    per-item transform work (PIL decode/resize) with consumption.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        num_workers: int = 0,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = False,
        shard_index: int = 0,
        num_shards: int = 1,
    ):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.num_workers = int(num_workers)
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        # multi-host: each process reads a disjoint slice of every epoch's
        # (identically seeded) permutation, so the union covers the dataset
        self.shard_index = int(shard_index)
        self.num_shards = int(num_shards)
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    @property
    def is_iterable(self) -> bool:
        # probe by calling len, not hasattr: wrapper datasets (e.g. the
        # uint8-transfer view) define __len__ that delegates to an inner
        # dataset which may itself be iterable-only
        try:
            len(self.dataset)
            return False
        except TypeError:
            return True

    def _shard_len(self) -> int:
        """Items THIS shard iterates: the strided slice of the epoch order
        (see ``_order``), not the full dataset."""
        n = len(self.dataset)
        if self.num_shards > 1:
            n = (n - self.shard_index + self.num_shards - 1) // self.num_shards
        return n

    def __len__(self) -> int:
        """Batches per epoch FOR THIS SHARD. Counting the full dataset here
        would make a sharded loader iterate num_shards x too many batches:
        the trailing ones collate empty (None) and the per-shard partial
        batch escapes drop_last — an SPMD shape hazard on multi-host."""
        if self.is_iterable:
            raise TypeError("Iterable (streaming) dataset has no length")
        n = self._shard_len()
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _order(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, self._epoch])
            )
            order = rng.permutation(n)
        else:
            order = np.arange(n)
        if self.num_shards > 1:
            order = order[self.shard_index :: self.num_shards]
        return order

    def _fetch(self, index: int):
        try:
            return self.dataset[int(index)]
        except Exception as e:  # noqa: BLE001
            logger.warning("DataLoader: dropping index %d (%s)", index, e)
            return None

    def _collate(self, items: List[Optional[Dict[str, np.ndarray]]]):
        good = [
            it["pixel_values"]
            for it in items
            if it is not None and it.get("pixel_values") is not None
        ]
        if len(good) < len(items):
            logger.warning(
                "Collate dropped %d bad item(s)", len(items) - len(good)
            )
        if not good:
            return None
        batch = np.stack(good)
        if batch.dtype not in (np.float32, np.uint8):
            batch = batch.astype(np.float32)
        return {"pixel_values": batch}

    def _iter_streaming(self) -> Iterator[Optional[Dict[str, np.ndarray]]]:
        if self.shuffle and not getattr(self, "_warned_shuffle", False):
            # once per loader, not once per epoch: the trainer always
            # requests shuffle and streaming epochs are many
            self._warned_shuffle = True
            logger.warning("Shuffle has no effect for streaming datasets.")
        buf: List[Dict[str, np.ndarray]] = []
        for i, item in enumerate(self.dataset):
            if self.num_shards > 1 and i % self.num_shards != self.shard_index:
                continue
            if item is not None and item.get("pixel_values") is not None:
                buf.append(item)
            if len(buf) == self.batch_size:
                yield self._collate(buf)
                buf = []
        if buf and not self.drop_last:
            yield self._collate(buf)

    def __iter__(self) -> Iterator[Optional[Dict[str, np.ndarray]]]:
        yield from self.iter_batches()

    def iter_batches(
        self, start_batch: int = 0
    ) -> Iterator[Optional[Dict[str, np.ndarray]]]:
        """Iterate the epoch's batches, optionally starting mid-epoch.

        ``start_batch`` is the resume fast-forward for map-style datasets:
        the epoch's (seeded) permutation is computed as usual and the first
        N batches are skipped at the INDEX level — no decode, no transform —
        so resuming deep into an epoch costs O(1) instead of re-decoding
        every already-consumed image. Only valid for map-style datasets
        (streaming has no random access; the caller consume-skips instead).
        """
        if self.is_iterable:
            if start_batch:
                raise TypeError(
                    "iter_batches(start_batch>0) requires a map-style "
                    "dataset; streaming datasets must consume-skip"
                )
            yield from self._iter_streaming()
            return
        order = self._order()
        n_batches = len(self)
        self._epoch += 1

        def batch_indices(b: int) -> np.ndarray:
            return order[b * self.batch_size : (b + 1) * self.batch_size]

        start = min(int(start_batch), n_batches)
        if self.num_workers <= 0:
            for b in range(start, n_batches):
                yield self._collate([self._fetch(i) for i in batch_indices(b)])
            return

        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            pending: "queue_mod.Queue" = queue_mod.Queue()
            depth = 2  # batches in flight

            def submit(b: int) -> None:
                futures = [pool.submit(self._fetch, i) for i in batch_indices(b)]
                pending.put(futures)

            for b in range(start, min(start + depth, n_batches)):
                submit(b)
            for b in range(start, n_batches):
                futures = pending.get()
                if b + depth < n_batches:
                    submit(b + depth)
                yield self._collate([f.result() for f in futures])


def create_dataloader(
    dataset,
    batch_size: int,
    num_workers: int = 0,
    shuffle: bool = True,
    seed: int = 0,
    drop_last: bool = False,
    shard_index: int = 0,
    num_shards: int = 1,
) -> DataLoader:
    logger.info(
        "Creating DataLoader (batch=%d, shuffle=%s, workers=%d, shard %d/%d)",
        batch_size, shuffle, num_workers, shard_index, num_shards,
    )
    return DataLoader(
        dataset,
        batch_size=batch_size,
        num_workers=num_workers,
        shuffle=shuffle,
        seed=seed,
        drop_last=drop_last,
        shard_index=shard_index,
        num_shards=num_shards,
    )


class Prefetcher:
    """Background-thread device prefetch: a worker thread draws batches
    (dicts of numpy arrays, or None) from ``iterator`` ahead of consumption,
    stages every array in pinned host memory and copies it to ``device``
    with ``non_blocking=True``, so host batch assembly and the host-to-device
    copy overlap the device's compute (the reference's pin_memory,
    data_utils.py:218-225). The copies are issued on the device's current
    stream, so the step that consumes a batch is ordered after its copy.
    Items that are not arrays pass through unchanged. With ``device=None``
    items pass through untouched; a CPU device gets tensors that share the
    arrays' memory."""

    def __init__(self, iterator: Iterator, device=None, depth: int = 2):
        self.device = None if device is None else torch.device(device)
        self._queue: "queue_mod.Queue" = queue_mod.Queue(maxsize=depth)
        self._sentinel = object()
        self._error: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._worker, args=(iterator,), daemon=True
        )
        self._thread.start()

    def _to_device(self, value):
        if not isinstance(value, np.ndarray):
            return value
        tensor = torch.from_numpy(np.ascontiguousarray(value))
        if self.device.type == "cpu":
            return tensor
        return tensor.pin_memory().to(self.device, non_blocking=True)

    def _put(self, item) -> bool:
        """Enqueue unless a close() raced in; never blocks forever."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue_mod.Full:
                continue
        return False

    def _worker(self, iterator: Iterator) -> None:
        try:
            for batch in iterator:
                if batch is not None and self.device is not None:
                    batch = {k: self._to_device(v) for k, v in batch.items()}
                if not self._put(batch):
                    break
        except BaseException as e:  # noqa: BLE001 — re-raised in __next__
            # a crashed source must NOT look like a clean end-of-epoch: the
            # consumer would otherwise checkpoint a silently truncated run
            # and keep training on it
            self._error = e
        finally:
            self._put(self._sentinel)
            # unwind the source (e.g. a generator holding a DataLoader's
            # thread pool open) now that no more items will be drawn
            close = getattr(iterator, "close", None)
            if close is not None:
                try:
                    close()
                except Exception:  # noqa: BLE001 — teardown best-effort
                    logger.debug("Prefetcher source close failed", exc_info=True)

    def close(self) -> None:
        """Stop the worker thread and release the source iterator. Safe to
        call more than once and after exhaustion; consumers that break out
        of iteration early (e.g. at max_train_steps, training/loop.py) must
        call this or the worker stays parked on a full queue."""
        self._stop.set()
        self._thread.join(timeout=10.0)
        if self._thread.is_alive():  # pragma: no cover — diagnostics only
            logger.warning("Prefetcher worker did not exit within 10s")

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False

    def __iter__(self):
        return self

    def __next__(self):
        if self._stop.is_set():
            raise StopIteration
        item = self._queue.get()
        if item is self._sentinel:
            if self._error is not None:
                error, self._error = self._error, None
                raise RuntimeError(
                    "Prefetcher source iterator failed mid-stream"
                ) from error
            raise StopIteration
        return item
