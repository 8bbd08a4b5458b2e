"""The port's own input pipeline (``vae_channel_dynamics_tpu_torch.data``)
against the JAX package's, on the CPU: both are numpy code, so they must give
identical arrays (no tolerance) for the same names, seeds and epochs."""

import numpy as np
import pytest
import torch

from vae_channel_dynamics_tpu import data as jdata
from vae_channel_dynamics_tpu.data import synthetic as jsyn
from vae_channel_dynamics_tpu_torch import data as tdata
from vae_channel_dynamics_tpu_torch.data import pipeline as tpipe
from vae_channel_dynamics_tpu_torch.data import synthetic as tsyn


@pytest.mark.parametrize("kind", ["noise", "gradients", "shapes", "highres"])
@pytest.mark.parametrize("split", ["train", "test", "custom"])
def test_synthetic_items_match_jax(kind, split):
    ours = tsyn.SyntheticImageDataset(kind=kind, num_samples=5, resolution=24, seed=3,
                                      split=split)
    theirs = jsyn.SyntheticImageDataset(kind=kind, num_samples=5, resolution=24, seed=3,
                                        split=split)
    for i in range(5):
        np.testing.assert_array_equal(ours[i]["pixel_values"], theirs[i]["pixel_values"])


@pytest.mark.parametrize("name", ["synthetic://shapes?num_samples=9",
                                  "synthetic://noise?num_samples=4&seed=2", "synthetic"])
def test_parse_synthetic_name_matches_jax(name):
    assert tsyn.parse_synthetic_name(name) == jsyn.parse_synthetic_name(name)


@pytest.mark.parametrize("transfer_dtype", ["float32", "uint8"])
@pytest.mark.parametrize("shuffle,drop_last,workers", [(True, False, 0), (False, True, 2),
                                                      (True, True, 2)])
def test_loader_batches_match_jax(transfer_dtype, shuffle, drop_last, workers):
    kw = dict(dataset_name="synthetic://shapes", resolution=16, max_samples=11, seed=5,
              transfer_dtype=transfer_dtype)
    ours = tdata.create_dataloader(tdata.load_and_preprocess_dataset(**kw), batch_size=4,
                                   num_workers=workers, shuffle=shuffle, seed=5,
                                   drop_last=drop_last)
    theirs = jdata.create_dataloader(jdata.load_and_preprocess_dataset(**kw), batch_size=4,
                                     num_workers=workers, shuffle=shuffle, seed=5,
                                     drop_last=drop_last)
    assert len(ours) == len(theirs)
    for epoch in (0, 1, 3):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        got = list(ours.iter_batches(start_batch=1))
        want = list(theirs.iter_batches(start_batch=1))
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            assert a["pixel_values"].dtype == b["pixel_values"].dtype
            np.testing.assert_array_equal(a["pixel_values"], b["pixel_values"])


def test_streaming_loader_matches_jax():
    kw = dict(dataset_name="synthetic://noise", resolution=8, max_samples=7, seed=1,
              streaming=True)
    ours = tdata.create_dataloader(tdata.load_and_preprocess_dataset(**kw), batch_size=3)
    theirs = jdata.create_dataloader(jdata.load_and_preprocess_dataset(**kw), batch_size=3)
    assert ours.is_iterable and theirs.is_iterable
    for a, b in zip(list(ours), list(theirs), strict=True):
        np.testing.assert_array_equal(a["pixel_values"], b["pixel_values"])


@pytest.mark.parametrize("size,mode", [((40, 30), "RGB"), ((17, 64), "L"), ((32, 32), "RGBA")])
def test_transform_matches_jax_on_pil_images(size, mode):
    from PIL import Image

    rng = np.random.default_rng(sum(size))
    channels = {"RGB": 3, "L": 1, "RGBA": 4}[mode]
    arr = rng.integers(0, 256, (size[1], size[0], channels), dtype=np.uint8)
    img = Image.fromarray(arr[..., 0] if channels == 1 else arr, mode)
    out = tdata.get_transform(16)(img)
    np.testing.assert_array_equal(out, jdata.get_transform(16)(img))
    assert out.shape == (16, 16, 3) and out.dtype == np.float32


def test_transform_matches_jax_on_encoded_bytes(tmp_path):
    from PIL import Image

    arr = np.random.default_rng(0).integers(0, 256, (20, 28, 3), dtype=np.uint8)
    path = tmp_path / "img.png"
    Image.fromarray(arr).save(path)
    body = path.read_bytes()
    np.testing.assert_array_equal(tdata.get_transform(12)(body),
                                  jdata.get_transform(12)(body))
    np.testing.assert_array_equal(tdata.get_transform(12)(str(path)),
                                  jdata.get_transform(12)(str(path)))


def test_native_preprocess_is_refused(monkeypatch):
    monkeypatch.setenv("VCD_NATIVE_PREPROCESS", "1")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tdata.get_transform(16)


def test_prefetcher_moves_arrays_to_the_device_and_keeps_order():
    batches = [{"pixel_values": np.full((2, 4, 4, 3), i, np.uint8), "n": i} for i in range(5)]
    with tpipe.Prefetcher(iter(batches), device="cpu", depth=2) as pre:
        got = list(pre)
    assert [b["n"] for b in got] == list(range(5))
    for i, b in enumerate(got):
        assert isinstance(b["pixel_values"], torch.Tensor)
        assert b["pixel_values"].dtype == torch.uint8 and int(b["pixel_values"][0, 0, 0, 0]) == i


def test_prefetcher_reraises_a_failed_source():
    def source():
        yield {"pixel_values": np.zeros((1, 2, 2, 3), np.float32)}
        raise OSError("disk gone")

    pre = tpipe.Prefetcher(source(), device="cpu")
    assert next(pre)["pixel_values"].shape == (1, 2, 2, 3)
    with pytest.raises(RuntimeError, match="mid-stream"):
        next(pre)
    pre.close()
