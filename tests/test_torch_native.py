"""The port's native decode and preprocess (``data/native.py``) on the CPU.

The port builds its own copies of ``csrc/preprocess.cpp`` and
``csrc/decode.cpp`` with the JAX package's g++ flags, so on the same
machine its results are bit-equal to the JAX package's ``data.native``;
both stay within the JAX test's bounds of the PIL transform
(``tests/test_native_preprocess.py``: mean < 0.02, max < 0.25). The native
transform counts each image's path, sends what the decoder does not take to
PIL, and raises where the library does not build. The library lands in
``build/torch_kernels/`` under a hashed name and never touches the JAX
package's ``build/libvcdprep.so``.
"""

import io
import os
import re

import numpy as np
import pytest
import torch
from PIL import Image

from vae_channel_dynamics_tpu.data import native as jax_native
from vae_channel_dynamics_tpu.data.pipeline import get_transform as jax_get_transform
from vae_channel_dynamics_tpu_torch.data import native
from vae_channel_dynamics_tpu_torch.data.pipeline import get_transform

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread, as the other port test files keep it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_lib():
    if not jax_native.available():
        pytest.skip("the JAX package's native library is unavailable (no g++?)")
    return jax_native


def _smooth(seed, h, w, channels=3):
    """A smooth image, so that resampling differences stay small."""
    base = np.random.default_rng(seed).uniform(0, 255, (h // 16, w // 16, channels))
    img = np.kron(base, np.ones((16, 16, 1))).astype(np.uint8)
    return img[..., 0] if channels == 1 else img


def _encoded(img, fmt):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, fmt, **({"quality": 90} if fmt == "JPEG" else {}))
    return buf.getvalue()


def test_constant_image_exact():
    out = native.preprocess_image(np.full((48, 64, 3), 200, np.uint8), 16)
    assert out.shape == (16, 16, 3)
    np.testing.assert_allclose(out, (200 / 255 - 0.5) / 0.5, atol=1e-6)


def test_grayscale_broadcasts_to_three_channels():
    out = native.preprocess_image(np.full((32, 32), 128, np.uint8), 8)
    assert out.shape == (8, 8, 3)
    np.testing.assert_array_equal(out[..., 0], out[..., 1])
    np.testing.assert_array_equal(out[..., 0], out[..., 2])


@pytest.mark.parametrize("shape,res", [((128, 160, 3), 64), ((96, 80, 3), 32),
                                       ((64, 64, 1), 48)])
def test_preprocess_is_bit_equal_to_jax(jax_lib, shape, res):
    img = _smooth(sum(shape), *shape)
    np.testing.assert_array_equal(native.preprocess_image(img, res),
                                  jax_lib.preprocess_image(img, res))


@pytest.mark.parametrize("fmt", ["JPEG", "PNG"])
@pytest.mark.parametrize("dct_scaling", [True, False])
def test_decode_is_bit_equal_to_jax(jax_lib, fmt, dct_scaling):
    data = _encoded(_smooth(3, 256, 192), fmt)
    out = native.decode_preprocess(data, 48, dct_scaling=dct_scaling)
    assert out.shape == (48, 48, 3)
    np.testing.assert_array_equal(out, jax_lib.decode_preprocess(data, 48,
                                                                 dct_scaling=dct_scaling))


@pytest.mark.parametrize("path", ["preprocess", "decode"])
def test_within_the_jax_tests_bounds_of_pil(monkeypatch, path):
    monkeypatch.delenv("VCD_NATIVE_PREPROCESS", raising=False)
    img = _smooth(0, 128, 160)
    ref = get_transform(64)(Image.fromarray(img))
    if path == "preprocess":
        out = native.preprocess_image(img, 64)
    else:
        out = native.decode_preprocess(_encoded(img, "PNG"), 64)
    assert out.shape == ref.shape
    assert np.mean(np.abs(out - ref)) < 0.02
    assert np.max(np.abs(out - ref)) < 0.25


def test_native_transform_equals_the_jax_transform(jax_lib, monkeypatch, tmp_path):
    files = []
    for i, (fmt, ext) in enumerate([("JPEG", "jpg"), ("PNG", "png"), ("JPEG", "jpeg")]):
        path = tmp_path / f"img{i}.{ext}"
        path.write_bytes(_encoded(_smooth(10 + i, 96 + 32 * i, 128), fmt))
        files.append(str(path))
    monkeypatch.setenv("VCD_NATIVE_PREPROCESS", "1")
    port, ref = get_transform(32), jax_get_transform(32)
    native.reset_counts()
    for path in files:
        # a path, a still-lazy PIL image (re-read as bytes), raw bytes, and a
        # decoded array (the preprocess kernel)
        with open(path, "rb") as f:
            raw = f.read()
        items = [path, Image.open(path), raw, np.asarray(Image.open(path).convert("RGB"))]
        for item in items:
            jax_item = Image.open(path) if isinstance(item, Image.Image) else item
            np.testing.assert_array_equal(port(item), ref(jax_item))
    assert native.counts == {"decode": 9, "preprocess": 3, "pil": 0}


def test_a_cmyk_jpeg_goes_to_pil_and_is_counted(monkeypatch):
    buf = io.BytesIO()
    Image.fromarray(_smooth(4, 64, 64)).convert("CMYK").save(buf, "JPEG")
    with pytest.raises(RuntimeError, match="native decode failed"):
        native.decode_preprocess(buf.getvalue(), 32)
    monkeypatch.setenv("VCD_NATIVE_PREPROCESS", "1")
    transform = get_transform(32)
    native.reset_counts()
    out = transform(buf.getvalue())
    assert native.counts == {"decode": 0, "preprocess": 0, "pil": 1}
    monkeypatch.setenv("VCD_NATIVE_PREPROCESS", "0")
    np.testing.assert_array_equal(out, get_transform(32)(buf.getvalue()))


def test_a_failed_build_raises_and_names_the_command(monkeypatch, tmp_path):
    missing = str(tmp_path / "no-such-g++")
    monkeypatch.setattr(native, "CXX", missing)
    monkeypatch.setenv("VCD_NATIVE_PREPROCESS", "1")
    with pytest.raises(native.NativeBuildError) as info:
        get_transform(16)
    message = str(info.value)
    assert f"{missing} -O3 -march=native" in message and "-ljpeg -lpng" in message
    assert not native.available()
    monkeypatch.undo()
    assert native.available() and native.build_kind == "decode"


def test_the_library_lands_in_torch_kernels_under_a_hashed_name(jax_lib, monkeypatch, tmp_path):
    assert native.BUILD_DIR == os.path.join(ROOT, "build", "torch_kernels")
    jax_so = os.path.join(ROOT, "build", "libvcdprep.so")
    before = os.stat(jax_so).st_mtime_ns
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    lib = native.get_lib()
    built = os.listdir(tmp_path)
    assert len(built) == 1 and re.fullmatch(r"libvcdprep-[0-9a-f]{16}\.so", built[0])
    assert lib._name == os.path.join(str(tmp_path), built[0])
    assert native.build_kind == "decode" and native.decode_available()
    assert os.stat(jax_so).st_mtime_ns == before
