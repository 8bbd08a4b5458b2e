"""Tiled and sliced inference of the port against the JAX package's, on the
CPU.

``tile_starts``, ``tiled_apply`` and ``sliced_apply`` take the same numpy
inputs on both sides: the identity, a pooling and an upsampling map, and a
map whose tiles disagree (so the seam blend decides the result). The
wrapper's tiled and sliced ``encode``/``decode`` run the tiny VAE with the
same weights on both sides at fp32 (TF32 is irrelevant on the CPU; JAX at
``Precision.HIGHEST``): the two frameworks sum the convolutions in another
order, about 1e-6 relative, so outputs are held to 1e-5 of max|JAX|.
Validation errors, the serve CLI with ``--tile_size`` and the server's tiled
/reconstruct run on the port alone.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_channel_dynamics_tpu.models import tiling as jtiling
from vae_channel_dynamics_tpu.models.io import abstract_params, unflatten_params
from vae_channel_dynamics_tpu.models.vae import VAEConfig as JaxConfig
from vae_channel_dynamics_tpu.models.wrapper import SDXLVAEWrapper as JaxWrapper
from vae_channel_dynamics_tpu_torch import serve, server
from vae_channel_dynamics_tpu_torch.models import AutoencoderKL, SDXLVAEWrapper, VAEConfig
from vae_channel_dynamics_tpu_torch.models import io as model_io
from vae_channel_dynamics_tpu_torch.models import tiling

REL = 1e-5


@pytest.mark.parametrize("size,tile,stride", [
    (96, 64, 48), (64, 64, 48), (32, 64, 48), (112, 64, 48), (160, 64, 48), (2048, 512, 384),
    (256, 64, 48), (100, 30, 7),
])
def test_tile_starts_match_jax(size, tile, stride):
    assert tiling.tile_starts(size, tile, stride) == jtiling.tile_starts(size, tile, stride)


@pytest.mark.parametrize("args", [(100, 64, 65), (100, 0, 1), (100, 4, 0)])
def test_tile_starts_validation(args):
    with pytest.raises(ValueError):
        jtiling.tile_starts(*args)
    with pytest.raises(ValueError):
        tiling.tile_starts(*args)


def _pool(t, xp):
    n, h, w, c = t.shape
    return t.reshape(n, h // 2, 2, w // 2, 2, c).mean(axis=(2, 4)) if xp is jnp else (
        t.reshape(n, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4)))


def _up(t, xp):
    if xp is jnp:
        return jnp.repeat(jnp.repeat(t, 2, axis=1), 2, axis=2)
    return t.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def _shift(t, xp):
    # each tile offset by its own mean: tiles disagree over the overlap
    return t + t.mean()


MAPS = {"identity": (lambda t, xp: t, 1, 1), "pool": (_pool, 1, 2), "up": (_up, 2, 1),
        "tile-mean": (_shift, 1, 1)}


@pytest.mark.parametrize("name", sorted(MAPS))
@pytest.mark.parametrize("h,w", [(112, 112), (96, 96), (160, 112), (112, 64), (64, 96)])
def test_tiled_apply_matches_jax(name, h, w):
    fn, num, den = MAPS[name]
    x = np.random.default_rng(h + w).normal(size=(2, h, w, 3)).astype(np.float32)
    ref = np.asarray(jtiling.tiled_apply(lambda t: fn(t, jnp), jnp.asarray(x), 64, 48, num, den))
    out = tiling.tiled_apply(lambda t: fn(t, torch), torch.from_numpy(x), 64, 48, num, den)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)
    if name == "identity":
        np.testing.assert_array_equal(out.numpy(), x)


def test_tiled_apply_divisibility_validation():
    x = np.zeros((1, 66, 64, 3), np.float32)
    with pytest.raises(ValueError, match="divisible"):
        jtiling.tiled_apply(lambda t: t, jnp.asarray(x), 64, 48, 1, 4)
    with pytest.raises(ValueError, match="divisible"):
        tiling.tiled_apply(lambda t: t, torch.from_numpy(x), 64, 48, 1, 4)


@pytest.mark.parametrize("batch", [1, 3])
def test_sliced_apply_matches_jax(batch):
    x = np.random.default_rng(batch).normal(size=(batch, 8, 6, 2)).astype(np.float32)
    ref = np.asarray(jtiling.sliced_apply(lambda t: t * 2.0 + t.sum(), jnp.asarray(x)))
    out = tiling.sliced_apply(lambda t: t * 2.0 + t.sum(), torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------------------- #
# The wrapper, against the JAX wrapper on the same weights
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def wrappers():
    model = AutoencoderKL(VAEConfig.tiny())
    model.init_weights(torch.Generator().manual_seed(0))
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    params = unflatten_params(abstract_params(JaxConfig.tiny()),
                              {k: v.numpy() for k, v in state.items()})
    port = SDXLVAEWrapper(VAEConfig.tiny(), state_dict=state, device="cpu")
    ref = JaxWrapper(config=JaxConfig.tiny(), params=params, dtype=jnp.float32)
    return port, ref


def _close(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= REL * np.abs(ref).max()


@pytest.mark.parametrize("mode", ["tiled", "sliced", "tiled+sliced"])
def test_wrapper_encode_decode_match_jax(wrappers, mode):
    port, ref = wrappers
    x = np.random.default_rng(7).uniform(-1, 1, (2, 40, 40, 3)).astype(np.float32)
    for w in (port, ref):
        w.disable_tiling()
        w.disable_slicing()
        if "tiled" in mode:
            w.enable_tiling(16, 0.25)
        if "sliced" in mode:
            w.enable_slicing()
    try:
        z_ref = ref.encode(jnp.asarray(x), deterministic=True)
        z = port.encode(x, deterministic=True)
        _close(z, z_ref)
        _close(port.decode(np.array(z_ref)), ref.decode(z_ref))
    finally:
        for w in (port, ref):
            w.disable_tiling()
            w.disable_slicing()


def test_wrapper_tiling_is_exact_below_the_tile(wrappers):
    """An image no larger than the tile is one tile: tiled = untiled."""
    port, _ref = wrappers
    x = np.random.default_rng(8).uniform(-1, 1, (1, 16, 16, 3)).astype(np.float32)
    z = port.encode(x, deterministic=True)
    port.enable_tiling(16, 0.25)
    try:
        torch.testing.assert_close(port.encode(x, deterministic=True), z, rtol=0, atol=0)
    finally:
        port.disable_tiling()


@pytest.mark.parametrize("tile,overlap,match", [
    (15, 0.25, "divisible"),     # not a multiple of the spatial factor 2
    (16, 0.0, r"\(0, 1\)"),
    (16, 1.0, r"\(0, 1\)"),
    (2, 0.25, "no overlap"),     # stride snaps to the tile
])
def test_enable_tiling_validation_matches_jax(wrappers, tile, overlap, match):
    for w in wrappers:
        with pytest.raises(ValueError, match=match):
            w.enable_tiling(tile, overlap)
        w.disable_tiling()
        w.tile_sample_min_size, w.tile_overlap_factor = w.config.sample_size, 0.25


def test_tile_stride_matches_jax(wrappers):
    port, ref = wrappers
    for tile, overlap in ((16, 0.25), (32, 0.5), (512, 0.25), (64, 0.3)):
        port.tile_sample_min_size = ref.tile_sample_min_size = tile
        port.tile_overlap_factor = ref.tile_overlap_factor = overlap
        assert port._tile_stride() == ref._tile_stride()
    port.tile_sample_min_size = ref.tile_sample_min_size = port.config.sample_size
    port.tile_overlap_factor = ref.tile_overlap_factor = 0.25


# --------------------------------------------------------------------------- #
# The serve CLI and the server, tiled
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def model_dir(tmp_path_factory, wrappers):
    path = str(tmp_path_factory.mktemp("tiny_model"))
    model_io.save_model_dir(path, VAEConfig.tiny(), wrappers[0].state_dict())
    return path


def test_serve_cli_tiled_reconstruct(tmp_path, model_dir):
    out = tmp_path / "out"
    assert serve.main(["--checkpoint_path", model_dir, "--input",
                       "synthetic://shapes?num_samples=3", "--output", str(out),
                       "--resolution", "40", "--batch_size", "2", "--tile_size", "16",
                       "--tile_overlap", "0.25", "--slicing", "--device", "cpu"]) == 0
    metrics = json.loads((out / "serve_metrics.json").read_text())
    assert metrics["num_images"] == 3 and np.isfinite(metrics["avg_mse"])
    assert sorted(os.listdir(out)) == ["recon_0.png", "recon_1.png", "recon_2.png",
                                       "serve_metrics.json"]


def test_server_tiled_reconstruct_is_encode_then_decode(model_dir):
    args = server.parse_args(["--checkpoint_path", model_dir, "--resolution", "40",
                              "--max_batch", "2", "--port", "0", "--tile_size", "16",
                              "--device", "cpu"])
    assert (args.tile_size, args.tile_overlap, args.slicing) == (16, 0.25, False)
    srv = server.build_server(args)
    try:
        w = srv.wrapper
        assert w.use_tiling and not w.use_slicing and w.tile_sample_min_size == 16
        x = np.random.default_rng(9).uniform(-1, 1, (1, 40, 40, 3)).astype(np.float32)
        got = srv._run("reconstruct", x)
        want = w.decode(w.encode(torch.from_numpy(x), deterministic=True)).float().numpy()
        np.testing.assert_array_equal(got, want)
    finally:
        srv.batcher.close()
        srv.httpd.server_close()
