"""The parts of the port's data axis against the JAX package's, without a
process group: the pad rows, each rank's contiguous block of a global
batch against JAX's ``batch_sharding`` on a CPU mesh, and the ZeRO axis of
every leaf of the SDXL state at 2, 4 and 8 ranks against JAX's
``_best_axis`` and ``_channel_axis`` on the JAX layout, translated to the
port's (OIHW convs, (out, in) dense kernels). Then what the port refuses
and how it starts without torchrun.
"""

import jax
import numpy as np
import pytest
import torch

from vae_channel_dynamics_tpu.models.io import abstract_params
from vae_channel_dynamics_tpu.models.vae import VAEConfig as JaxConfig
from vae_channel_dynamics_tpu.parallel import make_mesh as jax_make_mesh
from vae_channel_dynamics_tpu.parallel.mesh import batch_sharding
from vae_channel_dynamics_tpu.parallel.mesh import pad_batch_to_multiple as jax_pad
from vae_channel_dynamics_tpu.parallel.zero import _best_axis as jax_best_axis
from vae_channel_dynamics_tpu.parallel.zero import _channel_axis as jax_channel_axis
from vae_channel_dynamics_tpu.utils import naming as jax_naming
from vae_channel_dynamics_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from vae_channel_dynamics_tpu_torch.parallel import (
    data_axis_size,
    initialize_distributed,
    local_block,
    pad_batch_to_multiple,
    refuse_unported_axes,
)
from vae_channel_dynamics_tpu_torch.parallel.mesh import spatial_conv_choice, with_layout
from vae_channel_dynamics_tpu_torch.parallel.zero import (
    _best_axis,
    _channel_axis,
    chunk_span,
    local_chunk,
    zero_axis,
)


@pytest.mark.parametrize("n,multiple", [(3, 2), (3, 4), (8, 4), (5, 8), (1, 1)])
def test_pad_batch_to_multiple_matches_jax(n, multiple):
    raw = {"pixel_values": np.arange(n * 6, dtype=np.float32).reshape(n, 2, 3),
           "ids": np.arange(n)}
    got, mask = pad_batch_to_multiple(raw, multiple)
    want, jmask = jax_pad(raw, multiple)
    np.testing.assert_array_equal(mask, jmask)
    for k in raw:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("world", [2, 4, 8])
def test_local_blocks_are_jax_batch_sharding(world):
    mesh = jax_make_mesh(n_devices=world)
    batch, mask = pad_batch_to_multiple(
        {"x": np.arange((2 * world - 1) * 3, dtype=np.float32).reshape(-1, 3)}, world)
    arr = jax.device_put(batch["x"], batch_sharding(mesh))
    devices = list(mesh.devices.flat)
    for shard in arr.addressable_shards:
        rank = devices.index(shard.device)
        np.testing.assert_array_equal(np.asarray(shard.data),
                                      local_block(batch["x"], rank, world))
    # the pad row is on the last rank
    assert local_block(mask, world - 1, world)[-1] == 0.0
    assert local_block(mask, 0, world).all()
    blocks = [local_block({"x": batch["x"], "m": mask}, r, world) for r in range(world)]
    np.testing.assert_array_equal(np.concatenate([b["x"] for b in blocks]), batch["x"])
    with pytest.raises(ValueError, match="pad them first"):
        local_block(np.zeros(world + 1), 0, world)


def _sdxl_leaves():
    """(torch name, JAX shape, torch axis of each JAX axis) of every SDXL
    parameter, the axis map read off the JAX package's own layout
    conversion."""
    torch_shapes = {k: tuple(v.shape) for k, v in
                    AutoencoderKL(VAEConfig.sdxl(), device="meta").named_parameters()}
    out = []
    for name, leaf in jax_naming.iter_torch_named_params(abstract_params(JaxConfig.sdxl())):
        shape = tuple(leaf.shape)
        order = []
        for j in range(len(shape)):
            ramp = np.arange(shape[j]).reshape([-1 if k == j else 1 for k in range(len(shape))])
            moved = np.asarray(jax_naming.to_torch_layout(name, np.broadcast_to(ramp, shape)))
            varying = [k for k in range(moved.ndim) if moved.shape[k] > 1
                       and not (np.diff(moved, axis=k) == 0).all()]
            order.append(varying[0] if varying else
                         next(k for k in range(moved.ndim) if moved.shape[k] == shape[j]))
        assert tuple(torch_shapes[name][k] for k in order) == shape, name
        out.append((name, shape, torch_shapes[name], order))
    assert len(out) == len(torch_shapes)
    return out


SDXL = _sdxl_leaves()


@pytest.mark.parametrize("world", [2, 4, 8])
def test_zero_axis_of_every_sdxl_leaf_matches_jax(world):
    sharded = 0
    for name, jax_shape, torch_shape, order in SDXL:
        for port_fn, jax_fn in ((_best_axis, jax_best_axis), (_channel_axis, jax_channel_axis)):
            # copied exactly
            assert port_fn(jax_shape, world) == jax_fn(jax_shape, world), name
            want = jax_fn(jax_shape, world)
            got = zero_axis(torch_shape, world, choose=port_fn)
            assert got == (None if want is None else order[want]), (name, port_fn.__name__)
        sharded += zero_axis(torch_shape, world) is not None
    # only leaves no axis of which the world size divides stay whole
    assert sharded >= len(SDXL) - 4


def test_square_convs_slice_output_channels():
    # ties go to JAX's last axis, HWIO's O: the port's axis 0
    assert zero_axis((512, 512, 3, 3), 4) == 0
    assert zero_axis((256, 512, 3, 3), 4) == 1
    assert zero_axis((512, 512), 8) == 0  # dense (out, in): JAX (in, out) -> out
    assert zero_axis((3,), 2) is None


@pytest.mark.parametrize("n,world", [(8, 2), (3, 2), (3, 4), (128, 8), (1, 4)])
def test_chunks_are_torch_chunk(n, world):
    t = torch.arange(n * 2).reshape(n, 2)
    chunks = list(t.chunk(world, 0))
    got = [local_chunk(t, 0, r, world) for r in range(world)]
    for r in range(world):
        want = chunks[r] if r < len(chunks) else t[:0]
        assert torch.equal(got[r], want)
        assert chunk_span(n, r, world)[1] == want.shape[0]


@pytest.mark.parametrize("axis,name", [("slices", "Do not port")])
def test_unported_axes_are_refused(axis, name):
    with pytest.raises(NotImplementedError, match=name):
        refuse_unported_axes({axis: 2})
    refuse_unported_axes({axis: 1, "shard_params": True})


@pytest.mark.parametrize("value", ["gspmd", "shard_map", None])
def test_spatial_axis_is_ported(value):
    """``parallel.spatial`` passes the refusals, ``spatial_conv`` takes both
    of JAX's values (the one manual halo exchange either way) and refuses
    others with JAX's message, and one process does not divide into
    spatial shards (JAX ``make_mesh``'s message)."""
    parallel = {"spatial": 2, "spatial_conv": value}
    refuse_unported_axes(parallel)
    assert spatial_conv_choice(parallel) == (value or "gspmd")
    with pytest.raises(ValueError, match="must be 'gspmd' or 'shard_map'"):
        spatial_conv_choice({"spatial_conv": "xla"})
    assert with_layout(None, 1) is None
    with pytest.raises(ValueError, match="not divisible by slices=1 x spatial=2"):
        with_layout(None, 2)


@pytest.mark.parametrize("geometry,halo", [((3, 1, (1, 1)), (1, 1)), ((3, 2, (0, 1)), (0, 1)),
                                           ((1, 1, (0, 0)), (0, 0))])
def test_halo_widths_are_jax_halo_widths(geometry, halo):
    """The port's halo arithmetic is JAX's, messages included."""
    from vae_channel_dynamics_tpu.ops.spatial_conv import _halo_widths

    from vae_channel_dynamics_tpu_torch.ops.spatial_conv import halo_widths

    kh, stride, pad = geometry
    assert halo_widths(kh, stride, pad, 8, 16, 2) == _halo_widths(kh, stride, pad, 8, 16, 2) == halo
    for args in ((kh, stride, pad, 3, 9, 3), (3, 1, (1, 1), 0, 0, 2), (3, 2, (0, 1), 3, 6, 2)):
        try:
            _halo_widths(*args)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                halo_widths(*args)
            assert str(got.value) == str(e)
        else:
            assert halo_widths(*args) == _halo_widths(*args)


def test_row_block_refuses_rows_that_do_not_split():
    from vae_channel_dynamics_tpu_torch.ops.spatial_conv import SpatialGroup, row_block

    sp = SpatialGroup(group=None, size=2, index=1, prev=0, next=None)
    x = torch.arange(2 * 6).reshape(1, 1, 6, 2)
    assert torch.equal(row_block(x, sp), x[:, :, 3:])
    assert row_block(x, None) is x
    with pytest.raises(ValueError, match="H=5 not divisible by the 2-way spatial axis"):
        row_block(x[:, :, :5], sp)


def test_one_process_without_torchrun(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert initialize_distributed("cpu") is None
    assert data_axis_size(None) == 1


def test_a_cuda_rank_without_a_card_raises(monkeypatch):
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": "1"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="is_available"):
        initialize_distributed("cuda")
