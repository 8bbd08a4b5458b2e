"""The tensor axis's parts against one process, with no process spawned.

``ops/tensor_parallel.py``'s collectives run here over T threads of this
process, which stand for the ranks of a tensor group: ``dist`` in that
module is replaced by an in-process exchange (every thread posts its
tensor, waits for the others, and reads theirs in rank order), so each
layer runs its real forward and backward, collectives included, on every
"rank". Held against the whole layer in one process, within 1e-5 of each
result's largest entry (fp32):

- the column-parallel conv (a sharded input gathered, or a whole one) at
  the model's geometries, the row-parallel conv, the column-parallel
  linear: outputs, input, weight and bias gradients; the fp32 forward's
  slices of output channels;
- the channel gather (both adjoints), the reduce-scatter, the partial sum
  and the cut to a block;
- GroupNorm(+SiLU) on each rank's channel block, both routes (the plain
  version and the kernels' wrappers, which run their plain versions on a
  CPU tensor), with the kernel's mean |z| tap, and the kernels'
  eligibility judged on the whole layer;
- the tap statistics of a block and of a whole tensor.

Then the layout: each port leaf's tensor and data axes under ``tensor: 2``
on 2 data ranks, plain and with ``shard_optimizer``/``shard_ema``, against
JAX ``_combined_spec`` and ``state_shardings`` on ``make_mesh(4,
tensor=2)`` (the shardings only, no step); the cut of a whole state dict
(``models/io.py``) on the JAX params, its blocks joined again; and the mesh's rank
layout and checks.
"""

import threading
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from test_torch_taps import seeded_pair

from vae_channel_dynamics_tpu.parallel import make_mesh as jax_make_mesh
from vae_channel_dynamics_tpu.parallel.mesh import DATA_AXIS as JAX_DATA
from vae_channel_dynamics_tpu.parallel.mesh import TENSOR_AXIS as JAX_TENSOR
from vae_channel_dynamics_tpu.parallel.zero import _combined_spec, state_shardings
from vae_channel_dynamics_tpu.training import TrainState as JaxTrainState
from vae_channel_dynamics_tpu.training import build_optimizer as jax_build_optimizer
from vae_channel_dynamics_tpu.utils import naming as jax_naming
from vae_channel_dynamics_tpu_torch.models import io as model_io
from vae_channel_dynamics_tpu_torch.ops import group_norm_kernel, stats
from vae_channel_dynamics_tpu_torch.ops import tensor_parallel as tpar
from vae_channel_dynamics_tpu_torch.ops.group_norm import group_norm
from vae_channel_dynamics_tpu_torch.ops.spatial_conv import SpatialGroup
from vae_channel_dynamics_tpu_torch.parallel.mesh import (DataAxis, check_tensor,
                                                          refuse_unported_axes, with_layout)
from vae_channel_dynamics_tpu_torch.parallel.zero import ZeroLayout, jax_axes, tensor_axis

REL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Each simulated rank on one intra-op thread (they run side by side)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Hub:
    """The exchange of one simulated group: each rank posts, all wait, each
    reads every rank's post in rank order."""

    def __init__(self, size: int):
        self.size = size
        self.posts = [None] * size
        self.barrier = threading.Barrier(size)

    def exchange(self, index, value):
        self.posts[index] = value
        self.barrier.wait()
        got = list(self.posts)
        self.barrier.wait()
        return got


class _Handle:
    def __init__(self, hub, index):
        self.hub, self.index = hub, index


class _InProcessDist:
    """The three collectives ``ops/tensor_parallel.py`` issues, over a
    ``_Handle`` group; sums add the ranks' tensors in rank order."""

    @staticmethod
    def all_gather(parts, t, group):
        for p, got in zip(parts, group.hub.exchange(group.index, t.clone())):
            p.copy_(got)

    @staticmethod
    def reduce_scatter(out, parts, group):
        got = group.hub.exchange(group.index, [p.clone() for p in parts])
        out.copy_(sum(g[group.index] for g in got))

    @staticmethod
    def all_reduce(t, group):
        got = group.hub.exchange(group.index, t.clone())
        t.copy_(sum(got))


@pytest.fixture
def ranks(monkeypatch):
    """``ranks(T, fn)``: ``fn(tp)`` on T simulated tensor ranks, each with
    its own ``TensorGroup``; returns their results in rank order."""
    monkeypatch.setattr(tpar, "dist", _InProcessDist)

    def run(size, fn):
        hub = _Hub(size)
        groups = [tpar.TensorGroup(group=_Handle(hub, r), size=size, index=r)
                  for r in range(size)]
        with ThreadPoolExecutor(size) as pool:
            return list(pool.map(fn, groups))

    return run


def _close(got, want, what):
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= REL * scale, f"{what}: {err:.3e} vs {REL} x {scale:.3e}"


def _block(t, dim, index, size):
    return t.chunk(size, dim=dim)[index]


def _leaves(*tensors):
    return [t.detach().clone().requires_grad_(True) for t in tensors]


# (kernel, stride, pad (left, right, top, bottom)): the model's convs
GEOMETRIES = {
    "3x3": (3, 1, (1, 1, 1, 1)),
    "down": (3, 2, (0, 1, 0, 1)),
    "1x1": (1, 1, (0, 0, 0, 0)),
}


def _conv_case(seed, cin, cout, k, hw=8):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(2, cin, hw, hw, generator=g), torch.randn(cout, cin, k, k, generator=g),
            torch.randn(cout, generator=g))


def _conv_ref(x, w, b, stride, pad, dy_seed):
    x, w, b = _leaves(x, w, b)
    y = F.conv2d(F.pad(x, pad), w, b, stride)
    dy = torch.randn(y.shape, generator=torch.Generator().manual_seed(dy_seed))
    (y * dy).sum().backward()
    return y.detach(), dy, x.grad, w.grad, b.grad


@pytest.mark.parametrize("gathered", [True, False], ids=["block_input", "whole_input"])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
@pytest.mark.parametrize("size", [2, 4])
def test_column_conv_matches_whole(ranks, size, geometry, gathered):
    k, stride, pad = GEOMETRIES[geometry]
    x, w, b = _conv_case(1, 8, 12 if size == 2 else 16, k)
    y, dy, dx, dw, db = _conv_ref(x, w, b, stride, pad, 2)

    def rank(tp):
        xi = _block(x, 1, tp.index, size) if gathered else x
        xi, wi, bi = _leaves(xi, _block(w, 0, tp.index, size), _block(b, 0, tp.index, size))
        yi = tpar.column_conv(xi, wi, bi, stride, pad, x.shape[1], tp)
        (yi * _block(dy, 1, tp.index, size)).sum().backward()
        return yi.detach(), xi.grad, wi.grad, bi.grad

    out = ranks(size, rank)
    _close(torch.cat([o[0] for o in out], 1), y, "y")
    if gathered:
        _close(torch.cat([o[1] for o in out], 1), dx, "dx")
    else:
        for o in out:
            _close(o[1], dx, "dx of a whole input, on every rank")
    _close(torch.cat([o[2] for o in out], 0), dw, "dw")
    _close(torch.cat([o[3] for o in out], 0), db, "db")


@pytest.mark.parametrize("bias", [True, False])
def test_sliced_conv_matches_one_conv(bias):
    """The fp32 column conv's forward in slices of output channels (the
    last one short) is the one conv's output."""
    g = torch.Generator().manual_seed(8)
    x, w = torch.randn(2, 8, 9, 9, generator=g), torch.randn(200, 8, 3, 3, generator=g)
    b = torch.randn(200, generator=g) if bias else None
    want = F.conv2d(x, w, b, 2, (1, 1))
    _close(tpar.sliced_conv2d(x, w, b, 2, (1, 1), tpar.FP32_CONV_SLICE), want, "sliced")


@pytest.mark.parametrize("whole_input", [False, True])
def test_row_conv_matches_whole(ranks, whole_input):
    """conv_out's layout: O = 3 does not split, so each rank holds a block
    of the input channels and the partial outputs are summed."""
    size = 2
    x, w, b = _conv_case(3, 16, 3, 3)
    y, dy, dx, dw, db = _conv_ref(x, w, b, 1, (1, 1, 1, 1), 4)

    def rank(tp):
        xi = x if whole_input else _block(x, 1, tp.index, size)
        xi, wi, bi = _leaves(xi, _block(w, 1, tp.index, size), b)
        yi = tpar.row_conv(xi, wi, bi, 1, (1, 1, 1, 1), x.shape[1], tp)
        (yi * dy).sum().backward()
        return yi.detach(), xi.grad, wi.grad, bi.grad

    out = ranks(size, rank)
    for r, o in enumerate(out):
        _close(o[0], y, "y, whole on every rank")
        _close(o[1], dx if whole_input else _block(dx, 1, r, size), "dx")
        _close(o[2], _block(dw, 1, r, size), "dw")
        _close(o[3], db, "db")


@pytest.mark.parametrize("gathered", [True, False], ids=["block_input", "whole_input"])
def test_column_linear_matches_whole(ranks, gathered):
    size = 2
    g = torch.Generator().manual_seed(5)
    x, w, b = torch.randn(2, 10, 8, generator=g), torch.randn(6, 8, generator=g), torch.randn(6)
    xr, wr, br = _leaves(x, w, b)
    y = F.linear(xr, wr, br)
    dy = torch.randn(y.shape, generator=g)
    (y * dy).sum().backward()

    def rank(tp):
        xi = _block(x, -1, tp.index, size) if gathered else x
        xi, wi, bi = _leaves(xi, _block(w, 0, tp.index, size), _block(b, 0, tp.index, size))
        yi = tpar.column_linear(xi, wi, bi, 8, tp)
        (yi * _block(dy, -1, tp.index, size)).sum().backward()
        return yi.detach(), xi.grad, wi.grad, bi.grad

    out = ranks(size, rank)
    _close(torch.cat([o[0] for o in out], -1), y.detach(), "y")
    want_dx = torch.cat([o[1] for o in out], -1) if gathered else out[0][1]
    _close(want_dx, xr.grad, "dx")
    _close(torch.cat([o[2] for o in out], 0), wr.grad, "dw")
    _close(torch.cat([o[3] for o in out], 0), br.grad, "db")


def test_channel_collectives_and_their_adjoints(ranks):
    size = 4
    g = torch.Generator().manual_seed(6)
    whole = torch.randn(2, 8, 3, generator=g)
    partial = [torch.randn(2, 8, 3, generator=g) for _ in range(size)]
    cot = torch.randn(2, 8, 3, generator=g)

    def rank(tp):
        r = tp.index
        out = {}
        for partial_grads in (False, True):
            x = _leaves(_block(whole, 1, r, size))[0]
            y = tpar.gather_channels(x, 1, tp, partial_grads=partial_grads)
            # a partial cotangent per rank: each rank's share of cot
            (y * (cot / size if partial_grads else cot)).sum().backward()
            out[f"gather{int(partial_grads)}"] = (y.detach(), x.grad)
        # the reduce-scatter alone (its adjoint is gather1's forward)
        out["reduce_scatter"] = tpar._reduce_scatter(partial[r], 1, tp)
        x = _leaves(partial[r])[0]
        y = tpar.sum_partials(x, tp)
        (y * cot).sum().backward()
        out["sum"] = (y.detach(), x.grad)
        x = _leaves(whole)[0]
        y = tpar.to_block(x, 1, tp)
        (y * _block(cot, 1, r, size)).sum().backward()
        out["to_block"] = (y.detach(), x.grad)
        return out

    out = ranks(size, rank)
    total = sum(partial)
    for r, o in enumerate(out):
        for key in ("gather0", "gather1"):
            _close(o[key][0], whole, f"{key} forward")
            _close(o[key][1], _block(cot, 1, r, size), f"{key} adjoint")
        _close(o["reduce_scatter"], _block(total, 1, r, size), "reduce-scatter")
        _close(o["sum"][0], total, "partial sum")
        _close(o["sum"][1], cot, "partial sum adjoint (identity)")
        _close(o["to_block"][0], _block(whole, 1, r, size), "to_block")
        _close(o["to_block"][1], cot, "to_block adjoint (all-gather)")
    assert tpar.collectives["all_gather"] > 0 and tpar.collectives["reduce_scatter"] > 0


@pytest.mark.parametrize("route", ["auto", "pallas", "pallas_tap"])
@pytest.mark.parametrize("size", [2, 4])
def test_group_norm_on_channel_blocks_matches_whole(route, size):
    """Each block's G/T groups are whole, so the norm of a block is the
    block of the norm, forward and backward, on both routes and with the
    normalize kernel's mean |z| tap; no collective runs."""
    g = torch.Generator().manual_seed(7)
    x = torch.randn(2, 128, 4, 4, generator=g) * 2 + 1
    w, b = 1 + 0.1 * torch.randn(128, generator=g), 0.1 * torch.randn(128, generator=g)
    cot = torch.randn(x.shape, generator=g)

    def norm(xi, wi, bi, groups, shards):
        if route == "pallas_tap":
            return group_norm_kernel.group_norm_silu_with_stats(xi, wi, bi, groups, 1e-6,
                                                                fuse_silu=True)
        return group_norm(xi, wi, bi, groups, 1e-6, fuse_silu=True,
                          impl="auto" if route == "auto" else "pallas", shards=shards), None

    xr, wr, br = _leaves(x, w, b)
    y, tap = norm(xr, wr, br, 32, 1)
    (y * cot).sum().backward()
    before = dict(tpar.collectives)
    for r in range(size):
        xi, wi, bi = _leaves(*(_block(t, 0 if t.dim() == 1 else 1, r, size) for t in (x, w, b)))
        yi, tapi = norm(xi, wi, bi, 32 // size, size)
        (yi * _block(cot, 1, r, size)).sum().backward()
        _close(yi.detach(), _block(y.detach(), 1, r, size), "y")
        _close(xi.grad, _block(xr.grad, 1, r, size), "dx")
        _close(wi.grad, _block(wr.grad, 0, r, size), "dscale")
        _close(bi.grad, _block(br.grad, 0, r, size), "dbias")
        if tap is not None:
            _close(tapi, _block(tap, 0, r, size), "mean |z| tap")
    assert tpar.collectives == before


@pytest.mark.parametrize("channels,eligible", [(128, True), (256, True), (64, False)])
def test_kernel_eligibility_is_judged_on_the_whole_layer(channels, eligible):
    """A 128-channel layer's 64- and 32-channel blocks take the kernels, as
    the layer does on one card; a 64-channel layer's blocks do not."""
    whole = torch.zeros(1, channels, 4, 4)
    assert group_norm_kernel.eligible(whole, 32) is eligible
    for size in (2, 4):
        block = torch.zeros(1, channels // size, 4, 4)
        assert group_norm_kernel.eligible(block, 32 // size, size) is eligible
    if eligible:
        assert not group_norm_kernel.eligible(torch.zeros(1, 64, 4, 4), 16)


def test_tap_statistics_of_blocks_and_whole_tensors(monkeypatch):
    """Under a tensor group a per-channel metric is the rank's block of the
    one-card vector, whether the rank holds a block or the whole tensor,
    and a scalar share summed over the ranks is the one-card value."""
    size = 2
    g = torch.Generator().manual_seed(8)
    x = torch.randn(3, 8, 4, 4, generator=g).relu()
    mask = torch.tensor([1.0, 1.0, 0.0])
    metrics = ("mean_abs_activation_per_channel", "zero_fraction_per_channel",
               "mean_activation")
    with stats.tap_mask(mask):
        want = stats.channel_stats(x, metrics)
    monkeypatch.setattr(stats, "_TAP_REDUCE", True)
    for whole in (False, True):
        shares = []
        for r in range(size):
            tp = tpar.TensorGroup(group=None, size=size, index=r)
            xi = x if whole else _block(x, 1, r, size)
            with stats.tap_mask(mask, reduce=True), tpar.tensor_scope(tp):
                got = stats.channel_stats(xi, metrics, channels=8)
            for m in metrics[:2]:
                _close(got[m], _block(want[m], 0, r, size), f"{m} (whole={whole})")
            shares.append(got["mean_activation"])
        _close(sum(shares), want["mean_activation"], f"mean_activation (whole={whole})")


# --------------------------------------------------------------------------- #
# The layout
# --------------------------------------------------------------------------- #
def _axis(rank, world=4, spatial=1, tensor=2):
    return DataAxis(rank=rank, world=world, local_rank=rank, device=torch.device("cpu"),
                    mesh=None, spatial=spatial, tensor=tensor)


def _port_axes(spec, ndim):
    """{mesh axis: port axis} of a JAX PartitionSpec on a JAX-layout leaf."""
    order = jax_axes(ndim)
    return {name: order[j] for j, name in enumerate(tuple(spec)) if name is not None}


@pytest.fixture(scope="module")
def sharded_narrow():
    model, params = seeded_pair(5, impl="auto")
    whole = {k: v.detach().clone() for k, v in model.state_dict().items()}
    model.shard_tensor_(tpar.TensorGroup(group=None, size=2, index=1))
    return model, params, whole


@pytest.mark.parametrize("flags", ["tensor", "tensor+zero1"])
def test_layout_matches_jax_combined_spec(sharded_narrow, flags):
    model, params, whole = sharded_narrow
    zero = flags.endswith("zero1")
    layout = ZeroLayout(_axis(1), model, zero, zero, fsdp=False)
    mesh = jax_make_mesh(4, tensor=2)
    assert dict(mesh.shape) == {"data": 2, "tensor": 2}
    jtx, _ = jax_build_optimizer(1e-3, 1, 10)
    jstate = JaxTrainState.create(params, jtx, ema=True)
    shardings = state_shardings(mesh, jstate, shard_optimizer=zero, shard_ema=zero)
    ema_specs = dict(jax_naming.iter_torch_named_params(
        jax.tree.map(lambda s: s.spec, shardings.ema_params)))
    param_specs = dict(jax_naming.iter_torch_named_params(
        jax.tree.map(lambda s: s.spec, shardings.params)))
    names = [n for n, _ in model.named_parameters()]
    cut = 0
    for i, name in enumerate(names):
        shape = tuple(whole[name].shape)
        jshape = tuple(shape[a] for a in jax_axes(len(shape)))
        want = _port_axes(_combined_spec(jshape, mesh, zero), len(shape))
        assert layout.t_axes[i] == want.get(JAX_TENSOR), name
        assert layout.opt_axes[i] == want.get(JAX_DATA), name
        assert layout.ema_axes[i] == want.get(JAX_DATA), name
        assert _port_axes(ema_specs[name], len(shape)) == want, name
        # the parameters keep the tensor axis alone (no shard_params)
        assert _port_axes(param_specs[name], len(shape)) == {
            k: v for k, v in want.items() if k == JAX_TENSOR}, name
        p = dict(model.named_parameters())[name]
        assert tuple(p.shape) == layout.full_shapes[i]
        if layout.t_axes[i] is not None:
            cut += 1
            assert p.shape[layout.t_axes[i]] * 2 == shape[layout.t_axes[i]]
    assert cut > 100


def test_io_cuts_the_jax_params_into_tensor_blocks(sharded_narrow):
    """The JAX params enter a tensor rank through ``tensor_blocks``, which
    is the cut ``shard_tensor_`` makes; the blocks in rank order are the
    whole."""
    model, params, whole = sharded_narrow
    sd = model_io.state_dict_from_jax_params(params)
    for k in whole:
        assert torch.equal(sd[k], whole[k])
    blocks = [model_io.tensor_blocks(sd, r, 2) for r in range(2)]
    mine = dict(model.named_parameters())
    for k, v in blocks[1].items():
        assert torch.equal(v, mine[k].detach()), k
    for k, v in sd.items():
        a = tensor_axis(tuple(v.shape), 2)
        joined = blocks[0][k] if a is None else torch.cat([b[k] for b in blocks], dim=a)
        assert torch.equal(joined, v), k
    assert sum(tensor_axis(tuple(v.shape), 2) is not None for v in sd.values()) > 100


def test_mesh_ranks_follow_jax_axis_order():
    """("data", "spatial", "tensor"), tensor innermost: rank r is tensor rank
    r % T, spatial rank (r // T) % S, data rank r // (S T); spatial
    neighbours are T ranks apart."""
    for r in range(8):
        a = _axis(r, world=8, spatial=2, tensor=2)
        assert (a.data_rank, a.spatial_rank, a.tensor_rank) == (r // 4, (r // 2) % 2, r % 2)
        assert a.data_world == 2 and a.replica_world == 4
        sp = SpatialGroup.of(a)
        assert sp.prev == (r - 2 if a.spatial_rank else None)
        assert sp.next == (r + 2 if not a.spatial_rank else None)


@pytest.mark.parametrize("tensor", [0, 3, 6, 64])
def test_tensor_axis_must_divide_the_group_count(tensor):
    with pytest.raises(ValueError, match=">= 1" if tensor < 1 else "must divide 32"):
        check_tensor(tensor)


def test_tensor_axis_passes_the_refusals_and_needs_ranks():
    """``parallel.tensor`` is ported (only ``slices`` is refused) and one
    process does not divide into tensor ranks (JAX ``make_mesh``'s
    message)."""
    for t in (1, 2, 4, 8, 16, 32):
        assert check_tensor(t) == t
    refuse_unported_axes({"tensor": 2, "spatial": 2, "spatial_conv": "gspmd"})
    with pytest.raises(NotImplementedError, match="Do not port"):
        refuse_unported_axes({"slices": 2, "tensor": 2})
    with pytest.raises(ValueError, match="1 devices not divisible by slices=1 x spatial=1 "
                                         "x tensor=2"):
        with_layout(None, 1, 2)
