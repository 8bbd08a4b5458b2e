"""The NHWC conv3x3 with bias (kernel #12) against the JAX package's Pallas
prototype, on the CPU.

``experiments/conv_bench.py`` is loaded by path; its ``pallas_conv3x3``
runs in interpret mode on the CPU (it decides by the platform), jitted, for
both of its formulations, v9 (nine shifted products) and v3 (three over the
dx-concatenated window). The port's ``conv3x3_nhwc`` takes its plain
version on a CPU tensor, so both it and ``conv3x3_nhwc_reference`` are held
to each formulation:

- fp32: max abs error at most 1e-5 of max|JAX| (both sum fp32 products,
  in another order);
- bf16 inputs: at most 1 bf16 ulp of max|JAX| (each rounds one fp32 sum to
  bf16; a sum that lands on a rounding boundary may go either way).

Shapes cover one row tile and several (the prototype's ``_pick_tile_h``),
Cout != Cin and a non-zero bias. The kernel's own eligibility rule and the
ported bench's CPU run are checked here too; the kernel itself runs only
on the card (``tests/test_torch_conv_nhwc_cuda.py``).
"""

import importlib.util
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_channel_dynamics_tpu_torch.experiments import conv_bench as port_bench
from vae_channel_dynamics_tpu_torch.ops import conv_nhwc as cn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (x shape NHWC, Cout, row tiles of the prototype)
SHAPES = [
    ((1, 16, 8, 32), 64, 1),
    ((2, 48, 8, 32), 48, 3),
    ((1, 12, 16, 64), 64, 3),
]
IDS = [f"{s}->{c}" for s, c, _ in SHAPES]


@pytest.fixture(scope="module")
def jax_bench():
    spec = importlib.util.spec_from_file_location(
        "jax_conv_bench", os.path.join(REPO, "experiments", "conv_bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(shape, cout, seed):
    rng = np.random.default_rng(seed)
    cin = shape[-1]
    x = rng.standard_normal(shape, dtype=np.float32)
    w = rng.standard_normal((3, 3, cin, cout), dtype=np.float32) / np.sqrt(9 * cin)
    b = 0.5 * rng.standard_normal((cout,), dtype=np.float32)
    return x, w, b


def _jax(jax_bench, x, w, b, variant, dtype):
    fn = jax.jit(lambda xx, ww, bb: jax_bench.pallas_conv3x3(xx, ww, bb, variant=variant))
    out = fn(jnp.asarray(x, dtype), jnp.asarray(w, dtype), jnp.asarray(b, dtype))
    return np.asarray(out.astype(jnp.float32))


def _port(fn, x, w, b, dtype):
    tx, tw, tb = (torch.from_numpy(a).to(dtype) for a in (x, w, b))
    return fn(tx, tw, tb).float().numpy()


@pytest.mark.parametrize("shape,cout,tiles", SHAPES, ids=IDS)
def test_prototype_tiles(jax_bench, shape, cout, tiles):
    _n, h, wd, cin = shape
    assert h // jax_bench._pick_tile_h(h, wd, cin) == tiles


@pytest.mark.parametrize("variant", ["v9", "v3"])
@pytest.mark.parametrize("shape,cout,tiles", SHAPES, ids=IDS)
def test_fp32_matches_the_prototype(jax_bench, variant, shape, cout, tiles):
    x, w, b = _inputs(shape, cout, seed=sum(shape) + cout)
    ref = _jax(jax_bench, x, w, b, variant, jnp.float32)
    assert ref.shape == shape[:3] + (cout,)
    bound = 1e-5 * np.abs(ref).max()
    before = dict(cn.launches)
    for fn in (cn.conv3x3_nhwc, cn.conv3x3_nhwc_reference):
        out = _port(fn, x, w, b, torch.float32)
        assert out.shape == ref.shape
        assert np.abs(out - ref).max() <= bound
    assert cn.launches == before  # a CPU tensor runs the plain version


@pytest.mark.parametrize("variant", ["v9", "v3"])
@pytest.mark.parametrize("shape,cout,tiles", SHAPES, ids=IDS)
def test_bf16_matches_the_prototype(jax_bench, variant, shape, cout, tiles):
    x, w, b = _inputs(shape, cout, seed=sum(shape) + cout + 1)
    ref = _jax(jax_bench, x, w, b, variant, jnp.bfloat16)
    ulp = 2.0 ** (math.floor(math.log2(np.abs(ref).max())) - 7)
    for fn in (cn.conv3x3_nhwc, cn.conv3x3_nhwc_reference):
        out = _port(fn, x, w, b, torch.bfloat16)
        assert np.abs(out - ref).max() <= ulp


def test_no_bias_is_zero_bias():
    x, w, _b = _inputs((1, 5, 6, 32), 64, seed=3)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    torch.testing.assert_close(cn.conv3x3_nhwc(tx, tw), cn.conv3x3_nhwc(tx, tw, torch.zeros(64)),
                               rtol=0, atol=0)


@pytest.mark.parametrize("shape,cout,ok", [
    ((8, 64, 64, 512), 512, True),
    ((8, 256, 256, 128), 128, True),
    ((1, 5, 7, 32), 64, True),       # any H and W
    ((65535, 1, 1, 32), 64, True),
    ((65536, 1, 1, 32), 64, False),  # the grid's z limit
    ((1, 8, 8, 48), 64, False),      # Cin not a multiple of 32
    ((1, 8, 8, 32), 96, False),      # Cout not a multiple of 64
    ((1, 8, 8, 16), 64, False),
    ((1, 8, 8), 64, False),          # not NHWC
])
def test_eligible(shape, cout, ok):
    assert cn.eligible(shape, cout) is ok
    if len(shape) == 4 and shape[0] < 16:
        assert cn.eligible(torch.empty(shape), cout) is ok


@pytest.mark.parametrize("h,w,tile", [
    (64, 64, (2, 64)), (32, 32, (4, 32)), (128, 128, (1, 128)), (256, 256, (1, 128)),
    (1, 1, (1, 128)), (5, 7, (8, 16)), (9, 65, (1, 128)),
])
def test_pixel_tile_wastes_the_fewest_pixels(h, w, tile):
    rows, cols = cn.pixel_tile(h, w)
    assert (rows, cols) == tile
    assert rows * cols == cn.TILE_PIXELS and cols & (cols - 1) == 0

    def covered(r, c):
        return -(-h // r) * r * -(-w // c) * c

    assert all(covered(rows, cols) <= covered(cn.TILE_PIXELS // c, c)
               for c in (1, 2, 4, 8, 16, 32, 64, 128))


def test_ported_bench_runs_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(port_bench, "SHAPES", [("T 64ch@6x5px", (1, 6, 5, 64))])
    for which in ("v9", "all"):
        assert port_bench.main([which, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "T 64ch@6x5px kernel: rel_err=" in out
    assert "T 64ch@6x5px cudnn: rel_err=" in out
    assert "T 64ch@6x5px:  kernel=not timed on the CPU  cudnn=not timed on the CPU" in out
    for line in out.splitlines():
        if "rel_err=" in line:
            assert float(line.split("rel_err=")[1]) < 2.0 ** -7


def test_bench_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="cuda"):
        port_bench.main(["kernel", "--device", "cuda"])
