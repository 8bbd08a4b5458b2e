"""The port's row-sharded ops on two gloo ranks of one spatial group against
the JAX package on the whole image.

One spawn (``tests/torch_parallel_ranks.py``, scenario ``spatial_ops``)
runs, at fp32 with inputs from a numpy seed:

* ``halo_conv`` for each of the model's four conv geometries
  (``tests/test_spatial_conv.py``'s cases: 3x3 stride 1, the stride-2
  downsample after its (0, 1) pad, 1x1, and the upsample, which the port
  runs as a nearest-2x and a 3x3 conv on the upsampled rows and JAX as one
  input-dilated 4x4 conv of the summed kernel), forward and the input and
  weight gradients, against JAX ``ops/spatial_conv.py::halo_conv`` on a
  (1 data x 2 spatial) mesh;
* GroupNorm+SiLU on the plain route and on the kernel route (its CPU plain
  versions, with the all-reduces between the kernels), the mean |z| tap
  under a mask that leaves one of the two images out, and the stats taps of
  a 4-D and a (B, N, C) activation, against JAX ``group_norm`` and
  ``ops/stats.py`` on the whole image;
* attention with each rank's queries against every rank's keys and values
  (naive, chunked, and flash, whose plain versions the CPU runs at nq =
  N / 2 < nk = N), forward and dQ, dK, dV, against JAX ``flash_attention``
  under the spatial mesh in interpret mode; and the flash kernels' entries
  at nq < nk directly (o, lse, the serving forward, dQ, dK, dV).

Tolerance: 1e-5 of each tensor's largest entry (fp32 sums in other orders;
JAX at ``Precision.HIGHEST``, the port with TF32 off).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax
from jax.sharding import Mesh
from torch_parallel_ranks import run_ranks

from vae_channel_dynamics_tpu.ops import pallas_attention, stats as jax_stats
from vae_channel_dynamics_tpu.ops.group_norm import group_norm as jax_group_norm
from vae_channel_dynamics_tpu.ops.spatial_conv import halo_conv as jax_halo_conv

REL = 1e-5
S = 2
GROUPS = 8
# (id, kernel size, stride, the port's (left, right, top, bottom) pad, up)
GEOMETRIES = [
    {"id": "3x3-s1", "k": 3, "stride": 1, "pad": [1, 1, 1, 1], "up": False},
    {"id": "down-3x3-s2", "k": 3, "stride": 2, "pad": [0, 1, 0, 1], "up": False},
    {"id": "1x1", "k": 1, "stride": 1, "pad": [0, 0, 0, 0], "up": False},
    {"id": "up-4x4-dil2", "k": 3, "stride": 1, "pad": [1, 1, 1, 1], "up": True},
]
ATTN = (2, 256, 128)  # (B, N, C): 128 local queries a rank against 256 keys
CHUNK = 96  # keys per chunk: not a divisor of N, so the padded chunk runs too


def _mesh():
    return Mesh(np.array(jax.devices()[:S]).reshape(1, S), ("data", "spatial"))


def _nchw(a):
    return np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2)))


def _close(got, want, what):
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert err <= REL * scale, f"{what}: max err {err:.3e} vs {REL} x {scale:.3e}"


def _jax_conv(geo, x, w_oihw, g):
    """JAX halo_conv on the spatial mesh: (y, dx, dw) in the port's layouts."""
    x_nhwc = jnp.asarray(np.transpose(x, (0, 2, 3, 1)))
    kernel = jnp.asarray(np.transpose(w_oihw, (2, 3, 1, 0)))  # HWIO
    g_nhwc = jnp.asarray(np.transpose(g, (0, 2, 3, 1)))
    k, (l, r, t, b) = geo["k"], geo["pad"]

    def fn(x_, k_):
        if geo["up"]:
            # nearest-2x then the 3x3 conv, as JAX's model fuses it
            w4 = jnp.zeros((4, 4) + k_.shape[2:], k_.dtype)
            for p in (0, 1):
                for q in (0, 1):
                    w4 = w4.at[p:p + 3, q:q + 3].add(k_)
            return jax_halo_conv(x_, w4, strides=(1, 1), padding=((2, 2), (2, 2)),
                                 mesh=_mesh(), precision=lax.Precision.HIGHEST,
                                 lhs_dilation=(2, 2))
        return jax_halo_conv(x_, k_, strides=(geo["stride"],) * 2,
                             padding=((t, b), (l, r)), mesh=_mesh(),
                             precision=lax.Precision.HIGHEST)

    y, vjp = jax.vjp(fn, x_nhwc, kernel)
    dx, dk = vjp(g_nhwc)
    assert k == kernel.shape[0]
    return (_nchw(np.asarray(y)), _nchw(np.asarray(dx)),
            np.ascontiguousarray(np.transpose(np.asarray(dk), (3, 2, 0, 1))))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spatial_ops")
    rng = np.random.default_rng(18)
    data, want = {}, {}
    # (a) the convs: NCHW x (2, 4, 16, 16), OIHW kernels of 6 outputs
    for geo in GEOMETRIES:
        name, k = geo["id"], geo["k"]
        x = rng.standard_normal((2, 4, 16, 16)).astype(np.float32)
        w = (rng.standard_normal((6, 4, k, k)) * 0.2).astype(np.float32)
        rows = {"down-3x3-s2": 8, "up-4x4-dil2": 32}.get(name, 16)
        g = rng.standard_normal((2, 6, rows, rows)).astype(np.float32)
        data.update({f"{name}/x": x, f"{name}/w": w, f"{name}/g": g})
        for key, value in zip(("y", "dx", "dw"), _jax_conv(geo, x, w, g)):
            want[f"{name}/{key}"] = value

    # (b) GroupNorm+SiLU over (2, 32, 16, 16), 8 groups; the second image
    # masked out of the taps
    x = (rng.standard_normal((2, 32, 16, 16)) * 2.0 + 0.5).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(32)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(32)).astype(np.float32)
    g = rng.standard_normal((2, 32, 16, 16)).astype(np.float32)
    mask = np.array([1.0, 0.0], np.float32)
    data.update({"gn/x": x, "gn/scale": scale, "gn/bias": bias, "gn/g": g, "gn/mask": mask})

    def gn(x_, s_, b_):
        return jax_group_norm(x_, s_, b_, GROUPS, 1e-6, fuse_silu=True, impl="xla")

    x_nhwc = jnp.asarray(np.transpose(x, (0, 2, 3, 1)))
    y, vjp = jax.vjp(gn, x_nhwc, jnp.asarray(scale), jnp.asarray(bias))
    dx, dscale, dbias = vjp(jnp.asarray(np.transpose(g, (0, 2, 3, 1))))
    with jax_stats.tap_mask(jnp.asarray(mask)):
        z = jax_group_norm(x_nhwc, jnp.asarray(scale), jnp.asarray(bias), GROUPS, 1e-6,
                           impl="xla")
        tap = jax_stats.mean_abs_activation_per_channel(z)
    want.update({"gn/y": _nchw(np.asarray(y)), "gn/dx": _nchw(np.asarray(dx)),
                 "gn/dscale": np.asarray(dscale), "gn/dbias": np.asarray(dbias),
                 "gn/tap": np.asarray(tap)})
    # the stats taps: a 4-D activation (NCHW for the port, NHWC for JAX) and
    # a (B, N, C) one, some entries exactly zero
    act4 = rng.standard_normal((2, 32, 16, 16)).astype(np.float32)
    act4[act4 < -1.0] = 0.0
    act3 = rng.standard_normal((2, 64, 32)).astype(np.float32)
    act3[act3 > 1.2] = 0.0
    data.update({"stats/act4": act4, "stats/act3": act3})
    with jax_stats.tap_mask(jnp.asarray(mask)):
        for name, a in (("act4", np.transpose(act4, (0, 2, 3, 1))), ("act3", act3)):
            got = jax_stats.channel_stats(jnp.asarray(a), tuple(jax_stats.METRIC_FNS))
            for metric, value in got.items():
                want[f"stats_{name}/{metric}"] = np.asarray(value)

    # (c) attention, JAX's flash under the spatial mesh (sequence parallel)
    b, n, c = ATTN
    q, k, v, g = ((rng.standard_normal(ATTN) * 0.5).astype(np.float32) for _ in range(4))
    data.update({"attn/q": q, "attn/k": k, "attn/v": v, "attn/g": g})
    attn_scale = c ** -0.5
    pallas_attention.set_shard_mesh(_mesh())
    try:
        assert pallas_attention.eligible(n, c)

        def attn(q_, k_, v_):
            return pallas_attention.flash_attention(q_, k_, v_, scale=attn_scale,
                                                    out_dtype=jnp.float32,
                                                    precision=lax.Precision.HIGHEST)

        o, vjp = jax.vjp(attn, *(jnp.asarray(a) for a in (q, k, v)))
        grads = vjp(jnp.asarray(g))
    finally:
        pallas_attention.set_shard_mesh(None)
    want["attn/o"] = np.asarray(o)
    for name, d in zip("qkv", grads):
        want[f"attn/d{name}"] = np.asarray(d)
    logits = jnp.einsum("bqc,bkc->bqk", q, k, precision=lax.Precision.HIGHEST) * attn_scale
    want["attn/lse"] = np.asarray(jax.nn.logsumexp(logits, axis=-1))

    np.savez(tmp / "data.npz", **data)
    out = tmp / "port.npz"
    run_ranks("spatial_ops", {
        "data": str(tmp / "data.npz"), "out": str(out), "geometries": GEOMETRIES,
        "groups": GROUPS, "attn_scale": attn_scale, "chunk": CHUNK,
    }, str(tmp / "ranks"), world=S, timeout=120)
    return {"port": dict(np.load(out)), "jax": want}


@pytest.mark.parametrize("geo", [g["id"] for g in GEOMETRIES])
def test_halo_conv_matches_jax(runs, geo):
    for key in ("y", "dx", "dw"):
        _close(runs["port"][f"{geo}/{key}"], runs["jax"][f"{geo}/{key}"], f"{geo} {key}")


@pytest.mark.parametrize("impl", ["auto", "pallas"])
def test_group_norm_over_row_shards_matches_jax(runs, impl):
    for key in ("y", "dx", "dscale", "dbias", "tap"):
        _close(runs["port"][f"gn_{impl}/{key}"], runs["jax"][f"gn/{key}"], f"{impl} {key}")


@pytest.mark.parametrize("name", ["act4", "act3"])
def test_stats_over_row_shards_match_jax(runs, name):
    keys = [k for k in runs["jax"] if k.startswith(f"stats_{name}/")]
    assert len(keys) == 5
    for key in keys:
        _close(runs["port"][key], runs["jax"][key], key)


@pytest.mark.parametrize("impl", ["naive", "chunked", "flash"])
def test_sequence_parallel_attention_matches_jax(runs, impl):
    for key in ("o", "dq", "dk", "dv"):
        _close(runs["port"][f"attn_{impl}/{key}"], runs["jax"][f"attn/{key}"],
               f"{impl} {key}")


def test_flash_kernel_entries_take_fewer_queries_than_keys(runs):
    port, want = runs["port"], runs["jax"]
    assert port["kernels/nq_nk"].tolist() == [ATTN[1] // S, ATTN[1]]
    _close(port["kernels/o"], want["attn/o"], "o")
    _close(port["kernels/serving"], want["attn/o"], "serving o")
    _close(port["kernels/lse"], want["attn/lse"], "lse")
    for key in ("dq", "dk", "dv"):
        _close(port[f"kernels/{key}"], want[f"attn/{key}"], key)
