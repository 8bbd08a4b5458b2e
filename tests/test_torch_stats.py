"""The port's activation statistics against the JAX package's, on the CPU.

The five metrics of ``ops/stats.py`` for the same numpy activation, NHWC to
JAX and NCHW to the port (and (B, N, C) to both, the attention projections'
layout), with and without a batch-validity mask that drops the last row.
fp32 reductions in another order: rtol 1e-5, atol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_channel_dynamics_tpu.ops import stats as jstats
from vae_channel_dynamics_tpu_torch.ops import stats as tstats

RTOL, ATOL = 1e-5, 1e-6
METRICS = tuple(jstats.METRIC_FNS)


def _activation(shape, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 1.5 + 0.2).astype(np.float32)
    x[..., 1] = 0.0  # one dead channel, for zero_fraction_per_channel
    return x


def _to_port(x: np.ndarray) -> torch.Tensor:
    if x.ndim == 4:
        return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    return torch.from_numpy(x)


def _both(x, metrics, mask):
    with jstats.tap_mask(None if mask is None else jnp.asarray(mask)):
        j = jstats.channel_stats(jnp.asarray(x), metrics)
    with tstats.tap_mask(None if mask is None else torch.from_numpy(mask)):
        t = tstats.channel_stats(_to_port(x), metrics)
    return j, t


@pytest.mark.parametrize("shape", [(3, 6, 5, 16), (3, 20, 32)])
@pytest.mark.parametrize("masked", [False, True])
def test_metrics_match_jax(shape, masked):
    x = _activation(shape, 0)
    mask = np.array([1.0, 1.0, 0.0], np.float32) if masked else None
    j, t = _both(x, METRICS + ("not_a_metric",), mask)
    assert set(j) == set(t) == set(METRICS)
    for name in METRICS:
        got = t[name].numpy()
        want = np.asarray(j[name])
        if name == "full_activation_map":
            # the JAX map is NCHW (transposed from NHWC); the port's is NCHW
            # already, and neither is masked
            np.testing.assert_array_equal(got, want)
            continue
        assert got.shape == want.shape, name
        assert t[name].dtype == torch.float32
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=name)


def test_masked_metrics_ignore_the_pad_row():
    x = _activation((3, 4, 4, 8), 1)
    x[2] = 1e3  # a pad row that would dominate every statistic
    mask = torch.tensor([1.0, 1.0, 0.0])
    with tstats.tap_mask(mask):
        masked = tstats.channel_stats(_to_port(x), METRICS)
    valid = tstats.channel_stats(_to_port(x[:2]), METRICS)
    for name in METRICS:
        if name != "full_activation_map":
            np.testing.assert_allclose(masked[name].numpy(), valid[name].numpy(),
                                       rtol=RTOL, atol=ATOL, err_msg=name)


def test_masked_std_is_cancellation_safe():
    """A large common mean must not cancel the variance away in fp32 (the
    JAX test at tests/test_pallas_group_norm.py:208, on both packages)."""
    rng = np.random.default_rng(1)
    data = (50.0 + 0.1 * rng.normal(size=(2, 64, 64, 32))).astype(np.float32)
    padded = np.concatenate([data, np.repeat(data[-1:], 2, axis=0)])
    mask = np.array([1, 1, 0, 0], np.float32)
    expected = np.std(data.astype(np.float64), ddof=1)
    j, t = _both(padded, ("std_activation",), mask)
    np.testing.assert_allclose(float(t["std_activation"]), expected, rtol=1e-3)
    np.testing.assert_allclose(float(t["std_activation"]), float(j["std_activation"]),
                               rtol=1e-4)


def test_mask_applies_only_to_matching_batch_and_nests():
    x = torch.ones(2, 3, 4, 4)
    outer = torch.tensor([1.0, 0.0])
    with tstats.tap_mask(outer):
        assert tstats.mask_for(x) is not None
        assert tstats.mask_for(torch.ones(3, 3, 4, 4)) is None  # another batch size
        with tstats.tap_mask(None):
            assert tstats.mask_for(x) is None
        assert torch.equal(tstats.mask_for(x), outer)
    assert tstats.mask_for(x) is None


def test_statistics_hold_no_autograd_graph():
    x = torch.randn(2, 4, 3, 3, requires_grad=True)
    for value in tstats.channel_stats(x, METRICS).values():
        assert not value.requires_grad
