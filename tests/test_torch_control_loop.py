"""The port's interval control loop against the JAX package's, on the CPU.

Identical accumulators and identical parameters must give identical
results: the ActivityMonitor's metric dict, processed data, records and map
eviction; the RegionClassifier's result dict; the InterventionHandler's
nudged gamma (gentle nudge with its cap, reset, and the interval rules); and
the DeadNeuronTracker's percentages for all three dead types. Values that
both sides compute from the same fp32 numbers on the host must agree
exactly (the nudged gamma) or to float64 rounding (rtol 1e-6); the
device-side dead-weight percentages to 1e-4 points.

Last, every new module of the port imports with jax made unimportable.
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_channel_dynamics_tpu.classification import RegionClassifier as JaxClassifier
from vae_channel_dynamics_tpu.intervention import InterventionHandler as JaxHandler
from vae_channel_dynamics_tpu.models.io import abstract_params, unflatten_params
from vae_channel_dynamics_tpu.models.vae import AutoencoderKL as JaxAutoencoderKL
from vae_channel_dynamics_tpu.models.vae import VAEConfig as JaxConfig
from vae_channel_dynamics_tpu.tracking import ActivityMonitor as JaxMonitor
from vae_channel_dynamics_tpu.tracking import DeadNeuronTracker as JaxDeadNeuronTracker
from vae_channel_dynamics_tpu.utils import naming as jnaming
from vae_channel_dynamics_tpu_torch.classification import RegionClassifier
from vae_channel_dynamics_tpu_torch.intervention import InterventionHandler
from vae_channel_dynamics_tpu_torch.models import AutoencoderKL, VAEConfig
from vae_channel_dynamics_tpu_torch.tracking import ActivityMonitor, DeadNeuronTracker
from vae_channel_dynamics_tpu_torch.utils import naming

NORM = "encoder.down_blocks.0.resnets.0.norm1"
TRACKING = {
    "enabled": True,
    "track_interval": 10,
    "max_map_history": 1,
    "target_layers": [
        {"name": f"vae.{NORM}", "capture_point": "output",
         "metrics": ["mean_abs_activation_per_channel", "std_activation", "bogus"]},
        {"name": "vae.decoder.conv_in", "capture_point": "input",
         "metrics": ["zero_fraction_per_channel", "mean_activation"]},
        {"name": "vae.encoder.conv_in", "capture_point": "output",
         "metrics": ["full_activation_map", "mean_abs_activation_per_channel"]},
        {"name": "vae.encoder.mid_block.attentions.0.to_q", "capture_point": "input",
         "metrics": ["mean_abs_activation_per_channel"]},
        {"capture_point": "output"},
        {"name": "vae.encoder.conv_out", "capture_point": "middle"},
    ],
}


@pytest.fixture(scope="module")
def tiny():
    """The tiny config's port model with seeded weights, and the same
    parameters as a JAX params tree."""
    model = AutoencoderKL(VAEConfig.tiny())
    model.init_weights(torch.Generator().manual_seed(0))
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    params = unflatten_params(abstract_params(JaxConfig.tiny()), state)
    return model, params


def _jax_gamma(params, name):
    return np.asarray(jnaming.get_param(params, name))


def _port_gamma(model, name):
    return naming.get_param(model, name).detach().numpy().copy()


def test_monitor_tables_and_init_acc_match_jax(tiny):
    model, params = tiny
    tm, jm = ActivityMonitor(TRACKING), JaxMonitor(TRACKING)
    assert tm.scalar_capture_table == jm.scalar_capture_table
    assert tm.map_capture_table == jm.map_capture_table
    assert tm.map_keys == jm.map_keys
    assert tm.key_to_identifier == jm.key_to_identifier
    module = JaxAutoencoderKL(config=JaxConfig.tiny(), capture=jm.scalar_capture_table)
    j_acc = jm.init_acc(module, params, (2, 16, 16, 3))
    t_acc = tm.init_acc(model)
    assert {k: tuple(v.shape) for k, v in t_acc.items()} == \
        {k: tuple(v.shape) for k, v in j_acc.items()}
    assert all(float(v.abs().sum()) == 0.0 and v.dtype == torch.float32
               for v in t_acc.values())


def _fake_interval(acc_shapes, seed):
    rng = np.random.default_rng(seed)
    acc = {k: np.asarray(rng.random(shape) * 3.0, np.float32) for k, shape in acc_shapes.items()}
    maps = {"encoder.conv_in.output.full_activation_map":
            rng.standard_normal((2, 16, 8, 8)).astype(np.float32)}
    return acc, maps


def test_monitor_step_records_and_eviction_match_jax(tiny):
    model, _params = tiny
    tm, jm = ActivityMonitor(TRACKING), JaxMonitor(TRACKING)
    shapes = {k: tuple(v.shape) for k, v in tm.init_acc(model).items()}
    for i, global_step in enumerate((10, 20, 30)):
        acc, maps = _fake_interval(shapes, i)
        count = 10.0 - i
        t_metrics = tm.step(global_step, {k: torch.from_numpy(v) for k, v in acc.items()},
                            torch.tensor(count), {k: torch.from_numpy(v) for k, v in maps.items()})
        j_metrics = jm.step(global_step, {k: jnp.asarray(v) for k, v in acc.items()},
                            jnp.asarray(count), {k: jnp.asarray(v) for k, v in maps.items()})
        assert set(t_metrics) == set(j_metrics)
        assert any(k.endswith("_overall_mean") for k in t_metrics)
        for key, want in j_metrics.items():
            assert t_metrics[key] == pytest.approx(want, rel=1e-6, abs=1e-9), key
    for global_step in (10, 20, 30):
        t_data, j_data = tm.get_data_for_step(global_step), jm.get_data_for_step(global_step)
        assert set(t_data) == set(j_data)
        for ident, metrics in j_data.items():
            assert set(t_data[ident]) == set(metrics)
    # max_map_history=1: the two older maps were replaced by summaries on both
    t_records = tm.export_all_processed_data_to_records()
    j_records = jm.export_all_processed_data_to_records()
    assert len(t_records) == len(j_records)
    for tr, jr in zip(t_records, j_records):
        assert {k: v for k, v in tr.items() if k != "metric_value"} == \
            {k: v for k, v in jr.items() if k != "metric_value"}
        if isinstance(jr["metric_value"], str):
            assert tr["metric_value"] == jr["metric_value"]
        else:
            assert tr["metric_value"] == pytest.approx(jr["metric_value"], rel=1e-6, abs=1e-9)
    assert tm.step(40, {}, torch.tensor(0.0)) == {}
    assert ActivityMonitor({"enabled": False}).step(10, {}, torch.tensor(1.0)) == {}


def _classification_config(**overrides):
    return {"enabled": True, "method": "threshold_groupnorm_activity", "threshold": 0.2,
            "target_metric_key": "mean_abs_activation_per_channel",
            "layers_to_classify": [f"vae.{NORM}.output", "vae.decoder.conv_norm_out.output"],
            **overrides}


def _tracked(values):
    return {f"vae.{NORM}.output": {"mean_abs_activation_per_channel": values,
                                   "std_activation": 0.5},
            "vae.encoder.conv_norm_out.output": {
                "mean_abs_activation_per_channel": np.zeros(32, np.float32)},
            "vae.decoder.conv_norm_out.output": {
                "mean_abs_activation_per_channel": np.zeros(5, np.float32)}}


def test_classifier_matches_jax(tiny):
    model, params = tiny
    assert naming.groupnorm_channel_map(model) == jnaming.groupnorm_channel_map(params)
    values = np.linspace(0.0, 1.0, 16).astype(np.float32)
    for config in (_classification_config(), _classification_config(layers_to_classify=[]),
                   _classification_config(enabled=False),
                   _classification_config(method="other")):
        t = RegionClassifier(model, config).classify(_tracked(values), 10)
        j = JaxClassifier(params, config).classify(_tracked(values), 10)
        assert t == j
    flagged = RegionClassifier(model, _classification_config()).classify(_tracked(values), 10)
    assert flagged[f"vae.{NORM}.output"]["param_name_scale"] == f"{NORM}.weight"
    assert flagged[f"vae.{NORM}.output"]["inactive_channel_indices"] == [0, 1, 2]


@pytest.mark.parametrize("strategy", ["gentle_nudge_groupnorm_scale", "reset_groupnorm_scale"])
@pytest.mark.parametrize("interval", [1, 10])
def test_nudger_matches_jax(tiny, strategy, interval):
    _model, params = tiny
    model = AutoencoderKL(VAEConfig.tiny())
    model.load_state_dict(_model.state_dict())
    name = f"{NORM}.weight"
    gamma0 = np.linspace(0.5, 1.45, 16).astype(np.float32)
    naming.set_param(model, name, gamma0)
    params = jnaming.set_param(params, name, jnp.asarray(gamma0))
    config = {"enabled": True, "strategy": strategy, "nudge_factor": 1.1,
              "max_scale_value": 1.5, "intervention_interval": interval}
    results = {f"vae.{NORM}.output": {"param_name_scale": name,
                                      "inactive_channel_indices": [0, 3, 15, 99]},
               "vae.other.output": {"param_name_scale": "no.such.weight",
                                    "inactive_channel_indices": [0]}}
    th, jh = InterventionHandler(config), JaxHandler(config)
    other = {k: v.clone() for k, v in model.state_dict().items() if k != name}
    for step in (0, 1, 5, 10, 20):
        assert th._interval_due(step) == jh._interval_due(step)
        th.intervene(model, results, step)
        params = jh.intervene(params, results, step)
        np.testing.assert_array_equal(_port_gamma(model, name), _jax_gamma(params, name))
        if th._interval_due(step):
            assert th.num_nudges_applied == jh.num_nudges_applied == 3
    # nothing but the named gamma changed, and only on the classified channels
    assert all(torch.equal(v, other[k]) for k, v in model.state_dict().items() if k != name)
    final = _port_gamma(model, name)
    untouched = [i for i in range(16) if i not in (0, 3, 15)]
    np.testing.assert_array_equal(final[untouched], gamma0[untouched])
    if strategy == "gentle_nudge_groupnorm_scale":
        assert final[15] == np.float32(1.5)  # the cap
    else:
        assert final[0] == 1.0


@pytest.mark.parametrize("dead_type", ["threshold", "percent_of_mean", "both", "typo"])
def test_dead_neuron_percentages_match_jax(tiny, dead_type):
    _model, _params = tiny
    model = AutoencoderKL(VAEConfig.tiny())
    model.load_state_dict(_model.state_dict())
    with torch.no_grad():
        model.encoder.conv_in.weight[:2].zero_()
        model.encoder.conv_in.bias.zero_()
        model.decoder.conv_in.weight[0, 0, 0, 0] = 1e-4
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    params = unflatten_params(abstract_params(JaxConfig.tiny()), state)
    raw = ["vae.encoder.conv_in.weight", "vae.encoder.conv_norm_out.weight", "vae.missing"]
    kwargs = dict(threshold=1e-3, mean_percentage=0.05, dead_type=dead_type,
                  target_layer_names_for_raw_weights=raw)
    t, j = DeadNeuronTracker(**kwargs), JaxDeadNeuronTracker(**kwargs)
    t.track_dead_neurons(model, 7)
    j.track_dead_neurons(params, 7)
    assert set(t.percent_history) == set(j.percent_history)
    for name, hist in j.percent_history.items():
        assert t.percent_history[name][0][0] == hist[0][0] == 7
        assert t.percent_history[name][0][1] == pytest.approx(hist[0][1], abs=1e-4), name
    if dead_type != "typo":
        assert t.percent_history["encoder.conv_in.bias"][0][1] == 100.0
    assert set(t.weights_history) == set(j.weights_history)
    for name, snaps in j.weights_history.items():
        np.testing.assert_array_equal(t.weights_history[name][0], snaps[0])


def test_port_modules_import_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import importlib\n"
        "for name in ['vae_channel_dynamics_tpu_torch.ops.stats',\n"
        "             'vae_channel_dynamics_tpu_torch.ops.group_norm_kernel',\n"
        "             'vae_channel_dynamics_tpu_torch.ops.group_norm',\n"
        "             'vae_channel_dynamics_tpu_torch.models',\n"
        "             'vae_channel_dynamics_tpu_torch.training',\n"
        "             'vae_channel_dynamics_tpu_torch.training.state',\n"
        "             'vae_channel_dynamics_tpu_torch.training.step',\n"
        "             'vae_channel_dynamics_tpu_torch.utils.naming',\n"
        "             'vae_channel_dynamics_tpu_torch.tracking',\n"
        "             'vae_channel_dynamics_tpu_torch.tracking.monitor',\n"
        "             'vae_channel_dynamics_tpu_torch.tracking.deadneuron',\n"
        "             'vae_channel_dynamics_tpu_torch.classification',\n"
        "             'vae_channel_dynamics_tpu_torch.intervention']:\n"
        "    importlib.import_module(name)\n"
        "assert not any(m == 'vae_channel_dynamics_tpu' or\n"
        "               m.startswith('vae_channel_dynamics_tpu.') for m in sys.modules)\n"
        "print('ok')\n"
    )
    root = __file__.rsplit("/tests/", 1)[0]
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
