"""The port's end-of-run plots (``utils/plotting.py``) against the JAX
package's plotters, on the CPU: the same files under the same names, and
the data each figure plots (not its pixels); where matplotlib does not
import, each plot logs one warning that names it and is skipped, and the
CSVs are still written.
"""

import logging
import os
import sys

import numpy as np
import pandas as pd
import pytest
import torch
from test_torch_trainer import _resume_cfg

from vae_channel_dynamics_tpu.utils import plotting as jax_plotting
from vae_channel_dynamics_tpu_torch.utils import plotting

LAYERS = [f"encoder.down_blocks.{i}.resnets.0.conv1.weight" for i in range(4)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The Trainer runs on one intra-op thread, beside the other test
    workers (tests/test_torch_flash_bwd_f32.py's ``one_thread``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _plot_cfg(tmp_path, name):
    """The Trainer for 2 steps with the dead-weight tracker, the monitor and
    a classifier that flags every channel, so that every plot has data."""
    cfg = _resume_cfg(tmp_path, name, stop_after=2)
    cfg["dead_neuron_tracking"] = {"enabled": True, "track_interval": 1,
                                   "target_layer_names_for_raw_weights": [
                                       "decoder.conv_out.weight"]}
    cfg["tracking"]["track_interval"] = 1
    cfg["classification"]["threshold"] = 1e6
    cfg["intervention"]["intervention_interval"] = 1
    return cfg


def _histories():
    rng = np.random.default_rng(3)
    percent = {name: [(step, float(rng.uniform(0, 10 * (i + 1)))) for step in (10, 20, 30)]
               for i, name in enumerate(LAYERS)}
    weights = {"decoder.conv_out.weight": [rng.standard_normal((3, 8, 3, 3)).astype(np.float32)],
               "decoder.mid_block.attentions.0.to_q.weight":
                   [rng.standard_normal((8, 8)).astype(np.float32)],
               "decoder.conv_out.bias": [rng.standard_normal(3).astype(np.float32)]}
    return percent, weights


def _activity_csv(path):
    rows = []
    for step in (2, 4, 6):
        for i, layer in enumerate(("vae.encoder.conv_in.output", "vae.decoder.norm.output")):
            for stat in ("mean", "std"):
                rows.append({"global_step": step, "layer_identifier": layer,
                             "original_metric_name": "mean_abs_activation_per_channel",
                             "metric_type": f"per_channel_overall_{stat}",
                             "metric_value": 0.1 * step + i})
            rows.append({"global_step": step, "layer_identifier": layer,
                         "original_metric_name": "std_activation", "metric_type": "scalar",
                         "metric_value": 1.0})
    pd.DataFrame(rows).to_csv(path, index=False)
    return rows


def _intervention_csv(path):
    with open(path, "w") as f:
        f.write("2,5,3\n4,2,1\n")


def _draw_all(module, out, percent, weights, csv, history):
    module.DeadNeuronPlotter(top_n_layers=2, threshold=1e-8, output_dir=str(out)).plot_all(
        percent_history=percent, weights_history=weights)
    module.ActivityPlotter(output_dir=str(out / "activity_plots")).plot_activation_stats_evolution(
        csv_path=str(csv))
    module.plot_dead_vs_nudge(str(history), str(out / "dead_vs_nudge.png"), nudge_factor=1.05)


def _files(root):
    return sorted(os.path.relpath(os.path.join(r, f), root)
                  for r, _d, fs in os.walk(root) for f in fs)


def test_plots_have_the_jax_files_and_data(tmp_path):
    percent, weights = _histories()
    csv, history = tmp_path / "stats.csv", tmp_path / "history.csv"
    rows = _activity_csv(csv)
    _intervention_csv(history)
    _draw_all(plotting, tmp_path / "port", percent, weights, csv, history)
    _draw_all(jax_plotting, tmp_path / "jax", percent, weights, csv, history)
    files = _files(tmp_path / "port")
    assert files == _files(tmp_path / "jax")
    assert files == sorted([
        "activity_plots/activation_evo_mean_mean.png", "dead_neuron_percentage_history.csv",
        "dead_neuron_percentage_history.png", "dead_vs_nudge.png",
        "filter_magnitudes_decoder_conv_out_weight.png",
        "heatmap_decoder_mid_block_attentions_0_to_q_weight.png"])
    for name in files:
        assert os.path.getsize(tmp_path / "port" / name) > 0, name
    pd.testing.assert_frame_equal(
        pd.read_csv(tmp_path / "port" / "dead_neuron_percentage_history.csv"),
        pd.read_csv(tmp_path / "jax" / "dead_neuron_percentage_history.csv"))

    # the dead-weight lines: the top 2 layers by their peak, step by step
    series = plotting.dead_history_series(plotting.dead_history_frame(percent), 2)
    peaks = {name: max(p for _s, p in hist) for name, hist in percent.items()}
    assert list(series) == sorted(peaks, key=peaks.get, reverse=True)[:2]
    for name, d in series.items():
        assert d["step"].tolist() == [10, 20, 30]
        assert d["percentage"].tolist() == [p for _s, p in percent[name]]
    # the filter bars: mean |w| per output channel
    w = weights["decoder.conv_out.weight"][0]
    np.testing.assert_allclose(plotting.filter_magnitudes(w),
                               [np.abs(w[o]).mean() for o in range(3)], rtol=1e-6)
    # the activity lines: the per-channel overall means of each layer
    lines = plotting.activity_series(str(csv), "mean_abs_activation_per_channel",
                                     "per_channel_overall_mean")
    assert sorted(lines) == ["vae.decoder.norm.output", "vae.encoder.conv_in.output"]
    for layer, d in lines.items():
        want = [r["metric_value"] for r in rows if r["layer_identifier"] == layer
                and r["metric_type"] == "per_channel_overall_mean"]
        np.testing.assert_allclose(d["metric_value"].to_numpy(), want)
        assert d["global_step"].tolist() == [2, 4, 6]


def test_plots_without_matplotlib_warn_once_each(tmp_path, monkeypatch, caplog):
    percent, weights = _histories()
    csv, history = tmp_path / "stats.csv", tmp_path / "history.csv"
    _activity_csv(csv)
    _intervention_csv(history)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with caplog.at_level(logging.WARNING, logger=plotting.__name__):
        _draw_all(plotting, tmp_path / "port", percent, weights, csv, history)
    warned = [r.getMessage() for r in caplog.records if "matplotlib" in r.getMessage()]
    # the history, two weight snapshots (the 1-D bias has no figure), the
    # activity and dead vs nudge
    assert len(warned) == 5, warned
    assert all("is not drawn" in w for w in warned)
    assert _files(tmp_path / "port") == ["dead_neuron_percentage_history.csv"]


def test_trainer_and_compare_runs_skip_plots_without_matplotlib(tmp_path, monkeypatch):
    """The run goes on: the Trainer writes its CSVs and final model, and
    compare_runs its table, with no plot."""
    from vae_channel_dynamics_tpu_torch.tools import compare_runs
    from vae_channel_dynamics_tpu_torch.training.loop import Trainer

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    summary = Trainer(_plot_cfg(tmp_path, "noplots"), device="cpu").train()
    run = os.path.dirname(summary["final_model_dir"])
    assert os.path.exists(os.path.join(run, "dead_neuron_percentage_history.csv"))
    assert os.path.exists(os.path.join(run, "tracked_activation_stats.csv"))
    assert not [f for f in _files(run) if f.endswith(".png") and "logit_lens" not in f]
    out = tmp_path / "cmp.md"
    assert compare_runs.main(["--baseline", run, "--treatment", run, "--output", str(out)]) == 0
    assert out.exists() and not (tmp_path / "cmp_activity.png").exists()


@pytest.fixture(scope="module")
def drawn_run(tmp_path_factory):
    from vae_channel_dynamics_tpu_torch.training.loop import Trainer

    summary = Trainer(_plot_cfg(tmp_path_factory.mktemp("plots"), "drawn"), device="cpu").train()
    return os.path.dirname(summary["final_model_dir"])


@pytest.mark.parametrize("name", ["dead_neuron_percentage_history.png",
                                  "filter_magnitudes_decoder_conv_out_weight.png",
                                  "activity_plots/activation_evo_mean_mean.png",
                                  "dead_vs_nudge.png"])
def test_trainer_draws_the_jax_plots(drawn_run, name):
    """With matplotlib the Trainer draws the JAX Trainer's end-of-run
    plots under their names."""
    assert os.path.getsize(os.path.join(drawn_run, name)) > 0, name
