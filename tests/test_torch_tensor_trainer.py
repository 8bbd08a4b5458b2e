"""The port's Trainer with ``parallel.tensor`` on gloo ranks, against one
process, on the CPU.

One spawn of two ranks (one tensor group: each rank holds half of every
channel axis ``_channel_axis`` cuts) runs, in order: the Trainer for 4
steps (the tiny two-level model at 32px, fp32, ``remat: full``, EMA, step
validation through the eval step on the rank's blocks, the taps with
``std_activation``, ``zero_fraction_per_channel`` on the encoder's
column-parallel ``conv_in``, a full activation map, the control loop
nudging GroupNorm scales read whole and written back as the rank's block,
a checkpoint at step 2, and ``kernel_impl: fused`` with ``attention_impl:
flash``, which run ``auto`` with JAX's two warnings); then the same run
resumed from its gathered step-2 checkpoint.

- The tensor run logs both warnings and equals one process running
  ``auto`` at the same batch: the losses, grad norms and validation losses
  step by step within 1e-5 relative, the final parameters within 1e-5 of
  each tensor's largest entry (Adam's epsilon of 1 keeps the updates
  linear in the gradients), the tracked statistics within 1e-5, the same
  nudges (and some fire); both ranks end with the same parameter bits.
- Its checkpoint and ``final_model`` are the one-card files: the same
  keys and shapes (the taps' running sums whole), the values as above.
- The checkpoint resumes at two ranks bit for bit.

A second spawn runs ``configs/smoke_spatial_tensor.yaml`` at its shape, 2
data x 2 spatial x 2 tensor ranks (``shard_map``, ZeRO-1 + ZeRO-3, the
control loop live), cut to reach one nudge: ``output_dir`` under the test's
tmp dir, ``num_train_epochs`` 1, ``intervention_interval`` 2 (the config's
4) and ``stop_after_steps`` 2 (the config's 2 epochs run 8), so its
epoch-end validation is skipped as for any stop. It is held to one process
at the same global batch (8 images a step): the losses within 1e-5, the
parameters' deltas within 2e-3 of their largest entry (the config's Adam
epsilon of 1e-8 makes a near-zero gradient's update sign-like), and the
same nudge.
"""

import json
import os

import numpy as np
import pytest
import torch
from torch_parallel_ranks import REPO, run_ranks

from vae_channel_dynamics_tpu_torch.training.loop import Trainer
from vae_channel_dynamics_tpu_torch.utils.config_utils import load_config

STEPS = 4
FUSED_WARNING = ("model.kernel_impl='fused' only supports pure data-parallel meshes, not "
                 "{'data': 1, 'tensor': 2} — falling back to kernel_impl='auto'.")
FLASH_WARNING = ("model.attention_impl='flash' supports data/spatial meshes, not "
                 "{'data': 1, 'tensor': 2} — falling back to attention_impl='auto'.")
SMOKE_STEPS = 2


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """This process's runs on one intra-op thread, as the ranks' are, beside
    the other test workers (tests/test_torch_flash_bwd_f32.py's
    ``one_thread``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(out_dir, name, tensor=1, impl="auto", attn="auto"):
    return {
        "run_name": name,
        "output_dir": str(out_dir),
        "seed": 5,
        "model": {"pretrained_vae_name": None, "architecture": "tiny", "remat": "full",
                  "kernel_impl": impl, "attention_impl": attn},
        "data": {"dataset_name": "synthetic://shapes?num_samples=8", "resolution": 32,
                 "batch_size": 2, "do_validation": True,
                 "validation_dataset_name": "synthetic://shapes?num_samples=4"},
        "training": {"num_train_epochs": 1, "learning_rate": 1e-3, "kl_weight": 1e-6,
                     "lr_warmup_steps": 2, "mixed_precision": "no", "adam_epsilon": 1.0,
                     "ema_decay": 0.9, "validation_steps": 2},
        "logging": {"log_interval": 1, "report_to": "jsonl"},
        "saving": {"save_interval_steps": 2},
        "parallel": {"tensor": tensor} if tensor > 1 else {},
        "tracking": {"enabled": True, "track_interval": 2, "target_layers": [
            {"name": "vae.encoder.down_blocks.0.resnets.0.norm1", "capture_point": "output",
             "metrics": ["mean_abs_activation_per_channel", "std_activation"]},
            {"name": "vae.encoder.conv_in", "capture_point": "output",
             "metrics": ["zero_fraction_per_channel", "mean_activation"]},
            {"name": "vae.decoder.up_blocks.0.resnets.0.conv1", "capture_point": "output",
             "metrics": ["full_activation_map"]}]},
        "classification": {"enabled": True, "method": "threshold_groupnorm_activity",
                           "threshold": 0.6,
                           "target_metric_key": "mean_abs_activation_per_channel",
                           "layers_to_classify": [
                               "vae.encoder.down_blocks.0.resnets.0.norm1.output"]},
        "intervention": {"enabled": True, "strategy": "gentle_nudge_groupnorm_scale",
                         "nudge_factor": 1.05, "max_scale_value": 1.5,
                         "intervention_interval": 2},
    }


def _smoke_cfg(out_dir, one_process=False):
    cfg = load_config(os.path.join(REPO, "configs", "smoke_spatial_tensor.yaml"))
    cfg["output_dir"] = str(out_dir)
    cfg["training"].update(num_train_epochs=1, stop_after_steps=SMOKE_STEPS)
    cfg["intervention"]["intervention_interval"] = SMOKE_STEPS
    if one_process:
        # the same global batch: 2 data ranks of 4 images
        cfg["parallel"] = {}
        cfg["data"]["batch_size"] = 2 * cfg["data"]["batch_size"]
    return cfg


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tensor_trainer")
    tp = tmp / "tp"
    spawn = [
        {"kind": "trainer", "config": _cfg(tp, "tensor", tensor=2, impl="fused", attn="flash")},
        {"kind": "trainer", "config": _cfg(tp, "resumed", tensor=2, impl="fused", attn="flash"),
         "resume_from": str(tp / "tensor" / "chkpt-2")},
    ]
    run_ranks("runs", {"runs": spawn, "out": str(tmp / "tp_run")}, str(tmp / "ranks"),
              timeout=150)
    run_ranks("runs", {"runs": [{"kind": "trainer", "config": _smoke_cfg(tmp / "smoke")}],
                       "out": str(tmp / "smoke_run")}, str(tmp / "smoke_ranks"), world=8,
              timeout=150)
    one = Trainer(_cfg(tmp / "one", "one"), device="cpu")
    one_summary = one.train()
    smoke_one = Trainer(_smoke_cfg(tmp / "smoke_one", one_process=True), device="cpu")
    smoke_one.train()

    def params(tag, i, rank):
        return dict(np.load(f"{tmp / tag}_{i}_rank{rank}.npz"))

    logs = [open(tmp / "ranks" / f"runs_rank{r}.log").read() for r in range(2)]
    return {"tmp": tmp, "tp": {i: params("tp_run", i, 0) for i in range(2)},
            "tp_rank1": params("tp_run", 0, 1),
            "tp_summary": json.load(open(f"{tmp / 'tp_run'}_0.json")),
            "one": {k: p.detach().numpy().copy() for k, p in one.model.named_parameters()},
            "one_summary": one_summary, "logs": logs,
            "smoke": [params("smoke_run", 0, r) for r in range(8)],
            "smoke_one": {k: p.detach().numpy().copy()
                          for k, p in smoke_one.model.named_parameters()}}


def _records(run_dir, key):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return {r["step"]: r[key] for r in recs if key in r}


def _near(got, want, what, rel=1e-5):
    assert set(got) == set(want)
    for k, v in want.items():
        v = np.asarray(v, np.float64)
        scale = max(float(np.abs(v).max()), 1e-12)
        err = float(np.abs(np.asarray(got[k], np.float64) - v).max())
        assert err <= rel * scale, f"{what} {k}: {err:.3e} vs {scale:.3e}"


@pytest.mark.parametrize("key", ["train_loss_step", "grad_norm",
                                 "validation/avg_total_loss"])
def test_tensor_run_matches_one_process(runs, key):
    tmp = runs["tmp"]
    one = _records(tmp / "one" / "one", key)
    got = _records(tmp / "tp" / "tensor", key)
    assert sorted(got) == sorted(one) and len(one) >= 2
    for step, value in one.items():
        assert got[step] == pytest.approx(value, rel=1e-5), (key, step)


def test_tensor_parameters_match_one_process(runs):
    _near(runs["tp"][0], runs["one"], "tensor")
    assert runs["tp_summary"]["global_step"] == runs["one_summary"]["global_step"] == STEPS
    assert runs["tp_summary"]["images_seen"] == runs["one_summary"]["images_seen"] == 8
    for k, v in runs["tp"][0].items():
        np.testing.assert_array_equal(runs["tp_rank1"][k], v, err_msg=k)


def test_tensor_taps_and_nudges_match_one_process(runs):
    import pandas as pd

    tmp = runs["tmp"]
    frames = {name: pd.read_csv(tmp / path / "tracked_activation_stats.csv")
              for name, path in (("one", "one/one"), ("tp", "tp/tensor"))}
    assert len(frames["tp"]) == len(frames["one"]) > 0
    assert {"mean_abs_activation_per_channel", "std_activation", "mean_activation",
            "zero_fraction_per_channel"} <= set(frames["one"]["original_metric_name"])
    got, want = (pd.to_numeric(frames[k]["metric_value"], errors="coerce") for k in ("tp", "one"))
    np.testing.assert_allclose(got.to_numpy(np.float64), want.to_numpy(np.float64), rtol=1e-5,
                               atol=1e-7)
    # the full map's row records its shape: every channel, gathered
    shapes = frames["one"]["metric_value"][want.isna()]
    assert list(frames["tp"]["metric_value"][got.isna()]) == list(shapes)
    assert "(2, 32, 16, 16)" in set(shapes)
    rows = {}
    for name, path in (("one", tmp / "one" / "one"), ("tp", tmp / "tp" / "tensor")):
        with open(path / "intervention_history.csv") as f:
            rows[name] = f.read().split()
    assert rows["tp"] == rows["one"]
    assert any(int(r.split(",")[2]) > 0 for r in rows["one"])


@pytest.mark.parametrize("part", ["state", "vae"])
def test_tensor_checkpoint_is_the_one_card_file(runs, part):
    from vae_channel_dynamics_tpu_torch.models import io as model_io

    tmp = runs["tmp"]
    dirs = {name: tmp / path / "final_model" for name, path in (("one", "one/one"),
                                                                 ("tp", "tp/tensor"))}
    if part == "vae":
        (cfg_tp, got), (cfg_one, want) = (model_io.load_model_dir(str(dirs[k] / "vae"))
                                          for k in ("tp", "one"))
        assert cfg_tp == cfg_one
        _near({k: v.numpy() for k, v in got.items()},
              {k: v.numpy() for k, v in want.items()}, "vae")
        return
    got, want = (torch.load(dirs[k] / "state" / "train_state.pt", weights_only=True)
                 for k in ("tp", "one"))
    assert set(got) == set(want) and got["step"] == want["step"] == STEPS
    for field in ("params", "ema_params", "stats_acc"):
        assert {k: v.shape for k, v in got[field].items()} == \
            {k: v.shape for k, v in want[field].items()}, field
        _near({k: v.numpy() for k, v in got[field].items()},
              {k: v.numpy() for k, v in want[field].items()}, field)
    for field in ("mu", "nu"):
        assert [t.shape for t in got["opt"][field]] == [t.shape for t in want["opt"][field]]
    assert got["opt"]["count"] == want["opt"]["count"]


def test_tensor_checkpoint_resumes_bit_for_bit(runs):
    for k, v in runs["tp"][0].items():
        np.testing.assert_array_equal(runs["tp"][1][k], v, err_msg=k)
    tmp = runs["tmp"]
    got = _records(tmp / "tp" / "resumed", "train_loss_step")
    want = _records(tmp / "tp" / "tensor", "train_loss_step")
    assert sorted(got) == [3, 4] and all(got[s] == want[s] for s in got)


def test_fused_and_flash_on_a_tensor_mesh_warn_and_run_auto(runs):
    """The run asked for ``fused`` and ``flash``; it logged JAX's two
    warnings and trained as the one-process ``auto`` run (the parity tests
    above hold it there)."""
    assert FUSED_WARNING in runs["logs"][0] and FLASH_WARNING in runs["logs"][0]
    _near(runs["tp"][0], runs["one"], "fused-and-flash run against auto")


def test_smoke_spatial_tensor_config_runs_and_nudges(runs):
    """``configs/smoke_spatial_tensor.yaml`` at 2 x 2 x 2 ranks: the same
    losses, parameters and nudge as one process at its global batch."""
    tmp = runs["tmp"]
    got = _records(tmp / "smoke" / "smoke_spatial_tensor", "train_loss_step")
    want = _records(tmp / "smoke_one" / "smoke_spatial_tensor", "train_loss_step")
    assert sorted(got) == sorted(want) == [SMOKE_STEPS]
    for step, value in want.items():
        assert got[step] == pytest.approx(value, rel=1e-5), step
    # the config's Adam epsilon (1e-8) makes an update of a near-zero
    # gradient sign-like, so the parameters are held by their deltas from
    # the seeded start, within 2e-3 of each delta's largest entry (the JAX
    # parity steps' bound)
    from vae_channel_dynamics_tpu_torch.training.loop import resolve_model

    start = resolve_model(_smoke_cfg(tmp)["model"], torch.float32, "cpu")
    for k, p in start.named_parameters():
        if k.endswith("to_k.bias"):
            # zero gradient by symmetry: the update is roundoff
            continue
        want = runs["smoke_one"][k].astype(np.float64) - p.detach().numpy()
        got = runs["smoke"][0][k].astype(np.float64) - p.detach().numpy()
        assert np.abs(got - want).max() <= 2e-3 * np.abs(want).max() + 1e-12, k
    for rank in runs["smoke"][1:]:
        for k, v in runs["smoke"][0].items():
            np.testing.assert_array_equal(rank[k], v, err_msg=k)
    rows = {}
    for name in ("smoke", "smoke_one"):
        with open(tmp / name / "smoke_spatial_tensor" / "intervention_history.csv") as f:
            rows[name] = f.read().split()
    assert rows["smoke"] == rows["smoke_one"]
    assert [int(r.split(",")[0]) for r in rows["smoke"]] == [SMOKE_STEPS]
    assert int(rows["smoke"][0].split(",")[2]) > 0
