"""The port's Trainer with ``parallel.spatial: 2`` on two gloo ranks (one
spatial group: each rank holds 16 of the 32 image rows) against one process,
on the CPU.

One spawn of two ranks runs, in order: the Trainer for 6 steps (the tiny
two-level model at 32px, fp32, ``remat: full`` so that every resnet's
collectives run again in the recompute, the mid block's attention over
gathered keys, step validation, the control loop nudging GroupNorm scales,
the taps with ``std_activation`` and a full activation map); the same run
stopped at step 4 and resumed at two ranks from its checkpoint; the same
run with ``kernel_impl: fused``, which runs ``auto`` with JAX's warning,
since the fused kernels exchange no halo rows; and the same run under
``remat: conv``, whose backward computes each conv's input again, its
GroupNorm's all-reduce included.

- The spatial run equals one process at the same batch: the losses step by
  step and the validation losses within 1e-5 relative, the final parameters
  within 1e-5 of each tensor's largest entry (Adam's epsilon of 1 keeps the
  updates linear in the gradients), the tracked statistics within 1e-5, the
  same nudges (and some fire); both ranks end with the same parameter bits.
- The checkpoint resumes at two ranks bit for bit.
- The fused run logs the warning and trains as the ``auto`` run, bit for
  bit; the ``remat: conv`` run trains as one process within 1e-5.
"""

import json
import os

import numpy as np
import pandas as pd
import pytest
from torch_parallel_ranks import run_ranks

from vae_channel_dynamics_tpu_torch.training.loop import Trainer

STEPS = 6
WARNING = ("model.kernel_impl='fused' only supports pure data-parallel meshes, not "
           "{'data': 1, 'spatial': 2} — falling back to kernel_impl='auto'.")


def _cfg(out_dir, name, spatial=1, stop_after=0, impl="auto", remat="full"):
    return {
        "run_name": name,
        "output_dir": str(out_dir),
        "seed": 5,
        "model": {"pretrained_vae_name": None, "architecture": "tiny", "remat": remat,
                  "kernel_impl": impl},
        "data": {"dataset_name": "synthetic://shapes?num_samples=12", "resolution": 32,
                 "batch_size": 2, "do_validation": True,
                 "validation_dataset_name": "synthetic://shapes?num_samples=4"},
        "training": {"num_train_epochs": 1, "learning_rate": 1e-3, "kl_weight": 1e-6,
                     "lr_warmup_steps": 2, "mixed_precision": "no", "adam_epsilon": 1.0,
                     "ema_decay": 0.9, "stop_after_steps": stop_after,
                     "validation_steps": 3},
        "logging": {"log_interval": 1, "report_to": "jsonl"},
        "saving": {"save_interval_steps": 1000},
        "parallel": {"spatial": spatial, "spatial_conv": "shard_map"} if spatial > 1 else {},
        "tracking": {"enabled": True, "track_interval": 2, "target_layers": [
            {"name": "vae.encoder.down_blocks.0.resnets.0.norm1", "capture_point": "output",
             "metrics": ["mean_abs_activation_per_channel", "std_activation"]},
            {"name": "vae.decoder.up_blocks.0.resnets.0.conv1", "capture_point": "output",
             "metrics": ["full_activation_map", "zero_fraction_per_channel"]}]},
        "classification": {"enabled": True, "method": "threshold_groupnorm_activity",
                           "threshold": 0.6,
                           "target_metric_key": "mean_abs_activation_per_channel",
                           "layers_to_classify": [
                               "vae.encoder.down_blocks.0.resnets.0.norm1.output"]},
        "intervention": {"enabled": True, "strategy": "gentle_nudge_groupnorm_scale",
                         "nudge_factor": 1.05, "max_scale_value": 1.5,
                         "intervention_interval": 2},
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spatial_trainer")
    sp = tmp / "sp"
    spawn = [
        {"kind": "trainer", "config": _cfg(sp, "spatial", spatial=2)},
        {"kind": "trainer", "config": _cfg(sp, "resumed", spatial=2, stop_after=4)},
        {"kind": "trainer", "config": _cfg(sp, "resumed", spatial=2),
         "resume_from": str(sp / "resumed" / "chkpt-4")},
        {"kind": "trainer", "config": _cfg(sp, "fused", spatial=2, impl="fused")},
        {"kind": "trainer", "config": _cfg(sp, "remat_conv", spatial=2, remat="conv")},
    ]
    run_ranks("runs", {"runs": spawn, "out": str(tmp / "sp_run")}, str(tmp / "ranks"),
              timeout=150)
    one = Trainer(_cfg(tmp / "one", "one"), device="cpu")
    one_summary = one.train()

    def params(i, rank):
        return dict(np.load(f"{tmp / 'sp_run'}_{i}_rank{rank}.npz"))

    logs = [open(tmp / "ranks" / f"runs_rank{r}.log").read() for r in range(2)]
    return {"tmp": tmp, "sp": {i: params(i, 0) for i in range(5)},
            "sp_rank1": {i: params(i, 1) for i in range(4)},
            "sp_summary": json.load(open(f"{tmp / 'sp_run'}_0.json")),
            "one": {k: p.detach().numpy().copy() for k, p in one.model.named_parameters()},
            "one_summary": one_summary, "logs": logs}


def _records(run_dir, key):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return {r["step"]: r[key] for r in recs if key in r}


def _near(got, want, what, rel=1e-5):
    assert set(got) == set(want)
    for k, v in want.items():
        scale = max(float(np.abs(v).max()), 1e-12)
        err = float(np.abs(got[k].astype(np.float64) - v).max())
        assert err <= rel * scale, f"{what} {k}: {err:.3e} vs {scale:.3e}"


@pytest.mark.parametrize("key", ["train_loss_step", "grad_norm",
                                 "validation/avg_total_loss"])
def test_spatial_run_matches_one_process(runs, key):
    tmp = runs["tmp"]
    one = _records(tmp / "one" / "one", key)
    got = _records(tmp / "sp" / "spatial", key)
    assert sorted(got) == sorted(one) and len(one) >= 2
    for step, value in one.items():
        assert got[step] == pytest.approx(value, rel=1e-5), (key, step)


def test_spatial_parameters_match_one_process(runs):
    _near(runs["sp"][0], runs["one"], "spatial")
    assert runs["sp_summary"]["global_step"] == runs["one_summary"]["global_step"] == STEPS
    assert runs["sp_summary"]["images_seen"] == runs["one_summary"]["images_seen"] == 12
    for k, v in runs["sp"][0].items():
        np.testing.assert_array_equal(runs["sp_rank1"][0][k], v, err_msg=k)


def test_spatial_taps_and_nudges_match_one_process(runs):
    tmp = runs["tmp"]
    frames = {name: pd.read_csv(tmp / path / "tracked_activation_stats.csv")
              for name, path in (("one", "one/one"), ("sp", "sp/spatial"))}
    assert len(frames["sp"]) == len(frames["one"]) > 0
    assert {"mean_abs_activation_per_channel", "std_activation",
            "zero_fraction_per_channel"} <= set(frames["one"]["original_metric_name"])
    got, want = (pd.to_numeric(frames[k]["metric_value"], errors="coerce") for k in ("sp", "one"))
    np.testing.assert_allclose(got.to_numpy(np.float64), want.to_numpy(np.float64), rtol=1e-5,
                               atol=1e-7)
    # the full map's row records its shape: the whole image's rows, gathered
    shapes = frames["one"]["metric_value"][want.isna()]
    assert list(frames["sp"]["metric_value"][got.isna()]) == list(shapes)
    assert "(2, 32, 16, 16)" in set(shapes)
    rows = {}
    for name, path in (("one", tmp / "one" / "one"), ("sp", tmp / "sp" / "spatial")):
        with open(path / "intervention_history.csv") as f:
            rows[name] = f.read().split()
    assert rows["sp"] == rows["one"]
    assert any(int(r.split(",")[2]) > 0 for r in rows["one"])


def test_spatial_checkpoint_resumes_bit_for_bit(runs):
    for k, v in runs["sp"][0].items():
        np.testing.assert_array_equal(runs["sp"][2][k], v, err_msg=k)
    tmp = runs["tmp"]
    assert (_records(tmp / "sp" / "resumed", "train_loss_step")
            == _records(tmp / "sp" / "spatial", "train_loss_step"))


def test_fused_on_a_spatial_mesh_warns_and_runs_auto(runs):
    assert WARNING in runs["logs"][0]
    for k, v in runs["sp"][0].items():
        np.testing.assert_array_equal(runs["sp"][3][k], v, err_msg=k)


def test_spatial_remat_conv_matches_one_process(runs):
    _near(runs["sp"][4], runs["one"], "remat conv")
    one = _records(runs["tmp"] / "one" / "one", "train_loss_step")
    got = _records(runs["tmp"] / "sp" / "remat_conv", "train_loss_step")
    assert sorted(got) == sorted(one)
    for step, value in one.items():
        assert got[step] == pytest.approx(value, rel=1e-5), step
