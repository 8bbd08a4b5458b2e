"""The port's Trainer and training CLI against the JAX package's, on the CPU.

- ``configs/smoke_synthetic.yaml`` (with its logit lens) runs through both
  Trainers and leaves the same non-plot artifact tree, and the same logit
  lens image names: the same
  file names (a checkpoint's ``state/`` is compared as a directory: orbax
  and ``torch.save`` lay it out differently), the same CSV headers and the
  same JSONL keys, record by record. The JAX Trainer shards its batch over
  the suite's 8 virtual CPU devices (tests/conftest.py), so the port gets
  that global batch as its ``batch_size``: both then take the same steps.
- A run stopped at step 4 by ``training.stop_after_steps`` and resumed from
  its checkpoint equals the uninterrupted 6-step run bit for bit: losses,
  control-loop CSVs and final weights.
- ``--device cuda`` raises where there is no GPU.
"""

import copy
import csv
import json
import os

import jax
import numpy as np
import pytest
import torch
import yaml

from vae_channel_dynamics_tpu.training.loop import Trainer as JaxTrainer
from vae_channel_dynamics_tpu_torch import train as train_cli
from vae_channel_dynamics_tpu_torch.models import io as model_io
from vae_channel_dynamics_tpu_torch.training.checkpoint import latest_checkpoint
from vae_channel_dynamics_tpu_torch.training.loop import Trainer
from vae_channel_dynamics_tpu_torch.utils.config_utils import load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLOT_DIRS = ("activity_plots", "logs")


def _tree(run_dir):
    """Relative paths of a run dir without plots; a ``state/`` dir is one
    entry."""
    out = set()
    for root, dirs, files in os.walk(run_dir):
        rel = os.path.relpath(root, run_dir)
        if rel.split(os.sep)[0] in PLOT_DIRS:
            continue
        if os.path.basename(root) == "state":
            out.add(rel)
            dirs[:] = []
            continue
        for f in files:
            if not f.endswith(".png"):
                out.add(os.path.normpath(os.path.join(rel, f)))
    return out


def _csv_header(path):
    with open(path) as f:
        return next(csv.reader(f))


def _jsonl_keys(path):
    with open(path) as f:
        return [sorted(json.loads(line)) for line in f]


@pytest.fixture(scope="module")
def smoke_runs(tmp_path_factory):
    base = load_config(os.path.join(REPO, "configs", "smoke_synthetic.yaml"))
    shards = jax.device_count()
    out = {}
    for side in ("jax", "torch"):
        cfg = copy.deepcopy(base)
        cfg["output_dir"] = str(tmp_path_factory.mktemp(side))
        if side == "jax":
            summary = JaxTrainer(cfg).train()
        else:
            cfg["data"]["batch_size"] *= shards
            cfg["data"]["validation_batch_size"] *= shards
            summary = Trainer(cfg, device="cpu").train()
        out[side] = (os.path.join(cfg["output_dir"], cfg["run_name"]), summary)
    return out


def test_artifact_tree_matches_jax(smoke_runs):
    jax_dir, jax_summary = smoke_runs["jax"]
    torch_dir, torch_summary = smoke_runs["torch"]
    assert torch_summary["global_step"] == jax_summary["global_step"] == 8
    assert torch_summary["images_seen"] == jax_summary["images_seen"]
    tree = _tree(torch_dir)
    assert tree == _tree(jax_dir)
    for must in ("config.yaml", "metrics.jsonl", "tracked_activation_stats.csv",
                 "intervention_history.csv", "dead_neuron_percentage_history.csv",
                 "chkpt-5/state", "chkpt-5/resume_meta.json", "final_model/state",
                 "final_model/vae/config.json"):
        assert os.path.normpath(must) in tree, must


def test_logit_lens_tree_matches_jax(smoke_runs):
    """The lens ran at the same steps on the same layers: the same image
    names under ``logit_lens_visualizations`` (the port draws with PIL)."""
    trees = []
    for side in ("jax", "torch"):
        root = os.path.join(smoke_runs[side][0], "logit_lens_visualizations")
        trees.append(sorted(os.path.relpath(os.path.join(r, f), root)
                            for r, _d, fs in os.walk(root) for f in fs))
    assert trees[0] == trees[1]
    assert trees[1] and all(f.endswith("_single_channel_projections_combined.png")
                            for f in trees[1])


def test_csv_headers_and_jsonl_keys_match_jax(smoke_runs):
    jax_dir, _ = smoke_runs["jax"]
    torch_dir, _ = smoke_runs["torch"]
    for name in ("tracked_activation_stats.csv", "dead_neuron_percentage_history.csv"):
        assert _csv_header(os.path.join(torch_dir, name)) == _csv_header(
            os.path.join(jax_dir, name))
    # intervention_history.csv has no header: step, inactive count, nudges
    with open(os.path.join(torch_dir, "intervention_history.csv")) as f:
        ours = [row for row in csv.reader(f)]
    with open(os.path.join(jax_dir, "intervention_history.csv")) as f:
        theirs = [row for row in csv.reader(f)]
    assert [(r[0], len(r)) for r in ours] == [(r[0], len(r)) for r in theirs]
    assert _jsonl_keys(os.path.join(torch_dir, "metrics.jsonl")) == _jsonl_keys(
        os.path.join(jax_dir, "metrics.jsonl"))
    for name in ("chkpt-5", "final_model"):
        with open(os.path.join(torch_dir, name, "resume_meta.json")) as f:
            ours = json.load(f)
        with open(os.path.join(jax_dir, name, "resume_meta.json")) as f:
            assert ours == json.load(f)


def test_final_model_reloads_with_the_trained_weights(smoke_runs):
    torch_dir, summary = smoke_runs["torch"]
    cfg, state = model_io.load_model_dir(os.path.join(summary["final_model_dir"], "vae"))
    ckpt = torch.load(os.path.join(summary["final_model_dir"], "state", "train_state.pt"),
                      weights_only=True)
    assert state.keys() == ckpt["params"].keys()
    for k, v in state.items():
        assert torch.equal(v, ckpt["params"][k])


def _resume_cfg(out_dir, name, stop_after=0):
    return {
        "run_name": name,
        "output_dir": str(out_dir),
        "seed": 11,
        "model": {"pretrained_vae_name": None, "architecture": "tiny", "remat": "full"},
        "data": {"dataset_name": "synthetic://shapes?num_samples=12", "resolution": 32,
                 "batch_size": 4, "do_validation": False},
        "training": {"num_train_epochs": 2, "learning_rate": 1e-3, "kl_weight": 1e-6,
                     "lr_warmup_steps": 2, "mixed_precision": "no",
                     "stop_after_steps": stop_after},
        "logging": {"log_interval": 1, "report_to": "jsonl"},
        "saving": {"save_interval_steps": 1000},
        "tracking": {"enabled": True, "track_interval": 2, "target_layers": [
            {"name": "vae.encoder.down_blocks.0.resnets.0.norm1", "capture_point": "output",
             "metrics": ["mean_abs_activation_per_channel"]}]},
        "classification": {"enabled": True, "method": "threshold_groupnorm_activity",
                           "threshold": 0.6,
                           "target_metric_key": "mean_abs_activation_per_channel",
                           "layers_to_classify": [
                               "vae.encoder.down_blocks.0.resnets.0.norm1.output"]},
        "intervention": {"enabled": True, "strategy": "gentle_nudge_groupnorm_scale",
                         "nudge_factor": 1.05, "max_scale_value": 1.5,
                         "intervention_interval": 2},
    }


def _losses(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return {r["step"]: r["train_loss_step"] for r in recs if "train_loss_step" in r}


def test_resume_equals_the_uninterrupted_run(tmp_path):
    full = Trainer(_resume_cfg(tmp_path, "full"), device="cpu").train()
    assert full["global_step"] == 6
    first = Trainer(_resume_cfg(tmp_path, "resumed", stop_after=4), device="cpu").train()
    assert first["global_step"] == 4
    ckpt = latest_checkpoint(str(tmp_path / "resumed"))
    assert ckpt.endswith("chkpt-4")
    meta = json.loads(open(os.path.join(ckpt, "resume_meta.json")).read())
    assert meta == {"micro_step": 4, "global_step": 4, "epoch": 1, "in_epoch_batches": 1}
    resumed = Trainer(_resume_cfg(tmp_path, "resumed"), resume_from=ckpt,
                      device="cpu").train()
    assert resumed["global_step"] == 6 and resumed["images_seen"] == 8

    assert _losses(tmp_path / "resumed") == _losses(tmp_path / "full")
    for name in ("intervention_history.csv",):
        assert (open(tmp_path / "resumed" / name).read()
                == open(tmp_path / "full" / name).read())
    _, a = model_io.load_model_dir(os.path.join(full["final_model_dir"], "vae"))
    _, b = model_io.load_model_dir(os.path.join(resumed["final_model_dir"], "vae"))
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_cli_auto_resume_and_device(tmp_path):
    cfg = _resume_cfg(tmp_path, "cli", stop_after=2)
    cfg["tracking"]["enabled"] = False
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    assert train_cli.main(["--config_path", str(path), "--resume_from", "auto",
                           "--device", "cpu"]) == 0
    assert latest_checkpoint(str(tmp_path / "cli")).endswith("chkpt-2")
    cfg["training"]["stop_after_steps"] = 3
    path.write_text(yaml.safe_dump(cfg))
    assert train_cli.main(["--config_path", str(path), "--resume_from", "auto",
                           "--device", "cpu"]) == 0
    assert latest_checkpoint(str(tmp_path / "cli")).endswith("chkpt-3")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            train_cli.main(["--config_path", str(path), "--device", "cuda"])


def test_sigterm_checkpoints_and_leaves_the_loop(tmp_path, monkeypatch):
    """SIGTERM during step 3: the Trainer finishes the step, writes chkpt-3
    with its stream position, skips the final model, and puts the previous
    handler back."""
    import signal

    from vae_channel_dynamics_tpu_torch.training import loop

    make = loop.make_train_step

    def make_with_sigterm(*args, **kwargs):
        step_fn = make(*args, **kwargs)

        def step(state, *a, **kw):
            if state.step == 2:
                os.kill(os.getpid(), signal.SIGTERM)
            return step_fn(state, *a, **kw)

        return step

    monkeypatch.setattr(loop, "make_train_step", make_with_sigterm)
    before = signal.getsignal(signal.SIGTERM)
    summary = Trainer(_resume_cfg(tmp_path, "term"), device="cpu").train()
    assert summary["preempted"] and summary["final_model_dir"] is None
    assert summary["global_step"] == 3
    ckpt = latest_checkpoint(str(tmp_path / "term"))
    assert ckpt.endswith("chkpt-3")
    assert json.loads(open(os.path.join(ckpt, "resume_meta.json")).read())["micro_step"] == 3
    assert not (tmp_path / "term" / "final_model").exists()
    assert signal.getsignal(signal.SIGTERM) is before


def test_gradient_accumulation_and_ema(tmp_path):
    """``gradient_accumulation_steps: 2`` updates on every second micro-step
    (12 samples, batch 4, 2 epochs: 6 micro-steps, 3 updates) and
    ``ema_decay`` exports ``final_model/vae_ema`` beside ``vae``."""
    cfg = _resume_cfg(tmp_path, "accum")
    cfg["training"].update(gradient_accumulation_steps=2, ema_decay=0.9)
    summary = Trainer(cfg, device="cpu").train()
    assert summary["global_step"] == 3 and summary["images_seen"] == 24
    _, raw = model_io.load_model_dir(os.path.join(summary["final_model_dir"], "vae"))
    _, ema = model_io.load_model_dir(summary["ema_model_dir"])
    diffs = [float((raw[k] - ema[k]).abs().max()) for k in raw]
    assert 0.0 < max(diffs) < 0.1
    meta = json.loads(open(os.path.join(summary["final_model_dir"], "resume_meta.json")).read())
    assert meta == {"micro_step": 6, "global_step": 3, "epoch": 1, "in_epoch_batches": 3}


@pytest.mark.parametrize("section,key,value", [
    ("parallel", "slices", 2),
])
def test_unported_options_raise(tmp_path, section, key, value):
    cfg = _resume_cfg(tmp_path, "refused")
    cfg.setdefault(section, {})[key] = value
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Trainer(cfg, device="cpu").train()


def test_spatial_axis_in_one_process_does_not_divide(tmp_path):
    """``parallel.spatial`` is ported (its parity with one process is
    ``tests/test_torch_spatial_trainer.py``); one process is one device,
    which two spatial shards do not divide: JAX ``make_mesh``'s error."""
    cfg = _resume_cfg(tmp_path, "spatial")
    cfg.setdefault("parallel", {})["spatial"] = 2
    with pytest.raises(ValueError, match="1 devices not divisible by slices=1 x spatial=2"):
        Trainer(cfg, device="cpu").train()


def test_resolve_model_loads_a_local_model_dir(tmp_path):
    from vae_channel_dynamics_tpu_torch.models import AutoencoderKL, VAEConfig
    from vae_channel_dynamics_tpu_torch.training.loop import resolve_model

    src = AutoencoderKL(VAEConfig.tiny())
    src.init_weights(torch.Generator().manual_seed(3))
    model_io.save_model_dir(str(tmp_path / "m"), src.config, src.state_dict())
    model = resolve_model({"pretrained_vae_name": str(tmp_path / "m"), "kernel_impl": "pallas",
                           "attention_impl": "flash", "remat": "full"},
                          torch.bfloat16, "cpu")
    assert model.impl == "pallas" and model.dtype == torch.bfloat16
    assert model.decoder.mid_block.attentions[0].attn_impl == "flash"
    for k, v in src.state_dict().items():
        assert torch.equal(model.state_dict()[k], v)
    with pytest.raises(ValueError, match="attention_impl"):
        resolve_model({"architecture": "tiny", "attention_impl": "typo"}, torch.float32, "cpu")
    np.testing.assert_array_equal(
        resolve_model({"architecture": "tiny", "pretrained_vae_name": "hub/id"},
                      torch.float32, "cpu").encoder.conv_in.weight.detach().numpy(),
        resolve_model({"architecture": "tiny", "pretrained_vae_name": None},
                      torch.float32, "cpu").encoder.conv_in.weight.detach().numpy())
