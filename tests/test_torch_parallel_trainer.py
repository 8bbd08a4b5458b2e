"""The port's Trainer and evaluation CLI on two gloo ranks against one
process at the same global batch, on the CPU.

One spawn of two ranks runs, in order: the Trainer with the ZeRO stack
(``shard_optimizer``, ``shard_ema``, ``shard_params``) for 6 steps with the
control loop nudging GroupNorm scales; the same run stopped at step 4 and
resumed at two ranks from its checkpoint; the Trainer under plain DDP; and
the evaluation CLI on the DDP run's model. Each rank reads 2 images a step
(``data.batch_size`` is per rank), the one-process runs 4.

- The two-rank runs equal the one-process run: the losses step by step
  within 1e-5 relative, the final parameters within 1e-5 of each tensor's
  largest entry (Adam's epsilon of 1 keeps the updates linear in the
  gradients, so the rounding of the cross-rank sums does not flip a sign),
  and the same nudges; the ranks end with the same parameter bits.
- The checkpoint saved at two ranks is the world-independent file: resumed
  at two ranks it gives the uninterrupted two-rank run bit for bit, resumed
  in one process it gives the one-process run.
- The evaluation CLI at two ranks (batch 2 a rank, 7 images, so the last
  global batch is padded and a pad row is masked) writes the metrics of one
  process at batch 4 within 1e-6 and byte-equal sample PNGs.
- With 2 micro-steps of gradient accumulation (DDP's ``no_sync`` on the
  first) two ranks train as one process.
"""

import json
import os

import numpy as np
import pytest
from torch_parallel_ranks import run_ranks

from vae_channel_dynamics_tpu_torch import evaluate
from vae_channel_dynamics_tpu_torch.training.loop import Trainer

STEPS = 6
ZERO = {"shard_optimizer": True, "shard_ema": True, "shard_params": True}


def _cfg(out_dir, name, batch, stop_after=0, parallel=None, accum=1):
    return {
        "run_name": name,
        "output_dir": str(out_dir),
        "seed": 11,
        "model": {"pretrained_vae_name": None, "architecture": "tiny", "remat": "full"},
        "data": {"dataset_name": "synthetic://shapes?num_samples=12", "resolution": 32,
                 "batch_size": batch, "do_validation": False},
        "training": {"num_train_epochs": 2, "learning_rate": 1e-3, "kl_weight": 1e-6,
                     "lr_warmup_steps": 2, "mixed_precision": "no", "adam_epsilon": 1.0,
                     "ema_decay": 0.9, "stop_after_steps": stop_after,
                     "gradient_accumulation_steps": accum},
        "logging": {"log_interval": 1, "report_to": "jsonl"},
        "saving": {"save_interval_steps": 1000},
        "parallel": dict(parallel or {}),
        "tracking": {"enabled": True, "track_interval": 2, "target_layers": [
            {"name": "vae.encoder.down_blocks.0.resnets.0.norm1", "capture_point": "output",
             "metrics": ["mean_abs_activation_per_channel", "std_activation"]}]},
        "classification": {"enabled": True, "method": "threshold_groupnorm_activity",
                           "threshold": 0.6,
                           "target_metric_key": "mean_abs_activation_per_channel",
                           "layers_to_classify": [
                               "vae.encoder.down_blocks.0.resnets.0.norm1.output"]},
        "intervention": {"enabled": True, "strategy": "gentle_nudge_groupnorm_scale",
                         "nudge_factor": 1.05, "max_scale_value": 1.5,
                         "intervention_interval": 2},
    }


def _eval_config(path):
    with open(path, "w") as f:
        json.dump({"seed": 0, "data": {"dataset_name": "synthetic://shapes",
                                       "resolution": 32, "batch_size": 2},
                   "training": {"mixed_precision": "no"}}, f)
    return path


def _eval_argv(cfg_path, ckpt, out, batch):
    return ["--config_path", cfg_path, "--checkpoint_path", ckpt, "--output_dir", out,
            "--max_eval_samples", "7", "--batch_size", str(batch),
            "--num_samples_to_save", "5", "--logit_lens_layers",
            "encoder.down_blocks.0.resnets.0.norm1"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel_trainer")
    w2 = tmp / "w2"
    eval_cfg = _eval_config(str(tmp / "eval.json"))
    spawn = [
        {"kind": "trainer", "config": _cfg(w2, "zero", 2, parallel=ZERO)},
        {"kind": "trainer", "config": _cfg(w2, "resumed", 2, stop_after=4, parallel=ZERO)},
        {"kind": "trainer", "config": _cfg(w2, "resumed", 2, parallel=ZERO),
         "resume_from": str(w2 / "resumed" / "chkpt-4")},
        {"kind": "trainer", "config": _cfg(w2, "ddp", 2)},
        {"kind": "eval", "argv": _eval_argv(eval_cfg, str(w2 / "ddp" / "final_model"),
                                            str(tmp / "eval_w2"), 2)},
        {"kind": "trainer", "config": _cfg(w2, "accum", 2, accum=2)},
    ]
    run_ranks("runs", {"runs": spawn, "out": str(tmp / "w2_run")}, str(tmp / "ranks"),
              timeout=150)
    one = Trainer(_cfg(tmp / "w1", "one", 4, parallel=ZERO), device="cpu")
    one_summary = one.train()
    from_w2 = Trainer(_cfg(tmp / "w1", "from_w2", 4),
                      resume_from=str(w2 / "resumed" / "chkpt-4"), device="cpu")
    from_w2.train()
    accum = Trainer(_cfg(tmp / "w1", "accum", 4, accum=2), device="cpu")
    accum.train()
    assert evaluate.main(_eval_argv(eval_cfg, str(w2 / "ddp" / "final_model"),
                                    str(tmp / "eval_w1"), 4) + ["--device", "cpu"]) == 0

    def params(i, rank):
        return dict(np.load(f"{tmp / 'w2_run'}_{i}_rank{rank}.npz"))

    return {
        "tmp": tmp,
        "w2": {i: params(i, 0) for i in range(4)},
        "w2_rank1": {i: params(i, 1) for i in range(4)},
        "w2_summary": json.load(open(f"{tmp / 'w2_run'}_0.json")),
        "one": {k: p.detach().numpy().copy() for k, p in one.model.named_parameters()},
        "one_summary": one_summary,
        "from_w2": {k: p.detach().numpy().copy() for k, p in from_w2.model.named_parameters()},
        "accum": {k: p.detach().numpy().copy() for k, p in accum.model.named_parameters()},
        "w2_accum": params(5, 0),
    }


def _losses(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return {r["step"]: r["train_loss_step"] for r in recs if "train_loss_step" in r}


def _near(got, want, what):
    assert set(got) == set(want)
    for k, v in want.items():
        scale = max(float(np.abs(v).max()), 1e-12)
        err = float(np.abs(got[k].astype(np.float64) - v).max())
        assert err <= 1e-5 * scale, f"{what} {k}: {err:.3e} vs {scale:.3e}"


@pytest.mark.parametrize("run,name", [(0, "zero"), (3, "ddp")])
def test_two_ranks_train_as_one_process(runs, run, name):
    tmp = runs["tmp"]
    one = _losses(tmp / "w1" / "one")
    got = _losses(tmp / "w2" / name)
    assert sorted(got) == sorted(one) == list(range(1, STEPS + 1))
    for step, loss in one.items():
        assert got[step] == pytest.approx(loss, rel=1e-5), step
    _near(runs["w2"][run], runs["one"], name)
    assert runs["w2_summary"]["global_step"] == runs["one_summary"]["global_step"] == STEPS
    assert runs["w2_summary"]["images_seen"] == runs["one_summary"]["images_seen"]


@pytest.mark.parametrize("run", range(4))
def test_ranks_hold_the_same_parameters(runs, run):
    for k, v in runs["w2"][run].items():
        np.testing.assert_array_equal(runs["w2_rank1"][run][k], v, err_msg=k)


def test_the_same_nudges_fire(runs):
    tmp = runs["tmp"]
    rows = {}
    for name, path in (("one", tmp / "w1" / "one"), ("zero", tmp / "w2" / "zero"),
                       ("ddp", tmp / "w2" / "ddp")):
        with open(path / "intervention_history.csv") as f:
            rows[name] = f.read().split()
    assert rows["zero"] == rows["ddp"] == rows["one"]
    assert any(int(r.split(",")[2]) > 0 for r in rows["one"])


def test_a_two_rank_checkpoint_resumes_at_two_ranks_and_at_one(runs):
    for k, v in runs["w2"][0].items():
        np.testing.assert_array_equal(runs["w2"][2][k], v, err_msg=k)
    tmp = runs["tmp"]
    zero, resumed = _losses(tmp / "w2" / "zero"), _losses(tmp / "w2" / "resumed")
    assert resumed == zero
    _near(runs["from_w2"], runs["one"], "resumed in one process")
    one, from_w2 = _losses(tmp / "w1" / "one"), _losses(tmp / "w1" / "from_w2")
    assert sorted(from_w2) == [5, 6]
    for step in (5, 6):
        assert from_w2[step] == pytest.approx(one[step], rel=1e-5)


def test_accumulation_across_ranks_matches_one_process(runs):
    tmp = runs["tmp"]
    one, got = _losses(tmp / "w1" / "accum"), _losses(tmp / "w2" / "accum")
    assert sorted(got) == sorted(one) and len(one) >= 2
    for step, loss in one.items():
        assert got[step] == pytest.approx(loss, rel=1e-5), step
    _near(runs["w2_accum"], runs["accum"], "accumulation")


def test_evaluation_at_two_ranks_matches_one_process(runs):
    tmp = runs["tmp"]
    w1, w2 = tmp / "eval_w1", tmp / "eval_w2"
    got = json.load(open(w2 / "eval_metrics.json"))
    want = json.load(open(w1 / "eval_metrics.json"))
    assert got["num_samples"] == want["num_samples"] == 7
    for key in ("mse", "kl", "psnr", "ssim"):
        assert got[key] == pytest.approx(want[key], rel=1e-6), key
    pngs = sorted(f for f in os.listdir(w1) if f.endswith(".png"))
    assert sorted(f for f in os.listdir(w2) if f.endswith(".png")) == pngs
    assert sum(f.startswith("sample_") for f in pngs) == 10
    for f in pngs:
        assert (w2 / f).read_bytes() == (w1 / f).read_bytes(), f
    assert (w2 / "eval_metrics.txt").exists()
