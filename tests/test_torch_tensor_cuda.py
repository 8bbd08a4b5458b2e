"""The tensor axis on two cards over NCCL, against one process; skipped
below two cards. On the card's machine (no jax there, so without the
suite's conftest)::

    python -m pytest --noconftest -m cuda tests/test_torch_tensor_cuda.py -q

- The full-width SDXL VAE at 256px with ``parallel.tensor: 2`` (each card
  half of every channel axis ``_channel_axis`` cuts), ``kernel_impl:
  pallas`` (the GroupNorm kernels on each card's 64- to 256-channel
  blocks), ``remat: full``, EMA and the control loop, at fp32, 3 steps
  through the Trainer on two ranks against one process at the same batch:
  the losses, the gradient norm and the final parameters within 1e-4 (the
  sums run in another order; Adam's epsilon of 1 keeps the updates linear
  in the gradients, as in ``tests/test_torch_spatial_cuda.py``), the same
  nudges, the ranks' parameters bit-equal.
- Memory: one training forward at 256px batch 4, in bf16 and in fp32
  (cuDNN at its defaults), leaves each card at most 0.6 of the bytes one
  card keeps for the backward (a column-parallel conv saves the card's
  block of its input, 1/2), and each card's peak is below one card's.
"""

import json
import os

import numpy as np
import pytest
import torch
from torch_parallel_ranks import REPO, run_ranks, saved_activation_bytes

pytestmark = pytest.mark.cuda

STEPS, BATCH, RES = 3, 2, 256
PLANTED = ("encoder.down_blocks.0.resnets.0.norm1", tuple(range(0, 128, 16)), 0.01)


@pytest.fixture(scope="module")
def cards():
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs")
    return 2


@pytest.fixture(scope="module")
def model_dir(cards, tmp_path_factory):
    from vae_channel_dynamics_tpu_torch.models import AutoencoderKL, VAEConfig
    from vae_channel_dynamics_tpu_torch.models import io as model_io

    path = str(tmp_path_factory.mktemp("sdxl") / "vae")
    model = AutoencoderKL(VAEConfig.sdxl(), device="cuda")
    model.init_weights(torch.Generator(device="cuda").manual_seed(0))
    norm, channels, gamma = PLANTED
    with torch.no_grad():
        model.get_submodule(norm).weight[list(channels)] = gamma
    model_io.save_model_dir(path, model.config, model.state_dict())
    return path


def _config(model_dir, out_dir, name, tensor):
    from vae_channel_dynamics_tpu_torch.utils.config_utils import load_config

    cfg = load_config(os.path.join(REPO, "configs", "bench_tp.yaml"))
    for key in ("tracking", "classification", "intervention"):
        cfg[key] = load_config(os.path.join(REPO, "configs",
                                            "experiment_1024_stretch.yaml"))[key]
    cfg["tracking"]["track_interval"] = cfg["intervention"]["intervention_interval"] = STEPS
    cfg["run_name"], cfg["output_dir"] = name, str(out_dir)
    cfg["model"].update(pretrained_vae_name=model_dir, kernel_impl="pallas", remat="full")
    cfg["data"].update(batch_size=BATCH, max_samples=BATCH * STEPS, resolution=RES,
                       num_workers=0)
    cfg["training"].update(mixed_precision="no", stop_after_steps=STEPS, adam_epsilon=1.0,
                           learning_rate=1e-3, lr_warmup_steps=1)
    cfg["logging"] = {"log_interval": 1, "report_to": "jsonl"}
    cfg["logit_lens"] = {"enabled": False}
    cfg["parallel"] = {"tensor": tensor} if tensor > 1 else {}
    return cfg


def _records(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return {r["step"]: r for r in map(json.loads, f) if "train_loss_step" in r}


def test_tensor_step_on_two_cards_matches_one_process(cards, model_dir, tmp_path):
    from vae_channel_dynamics_tpu_torch.models import io as model_io
    from vae_channel_dynamics_tpu_torch.training.loop import Trainer

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    run_ranks("runs", {"device": "cuda", "out": str(tmp_path / "tp"), "runs": [
        {"kind": "trainer", "config": _config(model_dir, tmp_path, "tp", cards)}]},
        str(tmp_path / "ranks"), world=cards, timeout=600)
    Trainer(_config(model_dir, tmp_path, "one", 1), device="cuda").train()
    got, want = _records(tmp_path / "tp"), _records(tmp_path / "one")
    assert sorted(got) == sorted(want) == list(range(1, STEPS + 1))
    for step in want:
        for key in ("rec_loss", "kl_loss", "grad_norm"):
            assert got[step][key] == pytest.approx(want[step][key], rel=1e-4), (step, key)
    _, a = model_io.load_model_dir(str(tmp_path / "tp" / "final_model" / "vae"))
    _, b = model_io.load_model_dir(str(tmp_path / "one" / "final_model" / "vae"))
    for k, v in b.items():
        err = float((a[k].double() - v.double()).abs().max())
        assert err <= 1e-4 * float(v.double().abs().max()) + 1e-12, k
    rows = [open(tmp_path / d / "intervention_history.csv").read() for d in ("tp", "one")]
    assert rows[0] == rows[1] and any(int(r.split(",")[2]) > 0 for r in rows[0].split())
    ranks = [dict(np.load(f"{tmp_path / 'tp'}_0_rank{r}.npz")) for r in range(cards)]
    for k, v in ranks[0].items():
        np.testing.assert_array_equal(ranks[1][k], v, err_msg=k)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_a_card_keeps_about_half_the_activations(cards, tmp_path, dtype):
    from vae_channel_dynamics_tpu_torch.models.vae import AutoencoderKL, VAEConfig

    # the ranks' settings (tests/torch_parallel_ranks.py)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    args = {"device": "cuda", "resolution": RES, "batch": 4, "dtype": dtype,
            "out": str(tmp_path / "mem.json")}
    run_ranks("tensor_memory", args, str(tmp_path / "ranks"), world=cards, timeout=600)
    with open(args["out"]) as f:
        ranks = json.load(f)
    model = AutoencoderKL(VAEConfig.sdxl(), device="cuda", impl="pallas",
                          dtype=getattr(torch, dtype))
    model.init_weights(torch.Generator(device="cuda").manual_seed(0))
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(4, 3, RES, RES, generator=gen, device="cuda")
    noise = torch.randn(4, 4, RES // 8, RES // 8, generator=gen, device="cuda")
    saved, peak = saved_activation_bytes(model, x, noise)
    for rank_saved, rank_peak in ranks:
        assert rank_saved <= 0.6 * saved, (rank_saved, saved)
        assert rank_peak < peak, (rank_peak, peak)
