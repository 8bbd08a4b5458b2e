"""The data axis on two cards over NCCL, against one process; skipped
below two cards. On the card's machine (no jax there, so without the
suite's conftest)::

    python -m pytest --noconftest -m cuda tests/test_torch_parallel_cuda.py -q

- ``configs/bench_zero3_256px.yaml`` (the ZeRO stack, the EMA) with
  ``kernel_impl: pallas`` and the control loop, at fp32, 3 steps, through
  the Trainer on two ranks of 4 images against one process of 8: the
  losses, the gradient norm and the final parameters within 1e-4 (the sums
  run in another order), the same nudges, the ranks' parameters bit-equal;
- the 512px server with one replica a card against one replica: each
  card's block as the first card computes it at the same batch (within
  1e-6 relative L2), ``max_batch`` rounded up to the replica count, and the
  flash forward launched on both cards.
"""

import json
import os

import numpy as np
import pytest
import torch
from torch_parallel_ranks import REPO, run_ranks

pytestmark = pytest.mark.cuda

STEPS, BATCH = 3, 4
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


def _config(model_dir, out_dir, name, batch):
    from vae_channel_dynamics_tpu_torch.utils.config_utils import load_config

    cfg = load_config(os.path.join(REPO, "configs", "bench_zero3_256px.yaml"))
    loop = load_config(os.path.join(REPO, "configs", "experiment_1024_stretch.yaml"))
    for key in ("tracking", "classification", "intervention"):
        cfg[key] = loop[key]
    cfg["tracking"]["track_interval"] = cfg["intervention"]["intervention_interval"] = STEPS
    cfg["run_name"], cfg["output_dir"] = name, str(out_dir)
    cfg["model"].update(pretrained_vae_name=model_dir, kernel_impl="pallas")
    cfg["data"].update(batch_size=batch, max_samples=2 * BATCH * STEPS)
    cfg["training"].update(mixed_precision="no", stop_after_steps=STEPS)
    cfg["logging"] = {"log_interval": 1, "report_to": "jsonl"}
    cfg["logit_lens"] = {"enabled": False}
    return cfg


def _records(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return {r["step"]: r for r in map(json.loads, f) if "train_loss_step" in r}


def test_zero_stack_on_two_cards_matches_one_process(cards, model_dir, tmp_path):
    from vae_channel_dynamics_tpu_torch.models import io as model_io
    from vae_channel_dynamics_tpu_torch.training.loop import Trainer

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    run_ranks("runs", {"device": "cuda", "out": str(tmp_path / "w2"), "runs": [
        {"kind": "trainer", "config": _config(model_dir, tmp_path, "w2", BATCH)}]},
        str(tmp_path / "ranks"), world=cards, timeout=600)
    Trainer(_config(model_dir, tmp_path, "w1", cards * BATCH), device="cuda").train()
    got, want = _records(tmp_path / "w2"), _records(tmp_path / "w1")
    assert sorted(got) == sorted(want) == list(range(1, STEPS + 1))
    for step in want:
        for key in ("rec_loss", "kl_loss", "grad_norm"):
            assert got[step][key] == pytest.approx(want[step][key], rel=1e-4), (step, key)
    _, a = model_io.load_model_dir(str(tmp_path / "w2" / "final_model" / "vae"))
    _, b = model_io.load_model_dir(str(tmp_path / "w1" / "final_model" / "vae"))
    for k, v in b.items():
        err = float((a[k].double() - v.double()).abs().max())
        assert err <= 1e-4 * float(v.double().abs().max()) + 1e-12, k
    rows = [open(tmp_path / d / "intervention_history.csv").read() for d in ("w2", "w1")]
    assert rows[0] == rows[1] and any(int(r.split(",")[2]) > 0 for r in rows[0].split())
    ranks = [dict(np.load(f"{tmp_path / 'w2'}_0_rank{r}.npz")) for r in range(cards)]
    for k, v in ranks[0].items():
        np.testing.assert_array_equal(ranks[1][k], v, err_msg=k)


def test_server_on_two_cards_matches_one(cards, model_dir):
    from vae_channel_dynamics_tpu_torch import server as srv
    from vae_channel_dynamics_tpu_torch.models import SDXLVAEWrapper
    from vae_channel_dynamics_tpu_torch.models import io as model_io
    from vae_channel_dynamics_tpu_torch.ops import flash_attention as fa

    config, state = model_io.load_model_dir(model_dir)
    wrapper = SDXLVAEWrapper(config=config, state_dict=state, dtype=torch.bfloat16,
                             attn_impl="flash", device="cuda:0")
    one = srv.VAEServer(wrapper, resolution=512, max_batch=2, port=0, use_mesh=False)
    two = srv.VAEServer(wrapper, resolution=512, max_batch=3, port=0,
                        replicas=[wrapper, wrapper.replicate("cuda:1")])
    try:
        assert len(two.replicas) == cards and two.batcher.max_batch == 4
        assert [w.device.index for w in two.replicas] == list(range(cards))
        x = np.random.default_rng(0).uniform(-1, 1, (4, 512, 512, 3)).astype(np.float32)
        before = fa.launches["flash_attention_fwd"]
        got = two._run("reconstruct", x)
        assert fa.launches["flash_attention_fwd"] - before == 2 * cards
        # each card's block of 2 against the first card at the same batch:
        # another batch size may take other cuDNN algorithms, whose bf16
        # rounding the random-weight decoder amplifies to ~5%
        want = np.concatenate([one._run("reconstruct", x[:2]), one._run("reconstruct", x[2:])])
        assert got.shape == want.shape == (4, 512, 512, 3) and np.isfinite(got).all()
        assert np.linalg.norm(got - want) <= 1e-6 * np.linalg.norm(want)
    finally:
        # no accept loop ran: close the sockets and the batchers directly
        for s in (one, two):
            s.httpd.server_close()
            s.batcher.close()
