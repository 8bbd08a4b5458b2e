"""Evaluation, the activation hooks and the logit lens of the port against
the JAX package's, on the CPU.

- ``ops.image_metrics`` against the JAX functions on the same NHWC arrays:
  fp32 on both sides, JAX's filter at ``Precision.HIGHEST``, so 1e-6.
- The port's ``evaluate.main`` on ``tests/fixtures/golden_eval`` reproduces
  ``golden_metrics.json`` at ``tests/test_golden_eval_parity.py``'s
  tolerances, and writes the JAX CLI's ``eval_metrics.txt`` lines and
  ``eval_metrics.json`` keys.
- ``add_hooks`` captures the same maps as the JAX wrapper's on the same
  weights (fp32, 1e-5 of max|JAX|: the two sum the convolutions in another
  order), keyed the same, and warns about the same unknown names.
- The lens: the projections through the port's ``MiniDecoder`` on Flax
  parameters carried across by ``state_dict_from_flax_params`` within 1e-5
  of the Flax module's; the drawn arrays (per-tile normalisation, the
  viridis table) against numpy and matplotlib; the artifact tree's file
  names against a JAX lens run on the same activations.
The Trainer's lens tree against the JAX Trainer's is in
``tests/test_torch_trainer.py``, which already runs both Trainers.
"""

import json
import logging
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_eval_harness import BATCH_SIZE, CKPT_DIR, GOLDEN_JSON, IMAGES_DIR, NUM_IMAGES, RESOLUTION
from vae_channel_dynamics_tpu.analysis.logit_lens import VAELogitLens as JaxLens
from vae_channel_dynamics_tpu.models.io import abstract_params, unflatten_params
from vae_channel_dynamics_tpu.models.vae import VAEConfig as JaxConfig
from vae_channel_dynamics_tpu.models.wrapper import SDXLVAEWrapper as JaxWrapper
from vae_channel_dynamics_tpu.ops import image_metrics as jim
from vae_channel_dynamics_tpu_torch import evaluate
from vae_channel_dynamics_tpu_torch.analysis import logit_lens as ll
from vae_channel_dynamics_tpu_torch.models import AutoencoderKL, SDXLVAEWrapper, VAEConfig
from vae_channel_dynamics_tpu_torch.ops import image_metrics as tim


# --------------------------------------------------------------------------- #
# image metrics
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def images01():
    rng = np.random.default_rng(0)
    target = rng.uniform(0, 1, (3, 24, 20, 3)).astype(np.float32)
    pred = np.clip(target + 0.1 * rng.standard_normal(target.shape), 0, 1).astype(np.float32)
    return pred, target


def test_gaussian_kernel_matches_jax():
    np.testing.assert_array_equal(tim.gaussian_kernel_1d(), jim.gaussian_kernel_1d())
    np.testing.assert_array_equal(tim.gaussian_kernel_1d(7, 1.0), jim.gaussian_kernel_1d(7, 1.0))


def test_ssim_matches_jax(images01):
    pred, target = images01
    ref = np.asarray(jim.ssim_per_image(jnp.asarray(pred), jnp.asarray(target)))
    out = tim.ssim_per_image(torch.from_numpy(pred), torch.from_numpy(target)).numpy()
    assert out.shape == (3,)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        float(tim.ssim(torch.from_numpy(pred), torch.from_numpy(target))),
        float(jim.ssim(jnp.asarray(pred), jnp.asarray(target))), rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        tim.ssim_per_image(torch.from_numpy(target), torch.from_numpy(target)).numpy(), 1.0,
        rtol=0, atol=1e-6)


def test_psnr_matches_jax(images01):
    pred, target = images01
    np.testing.assert_allclose(
        float(tim.psnr(torch.from_numpy(pred), torch.from_numpy(target))),
        float(jim.psnr(jnp.asarray(pred), jnp.asarray(target))), rtol=1e-6)
    np.testing.assert_allclose(float(tim.psnr_from_accumulated(12.5, 1000.0)),
                               float(jim.psnr_from_accumulated(jnp.asarray(12.5),
                                                               jnp.asarray(1000.0))), rtol=1e-6)


# --------------------------------------------------------------------------- #
# the evaluation CLI on the golden fixture
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def golden_eval(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("golden_eval")
    config_path = tmp / "eval_config.yaml"
    config_path.write_text(
        "seed: 0\n"
        "data:\n"
        f"  dataset_name: {IMAGES_DIR}\n"
        f"  resolution: {RESOLUTION}\n"
        f"  batch_size: {BATCH_SIZE}\n"
        "training:\n"
        "  mixed_precision: 'no'\n"
    )
    out_dir = tmp / "eval_out"
    rc = evaluate.main([
        "--config_path", str(config_path), "--checkpoint_path", CKPT_DIR,
        "--eval_split", "test", "--output_dir", str(out_dir),
        "--batch_size", str(BATCH_SIZE), "--num_samples_to_save", "2",
        "--enable_logit_lens", "false", "--device", "cpu",
    ])
    return rc, out_dir


def test_evaluate_cli_matches_golden_dataset_metrics(golden_eval):
    rc, out_dir = golden_eval
    assert rc == 0
    with open(GOLDEN_JSON) as f:
        golden = json.load(f)
    with open(out_dir / "eval_metrics.json") as f:
        ours = json.load(f)
    assert ours["num_samples"] == NUM_IMAGES
    # the tolerances of tests/test_golden_eval_parity.py
    np.testing.assert_allclose(ours["mse"], golden["mse"], rtol=1e-6)
    np.testing.assert_allclose(ours["kl"], golden["kl"], rtol=3e-5)
    assert abs(ours["psnr"] - golden["psnr"]) < 1e-4
    assert abs(ours["ssim"] - golden["ssim"]) < 1e-5


def test_evaluate_cli_artifacts(golden_eval):
    _rc, out_dir = golden_eval
    with open(out_dir / "eval_metrics.json") as f:
        ours = json.load(f)
    assert list(ours) == ["eval_split", "checkpoint_path", "num_samples", "mse", "kl", "psnr",
                          "ssim"]
    assert (ours["eval_split"], ours["checkpoint_path"]) == ("test", CKPT_DIR)
    assert (out_dir / "eval_metrics.txt").read_text().splitlines() == [
        "Evaluation Split: test",
        f"Checkpoint Path: {CKPT_DIR}",
        f"Number of Samples Processed: {NUM_IMAGES}",
        f"Average MSE: {ours['mse']}",
        f"Average KL: {ours['kl']}",
        f"Average PSNR: {ours['psnr']}",
        f"Average SSIM: {ours['ssim']}",
    ]
    assert sorted(os.listdir(out_dir)) == [
        "eval_metrics.json", "eval_metrics.txt", "sample_0_orig.png", "sample_0_recon.png",
        "sample_1_orig.png", "sample_1_recon.png"]


def test_evaluate_cli_without_a_model_dir_fails(tmp_path):
    cfg = tmp_path / "c.yaml"
    cfg.write_text("data:\n  dataset_name: synthetic://shapes?num_samples=2\n")
    assert evaluate.main(["--config_path", str(cfg), "--checkpoint_path", str(tmp_path),
                          "--device", "cpu"]) == 1


def test_evaluate_cli_refuses_a_missing_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    cfg = tmp_path / "c.yaml"
    cfg.write_text("data:\n  dataset_name: synthetic://shapes?num_samples=2\n")
    with pytest.raises(RuntimeError, match="cuda"):
        evaluate.main(["--config_path", str(cfg), "--checkpoint_path", CKPT_DIR,
                       "--output_dir", str(tmp_path / "out")])


def test_evaluate_cli_runs_the_configured_kernel_impl(tmp_path, monkeypatch):
    """``model.kernel_impl: pallas`` takes every GroupNorm through the kernel
    wrappers (their CPU branch, counted here), ``auto`` through the plain
    GroupNorm, and the metrics agree to fp32 rounding (1e-5 relative). The
    CLI once passed no kernel_impl to its wrapper (as the JAX CLI reads
    none), so a ``pallas`` evaluation ran the plain GroupNorm on the card.
    A (128, 128)-channel model: the kernels take 128-channel norms."""
    from vae_channel_dynamics_tpu_torch.models import io as model_io
    from vae_channel_dynamics_tpu_torch.ops import group_norm_kernel as gnk

    cfg = VAEConfig(block_out_channels=(128, 128), layers_per_block=1, sample_size=16)
    model = AutoencoderKL(cfg)
    model.init_weights(torch.Generator().manual_seed(0))
    model_dir = tmp_path / "model"
    model_io.save_model_dir(str(model_dir), cfg, model.state_dict())
    reached = []
    on_cpu = gnk._on_cpu
    monkeypatch.setattr(gnk, "_on_cpu", lambda x, name: reached.append(name) or on_cpu(x, name))
    metrics, calls = {}, {}
    for impl in ("auto", "pallas"):
        config_path = tmp_path / f"{impl}.yaml"
        config_path.write_text(
            "data:\n"
            "  dataset_name: synthetic://shapes?num_samples=4\n"
            "  resolution: 16\n"
            "  batch_size: 2\n"
            f"model:\n  kernel_impl: {impl}\n"
        )
        reached.clear()
        assert evaluate.main(["--config_path", str(config_path), "--checkpoint_path",
                              str(model_dir), "--output_dir", str(tmp_path / impl),
                              "--enable_logit_lens", "false", "--device", "cpu"]) == 0
        calls[impl] = sorted(set(reached))
        with open(tmp_path / impl / "eval_metrics.json") as f:
            metrics[impl] = json.load(f)
    assert calls == {"auto": [], "pallas": ["gn_fwd_normalize", "gn_fwd_reduce"]}
    for key in ("mse", "kl", "psnr", "ssim"):
        np.testing.assert_allclose(metrics["pallas"][key], metrics["auto"][key], rtol=1e-5)


# --------------------------------------------------------------------------- #
# add_hooks
# --------------------------------------------------------------------------- #
HOOKS = ["vae.encoder.down_blocks.0.resnets.0.norm1", "encoder.conv_in",
         "decoder.up_blocks.1.resnets.0.conv_shortcut", "encoder.mid_block.attentions.0.to_q",
         "encoder.mid_block.attentions.0", "decoder.no_such_layer"]


@pytest.fixture(scope="module")
def hooked():
    model = AutoencoderKL(VAEConfig.tiny())
    model.init_weights(torch.Generator().manual_seed(0))
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    params = unflatten_params(abstract_params(JaxConfig.tiny()),
                              {k: v.numpy() for k, v in state.items()})
    port = SDXLVAEWrapper(VAEConfig.tiny(), state_dict=state, device="cpu")
    ref = JaxWrapper(config=JaxConfig.tiny(), params=params, dtype=jnp.float32)
    x = np.random.default_rng(5).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    for w in (port, ref):
        w.add_hooks(HOOKS)
    ref.forward(jnp.asarray(x), sample_posterior=False)
    port.forward(x, sample_posterior=False)
    return port, ref, x


def test_add_hooks_capture_matches_jax(hooked):
    port, ref, _x = hooked
    ours, theirs = port.get_captured_activations(), ref.get_captured_activations()
    assert list(ours) == list(theirs) == sorted([
        "encoder.down_blocks.0.resnets.0.norm1", "encoder.conv_in",
        "decoder.up_blocks.1.resnets.0.conv_shortcut", "encoder.mid_block.attentions.0.to_q"])
    for name, ref_map in theirs.items():
        ref_map = np.asarray(ref_map, np.float32)
        assert ours[name].dtype == np.float32 and ours[name].shape == ref_map.shape, name
        assert np.abs(ours[name] - ref_map).max() <= 1e-5 * np.abs(ref_map).max(), name


def test_add_hooks_warns_about_unknown_names(caplog):
    wrapper = SDXLVAEWrapper(VAEConfig.tiny(), device="cpu")
    with caplog.at_level(logging.WARNING):
        wrapper.add_hooks(["encoder.mid_block.attentions.0", "encoder.conv_in"])
    warned = [r.getMessage() for r in caplog.records if r.levelno == logging.WARNING]
    assert len(warned) == 1 and "encoder.mid_block.attentions.0" in warned[0]
    assert "encoder.conv_in'" not in warned[0]


def test_hooks_clear_and_remove(hooked):
    port, _ref, x = hooked
    out = port.forward(x, sample_posterior=False)["reconstruction"]
    assert port.get_captured_activations()
    port.clear_captured_activations()
    assert port.get_captured_activations() == {}
    port.remove_hooks()
    again = port.forward(x, sample_posterior=False)["reconstruction"]
    assert port.get_captured_activations() == {}
    torch.testing.assert_close(again, out, rtol=0, atol=0)  # taps observe, change nothing
    port.add_hooks(HOOKS)


# --------------------------------------------------------------------------- #
# the logit lens
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("channels", [1, 6])
def test_lens_projections_match_flax(tmp_path, channels):
    jlens = JaxLens(main_experiment_output_dir=str(tmp_path / "j"), seed=3)
    params, _apply = jlens._decoder_for(channels)
    lens = ll.VAELogitLens(main_experiment_output_dir=str(tmp_path / "t"), seed=3)
    lens.decoder_for(channels).load_state_dict(ll.state_dict_from_flax_params(params))
    acts = np.random.default_rng(channels).standard_normal((2, channels, 7, 9)).astype(np.float32)
    ref = jlens.project_through_mini_decoder(acts)
    out = lens.project_through_mini_decoder(acts)
    assert out.shape == ref.shape == (2, 28, 36, 3)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def test_lens_seeded_init_is_fixed(tmp_path):
    a = ll.VAELogitLens(main_experiment_output_dir=str(tmp_path), seed=4).decoder_for(3)
    b = ll.VAELogitLens(main_experiment_output_dir=str(tmp_path), seed=4).decoder_for(3)
    c = ll.VAELogitLens(main_experiment_output_dir=str(tmp_path), seed=5).decoder_for(3)
    for (name, p), q, r in zip(a.state_dict().items(), b.state_dict().values(),
                               c.state_dict().values()):
        torch.testing.assert_close(p, q, rtol=0, atol=0)
        if name.endswith("weight"):
            assert not torch.equal(p, r)


def test_drawn_arrays(tmp_path):
    import matplotlib

    arr = np.random.default_rng(1).standard_normal((2, 3, 5, 4)).astype(np.float32)
    arr[1, 2] = 7.0  # a flat tile draws as zeros
    tiles = ll.normalized_tiles(arr, 1, 3)
    for c in range(2):
        t = arr[1, c]
        np.testing.assert_allclose(tiles[c], (t - t.min()) / (t.max() - t.min()), rtol=1e-6)
    np.testing.assert_array_equal(tiles[2], 0.0)
    values = np.concatenate([np.linspace(0, 1, 1001), [0.0, 1.0, 0.5]]).astype(np.float32)
    want = matplotlib.colormaps["viridis"](values, bytes=True)[..., :3]
    np.testing.assert_array_equal(ll.colorize(values), want)
    row = ll.side_by_side([np.zeros((4, 3, 3), np.uint8), np.ones((2, 5, 3), np.uint8)])
    assert row.shape == (8, 14, 3)
    # any other colormap is matplotlib's own table
    for name in ("magma", "gray", "tab10"):
        want = matplotlib.colormaps[name](values, bytes=True)[..., :3]
        np.testing.assert_array_equal(ll.colorize(values, name), want, err_msg=name)
    assert ll.VAELogitLens({"colormap": "magma"}, main_experiment_output_dir=str(
        tmp_path)).colormap == "magma"
    with pytest.raises(ValueError, match="not one of matplotlib's"):
        ll.colorize(values, "no_such_map")


def test_colormaps_without_matplotlib_raise_naming_it(monkeypatch):
    """Where matplotlib does not import, viridis still draws from the
    carried table and any other colormap raises an error that names
    matplotlib; nothing swaps to another colormap."""
    values = np.linspace(0, 1, 17, dtype=np.float32)
    viridis = ll.colorize(values)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setattr(ll, "COLORMAPS", {"viridis": ll.VIRIDIS})
    np.testing.assert_array_equal(ll.colorize(values), viridis)
    with pytest.raises(ValueError, match="needs matplotlib"):
        ll.colorize(values, "magma")
    with pytest.raises(ValueError, match="needs matplotlib"):
        ll.VAELogitLens({"colormap": "cividis"}, main_experiment_output_dir="/nonexistent")


def _files(root):
    return sorted(os.path.relpath(os.path.join(r, f), root)
                  for r, _d, fs in os.walk(root) for f in fs)


def test_lens_artifact_tree_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    acts = {
        "encoder.down_blocks.0.resnets.0.norm1": rng.standard_normal((2, 6, 8, 8)),
        # the monitor's per-step dict, resolved through .full_activation_map
        "vae.decoder.conv_in.output": {"full_activation_map": rng.standard_normal((1, 3, 4, 4)),
                                       "mean_activation": np.float32(0.1)},
        "not.four.d": rng.standard_normal((3, 4)),
    }
    layers = ["encoder.down_blocks.0.resnets.0.norm1",
              "vae.decoder.conv_in.output.full_activation_map", "not.four.d", "missing.layer"]
    cfg = {"num_channels_to_viz": 3, "num_batch_samples_to_viz": 2}
    roots = {}
    for side, cls in (("jax", JaxLens), ("torch", ll.VAELogitLens)):
        lens = cls(cfg, main_experiment_output_dir=str(tmp_path / side), seed=0)
        for step, kind in ((0, "mini_decoder_single_channel"), (5, "mini_decoder_full_map")):
            lens.run_logit_lens_with_activations(global_step=step, layers_to_analyze=layers,
                                                 num_batch_samples_to_viz=None,
                                                 projection_type=kind,
                                                 activations_to_process=acts)
        lens.visualize_channel_activation_maps(acts["encoder.down_blocks.0.resnets.0.norm1"],
                                               "encoder.down_blocks.0.resnets.0.norm1", 9)
        roots[side] = str(tmp_path / side)
    assert _files(roots["torch"]) == _files(roots["jax"])
    assert len(_files(roots["torch"])) == 8
