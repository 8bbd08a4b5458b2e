"""The port's run tools on the CPU (``vae_channel_dynamics_tpu_torch/tools``):

- ``report`` and ``compare_runs`` on the run-directory fixture of
  ``tests/test_tools_reports.py`` write what the JAX tools write (the
  comparison's activity plot under the JAX tool's name too), and
  ``report`` reads a run of the port's Trainer;
- ``serving_bench`` drives a live CPU server and reports its latencies and
  rate;
- ``doctor`` on this CPU-only machine reports its FAILs and exits nonzero;
  its native check reports ``ok`` with the decode linked, and ``FAIL``
  without a compiler;
- ``loader_bench`` prints the JAX tool's JSON line, with every image of a
  native result through native code;
- ``convert_diffusers`` takes a diffusers directory and a legacy
  ``model.safetensors`` directory to the canonical one, tensor for tensor,
  and refuses weights that do not fit the config.
"""

import json
import logging
import os
import threading

import numpy as np
import pytest
import torch
from test_tools_reports import _make_run_dir
from test_torch_trainer import _resume_cfg

from vae_channel_dynamics_tpu.models import io as jax_io
from vae_channel_dynamics_tpu.tools import compare_runs as jax_compare_runs
from vae_channel_dynamics_tpu.tools import report as jax_report
from vae_channel_dynamics_tpu_torch import server as srv
from vae_channel_dynamics_tpu_torch.models import AutoencoderKL, SDXLVAEWrapper, VAEConfig
from vae_channel_dynamics_tpu_torch.models import io as model_io
from vae_channel_dynamics_tpu_torch.tools import (
    compare_runs,
    convert_diffusers,
    doctor,
    loader_bench,
    report,
    serving_bench,
)
from vae_channel_dynamics_tpu_torch.training.loop import Trainer


@pytest.fixture(autouse=True)
def _one_thread():
    """The Trainer runs and the small models issue thousands of small ops: one
    intra-op thread keeps them from contending with the other test workers'
    threads (tests/test_torch_flash_bwd_f32.py's ``one_thread``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)



@pytest.fixture(autouse=True)
def _root_logging_restored():
    """The CLIs' setup_logging points the root logger at this test's
    captured stdout; later tests must not log into it once it is closed."""
    root = logging.getLogger()
    handlers, level = root.handlers[:], root.level
    yield
    root.handlers[:] = handlers
    root.setLevel(level)


def test_report_matches_the_jax_tool(tmp_path, capsys):
    run = _make_run_dir(tmp_path, "run_a")
    assert report.main(["--run_dir", str(run), "--output", str(tmp_path / "r.md")]) == 0
    text = (tmp_path / "r.md").read_text()
    assert text == jax_report.generate_report(str(run))
    assert "## Training" in text and "Average PSNR: 25.0" in text
    assert "- events: 2, total scales nudged: 8" in text
    assert "`vae.encoder.conv_in.weight`: peak 2.00%" in text
    assert text in capsys.readouterr().out


def test_report_reads_a_trainer_run(tmp_path):
    Trainer(_resume_cfg(tmp_path, "run", stop_after=4), device="cpu").train()
    run = tmp_path / "run"
    assert report.main(["--run_dir", str(run)]) == 0
    text = (run / "report.md").read_text()
    assert "- steps logged: 4 (step 1 → 4)" in text
    assert "## Per-channel activation" in text and "## Interventions" in text


def test_compare_runs_matches_the_jax_table_and_names_plots(tmp_path, capsys):
    base = _make_run_dir(tmp_path, "base", loss0=0.5)
    treat = _make_run_dir(tmp_path, "treat", loss0=0.4)
    out = tmp_path / "comparison.md"
    # the CLI's logging goes to stdout (utils/logging_utils.py)
    assert compare_runs.main(["--baseline", str(base), "--treatment", str(treat),
                              "--output", str(out)]) == 0
    text = out.read_text()
    assert text == jax_compare_runs.compare(str(base), str(treat))
    assert "| final train loss | 0.025 | 0.02 | -0.005 |" in text
    assert "| eval PSNR (dB) | 25 | 25 | +0 |" in text
    # the activity overlay under the JAX tool's name, its series from both
    # runs' tracked_activation_stats.csv
    assert (tmp_path / "comparison_activity.png").stat().st_size > 0
    jax_compare_runs.plot_activation_comparison(str(base), str(treat),
                                                str(tmp_path / "jax_activity.png"))
    assert (tmp_path / "jax_activity.png").exists()


@pytest.fixture(scope="module")
def live_server():
    wrapper = SDXLVAEWrapper(VAEConfig.tiny(), seed=0, device="cpu")
    server = srv.VAEServer(wrapper, resolution=32, max_batch=2, max_wait_ms=5, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield server
    server.shutdown()
    thread.join(timeout=10)


def test_serving_bench_drives_a_live_server(live_server):
    url = f"http://127.0.0.1:{live_server.port}"
    result = serving_bench.run(url, streams=3, duration_s=1.5, resolution=32)
    assert result["errors"] == 0 and result["ok"] > 0
    assert result["metric"] == "serving_reconstruct_ok_req_per_sec@32px"
    assert 0 < result["latency_ms_p50"] <= result["latency_ms_p95"] <= result["latency_ms_p99"]
    assert result["value"] == pytest.approx(result["ok"] / result["duration_s"], rel=0.1)
    assert 1 <= result["server_batching_ratio"] <= 2
    assert result["server_batch_calls"] >= result["ok"] / 2


def test_serving_bench_cli_prints_one_json_line(live_server, capsys):
    rc = serving_bench.main(["--url", f"http://127.0.0.1:{live_server.port}", "--streams", "2",
                             "--duration_s", "0.5", "--resolution", "32", "--op", "encode"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert rc == 0 and len(lines) == 1
    result = json.loads(lines[0])
    assert result["metric"] == "serving_encode_ok_req_per_sec@32px" and result["ok"] > 0


def test_doctor_reports_its_fails_on_the_cpu(capsys):
    assert not torch.cuda.is_available()
    assert doctor.main(["--device", "cuda"]) == 1
    out = capsys.readouterr().out
    lines = out.strip().splitlines()
    assert lines[0].startswith("[  ok  ] versions: python")
    assert "[ FAIL ] torch CUDA build" in out or "[ FAIL ] CUDA device" in out
    assert "[ FAIL ] device probes" in out
    for name in doctor.libraries():
        assert f"library {name}" in out
    fails = sum(line.startswith("[ FAIL ]") for line in lines)
    assert lines[-1] == f"{len(lines) - 2} checks: {fails} failed, 0 warnings"


def test_doctor_native_check_is_ok_with_the_decode_linked(capsys):
    doctor._RESULTS.clear()
    doctor.check_native()
    assert capsys.readouterr().out == "[  ok  ] native preprocess: decode+preprocess path active\n"
    assert doctor._RESULTS == ["ok"]


def test_doctor_native_check_fails_without_a_compiler(monkeypatch, tmp_path, capsys):
    from vae_channel_dynamics_tpu_torch.data import native

    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    doctor._RESULTS.clear()
    doctor.check_native()
    out = capsys.readouterr().out
    assert out.startswith("[ FAIL ] native preprocess: the native preprocess library did not "
                          "build") and "no-such-g++" in out
    assert doctor._RESULTS == ["FAIL"]


def test_loader_bench_counts_every_native_image_as_native(capsys):
    assert loader_bench.main(["--num-images", "8", "--src-size", "64", "--resolution", "32",
                              "--workers", "0", "--batch-size", "4"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    result = json.loads(lines[0])
    # the JAX tool's keys, and the native counts beside them
    assert set(result) == {"metric", "src_jpeg_px", "host_cores", "results", "native_counts"}
    assert result["metric"] == "loader_images_per_sec@32px" and result["src_jpeg_px"] == 64
    assert set(result["results"]) == {"pil_w0", "native_w0"}
    assert all(v > 0 for v in result["results"].values())
    assert result["native_counts"] == {"native_w0": {"decode": 8, "preprocess": 0, "pil": 0}}
    assert "VCD_NATIVE_PREPROCESS" not in os.environ


def test_doctor_checks_every_kernel_library():
    assert doctor.libraries() == ["conv_nhwc", "flash_attention_bwd", "flash_attention_bwd_f32",
                                  "flash_attention_fwd", "fused_resnet", "group_norm"]


def _tiny_dir(path):
    model = AutoencoderKL(VAEConfig.tiny())
    model.init_weights(torch.Generator().manual_seed(4))
    model_io.save_model_dir(str(path), model.config, model.state_dict())
    return model.state_dict()


def test_convert_diffusers_round_trip(tmp_path):
    want = _tiny_dir(tmp_path / "src")
    # a diffusers directory: only the constructor's own keys in its config
    cfg = json.loads((tmp_path / "src" / "config.json").read_text())
    for key in ("mid_block_attention", "norm_eps", "_framework"):
        cfg.pop(key)
    (tmp_path / "src" / "config.json").write_text(json.dumps(cfg))
    assert convert_diffusers.main(["--src", str(tmp_path / "src"),
                                   "--dst", str(tmp_path / "ours")]) == 0
    # and back, from a legacy model.safetensors directory
    os.rename(tmp_path / "ours" / "diffusion_pytorch_model.safetensors",
              tmp_path / "ours" / "model.safetensors")
    assert convert_diffusers.main(["--src", str(tmp_path / "ours"),
                                   "--dst", str(tmp_path / "back"), "--reverse"]) == 0
    assert sorted(os.listdir(tmp_path / "back")) == [
        "config.json", "diffusion_pytorch_model.safetensors"]
    config, got = model_io.load_model_dir(str(tmp_path / "back"))
    assert config == VAEConfig.tiny()
    assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)
    # the JAX package loads it too
    jconfig, jparams = jax_io.load_model_dir(str(tmp_path / "back"))
    assert jconfig.block_out_channels == config.block_out_channels
    assert np.asarray(jparams["encoder"]["conv_in"]["kernel"]).shape[-1] == (
        config.block_out_channels[0])


def test_convert_diffusers_refuses_weights_that_do_not_fit(tmp_path):
    _tiny_dir(tmp_path / "src")
    cfg = json.loads((tmp_path / "src" / "config.json").read_text())
    cfg["latent_channels"] = 8
    (tmp_path / "src" / "config.json").write_text(json.dumps(cfg))
    with pytest.raises(RuntimeError, match="size mismatch"):
        convert_diffusers.convert(str(tmp_path / "src"), str(tmp_path / "dst"))
    assert not (tmp_path / "dst").exists()
