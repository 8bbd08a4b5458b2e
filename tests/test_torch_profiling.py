"""Profiling in the port, on the CPU: ``utils/profiling.py`` (``TraceCapture``
over a step window, ``StepTimer``) and ``tools/profile_summary.py``.

- ``TraceCapture`` starts at the first step at or after ``start_step``,
  stops at ``start_step + num_steps``, writes one Chrome trace, never
  restarts, and ``close`` is idempotent and writes a window still open; a
  CUDA run whose trace holds no device event raises instead of writing.
- The Trainer on ``configs/smoke_synthetic.yaml`` with profiling on writes a
  trace that ``profile_summary`` parses; an error in the loop still closes
  the window, and the loop's error is the one raised.
- ``profile_summary`` on a hand-written Chrome trace with kernel events:
  the families, their shares and launches, the top-N kernels, and a rate
  for the op that carries FLOPs; on a CPU trace, no device section and the
  CPU ops under their own heading.
- ``StepTimer`` equals the JAX package's under the same patched clock.
- The repository's configs that set the options the port's Trainer refused
  before (``configs/bench_256px.yaml``'s profiling,
  ``configs/bench_adafactor_256px.yaml``'s Adafactor, and ``remat: conv``)
  run through it as written, only their sizes cut to the tiny model.
"""

import copy
import json
import os
import time

import pytest
import torch

from vae_channel_dynamics_tpu.utils.profiling import StepTimer as JaxStepTimer
from vae_channel_dynamics_tpu_torch.tools import profile_summary as ps
from vae_channel_dynamics_tpu_torch.training import loop
from vae_channel_dynamics_tpu_torch.training.loop import Trainer
from vae_channel_dynamics_tpu_torch.utils.config_utils import load_config
from vae_channel_dynamics_tpu_torch.utils.profiling import StepTimer, TraceCapture

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    """The Trainer runs and the small models issue thousands of small ops: one
    intra-op thread keeps them from contending with the other test workers'
    threads (tests/test_torch_flash_bwd_f32.py's ``one_thread``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)



def _traces(root):
    return sorted(f for f in os.listdir(root) if f.endswith(".pt.trace.json"))


def _work():
    torch.nn.functional.conv2d(torch.ones(1, 2, 8, 8), torch.ones(2, 2, 3, 3)).sum()


def test_window_starts_stops_once_and_writes_one_trace(tmp_path):
    tc = TraceCapture({"enabled": True, "start_step": 3, "num_steps": 2}, str(tmp_path))
    for step in (1, 2):
        tc.maybe_start(step)
        _work()
        tc.maybe_stop(step)
    assert not (tmp_path / "profile").exists()
    for step in (3, 4, 5):
        tc.maybe_start(step)
        _work()
        tc.maybe_stop(step)
    assert _traces(tmp_path / "profile") == ["trace_steps3-5.pt.trace.json"]
    assert tc.trace_path == str(tmp_path / "profile" / "trace_steps3-5.pt.trace.json")
    # done: no second window, and close does nothing more
    tc.maybe_start(6)
    tc.maybe_stop(9)
    tc.close()
    tc.close()
    assert _traces(tmp_path / "profile") == ["trace_steps3-5.pt.trace.json"]
    events = ps.load_trace(tc.trace_path)["traceEvents"]
    assert any(e.get("name") == "aten::conv2d" for e in events)


def test_disabled_capture_does_nothing(tmp_path):
    tc = TraceCapture({"enabled": False, "start_step": 0}, str(tmp_path))
    tc.maybe_start(0)
    tc.maybe_stop(10)
    tc.close()
    assert not (tmp_path / "profile").exists() and tc.trace_path is None


def test_close_writes_an_open_window_once(tmp_path):
    tc = TraceCapture({"enabled": True, "start_step": 0, "num_steps": 100,
                       "output_subdir": "prof"}, str(tmp_path))
    tc.maybe_start(0)
    _work()
    tc.maybe_stop(0)
    tc.maybe_start(1)  # already active: no restart
    tc.maybe_stop(1)
    tc.close()
    tc.close()
    assert _traces(tmp_path / "prof") == ["trace_steps0-1.pt.trace.json"]


def test_cuda_trace_without_device_events_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    tc = TraceCapture({"enabled": True, "start_step": 0, "num_steps": 1}, str(tmp_path),
                      device="cuda")
    tc.maybe_start(0)
    _work()
    with pytest.raises(RuntimeError, match="no CUDA kernel"):
        tc.maybe_stop(1)
    assert _traces(tmp_path / "profile") == []
    tc.close()  # the window is over: nothing left to raise


def _smoke_cfg(tmp_path, **profiling):
    cfg = load_config(os.path.join(REPO, "configs", "smoke_synthetic.yaml"))
    cfg = copy.deepcopy(cfg)
    cfg["output_dir"] = str(tmp_path)
    cfg["logit_lens"]["enabled"] = False
    cfg["logging"]["report_to"] = "jsonl"
    cfg["data"]["do_validation"] = False
    cfg["training"]["stop_after_steps"] = 4
    cfg["profiling"] = {"enabled": True, **profiling}
    return cfg


def test_trainer_writes_a_trace_the_summary_parses(tmp_path):
    cfg = _smoke_cfg(tmp_path, start_step=2, num_steps=1)
    summary = Trainer(cfg, device="cpu").train()
    assert summary["global_step"] == 4
    trace_dir = tmp_path / cfg["run_name"] / "profile"
    assert _traces(trace_dir) == ["trace_steps2-3.pt.trace.json"]
    text = ps.summarize(str(trace_dir), top_n=5)
    assert "no device events in this trace (a CPU run)" in text
    assert "top 5 CPU ops by host time" in text and "aten::" in text
    assert "device ms" not in text


def test_trainer_closes_the_window_on_an_error(tmp_path, monkeypatch):
    cfg = _smoke_cfg(tmp_path, start_step=1, num_steps=50)
    real = loop.make_train_step

    def failing(*args, **kwargs):
        step = real(*args, **kwargs)

        def run(state, *a, **k):
            if state.step == 2:
                raise ArithmeticError("planted failure at step 3")
            return step(state, *a, **k)

        return run

    monkeypatch.setattr(loop, "make_train_step", failing)
    with pytest.raises(ArithmeticError, match="planted"):
        Trainer(cfg, device="cpu").train()
    assert _traces(tmp_path / cfg["run_name"] / "profile") == ["trace_steps1-2.pt.trace.json"]
    # the profiler is off: another window can start in this process
    tc = TraceCapture({"enabled": True, "start_step": 0, "num_steps": 0}, str(tmp_path / "x"))
    tc.maybe_start(0)
    tc.maybe_stop(0)
    assert _traces(tmp_path / "x" / "profile") == ["trace_steps0-0.pt.trace.json"]


@pytest.mark.parametrize("name,remat", [("bench_256px", None), ("bench_adafactor_256px", None),
                                        ("bench_256px", "conv")])
def test_repo_configs_run_as_written(tmp_path, name, remat):
    cfg = load_config(os.path.join(REPO, "configs", f"{name}.yaml"))
    cfg["output_dir"] = str(tmp_path)
    cfg["model"].update(architecture="tiny", pretrained_vae_name=None)
    if remat:
        cfg["model"]["remat"] = remat
    cfg["data"].update(resolution=32, batch_size=2, max_samples=8)
    cfg["training"]["stop_after_steps"] = 3
    profiling = cfg.get("profiling", {})
    if profiling.get("enabled"):
        profiling.update(start_step=2, num_steps=1)
    summary = Trainer(cfg, device="cpu").train()
    assert summary["global_step"] == 3
    run = tmp_path / cfg["run_name"]
    state = torch.load(run / "final_model" / "state" / "train_state.pt", weights_only=True)
    want = "FactoredState" if cfg["training"].get("optimizer") == "adafactor" else "OptState"
    assert state["opt"]["kind"] == want
    if profiling.get("enabled"):
        assert _traces(run / "profile") == ["trace_steps2-3.pt.trace.json"]


# --------------------------------------------------------------------------- #
# profile_summary on a hand-written trace
# --------------------------------------------------------------------------- #
def _kernel(name, ts, dur, corr, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7, "ts": ts, "dur": dur,
            "args": {"correlation": corr, "device": 0, "stream": 7}}


def _launch(ts, corr):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 1, "tid": 1,
            "ts": ts, "dur": 1, "args": {"correlation": corr}}


def _op(name, ts, dur, flops=None):
    args = {"External id": ts}
    if flops is not None:
        args["flops"] = flops
    return {"ph": "X", "cat": "cpu_op", "name": name, "pid": 1, "tid": 1, "ts": ts, "dur": dur,
            "args": args}


GN = "void gn_fwd_reduce_kernel<__nv_bfloat16>(Params)"
FLASH = "void flash_bwd_dkv_kernel<512>(CUtensorMap, CUtensorMap, float)"
FPROP = "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc"
EW = "void at::native::vectorized_elementwise_kernel<4, at::native::AddFunctor<float>>"


def _fixture_trace():
    events = [
        _op("aten::conv2d", 100, 50, flops=4.0e9),
        _launch(110, 1), _launch(120, 2),
        _kernel(FPROP, 200, 20, 1), _kernel(FPROP, 230, 20, 2),
        _op("aten::group_norm_kernel", 300, 10), _launch(301, 3), _launch(302, 4),
        _launch(303, 5),
        _kernel(GN, 400, 10, 3), _kernel(GN, 410, 10, 4), _kernel(GN, 420, 10, 5),
        _kernel(FLASH, 500, 40, 6),
        _kernel(EW, 600, 5, 7),
        _kernel("Memcpy HtoD (Pageable -> Device)", 700, 5, 8, cat="gpu_memcpy"),
        {"ph": "M", "name": "process_name", "pid": 0, "tid": 0, "args": {"name": "GPU 0"}},
    ]
    return {"traceEvents": events}


def test_summary_families_shares_and_top_n(tmp_path):
    trace = _fixture_trace()
    device = ps.device_events(trace)
    assert len(device) == 8
    table = {fam: (us, n) for fam, us, n in ps.family_table(device)}
    assert table == {
        ps.GROUPNORM: (30, 3),
        ps.CUDNN_CONVS: (40, 2),
        "flash attention kernels (flash_*)": (40, 1),
        "elementwise": (5, 1),
        "memcpy/memset": (5, 1),
    }
    assert [name for _us, _n, name in ps.top_kernels(device, 2)] == [FPROP, FLASH]
    assert ps.top_kernels(device, 10)[2] == (30, 3, GN)

    path = tmp_path / "profile" / "trace_steps1-2.pt.trace.json"
    path.parent.mkdir()
    path.write_text(json.dumps(trace))
    text = ps.summarize(str(tmp_path / "profile"), top_n=3)
    assert "device: 8 events, 0.120 ms of device time" in text
    gn_line = next(ln for ln in text.splitlines() if ln.startswith(ps.GROUPNORM))
    assert gn_line.split()[-3:] == ["0.030", "25.0", "3"]
    assert "top 3 kernels by self device time:" in text
    top = text.split("top 3 kernels")[1].split("rates")[0]
    assert GN[:40] in top and EW[:40] not in top


def test_summary_rate_of_an_op_that_carries_flops(tmp_path):
    rates = ps.op_rates(_fixture_trace())
    # the conv's two launches run 40 us of kernels: 4e9 FLOPs in 40 us
    assert rates == [("aten::conv2d", 4.0e9, 40.0)]
    (tmp_path / "t.json").write_text(json.dumps(_fixture_trace()))
    line = next(ln for ln in ps.summarize(str(tmp_path)).splitlines()
                if ln.startswith("aten::conv2d"))
    assert line.split()[-2:] == ["100.00", "TFLOP/s"]


def test_summary_of_a_cpu_trace_has_no_device_section(tmp_path):
    events = [_op("aten::mm", 0, 30), _op("aten::add", 40, 5), _op("aten::mm", 50, 10)]
    (tmp_path / "t.json").write_text(json.dumps({"traceEvents": events}))
    text = ps.summarize(str(tmp_path), top_n=5)
    assert "no device events in this trace (a CPU run)" in text
    assert "device ms" not in text and "TFLOP/s" not in text
    host = text.split("top 5 CPU ops by host time")[1].splitlines()[1:]
    assert host[0].split()[:3] == ["0.040", "ms", "x2"] and host[0].endswith("aten::mm")


def test_cli_reads_the_newest_trace(tmp_path, capsys):
    (tmp_path / "a.json").write_text(json.dumps({"traceEvents": [_op("aten::old", 0, 1)]}))
    newer = tmp_path / "sub" / "b.pt.trace.json"
    newer.parent.mkdir()
    newer.write_text(json.dumps(_fixture_trace()))
    os.utime(tmp_path / "a.json", (1, 1))
    assert ps.main(["--trace_dir", str(tmp_path), "--top_n", "2"]) == 0
    out = capsys.readouterr().out
    assert str(newer) in out and "top 2 kernels" in out and "TFLOP/s" in out
    with pytest.raises(FileNotFoundError):
        ps.find_trace(str(tmp_path / "empty"))


@pytest.mark.parametrize("name,want", [
    ("void conv3x3_dw_kernel<64>(...)", "fused resnet kernels (#9-#11)"),
    ("void conv3x3_dw_f32_kernel<32>(...)", "fused resnet kernels (#9-#11)"),
    ("fused_gn_silu_conv3x3_f32_kernel(CUtensorMap_st, ...)", "fused resnet kernels (#9-#11)"),
    ("void split_nhwc_f32_kernel<true>(...)", "fused resnet kernels (#9-#11)"),
    ("void flash_fwd_f32_kernel<512>(...)", "flash attention kernels (flash_*)"),
    ("void sum_splits_kernel<float>(...)", ps.GROUPNORM),
    ("void flash_fwd_kernel<512>(...)", "flash attention kernels (flash_*)"),
    ("sm90_xmma_dgrad_implicit_gemm", ps.CUDNN_CONVS),
    ("void at::native::nchwToNhwcKernel<float>", "layout transposes"),
    ("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NTT", "other"),
    ("void at::native::reduce_kernel<512, 1>", "reductions"),
    ("void at::native::(anonymous namespace)::multi_tensor_apply_kernel", "optimizer (foreach)"),
])
def test_family_of_kernel_names(name, want):
    assert ps.family(name) == want


# --------------------------------------------------------------------------- #
# StepTimer
# --------------------------------------------------------------------------- #
def test_step_timer_matches_jax(monkeypatch):
    ticks = iter([0.0, 0.5, 1.25, 1.5, 3.0, 3.5, 3.75, 6.0, 6.5] * 2)
    monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
    port, ref = StepTimer(window=3), JaxStepTimer(window=3)
    seen = []
    for timer in (port, ref):
        rates = []
        for images in (4, 4, 8, 4, 2, 6, 4, 4, 8):
            timer.update(images)
            rates.append(timer.images_per_sec)
        seen.append(rates)
    assert seen[0] == seen[1]
    assert seen[0][3] == pytest.approx(16 / 1.5)
