"""The port's deployment export (``tools/export_model.py``) on the CPU.

``torch.export`` programs of encode, decode and reconstruct with a symbolic
batch: they equal the port's live wrapper at two batch sizes from one
artifact and the JAX model with the same weights; a flash-eligible export
carries ``vcd::flash_attention_fwd`` as a node of its graph; the CLI's
``--check``, the server's ``--exported_dir`` and the Trainer's
``saving.export_stablehlo`` work; the custom op passes
``torch.library.opcheck``.

Tolerances: the exported programs run the live wrapper's ops, so they are
held to it at 1e-5 (fp32); against JAX the model tests' bounds
(``tests/test_torch_models.py``: rtol 1e-4, atol 1e-5 on latents and 1e-4
on pixels).
"""

import io
import json
import os
import shutil
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_trainer import _resume_cfg

from vae_channel_dynamics_tpu.models import SDXLVAEWrapper as JaxWrapper
from vae_channel_dynamics_tpu.models import VAEConfig as JaxConfig
from vae_channel_dynamics_tpu.models.io import abstract_params, unflatten_params
from vae_channel_dynamics_tpu_torch import server as srv
from vae_channel_dynamics_tpu_torch.models import AutoencoderKL, SDXLVAEWrapper, VAEConfig
from vae_channel_dynamics_tpu_torch.models import io as model_io
from vae_channel_dynamics_tpu_torch.ops import flash_attention as fa
from vae_channel_dynamics_tpu_torch.tools import export_model
from vae_channel_dynamics_tpu_torch.training.loop import Trainer

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

RES = 16
RTOL = 1e-4
ATOL_LATENT, ATOL_PIXEL = 1e-5, 1e-4
# two levels of 32 and 128 channels: at 128px the mid block sees 4096 tokens
# of 128 channels, where the serving policy takes the flash kernel
FLASH_SHAPED = dict(block_out_channels=(32, 128), layers_per_block=1,
                    norm_num_groups=8, latent_channels=4, sample_size=128)
FLASH_RES = 128


@pytest.fixture(autouse=True)
def _one_thread():
    """Tracing and the small models run thousands of small ops: one
    intra-op thread keeps them from contending with the other test workers'
    threads (tests/test_torch_tools.py's fixture)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _model_dir(path, cfg, seed=0):
    model = AutoencoderKL(cfg)
    model.init_weights(torch.Generator().manual_seed(seed))
    model_io.save_model_dir(str(path), cfg, model.state_dict())
    return model_io.load_model_dir(str(path))


def _jax_wrapper(cfg, state):
    params = unflatten_params(abstract_params(cfg), {k: v.numpy() for k, v in state.items()})
    return JaxWrapper(config=cfg, params=params, dtype=jnp.float32)


def _pixels(seed, b, res):
    return np.random.default_rng(seed).uniform(-1, 1, (b, res, res, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The tiny config exported at 16px by the CLI with ``--check``, its
    programs loaded, and the live wrapper of the same model dir."""
    root = tmp_path_factory.mktemp("export")
    model_dir, dst = str(root / "model"), str(root / "artifacts")
    cfg, state = _model_dir(model_dir, VAEConfig.tiny())
    rc = export_model.main(["--model_dir", model_dir, "--dst", dst, "--resolution", str(RES),
                            "--check", "--device", "cpu"])
    live = SDXLVAEWrapper(cfg, state_dict=state, device="cpu")
    return dict(rc=rc, model_dir=model_dir, dst=dst, state=state, live=live,
                manifest=export_model.read_manifest(dst),
                fns=export_model.load_exported(dst, "cpu"))


@pytest.fixture(scope="module")
def flash(tmp_path_factory):
    """The flash-shaped config exported at 128px."""
    root = tmp_path_factory.mktemp("export_flash")
    model_dir, dst = str(root / "model"), str(root / "artifacts")
    cfg, state = _model_dir(model_dir, VAEConfig(**FLASH_SHAPED), seed=3)
    manifest = export_model.export_model_dir(model_dir, dst, resolution=FLASH_RES, device="cpu")
    return dict(dst=dst, state=state, manifest=manifest,
                live=SDXLVAEWrapper(cfg, state_dict=state, attn_impl=manifest["attention_impl"],
                                    device="cpu"),
                fns=export_model.load_exported(dst, "cpu"))


def test_cli_export_and_check(tiny):
    assert tiny["rc"] == 0
    assert sorted(os.listdir(tiny["dst"])) == ["decode.pt2", "encode.pt2", "manifest.json",
                                               "reconstruct.pt2"]


def test_manifest_describes_every_entry_point(tiny):
    manifest = tiny["manifest"]
    assert manifest["format"] == "torch.export"
    assert manifest["torch_version"] == torch.__version__
    assert manifest["device"] == "cpu" and manifest["dtype"] == "float32"
    assert manifest["resolution"] == RES and manifest["latent_resolution"] == RES // 2
    assert manifest["latent_channels"] == 4 and manifest["attention_impl"] == "auto"
    assert set(manifest["entry_points"]) == {"encode", "decode", "reconstruct"}
    assert manifest["entry_points"]["encode"]["in_avals"] == [f"float32[b,{RES},{RES},3]"]
    assert manifest["entry_points"]["encode"]["out_avals"] == ["float32[b,8,8,4]"]
    assert manifest["param_dtypes"] == {k: "float32" for k in tiny["state"]}
    for info in manifest["entry_points"].values():
        assert os.path.getsize(os.path.join(tiny["dst"], info["file"])) == info["bytes"] > 0
        # the weights are an argument, not part of the program
        assert info["bytes"] < 1 << 20
        assert info["params"] == len(tiny["state"]) and info["vcd_ops"] == []


@pytest.mark.parametrize("batch", [1, 3])
def test_exported_matches_live_wrapper_across_batch_sizes(tiny, batch):
    fns, state, live = tiny["fns"], tiny["state"], tiny["live"]
    x = torch.from_numpy(_pixels(batch, batch, RES))
    z = fns["encode"](state, x)
    assert z.shape == (batch, RES // 2, RES // 2, 4)
    torch.testing.assert_close(z, live.encode(x, deterministic=True), rtol=0, atol=1e-5)
    torch.testing.assert_close(fns["decode"](state, z), live.decode(z), rtol=0, atol=1e-5)
    want = live.forward(x, sample_posterior=False)["reconstruction"]
    torch.testing.assert_close(fns["reconstruct"](state, x), want, rtol=0, atol=1e-5)


def _assert_equals_jax(fns, state, jw, name, x):
    z = fns["encode"](state, torch.from_numpy(x))
    if name == "encode":
        want, got, atol = jw.encode(x, deterministic=True), z, ATOL_LATENT
    elif name == "decode":
        want, got, atol = jw.decode(z.numpy()), fns["decode"](state, z), ATOL_PIXEL
    else:
        want = jw.forward(x, sample_posterior=False)["reconstruction"]
        got, atol = fns["reconstruct"](state, torch.from_numpy(x)), ATOL_PIXEL
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=atol)


@pytest.mark.parametrize("name", ["encode", "decode", "reconstruct"])
def test_exported_matches_the_jax_model(tiny, name):
    jw = _jax_wrapper(JaxConfig.tiny(), tiny["state"])
    _assert_equals_jax(tiny["fns"], tiny["state"], jw, name, _pixels(7, 2, RES))


def test_flash_export_carries_the_custom_op(flash):
    manifest = flash["manifest"]
    assert manifest["attention_impl"] == "flash"
    for name, info in manifest["entry_points"].items():
        assert info["vcd_ops"] == ["vcd::flash_attention_fwd"], name
        assert info["bytes"] < 1 << 20
    targets = [n.target for n in flash["fns"]["reconstruct"].graph.nodes
               if n.op == "call_function"]
    assert targets.count(torch.ops.vcd.flash_attention_fwd.default) == 2
    # the dtype asserts of the .to() calls are left out of the saved graph
    assert torch.ops.aten._assert_tensor_metadata.default not in targets


def test_flash_export_matches_live_wrapper_and_jax(flash):
    fns, state, live = flash["fns"], flash["state"], flash["live"]
    x = _pixels(5, 1, FLASH_RES)
    want = live.forward(torch.from_numpy(x), sample_posterior=False)["reconstruction"]
    torch.testing.assert_close(fns["reconstruct"](state, torch.from_numpy(x)), want,
                               rtol=0, atol=1e-5)
    jw = _jax_wrapper(JaxConfig(**FLASH_SHAPED), state)
    for name in ("encode", "decode", "reconstruct"):
        _assert_equals_jax(fns, state, jw, name, x)


def test_load_refuses_another_device_and_missing_ops(tiny, tmp_path):
    with pytest.raises(ValueError, match="exported for device 'cpu'"):
        export_model.load_exported(tiny["dst"], "cuda")
    dst = tmp_path / "copy"
    shutil.copytree(tiny["dst"], dst)
    manifest = json.loads((dst / "manifest.json").read_text())
    manifest["entry_points"]["decode"]["vcd_ops"] = ["vcd::not_registered"]
    (dst / "manifest.json").write_text(json.dumps(manifest))
    with pytest.raises(RuntimeError, match="vcd::not_registered"):
        export_model.load_exported(str(dst), "cpu")


def _post(port, path, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body, method="POST")
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, resp.read()


def test_server_serves_exported_artifacts(tiny):
    """``--exported_dir`` mode: the daemon runs the exported programs,
    answers as the live model does, and refuses sampling with a client
    error (deterministic only)."""
    args = srv.parse_args(["--checkpoint_path", tiny["model_dir"], "--exported_dir",
                           tiny["dst"], "--resolution", "64", "--max_batch", "2",
                           "--port", "0", "--device", "cpu"])
    server = srv.build_server(args)
    assert isinstance(server.wrapper, export_model.ExportedVAEWrapper)
    assert server.resolution == RES and server.latent_shape == (RES // 2, RES // 2, 4)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        server.warmup()  # the deterministic endpoints; sampling is skipped
        with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/healthz",
                                    timeout=30) as resp:
            health = json.loads(resp.read())
        assert health["scaling_factor"] == tiny["manifest"]["scaling_factor"]
        x = _pixels(11, 1, RES)[0]
        buf = io.BytesIO()
        np.save(buf, x)
        status, body = _post(server.port, "/reconstruct?format=npy", buf.getvalue())
        assert status == 200
        want = tiny["live"].forward(torch.from_numpy(x[None]),
                                    sample_posterior=False)["reconstruction"]
        np.testing.assert_allclose(np.load(io.BytesIO(body)), want[0].numpy(),
                                   rtol=0, atol=1e-5)
        with pytest.raises(urllib.error.HTTPError) as info:
            _post(server.port, "/encode?deterministic=false", buf.getvalue())
        assert 400 <= info.value.code < 500
        assert b"deterministic-only" in info.value.read()
    finally:
        server.shutdown()
        thread.join(timeout=10)
    assert not thread.is_alive()


def test_exported_dir_with_tile_size_exits_2(tiny):
    assert srv.main(["--checkpoint_path", tiny["model_dir"], "--exported_dir", tiny["dst"],
                     "--tile_size", "8", "--device", "cpu"]) == 2


def test_trainer_writes_the_export(tmp_path):
    cfg = _resume_cfg(tmp_path, "exported", stop_after=2)
    cfg["saving"]["export_stablehlo"] = True
    summary = Trainer(cfg, device="cpu").train()
    export_dir = os.path.join(summary["final_model_dir"], "exported")
    assert summary["export_dir"] == export_dir
    manifest = export_model.read_manifest(export_dir)
    assert manifest["resolution"] == 32 and manifest["dtype"] == "float32"
    vae_cfg, state = model_io.load_model_dir(os.path.join(summary["final_model_dir"], "vae"))
    wrapper = export_model.ExportedVAEWrapper(export_dir, state, device="cpu")
    live = SDXLVAEWrapper(vae_cfg, state_dict=state, device="cpu")
    x = torch.from_numpy(_pixels(2, 2, 32))
    torch.testing.assert_close(wrapper.forward(x, sample_posterior=False)["reconstruction"],
                               live.forward(x, sample_posterior=False)["reconstruction"],
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_opcheck_flash_attention_fwd_on_cpu(dtype):
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 128, 64, generator=gen).to(dtype) for _ in range(3))
    torch.library.opcheck(torch.ops.vcd.flash_attention_fwd.default, (q, k, v, 0.125, dtype))
    torch.testing.assert_close(fa.flash_attention_fwd(q, k, v, scale=0.125, out_dtype=dtype),
                               fa.flash_attention_reference(q, k, v, 0.125, dtype),
                               rtol=0, atol=0)
