"""The PyTorch port's serving path on the CPU: the HTTP server answers with
the port wrapper's own results, the batch CLI writes its outputs, and
running the port loads no jax."""

import io
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from vae_channel_dynamics_tpu_torch import serve
from vae_channel_dynamics_tpu_torch import server as srv
from vae_channel_dynamics_tpu_torch.models import SDXLVAEWrapper, VAEConfig
from vae_channel_dynamics_tpu_torch.models import io as tio

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = 32


def _npy(arr):
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def _post(port, path, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 method="POST")
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, resp.read()


@pytest.fixture(scope="module")
def server():
    wrapper = SDXLVAEWrapper(VAEConfig.tiny(), seed=0, device="cpu")
    s = srv.VAEServer(wrapper, resolution=RES, max_batch=2, max_wait_ms=5, port=0)
    t = threading.Thread(target=s.serve_forever, daemon=True)
    t.start()
    yield s
    s.shutdown()
    t.join(timeout=10)
    assert not t.is_alive()


def test_healthz(server):
    with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/healthz",
                                timeout=30) as resp:
        body = json.loads(resp.read())
    assert resp.status == 200
    assert body["status"] == "ok" and body["platform"] == "cpu"
    assert body["resolution"] == RES and body["max_batch"] == 2


def test_endpoints_return_the_wrappers_results(server):
    w = server.wrapper
    x = np.random.default_rng(0).uniform(-1, 1, (RES, RES, 3)).astype(np.float32)
    status, body = _post(server.port, "/reconstruct?format=npy", _npy(x))
    assert status == 200
    recon = np.load(io.BytesIO(body))
    want = w.forward(torch.from_numpy(x[None]), sample_posterior=False)["reconstruction"]
    # the server runs the batch padded to max_batch; rows are independent
    np.testing.assert_allclose(recon, want[0].numpy(), rtol=1e-5, atol=1e-5)

    status, body = _post(server.port, "/encode", _npy(x))
    assert status == 200
    z = np.load(io.BytesIO(body))
    np.testing.assert_allclose(
        z, w.encode(torch.from_numpy(x[None]), deterministic=True)[0].numpy(),
        rtol=1e-5, atol=1e-5)
    assert z.shape == server.latent_shape

    status, body = _post(server.port, "/decode", _npy(z))
    assert status == 200
    from PIL import Image

    img = np.asarray(Image.open(io.BytesIO(body)))
    dec = w.decode(torch.from_numpy(z[None]))[0].numpy()
    expect = (np.clip((dec + 1.0) / 2.0, 0.0, 1.0) * 255).astype(np.uint8)
    assert img.shape == (RES, RES, 3)
    assert np.abs(img.astype(int) - expect.astype(int)).max() <= 1
    # the batcher path the handler calls returns the decoded pixels
    np.testing.assert_allclose(server.batcher.submit("decode", z), dec,
                               rtol=1e-5, atol=1e-5)


def test_sampling_requests_draw_fresh_noise(server):
    x = np.zeros((RES, RES, 3), np.float32)
    a = np.load(io.BytesIO(_post(server.port, "/encode?deterministic=false", _npy(x))[1]))
    b = np.load(io.BytesIO(_post(server.port, "/encode?deterministic=false", _npy(x))[1]))
    assert not np.array_equal(a, b)


def test_image_bytes_go_through_the_transform(server):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.full((40, 48, 3), 128, np.uint8)).save(buf, "PNG")
    status, body = _post(server.port, "/reconstruct", buf.getvalue())
    assert status == 200 and body[:8] == b"\x89PNG\r\n\x1a\n"


def test_bad_shapes_are_client_errors(server):
    for path, arr in (("/encode", np.zeros((8, 8, 3), np.float32)),
                      ("/decode", np.zeros((3, 3, 4), np.float32))):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(server.port, path, _npy(arr))
        assert e.value.code == 400


def _settled_stats(server, timeout=10.0):
    """``stats()`` once no handler is in flight: a handler records its
    request after the client already holds the response."""
    deadline = time.monotonic() + timeout
    while server._inflight and time.monotonic() < deadline:
        time.sleep(0.01)
    return server.stats()


def test_concurrent_requests_coalesce(server):
    x = np.zeros((RES, RES, 3), np.float32)
    before = server.batcher.items_served
    errors = _settled_stats(server)["errors"]
    results = []

    def fire():
        results.append(_post(server.port, "/encode", _npy(x))[0])

    threads = [threading.Thread(target=fire) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert results == [200] * 6
    assert server.batcher.items_served - before == 6
    assert _settled_stats(server)["errors"] == errors


def test_build_server_serves_bf16_on_cpu(tmp_path):
    cfg = VAEConfig.tiny()
    tio.save_model_dir(str(tmp_path / "vae"), cfg,
                       SDXLVAEWrapper(cfg, seed=1, device="cpu").state_dict())
    args = srv.parse_args(["--checkpoint_path", str(tmp_path), "--resolution", str(RES),
                           "--max_batch", "2", "--port", "0", "--device", "cpu"])
    s = srv.build_server(args)
    # shutdown() stops a running accept loop, so one runs
    t = threading.Thread(target=s.serve_forever, daemon=True)
    t.start()
    try:
        assert s.wrapper.dtype == torch.bfloat16
        assert s.wrapper.attn_impl == "auto"  # 16x16 latent tokens: below the flash rule
        out = s.batcher.submit("reconstruct", np.zeros((RES, RES, 3), np.float32))
        assert out.shape == (RES, RES, 3) and out.dtype == np.float32
        assert np.isfinite(out).all()
    finally:
        s.shutdown()
        t.join(timeout=10)


def test_serving_policy_picks_flash_from_512px():
    sdxl = VAEConfig.sdxl()
    assert srv.resolve_serving_attention_impl("auto", 256, sdxl) == "auto"
    assert srv.resolve_serving_attention_impl("auto", 512, sdxl) == "flash"
    assert srv.resolve_serving_attention_impl("auto", 1024, sdxl) == "flash"
    assert srv.resolve_serving_attention_impl("naive", 1024, sdxl) == "naive"


def test_server_cli_refuses_cuda_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: --device cuda is valid here")
    cfg = VAEConfig.tiny()
    tio.save_model_dir(str(tmp_path), cfg, SDXLVAEWrapper(cfg, device="cpu").state_dict())
    with pytest.raises(RuntimeError, match="cuda"):
        srv.build_server(srv.parse_args(["--checkpoint_path", str(tmp_path), "--port", "0"]))


def test_serve_cli_reconstruct_encode_decode(tmp_path):
    cfg = VAEConfig.tiny()
    ckpt = tmp_path / "ckpt"
    tio.save_model_dir(str(ckpt), cfg, SDXLVAEWrapper(cfg, seed=2, device="cpu").state_dict())
    common = ["--checkpoint_path", str(ckpt), "--resolution", str(RES),
              "--batch_size", "2", "--device", "cpu"]
    out = tmp_path / "recon"
    assert serve.main(common + ["--input", "synthetic://cifar10", "--max_samples", "3",
                                "--output", str(out)]) == 0
    metrics = json.loads((out / "serve_metrics.json").read_text())
    assert metrics["num_images"] == 3 and np.isfinite(metrics["avg_mse"])
    assert len(list(out.glob("recon_*.png"))) == 3

    enc = tmp_path / "enc"
    assert serve.main(common + ["--input", "synthetic://cifar10", "--max_samples", "2",
                                "--mode", "encode", "--output", str(enc)]) == 0
    z = np.load(enc / "latents_00000.npy")
    assert z.shape == (2, RES // 2, RES // 2, 4)

    dec = tmp_path / "dec"
    assert serve.main(common + ["--input", str(enc / "latents_00000.npy"),
                                "--mode", "decode", "--output", str(dec)]) == 0
    assert len(list(dec.glob("decoded_*.png"))) == 2


def test_the_port_runs_without_loading_jax():
    code = (
        "import sys, numpy as np, torch\n"
        "from vae_channel_dynamics_tpu_torch import server, serve\n"
        "from vae_channel_dynamics_tpu_torch.models import SDXLVAEWrapper, VAEConfig\n"
        "w = SDXLVAEWrapper(VAEConfig.tiny(), device='cpu', attn_impl='flash')\n"
        "out = w.forward(np.zeros((1, 32, 32, 3), np.float32), sample_posterior=False)\n"
        "assert out['reconstruction'].shape == (1, 32, 32, 3)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'flax')))\n"
        "assert not bad, bad\n"
        "print('no jax')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=ROOT, env=env)
    assert proc.returncode == 0, proc.stderr
    assert "no jax" in proc.stdout
