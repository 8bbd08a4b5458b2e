"""The port's server across replicas, on the CPU: two replicas of the tiny
model (an explicit list of two CPU replicas standing in for two cards)
answer what one replica answers, with ``max_batch`` rounded up to a
multiple of the replica count, each padded batch split into contiguous
blocks and each block's padding sliced off before the copy to the host; on
the CPU ``use_mesh`` keeps one replica; exported programs, pinned to one
device, refuse ``use_mesh=True`` and are served alone when it is unset."""

import io
import threading
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from vae_channel_dynamics_tpu_torch import server as srv
from vae_channel_dynamics_tpu_torch.models import SDXLVAEWrapper, VAEConfig
from vae_channel_dynamics_tpu_torch.tools.export_model import ExportedVAEWrapper

RES = 32


def _npy(arr):
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def _post(port, path, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body, method="POST")
    with urllib.request.urlopen(req, timeout=60) as resp:
        assert resp.status == 200
        body = resp.read()
    if path.startswith("/decode"):
        return body  # a PNG
    return np.load(io.BytesIO(body))


@pytest.fixture(scope="module")
def servers():
    wrapper = SDXLVAEWrapper(VAEConfig.tiny(), seed=0, device="cpu")
    out = {}
    for name, kwargs in (("one", {"use_mesh": False}),
                         ("two", {"replicas": [wrapper, wrapper.replicate("cpu")]})):
        s = srv.VAEServer(wrapper, resolution=RES, max_batch=3, max_wait_ms=50, port=0,
                          **kwargs)
        t = threading.Thread(target=s.serve_forever, daemon=True)
        t.start()
        out[name] = (s, t)
    yield {k: v[0] for k, v in out.items()}
    for s, t in out.values():
        s.shutdown()
        t.join(timeout=10)


def test_replicas_and_batch_rounding(servers):
    one, two = servers["one"], servers["two"]
    assert len(one.replicas) == 1 and one.batcher.max_batch == 3
    assert len(two.replicas) == 2 and two.batcher.max_batch == 4
    first, second = two.replicas
    assert first is two.wrapper and second is not first
    for k, v in first.state_dict().items():
        assert torch.equal(second.state_dict()[k], v)


def test_two_replicas_answer_as_one(servers):
    rng = np.random.default_rng(0)
    images = [rng.uniform(-1, 1, (RES, RES, 3)).astype(np.float32) for _ in range(5)]
    latents = [rng.standard_normal((RES // 2, RES // 2, 4)).astype(np.float32)
               for _ in range(3)]
    for path, bodies in (("/reconstruct?format=npy", images), ("/encode", images),
                         ("/decode", latents)):
        got = {}
        for name, s in servers.items():
            # concurrent requests, so batches of several rows reach both blocks
            with ThreadPoolExecutor(len(bodies)) as pool:
                got[name] = list(pool.map(lambda b, p=s.port: _post(p, path, _npy(b)),
                                          bodies))
        for a, b in zip(got["two"], got["one"]):
            if isinstance(a, bytes):
                assert a == b, path
            else:
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6, err_msg=path)
    assert servers["two"].batcher.items_served >= 13


def test_the_split_puts_contiguous_blocks_on_each_replica(servers):
    two = servers["two"]
    seen = []
    originals = [w.forward for w in two.replicas]
    for i, w in enumerate(two.replicas):
        def forward(x, *a, _f=originals[i], _i=i, **k):
            seen.append((_i, x[:, 0, 0, 0].clone()))
            return _f(x, *a, **k)
        w.forward = forward
    try:
        x = np.stack([np.full((RES, RES, 3), v, np.float32) for v in (0.1, 0.2, 0.3)])
        two._run("reconstruct", x)
    finally:
        for w, f in zip(two.replicas, originals):
            w.forward = f
    blocks = dict(seen)
    np.testing.assert_allclose(blocks[0].numpy(), [0.1, 0.2])
    # the pad row (zeros) lands on the last replica
    np.testing.assert_allclose(blocks[1].numpy(), [0.3, 0.0])


class _Pinned:
    """Stands in for an ExportedVAEWrapper: programs pinned to one device."""

    supports_mesh = ExportedVAEWrapper.supports_mesh
    device = torch.device("cpu")


def test_exported_programs_refuse_use_mesh():
    assert ExportedVAEWrapper.supports_mesh is False
    with pytest.raises(ValueError, match="use_mesh=True"):
        srv.serving_replicas(_Pinned(), True)
    pinned = _Pinned()
    assert srv.serving_replicas(pinned, None) == [pinned]
    assert srv.serving_replicas(pinned, False) == [pinned]


@pytest.mark.parametrize("use_mesh", [None, True, False])
def test_one_cpu_device_keeps_one_replica(use_mesh):
    wrapper = SDXLVAEWrapper(VAEConfig.tiny(), seed=0, device="cpu")
    assert srv.serving_replicas(wrapper, use_mesh) == [wrapper]


@pytest.mark.parametrize("rows", [1, 2, 3, 4])
def test_each_block_returns_its_valid_rows(servers, rows):
    two = servers["two"]
    x = np.stack([np.full((RES, RES, 3), 0.1 * (v + 1), np.float32) for v in range(rows)])
    # the first replica is the one server's wrapper: its answer first
    want = servers["one"]._run("reconstruct", x)
    returned = []
    originals = [w.forward for w in two.replicas]
    for i, w in enumerate(two.replicas):
        def forward(x, *a, _f=originals[i], **k):
            out = _f(x, *a, **k)
            returned.append(out["reconstruction"].shape[0])
            return out
        w.forward = forward
    try:
        got = two._run("reconstruct", x)
    finally:
        for w, f in zip(two.replicas, originals):
            w.forward = f
    # both blocks of two rows launched, only the valid rows come back
    assert returned == [2, 2] and got.shape == (rows, RES, RES, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_server_cli_leaves_the_cards_to_the_environment():
    args = srv.parse_args(["--checkpoint_path", "x", "--device", "cpu"])
    assert not hasattr(args, "use_mesh") and not hasattr(args, "replicas")
    with pytest.raises(SystemExit):
        srv.parse_args(["--checkpoint_path", "x", "--replicas", "2"])
