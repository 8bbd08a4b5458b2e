"""HTTP serving daemon with dynamic micro-batching, on PyTorch.

``python -m vae_channel_dynamics_tpu_torch.server --checkpoint_path <dir>
[--port 8400] [--resolution 256] [--max_batch 8] [--max_wait_ms 10]
[--tile_size 0] [--tile_overlap 0.25] [--slicing] [--exported_dir DIR]
[--device cuda]``

Counterpart of ``vae_channel_dynamics_tpu/server.py``. The batcher, the
HTTP handler and the overload rules are the same framework-free code; only
the model call (``VAEServer._run``) differs. Every request is preprocessed to
the server resolution and each batch is padded to ``max_batch``, so the
device sees one shape per endpoint.

Endpoints (stdlib http.server):
  GET  /healthz          liveness + model/device info
  GET  /stats            request counts, latency percentiles, batching ratio
  POST /reconstruct      image bytes -> PNG (header X-VCD-MSE vs the input)
  POST /encode           image bytes -> scaled latents as .npy
  POST /decode           .npy latents (one image, HxWx4) -> PNG
A ``.npy`` body ((H, W, 3) float32 in [-1, 1]) to /reconstruct or /encode
skips the image codec, and ``?format=npy`` returns /reconstruct as ``.npy``:
those paths need no Pillow. Query ``?deterministic=false`` samples the
posterior instead of its mode.

Overload behaviour: bodies above ``--max_body_mb`` get 413 before they are
read; beyond ``--max_queue`` waiting requests new ones get 503 +
Retry-After; connections carry a ``--read_timeout_s`` socket timeout.

``--tile_size`` encodes and decodes in overlapping tiles of that many pixels
(``wrapper.enable_tiling``), so activation memory follows the tile and not
the resolution; ``--slicing`` runs one image per pass. With either,
/reconstruct runs encode then decode (the tiled path) instead of the untiled
forward, and the attention policy is resolved at the tile size.

``--exported_dir`` serves the ``torch.export`` programs of
``tools/export_model.py`` (``ExportedVAEWrapper``) instead of the live
model: deterministic only (``?deterministic=false`` gets a client error),
at the manifest's resolution, untiled; the weights still load from
``--checkpoint_path``.

Across cards (wherever more than one card is visible, as the JAX server
shards over a data mesh; ``VAEServer(use_mesh=False)`` keeps one): one
replica of the live model a card, ``max_batch`` rounded up to a multiple of
the replica count, and each padded micro-batch split into contiguous
blocks, one a replica. Every block is copied in and launched before any
result is read, so the cards run together from the one batcher thread; each
block's valid rows are sliced on its card and the results concatenated in
order. Exported programs are pinned to one device: ``use_mesh=True`` with
them is refused, and unset serves them on one card.
"""

from __future__ import annotations

import argparse
import io
import json
import logging
import os
import queue
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Sequence, Tuple
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from .models import SDXLVAEWrapper
from .models import io as model_io
from .ops.attention import resolve_serving_impl

logger = logging.getLogger(__name__)


def resolve_serving_attention_impl(attn_impl, resolution, config, logger=None):
    """Serving view of the shared ``auto`` policy
    (``ops.attention.resolve_serving_impl``): from 4096 mid-block tokens
    (512px for the SDXL /8 downsampling) ``auto`` becomes the flash kernel
    when it takes the shape. Explicit impls pass through untouched."""
    if attn_impl != "auto":
        return attn_impl
    factor = 2 ** (len(config.block_out_channels) - 1)
    tokens = (resolution // factor) ** 2
    channels = config.block_out_channels[-1]
    resolved = resolve_serving_impl(attn_impl, tokens, channels)
    if resolved == "flash":
        if logger is not None:
            logger.info(
                "attention_impl=auto at %d tokens: using the flash kernel.",
                tokens,
            )
        return "flash"
    return attn_impl


# --------------------------------------------------------------------------- #
# Micro-batching
# --------------------------------------------------------------------------- #
class _Pending:
    __slots__ = ("kind", "payload", "event", "result", "error")

    def __init__(self, kind: str, payload: np.ndarray):
        self.kind = kind
        self.payload = payload
        self.event = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None


class BatcherOverloaded(RuntimeError):
    """Raised by submit() when the waiting queue is at max_queue — the
    HTTP layer maps this to 503 so overload sheds instead of piling up."""


class MicroBatcher:
    """Coalesce concurrent single-item requests into padded device batches.

    One worker thread drains the queue: it blocks for the first item, then
    keeps collecting until ``max_batch`` items are in hand or ``max_wait_ms``
    elapsed since the first. Items are grouped by kind (encode/decode/...)
    and each group runs as ONE ``runner`` call on a batch padded to
    ``max_batch`` — so the device sees a single static shape per kind.

    Backpressure: at most ``max_queue`` items may wait; beyond that
    ``submit`` raises :class:`BatcherOverloaded` immediately (load shedding)
    instead of queueing unboundedly.
    """

    def __init__(self, runner, max_batch: int = 8, max_wait_ms: float = 10.0,
                 max_queue: int = 64):
        self._runner = runner
        self.max_batch = max(1, int(max_batch))
        self.max_wait_s = max(0.0, float(max_wait_ms) / 1e3)
        self.max_queue = max(1, int(max_queue))
        self._queue: "queue.Queue[Optional[_Pending]]" = queue.Queue()
        self._stopped = False
        # serializes enqueue vs close: a submit that passed the _stopped
        # check cannot interleave its put() with close()'s drain
        self._submit_lock = threading.Lock()
        self.batch_calls = 0
        self.items_served = 0
        self.rejected = 0
        self._thread = threading.Thread(
            target=self._worker, name="vcd-batcher", daemon=True
        )
        self._thread.start()

    def submit(self, kind: str, payload: np.ndarray) -> np.ndarray:
        item = _Pending(kind, payload)
        with self._submit_lock:
            if self._stopped:
                # BatcherOverloaded (a RuntimeError) so the HTTP layer sheds
                # with 503 + Retry-After during a graceful drain — the
                # client retries against a live peer instead of getting 500
                raise BatcherOverloaded("batcher stopped (shutting down)")
            if self._queue.qsize() >= self.max_queue:
                self.rejected += 1
                raise BatcherOverloaded(
                    f"batch queue full ({self.max_queue} waiting)"
                )
            self._queue.put(item)
        item.event.wait()
        if item.error is not None:
            raise item.error
        return item.result

    def close(self) -> None:
        with self._submit_lock:
            if self._stopped:
                return
            self._stopped = True
            self._queue.put(None)
        self._thread.join(timeout=5.0)
        # items enqueued before the sentinel but unprocessed (the worker
        # returns when it sees None mid-collection): fail those waiters
        # instead of leaving them blocked. The lock above guarantees no new
        # item can land after this drain.
        drained_sentinel = False
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is None:
                drained_sentinel = True
            else:
                item.error = RuntimeError("batcher stopped")
                item.event.set()
        if drained_sentinel and self._thread.is_alive():
            # the join timed out with the worker mid-batch and the drain
            # consumed its stop sentinel — re-put it, or the worker would
            # finish its batch and park forever on queue.get(), pinning the
            # model in memory
            self._queue.put(None)

    # ------------------------------------------------------------------ #
    def _worker(self) -> None:
        while True:
            first = self._queue.get()
            if first is None:
                return
            batch: List[_Pending] = [first]
            deadline = time.monotonic() + self.max_wait_s
            while len(batch) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    self._run_groups(batch)
                    return
                batch.append(nxt)
            self._run_groups(batch)

    def _run_groups(self, batch: List[_Pending]) -> None:
        # group by (kind, item shape): only identical shapes can stack, and
        # each group maps to one static-shape device call
        groups: Dict[Tuple[str, Tuple[int, ...]], List[_Pending]] = {}
        for item in batch:
            groups.setdefault((item.kind, item.payload.shape), []).append(item)
        for (kind, _shape), items in groups.items():
            try:
                stacked = np.stack([it.payload for it in items])
                results = self._runner(kind, stacked)
                self.batch_calls += 1
                self.items_served += len(items)
                for it, res in zip(items, results):
                    it.result = res
                    it.event.set()
            except BaseException as e:  # noqa: BLE001 — delivered per item
                for it in items:
                    it.error = e
                    it.event.set()


# --------------------------------------------------------------------------- #
# Model runners
# --------------------------------------------------------------------------- #
class VAEServer:
    """Owns the wrapper, the batcher, and the HTTP server."""

    def __init__(
        self,
        wrapper,
        resolution: int = 256,
        max_batch: int = 8,
        max_wait_ms: float = 10.0,
        host: str = "127.0.0.1",
        port: int = 8400,
        max_queue: int = 64,
        max_body_bytes: int = 32 << 20,
        read_timeout_s: float = 30.0,
        use_mesh: Optional[bool] = None,
        replicas: Optional[Sequence[Any]] = None,
    ):
        self.wrapper = wrapper
        # the wrappers each batch is split over, ``wrapper`` first; given
        # explicitly (the tests' CPU replicas), ``use_mesh`` is not read
        self.replicas = (list(replicas) if replicas is not None
                         else serving_replicas(wrapper, use_mesh))
        n_rep = len(self.replicas)
        max_batch = -(-max(1, int(max_batch)) // n_rep) * n_rep
        self.resolution = int(resolution)
        self.max_body_bytes = int(max_body_bytes)
        self.read_timeout_s = float(read_timeout_s)
        # the one latent shape /decode serves, as every endpoint serves one
        # shape
        latent_shape = getattr(wrapper, "latent_shape", None)
        if latent_shape is not None:
            # an exported wrapper carries its geometry in its manifest
            self.latent_shape = tuple(int(v) for v in latent_shape)
        else:
            cfg = wrapper.config
            down = 2 ** (len(cfg.block_out_channels) - 1)
            self.latent_shape = (
                self.resolution // down, self.resolution // down,
                int(cfg.latent_channels),
            )
        # the image transform needs Pillow: it is built on the first
        # image-bytes request, so a host without Pillow still serves the
        # .npy paths
        self._transform = None
        self.platform = wrapper.device.type
        self.started = time.time()
        self.requests = 0
        self.errors = 0
        self._inflight = 0
        self._latencies: List[float] = []
        self._lock = threading.Lock()
        self._sample_calls = 0

        class _Server(ThreadingHTTPServer):
            # the stdlib default accept backlog of 5 drops connections the
            # moment concurrency exceeds single digits
            request_queue_size = 128
            daemon_threads = True

        self.batcher = MicroBatcher(
            self._run, max_batch, max_wait_ms, max_queue=max_queue
        )
        try:
            self.httpd = _Server((host, port), self._make_handler())
        except BaseException:
            # a failed bind leaves the caller no server to shutdown()
            self.batcher.close()
            raise

    # ------------------------------------------------------------------ #
    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def transform(self, body: bytes) -> np.ndarray:
        with self._lock:
            if self._transform is None:
                from .data.pipeline import get_transform

                self._transform = get_transform(self.resolution)
        return self._transform(body)

    def serve_forever(self) -> None:
        logger.info(
            "Serving on %s:%d (%s x %d, res=%d, max_batch=%d)",
            self.httpd.server_address[0], self.port, self.platform, len(self.replicas),
            self.resolution, self.batcher.max_batch,
        )
        self.httpd.serve_forever()

    def shutdown(self) -> None:
        """Fast stop (tests, embedded teardown): close the listener and
        fail whatever is still queued."""
        if getattr(self, "_shut", False):
            return
        self._shut = True
        self.httpd.shutdown()
        self.httpd.server_close()
        self.batcher.close()

    def graceful_shutdown(self, timeout: float = 30.0) -> None:
        """Drain-and-exit on SIGTERM: stop accepting new connections, answer
        every request already accepted or queued (the batcher sentinel lands
        behind all accepted items; late arrivals shed 503 + Retry-After),
        wait for the in-flight handler threads to finish writing, then
        release the port. Idempotent, and safe to call from a
        signal-handler thread."""
        if getattr(self, "_shut", False):
            return
        self._shut = True
        with self._lock:
            queued = self.batcher._queue.qsize()
            inflight = self._inflight
        logger.info(
            "Graceful shutdown: %d in-flight request(s), %d queued — "
            "draining.", inflight, queued,
        )
        self.httpd.shutdown()  # stop the accept loop; handlers keep running
        self.batcher.close()   # answers everything queued, then stops
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if self._inflight == 0:
                    break
            time.sleep(0.02)
        self.httpd.server_close()
        logger.info(
            "Graceful shutdown complete: %d request(s) served in total.",
            self.requests,
        )

    def warmup(self) -> None:
        """Run every endpoint once before traffic, so the first user request
        does not pay the one-time costs (kernel build, cuDNN algorithm
        choice, allocator growth)."""
        dummy = np.zeros((self.resolution, self.resolution, 3), np.float32)
        t0 = time.time()
        z = self.batcher.submit("encode", dummy)
        self.batcher.submit("decode", z)
        self.batcher.submit("reconstruct", dummy)
        # wrappers that refuse sampling (exported artifacts) skip these
        try:
            self.batcher.submit("encode@sample", dummy)
            self.batcher.submit("reconstruct@sample", dummy)
        except ValueError as e:
            logger.info("Sampling endpoints not warmed (%s)", e)
        logger.info("Warmup done in %.1fs", time.time() - t0)

    # ------------------------------------------------------------------ #
    def _pad(self, x: np.ndarray) -> Tuple[np.ndarray, int]:
        n = x.shape[0]
        target = self.batcher.max_batch
        if n < target:
            pad = np.zeros((target - n,) + x.shape[1:], x.dtype)
            x = np.concatenate([x, pad], axis=0)
        return x, n

    def _run(self, kind: str, stacked: np.ndarray) -> np.ndarray:
        """Batcher callback: one padded device call per group, split into
        one contiguous block a replica."""
        deterministic = not kind.endswith("@sample")
        op = kind.split("@", 1)[0]
        if op not in ("encode", "decode", "reconstruct"):
            raise ValueError(f"unknown op {op!r}")
        padded, n = self._pad(stacked.astype(np.float32))
        seed = None
        if not deterministic:
            # fresh seed per device call: the wrapper's generator=None
            # fallback is a FIXED seed, which would make every 'sampling'
            # request return the identical latent/reconstruction
            with self._lock:
                self._sample_calls += 1
                seed = self._sample_calls
        blocks = np.split(padded, len(self.replicas))
        # every block on its card before any launch, every launch before
        # any result is read: the cards run together
        xs = [torch.from_numpy(b).to(w.device, non_blocking=True)
              for b, w in zip(blocks, self.replicas)]
        ys = [_call(w, op, x, deterministic,
                    None if seed is None else
                    torch.Generator(device=w.device).manual_seed(seed * len(xs) + i))
              for i, (w, x) in enumerate(zip(self.replicas, xs))]
        # slice each block's padding off on its device before the copy to
        # the host
        outs, off = [], 0
        for x, y in zip(xs, ys):
            keep = max(0, min(x.shape[0], n - off))
            off += x.shape[0]
            if keep:
                outs.append(y[:keep].float().cpu().numpy())
        return outs[0] if len(outs) == 1 else np.concatenate(outs)

    # ------------------------------------------------------------------ #
    def _record(self, dt: float, ok: bool) -> None:
        with self._lock:
            self.requests += 1
            if not ok:
                self.errors += 1
            self._latencies.append(dt)
            if len(self._latencies) > 4096:
                self._latencies = self._latencies[-2048:]

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            lat = sorted(self._latencies)
            requests, errors = self.requests, self.errors

        def pct(p: float) -> Optional[float]:
            if not lat:
                return None
            return round(lat[min(len(lat) - 1, int(p * len(lat)))] * 1e3, 2)

        return {
            "requests": requests,
            "errors": errors,
            "uptime_s": round(time.time() - self.started, 1),
            "latency_ms_p50": pct(0.50),
            "latency_ms_p95": pct(0.95),
            "batch_calls": self.batcher.batch_calls,
            "items_batched": self.batcher.items_served,
            "batching_ratio": round(
                self.batcher.items_served / max(1, self.batcher.batch_calls), 3
            ),
            "rejected_overload": self.batcher.rejected,
            "max_queue": self.batcher.max_queue,
            "platform": self.platform,
            "resolution": self.resolution,
        }

    # ------------------------------------------------------------------ #
    def _make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # socketserver applies this as the connection socket timeout: a
            # client that stalls mid-body cannot pin a handler thread forever
            timeout = server.read_timeout_s

            def log_message(self, fmt, *args):  # route through logging
                logger.debug("http: " + fmt, *args)

            def _send(self, code: int, body: bytes, ctype: str,
                      headers: Optional[Dict[str, str]] = None) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _send_json(self, code: int, obj: Dict[str, Any]) -> None:
                self._send(
                    code, json.dumps(obj).encode(), "application/json"
                )

            def do_GET(self):
                path = urlparse(self.path).path
                if path == "/healthz":
                    self._send_json(200, {
                        "status": "ok",
                        "platform": server.platform,
                        "resolution": server.resolution,
                        "scaling_factor": server.wrapper.scaling_factor,
                        "max_batch": server.batcher.max_batch,
                        "replicas": len(server.replicas),
                    })
                elif path == "/stats":
                    self._send_json(200, server.stats())
                else:
                    self._send_json(404, {"error": f"no route {path}"})

            def do_POST(self):
                # in-flight census for graceful_shutdown: the drain waits
                # for handlers that already hold a connection to finish
                with server._lock:
                    server._inflight += 1
                try:
                    self._do_post()
                finally:
                    with server._lock:
                        server._inflight -= 1

            def _do_post(self):
                t0 = time.perf_counter()
                parsed = urlparse(self.path)
                op = parsed.path.lstrip("/")
                q = parse_qs(parsed.query)
                deterministic = (
                    q.get("deterministic", ["true"])[0].lower() != "false"
                )
                fmt = q.get("format", ["png"])[0].lower()
                ok = False
                try:
                    try:
                        length = int(self.headers.get("Content-Length", 0))
                    except (TypeError, ValueError):
                        self._send_json(
                            400, {"error": "invalid Content-Length"}
                        )
                        return
                    if length < 0:
                        self._send_json(
                            400, {"error": "invalid Content-Length"}
                        )
                        return
                    if length > server.max_body_bytes:
                        # reject BEFORE reading; close the connection — the
                        # unread body would otherwise be parsed as the next
                        # keep-alive request
                        self.close_connection = True
                        self._send_json(413, {
                            "error": f"body {length} bytes exceeds limit "
                                     f"{server.max_body_bytes}"
                        })
                        return
                    body = self.rfile.read(length)
                    if op in ("reconstruct", "encode"):
                        if body[:6] == b"\x93NUMPY":
                            pixels = np.load(io.BytesIO(body))
                            if pixels.shape != (
                                server.resolution, server.resolution, 3
                            ):
                                raise ValueError(
                                    f"npy pixels must be "
                                    f"({server.resolution}, "
                                    f"{server.resolution}, 3), "
                                    f"got {pixels.shape}"
                                )
                            pixels = pixels.astype(np.float32)
                        else:
                            pixels = server.transform(body)
                        kind = op if deterministic else op + "@sample"
                        out = server.batcher.submit(kind, pixels)
                        if op == "encode":
                            buf = io.BytesIO()
                            np.save(buf, out)
                            self._send(
                                200, buf.getvalue(),
                                "application/octet-stream",
                                {"X-VCD-Latent-Shape": str(out.shape)},
                            )
                        elif fmt == "npy":
                            buf = io.BytesIO()
                            np.save(buf, out)
                            self._send(
                                200, buf.getvalue(),
                                "application/octet-stream",
                            )
                        else:
                            mse = float(np.mean((out - pixels) ** 2))
                            self._send(
                                200, _to_png(out), "image/png",
                                {"X-VCD-MSE": f"{mse:.6f}"},
                            )
                    elif op == "decode":
                        z = np.load(io.BytesIO(body))
                        if z.ndim == 4:
                            if z.shape[0] != 1:
                                # silently decoding z[0] would drop the
                                # rest of the batch while returning 200
                                raise ValueError(
                                    f"/decode serves ONE latent per "
                                    f"request (got a batch of "
                                    f"{z.shape[0]}); send each latent "
                                    "separately — the micro-batcher "
                                    "coalesces concurrent requests"
                                )
                            z = z[0]
                        if tuple(z.shape) != server.latent_shape:
                            raise ValueError(
                                f"latents must be {server.latent_shape} "
                                f"(resolution {server.resolution}), "
                                f"got {tuple(z.shape)}"
                            )
                        out = server.batcher.submit("decode", z)
                        self._send(200, _to_png(out), "image/png")
                    else:
                        self._send_json(404, {"error": f"no route /{op}"})
                        return
                    ok = True
                except BatcherOverloaded as e:
                    self._send(
                        503,
                        json.dumps({"error": str(e)}).encode(),
                        "application/json",
                        {"Retry-After": "1"},
                    )
                except Exception as e:  # noqa: BLE001 — client gets the cause
                    logger.exception("request failed")
                    self._send_json(400, {
                        "error": f"{type(e).__name__}: {e}"
                    })
                finally:
                    server._record(time.perf_counter() - t0, ok)

        return Handler


def serving_replicas(wrapper, use_mesh: Optional[bool]) -> List[Any]:
    """The wrappers the server splits each batch over: ``wrapper`` alone, or
    it and one replica on each further visible card (``use_mesh`` None:
    wherever more than one card is visible and the wrapper can be
    replicated)."""
    if not getattr(wrapper, "supports_mesh", True):
        if use_mesh:
            raise ValueError(
                "use_mesh=True is incompatible with this wrapper (exported programs "
                "run pinned to one device; serve the live model across cards)")
        return [wrapper]
    device = wrapper.device
    if use_mesh is False or device.type != "cuda":
        return [wrapper]
    first = device.index or 0
    count = torch.cuda.device_count()
    others = [torch.device("cuda", (first + i) % count) for i in range(1, count)]
    return [wrapper] + [wrapper.replicate(d) for d in others]


def _call(wrapper, op: str, x: torch.Tensor, deterministic: bool,
          generator: Optional[torch.Generator]) -> torch.Tensor:
    """One replica's part of a batch, launched and not waited for."""
    if op == "encode":
        return wrapper.encode(x, deterministic=deterministic, generator=generator)
    if op == "decode":
        return wrapper.decode(x)
    if wrapper.use_tiling or wrapper.use_slicing:
        # tiling and slicing live on encode/decode: the same deterministic
        # math as forward(), plus decode's [-1, 1] clamp
        return wrapper.decode(wrapper.encode(x, deterministic=deterministic,
                                             generator=generator))
    return wrapper.forward(x, sample_posterior=not deterministic,
                           generator=generator)["reconstruction"]


def _to_png(arr_hwc: np.ndarray) -> bytes:
    from PIL import Image

    img = np.clip((arr_hwc + 1.0) / 2.0, 0.0, 1.0)
    buf = io.BytesIO()
    Image.fromarray((img * 255).astype(np.uint8)).save(buf, "PNG")
    return buf.getvalue()


# --------------------------------------------------------------------------- #
def parse_args(argv=None):
    p = argparse.ArgumentParser(description="VAE serving daemon (PyTorch).")
    p.add_argument("--checkpoint_path", required=True,
                   help="Dir containing the 'vae' subdirectory (or a model dir).")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8400)
    p.add_argument("--resolution", type=int, default=256)
    p.add_argument("--max_batch", type=int, default=8)
    p.add_argument("--max_wait_ms", type=float, default=10.0)
    p.add_argument("--max_queue", type=int, default=64,
                   help="Max waiting requests before shedding with 503.")
    p.add_argument("--max_body_mb", type=float, default=32.0,
                   help="Request bodies above this get HTTP 413.")
    p.add_argument("--read_timeout_s", type=float, default=30.0,
                   help="Socket read timeout per connection.")
    p.add_argument("--no_warmup", action="store_true",
                   help="Skip running the endpoints before accepting traffic.")
    p.add_argument("--attention_impl", default="auto",
                   choices=["auto", "naive", "chunked", "flash"],
                   help="Mid-block attention: auto takes the flash kernel "
                        "from 4096 tokens (512px) up when it fits the shape, "
                        "naive below; chunked is online softmax over key "
                        "chunks in plain PyTorch.")
    p.add_argument("--tile_size", type=int, default=0,
                   help="Enable tiled inference with this pixel tile size "
                        "(wrapper.enable_tiling): endpoint activation memory "
                        "scales with the tile, so a high --resolution daemon "
                        "fits on the card. 0 = off.")
    p.add_argument("--tile_overlap", type=float, default=0.25,
                   help="Tile overlap fraction for seam blending.")
    p.add_argument("--slicing", action="store_true",
                   help="Process one image per device pass "
                        "(wrapper.enable_slicing): batched endpoints at "
                        "single-sample activation cost.")
    p.add_argument("--exported_dir", default=None,
                   help="Serve the torch.export programs in this export dir "
                        "(tools/export_model.py) instead of the live model: "
                        "deterministic-only; the resolution comes from the "
                        "manifest; weights still load from --checkpoint_path.")
    p.add_argument("--device", default="cuda",
                   help="Torch device to serve on; 'cuda' fails when no GPU "
                        "is visible (pass 'cpu' to run on the CPU).")
    return p.parse_args(argv)


class ExportedServingRefused(ValueError):
    """``--exported_dir`` with an option only the live model has."""


def build_server(args) -> VAEServer:
    """Load the model dir named by ``args`` and build the server ``main``
    runs: bf16 compute, the serving attention policy (at the tile size when
    tiling), tiling and slicing as asked, the batcher; or, with
    ``--exported_dir``, the exported programs at their manifest's
    resolution."""
    vae_dir = os.path.join(args.checkpoint_path, "vae")
    if not os.path.isdir(vae_dir):
        vae_dir = args.checkpoint_path
    config, state_dict = model_io.load_model_dir(vae_dir)
    resolution = args.resolution
    if args.exported_dir:
        from .tools.export_model import ExportedVAEWrapper

        if args.tile_size or args.slicing:
            raise ExportedServingRefused(
                "--tile_size/--slicing require the live model: exported "
                "programs run their pinned untiled graphs. Re-export or "
                "serve via --checkpoint_path alone."
            )
        wrapper = ExportedVAEWrapper(args.exported_dir, state_dict, device=args.device)
        if wrapper.resolution != args.resolution:
            logger.info("Serving at the artifact's resolution %d (manifest), "
                        "not --resolution %d.", wrapper.resolution, args.resolution)
        resolution = wrapper.resolution
    else:
        attn_impl = resolve_serving_attention_impl(
            args.attention_impl, args.tile_size or args.resolution, config, logger=logger,
        )
        wrapper = SDXLVAEWrapper(
            config=config, state_dict=state_dict, dtype=torch.bfloat16,
            attn_impl=attn_impl, device=args.device,
        )
        if args.tile_size:
            wrapper.enable_tiling(args.tile_size, args.tile_overlap)
        if args.slicing:
            wrapper.enable_slicing()
    return VAEServer(
        wrapper,
        resolution=resolution,
        max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms,
        host=args.host,
        port=args.port,
        max_queue=args.max_queue,
        max_body_bytes=int(args.max_body_mb * (1 << 20)),
        read_timeout_s=args.read_timeout_s,
    )


def main(argv=None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    args = parse_args(argv)
    try:
        server = build_server(args)
    except ExportedServingRefused as e:
        logger.error("%s", e)
        return 2
    import signal

    graceful_threads: list = []

    def _graceful(signum, _frame):
        logger.info("Signal %d: draining and shutting down.", signum)
        t = threading.Thread(target=server.graceful_shutdown, daemon=True)
        graceful_threads.append(t)
        t.start()

    try:
        signal.signal(signal.SIGTERM, _graceful)
    except ValueError:
        pass
    try:
        if not args.no_warmup:
            server.warmup()
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        # serve_forever returns the moment graceful_shutdown stops the
        # accept loop; join the drain before interpreter teardown kills the
        # daemon threads mid-response
        for t in graceful_threads:
            t.join(timeout=90.0)
        server.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
