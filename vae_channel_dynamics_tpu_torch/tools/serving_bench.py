"""Load-test a running serving daemon (``server.py``) with sustained
closed-loop clients. The port of ``vae_channel_dynamics_tpu/tools/serving_bench.py``.

``python -m vae_channel_dynamics_tpu_torch.tools.serving_bench
--url http://127.0.0.1:8400 [--streams 32] [--duration_s 20]
[--resolution 256] [--op reconstruct]``

Each stream issues back-to-back requests (closed loop, the npy fast path)
for ``duration_s``; 503 responses are counted and retried after the
server's Retry-After, the intended client behaviour against the daemon's
load shedding. Prints one JSON line: ok-req/s, latency percentiles (client
clock), the shed count, and the server's own /stats deltas. Exits nonzero
when a request failed otherwise.
"""

from __future__ import annotations

import argparse
import io
import json
import sys
import threading
import time
import urllib.error
import urllib.request
from typing import Any, Dict

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Serving daemon load test.")
    p.add_argument("--url", default="http://127.0.0.1:8400")
    p.add_argument("--streams", type=int, default=32)
    p.add_argument("--duration_s", type=float, default=20.0)
    p.add_argument("--resolution", type=int, default=256)
    p.add_argument("--op", default="reconstruct", choices=["reconstruct", "encode"])
    p.add_argument("--timeout_s", type=float, default=120.0)
    return p.parse_args(argv)


def _get_stats(url: str, timeout: float) -> Dict[str, Any]:
    with urllib.request.urlopen(f"{url}/stats", timeout=timeout) as r:
        return json.loads(r.read())


def run(url: str, streams: int = 32, duration_s: float = 20.0, resolution: int = 256,
        op: str = "reconstruct", timeout_s: float = 120.0) -> Dict[str, Any]:
    """The load test; returns the result line's dict."""
    pixels = np.random.default_rng(0).uniform(-1, 1, (resolution, resolution, 3))
    buf = io.BytesIO()
    np.save(buf, pixels.astype(np.float32))
    body = buf.getvalue()
    endpoint = f"{url}/{op}?format=npy"

    lock = threading.Lock()
    latencies: list = []
    counts = {"ok": 0, "shed": 0, "errors": 0}
    stop_at = time.monotonic() + duration_s

    def count(key: str) -> None:
        with lock:
            counts[key] += 1

    def stream() -> None:
        while time.monotonic() < stop_at:
            t0 = time.perf_counter()
            req = urllib.request.Request(endpoint, data=body, method="POST")
            try:
                with urllib.request.urlopen(req, timeout=timeout_s) as resp:
                    resp.read()
                with lock:
                    counts["ok"] += 1
                    latencies.append(time.perf_counter() - t0)
            except urllib.error.HTTPError as e:
                if e.code == 503:
                    count("shed")
                    time.sleep(float(e.headers.get("Retry-After", 1)))
                else:
                    count("errors")
            except Exception:  # noqa: BLE001 — counted, keep the load on
                count("errors")

    before = _get_stats(url, timeout_s)
    threads = [threading.Thread(target=stream, daemon=True) for _ in range(streams)]
    t_start = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=duration_s + timeout_s)
    elapsed = time.monotonic() - t_start
    after = _get_stats(url, timeout_s)
    latencies.sort()

    def pct(p: float):
        if not latencies:
            return None
        return round(latencies[min(len(latencies) - 1, int(p * len(latencies)))] * 1e3, 1)

    calls = after["batch_calls"] - before["batch_calls"]
    return {
        "metric": f"serving_{op}_ok_req_per_sec@{resolution}px",
        "value": round(counts["ok"] / elapsed, 2),
        "unit": "req/s",
        "streams": streams,
        "duration_s": round(elapsed, 1),
        "ok": counts["ok"],
        "shed_503": counts["shed"],
        "errors": counts["errors"],
        "latency_ms_p50": pct(0.50),
        "latency_ms_p95": pct(0.95),
        "latency_ms_p99": pct(0.99),
        "server_batch_calls": calls,
        "server_batching_ratio": round(
            (after["items_batched"] - before["items_batched"]) / max(1, calls), 2),
        "server_rejected_overload": (after.get("rejected_overload", 0)
                                     - before.get("rejected_overload", 0)),
    }


def main(argv=None) -> int:
    args = parse_args(argv)
    result = run(args.url, args.streams, args.duration_s, args.resolution, args.op,
                 args.timeout_s)
    print(json.dumps(result))
    return 0 if result["errors"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
