"""Summarize a Trainer's torch.profiler trace: device time, share and
launches per kernel family, the top kernels by self device time, and a rate
wherever the trace carries FLOPs for an op. The port of
``vae_channel_dynamics_tpu/tools/profile_summary.py``.

Usage:
    python -m vae_channel_dynamics_tpu_torch.tools.profile_summary \\
        --trace_dir results/<run>/profile [--top_n 15]

Pairs with the Trainer's ``profiling:`` config section
(``utils/profiling.py``), which writes a Chrome trace
(``*.pt.trace.json``) into that directory; the newest trace under it is
read. Device events are the trace's kernels, memcpys and memsets. A trace
of a CPU run has none: its device section says so, and its CPU ops are
listed under their own heading as host time.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import glob
import gzip
import json
import os
import sys
from typing import Any, Dict, Iterable, List, Optional, Tuple

# Kernel families by a lower-cased substring of the kernel's name, the first
# match wins: the port's hand-written kernels first, then the libraries'.
FAMILIES: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ("fused resnet kernels (#9-#11)", ("conv3x3_kernel", "conv3x3_dw_kernel",
                                       "conv3x3_nchw_kernel", "silu_nhwc_kernel",
                                       "sum_tiles_kernel", "conv3x3_f32_kernel",
                                       "conv3x3_nchw_f32_kernel", "conv3x3_dw_f32_kernel",
                                       "split_nhwc_f32_kernel", "nchw_f32_kernel")),
    ("flash attention kernels (flash_*)", ("flash_fwd", "flash_bwd")),
    ("GroupNorm kernels (gn_*)", ("gn_fwd_", "gn_bwd_", "sum_splits_kernel")),
    ("convolutions (cuDNN)", ("conv", "fprop", "dgrad", "wgrad", "implicit")),
    ("layout transposes", ("nchw", "nhwc", "transpose", "permute")),
    ("matmul (cuBLAS)", ("gemm", "cublas")),
    ("optimizer (foreach)", ("foreach", "multi_tensor")),
    ("reductions", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
    ("memcpy/memset", ("memcpy", "memset")),
)
OTHER = "other"
FUSED_RESNET = FAMILIES[0][0]
GROUPNORM = FAMILIES[2][0]
CUDNN_CONVS = FAMILIES[3][0]
# the trace's device-side event categories
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def family(name: str) -> str:
    """The family of a device event's name (``other`` when none matches)."""
    low = name.lower()
    return next((f for f, keys in FAMILIES if any(k in low for k in keys)), OTHER)


def find_trace(trace_dir: str) -> str:
    """The newest ``*.json`` or ``*.json.gz`` trace under ``trace_dir``."""
    matches = [p for pattern in ("*.json", "*.json.gz")
               for p in glob.glob(os.path.join(trace_dir, "**", pattern), recursive=True)]
    if not matches:
        raise FileNotFoundError(f"No *.json or *.json.gz trace under {trace_dir}")
    return max(matches, key=lambda p: (os.path.getmtime(p), p))


def load_trace(path: str) -> Dict[str, Any]:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


def _complete(events: Iterable[Dict[str, Any]], categories: Tuple[str, ...]):
    return [e for e in events if e.get("ph") == "X" and "dur" in e
            and e.get("cat") in categories]


def device_events(trace: Dict[str, Any]) -> List[Dict[str, Any]]:
    """The trace's device events (kernels, memcpys, memsets)."""
    return _complete(trace.get("traceEvents", []), DEVICE_CATEGORIES)


def _busy_us(events: List[Dict[str, Any]]) -> float:
    """The union of the events' intervals, us (streams may overlap)."""
    busy, end = 0.0, None
    for e in sorted(events, key=lambda e: e["ts"]):
        lo, hi = e["ts"], e["ts"] + e["dur"]
        if end is None or lo > end:
            busy += hi - lo
            end = hi
        elif hi > end:
            busy += hi - end
            end = hi
    return busy


def family_table(events: List[Dict[str, Any]]) -> List[Tuple[str, float, int]]:
    """[(family, device us, launches)], the largest first."""
    us: Dict[str, float] = collections.Counter()
    count: Dict[str, int] = collections.Counter()
    for e in events:
        fam = family(e["name"])
        us[fam] += e["dur"]
        count[fam] += 1
    return sorted(((f, us[f], count[f]) for f in us), key=lambda r: -r[1])


def top_kernels(events: List[Dict[str, Any]], n: int) -> List[Tuple[float, int, str]]:
    """[(self device us, launches, name)] of the ``n`` largest by time."""
    us: Dict[str, float] = collections.Counter()
    count: Dict[str, int] = collections.Counter()
    for e in events:
        us[e["name"]] += e["dur"]
        count[e["name"]] += 1
    return sorted(((us[k], count[k], k) for k in us), reverse=True)[:n]


def op_rates(trace: Dict[str, Any]) -> List[Tuple[str, float, float]]:
    """[(op, FLOPs, device us)] for every CPU op whose event carries
    ``flops``: its device time is that of the kernels launched while it ran
    on its thread (the runtime launches inside its interval, joined to the
    kernels by their correlation id)."""
    events = trace.get("traceEvents", [])
    kernels: Dict[Any, float] = collections.Counter()
    for e in device_events(trace):
        corr = (e.get("args") or {}).get("correlation")
        if corr is not None:
            kernels[corr] += e["dur"]
    launches: Dict[Any, List[Tuple[float, Any]]] = collections.defaultdict(list)
    for e in _complete(events, ("cuda_runtime", "cuda_driver")):
        launches[e["tid"]].append((e["ts"], (e.get("args") or {}).get("correlation")))
    for runs in launches.values():
        runs.sort(key=lambda r: r[0])
    starts = {tid: [ts for ts, _ in runs] for tid, runs in launches.items()}
    out = []
    for op in _complete(events, ("cpu_op",)):
        flops = float((op.get("args") or {}).get("flops", 0) or 0)
        if flops <= 0:
            continue
        runs, ts = launches.get(op["tid"], []), starts.get(op["tid"], [])
        lo = bisect.bisect_left(ts, op["ts"])
        hi = bisect.bisect_right(ts, op["ts"] + op["dur"])
        us = sum(kernels.get(corr, 0.0) for _, corr in runs[lo:hi])
        out.append((op["name"], flops, us))
    return out


def summarize(trace_dir: str, top_n: int = 15, path: Optional[str] = None) -> str:
    """The summary of the newest trace under ``trace_dir`` (or of ``path``)."""
    path = path or find_trace(trace_dir)
    trace = load_trace(path)
    events = trace.get("traceEvents", [])
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    window_us = (max(e["ts"] + e["dur"] for e in spans) - min(e["ts"] for e in spans)
                 if spans else 0.0)
    lines = [f"trace: {path}", f"window: {window_us / 1e3:.3f} ms", ""]
    device = device_events(trace)
    if not device:
        lines += ["device: no device events in this trace (a CPU run); the CPU ops "
                  "below are host time, not device time", ""]
    else:
        total = sum(e["dur"] for e in device)
        busy = _busy_us(device)
        lines += [
            f"device: {len(device)} events, {total / 1e3:.3f} ms of device time, busy "
            f"{busy / 1e3:.3f} ms ({100 * busy / window_us:.1f}% of the window)",
            "",
            f"{'family':36s} {'device ms':>10s} {'share %':>8s} {'launches':>9s}",
        ]
        for fam, us, n in family_table(device):
            lines.append(f"{fam:36s} {us / 1e3:10.3f} {100 * us / total:8.1f} {n:9d}")
        lines += ["", f"top {top_n} kernels by self device time:"]
        for us, n, name in top_kernels(device, top_n):
            lines.append(f"{us / 1e3:10.3f} ms x{n:<5d} {name[:110]}")
        rates = [r for r in op_rates(trace) if r[2] > 0]
        lines += ["", "rates of the ops that carry FLOPs (device time of their kernels):"]
        if not rates:
            lines.append("  none: no op in this trace carries FLOPs")
        by_op: Dict[str, List[float]] = {}
        for name, flops, us in rates:
            acc = by_op.setdefault(name, [0.0, 0.0, 0])
            acc[0] += flops
            acc[1] += us
            acc[2] += 1
        for name, (flops, us, n) in sorted(by_op.items(), key=lambda kv: -kv[1][1]):
            lines.append(f"{name:36s} x{n:<5d} {us / 1e3:10.3f} ms "
                         f"{flops / (us * 1e-6) / 1e12:9.2f} TFLOP/s")
    host: Dict[str, float] = collections.Counter()
    calls: Dict[str, int] = collections.Counter()
    for e in _complete(events, ("cpu_op",)):
        host[e["name"]] += e["dur"]
        calls[e["name"]] += 1
    lines += ["", f"top {top_n} CPU ops by host time (inclusive of the ops they call):"]
    if not host:
        lines.append("  none")
    for name, us in sorted(host.items(), key=lambda kv: -kv[1])[:top_n]:
        lines.append(f"{us / 1e3:10.3f} ms x{calls[name]:<5d} {name[:110]}")
    return "\n".join(lines)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Summarize a torch.profiler trace.")
    parser.add_argument("--trace_dir", required=True)
    parser.add_argument("--top_n", "--top", dest="top_n", type=int, default=15)
    args = parser.parse_args(argv)
    print(summarize(args.trace_dir, args.top_n))
    return 0


if __name__ == "__main__":
    sys.exit(main())
