"""Tracing / profiling / debug hooks (SURVEY.md §5 aux subsystems).

The reference has only epoch-time prints; here: jax.profiler trace context
(TensorBoard-compatible), a per-step timer with JSONL export, and a NaN-check
mode (jax_debug_nans) as the race/sanitizer equivalent for a functional
runtime.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import os
import time
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import jax


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a device trace viewable in TensorBoard/XProf."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def gpu_name_and_power_limit() -> List[str]:
    """One line per GPU, as ``nvidia-smi`` gives them: "name, power.limit".
    A card set below its maximum power runs slower under load, so every
    number measured on it is reported beside this line."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def busy_ns(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of (start, duration) intervals, in their unit."""
    total, end = 0.0, float("-inf")
    for start, dur in sorted(intervals):
        stop = start + dur
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total


def device_events(trace_dir: str, plane_prefix: str = "/device:GPU"):
    """(name, start_ns, duration_ns, stats) of every op on the device planes
    of the newest trace under ``trace_dir``: the events on each plane's
    ``Stream`` lines (kernels and copies)."""
    from jax.profiler import ProfileData

    paths = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                      recursive=True)
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {trace_dir}")
    data = ProfileData.from_file(max(paths, key=os.path.getmtime))
    for plane in data.planes:
        if not plane.name.startswith(plane_prefix):
            continue
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                yield ev.name, ev.start_ns, ev.duration_ns, dict(ev.stats)


def summarize_device_trace(trace_dir: str) -> Dict:
    """Device busy time of a trace (union of op intervals, ns) and the
    kernels that took the most time. Kernels replayed from a CUDA graph
    carry no op name, so a program's parts are timed by tracing them as
    programs of their own."""
    spans = []
    per_kernel: collections.Counter = collections.Counter()
    for name, start, dur, _ in device_events(trace_dir):
        spans.append((start, dur))
        per_kernel[name] += dur
    return {"busy_ns": busy_ns(spans),
            "top_kernels_ns": per_kernel.most_common(8)}


@contextlib.contextmanager
def debug_nans(enable: bool = True) -> Iterator[None]:
    """NaN-fail-fast mode (the functional runtime's sanitizer)."""
    prev = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", enable)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", prev)


class StepTimer:
    """Wall-clock step timing with blocking, JSONL-exportable."""

    def __init__(self, jsonl_path: Optional[str] = None):
        self.records: List[Dict] = []
        self.jsonl_path = jsonl_path

    @contextlib.contextmanager
    def step(self, name: str, **meta) -> Iterator[None]:
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        rec = {"name": name, "seconds": dt, **meta}
        self.records.append(rec)
        if self.jsonl_path:
            from bbbp.reporting.metrics_io import append_jsonl

            append_jsonl(self.jsonl_path, rec)

    def timed(self, name: str, fn, *args, block: bool = True, **meta):
        t0 = time.perf_counter()
        out = fn(*args)
        if block:
            out = jax.block_until_ready(out)
        dt = time.perf_counter() - t0
        rec = {"name": name, "seconds": dt, **meta}
        self.records.append(rec)
        if self.jsonl_path:
            from bbbp.reporting.metrics_io import append_jsonl

            append_jsonl(self.jsonl_path, rec)
        return out

    def summary(self) -> Dict[str, float]:
        out: Dict[str, List[float]] = {}
        for r in self.records:
            out.setdefault(r["name"], []).append(r["seconds"])
        return {k: sum(v) / len(v) for k, v in out.items()}
