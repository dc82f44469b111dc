"""Profiling and timing utilities.

Equivalents of the reference's observability layer:

- NVTX ranges (``tests/nvtx.h:18-105``) -> :func:`trace_scope` /
  :func:`mark`, backed by ``jax.profiler`` named traces.
- CUDA-event benchmark protocol (``tests/testsCommon.cuh:122-317``):
  warmup pass + N timed iterations, per-case statistics and mean speedup,
  written to CSV with one row per case — :class:`BenchmarkRecorder` +
  :func:`time_fn`.
- Device time per call from a ``jax.profiler`` trace: :func:`device_time`.
- The card a number was taken on: :func:`card_description`,
  :func:`require_gpu`.
"""

from __future__ import annotations

import contextlib
import csv
import glob
import math
import os
import subprocess
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Sequence

import jax
import numpy as np


@contextlib.contextmanager
def trace_scope(name: str):
    """Named profiler range (NVTX PUSH_RANGE/POP_RANGE analog)."""
    with jax.profiler.TraceAnnotation(name):
        yield


def mark(name: str) -> None:
    """Instantaneous annotation (CUDA_MARK analog)."""
    with jax.profiler.TraceAnnotation(name):
        pass


@dataclass
class TimingStats:
    mean: float
    variance: float
    min: float
    max: float
    median: float
    p90: float
    iters: int

    @classmethod
    def from_samples(cls, samples: Sequence[float]) -> "TimingStats":
        arr = np.asarray(samples, np.float64)
        return cls(
            mean=float(arr.mean()),
            variance=float(arr.var()),
            min=float(arr.min()),
            max=float(arr.max()),
            median=float(np.median(arr)),
            p90=float(np.percentile(arr, 90)),
            iters=len(samples),
        )


def time_fn(fn: Callable[[], object], iters: int = 100, warmup: int = 1) -> TimingStats:
    """Reference benchmark protocol: warmup + per-iteration wall timing,
    each iteration ending in ``block_until_ready`` on every output leaf."""
    for _ in range(warmup):
        jax.block_until_ready(fn())
    samples = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        samples.append(time.perf_counter() - t0)
    return TimingStats.from_samples(samples)


def trace_device_events(data, device: str = "/device:GPU:0") -> Dict[str, List[float]]:
    """Durations (ns) of the events on one device of a profiler trace
    (``jax.profiler.ProfileData``), by event name. Only the per-stream lines
    count, so an event that the profiler also lists on a summary line is not
    counted twice."""
    out: Dict[str, List[float]] = {}
    for plane in data.planes:
        if plane.name != device:
            continue
        lines = list(plane.lines)
        streams = [ln for ln in lines if ln.name.startswith("Stream")]
        for line in streams or lines:
            for ev in line.events:
                out.setdefault(ev.name, []).append(ev.duration_ns)
    return out


def device_time(fn: Callable[[], object], iters: int = 20) -> Dict[str, float]:
    """Seconds of device time per call of ``fn``, by device op name, from a
    ``jax.profiler`` trace of ``iters`` calls after one warm-up call.
    ``"total"`` is the sum over ops (the device's busy time per call)."""
    jax.block_until_ready(fn())
    with tempfile.TemporaryDirectory() as d:
        with jax.profiler.trace(d):
            for _ in range(iters):
                jax.block_until_ready(fn())
        paths = glob.glob(os.path.join(d, "**", "*.xplane.pb"), recursive=True)
        if not paths:
            raise RuntimeError("the profiler wrote no trace")
        events = trace_device_events(jax.profiler.ProfileData.from_file(paths[0]))
    per_call = {k: sum(v) * 1e-9 / iters for k, v in events.items()}
    per_call["total"] = sum(per_call.values())
    return per_call


def require_gpu() -> str:
    """The line that names the device a measurement runs on — the card's
    name and power limit, JAX's device kind and device count. Raises where
    JAX finds no GPU: a measurement never falls back to the CPU."""
    if jax.default_backend() != "gpu":
        raise SystemExit(f"no GPU: JAX runs on {jax.default_backend()!r}")
    devices = jax.devices()
    return (f"{card_description()} | {devices[0].device_kind} x "
            f"{len(devices)} | jax {jax.__version__}")


def card_description() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them, or
    ``"not an NVIDIA card"`` where there is none."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return "not an NVIDIA card"
    return res.stdout.strip().splitlines()[0]


@dataclass
class BenchmarkRecorder:
    """Per-case CSV writer matching the reference's column protocol
    (``tests/testsCommon.cuh:142-195``): one row per case with baseline and
    fused stats plus mean speedup."""

    path: str
    rows: List[Dict] = field(default_factory=list)

    def add_case(self, case: str, baseline: TimingStats, fused: TimingStats) -> None:
        self.rows.append({
            "case": case,
            "baseline_mean_s": baseline.mean,
            "baseline_var": baseline.variance,
            "baseline_max_s": baseline.max,
            "baseline_min_s": baseline.min,
            "fused_mean_s": fused.mean,
            "fused_var": fused.variance,
            "fused_max_s": fused.max,
            "fused_min_s": fused.min,
            "mean_speedup": baseline.mean / fused.mean if fused.mean else math.inf,
        })

    def write(self) -> None:
        if not self.rows:
            return
        with open(self.path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(self.rows[0].keys()))
            w.writeheader()
            w.writerows(self.rows)
