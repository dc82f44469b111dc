"""Benchmark-protocol utilities (reference testsCommon.cuh analog)."""

import csv
import subprocess

import jax
import jax.numpy as jnp
import pytest

from cvgpuspeedup_tpu.utils import profiling
from cvgpuspeedup_tpu.utils.profiling import (
    BenchmarkRecorder,
    TimingStats,
    time_fn,
    trace_device_events,
    trace_scope,
)


def test_time_fn_protocol():
    calls = []

    def fn():
        calls.append(1)
        return jnp.ones((4, 4))

    stats = time_fn(fn, iters=5, warmup=2)
    assert stats.iters == 5 and len(calls) == 7
    assert stats.min <= stats.median <= stats.max
    assert stats.min <= stats.mean <= stats.max
    assert stats.median <= stats.p90 <= stats.max


def test_trace_scope_runs():
    with trace_scope("unit-test-range"):
        x = jnp.ones((2, 2)) * 2
    assert float(x[0, 0]) == 2.0


_TRACE = """
planes {
  id: 1
  name: "/device:GPU:0"
  lines {
    id: 1
    name: "Stream #13(compute)"
    events { metadata_id: 1 offset_ps: 0 duration_ps: 5000000 }
    events { metadata_id: 2 offset_ps: 6000000 duration_ps: 2000000 }
    events { metadata_id: 1 offset_ps: 9000000 duration_ps: 3000000 }
  }
  lines {
    id: 2
    name: "XLA Ops"
    events { metadata_id: 1 offset_ps: 0 duration_ps: 5000000 }
  }
  event_metadata { key: 1 value { id: 1 name: "loop_fusion" } }
  event_metadata { key: 2 value { id: 2 name: "MemcpyH2D" } }
}
planes {
  id: 2
  name: "/host:CPU"
  lines {
    id: 1
    name: "python"
    events { metadata_id: 1 offset_ps: 0 duration_ps: 9000000 }
  }
  event_metadata { key: 1 value { id: 1 name: "execute" } }
}
"""


def test_trace_device_events_counts_streams_only():
    """Per-stream events of the device plane, by name; the summary line and
    the host plane do not count."""
    data = jax.profiler.ProfileData.from_text_proto(_TRACE)
    events = trace_device_events(data)
    assert events == {"loop_fusion": [5000.0, 3000.0], "MemcpyH2D": [2000.0]}
    assert trace_device_events(data, device="/device:GPU:1") == {}


def test_card_description_without_nvidia_smi(monkeypatch):
    def missing(*a, **k):
        raise FileNotFoundError("nvidia-smi")

    monkeypatch.setattr(subprocess, "run", missing)
    assert profiling.card_description() == "not an NVIDIA card"


def test_benchmark_recorder_csv(tmp_path):
    path = str(tmp_path / "bench.csv")
    rec = BenchmarkRecorder(path)
    base = TimingStats.from_samples([2.0, 1.9, 2.1])
    fused = TimingStats.from_samples([0.5, 0.4, 0.6])
    rec.add_case("batch50", base, fused)
    rec.write()
    with open(path) as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 1
    assert float(rows[0]["mean_speedup"]) == pytest.approx(4.0)
    assert rows[0]["case"] == "batch50"
