#!/usr/bin/env python
"""Host-side cost of the lazy graph build + executor dispatch.

Analog of the reference's ``benchmark_CPUandGPU_cvGS_vs_fk.cu:116-184`` which
proves the cvGS wrapper's CPU cost ≈ raw FKL's (graph build is free). Here
the contract is: building the op graph, flattening it, and hitting the jit
cache must cost microseconds per call — frames/rects/scalar changes never
retrace. The frame is already on the device, so no upload is counted; the
dispatch loop does not wait for the device, and one ``block_until_ready``
closes it. Prints the card's name and power limit first.

Usage: python benchmarks/host_overhead.py
"""

import os
import sys
import time

import jax
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import cvgpuspeedup_tpu as cvgs  # noqa: E402
from cvgpuspeedup_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402
from cvgpuspeedup_tpu.utils.profiling import require_gpu  # noqa: E402


def main():
    header = require_gpu()
    enable_compile_cache()
    print(header, flush=True)

    rng = np.random.default_rng(0)
    frame = jax.device_put(rng.integers(0, 256, (2160, 3840, 3), dtype=np.uint8))
    rects = np.array([[i, i, 60, 120] for i in range(50)], np.int32)

    def ops(shift=0):
        return (
            cvgs.resize_batch(frame, rects=rects + shift, dsize=cvgs.Size(64, 128)),
            cvgs.convert_to(np.float32, alpha=0.3),
            cvgs.subtract((3.2, 0.6, 11.8)),
            cvgs.divide((128.0,) * 3),
            cvgs.split_tensor(),
        )

    cvgs.execute_operations(*ops()).block_until_ready()  # compile once

    n = 200
    t0 = time.perf_counter()
    for i in range(n):
        out = cvgs.execute_operations(*ops(i % 3))
    dispatch_us = (time.perf_counter() - t0) / n * 1e6
    out.block_until_ready()

    t0 = time.perf_counter()
    for _ in range(n):
        cvgs.build_pipeline(*ops())
    graph_us = (time.perf_counter() - t0) / n * 1e6

    print(f"graph build only: {graph_us:.1f} us/call", flush=True)
    print(f"build + dispatch (cache hit, no wait): {dispatch_us:.1f} us/call",
          flush=True)


if __name__ == "__main__":
    main()
