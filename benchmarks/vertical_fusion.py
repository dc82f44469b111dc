#!/usr/bin/env python
"""Vertical-fusion stress benchmark — the MAD-loop family.

Reference analog: ``benchmarks/benchmark_image_resolution_MAD_loop.cu:24-128``
and the ``benchmarks/verticalfusion/`` kernel-instance family: N fused
multiply/add ops applied between ONE read and ONE write, swept over image
resolutions, vs launching one device program per op (the per-op pattern) —
the 2x-10000x speedup axis of the reference (``README.md:140``).

The fused chain is a single XLA program (XLA fuses the unrolled StaticLoop
chain into one kernel); the per-op baseline dispatches one jitted program
per MAD step. Both are timed with ``block_until_ready``; the fused chain's
device time per call comes from a profiler trace. Prints the card's name
and power limit first.

Usage: python benchmarks/vertical_fusion.py [--ops 200] [--iters 20] [--csv PATH]
"""

import argparse
import os
import sys

import jax
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import cvgpuspeedup_tpu as cvgs  # noqa: E402
from cvgpuspeedup_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402
from cvgpuspeedup_tpu.utils.profiling import (BenchmarkRecorder, device_time,  # noqa: E402
                                              require_gpu, time_fn)

# resolution sweep: edge sizes (reference sweeps 100 -> ~17M elements)
RESOLUTIONS = [128, 512, 1024, 2048, 4096]


def fused_chain(n_ops):
    mad = cvgs.fuse(cvgs.multiply(1.0009), cvgs.add(0.0001))
    assert n_ops % 20 == 0
    # nested StaticLoop exactly like the reference's
    # StaticLoop<StaticLoop<MAD, k>, N/k> (vertical_fusion_static_loop.cuh:33-46)
    return cvgs.static_loop(cvgs.static_loop(mad, 10), n_ops // 2 // 10)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ops", type=int, default=200)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--csv", default=None, help="write the CSV rows here")
    args = ap.parse_args()

    header = require_gpu()
    enable_compile_cache()
    print(header, flush=True)

    chain = fused_chain(args.ops)
    mul = jax.jit(lambda x: x * np.float32(1.0009))
    add = jax.jit(lambda x: x + np.float32(0.0001))

    def per_op(x):
        for _ in range(args.ops // 2):
            x = add(mul(x))
        return x

    rec = BenchmarkRecorder(args.csv or os.devnull)
    for edge in RESOLUTIONS:
        img = jax.device_put(np.linspace(0, 1, edge * edge, dtype=np.float32)
                             .reshape(edge, edge, 1))
        fused = lambda: cvgs.execute_operations(cvgs.image(img), chain)
        t_fused = time_fn(fused, iters=args.iters)
        t_perop = time_fn(lambda: per_op(img), iters=max(3, args.iters // 5))
        dt = device_time(fused, iters=5)
        rec.add_case(f"{edge}x{edge}_{args.ops}ops", t_perop, t_fused)
        print(f"{edge:5}x{edge:<5} fused median {t_fused.median * 1e6:9.1f} us "
              f"(device {dt['total'] * 1e6:9.1f} us) | per-op median "
              f"{t_perop.median * 1e6:9.1f} us | speedup "
              f"{t_perop.median / t_fused.median:8.1f}x", flush=True)
    if args.csv:
        rec.write()


if __name__ == "__main__":
    main()
