#!/usr/bin/env python
"""Multi-device scaling benchmark — images/s at 1..N shards + efficiency.

Each shard runs the SAME fused pipeline on its plane slice (embarrassingly
parallel); this script measures the flagship pipeline under
``parallel.mesh.execute_sharded`` at mesh sizes 1, 2, 4, ... up to the
device count and reports ``scaling_efficiency``. Every call ends in
``block_until_ready``. Prints the card's name and power limit first.

Usage: python benchmarks/scaling.py [--batch-per-device 16] [--iters 30]
"""

import argparse
import os
import sys

import jax
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import cvgpuspeedup_tpu as cvgs  # noqa: E402
from cvgpuspeedup_tpu.parallel import mesh as pmesh  # noqa: E402
from cvgpuspeedup_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402
from cvgpuspeedup_tpu.utils.profiling import require_gpu, time_fn  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch-per-device", type=int, default=16)
    ap.add_argument("--iters", type=int, default=30)
    args = ap.parse_args()

    header = require_gpu()
    enable_compile_cache()
    print(header, flush=True)

    rng = np.random.default_rng(0)
    frame = jax.device_put(rng.integers(0, 256, (1080, 1920, 3), dtype=np.uint8))
    n_dev = len(jax.devices())
    sizes = [s for s in (1, 2, 4, 8) if s <= n_dev]
    rates = {}
    for nsh in sizes:
        batch = args.batch_per_device * nsh
        rects = np.array([[i % 800, i % 800, 60, 120] for i in range(batch)],
                         np.int32)
        mesh = pmesh.make_mesh(nsh)
        run = lambda: pmesh.execute_sharded(
            cvgs.resize_batch(frame, rects=rects, dsize=cvgs.Size(64, 128)),
            cvgs.convert_to(np.float32, alpha=0.3),
            cvgs.subtract((3.2, 0.6, 11.8)),
            cvgs.divide((128.0,) * 3),
            cvgs.split_tensor(),
            mesh=mesh,
        )
        t = time_fn(run, iters=args.iters)
        rates[nsh] = batch / t.median
        eff = pmesh.scaling_efficiency(rates[nsh], rates[sizes[0]], nsh)
        print(f"shards={nsh}: {rates[nsh]:.0f} images/s (median "
              f"{t.median * 1e6:.1f} us per call, efficiency {eff * 100:.0f}%)",
              flush=True)


if __name__ == "__main__":
    main()
