#!/usr/bin/env python
"""Flagship benchmark: the reference's headline 50-crop pipeline on one GPU.

Pipeline (reference SURVEY.md §3.2, ``tests/batchresize/test_batchresize_x_
split3D.cu:311-324``): 3840x2160 uint8 frame -> 50 crops (60x120 at offset
(i, i); 30x120 letterboxed in the PRESERVE_AR row) -> bilinear resize to
64x128 -> convertTo(float, 0.3) -> subtract -> divide -> planar TensorSplit,
through ``pipelines.presets.detection_preprocessor`` as a user calls it.

For each aspect-ratio mode: the output is checked against the numpy
reference of ``chip_smoke.py`` (1e-4 per pixel), then timed with
``block_until_ready`` — end to end from a host frame (the upload included)
and with the frame already on the device — and the device time per call is
read from a profiler trace. The baseline is the same math issued as one
device program per op per crop — the 250-launch pattern cvGPUSpeedup
replaces (``README.md:90-98``).

Prints the card's name and power limit, then ONE JSON line:
{"metric", "value" (images/s end to end, IGNORE_AR), "unit",
"vs_baseline" (unfused time over fused time), "device", ...}.

Usage: python bench.py [--iters 200]
"""

import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np

import cvgpuspeedup_tpu as cvgs
from chip_smoke import (FLAGSHIP_ALPHA, FLAGSHIP_BG, FLAGSHIP_MEAN,
                        FLAGSHIP_SCALE, flagship_reference)
from cvgpuspeedup_tpu.pipelines.presets import detection_preprocessor
from cvgpuspeedup_tpu.utils.compile_cache import enable_compile_cache
from cvgpuspeedup_tpu.utils.profiling import device_time, require_gpu, time_fn

BATCH = 50
SRC_H, SRC_W = 2160, 3840
UP = cvgs.Size(64, 128)


def unfused_baseline(frame_dev, rects, iters):
    """The 5-programs-per-crop launch pattern (250 dispatches per batch)."""
    op_resize = jax.jit(lambda fr, rect: cvgs.execute_operations(
        cvgs.resize_batch(fr, rects=rect[None, :], dsize=UP)))
    op_convert = jax.jit(lambda t: t * np.float32(FLAGSHIP_ALPHA))
    op_sub = jax.jit(lambda t: t - jnp.asarray(FLAGSHIP_MEAN, jnp.float32))
    op_div = jax.jit(lambda t: t / jnp.asarray(FLAGSHIP_SCALE, jnp.float32))
    op_split = jax.jit(lambda t: jnp.transpose(t, (0, 3, 1, 2)))
    rects_dev = [jax.device_put(r) for r in rects]

    def one_batch():
        return [op_split(op_div(op_sub(op_convert(op_resize(frame_dev, r)))))
                for r in rects_dev]

    return time_fn(one_batch, iters=iters)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=200)
    args = ap.parse_args()

    header = require_gpu()
    enable_compile_cache()
    print(header, flush=True)

    rng = np.random.default_rng(42)
    frame = rng.integers(0, 256, (SRC_H, SRC_W, 3), dtype=np.uint8)
    frame_dev = jax.device_put(frame)
    report = {}
    for name, crop_w, mode in (("ignore_ar", 60, cvgs.AspectRatio.IGNORE_AR),
                               ("preserve_ar", 30, cvgs.AspectRatio.PRESERVE_AR)):
        rects = np.array([[i, i, crop_w, 120] for i in range(BATCH)], np.int32)
        prep = detection_preprocessor(
            dsize=UP, mean=FLAGSHIP_MEAN, scale=FLAGSHIP_SCALE,
            alpha=FLAGSHIP_ALPHA, background=FLAGSHIP_BG, aspect_ratio=mode)
        out = np.asarray(prep(frame, rects))
        err = float(np.abs(out - flagship_reference(
            frame, rects, preserve=mode != cvgs.AspectRatio.IGNORE_AR)).max())
        if not err <= 1e-4:
            raise SystemExit(f"{name}: output differs from the reference by {err}")
        e2e = time_fn(lambda: prep(frame, rects), iters=args.iters)
        dev = time_fn(lambda: prep(frame_dev, rects), iters=args.iters)
        dt = device_time(lambda: prep(frame_dev, rects))
        report[name] = {
            "max_abs_err": err,
            "end_to_end_median_us": e2e.median * 1e6,
            "end_to_end_p90_us": e2e.p90 * 1e6,
            "device_resident_median_us": dev.median * 1e6,
            "device_time_us": dt["total"] * 1e6,
        }
        print(f"{name}: {json.dumps(report[name])}", flush=True)

    rects = np.array([[i, i, 60, 120] for i in range(BATCH)], np.int32)
    unfused = unfused_baseline(frame_dev, rects, iters=5)
    print(f"unfused 250-dispatch baseline: median {unfused.median * 1e3:.3f} ms",
          flush=True)
    fused = report["ignore_ar"]["end_to_end_median_us"] * 1e-6
    dev = jax.devices()[0]
    print(json.dumps({
        "metric": "images_per_sec_50crop_resize_normalize_split",
        "value": BATCH / fused,
        "unit": "images/sec",
        "vs_baseline": unfused.median / fused,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "cases": report,
    }), flush=True)


if __name__ == "__main__":
    main()
