#!/usr/bin/env python
"""Auxiliary benchmarks: the other deployment pipelines, fused vs unfused.

Reference CSV protocol (``tests/testsCommon.cuh:122-195``): one row per
case, baseline-vs-fused statistics and mean speedup. The baseline there is
per-op OpenCV calls; here it is the same pipeline issued as one device
program per op (the read, each compute op, the write), the launch pattern
the fused path replaces. Divergent batches compare against one fused
program per sequence plus a merge.

Cases (inputs are generated from a seed and put on the device first):

- single 1920x1080 RGB -> 640x360, normalize, planar split
- 6K NV12 -> RGB -> 1080p, normalize ("ComputeWhatYouSee"; synthesized
  data, the upstream raw6K.nv12 blob is missing)
- 32-frame CircularTensor window update (1080p -> 64x128)
- 1080p warps: separable scale+translate, 10-degree rotation, horizontal
  flip, perspective; a ragged batch of 8 rotations
- divergent batches: crop-resize | pass-through, NV12 cameras |
  pass-through, warp | crop-resize | pass-through

Every number is timed with ``block_until_ready``; the device time per call
comes from a profiler trace. Prints the card's name and power limit first.

Usage: python benchmarks/aux_pipelines.py [--iters 50] [--csv PATH]
"""

import argparse
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import cvgpuspeedup_tpu as cvgs  # noqa: E402
from chip_smoke import rotation_matrix  # noqa: E402
from cvgpuspeedup_tpu.pipelines.presets import temporal_window  # noqa: E402
from cvgpuspeedup_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402
from cvgpuspeedup_tpu.utils.profiling import (BenchmarkRecorder, device_time,  # noqa: E402
                                              require_gpu, time_fn)

NORM = (cvgs.convert_to(np.float32, alpha=1 / 255.0),
        cvgs.subtract((0.485, 0.456, 0.406)),
        cvgs.divide((0.229, 0.224, 0.225)))

_read = jax.jit(lambda r: r.lower())
_apply = jax.jit(lambda o, x: o.apply(x))
_write = jax.jit(lambda w, x: w.write(x))


def per_op(*iops):
    """The pipeline as one device program per op."""
    p = cvgs.build_pipeline(*iops)
    x = _read(p.read)
    for o in p.compute:
        x = _apply(o, x)
    return _write(p.write, x)


def _merge(ids, outs):
    sel = jnp.asarray(ids).reshape((-1,) + (1,) * (outs[0].ndim - 1))
    merged = outs[0]
    for k in range(1, len(outs)):
        merged = jnp.where(sel == k + 1, outs[k], merged)
    return merged


_merge_jit = jax.jit(_merge, static_argnums=0)


def _run_sequence(seq):
    """One divergent sequence over the whole batch as its own program."""
    return cvgs.execute_operations(seq.read, *seq.compute, seq.write)


def cases(rng):
    """name -> (fused, unfused): zero-argument callables."""
    img_host = rng.integers(0, 256, (1080, 1920, 3), dtype=np.uint8)
    img = jax.device_put(img_host)
    nv12 = jax.device_put(rng.integers(0, 256, (3240 * 3 // 2, 5760), dtype=np.uint8))
    frame4k = jax.device_put(rng.integers(0, 256, (2160, 3840, 3), dtype=np.uint8))
    out = {}

    ops = lambda: [cvgs.resize(cvgs.image(img), cvgs.Size(640, 360)), *NORM,
                   cvgs.split_tensor()]
    out["single_1080p_resize_normalize_split"] = ops

    ops = lambda: [cvgs.resize(cvgs.fuse(cvgs.read_yuv(nv12),
                                         cvgs.convert_yuv_to_rgb(out_dtype=np.float32)),
                               cvgs.Size(1920, 1080)),
                   cvgs.multiply(1 / 255.0), cvgs.split_tensor()]
    out["nv12_6k_to_1080p_rgb_normalize"] = ops

    warps = {
        "warp_1080p_separable_affine_normalize_split":
            (np.array([[0.55, 0.0, 23.0], [0.0, 0.62, 11.0]]), (640, 360), False),
        "warp_1080p_rotation10deg_normalize_split":
            (rotation_matrix((960, 540), 10.0, 1 / 3.0), (640, 360), False),
        "warp_1080p_hflip_downscale":
            (np.array([[-0.5, 0.0, 959.0], [0.0, 0.5, 0.0]]), (960, 540), False),
        "warp_1080p_perspective":
            (np.array([[0.33, 0.02, 5.0], [0.01, 0.35, 3.0], [1e-5, 2e-5, 1.0]]),
             (640, 384), True),
    }
    for name, (m, size, persp) in warps.items():
        wt = cvgs.WarpType.PERSPECTIVE if persp else cvgs.WarpType.AFFINE
        out[name] = (lambda m=m, size=size, wt=wt: [
            cvgs.warp(img, m, cvgs.Size(*size), warp_type=wt), *NORM,
            cvgs.split_tensor()])

    mats = [rotation_matrix((960, 540), 3.0 * i - 10, 1.0 + 0.04 * i)
            for i in range(8)]
    out["warp_batch8_1080p_rotations_ragged"] = lambda: [
        cvgs.warp_batch([img] * 8, mats, cvgs.Size(640, 360), used_planes=6,
                        default=0.0),
        *NORM, cvgs.split_tensor()]

    runs = {name: (lambda ops=ops: cvgs.execute_operations(*ops()),
                   lambda ops=ops: per_op(*ops()))
            for name, ops in out.items()}

    # CircularTensor window (host frames, as the preset takes them): fused
    # update vs per-op resize/normalize + shift
    tw = temporal_window(window=32, dsize=cvgs.Size(64, 128))
    ring = jnp.zeros((32, 3, 128, 64), jnp.float32)
    shift = jax.jit(lambda r, x: jnp.concatenate([x[None], r[:-1]], axis=0))

    def ring_unfused():
        x = per_op(cvgs.resize(cvgs.image(img_host), cvgs.Size(64, 128)),
                   cvgs.convert_to(np.float32, alpha=1 / 255.0),
                   cvgs.split_tensor())
        return shift(ring, x)

    runs["circular_tensor_32_update"] = (lambda: tw.push(img_host), ring_unfused)

    # divergent batches: one program vs one fused program per sequence + merge
    rects = np.array([[13 * z, 9 * z, 60, 120] for z in range(8)], np.int32)
    flat = jax.device_put(rng.random((8, 128, 64, 3), dtype=np.float32) * 255)
    bufs = [jax.device_put(rng.integers(0, 256, (1080 * 3 // 2, 1920), dtype=np.uint8))
            for _ in range(8)]
    wimgs = [jax.device_put(rng.integers(0, 256, (512, 768, 3), dtype=np.uint8))
             for _ in range(8)]
    wmats = [rotation_matrix((384, 256), 4.0 * z - 14, 1.0) for z in range(8)]
    crop = lambda: cvgs.build_operation_sequence(
        cvgs.resize_batch(frame4k, rects=rects, dsize=cvgs.Size(64, 128)),
        cvgs.convert_to(np.float32, alpha=0.5), cvgs.write_tensor())
    passthrough = lambda: cvgs.build_operation_sequence(
        cvgs.image(flat), cvgs.multiply(2.0), cvgs.write_tensor())
    cams = lambda: cvgs.build_operation_sequence(
        cvgs.batch_read([cvgs.resize(cvgs.fuse(cvgs.read_yuv(b),
                                               cvgs.convert_yuv_to_rgb(out_dtype=np.float32)),
                                     cvgs.Size(64, 128)) for b in bufs]),
        cvgs.multiply(0.5), cvgs.write_tensor())
    warp_seq = lambda: cvgs.build_operation_sequence(
        cvgs.warp_batch(wimgs, wmats, cvgs.Size(64, 128)),
        cvgs.multiply(0.5), cvgs.write_tensor())
    divergent = {
        "divergent_crop_resize_passthrough_8planes":
            ((1, 2, 1, 2, 1, 2, 1, 2), (crop, passthrough)),
        "divergent_nv12_resize_passthrough_8planes":
            ((1, 2, 1, 2, 1, 2, 1, 2), (cams, passthrough)),
        "divergent_warp_crop_pass_8planes":
            ((1, 2, 3, 1, 2, 3, 1, 2), (warp_seq, crop, passthrough)),
    }
    for name, (ids, seqs) in divergent.items():
        runs[name] = (
            lambda ids=ids, seqs=seqs: cvgs.launch_divergent_batch(
                ids, *[s() for s in seqs]),
            lambda ids=ids, seqs=seqs: _merge_jit(
                ids, [_run_sequence(s()) for s in seqs]),
        )
    return runs


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--csv", default=None, help="write the CSV rows here")
    args = ap.parse_args()

    header = require_gpu()
    enable_compile_cache()
    print(header, flush=True)
    rec = BenchmarkRecorder(args.csv or os.devnull)
    for name, (fused, unfused) in cases(np.random.default_rng(0)).items():
        t_f = time_fn(fused, iters=args.iters)
        t_u = time_fn(unfused, iters=max(5, args.iters // 5))
        dt = device_time(fused, iters=10)
        rec.add_case(name, t_u, t_f)
        print(f"{name}: fused median {t_f.median * 1e6:.1f} us "
              f"(device {dt['total'] * 1e6:.1f} us), unfused median "
              f"{t_u.median * 1e6:.1f} us, speedup {t_u.median / t_f.median:.2f}x",
              flush=True)
    if args.csv:
        rec.write()


if __name__ == "__main__":
    main()
