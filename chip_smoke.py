#!/usr/bin/env python3
"""Smoke check of the fused-preprocessing main path on one NVIDIA GPU.

Run from the repository root on a machine with a GPU::

    python chip_smoke.py                # one card
    python chip_smoke.py --four-cards   # the sharded flagship on four cards

Phases on one card (every one must pass for exit code 0):

1. The flagship through ``pipelines.presets.detection_preprocessor`` with
   the AUTO backend, at full size: a host 3840x2160x3 u8 frame, 50 crops
   resized to 64x128, ``convert_to(f32, 0.3)``, subtract, divide, planar
   split — IGNORE_AR with 60x120 crops, PRESERVE_AR with 30x120 crops
   (background 128), and IGNORE_AR with ``used_planes=37``. Float output
   within 1e-4 of the numpy reference per pixel; time per call end to end
   and device time per call from a profiler trace.
2. One pass of each pipeline whose hand kernel was removed, against the
   reference: ``camera_pipeline`` NV12 6K -> 1080p (u8), ``temporal_window``
   with 32 pushes of 1080p -> 64x128, a 1080p 10-degree rotation warp, and a
   divergent crop-resize | passthrough batch. Integer outputs are held
   bit-exact, except that a pixel whose exact value sits on a .5 rounding
   edge may round either way (float32 rounds the intermediate products, or
   the GPU contracts ``a*b+c`` into an FMA); such pixels are counted.

``--four-cards`` runs only the sharded flagship: 52 planes with
``used_planes=50`` over a 1-D mesh of four cards, compared bit for bit with
``execute_operations`` on one card.

The last line of standard output is one JSON object; a run that finds no GPU
exits non-zero before it prints one. The reference below is plain numpy: it
imports nothing from the package and needs no OpenCV.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

SEED = 20261016
FLAGSHIP_DSIZE = (64, 128)  # (width, height)
FLAGSHIP_ALPHA = 0.3
FLAGSHIP_MEAN = (3.2, 0.6, 11.8)
FLAGSHIP_SCALE = (128.0, 128.0, 128.0)
FLAGSHIP_BG = 128.0
FLOAT_TOL = 1e-4

_KR_KB = {"bt601": (0.299, 0.114), "bt709": (0.2126, 0.0722)}


# ---------------------------------------------------------------------------
# plain numpy reference
# ---------------------------------------------------------------------------


def ref_axis(dst_len: int, src_len: int):
    """OpenCV INTER_LINEAR taps for one axis: half-pixel centres,
    ``s = (q + 0.5) * src/dst - 0.5``; the left tap clamps to the edge with
    weight 0 at either end. Returns (i0, i1, w) with w in float64."""
    q = np.arange(dst_len, dtype=np.float64)
    s = (q + 0.5) * (src_len / max(dst_len, 1)) - 0.5  # dst 0: no taps
    i0 = np.floor(s)
    w = s - i0
    i0 = i0.astype(np.int64)
    w = np.where(i0 < 0, 0.0, w)
    i0 = np.maximum(i0, 0)
    w = np.where(i0 >= src_len - 1, 0.0, w)
    i0 = np.minimum(i0, src_len - 1)
    return i0, np.minimum(i0 + 1, src_len - 1), w


def ref_resize(img: np.ndarray, dst_w: int, dst_h: int) -> np.ndarray:
    """Bilinear resize of an (H, W, C) image, in float64."""
    x = img.astype(np.float64)
    y0, y1, wy = ref_axis(dst_h, x.shape[0])
    x0, x1, wx = ref_axis(dst_w, x.shape[1])
    wx = wx[None, :, None]
    wy = wy[:, None, None]
    top, bot = x[y0], x[y1]
    top = top[:, x0] * (1.0 - wx) + top[:, x1] * wx
    bot = bot[:, x0] * (1.0 - wx) + bot[:, x1] * wx
    return top * (1.0 - wy) + bot * wy


def ref_letterbox(w: int, h: int, dst_w: int, dst_h: int, preserve: bool):
    """Fitted sub-rectangle (new_w, new_h, ox, oy) of the reference's
    aspect-ratio host code: scale to the target height in float32 and
    truncate; if the width overflows, scale to the target width; centre."""
    if not preserve:
        return dst_w, dst_h, 0, 0
    scale = np.float32(dst_h) / np.float32(h)
    new_w, new_h = int(np.float32(scale * np.float32(w))), dst_h
    if new_w > dst_w:
        scale2 = np.float32(dst_w) / np.float32(w)
        new_w, new_h = dst_w, int(np.float32(scale2 * np.float32(h)))
    return new_w, new_h, (dst_w - new_w) // 2, (dst_h - new_h) // 2


def ref_batch_resize(frame, rects, dst_w, dst_h, preserve=False,
                     background=0.0, used=None) -> np.ndarray:
    """(N, dst_h, dst_w, C) float64: each rect [x, y, w, h] of ``frame``
    resized (letterboxed when ``preserve``); planes ``>= used`` and
    letterbox borders hold ``background``."""
    frame = frame if frame.ndim == 3 else frame[..., None]
    n, c = len(rects), frame.shape[-1]
    used = n if used is None else used
    out = np.empty((n, dst_h, dst_w, c), np.float64)
    out[:] = np.broadcast_to(np.asarray(background, np.float64), (c,))
    for z in range(min(n, used)):
        x, y, w, h = (int(v) for v in rects[z])
        nw, nh, ox, oy = ref_letterbox(w, h, dst_w, dst_h, preserve)
        out[z, oy:oy + nh, ox:ox + nw] = ref_resize(
            frame[y:y + h, x:x + w], nw, nh)
    return out


def ref_nv12_to_rgb(buf: np.ndarray, standard: str = "bt601",
                    limited: bool = False, nv21: bool = False) -> np.ndarray:
    """NV12 (or NV21) buffer (H*3/2, W) -> (H, W, 3) RGB by the BT.601 /
    BT.709 equations (Kr, Kb), full or limited range, chroma upsampled
    nearest-neighbour. The coefficients are rounded to float32, as the
    device uses them; the arithmetic is float64, i.e. the exact value that
    any float32 evaluation order approximates."""
    height = buf.shape[0] * 2 // 3
    kr, kb = _KR_KB[standard]
    kg = 1.0 - kr - kb

    def f32(c):
        return np.float64(np.float32(c))

    y = buf[:height].astype(np.float64)
    uv = buf[height:].reshape(height // 2, -1, 2).astype(np.float64)
    if nv21:
        uv = uv[..., ::-1]
    uv = np.repeat(np.repeat(uv, 2, axis=0), 2, axis=1)
    u = uv[..., 0] - 128.0
    v = uv[..., 1] - 128.0
    if limited:
        y = (y - 16.0) * f32(255.0 / 219.0)
        u = u * f32(255.0 / 224.0)
        v = v * f32(255.0 / 224.0)
    r = y + f32(2.0 * (1.0 - kr)) * v
    g = (y - f32(2.0 * kb * (1.0 - kb) / kg) * u
         - f32(2.0 * kr * (1.0 - kr) / kg) * v)
    b = y + f32(2.0 * (1.0 - kb)) * u
    return np.stack([r, g, b], axis=-1)


def ref_warp(img: np.ndarray, m, dst_w: int, dst_h: int,
             perspective: bool = False, border=0.0) -> np.ndarray:
    """Bilinear warp by the FORWARD matrix ``m`` (2x3 affine or 3x3
    homography) with a constant border — OpenCV ``warpAffine`` /
    ``warpPerspective`` semantics, with exact float coordinates instead of
    OpenCV's 1/32-pixel fixed point. Source coordinates follow OpenCV's
    per-axis decomposition with float32 coefficients, products and sums.
    Returns (dst_h, dst_w, C) float32."""
    img = img if img.ndim == 3 else img[..., None]
    m = np.asarray(m, np.float64)
    if perspective:
        inv = np.linalg.inv(m)
    else:
        a_inv = np.linalg.inv(m[:, :2])
        inv = np.concatenate([a_inv, (-a_inv @ m[:, 2])[:, None]], axis=1)
    c = inv.astype(np.float32)
    xs = np.arange(dst_w, dtype=np.float32)
    ys = np.arange(dst_h, dtype=np.float32)
    sx = (c[0, 0] * xs)[None, :] + (c[0, 1] * ys + c[0, 2])[:, None]
    sy = (c[1, 0] * xs)[None, :] + (c[1, 1] * ys + c[1, 2])[:, None]
    if perspective:
        den = (c[2, 0] * xs)[None, :] + (c[2, 1] * ys + c[2, 2])[:, None]
        den = np.where(den == 0, np.float32(1.0), den)
        sx, sy = sx / den, sy / den
    x0, y0 = np.floor(sx), np.floor(sy)
    fx, fy = (sx - x0)[..., None], (sy - y0)[..., None]
    x0, y0 = x0.astype(np.int64), y0.astype(np.int64)
    h, w = img.shape[:2]
    src = img.astype(np.float32)
    bord = np.broadcast_to(np.asarray(border, np.float32), (img.shape[-1],))

    def tap(ix, iy):
        ok = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        v = src[np.clip(iy, 0, h - 1), np.clip(ix, 0, w - 1)]
        return np.where(ok[..., None], v, bord)

    top = tap(x0, y0) * (1 - fx) + tap(x0 + 1, y0) * fx
    bot = tap(x0, y0 + 1) * (1 - fx) + tap(x0 + 1, y0 + 1) * fx
    return top * (1 - fy) + bot * fy


def ref_to_u8(x: np.ndarray) -> np.ndarray:
    """OpenCV ``saturate_cast<uchar>``: round half to even, clamp."""
    return np.clip(np.rint(x), 0, 255).astype(np.uint8)


def rotation_matrix(center, angle_deg: float, scale: float) -> np.ndarray:
    """OpenCV ``getRotationMatrix2D``: a 2x3 forward affine map."""
    a = np.deg2rad(angle_deg)
    al, be = scale * np.cos(a), scale * np.sin(a)
    cx, cy = center
    return np.array([[al, be, (1 - al) * cx - be * cy],
                     [-be, al, be * cx + (1 - al) * cy]], np.float64)


def flagship_reference(frame, rects, preserve=False, used=None) -> np.ndarray:
    """The flagship chain on the reference resize, planar (N, C, H, W)."""
    x = ref_batch_resize(frame, rects, *FLAGSHIP_DSIZE, preserve=preserve,
                         background=FLAGSHIP_BG, used=used)
    x = (x * FLAGSHIP_ALPHA - np.asarray(FLAGSHIP_MEAN)) / np.asarray(FLAGSHIP_SCALE)
    return x.transpose(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# checks
# ---------------------------------------------------------------------------


class PhaseFailed(Exception):
    pass


def check_float(name: str, out, ref, tol: float = FLOAT_TOL) -> None:
    out = np.asarray(out, np.float64)
    if out.shape != ref.shape:
        raise PhaseFailed(f"{name}: shape {out.shape} != reference {ref.shape}")
    err = np.abs(out - ref)
    bad = int((err > tol).sum())
    print(f"  {name}: max abs err {err.max():.3e}, {bad} pixels over {tol:g}",
          flush=True)
    if bad or not np.isfinite(out).all():
        raise PhaseFailed(f"{name}: {bad} pixels exceed {tol:g}")


#: how far a float32 evaluation of the pipelines' short formulas can land
#: from the exact value: their intermediates (|y| + |c*u| + |c*v|, or a
#: weighted sum of pixels) stay below 512, where one rounding errs by at most
#: half of 3.05e-5; four ulps there cover every evaluation order the compiler
#: may pick (the rounding of each product, or an FMA that skips it)
_EDGE_TOL = 4 * float(np.spacing(np.float32(256.0)))


def check_u8(name: str, out, ref_exact: np.ndarray) -> None:
    """Bit-exact check of a u8 output against the rounded exact reference.

    A pixel whose exact value lies within ``_EDGE_TOL`` of a .5 rounding tie
    is on an edge: whether the device rounds it up or down depends on how
    float32 evaluates the formula, so either neighbour is accepted there.
    Those pixels are counted and printed; every other pixel must match."""
    out = np.asarray(out)
    ref = ref_to_u8(ref_exact)
    if out.shape != ref.shape or out.dtype != np.uint8:
        raise PhaseFailed(f"{name}: {out.dtype}{out.shape} != u8{ref.shape}")
    edge = ((np.abs(ref_exact - np.floor(ref_exact) - 0.5) <= _EDGE_TOL)
            & (ref_exact > -1.0) & (ref_exact < 256.0))
    diff = out.astype(np.int32) - ref
    flips = int(((diff != 0) & edge).sum())
    bad = int(((diff != 0) & ~(edge & (np.abs(diff) == 1))).sum())
    print(f"  {name}: {bad} mismatching pixels; {int(edge.sum())} pixels on a "
          f".5 rounding edge, {flips} of them rounded the other way",
          flush=True)
    if bad:
        raise PhaseFailed(f"{name}: {bad} mismatching u8 pixels")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def _flagship_rects(n: int, crop_w: int) -> np.ndarray:
    return np.array([[i, i, crop_w, 120] for i in range(n)], np.int32)


def _flagship_ops(cvgs, frame, rects, preserve=False, used=None):
    return [
        cvgs.resize_batch(
            frame, rects=rects, dsize=cvgs.Size(*FLAGSHIP_DSIZE),
            used_planes=used, background=FLAGSHIP_BG,
            aspect_ratio=(cvgs.AspectRatio.PRESERVE_AR if preserve
                          else cvgs.AspectRatio.IGNORE_AR)),
        cvgs.convert_to(np.float32, alpha=FLAGSHIP_ALPHA),
        cvgs.subtract(FLAGSHIP_MEAN),
        cvgs.divide(FLAGSHIP_SCALE),
        cvgs.split_tensor(),
    ]


def _us(seconds: float) -> str:
    return f"{seconds * 1e6:.1f} us"


def _report(name: str, fn) -> None:
    """Print the end-to-end time per call and the device time per call."""
    from cvgpuspeedup_tpu.utils.profiling import device_time, time_fn

    t = time_fn(fn, iters=50)
    dt = device_time(fn, iters=10)
    ops_txt = ", ".join(f"{k} {_us(v)}" for k, v in sorted(
        dt.items(), key=lambda kv: -kv[1]) if k != "total")
    print(f"  {name}: end to end median {_us(t.median)} (p90 {_us(t.p90)}), "
          f"device time {_us(dt['total'])} per call ({ops_txt})", flush=True)


def phase_flagship(cvgs, executor, frame) -> None:
    from cvgpuspeedup_tpu.pipelines.presets import detection_preprocessor

    cases = [("IGNORE_AR", 60, False, None), ("PRESERVE_AR", 30, True, None),
             ("IGNORE_AR used_planes=37", 60, False, 37)]
    for name, crop_w, preserve, used in cases:
        rects = _flagship_rects(50, crop_w)
        prep = detection_preprocessor(
            dsize=cvgs.Size(*FLAGSHIP_DSIZE), mean=FLAGSHIP_MEAN,
            scale=FLAGSHIP_SCALE, alpha=FLAGSHIP_ALPHA, background=FLAGSHIP_BG,
            aspect_ratio=(cvgs.AspectRatio.PRESERVE_AR if preserve
                          else cvgs.AspectRatio.IGNORE_AR))
        out = np.asarray(prep(frame, rects, used))
        print(f"  flagship {name}: backend {executor.last_backend()}, "
              f"out {out.dtype}{out.shape}", flush=True)
        check_float(f"flagship {name}", out,
                    flagship_reference(frame, rects, preserve, used))
        _report(f"flagship {name}", lambda: prep(frame, rects, used))


def phase_xla_pipelines(cvgs, executor, rng) -> None:
    from cvgpuspeedup_tpu.pipelines.presets import (camera_pipeline,
                                                     temporal_window)

    # camera_pipeline: NV12 6K -> 1080p RGB u8 (the fused-frame kernel's cell)
    buf = rng.integers(0, 256, (3240 * 3 // 2, 5760), dtype=np.uint8)
    cam = camera_pipeline(out_size=cvgs.Size(1920, 1080))
    out = np.asarray(cam(buf))
    print(f"  camera_pipeline NV12 6K->1080p: backend "
          f"{executor.last_backend()}", flush=True)
    check_u8("camera_pipeline NV12 6K->1080p", out,
             ref_resize(ref_nv12_to_rgb(buf), 1920, 1080))
    _report("camera_pipeline NV12 6K->1080p", lambda: cam(buf))

    # temporal_window: 32 pushes of 1080p -> 64x128 (circular-tensor cell)
    frames = rng.integers(0, 256, (32, 1080, 1920, 3), dtype=np.uint8)
    tw = temporal_window(window=32, dsize=cvgs.Size(64, 128), channels=3)
    for f in frames:
        tw.push(f)
    out = np.asarray(tw.tensor)
    print(f"  temporal_window 32 x 1080p->64x128: backend "
          f"{executor.last_backend()}", flush=True)
    ref = np.stack([ref_resize(f, 64, 128) * (1.0 / 255.0)
                    for f in frames[::-1]]).transpose(0, 3, 1, 2)
    check_float("temporal_window 32 x 1080p->64x128", out, ref)
    _report("temporal_window push 1080p->64x128", lambda: tw.push(frames[0]))

    # 1080p 10-degree rotation warp + normalize + planar split
    img = rng.integers(0, 256, (1080, 1920, 3), dtype=np.uint8)
    m = rotation_matrix((960, 540), 10.0, 1.0)
    wops = lambda: [cvgs.warp(img, m, cvgs.Size(1920, 1080)),
                    cvgs.convert_to(np.float32, alpha=1 / 255.0),
                    cvgs.split_tensor()]
    out = np.asarray(cvgs.execute_operations(*wops()))
    print(f"  warp 1080p 10deg: backend {executor.last_backend()}", flush=True)
    ref = (ref_warp(img, m, 1920, 1080).astype(np.float64)
           * np.float32(1 / 255.0)).transpose(2, 0, 1)
    check_float("warp 1080p 10deg rotation", out, ref)
    _report("warp 1080p 10deg rotation",
           lambda: cvgs.execute_operations(*wops()))

    # divergent batch: crop-resize planes | passthrough planes
    frame = rng.integers(0, 256, (1080, 1920, 3), dtype=np.uint8)
    rects = np.array([[17 * z, 9 * z, 96, 192] for z in range(16)], np.int32)
    flat = rng.random((16, 128, 64, 3), dtype=np.float32) * 255
    ids = [1 if z % 2 == 0 else 2 for z in range(16)]

    def divergent():
        seq1 = cvgs.build_operation_sequence(
            cvgs.resize_batch(frame, rects=rects, dsize=cvgs.Size(64, 128)),
            cvgs.convert_to(np.float32, alpha=0.5), cvgs.write_tensor())
        seq2 = cvgs.build_operation_sequence(
            cvgs.image(flat), cvgs.multiply(2.0), cvgs.write_tensor())
        return cvgs.launch_divergent_batch(ids, seq1, seq2)

    out = np.asarray(divergent())
    print(f"  divergent crop-resize|passthrough: backend "
          f"{executor.last_backend()}", flush=True)
    ref = np.where(np.asarray(ids)[:, None, None, None] == 1,
                   ref_batch_resize(frame, rects, 64, 128) * 0.5,
                   flat.astype(np.float64) * 2.0)
    check_float("divergent crop-resize|passthrough", out, ref)
    _report("divergent crop-resize|passthrough", divergent)


def phase_four_cards(cvgs, executor, jax, frame) -> None:
    from cvgpuspeedup_tpu.parallel import mesh as pmesh

    devices = jax.devices()
    if len(devices) < 4:
        raise PhaseFailed(f"--four-cards needs 4 devices, found {len(devices)}")
    mesh = pmesh.make_mesh(devices=devices[:4])
    rects = _flagship_rects(52, 60)
    ops = lambda: _flagship_ops(cvgs, frame, rects, used=50)
    single = np.asarray(cvgs.execute_operations(*ops()))
    single_backend = executor.last_backend()
    sharded = pmesh.execute_sharded(*ops(), mesh=mesh)
    print(f"  single card: backend {single_backend}; sharded over "
          f"{mesh.devices.size} cards: output sharding "
          f"{sharded.sharding.spec}", flush=True)
    sharded = np.asarray(sharded)
    same = np.array_equal(sharded, single)
    print(f"  sharded vs single card: {'bit-identical' if same else 'DIFFERENT'}"
          f", max abs diff {np.abs(sharded - single).max():.3e}", flush=True)
    if not same:
        raise PhaseFailed("sharded flagship differs from the single-card run")
    check_float("sharded flagship vs reference", sharded,
                flagship_reference(frame, rects, used=50))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the sharded flagship on four cards")
    args = parser.parse_args(argv)

    import jax

    platform = jax.default_backend()
    if platform != "gpu":
        print(f"chip_smoke: JAX found no GPU (default backend {platform!r})",
              file=sys.stderr)
        return 2

    import cvgpuspeedup_tpu as cvgs
    from cvgpuspeedup_tpu.exec import executor
    from cvgpuspeedup_tpu.utils.compile_cache import enable_compile_cache
    from cvgpuspeedup_tpu.utils.profiling import card_description

    cache_dir = enable_compile_cache()
    dev = jax.devices()[0]
    print(card_description(), flush=True)
    print(f"device_kind {dev.device_kind}, {len(jax.devices())} device(s), "
          f"jax {jax.__version__}, compile cache {cache_dir}", flush=True)

    rng = np.random.default_rng(SEED)
    frame = rng.integers(0, 256, (2160, 3840, 3), dtype=np.uint8)
    if args.four_cards:
        phases = [("sharded flagship on four cards",
                   lambda: phase_four_cards(cvgs, executor, jax, frame))]
    else:
        phases = [
            ("flagship through detection_preprocessor",
             lambda: phase_flagship(cvgs, executor, frame)),
            ("pipelines of the removed kernels",
             lambda: phase_xla_pipelines(cvgs, executor, rng)),
        ]
    failed = []
    for name, run in phases:
        print(f"phase: {name}", flush=True)
        t0 = time.perf_counter()
        try:
            run()
        except PhaseFailed as e:
            print(f"  FAILED: {e}", flush=True)
            failed.append(name)
        print(f"  ({time.perf_counter() - t0:.1f} s)", flush=True)
    if failed:
        print(f"chip_smoke: {len(failed)} phase(s) failed: {failed}",
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
