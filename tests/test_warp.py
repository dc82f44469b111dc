"""Warp affine/perspective parity vs cv2 — the ``tests/warping/`` analog
(reference ``test_warping_opencv.cu:58-73,185,262-271``).

The reference itself treats perspective border pixels as "EXPECTED_FAIL" vs
OpenCV/NPP; we mirror that by masking the outermost border ring for the
perspective comparison and requiring exact-tolerance parity on the interior.
"""

import cv2
import numpy as np
import pytest

import cvgpuspeedup_tpu as cvgs
from chip_smoke import ref_warp
from conftest import check_float


def _affine_matrix(angle=20.0, scale=0.8, center=(40, 30), shift=(5, -3)):
    m = cv2.getRotationMatrix2D(center, angle, scale)
    m[:, 2] += shift
    return m


def _np_warp_affine(img, m, dsize):
    """Pure-float reference (the semantics our engine and the reference's GPU
    path implement; cv2 CPU quantizes coords to 1/32 px — INTER_BITS=5 —
    which the reference classes as EXPECTED_FAIL-level divergence)."""
    w, h = dsize
    m = np.asarray(m, np.float64)
    a = np.linalg.inv(m[:, :2])
    b = -a @ m[:, 2]
    # mirror the engine's per-axis decomposition (f32 coefficients, IEEE f32
    # products — ops.warp.decompose_inverse_map)
    xs = np.arange(w, dtype=np.float32)
    ys = np.arange(h, dtype=np.float32)
    a32 = a.astype(np.float32)
    b32 = b.astype(np.float32)
    col_x = a32[0, 0] * xs
    row_x = a32[0, 1] * ys + b32[0]
    col_y = a32[1, 0] * xs
    row_y = a32[1, 1] * ys + b32[1]
    sx = col_x[None, :] + row_x[:, None]
    sy = col_y[None, :] + row_y[:, None]
    x0 = np.floor(sx).astype(np.int64)
    y0 = np.floor(sy).astype(np.int64)
    fx = (sx - x0)[..., None]
    fy = (sy - y0)[..., None]
    H, W = img.shape[:2]
    src = img.astype(np.float32)

    def tap(ix, iy):
        valid = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
        v = src[np.clip(iy, 0, H - 1), np.clip(ix, 0, W - 1)]
        return np.where(valid[..., None], v, 0.0)

    h0 = tap(x0, y0) * (1 - fx) + tap(x0 + 1, y0) * fx
    h1 = tap(x0, y0 + 1) * (1 - fx) + tap(x0 + 1, y0 + 1) * fx
    return h0 * (1 - fy) + h1 * fy


def test_warp_affine_vs_cv2(rng):
    img = rng.integers(0, 256, (60, 80, 3)).astype(np.uint8)
    m = _affine_matrix()
    out = np.asarray(
        cvgs.execute_operations(cvgs.warp(img, m, cvgs.Size(80, 60)))
    )
    ref = cv2.warpAffine(
        img.astype(np.float32), m, (80, 60), flags=cv2.INTER_LINEAR,
        borderMode=cv2.BORDER_CONSTANT, borderValue=0,
    )
    # cv2 CPU uses 1/32-px fixed-point coords; bound the divergence it causes
    # (255 * 2/32 worst case ~ 2e-2; typical well under that).
    check_float(out, ref, tol=2e-2, msg="warpAffine vs cv2 (quantized oracle)")
    # tight check vs an exact float reference of the same semantics
    check_float(out, _np_warp_affine(img, m, (80, 60)), msg="warpAffine float ref (1e-4 contract; XLA FMA vs numpy)")


def test_warp_affine_identity(rng):
    img = rng.integers(0, 256, (32, 48, 3)).astype(np.uint8)
    m = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    out = np.asarray(cvgs.execute_operations(cvgs.warp(img, m, cvgs.Size(48, 32))))
    check_float(out, img.astype(np.float32), msg="identity affine")


def test_warp_perspective_vs_cv2(rng):
    img = rng.integers(0, 256, (60, 80, 3)).astype(np.uint8)
    src_pts = np.float32([[0, 0], [79, 0], [0, 59], [79, 59]])
    dst_pts = np.float32([[3, 2], [75, 5], [2, 55], [78, 57]])
    m = cv2.getPerspectiveTransform(src_pts, dst_pts)
    out = np.asarray(
        cvgs.execute_operations(
            cvgs.warp(img, m, cvgs.Size(80, 60), warp_type=cvgs.WarpType.PERSPECTIVE)
        )
    )
    ref = cv2.warpPerspective(
        img.astype(np.float32), m, (80, 60), flags=cv2.INTER_LINEAR,
        borderMode=cv2.BORDER_CONSTANT, borderValue=0,
    )
    # interior must match; border ring is EXPECTED_FAIL territory in the
    # reference (test_warping_opencv.cu:73,268-270)
    check_float(out[2:-2, 2:-2], ref[2:-2, 2:-2], tol=1e-2, msg="warpPerspective interior")


def test_warp_then_cast(rng):
    """warp emits float; append Cast like the reference tests
    (``test_warping_opencv.cu:63``)."""
    img = rng.integers(0, 256, (40, 40, 3)).astype(np.uint8)
    m = _affine_matrix(center=(20, 20), shift=(0, 0))
    out = np.asarray(
        cvgs.execute_operations(
            cvgs.warp(img, m, cvgs.Size(40, 40)), cvgs.convert_to(np.uint8)
        )
    )
    assert out.dtype == np.uint8
    ref = cv2.warpAffine(img.astype(np.float32), m, (40, 40))
    ref_u8 = np.clip(np.rint(ref), 0, 255).astype(np.uint8)
    # float->u8 rounding can flip on ties; allow <=1 lsb on a tiny fraction
    diff = np.abs(out.astype(np.int32) - ref_u8.astype(np.int32))
    assert (diff > 1).sum() == 0 and (diff == 1).mean() < 0.01


def test_warp_batch_ragged(rng):
    """Batched warp with per-image matrices + ragged default
    (reference ``test_warping_opencv.cu:242-247``)."""
    imgs = rng.integers(0, 256, (4, 40, 40, 3)).astype(np.uint8)
    mats = [_affine_matrix(angle=10 * i, center=(20, 20), shift=(0, 0)) for i in range(4)]
    warps = [cvgs.warp(imgs[i], mats[i], cvgs.Size(40, 40)) for i in range(4)]
    out = np.asarray(
        cvgs.execute_operations(
            cvgs.batch_read(warps, used_planes=3, default=7.0)
        )
    )
    for i in range(3):
        ref = cv2.warpAffine(imgs[i].astype(np.float32), mats[i], (40, 40))
        check_float(out[i], ref, tol=2e-2, msg=f"batch warp plane {i} (quantized oracle)")
        check_float(out[i], _np_warp_affine(imgs[i], mats[i], (40, 40)), tol=1e-4,
                    msg=f"batch warp plane {i} float ref")
    assert np.all(out[3] == 7.0)


def test_warp_batch_factory(rng):
    """One-call batched warp (cvGS::warp<WT,I,BATCH> overload family)."""
    imgs = rng.integers(0, 256, (3, 40, 40, 3)).astype(np.uint8)
    mats = [_affine_matrix(angle=5 * i, center=(20, 20), shift=(0, 0)) for i in range(3)]
    out = np.asarray(cvgs.execute_operations(
        cvgs.warp_batch(list(imgs), mats, cvgs.Size(40, 40),
                        used_planes=2, default=3.0)
    ))
    assert out.shape == (3, 40, 40, 3)
    check_float(out[1], _np_warp_affine(imgs[1], mats[1], (40, 40)), tol=1e-4,
                msg="warp_batch plane 1")
    assert np.all(out[2] == 3.0)


# --- affine maps once served by a separable-warp kernel, now by XLA -------


def test_pallas_warp_translation(rng):
    """The reference's own affine test class (pure translation,
    test_warping_opencv.cu:92-107)."""
    img = rng.integers(0, 256, (96, 128, 3)).astype(np.uint8)
    m = np.array([[1.0, 0.0, 17.0], [0.0, 1.0, -9.0]])
    out = np.asarray(cvgs.execute_operations(
        cvgs.warp(img, m, cvgs.Size(128, 96)),
        cvgs.multiply(0.5),
        cvgs.split_tensor(),
    ))
    assert out.shape == (3, 96, 128)
    ref = ref_warp(img, m, 128, 96) * np.float32(0.5)
    check_float(out, ref.transpose(2, 0, 1), msg="translation vs reference")


def test_pallas_warp_scale_translate_border(rng):
    """Axis-aligned scale + translation with a nonzero border value: samples
    off all four source edges."""
    img = rng.integers(0, 256, (64, 128, 3)).astype(np.uint8)
    m = np.array([[0.7, 0.0, -20.0], [0.0, 1.3, 30.0]])
    out = np.asarray(cvgs.execute_operations(
        cvgs.warp(img, m, cvgs.Size(128, 64), default=(9.0, 8.0, 7.0)),
        cvgs.split_tensor(),
    ))
    ref = ref_warp(img, m, 128, 64, border=(9.0, 8.0, 7.0))
    check_float(out, ref.transpose(2, 0, 1), msg="scale+translate+border")


def test_pallas_warp_matrix_values_reuse_program(rng):
    """Two matrices must produce the same pipeline treedef (values are
    runtime leaves — matrix changes never recompile)."""
    import jax as _jax

    img = rng.integers(0, 256, (64, 96, 3)).astype(np.uint8)
    pipes = [
        cvgs.build_pipeline(
            cvgs.warp(img, np.array([[1.0, 0.0, t], [0.0, 1.0, -t]]),
                      cvgs.Size(96, 64)),
            cvgs.split_tensor(),
        )
        for t in (3.0, 11.0)
    ]
    t0 = _jax.tree_util.tree_structure(pipes[0])
    t1 = _jax.tree_util.tree_structure(pipes[1])
    assert t0 == t1


def test_pallas_warp_fallbacks(rng):
    """Rotation and perspective maps through the same lowering."""
    img = rng.integers(0, 256, (64, 96, 3)).astype(np.uint8)
    rot = cv2.getRotationMatrix2D((48, 32), 15.0, 1.0)
    out = np.asarray(cvgs.execute_operations(
        cvgs.warp(img, rot, cvgs.Size(96, 64)), cvgs.split_tensor()))
    check_float(out, ref_warp(img, rot, 96, 64).transpose(2, 0, 1),
                msg="rotation vs reference")
    persp = np.array([[1.0, 0.02, 3.0], [0.01, 1.0, -2.0], [1e-4, 2e-4, 1.0]])
    out = np.asarray(cvgs.execute_operations(
        cvgs.warp(img, persp, cvgs.Size(96, 64),
                  warp_type=cvgs.WarpType.PERSPECTIVE),
        cvgs.split_tensor()))
    check_float(out, ref_warp(img, persp, 96, 64, perspective=True)
                .transpose(2, 0, 1), msg="perspective vs reference")


def test_pallas_warp_identity_upscale_band_tiles(rng):
    """A 2x upscale to a large output."""
    img = rng.integers(0, 256, (96, 256, 3)).astype(np.uint8)
    m = np.array([[2.0, 0.0, 5.0], [0.0, 2.0, 3.0]])  # forward 2x upscale
    out = np.asarray(cvgs.execute_operations(
        cvgs.warp(img, m, cvgs.Size(512, 192)),
        cvgs.convert_to(np.float32, alpha=1 / 255.0),
        cvgs.split_tensor(),
    ))
    ref = ref_warp(img, m, 512, 192) * np.float32(1 / 255.0)
    check_float(out, ref.transpose(2, 0, 1), msg="2x upscale vs reference")


def test_warp_batch_perspective(rng):
    """Batched perspective warps with per-plane homographies (the
    ``cvGS::warp<Perspective, I, BATCH>`` overload family,
    ``include/cvGPUSpeedup.cuh:381-442``)."""
    frame = rng.integers(0, 256, (64, 128, 3)).astype(np.uint8)
    src_pts = np.float32([[0, 0], [127, 0], [0, 63], [127, 63]])
    mats = []
    for i in range(4):
        dst_pts = np.float32([[2 + i, 1], [100 + i, 3], [1, 50], [104, 55 + i]])
        mats.append(cv2.getPerspectiveTransform(src_pts, dst_pts))
    out = np.asarray(cvgs.execute_operations(
        cvgs.warp_batch([frame] * 4, mats, cvgs.Size(64, 32),
                        warp_type=cvgs.WarpType.PERSPECTIVE),
        backend=cvgs.ParBackend.XLA,
    ))
    assert out.shape == (4, 32, 64, 3)
    for z in range(4):
        ref = cv2.warpPerspective(
            frame.astype(np.float32), mats[z], (64, 32),
            flags=cv2.INTER_LINEAR, borderMode=cv2.BORDER_CONSTANT,
            borderValue=0)
        check_float(out[z][2:-2, 2:-2], ref[2:-2, 2:-2], tol=1e-2,
                    msg=f"batched perspective z={z} interior")
