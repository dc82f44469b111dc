"""Upscaling, flipping and perspective warps, single and batched, against the
numpy warp reference of ``chip_smoke.py`` (the reference's one kernel covers
them all: ``include/cvGPUSpeedup.cuh:285-442``, perspective validated at
``tests/warping/test_warping_opencv.cu:185-270``)."""

import cv2
import numpy as np

import cvgpuspeedup_tpu as cvgs
from chip_smoke import ref_warp
from conftest import assert_backend, check_float


def _pipe(img, m, dsize, extra=(), wt=cvgs.WarpType.AFFINE, **kw):
    ops = [cvgs.warp(img, m, dsize, warp_type=wt, **kw), *extra,
           cvgs.split_tensor()]
    return ops, cvgs.build_pipeline(*ops)


def _parity(ops, ref, tol=1e-4):
    """``ref``: (H, W, C) reference of the whole chain."""
    out = np.asarray(cvgs.execute_operations(*ops))
    check_float(out, np.asarray(ref).transpose(2, 0, 1), tol=tol,
                msg="warp vs reference")


def _persp(dst_pts, src_w=384, src_h=96):
    src = np.float32([[0, 0], [src_w - 1, 0], [0, src_h - 1],
                      [src_w - 1, src_h - 1]])
    return cv2.getPerspectiveTransform(src, np.float32(dst_pts))


def test_upscale_rotation_parity(rng):
    img = rng.integers(0, 256, (96, 384, 3)).astype(np.uint8)
    m = cv2.getRotationMatrix2D((100, 40), 10.0, 1.2)
    ops, _ = _pipe(img, m, cvgs.Size(128, 64))
    _parity(ops, ref_warp(img, m, 128, 64))


def test_horizontal_flip_parity(rng):
    img = rng.integers(0, 256, (96, 384, 3)).astype(np.uint8)
    m = np.array([[-0.5, 0.0, 90.0], [0.0, 0.5, 2.0]], np.float64)
    ops, _ = _pipe(img, m, cvgs.Size(64, 32))
    _parity(ops, ref_warp(img, m, 64, 32))


def test_vertical_flip_parity(rng):
    img = rng.integers(0, 256, (96, 384, 3)).astype(np.uint8)
    m = np.array([[0.5, 0.02, 3.0], [0.01, -0.5, 80.0]], np.float64)
    ops, _ = _pipe(img, m, cvgs.Size(64, 32))
    _parity(ops, ref_warp(img, m, 64, 32))


def test_perspective_parity(rng):
    img = rng.integers(0, 256, (96, 384, 3)).astype(np.uint8)
    m = _persp([[5, 3], [120, 8], [2, 60], [125, 62]])
    ops, _ = _pipe(img, m, cvgs.Size(128, 64), wt=cvgs.WarpType.PERSPECTIVE)
    _parity(ops, ref_warp(img, m, 128, 64, perspective=True))


def test_perspective_vs_cv2_interior(rng):
    img = rng.integers(0, 256, (96, 384, 3)).astype(np.uint8)
    m = _persp([[5, 3], [120, 8], [2, 60], [125, 62]])
    ops, _ = _pipe(img, m, cvgs.Size(128, 64), wt=cvgs.WarpType.PERSPECTIVE)
    out = np.asarray(cvgs.execute_operations(*ops))
    ref = cv2.warpPerspective(
        img.astype(np.float32), m, (128, 64), flags=cv2.INTER_LINEAR,
        borderMode=cv2.BORDER_CONSTANT, borderValue=0,
    ).transpose(2, 0, 1)
    # border ring is EXPECTED_FAIL territory in the reference
    # (test_warping_opencv.cu:268-270); the interior must track cv2's
    # 1/32-px-quantized sampler
    check_float(out[:, 2:-2, 2:-2], ref[:, 2:-2, 2:-2], tol=2e-2,
                msg="perspective vs cv2 interior")


def test_chain_and_border(rng):
    img = rng.integers(0, 256, (96, 384, 3)).astype(np.uint8)
    m = cv2.getRotationMatrix2D((50, 20), 12.0, 1.5)
    ops, _ = _pipe(
        img, m, cvgs.Size(128, 64),
        extra=(cvgs.multiply((2.0, 0.5, 1.0)), cvgs.subtract(3.0)),
        default=17.0,
    )
    ref = ref_warp(img, m, 128, 64, border=17.0) * np.float32([2.0, 0.5, 1.0])
    _parity(ops, ref - np.float32(3.0))


def test_single_channel_split_write(rng):
    img = rng.integers(0, 256, (96, 384)).astype(np.uint8)
    m = cv2.getRotationMatrix2D((150, 40), -8.0, 1.3)
    out = cvgs.execute_operations(cvgs.warp(img, m, cvgs.Size(128, 64)),
                                  cvgs.split())
    assert len(out) == 1
    check_float(np.asarray(out[0]), ref_warp(img, m, 128, 64)[..., 0],
                msg="single channel split")


def test_matrix_jitter_reuses_program(rng):
    """Matrix values are runtime leaves: a different matrix must not change
    the pytree structure (no recompile)."""
    import jax

    img = rng.integers(0, 256, (96, 384, 3)).astype(np.uint8)
    m1 = cv2.getRotationMatrix2D((100, 40), 10.0, 1.2)
    m2 = cv2.getRotationMatrix2D((101, 41), 35.2, 0.41)
    _, p1 = _pipe(img, m1, cvgs.Size(128, 64))
    _, p2 = _pipe(img, m2, cvgs.Size(128, 64))
    assert jax.tree_util.tree_structure(p1) == jax.tree_util.tree_structure(p2)


def test_describe_backend_reports_universal(rng):
    img = rng.integers(0, 256, (96, 384, 3)).astype(np.uint8)
    m = cv2.getRotationMatrix2D((100, 40), 10.0, 1.2)
    cvgs.execute_operations(cvgs.warp(img, m, cvgs.Size(128, 64)),
                            cvgs.split_tensor())
    assert_backend("xla")


def test_out_of_class_rejects(rng):
    """A homography whose denominator crosses zero inside the output runs
    (the zero denominator is replaced by 1) and yields finite values."""
    img = rng.integers(0, 256, (96, 384, 3)).astype(np.uint8)
    m = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [-0.2, 0.0, 1.0]])
    ops, _ = _pipe(img, m, cvgs.Size(128, 64), wt=cvgs.WarpType.PERSPECTIVE)
    out = np.asarray(cvgs.execute_operations(*ops))
    assert out.shape == (3, 64, 128) and np.isfinite(out).all()


def test_ragged_band_heights(rng):
    """Output heights with no power-of-two factor."""
    img = rng.integers(0, 256, (96, 384, 3)).astype(np.uint8)
    m = cv2.getRotationMatrix2D((100, 40), 10.0, 1.2)
    for h in (60, 44, 52):
        ops, _ = _pipe(img, m, cvgs.Size(128, h))
        _parity(ops, ref_warp(img, m, 128, h))


def test_sy_endpoint_rounding_regression(rng):
    """Homography whose bottom output rows map to source row ~95 everywhere:
    the float32 coordinate rounds to either side of the last row, and the
    border rule must follow the rounded value exactly."""
    img = rng.integers(0, 256, (96, 384, 3)).astype(np.uint8)
    m = _persp([[6, 3], [119, 8], [2, 61], [125, 61]])
    ops, _ = _pipe(img, m, cvgs.Size(128, 64), wt=cvgs.WarpType.PERSPECTIVE)
    _parity(ops, ref_warp(img, m, 128, 64, perspective=True))


# --- batched warp (cvGS::warp<WT, I, BATCH>, one program) ------------------


def test_warp_batch_kernel_affine_ragged(rng):
    """Per-image affine matrices + ragged used_planes + default in one
    program (reference ``include/cvGPUSpeedup.cuh:381-442``,
    ``tests/warping/test_warping_opencv.cu:157-247``)."""
    imgs = [rng.integers(0, 256, (96, 384, 3)).astype(np.uint8)
            for _ in range(6)]
    mats = [cv2.getRotationMatrix2D((192, 48), 7.0 * i - 15, 1.0 + 0.1 * i)
            for i in range(6)]
    out = np.asarray(cvgs.execute_operations(
        cvgs.warp_batch(imgs, mats, cvgs.Size(128, 64), used_planes=5,
                        default=7.0, border_value=(1.0, 2.0, 3.0)),
        cvgs.multiply(0.5),
        cvgs.split_tensor(),
    ))
    assert out.shape == (6, 3, 64, 128)
    for z in range(5):
        ref = ref_warp(imgs[z], mats[z], 128, 64, border=(1.0, 2.0, 3.0))
        check_float(out[z], (ref * np.float32(0.5)).transpose(2, 0, 1),
                    msg=f"batched warp plane {z}")
    # ragged plane: the default through the chain
    assert np.all(out[5] == 3.5)


def test_warp_batch_kernel_perspective(rng):
    imgs = [rng.integers(0, 256, (96, 384, 3)).astype(np.uint8)
            for _ in range(4)]
    pms = [_persp([[5 + i, 3], [120 - i, 8], [2, 60 + i], [125, 62 - i]])
           for i in range(4)]
    out = np.asarray(cvgs.execute_operations(
        cvgs.warp_batch(imgs, pms, cvgs.Size(128, 64),
                        warp_type=cvgs.WarpType.PERSPECTIVE),
        cvgs.split_tensor(),
    ))
    for z in range(4):
        check_float(out[z], ref_warp(imgs[z], pms[z], 128, 64,
                                     perspective=True).transpose(2, 0, 1),
                    msg=f"batched perspective plane {z}")


def test_warp_batch_mixed_classes_one_kernel(rng):
    """A batch mixing a translation with rotations is one program."""
    imgs = [rng.integers(0, 256, (96, 384, 3)).astype(np.uint8)
            for _ in range(4)]
    mats = [np.array([[1.0, 0.0, 5.0], [0.0, 1.0, 3.0]])] + [
        cv2.getRotationMatrix2D((192, 48), 7.0 * i, 1.1) for i in range(1, 4)]
    out = np.asarray(cvgs.execute_operations(
        cvgs.warp_batch(imgs, mats, cvgs.Size(128, 64)), cvgs.split_tensor()))
    for z in range(4):
        check_float(out[z], ref_warp(imgs[z], mats[z], 128, 64).transpose(2, 0, 1),
                    msg=f"mixed-class plane {z}")


def test_describe_backend_reports_batch(rng):
    imgs = [rng.integers(0, 256, (96, 384, 3)).astype(np.uint8)
            for _ in range(3)]
    mats = [cv2.getRotationMatrix2D((192, 48), 5.0 * i, 1.1) for i in range(3)]
    cvgs.execute_operations(cvgs.warp_batch(imgs, mats, cvgs.Size(128, 64)),
                            cvgs.split_tensor())
    assert_backend("xla")
