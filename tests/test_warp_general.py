"""General-affine (rotation/shear) warps against the numpy warp reference
of ``chip_smoke.py`` (the reference fuses arbitrary affine maps into its one
kernel: ``include/cvGPUSpeedup.cuh:285-442``,
``tests/warping/test_warping_opencv.cu:139-271``).

The reference recomputes every coordinate with the float32 operations of
``decompose_inverse_map``, so taps and fractions agree with the device
bit for bit; what remains is lerp rounding, far inside the 1e-4 contract.
"""

import cv2
import numpy as np
import pytest

import cvgpuspeedup_tpu as cvgs
from chip_smoke import ref_warp
from conftest import check_float


def _pipe(img, m, dsize, extra=(), write=None, **kw):
    ops = [cvgs.warp(img, m, dsize, **kw), *extra,
           write if write is not None else cvgs.split_tensor()]
    return ops, cvgs.build_pipeline(*ops)


def _parity(ops, ref, tol=1e-4):
    """``ref``: (H, W, C) reference of the whole chain."""
    out = cvgs.execute_operations(*ops)
    if isinstance(out, tuple):
        out = np.stack([np.asarray(o) for o in out])
    check_float(np.asarray(out), np.asarray(ref).transpose(2, 0, 1), tol=tol,
                msg="warp vs reference")


@pytest.mark.parametrize("angle", [10.0, -7.5, 3.0])
def test_rotation_parity(rng, angle):
    img = rng.integers(0, 256, (288, 768, 3)).astype(np.uint8)
    m = cv2.getRotationMatrix2D((384, 144), angle, 1 / 3.0)
    ops, pipe = _pipe(img, m, cvgs.Size(128, 96))
    _parity(ops, ref_warp(img, m, 128, 96))


def test_rotation_with_chain_and_border(rng):
    # heavy border coverage: half the output falls outside the source
    img = rng.integers(0, 256, (96, 384, 3)).astype(np.uint8)
    m = cv2.getRotationMatrix2D((50, 20), 12.0, 0.25)
    ops, pipe = _pipe(
        img, m, cvgs.Size(128, 96),
        extra=(cvgs.multiply((2.0, 0.5, 1.0)), cvgs.subtract(3.0)),
        default=17.0,
    )
    ref = ref_warp(img, m, 128, 96, border=17.0) * np.float32([2.0, 0.5, 1.0])
    _parity(ops, ref - np.float32(3.0))


def test_shear_only_horizontal(rng):
    # forward shear in x => inverse has b != 0, d == 0
    img = rng.integers(0, 256, (160, 512, 3)).astype(np.uint8)
    m = np.array([[1 / 3.0, 0.12, 5.0], [0.0, 1 / 2.0, -2.0]], np.float64)
    inv_like = np.linalg.inv(np.vstack([m, [0, 0, 1]]))[:2]
    assert abs(inv_like[0, 1]) > 0
    ops, pipe = _pipe(img, m, cvgs.Size(96, 64))
    _parity(ops, ref_warp(img, m, 96, 64))


def test_shear_only_vertical(rng):
    # forward shear in y => inverse has d != 0, b == 0
    img = rng.integers(0, 256, (160, 512, 3)).astype(np.uint8)
    m = np.array([[1 / 3.0, 0.0, 1.0], [0.08, 1 / 2.0, 0.0]], np.float64)
    ops, pipe = _pipe(img, m, cvgs.Size(96, 64))
    _parity(ops, ref_warp(img, m, 96, 64))


def test_single_channel_and_split_write(rng):
    img = rng.integers(0, 256, (288, 768)).astype(np.uint8)
    m = cv2.getRotationMatrix2D((300, 100), -15.0, 1 / 4.0)
    ops, pipe = _pipe(img, m, cvgs.Size(128, 64),
                      write=cvgs.split())
    _parity(ops, ref_warp(img, m, 128, 64))


def test_four_channel(rng):
    img = rng.integers(0, 256, (96, 320, 4)).astype(np.uint8)
    m = cv2.getRotationMatrix2D((160, 48), 8.0, 1 / 3.0)
    ops, pipe = _pipe(img, m, cvgs.Size(64, 48))
    _parity(ops, ref_warp(img, m, 64, 48))


def test_vertical_upscale_rotation(rng):
    # vertical upscale with rotation
    img = rng.integers(0, 256, (64, 512, 3)).astype(np.uint8)
    m = np.array([[1 / 3.0, -0.05, 8.0], [0.10, 1.6, 2.0]], np.float64)
    ops, pipe = _pipe(img, m, cvgs.Size(96, 64))
    _parity(ops, ref_warp(img, m, 96, 64))


def test_out_of_class_falls_back(rng):
    """An upscaling rotation and a separable map take the same lowering as
    any other affine map and agree with the reference."""
    img = rng.integers(0, 256, (96, 384, 3)).astype(np.uint8)
    m_up = cv2.getRotationMatrix2D((100, 40), 10.0, 1.2)
    ops, _ = _pipe(img, m_up, cvgs.Size(64, 64))
    _parity(ops, ref_warp(img, m_up, 64, 64))
    m_sep = np.array([[0.4, 0.0, 3.0], [0.0, 0.5, 1.0]], np.float64)
    ops, _ = _pipe(img, m_sep, cvgs.Size(64, 64))
    _parity(ops, ref_warp(img, m_sep, 64, 64))


def test_cv2_oracle_quantized(rng):
    """End-to-end vs cv2 itself (2e-2: cv2 quantizes coords to 1/32 px)."""
    img = rng.integers(0, 256, (288, 768, 3)).astype(np.uint8)
    m = cv2.getRotationMatrix2D((384, 144), 10.0, 1 / 3.0)
    ops, pipe = _pipe(img, m, cvgs.Size(128, 96))
    out = np.asarray(cvgs.execute_operations(*ops))
    ref = cv2.warpAffine(img.astype(np.float32), m, (128, 96)).transpose(2, 0, 1)
    check_float(out, ref, tol=2e-2, msg="general warp vs cv2 (quantized)")


def test_describe_backend_reports_general(rng):
    """A rotation runs the XLA lowering, as ``last_backend`` reports."""
    from conftest import assert_backend

    img = rng.integers(0, 256, (288, 768, 3)).astype(np.uint8)
    m = cv2.getRotationMatrix2D((384, 144), 10.0, 1 / 3.0)
    cvgs.execute_operations(cvgs.warp(img, m, cvgs.Size(128, 96)),
                            cvgs.split_tensor())
    assert_backend("xla")
