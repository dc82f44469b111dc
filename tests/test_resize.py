"""Resize parity vs cv2 INTER_LINEAR — the ``tests/resize/`` analog
(reference ``test_resize_write.cu:55-72``, ``test_resize_x_split.cu:79-97``).

cv2 CPU uses fixed-point arithmetic for uint8 inputs but plain float for
float32 inputs; the reference engine (and ours) always interpolates in float32
(resize emits float, ``include/cvGPUSpeedup.cuh:227``). The oracle therefore
feeds cv2 the input cast to float32 — identical math, matching the reference's
GPU-float-vs-GPU-float comparison.
"""

import cv2
import numpy as np
import pytest

import cvgpuspeedup_tpu as cvgs
from conftest import check_exact, check_float


def _cv_resize_f32(img, dsize):
    return cv2.resize(
        img.astype(np.float32), dsize, interpolation=cv2.INTER_LINEAR
    ).reshape((dsize[1], dsize[0]) + img.shape[2:])


@pytest.mark.parametrize("src_wh,dst_wh", [
    ((64, 128), (32, 64)),    # 2x down
    ((64, 128), (128, 256)),  # 2x up
    ((60, 120), (64, 128)),   # non-integer up (flagship geometry)
    ((61, 37), (97, 53)),     # odd everything
    ((200, 100), (64, 128)),  # anisotropic
])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_resize_vs_cv2(rng, src_wh, dst_wh, channels):
    img = rng.integers(0, 256, (src_wh[1], src_wh[0], channels)).astype(np.uint8)
    out = np.asarray(
        cvgs.execute_operations(cvgs.resize(img, cvgs.Size(*dst_wh)))
    )
    assert out.dtype == np.float32  # resize always emits float
    ref = _cv_resize_f32(img, dst_wh)
    check_float(out, ref, msg=f"resize {src_wh}->{dst_wh} c{channels}")


def test_resize_then_cast_bit_exact(rng):
    """resize -> convertTo(u8): integer outputs bit-exact vs cv2-float+cvRound."""
    img = rng.integers(0, 256, (100, 80, 3)).astype(np.uint8)
    out = np.asarray(
        cvgs.execute_operations(
            cvgs.resize(img, cvgs.Size(64, 128)), cvgs.convert_to(np.uint8)
        )
    )
    ref = _cv_resize_f32(img, (64, 128))
    ref_u8 = np.clip(np.rint(ref), 0, 255).astype(np.uint8)
    check_exact(out, ref_u8, "resize+saturate_cast")


def test_resize_float_input(rng):
    img = (rng.random((50, 70, 3), dtype=np.float32) * 255).astype(np.float32)
    out = np.asarray(cvgs.execute_operations(cvgs.resize(img, cvgs.Size(33, 44))))
    check_float(out, _cv_resize_f32(img, (33, 44)), msg="float resize")


def test_crop_then_resize_then_split(rng):
    """crop -> resize -> normalize -> split, the fused-read composition
    (reference ``test_resize_x_split.cu:79-97``)."""
    frame = rng.integers(0, 256, (216, 384, 3)).astype(np.uint8)
    rect = cvgs.Rect(17, 23, 60, 120)
    out = np.asarray(
        cvgs.execute_operations(
            cvgs.resize(cvgs.crop(frame, rect), cvgs.Size(64, 128)),
            cvgs.multiply(0.5),
            cvgs.split_tensor(),
        )
    )
    crop = frame[23 : 23 + 120, 17 : 17 + 60]
    ref = _cv_resize_f32(crop, (64, 128)) * np.float32(0.5)
    check_float(out, ref.transpose(2, 0, 1), msg="crop->resize->mul->split")


def test_crop_identity(rng):
    frame = rng.integers(0, 256, (64, 64, 3)).astype(np.uint8)
    out = np.asarray(
        cvgs.execute_operations(cvgs.crop(frame, cvgs.Rect(5, 9, 20, 30)))
    )
    check_exact(out, frame[9:39, 5:25], "plain crop")


def test_resize_fused_backop(rng):
    """resize over a fused (read+compute) virtual image — the
    "ComputeWhatYouSee" pattern (reference ``test_fused_resize.cu:73-77``)."""
    frame = rng.integers(0, 256, (90, 120, 3)).astype(np.uint8)
    virtual = cvgs.fuse(cvgs.image(frame), cvgs.vector_reorder(2, 1, 0))
    out = np.asarray(
        cvgs.execute_operations(cvgs.resize(virtual, cvgs.Size(60, 45)))
    )
    ref = _cv_resize_f32(frame[..., ::-1], (60, 45))
    check_float(out, ref, msg="resize over fused read")


@pytest.mark.parametrize("src_wh,dst_wh", [
    ((64, 128), (32, 64)),     # Q=1 integer down
    ((32, 16), (64, 48)),      # integer up
    ((60, 120), (64, 128)),    # Q=16
    ((200, 100), (64, 128)),   # Qx=8, Qy mixed
    ((48, 48), (36, 60)),      # Q=3 down / Q=5 up (odd mixes)
])
def test_polyphase_matches_gather_path(rng, src_wh, dst_wh):
    """The strided-slice polyphase lowering must match the corner-gather
    lowering (same rational weights, same lerp association) to float
    tolerance on every ratio class."""
    from cvgpuspeedup_tpu.ops import resize as rz
    img = rng.integers(0, 256, (src_wh[1], src_wh[0], 3)).astype(np.uint8)
    out_poly = np.asarray(cvgs.execute_operations(cvgs.resize(img, cvgs.Size(*dst_wh))))
    # force the gather path by dropping the phase cap
    old = rz._MAX_PHASES
    rz._MAX_PHASES = 0
    try:
        from cvgpuspeedup_tpu.exec import executor
        executor.clear_cache()
        out_gather = np.asarray(cvgs.execute_operations(cvgs.resize(img, cvgs.Size(*dst_wh))))
        executor.clear_cache()
    finally:
        rz._MAX_PHASES = old
    check_float(out_poly, out_gather, tol=1e-4, msg=f"polyphase vs gather {src_wh}->{dst_wh}")


@pytest.mark.parametrize("src_wh,dst_wh", [
    ((1920, 1080), (97, 111)),   # prime dst dims: 97/37 phases
    ((640, 480), (97, 111)),     # coprime-ish ratios both axes
])
@pytest.mark.parametrize("channels", [1, 3])
def test_resize_matmul_path_vs_cv2(rng, src_wh, dst_wh, channels):
    """Ratios beyond the polyphase cap lower to dense matmuls; weights
    use the identical axis_lerp taps so parity holds at the same tolerance."""
    from cvgpuspeedup_tpu.ops import resize as resize_mod
    import math
    qx = dst_wh[0] // math.gcd(src_wh[0], dst_wh[0])
    qy = dst_wh[1] // math.gcd(src_wh[1], dst_wh[1])
    assert max(qx, qy) > resize_mod._MAX_PHASES, "geometry must hit the matmul path"
    img = rng.integers(0, 256, (src_wh[1], src_wh[0], channels)).astype(np.uint8)
    out = np.asarray(
        cvgs.execute_operations(cvgs.resize(img, cvgs.Size(*dst_wh)))
    )
    check_float(out, _cv_resize_f32(img, dst_wh),
                msg=f"matmul resize {src_wh}->{dst_wh} c{channels}")


def test_resize_matmul_then_cast(rng):
    """Integer outputs through the matmul path: the split single-tap weight
    matrices reproduce the exact lerp products, so any deviation from the
    cv2-float-then-round oracle can only be a .5 rounding tie where cv2's own
    float value drifts ~1 ulp (same contract as the fused NV12 resize test)."""
    img = rng.integers(0, 256, (480, 640, 3)).astype(np.uint8)
    out = np.asarray(
        cvgs.execute_operations(
            cvgs.resize(img, cvgs.Size(97, 111)), cvgs.convert_to(np.uint8)
        )
    )
    ref = _cv_resize_f32(img, (97, 111))
    ref_u8 = np.clip(np.rint(ref), 0, 255).astype(np.uint8)
    diff = np.abs(out.astype(np.int32) - ref_u8.astype(np.int32))
    assert (diff > 1).sum() == 0, f"non-tie mismatches: {(diff > 1).sum()}"
    # every 1-lsb difference must sit on a genuine .5 tie of the oracle float
    ties = diff == 1
    assert np.all(np.abs(ref[ties] - (np.floor(ref[ties]) + 0.5)) < 1e-4)
