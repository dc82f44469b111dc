"""Single-image resize pipelines against cv2 and the numpy reference of
``chip_smoke.py`` (these cases once compared a Pallas frame kernel with XLA;
the kernel is gone and each now holds the XLA lowering to the reference) — ``cvGS::resize<T, INTER_LINEAR>(src, dsize)``
(``include/cvGPUSpeedup.cuh:209-216``) and the fused NV12 read of
``tests/resize/test_fused_resize.cu:121-143``.

The XLA lowering picks polyphase strided slices, dense matmuls or corner
gathers by ratio (``ops.resize.ResizeRead``); these cases reach each of
them: selection ratios, fractional ratios, upscales, multi-tile 1080p,
grayscale, split writes and the NV12/NV21 plane-space path.
"""

import cv2
import numpy as np
import pytest

import cvgpuspeedup_tpu as cvgs
from chip_smoke import check_u8, ref_nv12_to_rgb, ref_resize
from conftest import assert_backend, check_float


def _img(rng, h=96, w=384, c=3, dtype=np.uint8):
    return rng.integers(0, 256, (h, w, c)).astype(dtype)


def _run(ops):
    out = cvgs.execute_operations(*ops)
    assert_backend("xla")
    return out


def _cv2_resize(img, dsize):
    ref = cv2.resize(img.astype(np.float32), dsize, interpolation=cv2.INTER_LINEAR)
    return ref if ref.ndim == 3 else ref[..., None]


def test_supports_frame_pipeline(rng):
    """A plain frame resize + chain + planar split runs and is planar."""
    img = _img(rng)
    out = np.asarray(_run([
        cvgs.resize(cvgs.image(img), cvgs.Size(128, 32)),
        cvgs.multiply(0.5),
        cvgs.split_tensor(),
    ]))
    assert out.shape == (3, 32, 128)
    check_float(out, (_cv2_resize(img, (128, 32)) * 0.5).transpose(2, 0, 1),
                msg="frame pipeline vs cv2")


def test_exact_selection_ratio_bit_identical(rng):
    """3:1 downscale: pure row/column selection — the output is the source
    pixels themselves, so it matches the reference to the last bit."""
    img = _img(rng)
    out = np.asarray(_run([
        cvgs.resize(cvgs.image(img), cvgs.Size(128, 32)),
        cvgs.convert_to(np.float32),
        cvgs.split_tensor(),
    ]))
    assert out.shape == (3, 32, 128)
    np.testing.assert_array_equal(out, ref_resize(img, 128, 32).transpose(2, 0, 1))


def test_exact_fractional_dekker_bit_identical(rng):
    """264 -> 128 rows, 384 -> 64 columns: fractional weights."""
    img = _img(rng, h=264, w=384)
    out = np.asarray(_run([
        cvgs.resize(cvgs.image(img), cvgs.Size(64, 128)),
        cvgs.convert_to(np.float32, alpha=1 / 255.0),
        cvgs.split_tensor(),
    ]))
    check_float(out, (ref_resize(img, 64, 128) / 255.0).transpose(2, 0, 1),
                msg="fractional ratio vs reference")


def test_integer_output_exact(rng):
    img = _img(rng)
    out = np.asarray(_run([
        cvgs.resize(cvgs.image(img), cvgs.Size(128, 32)),
        cvgs.convert_to(np.uint8),
        cvgs.split_tensor(),
    ]))
    assert out.dtype == np.uint8
    check_u8("u8 frame resize", out, ref_resize(img, 128, 32).transpose(2, 0, 1))


def test_general_f32_regime_float_contract(rng):
    """Upscale by thirds (256 -> 384) vs cv2."""
    img = _img(rng, h=96, w=256)
    out = np.asarray(_run([
        cvgs.resize(cvgs.image(img), cvgs.Size(384, 144)),
        cvgs.multiply(0.25),
        cvgs.split_tensor(),
    ]))
    check_float(out, (_cv2_resize(img, (384, 144)) * 0.25).transpose(2, 0, 1),
                msg="upscale vs cv2")


def test_multiband_multitile(rng):
    """The 1080p -> 640x360 video shape."""
    img = _img(rng, h=1080, w=1920)
    out = np.asarray(_run([
        cvgs.resize(cvgs.image(img), cvgs.Size(640, 360)),
        cvgs.convert_to(np.float32, alpha=1 / 255.0),
        cvgs.subtract((0.485, 0.456, 0.406)),
        cvgs.divide((0.229, 0.224, 0.225)),
        cvgs.split_tensor(),
    ]))
    assert out.shape == (3, 360, 640)
    ref = (ref_resize(img, 640, 360) / 255.0 - np.array([0.485, 0.456, 0.406])) \
        / np.array([0.229, 0.224, 0.225])
    check_float(out, ref.transpose(2, 0, 1), msg="1080p normalize")


def test_split_write_layout(rng):
    img = _img(rng)
    out = _run([
        cvgs.resize(cvgs.image(img), cvgs.Size(128, 32)),
        cvgs.multiply(2.0),
        cvgs.split(),
    ])
    ref = ref_resize(img, 128, 32) * 2.0
    assert len(out) == 3
    for c, oc in enumerate(out):
        check_float(np.asarray(oc), ref[..., c], msg=f"split ch{c}")


def test_grayscale(rng):
    img = rng.integers(0, 256, (96, 384, 1)).astype(np.uint8)
    out = np.asarray(_run([
        cvgs.resize(cvgs.image(img), cvgs.Size(128, 32)),
        cvgs.multiply(3.0),
        cvgs.split_tensor(),
    ]))
    assert out.shape == (1, 32, 128)
    check_float(out, (_cv2_resize(img, (128, 32)) * 3.0).transpose(2, 0, 1),
                msg="grayscale vs cv2")


def test_nv12_fused_read_bit_identical(rng):
    """NV12 plane-space resize: Y at full resolution, UV at half with
    full-resolution tap math, then the BT.709 conversion."""
    buf = rng.integers(0, 256, (1620, 1920)).astype(np.uint8)
    out = np.asarray(_run([
        cvgs.resize(
            cvgs.fuse(
                cvgs.read_yuv(buf),
                cvgs.convert_yuv_to_rgb(
                    standard=cvgs.ColorStandard.BT709, out_dtype=np.float32
                ),
            ),
            cvgs.Size(640, 360),
        ),
        cvgs.multiply(1 / 255.0),
        cvgs.split_tensor(),
    ]))
    assert out.shape == (3, 360, 640)
    ref = ref_resize(ref_nv12_to_rgb(buf, "bt709"), 640, 360) / 255.0
    check_float(out, ref.transpose(2, 0, 1), msg="NV12 BT.709 resize")


def test_nv21_limited_alpha(rng):
    buf = rng.integers(0, 256, (1620, 1920)).astype(np.uint8)
    out = np.asarray(_run([
        cvgs.resize(
            cvgs.fuse(
                cvgs.read_yuv(buf, pixel_format=cvgs.PixelFormat.NV21),
                cvgs.convert_yuv_to_rgb(
                    standard=cvgs.ColorStandard.BT601,
                    color_range=cvgs.ColorRange.LIMITED,
                    alpha=True,
                    out_dtype=np.float32,
                ),
            ),
            cvgs.Size(640, 360),
        ),
        cvgs.split_tensor(),
    ]))
    assert out.shape == (4, 360, 640)
    assert np.all(out[3] == 1.0)
    ref = ref_resize(ref_nv12_to_rgb(buf, "bt601", limited=True, nv21=True),
                     640, 360)
    check_float(out[:3], ref.transpose(2, 0, 1),
                msg="NV21 limited resize")


def test_fallbacks():
    """Frame shapes that were once outside a kernel's alignment grain (odd
    widths, odd heights, packed writes) run like any other."""
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (95, 200, 3)).astype(np.uint8)
    out = np.asarray(_run([cvgs.resize(cvgs.image(img), cvgs.Size(64, 32)),
                           cvgs.split_tensor()]))
    check_float(out, _cv2_resize(img, (64, 32)).transpose(2, 0, 1),
                msg="odd frame vs cv2")
    out = np.asarray(_run([cvgs.resize(cvgs.image(img), cvgs.Size(64, 32))]))
    check_float(out, _cv2_resize(img, (64, 32)), msg="packed write vs cv2")


def test_oracle_parity_cv2(rng):
    """End to end vs the cv2 oracle: resize + normalize, float contract."""
    img = _img(rng, h=96, w=384)
    out = np.asarray(_run([
        cvgs.resize(cvgs.image(img), cvgs.Size(128, 32)),
        cvgs.convert_to(np.float32, alpha=1 / 255.0),
        cvgs.split_tensor(),
    ]))
    ref = _cv2_resize(img, (128, 32)) * np.float32(1 / 255.0)
    check_float(out, np.transpose(ref, (2, 0, 1)), msg="frame resize vs cv2")


def test_auto_gate_small_frame_not_profitable(rng):
    """A tiny frame and the 6K NV12 frame both run the XLA lowering under
    AUTO; the tiny one is checked against cv2."""
    small = rng.integers(0, 256, (128, 128, 3)).astype(np.uint8)
    out = np.asarray(cvgs.execute_operations(
        cvgs.resize(cvgs.image(small), cvgs.Size(64, 128)),
        cvgs.convert_to(np.float32, alpha=1 / 255.0),
        cvgs.split_tensor(),
        backend=cvgs.ParBackend.AUTO,
    ))
    assert_backend("xla")
    check_float(out, (_cv2_resize(small, (64, 128)) / 255.0).transpose(2, 0, 1),
                msg="small frame vs cv2")


@pytest.mark.parametrize("dsize", [(320, 40), (97, 111), (384, 96)])
def test_w3_fractional_ratio_regime(rng, dsize):
    """Fractional 3.2:1 downscale (polyphase), a prime-ish size with too many
    phases (dense matmul), and an identity size."""
    img = _img(rng, h=128, w=1024) if dsize != (384, 96) else _img(rng)
    out = np.asarray(_run([
        cvgs.resize(cvgs.image(img), cvgs.Size(*dsize)),
        cvgs.multiply(np.float32(1 / 255.0)),
        cvgs.split_tensor(),
    ]))
    ref = ref_resize(img, *dsize) * np.float32(1 / 255.0)
    check_float(out, ref.transpose(2, 0, 1), msg=f"resize to {dsize}")
