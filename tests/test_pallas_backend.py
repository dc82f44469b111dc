"""The flagship batched resize against the numpy reference of
``chip_smoke.py`` (and cv2 where it has the same semantics). These cases
once compared a Pallas kernel with XLA; the kernel is gone (``PERF.md``), and
each case now holds the XLA lowering to the reference.

Covers what the reference's batch-resize tests sweep
(``tests/batchresize/test_batchresize_x_split3D.cu``,
``test_batchresize_aspectratio_x_split3D.cu``): aspect-ratio modes, channel
counts, source dtypes, ragged planes, output sizes that are not powers of
two, rects at the frame edges, every write layout, and chains with casts,
swizzles and GRAY — float outputs within 1e-4 per pixel, integer outputs
bit-exact except on a .5 rounding edge.
"""

import cv2
import numpy as np
import pytest

import cvgpuspeedup_tpu as cvgs
from chip_smoke import (PhaseFailed, check_u8, ref_batch_resize, ref_letterbox,
                        ref_resize)
from conftest import check_exact, check_float

UP = (64, 128)
MEAN = np.array([3.2, 0.6, 11.8])


def _frame(rng, h=296, w=384, c=3, dtype=np.uint8):
    return rng.integers(0, 256, (h, w, c)).astype(dtype)


def _rects(batch, cw=60, ch=120):
    return np.array([[i * 2, i, cw - (i % 7), ch - (i % 5)] for i in range(batch)], np.int32)


def _fit(mode, w, h, dst_w, dst_h):
    """Fitted sub-rect of every aspect-ratio mode, from the reference's
    PRESERVE_AR rule."""
    if mode == cvgs.AspectRatio.IGNORE_AR:
        return dst_w, dst_h, 0, 0
    nw, nh, ox, oy = ref_letterbox(w, h, dst_w, dst_h, preserve=True)
    if mode == cvgs.AspectRatio.PRESERVE_AR_RN_EVEN:
        nw = min(((nw + 1) // 2) * 2, dst_w)
        nh = min(((nh + 1) // 2) * 2, dst_h)
        ox, oy = (dst_w - nw) // 2, (dst_h - nh) // 2
    if mode == cvgs.AspectRatio.PRESERVE_AR_LEFT:
        ox = oy = 0
    return nw, nh, ox, oy


def _ref(frame, rects, mode=cvgs.AspectRatio.IGNORE_AR, dsize=UP,
         background=0.0, used=None):
    """(N, H, W, C) float64 reference for any aspect-ratio mode."""
    frame = frame if frame.ndim == 3 else frame[..., None]
    dst_w, dst_h = dsize
    n, c = len(rects), frame.shape[-1]
    out = np.empty((n, dst_h, dst_w, c))
    out[:] = np.broadcast_to(np.asarray(background, np.float64), (c,))
    for z in range(n if used is None else used):
        x, y, w, h = (int(v) for v in rects[z])
        nw, nh, ox, oy = _fit(mode, w, h, dst_w, dst_h)
        out[z, oy:oy + nh, ox:ox + nw] = ref_resize(frame[y:y + h, x:x + w], nw, nh)
    return out


def _flagship_chain(ref):
    return ((ref * 0.3 - MEAN) / 128.0).transpose(0, 3, 1, 2)


def test_flagship_parity_tensor_split(rng):
    frame = _frame(rng)
    rects = _rects(6)
    out = np.asarray(cvgs.execute_operations(
        cvgs.resize_batch(frame, rects=rects, dsize=cvgs.Size(*UP),
                          used_planes=5, background=128.0),
        cvgs.convert_to(np.float32, alpha=0.3),
        cvgs.subtract((3.2, 0.6, 11.8)),
        cvgs.divide((128.0, 128.0, 128.0)),
        cvgs.split_tensor(),
    ))
    assert out.shape == (6, 3, UP[1], UP[0])
    check_float(out, _flagship_chain(_ref(frame, rects, background=128.0, used=5)),
                msg="flagship vs reference")
    # the chip-smoke reference agrees with the test-side one
    check_float(out, _flagship_chain(
        ref_batch_resize(frame, rects, *UP, background=128.0, used=5)),
        msg="flagship vs chip_smoke reference")


def test_flagship_parity_u8_output(rng):
    frame = _frame(rng)
    rects = _rects(3)
    out = np.asarray(cvgs.execute_operations(
        cvgs.resize_batch(frame, rects=rects, dsize=cvgs.Size(*UP)),
        cvgs.convert_to(np.uint8),
        cvgs.split_tensor(),
    ))
    assert out.dtype == np.uint8
    check_u8("u8 flagship", out, _ref(frame, rects).transpose(0, 3, 1, 2))


@pytest.mark.parametrize("mode", [
    cvgs.AspectRatio.PRESERVE_AR,
    cvgs.AspectRatio.PRESERVE_AR_LEFT,
    cvgs.AspectRatio.PRESERVE_AR_RN_EVEN,
])
def test_letterbox_parity(rng, mode):
    frame = _frame(rng)
    rects = _rects(5, cw=30, ch=120)
    out = np.asarray(cvgs.execute_operations(
        cvgs.resize_batch(frame, rects=rects, dsize=cvgs.Size(*UP),
                          background=99.0, aspect_ratio=mode),
    ))
    check_float(out, _ref(frame, rects, mode, background=99.0),
                msg=f"letterbox {mode.name}")


def test_stack_mode_parity(rng):
    imgs = [_frame(rng, 100, 50), _frame(rng, 80, 120), _frame(rng, 37, 61)]
    out = np.asarray(cvgs.execute_operations(
        cvgs.resize_batch(imgs, dsize=cvgs.Size(32, 32)),
        cvgs.multiply(2.0),
        cvgs.split_tensor(),
    ))
    for z, im in enumerate(imgs):
        check_float(out[z], (ref_resize(im, 32, 32) * 2.0).transpose(2, 0, 1),
                    msg=f"stack plane {z}")


def test_chain_with_swizzle_and_gray(rng):
    frame = _frame(rng)
    rects = _rects(3)
    ops = lambda *tail: [
        cvgs.resize_batch(frame, rects=rects, dsize=cvgs.Size(*UP)),
        cvgs.convert_to(np.uint8), *tail,
    ]
    rgb = np.asarray(cvgs.execute_operations(*ops(cvgs.write_tensor())))
    gray = np.asarray(cvgs.execute_operations(*ops(
        cvgs.cvt_color(cvgs.ColorConversionCode.COLOR_RGB2GRAY),
        cvgs.split_tensor())))
    bgr = np.asarray(cvgs.execute_operations(*ops(
        cvgs.cvt_color(cvgs.ColorConversionCode.COLOR_RGB2BGR),
        cvgs.split_tensor())))
    assert gray.shape == (3, 1, UP[1], UP[0])
    for z in range(3):
        check_exact(gray[z, 0], cv2.cvtColor(rgb[z], cv2.COLOR_RGB2GRAY),
                    f"gray plane {z}")
        check_exact(bgr[z], rgb[z, ..., ::-1].transpose(2, 0, 1),
                    f"swizzle plane {z}")


@pytest.mark.parametrize("write,shape,perm", [
    ("split_tensor_transposed", (3, 4, 128, 64), (3, 0, 1, 2)),
    ("write_tensor", (4, 128, 64, 3), (0, 1, 2, 3)),
])
def test_write_layouts_parity(rng, write, shape, perm):
    frame = _frame(rng)
    rects = _rects(4)
    out = np.asarray(cvgs.execute_operations(
        cvgs.resize_batch(frame, rects=rects, dsize=cvgs.Size(*UP)),
        getattr(cvgs, write)(),
    ))
    assert out.shape == shape
    check_float(out, _ref(frame, rects).transpose(perm), msg=write)


def test_split_write_parity(rng):
    frame = _frame(rng)
    rects = _rects(4)
    out = cvgs.execute_operations(
        cvgs.resize_batch(frame, rects=rects, dsize=cvgs.Size(*UP)),
        cvgs.split(),
    )
    assert isinstance(out, (tuple, list)) and len(out) == 3
    ref = _ref(frame, rects)
    for c in range(3):
        check_float(np.asarray(out[c]), ref[..., c], msg=f"split ch{c}")


def test_chain_with_alpha_add_parity(rng):
    """BGR2BGRA (alpha append) after a u8 cast."""
    frame = _frame(rng)
    rects = _rects(3)
    out = np.asarray(cvgs.execute_operations(
        cvgs.resize_batch(frame, rects=rects, dsize=cvgs.Size(*UP)),
        cvgs.convert_to(np.uint8),
        cvgs.cvt_color(cvgs.ColorConversionCode.COLOR_BGR2BGRA),
        cvgs.split_tensor(),
    ))
    assert out.shape == (3, 4, UP[1], UP[0])
    assert np.all(out[:, 3] == 255)
    check_u8("alpha-append chain", out[:, :3],
             _ref(frame, rects).transpose(0, 3, 1, 2))


def test_packed_split_parity(rng):
    """TensorSplitPacked: the same values as TensorSplit in packed row order."""
    frame = rng.integers(0, 256, (512, 768, 3)).astype(np.uint8)
    rects = np.array([[i, i, 60, 120] for i in range(8)], np.int32)

    def run(write):
        return np.asarray(cvgs.execute_operations(
            cvgs.resize_batch(frame, rects=rects, dsize=cvgs.Size(64, 128)),
            cvgs.convert_to(np.float32, alpha=0.3),
            cvgs.subtract((3.2, 0.6, 11.8)),
            cvgs.divide((128.0, 128.0, 128.0)),
            write,
        ))

    planar = run(cvgs.split_tensor())
    packed = run(cvgs.split_tensor_packed())
    assert packed.shape == (8, 3, 64, 128)
    assert np.array_equal(packed.reshape(8, 3, 128, 64), planar)
    check_float(planar, _flagship_chain(_ref(frame, rects)), msg="planar")


def test_packed_split_ragged_letterbox(rng):
    """Packed layout with masking paths active (letterbox + ragged batch)."""
    frame = rng.integers(0, 256, (512, 768, 3)).astype(np.uint8)
    rects = np.array([[8 * i, 4 * i, 30 + i, 100] for i in range(6)], np.int32)
    packed = np.asarray(cvgs.execute_operations(
        cvgs.resize_batch(frame, rects=rects, dsize=cvgs.Size(64, 128),
                          aspect_ratio=cvgs.AspectRatio.PRESERVE_AR,
                          used_planes=4, background=(7.0, 8.0, 9.0)),
        cvgs.convert_to(np.float32),
        cvgs.split_tensor_packed(),
    ))
    ref = _ref(frame, rects, cvgs.AspectRatio.PRESERVE_AR,
               background=(7.0, 8.0, 9.0), used=4)
    check_float(packed.reshape(6, 3, 128, 64), ref.transpose(0, 3, 1, 2),
                msg="packed letterbox")


def test_bottom_aligned_uniform_crops(rng):
    """Uniform crops whose bottom edge is the frame's bottom row."""
    frame = rng.integers(0, 256, (512, 768, 3)).astype(np.uint8)
    rects = np.array([[7 * i, 440 + i, 60, 64] for i in range(9)], np.int32)
    rects[-1, 1] = 512 - 64
    out = np.asarray(cvgs.execute_operations(
        cvgs.resize_batch(frame, rects=rects, dsize=cvgs.Size(*UP)),
        cvgs.convert_to(np.float32, alpha=0.5),
        cvgs.split_tensor(),
    ))
    check_float(out, (_ref(frame, rects) * 0.5).transpose(0, 3, 1, 2),
                msg="bottom-aligned uniform crops")


def test_rects_touch_frame_edges(rng):
    """Crops anchored at every corner of the frame, and the whole frame."""
    frame = _frame(rng, 120, 200)
    rects = np.array([[0, 0, 50, 40], [150, 0, 50, 40], [0, 80, 50, 40],
                      [150, 80, 50, 40], [0, 0, 200, 120]], np.int32)
    out = np.asarray(cvgs.execute_operations(
        cvgs.resize_batch(frame, rects=rects, dsize=cvgs.Size(48, 32)),
    ))
    check_float(out, _ref(frame, rects, dsize=(48, 32)), msg="edge rects")


@pytest.mark.parametrize("dsize", [(37, 53), (100, 7), (1, 1)])
def test_non_power_of_two_dsize(rng, dsize):
    frame = _frame(rng)
    rects = _rects(4)
    out = np.asarray(cvgs.execute_operations(
        cvgs.resize_batch(frame, rects=rects, dsize=cvgs.Size(*dsize),
                          aspect_ratio=cvgs.AspectRatio.PRESERVE_AR,
                          background=5.0),
    ))
    assert out.shape == (4, dsize[1], dsize[0], 3)
    check_float(out, _ref(frame, rects, cvgs.AspectRatio.PRESERVE_AR, dsize,
                          background=5.0), msg=f"dsize {dsize}")


@pytest.mark.parametrize("mode", [cvgs.AspectRatio.IGNORE_AR,
                                  cvgs.AspectRatio.PRESERVE_AR])
@pytest.mark.parametrize("src_dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("ch", [1, 3, 4])
def test_channels_dtypes_modes(rng, ch, src_dtype, mode):
    frame = _frame(rng, 160, 224, ch, src_dtype)
    if src_dtype == np.float32:
        frame = frame + rng.random(frame.shape, dtype=np.float32)
    rects = _rects(5, cw=44, ch=80)
    bg = tuple(float(10 + c) for c in range(ch))
    out = np.asarray(cvgs.execute_operations(
        cvgs.resize_batch(frame, rects=rects, dsize=cvgs.Size(32, 48),
                          aspect_ratio=mode, background=bg, used_planes=4),
        cvgs.multiply(0.5),
        cvgs.split_tensor(),
    ))
    ref = _ref(frame, rects, mode, (32, 48), background=bg, used=4) * 0.5
    check_float(out, ref.transpose(0, 3, 1, 2),
                msg=f"c{ch} {np.dtype(src_dtype).name} {mode.name}")


def test_check_u8_accepts_only_edge_flips():
    """The u8 check of ``chip_smoke`` lets a pixel round either way only
    when its exact value sits on a .5 tie."""
    ref = np.array([[0.5, 2.5, 3.2]])
    check_u8("ties", np.array([[1, 2, 3]], np.uint8), ref)
    with pytest.raises(PhaseFailed):
        check_u8("off by one", np.array([[0, 2, 4]], np.uint8), ref)
