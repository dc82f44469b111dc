"""The numpy reference of ``chip_smoke.py`` against OpenCV, and the script's
refusal to run without a GPU."""

import cv2
import numpy as np
import pytest

import chip_smoke as cs


def test_main_exits_nonzero_without_gpu(capsys):
    assert cs.main([]) != 0
    assert cs.main(["--four-cards"]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out


@pytest.mark.parametrize("src,dst", [((120, 60), (64, 128)),
                                     ((97, 211), (40, 33)),
                                     ((30, 40), (90, 100))])
def test_ref_resize_matches_cv2(rng, src, dst):
    img = rng.integers(0, 256, src + (3,)).astype(np.uint8)
    ref = cs.ref_resize(img, *dst)
    cv = cv2.resize(img.astype(np.float32), dst, interpolation=cv2.INTER_LINEAR)
    assert np.abs(ref - cv).max() <= 1e-3


def test_ref_letterbox_rule():
    assert cs.ref_letterbox(60, 120, 64, 128, preserve=False) == (64, 128, 0, 0)
    # the flagship PRESERVE_AR crop: fit the height, centre the width
    assert cs.ref_letterbox(30, 120, 64, 128, preserve=True) == (32, 128, 16, 0)
    # a wide crop overflows the width and is fitted to it instead
    assert cs.ref_letterbox(200, 50, 64, 128, preserve=True) == (64, 16, 0, 56)


def test_ref_nv12_matches_cv2(rng):
    """OpenCV's NV12 conversion is BT.601 limited range in fixed point: the
    float reference rounds to within one level of it. The samples stay in
    the legal video range (OpenCV clamps Y - 16 at zero)."""
    buf = rng.integers(16, 236, (96, 128)).astype(np.uint8)
    ref = cs.ref_to_u8(cs.ref_nv12_to_rgb(buf, "bt601", limited=True))
    cv = cv2.cvtColor(buf, cv2.COLOR_YUV2RGB_NV12)
    diff = np.abs(ref.astype(np.int32) - cv)
    assert diff.max() <= 1 and (diff == 0).mean() > 0.9
    nv21 = cs.ref_to_u8(cs.ref_nv12_to_rgb(buf, "bt601", limited=True, nv21=True))
    cv21 = cv2.cvtColor(buf, cv2.COLOR_YUV2RGB_NV21)
    assert np.abs(nv21.astype(np.int32) - cv21).max() <= 1


def test_ref_warp_matches_cv2(rng):
    """Exact float coordinates vs OpenCV's 1/32-pixel fixed point."""
    img = rng.integers(0, 256, (60, 80, 3)).astype(np.uint8)
    m = cs.rotation_matrix((40, 30), 20.0, 0.8)
    np.testing.assert_allclose(m, cv2.getRotationMatrix2D((40, 30), 20.0, 0.8))
    ref = cs.ref_warp(img, m, 80, 60, border=3.0)
    cv = cv2.warpAffine(img.astype(np.float32), m, (80, 60),
                        flags=cv2.INTER_LINEAR, borderMode=cv2.BORDER_CONSTANT,
                        borderValue=(3.0, 3.0, 3.0))
    assert np.abs(ref - cv).max() <= 2e-2
    src = np.float32([[0, 0], [79, 0], [0, 59], [79, 59]])
    dst = np.float32([[3, 2], [75, 5], [2, 55], [78, 57]])
    h = cv2.getPerspectiveTransform(src, dst)
    ref = cs.ref_warp(img, h, 80, 60, perspective=True)
    cv = cv2.warpPerspective(img.astype(np.float32), h, (80, 60),
                             flags=cv2.INTER_LINEAR,
                             borderMode=cv2.BORDER_CONSTANT, borderValue=0)
    assert np.abs(ref[2:-2, 2:-2] - cv[2:-2, 2:-2]).max() <= 1e-2


def test_flagship_reference_chain(rng):
    """The flagship reference: ragged planes hold the background pushed
    through the chain; active planes are the cv2 crops through it."""
    frame = rng.integers(0, 256, (200, 300, 3)).astype(np.uint8)
    rects = np.array([[i, i, 60, 120] for i in range(4)], np.int32)
    ref = cs.flagship_reference(frame, rects, used=3)
    assert ref.shape == (4, 3, 128, 64)
    bg = (cs.FLAGSHIP_BG * cs.FLAGSHIP_ALPHA - np.asarray(cs.FLAGSHIP_MEAN)) \
        / np.asarray(cs.FLAGSHIP_SCALE)
    np.testing.assert_allclose(ref[3], np.broadcast_to(bg[:, None, None], (3, 128, 64)))
    crop = cv2.resize(frame[1:121, 1:61].astype(np.float32), (64, 128))
    want = (crop * 0.3 - np.asarray(cs.FLAGSHIP_MEAN)) / 128.0
    assert np.abs(ref[1] - want.transpose(2, 0, 1)).max() <= 1e-4
