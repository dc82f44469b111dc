"""NV12 path + divergent batch — the ``tests/resize/test_fused_resize.cu``
analog ("ComputeWhatYouSee": fused NV12 read -> YUV->RGB -> resize; divergent
per-plane op sequences), with the dummy-buffer fallback the reference uses
when the .nv12 assets are missing (:166-207 — they are missing in our
checkout too, ``.MISSING_LARGE_BLOBS``)."""

import numpy as np
import pytest

import cvgpuspeedup_tpu as cvgs
from chip_smoke import ref_batch_resize, ref_nv12_to_rgb, ref_resize, ref_warp
from conftest import check_exact, check_float

H, W = 64, 96


def _nv12_buffer(rng):
    return rng.integers(0, 256, (H * 3 // 2, W)).astype(np.uint8)


def _np_nv12_to_rgb(buf, kr, kb, limited=False):
    y = buf[:H].astype(np.float32)
    uv = buf[H:].reshape(H // 2, W // 2, 2).astype(np.float32)
    u = np.repeat(np.repeat(uv[..., 0], 2, 0), 2, 1) - 128.0
    v = np.repeat(np.repeat(uv[..., 1], 2, 0), 2, 1) - 128.0
    if limited:
        y = (y - 16.0) * np.float32(255.0 / 219.0)
        u = u * np.float32(255.0 / 224.0)
        v = v * np.float32(255.0 / 224.0)
    kg = 1.0 - kr - kb
    r = y + np.float32(2 * (1 - kr)) * v
    g = y - np.float32(2 * kb * (1 - kb) / kg) * u - np.float32(2 * kr * (1 - kr) / kg) * v
    b = y + np.float32(2 * (1 - kb)) * u
    return np.stack([r, g, b], axis=-1)


@pytest.mark.parametrize("standard,kr,kb", [
    (cvgs.ColorStandard.BT601, 0.299, 0.114),
    (cvgs.ColorStandard.BT709, 0.2126, 0.0722),
])
@pytest.mark.parametrize("crange", [cvgs.ColorRange.FULL, cvgs.ColorRange.LIMITED])
def test_nv12_to_rgb(rng, standard, kr, kb, crange):
    buf = _nv12_buffer(rng)
    out = np.asarray(
        cvgs.execute_operations(
            cvgs.read_yuv(buf),
            cvgs.convert_yuv_to_rgb(color_range=crange, standard=standard),
        )
    )
    ref_f = _np_nv12_to_rgb(buf, kr, kb, limited=(crange == cvgs.ColorRange.LIMITED))
    # u8 output must sit within rounding distance of the float reference
    # (engine f32 FMA vs numpy mul+add can flip exact .5 ties either way)
    err = np.abs(out.astype(np.float64) - np.clip(ref_f, 0, 255))
    assert err.max() <= 0.5 + 1e-3, f"NV12 {standard.name} {crange.name}: max {err.max()}"


def test_nv12_alpha_and_float_out(rng):
    buf = _nv12_buffer(rng)
    out = np.asarray(
        cvgs.execute_operations(
            cvgs.read_yuv(buf),
            cvgs.convert_yuv_to_rgb(alpha=True, out_dtype=np.float32),
        )
    )
    assert out.shape == (H, W, 4) and out.dtype == np.float32
    assert np.all(out[..., 3] == 1.0)
    ref = _np_nv12_to_rgb(buf, 0.299, 0.114)
    check_float(out[..., :3], ref, msg="float RGB")


def test_compute_what_you_see_fused_resize(rng):
    """The flagship NV12 pattern: resize over the fused NV12->RGB virtual
    image — conversion happens at full res inside the fused read, then
    bilinear samples it (reference :73-92)."""
    buf = _nv12_buffer(rng)
    virtual = cvgs.fuse(
        cvgs.read_yuv(buf),
        cvgs.convert_yuv_to_rgb(standard=cvgs.ColorStandard.BT709,
                                out_dtype=np.float32),
    )
    out = np.asarray(
        cvgs.execute_operations(
            cvgs.resize(virtual, cvgs.Size(48, 32)),
            cvgs.convert_to(np.uint8),
        )
    )
    import cv2
    full = _np_nv12_to_rgb(buf, 0.2126, 0.0722)
    ref = cv2.resize(full, (48, 32), interpolation=cv2.INTER_LINEAR)
    ref = np.clip(np.rint(ref), 0, 255).astype(np.uint8)
    # resize of f32 data: ties in the final rounding may flip by 1 lsb
    diff = np.abs(out.astype(np.int32) - ref.astype(np.int32))
    assert (diff > 1).sum() == 0


def test_nv21_swaps_uv(rng):
    buf = _nv12_buffer(rng)
    out12 = np.asarray(cvgs.execute_operations(
        cvgs.read_yuv(buf, pixel_format=cvgs.PixelFormat.NV12)))
    out21 = np.asarray(cvgs.execute_operations(
        cvgs.read_yuv(buf, pixel_format=cvgs.PixelFormat.NV21)))
    check_exact(out12[..., 1], out21[..., 2], "U/V swap")
    check_exact(out12[..., 0], out21[..., 0], "Y unchanged")


def test_divergent_batch_two_sequences(rng):
    """Plane-dependent op sequences in one launch (reference
    ``test_circularbatchread_x_write3D.cu:147-156``): seq1 = read+add,
    seq2 = plain copy; selector routes planes."""
    data = rng.integers(0, 200, (6, 10, 12, 3)).astype(np.float32)
    seq1 = cvgs.build_operation_sequence(
        cvgs.image(data), cvgs.add(3.0), cvgs.split_tensor()
    )
    seq2 = cvgs.build_operation_sequence(cvgs.image(data), cvgs.split_tensor())

    def selector(z):
        return 1 if z % 2 == 0 else 2

    out = np.asarray(cvgs.launch_divergent_batch(selector, seq1, seq2))
    assert out.shape == (6, 3, 10, 12)
    for z in range(6):
        expect = data[z] + 3.0 if z % 2 == 0 else data[z]
        check_float(out[z], expect.transpose(2, 0, 1), msg=f"divergent z={z}")


def test_divergent_batch_different_reads(rng):
    """Sequences may read different sources (reference: CircularBatchRead in
    seq1 vs plain batch read in seq2)."""
    a = rng.integers(0, 100, (4, 8, 8, 1)).astype(np.float32)
    b = rng.integers(0, 100, (4, 8, 8, 1)).astype(np.float32)
    seq1 = cvgs.build_operation_sequence(cvgs.circular_batch_read(a, first=2))
    seq2 = cvgs.build_operation_sequence(cvgs.image(b))
    out = np.asarray(
        cvgs.launch_divergent_batch(lambda z: 1 if z < 2 else 2, seq1, seq2)
    )
    for z in range(4):
        expect = a[(2 + z) % 4] if z < 2 else b[z]
        check_float(out[z], expect, msg=f"z={z}")


def test_nv12_multi_camera_batch(rng):
    """Multiple same-size NV12 cameras as one batched fused read (the
    reference's CAMERAS loop, test_fused_resize.cu:47-58, as ONE launch)."""
    bufs = [rng.integers(0, 256, (H * 3 // 2, W)).astype(np.uint8) for _ in range(4)]
    cams = [
        cvgs.fuse(cvgs.read_yuv(b),
                  cvgs.convert_yuv_to_rgb(out_dtype=np.float32))
        for b in bufs
    ]
    out = np.asarray(cvgs.execute_operations(
        cvgs.batch_read(cams), cvgs.multiply(0.5), cvgs.split_tensor()
    ))
    assert out.shape == (4, 3, H, W)
    ref0 = _np_nv12_to_rgb(bufs[0], 0.299, 0.114) * 0.5
    check_float(out[0], ref0.transpose(2, 0, 1), msg="camera 0")


@pytest.mark.parametrize("src_hw,dst_wh", [
    ((96, 144), (48, 32)),    # 3:1 both axes (P odd -> doubled chroma phases)
    ((64, 96), (96, 144)),    # 3:2 upscale
    ((54, 60), (40, 36)),     # 3:2 down / 2:3 up mix
    ((64, 96), (64, 96)),     # identity ratio (pure chroma upsample)
])
def test_nv12_planespace_resize_parity(rng, src_hw, dst_wh):
    """The plane-space rewrite (resize Y/U/V at native resolution, convert
    after) must match the full-res reference composition exactly: cv2 resize
    of the upsampled-and-converted image."""
    import cv2
    h, w = src_hw
    buf = rng.integers(0, 256, (h * 3 // 2, w)).astype(np.uint8)
    virtual = cvgs.fuse(
        cvgs.read_yuv(buf),
        cvgs.convert_yuv_to_rgb(standard=cvgs.ColorStandard.BT709,
                                out_dtype=np.float32),
    )
    out = np.asarray(cvgs.execute_operations(
        cvgs.resize(virtual, cvgs.Size(*dst_wh))))
    # oracle: full-res YUV image (nearest chroma upsample), convert, resize
    y = buf[:h].astype(np.float32)
    uv = buf[h:].reshape(h // 2, w // 2, 2).astype(np.float32)
    u = np.repeat(np.repeat(uv[..., 0], 2, 0), 2, 1)
    v = np.repeat(np.repeat(uv[..., 1], 2, 0), 2, 1)
    kr, kb = 0.2126, 0.0722
    kg = 1.0 - kr - kb
    uu, vv = u - 128.0, v - 128.0
    full = np.stack([
        y + np.float32(2 * (1 - kr)) * vv,
        y - np.float32(2 * kb * (1 - kb) / kg) * uu
          - np.float32(2 * kr * (1 - kr) / kg) * vv,
        y + np.float32(2 * (1 - kb)) * uu,
    ], axis=-1)
    ref = cv2.resize(full, dst_wh, interpolation=cv2.INTER_LINEAR)
    check_float(out, ref, msg=f"NV12 plane-space {src_hw}->{dst_wh}")


def test_nv21_planespace_resize_parity(rng):
    """NV21 (swapped UV) must survive the plane-space rewrite."""
    h, w = 64, 96
    buf = rng.integers(0, 256, (h * 3 // 2, w)).astype(np.uint8)
    v12 = cvgs.fuse(cvgs.read_yuv(buf, pixel_format=cvgs.PixelFormat.NV21),
                    cvgs.convert_yuv_to_rgb(out_dtype=np.float32))
    out = np.asarray(cvgs.execute_operations(cvgs.resize(v12, cvgs.Size(48, 32))))
    # swap UV pairs in the buffer -> NV12 read must equal the NV21 read
    buf2 = buf.copy()
    uvrows = buf2[h:].reshape(-1, 2)
    buf2[h:] = uvrows[:, ::-1].reshape(buf2[h:].shape)
    v21 = cvgs.fuse(cvgs.read_yuv(buf2),
                    cvgs.convert_yuv_to_rgb(out_dtype=np.float32))
    ref = np.asarray(cvgs.execute_operations(cvgs.resize(v21, cvgs.Size(48, 32))))
    check_float(out, ref, msg="NV21 plane-space")


def _divergent_ref(ids, refs):
    """Merge per-sequence (N, ...) references by the 1-based plane ids."""
    return np.stack([refs[sid - 1][z] for z, sid in enumerate(ids)])


def test_divergent_pallas_kernel_parity(rng):
    """Mixed image + circular reads with per-channel chains, across ring
    rotations, against the per-plane expectation."""
    n = 6
    a = rng.integers(0, 200, (n, 16, 128, 3)).astype(np.float32)
    b = rng.integers(0, 200, (n, 16, 128, 3)).astype(np.uint8)
    ids = [1, 2, 2, 1, 2, 1]
    for first in (0, 3):
        seq1 = cvgs.build_operation_sequence(
            cvgs.circular_batch_read(a, first=first),
            cvgs.multiply((2.0, 0.5, 1.0)),
            cvgs.add(1.0),
        )
        seq2 = cvgs.build_operation_sequence(
            cvgs.image(b), cvgs.convert_to(np.float32, alpha=0.25)
        )
        out = np.asarray(cvgs.launch_divergent_batch(ids, seq1, seq2))
        from conftest import assert_backend
        assert_backend("xla:divergent")
        ring = a[(first + np.arange(n)) % n] * np.float32([2.0, 0.5, 1.0]) + 1.0
        ref = _divergent_ref(ids, [ring, b.astype(np.float32) * np.float32(0.25)])
        assert out.shape == (n, 16, 128, 3)
        check_float(out, ref, tol=0, msg=f"divergent mixed reads first={first}")


def test_divergent_pallas_unsupported_falls_back(rng):
    """A planar write layout on the merged batch."""
    data = rng.integers(0, 200, (4, 16, 128, 3)).astype(np.float32)
    seq_split = cvgs.build_operation_sequence(
        cvgs.image(data), cvgs.split_tensor())
    out = np.asarray(cvgs.launch_divergent_batch([1, 1, 1, 1], seq_split))
    assert out.shape == (4, 3, 16, 128)
    check_float(out, data.transpose(0, 3, 1, 2), tol=0, msg="planar write")


def test_divergent_resize_sequence_kernel(rng):
    """Divergent batch whose seq1 READ is a whole-plane resize of a stack —
    the reference's own divergent showcase shape
    (test_fused_resize.cu:85-92)."""
    stack = rng.integers(0, 256, (6, 64, 256, 3)).astype(np.uint8)
    flat = rng.integers(0, 200, (6, 32, 128, 3)).astype(np.float32)
    seq1 = cvgs.build_operation_sequence(
        cvgs.resize_batch(list(stack), dsize=cvgs.Size(128, 32)),
        cvgs.multiply(0.5), cvgs.write_tensor(),
    )
    seq2 = cvgs.build_operation_sequence(cvgs.image(flat), cvgs.write_tensor())
    ids = [1 if z % 2 == 0 else 2 for z in range(6)]
    out = np.asarray(cvgs.launch_divergent_batch(ids, seq1, seq2))
    resized = np.stack([ref_resize(im, 128, 32) * 0.5 for im in stack])
    check_float(out, _divergent_ref(ids, [resized, flat]),
                msg="divergent resize vs reference")


@pytest.mark.parametrize("fmt,crange", [
    (cvgs.PixelFormat.NV12, cvgs.ColorRange.FULL),
    (cvgs.PixelFormat.NV21, cvgs.ColorRange.LIMITED),
])
def test_divergent_nv12_sequence_kernel(rng, fmt, crange):
    """Divergent batch mixing an NV12->RGB->resize sequence with a
    pass-through — the full reference demo in one program."""
    SH, SW, h, w = 64, 256, 32, 128
    bufs = [rng.integers(0, 256, (SH * 3 // 2, SW)).astype(np.uint8)
            for _ in range(4)]
    cams = [cvgs.resize(
        cvgs.fuse(cvgs.read_yuv(b, pixel_format=fmt),
                  cvgs.convert_yuv_to_rgb(standard=cvgs.ColorStandard.BT709,
                                          color_range=crange,
                                          out_dtype=np.float32)),
        cvgs.Size(w, h)) for b in bufs]
    flat = rng.integers(0, 200, (4, h, w, 3)).astype(np.float32)
    seq1 = cvgs.build_operation_sequence(
        cvgs.batch_read(cams), cvgs.multiply(0.5), cvgs.write_tensor())
    seq2 = cvgs.build_operation_sequence(cvgs.image(flat), cvgs.write_tensor())
    ids = [1, 2, 1, 2]
    out = np.asarray(cvgs.launch_divergent_batch(ids, seq1, seq2))
    limited = crange == cvgs.ColorRange.LIMITED
    nv21 = fmt == cvgs.PixelFormat.NV21
    cam_ref = np.stack([
        ref_resize(ref_nv12_to_rgb(b, "bt709", limited, nv21), w, h) * 0.5
        for b in bufs])
    check_float(out, _divergent_ref(ids, [cam_ref, flat]),
                msg=f"divergent NV12 vs reference ({fmt.name})")


def test_divergent_nv12_unaligned_falls_back(rng):
    """NV12 buffers of a width with no power-of-two factor run like any
    other."""
    bufs = [rng.integers(0, 256, (96, 96)).astype(np.uint8) for _ in range(2)]
    cams = [cvgs.fuse(cvgs.read_yuv(b),
                      cvgs.convert_yuv_to_rgb(out_dtype=np.float32))
            for b in bufs]
    seq1 = cvgs.build_operation_sequence(cvgs.batch_read(cams),
                                         cvgs.write_tensor())
    flat = np.zeros((2, 64, 96, 3), np.float32)
    seq2 = cvgs.build_operation_sequence(cvgs.image(flat), cvgs.write_tensor())
    out = np.asarray(cvgs.launch_divergent_batch([1, 2], seq1, seq2))
    check_float(out[0], ref_nv12_to_rgb(bufs[0]), msg="NV12 plane")
    check_float(out[1], flat[1], tol=0, msg="pass-through plane")


def test_divergent_crop_resize_sequence_kernel(rng):
    """Divergent batch whose seq1 READ is the FLAGSHIP shape — per-plane
    CROPS of one shared frame, bilinear-resized (different rects AND
    different chains per plane: the reference's
    ``test_circularbatchread_x_write3D.cu:147-156`` routing)."""
    frame = rng.integers(0, 256, (296, 384, 3)).astype(np.uint8)
    n = 8
    rects = np.array([[5 * z, 3 * z, 60, 120] for z in range(n)], np.int32)
    seq1 = cvgs.build_operation_sequence(
        cvgs.resize_batch(frame, rects=rects, dsize=cvgs.Size(64, 128)),
        cvgs.convert_to(np.float32, alpha=0.5), cvgs.subtract((1.0, 2.0, 3.0)),
        cvgs.write_tensor(),
    )
    flat = rng.integers(0, 200, (n, 128, 64, 3)).astype(np.float32)
    seq2 = cvgs.build_operation_sequence(
        cvgs.image(flat), cvgs.multiply(2.0), cvgs.write_tensor())
    ids = [1 if z % 3 else 2 for z in range(n)]
    out = np.asarray(cvgs.launch_divergent_batch(ids, seq1, seq2))
    crops = ref_batch_resize(frame, rects, 64, 128) * 0.5 - np.array([1.0, 2.0, 3.0])
    check_float(out, _divergent_ref(ids, [crops, flat * 2.0]),
                msg="divergent crop-resize vs reference")


def test_divergent_crop_resize_rect_jitter_no_recompile(rng):
    """Rect positions are runtime values: shifting them reuses the compiled
    divergent program."""
    from cvgpuspeedup_tpu.exec import executor

    frame = rng.integers(0, 256, (296, 384, 3)).astype(np.uint8)
    n = 4
    flat = rng.integers(0, 200, (n, 64, 32, 3)).astype(np.float32)
    executor.clear_cache()
    outs = []
    for shift in range(2):
        rects = np.array([[5 * z + shift, 3 * z, 40, 56] for z in range(n)],
                         np.int32)
        seq1 = cvgs.build_operation_sequence(
            cvgs.resize_batch(frame, rects=rects, dsize=cvgs.Size(32, 64)),
            cvgs.write_tensor(),
        )
        seq2 = cvgs.build_operation_sequence(cvgs.image(flat),
                                             cvgs.write_tensor())
        outs.append(np.asarray(cvgs.launch_divergent_batch(
            [1, 2, 1, 2], seq1, seq2)))
    assert len(executor._CACHE) == 1
    assert not np.allclose(outs[0], outs[1])


def test_divergent_crop_resize_bottom_of_frame(rng):
    """Bottom-aligned crops: the last crop's bottom row is the frame's."""
    frame = rng.integers(0, 256, (296, 384, 3)).astype(np.uint8)
    n = 4
    # y0=176 is the maximal valid start (176 + 120 = 296 = src_h)
    rects = np.array([[8 * z, 176 - z, 60, 120] for z in range(n)], np.int32)
    seq1 = cvgs.build_operation_sequence(
        cvgs.resize_batch(frame, rects=rects, dsize=cvgs.Size(64, 128)),
        cvgs.convert_to(np.float32, alpha=0.5), cvgs.write_tensor(),
    )
    flat = rng.integers(0, 200, (n, 128, 64, 3)).astype(np.float32)
    seq2 = cvgs.build_operation_sequence(cvgs.image(flat), cvgs.write_tensor())
    ids = [1, 1, 2, 1]
    out = np.asarray(cvgs.launch_divergent_batch(ids, seq1, seq2))
    crops = ref_batch_resize(frame, rects, 64, 128) * 0.5
    check_float(out, _divergent_ref(ids, [crops, flat]),
                msg="divergent bottom-of-frame crop vs reference")


def test_divergent_auto_refuses_lane_pad(rng):
    """A stack whose row is not a multiple of any tile width (100 px x 3
    channels) runs unpadded."""
    data = rng.integers(0, 200, (4, 16, 100, 3)).astype(np.float32)
    seq = cvgs.build_operation_sequence(
        cvgs.image(data), cvgs.multiply(2.0), cvgs.write_tensor())
    out = np.asarray(cvgs.launch_divergent_batch([1, 1, 1, 1], seq))
    check_float(out, np.asarray(data) * 2.0, tol=0, msg="unaligned stack")


def test_divergent_warp_mix_one_kernel(rng):
    """8-plane pipeline mixing WARP | crop-resize | pass-through sequences
    in one program (reference arbitrary per-plane routing,
    ``test_circularbatchread_x_write3D.cu:147-156``, warp overloads
    ``include/cvGPUSpeedup.cuh:285-442``)."""
    import cv2

    n = 8
    imgs = [rng.integers(0, 256, (96, 128, 3)).astype(np.uint8)
            for _ in range(n)]
    mats = [cv2.getRotationMatrix2D((64, 48), 4.0 * z - 14, 1.0)
            for z in range(n)]
    frame = rng.integers(0, 256, (296, 384, 3)).astype(np.uint8)
    rects = np.array([[5 * z, 3 * z, 60, 120] for z in range(n)], np.int32)
    flat = rng.integers(0, 200, (n, 128, 64, 3)).astype(np.float32)
    seq_warp = cvgs.build_operation_sequence(
        cvgs.warp_batch(imgs, mats, cvgs.Size(64, 128)),
        cvgs.multiply(0.5), cvgs.write_tensor())
    seq_crop = cvgs.build_operation_sequence(
        cvgs.resize_batch(frame, rects=rects, dsize=cvgs.Size(64, 128)),
        cvgs.convert_to(np.float32, alpha=0.5), cvgs.write_tensor())
    seq_pass = cvgs.build_operation_sequence(
        cvgs.image(flat), cvgs.multiply(2.0), cvgs.write_tensor())
    ids = [1, 2, 3, 1, 2, 3, 1, 2]
    out = np.asarray(cvgs.launch_divergent_batch(ids, seq_warp, seq_crop,
                                                 seq_pass))
    warped = np.stack([ref_warp(im, m, 64, 128) * np.float32(0.5)
                       for im, m in zip(imgs, mats)])
    crops = ref_batch_resize(frame, rects, 64, 128) * 0.5
    check_float(out, _divergent_ref(ids, [warped, crops, flat * 2.0]),
                msg="divergent warp mix vs reference")


def test_divergent_warp_static_key_recompiles(rng):
    """NEW warp matrices must produce new results (matrices are runtime
    leaves of the divergent program)."""
    import cv2

    n = 4
    imgs = [rng.integers(0, 256, (96, 128, 3)).astype(np.uint8)
            for _ in range(n)]
    flat = rng.integers(0, 200, (n, 128, 64, 3)).astype(np.float32)
    seq_pass = cvgs.build_operation_sequence(
        cvgs.image(flat), cvgs.write_tensor())
    outs = []
    for ang in (5.0, 25.0):
        mats = [cv2.getRotationMatrix2D((64, 48), ang + z, 1.0)
                for z in range(n)]
        sw = cvgs.build_operation_sequence(
            cvgs.warp_batch(imgs, mats, cvgs.Size(64, 128)),
            cvgs.write_tensor())
        out = np.asarray(cvgs.launch_divergent_batch([1, 2, 1, 2], sw, seq_pass))
        warped = np.stack([ref_warp(im, m, 64, 128) for im, m in zip(imgs, mats)])
        check_float(out, _divergent_ref([1, 2, 1, 2], [warped, flat]),
                    msg=f"warp matrices ang={ang}")
        outs.append(out)
    assert not np.allclose(outs[0], outs[1])
