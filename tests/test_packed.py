"""Packed-frame ingestion: host arrays enter the graph as (H, W*C) rows of
interleaved pixels — a free numpy view — and the XLA lowerings unpack them
to (H, W, C). See ops.memory.ImageRead.packed_channels."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import cvgpuspeedup_tpu as cvgs
from cvgpuspeedup_tpu.ops.memory import ImageRead
from cvgpuspeedup_tpu.ops.resize import BatchResizeRead
from conftest import check_float


def test_image_packs_host_arrays(rng):
    img = rng.integers(0, 256, (16, 32, 3)).astype(np.uint8)
    read = cvgs.image(img)
    assert isinstance(read, ImageRead)
    assert read.packed_channels == 3
    assert read.data.shape == (16, 96)
    # the packed rows are the row-major bytes of the original
    assert np.array_equal(read.data, img.reshape(16, 96))
    # XLA lowering unpacks to the logical (H, W, C)
    assert np.array_equal(np.asarray(read.lower()), img)


def test_image_batched_packs(rng):
    batch = rng.integers(0, 256, (4, 8, 16, 3)).astype(np.uint8)
    read = cvgs.image(batch)
    assert read.packed_channels == 3 and read.is_batch
    assert read.data.shape == (4, 8, 48)
    assert np.array_equal(np.asarray(read.lower()), batch)


def test_image_device_arrays_not_packed(rng):
    img = jnp.asarray(rng.integers(0, 256, (16, 32, 3)).astype(np.uint8))
    read = cvgs.image(img)
    assert read.packed_channels == 0
    assert read.data.shape == (16, 32, 3)


def test_grayscale_not_packed(rng):
    img = rng.integers(0, 256, (16, 32)).astype(np.uint8)
    read = cvgs.image(img)
    assert read.packed_channels == 0


def test_image_channels_kwarg_prepacked(rng):
    """channels= declares an already-packed buffer (host OR device) — the
    frameloader/raw-ingest path, no reshape anywhere."""
    img = rng.integers(0, 256, (16, 32, 3)).astype(np.uint8)
    packed = img.reshape(16, 96)
    read = cvgs.image(packed, channels=3)
    assert read.packed_channels == 3 and not read.is_batch
    assert np.array_equal(np.asarray(read.lower()), img)
    # device buffer kept in ingest layout
    read_dev = cvgs.image(jnp.asarray(packed), channels=3)
    assert read_dev.packed_channels == 3
    assert np.array_equal(np.asarray(read_dev.lower()), img)
    with pytest.raises(ValueError):
        cvgs.image(packed[:, :95], channels=3)


def test_resize_batch_packs_frame(rng):
    frame = rng.integers(0, 256, (64, 128, 3)).astype(np.uint8)
    rects = np.array([[0, 0, 32, 16], [8, 8, 32, 16]], np.int32)
    read = cvgs.resize_batch(frame, rects=rects, dsize=cvgs.Size(16, 8))
    assert isinstance(read, BatchResizeRead)
    assert read.packed_channels == 3
    assert read.frame.shape == (64, 384)
    assert read.source_dims() == (64, 128, 3)
    assert np.array_equal(read.frame_hwc(), frame)


def test_packed_pipeline_matches_cv2(rng):
    """End-to-end through execute_operations with a packed host frame."""
    import cv2

    frame = rng.integers(0, 256, (96, 160, 3)).astype(np.uint8)
    rects = np.array([[i, i, 40, 48] for i in range(6)], np.int32)
    out = np.asarray(cvgs.execute_operations(
        cvgs.resize_batch(frame, rects=rects, dsize=cvgs.Size(32, 64)),
        cvgs.convert_to(np.float32, alpha=0.5),
        cvgs.split_tensor(),
        backend=cvgs.ParBackend.XLA,
    ))
    for z, (x, y, w, h) in enumerate(rects):
        crop = frame[y:y + h, x:x + w].astype(np.float32)
        ref = cv2.resize(crop, (32, 64), interpolation=cv2.INTER_LINEAR) * 0.5
        check_float(out[z], ref.transpose(2, 0, 1), tol=1e-5,
                    msg=f"packed plane {z}")


def test_packed_pallas_interpret_parity(rng):
    """A host frame (ingested packed) and the same frame already on the
    device (unpacked) give bit-identical results."""
    import jax

    frame = rng.integers(0, 256, (96, 256, 3)).astype(np.uint8)
    rects = np.array([[i, i, 40, 48] for i in range(4)], np.int32)
    ops = lambda f: [
        cvgs.resize_batch(f, rects=rects, dsize=cvgs.Size(32, 64)),
        cvgs.convert_to(np.float32, alpha=0.5),
        cvgs.split_tensor(),
    ]
    a = np.asarray(cvgs.execute_operations(*ops(frame)))
    b = np.asarray(cvgs.execute_operations(*ops(jax.device_put(frame))))
    check_float(b, a, tol=0, msg="device frame == packed host frame")


def test_packed_stack_mode(rng):
    imgs = [rng.integers(0, 256, (24 + 8 * i, 40, 3)).astype(np.uint8)
            for i in range(3)]
    read = cvgs.resize_batch(imgs, dsize=cvgs.Size(16, 16))
    assert read.packed_channels == 3
    assert read.stack.ndim == 3  # (N, maxH, maxW*C)
    out = np.asarray(cvgs.execute_operations(
        read, cvgs.convert_to(np.float32),
        backend=cvgs.ParBackend.XLA))
    import cv2
    for z, im in enumerate(imgs):
        ref = cv2.resize(im.astype(np.float32), (16, 16),
                         interpolation=cv2.INTER_LINEAR)
        check_float(out[z], ref, tol=1e-5, msg=f"stack plane {z}")
