"""API edge coverage: overloads and less-traveled paths of the factory
surface (completing the reference's overload matrix)."""

import cv2
import numpy as np
import pytest

import cvgpuspeedup_tpu as cvgs
from conftest import check_exact, check_float


def test_resize_with_fx_fy(rng):
    """cvGS::resize(src, dsize=(0,0), fx, fy) scale-factor form."""
    img = rng.integers(0, 256, (40, 60, 3)).astype(np.uint8)
    out = np.asarray(cvgs.execute_operations(
        cvgs.resize(img, cvgs.Size(0, 0), fx=0.5, fy=0.25)
    ))
    assert out.shape == (10, 30, 3)
    ref = cv2.resize(img.astype(np.float32), (30, 10), interpolation=cv2.INTER_LINEAR)
    check_float(out, ref, msg="fx/fy resize")


def test_execute_with_input_array(rng):
    """executeOperations(input, stream, iops...) overload: input= array."""
    img = rng.integers(0, 256, (16, 16, 3)).astype(np.uint8)
    out = np.asarray(cvgs.execute_operations(
        cvgs.convert_to(np.float32, alpha=2.0), input=img
    ))
    check_float(out, img.astype(np.float32) * 2.0, msg="input= overload")


def test_grayscale_2d_input(rng):
    img = rng.integers(0, 256, (12, 20)).astype(np.uint8)
    out = np.asarray(cvgs.execute_operations(cvgs.image(img), cvgs.multiply(2.0)))
    assert out.shape == (12, 20, 1)
    check_exact(out[..., 0], cv2.multiply(img, np.array(2.0)), "gray 2D")


def test_convert_to_float_beta(rng):
    img = rng.integers(0, 256, (8, 8, 3)).astype(np.uint8)
    out = np.asarray(cvgs.execute_operations(
        cvgs.image(img), cvgs.convert_to(np.float32, alpha=0.5, beta=-3.25)
    ))
    ref = cv2.addWeighted(img, 0.5, img, 0.0, -3.25, dtype=cv2.CV_32F).reshape(img.shape)
    check_float(out, ref, msg="float alpha+beta")


def test_crop_batch_same_size(rng):
    frame = rng.integers(0, 256, (64, 64, 3)).astype(np.uint8)
    rects = [cvgs.Rect(i, 2 * i, 16, 12) for i in range(4)]
    out = np.asarray(cvgs.execute_operations(cvgs.crop_batch(frame, rects)))
    assert out.shape == (4, 12, 16, 3)
    for i, r in enumerate(rects):
        check_exact(out[i], frame[r.y : r.y + 12, r.x : r.x + 16], f"crop {i}")
    with pytest.raises(ValueError):
        cvgs.crop_batch(frame, [cvgs.Rect(0, 0, 8, 8), cvgs.Rect(0, 0, 9, 8)])


def test_divergent_selector_out_of_range(rng):
    data = rng.random((2, 4, 4, 1), dtype=np.float32)
    seq = cvgs.build_operation_sequence(cvgs.image(data))
    with pytest.raises(ValueError):
        cvgs.launch_divergent_batch(lambda z: 5, seq)


def test_batched_pipeline_input_4d(rng):
    batch = rng.integers(0, 256, (3, 8, 8, 3)).astype(np.uint8)
    out = np.asarray(cvgs.execute_operations(
        cvgs.convert_to(np.float32), input=batch
    ))
    assert out.shape == (3, 8, 8, 3) and out.dtype == np.float32


def test_int16_negative_saturate(rng):
    img = (rng.random((8, 8, 1), dtype=np.float32) * 200000 - 100000).astype(np.float32)
    out = np.asarray(cvgs.execute_operations(
        cvgs.image(img), cvgs.convert_to(np.int16)
    ))
    ref = np.clip(np.rint(img), -32768, 32767).astype(np.int16)
    check_exact(out, ref, "negative saturate")


def test_convert_to_beta_only(rng):
    """Regression: beta without alpha must default alpha to 1.0 (OpenCV
    semantics), not corrupt the pipeline with NaN."""
    img = np.full((4, 4, 3), 100, np.uint8)
    out = np.asarray(cvgs.execute_operations(
        cvgs.image(img), cvgs.convert_to(np.uint8, beta=10.0)
    ))
    assert np.all(out == 110)
    outf = np.asarray(cvgs.execute_operations(
        cvgs.image(img), cvgs.convert_to(np.float32, beta=10.0)
    ))
    assert np.all(outf == 110.0)


def test_divergent_accepts_id_list(rng):
    data = rng.random((4, 4, 4, 1), dtype=np.float32)
    seq1 = cvgs.build_operation_sequence(cvgs.image(data), cvgs.multiply(2.0))
    seq2 = cvgs.build_operation_sequence(cvgs.image(data))
    out = np.asarray(cvgs.launch_divergent_batch([1, 2, 1, 2], seq1, seq2))
    check_float(out[0], data[0] * 2.0)
    check_float(out[1], data[1])


def test_divergent_lambda_reuses_cache(rng):
    """Fresh lambdas with identical routing must hit the compile cache."""
    from cvgpuspeedup_tpu.exec import executor
    data = rng.random((4, 4, 4, 1), dtype=np.float32)
    executor.clear_cache()
    for _ in range(3):
        seq = cvgs.build_operation_sequence(cvgs.image(data), cvgs.add(1.0))
        cvgs.launch_divergent_batch(lambda z: 1, seq)
    n = sum(1 for k in executor._CACHE if "divergent" in str(k))
    assert n == 1


def test_circular_tensor_snapshot():
    ct = cvgs.CircularTensor(width=4, height=4, channels=3, batch=2)
    ct.update(input=np.full((4, 4, 3), 1, np.uint8))
    snap = ct.snapshot()
    ct.update(input=np.full((4, 4, 3), 2, np.uint8))
    assert float(np.asarray(snap)[0, 0, 0, 0]) == 1.0


def test_resize_batch_2d_grayscale_frame(rng):
    """Regression: 2D frame gains its channel axis in frame mode."""
    frame = rng.integers(0, 256, (64, 64)).astype(np.uint8)
    out = np.asarray(cvgs.execute_operations(
        cvgs.resize_batch(frame, rects=np.array([[0, 0, 32, 32], [8, 8, 16, 16]],
                                                np.int32),
                          dsize=cvgs.Size(16, 16)),
        backend=cvgs.ParBackend.XLA,
    ))
    assert out.shape == (2, 16, 16, 1)
    ref = cv2.resize(frame[:32, :32].astype(np.float32), (16, 16))
    check_float(out[0, ..., 0], ref, msg="gray frame plane 0")


def test_warp_2d_grayscale(rng):
    img = rng.integers(0, 256, (12, 20)).astype(np.uint8)
    m = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    out = np.asarray(cvgs.execute_operations(cvgs.warp(img, m, cvgs.Size(10, 8))))
    assert out.shape == (8, 10, 1)
    check_float(out[..., 0], img[:8, :10].astype(np.float32))


def test_warp_channels_from_readop(rng):
    img = rng.integers(0, 256, (16, 16, 4)).astype(np.uint8)
    m = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    out = np.asarray(cvgs.execute_operations(
        cvgs.warp(cvgs.image(img), m, cvgs.Size(8, 8))
    ))
    assert out.shape == (8, 8, 4)


def test_batch_read_used_planes_requires_default(rng):
    ops = [cvgs.image(rng.random((4, 4, 3), dtype=np.float32)) for _ in range(2)]
    with pytest.raises(ValueError):
        cvgs.batch_read(ops, used_planes=1)


def test_pipeline_lower_outside_jit(rng):
    """Regression: direct Pipeline.lower with numpy leaves (eval_shape /
    eager use, as the driver may do with __graft_entry__.entry)."""
    frame = rng.integers(0, 256, (64, 64, 3)).astype(np.uint8)
    pipe = cvgs.build_pipeline(
        cvgs.resize_batch(frame, rects=np.array([[0, 0, 32, 32]], np.int32),
                          dsize=cvgs.Size(8, 8)),
    )
    out = np.asarray(pipe.lower())
    assert out.shape == (1, 8, 8, 3)


def test_pallas_scalar_vec_broadcast(rng):
    """A length-1 per-channel scalar broadcasts over every channel."""
    frame = rng.integers(0, 256, (296, 384, 3)).astype(np.uint8)
    rects = np.array([[0, 0, 60, 120]], np.int32)
    ops = lambda v: [
        cvgs.resize_batch(frame, rects=rects, dsize=cvgs.Size(64, 128)),
        cvgs.multiply(v),
        cvgs.split_tensor(),
    ]
    x = np.asarray(cvgs.execute_operations(*ops((2.0,))))
    p = np.asarray(cvgs.execute_operations(*ops((2.0, 2.0, 2.0))))
    check_float(x, p, tol=0, msg="len-1 scalar broadcast")
