"""Flagship type/batch sweeps — mirroring the reference's combinatorics
(``test_batchresize_x_split3D.cu``: 6 type combos x batch 10..50, to 300 in
benchmark mode; our oracle sweep covers dtype x channels x batch)."""

import cv2
import numpy as np
import pytest

import cvgpuspeedup_tpu as cvgs
from chip_smoke import ref_batch_resize
from conftest import check_float

UP = (32, 64)


def _frame(rng, dtype, ch):
    shape = (296, 384, ch)
    if np.issubdtype(dtype, np.integer):
        return rng.integers(0, min(np.iinfo(dtype).max, 4096) + 1, shape).astype(dtype)
    return (rng.random(shape, dtype=np.float32) * 255).astype(dtype)


@pytest.mark.parametrize(
    "dtype", [np.uint8, np.uint16, np.int16, np.int32, np.float32, np.float64]
)
@pytest.mark.parametrize("ch", [1, 2, 3, 4])
def test_type_sweep_xla_and_pallas(rng, dtype, ch):
    """Reference sweeps 26 dtype combos over the batched pipelines
    (``tests/batchread/test_batchread_x_write3D.cu:28-31``); this covers
    every SUPPORTED_DEPTH x channel count, against cv2 and the numpy
    reference."""
    frame = _frame(rng, dtype, ch)
    rects = np.array([[i, 2 * i, 40, 56] for i in range(4)], np.int32)
    ops = lambda: [
        cvgs.resize_batch(frame, rects=rects, dsize=cvgs.Size(*UP), channels=ch),
        cvgs.multiply(0.5),
        cvgs.split_tensor(),
    ]
    x = np.asarray(cvgs.execute_operations(*ops(), backend=cvgs.ParBackend.XLA))
    assert x.shape == (4, ch, UP[1], UP[0])
    # cv2 oracle per plane
    for z in range(4):
        xx, y, w, h = rects[z]
        crop = frame[y : y + h, xx : xx + w].astype(np.float32)
        ref = cv2.resize(crop, UP, interpolation=cv2.INTER_LINEAR)
        ref = ref.reshape(UP[1], UP[0], ch) * np.float32(0.5)
        check_float(x[z], ref.transpose(2, 0, 1), msg=f"{dtype} c{ch} z={z}")
    ref = ref_batch_resize(frame, rects, *UP) * 0.5
    check_float(x, ref.transpose(0, 3, 1, 2), msg=f"reference {dtype} c{ch}")


def test_batch_300_stress(rng):
    """The CUDA-12 benchmark-mode scale (batch 300) — no 4KB-param analog
    here: per-plane params are arrays, so large batches neither recompile
    nor hit a parameter limit."""
    frame = _frame(rng, np.uint8, 3)
    rects = np.array([[i % 200, i % 150, 30, 40] for i in range(300)], np.int32)
    out = np.asarray(cvgs.execute_operations(
        cvgs.resize_batch(frame, rects=rects, dsize=cvgs.Size(16, 16)),
        backend=cvgs.ParBackend.XLA,
    ))
    assert out.shape == (300, 16, 16, 3)
    z = 123
    x, y, w, h = rects[z]
    ref = cv2.resize(frame[y:y+h, x:x+w].astype(np.float32), (16, 16))
    check_float(out[z], ref, msg="batch300 plane 123")


def test_batch_size_change_no_recompile(rng):
    """Batch-size buckets: same structure at the same N reuses the program;
    a different N is a new structure (shape) but params within N never
    recompile."""
    from cvgpuspeedup_tpu.exec import executor
    frame = _frame(rng, np.uint8, 3)
    executor.clear_cache()
    for shift in range(3):
        rects = np.array([[i + shift, i, 20, 24] for i in range(8)], np.int32)
        cvgs.execute_operations(
            cvgs.resize_batch(frame, rects=rects, dsize=cvgs.Size(8, 8)),
            backend=cvgs.ParBackend.XLA,
        )
    assert len(executor._CACHE) == 1
