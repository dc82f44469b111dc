"""Backend selection: every pipeline lowers through XLA.

``ParBackend`` keeps AUTO and XLA (the same choice); anything else passed as
a backend is refused rather than silently run. ``last_backend`` reports the
lowering a call used, and the sharded executor takes the same lowering as
the unsharded one.
"""

import jax
import numpy as np
import pytest

import cvgpuspeedup_tpu as cvgs
from cvgpuspeedup_tpu.exec import executor
from cvgpuspeedup_tpu.parallel import mesh as pmesh
from cvgpuspeedup_tpu.types import ParBackend


def _flagship_ops(frame, rects):
    return [
        cvgs.resize_batch(frame, rects=rects, dsize=cvgs.Size(64, 128)),
        cvgs.convert_to(np.float32, alpha=0.3),
        cvgs.subtract((3.2, 0.6, 11.8)),
        cvgs.divide((128.0, 128.0, 128.0)),
        cvgs.split_tensor(),
    ]


def _flagship(rng, n=8):
    frame = rng.integers(0, 256, (296, 384, 3)).astype(np.uint8)
    rects = np.array([[i, i, 60, 120] for i in range(n)], np.int32)
    return frame, rects


def test_parbackend_has_auto_and_xla_only():
    assert {b.name for b in ParBackend} == {"AUTO", "XLA"}


def test_flagship_reports_batch_resize_kernel(rng):
    """The flagship takes the XLA lowering under AUTO, bit-identical to an
    explicit XLA request."""
    frame, rects = _flagship(rng)
    auto = np.asarray(cvgs.execute_operations(*_flagship_ops(frame, rects)))
    xla = np.asarray(cvgs.execute_operations(*_flagship_ops(frame, rects),
                                             backend=ParBackend.XLA))
    assert np.array_equal(auto, xla)


def test_last_backend_records_xla_on_cpu(rng):
    frame, rects = _flagship(rng)
    cvgs.execute_operations(*_flagship_ops(frame, rects))
    assert executor.last_backend() == "xla"


def test_divergent_last_backend(rng):
    data = rng.integers(0, 200, (4, 8, 8, 3)).astype(np.float32)
    seq = cvgs.build_operation_sequence(cvgs.image(data), cvgs.add(1.0))
    cvgs.launch_divergent_batch([1, 1, 1, 1], seq)
    assert executor.last_backend() == "xla:divergent"


@pytest.mark.parametrize("bad", ["pallas", "xla", None])
def test_backend_must_be_parbackend(rng, bad):
    """A backend that is not a ParBackend (such as a request for a kernel
    this build does not have) raises instead of running XLA silently."""
    frame, rects = _flagship(rng, 2)
    with pytest.raises(TypeError, match="ParBackend"):
        cvgs.execute_operations(*_flagship_ops(frame, rects), backend=bad)
    seq = cvgs.build_operation_sequence(
        cvgs.image(np.zeros((2, 4, 4, 3), np.float32)))
    with pytest.raises(TypeError, match="ParBackend"):
        cvgs.launch_divergent_batch([1, 1], seq, backend=bad)


def test_sharded_auto_uses_profitability_gate(rng):
    """The sharded executor resolves AUTO like the unsharded one: XLA."""
    frame, rects = _flagship(rng, 16)
    mesh = pmesh.make_mesh(8)
    auto = pmesh.execute_sharded(*_flagship_ops(frame, rects), mesh=mesh)
    xla = pmesh.execute_sharded(*_flagship_ops(frame, rects), mesh=mesh,
                                backend=ParBackend.XLA)
    assert auto.sharding.spec == jax.sharding.PartitionSpec("batch")
    assert np.array_equal(np.asarray(auto), np.asarray(xla))
    with pytest.raises(TypeError, match="ParBackend"):
        pmesh.execute_sharded(*_flagship_ops(frame, rects), mesh=mesh,
                              backend="pallas")


def test_odd_height_frame_reports_xla_cliff(rng):
    """A 1079-row frame takes the same lowering as any other and matches
    cv2."""
    import cv2

    img = rng.integers(0, 256, (1079, 1920, 3)).astype(np.uint8)
    out = np.asarray(cvgs.execute_operations(
        cvgs.resize(cvgs.image(img), cvgs.Size(640, 360)),
        cvgs.convert_to(np.float32, alpha=1 / 255.0),
        cvgs.split_tensor(),
    ))
    assert executor.last_backend() == "xla"
    ref = cv2.resize(img.astype(np.float32), (640, 360),
                     interpolation=cv2.INTER_LINEAR) * np.float32(1 / 255.0)
    assert np.abs(out - ref.transpose(2, 0, 1)).max() <= 1e-4


def test_small_frame_profitability_gate(rng):
    """A tiny frame under AUTO and under XLA: one lowering, one result."""
    img = rng.integers(0, 256, (128, 128, 3)).astype(np.uint8)
    ops = lambda: [
        cvgs.resize(cvgs.image(img), cvgs.Size(64, 64)),
        cvgs.convert_to(np.float32, alpha=1 / 255.0),
        cvgs.split_tensor(),
    ]
    auto = np.asarray(cvgs.execute_operations(*ops()))
    xla = np.asarray(cvgs.execute_operations(*ops(), backend=ParBackend.XLA))
    assert np.array_equal(auto, xla)


def test_warp_reports_warp_kernel(rng):
    img = rng.integers(0, 256, (1080, 1920, 3)).astype(np.uint8)
    M = np.array([[0.55, 0.0, 23.0], [0.0, 0.62, 11.0]], np.float32)
    cvgs.execute_operations(
        cvgs.warp(cvgs.image(img), M, cvgs.Size(640, 360)),
        cvgs.convert_to(np.float32, alpha=1 / 255.0),
        cvgs.split_tensor(),
    )
    assert executor.last_backend() == "xla"
