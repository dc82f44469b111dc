"""Batch sharding over the 8-device virtual CPU mesh — the multi-chip path
(new scope, SURVEY.md §5.8; no reference analog)."""

import numpy as np
import pytest
import jax

import cvgpuspeedup_tpu as cvgs
from cvgpuspeedup_tpu.parallel import mesh as pmesh
from conftest import check_float


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) == 8, "conftest must set 8 virtual CPU devices"
    return pmesh.make_mesh(8)


def test_sharded_flagship_matches_single(rng, mesh8):
    frame = rng.integers(0, 256, (296, 384, 3)).astype(np.uint8)
    rects = np.array([[i, i, 60, 120] for i in range(16)], np.int32)
    ops = lambda: [
        cvgs.resize_batch(frame, rects=rects, dsize=cvgs.Size(64, 128)),
        cvgs.convert_to(np.float32, alpha=0.3),
        cvgs.subtract((3.2, 0.6, 11.8)),
        cvgs.divide((128.0, 128.0, 128.0)),
        cvgs.split_tensor(),
    ]
    single = np.asarray(cvgs.execute_operations(*ops(), backend=cvgs.ParBackend.XLA))
    sharded = pmesh.execute_sharded(*ops(), mesh=mesh8, backend=cvgs.ParBackend.XLA)
    assert sharded.sharding.spec == jax.sharding.PartitionSpec("batch")
    check_float(np.asarray(sharded), single, tol=0, msg="sharded == single")


def test_sharded_ragged_used_planes(rng, mesh8):
    """Global used_planes is rebased per shard (planes 0..10 active of 16)."""
    frame = rng.integers(0, 256, (296, 384, 3)).astype(np.uint8)
    rects = np.array([[i, i, 40, 80] for i in range(16)], np.int32)
    ops = lambda: [
        cvgs.resize_batch(frame, rects=rects, dsize=cvgs.Size(32, 64),
                          used_planes=11, background=5.0),
    ]
    single = np.asarray(cvgs.execute_operations(*ops(), backend=cvgs.ParBackend.XLA))
    sharded = np.asarray(
        pmesh.execute_sharded(*ops(), mesh=mesh8, backend=cvgs.ParBackend.XLA)
    )
    check_float(sharded, single, tol=0, msg="ragged sharded")
    assert np.all(sharded[11:] == 5.0)


def test_sharded_batched_image_pipeline(rng, mesh8):
    batch = rng.integers(0, 256, (8, 16, 32, 3)).astype(np.uint8)
    ops = lambda: [
        cvgs.image(batch),
        cvgs.convert_to(np.float32, alpha=2.0),
        cvgs.split_tensor(),
    ]
    single = np.asarray(cvgs.execute_operations(*ops(), backend=cvgs.ParBackend.XLA))
    sharded = np.asarray(pmesh.execute_sharded(*ops(), mesh=mesh8))
    check_float(sharded, single, tol=0, msg="image batch sharded")


def test_sharded_transposed_layout(rng, mesh8):
    batch = rng.integers(0, 256, (8, 16, 32, 3)).astype(np.uint8)
    ops = lambda: [cvgs.image(batch), cvgs.split_tensor_transposed()]
    single = np.asarray(cvgs.execute_operations(*ops(), backend=cvgs.ParBackend.XLA))
    sharded = pmesh.execute_sharded(*ops(), mesh=mesh8)
    assert sharded.sharding.spec == jax.sharding.PartitionSpec(None, "batch")
    check_float(np.asarray(sharded), single, tol=0, msg="transposed sharded")


def test_sharded_warp_batch(rng, mesh8):
    """BatchRead (warp_batch) sharding: per-plane matrices shard, the shared
    source frame (same array object on every plane) replicates."""
    frame = rng.integers(0, 256, (64, 128, 3)).astype(np.uint8)
    frame = jax.device_put(frame)  # one object shared by all sub-reads
    mats = [
        np.array([[1.0, 0.0, float(i)], [0.0, 1.0, float(i) / 2]], np.float32)
        for i in range(8)
    ]
    ops = lambda: [
        cvgs.warp_batch([frame] * 8, mats, cvgs.Size(32, 16)),
        cvgs.convert_to(np.float32, alpha=0.5),
    ]
    single = np.asarray(cvgs.execute_operations(*ops(), backend=cvgs.ParBackend.XLA))
    sharded = pmesh.execute_sharded(*ops(), mesh=mesh8, backend=cvgs.ParBackend.XLA)
    assert sharded.sharding.spec == jax.sharding.PartitionSpec("batch")
    check_float(np.asarray(sharded), single, tol=0, msg="warp batch sharded")


def test_sharded_warp_batch_ragged(rng, mesh8):
    frame = jax.device_put(rng.integers(0, 256, (64, 128, 3)).astype(np.uint8))
    mats = [np.array([[1.0, 0.0, float(i)], [0.0, 1.0, 0.0]], np.float32)
            for i in range(8)]
    ops = lambda: [
        cvgs.warp_batch([frame] * 8, mats, cvgs.Size(32, 16),
                        used_planes=5, default=7.0),
    ]
    single = np.asarray(cvgs.execute_operations(*ops(), backend=cvgs.ParBackend.XLA))
    sharded = np.asarray(
        pmesh.execute_sharded(*ops(), mesh=mesh8, backend=cvgs.ParBackend.XLA)
    )
    check_float(sharded, single, tol=0, msg="ragged warp batch sharded")
    assert np.all(sharded[5:] == 7.0)


def test_sharded_circular_batch_read(rng, mesh8):
    """CircularBatchRead sharding: the ring replicates, ``first`` rebases per
    shard; every rotation matches the single-device modular view."""
    ring = rng.integers(0, 256, (16, 8, 16, 3)).astype(np.uint8)
    for first in (0, 3, 15):
        for asc in (True, False):
            ops = lambda: [
                cvgs.circular_batch_read(ring, first=first, ascendent=asc),
                cvgs.convert_to(np.float32, alpha=1.0),
            ]
            single = np.asarray(
                cvgs.execute_operations(*ops(), backend=cvgs.ParBackend.XLA)
            )
            sharded = np.asarray(
                pmesh.execute_sharded(*ops(), mesh=mesh8,
                                      backend=cvgs.ParBackend.XLA)
            )
            check_float(sharded, single, tol=0,
                        msg=f"circular sharded first={first} asc={asc}")


def test_sharded_pallas_interpret_bitexact(rng, mesh8):
    """The flagship sharded over the mesh with a ragged tail (used_planes
    cuts inside a shard): bit-identical to the single-device run and within
    the float contract of the numpy reference."""
    from chip_smoke import ref_batch_resize

    frame = rng.integers(0, 256, (296, 384, 3)).astype(np.uint8)
    rects = np.array([[i, i, 60, 120] for i in range(16)], np.int32)
    ops = lambda: [
        cvgs.resize_batch(frame, rects=rects, dsize=cvgs.Size(64, 128),
                          used_planes=13, background=7.0),
        cvgs.convert_to(np.float32, alpha=0.3),
        cvgs.subtract((3.2, 0.6, 11.8)),
        cvgs.divide((128.0, 128.0, 128.0)),
        cvgs.split_tensor(),
    ]
    single = np.asarray(cvgs.execute_operations(*ops()))
    out = pmesh.execute_sharded(*ops(), mesh=mesh8)
    assert out.sharding.spec == jax.sharding.PartitionSpec("batch")
    check_float(np.asarray(out), single, tol=0, msg="sharded == single")
    ref = ref_batch_resize(frame, rects, 64, 128, background=7.0, used=13)
    ref = (ref * 0.3 - np.array([3.2, 0.6, 11.8])) / 128.0
    check_float(np.asarray(out), ref.transpose(0, 3, 1, 2),
                msg="sharded flagship vs reference")


def test_plane_count_must_divide(rng, mesh8):
    frame = rng.integers(0, 256, (296, 384, 3)).astype(np.uint8)
    rects = np.array([[0, 0, 8, 8]] * 6, np.int32)
    with pytest.raises(ValueError):
        pmesh.execute_sharded(
            cvgs.resize_batch(frame, rects=rects, dsize=cvgs.Size(8, 8)),
            mesh=mesh8,
        )


def test_sharded_warp_batch_pallas_kernel(rng, mesh8):
    """warp_batch inside shard_map: per-plane coordinate terms shard, the
    shared frame replicates; bit-identical to the single-device run and
    within the float contract of the numpy warp reference."""
    import cv2
    from chip_smoke import ref_warp

    img = rng.integers(0, 256, (96, 384, 3)).astype(np.uint8)
    frame = jax.device_put(img)
    mats = [cv2.getRotationMatrix2D((192, 48), 3.0 * i - 10, 1.0 + 0.05 * i)
            for i in range(8)]
    ops = lambda: [
        cvgs.warp_batch([frame] * 8, mats, cvgs.Size(128, 64)),
        cvgs.multiply(0.5),
        cvgs.split_tensor(),
    ]
    single = np.asarray(cvgs.execute_operations(*ops()))
    shp = pmesh.execute_sharded(*ops(), mesh=mesh8)
    assert shp.sharding.spec == jax.sharding.PartitionSpec("batch")
    check_float(np.asarray(shp), single, tol=0, msg="sharded batch warp")
    ref = np.stack([ref_warp(img, m, 128, 64) * np.float32(0.5)
                    for m in mats]).transpose(0, 3, 1, 2)
    check_float(np.asarray(shp), ref, msg="sharded batch warp vs reference")


def test_sharded_divergent(rng, mesh8):
    """Divergent batch sharded over the mesh (VERDICT r4 #9): plane routing
    rides a runtime id slice per shard; crop-resize frames replicate,
    rects/pass-through stacks shard, rings rebase."""
    n = 16
    frame = rng.integers(0, 256, (296, 384, 3)).astype(np.uint8)
    rects = np.array([[5 * z, 3 * z, 60, 120] for z in range(n)], np.int32)
    flat = rng.integers(0, 200, (n, 128, 64, 3)).astype(np.float32)
    ring = rng.integers(0, 256, (n, 128, 64, 3)).astype(np.uint8)
    seq1 = cvgs.build_operation_sequence(
        cvgs.resize_batch(frame, rects=rects, dsize=cvgs.Size(64, 128)),
        cvgs.convert_to(np.float32, alpha=0.5), cvgs.write_tensor())
    seq2 = cvgs.build_operation_sequence(
        cvgs.image(flat), cvgs.multiply(2.0), cvgs.write_tensor())
    seq3 = cvgs.build_operation_sequence(
        cvgs.circular_batch_read(ring, first=5),
        cvgs.convert_to(np.float32, alpha=0.25), cvgs.write_tensor())
    ids = [1 + (z % 3) for z in range(n)]
    single = np.asarray(cvgs.launch_divergent_batch(
        ids, seq1, seq2, seq3, backend=cvgs.ParBackend.XLA))
    for be in (cvgs.ParBackend.AUTO, cvgs.ParBackend.XLA):
        out = pmesh.execute_divergent_sharded(
            ids, seq1, seq2, seq3, mesh=mesh8, backend=be)
        assert out.sharding.spec == jax.sharding.PartitionSpec("batch")
        check_float(np.asarray(out), single, tol=0,
                    msg=f"sharded divergent {be.name}")
