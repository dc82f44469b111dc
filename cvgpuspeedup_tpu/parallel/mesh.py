"""Multi-chip / multi-host batch sharding of fused pipelines.

The reference is single-GPU (SURVEY.md §0.5); multi-device scaling is new
scope: the batch (plane) axis of a fused pipeline shards across a
``jax.sharding.Mesh``, each device runs the SAME fused program on its plane
slice (embarrassingly parallel — each image's
pipeline is independent), and collectives appear only where an output tensor
must be reassembled or metrics reduced (SURVEY.md §5.8).

Entry points:

- :func:`make_mesh` — 1-D device mesh over the batch axis (multi-host: pass
  ``jax.devices()`` after ``jax.distributed.initialize``; the cards of a
  host are joined all to all, so the mesh follows the algorithm alone).
- :func:`execute_sharded` — ``execute_operations`` over a mesh: per-plane
  parameter leaves (rects, stacked sources) are partitioned, broadcast leaves
  (the shared frame, scalars) replicate, ragged ``used_planes`` is rebased
  per shard, and the write layout determines the output partition axis.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..exec.executor import Pipeline, _check_backend, build_pipeline
from ..graph import IOp, ReadOp, op, static_field
from ..ops.memory import (BatchRead, CircularBatchRead, ImageRead, SplitWrite,
                          TensorTSplit)
from ..ops.resize import BatchResizeRead
from ..types import ParBackend

__all__ = ["initialize_distributed", "make_mesh", "execute_sharded",
           "execute_divergent_sharded", "scaling_efficiency"]

# compile cache: (treedef, mesh, axis) -> jitted shard_map program, so
# parameter-only changes reuse the compiled program like execute_operations
_SHARD_CACHE: dict = {}

#: pipeline-leaf field names that carry the plane (batch) axis as dim 0
_PLANE_AXIS_FIELDS = ("rects", "stack", "data")


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> Mesh:
    """Multi-host bring-up: ``jax.distributed.initialize`` + a global batch
    mesh over every device of every process.

    Pass the coordinator address, process count and process id explicitly
    (nothing detects a cluster automatically). Each host then calls
    :func:`execute_sharded`
    with its host-local inputs — the host-local-feeding model the north star
    prescribes (SURVEY.md §5.8).
    """
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return make_mesh()


def make_mesh(n: Optional[int] = None, axis: str = "batch", devices=None) -> Mesh:
    devices = list(devices if devices is not None else jax.devices())
    if n is not None:
        devices = devices[:n]
    return Mesh(np.array(devices), (axis,))


def _leaf_spec(path, axis: str, read=None):
    # A CircularBatchRead's ring buffer is named "data" but must REPLICATE:
    # output plane z reads input plane (first +/- z) % N, so a shard needs
    # ring planes outside its own output range — the per-shard remap rebases
    # ``first`` instead (see local_run). Name-based plane routing applies to
    # the partitionable reads only.
    if isinstance(read, CircularBatchRead):
        return P()
    names = {getattr(p, "name", None) for p in path}
    if names & set(_PLANE_AXIS_FIELDS):
        return P(axis)
    return P()


def _write_out_spec(pipeline, axis: str):
    """Output partition from the write layout's plane axis."""
    if isinstance(pipeline.write, TensorTSplit):
        return P(None, axis)
    if isinstance(pipeline.write, SplitWrite):
        outs = jax.eval_shape(pipeline.lower)
        return tuple(P(axis) for _ in outs)
    return P(axis)


def execute_sharded(
    *iops: IOp,
    mesh: Mesh,
    input=None,
    backend: ParBackend = ParBackend.AUTO,
):
    """Run a batched fused pipeline with its plane axis sharded over ``mesh``.

    The plane count must divide the mesh size. Returns a globally-sharded
    array (jax.Array with NamedSharding); callers on a multi-host pod see
    their local shard, exactly the host-local-output model the north star
    prescribes.
    """
    _check_backend(backend)
    axis = mesh.axis_names[0]
    nsh = mesh.shape[axis]
    pipeline = build_pipeline(*iops, input=input)
    read = pipeline.read
    if not read.batched:
        raise ValueError("execute_sharded needs a batched read op")
    if isinstance(read, ImageRead):
        n_planes = int(read.data.shape[0])
    elif isinstance(read, BatchResizeRead):
        n_planes = read.num_planes
    elif isinstance(read, CircularBatchRead):
        n_planes = int(read.data.shape[0])
    elif isinstance(read, BatchRead):
        return _execute_sharded_batchread(pipeline, mesh, axis, nsh)
    else:
        raise NotImplementedError(
            f"sharding of {type(read).__name__} is not supported (its plane "
            "semantics are not a plain partition)"
        )
    if n_planes % nsh:
        raise ValueError(f"plane count {n_planes} must divide mesh size {nsh}")
    local_n = n_planes // nsh

    leaves_path, treedef = jax.tree_util.tree_flatten_with_path(pipeline)
    specs = tuple(_leaf_spec(path, axis, read) for path, _ in leaves_path)
    leaves = tuple(leaf for _, leaf in leaves_path)

    out_spec = _write_out_spec(pipeline, axis)

    cache_key = (treedef, mesh, axis)
    jitted = _SHARD_CACHE.get(cache_key)
    if jitted is None:

        def local_run(*lv):
            p: Pipeline = jax.tree_util.tree_unflatten(treedef, list(lv))
            rd = p.read
            idx = jax.lax.axis_index(axis)
            if isinstance(rd, BatchResizeRead) and rd.used_planes is not None:
                # rebase the global ragged count onto this shard's plane range
                local_used = jnp.clip(rd.used_planes - idx * local_n, 0, local_n)
                rd = dataclasses.replace(rd, used_planes=local_used)
                p = dataclasses.replace(p, read=rd)
            elif isinstance(rd, CircularBatchRead):
                # ring data is replicated; each shard's output planes are the
                # global range [idx*local_n, (idx+1)*local_n), reached by
                # rebasing the modular start index
                off = idx * jnp.int32(local_n)
                first = rd.first + off if rd.ascendent else rd.first - off
                p = dataclasses.replace(p, read=_LocalRingView(
                    data=rd.data, first=first, ascendent=rd.ascendent,
                    local_n=local_n, packed_channels=rd.packed_channels,
                ))
            return p.lower()

        jitted = jax.jit(shard_map(
            local_run, mesh=mesh, in_specs=specs, out_specs=out_spec))
        _SHARD_CACHE[cache_key] = jitted
    with mesh:
        return jitted(*leaves)


@op
class _LocalRingView(ReadOp):
    """One shard's slice of a replicated :class:`CircularBatchRead` ring:
    ``local_n`` output planes starting at the shard-rebased modular index."""

    data: jnp.ndarray
    first: jnp.ndarray
    ascendent: bool = static_field(default=True)
    local_n: int = static_field(default=1)
    packed_channels: int = static_field(default=0)

    batched = True

    def lower(self) -> jnp.ndarray:
        n = self.data.shape[0]
        z = jnp.arange(self.local_n)
        src = (self.first + z) % n if self.ascendent else (self.first - z) % n
        x = jnp.take(self.data, src, axis=0)
        if self.packed_channels:
            c = self.packed_channels
            x = x.reshape(x.shape[:-1] + (x.shape[-1] // c, c))
        return x

    def describe(self) -> str:
        return f"LocalRingView[{self.local_n}/{self.data.shape[0]}]"


def _execute_sharded_batchread(pipeline: Pipeline, mesh: Mesh, axis: str,
                               nsh: int):
    """Shard a :class:`BatchRead` pipeline (e.g. ``warp_batch``): the plane
    axis is the sub-read TUPLE, not an array axis, so per-plane leaves are
    stacked into sharded arrays while leaves shared BY IDENTITY across every
    sub-read (a common source frame) stay replicated — one copy per device,
    not one per plane."""
    read: BatchRead = pipeline.read
    n_planes = len(read.ops)
    if n_planes % nsh:
        raise ValueError(f"plane count {n_planes} must divide mesh size {nsh}")
    local_n = n_planes // nsh

    sub = [jax.tree_util.tree_flatten(o) for o in read.ops]
    sub_defs = {d for _, d in sub}
    if len(sub_defs) != 1:
        raise NotImplementedError(
            "BatchRead sharding needs structurally identical sub-reads "
            "(same op types and static fields on every plane)"
        )
    sub_def = sub[0][1]
    n_leaf = len(sub[0][0])
    shared = tuple(
        all(sub[z][0][j] is sub[0][0][j] for z in range(n_planes))
        for j in range(n_leaf)
    )
    sub_leaves = tuple(
        sub[0][0][j] if shared[j]
        else jnp.stack([jnp.asarray(sub[z][0][j]) for z in range(n_planes)])
        for j in range(n_leaf)
    )
    sub_specs = tuple(P() if shared[j] else P(axis) for j in range(n_leaf))

    rest = dataclasses.replace(pipeline,
                               read=dataclasses.replace(read, ops=()))
    rest_lp, rest_def = jax.tree_util.tree_flatten_with_path(rest)
    rest_leaves = tuple(l for _, l in rest_lp)
    rest_specs = tuple(P() for _ in rest_lp)  # used_planes/default/chain/write

    out_spec = _write_out_spec(pipeline, axis)

    cache_key = (rest_def, sub_def, shared, n_planes, mesh, axis)
    jitted = _SHARD_CACHE.get(cache_key)
    if jitted is None:

        def local_run(sub_lv, rest_lv):
            p: Pipeline = jax.tree_util.tree_unflatten(rest_def, list(rest_lv))
            rd = p.read
            idx = jax.lax.axis_index(axis)
            ops_local = tuple(
                jax.tree_util.tree_unflatten(
                    sub_def,
                    [sub_lv[j] if shared[j] else sub_lv[j][z]
                     for j in range(n_leaf)],
                )
                for z in range(local_n)
            )
            up = rd.used_planes
            if up is not None:
                up = jnp.clip(up - idx * local_n, 0, local_n)
            rd = dataclasses.replace(rd, ops=ops_local, used_planes=up)
            p = dataclasses.replace(p, read=rd)
            return p.lower()

        jitted = jax.jit(
            shard_map(local_run, mesh=mesh, in_specs=(sub_specs, rest_specs),
                      out_specs=out_spec)
        )
        _SHARD_CACHE[cache_key] = jitted
    with mesh:
        return jitted(sub_leaves, rest_leaves)


def execute_divergent_sharded(
    selector,
    *sequences: Pipeline,
    mesh: Mesh,
    backend: ParBackend = ParBackend.AUTO,
):
    """Shard a divergent batch (``launch_divergent_batch``) over the mesh's
    plane axis: every shard runs its local planes' sequences in one program.

    Plane routing is a RUNTIME array — each shard gets its slice of the
    global plane->sequence map, so one traced program serves every shard
    (static per-shard routing is impossible inside shard_map). Sources with
    a leading plane axis shard; shared frames replicate; circular rings
    replicate with a per-shard rebased ``first``. BatchRead sequences are
    not shardable here and raise.
    """
    _check_backend(backend)
    axis = mesh.axis_names[0]
    nsh = mesh.shape[axis]
    seqs = list(sequences)
    n_planes = jax.eval_shape(seqs[0].read.lower).shape[0]
    if callable(selector):
        plane_ids = tuple(selector(z) for z in range(n_planes))
    else:
        plane_ids = tuple(int(i) for i in selector)
        if len(plane_ids) != n_planes:
            raise ValueError(
                f"selector list has {len(plane_ids)} entries for "
                f"{n_planes} planes")
    if n_planes % nsh:
        raise ValueError(f"plane count {n_planes} must divide mesh size {nsh}")
    local_n = n_planes // nsh
    for seq in seqs:
        if isinstance(seq.read, BatchRead):
            # BatchRead sequences (warp groups, NV12 camera groups) hold
            # per-plane sub-reads that this plane partitioner cannot slice —
            # refuse cleanly instead of failing downstream with a
            # broadcast/trace error
            raise NotImplementedError(
                "sharded divergent BatchRead sequences are not supported "
                "(their per-plane structure is global-plane indexed); shard "
                "warp_batch via execute_sharded instead")

    gids_global = jnp.asarray(plane_ids, jnp.int32)
    n_seq = len(seqs)

    flat = [jax.tree_util.tree_flatten_with_path(s) for s in seqs]
    seq_defs = tuple(d for _, d in flat)
    seq_leaves = tuple(tuple(l for _, l in lp) for lp, _ in flat)
    seq_specs = tuple(
        tuple(_leaf_spec(path, axis, seqs[i].read) for path, _ in flat[i][0])
        for i in range(n_seq)
    )
    out_spec = _write_out_spec(seqs[0], axis)

    cache_key = (seq_defs, "divergent", plane_ids, mesh)
    jitted = _SHARD_CACHE.get(cache_key)
    if jitted is None:

        def local_run(gid_loc, *leaves_per_seq):
            idx = jax.lax.axis_index(axis)
            local_seqs = []
            for i in range(n_seq):
                s: Pipeline = jax.tree_util.tree_unflatten(
                    seq_defs[i], list(leaves_per_seq[i]))
                rd = s.read
                if isinstance(rd, CircularBatchRead):
                    off = idx * jnp.int32(local_n)
                    first = (rd.first + off if rd.ascendent
                             else rd.first - off)
                    s = dataclasses.replace(
                        s, read=dataclasses.replace(rd, first=first))
                local_seqs.append(s)
            # masked merge: routing is runtime here, so every sequence
            # computes its local planes and the gid mask selects — redundant
            # work, but shard-uniform (static grouping needs static ids,
            # impossible inside shard_map)
            outs = []
            for s in local_seqs:
                rd = s.read
                if isinstance(rd, CircularBatchRead):
                    x = _LocalRingView(
                        data=rd.data, first=rd.first, ascendent=rd.ascendent,
                        local_n=local_n,
                        packed_channels=rd.packed_channels).lower()
                else:
                    x = rd.lower()
                for o in s.compute:
                    x = o.apply(x)
                outs.append(x)
            merged = outs[0]
            gcol = gid_loc.reshape((local_n,) + (1,) * (outs[0].ndim - 1))
            for k in range(1, n_seq):
                merged = jnp.where(gcol == k + 1, outs[k], merged)
            return local_seqs[0].write.write(merged)

        jitted = jax.jit(shard_map(
            local_run, mesh=mesh,
            in_specs=(P(axis),) + tuple(seq_specs),
            out_specs=out_spec,
        ))
        _SHARD_CACHE[cache_key] = jitted
    with mesh:
        return jitted(gids_global, *seq_leaves)


def scaling_efficiency(images_per_sec_n: float, images_per_sec_1: float, n: int) -> float:
    """Linear-scaling efficiency: throughput on n devices over n times the
    single-device throughput."""
    return images_per_sec_n / (n * images_per_sec_1)
