"""The executor — ``execute_operations`` and the pipeline compile cache.

JAX equivalent of ``fk::executeOperations`` + the TransformDPP launcher
(reference F12; wrapper overloads at ``include/cvGPUSpeedup.cuh:464-584``).

The reference performs fusion at C++ compile time and launches one CUDA kernel
per call. Here, a pipeline's *structure* (op classes, dtypes, static geometry)
lives in the pytree treedef while all runtime parameters (images, rects,
scalars) are leaves, so:

- first call with a given structure: trace + XLA compile -> ONE fused
  device program (the single-kernel guarantee);
- every later call with new parameter values: cache hit, zero Python-side
  rebuild — the analog of the reference's "graph build is allocation-free and
  ≈ free on CPU" property (``benchmarks/benchmark_CPUandGPU_cvGS_vs_fk.cu:116-184``).

The reference's 12 ``executeOperations`` overloads collapse to one Python
signature: reads/writes are inferred when omitted, exactly like
``FirstInstantiableOperationInputType_t`` / ``LastInstantiableOperationOutputType_t``
derive them in the wrapper (``include/cvGPUSpeedup.cuh:479-494``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from ..graph import ComputeOp, FusedCompute, FusedRead, IOp, PendingReadOp, ReadOp, WriteOp, op
from ..ops.memory import ImageRead, Write2D
from ..types import ParBackend

__all__ = [
    "Pipeline",
    "build_pipeline",
    "execute_operations",
    "build_operation_sequence",
    "launch_divergent_batch",
    "clear_cache",
    "last_backend",
]


@op
class Pipeline:
    """A fully-normalized pipeline: read head, pointwise chain, write tail.

    This is the analog of the reference's "details" struct built by
    ``TransformDPP::build_details`` (``benchmarks/benchmark_image_resolution_
    MAD_loop.cu:66``): everything the fused kernel needs, ready to launch.
    """

    read: ReadOp
    compute: Tuple[ComputeOp, ...]
    write: WriteOp

    def lower(self):
        x = self.read.lower()
        for o in self.compute:
            x = o.apply(x)
        return self.write.write(x)

    def describe(self) -> str:
        parts = [self.read.describe()]
        parts += [o.describe() for o in self.compute]
        parts += [self.write.describe()]
        return " -> ".join(parts)


def build_pipeline(*iops: IOp, input: Optional[jnp.ndarray] = None) -> Pipeline:
    """Normalize a user op list into a :class:`Pipeline`.

    - ``input=`` supplies the source array when the first op is not a read
      (the ``executeOperations(input, stream, iops...)`` overload family);
      rank-4 arrays are treated as batched (N, H, W, C).
    - A missing terminal write defaults to the packed layout
      (``PerThreadWrite`` derivation, ``include/cvGPUSpeedup.cuh:493-494``).
    """
    ops_list = list(iops)
    if input is not None:
        if ops_list and isinstance(ops_list[0], ReadOp):
            raise ValueError("pass either an input array or a leading read op, not both")
        ops_list.insert(0, ImageRead(data=input, is_batch=(input.ndim == 4)))
    if not ops_list or not isinstance(ops_list[0], ReadOp):
        raise ValueError("pipeline needs a read op or an input array at its head")
    read = ops_list[0]

    write: WriteOp
    if isinstance(ops_list[-1], WriteOp):
        write = ops_list[-1]
        middle = ops_list[1:-1]
    else:
        write = Write2D()
        middle = ops_list[1:]

    compute: list = []
    for o in middle:
        if isinstance(o, PendingReadOp):
            # geometry op used positionally (cvGS::resize(dsize) after a
            # fused read): bind it to everything accumulated so far
            if compute:
                read = FusedRead(read=read, chain=tuple(compute))
                compute = []
            read = o.bind(read)
        elif isinstance(o, FusedCompute):
            compute.extend(o.ops)
        elif isinstance(o, ComputeOp):
            compute.append(o)
        else:
            raise TypeError(
                f"mid-pipeline ops must be compute ops, got {type(o).__name__}"
            )
    return Pipeline(read=read, compute=tuple(compute), write=write)


# --- compile cache --------------------------------------------------------

_CACHE: Dict[object, Callable] = {}


def clear_cache() -> None:
    _CACHE.clear()


_LAST_BACKEND: Optional[str] = None


def last_backend() -> Optional[str]:
    """The lowering used by the most recent :func:`execute_operations` /
    :func:`launch_divergent_batch` call in this process (None before any):
    ``"xla"`` or ``"xla:divergent"``."""
    return _LAST_BACKEND


def _check_backend(backend) -> None:
    if not isinstance(backend, ParBackend):
        raise TypeError(f"backend must be a ParBackend, got {backend!r}")


def _compiled(treedef) -> Callable:
    fn = _CACHE.get(treedef)
    if fn is None:

        def run(leaves):
            return jax.tree_util.tree_unflatten(treedef, leaves).lower()

        fn = jax.jit(run)
        _CACHE[treedef] = fn
    return fn


def execute_operations(
    *iops: IOp,
    input: Optional[jnp.ndarray] = None,
    backend: ParBackend = ParBackend.AUTO,
):
    """Fuse the op chain into one device program and run it.

    Returns the output array (or tuple of arrays for ``SplitWrite``). The
    compiled program is cached by pipeline structure; parameter-only changes
    (new frames, new rects, new scalars) reuse it.
    """
    _check_backend(backend)
    pipeline = build_pipeline(*iops, input=input)
    global _LAST_BACKEND
    _LAST_BACKEND = "xla"
    leaves, treedef = jax.tree_util.tree_flatten(pipeline)
    return _compiled(treedef)(leaves)


# --- divergent batch (reference F9) ---------------------------------------


def build_operation_sequence(*iops: IOp) -> Pipeline:
    """Pack one per-plane operation sequence — ``fk::buildOperationSequence``
    (reference ``tests/batchread/test_circularbatchread_x_write3D.cu:89-94``)."""
    return build_pipeline(*iops)


def launch_divergent_batch(
    selector: Callable[[int], int],
    *sequences: Pipeline,
    backend: ParBackend = ParBackend.AUTO,
):
    """Run different op sequences on different planes of one batch.

    ``selector(z)`` returns the **1-based** sequence id for plane ``z`` (the
    reference's ``SequenceSelector::at`` device functor,
    ``tests/resize/test_fused_resize.cu:22-26``). The selector is static — it
    is evaluated at trace time, so XLA compiles exactly the work each plane
    needs (the analog of the per-plane template dispatch). All sequences
    must produce batches of the same plane count and element shape; the write
    layout of the first sequence is applied to the merged batch.

    A precomputed per-plane id sequence may be passed instead of a callable.

    Lowering: per-group region computations + scatter merge, one jitted
    program — the analog of the reference's single
    ``launchDivergentBatchTransformDPP_Kernel``.
    """
    if not sequences:
        raise ValueError("need at least one operation sequence")

    seqs = list(sequences)
    # Evaluate the static selector up front into a hashable id tuple so the
    # compile cache keys on plane ROUTING, not on the callable's identity
    # (callers naturally pass fresh lambdas per call). A precomputed
    # sequence of ids is also accepted directly.
    n_planes = jax.eval_shape(seqs[0].read.lower).shape[0]
    if callable(selector):
        plane_ids = tuple(selector(z) for z in range(n_planes))
    else:
        plane_ids = tuple(int(i) for i in selector)
        if len(plane_ids) != n_planes:
            raise ValueError(
                f"selector list has {len(plane_ids)} entries for {n_planes} planes"
            )
    for z, sid in enumerate(plane_ids):
        if not 1 <= sid <= len(seqs):
            raise ValueError(f"selector({z}) = {sid} out of range")

    _check_backend(backend)
    global _LAST_BACKEND
    _LAST_BACKEND = "xla:divergent"

    def run(seq_list):
        # group planes by sequence id at trace time (the selector is static,
        # like the reference's constexpr SequenceSelector::at) so each
        # sequence computes ONLY its own planes, then scatter back in order
        n = n_planes
        groups: dict = {}
        for z in range(n):
            sid = plane_ids[z]
            groups.setdefault(sid, []).append(z)
        merged = None
        for sid, planes in groups.items():
            s = seq_list[sid - 1]
            x = s.read.lower_planes(tuple(planes))
            for o in s.compute:
                x = o.apply(x)
            if merged is None:
                merged = jnp.zeros((n,) + x.shape[1:], dtype=x.dtype)
            merged = merged.at[jnp.asarray(planes)].set(x)
        return seq_list[0].write.write(merged)

    leaves, treedef = jax.tree_util.tree_flatten(seqs)
    key = (treedef, "divergent", plane_ids)
    fn = _CACHE.get(key)
    if fn is None:

        def traced(ls):
            return run(jax.tree_util.tree_unflatten(treedef, ls))

        fn = jax.jit(traced)
        _CACHE[key] = fn
    return fn(leaves)
