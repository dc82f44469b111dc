"""The lazy operation-graph IR — heart of the framework front-end.

A JAX re-design of the reference's "Instantiable Operation" (IOp) model
(reference F4; usage ``include/cvGPUSpeedup.cuh:74-265``): factory functions
build parameterized op nodes that execute nothing; ``execute_operations``
compiles the whole chain into a single fused device program.

Where the reference encodes the graph in C++ template types (compile-time
fusion by ``nvcc``), we encode it in **pytree structure**: every op is a frozen
dataclass registered as a JAX pytree whose

- *leaves*  = runtime parameters (images, crop rects, scalars) — can change
  every call without recompilation, and
- *treedef* = static structure (dtypes, output sizes, op ordering) — the jit
  cache key.

``jax.jit`` over the flattened pipeline is therefore the exact analog of the
reference's "compile-time CUDA Graphs" (``README.md:36``): one compiled XLA
program per pipeline *structure*, reused across frames.

Composition mirrors the reference surface:

- ``a.then(b)``  — sequential fusion (reference ``include/cvGPUSpeedup.cuh:95-127``).
- ``fuse(a, b, ...)`` — same, variadic (reference ``fk::fuse`` usage
  ``tests/resize/test_fused_resize.cu:73-77``).
- Read ops can wrap other read ops as their sampling source ("back op"),
  e.g. resize-over-NV12-read (reference ``fk::Resize<...>::build(backIOp, ...)``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp

__all__ = [
    "IOp",
    "PendingReadOp",
    "ReadOp",
    "ComputeOp",
    "WriteOp",
    "FusedRead",
    "FusedCompute",
    "op",
    "static_field",
    "fuse",
]


def static_field(**kwargs):
    """Mark a dataclass field as static (goes into the pytree treedef)."""
    metadata = dict(kwargs.pop("metadata", ()) or {})
    metadata["static"] = True
    return dataclasses.field(metadata=metadata, **kwargs)


def op(cls):
    """Class decorator: frozen dataclass + pytree registration.

    Fields marked with :func:`static_field` become treedef aux data (must be
    hashable); all other fields are pytree children (runtime data).
    """
    cls = dataclasses.dataclass(frozen=True)(cls)
    data_fields = [f.name for f in dataclasses.fields(cls) if not f.metadata.get("static")]
    meta_fields = [f.name for f in dataclasses.fields(cls) if f.metadata.get("static")]
    jax.tree_util.register_dataclass(cls, data_fields=data_fields, meta_fields=meta_fields)
    return cls


class IOp:
    """Base of all instantiable operations. Executes nothing on its own."""

    def then(self, other: "IOp") -> "IOp":
        """Sequential composition, reference ``iop.then(next)`` semantics."""
        raise NotImplementedError

    # Subclasses override for pretty pipeline dumps.
    def describe(self) -> str:
        return type(self).__name__


class ComputeOp(IOp):
    """Pointwise stage: maps a channel-last array to a channel-last array.

    Covers the reference's Unary and Binary IOps (F4/F5) — both are a traced
    elementwise function fused into the surrounding kernel by XLA.
    """

    def apply(self, x: jnp.ndarray) -> jnp.ndarray:
        raise NotImplementedError

    def then(self, other: IOp) -> IOp:
        if isinstance(other, ComputeOp):
            return FusedCompute(ops=_chain_of(self) + _chain_of(other))
        raise TypeError(f"cannot compose ComputeOp with {type(other).__name__}")


class ReadOp(IOp):
    """Source stage: materializes the pipeline's input value grid.

    The analog of the reference's Read/ReadBack IOps (``PerThreadRead``,
    ``Resize``, ``Crop``, ``ReadYUV``, ``BatchRead`` — F6/F7/F11). ``lower()``
    returns the full logical value array, channel-last:
    ``(H, W, C)`` for single-plane reads, ``(N, H, W, C)`` for batched reads.
    The executor calls it directly.
    """

    # True when lower() yields a leading batch axis. Deliberately NOT an
    # annotated field: dataclass subclasses must not inherit it as a leaf.
    batched = False

    def lower(self) -> jnp.ndarray:
        raise NotImplementedError

    def lower_planes(self, planes: Tuple[int, ...]) -> jnp.ndarray:
        """Materialize only the given plane indices of a batched read.

        Used by the divergent-batch launcher so each sequence computes
        exactly the planes its selector routes to it (the reference's
        per-plane template dispatch, F9). The default slices the full
        read; cheap per-read specializations override this.
        """
        if not self.batched:
            raise ValueError("lower_planes needs a batched read")
        x = self.lower()
        return x[jnp.asarray(planes, jnp.int32)]

    def then(self, other: IOp) -> IOp:
        if isinstance(other, ComputeOp):
            return FusedRead(read=self, chain=_chain_of(other))
        if isinstance(other, PendingReadOp):
            return other.bind(self)
        raise TypeError(f"cannot compose ReadOp with {type(other).__name__}")


class PendingReadOp(IOp):
    """A geometry op waiting for its source ("back op").

    Mirrors the reference factories that take no input — ``cvGS::resize<INTER_F>
    (dsize)`` / ``cvGS::crop(rect)`` (``include/cvGPUSpeedup.cuh:204-207,
    247-249``) — which attach to the preceding read when the pipeline is
    assembled: here ``read.then(pending)`` / ``fuse(read, pending)`` binds it.
    """

    def __init__(self, bind):
        self._bind = bind

    def bind(self, source: "ReadOp") -> "ReadOp":
        return self._bind(source)

    def then(self, other: IOp) -> IOp:
        raise TypeError("a geometry op must be bound to a read first (read.then(op))")


class WriteOp(IOp):
    """Terminal stage: maps the computed channel-last array to output layout(s).

    Covers ``PerThreadWrite/TensorWrite/TensorSplit/TensorTSplit/SplitWrite``
    (reference F6). Purely a layout transform — XLA materializes the
    requested output layout directly from the fused kernel's epilogue.
    """

    def write(self, x: jnp.ndarray):
        raise NotImplementedError

    def then(self, other: IOp) -> IOp:
        raise TypeError("write ops are terminal")


@op
class FusedCompute(ComputeOp):
    """A fused chain of pointwise stages (reference ``fk::FusedOperation``).

    Parameters of stage N are reachable as ``.ops[N]`` — the analog of
    ``fk::get<N>(params)`` (reference
    ``benchmarks/benchmark_image_resolution_MAD_loop.cu:50-51``).
    """

    ops: Tuple[ComputeOp, ...]

    def apply(self, x: jnp.ndarray) -> jnp.ndarray:
        for o in self.ops:
            x = o.apply(x)
        return x

    def describe(self) -> str:
        return "Fused(" + " -> ".join(o.describe() for o in self.ops) + ")"


@op
class FusedRead(ReadOp):
    """A read op with a fused pointwise tail (reference ``fk::fuse(read, ops...)``,
    used e.g. to feed resize from a virtual NV12->RGB image,
    ``tests/resize/test_fused_resize.cu:73-77``)."""

    read: ReadOp
    chain: Tuple[ComputeOp, ...]

    @property
    def batched(self) -> bool:  # type: ignore[override]
        return self.read.batched

    def lower(self) -> jnp.ndarray:
        x = self.read.lower()
        for o in self.chain:
            x = o.apply(x)
        return x

    def then(self, other: IOp) -> IOp:
        if isinstance(other, ComputeOp):
            return FusedRead(read=self.read, chain=self.chain + _chain_of(other))
        if isinstance(other, PendingReadOp):
            return other.bind(self)
        raise TypeError(f"cannot compose ReadOp with {type(other).__name__}")

    def describe(self) -> str:
        return (
            "FusedRead("
            + " -> ".join([self.read.describe()] + [o.describe() for o in self.chain])
            + ")"
        )


def _chain_of(o: ComputeOp) -> Tuple[ComputeOp, ...]:
    if isinstance(o, FusedCompute):
        return o.ops
    return (o,)


def fuse(*iops: IOp) -> IOp:
    """Variadic sequential fusion — reference ``fk::fuse(iop, ...)``."""
    if not iops:
        raise ValueError("fuse() needs at least one op")
    out = iops[0]
    for nxt in iops[1:]:
        out = out.then(nxt)
    return out
