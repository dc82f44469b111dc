"""Memory read/write ops: sources, batch dispatch, and output layouts.

Equivalents of the reference's memory-operation layer (F6/F7/F8):

- ``fk::PerThreadRead<_2D/_3D, T>``  -> :class:`ImageRead` (a channel-last array
  is itself the value grid; "pitch" no longer exists — XLA owns layout).
- ``fk::BatchRead<N, CONDITIONAL_WITH_DEFAULT>``  -> :class:`BatchRead`
  (per-plane sub-reads + active-plane mask + per-channel default value;
  reference usage ``include/cvGPUSpeedup.cuh:240-243``).
- ``fk::CircularBatchRead<Direction, ReadOp, BATCH>`` -> :class:`CircularBatchRead`
  (modular plane remap; exact semantics pinned by
  ``tests/batchread/test_circularbatchread_x_write3D.cu:59-84``).
- Write layouts (``PerThreadWrite/TensorWrite/TensorSplit/TensorTSplit/
  SplitWrite``) -> :class:`Write2D`/:class:`TensorWrite`/:class:`TensorSplit`/
  :class:`TensorTSplit`/:class:`SplitWrite`. These are epilogue layout
  transforms of the fused program:

  ========================  =============================  =======================
  reference op              layout written                 here
  ========================  =============================  =======================
  PerThreadWrite<_2D,T>     packed HWC image               (H, W, C)
  TensorWrite<T>            packed, one image per plane    (N, H, W, C)
  TensorSplit<T>            planar per image               (N, C, H, W)
  TensorTSplit<T>           channel-major over the batch   (C, N, H, W)
  SplitWrite<_2D,T>         C separate 2D buffers          tuple of (H, W)
  ========================  =============================  =======================

  Plane strides verified in the reference at
  ``tests/batchread/test_circularbatchread_x_write3D.cu:264-337``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax.numpy as jnp

from ..graph import ReadOp, WriteOp, op, static_field


@op
class ImageRead(ReadOp):
    """Read a packed channel-last image (or stack of images).

    ``data`` has shape (H, W, C) or, with ``batched=True`` layouts upstream,
    (N, H, W, C). Grayscale 2D arrays are accepted and treated as C=1.
    """

    data: jnp.ndarray
    is_batch: bool = static_field(default=False)
    #: >0: ``data`` rows are channel-interleaved pixels — (H, W*C) (or
    #: (N, H, W*C) batched), as a raw row-major frame arrives; the lowering
    #: reshapes back to (H, W, C) here.
    packed_channels: int = static_field(default=0)

    @property
    def batched(self):  # type: ignore[override]
        return self.is_batch

    def lower(self) -> jnp.ndarray:
        x = self.data
        if self.packed_channels:
            c = self.packed_channels
            return x.reshape(x.shape[:-1] + (x.shape[-1] // c, c))
        min_rank = 4 if self.is_batch else 3
        if x.ndim == min_rank - 1:  # grayscale without channel axis
            x = x[..., None]
        return x

    def lower_planes(self, planes) -> jnp.ndarray:
        return self.lower()[jnp.asarray(planes, jnp.int32)]

    def describe(self) -> str:
        return f"ImageRead{tuple(self.data.shape)}"


@op
class BatchRead(ReadOp):
    """Horizontal (batch) fusion with optional ragged masking.

    Stacks N same-shaped sub-reads along a new leading plane axis. When
    ``used_planes`` is given, planes ``z >= used_planes`` yield ``default``
    instead of their read result — the reference's CONDITIONAL_WITH_DEFAULT
    mode (``include/cvGPUSpeedup.cuh:506-516``). ``used_planes`` is a runtime
    scalar: changing the active count never recompiles.
    """

    ops: Tuple[ReadOp, ...]
    used_planes: Optional[jnp.ndarray]
    default: Optional[jnp.ndarray]  # scalar or (C,)

    batched = True

    def lower(self) -> jnp.ndarray:
        x = jnp.stack([o.lower() for o in self.ops], axis=0)
        if self.used_planes is not None:
            n = x.shape[0]
            z = jnp.arange(n).reshape((n,) + (1,) * (x.ndim - 1))
            default = jnp.asarray(self.default, dtype=x.dtype)
            x = jnp.where(z < self.used_planes, x, default)
        return x

    def lower_planes(self, planes) -> jnp.ndarray:
        # static plane list -> stack only the selected sub-reads
        x = jnp.stack([self.ops[int(z)].lower() for z in planes], axis=0)
        if self.used_planes is not None:
            z = jnp.asarray(planes, jnp.int32).reshape((-1,) + (1,) * (x.ndim - 1))
            default = jnp.asarray(self.default, dtype=x.dtype)
            x = jnp.where(z < self.used_planes, x, default)
        return x

    def describe(self) -> str:
        return f"BatchRead[{len(self.ops)}]({self.ops[0].describe()}, ...)"


@op
class CircularBatchRead(ReadOp):
    """Temporal ring view over the plane axis.

    Output plane ``z`` reads input plane ``(first + z) % N`` (ascendent) or
    ``(first - z) % N`` (descendent). ``first`` is a runtime scalar.
    """

    data: jnp.ndarray  # (N, H, W, C), or (N, H, W*C) when packed
    first: jnp.ndarray  # scalar int
    ascendent: bool = static_field(default=True)
    #: >0: ring planes are channel-interleaved (N, H, W*C) rows — see
    #: ImageRead.packed_channels (packing on device is a relayout copy;
    #: the factory packs host arrays for free)
    packed_channels: int = static_field(default=0)

    batched = True

    def _unpack(self, x: jnp.ndarray) -> jnp.ndarray:
        if self.packed_channels:
            c = self.packed_channels
            return x.reshape(x.shape[:-1] + (x.shape[-1] // c, c))
        return x

    def lower(self) -> jnp.ndarray:
        n = self.data.shape[0]
        z = jnp.arange(n)
        src = (self.first + z) % n if self.ascendent else (self.first - z) % n
        return self._unpack(jnp.take(self.data, src, axis=0))

    def lower_planes(self, planes) -> jnp.ndarray:
        n = self.data.shape[0]
        z = jnp.asarray(planes, jnp.int32)
        src = (self.first + z) % n if self.ascendent else (self.first - z) % n
        return self._unpack(jnp.take(self.data, src, axis=0))

    def describe(self) -> str:
        d = "asc" if self.ascendent else "desc"
        return f"CircularBatchRead[{self.data.shape[0]},{d}]"


# --------------------------------------------------------------------------
# Write layouts
# --------------------------------------------------------------------------


@op
class Write2D(WriteOp):
    """Packed channel-last output — ``fk::PerThreadWrite`` (identity layout)."""

    def write(self, x: jnp.ndarray):
        return x


@op
class TensorWrite(WriteOp):
    """Packed 3D tensor, one image per plane — ``fk::TensorWrite``: (N,H,W,C)."""

    def write(self, x: jnp.ndarray):
        if x.ndim != 4:
            raise ValueError(f"TensorWrite expects a batched (N,H,W,C) value, got {x.shape}")
        return x


@op
class TensorSplit(WriteOp):
    """Planar split per image — ``fk::TensorSplit``: (N,C,H,W) (or (C,H,W))."""

    def write(self, x: jnp.ndarray):
        if x.ndim == 4:
            return jnp.transpose(x, (0, 3, 1, 2))
        if x.ndim == 3:
            return jnp.transpose(x, (2, 0, 1))
        raise ValueError(f"TensorSplit expects (N,H,W,C) or (H,W,C), got {x.shape}")


def pack_factor(height: int, width: int) -> int:
    """Row-packing factor for :class:`TensorSplitPacked`: how many consecutive
    output rows share one packed row of at least 128 elements. 1 when the
    width already reaches 128 (or the height does not divide)."""
    f = max(1, 128 // max(1, width))
    while f > 1 and height % f:
        f //= 2
    return f


@op
class TensorSplitPacked(WriteOp):
    """Planar split with ``f`` output rows per packed row: (N, C, H/f, f*W).

    Same VALUES in the same row-major order as :class:`TensorSplit` — row r
    of a packed plane holds output rows ``f*r .. f*r+f-1`` side by side, so
    ``out.reshape(N, C, H, W)`` is exactly the TensorSplit plane and
    ``out.reshape(N, C*H*W)`` is exactly the reference's flat per-image row
    (``fk::TensorSplit`` plane stride ``width*height``,
    ``tests/batchread/test_circularbatchread_x_write3D.cu:264-279``). For
    consumers that take flat plane buffers.
    """

    def write(self, x: jnp.ndarray):
        if x.ndim != 4:
            raise ValueError(
                f"TensorSplitPacked expects a batched (N,H,W,C) value, got {x.shape}"
            )
        n, h, w, c = x.shape
        f = pack_factor(h, w)
        return jnp.transpose(x, (0, 3, 1, 2)).reshape(n, c, h // f, f * w)


@op
class TensorTSplit(WriteOp):
    """Transposed planar split — ``fk::TensorTSplit``: (C,N,H,W)."""

    def write(self, x: jnp.ndarray):
        if x.ndim != 4:
            raise ValueError(f"TensorTSplit expects a batched (N,H,W,C) value, got {x.shape}")
        return jnp.transpose(x, (3, 0, 1, 2))


@op
class SplitWrite(WriteOp):
    """Split channels into separate buffers — ``fk::SplitWrite<_2D, T>``
    (reference ``include/cvGPUSpeedupHelpers.cuh:73-87``). Returns a tuple of
    C arrays of shape (H, W) (or (N, H, W) for batched pipelines)."""

    def write(self, x: jnp.ndarray):
        return tuple(x[..., c] for c in range(x.shape[-1]))
