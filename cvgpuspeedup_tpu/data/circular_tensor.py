"""CircularTensor — temporal sliding-window state with fused update.

Equivalent of ``fk::CircularTensor<T, COLOR_PLANES, BATCH, CircularTensorOrder,
ColorPlanes>`` (reference F10; wrapper ``include/cvGPUSpeedup.cuh:600-627``;
semantics pinned exactly by
``tests/batchread/test_circularbatchread_x_write3D.cu:176-460``):

- ``update(...)`` runs the per-new-frame preprocessing chain and inserts the
  result into the window as ONE fused device program. The reference does the
  insert by SHIFTING the other BATCH-1 planes in a single divergent-batch
  kernel ("some threads normalize the new image, others copy old planes",
  ``README.md:149-155``) — a copy of the whole ring every frame. Here the
  ring is stored in ROLLING SLOT ORDER with a host-tracked offset, so
  ``update`` writes exactly ONE plane slot (a donated
  ``dynamic_update_slice`` — in place in device memory) and nothing is ever
  copied. Readers apply the modular index instead: ``read_batch()``
  yields a :class:`~cvgpuspeedup_tpu.ops.memory.CircularBatchRead` whose
  runtime ``first`` scalar presents the logically-ordered window to any fused
  pipeline with zero data movement, and ``.tensor`` materializes the rotated
  view only when asked for.
- Ordering semantics (verified in the reference tests): after k updates,
  NEWEST_FIRST plane z holds frame k-z; OLDEST_FIRST plane z holds frame
  k-(BATCH-z-1).
- Layout variants: STANDARD planar (N, C, H, W) (``TensorSplit``),
  TRANSPOSED channel-major (C, N, H, W) (``TensorTSplit``), PACKED
  (N, H, W, C) (``TensorWrite``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..graph import ComputeOp, FusedCompute, IOp, ReadOp, WriteOp
from ..ops.memory import (CircularBatchRead, ImageRead, TensorSplit,
                          TensorTSplit, TensorWrite)
from ..types import CircularTensorOrder, ColorPlanes

_LAYOUT_FOR_WRITE = {
    TensorSplit: ColorPlanes.STANDARD,
    TensorTSplit: ColorPlanes.TRANSPOSED,
    TensorWrite: ColorPlanes.PACKED,
}


class CircularTensor:
    """A BATCH-deep ring of processed frames on device.

    Physical storage is in slot order (frame j lives in slot ``(j-1) % B``);
    the logical NEWEST_FIRST/OLDEST_FIRST ordering is applied by readers.
    """

    def __init__(
        self,
        width: int,
        height: int,
        channels: int,
        batch: int,
        order: CircularTensorOrder = CircularTensorOrder.NEWEST_FIRST,
        planes: ColorPlanes = ColorPlanes.STANDARD,
        dtype=np.float32,
        device=None,
    ):
        self.width = width
        self.height = height
        self.channels = channels
        self.batch = batch
        self.order = order
        self.planes = planes
        self.dtype = jnp.dtype(dtype)
        if planes == ColorPlanes.STANDARD:
            shape = (batch, channels, height, width)
        elif planes == ColorPlanes.TRANSPOSED:
            shape = (channels, batch, height, width)
        else:
            shape = (batch, height, width, channels)
        arr = jnp.zeros(shape, dtype=self.dtype)
        if device is not None:
            arr = jax.device_put(arr, device)
        self._ring = arr
        self._count = 0  # total frames ever inserted
        self._update_cache = {}
        self._view_fn = None

    # --- logical <-> physical mapping -------------------------------------

    def _plane_axis(self) -> int:
        return 1 if self.planes == ColorPlanes.TRANSPOSED else 0

    def _slot_perm(self, count: int) -> np.ndarray:
        """Physical slot of each LOGICAL plane z, given ``count`` updates.

        Frame j (1-based) lives in slot (j-1) % B. NEWEST_FIRST logical z
        holds frame count-z; OLDEST_FIRST holds frame count-(B-1-z)."""
        z = np.arange(self.batch, dtype=np.int64)
        if self.order == CircularTensorOrder.NEWEST_FIRST:
            return ((self._count if count is None else count) - 1 - z) % self.batch
        return ((self._count if count is None else count) + z) % self.batch

    # reference .ptr()/.tensor access. Materializes the logically-ordered
    # window (one device gather program, cached) — the ring itself is stored
    # in slot order and never copied by update(). The returned array is a
    # fresh buffer, valid across future update()s (unlike the reference's
    # live .ptr()).
    @property
    def tensor(self) -> jnp.ndarray:
        if self._view_fn is None:
            axis = self._plane_axis()

            def view(ring, perm):
                return jnp.take(ring, perm, axis=axis)

            self._view_fn = jax.jit(view)
        perm = jnp.asarray(self._slot_perm(self._count), jnp.int32)
        return self._view_fn(self._ring, perm)

    def snapshot(self) -> jnp.ndarray:
        """A logically-ordered copy of the window (same as ``.tensor``; kept
        for API compatibility with the donation-hazard era)."""
        return self.tensor

    def read_batch(self) -> CircularBatchRead:
        """The zero-copy read head: a :class:`CircularBatchRead` over the raw
        ring whose runtime ``first`` scalar applies the logical order, for use
        at the head of any fused pipeline (``execute_operations(ct.read_batch(),
        ...)``). This replaces the reference's shift-kernel: the ring never
        moves, readers index it modularly. STANDARD/PACKED layouts
        only (the plane axis must lead)."""
        if self.planes == ColorPlanes.TRANSPOSED:
            raise ValueError(
                "read_batch() needs the plane axis leading; TRANSPOSED rings "
                "store (C, N, H, W) — read .tensor instead"
            )
        if self.order == CircularTensorOrder.NEWEST_FIRST:
            # logical z = slot (count-1-z) % B: descendent from count-1
            return CircularBatchRead(
                data=self._ring,
                first=jnp.asarray((self._count - 1) % self.batch, jnp.int32),
                ascendent=False,
            )
        return CircularBatchRead(
            data=self._ring,
            first=jnp.asarray(self._count % self.batch, jnp.int32),
            ascendent=True,
        )

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self._ring.shape)

    def size_in_bytes(self) -> int:
        return self._ring.size * self._ring.dtype.itemsize

    def update(self, *iops: IOp, input: Optional[jnp.ndarray] = None) -> None:
        """Insert one new frame: run the compute chain on it and write it into
        its ring slot, fused into one device program.

        ``iops`` = optional leading read op (or pass ``input=`` array, the
        ``cvGS::CircularTensor::update(stream, GpuMat, ...)`` form), pointwise
        compute ops, and an optional terminal write op which — if present —
        must match this tensor's plane layout (the reference's
        self-referencing ``TensorSplit(self)`` argument).

        Unlike the reference's single shift kernel (which still copies
        BATCH-1 planes, ``README.md:149-155``), this writes ONE plane slot:
        the ring buffer is donated and the slot updated in place, so the
        update cost is the new-frame chain alone regardless of BATCH.
        """
        ops_list = list(iops)
        if input is not None:
            arr = jnp.asarray(input)
            ops_list.insert(0, ImageRead(data=arr, is_batch=False))
        if not ops_list or not isinstance(ops_list[0], ReadOp):
            raise ValueError("update needs a read op or input= array")
        read = ops_list[0]
        rest = ops_list[1:]
        if rest and isinstance(rest[-1], WriteOp):
            wlayout = _LAYOUT_FOR_WRITE.get(type(rest[-1]))
            if wlayout is not None and wlayout != self.planes:
                raise ValueError(
                    f"write op {type(rest[-1]).__name__} does not match "
                    f"CircularTensor layout {self.planes.name}"
                )
            rest = rest[:-1]
        compute: list = []
        for o in rest:
            if isinstance(o, FusedCompute):
                compute.extend(o.ops)
            elif isinstance(o, ComputeOp):
                compute.append(o)
            else:
                raise TypeError(f"unexpected op {type(o).__name__} in update chain")

        bundle = (read, tuple(compute))
        leaves, treedef = jax.tree_util.tree_flatten(bundle)
        key = treedef
        fn = self._update_cache.get(key)
        if fn is None:
            planes_mode = self.planes
            axis = self._plane_axis()
            dtype = self.dtype

            def run(ring, slot, ls):
                rd, chain = jax.tree_util.tree_unflatten(treedef, ls)
                x = rd.lower()
                for o in chain:
                    x = o.apply(x)
                x = x.astype(dtype)
                if planes_mode == ColorPlanes.PACKED:
                    plane = x
                else:
                    plane = jnp.transpose(x, (2, 0, 1))  # (C, H, W)
                if planes_mode == ColorPlanes.TRANSPOSED:
                    new = plane[:, None]  # (C, 1, H, W)
                else:
                    new = plane[None]  # (1, ...) leading plane axis
                # donated in-place single-slot write; slot is a runtime
                # scalar so every update reuses ONE compiled program
                return jax.lax.dynamic_update_slice_in_dim(ring, new, slot, axis)

            fn = jax.jit(run, donate_argnums=(0,))
            self._update_cache[key] = fn
        slot = jnp.asarray(self._count % self.batch, jnp.int32)
        self._ring = fn(self._ring, slot, leaves)
        self._count += 1

    # --- persistence (the ring is the only persistent state the engine owns,
    # SURVEY.md §5.4) ---

    def state_dict(self) -> dict:
        # the LOGICAL window is saved (rotation applied), so files are
        # self-describing and independent of the in-memory slot phase
        return {
            "tensor": np.asarray(self.tensor),
            "order": self.order.value,
            "planes": self.planes.value,
            "width": self.width,
            "height": self.height,
            "channels": self.channels,
            "batch": self.batch,
        }

    def save(self, path: str) -> None:
        np.savez(path, **self.state_dict())

    @classmethod
    def load(cls, path: str, device=None) -> "CircularTensor":
        d = np.load(path if str(path).endswith(".npz") else str(path) + ".npz")
        ct = cls(
            width=int(d["width"]), height=int(d["height"]),
            channels=int(d["channels"]), batch=int(d["batch"]),
            order=CircularTensorOrder(str(d["order"])),
            planes=ColorPlanes(str(d["planes"])),
            dtype=d["tensor"].dtype, device=device,
        )
        # re-phase the logical window into slot order at count = batch
        # (count is only meaningful modulo batch once the ring is full)
        ct._count = ct.batch
        perm = ct._slot_perm(ct.batch)  # slot of each logical plane
        logical = d["tensor"]
        phys = np.empty_like(logical)
        axis = ct._plane_axis()
        idx = [slice(None)] * logical.ndim
        for z in range(ct.batch):
            dst = list(idx)
            src = list(idx)
            dst[axis] = int(perm[z])
            src[axis] = z
            phys[tuple(dst)] = logical[tuple(src)]
        payload = jnp.asarray(phys)
        if device is not None:
            payload = jax.device_put(payload, device)
        ct._ring = payload
        return ct
