"""Pointwise arithmetic ops + compile-time-repeat loop.

Equivalents of the reference FKL ``algorithms/basic_ops/arithmetic.cuh`` and
``static_loop.cuh`` (usage: ``include/cvGPUSpeedup.cuh:131-149``,
``benchmarks/verticalfusion/vertical_fusion_static_loop.cuh:21-49``).

Numeric contract (matching OpenCV per-op semantics, the reference's oracle):

- float arrays: plain IEEE f32/f64 elementwise math.
- integer arrays: computed in float32 then saturate-cast back (OpenCV's
  ``add/subtract/multiply/divide`` saturate and round-half-to-even on integer
  outputs rather than wrapping).

The scalar operand is the analog of ``cv::Scalar`` -> CUDA vector constant
(reference ``include/cvGPUSpeedupHelpers.cuh:38-69``): a python scalar
broadcasts over channels, a length-C vector applies per channel.
"""

from __future__ import annotations



import jax.numpy as jnp

from ..graph import ComputeOp, op, static_field
from ..utils import dtypes as dt


class _BinaryWithScalar(ComputeOp):
    """Shared machinery for Mul/Add/Sub/Div. ``value`` is a pytree leaf, so
    changing it never recompiles the pipeline (reference analog: kernel
    parameter, not template parameter)."""

    def _combine(self, x, v):
        raise NotImplementedError

    def apply(self, x: jnp.ndarray) -> jnp.ndarray:
        v = jnp.asarray(self.value)  # type: ignore[attr-defined]
        if v.ndim > 1:
            raise ValueError("binary op scalar must be rank 0 or 1 (per-channel)")
        if dt.is_integer(x.dtype):
            y = self._combine(x.astype(jnp.float32), v.astype(jnp.float32))
            return dt.saturate_cast(y, x.dtype)
        return self._combine(x, v.astype(x.dtype))


@op
class Mul(_BinaryWithScalar):
    value: jnp.ndarray

    def _combine(self, x, v):
        return x * v


@op
class Add(_BinaryWithScalar):
    value: jnp.ndarray

    def _combine(self, x, v):
        return x + v


@op
class Sub(_BinaryWithScalar):
    value: jnp.ndarray

    def _combine(self, x, v):
        return x - v


@op
class Div(_BinaryWithScalar):
    value: jnp.ndarray

    def _combine(self, x, v):
        return x / v


@op
class StaticLoop(ComputeOp):
    """Apply ``body`` N times, unrolled at trace time.

    Reference ``fk::StaticLoop<Op, N>`` (nestable, e.g.
    ``StaticLoop<StaticLoop<Op, k>, N/k>`` at
    ``benchmarks/verticalfusion/vertical_fusion_static_loop.cuh:33-46``). The
    unrolled chain is fused by XLA into one kernel — the vertical-fusion
    stress path.
    """

    body: ComputeOp
    n: int = static_field()

    def apply(self, x: jnp.ndarray) -> jnp.ndarray:
        for _ in range(self.n):
            x = self.body.apply(x)
        return x

    def describe(self) -> str:
        return f"StaticLoop({self.body.describe()} x {self.n})"
