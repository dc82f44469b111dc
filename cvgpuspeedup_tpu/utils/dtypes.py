"""Dtype & channel metadata + OpenCV-semantics saturating casts.

Replacement for the reference's CUDA vector-type layer:

- ``cv2cuda_t`` / ``CUDA_T`` macros (reference ``include/cv2cuda_types.cuh:25-96``):
  an OpenCV ``CV_8UC3``-style code maps to a CUDA vector type ``uchar3``. Here a
  "vector type" is simply ``(dtype, channels)`` and images are channel-last
  ``(..., C)`` jnp arrays (XLA owns physical layout; there is no pitch).
- CUDA vector utils ``VectorTraits/VBase/cn/make_set`` (usage at reference
  ``include/cvGPUSpeedup.cuh:84-113``, ``tests/testUtils.cuh:52-79``): replaced by
  :func:`channels`, :func:`base_dtype`, :func:`as_channel_vector`.
- ``vlimits.h`` ``fk::minValue/maxValue`` (usage at reference
  ``tests/testsCommon.cuh:202-206``): :func:`min_value` / :func:`max_value`.
- ``fk::SaturateCast`` semantics (validated against ``cv::convertTo`` in reference
  ``tests/single_operation/test_convertTo.cu:60-96``): :func:`saturate_cast`
  rounds float->int with round-half-to-even (OpenCV ``cvRound``) then clamps to
  the destination range.
"""

from __future__ import annotations

from typing import Any, Sequence, Tuple, Union

import jax.numpy as jnp
import numpy as np

DTypeLike = Any

#: Depths supported by the reference wrapper (CV_8U..CV_64F,
#: reference include/cv2cuda_types.cuh:28-63).
SUPPORTED_DEPTHS: Tuple[np.dtype, ...] = tuple(
    np.dtype(d) for d in ("uint8", "int8", "uint16", "int16", "int32", "float32", "float64")
)

#: Channel counts supported (C1..C4).
SUPPORTED_CHANNELS = (1, 2, 3, 4)


def is_float(dtype: DTypeLike) -> bool:
    return jnp.issubdtype(jnp.dtype(dtype), jnp.floating)


def is_integer(dtype: DTypeLike) -> bool:
    return jnp.issubdtype(jnp.dtype(dtype), jnp.integer)


def min_value(dtype: DTypeLike):
    """``fk::minValue<T>`` equivalent."""
    dtype = jnp.dtype(dtype)
    if is_integer(dtype):
        return jnp.iinfo(dtype).min
    return float(jnp.finfo(dtype).min)


def max_value(dtype: DTypeLike):
    """``fk::maxValue<T>`` equivalent."""
    dtype = jnp.dtype(dtype)
    if is_integer(dtype):
        return jnp.iinfo(dtype).max
    return float(jnp.finfo(dtype).max)


def channels(x) -> int:
    """Channel count of a channel-last image array (``fk::cn<T>``)."""
    if x.ndim == 0:
        return 1
    return int(x.shape[-1])


def saturate_cast(x: jnp.ndarray, dtype: DTypeLike) -> jnp.ndarray:
    """OpenCV ``saturate_cast`` semantics, elementwise.

    float -> integer: round half-to-even (``cvRound``) then clamp to range.
    integer -> integer: clamp to destination range.
    anything -> float: plain convert (no clamping), matching OpenCV.

    Reference behavior pinned by ``tests/single_operation/test_convertTo.cu:60-96``
    (bit-exact vs ``cv::cuda::GpuMat::convertTo``).
    """
    dtype = jnp.dtype(dtype)
    if x.dtype == dtype:
        return x
    if is_integer(dtype):
        if is_float(x.dtype):
            x = jnp.rint(x)
        else:
            # Widen before clamping: the destination bounds may not be
            # representable in the source dtype (e.g. int8 -> uint8).
            x = x.astype(jnp.int32)
        info = jnp.iinfo(dtype)
        x = jnp.clip(x, info.min, info.max)
        return x.astype(dtype)
    return x.astype(dtype)


def cast(x: jnp.ndarray, dtype: DTypeLike) -> jnp.ndarray:
    """``fk::Cast`` — plain C-style convert (truncation for float->int)."""
    return x.astype(jnp.dtype(dtype))


ScalarLike = Union[int, float, Sequence[float], np.ndarray, jnp.ndarray]


def as_channel_vector(value: ScalarLike, num_channels: int, dtype: DTypeLike = jnp.float32):
    """cv::Scalar -> per-channel constant vector of shape ``(num_channels,)``.

    Equivalent of ``cvScalar2CUDAV`` (reference
    ``include/cvGPUSpeedupHelpers.cuh:38-69``). A python scalar broadcasts to all
    channels (``make_set``); a sequence must have ``num_channels`` entries.
    """
    # numpy (not jnp) on purpose: factory-built constants are pytree leaves
    # converted once at jit dispatch; per-call jnp dispatch of tiny arrays
    # costs ~50us each on the host (the reference's "graph build ~ free"
    # contract applies to us too)
    if isinstance(value, jnp.ndarray):
        arr = value.astype(jnp.dtype(dtype))
        if arr.ndim == 0:
            return jnp.broadcast_to(arr, (num_channels,))
        arr = arr.reshape(-1)
        if arr.shape[0] == 1:
            return jnp.broadcast_to(arr[0], (num_channels,))
        if arr.shape[0] != num_channels:
            raise ValueError(
                f"scalar has {arr.shape[0]} components, image has {num_channels} channels"
            )
        return arr
    arr = np.asarray(value, dtype=np.dtype(dtype))
    if arr.ndim == 0:
        return np.full((num_channels,), arr, dtype=arr.dtype)
    arr = arr.reshape(-1)
    if arr.shape[0] == 1:
        return np.full((num_channels,), arr[0], dtype=arr.dtype)
    if arr.shape[0] != num_channels:
        raise ValueError(
            f"scalar has {arr.shape[0]} components, image has {num_channels} channels"
        )
    return arr
