"""Geometry primitives and public enums.

Equivalents of ``fk::Point/Size/Rect`` (reference usage
``include/cvGPUSpeedup.cuh:247-265``, ``tests/testUtils.cuh:103-147``) and the
enum surface of the reference wrapper:

- ``AspectRatio`` (reference ``include/cvGPUSpeedup.cuh:32``):
  ``PRESERVE_AR, IGNORE_AR, PRESERVE_AR_RN_EVEN, PRESERVE_AR_LEFT``.
- ``InterpolationType`` — only ``INTER_LINEAR`` is supported
  (whitelist at reference ``include/cv2cuda_types.cuh:86``).
- ``CircularTensorOrder`` / ``ColorPlanes`` (reference F10 usage,
  ``tests/batchread/test_circularbatchread_x_write3D.cu:176-460``).
- YUV color range/standard selectors for NV12 conversion
  (``fk::ConvertYUVToRGB<NV12, {Full,Limited}, {bt601,bt709}, alpha>``,
  reference ``tests/resize/test_fused_resize.cu:50-51,121-122``).
"""

from __future__ import annotations

import enum
from typing import NamedTuple


class Size(NamedTuple):
    """Width x height, OpenCV argument order (``cv::Size(w, h)``)."""

    width: int
    height: int


class Point(NamedTuple):
    x: int = 0
    y: int = 0
    z: int = 0


class Rect(NamedTuple):
    """Crop rectangle. ``width``/``height`` must be static python ints when the
    rect determines an output shape (plain crop); ``x``/``y`` may be traced."""

    x: int
    y: int
    width: int
    height: int


class InterpolationType(enum.Enum):
    INTER_LINEAR = "linear"


class AspectRatio(enum.Enum):
    IGNORE_AR = "ignore"
    PRESERVE_AR = "preserve"
    PRESERVE_AR_RN_EVEN = "preserve_round_even"
    PRESERVE_AR_LEFT = "preserve_left"


class CircularTensorOrder(enum.Enum):
    NEWEST_FIRST = "newest_first"
    OLDEST_FIRST = "oldest_first"


class ColorPlanes(enum.Enum):
    STANDARD = "standard"      # (N, C, H, W) — TensorSplit layout
    TRANSPOSED = "transposed"  # (C, N, H, W) — TensorTSplit layout
    PACKED = "packed"          # (N, H, W, C) — TensorWrite layout


class ColorRange(enum.Enum):
    FULL = "full"
    LIMITED = "limited"


class ColorStandard(enum.Enum):
    BT601 = "bt601"
    BT709 = "bt709"


class PixelFormat(enum.Enum):
    NV12 = "nv12"
    NV21 = "nv21"


class ParBackend(enum.Enum):
    """Backend selector — the analog of ``fk::ParArch`` (reference F12).
    Every pipeline lowers through XLA; AUTO and XLA are the same choice."""

    AUTO = "auto"
    XLA = "xla"
