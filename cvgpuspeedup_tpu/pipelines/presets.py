"""Preset end-to-end pipelines — the framework's "model families".

The reference is consumed by DL inference / SLAM front-ends (``README.md:
90-155``); these presets package its three canonical deployment pipelines
with one-call APIs:

- :func:`detection_preprocessor` — the flagship: N detection crops of one
  frame -> fused resize+normalize+planar split (SURVEY.md §3.2).
- :func:`temporal_window` — CircularTensor-based sliding window feeding
  temporal models (SURVEY.md §3.3, ``README.md:149-155``).
- :func:`camera_pipeline` — NV12 camera frames -> RGB(A) (+ optional
  resize), the "ComputeWhatYouSee" path (``tests/resize/test_fused_resize.cu``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np

from .. import (
    AspectRatio,
    CircularTensorOrder,
    ColorPlanes,
    ColorRange,
    ColorStandard,
    ParBackend,
    PixelFormat,
    Size,
    CircularTensor,
    convert_to,
    convert_yuv_to_rgb,
    divide,
    execute_operations,
    fuse,
    image,
    read_yuv,
    resize,
    resize_batch,
    split_tensor,
    subtract,
)


class detection_preprocessor:
    """Fused N-crop detection preprocessing: one kernel per frame batch.

    >>> prep = detection_preprocessor(dsize=Size(64, 128), mean=(127.5,)*3,
    ...                               scale=(128.0,)*3, alpha=1.0)
    >>> planar = prep(frame, rects, n_valid)   # (N, C, 128, 64) float32
    """

    def __init__(
        self,
        dsize: Size,
        mean: Union[float, Sequence[float]] = 0.0,
        scale: Union[float, Sequence[float]] = 1.0,
        alpha: float = 1.0,
        background: Union[float, Sequence[float]] = 0.0,
        aspect_ratio: AspectRatio = AspectRatio.IGNORE_AR,
        backend: ParBackend = ParBackend.AUTO,
    ):
        self.dsize = dsize
        self.mean = mean
        self.scale = scale
        self.alpha = alpha
        self.background = background
        self.aspect_ratio = aspect_ratio
        self.backend = backend

    def __call__(self, frame, rects, used_planes=None):
        return execute_operations(
            resize_batch(
                frame, rects=rects, dsize=self.dsize,
                used_planes=used_planes, background=self.background,
                aspect_ratio=self.aspect_ratio,
            ),
            convert_to(np.float32, alpha=self.alpha),
            subtract(self.mean),
            divide(self.scale),
            split_tensor(),
            backend=self.backend,
        )


class temporal_window:
    """Sliding temporal window: push frames, read the (BATCH, C, H, W) ring.

    Each ``push`` runs resize+normalize on the new frame and shifts the ring
    in ONE fused device program (CircularTensor semantics, reference F10).
    """

    def __init__(
        self,
        window: int,
        dsize: Size,
        channels: int = 3,
        alpha: float = 1.0 / 255.0,
        order: CircularTensorOrder = CircularTensorOrder.NEWEST_FIRST,
        planes: ColorPlanes = ColorPlanes.STANDARD,
    ):
        self.dsize = dsize
        self.alpha = alpha
        self.ring = CircularTensor(
            width=dsize.width, height=dsize.height, channels=channels,
            batch=window, order=order, planes=planes, dtype=np.float32,
        )

    def push(self, frame):
        self.ring.update(
            resize(image(np.asarray(frame)), self.dsize),
            convert_to(np.float32, alpha=self.alpha),
        )
        return self.ring.tensor

    @property
    def tensor(self):
        return self.ring.tensor


class video_stream:
    """End-to-end raw video streaming: native prefetch-ring frame loader ->
    packed ingestion -> one fused program per frame.

    The loader yields zero-copy numpy views of raw row-major frames — which
    IS the packed (H, W*C) ingest layout, so no byte is reshaped on the
    host. ``fmt="nv12"`` streams NV12 buffers
    through the fused YUV read instead.

    >>> for planar in video_stream("cam.raw", 1920, 1080, dsize=Size(640, 360),
    ...                            mean=(0.485, 0.456, 0.406),
    ...                            scale=(0.229, 0.224, 0.225)):
    ...     model(planar)                       # (C, 360, 640) float32
    """

    def __init__(
        self,
        path: str,
        width: int,
        height: int,
        dsize: Optional[Size] = None,
        mean: Union[float, Sequence[float]] = 0.0,
        scale: Union[float, Sequence[float]] = 1.0,
        alpha: float = 1.0 / 255.0,
        channels: int = 3,
        fmt: str = "rgb",
        standard: ColorStandard = ColorStandard.BT601,
        color_range: ColorRange = ColorRange.FULL,
        ring_depth: int = 4,
        backend: ParBackend = ParBackend.AUTO,
    ):
        from ..utils.frameloader import (FrameLoader, frame_shape_nv12,
                                         frame_shape_packed)

        self.fmt = fmt
        self.width, self.height, self.channels = width, height, channels
        self.dsize = dsize or Size(width, height)
        self.mean, self.scale, self.alpha = mean, scale, alpha
        self.standard, self.color_range = standard, color_range
        self.backend = backend
        shape = (frame_shape_nv12(width, height) if fmt == "nv12"
                 else frame_shape_packed(width, height, channels))
        self.loader = FrameLoader(path, shape, np.uint8, ring_depth=ring_depth)

    def _head(self, frame):
        if self.fmt == "nv12":
            return resize(
                fuse(
                    read_yuv(frame),
                    convert_yuv_to_rgb(color_range=self.color_range,
                                       standard=self.standard,
                                       out_dtype=np.float32),
                ),
                self.dsize,
            )
        # packed rows pass straight through (channels= declares the layout)
        return resize(image(frame, channels=self.channels), self.dsize)

    def __iter__(self):
        for frame in self.loader:
            yield execute_operations(
                self._head(frame),
                convert_to(np.float32, alpha=self.alpha),
                subtract(self.mean),
                divide(self.scale),
                split_tensor(),
                backend=self.backend,
            )


class camera_pipeline:
    """NV12 camera frame -> RGB(A), optionally fused with a resize
    ("ComputeWhatYouSee": conversion happens inside the fused read)."""

    def __init__(
        self,
        standard: ColorStandard = ColorStandard.BT601,
        color_range: ColorRange = ColorRange.FULL,
        alpha: bool = False,
        out_size: Optional[Size] = None,
        pixel_format: PixelFormat = PixelFormat.NV12,
    ):
        self.standard = standard
        self.color_range = color_range
        self.alpha = alpha
        self.out_size = out_size
        self.pixel_format = pixel_format

    def __call__(self, nv12_buffer):
        if self.out_size is None:
            # conversion (incl. alpha) entirely inside one fused program
            return execute_operations(
                read_yuv(nv12_buffer, pixel_format=self.pixel_format),
                convert_yuv_to_rgb(
                    color_range=self.color_range, standard=self.standard,
                    alpha=self.alpha, out_dtype=np.uint8,
                ),
            )
        from .. import ColorConversionCode, cvt_color

        virtual = fuse(
            read_yuv(nv12_buffer, pixel_format=self.pixel_format),
            convert_yuv_to_rgb(
                color_range=self.color_range, standard=self.standard,
                alpha=False, out_dtype=np.float32,
            ),
        )
        ops = [resize(virtual, self.out_size), convert_to(np.uint8)]
        if self.alpha:
            # alpha appended inside the same fused program (RGB -> RGBA)
            ops.append(cvt_color(ColorConversionCode.COLOR_RGB2RGBA))
        return execute_operations(*ops)
