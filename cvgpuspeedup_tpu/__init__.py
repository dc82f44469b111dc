"""cvgpuspeedup_tpu — a fused vision-preprocessing engine in JAX.

A JAX/XLA implementation of the capabilities of cvGPUSpeedup +
FusedKernelLibrary: a lazy operation graph that compiles every
preprocessing pipeline into ONE fused device program — read device memory
once, compute the whole chain in registers, write once — replacing the
kernel-per-op launch pattern of classic vision libraries.

This module is the public factory surface, mirroring the ``cvGS::`` API
(reference ``include/cvGPUSpeedup.cuh:30-628``) with JAX types: factories
build ops and execute nothing; :func:`execute_operations` fuses and runs.

Example (the reference's flagship 50-crop pipeline, SURVEY.md §3.2)::

    import cvgpuspeedup_tpu as cvgs

    out = cvgs.execute_operations(
        cvgs.resize_batch(frame, rects=rects, dsize=cvgs.Size(64, 128),
                          used_planes=n_detections, background=128.0),
        cvgs.cvt_color(cvgs.ColorConversionCode.COLOR_RGB2BGR),
        cvgs.multiply(0.3),
        cvgs.subtract((3.2, 0.6, 11.8)),
        cvgs.divide((128.0, 128.0, 128.0)),
        cvgs.split_tensor(),            # planar (N, C, H, W)
    )
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import jax
import jax.numpy as jnp
import numpy as np

from .graph import ComputeOp, FusedCompute, IOp, PendingReadOp, ReadOp, WriteOp, fuse
from .ops.arithmetic import Add, Div, Mul, StaticLoop, Sub
from .ops.cast import Cast, SaturateCast
from .ops.color import ColorConversion, ColorConversionCode, VectorReorder
from .ops.crop import CropRead
from .ops.memory import (
    BatchRead,
    CircularBatchRead,
    ImageRead,
    SplitWrite,
    TensorSplit,
    TensorSplitPacked,
    TensorTSplit,
    TensorWrite,
    Write2D,
)
from .ops.border import BorderMode, BorderRead
from .ops.nv12 import ConvertYUVToRGB, ReadYUV
from .ops.resize import BatchResizeRead, ResizeRead
from .ops.warp import WarpRead, WarpType, invert_affine, invert_perspective
from .exec.executor import (
    Pipeline,
    build_operation_sequence,
    build_pipeline,
    execute_operations,
    launch_divergent_batch,
)
from .types import (
    AspectRatio,
    CircularTensorOrder,
    ColorPlanes,
    ColorRange,
    ColorStandard,
    InterpolationType,
    ParBackend,
    PixelFormat,
    Point,
    Rect,
    Size,
)
from .utils import dtypes as _dt
from .utils.dtypes import saturate_cast as saturate_cast_fn
from .data.circular_tensor import CircularTensor

__version__ = "0.1.0"

ArrayLike = Union[np.ndarray, jnp.ndarray]
_SourceLike = Union[ArrayLike, ReadOp]


def _np_or_traced(value, dtype):
    """Tiny factory constants stay numpy (cheap host path, converted at jit
    dispatch); traced/jax values pass through."""
    if isinstance(value, (jnp.ndarray, jax.core.Tracer)):
        return value
    return np.asarray(value, dtype)


def _as_read(source: _SourceLike) -> ReadOp:
    if isinstance(source, ReadOp):
        return source
    arr = source if isinstance(source, (jnp.ndarray, jax.core.Tracer)) else np.asarray(source)
    return ImageRead(data=arr, is_batch=(arr.ndim == 4))


# ---------------------------------------------------------------------------
# pointwise factories (reference include/cvGPUSpeedup.cuh:74-161)
# ---------------------------------------------------------------------------


def convert_to(dst_dtype, alpha: Optional[float] = None, beta: Optional[float] = None) -> ComputeOp:
    """``cvGS::convertTo<I, O>([alpha[, beta]])`` (reference
    ``include/cvGPUSpeedup.cuh:74-129``): OpenCV ``convertTo`` semantics —
    ``saturate_cast<O>(src * alpha + beta)``, with the multiply/add computed in
    float when the output is integral."""
    dst = np.dtype(dst_dtype)
    if alpha is None and beta is None:
        return SaturateCast(dst=dst)
    if alpha is None:
        alpha = 1.0  # OpenCV convertTo default when only beta is given
    stages: list = []
    if _dt.is_float(dst):
        stages.append(SaturateCast(dst=dst))
        stages.append(Mul(value=_np_or_traced(alpha, dst)))
        if beta is not None:
            stages.append(Add(value=_np_or_traced(beta, dst)))
    else:
        stages.append(Cast(dst=np.dtype(np.float32)))
        stages.append(Mul(value=_np_or_traced(alpha, np.float32)))
        if beta is not None:
            stages.append(Add(value=_np_or_traced(beta, np.float32)))
        stages.append(SaturateCast(dst=dst))
    return FusedCompute(ops=tuple(stages))


def multiply(value) -> ComputeOp:
    return Mul(value=_np_or_traced(value, np.float32))


def add(value) -> ComputeOp:
    return Add(value=_np_or_traced(value, np.float32))


def subtract(value) -> ComputeOp:
    return Sub(value=_np_or_traced(value, np.float32))


def divide(value) -> ComputeOp:
    return Div(value=_np_or_traced(value, np.float32))


def cvt_color(code: ColorConversionCode) -> ComputeOp:
    return ColorConversion(code=code)


def vector_reorder(*indices: int) -> ComputeOp:
    return VectorReorder(indices=tuple(indices))


def static_loop(body: ComputeOp, n: int) -> ComputeOp:
    return StaticLoop(body=body, n=n)


def convert_yuv_to_rgb(
    color_range: ColorRange = ColorRange.FULL,
    standard: ColorStandard = ColorStandard.BT601,
    alpha: bool = False,
    out_dtype=np.uint8,
) -> ComputeOp:
    return ConvertYUVToRGB(
        color_range=color_range,
        standard=standard,
        alpha=alpha,
        out_dtype=np.dtype(out_dtype),
    )


# ---------------------------------------------------------------------------
# read factories (reference include/cvGPUSpeedup.cuh:204-265,285-447,600-627)
# ---------------------------------------------------------------------------


def image(source: ArrayLike, channels: Optional[int] = None) -> ReadOp:
    """Wrap a packed (H, W, C) / (N, H, W, C) array as a read op
    (``fk::PerThreadRead`` analog).

    HOST (numpy) arrays are ingested in packed-row form — a free row-major
    reshape to (H, W*C). Device arrays are wrapped as-is.

    ``channels=C`` declares an ALREADY-packed (H, W*C) (or (N, H, W*C))
    buffer — e.g. a raw row-major frame straight from `utils.frameloader`
    (``frame_shape_packed``) or a device buffer kept in ingest layout; no
    reshape happens anywhere."""
    if channels is not None:
        arr = source if isinstance(source, (jnp.ndarray, jax.core.Tracer)) \
            else np.asarray(source)
        if arr.ndim not in (2, 3):
            raise ValueError("image(channels=) expects packed (H, W*C) or "
                             "(N, H, W*C) rows")
        if arr.shape[-1] % channels:
            raise ValueError(
                f"packed row length {arr.shape[-1]} is not a multiple of "
                f"channels={channels}")
        return ImageRead(data=arr, is_batch=(arr.ndim == 3),
                         packed_channels=int(channels))
    if (isinstance(source, np.ndarray) and not isinstance(source, jnp.ndarray)
            and source.ndim in (3, 4) and source.shape[-1] > 1):
        c = int(source.shape[-1])
        arr = np.ascontiguousarray(source)
        packed = arr.reshape(arr.shape[:-2] + (arr.shape[-2] * c,))
        return ImageRead(data=packed, is_batch=(source.ndim == 4),
                         packed_channels=c)
    return _as_read(source)


def read_yuv(buffer: ArrayLike, pixel_format: PixelFormat = PixelFormat.NV12) -> ReadOp:
    return ReadYUV(buffer=buffer if isinstance(buffer, (jnp.ndarray, jax.core.Tracer)) else np.asarray(buffer), pixel_format=pixel_format)


def crop(source=None, rect: Optional[Rect] = None):
    """``cvGS::crop(backIOp, rect)`` / ``cvGS::crop(rect)``: a zero-copy
    re-indexing read stage. Called with only a rect (``crop(rect)``), it
    returns a geometry op that binds to the preceding read via ``.then`` or
    positionally inside ``execute_operations`` (reference
    ``include/cvGPUSpeedup.cuh:247-249``)."""
    if rect is None and isinstance(source, Rect):
        source, rect = None, source
    if rect is None:
        raise ValueError("crop needs a rect")

    def build(src: ReadOp) -> ReadOp:
        return CropRead(
            source=src,
            x=_np_or_traced(rect.x, np.int32),
            y=_np_or_traced(rect.y, np.int32),
            width=int(rect.width),
            height=int(rect.height),
        )

    if source is None:
        return PendingReadOp(build)
    return build(_as_read(source))


def crop_batch(source: _SourceLike, rects: Sequence[Rect]) -> ReadOp:
    """``cvGS::crop<BATCH>(rects)``: N same-size crops as one batched read."""
    sizes = {(r.width, r.height) for r in rects}
    if len(sizes) != 1:
        raise ValueError("crop_batch requires equal crop sizes (shape is static); "
                         "use resize_batch for variable geometry")
    src = _as_read(source)
    return BatchRead(
        ops=tuple(crop(src, r) for r in rects),
        used_planes=None,
        default=None,
    )


def resize(
    source=None,
    dsize: Optional[Size] = None,
    fx: float = 0.0,
    fy: float = 0.0,
    interpolation: InterpolationType = InterpolationType.INTER_LINEAR,
):
    """``cvGS::resize<T, INTER_LINEAR>(src, dsize, fx, fy)``. Output is float32
    (the resize stage always emits float; append :func:`convert_to` to cast).

    Called with only a size (``resize(Size(w, h))`` or ``resize(dsize=...)``),
    it returns a geometry op that binds to the preceding (possibly fused)
    read — the ``cvGS::resize<INTER_F>(dsize)`` overload used after a fused
    NV12 read (reference ``include/cvGPUSpeedup.cuh:204-207``)."""
    if dsize is None and isinstance(source, Size):
        source, dsize = None, source
    if source is None:
        if dsize is None:
            raise ValueError("resize needs a dsize")
        return PendingReadOp(
            lambda src: ResizeRead(source=src, dsize=dsize, interp=interpolation)
        )
    src = _as_read(source)
    if dsize is None or dsize == Size(0, 0):
        # eval_shape: shape only, no device materialization (factories must
        # stay host-cheap — lower() here would run the whole read on device)
        shape = (jax.eval_shape(src.lower).shape
                 if not isinstance(source, ReadOp) else None)
        if shape is None or not (fx > 0 and fy > 0):
            raise ValueError("resize with dsize=(0,0) needs fx, fy > 0 and an array source")
        dsize = Size(int(round(shape[1] * fx)), int(round(shape[0] * fy)))
    return ResizeRead(source=src, dsize=dsize, interp=interpolation)


def resize_batch(
    source: Union[ArrayLike, Sequence[ArrayLike]],
    dsize: Size,
    rects: Optional[ArrayLike] = None,
    used_planes: Optional[ArrayLike] = None,
    background=0.0,
    aspect_ratio: AspectRatio = AspectRatio.IGNORE_AR,
    interpolation: InterpolationType = InterpolationType.INTER_LINEAR,
    channels: Optional[int] = None,
) -> BatchResizeRead:
    """The flagship batched variable-geometry resize
    (``cvGS::resize<T, INTER_LINEAR, NPtr, AR>``,
    ``include/cvGPUSpeedup.cuh:218-245``).

    - ``source`` = one frame + ``rects`` (N, 4) ``[x, y, w, h]``  (crops of a
      frame), or a list of independent images (padded+stacked internally).
    - ``used_planes``: runtime active-plane count (ragged batch); inactive
      planes emit ``background``.
    - ``background``: scalar or per-channel; fills inactive planes and
      letterbox borders for PRESERVE_AR modes.
    """
    if rects is not None:
        frame = source if isinstance(source, (jnp.ndarray, jax.core.Tracer)) else np.asarray(source)
        if frame.ndim == 2:  # grayscale without channel axis
            frame = frame[..., None]
        # host frames ingest packed (free numpy view; on-device reshape is a
        # relayout copy — see ops.memory.ImageRead.packed_channels)
        packed_c = 0
        if isinstance(frame, np.ndarray) and not isinstance(frame, jnp.ndarray):
            packed_c = int(frame.shape[-1])
        frame_hwc = frame
        rect_arr = rects if isinstance(rects, jax.core.Tracer) else np.asarray(rects, np.int32)
        if rect_arr.ndim != 2 or rect_arr.shape[1] != 4:
            raise ValueError("rects must be (N, 4) [x, y, w, h]")
        nch = channels or (frame.shape[-1] if frame.ndim == 3 else 1)
        if packed_c:
            frame = np.ascontiguousarray(frame_hwc).reshape(
                frame_hwc.shape[0], frame_hwc.shape[1] * packed_c
            )
        return BatchResizeRead(
            frame=frame,
            stack=None,
            rects=rect_arr,
            used_planes=None if used_planes is None else _np_or_traced(used_planes, np.int32),
            background=_dt.as_channel_vector(background, nch, np.float32),
            dsize=dsize,
            aspect_ratio=aspect_ratio,
            interp=interpolation,
            packed_channels=packed_c,
        )
    imgs = [np.asarray(s) for s in source]
    nch = channels or (imgs[0].shape[-1] if imgs[0].ndim == 3 else 1)
    max_h = max(i.shape[0] for i in imgs)
    max_w = max(i.shape[1] for i in imgs)
    stack = np.zeros((len(imgs), max_h, max_w, nch), dtype=imgs[0].dtype)
    rect_list = []
    for z, im in enumerate(imgs):
        if im.ndim == 2:
            im = im[:, :, None]
        stack[z, : im.shape[0], : im.shape[1], :] = im
        rect_list.append((0, 0, im.shape[1], im.shape[0]))
    stack = stack.reshape(len(imgs), max_h, max_w * nch)  # packed rows
    return BatchResizeRead(
        frame=None,
        stack=stack,
        packed_channels=nch,
        rects=np.asarray(rect_list, np.int32),
        used_planes=None if used_planes is None else _np_or_traced(used_planes, np.int32),
        background=_dt.as_channel_vector(background, nch, np.float32),
        dsize=dsize,
        aspect_ratio=aspect_ratio,
        interp=interpolation,
    )


def warp(
    source: _SourceLike,
    matrix: ArrayLike,
    dsize: Size,
    warp_type: WarpType = WarpType.AFFINE,
    default=0.0,
    channels: Optional[int] = None,
) -> ReadOp:
    """``cvGS::warp<WarpType, I>(src, 3x3/2x3, dstSize)``. The forward matrix
    is inverted host-side exactly like the reference wrapper
    (``include/cvGPUSpeedup.cuh:292-301``); pass ``warp_type=PERSPECTIVE`` with
    a 3x3 homography. Output is float32."""
    m = np.asarray(matrix, np.float64)
    if warp_type == WarpType.AFFINE:
        if m.shape != (2, 3):
            raise ValueError("affine warp needs a 2x3 matrix")
        inv = invert_affine(m)
    else:
        if m.shape != (3, 3):
            raise ValueError("perspective warp needs a 3x3 matrix")
        inv = invert_perspective(m)
    src = _as_read(source)
    nch = channels
    if nch is None:
        if isinstance(source, ReadOp):
            nch = int(jax.eval_shape(source.lower).shape[-1])
        elif source.ndim == 2:
            nch = 1
        else:
            nch = int(source.shape[-1])
    from .ops.warp import decompose_inverse_map

    terms = decompose_inverse_map(inv, dsize)
    return WarpRead(
        source=src,
        default=_dt.as_channel_vector(default, nch, np.float32),
        dsize=dsize,
        warp_type=warp_type,
        **terms,
    )


def set_to(value, shape, dtype=np.float32):
    """``fk::setTo(value, ptr)`` analog: a filled device array (functional —
    returns the filled value instead of mutating a buffer)."""
    return jnp.full(tuple(shape), value, dtype=jnp.dtype(dtype))


def make_border(
    source: _SourceLike,
    top: int,
    bottom: int,
    left: int,
    right: int,
    mode: "BorderMode" = None,
    value=0.0,
) -> ReadOp:
    """Border-extension read (FKL ``border_reader`` analog; cv2
    ``copyMakeBorder`` semantics). Composes with resize/warp back-ops."""
    mode = mode or BorderMode.REFLECT_101
    return BorderRead(
        source=_as_read(source),
        value=_np_or_traced(value, np.float32),
        top=int(top), bottom=int(bottom), left=int(left), right=int(right),
        mode=mode,
    )


def warp_batch(
    sources: Sequence[_SourceLike],
    matrices: Sequence[ArrayLike],
    dsize: Size,
    warp_type: WarpType = WarpType.AFFINE,
    used_planes: Optional[ArrayLike] = None,
    default=0.0,
    border_value=0.0,
) -> ReadOp:
    """Batched warp with per-image matrices — the ``cvGS::warp<WT, I, BATCH>``
    overload family incl. the ragged form with ``usedPlanes`` + default value
    (reference ``include/cvGPUSpeedup.cuh:381-442``,
    ``tests/warping/test_warping_opencv.cu:242-247``). ``border_value`` fills
    out-of-source samples; ``default`` fills planes beyond ``used_planes``."""
    if len(sources) != len(matrices):
        raise ValueError("need one matrix per source image")
    warps = [warp(s, m, dsize, warp_type=warp_type, default=border_value)
             for s, m in zip(sources, matrices)]
    return batch_read(
        warps,
        used_planes=used_planes,
        default=default if used_planes is not None else None,
    )


def batch_read(
    ops: Sequence[ReadOp],
    used_planes: Optional[ArrayLike] = None,
    default=None,
) -> ReadOp:
    """``fk::BatchRead<N, CONDITIONAL_WITH_DEFAULT>`` over arbitrary per-plane
    read ops."""
    if used_planes is not None and default is None:
        raise ValueError("batch_read with used_planes needs a default value "
                         "for the masked planes (CONDITIONAL_WITH_DEFAULT)")
    return BatchRead(
        ops=tuple(ops),
        used_planes=None if used_planes is None else _np_or_traced(used_planes, np.int32),
        default=None if default is None else _np_or_traced(default, np.float32),
    )


def circular_batch_read(data: ArrayLike, first, ascendent: bool = True,
                        channels: Optional[int] = None) -> ReadOp:
    """Temporal ring view (F8). Host (numpy) rings of shape (N, H, W, C)
    ingest packed — (N, H, W*C) rows, free on the host; ``channels=C``
    declares an already-packed ring."""
    packed = 0
    if channels is not None:
        arr = data if isinstance(data, (jnp.ndarray, jax.core.Tracer))             else np.asarray(data)
        if arr.ndim != 3 or arr.shape[-1] % channels:
            raise ValueError("circular_batch_read(channels=) expects a packed "
                             "(N, H, W*C) ring")
        packed = int(channels)
    elif (isinstance(data, np.ndarray) and not isinstance(data, jnp.ndarray)
            and data.ndim == 4 and data.shape[-1] > 1):
        c = int(data.shape[-1])
        arr = np.ascontiguousarray(data).reshape(
            data.shape[0], data.shape[1], data.shape[2] * c)
        packed = c
    else:
        arr = data if isinstance(data, (jnp.ndarray, jax.core.Tracer)) else np.asarray(data)
    return CircularBatchRead(
        data=arr,
        first=_np_or_traced(first, np.int32), ascendent=ascendent,
        packed_channels=packed,
    )


# ---------------------------------------------------------------------------
# write factories (reference include/cvGPUSpeedup.cuh:163-202,449-462)
# ---------------------------------------------------------------------------


def write() -> WriteOp:
    """Packed channel-last output (``cvGS::write<O>(GpuMat)``)."""
    return Write2D()


def write_tensor() -> WriteOp:
    """Packed batch tensor (N, H, W, C) (``fk::TensorWrite``)."""
    return TensorWrite()


def split() -> WriteOp:
    """Per-channel separate buffers (``cvGS::split<O>(vector<GpuMat>)``)."""
    return SplitWrite()


def split_tensor() -> WriteOp:
    """Planar (N, C, H, W) tensor (``cvGS::split<O>(GpuMat, planeDims)``)."""
    return TensorSplit()


def split_tensor_transposed() -> WriteOp:
    """Channel-major (C, N, H, W) tensor (``cvGS::splitT``)."""
    return TensorTSplit()


def split_tensor_packed() -> WriteOp:
    """Planar tensor reshaped to (N, C, H/f, f*W) — row-major-identical to
    :func:`split_tensor` (``reshape(N, C, H, W)`` recovers it;
    ``reshape(N, C*H*W)`` is the reference's flat per-image row)."""
    return TensorSplitPacked()


__all__ = [
    # graph
    "IOp", "ReadOp", "ComputeOp", "WriteOp", "FusedCompute", "fuse",
    "Pipeline", "build_pipeline", "execute_operations",
    "build_operation_sequence", "launch_divergent_batch",
    # types
    "Size", "Point", "Rect", "InterpolationType", "AspectRatio",
    "CircularTensorOrder", "ColorPlanes", "ColorRange", "ColorStandard",
    "PixelFormat", "ParBackend", "ColorConversionCode", "WarpType",
    # factories
    "convert_to", "multiply", "add", "subtract", "divide", "cvt_color",
    "vector_reorder", "static_loop", "convert_yuv_to_rgb", "image",
    "read_yuv", "crop", "crop_batch", "resize", "resize_batch", "warp",
    "batch_read", "circular_batch_read", "set_to", "make_border", "BorderMode", "warp_batch",
    "write", "write_tensor", "split", "split_tensor", "split_tensor_transposed",
    "split_tensor_packed",
    # data
    "CircularTensor",
    # utils
    "saturate_cast_fn",
]
