"""Bilinear resize read ops — single image and batched variable-geometry.

Equivalent of ``fk::Resize<InterpolationType[, AspectRatio][, BackOp]>``
(reference F11; factory surface ``include/cvGPUSpeedup.cuh:204-245``):

- interpolation: INTER_LINEAR only (whitelist ``include/cv2cuda_types.cuh:86``),
  computed in float32 with OpenCV half-pixel-center coordinates; **the resize
  stage always emits float**, callers append a cast (reference
  ``include/cvGPUSpeedup.cuh:227``, ``tests/resize/test_resize_write.cu:55-56``).
- :class:`BatchResizeRead` is the flagship read: N crops with per-plane runtime
  geometry, one fused program (reference ``include/cvGPUSpeedup.cuh:218-245``,
  call stack SURVEY.md §3.2). Per-plane rects/sizes/active-mask/background are
  runtime arrays — batch geometry changes never recompile.
- aspect-ratio modes ``PRESERVE_AR / IGNORE_AR / PRESERVE_AR_RN_EVEN /
  PRESERVE_AR_LEFT`` (reference ``include/cvGPUSpeedup.cuh:32``); PRESERVE_AR
  letterboxes into the target with the background value, with the exact
  float/trunc arithmetic of the reference host code
  (``tests/batchresize/test_batchresize_aspectratio_x_split3D.cu:86-95``).

The coordinate/weight helpers here are the single source of truth for bilinear
numerics: every lowering (gathers, polyphase slices, dense matmuls) takes its
taps and weights from them.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
import jax.numpy as jnp

from ..graph import ReadOp, op, static_field
from ..types import AspectRatio, InterpolationType, Size


def axis_lerp(q, src_len, dst_len):
    """Per-output-index source taps + weight for one axis, OpenCV semantics.

    OpenCV computes ``s = (q + 0.5) * (src/dst) - 0.5`` in double. Device
    code avoids doubles, so we use the exact rational form instead::

        s = ((2q + 1) * src - dst) / (2 * dst)

    with integer numerator/denominator: ``i0 = floor_divide(num, den)`` is
    EXACT, and the fractional weight ``(num - i0*den) / den`` is one
    correctly-rounded f32 division of exact integers (<= 0.5 ulp). This agrees
    with cv2's double-then-float weights to ~1 ulp — well inside the 1e-4
    float contract — where a naive f32 ``(q+0.5)*scale`` drifts to ~1e-3.

    Border clamping matches ``cv::resize`` INTER_LINEAR: weight forced to 0
    when the left tap clamps at either edge.

    ``q``: int32 output indices (may be offset for letterboxing);
    ``src_len``/``dst_len``: ints or traced int32 scalars.
    Returns ``(i0, i1, w)``: int32 taps and f32 weights, shaped like ``q``.
    """
    q = jnp.asarray(q, jnp.int32)
    src_len = jnp.asarray(src_len, jnp.int32)
    dst_len = jnp.asarray(dst_len, jnp.int32)
    num = (2 * q + 1) * src_len - dst_len
    den = 2 * dst_len
    i0 = jnp.floor_divide(num, den)
    w = (num - i0 * den).astype(jnp.float32) / den.astype(jnp.float32)
    w = jnp.where(i0 < 0, 0.0, w)
    i0 = jnp.maximum(i0, 0)
    w = jnp.where(i0 >= src_len - 1, 0.0, w)
    i0 = jnp.minimum(i0, src_len - 1)
    i1 = jnp.minimum(i0 + 1, src_len - 1)
    return i0, i1, w


def letterbox_geometry(crop_w, crop_h, dsize: Size, mode: AspectRatio):
    """Target sub-rectangle for aspect-ratio-preserving resize.

    Float/trunc math copied semantically from the reference oracle
    (``tests/batchresize/test_batchresize_aspectratio_x_split3D.cu:86-95``):
    scale to target height, truncate the scaled width, and if it overflows
    scale to target width instead. Offsets center the sub-rect (integer
    division), except PRESERVE_AR_LEFT which anchors at (0, 0).
    PRESERVE_AR_RN_EVEN additionally rounds the fitted dims to the nearest
    even number (reconstructed; enum at reference ``include/cvGPUSpeedup.cuh:32``).

    Returns traced int32 scalars ``(new_w, new_h, ox, oy)``.
    """
    dst_w, dst_h = dsize.width, dsize.height
    crop_w = jnp.asarray(crop_w, jnp.float32)
    crop_h = jnp.asarray(crop_h, jnp.float32)
    if mode == AspectRatio.IGNORE_AR:
        zero = jnp.int32(0)
        return jnp.int32(dst_w), jnp.int32(dst_h), zero, zero
    scale = jnp.float32(dst_h) / crop_h
    new_w = (scale * crop_w).astype(jnp.int32)  # trunc, as static_cast<int>
    overflow = new_w > dst_w
    scale2 = jnp.float32(dst_w) / crop_w
    new_h2 = (scale2 * crop_h).astype(jnp.int32)
    new_w = jnp.where(overflow, dst_w, new_w)
    new_h = jnp.where(overflow, new_h2, dst_h)
    if mode == AspectRatio.PRESERVE_AR_RN_EVEN:
        new_w = jnp.minimum(((new_w + 1) // 2) * 2, dst_w)
        new_h = jnp.minimum(((new_h + 1) // 2) * 2, dst_h)
    if mode == AspectRatio.PRESERVE_AR_LEFT:
        ox = jnp.int32(0)
        oy = jnp.int32(0)
    else:
        ox = (dst_w - new_w) // 2
        oy = (dst_h - new_h) // 2
    return new_w, new_h, ox, oy


def _bilinear_sample(img_f32, i0x, i1x, wx, i0y, i1y, wy):
    """Separable bilinear via 4 corner-point gathers: horizontal lerp first,
    then vertical.

    The association (horizontal, then vertical, each as ``a*(1-w) + b*w``) is
    fixed; the polyphase and matmul forms keep it.
    """
    ry0 = i0y[:, None]
    ry1 = i1y[:, None]
    cx0 = i0x[None, :]
    cx1 = i1x[None, :]
    v00 = img_f32[ry0, cx0]
    v01 = img_f32[ry0, cx1]
    v10 = img_f32[ry1, cx0]
    v11 = img_f32[ry1, cx1]
    wx_c = wx[None, :, None]
    wy_c = wy[:, None, None]
    h0 = v00 * (1.0 - wx_c) + v01 * wx_c
    h1 = v10 * (1.0 - wx_c) + v11 * wx_c
    return h0 * (1.0 - wy_c) + h1 * wy_c


def axis_lerp_np(q, src_len: int, dst_len: int):
    """Numpy mirror of :func:`axis_lerp` for concrete geometry (identical
    exact-integer-rational math and f32 weight division; identical edge
    clamping). Single host-side source of truth for baked weight tables —
    used by the matmul lowering here."""
    q = np.asarray(q, np.int64)
    num = (2 * q + 1) * src_len - dst_len
    den = 2 * dst_len
    i0 = num // den
    w = ((num - i0 * den).astype(np.float32) / np.float32(den)).astype(np.float32)
    w = np.where(i0 < 0, np.float32(0.0), w)
    i0 = np.maximum(i0, 0)
    w = np.where(i0 >= src_len - 1, np.float32(0.0), w)
    i0 = np.minimum(i0, src_len - 1)
    i1 = np.minimum(i0 + 1, src_len - 1)
    return i0, i1, w.astype(np.float32)


def _axis_weight_matrices(src_len: int, dst_len: int):
    """Dense (src_len, dst_len) f32 interpolation matrices with exactly the
    :func:`axis_lerp` taps/weights, SPLIT per tap: ``m0`` holds (1-w) at i0,
    ``m1`` holds w at i1. Splitting keeps the lerp bit-exact under matmul:
    each column has ONE nonzero, so each dot output is a single correctly-
    rounded f32 product (zero addends are exact), and ``x@m0 + x@m1``
    reproduces ``a*(1-w) + b*w`` with the same separate roundings — a
    combined matrix would let the accumulator fuse the two products and
    drift ~1 ulp, flipping .5 ties in integer casts."""
    q = np.arange(dst_len, dtype=np.int64)
    i0, i1, w = axis_lerp_np(q, src_len, dst_len)
    m0 = np.zeros((src_len, dst_len), np.float32)
    m1 = np.zeros((src_len, dst_len), np.float32)
    m0[i0, q] = np.float32(1.0) - w
    m1[i1, q] = w
    return m0, m1


#: phase-count cap for the polyphase path; above this, fall back to gathers
_MAX_PHASES = 32

#: weight-table budget for the dense-matmul resize fallback (bytes per axis)
_MATMUL_WEIGHT_BYTES = 8 * 1024 * 1024


def _axis_phases(src_len: int, dst_len: int):
    """Static polyphase decomposition of one resize axis (host-side numpy).

    The rational coordinate ``s(q) = ((2q+1)src - dst)/(2dst)`` is periodic in
    ``Q = dst/gcd(src, dst)`` phases: outputs ``q = phi + k*Q`` share one
    weight and advance the source tap by ``P = src/gcd`` per step. Each phase
    therefore lowers to TWO STRIDED SLICES + a constant-weight lerp — no
    gathers. (Chosen where gathers were slow; whether it still beats the
    gather form on the GPU is an open measurement in ROADMAP.md.)

    Returns ``(P, Q, i0_per_phase, w_per_phase, counts)`` with i0 UNCLAMPED
    (edge behavior is reproduced by edge-padding the source: when the exact
    semantics clamp, both taps read the same edge pixel so any weight yields
    the clamped value).
    """
    import math

    g = math.gcd(src_len, dst_len)
    p_stride, q_phases = src_len // g, dst_len // g
    phis = np.arange(q_phases, dtype=np.int64)
    num = (2 * phis + 1) * src_len - dst_len
    den = 2 * dst_len
    i0 = num // den
    # f32/f32 division, matching axis_lerp_np's single rounding (an f64
    # divide then f32 cast can double-round one ulp differently)
    w = (num - i0 * den).astype(np.float32) / np.float32(den)
    counts = np.full(q_phases, dst_len // q_phases, np.int64)
    return p_stride, q_phases, i0, w, counts


def _resize_axis_static(x: jnp.ndarray, axis: int, src_len: int, dst_len: int):
    """Resize one axis with static geometry via polyphase strided slices.

    ``x`` is float32; ``axis`` is 0 or 1 of a (H, W, C) array. Exactly the
    math of :func:`axis_lerp` + the lerp in :func:`_bilinear_sample`.
    """
    p_stride, q_phases, i0s, ws, counts = _axis_phases(src_len, dst_len)
    k = int(counts[0])
    # Pad only as far as taps actually reach (edge mode: a clamped tap then
    # reads the same edge pixel, so the weight becomes irrelevant — exactly
    # the OpenCV clamp semantics). Pure downscales need no pad at all and
    # lower to zero-copy strided slices.
    max_tap = int(i0s.max()) + 1 + (k - 1) * p_stride
    pad_l = max(0, -int(i0s.min()))
    pad_r = max(0, max_tap - (src_len - 1))
    if pad_l or pad_r:
        pad = [(0, 0)] * x.ndim
        pad[axis] = (pad_l, pad_r)
        xp = jnp.pad(x, pad, mode="edge")
    else:
        xp = x

    def slice_axis(start, stride):
        idx = [slice(None)] * x.ndim
        idx[axis] = slice(start, start + (k - 1) * stride + 1, stride)
        return xp[tuple(idx)]

    phases = []
    for phi in range(q_phases):
        a = slice_axis(int(i0s[phi]) + pad_l, p_stride)
        w = float(ws[phi])
        if w == 0.0:
            # pure subsample: keep the source dtype (converting after the
            # slice is up to P x cheaper than converting the full source)
            phases.append(a)
        else:
            b = slice_axis(int(i0s[phi]) + pad_l + 1, p_stride)
            wf = jnp.float32(w)
            phases.append(
                a.astype(jnp.float32) * (1.0 - wf) + b.astype(jnp.float32) * wf
            )
    if q_phases == 1:
        return phases[0]
    # interleave phases: stack -> (..., K, Q, ...) -> reshape to dst_len
    # (mixed-phase outputs promote to f32 first)
    if any(p.dtype != phases[0].dtype for p in phases):
        phases = [p.astype(jnp.float32) for p in phases]
    stacked = jnp.stack(phases, axis=axis + 1)  # (.., K, Q, ..)
    new_shape = list(x.shape)
    new_shape[axis] = dst_len
    return stacked.reshape(new_shape)


def _axis_phases_half(src_len_full: int, dst_len: int):
    """Polyphase plan for resizing a HALF-resolution plane with FULL-resolution
    tap math (the NV12 chroma case): the logical source is the 2x
    nearest-upsampled plane, so the exact lerp is

        out[q] = uv[i0(q) // 2] * (1 - w(q)) + uv[i1(q) // 2] * w(q)

    with ``i0/i1/w`` from the full-res rational coordinates. ``i0(q+Q) =
    i0(q) + P`` makes the halved taps periodic in Q phases when P is even and
    2Q phases when P is odd. Returns ``(stride, q2, j0, j1, w)`` or None when
    the doubled phase count does not divide ``dst_len`` or exceeds the phase
    cap."""
    import math

    g = math.gcd(src_len_full, dst_len)
    p_stride, q_phases = src_len_full // g, dst_len // g
    if p_stride % 2 == 0:
        q2, pp = q_phases, p_stride
    else:
        q2, pp = 2 * q_phases, 2 * p_stride
    if dst_len % q2 or q2 > _MAX_PHASES:
        return None
    phis = np.arange(q2, dtype=np.int64)
    num = (2 * phis + 1) * src_len_full - dst_len
    den = 2 * dst_len
    i0 = num // den  # UNCLAMPED full-res left tap (edge pad supplies clamps)
    # same f32/f32 single-rounded division as axis_lerp_np / _axis_phases
    w = (num - i0 * den).astype(np.float32) / np.float32(den)
    j0 = i0 // 2  # floor division: correct for negative taps too
    j1 = (i0 + 1) // 2
    return pp // 2, q2, j0, j1, w


def _resize_axis_half(x: jnp.ndarray, axis: int, src_len_full: int, dst_len: int):
    """Resize one axis of a half-resolution plane using full-resolution
    INTER_LINEAR coordinates (chroma of NV12, see :func:`_axis_phases_half`).
    Bit-identical to ``_resize_axis_static`` applied to the 2x-upsampled
    plane (both keep unclamped taps and read edge padding, so clamped taps
    hit the same pixel), without ever materializing it. Edge outputs can
    drift <=1 ulp from the gather path: ``axis_lerp`` zeroes the weight at a
    clamped edge (exactly ``v``) where the polyphase form computes
    ``v*(1-w) + v*w`` — inside the float contract. Caller checks
    feasibility."""
    plan = _axis_phases_half(src_len_full, dst_len)
    assert plan is not None, "caller must check _axis_phases_half feasibility"
    stride, q2, j0s, j1s, ws = plan
    half_len = x.shape[axis]
    k = dst_len // q2
    reach0 = j0s + (k - 1) * stride
    reach1 = j1s + (k - 1) * stride
    pad_l = max(0, -int(j0s.min()))
    pad_r = max(0, int(max(reach0.max(), reach1.max())) - (half_len - 1))
    if pad_l or pad_r:
        pad = [(0, 0)] * x.ndim
        pad[axis] = (pad_l, pad_r)
        xp = jnp.pad(x, pad, mode="edge")
    else:
        xp = x

    def slice_axis(start, step):
        idx = [slice(None)] * x.ndim
        idx[axis] = slice(start, start + (k - 1) * step + 1, step)
        return xp[tuple(idx)]

    phases = []
    for phi in range(q2):
        a = slice_axis(int(j0s[phi]) + pad_l, stride)
        w = float(ws[phi])
        if w == 0.0:
            phases.append(a)
        else:
            b = slice_axis(int(j1s[phi]) + pad_l, stride)
            wf = jnp.float32(w)
            phases.append(
                a.astype(jnp.float32) * (1.0 - wf) + b.astype(jnp.float32) * wf
            )
    if q2 == 1:
        return phases[0]
    if any(p.dtype != phases[0].dtype for p in phases):
        phases = [p.astype(jnp.float32) for p in phases]
    stacked = jnp.stack(phases, axis=axis + 1)
    new_shape = list(x.shape)
    new_shape[axis] = dst_len
    return stacked.reshape(new_shape)


def _resize_matmul(src: jnp.ndarray, dst_w: int, dst_h: int) -> jnp.ndarray:
    """Static-geometry bilinear resize as two dense matmuls.

    For ratios whose polyphase period exceeds ``_MAX_PHASES`` (prime-ish
    destination dims, e.g. 1080p -> 97x111: 97 horizontal phases), the
    banded (src_len, dst_len) interpolation tables are small enough to
    multiply densely. Association is horizontal-then-vertical, identical
    weights/taps to the gather form (see ``_axis_weight_matrices``), at
    ``Precision.HIGHEST`` so the GPU does not run these dots in TF32.
    Whether this beats the gather form on the GPU is an open measurement
    in ROADMAP.md.
    """
    src_h, src_w = int(src.shape[0]), int(src.shape[1])
    wh0, wh1 = (jnp.asarray(m) for m in _axis_weight_matrices(src_w, dst_w))
    wv0, wv1 = (jnp.asarray(m) for m in _axis_weight_matrices(src_h, dst_h))
    x = src.astype(jnp.float32)
    hi = jax.lax.Precision.HIGHEST
    # (H, W, C) x (W, dstW) -> (H, dstW, C), horizontal first
    t = (
        jnp.einsum("hwc,wx->hxc", x, wh0, precision=hi)
        + jnp.einsum("hwc,wx->hxc", x, wh1, precision=hi)
    )
    return (
        jnp.einsum("hxc,hy->yxc", t, wv0, precision=hi)
        + jnp.einsum("hxc,hy->yxc", t, wv1, precision=hi)
    )


@op
class ResizeRead(ReadOp):
    """Single-image bilinear resize over any back read-op. Emits float32.

    Geometry is static, so the lowering is gather-free where possible: a
    polyphase strided-slice pass per axis (horizontal first, then vertical —
    the same association as the batched paths). Ratios with more than
    ``_MAX_PHASES`` phases fall back to the corner-gather form.
    """

    source: ReadOp
    dsize: Size = static_field()
    interp: InterpolationType = static_field(default=InterpolationType.INTER_LINEAR)

    def _commuted_source(self):
        """Linearity rewrite: a float YUV->RGB conversion is an affine
        pointwise map, which commutes EXACTLY with bilinear resize (the
        interpolation weights sum to 1, so offsets pass through). Pulling the
        conversion AFTER the resize converts only dst-resolution pixels — on
        the 6K "ComputeWhatYouSee" downscale that is 1/9th of the work.
        Returns (yuv_source_value, conversion_op) or None."""
        from ..graph import FusedRead
        from .nv12 import ConvertYUVToRGB, ReadYUV

        src = self.source
        if not isinstance(src, FusedRead) or len(src.chain) != 1:
            return None
        conv = src.chain[0]
        if not isinstance(conv, ConvertYUVToRGB) or not isinstance(src.read, ReadYUV):
            return None
        if not jnp.issubdtype(jnp.dtype(conv.out_dtype), jnp.floating):
            return None  # integer out saturates — not affine
        return src.read, conv

    def _lower_yuv_planespace(self, readop, conv):
        """Resize each NV12 plane at its NATIVE resolution, then convert.

        The default commuted path still materializes full-resolution chroma
        (2x nearest upsample) before resizing; here the upsample-then-resize
        composition folds into a half-resolution polyphase plan
        (:func:`_axis_phases_half`), so the chroma plane is read once at
        native size. On a 6K -> 1080p downscale this removes every
        full-resolution intermediate: the whole read is strided slices of
        the raw NV12 buffer. Bit-identical to the full-res path. Returns
        None when a plane's phase plan is infeasible (caller falls back).
        """
        import math

        y, uv = readop.lower_native_planes()
        src_h, src_w = int(y.shape[0]), int(y.shape[1])
        dst_w, dst_h = self.dsize.width, self.dsize.height
        qx = dst_w // math.gcd(src_w, dst_w)
        qy = dst_h // math.gcd(src_h, dst_h)
        if qx > _MAX_PHASES or qy > _MAX_PHASES:
            return None
        if (
            _axis_phases_half(src_w, dst_w) is None
            or _axis_phases_half(src_h, dst_h) is None
        ):
            return None
        y_r = _resize_axis_static(y, 1, src_w, dst_w)
        y_r = _resize_axis_static(y_r, 0, src_h, dst_h)
        uv_r = _resize_axis_half(uv, 1, src_w, dst_w)
        uv_r = _resize_axis_half(uv_r, 0, src_h, dst_h)
        x = jnp.stack(
            [
                y_r.astype(jnp.float32),
                uv_r[..., 0].astype(jnp.float32),
                uv_r[..., 1].astype(jnp.float32),
            ],
            axis=-1,
        )
        return conv.apply(x)  # affine conversion on dst-resolution pixels

    def lower(self) -> jnp.ndarray:
        commuted = self._commuted_source()
        if commuted is not None:
            readop, conv = commuted
            out = self._lower_yuv_planespace(readop, conv)
            if out is not None:
                return out
            src = readop.lower()
        else:
            src = self.source.lower()
        if src.ndim != 3:
            raise ValueError("ResizeRead expects a single (H, W, C) source")
        src_h, src_w = int(src.shape[0]), int(src.shape[1])
        dst_w, dst_h = self.dsize.width, self.dsize.height
        import math

        qx = dst_w // math.gcd(src_w, dst_w)
        qy = dst_h // math.gcd(src_h, dst_h)
        if qx <= _MAX_PHASES and qy <= _MAX_PHASES:
            x = _resize_axis_static(src, 1, src_w, dst_w)
            x = _resize_axis_static(x, 0, src_h, dst_h)
            x = x.astype(jnp.float32)  # pure-subsample paths stay integer
        elif (src_w * dst_w + src_h * dst_h) * 2 * 4 <= _MATMUL_WEIGHT_BYTES:
            # x2: _axis_weight_matrices returns TWO (src, dst) f32 matrices
            # per axis (the split m0/m1 tap pair)
            x = _resize_matmul(src, dst_w, dst_h)
        else:
            i0x, i1x, wx = axis_lerp(jnp.arange(dst_w), src_w, dst_w)
            i0y, i1y, wy = axis_lerp(jnp.arange(dst_h), src_h, dst_h)
            x = _bilinear_sample(src.astype(jnp.float32), i0x, i1x, wx, i0y, i1y, wy)
        if commuted is not None:
            x = conv.apply(x)  # affine conversion on dst-resolution pixels
        return x

    def describe(self) -> str:
        return f"Resize[{self.dsize.width}x{self.dsize.height}]({self.source.describe()})"


@op
class BatchResizeRead(ReadOp):
    """The flagship: N variable-geometry crops -> dsize, one fused program.

    Two source modes (exactly one of ``frame``/``stack`` is set):

    - *rect mode*: ``frame`` (H, W, C) + ``rects`` (N, 4) int32 ``[x, y, w, h]``
      — N crops of one frame (the reference's 50-detections pipeline,
      SURVEY.md §3.2).
    - *stack mode*: ``stack`` (N, maxH, maxW, C) padded stack + ``rects`` with
      x=y=0 and per-plane true dims — N independent images.

    ``used_planes`` (runtime scalar) masks ragged batches: planes >= it emit
    ``background`` (reference CONDITIONAL_WITH_DEFAULT, F7). ``background`` is
    a per-channel float32 vector; it also fills letterbox borders for
    PRESERVE_AR modes. Output: (N, dstH, dstW, C) float32.
    """

    frame: Optional[jnp.ndarray]
    stack: Optional[jnp.ndarray]
    rects: jnp.ndarray
    used_planes: Optional[jnp.ndarray]
    background: jnp.ndarray
    dsize: Size = static_field()
    aspect_ratio: AspectRatio = static_field(default=AspectRatio.IGNORE_AR)
    interp: InterpolationType = static_field(default=InterpolationType.INTER_LINEAR)
    #: >0: frame/stack rows are channel-interleaved — frame (H, W*C), stack
    #: (N, H, W*C). The factory packs host arrays (a free numpy view).
    packed_channels: int = static_field(default=0)

    batched = True

    @property
    def num_planes(self) -> int:
        return self.rects.shape[0]

    def frame_hwc(self):
        """The logical (H, W, C) frame (unpacking if needed — XLA path)."""
        f = self.frame
        if f is not None and self.packed_channels:
            c = self.packed_channels
            f = f.reshape(f.shape[0], f.shape[1] // c, c)
        return f

    def stack_nhwc(self):
        """The logical (N, H, W, C) stack (unpacking if needed — XLA path)."""
        s = self.stack
        if s is not None and self.packed_channels:
            c = self.packed_channels
            s = s.reshape(s.shape[0], s.shape[1], s.shape[2] // c, c)
        return s

    def source_dims(self):
        """(src_h, src_w, nch) of the logical source plane."""
        src = self.frame if self.frame is not None else self.stack
        off = 0 if self.frame is not None else 1
        if self.packed_channels:
            nch = self.packed_channels
            return int(src.shape[off]), int(src.shape[off + 1]) // nch, nch
        return int(src.shape[off]), int(src.shape[off + 1]), int(src.shape[-1])

    def lower(self) -> jnp.ndarray:
        dst_w, dst_h = self.dsize.width, self.dsize.height
        dsize = self.dsize
        mode = self.aspect_ratio
        bg = jnp.asarray(self.background, jnp.float32)

        def one_plane(rect, plane_src):
            x0, y0 = rect[0], rect[1]
            w, h = rect[2], rect[3]
            new_w, new_h, ox, oy = letterbox_geometry(w, h, dsize, mode)
            # Coordinates relative to the letterbox sub-rect (exact rational
            # math, see axis_lerp). Taps clamp inside the crop window, then
            # shift into the source frame.
            qx = jnp.arange(dst_w, dtype=jnp.int32) - ox
            qy = jnp.arange(dst_h, dtype=jnp.int32) - oy
            i0x, i1x, wx = axis_lerp(qx, w, new_w)
            i0y, i1y, wy = axis_lerp(qy, h, new_h)
            val = _bilinear_sample(
                plane_src, x0 + i0x, x0 + i1x, wx, y0 + i0y, y0 + i1y, wy
            )
            # letterbox mask
            col = jnp.arange(dst_w, dtype=jnp.int32)
            row = jnp.arange(dst_h, dtype=jnp.int32)
            inside = ((col >= ox) & (col < ox + new_w))[None, :, None] & (
                (row >= oy) & (row < oy + new_h)
            )[:, None, None]
            return jnp.where(inside, val, bg)

        rects = jnp.asarray(self.rects, jnp.int32)
        if self.frame is not None:
            # jnp coercion matters when lowering OUTSIDE jit (eval_shape /
            # direct Pipeline.lower): vmap tracers cannot index numpy leaves
            frame = jnp.asarray(self.frame_hwc()).astype(jnp.float32)
            out = jax.vmap(lambda r: one_plane(r, frame))(rects)
        else:
            stack = jnp.asarray(self.stack_nhwc()).astype(jnp.float32)
            out = jax.vmap(one_plane)(rects, stack)

        if self.used_planes is not None:
            n = out.shape[0]
            z = jnp.arange(n).reshape(n, 1, 1, 1)
            out = jnp.where(z < self.used_planes, out, bg)
        return out

    def describe(self) -> str:
        return (
            f"BatchResize[{self.num_planes} -> {self.dsize.width}x{self.dsize.height},"
            f" {self.aspect_ratio.name}]"
        )
