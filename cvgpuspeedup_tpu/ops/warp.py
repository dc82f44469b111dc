"""Affine / perspective warp read ops.

Equivalent of ``fk::Warping<WarpType::{Affine,Perspective}[, ReadOp]>`` with
``WarpingParameters`` = **inverse** transform matrix + destination size
(reference F11; factory surface ``include/cvGPUSpeedup.cuh:285-442``). As in
the reference wrapper, the user passes the forward matrix and it is inverted
host-side (``cv::invertAffineTransform`` / ``cv::Mat::inv`` analog,
``include/cvGPUSpeedup.cuh:292-301``); the stored op param is the inverse map.

Sampling: INTER_LINEAR with constant border — any tap outside the source
contributes the default value (0), matching OpenCV ``warpAffine``/
``warpPerspective`` semantics that the reference validates against
(``tests/warping/test_warping_opencv.cu:58-73``; perspective border pixels are
"EXPECTED_FAIL" there, i.e. a small tolerance is inherent). Output is
float-typed; callers append a cast (``tests/warping/test_warping_opencv.cu:63``).
"""

from __future__ import annotations

import enum


import jax
import jax.numpy as jnp
import numpy as np

from ..graph import ReadOp, op, static_field
from ..types import Size


class WarpType(enum.Enum):
    AFFINE = "affine"
    PERSPECTIVE = "perspective"


def invert_affine(m) -> np.ndarray:
    """``cv::invertAffineTransform`` for a 2x3 matrix (host-side, float64)."""
    m = np.asarray(m, dtype=np.float64)
    a = m[:, :2]
    b = m[:, 2]
    a_inv = np.linalg.inv(a)
    b_inv = -a_inv @ b
    return np.concatenate([a_inv, b_inv[:, None]], axis=1)


def invert_perspective(m) -> np.ndarray:
    """``cv::Mat::inv`` for a 3x3 homography (host-side, float64)."""
    return np.linalg.inv(np.asarray(m, dtype=np.float64))


def _sample_constant_border(src_f32, sx, sy, border):
    """Bilinear at float coords (sx, sy); out-of-range taps read ``border``."""
    h, w = src_f32.shape[0], src_f32.shape[1]
    x0f = jnp.floor(sx)
    y0f = jnp.floor(sy)
    wx = (sx - x0f)[..., None]
    wy = (sy - y0f)[..., None]
    x0 = x0f.astype(jnp.int32)
    y0 = y0f.astype(jnp.int32)

    def tap(ix, iy):
        valid = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        v = src_f32[jnp.clip(iy, 0, h - 1), jnp.clip(ix, 0, w - 1)]
        return jnp.where(valid[..., None], v, border)

    v00 = tap(x0, y0)
    v01 = tap(x0 + 1, y0)
    v10 = tap(x0, y0 + 1)
    v11 = tap(x0 + 1, y0 + 1)
    h0 = v00 * (1.0 - wx) + v01 * wx
    h1 = v10 * (1.0 - wx) + v11 * wx
    return h0 * (1.0 - wy) + h1 * wy


def decompose_inverse_map(inv: np.ndarray, dsize: Size):
    """Split the inverse map into per-axis coordinate term vectors — OpenCV's
    adelta/bdelta decomposition.

    Device-side the coordinate is then ONE f32 add (+ divide for perspective):
    ``sx(y, x) = col_x[x] + row_x[y]`` etc.

    The term PRODUCTS are computed in float32 (coefficients rounded to f32
    first, then IEEE f32 multiply/add), which is what the reference's CUDA
    path effectively computes per thread; a reference that recomputes the
    terms the same way agrees to the last bit (a 1-ulp term mismatch at
    sy ~ 1000 is a 1.2e-4 coordinate shift, up to ~0.03 of value error).
    """
    inv = np.asarray(inv, np.float64)
    c = inv.astype(np.float32)
    xs = np.arange(dsize.width, dtype=np.float32)
    ys = np.arange(dsize.height, dtype=np.float32)
    terms = {
        "col_x": c[0, 0] * xs,
        "row_x": c[0, 1] * ys + c[0, 2],
        "col_y": c[1, 0] * xs,
        "row_y": c[1, 1] * ys + c[1, 2],
    }
    if inv.shape[0] == 3:
        terms["col_w"] = c[2, 0] * xs
        terms["row_w"] = c[2, 1] * ys + c[2, 2]
    else:
        terms["col_w"] = None
        terms["row_w"] = None
    return {
        k: (None if v is None else jnp.asarray(v, jnp.float32)) for k, v in terms.items()
    }


@op
class WarpRead(ReadOp):
    """Warp a source read through an inverse (dst -> src) map, held as
    precomputed per-axis coordinate terms (see :func:`decompose_inverse_map`)."""

    source: ReadOp
    col_x: jnp.ndarray  # (W,)
    row_x: jnp.ndarray  # (H,)
    col_y: jnp.ndarray
    row_y: jnp.ndarray
    col_w: object  # (W,) or None (affine)
    row_w: object
    default: jnp.ndarray  # per-channel border value, float32
    dsize: Size = static_field()
    warp_type: WarpType = static_field()

    def lower(self) -> jnp.ndarray:
        # jnp.asarray: a host-numpy source indexed with TRACED tap indices
        # would call numpy fancy indexing on tracers (crashes under
        # eval_shape / abstract tracing)
        src = jnp.asarray(self.source.lower()).astype(jnp.float32)
        sx = self.col_x[None, :] + self.row_x[:, None]
        sy = self.col_y[None, :] + self.row_y[:, None]
        if self.warp_type == WarpType.PERSPECTIVE:
            den = self.col_w[None, :] + self.row_w[:, None]
            den = jnp.where(den == 0.0, jnp.float32(1.0), den)
            sx = sx / den
            sy = sy / den
        border = jnp.asarray(self.default, jnp.float32)
        return _sample_constant_border(src, sx, sy, border)

    def describe(self) -> str:
        return (
            f"Warp[{self.warp_type.name},{self.dsize.width}x{self.dsize.height}]"
            f"({self.source.describe()})"
        )
