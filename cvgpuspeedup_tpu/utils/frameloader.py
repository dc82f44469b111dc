"""Python binding for the native streaming frame loader (native/frameloader.cpp).

Feeds raw NV12 / packed-RGB frame sequences from disk through a native
prefetch ring so the next frame is always host-resident while the device
runs the current fused pipeline — the data-path role the reference delegates to
its consumers' OpenCV/cudaMemcpy staging code.

The shared library builds on demand (``make -C native``); when no compiler
is available, :class:`FrameLoader` transparently falls back to a pure-numpy
reader with identical semantics (slower, no prefetch overlap).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Iterator, Tuple

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libframeloader.so")

_lib = None
_lib_tried = False


def _load_native():
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    try:
        if not os.path.exists(_LIB_PATH):
            subprocess.run(
                ["make", "-C", _NATIVE_DIR], check=True,
                capture_output=True, timeout=120,
            )
        lib = ctypes.CDLL(_LIB_PATH)
        lib.flv_open.restype = ctypes.c_void_p
        lib.flv_open.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int]
        lib.flv_frame_count.restype = ctypes.c_int64
        lib.flv_frame_count.argtypes = [ctypes.c_void_p]
        lib.flv_next.restype = ctypes.POINTER(ctypes.c_uint8)
        lib.flv_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
        lib.flv_release.restype = None
        lib.flv_release.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8)]
        lib.flv_close.restype = None
        lib.flv_close.argtypes = [ctypes.c_void_p]
        lib.flv_last_error.restype = ctypes.c_char_p
        _lib = lib
    except Exception:
        _lib = None
    return _lib


def frame_shape_nv12(width: int, height: int) -> Tuple[int, int]:
    """NV12 buffer shape for a WxH stream (luma + half-res interleaved UV)."""
    return (height * 3 // 2, width)


def frame_shape_packed(width: int, height: int, channels: int = 3) -> Tuple[int, int]:
    """Packed frame shape — (H, W*C) rows of interleaved pixels, the
    framework's ingest layout: a raw row-major RGB frame IS this layout
    already (no host work; see ops.memory.ImageRead.packed_channels)."""
    return (height, width * channels)


class FrameLoader:
    """Iterate frames of a raw frame-sequence file with native prefetch.

    ``shape``/``dtype`` describe one frame's payload (e.g.
    ``frame_shape_nv12(w, h)`` + uint8 for NV12, ``(h, w, 3)`` + uint8 for
    packed RGB). Yields zero-copy numpy views of ring slots; each yielded
    frame's memory is recycled on the next iteration.
    """

    def __init__(self, path: str, shape, dtype=np.uint8, ring_depth: int = 4):
        self.path = path
        self.shape = tuple(int(s) for s in shape)
        self.dtype = np.dtype(dtype)
        self.frame_bytes = int(np.prod(self.shape)) * self.dtype.itemsize
        self.ring_depth = ring_depth
        self._lib = _load_native()
        self._handle = None
        self._pending = None
        if self._lib is not None:
            self._handle = self._lib.flv_open(
                path.encode(), self.frame_bytes, ring_depth
            )
            if not self._handle:
                raise OSError(self._lib.flv_last_error().decode())
            self.num_frames = int(self._lib.flv_frame_count(self._handle))
        else:  # pure-python fallback
            self._file = open(path, "rb")
            self._file.seek(0, 2)
            self.num_frames = self._file.tell() // self.frame_bytes
            self._file.seek(0)

    @property
    def native(self) -> bool:
        return self._handle is not None

    def __iter__(self) -> Iterator[np.ndarray]:
        return self

    def __next__(self) -> np.ndarray:
        if self._handle is not None:
            if self._pending is not None:
                self._lib.flv_release(self._handle, self._pending)
                self._pending = None
            idx = ctypes.c_int64()
            ptr = self._lib.flv_next(self._handle, ctypes.byref(idx))
            if not ptr:
                raise StopIteration
            self._pending = ptr
            arr = np.ctypeslib.as_array(ptr, shape=(self.frame_bytes,))
            return arr.view(self.dtype).reshape(self.shape)
        buf = self._file.read(self.frame_bytes)
        if len(buf) < self.frame_bytes:
            raise StopIteration
        return np.frombuffer(buf, self.dtype).reshape(self.shape)

    def close(self):
        if self._handle is not None:
            if self._pending is not None:
                self._lib.flv_release(self._handle, self._pending)
                self._pending = None
            self._lib.flv_close(self._handle)
            self._handle = None
        elif getattr(self, "_file", None):
            self._file.close()
            self._file = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
