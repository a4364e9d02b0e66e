"""ctypes bindings for the native C++ prefetching data loader.

The compute path is JAX; the IO runtime around it is native C++
(native/dataloader.cpp): image decode (PNG/JPEG/PGM) + rectification remap +
bounded prefetch queue on background threads, mirroring the role of the
reference's cv::imread + rectifyImagesLR main-thread path
(plslam_mod.cpp:330-354) but off the critical path.

Builds the shared library from source on first use in a process (``make``
in native/, a no-op when the library is up to date). There is no fallback:
without a C++ toolchain and libpng/libjpeg, ``get_lib`` returns None and the
loader raises.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Sequence

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libgfpl_dataloader.so")

_lib = None


def _build() -> bool:
    try:
        subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                       capture_output=True, timeout=120)
        return os.path.exists(_LIB_PATH)
    except Exception:
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    if not _build():
        return None
    lib = ctypes.CDLL(_LIB_PATH)
    lib.loader_create.restype = ctypes.c_void_p
    lib.loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.loader_next.restype = ctypes.c_int
    lib.loader_next.argtypes = [ctypes.c_void_p,
                                ctypes.POINTER(ctypes.c_float),
                                ctypes.POINTER(ctypes.c_float)]
    lib.loader_destroy.argtypes = [ctypes.c_void_p]
    lib.decode_image.restype = ctypes.c_int
    lib.decode_image.argtypes = [ctypes.c_char_p,
                                 ctypes.POINTER(ctypes.c_float),
                                 ctypes.c_int, ctypes.c_int,
                                 ctypes.POINTER(ctypes.c_int),
                                 ctypes.POINTER(ctypes.c_int)]
    _lib = lib
    return _lib


def native_available() -> bool:
    return get_lib() is not None


def decode_image(path: str, max_w: int = 4096, max_h: int = 4096
                 ) -> np.ndarray:
    """Decode one image via the native library -> float32 [H, W]."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native loader unavailable")
    buf = np.empty(max_w * max_h, np.float32)
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.decode_image(path.encode(), buf.ctypes.data_as(
        ctypes.POINTER(ctypes.c_float)), max_w, max_h,
        ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise IOError(f"decode failed ({rc}): {path}")
    return buf[:w.value * h.value].reshape(h.value, w.value).copy()


class StereoLoader:
    """Prefetching rectified-stereo-sequence iterator."""

    def __init__(self, paths_l: Sequence[str], paths_r: Sequence[str],
                 out_w: int, out_h: int,
                 maps: Optional[tuple[np.ndarray, np.ndarray, np.ndarray,
                                      np.ndarray]] = None,
                 n_threads: int = 2, queue_depth: int = 4):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native loader unavailable")
        self._lib = lib
        self._n = len(paths_l)
        self._w, self._h = out_w, out_h
        arr_l = (ctypes.c_char_p * self._n)(*[p.encode() for p in paths_l])
        arr_r = (ctypes.c_char_p * self._n)(*[p.encode() for p in paths_r])
        self._keep = (arr_l, arr_r)
        fp = ctypes.POINTER(ctypes.c_float)
        if maps is not None:
            ms = [np.ascontiguousarray(m, np.float32) for m in maps]
            self._maps = ms
            mp = [m.ctypes.data_as(fp) for m in ms]
        else:
            self._maps = None
            mp = [ctypes.cast(None, fp)] * 4
        self._h_ptr = lib.loader_create(arr_l, arr_r, self._n, *mp,
                                        out_w, out_h, n_threads, queue_depth)

    def __iter__(self):
        return self

    def __next__(self):
        out_l = np.empty((self._h, self._w), np.float32)
        out_r = np.empty((self._h, self._w), np.float32)
        fp = ctypes.POINTER(ctypes.c_float)
        rc = self._lib.loader_next(self._h_ptr,
                                   out_l.ctypes.data_as(fp),
                                   out_r.ctypes.data_as(fp))
        if rc == -1:
            raise StopIteration
        if rc == -2:
            raise IOError("frame decode failed")
        return rc, out_l, out_r

    def close(self):
        if self._h_ptr:
            self._lib.loader_destroy(self._h_ptr)
            self._h_ptr = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
