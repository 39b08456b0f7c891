"""ctypes bindings for the native data-prep library (native/pdnative.cpp)
(``planedepth_tpu/data/native.py``, the two entry points the reader uses).

The library is the repository's ``native/libpdnative.so``, loaded where it
lies; nothing here builds or moves it (``python scripts/build_native.py``
builds it).  :func:`resize_bicubic_native` (``data/transforms.py``) and
:func:`velodyne_to_depth_native` (``data/kitti_utils.py``) return None when
the library is missing or does not load, and their callers then take their
numpy fallbacks, which have the same semantics.  :func:`available` says
which one runs.
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_F32 = np.ctypeslib.ndpointer(dtype=np.float32, flags="C_CONTIGUOUS")
_F64 = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), "native", "libpdnative.so",
    )
    if not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
        lib.pd_resize_bicubic.argtypes = [
            _F32, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            _F32, ctypes.c_int, ctypes.c_int,
        ]
        lib.pd_velodyne_to_depth.argtypes = [
            _F32, ctypes.c_int, _F64, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, _F32,
        ]
        lib.pd_version.restype = ctypes.c_int
        assert lib.pd_version() == 1
        _LIB = lib
    except Exception:
        _LIB = None
    return _LIB


def available() -> bool:
    return _load() is not None


def resize_bicubic_native(img: np.ndarray, out_hw) -> Optional[np.ndarray]:
    """Native bicubic align_corners=True resize; None if lib missing."""
    lib = _load()
    if lib is None:
        return None
    img = np.ascontiguousarray(img, dtype=np.float32)
    h, w, c = img.shape
    ho, wo = out_hw
    out = np.empty((ho, wo, c), np.float32)
    lib.pd_resize_bicubic(img, h, w, c, out, ho, wo)
    return out


def velodyne_to_depth_native(
    points: np.ndarray, P: np.ndarray, h: int, w: int,
    use_x_as_depth: bool = False,
) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    pts = np.ascontiguousarray(points, dtype=np.float32)
    P = np.ascontiguousarray(P[:3, :4], dtype=np.float64)
    out = np.empty((h, w), np.float32)
    lib.pd_velodyne_to_depth(pts, pts.shape[0], P, h, w,
                             int(use_x_as_depth), out)
    return out
