"""ctypes binding of the native image-ops library (`native/image_ops.cc`).

The port's own copy of `invertible_cd_tpu/utils/native.py`. Exposes
`resize_crop_normalize(_batch)`, the data path's CPU image op (short-side
bicubic resize, centre crop, normalise) in threaded C++. The library is
built from `native/image_ops.cc` with g++ into `native/libicd_image_ops.so`
on first use when it is absent (the build goes to a temporary name first,
so a concurrent process never loads half a file); where it cannot be built,
every function returns None and `data/dataset.py` takes PIL instead.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import List, Optional

import numpy as np

FILTER_BILINEAR = 0
FILTER_BICUBIC = 1

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    root = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", "native"))
    path = os.path.join(root, "libicd_image_ops.so")
    src = os.path.join(root, "image_ops.cc")
    if not os.path.exists(path) and os.path.exists(src):
        tmp = f"{path}.{os.getpid()}.tmp"
        try:
            subprocess.run(["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
                            "-o", tmp, src], check=True, capture_output=True, timeout=120)
            os.replace(tmp, path)
        except (subprocess.SubprocessError, OSError):
            if os.path.exists(tmp):
                os.remove(tmp)
            return None
    if not os.path.exists(path):
        return None
    lib = ctypes.CDLL(path)
    lib.icd_native_version.restype = ctypes.c_int
    lib.icd_resize_crop_normalize.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_int,
    ]
    lib.icd_resize_crop_normalize_batch.argtypes = [
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
    ]
    _LIB = lib
    return lib


def available() -> bool:
    return _load() is not None


def resize_crop_normalize(image: np.ndarray, size: int, scale: float = 1.0 / 127.5,
                          offset: float = -1.0, filter: int = FILTER_BICUBIC
                          ) -> Optional[np.ndarray]:
    """uint8 (H, W, 3) -> float32 (size, size, 3); None without the library."""
    lib = _load()
    if lib is None:
        return None
    img = np.ascontiguousarray(image, np.uint8)
    h, w = img.shape[:2]
    out = np.empty((size, size, 3), np.float32)
    lib.icd_resize_crop_normalize(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), size,
        ctypes.c_float(scale), ctypes.c_float(offset), filter,
    )
    return out


def resize_crop_normalize_batch(images: List[np.ndarray], size: int, scale: float = 1.0 / 127.5,
                                offset: float = -1.0, filter: int = FILTER_BICUBIC,
                                num_threads: int = 0) -> Optional[np.ndarray]:
    """List of uint8 (H, W, 3) -> float32 (N, size, size, 3); None without
    the library."""
    lib = _load()
    if lib is None:
        return None
    imgs = [np.ascontiguousarray(im, np.uint8) for im in images]
    n = len(imgs)
    ptrs = (ctypes.POINTER(ctypes.c_uint8) * n)(
        *[im.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)) for im in imgs])
    shapes = np.asarray([[im.shape[0], im.shape[1]] for im in imgs], np.int32)
    out = np.empty((n, size, size, 3), np.float32)
    lib.icd_resize_crop_normalize_batch(
        ptrs, shapes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), size,
        ctypes.c_float(scale), ctypes.c_float(offset), filter, num_threads,
    )
    return out
