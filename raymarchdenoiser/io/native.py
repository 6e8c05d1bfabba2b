"""ctypes bindings for the optional C++ runtime library (``native/``).

The reference implements its runtime (image conversion, device vectors, CPU
filter oracle) in C++ (``include/vector.h``, ``src/image.cpp``); this package's
equivalent keeps the host-side hot paths in C++ too:

* ``rdt_u8_to_planar_f32`` / ``rdt_planar_f32_to_u8`` — image layout+dtype
  conversion (host side of the H2D path; reference ``vector.h:142-163``).
* ``rdt_box_filter_u8`` — an independent C++ CPU implementation of the
  reference kernels' *semantics* (``src/filter.cu:13-158``), used as the
  golden oracle for parity tests.

Build: ``python native/build.py`` (or ``make -C native``).  Everything
degrades gracefully to numpy if the shared library is missing.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_LIB_PATHS = (
    os.path.join(os.path.dirname(__file__), "..", "..", "native", "librdt_native.so"),
    os.path.join(os.path.dirname(__file__), "librdt_native.so"),
)


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    for p in _LIB_PATHS:
        p = os.path.abspath(p)
        if os.path.exists(p):
            try:
                lib = ctypes.CDLL(p)
            except OSError:
                continue
            u8p = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
            f32p = np.ctypeslib.ndpointer(dtype=np.float32, flags="C_CONTIGUOUS")
            lib.rdt_u8_to_planar_f32.argtypes = [u8p, f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
            lib.rdt_planar_f32_to_u8.argtypes = [f32p, u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
            lib.rdt_box_filter_u8.argtypes = [
                u8p, u8p, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ]
            _LIB = lib
            break
    return _LIB


def available() -> bool:
    return _load() is not None


def u8_to_planar_f32(img: np.ndarray) -> np.ndarray:
    lib = _load()
    assert lib is not None
    h, w, c = img.shape
    out = np.empty((c, h, w), dtype=np.float32)
    lib.rdt_u8_to_planar_f32(img, out, h, w, c)
    return out


def planar_f32_to_u8(planes: np.ndarray) -> np.ndarray:
    lib = _load()
    assert lib is not None
    c, h, w = planes.shape
    out = np.empty((h, w, c), dtype=np.uint8)
    lib.rdt_planar_f32_to_u8(planes, out, h, w, c)
    return out


def box_filter_u8(img: np.ndarray, radius: int, depth: int, grayscale_quirk: bool) -> np.ndarray:
    """C++ oracle for the reference average filter semantics.

    ``grayscale_quirk=True`` reproduces ``filterKernelBaseline``'s write of
    ``acum.x`` into all three channels (reference src/filter.cu:50-53);
    ``False`` matches ``filterKernelTiled`` (src/filter.cu:151-155).
    """
    lib = _load()
    assert lib is not None
    h, w, c = img.shape
    assert c == 3, "oracle operates on RGB"
    out = np.empty_like(img)
    lib.rdt_box_filter_u8(img, out, h, w, radius, depth, 1 if grayscale_quirk else 0)
    return out
