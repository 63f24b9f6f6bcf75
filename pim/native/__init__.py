"""Native (C++) host-runtime components, bound via ctypes.

The reference's runtime is native C (allocator/task pool/Embree build —
SURVEY.md §2.1/§2.6); the device side is XLA's and the traversal kernel's, but host-side hot
loops still deserve native code.  Currently: the binned-SAH BVH builder
(bvh_builder.cpp), which replaces Embree's RTC_BUILD_QUALITY_HIGH scene
commit (ref: src/rendering/path_tracer.c:618-690).

The shared library is compiled on demand with g++ and cached next to the
source; if no toolchain is available the callers fall back to the numpy
builder (pim/geom/bvh.py), which has identical output semantics.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "bvh_builder.cpp")
_LIB = os.path.join(_HERE, "libpim_native.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def _compile() -> bool:
    cmd = [
        "g++", "-O3", "-std=c++17", "-fPIC", "-shared",
        "-march=native", "-o", _LIB, _SRC,
    ]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired):
        return False
    return res.returncode == 0 and os.path.exists(_LIB)


def load() -> Optional[ctypes.CDLL]:
    """Returns the native library, compiling it on first use; None if the
    toolchain or compile is unavailable (callers must fall back)."""
    global _lib, _load_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _load_failed:
            return None
        if not os.path.exists(_LIB) or (
            os.path.exists(_SRC)
            and os.path.getmtime(_SRC) > os.path.getmtime(_LIB)
        ):
            if not _compile():
                _load_failed = True
                return None
        try:
            lib = ctypes.CDLL(_LIB)
        except OSError:
            _load_failed = True
            return None
        lib.pim_bvh_build.restype = ctypes.c_void_p
        lib.pim_bvh_build.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int,
        ]
        lib.pim_bvh_counts.restype = None
        lib.pim_bvh_counts.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ]
        lib.pim_bvh_export.restype = None
        lib.pim_bvh_export.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.pim_bvh_free.restype = None
        lib.pim_bvh_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def build_bvh_native(positions, max_leaf: int = 4):
    """Binned-SAH build in C++; returns BvhArrays or None if unavailable.

    positions: [V, 3] float32 flat triangle soup (V = 3*T)."""
    import numpy as np

    from pim.geom.bvh import BvhArrays

    lib = load()
    if lib is None:
        return None
    v = np.ascontiguousarray(positions, np.float32)
    tri_count = v.shape[0] // 3
    handle = lib.pim_bvh_build(
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(tri_count), ctypes.c_int(max_leaf),
    )
    try:
        nn = ctypes.c_int64()
        nt = ctypes.c_int64()
        lib.pim_bvh_counts(handle, ctypes.byref(nn), ctypes.byref(nt))
        node_lo = np.empty((nn.value, 3), np.float32)
        node_hi = np.empty((nn.value, 3), np.float32)
        node_a = np.empty(nn.value, np.int32)
        node_b = np.empty(nn.value, np.int32)
        tri_order = np.empty(nt.value, np.int32)
        lib.pim_bvh_export(
            handle,
            node_lo.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            node_hi.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            node_a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            node_b.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            tri_order.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
    finally:
        lib.pim_bvh_free(handle)
    return BvhArrays(node_lo, node_hi, node_a, node_b, tri_order)
