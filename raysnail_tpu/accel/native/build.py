"""ctypes loader for the native BVH builder. The shared object is never
committed: it is compiled from bvh_builder.cpp with g++ at first use,
whenever it is missing or older than the source, next to the source (a path
.gitignore lists). Falls back to the numpy builder (accel/bvh.py) when
compilation is unavailable."""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "bvh_builder.cpp")
_SO = os.path.join(_HERE, "libraysnail_bvh.so")
_lock = threading.Lock()
_lib = None
_failed = False


def _load():
    global _lib, _failed
    with _lock:
        if _lib is not None or _failed:
            return _lib
        try:
            if (not os.path.exists(_SO)) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
                subprocess.run(
                    ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", _SO],
                    check=True, capture_output=True, timeout=120,
                )
            lib = ctypes.CDLL(_SO)
            lib.raysnail_build_bvh.restype = ctypes.c_int
            lib.raysnail_build_bvh.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
                ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
            ]
            _lib = lib
        except Exception:
            _failed = True
            _lib = None
        return _lib


def build_bvh_native(prim_bb_min, prim_bb_max, leaf_size: int):
    """-> BvhArrays or None if the native builder is unavailable/failed."""
    from raysnail_tpu.accel.bvh import BvhArrays

    lib = _load()
    if lib is None:
        return None

    pmin = np.ascontiguousarray(prim_bb_min, np.float32)
    pmax = np.ascontiguousarray(prim_bb_max, np.float32)
    n = pmin.shape[0]
    max_nodes = 2 * n + 2
    max_prims = (n + max_nodes) * leaf_size  # worst case padding per leaf

    bb_min = np.empty((max_nodes, 3), np.float32)
    bb_max = np.empty((max_nodes, 3), np.float32)
    first = np.empty(max_nodes, np.int32)
    count = np.empty(max_nodes, np.int32)
    miss = np.empty(max_nodes, np.int32)
    prim_order = np.empty(max_prims, np.int32)
    sizes = np.zeros(2, np.int32)

    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int)
    rc = lib.raysnail_build_bvh(
        pmin.ctypes.data_as(fp), pmax.ctypes.data_as(fp),
        ctypes.c_int(n), ctypes.c_int(leaf_size),
        bb_min.ctypes.data_as(fp), bb_max.ctypes.data_as(fp),
        first.ctypes.data_as(ip), count.ctypes.data_as(ip),
        miss.ctypes.data_as(ip), prim_order.ctypes.data_as(ip),
        ctypes.c_int(max_nodes), ctypes.c_int(max_prims),
        sizes.ctypes.data_as(ip),
    )
    if rc != 0:
        return None
    m, p = int(sizes[0]), int(sizes[1])
    # miss links point at m (the node count) as END — consistent already
    return BvhArrays(
        bb_min=bb_min[:m].copy(), bb_max=bb_max[:m].copy(),
        first=first[:m].copy(), count=count[:m].copy(), miss=miss[:m].copy(),
        prim_order=prim_order[:p].copy(),
    )
