"""ctypes bindings for the native (C++) binned-SAH BVH builder.

Loads build/libbvh.so, building it from native/ with make on first use;
falls back to the NumPy median-split builder in models/mesh.py (with one
warning line saying why) when that fails. Both emit the identical
threaded-DFS array contract, so call sites are oblivious
(models/mesh.build_bvh dispatches here).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np

_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_ROOT, "native")
_LIB_PATH = os.path.join(_ROOT, "build", "libbvh.so")

_lib = None
_load_failed = False


def _build() -> None:
    # build under a private name, then rename: concurrent first uses
    # (parallel test workers) never load a half-written library
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    subprocess.run(["make", "-C", _NATIVE_DIR, "-s", f"OUT={tmp}"],
                   check=True, capture_output=True, timeout=120)
    os.replace(tmp, _LIB_PATH)


def _load():
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    try:
        if not os.path.exists(_LIB_PATH):
            _build()
        lib = ctypes.CDLL(_LIB_PATH)
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.bvh_build.argtypes = [
            f32p, f32p, f32p, ctypes.c_int, ctypes.c_int,
            i32p, f32p, f32p, i32p, i32p, i32p, ctypes.c_int,
        ]
        lib.bvh_build.restype = ctypes.c_int
        _lib = lib
    except Exception as e:  # no toolchain, build error, unloadable library
        _load_failed = True
        print(f"pathtracer: native BVH builder unavailable ({e!r}); "
              "using the NumPy builder", file=sys.stderr)
    return _lib


def available() -> bool:
    return _load() is not None


def build_arrays(
    tri_min: np.ndarray,  # (T, 3) float
    tri_max: np.ndarray,
    centroid: np.ndarray,
    leaf_size: int,
):
    """Run the native builder. Returns (order, node_min, node_max,
    node_skip, node_start, node_count) or None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    T = tri_min.shape[0]
    max_nodes = 2 * T + 16
    tri_min = np.ascontiguousarray(tri_min, np.float32)
    tri_max = np.ascontiguousarray(tri_max, np.float32)
    centroid = np.ascontiguousarray(centroid, np.float32)
    order = np.empty((T,), np.int32)
    node_min = np.empty((max_nodes, 3), np.float32)
    node_max = np.empty((max_nodes, 3), np.float32)
    node_skip = np.empty((max_nodes,), np.int32)
    node_start = np.empty((max_nodes,), np.int32)
    node_count = np.empty((max_nodes,), np.int32)
    m = lib.bvh_build(
        tri_min, tri_max, centroid, T, leaf_size,
        order, node_min, node_max, node_skip, node_start, node_count,
        max_nodes,
    )
    if m < 0:
        return None
    return (
        order,
        node_min[:m].copy(),
        node_max[:m].copy(),
        node_skip[:m].copy(),
        node_start[:m].copy(),
        node_count[:m].copy(),
    )
