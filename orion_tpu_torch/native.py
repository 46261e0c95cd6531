"""ctypes bindings for the native host-runtime sources (native/*.cpp).

The port's own loader: `native/bvh_builder.cpp` and `native/obj_loader.cpp`
(the repo's C++ BVH builder and OBJ tokenizer, shared with the JAX package
as sources, never as a binary) are compiled with g++ at first use into
`orion_tpu_torch/_build/`, under a name that carries a hash of the sources
and flags, and loaded through ctypes. Where g++ or the sources are missing
or the build fails, `get_lib()` is None and callers use the NumPy / Python
implementations with the same semantics.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

from orion_tpu_torch.profiling import count, span

_PKG = Path(__file__).resolve().parent
_NATIVE_DIR = _PKG.parent / "native"
_BUILD_DIR = _PKG / "_build"
_SRCS = ("bvh_builder.cpp", "obj_loader.cpp")
# portable baseline (no -march=native), as native/Makefile builds it
_CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")

_lib = None
_load_attempted = False


def _lib_path() -> Optional[Path]:
    """The library's path, named by a hash of sources and flags; None when
    a source is missing."""
    h = hashlib.sha256(" ".join(_CXXFLAGS).encode())
    for name in _SRCS:
        p = _NATIVE_DIR / name
        if not p.exists():
            return None
        h.update(p.read_bytes())
    return _BUILD_DIR / f"orion_native-{h.hexdigest()[:12]}.so"


def _try_build(out: Path) -> bool:
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        return False
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        with span("kernel.build"):
            subprocess.run([cxx, *_CXXFLAGS, "-o", str(tmp),
                            *(str(_NATIVE_DIR / s) for s in _SRCS)],
                           check=True, capture_output=True, timeout=300)
        os.replace(tmp, out)
    except Exception:
        return False
    count("kernel.built")
    return True


def get_lib(build: bool = True) -> Optional[ctypes.CDLL]:
    """Load (building it first when needed) the native library, or None."""
    global _lib, _load_attempted
    if _lib is not None:
        return _lib
    if _load_attempted:
        return None
    _load_attempted = True
    path = _lib_path()
    if path is None:
        return None
    if not path.exists() and not (build and _try_build(path)):
        return None
    try:
        with span("kernel.load"):
            lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    count("kernel.loaded")

    c_i64 = ctypes.c_int64
    c_i32 = ctypes.c_int32
    c_p = ctypes.c_void_p
    f32_p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32_p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64_p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    u8_p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")

    lib.orion_bvh_build.restype = c_p
    lib.orion_bvh_build.argtypes = [
        f32_p, f32_p, f32_p, u8_p, c_i64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, f32_p, ctypes.POINTER(c_i64), ctypes.POINTER(c_i64),
        ctypes.POINTER(c_i32), ctypes.POINTER(c_i64)]
    lib.orion_bvh_export.restype = None
    lib.orion_bvh_export.argtypes = [c_p, f32_p, f32_p, i32_p, i32_p,
                                     i32_p, i64_p]
    lib.orion_bvh_free.restype = None
    lib.orion_bvh_free.argtypes = [c_p]

    lib.orion_obj_load.restype = c_p
    lib.orion_obj_load.argtypes = [ctypes.c_char_p, ctypes.POINTER(c_i64),
                                   ctypes.POINTER(c_i64)]
    lib.orion_obj_mesh_tris.restype = c_i64
    lib.orion_obj_mesh_tris.argtypes = [c_p, c_i64]
    for fn in ("orion_obj_mesh_name", "orion_obj_mesh_material",
               "orion_obj_mtllib"):
        getattr(lib, fn).restype = ctypes.c_char_p
    lib.orion_obj_mesh_name.argtypes = [c_p, c_i64]
    lib.orion_obj_mesh_material.argtypes = [c_p, c_i64]
    lib.orion_obj_mtllib.argtypes = [c_p, c_i64]
    lib.orion_obj_mesh_data.restype = None
    lib.orion_obj_mesh_data.argtypes = [c_p, c_i64, f32_p, f32_p, f32_p]
    lib.orion_obj_free.restype = None
    lib.orion_obj_free.argtypes = [c_p]

    _lib = lib
    return _lib


def native_available() -> bool:
    return get_lib() is not None


STRATEGY_CODES = {"median": 0, "middle": 1, "sah": 2}


def bvh_build_native(tri_v0: np.ndarray, tri_e1: np.ndarray,
                     tri_e2: np.ndarray, valid: np.ndarray, *,
                     strategy: str, leaf_size: int, leaf_width: int,
                     order_signs=(1.0, 1.0, 1.0)):
    """Run the C++ builder; returns the flat arrays (see accel/bvh.py
    schema) or None when the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None

    v0 = np.ascontiguousarray(tri_v0, np.float32)
    e1 = np.ascontiguousarray(tri_e1, np.float32)
    e2 = np.ascontiguousarray(tri_e2, np.float32)
    vd = np.ascontiguousarray(valid, np.uint8)
    T = v0.shape[0]

    n_nodes = ctypes.c_int64()
    n_bundled = ctypes.c_int64()
    max_depth = ctypes.c_int32()
    leaves = ctypes.c_int64()
    signs = np.ascontiguousarray(order_signs, np.float32)
    h = lib.orion_bvh_build(v0, e1, e2, vd, T,
                            STRATEGY_CODES[strategy], leaf_size, leaf_width,
                            signs,
                            ctypes.byref(n_nodes), ctypes.byref(n_bundled),
                            ctypes.byref(max_depth), ctypes.byref(leaves))
    if not h:
        raise ValueError("native BVH build failed (no valid triangles?)")
    try:
        M, B = n_nodes.value, n_bundled.value
        node_lo = np.empty((M, 3), np.float32)
        node_hi = np.empty((M, 3), np.float32)
        node_skip = np.empty(M, np.int32)
        node_start = np.empty(M, np.int32)
        node_count = np.empty(M, np.int32)
        order = np.empty(B, np.int64)
        lib.orion_bvh_export(h, node_lo, node_hi, node_skip, node_start,
                             node_count, order)
    finally:
        lib.orion_bvh_free(h)
    return (node_lo, node_hi, node_skip, node_start, node_count, order,
            max_depth.value, leaves.value)


def obj_load_native(path):
    """Run the C++ OBJ parser; returns (meshes, mtllibs) where meshes are
    (name, material_name, pos[F,3,3], nrm[F,3,3], uv[F,3,2]) tuples, or
    None when the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n_meshes = ctypes.c_int64()
    n_libs = ctypes.c_int64()
    h = lib.orion_obj_load(str(path).encode(), ctypes.byref(n_meshes),
                           ctypes.byref(n_libs))
    if not h:
        raise FileNotFoundError(path)
    try:
        mtllibs = [lib.orion_obj_mtllib(h, i).decode("utf-8", "replace")
                   for i in range(n_libs.value)]
        meshes = []
        for m in range(n_meshes.value):
            F = lib.orion_obj_mesh_tris(h, m)
            pos = np.empty((F, 3, 3), np.float32)
            nrm = np.empty((F, 3, 3), np.float32)
            uv = np.empty((F, 3, 2), np.float32)
            lib.orion_obj_mesh_data(h, m, pos, nrm, uv)
            meshes.append((
                lib.orion_obj_mesh_name(h, m).decode("utf-8", "replace"),
                lib.orion_obj_mesh_material(h, m).decode("utf-8", "replace"),
                pos, nrm, uv))
    finally:
        lib.orion_obj_free(h)
    return meshes, mtllibs
