"""ctypes bindings for the native geometry runtime (native/libtacex_geom.so).

The C++ library provides the host-side scene-build operations (tet meshing,
boundary extraction, lumped masses, barycentric binding — see
native/tacex_geom.cpp). It is built from that source on first use (or with
``make -C native``); every entry point has a numpy fallback in
physics/soft/mesh.py, so the framework works where no C++ compiler is
installed. ``available()`` reports which path is active.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parents[1] / "native"
_SRC_PATH = _NATIVE_DIR / "tacex_geom.cpp"
_LIB_PATH = _NATIVE_DIR / "libtacex_geom.so"
_CXXFLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17", "-Wall")  # as native/Makefile
_lib = None


def build() -> bool:
    """Compile the library from source unless an up-to-date one exists.

    Returns whether the library exists afterwards (False when no C++
    compiler is installed). Concurrent callers each compile into a temp
    file and rename it into place, so none loads a half-written library.
    """
    if _LIB_PATH.exists() and _LIB_PATH.stat().st_mtime >= _SRC_PATH.stat().st_mtime:
        return True
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        return False
    fd, tmp = tempfile.mkstemp(dir=_NATIVE_DIR, prefix=".libtacex_geom.", suffix=".so")
    os.close(fd)
    try:
        subprocess.run([cxx, *_CXXFLAGS, "-o", tmp, str(_SRC_PATH)], check=True, capture_output=True)
        os.replace(tmp, _LIB_PATH)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return True


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not build():
        return None
    lib = ctypes.CDLL(str(_LIB_PATH))
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.box_tet_mesh.argtypes = [ctypes.c_int] * 3 + [ctypes.c_float] * 6 + [f32p, i32p]
    lib.box_tet_mesh.restype = ctypes.c_int
    lib.extract_surface.argtypes = [i32p, ctypes.c_int, f32p, ctypes.c_int, i32p]
    lib.extract_surface.restype = ctypes.c_int
    lib.lumped_masses.argtypes = [i32p, ctypes.c_int, f32p, ctypes.c_int, ctypes.c_float, f32p]
    lib.lumped_masses.restype = ctypes.c_int
    lib.barycentric_bind.argtypes = [
        f32p, ctypes.c_int, f32p, ctypes.c_int, i32p, ctypes.c_int, i32p, f32p,
    ]
    lib.barycentric_bind.restype = ctypes.c_int
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _ip(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def box_tet_mesh(resolution, size, center) -> tuple[np.ndarray, np.ndarray]:
    lib = _load()
    nx, ny, nz = resolution
    n_pts = (nx + 1) * (ny + 1) * (nz + 1)
    n_tets = nx * ny * nz * 6
    points = np.empty((n_pts, 3), np.float32)
    tets = np.empty((n_tets, 4), np.int32)
    rc = lib.box_tet_mesh(
        nx, ny, nz, float(size[0]), float(size[1]), float(size[2]),
        float(center[0]), float(center[1]), float(center[2]), _fp(points), _ip(tets),
    )
    assert rc == 0
    return points, tets


def extract_surface(tets: np.ndarray, points: np.ndarray) -> np.ndarray:
    lib = _load()
    tets = np.ascontiguousarray(tets, np.int32)
    points = np.ascontiguousarray(points, np.float32)
    out = np.empty((len(tets) * 4, 3), np.int32)
    n = lib.extract_surface(_ip(tets), len(tets), _fp(points), len(points), _ip(out))
    return out[:n].copy()


def lumped_masses(tets: np.ndarray, points: np.ndarray, density: float) -> np.ndarray:
    lib = _load()
    tets = np.ascontiguousarray(tets, np.int32)
    points = np.ascontiguousarray(points, np.float32)
    out = np.empty((len(points),), np.float32)
    lib.lumped_masses(_ip(tets), len(tets), _fp(points), len(points), float(density), _fp(out))
    return out


def barycentric_bind(
    markers_xy: np.ndarray, points: np.ndarray, tris: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    lib = _load()
    markers_xy = np.ascontiguousarray(markers_xy, np.float32)
    points = np.ascontiguousarray(points, np.float32)
    tris = np.ascontiguousarray(tris, np.int32)
    tri_idx = np.empty((len(markers_xy),), np.int32)
    weights = np.empty((len(markers_xy), 3), np.float32)
    lib.barycentric_bind(
        _fp(markers_xy), len(markers_xy), _fp(points), len(points), _ip(tris), len(tris),
        _ip(tri_idx), _fp(weights),
    )
    return tri_idx, weights
