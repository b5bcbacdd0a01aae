"""Native C++ runtime bindings (ctypes): the host's fast paths.

physim_runtime.cc (a copy of the JAX package's runtime source) is compiled
with g++ on first use into build/runtime/ at the repository root, under a
name keyed by a hash of the source and the flags, as _build.py keys the CUDA
kernels: an edited source rebuilds, an unchanged one is reused, and nothing
is written beside the source. It offers PLY/OBJ mesh loading and the O(N^2)
PPF table build. Every entry point has the pure-Python path as its fallback
(models/assets.py, ops/ppf.py), which the callers take when the library
cannot be built; the native path is preferred when it is. Each entry point
counts its native calls in its `calls` attribute, as the kernel wrappers
count their launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "physim_runtime.cc"
BUILD_DIR = SOURCE.parent.parent.parent / "build" / "runtime"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None
_build_failed = False
# The g++ messages of a failed build (empty when the library built or loaded).
BUILD_LOG = ""


class _MeshOut(ctypes.Structure):
    _fields_ = [
        ("vertices", ctypes.POINTER(ctypes.c_float)),
        ("faces", ctypes.POINTER(ctypes.c_int32)),
        ("n_vertices", ctypes.c_int64),
        ("n_faces", ctypes.c_int64),
    ]


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libphysim_runtime_{digest}.so"


def _build(lib: Path) -> bool:
    global BUILD_LOG
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    try:
        done = subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                              capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as exc:
        BUILD_LOG = repr(exc)
        return False
    if done.returncode != 0:
        BUILD_LOG = done.stderr
        return False
    os.replace(tmp, lib)
    return True


def get_lib():
    """The loaded native library, or None if it cannot be built or loaded."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        path = library_path()
        if not path.exists() and not _build(path):
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            _build_failed = True
            return None
        lib.physim_load_ply.argtypes = [ctypes.c_char_p, ctypes.POINTER(_MeshOut)]
        lib.physim_load_ply.restype = ctypes.c_int
        lib.physim_load_obj.argtypes = [ctypes.c_char_p, ctypes.POINTER(_MeshOut)]
        lib.physim_load_obj.restype = ctypes.c_int
        lib.physim_free.argtypes = [ctypes.c_void_p]
        lib.physim_free.restype = None
        lib.physim_build_ppf.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ]
        lib.physim_build_ppf.restype = ctypes.c_int
        _lib = lib
        return _lib


def load_mesh_native(path: str):
    """Load a PLY/OBJ mesh natively. Returns (vertices, faces) or None."""
    lib = get_lib()
    if lib is None:
        return None
    out = _MeshOut()
    fn = lib.physim_load_obj if path.endswith(".obj") else lib.physim_load_ply
    rc = fn(path.encode(), ctypes.byref(out))
    if rc != 0 or out.n_vertices == 0:
        if out.vertices:
            lib.physim_free(out.vertices)
        if out.faces:
            lib.physim_free(out.faces)
        return None
    verts = np.ctypeslib.as_array(out.vertices, shape=(out.n_vertices, 3)).copy()
    if out.n_faces:
        faces = np.ctypeslib.as_array(out.faces, shape=(out.n_faces, 3)).copy()
    else:
        faces = np.zeros((0, 3), np.int32)
    lib.physim_free(out.vertices)
    lib.physim_free(out.faces)
    load_mesh_native.calls += 1
    return verts.astype(np.float32), faces.astype(np.int32)


load_mesh_native.calls = 0


def build_ppf_native(
    pts: np.ndarray, nrm: np.ndarray, trans_disc: int, rot_disc: int, max_dist_mm: int
):
    """Native CSR PPF build. Returns (offsets, counts, pairs) or None."""
    lib = get_lib()
    if lib is None:
        return None
    pts = np.ascontiguousarray(pts, np.float32)
    nrm = np.ascontiguousarray(nrm, np.float32)
    if pts.ndim != 2 or pts.shape[1] != 3 or nrm.shape != pts.shape:
        raise ValueError(f"points {pts.shape} and normals {nrm.shape} must both be [N, 3]")
    offsets_p = ctypes.POINTER(ctypes.c_int32)()
    counts_p = ctypes.POINTER(ctypes.c_int32)()
    pairs_p = ctypes.POINTER(ctypes.c_int32)()
    n_bins = ctypes.c_int64()
    total = ctypes.c_int64()
    rc = lib.physim_build_ppf(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        nrm.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(pts), trans_disc, rot_disc, max_dist_mm,
        ctypes.byref(offsets_p), ctypes.byref(counts_p), ctypes.byref(pairs_p),
        ctypes.byref(n_bins), ctypes.byref(total),
    )
    if rc != 0:
        return None
    nb, tot = n_bins.value, total.value
    offsets = np.ctypeslib.as_array(offsets_p, shape=(nb,)).copy()
    counts = np.ctypeslib.as_array(counts_p, shape=(nb,)).copy()
    pairs = np.ctypeslib.as_array(pairs_p, shape=(max(tot, 1), 2))[:tot].copy()
    lib.physim_free(offsets_p)
    lib.physim_free(counts_p)
    lib.physim_free(pairs_p)
    build_ppf_native.calls += 1
    return offsets, counts, pairs


build_ppf_native.calls = 0
