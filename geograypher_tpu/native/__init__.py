"""Native host-side runtime (C++ via ctypes).

Provides the fast PLY loader and the int32 RLE codec used by the pix2face
disk cache.  The library is compiled on demand with the local toolchain
(`make` in this directory); every consumer has a pure-Python fallback, so
a missing compiler degrades performance, never correctness.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_HERE = Path(__file__).parent
_LIB_PATH = _HERE / "libfastnative.so"
_lib = None
_build_attempted = False


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if necessary) the native library; None on failure."""
    global _lib, _build_attempted
    if _lib is not None:
        return _lib
    if not _LIB_PATH.exists() and not _build_attempted:
        _build_attempted = True
        try:
            subprocess.run(
                ["make", "-s"], cwd=_HERE, check=True, capture_output=True
            )
        except Exception:
            return None
    if not _LIB_PATH.exists():
        return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError:
        return None
    lib.rle_encode_i32.restype = ctypes.c_int64
    lib.rle_encode_i32.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.rle_decode_i32.restype = ctypes.c_int64
    lib.rle_decode_i32.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.ply_open.restype = ctypes.c_int
    lib.ply_open.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.ply_read.restype = ctypes.c_int64
    lib.ply_read.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64,
    ]
    lib.ply_close.restype = None
    lib.ply_close.argtypes = [ctypes.c_int]
    if hasattr(lib, "class_counts_i32"):
        lib.class_counts_i32.restype = None
        lib.class_counts_i32.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p, ctypes.c_int32,
        ]
    _lib = lib
    return _lib


def class_counts_host(
    pix2face: np.ndarray,
    labels: np.ndarray,
    n_faces: int,
    n_classes: int,
    n_threads: int = 0,
) -> Optional[np.ndarray]:
    """Threaded host-side per-face class-count scatter.

    Each thread owns a face-id RANGE and scans all pixels (no atomics), so
    speedup requires real cores: ~217 ms single-core for an 8M-pixel view
    — for flows where the pix2face map is already host-resident (cache hits,
    post-processing).  ``n_threads=0`` uses the machine's core count.
    Returns (n_faces, n_classes) int32, or None without the native lib.
    """
    import os

    if n_threads <= 0:
        n_threads = os.cpu_count() or 1
    n_threads = min(n_threads, os.cpu_count() or 1)
    lib = get_lib()
    if lib is None or not hasattr(lib, "class_counts_i32"):
        return None
    p2f = np.ascontiguousarray(pix2face, dtype=np.int32).reshape(-1)
    lab = np.ascontiguousarray(labels, dtype=np.int32).reshape(-1)
    if p2f.size != lab.size:
        raise ValueError("pix2face and labels must have equal sizes")
    out = np.zeros((n_faces, n_classes), dtype=np.int32)
    lib.class_counts_i32(
        p2f.ctypes.data, lab.ctypes.data, p2f.size,
        n_faces, n_classes, out.ctypes.data, int(n_threads),
    )
    return out


def rle_encode(arr: np.ndarray) -> Optional[bytes]:
    """RLE-encode an int32 array; None if the native lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    arr = np.ascontiguousarray(arr, dtype=np.int32).reshape(-1)
    out = np.empty(arr.size * 8 + 16, dtype=np.uint8)
    n = lib.rle_encode_i32(
        arr.ctypes.data, arr.size, out.ctypes.data, out.size
    )
    if n < 0:
        return None
    return out[:n].tobytes()


def rle_decode(enc: bytes, n_elements: int) -> Optional[np.ndarray]:
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty(n_elements, dtype=np.int32)
    buf = np.frombuffer(enc, dtype=np.uint8)
    n = lib.rle_decode_i32(
        buf.ctypes.data, buf.size, out.ctypes.data, out.size
    )
    if n != n_elements:
        return None
    return out


class fastply:
    """Namespace for the native PLY fast path (see utils/meshio.py)."""

    @staticmethod
    def load_ply(path: str):
        lib = get_lib()
        if lib is None:
            return None
        n_verts = ctypes.c_int64()
        n_faces = ctypes.c_int64()
        has_rgb = ctypes.c_int()
        xyz_is_double = ctypes.c_int()
        handle = lib.ply_open(
            path.encode(),
            ctypes.byref(n_verts),
            ctypes.byref(n_faces),
            ctypes.byref(has_rgb),
            ctypes.byref(xyz_is_double),
        )
        if handle < 0:
            return None
        try:
            verts = np.empty((n_verts.value, 3), dtype=np.float64)
            rgb = (
                np.empty((n_verts.value, 3), dtype=np.uint8)
                if has_rgb.value
                else None
            )
            # fan triangulation of an n-gon yields n-2 tris; polygons are
            # quads at most in practice — allocate 4x and retry bigger if
            # the native side reports overflow
            cap = max(n_faces.value * 4, 16)
            tris = np.empty((cap, 3), dtype=np.int32)
            n_tris = lib.ply_read(
                handle,
                verts.ctypes.data,
                rgb.ctypes.data if rgb is not None else None,
                tris.ctypes.data,
                cap,
            )
            if n_tris < 0:
                return None
            attrs = {}
            if rgb is not None:
                attrs["colors"] = rgb
            return verts, np.ascontiguousarray(tris[:n_tris]), attrs
        finally:
            lib.ply_close(handle)
