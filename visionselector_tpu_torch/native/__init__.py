"""Native host-side preprocessing: fused normalize + patchify (C, OpenMP).

The port's counterpart of ``visionselector_tpu.native``, with its own copy
of the C source (``fused_preprocess.c``). It is compiled the first time a
caller asks for it, with the system C compiler (``$CC``, default ``cc``):
``-O3 -shared -fPIC -fopenmp``, or without OpenMP where the compiler
refuses it. The library goes to ``native/build/`` (git-ignored) under a
name that carries the source's hash, so an edited source is rebuilt and a
stale library is never loaded. Nothing here runs at import time.

On a machine with no C compiler (or where the build fails) every caller
takes the numpy pipeline of ``preprocess.image``, which gives the same
arrays; ``native_available()`` says which path is in use.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "fused_preprocess.c")
_BUILD_DIR = os.path.join(_DIR, "build")
_LOCK = threading.Lock()
_LIB = None
_TRIED = False
# What the last build attempt printed (compiler errors), for the callers
# that must report why the native path is missing.
BUILD_LOG = ""


def _so_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    tag = f"cpython{sys.version_info[0]}{sys.version_info[1]}"
    return os.path.join(_BUILD_DIR, f"fused_preprocess_{tag}_{digest}.so")


def _build() -> str | None:
    global BUILD_LOG
    so = _so_path()
    if os.path.exists(so):
        return so
    os.makedirs(_BUILD_DIR, exist_ok=True)
    cc = os.environ.get("CC", "cc")
    tmp = f"{so}.tmp{os.getpid()}"
    for extra in (["-fopenmp"], []):  # OpenMP where supported, else serial
        try:
            r = subprocess.run(
                [cc, "-O3", "-shared", "-fPIC", "-o", tmp, _SRC] + extra,
                capture_output=True, text=True, timeout=120)
        except (OSError, subprocess.TimeoutExpired) as e:
            BUILD_LOG = f"{cc}: {e!r}"
            return None
        BUILD_LOG = r.stdout + r.stderr
        if r.returncode == 0:
            os.replace(tmp, so)  # atomic: no partly written library
            return so
    return None


def _load():
    global _LIB, _TRIED, BUILD_LOG
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        so = _build()
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError as e:
            BUILD_LOG = f"dlopen {so}: {e!r}"
            return None
        common = [ctypes.c_long] * 6 + [ctypes.POINTER(ctypes.c_double)] * 2
        for name, src in (("fused_normalize_patchify_u8", ctypes.c_ubyte),
                          ("fused_normalize_patchify_f64", ctypes.c_double)):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.POINTER(src),
                           ctypes.POINTER(ctypes.c_float)] + common
            fn.restype = None
        _LIB = lib
        return _LIB


def native_available() -> bool:
    """True when the C library is built and loaded (the native path)."""
    return _load() is not None


def fused_normalize_patchify(
    frames: np.ndarray,  # [T, H, W, 3] uint8 or float64
    patch_size: int,
    temporal_patch_size: int,
    merge_size: int,
    mean: np.ndarray,
    std: np.ndarray,
) -> np.ndarray | None:
    """Normalize + patchify in C: [grid_t * grid_h * grid_w, 3 * tp * ps *
    ps] float32, the rows ``preprocess.image.patchify`` gives. None when the
    library is unavailable, or for input it does not take (another dtype,
    not 3 channels, a side that is not a multiple of patch * merge): the
    caller then takes the numpy path."""
    lib = _load()
    if lib is None or frames.ndim != 4:
        return None
    t, h, w, c = frames.shape
    m = patch_size * merge_size
    if c != 3 or h % m or w % m or t < 1:
        return None
    if frames.dtype == np.uint8:
        fn, ptr = lib.fused_normalize_patchify_u8, ctypes.c_ubyte
    elif frames.dtype == np.float64:
        fn, ptr = lib.fused_normalize_patchify_f64, ctypes.c_double
    else:
        return None
    fr = np.ascontiguousarray(frames)
    gt = -(-t // temporal_patch_size)
    out = np.empty((gt * (h // patch_size) * (w // patch_size),
                    3 * temporal_patch_size * patch_size**2), np.float32)
    meand = np.ascontiguousarray(mean, np.float64)
    stdd = np.ascontiguousarray(std, np.float64)
    if meand.shape != (3,) or stdd.shape != (3,):
        raise ValueError("mean and std take one value per channel")
    dbl = ctypes.POINTER(ctypes.c_double)
    fn(fr.ctypes.data_as(ctypes.POINTER(ptr)),
       out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
       t, h, w, patch_size, temporal_patch_size, merge_size,
       meand.ctypes.data_as(dbl), stdd.ctypes.data_as(dbl))
    return out
