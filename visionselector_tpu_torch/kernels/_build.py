"""Build and load the CUDA kernels (attention, and the weight-only
quantized product).

``csrc/*.cu`` are compiled by ``nvcc`` for ``sm_90a`` (one ``nvcc`` per
source, all started together) and linked into one shared library with a
plain C interface, the first time a CUDA tensor reaches a kernel wrapper,
and loaded with ``ctypes``. The library goes to
``kernels/build/`` (git-ignored) under a name that carries a hash of the
sources, so an edited source is rebuilt and a stale library is never
loaded. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LOCK = threading.Lock()
_LIB = None
# Seconds the last build took (0.0 when the library was already built) and
# the compiler's register / shared-memory report for each kernel.
BUILD_SECONDS = 0.0
PTXAS_LOG = ""

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")) +
                  glob.glob(os.path.join(CSRC, "*.cuh")))


def library_path() -> str:
    digest = hashlib.sha256()
    for path in _sources():
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libvst_attn_{digest.hexdigest()[:12]}.so")


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError(
            f"nvcc not found at {nvcc}: the CUDA kernels need the CUDA "
            "toolkit (set CUDA_HOME)")
    return nvcc


def _run(cmd):
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if r.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({r.returncode}):\n{' '.join(cmd)}\n{r.stderr}")
    return r.stderr


def build() -> str:
    """Compile the kernels unless the library for these sources exists."""
    global BUILD_SECONDS, PTXAS_LOG
    so = library_path()
    if os.path.exists(so):
        BUILD_SECONDS = 0.0
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.tmp{os.getpid()}"
    nvcc = nvcc_path()
    sources = [s for s in _sources() if s.endswith(".cu")]
    objs = [f"{tmp}.{os.path.basename(s)}.o" for s in sources]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as ex:
        logs = list(ex.map(_run, [[nvcc, *NVCC_FLAGS, "-c", "-o", o, s]
                                  for s, o in zip(sources, objs)]))
    _run([nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs])
    for o in objs:
        os.remove(o)
    os.replace(tmp, so)  # atomic: no half-written library is ever loaded
    BUILD_SECONDS = time.perf_counter() - t0
    PTXAS_LOG = "".join(logs)
    with open(so + ".ptxas.txt", "w") as f:
        f.write(PTXAS_LOG)
    return so


def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build())
            lib.vst_flash_varlen_fwd.argtypes = (
                [_P] * 7 + [_L] * 9 + [_I] * 8 + [_F] + [_P] * 5 + [_I, _P])
            lib.vst_flash_varlen_fwd.restype = _I
            lib.vst_fullattn_ablate_fwd.argtypes = (
                [_P] * 5 + [_L] * 9 + [_I] * 6 + [_F] + [_P] * 5 + [_I, _P])
            lib.vst_fullattn_ablate_fwd.restype = _I
            lib.vst_fused_vit_attn_fwd.argtypes = (
                [_P] * 10 + [_I] * 3 + [_F, _I, _P])
            lib.vst_fused_vit_attn_fwd.restype = _I
            lib.vst_wgmma_main_smem_bytes.argtypes = [_I]
            lib.vst_wgmma_main_smem_bytes.restype = _I
            lib.vst_wgmma_main_blocks_per_sm.argtypes = [_I, _I]
            lib.vst_wgmma_main_blocks_per_sm.restype = _I
            lib.vst_diag_attn_fwd.argtypes = (
                [_P] * 6 + [_L] * 9 + [_I] * 4 + [_F, _P])
            lib.vst_diag_attn_fwd.restype = _I
            lib.vst_diag_attn_query.argtypes = [_I, _I]
            lib.vst_diag_attn_query.restype = _I
            lib.vst_decode_blocked_fwd.argtypes = (
                [_P] * 7 + [_L] * 12 + [_I] * 9 + [_F, _P])
            lib.vst_decode_blocked_fwd.restype = _I
            lib.vst_decode_blocked_query.argtypes = [_I] * 7
            lib.vst_decode_blocked_query.restype = _I
            lib.vst_wq_matmul_fwd.argtypes = [_P] * 4 + [_I] * 11 + [_P]
            lib.vst_wq_matmul_fwd.restype = _I
            lib.vst_wq_dequant_fwd.argtypes = [_P] * 3 + [_I] * 4 + [_P]
            lib.vst_wq_dequant_fwd.restype = _I
            _LIB = lib
        return _LIB
