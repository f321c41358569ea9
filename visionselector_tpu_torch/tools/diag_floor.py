"""Where the window-attention kernel's time goes, on the card.

    python -m visionselector_tpu_torch.tools.diag_floor [--dims 80,128]
        [--variants full,no_store,no_math,empty] [--json PATH]

Times ``diag_attn_fwd`` at the main path's window layer: the 3B ViT's
S = 6,144 bucket (the 1036x1456 request: grid 1x60x84, window-aligned
layout), 16 heads; q and k contiguous as the rotary gives them, v a view
of the qkv slab (row stride 3 H d). ``--dims``: 80 (the default
configuration) and 128 (the "packed" configuration: heads zero-padded
from 80 to 128, the real 80 ** -0.5 scale).

It does so for builds of ``csrc/diag_attn_fwd.cu`` compiled with macros,
each launched by the unchanged wrapper (same grid, shared memory and host
work):

  full       the kernel as it is
  no_store   -DVST_DIAG_NO_STORE: no output write (wrong output)
  no_math    -DVST_DIAG_NO_MATH: loads and stores, no products (zeros)
  empty      -DVST_DIAG_EMPTY: the kernel returns at once (the floor of
             one launch)

The full build's output is checked against ``diag_plain`` (bf16 ulps of
each row's largest value). Times are CUDA-event medians of 20 calls, each
after a ~1 ms spin kernel so the host's enqueue time is not counted;
"back to back" is 10 calls in one timed window, divided by 10. Bound: the
bytes the function must move over 3.35 TB/s: q, k and v read once for
the rows of a segment > 0 (padding rows need no read), the output
written and seg read once for every row. Prints one line per (build,
head dim), then one JSON line. Needs a CUDA device and nvcc; raises
without them, and when a build does not launch. Run from a copy of
another tree to time that tree's kernel.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from visionselector_tpu_torch.tools.decode_floor import cuda_ms

H, D_REAL, S = 16, 80, 6144
GRID = (1, 60, 84)  # the main path's image, 5,040 patches
HBM_BYTES_S = 3.35e12
VARIANTS = {
    "full": [], "no_store": ["-DVST_DIAG_NO_STORE"],
    "no_math": ["-DVST_DIAG_NO_MATH"], "empty": ["-DVST_DIAG_EMPTY"],
}


def ulp_err(got, want) -> float:
    """Largest |got - want| in bf16 ulps of its row's largest |want|."""
    g, w = got.float(), want.float()
    amax = w.abs().amax(-1, keepdim=True)
    ulp = torch.exp2(torch.floor(torch.log2(amax)) - 7)
    ulp = torch.where(amax > 0, ulp, torch.finfo(torch.float32).tiny)
    return ((g - w).abs() / ulp).max().item()


def _compile(name: str, flags) -> str:
    from visionselector_tpu_torch.kernels import _build

    src = os.path.join(_build.CSRC, "diag_attn_fwd.cu")
    so = os.path.join(_build.BUILD_DIR, f"diag_floor_{name}.so")
    r = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, *flags,
                        "-shared", "-o", so, src], capture_output=True,
                       text=True, timeout=900)
    if r.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{r.stderr}")
    return so


def build_variants(names) -> dict:
    """{name: library}: the full library for "full", else
    ``diag_attn_fwd.cu`` alone with the variant's flags (one nvcc each,
    all started together), its entry point typed as the full library's."""
    from visionselector_tpu_torch.kernels import _build

    full = _build.load()
    todo = [n for n in names if VARIANTS[n]]
    with ThreadPoolExecutor(max(1, len(todo))) as ex:
        paths = dict(zip(todo, ex.map(lambda n: _compile(n, VARIANTS[n]),
                                      todo)))
    libs = {}
    for name in names:
        if not VARIANTS[name]:
            libs[name] = full
            continue
        lib = ctypes.CDLL(paths[name])
        for fn in ("vst_diag_attn_fwd", "vst_diag_attn_query"):
            if hasattr(full, fn):
                getattr(lib, fn).argtypes = getattr(full, fn).argtypes
                getattr(lib, fn).restype = getattr(full, fn).restype
        libs[name] = lib
    return libs


class _Proxy:
    """The full library, with the diag entry points taken from ``lib``."""

    def __init__(self, full, lib):
        self._full, self._lib = full, lib

    def __getattr__(self, name):
        if name.startswith("vst_diag_attn"):
            return getattr(self._lib, name)
        return getattr(self._full, name)


def needed_bytes(seg: torch.Tensor, h: int, d: int) -> int:
    """Bytes a window-attention call must move: q, k and v (bf16) read
    for the rows of a segment > 0, out written and seg (int32) read for
    every row."""
    valid, rows = int((seg > 0).sum()), seg.numel()
    return (3 * valid + rows) * h * d * 2 + rows * 4


def window_seg(dev) -> torch.Tensor:
    """[1, S] window segment ids of the main path's image in the
    window-aligned layout."""
    from visionselector_tpu_torch.preprocess.indices import (
        build_vision_batch,
    )

    grid = np.asarray([GRID])
    n = int(np.prod(grid))
    vb = build_vision_batch(np.zeros((n, 1), np.float32), grid, pad_to=S,
                            align_windows=True)
    if not vb.window_diag:
        raise RuntimeError("the main path's image did not take the "
                           "window-aligned layout")
    return torch.as_tensor(np.asarray(vb.window_seg_ids), device=dev)[None]


def inputs(d: int, dev, gen):
    """q, k [1, S, H, d] contiguous and v a view of a [S, 3, H, d] slab;
    head dims past 80 zero (the "packed" padding)."""
    q, k = (torch.randn(1, S, H, d, generator=gen, device=dev).bfloat16()
            for _ in range(2))
    slab = torch.randn(S, 3, H, d, generator=gen, device=dev).bfloat16()
    if d > D_REAL:
        for x in (q, k, slab):
            x[..., D_REAL:] = 0
    return q, k, slab[:, 2][None]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dims", default="80,128",
                    help="head dims (128: the packed layout of d 80)")
    ap.add_argument("--variants", default="full,no_store,no_math,empty",
                    help=f"builds to time, of {', '.join(VARIANTS)}")
    ap.add_argument("--json", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("diag_floor needs a CUDA device")
    from visionselector_tpu_torch.kernels import _build
    from visionselector_tpu_torch.kernels import attention as A

    dev = "cuda"
    names = args.variants.split(",")
    libs = build_variants(names)
    full = _build.load()
    gen = torch.Generator(device=dev).manual_seed(0)
    seg = window_seg(dev)
    out = {"device": torch.cuda.get_device_name(0), "S": S, "H": H,
           "variants": {}}
    load = _build.load
    try:
        for d in (int(x) for x in args.dims.split(",")):
            q, k, v = inputs(d, dev, gen)
            scale = D_REAL**-0.5
            want = A.diag_plain(q, k, v, seg, scale)
            nbytes = needed_bytes(seg, H, d)
            bound = nbytes / HBM_BYTES_S * 1e3
            for name in names:
                lib = libs[name]
                _build.load = lambda lib=lib: _Proxy(full, lib)
                got = A.diag_attn_fwd(q, k, v, seg, scale)
                torch.cuda.synchronize()
                ulps = ulp_err(got, want) if name == "full" else None
                ms = cuda_ms(lambda: A.diag_attn_fwd(q, k, v, seg, scale))
                b2b = cuda_ms(lambda: [A.diag_attn_fwd(q, k, v, seg, scale)
                                       for _ in range(10)]) / 10
                info = {}
                if hasattr(lib, "vst_diag_attn_query"):
                    info = {key: lib.vst_diag_attn_query(d, i) for i, key in
                            enumerate(("smem_bytes", "blocks_per_sm",
                                       "stages", "consumers", "sms"))}
                row = dict(ms=ms, back_to_back_ms=b2b, bytes=nbytes,
                           bound_ms=bound, ulp_err=ulps, **info)
                out["variants"].setdefault(name, {})[str(d)] = row
                print(f"[diag_floor] {name} S={S} H={H} d={d}: ms={ms!r} "
                      f"back_to_back_ms={b2b!r} bound_ms={bound!r} "
                      f"share_of_bound={bound / ms!r} ulp_err={ulps!r} "
                      f"{' '.join(f'{k_}={v_}' for k_, v_ in info.items())}",
                      flush=True)
                if ulps is not None and not ulps <= 4:
                    raise AssertionError(
                        f"diag_floor: build {name} at d={d} disagrees with "
                        f"diag_plain ({ulps} ulps)")
    finally:
        _build.load = load
    print(json.dumps(out))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
