"""Where the weight-only GEMM's time goes, on the card.

    python -m visionselector_tpu_torch.tools.wq_floor [--rows 1,8]
        [--specs int8,int4,int4:g128] [--variants full,no_math,no_reduce]

Times kernel A (``wq_matmul_fwd``) on the 3B decoder layer's seven
products (q, k, v, o, gate, up, down; random stored weights of each spec)
at each row count, per product and summed over the layer, beside the
layer's bound (stored weights + scales + x + y over 3.35 TB/s).

It does so for three builds of ``csrc/wq_matmul_fwd.cu``, each launched by
the unchanged wrapper (same plan, grid, clusters, shared memory and host
work):

  full       the kernel as it is
  no_math    compiled with ``-DVST_WQ_NO_MATH``: the loads and the ring as
             they are, no widening and no mma (wrong output; the cost of
             the math is full - no_math)
  no_reduce  compiled with ``-DVST_WQ_NO_REDUCE``: each block stops after
             adding its own warps' sums, before the K splits meet in the
             cluster (wrong output; the cost of that reduction is
             full - no_reduce)

Times are CUDA-event medians of 20 calls, each after a ~1 ms spin kernel
so the host's enqueue time is not counted; "back to back" is the layer's
seven products in one timed window, 10 times over, divided by 10. Prints
one line per (build, spec, rows), then one JSON line. Needs a CUDA device
and nvcc; raises without them.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess

import torch

from visionselector_tpu_torch.tools.decode_floor import cuda_ms

VARIANTS = {"full": [], "no_math": ["-DVST_WQ_NO_MATH"],
            "no_reduce": ["-DVST_WQ_NO_REDUCE"]}
SPECS = {"int8": (8, 0), "int4": (4, 0), "int4:g128": (4, 128)}
# (K, N) of the 3B decoder layer's products, with how many share the shape
LAYER_3B = {(2048, 2048): 2, (2048, 256): 2, (2048, 11008): 2,
            (11008, 2048): 1}


def build_variant(name: str, flags) -> ctypes.CDLL:
    """``wq_matmul_fwd.cu`` alone, with ``flags``, as a library whose
    kernel-A entry point has the full library's argument types."""
    from visionselector_tpu_torch.kernels import _build

    full = _build.load()
    if not flags:
        return full
    src = os.path.join(_build.CSRC, "wq_matmul_fwd.cu")
    so = os.path.join(_build.BUILD_DIR, f"wq_floor_{name}.so")
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, *flags,
                    "-shared", "-o", so, src], check=True,
                   capture_output=True, text=True, timeout=900)
    lib = ctypes.CDLL(so)
    fn = lib.vst_wq_matmul_fwd
    fn.argtypes = full.vst_wq_matmul_fwd.argtypes
    fn.restype = full.vst_wq_matmul_fwd.restype
    return lib


class _Proxy:
    """The full library, with kernel A's entry point taken from ``lib``."""

    def __init__(self, full, lib):
        self._full, self._lib = full, lib

    def __getattr__(self, name):
        if name == "vst_wq_matmul_fwd":
            return self._lib.vst_wq_matmul_fwd
        return getattr(self._full, name)


def layer_weights(spec: str, gen) -> dict:
    """(K, N) -> random stored weight and fp32 scales of ``spec``."""
    from visionselector_tpu_torch.models.qwen25vl.lm import pack_int4

    bits, group = SPECS[spec]
    qmax = 127 if bits == 8 else 7
    out = {}
    for k, n in LAYER_3B:
        q = torch.randint(-qmax, qmax + 1, (k, n), generator=gen,
                          device="cuda", dtype=torch.int8)
        s = torch.rand((k // group, n) if group else (n,), generator=gen,
                       device="cuda") * 2e-3 + 1e-4
        out[(k, n)] = (pack_int4(q) if bits == 4 else q), s
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", default="1,8", help="x rows, comma-separated")
    ap.add_argument("--specs", default=",".join(SPECS),
                    help=f"formats, of {', '.join(SPECS)}")
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help=f"builds to time, of {', '.join(VARIANTS)}")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("wq_floor needs a CUDA device")
    from visionselector_tpu_torch.kernels import _build
    from visionselector_tpu_torch.kernels import wq_matmul as wq

    gen = torch.Generator(device="cuda").manual_seed(0)
    full = _build.load()
    load = _build.load
    rows_list = [int(r) for r in args.rows.split(",")]
    out = {"device": torch.cuda.get_device_name(0), "layer": "3b",
           "variants": {}}
    try:
        libs = {name: build_variant(name, VARIANTS[name])
                for name in args.variants.split(",")}
        for spec in args.specs.split(","):
            weights = layer_weights(spec, gen)
            for rows in rows_list:
                xs = {k: torch.randn(rows, k, generator=gen, device="cuda",
                                     dtype=torch.bfloat16)
                      for k, _ in LAYER_3B}
                bound = sum(c * wq.bytes_moved(rows, *weights[kn])
                            for kn, c in LAYER_3B.items()) / 3.35e12 * 1e3
                for name, lib in libs.items():
                    _build.load = lambda lib=lib: _Proxy(full, lib)
                    per, total = {}, 0.0
                    for (k, n), c in LAYER_3B.items():
                        w, s = weights[(k, n)]
                        ms = cuda_ms(lambda: wq._launch(xs[k], w, s))
                        per[f"{k}x{n}"] = ms
                        total += c * ms

                    def layer():
                        for _ in range(10):
                            for (k, n), c in LAYER_3B.items():
                                for _ in range(c):
                                    wq._launch(xs[k], *weights[(k, n)])

                    b2b = cuda_ms(layer) / 10
                    out["variants"].setdefault(name, []).append(dict(
                        spec=spec, rows=rows, layer_ms=total,
                        back_to_back_ms=b2b, bound_ms=bound, per_shape=per))
                    print(f"[wq_floor] {name} {spec} rows={rows}: layer "
                          f"{total!r} ms (back to back {b2b!r}), bound "
                          f"{bound!r} ms; per product {per}", flush=True)
    finally:
        _build.load = load
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
