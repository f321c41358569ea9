"""Where the decode kernel's time goes, on the card.

    python -m visionselector_tpu_torch.tools.decode_floor [--quant]
        [--slots 8] [--rows 2048] [--lengths 0,256,1024,2000]
        [--variants full,no_merge,empty]

Times ``decode_blocked_fwd`` over a pool of 8 slots of 2,048 rows at the
3B decoder's widths (16 query heads, 2 kv heads, head dim 128; t_c = 1,
bf16, or int8 with ``--quant``) with every slot at live length 0 (base_len
0), 256, 1,024 and 2,000, and prints the least-squares intercept (ms) and
slope (ms per MB of live cache) of time against the bytes the call must
move (with two lengths or more).

It does so for three builds of ``csrc/decode_blocked_fwd.cu``, each
launched by the unchanged wrapper (same grid, cluster, shared memory and
host work):

  full      the kernel as it is
  no_merge  compiled with ``-DVST_DECODE_NO_MERGE``: each block stops after
            merging its own warps, before the blocks of a (slot, kv head)
            merge (wrong output; the cost of that merge is full - no_merge)
  empty     compiled with ``-DVST_DECODE_EMPTY``: the kernel returns at once
            (the floor of one launch)

Times are CUDA-event medians of 20 calls, each after a ~1 ms spin kernel
so the host's enqueue time is not counted; "back to back" is 10 calls in
one timed window, divided by 10. Prints one line per (build, length), then
one JSON line. Needs a CUDA device and nvcc; raises without them.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess

import numpy as np
import torch

HQ, HKV, D = 16, 2, 128
VARIANTS = {"full": [], "no_merge": ["-DVST_DECODE_NO_MERGE"],
            "empty": ["-DVST_DECODE_EMPTY"]}


def cuda_ms(fn, n: int = 20) -> float:
    """Median milliseconds of ``fn`` over n calls (CUDA events), after one
    warm-up call; a spin kernel keeps the card busy while the host
    enqueues each call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def build_variant(name: str, flags) -> ctypes.CDLL:
    """``decode_blocked_fwd.cu`` alone, with ``flags``, as a library whose
    decode entry point has the full library's argument types."""
    from visionselector_tpu_torch.kernels import _build

    full = _build.load()
    if not flags:
        return full
    src = os.path.join(_build.CSRC, "decode_blocked_fwd.cu")
    so = os.path.join(_build.BUILD_DIR, f"decode_floor_{name}.so")
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, *flags,
                    "-shared", "-o", so, src], check=True,
                   capture_output=True, text=True, timeout=900)
    lib = ctypes.CDLL(so)
    fn = lib.vst_decode_blocked_fwd
    fn.argtypes = full.vst_decode_blocked_fwd.argtypes
    fn.restype = full.vst_decode_blocked_fwd.restype
    return lib


class _Proxy:
    """The full library, with the decode entry point taken from ``lib``."""

    def __init__(self, full, lib):
        self._full, self._lib = full, lib

    def __getattr__(self, name):
        if name == "vst_decode_blocked_fwd":
            return self._lib.vst_decode_blocked_fwd
        return getattr(self._full, name)


def live_bytes(base, rows: int, quant: bool) -> int:
    """Bytes the call must move: each slot's live k and v rows (and their
    scales), q and the output."""
    keys = int(torch.clamp(base + 1, max=rows).sum())
    per_key = HKV * D * (1 if quant else 2) * 2 + (HKV * 8 if quant else 0)
    return keys * per_key + 2 * base.shape[0] * HQ * D * 2


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quant", action="store_true",
                    help="an int8 pool with f32 scales")
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--rows", type=int, default=2048)
    ap.add_argument("--lengths", default="0,256,1024,2000",
                    help="live lengths, comma-separated")
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help=f"builds to time, of {', '.join(VARIANTS)}")
    args = ap.parse_args(argv)
    slots, rows = args.slots, args.rows
    lengths = [int(x) for x in args.lengths.split(",")]
    if not torch.cuda.is_available():
        raise RuntimeError("decode_floor needs a CUDA device")
    from visionselector_tpu_torch.kernels import _build
    from visionselector_tpu_torch.kernels import attention as A
    from visionselector_tpu_torch.models.qwen25vl.lm import quantize_kv

    gen = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn(slots, 1, HQ, D, generator=gen, device="cuda").bfloat16()
    k = torch.randn(slots, rows, HKV, D, generator=gen,
                    device="cuda").bfloat16()
    v = torch.randn(slots, rows, HKV, D, generator=gen,
                    device="cuda").bfloat16()
    sc = {}
    if args.quant:
        (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
        sc = dict(k_scale=ks, v_scale=vs)
    full = _build.load()
    load = _build.load
    out = {"device": torch.cuda.get_device_name(0),
           "dtype": "int8" if args.quant else "bf16", "variants": {}}
    try:
        for name in args.variants.split(","):
            lib = build_variant(name, VARIANTS[name])
            _build.load = lambda lib=lib: _Proxy(full, lib)
            timed = []
            for n in lengths:
                base = torch.full((slots,), max(n - 1, 0), device="cuda")
                ms = cuda_ms(lambda: A.decode_blocked_fwd(q, k, v, base,
                                                          **sc))
                b2b = cuda_ms(lambda: [A.decode_blocked_fwd(q, k, v, base,
                                                            **sc)
                                       for _ in range(10)]) / 10
                nb = live_bytes(base, rows, args.quant)
                timed.append(dict(length=n, bytes=nb, ms=ms,
                                  back_to_back_ms=b2b,
                                  bound_ms=nb / 3.35e12 * 1e3))
                print(f"[decode_floor] {out['dtype']} {name} B={slots} "
                      f"T={rows} length {n}: "
                      f"ms={ms!r} back_to_back_ms={b2b!r} bytes={nb} "
                      f"bound_ms={timed[-1]['bound_ms']!r}", flush=True)
            out["variants"][name] = dict(rows=timed)
            if len(timed) < 2:
                continue
            x = np.array([r["bytes"] / 1e6 for r in timed])
            y = np.array([r["ms"] for r in timed])
            slope, icpt = (float(c) for c in np.polyfit(x, y, 1))
            print(f"[decode_floor] {out['dtype']} {name}: intercept_ms="
                  f"{icpt!r} slope_ms_per_MB={slope!r} (the card's rate: "
                  f"{1e6 / 3.35e12 * 1e3!r})", flush=True)
            out["variants"][name].update(intercept_ms=icpt,
                                         slope_ms_per_mb=slope)
    finally:
        _build.load = load
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
