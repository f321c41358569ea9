"""Ablate the full-attention flash kernel's in-kernel costs on the card.

    python -m visionselector_tpu_torch.tools.bench_fullattn_ablate [S]

The port of the JAX package's TPU bench ``tools/bench_fullattn_ablate.py``:
which part of the flash kernel owns its time on the ViT's full-attention
layers? Each case runs on the same seeded inputs (S x 16 heads x d 80,
bf16, q/k/v = 0.1 * normal, the last 128 rows padding; default S = 5632):

  prod         ``flash_varlen_fwd`` without bounds: the production kernel
  full_ablate  ``fullattn_ablate`` with mask and exp: the same kernel code
               through the ablation entry (checks the harness)
  nomask       no segment mask, padding included (exp and online softmax
               kept)
  noexp        mask kept, p = the masked logits (no exp, no division)
  bare         the two matrix products and the accumulation only

Every case runs the production kernel's route (an image prologue, then
the wgmma main loop), with its grid, tiles and loads, and visits every kv
tile. Each case is timed as one call and as its two launches apart (the
prologue, which is the same in every case, and the main loop). Times are
CUDA-event medians of 10 calls, each after a ~1 ms spin kernel so the
host's enqueue time is not counted. Prints one line per case, then one
JSON line. Needs a CUDA device; raises without one.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

HEADS, HEAD_DIM, PAD_ROWS = 16, 80, 128
N_TIMED = 10


def cuda_ms(fn, n: int = N_TIMED) -> float:
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


def inputs(s: int, device="cuda"):
    """The bench's q, k, v [1, S, 16, 80] bf16 and seg [1, S] (ones, the
    last 128 rows 0), from numpy seed 0."""
    rng = np.random.RandomState(0)
    q, k, v = (torch.as_tensor(rng.randn(1, s, HEADS, HEAD_DIM) * 0.1,
                               dtype=torch.bfloat16, device=device)
               for _ in range(3))
    seg = np.ones(s, np.int32)
    seg[-PAD_ROWS:] = 0
    return q, k, v, torch.as_tensor(seg, device=device)[None]


def cases(q, k, v, seg) -> dict:
    """name -> a call of the case's kernel."""
    from visionselector_tpu_torch.kernels.attention import (
        flash_varlen_fwd,
        fullattn_ablate,
    )

    return {
        "prod": lambda: flash_varlen_fwd(q, k, v, seg, seg),
        "full_ablate": lambda: fullattn_ablate(q, k, v, seg, True, True),
        "nomask": lambda: fullattn_ablate(q, k, v, seg, False, True),
        "noexp": lambda: fullattn_ablate(q, k, v, seg, True, False),
        "bare": lambda: fullattn_ablate(q, k, v, seg, False, False),
    }


def phase_runs(q, k, v, seg) -> dict:
    """name -> run(phases, scratch): the case's launches (phases 1 the
    prologue, 2 the main loop on the images a prologue wrote into
    ``scratch``, 3 both); returns (out, scratch)."""
    from visionselector_tpu_torch.kernels import attention as A

    def prod(phases=3, scratch=None):
        return A._launch_flash("prod", q, k, v, seg, seg, False, None, None,
                               None, phases=phases, scratch=scratch)

    def ablate(do_mask, do_exp):
        return lambda phases=3, scratch=None: A._launch_ablate(
            q, k, v, seg, do_mask, do_exp, None, phases=phases,
            scratch=scratch)

    return {"prod": prod, "full_ablate": ablate(True, True),
            "nomask": ablate(False, True), "noexp": ablate(True, False),
            "bare": ablate(False, False)}


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    s = int(argv[0]) if argv else 5632
    if not torch.cuda.is_available():
        raise RuntimeError("bench_fullattn_ablate runs on a CUDA device; "
                           "torch.cuda.is_available() is false")
    result = {"s": s, "heads": HEADS, "head_dim": HEAD_DIM,
              "device": torch.cuda.get_device_name(0)}
    args = inputs(s)
    runs = phase_runs(*args)
    for name, fn in cases(*args).items():
        ms = cuda_ms(fn)
        _, scratch = runs[name]()
        pro, main_ms = (cuda_ms(lambda st=st: runs[name](st, scratch))
                        for st in (1, 2))
        result[f"ms_{name}"] = ms
        result[f"ms_{name}_prologue"] = pro
        result[f"ms_{name}_main"] = main_ms
        print(f"[{name}] {ms!r} ms = prologue {pro!r} + main loop "
              f"{main_ms!r}", flush=True)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
