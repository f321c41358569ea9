#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``visionselector_tpu_torch``) on one
NVIDIA GPU: the quickest proof that the port still starts on the card.

    python3 chip_smoke.py

Phases (each prints its lines; any failure raises and exits non-zero):

1. Device and build: the card's name and power limit, torch / CUDA
   versions, the CUDA kernels' build time (``nvcc``, from the sources in
   this checkout); TF32 off for fp32 matmuls and convolutions.
2. Each kernel against its plain PyTorch version on the card at the main
   path's shapes (bf16 inputs from a seeded generator): flash and diag at
   the prefill's shapes, the decode kernel over an 8-slot, 2,048-row pool
   and over one slot of the one-shot ``orig`` cache (bf16 and int8, t_c 1
   and 4, lengths at tile edges; at t_c 16 and 32, multiple-choice
   scoring's chunk, at the cache's base, 0 and across a tile edge, with a
   planted fault: chunk row i sees position base + i + 1; also against its
   schedule's plain mirror
   ``decode_split_plain``, with its times at four live lengths, their
   intercept and slope, its cluster size, ptxas lines and occupancy at
   D = 128), the fused rotary +
   attention kernel on a ViT layer's qkv slab with full and window bounds,
   the packed entry point on the ViT full layer with heads padded from 80
   to 128 and on the LM prefill slabs, and the four full-attention
   ablation variants at S = 5,632; the window kernel (K4) also on the
   "packed" window layer (heads padded from 80 to 128, v a view of the
   qkv slab), with its ptxas lines, shared memory, ring, blocks per SM and
   grid at D = 80 and 128 and ``tools/diag_floor``'s breakdown (full, no
   store, no products, empty launch). Every flash-source call (flash with
   bounds, a kv_iters cap or the causal mask, packed, ablation) and every
   fused call makes two launches, an image prologue and the wgmma main
   loop: they are also timed apart, each beside its bound, the prologue's
   tile images and tile_segs must equal their plain versions bit for bit,
   and the share of visited kv tiles that take the mask-free step (from
   ``tiles.flash_steps_plain``) is printed, with the kernels' ptxas
   registers, shared memory and blocks per SM (D = 80 and 128, the causal
   main loop's too).
   Tolerance: every
   output element within ULP_LIMIT bf16 ulps of the largest |value| of
   its row (one head of one query) in the plain output. Rounding both
   outputs to bf16 differs by at most 1 such ulp; the kernel rounds p to
   bf16 at the running row max and the plain version at the final one,
   which adds up to about one more in the tails. Also checked: padding
   rows exactly 0. Planted faults (kv tiles dropped from the bounds, a key
   dropped from every window, a slot's last key or last live tile dropped
   in decode, the last rank's share left out of the decode kernel's
   cluster merge, k rotated with the next row's cos/sin, a straddling tile
   forced onto the mask-free step of the flash and the fused kernels and
   of the causal LM prefill, each causal q tile's diagonal kv tile cut
   from the bounds, noise in the pad columns of q and k, the ablation's
   mask switched off, a mixed tile of the window kernel forced onto its
   mask-free path)
   must fail the
   same check, so it is shown to see an off-by-one tile at the main path's
   shapes.
   Kernel, plain and library times are CUDA-event medians (the card is
   kept busy while the call is enqueued, so host time is not counted);
   work rates are printed from the tiles the kernel visits and from the
   valid (query, key) pairs. Each kernel's bound is the larger of its bytes
   (inputs read once, outputs written once; for decode the live prefix)
   over 3.35 TB/s and its flop over 989 TFLOP/s (bf16 dense; the real
   head dim's flop for padded heads); the library yardstick is one
   ``F.scaled_dot_product_attention`` call with the same mask (causal and
   padding for the LM prefill, GQA; for decode the length mask, causal
   within the chunk at t_c 4; the port never calls it; for the fused
   kernel it gets q and k already rotated, for padded heads the unpadded
   d = 80, and int8 decode and the ablation without exp have none).
3. Main path: full-width Qwen2.5-VL-3B with random weights (bf16, seeded),
   one 1036x1456 image and ~40 text ids, ``QwenVLEngine.generate`` with the
   LIS selector at budget 0.2 and with ``orig``, 32 greedy tokens each.
   The kernel launch counters are zeroed just before and read just after;
   every prefill must launch the diag kernel once per window layer and the
   flash kernel once per full-attention ViT layer and per decoder layer
   (causal), all on the wgmma route, and every decode step the decode
   kernel once per decoder layer.
   The same request then runs with the plain attention path, and the
   first-token logits and selected sets are compared. Then the selector
   request under ``attn_variant="fused"`` and ``"packed"`` (each with its
   own launch counts, and against its own plain path).
4. Where the time goes: unprofiled wall times of prefill, host prep and
   decode per token, then ``torch.profiler`` runs of the prefill and of the
   decode: device busy time (the union of kernel and copy intervals in the
   trace), the idle share and the top kernels; the ViT's device time and
   the prefill's wall and device time under each attention configuration;
   then the ablation entry point (``visionselector_tpu_torch.tools.
   bench_fullattn_ablate``) once, with its five times.
   Per-kernel device times go to ``chiprun_out/profile_*_kernels.txt``.
5. Serving: ``ContinuousBatcher`` (8 slots, 2,048 rows, chunk 8) over the
   same weights; 16 requests from 16 threads (4 at once, then one every
   100 ms): 1036x1456 and 448x448 images, text-only prompts and two
   ``orig`` requests on a second batcher; three sampled, one with a
   repetition penalty; then 4 requests through an int8 pool. Checked:
   tokens in range, the batchers' stats, decode launches = layers x decode
   steps, each greedy request's first token equals one-shot ``generate``'s,
   and a teacher-forced step on copies of one admitted pool with the
   kernel and with ``decode_attn="plain"``. Printed: decode tok/s, time to
   first token, chunk wall vs device-busy ms (torch.profiler), peak memory
   and pool bytes.
6. Training (``train``): K1's gradient at the LM's training shape (B = 2,
   T = 1,536 with padding tails, GQA 16/2, D = 128, causal): the autograd
   Function (kernel forward, the blocked mirror backward) against the
   plain forward with the same backward, output within ULP_LIMIT, dq /
   dk / dv within GRAD_TOL of their largest |value| (its comment says
   why), and two planted faults (delta from zeros, the diagonal kv block
   left out of dk) must exceed it. Then 8 selector steps at full width
   on one fixed batch (2 samples of the phase-3 image, its 40 prompt ids
   and a 32-id answer each, text bucket 1,536; lr 5e-3, reg_weight 1.0):
   loss and BCE fall, 28 K4 + 4 K1 launches per sample and 36 K1 per LM
   call every step, scorer gradients finite and non-zero, every frozen
   weight bit-equal (per-tensor checksums) and without ``.grad``. Before
   the steps, the CE's scorer gradients (the part that crosses the LM)
   with remat equal the default run's, and agree within TRAIN_GRAD_TOL
   with plain attention differentiated by autograd (no kernel, no mirror;
   the LM's alone, and the ViT's too), which two planted mirror faults
   must exceed; both bf16 paths' distances from an fp32 reference (an fp32
   copy of the weights, every attention plain) are printed, the plain
   path's being the noise floor of bf16 rounding.
   Printed: step wall, device busy and idle share (the last step under
   torch.profiler, against its own wall), forward, backward and update
   device ms and the mirror's share of the backward (each kernel placed
   by the host code that launched it, in that trace), tokens/s, peak
   memory with and without remat. Then an HF-layout safetensors
   directory of the weights at reduced depth (ViT blocks 0 and 7, LM
   layers 0 and 1, bf16, the trained scorer) in both prefix layouts,
   loaded onto the card bit for bit, and served by ``api.predict
   --model-path``; the trained scorer exported, reloaded bit for bit and
   served (first token equal to the in-memory scorer's); ``api.train
   --smoke --total-steps 3`` on the card (the two CLI runs beside the
   rest of the phase). Its files go under ``.smoke_tmp/`` and are
   removed after phase 7.
7. Eval (``eval``), on phase 3's weights with phase 6's scorer:
   ``QwenVLEngine.loglikelihood`` of a 12-id continuation after the
   phase-3 request (selector 0.2 and ``orig``) and after 200 text ids,
   and ``run_loglikelihood_choices`` with choices of 1, 5, 12 and 20 ids
   (one prefill, one chunked decode forward of 32 rows per choice), each
   against ``attn_impl="plain"`` within LL_TOL nats per continuation
   token (LL_TOL_SAME for the full-prefill ll of ``orig`` and text-only,
   whose kept tokens cannot differ; LL_TOL_CHUNK for ``orig``'s
   choices), planted faults exceeding the tolerance they are planted in
   (the continuation scored one position late; a choice's token j read
   from chunk row j), the choices in reverse order equal, on ``orig``
   each choice against its own full prefill, and the launches (28 K4 + 40 K1
   per image prefill, 36 K1 per text prefill, 36 K5 per choice and none
   otherwise); then ``evaluate`` through the port's ``EngineAdapter``
   (``_IdTokenizer``, EVAL_TIME) on synthetic tasks under
   ``.smoke_tmp/`` (4 text-only generate docs of 16 tokens, 4 text-only
   MC docs of 2-4 choices, and an image MC doc when PIL imports): every
   doc predicted, the reference harness's metric keys, MC predictions the
   argmax of their lls; and ``api.run_eval --model-path`` (phase 6's
   reduced-depth HF directory) ``--device cuda`` in a process of its own.

The line before the last is a JSON object describing the kernels; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

ULP_LIMIT = 4
N_TIMED = 10
SEED = 0
MAX_NEW_TOKENS = 32
PROFILE_DECODE_STEPS = 16
SRC = "visionselector_tpu_torch/kernels/csrc/"
TILE = 64  # the kernels' q/kv tile (FLASH_BLOCK)
HBM_BYTES_S = 3.35e12  # H100 SXM device memory rate
BF16_FLOP_S = 989e12  # H100 SXM dense bf16 tensor-core peak
# Decode kernel check: an 8-slot pool of 2,048 rows at the 3B decoder's
# GQA widths; lengths at the tile edges and the 3B orig prefill length.
POOL_SLOTS, POOL_ROWS = 8, 2048
DECODE_LENS = (1, 63, 64, 65, 300, 1302, 1900, 2047)
# Live lengths of the decode time sweep (0 = base_len 0), and the one-shot
# engine's cache under orig: the 1,664-row prefill (1,302 valid) plus room
# for MAX_NEW_TOKENS, decoded from base length 1,302.
DECODE_SWEEP = (0, 256, 1024, 2000)
ORIG_CACHE_ROWS, ORIG_BASE_LEN = 1664 + MAX_NEW_TOKENS, 1302
# Teacher-forced decode step, kernel vs dense plain path, per slot: the
# two differ only in decode attention (bf16 out of an fp32 online softmax
# vs a bf16 einsum of probabilities rounded at the final max), about one
# bf16 ulp (0.4%) per layer, which 36 random-weight layers carry to 3-4%
# of max |logit| (measured on the H100; phase 3's whole-model check uses
# the same 0.1). A slot read from the wrong place or garbage gives O(max
# |logit|); a dropped key or tile is the kernel check's to catch.
TEACHER_TOL = 0.1
# Each kernel of the port: (source, the TPU kernel it replaces). K1 and K2
# share flash_varlen_fwd; the packed entry (K3) and the ablation (K7) are
# launches of the same source's kernels (non-causal: the image prologue and
# the wgmma main loop of wgmma_attn.cuh, which the fused kernel shares).
KERNELS = {
    "flash_varlen_fwd": ("flash_varlen_fwd.cu",
                         "visionselector_tpu/kernels/attention.py:203"),
    "diag_attn_fwd": ("diag_attn_fwd.cu",
                      "visionselector_tpu/kernels/attention.py:681"),
    "decode_blocked_fwd": ("decode_blocked_fwd.cu",
                           "visionselector_tpu/kernels/attention.py:1085"),
    # K5 at t_c = 32 rows per slot: the chunked decode forward of
    # multiple-choice scoring (phase 7), a launch shape of its own
    "decode_blocked_fwd_t_c32": ("decode_blocked_fwd.cu",
                                 "visionselector_tpu/kernels/attention.py:"
                                 "1085"),
    "fused_vit_attn_fwd": ("fused_vit_attn_fwd.cu",
                           "visionselector_tpu/kernels/fused_vit_attn.py:144"),
    "flash_packed_fwd": ("flash_varlen_fwd.cu",
                         "visionselector_tpu/kernels/attention.py:521"),
    "fullattn_ablate_fwd": ("flash_varlen_fwd.cu",
                            "tools/bench_fullattn_ablate.py:83"),
}
ABLATE_S = 5632  # the ablation's sequence (the JAX bench's default)


def nvidia_smi() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip()


def cuda_ms(fn, n=N_TIMED) -> float:
    """Median milliseconds of ``fn`` over n runs (CUDA events), after one
    warm-up call. A ~1 ms spin kernel runs first, so the card is busy while
    the host enqueues the events and ``fn``'s launches: the time is the
    device's, not the Python wrapper's."""
    import torch

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


def bound_ms(nbytes, flop):
    """(least ms for this work on the card, what bounds it)."""
    t_bytes, t_flop = nbytes / HBM_BYTES_S * 1e3, flop / BF16_FLOP_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_flop else (t_flop,
                                                          "operations")


def sdpa_ms(q, k, v, mask, scale=None):
    """Time of one ``F.scaled_dot_product_attention`` call on the same
    inputs and mask ([B, S, H, D] layouts; GQA when k has fewer heads)."""
    import torch.nn.functional as F

    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    gqa = k.shape[2] != q.shape[2]
    return cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=gqa, scale=scale))


def bf16_ulp_err(got, want) -> float:
    """Largest |got - want| in bf16 ulps of its row's largest |want| (a row
    is the last dim). A value in [2^e, 2^(e+1)) has bf16 spacing 2^(e-7).
    An all-zero row of ``want`` must be exactly zero in ``got``."""
    import torch

    g, w = got.float(), want.float()
    amax = w.abs().amax(-1, keepdim=True)
    ulp = torch.exp2(torch.floor(torch.log2(amax)) - 7)
    ulp = torch.where(amax > 0, ulp, torch.finfo(torch.float32).tiny)
    return ((g - w).abs() / ulp).max().item()


def flash_work(tiles, valid_pairs, h, d):
    """(flop over the kv tiles the kernel visits, flop over the valid
    (query, key) pairs), for ``tiles`` visited kv tiles of all q tiles of
    one head: QK^T and PV are 2 * d flop per pair each."""
    return 4 * d * h * int(tiles) * TILE * TILE, 4 * d * h * int(valid_pairs)


def tflops(flop, ms):
    return flop / (ms * 1e-3) / 1e12


PROMPT_BEFORE, PROMPT_AFTER = list(range(100, 120)), list(range(300, 320))


def request_image():
    """The main path's seeded 1036x1456 RGB image."""
    import numpy as np

    rng = np.random.RandomState(SEED)
    return (rng.rand(1036, 1456, 3) * 255).astype(np.uint8)


def request(cfg):
    """The main path's request: a seeded 1036x1456 RGB image (grid
    (1, 60, 84), 5,040 patches, the 6,144 bucket) and 40 text ids around
    it."""
    from visionselector_tpu_torch.preprocess.image import preprocess_image
    from visionselector_tpu_torch.preprocess.rope import expand_vision_tokens

    pixels, grid = preprocess_image(request_image())
    input_ids = expand_vision_tokens(
        PROMPT_BEFORE, PROMPT_AFTER, grid,
        spatial_merge_size=cfg.vision.spatial_merge_size,
        image_token_id=cfg.image_token_id,
        vision_start_token_id=cfg.vision_start_token_id,
        vision_end_token_id=cfg.vision_end_token_id,
    )
    return input_ids, pixels, grid


def check_kernels(cfg, engine, input_ids, pixels, grid):
    """Phase 2: each kernel against its plain version. Returns
    {kernel: {max_abs_err over its cases, and ms, plain_ms, bound_ms,
    bound_by, library_ms of its main case}}."""
    import numpy as np
    import torch

    from visionselector_tpu_torch.kernels import attention as A
    from visionselector_tpu_torch.kernels import tiles as T
    from visionselector_tpu_torch.preprocess.indices import build_vision_batch
    from visionselector_tpu_torch.tools import diag_floor

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(
            torch.bfloat16)

    def ivec(x):
        return torch.as_tensor(np.asarray(x), device=dev)[None].int()

    results = {name: [] for name in KERNELS}

    def case(kernel, name, fn, plain, pad_rows, rate, work, library=None):
        """Check one shape; ``rate(ms)`` formats the kernel's work rate;
        ``work`` = (bytes, flop) of the call; ``library``: the timed
        library call, where one computes the same function (the JSON line
        takes the kernel's first case)."""
        got, want = fn(), plain()
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        ulps = bf16_ulp_err(got, want)
        pad_zero = bool((got[:, pad_rows] == 0).all()) if len(pad_rows) \
            else True
        ms, plain_ms = cuda_ms(fn), cuda_ms(plain, n=3)
        print(f"[kernel] {kernel} {name}: max_abs_err={err!r} "
              f"max|plain|={want.float().abs().max().item()!r} "
              f"ulp_err={ulps!r} (limit {ULP_LIMIT}) pad_rows_zero={pad_zero}"
              f" ms={ms!r} plain_ms={plain_ms!r} {rate(ms)}", flush=True)
        if not (ulps <= ULP_LIMIT and pad_zero and torch.isfinite(got).all()):
            raise AssertionError(
                f"{kernel} {name} disagrees with its plain version "
                f"({ulps} ulps, pad rows zero {pad_zero})")
        entry = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
        entry["bound_ms"], entry["bound_by"] = bound_ms(*work)
        entry["library_ms"] = library() if library is not None else None
        lib = ("" if library is None else
               f" library_ms={entry['library_ms']!r} (one "
               f"scaled_dot_product_attention call, same mask)")
        print(f"[bound] {kernel} {name}: bytes={work[0]} flop={work[1]} "
              f"bound_ms={entry['bound_ms']!r} ({entry['bound_by']}) "
              f"share_of_bound={entry['bound_ms'] / ms!r}{lib}", flush=True)
        results[kernel].append(entry)

    def control(kernel, name, got, want):
        """A planted fault: the tolerance check must reject it."""
        ulps = bf16_ulp_err(got, want)
        print(f"[control] {kernel} {name}: ulp_err={ulps!r} (limit "
              f"{ULP_LIMIT}) rejected={ulps > ULP_LIMIT}", flush=True)
        if not ulps > ULP_LIMIT:
            raise AssertionError(f"the tolerance check passes a planted "
                                 f"fault ({kernel} {name}): it is too loose")

    def bounded_work(seg, bounds, iters, h, d):
        visited = T.flash_steps_plain(seg, seg, False, bounds,
                                      iters)[0].numpy()
        return flash_work(visited.sum(), valid_pairs(seg, visited, False), h,
                          d)

    def bounded_rate(seg, bounds, iters, h, d):
        visited, useful = bounded_work(seg, bounds, iters, h, d)
        return lambda ms: (f"visited_tflops={tflops(visited, ms)!r} "
                           f"valid_pair_tflops={tflops(useful, ms)!r}")

    def seg_mask(seg):
        """[1, 1, S, S] bool: same nonzero segment (the library call's
        mask)."""
        return ((seg[0, :, None] == seg[0, None, :])
                & (seg[0, None, :] > 0))[None, None]

    def causal_mask(seg):
        """[1, 1, T, T] bool: the segment mask and i >= j (the causal LM
        prefill's library call: causal plus padding, GQA)."""
        n = seg.shape[1]
        return seg_mask(seg) & torch.ones(n, n, dtype=torch.bool,
                                          device=seg.device).tril()


    p = engine._prep_vision(input_ids, pixels, grid)
    vb = p.vb
    h, d = cfg.vision.num_heads, cfg.vision.head_dim
    for dd in (d, 128):  # the ViT's head dim, and K3's padded one
        wgmma_build_report(dd)
    s = vb.pixel_values.shape[0]
    print(f"[kernel] image grid {grid.tolist()} patches {vb.num_patches} "
          f"bucket {s} merged {vb.num_merged} window_diag {vb.window_diag}")
    q, k, v = rnd(1, s, h, d), rnd(1, s, h, d), rnd(1, s, h, d)

    # Flash, ViT full-attention layers (per-image segment, kv-tile bounds).
    fseg, fb = ivec(vb.full_seg_ids), torch.as_tensor(vb.full_kv_bounds,
                                                       device=dev)
    iters = vb.full_kv_iters or None
    pad = np.where(vb.full_seg_ids == 0)[0]
    qkvo_bytes = 4 * s * h * d * 2  # q, k, v read and out written, bf16
    case("flash_varlen_fwd", f"vit_full S={s} H={h} D={d}",
         lambda: A.flash_varlen_fwd(q, k, v, fseg, fseg, kv_bounds=fb,
                                    kv_iters=iters),
         lambda: A.flash_plain(q, k, v, fseg, fseg, kv_bounds=fb,
                               kv_iters=iters), pad,
         bounded_rate(vb.full_seg_ids, vb.full_kv_bounds, iters, h, d),
         (qkvo_bytes + 2 * s * 4, bounded_work(
             vb.full_seg_ids, vb.full_kv_bounds, iters, h, d)[1]),
         lambda: sdpa_ms(q, k, v, seg_mask(fseg)))
    # Planted faults at this shape: every q tile's last (or first) kv tile
    # dropped from the bounds, against the plain version on true bounds;
    # a tile of image and padding rows marked uniform in the q and kv
    # tile_segs, so its steps skip the mask.
    want = A.flash_plain(q, k, v, fseg, fseg, kv_bounds=fb, kv_iters=iters)
    live = (fb[:, 1] > fb[:, 0]).int()
    for name, shift in (("last kv tile dropped", [0, -1]),
                        ("first kv tile dropped", [1, 0])):
        bad = fb + live[:, None] * torch.tensor(shift, device=dev)
        control("flash_varlen_fwd", f"vit_full {name}",
                A.flash_varlen_fwd(q, k, v, fseg, fseg, kv_bounds=bad,
                                   kv_iters=iters), want)
    forced = T.tile_seg_plain(fseg[0])
    mixed = [t for t in range(len(forced)) if forced[t] < 0
             and (fseg[0, t * TILE:(t + 1) * TILE] > 0).any()]
    t0 = mixed[0] * TILE
    forced[mixed[0]] = int(fseg[0, t0:t0 + TILE].max())
    control("flash_varlen_fwd", f"vit_full tile {mixed[0]} (image and "
            f"padding rows) forced onto the mask-free step",
            A._launch_flash("flash_varlen_fwd", q, k, v, fseg, fseg, False,
                            None, fb, iters,
                            tile_seg=(forced[None], forced[None]))[0], want)
    flash_phases("flash_varlen_fwd", f"vit_full S={s} H={h} D={d}", q, k, v,
                 fseg, vb.full_kv_bounds, iters)

    # Diag, ViT window layers (aligned window segments).
    wseg_np = np.asarray(vb.window_seg_ids)
    wseg = ivec(wseg_np)
    pad = np.where(wseg_np == 0)[0]
    window_pairs = int(sum((wseg_np == i).sum() ** 2
                           for i in np.unique(wseg_np) if i > 0))
    # The bytes it must move: q, k, v read for the rows of a window (not
    # for padding rows), out written and seg read for every row.
    diag_bytes = diag_floor.needed_bytes(wseg, h, d)
    case("diag_attn_fwd", f"vit_window S={s} H={h} D={d}",
         lambda: A.diag_attn_fwd(q, k, v, wseg),
         lambda: A.diag_plain(q, k, v, wseg), pad,
         lambda ms: f"tb_s={diag_bytes / (ms * 1e-3) / 1e12!r}",
         (diag_bytes, 4 * d * h * window_pairs),
         lambda: sdpa_ms(q, k, v, seg_mask(wseg)))
    # Planted fault: the last key of every window masked out for the
    # kernel; compared on the other rows of each window.
    ids, first_rev = np.unique(wseg_np[::-1], return_index=True)
    last = (len(wseg_np) - 1 - first_rev)[ids > 0]
    cut = wseg_np.copy()
    cut[last] = 0
    keep = np.setdiff1d(np.arange(s), last)
    control("diag_attn_fwd", "vit_window last key of each window dropped",
            A.diag_attn_fwd(q, k, v, ivec(cut))[:, keep],
            A.diag_plain(q, k, v, wseg)[:, keep])
    check_diag((q, k, v), wseg, window_pairs, dict(
        case=case, control=control, seg_mask=seg_mask))

    # Flash, LM causal prefill (GQA 16/2, valid-prefix segments) at the
    # compacted lengths of this request: selector 0.2 and orig.
    tc = cfg.text
    valid_sel = p.num_text + p.k
    lengths = [(p.k_max + p.t_text_bucket, valid_sel)]
    orig = engine.__class__(cfg, engine.params, use_selector=False,
                            device=dev)._prep_vision(input_ids, pixels, grid)
    lengths.append((orig.k_max + orig.t_text_bucket, orig.num_text + orig.k))
    hq = tc.num_attention_heads
    for t, valid in lengths:
        ql = rnd(1, t, hq, tc.head_dim)
        kl = rnd(1, t, tc.num_key_value_heads, tc.head_dim)
        vl = rnd(1, t, tc.num_key_value_heads, tc.head_dim)
        seg = (torch.arange(t, device=dev) < valid).int()[None]
        # No bounds: q tile iq visits kv tiles [0, iq + 1) (causal cap), a
        # q tile of padding rows only none.
        nq = -(-t // TILE)
        n_steps = int(T.flash_steps_plain(seg[0], seg[0], True)[0].sum())
        visited, useful = flash_work(n_steps, valid * (valid + 1) // 2, hq,
                                     tc.head_dim)
        case("flash_varlen_fwd",
             f"lm_prefill T={t} valid={valid} Hq={hq} "
             f"Hkv={tc.num_key_value_heads} D={tc.head_dim}",
             lambda: A.flash_varlen_fwd(ql, kl, vl, seg, seg, causal=True),
             lambda: A.flash_plain(ql, kl, vl, seg, seg, causal=True),
             np.arange(valid, t),
             lambda ms, v_=visited, u_=useful: (
                 f"visited_tflops={tflops(v_, ms)!r} "
                 f"valid_pair_tflops={tflops(u_, ms)!r}"),
             ((2 * hq + 2 * tc.num_key_value_heads) * t * tc.head_dim * 2
              + t * 8, useful),
             lambda ql=ql, kl=kl, vl=vl, seg=seg: sdpa_ms(
                 ql, kl, vl, causal_mask(seg)))
        flash_phases("flash_varlen_fwd", f"lm_prefill T={t} valid={valid}",
                     ql, kl, vl, seg, None, None, causal=True)
        if (t, valid) != lengths[-1] or not valid % TILE:
            continue
        # Planted faults at the orig length: each q tile's diagonal kv tile
        # cut from the bounds; the q tile of valid and padding rows marked
        # uniform, so its steps below the diagonal skip the mask.
        want = A.flash_plain(ql, kl, vl, seg, seg, causal=True)
        iq = torch.arange(nq, device=dev)
        cut = torch.stack([torch.zeros_like(iq), iq], 1).int()
        control("flash_varlen_fwd", f"lm_prefill T={t} diagonal kv tile "
                f"cut from every q tile",
                A.flash_varlen_fwd(ql, kl, vl, seg, seg, causal=True,
                                   kv_bounds=cut), want)
        ts = T.tile_seg_plain(seg[0])
        forced = ts.clone()
        forced[valid // TILE] = 1
        control("flash_varlen_fwd", f"lm_prefill T={t} q tile "
                f"{valid // TILE} (valid and padding rows) forced onto the "
                f"mask-free step",
                A._launch_flash("flash_varlen_fwd", ql, kl, vl, seg, seg,
                                True, None, None, None,
                                tile_seg=(forced[None], ts[None]))[0], want)

    # Flash at the 16,384 bucket with a kv_iters cap (per-frame segments of
    # an 8-frame clip, classic layout): the cap the engine computes, and a
    # truncating one (the contract: a q tile sees [lo, min(hi, lo+iters))).
    big_grid = np.asarray([[8, 36, 52]])
    n_big = int(np.prod(big_grid))
    vbig = build_vision_batch(
        np.zeros((n_big, cfg.vision.patch_dim), np.float32), big_grid,
        window_size=cfg.vision.window_size, pad_to=16384)
    span = int((vbig.full_kv_bounds[:, 1] - vbig.full_kv_bounds[:, 0]).max())
    qb, kb, vb_ = (rnd(1, 16384, h, d) for _ in range(3))
    bseg = ivec(vbig.full_seg_ids)
    bb = torch.as_tensor(vbig.full_kv_bounds, device=dev)
    pad = np.where(vbig.full_seg_ids == 0)[0]
    for iters in (vbig.full_kv_iters, span // 4):
        # The library yardstick (K2's main case): one call with the 8-frame
        # segment mask, a 16,384^2 bool tensor (256 MiB).
        library = (None if iters != vbig.full_kv_iters else
                   lambda: sdpa_ms(qb, kb, vb_, seg_mask(bseg)))
        case("flash_varlen_fwd",
             f"streamed S=16384 frames=8 span={span} kv_iters={iters}",
             lambda: A.flash_varlen_fwd(qb, kb, vb_, bseg, bseg,
                                        kv_bounds=bb, kv_iters=iters),
             lambda: A.flash_plain(qb, kb, vb_, bseg, bseg, kv_bounds=bb,
                                   kv_iters=iters), pad,
             bounded_rate(vbig.full_seg_ids, vbig.full_kv_bounds, iters, h,
                          d),
             (4 * 16384 * h * d * 2 + 2 * 16384 * 4, bounded_work(
                 vbig.full_seg_ids, vbig.full_kv_bounds, iters, h, d)[1]),
             library)
        flash_phases("flash_varlen_fwd", f"streamed S=16384 kv_iters={iters}",
                     qb, kb, vb_, bseg, vbig.full_kv_bounds, iters)
    del qb, kb, vb_
    check_decode(cfg, rnd, case, control)
    kit = dict(rnd=rnd, case=case, control=control, seg_mask=seg_mask,
               causal_mask=causal_mask, bounded_work=bounded_work,
               bounded_rate=bounded_rate)
    check_fused(cfg, vb, kit)
    check_packed(cfg, vb, (q, k, v), lengths, kit)
    check_ablate(kit)
    return {name: dict(rs[0], max_abs_err=max(r["max_abs_err"] for r in rs))
            for name, rs in results.items()}


def check_diag(qkv, wseg, window_pairs, kit):
    """Phase 2, window kernel (K4), after its main case: a mixed tile (a
    partial window and padding rows) forced onto the mask-free path through
    the wrapper's tile-kind hook, a planted fault that must fail the check;
    the "packed" window layer (heads of 80 zero-padded to dp = 128, q and k
    contiguous, v a view of the padded qkv slab, the real 80 ** -0.5
    scale) with its bound and one SDPA call on the same padded inputs; the
    kernel's ptxas lines, shared memory, ring, blocks per SM and grid at D
    = 80 and 128; then ``tools/diag_floor``'s breakdown (full, no store, no
    math, empty launch) at both head dims."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from visionselector_tpu_torch.kernels import _build
    from visionselector_tpu_torch.kernels import attention as A
    from visionselector_tpu_torch.kernels import tiles as T
    from visionselector_tpu_torch.tools import diag_floor

    q, k, v = qkv
    _, s, h, d = q.shape
    dp = 128
    want = A.diag_plain(q, k, v, wseg)
    kinds = T.diag_tile_kinds_plain(wseg.cpu())
    counts = torch.bincount(kinds.flatten(), minlength=3).tolist()
    print(f"[kernel] diag_attn_fwd tile kinds: uniform {counts[T.DIAG_UNIFORM]}"
          f" mixed {counts[T.DIAG_MIXED]} padding {counts[T.DIAG_PAD]}",
          flush=True)
    forced = kinds.clone()
    mixed = int((kinds[0] == T.DIAG_MIXED).nonzero()[0])
    forced[0, mixed] = T.DIAG_UNIFORM
    kit["control"]("diag_attn_fwd", f"vit_window tile {mixed} (a partial "
                   f"window and padding rows) forced onto the mask-free path",
                   A._launch_diag(q, k, v, wseg, tile_kind=forced), want)

    pad = np.where(wseg[0].cpu().numpy() == 0)[0]
    qp, kp = (F.pad(x, (0, dp - d)) for x in (q, k))
    slab = torch.zeros(s, 3, h, dp, dtype=v.dtype, device=v.device)
    slab[:, 2, :, :d] = v[0]
    vp = slab[:, 2][None]
    scale = d**-0.5
    nbytes = diag_floor.needed_bytes(wseg, h, dp)
    kit["case"](
        "diag_attn_fwd", f"vit_window_packed S={s} H={h} dp={dp} (real D={d},"
        f" v a slab view)",
        lambda: A.diag_attn_fwd(qp, kp, vp, wseg, scale=scale),
        lambda: A.diag_plain(qp, kp, vp, wseg, scale=scale), pad,
        lambda ms: f"tb_s={nbytes / (ms * 1e-3) / 1e12!r}",
        (nbytes, 4 * d * h * window_pairs),
        lambda: sdpa_ms(qp, kp, vp, kit["seg_mask"](wseg), scale=scale))
    out = A.diag_attn_fwd(qp, kp, vp, wseg, scale=scale)
    if not (out[..., d:] == 0).all():
        raise AssertionError("diag_attn_fwd (packed): pad columns of the "
                             "output are not exactly 0")

    lib = _build.load()
    for dd in (d, dp):
        for kname, usage in ptxas_report("diag_attn_fwd",
                                         f"ILi{dd}E").items():
            print(f"[build] {kname}: {usage}", flush=True)
        smem, per_sm, stages, wgs, sms = (
            lib.vst_diag_attn_query(dd, w) for w in range(5))
        items = s // TILE * h
        print(f"[build] diag_attn_fwd D={dd}: dynamic shared memory {smem} "
              f"bytes, ring {stages} stages, {wgs} consumer warpgroup(s) + "
              f"1 producer warp, {per_sm} blocks per SM x {sms} SMs, grid "
              f"{min(items, per_sm * sms)} for {items} items", flush=True)
    diag_floor.main(["--variants", "full,no_store,no_math,empty",
                     "--dims", f"{d},{dp}"])


def check_decode(cfg, rnd, case, control):
    """Phase 2, decode kernel: an 8-slot pool at the 3B decoder's widths,
    bf16 and int8, t_c 1 and 4, and one slot at the one-shot ``orig``
    cache, against its plain version and its schedule's plain mirror
    (``decode_split_plain`` at the kernel's cluster size); three planted
    faults; its time at four live lengths of the same pool, with the
    intercept and slope; ptxas, cluster size and occupancy at D = 128."""
    import numpy as np
    import torch

    from visionselector_tpu_torch.kernels import _build
    from visionselector_tpu_torch.kernels import attention as A
    from visionselector_tpu_torch.models.qwen25vl.lm import quantize_kv

    dev = "cuda"
    tc = cfg.text
    hq, hkv, dh = tc.num_attention_heads, tc.num_key_value_heads, tc.head_dim
    lib = _build.load()
    for quant in (False, True):
        for kname, usage in ptxas_report("decode_blocked_fwd",
                                         f"ILi{dh}ELb{int(quant)}E").items():
            print(f"[build] {kname}: {usage}", flush=True)
        for t_c in (1, 4, 16, 32):
            shape = (t_c, hq, hkv, dh, int(quant))
            c = A.decode_cluster_size(dev, POOL_SLOTS, t_c, hq, hkv, dh,
                                      quant)
            print(f"[build] decode_blocked_fwd D={dh} "
                  f"{'int8' if quant else 'bf16'} t_c={t_c}: cluster "
                  f"{c} (B={POOL_SLOTS}), "
                  f"{A.decode_cluster_size(dev, 1, t_c, hq, hkv, dh, quant)}"
                  f" (B=1); dynamic shared memory "
                  f"{lib.vst_decode_blocked_query(*shape, c, 2)} bytes, "
                  f"{lib.vst_decode_blocked_query(*shape, c, 1)} blocks per "
                  f"SM, {lib.vst_decode_blocked_query(*shape, c, 0)} "
                  f"clusters resident", flush=True)

    def work(base, t_c, quant, t):
        """(bytes of the live prefix + q + out, flop) for these lengths."""
        keys = torch.minimum(base[:, None] + torch.arange(
            1, t_c + 1, device=dev), torch.tensor(t, device=dev))
        live = int(keys[:, -1].sum())
        per_key = hkv * dh * (1 if quant else 2) * 2 + (hkv * 8 if quant
                                                        else 0)
        qo = 2 * base.shape[0] * t_c * hq * dh * 2
        return live * per_key + qo, 4 * hq * dh * int(keys.sum())

    def mask(base, t_c, t):
        """[B, 1, t_c, T]: chunk row i sees positions < base + i + 1
        (causal within the chunk, and the length mask)."""
        lim = base[:, None] + torch.arange(1, t_c + 1, device=dev)
        return (torch.arange(t, device=dev) < lim[..., None])[:, None]

    def split_check(name, q, kc, vc, b, sc, t_c, quant):
        """The kernel against its schedule's mirror at its cluster size."""
        c = A.decode_cluster_size(dev, q.shape[0], t_c, hq, hkv, dh, quant)
        ulps = bf16_ulp_err(A.decode_blocked_fwd(q, kc, vc, b, **sc),
                            A.decode_split_plain(q, kc, vc, b, cluster=c,
                                                 **sc))
        print(f"[kernel] decode_blocked_fwd {name} against decode_split_plain"
              f" (cluster {c}): ulp_err={ulps!r} (limit {ULP_LIMIT})",
              flush=True)
        if not ulps <= ULP_LIMIT:
            raise AssertionError(f"decode {name}: {ulps} ulps from "
                                 f"decode_split_plain")

    t = POOL_ROWS
    kp, vp = rnd(POOL_SLOTS, t, hkv, dh), rnd(POOL_SLOTS, t, hkv, dh)
    (k8, ks), (v8, vs) = quantize_kv(kp), quantize_kv(vp)
    lens = torch.tensor(DECODE_LENS, device=dev)
    k1, v1 = rnd(1, ORIG_CACHE_ROWS, hkv, dh), rnd(1, ORIG_CACHE_ROWS, hkv, dh)
    (k18, k1s), (v18, v1s) = quantize_kv(k1), quantize_kv(v1)
    one = torch.tensor([ORIG_BASE_LEN], device=dev)
    pools = [(POOL_SLOTS, t, lens, (kp, vp, k8, ks, v8, vs)),
             (1, ORIG_CACHE_ROWS, one, (k1, v1, k18, k1s, v18, v1s))]
    for n_slots, rows, slot_lens, (kb, vb, kq, ksq, vq, vsq) in pools:
        for quant in (False, True):
            kc, vc = (kq, vq) if quant else (kb, vb)
            sc = dict(k_scale=ksq, v_scale=vsq) if quant else {}
            for t_c in (1, 4):
                base = slot_lens if t_c == 1 else (slot_lens - t_c).clamp(
                    min=0)
                q = rnd(n_slots, t_c, hq, dh)
                nbytes, flop = work(base, t_c, quant, rows)
                library = None
                if not quant:
                    library = (lambda q=q, kb=kb, vb=vb,
                               m=mask(base, t_c, rows): sdpa_ms(q, kb, vb, m))
                name = (f"{'int8' if quant else 'bf16'} t_c={t_c} "
                        f"B={n_slots} T={rows} Hq={hq} Hkv={hkv} D={dh} "
                        f"lens={base.tolist()}")
                case("decode_blocked_fwd", name,
                     lambda q=q, b=base, kc=kc, vc=vc, sc=sc:
                         A.decode_blocked_fwd(q, kc, vc, b, **sc),
                     lambda q=q, b=base, kc=kc, vc=vc, sc=sc:
                         A.decode_blocked_plain(q, kc, vc, b, **sc), [],
                     lambda ms, n=nbytes:
                         f"live_tb_s={n / (ms * 1e-3) / 1e12!r}",
                     (nbytes, flop), library)
                split_check(name, q, kc, vc, base, sc, t_c, quant)
    q = rnd(POOL_SLOTS, 1, hq, dh)
    want = A.decode_blocked_plain(q, kp, vp, lens)
    cut = lens.clone()
    cut[5] -= 1
    control("decode_blocked_fwd", f"slot 5 base_len {DECODE_LENS[5]} - 1",
            A.decode_blocked_fwd(q, kp, vp, cut), want)
    tile_cut = ((lens + TILE) // TILE - 1) * TILE - 1
    control("decode_blocked_fwd", "last live tile of every slot skipped",
            A.decode_blocked_fwd(q, kp, vp, tile_cut), want)
    c = A.decode_cluster_size(dev, POOL_SLOTS, 1, hq, hkv, dh, False)
    control("decode_blocked_fwd", f"the last of {c} ranks left out of the "
            f"cluster merge", A._decode_launch(q, kp, vp, lens,
                                               drop_rank=c - 1), want)
    # The chunked decode of multiple-choice scoring (run_loglikelihood_choices
    # runs lm_decode_chunk at t_c = c_max rows per slot): one slot of the
    # orig cache, based at its 1,302 valid rows, at 0 and straddling a tile
    # edge; R = t_c x 8 query rows per kv head in row groups of 32.
    kname = "decode_blocked_fwd_t_c32"
    for t_c in (32, 16):
        for quant in (False, True):
            kc, vc = (k18, v18) if quant else (k1, v1)
            sc = dict(k_scale=k1s, v_scale=v1s) if quant else {}
            for b0 in (ORIG_BASE_LEN, 0, 2 * TILE - t_c // 2):
                base = torch.tensor([b0], device=dev)
                qc = rnd(1, t_c, hq, dh)
                nbytes, flop = work(base, t_c, quant, ORIG_CACHE_ROWS)
                library = None
                if not quant:
                    library = (lambda q=qc, m=mask(base, t_c, ORIG_CACHE_ROWS):
                               sdpa_ms(q, k1, v1, m))
                name = (f"{'int8' if quant else 'bf16'} t_c={t_c} B=1 "
                        f"T={ORIG_CACHE_ROWS} Hq={hq} Hkv={hkv} D={dh} "
                        f"base={b0} row_groups="
                        f"{A.decode_rows(t_c, hq // hkv)[1]}")
                case(kname, name,
                     lambda q=qc, b=base, kc=kc, vc=vc, sc=sc:
                         A.decode_blocked_fwd(q, kc, vc, b, **sc),
                     lambda q=qc, b=base, kc=kc, vc=vc, sc=sc:
                         A.decode_blocked_plain(q, kc, vc, b, **sc), [],
                     lambda ms, n=nbytes:
                         f"live_tb_s={n / (ms * 1e-3) / 1e12!r}",
                     (nbytes, flop), library)
                split_check(name, qc, kc, vc, base, sc, t_c, quant)
    qc = rnd(1, 32, hq, dh)
    control(kname, "chunk row i sees position base + i + 1",
            A.decode_blocked_fwd(qc, k1, v1, one + 1),
            A.decode_blocked_plain(qc, k1, v1, one))
    for quant in (False, True):
        kc, vc = (k8, v8) if quant else (kp, vp)
        sc = dict(k_scale=ks, v_scale=vs) if quant else {}
        times, nbytes = {}, {}
        for n in DECODE_SWEEP:
            base = torch.full((POOL_SLOTS,), max(n - 1, 0), device=dev)
            times[n] = cuda_ms(lambda b=base: A.decode_blocked_fwd(
                q, kc, vc, b, **sc), n=2 * N_TIMED)
            # ten launches back to back: the per-launch time without the
            # gap before a lone launch
            run10 = cuda_ms(lambda b=base: [A.decode_blocked_fwd(
                q, kc, vc, b, **sc) for _ in range(10)]) / 10
            nbytes[n], _ = work(base, 1, quant, t)
            b_ms, _ = bound_ms(nbytes[n], 0)
            print(f"[kernel] decode_blocked_fwd {'int8' if quant else 'bf16'}"
                  f" every slot at length {n} of {t}: ms={times[n]!r} "
                  f"back_to_back_ms={run10!r} bytes={nbytes[n]} "
                  f"bound_ms={b_ms!r}", flush=True)
        slope, icpt = (float(x) for x in np.polyfit(
            [nbytes[n] / 1e6 for n in DECODE_SWEEP],
            [times[n] for n in DECODE_SWEEP], 1))
        print(f"[kernel] decode_blocked_fwd {'int8' if quant else 'bf16'} "
              f"over lengths {DECODE_SWEEP}: intercept_ms={icpt!r} "
              f"slope_ms_per_MB={slope!r} (the card's rate "
              f"{1e9 / HBM_BYTES_S!r})", flush=True)
        if not times[2000] > times[256]:
            raise AssertionError("decode kernel time does not grow with the "
                                 f"live length: {times}")


def ptxas_report(*parts) -> dict:
    """{kernel: its ptxas lines (registers, barriers, static shared memory,
    stack and spills)} for the kernels whose mangled name holds every one
    of ``parts``, from the report the build saved beside the library."""
    from visionselector_tpu_torch.kernels import _build

    with open(_build.library_path() + ".ptxas.txt") as f:
        log = f.read()
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = m.group(1) if all(x in m.group(1) for x in parts) else None
            if cur:
                out[cur] = []
        elif cur and ("Used" in line or "spill" in line):
            out[cur].append(line.split(":", 1)[-1].strip())
    return {k: "; ".join(v) for k, v in out.items()}


def wgmma_build_report(d):
    """The ptxas lines of the wgmma route's kernels for head dim d (the
    flash route's prologue and main-loop variants
    ``flash_wgmma_main_kernel<D, kMask, kExp, kCausal>``, the fused
    kernel's), the main loop's dynamic shared memory and its blocks per SM
    (non-causal and causal)."""
    from visionselector_tpu_torch.kernels import _build

    lib = _build.load()
    for parts in (("flash_images_prologue",), ("flash_wgmma_main",),
                  ("fused",)):
        for kname, usage in ptxas_report(*parts, f"ILi{d}E").items():
            print(f"[build] {kname}: {usage}", flush=True)
    print(f"[build] wgmma main loop D={d}: dynamic shared memory "
          f"{lib.vst_wgmma_main_smem_bytes(d)} bytes, "
          f"{lib.vst_wgmma_main_blocks_per_sm(d, 0)} blocks per SM, causal "
          f"{lib.vst_wgmma_main_blocks_per_sm(d, 1)}", flush=True)


def wgmma_phases(kernel, name, run, plain_images, steps, pro_bytes,
                 main_work):
    """The two launches of one wgmma-route call (a prologue, then the main
    loop): the prologue's tile images and tile_segs against their plain
    versions bit for bit; the share of visited kv tiles whose step is
    mask-free; the prologue and the main loop timed apart, each beside its
    bound. ``run(phases, scratch)`` -> (out, scratch); ``steps``: (visited,
    mask_free) [nq, nk] bool, the main loop's schedule
    (``tiles.flash_steps_plain`` on the tile_segs the images check holds
    equal); ``pro_bytes``: the prologue's bytes; ``main_work``: (bytes,
    flop) of the main loop. Bounds and inputs are already on the card (a
    host copy inside the timed call would stall it). Returns the line's
    numbers."""
    import torch

    _, scratch = run(3, None)
    torch.cuda.synchronize()
    exact = [torch.equal(a, b) for a, b in zip(scratch, plain_images)]
    visited, interior = (int(x.sum()) for x in steps)
    share = interior / max(visited, 1)
    print(f"[kernel] {kernel} {name} prologue images and tile_segs equal "
          f"the plain ones bit for bit: {exact}; visited kv tiles {visited},"
          f" mask-free {interior}, share {share!r}", flush=True)
    if not all(exact):
        raise AssertionError(f"{kernel} {name}: the prologue disagrees with "
                             f"its plain version")
    times = {st: cuda_ms(lambda st=st: run(st, scratch)) for st in (1, 2)}
    pro, main = bound_ms(pro_bytes, 0), bound_ms(*main_work)
    print(f"[kernel] {kernel} {name} prologue_ms={times[1]!r} bound_ms="
          f"{pro[0]!r} ({pro[1]}) main_ms={times[2]!r} bound_ms={main[0]!r} "
          f"({main[1]}) share_of_bound prologue={pro[0] / times[1]!r} "
          f"main={main[0] / times[2]!r}", flush=True)
    return dict(prologue_ms=times[1], main_ms=times[2], share=share)


def valid_pairs(seg_np, visited, causal):
    """(query, key) pairs inside the visited tiles ([nq, nq] bool) that the
    mask lets through for one seg [S] of queries and keys: the same nonzero
    segment and, when causal, query row >= key (counted densely; the causal
    calls are the LM prefill's, S <= 2,048)."""
    import numpy as np

    nt = visited.shape[0]
    rows = np.zeros(nt * TILE, np.int64)
    rows[:len(seg_np)] = seg_np
    if causal:
        n = nt * TILE
        ok = ((rows[:, None] == rows[None]) & (rows[None] > 0)
              & (np.arange(n)[:, None] >= np.arange(n)[None]))
        per_tile = ok.reshape(nt, TILE, nt, TILE).sum((1, 3))
    else:
        tiles = rows.reshape(nt, TILE)
        counts = np.stack([(tiles == i).sum(1) for i in np.unique(rows)
                           if i > 0], 1)
        per_tile = counts @ counts.T
    return int((per_tile * visited).sum())


def flash_phases(kernel, name, q, k, v, seg, bounds_np, iters, d_real=None,
                 ablate=None, causal=False):
    """``wgmma_phases`` for a flash-route call on [1, S, H, D] q and [1, S,
    H_kv, D] k, v with one seg [1, S] for queries and keys: bounds (numpy,
    or None for the full range), a kv_iters cap, the causal mask,
    ``ablate=(do_mask, do_exp)`` for the ablation's variants. Bytes: q, k,
    v and seg read, the images and tile_segs written (prologue); the
    images, segs, tile_segs and bounds read and out written (main loop);
    flop of the valid pairs at the real head dim ``d_real`` (every pair of
    every visited tile without the mask)."""
    import torch

    from visionselector_tpu_torch.kernels import attention as A
    from visionselector_tpu_torch.kernels import tiles as T

    _, s, h, d = q.shape
    h_kv = k.shape[2]
    nt, dp = -(-s // TILE), T.padded_head_dim(d)
    d_real = d_real or d
    bounds = (None if bounds_np is None
              else torch.as_tensor(bounds_np, device="cuda"))
    if ablate is None:
        def run(phases, scratch):
            return A._launch_flash(kernel, q, k, v, seg, seg, causal,
                                   d_real**-0.5, bounds, iters,
                                   phases=phases, scratch=scratch)
    else:
        def run(phases, scratch):
            return A._launch_ablate(q, k, v, seg, *ablate, d_real**-0.5,
                                    phases=phases, scratch=scratch)
    visited, mask_free = (x.cpu().numpy() for x in T.flash_steps_plain(
        seg[0], seg[0], causal, bounds_np, iters))
    if ablate is None:
        pairs = valid_pairs(seg[0].cpu().numpy(), visited, causal)
    else:  # the ablation's function: every pair of every visited tile
        pairs = int(visited.sum()) * TILE * TILE
        if not ablate[0]:
            mask_free = visited
    img_bytes = (h + 2 * h_kv) * nt * TILE * dp * 2
    qkv_bytes = (h + 2 * h_kv) * s * d * 2
    return wgmma_phases(
        kernel, name, run,
        T.flash_images_plain(q, k, v, seg, seg), (visited, mask_free),
        qkv_bytes + s * 4 + img_bytes + 2 * nt * 4,
        (img_bytes + s * h * d * 2 + s * 4 + 2 * nt * 4 + nt * 8,
         4 * d_real * h * pairs))


def check_fused(cfg, vb, kit):
    """Phase 2, fused rotary + attention kernel (K6) on the 6,144 bucket:
    the qkv slab of a ViT layer with full bounds (main case) and window
    bounds. For each: the prologue's tile images against the plain
    prologue (bit for bit) and its tile_seg against the plain one; the
    prologue and the main loop timed apart beside their bounds; the share
    of visited kv tiles that took the mask-free step. Planted faults: the
    last kv tile dropped from the full bounds, the plain version rotating k
    with the next row's cos/sin, and a tile that holds padding rows marked
    uniform so the main loop skips its mask."""
    import numpy as np
    import torch

    from visionselector_tpu_torch.kernels import attention as A
    from visionselector_tpu_torch.kernels import fused_vit_attn as F_
    from visionselector_tpu_torch.kernels import tiles as T
    from visionselector_tpu_torch.models.qwen25vl.vit import (
        apply_rotary,
        vision_rotary_cos_sin,
    )

    dev = "cuda"
    h, d = cfg.vision.num_heads, cfg.vision.head_dim
    s = vb.pixel_values.shape[0]
    qkv = kit["rnd"](s, 3 * h * d)
    cos, sin = (x.bfloat16() for x in vision_rotary_cos_sin(
        torch.as_tensor(np.asarray(vb.rot_pos_ids), device=dev), d))

    def rotated(k_shift=0):
        """q, k, v [1, S, H, d] as the plain version rotates them (k with
        the cos/sin of row i + k_shift when k_shift != 0)."""
        q, k, v = qkv.view(s, 3, h, d).unbind(1)
        q, _ = apply_rotary(q, q, cos, sin)
        _, k = apply_rotary(k, k, cos.roll(-k_shift, 0), sin.roll(-k_shift, 0))
        return q[None], k[None], v[None]

    # bytes: the slab and cos/sin read, out written (bf16), seg and bounds.
    nbytes = (3 * s * h * d + 2 * s * d + s * h * d) * 2 + s * 4 + s // 8
    nt, dp = -(-s // TILE), F_.padded_head_dim(d)
    img_bytes = 3 * h * nt * TILE * dp * 2  # the three tile images, bf16

    def phases(name, seg, seg_np, bounds, bounds_np):
        """The prologue's images and tile_seg against prologue_plain bit for
        bit, the two launches timed apart, the mask-free share. Prologue:
        the slab, cos/sin and seg read, the images and tile_seg written;
        main loop: the images, seg, tile_seg and bounds read, out written,
        the flop of the valid pairs."""
        wgmma_phases(
            "fused_vit_attn_fwd", name,
            lambda ph, sc: F_._launch(qkv, seg, cos, sin, bounds, h, d,
                                      d**-0.5, phases=ph, scratch=sc),
            (*F_.prologue_plain(qkv, cos, sin, h, d), F_.tile_seg_plain(seg)),
            tuple(x.cpu().numpy() for x in T.flash_steps_plain(
                seg, seg, False, bounds_np)),
            3 * s * h * d * 2 + 2 * s * d * 2 + s * 4 + img_bytes + nt * 4,
            (img_bytes + s * h * d * 2 + s * 4 + nt * 12,
             kit["bounded_work"](seg_np, bounds_np, 0, h, d)[1]))

    for name, seg_np, bounds_np in (
            ("vit_full", vb.full_seg_ids, vb.full_kv_bounds),
            ("vit_window", vb.window_seg_ids, vb.window_kv_bounds)):
        seg = torch.as_tensor(np.asarray(seg_np), device=dev).int()
        bounds = torch.as_tensor(bounds_np, device=dev)
        q, k, v = rotated()
        kit["case"](
            "fused_vit_attn_fwd", f"{name} S={s} H={h} D={d} (qkv slab)",
            lambda: F_.fused_vit_attention(qkv, seg, cos, sin, bounds, h,
                                           d).view(1, s, h, d),
            lambda: F_.fused_plain(qkv, seg, cos, sin, bounds, h,
                                   d).view(1, s, h, d),
            np.where(np.asarray(seg_np) == 0)[0],
            kit["bounded_rate"](seg_np, bounds_np, 0, h, d),
            (nbytes, kit["bounded_work"](seg_np, bounds_np, 0, h, d)[1]),
            # the yardstick leaves the rotary out: q and k come rotated
            lambda: sdpa_ms(q, k, v, kit["seg_mask"](seg[None])))
        if name == "vit_full":
            want = F_.fused_plain(qkv, seg, cos, sin, bounds, h, d)
            live = (bounds[:, 1] > bounds[:, 0]).int()
            bad = bounds + live[:, None] * torch.tensor([0, -1], device=dev)
            kit["control"](
                "fused_vit_attn_fwd", "vit_full last kv tile dropped",
                F_.fused_vit_attention(qkv, seg, cos, sin, bad, h,
                                       d).view(1, s, h, d),
                want.view(1, s, h, d))
            q, k, v = rotated(k_shift=1)
            kit["control"](
                "fused_vit_attn_fwd", "vit_full k rotated with the next "
                "row's cos/sin",
                F_.fused_vit_attention(qkv, seg, cos, sin, bounds, h,
                                       d).view(1, s, h, d),
                A.flash_plain(q, k, v, seg[None], seg[None],
                              kv_bounds=bounds))
            # A tile of one image's rows and padding rows, marked uniform.
            forced = F_.tile_seg_plain(seg)
            mixed = [t for t in range(len(forced)) if forced[t] < 0
                     and (seg[t * TILE:(t + 1) * TILE] > 0).any()]
            t0 = mixed[0] * TILE
            forced[mixed[0]] = int(seg[t0:t0 + TILE].max())
            kit["control"](
                "fused_vit_attn_fwd", f"vit_full tile {mixed[0]} (image and "
                f"padding rows) forced onto the mask-free step",
                F_._launch(qkv, seg, cos, sin, bounds, h, d, d**-0.5,
                           tile_seg=forced)[0].view(1, s, h, d),
                want.view(1, s, h, d))
        phases(name, seg, seg_np, bounds, bounds_np)


def check_packed(cfg, vb, qkv_vit, lengths, kit):
    """Phase 2, packed entry point (K3): the ViT full layer with heads of
    80 zero-padded to 128 (main case; the real 80 ** -0.5 scale, the same
    q/k/v as the flash check) and the LM prefill at the compacted lengths.
    Bounds count real-d flop, so the padding's work shows as a gap. Planted
    fault: noise in the pad columns of q and k (noise in q's alone is
    invisible: k's pad columns are zero), which must fail the check, so it
    is shown to see what the pad columns hold."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from visionselector_tpu_torch.kernels import attention as A
    from visionselector_tpu_torch.kernels import tiles as T

    dev, dp = "cuda", 128
    h, d = cfg.vision.num_heads, cfg.vision.head_dim
    s = vb.pixel_values.shape[0]
    fseg = torch.as_tensor(np.asarray(vb.full_seg_ids), device=dev)[None].int()
    fb = torch.as_tensor(vb.full_kv_bounds, device=dev)
    q, k, v = qkv_vit
    qp, kp, vp = (F.pad(x, (0, dp - d)).flatten(2) for x in qkv_vit)

    def packed(qq, kk):
        return A.flash_packed_fwd(qq, kk, vp, fseg, fseg, h, h, dp,
                                  scale=d**-0.5,
                                  kv_bounds=fb).view(1, s, h, dp)

    def plain():
        return A.flash_packed_plain(qp, kp, vp, fseg, fseg, h, h, dp,
                                    scale=d**-0.5,
                                    kv_bounds=fb).view(1, s, h, dp)

    kit["case"](
        "flash_packed_fwd", f"vit_full S={s} H={h} dp={dp} (real D={d})",
        lambda: packed(qp, kp), plain, np.where(vb.full_seg_ids == 0)[0],
        kit["bounded_rate"](vb.full_seg_ids, vb.full_kv_bounds, 0, h, d),
        (4 * s * h * dp * 2 + 2 * s * 4, kit["bounded_work"](
            vb.full_seg_ids, vb.full_kv_bounds, 0, h, d)[1]),
        lambda: sdpa_ms(q, k, v, kit["seg_mask"](fseg)))
    out = packed(qp, kp)
    if not (out[..., d:] == 0).all():
        raise AssertionError("flash_packed_fwd: pad columns of the output "
                             "are not exactly 0")
    noisy = [x.clone().view(1, s, h, dp) for x in (qp, kp)]
    for x in noisy:
        x[..., d:] = kit["rnd"](1, s, h, dp - d)
    kit["control"]("flash_packed_fwd", "vit_full noise in the pad columns "
                   "of q and k",
                   packed(*(x.flatten(2) for x in noisy)), plain())
    flash_phases("flash_packed_fwd", f"vit_full S={s} H={h} dp={dp}",
                 *(A._heads(x, h, dp, n) for x, n in zip((qp, kp, vp), "qkv")),
                 fseg, vb.full_kv_bounds, None, d_real=d)

    tc = cfg.text
    hq, hkv, dh = (tc.num_attention_heads, tc.num_key_value_heads,
                   tc.head_dim)
    for t, valid in lengths:
        ql, kl, vl = (kit["rnd"](1, t, n * dh) for n in (hq, hkv, hkv))
        seg = (torch.arange(t, device=dev) < valid).int()[None]
        n_steps = int(T.flash_steps_plain(seg[0], seg[0], True)[0].sum())
        visited, useful = flash_work(n_steps, valid * (valid + 1) // 2,
                                     hq, dh)
        kit["case"](
            "flash_packed_fwd", f"lm_prefill T={t} valid={valid} Hq={hq} "
            f"Hkv={hkv} dp={dh} (slabs)",
            lambda: A.flash_packed_fwd(ql, kl, vl, seg, seg, hq, hkv, dh,
                                       causal=True).view(1, t, hq, dh),
            lambda: A.flash_packed_plain(ql, kl, vl, seg, seg, hq, hkv, dh,
                                         causal=True).view(1, t, hq, dh),
            np.arange(valid, t),
            lambda ms, v_=visited, u_=useful: (
                f"visited_tflops={tflops(v_, ms)!r} "
                f"valid_pair_tflops={tflops(u_, ms)!r}"),
            ((2 * hq + 2 * hkv) * t * dh * 2 + t * 8, useful),
            lambda q_=ql, k_=kl, v_=vl, t_=t, seg_=seg: sdpa_ms(
                q_.view(1, t_, hq, dh), k_.view(1, t_, hkv, dh),
                v_.view(1, t_, hkv, dh), kit["causal_mask"](seg_)))
        flash_phases("flash_packed_fwd", f"lm_prefill T={t} (slabs)",
                     *(A._heads(x, n, dh, nm) for x, n, nm in zip(
                         (ql, kl, vl), (hq, hkv, hkv), "qkv")),
                     seg, None, None, causal=True)


def check_ablate(kit):
    """Phase 2, the full-attention ablation (K7) at S = 5,632 (16 heads, d
    80, the last 128 rows padding; the bench's inputs): the four variants
    against ``ablate_plain``, every kv tile visited. Main case: mask and
    exp (the production kernel without bounds). Planted fault: the kernel
    without the mask against the masked plain version."""
    import numpy as np

    from visionselector_tpu_torch.kernels import attention as A
    from visionselector_tpu_torch.tools import bench_fullattn_ablate as B

    q, k, v, seg = B.inputs(ABLATE_S)
    s, h, d = ABLATE_S, B.HEADS, B.HEAD_DIM
    flop = 4 * s * s * h * d  # every (query, key) pair of every tile
    nbytes = 4 * s * h * d * 2 + s * 4
    pad = np.arange(s - B.PAD_ROWS, s)
    for do_mask, do_exp in ((True, True), (False, True), (True, False),
                            (False, False)):
        library = None  # no one call computes p = logits (noexp, bare)
        if do_exp:
            mask = kit["seg_mask"](seg) if do_mask else None
            library = lambda m=mask: sdpa_ms(q, k, v, m)  # noqa: E731
        kit["case"](
            "fullattn_ablate_fwd",
            f"S={s} H={h} D={d} mask={do_mask} exp={do_exp}",
            lambda m=do_mask, e=do_exp: A.fullattn_ablate(q, k, v, seg, m, e),
            lambda m=do_mask, e=do_exp: A.ablate_plain(q, k, v, seg, m, e),
            pad if do_mask else [],
            lambda ms: f"tflops={tflops(flop, ms)!r}", (nbytes, flop),
            library)
        flash_phases("fullattn_ablate_fwd",
                     f"S={s} mask={do_mask} exp={do_exp}", q, k, v, seg,
                     None, None, ablate=(do_mask, do_exp))
    valid = slice(0, s - B.PAD_ROWS)  # rows that attend in both
    kit["control"]("fullattn_ablate_fwd", "mask off against the masked "
                   "plain version (valid rows)",
                   A.fullattn_ablate(q, k, v, seg, False, True)[:, valid],
                   A.ablate_plain(q, k, v, seg, True, True)[:, valid])


def launch_counts() -> dict:
    """Every kernel wrapper's launch count, by kernel name."""
    from visionselector_tpu_torch.kernels import attention as A
    from visionselector_tpu_torch.kernels import fused_vit_attn as F_

    return {"flash_varlen_fwd": A.FLASH_LAUNCHES,
            "diag_attn_fwd": A.DIAG_LAUNCHES,
            "decode_blocked_fwd": A.DECODE_LAUNCHES,
            "fused_vit_attn_fwd": F_.FUSED_LAUNCHES,
            "flash_packed_fwd": A.PACKED_LAUNCHES,
            "fullattn_ablate_fwd": A.ABLATE_LAUNCHES}


def zero_counts():
    from visionselector_tpu_torch.kernels import attention as A
    from visionselector_tpu_torch.kernels import fused_vit_attn as F_

    A.FLASH_LAUNCHES = A.DIAG_LAUNCHES = A.DECODE_LAUNCHES = 0
    A.PACKED_LAUNCHES = A.ABLATE_LAUNCHES = F_.FUSED_LAUNCHES = 0
    for route in A.FLASH_ROUTE_LAUNCHES:
        A.FLASH_ROUTE_LAUNCHES[route] = 0


def run_main_path(cfg, params, input_ids, pixels, grid):
    """Phase 3. Returns the launch counts of the main path's run."""
    import torch

    from visionselector_tpu_torch.kernels import attention as A
    from visionselector_tpu_torch.models.qwen25vl.model import QwenVLEngine

    n_full = len(cfg.vision.fullatt_block_indexes)
    want_diag = cfg.vision.depth - n_full
    want_flash = n_full + cfg.text.num_hidden_layers
    want_routes = {"wgmma": n_full + cfg.text.num_hidden_layers}
    engines = {
        "selector": QwenVLEngine(cfg, params, use_selector=True, budget=0.2,
                                 device="cuda"),
        "orig": QwenVLEngine(cfg, params, use_selector=False, device="cuda"),
    }
    # Warm-up (cuBLAS handles, allocator), outside the counted run.
    for eng in engines.values():
        eng.generate(input_ids, pixels, grid, max_new_tokens=2)
    torch.cuda.synchronize()

    zero_counts()
    results = {}
    for name, eng in engines.items():
        f0, d0, k0 = A.FLASH_LAUNCHES, A.DIAG_LAUNCHES, A.DECODE_LAUNCHES
        r0 = dict(A.FLASH_ROUTE_LAUNCHES)
        torch.cuda.reset_peak_memory_stats()
        res = eng.generate(input_ids, pixels, grid,
                           max_new_tokens=MAX_NEW_TOKENS)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        flash, diag = A.FLASH_LAUNCHES - f0, A.DIAG_LAUNCHES - d0
        dec = A.DECODE_LAUNCHES - k0
        routes = {r: n - r0[r] for r, n in A.FLASH_ROUTE_LAUNCHES.items()}
        # decode steps run: one per token after the first, plus the step
        # whose EOS ended the loop early
        steps = (len(res.tokens) - 1 if len(res.tokens) == MAX_NEW_TOKENS
                 else len(res.tokens))
        kept = (len(res.selected_indices) if res.selected_indices is not None
                else res.num_vision_tokens)
        decode_s = res.total_seconds - res.prefill_seconds
        n_decode = len(res.tokens) - 1
        tok_s = n_decode / decode_s if n_decode > 0 else float("nan")
        print(f"[main] {name}: vision_tokens={res.num_vision_tokens} "
              f"kept={kept} prefill_len={res.prefill_len} "
              f"prefill_ms={res.prefill_seconds * 1e3!r} "
              f"decode_tokens={n_decode} decode_tok_s={tok_s!r} "
              f"peak_mem_bytes={peak} launches flash={flash} diag={diag} "
              f"decode={dec} (decode steps {steps}) flash routes {routes}",
              flush=True)
        print(f"[main] {name} tokens: {res.tokens}", flush=True)
        logits = res.logits
        if not (torch.isfinite(logits).all()
                and logits.shape == (cfg.text.vocab_size,)):
            raise AssertionError(f"{name}: first-token logits not finite / "
                                 f"wrong shape {tuple(logits.shape)}")
        if not res.tokens or not all(
                0 <= t < cfg.text.vocab_size for t in res.tokens):
            raise AssertionError(f"{name}: bad tokens {res.tokens}")
        if (flash, diag) != (want_flash, want_diag):
            raise AssertionError(
                f"{name}: kernel launches flash={flash} diag={diag}, "
                f"expected flash={want_flash} ({n_full} ViT full layers + "
                f"{cfg.text.num_hidden_layers} decoder layers) and "
                f"diag={want_diag} (window layers)")
        if dec != cfg.text.num_hidden_layers * steps:
            raise AssertionError(
                f"{name}: decode kernel launches {dec}, expected "
                f"{cfg.text.num_hidden_layers} per decode step x {steps}")
        if routes != want_routes:
            raise AssertionError(
                f"{name}: flash routes {routes}, expected {want_routes} (the "
                f"ViT full layers and the causal decoder layers, all on the "
                f"wgmma route)")
        results[name] = res
    print(f"[main] expected per prefill: flash={want_flash} "
          f"diag={want_diag} flash routes {want_routes}; per decode step: "
          f"decode={cfg.text.num_hidden_layers}", flush=True)
    launches = {"flash_varlen_fwd": A.FLASH_LAUNCHES,
                "diag_attn_fwd": A.DIAG_LAUNCHES,
                "decode_blocked_fwd": A.DECODE_LAUNCHES}

    # The same requests with the plain attention path on the card.
    for name, eng in engines.items():
        plain = QwenVLEngine(cfg, params, use_selector=eng.use_selector,
                             budget=eng.budget, device="cuda",
                             attn_impl="plain")
        res_p = plain.generate(input_ids, pixels, grid, max_new_tokens=1)
        res_k = results[name]
        diff = (res_p.logits - res_k.logits).abs().max().item()
        scale = res_k.logits.abs().max().item()
        line = (f"[plain] {name}: first-token logits max_abs_diff={diff!r} "
                f"(max |logit| {scale!r}) first token kernel="
                f"{res_k.tokens[0]} plain={res_p.tokens[0]}")
        overlap = 1.0
        if res_k.selected_indices is not None:
            a = set(res_k.selected_indices.tolist())
            b = set(res_p.selected_indices.tolist())
            overlap = len(a & b) / len(a)
            line += f" selected overlap {len(a & b)}/{len(a)}"
        print(line, flush=True)
        # orig: bf16 activations through 32 ViT and 36 decoder layers,
        # attention summed in another order — the paths drift apart by a
        # few percent of the logit range; a wrong kernel gives O(range) or
        # non-finite differences. selector: the random-init scorer (std
        # 1e-4) leaves near-ties, so a few kept tokens (and with them the
        # logits) may differ; the kept sets must still mostly agree.
        ok = overlap >= 0.9 if name == "selector" else diff <= 0.1 * scale
        if not ok:
            raise AssertionError(
                f"{name}: kernel and plain paths disagree (logits "
                f"{diff} of {scale}, selection overlap {overlap})")
    return launches


def run_variant_paths(cfg, params, input_ids, pixels, grid):
    """Phase 3, the other attention configurations of the selector request:
    ``attn_variant="fused"`` and ``"packed"``, 32 greedy tokens each, with
    the counters zeroed just before and read just after each run. Per
    image prefill: fused = one fused launch per ViT layer + one flash
    launch per decoder layer, no diag; packed = one diag launch per window
    layer + one packed launch per ViT full layer and per decoder layer (the
    packed wrapper counts PACKED_LAUNCHES only, not FLASH_LAUNCHES); every
    decode step one decode launch per decoder layer. Flash routes per
    prefill: the ViT's full layers (none under "fused") and every decoder
    layer's causal prefill, all on the wgmma route. Each is
    held against the same request with ``attn_impl="plain"`` and the same
    variant, with phase 3's tolerance. Returns each variant's launch counts."""
    import torch

    from visionselector_tpu_torch.kernels import attention as A
    from visionselector_tpu_torch.models.qwen25vl.model import QwenVLEngine

    vc, n_layers = cfg.vision, cfg.text.num_hidden_layers
    n_full = len(vc.fullatt_block_indexes)
    # the decoder takes the packed entry when its head dim is a multiple
    # of 128 (the 3B's 128 is)
    lm_packed = n_layers if cfg.text.head_dim % 128 == 0 else 0
    want = {
        "fused": dict(fused_vit_attn_fwd=vc.depth, flash_varlen_fwd=n_layers,
                      diag_attn_fwd=0, flash_packed_fwd=0,
                      routes={"wgmma": n_layers}),
        "packed": dict(fused_vit_attn_fwd=0,
                       flash_varlen_fwd=n_layers - lm_packed,
                       diag_attn_fwd=vc.depth - n_full,
                       flash_packed_fwd=n_full + lm_packed,
                       routes={"wgmma": n_full + n_layers}),
    }
    out = {}
    for variant, expect in want.items():
        eng = QwenVLEngine(cfg, params, use_selector=True, budget=0.2,
                           device="cuda", attn_variant=variant)
        eng.generate(input_ids, pixels, grid, max_new_tokens=2)  # warm-up
        torch.cuda.synchronize()
        zero_counts()
        res = eng.generate(input_ids, pixels, grid,
                           max_new_tokens=MAX_NEW_TOKENS)
        torch.cuda.synchronize()
        counts = launch_counts()
        counts["routes"] = dict(A.FLASH_ROUTE_LAUNCHES)
        steps = (len(res.tokens) - 1 if len(res.tokens) == MAX_NEW_TOKENS
                 else len(res.tokens))
        n_decode = len(res.tokens) - 1
        decode_s = res.total_seconds - res.prefill_seconds
        print(f"[variant] {variant}: kept={len(res.selected_indices)} "
              f"prefill_len={res.prefill_len} "
              f"prefill_ms={res.prefill_seconds * 1e3!r} decode_tok_s="
              f"{n_decode / decode_s if n_decode else float('nan')!r} "
              f"launches {counts} (decode steps {steps})", flush=True)
        print(f"[variant] {variant} tokens: {res.tokens}", flush=True)
        got = {k: counts[k] for k in expect}
        if got != expect or counts["decode_blocked_fwd"] != n_layers * steps:
            raise AssertionError(
                f"{variant}: launches {counts}, expected {expect} and "
                f"{n_layers} decode launches x {steps} steps")
        if not (torch.isfinite(res.logits).all() and res.tokens and all(
                0 <= t < cfg.text.vocab_size for t in res.tokens)):
            raise AssertionError(f"{variant}: non-finite logits or bad "
                                 f"tokens {res.tokens}")
        plain = QwenVLEngine(cfg, params, use_selector=True, budget=0.2,
                             device="cuda", attn_impl="plain",
                             attn_variant=variant)
        res_p = plain.generate(input_ids, pixels, grid, max_new_tokens=1)
        a = set(res.selected_indices.tolist())
        b = set(res_p.selected_indices.tolist())
        overlap = len(a & b) / len(a)
        diff = (res_p.logits - res.logits).abs().max().item()
        scale = res.logits.abs().max().item()
        print(f"[plain] {variant}: first-token logits max_abs_diff={diff!r}"
              f" (max |logit| {scale!r}) first token kernel={res.tokens[0]} "
              f"plain={res_p.tokens[0]} selected overlap {len(a & b)}/"
              f"{len(a)}", flush=True)
        # phase 3's tolerance: the kept sets mostly agree (near-ties of the
        # random scorer); where they are equal, so is the decoder's input
        # and the logits agree within 0.1 of their range.
        if overlap < 0.9 or (a == b and diff > 0.1 * scale):
            raise AssertionError(
                f"{variant}: kernel and plain paths disagree (logits {diff}"
                f" of {scale}, selection overlap {overlap})")
        out[variant] = counts
        del eng, plain
    return out


def device_busy(trace_path):
    """(busy ms, {kernel name: [ms, count]}) from a torch.profiler chrome
    trace: busy is the union of the device's kernel, copy and memset
    intervals."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    spans, by_name = [], {}
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") \
                and "dur" in e:
            spans.append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
            acc = by_name.setdefault(e["name"], [0.0, 0])
            acc[0] += float(e["dur"]) / 1e3
            acc[1] += 1
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3, by_name


def kernel_group(name: str) -> str:
    """The port's kernels, GEMMs (cuBLAS / cuBLASLt / CUTLASS), copies, or
    the rest (PyTorch's elementwise and reduction kernels)."""
    low = name.lower()
    if "vst::" in name:
        return "vst kernels"
    if any(w in low for w in ("gemm", "xmma", "cutlass", "nvjet")):
        return "gemm"
    return "copies" if low.startswith("mem") else "other"


def traced(fn, path, parse=None):
    """(device busy ms, {kernel name: [ms, count]}, fn's result) of one call
    of ``fn`` under torch.profiler, and ``parse(trace path)`` fourth when
    ``parse`` is given. The trace (tens of MB) is parsed and removed; a
    per-kernel summary stays beside ``path``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        result = fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    busy, kernels = device_busy(path)
    parsed = parse(path) if parse else None
    os.remove(path)
    with open(path[:-5] + "_kernels.txt", "w") as f:
        for kname, (ms, count) in sorted(kernels.items(),
                                         key=lambda kv: -kv[1][0]):
            f.write(f"{ms:.4f} ms x{count}: {kname}\n")
    return (busy, kernels, result) + ((parsed,) if parse else ())


def step_split(trace_path, mirror="FlashAttentionFnBackward"):
    """Device ms of a training step's trace by the host code that launched
    each kernel, copy or memset (matched by its correlation id):
    "forward" before the autograd engine's first node, "backward" inside
    its nodes ("mirror": inside the ``mirror`` nodes, a part of
    "backward"), "update" after its last (clipping and AdamW). None when
    the trace holds no autograd node or no device event."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    nodes, mirrors, launches, device = [], [], {}, []
    for e in events:
        cat, name, args = e.get("cat"), e.get("name", ""), e.get("args") or {}
        if cat == "cpu_op" and name.startswith(
                "autograd::engine::evaluate_function"):
            span = (e["tid"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            nodes.append(span)
            if name.endswith(mirror):
                mirrors.append(span)
        elif cat in ("cuda_runtime", "cuda_driver") and "correlation" in args:
            launches[args["correlation"]] = (e["tid"], float(e["ts"]))
        elif cat in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e:
            device.append((args.get("correlation"), float(e["dur"]) / 1e3))
    if not nodes or not device:
        return None
    b0, b1 = min(n[1] for n in nodes), max(n[2] for n in nodes)
    out = dict.fromkeys(("forward", "backward", "mirror", "update",
                         "unmatched"), 0.0)
    for corr, ms in device:
        if corr not in launches:
            out["unmatched"] += ms
            continue
        tid, ts = launches[corr]
        if ts < b0:
            out["forward"] += ms
        elif ts <= b1:
            out["backward"] += ms
            if any(t == tid and a <= ts <= b for t, a, b in mirrors):
                out["mirror"] += ms
        else:
            out["update"] += ms
    return out


def kernel_groups(kernels) -> dict:
    """Device ms by ``kernel_group``."""
    groups = dict.fromkeys(("vst kernels", "gemm", "copies", "other"), 0.0)
    for kname, (ms, _) in kernels.items():
        groups[kernel_group(kname)] += ms
    return groups


def profile_phase(cfg, params, input_ids, pixels, grid):
    """Phase 4: wall and device time of prefill and decode. Returns the
    directory the per-kernel summaries went to."""
    import statistics

    from visionselector_tpu_torch.models.qwen25vl.model import QwenVLEngine

    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    n_new = 1 + PROFILE_DECODE_STEPS
    for name, sel in (("selector", True), ("orig", False)):
        eng = QwenVLEngine(cfg, params, use_selector=sel, budget=0.2,
                           device="cuda")
        eng.generate(input_ids, pixels, grid, max_new_tokens=2)
        prep = []
        for _ in range(5):
            t0 = time.perf_counter()
            eng._prep_vision(input_ids, pixels, grid)
            prep.append((time.perf_counter() - t0) * 1e3)
        runs = [eng.generate(input_ids, pixels, grid, max_new_tokens=n_new)
                for _ in range(3)]
        prefill_ms = statistics.median(r.prefill_seconds * 1e3 for r in runs)
        step_ms = statistics.median(
            (r.total_seconds - r.prefill_seconds) * 1e3
            / max(len(r.tokens) - 1, 1) for r in runs)
        runs = {tag: traced(
            lambda new=new: eng.generate(input_ids, pixels, grid,
                                         max_new_tokens=new),
            os.path.join(out_dir, f"profile_{name}_{tag}.json"))
            for tag, new in (("prefill", 1), ("decode", n_new))}
        busy, kernels, _ = runs["prefill"]
        if busy == 0.0:
            print(f"[profile] {name}: device time not measured (the trace "
                  f"holds no device events)", flush=True)
            continue
        steps = max(len(runs["decode"][2].tokens) - 1, 1)
        step_busy = (runs["decode"][0] - busy) / steps
        print(f"[profile] {name}: prefill_wall_ms={prefill_ms!r} "
              f"host_prep_ms={statistics.median(prep)!r} "
              f"prefill_device_busy_ms={busy!r} "
              f"prefill_idle_share={1 - busy / prefill_ms!r} "
              f"decode_wall_ms_per_token={step_ms!r} "
              f"decode_device_ms_per_token={step_busy!r} "
              f"decode_idle_share={1 - step_busy / step_ms!r}", flush=True)
        print(f"[profile] {name} prefill device ms by group: "
              + " ".join(f"{g}={ms!r}"
                         for g, ms in kernel_groups(kernels).items()),
              flush=True)
        top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]
        for kname, (ms, count) in top:
            print(f"[profile] {name} prefill kernel {ms:.3f} ms x{count}: "
                  f"{kname[:100]}", flush=True)
    return out_dir


def profile_variants(cfg, params, input_ids, pixels, grid, out_dir):
    """Phase 4, the three attention configurations of the selector request:
    the ViT's device time (one ``vit_forward`` under torch.profiler, by
    kernel group) and the prefill's wall (median of 3 unprofiled runs) and
    device busy time. Findings, not claims."""
    import statistics

    import torch

    from visionselector_tpu_torch.models.qwen25vl import vit as V
    from visionselector_tpu_torch.models.qwen25vl.model import QwenVLEngine

    for variant in (None, "fused", "packed"):
        eng = QwenVLEngine(cfg, params, use_selector=True, budget=0.2,
                           device="cuda", attn_variant=variant)
        vt = eng._vision_tensors(eng._prep_vision(input_ids, pixels,
                                                  grid).vb)
        vit_variant = "fused" if variant == "fused" else None

        def vit():
            return V.vit_forward(eng.params.visual, attn_variant=vit_variant,
                                 **vt)

        def prefill():
            return eng.generate(input_ids, pixels, grid, max_new_tokens=1)

        vit()
        prefill()
        wall = statistics.median(prefill().prefill_seconds * 1e3
                                 for _ in range(3))
        tag = variant or "default"
        vit_busy, vit_kernels, _ = traced(
            vit, os.path.join(out_dir, f"profile_vit_{tag}.json"))
        busy, kernels, _ = traced(
            prefill, os.path.join(out_dir, f"profile_prefill_{tag}.json"))
        print(f"[profile] variant={tag}: vit_device_busy_ms={vit_busy!r} "
              + " ".join(f"vit_{g.replace(' ', '_')}_ms={ms!r}"
                         for g, ms in kernel_groups(vit_kernels).items())
              + f" prefill_wall_ms={wall!r} prefill_device_busy_ms={busy!r}"
              f" prefill_vst_kernels_ms="
              f"{kernel_groups(kernels)['vst kernels']!r}", flush=True)
        for kname, (ms, count) in sorted(vit_kernels.items()):
            if kernel_group(kname) == "vst kernels":
                print(f"[profile] variant={tag} vit kernel {ms!r} ms x{count}:"
                      f" {kname[:100]}", flush=True)
        del eng, vt


def run_ablation():
    """The ablation entry point, once, with the counters zeroed just before
    and read just after. Returns its launch counts."""
    from visionselector_tpu_torch.kernels import attention as A
    from visionselector_tpu_torch.tools import bench_fullattn_ablate

    zero_counts()
    res = bench_fullattn_ablate.main([str(ABLATE_S)])
    counts = launch_counts()
    print("[ablate] ms (prologue + main loop): " + " ".join(
        f"{k}={res['ms_' + k]!r} ({res['ms_' + k + '_prologue']!r} + "
        f"{res['ms_' + k + '_main']!r})"
        for k in ("prod", "full_ablate", "nomask", "noexp", "bare"))
          + f"; launches {counts} flash routes {A.FLASH_ROUTE_LAUNCHES}",
          flush=True)
    if counts["fullattn_ablate_fwd"] <= 0:
        raise AssertionError("the ablation entry point launched no kernel")
    return counts


def serve_traffic(cfg, input_ids, pixels, grid):
    """Phase 5's 16 requests: (engine, request, max_new_tokens, sampling
    kwargs, arrival delay in s). Questions of 8-40 ids after the 1036x1456
    image, a seeded 448x448 image, text-only prompts of 20-200 ids; three
    sampled (distinct seeds), one with a repetition penalty; two ``orig``."""
    import numpy as np

    from visionselector_tpu_torch.preprocess.image import preprocess_image
    from visionselector_tpu_torch.preprocess.rope import expand_vision_tokens

    rng = np.random.RandomState(SEED + 5)
    spx, sgrid = preprocess_image(
        (rng.rand(448, 448, 3) * 255).astype(np.uint8))
    n_big = int(np.sum(np.asarray(input_ids) == cfg.image_token_id))
    head = list(np.asarray(input_ids)[:np.argmax(
        np.asarray(input_ids) == cfg.image_token_id) + n_big + 1])

    def big(n_q):  # the phase-3 image, another question
        ids = head + rng.randint(100, 5000, n_q).tolist()
        return dict(input_ids=np.asarray(ids), pixel_values=pixels,
                    grid_thw=grid)

    def small(n_q):
        ids = expand_vision_tokens(
            [100, 101], rng.randint(100, 5000, n_q).tolist(), sgrid,
            spatial_merge_size=cfg.vision.spatial_merge_size,
            image_token_id=cfg.image_token_id,
            vision_start_token_id=cfg.vision_start_token_id,
            vision_end_token_id=cfg.vision_end_token_id)
        return dict(input_ids=np.asarray(ids), pixel_values=spx,
                    grid_thw=sgrid)

    def text(n):
        return dict(input_ids=rng.randint(100, 5000, n).astype(np.int64))

    samp = dict(temperature=0.7, top_p=0.9, top_k=50)
    sel = [(big(8), 64, {}), (big(12), 48, dict(samp, seed=1)),
           (text(20), 32, {}), (big(16), 40, {}),
           (big(20), 56, dict(repetition_penalty=1.1)), (small(10), 24, {}),
           (big(24), 32, dict(samp, seed=2)), (text(80), 40, {}),
           (big(30), 16, {}), (small(14), 48, dict(samp, seed=3)),
           (text(150), 24, {}), (big(36), 64, {}), (big(40), 32, {}),
           (text(200), 48, {})]
    orig = [(big(10), 32, {}), (big(28), 48, {})]
    return ([("selector", r, m, kw, max(0, i - 3) * 0.1)
             for i, (r, m, kw) in enumerate(sel)]
            + [("orig", r, m, kw, i * 0.1) for i, (r, m, kw) in
               enumerate(orig)])


def run_batcher(bat, traffic):
    """Submit each request from its own thread at its arrival time;
    returns (results, wall seconds from the first arrival to the last
    result)."""
    import concurrent.futures as cf

    t0 = time.perf_counter()

    def one(req, max_new, kw, delay):
        time.sleep(max(0.0, t0 + delay - time.perf_counter()))
        return bat.submit(req, max_new, **kw)

    try:
        with cf.ThreadPoolExecutor(max_workers=len(traffic)) as ex:
            futs = [ex.submit(one, r, m, kw, d) for _, r, m, kw, d in traffic]
            results = [f.result(timeout=600) for f in futs]
    finally:
        bat.shutdown()
    return results, time.perf_counter() - t0


def serve_phase(cfg, params, input_ids, pixels, grid, out_dir):
    """Phase 5: continuous batching at full width; profile summaries go to
    ``out_dir``. Returns the launch counts of the serving run."""
    import dataclasses
    import statistics

    import torch

    from visionselector_tpu_torch.kernels import attention as A
    from visionselector_tpu_torch.models.qwen25vl import lm as L
    from visionselector_tpu_torch.models.qwen25vl.continuous import (
        ContinuousBatcher,
        _decode_chunk_slots,
        _insert_slot,
    )
    from visionselector_tpu_torch.models.qwen25vl.model import QwenVLEngine

    n_layers = cfg.text.num_hidden_layers
    vocab = cfg.text.vocab_size
    engines = {
        "selector": QwenVLEngine(cfg, params, use_selector=True, budget=0.2,
                                 device="cuda"),
        "orig": QwenVLEngine(cfg, params, use_selector=False, device="cuda"),
    }
    traffic = serve_traffic(cfg, input_ids, pixels, grid)
    eos = (-1,)  # random weights: run every request to its budget
    traffic = [(e, r, m, dict(kw, eos_token_ids=eos), d)
               for e, r, m, kw, d in traffic]

    # The serving run: the selector batcher, then the orig one.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    results, stats, steps = {}, {}, 0
    for name in ("selector", "orig"):
        part = [x for x in traffic if x[0] == name]
        bat = ContinuousBatcher(engines[name], n_slots=POOL_SLOTS,
                                t_max=POOL_ROWS, chunk=8)
        res, wall = run_batcher(bat, part)
        steps += bat.stats["chunks"] * bat.chunk
        stats[name] = dict(bat.stats)
        pool_bytes = bat.pool.k.nbytes + bat.pool.v.nbytes
        n_tok = sum(len(r.tokens) - 1 for r in res)
        print(f"[serve] {name} batcher: {len(part)} requests in {wall!r} s, "
              f"decode tokens {n_tok}, aggregate decode tok/s "
              f"{n_tok / wall!r}, pool bytes {pool_bytes}, stats "
              f"{bat.stats}", flush=True)
        results.update(zip([id(x) for x in part], res))
        del bat
    torch.cuda.synchronize()
    launches = {"flash_varlen_fwd": A.FLASH_LAUNCHES,
                "diag_attn_fwd": A.DIAG_LAUNCHES,
                "decode_blocked_fwd": A.DECODE_LAUNCHES}
    peak = torch.cuda.max_memory_allocated()
    ttft = [results[id(x)].first_token_seconds * 1e3 for x in traffic]
    print(f"[serve] launches {launches} over {steps} decode steps; peak "
          f"memory {peak} bytes; time to first token ms median "
          f"{statistics.median(ttft)!r} max {max(ttft)!r}", flush=True)
    admitted = sum(st["admitted"] for st in stats.values())
    checks = {
        "tokens in range": all(
            len(results[id(x)].tokens) == x[2]
            and all(0 <= t < vocab for t in results[id(x)].tokens)
            for x in traffic),
        "admitted == 16": admitted == len(traffic) == 16,
        "max_concurrent == 8": stats["selector"]["max_concurrent"] == 8,
        "mid_flight_joins >= 1": stats["selector"]["mid_flight_joins"] >= 1,
        "rejected_too_long == 0": all(st["rejected_too_long"] == 0
                                      for st in stats.values()),
        "decode launches == layers x steps":
            launches["decode_blocked_fwd"] == n_layers * steps,
        "every kernel launched": min(launches.values()) > 0,
    }

    # Each greedy request against one-shot generate of the same request.
    first_ok = True
    for x in traffic:
        name, req, max_new, kw, _ = x
        got = results[id(x)].tokens
        want = engines[name].generate(**req, max_new_tokens=max_new,
                                      **kw).tokens
        agree = next((i for i, (a, b) in enumerate(zip(got, want))
                      if a != b), min(len(got), len(want)))
        greedy = kw.get("temperature", 0.0) == 0.0
        first_ok &= (not greedy) or got[0] == want[0]
        print(f"[serve] {name} {'greedy' if greedy else 'sampled'} "
              f"ids={len(req['input_ids'])} image={'pixel_values' in req} "
              f"rp={kw.get('repetition_penalty', 1.0)}: first token "
              f"batcher={got[0]} one-shot={want[0]}; {agree} of {max_new} "
              f"tokens agree", flush=True)
    checks["greedy first tokens == one-shot"] = first_ok

    # Four requests through an int8 pool.
    int8_part = [x for x in traffic if x[0] == "selector"
                 and x[3].get("temperature", 0.0) == 0.0][:4]
    bat = ContinuousBatcher(engines["selector"], n_slots=POOL_SLOTS,
                            t_max=POOL_ROWS, chunk=8, kv_quant="int8")
    res8, wall8 = run_batcher(bat, [(e, r, m, kw, 0.0)
                                    for e, r, m, kw, _ in int8_part])
    pool8 = bat.pool
    int8_bytes = (pool8.k.nbytes + pool8.v.nbytes, pool8.k_scale.nbytes
                  + pool8.v_scale.nbytes)
    del bat, pool8
    for x, r in zip(int8_part, res8):
        ref = results[id(x)].tokens
        agree = next((i for i, (a, b) in enumerate(zip(r.tokens, ref))
                      if a != b), len(ref))
        print(f"[serve] int8 pool: ids={len(x[1]['input_ids'])} first "
              f"token {r.tokens[0]} (bf16 pool {ref[0]}); {agree} of "
              f"{x[2]} tokens agree with the bf16 pool", flush=True)
    print(f"[serve] int8 pool: 4 requests in {wall8!r} s; pool bytes int8 "
          f"{int8_bytes[0]} + scales {int8_bytes[1]}", flush=True)
    checks["int8 tokens in range"] = all(
        len(r.tokens) == x[2] and all(0 <= t < vocab for t in r.tokens)
        for x, r in zip(int8_part, res8))

    # Teacher-forced: one admitted pool, one step with the kernel and one
    # with the dense plain path, on copies of the pool.
    eng = engines["selector"]
    admit = [x for x in traffic if x[0] == "selector"][:POOL_SLOTS]
    states = [eng.generate(**r, max_new_tokens=m, eos_token_ids=eos,
                           _defer_decode=True) for _, r, m, _, _ in admit]
    cur = torch.tensor([st.next_token for st in states], device="cuda")
    pos = torch.tensor([st.start_pos for st in states], device="cuda")
    live = torch.ones(POOL_SLOTS, dtype=torch.bool, device="cuda")
    for quant in (False, True):
        pool = L.init_kv_cache(cfg.text, POOL_SLOTS, POOL_ROWS, "cuda",
                               torch.bfloat16, quant=quant)
        for i, st in enumerate(states):
            _insert_slot(pool, st.cache.k, st.cache.v, st.cache.length, i)
        logits = {}
        for impl in (None, "plain"):
            copy = dataclasses.replace(pool, **{
                f.name: getattr(pool, f.name).clone()
                for f in dataclasses.fields(pool)})
            hidden, _ = L.lm_decode_step(
                params.lm, copy, L.embed_tokens(params.lm, cur)[:, None],
                pos[None, :, None].expand(3, POOL_SLOTS, 1), attn_impl=impl)
            logits[impl] = L.lm_head(params.lm, hidden[:, 0])
        rel = ((logits[None] - logits["plain"]).abs().amax(-1)
               / logits["plain"].abs().amax(-1))
        same = int((logits[None].argmax(-1)
                    == logits["plain"].argmax(-1)).sum())
        kind = "int8" if quant else "bf16"
        print(f"[serve] teacher-forced step, {kind} pool, kernel vs plain: "
              f"per-slot max|diff| / max|logit| {rel.tolist()!r} (limit "
              f"{TEACHER_TOL}); argmax equal in {same} of {POOL_SLOTS}",
              flush=True)
        checks[f"teacher-forced {kind}"] = bool(
            (rel <= TEACHER_TOL).all() and torch.isfinite(rel).all())
        if not quant:
            bf16_pool = pool
        del pool

    # Two chunks of the bf16 pool: wall vs device busy.
    _decode_chunk_slots(params, bf16_pool, cur, pos, live, 8)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2):
        _decode_chunk_slots(params, bf16_pool, cur, pos, live, 8)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / 2
    busy, kernels, _ = traced(
        lambda: [_decode_chunk_slots(params, bf16_pool, cur, pos, live, 8)
                 for _ in range(2)],
        os.path.join(out_dir, "profile_serve_chunks.json"))
    dec_ms = sum(ms for k, (ms, _) in kernels.items() if "decode_blocked" in k)
    if busy == 0.0:
        print("[serve] chunk device time not measured (the trace holds no "
              "device events)", flush=True)
    else:
        print(f"[serve] chunk of 8 steps x {POOL_SLOTS} slots: wall_ms="
              f"{wall_ms!r} device_busy_ms={busy / 2!r} idle_share="
              f"{1 - busy / 2 / wall_ms!r} decode_kernel_ms={dec_ms / 2!r}",
              flush=True)
    del bf16_pool
    bad = [k for k, ok in checks.items() if not ok]
    print(f"[serve] checks: {checks}", flush=True)
    if bad:
        raise AssertionError(f"serving phase failed: {bad}")
    return launches


# Phase 6 (training). The selector trains on one fixed batch: 2 samples of
# the phase-3 image, its 40 prompt ids and a 32-id answer each, text
# bucket 1,536, 8 steps at lr 5e-3 with reg_weight pinned to 1.0.
TRAIN_STEPS, TRAIN_LR, TRAIN_BATCH = 8, 5e-3, 2
TRAIN_S_BUCKET, TRAIN_T_BUCKET, ANSWER_LEN = 6144, 1536, 32
# K1's gradient (kernel forward + mirror backward) against the plain
# forward + the same backward, each of dq, dk, dv within GRAD_TOL of its
# largest |value|: the gradients are bf16 (one ulp of the largest |value|
# is 2^-8 = 3.9e-3 of it, so last-bit rounding differences stay below
# that), and delta = rowsum(dO * O) reads two forwards that differ by <=
# ULP_LIMIT ulps per row, which moves dS by ~1e-3 of |dP - delta|. The
# planted faults (delta from zeros; the diagonal kv block left out of dk)
# move the gradients by O(1) of their range.
GRAD_TOL = 1e-2
# remat recomputes the same kernels on the same inputs, so its scorer
# gradients should equal the plain run's; the tolerance only admits a
# reduction that changes order between the two runs.
REMAT_TOL = 1e-5
# The CE's scorer gradients (kernel forwards, FlashAttentionFn's mirror
# backward) against plain attention differentiated by autograd (no kernel,
# no mirror), each leaf within TRAIN_GRAD_TOL of its largest |value|. Both
# sides round every activation and activation gradient to bf16 through 32
# ViT and 36 LM layers, and the soft top-k's VJP (g_i - mean g, weighted)
# cancels most of what reaches the scores. Readings at the initial
# parameters on an H100 80GB HBM3 (700 W): the kernel path against the
# LM's plain attention by autograd 0.040, against every attention plain
# 0.071; the planted mirror faults 0.35 (the diagonal kv block out of dk)
# and 1.34 (delta from zeros). At the trained parameters the soft mask is
# saturated (BCE ~5e-4) and the gradient is ill-conditioned (the phase
# prints that comparison unchecked), so the check runs before the steps.
TRAIN_GRAD_TOL = 0.15


def rel_err(got, want) -> float:
    """max |got - want| over the largest |want|."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp(min=1e-30)).item()


def check_flash_grad(cfg):
    """Phase 6.1: the gradient of K1 at the LM's training shape (B = 2,
    T = 1,536 with padding tails, GQA 16/2, D = 128, causal), and the
    kernel forward's and the mirror backward's ms (CUDA events)."""
    import torch

    from visionselector_tpu_torch.kernels import attention as A

    b, t = TRAIN_BATCH, TRAIN_T_BUCKET
    hq, hkv, d = (cfg.text.num_attention_heads, cfg.text.num_key_value_heads,
                  cfg.text.head_dim)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").bfloat16()

    q, k, v, g = rnd(b, t, hq, d), rnd(b, t, hkv, d), rnd(b, t, hkv, d), \
        rnd(b, t, hq, d)
    valid = torch.tensor([t - 202, t - 335], device="cuda")  # 1334, 1201
    seg = (torch.arange(t, device="cuda")[None] < valid[:, None]).int()
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = A.attention(*leaves, seg, seg, causal=True)
    out.backward(g)
    plain = A.flash_plain(q, k, v, seg, seg, causal=True)
    want = A.flash_backward_plain(q, k, v, seg, seg, True, None, plain, g)
    ulp = bf16_ulp_err(out.detach(), plain)
    errs = [rel_err(x.grad, w) for x, w in zip(leaves, want)]
    pad_zero = bool((leaves[0].grad[seg == 0] == 0).all()
                    and (leaves[1].grad[seg == 0] == 0).all())
    faults = {}
    for fault in ("delta_zero", "drop_diag_dk"):
        bad = A.flash_backward_plain(q, k, v, seg, seg, True, None,
                                     out.detach(), g, fault=fault)
        faults[fault] = max(rel_err(x, w) for x, w in zip(bad, want))
    fwd_ms = cuda_ms(lambda: A.flash_varlen_fwd(q, k, v, seg, seg,
                                                causal=True))
    mirror_ms = cuda_ms(lambda: A.flash_backward_plain(
        q, k, v, seg, seg, True, None, plain, g), n=5)
    print(f"[train] K1 gradient B={b} T={t} Hq={hq} Hkv={hkv} D={d} causal "
          f"valid={valid.tolist()}: out ulp_err={ulp!r} (limit {ULP_LIMIT}) "
          f"dq/dk/dv rel_err={errs!r} (limit {GRAD_TOL}) pad_rows_zero="
          f"{pad_zero} planted faults {faults!r} (must exceed {GRAD_TOL}); "
          f"kernel forward ms={fwd_ms!r} mirror backward ms={mirror_ms!r}",
          flush=True)
    ok = (ulp <= ULP_LIMIT and max(errs) <= GRAD_TOL and pad_zero
          and min(faults.values()) > GRAD_TOL)
    if not ok:
        raise AssertionError("K1 gradient check failed")


def train_batch(cfg):
    """Phase 6's fixed batch, stacked on the host."""
    import numpy as np

    from visionselector_tpu_torch.train.data import (
        build_train_sample,
        stack_samples,
    )

    img = request_image()
    answers = [list(range(500 + 40 * i, 500 + 40 * i + ANSWER_LEN))
               for i in range(TRAIN_BATCH)]
    batch = stack_samples([build_train_sample(
        cfg, img, PROMPT_BEFORE, PROMPT_AFTER, a, budget=0.2,
        s_bucket=TRAIN_S_BUCKET, t_bucket=TRAIN_T_BUCKET) for a in answers])
    assert int(np.asarray(batch.k)[0]) == int(
        np.asarray(batch.num_merged)[0]) // 5
    return batch


def frozen_checksums(params) -> dict:
    """Every non-scorer parameter's bits as integers, summed plainly and
    weighted by position (mod 65,521): a change to any element moves one
    of the two sums. Computed in chunks on the card (no copy of the
    weights)."""
    import torch

    sums = {}
    for name, p in params.named_parameters():
        if name.startswith("scorer."):
            continue
        bits = p.detach().reshape(-1).view(
            torch.int16 if p.element_size() == 2 else torch.int32)
        acc = torch.zeros(2, dtype=torch.int64, device=p.device)
        for i in range(0, bits.numel(), 1 << 24):
            x = bits[i:i + (1 << 24)].long()
            w = torch.arange(i, i + x.numel(), device=p.device) % 65521 + 1
            acc += torch.stack([x.sum(), (x * w).sum()])
        sums[name] = acc
    return sums


@contextlib.contextmanager
def patched(obj, name, value):
    """``obj.name`` is ``value`` inside the block."""
    saved = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, saved)


class PlainAutogradAttention:
    """Stands in for FlashAttentionFn: the plain forward, differentiated by
    autograd (no kernel, no mirror backward). Only calls that need a
    gradient reach it, so the frozen ViT (under ``no_grad``) keeps its
    kernels."""

    @staticmethod
    def apply(fwd, q, k, v, q_seg, kv_seg, causal, scale):
        from visionselector_tpu_torch.kernels.attention import flash_plain

        return flash_plain(q, k, v, q_seg, kv_seg, causal, scale)


def ce_scorer_grads(cfg, params, state, batch, k_max, remat,
                    attn_impl=None):
    """({scorer leaf: gradient}, peak memory bytes) of the batch's CE alone
    (reg_weight 0), with no update."""
    import torch

    from visionselector_tpu_torch.train.train_step import batch_loss

    state.optimizer.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loss, _ = batch_loss(params, batch, cfg, 0.0, k_max, remat=remat,
                         attn_impl=attn_impl)
    loss.backward()
    torch.cuda.synchronize()
    grads = {n: p.grad.clone() for n, p in params.scorer.named_parameters()}
    state.optimizer.zero_grad(set_to_none=True)
    return grads, torch.cuda.max_memory_allocated()


def fp32_ce_scorer_grads(cfg, params, batch, k_max) -> dict:
    """The CE's scorer gradients (reg_weight 0) with an fp32 copy of every
    weight and every attention plain, differentiated by autograd (remat):
    the reference the bf16 paths are held to."""
    import copy

    import torch

    from visionselector_tpu_torch.kernels import attention as A
    from visionselector_tpu_torch.train.train_step import batch_loss

    p32 = copy.deepcopy(params).float()
    with patched(A, "FlashAttentionFn", PlainAutogradAttention):
        loss, _ = batch_loss(p32, batch, cfg, 0.0, k_max, remat=True,
                             attn_impl="plain")
        loss.backward()
    torch.cuda.synchronize()
    grads = {n: p.grad.clone() for n, p in p32.scorer.named_parameters()}
    del p32, loss
    torch.cuda.empty_cache()
    return grads


def grad_err(got, want) -> float:
    """The largest ``rel_err`` over the scorer's leaves but q_bias, whose
    gradient is zero analytically (a shift of every score leaves the soft
    top-k unchanged)."""
    return max(rel_err(got[n], w) for n, w in want.items() if n != "q_bias")


def gradient_checks(cfg, params, state, batch, k_max) -> dict:
    """Phase 6.2's gradient checks at the initial parameters (no update):
    the scorer gradients of the CE alone (reg_weight 0: the part that
    crosses the LM, its attention gradient and the soft top-k's VJP; the
    BCE's part reaches the scorer directly and would hide it) on the
    default path, with remat, and against two references: the LM's
    attention plain and differentiated by autograd (the frozen ViT keeps
    its kernels), and every attention plain. Each planted mirror fault
    must exceed the tolerance against the first."""
    import torch

    from visionselector_tpu_torch.kernels import attention as A

    def grads_of(remat, attn_impl=None):
        return ce_scorer_grads(cfg, params, state, batch, k_max, remat,
                               attn_impl)

    checks = {}
    g_kernel, peak_plain = grads_of(False)
    g_remat, peak_remat = grads_of(True)
    with patched(A, "FlashAttentionFn", PlainAutogradAttention):
        g_lm, peak_ref = grads_of(True)
        g_all = grads_of(True, attn_impl="plain")[0]
    faults = {}
    for fault in ("delta_zero", "drop_diag_dk"):
        with patched(A, "flash_backward_plain", functools.partial(
                A.flash_backward_plain, fault=fault)):
            faults[fault] = grad_err(grads_of(False)[0], g_lm)
    remat_err = grad_err(g_remat, g_kernel)
    equal = all(torch.equal(g_remat[n], g) for n, g in g_kernel.items())
    checks["remat gradients"] = remat_err <= REMAT_TOL
    print(f"[train] remat: CE scorer grad rel_err={remat_err!r} (limit "
          f"{REMAT_TOL}; q_bias's gradient is zero analytically) bit_equal="
          f"{equal} peak_mem_bytes remat={peak_remat} no_remat={peak_plain}",
          flush=True)
    # The fp32 reference: the bf16 plain path's distance from it is the
    # noise floor of bf16 rounding, the kernel path's is held beside it.
    g_fp32 = fp32_ce_scorer_grads(cfg, params, batch, k_max)
    floor, kern = grad_err(g_all, g_fp32), grad_err(g_kernel, g_fp32)
    print(f"[train] CE scorer gradients at the initial parameters against "
          f"the fp32 reference (fp32 weights, every attention plain, "
          f"autograd): the bf16 plain path rel_err={floor!r} (the noise "
          f"floor), the bf16 kernel path rel_err={kern!r}; per leaf plain "
          f"{ {n: rel_err(g, g_fp32[n]) for n, g in g_all.items()}!r} kernel "
          f"{ {n: rel_err(g, g_fp32[n]) for n, g in g_kernel.items()}!r}; "
          f"the kernel path {'is' if kern <= floor else 'is not'} within "
          f"the plain path's distance (ratio {kern / floor!r})", flush=True)
    lm_err, all_err = grad_err(g_kernel, g_lm), grad_err(g_kernel, g_all)
    checks["CE scorer gradients vs plain attention by autograd"] = (
        bool(all(torch.isfinite(g).all() for g in g_lm.values()))
        and max(lm_err, all_err) <= TRAIN_GRAD_TOL
        and min(faults.values()) > TRAIN_GRAD_TOL)
    print(f"[train] CE scorer gradients at the initial parameters, kernel "
          f"forwards + mirror backward against plain attention "
          f"differentiated by autograd (remat, peak_mem_bytes={peak_ref}): "
          f"the LM's rel_err={lm_err!r} per leaf "
          f"{ {n: rel_err(g, g_lm[n]) for n, g in g_kernel.items()}!r}, "
          f"the ViT's too rel_err={all_err!r} (limit {TRAIN_GRAD_TOL}); "
          f"planted mirror faults against the first {faults!r} (must "
          f"exceed it)", flush=True)
    return checks


def train_phase(cfg, params, out_dir):
    """Phase 6.2: the gradient checks, then 8 selector steps at full
    width (the last under the profiler). Returns the checks' results."""
    import statistics

    import numpy as np
    import torch

    from visionselector_tpu_torch.kernels import attention as A
    from visionselector_tpu_torch.train.loss import IGNORE_INDEX, to_device
    from visionselector_tpu_torch.train.train_step import (
        ScheduleConfig,
        init_train_state,
        train_step,
    )

    host = train_batch(cfg)
    batch = to_device(host, "cuda")
    k_max = max(1, int(TRAIN_S_BUCKET // cfg.vision.spatial_merge_unit
                       * 0.2))
    sup = int((np.asarray(host.labels)[:, 1:] != IGNORE_INDEX).sum())
    valid = int(np.asarray(host.seg_ids).sum())
    print(f"[train] batch: {TRAIN_BATCH} samples, merged="
          f"{np.asarray(host.num_merged).tolist()} k="
          f"{np.asarray(host.k).tolist()} k_max={k_max} s_bucket="
          f"{TRAIN_S_BUCKET} t_bucket={TRAIN_T_BUCKET} valid_tokens={valid} "
          f"supervised_tokens={sup}", flush=True)
    sched = ScheduleConfig(total_steps=TRAIN_STEPS, lr=TRAIN_LR,
                           reg_weight_start=1.0, reg_weight_end=1.0)
    frozen = frozen_checksums(params)
    state = init_train_state(params, sched)
    checks = gradient_checks(cfg, params, state, batch, k_max)
    n_full = len(cfg.vision.fullatt_block_indexes)
    want = {"diag_attn_fwd": TRAIN_BATCH * (cfg.vision.depth - n_full),
            "flash_varlen_fwd": TRAIN_BATCH * n_full
            + cfg.text.num_hidden_layers}
    metrics, walls, counts = [], [], []

    def step():
        t0 = time.perf_counter()
        out = train_step(state, params, batch, cfg, k_max, sched)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(TRAIN_STEPS):
        zero_counts()
        if i == TRAIN_STEPS - 1:  # the last step under the profiler
            busy, kernels, ((state, m), prof_wall), split = traced(
                step, os.path.join(out_dir, "profile_train_step.json"),
                parse=step_split)
        else:
            (state, m), wall = step()
            walls.append(wall)
        counts.append({n: c for n, c in launch_counts().items() if c})
        metrics.append({k: float(v) for k, v in m.items()})
        print(f"[train] step {i + 1}: " + " ".join(
            f"{k}={v!r}" for k, v in metrics[-1].items())
            + f" launches {counts[-1]}", flush=True)
    peak = torch.cuda.max_memory_allocated()
    grads = {n: p.grad for n, p in params.scorer.named_parameters()}
    checks["launches per step"] = all(c == want for c in counts)
    checks["loss falls"] = metrics[-1]["loss"] < metrics[0]["loss"]
    checks["bce falls"] = metrics[-1]["bce"] < metrics[0]["bce"]
    checks["first step lr 0"] = metrics[0]["lr"] == 0.0
    checks["scorer grads finite, non-zero"] = bool(
        all(torch.isfinite(g).all() for g in grads.values())
        and all(grads[n].abs().max() > 0
                for n in ("q_kernel", "k_kernel", "k_bias")))
    after = frozen_checksums(params)
    checks["frozen bit-equal, no grad"] = all(
        torch.equal(after[n], frozen[n]) and p.grad is None
        for n, p in params.named_parameters() if n in frozen)
    step_ms = statistics.median(walls)
    idle = (f"device_busy_ms={busy!r} wall_ms={prof_wall!r} idle_share="
            f"{1 - busy / prof_wall!r} (step {TRAIN_STEPS}, profiled)"
            if busy else "device busy and idle share not measured (the "
            "trace holds no device events)")
    print(f"[train] {TRAIN_STEPS} steps: step_wall_ms median={step_ms!r} "
          f"(steps 1-{TRAIN_STEPS - 1}, unprofiled: {walls!r}); expected "
          f"launches per step {want}; {idle} "
          f"supervised_tok_s={sup / step_ms * 1e3!r} "
          f"valid_tok_s={valid / step_ms * 1e3!r} "
          f"max_memory_allocated={peak}", flush=True)
    print("[train] step device ms by group: " + " ".join(
        f"{g}={ms!r}" for g, ms in kernel_groups(kernels).items()),
        flush=True)
    if split:
        print(f"[train] step {TRAIN_STEPS} device ms by the host code that "
              f"launched it: forward={split['forward']!r} backward="
              f"{split['backward']!r} update={split['update']!r} unmatched="
              f"{split['unmatched']!r}; the mirror backward (inside "
              f"FlashAttentionFn's backward nodes) {split['mirror']!r} ms, "
              f"{split['mirror'] / split['backward']!r} of the backward",
              flush=True)
    else:
        print("[train] forward / backward device time not measured (the "
              "trace holds no autograd node or device event)", flush=True)
    g_kernel = ce_scorer_grads(cfg, params, state, batch, k_max, False)[0]
    with patched(A, "FlashAttentionFn", PlainAutogradAttention):
        g_all = ce_scorer_grads(cfg, params, state, batch, k_max, True,
                                "plain")[0]
    print(f"[train] not checked: the CE scorer gradients at the trained "
          f"parameters (soft mask saturated), kernel forwards + mirror "
          f"against every attention plain by autograd rel_err="
          f"{grad_err(g_kernel, g_all)!r}", flush=True)
    return checks


def start_cli(procs, tmp, name, *args):
    """Start ``python -m visionselector_tpu_torch.api.<name> args`` with
    its output in files under ``tmp``."""
    out = open(os.path.join(tmp, f"{name}.out"), "w")
    err = open(os.path.join(tmp, f"{name}.err"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", f"visionselector_tpu_torch.api.{name}",
         *args], stdout=out, stderr=err, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    out.close()
    err.close()
    procs[name] = (proc, os.path.join(tmp, name), time.perf_counter())


def finish_cli(procs, name):
    """(return code, stdout, stderr, seconds since its start) of a CLI run
    started by ``start_cli``, waiting up to 300 s for it."""
    proc, base, t0 = procs[name]
    rc = proc.wait(timeout=300)
    with open(base + ".out") as f, open(base + ".err") as g:
        return rc, f.read(), g.read(), time.perf_counter() - t0


def hf_phase(cfg, params, input_ids, pixels, grid, tmp, procs):
    """Phase 6.3: an HF-layout directory of the 3B weights at reduced depth
    (ViT block 0 and the first full-attention block, 7; LM layers 0 and 1;
    bf16; the trained scorer) written in both prefix layouts and
    loaded onto the card bit for bit; the trained scorer exported,
    reloaded bit for bit and served; ``api.train --smoke`` on the card.
    The two CLI runs are processes of their own (in ``procs``), run beside
    the rest of the phase and waited for at its end. Returns the checks'
    results."""
    import dataclasses

    import torch

    from visionselector_tpu_torch.core.safetensors import (
        open_checkpoint,
        save_sharded,
    )
    from visionselector_tpu_torch.models.qwen25vl.model import (
        QwenVLEngine,
        QwenVLParams,
    )
    from visionselector_tpu_torch.models.qwen25vl.weights import (
        config_from_hf,
        export_scorer_to_safetensors,
        load_hf_checkpoint,
        load_scorer_params,
        to_hf_tensors,
    )

    checks = {}
    smoke_out = os.path.join(tmp, "smoke_train")
    start_cli(procs, tmp, "train", "--smoke", "--total-steps", "3",
              "--log-steps", "1", "--output-dir", smoke_out)
    src = to_hf_tensors(params)  # views, no copies
    full = cfg.vision.fullatt_block_indexes[0]
    keep = {"visual.blocks.0.": "visual.blocks.0.",
            f"visual.blocks.{full}.": "visual.blocks.1.",
            "model.layers.0.": "model.layers.0.",
            "model.layers.1.": "model.layers.1."}
    small = {}
    for name, t in src.items():
        for old, new in keep.items():
            if name.startswith(old):
                small[new + name[len(old):]] = t
                break
        else:
            if ".blocks." not in name and ".layers." not in name:
                small[name] = t
    vis = dataclasses.asdict(cfg.vision)
    vis.update(depth=2, fullatt_block_indexes=[1])
    text = dict(dataclasses.asdict(cfg.text), num_hidden_layers=2,
                rope_scaling={"type": "mrope",
                              "mrope_section": list(cfg.text.mrope_section)})
    for layout in ("visual.", "model.visual."):
        lm_prefix = "model." if layout == "visual." else \
            "model.language_model."
        d = os.path.join(tmp, f"hf_{layout.rstrip('.')}")
        names = {}
        for name in small:
            if name.startswith("visual."):
                names[layout + name[len("visual."):]] = name
            elif name.startswith("model."):
                names[lm_prefix + name[len("model."):]] = name
            else:
                names[name] = name
        t0 = time.perf_counter()
        save_sharded({n: small[o] for n, o in names.items()}, d, shards=2)
        conf = {"vision_config": vis, "image_token_id": cfg.image_token_id,
                "eos_token_id": cfg.eos_token_id}
        if layout == "visual.":
            conf.update(text)
        else:
            conf["text_config"] = text
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(conf, f)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        small_cfg = config_from_hf(d)
        loaded = load_hf_checkpoint(d, small_cfg, "cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        back = to_hf_tensors(loaded, layout, lm_prefix)
        same = (back.keys() == names.keys() and all(
            back[n].dtype == small[o].dtype and torch.equal(back[n], small[o])
            for n, o in names.items()))
        nbytes = sum(t.numel() * t.element_size() for t in small.values())
        print(f"[train] HF dir ({layout} / {lm_prefix}, 2 shards, "
              f"{len(names)} tensors, {nbytes} bytes): write_s={write_s!r} "
              f"load_to_card_s={load_s!r} config depth="
              f"{small_cfg.vision.depth} layers="
              f"{small_cfg.text.num_hidden_layers} bit_equal={same}",
              flush=True)
        checks[f"HF load bit-equal ({layout})"] = bool(
            same and small_cfg.vision.fullatt_block_indexes == (1,))
        del loaded, back
    # the last directory (nested layout) through the predict CLI on the card
    start_cli(procs, tmp, "predict", "--model-path", d, "--max-new-tokens",
              "2")

    path = os.path.join(tmp, "importance_scorer.safetensors")
    export_scorer_to_safetensors(params.scorer, path)
    reloaded = load_scorer_params(open_checkpoint(path), cfg, "cuda")
    checks["scorer export bit-equal"] = all(
        torch.equal(p, q) for p, q in zip(params.scorer.parameters(),
                                          reloaded.parameters()))
    firsts = []
    for scorer in (params.scorer, reloaded):
        eng = QwenVLEngine(cfg, QwenVLParams(params.visual, params.lm,
                                             scorer),
                           use_selector=True, budget=0.2, device="cuda")
        res = eng.generate(input_ids, pixels, grid, max_new_tokens=1)
        firsts.append((res.tokens[:1], res.selected_indices.tolist()))
    checks["served first token equal"] = firsts[0] == firsts[1]
    print(f"[train] served with the trained scorer in memory and reloaded "
          f"from its export: first tokens {firsts[0][0]} / {firsts[1][0]}, "
          f"selected sets equal {firsts[0][1] == firsts[1][1]}", flush=True)

    rc, stdout, stderr, secs = finish_cli(procs, "predict")
    out = json.loads(stdout.strip().splitlines()[-1]) if rc == 0 else {}
    checks["api.predict --model-path on cuda"] = bool(
        out.get("tokens") and out.get("selector") and out["device"] == "cuda")
    print(f"[train] api.predict --model-path (cuda): rc={rc} in {secs!r} s "
          f"{out or stderr[-2000:]}", flush=True)
    rc, _, stderr, secs = finish_cli(procs, "train")
    log = os.path.join(smoke_out, "train_log.jsonl")
    ok = (rc == 0 and os.path.isfile(log) and os.path.isfile(
        os.path.join(smoke_out, "importance_scorer.safetensors")))
    lines = open(log).read().splitlines() if ok else []
    checks["api.train --smoke on cuda"] = ok and len(lines) == 3
    print(f"[train] api.train --smoke --total-steps 3 (cuda): rc={rc} in "
          f"{secs!r} s; last log line "
          f"{lines[-1] if lines else stderr[-2000:]}", flush=True)
    return checks, d


def training(cfg, params, input_ids, pixels, grid, out_dir, tmp) -> str:
    """Phase 6: K1's gradient, training at full width, load / export /
    serve, with its files under ``tmp``. Raises if any check failed;
    returns the reduced-depth HF directory (nested layout, with the
    trained scorer), which phase 7 evaluates."""
    t0 = time.perf_counter()
    print(f"[train] card: {nvidia_smi()}", flush=True)
    check_flash_grad(cfg)
    checks = train_phase(cfg, params, out_dir)
    procs = {}
    try:
        hf_checks, hf_dir = hf_phase(cfg, params, input_ids, pixels, grid,
                                     tmp, procs)
        checks.update(hf_checks)
    finally:
        for proc, _, _ in procs.values():  # stopped if the phase failed
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    print(f"[train] checks: {checks}", flush=True)
    print(f"[train] phase seconds {time.perf_counter() - t0!r}", flush=True)
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"training phase failed: {bad}")
    return hf_dir


# Phase 7 (eval). Loglikelihood scoring and the evaluation harness on the
# phase-3 weights (the scorer as phase 6 trained it).
LL_CONT_LEN = 12
CHOICE_LENS = (1, 5, 12, 20)  # c_max 32
TEXT_CTX_LEN = 200
# Kernel path against attn_impl="plain" (and a choice's chunk against its
# full prefill), |ll difference| per continuation token in nats. Both sides
# round activations to bf16 through 32 ViT and 36 decoder layers and sum
# attention in another order; with the selector, near-ties may also swap a
# kept token, and a chunk goes through the decode kernel where the prefill
# goes through K1. Readings on an H100 80GB HBM3 (700 W): selector ll
# 0.013, choices and chunk against per-pair 0.0015-0.0186 per token.
LL_TOL = 0.05
# The same for the full-prefill ll where the kept tokens cannot differ
# (orig, text-only): readings 0.0003 and 0.0037 per token.
LL_TOL_SAME = 0.01
# The planted fault (the continuation scored one position late) must
# exceed the tolerance of the comparison it is planted in. Random weights
# give a near-uniform next-token distribution that hardly changes from
# one position to the next, so it moved the ll by 0.20 (selector), 0.022
# (orig, after 1,302 context rows) and 0.048 (text-only) per token there.
# The choices' planted fault reads token j from chunk row j (one row late,
# the chunk path's off-by-one). On ``orig`` the choices are held against
# the plain chunk and against each choice's own full prefill at
# LL_TOL_CHUNK, between the sound readings there (at most 0.0176 and
# 0.0107 per token; the 1-id choice's 0.0176 is the context's last-row
# logits, K1 against plain) and what the fault reads (at most 0.080 and
# 0.083; 0.170 on the selector's, held at LL_TOL).
LL_TOL_CHUNK = 0.03
EVAL_TASKS = [
    {"name": "smoke_gen", "metric": "exact_match", "max_new_tokens": 16},
    {"name": "smoke_mc", "metric": "multiple_choice",
     "request_type": "loglikelihood"},
]
# The reference harness's result keys (visionselector_tpu/eval/
# evaluator.py:453-458, tasks.py aggregate_scores, EvalTimeStats.summary).
EVAL_TIME_KEYS = ("avg_prefill_ms", "avg_latency_ms", "avg_visual_tokens",
                  "avg_input_tokens", "avg_output_tokens")


def ll_per_token(a, b, n) -> float:
    return abs(a - b) / n


def eval_task_dir(tmp, with_image) -> str:
    """Phase 7's synthetic tasks under ``tmp``: a generate_until task of 4
    text-only docs (16 new tokens) and an MC loglikelihood task of 4
    text-only docs with 2-4 choices, plus one doc with the phase-3 image
    (a PNG) when PIL imports."""
    d = os.path.join(tmp, "eval_tasks")
    os.makedirs(d)
    with open(os.path.join(d, "tasks.json"), "w") as f:
        json.dump(EVAL_TASKS, f)
    gen = [{"question": q, "answers": [a]} for q, a in (
        ("What is two plus two?", "4"), ("Name a primary color.", "red"),
        ("Spell the word cat.", "cat"), ("Is water wet?", "yes"))]
    mc = [{"question": "Pick the animal.", "answers": ["B"],
           "choices": ["a rock", "a dog"]},
          {"question": "Which is largest?", "answers": ["C"],
           "choices": ["one", "ten", "one hundred"]},
          {"question": "Which shape has three sides?", "answers": ["A"],
           "choices": ["triangle", "square", "circle", "line"]},
          {"question": "Which is a fruit?", "answers": ["A"],
           "choices": ["apple pie slice", "brick"]}]
    if with_image:
        from PIL import Image

        Image.fromarray(request_image()).save(os.path.join(d, "image.png"))
        mc.append({"question": "What does the image show?", "answers": ["A"],
                   "image": "image.png", "choices": ["noise", "a cat"]})
    for name, docs in (("smoke_gen", gen), ("smoke_mc", mc)):
        with open(os.path.join(d, f"{name}.jsonl"), "w") as f:
            f.writelines(json.dumps(doc) + "\n" for doc in docs)
    return d


def ll_checks(cfg, params, input_ids, pixels, grid):
    """Phase 7.2-7.3: ``loglikelihood`` and ``run_loglikelihood_choices``
    on the kernel path against the plain path, launch counts, the planted
    fault, reverse order, the chunk against per-pair prefills. Returns
    (checks, the selector choices run's K5 launches)."""
    import numpy as np
    import torch

    from visionselector_tpu_torch.kernels import attention as A
    from visionselector_tpu_torch.models.qwen25vl import model as M

    rng = np.random.RandomState(SEED + 7)
    cont = rng.randint(1000, 100000, LL_CONT_LEN)
    text_ctx = rng.randint(1000, 100000, TEXT_CTX_LEN)
    choices = [rng.randint(1000, 100000, n) for n in CHOICE_LENS]
    n_full = len(cfg.vision.fullatt_block_indexes)
    n_layers = cfg.text.num_hidden_layers
    want_vision = {"diag_attn_fwd": cfg.vision.depth - n_full,
                   "flash_varlen_fwd": n_full + n_layers,
                   "decode_blocked_fwd": 0}
    vision = dict(pixel_values=pixels, grid_thw=grid)
    checks = {}
    chunk_of = M.lm_mod.lm_decode_chunk

    def chunk_one_row_late(*a, **kw):
        # hidden row j - 1 (which scores token j) replaced by row j
        hidden, cache = chunk_of(*a, **kw)
        return torch.cat([hidden[:, 1:], hidden[:, -1:]], 1), cache

    def counted(fn):
        zero_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        c = launch_counts()
        return out, wall, {k: c[k] for k in want_vision}

    k5_launches = 0
    for name, use_sel in (("selector", True), ("orig", False)):
        eng = M.QwenVLEngine(cfg, params, use_selector=use_sel, budget=0.2,
                             device="cuda")
        plain = M.QwenVLEngine(cfg, params, use_selector=use_sel, budget=0.2,
                               device="cuda", attn_impl="plain")
        eng.loglikelihood(input_ids, cont, **vision)  # warm-up
        (ll_k, gr_k), ms, launches = counted(
            lambda: eng.loglikelihood(input_ids, cont, **vision))
        ll_p, gr_p = plain.loglikelihood(input_ids, cont, **vision)
        late = M._score_continuation
        with patched(M, "_score_continuation",
                     lambda p, h, n, *a: late(p, h, n + 1, *a)):
            ll_f, _ = eng.loglikelihood(input_ids, cont, **vision)
        err, fault = (ll_per_token(ll_k, ll_p, LL_CONT_LEN),
                      ll_per_token(ll_f, ll_p, LL_CONT_LEN))
        tol = LL_TOL if use_sel else LL_TOL_SAME
        print(f"[eval] loglikelihood {name} (image, {len(input_ids)} ids, "
              f"{LL_CONT_LEN}-id continuation): kernel ll={ll_k!r} greedy="
              f"{gr_k} plain ll={ll_p!r} greedy={gr_p}: |diff| per token "
              f"{err!r} (limit {tol}); planted fault (scored one position "
              f"late) ll={ll_f!r}, {fault!r} per token (must exceed the "
              f"limit); wall_ms={ms!r} launches {launches} (expected "
              f"{want_vision})", flush=True)
        checks[f"ll {name} kernel vs plain"] = bool(
            err <= tol and gr_k == gr_p and np.isfinite(ll_k))
        checks[f"ll {name} planted fault fails"] = fault > tol
        checks[f"ll {name} launches"] = launches == want_vision

        shared, ms_shared, launches = counted(
            lambda: M.run_loglikelihood_choices(eng, input_ids, choices,
                                                **vision))
        if use_sel:
            k5_launches = launches["decode_blocked_fwd"]
        want = dict(want_vision,
                    decode_blocked_fwd=n_layers * len(choices))
        rev = M.run_loglikelihood_choices(eng, input_ids, choices[::-1],
                                          **vision)[::-1]
        plain_sh = M.run_loglikelihood_choices(plain, input_ids, choices,
                                               **vision)
        with patched(M.lm_mod, "lm_decode_chunk", chunk_one_row_late):
            faulty = M.run_loglikelihood_choices(eng, input_ids, choices,
                                                 **vision)
        errs = [ll_per_token(a[0], b[0], n) for a, b, n in
                zip(shared, plain_sh, CHOICE_LENS)]
        faults = [ll_per_token(a[0], b[0], n) for a, b, n in
                  zip(faulty, plain_sh, CHOICE_LENS)]
        rev_diff = max(abs(a[0] - b[0]) for a, b in zip(shared, rev))
        tol = LL_TOL if use_sel else LL_TOL_CHUNK
        print(f"[eval] run_loglikelihood_choices {name} ({len(choices)} "
              f"choices of {CHOICE_LENS} ids, c_max 32): kernel "
              f"{[round(x[0], 4) for x in shared]} plain "
              f"{[round(x[0], 4) for x in plain_sh]}: |diff| per token "
              f"{errs!r} (limit {tol}); planted fault (token j read from "
              f"chunk row j) {[round(x[0], 4) for x in faulty]}, {faults!r} "
              f"per token (the largest must exceed the limit); reverse "
              f"order max |diff| {rev_diff!r} (expected 0: each choice "
              f"rewrites the rows it reads); wall_ms={ms_shared!r} "
              f"launches {launches} (expected {want})", flush=True)
        checks[f"choices {name} kernel vs plain"] = (
            max(errs) <= tol
            and [x[1] for x in shared] == [x[1] for x in plain_sh])
        checks[f"choices {name} planted fault fails"] = max(faults) > tol
        checks[f"choices {name} reverse order"] = rev_diff == 0.0
        checks[f"choices {name} launches"] = launches == want
        if not use_sel:
            pairs, ms_pairs, _ = counted(lambda: [
                eng.loglikelihood(input_ids, c, **vision) for c in choices])
            perr = [ll_per_token(a[0], b[0], n) for a, b, n in
                    zip(shared, pairs, CHOICE_LENS)]
            pfault = [ll_per_token(a[0], b[0], n) for a, b, n in
                      zip(faulty, pairs, CHOICE_LENS)]
            print(f"[eval] orig: each choice's chunk against its per-pair "
                  f"loglikelihood (full prefill): |diff| per token {perr!r} "
                  f"(limit {LL_TOL_CHUNK}), greedy flags equal "
                  f"{[x[1] for x in shared] == [x[1] for x in pairs]}; "
                  f"planted fault (token j read from chunk row j) "
                  f"{pfault!r} per token (the largest must exceed the "
                  f"limit); wall ms: shared prefill + {len(choices)} chunks "
                  f"{ms_shared!r} against {len(choices)} per-pair prefills "
                  f"{ms_pairs!r}", flush=True)
            checks["choices orig vs per-pair"] = (
                max(perr) <= LL_TOL_CHUNK
                and [x[1] for x in shared] == [x[1] for x in pairs])
            checks["choices orig vs per-pair planted fault fails"] = (
                max(pfault) > LL_TOL_CHUNK)

    eng = M.QwenVLEngine(cfg, params, device="cuda")
    plain = M.QwenVLEngine(cfg, params, device="cuda", attn_impl="plain")
    (ll_k, gr_k), ms, launches = counted(
        lambda: eng.loglikelihood(text_ctx, cont))
    ll_p, gr_p = plain.loglikelihood(text_ctx, cont)
    late = M._score_continuation
    with patched(M, "_score_continuation",
                 lambda p, h, n, *a: late(p, h, n + 1, *a)):
        ll_f, _ = eng.loglikelihood(text_ctx, cont)
    err, fault = (ll_per_token(ll_k, ll_p, LL_CONT_LEN),
                  ll_per_token(ll_f, ll_p, LL_CONT_LEN))
    want = {"diag_attn_fwd": 0, "flash_varlen_fwd": n_layers,
            "decode_blocked_fwd": 0}
    print(f"[eval] loglikelihood text-only ({TEXT_CTX_LEN} ids): kernel "
          f"ll={ll_k!r} plain ll={ll_p!r}: |diff| per token {err!r} (limit "
          f"{LL_TOL_SAME}); planted fault (scored one position late) ll="
          f"{ll_f!r}, {fault!r} per token (must exceed the limit); wall_ms="
          f"{ms!r} launches {launches} (expected {want})", flush=True)
    checks["ll text kernel vs plain"] = err <= LL_TOL_SAME and gr_k == gr_p
    checks["ll text planted fault fails"] = fault > LL_TOL_SAME
    checks["ll text launches"] = launches == want
    return checks, k5_launches


def harness_checks(cfg, params, tmp, hf_dir):
    """Phase 7.4-7.5: ``evaluate`` through the port's EngineAdapter on the
    synthetic tasks (``_IdTokenizer``, EVAL_TIME=true), then the
    ``api.run_eval`` CLI on phase 6's HF directory in a process of its
    own. Returns the checks' results."""
    import numpy as np

    from visionselector_tpu_torch.api.run_eval import _IdTokenizer
    from visionselector_tpu_torch.eval.evaluator import EngineAdapter, evaluate
    from visionselector_tpu_torch.eval.tasks import (
        TASKS,
        load_task_configs,
        load_task_docs,
    )
    from visionselector_tpu_torch.models.qwen25vl import model as M

    try:
        import PIL  # noqa: F401
        with_image = True
    except ImportError:
        with_image = False
    print(f"[eval] PIL imports: {with_image} (image docs through the "
          f"adapter {'included' if with_image else 'left out'})", flush=True)
    task_dir = eval_task_dir(tmp, with_image)
    names = load_task_configs(task_dir)
    checks = {}
    saved = os.environ.get("EVAL_TIME")
    os.environ["EVAL_TIME"] = "true"
    try:
        eng = M.QwenVLEngine(cfg, params, use_selector=True, budget=0.2,
                             device="cuda")
        adapter = EngineAdapter(eng, _IdTokenizer())
        log = os.path.join(tmp, "eval_samples.jsonl")
        t0 = time.perf_counter()
        res = evaluate(adapter, names, task_dir, log_samples_path=log)
        wall = time.perf_counter() - t0
        with open(log) as f:
            recs = [json.loads(line) for line in f]
        n_docs = {n: len(load_task_docs(TASKS[n], task_dir)) for n in names}
        want_keys = {f"{n}/{k}" for n in names for k in (
            TASKS[n].metric, "stderr", "n", "wall_s")} | set(EVAL_TIME_KEYS)
        preds_ok = (len(recs) == sum(n_docs.values()) and all(
            isinstance(r["prediction"], str) for r in recs))
        mc = [r for r in recs if r["task"] == "smoke_mc"]
        argmax_ok = True
        for req, rec in zip(load_task_docs(TASKS["smoke_mc"], task_dir), mc):
            kw, _ = adapter._prepare_request(req)
            conts = [np.asarray(_IdTokenizer().encode(" " + c.strip()))
                     for c in req.choices]
            lls = M.run_loglikelihood_choices(eng, kw.pop("input_ids"),
                                              conts, **kw)
            argmax_ok &= rec["prediction"] == "ABCD"[int(np.argmax(
                [ll for ll, _ in lls]))]
        print(f"[eval] evaluate (selector 0.2, _IdTokenizer, EVAL_TIME): "
              f"{n_docs} docs in {wall!r} s; predictions "
              f"{[r['prediction'] for r in recs]}; results {res}; "
              f"avg_prefill_ms={res.get('avg_prefill_ms')!r} "
              f"avg_latency_ms={res.get('avg_latency_ms')!r} wall_s "
              f"{ {n: res.get(f'{n}/wall_s') for n in names}!r}", flush=True)
        checks["evaluate: every doc predicted"] = preds_ok
        checks["evaluate: the reference's metric keys"] = set(res) == \
            want_keys
        checks["evaluate: MC = argmax of the lls"] = argmax_ok

        out_dir = os.path.join(tmp, "run_eval_out")
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "visionselector_tpu_torch.api.run_eval",
             "--model-path", hf_dir, "--data-dir", task_dir,
             "--task-config-dir", task_dir, "--tasks", ",".join(names),
             "--budgets", "0.2", "--device", "cuda", "--output-dir",
             out_dir], capture_output=True, text=True, timeout=600,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        secs = time.perf_counter() - t0
        files = sorted(os.listdir(out_dir)) if os.path.isdir(out_dir) else []
        tail = (r.stdout.strip().splitlines()[-1] if r.returncode == 0
                else r.stderr[-3000:])
        print(f"[eval] api.run_eval --model-path <phase-6 HF dir> --device "
              f"cuda: rc={r.returncode} in {secs!r} s, files {files}; "
              f"{tail}", flush=True)
        checks["api.run_eval on cuda"] = (
            r.returncode == 0 and "selector_0.2_rank0.json" in files
            and "samples_selector_0.2_rank0.jsonl" in files)
    finally:
        if saved is None:
            os.environ.pop("EVAL_TIME", None)
        else:
            os.environ["EVAL_TIME"] = saved
    return checks


def eval_phase(cfg, params, input_ids, pixels, grid, tmp, hf_dir) -> int:
    """Phase 7. Raises if any check failed; returns the K5 launches of the
    selector request's ``run_loglikelihood_choices`` (t_c = 32)."""
    t0 = time.perf_counter()
    print(f"[eval] card: {nvidia_smi()}", flush=True)
    checks, k5 = ll_checks(cfg, params, input_ids, pixels, grid)
    checks.update(harness_checks(cfg, params, tmp, hf_dir))
    print(f"[eval] checks: {checks}", flush=True)
    print(f"[eval] phase seconds {time.perf_counter() - t0!r}", flush=True)
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"eval phase failed: {bad}")
    return k5


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); this smoke runs only on the GPU", file=sys.stderr)
        return 2
    from visionselector_tpu_torch.core.config import qwen25vl_3b
    from visionselector_tpu_torch.kernels import _build
    from visionselector_tpu_torch.models.qwen25vl.model import QwenVLEngine
    from visionselector_tpu_torch.models.qwen25vl.weights import init_params

    t_start = time.perf_counter()
    smi = nvidia_smi()
    print(f"[device] {smi}", flush=True)
    print(f"[device] python {sys.version.split()[0]} torch {torch.__version__}"
          f" cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}"
          f" count {torch.cuda.device_count()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}", flush=True)
    t0 = time.perf_counter()
    _build.load()
    print(f"[build] {_build.library_path()} built in "
          f"{_build.BUILD_SECONDS!r} s (load {time.perf_counter() - t0!r} s)",
          flush=True)
    for line in _build.PTXAS_LOG.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")

    cfg = qwen25vl_3b()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = init_params(cfg, gen, "cuda", torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"[weights] qwen25vl_3b random bf16: {n_params} parameters in "
          f"{time.perf_counter() - t0!r} s", flush=True)
    input_ids, pixels, grid = request(cfg)
    engine = QwenVLEngine(cfg, params, use_selector=True, budget=0.2,
                          device="cuda")

    kernels = check_kernels(cfg, engine, input_ids, pixels, grid)
    launches = run_main_path(cfg, params, input_ids, pixels, grid)
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} never launched on the main path")
    variants = run_variant_paths(cfg, params, input_ids, pixels, grid)
    out_dir = profile_phase(cfg, params, input_ids, pixels, grid)
    profile_variants(cfg, params, input_ids, pixels, grid, out_dir)
    ablation = run_ablation()
    # The serving path: flash, diag and decode launches; the fused and
    # packed kernels count on their own paths, the ablation on its entry
    # point's run.
    launches = serve_phase(cfg, params, input_ids, pixels, grid, out_dir)
    launches["fused_vit_attn_fwd"] = variants["fused"]["fused_vit_attn_fwd"]
    launches["flash_packed_fwd"] = variants["packed"]["flash_packed_fwd"]
    launches["fullattn_ablate_fwd"] = ablation["fullattn_ablate_fwd"]
    # Phases 6 and 7 write under .smoke_tmp/ (git-ignored), removed at the
    # end: phase 7 evaluates phase 6's HF directory.
    scratch = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           ".smoke_tmp")
    os.makedirs(scratch, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=scratch)
    try:
        hf_dir = training(cfg, params, input_ids, pixels, grid, out_dir, tmp)
        # The eval path: the selector request's choices, counted on their
        # own (phase 7 zeroes the counts just before and reads them after).
        launches["decode_blocked_fwd_t_c32"] = eval_phase(
            cfg, params, input_ids, pixels, grid, tmp, hf_dir)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    summary = {"kernels": [
        {"name": name, "route": "cuda", "source": SRC + KERNELS[name][0],
         "replaces": KERNELS[name][1], "launches": launches[name],
         **{k: res[k] for k in keys}}
        for name, res in kernels.items()
    ]}
    print(f"[done] {time.perf_counter() - t_start!r} s", flush=True)
    print(smi)
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
