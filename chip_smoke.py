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
   scoring's chunk, at the cache's base, 0 and across a tile edge, and at
   t_c 256, a chunked admission's decoder segment, at bases 256, 0, 1,280
   and 1,312, each with a planted fault: chunk row i sees position base +
   i + 1; also against its
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
   removed after phase 9.
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
8. Strategies (``strategies``), on phase 3's weights and request: every
   training-free baseline (``selector.baselines``) through
   ``QwenVLEngine(strategy=...).generate`` at budget 0.2, 8 greedy tokens,
   the counters zeroed just before and read just after each: its prefill
   wall, kept count, ``prefill_len`` and K1 / K4 / K5 launches (ViT-side:
   the last ViT block through ``attention_with_received``, so one ViT K1
   fewer; LLM-side: 36 causal K1 split between stage A and stage B).
   visionzip, fastv and dart again under ``attn_impl="plain"``: the first
   token equal and the kept sets within phase 3's overlap (VisionZip's
   dominant tokens: its stride-picked contextual ones shift with any
   dominant one). A teacher-forced decode step on the FastV cache (layers
   [0, 2) at t_orig rows, the rest at the kept ones, from t_orig +
   rope_delta): each layer's K5 call against ``decode_blocked_plain``
   within ULP_LIMIT, the logits against the dense plain step within
   TEACHER_TOL. ``attention_with_received`` at the last ViT block's shape
   (timed) and against a dense [H, S, S] softmax at S = 2,048, the FastV
   column sum at the ``orig`` length against a dense causal softmax (timed),
   each with a planted fault (padding keys left visible, the causal mask
   dropped) that must fail; the host strategies' times;
   ``api.run_token_compression --methods fastv,visionzip`` (``api.run_eval
   --method`` once per method) on phase 6's HF directory in a process of
   its own.
9. Serve (``http``): ``api.serve.Server`` with no tokenizer (the stub
   prompt ids) on a ``ThreadingHTTPServer`` at 127.0.0.1 over phase 3's
   engine. ``/health`` and ``/``; ``/generate`` with the phase-3 image as
   a PNG (``preprocess.png.encode_png``), 32 tokens, equal to one-shot
   ``generate`` of the same ids; the same request streamed (ndjson: the
   chunks concatenate to those tokens; the first chunk's arrival time);
   ``/v1/chat/completions`` plain and SSE; a three-turn session on an
   ``orig`` server (turn 2's first token equals a fresh prefill of the
   concatenated stream's); two requests sharing their prefix through
   ``--prefix-cache 2`` (a hit, the first token unchanged); ``--micro-batch
   4`` with four concurrent requests (first tokens equal one-shot; decode
   tok/s). Then servers built as ``--continuous 8 --continuous-prefill-chunk
   256 --continuous-prefill-vit-segments 4`` take phase 5's arrival pattern
   (its first 4 selector requests, then a text request decoding when phase 5's
   two ``orig`` requests arrive), submitted to their batchers from threads
   as handler threads do, and the same mix with one-shot admissions:
   chunked admissions and steps counted, K1 / K4 / K5 launches (K5 per t_c)
   equal to what the admissions' segments and the decode steps make, first
   tokens equal one-shot, ``max_decode_gap_ms``, TTFT and tok/s of both.
   Last, ``python -m visionselector_tpu_torch.api.serve --device cuda
   --model-path`` on phase 6's HF directory in a process of its own:
   ``/health`` and one ``/generate``, then it is terminated.
10. Video (``video``), on phase 3's weights: a seeded 16-frame 360x640
   clip written under ``.smoke_tmp/`` as an ``.npy`` file and as PNG
   frames; ``process_video`` on both gives equal pixels, grid (8, 26, 46),
   the 16,384 bucket with ``full_kv_iters`` 32 and 2,392 merged tokens;
   its host preparation on the native (C) and numpy paths, which must
   agree (the native library must build on the card's host). Then seven
   requests, 32 greedy tokens each, the counters zeroed just before and
   read just after each: the clip at selector 0.1 and 0.2 and ``orig``;
   two images (the phase-3 image and a 448x448 one, bucket 8,192) and the
   448x448 image + the clip (bucket 16,384) at 0.2 and ``orig``: 28 K4 and
   4 + 36 K1 per prefill, the ViT's 4 K1 capped (K2) in the 16,384 bucket
   and none in the 8,192 one, 36 K5 per decode step, each against
   ``attn_impl="plain"`` with phase 3's tolerance; prefill ms, decode
   tok/s, ViT device ms and peak memory printed. K2 on q, k and v captured
   from the clip's first ViT full layer at its own segments, bounds and
   cap: ULP_LIMIT against the plain version, a planted fault (each q
   tile's last kv tile dropped) that must fail, prologue and main loop
   apart, its bound and one SDPA call with the segment mask. Then the clip
   through ``ContinuousBatcher`` with a chunked admission (256-row
   segments, 4 tower groups) and a one-shot one (first token equal to
   one-shot ``generate``, 4 capped launches each), its 4 choices against
   per-choice ``loglikelihood`` within LL_TOL_CHUNK, ``evaluate`` on a
   ``videomme`` doc of the ``.npy`` clip, ``api.run_eval --http-endpoint``
   against phase 9's server on text-only and image docs, and two clips of
   one grid through a prefix store (no hit).

11. LLaVA-OneVision-1.5-8B (``ov``): ``llava_ov15_8b()`` at full width
   from a seeded generator on the card (bf16, the scorer fp32), 8.5 B
   parameters beside phase 3's. The phase-3 image at its own 1036x1456
   (grid 1x74x104, 7,696 patches, the 8,192 bucket: S' = 8,192 + 8 CLS
   slots, padded to 8,256 rows, 1,924 merged tokens) and its 40 text ids.
   K1 at RICE block 0's captured q / k / v (16 heads, D = 64, a 7,697-row
   segment, bounds at the 64-row tile; fault: each q tile's last kv tile
   dropped), K1 causal at the decoder's layer 0 (GQA 32/8, D = 128) under
   the selector and ``orig`` (fault: the diagonal kv tile cut), K5 at 8 kv
   heads (n_rep 4) over the ``orig`` cache's layer 0 and a 4-slot pool,
   bf16 and int8 (fault: the last live tile skipped): ULP_LIMIT against
   their plain versions, times, bounds, SDPA. Then the selector 0.2 (k =
   384, k_max = 409) and ``orig`` requests, 32 greedy tokens, the counts
   zeroed just before and read just after: 24 RICE K1 + 36 causal K1 per
   prefill, no K4, K6, capped or packed launch, 36 K5 per decode step;
   against ``attn_impl="plain"`` with phase 3's tolerance (and the first
   token where the plain top-2 gap exceeds twice the drift). Prefill wall
   and device ms, RICE device ms, decode wall and device ms per token, peak
   memory. The choices (1, 5, 12, 20 ids) against per-choice
   ``loglikelihood`` within LL_TOL_CHUNK; ``generate_batch`` and a
   ``ContinuousBatcher(n_slots=4)`` of 6 requests (image, text, two images,
   one sampled) against one-shot first tokens; VisionZip and FastV at 0.2
   (launches; phase 8's rule against the plain path); two images (the
   phase-3 image and a 224x224 one, the same bucket) at 0.2 and ``orig``;
   an OV HF directory at reduced depth (RICE blocks 0 and 23, decoder
   layers 0 and 35, full widths) written, read back bit for bit, and
   served by ``api.predict --family llava_ov15 --model-path`` in a process
   of its own (first token equal to the in-process engine's), and
   ``api.predict --family llava_ov15`` on the tiny config (head dims 16
   and 32) on the card.

12. LLaVA-OV-1.5-8B training and acceptance (``ov-train``), on phase
   11's weights: 2 samples of the phase-3 image at OV's layout (S' 8,256,
   1,924 merged, k 384, k_max 409), its 40 prompt ids and a 32-id answer
   each (1,998 of 2,048 text rows). K1 causal at the step's shape (B = 2,
   GQA 32/8, D = 128; q / k / v captured from decoder layer 0) against its
   plain version (fault: the diagonal kv tile cut), and its gradient
   (``check_flash_grad`` at T = 2,048). The CE's scorer gradients at the
   initial parameters against plain attention by autograd (the LM's, and
   RICE's too) within TRAIN_GRAD_TOL, planted mirror faults above it,
   remat equal (no fp32 reference: an fp32 copy of the 8B does not fit
   beside both models). 4 AdamW steps without remat and 4 with it (reg
   weight 0.1 -> 3.0, the OV recipe), the last of each under the
   profiler: 48 RICE + 36 causal K1 per step (+ 36 with remat), the
   schedule, finite losses, frozen weights bit-equal. Printed: step wall,
   device busy and idle share, forward / backward / mirror device ms,
   tokens/s, peak memory with and without remat. Then, as processes on
   the card: ``api.train --family llava_ov15 --smoke`` and ``--model-path``
   phase 11's directory (3 steps, B = 2), the trained scorer copied into a
   copy of that directory and served by ``api.predict`` (first token equal
   to the in-process engine's), ``api.acceptance`` on phase 6's 3B and
   phase 11's OV directories (``--prompt-ids``, ``regression8`` on phase
   7's generate docs as a ``chartqa`` file): PASS; in process,
   ``verify_checkpoint --verify`` against the 3B transcript with one token
   changed must exit 1. Phases 4 and 11 also hold the LM head (one bf16
   GEMM with fp32 output) to its upcast path (``head_check``).

13. Speculative decoding and the int4 pool (``spec``), on phase 3's and
   phase 11's weights. K5 at t_c 8 (a verify chunk of m = 7 proposals):
   the 8-slot, 2,048-row pool at bases ``DECODE_LENS`` - 8 and one slot at
   the ``orig`` cache, and OV-8B's n_rep 4 (one slot at base 1,966 and a
   4-slot pool), bf16 and int8, each within ULP_LIMIT of its plain
   version, with ms, bound and one SDPA call (causal within the chunk +
   length mask); a planted off-by-one in the in-chunk causal limit (the
   kernel given base + 1) must fail. ``generate_speculative`` on the
   phase-3 selector request at m = 3 and m = 7 (32 tokens): the first
   token equal to ``generate``'s, every emitted token the accepted prefix
   of its verify step's argmaxes (each step recorded), dispatches,
   accepted proposals, wall and device ms per emitted token and per verify
   step beside the plain decode's; the m = 7 run's K5 launches (zeroed
   just before, read just after) are 36 per verify step, all at t_c 8. On
   copies of one prefill cache: the t_c 8 verify rows against 8 t_c 1
   steps and against ``attn_impl="plain"`` within TEACHER_TOL, and the
   plain decode's own next 7 tokens proposed: a = 7, or the first
   rejected row's top-2 margin within twice its measured drift. The
   speculative batcher (m = 3, 8 slots, chunk 8) on 6 of phase 5's
   requests (4 greedy, one sampled, one penalized), bf16 and int8 pools:
   budgets, first tokens equal to one-shot, ``spec_steps`` /
   ``spec_tokens``; one dispatch of 8 rounds over 8 admitted slots, wall
   against device busy. The int4 pool: its bytes beside bf16's and int8's,
   a teacher-forced decode step over 8 admitted slots (5 image and 3
   text-only requests): the int4 route against K5 over the same values
   and scales held as int8 (the step's own row quantized to 4 bits
   there too), within TEACHER_TOL, and the int8 and int4
   pools' drift against the bf16 pool, under INT4_DRIFT_TOL (the
   reference's 0.25, set on an image request) on the image slots, the
   text-only slots' printed beside them; decode device ms per step of
   each pool (no K5 launch on int4, 36 plain-route calls a step), 4
   requests through an int4 batcher. OV-8B: one speculative
   request (m = 7), its first token equal to ``generate``'s, 36 K5
   launches at t_c 8 per verify step.
14. The trainers of ``api.train`` (``train-methods``), on phase 3's and
   phase 11's weights. While OV-8B is on the card: ``api.train --smoke``
   with ``--method dynamic``, ``--method sft --lora-rank 8`` and
   ``--async-save`` start in processes of their own (3 steps each; their
   log, checkpoint and export are checked at the phase's end), and
   OV-8B LoRA SFT (rank 64, alpha 16) takes 3 steps on phase 12's batch:
   the base weights bit-equal, every adapter changed, step wall and peak
   memory; then the merge (in place) against the adapter model, logits
   within MERGE_TOL and the first greedy token equal. OV-8B's weights go.
   (a) K1 causal on packed rows (B = 2, T = 2,048, 4 samples of 330 rows
   a row, each its own segment, GQA 16/2, D = 128) within ULP_LIMIT of
   its plain version, the row's segments merged into one for the kernel
   as the planted fault, ms, bound, visited and valid pairs, one SDPA
   call (causal + segment mask); its gradient through
   ``FlashAttentionFn`` against autograd of the plain version (GRAD_TOL).
   (b) K4 under autograd on the ViT's first window layer (q, k, v
   captured from a phase-3 prefill): its gradients through
   ``FlashAttentionFn`` against autograd of ``diag_plain`` (GRAD_TOL),
   the mirror given one merged segment as the planted fault, one launch
   under grad, the mirror's ms beside K4's. (c)
   ``api.train._packed_stream`` over 8 seeded 448x448 records (rows of 4
   records, 1,320 ids, vision bucket 4,096, text bucket 2,048): 4 selector
   steps (28 K4 + 4 K1 per row and 36 causal K1 a step, the loss falls),
   then 4 unpacked steps over the same records at the same buckets and 4
   at the smallest that hold one record (1,024 / 512); step wall and
   valid tokens/s of each. (d) ``--method dynamic`` at full width
   (predictor 2,048 -> 512, 8 heads) on phase 6's batch: the CE's and the
   weighted mask loss's gradients on the predictor apart (norms, cosine),
   and a step along the mask loss's alone lowers it on the same Gumbel
   draws; one ``dynamic_train_step`` on fixed draws moves the predictor
   against the gradient and lowers the objective on them; 4 steps: CE,
   mask loss and keep ratio, the predictor moved by every step with lr >
   0, 2 causal K1 launches without grad and 34 with, every model weight
   bit-equal; the exported predictor reloaded bit for bit gives
   ``DynamicSelect`` the in-memory predictor's first token. (e)
   3B full-LM SFT, 3 steps on phase 6's batch: the loss falls, the ViT
   and scorer bit-equal, every LM tensor changed, peak memory; then with
   ``--tune-mm-vision`` on one sample, window block 0's q-kernel gradient
   against every attention plain by autograd (the ViT blocks and the LM
   recomputed in the backward) within TRAIN_GRAD_TOL, with K4's output
   detached as the planted fault; this trains the 3B's LM in place, so
   it runs after every other phase that reads it.
15. Preference and RL training (``preference``). While OV-8B is on the
   card: ``api.train --smoke`` with ``--method dpo``, ``--method dpo
   --grad-accum-steps 2 --dpo-loss-type ipo``, ``--method grpo`` and
   ``--family llava_ov15 --method grpo --lora-rank 8`` start in processes
   of their own (3 steps each), and after 14f (c) OV-8B DPO of LoRA
   adapters (rank 64; one pair of phase 12's image at T = 2,048, 2 steps):
   step 0's loss ln 2, the base bit-equal, every adapter B changed, step
   wall, peak memory. After phase 14, (b) then (a). (b) 3B GRPO of LoRA
   adapters (rank 64, beta 0.04, the grpo reduction, 2 steps) on one
   prompt (phase 3's image and ids with the assistant opener): 4 rollouts
   of up to 32 tokens at temperature 1 through ``QwenVLEngine(
   use_selector=False)`` with the adapters live, each equal to one-shot
   ``generate`` with its seed, at least 2 distinct, 36 K5 launches per
   decode step; a synthetic reward; the first completion row's
   log-softmax from the training forward against the engine prefill's
   (the heads' fp32 rounding, within 4 bf16 ulps; the vision run spliced
   one slot late as the planted fault); step 0's KL exactly 0 and
   clip_ratio 0; the base bit-equal, every B changed and every A
   unchanged after the two steps; rollout and step walls, peak memory;
   the adapters are then merged into the decoder. The CLIs' outputs (log,
   checkpoint-3, ``lora_merged``) are checked and their resumed runs
   start. (a) 3B DPO of the whole decoder (phase 6's image and prompt,
   phase 6's answer against a seeded one, T = 1,536, sigmoid, beta 0.1, 3
   steps): at the starting weights one decoder leaf's DPO gradient against
   every attention plain by autograd (TRAIN_GRAD_TOL; chosen and rejected
   swapped on the plain side as the planted fault); step 0's loss ln 2,
   the margin > 0 after the steps, the reference copy bit-equal before
   and after, the ViT and scorer bit-equal, every decoder tensor changed,
   K1 (with and without grad) and K4 launches per step against the count
   the code implies, step wall and peak memory. (d) The resumed CLIs
   (resumed at step 3, no step taken); ``train.check_data`` (exit 0 on
   clean records, 1 on three broken ones) and ``train.prep_data``
   (filter; sample-merge byte-equal for one seed, not for another). Trains
   the 3B's decoder in place, so it runs last.
16. Weight-only quantization (``quantize``; ``--quantize int8 | int4 |
   int4:g128``; the decoder's seven kernels a layer as int8 or packed
   int4 buffers, fp32 scales). (d) While OV-8B is on the card (after
   phase 14's OV part): phase 11's selector request under bf16, int8 and
   int4:g128, each quantized in place from the bf16 kernels (put back from
   host copies in between): 252 weight-only GEMM (kernel A) launches a
   decode step, and 252 dequantize-route calls and dequantize-kernel
   (kernel B) launches a prefill, the first token and prefill logits
   against the plain routes (``attn_impl="plain"``, an empty
   ``WQ_MAX_ROWS``) by phase 3's rule, a teacher-forced decode step of the
   kernel route against the dequantize route (TEACHER_TOL), prefill device
   ms and decode device ms per token, LM bytes and peak memory beside
   bf16's. After phase 15: (a) kernel A's instantiations with their ptxas
   lines and each shape's plan (blocks, splits, stages, shared memory);
   kernel A against ``wq_matmul_plain`` at the seven kernel shapes of the
   3B, of OV-8B and of the 7B, 1 / 8 / 16 / 32 / 48 / 64 rows, each spec,
   within
   ULP_LIMIT; four planted faults (the last 16 k rows skipped, int4
   nibbles swapped, group g read with g + 1's scale, a K split's partial
   dropped) must fail it; kernel B bit-equal to ``wq.dequantize`` at
   every shape and spec; per shape at one row kernel A's ms, its bound
   (Wq + scales + x + y over 3.35 TB/s), the dequantize route's ms, the
   library call's (``torch._weight_int8pack_mm`` /
   ``torch._weight_int4pack_mm``, held to the plain version within
   ULP_LIMIT) and a bf16 ``torch.mm`` on an unquantized weight of the
   shape; the 3B's and the 7B's shapes also at 16, 32 and 64 rows on both
   routes (the 3B's set ``WQ_MAX_ROWS`` per format); kernel B's ms at the
   3B's and the 7B's shapes beside its bound (Wq + scales + the bf16
   transient) and the plain dequantize's (``chiprun_out/quant_kernels.txt``;
   each layer's seven products summed printed). (b) The 3B under bf16, then each spec, phase
   3's request at selector 0.2, 32 greedy tokens, with (d)'s checks and
   numbers, and the prefill logits' distance from bf16's. (c) ``ContinuousBatcher(n_slots=8)`` over the
   int4:g128 3B, six of phase 5's greedy requests on a bf16 and an int8
   pool: each first token equals its one-shot ``generate``'s. (e) In
   processes beside the phase (started after (a)): ``api.predict
   --quantize int8``, ``api.run_eval --quantize int8`` and ``api.serve
   --quantize int4:g128 --continuous 4`` (two requests at the phase's end)
   on phase 6's reduced-depth directory, ``api.predict --family
   llava_ov15 --quantize int4:g128`` on phase 11's. Prints the phase's
   seconds and its parts'.
17. Qwen2.5-VL-7B and the MoE decoder (``7b-moe``), after phase 16, with
   the 3B's weights freed: ``qwen25vl_7b()`` at full width and depth from
   a seeded generator (bf16, the scorer fp32 at in features 3,584; ViT 32
   x 1280, LM 28 x 3,584, GQA 28 / 4: n_rep 7, an untied 152,064-row
   head). (a) Its kernels against their plain versions: K1 causal at
   decoder layer 0 under the selector and ``orig`` (fault: the diagonal kv
   tile cut); K5 at n_rep 7, bf16 and int8, at t_c 1 over an 8-slot,
   2,048-row pool at ``DECODE_LENS``, t_c 4 / 8 / 32 over one slot of the
   ``orig`` cache's size at its base 1,302 and t_c 256 at base 1,280
   (fault: the in-chunk causal limit off by one), each with ms, bound and
   one SDPA call. The ViT's K1 / K4 have the 3B's shapes (phase 2);
   kernels A and B at the 7B layer's seven products are checked and timed
   in 16(a). (b)
   Phase 3's request at selector 0.2 and ``orig``, 32 greedy tokens, the
   counts zeroed just before and read just after: 28 K4 + 4 + 28 K1 per
   prefill, 28 K5 per decode step; each first token equal to
   ``attn_impl="plain"``'s; prefill device ms of both and their ratio,
   decode device ms per token, peak memory. ``generate_speculative`` at m
   = 3 and 7 (K5 at t_c 4 and 8) and the choices (K5 at t_c 32), each
   counted; then the selector request under int8, int4 and int4:g128
   (quantized in place, 8 tokens; 196 kernel-A launches a decode step,
   196 kernel-B launches a prefill; phase 16's checks). (c)
   ``ContinuousBatcher(n_slots=8)`` over six of phase 5's greedy requests,
   bf16 pool: first tokens equal one-shot ``generate``'s; then the phase-3
   request as one chunked admission (256-row decoder segments: K5 at t_c
   256) against its one-shot prefill. (d) A
   reduced-depth 7B HF directory (ViT blocks 0 and 7, decoder layers 0 and
   1, full widths, ``lm_head.weight``, the scorer) written under
   ``.smoke_tmp/`` and served by ``api.predict --model-path`` in a process
   of its own: exit 0 and the tokens of the same entry points in process.
   (e) ``OVEngine.generate`` on ``llava_ov_moe_tiny`` on the card equal to
   the CPU port's (tokens and selected indices), and one MoE layer at 128
   experts, top 8, expert width 768, hidden 2,048: the routed path against
   the dense plain scan within MOE_ULPS bf16 ulps, both timed. Prints the
   phase's seconds and its parts'.
18. W8A8 and parallel paths (``parallel_phase``, last; the 3B rebuilt
   from its seed). (a) The 3B ViT quantized W8A8 (a copy; the quantize
   pass timed) on phase 3's image at the 6,144 bucket: each of the five
   padded ``_int_mm`` products bit-equal to the plain int product (fp64 on
   the card, exact), the epilogue within ULP_LIMIT bf16 ulps of its fp64
   version, ms of ``_int_mm``, the bf16 GEMM, the quantize and the
   epilogue; the merged tokens against the bf16 tower (cosine >
   W8A8_COS, relative error < W8A8_REL) and the overlap of the selected
   indices; ViT device ms of both (profiler); 160 ``_int_mm`` launches a
   tower, and the W8A8 engine's request with its launches. (b) K1 causal
   at the tensor-parallel ranks' heads (3B tp 2: 8 / 1; 7B tp 2: 14 / 2)
   and K5 at one kv head (n_rep 8; t_c 1 over the 8-slot pool, 8 and 32
   over one slot of the ``orig`` cache; 7B tp 2 at t_c 1), each with its
   planted fault, ms, bound and SDPA; then a world of TP_WORLD spawned
   ranks (``parallel_rank``) sharing the card over gloo: the decoder
   sharded, phase 3's selector request (first token equal to the unsharded
   engine's, logits within TEACHER_TOL of max |logit|, kept set, launches
   at the local heads counted on rank 0, LM bytes a rank about half),
   speculative decoding at m = 7 equal to plain decode, the choices, a
   2-slot batcher on bf16 and int8 pools against one-shot, and the request
   under each ``--quantize`` spec (quantized whole, then sharded; first
   token and logits against the unsharded quantized engine's, kernel A 7
   x 36 a decode step and kernel B 7 x 36 a prefill at a rank's slices,
   which 16(a) checks and times). (c) K1 at ``vit_forward_sp``'s shapes
   (each shard's 3,072 queries against the 6,144 gathered keys) and K4 at
   its local S, each shard within ULP_LIMIT of the plain version, with
   planted faults, ms, bound and SDPA; in the same world: ``moe_mlp_ep``
   of 17(e)'s layer (64 experts a rank) within ULP_LIMIT bf16 ulps of
   ``_moe_mlp``, and ``vit_forward_sp`` of the 3B tower within ULP_LIMIT
   of ``vit_forward`` (28 K4 + 4 K1 a rank). Prints the phase's seconds
   and its parts'.
19. Data- and pipeline-parallel training, the training CLI under
   ``torch.distributed.run`` and the warm-up (``dp_pp_phase``, last).
   K1 causal at a rank's one sample and at a pipeline microbatch (T
   1,536, GQA 16/2) and K4 at one sample's ViT window layer, each with
   its planted fault, ms, bound and SDPA; the references in this process
   (the 3B rebuilt from its seed): phase 6's selector steps at B = 2 (2
   at accumulation 1, 1 at accumulation 2) and ``lm_prefill_layers`` of
   the 36 layers at B = 2, T = 1,536 with its gradients; then a world of
   TP_WORLD spawned ranks over gloo on the card (``dp_pp_rank``): (a) the
   same steps data-parallel, one sample a rank (losses within
   DP_LOSS_TOL, step-1 averaged scorer gradients within GRAD_TOL, the
   ranks' scorers bit-equal, 28 K4 + 40 K1 with 36 through
   ``FlashAttentionFn`` a micro-batch on rank 0; planted: the gradients
   not averaged), (b) ``lm_prefill_layers_pp`` over 2 stages of 18
   layers, M = 2 (hidden states within ULP_LIMIT bf16 ulps, else
   TEACHER_TOL, the rule printed; the gradients of the input and of each
   stage's first q kernel within GRAD_TOL; 36 causal K1 forward and 36
   recomputed under grad a rank; each rank's layer bytes half the whole;
   planted: the last stage's microbatches swapped, the output's gradient
   summed over the stages). Beside them, in processes of their own: (c)
   ``python -m torch.distributed.run --standalone --nproc-per-node 2 -m
   visionselector_tpu_torch.api.train --model-path <phase 6's directory>
   --batch-size 2 --total-steps 2`` against the same command alone (log
   lines from rank 0 only, losses within DP_LOSS_TOL, exported scorers
   within GRAD_TOL) and (d) ``api.warmup --buckets 1024,6144
   --micro-batch 2`` on that directory (exit 0, one line per bucket,
   text-only, decode_batch 2). Prints the phase's seconds and its parts'.

The line before the last is a JSON object describing the kernels (K2's
entry, ``flash_varlen_fwd_capped``, from phase 10; the OV shapes,
``flash_varlen_fwd_rice``, ``flash_varlen_fwd_ov_lm`` and
``decode_blocked_fwd_ov``, from phase 11; K1 at the OV training step's
shape, ``flash_varlen_fwd_ov_train``, from phase 12, its launches the
causal ones of the last step; K5 at t_c 8, ``decode_blocked_fwd_t_c8`` and
``decode_blocked_fwd_ov_t_c8``, from phase 13, its launches those of the
3B's m = 7 run and of OV-8B's; K1 on packed training rows,
``flash_varlen_fwd_packed_train``, from phase 14, its launches the
causal ones of the last packed step; the weight-only GEMM per spec,
``wq_matmul_fwd``, ``wq_matmul_fwd_int4`` and ``wq_matmul_fwd_int4_g128``,
from phase 16, timed as the 3B layer's seven products at one row, its
launches those of 16(b)'s counted request (the ``_7b`` entries: 16(a)'s
times at the 7B layer, phase 17's launches); the dequantize kernel,
``wq_dequant_fwd``, timed as the 3B layer's seven int8 transients, its
launches those of 16(b)'s int8 prefill; the 7B's shapes from phase 17:
``flash_varlen_fwd_7b`` and ``decode_blocked_fwd_7b`` counted in 17(b)'s
requests, ``decode_blocked_fwd_7b_t_c4`` / ``_t_c8`` in its speculative
runs, ``_t_c32`` in its choices, ``_t_c256`` in 17(c)'s chunked
admission, ``wq_matmul_fwd_7b``, ``wq_matmul_fwd_int4_7b``,
``wq_matmul_fwd_int4_g128_7b`` and ``wq_dequant_fwd_7b`` in its quantized
requests; the tensor-parallel shapes from phase 18: ``flash_varlen_fwd_tp2``
and ``decode_blocked_fwd_tp2`` counted in rank 0's request,
``decode_blocked_fwd_tp2_t_c8`` in its speculative run,
``decode_blocked_fwd_tp2_t_c32`` in its choices, ``wq_matmul_fwd_tp2``,
``wq_matmul_fwd_int4_tp2``, ``wq_matmul_fwd_int4_g128_tp2`` and
``wq_dequant_fwd_tp2`` (16(a)'s times at a rank's slices of the 3B
layer) in its quantized requests; the sequence-parallel shapes,
``flash_varlen_fwd_sp2`` and ``diag_attn_fwd_sp2``, in rank 0's
``vit_forward_sp``; the data- and pipeline-parallel shapes from phase 19:
``flash_varlen_fwd_dp`` and ``diag_attn_fwd_dp`` counted on rank 0 over
19(a)'s three steps (the ViT's and the LM's K1), ``flash_varlen_fwd_pp``
over rank 0's pipelined forward and backward in 19(b)); the last line is
``{"ok": true, "device": {...}}``.
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
import threading
import time
from types import SimpleNamespace

ULP_LIMIT = 4
N_TIMED = 10
SEED = 0
MAX_NEW_TOKENS = 32
PROFILE_DECODE_STEPS = 16
SRC = "visionselector_tpu_torch/kernels/csrc/"
TILE = 64  # the kernels' q/kv tile (FLASH_BLOCK)
HBM_BYTES_S = 3.35e12  # H100 SXM device memory rate
BF16_FLOP_S = 989e12  # H100 SXM dense bf16 tensor-core peak
INT8_OPS_S = 1979e12  # H100 SXM dense int8 tensor-core peak
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
WQ_REPLACES = ("none (the XLA convert + dot of _dense, "
               "visionselector_tpu/models/qwen25vl/lm.py:139)")
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
    # K5 at t_c = 256 rows: a decoder segment of a chunked admission
    # (phase 9), a launch shape of its own
    "decode_blocked_fwd_t_c256": ("decode_blocked_fwd.cu",
                                  "visionselector_tpu/kernels/attention.py:"
                                  "1085"),
    "fused_vit_attn_fwd": ("fused_vit_attn_fwd.cu",
                           "visionselector_tpu/kernels/fused_vit_attn.py:144"),
    "flash_packed_fwd": ("flash_varlen_fwd.cu",
                         "visionselector_tpu/kernels/attention.py:521"),
    "fullattn_ablate_fwd": ("flash_varlen_fwd.cu",
                            "tools/bench_fullattn_ablate.py:83"),
    # K2: the flash calls with a kv_iters cap, the ViT's full layers in the
    # 16,384 bucket (phase 10's clip and image + clip requests)
    "flash_varlen_fwd_capped": ("flash_varlen_fwd.cu",
                                "visionselector_tpu/kernels/attention.py:"
                                "389"),
    # LLaVA-OV-1.5-8B (phase 11): K1 in RICE's blocks (head dim 64, CLS
    # rows), K1 causal in the Qwen3 decoder (GQA 32/8), K5 at n_rep 4
    "flash_varlen_fwd_rice": ("flash_varlen_fwd.cu",
                              "visionselector_tpu/kernels/attention.py:203"),
    "flash_varlen_fwd_ov_lm": ("flash_varlen_fwd.cu",
                               "visionselector_tpu/kernels/attention.py:"
                               "203"),
    "decode_blocked_fwd_ov": ("decode_blocked_fwd.cu",
                              "visionselector_tpu/kernels/attention.py:"
                              "1085"),
    # OV-8B training (phase 12): K1 causal at the step's B = 2, T = 2,048
    "flash_varlen_fwd_ov_train": ("flash_varlen_fwd.cu",
                                  "visionselector_tpu/kernels/attention.py:"
                                  "203"),
    # Packed training rows (phase 14): K1 causal at B = 2, T = 2,048 with
    # four samples per row, each its own segment
    "flash_varlen_fwd_packed_train": ("flash_varlen_fwd.cu",
                                      "visionselector_tpu/kernels/"
                                      "attention.py:203"),
    # Speculative decoding (phase 13): K5 at t_c = m + 1 = 8, the verify
    # chunk, on the 3B and on OV-8B (n_rep 4)
    "decode_blocked_fwd_t_c8": ("decode_blocked_fwd.cu",
                                "visionselector_tpu/kernels/attention.py:"
                                "1085"),
    "decode_blocked_fwd_ov_t_c8": ("decode_blocked_fwd.cu",
                                   "visionselector_tpu/kernels/"
                                   "attention.py:1085"),
    # The weight-only quantized product (phase 16): it replaces no Pallas
    # kernel but the XLA convert + dot of the reference's _dense; one entry
    # per --quantize spec, timed as the 3B decoder layer's seven products
    # at one row
    "wq_matmul_fwd": ("wq_matmul_fwd.cu", WQ_REPLACES),
    "wq_matmul_fwd_int4": ("wq_matmul_fwd.cu", WQ_REPLACES),
    "wq_matmul_fwd_int4_g128": ("wq_matmul_fwd.cu", WQ_REPLACES),
    # The dequantize route's transient (kernel B of the same source), timed
    # as the 3B decoder layer's seven int8 kernels
    "wq_dequant_fwd": ("wq_matmul_fwd.cu", WQ_REPLACES),
    # Qwen2.5-VL-7B (phase 17): K1 causal at GQA 28/4, K5 at n_rep 7 per
    # t_c, and kernels A (per spec) and B at the 7B layer's widths
    "flash_varlen_fwd_7b": ("flash_varlen_fwd.cu",
                            "visionselector_tpu/kernels/attention.py:203"),
    **{f"decode_blocked_fwd_7b{sfx}": (
        "decode_blocked_fwd.cu", "visionselector_tpu/kernels/attention.py:"
        "1085") for sfx in ("", "_t_c4", "_t_c8", "_t_c32", "_t_c256")},
    "wq_matmul_fwd_7b": ("wq_matmul_fwd.cu", WQ_REPLACES),
    "wq_matmul_fwd_int4_7b": ("wq_matmul_fwd.cu", WQ_REPLACES),
    "wq_matmul_fwd_int4_g128_7b": ("wq_matmul_fwd.cu", WQ_REPLACES),
    "wq_dequant_fwd_7b": ("wq_matmul_fwd.cu", WQ_REPLACES),
    # Data- and pipeline-parallel training over 2 ranks (phase 19): K1
    # causal at a rank's one sample and at a pipeline microbatch (B = 1, T
    # = 1,536, GQA 16/2), K4 at one sample's ViT window layer
    "flash_varlen_fwd_dp": ("flash_varlen_fwd.cu",
                            "visionselector_tpu/kernels/attention.py:203"),
    "flash_varlen_fwd_pp": ("flash_varlen_fwd.cu",
                            "visionselector_tpu/kernels/attention.py:203"),
    "diag_attn_fwd_dp": ("diag_attn_fwd.cu",
                         "visionselector_tpu/kernels/attention.py:681"),
    # Tensor-parallel serving over 2 ranks (phase 18): K1 causal at the
    # 3B's local 8 / 1 heads (n_rep 8), K5 at n_rep 8 per t_c
    "flash_varlen_fwd_tp2": ("flash_varlen_fwd.cu",
                             "visionselector_tpu/kernels/attention.py:203"),
    **{f"decode_blocked_fwd_tp2{sfx}": (
        "decode_blocked_fwd.cu", "visionselector_tpu/kernels/attention.py:"
        "1085") for sfx in ("", "_t_c8", "_t_c32")},
    # kernels A (per spec) and B at a tp-2 rank's slices of the 3B layer
    "wq_matmul_fwd_tp2": ("wq_matmul_fwd.cu", WQ_REPLACES),
    "wq_matmul_fwd_int4_tp2": ("wq_matmul_fwd.cu", WQ_REPLACES),
    "wq_matmul_fwd_int4_g128_tp2": ("wq_matmul_fwd.cu", WQ_REPLACES),
    "wq_dequant_fwd_tp2": ("wq_matmul_fwd.cu", WQ_REPLACES),
    # The sequence-parallel ViT over 2 ranks (phase 18): K1 with a shard's
    # queries against the gathered keys, K4 at the local S
    "flash_varlen_fwd_sp2": ("flash_varlen_fwd.cu",
                             "visionselector_tpu/kernels/attention.py:203"),
    "diag_attn_fwd_sp2": ("diag_attn_fwd.cu",
                          "visionselector_tpu/kernels/attention.py:681"),
}
ABLATE_S = 5632  # the ablation's sequence (the JAX bench's default)
# Chunked admission's decoder segment (the reference's default
# prefill_chunk) and the bases K5 is checked at there: the second segment
# (the main case), the first, the orig admission's last (1,302 valid rows)
# and one across a tile edge.
ADMIT_SEG = 256
ADMIT_BASES = (256, 0, 1280, 1312)
ADMIT_SELECTOR = 4  # step 9.8's selector requests: phase 5's first 4


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


    p = engine._prep_vision(input_ids, pixels, grid, grid, None, None)
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
                            device=dev)._prep_vision(input_ids, pixels, grid,
                                                     grid, None, None)
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
            for name, rs in results.items() if rs}


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
        for t_c in (1, 4, 16, 32, ADMIT_SEG):
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
    # Chunked admission (phase 9): each decoder segment is lm_decode_chunk
    # at t_c = ADMIT_SEG rows of one slot, R = 2,048 query rows per kv head
    # in 64 row groups of 32, each group re-reading the live prefix; at the
    # bases of the orig admission's segments (the first listed is the JSON
    # line's case) and across a tile edge.
    kname = "decode_blocked_fwd_t_c256"
    for quant in (False, True):
        kc, vc = (k18, v18) if quant else (k1, v1)
        sc = dict(k_scale=k1s, v_scale=v1s) if quant else {}
        for b0 in ADMIT_BASES:
            base = torch.tensor([b0], device=dev)
            qc = rnd(1, ADMIT_SEG, hq, dh)
            nbytes, flop = work(base, ADMIT_SEG, quant, ORIG_CACHE_ROWS)
            library = None
            if not quant:
                library = (lambda q=qc, m=mask(base, ADMIT_SEG,
                                               ORIG_CACHE_ROWS):
                           sdpa_ms(q, k1, v1, m))
            name = (f"{'int8' if quant else 'bf16'} t_c={ADMIT_SEG} B=1 "
                    f"T={ORIG_CACHE_ROWS} Hq={hq} Hkv={hkv} D={dh} base={b0} "
                    f"row_groups={A.decode_rows(ADMIT_SEG, hq // hkv)[1]}")
            case(kname, name,
                 lambda q=qc, b=base, kc=kc, vc=vc, sc=sc:
                     A.decode_blocked_fwd(q, kc, vc, b, **sc),
                 lambda q=qc, b=base, kc=kc, vc=vc, sc=sc:
                     A.decode_blocked_plain(q, kc, vc, b, **sc), [],
                 lambda ms, n=nbytes, f=flop:
                     (f"live_tb_s={n / (ms * 1e-3) / 1e12!r} "
                      f"tflops={tflops(f, ms)!r}"),
                 (nbytes, flop), library)
            split_check(name, qc, kc, vc, base, sc, ADMIT_SEG, quant)
    qc = rnd(1, ADMIT_SEG, hq, dh)
    base = torch.tensor([ADMIT_BASES[0]], device=dev)
    control(kname, "chunk row i sees position base + i + 1",
            A.decode_blocked_fwd(qc, k1, v1, base + 1),
            A.decode_blocked_plain(qc, k1, v1, base))
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
            "flash_varlen_fwd_capped": A.FLASH_CAPPED_LAUNCHES,
            "diag_attn_fwd": A.DIAG_LAUNCHES,
            "decode_blocked_fwd": A.DECODE_LAUNCHES,
            "fused_vit_attn_fwd": F_.FUSED_LAUNCHES,
            "flash_packed_fwd": A.PACKED_LAUNCHES,
            "fullattn_ablate_fwd": A.ABLATE_LAUNCHES}


def zero_counts():
    from visionselector_tpu_torch.kernels import attention as A
    from visionselector_tpu_torch.kernels import fused_vit_attn as F_
    from visionselector_tpu_torch.kernels import wq_matmul as wq

    A.FLASH_LAUNCHES = A.DIAG_LAUNCHES = A.DECODE_LAUNCHES = 0
    A.FLASH_CAPPED_LAUNCHES = A.FLASH_CAUSAL_LAUNCHES = 0
    A.FLASH_GRAD_LAUNCHES = A.DIAG_GRAD_LAUNCHES = 0
    A.PACKED_LAUNCHES = A.ABLATE_LAUNCHES = F_.FUSED_LAUNCHES = 0
    for route in A.FLASH_ROUTE_LAUNCHES:
        A.FLASH_ROUTE_LAUNCHES[route] = 0
    A.DECODE_LAUNCHES_BY_ROWS.clear()
    wq.WQ_LAUNCHES = wq.WQ_DEQUANT_CALLS = wq.WQ_DEQUANT_LAUNCHES = 0


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
    """Phase 4: wall and device time of prefill and decode, peak memory,
    the LM head against its upcast path. Returns the directory the
    per-kernel summaries went to."""
    import statistics

    import torch

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
            eng._prep_vision(input_ids, pixels, grid, grid, None, None)
            prep.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.reset_peak_memory_stats()
        runs = [eng.generate(input_ids, pixels, grid, max_new_tokens=n_new)
                for _ in range(3)]
        peak = torch.cuda.max_memory_allocated()
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
              f"decode_idle_share={1 - step_busy / step_ms!r} "
              f"peak_mem_bytes={peak}", flush=True)
        print(f"[profile] {name} prefill device ms by group: "
              + " ".join(f"{g}={ms!r}"
                         for g, ms in kernel_groups(kernels).items()),
              flush=True)
        top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]
        for kname, (ms, count) in top:
            print(f"[profile] {name} prefill kernel {ms:.3f} ms x{count}: "
                  f"{kname[:100]}", flush=True)
    head_check(params.lm, "[profile]")
    return out_dir


def head_check(lm, tag):
    """The LM head on CUDA tensors (one bf16 GEMM with an fp32 output, no
    fp32 copy of the weight) against the upcast path (both operands fp32,
    what the training head and the CPU run) on 16 seeded bf16 rows:
    within ULP_LIMIT bf16 ulps of each row's largest |value| (both sum
    exact bf16 products in fp32, in another order); the bytes one call
    allocates beside the weight's fp32 copy; both paths' ms at 1 row (a
    decode step's call) and 16. Raises if they disagree or the call
    allocates half the copy's bytes."""
    import torch

    from visionselector_tpu_torch.models.qwen25vl.lm import lm_head

    gen = torch.Generator(device="cuda").manual_seed(SEED + 16)
    h = torch.randn(16, lm.cfg.hidden_size, generator=gen,
                    device="cuda").bfloat16()
    w = lm.embed_tokens.t() if lm.cfg.tie_word_embeddings \
        else lm.lm_head_kernel

    def upcast(x):
        return x.float() @ w.float()

    with torch.no_grad():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        got = lm_head(lm, h)
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - base
        want = upcast(h)
        ulps = bf16_ulp_err(got, want)
        err = (got - want).abs().max().item()
        ms = {n: (cuda_ms(lambda: lm_head(lm, h[:n])),
                  cuda_ms(lambda: upcast(h[:n]))) for n in (1, 16)}
    copy = w.numel() * 4
    print(f"{tag} LM head ({'tied' if lm.cfg.tie_word_embeddings else 'untied'}"
          f" {tuple(w.shape)} {w.dtype}): bf16 GEMM with fp32 output vs the "
          f"upcast path: ulp_err={ulps!r} (limit {ULP_LIMIT}) max_abs_err="
          f"{err!r}; one 16-row call allocates {extra} bytes (the upcast "
          f"path's fp32 weight copy: {copy}); ms at 1 / 16 rows: head "
          f"{ms[1][0]!r} / {ms[16][0]!r}, upcast {ms[1][1]!r} / "
          f"{ms[16][1]!r}", flush=True)
    if not (ulps <= ULP_LIMIT and extra < copy // 2
            and got.dtype == torch.float32):
        raise AssertionError(f"{tag} LM head: {ulps} ulps, {extra} bytes")


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
        vt = eng._vision_tensors(eng._prep_vision(
            input_ids, pixels, grid, grid, None, None).vb)
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


def check_flash_grad(cfg, t=TRAIN_T_BUCKET, valid=(TRAIN_T_BUCKET - 202,
                                                  TRAIN_T_BUCKET - 335),
                     tag="[train]"):
    """Phase 6.1 (and 12.1 at OV's shape): the gradient of K1 at the LM's
    training shape (B = 2, T = 1,536 with padding tails of 202 and 335
    rows, GQA 16/2, D = 128, causal), and the kernel forward's and the
    mirror backward's ms (CUDA events)."""
    import torch

    from visionselector_tpu_torch.kernels import attention as A

    b = TRAIN_BATCH
    hq, hkv, d = (cfg.text.num_attention_heads, cfg.text.num_key_value_heads,
                  cfg.text.head_dim)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").bfloat16()

    q, k, v, g = rnd(b, t, hq, d), rnd(b, t, hkv, d), rnd(b, t, hkv, d), \
        rnd(b, t, hq, d)
    valid = torch.tensor(valid, device="cuda")
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
    print(f"{tag} K1 gradient B={b} T={t} Hq={hq} Hkv={hkv} D={d} causal "
          f"valid={valid.tolist()}: out ulp_err={ulp!r} (limit {ULP_LIMIT}) "
          f"dq/dk/dv rel_err={errs!r} (limit {GRAD_TOL}) pad_rows_zero="
          f"{pad_zero} planted faults {faults!r} (must exceed {GRAD_TOL}); "
          f"kernel forward ms={fwd_ms!r} mirror backward ms={mirror_ms!r}",
          flush=True)
    ok = (ulp <= ULP_LIMIT and max(errs) <= GRAD_TOL and pad_zero
          and min(faults.values()) > GRAD_TOL)
    if not ok:
        raise AssertionError("K1 gradient check failed")
    return fwd_ms, mirror_ms


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
    """Every non-scorer parameter's ``checksums``."""
    return checksums(params, lambda n: not n.startswith("scorer."))


def checksums(params, keep) -> dict:
    """The bits of each parameter whose name ``keep`` accepts, as
    integers summed plainly and weighted by position (mod 65,521): a
    change to any element moves one of the two sums. Computed in chunks
    on the card (no copy of the weights)."""
    return tensor_checksums({name: p for name, p in params.named_parameters()
                             if keep(name)})


def tensor_checksums(named: dict) -> dict:
    """``checksums`` of a {name: tensor} dict."""
    import torch

    sums = {}
    for name, p in named.items():
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


def gradient_checks(cfg, params, state, batch, k_max, tag="[train]",
                    fp32_reference=True) -> dict:
    """Phase 6.2's (and 12.1's) gradient checks at the initial parameters
    (no update): the scorer gradients of the CE alone (reg_weight 0: the
    part that crosses the LM, its attention gradient and the soft top-k's
    VJP; the BCE's part reaches the scorer directly and would hide it) on
    the default path, with remat, and against two references: the LM's
    attention plain and differentiated by autograd (the frozen vision
    tower keeps its kernels), and every attention plain; both references
    run under remat (one layer's plain attention probabilities live at a
    time). Each planted mirror fault must exceed the tolerance against the
    first. ``fp32_reference``: also print both bf16 paths' distances from
    an fp32 copy of the model."""
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
    print(f"{tag} remat: CE scorer grad rel_err={remat_err!r} (limit "
          f"{REMAT_TOL}; q_bias's gradient is zero analytically) bit_equal="
          f"{equal} peak_mem_bytes remat={peak_remat} no_remat={peak_plain}",
          flush=True)
    if fp32_reference:
        # The fp32 reference: the bf16 plain path's distance from it is the
        # noise floor of bf16 rounding, the kernel path's is held beside it.
        g_fp32 = fp32_ce_scorer_grads(cfg, params, batch, k_max)
        floor, kern = grad_err(g_all, g_fp32), grad_err(g_kernel, g_fp32)
        print(f"{tag} CE scorer gradients at the initial parameters "
              f"against the fp32 reference (fp32 weights, every attention "
              f"plain, autograd): the bf16 plain path rel_err={floor!r} (the "
              f"noise floor), the bf16 kernel path rel_err={kern!r}; per "
              f"leaf plain "
              f"{ {n: rel_err(g, g_fp32[n]) for n, g in g_all.items()}!r} "
              f"kernel "
              f"{ {n: rel_err(g, g_fp32[n]) for n, g in g_kernel.items()}!r};"
              f" the kernel path {'is' if kern <= floor else 'is not'} "
              f"within the plain path's distance (ratio {kern / floor!r})",
              flush=True)
    lm_err, all_err = grad_err(g_kernel, g_lm), grad_err(g_kernel, g_all)
    checks["CE scorer gradients vs plain attention by autograd"] = (
        bool(all(torch.isfinite(g).all() for g in g_lm.values()))
        and max(lm_err, all_err) <= TRAIN_GRAD_TOL
        and min(faults.values()) > TRAIN_GRAD_TOL)
    print(f"{tag} CE scorer gradients at the initial parameters, kernel "
          f"forwards + mirror backward against plain attention "
          f"differentiated by autograd (remat, peak_mem_bytes={peak_ref}): "
          f"the LM's rel_err={lm_err!r} per leaf "
          f"{ {n: rel_err(g, g_lm[n]) for n, g in g_kernel.items()}!r}, "
          f"the vision tower's too rel_err={all_err!r} (limit "
          f"{TRAIN_GRAD_TOL}); "
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


def start_cli(procs, tmp, name, *args, key=None):
    """Start ``python -m visionselector_tpu_torch.api.<name> args`` with
    its output in files under ``tmp`` named by ``key`` (default ``name``),
    under which ``procs`` holds it."""
    start_cmd(procs, tmp, key or name, [
        sys.executable, "-m", f"visionselector_tpu_torch.api.{name}", *args])


def start_cmd(procs, tmp, key, cmd):
    """Start ``cmd`` from the repository's root with its output in files
    under ``tmp`` named by ``key``, under which ``procs`` holds it."""
    out = open(os.path.join(tmp, f"{key}.out"), "w")
    err = open(os.path.join(tmp, f"{key}.err"), "w")
    proc = subprocess.Popen(cmd, stdout=out, stderr=err, text=True,
                            cwd=os.path.dirname(os.path.abspath(__file__)))
    out.close()
    err.close()
    procs[key] = (proc, os.path.join(tmp, key), time.perf_counter())


def finish_cli(procs, name):
    """(return code, stdout, stderr, seconds since its start) of a CLI run
    started by ``start_cli``, waiting up to 300 s for it."""
    proc, base, t0 = procs[name]
    rc = proc.wait(timeout=300)
    with open(base + ".out") as f, open(base + ".err") as g:
        return rc, f.read(), g.read(), time.perf_counter() - t0


def reduced_tensors(src: dict, keep: dict) -> dict:
    """A reduced-depth HF tensor dict: the tensors of ``src`` under each
    kept block or layer prefix (``keep``: old prefix -> new), renamed, and
    every tensor outside the ``.blocks.`` / ``.layers.`` stacks."""
    small = {}
    for name, t in src.items():
        for old, new in keep.items():
            if name.startswith(old):
                small[new + name[len(old):]] = t
                break
        else:
            if ".blocks." not in name and ".layers." not in name:
                small[name] = t
    return small


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
    full = cfg.vision.fullatt_block_indexes[0]
    small = reduced_tensors(to_hf_tensors(params), {
        "visual.blocks.0.": "visual.blocks.0.",
        f"visual.blocks.{full}.": "visual.blocks.1.",
        "model.layers.0.": "model.layers.0.",
        "model.layers.1.": "model.layers.1."})
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


# Phase 8 (strategies): every training-free baseline on the phase-3
# request at budget 0.2, 8 greedy tokens each.
STRATEGY_BUDGET = 0.2
STRATEGY_TOKENS = 8
# run again with attn_impl="plain": one ViT-side baseline that reads the
# stats block, and both statistics of the two-stage prefill
STRATEGY_PLAIN = ("visionzip", "fastv", "dart")
# attention_with_received's received mass and the FastV column sum against
# dense fp32 softmaxes on the card: both sides fp32 from the same bf16
# inputs, so they differ by summation order (~1e-6 of the largest value);
# a padding key left visible or the causal mask dropped moves them by
# percents. attention_with_received's output is rounded to q's bf16, so
# it is held to ULP_LIMIT as the kernels are.
STATS_TOL = 1e-4
RECV_CHECK_S, RECV_CHECK_VALID = 2048, 1900


def strategy_task_dir(tmp, with_image) -> str:
    """A generate task for ``api.run_eval --method fastv``: two text-only
    docs and, when PIL imports, one doc with the phase-3 image (the only
    kind a strategy compresses; scoring tasks refuse a strategy)."""
    d = os.path.join(tmp, "strategy_tasks")
    os.makedirs(d)
    with open(os.path.join(d, "tasks.json"), "w") as f:
        json.dump([{"name": "strategy_gen", "metric": "exact_match",
                    "max_new_tokens": 8}], f)
    docs = [{"question": "What is two plus two?", "answers": ["4"]},
            {"question": "Name a primary color.", "answers": ["red"]}]
    if with_image:
        from PIL import Image

        Image.fromarray(request_image()).save(os.path.join(d, "image.png"))
        docs.append({"question": "What does the image show?",
                     "answers": ["noise"], "image": "image.png"})
    with open(os.path.join(d, "strategy_gen.jsonl"), "w") as f:
        f.writelines(json.dumps(doc) + "\n" for doc in docs)
    return d


def strategy_launches(cfg, llm_side: bool, steps: int) -> dict:
    """Launches of one strategy request: a ViT-side strategy runs the last
    ViT block through ``attention_with_received`` (no kernel), the
    two-stage prefill the whole default ViT; the decoder's 36 causal K1
    launches are split between stage A and stage B; K5 once per layer per
    decode step."""
    vc, n = cfg.vision, cfg.text.num_hidden_layers
    full = set(vc.fullatt_block_indexes)
    diag = vc.depth - len(full)
    vit_flash = len(full)
    if not llm_side:
        last = vc.depth - 1
        vit_flash -= last in full
        diag -= last not in full
    return {"flash_varlen_fwd": vit_flash + n, "diag_attn_fwd": diag,
            "decode_blocked_fwd": n * steps}


def stats_checks(cfg, vb, k1_ms) -> dict:
    """``attention_with_received`` (the stats block's attention) and the
    FastV column sum on the card: each against a dense fp32 softmax, each
    with a planted fault that must exceed STATS_TOL, and their times."""
    import torch

    from visionselector_tpu_torch.kernels import attention as A
    from visionselector_tpu_torch.models.qwen25vl import model as M

    checks = {}
    g = torch.Generator(device="cuda").manual_seed(SEED + 8)
    vh, vd = cfg.vision.num_heads, cfg.vision.head_dim

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda",
                           dtype=torch.bfloat16)

    # The main path's shape: the last ViT block over the 6,144 bucket.
    fseg = torch.as_tensor(vb.full_seg_ids, device="cuda")
    s_main = fseg.shape[0]
    q, k, v = (randn(s_main, vh, vd) for _ in range(3))
    ms = cuda_ms(lambda: A.attention_with_received(q, k, v, fseg))
    sdpa = sdpa_ms(q[None], k[None], v[None],
                   ((fseg[:, None] == fseg[None, :]) & (fseg[None, :] > 0)),
                   vd**-0.5)
    print(f"[strategies] attention_with_received S={s_main} H={vh} D={vd} "
          f"(the stats block's attention, plain blocked fp32): {ms!r} ms; "
          f"K1 on the same layer (phase 2's main case) {k1_ms!r} ms; one "
          f"SDPA call with the segment mask (no received mass) {sdpa!r} ms",
          flush=True)

    def rel(got, want):
        return ((got.float() - want).abs().max()
                / want.abs().max()).item()

    s2 = RECV_CHECK_S
    seg = (torch.arange(s2, device="cuda") < RECV_CHECK_VALID).int()
    q, k, v = (randn(s2, vh, vd) for _ in range(3))
    logits = torch.einsum("qhd,khd->hqk", q.float(), k.float()) * vd**-0.5
    mask = (seg[:, None] == seg[None, :]) & (seg[None, :] > 0)
    probs = torch.where(mask, torch.softmax(
        torch.where(mask, logits, A.NEG_INF), -1), 0.0)
    out_ref = torch.einsum("hqk,khd->qhd", probs, v.float())
    recv_ref = probs.mean(0).sum(0) / RECV_CHECK_VALID
    for fault in (None, "unmask_padding_keys"):
        out, recv = A.attention_with_received(q, k, v, seg, fault=fault)
        e_out, e_recv = bf16_ulp_err(out, out_ref), rel(recv, recv_ref)
        ok = e_out <= ULP_LIMIT and e_recv <= STATS_TOL
        print(f"[strategies] attention_with_received S={s2} "
              f"({s2 - RECV_CHECK_VALID} padding rows) against a dense "
              f"[H, S, S] "
              f"softmax{', planted fault ' + fault if fault else ''}: out "
              f"(bf16, q's dtype) {e_out!r} bf16 ulps of its row's largest "
              f"|value| (limit {ULP_LIMIT}), recv (fp32) {e_recv!r} of its "
              f"largest value (limit {STATS_TOL})", flush=True)
        checks[f"attention_with_received{' ' + fault if fault else ''}"] = (
            ok if fault is None else not ok)
    del logits, probs

    # The FastV column sum at the orig length: 1,664 rows, 1,302 valid,
    # the decoder's 16 heads (k expanded), D = 128.
    tc = cfg.text
    t, valid = ORIG_CACHE_ROWS - MAX_NEW_TOKENS, ORIG_BASE_LEN
    q, k = (randn(t, tc.num_attention_heads, tc.head_dim) for _ in range(2))
    seg = (torch.arange(t, device="cuda") < valid).int()
    scale = tc.head_dim**-0.5
    logits = torch.einsum("qhd,khd->hqk", q.float(), k.float()) * scale
    ok_pair = (torch.ones(t, t, dtype=torch.bool, device="cuda").tril()
               & (seg > 0)[None] & (seg > 0)[:, None])
    ref = torch.where(ok_pair, torch.softmax(
        torch.where(ok_pair, logits, -1e30), -1), 0.0).mean(0).sum(0) / valid
    ms_col = cuda_ms(lambda: M._fastv_attention_colsum(q, k, seg, scale))
    sdpa_col = sdpa_ms(q[None], k[None], k[None],
                       ok_pair & (seg > 0)[:, None], scale)
    for fault in (None, "no_causal"):
        got = M._fastv_attention_colsum(q, k, seg, scale, fault=fault)
        err = rel(got, ref)
        ok = err <= STATS_TOL
        print(f"[strategies] FastV column sum T={t} ({valid} valid) H="
              f"{tc.num_attention_heads} D={tc.head_dim} against a dense "
              f"causal softmax{', planted fault ' + fault if fault else ''}"
              f": {err!r} of the largest value (limit {STATS_TOL})",
              flush=True)
        checks[f"colsum{' ' + fault if fault else ''}"] = (
            ok if fault is None else not ok)
    print(f"[strategies] FastV column sum (plain, 128-row query blocks): "
          f"{ms_col!r} ms; one causal SDPA call on the same q, k "
          f"{sdpa_col!r} ms", flush=True)
    return checks


def strategies_phase(cfg, params, input_ids, pixels, grid, tmp, hf_dir,
                     k1_ms):
    """Phase 8: the training-free strategies at full width. Raises if any
    check failed."""
    import dataclasses

    import numpy as np
    import torch

    from visionselector_tpu_torch.kernels import attention as A
    from visionselector_tpu_torch.models.qwen25vl import lm as L
    from visionselector_tpu_torch.models.qwen25vl import model as M
    from visionselector_tpu_torch.selector.baselines import (
        available_baselines,
        get_baseline,
    )

    t_phase = time.perf_counter()
    print(f"[strategies] card: {nvidia_smi()}", flush=True)
    checks = {}
    runs = {}
    vocab = cfg.text.vocab_size
    for name in available_baselines():
        eng = M.QwenVLEngine(cfg, params, budget=STRATEGY_BUDGET,
                             strategy=get_baseline(name), device="cuda")
        eng.generate(input_ids, pixels, grid, max_new_tokens=2)  # warm-up
        torch.cuda.synchronize()
        zero_counts()
        res = eng.generate(input_ids, pixels, grid,
                           max_new_tokens=STRATEGY_TOKENS)
        torch.cuda.synchronize()
        counts = launch_counts()
        routes = dict(A.FLASH_ROUTE_LAUNCHES)
        steps = (len(res.tokens) - 1 if len(res.tokens) == STRATEGY_TOKENS
                 else len(res.tokens))
        llm_side = getattr(eng.strategy, "llm_side", False)
        want = strategy_launches(cfg, llm_side, steps)
        got = {k: counts[k] for k in want}
        kept = len(res.selected_indices)
        print(f"[strategies] {name}: prefill_ms="
              f"{res.prefill_seconds * 1e3!r} kept={kept} of "
              f"{res.num_vision_tokens} prefill_len={res.prefill_len} "
              f"launches K1={got['flash_varlen_fwd']} K4="
              f"{got['diag_attn_fwd']} K5={got['decode_blocked_fwd']} "
              f"(decode steps {steps}; expected {want}) routes {routes} "
              f"tokens {res.tokens}", flush=True)
        checks[f"{name}: launches"] = (
            got == want and routes == {"wgmma": want["flash_varlen_fwd"]}
            and counts["fused_vit_attn_fwd"] == counts["flash_packed_fwd"]
            == 0)
        checks[f"{name}: finite logits, tokens in range"] = bool(
            torch.isfinite(res.logits).all() and res.tokens
            and all(0 <= x < vocab for x in res.tokens))
        checks[f"{name}: kept within the vision tokens"] = (
            0 < kept < res.num_vision_tokens)
        runs[name] = (eng, res)

    # The same requests with every attention plain: the first token and,
    # to phase 3's tolerance, the kept set.
    p = runs["fastv"][0]._prep_vision(input_ids, pixels, grid, grid, None,
                                      None)
    vb = runs["fastv"][0]._vision_tensors(p.vb)
    for name in STRATEGY_PLAIN:
        eng, res = runs[name]
        plain = M.QwenVLEngine(cfg, params, budget=STRATEGY_BUDGET,
                               strategy=get_baseline(name), device="cuda",
                               attn_impl="plain")
        res_p = plain.generate(input_ids, pixels, grid, max_new_tokens=1)
        a = set(res.selected_indices.tolist())
        b = set(res_p.selected_indices.tolist())
        overlap = len(a & b) / max(len(a), len(b))
        diff = (res_p.logits - res.logits).abs().max().item()
        scale = res.logits.abs().max().item()
        line = (f"[plain] {name}: first-token logits max_abs_diff={diff!r} "
                f"(max |logit| {scale!r}) first token kernel="
                f"{res.tokens[0]} plain={res_p.tokens[0]} kept overlap "
                f"{len(a & b)}/{max(len(a), len(b))}")
        if name == "visionzip":
            # VisionZip's contextual tokens are a uniform stride over the
            # tokens left after the dominant ones, so each dominant token
            # that differs shifts every later stride pick and the kept
            # sets' overlap understates the agreement (on the card: 207 of
            # 252 for a handful of near-tied dominant tokens). The
            # dominant tokens, the top by received attention, are held to
            # phase 3's tolerance.
            n = p.n
            dom = int(n * (STRATEGY_BUDGET - eng.strategy.contextual_ratio))

            def top(impl):
                recv = M._vision_stats(params, vb, impl)[1][:n]
                return set(torch.argsort(-recv, stable=True)[:dom].tolist())

            both = len(top(None) & top("plain"))
            overlap = both / dom
            line += (f"; dominant (top {dom} by received attention) "
                     f"{both}/{dom}")
        print(line, flush=True)
        checks[f"{name}: plain first token"] = (
            res_p.tokens[0] == res.tokens[0])
        checks[f"{name}: plain kept overlap"] = overlap >= 0.9
        del plain

    # A teacher-forced decode step on the FastV cache: layers [0, target)
    # hold t_orig rows, the rest the kept ones. Every layer's K5 call is
    # held against its plain version on the same inputs (ULP_LIMIT), and
    # the step's logits against the dense plain decode (TEACHER_TOL).
    eng, res = runs["fastv"]
    state = eng.generate(input_ids, pixels, grid, max_new_tokens=2,
                         _defer_decode=True)
    target = eng.strategy.target_layer
    lengths = state.cache.length[:, 0].tolist()
    n_layers = cfg.text.num_hidden_layers
    checks["fastv: per-layer cache lengths"] = lengths == (
        [p.t_orig] * target + [res.prefill_len] * (n_layers - target))
    checks["fastv: decode starts at t_orig + rope_delta"] = (
        state.start_pos == p.t_orig + int(p.rope_delta))
    errs = []
    decode_attention = L.chunk_decode_attention

    def held(q, k_cache, v_cache, base_len, impl=None, **kw):
        out = decode_attention(q, k_cache, v_cache, base_len, impl=impl, **kw)
        if impl is None:
            want = A.decode_blocked_plain(q, k_cache, v_cache, base_len, **kw)
            errs.append((int(base_len[0]), bf16_ulp_err(out, want)))
        return out

    tok = torch.tensor([[state.next_token]], device="cuda")
    pos3 = torch.full((3, 1, 1), state.start_pos, device="cuda")
    logits = {}
    for impl in (None, "plain"):
        cache = dataclasses.replace(state.cache, **{
            f.name: getattr(state.cache, f.name).clone()
            for f in dataclasses.fields(state.cache)})
        with patched(L, "chunk_decode_attention", held):
            hidden, _ = L.lm_decode_step(
                params.lm, cache, L.embed_tokens(params.lm, tok), pos3,
                attn_impl=impl)
        logits[impl] = L.lm_head(params.lm, hidden[0, 0])
    worst = max(e for _, e in errs)
    rel = ((logits[None] - logits["plain"]).abs().max()
           / logits["plain"].abs().max()).item()
    print(f"[strategies] fastv teacher-forced decode step at position "
          f"{state.start_pos} (t_orig {p.t_orig} + rope_delta "
          f"{int(p.rope_delta)}), per-layer base lengths "
          f"{sorted(set(b for b, _ in errs))}: K5 vs its plain version "
          f"worst {worst!r} bf16 ulps over {len(errs)} layers (limit "
          f"{ULP_LIMIT}); logits kernel vs dense plain step {rel!r} of max "
          f"|logit| (limit {TEACHER_TOL}); argmax "
          f"{int(logits[None].argmax())} / {int(logits['plain'].argmax())}",
          flush=True)
    checks["fastv: K5 over per-layer lengths within ULP_LIMIT"] = (
        len(errs) == n_layers and worst <= ULP_LIMIT)
    checks["fastv: teacher-forced logits"] = rel <= TEACHER_TOL

    checks.update(stats_checks(cfg, p.vb, k1_ms))

    # The host strategies' times on this request's inputs (the stats block
    # once; stage A once per capture).
    merged, recv, keys = M._vision_stats(params, vb)
    n = p.n
    host = (merged[:n].float().cpu().numpy(), recv[:n].cpu().numpy(),
            keys[:n].cpu().numpy())
    times = {}
    for name in ("visionzip", "prumerge_plus", "divprune", "holov",
                 "random"):
        strat = get_baseline(name)
        t0 = time.perf_counter()
        strat(*host, STRATEGY_BUDGET, np.asarray(grid))
        times[name] = (time.perf_counter() - t0) * 1e3
    t_orig = p.t_orig
    with torch.no_grad():
        vision = M.vit_mod.vit_forward(params.visual, **vb)
    for name in ("fastv", "dart", "dynamic"):
        eng = runs[name][0]
        strat = eng.strategy
        out = M._stage_a_from_vision(
            params, strat.target_layer, strat.capture, vision, n,
            *M.sequence_tensors(p, input_ids, eng.device))
        hidden_t, fv, key_l1 = out[0], out[2], out[3]
        args = (fv[:t_orig].cpu().numpy() if fv is not None else None,
                key_l1[:t_orig].cpu().numpy(),
                hidden_t[0, :t_orig].float().cpu().numpy())
        t0 = time.perf_counter()
        strat.select(*args, p.image_pos, STRATEGY_BUDGET)
        times[name] = (time.perf_counter() - t0) * 1e3
    print(f"[strategies] host strategy ms (numpy on the host; dynamic's "
          f"predictor on the card), N={n} merged tokens, T={t_orig}: "
          f"{ {k: round(v, 3) for k, v in times.items()}!r}", flush=True)

    # api.run_token_compression, which runs api.run_eval --method fastv
    # and --method visionzip, on phase 6's reduced-depth HF directory.
    try:
        import PIL  # noqa: F401
        with_image = True
    except ImportError:
        with_image = False
    task_dir = strategy_task_dir(tmp, with_image)
    out_dir = os.path.join(tmp, "strategy_eval_out")
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m",
         "visionselector_tpu_torch.api.run_token_compression",
         "--methods", "fastv,visionzip", "--model-path", hf_dir,
         "--data-dir", task_dir, "--task-config-dir", task_dir, "--tasks",
         "strategy_gen", "--budgets", "0.2", "--device", "cuda",
         "--output-dir", out_dir], capture_output=True, text=True,
        timeout=600, cwd=os.path.dirname(os.path.abspath(__file__)))
    secs = time.perf_counter() - t0
    files = sorted(os.listdir(out_dir)) if os.path.isdir(out_dir) else []
    tail = (" | ".join(r.stdout.strip().splitlines()[-3:])
            if r.returncode == 0 else r.stderr[-3000:])
    print(f"[strategies] api.run_token_compression --methods fastv,visionzip"
          f" --model-path <phase-6 HF dir> --device cuda ("
          f"{'with' if with_image else 'without'} the image doc): rc="
          f"{r.returncode} in {secs!r} s, files {files}; {tail}", flush=True)
    checks["api.run_token_compression (run_eval --method fastv, "
           "visionzip) on cuda"] = r.returncode == 0 and all(
        f"{pre}{m}_0.2_rank0.json{post}" in files
        for m in ("fastv", "visionzip")
        for pre, post in (("", ""), ("samples_", "l")))

    print(f"[strategies] checks: {checks}", flush=True)
    print(f"[strategies] phase seconds {time.perf_counter() - t_phase!r}",
          flush=True)
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"strategies phase failed: {bad}")


# Phase 9 (serve): the HTTP server (``api/serve.py``) over phase 3's
# engine, with no tokenizer (the reference's stub prompt ids).
HTTP_TOKENS = 32
HTTP_TIMEOUT = 600  # seconds per HTTP call: a stuck server fails the phase
ADMIT_VIT_SEGMENTS = 4  # 32 ViT blocks in groups of 8


class _Http:
    """A ``Server`` on a ThreadingHTTPServer at 127.0.0.1 on a free port,
    and the JSON calls the phase makes to it."""

    def __init__(self, engine, method, budget, **kw):
        from http.server import ThreadingHTTPServer

        from visionselector_tpu_torch.api import serve

        self.srv = serve.Server(engine, None, method, budget, **kw)
        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                         serve.make_handler(self.srv))
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def close(self):
        self.httpd.shutdown()
        self.srv.close()
        self.httpd.server_close()
        self.thread.join(timeout=30)

    def post(self, path, body):
        """The response, parsed; a stream's lines with their arrival
        seconds since the request was sent: [(seconds, line)]."""
        import urllib.request

        req = urllib.request.Request(
            self.url + path, data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT) as r:
            if not body.get("stream"):
                return json.loads(r.read())
            return [(time.perf_counter() - t0, line.decode())
                    for line in r if line.strip()]

    def get(self, path):
        import urllib.request

        with urllib.request.urlopen(self.url + path,
                                    timeout=HTTP_TIMEOUT) as r:
            return r.read().decode()


def first_agree(got, want):
    """How many leading tokens agree."""
    return next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                min(len(got), len(want)))


def http_requests(engine, pixels, grid):
    """Steps 9.2-9.7: /generate plain and streamed, chat completions, a
    session, the prefix cache and the micro-batcher. Returns the checks."""
    import base64

    import numpy as np

    from visionselector_tpu_torch.models.qwen25vl.model import QwenVLEngine
    from visionselector_tpu_torch.preprocess.image import preprocess_image
    from visionselector_tpu_torch.preprocess.png import encode_png
    from visionselector_tpu_torch.preprocess.rope import expand_vision_tokens

    cfg = engine.cfg
    checks = {}
    t0 = time.perf_counter()
    png = encode_png(request_image())
    b64 = base64.b64encode(png).decode()
    print(f"[http] the phase-3 image as a PNG: {len(png)} bytes (base64 "
          f"{len(b64)}), encoded in {time.perf_counter() - t0!r} s",
          flush=True)

    def stub_ids(g):  # the server's prompt without a tokenizer
        if g is None:
            return np.asarray([100, 200, 300, 400], np.int64)
        return expand_vision_tokens(
            [100, 200], [300, 400], g,
            spatial_merge_size=cfg.vision.spatial_merge_size,
            image_token_id=cfg.image_token_id,
            vision_start_token_id=cfg.vision_start_token_id,
            vision_end_token_id=cfg.vision_end_token_id)

    ids = stub_ids(grid)
    body = {"prompt": "describe", "image_b64": b64,
            "max_new_tokens": HTTP_TOKENS}
    http = _Http(engine, "selector", 0.2)
    try:
        health = json.loads(http.get("/health"))
        page = http.get("/")
        t0 = time.perf_counter()
        out = http.post("/generate", body)
        wall = time.perf_counter() - t0
        want = engine.generate(ids, pixels, grid,
                               max_new_tokens=HTTP_TOKENS).tokens
        print(f"[http] /health {health}; / {len(page)} bytes; /generate "
              f"(image, {HTTP_TOKENS} tokens): {wall!r} s of wall, "
              f"prefill_ms={out['prefill_ms']!r} latency_ms="
              f"{out['latency_ms']!r} kept {out['kept_vision_tokens']} of "
              f"{out['num_vision_tokens']}; {first_agree(out['tokens'], want)}"
              f" of {HTTP_TOKENS} tokens equal one-shot generate of the same "
              f"ids", flush=True)
        checks["/health"] = health.get("ok") is True and "/generate" in page
        checks["/generate == one-shot"] = out["tokens"] == want
        lines = http.post("/generate", dict(body, stream=True))
        recs = [json.loads(line) for _, line in lines]
        chunks = [r["tokens"] for r in recs[:-1]]
        print(f"[http] streamed /generate: first chunk after "
              f"{lines[0][0] * 1e3!r} ms (the one-shot prefill_ms "
              f"{out['prefill_ms']!r}), last line after {lines[-1][0]!r} s; "
              f"chunk sizes {[len(c) for c in chunks]}", flush=True)
        checks["stream chunks == tokens"] = (
            sum(chunks, []) == out["tokens"] == recs[-1]["tokens"]
            and recs[-1].get("done") is True
            and [len(c) for c in chunks][:2] == [1, 8])
        msg = [{"role": "user", "content": [
            {"type": "text", "text": "describe"},
            {"type": "image_url", "image_url": {
                "url": f"data:image/png;base64,{b64}"}}]}]
        oai = http.post("/v1/chat/completions",
                        {"messages": msg, "max_tokens": HTTP_TOKENS})
        sse = http.post("/v1/chat/completions",
                        {"messages": msg, "max_tokens": HTTP_TOKENS,
                         "stream": True})
        events = [line.strip()[len("data: "):] for _, line in sse
                  if line.startswith("data: ")]
        deltas = [json.loads(e)["choices"][0] for e in events[:-1]]
        text = " ".join(d["delta"]["content"] for d in deltas
                        if d["delta"].get("content"))
        ids_text = " ".join(map(str, out["tokens"]))
        print(f"[http] /v1/chat/completions: {oai['usage']}; SSE "
              f"{len(events)} events, first after {sse[0][0] * 1e3!r} ms",
              flush=True)
        checks["chat completions"] = (
            oai["choices"][0]["message"]["content"] == ids_text
            and text == ids_text and events[-1] == "[DONE]"
            and deltas[-1]["finish_reason"] == "stop")
    finally:
        http.close()

    # A three-turn session, on orig: there a fresh prefill of the
    # concatenated stream numbers every row as the session did (under
    # compression decode numbers the answer from the compacted length).
    orig = QwenVLEngine(cfg, engine.params, use_selector=False,
                        device="cuda")
    http = _Http(orig, "orig", 1.0)
    try:
        turns = [dict(body, max_new_tokens=16, session="p9"),
                 {"prompt": "what else is there", "max_new_tokens": 16,
                  "session": "p9"},
                 {"prompt": "and then", "max_new_tokens": 8,
                  "session": "p9"}]
        got = []
        for t in turns:
            t0 = time.perf_counter()
            got.append(http.post("/generate", t))
            print(f"[http] session turn {len(got)}: {len(got[-1]['tokens'])}"
                  f" tokens, prefill_ms={got[-1]['prefill_ms']!r} wall "
                  f"{time.perf_counter() - t0!r} s", flush=True)
        stream = np.concatenate([stub_ids(grid), got[0]["tokens"],
                                 http.srv._turn_ids(turns[1]["prompt"])])
        fresh = orig.generate(stream.astype(np.int64), pixels, grid,
                              max_new_tokens=1)
        top2 = fresh.logits.topk(2).values.tolist()
        print(f"[http] session turn 2 first token {got[1]['tokens'][0]}; a "
              f"fresh orig prefill of the {len(stream)}-id stream "
              f"{fresh.tokens[0]} (its top-2 logits {top2!r})", flush=True)
        checks["session turn 2 == fresh prefill"] = (
            got[1]["tokens"][0] == fresh.tokens[0]
            and [len(g["tokens"]) for g in got] == [16, 16, 8])
    finally:
        http.close()
    del orig

    # Two requests that share their prefix (the same image and stub ids).
    http = _Http(engine, "selector", 0.2, prefix_cache=2, prefix_cache_min=1)
    try:
        a = http.post("/generate", dict(body, max_new_tokens=8))
        b = http.post("/generate", dict(body, max_new_tokens=8))
        pc = json.loads(http.get("/health"))["prefix_cache"]
        print(f"[http] prefix cache: {pc}; miss prefill_ms "
              f"{a['prefill_ms']!r}, hit prefill_ms {b['prefill_ms']!r}; "
              f"first tokens {a['tokens'][0]} / {b['tokens'][0]} (one-shot "
              f"{want[0]})", flush=True)
        checks["prefix cache hit"] = (pc["hits"] == 1 and pc["misses"] == 1
                                      and b["tokens"][0] == want[0]
                                      == a["tokens"][0])
    finally:
        http.close()

    # --micro-batch 4: four concurrent requests.
    rng = np.random.RandomState(SEED + 9)
    small = (rng.rand(448, 448, 3) * 255).astype(np.uint8)
    spx, sgrid = preprocess_image(small)
    s64 = base64.b64encode(encode_png(small)).decode()
    bodies = [dict(body, max_new_tokens=16),
              {"prompt": "a", "image_b64": s64, "max_new_tokens": 16},
              {"prompt": "b", "max_new_tokens": 16},
              {"prompt": "c", "image_b64": s64, "max_new_tokens": 16}]
    refs = [(ids, pixels, grid), (stub_ids(sgrid), spx, sgrid),
            (stub_ids(None), None, None), (stub_ids(sgrid), spx, sgrid)]
    sizes = []
    batch = engine.generate_batch

    def counted(reqs, **kw):
        sizes.append(len(reqs))
        return batch(reqs, **kw)

    engine.generate_batch = counted
    # a window long enough for all four to join (the handlers decode and
    # preprocess their images first)
    http = _Http(engine, "selector", 0.2, micro_batch=4, batch_window_ms=250)
    try:
        outs = [None] * len(bodies)

        def one(i):
            outs[i] = http.post("/generate", bodies[i])

        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(bodies))]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(HTTP_TIMEOUT)
        wall = time.perf_counter() - t0
    finally:
        http.close()
        del engine.generate_batch
    firsts = [engine.generate(i, p, g, max_new_tokens=1).tokens[0]
              for i, p, g in refs]
    n_tok = sum(len(o["tokens"]) - 1 for o in outs if o)
    print(f"[http] --micro-batch 4: 4 concurrent requests in {wall!r} s, "
          f"batches {sizes}, decode tokens {n_tok}, aggregate decode tok/s "
          f"{n_tok / wall!r}; first tokens {[o['tokens'][0] for o in outs]}"
          f" (one-shot {firsts})", flush=True)
    checks["micro-batch first tokens == one-shot"] = (
        all(o is not None for o in outs)
        and [o["tokens"][0] for o in outs] == firsts and max(sizes) > 1)
    return checks


def admission_mix(cfg, input_ids, pixels, grid):
    """Step 9.8's traffic: the first 4 of phase 5's 14 selector requests
    (the 4 that arrive at once; the other 10 made this step the script's
    longest part), then an orig part: a text request decoding when two
    orig image requests (phase 5's) arrive; its budget (192 tokens) keeps
    it live through both admissions, chunked or not."""
    import numpy as np

    traffic = serve_traffic(cfg, input_ids, pixels, grid)
    sel = [x for x in traffic if x[0] == "selector"][:ADMIT_SELECTOR]
    origs = [x for x in traffic if x[0] == "orig"]
    text = dict(input_ids=np.random.RandomState(SEED + 8).randint(
        100, 5000, 30).astype(np.int64))
    orig = ([("orig", text, 192, {}, 0.0)]
            + [(e, r, m, kw, 0.3 + 0.2 * i)
               for i, (e, r, m, kw, _) in enumerate(origs)])
    eos = (-1,)  # random weights: run every request to its budget
    return [[(e, r, m, dict(kw, eos_token_ids=eos), d)
             for e, r, m, kw, d in part] for part in (sel, orig)]


def chunked_admissions(engines, parts, prefill_chunk):
    """One run of step 9.8's traffic through servers built as ``--continuous
    8 --continuous-t-max 2048 --continuous-prefill-chunk <prefill_chunk>
    --continuous-prefill-vit-segments 4`` (the selector part on phase 3's
    engine, the orig part on an orig one), each request submitted to the
    server's batcher from a thread of its own at its arrival time, as a
    handler thread does. The counts are zeroed just before and read just
    after. Returns (results by request id, stats by part, launches)."""
    from visionselector_tpu_torch.api.serve import Server
    from visionselector_tpu_torch.kernels import attention as A

    results, stats = {}, {}
    zero_counts()
    for part in parts:
        name = part[0][0]
        srv = Server(engines[name], None, name, 0.2, continuous=POOL_SLOTS,
                     continuous_t_max=POOL_ROWS, continuous_chunk=8,
                     continuous_prefill_chunk=prefill_chunk,
                     continuous_prefill_vit_segments=ADMIT_VIT_SEGMENTS)
        res, wall = run_batcher(srv.batcher, part)
        stats[name] = dict(srv.batcher.stats, wall=wall,
                           tokens=sum(len(r.tokens) - 1 for r in res))
        results.update(zip([id(x) for x in part], res))
        del srv
    import torch

    torch.cuda.synchronize()
    launches = dict(launch_counts(), **{
        f"decode_t_c{k}": v for k, v in A.DECODE_LAUNCHES_BY_ROWS.items()})
    return results, stats, launches


def http_phase(cfg, params, engine, input_ids, pixels, grid, hf_dir) -> int:
    """Phase 9. Raises if any check failed; returns the K5 launches at
    t_c = ADMIT_SEG of step 9.8's chunked run."""
    import statistics

    from visionselector_tpu_torch.models.qwen25vl.model import QwenVLEngine

    t_phase = time.perf_counter()
    print(f"[http] card: {nvidia_smi()}", flush=True)
    checks = http_requests(engine, pixels, grid)

    # 9.8: chunked admissions against the same mix admitted one-shot.
    t98 = time.perf_counter()
    n_layers = cfg.text.num_hidden_layers
    engines = {"selector": engine,
               "orig": QwenVLEngine(cfg, params, use_selector=False,
                                    device="cuda")}
    parts = admission_mix(cfg, input_ids, pixels, grid)
    traffic = parts[0] + parts[1]
    runs = {}
    for chunk in (ADMIT_SEG, 0):
        runs[chunk] = chunked_admissions(engines, parts, chunk)
        res, stats, launches = runs[chunk]
        ttft = [res[id(x)].first_token_seconds * 1e3 for x in traffic]
        for name, st in stats.items():
            print(f"[http] --continuous {POOL_SLOTS} --continuous-prefill-"
                  f"chunk {chunk} ({name} part): max_decode_gap_ms="
                  f"{st['max_decode_gap_ms']!r} aggregate decode tok/s "
                  f"{st['tokens'] / st['wall']!r} stats {st}", flush=True)
        print(f"[http] prefill chunk {chunk}: time to first token ms median "
              f"{statistics.median(ttft)!r} max {max(ttft)!r}; launches "
              f"{launches}", flush=True)
    res, stats, launches = runs[ADMIT_SEG]
    images = [x for x in traffic if "pixel_values" in x[1]]
    texts = [x for x in traffic if "pixel_values" not in x[1]]
    n_seg = sum(-(-res[id(x)].prefill_len // ADMIT_SEG) for x in images)
    steps = sum(st["chunks"] for st in stats.values()) * 8
    vit = cfg.vision.depth
    groups = -(-vit // -(-vit // ADMIT_VIT_SEGMENTS))
    n_full = len(cfg.vision.fullatt_block_indexes)
    want = {"diag_attn_fwd": (vit - n_full) * len(images),
            "flash_varlen_fwd": n_full * len(images) + n_layers * len(texts),
            f"decode_t_c{ADMIT_SEG}": n_layers * n_seg,
            "decode_t_c1": n_layers * steps}
    got = {k: launches.get(k, 0) for k in want}
    chunks = sum(st["prefill_chunks"] for st in stats.values())
    admitted = sum(st["chunked_admissions"] for st in stats.values())
    print(f"[http] chunked run: launches {got}, expected {want} ({len(images)}"
          f" image admissions in {n_seg} segments of {ADMIT_SEG}, "
          f"{len(texts)} text prefills, {steps} decode steps); prefill_chunks"
          f" {chunks} (expected {len(images) * (groups + 1) + n_seg})",
          flush=True)
    checks["chunked launches == segments' counts"] = (
        got == want and launches["decode_blocked_fwd"]
        == want[f"decode_t_c{ADMIT_SEG}"] + want["decode_t_c1"])
    checks["chunked_admissions and prefill_chunks"] = (
        admitted == len(images) and chunks == len(images) * (groups + 1)
        + n_seg and all(st["rejected_too_long"] == 0
                        for r in runs.values() for st in r[1].values()))
    # both orig admissions joined a live pool, chunked and one-shot
    checks["orig admissions mid-decode"] = all(
        r[1]["orig"]["mid_flight_joins"] == 2 for r in runs.values())
    first_ok = True
    for x in traffic:
        name, req, max_new, kw, _ = x
        if kw.get("temperature", 0.0) > 0.0:
            continue
        want_first = engines[name].generate(
            **req, max_new_tokens=1, eos_token_ids=kw["eos_token_ids"]
        ).tokens[0]
        got_first = [r[0][id(x)].tokens[0] for r in runs.values()]
        first_ok &= got_first == [want_first] * 2
    checks["chunked and one-shot admissions: first tokens == one-shot"] = \
        first_ok
    del engines
    print(f"[http] step 9.8 seconds {time.perf_counter() - t98!r} "
          f"({ADMIT_SELECTOR} selector requests + the orig part, chunked "
          f"and one-shot)", flush=True)

    # 9.9: the CLI on phase 6's HF directory, a process of its own.
    checks["api.serve --model-path on cuda"] = serve_cli(hf_dir)
    print(f"[http] checks: {checks}", flush=True)
    print(f"[http] phase seconds {time.perf_counter() - t_phase!r}",
          flush=True)
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"http phase failed: {bad}")
    return launches[f"decode_t_c{ADMIT_SEG}"]


def serve_start(hf_dir, extra=()):
    """Start ``python -m visionselector_tpu_torch.api.serve --device cuda
    --model-path <hf_dir> --port 0`` (and ``extra`` flags) in a process of
    its own. Returns (process, queue of (arrival time, output line), start
    time)."""
    import queue

    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "visionselector_tpu_torch.api.serve",
         "--device", "cuda", "--model-path", hf_dir, "--port", "0",
         *extra],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    lines = queue.Queue()
    threading.Thread(
        target=lambda: [lines.put((time.perf_counter(), x))
                        for x in proc.stdout],
        daemon=True).start()
    return proc, lines, t0


def serve_cli(hf_dir, extra=(), n_requests=1, started=None) -> bool:
    """The server of ``serve_start(hf_dir, extra)``, or ``started``, one
    begun earlier: /health and ``n_requests`` /generate, then terminate
    it."""
    import base64
    import queue
    import urllib.request

    import numpy as np

    from visionselector_tpu_torch.preprocess.png import encode_png

    proc, lines, t0 = started or serve_start(hf_dir, extra)
    log, url = [], None
    try:
        while url is None and time.perf_counter() - t0 < 300:
            try:
                at, line = lines.get(timeout=5)
            except queue.Empty:
                if proc.poll() is not None:
                    break
                continue
            log.append(line.rstrip())
            m = re.search(r"listening on ([\d.]+):(\d+)", line)
            if m:
                url = f"http://{m.group(1)}:{m.group(2)}"
        if url is None:
            print(f"[http] api.serve did not start: {log[-20:]}", flush=True)
            return False
        up = at - t0
        with urllib.request.urlopen(url + "/health", timeout=60) as r:
            health = json.loads(r.read())
        img = (np.random.RandomState(SEED + 10).rand(448, 448, 3)
               * 255).astype(np.uint8)
        body = {"prompt": "hi", "max_new_tokens": 4, "image_b64":
                base64.b64encode(encode_png(img)).decode()}
        outs = []
        for _ in range(n_requests):
            req = urllib.request.Request(
                url + "/generate", data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT) as r:
                outs.append(json.loads(r.read()))
        out = outs[-1]
        print(f"[http] api.serve --device cuda --model-path <phase-6 HF dir>"
              f" {' '.join(extra)}: up after {up!r} s ({log[-1]}); /health "
              f"{health}; /generate {[o['tokens'] for o in outs]} kept "
              f"{out['kept_vision_tokens']} of {out['num_vision_tokens']}, "
              f"prefill_ms {out['prefill_ms']!r}", flush=True)
        return health.get("ok") is True and all(
            len(o["tokens"]) == 4 for o in outs)
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)


# Phase 10 (video): a clip, two images and an image + the clip on phase 3's
# weights. The clip: 16 seeded frames of 360x640, resized to 364x644, grid
# (8, 26, 46), 9,568 patches, 12,288 window-aligned rows, so the 16,384
# bucket with a kv_iters cap of 32 tiles (K2's case), 2,392 merged tokens.
CLIP_FRAMES, CLIP_HW = 16, (360, 640)
CLIP_GRID, CLIP_BUCKET, CLIP_KV_ITERS, CLIP_MERGED = (8, 26, 46), 16384, 32, \
    2392
SMALL_HW = (448, 448)  # the second image: 256 merged tokens
# (merged tokens, bucket): the phase-3 image + the 448x448 one; the 448x448
# image + the clip
TWO_IMAGES = (1516, 8192)
MIXED = (2648, 16384)
VIDEO_REQUESTS = (("selector 0.1", "clip"), ("selector 0.2", "clip"),
                  ("orig", "clip"), ("selector 0.2", "two images"),
                  ("orig", "two images"), ("selector 0.2", "mixed"),
                  ("orig", "mixed"))
VIDEO_BATCH_TOKENS = 8


def clip_frames(seed):
    import numpy as np

    rng = np.random.RandomState(seed)
    return (rng.rand(CLIP_FRAMES, *CLIP_HW, 3) * 255).astype(np.uint8)


def write_clip(tmp, frames, name):
    """The clip under ``tmp`` as ``<name>.npy`` and as a directory of PNG
    frames (``encode_png``; the card's host has no Pillow)."""
    import numpy as np

    from visionselector_tpu_torch.preprocess.png import encode_png

    npy = os.path.join(tmp, f"{name}.npy")
    np.save(npy, frames)
    d = os.path.join(tmp, f"{name}_frames")
    os.makedirs(d)
    for i, fr in enumerate(frames):
        with open(os.path.join(d, f"frame_{i:03d}.png"), "wb") as f:
            f.write(encode_png(fr))
    return npy, d


def clip_inputs(cfg, engine, tmp, checks):
    """10.1: the clip from its .npy file and from its PNG frames (equal
    pixels), its layout, and host preparation on the native and numpy
    paths. Returns (generate keywords of the clip without ids, the .npy
    path)."""
    import numpy as np

    from visionselector_tpu_torch import native
    from visionselector_tpu_torch.preprocess.video import process_video

    npy, png_dir = write_clip(tmp, clip_frames(SEED + 10), "clip")
    t0 = time.perf_counter()
    have_native = native.native_available()
    print(f"[video] native preprocessing available: {have_native} (build "
          f"and load {time.perf_counter() - t0!r} s; {native._so_path()})"
          f"{'' if have_native else ' log: ' + native.BUILD_LOG[-2000:]}",
          flush=True)
    checks["native preprocessing builds on the card's host"] = have_native

    host_ms = {}
    for path in ("native", "numpy"):
        with contextlib.ExitStack() as stack:
            if path == "numpy":
                stack.enter_context(patched(native, "_LIB", None))
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                out = process_video(npy)
                times.append((time.perf_counter() - t0) * 1e3)
            host_ms[path] = (sorted(times)[1], out)
    px, grid, spg = host_ms["native"][1]
    px_png, grid_png, spg_png = process_video(png_dir)
    same_paths = np.array_equal(px, host_ms["numpy"][1][0])
    same_sources = (np.array_equal(px, px_png)
                    and np.array_equal(grid, grid_png) and spg == spg_png)
    print(f"[video] clip {CLIP_FRAMES}x{CLIP_HW[0]}x{CLIP_HW[1]} uint8: "
          f"process_video grid {grid.tolist()} pixels {px.shape} "
          f"second_per_grid_t {spg!r}; host prep ms native "
          f"{host_ms['native'][0]!r} numpy {host_ms['numpy'][0]!r} (median "
          f"of 3, .npy source); native == numpy rows: {same_paths}; .npy "
          f"== PNG frames: {same_sources}", flush=True)
    checks["clip: native rows == numpy rows"] = same_paths
    checks["clip: .npy == PNG frame directory"] = same_sources
    video = dict(pixel_values_videos=px, video_grid_thw=grid,
                 second_per_grid_ts=np.array([spg]))
    p = engine._prep_vision(clip_ids(cfg, grid), px, grid, None, grid,
                            video["second_per_grid_ts"])
    layout = (tuple(grid[0]), p.s_bucket, p.vb.full_kv_iters, p.n)
    print(f"[video] clip layout: grid {layout[0]} patches "
          f"{p.vb.num_patches} bucket {p.s_bucket} full_kv_iters "
          f"{p.vb.full_kv_iters} merged {p.n}", flush=True)
    checks["clip layout (grid, bucket, kv_iters, merged)"] = layout == (
        CLIP_GRID, CLIP_BUCKET, CLIP_KV_ITERS, CLIP_MERGED)
    return video, npy


def vision_block(cfg, grid, token):
    ids = []
    for t, h, w in grid:
        ids += ([cfg.vision_start_token_id]
                + [token] * (int(t * h * w) // cfg.vision.spatial_merge_unit)
                + [cfg.vision_end_token_id])
    return ids


def clip_ids(cfg, grid):
    import numpy as np

    return np.asarray(PROMPT_BEFORE + vision_block(cfg, grid,
                                                   cfg.video_token_id)
                      + PROMPT_AFTER, np.int64)


def video_request_set(cfg, video, pixels, grid):
    """The phase's three requests as ``generate`` keywords: the clip, the
    phase-3 image + a 448x448 one, the 448x448 image + the clip."""
    import numpy as np

    from visionselector_tpu_torch.preprocess.image import preprocess_image

    small = (np.random.RandomState(SEED + 12).rand(*SMALL_HW, 3)
             * 255).astype(np.uint8)
    spx, sgrid = preprocess_image(small)
    vgrid = video["video_grid_thw"]
    img = cfg.image_token_id
    two = np.concatenate([grid, sgrid])
    return {
        "clip": dict(input_ids=clip_ids(cfg, vgrid), **video),
        "two images": dict(
            input_ids=np.asarray(PROMPT_BEFORE + vision_block(cfg, two, img)
                                 + PROMPT_AFTER, np.int64),
            pixel_values=np.concatenate([pixels, spx]), grid_thw=two),
        "mixed": dict(
            input_ids=np.asarray(
                PROMPT_BEFORE + vision_block(cfg, sgrid, img)
                + vision_block(cfg, vgrid, cfg.video_token_id)
                + PROMPT_AFTER, np.int64),
            pixel_values=spx, grid_thw=sgrid, **video),
    }


def video_generate(cfg, params, reqs, checks):
    """10.2: each request of VIDEO_REQUESTS, 32 greedy tokens, the counters
    zeroed just before and read just after: 28 K4 and 4 + 36 K1 per
    prefill, 4 of the K1 capped in the 16,384 bucket and none in the 8,192
    one, 36 K5 per decode step; against ``attn_impl="plain"`` with phase
    3's tolerance. Returns (capped launches over these runs, results by
    request, the engines by name)."""
    import torch

    from visionselector_tpu_torch.models.qwen25vl import vit as V
    from visionselector_tpu_torch.models.qwen25vl.model import (
        QwenVLEngine,
        _vision_inputs,
    )

    vc, n_layers = cfg.vision, cfg.text.num_hidden_layers
    n_full = len(vc.fullatt_block_indexes)

    def engine(name, **kw):
        if name == "orig":
            return QwenVLEngine(cfg, params, use_selector=False,
                                device="cuda", **kw)
        return QwenVLEngine(cfg, params, use_selector=True,
                            budget=float(name.split()[1]), device="cuda",
                            **kw)

    engines = {name: engine(name) for name, _ in VIDEO_REQUESTS}
    # warm-up at the 16,384 bucket (allocator), outside the counted runs
    engines["orig"].generate(**reqs["clip"], max_new_tokens=2)
    torch.cuda.synchronize()
    capped_total, results = 0, {}
    for name, kind in VIDEO_REQUESTS:
        eng, req = engines[name], reqs[kind]
        zero_counts()
        torch.cuda.reset_peak_memory_stats()
        res = eng.generate(**req, max_new_tokens=MAX_NEW_TOKENS)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        counts = launch_counts()
        steps = (len(res.tokens) - 1 if len(res.tokens) == MAX_NEW_TOKENS
                 else len(res.tokens))
        pv, g, ig, vg = _vision_inputs(
            req.get("pixel_values"), req.get("grid_thw"),
            req.get("pixel_values_videos"), req.get("video_grid_thw"))
        p = eng._prep_vision(req["input_ids"], pv, g, ig, vg,
                             req.get("second_per_grid_ts"))
        want = {"diag_attn_fwd": vc.depth - n_full,
                "flash_varlen_fwd": n_full + n_layers,
                "flash_varlen_fwd_capped": (n_full if p.vb.full_kv_iters
                                            else 0),
                "decode_blocked_fwd": n_layers * steps}
        got = {k: counts[k] for k in want}
        capped_total += got["flash_varlen_fwd_capped"]
        with torch.no_grad():
            vt = eng._vision_tensors(p.vb)
            vit_ms = cuda_ms(lambda: V.vit_forward(params.visual, **vt),
                             n=3)
        n_decode = len(res.tokens) - 1
        decode_s = res.total_seconds - res.prefill_seconds
        kept = (len(res.selected_indices) if res.selected_indices is not None
                else res.num_vision_tokens)
        print(f"[video] {name} {kind}: bucket {p.s_bucket} full_kv_iters "
              f"{p.vb.full_kv_iters} vision_tokens {res.num_vision_tokens} "
              f"kept {kept} prefill_len {res.prefill_len} prefill_ms="
              f"{res.prefill_seconds * 1e3!r} decode_tok_s="
              f"{n_decode / decode_s if n_decode else float('nan')!r} "
              f"vit_device_ms={vit_ms!r} (CUDA events, median of 3) "
              f"peak_mem_bytes={peak} launches {got} (expected {want})",
              flush=True)
        ok = (got == want and res.tokens and all(
            0 <= t < cfg.text.vocab_size for t in res.tokens)
            and bool(torch.isfinite(res.logits).all()))
        want_n = {"two images": TWO_IMAGES, "mixed": MIXED}.get(
            kind, (CLIP_MERGED, CLIP_BUCKET))
        ok &= (res.num_vision_tokens, p.s_bucket) == want_n
        checks[f"{name} {kind}: launches, tokens, layout"] = ok
        plain = engine(name, attn_impl="plain")
        res_p = plain.generate(**req, max_new_tokens=1)
        diff = (res_p.logits - res.logits).abs().max().item()
        scale = res.logits.abs().max().item()
        line = (f"[plain] video {name} {kind}: first-token logits "
                f"max_abs_diff={diff!r} (max |logit| {scale!r}) first token "
                f"kernel={res.tokens[0]} plain={res_p.tokens[0]}")
        overlap = 1.0
        if res.selected_indices is not None:
            a = set(res.selected_indices.tolist())
            b = set(res_p.selected_indices.tolist())
            overlap = len(a & b) / len(a)
            line += f" selected overlap {len(a & b)}/{len(a)}"
        print(line, flush=True)
        # phase 3's tolerance
        checks[f"{name} {kind}: kernel vs plain"] = (
            overlap >= 0.9 if res.selected_indices is not None
            else diff <= 0.1 * scale)
        results[(name, kind)] = res
        del plain
    return capped_total, results, engines


def k2_at_clip_layout(cfg, engine, req):
    """10.3: K2 on q, k and v of the clip's first ViT full layer (captured
    from a prefill), at its real segments, bounds and cap, against the
    plain version within ULP_LIMIT, with a planted fault (each q tile's
    last kv tile dropped from the bounds) that must fail; its prologue and
    main loop apart; its time beside its bound and one SDPA call with the
    same segment mask. Returns the kernels line's entry."""
    import torch

    from visionselector_tpu_torch.kernels import attention as A
    from visionselector_tpu_torch.kernels import tiles as T

    seen = {}
    flash = A.flash_varlen_fwd

    def capture(q, k, v, q_seg, kv_seg, causal=False, scale=None,
                kv_bounds=None, kv_iters=None):
        if kv_iters and not seen:
            seen.update(q=q.clone(), k=k.clone(), v=v.clone(),
                        seg=q_seg.clone(), bounds=kv_bounds.clone(),
                        iters=int(kv_iters), scale=scale)
        return flash(q, k, v, q_seg, kv_seg, causal, scale, kv_bounds,
                     kv_iters)

    with patched(A, "flash_varlen_fwd", capture):
        engine.generate(**req, max_new_tokens=1)
    q, k, v, seg, bounds = (seen[x] for x in ("q", "k", "v", "seg",
                                              "bounds"))
    iters, scale = seen["iters"], seen["scale"]
    _, s, h, d = q.shape

    def kernel(b=bounds):
        return A.flash_varlen_fwd(q, k, v, seg, seg, scale=scale,
                                  kv_bounds=b, kv_iters=iters)

    def plain():
        return A.flash_plain(q, k, v, seg, seg, scale=scale,
                             kv_bounds=bounds, kv_iters=iters)

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    ulps = bf16_ulp_err(got, want)
    pad = seg[0] == 0
    pad_zero = bool((got[:, pad] == 0).all())
    live = (bounds[:, 1] > bounds[:, 0]).int()
    fault = bf16_ulp_err(kernel(bounds + live[:, None] * torch.tensor(
        [0, -1], device=bounds.device)), want)
    ms, plain_ms = cuda_ms(kernel), cuda_ms(plain, n=3)
    seg_np, bounds_np = seg[0].cpu().numpy(), bounds.cpu().numpy()
    visited = T.flash_steps_plain(seg[0], seg[0], False, bounds_np,
                                  iters)[0].cpu().numpy()
    pairs = valid_pairs(seg_np, visited, False)
    nbytes = 4 * s * h * d * 2 + 2 * s * 4
    bound, by = bound_ms(nbytes, 4 * d * h * pairs)
    mask = ((seg[0, :, None] == seg[0, None, :])
            & (seg[0, None, :] > 0))[None, None]
    library = sdpa_ms(q, k, v, mask, scale=scale)
    del mask
    print(f"[kernel] flash_varlen_fwd capped (K2) clip S={s} H={h} D={d} "
          f"frames={int(seg_np.max())} kv_iters={iters}: max_abs_err="
          f"{err!r} ulp_err={ulps!r} (limit {ULP_LIMIT}) pad_rows_zero="
          f"{pad_zero} ms={ms!r} plain_ms={plain_ms!r} "
          f"valid_pair_tflops={tflops(4 * d * h * pairs, ms)!r}", flush=True)
    print(f"[bound] flash_varlen_fwd capped clip: bytes={nbytes} flop="
          f"{4 * d * h * pairs} bound_ms={bound!r} ({by}) share_of_bound="
          f"{bound / ms!r} library_ms={library!r} (one "
          f"scaled_dot_product_attention call, same segment mask)",
          flush=True)
    print(f"[control] flash_varlen_fwd capped clip, each q tile's last kv "
          f"tile dropped: ulp_err={fault!r} (limit {ULP_LIMIT}) rejected="
          f"{fault > ULP_LIMIT}", flush=True)
    if not (ulps <= ULP_LIMIT and pad_zero and fault > ULP_LIMIT
            and torch.isfinite(got).all()):
        raise AssertionError(
            f"K2 at the clip's layout: {ulps} ulps (pad rows zero "
            f"{pad_zero}); planted fault {fault} ulps")
    flash_phases("flash_varlen_fwd", f"capped clip S={s} kv_iters={iters}",
                 q, k, v, seg, bounds_np, iters)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, library_ms=library)


def video_other_paths(cfg, engines, reqs, results, npy, tmp, engine3,
                      checks):
    """10.4: the clip through the batcher (chunked and one-shot admission),
    the choices against per-choice loglikelihood, ``evaluate`` on a
    ``videomme`` doc, ``api.run_eval --http-endpoint`` against the port's
    server, and a prefix store given two clips."""
    import numpy as np
    import torch

    from visionselector_tpu_torch.api import run_eval
    from visionselector_tpu_torch.api.run_eval import _IdTokenizer
    from visionselector_tpu_torch.eval.evaluator import EngineAdapter, evaluate
    from visionselector_tpu_torch.kernels import attention as A
    from visionselector_tpu_torch.models.qwen25vl import model as M
    from visionselector_tpu_torch.models.qwen25vl.continuous import (
        ContinuousBatcher,
    )
    from visionselector_tpu_torch.preprocess.png import encode_png
    from visionselector_tpu_torch.preprocess.video import process_video

    clip = reqs["clip"]
    sel = engines["selector 0.1"]
    want_first = results[("selector 0.1", "clip")].tokens[0]
    for label, chunk in (("chunked", ADMIT_SEG), ("one-shot", 0)):
        bat = ContinuousBatcher(sel, n_slots=2, t_max=POOL_ROWS, chunk=8,
                                prefill_chunk=chunk,
                                prefill_vit_segments=ADMIT_VIT_SEGMENTS)
        zero_counts()
        t0 = time.perf_counter()
        try:
            res = bat.submit(clip, VIDEO_BATCH_TOKENS)
        finally:
            bat.shutdown()
        torch.cuda.synchronize()
        capped = A.FLASH_CAPPED_LAUNCHES
        secs = time.perf_counter() - t0
        print(f"[video] batcher, {label} admission (prefill_chunk {chunk}, "
              f"vit_segments {ADMIT_VIT_SEGMENTS}): {secs!r} s, ttft_ms="
              f"{res.first_token_seconds * 1e3!r} tokens {res.tokens}; "
              f"stats {bat.stats}; capped K1 {capped}; first token "
              f"{res.tokens[0]} (one-shot {want_first})", flush=True)
        checks[f"batcher {label}: first token == one-shot"] = (
            res.tokens[0] == want_first and capped == 4
            and bat.stats["chunked_admissions"] == (1 if chunk else 0))

    orig = engines["orig"]
    rng = np.random.RandomState(SEED + 13)
    choices = [rng.randint(1000, 100000, n) for n in CHOICE_LENS]
    kw = {k: v for k, v in clip.items() if k != "input_ids"}
    t0 = time.perf_counter()
    lls = M.run_loglikelihood_choices(orig, clip["input_ids"], choices, **kw)
    ms = (time.perf_counter() - t0) * 1e3
    per = [orig.loglikelihood(clip["input_ids"], c, **kw) for c in choices]
    errs = [ll_per_token(a[0], b[0], len(c))
            for a, b, c in zip(lls, per, choices)]
    print(f"[video] orig clip choices ({list(CHOICE_LENS)} ids; one prefill,"
          f" {ms!r} ms): {[x for x, _ in lls]} against each choice's "
          f"loglikelihood {[x for x, _ in per]}: |diff| per token {errs} "
          f"(limit {LL_TOL_CHUNK})", flush=True)
    checks["clip choices vs per-choice loglikelihood"] = (
        max(errs) <= LL_TOL_CHUNK
        and all(np.isfinite(x) for x, _ in lls + per))

    task_dir = os.path.join(tmp, "video_tasks")
    os.makedirs(task_dir)
    shutil.copy(npy, os.path.join(task_dir, "clip.npy"))
    with open(os.path.join(task_dir, "videomme.jsonl"), "w") as f:
        f.write(json.dumps({"question": "What happens in the clip?",
                            "answers": ["A"], "video": "clip.npy",
                            "choices": ["noise", "a cat", "a dog"]}) + "\n")
    t0 = time.perf_counter()
    res = evaluate(EngineAdapter(sel, _IdTokenizer()), ["videomme"],
                   task_dir)
    print(f"[video] evaluate videomme (one .npy clip doc, selector 0.1): "
          f"{res} in {time.perf_counter() - t0!r} s", flush=True)
    checks["evaluate videomme"] = res.get("videomme/n") == 1.0 and \
        "videomme/multiple_choice" in res

    http_dir = os.path.join(tmp, "http_tasks")
    os.makedirs(http_dir)
    with open(os.path.join(http_dir, "image.png"), "wb") as f:
        f.write(encode_png(request_image()))
    with open(os.path.join(http_dir, "chartqa.jsonl"), "w") as f:
        for doc in ({"question": "What is two?", "answers": ["2"]},
                    {"question": "Name a color.", "answers": ["red"]},
                    {"question": "Read the chart.", "answers": ["x"],
                     "image": "image.png"}):
            f.write(json.dumps(doc) + "\n")
    out_dir = os.path.join(tmp, "http_eval_out")
    http = _Http(engine3, "selector", 0.2)
    t0 = time.perf_counter()
    try:
        rc = run_eval.main(["--data-dir", http_dir, "--tasks", "chartqa",
                            "--http-endpoint", http.url,
                            "--http-concurrency", "2", "--output-dir",
                            out_dir])
    finally:
        http.close()
    with open(os.path.join(out_dir, "http_endpoint.json")) as f:
        got = json.load(f)["results"]
    print(f"[video] api.run_eval --http-endpoint (the port's server, 2 "
          f"text-only docs and one image doc): rc={rc} {got} in "
          f"{time.perf_counter() - t0!r} s", flush=True)
    checks["run_eval --http-endpoint"] = rc == 0 and got.get(
        "chartqa/n") == 3.0

    store = M.PrefixCacheStore(min_prefix=1)
    other = dict(clip)
    px2, grid2, spg2 = process_video(clip_frames(SEED + 11))
    other.update(pixel_values_videos=px2, video_grid_thw=grid2,
                 second_per_grid_ts=np.array([spg2]))
    for req in (clip, other):
        M.prefix_cached_prefill(orig, store, **req, max_new_tokens=4)
    print(f"[video] prefix store, two clips of one grid and the same ids: "
          f"hits {store.hits} misses {store.misses}", flush=True)
    checks["prefix store: two clips never share an entry"] = (
        store.hits, store.misses) == (0, 2)


def video_phase(cfg, params, engine3, pixels, grid, tmp):
    """Phase 10. Raises if any check failed; returns (the capped K1
    launches of 10.2's runs, the kernels line's K2 entry)."""
    t_phase = time.perf_counter()
    print(f"[video] card: {nvidia_smi()}", flush=True)
    checks = {}
    video, npy = clip_inputs(cfg, engine3, tmp, checks)
    reqs = video_request_set(cfg, video, pixels, grid)
    capped, results, engines = video_generate(cfg, params, reqs, checks)
    k2 = k2_at_clip_layout(cfg, engines["orig"], reqs["clip"])
    video_other_paths(cfg, engines, reqs, results, npy, tmp, engine3,
                      checks)
    bad = [k for k, ok in checks.items() if not ok]
    print(f"[video] checks: {checks}", flush=True)
    print(f"[video] phase seconds {time.perf_counter() - t_phase!r}",
          flush=True)
    if bad:
        raise AssertionError(f"video phase failed: {bad}")
    return capped, k2


# -- Phase 11: LLaVA-OneVision-1.5-8B ----------------------------------------

# The OV request: the phase-3 image at its own 1036x1456 (grid 1x74x104,
# 7,696 patches, the 8,192 bucket: S' = 8,192 + 8 CLS slots, padded to
# 8,256 rows; 1,924 merged tokens) and phase 3's 40 text ids; the second
# image of the two-image request (224x224: 256 patches, the same bucket).
OV_GRID = (1, 74, 104)
OV_BUCKET, OV_MERGED = 8192, 1924
OV_SECOND_HW = (224, 224)
OV_STRATEGY_TOKENS = 8
# A reduced-depth OV HF directory: RICE blocks and decoder layers kept.
OV_HF_BLOCKS, OV_HF_LAYERS = (0, 23), (0, 35)


def ov_request(cfg, second=False):
    """The phase-11 request: (generate keywords). ``second``: the two-image
    request (the phase-3 image and a seeded 224x224 one)."""
    import numpy as np

    from visionselector_tpu_torch.preprocess.image import preprocess_image
    from visionselector_tpu_torch.preprocess.rope import expand_vision_tokens

    img = request_image()
    # max_pixels at the image's own size: every 14x14 patch kept
    px, grid = preprocess_image(img, max_pixels=img.shape[0] * img.shape[1],
                                temporal_patch_size=1)
    if second:
        rng = np.random.RandomState(SEED + 11)
        p2, g2 = preprocess_image(
            (rng.rand(*OV_SECOND_HW, 3) * 255).astype(np.uint8),
            temporal_patch_size=1)
        px, grid = np.concatenate([px, p2]), np.concatenate([grid, g2])
    ids = expand_vision_tokens(
        PROMPT_BEFORE, PROMPT_AFTER, grid,
        spatial_merge_size=cfg.vision.spatial_merge_size,
        image_token_id=cfg.image_token_id,
        vision_start_token_id=cfg.vision_start_token_id,
        vision_end_token_id=cfg.vision_end_token_id)
    return dict(input_ids=ids, pixel_values=px, grid_thw=grid)


def ov_counts() -> dict:
    """The launch counts phase 11 reads: RICE's K1 (the flash calls
    without the causal mask), the decoder's causal K1, K5 and the kernels
    the OV path must not launch."""
    from visionselector_tpu_torch.kernels import attention as A

    c = launch_counts()
    return {"rice": c["flash_varlen_fwd"] - A.FLASH_CAUSAL_LAUNCHES,
            "lm": A.FLASH_CAUSAL_LAUNCHES,
            "decode": c["decode_blocked_fwd"],
            "diag": c["diag_attn_fwd"], "fused": c["fused_vit_attn_fwd"],
            "capped": c["flash_varlen_fwd_capped"],
            "packed": c["flash_packed_fwd"]}


def ov_steps(res, max_new=MAX_NEW_TOKENS) -> int:
    """Decode steps a ``generate`` of ``max_new`` tokens ran: one per token
    after the first, plus the step whose EOS ended the loop early."""
    return (len(res.tokens) - 1 if len(res.tokens) == max_new
            else len(res.tokens))


def ov_capture(engine, req, want_causal: bool) -> dict:
    """q, k, v, seg, bounds and scale of the first flash call of one
    prefill with (or without) the causal mask: RICE's block 0 or the
    decoder's layer 0."""
    return flash_capture(lambda: engine.generate(**req, max_new_tokens=1),
                         want_causal)


def flash_capture(run, want_causal: bool) -> dict:
    """q, k, v, seg, bounds and scale of the first flash call with (or
    without) the causal mask that ``run()`` makes."""
    from visionselector_tpu_torch.kernels import attention as A

    seen = {}
    flash = A.flash_varlen_fwd

    def capture(q, k, v, q_seg, kv_seg, causal=False, scale=None,
                kv_bounds=None, kv_iters=None):
        if bool(causal) == want_causal and not seen:
            seen.update(q=q.clone(), k=k.clone(), v=v.clone(),
                        seg=q_seg.clone(), scale=scale,
                        bounds=None if kv_bounds is None
                        else kv_bounds.clone())
        return flash(q, k, v, q_seg, kv_seg, causal, scale, kv_bounds,
                     kv_iters)

    with patched(A, "flash_varlen_fwd", capture):
        run()
    return seen


def ov_kernel_entry(kname, name, kernel, plain, fault, nbytes, flop,
                    library, pad_rows_zero, tag="[ov-kernel]"):
    """Time, bound and check one kernel case (OV's, and phase 13's under
    its own ``tag``); raises if it disagrees with its plain version or its
    planted fault passes."""
    import torch

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    ulps = bf16_ulp_err(got, want)
    # fault: a call, judged against ``want``, or (a call, its own want)
    bad_got, bad_want = fault if isinstance(fault, tuple) else (fault, plain)
    bad = bf16_ulp_err(bad_got(), want if bad_want is plain else bad_want())
    ms, plain_ms = cuda_ms(kernel), cuda_ms(plain, n=3)
    bound, by = bound_ms(nbytes, flop)
    lib = library() if library is not None else None
    pad_zero = pad_rows_zero(got)
    print(f"{tag} {kname} {name}: max_abs_err={err!r} ulp_err={ulps!r}"
          f" (limit {ULP_LIMIT}) pad_rows_zero={pad_zero} ms={ms!r} "
          f"plain_ms={plain_ms!r} bytes={nbytes} flop={flop} bound_ms="
          f"{bound!r} ({by}) share_of_bound={bound / ms!r} library_ms="
          f"{lib!r} (one scaled_dot_product_attention call, same mask)",
          flush=True)
    print(f"[control] {kname} {name}, planted fault: ulp_err={bad!r} (limit "
          f"{ULP_LIMIT}) rejected={bad > ULP_LIMIT}", flush=True)
    if not (ulps <= ULP_LIMIT and pad_zero and bad > ULP_LIMIT
            and torch.isfinite(got).all()):
        raise AssertionError(f"{kname} {name}: {ulps} ulps (pad rows zero "
                             f"{pad_zero}); planted fault {bad} ulps")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, library_ms=lib)


def causal_k1_cases(kname, model, engines, req, tag="[ov-kernel]",
                    phases=True) -> dict:
    """K1 causal at the decoder's layer 0 of the selector and ``orig``
    requests (q / k / v captured from one prefill of each engine) against
    its plain version, with ms, bound and one SDPA call (causal + padding
    mask, GQA); fault: each q tile's diagonal kv tile cut from the
    bounds. With ``phases`` the prologue and main loop are also timed
    apart. Returns the kernels line's entry: the selector's (the main
    case), with the larger error of the two."""
    import torch

    from visionselector_tpu_torch.kernels import attention as A

    entries = []
    for name in ("selector", "orig"):
        c = ov_capture(engines[name], req, True)
        q, k, v, seg = c["q"], c["k"], c["v"], c["seg"]
        _, t, hq, d = q.shape
        hkv = k.shape[2]
        valid = int(seg.sum())
        nq = -(-t // TILE)
        iq = torch.arange(nq, device="cuda")
        cut = torch.stack([torch.zeros_like(iq), iq], 1).int()
        pos = torch.arange(t, device="cuda")
        mask = ((seg[0, :, None] > 0) & (seg[0, None, :] > 0)
                & (pos[:, None] >= pos[None]))[None, None]
        entries.append(ov_kernel_entry(
            kname,
            f"{name} decoder layer 0 T={t} valid={valid} Hq={hq} Hkv={hkv} "
            f"(n_rep {hq // hkv}) D={d}",
            lambda: A.flash_varlen_fwd(q, k, v, seg, seg, causal=True),
            lambda: A.flash_plain(q, k, v, seg, seg, causal=True),
            lambda: A.flash_varlen_fwd(q, k, v, seg, seg, causal=True,
                                       kv_bounds=cut),
            (2 * hq + 2 * hkv) * t * d * 2 + t * 8,
            4 * d * hq * (valid * (valid + 1) // 2),
            lambda: sdpa_ms(q, k, v, mask),
            lambda got: bool((got[:, seg[0] == 0] == 0).all()), tag=tag))
        if phases:
            flash_phases("flash_varlen_fwd", f"{model} {name} T={t} "
                         f"valid={valid}", q, k, v, seg, None, None,
                         causal=True)
        del q, k, v, c
    return dict(entries[0], max_abs_err=max(e["max_abs_err"]
                                            for e in entries))


def ov_kernels(cfg, engines, req) -> dict:
    """11.2: each kernel of the OV path at its own shapes against its
    plain version: K1 at RICE block 0's captured q / k / v (S' = 8,256,
    16 heads, D = 64, one 7,697-row segment, its bounds; fault: each q
    tile's last kv tile dropped), K1 causal at the decoder's layer 0 under
    the selector and ``orig`` (GQA 32/8, D = 128; fault: each q tile's
    diagonal kv tile cut), K5 at 8 kv heads (n_rep 4) over the ``orig``
    one-shot cache's layer 0 and a 4-slot pool, bf16 and int8 (fault: the
    last live tile of every slot skipped). Returns the kernels line's
    entries."""
    import numpy as np
    import torch

    from visionselector_tpu_torch.kernels import attention as A
    from visionselector_tpu_torch.kernels import tiles as T
    from visionselector_tpu_torch.models.qwen25vl.lm import quantize_kv

    out = {}
    # K1, RICE block 0
    c = ov_capture(engines["orig"], req, False)
    q, k, v, seg, bounds = c["q"], c["k"], c["v"], c["seg"], c["bounds"]
    _, s, h, d = q.shape
    seg_np, bounds_np = seg[0].cpu().numpy(), bounds.cpu().numpy()
    visited = T.flash_steps_plain(seg[0], seg[0], False, bounds_np,
                                  None)[0].cpu().numpy()
    pairs = valid_pairs(seg_np, visited, False)
    live = (bounds[:, 1] > bounds[:, 0]).int()
    drop = torch.stack([0 * live, live], 1).int()
    smask = ((seg[0, :, None] == seg[0, None, :])
             & (seg[0, None, :] > 0))[None, None]
    # The planted fault on seeded normal q / k / v at the same layout: the
    # captured block-0 logits are nearly flat over the 7,697 keys, so one
    # tile of 64 keys moves each row by about 1/120 of its spread, under
    # the tolerance (its ulps at the captured inputs are printed too).
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    qr, kr, vr = (torch.randn(q.shape, generator=gen, device="cuda")
                  .bfloat16() for _ in range(3))
    flat = bf16_ulp_err(A.flash_varlen_fwd(q, k, v, seg, seg, kv_bounds=(
        bounds - drop), scale=c["scale"]), A.flash_plain(
            q, k, v, seg, seg, scale=c["scale"], kv_bounds=bounds))
    print(f"[control] flash_varlen_fwd_rice, each q tile's last kv tile "
          f"dropped, at the captured q / k / v: ulp_err={flat!r}",
          flush=True)
    out["flash_varlen_fwd_rice"] = ov_kernel_entry(
        "flash_varlen_fwd_rice",
        f"RICE block 0 S'={s} H={h} D={d} segments={int(seg_np.max())} "
        f"rows_in_segments={int((seg_np > 0).sum())}",
        lambda: A.flash_varlen_fwd(q, k, v, seg, seg, scale=c["scale"],
                                   kv_bounds=bounds),
        lambda: A.flash_plain(q, k, v, seg, seg, scale=c["scale"],
                              kv_bounds=bounds),
        (lambda: A.flash_varlen_fwd(qr, kr, vr, seg, seg,
                                    kv_bounds=bounds - drop),
         lambda: A.flash_plain(qr, kr, vr, seg, seg, kv_bounds=bounds)),
        4 * s * h * d * 2 + s * 4 + bounds.numel() * 4, 4 * d * h * pairs,
        lambda: sdpa_ms(q, k, v, smask, scale=c["scale"]),
        lambda got: bool((got[:, seg[0] == 0] == 0).all()))
    del smask
    flash_phases("flash_varlen_fwd", f"RICE block 0 S'={s} D={d}", q, k, v,
                 seg, bounds_np, None)

    out["flash_varlen_fwd_ov_lm"] = causal_k1_cases(
        "flash_varlen_fwd_ov_lm", "OV", engines, req)

    # K5 at n_rep 4: the orig cache's layer 0, and a 4-slot pool
    tc = cfg.text
    hq, hkv, dh = tc.num_attention_heads, tc.num_key_value_heads, tc.head_dim
    state = engines["orig"].generate(**req, max_new_tokens=MAX_NEW_TOKENS,
                                     _defer_decode=True)
    k1, v1 = state.cache.k[0], state.cache.v[0]  # [1, T, 8, 128]
    rows = k1.shape[1]
    n = int(state.cache.length[0, 0])
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    pool = (torch.randn(2, 4, rows, hkv, dh, generator=gen, device="cuda")
            .bfloat16())
    cases = [("orig cache", k1, v1, torch.tensor([n], device="cuda")),
             ("4-slot pool", pool[0], pool[1],
              torch.tensor([1, 63, 65, n], device="cuda"))]
    entries = []
    for where, kb, vb, lens in cases:
        (k8, ks), (v8, vs) = quantize_kv(kb), quantize_kv(vb)
        for quant in (False, True):
            kc, vc = (k8, v8) if quant else (kb, vb)
            sc = dict(k_scale=ks, v_scale=vs) if quant else {}
            b = lens.shape[0]
            qd = torch.randn(b, 1, hq, dh, generator=gen,
                             device="cuda").bfloat16()
            live = int(lens.sum()) + b
            per_key = hkv * dh * (1 if quant else 2) * 2 + (
                hkv * 8 if quant else 0)
            tile_cut = ((lens + TILE) // TILE - 1) * TILE - 1
            lim = lens[:, None] + 1
            dmask = (torch.arange(rows, device="cuda")[None, None]
                     < lim[:, :, None])[:, None]
            entries.append(ov_kernel_entry(
                "decode_blocked_fwd_ov",
                f"{'int8' if quant else 'bf16'} {where} t_c=1 B={b} T={rows}"
                f" Hq={hq} Hkv={hkv} (n_rep {hq // hkv}) D={dh} lens="
                f"{lens.tolist()} cluster="
                f"{A.decode_cluster_size('cuda', b, 1, hq, hkv, dh, quant)}",
                lambda: A.decode_blocked_fwd(qd, kc, vc, lens, **sc),
                lambda: A.decode_blocked_plain(qd, kc, vc, lens, **sc),
                lambda: A.decode_blocked_fwd(qd, kc, vc,
                                             tile_cut.clamp(min=0), **sc),
                live * per_key + 2 * b * hq * dh * 2,
                4 * hq * dh * live,
                None if quant else (lambda: sdpa_ms(qd, kb, vb, dmask)),
                lambda got: True))
    # the kernels line keeps the orig cache's bf16 case (the one-shot
    # decode step's shape) with the largest error of the four
    out["decode_blocked_fwd_ov"] = dict(
        entries[0], max_abs_err=max(e["max_abs_err"] for e in entries))
    del state, pool
    return out


def ov_main_path(cfg, engines, plains, req, checks) -> dict:
    """11.3: the selector and ``orig`` requests, 32 greedy tokens each,
    the counts zeroed just before and read just after: per prefill 24 RICE
    K1 and 36 causal K1, no K4 / K6 / capped / packed launch, 36 K5 per
    decode step; against ``attn_impl="plain"`` with phase 3's tolerance.
    Returns the launches of the run."""
    import torch

    n_blocks, n_layers = cfg.vision.depth, cfg.text.num_hidden_layers
    for eng in engines.values():  # warm-up, outside the counted run
        eng.generate(**req, max_new_tokens=2)
    torch.cuda.synchronize()
    zero_counts()
    results, steps = {}, 0
    for name in ("selector", "orig"):
        before = ov_counts()
        torch.cuda.reset_peak_memory_stats()
        res = engines[name].generate(**req, max_new_tokens=MAX_NEW_TOKENS)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        got = {key: n - before[key] for key, n in ov_counts().items()}
        want = {"rice": n_blocks, "lm": n_layers,
                "decode": n_layers * ov_steps(res), "diag": 0, "fused": 0,
                "capped": 0, "packed": 0}
        steps += ov_steps(res)
        kept = (len(res.selected_indices) if res.selected_indices is not None
                else res.num_vision_tokens)
        n_dec = len(res.tokens) - 1
        print(f"[ov-main] {name}: vision_tokens={res.num_vision_tokens} "
              f"kept={kept} prefill_len={res.prefill_len} prefill_ms="
              f"{res.prefill_seconds * 1e3!r} decode_tok_s="
              f"{n_dec / (res.total_seconds - res.prefill_seconds)!r} "
              f"peak_mem_bytes={peak} launches {got} (expected {want})",
              flush=True)
        print(f"[ov-main] {name} tokens: {res.tokens}", flush=True)
        checks[f"main {name}: launches"] = got == want
        checks[f"main {name}: tokens and logits"] = bool(
            res.tokens and all(0 <= t < cfg.text.vocab_size
                               for t in res.tokens)
            and torch.isfinite(res.logits).all()
            and res.logits.shape == (cfg.text.vocab_size,))
        checks[f"main {name}: layout"] = (res.num_vision_tokens == OV_MERGED
                                          and kept == (384 if name ==
                                                       "selector" else
                                                       OV_MERGED))
        results[name] = res
    launches = ov_counts()
    for name, res in results.items():
        res_p = plains[name].generate(**req, max_new_tokens=1)
        diff = (res_p.logits - res.logits).abs().max().item()
        scale = res.logits.abs().max().item()
        top2 = res_p.logits.topk(2).values
        gap = (top2[0] - top2[1]).item()
        line = (f"[ov-plain] {name}: first-token logits max_abs_diff="
                f"{diff!r} (max |logit| {scale!r}) first token kernel="
                f"{res.tokens[0]} plain={res_p.tokens[0]} (plain top-2 gap "
                f"{gap!r})")
        ok = diff <= 0.1 * scale
        if res.selected_indices is not None:
            a = set(res.selected_indices.tolist())
            b = set(res_p.selected_indices.tolist())
            line += f" selected overlap {len(a & b)}/{len(a)}"
            # phase 3's rule: near-ties of the random scorer may swap a few
            # kept tokens (and with them the logits)
            ok = len(a & b) / len(a) >= 0.9
        elif gap > 2 * diff:  # a first token the drift cannot flip
            ok = ok and res.tokens[0] == res_p.tokens[0]
        print(line, flush=True)
        checks[f"main {name}: kernel vs plain"] = ok
    return {"flash_varlen_fwd_rice": launches["rice"],
            "flash_varlen_fwd_ov_lm": launches["lm"],
            "decode_blocked_fwd_ov": launches["decode"]}


def ov_profile(cfg, params, engines, req, out_dir):
    """11.4: prefill wall (median of 3) and device busy ms (one traced
    prefill), RICE device ms (CUDA events), decode wall and device ms per
    token (a traced 17-token run against the prefill), peak memory."""
    import statistics

    import torch

    from visionselector_tpu_torch.models.llava_ov15 import rice as R

    n_new = 1 + PROFILE_DECODE_STEPS
    for name in ("selector", "orig"):
        eng = engines[name]
        torch.cuda.reset_peak_memory_stats()
        runs = [eng.generate(**req, max_new_tokens=n_new) for _ in range(3)]
        peak = torch.cuda.max_memory_allocated()
        prefill_ms = statistics.median(r.prefill_seconds * 1e3 for r in runs)
        step_ms = statistics.median(
            (r.total_seconds - r.prefill_seconds) * 1e3
            / max(len(r.tokens) - 1, 1) for r in runs)
        busy, kernels, _ = traced(
            lambda: eng.generate(**req, max_new_tokens=1),
            os.path.join(out_dir, f"profile_ov_{name}_prefill.json"))
        busy_d, _, res = traced(
            lambda: eng.generate(**req, max_new_tokens=n_new),
            os.path.join(out_dir, f"profile_ov_{name}_decode.json"))
        step_busy = (busy_d - busy) / max(len(res.tokens) - 1, 1)
        p = eng._prep_vision(req["input_ids"], req["pixel_values"],
                             req["grid_thw"], True, False)
        with torch.no_grad():
            rt = eng._rice_tensors(p.rb)
            rice_ms = cuda_ms(lambda: R.rice_forward(params.visual, **rt),
                              n=3)
        if busy == 0.0:
            print(f"[ov-profile] {name}: device time not measured (the "
                  f"trace holds no device events)", flush=True)
        print(f"[ov-profile] {name}: prefill_wall_ms={prefill_ms!r} "
              f"prefill_device_busy_ms={busy!r} rice_device_ms={rice_ms!r} "
              f"(CUDA events, median of 3) decode_wall_ms_per_token="
              f"{step_ms!r} decode_device_ms_per_token={step_busy!r} "
              f"peak_mem_bytes={peak}", flush=True)
        print(f"[ov-profile] {name} prefill device ms by group: "
              + " ".join(f"{g}={ms!r}"
                         for g, ms in kernel_groups(kernels).items()),
              flush=True)
    head_check(params.lm, "[ov-profile]")


def ov_other_paths(cfg, params, engines, plains, req, checks):
    """11.5: loglikelihood and four choices; ``generate_batch`` and the
    batcher against one-shot; VisionZip and FastV at 0.2 (launches, and
    against the plain path); the two-image request."""
    import numpy as np
    import torch

    from visionselector_tpu_torch.models.llava_ov15.model import OVEngine
    from visionselector_tpu_torch.models.qwen25vl import model as M
    from visionselector_tpu_torch.models.qwen25vl.continuous import (
        ContinuousBatcher,
    )
    from visionselector_tpu_torch.selector.baselines import get_baseline

    n_blocks, n_layers = cfg.vision.depth, cfg.text.num_hidden_layers
    rng = np.random.RandomState(SEED + 12)
    ids = req["input_ids"]
    vision = dict(pixel_values=req["pixel_values"], grid_thw=req["grid_thw"])
    choices = [rng.randint(1000, 100000, n) for n in CHOICE_LENS]
    eng = engines["orig"]
    zero_counts()
    got = M.run_loglikelihood_choices(eng, ids, choices, **vision)
    counts = ov_counts()
    want = [eng.loglikelihood(ids, c, **vision) for c in choices]
    errs = [ll_per_token(g[0], w[0], len(c))
            for g, w, c in zip(got, want, choices)]
    print(f"[ov-eval] orig choices {CHOICE_LENS}: one prefill + chunks "
          f"{[round(g[0], 4) for g in got]} vs per-choice loglikelihood "
          f"{[round(w[0], 4) for w in want]}: |diff| per token {errs} "
          f"(limit {LL_TOL_CHUNK}); launches of the choices run {counts}",
          flush=True)
    checks["choices vs loglikelihood"] = (
        max(errs) <= LL_TOL_CHUNK and all(np.isfinite(g[0]) for g in got))
    checks["choices launches"] = counts["decode"] == n_layers * len(choices)

    text = dict(input_ids=rng.randint(1000, 100000, 200))
    reqs = [req, text, ov_request(cfg, second=True)]
    one = [engines["selector"].generate(**r, max_new_tokens=8) for r in reqs]
    batch = engines["selector"].generate_batch(reqs, max_new_tokens=8)
    same = [sum(a == b for a, b in zip(x.tokens, y.tokens))
            for x, y in zip(batch, one)]
    firsts = [x.tokens[:1] == y.tokens[:1] for x, y in zip(batch, one)]
    print(f"[ov-serve] generate_batch of {len(reqs)} (image, text, two "
          f"images) vs one-shot: tokens equal per row {same} of 8 (first "
          f"tokens equal: {firsts})", flush=True)
    checks["generate_batch first tokens"] = all(firsts)

    items = [(req, 8, {}), (text, 8, {}), (reqs[2], 6, {}),
             (req, 6, dict(temperature=0.8, top_p=0.9, top_k=50, seed=3)),
             (dict(input_ids=rng.randint(1000, 100000, 90)), 5, {}),
             (req, 4, {})]
    bat = ContinuousBatcher(engines["selector"], n_slots=4, t_max=4096,
                            chunk=8)
    t0 = time.perf_counter()
    try:
        outs = [None] * len(items)

        def submit(i):
            r, m, s = items[i]
            outs[i] = bat.submit(r, m, (-1,), **s)

        threads = [threading.Thread(target=submit, args=(i,))
                   for i in range(len(items))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(600)
    finally:
        bat.shutdown()
    wall = time.perf_counter() - t0
    firsts = [o.tokens[:1] == engines["selector"].generate(
        **r, max_new_tokens=1, eos_token_ids=(-1,)).tokens[:1]
        for o, (r, _, s) in zip(outs, items) if not s]
    print(f"[ov-serve] ContinuousBatcher(n_slots=4) 6 requests (image, "
          f"text, two images, one sampled): wall_s={wall!r} stats "
          f"{bat.stats} greedy first tokens equal one-shot {firsts}",
          flush=True)
    checks["batcher"] = (all(o is not None and len(o.tokens) == m
                             and all(0 <= t < cfg.text.vocab_size
                                     for t in o.tokens)
                             for o, (_, m, _) in zip(outs, items))
                         and all(firsts) and bat.stats["admitted"] == 6)

    from visionselector_tpu_torch.models.llava_ov15 import rice as R

    for method in ("visionzip", "fastv"):
        kw = dict(budget=0.2, strategy=get_baseline(method), device="cuda")
        strat = OVEngine(cfg, params, **kw)
        strat.generate(**req, max_new_tokens=2)  # warm-up
        zero_counts()
        res = strat.generate(**req, max_new_tokens=OV_STRATEGY_TOKENS)
        torch.cuda.synchronize()
        c = ov_counts()
        want = {"rice": n_blocks - (method == "visionzip"), "lm": n_layers,
                "decode": n_layers * ov_steps(res, OV_STRATEGY_TOKENS),
                "diag": 0, "fused": 0, "capped": 0, "packed": 0}
        res_p = OVEngine(cfg, params, attn_impl="plain", **kw).generate(
            **req, max_new_tokens=1)
        a, b = set(res.selected_indices.tolist()), set(
            res_p.selected_indices.tolist())
        overlap = len(a & b) / max(len(a), len(b))
        line = (f"[ov-strategy] {method} 0.2: kept {len(a)} prefill_len "
                f"{res.prefill_len} prefill_ms "
                f"{res.prefill_seconds * 1e3!r} launches {c} (expected "
                f"{want}); vs plain: first token {res.tokens[0]} / "
                f"{res_p.tokens[0]}, kept overlap {len(a & b)}/"
                f"{max(len(a), len(b))}")
        if method == "visionzip":
            # phase 8's rule: the dominant tokens (the top by received
            # attention) are held to the overlap; the stride-picked
            # contextual ones shift with any dominant one
            p = strat._prep_vision(ids, vision["pixel_values"],
                                   vision["grid_thw"], True, False)
            rt = strat._rice_tensors(p.rb)
            dom = int(p.n * (0.2 - strat.strategy.contextual_ratio))

            def top(impl):
                with torch.no_grad():
                    recv = R.rice_forward_stats(params.visual, **rt,
                                                attn_impl=impl)[1][:p.n]
                return set(torch.argsort(-recv, stable=True)[:dom].tolist())

            both = len(top(None) & top("plain"))
            overlap = both / dom
            line += f"; dominant (top {dom}) {both}/{dom}"
        print(line, flush=True)
        checks[f"{method} launches"] = c == want
        checks[f"{method} vs plain"] = (overlap >= 0.9
                                        and res.tokens[0] == res_p.tokens[0])

    two = reqs[2]
    for name in ("selector", "orig"):
        zero_counts()
        res = engines[name].generate(**two, max_new_tokens=MAX_NEW_TOKENS)
        torch.cuda.synchronize()
        c = ov_counts()
        want = {"rice": n_blocks, "lm": n_layers,
                "decode": n_layers * ov_steps(res)}
        res_p = plains[name].generate(**two, max_new_tokens=1)
        diff = (res_p.logits - res.logits).abs().max().item()
        scale = res.logits.abs().max().item()
        ok = diff <= 0.1 * scale
        if res.selected_indices is not None:
            a, b = set(res.selected_indices.tolist()), set(
                res_p.selected_indices.tolist())
            ok = len(a & b) / len(a) >= 0.9
        print(f"[ov-two-images] {name}: vision_tokens "
              f"{res.num_vision_tokens} prefill_len {res.prefill_len} "
              f"launches {c} (expected {want}); vs plain logits "
              f"{diff!r} of {scale!r}", flush=True)
        checks[f"two images {name}"] = ok and all(
            c[k] == v for k, v in want.items()) and (
            res.num_vision_tokens == OV_MERGED + 64)


def ov_hf_dir(cfg, params, tmp, procs):
    """11.6: an OV HF directory of the 8B weights at reduced depth (RICE
    blocks and decoder layers OV_HF_BLOCKS / OV_HF_LAYERS, full widths,
    bf16; the scorer fp32 in ``importance_scorer.safetensors``, as a
    trained one is copied in), written, read back bit for bit, and served by
    ``api.predict --family llava_ov15 --model-path`` in a process of its
    own; ``api.predict --family llava_ov15`` on the tiny random config
    (head dims 16 and 32) beside it. Returns the directory and the
    in-process result to compare with."""
    import dataclasses

    import numpy as np
    import torch

    from visionselector_tpu_torch.models.llava_ov15.model import (
        OVEngine,
        OVParams,
    )
    from visionselector_tpu_torch.models.llava_ov15.weights import (
        load_ov_checkpoint,
        ov_config_from_hf,
        save_ov_checkpoint,
    )
    from visionselector_tpu_torch.models.qwen25vl.weights import (
        export_scorer_to_safetensors,
    )
    from visionselector_tpu_torch.preprocess.image import preprocess_image
    from visionselector_tpu_torch.preprocess.rope import expand_vision_tokens

    small_cfg = dataclasses.replace(
        cfg, vision=dataclasses.replace(cfg.vision, depth=len(OV_HF_BLOCKS)),
        text=dataclasses.replace(cfg.text,
                                 num_hidden_layers=len(OV_HF_LAYERS)))
    vis, lm = params.visual, params.lm
    saved_blocks, saved_layers = vis.blocks, lm.layers
    vis.blocks = torch.nn.ModuleList(saved_blocks[i] for i in OV_HF_BLOCKS)
    lm.layers = torch.nn.ModuleList(saved_layers[i] for i in OV_HF_LAYERS)
    d = os.path.join(tmp, "ov_hf")
    t0 = time.perf_counter()
    scorer = params.scorer
    try:
        vis.cfg, lm.cfg = small_cfg.vision, small_cfg.text
        params.scorer = None  # the scorer goes in a file of its own
        save_ov_checkpoint(params, small_cfg, d, shards=2)
        params.scorer = scorer
        export_scorer_to_safetensors(
            scorer, os.path.join(d, "importance_scorer.safetensors"),
            prefix="model.visual.importance_scorer.")
        src = params.state_dict()  # the reduced model's tensors
    finally:
        params.scorer = scorer
        vis.blocks, lm.layers = saved_blocks, saved_layers
        vis.cfg, lm.cfg = cfg.vision, cfg.text
    write_s = time.perf_counter() - t0
    start_cli(procs, tmp, "predict", "--family", "llava_ov15",
              "--model-path", d, "--prompt-ids", "300,301,302",
              "--max-new-tokens", "4")
    t0 = time.perf_counter()
    loaded = load_ov_checkpoint(d, ov_config_from_hf(d), "cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    back = loaded.state_dict()
    same = back.keys() == src.keys() and all(
        torch.equal(back[n], src[n]) for n in src)
    print(f"[ov-hf] reduced-depth HF dir (RICE blocks {OV_HF_BLOCKS}, "
          f"decoder layers {OV_HF_LAYERS}, 2 shards): write_s={write_s!r} "
          f"load_to_card_s={load_s!r} bit_equal={same}", flush=True)
    del src, back
    img = (np.random.RandomState(0).rand(112, 112, 3) * 255).astype(np.uint8)
    px, grid = preprocess_image(img, min_pixels=1, max_pixels=10**9,
                                temporal_patch_size=1)
    res = OVEngine(loaded.cfg, loaded, device="cuda").generate(
        expand_vision_tokens([], [300, 301, 302], grid), px, grid,
        max_new_tokens=4)
    del loaded
    return same, res.tokens


def ov_phase(tmp, out_dir):
    """Phase 11. Raises if any check failed; returns (the main path's
    launches, the kernels line's entries, the config, the weights, the
    reduced-depth HF directory), the last three for phase 12."""
    import torch

    from visionselector_tpu_torch.core.config import llava_ov15_8b
    from visionselector_tpu_torch.models.llava_ov15.model import (
        OVEngine,
        init_ov_params,
    )

    t_phase = time.perf_counter()
    print(f"[ov] card: {nvidia_smi()}", flush=True)
    cfg = llava_ov15_8b()
    t0 = time.perf_counter()
    params = init_ov_params(cfg, torch.Generator(device="cuda").manual_seed(
        SEED), "cuda", torch.bfloat16)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in params.parameters())
    print(f"[ov] llava_ov15_8b random bf16 (scorer fp32): {n} parameters in "
          f"{time.perf_counter() - t0!r} s; memory allocated "
          f"{torch.cuda.memory_allocated()} bytes", flush=True)
    procs, checks = {}, {}
    tiny_tmp = os.path.join(tmp, "ov_tiny")
    os.makedirs(tiny_tmp)
    start_cli(procs, tiny_tmp, "predict", "--family", "llava_ov15",
              "--max-new-tokens", "3")
    procs["predict_tiny"] = procs.pop("predict")
    req = ov_request(cfg)
    engines = {name: OVEngine(cfg, params, use_selector=name == "selector",
                              budget=0.2, device="cuda")
               for name in ("selector", "orig")}
    plains = {name: OVEngine(cfg, params, use_selector=name == "selector",
                             budget=0.2, device="cuda", attn_impl="plain")
              for name in ("selector", "orig")}
    p = engines["selector"]._prep_vision(req["input_ids"],
                                         req["pixel_values"],
                                         req["grid_thw"], True, False)
    print(f"[ov] request: grid {req['grid_thw'].tolist()} patches "
          f"{len(req['pixel_values'])} bucket {p.s_bucket} S'="
          f"{len(p.rb.seg_ids)} merged {p.n} k={p.k} k_max={p.k_max} ids "
          f"{len(req['input_ids'])}", flush=True)
    checks["layout"] = (tuple(req["grid_thw"][0]) == OV_GRID
                        and p.s_bucket == OV_BUCKET and p.n == OV_MERGED
                        and (p.k, p.k_max) == (384, 409))
    kernels = ov_kernels(cfg, engines, req)
    launches = ov_main_path(cfg, engines, plains, req, checks)
    ov_profile(cfg, params, engines, req, out_dir)
    ov_other_paths(cfg, params, engines, plains, req, checks)
    same, want_tokens = ov_hf_dir(cfg, params, tmp, procs)
    hf_dir = os.path.join(tmp, "ov_hf")
    checks["HF dir bit-equal"] = same
    rc, stdout, stderr, secs = finish_cli(procs, "predict")
    out = json.loads(stdout.strip().splitlines()[-1]) if rc == 0 else {}
    print(f"[ov-hf] api.predict --family llava_ov15 --model-path (cuda): "
          f"rc={rc} in {secs!r} s {out or stderr[-2000:]}; in process "
          f"{want_tokens}", flush=True)
    checks["api.predict --model-path"] = bool(
        out.get("tokens") and out["tokens"][:1] == want_tokens[:1]
        and out.get("selector") and out["device"] == "cuda")
    rc, stdout, stderr, secs = finish_cli(procs, "predict_tiny")
    out = json.loads(stdout.strip().splitlines()[-1]) if rc == 0 else {}
    print(f"[ov-hf] api.predict --family llava_ov15 (tiny config, cuda): "
          f"rc={rc} in {secs!r} s {out or stderr[-2000:]}", flush=True)
    checks["api.predict tiny on cuda"] = bool(
        out.get("tokens") and out["num_vision_tokens"] == 16)
    bad = [k for k, ok in checks.items() if not ok]
    print(f"[ov] checks: {checks}", flush=True)
    print(f"[ov] phase seconds {time.perf_counter() - t_phase!r}",
          flush=True)
    del engines, plains
    torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"OV phase failed: {bad}")
    return launches, kernels, cfg, params, hf_dir


# Phase 12 (ov-train): OV-8B selector training at full width, the OV
# recipe through the CLIs, and checkpoint acceptance of both families.
OV_TRAIN_T_BUCKET = 2048
OV_TRAIN_STEPS = 4  # AdamW steps without remat, then as many with it
OV_REG = (0.1, 3.0)  # the OV recipe's reg-weight curriculum
OV_TRAIN_LEN = OV_MERGED + 2 + len(PROMPT_BEFORE) + len(PROMPT_AFTER) \
    + ANSWER_LEN  # 1,998 rows of the 2,048 bucket
ACCEPT_IDS = "300,301,302"


def ov_train_batch(cfg):
    """Phase 12's fixed batch, stacked on the host: 2 samples of the
    phase-3 image at its own 1036x1456 (OV's layout: grid 1x74x104, the
    8,192 bucket, 4 CLS slots, S' tile-padded to 8,256), its 40 prompt ids
    and a 32-id answer each, text bucket 2,048."""
    from visionselector_tpu_torch.train.data import stack_samples
    from visionselector_tpu_torch.train.ov_loss import build_ov_train_sample

    img = request_image()
    answers = [list(range(500 + 40 * i, 500 + 40 * i + ANSWER_LEN))
               for i in range(TRAIN_BATCH)]
    return stack_samples([build_ov_train_sample(
        cfg, img, PROMPT_BEFORE, PROMPT_AFTER, a, budget=0.2,
        s_bucket=OV_BUCKET, t_bucket=OV_TRAIN_T_BUCKET) for a in answers])


def ov_train_kernel(cfg, params, batch, k_max) -> dict:
    """12.1: K1 causal at the training step's shape (B = 2, T = 2,048, GQA
    32/8, D = 128), on q / k / v captured from the first decoder layer of
    one forward of the batch: ULP_LIMIT against its plain version, each q
    tile's diagonal kv tile cut as the planted fault, its time, bound and
    one SDPA call; then its gradient at that shape (``check_flash_grad``:
    the mirror backward against the plain forward's, planted mirror
    faults). Returns the kernels line's entry."""
    import torch

    from visionselector_tpu_torch.kernels import attention as A
    from visionselector_tpu_torch.train.train_step import batch_loss

    with torch.no_grad():
        seen = flash_capture(
            lambda: batch_loss(params, batch, cfg, 0.0, k_max), True)
    q, k, v, seg = seen["q"], seen["k"], seen["v"], seen["seg"]
    b, t, hq, d = q.shape
    hkv = k.shape[2]
    valid = seg.sum(1)
    nq = -(-t // TILE)
    iq = torch.arange(nq, device="cuda")
    cut = torch.stack([torch.zeros_like(iq), iq], 1).int()
    pos = torch.arange(t, device="cuda")
    mask = ((seg[:, None, :, None] > 0) & (seg[:, None, None, :] > 0)
            & (pos[:, None] >= pos[None]))
    pairs = sum(int(n) * (int(n) + 1) // 2 for n in valid)
    entry = ov_kernel_entry(
        "flash_varlen_fwd_ov_train",
        f"training step decoder layer 0 B={b} T={t} valid={valid.tolist()} "
        f"Hq={hq} Hkv={hkv} D={d}",
        lambda: A.flash_varlen_fwd(q, k, v, seg, seg, causal=True),
        lambda: A.flash_plain(q, k, v, seg, seg, causal=True),
        lambda: A.flash_varlen_fwd(q, k, v, seg, seg, causal=True,
                                   kv_bounds=cut),
        (2 * hq + 2 * hkv) * b * t * d * 2 + b * t * 8,
        4 * d * hq * pairs, lambda: sdpa_ms(q, k, v, mask),
        lambda got: bool((got[seg == 0] == 0).all()))
    del mask
    fwd_ms, mirror_ms = check_flash_grad(cfg, t=t, valid=tuple(
        valid.tolist()), tag="[ov-train]")
    n = cfg.text.num_hidden_layers
    print(f"[ov-train] K1 at the step's shape: forward {fwd_ms!r} ms, mirror "
          f"backward {mirror_ms!r} ms per decoder layer (x {n} layers: "
          f"{fwd_ms * n!r} / {mirror_ms * n!r} ms a step)", flush=True)
    return entry


def ov_train_phase(cfg, params, out_dir):
    """12.1: the gradient checks at the initial parameters, then
    OV_TRAIN_STEPS AdamW steps without remat and as many with it (reg
    weight 0.1 -> 3.0 over the 8; the last step of each under the
    profiler). Returns (checks, the last step's causal K1 launches, the
    kernels line's entry)."""
    import statistics

    import numpy as np
    import torch

    from visionselector_tpu_torch.kernels import attention as A
    from visionselector_tpu_torch.train.loss import (
        IGNORE_INDEX,
        reg_weight_schedule,
        to_device,
    )
    from visionselector_tpu_torch.train.train_step import (
        ScheduleConfig,
        init_train_state,
        train_step,
    )

    host = ov_train_batch(cfg)
    batch = to_device(host, "cuda")
    k_max = max(1, int(OV_BUCKET // cfg.vision.spatial_merge_unit * 0.2))
    sup = int((np.asarray(host.labels)[:, 1:] != IGNORE_INDEX).sum())
    valid = int(np.asarray(host.seg_ids).sum())
    layout = dict(merged=np.asarray(host.num_merged).tolist(),
                  k=np.asarray(host.k).tolist(), k_max=k_max,
                  s_prime=host.vit_seg_ids.shape[1],
                  rows=np.asarray(host.seg_ids).sum(1).tolist())
    print(f"[ov-train] batch: {TRAIN_BATCH} samples {layout} s_bucket "
          f"{OV_BUCKET} t_bucket {OV_TRAIN_T_BUCKET} valid_tokens={valid} "
          f"supervised_tokens={sup}", flush=True)
    checks = {"layout": layout == dict(
        merged=[OV_MERGED] * 2, k=[384] * 2, k_max=409, s_prime=8256,
        rows=[OV_TRAIN_LEN] * 2) and OV_TRAIN_LEN <= OV_TRAIN_T_BUCKET}
    entry = ov_train_kernel(cfg, params, batch, k_max)
    total = 2 * OV_TRAIN_STEPS
    sched = ScheduleConfig(total_steps=total, lr=TRAIN_LR,
                           reg_weight_start=OV_REG[0],
                           reg_weight_end=OV_REG[1])
    frozen = frozen_checksums(params)
    state = init_train_state(params, sched)
    checks.update(gradient_checks(cfg, params, state, batch, k_max,
                                  tag="[ov-train]", fp32_reference=False))
    n_rice, n_lm = TRAIN_BATCH * cfg.vision.depth, cfg.text.num_hidden_layers
    metrics, counts, steps = [], [], {}
    for remat in (False, True):
        sch = sched._replace(remat=remat)
        walls = []

        def step():
            t0 = time.perf_counter()
            out = train_step(state, params, batch, cfg, k_max, sch)
            torch.cuda.synchronize()
            return out, (time.perf_counter() - t0) * 1e3

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for i in range(OV_TRAIN_STEPS):
            zero_counts()
            if i == OV_TRAIN_STEPS - 1:  # the last step under the profiler
                busy, kernels, ((_, m), prof_wall), split = traced(
                    step, os.path.join(out_dir, f"profile_ov_train_"
                                       f"{'remat' if remat else 'plain'}"
                                       f".json"), parse=step_split)
            else:
                (_, m), wall = step()
                walls.append(wall)
            c = launch_counts()
            counts.append({"flash": c["flash_varlen_fwd"],
                           "causal": A.FLASH_CAUSAL_LAUNCHES,
                           "other": sum(n for name, n in c.items()
                                        if name != "flash_varlen_fwd")})
            metrics.append({k: float(v) for k, v in m.items()})
            print(f"[ov-train] step {len(metrics)} (remat={remat}): " + " ".join(
                f"{k}={v!r}" for k, v in metrics[-1].items())
                + f" launches {counts[-1]}", flush=True)
        peak = torch.cuda.max_memory_allocated()
        want = {"flash": n_rice + n_lm * (1 + remat),
                "causal": n_lm * (1 + remat), "other": 0}
        checks[f"launches per step (remat={remat})"] = all(
            c == want for c in counts[-OV_TRAIN_STEPS:])
        step_ms = statistics.median(walls)
        steps[remat] = (step_ms, peak)
        idle = (f"device_busy_ms={busy!r} wall_ms={prof_wall!r} idle_share="
                f"{1 - busy / prof_wall!r}" if busy else "device busy and "
                "idle share not measured (the trace holds no device events)")
        print(f"[ov-train] remat={remat}: step_wall_ms median={step_ms!r} "
              f"({walls!r}, unprofiled); expected launches per step {want}; "
              f"profiled step: {idle}; supervised_tok_s="
              f"{sup / step_ms * 1e3!r} valid_tok_s={valid / step_ms * 1e3!r}"
              f" max_memory_allocated={peak}", flush=True)
        print(f"[ov-train] remat={remat} step device ms by group: " + " ".join(
            f"{g}={ms!r}" for g, ms in kernel_groups(kernels).items()),
            flush=True)
        if split:
            print(f"[ov-train] remat={remat} profiled step device ms by the "
                  f"host code that launched it: forward={split['forward']!r} "
                  f"backward={split['backward']!r} update="
                  f"{split['update']!r} unmatched={split['unmatched']!r}; the "
                  f"mirror backward {split['mirror']!r} ms, "
                  f"{split['mirror'] / split['backward']!r} of the backward",
                  flush=True)
        else:
            print("[ov-train] forward / backward device time not measured "
                  "(the trace holds no autograd node or device event)",
                  flush=True)
    grads = {n: p.grad for n, p in params.scorer.named_parameters()}
    checks["losses finite"] = all(np.isfinite(m["loss"]) for m in metrics)
    checks["reg_weight schedule"] = [m["reg_weight"] for m in metrics] == [
        reg_weight_schedule(i, total, *OV_REG) for i in range(total)]
    checks["first step lr 0"] = metrics[0]["lr"] == 0.0
    checks["scorer grads finite, non-zero"] = bool(
        all(torch.isfinite(g).all() for g in grads.values())
        and all(grads[n].abs().max() > 0
                for n in ("q_kernel", "k_kernel", "k_bias")))
    after = frozen_checksums(params)
    checks["frozen bit-equal, no grad"] = all(
        torch.equal(after[n], frozen[n]) and p.grad is None
        for n, p in params.named_parameters() if n in frozen)
    print(f"[ov-train] {total} steps: bce {[m['bce'] for m in metrics]} "
          f"reg_weight {[m['reg_weight'] for m in metrics]}; step wall ms "
          f"no remat {steps[False][0]!r} remat {steps[True][0]!r}; "
          f"max_memory_allocated no remat {steps[False][1]} remat "
          f"{steps[True][1]}", flush=True)
    state.optimizer.zero_grad(set_to_none=True)
    return checks, counts[-1]["causal"], entry


def accept_task_dir(tmp) -> str:
    """Phase 7's four generate docs as the built-in ``chartqa`` task's
    file (``api.acceptance`` registers no task configs), text-only: the
    card's host has no Pillow."""
    d = os.path.join(tmp, "accept_tasks")
    os.makedirs(d)
    docs = [{"question": q, "answers": [a]} for q, a in (
        ("What is two plus two?", "4"), ("Name a primary color.", "red"),
        ("Spell the word cat.", "cat"), ("Is water wet?", "yes"))]
    with open(os.path.join(d, "chartqa.jsonl"), "w") as f:
        f.writelines(json.dumps(doc) + "\n" for doc in docs)
    return d


def accepted(stdout) -> tuple:
    """(the acceptance verdict, its steps) from an ``api.acceptance``
    run's output lines."""
    lines = [json.loads(ln) for ln in stdout.splitlines()
             if ln.startswith("{")]
    return (lines[-1].get("acceptance") if lines else None,
            [ln for ln in lines if "step" in ln])


def ov_cli_phase(tmp, qwen_hf, ov_hf, procs) -> dict:
    """12.2-12.3: the OV recipe through the CLIs and acceptance, each CLI
    a process of its own on the card, run beside each other: ``api.train
    --family llava_ov15 --smoke``; ``api.train --family llava_ov15
    --model-path`` phase 11's reduced-depth directory (3 steps, B = 2),
    its exported scorer copied into a copy of that directory (hard links)
    and served by ``api.predict --model-path`` (the trained scorer, first
    token equal to the in-process engine on the same weights);
    ``api.acceptance`` on phase 6's 3B directory and on phase 11's OV
    directory, each with ``regression8`` on one synthetic task; in
    process, ``verify_checkpoint --verify`` against the 3B transcript with
    one token changed, which must exit 1. The processes go in ``procs``.
    Returns the checks."""
    import numpy as np
    import torch

    from visionselector_tpu_torch.api import verify_checkpoint
    from visionselector_tpu_torch.core.safetensors import open_checkpoint
    from visionselector_tpu_torch.models.llava_ov15.model import OVEngine
    from visionselector_tpu_torch.models.llava_ov15.weights import (
        load_ov_checkpoint,
        ov_config_from_hf,
    )
    from visionselector_tpu_torch.models.qwen25vl.weights import (
        load_scorer_params,
    )
    from visionselector_tpu_torch.preprocess.image import preprocess_image
    from visionselector_tpu_torch.preprocess.rope import expand_vision_tokens

    checks = {}
    tasks = accept_task_dir(tmp)
    smoke_out, train_out = (os.path.join(tmp, n) for n in (
        "ov_smoke_train", "ov_train"))
    reg = ["--reg-weight-start", str(OV_REG[0]), "--reg-weight-end",
           str(OV_REG[1])]
    start_cli(procs, tmp, "train", "--family", "llava_ov15", "--smoke",
              "--total-steps", "3", "--log-steps", "1", "--output-dir",
              smoke_out, *reg, key="train_smoke")
    start_cli(procs, tmp, "train", "--family", "llava_ov15", "--model-path",
              ov_hf, "--total-steps", "3", "--batch-size", "2",
              "--log-steps", "1", "--vision-bucket", "256", "--text-bucket",
              "64", "--output-dir", train_out, *reg)
    accept = ["--prompt-ids", ACCEPT_IDS, "--max-new-tokens", "8",
              "--data-dir", tasks, "--tasks", "chartqa", "--limit", "4"]
    start_cli(procs, tmp, "acceptance", "--model-path", qwen_hf, *accept,
              key="accept_qwen")
    start_cli(procs, tmp, "acceptance", "--family", "llava_ov15",
              "--model-path", ov_hf, *accept, key="accept_ov")

    # the planted fault: a transcript with one token changed
    rec = os.path.join(tmp, "transcript.json")
    args = ["--model-path", qwen_hf, "--prompt-ids", ACCEPT_IDS,
            "--max-new-tokens", "8", "--device", "cuda"]
    zero_counts()
    rcs = [verify_checkpoint.main(args + ["--record", rec]),
           verify_checkpoint.main(args + ["--verify", rec])]
    with open(rec) as f:
        transcript = json.load(f)
    transcript["tokens"][0] += 1
    with open(rec, "w") as f:
        json.dump(transcript, f)
    rcs.append(verify_checkpoint.main(args + ["--verify", rec]))
    c = launch_counts()
    # per run of the 2-block / 2-layer directory: K4 at the window block,
    # K1 at the full block and the 2 causal layers, K5 per layer and step
    steps = ov_steps(SimpleNamespace(tokens=transcript["tokens"]), 8)
    want = {"diag_attn_fwd": 3, "flash_varlen_fwd": 3 * 3,
            "decode_blocked_fwd": 3 * 2 * steps}
    got = {k: c[k] for k in want}
    print(f"[ov-cli] verify_checkpoint on the 3B directory: record rc="
          f"{rcs[0]}, verify rc={rcs[1]}; the transcript's first token "
          f"changed: verify rc={rcs[2]} (must be 1); launches of the three "
          f"runs {got} (expected {want})", flush=True)
    checks["verify_checkpoint: planted token fails"] = rcs == [0, 0, 1]
    checks["verify_checkpoint: launches"] = got == want

    for name in ("accept_qwen", "accept_ov"):
        rc, stdout, stderr, secs = finish_cli(procs, name)
        verdict, steps = accepted(stdout)
        print(f"[ov-cli] api.acceptance ({name}): rc={rc} in {secs!r} s "
              f"verdict={verdict} steps {steps or stderr[-2000:]}",
              flush=True)
        checks[f"{name}: PASS"] = rc == 0 and verdict == "PASS" and [
            s["step"] for s in steps] == ["transcript", "golden_indices",
                                          "regression8"]
    for name, out, want_lines in (("train_smoke", smoke_out, 3),
                                  ("train", train_out, 3)):
        rc, _, stderr, secs = finish_cli(procs, name)
        log = os.path.join(out, "train_log.jsonl")
        ok = rc == 0 and os.path.isfile(log) and os.path.isfile(
            os.path.join(out, "importance_scorer.safetensors"))
        lines = open(log).read().splitlines() if ok else []
        checks[f"api.train --family llava_ov15 ({name})"] = (
            ok and len(lines) == want_lines
            and all(np.isfinite(json.loads(ln)["loss"]) for ln in lines))
        print(f"[ov-cli] api.train --family llava_ov15 ({name}): rc={rc} in "
              f"{secs!r} s; last log line "
              f"{lines[-1] if lines else stderr[-2000:]}", flush=True)

    # the trained scorer copied into a copy of the directory
    served = os.path.join(tmp, "ov_hf_trained")
    os.makedirs(served)
    for f in os.listdir(ov_hf):
        if f != "importance_scorer.safetensors":
            os.link(os.path.join(ov_hf, f), os.path.join(served, f))
    trained = os.path.join(train_out, "importance_scorer.safetensors")
    shutil.copy(trained, served)
    start_cli(procs, tmp, "predict", "--family", "llava_ov15",
              "--model-path", served, "--prompt-ids", ACCEPT_IDS,
              "--max-new-tokens", "4")
    loaded = load_ov_checkpoint(served, ov_config_from_hf(served), "cuda")
    want = load_scorer_params(open_checkpoint(trained), loaded.cfg, "cuda",
                              prefix="model.visual.importance_scorer.")
    same = all(torch.equal(a, b) for a, b in zip(
        loaded.scorer.parameters(), want.parameters()))
    base = load_scorer_params(open_checkpoint(os.path.join(
        ov_hf, "importance_scorer.safetensors")), loaded.cfg, "cuda",
        prefix="model.visual.importance_scorer.")
    moved = any(not torch.equal(a, b) for a, b in zip(
        loaded.scorer.parameters(), base.parameters()))
    img = (np.random.RandomState(0).rand(112, 112, 3) * 255).astype(np.uint8)
    px, grid = preprocess_image(img, min_pixels=1, max_pixels=10**9,
                                temporal_patch_size=1)
    ids = [int(x) for x in ACCEPT_IDS.split(",")]
    res = OVEngine(loaded.cfg, loaded, device="cuda").generate(
        expand_vision_tokens([], ids, grid), px, grid, max_new_tokens=4)
    del loaded
    rc, stdout, stderr, secs = finish_cli(procs, "predict")
    out = json.loads(stdout.strip().splitlines()[-1]) if rc == 0 else {}
    print(f"[ov-cli] the trained scorer in a copy of the directory: loaded "
          f"bit-equal to its export {same}, moved from phase 11's {moved}; "
          f"api.predict --family llava_ov15 --model-path: rc={rc} in "
          f"{secs!r} s {out or stderr[-2000:]}; in process {res.tokens}",
          flush=True)
    checks["api.predict serves the trained OV scorer"] = bool(
        same and moved and out.get("selector")
        and out.get("tokens", [])[:1] == res.tokens[:1]
        and out["device"] == "cuda")
    return checks


def ov_train_cli_phase(cfg, params, tmp, out_dir, qwen_hf, ov_hf):
    """Phase 12. Raises if any check failed; returns (the last training
    step's causal K1 launches, the kernels line's entry)."""
    import torch

    t0 = time.perf_counter()
    print(f"[ov-train] card: {nvidia_smi()}", flush=True)
    checks, launches, entry = ov_train_phase(cfg, params, out_dir)
    torch.cuda.empty_cache()
    procs = {}
    try:
        checks.update(ov_cli_phase(tmp, qwen_hf, ov_hf, procs))
    finally:
        for proc, _, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    print(f"[ov-train] checks: {checks}", flush=True)
    print(f"[ov-train] phase seconds {time.perf_counter() - t0!r}",
          flush=True)
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"OV training phase failed: {bad}")
    return launches, entry


# Phase 13 (spec): prompt-lookup speculative decoding and the int4 slot
# pool at full width, on phase 3's and phase 11's weights. A verify chunk
# is m + 1 rows per slot: K5 at t_c = SPEC_M + 1 = 8.
SPEC_M = 7
SPEC_T_C = SPEC_M + 1
SPEC_BATCHER_M = 3
# The reference's bound on an int4 pool's teacher-forced logit drift
# (max |diff| / max |logit| of a decode step against the bf16 pool's).
INT4_DRIFT_TOL = 0.25


def decode_work(base, t_c, quant, t, hq, hkv, dh):
    """(bytes of the live prefix + q + out, flop) of one decode-kernel
    call at these base lengths: chunk row i sees base + i + 1 keys."""
    import torch

    keys = torch.minimum(base[:, None] + torch.arange(
        1, t_c + 1, device=base.device), torch.tensor(t, device=base.device))
    live = int(keys[:, -1].sum())
    per_key = hkv * dh * (1 if quant else 2) * 2 + (hkv * 8 if quant else 0)
    qo = 2 * base.shape[0] * t_c * hq * dh * 2
    return live * per_key + qo, 4 * hq * dh * int(keys.sum())


def chunk_mask(base, t_c, t):
    """[B, 1, t_c, T] bool: chunk row i sees positions < base + i + 1."""
    import torch

    lim = base[:, None] + torch.arange(1, t_c + 1, device=base.device)
    return (torch.arange(t, device=base.device) < lim[..., None])[:, None]


def spec_k5_cases(tc, cases, kname, gen, t_c=SPEC_T_C,
                  tag="[spec-kernel]"):
    """13.1: K5 at ``t_c`` rows a slot (SPEC_T_C: a verify chunk) over
    each (where, bf16 k, v, base lengths) case, bf16 and int8, against its
    plain version with the in-chunk causal limit off by one planted (the
    kernel called with base + 1: row i sees one key more), ms, bound and
    one SDPA call (causal within the chunk + length mask). Returns the
    kernels line's entry (the first case, the largest error of all)."""
    import torch

    from visionselector_tpu_torch.kernels import attention as A
    from visionselector_tpu_torch.models.qwen25vl.lm import quantize_kv

    hq, hkv, dh = tc.num_attention_heads, tc.num_key_value_heads, tc.head_dim
    entries = []
    for where, kb, vb, base in cases:
        (k8, ks), (v8, vs) = quantize_kv(kb), quantize_kv(vb)
        b, rows = base.shape[0], kb.shape[1]
        for quant in (False, True):
            kc, vc = (k8, v8) if quant else (kb, vb)
            sc = dict(k_scale=ks, v_scale=vs) if quant else {}
            q = torch.randn(b, t_c, hq, dh, generator=gen,
                            device="cuda").bfloat16()
            nbytes, flop = decode_work(base, t_c, quant, rows, hq, hkv, dh)
            cluster = A.decode_cluster_size("cuda", b, t_c, hq, hkv, dh,
                                            quant)
            entries.append(ov_kernel_entry(
                kname,
                f"{'int8' if quant else 'bf16'} {where} t_c={t_c} B={b}"
                f" T={rows} Hq={hq} Hkv={hkv} (n_rep {hq // hkv}) D={dh} "
                f"base={base.tolist()} cluster={cluster}",
                lambda: A.decode_blocked_fwd(q, kc, vc, base, **sc),
                lambda: A.decode_blocked_plain(q, kc, vc, base, **sc),
                lambda: A.decode_blocked_fwd(q, kc, vc, base + 1, **sc),
                nbytes, flop,
                None if quant else (lambda: sdpa_ms(
                    q, kb, vb, chunk_mask(base, t_c, rows))),
                lambda got: True, tag=tag))
    return dict(entries[0], max_abs_err=max(e["max_abs_err"]
                                            for e in entries))


def spec_oneshot(cfg, params, engine, input_ids, pixels, grid, out_dir,
                 checks):
    """13.2: speculative decoding of the phase-3 selector request at m = 3
    and m = 7 (every verify step's greedy rows recorded: the emitted
    tokens must be their accepted prefixes), the first token equal to
    ``generate``'s, dispatches, accepted proposals, wall and device ms per
    emitted token beside the plain decode's; the K5 launches of the m = 7
    run (zeroed just before, read just after). Returns them."""
    import torch

    from visionselector_tpu_torch.kernels import attention as A
    from visionselector_tpu_torch.models.qwen25vl import model as M

    n_layers = cfg.text.num_hidden_layers
    req = dict(input_ids=input_ids, pixel_values=pixels, grid_thw=grid)
    kw = dict(max_new_tokens=MAX_NEW_TOKENS, eos_token_ids=(-1,))
    plain = engine.generate(**req, **kw)
    busy_pre, _, _ = traced(
        lambda: engine.generate(**req, **kw, _defer_decode=True),
        os.path.join(out_dir, "profile_spec_prefill.json"))
    busy_plain, _, _ = traced(lambda: engine.generate(**req, **kw),
                              os.path.join(out_dir, "profile_spec_plain.json"))
    n_dec = len(plain.tokens) - 1
    wall = (plain.total_seconds - plain.prefill_seconds) * 1e3
    print(f"[spec] plain decode: {n_dec} tokens after the first, wall ms "
          f"per token {wall / n_dec!r}, device ms per token "
          f"{(busy_plain - busy_pre) / n_dec!r}", flush=True)
    launches = None
    for m in (3, SPEC_M):
        steps = []
        verify = M._spec_verify

        def recording(*a, **k):
            out = verify(*a, **k)
            steps.append((out[0].tolist(), int(out[1])))
            return out

        spec_kw = dict(kw, propose_len=m)
        M.generate_speculative(engine, **req, **spec_kw)  # warm-up
        torch.cuda.synchronize()
        if m == SPEC_M:
            zero_counts()
        with patched(M, "_spec_verify", recording):
            res = M.generate_speculative(engine, **req, **spec_kw)
        torch.cuda.synchronize()
        if m == SPEC_M:
            launches = dict(A.DECODE_LAUNCHES_BY_ROWS)
            total_k5 = A.DECODE_LAUNCHES
        busy, _, _ = traced(
            lambda: M.generate_speculative(engine, **req, **spec_kw),
            os.path.join(out_dir, f"profile_spec_m{m}.json"))
        emitted = [res.tokens[0]]
        for greedy, a in steps:
            emitted += greedy[:a + 1]
        n = len(res.tokens) - 1
        wall = (res.total_seconds - res.prefill_seconds) * 1e3
        agree = next((i for i, (x, y) in enumerate(zip(res.tokens,
                                                        plain.tokens))
                      if x != y), len(plain.tokens))
        print(f"[spec] one-shot m={m}: {res.decode_dispatches} dispatches, "
              f"accepted {res.spec_accepted} of {res.spec_proposed}, tokens "
              f"per dispatch {n / res.decode_dispatches!r}, wall ms per "
              f"emitted token {wall / n!r}, device ms per emitted token "
              f"{(busy - busy_pre) / n!r}, "
              f"device ms per verify step "
              f"{(busy - busy_pre) / res.decode_dispatches!r}; first token "
              f"{res.tokens[0]} (generate {plain.tokens[0]}); {agree} of "
              f"{len(plain.tokens)} tokens equal generate's", flush=True)
        checks[f"one-shot m={m}: first token"] = (
            res.tokens[0] == plain.tokens[0])
        checks[f"one-shot m={m}: emitted = accepted verify argmaxes"] = (
            emitted[:len(res.tokens)] == res.tokens
            and len(steps) == res.decode_dispatches
            and len(res.tokens) == MAX_NEW_TOKENS)
    print(f"[spec] K5 launches of the m={SPEC_M} run by t_c: {launches}",
          flush=True)
    checks["one-shot K5 launches: layers x verify steps at t_c 8"] = (
        launches == {SPEC_T_C: n_layers * res.decode_dispatches}
        and total_k5 == n_layers * res.decode_dispatches)
    return launches.get(SPEC_T_C, 0)


def spec_verify_rows(cfg, params, engine, input_ids, pixels, grid, checks):
    """13.3 and 13.4, on copies of one prefill cache: the t_c = 8 verify
    rows against 8 t_c = 1 steps of the same tokens (the plain decode's),
    and the kernel against ``attn_impl="plain"``, each within TEACHER_TOL
    of max |logit| per row (phase 3's tolerance); then the true
    continuation: proposals that are the plain decode's own next m tokens
    are all accepted, or the first rejected row is one whose top-2 margin
    in the steps' logits is within twice that row's measured chunk-vs-step
    drift (a bf16 flip, ROADMAP §3)."""
    import dataclasses

    import torch

    from visionselector_tpu_torch.models.qwen25vl import lm as L
    from visionselector_tpu_torch.models.qwen25vl import model as M

    req = dict(input_ids=input_ids, pixel_values=pixels, grid_thw=grid)
    want = engine.generate(**req, max_new_tokens=SPEC_T_C + 1,
                           eos_token_ids=(-1,)).tokens
    state = engine.generate(**req, max_new_tokens=2 * SPEC_T_C,
                            eos_token_ids=(-1,), _defer_decode=True)

    def fresh():
        c = state.cache
        return dataclasses.replace(c, k=c.k.clone(), v=c.v.clone(),
                                   length=c.length.clone())

    dev = "cuda"
    cur = torch.tensor([want[0]], device=dev)
    pos = torch.tensor([state.start_pos], device=dev)
    props = torch.tensor([want[1:SPEC_T_C]], device=dev)
    logits = M._verify_logits(params, fresh(), cur, props, pos)[0][0]
    ids = torch.tensor([want[:SPEC_T_C]], device=dev)
    steps_logits, c = [], fresh()
    for i in range(SPEC_T_C):
        hidden, c = L.lm_decode_step(
            params.lm, c, L.embed_tokens(params.lm, ids[:, i:i + 1]),
            (pos + i).view(1, 1, 1).expand(3, 1, 1))
        steps_logits.append(L.lm_head(params.lm, hidden[0, 0]))
    steps_logits = torch.stack(steps_logits)
    plain_logits = M._verify_logits(params, fresh(), cur, props, pos,
                                    attn_impl="plain")[0][0]
    rels = {}
    for name, other in (("8 t_c=1 steps", steps_logits),
                        ('attn_impl="plain"', plain_logits)):
        rel = ((logits - other).abs().amax(-1)
               / other.abs().amax(-1)).tolist()
        same = int((logits.argmax(-1) == other.argmax(-1)).sum())
        print(f"[spec] teacher-forced verify chunk (t_c={SPEC_T_C}) against "
              f"{name}: per-row max|diff| / max|logit| {rel!r} (limit "
              f"{TEACHER_TOL}); argmax equal in {same} of {SPEC_T_C}",
              flush=True)
        checks[f"teacher-forced verify vs {name}"] = max(rel) <= TEACHER_TOL
        rels[name] = rel
    top2 = steps_logits.topk(2, dim=-1).values
    margin = ((top2[:, 0] - top2[:, 1])
              / steps_logits.abs().amax(-1)).tolist()
    a = int(M._greedy_accept(logits.argmax(-1), props[0]))
    print(f"[spec] true continuation (the plain decode's next {SPEC_M} "
          f"tokens proposed): a={a} of {SPEC_M}; steps' argmaxes equal the "
          f"plain decode's: {steps_logits.argmax(-1).tolist() == want[1:]}"
          f"; per-row top-2 margin / max|logit| {margin!r}", flush=True)
    checks["true continuation: a = m but where bf16 noise flips a row"] = (
        a == SPEC_M or margin[a] <= 2 * rels["8 t_c=1 steps"][a])


def spec_batcher(cfg, params, engine, input_ids, pixels, grid, out_dir,
                 checks):
    """13.5: ``ContinuousBatcher(speculative=3)`` on a subset of phase 5's
    mix (greedy, sampled and penalized), bf16 and int8 pools: first tokens
    equal to one-shot, ``spec_steps`` / ``spec_tokens``; one dispatch of
    8 rounds over 8 admitted slots, wall against device busy."""
    import numpy as np
    import torch

    from visionselector_tpu_torch.models.qwen25vl import lm as L
    from visionselector_tpu_torch.models.qwen25vl.continuous import (
        ContinuousBatcher,
        _insert_slot,
        _spec_rounds,
    )

    traffic = [x for x in serve_traffic(cfg, input_ids, pixels, grid)
               if x[0] == "selector"]
    part = traffic[:6]  # 4 greedy, 1 sampled, 1 penalized
    assert sum(1 for x in part if x[3].get("temperature")) == 1
    assert sum(1 for x in part if x[3].get("repetition_penalty")) == 1
    eos = (-1,)
    part = [(e, r, m, dict(kw, eos_token_ids=eos), d)
            for e, r, m, kw, d in part]
    for quant in (None, "int8"):
        bat = ContinuousBatcher(engine, n_slots=POOL_SLOTS, t_max=POOL_ROWS,
                                chunk=8, kv_quant=quant,
                                speculative=SPEC_BATCHER_M)
        res, wall = run_batcher(bat, part)
        ok = True
        for x, r in zip(part, res):
            _, req, max_new, kw, _ = x
            want = engine.generate(**req, max_new_tokens=1, **kw).tokens
            ok &= len(r.tokens) == max_new and (
                kw.get("temperature", 0.0) > 0 or r.tokens[0] == want[0])
        n_tok = sum(len(r.tokens) - 1 for r in res)
        print(f"[spec] batcher m={SPEC_BATCHER_M} {quant or 'bf16'} pool: "
              f"{len(part)} requests in {wall!r} s, decode tokens {n_tok}, "
              f"tok/s {n_tok / wall!r}, spec_steps {bat.stats['spec_steps']}"
              f" spec_tokens {bat.stats['spec_tokens']} accepted "
              f"{bat.stats['spec_accepted']} of {bat.stats['spec_proposed']}"
              f", chunks {bat.stats['chunks']}", flush=True)
        checks[f"batcher {quant or 'bf16'}: first tokens, budgets"] = ok
        checks[f"batcher {quant or 'bf16'}: spec rounds ran"] = (
            bat.stats["spec_steps"] == 8 * bat.stats["chunks"] > 0
            and bat.stats["spec_tokens"] == n_tok)
        del bat
    # One dispatch of 8 rounds over 8 admitted slots: wall vs device busy.
    admit = traffic[:POOL_SLOTS]
    states = [engine.generate(**r, max_new_tokens=m, eos_token_ids=eos,
                              _defer_decode=True) for _, r, m, _, _ in admit]
    pool = L.init_kv_cache(cfg.text, POOL_SLOTS, POOL_ROWS, "cuda",
                           torch.bfloat16)
    for i, st in enumerate(states):
        _insert_slot(pool, st.cache.k, st.cache.v, st.cache.length, i)
    cur = torch.tensor([st.next_token for st in states], device="cuda")
    pos = torch.tensor([st.start_pos for st in states], device="cuda")
    live = torch.ones(POOL_SLOTS, dtype=torch.bool, device="cuda")
    c = 128
    buf = np.full((POOL_SLOTS, c), -1, np.int64)
    for i, (_, r, _, _, _) in enumerate(admit):
        ctx = list(np.asarray(r["input_ids"])[-(c - 1):]) + [
            states[i].next_token]
        buf[i, c - len(ctx):] = ctx
    buf = torch.as_tensor(buf, device="cuda")
    len0 = pool.length.clone()

    def dispatch():
        pool.length.copy_(len0)
        return _spec_rounds(params, pool, cur, pos, live, buf,
                            SPEC_BATCHER_M, 8, 3)

    dispatch()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2):
        em, acc, _ = dispatch()
        acc.cpu()
    wall_ms = (time.perf_counter() - t0) * 1e3 / 2
    busy, kernels, _ = traced(lambda: [dispatch() for _ in range(2)],
                              os.path.join(out_dir,
                                           "profile_spec_dispatch.json"))
    k5 = sum(ms for k, (ms, _) in kernels.items() if "decode_blocked" in k)
    print(f"[spec] dispatch of 8 rounds x {POOL_SLOTS} slots (m="
          f"{SPEC_BATCHER_M}, t_c {SPEC_BATCHER_M + 1}): wall_ms={wall_ms!r}"
          f" device_busy_ms={busy / 2!r} idle_share="
          f"{1 - busy / 2 / wall_ms!r} decode_kernel_ms={k5 / 2!r}; "
          f"emitted per slot {(acc + 1).sum(0).tolist()}", flush=True)
    del pool, states


def spec_int4(cfg, params, engine, input_ids, pixels, grid, out_dir, checks):
    """13.6: the int4 pool: bytes beside bf16 and int8; a teacher-forced
    decode step over 8 admitted slots against the bf16 pool (drift under
    INT4_DRIFT_TOL); decode device ms per step and per token of bf16, int8
    and int4 (8 steps under the profiler); K5 launches 0 and the plain
    int4 route's calls counted; 4 requests through an int4 batcher."""
    import torch

    from visionselector_tpu_torch.kernels import attention as A
    from visionselector_tpu_torch.models.qwen25vl import lm as L
    from visionselector_tpu_torch.models.qwen25vl.continuous import (
        ContinuousBatcher,
        _decode_chunk_slots,
        _insert_slot,
    )

    n_layers = cfg.text.num_hidden_layers
    eos = (-1,)
    traffic = [x for x in serve_traffic(cfg, input_ids, pixels, grid)
               if x[0] == "selector" and not x[3]]  # 10 greedy requests
    admit = traffic[:POOL_SLOTS]
    states = [engine.generate(**r, max_new_tokens=m, eos_token_ids=eos,
                              _defer_decode=True) for _, r, m, _, _ in admit]
    cur = torch.tensor([st.next_token for st in states], device="cuda")
    pos = torch.tensor([st.start_pos for st in states], device="cuda")
    live = torch.ones(POOL_SLOTS, dtype=torch.bool, device="cuda")
    pools, logits, step_ms = {}, {}, {}

    def step_logits(pool):
        """A teacher-forced decode step's logits [S, V] over ``pool`` (its
        row written in place above the lengths, which stay)."""
        hidden, _ = L.lm_decode_step(
            params.lm, pool, L.embed_tokens(params.lm, cur)[:, None],
            pos[None, :, None].expand(3, POOL_SLOTS, 1))
        return L.lm_head(params.lm, hidden[:, 0])

    for quant in (False, "int8", "int4"):
        kind = quant or "bf16"
        pool = L.init_kv_cache(cfg.text, POOL_SLOTS, POOL_ROWS, "cuda",
                               torch.bfloat16, quant=quant)
        for i, st in enumerate(states):
            _insert_slot(pool, st.cache.k, st.cache.v, st.cache.length, i)
        fields = [f for f in ("k", "v", "k_scale", "v_scale")
                  if hasattr(pool, f)]
        nbytes = {f: getattr(pool, f).nbytes for f in fields}
        len0 = pool.length.clone()
        logits[kind] = step_logits(pool)
        if quant == "int4":
            # the same values and scales held as int8, which K5 reads, the
            # step's own row quantized to 4 bits too: the arithmetic of the
            # int4 route, through the kernel
            as8 = L.QuantKVCache(
                k=L.unpack_int4(pool.k), v=L.unpack_int4(pool.v),
                k_scale=pool.k_scale.clone(), v_scale=pool.v_scale.clone(),
                length=len0.clone())
            to8 = L.quantize_kv
            with patched(L, "quantize_kv", lambda x, bits=8: to8(x, 4)):
                logits["int4 values through K5"] = step_logits(as8)
            del as8

        def chunk(pool=pool, len0=len0):
            pool.length.copy_(len0)
            return _decode_chunk_slots(params, pool, cur, pos, live, 8)

        chunk()
        torch.cuda.synchronize()
        k0, i0 = A.DECODE_LAUNCHES, A.INT4_DECODE_CALLS
        busy, kernels, _ = traced(
            chunk, os.path.join(out_dir, f"profile_spec_pool_{kind}.json"))
        k5 = A.DECODE_LAUNCHES - k0
        i4 = A.INT4_DECODE_CALLS - i0
        step_ms[kind] = busy / 8
        print(f"[spec] {kind} pool ({POOL_SLOTS} x {POOL_ROWS}): bytes "
              f"{nbytes} = {sum(nbytes.values())}; decode device ms per "
              f"step {busy / 8!r} per token {busy / 8 / POOL_SLOTS!r}; K5 "
              f"launches {k5}, plain int4 route calls {i4} (8 steps)",
              flush=True)
        if quant == "int4":
            checks["int4: K5 launches 0, plain route layers x steps"] = (
                k5 == 0 and i4 == n_layers * 8)
            checks["int4: pool value bytes a quarter of bf16's"] = (
                nbytes["k"] + nbytes["v"]) * 4 == pools["bf16"]
        else:
            checks[f"{kind}: K5 launches layers x steps"] = (
                k5 == n_layers * 8 and i4 == 0)
        pools[kind] = nbytes["k"] + nbytes["v"]
        del pool
    image = torch.tensor(["pixel_values" in r for _, r, _, _, _ in admit])
    keys = [int(st.cache.length.max()) for st in states]

    def drift(a, b):
        rel = ((logits[a] - logits[b]).abs().amax(-1)
               / logits[b].abs().amax(-1)).cpu()
        same = int((logits[a].argmax(-1) == logits[b].argmax(-1)).sum())
        print(f"[spec] teacher-forced step, {a} against {b}: per-slot "
              f"max|diff| / max|logit| {rel.tolist()!r} (slots' keys "
              f"{keys}, image requests {image.tolist()}); argmax equal in "
              f"{same} of {POOL_SLOTS}", flush=True)
        return rel

    # The int4 route against K5 on the same values (phase 5's kernel vs
    # plain check, on these values).
    rel = drift("int4", "int4 values through K5")
    checks["int4 route = K5 on its dequantized values"] = bool(
        (rel <= TEACHER_TOL).all())
    # The reference's drift bound is set on an image request
    # (tests/test_continuous.py:669-699); text-only slots, with tens of
    # keys to average the 4-bit errors over, are reported beside it.
    for kind in ("int8", "int4"):
        rel = drift(kind, "bf16")
        checks[f"{kind} drift under {INT4_DRIFT_TOL} (image requests)"] = \
            bool((rel[image] < INT4_DRIFT_TOL).all()
                 and torch.isfinite(rel).all())
    print(f"[spec] decode device ms per step, int4 - bf16: "
          f"{step_ms['int4'] - step_ms['bf16']!r} (int8 - bf16 "
          f"{step_ms['int8'] - step_ms['bf16']!r})", flush=True)
    del states
    part = [(e, r, m, dict(kw, eos_token_ids=eos), 0.0)
            for e, r, m, kw, _ in traffic[:4]]
    bat = ContinuousBatcher(engine, n_slots=POOL_SLOTS, t_max=POOL_ROWS,
                            chunk=8, kv_quant="int4")
    res, wall = run_batcher(bat, part)
    vocab = cfg.text.vocab_size
    print(f"[spec] int4 batcher: 4 requests in {wall!r} s, stats "
          f"{bat.stats}", flush=True)
    checks["int4 batcher: budgets, tokens in range"] = all(
        len(r.tokens) == x[2] and all(0 <= t < vocab for t in r.tokens)
        for x, r in zip(part, res))


def spec_ov(ov_cfg, ov_params, checks) -> int:
    """13.7: one speculative request (m = 7) on OV-8B's selector engine
    and phase 11's request, the first token equal to ``generate``'s, the
    K5 launches at t_c 8 (zeroed just before, read just after). Returns
    them."""
    import torch

    from visionselector_tpu_torch.kernels import attention as A
    from visionselector_tpu_torch.models.llava_ov15.model import OVEngine
    from visionselector_tpu_torch.models.qwen25vl import model as M

    eng = OVEngine(ov_cfg, ov_params, use_selector=True, budget=0.2,
                   device="cuda")
    req = ov_request(ov_cfg)
    kw = dict(max_new_tokens=MAX_NEW_TOKENS, eos_token_ids=(-1,))
    plain = eng.generate(**req, **kw)
    torch.cuda.synchronize()
    zero_counts()
    res = M.generate_speculative(eng, **req, **kw, propose_len=SPEC_M)
    torch.cuda.synchronize()
    by_rows = dict(A.DECODE_LAUNCHES_BY_ROWS)
    n = len(res.tokens) - 1
    print(f"[spec] OV-8B one-shot m={SPEC_M}: {res.decode_dispatches} "
          f"dispatches, accepted {res.spec_accepted} of {res.spec_proposed}"
          f", wall ms per emitted token "
          f"{(res.total_seconds - res.prefill_seconds) * 1e3 / n!r}; first "
          f"token {res.tokens[0]} (generate {plain.tokens[0]}); K5 launches "
          f"by t_c {by_rows}", flush=True)
    layers = ov_cfg.text.num_hidden_layers
    checks["OV: first token, K5 at t_c 8 per verify step"] = (
        res.tokens[0] == plain.tokens[0]
        and len(res.tokens) == MAX_NEW_TOKENS
        and by_rows == {SPEC_T_C: layers * res.decode_dispatches})
    return by_rows.get(SPEC_T_C, 0)


def spec_phase(cfg, params, engine, input_ids, pixels, grid, ov_cfg,
               ov_params, out_dir):
    """Phase 13. Raises if any check failed; returns (launches, kernels
    line entries) of K5 at t_c 8: ``decode_blocked_fwd_t_c8`` (the 3B) and
    ``decode_blocked_fwd_ov_t_c8`` (OV-8B, n_rep 4)."""
    import torch

    t_phase = time.perf_counter()
    print(f"[spec] card: {nvidia_smi()}", flush=True)
    checks, kernels, launches = {}, {}, {}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    tc = cfg.text
    hkv, dh = tc.num_key_value_heads, tc.head_dim

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").bfloat16()

    lens = torch.tensor(DECODE_LENS, device="cuda")
    kernels["decode_blocked_fwd_t_c8"] = spec_k5_cases(tc, [
        ("8-slot pool", rnd(POOL_SLOTS, POOL_ROWS, hkv, dh),
         rnd(POOL_SLOTS, POOL_ROWS, hkv, dh),
         (lens - SPEC_T_C).clamp(min=0)),
        ("one slot, orig cache", rnd(1, ORIG_CACHE_ROWS, hkv, dh),
         rnd(1, ORIG_CACHE_ROWS, hkv, dh),
         torch.tensor([ORIG_BASE_LEN], device="cuda"))],
        "decode_blocked_fwd_t_c8", gen)
    otc = ov_cfg.text
    ohkv, odh = otc.num_key_value_heads, otc.head_dim
    # OV's orig cache: 1,966 valid rows (phase 11) of 2,048 + headroom
    ov_rows = 2048 + MAX_NEW_TOKENS + SPEC_T_C
    kernels["decode_blocked_fwd_ov_t_c8"] = spec_k5_cases(otc, [
        ("one slot, OV orig cache", rnd(1, ov_rows, ohkv, odh),
         rnd(1, ov_rows, ohkv, odh), torch.tensor([1966], device="cuda")),
        ("4-slot pool", rnd(4, ov_rows, ohkv, odh), rnd(4, ov_rows, ohkv, odh),
         torch.tensor([1, 63, 65, 1966], device="cuda"))],
        "decode_blocked_fwd_ov_t_c8", gen)
    launches["decode_blocked_fwd_t_c8"] = spec_oneshot(
        cfg, params, engine, input_ids, pixels, grid, out_dir, checks)
    spec_verify_rows(cfg, params, engine, input_ids, pixels, grid, checks)
    spec_batcher(cfg, params, engine, input_ids, pixels, grid, out_dir,
                 checks)
    spec_int4(cfg, params, engine, input_ids, pixels, grid, out_dir, checks)
    launches["decode_blocked_fwd_ov_t_c8"] = spec_ov(ov_cfg, ov_params,
                                                     checks)
    bad = [k for k, ok in checks.items() if not ok]
    print(f"[spec] checks: {checks}", flush=True)
    print(f"[spec] phase seconds {time.perf_counter() - t_phase!r}",
          flush=True)
    torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"speculative phase failed: {bad}")
    return launches, kernels


# Phase 14 (train-methods): the standard-path trainers of ``api.train`` at
# full width: packed rows, the dynamic predictor, SFT (3B) with the freeze
# policy, LoRA SFT (OV-8B), and the CLIs on the card.
PACK_RECORDS, PACK_HW = 8, (448, 448)  # 1,024 patches, 256 merged each
PACK_S_BUCKET, PACK_T_BUCKET, PACK_STEPS = 4096, 2048, 4
PACK_ROW = 4  # records per packed row: 4 x 1,024 aligned vision rows
# the smallest buckets that hold one record (1,024 aligned vision rows, 330
# ids): the unpacked steps packing is measured against
PACK_SMALL = 1024, 512
PACK_SEG = PACK_T_BUCKET, 330  # K1's packed-row check: 4 x 330 + a tail
METHOD_STEPS = 3  # SFT and LoRA steps; dynamic takes 4
DYN_STEPS = 4
# The predictor's lr. At TRAIN_LR (5e-3) the keep ratio went 0.49 -> 0.40
# -> 0.81 over three updates (measured on one H100): on these random weights
# the CE's gradient on the predictor points against the mask loss's
# (cosine -0.99) and is twice its norm, and a larger lr only swings
# further.
DYN_LR = 1e-3
LORA_RANK, LORA_ALPHA = 64, 16  # the reference's OV recipe
# the merged model's logits against the adapter model's: phase 11's rule
# (max |difference| within 0.1 of the largest |logit|)
MERGE_TOL = 0.1


def detached_diag(q, k, v, seg, scale=None, block_q=None, impl=None):
    """The planted fault of 14e, in the ViT's ``attention_diag``: the diag
    kernel's output cut from the graph (what ``attention_diag`` returned
    under grad before it went through ``FlashAttentionFn``)."""
    from visionselector_tpu_torch.kernels import attention as A

    return A.diag_attn_fwd(q, k, v, seg, scale, block_q).detach()


def same_sums(a, b) -> bool:
    import torch

    return a.keys() == b.keys() and all(torch.equal(a[n], b[n]) for n in a)


def timed_step(fn):
    """(fn's result, its wall ms, ended by a synchronize)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def methods_packed_k1(cfg) -> dict:
    """14a: K1 causal on packed rows (B = 2, T = 2,048, GQA 16/2, D = 128;
    each row 4 samples of 330 rows, each its own segment, then padding):
    the forward against ``flash_plain`` (ULP_LIMIT; the kernel given the
    row's segments merged into one as the planted fault), time, bound,
    the visited and valid (query, key) pairs and one SDPA call with the
    causal + segment mask; dq, dk, dv through ``FlashAttentionFn`` against
    autograd of the plain version (GRAD_TOL). Returns the kernels line's
    entry."""
    import torch

    from visionselector_tpu_torch.kernels import attention as A
    from visionselector_tpu_torch.kernels import tiles as T

    b, (t, length) = TRAIN_BATCH, PACK_SEG
    valid = PACK_ROW * length
    hq, hkv, d = (cfg.text.num_attention_heads, cfg.text.num_key_value_heads,
                  cfg.text.head_dim)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").bfloat16()

    q, k, v, g = rnd(b, t, hq, d), rnd(b, t, hkv, d), rnd(b, t, hkv, d), \
        rnd(b, t, hq, d)
    row = torch.zeros(t, dtype=torch.int32, device="cuda")
    for i in range(PACK_ROW):
        row[i * length:(i + 1) * length] = i + 1
    seg = row[None].repeat(b, 1)
    merged = (seg > 0).int()
    pos = torch.arange(t, device="cuda")
    mask = ((seg[:, None, :, None] == seg[:, None, None, :])
            & (seg[:, None, None, :] > 0) & (pos[:, None] >= pos[None]))
    visited, _ = T.flash_steps_plain(row.cpu(), row.cpu(), True, None, None)
    visited = visited.numpy()
    pairs = valid_pairs(row.cpu().numpy(), visited, True)
    entry = ov_kernel_entry(
        "flash_varlen_fwd_packed_train",
        f"packed rows B={b} T={t} segments {PACK_ROW}x{length} Hq={hq} "
        f"Hkv={hkv} D={d}",
        lambda: A.flash_varlen_fwd(q, k, v, seg, seg, causal=True),
        lambda: A.flash_plain(q, k, v, seg, seg, causal=True),
        lambda: A.flash_varlen_fwd(q, k, v, merged, merged, causal=True),
        # q, k, v of the valid rows (no padding row's is needed), out over
        # every row (its padding written as zeros), the segment ids
        (hq * valid + hq * t + 2 * hkv * valid) * b * d * 2 + b * t * 8,
        4 * d * hq * pairs * b, lambda: sdpa_ms(q, k, v, mask),
        lambda got: bool((got[seg == 0] == 0).all()),
        tag="[methods-kernel]")
    del mask
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    n0 = A.FLASH_GRAD_LAUNCHES
    out = A.attention(*leaves, seg, seg, causal=True)
    out.backward(g)
    launched = A.FLASH_GRAD_LAUNCHES - n0
    refs = [x.clone().requires_grad_(True) for x in (q, k, v)]
    A.flash_plain(*refs, seg, seg, causal=True).backward(g)
    errs = [rel_err(x.grad, r.grad) for x, r in zip(leaves, refs)]
    mirror_ms = cuda_ms(lambda: A.flash_backward_plain(
        q, k, v, seg, seg, True, None, out.detach(), g), n=3)
    print(f"[methods-kernel] packed rows: visited (query, key) pairs per "
          f"row {int(visited.sum()) * TILE * TILE} for {pairs} valid "
          f"({int(visited.sum()) * TILE * TILE / pairs!r}x); gradient "
          f"through FlashAttentionFn ({launched} launch under grad) against "
          f"autograd of flash_plain: dq/dk/dv rel_err={errs!r} (limit "
          f"{GRAD_TOL}); mirror backward ms={mirror_ms!r}", flush=True)
    if not (max(errs) <= GRAD_TOL and launched == 1):
        raise AssertionError("K1 packed-row gradient check failed")
    return entry


def diag_capture(run) -> dict:
    """q, k, v, seg and scale of the first diag-kernel call ``run()``
    makes."""
    from visionselector_tpu_torch.kernels import attention as A

    seen = {}
    diag = A.diag_attn_fwd

    def capture(q, k, v, seg, scale=None, block_q=A.DIAG_BLOCK):
        if not seen:
            seen.update(q=q.clone(), k=k.clone(), v=v.clone(),
                        seg=seg.clone(), scale=scale)
        return diag(q, k, v, seg, scale, block_q)

    with patched(A, "diag_attn_fwd", capture):
        run()
    return seen


def methods_diag_grad(engine, input_ids, pixels, grid, checks):
    """14b: K4 under autograd on the ViT's first window layer at S =
    6,144 (q, k, v captured from a phase-3 prefill): ``FlashAttentionFn``'s
    dq, dk, dv against autograd of ``diag_plain`` (GRAD_TOL), one launch
    counted under grad, the mirror given one merged segment (planted)
    above the tolerance; the mirror's ms beside K4's."""
    import torch

    from visionselector_tpu_torch.kernels import attention as A

    with torch.no_grad():
        seen = diag_capture(lambda: engine.generate(
            input_ids, pixels, grid, max_new_tokens=1))
    q, k, v, seg, scale = (seen[n] for n in ("q", "k", "v", "seg", "scale"))
    g = torch.randn(q.shape, generator=torch.Generator(
        device="cuda").manual_seed(SEED + 15), device="cuda").bfloat16()
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    n0 = A.DIAG_GRAD_LAUNCHES
    out = A.attention_diag(*leaves, seg, scale=scale)
    out.backward(g)
    launched = A.DIAG_GRAD_LAUNCHES - n0
    refs = [x.clone().requires_grad_(True) for x in (q, k, v)]
    want = A.diag_plain(*refs, seg, scale)
    want.backward(g)
    ulps = bf16_ulp_err(out.detach(), want.detach())
    errs = [rel_err(x.grad, r.grad) for x, r in zip(leaves, refs)]
    merged = (seg > 0).int()
    bad = A.flash_backward_plain(q, k, v, merged, merged, False, scale,
                                 out.detach(), g)
    fault = max(rel_err(x, r.grad) for x, r in zip(bad, refs))
    k4_ms = cuda_ms(lambda: A.diag_attn_fwd(q, k, v, seg, scale))
    mirror_ms = cuda_ms(lambda: A.flash_backward_plain(
        q, k, v, seg, seg, False, scale, out.detach(), g), n=3)
    print(f"[methods-diag] K4 under grad, ViT window layer S={q.shape[1]} "
          f"H={q.shape[2]} D={q.shape[3]}: {launched} launch under grad, "
          f"out ulp_err={ulps!r} (limit {ULP_LIMIT}); FlashAttentionFn dq/dk/"
          f"dv against autograd of diag_plain rel_err={errs!r} (limit "
          f"{GRAD_TOL}); planted fault (the mirror given one merged "
          f"segment) {fault!r} (must exceed it); K4 forward ms={k4_ms!r} "
          f"mirror backward ms={mirror_ms!r} ({mirror_ms / k4_ms!r}x; x 28 "
          f"window layers: {mirror_ms * 28!r} ms a sample)", flush=True)
    checks["K4 gradient"] = (launched == 1 and ulps <= ULP_LIMIT
                             and max(errs) <= GRAD_TOL and fault > GRAD_TOL)
    return k4_ms, mirror_ms


def pack_records():
    """PACK_RECORDS seeded 448x448 records: the 20 + 20 prompt ids around
    the image slot and a 32-id answer (the supervised labels)."""
    import numpy as np

    from visionselector_tpu_torch.train.loss import IGNORE_INDEX

    rng = np.random.RandomState(SEED + 14)
    recs = []
    for i in range(PACK_RECORDS):
        img = (rng.rand(*PACK_HW, 3) * 255).astype(np.uint8)
        answer = list(range(600 + 40 * i, 600 + 40 * i + ANSWER_LEN))
        prompt = PROMPT_BEFORE + PROMPT_AFTER
        recs.append({"ids": prompt + answer, "image_slot":
                     len(PROMPT_BEFORE), "image": img, "images": [img],
                     "labels": [IGNORE_INDEX] * len(prompt) + answer})
    return recs


def methods_packed_train(cfg, params, checks) -> int:
    """14c: ``api.train._packed_stream`` over PACK_RECORDS records (rows of
    4 records, B = 2) and PACK_STEPS selector steps (lr 5e-3, reg_weight
    1.0) with launch counts; then as many unpacked steps over the same
    records at the same buckets (their valid tokens/s ratio is the padding
    ratio, as the walls are equal) and at the smallest buckets that hold
    one record (PACK_SMALL: what packing gains). Returns the causal K1
    launches of the last packed step (the counts zeroed just before
    it)."""
    from types import SimpleNamespace

    import numpy as np

    from visionselector_tpu_torch.api.train import _packed_stream
    from visionselector_tpu_torch.kernels import attention as A
    from visionselector_tpu_torch.train.data import stack_samples
    from visionselector_tpu_torch.train.dataset import (
        build_sample_from_record,
    )
    from visionselector_tpu_torch.train.loss import to_device
    from visionselector_tpu_torch.train.train_step import (
        ScheduleConfig,
        init_train_state,
        train_step,
    )

    recs = pack_records()
    args = SimpleNamespace(text_bucket=PACK_T_BUCKET,
                           vision_bucket=PACK_S_BUCKET, budget=0.2)
    stream = _packed_stream(cfg, recs, args, build_sample_from_record)
    rows = [next(stream) for _ in range(TRAIN_BATCH)]
    packed = to_device(stack_samples(rows), "cuda")

    def unpacked(s_bucket, t_bucket):
        singles = [build_sample_from_record(cfg, r, 0.2, s_bucket, t_bucket)
                   for r in recs]
        return [to_device(stack_samples(singles[i:i + TRAIN_BATCH]), "cuda")
                for i in range(0, len(singles), TRAIN_BATCH)]

    segs = [int(np.asarray(r.seg_ids).max()) for r in rows]
    lens = [int((np.asarray(r.seg_ids) > 0).sum()) for r in rows]
    print(f"[methods-packed] {PACK_RECORDS} records of {PACK_HW}: rows of "
          f"{segs} records, {lens} ids, merged "
          f"{[int(r.num_merged) for r in rows]} k {[int(r.k) for r in rows]}"
          f" window_diag {[bool(r.window_diag) for r in rows]} (vision "
          f"bucket {PACK_S_BUCKET}, text bucket {PACK_T_BUCKET})",
          flush=True)
    checks["packed rows"] = segs == [PACK_ROW] * TRAIN_BATCH and all(
        bool(r.window_diag) for r in rows)
    n_full = len(cfg.vision.fullatt_block_indexes)
    want = {"diag": TRAIN_BATCH * (cfg.vision.depth - n_full),
            "vit_k1": TRAIN_BATCH * n_full,
            "causal": cfg.text.num_hidden_layers}
    result = {}
    for name, batches, s_bucket in (
            ("packed", [packed] * PACK_STEPS, PACK_S_BUCKET),
            ("unpacked", unpacked(PACK_S_BUCKET, PACK_T_BUCKET),
             PACK_S_BUCKET),
            ("unpacked_small", unpacked(*PACK_SMALL), PACK_SMALL[0])):
        k_max = max(1, int(s_bucket // cfg.vision.spatial_merge_unit * 0.2))
        sched = ScheduleConfig(total_steps=len(batches), lr=TRAIN_LR,
                               reg_weight_start=1.0, reg_weight_end=1.0)
        state = init_train_state(params, sched)
        losses, walls, counts = [], [], []
        for batch in batches:
            zero_counts()
            (state, m), wall = timed_step(lambda: train_step(
                state, params, batch, cfg, k_max, sched))
            counts.append({"diag": A.DIAG_LAUNCHES,
                           "vit_k1": A.FLASH_LAUNCHES
                           - A.FLASH_CAUSAL_LAUNCHES,
                           "causal": A.FLASH_CAUSAL_LAUNCHES})
            losses.append(float(m["loss"]))
            walls.append(wall)
        valid = sum(int((b.seg_ids > 0).sum()) for b in batches)
        ms = sorted(walls[1:])[len(walls[1:]) // 2]
        result[name] = (valid / len(batches)) / ms * 1e3
        print(f"[methods-packed] {name} (vision bucket "
              f"{batches[0].pixel_values.shape[1]}, text bucket "
              f"{batches[0].input_ids.shape[1]}): {len(batches)} steps loss "
              f"{losses!r} step_wall_ms {walls!r} (median after the first "
              f"{ms!r}) valid_tok_s={result[name]!r} launches {counts}",
              flush=True)
        checks[f"{name} launches per step"] = all(c == want for c in counts)
        if name == "packed":
            checks["packed loss falls"] = losses[-1] < losses[0]
            packed_causal = counts[-1]["causal"]
    print(f"[methods-packed] packed / unpacked valid tokens per second: at "
          f"the same buckets {result['packed'] / result['unpacked']!r}x, at "
          f"the smallest buckets that hold one record "
          f"{result['packed'] / result['unpacked_small']!r}x", flush=True)
    for p in params.parameters():
        p.requires_grad_(False)
    return packed_causal


def dynamic_terms(cfg, params, predictor, batch, sched):
    """The predictor's gradients of the CE and of the weighted mask loss
    apart, at its initial parameters on one set of Gumbel draws (tau 1):
    their norms and cosine; then the mask loss on the same draws after a
    step of -eta g / |g| along the mask term's gradient g alone, at three
    step sizes. Returns (the mask loss before, {eta: after})."""
    import copy

    import torch

    from visionselector_tpu_torch.train.dynamic_train import (
        dynamic_batch_forward,
    )
    from visionselector_tpu_torch.train.train_step import global_norm

    l_pad = batch.image_positions.shape[1]
    u = torch.rand(TRAIN_BATCH, l_pad, 2, device="cuda",
                   generator=torch.Generator(device="cuda").manual_seed(
                       SEED + 16))

    def forward(pred):
        return dynamic_batch_forward(pred, params, batch, cfg, 1.0, sched,
                                     uniforms=u)[1]

    m = forward(predictor)
    terms = {"ce": m["ce"].mean(),
             "mask": sched.mask_loss_weight * m["mask_loss"].mean()}
    grads = {n: torch.autograd.grad(t, list(predictor.parameters()),
                                    retain_graph=True)
             for n, t in terms.items()}
    norms = {n: global_norm(g).item() for n, g in grads.items()}
    cos = (sum((a.float() * b.float()).sum() for a, b in zip(
        grads["ce"], grads["mask"])) / (norms["ce"] * norms["mask"])).item()
    probe = {}
    for eta in (1e-2, 1e-1, 1.0):
        moved = copy.deepcopy(predictor)
        with torch.no_grad():
            for p, g in zip(moved.parameters(), grads["mask"]):
                p -= eta * g / norms["mask"]
            probe[eta] = forward(moved)["mask_loss"].mean().item()
    print(f"[methods-dynamic] predictor gradients at step 0 (tau 1, one "
          f"set of draws): CE norm {norms['ce']!r}, weighted mask loss norm "
          f"{norms['mask']!r}, cosine {cos!r}; mask loss "
          f"{m['mask_loss'].mean().item()!r} -> {probe!r} after a step of "
          f"eta along the mask term's gradient alone (same draws)",
          flush=True)
    return m["mask_loss"].mean().item(), probe


def dynamic_descent(cfg, params, predictor, batch, sched, checks):
    """One ``dynamic_train_step`` on one fixed set of Gumbel draws, on a
    copy of ``predictor``. The warmup gives the first update lr 0, so the
    generator is rewound and the second step takes the same draws (and a
    constant tau, so both steps see the same gradient g and Adam's first
    moving update is -lr g / |g| elementwise). Checks: both steps report
    the objective (CE + w * mask loss) evaluated on those draws, the lr 0
    step moves nothing, the next moves every predictor tensor, the
    objective's first-order change along that update, g . delta, is
    negative (a step with the wrong sign or none fails), and the objective
    on the same draws is lower after the step. The last is not implied by
    the first: the forward runs the hard keep mask, so the objective moves
    only where a row's decision flips, which the straight-through gradient
    does not see."""
    import copy

    import torch

    from visionselector_tpu_torch.train.dynamic_train import (
        dynamic_batch_forward,
        dynamic_train_step,
        init_dynamic_train_state,
    )

    sched = sched._replace(tau_end=sched.tau_start)
    state = init_dynamic_train_state(params, copy.deepcopy(predictor), sched,
                                     seed=SEED + 17)
    draws = state.generator.get_state()
    gen = torch.Generator(device="cuda")
    gen.set_state(draws)
    # the draws gumbel_keep_mask takes from the state's generator
    u = torch.rand(TRAIN_BATCH, batch.image_positions.shape[1], 2,
                   generator=gen, device="cuda")

    def objective(pred):
        losses, m = dynamic_batch_forward(pred, params, batch, cfg,
                                          sched.tau_start, sched, uniforms=u)
        return losses.mean(), m["keep_ratio"].mean().item()

    weights = list(state.predictor.parameters())
    loss0, keep0 = objective(state.predictor)
    grads = torch.autograd.grad(loss0, weights)
    loss0 = loss0.item()
    theta0 = [p.detach().clone() for p in weights]
    state, m1 = dynamic_train_step(state, params, batch, cfg, sched)
    still = all(torch.equal(p, t) for p, t in zip(weights, theta0))
    state.generator.set_state(draws)
    state, m2 = dynamic_train_step(state, params, batch, cfg, sched)
    delta = [p.detach() - t for p, t in zip(weights, theta0)]
    moved = sum(bool(d.any()) for d in delta)
    first = sum((g.double() * d.double()).sum() for g, d in zip(
        grads, delta)).item()
    with torch.no_grad():
        loss1, keep1 = objective(state.predictor)
    same = [abs(float(m["loss"]) - loss0) <= 1e-4 * abs(loss0)
            for m in (m1, m2)]
    print(f"[methods-dynamic] one step on fixed draws (tau {sched.tau_start}"
          f"): objective {loss0!r} (the steps report {float(m1['loss'])!r}, "
          f"{float(m2['loss'])!r}); step 1 lr {float(m1['lr'])!r} moved "
          f"nothing {still}; step 2 lr {float(m2['lr'])!r} moved {moved} of "
          f"{len(delta)} tensors, first-order change g.delta {first!r} (must "
          f"be < 0; |g|_1 {sum(g.abs().sum().item() for g in grads)!r}); "
          f"objective after {loss1.item()!r} (must be lower; keep ratio "
          f"{keep0!r} -> {keep1!r})", flush=True)
    checks["dynamic: a step descends its objective"] = (
        all(same) and still and float(m1["lr"]) == 0.0
        and moved == len(delta) and first < 0 and loss1.item() < loss0)


def methods_dynamic(cfg, params, input_ids, pixels, grid, tmp, checks):
    """14d: the CE's and the mask loss's gradients on the predictor apart,
    and a step along the mask loss's alone, which must lower it on the
    same Gumbel draws (``dynamic_terms``); one ``dynamic_train_step`` on
    fixed draws that must descend its objective (``dynamic_descent``);
    then DYN_STEPS predictor steps (d_model 512, 8 heads) on phase 6's
    batch at DYN_LR: CE, mask loss and keep ratio; the predictor moves at
    every step whose lr is above 0 and at no other; only the predictor
    changes; 2 causal K1 launches without grad and 34 with grad per step;
    the export reloaded bit for bit drives ``DynamicSelect`` to the
    in-memory predictor's first token."""
    import torch

    from visionselector_tpu_torch.kernels import attention as A
    from visionselector_tpu_torch.models.qwen25vl.model import QwenVLEngine
    from visionselector_tpu_torch.selector.baselines.dynamic import (
        DynamicSelect,
        init_predictor,
    )
    from visionselector_tpu_torch.train.dynamic_train import (
        DynamicScheduleConfig,
        dynamic_train_step,
        export_predictor_to_safetensors,
        init_dynamic_train_state,
        load_predictor,
    )
    from visionselector_tpu_torch.train.loss import to_device

    batch = to_device(train_batch(cfg), "cuda")
    sched = DynamicScheduleConfig(total_steps=DYN_STEPS, lr=DYN_LR)
    pred = init_predictor(cfg.text.hidden_size, torch.Generator(
        device="cuda").manual_seed(SEED + 14), "cuda", d_model=512,
        num_heads=8)
    before = checksums(params, lambda n: True)
    state = init_dynamic_train_state(params, pred, sched, seed=SEED)
    m0, probe = dynamic_terms(cfg, params, state.predictor, batch, sched)
    checks["dynamic: the mask loss's gradient lowers it"] = (
        probe[0.1] < m0 and probe[1.0] < probe[0.1])
    dynamic_descent(cfg, params, state.predictor, batch, sched, checks)
    target, n_layers = sched.target_layer, cfg.text.num_hidden_layers
    metrics, walls, counts, moved = [], [], [], []
    for _ in range(DYN_STEPS):
        last = [p.detach().clone() for p in state.predictor.parameters()]
        zero_counts()
        (state, m), wall = timed_step(lambda: dynamic_train_step(
            state, params, batch, cfg, sched))
        counts.append((A.FLASH_CAUSAL_LAUNCHES - A.FLASH_GRAD_LAUNCHES,
                       A.FLASH_GRAD_LAUNCHES))
        moved.append(not all(torch.equal(p, q) for p, q in zip(
            state.predictor.parameters(), last)))
        metrics.append({k: float(v) for k, v in m.items()})
        walls.append(wall)
        print(f"[methods-dynamic] step {len(walls)}: " + " ".join(
            f"{k}={v!r}" for k, v in metrics[-1].items())
            + f" causal K1 without / with grad {counts[-1]} predictor moved "
            f"{moved[-1]} wall_ms={wall!r}", flush=True)
    print(f"[methods-dynamic] mask loss over the steps "
          f"{[m['mask_loss'] for m in metrics]!r} (not checked: on these "
          f"random weights the CE's gradient opposes the mask loss's)",
          flush=True)
    checks["dynamic K1 launches"] = all(
        c == (target, n_layers - target) for c in counts)
    checks["dynamic: the predictor moves at every step with lr > 0"] = all(
        mv == (m["lr"] > 0) for mv, m in zip(moved, metrics))
    checks["dynamic: only the predictor changes"] = same_sums(
        before, checksums(params, lambda n: True))
    path = os.path.join(tmp, "image_score_predictor.safetensors")
    export_predictor_to_safetensors(state.predictor, path)
    loaded = load_predictor(path, "cuda", 8)
    same = all(torch.equal(a, b) for a, b in zip(
        state.predictor.parameters(), loaded.parameters()))
    tokens = []
    for p in (state.predictor, loaded):
        eng = QwenVLEngine(cfg, params, budget=0.2, device="cuda",
                           strategy=DynamicSelect(predictor=p))
        with torch.no_grad():
            tokens.append(eng.generate(input_ids, pixels, grid,
                                       max_new_tokens=1).tokens)
    print(f"[methods-dynamic] export reloaded bit-equal={same}; "
          f"DynamicSelect first token in memory {tokens[0]} reloaded "
          f"{tokens[1]}; step_wall_ms {walls!r}", flush=True)
    checks["dynamic export"] = same and tokens[0][:1] == tokens[1][:1]
    for p in params.parameters():
        p.requires_grad_(False)


def vit_remat():
    """``vit_mod._block`` under ``torch.utils.checkpoint`` (one block's
    activations live at a time in the backward) for the plain reference
    of 14e."""
    import torch.utils.checkpoint

    from visionselector_tpu_torch.models.qwen25vl import vit as vit_mod

    block = vit_mod._block
    return patched(vit_mod, "_block", lambda *a, **kw:
                   torch.utils.checkpoint.checkpoint(
                       block, *a, use_reentrant=False, **kw))


def methods_sft(cfg, params, checks):
    """14e: METHOD_STEPS full-LM SFT steps at B = 2 (phase 6's batch, lr
    5e-3): the loss falls, the ViT and the scorer bit-equal, the LM
    changed; peak memory. Then the ``--tune-mm-vision`` gradient of a
    window layer's q kernel on one sample against the same with every
    attention plain by autograd (TRAIN_GRAD_TOL), the kernel's output
    detached as the planted fault."""
    import numpy as np
    import torch

    from visionselector_tpu_torch.kernels import attention as A
    from visionselector_tpu_torch.models.qwen25vl import vit as vit_mod
    from visionselector_tpu_torch.train.data import stack_samples
    from visionselector_tpu_torch.train.loss import to_device
    from visionselector_tpu_torch.train.sft import (
        SFTScheduleConfig,
        init_sft_state,
        sft_batch_forward,
        sft_train_step,
    )

    host = train_batch(cfg)
    batch = to_device(host, "cuda")
    frozen = checksums(params, lambda n: not n.startswith("lm."))
    lm_before = checksums(params, lambda n: n.startswith("lm."))
    sched = SFTScheduleConfig(total_steps=METHOD_STEPS, lr=TRAIN_LR)
    state = init_sft_state(params, sched)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, walls = [], []
    for _ in range(METHOD_STEPS):
        (state, m), wall = timed_step(lambda: sft_train_step(
            state, params, batch, cfg, sched))
        losses.append(float(m["loss"]))
        walls.append(wall)
        print(f"[methods-sft] step {len(walls)}: " + " ".join(
            f"{k}={float(v)!r}" for k, v in m.items())
            + f" wall_ms={wall!r}", flush=True)
    peak = torch.cuda.max_memory_allocated()
    lm_after = checksums(params, lambda n: n.startswith("lm."))
    changed = sum(not torch.equal(lm_after[n], lm_before[n])
                  for n in lm_before)
    print(f"[methods-sft] 3B full-LM SFT B={TRAIN_BATCH} T={TRAIN_T_BUCKET}:"
          f" loss {losses!r} step_wall_ms {walls!r} max_memory_allocated="
          f"{peak}; LM tensors changed {changed} of {len(lm_before)}",
          flush=True)
    checks["sft loss falls"] = losses[-1] < losses[0]
    checks["sft: ViT and scorer bit-equal"] = same_sums(
        frozen, checksums(params, lambda n: not n.startswith("lm.")))
    checks["sft: the LM changed"] = changed == len(lm_before)
    del state
    torch.cuda.empty_cache()

    one = to_device(stack_samples([type(host)(*(
        np.asarray(x)[0] for x in host))]), "cuda")
    vis = SFTScheduleConfig(tune_mm_vision=True, tune_mm_llm=False)
    init_sft_state(params, vis)
    w = params.visual.blocks[0].qkv_kernel  # block 0: a window layer
    hp = w.shape[1] // 3

    def q_grad(attn_impl=None, remat=False):
        loss = sft_batch_forward(params, one, cfg, remat, attn_impl)[0]
        (g,) = torch.autograd.grad(loss.mean(), [w], allow_unused=True)
        return torch.zeros_like(w[:, :hp]) if g is None else g[:, :hp]

    n0 = A.DIAG_GRAD_LAUNCHES
    got = q_grad()
    launched = A.DIAG_GRAD_LAUNCHES - n0
    with patched(A, "FlashAttentionFn", PlainAutogradAttention), vit_remat():
        ref = q_grad("plain", remat=True)
    with patched(vit_mod, "attention_diag", detached_diag):
        bad = q_grad()
    err, fault = rel_err(got, ref), rel_err(bad, ref)
    n_window = cfg.vision.depth - len(cfg.vision.fullatt_block_indexes)
    print(f"[methods-sft] --tune-mm-vision, one sample: window block 0's "
          f"q-kernel gradient (kernels, FlashAttentionFn, {launched} K4 "
          f"launches under grad) against every attention plain by autograd:"
          f" rel_err={err!r} (limit {TRAIN_GRAD_TOL}); planted fault (K4's "
          f"output detached) {fault!r} (must exceed it)", flush=True)
    checks["sft --tune-mm-vision gradient"] = (
        err <= TRAIN_GRAD_TOL < fault and launched == n_window)
    for p in params.parameters():
        p.requires_grad_(False)
    torch.cuda.empty_cache()


def methods_lora(ov_cfg, ov_params, checks):
    """14f: LoRA SFT on OV-8B (rank 64, alpha 16, METHOD_STEPS steps on
    phase 12's batch, lr 5e-3): the base weights bit-equal, every adapter
    changed, step wall and peak memory; then the merged model's logits
    against the adapter model's (MERGE_TOL) and the first greedy token
    equal. The merge is in place: OV-8B is not used after this."""
    import torch

    from visionselector_tpu_torch.models.llava_ov15.model import OVEngine
    from visionselector_tpu_torch.train.loss import to_device
    from visionselector_tpu_torch.train.lora import (
        add_lora_params,
        lora_leaf,
        merge_lora_params,
    )
    from visionselector_tpu_torch.train.sft import (
        SFTScheduleConfig,
        forward_logits,
        init_sft_state,
        sft_train_step,
    )

    batch = to_device(ov_train_batch(ov_cfg), "cuda")
    base = checksums(ov_params, lambda n: True)
    add_lora_params(ov_params.lm, torch.Generator(device="cuda").manual_seed(
        SEED + 14), rank=LORA_RANK, alpha=LORA_ALPHA)
    sched = SFTScheduleConfig(total_steps=METHOD_STEPS, lr=TRAIN_LR,
                              lora_rank=LORA_RANK)
    state = init_sft_state(ov_params, sched)
    start = {n: p.detach().clone() for n, p in state.trainables.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, walls = [], []
    for _ in range(METHOD_STEPS):
        (state, m), wall = timed_step(lambda: sft_train_step(
            state, ov_params, batch, ov_cfg, sched))
        losses.append(float(m["loss"]))
        walls.append(wall)
    peak = torch.cuda.max_memory_allocated()
    moved = sum(not torch.equal(p, start[n])
                for n, p in state.trainables.items())
    n_adapters = sum(p.numel() for p in state.trainables.values())
    print(f"[methods-lora] OV-8B LoRA rank {LORA_RANK} alpha {LORA_ALPHA} "
          f"({len(start)} adapter tensors, {n_adapters} parameters) B="
          f"{TRAIN_BATCH} T={OV_TRAIN_T_BUCKET}: loss {losses!r} "
          f"step_wall_ms {walls!r} max_memory_allocated={peak}; adapters "
          f"changed {moved} of {len(start)}", flush=True)
    checks["lora: base bit-equal"] = same_sums(
        base, checksums(ov_params, lambda n: not lora_leaf(n)))
    checks["lora: only the adapters change"] = moved == len(start)
    del state, start
    for p in ov_params.parameters():
        p.requires_grad_(False)
    sample = type(batch)(*(x[0] for x in batch))
    n = int(sample.seg_ids.sum())
    req = ov_request(ov_cfg)
    eng = OVEngine(ov_cfg, ov_params, use_selector=False, device="cuda")
    with torch.no_grad():
        adapted = forward_logits(ov_params, sample, ov_cfg)[:n]
        tok_a = eng.generate(**req, max_new_tokens=1).tokens
        merge_lora_params(ov_params.lm)
        merged = forward_logits(ov_params, sample, ov_cfg)[:n]
        tok_m = eng.generate(**req, max_new_tokens=1).tokens
    diff = (merged - adapted).abs().max().item()
    scale = adapted.abs().max().item()
    left = sum(lora_leaf(n) for n, _ in ov_params.named_parameters())
    print(f"[methods-lora] merged model against the adapter model: max "
          f"|logit difference| {diff!r} of max |logit| {scale!r} (limit "
          f"{MERGE_TOL} of it) over {n} rows; first greedy token adapters "
          f"{tok_a} merged {tok_m}; adapters left {left}", flush=True)
    checks["lora merge"] = (diff <= MERGE_TOL * scale and left == 0
                            and tok_a[:1] == tok_m[:1])
    del adapted, merged, eng
    torch.cuda.empty_cache()


def methods_clis(tmp, procs):
    """14g: ``api.train --smoke`` on the card with ``--method dynamic``,
    ``--method sft --lora-rank 8`` and ``--async-save`` (3 steps each, in
    processes of their own beside the rest of the phase)."""
    runs = {"train_dynamic": (["--method", "dynamic"],
                              "image_score_predictor.safetensors"),
            "train_lora": (["--method", "sft", "--lora-rank", "8"],
                           "lora_merged/params.pt"),
            "train_async": (["--async-save"],
                            "importance_scorer.safetensors")}
    for key, (extra, _) in runs.items():
        start_cli(procs, tmp, "train", "--smoke", "--total-steps",
                  str(METHOD_STEPS), "--batch-size", "2", "--log-steps", "1",
                  "--output-dir", os.path.join(tmp, key), *extra, key=key)
    return runs


def methods_clis_done(tmp, procs, runs, checks):
    for key, (extra, export) in runs.items():
        rc, stdout, stderr, secs = finish_cli(procs, key)
        out = os.path.join(tmp, key)
        steps = []
        with contextlib.suppress(OSError), open(
                os.path.join(out, "train_log.jsonl")) as f:
            steps = [json.loads(ln)["step"] for ln in f]
        files = {name: os.path.isfile(os.path.join(out, name)) for name in (
            "train_log.jsonl", f"checkpoint-{METHOD_STEPS}/train_state.pt",
            export)}
        tail = (stdout.strip().splitlines()[-3:] if rc == 0
                else stderr[-2000:])
        print(f"[methods-cli] api.train --smoke {' '.join(extra)} (cuda): "
              f"rc={rc} in {secs!r} s files {files} {tail}", flush=True)
        checks[f"api.train {' '.join(extra)}"] = (
            rc == 0 and all(files.values())
            and steps == list(range(1, METHOD_STEPS + 1)))


def methods_phase_ov(ov_cfg, ov_params, tmp) -> dict:
    """Phase 14, part 1, while OV-8B is on the card: the CLIs start (14g),
    then 14f. Returns the state part 2 finishes."""
    t0 = time.perf_counter()
    print(f"[methods] card: {nvidia_smi()}", flush=True)
    part = dict(checks={}, procs={}, tmp=os.path.join(tmp, "methods"))
    os.makedirs(part["tmp"])
    part["runs"] = methods_clis(part["tmp"], part["procs"])
    part["pref"] = pref = pref_start(tmp)
    try:
        methods_lora(ov_cfg, ov_params, part["checks"])
        part["seconds"] = time.perf_counter() - t0
        t1 = time.perf_counter()
        pref_ov(ov_cfg, ov_params, pref["checks"])  # 15c
        pref["ov_seconds"] += time.perf_counter() - t1
    except BaseException:
        for proc, _, _ in part["procs"].values():
            proc.kill()
        pref_kill(pref)
        raise
    return part


def methods_phase(cfg, params, engine, input_ids, pixels, grid, part):
    """Phase 14, part 2 (OV-8B's weights dropped): 14a-14e, then the CLIs'
    results. Raises if any check of the phase failed; returns (the causal
    K1 launches of the last packed step, the kernels line's entry of K1
    on packed rows). 14e trains the 3B's LM in place, so it runs last."""
    import torch

    t0 = time.perf_counter()
    checks = part["checks"]
    try:
        entry = methods_packed_k1(cfg)
        methods_diag_grad(engine, input_ids, pixels, grid, checks)
        launches = methods_packed_train(cfg, params, checks)
        methods_dynamic(cfg, params, input_ids, pixels, grid, part["tmp"],
                        checks)
        methods_sft(cfg, params, checks)
        methods_clis_done(part["tmp"], part["procs"], part["runs"], checks)
    finally:
        for proc, _, _ in part["procs"].values():
            if proc.poll() is None:
                proc.kill()
    bad = [k for k, ok in checks.items() if not ok]
    print(f"[methods] checks: {checks}", flush=True)
    seconds = part["seconds"] + time.perf_counter() - t0
    print(f"[methods] phase seconds {seconds!r} (OV-8B part "
          f"{part['seconds']!r})", flush=True)
    torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"train-methods phase failed: {bad}")
    return launches, entry


PREF_STEPS = 3  # 3B DPO steps (15a)
GRPO_STEPS, GRPO_G, GRPO_LEN = 2, 4, 32  # 15b: steps, group, tokens
GRPO_BETA = 0.04
OV_DPO_STEPS = 2  # 15c
# "<|im_start|>assistant\n": the opener that starts a rollout on the chat
# template's assistant turn (the reference applies add_generation_prompt)
OPENER = [151644, 77091, 198]
# 15b: the first completion row's log-softmax from the training forward
# (uncompressed, T = 1,536) against the engine's prefill logits over the
# temperature. Both forwards take the same rows through the same kernels
# and bf16 GEMMs; the heads differ (the engine's GEMM on the bf16 weight
# with an fp32 output, the training head's on an fp32 copy) in the order
# of their fp32 sums of the same exact bf16 products. Rounding errors of
# random sign leave two such sums ~sqrt(K) 2^-24 sum_k |h_k w_kj| apart
# (K u sum |x| at worst), twice that after the log-softmax's normalizer;
# the check allows PREF_LOGP_MARGIN times that, and at most
# PREF_LOGP_ULPS bf16 ulps of the row's largest |log-prob|. Measured on
# an H100 (80GB HBM3, 700 W): the rows 1.5e-5 apart on fresh weights,
# 5.9e-5 on the trained ones; the vision run spliced one slot late moves
# them by 0.094 and 0.0095, which 4 bf16 ulps of the largest |log-prob|
# (0.5) and the worst-case fp32 bound (0.017) do not see.
PREF_LOGP_ULPS, PREF_LOGP_MARGIN = 4, 4


def pref_counts() -> dict:
    from visionselector_tpu_torch.kernels import attention as A

    return {"k1": A.FLASH_LAUNCHES, "k1_grad": A.FLASH_GRAD_LAUNCHES,
            "k1_causal": A.FLASH_CAUSAL_LAUNCHES, "k4": A.DIAG_LAUNCHES,
            "k4_grad": A.DIAG_GRAD_LAUNCHES, "k5": A.DECODE_LAUNCHES}


def pref_delta(before: dict) -> dict:
    return {k: v - before[k] for k, v in pref_counts().items()}


def pref_pair(cfg, build, s_bucket, t_bucket):
    """15a / 15c's pair: phase 6's image and 40 prompt ids; chosen is
    phase 6's first 32-id answer, rejected another seeded 32 ids."""
    import numpy as np

    from visionselector_tpu_torch.train.data import stack_samples
    from visionselector_tpu_torch.train.loss import to_device

    img = request_image()
    chosen = list(range(500, 500 + ANSWER_LEN))
    rejected = [int(t) for t in np.random.RandomState(SEED + 15).randint(
        1000, 100000, ANSWER_LEN)]
    return tuple(to_device(stack_samples([build(
        cfg, img, PROMPT_BEFORE, PROMPT_AFTER, ans, budget=0.2,
        s_bucket=s_bucket, t_bucket=t_bucket)]), "cuda")
        for ans in (chosen, rejected))


def pref_dpo(cfg, params, checks):
    """15a: 3B DPO of the whole decoder (phase 6's pair, sigmoid, beta
    0.1, PREF_STEPS steps at TRAIN_LR). First, at the starting weights, one
    decoder leaf's DPO gradient against every attention plain by autograd
    (TRAIN_GRAD_TOL; chosen and rejected swapped on the plain side as the
    planted fault). Then the steps: step 0's loss ln 2, the margin after
    the last step > 0, the reference copy bit-equal before and after, the
    ViT and scorer bit-equal, every decoder tensor changed, K1 / K4
    launches per step against the count the code implies, step wall and
    peak memory."""
    import math

    import torch

    from visionselector_tpu_torch.kernels import attention as A
    from visionselector_tpu_torch.train.data import build_train_sample
    from visionselector_tpu_torch.train.dpo import (
        DPOScheduleConfig,
        ReferencePolicy,
        dpo_pair_loss,
        dpo_train_step,
        init_dpo_state,
    )

    chosen, rejected = pref_pair(cfg, build_train_sample, TRAIN_S_BUCKET,
                                 TRAIN_T_BUCKET)
    sched = DPOScheduleConfig(total_steps=PREF_STEPS, lr=TRAIN_LR)
    frozen = checksums(params, lambda n: not n.startswith("lm."))
    lm_before = checksums(params, lambda n: n.startswith("lm."))
    state = init_dpo_state(params, sched)
    ref = ReferencePolicy(params, state)
    ref_before = tensor_checksums(ref.weights)
    w = params.lm.layers[len(params.lm.layers) // 2].q_kernel

    def leaf_grad(c, r, attn_impl=None):
        loss, _ = dpo_pair_loss(params, ref, c, r, sched, attn_impl)
        return torch.autograd.grad(loss, [w])[0]

    got = leaf_grad(chosen, rejected)
    with patched(A, "FlashAttentionFn", PlainAutogradAttention):
        want = leaf_grad(chosen, rejected, "plain")
        bad = leaf_grad(rejected, chosen, "plain")
    err, fault = rel_err(got, want), rel_err(bad, want)
    print(f"[pref-dpo] starting weights: the DPO gradient of a middle "
          f"layer's q kernel (kernels, FlashAttentionFn) against every "
          f"attention plain by autograd: rel_err={err!r} (limit "
          f"{TRAIN_GRAD_TOL}); planted fault (chosen and rejected swapped "
          f"on the plain side) {fault!r} (must exceed it)", flush=True)
    checks["dpo gradient against plain autograd"] = (
        err <= TRAIN_GRAD_TOL < fault)
    del got, want, bad
    torch.cuda.empty_cache()
    n_vit = 2 * 2  # reference and policy, chosen and rejected: one sample
    n_full = len(cfg.vision.fullatt_block_indexes)
    n_layers = cfg.text.num_hidden_layers
    implied = {"k1": n_vit * (n_full + n_layers), "k1_grad": 2 * n_layers,
               "k1_causal": n_vit * n_layers,
               "k4": n_vit * (cfg.vision.depth - n_full), "k4_grad": 0,
               "k5": 0}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    metrics, walls, counts = [], [], []
    for _ in range(PREF_STEPS):
        c0 = pref_counts()
        (state, m), wall = timed_step(lambda: dpo_train_step(
            state, ref, params, chosen, rejected, cfg, sched))
        counts.append(pref_delta(c0))
        metrics.append({k: float(v) for k, v in m.items()})
        walls.append(wall)
        print(f"[pref-dpo] step {len(walls)}: " + " ".join(
            f"{k}={v!r}" for k, v in metrics[-1].items())
            + f" wall_ms={wall!r} launches {counts[-1]}", flush=True)
    peak = torch.cuda.max_memory_allocated()
    with torch.no_grad():
        _, after = dpo_pair_loss(params, ref, chosen, rejected, sched)
    margin = float(after["reward_margin"])
    lm_after = checksums(params, lambda n: n.startswith("lm."))
    changed = sum(not torch.equal(lm_after[n], lm_before[n])
                  for n in lm_before)
    n_ref = sum(t.numel() for t in ref.weights.values())
    print(f"[pref-dpo] 3B full-decoder DPO T={TRAIN_T_BUCKET} (one pair, "
          f"beta {sched.beta}, lr {sched.lr}): step-0 loss "
          f"{metrics[0]['loss']!r} (ln 2 = {math.log(2)!r}), margin after "
          f"{PREF_STEPS} steps {margin!r}; step_wall_ms {walls!r} "
          f"max_memory_allocated={peak}; reference copy {len(ref.weights)} "
          f"tensors, {n_ref} elements; decoder tensors changed {changed} of "
          f"{len(lm_before)}; launches per step implied {implied}",
          flush=True)
    checks["dpo step-0 loss ln 2"] = abs(metrics[0]["loss"]
                                         - math.log(2)) <= 1e-3
    checks["dpo margin > 0 after the steps"] = margin > 0
    checks["dpo reference copy bit-equal"] = same_sums(
        ref_before, tensor_checksums(ref.weights))
    checks["dpo: ViT and scorer bit-equal"] = same_sums(
        frozen, checksums(params, lambda n: not n.startswith("lm.")))
    checks["dpo: every decoder tensor changed"] = changed == len(lm_before)
    checks["dpo launches per step"] = all(c == implied for c in counts)
    del state, ref
    for p in params.parameters():
        p.grad = None
        p.requires_grad_(False)
    torch.cuda.empty_cache()


def grpo_reward(tokens) -> float:
    """15b's synthetic reward: a position-weighted token checksum in [0,
    1), deterministic and varying across distinct completions."""
    return float(sum((i + 1) * int(t) for i, t in enumerate(tokens))
                 % 1009) / 1009


def first_row_logsoftmax(params, batch, row: int, temperature: float):
    """The training forward's (uncompressed, ``sft.batch_hidden``)
    log-softmax at ``row`` of sample 0, the logits over the temperature,
    with the training head's route."""
    import torch

    from visionselector_tpu_torch.models.qwen25vl import lm as lm_mod
    from visionselector_tpu_torch.train.sft import batch_hidden

    with torch.no_grad():
        hidden = batch_hidden(params, batch)
        logits = lm_mod.lm_head(params.lm, hidden[0, row:row + 1],
                                upcast=True)[0] / temperature
        return torch.log_softmax(logits, dim=-1)


def pref_grpo(cfg, params, checks):
    """15b: 3B GRPO of LoRA adapters (rank 64, alpha 16, beta 0.04, the
    grpo reduction, GRPO_STEPS steps at TRAIN_LR) on one prompt (the
    phase-3 image, its 40 ids and the assistant opener): GRPO_G rollouts
    of up to GRPO_LEN tokens at temperature 1 through
    ``QwenVLEngine(use_selector=False)`` with the adapters live; each
    equal to one-shot ``generate`` with its seed, at least 2 of them
    distinct, K5 launches 36 per decode step; the first completion row's
    log-softmax from the training forward against the engine's prefill
    logits over the temperature (PREF_LOGP_ULPS; the vision run spliced
    one slot late as the planted fault); step 0's KL exactly 0 and
    clip_ratio 0; the base weights bit-equal, every adapter B changed and
    every A unchanged after the two steps (A's gradient is zero while B
    is); rollout wall, step wall, peak memory. The adapters are merged
    into the decoder at the end."""
    import numpy as np
    import torch

    from visionselector_tpu_torch.models.qwen25vl.model import QwenVLEngine
    from visionselector_tpu_torch.preprocess.image import preprocess_image
    from visionselector_tpu_torch.preprocess.rope import (
        expand_vision_tokens,
        expand_vision_tokens_at_slots,
    )
    from visionselector_tpu_torch.train.data import stack_samples
    from visionselector_tpu_torch.train.dpo import ReferencePolicy
    from visionselector_tpu_torch.train.grpo import (
        GRPOScheduleConfig,
        build_grpo_sample,
        group_advantages,
        grpo_train_step,
        init_grpo_state,
        rollout_group,
    )
    from visionselector_tpu_torch.train.lora import (
        add_lora_params,
        lora_leaf,
        merge_lora_params,
    )
    from visionselector_tpu_torch.train.loss import to_device

    base = checksums(params, lambda n: True)
    add_lora_params(params.lm, torch.Generator(device="cuda").manual_seed(
        SEED + 15), rank=LORA_RANK, alpha=LORA_ALPHA)
    sched = GRPOScheduleConfig(
        total_steps=GRPO_STEPS, lr=TRAIN_LR, beta=GRPO_BETA,
        num_generations=GRPO_G, temperature=1.0,
        max_completion_length=GRPO_LEN, lora_rank=LORA_RANK)
    state = init_grpo_state(params, sched)
    ref = ReferencePolicy(params, state)
    start = {n: p.detach().clone() for n, p in state.trainables.items()}
    img = request_image()
    px, grid = preprocess_image(img)
    vc = cfg.vision
    raw = PROMPT_BEFORE + PROMPT_AFTER + OPENER
    slot = len(PROMPT_BEFORE)
    tok_kw = dict(spatial_merge_size=vc.spatial_merge_size,
                  image_token_id=cfg.image_token_id,
                  vision_start_token_id=cfg.vision_start_token_id,
                  vision_end_token_id=cfg.vision_end_token_id)
    ids = expand_vision_tokens_at_slots(raw, [slot], grid, **tok_kw)
    checks["grpo prompt = phase 3's ids + opener"] = list(ids) == list(
        expand_vision_tokens(PROMPT_BEFORE, PROMPT_AFTER, grid,
                             **tok_kw)) + OPENER
    engine = QwenVLEngine(cfg, params, use_selector=False, device="cuda")
    n_layers = cfg.text.num_hidden_layers
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rollout_walls, step_walls, k5_ok, metrics = [], [], [], []
    for step in range(GRPO_STEPS):
        c0 = pref_counts()
        comps, wall = timed_step(lambda: rollout_group(
            engine, ids, px, grid, sched, seed=step))
        rolled = pref_delta(c0)
        k5 = rolled["k5"]
        steps = sum(max(0, len(c) - (len(c) == GRPO_LEN)) for c in comps)
        k5_ok.append(k5 == n_layers * steps)
        rollout_walls.append(wall)
        rewards = [grpo_reward(c) for c in comps]
        adv = group_advantages(np.asarray(rewards), GRPO_G)
        batch = to_device(stack_samples([build_grpo_sample(
            cfg, [img], raw, [slot], c, budget=0.2,
            s_bucket=TRAIN_S_BUCKET, t_bucket=TRAIN_T_BUCKET)
            for c in comps]), "cuda")
        if step == 0:
            replay = [engine.generate(
                ids, px, grid, max_new_tokens=GRPO_LEN, temperature=1.0,
                seed=g).tokens for g in range(GRPO_G)]
            checks["grpo rollouts = one-shot generate"] = replay == [
                c.tolist() for c in comps]
            checks["grpo rollouts differ"] = len(
                {tuple(c.tolist()) for c in comps}) >= 2
            checks["grpo rewards vary"] = len(set(rewards)) >= 2
            logp_check(cfg, params, engine, ids, px, grid, img, raw, slot,
                       comps[0], batch, sched, checks)
        c0 = pref_counts()
        (state, m), wall = timed_step(lambda: grpo_train_step(
            state, ref, params, batch, torch.as_tensor(adv, device="cuda"),
            cfg, sched))
        trained = pref_delta(c0)
        step_walls.append(wall)
        metrics.append({k: float(v) for k, v in m.items()})
        print(f"[pref-grpo] step {step}: rollouts {[len(c) for c in comps]}"
              f" tokens, rewards {rewards!r}, {steps} decode steps, "
              f"launches {rolled}; " + " ".join(
                  f"{k}={v!r}" for k, v in metrics[-1].items())
              + f" rollout_wall_ms={rollout_walls[-1]!r} step_wall_ms="
              f"{wall!r} step launches {trained}", flush=True)
    peak = torch.cuda.max_memory_allocated()
    moved_b = sum(not torch.equal(p, start[n]) for n, p in
                  state.trainables.items() if n.endswith("_lora_b"))
    still_a = sum(torch.equal(p, start[n]) for n, p in
                  state.trainables.items() if n.endswith("_lora_a"))
    n_half = len(start) // 2
    print(f"[pref-grpo] 3B LoRA GRPO rank {LORA_RANK}, G={GRPO_G}, "
          f"{GRPO_LEN} tokens, T={TRAIN_T_BUCKET}: rollout_wall_ms "
          f"{rollout_walls!r} step_wall_ms {step_walls!r} "
          f"max_memory_allocated={peak}; adapter B changed {moved_b} of "
          f"{n_half}, A unchanged {still_a} of {n_half}", flush=True)
    checks["grpo K5 = 36 per decode step"] = all(k5_ok)
    checks["grpo step-0 KL 0 and clip_ratio 0"] = (
        metrics[0]["kl"] == 0.0 and metrics[0]["clip_ratio"] == 0.0)
    checks["grpo: base bit-equal"] = same_sums(
        base, checksums(params, lambda n: not lora_leaf(n)))
    checks["grpo: every B changed, every A unchanged"] = (
        moved_b == n_half and still_a == n_half)
    del state, ref, engine, start
    merge_lora_params(params.lm)  # 15a trains the merged decoder
    for p in params.parameters():
        p.grad = None
        p.requires_grad_(False)
    torch.cuda.empty_cache()


def logp_check(cfg, params, engine, ids, px, grid, img, raw, slot, comp,
               batch, sched, checks):
    """15b's "scored distribution = sampling distribution": the first
    completion row's log-softmax of the training forward against the
    engine prefill's, and ``per_token_logps`` at that row against both."""
    import math

    import torch

    from visionselector_tpu_torch.train.data import stack_samples
    from visionselector_tpu_torch.train.grpo import (
        build_grpo_sample,
        per_token_logps,
    )
    from visionselector_tpu_torch.train.loss import to_device

    state = engine.generate(ids, px, grid, max_new_tokens=GRPO_LEN,
                            temperature=sched.temperature, seed=0,
                            _defer_decode=True)
    want = torch.log_softmax(state.logits.float() / sched.temperature, -1)
    row = len(ids) - 1  # predicts the first completion token
    got = first_row_logsoftmax(params, batch, row, sched.temperature)
    sample = type(batch)(*(x[0] for x in batch))
    with torch.no_grad():
        lp, mask = per_token_logps(params, sample, cfg,
                                   temperature=sched.temperature)
    late = to_device(stack_samples([build_grpo_sample(
        cfg, [img], raw, [slot + 1], comp, budget=0.2,
        s_bucket=TRAIN_S_BUCKET, t_bucket=TRAIN_T_BUCKET)]), "cuda")
    bad = first_row_logsoftmax(params, late, row, sched.temperature)
    amax = want.abs().max().item()
    ulps = PREF_LOGP_ULPS * 2.0 ** (math.floor(math.log2(amax)) - 7)
    tol = min(ulps, head_rounding_tol(params, batch, row,
                                      sched.temperature))
    err = (got - want).abs().max().item()
    fault = (bad - want).abs().max().item()
    tok = int(comp[0])
    print(f"[pref-grpo] first completion token {tok}: log-prob "
          f"per_token_logps {lp[row].item()!r} (mask {bool(mask[row])}), "
          f"training forward {got[tok].item()!r}, engine prefill "
          f"{want[tok].item()!r}; whole row max |diff| {err!r} (limit "
          f"{tol!r}: the heads' fp32 rounding, within {ulps!r} = "
          f"{PREF_LOGP_ULPS} bf16 ulps of max |log-prob| {amax!r}); "
          f"planted fault (vision run one slot late) {fault!r} (must "
          f"exceed it)", flush=True)
    checks["grpo scored = sampled distribution"] = (
        err <= tol < fault and bool(mask[row])
        and abs(lp[row].item() - got[tok].item()) <= tol)


def head_rounding_tol(params, batch, row: int, temperature: float):
    """PREF_LOGP_MARGIN x 4 sqrt(K) 2^-24 max_j sum_k |h_k w_kj| /
    temperature at ``row`` of sample 0 (the training forward's hidden row
    h, the head's weight w, K its width): how far two fp32 sums of the
    same exact bf16 products land apart when their rounding errors have
    random signs (2 sqrt(K) u per logit), doubled for the log-softmax's
    normalizer."""
    import math

    import torch

    from visionselector_tpu_torch.train.sft import batch_hidden

    lm = params.lm
    w = lm.embed_tokens.t() if lm.cfg.tie_word_embeddings \
        else lm.lm_head_kernel
    with torch.no_grad():
        h = batch_hidden(params, batch)[0, row].float().abs()
        sums = (h[None] @ w.float().abs())[0]
    k = h.numel()
    return (PREF_LOGP_MARGIN * 4 * math.sqrt(k) * 2.0 ** -24
            * sums.max().item() / temperature)


def pref_ov(ov_cfg, ov_params, checks):
    """15c: OV-8B DPO of LoRA adapters (rank 64, alpha 16; one pair of
    phase 12's image at T = 2,048, OV_DPO_STEPS steps at TRAIN_LR): step
    0's loss ln 2, the base bit-equal, every adapter B changed; step wall
    and peak memory. Runs after 14f's merge, on the merged weights."""
    import math

    import torch

    from visionselector_tpu_torch.train.dpo import (
        DPOScheduleConfig,
        ReferencePolicy,
        dpo_train_step,
        init_dpo_state,
    )
    from visionselector_tpu_torch.train.lora import add_lora_params, lora_leaf
    from visionselector_tpu_torch.train.ov_loss import build_ov_train_sample

    chosen, rejected = pref_pair(ov_cfg, build_ov_train_sample, OV_BUCKET,
                                 OV_TRAIN_T_BUCKET)
    base = checksums(ov_params, lambda n: True)
    add_lora_params(ov_params.lm, torch.Generator(
        device="cuda").manual_seed(SEED + 16), rank=LORA_RANK,
        alpha=LORA_ALPHA)
    sched = DPOScheduleConfig(total_steps=OV_DPO_STEPS, lr=TRAIN_LR,
                              lora_rank=LORA_RANK)
    state = init_dpo_state(ov_params, sched)
    ref = ReferencePolicy(ov_params, state)
    start = {n: p.detach().clone() for n, p in state.trainables.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, walls = [], []
    for _ in range(OV_DPO_STEPS):
        (state, m), wall = timed_step(lambda: dpo_train_step(
            state, ref, ov_params, chosen, rejected, ov_cfg, sched))
        losses.append(float(m["loss"]))
        walls.append(wall)
    peak = torch.cuda.max_memory_allocated()
    moved_b = sum(not torch.equal(p, start[n]) for n, p in
                  state.trainables.items() if n.endswith("_lora_b"))
    print(f"[pref-ov] OV-8B LoRA DPO rank {LORA_RANK} T="
          f"{OV_TRAIN_T_BUCKET} (one pair): loss {losses!r} (ln 2 = "
          f"{math.log(2)!r}) step_wall_ms {walls!r} max_memory_allocated="
          f"{peak}; adapter B changed {moved_b} of {len(start) // 2}",
          flush=True)
    checks["ov dpo step-0 loss ln 2"] = abs(losses[0] - math.log(2)) <= 1e-3
    checks["ov dpo: base bit-equal"] = same_sums(
        base, checksums(ov_params, lambda n: not lora_leaf(n)))
    checks["ov dpo: every B changed"] = moved_b == len(start) // 2
    del state, ref, start
    for p in ov_params.parameters():
        p.grad = None
        p.requires_grad_(False)
    torch.cuda.empty_cache()


PREF_CLIS = {
    "pref_dpo": ["--method", "dpo"],
    "pref_dpo_ipo": ["--method", "dpo", "--grad-accum-steps", "2",
                     "--dpo-loss-type", "ipo"],
    "pref_grpo": ["--method", "grpo"],
    "pref_grpo_ov": ["--family", "llava_ov15", "--method", "grpo",
                     "--lora-rank", "8"],
}


def pref_cli_args(tmp, key):
    return ["--smoke", "--total-steps", str(METHOD_STEPS), "--batch-size",
            "2", "--log-steps", "1", "--output-dir", os.path.join(tmp, key),
            *PREF_CLIS[key]]


def pref_clis(tmp, procs):
    """15d: the four ``api.train --smoke`` runs, started in processes of
    their own beside the rest of the phase (3 steps each)."""
    for key in PREF_CLIS:
        start_cli(procs, tmp, "train", *pref_cli_args(tmp, key), key=key)


def pref_clis_first(tmp, procs, checks):
    """15d, after 15b: each run's log, checkpoint and (LoRA)
    ``lora_merged``; then the four start again, in parallel, beside 15a;
    each must resume at step 3 and take no step."""
    for key, extra in PREF_CLIS.items():
        rc, stdout, stderr, secs = finish_cli(procs, key)
        out = os.path.join(tmp, key)
        log = []
        with contextlib.suppress(OSError), open(
                os.path.join(out, "train_log.jsonl")) as f:
            log = [json.loads(ln) for ln in f]
        want = ["train_log.jsonl", f"checkpoint-{METHOD_STEPS}/train_state.pt"]
        if "--lora-rank" in extra:
            want.append("lora_merged/params.pt")
        files = {n: os.path.isfile(os.path.join(out, n)) for n in want}
        tail = (stdout.strip().splitlines()[-2:] if rc == 0
                else stderr[-2000:])
        keys = sorted(log[0]) if log else []
        print(f"[pref-cli] api.train --smoke {' '.join(extra)} (cuda): "
              f"rc={rc} in {secs!r} s files {files} log keys {keys} {tail}",
              flush=True)
        checks[f"api.train {' '.join(extra)}"] = (
            rc == 0 and all(files.values())
            and [m["step"] for m in log] == list(
                range(1, METHOD_STEPS + 1))
            and ("mean_reward" in log[0]) == ("grpo" in extra))
    for key in PREF_CLIS:
        start_cli(procs, tmp, "train", *pref_cli_args(tmp, key),
                  key=key + "_resume")


def pref_clis_done(tmp, procs, checks):
    """15d, at the phase's end: the resumed runs, then the data tools."""
    for key, extra in PREF_CLIS.items():
        rc, stdout, stderr, secs = finish_cli(procs, key + "_resume")
        with open(os.path.join(tmp, key, "train_log.jsonl")) as f:
            lines = len(f.readlines())
        ok = (rc == 0 and f"resumed at step {METHOD_STEPS}" in stdout
              and lines == METHOD_STEPS)
        print(f"[pref-cli] resume {' '.join(extra)}: rc={rc} in {secs!r} s "
              f"log lines {lines} resumed {ok}", flush=True)
        checks[f"resume {' '.join(extra)}"] = ok
    data_tools(tmp, checks)


def run_module(module, *args):
    """(return code, stdout) of ``python -m <module> args`` from the
    repo's root (120 s at most)."""
    proc = subprocess.run(
        [sys.executable, "-m", module, *args], capture_output=True,
        text=True, timeout=120,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    return proc.returncode, proc.stdout


def data_tools(tmp, checks):
    """15d's data tools on seeded files: ``train.check_data`` exits 0 on
    clean records and 1 on three broken ones (a missing image, empty
    conversations, a first turn from the assistant), printing each;
    ``train.prep_data filter`` splits by source; ``sample-merge`` keeps
    the sampled count and gives the same bytes for the same seed and
    other bytes for another."""
    import random

    d = os.path.join(tmp, "data_tools")
    os.makedirs(d)
    clean = [{"conversations": [{"from": "human", "value": f"q{i}"},
                                {"from": "gpt", "value": f"a{i}"}]}
             for i in range(5)]
    broken = clean + [
        {"image": "missing.png", "conversations": [
            {"from": "human", "value": "<image>x"}]},
        {"conversations": []},
        {"conversations": [{"from": "gpt", "value": "first"}]}]
    paths = {}
    for name, recs in (("clean", clean), ("broken", broken)):
        paths[name] = os.path.join(d, f"{name}.jsonl")
        with open(paths[name], "w") as f:
            f.write("\n".join(json.dumps(r) for r in recs) + "\n")
    rc0, out0 = run_module("visionselector_tpu_torch.train.check_data",
                           "--annotation", paths["clean"], "--image-root", d)
    rc1, out1 = run_module("visionselector_tpu_torch.train.check_data",
                           "--annotation", paths["broken"], "--image-root", d)
    rng = random.Random(SEED)
    src = os.path.join(d, "all.jsonl")
    with open(src, "w") as f:
        for i in range(200):
            source = rng.choice(["coco", "ocr_vqa", "misc"])
            f.write(json.dumps({"id": i, "image": f"{source}/{i}.jpg"})
                    + "\n")
    rcf, outf = run_module("visionselector_tpu_torch.train.prep_data",
                           "filter", "--input", src, "--output-dir",
                           os.path.join(d, "split"), "--datasets",
                           "coco,ocr_vqa")
    merged = {}
    for tag, seed in (("a", 42), ("b", 42), ("c", 7)):
        out = os.path.join(d, f"merged_{tag}.jsonl")
        rc, _ = run_module("visionselector_tpu_torch.train.prep_data",
                           "sample-merge", "--inputs",
                           f"{src}:0.3,{paths['clean']}:1.0", "--output",
                           out, "--seed", str(seed))
        with open(out, "rb") as f:
            merged[tag] = (rc, f.read())
    counts = json.loads(outf) if rcf == 0 else {}
    n_merged = len(merged["a"][1].splitlines())
    print(f"[pref-data] check_data clean rc={rc0} ({out0.strip()!r}), "
          f"broken rc={rc1} ({out1.strip().splitlines()!r}); prep_data "
          f"filter rc={rcf} {counts}; sample-merge {n_merged} lines, seed "
          f"42 twice equal {merged['a'] == merged['b']}, seed 7 differs "
          f"{merged['a'][1] != merged['c'][1]}", flush=True)
    checks["check_data"] = (rc0 == 0 and rc1 == 1
                            and len(out1.strip().splitlines()) == 4)
    checks["prep_data"] = (
        rcf == 0 and sum(counts.values()) > 0
        and all(r == 0 for r, _ in merged.values())
        and n_merged == 60 + len(clean) and merged["a"] == merged["b"]
        and merged["a"][1] != merged["c"][1])


def pref_start(tmp) -> dict:
    """Phase 15, part 1 (while OV-8B is on the card, beside phase 14's
    CLIs): the CLIs start (15d). Returns the phase's state."""
    t0 = time.perf_counter()
    pref = dict(checks={}, procs={}, tmp=os.path.join(tmp, "preference"))
    os.makedirs(pref["tmp"])
    pref_clis(pref["tmp"], pref["procs"])
    pref["ov_seconds"] = time.perf_counter() - t0  # grows with 15c
    return pref


def pref_kill(pref):
    for proc, _, _ in pref["procs"].values():
        if proc.poll() is None:
            proc.kill()


def preference_phase(cfg, params, pref):
    """Phase 15, part 2 (after phase 14, which needs the 3B's weights as
    they were): 15b (adapters on phase 14e's decoder, merged into it at
    the end), the CLIs' first runs, 15a (the decoder trained in place),
    the resumed CLIs and the data tools. Raises if any check of the phase
    failed."""
    import torch

    t0 = time.perf_counter()
    print(f"[pref] card: {nvidia_smi()}", flush=True)
    checks = pref["checks"]
    try:
        pref_grpo(cfg, params, checks)
        pref_clis_first(pref["tmp"], pref["procs"], checks)
        pref_dpo(cfg, params, checks)
        pref_clis_done(pref["tmp"], pref["procs"], checks)
    finally:
        pref_kill(pref)
    bad = [k for k, ok in checks.items() if not ok]
    print(f"[pref] checks: {checks}", flush=True)
    seconds = pref["ov_seconds"] + time.perf_counter() - t0
    print(f"[pref] phase seconds {seconds!r} (OV-8B part "
          f"{pref['ov_seconds']!r})", flush=True)
    torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"preference phase failed: {bad}")


# Phase 16 (quantize): weight-only LM quantization (``--quantize``). The
# decoder's seven matmul kernels as int8 or packed int4 with per-channel or
# grouped fp32 scales (``lm.apply_weight_quantization``); decode rows (at
# most ``WQ_MAX_ROWS[dtype]``) take the hand-written weight-only GEMM
# (kernel A, ``csrc/wq_matmul_fwd.cu``), prefill rows the dequantize kernel
# (kernel B, same source) and ``torch.matmul``.
QUANT_SPECS = ("int8", "int4", "int4:g128")
# Rows checked at every shape; rows timed: one (the kernels line, every
# shape) and 16 / 32 / 64 (the 3B's shapes, which set WQ_MAX_ROWS per
# format).
WQ_ROWS = (1, 8, 16, 32, 48, 64)
WQ_CAP_ROWS = (16, 32, 64)
WQ_ENTRY = {"int8": "wq_matmul_fwd", "int4": "wq_matmul_fwd_int4",
            "int4:g128": "wq_matmul_fwd_int4_g128"}
QUANT_NEW_TOKENS = 32
QUANT_PROFILE_STEPS = 8
QUANT_SERVE_REQUESTS = 6


def lm_kernel_shapes(text_cfg) -> dict:
    """(in, out) of each of a decoder layer's seven matmul kernels."""
    d, i = text_cfg.hidden_size, text_cfg.intermediate_size
    hq = text_cfg.num_attention_heads * text_cfg.head_dim
    hkv = text_cfg.num_key_value_heads * text_cfg.head_dim
    return {"q_kernel": (d, hq), "k_kernel": (d, hkv), "v_kernel": (d, hkv),
            "o_kernel": (hq, d), "gate_kernel": (d, i), "up_kernel": (d, i),
            "down_kernel": (i, d)}


def wq_weight(spec, k, n, gen):
    """Random stored weight and fp32 scales of ``spec`` at [k, n]."""
    import torch

    from visionselector_tpu_torch.models.qwen25vl.lm import (
        pack_int4,
        parse_quantize_spec,
    )

    bits, group = parse_quantize_spec(spec)
    qmax = 127 if bits == 8 else 7
    q = torch.randint(-qmax, qmax + 1, (k, n), generator=gen, device="cuda",
                      dtype=torch.int8)
    s = torch.rand((k // group, n) if group else (n,), generator=gen,
                   device="cuda") * 2e-3 + 1e-4
    return (pack_int4(q) if bits == 4 else q), s


def wq_library(w, s):
    """One PyTorch call computing the same product, timed beside the
    kernel and used nowhere in the port: ``torch._weight_int8pack_mm``
    (x @ q^T [N, K] int8 times bf16 scales) for int8, and tinygemm's
    ``torch._weight_int4pack_mm`` for int4 (the ints stored as q + 8 with
    zero points 0, packed by ``_convert_weight_to_int4pack``: byte k / 2 of
    a row holds k's nibble high and k + 1's low; per-channel scales
    repeated over groups of 128, its largest group that divides both
    models' widths). Returns x -> y."""
    import torch

    from visionselector_tpu_torch.kernels import wq_matmul as wq

    q = wq.weight_ints(w)
    if w.dtype == torch.int8:
        qt, sb = q.t().contiguous(), s.to(torch.bfloat16)
        return lambda x: torch._weight_int8pack_mm(x, qt, sb)
    k, n = q.shape
    u = q.t().to(torch.int32) + 8
    packed = torch._convert_weight_to_int4pack(
        ((u[:, ::2] << 4) | u[:, 1::2]).to(torch.uint8).contiguous(), 8)
    group = k // s.shape[0] if s.dim() == 2 else 128
    sg = s if s.dim() == 2 else s[None].expand(k // group, n)
    sz = torch.stack([sg, torch.zeros_like(sg)], -1).to(
        torch.bfloat16).contiguous()
    return lambda x: torch._weight_int4pack_mm(x, packed, group, sz)


def wq_build_report():
    """Kernel A's and B's instantiations with their ptxas lines
    (registers, stack, spills)."""
    for kname, usage in ptxas_report("vst_wq").items():
        m = re.search(r"(wq_\w+?_kernel)I(.*?)EEv", kname)
        args = ",".join(re.findall(r"L[ib](\d+)E", m.group(2))) if m else ""
        print(f"[quant-kernel] ptxas {m.group(1) if m else kname}<{args}>: "
              f"{usage}", flush=True)


def quant_kernels(cfg, ov_cfg, out_dir, checks) -> dict:
    """16(a). Kernel A against ``wq_matmul_plain`` at the seven kernel
    shapes of the 3B, of OV-8B and of the 7B (phase 17's model: K / N up
    to 18,944; int4:g128 on K = 18,944 is 148 groups), and of one rank of
    the 3B and of the 7B under phase 18's tensor parallelism (``_tp2``:
    the 3B's k / v at N = 128, one kv head), rows 1 / 8 / 16 / 32 / 48 /
    64, each spec; its plan per shape (every whole model's at least
    ``WQ_SMS`` blocks); four planted faults.
    Kernel B bit-equal to ``wq.dequantize`` at every shape and spec. Per
    shape at one row: kernel A's ms, its bound, the dequantize route's ms,
    the library call's (``wq_library``, held to the plain version as the
    kernel is), a bf16 ``torch.mm`` on an unquantized weight of the shape
    (the yardstick); at the 3B's and the 7B's shapes the same products at
    16, 32 and 64 rows (the 3B's set ``WQ_MAX_ROWS``), and kernel B's ms
    beside its bound and the plain dequantize's. Returns the kernels line's
    entries: per spec, the 3B decoder layer's seven products at one row (a
    decode step at batch 1), summed, the 7B's (``_7b``) and a tp-2 rank's
    of the 3B (``_tp2``); kernel B as each layer's seven int8
    transients."""
    import torch

    from visionselector_tpu_torch.core.config import qwen25vl_7b
    from visionselector_tpu_torch.kernels import wq_matmul as wq
    from visionselector_tpu_torch.models.qwen25vl.lm import (
        parse_quantize_spec,
        tp_text_config,
    )

    wq_build_report()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 16)
    rows_out = []
    entries = {}
    worst = lib_worst = 0.0
    deq_equal = True
    least_blocks = None
    models = (("3b", lm_kernel_shapes(cfg.text)),
              ("ov8b", lm_kernel_shapes(ov_cfg.text)),
              ("7b", lm_kernel_shapes(qwen25vl_7b().text)),
              # a rank's slices under phase 18's tensor parallelism
              ("3b_tp2", lm_kernel_shapes(tp_text_config(cfg.text,
                                                         TP_WORLD))),
              ("7b_tp2", lm_kernel_shapes(tp_text_config(
                  qwen25vl_7b().text, TP_WORLD))))
    # model -> its entries' suffix
    summed = {"3b": "", "7b": "_7b", "3b_tp2": "_tp2"}
    for spec in QUANT_SPECS:
        bits, group = parse_quantize_spec(spec)
        # each summed layer's seven products per timed row count, kernel B
        ats = {model: {m: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0,
                               library_ms=0.0, mm_ms=0.0, err=0.0)
                       for m in (1,) + WQ_CAP_ROWS} for model in summed}
        deqs = {model: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0,
                            library_ms=0.0) for model in summed}
        for model, shapes in models:
            at, deq = ats.get(model), deqs.get(model)
            for (k, n), names in _group_shapes(shapes).items():
                w, s = wq_weight(spec, k, n, gen)
                c = len(names)
                tag = f"{spec} {model} {'/'.join(names)} K={k} N={n}"
                plan = wq.wq_plan(1, k, n, bits, group)
                if not model.endswith("_tp2"):  # the whole models' rule
                    least_blocks = min(least_blocks or plan.blocks,
                                       plan.blocks)
                print(f"[quant-kernel] plan {tag}: {plan.blocks} blocks = "
                      f"{plan.tiles} column tiles of {plan.col_tile} x "
                      f"{plan.splits} K splits of {plan.split_rows} rows, "
                      f"{plan.stages} stages, {plan.smem} bytes of shared "
                      f"memory at one row ({wq.wq_plan(64, k, n, bits, group).smem}"
                      f" at 64)", flush=True)
                dense = torch.randn(k, n, generator=gen, device="cuda",
                                    dtype=torch.bfloat16)
                library = wq_library(w, s)
                got = wq.wq_dequant(w, s, torch.bfloat16)
                same = torch.equal(got, wq.dequantize(w, s, torch.bfloat16))
                deq_equal &= same
                line = f"{tag} kernel B: bit-equal {same}"
                if model in summed:
                    ms = cuda_ms(lambda: wq.wq_dequant(w, s, torch.bfloat16))
                    plain_ms = cuda_ms(
                        lambda: wq.dequantize(w, s, torch.bfloat16), n=3)
                    bound, _ = bound_ms(wq.dequant_bytes(w, s), 0)
                    lib_ms = (cuda_ms(lambda: w.to(torch.bfloat16))
                              if bits == 8 else None)
                    line += (f", {ms!r} ms, bound {bound!r} ms, plain "
                             f"dequantize {plain_ms!r} ms, library "
                             f"{lib_ms!r} ms")
                    deq["ms"] += ms * c
                    deq["plain_ms"] += plain_ms * c
                    deq["bound_ms"] += bound * c
                    deq["library_ms"] = (None if lib_ms is None
                                         else deq["library_ms"] + lib_ms * c)
                rows_out.append(line)
                del got
                for m in WQ_ROWS:
                    x = torch.randn(m, k, generator=gen, device="cuda",
                                    dtype=torch.bfloat16)
                    got = wq.wq_matmul(x, w, s)
                    want = wq.wq_matmul_plain(x, w, s)
                    ulp = bf16_ulp_err(got, want)
                    err = (got.float() - want.float()).abs().max().item()
                    worst = max(worst, ulp)
                    line = f"{tag} M={m}: err {err!r} ({ulp!r} ulp)"
                    if m == 1 or (model in summed and m in at):
                        lib_ulp = bf16_ulp_err(library(x), want)
                        lib_worst = max(lib_worst, lib_ulp)
                        ms = cuda_ms(lambda: wq.wq_matmul(x, w, s))
                        plain_ms = cuda_ms(
                            lambda: wq.wq_dequant_matmul(x, w, s))
                        lib_ms = cuda_ms(lambda: library(x))
                        mm_ms = cuda_ms(lambda: torch.mm(x, dense))
                        bound, by = bound_ms(wq.bytes_moved(m, w, s),
                                             2 * m * k * n)
                        line += (f", kernel {ms!r} ms, bound {bound!r} ms "
                                 f"({by}), dequant+matmul {plain_ms!r} ms, "
                                 f"library {lib_ms!r} ms ({lib_ulp!r} ulp),"
                                 f" bf16 torch.mm {mm_ms!r} ms")
                        if model in summed:
                            a = at[m]
                            a["ms"] += ms * c
                            a["plain_ms"] += plain_ms * c
                            a["bound_ms"] += bound * c
                            a["library_ms"] += lib_ms * c
                            a["mm_ms"] += mm_ms * c
                            a["err"] = max(a["err"], err)
                    rows_out.append(line)
                del w, s, dense, library
        cap = wq.WQ_MAX_ROWS[torch.uint8 if bits == 4 else torch.int8]
        for model, sfx in summed.items():
            at, deq, one = ats[model], deqs[model], ats[model][1]
            entries[WQ_ENTRY[spec] + sfx] = {
                "max_abs_err": one["err"], "ms": one["ms"],
                "plain_ms": one["plain_ms"], "bound_ms": one["bound_ms"],
                "bound_by": "bytes", "library_ms": one["library_ms"]}
            if bits == 8:
                entries["wq_dequant_fwd" + sfx] = {
                    "max_abs_err": 0.0 if deq_equal else float("nan"),
                    "ms": deq["ms"], "plain_ms": deq["plain_ms"],
                    "bound_ms": deq["bound_ms"], "bound_by": "bytes",
                    "library_ms": deq["library_ms"]}
            name = model.upper()
            for m, a in at.items():
                print(f"[quant-kernel] {spec}: the {name} layer's seven "
                      f"products at M={m}: kernel {a['ms']!r} ms, bound "
                      f"{a['bound_ms']!r} ms, dequant+matmul "
                      f"{a['plain_ms']!r} ms, library {a['library_ms']!r} "
                      f"ms, bf16 torch.mm {a['mm_ms']!r} ms, max_abs_err "
                      f"{a['err']!r} (WQ_MAX_ROWS {cap})", flush=True)
            print(f"[quant-kernel] {spec}: the {name} layer's seven kernel-B"
                  f" transients {deq['ms']!r} ms, bound {deq['bound_ms']!r} "
                  f"ms, plain dequantize {deq['plain_ms']!r} ms, library "
                  f"{deq['library_ms']!r} ms", flush=True)
    with open(os.path.join(out_dir, "quant_kernels.txt"), "w") as f:
        f.write("\n".join(rows_out) + "\n")
    print(f"[quant-kernel] {len(rows_out)} cases (chiprun_out/"
          f"quant_kernels.txt), worst {worst!r} bf16 ulps; library calls "
          f"worst {lib_worst!r}; kernel B bit-equal {deq_equal}; fewest "
          f"blocks at one row {least_blocks}", flush=True)
    checks[f"kernel within {ULP_LIMIT} ulps at every shape"] = (
        worst <= ULP_LIMIT)
    checks[f"library calls within {ULP_LIMIT} ulps (the same product)"] = (
        lib_worst <= ULP_LIMIT)
    checks["kernel B bit-equal to dequantize at every shape"] = deq_equal
    checks[f"every plan launches at least {wq.WQ_SMS} blocks"] = (
        least_blocks >= wq.WQ_SMS)
    # Planted faults at the 3B's gate shape, 8 rows (two K splits): each
    # must fail the same check.
    k, n = lm_kernel_shapes(cfg.text)["gate_kernel"]
    x = torch.randn(8, k, generator=gen, device="cuda", dtype=torch.bfloat16)
    for spec, fault, what in (("int8", 1, "last 16 k rows skipped"),
                              ("int4", 2, "int4 nibbles swapped"),
                              ("int4:g128", 3, "next group's scale"),
                              ("int8", 4, "a K split's partial dropped")):
        w, s = wq_weight(spec, k, n, gen)
        err = bf16_ulp_err(wq._launch(x, w, s, fault=fault),
                           wq.wq_matmul_plain(x, w, s))
        print(f"[quant-kernel] planted fault ({what}, {spec}): {err!r} "
              f"ulps", flush=True)
        checks[f"fault caught: {what}"] = err > ULP_LIMIT
    return entries


def _group_shapes(shapes) -> dict:
    """(in, out) -> the kernel names of that shape."""
    out = {}
    for name, shape in shapes.items():
        out.setdefault(shape, []).append(name[:-len("_kernel")])
    return out


def lm_bytes(lm) -> int:
    return sum(t.nbytes for t in list(lm.parameters()) + list(lm.buffers()))


def save_lm_kernels(lm) -> dict:
    """Host copies of the decoder's float matmul kernels."""
    from visionselector_tpu_torch.models.qwen25vl.lm import QUANT_KERNELS

    return {(i, name): getattr(layer, name).detach().to("cpu")
            for i, layer in enumerate(lm.layers) for name in QUANT_KERNELS}


def restore_lm_kernels(lm, saved) -> None:
    """Put the float kernels of ``save_lm_kernels`` back in place of the
    quantized buffers."""
    import torch

    for (i, name), w in saved.items():
        layer = lm.layers[i]
        layer._buffers.pop(name, None)
        layer._buffers.pop(name + "_scale", None)
        layer.register_parameter(name, torch.nn.Parameter(
            w.to("cuda"), requires_grad=False))


def quant_decode_ms(eng, req, out_dir, tag) -> tuple:
    """(prefill device ms, decode device ms per token): a traced prefill
    (one token), and a traced QUANT_PROFILE_STEPS-step run less it, over
    the steps."""
    n_new = 1 + QUANT_PROFILE_STEPS
    pre, _, _ = traced(lambda: eng.generate(**req, max_new_tokens=1),
                       os.path.join(out_dir, f"profile_quant_{tag}_pre.json"))
    busy, _, res = traced(
        lambda: eng.generate(**req, max_new_tokens=n_new,
                             eos_token_ids=(-1,)),
        os.path.join(out_dir, f"profile_quant_{tag}_decode.json"))
    return pre, (busy - pre) / max(len(res.tokens) - 1, 1)


def quant_teacher_step(lm, state) -> tuple:
    """A teacher-forced decode step from a deferred prefill on copies of
    its cache: (logits on the kernel route, on the dequantize route)."""
    import dataclasses

    import torch

    from visionselector_tpu_torch.kernels import wq_matmul as wq
    from visionselector_tpu_torch.models.qwen25vl import lm as L

    cur = torch.tensor([state.next_token], device="cuda")
    pos = torch.tensor([state.start_pos], device="cuda")
    out = []
    for caps in (wq.WQ_MAX_ROWS, {}):
        cache = dataclasses.replace(
            state.cache, k=state.cache.k.clone(), v=state.cache.v.clone(),
            length=state.cache.length.clone())
        with patched(wq, "WQ_MAX_ROWS", caps):
            hidden, _ = L.lm_decode_step(
                lm, cache, L.embed_tokens(lm, cur)[:, None],
                pos[None, :, None].expand(3, 1, 1))
        out.append(L.lm_head(lm, hidden[:, 0])[0])
        del cache
    return out


def quant_request_checks(eng, plain, req, checks, tag, n_layers,
                         new_tokens=QUANT_NEW_TOKENS):
    """One quantized engine's request: launches (kernel A 7 x layers per
    decode step, the dequantize route and kernel B 7 x layers per
    prefill), peak memory, first token and prefill logits against the
    plain routes (attention and products), a teacher-forced decode step's
    kernel route against its dequantize route. Returns (result, peak
    bytes, kernel A launches, kernel B launches)."""
    import torch

    from visionselector_tpu_torch.kernels import attention as A
    from visionselector_tpu_torch.kernels import wq_matmul as wq

    zero_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res = eng.generate(**req, max_new_tokens=new_tokens, eos_token_ids=(-1,))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches, dequant = wq.WQ_LAUNCHES, wq.WQ_DEQUANT_CALLS
    dequant_launches = wq.WQ_DEQUANT_LAUNCHES
    steps = A.DECODE_LAUNCHES // n_layers
    per = 7 * n_layers
    checks[f"{tag}: kernel launches {per} x decode steps"] = (
        launches == per * steps and steps == len(res.tokens) - 1)
    checks[f"{tag}: dequantize route {per} per prefill"] = dequant == per
    checks[f"{tag}: dequantize kernel {per} launches per prefill"] = (
        dequant_launches == per)
    with patched(wq, "WQ_MAX_ROWS", {}):
        res_p = plain.generate(**req, max_new_tokens=1)
    diff = (res_p.logits - res.logits).abs().max().item()
    scale = res.logits.abs().max().item()
    overlap = 1.0
    if res.selected_indices is not None:
        a = set(res.selected_indices.tolist())
        overlap = len(a & set(res_p.selected_indices.tolist())) / len(a)
    state = eng.generate(**req, max_new_tokens=4, eos_token_ids=(-1,),
                         _defer_decode=True)
    kern, deq = quant_teacher_step(eng.params.lm, state)
    step_rel = ((kern - deq).abs().max() / deq.abs().max()).item()
    print(f"[quant] {tag}: {len(res.tokens)} tokens, kernel launches "
          f"{launches} ({steps} decode steps), dequantize-route calls "
          f"{dequant} (kernel B launches {dequant_launches}); first token "
          f"{res.tokens[0]} plain routes "
          f"{res_p.tokens[0]}; prefill logits max_abs_diff {diff!r} (max "
          f"|logit| {scale!r}), selected overlap {overlap!r}; teacher-"
          f"forced step kernel vs dequantize route max|diff|/max|logit| "
          f"{step_rel!r} (argmax {int(kern.argmax())} / "
          f"{int(deq.argmax())}); peak {peak} bytes", flush=True)
    # phase 3's rule for the kernel and plain paths
    checks[f"{tag}: kernel and plain routes agree"] = (
        overlap >= 0.9 if res.selected_indices is not None
        else diff <= 0.1 * scale)
    checks[f"{tag}: decode step, kernel vs dequantize route"] = (
        step_rel <= TEACHER_TOL)
    checks[f"{tag}: finite logits"] = bool(torch.isfinite(res.logits).all())
    return res, peak, launches, dequant_launches


def quant_3b(cfg, params, input_ids, pixels, grid, out_dir, checks) -> dict:
    """16(b) and (c): the 3B at full width, phase 3's request at selector
    0.2, under bf16, then int8, int4 and int4:g128 (each quantized in place
    from the bf16 kernels, put back from host copies in between); then the
    batcher over int4:g128. Returns kernel A's launches per spec and kernel
    B's (``wq_dequant_fwd``) of the int8 request."""
    import torch

    from visionselector_tpu_torch.models.qwen25vl import lm as L
    from visionselector_tpu_torch.models.qwen25vl.model import QwenVLEngine

    n_layers = cfg.text.num_hidden_layers
    req = dict(input_ids=input_ids, pixel_values=pixels, grid_thw=grid)

    def engines():
        return (QwenVLEngine(cfg, params, use_selector=True, budget=0.2,
                             device="cuda"),
                QwenVLEngine(cfg, params, use_selector=True, budget=0.2,
                             device="cuda", attn_impl="plain"))

    eng, _ = engines()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = eng.generate(**req, max_new_tokens=QUANT_NEW_TOKENS,
                        eos_token_ids=(-1,))
    torch.cuda.synchronize()
    base_peak = torch.cuda.max_memory_allocated()
    base_pre, base_ms = quant_decode_ms(eng, req, out_dir, "3b_bf16")
    base_bytes = lm_bytes(params.lm)
    print(f"[quant] 3B bf16: first token {base.tokens[0]}, LM bytes "
          f"{base_bytes}, peak {base_peak} bytes, prefill device ms "
          f"{base_pre!r}, decode device ms per token {base_ms!r}",
          flush=True)
    saved = save_lm_kernels(params.lm)
    launches = {}
    try:
        for spec in QUANT_SPECS:
            restore_lm_kernels(params.lm, saved)
            torch.cuda.empty_cache()
            L.apply_weight_quantization(params, spec)
            torch.cuda.empty_cache()
            eng, plain = engines()
            res, peak, launches[WQ_ENTRY[spec]], dequant = (
                quant_request_checks(eng, plain, req, checks, f"3B {spec}",
                                     n_layers))
            if spec == "int8":
                launches["wq_dequant_fwd"] = dequant
            pre, ms = quant_decode_ms(eng, req, out_dir, f"3b_{spec}")
            rel = ((res.logits - base.logits).abs().max()
                   / base.logits.abs().max()).item()
            print(f"[quant] 3B {spec}: LM bytes {lm_bytes(params.lm)} (bf16 "
                  f"{base_bytes}); peak {peak} bytes (bf16 {base_peak}); "
                  f"prefill device ms {pre!r} (bf16 {base_pre!r}); decode "
                  f"device ms per token {ms!r} (bf16 {base_ms!r}); "
                  f"prefill logits against bf16: max|diff|/max|logit| "
                  f"{rel!r}, first token {res.tokens[0]} (bf16 "
                  f"{base.tokens[0]})", flush=True)
            del eng, plain
        quant_serving(cfg, params, input_ids, pixels, grid, checks)
    finally:
        restore_lm_kernels(params.lm, saved)
        del saved
        torch.cuda.empty_cache()
    return launches


def quant_serving(cfg, params, input_ids, pixels, grid, checks):
    """16(c): ``ContinuousBatcher(n_slots=8)`` over the int4:g128 3B, six
    of phase 5's greedy requests on a bf16 and an int8 pool: each first
    token equals its one-shot ``generate``'s."""
    from visionselector_tpu_torch.kernels import wq_matmul as wq
    from visionselector_tpu_torch.models.qwen25vl.continuous import (
        ContinuousBatcher,
    )
    from visionselector_tpu_torch.models.qwen25vl.model import QwenVLEngine

    eng = QwenVLEngine(cfg, params, use_selector=True, budget=0.2,
                       device="cuda")
    traffic = [(e, r, m, dict(eos_token_ids=(-1,)), d)
               for e, r, m, kw, d in serve_traffic(cfg, input_ids, pixels,
                                                   grid)
               if e == "selector" and not kw][:QUANT_SERVE_REQUESTS]
    want = [eng.generate(**r, max_new_tokens=1).tokens[0]
            for _, r, _, _, _ in traffic]
    for pool in (None, "int8"):
        w0 = wq.WQ_LAUNCHES
        bat = ContinuousBatcher(eng, n_slots=POOL_SLOTS, t_max=POOL_ROWS,
                                chunk=8, kv_quant=pool)
        res, wall = run_batcher(bat, traffic)
        first = [r.tokens[0] for r in res]
        print(f"[quant-serve] int4:g128 3B, {pool or 'bf16'} pool: "
              f"{len(res)} requests in {wall!r} s, first tokens {first} "
              f"(one-shot {want}), kernel launches {wq.WQ_LAUNCHES - w0}, "
              f"stats {bat.stats}", flush=True)
        checks[f"serve {pool or 'bf16'} pool: first tokens = one-shot"] = (
            first == want and all(len(r.tokens) == m for r, (_, _, m, _, _)
                                  in zip(res, traffic)))
        checks[f"serve {pool or 'bf16'} pool: kernel launched"] = (
            wq.WQ_LAUNCHES > w0)


def quant_ov(ov_cfg, ov_params, ov_hf, out_dir, tmp) -> dict:
    """16(d), while OV-8B is on the card (its weights are dropped after):
    phase 11's selector request under bf16, int8 and int4:g128 (quantized
    in place; the bf16 kernels back from host copies in between), first
    token against the plain routes, decode device ms per token and peak
    memory beside bf16's, on the base weights: phase 15c's LoRA adapters
    are dropped first. Starts the phase's OV CLI (16e) in a process.
    Returns the state ``quant_phase`` finishes: checks, processes, the
    directory of their output, seconds."""
    from visionselector_tpu_torch.models.llava_ov15.model import OVEngine
    from visionselector_tpu_torch.train.lora import lora_leaf

    t0 = time.perf_counter()
    print(f"[quant-ov] card: {nvidia_smi()}", flush=True)
    quant = dict(checks={}, procs={}, tmp=os.path.join(tmp, "quant"))
    os.makedirs(quant["tmp"])
    checks = quant["checks"]
    start_cli(quant["procs"], quant["tmp"], "predict", "--family",
              "llava_ov15", "--model-path", ov_hf, "--quantize", "int4:g128",
              "--prompt-ids", "300,301,302", "--max-new-tokens", "8",
              key="predict_ov_int4")
    for layer in ov_params.lm.layers:
        for name in [n for n in layer._parameters if lora_leaf(n)]:
            del layer._parameters[name]
    req = ov_request(ov_cfg)

    def engines():
        return (OVEngine(ov_cfg, ov_params, use_selector=True, budget=0.2,
                         device="cuda"),
                OVEngine(ov_cfg, ov_params, use_selector=True, budget=0.2,
                         device="cuda", attn_impl="plain"))

    try:
        quant_ov_specs(ov_cfg, ov_params, req, engines, out_dir, checks)
    except BaseException:
        for proc, _, _ in quant["procs"].values():
            proc.kill()
        raise
    quant["seconds"] = time.perf_counter() - t0
    return quant


def quant_ov_specs(ov_cfg, ov_params, req, engines, out_dir, checks):
    """``quant_ov``'s requests: bf16, then each spec quantized in place
    from the bf16 kernels."""
    import torch

    from visionselector_tpu_torch.models.qwen25vl import lm as L

    n_layers = ov_cfg.text.num_hidden_layers
    eng, _ = engines()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = eng.generate(**req, max_new_tokens=QUANT_NEW_TOKENS,
                        eos_token_ids=(-1,))
    torch.cuda.synchronize()
    base_peak = torch.cuda.max_memory_allocated()
    base_pre, base_ms = quant_decode_ms(eng, req, out_dir, "ov_bf16")
    base_bytes = lm_bytes(ov_params.lm)
    print(f"[quant-ov] OV-8B bf16: LM bytes {base_bytes}, peak {base_peak} "
          f"bytes (the 3B's weights resident too), prefill device ms "
          f"{base_pre!r}, decode device ms per token {base_ms!r}",
          flush=True)
    saved = save_lm_kernels(ov_params.lm)
    for spec in ("int8", "int4:g128"):
        restore_lm_kernels(ov_params.lm, saved)
        torch.cuda.empty_cache()
        L.apply_weight_quantization(ov_params, spec)
        torch.cuda.empty_cache()
        eng, plain = engines()
        res, peak, _, _ = quant_request_checks(eng, plain, req, checks,
                                               f"OV-8B {spec}", n_layers)
        pre, ms = quant_decode_ms(eng, req, out_dir, f"ov_{spec}")
        print(f"[quant-ov] OV-8B {spec}: LM bytes {lm_bytes(ov_params.lm)} "
              f"(bf16 {base_bytes}); peak {peak} bytes (bf16 {base_peak}); "
              f"prefill device ms {pre!r} (bf16 {base_pre!r}); decode "
              f"device ms per token {ms!r} (bf16 {base_ms!r})", flush=True)
        del eng, plain
    del saved
    torch.cuda.empty_cache()


QUANT_SERVE_FLAGS = ("--quantize", "int4:g128", "--continuous", "4")


def quant_clis_start(tmp, hf_dir, procs):
    """16(e)'s 3B CLIs, in processes beside the phase: ``api.predict
    --quantize int8``, ``api.run_eval --quantize int8`` and the server of
    ``api.serve --quantize int4:g128 --continuous 4`` (asked at the
    phase's end) on phase 6's reduced-depth HF directory."""
    procs["serve_int4"] = serve_start(hf_dir, QUANT_SERVE_FLAGS)
    start_cli(procs, tmp, "predict", "--model-path", hf_dir, "--quantize",
              "int8", "--prompt-ids", "300,301,302", "--max-new-tokens", "8",
              key="predict_int8")
    task_dir = eval_task_dir(tmp, with_image=False)
    start_cli(procs, tmp, "run_eval", "--model-path", hf_dir, "--quantize",
              "int8", "--data-dir", task_dir, "--task-config-dir", task_dir,
              "--tasks", "smoke_gen,smoke_mc", "--budgets", "0.2",
              "--limit", "2", "--output-dir",
              os.path.join(tmp, "run_eval_int8"), key="run_eval_int8")


def quant_clis_done(procs, hf_dir, checks):
    for key, what in (("predict_int8", "api.predict --quantize int8"),
                      ("predict_ov_int4", "api.predict --family llava_ov15 "
                                          "--quantize int4:g128"),
                      ("run_eval_int8", "api.run_eval --quantize int8")):
        rc, stdout, stderr, secs = finish_cli(procs, key)
        lines = stdout.strip().splitlines()
        print(f"[quant-cli] {what}: rc={rc} in {secs!r} s "
              f"{lines[-1][:400] if lines and rc == 0 else stderr[-2000:]}",
              flush=True)
        checks[f"{what} exits 0"] = rc == 0
    checks["api.serve --quantize int4:g128 --continuous 4"] = serve_cli(
        hf_dir, QUANT_SERVE_FLAGS, 2, started=procs["serve_int4"])


def quant_phase(cfg, params, input_ids, pixels, grid, ov_cfg, out_dir,
                hf_dir, quant):
    """Phase 16, its 3B part (the OV-8B part, ``quant_ov``, ran while OV-8B
    was on the card; ``quant`` holds its checks, CLI processes and
    seconds). Raises if any check failed; returns (launches, kernels line
    entries)."""
    t0 = time.perf_counter()
    print(f"[quant] card: {nvidia_smi()}", flush=True)
    checks, procs = quant["checks"], quant["procs"]
    try:
        entries = quant_kernels(cfg, ov_cfg, out_dir, checks)
        t1 = time.perf_counter()
        quant_clis_start(quant["tmp"], hf_dir, procs)
        launches = quant_3b(cfg, params, input_ids, pixels, grid, out_dir,
                            checks)
        t2 = time.perf_counter()
        quant_clis_done(procs, hf_dir, checks)
        print(f"[quant] seconds: (a) {t1 - t0!r}, (b) and (c) {t2 - t1!r},"
              f" (e) after them {time.perf_counter() - t2!r}", flush=True)
    finally:
        for proc, _, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
    bad = [k for k, ok in checks.items() if not ok]
    print(f"[quant] checks: {checks}", flush=True)
    seconds = quant["seconds"] + time.perf_counter() - t0
    print(f"[quant] phase seconds {seconds!r} (OV-8B part "
          f"{quant['seconds']!r})", flush=True)
    if bad:
        raise AssertionError(f"quantize phase failed: {bad}")
    return launches, entries


# Phase 17 (7b-moe): Qwen2.5-VL-7B at full width and depth (GQA 28 / 4:
# n_rep 7, the first ratio whose query rows do not divide a 16-row tile;
# widths 3,584 / 18,944; an untied 152,064-row head), and the MoE decoder
# of LLaVA-OneVision-1.5's MoE variant.
SEVEN_TC = (4, 8, 32)  # K5 chunks at one slot of the 7B's orig cache
SEVEN_ADMIT_BASE = 1280  # K5 at t_c 256: the orig admission's last segment
SEVEN_SERVE_REQUESTS = 6
SEVEN_SPEC_TOKENS = 16
SEVEN_QUANT_TOKENS = 8
# The reduced-depth 7B HF directory: ViT blocks 0 and 7 (a full-attention
# block) and decoder layers 0 and 1, full widths, the untied head.
SEVEN_HF_BLOCKS, SEVEN_HF_LAYERS = (0, 7), (0, 1)
# One MoE decoder layer at the MoE knobs' defaults (core/config.py: 128
# experts, top 8, expert width 768) on hidden 2,048, at a decode row and
# the selector prefill's 294 rows: the routed path against the dense plain
# scan within MOE_ULPS bf16 ulps of each row's largest |value| (both add
# the experts' bf16 products in the same order; only the per-expert GEMMs
# see other row counts). The tiny MoE engine generates MOE_TOKENS tokens.
MOE_HIDDEN, MOE_ROWS, MOE_ULPS, MOE_TOKENS = 2048, (1, 294), 2, 4


def seven_b_kernels(cfg, engines, req) -> dict:
    """17(a): the kernels at the 7B's shapes against their plain versions:
    K1 causal at decoder layer 0 (GQA 28 / 4, D = 128) under the selector
    and ``orig``; K5 at n_rep 7, bf16 and int8: t_c 1 over an 8-slot,
    2,048-row pool at ``DECODE_LENS``, t_c 4 / 8 / 32 over one slot of the
    ``orig`` request's cache size (seeded rows) at its base and t_c 256 at
    SEVEN_ADMIT_BASE. The ViT's K1 / K4 have the 3B's shapes (phase 2);
    kernels A and B at the 7B layer's seven products are phase 16(a)'s
    (``quant_kernels``). Returns the kernels line's entries."""
    import torch

    out = {"flash_varlen_fwd_7b": causal_k1_cases(
        "flash_varlen_fwd_7b", "7B", engines, req, tag="[7b-kernel]",
        phases=False)}
    tc = cfg.text
    hkv, dh = tc.num_key_value_heads, tc.head_dim
    gen = torch.Generator(device="cuda").manual_seed(SEED + 17)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").bfloat16()

    out["decode_blocked_fwd_7b"] = spec_k5_cases(tc, [
        ("8-slot pool", rnd(POOL_SLOTS, POOL_ROWS, hkv, dh),
         rnd(POOL_SLOTS, POOL_ROWS, hkv, dh),
         torch.tensor(DECODE_LENS, device="cuda"))],
        "decode_blocked_fwd_7b", gen, t_c=1, tag="[7b-kernel]")
    # one slot of the orig request's cache: 1,664 prefill rows (1,302
    # valid) + room for MAX_NEW_TOKENS, as phase 2's
    k1, v1 = (rnd(1, ORIG_CACHE_ROWS, hkv, dh) for _ in range(2))
    where = "one slot, orig cache"
    for t_c in SEVEN_TC:
        out[f"decode_blocked_fwd_7b_t_c{t_c}"] = spec_k5_cases(
            tc, [(where, k1, v1, torch.tensor([ORIG_BASE_LEN],
                                              device="cuda"))],
            f"decode_blocked_fwd_7b_t_c{t_c}", gen, t_c=t_c,
            tag="[7b-kernel]")
    out[f"decode_blocked_fwd_7b_t_c{ADMIT_SEG}"] = spec_k5_cases(
        tc, [(where, k1, v1, torch.tensor([SEVEN_ADMIT_BASE],
                                          device="cuda"))],
        f"decode_blocked_fwd_7b_t_c{ADMIT_SEG}", gen, t_c=ADMIT_SEG,
        tag="[7b-kernel]")
    del k1, v1
    return out


def seven_b_main(cfg, engines, plains, req, out_dir, checks) -> dict:
    """17(b): the selector 0.2 and ``orig`` requests, 32 greedy tokens
    each, the counts zeroed just before and read just after: per prefill
    28 K4 and 4 + 28 K1 (the 28 causal), 28 K5 per decode step. Each first
    token equal to ``attn_impl="plain"``'s, the logits within 0.1 of max
    |logit| (phase 3's rule), the selector's on the kernel route's kept set
    (its own kept set within phase 3's overlap); then prefill device ms of
    both (one traced prefill each), their
    ratio, decode device ms per token (a traced run of
    QUANT_PROFILE_STEPS more steps, less the prefill), peak memory.
    Returns the launches of the counted run."""
    import torch

    from visionselector_tpu_torch.kernels import attention as A
    from visionselector_tpu_torch.models.qwen25vl import model as M

    n_full = len(cfg.vision.fullatt_block_indexes)
    n_layers = cfg.text.num_hidden_layers
    for eng in engines.values():  # warm-up, outside the counted run
        eng.generate(**req, max_new_tokens=2)
    torch.cuda.synchronize()
    zero_counts()
    results = {}
    for name, eng in engines.items():
        before = dict(launch_counts(), causal=A.FLASH_CAUSAL_LAUNCHES)
        torch.cuda.reset_peak_memory_stats()
        res = eng.generate(**req, max_new_tokens=MAX_NEW_TOKENS)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        now = dict(launch_counts(), causal=A.FLASH_CAUSAL_LAUNCHES)
        got = {key: now[key] - before[key] for key in
               ("flash_varlen_fwd", "causal", "diag_attn_fwd",
                "decode_blocked_fwd")}
        steps = ov_steps(res)
        want = {"flash_varlen_fwd": n_full + n_layers, "causal": n_layers,
                "diag_attn_fwd": cfg.vision.depth - n_full,
                "decode_blocked_fwd": n_layers * steps}
        kept = (len(res.selected_indices) if res.selected_indices is not None
                else res.num_vision_tokens)
        print(f"[7b-main] {name}: vision_tokens={res.num_vision_tokens} "
              f"kept={kept} prefill_len={res.prefill_len} prefill_ms="
              f"{res.prefill_seconds * 1e3!r} peak_mem_bytes={peak} "
              f"launches {got} (expected {want})", flush=True)
        print(f"[7b-main] {name} tokens: {res.tokens}", flush=True)
        checks[f"main {name}: launches"] = got == want
        checks[f"main {name}: tokens and logits"] = bool(
            res.tokens and all(0 <= t < cfg.text.vocab_size
                               for t in res.tokens)
            and torch.isfinite(res.logits).all()
            and res.logits.shape == (cfg.text.vocab_size,))
        results[name] = (res, peak)
    launches = {"flash_varlen_fwd_7b": A.FLASH_CAUSAL_LAUNCHES,
                "decode_blocked_fwd_7b": A.DECODE_LAUNCHES_BY_ROWS.get(1, 0)}
    select = M.select_hard
    for name, (res, _) in results.items():
        res_p = plains[name].generate(**req, max_new_tokens=1)
        line = ""
        if res.selected_indices is not None:
            # phase 3's rule: the random scorer (std 1e-4) leaves near-ties
            # that bf16 drift swaps, so the two routes' kept sets mostly
            # agree; the first token is then held on the kernel route's set
            a = set(res.selected_indices.tolist())
            b = set(res_p.selected_indices.tolist())
            line = (f" (own kept set: overlap {len(a & b)}/{len(a)}, first "
                    f"token {res_p.tokens[0]})")
            checks[f"main {name}: kept set vs plain"] = (
                len(a & b) / len(a) >= 0.9)
            seen = {}

            def capture(*args, **kw):
                seen["sel"] = select(*args, **kw)
                return seen["sel"]

            with patched(M, "select_hard", capture):
                same = engines[name].generate(**req, max_new_tokens=1)
            with patched(M, "select_hard", lambda *args, **kw: seen["sel"]):
                res_p = plains[name].generate(**req, max_new_tokens=1)
            checks[f"main {name}: kernel route repeats"] = (
                same.tokens[0] == res.tokens[0])
        diff = (res_p.logits - res.logits).abs().max().item()
        scale = res.logits.abs().max().item()
        top2 = res_p.logits.topk(2).values
        print(f"[7b-plain] {name}: first-token logits max_abs_diff={diff!r}"
              f" (max |logit| {scale!r}) first token kernel={res.tokens[0]}"
              f" plain={res_p.tokens[0]} (plain top-2 gap "
              f"{(top2[0] - top2[1]).item()!r}){line}", flush=True)
        checks[f"main {name}: first token = plain routes'"] = (
            res.tokens[0] == res_p.tokens[0])
        checks[f"main {name}: logits vs plain"] = diff <= 0.1 * scale
    ms = {}
    for name, eng in engines.items():
        ms[name] = quant_decode_ms(eng, req, out_dir, f"7b_{name}")
    sel, orig = ms["selector"], ms["orig"]
    print(f"[7b-main] prefill device ms: selector {sel[0]!r}, orig "
          f"{orig[0]!r}, orig / selector {orig[0] / sel[0]!r}; decode "
          f"device ms per token: selector {sel[1]!r}, orig {orig[1]!r}; "
          f"peak bytes: selector {results['selector'][1]}, orig "
          f"{results['orig'][1]} ({nvidia_smi()})", flush=True)
    return launches


def seven_b_paths(cfg, engine, req, checks) -> dict:
    """17(b), the chunked decode paths at the 7B's widths, each counted on
    its own (zeroed just before, read just after): ``generate_speculative``
    at m = 3 and 7 (SEVEN_SPEC_TOKENS greedy tokens; K5 at t_c 4 and 8, 28
    a verify step; the first token equal to ``generate``'s), and
    ``run_loglikelihood_choices`` with choices of ``CHOICE_LENS`` ids (one
    chunked forward of 32 rows a choice: K5 at t_c 32, 28 a choice; finite
    log-likelihoods). Returns those launches."""
    import numpy as np
    import torch

    from visionselector_tpu_torch.kernels import attention as A
    from visionselector_tpu_torch.models.qwen25vl import model as M

    n_layers = cfg.text.num_hidden_layers
    launches = {}
    first = engine.generate(**req, max_new_tokens=1).tokens[0]
    for m in (3, 7):
        zero_counts()
        res = M.generate_speculative(engine, **req,
                                     max_new_tokens=SEVEN_SPEC_TOKENS,
                                     eos_token_ids=(-1,), propose_len=m)
        torch.cuda.synchronize()
        by_rows = dict(A.DECODE_LAUNCHES_BY_ROWS)
        n = by_rows.get(m + 1, 0)
        print(f"[7b-paths] speculative m={m}: {len(res.tokens)} tokens in "
              f"{res.decode_dispatches} dispatches, accepted "
              f"{res.spec_accepted} of {res.spec_proposed}; K5 launches by "
              f"t_c {by_rows}; first token {res.tokens[0]} (generate "
              f"{first})", flush=True)
        checks[f"speculative m={m}: K5 at t_c {m + 1}, {n_layers} a verify "
               f"step"] = (n > 0 and n % n_layers == 0
                          and set(by_rows) == {m + 1})
        checks[f"speculative m={m}: first token"] = res.tokens[0] == first
        launches[f"decode_blocked_fwd_7b_t_c{m + 1}"] = n
    rng = np.random.RandomState(SEED + 17)
    choices = [rng.randint(1000, 100000, n) for n in CHOICE_LENS]
    zero_counts()
    lls = M.run_loglikelihood_choices(
        engine, req["input_ids"], choices, pixel_values=req["pixel_values"],
        grid_thw=req["grid_thw"])
    torch.cuda.synchronize()
    by_rows = dict(A.DECODE_LAUNCHES_BY_ROWS)
    c_max = 32
    print(f"[7b-paths] choices of {CHOICE_LENS} ids: ll {lls}; K5 launches "
          f"by t_c {by_rows}", flush=True)
    checks["choices: K5 at t_c 32, one chunk a choice"] = (
        by_rows == {c_max: n_layers * len(choices)})
    checks["choices: finite"] = all(np.isfinite(ll) for ll, _ in lls)
    launches[f"decode_blocked_fwd_7b_t_c{c_max}"] = by_rows.get(c_max, 0)
    return launches


def seven_b_serving(cfg, engine, input_ids, pixels, grid, checks) -> dict:
    """17(c): ``ContinuousBatcher(n_slots=8, t_max=2,048, chunk=8)`` at the
    7B's widths, bf16 pool, one-shot admissions, over SEVEN_SERVE_REQUESTS
    of phase 5's greedy selector requests arriving over time: K5 at n_rep
    7 on the live batch, each first token equal to its one-shot
    ``generate``'s, every budget run out. Then the phase-3 selector
    request as one chunked admission (``start_chunked_prefill``:
    ADMIT_VIT_SEGMENTS tower groups, ADMIT_SEG-row decoder segments, K5 at
    t_c 256 into its cache), the counts zeroed just before and read just
    after: its kept set equal to one-shot's, its first-token logits within
    0.1 of max |logit| of the one-shot prefill's (phase 3's rule: the
    decoder segments attend through K5, the one-shot prefill through K1),
    its first token equal. Returns K5's launches at t_c 256."""
    import torch

    from visionselector_tpu_torch.kernels import attention as A
    from visionselector_tpu_torch.models.qwen25vl.continuous import (
        ContinuousBatcher,
    )

    traffic = [(e, r, m, dict(eos_token_ids=(-1,)), d)
               for e, r, m, kw, d in serve_traffic(cfg, input_ids, pixels,
                                                   grid)
               if e == "selector" and not kw][:SEVEN_SERVE_REQUESTS]
    want = [engine.generate(**r, max_new_tokens=1).tokens[0]
            for _, r, _, _, _ in traffic]
    zero_counts()
    bat = ContinuousBatcher(engine, n_slots=POOL_SLOTS, t_max=POOL_ROWS,
                            chunk=8)
    res, wall = run_batcher(bat, traffic)
    by_rows = dict(A.DECODE_LAUNCHES_BY_ROWS)
    first = [r.tokens[0] for r in res]
    tokens = sum(len(r.tokens) - 1 for r in res)
    print(f"[7b-serve] {len(res)} requests: {wall!r} s wall, "
          f"{tokens / wall!r} decode tok/s, first tokens {first} (one-shot "
          f"{want}), K5 launches by t_c {by_rows}, stats {bat.stats}",
          flush=True)
    checks["serve: first tokens = one-shot"] = first == want
    checks["serve: budgets run out"] = all(
        len(r.tokens) == m for r, (_, _, m, _, _) in zip(res, traffic))
    checks["serve: K5 on the live batch"] = set(by_rows) == {1}

    one = engine.generate(input_ids, pixels, grid, max_new_tokens=1)
    zero_counts()
    cp = engine.start_chunked_prefill(
        input_ids, pixels, grid, max_new_tokens=1, prefill_chunk=ADMIT_SEG,
        vit_segments=ADMIT_VIT_SEGMENTS)
    while not cp.step():
        pass
    state = cp.finish()
    torch.cuda.synchronize()
    by_rows = dict(A.DECODE_LAUNCHES_BY_ROWS)
    got = state.result
    diff = (got.logits - one.logits).abs().max().item()
    scale = one.logits.abs().max().item()
    top2 = one.logits.topk(2).values
    same_sel = (got.selected_indices.tolist()
                == one.selected_indices.tolist())
    print(f"[7b-serve] chunked admission ({cp.n_seg} decoder segments of "
          f"{ADMIT_SEG} rows, {got.prefill_len} valid): first token "
          f"{state.next_token} (one-shot {one.tokens[0]}, its top-2 gap "
          f"{(top2[0] - top2[1]).item()!r}), first-token logits max_abs_"
          f"diff {diff!r} (max |logit| {scale!r}), kept set equal "
          f"{same_sel}, K5 launches by t_c {by_rows}", flush=True)
    n_layers = cfg.text.num_hidden_layers
    checks["chunked admission: K5 at t_c 256, a layer a segment"] = (
        by_rows == {ADMIT_SEG: n_layers * cp.n_seg})
    checks["chunked admission: kept set = one-shot"] = same_sel
    checks["chunked admission: logits vs one-shot"] = diff <= 0.1 * scale
    checks["chunked admission: first token"] = (
        state.next_token == one.tokens[0])
    return {f"decode_blocked_fwd_7b_t_c{ADMIT_SEG}": by_rows.get(ADMIT_SEG,
                                                                 0)}


def seven_b_hf_start(cfg, params, tmp, procs) -> str:
    """17(d): a reduced-depth 7B HF directory (ViT blocks SEVEN_HF_BLOCKS,
    the second a full-attention one; decoder layers SEVEN_HF_LAYERS; full
    widths, the untied ``lm_head.weight``, bf16; the scorer fp32 at in
    features 3,584), written in the nested layout, 2 shards, and
    ``api.predict --model-path`` on it started in a process of its own.
    Returns the directory."""
    import dataclasses

    from visionselector_tpu_torch.core.safetensors import save_sharded
    from visionselector_tpu_torch.models.qwen25vl.weights import (
        to_hf_tensors,
    )

    keep = {f"model.visual.blocks.{j}.": f"model.visual.blocks.{i}."
            for i, j in enumerate(SEVEN_HF_BLOCKS)}
    keep.update({f"model.language_model.layers.{j}.":
                 f"model.language_model.layers.{i}."
                 for i, j in enumerate(SEVEN_HF_LAYERS)})
    small = reduced_tensors(
        to_hf_tensors(params, "model.visual.", "model.language_model."),
        keep)
    vis = dataclasses.asdict(cfg.vision)
    vis.update(depth=len(SEVEN_HF_BLOCKS), fullatt_block_indexes=[1])
    text = dict(dataclasses.asdict(cfg.text),
                num_hidden_layers=len(SEVEN_HF_LAYERS),
                rope_scaling={"type": "mrope",
                              "mrope_section": list(cfg.text.mrope_section)})
    d = os.path.join(tmp, "hf_7b")
    t0 = time.perf_counter()
    save_sharded(small, d, shards=2)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump({"vision_config": vis, "text_config": text,
                   "image_token_id": cfg.image_token_id,
                   "eos_token_id": cfg.eos_token_id}, f)
    nbytes = sum(t.numel() * t.element_size() for t in small.values())
    print(f"[7b-hf] reduced-depth HF dir (ViT blocks {SEVEN_HF_BLOCKS}, "
          f"decoder layers {SEVEN_HF_LAYERS}, {len(small)} tensors, "
          f"{nbytes} bytes, lm_head.weight {'lm_head.weight' in small}): "
          f"write_s={time.perf_counter() - t0!r}", flush=True)
    start_cli(procs, tmp, "predict", "--model-path", d, "--prompt-ids",
              "300,301,302", "--max-new-tokens", "4", key="predict_7b")
    return d


def seven_b_hf_done(d, procs, checks):
    """17(d), the end: the directory loaded onto the card in this process
    (its config read by ``config_from_hf``: width 3,584, GQA 28 / 4, vocab
    152,064, untied), and the CLI's request through the same entry
    points (``api.predict.load_model`` / ``make_engine``, the predict
    request's image and ids): the CLI exits 0 with these tokens."""
    import numpy as np
    import torch

    from visionselector_tpu_torch.api.predict import load_model, make_engine
    from visionselector_tpu_torch.preprocess.image import preprocess_image
    from visionselector_tpu_torch.preprocess.rope import expand_vision_tokens

    rc, stdout, stderr, secs = finish_cli(procs, "predict_7b")
    out = json.loads(stdout.strip().splitlines()[-1]) if rc == 0 else {}
    cfg, params = load_model("qwen25vl", d, "cuda")
    img = (np.random.RandomState(0).rand(112, 112, 3) * 255).astype(np.uint8)
    px, grid = preprocess_image(img, min_pixels=1, max_pixels=10**9)
    ids = expand_vision_tokens(
        [], [300, 301, 302], grid,
        spatial_merge_size=cfg.vision.spatial_merge_size,
        image_token_id=cfg.image_token_id,
        vision_start_token_id=cfg.vision_start_token_id,
        vision_end_token_id=cfg.vision_end_token_id)
    eng = make_engine("qwen25vl", cfg, params, "selector", 0.2, "cuda")
    res = eng.generate(ids, px, grid, max_new_tokens=4)
    t = cfg.text
    print(f"[7b-hf] api.predict --model-path (cuda): rc={rc} in {secs!r} s "
          f"{out or stderr[-2000:]}; in process {res.tokens} (config: width "
          f"{t.hidden_size}, heads {t.num_attention_heads} / "
          f"{t.num_key_value_heads}, vocab {t.vocab_size}, tied "
          f"{t.tie_word_embeddings}, scorer in features "
          f"{params.scorer.k_kernel.shape[0]})", flush=True)
    checks["api.predict --model-path: rc 0, tokens = in process"] = bool(
        rc == 0 and out.get("tokens") == res.tokens and out.get("selector"))
    checks["7B directory: config"] = (
        (t.hidden_size, t.num_attention_heads, t.num_key_value_heads,
         t.vocab_size, t.tie_word_embeddings) == (3584, 28, 4, 152064, False)
        and params.scorer.k_kernel.shape[0] == 3584)
    del params, eng
    torch.cuda.empty_cache()


def seven_b_quant(cfg, params, req, checks) -> dict:
    """17(b) under ``--quantize``: the selector request, SEVEN_QUANT_TOKENS
    greedy tokens, under int8, int4 and int4:g128, each quantized in place
    from the bf16 kernels (put back from host copies in between; the last
    spec stays): 196 kernel-A launches a decode step, 196 dequantize-route
    calls and kernel-B launches a prefill, the plain routes and the
    teacher-forced decode step by phase 16's rule (``quant_request_checks``).
    Leaves the 7B quantized. Returns kernel A's launches per spec and
    kernel B's of the int8 request."""
    import torch

    from visionselector_tpu_torch.models.qwen25vl import lm as L
    from visionselector_tpu_torch.models.qwen25vl.model import QwenVLEngine

    n_layers = cfg.text.num_hidden_layers
    saved = save_lm_kernels(params.lm)
    launches = {}
    for i, spec in enumerate(QUANT_SPECS):
        if i:
            restore_lm_kernels(params.lm, saved)
        torch.cuda.empty_cache()
        L.apply_weight_quantization(params, spec)
        torch.cuda.empty_cache()
        eng = QwenVLEngine(cfg, params, use_selector=True, budget=0.2,
                           device="cuda")
        plain = QwenVLEngine(cfg, params, use_selector=True, budget=0.2,
                             device="cuda", attn_impl="plain")
        _, peak, kernel_a, kernel_b = quant_request_checks(
            eng, plain, req, checks, f"7B {spec}", n_layers,
            new_tokens=SEVEN_QUANT_TOKENS)
        launches[WQ_ENTRY[spec] + "_7b"] = kernel_a
        if spec == "int8":
            launches["wq_dequant_fwd_7b"] = kernel_b
        print(f"[7b-quant] {spec}: LM bytes {lm_bytes(params.lm)}, peak "
              f"{peak} bytes", flush=True)
        del eng, plain
    del saved
    return launches


def moe_checks(checks):
    """17(e): the MoE decoder on the card. ``OVEngine.generate`` on
    ``llava_ov_moe_tiny`` (weights from a seeded CPU generator, the
    decoder's matrices x 8 and the scorer at std 1, as the CPU tests take
    them, rounded to bf16: the card runs these bf16 values, the CPU port
    the same values in fp32) with the selector at 0.5, MOE_TOKENS greedy
    tokens: the tokens and selected indices equal the CPU port's. Then one MoE layer at 128 experts / top 8
    / expert width 768 on hidden 2,048 (seeded bf16): the routed path
    (``lm._moe_mlp``) against the dense plain scan (``lm.moe_mlp_plain``)
    at MOE_ROWS rows within MOE_ULPS bf16 ulps of each row's largest
    |value|, both timed (CUDA events; the routed path's one host read
    included)."""
    import dataclasses

    import torch

    from visionselector_tpu_torch.core.config import (
        TextConfig,
        llava_ov_moe_tiny,
    )
    from visionselector_tpu_torch.models.llava_ov15.model import (
        OVEngine,
        init_ov_params,
    )
    from visionselector_tpu_torch.models.qwen25vl import lm as L

    cfg = llava_ov_moe_tiny()
    host = init_ov_params(cfg, torch.Generator().manual_seed(SEED), "cpu",
                          torch.float32)
    card = init_ov_params(cfg, torch.Generator(device="cuda"), "cuda",
                          torch.bfloat16)
    with torch.no_grad():
        for (name, h), (_, t) in zip(host.named_parameters(),
                                     card.named_parameters()):
            if name.startswith("scorer."):
                h.mul_(1.0 / cfg.with_selector().selector.init_scale)
            elif name.startswith("lm.") and not name.endswith(
                    ("_scale", "_bias")):
                h.mul_(8.0)
            h.copy_(h.bfloat16().float())  # the card's values, in fp32
            t.copy_(h)
    req = dict(zip(("pixel_values", "grid_thw", "input_ids"),
                   tiny_ov_request(cfg)))
    runs = {}
    for dev, p in (("cuda", card), ("cpu", host)):
        runs[dev] = OVEngine(cfg, p, use_selector=True, budget=0.5,
                             device=dev).generate(
            **req, max_new_tokens=MOE_TOKENS, eos_token_ids=(-1,))
    a, b = runs["cuda"], runs["cpu"]
    same_sel = a.selected_indices.tolist() == b.selected_indices.tolist()
    top2 = b.logits.topk(2).values
    print(f"[moe] llava_ov_moe_tiny ({cfg.text.num_experts} experts, top "
          f"{cfg.text.num_experts_per_tok}) OVEngine.generate: card tokens "
          f"{a.tokens}, CPU tokens {b.tokens}; first-token logits max_abs_"
          f"diff {(a.logits.cpu() - b.logits).abs().max().item()!r} (max "
          f"|logit| {b.logits.abs().max().item()!r}, CPU top-2 gap "
          f"{(top2[0] - top2[1]).item()!r}); selected indices equal "
          f"{same_sel} ({len(a.selected_indices)} kept)", flush=True)
    checks["MoE engine: tokens = CPU port's"] = a.tokens == b.tokens
    checks["MoE engine: selected indices = CPU port's"] = same_sel
    del card, host

    tc = dataclasses.replace(TextConfig(), hidden_size=MOE_HIDDEN,
                             num_experts=128)
    layer = L.DecoderLayer(tc, "cuda", torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 18)
    with torch.no_grad():
        for t in layer.parameters():
            t.normal_(0.0, 0.02, generator=gen)
    for rows in MOE_ROWS:
        x = torch.randn(1, rows, MOE_HIDDEN, generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        with torch.no_grad():
            got = L._moe_mlp(x, layer, tc)
            want = L.moe_mlp_plain(x, layer, tc)
            ulps = bf16_ulp_err(got, want)
            ms = cuda_ms(lambda: L._moe_mlp(x, layer, tc))
            plain_ms = cuda_ms(lambda: L.moe_mlp_plain(x, layer, tc), n=3)
        print(f"[moe] layer E={tc.num_experts} top-{tc.num_experts_per_tok}"
              f" mi={tc.moe_intermediate_size} D={MOE_HIDDEN} rows={rows}: "
              f"routed vs dense plain {ulps!r} bf16 ulps (limit {MOE_ULPS}),"
              f" max_abs_err {(got.float() - want.float()).abs().max()!r}; "
              f"routed {ms!r} ms, dense plain {plain_ms!r} ms", flush=True)
        checks[f"MoE layer rows={rows}: routed = dense plain"] = bool(
            ulps <= MOE_ULPS and torch.isfinite(got).all())


def tiny_ov_request(cfg):
    """(pixel rows, grid, ids) of a seeded 112x140 image (temporal patch
    1) and 5 prompt ids for the tiny OV configs."""
    import numpy as np

    from visionselector_tpu_torch.preprocess.image import preprocess_image
    from visionselector_tpu_torch.preprocess.rope import expand_vision_tokens

    img = (np.random.RandomState(SEED).rand(112, 140, 3) * 255).astype(
        np.uint8)
    px, grid = preprocess_image(img, min_pixels=1, max_pixels=10**9,
                                temporal_patch_size=1)
    ids = expand_vision_tokens(
        [100, 200], [300, 400, 500], grid,
        spatial_merge_size=cfg.vision.spatial_merge_size,
        image_token_id=cfg.image_token_id,
        vision_start_token_id=cfg.vision_start_token_id,
        vision_end_token_id=cfg.vision_end_token_id)
    return px, grid, ids


def seven_b_phase(out_dir, tmp):
    """Phase 17. Raises if any check failed; returns (launches of the
    7B-shaped kernels: K1 causal, K5 at t_c 1 / 4 / 8 / 32 / 256, kernels
    A per spec and B, each counted on the 7B path that launches it; the
    kernels line's entries of K1 and K5, A's and B's being phase
    16(a)'s)."""
    import gc

    import torch

    from visionselector_tpu_torch.core.config import qwen25vl_7b
    from visionselector_tpu_torch.models.qwen25vl.model import QwenVLEngine
    from visionselector_tpu_torch.models.qwen25vl.weights import init_params

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[7b] card: {nvidia_smi()}; memory allocated before the 7B "
          f"{torch.cuda.memory_allocated()} bytes", flush=True)
    cfg = qwen25vl_7b()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(
        SEED), "cuda", torch.bfloat16)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in params.parameters())
    print(f"[7b] qwen25vl_7b random bf16 (scorer fp32, in features "
          f"{params.scorer.k_kernel.shape[0]}): {n} parameters in "
          f"{time.perf_counter() - t0!r} s; memory allocated "
          f"{torch.cuda.memory_allocated()} bytes", flush=True)
    input_ids, pixels, grid = request(cfg)
    req = dict(input_ids=input_ids, pixel_values=pixels, grid_thw=grid)
    engines = {name: QwenVLEngine(cfg, params, use_selector=name ==
                                  "selector", budget=0.2, device="cuda")
               for name in ("selector", "orig")}
    plains = {name: QwenVLEngine(cfg, params, use_selector=name ==
                                 "selector", budget=0.2, device="cuda",
                                 attn_impl="plain")
              for name in ("selector", "orig")}
    checks, launches, procs, secs = {}, {}, {}, {}
    try:
        t0 = time.perf_counter()
        kernels = seven_b_kernels(cfg, engines, req)
        secs["a"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        launches.update(seven_b_main(cfg, engines, plains, req, out_dir,
                                     checks))
        hf_dir = seven_b_hf_start(cfg, params, tmp, procs)
        launches.update(seven_b_paths(cfg, engines["selector"], req,
                                      checks))
        secs["b"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        launches.update(seven_b_serving(cfg, engines["selector"], input_ids,
                                        pixels, grid, checks))
        secs["c"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        launches.update(seven_b_quant(cfg, params, req, checks))
        secs["b, quantized"] = time.perf_counter() - t0
        del engines, plains, params
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        seven_b_hf_done(hf_dir, procs, checks)
        secs["d"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        moe_checks(checks)
        secs["e"] = time.perf_counter() - t0
    finally:
        for proc, _, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
    bad = [k for k, ok in checks.items() if not ok]
    print(f"[7b] checks: {checks}", flush=True)
    print(f"[7b] phase seconds {time.perf_counter() - t_phase!r}; parts "
          f"{secs}", flush=True)
    torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"7B / MoE phase failed: {bad}")
    return launches, kernels


# Phase 18: the W8A8 ViT and the parallel paths. The tensor-parallel,
# expert-parallel and sequence-parallel paths run in one world of TP_WORLD
# ranks, spawned processes that share the one card over gloo (NCCL refuses
# two ranks on one device), rendezvous under .smoke_tmp/.
TP_WORLD = 2
TP_NEW_TOKENS = 8
TP_SPEC_M = 7  # K5 at t_c 8 under TP
TP_TIMEOUT = 600  # seconds for the whole world
# the W8A8 tower against the bf16 one: the reference's own bar
# (tests/test_int8.py: cosine > 0.98, relative error < 0.2)
W8A8_COS, W8A8_REL = 0.98, 0.2


def int_mm_cases(vis, tower):
    """18(a): ``torch._int_mm`` at the 3B ViT's five products (6,144 rows:
    the 6,144 bucket), the MLP's padded to 3,424: bit-equal to the plain
    int product of the unpadded operands (fp64 on the card: |acc| <= 127^2
    x 3,420 < 2^53, so exact), ms beside the bf16 GEMM on the same widths,
    the per-token quantize and the epilogue, which holds 4 bf16 ulps of
    its plain fp64 version. Returns the parts' ms."""
    import torch

    from visionselector_tpu_torch.models.qwen25vl import vit as V

    blk = tower.blocks[0]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 23)
    rows, out = 6144, {}
    for name in V.VIT_QUANT_KERNELS:
        w = getattr(blk, name)
        q = V.vit_quantized_kernel(blk, name)
        din, dout = q.shape
        x = torch.randn(rows, din, generator=gen, device="cuda").bfloat16()
        xq, xs = V.quantize_rows(x)
        got = V.int8_matmul(xq, w)
        want = (xq.double() @ q.double()).long()
        exact = bool(torch.equal(got[:, :dout].long(), want)
                     and not got[:, dout:].any())
        ws, b = getattr(blk, name + "_scale"), getattr(
            blk, name.replace("_kernel", "_bias"))
        y = V.w8a8_epilogue(got, xs, ws, b, x.dtype)
        y64 = (want.double() * xs.double() * ws.double()
               + b.double()).to(x.dtype)
        epi_ulps = bf16_ulp_err(y, y64)
        wb = torch.randn(din, dout, generator=gen, device="cuda").bfloat16()
        mm, bf = cuda_ms(lambda: V.int8_matmul(xq, w)), cuda_ms(
            lambda: x @ wb)
        qms = cuda_ms(lambda: V.quantize_rows(x))
        ems = cuda_ms(lambda: V.w8a8_epilogue(got, xs, ws, b, x.dtype))
        nbytes = rows * din + din * dout + rows * dout * 4
        bound, by = nbytes / HBM_BYTES_S * 1e3, "bytes"
        t_ops = 2 * rows * din * dout / INT8_OPS_S * 1e3
        if t_ops > bound:
            bound, by = t_ops, "operations"
        print(f"[w8a8] {name} {rows}x{din}x{dout} (stored {tuple(w.shape)}"
              f"): _int_mm bit-equal to the plain int product {exact}; "
              f"epilogue {epi_ulps!r} bf16 ulps of its fp64 version (limit "
              f"{ULP_LIMIT}); _int_mm {mm!r} ms (bound {bound!r}, {by}), "
              f"bf16 GEMM {bf!r} ms, quantize {qms!r} ms, epilogue "
              f"{ems!r} ms", flush=True)
        vis["checks"][f"W8A8 {name}: _int_mm exact"] = exact
        vis["checks"][f"W8A8 {name}: epilogue ulps"] = epi_ulps <= ULP_LIMIT
        out[name] = dict(int_mm=mm, bf16=bf, quantize=qms, epilogue=ems)
    return out


def w8a8_phase(cfg, params, engine, req, out_dir, checks):
    """18(a): the full-width 3B ViT quantized W8A8 (a copy of the tower;
    the quantize pass timed), phase 3's image at the 6,144 bucket: the
    padded ``_int_mm`` and the epilogue (``int_mm_cases``); the merged
    tokens' cosine and relative error against the bf16 tower and the
    overlap of the selected indices; ViT device ms of both under the
    default route (profiler); ``_int_mm`` launches per tower (160), then
    the W8A8 engine's request with its launches."""
    import copy

    import torch

    from visionselector_tpu_torch.models.qwen25vl import model as M
    from visionselector_tpu_torch.models.qwen25vl import vit as V

    p = engine._prep_vision(req["input_ids"], req["pixel_values"],
                            req["grid_thw"], req["grid_thw"], None, None)
    vb = engine._vision_tensors(p.vb)
    tower = copy.deepcopy(params.visual)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    V.quantize_vit_params(tower)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    vis = {"checks": checks}
    parts = int_mm_cases(vis, tower)
    with torch.no_grad():
        ref = V.vit_forward(params.visual, **vb)
        n0 = V.INT_MM_LAUNCHES
        got = V.vit_forward(tower, **vb)
        launches = V.INT_MM_LAUNCHES - n0
        a, b = ref[:p.n].float(), got[:p.n].float()
        cos = (a * b).sum() / (a.norm() * b.norm())
        rel = (a - b).norm() / a.norm()
        sel = [set(M.select_hard(params.scorer, e, p.n, p.k, p.k_max)
                   .indices[:p.k].tolist()) for e in (ref, got)]
        overlap = len(sel[0] & sel[1]) / p.k
        ms = {}
        for name, t in (("bf16", params.visual), ("w8a8", tower)):
            V.vit_forward(t, **vb)
            ms[name] = traced(lambda: V.vit_forward(t, **vb), os.path.join(
                out_dir, f"profile_vit_{name}.json"))[0]
    print(f"[w8a8] 3B ViT at S={p.s_bucket}: quantize pass {quant_s!r} s; "
          f"_int_mm launches per tower {launches}; merged tokens against "
          f"the bf16 tower: cosine {cos.item()!r} (limit > {W8A8_COS}), "
          f"relative error {rel.item()!r} (limit < {W8A8_REL}); selected "
          f"indices overlap {overlap!r} ({p.k} kept); ViT device ms bf16 "
          f"{ms['bf16']!r}, W8A8 {ms['w8a8']!r} (ratio "
          f"{ms['w8a8'] / ms['bf16']!r}); per product ms {parts}",
          flush=True)
    depth, n_full = cfg.vision.depth, len(cfg.vision.fullatt_block_indexes)
    checks["W8A8: 5 _int_mm launches a block"] = launches == 5 * depth
    checks["W8A8: cosine / relative error"] = bool(
        cos > W8A8_COS and rel < W8A8_REL and torch.isfinite(b).all())
    eng8 = M.QwenVLEngine(cfg, M.QwenVLParams(tower, params.lm,
                                              params.scorer),
                          use_selector=True, budget=0.2, device="cuda")
    eng8.generate(**req, max_new_tokens=2)
    zero_counts()
    n0 = V.INT_MM_LAUNCHES
    res = eng8.generate(**req, max_new_tokens=TP_NEW_TOKENS,
                        eos_token_ids=(-1,))
    counts = dict(launch_counts(), int_mm=V.INT_MM_LAUNCHES - n0)
    print(f"[w8a8] W8A8 engine, selector 0.2, {TP_NEW_TOKENS} tokens: "
          f"{res.tokens}, prefill {res.prefill_seconds * 1e3!r} ms wall; "
          f"launches {counts}", flush=True)
    checks["W8A8 engine: 160 _int_mm + 28 K4 + 40 K1 a prefill"] = (
        counts["int_mm"] == 5 * depth
        and counts["diag_attn_fwd"] == depth - n_full
        and counts["flash_varlen_fwd"] == n_full
        + cfg.text.num_hidden_layers)
    del tower, eng8
    return dict(ms, quantize_s=quant_s, launches=launches)


def causal_k1_entry(kname, label, tc, t, valid, gen, tag) -> dict:
    """K1 causal on one row of ``t`` positions (``valid`` of them before
    the padding) at ``tc``'s heads, seeded bf16, against its plain version
    (fault: each q tile's diagonal kv tile cut from the bounds), with ms,
    bound and one SDPA call (``ov_kernel_entry``)."""
    import torch

    from visionselector_tpu_torch.kernels import attention as A

    hq, hkv, d = tc.num_attention_heads, tc.num_key_value_heads, tc.head_dim
    q = torch.randn(1, t, hq, d, generator=gen, device="cuda").bfloat16()
    k, v = (torch.randn(1, t, hkv, d, generator=gen,
                        device="cuda").bfloat16() for _ in range(2))
    seg = (torch.arange(t, device="cuda") < valid).int()[None]
    nq = -(-t // TILE)
    iq = torch.arange(nq, device="cuda")
    cut = torch.stack([torch.zeros_like(iq), iq], 1).int()
    pos = torch.arange(t, device="cuda")
    mask = ((seg[0, :, None] > 0) & (seg[0, None, :] > 0)
            & (pos[:, None] >= pos[None]))[None, None]
    return ov_kernel_entry(
        kname, f"{label} T={t} valid={valid} Hq={hq} Hkv={hkv} (n_rep "
        f"{hq // hkv}) D={d}",
        lambda: A.flash_varlen_fwd(q, k, v, seg, seg, causal=True),
        lambda: A.flash_plain(q, k, v, seg, seg, causal=True),
        lambda: A.flash_varlen_fwd(q, k, v, seg, seg, causal=True,
                                   kv_bounds=cut),
        (2 * hq + 2 * hkv) * t * d * 2 + t * 8,
        4 * d * hq * (valid * (valid + 1) // 2),
        lambda: sdpa_ms(q, k, v, mask),
        lambda got: bool((got[:, seg[0] == 0] == 0).all()), tag=tag)


def diag_entry(kname, label, q, k, v, wnp, tag) -> dict:
    """K4 on q / k / v [1, S, H, D] with window segments ``wnp`` (numpy
    [S]) against its plain version (fault: the last key of every window
    dropped, compared on the other rows), with ms, bound and one SDPA
    call (``ov_kernel_entry``)."""
    import numpy as np
    import torch

    from visionselector_tpu_torch.kernels import attention as A
    from visionselector_tpu_torch.tools import diag_floor

    n, h, d = q.shape[1], q.shape[2], q.shape[3]
    wseg = torch.as_tensor(wnp, device="cuda")[None].int()
    ids, first_rev = np.unique(wnp[::-1], return_index=True)
    last = (len(wnp) - 1 - first_rev)[ids > 0]
    cut = wnp.copy()
    cut[last] = 0
    cut = torch.as_tensor(cut, device="cuda")[None].int()
    keep = torch.as_tensor(np.setdiff1d(np.arange(n), last), device="cuda")
    wpairs = int(sum((wnp == j).sum() ** 2 for j in np.unique(wnp) if j > 0))
    wmask = ((wseg[0, :, None] == wseg[0, None, :])
             & (wseg[0, None, :] > 0))[None, None]
    return ov_kernel_entry(
        kname, f"{label} S={n} H={h} D={d}",
        lambda: A.diag_attn_fwd(q, k, v, wseg),
        lambda: A.diag_plain(q, k, v, wseg),
        (lambda: A.diag_attn_fwd(q, k, v, cut)[:, keep],
         lambda: A.diag_plain(q, k, v, wseg)[:, keep]),
        diag_floor.needed_bytes(wseg, h, d), 4 * d * h * wpairs,
        lambda: sdpa_ms(q, k, v, wmask),
        lambda got: bool((got[:, wseg[0] == 0] == 0).all()), tag=tag)


def tp_kernels(cfg) -> dict:
    """18(b): the kernels at the tensor-parallel ranks' shapes against
    their plain versions (seeded bf16): K1 causal at the 3B's tp 2 heads
    (8 query on 1 kv head, n_rep 8) at the selector's and ``orig``'s
    prefill lengths, and at the 7B's tp 2 heads (14 / 2, n_rep 7); K5 at
    n_rep 8, t_c 1 over the 8-slot pool, t_c 8 and 32 over one slot of the
    ``orig`` cache, bf16 and int8; each with its planted fault, ms, bound
    and one SDPA call. Returns the kernels line's entries."""
    import torch

    from visionselector_tpu_torch.core.config import qwen25vl_7b
    from visionselector_tpu_torch.models.qwen25vl.lm import tp_text_config

    gen = torch.Generator(device="cuda").manual_seed(SEED + 24)
    out = {}

    def causal(kname, tc, t, valid):
        return causal_k1_entry(kname, f"tp {TP_WORLD}", tc, t, valid, gen,
                               "[tp-kernel]")

    tc = tp_text_config(cfg.text, TP_WORLD)
    sel = causal("flash_varlen_fwd_tp2", tc, 384, 294)
    orig = causal("flash_varlen_fwd_tp2", tc, 1664, 1302)
    out["flash_varlen_fwd_tp2"] = dict(sel, max_abs_err=max(
        sel["max_abs_err"], orig["max_abs_err"]))
    causal("flash_varlen_fwd_7b_tp2", tp_text_config(qwen25vl_7b().text,
                                                     TP_WORLD), 384, 294)
    hkv, dh = tc.num_key_value_heads, tc.head_dim

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").bfloat16()

    out["decode_blocked_fwd_tp2"] = spec_k5_cases(tc, [
        ("8-slot pool", rnd(POOL_SLOTS, POOL_ROWS, hkv, dh),
         rnd(POOL_SLOTS, POOL_ROWS, hkv, dh),
         torch.tensor(DECODE_LENS, device="cuda"))],
        "decode_blocked_fwd_tp2", gen, t_c=1, tag="[tp-kernel]")
    k1, v1 = (rnd(1, ORIG_CACHE_ROWS, hkv, dh) for _ in range(2))
    for t_c in (TP_SPEC_M + 1, 32):
        out[f"decode_blocked_fwd_tp2_t_c{t_c}"] = spec_k5_cases(
            tc, [("one slot, orig cache", k1, v1,
                  torch.tensor([ORIG_BASE_LEN], device="cuda"))],
            f"decode_blocked_fwd_tp2_t_c{t_c}", gen, t_c=t_c,
            tag="[tp-kernel]")
    del k1, v1
    seven = tp_text_config(qwen25vl_7b().text, TP_WORLD)
    shape = (POOL_SLOTS, POOL_ROWS, seven.num_key_value_heads,
             seven.head_dim)
    spec_k5_cases(seven, [("8-slot pool", rnd(*shape), rnd(*shape),
                           torch.tensor(DECODE_LENS, device="cuda"))],
                  "decode_blocked_fwd_7b_tp2", gen, t_c=1,
                  tag="[tp-kernel]")
    return out


def sp_kernels(cfg, engine, req) -> dict:
    """18(c): the kernels at ``vit_forward_sp``'s shapes over TP_WORLD
    shards of phase 3's window-aligned batch (S 6,144, local S 3,072;
    seeded bf16 q / k / v at the 3B ViT's 16 heads of 80), each shard
    against its plain version within ULP_LIMIT, with ms, bound and one
    SDPA call: K1 with the shard's queries and segment ids against the
    gathered keys and segment ids of all S rows (fault: the other shards'
    kv tiles dropped from the bounds, as if k / v were not gathered); K4
    at the local S on the shard's window segments (fault: the last key of
    every window dropped, compared on the other rows). Returns the
    kernels line's entries (shard 0's times, the larger error)."""
    import numpy as np
    import torch

    from visionselector_tpu_torch.kernels import attention as A

    vb = engine._prep_vision(req["input_ids"], req["pixel_values"],
                             req["grid_thw"], req["grid_thw"], None,
                             None).vb
    gen = torch.Generator(device="cuda").manual_seed(SEED + 25)
    h, d = cfg.vision.num_heads, cfg.vision.head_dim
    s = vb.pixel_values.shape[0]
    ls = s // TP_WORLD
    k, v = (torch.randn(1, s, h, d, generator=gen, device="cuda").bfloat16()
            for _ in range(2))
    sg = torch.as_tensor(np.asarray(vb.full_seg_ids),
                         device="cuda")[None].int()
    wall = np.asarray(vb.window_seg_ids)
    found = {"flash_varlen_fwd_sp2": [], "diag_attn_fwd_sp2": []}
    for i in range(TP_WORLD):
        rows = slice(i * ls, (i + 1) * ls)
        q = torch.randn(1, ls, h, d, generator=gen, device="cuda").bfloat16()
        fseg = sg[:, rows]
        own = torch.tensor([[i * ls // TILE, (i + 1) * ls // TILE]],
                           device="cuda").int().repeat(ls // TILE, 1)
        pairs = int(sum((fseg == j).sum().item() * (sg == j).sum().item()
                        for j in torch.unique(fseg).tolist() if j > 0))
        mask = ((fseg[0, :, None] == sg[0, None, :])
                & (sg[0, None, :] > 0))[None, None]
        found["flash_varlen_fwd_sp2"].append(ov_kernel_entry(
            "flash_varlen_fwd_sp2", f"shard {i} of {TP_WORLD}: Sq={ls} "
            f"against gathered Sk={s} H={h} D={d}",
            lambda: A.flash_varlen_fwd(q, k, v, fseg, sg),
            lambda: A.flash_plain(q, k, v, fseg, sg),
            lambda: A.flash_varlen_fwd(q, k, v, fseg, sg, kv_bounds=own),
            (2 * ls + 2 * s) * h * d * 2 + (ls + s) * 4, 4 * d * h * pairs,
            lambda: sdpa_ms(q, k, v, mask),
            lambda got: bool((got[:, fseg[0] == 0] == 0).all()),
            tag="[sp-kernel]"))
        found["diag_attn_fwd_sp2"].append(diag_entry(
            "diag_attn_fwd_sp2", f"shard {i} of {TP_WORLD}: local", q,
            k[:, rows], v[:, rows], wall[rows], "[sp-kernel]"))
    return {name: dict(cases[0], max_abs_err=max(
        c["max_abs_err"] for c in cases)) for name, cases in found.items()}


def _counted(fn):
    """(fn's result, the launch counts of its run): zeroed just before,
    read just after."""
    from visionselector_tpu_torch.kernels import attention as A

    from visionselector_tpu_torch.kernels import wq_matmul as wq

    zero_counts()
    res = fn()
    return res, dict(launch_counts(), causal=A.FLASH_CAUSAL_LAUNCHES,
                     by_rows=dict(A.DECODE_LAUNCHES_BY_ROWS),
                     wq=wq.WQ_LAUNCHES, wq_dequant=wq.WQ_DEQUANT_LAUNCHES)


def _drive_batcher(engine, reqs, kv_quant):
    """A 2-slot ``ContinuousBatcher`` without its worker thread, driven as
    a tensor-parallel follower is (the same operations on every rank):
    both requests admitted, then decode dispatches until both finish.
    Returns each request's tokens."""
    from visionselector_tpu_torch.models.qwen25vl.continuous import (
        ContinuousBatcher,
        unwire_item,
    )

    bat = ContinuousBatcher(engine, n_slots=2, t_max=2048, chunk=8,
                            kv_quant=kv_quant, worker=False)
    items = [unwire_item(dict(
        request=r, max_new=TP_NEW_TOKENS, eos=(-1,), temperature=0.0,
        top_p=1.0, seed=0, top_k=0, repetition_penalty=1.0,
        t_submit=time.perf_counter())) for r in reqs]
    for slot, item in enumerate(items):
        bat._op("admit", item, slot)
    while any(bat.live):
        bat._op("dispatch")
    return [item["result"].tokens for item in items], bat.pool


def parallel_rank(rank, world, init_method, results):
    """One rank of phase 18's world (b, c): joins it over gloo on cuda:0,
    builds the seeded 3B (phase 3's weights), runs 18(c)'s sequence- and
    expert-parallel forwards, then shards the decoder (``tensor_parallel``)
    and runs the tensor-parallel request (counted), speculative decoding
    at m = TP_SPEC_M and the choices (K5 at t_c 8 and 32, counted), the
    2-slot batcher on bf16 and int8 pools, and the request under each
    ``--quantize`` spec (the whole decoder quantized, as ``load_model``
    does, then sharded; kernels A and B counted). Puts (rank, results)."""
    import copy
    import dataclasses
    import traceback

    import numpy as np
    import torch
    import torch.distributed as dist

    out = {}
    try:
        from visionselector_tpu_torch.core.config import (
            TextConfig,
            qwen25vl_3b,
        )
        from visionselector_tpu_torch.core.mesh import (
            init_world,
            make_mesh,
            tensor_parallel,
        )
        from visionselector_tpu_torch.kernels import attention as A
        from visionselector_tpu_torch.models.qwen25vl import lm as L
        from visionselector_tpu_torch.models.qwen25vl import model as M
        from visionselector_tpu_torch.models.qwen25vl import vit as V
        from visionselector_tpu_torch.models.qwen25vl.weights import (
            init_params,
        )

        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        init_world(rank, world, init_method, "gloo")
        mesh = make_mesh(1, world, device="cuda", backend="gloo")
        cfg = qwen25vl_3b()
        params = init_params(cfg, torch.Generator(device="cuda").manual_seed(
            SEED), "cuda", torch.bfloat16)
        input_ids, pixels, grid = request(cfg)
        req = dict(input_ids=input_ids, pixel_values=pixels, grid_thw=grid)
        eng = M.QwenVLEngine(cfg, params, use_selector=True, budget=0.2,
                             device="cuda")
        p = eng._prep_vision(input_ids, pixels, grid, grid, None, None)
        vb = eng._vision_tensors(p.vb)
        with torch.no_grad():  # 18(c) sequence parallel
            ref = V.vit_forward(params.visual, **vb)
            args = [vb[k] for k in ("pixel_values", "rot_pos_ids",
                                    "window_seg_ids", "full_seg_ids",
                                    "reverse_index")]
            V.vit_forward_sp(params.visual, *args, mesh)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sp, counts = _counted(lambda: V.vit_forward_sp(
                params.visual, *args, mesh))
            torch.cuda.synchronize()
            sp_s = time.perf_counter() - t0
        n = p.n
        diff = (sp[:n].float() - ref[:n].float()).abs().max().item()
        out["sp"] = dict(rel=diff / ref[:n].float().abs().max().item(),
                         ulps=bf16_ulp_err(sp[:n], ref[:n]), wall_s=sp_s,
                         counts=counts, s_pad=int(vb["pixel_values"].shape[0]))
        del ref, sp
        tc = dataclasses.replace(TextConfig(), hidden_size=MOE_HIDDEN,
                                 num_experts=128)  # 18(c) expert parallel
        layer = L.DecoderLayer(tc, "cuda", torch.bfloat16)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 18)
        with torch.no_grad():
            for t in layer.parameters():
                t.normal_(0.0, 0.02, generator=gen)
            x = torch.randn(1, MOE_ROWS[1], MOE_HIDDEN, generator=gen,
                            device="cuda", dtype=torch.bfloat16)
            ep = L.moe_mlp_ep(x, layer, tc, mesh)
            dense = L._moe_mlp(x, layer, tc)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            L.moe_mlp_ep(x, layer, tc, mesh)
            torch.cuda.synchronize()
            out["ep"] = dict(ulps=bf16_ulp_err(ep, dense),
                             err=(ep.float() - dense.float()).abs().max()
                             .item(), wall_s=time.perf_counter() - t0)
        del layer, x, ep, dense
        full_bytes = lm_bytes(params.lm)
        quantized = {}  # 18(b) --quantize: quantized whole, then sharded
        for spec in QUANT_SPECS:
            lm_q = copy.deepcopy(params.lm)
            L.quantize_lm_params(lm_q, *L.parse_quantize_spec(spec))
            quantized[spec] = L.shard_lm(lm_q, mesh)
        cfg, params = tensor_parallel(cfg, params, mesh)  # 18(b)
        torch.cuda.empty_cache()
        eng = M.QwenVLEngine(cfg, params, use_selector=True, budget=0.2,
                             device="cuda")
        eng.generate(**req, max_new_tokens=2)  # warm-up
        t0 = time.perf_counter()
        res, counts = _counted(lambda: eng.generate(
            **req, max_new_tokens=TP_NEW_TOKENS, eos_token_ids=(-1,)))
        out["generate"] = dict(
            tokens=res.tokens, logits=res.logits.cpu().numpy(), counts=counts,
            wall_s=time.perf_counter() - t0,
            prefill_s=res.prefill_seconds,
            selected=res.selected_indices.tolist(),
            heads=(cfg.text.num_attention_heads,
                   cfg.text.num_key_value_heads),
            lm_bytes=(full_bytes, lm_bytes(params.lm)),
            rank_memory=torch.cuda.max_memory_allocated())
        spec, counts = _counted(lambda: M.generate_speculative(
            eng, input_ids, pixels, grid, max_new_tokens=2 * TP_NEW_TOKENS,
            propose_len=TP_SPEC_M, eos_token_ids=(-1,)))
        plain = eng.generate(**req, max_new_tokens=2 * TP_NEW_TOKENS,
                             eos_token_ids=(-1,))
        out["spec"] = dict(same=spec.tokens == plain.tokens, counts=counts)
        choices = [np.arange(300, 300 + c) for c in CHOICE_LENS]
        scores, counts = _counted(lambda: M.run_loglikelihood_choices(
            eng, input_ids, choices, pixel_values=pixels, grid_thw=grid))
        out["choices"] = dict(scores=[float(s[0]) for s in scores],
                              counts=counts)
        text = dict(input_ids=np.asarray(PROMPT_BEFORE + PROMPT_AFTER,
                                         np.int64))
        one_shot = [eng.generate(**r, max_new_tokens=TP_NEW_TOKENS,
                                 eos_token_ids=(-1,)).tokens
                    for r in (req, text)]
        for quant in (None, "int8"):
            toks, pool = _drive_batcher(eng, [req, text], quant)
            out[f"batcher_{quant or 'bf16'}"] = dict(
                tokens=toks, one_shot=one_shot,
                pool_bytes=pool.k.nbytes + pool.v.nbytes)
        del eng
        for spec, lm_q in quantized.items():
            eng = M.QwenVLEngine(cfg, M.QwenVLParams(
                params.visual, lm_q, params.scorer), use_selector=True,
                budget=0.2, device="cuda")
            res, counts = _counted(lambda: eng.generate(
                **req, max_new_tokens=TP_NEW_TOKENS, eos_token_ids=(-1,)))
            out[f"quant_{spec}"] = dict(
                tokens=res.tokens, logits=res.logits.cpu().numpy(),
                counts=counts, lm_bytes=lm_bytes(lm_q))
    except Exception:  # noqa: BLE001 — the parent raises it
        out["error"] = traceback.format_exc()
    results.put((rank, out))
    if dist.is_initialized():
        dist.destroy_process_group()


def spawn_world(target, tmp, name, *args, timeout=TP_TIMEOUT) -> list:
    """Spawn TP_WORLD ranks of ``target(rank, world, init_method, *args,
    results)``, wait for their results and stop them; raises with a
    rank's traceback."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    init = f"file://{os.path.join(tmp, name + '_rendezvous')}"
    procs = [ctx.Process(target=target,
                         args=(r, TP_WORLD, init, *args, results))
             for r in range(TP_WORLD)]
    for proc in procs:
        proc.start()
    try:
        got = dict(results.get(timeout=timeout) for _ in procs)
    finally:
        for proc in procs:
            proc.join(60)
            if proc.is_alive():
                proc.kill()
                proc.join()
    for rank in range(TP_WORLD):
        if "error" in got[rank]:
            raise AssertionError(f"{name} rank {rank}:\n"
                                 f"{got[rank]['error']}")
    return [got[r] for r in range(TP_WORLD)]


def parallel_phase(out_dir, tmp):
    """Phase 18: (a) the W8A8 3B ViT (``w8a8_phase``); (b) the kernels at
    the tensor-parallel shapes (``tp_kernels``), then the world: the
    tensor-parallel request's first token equal to the unsharded engine's
    on the card and its logits within TEACHER_TOL of max |logit| (phase
    3's rule), the launches of its counted run (per prefill 28 K4 + 4 + 36
    K1, 36 K5 a decode step, at the local 8 / 1 heads), speculative tokens
    equal to plain decode's, the choices, the 2-slot batcher's tokens equal
    to one-shot's on bf16 and int8 pools, the per-rank LM bytes, the
    request under each ``--quantize`` spec against the unsharded quantized
    engine's with kernels A and B counted; (c) the kernels at the
    sequence-parallel shapes (``sp_kernels``), ``moe_mlp_ep`` against
    ``_moe_mlp`` and ``vit_forward_sp`` against ``vit_forward``, each
    within ULP_LIMIT bf16 ulps. Raises if any check failed; returns
    (launches, kernels line entries)."""
    import copy
    import gc

    import torch

    from visionselector_tpu_torch.core.config import qwen25vl_3b
    from visionselector_tpu_torch.models.qwen25vl.lm import (
        parse_quantize_spec,
        quantize_lm_params,
    )
    from visionselector_tpu_torch.models.qwen25vl.model import (
        QwenVLEngine,
        QwenVLParams,
    )
    from visionselector_tpu_torch.models.qwen25vl.weights import init_params

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = qwen25vl_3b()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(
        SEED), "cuda", torch.bfloat16)
    input_ids, pixels, grid = request(cfg)
    req = dict(input_ids=input_ids, pixel_values=pixels, grid_thw=grid)
    engine = QwenVLEngine(cfg, params, use_selector=True, budget=0.2,
                          device="cuda")
    checks, secs = {}, {}
    t0 = time.perf_counter()
    w8 = w8a8_phase(cfg, params, engine, req, out_dir, checks)
    secs["a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    kernels = tp_kernels(cfg)
    kernels.update(sp_kernels(cfg, engine, req))
    secs["b, c kernels"] = time.perf_counter() - t0
    ref = engine.generate(**req, max_new_tokens=TP_NEW_TOKENS,
                          eos_token_ids=(-1,))
    quant_ref = {}  # the unsharded engine under each --quantize spec
    for spec in QUANT_SPECS:
        lm_q = copy.deepcopy(params.lm)
        quantize_lm_params(lm_q, *parse_quantize_spec(spec))
        quant_ref[spec] = QwenVLEngine(
            cfg, QwenVLParams(params.visual, lm_q, params.scorer),
            use_selector=True, budget=0.2, device="cuda").generate(
                **req, max_new_tokens=TP_NEW_TOKENS, eos_token_ids=(-1,))
        del lm_q
    del engine, params
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = spawn_world(parallel_rank, tmp, "phase18")
    secs["b, c world"] = time.perf_counter() - t0
    r0 = ranks[0]
    g = r0["generate"]
    lg, want = torch.from_numpy(g["logits"]), ref.logits.float().cpu()
    scale = want.abs().max().item()
    err = (lg - want).abs().max().item()
    print(f"[tp] {TP_WORLD} ranks on one card over gloo, local heads "
          f"{g['heads']}: tokens {g['tokens']} (unsharded {ref.tokens}); "
          f"first-token logits max_abs_diff {err!r} of max |logit| "
          f"{scale!r} (limit {TEACHER_TOL} of it); selected equal "
          f"{g['selected'] == ref.selected_indices.tolist()}; request wall "
          f"{g['wall_s']!r} s, prefill {g['prefill_s']!r} s (ranks share "
          f"one card: not a speed); LM bytes a rank {g['lm_bytes'][1]} of "
          f"{g['lm_bytes'][0]} ({g['lm_bytes'][1] / g['lm_bytes'][0]!r}); "
          f"peak memory a rank {g['rank_memory']}; launches {g['counts']}",
          flush=True)
    n_layers = cfg.text.num_hidden_layers
    depth, n_full = cfg.vision.depth, len(cfg.vision.fullatt_block_indexes)
    steps = ov_steps(ref, TP_NEW_TOKENS)
    checks["TP: first token = unsharded"] = g["tokens"][0] == ref.tokens[0]
    checks["TP: logits within TEACHER_TOL"] = err <= TEACHER_TOL * scale
    checks["TP: every rank the same tokens"] = all(
        r["generate"]["tokens"] == g["tokens"] for r in ranks)
    c = g["counts"]
    checks["TP: launches 28 K4 + 40 K1 (36 causal) + 36 K5 a step"] = (
        c["diag_attn_fwd"] == depth - n_full
        and c["flash_varlen_fwd"] == n_full + n_layers
        and c["causal"] == n_layers
        and c["decode_blocked_fwd"] == n_layers * steps)
    checks["TP: LM bytes about half"] = (
        g["lm_bytes"][1] < 0.55 * g["lm_bytes"][0])
    s = r0["spec"]
    print(f"[tp] speculative m={TP_SPEC_M}: tokens equal plain decode's "
          f"{s['same']}; K5 launches by rows {s['counts']['by_rows']}",
          flush=True)
    checks["TP: speculative = plain"] = s["same"]
    ch = r0["choices"]
    print(f"[tp] choices {CHOICE_LENS}: log-likelihoods {ch['scores']}; K5 "
          f"launches by rows {ch['counts']['by_rows']}", flush=True)
    for quant in ("bf16", "int8"):
        b = r0[f"batcher_{quant}"]
        print(f"[tp] 2-slot batcher, {quant} pool ({b['pool_bytes']} bytes "
              f"a rank): tokens {b['tokens']}, one-shot {b['one_shot']}",
              flush=True)
        checks[f"TP batcher {quant}: first tokens = one-shot"] = all(
            t[0] == o[0] for t, o in zip(b["tokens"], b["one_shot"]))
        if quant == "bf16":
            checks["TP batcher bf16: tokens = one-shot"] = (
                b["tokens"] == b["one_shot"])
    per = 7 * n_layers  # kernel A per decode step, kernel B per prefill
    for spec in QUANT_SPECS:
        qr, want_q = r0[f"quant_{spec}"], quant_ref[spec]
        lq = torch.from_numpy(qr["logits"])
        wl = want_q.logits.float().cpu()
        q_err, q_scale = (lq - wl).abs().max().item(), wl.abs().max().item()
        qc = qr["counts"]
        q_steps = qc["decode_blocked_fwd"] // n_layers
        print(f"[tp] --quantize {spec} over {TP_WORLD} ranks: tokens "
              f"{qr['tokens']} (unsharded {want_q.tokens}); first-token "
              f"logits max_abs_diff {q_err!r} of max |logit| {q_scale!r} "
              f"(limit {TEACHER_TOL} of it); LM bytes a rank "
              f"{qr['lm_bytes']}; kernel A launches {qc['wq']} ({q_steps} "
              f"decode steps), kernel B {qc['wq_dequant']}", flush=True)
        checks[f"TP {spec}: first token = unsharded"] = (
            qr["tokens"][0] == want_q.tokens[0])
        checks[f"TP {spec}: logits within TEACHER_TOL"] = (
            q_err <= TEACHER_TOL * q_scale)
        checks[f"TP {spec}: every rank the same tokens"] = all(
            r[f"quant_{spec}"]["tokens"] == qr["tokens"] for r in ranks)
        checks[f"TP {spec}: kernel A {per} a step, kernel B {per} a "
               f"prefill"] = (qc["wq"] == per * q_steps
                              and q_steps == len(qr["tokens"]) - 1
                              and qc["wq_dequant"] == per)
    sp, ep = r0["sp"], r0["ep"]
    print(f"[sp] vit_forward_sp over {TP_WORLD} ranks, S={sp['s_pad']}: "
          f"max |diff| / max |value| against vit_forward {sp['rel']!r}, "
          f"{sp['ulps']!r} bf16 ulps (limit {ULP_LIMIT}); wall "
          f"{sp['wall_s']!r} s; launches {sp['counts']}", flush=True)
    print(f"[ep] moe_mlp_ep over {TP_WORLD} ranks (64 experts each), "
          f"{MOE_ROWS[1]} rows: {ep['ulps']!r} bf16 ulps of _moe_mlp (limit "
          f"{ULP_LIMIT}), max_abs_err {ep['err']!r}; wall {ep['wall_s']!r} "
          f"s", flush=True)
    checks["SP: vit_forward_sp = vit_forward"] = sp["ulps"] <= ULP_LIMIT
    checks["SP: 28 K4 + 4 K1 a rank"] = (
        sp["counts"]["diag_attn_fwd"] == depth - n_full
        and sp["counts"]["flash_varlen_fwd"] == n_full)
    checks["EP: moe_mlp_ep = _moe_mlp"] = ep["ulps"] <= ULP_LIMIT
    launches = {
        "flash_varlen_fwd_tp2": c["causal"],
        "decode_blocked_fwd_tp2": c["by_rows"].get(1, 0),
        f"decode_blocked_fwd_tp2_t_c{TP_SPEC_M + 1}":
            s["counts"]["by_rows"].get(TP_SPEC_M + 1, 0),
        "decode_blocked_fwd_tp2_t_c32": ch["counts"]["by_rows"].get(32, 0),
        "wq_dequant_fwd_tp2": r0["quant_int8"]["counts"]["wq_dequant"],
        **{WQ_ENTRY[spec] + "_tp2": r0[f"quant_{spec}"]["counts"]["wq"]
           for spec in QUANT_SPECS},
        "flash_varlen_fwd_sp2": sp["counts"]["flash_varlen_fwd"],
        "diag_attn_fwd_sp2": sp["counts"]["diag_attn_fwd"],
    }
    bad = [k for k, ok in checks.items() if not ok]
    print(f"[parallel] checks: {checks}", flush=True)
    print(f"[parallel] phase seconds {time.perf_counter() - t_phase!r}; "
          f"parts {secs}; W8A8 {w8}", flush=True)
    if bad:
        raise AssertionError(f"W8A8 / parallel phase failed: {bad}")
    return launches, kernels


# Phase 19 (data- and pipeline-parallel training, the training CLI under
# torch.distributed.run, the warm-up CLI). Its world is phase 18's kind:
# TP_WORLD spawned ranks sharing the card over gloo, each rebuilding the 3B
# from its seed. (a) trains on phase 6's batch (one sample a rank); (b)
# pipelines the 3B decoder over 2 stages at B = 2, T = 1,536, M = 2, with
# phase 6.1's padding tails; the card's one process computes both
# references first and leaves them in a file the ranks read.
PP_MICRO = 2
PP_VALID = (TRAIN_T_BUCKET - 202, TRAIN_T_BUCKET - 335)
# losses of the data-parallel steps against the same steps in one process:
# the ranks run the decoder at B = 1 where the process runs it at B = 2, so
# cuBLAS may pick other GEMM kernels; bf16 rounding stays far below this
DP_LOSS_TOL = 1e-3
DP_CLI_STEPS = 2
PHASE19_TIMEOUT = 900  # seconds for the world of phase 19


def _digest(module) -> str:
    """A hash of a module's parameters' bits (bit-equality across
    processes)."""
    import hashlib

    h = hashlib.sha256()
    for name, p in sorted(module.named_parameters()):
        h.update(name.encode() + p.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def dp_steps(cfg, params, host, mesh=None) -> dict:
    """19(a)'s selector steps from the initial scorer at phase 6's schedule:
    2 at accumulation 1 on phase 6's batch, then 1 at accumulation 2 (the
    batch, then its samples in reverse order). With ``mesh`` this rank
    takes its part of each micro-batch (``batch_sharding``) and
    ``accumulate`` averages over the ranks. Returns the first update's
    scorer gradients, the losses, each step's launches (zeroed just before
    it, read just after) and the scorer's digest after the steps. With
    ``mesh``, also the planted fault: one update from the initial scorer
    at lr > 0 with the gradients left each rank's own (``data_mean``
    averaging the metrics only): its gradients and the scorer's digest."""
    import numpy as np
    import torch

    from visionselector_tpu_torch.core.mesh import batch_sharding
    from visionselector_tpu_torch.kernels import attention as A
    from visionselector_tpu_torch.train import train_step as TS
    from visionselector_tpu_torch.train.loss import to_device

    sched = TS.ScheduleConfig(total_steps=TRAIN_STEPS, lr=TRAIN_LR,
                              reg_weight_start=1.0, reg_weight_end=1.0)
    k_max = max(1, int(TRAIN_S_BUCKET // cfg.vision.spatial_merge_unit
                       * 0.2))
    rev = type(host)(*(np.ascontiguousarray(np.asarray(x)[::-1])
                       for x in host))
    local = batch_sharding(mesh) if mesh is not None else None
    micro = [to_device(b if local is None else type(b)(*map(local, b)),
                       "cuda") for b in (host, rev)]
    start = {n: p.detach().clone() for n, p in
             params.scorer.named_parameters()}
    update = TS._update

    def recorder(into):
        def spy(state, s):
            if not into:
                into.update({n: p.grad.float().clone()
                             for n, p in state.trainable().items()})
            return update(state, s)
        return spy

    grads, losses, counts = {}, [], []
    state = TS.init_train_state(params, sched)
    state.mesh = mesh
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with patched(TS, "_update", recorder(grads)):
        for i in range(3):
            zero_counts()
            state, m = TS.train_step_accum(state, params,
                                           micro[:1 + i // 2], cfg, k_max,
                                           sched)
            torch.cuda.synchronize()
            counts.append(dict(launch_counts(),
                               causal=A.FLASH_CAUSAL_LAUNCHES,
                               grad=A.FLASH_GRAD_LAUNCHES))
            losses.append(float(m["loss"]))
    out = dict(grads=grads, losses=losses, counts=counts,
               scorer=_digest(params.scorer),
               wall_s=time.perf_counter() - t0)
    if mesh is not None:
        with torch.no_grad():
            for n, p in params.scorer.named_parameters():
                p.copy_(start[n])
        state = TS.init_train_state(params, sched)
        state.mesh, state.step = mesh, 1  # lr > 0 from update 1 on
        mean, bad = TS.data_mean, {}
        with patched(TS, "data_mean",
                     lambda mesh, g, metrics: mean(mesh, [], metrics)), \
                patched(TS, "_update", recorder(bad)):
            TS.train_step_accum(state, params, micro[:1], cfg, k_max, sched)
        out.update(fault_grads=bad, fault_scorer=_digest(params.scorer))
    return out


def pp_inputs(lm, cfg):
    """19(b)'s inputs, the same on every process: the embeddings of
    seeded token ids [2, 1,536], 1-D positions on the three rope axes,
    PP_VALID rows valid, and a seeded fp32 cotangent (the loss is
    sum(h * g))."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 19)
    b, t = TRAIN_BATCH, TRAIN_T_BUCKET
    ids = torch.randint(100, 5000, (b, t), generator=gen, device="cuda")
    with torch.no_grad():
        x = lm.embed_tokens[ids].clone()
    pos = torch.arange(t, device="cuda").expand(3, b, t).contiguous()
    valid = torch.tensor(PP_VALID, device="cuda")
    seg = (torch.arange(t, device="cuda")[None] < valid[:, None]).int()
    g = torch.randn(b, t, cfg.text.hidden_size, generator=gen,
                    device="cuda")
    return x, pos, seg, g


def pp_reference(cfg, lm) -> dict:
    """``lm_prefill_layers`` over all 36 layers on 19(b)'s inputs in one
    process: the hidden states and the gradients of sum(h * g) with
    respect to the input and to the q kernel of each stage's first layer
    (layers 0 and 18)."""
    from visionselector_tpu_torch.models.qwen25vl.lm import lm_prefill_layers

    n = cfg.text.num_hidden_layers
    x, pos, seg, g = pp_inputs(lm, cfg)
    x.requires_grad_(True)
    firsts = [lm.layers[i].q_kernel for i in (0, n // TP_WORLD)]
    for w in firsts:
        w.requires_grad_(True)
    h, _ = lm_prefill_layers(lm, range(n), x, pos, seg)
    (h.float() * g).sum().backward()
    out = {"h": h.detach(), "x_grad": x.grad, 0: firsts[0].grad.clone(),
           n // TP_WORLD: firsts[1].grad.clone()}
    for w in firsts:
        w.requires_grad_(False)
        w.grad = None
    return out


def pp_run(cfg, lm, mesh, ref) -> dict:
    """19(b) on one rank: the decoder staged (``stage_layers``), then
    ``lm_prefill_layers_pp`` on ``pp_inputs`` with a gradient (launches of
    its forward and of its backward counted apart), held to ``ref``; the
    planted faults, patched into the schedule (the last stage's
    microbatches swapped; the output's gradient summed over the stages);
    the decoder's bytes before and after staging."""
    import torch

    from visionselector_tpu_torch.core import collectives
    from visionselector_tpu_torch.core.pipeline import (
        _Pipe,
        lm_prefill_layers_pp,
        stage_layers,
    )
    from visionselector_tpu_torch.kernels import attention as A

    def counts():
        return dict(flash=A.FLASH_LAUNCHES, causal=A.FLASH_CAUSAL_LAUNCHES,
                    grad=A.FLASH_GRAD_LAUNCHES)

    def layer_bytes():
        return sum(t.nbytes for t in lm.layers.parameters())

    before = (lm_bytes(lm), layer_bytes())
    x, pos, seg, g = pp_inputs(lm, cfg)
    stage_layers(lm, mesh)
    first = lm.stage_layers[0]
    after = (lm_bytes(lm), layer_bytes())
    torch.cuda.empty_cache()
    w = lm.layers[0].q_kernel
    w.requires_grad_(True)

    def run():
        xg = x.clone().requires_grad_(True)
        w.grad = None
        h = lm_prefill_layers_pp(lm, xg, pos, seg, mesh, PP_MICRO)
        torch.cuda.synchronize()
        fwd = counts()
        zero_counts()
        (h.float() * g).sum().backward()
        torch.cuda.synchronize()
        return h.detach(), xg.grad, w.grad.clone(), fwd, counts()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    zero_counts()
    h, x_grad, w_grad, fwd, bwd = run()
    wall = time.perf_counter() - t0
    want = ref["h"]
    out = dict(
        first=first, bytes=(before, after), fwd=fwd, bwd=bwd, wall_s=wall,
        ulps=bf16_ulp_err(h, want),
        rel=((h.float() - want.float()).abs().max()
             / want.float().abs().max()).item(),
        x_err=rel_err(x_grad, ref["x_grad"]),
        w_err=rel_err(w_grad, ref[first]),
        finite=bool(torch.isfinite(h).all() and torch.isfinite(x_grad).all()))
    forward, backward = _Pipe.forward, _Pipe.backward

    def summed(pipe, grad_out, *rest):
        return backward(pipe, collectives.all_reduce(grad_out.clone(),
                                                     pipe.group), *rest)

    with torch.no_grad(), patched(
            _Pipe, "forward", lambda pipe, x_mb: forward(pipe, x_mb).flip(0)):
        swapped = lm_prefill_layers_pp(lm, x, pos, seg, mesh, PP_MICRO)
    out["swap_ulps"] = bf16_ulp_err(swapped, want)
    with patched(_Pipe, "backward", summed):
        _, xs, ws, _, _ = run()
    out["sum_err"] = max(rel_err(xs, ref["x_grad"]), rel_err(ws, ref[first]))
    w.requires_grad_(False)
    return out


def dp_pp_rank(rank, world, init_method, ref_path, results):
    """One rank of phase 19's world: joins it over gloo on cuda:0, makes
    the data mesh and the 2-stage mesh, builds the seeded 3B, runs
    ``dp_steps`` on its part of phase 6's batch (held to the one-process
    reference in ``ref_path``), drops the vision tower and the scorer, and
    runs ``pp_run`` on the decoder. Puts (rank, results)."""
    import traceback

    import torch
    import torch.distributed as dist

    out = {}
    try:
        from visionselector_tpu_torch.core.config import qwen25vl_3b
        from visionselector_tpu_torch.core.mesh import (
            data_mesh,
            init_world,
            stage_mesh,
        )
        from visionselector_tpu_torch.models.qwen25vl.weights import (
            init_params,
        )

        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        init_world(rank, world, init_method, "gloo")
        mesh = data_mesh(TRAIN_BATCH, device="cuda", backend="gloo")
        stages = stage_mesh(world, device="cuda", backend="gloo")
        ref = torch.load(ref_path, map_location="cuda", weights_only=False)
        cfg = qwen25vl_3b()
        params = init_params(cfg, torch.Generator(device="cuda").manual_seed(
            SEED), "cuda", torch.bfloat16)
        dp = dp_steps(cfg, params, train_batch(cfg), mesh)
        out["dp"] = dict(
            losses=dp["losses"], counts=dp["counts"], scorer=dp["scorer"],
            wall_s=dp["wall_s"], grad_err=grad_err(dp["grads"], ref["grads"]),
            fault_err=grad_err(dp["fault_grads"], ref["grads"]),
            fault_scorer=dp["fault_scorer"])
        lm = params.lm
        del params, dp
        torch.cuda.empty_cache()
        out["pp"] = pp_run(cfg, lm, stages, ref["pp"])
    except Exception:  # noqa: BLE001 — the parent raises it
        out["error"] = traceback.format_exc()
    results.put((rank, out))
    if dist.is_initialized():
        dist.destroy_process_group()


def dp_cli_start(procs, tmp, hf_dir):
    """19(c, d) started as processes of their own: ``api.train`` on phase
    6's reduced-depth directory under ``torch.distributed.run`` over 2
    ranks and the same command alone, and ``api.warmup`` on it."""
    common = ["--device", "cuda", "--model-path", hf_dir, "--batch-size",
              "2", "--total-steps", str(DP_CLI_STEPS), "--log-steps", "1"]
    start_cmd(procs, tmp, "train_dp", [
        sys.executable, "-m", "torch.distributed.run", "--standalone",
        "--nproc-per-node", str(TP_WORLD), "-m",
        "visionselector_tpu_torch.api.train", *common, "--output-dir",
        os.path.join(tmp, "train_dp")])
    start_cli(procs, tmp, "train", *common, "--output-dir",
              os.path.join(tmp, "train_one"), key="train_one")
    start_cli(procs, tmp, "warmup", "--device", "cuda", "--model-path",
              hf_dir, "--buckets", "1024,6144", "--micro-batch", "2")


def dp_cli_done(procs, tmp, checks):
    """19(c, d)'s checks: exit 0; the data-parallel run's log lines from
    rank 0 only, its losses within DP_LOSS_TOL of the one-process run's,
    its exported scorer within GRAD_TOL of each leaf's largest |value| of
    the other's; the warm-up's JSON lines (one per bucket, text-only,
    decode_batch 2)."""
    from visionselector_tpu_torch.core.safetensors import open_checkpoint

    logs, scorers = {}, {}
    for key in ("train_dp", "train_one"):
        rc, stdout, stderr, secs = finish_cli(procs, key)
        lines = [json.loads(ln) for ln in stdout.splitlines()
                 if ln.startswith("{")]
        logs[key] = (rc, lines)
        path = os.path.join(tmp, key, "importance_scorer.safetensors")
        if rc == 0 and os.path.isfile(path):
            get = open_checkpoint(path)
            scorers[key] = {n: get(n).float() for n in get.names}
        print(f"[dp-cli] {key}: rc={rc} in {secs!r} s; log lines {lines}"
              + ("" if rc == 0 else f"; stderr {stderr[-3000:]}"),
              flush=True)
    (rc2, dp_lines), (rc1, one_lines) = logs["train_dp"], logs["train_one"]
    checks["19c: both runs exit 0"] = rc2 == rc1 == 0
    checks["19c: log lines from rank 0 only"] = (
        [m.get("step") for m in dp_lines] == list(range(1, DP_CLI_STEPS + 1)))
    checks["19c: losses = one process's"] = bool(dp_lines) and len(
        dp_lines) == len(one_lines) and all(
        abs(a["loss"] - b["loss"]) <= DP_LOSS_TOL * abs(b["loss"])
        for a, b in zip(dp_lines, one_lines))
    errs = ({n: rel_err(t, scorers["train_one"][n])
             for n, t in scorers["train_dp"].items()}
            if len(scorers) == 2 else {})
    print(f"[dp-cli] exported scorers, data parallel against one process: "
          f"rel_err per leaf {errs!r} (limit {GRAD_TOL})", flush=True)
    checks["19c: exported scorer = one process's"] = bool(errs) and max(
        errs.values()) <= GRAD_TOL and scorers["train_dp"].keys() == \
        scorers["train_one"].keys()
    rc, stdout, stderr, secs = finish_cli(procs, "warmup")
    lines = [json.loads(ln) for ln in stdout.splitlines()
             if ln.startswith("{")]
    print(f"[warmup] api.warmup --buckets 1024,6144 --micro-batch 2 (cuda): "
          f"rc={rc} in {secs!r} s; lines {lines}"
          + ("" if rc == 0 else f"; stderr {stderr[-3000:]}"), flush=True)
    checks["19d: api.warmup exit 0 with its lines"] = rc == 0 and (
        [ln.get("bucket") for ln in lines if "bucket" in ln]
        == [1024, 6144, "text_only"]
        and [ln["decode_batch"] for ln in lines if "decode_batch" in ln]
        == [2] and "kernels_build_s" in lines[0]
        and all("patches" in ln for ln in lines[1:3]))


def dp_kernels(cfg, host) -> dict:
    """Phase 19's kernel entries: K1 causal at a data-parallel rank's LM
    shape (one sample of phase 6's batch: T 1,536, its valid rows, GQA
    16/2, D 128) and at a pipeline microbatch's (T 1,536, the second
    microbatch's PP_VALID[1] valid), K4 at one sample's ViT window layer
    (S 6,144, H 16, D 80, its window segments), each against its plain
    version with a planted fault, ms, bound and one SDPA call."""
    import numpy as np
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED + 26)
    out = {
        "flash_varlen_fwd_dp": causal_k1_entry(
            "flash_varlen_fwd_dp", "a data-parallel rank's sample",
            cfg.text, TRAIN_T_BUCKET, int(np.asarray(host.seg_ids)[0].sum()),
            gen, "[dp-kernel]"),
        "flash_varlen_fwd_pp": causal_k1_entry(
            "flash_varlen_fwd_pp", "a pipeline microbatch", cfg.text,
            TRAIN_T_BUCKET, PP_VALID[1], gen, "[pp-kernel]")}
    wnp = np.asarray(host.window_seg_ids)[0]
    h, d = cfg.vision.num_heads, cfg.vision.head_dim
    q, k, v = (torch.randn(1, len(wnp), h, d, generator=gen,
                           device="cuda").bfloat16() for _ in range(3))
    out["diag_attn_fwd_dp"] = diag_entry(
        "diag_attn_fwd_dp", "a data-parallel rank's sample: window layer",
        q, k, v, wnp, "[dp-kernel]")
    return out


def dp_pp_phase(out_dir, tmp, hf_dir):
    """Phase 19: 19(c, d)'s CLIs started; the kernels at the phase's
    shapes (``dp_kernels``); the one-process references (the 3B's selector
    steps of ``dp_steps`` at B = 2, ``pp_reference``), saved for the
    world; then the world (``dp_pp_rank``): (a) the ranks' losses within
    DP_LOSS_TOL of the one-process steps, their step-1 averaged scorer
    gradients within GRAD_TOL of its (``grad_err``), their scorers
    bit-equal, 28 K4 + 4 K1 + 36 causal K1 through FlashAttentionFn a
    micro-batch on rank 0, the planted fault (gradients not averaged)
    beyond GRAD_TOL and the ranks' scorers apart; (b) the pipelined hidden
    states within ULP_LIMIT bf16 ulps of each row's largest |value| of
    ``lm_prefill_layers`` (else, read as cuBLAS's per-shape choice, within
    TEACHER_TOL of max |value|; the rule used is printed), the gradients of
    the input and of each stage's first q kernel within GRAD_TOL, 18 x M
    causal K1 forward and as many recomputed under grad a rank, the layer
    bytes a rank half the whole, both planted faults beyond their limits;
    then 19(c, d)'s checks. Raises if any check failed; returns
    (launches, kernels line entries)."""
    import gc

    import torch

    from visionselector_tpu_torch.core.config import qwen25vl_3b
    from visionselector_tpu_torch.models.qwen25vl.weights import init_params

    t_phase = time.perf_counter()
    print(f"[dp] card: {nvidia_smi()}", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    checks, secs, procs = {}, {}, {}
    try:
        dp_cli_start(procs, tmp, hf_dir)
        cfg = qwen25vl_3b()
        host = train_batch(cfg)
        t0 = time.perf_counter()
        kernels = dp_kernels(cfg, host)
        secs["kernels"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        params = init_params(cfg, torch.Generator(device="cuda").manual_seed(
            SEED), "cuda", torch.bfloat16)
        one = dp_steps(cfg, params, host)
        ref = {"grads": {n: g.cpu() for n, g in one["grads"].items()},
               "pp": {k: v.cpu() for k, v in
                      pp_reference(cfg, params.lm).items()}}
        ref_path = os.path.join(tmp, "dp_pp_ref.pt")
        torch.save(ref, ref_path)
        del params, ref
        gc.collect()
        torch.cuda.empty_cache()
        secs["one process"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ranks = spawn_world(dp_pp_rank, tmp, "phase19", ref_path,
                            timeout=PHASE19_TIMEOUT)
        secs["world"] = time.perf_counter() - t0
        n_layers = cfg.text.num_hidden_layers
        depth, n_full = cfg.vision.depth, len(cfg.vision.fullatt_block_indexes)
        per = {"diag_attn_fwd": depth - n_full,
               "flash_varlen_fwd": n_full + n_layers, "causal": n_layers,
               "grad": n_layers}
        d0, d1 = ranks[0]["dp"], ranks[1]["dp"]
        loss_err = max(abs(a - b) / abs(b) for a, b in
                       zip(d0["losses"], one["losses"]))
        print(f"[dp] (a) selector steps over {TP_WORLD} ranks on one card "
              f"(gloo), one sample a rank: losses {d0['losses']} (one "
              f"process at B = 2: {one['losses']}; largest relative "
              f"difference {loss_err!r}, limit {DP_LOSS_TOL}); step-1 "
              f"averaged scorer gradients against one process's grad_err "
              f"{d0['grad_err']!r} / {d1['grad_err']!r} (ranks 0 / 1, limit "
              f"{GRAD_TOL}); scorers bit-equal {d0['scorer'] == d1['scorer']}"
              f"; launches a step on rank 0 {d0['counts']} (expected "
              f"{per} a micro-batch); wall {d0['wall_s']!r} s for 3 steps "
              f"(ranks share one card: not a speed; one process "
              f"{one['wall_s']!r} s)", flush=True)
        print(f"[control] (a) gradients not averaged: grad_err "
              f"{d0['fault_err']!r} / {d1['fault_err']!r} (must exceed "
              f"{GRAD_TOL}); scorers apart "
              f"{d0['fault_scorer'] != d1['fault_scorer']}", flush=True)
        checks["19a: losses = one process's"] = loss_err <= DP_LOSS_TOL
        checks["19a: step-1 gradients = one process's"] = max(
            d0["grad_err"], d1["grad_err"]) <= GRAD_TOL
        checks["19a: ranks' scorers bit-equal"] = d0["scorer"] == d1["scorer"]
        checks["19a: launches 28 K4 + 40 K1 (36 under grad) a micro-batch"] \
            = all(c["diag_attn_fwd"] == a * per["diag_attn_fwd"]
                  and c["flash_varlen_fwd"] == a * per["flash_varlen_fwd"]
                  and c["causal"] == a * per["causal"]
                  and c["grad"] == a * per["grad"]
                  for c, a in zip(d0["counts"], (1, 1, 2)))
        checks["19a: planted fault caught"] = (
            min(d0["fault_err"], d1["fault_err"]) > GRAD_TOL
            and d0["fault_scorer"] != d1["fault_scorer"])
        p0, p1 = ranks[0]["pp"], ranks[1]["pp"]
        ulps = max(p0["ulps"], p1["ulps"])
        rule = ("ULP_LIMIT" if ulps <= ULP_LIMIT else
                "TEACHER_TOL (the ranks run B = 1 microbatches where the "
                "reference runs B = 2: cuBLAS's per-shape GEMM choice)")
        half = n_layers // TP_WORLD
        for r, p in enumerate((p0, p1)):
            (lb, layb), (la, laya) = p["bytes"]
            print(f"[pp] (b) rank {r} (layers {p['first']}-"
                  f"{p['first'] + half - 1}): hidden {p['ulps']!r} bf16 ulps "
                  f"of each row's max |value| (limit {ULP_LIMIT}), max |diff| "
                  f"/ max |value| {p['rel']!r}; gradients rel_err input "
                  f"{p['x_err']!r}, layer {p['first']} q_kernel "
                  f"{p['w_err']!r} (limit {GRAD_TOL}); launches forward "
                  f"{p['fwd']}, backward {p['bwd']}; decoder layer bytes "
                  f"{laya} of {layb} ({laya / layb!r}), LM bytes {la} of "
                  f"{lb}; wall {p['wall_s']!r} s (ranks share one card: not "
                  f"a speed)", flush=True)
            print(f"[control] (b) rank {r}: last stage's microbatches "
                  f"swapped {p['swap_ulps']!r} ulps (must exceed "
                  f"{ULP_LIMIT}); output gradient summed over the stages "
                  f"rel_err {p['sum_err']!r} (must exceed {GRAD_TOL})",
                  flush=True)
        print(f"[pp] (b) hidden states held by {rule}", flush=True)
        pps = (p0, p1)
        checks["19b: hidden = one process's"] = all(
            p["finite"] for p in pps) and (
            ulps <= ULP_LIMIT or max(p["rel"] for p in pps) <= TEACHER_TOL)
        checks["19b: gradients = one process's"] = all(
            max(p["x_err"], p["w_err"]) <= GRAD_TOL for p in pps)
        checks["19b: 18 x M causal K1 forward + 18 x M recomputed a rank"] = \
            all(p["fwd"]["causal"] == p["fwd"]["flash"] == half * PP_MICRO
                and p["fwd"]["grad"] == 0
                and p["bwd"]["grad"] == p["bwd"]["causal"] == half * PP_MICRO
                for p in pps)
        checks["19b: layer bytes a rank half"] = all(
            p["bytes"][1][1] * TP_WORLD == p["bytes"][0][1] for p in pps)
        checks["19b: planted faults caught"] = all(
            p["swap_ulps"] > ULP_LIMIT and p["sum_err"] > GRAD_TOL
            for p in pps)
        t0 = time.perf_counter()
        dp_cli_done(procs, tmp, checks)
        secs["c, d (after the world)"] = time.perf_counter() - t0
    finally:
        for proc, _, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    launches = {
        "flash_varlen_fwd_dp": sum(c["flash_varlen_fwd"]
                                   for c in d0["counts"]),
        "diag_attn_fwd_dp": sum(c["diag_attn_fwd"] for c in d0["counts"]),
        "flash_varlen_fwd_pp": p0["fwd"]["flash"] + p0["bwd"]["flash"]}
    print(f"[dp] checks: {checks}", flush=True)
    print(f"[dp] phase seconds {time.perf_counter() - t_phase!r}; parts "
          f"{secs}; launches {launches}", flush=True)
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"data / pipeline parallel phase failed: {bad}")
    return launches, kernels


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
    # end: phases 7-9 use phase 6's HF directory.
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
        strategies_phase(cfg, params, input_ids, pixels, grid, tmp, hf_dir,
                         kernels["flash_varlen_fwd"]["ms"])
        # The admission path: the segments' K5 launches at t_c = 256 in
        # phase 9's chunked run (zeroed just before, read just after).
        launches["decode_blocked_fwd_t_c256"] = http_phase(
            cfg, params, engine, input_ids, pixels, grid, hf_dir)
        # The video path: the capped K1 launches (K2) of phase 10's counted
        # requests, and K2 held at the clip's own layout.
        (launches["flash_varlen_fwd_capped"],
         kernels["flash_varlen_fwd_capped"]) = video_phase(
            cfg, params, engine, pixels, grid, tmp)
        # LLaVA-OV-1.5-8B: RICE's K1, the decoder's causal K1 and K5 at
        # n_rep 4, counted in phase 11's main path (zeroed just before,
        # read just after) and held at its own shapes.
        ov_launches, ov_kernels_line, ov_cfg, ov_params, ov_hf = ov_phase(
            tmp, out_dir)
        launches.update(ov_launches)
        kernels.update(ov_kernels_line)
        # OV-8B training: the causal K1 launches of phase 12's last step
        # (zeroed just before, read just after), and K1 at its shape;
        # then the OV recipe's CLIs and both families' acceptance.
        (launches["flash_varlen_fwd_ov_train"],
         kernels["flash_varlen_fwd_ov_train"]) = ov_train_cli_phase(
            ov_cfg, ov_params, tmp, out_dir, hf_dir, ov_hf)
        # Speculative decoding and the int4 pool: K5 at t_c 8 in phase
        # 13's one-shot runs (zeroed just before, read just after each).
        spec_launches, spec_kernels = spec_phase(
            cfg, params, engine, input_ids, pixels, grid, ov_cfg, ov_params,
            out_dir)
        launches.update(spec_launches)
        kernels.update(spec_kernels)
        # The trainers of api.train: OV-8B's LoRA SFT while its weights are
        # on the card, then the 3B's packed rows, dynamic predictor and
        # SFT; the packed path's causal K1 launches are those of its last
        # step (zeroed just before, read just after).
        part = methods_phase_ov(ov_cfg, ov_params, tmp)
        # Weight-only quantization of OV-8B (16d), before its weights go
        try:
            quant = quant_ov(ov_cfg, ov_params, ov_hf, out_dir, tmp)
        except BaseException:
            pref_kill(part["pref"])
            for proc, _, _ in part["procs"].values():
                proc.kill()
            raise
        del ov_params
        torch.cuda.empty_cache()
        try:
            (launches["flash_varlen_fwd_packed_train"],
             kernels["flash_varlen_fwd_packed_train"]) = methods_phase(
                cfg, params, engine, input_ids, pixels, grid, part)
            # DPO and GRPO: the 3B's decoder, then adapters on it, trained
            # in place, so after every phase that reads its weights
            preference_phase(cfg, params, part["pref"])
            # Weight-only quantization (phase 16): the kernel's launches in
            # 16(b)'s counted request of each spec (zeroed just before,
            # read just after)
            quant_launches, quant_kernels_line = quant_phase(
                cfg, params, input_ids, pixels, grid, ov_cfg, out_dir,
                hf_dir, quant)
            launches.update(quant_launches)
            kernels.update(quant_kernels_line)
        finally:
            pref_kill(part["pref"])
            for proc, _, _ in quant["procs"].values():
                if proc.poll() is None:
                    proc.kill()
        # Qwen2.5-VL-7B and the MoE decoder (phase 17): the 3B's weights go
        # first; the 7B-shaped kernels' launches are those of the 7B path
        # that runs each (zeroed just before, read just after)
        del engine, params
        seven_launches, seven_kernels = seven_b_phase(out_dir, tmp)
        launches.update(seven_launches)
        kernels.update(seven_kernels)
        # The W8A8 ViT and the parallel paths (phase 18): the kernels at
        # the tensor-parallel shapes counted in its world's rank 0 (zeroed
        # just before each counted run, read just after)
        par_launches, par_kernels = parallel_phase(out_dir, tmp)
        launches.update(par_launches)
        kernels.update(par_kernels)
        # Data- and pipeline-parallel training, the training CLI under
        # torch.distributed.run and the warm-up (phase 19): K1 and K4
        # counted on rank 0 of its world (zeroed just before each counted
        # run, read just after)
        dp_launches, dp_kernels_line = dp_pp_phase(out_dir, tmp, hf_dir)
        launches.update(dp_launches)
        kernels.update(dp_kernels_line)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    missing = [name for name in kernels if not launches.get(name)]
    if missing:
        raise AssertionError(f"kernels never launched on their paths: "
                             f"{missing}")
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
