"""HTTP serving endpoint of the PyTorch port (the reference's
``visionselector_tpu.api.serve``; the serve surface of the reference's
gradio chat app, ``llava-ov-15/src/serve/app.py:17-142``).

Stdlib HTTP server exposing:
    POST /generate  {"prompt": str, "image_b64": str?, "max_new_tokens": int?,
                     "stream": bool?, "session": str?, "temperature": ...}
        -> {"tokens": [...], "text": str?, "kept_vision_tokens": int, ...}
        ("stream": true sends one ndjson line per token chunk, then the
        summary line)
    POST /v1/chat/completions  OpenAI-compatible chat (SSE when streaming)
    GET  /health    -> {"ok": true, "method": ..., "budget": ...}
    GET  /metrics   Prometheus text counters
    GET  / or /chat a browser chat page over /generate

Usage:
    python -m visionselector_tpu_torch.api.serve --port 8000 \\
        [--device cuda] [--model-path /ckpt] [--method selector] \\
        [--budget 0.2] [--continuous 8 --continuous-prefill-chunk 256]

It serves on the GPU (``--device cuda``, the default; no CPU fallback:
``--device cpu`` asks for the CPU) the engine of ``--family``: ``qwen25vl``
(the default) or ``llava_ov15`` (``OVEngine``: continuous batching admits
its requests one-shot). Without ``--model-path`` it serves the family's
tiny random-weight config; without a tokenizer (no ``--model-path``, or no
``transformers``) prompts become stub ids and answers are token ids, as
the reference's server does. ``image_b64`` takes an 8-bit RGB / RGBA PNG
without Pillow (``preprocess.png``); other formats need Pillow (a 400
that names it otherwise).

``--speculative N``: a request that asks for no stream (and finds no
batcher) decodes with prompt-lookup speculative decoding
(``model.generate_speculative``; its result carries ``spec_proposed`` /
``spec_accepted``); with ``--continuous S`` the batcher's slots run
speculative rounds (``/health`` shows ``spec_steps``).
``--continuous-kv-quant int4`` packs the slot pool's values two a byte
(the plain int4 decode route).

``--quantize int8 | int4 | int4:g<N>`` quantizes the decoder's matmul
kernels right after the weights load (``lm.apply_weight_quantization``):
decode steps and the batcher's slots then run the weight-only GEMM kernel
on the card.

Not ported yet, raising NotImplementedError with its ROADMAP §1 item:
``--tp`` (11).
``--continuous-auto-window`` raises ValueError: the decode kernel already
reads only each slot's live prefix (ROADMAP "Do not port").
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


def decode_image(image_b64: str):
    """A request's ``image_b64`` as an [H, W, 3] uint8 array (8-bit RGB /
    RGBA PNG, read without Pillow) or a Pillow image (any other format).
    ValueError (a 400) for bad data, or when Pillow is needed and
    missing."""
    from visionselector_tpu_torch.preprocess.png import decode_png

    try:
        data = base64.b64decode(image_b64, validate=True)
    except ValueError as e:
        raise ValueError(f"image_b64 is not base64 ({e})") from None
    pixels = decode_png(data)
    if pixels is not None:
        return pixels
    try:
        from PIL import Image
    except ImportError:
        raise ValueError(
            "image_b64: only 8-bit non-interlaced RGB or RGBA PNG is read "
            "without Pillow, and Pillow (PIL) is not installed") from None
    try:
        return Image.open(io.BytesIO(data))
    except Exception as e:  # noqa: BLE001 — Pillow's errors vary by format
        raise ValueError(f"image_b64: not an image Pillow reads ({e})") \
            from None


class MicroBatcher:
    """Coalesces concurrent non-streaming requests into one batched decode
    (``engine.generate_batch``): handler threads enqueue and wait; a single
    worker takes up to ``max_batch`` items that share ``max_new_tokens``,
    EOS ids and sampling settings after a short join window. Prefill still
    runs per request. A sampled request runs alone through
    ``engine.generate`` (the reference's rule: its key stream must not
    depend on batch composition)."""

    def __init__(self, engine, lock, max_batch: int = 8,
                 window_ms: float = 4.0):
        self.engine = engine
        self.lock = lock
        self.max_batch = max_batch
        self.window_s = window_ms / 1e3
        self.queue: list = []
        self.cv = threading.Condition()
        self._running = True
        self.worker = threading.Thread(target=self._loop, daemon=True)
        self.worker.start()

    def submit(self, gen_kwargs: dict, max_new_tokens: int,
               temperature: float = 0.0, top_p: float = 1.0, seed: int = 0,
               top_k: int = 0, repetition_penalty: float = 1.0):
        item = {"kw": gen_kwargs, "mnt": max_new_tokens,
                "samp": (float(temperature), float(top_p), int(seed),
                         int(top_k), float(repetition_penalty)),
                "done": threading.Event(), "result": None, "error": None}
        with self.cv:
            if not self._running:
                raise RuntimeError("batcher shut down")
            self.queue.append(item)
            self.cv.notify()
        item["done"].wait()
        if item["error"] is not None:
            raise item["error"]
        return item["result"]

    def shutdown(self):
        with self.cv:
            self._running = False
            self.cv.notify_all()
        self.worker.join(timeout=10)

    @staticmethod
    def _key(b):
        eos = b["kw"].get("eos_token_ids")
        solo = id(b) if b["samp"][0] > 0.0 else None
        return (b["mnt"], tuple(eos) if eos is not None else None,
                b["samp"], solo)

    def _loop(self):
        while True:
            with self.cv:
                while self._running and not self.queue:
                    self.cv.wait()
                if not self._running:
                    # never strand a waiter that enqueued before the flag
                    for b in self.queue:
                        b["error"] = RuntimeError("batcher shut down")
                        b["done"].set()
                    self.queue.clear()
                    return
            time.sleep(self.window_s)  # let concurrent requests join
            with self.cv:
                key = self._key(self.queue[0])
                batch = [b for b in self.queue
                         if self._key(b) == key][:self.max_batch]
                for b in batch:
                    self.queue.remove(b)
            try:
                temp, tp, seed, tk, rp = batch[0]["samp"]
                mnt = batch[0]["mnt"]
                with self.lock:
                    if len(batch) == 1:
                        results = [self.engine.generate(
                            **batch[0]["kw"], max_new_tokens=mnt,
                            temperature=temp, top_p=tp, seed=seed,
                            top_k=tk, repetition_penalty=rp)]
                    else:
                        results = self.engine.generate_batch(
                            [b["kw"] for b in batch], max_new_tokens=mnt,
                            temperature=temp, top_p=tp, seed=seed,
                            top_k=tk, repetition_penalty=rp)
                for b, r in zip(batch, results):
                    b["result"] = r
            except Exception as e:  # noqa: BLE001 — report to all waiters
                for b in batch:
                    b["error"] = e
            for b in batch:
                b["done"].set()


SESSION_PENALTY_REFUSAL = (
    "chat sessions do not support repetition_penalty (the penalty state "
    "would have to span turns); send the request without a session id")


class Server:
    """The serving state behind the HTTP handler: the engine, its lock
    (every engine call holds it, the batchers' too), the optional micro-
    or continuous batcher, the prefix store, chat sessions and counters."""

    def __init__(self, engine, tokenizer, method: str, budget: float,
                 micro_batch: int = 1, batch_window_ms: float = 4.0,
                 prefix_cache: int = 0, prefix_cache_min: int = 32,
                 continuous: int = 0, continuous_t_max: int = 4096,
                 continuous_chunk: int = 8, continuous_kv_int8: bool = False,
                 continuous_kv_quant: str | None = None,
                 continuous_prefill_chunk: int = 0,
                 continuous_prefill_vit_segments: int = 0,
                 decode_attn: str | None = None, speculative: int = 0):
        from visionselector_tpu_torch.models.qwen25vl.model import (
            PrefixCacheStore,
        )

        self.engine = engine
        self.tokenizer = tokenizer
        self.method = method
        self.budget = budget
        # prompt-lookup speculative decoding: N proposals per verify step
        self.speculative = speculative
        # cross-request KV prefix cache (exact for selector / orig;
        # whole-prompt repeats only for the text-dependent strategies)
        self.prefix_store = (PrefixCacheStore(max_entries=prefix_cache,
                                              min_prefix=prefix_cache_min)
                             if prefix_cache > 0 else None)
        self.lock = threading.Lock()  # serializes engine use
        # handler threads finish requests concurrently (continuous batching
        # completes outside self.lock), so the counters take their own lock
        self.metrics = {"requests_total": 0, "tokens_out_total": 0,
                        "request_seconds_sum": 0.0,
                        "prefill_seconds_sum": 0.0}
        self.metrics_lock = threading.Lock()
        if continuous > 0:
            from visionselector_tpu_torch.models.qwen25vl.continuous import (
                ContinuousBatcher,
            )

            self.batcher = ContinuousBatcher(
                engine, n_slots=continuous, t_max=continuous_t_max,
                chunk=continuous_chunk, lock=self.lock,
                prefix_store=self.prefix_store, speculative=speculative,
                kv_int8=continuous_kv_int8,
                kv_quant=continuous_kv_quant,
                prefill_chunk=continuous_prefill_chunk,
                prefill_vit_segments=continuous_prefill_vit_segments,
                decode_attn=decode_attn)
        else:
            self.batcher = (MicroBatcher(engine, self.lock, micro_batch,
                                         batch_window_ms)
                            if micro_batch > 1 else None)
        # multi-turn chat sessions: the KV cache kept across turns
        self.sessions: dict = {}
        self.max_sessions = 8

    def close(self):
        """Stop the batcher's worker thread (tests and embedding; the
        serving process never calls it: its daemon threads end with it)."""
        if self.batcher is not None:
            self.batcher.shutdown()

    def _prompt_ids(self, prompt: str):
        if self.tokenizer is not None:
            from visionselector_tpu_torch.api.predict import chat_prompt_ids

            return chat_prompt_ids(self.tokenizer, prompt)
        return [100, 200], [300, 400]  # the reference's stub ids

    def _turn_ids(self, prompt: str):
        if self.tokenizer is not None:
            return self.tokenizer.encode(
                f"<|im_start|>user\n{prompt}<|im_end|>\n"
                "<|im_start|>assistant\n")
        return [500] + [abs(hash(w)) % 1000 + 600
                        for w in prompt.split()][:16] + [501]

    def generate(self, prompt: str, image_b64: str | None,
                 max_new_tokens: int = 64, on_token_chunk=None,
                 session: str | None = None, temperature: float = 0.0,
                 top_p: float = 1.0, seed: int = 0, top_k: int = 0,
                 repetition_penalty: float = 1.0) -> dict:
        from visionselector_tpu_torch.models.qwen25vl import model as M
        from visionselector_tpu_torch.preprocess.image import preprocess_image
        from visionselector_tpu_torch.preprocess.rope import (
            expand_vision_tokens,
        )

        cfg = self.engine.cfg
        if session is not None:
            # membership is decided under the lock: another thread's first
            # turn may evict this session between an unlocked check and
            # the read
            with self.lock:
                existing = self.sessions.pop(session, None)
                if existing is not None:  # most recently used
                    self.sessions[session] = existing
            if existing is not None:
                if image_b64:
                    raise ValueError(
                        "chat sessions accept an image only on the first "
                        "turn (the cached KV already encodes it); start a "
                        "new session to switch images")
                if repetition_penalty != 1.0:
                    raise ValueError(SESSION_PENALTY_REFUSAL)
                turn = np.asarray(self._turn_ids(prompt), np.int64)
                with self.lock:
                    res, sess = M.continue_chat_session(
                        self.engine, existing, turn,
                        max_new_tokens=max_new_tokens,
                        temperature=temperature, top_p=top_p, seed=seed,
                        top_k=top_k)
                    self.sessions[session] = sess
                return self._result_dict(res, session=session)
        before, after = self._prompt_ids(prompt)
        if image_b64:
            pixels, grid = preprocess_image(
                decode_image(image_b64),
                patch_size=cfg.vision.patch_size,
                temporal_patch_size=cfg.vision.temporal_patch_size,
                merge_size=cfg.vision.spatial_merge_size)
            input_ids = expand_vision_tokens(
                before, after, grid,
                spatial_merge_size=cfg.vision.spatial_merge_size,
                image_token_id=cfg.image_token_id,
                vision_start_token_id=cfg.vision_start_token_id,
                vision_end_token_id=cfg.vision_end_token_id)
        else:
            # a text-only request: no vision branch, no image put in
            pixels, grid = None, None
            input_ids = np.concatenate([before, after]).astype(np.int64)
        if session is not None and on_token_chunk is None:
            if repetition_penalty != 1.0:
                raise ValueError(SESSION_PENALTY_REFUSAL)
            with self.lock:
                res, sess = M.start_chat_session(
                    self.engine, input_ids, pixels, grid,
                    max_new_tokens=max_new_tokens, temperature=temperature,
                    top_p=top_p, seed=seed, top_k=top_k)
                if len(self.sessions) >= self.max_sessions:
                    self.sessions.pop(next(iter(self.sessions)))
                self.sessions[session] = sess
            return self._result_dict(res, session=session)
        sampling = dict(temperature=temperature, top_p=top_p, seed=seed,
                        top_k=top_k, repetition_penalty=repetition_penalty)
        if self.batcher is not None and on_token_chunk is None:
            res = self.batcher.submit(
                dict(input_ids=input_ids, pixel_values=pixels,
                     grid_thw=grid), max_new_tokens, **sampling)
        elif self.speculative > 0 and on_token_chunk is None:
            with self.lock:
                res = M.generate_speculative(
                    self.engine, input_ids, pixels, grid,
                    max_new_tokens=max_new_tokens,
                    propose_len=self.speculative, **sampling)
        elif self.prefix_store is not None and on_token_chunk is None:
            with self.lock:
                res = M.generate_prefix_cached(
                    self.engine, self.prefix_store, input_ids, pixels, grid,
                    max_new_tokens=max_new_tokens, **sampling)
        else:
            with self.lock:
                res = self.engine.generate(
                    input_ids, pixels, grid, max_new_tokens=max_new_tokens,
                    on_token_chunk=on_token_chunk, **sampling)
        return self._result_dict(res)

    def metrics_text(self) -> str:
        """Prometheus text exposition of the serving counters."""
        with self.metrics_lock:
            m = dict(self.metrics)
        lines = [
            "# TYPE vst_requests_total counter",
            f"vst_requests_total {m['requests_total']}",
            "# TYPE vst_tokens_out_total counter",
            f"vst_tokens_out_total {m['tokens_out_total']}",
            "# TYPE vst_request_seconds_sum counter",
            f"vst_request_seconds_sum {m['request_seconds_sum']:.6f}",
            "# TYPE vst_prefill_seconds_sum counter",
            f"vst_prefill_seconds_sum {m['prefill_seconds_sum']:.6f}",
        ]
        if self.prefix_store is not None:
            lines += [
                "# TYPE vst_prefix_cache_hits_total counter",
                f"vst_prefix_cache_hits_total {self.prefix_store.hits}",
                "# TYPE vst_prefix_cache_misses_total counter",
                f"vst_prefix_cache_misses_total {self.prefix_store.misses}",
            ]
        stats = getattr(self.batcher, "stats", None)
        if stats is not None:
            for k, v in stats.items():
                lines += [f"# TYPE vst_continuous_{k} gauge",
                          f"vst_continuous_{k} {v}"]
        return "\n".join(lines) + "\n"

    def _result_dict(self, res, session: str | None = None) -> dict:
        with self.metrics_lock:
            self.metrics["requests_total"] += 1
            self.metrics["tokens_out_total"] += len(res.tokens)
            self.metrics["request_seconds_sum"] += float(res.total_seconds)
            self.metrics["prefill_seconds_sum"] += float(
                res.prefill_seconds or 0.0)
        out = {
            "tokens": res.tokens,
            "text": (self.tokenizer.decode(res.tokens,
                                           skip_special_tokens=True)
                     if self.tokenizer is not None else None),
            "num_vision_tokens": res.num_vision_tokens,
            "kept_vision_tokens": (len(res.selected_indices)
                                   if res.selected_indices is not None
                                   else res.num_vision_tokens),
            "prefill_ms": res.prefill_seconds * 1e3,
            "latency_ms": res.total_seconds * 1e3,
        }
        if res.spec_proposed is not None:
            out["spec_proposed"] = res.spec_proposed
            out["spec_accepted"] = res.spec_accepted
        if session is not None:
            out["session"] = session
        return out


# Minimal browser chat client over POST /generate (ndjson streaming).
# Parity surface for the reference's gradio chat UI
# (``llava-ov-15/src/serve/app.py:17-142``) without the gradio dependency.
CHAT_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>visionselector chat</title>
<style>
 body{font-family:system-ui,sans-serif;max-width:720px;margin:2rem auto;
      padding:0 1rem}
 #log{border:1px solid #ccc;border-radius:8px;padding:1rem;min-height:16rem;
      white-space:pre-wrap}
 .u{color:#036} .a{color:#063} .meta{color:#888;font-size:.8em}
 textarea{width:100%;height:4rem} button{padding:.4rem 1rem}
</style></head><body>
<h3>visionselector chat</h3>
<div id="log"></div>
<p><input type="file" id="img" accept="image/*"></p>
<textarea id="q" placeholder="Ask about the image..."></textarea>
<p class="meta">temperature <input id="temp" type="number" value="0"
   min="0" max="2" step="0.1" style="width:4em">
 top_p <input id="topp" type="number" value="1" min="0" max="1" step="0.05"
   style="width:4em">
 top_k <input id="topk" type="number" value="0" min="0" step="1"
   style="width:4em">
 repetition_penalty <input id="rep" type="number" value="1" min="0.5" max="2"
   step="0.05" style="width:4.5em"></p>
<p><button id="send">Send</button> <span class="meta" id="stat"></span></p>
<script>
const log = document.getElementById('log');
function add(cls, text){
  const d = document.createElement('div'); d.className = cls;
  d.textContent = text; log.appendChild(d); return d; }
async function b64(file){
  if(!file) return null;
  const buf = await file.arrayBuffer();
  let s=''; new Uint8Array(buf).forEach(b=>s+=String.fromCharCode(b));
  return btoa(s); }
// One KV-reuse session per page load: follow-up turns append to the cached
// conversation instead of re-prefilling (images go with the first turn).
const sid = 'web-' + Math.random().toString(36).slice(2);
let firstTurn = true;
document.getElementById('send').onclick = async () => {
  const q = document.getElementById('q').value.trim();
  if(!q) return;
  add('u', 'you: ' + q);
  const rep0 = parseFloat(document.getElementById('rep').value) || 1;
  // stateless mode (rep penalty) re-sends the image with every turn
  const image_b64 = (firstTurn || rep0 !== 1)
    ? await b64(document.getElementById('img').files[0]) : null;
  firstTurn = false;
  const out = add('a', 'model: ...');
  const t0 = performance.now();
  const rep = parseFloat(document.getElementById('rep').value) || 1;
  // repetition_penalty is incompatible with KV-reuse sessions (the penalty
  // state would have to span turns) -> stateless requests in that mode
  const resp = await fetch('/generate', {method:'POST',
    headers:{'Content-Type':'application/json'},
    body: JSON.stringify({prompt:q, image_b64,
      session: rep === 1 ? sid : undefined,
      temperature: parseFloat(document.getElementById('temp').value) || 0,
      top_p: parseFloat(document.getElementById('topp').value) || 1,
      top_k: parseInt(document.getElementById('topk').value) || 0,
      repetition_penalty: rep,
      max_new_tokens:128})});
  const rec = await resp.json();
  out.textContent = 'model: ' + (rec.text ?? rec.error ??
                                 (rec.tokens||[]).join(' '));
  document.getElementById('stat').textContent =
    ((performance.now()-t0)/1000).toFixed(1)+'s';
};
</script></body></html>
"""


def make_handler(server: Server):
    class Handler(BaseHTTPRequestHandler):
        # chunked Transfer-Encoding (streaming) requires HTTP/1.1 — the
        # BaseHTTPRequestHandler default is HTTP/1.0, under which compliant
        # clients would read the chunk framing as body bytes
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):  # quiet
            pass

        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                out = {"ok": True, "method": server.method,
                       "budget": server.budget}
                if server.prefix_store is not None:
                    out["prefix_cache"] = {
                        "hits": server.prefix_store.hits,
                        "misses": server.prefix_store.misses,
                        "entries": len(server.prefix_store.entries),
                    }
                if getattr(server.batcher, "stats", None) is not None:
                    out["continuous"] = dict(server.batcher.stats)
                self._send(200, out)
            elif self.path == "/metrics":
                body = server.metrics_text().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path in ("/", "/chat"):
                # Browser chat page (the reference ships a gradio chat app,
                # ``llava-ov-15/src/serve/app.py``; this is the dependency-
                # free equivalent over the same /generate API).
                body = CHAT_HTML.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            if self.path == "/v1/chat/completions":
                self._chat_completions()
                return
            if self.path != "/generate":
                self._send(404, {"error": "not found"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                if req.get("stream"):
                    if req.get("session"):
                        # explicit: the chunked-decode session path has no
                        # streaming variant yet — fail loudly instead of
                        # silently dropping the session
                        self._send(400, {"error": "sessions require "
                                                  "stream: false"})
                        return
                    self._stream(req)
                    return
                out = server.generate(
                    req.get("prompt", ""),
                    req.get("image_b64"),
                    int(req.get("max_new_tokens", 64)),
                    session=req.get("session"),
                    temperature=float(req.get("temperature", 0.0)),
                    top_p=float(req.get("top_p", 1.0)),
                    seed=int(req.get("seed", 0)),
                    top_k=int(req.get("top_k", 0)),
                    repetition_penalty=float(
                        req.get("repetition_penalty", 1.0)),
                )
                self._send(200, out)
            except ValueError as e:  # client-fixable (e.g. image mid-session)
                self._send(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001
                self._send(500, {"error": str(e)})

        def _chat_completions(self):
            """Minimal OpenAI-compatible chat endpoint (production-serving
            surface): messages with text + image_url (data: base64) content
            parts; supports "stream": true with SSE data: lines."""
            import time as _time

            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                prompt_parts, image_b64 = [], None
                for msg in req.get("messages", []):
                    content = msg.get("content", "")
                    if isinstance(content, str):
                        prompt_parts.append(content)
                        continue
                    for part in content:
                        if part.get("type") == "text":
                            prompt_parts.append(part.get("text", ""))
                        elif part.get("type") == "image_url":
                            url = part["image_url"]["url"]
                            if url.startswith("data:"):
                                image_b64 = url.split(",", 1)[1]
                prompt = "\n".join(p for p in prompt_parts if p)
                max_tokens = int(req.get("max_tokens",
                                         req.get("max_completion_tokens", 64)))
                # OpenAI-compatible sampling knobs (greedy by default, so a
                # compression benchmark sweep stays reproducible)
                sampling = dict(
                    temperature=float(req.get("temperature", 0.0)),
                    top_p=float(req.get("top_p", 1.0)),
                    seed=int(req.get("seed", 0)),
                    top_k=int(req.get("top_k", 0)),
                    repetition_penalty=float(
                        req.get("repetition_penalty", 1.0)),
                )
                created = int(_time.time())
                base = {"id": f"chatcmpl-{created}", "object":
                        "chat.completion", "created": created,
                        "model": server.method}

                if req.get("stream"):
                    self.send_response(200)
                    self.send_header("Content-Type", "text/event-stream")
                    self.send_header("Transfer-Encoding", "chunked")
                    self.end_headers()

                    def sse(payload):
                        body = f"data: {json.dumps(payload)}\n\n".encode()
                        self.wfile.write(f"{len(body):x}\r\n".encode())
                        self.wfile.write(body + b"\r\n")

                    def on_chunk(tokens):
                        text = (
                            server.tokenizer.decode(
                                tokens, skip_special_tokens=True)
                            if server.tokenizer is not None
                            else " ".join(map(str, tokens))
                        )
                        sse({**base, "object": "chat.completion.chunk",
                             "choices": [{"index": 0,
                                          "delta": {"content": text},
                                          "finish_reason": None}]})

                    server.generate(prompt, image_b64, max_tokens,
                                    on_token_chunk=on_chunk, **sampling)
                    sse({**base, "object": "chat.completion.chunk",
                         "choices": [{"index": 0, "delta": {},
                                      "finish_reason": "stop"}]})
                    done = b"data: [DONE]\n\n"
                    self.wfile.write(f"{len(done):x}\r\n".encode())
                    self.wfile.write(done + b"\r\n")
                    self.wfile.write(b"0\r\n\r\n")
                    return

                out = server.generate(prompt, image_b64, max_tokens,
                                      **sampling)
                self._send(200, {
                    **base,
                    "choices": [{
                        "index": 0,
                        "message": {"role": "assistant",
                                    "content": out["text"] or " ".join(
                                        map(str, out["tokens"]))},
                        "finish_reason": "stop",
                    }],
                    "usage": {
                        "prompt_tokens": out.get("num_vision_tokens", 0),
                        "completion_tokens": len(out["tokens"]),
                        "total_tokens": (out.get("num_vision_tokens", 0)
                                         + len(out["tokens"])),
                    },
                })
            except Exception as e:  # noqa: BLE001
                self._send(500, {"error": str(e)})

        def _stream(self, req: dict):
            """Chunked token streaming (the serve-side analog of the
            reference's streaming gradio chat, ``src/serve/app.py:17-142``):
            one JSON line per decoded chunk, then a final summary line."""
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def write_line(payload: dict):
                body = (json.dumps(payload) + "\n").encode()
                self.wfile.write(f"{len(body):x}\r\n".encode())
                self.wfile.write(body + b"\r\n")

            def on_chunk(tokens):
                text = (
                    server.tokenizer.decode(tokens, skip_special_tokens=True)
                    if server.tokenizer is not None else None
                )
                write_line({"tokens": tokens, "text": text})

            try:
                out = server.generate(
                    req.get("prompt", ""),
                    req.get("image_b64"),
                    int(req.get("max_new_tokens", 64)),
                    on_token_chunk=on_chunk,
                    temperature=float(req.get("temperature", 0.0)),
                    top_p=float(req.get("top_p", 1.0)),
                    seed=int(req.get("seed", 0)),
                    top_k=int(req.get("top_k", 0)),
                    repetition_penalty=float(
                        req.get("repetition_penalty", 1.0)),
                )
                write_line({"done": True, **out})
            except Exception as e:  # noqa: BLE001
                write_line({"error": str(e)})
            self.wfile.write(b"0\r\n\r\n")

    return Handler


def _refuse_unported(args) -> None:
    from visionselector_tpu_torch.models.qwen25vl.continuous import (
        AUTO_WINDOW_REFUSAL,
    )

    refused = [
        (int(getattr(args, "tp", 0) or 0) > 1, "--tp", 11),
    ]
    for hit, what, item in refused:
        if hit:
            raise NotImplementedError(
                f"{what} is not ported yet (ROADMAP §1 item {item})")
    if getattr(args, "continuous_auto_window", False):
        raise ValueError(f"--continuous-auto-window: {AUTO_WINDOW_REFUSAL}")


def build_server(args) -> ThreadingHTTPServer:
    """The HTTP server for ``args`` (``main``'s flags; missing ones take
    their defaults), bound but not yet serving. ``httpd.server_obj`` is the
    ``Server``: tests call ``httpd.shutdown()``, then
    ``httpd.server_obj.close()`` to stop its batcher."""
    import torch

    from visionselector_tpu_torch.api.predict import (
        load_model,
        load_tokenizer,
        make_engine,
    )

    _refuse_unported(args)
    device = getattr(args, "device", "cuda")
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available (pass "
                         "--device cpu to serve on the CPU)")
    family = getattr(args, "family", "qwen25vl")
    model_path = getattr(args, "model_path", None)
    cfg, params = load_model(family, model_path, device,
                             quantize=getattr(args, "quantize", None))
    tokenizer = load_tokenizer(model_path) if model_path else None
    method = getattr(args, "method", "selector")
    budget = getattr(args, "budget", 0.2)
    engine = make_engine(family, cfg, params, method, budget, device)
    # the reference's "blocked" decode attention is the port's decode
    # kernel (the default); its dense "xla" one is the plain path
    decode_attn = ("plain" if getattr(args, "decode_attn", None) == "xla"
                   else None)
    srv = Server(
        engine, tokenizer, method, budget,
        micro_batch=getattr(args, "micro_batch", 1),
        batch_window_ms=getattr(args, "batch_window_ms", 4.0),
        prefix_cache=getattr(args, "prefix_cache", 0),
        prefix_cache_min=getattr(args, "prefix_cache_min", 32),
        continuous=getattr(args, "continuous", 0),
        continuous_t_max=getattr(args, "continuous_t_max", 4096),
        continuous_chunk=getattr(args, "continuous_chunk", 8),
        continuous_kv_int8=getattr(args, "continuous_kv_int8", False),
        continuous_kv_quant=getattr(args, "continuous_kv_quant", None),
        continuous_prefill_chunk=getattr(args, "continuous_prefill_chunk",
                                         0),
        continuous_prefill_vit_segments=getattr(
            args, "continuous_prefill_vit_segments", 0),
        decode_attn=decode_attn, speculative=getattr(args, "speculative", 0))
    httpd = ThreadingHTTPServer((getattr(args, "host", "127.0.0.1"),
                                 getattr(args, "port", 8000)),
                                make_handler(srv))
    httpd.server_obj = srv
    return httpd


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--model-path", default=None)
    p.add_argument("--method", default="selector")
    p.add_argument("--family", default="qwen25vl",
                   choices=("qwen25vl", "llava_ov15"))
    p.add_argument("--budget", type=float, default=0.2)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000,
                   help="0 picks a free port (printed on the start line)")
    p.add_argument("--device", default="cuda", choices=("cpu", "cuda"),
                   help="cuda (default) or cpu; cuda without a GPU fails")
    p.add_argument("--micro-batch", type=int, default=1,
                   help="coalesce concurrent non-streaming requests into "
                        "one batched decode")
    p.add_argument("--batch-window-ms", type=float, default=4.0)
    p.add_argument("--quantize", default=None,
                   help="weight-only LM quantization: int8, int4, or "
                        "int4:g<N> (grouped); int4 packs 2 weights/byte "
                        "of HBM — more KV slots for --continuous")
    p.add_argument("--speculative", type=int, default=0,
                   help="prompt-lookup speculative decoding: propose N "
                        "tokens per decode dispatch (greedy-identical "
                        "outputs); with --continuous, speculative slots")
    p.add_argument("--prefix-cache", type=int, default=0,
                   help="cross-request KV prefix cache: keep N post-prefill "
                        "snapshots; requests sharing (image, prompt prefix) "
                        "append only their suffix; 0 = off")
    p.add_argument("--prefix-cache-min", type=int, default=32,
                   help="minimum shared-prefix tokens for a cache hit")
    p.add_argument("--continuous", type=int, default=0,
                   help="continuous batching: N persistent decode slots; "
                        "0 = off")
    p.add_argument("--continuous-t-max", type=int, default=4096,
                   help="per-slot KV capacity (tokens) of the pool")
    p.add_argument("--continuous-chunk", type=int, default=8,
                   help="decode steps per continuous-batching dispatch")
    p.add_argument("--continuous-kv-quant", default=None,
                   choices=["int8", "int4"],
                   help="quantize the slot pool: int8, or int4 packed "
                        "two values a byte (the plain int4 decode route; "
                        "measure drift before serving int4)")
    p.add_argument("--continuous-kv-int8", action="store_true",
                   help="int8 slot pool (the same as --continuous-kv-quant "
                        "int8)")
    p.add_argument("--continuous-prefill-chunk", type=int, default=0,
                   help="segmented admission prefills: the vision phase, "
                        "then N-row decoder segments between decode chunks; "
                        "0 = one-shot")
    p.add_argument("--continuous-prefill-vit-segments", type=int, default=0,
                   help="with --continuous-prefill-chunk: run each "
                        "admission's vision tower in N block groups too")
    p.add_argument("--tp", type=int, default=0,
                   help="tensor-parallel serving (not ported)")
    p.add_argument("--continuous-auto-window", action="store_true",
                   help="not ported: the decode kernel reads only each "
                        "slot's live prefix")
    p.add_argument("--decode-attn", choices=("xla", "blocked"), default=None,
                   help="the batcher's decode attention: 'blocked' (the "
                        "default) the decode kernel, 'xla' the dense plain "
                        "path")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    httpd = build_server(args)
    host, port = httpd.server_address[:2]
    print(f"[serve] listening on {host}:{port} method={args.method} "
          f"budget={args.budget} device={args.device}", flush=True)
    try:
        httpd.serve_forever()
    finally:
        httpd.server_obj.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
