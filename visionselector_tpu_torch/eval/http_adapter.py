"""Evaluate any OpenAI-compatible endpoint (lmms-eval ``openai_compatible``).

The port's counterpart of ``visionselector_tpu.eval.http_adapter``. The
reference harness registers API-backed models that answer
``generate_until`` requests over HTTP instead of running local weights
(``lmms-eval/lmms_eval/models/openai_compatible.py``: base64-encoded
images inside ``image_url`` content parts, frame-sampled videos, retries).
Point it at any ``/v1/chat/completions`` server, the port's own
``api.serve`` included (it reads the same content schema), and the eval
pipeline (tasks, filters, metrics, tracker, caching) runs over the remote
model:

    python -m visionselector_tpu_torch.api.run_eval \\
        --http-endpoint http://host:8000 --data-dir D --tasks chartqa ...

It duck-types the ``EngineAdapter`` surface ``evaluate`` reads, as
``eval/replay.py`` does for ``--from-log``. Video frames are sent as PNG
images encoded by ``preprocess.png.encode_png`` (no Pillow); Pillow is
needed only to re-encode image files that are neither PNG nor JPEG.
"""

from __future__ import annotations

import base64
import io
import json
import os
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from typing import List, Sequence


class _StubEngine:
    """The attributes ``evaluate`` reads off ``adapter.engine``."""

    use_selector = False
    budget = 0.0
    strategy = None


def _b64_png(path: str) -> str:
    """An image file as a base64 data URI: PNG and JPEG bytes as they are,
    any other format re-encoded to PNG (with Pillow)."""
    with open(path, "rb") as f:
        raw = f.read()
    suffix = os.path.splitext(path)[1].lower().lstrip(".") or "png"
    if suffix in ("jpg", "jpeg"):
        mime = "image/jpeg"
    elif suffix == "png":
        mime = "image/png"
    else:  # re-encode other formats to PNG for a predictable mime
        from PIL import Image

        buf = io.BytesIO()
        Image.open(io.BytesIO(raw)).convert("RGB").save(buf, format="PNG")
        raw, mime = buf.getvalue(), "image/png"
    return f"data:{mime};base64,{base64.b64encode(raw).decode()}"


def _video_frames_b64(video_path: str, max_frames: int) -> List[str]:
    """``max_frames`` sampled frames of a video as PNG data URIs (the
    reference adapter's video treatment: sampled frames sent as
    images)."""
    import numpy as np

    from visionselector_tpu_torch.preprocess.png import encode_png
    from visionselector_tpu_torch.preprocess.video import load_video_frames

    frames, _fps = load_video_frames(video_path, {"nframes": max_frames})
    return ["data:image/png;base64," + base64.b64encode(
        encode_png(np.ascontiguousarray(fr, np.uint8))).decode()
        for fr in np.asarray(frames)]


class OpenAICompatAdapter:
    """``generate_until`` over an OpenAI-compatible chat-completions API.

    Args:
        base_url: server root (``/v1/chat/completions`` is appended) or a
            full URL already ending in ``/chat/completions``.
        model: value for the payload's ``model`` field.
        api_key: optional bearer token (``OPENAI_API_KEY`` env fallback).
        concurrency: parallel in-flight requests (host threads; the
            server batches however it likes).
        max_frames: frames sampled per video document.
        timeout: per-request seconds; each request is tried ``retries``
            times with doubling backoff on URLError / a malformed reply.
    """

    eval_time = False

    def __init__(self, base_url: str, model: str = "default",
                 api_key: str = "", concurrency: int = 8,
                 max_frames: int = 8, timeout: float = 120.0,
                 retries: int = 3):
        base = base_url.rstrip("/")
        if not base.endswith("/chat/completions"):
            base = base + ("" if base.endswith("/v1") else "/v1") \
                + "/chat/completions"
        self.url = base
        self.model = model
        self.api_key = api_key or os.environ.get("OPENAI_API_KEY", "")
        self.concurrency = max(1, int(concurrency))
        self.max_frames = int(max_frames)
        self.timeout = float(timeout)
        self.retries = int(retries)
        self.engine = _StubEngine()
        self.model_tag = f"openai_compatible:{self.url}:{model}"

    # ---- request plumbing -------------------------------------------------
    def _payload(self, req, until: Sequence[str]) -> dict:
        content = [{"type": "text", "text": req.question}]
        if req.video_path:
            uris = _video_frames_b64(req.video_path, self.max_frames)
        else:
            uris = [_b64_png(p) for p in req.image_paths]
        for uri in uris:
            content.append({"type": "image_url", "image_url": {"url": uri}})
        return {
            "model": self.model,
            "messages": [{"role": "user", "content": content}],
            "max_tokens": req.task.max_new_tokens,
            "stop": list(until),
            "temperature": 0.0,
        }

    def _post(self, payload: dict) -> str:
        body = json.dumps(payload).encode()
        headers = {"Content-Type": "application/json"}
        if self.api_key:
            headers["Authorization"] = f"Bearer {self.api_key}"
        delay = 1.0
        last = None
        for _ in range(self.retries):
            try:
                r = urllib.request.Request(self.url, data=body,
                                           headers=headers)
                with urllib.request.urlopen(r, timeout=self.timeout) as resp:
                    out = json.loads(resp.read().decode())
                return out["choices"][0]["message"]["content"]
            except (urllib.error.URLError, KeyError, json.JSONDecodeError,
                    TimeoutError) as e:  # noqa: PERF203
                last = e
                time.sleep(delay)
                delay *= 2
        raise RuntimeError(
            f"openai_compatible endpoint {self.url} failed after "
            f"{self.retries} attempts: {last!r}")

    # ---- EngineAdapter surface -------------------------------------------
    def generate_until(self, requests: Sequence,
                       until: Sequence[str] = ("<|im_end|>",),
                       decode_batch: int | None = None) -> List[str]:
        del decode_batch  # server-side batching; concurrency covers it
        with ThreadPoolExecutor(max_workers=self.concurrency) as ex:
            return list(ex.map(
                lambda r: self._post(self._payload(r, until)), requests))

    def generate_until_multi_round(self, requests, until=("<|im_end|>",)):
        # one round is one chat call; multi-round folds earlier answers
        # into the question text upstream, so the plain path applies
        return self.generate_until(requests, until)

    def predict_multiple_choice(self, requests):
        raise SystemExit(
            "loglikelihood-scored tasks need token-level log-probs, which "
            "chat-completions APIs do not expose; run these tasks with a "
            "local engine (--model-path) instead")
