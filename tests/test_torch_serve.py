"""The port's HTTP server (``visionselector_tpu_torch.api.serve``) on
qwen25vl_tiny on the CPU, at 127.0.0.1 on a free port, every call under a
timeout: ``/health``, ``/metrics``, the chat page, ``/generate`` against
the JAX package's ``Server`` over the same weights (``from_jax_params`` on
one numpy tree, no tokenizer: the reference's stub ids), ndjson streaming,
OpenAI chat completions and SSE, chat sessions, the micro-batcher, the
continuous batcher with chunked admission, the prefix cache, the PNG reader
against Pillow, ``build_server`` / ``main``'s flags and the flags the port
refuses."""

import argparse
import base64
import contextlib
import io
import json
import sys
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from torch_serving_params import (  # noqa: F401 (one_thread: autouse)
    one_thread,
    serving_tree,
)

from visionselector_tpu.api import serve as jserve
from visionselector_tpu.core.config import qwen25vl_tiny as jax_tiny
from visionselector_tpu.models.qwen25vl import model as jmodel
from visionselector_tpu_torch.api import serve as tserve
from visionselector_tpu_torch.core.config import qwen25vl_tiny
from visionselector_tpu_torch.models.qwen25vl import model as tmodel
from visionselector_tpu_torch.models.qwen25vl.weights import from_jax_params
from visionselector_tpu_torch.preprocess.image import preprocess_image
from visionselector_tpu_torch.preprocess.png import decode_png, encode_png
from visionselector_tpu_torch.preprocess.rope import expand_vision_tokens

TIMEOUT = 60  # seconds per HTTP call: a deadlock fails, it does not hang


def _image(seed, hw=(56, 84), channels=3):
    rng = np.random.RandomState(seed)
    return (rng.rand(*hw, channels) * 255).astype(np.uint8)


def _b64(pixels) -> str:
    return base64.b64encode(encode_png(pixels)).decode()


@pytest.fixture(scope="module")
def w():
    tree = serving_tree(jax_tiny(), seed=0)
    tparams = from_jax_params(tree, qwen25vl_tiny(), "cpu")

    def teng():
        return tmodel.QwenVLEngine(qwen25vl_tiny(), tparams,
                                   use_selector=True, budget=0.5,
                                   device="cpu")

    jeng = jmodel.QwenVLEngine(jax_tiny(), jax.tree.map(jnp.asarray, tree),
                               use_selector=True, budget=0.5)
    return dict(teng=teng, jsrv=jserve.Server(jeng, None, "selector", 0.5),
                img=_image(0), img2=_image(1, (56, 56)))


@contextlib.contextmanager
def serving(engine, **kw):
    """A port ``Server`` on 127.0.0.1, a free port; yields (url, server)."""
    srv = tserve.Server(engine, None, "selector", 0.5, **kw)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), tserve.make_handler(srv))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}", srv
    finally:
        httpd.shutdown()
        srv.close()
        httpd.server_close()


def post(url, path, body, raw=False):
    req = urllib.request.Request(
        url + path, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
        data = r.read().decode()
    return data if raw else json.loads(data)


def get(url, path):
    with urllib.request.urlopen(url + path, timeout=TIMEOUT) as r:
        return r.read().decode(), r.headers["Content-Type"]


def post_status(url, path, body):
    """(HTTP status, JSON body) of a request that may fail."""
    try:
        return 200, post(url, path, body)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _ids(grid=None):
    """The prompt ids the servers build without a tokenizer."""
    if grid is None:
        return np.asarray([100, 200, 300, 400], np.int64)
    return expand_vision_tokens([100, 200], [300, 400], grid)


def test_health_metrics_and_page(w):
    with serving(w["teng"]()) as (url, _):
        health = json.loads(get(url, "/health")[0])
        assert health == {"ok": True, "method": "selector", "budget": 0.5}
        page, ctype = get(url, "/")
        assert "text/html" in ctype and "/generate" in page
        assert get(url, "/chat")[0] == page
        before = get(url, "/metrics")[0]
        assert "vst_requests_total 0" in before
        out = post(url, "/generate", {"prompt": "hi", "max_new_tokens": 3})
        after = get(url, "/metrics")[0]
        assert "vst_requests_total 1" in after
        assert f"vst_tokens_out_total {len(out['tokens'])}" in after
        with pytest.raises(urllib.error.HTTPError) as e:
            get(url, "/nope")
        assert e.value.code == 404


@pytest.mark.parametrize("with_image", [True, False])
def test_generate_matches_jax_server(w, with_image):
    """/generate's tokens and vision counts equal the JAX ``Server``'s for
    the same request (the image as a PNG, which the JAX side reads with
    Pillow and the port with its own reader)."""
    b64 = _b64(w["img"]) if with_image else None
    want = w["jsrv"].generate("hi", b64, 12)
    with serving(w["teng"]()) as (url, _):
        got = post(url, "/generate", {"prompt": "hi", "image_b64": b64,
                                      "max_new_tokens": 12})
    assert got["tokens"] == [int(t) for t in want["tokens"]]
    assert len(set(got["tokens"])) > 3
    for key in ("num_vision_tokens", "kept_vision_tokens"):
        assert got[key] == want[key]
    assert got["text"] is None


def test_stream_ndjson_then_summary(w):
    """stream: true sends the first token alone, then chunks of up to 8,
    then the summary line, whose tokens are the chunks' and the
    non-streamed request's."""
    body = {"prompt": "hi", "image_b64": _b64(w["img"]),
            "max_new_tokens": 12}
    with serving(w["teng"]()) as (url, _):
        plain = post(url, "/generate", body)
        lines = [json.loads(x) for x in post(
            url, "/generate", dict(body, stream=True), raw=True).splitlines()]
    chunks, summary = lines[:-1], lines[-1]
    assert [len(c["tokens"]) for c in chunks] == [1, 8, 3]
    assert summary["done"] is True
    assert sum((c["tokens"] for c in chunks), []) == summary["tokens"] \
        == plain["tokens"]


def test_chat_completions_and_sse(w):
    """The OpenAI endpoint: text + image_url (data: base64) content parts;
    the message is the /generate tokens (no tokenizer: ids as text); SSE
    deltas concatenate to the same ids, then a stop chunk and [DONE]."""
    b64 = _b64(w["img"])
    msg = [{"role": "user", "content": [
        {"type": "text", "text": "hi"},
        {"type": "image_url", "image_url": {
            "url": f"data:image/png;base64,{b64}"}}]}]
    with serving(w["teng"]()) as (url, _):
        plain = post(url, "/generate", {"prompt": "hi", "image_b64": b64,
                                        "max_new_tokens": 10})
        out = post(url, "/v1/chat/completions",
                   {"messages": msg, "max_tokens": 10})
        sse = post(url, "/v1/chat/completions",
                   {"messages": msg, "max_tokens": 10, "stream": True},
                   raw=True)
    ids = " ".join(map(str, plain["tokens"]))
    assert out["choices"][0]["message"]["content"] == ids
    assert out["usage"]["completion_tokens"] == 10
    events = [x[len("data: "):] for x in sse.split("\n\n") if x]
    assert events[-1] == "[DONE]"
    deltas = [json.loads(e)["choices"][0] for e in events[:-1]]
    assert deltas[-1]["finish_reason"] == "stop"
    text = " ".join(d["delta"]["content"] for d in deltas[:-1]
                    if d["delta"]["content"])
    assert text == ids


def test_sessions_match_jax_and_refusals(w):
    """A session's three turns equal the JAX server's (the stub turn ids
    come from the same ``hash`` in one process); an image mid-session, a
    stream with a session and a repetition penalty in a session are 400s."""
    b64 = _b64(w["img"])
    turns = [{"prompt": "hi", "image_b64": b64, "max_new_tokens": 5},
             {"prompt": "what else", "max_new_tokens": 5},
             {"prompt": "and then", "max_new_tokens": 4}]
    want = [w["jsrv"].generate(t["prompt"], t.get("image_b64"),
                               t["max_new_tokens"], session="s1")["tokens"]
            for t in turns]
    with serving(w["teng"]()) as (url, srv):
        got = [post(url, "/generate", dict(t, session="s1")) for t in turns]
        assert [g["tokens"] for g in got] == [[int(x) for x in t]
                                              for t in want]
        assert all(g["session"] == "s1" for g in got)
        code, err = post_status(url, "/generate", {
            "prompt": "x", "image_b64": b64, "session": "s1"})
        assert code == 400 and "first turn" in err["error"]
        code, err = post_status(url, "/generate", {
            "prompt": "x", "session": "s1", "stream": True})
        assert code == 400 and "stream: false" in err["error"]
        code, err = post_status(url, "/generate", {
            "prompt": "x", "session": "s2", "repetition_penalty": 1.2})
        assert code == 400 and "repetition_penalty" in err["error"]
        assert list(srv.sessions) == ["s1"]


def _concurrent(url, bodies):
    out = [None] * len(bodies)

    def one(i):
        out[i] = post(url, "/generate", bodies[i])

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT)
    assert all(o is not None for o in out)
    return out


def _bodies(w):
    return [{"prompt": "a", "image_b64": _b64(w["img"]),
             "max_new_tokens": 8},
            {"prompt": "b", "image_b64": _b64(w["img2"]),
             "max_new_tokens": 8},
            {"prompt": "c", "max_new_tokens": 8},
            {"prompt": "d", "image_b64": _b64(w["img"]),
             "max_new_tokens": 8}]


def _oneshot(eng, body):
    grid = px = None
    if body.get("image_b64"):
        px, grid = preprocess_image(decode_png(base64.b64decode(
            body["image_b64"])))
    return eng.generate(_ids(grid), px, grid,
                        max_new_tokens=body["max_new_tokens"]).tokens


def test_micro_batch_serves_concurrent_requests(w):
    """--micro-batch 4: four concurrent requests share batched decodes;
    each answer equals one-shot ``generate``."""
    eng = w["teng"]()
    sizes = []
    batch = eng.generate_batch

    def counted(reqs, **kw):
        sizes.append(len(reqs))
        return batch(reqs, **kw)

    eng.generate_batch = counted
    bodies = _bodies(w)
    with serving(eng, micro_batch=4, batch_window_ms=200) as (url, _):
        got = _concurrent(url, bodies)
    assert sizes and max(sizes) > 1
    for g, b in zip(got, bodies):
        assert g["tokens"] == _oneshot(eng, b)


def test_continuous_chunked_admission(w):
    """--continuous 2 with --continuous-prefill-chunk 8: answers equal
    one-shot; /health and /metrics show the chunked admissions."""
    eng = w["teng"]()
    bodies = _bodies(w)
    with serving(eng, continuous=2, continuous_t_max=256,
                 continuous_chunk=4, continuous_prefill_chunk=8,
                 continuous_prefill_vit_segments=2) as (url, _):
        got = _concurrent(url, bodies)
        health = json.loads(get(url, "/health")[0])
        metrics = get(url, "/metrics")[0]
    for g, b in zip(got, bodies):
        assert g["tokens"] == _oneshot(eng, b)
    st = health["continuous"]
    assert st["chunked_admissions"] == 3 and st["admitted"] == 4
    assert st["prefill_chunks"] > 3
    assert "vst_continuous_chunked_admissions 3" in metrics


@pytest.mark.parametrize("continuous", [0, 2])
def test_prefix_cache(w, continuous):
    """--prefix-cache 2, one-shot and under the continuous batcher: a
    repeated request hits, its answer unchanged."""
    eng = w["teng"]()
    body = {"prompt": "hi", "image_b64": _b64(w["img"]), "max_new_tokens": 6}
    with serving(eng, prefix_cache=2, prefix_cache_min=1,
                 continuous=continuous, continuous_t_max=256) as (url, _):
        a = post(url, "/generate", body)
        b = post(url, "/generate", body)
        health = json.loads(get(url, "/health")[0])
        metrics = get(url, "/metrics")[0]
    assert a["tokens"] == b["tokens"] == _oneshot(eng, body)
    assert health["prefix_cache"] == {"hits": 1, "misses": 1, "entries": 1}
    assert "vst_prefix_cache_hits_total 1" in metrics


@pytest.mark.parametrize("channels", [3, 4])
def test_png_reader_matches_pillow(channels):
    """8-bit RGB and RGBA PNGs (Pillow's encoder, and every filter type)
    decode to Pillow's RGB pixels; other kinds are left to Pillow."""
    from PIL import Image

    img = _image(5, (37, 53), channels)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    datas = [buf.getvalue()] + [encode_png(img, f)
                                for f in ([0], [1], [2], [3], [4],
                                          [0, 1, 2, 3, 4])]
    for data in datas:
        want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        got = decode_png(data)
        assert got.dtype == np.uint8 and np.array_equal(got, want)
    grey = io.BytesIO()
    Image.fromarray(img[..., 0]).save(grey, format="PNG")
    assert decode_png(grey.getvalue()) is None
    assert decode_png(b"GIF89a") is None
    with pytest.raises(ValueError, match="CRC"):
        bad = bytearray(datas[1])
        bad[40] ^= 0xFF
        decode_png(bytes(bad))


def test_image_without_pillow_is_a_400(w, monkeypatch):
    """A JPEG needs Pillow: without it the request is a 400 naming it; a
    PNG is still served."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(w["img"]).save(buf, format="JPEG")
    jpeg = base64.b64encode(buf.getvalue()).decode()
    assert isinstance(tserve.decode_image(jpeg), Image.Image)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with serving(w["teng"]()) as (url, _):
        code, err = post_status(url, "/generate", {"prompt": "hi",
                                                   "image_b64": jpeg})
        assert code == 400 and "Pillow" in err["error"]
        ok = post(url, "/generate", {"prompt": "hi", "max_new_tokens": 2,
                                     "image_b64": _b64(w["img"])})
    assert len(ok["tokens"]) == 2


def test_build_server_main_flags(w):
    """``build_server`` from ``main``'s parser (``--device cpu``, the tiny
    random-weight config, the continuous batcher with chunked admission)
    serves /health and an image request."""
    args = tserve.build_parser().parse_args(
        ["--device", "cpu", "--port", "0", "--budget", "0.5",
         "--continuous", "2", "--continuous-t-max", "256",
         "--continuous-prefill-chunk", "8", "--decode-attn", "xla"])
    httpd = tserve.build_server(args)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        assert httpd.server_obj.batcher.decode_attn == "plain"
        out = post(url, "/generate", {"prompt": "hi", "max_new_tokens": 3,
                                      "image_b64": _b64(w["img"])})
        assert len(out["tokens"]) == 3 and out["num_vision_tokens"] == 6
        health = json.loads(get(url, "/health")[0])
        assert health["continuous"]["chunked_admissions"] == 1
    finally:
        httpd.shutdown()
        httpd.server_obj.close()
        httpd.server_close()


@pytest.mark.parametrize("flags, exc, match", [
    # ``--tp`` is ported (tests/test_torch_serve_tp.py); what it refuses is
    # a split that does not divide the heads. The two ids are the names
    # these cases had while ``--tp`` was refused as ROADMAP item 11; they
    # are kept so that each case keeps its name across the change.
    pytest.param(["--family", "llava_ov15", "--tp", "3"], ValueError,
                 "does not split",
                 id="flags0-NotImplementedError-item 11\\b"),
    pytest.param(["--tp", "3"], ValueError, "does not split",
                 id="flags1-NotImplementedError-item 11\\b"),
    (["--continuous", "2", "--continuous-auto-window"], ValueError,
     "live prefix"),
])
def test_refused_flags(flags, exc, match):
    args = tserve.build_parser().parse_args(["--device", "cpu"] + flags)
    with pytest.raises(exc, match=match):
        tserve.build_server(args)


@pytest.mark.parametrize("flags", [
    ["--speculative", "3"],
    ["--continuous", "2", "--speculative", "3"],
    ["--continuous", "2", "--continuous-kv-quant", "int4"],
], ids=["speculative", "continuous-speculative", "continuous-int4"])
def test_formerly_refused_flags_serve(flags):
    """The flags of ROADMAP item 7 (refused until it was ported) build a
    server whose /generate gives the engine's plain greedy tokens (the
    int4 pool: its first token and the budget) and report what ran."""
    args = tserve.build_parser().parse_args(
        ["--device", "cpu", "--port", "0", "--budget", "0.5",
         "--continuous-t-max", "256"] + flags)
    httpd = tserve.build_server(args)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    srv = httpd.server_obj
    try:
        img = _image(3)
        out = post(url, "/generate", {"prompt": "hi", "max_new_tokens": 6,
                                      "image_b64": _b64(img)})
        _, grid = preprocess_image(img)
        want = srv.engine.generate(_ids(grid), *preprocess_image(img),
                                   max_new_tokens=6).tokens
        if "int4" in flags:
            assert out["tokens"][0] == want[0] and len(out["tokens"]) == 6
            assert srv.batcher.pool.k.dtype.itemsize == 1
            assert srv.batcher.stats["int4_plain_decode_calls"] > 0
        else:
            assert out["tokens"] == want
            assert out["spec_proposed"] >= out["spec_accepted"] >= 0
        health = json.loads(get(url, "/health")[0])
        if "--continuous" in flags:
            assert (health["continuous"]["spec_steps"] > 0) == (
                "--speculative" in flags)
    finally:
        httpd.shutdown()
        srv.close()
        httpd.server_close()


@pytest.mark.parametrize("spec", ["int8", "int4:g32"])
def test_quantize_serves(spec):
    """``api.serve --quantize`` builds a server over the quantized tiny
    decoder whose /generate gives that engine's one-shot greedy tokens;
    a bad spec raises ValueError."""
    from visionselector_tpu_torch.models.qwen25vl.lm import is_quantized

    args = tserve.build_parser().parse_args(
        ["--device", "cpu", "--port", "0", "--quantize", spec])
    httpd = tserve.build_server(args)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    srv = httpd.server_obj
    try:
        assert is_quantized(srv.engine.params.lm)
        img = _image(4)
        out = post(url, "/generate", {"prompt": "hi", "max_new_tokens": 5,
                                      "image_b64": _b64(img)})
        _, grid = preprocess_image(img)
        want = srv.engine.generate(_ids(grid), *preprocess_image(img),
                                   max_new_tokens=5).tokens
        assert out["tokens"] == list(want) and len(want) == 5
    finally:
        httpd.shutdown()
        srv.close()
        httpd.server_close()
    with pytest.raises(ValueError, match="int4 feature"):
        tserve.build_server(tserve.build_parser().parse_args(
            ["--device", "cpu", "--quantize", "int8:g32"]))


def test_speculative_server_matches_jax_plain_tokens(w):
    """``--speculative 3`` one-shot and in continuous slots: greedy tokens
    of an image and a text request equal the JAX server's plain ones."""
    for kw in (dict(speculative=3),
               dict(speculative=3, continuous=2, continuous_t_max=256,
                    continuous_chunk=4)):
        with serving(w["teng"](), **kw) as (url, _):
            for b64 in (_b64(w["img"]), None):
                got = post(url, "/generate", {
                    "prompt": "hi", "max_new_tokens": 10, "image_b64": b64})
                want = w["jsrv"].generate("hi", b64, 10)
                assert got["tokens"] == [int(t) for t in want["tokens"]]
                assert got["spec_proposed"] % 3 == 0


def test_cuda_device_without_a_card_fails(monkeypatch):
    """--device cuda (the default) with no GPU exits; no CPU fallback."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        tserve.build_server(argparse.Namespace(port=0))
