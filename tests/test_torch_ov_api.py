"""The port's entry points with ``--family llava_ov15`` on the CPU:
``api.predict`` (the tiny random-weight config, strategies, an HF
directory the test writes), ``api.run_eval`` (generate and
multiple-choice docs, text-only, image and video frames), and the HTTP
server (``build_server`` / ``Server`` over an ``OVEngine``): /generate
against the JAX package's ``Server`` over the same weights, streaming, a
session, the micro-batcher, the continuous batcher (one-shot admissions)
and the prefix cache. ``api.train --family llava_ov15 --data-flatten``
still refuses (packed rows are not ported)."""

import base64
import contextlib
import json
import os
import threading
import urllib.request
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from torch_ov_params import (  # noqa: F401 (one_thread: autouse fixture)
    configs,
    one_thread,
    ov_tree,
    port_params,
)

from visionselector_tpu.api import serve as jserve
from visionselector_tpu.models.llava_ov15 import model as jmodel
from visionselector_tpu_torch.api import predict as tpredict
from visionselector_tpu_torch.api import run_eval as trun_eval
from visionselector_tpu_torch.api import serve as tserve
from visionselector_tpu_torch.api import train as ttrain
from visionselector_tpu_torch.models.llava_ov15 import model as tmodel
from visionselector_tpu_torch.models.llava_ov15 import weights as tweights
from visionselector_tpu_torch.preprocess.image import preprocess_image
from visionselector_tpu_torch.preprocess.png import decode_png, encode_png
from visionselector_tpu_torch.preprocess.rope import expand_vision_tokens

TIMEOUT = 60  # seconds per HTTP call
OV = ["--family", "llava_ov15", "--device", "cpu"]


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


# -- predict ---------------------------------------------------------------


@pytest.mark.parametrize("method", ["selector", "orig", "visionzip",
                                    "fastv"])
def test_predict_smoke(capsys, method):
    """The tiny random config: a 112x112 image is 64 patches, 16 merged
    tokens; the selector keeps int(16 * 0.25) = 4, ``orig`` all."""
    assert tpredict.main(OV + ["--method", method, "--budget", "0.25",
                               "--max-new-tokens", "3"]) == 0
    out = _last_json(capsys)
    assert out["family"] == "llava_ov15" and out["num_vision_tokens"] == 16
    assert len(out["tokens"]) == 3
    kept = {"selector": 4, "orig": 16}.get(method)
    if kept is not None:
        assert out["kept_vision_tokens"] == kept
    else:
        assert 0 < out["kept_vision_tokens"] < 16


def test_predict_model_path(tmp_path, capsys):
    """``--model-path`` on an OV HF directory: the tokens of the engine on
    the loaded weights."""
    tree = ov_tree()
    _, cfg = configs()
    tweights.save_ov_checkpoint(port_params(tree), cfg, str(tmp_path))
    assert tpredict.main(OV + ["--model-path", str(tmp_path), "--prompt-ids",
                               "5,6,7", "--max-new-tokens", "5"]) == 0
    out = _last_json(capsys)
    hf_cfg = tweights.ov_config_from_hf(str(tmp_path))
    params = tweights.load_ov_checkpoint(str(tmp_path), hf_cfg, "cpu")
    img = (np.random.RandomState(0).rand(112, 112, 3) * 255).astype(np.uint8)
    px, grid = preprocess_image(img, min_pixels=1, max_pixels=10**9,
                                temporal_patch_size=1)
    want = tmodel.OVEngine(hf_cfg, params, device="cpu").generate(
        expand_vision_tokens([], [5, 6, 7], grid), px, grid,
        max_new_tokens=5)
    assert out["tokens"] == want.tokens and out["selector"]


# -- run_eval --------------------------------------------------------------


def _task_dir(tmp_path):
    """Task configs (a generate task, an MC task) with a text-only, an
    image and a video doc each; the video is a directory of PNG frames."""
    cfg, data = tmp_path / "configs", tmp_path / "data"
    cfg.mkdir()
    (data / "clip").mkdir(parents=True)
    with open(cfg / "tasks.json", "w") as f:
        json.dump([{"name": "ov_gen", "metric": "exact_match",
                    "max_new_tokens": 3},
                   {"name": "ov_mc", "metric": "multiple_choice",
                    "request_type": "loglikelihood"}], f)
    rng = np.random.RandomState(0)
    (data / "img.png").write_bytes(encode_png(
        (rng.rand(56, 84, 3) * 255).astype(np.uint8)))
    for i in range(4):
        (data / "clip" / f"f{i:02d}.png").write_bytes(encode_png(
            (rng.rand(56, 56, 3) * 255).astype(np.uint8)))
    docs = [{"question": "Say hi.", "answers": ["hi"], "choices": ["x", "y"]},
            {"question": "What is it?", "answers": ["A"], "image": "img.png",
             "choices": ["a thing", "b"]},
            {"question": "What happens?", "answers": ["B"], "video": "clip",
             "choices": ["A", "B", "C"]}]
    for name in ("ov_gen", "ov_mc"):
        with open(data / f"{name}.jsonl", "w") as f:
            f.writelines(json.dumps(d) + "\n" for d in docs)
    return str(cfg), str(data)


@pytest.mark.parametrize("extra", [[], ["--decode-batch", "2"]],
                         ids=["one-shot", "decode-batch"])
def test_run_eval_family_llava_ov15(tmp_path, capsys, extra):
    cfg, data = _task_dir(tmp_path)
    out = str(tmp_path / "out")
    assert trun_eval.main(OV + [
        "--task-config-dir", cfg, "--data-dir", data, "--tasks",
        "ov_gen,ov_mc", "--budgets", "0.5", "--output-dir", out] + extra) == 0
    with open(os.path.join(out, "selector_0.5_rank0.json")) as f:
        res = json.load(f)["results"]
    assert res["ov_gen/n"] == 3.0 and res["ov_mc/n"] == 3.0
    with open(os.path.join(out, "samples_selector_0.5_rank0.jsonl")) as f:
        samples = [json.loads(line) for line in f]
    assert len(samples) == 6
    assert all(s.get("prediction") is not None for s in samples)


def test_train_family_llava_ov15_still_refused(tmp_path):
    """OV training runs (``tests/test_torch_ov_train.py``); packed rows
    with it are refused with ValueError (the reference packs Qwen rows
    only and ignores the flag for this family)."""
    with pytest.raises(ValueError, match="data-flatten"):
        ttrain.main(["--family", "llava_ov15", "--smoke", "--device", "cpu",
                     "--data-flatten", "--output-dir", str(tmp_path)])


# -- serve -------------------------------------------------------------------


@pytest.fixture(scope="module")
def w():
    tree = ov_tree()
    jcfg, tcfg = configs()
    tparams = port_params(tree)

    def teng():
        return tmodel.OVEngine(tcfg, tparams, use_selector=True, budget=0.5,
                               device="cpu")

    jeng = jmodel.OVEngine(jcfg, jax.tree.map(jnp.asarray, tree),
                           use_selector=True, budget=0.5)
    rng = np.random.RandomState(0)
    return dict(teng=teng, jsrv=jserve.Server(jeng, None, "selector", 0.5),
                img=(rng.rand(56, 84, 3) * 255).astype(np.uint8),
                img2=(rng.rand(84, 56, 3) * 255).astype(np.uint8))


def _b64(pixels) -> str:
    return base64.b64encode(encode_png(pixels)).decode()


@contextlib.contextmanager
def serving(engine, **kw):
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


def _oneshot(eng, body):
    """The server's request through ``engine.generate`` (stub prompt ids
    [100, 200] + [300, 400] around the image, as the server builds
    them without a tokenizer)."""
    grid = px = None
    ids = np.asarray([100, 200, 300, 400], np.int64)
    if body.get("image_b64"):
        px, grid = preprocess_image(decode_png(base64.b64decode(
            body["image_b64"])), temporal_patch_size=1)
        ids = expand_vision_tokens([100, 200], [300, 400], grid)
    return eng.generate(ids, px, grid,
                        max_new_tokens=body["max_new_tokens"]).tokens


@pytest.mark.parametrize("with_image", [True, False])
def test_generate_matches_jax_server(w, with_image):
    b64 = _b64(w["img"]) if with_image else None
    want = w["jsrv"].generate("hi", b64, 10)
    with serving(w["teng"]()) as (url, _):
        got = post(url, "/generate", {"prompt": "hi", "image_b64": b64,
                                      "max_new_tokens": 10})
    assert got["tokens"] == [int(t) for t in want["tokens"]]
    assert len(set(got["tokens"])) > 2
    for key in ("num_vision_tokens", "kept_vision_tokens"):
        assert got[key] == want[key]


def test_stream_and_session_match_jax(w):
    """An ndjson stream concatenates to the tokens of the plain request;
    a session's two turns equal the JAX server's."""
    b64 = _b64(w["img"])
    turns = [{"prompt": "hi", "image_b64": b64, "max_new_tokens": 5},
             {"prompt": "what else", "max_new_tokens": 4}]
    want = [w["jsrv"].generate(t["prompt"], t.get("image_b64"),
                               t["max_new_tokens"], session="s")["tokens"]
            for t in turns]
    with serving(w["teng"]()) as (url, _):
        lines = [json.loads(x) for x in post(url, "/generate", dict(
            turns[0], stream=True), raw=True).splitlines() if x.strip()]
        got = [post(url, "/generate", dict(t, session="s"))["tokens"]
               for t in turns]
    streamed = sum((x["tokens"] for x in lines if not x.get("done")), [])
    assert lines[-1]["done"] and streamed == lines[-1]["tokens"] == got[0]
    assert got == [[int(x) for x in t] for t in want]


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
    return [{"prompt": "a", "image_b64": _b64(w["img"]), "max_new_tokens": 6},
            {"prompt": "b", "image_b64": _b64(w["img2"]),
             "max_new_tokens": 6},
            {"prompt": "c", "max_new_tokens": 6},
            {"prompt": "d", "image_b64": _b64(w["img"]), "max_new_tokens": 6}]


SERVER_MODES = {
    "micro-batch 4": dict(micro_batch=4, batch_window_ms=200),
    "continuous 2": dict(continuous=2, continuous_t_max=512,
                         continuous_chunk=4, continuous_prefill_chunk=8),
}


@pytest.mark.parametrize("mode", list(SERVER_MODES))
def test_concurrent_requests_match_oneshot(w, mode):
    """Four concurrent requests through the micro-batcher or the
    continuous batcher (one-shot admissions: ``OVEngine`` has no segmented
    prefill, so ``--continuous-prefill-chunk`` admits whole)."""
    eng = w["teng"]()
    bodies = _bodies(w)
    with serving(eng, **SERVER_MODES[mode]) as (url, srv):
        got = _concurrent(url, bodies)
        stats = getattr(srv.batcher, "stats", None)  # continuous only
    for g, b in zip(got, bodies):
        assert g["tokens"] == _oneshot(eng, b)
    if mode.startswith("continuous"):
        assert stats["admitted"] == 4 and stats["chunked_admissions"] == 0


def test_prefix_cache_hit(w):
    eng = w["teng"]()
    body = {"prompt": "hi", "image_b64": _b64(w["img"]), "max_new_tokens": 6}
    with serving(eng, prefix_cache=2, prefix_cache_min=1) as (url, srv):
        a = post(url, "/generate", body)
        b = post(url, "/generate", body)
        store = srv.prefix_store
    assert a["tokens"] == b["tokens"] == _oneshot(eng, body)
    assert (store.hits, store.misses) == (1, 1)


def test_build_server_family_llava_ov15(w):
    """``build_server`` from ``main``'s parser with ``--family llava_ov15``
    and the continuous batcher: an ``OVEngine`` on the tiny random config
    serves an image request."""
    args = tserve.build_parser().parse_args(
        OV + ["--port", "0", "--budget", "0.5", "--continuous", "2",
              "--continuous-t-max", "512"])
    httpd = tserve.build_server(args)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        assert isinstance(httpd.server_obj.engine, tmodel.OVEngine)
        out = post(url, "/generate", {"prompt": "hi", "max_new_tokens": 3,
                                      "image_b64": _b64(w["img"])})
        assert len(out["tokens"]) == 3 and out["num_vision_tokens"] == 6
        assert out["kept_vision_tokens"] == 3
    finally:
        httpd.shutdown()
        httpd.server_obj.close()
        httpd.server_close()
