"""``api.serve --tp 2`` on the CPU: this process is rank 0 (the HTTP
server, the engine lock, the batcher), ``serve_tp.start`` spawns rank 1,
and the two ranks meet over gloo. Every ``/generate`` through the
tensor-parallel server must give the tokens of the same request through
``--tp 0`` with the same flags: one-shot with a stream, a chat session of
two turns, and two concurrent requests through a 2-slot continuous
batcher, on a float pool and, with ``--quantize int8``, on an int8 pool.
Greedy tokens; every HTTP call under a timeout, so a rank that misses an
operation fails the test instead of hanging it."""

import base64
import json
import threading
import urllib.request

import numpy as np
import pytest

from visionselector_tpu_torch.api import serve as tserve
from visionselector_tpu_torch.preprocess.png import encode_png

TIMEOUT = 120
FLAGS = {
    "float": ["--continuous", "2"],
    "int8": ["--continuous", "2", "--continuous-kv-quant", "int8",
             "--quantize", "int8"],
}


def _b64(seed, hw):
    img = (np.random.RandomState(seed).rand(*hw, 3) * 255).astype(np.uint8)
    return base64.b64encode(encode_png(img)).decode()


def _post(url, body):
    req = urllib.request.Request(
        url + "/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
        return r.read().decode()


def _serve(flags, tp):
    args = tserve.build_parser().parse_args(
        ["--device", "cpu", "--port", "0", "--budget", "0.5", "--tp",
         str(tp)] + flags)
    httpd = tserve.build_server(args)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def _requests(url):
    """The tokens of each request kind through the server at ``url``."""
    out = {}
    bodies = [dict(prompt="a b", image_b64=_b64(0, (56, 84)),
                   max_new_tokens=6),
              dict(prompt="c d e", image_b64=_b64(1, (56, 56)),
                   max_new_tokens=5)]
    got = [None, None]

    def ask(i):
        got[i] = json.loads(_post(url, bodies[i]))["tokens"]

    threads = [threading.Thread(target=ask, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT)
    out["batcher"] = got
    lines = _post(url, dict(bodies[0], stream=True)).strip().splitlines()
    out["stream"] = json.loads(lines[-1])["tokens"]
    out["session"] = [
        json.loads(_post(url, dict(prompt=p, session="s", max_new_tokens=4,
                                   **extra)))["tokens"]
        for p, extra in (("hello there", dict(image_b64=_b64(2, (56, 56)))),
                         ("and then", {}))]
    return out


@pytest.mark.parametrize("pool", sorted(FLAGS))
def test_serve_tp2_matches_tp0(pool):
    want_srv, url0 = _serve(FLAGS[pool], 0)
    try:
        want = _requests(url0)
    finally:
        want_srv.shutdown()
        want_srv.server_obj.close()
    httpd, url = _serve(FLAGS[pool], 2)
    try:
        srv = httpd.server_obj
        assert srv.tp is not None and srv.tp.mesh.size("model") == 2
        lm = srv.engine.params.lm
        assert lm.cfg.num_attention_heads == 2  # 4 heads over 2 ranks
        got = _requests(url)
        assert srv.batcher.stats["max_concurrent"] >= 1
    finally:
        httpd.shutdown()
        httpd.server_obj.close()
    assert all(got["batcher"]) and got == want, (got, want)
