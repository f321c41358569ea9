"""Video and several-image docs through the port's eval harness and
training records, and the OpenAI-compatible eval adapter, on
qwen25vl_tiny (CPU, fp32) with the JAX package beside it on the same
weights (``from_jax_params``) and the same stub tokenizer:

- ``EngineAdapter`` prepares a video doc (an ``.npy`` clip) and a
  two-image doc as the JAX adapter does, and ``evaluate`` gives the JAX
  harness's predictions and results on generate and multiple-choice tasks
  of such docs;
- ``build_sample_from_record`` on a ``<video>`` record equals the JAX
  package's sample field for field (kv bounds at the port's own tile);
- ``OpenAICompatAdapter`` against the port's ``api.serve`` on 127.0.0.1
  (a free port, every call under a timeout): payload shape and URL
  normalisation, ``api.run_eval --http-endpoint`` and ``lmms_eval_cli
  --model openai_compatible`` over the live server, loglikelihood tasks
  refused."""

import base64
import contextlib
import json
import os
import socket
import threading
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image
from torch_port_params import jax_param_tree

from visionselector_tpu.core.config import qwen25vl_tiny as jax_tiny
from visionselector_tpu.eval import evaluator as jev
from visionselector_tpu.eval import tasks as jtasks
from visionselector_tpu.models.qwen25vl import model as jmodel
from visionselector_tpu.preprocess import video as jvideo
from visionselector_tpu.train import dataset as jdataset
from visionselector_tpu_torch.api import lmms_eval_cli as tlmms
from visionselector_tpu_torch.api import run_eval as trun_eval
from visionselector_tpu_torch.api import serve as tserve
from visionselector_tpu_torch.core.config import qwen25vl_tiny
from visionselector_tpu_torch.eval import evaluator as tev
from visionselector_tpu_torch.eval import http_adapter as thttp
from visionselector_tpu_torch.eval import tasks as ttasks
from visionselector_tpu_torch.models.qwen25vl import model as tmodel
from visionselector_tpu_torch.models.qwen25vl.weights import from_jax_params
from visionselector_tpu_torch.preprocess.png import decode_png
from visionselector_tpu_torch.train import dataset as tdataset

GEN, MC = "port_video_gen", "port_video_mc"
TIMING = ("/wall_s", "avg_prefill_ms", "avg_latency_ms")


class Tok:
    """The JAX eval tests' stub tokenizer (word hashes)."""

    def encode(self, s):
        return [abs(hash(w)) % 1000 + 600 for w in s.split()][:8]

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(i) for i in ids)


def _frames(t, hw, seed):
    rng = np.random.RandomState(seed)
    return (rng.rand(t, *hw, 3) * 255).astype(np.uint8)


@pytest.fixture(scope="module")
def engines():
    tree = jax_param_tree(jax_tiny(), seed=0, scorer_std=0.02)
    return (jmodel.QwenVLEngine(jax_tiny(), jax.tree.map(jnp.asarray, tree),
                                budget=0.5),
            tmodel.QwenVLEngine(qwen25vl_tiny(),
                                from_jax_params(tree, qwen25vl_tiny(), "cpu"),
                                budget=0.5, device="cpu"))


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """A generate task (a video doc, a two-image doc, a text doc) and an MC
    task (a video doc with choices), registered in both registries and
    removed at the end; 4-frame 28x42 clips (process_video upsizes them to
    its 100,352-pixel floor: 280x392, grid (2, 20, 28))."""
    d = tmp_path_factory.mktemp("video_eval")
    np.save(d / "v0.npy", _frames(4, (28, 42), 0))
    np.save(d / "v1.npy", _frames(4, (28, 42), 1))
    for i, hw in enumerate(((56, 56), (56, 84))):
        Image.fromarray(_frames(1, hw, 5 + i)[0]).save(d / f"i{i}.png")
    docs = {GEN: [{"question": "What happens?", "answers": ["x"],
                   "video": "v0.npy"},
                  {"question": "Compare them.", "answers": ["y"],
                   "images": ["i0.png", "i1.png"]},
                  {"question": "Say hi.", "answers": ["hi"]}],
            MC: [{"question": "Which event?", "answers": ["B"],
                  "video": "v1.npy", "choices": ["a run", "a jump", "z"]}]}
    for name, rows in docs.items():
        with open(d / f"{name}.jsonl", "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in rows)
    configs = {GEN: dict(metric="exact_match", max_new_tokens=4),
               MC: dict(metric="multiple_choice",
                        request_type="loglikelihood")}
    regs = ((jtasks.TASKS, jtasks.TaskConfig),
            (ttasks.TASKS, ttasks.TaskConfig))
    for reg, cls in regs:
        for name, kw in configs.items():
            reg[name] = cls(name, **kw)
    yield d
    for reg, _ in regs:
        for name in configs:
            reg.pop(name)


def test_prepared_requests_match_jax(engines, data_dir):
    jeng, teng = engines
    for req in ttasks.load_task_docs(ttasks.TASKS[GEN], str(data_dir))[:2]:
        got, ggrid = tev.EngineAdapter(teng, Tok())._prepare_request(req)
        want, wgrid = jev.EngineAdapter(jeng, Tok())._prepare_request(req)
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        if req.video_path is None:
            assert len(ggrid) == 2
            np.testing.assert_array_equal(ggrid, wgrid)
        else:
            assert ggrid is None and wgrid is None
            assert tuple(got["video_grid_thw"][0]) == (2, 20, 28)


def _untimed(res):
    return {k: v for k, v in res.items() if not k.endswith(TIMING)}


def test_evaluate_video_and_multi_image_docs_match_jax(engines, data_dir,
                                                       tmp_path):
    """``evaluate`` over both tasks (the MC video doc through
    ``run_loglikelihood_choices``): equal predictions and results."""
    jeng, teng = engines
    out = {}
    for tag, adapter, evaluate in (
            ("jax", jev.EngineAdapter(jeng, Tok()), jev.evaluate),
            ("port", tev.EngineAdapter(teng, Tok()), tev.evaluate)):
        path = tmp_path / f"{tag}.jsonl"
        res = evaluate(adapter, [GEN, MC], str(data_dir),
                       log_samples_path=str(path))
        with open(path) as f:
            out[tag] = (res, [json.loads(x)["prediction"] for x in f])
    assert out["port"][1] == out["jax"][1] and len(out["port"][1]) == 4
    assert _untimed(out["port"][0]) == _untimed(out["jax"][0])
    assert out["port"][1][3] in "ABC"


def test_video_doc_skips_the_visualization(engines, data_dir, tmp_path):
    _, teng = engines
    adapter = tev.EngineAdapter(teng, Tok(), visualize_dir=str(tmp_path))
    req = ttasks.load_task_docs(ttasks.TASKS[GEN], str(data_dir))[0]
    assert req.video_path is not None
    assert isinstance(adapter.generate_until([req])[0], str)
    assert os.listdir(tmp_path) == []


class StubTokenizer:
    """One id per character; never an image or vision-marker id."""

    def encode(self, text):
        return [ord(c) % 500 + 10 for c in text]


def test_video_training_record_matches_jax(tmp_path):
    np.save(tmp_path / "clip.npy", _frames(5, (56, 84), 3))
    ann = tmp_path / "data.jsonl"
    ann.write_text(json.dumps({
        "id": 0, "video": "clip.npy", "conversations": [
            {"from": "human", "value": "<video>What moves?"},
            {"from": "gpt", "value": "A ball"}]}) + "\n")
    tok = StubTokenizer()
    jr = jdataset.ConversationDataset(str(ann), str(tmp_path), tok)[0]
    tr = tdataset.ConversationDataset(str(ann), str(tmp_path), tok)[0]
    assert jr["video"] == tr["video"] and tr["image"] is None
    kw = dict(min_pixels=56 * 56, max_pixels=56 * 84)
    js = jdataset.build_sample_from_record(jax_tiny(), jr, 0.5, 256, 256,
                                           **kw)
    ts = tdataset.build_sample_from_record(qwen25vl_tiny(), tr, 0.5, 256,
                                           256, align_windows=False, **kw)
    # 5 frames sample 4 (smart_nframes): grid (2, 4, 6)
    assert int(ts.num_merged) == 2 * 4 * 6 // 4
    assert (ts.input_ids == qwen25vl_tiny().video_token_id).sum() == \
        int(ts.num_merged)
    for f in js._fields:
        if f.endswith("kv_bounds"):
            continue
        np.testing.assert_array_equal(getattr(ts, f), getattr(js, f),
                                      err_msg=f)


# -- the OpenAI-compatible adapter ---------------------------------------


@contextlib.contextmanager
def serving(engine):
    """The port's server on 127.0.0.1, a free port; yields its URL."""
    srv = tserve.Server(engine, None, "selector", 0.5)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), tserve.make_handler(srv))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}"
    finally:
        httpd.shutdown()
        srv.close()
        httpd.server_close()


@pytest.fixture(scope="module")
def http_data(tmp_path_factory):
    """A chartqa task of a text-only doc and two one-image docs, and a
    loglikelihood task (scienceqa_img_ll) of one doc."""
    d = tmp_path_factory.mktemp("http_eval")
    for i in range(2):
        Image.fromarray(_frames(1, (56, 56), i)[0]).save(d / f"img{i}.png")
    with open(d / "chartqa.jsonl", "w") as f:
        for i in range(3):
            doc = {"question": f"What is value {i}?", "answers": [str(i)]}
            if i:
                doc["image"] = f"img{i - 1}.png"
            f.write(json.dumps(doc) + "\n")
    (d / "scienceqa_img.jsonl").write_text(json.dumps(
        {"question": "Pick.", "answers": ["A"], "choices": ["a", "b"]})
        + "\n")
    return d


def test_payload_shape_and_url_normalization(http_data):
    a = thttp.OpenAICompatAdapter("http://h:1")
    assert a.url == "http://h:1/v1/chat/completions"
    assert thttp.OpenAICompatAdapter(
        "http://h:1/v1/").url == "http://h:1/v1/chat/completions"
    assert thttp.OpenAICompatAdapter(
        "http://h:1/v1/chat/completions").url == a.url
    req = ttasks.load_task_docs(ttasks.TASKS["chartqa"], str(http_data))[1]
    payload = a._payload(req, until=("<|im_end|>",))
    parts = payload["messages"][0]["content"]
    assert parts[0] == {"type": "text", "text": req.question}
    with open(req.image_path, "rb") as f:
        raw = f.read()
    assert parts[1]["image_url"]["url"] == (
        "data:image/png;base64," + base64.b64encode(raw).decode())
    assert payload["max_tokens"] == req.task.max_new_tokens
    assert payload["temperature"] == 0.0 and payload["stop"] == [
        "<|im_end|>"]


def test_video_payload_sends_sampled_frames_as_png(tmp_path):
    """A video doc: ``max_frames`` sampled frames, each a PNG data URI
    that decodes to the frame ``load_video_frames`` samples (the JAX
    adapter's frames, encoded without Pillow)."""
    clip = _frames(10, (28, 42), 7)
    np.save(tmp_path / "c.npy", clip)
    req = ttasks.Request(doc_id=0, question="Q?", answers=["a"],
                         image_path=None, task=ttasks.TASKS["chartqa"],
                         video_path=str(tmp_path / "c.npy"))
    parts = thttp.OpenAICompatAdapter("http://h:1", max_frames=4)._payload(
        req, until=())["messages"][0]["content"]
    want, _ = jvideo.load_video_frames(clip, {"nframes": 4})
    assert len(parts) == 5
    for part, frame in zip(parts[1:], want):
        uri = part["image_url"]["url"]
        assert uri.startswith("data:image/png;base64,")
        np.testing.assert_array_equal(
            decode_png(base64.b64decode(uri.split(",", 1)[1])), frame)


def test_run_eval_http_endpoint_over_the_port_server(engines, http_data,
                                                     tmp_path):
    """``api.run_eval --http-endpoint`` against the port's server: every
    doc answered, the task's metric keys, and the predictions those of the
    server's own ``generate`` path (a second run equal)."""
    _, teng = engines
    out = [str(tmp_path / "a"), str(tmp_path / "b")]
    with serving(teng) as url:
        for o in out:
            assert trun_eval.main([
                "--data-dir", str(http_data), "--tasks", "chartqa",
                "--http-endpoint", url, "--http-concurrency", "2",
                "--output-dir", o, "--device", "cpu"]) == 0
    res = []
    for o in out:
        with open(os.path.join(o, "http_endpoint.json")) as f:
            res.append(json.load(f))
    assert res[0]["results"]["chartqa/n"] == 3.0
    assert "chartqa/relaxed_accuracy" in res[0]["results"]
    assert res[0]["endpoint"] == url
    assert _untimed(res[0]["results"]) == _untimed(res[1]["results"])


def test_lmms_eval_cli_openai_compatible_over_the_port_server(
        engines, http_data, tmp_path):
    _, teng = engines
    with serving(teng) as url:
        assert tlmms.main([
            "--model", "openai_compatible", "--model_args",
            f"base_url={url}/v1,model=tiny", "--tasks", "chartqa",
            "--data_dir", str(http_data), "--output_path",
            str(tmp_path)]) == 0
    with open(tmp_path / "http_endpoint.json") as f:
        assert json.load(f)["results"]["chartqa/n"] == 3.0


def test_loglikelihood_tasks_are_refused(http_data, tmp_path):
    adapter = thttp.OpenAICompatAdapter("http://h:1")
    with pytest.raises(SystemExit, match="log-probs"):
        adapter.predict_multiple_choice([])
    with pytest.raises(SystemExit, match="log-probs"):
        tev.evaluate(adapter, ["scienceqa_img_ll"], str(http_data))
    assert adapter.generate_until_multi_round([]) == []


def test_unreachable_endpoint_fails_after_its_retries(tmp_path):
    """A closed port: each request tries ``retries`` times, then raises."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        url = f"http://127.0.0.1:{s.getsockname()[1]}"
    adapter = thttp.OpenAICompatAdapter(url, retries=1, timeout=5)
    req = ttasks.Request(doc_id=0, question="Q?", answers=["a"],
                         image_path=None, task=ttasks.TASKS["chartqa"])
    with pytest.raises(RuntimeError, match="failed after 1 attempts"):
        adapter.generate_until([req])
