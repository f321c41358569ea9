"""The port's data tools, ``train.check_data`` and ``train.prep_data``,
against the JAX package's copies: the same problems, printed lines and
exit codes; byte-equal output files (``random.Random(seed)`` sampling and
shuffling) and the same printed JSON. Seeded files in ``tmp_path``; no
model."""

import json
import random

import numpy as np
import pytest

from visionselector_tpu.train import check_data as jcheck
from visionselector_tpu.train import prep_data as jprep
from visionselector_tpu_torch.train import check_data as tcheck
from visionselector_tpu_torch.train import prep_data as tprep


def _png(path, hw=(28, 28)):
    from PIL import Image

    Image.fromarray((np.random.RandomState(0).rand(*hw, 3) * 255).astype(
        np.uint8)).save(path)


def _records(kind):
    good = [{"image": "a.png", "conversations": [
        {"from": "human", "value": "<image>What?"},
        {"from": "gpt", "value": "A thing."}]},
        {"conversations": [{"from": "user", "value": "Hi"},
                           {"from": "assistant", "value": "Hello" * 4}]}]
    if kind == "clean":
        return good
    return good + [
        {"image": "missing.png", "conversations": [
            {"from": "human", "value": "<image>x"}]},
        {"image": "bad.png", "conversations": [
            {"from": "human", "value": "no placeholder"}]},
        {"image": "a.png", "conversations": []},
        {"conversations": [{"from": "gpt", "value": "first"}]},
        {"conversations": [{"from": "human", "value": "y" * 120}]},
    ]


@pytest.mark.parametrize("kind, fmt, max_tokens", [
    ("clean", "jsonl", None), ("clean", "json", 10), ("problems", "jsonl",
                                                       None),
    ("problems", "json", 30)])
def test_check_data_matches_jax(tmp_path, capsys, kind, fmt, max_tokens):
    """``check`` returns the reference's (n, problems) (a missing image, a
    corrupt one, no placeholder, empty conversations, a first turn not
    from the user, too many tokens); ``main`` prints the same lines and
    exits 1 on problems, 0 on a clean file."""
    _png(tmp_path / "a.png")
    (tmp_path / "bad.png").write_bytes(b"not a png")
    path = tmp_path / f"data.{fmt}"
    recs = _records(kind)
    path.write_text("\n".join(map(json.dumps, recs)) if fmt == "jsonl"
                    else json.dumps(recs))
    got = tcheck.check(str(path), str(tmp_path), max_tokens)
    want = jcheck.check(str(path), str(tmp_path), max_tokens)
    assert [got[0], [i for i, _ in got[1]]] == [want[0],
                                                [i for i, _ in want[1]]]
    # the corrupt-image message carries Pillow's text: compare its start
    assert [m.split(":")[0] for _, m in got[1]] == [
        m.split(":")[0] for _, m in want[1]]
    argv = ["--annotation", str(path), "--image-root", str(tmp_path)]
    if max_tokens is not None:
        argv += ["--max-tokens", str(max_tokens)]
    rc_t = tcheck.main(argv)
    out_t = capsys.readouterr().out
    rc_j = jcheck.main(argv)
    out_j = capsys.readouterr().out
    assert rc_t == rc_j == (1 if got[1] else 0)
    assert out_t == out_j
    assert (kind == "clean") == (not got[1])


def _jsonl(path, n, tag, seed):
    rng = random.Random(seed)
    sources = ["coco", "ocr_vqa", "ChartQA", "misc"]
    lines = [json.dumps({"id": i, "image": f"{rng.choice(sources)}/{tag}{i}"
                         ".jpg", "v": "é"}, ensure_ascii=False)
             for i in range(n)]
    path.write_text("\n".join(lines) + "\n\n", encoding="utf-8")
    return str(path)


def test_prep_data_filter_matches_jax(tmp_path, capsys):
    """``filter``: the per-dataset files byte-equal to the reference's
    (case-insensitive substring of 'image', first match wins, non-ASCII
    kept) and the same printed counts."""
    src = _jsonl(tmp_path / "all.jsonl", 40, "x", 1)
    outs = {}
    for name, mod in (("t", tprep), ("j", jprep)):
        d = tmp_path / name
        assert mod.main(["filter", "--input", src, "--output-dir", str(d),
                         "--datasets", "coco,chartqa,ocr_vqa",
                         "--base", "mix"]) == 0
        outs[name] = (capsys.readouterr().out,
                      {p.name: p.read_bytes() for p in d.iterdir()})
    assert outs["t"] == outs["j"]
    assert sum(json.loads(outs["t"][0]).values()) > 0


@pytest.mark.parametrize("ratios, seed", [
    ("0.5,1.0", 42), ("0.3,0.05", 7), ("1.0,1.0", 0)])
def test_prep_data_sample_merge_matches_jax(tmp_path, capsys, ratios, seed):
    """``sample-merge``: the merged file byte-equal to the reference's for
    the same inputs, ratios and seed, and the same printed JSON (the path
    aside)."""
    a = _jsonl(tmp_path / "a.jsonl", 30, "a", 2)
    b = _jsonl(tmp_path / "b.jsonl", 17, "b", 3)
    r1, r2 = ratios.split(",")
    got = {}
    for name, mod in (("t", tprep), ("j", jprep)):
        out = tmp_path / f"{name}.jsonl"
        assert mod.main(["sample-merge", "--inputs", f"{a}:{r1},{b}:{r2}",
                         "--output", str(out), "--seed", str(seed)]) == 0
        printed = json.loads(capsys.readouterr().out)
        got[name] = (printed["merged"], out.read_bytes())
    assert got["t"] == got["j"]
    assert tprep.sample_jsonl(a, float(r1), seed) == jprep.sample_jsonl(
        a, float(r1), seed)
