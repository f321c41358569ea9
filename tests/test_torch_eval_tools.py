"""The port's copies of the eval tools (``eval/lite.py``,
``eval/export_tasks.py``) against the JAX package's on the same inputs:
``lite``'s k-center subsets byte for byte, with the same printed lines and
the same failures; every ``EXPORTERS`` family exported by both packages
from the synthetic parquet and ``save_to_disk`` releases of
``tests/test_export_tasks.py``, the jsonl and image files byte for byte,
and read back by the port's ``eval.tasks``; the export CLI's ``--limit``
and an unknown task."""

import base64
import io
import json
import os

import numpy as np
import pytest

from visionselector_tpu.eval import export_tasks as jexport
from visionselector_tpu.eval import lite as jlite
from visionselector_tpu_torch.eval import export_tasks as texport
from visionselector_tpu_torch.eval import lite as tlite
from visionselector_tpu_torch.eval.tasks import TASKS, load_task_docs


def png_bytes(seed=0, size=28):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(
        (np.random.RandomState(seed).rand(size, size, 3) * 255
         ).astype(np.uint8)).save(buf, format="PNG")
    return buf.getvalue()


def _img(seed):
    return {"bytes": png_bytes(seed), "path": None}


def _b64(seed):
    return base64.b64encode(png_bytes(seed)).decode()


# --------------------------------------------------------------- lite

def _lite_docs(n, dup=False):
    rng = np.random.RandomState(n)
    words = ["chart", "bar", "sales", "year", "cat", "dog", "red", "blue",
             "table", "total", "price", "city", "river", "sum", "axis"]
    docs = []
    for i in range(n):
        q = " ".join(rng.choice(words, 5)) if not dup else "same question"
        docs.append({"question": q, "answers": [str(i % 3)],
                     "image": f"img_{i}.png"})
    return docs


LITE_CASES = {
    "spread": ([("chartqa", _lite_docs(20))], ["--k", "5"]),
    "k_over_n": ([("chartqa", _lite_docs(4))], ["--k", "9"]),
    "duplicates": ([("chartqa", _lite_docs(6, dup=True))], ["--k", "3"]),
    "two_tasks": ([("chartqa", _lite_docs(12)), ("docvqa", _lite_docs(9))],
                  ["--k", "4"]),
}


@pytest.mark.parametrize("case", list(LITE_CASES))
def test_lite_matches_jax(tmp_path, capsys, case):
    tasks, extra = LITE_CASES[case]
    data = tmp_path / "data"
    data.mkdir()
    for name, docs in tasks:
        with open(data / f"{name}.jsonl", "w") as f:
            f.writelines(json.dumps(d) + "\n" for d in docs)
    names = ",".join(n for n, _ in tasks)
    printed = {}
    for tag, mod in (("jax", jlite), ("port", tlite)):
        out = tmp_path / tag
        assert mod.main(["--data-dir", str(data), "--task", names,
                         "--output-dir", str(out)] + extra) == 0
        printed[tag] = [json.loads(line) for line in
                        capsys.readouterr().out.splitlines()]
    for name, _ in tasks:
        with open(tmp_path / "jax" / f"{name}.jsonl", "rb") as f:
            want = f.read()
        with open(tmp_path / "port" / f"{name}.jsonl", "rb") as f:
            assert f.read() == want and want
    for a, b in zip(printed["jax"], printed["port"]):
        assert a["task"] == b["task"] and a["kept"] == b["kept"]
    assert len(printed["port"]) == len(tasks)


@pytest.mark.parametrize("argv, exc", [
    (["--task", "chartqa", "--output-dir", "x"], SystemExit),
    (["--task", "missing", "--output-dir", "x"], FileNotFoundError),
])
def test_lite_failures_match_jax(tmp_path, argv, exc):
    """A missing required flag exits 2 in both; a missing task file raises
    FileNotFoundError in both."""
    if exc is FileNotFoundError:
        argv = ["--data-dir", str(tmp_path)] + argv
    codes = []
    for mod in (jlite, tlite):
        with pytest.raises(exc) as e:
            mod.main(argv)
        codes.append(e.value.code if exc is SystemExit else type(e.value))
    assert codes[0] == codes[1]


# ------------------------------------------------------- export_tasks

def _parquet(rows):
    return ("parquet", rows)


# One or more releases per exporter family, in the reference task's field
# schema (the fixtures of tests/test_export_tasks.py).
EXPORT_CASES = {
    "vqa": [
        ("chartqa", _parquet([{"question": f"What is {i}?", "answer": str(i),
                               "image": _img(i), "type": "t"}
                              for i in range(3)])),
        ("textvqa_val", _parquet([{"question": "What?", "answers": ["w"] * 10,
                                   "image": _img(4)}])),
        ("pope", _parquet([{"question": "Is there a cat?", "answer": "yes",
                            "image": _img(3)}])),
        ("mme", _parquet([{"question": "Red?", "answer": "Yes",
                           "image": _img(5)}])),
        ("ocrbench", _parquet([{"question": "Text?", "answer": ["ab", "AB"],
                                "image": _img(6)}])),
        ("gqa", _parquet([{"question": "Where?", "answer": "left",
                           "image": _img(7)}])),
        ("ocr_vqa", _parquet([{"question": "Title?", "answers": ["Dune"],
                               "image": _img(6)}])),
    ],
    "docvqa_disk": [("docvqa_val", ("disk_image", {
        "question": ["q0", "q1"], "answers": [["a", "b"], ["c"]],
        "image": [0, 1]}))],
    "mc": [
        ("scienceqa_img", _parquet([
            {"question": "Which?", "choices": ["x", "y", "z"], "answer": 2,
             "hint": "a hint", "image": _img(1)},
            {"question": "skipme", "choices": ["x", "y"], "answer": 0,
             "hint": "", "image": None}])),
        ("ai2d_no_mask", _parquet([{"question": "Part?",
                                    "options": ["leaf", "stem"],
                                    "answer": "1", "image": _img(2)}])),
        ("mmbench", _parquet([{"question": "Pick", "hint": None, "A": "one",
                               "B": "two", "C": None, "D": None, "E": None,
                               "answer": "b", "image": _img(5)}])),
        ("qbench_dev", _parquet([{"question": "Quality?", "option0": "good",
                                  "option1": "bad", "option2": "N/A",
                                  "option3": "N/A", "correct_choice": "bad",
                                  "image": _img(5)}])),
        ("illusionvqa", _parquet([{"question": "What shape?",
                                   "options": ["circle", "square"],
                                   "answer": "square", "image": _img(8)}])),
        ("vmcbench", _parquet([{"question": "Pick", "A": "x", "B": "y",
                                "C": "z", "D": "w", "answer": "C",
                                "image": _img(7)}])),
    ],
    "embedded_options": [
        ("mmstar", _parquet([{"question": "Q?\nOptions: A. x, B. y",
                              "answer": "(A)", "image": _img(1)}])),
        ("realworldqa", _parquet([{"question": "How many?\nA. 1\nB. 2",
                                   "answer": "b", "image": _img(2)}])),
        ("hallusion_bench_image", _parquet([
            {"question": "Is the chart rising?", "gt_answer": "1",
             "image": _img(3)},
            {"question": "no-figure row", "gt_answer": "0", "image": None}])),
    ],
    "base64": [
        ("mme_realworld", _parquet([{"question": "Pick one.",
                                     "multi-choice options": ["(A) cat",
                                                              "(B) dog"],
                                     "answer": "(B)", "bytes": _b64(4)}])),
        ("websrc", _parquet([{"question": "What is the price?",
                              "answer": "$10", "image": _b64(2)}])),
        ("hrbench", _parquet([{"question": "Where?", "A": "left",
                               "B": "right", "C": float("nan"),
                               "D": float("nan"), "answer": "A",
                               "image": _b64(6)}])),
    ],
    "image_lists": [
        ("seedbench", ("disk_seq", {
            "question": ["Which scene?"], "choice_a": ["rain"],
            "choice_b": ["sun"], "choice_c": ["snow"], "choice_d": ["fog"],
            "answer": ["B"], "image": [[0, 1]]})),
        ("muirbench", ("disk_seq", {
            "question": ["Which image shows a dog?"],
            "options": [["first", "second"]], "answer": ["second"],
            "image_list": [[0, 1]]})),
    ],
    "multi_image": [
        ("mmmu_val", _parquet([
            {"question": "Compare <image 1> and <image 2>.",
             "options": "['alpha', 'beta']", "answer": "B",
             "image_1": _img(7), "image_2": _img(8), "image_3": None,
             "image_4": None, "image_5": None, "image_6": None,
             "image_7": None},
            {"question": "Open-ended?", "options": "", "answer": "42",
             "image_1": _img(9), "image_2": None, "image_3": None,
             "image_4": None, "image_5": None, "image_6": None,
             "image_7": None}])),
        ("multidocvqa", _parquet([dict(
            {"question": "Total?", "answers": "['42', 'forty two']"},
            **{f"image_{i}": _img(i) if i <= 2 else None
               for i in range(1, 21)})])),
        ("iconqa", _parquet([
            {"question": "How many?", "ques_type": "choose_txt",
             "choices": "two,three,four", "answer": "1",
             "query_image": _img(3)},
            {"question": "Fill: __", "ques_type": "fill_in_blank",
             "choices": None, "answer": "seven", "query_image": _img(4)},
            {"question": "Which image?", "ques_type": "choose_img",
             "choices": None, "answer": "0", "query_image": _img(5)}])),
    ],
    "captions": [
        (task, _parquet([{field: ["a cat on a mat", "a feline resting"],
                          "image": _img(1)}]))
        for task, field in (("coco2017_cap_val", "answer"),
                            ("nocaps_val", "annotations_captions"),
                            ("textcaps_val", "caption_str"),
                            ("flickr30k_test", "caption"))
    ],
    "video_index": [
        ("videomme", _parquet([{"question": "What happens?",
                                "options": ["A. x", "B. y", "C. z", "D. w"],
                                "answer": "C", "videoID": "vid001"}])),
        ("egoschema", _parquet([{"question": "What?",
                                 "option": ["A. run", "B. sit"],
                                 "answer": 1, "video_idx": "ego1"}])),
        ("nextqa_mc_test", _parquet([{"question": "Why?", "a0": "x",
                                      "a1": "y", "a2": "z", "a3": "w",
                                      "a4": "v", "answer": 0,
                                      "video": 4321}])),
        ("perceptiontest_val_mc", _parquet([{"question": "Which?",
                                             "options": ["p", "q", "r"],
                                             "answer_id": 2,
                                             "video_name": "video_77"}])),
    ],
    "video_letter": [
        ("tempcompass_mc", _parquet([{"question": "Which is correct?\n"
                                                  "A. fast\nB. slow",
                                      "answer": "A. fast",
                                      "video_id": "tc9"}])),
        ("mlvu", _parquet([{"question": "Pick.\n(A) one (B) two",
                            "answer": "(B) two", "video_name": "clip.mp4",
                            "task_type": "plotQA"}])),
        ("longvideobench", _parquet([{"question": "What first?",
                                      "option0": "walk", "option1": "jump",
                                      "option2": "N/A", "option3": "N/A",
                                      "option4": "N/A", "correct_choice": 1,
                                      "video_path": "lvb/v1.mp4"}])),
        ("mvbench", _parquet([{"question": "Order?",
                               "candidates": ["first", "second"],
                               "answer": "second",
                               "video": "sub/mv1.mp4"}])),
        ("egoplan", _parquet([{"task_goal": "my goal is to make coffee",
                               "choice_a": "pour water",
                               "choice_b": "grind beans",
                               "choice_c": "open fridge",
                               "choice_d": "wash cup",
                               "golden_choice_idx": "B",
                               "sample_id": 1234}])),
        ("videommmu", _parquet([
            {"question": "Which theorem?", "question_type": "multiple-choice",
             "options": "['Bayes', 'Fermat']", "answer": "A",
             "id": "math_1_q"},
            {"question": "State the value.", "question_type": "open",
             "options": None, "answer": "3.14", "id": "math_2_q"}])),
    ],
}


def _write_release(path, kind, rows):
    """A parquet file, or a ``save_to_disk`` directory whose image columns
    (seeds) become Image / Sequence(Image) features."""
    if kind == "parquet":
        import pyarrow as pa
        import pyarrow.parquet as pq

        cols = {k: [r[k] for r in rows] for k in rows[0]}
        pq.write_table(pa.table(cols), path + ".parquet")
        return path + ".parquet"
    import datasets
    from PIL import Image

    def pil(seed):
        return Image.open(io.BytesIO(png_bytes(seed)))

    cols = dict(rows)
    name = "image" if "image" in cols else "image_list"
    if kind == "disk_image":
        cols[name] = [pil(s) for s in cols[name]]
        feature = datasets.Image()
    else:
        cols[name] = [[pil(s) for s in seeds] for seeds in cols[name]]
        feature = datasets.Sequence(datasets.Image())
    datasets.Dataset.from_dict(cols).cast_column(name, feature).save_to_disk(
        path)
    return path


def _tree_bytes(root):
    out = {}
    for base, _, files in os.walk(root):
        for f in files:
            p = os.path.join(base, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


@pytest.mark.parametrize("family", list(EXPORT_CASES))
def test_exporters_match_jax(tmp_path, family):
    for task, (kind, rows) in EXPORT_CASES[family]:
        src = _write_release(str(tmp_path / f"src_{task}"), kind, rows)
        outs = {}
        for tag, mod in (("jax", jexport), ("port", texport)):
            out = str(tmp_path / f"{tag}_{task}")
            outs[tag] = (mod.export_task(task, src, out), _tree_bytes(out))
        assert outs["port"] == outs["jax"], task
        n, files = outs["port"]
        assert n >= 1 and f"{task}.jsonl" in files
        reqs = load_task_docs(TASKS[task], str(tmp_path / f"port_{task}"))
        assert len(reqs) == n, task


def test_every_exporter_has_a_case():
    covered = {t for cases in EXPORT_CASES.values() for t, _ in cases}
    assert set(texport.EXPORTERS) == set(jexport.EXPORTERS)
    families = {texport.EXPORTERS[t].__name__ for t in covered}
    assert families == {f.__name__ for f in texport.EXPORTERS.values()}


def test_export_cli_limit_and_unknown_task(tmp_path, capsys):
    src = _write_release(str(tmp_path / "chartqa"), "parquet", [
        {"question": f"q{i}", "answer": str(i), "image": _img(i), "type": "t"}
        for i in range(5)])
    printed = []
    for tag, mod in (("jax", jexport), ("port", texport)):
        out = str(tmp_path / tag)
        assert mod.main(["--task", "chartqa", "--dataset-path", src,
                         "--output-dir", out, "--limit", "2"]) == 0
        printed.append(json.loads(capsys.readouterr().out))
        assert _tree_bytes(out) == _tree_bytes(str(tmp_path / "jax"))
    assert printed[0]["exported"] == printed[1]["exported"] == 2
    for mod in (jexport, texport):
        with pytest.raises(SystemExit, match="no exporter for task 'nope'"):
            mod.main(["--task", "nope", "--dataset-path", src,
                      "--output-dir", str(tmp_path / "x")])
