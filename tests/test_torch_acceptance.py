"""The port's checkpoint acceptance CLIs on the CPU (``--device cpu``), for
both families on their tiny random-weight configs, as
``tests/test_checkpoint.py`` runs the JAX package's:
``api.verify_checkpoint`` record-then-verify (and with ``--model-path``
on an HF directory without a tokenizer, through ``--prompt-ids``), a
transcript with one token changed exiting 1, ``api.acceptance`` with its
three steps, and ``eval.regression --refs WORKTREE``."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from visionselector_tpu_torch.api import acceptance, verify_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = ("qwen25vl", "llava_ov15")
BASE = ["--device", "cpu", "--max-new-tokens", "3", "--budget", "0.5"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while the module runs (the tiny decode loop's
    small ops stall on oversubscribed threads in the parallel run)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _task_dir(tmp_path):
    """A ``chartqa`` docs file (the built-in task): two image docs and a
    text-only one."""
    from PIL import Image

    d = tmp_path / "tasks"
    d.mkdir()
    Image.fromarray((np.random.RandomState(0).rand(56, 56, 3) * 255).astype(
        np.uint8)).save(d / "img.png")
    with open(d / "chartqa.jsonl", "w") as f:
        for i in range(3):
            doc = {"question": f"What is {i}?", "answers": [str(i)]}
            if i < 2:
                doc["image"] = "img.png"
            f.write(json.dumps(doc) + "\n")
    return str(d)


@pytest.mark.parametrize("family", FAMILIES)
def test_verify_checkpoint_record_verify_and_changed_token(family, tmp_path,
                                                           capsys):
    """Record, then verify: exit 0; the transcript with its first token
    changed: exit 1, the mismatch named ``tokens`` on stderr."""
    t = str(tmp_path / "transcript.json")
    args = BASE + ["--family", family]
    assert verify_checkpoint.main(args + ["--record", t]) == 0
    assert verify_checkpoint.main(args + ["--verify", t]) == 0
    with open(t) as f:
        rec = json.load(f)
    assert rec["family"] == family and len(rec["tokens"]) == 3
    assert rec["kept_vision_tokens"] < rec["num_vision_tokens"]
    rec["tokens"][0] += 1
    with open(t, "w") as f:
        json.dump(rec, f)
    capsys.readouterr()
    assert verify_checkpoint.main(args + ["--verify", t]) == 1
    err = capsys.readouterr().err
    assert "OUTPUT mismatch tokens" in err
    assert "num_vision_tokens" not in err


def test_verify_checkpoint_model_path_and_prompt_ids(tmp_path):
    """An OV HF directory (no tokenizer) through ``--model-path`` and
    ``--prompt-ids``: the transcript records the ids and verifies; other
    ids are a setup mismatch."""
    from visionselector_tpu_torch.core.config import llava_ov_tiny
    from visionselector_tpu_torch.models.llava_ov15.model import (
        init_ov_params,
    )
    from visionselector_tpu_torch.models.llava_ov15.weights import (
        save_ov_checkpoint,
    )

    cfg = llava_ov_tiny()
    hf = str(tmp_path / "hf")
    save_ov_checkpoint(init_ov_params(cfg, torch.Generator().manual_seed(3),
                                      "cpu"), cfg, hf)
    t = str(tmp_path / "transcript.json")
    args = BASE + ["--family", "llava_ov15", "--model-path", hf,
                   "--prompt-ids", "300,301,302"]
    assert verify_checkpoint.main(args + ["--record", t]) == 0
    assert verify_checkpoint.main(args + ["--verify", t]) == 0
    with open(t) as f:
        assert json.load(f)["prompt_ids"] == "300,301,302"
    args[-1] = "300,301"
    assert verify_checkpoint.main(args + ["--verify", t]) == 1


@pytest.mark.parametrize("family", FAMILIES)
def test_acceptance_tiny_all_steps_pass(family, tmp_path, capsys):
    """transcript, golden_indices and regression8 (two docs of the
    synthetic chartqa directory) on the tiny config: every step ok, the
    last line PASS, exit 0."""
    data = _task_dir(tmp_path)
    rc = acceptance.main(BASE + ["--family", family, "--data-dir", data,
                                 "--tasks", "chartqa", "--limit", "2"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    steps = {s["step"]: s for s in lines if "step" in s}
    assert rc == 0, steps
    assert lines[-1]["acceptance"] == "PASS"
    assert set(steps) == {"transcript", "golden_indices", "regression8"}
    assert all(s["ok"] for s in steps.values())
    assert steps["golden_indices"]["kept"] < steps["golden_indices"][
        "vision_tokens"]
    assert steps["regression8"]["scores"]["chartqa"]["chartqa/n"] == 2.0


def test_acceptance_reports_a_failed_step(tmp_path, capsys):
    """A regression task with no docs file fails its step: FAIL, exit 1."""
    rc = acceptance.main(BASE + ["--data-dir", str(tmp_path), "--tasks",
                                 "chartqa", "--limit", "2"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert rc == 1 and lines[-1]["acceptance"] == "FAIL"
    assert [s["ok"] for s in lines if "step" in s] == [True, True, False]


def test_eval_regression_worktree_prints_the_table(tmp_path):
    """``eval.regression --refs WORKTREE --device cpu``: run_eval in a
    process of its own on the current tree, one row per metric."""
    data = _task_dir(tmp_path)
    r = subprocess.run(
        [sys.executable, "-m", "visionselector_tpu_torch.eval.regression",
         "--data-dir", data, "--tasks", "chartqa", "--limit", "2",
         "--budget", "0.5", "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stderr
    table = r.stdout.splitlines()
    header = next(i for i, ln in enumerate(table) if ln.startswith("metric"))
    assert table[header].split() == ["metric", "WORKTREE"]
    rows = {ln.split()[0]: float(ln.split()[1]) for ln in table[header + 1:]}
    assert rows["chartqa/n"] == 2.0 and "chartqa/relaxed_accuracy" in rows
