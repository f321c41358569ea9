"""The plain reference against the port at the tiny configurations, and
whole runs of the harness on the CPU with faults planted under the timed
path, each of which must turn ``correct`` false, and the fp8 control."""

import numpy as np
import pytest
import torch

from benchmark import harness, judge, models, serving, traffic
from benchmark.reference import common, decoder
from benchmark.tests import tiny

FAMILIES = (("qwen25vl-3b-sel20", "vqa-poisson-qwen3b"),
            ("llava-ov15-8b-sel20", "vqa-poisson-ov8b"))
# every mix under benchmark/mixes/ with its configuration, whether or not
# BENCHMARK.json runs it yet
CELLS = {m: {"name": m, "config": c, "traffic": m} for c, m in
         FAMILIES + (("qwen25vl-3b-sel20", "caption-closed48-qwen3b"),)}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name,mixname", FAMILIES)
def test_reference_agrees_with_the_port(name, mixname):
    cfg, mix = tiny.config(name), tiny.mix(mixname)
    _, eng = models.build_program(cfg, models.make_weights(cfg, 7, "cpu"),
                                  "cpu")
    ref = judge.Reference(cfg, 7, "cpu")
    pix = traffic.images(mix, 7)
    for size in range(len(pix)):
        req = traffic.requests(mix, 7, 1, pix)[0]
        req.image = pix[size][1]
        s = serving.Served(req)
        serving.prepare(s, mix, cfg)
        grid, merged, scores, ids, pos3, delta = ref.prompt(s, mix)
        assert np.array_equal(ids, s.ids) and tuple(grid) == s.grid
        v = cfg["vision_config"]
        rows, _ = common.patchify(req.image, v["patch_size"],
                                  v["temporal_patch_size"], 2,
                                  **cfg["processor"])
        assert np.array_equal(rows, s.pixels)
        res = eng.generate(s.ids, s.pixels, np.asarray([s.grid]),
                           max_new_tokens=6, eos_token_ids=(-1,))
        k = max(1, int(merged.shape[0] * 0.2))
        assert np.array_equal(decoder.top_k(scores, k), res.selected_indices)
        np.testing.assert_allclose(scores.numpy(), res.scores, rtol=1e-4,
                                   atol=1e-5 * np.abs(res.scores).max())
        lg = ref.logits(ids, merged, res.selected_indices, pos3, delta,
                        res.tokens)
        np.testing.assert_allclose(lg[0].numpy(), res.logits.numpy(),
                                   atol=1e-4)
        assert judge.gaps(lg, res.tokens).max() < 1e-4
        bad = list(res.tokens)
        bad[2] = (bad[2] + 1) % cfg["text_config"]["vocab_size"]
        assert judge.gaps(lg, bad).max() > 1e-2  # an altered token shows


def _run(cell, fault=None, control=False, seed=2**31 + 17):
    c = CELLS[cell]
    return harness.serve_cell(
        c, seed, 2.0, False, harness.Setup(0.0), device="cpu",
        cfg=tiny.config(c["config"]), mix=tiny.mix(c["traffic"]),
        fault=fault, control=control)


def alter_token(bat):
    """A token altered where it is produced: every chunk's second step
    hands every slot another token."""
    harvest = bat._harvest

    def wrapped(toks):
        if toks.shape[0] > 1:
            toks = toks.copy()
            toks[1] = (toks[1] + 1) % 151936
        harvest(toks)

    bat._harvest = wrapped


def state_unchanged(bat):
    """A decode step that returns its state unchanged: each chunk's
    cache rows are dropped (the pool's lengths put back)."""
    dispatch = bat._dispatch

    def wrapped():
        before = bat.pool.length.clone()
        out = dispatch()
        bat.pool.length.copy_(before)
        return out

    bat._dispatch = wrapped


def worst_selection(bat):
    """The selector keeps the lowest-scored tokens."""
    from visionselector_tpu_torch.models.qwen25vl import model as M
    from visionselector_tpu_torch.selector import select as S

    def flipped(scorer, tokens, num_valid, k, k_max):
        sel = S.select_hard(scorer, tokens, num_valid, k, k_max)
        low = S.hard_topk_indices(-sel.scores, k, k_max, valid_len=num_valid)
        return S.Selection(indices=low[0], valid=low[1], scores=sel.scores,
                           k=k)

    bat.engine._saved_select = M.select_hard
    M.select_hard = flipped
    import visionselector_tpu_torch.models.llava_ov15.model as OV

    OV.select_hard = flipped


@pytest.fixture
def restore_select():
    from visionselector_tpu_torch.models.llava_ov15 import model as OV
    from visionselector_tpu_torch.models.qwen25vl import model as M

    saved = M.select_hard, OV.select_hard
    yield
    M.select_hard, OV.select_hard = saved


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_sound_run_is_correct(cell):
    out = _run(cell)
    assert out["result"]["correct"], out["numbers"]
    assert out["numbers"]["tokens"] > 0
    assert out["result"]["attempted"] > 0 and out["result"]["failed"] == 0


@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("fault", [alter_token, state_unchanged,
                                   worst_selection])
def test_planted_fault_is_not_correct(cell, fault, restore_select):
    out = _run(cell, fault)
    assert not out["result"]["correct"], (fault.__name__, out["numbers"])


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_fp8_control_is_not_correct(cell):
    out = _run(cell, control=True)
    ok, _ = judge.verdict(out["control"],
                          tiny.mix(CELLS[cell]["traffic"])["check"]["limits"])
    assert not ok, out["control"]
