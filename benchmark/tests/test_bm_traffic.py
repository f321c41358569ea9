"""The traffic generator: a seed repeats exactly, seeds differ in order
but not in the amount of work."""

import numpy as np

from benchmark import traffic
from benchmark.tests import tiny

MIXES = ("vqa-poisson-qwen3b", "vqa-poisson-ov8b", "caption-closed48-qwen3b")


def _key(reqs):
    return [(r.image.shape, r.question, r.max_new, r.due) for r in reqs]


def test_seed_repeats_exactly():
    for name in MIXES:
        mix = traffic.load_mix(name)
        a, b = traffic.requests(mix, 2**31 + 5, 30), \
            traffic.requests(mix, 2**31 + 5, 30)
        assert _key(a) == _key(b)
        assert all(np.array_equal(x.image, y.image) for x, y in zip(a, b))


def _work(reqs):
    return [(r.image.shape, len(r.question), r.max_new, r.due) for r in reqs]


def test_seeds_differ_in_content_not_in_work():
    mix = traffic.load_mix("vqa-poisson-qwen3b")
    a = traffic.open_loop(mix, 11, 40.0)
    b = traffic.open_loop(mix, 12, 40.0)
    assert _key(a) != _key(b) and _work(a) == _work(b)
    assert not np.array_equal(a[0].image, b[0].image)
    n = int(np.ceil(mix["rate_per_s"] * (mix["lead_in_s"] + 40.0)))
    assert len(a) >= n - 2  # the fixed multisets, cut only at the end
    other = dict(mix, schedule_seed=mix["schedule_seed"] + 1)
    c = traffic.open_loop(other, 11, 40.0)
    assert _work(c) != _work(a)
    for f in (lambda r: r.max_new, lambda r: r.image.shape,
              lambda r: len(r.question)):
        assert sorted(map(f, traffic.requests(mix, 11, n))) == \
            sorted(map(f, traffic.requests(other, 11, n)))
    gaps = np.sort(traffic.exp_gaps(mix["rate_per_s"], n))
    assert abs(gaps.mean() * mix["rate_per_s"] - 1) < 0.05


def test_ranges_and_ids():
    mix = tiny.mix("vqa-poisson-qwen3b")
    cfg = tiny.config("qwen25vl-3b-sel20")
    for r in traffic.requests(mix, 3, 40):
        assert mix["answer_len"][0] <= r.max_new <= mix["answer_len"][1]
        assert mix["question_len"][0] <= len(r.question) \
            <= mix["question_len"][1]
        ids = traffic.prompt_ids(mix, cfg, 5, r.question)
        assert (ids == cfg["tokens"]["image_token_id"]).sum() == 5
    due = [r.due for r in traffic.open_loop(mix, 3, 10.0)]
    assert due == sorted(due) and due[-1] < mix["lead_in_s"] + 10.0
