"""One general traffic generator: requests of image question answering
drawn from a mix file (``benchmark/mixes/<name>.json``) and a seed.

Every seed gets the same work: the image sizes, the question and answer
lengths and the gaps between arrivals are fixed multisets (evenly spread
over each range, exponential quantiles for the gaps) put in one order by
the mix's own ``schedule_seed``; the run's seed draws the pixels and the
question ids (and the weights). Seeds so differ in what is computed, not
in how much or when: with the order drawn from the run's seed, the tail
of the time to first token moved by a third from seed to seed, as bursts
of large images came and went.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def load_mix(name: str) -> dict:
    with open(os.path.join(HERE, "mixes", name + ".json")) as f:
        return json.load(f)


@dataclasses.dataclass
class Request:
    rid: int
    image: np.ndarray  # (H, W, 3) uint8
    question: list  # text ids
    max_new: int
    due: float = 0.0  # seconds after the traffic starts (open loop)


def spread(lo: int, hi: int, n: int) -> np.ndarray:
    """n integers spread evenly over [lo, hi]."""
    return np.round(lo + (hi - lo) * (np.arange(n) + 0.5) / n).astype(int)


def exp_gaps(rate: float, n: int) -> np.ndarray:
    """n gaps of a Poisson process at ``rate``: the exponential's
    quantiles at (i + 0.5) / n."""
    return -np.log1p(-(np.arange(n) + 0.5) / n) / rate


def images(mix: dict, seed: int) -> list:
    """The mix's pixel sets: ``image_variants`` seeded uint8 images of each
    (width, height) in ``image_sizes``; request j uses one of them."""
    rng = np.random.default_rng([seed, 1])
    return [[rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
             for _ in range(mix["image_variants"])]
            for w, h in mix["image_sizes"]]


def requests(mix: dict, seed: int, n: int, pix=None) -> list:
    """The first ``n`` requests of the stream, in order: image size,
    variant, question length and answer budget each the schedule's
    permutation of an even spread (the sizes in equal shares); the
    seed's pixels and question ids (from ``question_ids``); ``pix``: the
    seed's ``images``, if made already."""
    rng = np.random.default_rng([seed, 2])
    order = np.random.default_rng([mix["schedule_seed"], 2])
    pix = images(mix, seed) if pix is None else pix
    n_sizes = len(mix["image_sizes"])
    sizes = order.permutation(np.arange(n) % n_sizes)
    variants = order.integers(0, mix["image_variants"], n)
    q_lens = order.permutation(spread(*mix["question_len"], n))
    a_lens = order.permutation(spread(*mix["answer_len"], n))
    lo, hi = mix["question_ids"]
    out = []
    for j in range(n):
        q = rng.integers(lo, hi, int(q_lens[j])).tolist()
        out.append(Request(rid=j, image=pix[sizes[j]][variants[j]],
                           question=q, max_new=int(a_lens[j])))
    return out


def open_loop(mix: dict, seed: int, seconds: float, pix=None) -> list:
    """Requests with due times over the lead-in and the window: Poisson
    arrivals at ``rate_per_s`` (the gaps the schedule's permutation of
    fixed exponential quantiles), cut at the window's end."""
    span = mix["lead_in_s"] + seconds
    n = int(np.ceil(mix["rate_per_s"] * span))
    rng = np.random.default_rng([mix["schedule_seed"], 3])
    due = np.cumsum(rng.permutation(exp_gaps(mix["rate_per_s"], n)))
    reqs = requests(mix, seed, n, pix)
    for r, t in zip(reqs, due):
        r.due = float(t)
    return [r for r in reqs if r.due < span]


def prompt_ids(mix: dict, cfg: dict, n_vision: int, question: list):
    """Chat-formatted ids: the mix's ``prompt.before``, the vision block
    (start, ``n_vision`` image pads, end), the question, ``prompt.after``."""
    tok = cfg["tokens"]
    ids = (list(mix["prompt"]["before"]) + [tok["vision_start_token_id"]]
           + [tok["image_token_id"]] * n_vision
           + [tok["vision_end_token_id"]] + list(question)
           + list(mix["prompt"]["after"]))
    return np.asarray(ids, np.int64)
