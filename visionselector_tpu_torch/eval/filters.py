"""Response filter pipelines (lmms-eval parity:
``lmms-eval/lmms_eval/filters/`` — extraction / transformation filters that
map raw generations to scoreable answers, declared per task).

A pipeline is a list of filter callables applied in order to each prediction
string. Tasks reference a pipeline by name in ``TaskConfig.filter``
(the compact analog of the YAML ``filter_list`` + ``!function`` wiring).
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Sequence


class RegexFilter:
    """Extract the first regex match (group) from the prediction; fall back
    to the raw string (lmms-eval ``extraction.RegexFilter`` semantics)."""

    def __init__(self, pattern: str, group: int = 0,
                 fallback: str | None = None):
        self.pattern = re.compile(pattern)
        self.group = group
        self.fallback = fallback

    def __call__(self, text: str) -> str:
        m = self.pattern.search(text)
        if m:
            return m.group(self.group)
        return text if self.fallback is None else self.fallback


class TakeFirstLine:
    def __call__(self, text: str) -> str:
        return text.strip().splitlines()[0] if text.strip() else text.strip()


class Strip:
    def __init__(self, chars: str | None = None):
        self.chars = chars

    def __call__(self, text: str) -> str:
        return text.strip(self.chars)


class Lowercase:
    def __call__(self, text: str) -> str:
        return text.lower()


class RemovePrefix:
    """Strip a leading phrase like 'The answer is' (MC extraction helper)."""

    def __init__(self, *prefixes: str):
        self.prefixes = tuple(p.lower() for p in prefixes)

    def __call__(self, text: str) -> str:
        t = text.strip()
        low = t.lower()
        for p in self.prefixes:
            if low.startswith(p):
                return t[len(p):].strip(" :.")
        return t


Pipeline = List[Callable[[str], str]]

# Named pipelines (the compact registry standing in for per-task YAML
# filter_list entries).
PIPELINES: Dict[str, Pipeline] = {
    "none": [],
    "first_line": [TakeFirstLine(), Strip()],
    # multiple-choice letter extraction (mmmu/ai2d-style): grab the first
    # standalone A-E letter, tolerating "The answer is (B)." phrasings.
    "mc_letter": [
        RemovePrefix("the answer is", "answer:", "answer is"),
        RegexFilter(r"\(?\b([A-Ea-e])\b\)?", group=1),
        Strip(),
    ],
    # numeric extraction (chartqa-style relaxed accuracy feeds)
    "number": [RegexFilter(r"-?\d[\d,]*\.?\d*%?", group=0), Strip()],
    # yes/no normalization (pope/mme)
    "yes_no": [Lowercase(), RegexFilter(r"\b(yes|no)\b", group=1)],
}


def apply_pipeline(name: str, prediction: str) -> str:
    for f in PIPELINES.get(name, ()):  # unknown name = identity
        prediction = f(prediction)
    return prediction


def apply_filters(name: str, predictions: Sequence[str]) -> List[str]:
    return [apply_pipeline(name, p) for p in predictions]
