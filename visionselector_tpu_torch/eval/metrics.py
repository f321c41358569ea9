"""Evaluation metrics for the paper benchmark suite.

Re-implements the metric semantics the reference consumes from its vendored
lmms-eval (``lmms-eval/lmms_eval/api/metrics.py`` and per-task utils):

- relaxed accuracy (ChartQA): numeric match within 5% relative tolerance,
  exact string match otherwise.
- ANLS (DocVQA): 1 - normalized Levenshtein, thresholded at 0.5.
- VQA accuracy (TextVQA): min(#annotators agreeing / 3, 1).
- substring/contains accuracy (OCRBench-style).
- exact match, yes/no accuracy (POPE), plus POPE precision/recall/F1.
- bootstrap standard error for aggregates (``api/metrics.py:490+``).
"""

from __future__ import annotations

import random
import re
import string
from typing import Callable, Dict, Sequence


def _to_float(text: str):
    try:
        if text.endswith("%"):
            return float(text.rstrip("%")) / 100.0
        return float(text)
    except ValueError:
        return None


def relaxed_match(prediction: str, target: str, max_relative_change: float = 0.05) -> bool:
    """ChartQA relaxed correctness (tasks/chartqa/utils.py semantics)."""
    prediction = str(prediction).strip()
    target = str(target).strip()
    p, t = _to_float(prediction), _to_float(target)
    if p is not None and t is not None:
        if t == 0:
            return p == 0
        return abs(p - t) / abs(t) <= max_relative_change
    return prediction.lower() == target.lower()


def relaxed_accuracy(prediction: str, targets: Sequence[str]) -> float:
    return float(any(relaxed_match(prediction, t) for t in targets))


def levenshtein(a: str, b: str) -> int:
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def anls(prediction: str, targets: Sequence[str], threshold: float = 0.5) -> float:
    """Average Normalized Levenshtein Similarity (DocVQA)."""
    prediction = " ".join(str(prediction).strip().lower().split())
    best = 0.0
    for t in targets:
        t = " ".join(str(t).strip().lower().split())
        if not t and not prediction:
            best = max(best, 1.0)
            continue
        dist = levenshtein(prediction, t)
        length = max(len(prediction), len(t), 1)
        sim = 1.0 - dist / length
        best = max(best, sim if sim >= threshold else 0.0)
    return best


_ARTICLES = {"a", "an", "the"}
_PUNCT = str.maketrans("", "", string.punctuation)


def vqa_normalize(text: str) -> str:
    text = str(text).lower().strip()
    text = text.translate(_PUNCT)
    words = [w for w in text.split() if w not in _ARTICLES]
    return " ".join(words)


def vqa_accuracy(prediction: str, answers: Sequence[str]) -> float:
    """VQAv2-style consensus accuracy: min(matches / 3, 1)."""
    pred = vqa_normalize(prediction)
    matches = sum(1 for a in answers if vqa_normalize(a) == pred)
    return min(matches / 3.0, 1.0)


def contains_accuracy(prediction: str, targets: Sequence[str]) -> float:
    """OCRBench-style: target string contained in the prediction."""
    pred = str(prediction).lower().strip()
    return float(any(str(t).lower().strip() in pred for t in targets))


def exact_match(prediction: str, targets: Sequence[str]) -> float:
    pred = str(prediction).strip().lower()
    return float(any(pred == str(t).strip().lower() for t in targets))


def multiple_choice_match(prediction: str, target: str) -> float:
    """MMMU/AI2D/ScienceQA-style letter matching: first A-E letter found."""
    m = re.search(r"\b([A-E])\b", str(prediction).upper())
    pred_letter = m.group(1) if m else str(prediction).strip().upper()[:1]
    return float(pred_letter == str(target).strip().upper()[:1])


def yes_no_match(prediction: str, target: str) -> float:
    """POPE binary: detect yes/no in the prediction."""
    pred = str(prediction).lower()
    pred_label = "yes" if "yes" in pred[:16] else "no"
    return float(pred_label == str(target).strip().lower())


def pope_aggregate(preds: Sequence[str], targets: Sequence[str]) -> Dict[str, float]:
    """POPE accuracy / precision / recall / F1 (yes = positive)."""
    tp = fp = tn = fn = 0
    for p, t in zip(preds, targets):
        pl = "yes" if "yes" in str(p).lower()[:16] else "no"
        tl = str(t).strip().lower()
        if pl == "yes" and tl == "yes":
            tp += 1
        elif pl == "yes" and tl == "no":
            fp += 1
        elif pl == "no" and tl == "no":
            tn += 1
        else:
            fn += 1
    n = max(tp + fp + tn + fn, 1)
    precision = tp / max(tp + fp, 1)
    recall = tp / max(tp + fn, 1)
    f1 = 2 * precision * recall / max(precision + recall, 1e-9)
    return {
        "accuracy": (tp + tn) / n,
        "precision": precision,
        "recall": recall,
        "f1": f1,
    }


def _squad_normalize(text: str) -> str:
    """SQuAD answer normalization: lowercase, strip punctuation/articles,
    collapse whitespace (websrc/utils.py squad-F1 scoring contract)."""
    text = str(text).lower()
    text = "".join(c for c in text if c not in set(string.punctuation))
    text = re.sub(r"\b(a|an|the)\b", " ", text)
    return " ".join(text.split())


def squad_f1(prediction: str, targets: Sequence[str]) -> float:
    """Token-level SQuAD F1, max over reference answers (WebSRC's headline
    metric — ``lmms-eval/lmms_eval/tasks/websrc/utils.py``)."""
    pred_toks = _squad_normalize(prediction).split()
    best = 0.0
    for t in targets:
        gold_toks = _squad_normalize(t).split()
        if not pred_toks or not gold_toks:
            best = max(best, float(pred_toks == gold_toks))
            continue
        common: Dict[str, int] = {}
        for tok in pred_toks:
            common[tok] = common.get(tok, 0) + 1
        overlap = 0
        for tok in gold_toks:
            if common.get(tok, 0) > 0:
                overlap += 1
                common[tok] -= 1
        if overlap == 0:
            continue
        precision = overlap / len(pred_toks)
        recall = overlap / len(gold_toks)
        best = max(best, 2 * precision * recall / (precision + recall))
    return best


def _cap_tokenize(text: str) -> list:
    """Caption tokenizer: lowercase, strip punctuation, whitespace split — a
    deterministic approximation of pycocoevalcap's PTBTokenizer (close in
    practice for model captions; divergence documented, no Java dep)."""
    text = str(text).lower()
    text = "".join(c if c not in set(string.punctuation) else " "
                   for c in text)
    return text.split()


def cider_d(predictions: Sequence[str],
            references: Sequence[Sequence[str]],
            n: int = 4, sigma: float = 6.0):
    """Corpus CIDEr-D (Vedantam et al.) over (prediction, references) pairs.

    Mirrors pycocoevalcap ``cider/cider_scorer.py`` — the scorer the
    reference's caption tasks aggregate with
    (``lmms-eval/lmms_eval/tasks/coco_cap/utils.py:73`` Cider()): TF-IDF
    n-gram vectors (IDF over the reference corpus), count-clipped cosine per
    n, gaussian length penalty exp(-delta^2/(2*sigma^2)), mean over
    n in 1..4, x10. Returns ``(corpus_mean, per_image_scores)``.
    """
    import math
    from collections import defaultdict

    def ngram_counts(tokens, max_n):
        counts = defaultdict(int)
        for k in range(1, max_n + 1):
            for i in range(len(tokens) - k + 1):
                counts[tuple(tokens[i:i + k])] += 1
        return counts

    pred_counts = [ngram_counts(_cap_tokenize(p), n) for p in predictions]
    ref_counts = [[ngram_counts(_cap_tokenize(r), n) for r in refs]
                  for refs in references]

    # document frequency over reference sets (cider_scorer.compute_doc_freq)
    doc_freq: Dict[tuple, float] = defaultdict(float)
    for refs in ref_counts:
        for ng in set(ng for rc in refs for ng in rc):
            doc_freq[ng] += 1
    corpus_n = max(len(ref_counts), 1)
    log_corpus = math.log(max(corpus_n, 1e-9))

    def to_vec(counts):
        vec = [defaultdict(float) for _ in range(n)]
        norm = [0.0] * n
        length = 0
        for ng, tf in counts.items():
            idf = log_corpus - math.log(max(1.0, doc_freq[ng]))
            k = len(ng) - 1
            vec[k][ng] = tf * idf
            norm[k] += vec[k][ng] ** 2
            if k == 0:
                length += tf
        return vec, [x ** 0.5 for x in norm], length

    scores = []
    for pc, refs in zip(pred_counts, ref_counts):
        v_p, n_p, len_p = to_vec(pc)
        per_ref = []
        for rc in refs:
            v_r, n_r, len_r = to_vec(rc)
            delta = float(len_p - len_r)
            vals = []
            for k in range(n):
                s = sum(min(v_p[k][ng], v_r[k][ng]) * v_r[k][ng]
                        for ng in v_p[k])
                if n_p[k] and n_r[k]:
                    s /= n_p[k] * n_r[k]
                vals.append(s * math.exp(-(delta ** 2) / (2 * sigma ** 2)))
            per_ref.append(10.0 * sum(vals) / n)
        scores.append(sum(per_ref) / max(len(per_ref), 1))
    return (sum(scores) / max(len(scores), 1), scores)


def mean(values: Sequence[float]) -> float:
    return sum(values) / max(len(values), 1)


def bootstrap_stderr(values: Sequence[float], iters: int = 1000,
                     seed: int = 1234) -> float:
    """Bootstrap standard error of the mean (lm-eval-harness style)."""
    if len(values) <= 1:
        return 0.0
    rng = random.Random(seed)
    n = len(values)
    means = []
    for _ in range(iters):
        sample = [values[rng.randrange(n)] for _ in range(n)]
        means.append(mean(sample))
    mu = mean(means)
    var = sum((m - mu) ** 2 for m in means) / (len(means) - 1)
    return var**0.5


METRICS: Dict[str, Callable] = {
    "relaxed_accuracy": relaxed_accuracy,
    "anls": anls,
    "vqa_accuracy": vqa_accuracy,
    "contains_accuracy": contains_accuracy,
    "exact_match": exact_match,
    "multiple_choice": multiple_choice_match,
    "yes_no": yes_no_match,
    "squad_f1": squad_f1,
}
