"""LLM-side compression strategies: FastV and DART.

A copy of ``visionselector_tpu.selector.baselines.llm_side`` (host numpy
in the reference too).

These prune image tokens *inside* the decoder at a target layer (default 2),
using the running sequence's own attention / key statistics — unlike the
ViT-side methods which select before the LLM. The engine runs a two-stage
prefill (``_stage_a_from_vision`` / ``_stage_b`` in models.qwen25vl.model); these classes
implement only the index selection between stages.

Selection interface::

    select(fastv_scores, key_l1, hidden_t, image_positions, budget)
        -> retained image positions (absolute, unsorted ok)

with all arrays host numpy over the VALID sequence prefix.
"""

from __future__ import annotations

import numpy as np


class _LLMSideStrategy:
    llm_side = True
    target_layer = 2  # reference default (fastv.py / dart.py target_layer_idx)
    capture = "fastv"
    name = "llm_side"

    def select(self, fastv_scores, key_l1, hidden_t, image_positions, budget):
        raise NotImplementedError


class FastV(_LLMSideStrategy):
    """FastV (``token_compression/fastv.py:236-266``): rank image positions by
    mean attention received in layer target-1; keep the top ratio."""

    name = "fastv"
    capture = "fastv"

    def __init__(self, target_layer: int = 2):
        self.target_layer = target_layer

    def select(self, fastv_scores, key_l1, hidden_t, image_positions, budget):
        n_img = len(image_positions)
        k = max(1, int(n_img * budget))
        scores = fastv_scores[image_positions]
        top = np.argsort(-scores, kind="stable")[:k]
        return image_positions[top]


class DART(_LLMSideStrategy):
    """DART (``token_compression/dart.py:208-302``): pivot tokens by key
    L1-norm (4 image + 4 post-image query tokens); greedily retain the image
    tokens LEAST cosine-similar to each pivot (duplication-aware)."""

    name = "dart"
    capture = "dart"

    def __init__(self, target_layer: int = 2, pivot_image: int = 4,
                 pivot_text: int = 4):
        self.target_layer = target_layer
        self.pivot_image = pivot_image
        self.pivot_text = pivot_text

    def select(self, fastv_scores, key_l1, hidden_t, image_positions, budget):
        n_img = len(image_positions)
        token_topk = max(
            1, int(n_img * budget / (self.pivot_image + self.pivot_text))
        )
        last_visual = int(image_positions.max())
        t = len(key_l1)

        img_l1 = key_l1[image_positions]
        top_img = image_positions[
            np.argsort(-img_l1, kind="stable")[: min(self.pivot_image, n_img)]
        ]
        query_range = np.arange(last_visual + 1, t)
        if len(query_range):
            q_l1 = key_l1[query_range]
            top_q = query_range[
                np.argsort(-q_l1, kind="stable")[: min(self.pivot_text, len(query_range))]
            ]
        else:
            top_q = np.asarray([], np.int64)

        indices_set = set(top_img.tolist()) | set(top_q.tolist())
        valid = set(image_positions.tolist()) - set(top_img.tolist())

        h = hidden_t / (np.linalg.norm(hidden_t, axis=-1, keepdims=True) + 1e-12)
        for item in list(indices_set):
            if not valid:
                break
            vlist = np.asarray(sorted(valid))
            cos = -(h[vlist] @ h[item])  # negated similarity: keep dissimilar
            cur = min(token_topk, len(vlist))
            if cur == 0:
                continue
            picked = vlist[np.argsort(-cos, kind="stable")[:cur]]
            indices_set.update(picked.tolist())
            valid.difference_update(picked.tolist())

        indices_set.difference_update(top_q.tolist())
        return np.asarray(sorted(indices_set), np.int64)
