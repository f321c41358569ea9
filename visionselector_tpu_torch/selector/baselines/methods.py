"""ViT-side training-free compression strategies.

A copy of ``visionselector_tpu.selector.baselines.methods``: host numpy
in the reference too, so the port runs the same code on the same arrays
(every argsort stable, the same float64 accumulations).

Each strategy implements::

    __call__(embeds, attn, keys, budget, grid_thw) -> (indices, new_embeds)

with
    embeds: [N, D] merged vision tokens (original order, unpadded),
    attn:   [N] mean attention received at the last ViT block (or None),
    keys:   [N, hidden] pooled last-block keys (or None),
    indices: sorted ascending int64 kept indices,
    new_embeds: [len(indices), D] replacement embeddings or None (gather
        embeds[indices]).

``needs_stats`` tells the engine whether to run the stats-capturing ViT
forward. Semantics cite the reference implementations.
"""

from __future__ import annotations

import numpy as np


class _Strategy:
    needs_stats = False
    name = "base"

    def __call__(self, embeds, attn, keys, budget, grid_thw):
        raise NotImplementedError


class RandomSelect(_Strategy):
    """Uniform random retention (sanity-floor baseline)."""

    name = "random"

    def __init__(self, seed: int = 0):
        self.seed = seed

    def __call__(self, embeds, attn, keys, budget, grid_thw):
        n = embeds.shape[0]
        k = max(1, int(n * budget))
        rng = np.random.RandomState(self.seed)
        idx = np.sort(rng.choice(n, size=k, replace=False))
        return idx.astype(np.int64), None


class VisionZip(_Strategy):
    """VisionZip re-implementation (``token_compression/visionzip.py:155-245``).

    dominant = top-k by last-block attention received; contextual = uniform
    stride over the remainder, each remaining token merged (mean) into its
    most key-similar contextual target.
    """

    needs_stats = True
    name = "visionzip"

    def __init__(self, contextual_ratio: float = 0.05):
        self.contextual_ratio = contextual_ratio

    def __call__(self, embeds, attn, keys, budget, grid_thw):
        n, d = embeds.shape
        if self.contextual_ratio <= 0:
            k = max(1, int(n * budget))
            idx = np.sort(np.argsort(-attn, kind="stable")[:k])
            return idx.astype(np.int64), None

        dominant_num = max(1, int(n * (budget - self.contextual_ratio)))
        contextual_num = max(1, int(n * self.contextual_ratio))
        dom_idx = np.sort(np.argsort(-attn, kind="stable")[:dominant_num])

        mask = np.ones(n, bool)
        mask[dom_idx] = False
        filtered_idx = np.where(mask)[0]
        metric = keys[filtered_idx]
        metric = metric / (np.linalg.norm(metric, axis=-1, keepdims=True) + 1e-12)
        hidden_f = embeds[filtered_idx]

        step = max(1, len(filtered_idx) // contextual_num)
        target_local = np.arange(0, len(filtered_idx), step)[:contextual_num]
        contextual_idx = filtered_idx[target_local]
        targets = metric[target_local]

        merge_local = np.setdiff1d(np.arange(len(filtered_idx)), target_local)
        if len(merge_local) and len(target_local):
            sim = metric[merge_local] @ targets.T
            assign = sim.argmax(axis=1)
            agg = np.zeros((len(target_local), d), np.float64)
            counts = np.zeros(len(target_local), np.int64)
            np.add.at(agg, assign, hidden_f[merge_local].astype(np.float64))
            np.add.at(counts, assign, 1)
            agg /= np.maximum(counts, 1)[:, None]
            contextual_tokens = hidden_f[target_local] + agg.astype(embeds.dtype)
        else:
            contextual_tokens = hidden_f[target_local]

        all_idx = np.concatenate([dom_idx, contextual_idx])
        order = np.argsort(all_idx, kind="stable")
        all_sorted = all_idx[order]
        new_embeds = np.concatenate([embeds[dom_idx], contextual_tokens])[order]
        return all_sorted.astype(np.int64), new_embeds


def _iqr_outlier_ratio(attn: np.ndarray) -> float:
    """(``prumerge.py:47-67``): fraction of scores above Q3 + 1.5 IQR."""
    a = np.asarray(attn, np.float32).ravel()
    q1, q3 = np.percentile(a, 25), np.percentile(a, 75)
    upper = q3 + 1.5 * (q3 - q1)
    return float((a > upper).sum()) / len(a)


class PruMergePlus(_Strategy):
    """PruMerge+ re-implementation (``token_compression/prumerge.py:195-310``).

    Adaptive count from IQR outliers, padded with an arithmetic-progression
    spatial sample up to the budget; kept tokens updated by adding the
    attention-weighted sum of their 32 most key-similar tokens.
    """

    needs_stats = True
    name = "prumerge_plus"

    def __init__(self, cluster_size: int = 32):
        self.cluster_size = cluster_size

    def __call__(self, embeds, attn, keys, budget, grid_thw):
        n, d = embeds.shape
        budget_tokens = max(1, int(n * budget))
        iqr_tokens = max(1, int(n * _iqr_outlier_ratio(attn)))

        if budget_tokens > iqr_tokens:
            iqr_idx = np.argsort(-attn, kind="stable")[:iqr_tokens]
            step = max(1, int(n / budget_tokens))
            arith = np.arange(0, n, step)
            fill = np.asarray([x for x in arith if x not in set(iqr_idx.tolist())])
            fill = fill[: budget_tokens - iqr_tokens]
            if len(fill) < budget_tokens - iqr_tokens:
                pool = np.setdiff1d(np.arange(n), np.concatenate([iqr_idx, fill]))
                extra = pool[: budget_tokens - iqr_tokens - len(fill)]
                fill = np.concatenate([fill, extra])
            idx = np.concatenate([iqr_idx, fill])[:budget_tokens]
        else:
            idx = np.argsort(-attn, kind="stable")[:budget_tokens]

        # Cluster-merge update of kept tokens (prumerge.py:259-305):
        # center_i += sum over its 32 most similar (by key cosine) of the
        # pool {all tokens except itself}, weighted by attention. Vectorized
        # (batched matmul + argpartition) instead of the reference's per-token
        # loop — the summed top-m SET is order-invariant, so partial selection
        # suffices; blocked over kept rows to cap the [K, N] similarity
        # buffer. (N=16k, K=3k runs in well under a second vs thousands of
        # host sorts.)
        keep = np.asarray(idx, np.int64)
        kn = keys / (np.linalg.norm(keys, axis=-1, keepdims=True) + 1e-12)
        kn = kn.astype(np.float32)
        m = min(max(self.cluster_size, 1), n - 1)
        ef = embeds.astype(np.float64)
        updated = np.array(embeds[keep], np.float64)
        block = 512
        for s in range(0, len(keep), block):
            rows = keep[s : s + block]
            sims = kn[rows] @ kn.T  # [b, N]
            sims[np.arange(len(rows)), rows] = -np.inf  # exclude self
            top = np.argpartition(-sims, m - 1, axis=1)[:, :m]  # [b, m]
            w = attn[top]  # [b, m]
            updated[s : s + block] += np.einsum(
                "bm,bmd->bd", w, ef[top], optimize=True
            )

        order = np.argsort(keep, kind="stable")
        return keep[order], updated[order].astype(embeds.dtype)


class DivPrune(_Strategy):
    """DivPrune re-implementation (``token_compression/divprune.py:53-74``).

    Greedy max-min diversity over cosine distance: repeatedly add the token
    whose minimum distance to the selected set is largest.
    """

    name = "divprune"

    def __call__(self, embeds, attn, keys, budget, grid_thw):
        n = embeds.shape[0]
        k = max(1, int(round(budget * n)))
        x = embeds.astype(np.float64)
        x = x / (np.linalg.norm(x, axis=1, keepdims=True) + 1e-12)
        dist = 1.0 - x @ x.T  # [N, N]

        selected = np.empty(k, np.int64)
        # first pick: max over (2nd-smallest distance per column) — the
        # reference's topk(largest=False).values[1] with i==0.
        second_min = np.partition(dist, 1, axis=0)[1]
        selected[0] = int(np.argmax(second_min))
        min_d = dist[selected[0]]
        for i in range(1, k):
            selected[i] = int(np.argmax(min_d))
            min_d = np.minimum(min_d, dist[selected[i]])
        return np.sort(selected), None


class HoloV(_Strategy):
    """HoloV re-implementation (``token_compression/holov.py:86-240, 743``).

    Splits the token sequence into spatial patch groups; per-group score =
    alpha * scaled attention + beta * similarity-variance; budget distributed
    across groups by score weight; within-group top-k by attention.
    """

    needs_stats = True
    name = "holov"

    def __init__(self, alpha: float = 1.0, beta: float = 0.09, eps: float = 1e-6):
        self.alpha, self.beta, self.eps = alpha, beta, eps

    def __call__(self, embeds, attn, keys, budget, grid_thw):
        n, d = embeds.shape
        keep_num = max(1, int(n * budget))
        num_patches = max(1, int((1024 / 576) * n / keep_num))

        base, rem = divmod(n, num_patches)
        bounds, start = [], 0
        for p in range(num_patches):
            size = base + (1 if p < rem else 0)
            if size > 0:
                bounds.append((start, start + size))
            start += size

        patch_scores, token_scores_all = [], []
        for s, e in bounds:
            toks = embeds[s:e].astype(np.float64)
            a = attn[s:e].astype(np.float64)
            size = e - s
            if size <= 1:
                patch_scores.append(a.mean() if size else 0.0)
                token_scores_all.append(a)
                continue
            f = toks / (np.linalg.norm(toks, axis=1, keepdims=True) + self.eps)
            sim = f @ f.T
            np.fill_diagonal(sim, 0.0)
            mean_sim = sim.sum(axis=1) / (size - 1)
            var_sim = ((sim - mean_sim[:, None]) ** 2).sum(axis=1) / (size - 1)
            a_scaled = a * 1e3
            var_scaled = var_sim * (
                np.abs(a_scaled).mean() / (np.abs(var_sim).mean() + self.eps)
            )
            scores = self.alpha * a_scaled + self.beta * var_scaled
            patch_scores.append(scores.mean())
            token_scores_all.append(a)

        w = np.asarray(patch_scores, np.float64)
        w = w / (w.sum() + self.eps)
        alloc = np.floor(w * keep_num).astype(np.int64)
        remaining = keep_num - alloc.sum()
        if remaining > 0:
            for j in np.argsort(-w, kind="stable")[:remaining]:
                alloc[j] += 1

        positions = []
        for (s, e), a_cnt in zip(bounds, alloc):
            size = e - s
            if a_cnt <= 0:
                continue
            if a_cnt >= size:
                positions.append(np.arange(s, e))
            else:
                pa = attn[s:e]
                top = np.argsort(-pa, kind="stable")[: int(a_cnt)]
                positions.append(s + top)
        idx = (
            np.concatenate(positions)[:keep_num]
            if positions
            else np.arange(min(1, n))
        )
        return np.sort(idx.astype(np.int64)), None
