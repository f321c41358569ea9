"""Dataset shrinker (lmms-eval parity: ``lmms-eval/tools/lite/`` — builds a
small representative "lite" subset of a benchmark by k-center selection over
embeddings, so cheap smoke evals track full-suite scores).

The reference embeds docs with an external embedding model; offline here, the
embedder is a deterministic hashed bag-of-words over the question text (plus
answer text), which preserves topical diversity — the property k-center
needs. The selection itself is the same greedy max-min farthest-point
traversal.

Usage:
    python -m visionselector_tpu_torch.eval.lite \\
        --data-dir eval_data/ --task chartqa --k 64 --output-dir lite/
writes ``lite/chartqa.jsonl`` containing the k selected docs.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
from typing import List

import numpy as np

EMBED_DIM = 256


def embed_text(text: str, dim: int = EMBED_DIM) -> np.ndarray:
    """Deterministic hashed bag-of-words embedding (L2-normalized)."""
    v = np.zeros(dim, np.float32)
    for tok in text.lower().split():
        h = int.from_bytes(
            hashlib.md5(tok.encode()).digest()[:8], "little"
        )
        sign = 1.0 if (h >> 32) & 1 else -1.0
        v[h % dim] += sign
    n = np.linalg.norm(v)
    return v / n if n > 0 else v


def k_center_indices(embeds: np.ndarray, k: int) -> List[int]:
    """Greedy max-min (farthest-point) k-center over cosine distance.

    O(n*k) memory/compute (distances only to selected centers — no n x n
    matrix). When every remaining point is a duplicate of a selected center
    (max min-distance ~ 0), the remainder is filled with arbitrary unselected
    indices so exactly k DISTINCT documents are returned.
    """
    n = embeds.shape[0]
    k = min(k, n)
    # start from the point farthest from the centroid (spread-out seed)
    centroid = embeds.mean(axis=0)
    start = int(np.argmin(embeds @ centroid))
    selected = [start]
    chosen = np.zeros(n, bool)
    chosen[start] = True
    min_d = 1.0 - embeds @ embeds[start]
    for _ in range(1, k):
        min_d[chosen] = -np.inf
        nxt = int(np.argmax(min_d))
        if min_d[nxt] <= 1e-9:
            # only duplicates left: fill with unselected docs
            for i in np.flatnonzero(~chosen):
                selected.append(int(i))
                chosen[i] = True
                if len(selected) == k:
                    break
            break
        selected.append(nxt)
        chosen[nxt] = True
        min_d = np.minimum(min_d, 1.0 - embeds @ embeds[nxt])
    return sorted(selected)


def shrink_task(data_dir: str, task: str, k: int, output_dir: str) -> int:
    path = os.path.join(data_dir, f"{task}.jsonl")
    with open(path) as f:
        docs = [json.loads(l) for l in f if l.strip()]
    texts = [
        str(d.get("question", "")) + " " + " ".join(
            str(a) for a in (d.get("answers") or [d.get("answer", "")])
        )
        for d in docs
    ]
    embeds = np.stack([embed_text(t) for t in texts])
    keep = k_center_indices(embeds, k)
    os.makedirs(output_dir, exist_ok=True)
    out_path = os.path.join(output_dir, f"{task}.jsonl")
    with open(out_path, "w") as f:
        for i in keep:
            f.write(json.dumps(docs[i]) + "\n")
    return len(keep)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data-dir", required=True)
    p.add_argument("--task", required=True, help="comma-separated task names")
    p.add_argument("--k", type=int, default=64)
    p.add_argument("--output-dir", required=True)
    args = p.parse_args(argv)
    for task in args.task.split(","):
        n = shrink_task(args.data_dir, task, args.k, args.output_dir)
        print(json.dumps({"task": task, "kept": n,
                          "output": os.path.join(args.output_dir,
                                                 f"{task}.jsonl")}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
