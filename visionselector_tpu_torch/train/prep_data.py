"""Dataset preparation utilities.

The port's copy of ``visionselector_tpu.train.prep_data`` (the reference's
``datasets/filter_json.py``: split a combined jsonl per source dataset by
the 'image' path substring; and ``datasets/sample_merge_json_llavaov.py``:
ratio-sample jsonl files and merge / shuffle them into one training file,
``random.Random(seed)``, so a seed gives the same bytes).

Usage:
    python -m visionselector_tpu_torch.train.prep_data filter \\
        --input Cambrian737k.jsonl --output-dir out/ \\
        --datasets ocr_vqa,chartqa,coco
    python -m visionselector_tpu_torch.train.prep_data sample-merge \\
        --inputs a.jsonl:0.5,b.jsonl:1.0 --output merged.jsonl --seed 42
"""

from __future__ import annotations

import argparse
import json
import os
import random
from typing import Dict, List, Tuple


def filter_multimodal_datasets(
    input_file: str,
    output_dir: str,
    target_datasets: List[str],
    output_filename_base: str = "cambrian",
) -> Dict[str, int]:
    """Split records of a combined jsonl into per-source files matched by
    the dataset-name substring of the 'image' field (case-insensitive)."""
    os.makedirs(output_dir, exist_ok=True)
    targets = [t.lower() for t in target_datasets]
    counts = {t: 0 for t in targets}
    handles = {
        t: open(os.path.join(output_dir, f"{t}_{output_filename_base}.jsonl"),
                "w", encoding="utf-8")
        for t in targets
    }
    try:
        with open(input_file, encoding="utf-8") as f:
            for line in f:
                if not line.strip():
                    continue
                rec = json.loads(line)
                image = str(rec.get("image", "")).lower()
                for t in targets:
                    if t in image:
                        handles[t].write(json.dumps(rec, ensure_ascii=False)
                                         + "\n")
                        counts[t] += 1
                        break
    finally:
        for h in handles.values():
            h.close()
    return counts


def sample_jsonl(input_path: str, ratio: float, seed: int = 42) -> List[str]:
    """Random ratio-sample of a jsonl's lines (deterministic given seed)."""
    with open(input_path, encoding="utf-8") as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    if ratio >= 1.0:
        return lines
    rng = random.Random(seed)
    k = max(1, int(len(lines) * ratio)) if lines else 0
    return rng.sample(lines, k)


def sample_and_merge(
    inputs: List[Tuple[str, float]],
    output_path: str,
    seed: int = 42,
    shuffle: bool = True,
) -> int:
    """Sample each (path, ratio) input and merge into one shuffled jsonl."""
    merged: List[str] = []
    for path, ratio in inputs:
        merged.extend(sample_jsonl(path, ratio, seed))
    if shuffle:
        random.Random(seed).shuffle(merged)
    with open(output_path, "w", encoding="utf-8") as f:
        for ln in merged:
            f.write(ln + "\n")
    return len(merged)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    pf = sub.add_parser("filter")
    pf.add_argument("--input", required=True)
    pf.add_argument("--output-dir", required=True)
    pf.add_argument("--datasets", required=True,
                    help="comma-separated source names (image-path substrings)")
    pf.add_argument("--base", default="cambrian")
    pm = sub.add_parser("sample-merge")
    pm.add_argument("--inputs", required=True,
                    help="comma-separated path:ratio pairs")
    pm.add_argument("--output", required=True)
    pm.add_argument("--seed", type=int, default=42)
    args = p.parse_args(argv)

    if args.cmd == "filter":
        counts = filter_multimodal_datasets(
            args.input, args.output_dir, args.datasets.split(","), args.base
        )
        print(json.dumps(counts))
    else:
        pairs = []
        for item in args.inputs.split(","):
            path, _, ratio = item.rpartition(":")
            pairs.append((path, float(ratio)))
        n = sample_and_merge(pairs, args.output, args.seed)
        print(json.dumps({"merged": n, "output": args.output}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
