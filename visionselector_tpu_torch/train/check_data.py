"""Training-data validation tool.

The port's copy of ``visionselector_tpu.train.check_data`` (the
reference's ``qwen-vl-finetune/tools/check_image.py``): scan an annotation
jsonl (or json list) against its image root and report missing or corrupt
images (Pillow verifies them), conversations without an ``<image>``
placeholder, and oversize-token samples. Exit code 1 when it found a
problem.

Usage:
    python -m visionselector_tpu_torch.train.check_data \
        --annotation data.jsonl --image-root images/ [--max-tokens 2048]
"""

from __future__ import annotations

import argparse
import json
import os


def check(annotation: str, image_root: str, max_tokens: int | None = None):
    problems = []
    n = 0
    with open(annotation) as f:
        records = (
            [json.loads(l) for l in f if l.strip()]
            if annotation.endswith(".jsonl") else json.load(f)
        )
    for i, rec in enumerate(records):
        n += 1
        img = rec.get("image")
        convs = rec.get("conversations", [])
        if img:
            path = os.path.join(image_root, img)
            if not os.path.exists(path):
                problems.append((i, f"missing image {img}"))
            else:
                try:
                    from PIL import Image

                    with Image.open(path) as im:
                        im.verify()
                except Exception as e:  # noqa: BLE001
                    problems.append((i, f"corrupt image {img}: {e}"))
            if not any("<image>" in t.get("value", "") for t in convs):
                problems.append((i, "image present but no <image> placeholder"))
        if not convs:
            problems.append((i, "empty conversations"))
        elif convs and convs[0].get("from") not in ("human", "user"):
            problems.append((i, "first turn is not from the user"))
        if max_tokens is not None:
            approx = sum(len(t.get("value", "")) for t in convs) // 3
            if approx > max_tokens:
                problems.append((i, f"~{approx} tokens > {max_tokens}"))
    return n, problems


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--annotation", required=True)
    p.add_argument("--image-root", default="")
    p.add_argument("--max-tokens", type=int, default=None)
    args = p.parse_args(argv)
    n, problems = check(args.annotation, args.image_root, args.max_tokens)
    for i, msg in problems:
        print(f"[{i}] {msg}")
    print(f"checked {n} records: {len(problems)} problems")
    return 1 if problems else 0


if __name__ == "__main__":
    raise SystemExit(main())
