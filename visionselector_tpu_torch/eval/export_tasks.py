"""Export HF benchmark releases into the harness's jsonl + image-dir schema.

``eval.tasks.load_task_docs`` reads ``<data_dir>/<task>.jsonl`` with::

    {"question": str, "answers": [str, ...], "image": "rel/path.png"}
    {"question": str, "answers": [str, ...], "video": "rel/dir_or_file"}

The reference pulls these benchmarks live from the hub via each task yaml's
``dataset_path`` (e.g. ``lmms-eval/lmms_eval/tasks/chartqa/chartqa.yaml``
``dataset_path: lmms-lab/ChartQA``) and maps doc fields in that task's
``utils.py`` ``doc_to_visual`` / ``doc_to_text`` / ``doc_to_target``. This
module is the offline equivalent: point it at a locally downloaded release
(``datasets.load_from_disk`` directory, a parquet file, or a directory of
parquet shards) and it writes the task's jsonl + extracted images.

Per-task field mappings cite the reference utils they mirror. MC tasks are
rendered to the same "A. <choice>" option block the reference prompts with
(``scienceqa/utils.py:sqa_doc_to_text``, ``ai2d/utils.py:ai2d_doc_to_text``)
with the answer letter as the target; the harness's TaskConfig appends the
answer-format suffix at load time, so it is NOT written here.

Usage:
    python -m visionselector_tpu_torch.eval.export_tasks \
        --task chartqa --dataset-path /data/hf/ChartQA --split test \
        --output-dir /data/vst_eval [--limit N]

Video tasks write jsonl referencing ``<videoID>.mp4`` (the reference
resolves the same id against its video cache dir,
``videomme/utils.py:137``); supply the video files separately under the
output dir.
"""

from __future__ import annotations

import argparse
import io
import json
import os
from typing import Callable, Dict, Iterable, Optional

LETTERS = [chr(ord("A") + i) for i in range(26)]


def _as_list(x) -> list:
    if x is None:
        return []
    if isinstance(x, (list, tuple)):
        # VQAv2/OK-VQA/VizWiz releases carry answers as annotation dicts
        # ({answer, answer_confidence, answer_id} — lmms-eval vqav2 utils
        # index doc["answers"][i]["answer"]); extract the answer text
        return [str(a["answer"]) if isinstance(a, dict) and "answer" in a
                else str(a) for a in x]
    return [str(x)]


def mc_block(question: str, choices, context: Optional[str] = None) -> str:
    """Render the reference's MC prompt body: question + 'A. x\\nB. y' block
    (``scienceqa/utils.py:sqa_doc_to_text``); context prepended when the
    doc carries a hint."""
    opts = "\n".join(
        f"{LETTERS[i]}. {c}" for i, c in enumerate(choices))
    ctx = f"Context: {context}\n" if context else ""
    return f"{ctx}{question}\n{opts}"


def _answer_letter(answer, choices) -> str:
    """Normalize an answer (index, letter, or choice text) to its letter."""
    if isinstance(answer, (int,)) or (
            isinstance(answer, str) and answer.isdigit()):
        return LETTERS[int(answer)]
    a = str(answer).strip()
    if len(a) == 1 and a.upper() in LETTERS[:len(choices)]:
        return a.upper()
    for i, c in enumerate(choices):
        if str(c).strip().lower() == a.lower():
            return LETTERS[i]
    raise ValueError(f"cannot normalize MC answer {answer!r}")


# --------------------------------------------------------------------------
# Per-task doc mappers: HF doc -> {question, answers, image|video|None}.
# `image` in the returned dict is the raw HF image value (PIL or
# {bytes,path}); the writer materializes it to a PNG.
# --------------------------------------------------------------------------

def _map_chartqa(doc):
    # chartqa/utils.py: doc_to_visual doc["image"], doc_to_text
    # doc["question"], target doc["answer"]
    return {"question": doc["question"], "answers": _as_list(doc["answer"]),
            "image": doc["image"]}


def _map_docvqa(doc):
    # docvqa/utils.py: doc["image"], doc["question"]; val split target is
    # the doc's answers list (anls over multiple references)
    return {"question": doc["question"],
            "answers": _as_list(doc.get("answers") or doc.get("answer")),
            "image": doc["image"]}


def _map_textvqa(doc):
    # textvqa/utils.py: doc["image"], doc["question"], doc["answers"]
    # (10 annotator answers, consensus-scored)
    return {"question": doc["question"], "answers": _as_list(doc["answers"]),
            "image": doc["image"]}


def _map_scienceqa(doc):
    # scienceqa/utils.py:sqa_doc_to_text: hint/question/choices;
    # target options[doc["answer"]]
    if doc.get("image") is None:
        return None  # scienceqa_img = image split only
    q = mc_block(doc["question"], doc["choices"], doc.get("hint") or None)
    return {"question": q,
            "answers": [_answer_letter(doc["answer"], doc["choices"])],
            "image": doc["image"]}


def _map_ai2d(doc):
    # ai2d/utils.py: question/options; target options[int(doc["answer"])]
    q = mc_block(doc["question"], doc["options"])
    return {"question": q,
            "answers": [_answer_letter(doc["answer"], doc["options"])],
            "image": doc["image"]}


def _map_pope(doc):
    # pope/utils.py: doc["question"], doc["answer"] (yes/no)
    return {"question": doc["question"], "answers": _as_list(doc["answer"]),
            "image": doc["image"]}


def _map_mme(doc):
    # mme/utils.py: doc["question"], doc["answer"] (Yes/No)
    return {"question": doc["question"], "answers": _as_list(doc["answer"]),
            "image": doc["image"]}


def _map_ocrbench(doc):
    # ocrbench/utils.py: doc["question"], doc["answer"] (list of refs)
    return {"question": doc["question"], "answers": _as_list(doc["answer"]),
            "image": doc["image"]}


def _map_gqa(doc):
    # gqa/utils.py: doc["question"], doc["answer"]; image joined by id
    # (lmms-lab/GQA ships a parallel image split — export the qa split
    # against a release whose docs carry the image inline, or place
    # images manually)
    return {"question": doc["question"], "answers": _as_list(doc["answer"]),
            "image": doc.get("image")}


def _map_mmbench(doc):
    # mmbench/en_utils.py: options live in columns A..E (may be nan),
    # hint in doc["hint"], target letter in doc["answer"]
    choices = []
    for letter in LETTERS[:5]:
        v = doc.get(letter)
        if v is None or (isinstance(v, float) and v != v) or v == "nan":
            break
        choices.append(v)
    hint = doc.get("hint")
    if isinstance(hint, float) and hint != hint:
        hint = None
    q = mc_block(doc["question"], choices, hint or None)
    return {"question": q, "answers": [str(doc["answer"]).strip().upper()],
            "image": doc["image"]}


def _map_mmmu(doc):
    # mmmu/utils.py: options is a STRING repr of a list
    # (ast.literal_eval, utils.py:125); images in image_1..image_7
    # (doc_to_visual); MC answer is the letter, open questions keep the
    # raw answer
    import ast

    opts = doc.get("options")
    if isinstance(opts, str):
        opts = ast.literal_eval(opts) if opts.strip() else []
    q = doc["question"]
    if opts:
        q = mc_block(q, opts)
        ans = [str(doc["answer"]).strip().upper()]
    else:
        ans = _as_list(doc["answer"])
    imgs = [doc[f"image_{i}"] for i in range(1, 8)
            if doc.get(f"image_{i}") is not None]
    if not imgs and doc.get("image") is not None:
        # mmmu_pro vision-variant rows carry one composite image
        imgs = [doc["image"]]
    return {"question": q, "answers": ans, "images": imgs}


def _map_videomme(doc):
    # videomme/utils.py:137,152-153: video <videoID>.mp4; question +
    # newline-joined options (already letter-prefixed in the release);
    # target doc["answer"] letter
    q = doc["question"] + "\n" + "\n".join(doc["options"])
    return {"question": q, "answers": [str(doc["answer"]).strip().upper()],
            "video": doc["videoID"] + ".mp4"}


def _letter_of(answer) -> str:
    """First option letter in a free-form answer field: 'A', '(B)', 'C. foo'
    all normalize to the letter (mirrors the reference's per-task
    extract_characters_regex variants, e.g. ``mlvu/utils.py:72-79``)."""
    a = str(answer).strip()
    if a and a[0] == "(" and len(a) > 1:
        a = a[1:]
    if a and a[0].upper() in LETTERS:
        return a[0].upper()
    raise ValueError(f"cannot extract option letter from {answer!r}")


def _map_seedbench(doc):
    # seedbench/utils.py:seed_doc_to_text: question + choice_a..d rendered
    # as 'A. x'; target doc["answer"] letter; doc["image"] is a LIST
    # (seed_doc_to_visual iterates it) -> multi-image record
    choices = [doc[f"choice_{c}"] for c in "abcd"]
    q = doc["question"] + "\n" + "\n".join(
        f"{LETTERS[i]}. {c}" for i, c in enumerate(choices))
    imgs = doc["image"] if isinstance(doc["image"], (list, tuple)) \
        else [doc["image"]]
    return {"question": q, "answers": [_letter_of(doc["answer"])],
            "images": list(imgs)}


def _map_mmstar(doc):
    # mmstar/utils.py:mmstar_doc_to_text: options already embedded in
    # doc["question"]; target doc["answer"] letter
    return {"question": doc["question"].strip(),
            "answers": [_letter_of(doc["answer"])], "image": doc["image"]}


def _map_realworldqa(doc):
    # realworldqa/utils.py:9-18: doc["image"], question (options embedded),
    # doc["answer"] letter (MC) or short phrase
    a = str(doc["answer"]).strip()
    if len(a) == 1 and a.upper() in LETTERS:
        a = a.upper()
    return {"question": doc["question"].strip(), "answers": [a],
            "image": doc["image"]}


def _map_hallusion(doc):
    # hallusion_bench/utils.py:28-33 (question, image) +
    # evaluate_hb.py:92 (gt_answer: '1'=yes / '0'=no); image-only variant
    # (hallusion_bench_image.yaml) skips figure-less rows
    if doc.get("image") is None:
        return None
    gt = str(doc.get("gt_answer", doc.get("answer", ""))).strip()
    ans = {"1": "yes", "0": "no"}.get(gt, gt.lower())
    return {"question": doc["question"], "answers": [ans],
            "image": doc["image"]}


def _map_mme_realworld(doc):
    # mme_realworld/utils.py:31-56: base64 image in doc["bytes"]; question +
    # doc["multi-choice options"] (already letter-prefixed) block; target
    # doc["answer"] letter
    import base64

    img = doc.get("bytes")
    if isinstance(img, str):
        img = {"bytes": base64.b64decode(img), "path": None}
    elif img is None:
        img = doc.get("image")
    q = doc["question"] + "\n" + "\n".join(doc["multi-choice options"])
    return {"question": q, "answers": [_letter_of(doc["answer"])],
            "image": img}


def _map_qbench(doc):
    # qbench/utils.py:q_bench_doc_to_text: option0..3 minus 'N/A', letter
    # block; target doc["correct_choice"]; visual doc["image"] or the
    # image1/image2 pair (A-bench, utils.py:22-26)
    choices = [doc[f"option{i}"] for i in range(4)
               if doc.get(f"option{i}") not in (None, "N/A")]
    q = mc_block(doc["question"], choices)
    ans = doc.get("correct_choice", doc.get("answer"))
    rec = {"question": q, "answers": [_answer_letter(ans, choices)]}
    if doc.get("image") is not None:
        rec["image"] = doc["image"]
    else:
        rec["images"] = [doc["image1"], doc["image2"]]
    return rec


def _map_egoschema(doc):
    # egoschema/utils.py:37-66: video doc["video_idx"]+'.mp4'; options are
    # already letter-prefixed strings appended line-per-option; target is
    # the int answer index
    q = doc["question"] + "\n" + "\n".join(doc["option"])
    return {"question": q, "answers": [LETTERS[int(doc["answer"])]],
            "video": doc["video_idx"] + ".mp4"}


def _map_nextqa_mc(doc):
    # nextqa/utils.py:59-78: question + a0..a4 as 'A. x'; target
    # OPTIONS[doc["answer"]] (int index); video doc["video"]+'.mp4'
    choices = [doc[f"a{i}"] for i in range(5) if doc.get(f"a{i}") is not None]
    q = mc_block(doc["question"].strip(), [c.strip() for c in choices])
    return {"question": q, "answers": [LETTERS[int(doc["answer"])]],
            "video": str(doc["video"]) + ".mp4"}


def _map_perceptiontest(doc):
    # perceptiontest/val/utils.py:36-76: video doc["video_name"]+'.mp4';
    # options prefixed A./B./C.; target doc["answer_id"] (int index)
    q = mc_block(doc["question"], doc["options"])
    return {"question": q, "answers": [LETTERS[int(doc["answer_id"])]],
            "video": doc["video_name"] + ".mp4"}


def _map_tempcompass_mc(doc):
    # tempcompass/utils.py:55-66,134-137: options embedded in
    # doc["question"]; rating compares pred to doc["answer"][0] (letter);
    # video doc["video_id"]+'.mp4'
    return {"question": doc["question"].strip(),
            "answers": [_letter_of(doc["answer"])],
            "video": doc["video_id"] + ".mp4"}


def _map_mlvu(doc):
    # mlvu/utils.py:44-69,95: options embedded in doc["question"]; target
    # doc["answer"] (letter via extract_characters_regex); video
    # doc["video_name"] verbatim (already carries its extension)
    return {"question": doc["question"].strip(),
            "answers": [_letter_of(doc["answer"])],
            "video": doc["video_name"]}


def _map_longvideobench(doc):
    # longvideobench/utils.py:114-125,291-292: option0..4 minus 'N/A'
    # letter block; target chr('A'+doc["correct_choice"]); video
    # doc["video_path"]
    choices = [doc[f"option{i}"] for i in range(5)
               if doc.get(f"option{i}") not in (None, "N/A")]
    q = mc_block(doc["question"], choices)
    return {"question": q,
            "answers": [LETTERS[int(doc["correct_choice"])]],
            "video": doc["video_path"]}


def _map_mvbench(doc):
    # mvbench/utils.py:93-101,170-171: 'Question:' + question + candidate
    # block; target = letter of doc["answer"]'s position in
    # doc["candidates"]; video doc["video"] (subdir-relative)
    cands = doc["candidates"]
    q = "Question:" + doc["question"] + "\n" + "\n".join(
        f"{LETTERS[i]}. {c}" for i, c in enumerate(cands))
    return {"question": q,
            "answers": [_answer_letter(doc["answer"], cands)],
            "video": doc["video"]}


CAPTION_PROMPT = "Provide a one-sentence caption for the provided image."


def _map_caption(answers_field):
    """Caption releases: the prompt is fixed (coco_cap/utils.py:31,
    flickr30k/utils.py:23, nocaps/_default_template prompt) and the target
    is the per-image reference-caption list in ``answers_field``
    (coco 'answer', nocaps 'annotations_captions', textcaps 'caption_str',
    flickr 'caption')."""
    def mapper(doc):
        return {"question": CAPTION_PROMPT,
                "answers": _as_list(doc[answers_field]),
                "image": doc["image"]}
    return mapper


def _map_muirbench(doc):
    # muirbench/utils.py:10-25: question + options letter block; multi-image
    # doc["image_list"]; target doc["answer"] (letter or option text)
    q = mc_block(doc["question"], doc["options"])
    return {"question": q,
            "answers": [_answer_letter(doc["answer"], doc["options"])],
            "images": list(doc["image_list"])}


def _map_iconqa(doc):
    # iconqa/utils.py:28-50: choose_txt renders doc["choices"] (comma
    # string); fill_in_blank keeps the free-form answer; choose_img rows
    # (image-valued options) are skipped — the jsonl schema carries one
    # option set per question
    qt = doc.get("ques_type", "choose_txt")
    if qt == "choose_img":
        return None
    img = doc.get("query_image", doc.get("image"))
    if qt == "fill_in_blank":
        return {"question": doc["question"],
                "answers": _as_list(doc["answer"]), "image": img}
    choices = [c.strip() for c in str(doc["choices"]).split(",")]
    return {"question": mc_block(doc["question"], choices),
            "answers": [_answer_letter(doc["answer"], choices)],
            "image": img}


def _map_hrbench(doc):
    # hrbench/utils.py:40-50: base64 image; options in single-letter
    # columns (nan-padded); target doc["answer"] letter
    import base64

    choices = []
    for letter in LETTERS:
        v = doc.get(letter)
        if v is None or (isinstance(v, float) and v != v):
            break
        choices.append(v)
    img = doc["image"]
    if isinstance(img, str):
        img = {"bytes": base64.b64decode(img), "path": None}
    return {"question": mc_block(doc["question"].strip(), choices),
            "answers": [_letter_of(doc["answer"])], "image": img}


def _map_illusionvqa(doc):
    # illusionvqa/utils.py:8-21: options list; target is the option TEXT
    # (options.index(doc["answer"]) -> letter)
    return {"question": mc_block(doc["question"], doc["options"]),
            "answers": [_answer_letter(doc["answer"], doc["options"])],
            "image": doc["image"]}


def _map_vmcbench(doc):
    # vmcbench/utils.py:34-40,123-126: options in A..D columns; target
    # doc["answer"] letter
    choices = [doc[c] for c in "ABCD"
               if doc.get(c) is not None
               and not (isinstance(doc.get(c), float) and doc[c] != doc[c])]
    return {"question": mc_block(doc["question"], choices),
            "answers": [_letter_of(doc["answer"])], "image": doc["image"]}


def _map_multidocvqa(doc):
    # multidocvqa/utils.py:13-28: answers is a STRING repr of a list
    # (ast.literal_eval); pages in image_1..image_20
    import ast

    ans = doc.get("answers")
    if isinstance(ans, str):
        ans = ast.literal_eval(ans)
    imgs = [doc[f"image_{i}"] for i in range(1, 21)
            if doc.get(f"image_{i}") is not None]
    return {"question": doc["question"], "answers": _as_list(ans),
            "images": imgs}


def _map_websrc(doc):
    # websrc/utils.py:20-43: base64 image string; squad-F1 over
    # doc["answer"]
    import base64

    img = doc["image"]
    if isinstance(img, str):
        img = {"bytes": base64.b64decode(img), "path": None}
    return {"question": doc["question"],
            "answers": _as_list(doc["answer"]), "image": img}


def _map_egoplan(doc):
    # egoplan/utils.py:138-167,203: task_goal-templated question + choice_a..d
    # letter block; target doc["golden_choice_idx"]; video sample_id+'.mp4'
    goal = doc["task_goal"]
    if "goal" in goal:
        goal = goal.split("to", 1)[1].strip()
    if goal.split()[0].endswith("ing"):
        q = (f"I am tasked with {goal}. The task's progress is demonstrated "
             "in the provided video. My current field of view is shown in "
             "the provided image. What should be my next action? Please "
             "output the most reasonable action you think, expressed in a "
             "short phrase.")
    else:
        q = (f"My current task is to {goal}. The task's progress is "
             "demonstrated in the provided video. My current field of view "
             "is shown in the provided image. What should be my next "
             "action? Please output the most reasonable action you think, "
             "expressed in a short phrase.")
    choices = [doc[f"choice_{c}"] for c in "abcd"]
    q = q + "\n" + "\n".join(
        f"{LETTERS[i]}. {c}" for i, c in enumerate(choices))
    return {"question": q,
            "answers": [_letter_of(doc["golden_choice_idx"])],
            "video": str(doc["sample_id"]) + ".mp4"}


def _map_videommmu(doc):
    # videommmu/utils.py:60-101: video doc["id"]+'.mp4'; MC renders the
    # options block, open questions keep the raw answer
    q = doc["question"]
    if doc.get("question_type") == "multiple-choice" and doc.get("options"):
        opts = doc["options"]
        if isinstance(opts, str):
            import ast

            opts = ast.literal_eval(opts)
        q = mc_block(q, opts)
        ans = [_letter_of(doc["answer"])]
    else:
        ans = _as_list(doc["answer"])
    return {"question": q, "answers": ans,
            "video": str(doc["id"]) + ".mp4"}


def _map_generic_vqa(doc):
    # Generic {question, answers|answer, image} releases (e.g.
    # howard-hou/OCR-VQA for the paper's ocr_vqa row,
    # qwen-evaluation/run_selector.sh:36)
    return {"question": doc["question"],
            "answers": _as_list(doc.get("answers") or doc.get("answer")),
            "image": doc.get("image")}


EXPORTERS: Dict[str, Callable] = {
    "chartqa": _map_chartqa,
    "docvqa_val": _map_docvqa,
    "infovqa_val": _map_docvqa,   # same schema family (anls, answers list)
    "stvqa": _map_docvqa,
    "textvqa_val": _map_textvqa,
    "ok_vqa_val2014": _map_textvqa,
    "vqav2_val": _map_textvqa,
    "vizwiz_vqa_val": _map_textvqa,
    "scienceqa_img": _map_scienceqa,
    "ai2d": _map_ai2d,
    "ai2d_no_mask": _map_ai2d,
    "pope": _map_pope,
    "mme": _map_mme,
    "ocrbench": _map_ocrbench,
    "gqa": _map_gqa,
    "mmbench": _map_mmbench,
    "mmmu_val": _map_mmmu,
    "videomme": _map_videomme,
    "seedbench": _map_seedbench,
    "seedbench_2": _map_seedbench,   # same choice_a..d/image-list schema
    "mmstar": _map_mmstar,
    "realworldqa": _map_realworldqa,
    "hallusion_bench_image": _map_hallusion,
    "mme_realworld": _map_mme_realworld,
    "qbench_dev": _map_qbench,
    "egoschema": _map_egoschema,
    "nextqa_mc_test": _map_nextqa_mc,
    "perceptiontest_val_mc": _map_perceptiontest,
    "tempcompass_mc": _map_tempcompass_mc,
    "mlvu": _map_mlvu,
    "longvideobench": _map_longvideobench,
    "mvbench": _map_mvbench,
    "ocr_vqa": _map_generic_vqa,
    "coco2017_cap_val": _map_caption("answer"),
    "nocaps_val": _map_caption("annotations_captions"),
    "textcaps_val": _map_caption("caption_str"),
    "flickr30k_test": _map_caption("caption"),
    "websrc": _map_websrc,
    "mmmu_pro": _map_mmmu,
    "muirbench": _map_muirbench,
    "iconqa": _map_iconqa,
    "hrbench": _map_hrbench,
    "illusionvqa": _map_illusionvqa,
    "vmcbench": _map_vmcbench,
    "seedbench_2_plus": _map_seedbench,
    "multidocvqa": _map_multidocvqa,
    "egoplan": _map_egoplan,
    "videommmu": _map_videommmu,
}


def load_docs(dataset_path: str, split: Optional[str]) -> Iterable[dict]:
    """Load docs from a local HF release: a ``save_to_disk`` directory, a
    parquet file, or a directory of parquet shards. Never touches the
    network.

    Split handling is strict: a DatasetDict requires ``--split`` (and the
    name must exist); a parquet DIRECTORY with ``--split`` exports only
    shards under/named for that split and errors when none match —
    silently merging train+test shards into one jsonl would contaminate
    eval data."""
    import datasets

    if os.path.isdir(dataset_path):
        names = os.listdir(dataset_path)
        if "dataset_info.json" in names or "dataset_dict.json" in names:
            ds = datasets.load_from_disk(dataset_path)
            if isinstance(ds, datasets.DatasetDict) or hasattr(ds, "keys"):
                avail = list(ds.keys())
                if split is None:
                    if len(avail) == 1:
                        return ds[avail[0]]
                    raise SystemExit(
                        f"{dataset_path} is a DatasetDict; pass --split "
                        f"(available: {', '.join(avail)})")
                if split not in avail:
                    raise SystemExit(
                        f"split {split!r} not in {dataset_path} "
                        f"(available: {', '.join(avail)})")
                return ds[split]
            return ds
        files = sorted(
            os.path.join(root, f)
            for root, _, fs in os.walk(dataset_path)
            for f in fs if f.endswith(".parquet"))
        if split:
            want = [f for f in files
                    if f"{os.sep}{split}{os.sep}" in f
                    or os.path.basename(f).startswith(f"{split}-")
                    or os.path.basename(f).startswith(f"{split}.")]
            if not want:
                raise SystemExit(
                    f"no parquet shards for split {split!r} under "
                    f"{dataset_path} (found {len(files)} shards total)")
            files = want
        if not files:
            raise FileNotFoundError(f"no parquet files under {dataset_path}")
        return datasets.load_dataset(
            "parquet", data_files=files, split="train")
    if dataset_path.endswith(".parquet"):
        return datasets.load_dataset(
            "parquet", data_files=[dataset_path], split="train")
    raise FileNotFoundError(dataset_path)


def _save_image(img, path: str) -> None:
    from PIL import Image

    if isinstance(img, dict):  # HF image feature as {bytes, path}
        if img.get("bytes"):
            img = Image.open(io.BytesIO(img["bytes"]))
        else:
            img = Image.open(img["path"])
    if not hasattr(img, "save"):
        import numpy as np

        img = Image.fromarray(np.asarray(img))
    img.convert("RGB").save(path)


def export_task(task: str, dataset_path: str, output_dir: str,
                split: Optional[str] = None, limit: Optional[int] = None,
                image_subdir: str = "images") -> int:
    """Write ``<output_dir>/<task>.jsonl`` (+ extracted images). Returns
    the number of exported docs."""
    if task not in EXPORTERS:
        raise SystemExit(
            f"no exporter for task {task!r}; available: "
            f"{', '.join(sorted(EXPORTERS))}")
    mapper = EXPORTERS[task]
    docs = load_docs(dataset_path, split)
    os.makedirs(output_dir, exist_ok=True)
    img_dir = os.path.join(output_dir, image_subdir)
    n = 0
    with open(os.path.join(output_dir, f"{task}.jsonl"), "w") as out:
        for doc in docs:
            if limit is not None and n >= limit:
                break
            rec = mapper(doc)
            if rec is None:
                continue
            img = rec.pop("image", None)
            imgs = rec.pop("images", None)
            if imgs is not None:  # multi-image docs (MMMU)
                os.makedirs(img_dir, exist_ok=True)
                rels = []
                for j, im in enumerate(imgs):
                    rel = os.path.join(image_subdir,
                                       f"{task}_{n:06d}_{j}.png")
                    _save_image(im, os.path.join(output_dir, rel))
                    rels.append(rel)
                rec["images"] = rels
            elif img is not None:
                os.makedirs(img_dir, exist_ok=True)
                rel = os.path.join(image_subdir, f"{task}_{n:06d}.png")
                _save_image(img, os.path.join(output_dir, rel))
                rec["image"] = rel
            out.write(json.dumps(rec) + "\n")
            n += 1
    return n


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--task", required=True,
                   help=f"one of: {', '.join(sorted(EXPORTERS))}")
    p.add_argument("--dataset-path", required=True,
                   help="local HF release: save_to_disk dir, parquet file, "
                        "or dir of parquet shards")
    p.add_argument("--split", default=None)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--limit", type=int, default=None)
    args = p.parse_args(argv)
    n = export_task(args.task, args.dataset_path, args.output_dir,
                    split=args.split, limit=args.limit)
    print(json.dumps({"task": args.task, "exported": n,
                      "output": os.path.join(args.output_dir,
                                             f"{args.task}.jsonl")}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
