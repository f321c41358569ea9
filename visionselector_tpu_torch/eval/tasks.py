"""Task registry for the evaluation harness.

Mirrors the role of lmms-eval's YAML task configs + utils
(``lmms-eval/lmms_eval/api/task.py``, ``tasks/<name>/*.yaml``) with a compact
dataclass registry. Datasets are read from local jsonl files (one object per
line) with fields::

    {"question": str, "answers": [str, ...], "image": "relative/path.png"}

pointed at by ``data_dir`` (images resolved relative to it). The paper's image
suite (``qwen-evaluation/run_selector.sh:36``) is pre-registered; datasets are
supplied by the user (no network access is assumed).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Sequence

from visionselector_tpu_torch.eval import metrics as M


@dataclasses.dataclass(frozen=True)
class TaskConfig:
    name: str
    metric: str  # key into metrics.METRICS
    prompt_suffix: str = ""  # appended to the question (task-style prompting)
    max_new_tokens: int = 32
    aggregate: str = "mean"  # "mean" | "pope"
    splits_answers: bool = True  # answers field is a list
    # response filter pipeline (eval.filters.PIPELINES key) applied to raw
    # generations before scoring — lmms-eval filter_list equivalent
    filter: str = "none"
    # Which lmms model-ABC method answers this task's requests
    # (``lmms-eval/lmms_eval/api/model.py:30-90``): "generate_until"
    # (default) or "loglikelihood" (MC scored by per-choice continuation
    # log-prob instead of free generation).
    request_type: str = "generate_until"
    # jsonl basename when it differs from the task name (lets a
    # loglikelihood variant share the generative task's dataset)
    dataset_file: Optional[str] = None


# The paper image suite (run_selector.sh:36) + shapes of their prompting.
_SHORT = "\nAnswer the question using a single word or phrase."
_MC = "\nAnswer with the option's letter from the given choices directly."

TASKS: Dict[str, TaskConfig] = {
    "chartqa": TaskConfig("chartqa", "relaxed_accuracy", _SHORT, 32),
    "docvqa_val": TaskConfig("docvqa_val", "anls", _SHORT, 32),
    "textvqa_val": TaskConfig("textvqa_val", "vqa_accuracy", _SHORT, 32),
    "ocrbench": TaskConfig("ocrbench", "contains_accuracy", _SHORT, 48),
    "scienceqa_img": TaskConfig("scienceqa_img", "multiple_choice", _MC, 8,
                                filter="mc_letter"),
    "ai2d_no_mask": TaskConfig("ai2d_no_mask", "multiple_choice", _MC, 8,
                               filter="mc_letter"),
    "mmmu_val": TaskConfig("mmmu_val", "multiple_choice", _MC, 8,
                           filter="mc_letter"),
    "mme": TaskConfig("mme", "yes_no", _SHORT, 8, filter="yes_no"),
    "pope": TaskConfig("pope", "yes_no", _SHORT, 8, aggregate="pope",
                       filter="yes_no"),
    "ocr_vqa": TaskConfig("ocr_vqa", "exact_match", _SHORT, 32),
    # Video suite (the paper's "13 image & video benchmarks", README.md:47;
    # task configs mirror lmms-eval/lmms_eval/tasks/<name>/ MC yaml schemas).
    "videomme": TaskConfig("videomme", "multiple_choice", _MC, 8,
                           filter="mc_letter"),
    "mlvu": TaskConfig("mlvu", "multiple_choice", _MC, 8, filter="mc_letter"),
    "longvideobench": TaskConfig("longvideobench", "multiple_choice", _MC, 8,
                                 filter="mc_letter"),
    "mvbench": TaskConfig("mvbench", "multiple_choice", _MC, 8,
                          filter="mc_letter"),
    # Further standard MC image suites (same yaml shapes in
    # lmms-eval/lmms_eval/tasks/<name>/; datasets are user-supplied jsonl)
    "mmbench": TaskConfig("mmbench", "multiple_choice", _MC, 8,
                          filter="mc_letter"),
    "seedbench": TaskConfig("seedbench", "multiple_choice", _MC, 8,
                            filter="mc_letter"),
    "mmstar": TaskConfig("mmstar", "multiple_choice", _MC, 8,
                         filter="mc_letter"),
    "realworldqa": TaskConfig("realworldqa", "multiple_choice", _MC, 8,
                              filter="mc_letter"),
    # Standard short-answer VQA suites (lmms-eval tasks/<name>/ equivalents
    # with the matching headline metric).
    "infovqa_val": TaskConfig("infovqa_val", "anls", _SHORT, 32),
    "vqav2_val": TaskConfig("vqav2_val", "vqa_accuracy", _SHORT, 32),
    "gqa": TaskConfig("gqa", "exact_match", _SHORT, 32),
    "vizwiz_vqa_val": TaskConfig("vizwiz_vqa_val", "vqa_accuracy", _SHORT,
                                 32),
    # Loglikelihood-scored MC variant (lmms ABC ``loglikelihood``,
    # ``api/model.py:30-57``): each doc's choices are scored by continuation
    # log-prob and the argmax letter is the prediction. Shares the
    # scienceqa_img jsonl.
    "scienceqa_img_ll": TaskConfig(
        "scienceqa_img_ll", "multiple_choice", _MC, 8,
        request_type="loglikelihood", dataset_file="scienceqa_img"),
    # Secondary image suites (lmms-eval tasks/<dir>/<name>.yaml
    # equivalents; same jsonl contract, metric matches each task's
    # headline aggregation).
    "stvqa": TaskConfig("stvqa", "anls", _SHORT, 32),
    "ok_vqa_val2014": TaskConfig("ok_vqa_val2014", "vqa_accuracy", _SHORT,
                                 32),
    # hallusion_bench_image.yaml: yes/no per-question accuracy (its qAcc/
    # fAcc grouped aggregations need the paired metadata; per-question
    # accuracy is the comparable headline here)
    "hallusion_bench_image": TaskConfig("hallusion_bench_image", "yes_no",
                                        _SHORT, 8, filter="yes_no"),
    "seedbench_2": TaskConfig("seedbench_2", "multiple_choice", _MC, 8,
                              filter="mc_letter"),
    "mme_realworld": TaskConfig("mme_realworld", "multiple_choice", _MC, 8,
                                filter="mc_letter"),
    "qbench_dev": TaskConfig("qbench_dev", "multiple_choice", _MC, 8,
                             filter="mc_letter"),
    # ai2d.yaml (masked-option prompt variant; ai2d_no_mask above is the
    # unmasked one the paper suite uses)
    "ai2d": TaskConfig("ai2d", "multiple_choice", _MC, 8,
                       filter="mc_letter"),
    # Secondary video MC suites (tasks/egoschema/egoschema.yaml,
    # nextqa/nextqa_mc_test.yaml, perceptiontest/val,
    # tempcompass/tempcompass_mc.yaml)
    "egoschema": TaskConfig("egoschema", "multiple_choice", _MC, 8,
                            filter="mc_letter"),
    "nextqa_mc_test": TaskConfig("nextqa_mc_test", "multiple_choice", _MC,
                                 8, filter="mc_letter"),
    "perceptiontest_val_mc": TaskConfig(
        "perceptiontest_val_mc", "multiple_choice", _MC, 8,
        filter="mc_letter"),
    "tempcompass_mc": TaskConfig("tempcompass_mc", "multiple_choice", _MC,
                                 8, filter="mc_letter"),
    # Captioning family (tasks/coco_cap, nocaps, textcaps, flickr30k):
    # corpus-level CIDEr-D (their pycocoevalcap Cider aggregation,
    # coco_cap/utils.py:73); the prompt is the doc question itself
    # ("Provide a one-sentence caption...", written by the exporter), so no
    # suffix is appended here.
    "coco2017_cap_val": TaskConfig("coco2017_cap_val", "cider", "", 64,
                                   aggregate="cider"),
    "nocaps_val": TaskConfig("nocaps_val", "cider", "", 64,
                             aggregate="cider"),
    "textcaps_val": TaskConfig("textcaps_val", "cider", "", 64,
                               aggregate="cider"),
    "flickr30k_test": TaskConfig("flickr30k_test", "cider", "", 64,
                                 aggregate="cider"),
    # WebSRC (tasks/websrc/utils.py): web screenshot QA, SQuAD token-F1
    "websrc": TaskConfig("websrc", "squad_f1", _SHORT, 32),
    # Further MC image suites (tasks/<dir>/utils.py mappings in
    # eval/export_tasks.py)
    "mmmu_pro": TaskConfig("mmmu_pro", "multiple_choice", _MC, 8,
                           filter="mc_letter"),
    "muirbench": TaskConfig("muirbench", "multiple_choice", _MC, 8,
                            filter="mc_letter"),
    "iconqa": TaskConfig("iconqa", "multiple_choice", _MC, 8,
                         filter="mc_letter"),
    "hrbench": TaskConfig("hrbench", "multiple_choice", _MC, 8,
                          filter="mc_letter"),
    "illusionvqa": TaskConfig("illusionvqa", "multiple_choice", _MC, 8,
                              filter="mc_letter"),
    "vmcbench": TaskConfig("vmcbench", "multiple_choice", _MC, 8,
                           filter="mc_letter"),
    "seedbench_2_plus": TaskConfig("seedbench_2_plus", "multiple_choice",
                                   _MC, 8, filter="mc_letter"),
    # MP-DocVQA (tasks/multidocvqa): multi-page documents, anls headline
    "multidocvqa": TaskConfig("multidocvqa", "anls", _SHORT, 32),
    # Secondary video suites (tasks/egoplan, tasks/videommmu)
    "egoplan": TaskConfig("egoplan", "multiple_choice", _MC, 8,
                          filter="mc_letter"),
    "videommmu": TaskConfig("videommmu", "multiple_choice", _MC, 8,
                            filter="mc_letter"),
}


def register_task(cfg: TaskConfig) -> None:
    TASKS[cfg.name] = cfg


def load_task_configs(config_dir: str) -> List[str]:
    """Register TaskConfigs from ``*.yaml``/``*.json`` files in a directory.

    The extensibility mechanism standing in for lmms-eval's 147 per-task YAML
    dirs (``lmms-eval/lmms_eval/tasks/<name>/<name>.yaml``): each file holds
    one task spec (or a list) with the TaskConfig field names::

        name: my_task
        metric: multiple_choice
        prompt_suffix: "\\nAnswer with the option's letter."
        max_new_tokens: 8
        filter: mc_letter

    Returns the registered task names. ``yaml`` is imported only when a
    YAML file is read, so a directory of JSON files needs no PyYAML.
    """
    import glob

    names = []
    for path in sorted(
        glob.glob(os.path.join(config_dir, "*.yaml"))
        + glob.glob(os.path.join(config_dir, "*.yml"))
        + glob.glob(os.path.join(config_dir, "*.json"))
    ):
        with open(path) as f:
            if path.endswith(".json"):
                spec = json.load(f)
            else:
                import yaml

                spec = yaml.safe_load(f)
        for item in (spec if isinstance(spec, list) else [spec]):
            fields = {f.name for f in dataclasses.fields(TaskConfig)}
            unknown = set(item) - fields
            if unknown:
                raise ValueError(
                    f"{path}: unknown TaskConfig fields {sorted(unknown)}"
                )
            cfg = TaskConfig(**item)
            register_task(cfg)
            names.append(cfg.name)
    return names


@dataclasses.dataclass
class Request:
    """One evaluation request (lmms-eval Instance equivalent,
    ``api/instance.py``)."""

    doc_id: int
    question: str
    answers: List[str]
    image_path: Optional[str]  # first image (None for text-only/video docs)
    task: TaskConfig
    video_path: Optional[str] = None  # frame dir / .npy / video file
    extra_image_paths: List[str] = dataclasses.field(default_factory=list)
    # Rank-padding marker: duplicated requests appended so every rank runs the
    # same count (SPMD) are generated but NEVER scored — lmms-eval tracks its
    # padding_requests the same way (``evaluator.py:442-473``).
    is_padding: bool = False
    # MC choice strings for loglikelihood-scored tasks (doc "choices" field);
    # empty -> the standard A-D letters.
    choices: List[str] = dataclasses.field(default_factory=list)

    @property
    def image_paths(self) -> List[str]:
        paths = [self.image_path] if self.image_path else []
        return paths + list(self.extra_image_paths)


def load_task_docs(task: TaskConfig, data_dir: str,
                   limit: Optional[float] = None) -> List[Request]:
    """Read ``<data_dir>/<task>.jsonl`` into requests.

    ``limit``: lmms-eval semantics — >= 1 is a document count, a fraction in
    (0, 1) evaluates that share of the docs (``evaluator.py:63,109``)."""
    path = os.path.join(data_dir, f"{task.dataset_file or task.name}.jsonl")
    requests = []
    count_limit = None
    if limit is not None and limit >= 1:
        count_limit = int(limit)
    with open(path) as f:
        for i, line in enumerate(f):
            if count_limit is not None and i >= count_limit:
                break
            doc = json.loads(line)
            answers = doc.get("answers") or [doc.get("answer", "")]
            if isinstance(answers, str):
                answers = [answers]
            # "image": str | "images": [str, ...] (multi-image docs, e.g. MMMU)
            imgs = doc.get("images") or ([doc["image"]] if doc.get("image") else [])
            if isinstance(imgs, str):
                imgs = [imgs]
            imgs = [os.path.join(data_dir, p) for p in imgs]
            vid = doc.get("video")
            requests.append(
                Request(
                    doc_id=i,
                    question=doc["question"] + task.prompt_suffix,
                    answers=[str(a) for a in answers],
                    image_path=imgs[0] if imgs else None,
                    extra_image_paths=imgs[1:],
                    video_path=os.path.join(data_dir, vid) if vid else None,
                    task=task,
                    choices=[str(c) for c in doc.get("choices", [])],
                )
            )
    if limit is not None and 0 < limit < 1:
        requests = requests[: max(1, int(len(requests) * limit))]
    return requests


def shard_requests(requests: Sequence[Request], rank: int,
                   world_size: int) -> List[Request]:
    """Rank-shard with padding so every rank runs the same request count
    (SPMD parity with ``lmms-eval/lmms_eval/evaluator.py:442-462``)."""
    if world_size <= 1:
        return list(requests)
    per_rank = -(-len(requests) // world_size)
    shard = list(requests[rank::world_size])
    while len(shard) < per_rank and requests:
        shard.append(
            dataclasses.replace(requests[rank % len(requests)], is_padding=True)
        )
    return shard


def score_request(req: Request, prediction: str) -> float:
    from visionselector_tpu_torch.eval.filters import apply_pipeline

    prediction = apply_pipeline(req.task.filter, prediction)
    fn = M.METRICS[req.task.metric]
    if req.task.metric in ("multiple_choice", "yes_no"):
        return fn(prediction, req.answers[0])
    return fn(prediction, req.answers)


def aggregate_scores(task: TaskConfig, preds: List[str],
                     requests: List[Request]) -> Dict[str, float]:
    pairs = [(r, p) for r, p in zip(requests, preds) if not r.is_padding]
    if task.aggregate == "cider":
        # Corpus-level CIDEr-D: IDF spans the whole reference set, so the
        # per-sample scores come out of one corpus computation (the mean of
        # which is the headline, exactly pycocoevalcap's contract)
        _, scores = M.cider_d([p for _, p in pairs],
                              [r.answers for r, _ in pairs])
    else:
        scores = [score_request(r, p) for r, p in pairs]
    out = {
        f"{task.name}/{task.metric}": M.mean(scores),
        f"{task.name}/stderr": M.bootstrap_stderr(scores),
        f"{task.name}/n": float(len(scores)),
    }
    if task.aggregate == "pope":
        from visionselector_tpu_torch.eval.filters import apply_pipeline

        pope = M.pope_aggregate(
            [apply_pipeline(task.filter, p) for _, p in pairs],
            [r.answers[0] for r, _ in pairs],
        )
        out.update({f"{task.name}/{k}": v for k, v in pope.items()})
    return out
