"""Replay previous eval responses as a model (lmms-eval ``from_log`` parity).

The reference ships a registered model that answers ``generate_until``
requests from persisted sample logs instead of running a checkpoint
(``lmms-eval/lmms_eval/models/from_log.py:16-112``: walks log folders,
keys responses by ``doc_id`` per task, newest log wins). It exists so
scores can be re-aggregated — after a metric fix, with different filters,
or merged across runs — without re-running the model.

Here the inputs are the jsonl sample logs that ``evaluate(...,
log_samples_path=...)`` and ``run_eval`` already write (one record per
request: task / doc_id / question / answers / prediction / is_padding).
``ReplayAdapter`` duck-types the ``EngineAdapter`` surface that
``evaluate`` consumes, so the whole scoring path (filters, metrics,
bootstrap, tracker) runs unchanged over replayed predictions:

    python -m visionselector_tpu_torch.api.run_eval --from-log results/ \
        --tasks chartqa --data-dir eval_data/ --output-dir rescored/
"""

from __future__ import annotations

import json
import os
import re
import time
from typing import Dict, List, Sequence, Tuple


class _StubEngine:
    """Minimal attribute surface ``evaluate`` reads off ``adapter.engine``."""

    use_selector = False
    budget = 0.0
    strategy = None


class ReplayAdapter:
    """Answers eval requests from persisted sample logs.

    Args:
        logs: comma-separated files and/or directories. Directories are
            walked for ``*.jsonl`` sample logs. Files are applied oldest
            first, so the NEWEST log wins each (task, doc_id) — matching
            the reference's newest-log-wins rule (``from_log.py:80-81``).
            Recency uses an embedded filename timestamp
            (``...YYYYmmddTHHMMSS...``, the tracker's stamp) when present
            — robust to copies/checkouts resetting mtimes, like the
            reference's date-stamped folder parse — and falls back to
            mtime otherwise.
        strict: missing (task, doc_id) raises KeyError (default); with
            ``strict=False`` it replays an empty prediction instead.
    """

    eval_time = False
    model_tag = "from_log"

    def __init__(self, logs: str, strict: bool = True):
        self.engine = _StubEngine()
        self.strict = strict
        self._preds: Dict[Tuple[str, int], str] = {}
        files = []
        for path in logs.split(","):
            path = path.strip()
            if not path:
                continue
            if os.path.isdir(path):
                for root, _, names in os.walk(path):
                    files.extend(os.path.join(root, n) for n in names
                                 if n.endswith(".jsonl"))
            elif os.path.exists(path):
                files.append(path)
            else:
                raise FileNotFoundError(f"--from-log path {path!r}")
        if not files:
            raise FileNotFoundError(f"no .jsonl sample logs under {logs!r}")
        for f in sorted(files, key=self._recency):
            self._load(f)

    @staticmethod
    def _recency(path: str) -> float:
        """Epoch seconds: the filename's embedded run stamp when present
        (survives copies/checkouts resetting mtimes), else mtime — both in
        the same unit so mixed sets order sensibly."""
        m = re.search(r"(\d{8}T\d{6})", os.path.basename(path))
        if m:
            try:
                return time.mktime(
                    time.strptime(m.group(1), "%Y%m%dT%H%M%S"))
            except ValueError:
                pass  # digits that merely look like a stamp
        return os.path.getmtime(path)

    def _load(self, path: str) -> None:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue  # not a sample log — skip the file's junk lines
                if not isinstance(rec, dict) or "prediction" not in rec:
                    continue
                if rec.get("is_padding"):
                    continue
                key = (rec.get("task"), rec.get("doc_id"))
                if key[0] is None or key[1] is None:
                    continue
                self._preds[key] = rec["prediction"]

    def __len__(self) -> int:
        return len(self._preds)

    def _lookup(self, req) -> str:
        key = (req.task.name, req.doc_id)
        if key in self._preds:
            return self._preds[key]
        if self.strict:
            raise KeyError(
                f"no logged response for task={key[0]!r} doc_id={key[1]} "
                f"({len(self._preds)} replayable records loaded)")
        return ""

    def generate_until(self, requests: Sequence) -> List[str]:
        return [self._lookup(r) for r in requests]

    # MC tasks store the chosen letter/string as the prediction, so replay
    # is the same lookup (the loglikelihood pass already happened).
    def predict_multiple_choice(self, requests: Sequence) -> List[str]:
        return [self._lookup(r) for r in requests]

    def generate_until_multi_round(self, requests: Sequence) -> List[str]:
        return self.generate_until(requests)
