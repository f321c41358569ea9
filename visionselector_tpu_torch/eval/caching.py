"""Request/response caching for evaluation runs.

Parity with lmms-eval's dill-pickle request cache
(``lmms-eval/lmms_eval/caching/cache.py:10-60``): responses keyed by a stable
hash of (task, doc_id, question, method, budget) under
``LM_HARNESS_CACHE_PATH`` (same env var contract) — re-runs skip generation
for already-answered requests.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Optional

CACHE_ENV = "LM_HARNESS_CACHE_PATH"


class ResponseCache:
    def __init__(self, path: Optional[str] = None):
        self.path = path or os.environ.get(CACHE_ENV)
        self._mem = {}
        if self.path:
            os.makedirs(self.path, exist_ok=True)

    def enabled(self) -> bool:
        return self.path is not None

    @staticmethod
    def key(task: str, doc_id: int, question: str, method: str,
            budget: float) -> str:
        blob = json.dumps(
            [task, doc_id, question, method, budget], sort_keys=True
        ).encode()
        return hashlib.sha256(blob).hexdigest()[:32]

    def _file(self, key: str) -> str:
        return os.path.join(self.path, f"{key}.json")

    def get(self, key: str) -> Optional[str]:
        if key in self._mem:
            return self._mem[key]
        if not self.enabled():
            return None
        f = self._file(key)
        if os.path.exists(f):
            with open(f) as fh:
                val = json.load(fh)["response"]
            self._mem[key] = val
            return val
        return None

    def put(self, key: str, response: str) -> None:
        self._mem[key] = response
        if self.enabled():
            with open(self._file(key), "w") as fh:
                json.dump({"response": response}, fh)
