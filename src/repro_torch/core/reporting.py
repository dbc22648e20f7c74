"""Metric reporters (paper §3 --report_to). tensorboard/wandb are replaced by
file-backed reporters with the same ``log(step, metrics)`` interface."""

from __future__ import annotations

import csv
import json
import os
import threading
from typing import Dict, List, Optional


class BaseLogger:
    def log(self, step: int, metrics: Dict[str, float]) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class CSVLogger(BaseLogger):
    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._fields: Optional[List[str]] = None
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        # restart safety: adopt an existing file's header so the first log()
        # of a fresh process APPENDS instead of truncating the history a
        # prior run (and the control plane's consumers) already wrote.
        if os.path.exists(path):
            with open(path, newline="") as f:
                header = next(csv.reader(f), None)
            if header:
                self._fields = list(header)

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        with self._lock:
            row = {"step": step, **metrics}
            new_fields = sorted(row)
            if self._fields is None or any(f not in self._fields
                                           for f in new_fields):
                old_rows = []
                if os.path.exists(self.path):
                    with open(self.path) as f:
                        old_rows = list(csv.DictReader(f))
                self._fields = sorted(set(new_fields)
                                      | set(self._fields or []))
                with open(self.path, "w", newline="") as f:
                    w = csv.DictWriter(f, fieldnames=self._fields)
                    w.writeheader()
                    for r in old_rows:
                        w.writerow(r)
            with open(self.path, "a", newline="") as f:
                csv.DictWriter(f, fieldnames=self._fields).writerow(row)


class JSONLLogger(BaseLogger):
    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        with self._lock:
            with open(self.path, "a") as f:
                f.write(json.dumps({"step": step, **metrics}) + "\n")

    def read(self) -> List[dict]:
        if not os.path.exists(self.path):
            return []
        with open(self.path) as f:
            return [json.loads(l) for l in f if l.strip()]


class MultiLogger(BaseLogger):
    def __init__(self, *loggers: BaseLogger):
        self.loggers = loggers

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        for lg in self.loggers:
            lg.log(step, metrics)
