"""Structured metrics: a JSONL metric stream with in-memory aggregation,
written by one process of a multi-process run.

PyTorch counterpart of ``difffe_tpu/utils/metrics.py``: the JAX
``jax.process_index()`` is the ``torch.distributed`` rank where a process
group is initialized, and 0 otherwise.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Dict, Optional, TextIO

import torch.distributed as dist


def process_index() -> int:
    """This process's rank in the initialized process group, else 0."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


class MetricsLogger:
    """Append-only JSONL metrics with step/time stamping.

    ``log(step, solves_per_s=..., kappa_err=...)`` → one JSON line.  Under
    a multi-process run only rank 0 writes (pass ``all_hosts=True`` to
    override).
    """

    def __init__(self, path: Optional[str] = None,
                 stream: Optional[TextIO] = None, all_hosts: bool = False):
        self._t0 = time.time()
        self._history: list[Dict[str, Any]] = []
        self._enabled = all_hosts or process_index() == 0
        self._fh: Optional[TextIO] = None
        if self._enabled:
            if path is not None:
                os.makedirs(os.path.dirname(os.path.abspath(path)),
                            exist_ok=True)
                self._fh = open(path, "a")
            elif stream is not None:
                self._fh = stream

    def log(self, step: int, **metrics: Any) -> None:
        record = {"step": step, "t": round(time.time() - self._t0, 4)}
        for k, v in metrics.items():
            record[k] = float(v) if hasattr(v, "__float__") else v
        self._history.append(record)
        if self._fh is not None:
            self._fh.write(json.dumps(record) + "\n")
            self._fh.flush()

    @property
    def history(self):
        return list(self._history)

    def last(self, key: str):
        for rec in reversed(self._history):
            if key in rec:
                return rec[key]
        return None

    def close(self) -> None:
        if self._fh is not None and self._fh not in (sys.stdout, sys.stderr):
            self._fh.close()
            self._fh = None
