"""Checkpoint / resume of training state by step number.

PyTorch counterpart of ``difffe_tpu/utils/checkpoint.py`` on
``torch.save``/``torch.load``: a state is any nest of dicts, lists and
tuples whose leaves are tensors or plain Python values — parameters, an
optimizer's ``state_dict()``, a generator's ``get_state()``, the step
counter.  Each step is one file, ``step_<012d>/state.pt``.

``save`` snapshots every tensor to host memory before it returns, so the
caller may update its tensors in place at once.  With ``async_save=True``
the write runs on a background thread; :meth:`wait_until_finished` (also
called before the next save, a restore and garbage collection) joins it
and raises what the write raised.

Multi-process runs: call ``save`` on every process; only rank 0 writes
(and collects garbage).  ``restore`` and ``steps`` read on every process,
from a file system they share.  ``restore(step, template=...)`` puts each
tensor on the device of the template's tensor at the same place, so a
state saved from the card comes back on the card.
"""

from __future__ import annotations

import os
import shutil
import threading
from typing import Any, Optional

import torch

from .metrics import process_index


def _to_host(obj):
    """A copy of ``obj`` with every tensor detached and copied to the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return type(obj)((k, _to_host(v)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _onto(obj, template):
    """``obj`` with each tensor moved to the device of the tensor at the
    same place in ``template`` (leaves without one stay where they are)."""
    if isinstance(obj, torch.Tensor):
        if isinstance(template, torch.Tensor):
            return obj.to(template.device)
        return obj
    if isinstance(obj, dict):
        tmpl = template if isinstance(template, dict) else {}
        return type(obj)((k, _onto(v, tmpl.get(k))) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        tmpl = (template if isinstance(template, (list, tuple))
                and len(template) == len(obj) else [None] * len(obj))
        return type(obj)(_onto(v, t) for v, t in zip(obj, tmpl))
    return obj


class CheckpointManager:
    """Save/restore training states by step number.

    Usage::

        mgr = CheckpointManager("/path/ckpts", max_to_keep=3)
        mgr.save(step, {"log_k": log_k, "opt": opt.state_dict()})
        state = mgr.restore(mgr.latest_step(), template=state_template)

    Keeps the newest ``max_to_keep`` steps.
    """

    def __init__(self, directory: str, max_to_keep: int = 3,
                 async_save: bool = False):
        self.directory = os.path.abspath(directory)
        if process_index() == 0:
            os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._async = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:012d}")

    def _write(self, path: str, state: Any) -> None:
        os.makedirs(path, exist_ok=True)
        tmp = os.path.join(path, "state.pt.tmp")
        torch.save(state, tmp)
        os.replace(tmp, os.path.join(path, "state.pt"))

    def _write_in_background(self, path: str, state: Any) -> None:
        try:
            self._write(path, state)
        except Exception as e:  # raised by wait_until_finished
            self._error = e

    def save(self, step: int, state: Any) -> None:
        """Write ``state`` under ``step`` (see the module note)."""
        self.wait_until_finished()
        state = _to_host(state)
        if process_index() != 0:
            return
        path = self._step_dir(step)
        if self._async:
            self._thread = threading.Thread(
                target=self._write_in_background, args=(path, state),
                name=f"checkpoint-step-{step}", daemon=True)
            self._thread.start()
        else:
            self._write(path, state)
            self._gc()

    def wait_until_finished(self) -> None:
        """Block until an in-flight async save has landed; raise its
        error if it failed."""
        if self._thread is None:
            return
        self._thread.join()
        self._thread = None
        error, self._error = self._error, None
        if error is not None:
            raise error
        self._gc()

    def restore(self, step: int, template: Any = None) -> Any:
        """The state saved under ``step``, its tensors on the devices of
        ``template``'s (the CPU without one)."""
        self.wait_until_finished()
        path = os.path.join(self._step_dir(step), "state.pt")
        if not os.path.exists(path):
            raise FileNotFoundError(f"no checkpoint at step {step}: {path}")
        state = torch.load(path, map_location="cpu", weights_only=True)
        return _onto(state, template) if template is not None else state

    def steps(self):
        """The saved steps, ascending (an in-flight save is waited for)."""
        self.wait_until_finished()
        out = []
        if not os.path.isdir(self.directory):
            return out
        for name in os.listdir(self.directory):
            if name.startswith("step_") and os.path.exists(
                    os.path.join(self.directory, name, "state.pt")):
                try:
                    out.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def _gc(self) -> None:
        if process_index() != 0:
            return
        for s in self.steps()[:-self.max_to_keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
