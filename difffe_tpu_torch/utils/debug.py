"""Numerical-debug guards.

PyTorch counterpart of ``difffe_tpu/utils/debug.py``:

* ``nan_guard`` — a context under which the first torch operation whose
  floating outputs hold a NaN raises ``FloatingPointError`` naming it
  (JAX's ``jax_debug_nans``).  It is a ``TorchDispatchMode``, so it sees
  what goes through torch's dispatcher and nothing else: the port's CUDA
  kernels are launched through ctypes (ops/kernels/_build.py), and a NaN
  that a kernel writes is caught at the first torch operation that
  computes from it, not at the launch.  Every check reads the device, so
  a guarded region runs synchronously.
* ``check_deterministic`` — runs a function twice and compares the
  outputs bit for bit.
* ``golden_compare`` — runs a function in float64 (golden) and in its
  production dtype and reports the worst relative deviation.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves, tree_map


class _NanGuard(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if (isinstance(t, torch.Tensor) and t.is_floating_point()
                    and bool(torch.isnan(t).any())):
                raise FloatingPointError(f"NaN in the output of {func}")
        return out


@contextlib.contextmanager
def nan_guard():
    """Raise at the first NaN-producing torch operation inside the
    context (see the module note for what it cannot see)."""
    with _NanGuard():
        yield


def _host_leaves(out, as_float64=False):
    """The leaves of ``out`` as numpy arrays: their bits (a bfloat16
    tensor viewed as int16), or their values in float64."""
    leaves = []
    for t in tree_leaves(out):
        if isinstance(t, torch.Tensor):
            t = t.detach().cpu()
            if as_float64:
                t = t.double()
            elif t.dtype == torch.bfloat16:
                t = t.view(torch.int16)
        leaves.append(np.asarray(t, np.float64) if as_float64
                      else np.asarray(t))
    return leaves


def check_deterministic(fn: Callable, *args, runs: int = 2) -> bool:
    """True iff repeated executions produce bitwise-identical outputs."""
    ref = _host_leaves(fn(*args))
    for _ in range(runs - 1):
        out = _host_leaves(fn(*args))
        if len(out) != len(ref):
            return False
        for a, b in zip(ref, out):
            if a.dtype != b.dtype or a.shape != b.shape or \
                    a.tobytes() != b.tobytes():
                return False
    return True


def golden_compare(fn: Callable, *args,
                   production_dtype: torch.dtype = torch.float32) -> float:
    """Max relative deviation between ``fn`` run in float64 (golden) and
    in ``production_dtype``: every floating tensor among ``args`` is cast
    to each in turn; ``fn`` must follow its inputs' dtype."""
    def cast(tree, dtype):
        return tree_map(lambda x: x.to(dtype)
                        if isinstance(x, torch.Tensor)
                        and x.is_floating_point() else x, tree)

    golden = _host_leaves(fn(*cast(args, torch.float64)), as_float64=True)
    prod = _host_leaves(fn(*cast(args, production_dtype)), as_float64=True)
    worst = 0.0
    for a, b in zip(golden, prod):
        denom = np.maximum(np.abs(a), 1e-30)
        worst = max(worst, float(np.max(np.abs(a - b) / denom)))
    return worst
