"""Faults planted under the timed path, for showing that ``correct`` comes
out false: the CPU tests plant them at tiny sizes, ``control.py
--faults`` at the cell's own size on the card.

Each fault takes a ``setattr(obj, name, value)`` (pytest's monkeypatch, or
``Patch`` below) and replaces functions of the program's modules:

* ``unchanged``: each CG kernel returns the state it started from;
* ``half_batch``: the step sees the first half of the batch and takes its
  mean over that half; the solve leaves the second half at its start;
* ``altered``: each CG kernel hands scenario 1's solution out as
  scenario 0's.

The fourth fault, an exchange between chips left out, has no place in
these cells: each runs on one chip.
"""

from __future__ import annotations

import importlib

import torch

SK = "difffe_tpu_torch.ops.kernels.stencil_cg_kernel"
S3 = "difffe_tpu_torch.ops.kernels.stencil3d_cg_kernel"
# on CPU tensors a batched box solve takes the plain per-scenario solve
# (on the card K4a): the faults break both
P3 = "difffe_tpu_torch.ops.stencil3d"
BOX = "solve_poisson_structured_3d_batched"


class Patch:
    """``setattr`` that remembers, and ``undo`` that restores."""

    def __init__(self):
        self.saved = []

    def setattr(self, obj, name, value):
        self.saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self):
        while self.saved:
            obj, name, value = self.saved.pop()
            setattr(obj, name, value)


def _modules():
    return tuple(map(importlib.import_module, (SK, S3, P3)))


def unchanged(patch):
    sk, s3, p3 = _modules()
    for mod, one, two in ((sk, "_cg", "_cg2"), (s3, "_cg3", "_cg3_2")):
        patch.setattr(mod, one, lambda D, b, Minv, x0, iters,
                      block_b=1: x0.clone())
        patch.setattr(mod, two, lambda D, b, Minv, x0, lam0, ud,
                      scale, iters, block_b=1: (x0.clone(), lam0.clone()))
    patch.setattr(p3, BOX, lambda grid, k, f, g, tol, maxiter:
                  torch.zeros_like(f) + g)


def half_batch(patch):
    sk, s3, p3 = _modules()

    def solve(real):
        def f(D, b, Minv, x0, iters, block_b=1):
            h = b.shape[0] // 2
            x = real(D[:, :h].contiguous(), b[:h].contiguous(),
                     Minv[:h].contiguous(), x0[:h].contiguous(), iters)
            return torch.cat([x, x0[h:]])
        return f

    def step(real, planes):
        def f(grid, kappa, fg, g, ud, scale=None, iters=16, block_b=1,
              warm_state=None, return_state=False, **kw):
            h = fg.shape[0] // 2

            def cut(t):
                return t[:h].contiguous()

            k = tuple(map(cut, kappa)) if planes else cut(kappa)
            ws = None if warm_state is None else tuple(map(cut, warm_state))
            lp, gk, u, st = real(grid, k, cut(fg), g, cut(ud), scale=scale,
                                 iters=iters, block_b=block_b,
                                 warm_state=ws, return_state=True, **kw)

            def pad(t, like):
                return torch.cat([t, torch.zeros_like(like[h:])])

            gk = (tuple(pad(a, b) for a, b in zip(gk, kappa)) if planes
                  else pad(gk, kappa))
            out = (lp, gk, pad(u, fg))
            return out + (tuple(pad(s, fg) for s in st),) if return_state \
                else out
        return f

    def box(real):
        def f(grid, k, fB, g, tol, maxiter):
            h = fB.shape[0] // 2
            u = real(grid, k[:h], fB[:h], g, tol, maxiter)
            return torch.cat([u, torch.zeros_like(fB[h:]) + g])
        return f

    patch.setattr(sk, "_cg", solve(sk._cg))
    patch.setattr(s3, "_cg3", solve(s3._cg3))
    patch.setattr(p3, BOX, box(getattr(p3, BOX)))
    patch.setattr(sk, "fused_kappa_mse_step_2d",
                  step(sk.fused_kappa_mse_step_2d, True))
    patch.setattr(s3, "fused_kappa_mse_step_3d_kernel",
                  step(s3.fused_kappa_mse_step_3d_kernel, False))


def altered(patch):
    sk, s3, p3 = _modules()

    def one(real):
        def f(*a, **kw):
            x = real(*a, **kw).clone()
            x[0] = x[1]
            return x
        return f

    def two(real):
        def f(*a, **kw):
            x, lam = real(*a, **kw)
            x = x.clone()
            x[0] = x[1]
            return x, lam
        return f

    patch.setattr(sk, "_cg", one(sk._cg))
    patch.setattr(s3, "_cg3", one(s3._cg3))
    patch.setattr(p3, BOX, one(getattr(p3, BOX)))
    patch.setattr(sk, "_cg2", two(sk._cg2))
    patch.setattr(s3, "_cg3_2", two(s3._cg3_2))


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "altered": altered}
