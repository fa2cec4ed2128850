"""The one preconditioned-CG body the port's torch solve paths share.

PyTorch counterpart of ``difffe_tpu/ops/pcg.py``.  The CUDA whole-CG
kernels (ops/kernels/stencil_cg_kernel.py) keep their own loop on the
chip; this module is the plain-tensor form.

Parameterized over:

* ``A``     — the SPD operator, ``v ↦ A·v`` (matrix-free);
* ``Minv``  — preconditioner apply, ``r ↦ z``;
* ``dot``   — inner product.  The default is one global dot (couples a
  scenario batch into one block-diagonal CG, the behaviour of the JAX
  structured path); :func:`batched_dot` gives independent per-scenario
  α/β, which is what the whole-CG kernels do.

Modes: ``tol=0`` runs exactly ``maxiter`` iterations and never waits for
the device.  ``tol>0`` is gated: before every iteration the loop reads
one boolean (``bool(tensor)``), so it synchronizes with the device once
per iteration.  ``torch.export`` cannot trace that read, so each caller
that runs the loop tol-gated does so inside a ``torch.library`` op of its
own (ops/stencil.py, ops/stencil3d.py, ops/stencil_natural.py, ops/cg.py,
ops/kernels/ell_kernel.py): an exported program holds the loop as one
node and runs it, with the live route's iterations, when it is called.
Each such solve appends its iteration count to :data:`gated_iters`.
"""

from __future__ import annotations

import collections
from typing import Callable, Optional

import torch

#: Test hook: CG iterations of the latest tol-gated solves run by the ops
#: above, newest last (live or in an exported program's replay; a forward
#: solve and its adjoint append one each).  One deque for the process, so
#: solves run concurrently interleave their counts.
gated_iters = collections.deque(maxlen=64)


def batched_dot(ndim: int = 2):
    """Per-scenario inner product over the trailing ``ndim`` axes, keepdims —
    so α/β broadcast back against (..., H, W)-shaped CG state."""
    dims = tuple(range(-ndim, 0))

    def dot(u, v):
        return (u * v).sum(dim=dims, keepdim=True)

    dot.scope_ndim = ndim      # names it to the gated ops' schemas
    return dot


def first_order_only(name: str) -> None:
    """Raise inside a backward that autograd is recording (create_graph):
    an IFT backward whose adjoint solve runs this loop gives first
    derivatives only, as the JAX package's custom VJPs do, and a graph
    that skipped λ's dependence on the inputs would give wrong second
    derivatives without a word."""
    if torch.is_grad_enabled():
        raise NotImplementedError(f"{name} is differentiable once: its "
                                  f"backward takes no create_graph")


def _global_dot(u, v):
    return (u * v).sum()


def _safe_div(num, den):
    """num/den with 0/0 → 0: past convergence (tol=0 fixed-trip mode) both
    rz and pAp hit exact zero and a plain division would poison the batch
    with NaNs."""
    nz = den != 0
    return torch.where(nz, num / torch.where(nz, den, torch.ones_like(den)),
                       torch.zeros_like(num))


def pcg(A: Callable, b: torch.Tensor, Minv: Callable, x0: torch.Tensor,
        tol: float, maxiter: int,
        dot: Optional[Callable] = None,
        with_diagnostics: bool = False,
        stagnation_floor: Optional[float] = None):
    """Preconditioned conjugate gradients for SPD ``A``.

    ``tol`` is relative to ‖b‖ (per dot scope); ``tol=0`` runs exactly
    ``maxiter`` iterations.  Returns ``x``, or ``(x, iters, r)`` when
    ``with_diagnostics`` (``iters`` a Python int).  Never differentiate
    through this loop: every caller wraps it in an IFT backward.

    Noise-floor freeze: once a scenario's rz falls below
    ``stagnation_floor``·rz₀ (default (4ε)² of b's dtype) it is frozen —
    α = 0 (x, r stop moving) and β = 0 (p resets to z) — because fixed-trip
    CG far past convergence can diverge on rounding noise.  Pass 0.0 to
    opt out.  In tol-gated mode the loop also exits once every scenario is
    frozen.
    """
    dot = dot or _global_dot
    r = b - A(x0)
    z = Minv(r)
    p = z
    rz = dot(r, z)
    bnorm2 = dot(b, b)
    tol2 = tol ** 2 * bnorm2.clamp_min(1e-30)
    if stagnation_floor is None:
        eps = torch.finfo(b.dtype).eps
        stagnation_floor = (4.0 * eps) ** 2
    floor = stagnation_floor * rz.clamp_min(1e-30)

    x = x0
    k = 0
    while k < maxiter:
        if tol > 0.0 and not bool(((dot(r, r) > tol2).any()
                                   & (rz > floor).any())):
            break
        live = rz > floor
        Ap = A(p)
        alpha = torch.where(live, _safe_div(rz, dot(p, Ap)),
                            torch.zeros_like(rz))
        x = x + alpha * p
        r = r - alpha * Ap
        z = Minv(r)
        rz_new = dot(r, z)
        beta = torch.where(live & (rz_new > floor), _safe_div(rz_new, rz),
                           torch.zeros_like(rz))
        p = z + beta * p
        rz = rz_new
        k += 1
    if with_diagnostics:
        return x, k, r
    return x


def dot_of(ndim: int):
    """The dot a gated op's ``dot_ndim`` names: 0 the global dot, n > 0
    :func:`batched_dot` (n)."""
    return batched_dot(ndim) if ndim else None


def dot_ndim(dot: Optional[Callable]) -> int:
    """The inverse of :func:`dot_of`."""
    return 0 if dot is None else dot.scope_ndim
