"""Topology optimization: SIMP compliance minimization on rectangle meshes.

PyTorch counterpart of ``difffe_tpu/control/topopt.py``.  Thermal
compliance on ``FEMesh.rectangle``: distribute material density ρ ∈ [0, 1]
per quad to minimize C(ρ) = FᵀU with K(κ(ρ))U = F under the volume
constraint mean(ρ) = v̄.

* densities live on the (ny, nx) quad grid, scenarios on leading axes;
  both triangles of a quad share one density (``quads_to_tris``, in
  ``FEMesh.rectangle``'s interleaved element order);
* SIMP interpolation κ = κ_min + ρᵖ(κ₀ − κ_min);
* the density filter is ``torch.nn.functional.conv2d`` with a normalized
  cone kernel and edge renormalization (a cross-correlation, as JAX's
  ``conv_general_dilated``);
* sensitivities dC/dρ through the facade's adjoint solve: the state solve
  is ``solve_poisson_batched`` with ``cfg.method`` and ``cfg.cg_maxiter``
  (on a rectangle the tol-gated stencil CG with per-scenario dots; the JAX
  package ``vmap``s one solve per scenario, whose converged scenarios stop
  while here they keep iterating on a frozen residual);
* the optimality-criteria update bisects the volume multiplier.  JAX runs
  a ``lax.while_loop``; its trip count does not depend on the data, since
  each bisection step replaces lo or hi by √(lo·hi) and so halves
  log(hi/lo) whichever branch it takes.  ``oc_bisection_steps`` counts the
  steps on the host from (1e-9, 1e9) (25 in float32 and float64), the
  device runs that many masked steps (a scenario whose interval has closed
  stops moving, as under JAX's ``vmap``), and one host check at the end of
  a call or loop asserts that every interval closed.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F_

from ..mesh import FEMesh
from ..ops.assembly import assemble_load
from ..solver import solve_poisson_batched

_LAM_LO, _LAM_HI = 1e-9, 1e9
_BISECT_TOL = 1e-6


@dataclasses.dataclass(frozen=True)
class TopOptConfig:
    nx: int = 32
    ny: int = 32
    vol_frac: float = 0.4
    penal: float = 3.0           # SIMP exponent p
    kappa_min: float = 1e-3
    kappa0: float = 1.0
    filter_radius: float = 1.5   # in units of quad size
    move: float = 0.2            # OC move limit
    n_iters: int = 50
    method: str = "auto"         # solver method for the state solves
    cg_maxiter: Optional[int] = None


def cone_filter_kernel(radius: float, dtype=None,
                       device=None) -> torch.Tensor:
    """Normalized cone (linear hat) kernel of the given radius in quads,
    (2⌊r⌋+1, 2⌊r⌋+1)."""
    r = int(math.floor(radius))
    ij = torch.arange(-r, r + 1, dtype=dtype, device=device)
    dist = torch.sqrt(ij[:, None] ** 2 + ij[None, :] ** 2)
    w = (radius - dist).clamp_min(0.0)
    return w / w.sum()


def density_filter(rho_grid: torch.Tensor,
                   kernel: torch.Tensor) -> torch.Tensor:
    """Filter densities (..., ny, nx) on the grid (edge-renormalized
    convolution), in the input's dtype."""
    lead, (ny, nx) = rho_grid.shape[:-2], rho_grid.shape[-2:]
    x = rho_grid.reshape((-1, 1, ny, nx))
    k = kernel.to(rho_grid.dtype)[None, None]
    pad = (kernel.shape[0] // 2, kernel.shape[1] // 2)
    num = F_.conv2d(x, k, padding=pad)
    den = F_.conv2d(torch.ones_like(x[:1]), k, padding=pad)
    return (num / den).reshape(lead + (ny, nx)).to(rho_grid.dtype)


def simp_kappa(rho_tri: torch.Tensor, cfg: TopOptConfig) -> torch.Tensor:
    return cfg.kappa_min + rho_tri ** cfg.penal * (cfg.kappa0 - cfg.kappa_min)


def quads_to_tris(rho_grid: torch.Tensor) -> torch.Tensor:
    """(..., ny, nx) quad densities → (..., 2·ny·nx) per-triangle values in
    ``FEMesh.rectangle``'s interleaved [lower_0, upper_0, lower_1, …]
    element order."""
    return rho_grid.flatten(-2).repeat_interleave(2, dim=-1)


def compliance(mesh: FEMesh, rho_grid: torch.Tensor, f: torch.Tensor,
               cfg: TopOptConfig, kernel: torch.Tensor) -> torch.Tensor:
    """C(ρ) = FᵀU after filtering and SIMP, differentiable through the
    solver's adjoint: ρ (ny, nx) and f (n,) give a scalar; scenario axes
    on ρ (…, ny, nx) or f (…, n) give one compliance a scenario."""
    f = torch.as_tensor(f, dtype=mesh.dtype, device=mesh.device)
    kappa_e = simp_kappa(quads_to_tris(density_filter(rho_grid, kernel)),
                         cfg)
    # unbatched κ and f take solve_poisson's route, as in JAX
    u = solve_poisson_batched(mesh, kappa_e, f, method=cfg.method,
                              kappa_batched=kappa_e.ndim > 1,
                              cg_maxiter=cfg.cg_maxiter)
    return (assemble_load(mesh, f) * u).sum(-1)


@functools.lru_cache(maxsize=None)
def oc_bisection_steps(dtype: torch.dtype) -> int:
    """The trip count of the OC bisection in ``dtype``: the JAX
    ``while_loop``'s steps from (1e-9, 1e9) until (hi − lo)/(hi + lo) ≤
    1e-6, counted on the host in the same arithmetic (module note)."""
    np_dtype = {torch.float32: np.float32, torch.float64: np.float64}[dtype]
    lo, hi = np_dtype(_LAM_LO), np_dtype(_LAM_HI)
    steps = 0
    while (hi - lo) / (hi + lo) > np_dtype(_BISECT_TOL):
        lo = np.sqrt(lo * hi)
        steps += 1
    return steps


def _oc_update(rho: torch.Tensor, dc: torch.Tensor, cfg: TopOptConfig):
    """The OC step on ρ (..., ny, nx) with its per-scenario multipliers;
    returns (new ρ, a device flag true where a bisection interval is still
    open after ``oc_bisection_steps``)."""
    dc_neg = dc.clamp_max(-1e-12)
    lead = rho.shape[:-2]
    lo = torch.full(lead + (1, 1), _LAM_LO, dtype=rho.dtype,
                    device=rho.device)
    hi = torch.full_like(lo, _LAM_HI)

    def candidate(lam):
        r = rho * torch.sqrt(-dc_neg / lam)
        r = torch.minimum(torch.maximum(r, rho - cfg.move), rho + cfg.move)
        return r.clamp(0.0, 1.0)

    def is_open(lo, hi):
        return (hi - lo) / (hi + lo) > _BISECT_TOL

    for _ in range(oc_bisection_steps(rho.dtype)):
        live = is_open(lo, hi)
        mid = torch.sqrt(lo * hi)          # geometric bisection
        # more material than allowed → raise λ
        too_much = candidate(mid).mean((-2, -1), keepdim=True) > cfg.vol_frac
        lo = torch.where(live & too_much, mid, lo)
        hi = torch.where(live & ~too_much, mid, hi)
    return candidate(torch.sqrt(lo * hi)), is_open(lo, hi).any()


def _assert_closed(still_open: torch.Tensor) -> None:
    if bool(still_open):
        raise RuntimeError(
            "the OC bisection did not close its interval in "
            "oc_bisection_steps() steps; its trip count was meant to be "
            "independent of the data")


def oc_update(rho: torch.Tensor, dc: torch.Tensor,
              cfg: TopOptConfig) -> torch.Tensor:
    """Optimality-criteria step with bisection on the volume multiplier,
    one multiplier a scenario for ρ, dc (..., ny, nx).  dc ≤ 0 in
    well-posed compliance problems; clipped for robustness."""
    rho_new, still_open = _oc_update(rho, dc, cfg)
    _assert_closed(still_open)
    return rho_new


def _optimize(mesh: FEMesh, f: torch.Tensor, cfg: TopOptConfig,
              rho0: Optional[torch.Tensor]):
    f = torch.as_tensor(f, dtype=mesh.dtype, device=mesh.device)
    shape = f.shape[:-1] + (cfg.ny, cfg.nx)
    if rho0 is None:
        rho = torch.full(shape, cfg.vol_frac, dtype=mesh.dtype,
                         device=mesh.device)
    else:
        rho = torch.as_tensor(rho0, dtype=mesh.dtype,
                              device=mesh.device).expand(shape)
    kernel = cone_filter_kernel(cfg.filter_radius, mesh.dtype, mesh.device)
    hist, still_open = [], []
    for _ in range(cfg.n_iters):
        r = rho.detach().requires_grad_(True)
        c = compliance(mesh, r, f, cfg, kernel)
        (dc,) = torch.autograd.grad(c.sum(), r)
        rho, left = _oc_update(rho, dc, cfg)
        hist.append(c.detach())
        still_open.append(left)
    if still_open:
        _assert_closed(torch.stack(still_open).any())
    return rho, torch.stack(hist, dim=-1)


def optimize(mesh: FEMesh, f: torch.Tensor, cfg: TopOptConfig,
             rho0: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run cfg.n_iters OC iterations for one forcing f (n,); returns
    (ρ grid (ny, nx), compliance history (n_iters,)).  Each iteration is a
    state solve, its adjoint, the filter chain's VJP and the OC
    bisection."""
    return _optimize(mesh, f, cfg, rho0)


def optimize_batched(mesh: FEMesh, f_batch: torch.Tensor, cfg: TopOptConfig,
                     rho0: Optional[torch.Tensor] = None):
    """Scenario-batched topology optimization: f_batch (B, n_nodes) →
    (ρ (B, ny, nx), compliance histories (B, n_iters)), the B state solves
    of an iteration as one batched solve."""
    f_batch = torch.as_tensor(f_batch, dtype=mesh.dtype, device=mesh.device)
    if f_batch.ndim != 2:
        raise ValueError(f"f_batch must be (B, n_nodes), got shape "
                         f"{tuple(f_batch.shape)}")
    return _optimize(mesh, f_batch, cfg, rho0)
