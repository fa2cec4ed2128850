"""Solve −∇·(κ∇u) = f with Dirichlet BCs: the 1D facade.

PyTorch counterpart of the 1D subset of ``difffe_tpu/solver.py``:
``solve_poisson`` and ``solve_poisson_batched`` with the JAX package's
κ-batching rules, routed to the PCR tridiagonal solver
(ops/tridiag.py).  Every route not ported yet raises
``NotImplementedError`` naming the slice that ports it.
"""

from __future__ import annotations

from typing import Optional

import torch

from .mesh import FEMesh
from .ops import tridiag as _tridiag
from .ops.assembly import assemble_load, assemble_tridiag_1d, element_family

_UNPORTED_METHODS = {
    "tridiag_pallas": "method='tridiag_pallas' needs the PCR kernel K2, "
                      "not ported yet (K2, slice B)",
    "dense": "method='dense' is not ported yet (slice B: ops/solve.py)",
    "lu": "method='lu' is not ported yet (slice B: ops/solve.py)",
    "cg": "method='cg' is not ported yet (slice C: ops/cg.py)",
    "stencil": "method='stencil' is not ported yet (slices C/D: "
               "ops/stencil.py, ops/stencil3d.py)",
}


def _resolve_method(mesh: FEMesh, method: str) -> str:
    if method != "auto":
        return method
    element_family(mesh)    # raises for every family not ported yet
    return "tridiag"


def _require_ported(mesh: FEMesh, method: str, kw: dict):
    for name in ("neumann", "robin"):
        if kw.get(name) is not None:
            raise NotImplementedError(
                f"{name}= boundary terms are not ported yet (slice B: "
                f"ops/{name}.py)")
    extra = set(kw) - {"neumann", "robin", "cg_tol", "cg_maxiter"}
    if extra:
        raise TypeError(f"unexpected keyword arguments {sorted(extra)}")
    if method in _UNPORTED_METHODS:
        raise NotImplementedError(_UNPORTED_METHODS[method])
    if method != "tridiag":
        raise ValueError(f"Unknown method {method!r}")
    if mesh.dim != 1:
        raise ValueError(f"method={method!r} requires a 1D mesh")
    if mesh.n_dirichlet == 0:
        raise ValueError(
            "mesh has no Dirichlet nodes: the Poisson system is singular "
            "(constant nullspace). Pin at least one node "
            "(FEMesh.with_dirichlet).")


def solve_poisson(mesh: FEMesh, kappa, f, method: str = "auto",
                  cg_tol: Optional[float] = None,
                  cg_maxiter: Optional[int] = None, bc_values=None,
                  neumann=None, robin=None) -> torch.Tensor:
    """Solve −∇·(κ∇u) = f on ``mesh`` with its Dirichlet BCs.

    kappa : scalar, (n_elements,) or (n_nodes,) diffusion coefficient.
    f : (n_nodes,) nodal forcing values.
    method : 'auto' | 'tridiag' (ported); 'tridiag_pallas', 'dense', 'lu',
        'cg' and 'stencil' raise NotImplementedError.
    bc_values : optional (n_nodes,) override of the Dirichlet values.
    ``cg_tol``/``cg_maxiter`` are read by the unported CG routes only.

    Returns u (n_nodes,), differentiable wrt kappa, f and bc_values.
    """
    f = torch.as_tensor(f, dtype=mesh.dtype, device=mesh.device)
    method = _resolve_method(mesh, method)
    _require_ported(mesh, method, dict(neumann=neumann, robin=robin))
    d, e = assemble_tridiag_1d(mesh, kappa)
    F = assemble_load(mesh, f)
    return _tridiag.solve_poisson_tridiag(mesh, d, e, F,
                                          bc_values=bc_values)


def solve_poisson_batched(mesh: FEMesh, kappa, f, method: str = "auto",
                          bc_values=None,
                          kappa_batched: Optional[bool] = None,
                          **kw) -> torch.Tensor:
    """Batched scenarios: κ (B, …), f (B, n_nodes) and/or Dirichlet values
    ``bc_values`` (B, n_nodes) → u (B, n_nodes).

    Any argument may be unbatched (broadcast across the batch).  A 1-D κ
    of length B is a batch of per-scenario scalars; of length
    n_elements/n_nodes it is one shared field.  When B equals n_elements
    or n_nodes the two readings collide and the call raises: pass
    ``kappa_batched=True/False``.
    """
    dt, dev = mesh.dtype, mesh.device
    kappa = torch.as_tensor(kappa, dtype=dt, device=dev)
    f = torch.as_tensor(f, dtype=dt, device=dev)
    if bc_values is not None:
        bc_values = torch.as_tensor(bc_values, dtype=dt, device=dev)
    f_batched = f.ndim >= 2
    g_batched = bc_values is not None and bc_values.ndim >= 2

    k_core = tuple(kappa.shape)
    if kappa_batched is not None:
        k_batched = kappa_batched and len(k_core) >= 1
    elif len(k_core) == 2:
        k_batched = True
    elif len(k_core) == 1:
        L = k_core[0]
        looks_field = L in (mesh.n_elements, mesh.n_nodes)
        batch_sizes = ({f.shape[0]} if f_batched else set()) | (
            {bc_values.shape[0]} if g_batched else set())
        looks_batch = (not batch_sizes and not looks_field) or \
            (L in batch_sizes)
        if looks_field and looks_batch:
            raise ValueError(
                f"ambiguous kappa lead dim of length {L}: could be a shared "
                f"per-element/per-node field or B={L} per-scenario values "
                f"— pass kappa_batched=True (batch) or False (field)")
        k_batched = looks_batch and not looks_field
    else:
        k_batched = False

    if not (k_batched or f_batched or g_batched):
        return solve_poisson(mesh, kappa, f, method=method,
                             bc_values=bc_values, **kw)

    method = _resolve_method(mesh, method)
    _require_ported(mesh, method, kw)
    if k_batched and kappa.ndim == 1:
        # (B,) scalar-per-scenario → (B, n_elements)
        kappa = kappa[:, None].expand(kappa.shape[0], mesh.n_elements)
    d, e = assemble_tridiag_1d(mesh, kappa)
    F = assemble_load(mesh, f)
    lead = torch.broadcast_shapes(
        d.shape[:-1], F.shape[:-1],
        bc_values.shape[:-1] if g_batched else ())
    F = F.expand(lead + F.shape[-1:])
    d = d.expand(lead + d.shape[-1:])
    e = e.expand(lead + e.shape[-1:])
    return _tridiag.solve_poisson_tridiag(mesh, d, e, F,
                                          bc_values=bc_values)
