"""Solve −∇·(κ∇u) = f with Dirichlet BCs: the differentiable facade.

PyTorch counterpart of the ported subset of ``difffe_tpu/solver.py``:
``solve_poisson``, ``solve_poisson_batched`` with the JAX package's
κ-batching rules, and the ``DifferentiableFESolver`` wrapper, routed to

* on 1D line meshes, the PCR tridiagonal solver (ops/tridiag.py), as
  elementwise sweeps (``method="tridiag"``) or on kernel K2
  (``method="tridiag_pallas"``, ops/kernels/tridiag_kernel.py), with
  point Neumann loads and point Robin terms;
* on any mesh, the dense Cholesky / LU solves of ops/solve.py over the
  generic assembly (``method="dense"`` / ``"lu"``) and the matrix-free
  Jacobi-PCG of ops/cg.py (``method="cg"``), with scalar, field or tensor
  κ, edge Neumann loads and edge Robin terms; ``method="auto"`` picks
  dense up to 4096 nodes and cg above on meshes without a grid;
* the structured stencil solver (ops/stencil.py) on ``FEMesh.rectangle``
  meshes with their factory Dirichlet boundary, and for fixed-trip batched
  solves (``cg_tol=0``, ``cg_maxiter ≤ 256``) the whole-CG kernel K3a
  (ops/kernels/stencil_cg_kernel.py), forward and adjoint;
* the 3D structured stencil solver (ops/stencil3d.py) on ``FEMesh.box``
  meshes with their factory Dirichlet boundary, and for fixed-trip batched
  solves on the card (``cg_tol=0``, an explicit ``cg_maxiter``) the
  whole-CG kernel K4a (ops/kernels/stencil3d_cg_kernel.py), forward and
  adjoint.

Natural BCs and non-factory Dirichlet masks on rectangle meshes (the
generalized-mask stencil solver) raise ``NotImplementedError`` naming the
slice that ports them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from .mesh import FEMesh
from .ops import cg as _cg
from .ops import tridiag as _tridiag
from .ops.assembly import (assemble_load, assemble_stiffness_dense,
                           assemble_tridiag_1d, element_family,
                           is_tensor_kappa, kappa_on_elements)
from .ops.solve import solve_dense

_NATURAL_2D = ("Neumann/Robin terms and non-factory Dirichlet masks on "
               "rectangle meshes take the generalized-mask stencil solver, "
               "not ported yet (slice C item 14: ops/stencil_natural.py)")
_NATURAL_3D = ("the 3D structured stencil path supports the factory "
               "Dirichlet boundary only (no Neumann/Robin); use "
               "method='cg' or 'dense'")


def _resolve_method(mesh: FEMesh, method: str, kappa=None,
                    structured_ok: bool = True) -> str:
    if method != "auto":
        return method
    if element_family(mesh) == "p1_line":
        return "tridiag"
    # structured rectangle meshes carry their grid metadata: route to the
    # closed-form stencil operators when κ is isotropic
    if (structured_ok and mesh.grid is not None
            and (kappa is None or not is_tensor_kappa(mesh, kappa))):
        return "stencil"
    return "dense" if mesh.n_nodes <= 4096 else "cg"


def _cg_policy(mesh: FEMesh, cg_tol, cg_maxiter):
    """Default iteration policy for the public CG surface: unspecified
    ``cg_tol`` converges to 1e-6 (f32) / 1e-12 (f64) relative residual
    with a cap of ≈10·√n iterations; ``cg_tol=0.0`` with an explicit
    ``cg_maxiter`` is the fixed-trip mode."""
    if cg_tol is None:
        cg_tol = 1e-12 if mesh.dtype == torch.float64 else 1e-6
    if cg_maxiter is None and cg_tol > 0.0:
        n = mesh.n_nodes
        cg_maxiter = min(n, max(64, 10 * math.isqrt(n)))
    return cg_tol, cg_maxiter


def _mask_is_factory(mesh: FEMesh) -> bool:
    """True when the mesh's Dirichlet set is the factory full boundary of
    its grid (the assumption of the structured stencil solvers).  One
    device-to-host copy of the mask."""
    mask = mesh.bc_mask.detach().cpu().numpy() > 0.5
    shape = mesh.grid.node_shape
    factory = np.zeros(shape, bool)
    for ax in range(len(shape)):
        lo = [slice(None)] * len(shape)
        lo[ax] = 0
        hi = [slice(None)] * len(shape)
        hi[ax] = -1
        factory[tuple(lo)] = True
        factory[tuple(hi)] = True
    return bool((mask.reshape(shape) == factory).all())


def _solve_stencil(mesh: FEMesh, kappa, f: torch.Tensor, cg_tol: float,
                   cg_maxiter: Optional[int], neumann=None, robin=None,
                   bc_values=None, dot=None) -> torch.Tensor:
    """Route onto the closed-form structured stencil solver.

    κ in any facade form (scalar / per-element / per-node, leading batch
    axes allowed) becomes per-triangle fields by the generic assembly's
    rules; flat node vectors reshape to the node grid and back.  All of it
    is differentiable.  ``dot`` is the CG inner product
    (``pcg.batched_dot(2)`` for independent scenarios)."""
    from .ops.stencil import kappa_lu_from_elements, solve_poisson_structured
    from .ops.stencil3d import solve_poisson_structured_3d

    _require_factory_dirichlet(mesh, neumann is not None or robin is not None)
    grid = mesh.grid
    shape = grid.node_shape
    ke = kappa_on_elements(mesh, kappa)
    g = mesh.bc_values if bc_values is None else bc_values
    g = g.reshape(g.shape[:-1] + shape)
    fg = f.reshape(f.shape[:-1] + shape)
    if mesh.dim == 3:
        u = solve_poisson_structured_3d(grid, ke, fg, g, cg_tol, cg_maxiter,
                                        dot)
    else:
        u = solve_poisson_structured(grid, kappa_lu_from_elements(grid, ke),
                                     fg, g, cg_tol, cg_maxiter, dot)
    return u.reshape(u.shape[:-len(shape)] + (mesh.n_nodes,))


def _require_factory_dirichlet(mesh: FEMesh, natural: bool):
    """The structured solvers take the factory Dirichlet boundary only: 3D
    refuses anything else as the JAX package does; 2D's generalized-mask
    solver is not ported yet."""
    if natural or not _mask_is_factory(mesh):
        if mesh.dim == 3:
            raise ValueError(_NATURAL_3D)
        raise NotImplementedError(_NATURAL_2D)


def _check_kw(kw: dict):
    extra = set(kw) - {"neumann", "robin", "cg_tol", "cg_maxiter"}
    if extra:
        raise TypeError(f"unexpected keyword arguments {sorted(extra)}")


def _natural_1d(mesh: FEMesh, d, F, neumann, robin):
    """Add point Neumann loads and a diagonal-only Robin term to 1D bands
    (d, F); ``robin_diag``/``load`` keep any per-scenario lead dims."""
    if neumann is not None:
        F = F + torch.as_tensor(neumann, dtype=mesh.dtype, device=mesh.device)
    if robin is not None:
        if not robin.diagonal_only:
            raise ValueError("tridiagonal path supports diagonal-only Robin "
                             "terms (1D point Robin); use method='dense' "
                             "for edge Robin")
        from .ops.robin import robin_diag
        d = d + robin_diag(mesh, robin)
        F = F + robin.load
    return d, F


def _dense_route(mesh: FEMesh, method, kappa, f, bc_values, neumann, robin):
    """The dense routes: 'dense' (Cholesky) and 'lu', one factorization
    per scenario, batched over the leading axes."""
    K = assemble_stiffness_dense(mesh, kappa)
    F = assemble_load(mesh, f)
    if neumann is not None:
        F = F + torch.as_tensor(neumann, dtype=mesh.dtype, device=mesh.device)
    if robin is not None:
        from .ops.robin import robin_matrix_dense
        K = K + robin_matrix_dense(mesh, robin)
        F = F + robin.load
    return solve_dense(mesh, K, F,
                       factor="cholesky" if method == "dense" else "lu",
                       bc_values=bc_values)


def _cg_route(mesh: FEMesh, kappa, f, cg_tol, cg_maxiter, bc_values,
              neumann, robin):
    """The matrix-free PCG route, batched over the leading axes of κ, f,
    the Dirichlet values and the Neumann/Robin terms (per-scenario dots:
    the scenarios are independent solves)."""
    F = assemble_load(mesh, f)
    if neumann is not None:
        F = F + torch.as_tensor(neumann, dtype=mesh.dtype, device=mesh.device)
    if bc_values is not None:
        mesh = dataclasses.replace(mesh, bc_values=bc_values)
    if robin is not None:
        return _cg.solve_poisson_cg_robin(mesh, kappa, F, robin, cg_tol,
                                          cg_maxiter)
    return _cg.solve_poisson_cg(mesh, kappa, F, cg_tol, cg_maxiter)


def _tridiag_route(mesh: FEMesh, method, kappa, f, bc_values, neumann,
                   robin, batched: bool):
    """The 1D band routes: 'tridiag' (elementwise PCR) and
    'tridiag_pallas' (kernel K2)."""
    if mesh.dim != 1:
        raise ValueError(f"method={method!r} requires a 1D mesh")
    d, e = assemble_tridiag_1d(mesh, kappa)
    d, F = _natural_1d(mesh, d, assemble_load(mesh, f), neumann, robin)
    if batched:
        lead = torch.broadcast_shapes(
            d.shape[:-1], F.shape[:-1],
            bc_values.shape[:-1] if bc_values is not None else ())
        F = F.expand(lead + F.shape[-1:])
        d = d.expand(lead + d.shape[-1:])
        e = e.expand(lead + e.shape[-1:])
    backend = "pallas" if method == "tridiag_pallas" else "xla"
    return _tridiag.solve_poisson_tridiag(mesh, d, e, F, backend=backend,
                                          bc_values=bc_values)


def _require_stencil(mesh: FEMesh):
    if mesh.grid is None:
        raise ValueError(
            "method='stencil' requires structured-grid metadata (a mesh "
            "built by FEMesh.rectangle or FEMesh.box whose Dirichlet set is "
            "the factory boundary); general meshes take method='cg' or "
            "'dense'")


def solve_poisson(mesh: FEMesh, kappa, f, method: str = "auto",
                  cg_tol: Optional[float] = None,
                  cg_maxiter: Optional[int] = None, bc_values=None,
                  neumann=None, robin=None) -> torch.Tensor:
    """Solve −∇·(κ∇u) = f on ``mesh`` with its Dirichlet BCs.

    kappa : scalar, (n_elements,) or (n_nodes,) diffusion coefficient; on
        2D/3D P1 meshes also a diffusion tensor (d, d), (n_elements, d, d)
        or (n_nodes, d, d) for the 'dense'/'lu'/'cg' routes ('auto' sends
        it there).
    f : (n_nodes,) nodal forcing values.
    method : 'auto' | 'tridiag' | 'tridiag_pallas' (1D) | 'dense' | 'lu' |
        'cg' | 'stencil' (rectangle and box meshes).  'auto' takes tridiag
        on 1D chains, the stencil solvers on rectangle/box meshes (isotropic
        κ), dense up to 4096 nodes and cg above otherwise.
    cg_tol, cg_maxiter : the CG policy of the 'cg' and stencil routes
        (``_cg_policy``).
    bc_values : optional (n_nodes,) override of the Dirichlet values.
    neumann : optional (n_nodes,) natural-BC load (ops/neumann.py), added
        to F before Dirichlet elimination.
    robin : optional ops/robin.RobinBC (1D point Robin: every 1D route;
        edge Robin: 'dense', 'lu', 'cg').

    Returns u (n_nodes,), differentiable wrt kappa, f and bc_values, and on
    the 'dense'/'lu'/'cg' routes wrt the node coordinates.
    """
    f = torch.as_tensor(f, dtype=mesh.dtype, device=mesh.device)
    natural = neumann is not None or robin is not None
    method = _resolve_method(mesh, method, kappa=kappa,
                             structured_ok=(not natural) or mesh.dim == 2)
    if robin is None and mesh.n_dirichlet == 0:
        raise ValueError(
            "mesh has no Dirichlet nodes: the Poisson system is singular "
            "(constant nullspace). Pin at least one node "
            "(FEMesh.with_dirichlet) or add a Robin term.")
    if method in ("tridiag", "tridiag_pallas"):
        return _tridiag_route(mesh, method, kappa, f, bc_values, neumann,
                              robin, batched=False)
    if bc_values is not None:
        bc_values = torch.as_tensor(bc_values, dtype=mesh.dtype,
                                    device=mesh.device)
    if method == "stencil":
        _require_stencil(mesh)
        cg_tol, cg_maxiter = _cg_policy(mesh, cg_tol, cg_maxiter)
        return _solve_stencil(mesh, kappa, f, cg_tol, cg_maxiter,
                              neumann=neumann, robin=robin,
                              bc_values=bc_values)
    if method == "cg":
        cg_tol, cg_maxiter = _cg_policy(mesh, cg_tol, cg_maxiter)
        return _cg_route(mesh, kappa, f, cg_tol, cg_maxiter, bc_values,
                         neumann, robin)
    if method in ("dense", "lu"):
        return _dense_route(mesh, method, kappa, f, bc_values, neumann, robin)
    raise ValueError(f"Unknown method {method!r}")


def _kappa_batched(mesh, kappa, kappa_batched, batch_sizes) -> bool:
    k_core = tuple(kappa.shape[:-2] if is_tensor_kappa(mesh, kappa)
                   else kappa.shape)
    if kappa_batched is not None:
        return kappa_batched and len(k_core) >= 1
    if len(k_core) == 2:
        return True
    if len(k_core) == 1:
        L = k_core[0]
        looks_field = L in (mesh.n_elements, mesh.n_nodes)
        looks_batch = (not batch_sizes and not looks_field) or \
            (L in batch_sizes)
        if looks_field and looks_batch:
            raise ValueError(
                f"ambiguous kappa lead dim of length {L}: could be a shared "
                f"per-element/per-node field or B={L} per-scenario values "
                f"— pass kappa_batched=True (batch) or False (field)")
        return looks_batch and not looks_field
    return False


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

    On rectangle meshes a fixed-trip solve (``cg_tol=0.0``,
    ``cg_maxiter ≤ 256``) of batched forcings with shared boundary values
    runs on the whole-CG kernel K3a, its gradient too; other batched
    stencil solves run the torch CG with per-scenario dots (the JAX
    package ``vmap``s one solve per scenario there).  On box meshes such a
    solve (any explicit ``cg_maxiter``) on the card runs on K4a, its
    gradient too; every other batched box solve runs
    ``solve_poisson_structured_3d_batched`` (per-scenario dots, the JAX
    package's batch-minor solve).

    On line meshes the 'tridiag' and 'tridiag_pallas' routes solve the
    whole batch as one batched band solve.  On any mesh 'dense'/'lu' solve
    it as one batched factorization and 'cg' as one batched PCG with
    per-scenario dots (the JAX package ``vmap``s one solve per scenario
    there; a tol-gated batch runs until every scenario has converged, and
    the converged ones keep iterating).  Neumann loads (B, n) and Robin
    terms with batched α / r are scenario axes too.
    """
    _check_kw(kw)
    dt, dev = mesh.dtype, mesh.device
    kappa = torch.as_tensor(kappa, dtype=dt, device=dev)
    f = torch.as_tensor(f, dtype=dt, device=dev)
    if bc_values is not None:
        bc_values = torch.as_tensor(bc_values, dtype=dt, device=dev)
    f_batched = f.ndim >= 2
    g_batched = bc_values is not None and bc_values.ndim >= 2
    nm, rb = kw.get("neumann"), kw.get("robin")
    natural = nm is not None or rb is not None
    nm_batched = nm is not None and torch.as_tensor(nm).ndim >= 2
    rb_batched = rb is not None and (rb.vals.ndim >= 2 or rb.load.ndim >= 2)
    batch_sizes = ({f.shape[0]} if f_batched else set()) | (
        {bc_values.shape[0]} if g_batched else set())
    k_batched = _kappa_batched(mesh, kappa, kappa_batched, batch_sizes)

    if not (k_batched or f_batched or g_batched or nm_batched
            or rb_batched):
        return solve_poisson(mesh, kappa, f, method=method,
                             bc_values=bc_values, **kw)

    method = _resolve_method(mesh, method, kappa=kappa,
                             structured_ok=(not natural) or mesh.dim == 2)
    if k_batched and kappa.ndim == 1:
        # (B,) scalar-per-scenario → (B, n_elements)
        kappa = kappa[:, None].expand(kappa.shape[0], mesh.n_elements)

    if method == "stencil":
        _require_stencil(mesh)
        _require_factory_dirichlet(mesh, natural)
        from .ops.kernels.stencil_cg_kernel import choose_2d_path
        from .ops.pcg import batched_dot

        cg_tol, cg_maxiter = kw.get("cg_tol"), kw.get("cg_maxiter")
        if mesh.dim == 3:
            return _solve_batched_box(mesh, kappa, f, bc_values, cg_tol,
                                      cg_maxiter)
        if (f_batched and not g_batched
                and cg_tol == 0.0 and cg_maxiter and cg_maxiter <= 256
                and choose_2d_path(mesh.grid, block_b=8) == "fused"):
            return _solve_batched_kernel(mesh, kappa, f, bc_values,
                                         int(cg_maxiter))
        cg_tol, cg_maxiter = _cg_policy(mesh, cg_tol, cg_maxiter)
        return _solve_stencil(mesh, kappa, f, cg_tol, cg_maxiter,
                              bc_values=bc_values, dot=batched_dot(2))

    if method in ("tridiag", "tridiag_pallas"):
        return _tridiag_route(mesh, method, kappa, f, bc_values, nm, rb,
                              batched=True)
    if method == "cg":
        cg_tol, cg_maxiter = _cg_policy(mesh, kw.get("cg_tol"),
                                        kw.get("cg_maxiter"))
        return _cg_route(mesh, kappa, f, cg_tol, cg_maxiter, bc_values, nm,
                         rb)
    if method in ("dense", "lu"):
        return _dense_route(mesh, method, kappa, f, bc_values, nm, rb)
    raise ValueError(f"Unknown method {method!r}")


def _solve_batched_kernel(mesh, kappa, f, bc_values, iters):
    """The fixed-trip batched rectangle solve on K3a (block_b = 8, as the
    JAX route passes)."""
    from .ops.kernels.stencil_cg_kernel import solve_structured_kernel
    from .ops.stencil import kappa_lu_from_elements

    grid = mesh.grid
    B = f.shape[0]
    keB = kappa_on_elements(mesh, kappa).expand(B, mesh.n_elements)
    g = mesh.bc_values if bc_values is None else bc_values
    u = solve_structured_kernel(
        grid, kappa_lu_from_elements(grid, keB),
        f.reshape((B,) + grid.node_shape), g.reshape(grid.node_shape),
        iters, 8)
    return u.reshape(B, mesh.n_nodes)


def _solve_batched_box(mesh, kappa, f, bc_values, cg_tol, cg_maxiter):
    """The batched box solve: fixed-trip solves of batched forcings with
    shared boundary values on the card take K4a (block_b = 1); the rest
    take the plain per-scenario batched solve."""
    from .ops.kernels.stencil3d_cg_kernel import solve_structured_kernel_3d
    from .ops.stencil3d import solve_poisson_structured_3d_batched

    grid = mesh.grid
    shape = grid.node_shape
    ke = kappa_on_elements(mesh, kappa)
    g = mesh.bc_values if bc_values is None else bc_values
    B = max(t.shape[0] if t.ndim == 2 else 1 for t in (ke, f, g))
    keB = ke.expand(B, mesh.n_elements)
    if (f.is_cuda and f.ndim == 2 and g.ndim == 1 and cg_tol == 0.0
            and cg_maxiter):
        u = solve_structured_kernel_3d(grid, keB, f.reshape((B,) + shape),
                                       g.reshape(shape), int(cg_maxiter))
    else:
        cg_tol, cg_maxiter = _cg_policy(mesh, cg_tol, cg_maxiter)
        u = solve_poisson_structured_3d_batched(
            grid, keB, f.expand(B, mesh.n_nodes).reshape((B,) + shape),
            g.reshape(g.shape[:-1] + shape), cg_tol, cg_maxiter)
    return u.reshape(B, mesh.n_nodes)


class DifferentiableFESolver:
    """The reference's ``solver(f)`` call shape over ``solve_poisson``.

    Holds no trainable state: κ is a plain tensor and gradients are taken
    through the functional API.  A batched f (B, n_nodes) goes to
    ``solve_poisson_batched``.
    """

    def __init__(self, mesh: FEMesh, kappa=1.0, method: str = "auto"):
        self.mesh = mesh
        self.kappa = torch.as_tensor(kappa, dtype=mesh.dtype,
                                     device=mesh.device)
        self.method = method

    def __call__(self, f) -> torch.Tensor:
        f = torch.as_tensor(f, dtype=self.mesh.dtype, device=self.mesh.device)
        if f.ndim >= 2:
            return solve_poisson_batched(self.mesh, self.kappa, f,
                                         method=self.method)
        return solve_poisson(self.mesh, self.kappa, f, method=self.method)

    forward = __call__
