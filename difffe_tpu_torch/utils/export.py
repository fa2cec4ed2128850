"""AOT export of solver programs (the deployment and serving path).

PyTorch counterpart of ``difffe_tpu/utils/export.py``.  ``torch.export``
traces a function once, for fixed shapes, into an ``ExportedProgram`` (an
ATen graph with its constants), and ``torch.export.save`` writes it as
bytes: the batched solve or the gradient step is built once, shipped, and
run later without retracing the Python that built it.  An artifact holds

* plain PyTorch (assembly, the elimination, the 'tridiag' sweeps, the
  dense factorizations, the stencil operators);
* every kernel as a ``torch.library`` op, one node each
  (``ops/kernels/_build.kernel_op``), which runs the kernel on CUDA
  tensors, planning its route at call time, and the plain version on CPU
  tensors: K1 (``difffe::cf_step``, ``difffe::cf_chain``), K2
  (``difffe::tridiag_pcr``), K3a/K3b (``difffe::stencil_cg``,
  ``difffe::stencil_cg2``), K4a/K4b (``difffe::stencil3d_cg``,
  ``difffe::stencil3d_cg2``), K5a/K5b (``difffe::fused_pcr``), K6
  (``difffe::fused_thomas``), K7 (``difffe::fused_mxu``), K8
  (``difffe::ell_apply``) and K8s (``difffe::ell_cg``, which also runs the
  per-iteration and tol-gated ELL solves);
* the tol-gated CG loops, which read a boolean an iteration, one op each:
  ``difffe::stencil_cg_gated`` (2D), ``difffe::stencil3d_cg_gated`` (3D),
  ``difffe::stencil_natural_cg_gated`` (natural and custom masks) and
  ``difffe::element_cg_gated`` (the element CG of ``method="cg"``).

Only the probes' kernels (P2 and K5's warp variants) refuse to be traced
(``ops/kernels/_build.refuse_traced``).  The loaders import the modules
that register the ops before ``torch.export.load``.

Autograd cannot be traced by ``torch.export``, so the gradient step is its
explicit adjoint on the same primitives: u by the live solve, λ by one more
solve of the same symmetric system, and the κ contraction in closed form.

``platforms`` names the devices an artifact may run on: ``"cpu"`` and
``"cuda"`` (or ``"gpu"``); ``None`` is the device it is traced on (the
mesh's, which is the card by default).  ``torch.export`` traces for one
device, the first; a loader runs the artifact on the card where the list
holds it and one is present, else on the CPU, and moves a program traced
for the other device there (``torch.export.passes.move_to_device_pass``).

Typical use::

    blob = export_batched_solver(mesh, batch=8192)
    ...                                  # ship blob to the serving fleet
    solve = load_exported(blob)
    u = solve(kappas, forcings)
"""

from __future__ import annotations

import dataclasses
import io
import json
from typing import Callable, NamedTuple, Optional, Sequence

import torch

from ..mesh import FEMesh

_PLATFORMS = {"cpu": "cpu", "cuda": "cuda", "gpu": "cuda"}
_EXTRA = "difffe_platforms"


class InputSpec(NamedTuple):
    """What an artifact was traced with for one input (serving layers cast
    requests to it)."""

    shape: tuple
    dtype: torch.dtype
    device: torch.device


def _devices(platforms) -> list:
    """The device types of ``platforms``, in order, each once."""
    devices = []
    for p in platforms:
        d = _PLATFORMS.get(str(p).lower())
        if d is None:
            raise ValueError(f"unknown platform {p!r}: artifacts run on "
                             f"'cpu' or 'cuda' ('gpu')")
        if d not in devices:
            devices.append(d)
    if not devices:
        raise ValueError("platforms must name at least one device")
    return devices


class _Fn(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def export_fn(fn: Callable, *example_args,
              platforms: Optional[Sequence[str]] = None) -> bytes:
    """Trace ``fn`` for the example arguments' shapes, dtypes and device,
    and serialize it.

    ``platforms`` defaults to that device; pass e.g. ``["cuda", "cpu"]``
    for an artifact that also loads where there is no card."""
    devices = {a.device.type for a in example_args
               if isinstance(a, torch.Tensor)}
    if len(devices) != 1:
        raise ValueError(f"example arguments must be tensors on one device, "
                         f"got {sorted(devices)}")
    traced = devices.pop()
    platforms = [traced] if platforms is None else _devices(platforms)
    if platforms[0] != traced:
        raise ValueError(f"platforms {platforms} must name the example "
                         f"arguments' device ({traced}) first")
    with torch.no_grad():
        ep = torch.export.export(_Fn(fn), tuple(example_args), strict=False)
    ep.example_inputs = None    # shapes only, as JAX's: not the data
    buf = io.BytesIO()
    torch.export.save(ep, buf, extra_files={_EXTRA: json.dumps(platforms)})
    return buf.getvalue()


def _register_ops():
    """Import the modules that define the artifacts' ops."""
    from ..ops import cg, stencil, stencil3d, stencil_natural  # noqa: F401
    from ..ops.kernels import (ell_kernel, fused_grad_cf_kernel,  # noqa: F401
                               fused_grad_kernel, fused_grad_mxu_kernel,
                               fused_grad_thomas_kernel, stencil3d_cg_kernel,
                               stencil_cg_kernel, tridiag_kernel)


def _load(blob: bytes, device=None):
    _register_ops()
    extra = {_EXTRA: ""}
    ep = torch.export.load(io.BytesIO(bytes(blob)), extra_files=extra)
    platforms = json.loads(extra[_EXTRA]) if extra[_EXTRA] else ["cpu"]
    if device is None:
        target = ("cuda" if "cuda" in platforms and torch.cuda.is_available()
                  else "cpu")
    else:
        target = _devices([torch.device(device).type])[0]
    if target not in platforms:
        raise ValueError(f"the artifact runs on {platforms}, not on "
                         f"{target}" + ("" if device is not None else
                                        " (this machine has no CUDA card)"))
    if target != platforms[0]:
        from torch.export.passes import move_to_device_pass
        ep = move_to_device_pass(ep, target)
    return ep, torch.device(target)


def load_exported(blob: bytes, device=None) -> Callable:
    """Deserialize an exported program; returns ``fn(*args) → result``.
    ``device`` (one of the artifact's platforms) defaults to the card where
    the artifact runs there and one is present, else the CPU."""
    return _load(blob, device)[0].module()


def load_exported_with_avals(blob: bytes, device=None):
    """(call_fn, input specs): each spec carries the shape, dtype and
    device the artifact runs with (serving layers cast requests to
    them); ``device`` as in :func:`load_exported`."""
    ep, target = _load(blob, device)
    vals = {n.name: n.meta["val"] for n in ep.graph.nodes
            if n.op == "placeholder"}
    specs = [InputSpec(tuple(vals[name].shape), vals[name].dtype, target)
             for name in ep.graph_signature.user_inputs]
    return ep.module(), specs


def _mesh_for_export(mesh: FEMesh, platforms) -> FEMesh:
    """The mesh on the device an artifact for ``platforms`` is traced on,
    with what the facade derives from it computed outside the trace."""
    from ..solver import _mask_is_factory

    if platforms is not None:
        device = torch.device(_devices(platforms)[0])
        if mesh.device.type != device.type:
            mesh = dataclasses.replace(
                mesh, nodes=mesh.nodes.to(device),
                elements=mesh.elements.to(device),
                bc_mask=mesh.bc_mask.to(device),
                bc_values=mesh.bc_values.to(device))
    if mesh.grid is not None:
        _mask_is_factory(mesh)
    return mesh


def export_batched_solver(mesh: FEMesh, batch: int,
                          method: str = "auto",
                          platforms: Optional[Sequence[str]] = None) -> bytes:
    """AOT-export the scenario-batched Poisson solve for fixed (mesh, B).

    The artifact takes (κ (B,), f (B, n_nodes)) and returns u (B, n_nodes).
    """
    from ..solver import solve_poisson_batched

    mesh = _mesh_for_export(mesh, platforms)

    def fn(kappa_b, f_b):
        return solve_poisson_batched(mesh, kappa_b, f_b, method=method,
                                     kappa_batched=True)

    kw = dict(dtype=mesh.dtype, device=mesh.device)
    return export_fn(fn, torch.ones(batch, **kw),
                     torch.ones(batch, mesh.n_nodes, **kw),
                     platforms=platforms)


def _mse_cotangent(r):
    """∂ mean(r²)/∂r = 2r/N, in the order autograd forms it."""
    return (r.new_ones(()) / r.numel()) * (2.0 * r)


def _band_pieces(mesh: FEMesh, backend: str):
    """The band routes: λ by the eliminated bands' solve, K(κ)u by the
    assembled bands before elimination."""
    from ..ops.assembly import assemble_tridiag_1d
    from ..ops.tridiag import (dirichlet_elimination, solve_eliminated,
                               tridiag_matvec)

    def pieces(ke, u, ubar):
        d, e = assemble_tridiag_1d(mesh, ke)
        d_mod, e_mod, _, _ = dirichlet_elimination(mesh, d, e)
        return (solve_eliminated(d_mod, e_mod, ubar, backend),
                tridiag_matvec(d, e, u))

    return pieces


def _dense_pieces(mesh: FEMesh, factor: str):
    """The dense routes: λ from the eliminated matrix's factors, as the
    live backward solves it (Cholesky, or LU's adjoint solve), K(κ)u by
    the assembled matrix."""
    from ..ops.assembly import assemble_stiffness_dense
    from ..ops.solve import apply_dirichlet_dense

    def pieces(ke, u, ubar):
        K = assemble_stiffness_dense(mesh, ke)
        K_mod, _ = apply_dirichlet_dense(mesh, K, ubar)
        if factor == "dense":
            lam = torch.cholesky_solve(ubar[..., None],
                                       torch.linalg.cholesky(K_mod))
        else:
            LU, piv = torch.linalg.lu_factor(K_mod)
            lam = torch.linalg.lu_solve(LU, piv, ubar[..., None],
                                        adjoint=True)
        return lam[..., 0], (K @ u[..., None])[..., 0]

    return pieces


def _cg_pieces(mesh: FEMesh):
    """The element CG route: λ by the same (tol-gated) PCG on the same
    operator, K(κ)u by its element apply."""
    from ..ops.cg import (apply_K, element_operator, jacobi, solve_element,
                          stiffness_diag)
    from ..solver import _cg_policy

    tol, maxiter = _cg_policy(mesh, None, None)

    def pieces(ke, u, ubar):
        op = element_operator(mesh, ke)
        Minv = jacobi(mesh, stiffness_diag(mesh, ke))
        lam = solve_element(op, ubar, Minv, torch.zeros_like(ubar), tol,
                            maxiter)
        return lam, apply_K(op, u)

    return pieces


def _stencil_adjoint(mesh: FEMesh):
    """The stencil routes (2D factory and natural/custom masks, 3D box)
    as their IFT backwards form them: λ by the route's tol-gated CG, then
    the closed-form κ contraction per element (so the 2D factory route
    gives its live backward's bits)."""
    from ..ops.pcg import batched_dot
    from ..ops import stencil as st
    from ..solver import _cg_policy, _mask_is_factory

    grid = mesh.grid
    shape = grid.node_shape
    tol, maxiter = _cg_policy(mesh, None, None)
    m = mesh.bc_mask.reshape(shape)
    p = 1.0 - m
    g = mesh.bc_values.reshape(shape)
    if mesh.dim == 3:
        from ..ops import stencil3d as st3

        def lam_and_grad(ke, u, ubar):
            lam = st3.apply_inv_3d(grid, ke, ubar, tol, maxiter,
                                   batched_dot(3))
            return -st3.stencil3d_kappa_grad(grid, p * lam, m * g + p * u)
    else:
        from ..ops import stencil_natural as sn
        factory = _mask_is_factory(mesh)

        def lam_and_grad(ke, u, ubar):
            kl, ku = st.kappa_lu_from_elements(grid, ke)
            if factory:
                lam = st.apply_inv(grid, (kl, ku), ubar, tol, maxiter,
                                   batched_dot(2))
            else:
                lam = sn._pcg_nat(grid, st.stencil_coefficients(grid, kl, ku),
                                  None, m, ubar, torch.zeros_like(ubar), tol,
                                  maxiter)
            g_low, g_up = st.stencil_kappa_grad(grid, p * lam,
                                                m * g + p * u)
            return torch.stack([-g_low, -g_up], dim=-1)

    def adjoint(kappa, u, ubar):
        B = kappa.shape[0]
        ke = kappa[:, None].expand(B, mesh.n_elements)
        g_el = lam_and_grad(ke, u.reshape((B,) + shape),
                            ubar.reshape((B,) + shape))
        return g_el.reshape(B, -1).sum(-1) * kappa

    return adjoint


def _adjoint(mesh: FEMesh, route: str):
    """(κ (B,), u (B, n), ū (B, n)) → ∂loss/∂log κ (B,) on ``route``.

    For one κ per scenario the eliminated operator is A(κ_b) = m +
    κ_b·P K₁ P, so with λ_b = A(κ_b)⁻¹ ū_b (A symmetric), solved by the
    route's own solve on ū itself, ∂loss/∂log κ_b = −(P λ_b)ᵀ K(κ_b) u_b,
    with K before elimination: u_b = m⊙g + P u_b, so the term holds the
    κ-dependence of the eliminated right-hand side where g ≠ 0."""
    if route == "stencil":
        return _stencil_adjoint(mesh)
    if route in ("tridiag", "tridiag_pallas"):
        pieces = _band_pieces(mesh, "pallas" if route == "tridiag_pallas"
                              else "xla")
    elif route in ("dense", "lu"):
        pieces = _dense_pieces(mesh, route)
    elif route == "cg":
        pieces = _cg_pieces(mesh)
    else:
        raise ValueError(f"Unknown method {route!r}")
    p = 1.0 - mesh.bc_mask

    def adjoint(kappa, u, ubar):
        ke = kappa[:, None].expand(kappa.shape[0], mesh.n_elements)
        lam, Ku = pieces(ke, u, ubar)
        return -(p * lam * Ku).sum(-1)

    return adjoint


def export_gradient_step(mesh: FEMesh, batch: int,
                         method: str = "auto",
                         platforms: Optional[Sequence[str]] = None) -> bytes:
    """AOT-export one fwd+adjoint κ-gradient step (the inversion hot loop).

    Artifact signature: (log_κ (B,), f (B,n), u_data (B,n)) →
    (loss scalar, grad (B,)), grad = ∂ mean((u − u_data)²)/∂ log κ, on
    every route the facade takes for ``method``: the band routes of line
    meshes, 'dense', 'lu' and 'cg' on any mesh, the 2D stencil route with
    the factory or any other Dirichlet mask and the 3D stencil route (both
    tol-gated), as :func:`_adjoint` forms the gradient.
    """
    from ..solver import _resolve_method, solve_poisson_batched

    mesh = _mesh_for_export(mesh, platforms)
    adjoint = _adjoint(mesh, _resolve_method(mesh, method))

    def step(log_k, f_b, u_data):
        kappa = log_k.exp()
        u = solve_poisson_batched(mesh, kappa, f_b, method=method,
                                  kappa_batched=True)
        r = u - u_data
        loss = (r ** 2).mean()
        return loss, adjoint(kappa, u, _mse_cotangent(r))

    kw = dict(dtype=mesh.dtype, device=mesh.device)
    # two tensors: inputs given as one object would be traced as one
    return export_fn(step, torch.zeros(batch, **kw),
                     torch.ones(batch, mesh.n_nodes, **kw),
                     torch.ones(batch, mesh.n_nodes, **kw),
                     platforms=platforms)
