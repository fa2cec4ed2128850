"""AOT export of solver programs (the deployment and serving path).

PyTorch counterpart of ``difffe_tpu/utils/export.py``.  ``torch.export``
traces a function once, for fixed shapes, into an ``ExportedProgram`` (an
ATen graph with its constants), and ``torch.export.save`` writes it as
bytes: the batched solve or the gradient step is built once, shipped, and
run later without retracing the Python that built it.  An artifact holds

* plain PyTorch (assembly, the elimination, the 'tridiag' sweeps, the
  stencil operators);
* the kernels that are ``torch.library`` custom ops, one node each: K2
  (``difffe::tridiag_pcr``, ``method="tridiag_pallas"``) and K1
  (``difffe::cf_step``, ``difffe::cf_chain``), which run the kernel on CUDA
  tensors and the plain version on CPU tensors;
* the tol-gated stencil CG (``difffe::stencil_cg_gated``, ops/stencil.py),
  whose loop reads a boolean an iteration.

Any other kernel raises ``NotImplementedError`` when traced
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
    """Import the modules that define the artifacts' custom ops."""
    from ..ops import stencil  # noqa: F401  difffe::stencil_cg_gated
    from ..ops.kernels import fused_grad_cf_kernel  # noqa: F401  K1
    from ..ops.kernels import tridiag_kernel  # noqa: F401  K2


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


def _adjoint_1d(mesh: FEMesh, backend: str):
    """λ-contraction of the band routes: with p = 1 − m and A(κ) the
    assembled bands before elimination (linear in κ), ∂loss/∂log κ_b =
    −(p⊙λ_b)ᵀ A(κ_b) u_b, which holds the κ-dependence of the eliminated
    right-hand side where g ≠ 0."""
    from ..ops.assembly import assemble_tridiag_1d
    from ..ops.tridiag import (dirichlet_elimination, solve_eliminated,
                               tridiag_matvec)

    def adjoint(kappa, u, ubar):
        d, e = assemble_tridiag_1d(
            mesh, kappa[:, None].expand(kappa.shape[0], mesh.n_elements))
        d_mod, e_mod, p, _ = dirichlet_elimination(mesh, d, e)
        lam = solve_eliminated(d_mod, e_mod, ubar, backend)
        return -(p * lam * tridiag_matvec(d, e, u)).sum(-1)

    return adjoint


def _adjoint_2d(mesh: FEMesh):
    """The stencil route's adjoint as its IFT backward forms it: λ by the
    same tol-gated CG, then the closed-form κ contraction per triangle."""
    from ..ops.pcg import batched_dot
    from ..ops.stencil import (apply_inv, boundary_mask_grid,
                               kappa_lu_from_elements, stencil_kappa_grad)
    from ..solver import _cg_policy

    grid = mesh.grid
    shape = grid.node_shape
    tol, maxiter = _cg_policy(mesh, None, None)
    dot = batched_dot(2)

    def adjoint(kappa, u, ubar):
        B = kappa.shape[0]
        kl, ku = kappa_lu_from_elements(
            grid, kappa[:, None].expand(B, mesh.n_elements))
        lam = apply_inv(grid, (kl, ku), ubar.reshape((B,) + shape), tol,
                        maxiter, dot)
        m = boundary_mask_grid(grid, lam.dtype, lam.device)
        p = 1.0 - m
        g_low, g_up = stencil_kappa_grad(
            grid, p * lam, m * mesh.bc_values.reshape(shape)
            + p * u.reshape((B,) + shape))
        g_el = torch.stack([-g_low, -g_up], dim=-1).reshape(B, -1)
        return g_el.sum(-1) * kappa

    return adjoint


def export_gradient_step(mesh: FEMesh, batch: int,
                         method: str = "auto",
                         platforms: Optional[Sequence[str]] = None) -> bytes:
    """AOT-export one fwd+adjoint κ-gradient step (the inversion hot loop).

    Artifact signature: (log_κ (B,), f (B,n), u_data (B,n)) →
    (loss scalar, grad (B,)), grad = ∂ mean((u − u_data)²)/∂ log κ.  The
    1D band routes ('auto', 'tridiag', 'tridiag_pallas' on line meshes)
    and the 2D stencil route ('auto' on rectangle meshes with the factory
    boundary, tol-gated) are carried; other routes raise
    ``NotImplementedError``.
    """
    from ..solver import (_mask_is_factory, _resolve_method,
                          solve_poisson_batched)

    mesh = _mesh_for_export(mesh, platforms)
    route = _resolve_method(mesh, method)
    if mesh.dim == 1 and route in ("tridiag", "tridiag_pallas"):
        adjoint = _adjoint_1d(mesh, "pallas" if route == "tridiag_pallas"
                              else "xla")
    elif (mesh.dim == 2 and route == "stencil" and mesh.grid is not None
          and _mask_is_factory(mesh)):
        adjoint = _adjoint_2d(mesh)
    else:
        raise NotImplementedError(
            f"export_gradient_step carries the 1D band routes and the 2D "
            f"stencil route; method {method!r} on this {mesh.dim}D mesh "
            f"takes {route!r}")

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
