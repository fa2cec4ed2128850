"""Time-dependent heat equation: implicit rollouts with adjoint gradients.

PyTorch counterpart of ``difffe_tpu/control/heat.py``.  Method-of-lines P1
FEM with lumped mass,

    M u̇ + K(κ)u = F(q),   θ-scheme:
    (M + θΔt·K) u_{t+1} = (M − (1−θ)Δt·K) u_t + Δt·F_{t+1},

θ = 1 backward Euler (the default), θ = 0.5 Crank–Nicolson.  The system
matrix is SPD and time-independent; on a 1D chain mesh every step is one
batched tridiagonal solve.

The JAX ``lax.scan`` with ``jax.checkpoint`` on the step becomes a Python
loop over the H steps that stacks the trajectory, and autograd keeps every
step's state: at BASELINE.json config 3's width (H = 50, B = 4096, 65
nodes, float32) a trajectory is 50 × 4096 × 65 × 4 B ≈ 53 MB, which the
card holds many times over, so nothing is rematerialized.

``method`` names follow ``solve_poisson``'s: ``"tridiag"`` is the plain
PCR sweeps of ops/tridiag.py (what the JAX rollout runs, as XLA),
``"tridiag_pallas"`` kernel K2 (ops/kernels/tridiag_kernel.py: each
forward step one launch, each adjoint step one more), ``"dense"`` Cholesky
on the assembled matrix, ``"cg"`` the matrix-free shifted PCG of
ops/cg.py.  ``"auto"`` takes ``"tridiag_pallas"`` for a line mesh on the
card and ``"tridiag"`` on the CPU (where K2's wrapper would run that plain
version anyway), ``"dense"`` up to 4096 nodes and ``"cg"`` above
otherwise.  K2 is differentiable once, so the kernel route refuses
``create_graph``; first-order gradients to κ, u0 and the forcing are what
the planners need.  Batched scenarios are leading axes (bands (B, n) for a
per-scenario κ, stride-0 views of a shared one) where JAX ``vmap``s.
"""

from __future__ import annotations

import torch

from ..mesh import FEMesh
from ..ops.assembly import (assemble_load, assemble_lumped_mass,
                            assemble_stiffness_dense, assemble_tridiag_1d,
                            element_family, stiffness_apply)
from ..ops.cg import solve_shifted_cg
from ..ops.solve import apply_dirichlet_dense, cholesky_solve
from ..ops.tridiag import (dirichlet_elimination, solve_eliminated,
                           solve_poisson_tridiag, tridiag_matvec)

_BACKENDS = {"tridiag": "xla", "tridiag_pallas": "pallas"}


def resolve_method(mesh: FEMesh, method: str = "auto") -> str:
    """The rollout route ``method="auto"`` stands for on ``mesh`` (module
    note); any other name is returned as given."""
    if method != "auto":
        return method
    if element_family(mesh) == "p1_line":
        return "tridiag_pallas" if mesh.device.type == "cuda" else "tridiag"
    return "dense" if mesh.n_nodes <= 4096 else "cg"


def heat_system_tridiag(mesh: FEMesh, kappa, dt: float):
    """Bands (d, e) of A = M_lumped + Δt·K for a 1D chain mesh."""
    dK, eK = assemble_tridiag_1d(mesh, kappa)
    return assemble_lumped_mass(mesh) + dt * dK, dt * eK


def heat_step_tridiag(mesh: FEMesh, bands, M: torch.Tensor,
                      u: torch.Tensor, f_next: torch.Tensor,
                      dt: float) -> torch.Tensor:
    """One backward-Euler step on a 1D mesh (batched over leading axes), on
    the ``"auto"`` route (K2 on the card).

    ``f_next`` holds nodal forcing values at t+Δt; the load integral and BC
    elimination are applied inside.
    """
    d, e = bands
    rhs = M * u + dt * assemble_load(mesh, f_next)
    return solve_poisson_tridiag(mesh, d, e, rhs,
                                 backend=_BACKENDS[resolve_method(mesh)])


def _loads(mesh: FEMesh, M: torch.Tensor, f_seq: torch.Tensor,
           dt: float) -> torch.Tensor:
    """Δt·F(f_t) for every step at once.  On a P1 line the trapezoidal
    load is the lumped mass times the nodal forcing (each element gives
    each of its nodes h/2 of that node's value): one elementwise product,
    where ``assemble_load``'s gathers and scatters cost a sort-based
    scatter in the backward pass (half the plan's device time at config
    3's width)."""
    if element_family(mesh) == "p1_line":
        return dt * (M * f_seq)
    return dt * assemble_load(mesh, f_seq)


def rollout(mesh: FEMesh, kappa, u0, f_seq, dt: float,
            method: str = "auto", theta: float = 1.0) -> torch.Tensor:
    """Roll the heat equation H steps; returns the trajectory (H, ..., n).

    f_seq: (H, ..., n_nodes) nodal forcing per step (leading batch axes
    after H broadcast against u0).  Differentiable wrt κ, u0 and f_seq
    through the per-step solves' adjoints.  ``method`` as in the module
    note; ``theta`` 1 (backward Euler) or 0.5 (Crank–Nicolson, second
    order; sample f_seq at the t+θ point for full accuracy).
    """
    dtype, dev = mesh.dtype, mesh.device
    u = torch.as_tensor(u0, dtype=dtype, device=dev)
    f_seq = torch.as_tensor(f_seq, dtype=dtype, device=dev)
    method = resolve_method(mesh, method)
    M = assemble_lumped_mass(mesh)
    loads = _loads(mesh, M, f_seq, dt)
    explicit = (1.0 - theta) * dt

    if method in _BACKENDS:
        dK, eK = assemble_tridiag_1d(mesh, kappa)
        # the system is the same every step: eliminate its Dirichlet rows
        # once (solve_poisson_tridiag's elimination, split).  The
        # eliminated right-hand side of M u + load is affine in both,
        # (p⊙M)⊙u + rhs(load), so the loads of all steps are eliminated at
        # once and a step costs one fused multiply-add and one solve
        d, e, p, eliminate = dirichlet_elimination(
            mesh, M + theta * dt * dK, theta * dt * eK)
        pM = p * M
        lead = torch.broadcast_shapes(u.shape[:-1], loads.shape[1:-1],
                                      d.shape[:-1])
        loads = eliminate(loads.expand(loads.shape[:1] + lead
                                       + loads.shape[-1:]))

        def step(u, load):
            rhs = torch.addcmul(load, pM, u)
            if theta < 1.0:
                rhs = rhs - p * (explicit * tridiag_matvec(dK, eK, u))
            return solve_eliminated(d, e, rhs, _BACKENDS[method])

    elif method == "dense":
        K = assemble_stiffness_dense(mesh, kappa)
        A = torch.diag(M) + theta * dt * K

        def step(u, load):
            rhs = M * u + load
            if theta < 1.0:
                rhs = rhs - explicit * (K @ u[..., None])[..., 0]
            A_mod, rhs_mod = apply_dirichlet_dense(mesh, A, rhs)
            lead = torch.broadcast_shapes(A_mod.shape[:-2],
                                          rhs_mod.shape[:-1])
            n = rhs_mod.shape[-1]
            return cholesky_solve(A_mod.expand(lead + (n, n)),
                                  rhs_mod.expand(lead + (n,)))

    elif method == "cg":
        tau = theta * dt

        def step(u, load):
            rhs = M * u + load
            if theta < 1.0:
                rhs = rhs - explicit * stiffness_apply(mesh, kappa, u)
            return solve_shifted_cg(mesh, kappa, M, tau, rhs)

    else:
        raise ValueError(f"Unknown method {method!r}")

    traj = []
    for load in loads.unbind(0):      # one backward node for all the steps
        u = step(u, load)
        traj.append(u)
    return torch.stack(traj)


def rollout_batched(mesh: FEMesh, kappa, u0, f_seq, dt: float,
                    method: str = "auto") -> torch.Tensor:
    """Scenario-batched rollout: κ (B, …) or shared, u0 (B, n), f_seq
    (H, B, n) → trajectory (H, B, n).  A κ whose leading axis is B is per
    scenario (a (B,) κ one scalar a scenario), as in the JAX package."""
    kappa = torch.as_tensor(kappa, dtype=mesh.dtype, device=mesh.device)
    B = torch.as_tensor(u0).shape[0]
    if kappa.ndim == 1 and kappa.shape[0] == B:
        kappa = kappa[:, None].expand(B, mesh.n_elements)
    return rollout(mesh, kappa, u0, f_seq, dt, method)
