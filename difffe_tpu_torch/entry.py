"""Driver entry points: the flagship forward step, and a multi-rank dry run.

PyTorch counterpart of the repository's ``__graft_entry__.py``:

* ``entry()`` returns the scenario-batched differentiable 1D solve (κ
  batch × forcing batch → solution batch, ``FEMesh.line(128)``, B = 256)
  that every north-star config builds on, and its example arguments; on
  the card every solve is one launch of kernel K2.
* ``dryrun_multichip(n)`` runs, on the n ranks of the initialized process
  group (``parallel.multihost.initialize``), one step of the sharded
  κ-inversion training step with dp × dof shardings (dof = 2 where n is
  even), one value and gradient of the 2D and of the 3D halo solver, and
  one of the time-pipelined rollout, on tiny shapes.  Every rank calls it.

``python -m difffe_tpu_torch.entry [--device cpu]`` runs both in a group
of this one process.
"""

from __future__ import annotations

import argparse
import math
import sys

import torch


def entry(device="cuda"):
    """(fn, example_args): the batched differentiable forward solve."""
    from .mesh import FEMesh
    from .solver import solve_poisson_batched

    fe_mesh = FEMesh.line(n_elements=128, dtype=torch.float32, device=device)
    B = 256
    x = fe_mesh.nodes[:, 0]

    def fn(kappa_b, f_b):
        return solve_poisson_batched(fe_mesh, kappa_b, f_b,
                                     method="tridiag_pallas",
                                     kappa_batched=True)

    kappa_b = torch.linspace(0.5, 2.0, B, dtype=torch.float32, device=device)
    f_b = (torch.sin(math.pi * x) + 1.0).expand(B, fe_mesh.n_nodes)
    return fn, (kappa_b, f_b)


def _finite(*tensors) -> bool:
    return all(bool(torch.isfinite(t).all()) for t in tensors)


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """One sharded training step, 2D and 3D halo gradients and a pipelined
    rollout gradient on an n-rank mesh (tiny shapes); raises on a
    non-finite result."""
    import torch.distributed as dist

    from .mesh import FEMesh
    from .ops.stencil import StructuredGrid
    from .ops.stencil3d import StructuredGrid3
    from .parallel import (make_device_mesh, make_halo_solver,
                           make_inversion_step, pipelined_rollout)
    from .parallel.halo3d import make_halo_solver_3d
    from .solver import solve_poisson_batched

    f32 = torch.float32
    # dp × dof layout: scenario batch over dp, DOF axis over dof
    dof = 2 if n_devices % 2 == 0 else 1
    dp = n_devices // dof
    dmesh = make_device_mesh(n_devices=n_devices, mesh_shape=(dp, dof))

    def grad(loss, wrt):
        # a loss every rank holds whole seeds 1/n; the ranks' gradients of
        # a whole input are partials to sum (parallel/_collectives.py)
        (g,) = torch.autograd.grad(loss, (wrt,), loss.new_tensor(
            1.0 / n_devices))
        dist.all_reduce(g)
        return g

    fe_mesh = FEMesh.line(n_elements=31, dtype=f32, device=device)
    B = max(2 * dp, 8)
    x = fe_mesh.nodes[:, 0]
    k_true = torch.linspace(1.0, 3.0, B, dtype=f32, device=device)
    f = (torch.sin(math.pi * x) + 1.0).expand(B, fe_mesh.n_nodes)
    u_data = solve_poisson_batched(fe_mesh, k_true, f, kappa_batched=True)
    init_fn, step_fn, data_sh = make_inversion_step(
        fe_mesh, dmesh, lr=0.1, method="tridiag_pallas", shard_dof=True)
    log_k, opt_state = init_fn(torch.zeros(B, dtype=f32))
    log_k, opt_state, loss = step_fn(log_k, opt_state, data_sh.local(f),
                                     data_sh.local(u_data))
    if not _finite(loss, log_k):
        raise AssertionError(f"non-finite inversion step: loss {loss}")

    # 2D halo leg: node rows split over dof (every rank the same two
    # scenarios)
    grid = StructuredGrid.unit(4, 2 * dof - 1)
    Bh = 2
    kl = torch.ones((Bh, grid.ny, grid.nx), dtype=f32, device=device)
    fh = torch.ones((Bh,) + grid.node_shape, dtype=f32, device=device)
    gh = torch.zeros(grid.node_shape, dtype=f32, device=device)
    solve = make_halo_solver(dmesh, grid, maxiter=64, batch_axis="dp")
    u_tgt = solve((kl * 2.0, kl), fh, gh)
    kl_ = kl.clone().requires_grad_()
    val = ((solve((kl_, kl), fh, gh) - u_tgt) ** 2).mean()
    gk = grad(val, kl_)
    if not _finite(val, gk):
        raise AssertionError("non-finite 2D halo value or gradient")

    # 3D halo leg: z-planes split over dof
    g3 = StructuredGrid3.unit(3, 3, 2 * dof - 1)
    k3 = torch.ones((2, g3.n_elements), dtype=f32, device=device)
    f3 = torch.ones((2,) + g3.node_shape, dtype=f32, device=device)
    g30 = torch.zeros(g3.node_shape, dtype=f32, device=device)
    solve3 = make_halo_solver_3d(dmesh, g3, maxiter=48, batch_axis="dp")
    u3_tgt = solve3(k3 * 2.0, f3, g30)
    k3_ = k3.clone().requires_grad_()
    v3 = ((solve3(k3_, f3, g30) - u3_tgt) ** 2).mean()
    gk3 = grad(v3, k3_)
    if not _finite(v3, gk3):
        raise AssertionError("non-finite 3D halo value or gradient")

    # pipeline leg: time-axis GPipe rollout over dof, differentiated
    # through the stage hand-offs
    fe1 = FEMesh.line(n_elements=7, dtype=f32, device=device)
    Hp, Bp = 2 * dof, 2 * dp
    u0p = torch.zeros((Bp, fe1.n_nodes), dtype=f32, device=device)
    f_seq = torch.ones((Hp, Bp, fe1.n_nodes), dtype=f32, device=device)
    kappa = torch.tensor(1.2, dtype=f32, device=device, requires_grad=True)
    _, cost = pipelined_rollout(dmesh, fe1, kappa, u0p, f_seq, 0.05,
                                n_micro=2, cost_fn=lambda u: (u * u).sum())
    gkp = grad(cost, kappa)
    if not _finite(cost, gkp):
        raise AssertionError("non-finite pipelined rollout or gradient")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    device = parser.parse_args(argv).device
    import torch.distributed as dist

    from .parallel import multihost

    multihost.initialize(device=device)
    try:
        fn, args = entry(device)
        out = fn(*args)
        print("entry ok:", tuple(out.shape), out.dtype)
        n = dist.get_world_size()
        dryrun_multichip(n, device=device)
        print(f"dryrun_multichip({n}) ok")
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
