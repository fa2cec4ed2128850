"""The parallel layer's cases, run by tests/test_torch_parallel.py at world
size 1 in the test process and, as a script, by each rank of a gloo
group of 2 or 4 processes:

    python tests/torch_parallel_cases.py RANK WORLD STORE_FILE OUT_DIR

This module imports torch, numpy and the PyTorch port only (never jax):
the ranks of a group are processes of their own.  ``inputs()`` makes the
cases' data with numpy from fixed seeds, so every process and the JAX
references see the same numbers; ``run_all(dmesh)`` runs every case on a
mesh and returns its results whole (a rank's shards gathered, and the
ranks' partial gradients summed, by the package's cotangent convention).
"""

import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch.distributed as dist  # noqa: E402

from difffe_tpu_torch.mesh import FEMesh  # noqa: E402
from difffe_tpu_torch.models.neural import mlp_params_from_jax  # noqa: E402
from difffe_tpu_torch.ops.stencil import (  # noqa: E402
    StructuredGrid, boundary_mask_grid, stencil_coefficients)
from difffe_tpu_torch.ops.stencil3d import (  # noqa: E402
    StructuredGrid3, stencil3d_coefficients)
from difffe_tpu_torch.parallel import (  # noqa: E402
    batch_sharding, halo_cg_solve, make_device_mesh, make_halo_apply, make_halo_solver,
    make_inversion_step, make_inversion_step_shard_map, moe_apply,
    pipelined_rollout, route_by_bucket)
from difffe_tpu_torch.parallel import multihost  # noqa: E402
from difffe_tpu_torch.parallel._collectives import (  # noqa: E402
    all_gather, rank_slice)
from difffe_tpu_torch.parallel.expert import mlp_bank  # noqa: E402
from difffe_tpu_torch.parallel.halo3d import (  # noqa: E402
    make_halo_apply_3d, make_halo_solver_3d)
from difffe_tpu_torch.solver import solve_poisson_batched  # noqa: E402

F64 = torch.float64
# (mesh shape) by world size: dof alone at 2, dp × dof at 4
MESH_SHAPES = {1: (1, 1), 2: (1, 2), 4: (2, 2)}

INV_ELEMENTS, INV_B, INV_STEPS, INV_LR = 15, 8, 3, 0.1
GRID2 = (4, 7)             # (nx, ny): 8 node rows, divisible by dof = 2
GRID3 = (3, 2, 3)          # (nx, ny, nz): 4 z-planes
HALO_B, HALO_ITERS = 4, 40
PIPE_ELEMENTS, PIPE_H, PIPE_B, PIPE_MICRO, PIPE_DT = 7, 4, 8, 2, 0.05
MOE_E, MOE_B, MOE_DIN, MOE_HIDDEN, MOE_CAP = 4, 16, 6, 8, 3
STALL_S = 0.8              # how long the straggler of the stall check waits


def inputs(seed: int = 0) -> dict:
    """Every case's data, numpy float64, from ``seed``."""
    rng = np.random.default_rng(seed)
    nx, ny = GRID2
    gx, gy, gz = GRID3
    n_inv = INV_ELEMENTS + 1
    x = np.linspace(0.0, 1.0, n_inv)
    n3 = (gz + 1, gy + 1, gx + 1)
    dims = [MOE_DIN, MOE_HIDDEN, MOE_HIDDEN, 1]
    return {
        "inv_k_true": 1.0 + 2.0 * rng.random(INV_B),
        "inv_f": np.sin(np.pi * x)[None] + rng.random((INV_B, n_inv)),
        "h2_kl": 1.0 + rng.random((HALO_B, ny, nx)),
        "h2_ku": 1.0 + rng.random((HALO_B, ny, nx)),
        "h2_f": rng.random((HALO_B, ny + 1, nx + 1)),
        "h2_g": rng.random((ny + 1, nx + 1)),
        "h2_w": rng.standard_normal((HALO_B, ny + 1, nx + 1)),
        "h3_k": 1.0 + rng.random((HALO_B, 6 * gx * gy * gz)),
        "h3_f": rng.random((HALO_B,) + n3),
        "h3_g": rng.random(n3),
        "h3_w": rng.standard_normal((HALO_B,) + n3),
        "pp_kappa": 0.5 + rng.random(PIPE_ELEMENTS),
        "pp_u0": rng.random((PIPE_B, PIPE_ELEMENTS + 1)),
        "pp_f": rng.random((PIPE_H, PIPE_B, PIPE_ELEMENTS + 1)),
        "pp_w": rng.standard_normal((PIPE_B, PIPE_ELEMENTS + 1)),
        "moe_layers": [[(rng.uniform(-0.5, 0.5, (a, b)),
                         rng.uniform(-0.5, 0.5, b))
                        for a, b in zip(dims[:-1], dims[1:])]
                       for _ in range(MOE_E)],
        "moe_x": rng.standard_normal((MOE_B, MOE_DIN)),
        "moe_v": rng.random(MOE_B),
        "moe_bounds": np.array([0.2, 0.45, 0.7]),
        "moe_w": rng.standard_normal((MOE_B, 1)),
    }


def t64(a, requires_grad=False) -> torch.Tensor:
    return torch.tensor(np.asarray(a), dtype=F64,
                        requires_grad=requires_grad)


def _whole(x, dmesh, axis, dim):
    """The rank's shard along ``dim`` over ``axis``, gathered whole."""
    return all_gather(x.detach().contiguous(), dmesh.get_group(axis),
                      dim=dim)


def _summed(x, group=None):
    """The ranks' partial gradients summed (the whole gradient)."""
    x = x.detach().clone()
    dist.all_reduce(x, group=group)
    return x


def _seed_grad(loss, inputs_, group=None):
    """Gradients of a loss the ranks of ``group`` (default: all) hold
    whole: each seeds 1/N of its cotangent."""
    return torch.autograd.grad(
        loss, inputs_, loss.new_tensor(1.0 / dist.get_world_size(group)))


def run_inversion(dmesh, d) -> dict:
    fe = FEMesh.line(INV_ELEMENTS, dtype=F64, device="cpu")
    f = t64(d["inv_f"])
    u_data = solve_poisson_batched(fe, t64(d["inv_k_true"]), f,
                                   kappa_batched=True)
    out = {}
    variants = {
        "gspmd": make_inversion_step(fe, dmesh, lr=INV_LR),
        "dof": make_inversion_step(fe, dmesh, lr=INV_LR, shard_dof=True),
        "shard_map": make_inversion_step_shard_map(fe, dmesh, lr=INV_LR)
        + (batch_sharding(dmesh),),
    }
    for name, (init_fn, step, sh) in variants.items():
        log_k, opt = init_fn(torch.zeros(INV_B, dtype=F64))
        fl, ul = sh.local(f), sh.local(u_data)
        losses = []
        for _ in range(INV_STEPS):
            log_k, opt, loss = step(log_k, opt, fl, ul)
            losses.append(loss)
        out[f"inv_{name}_losses"] = torch.stack(losses)
        out[f"inv_{name}_log_k"] = _whole(log_k, dmesh, "dp", 0)
    return out


def run_halo2d(dmesh, d) -> dict:
    nx, ny = GRID2
    grid = StructuredGrid.unit(nx, ny)
    dof, dp = dmesh.get_group("dof"), dmesh.get_group("dp")
    kl, ku = (rank_slice(t64(d[k]), dp, 0).clone().requires_grad_()
              for k in ("h2_kl", "h2_ku"))
    f = rank_slice(t64(d["h2_f"]), dp, 0).clone().requires_grad_()
    g = t64(d["h2_g"], requires_grad=True)
    w = rank_slice(t64(d["h2_w"]), dp, 0)
    solve = make_halo_solver(dmesh, grid, maxiter=HALO_ITERS,
                             batch_axis="dp")
    u = solve((kl, ku), f, g)
    # a dp rank's loss is its scenarios' part, whole over its dof group
    grads = _seed_grad((u * w).sum(), (kl, ku, f, g), dof)
    out = {"h2_u": _whole(u, dmesh, "dp", 0)}
    for name, gr in zip(("kl", "ku", "f"), grads[:3]):
        out[f"h2_grad_{name}"] = _whole(_summed(gr, dof), dmesh, "dp", 0)
    out["h2_grad_g"] = _summed(grads[3])

    # the apply, its gradient, and the forward-only CG on row blocks
    C = stencil_coefficients(grid, kl.detach(), ku.detach())
    u_rows = rank_slice(w, dof, -2).clone().requires_grad_()
    C_rows = rank_slice(C, dof, -2)
    Ku = make_halo_apply(dmesh, batched=True)(C_rows, u_rows)
    (gu,) = torch.autograd.grad((Ku * Ku).sum(), (u_rows,))
    out["h2_apply"] = _whole(_whole(Ku, dmesh, "dof", -2), dmesh, "dp", 0)
    out["h2_apply_grad"] = _whole(_whole(gu, dmesh, "dof", -2), dmesh,
                                  "dp", 0)
    # the first scenario on every rank
    C0 = stencil_coefficients(grid, t64(d["h2_kl"][0]), t64(d["h2_ku"][0]))
    m = boundary_mask_grid(grid, F64)
    x = halo_cg_solve(dmesh, rank_slice(C0, dof, -2), rank_slice(m, dof, -2),
                      rank_slice((1.0 - m) * t64(d["h2_w"][0]), dof, -2),
                      HALO_ITERS)
    out["h2_cg"] = _whole(x, dmesh, "dof", -2)
    return out


def run_halo3d(dmesh, d) -> dict:
    gx, gy, gz = GRID3
    grid = StructuredGrid3.unit(gx, gy, gz)
    dof, dp = dmesh.get_group("dof"), dmesh.get_group("dp")
    k = rank_slice(t64(d["h3_k"]), dp, 0).clone().requires_grad_()
    f = rank_slice(t64(d["h3_f"]), dp, 0).clone().requires_grad_()
    g = t64(d["h3_g"], requires_grad=True)
    w = rank_slice(t64(d["h3_w"]), dp, 0)
    solve = make_halo_solver_3d(dmesh, grid, maxiter=HALO_ITERS,
                                batch_axis="dp")
    u = solve(k, f, g)
    grads = _seed_grad((u * w).sum(), (k, f, g), dof)
    out = {"h3_u": _whole(u, dmesh, "dp", 0),
           "h3_grad_k": _whole(_summed(grads[0], dof), dmesh, "dp", 0),
           "h3_grad_f": _whole(_summed(grads[1], dof), dmesh, "dp", 0),
           "h3_grad_g": _summed(grads[2])}
    C = stencil3d_coefficients(grid, k.detach())
    Ku = make_halo_apply_3d(dmesh, batched=True)(
        rank_slice(C, dof, -3), rank_slice(w, dof, -3))
    out["h3_apply"] = _whole(_whole(Ku, dmesh, "dof", -3), dmesh, "dp", 0)
    return out


def run_pipeline(dmesh, d) -> dict:
    fe = FEMesh.line(PIPE_ELEMENTS, dtype=F64, device="cpu")
    kappa = t64(d["pp_kappa"], requires_grad=True)
    u0 = t64(d["pp_u0"], requires_grad=True)
    f_seq = t64(d["pp_f"], requires_grad=True)
    u_final, cost = pipelined_rollout(dmesh, fe, kappa, u0, f_seq, PIPE_DT,
                                      n_micro=PIPE_MICRO,
                                      cost_fn=lambda u: (u * u).sum())
    loss = cost + (u_final * t64(d["pp_w"])).sum()
    grads = _seed_grad(loss, (kappa, u0, f_seq))
    return {"pp_final": u_final.detach(), "pp_cost": cost.detach(),
            "pp_grad_kappa": _summed(grads[0]),
            "pp_grad_u0": _summed(grads[1]),
            "pp_grad_f": _summed(grads[2])}


def moe_bank(d):
    """The expert bank (port MLPs holding the layers of ``inputs()``)."""
    nets = [mlp_params_from_jax(layers) for layers in d["moe_layers"]]
    return mlp_bank(nets)


def run_expert(dmesh, d) -> dict:
    dp = dmesh.get_group("dp")
    params, apply_fn = moe_bank(d)
    params = {k: v.detach().requires_grad_() for k, v in params.items()}
    ids = route_by_bucket(t64(d["moe_v"]), t64(d["moe_bounds"]))
    X = rank_slice(t64(d["moe_x"]), dp, 0).clone().requires_grad_()
    Y, dropped = moe_apply(params, X, rank_slice(ids, dp, 0), apply_fn,
                           capacity=MOE_CAP, dmesh=dmesh)
    loss = (Y * rank_slice(t64(d["moe_w"]), dp, 0)).sum()
    names = sorted(params)
    grads = _seed_grad(loss, [params[k] for k in names] + [X],
                       dmesh.get_group("dof"))
    out = {"moe_ids": ids, "moe_y": _whole(Y, dmesh, "dp", 0),
           "moe_dropped": dropped,
           "moe_grad_x": _whole(_summed(grads[-1], dmesh.get_group("dof")),
                                dmesh, "dp", 0)}
    for k, gr in zip(names, grads[:-1]):
        out[f"moe_grad_{k}"] = _summed(gr)
    return out


def run_all(dmesh, seed: int = 0) -> dict:
    """Every case on ``dmesh``; the results whole on every rank.  The
    plain functions each case equals: ``solve_poisson_structured`` and its
    3D twin with per-scenario dots, ``stencil_apply``, a global-dot PCG,
    ``rollout_batched``, ``moe_apply`` without a mesh, and one Adam loop
    over every scenario."""
    d = inputs(seed)
    out = {}
    for case in (run_inversion, run_halo2d, run_halo3d, run_pipeline,
                 run_expert):
        out.update(case(dmesh, d))
    return out


def check_multihost(world: int) -> dict:
    """Heartbeats over the mesh and the default group, and (from two
    ranks) a stalled participant: the last rank joins an all-reduce
    STALL_S late."""
    dmesh = make_device_mesh(mesh_shape=MESH_SHAPES[world])
    out = {"ping_mesh": multihost.HealthCheck(30.0).ping(dmesh),
           "ping_world": multihost.HealthCheck(30.0).ping()}
    if world == 1:
        return out
    late = dist.get_rank() == world - 1
    t = torch.ones(())
    if late:
        time.sleep(STALL_S)
    work = dist.all_reduce(t, async_op=True)
    out["stalled_wait"] = multihost.timed_block_until_ready(
        work, STALL_S / 5)
    out["late_wait"] = multihost.timed_block_until_ready(work, 30.0)
    out["sum"] = float(t)
    if late:
        time.sleep(STALL_S)
        tok = torch.tensor(world, dtype=torch.int64)
        dist.all_reduce(tok)
        out["stalled_ping"] = False
    else:
        out["stalled_ping"] = multihost.HealthCheck(STALL_S / 5).ping()
        # the straggler's contribution lands later: wait for it
    dist.barrier()
    return out


def main(argv) -> int:
    rank, world, store, out_dir = (int(argv[1]), int(argv[2]), argv[3],
                                   argv[4])
    torch.set_num_threads(1)
    multihost.initialize(f"file://{store}", world, rank, device="cpu",
                         timeout_s=30.0)
    try:
        res = {"multihost": check_multihost(world)}
        dmesh = make_device_mesh(mesh_shape=MESH_SHAPES[world])
        res.update(run_all(dmesh))
        from difffe_tpu_torch.entry import dryrun_multichip
        dryrun_multichip(world, device="cpu")
        res["dryrun"] = True
        torch.save(res, os.path.join(out_dir, f"w{world}_r{rank}.pt"))
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
