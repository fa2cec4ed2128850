"""The parallel layer of the PyTorch port (difffe_tpu_torch/parallel/)
against the JAX package's single-device functions, and its gloo groups of
2 and 4 processes against its single process.

The JAX parallel modules state their single-device equivalents
(``parallel/halo.py:17-19``, ``halo3d.py:17-18``, ``pipeline.py:24-26``,
``expert.py:28-29``; the vmapped Adam loop of
tests/test_distributed_training.py), so JAX runs only those, in one
``jax.jit`` for the module, and no virtual mesh.  The port's functions
run at world size 1 in this process (a gloo group of one, made and
destroyed by the module's fixture) and in two gloo groups spawned once
for the module: dof = 2 (world 2) and dp × dof = 2 × 2 (world 4), their
ranks meeting through a file store in a temporary directory.  The cases
and their data are tests/torch_parallel_cases.py's, which the ranks run
as a script (torch and the port only).  Every rendezvous and collective
gives up after 30 s and the spawn after ``SPAWN_TIMEOUT_S``.

Tolerances (float64, relative): exchange, apply, dispatch and the
pipeline's forward 1e-12; CG solves, gradients and Adam trajectories
1e-10; the port's single process against JAX 1e-10; pings and drop
counts exact.
"""

import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_parallel_cases as tc
from torch_parity import jax_mesh, rel_err

from difffe_tpu.control.heat import rollout_batched as j_rollout_batched
from difffe_tpu.mesh import FEMesh as JMesh
from difffe_tpu.models.neural import apply_mlp
from difffe_tpu.ops import stencil as js
from difffe_tpu.ops import stencil3d as js3
from difffe_tpu.ops.pcg import pcg as j_pcg
from difffe_tpu.parallel.expert import (make_dispatch as j_make_dispatch,
                                        moe_apply as j_moe_apply,
                                        route_by_bucket as j_route)
from difffe_tpu.solver import solve_poisson as j_solve
from difffe_tpu.solver import solve_poisson_batched as j_solve_batched

from difffe_tpu_torch.parallel import make_device_mesh, make_dispatch
from difffe_tpu_torch.parallel import multihost

torch.set_num_threads(1)

WORLDS = (2, 4)
SPAWN_TIMEOUT_S = 120.0
REPO = Path(__file__).resolve().parents[1]


def _spawn(out_dir):
    """Start every rank of the worlds of ``WORLDS``; returns the procs."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    procs = []
    for world in WORLDS:
        store = out_dir / f"store{world}"
        for rank in range(world):
            log = open(out_dir / f"w{world}_r{rank}.log", "w")
            procs.append((subprocess.Popen(
                [sys.executable, str(REPO / "tests" / "torch_parallel_cases.py"),
                 str(rank), str(world), str(store), str(out_dir)],
                env=env, stdout=log, stderr=subprocess.STDOUT), log))
    return procs


def _join(procs, out_dir):
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    failed = []
    for proc, log in procs:
        try:
            rc = proc.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            rc = "timeout"
        log.close()
        if rc != 0:
            failed.append((proc.args[2:4], rc))
    if failed:
        logs = "\n".join(p.read_text()[-2000:]
                         for p in sorted(out_dir.glob("*.log")))
        raise AssertionError(f"gloo ranks failed: {failed}\n{logs}")


def _world1():
    """The port's results at world size 1 in this process (a gloo group of
    one, destroyed before the fixture returns)."""
    multihost.initialize(device="cpu", timeout_s=30.0)
    try:
        res = {"multihost": tc.check_multihost(1)}
        res.update(tc.run_all(make_device_mesh()))
        return res
    finally:
        torch.distributed.destroy_process_group()


def _jax_references(d):
    """Every JAX single-device reference, in one jit."""
    fe = jax_mesh(JMesh.line, tc.INV_ELEMENTS, dtype=jnp.float64)
    fe1 = jax_mesh(JMesh.line, tc.PIPE_ELEMENTS, dtype=jnp.float64)
    grid = js.StructuredGrid.unit(*tc.GRID2)
    grid3 = js3.StructuredGrid3.unit(*tc.GRID3)
    opt = optax.adam(tc.INV_LR)

    def expert_apply(params, xb):
        return apply_mlp(params, xb)[:, None]

    @jax.jit
    def refs(a):
        out = {}
        # the vmapped Adam loop of tests/test_distributed_training.py
        f = a["inv_f"]
        u_data = j_solve_batched(fe, a["inv_k_true"], f, kappa_batched=True)

        def inv_loss(log_k):
            u = jax.vmap(lambda lk, ff: j_solve(fe, jnp.exp(lk), ff))(
                log_k, f)
            return jnp.mean((u - u_data) ** 2)

        def adam_step(carry, _):
            k, st = carry
            loss, g = jax.value_and_grad(inv_loss)(k)
            upd, st = opt.update(g, st)
            return (optax.apply_updates(k, upd), st), loss

        k = jnp.zeros(tc.INV_B)
        (k, _), losses = jax.lax.scan(adam_step, (k, opt.init(k)), None,
                                      length=tc.INV_STEPS)
        out["inv_losses"], out["inv_log_k"] = losses, k

        # 2D: one structured solve a scenario (per-scenario dots)
        def h2(kl, ku, f2, g2):
            u = jax.vmap(lambda a_, b_, c_: js.solve_poisson_structured(
                grid, (a_, b_), c_, g2, maxiter=tc.HALO_ITERS))(kl, ku, f2)
            return jnp.sum(u * a["h2_w"]), u

        (_, out["h2_u"]), grads = jax.value_and_grad(
            h2, argnums=(0, 1, 2, 3), has_aux=True)(
            a["h2_kl"], a["h2_ku"], a["h2_f"], a["h2_g"])
        for name, gr in zip(("kl", "ku", "f", "g"), grads):
            out[f"h2_grad_{name}"] = gr
        C = js.stencil_coefficients(grid, a["h2_kl"], a["h2_ku"])
        out["h2_apply"] = js.stencil_apply(C, a["h2_w"])
        out["h2_apply_grad"] = jax.grad(
            lambda w: jnp.sum(js.stencil_apply(C, w) ** 2))(a["h2_w"])
        m = js.boundary_mask_grid(grid, jnp.float64)
        p = 1.0 - m
        C0 = C[0]
        diag = m + p * C0[0]
        out["h2_cg"] = j_pcg(lambda v: m * v + p * js.stencil_apply(C0, p * v),
                             p * a["h2_w"][0], lambda r: r / diag,
                             jnp.zeros_like(m), 0.0, tc.HALO_ITERS)

        # 3D
        def h3(k3, f3, g3):
            u = jax.vmap(lambda a_, b_: js3.solve_poisson_structured_3d(
                grid3, a_, b_, g3, maxiter=tc.HALO_ITERS))(k3, f3)
            return jnp.sum(u * a["h3_w"]), u

        (_, out["h3_u"]), grads = jax.value_and_grad(
            h3, argnums=(0, 1, 2), has_aux=True)(a["h3_k"], a["h3_f"],
                                                 a["h3_g"])
        for name, gr in zip(("k", "f", "g"), grads):
            out[f"h3_grad_{name}"] = gr
        out["h3_apply"] = js3.stencil3d_apply(
            js3.stencil3d_coefficients(grid3, a["h3_k"]), a["h3_w"])

        # the rollout the pipeline equals
        def pp(kappa, u0, fs):
            traj = j_rollout_batched(fe1, kappa, u0, fs, tc.PIPE_DT,
                                     method="tridiag")
            cost = jnp.sum(traj * traj)
            return cost + jnp.sum(traj[-1] * a["pp_w"]), (traj[-1], cost)

        (_, (out["pp_final"], out["pp_cost"])), grads = jax.value_and_grad(
            pp, argnums=(0, 1, 2), has_aux=True)(a["pp_kappa"], a["pp_u0"],
                                                 a["pp_f"])
        for name, gr in zip(("kappa", "u0", "f"), grads):
            out[f"pp_grad_{name}"] = gr

        # the expert bank without a mesh
        ids = j_route(a["moe_v"], a["moe_bounds"])
        D, dropped = j_make_dispatch(ids, tc.MOE_E, tc.MOE_CAP)

        def moe(params, X):
            Y, drop = j_moe_apply(params, X, ids, expert_apply,
                                  capacity=tc.MOE_CAP)
            return jnp.sum(Y * a["moe_w"]), (Y, drop)

        (_, (out["moe_y"], out["moe_dropped"])), (gp, gx) = \
            jax.value_and_grad(moe, argnums=(0, 1), has_aux=True)(
                a["moe_params"], a["moe_x"])
        out.update(moe_ids=ids, moe_D=D, moe_D_dropped=dropped,
                   moe_grad_x=gx)
        for i, (gW, gb) in enumerate(gp):
            out[f"moe_grad_layers.{i}.weight"] = jnp.swapaxes(gW, -1, -2)
            out[f"moe_grad_layers.{i}.bias"] = gb
        return out

    a = {k: jnp.asarray(v) for k, v in d.items() if k != "moe_layers"}
    a["moe_params"] = [
        (jnp.stack([jnp.asarray(layers[i][0]) for layers in d["moe_layers"]]),
         jnp.stack([jnp.asarray(layers[i][1]) for layers in d["moe_layers"]]))
        for i in range(len(d["moe_layers"][0]))]
    return jax.device_get(refs(a))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("gloo")
    procs = _spawn(out_dir)
    try:
        world1 = _world1()
        jax_refs = _jax_references(tc.inputs())
    finally:
        _join(procs, out_dir)
    ranks = {world: [torch.load(out_dir / f"w{world}_r{r}.pt",
                                weights_only=False) for r in range(world)]
             for world in WORLDS}
    return {"w1": world1, "jax": jax_refs, "ranks": ranks}


def _hold(runs, keys, tol_jax, tol_ranks):
    """Each key: world 1 against JAX, every rank of each world against
    world 1."""
    for key, jkey in keys:
        w1 = runs["w1"][key]
        if jkey is not None:
            e = rel_err(w1, runs["jax"][jkey])
            assert e <= tol_jax, f"{key}: world 1 vs JAX {e:.3e}"
        for world, ranks in runs["ranks"].items():
            for r, res in enumerate(ranks):
                e = rel_err(res[key], w1)
                assert e <= tol_ranks, (f"{key}: world {world} rank {r} vs "
                                        f"world 1 {e:.3e}")


def test_inversion_step(runs):
    """The sharded Adam step (GSPMD, dof-sharded and shard_map variants)
    against the vmapped optax loop over every scenario."""
    keys = [(f"inv_{v}_{what}", f"inv_{what}")
            for v in ("gspmd", "dof", "shard_map")
            for what in ("losses", "log_k")]
    _hold(runs, keys, 1e-10, 1e-10)
    w1 = runs["w1"]
    assert torch.equal(w1["inv_gspmd_log_k"], w1["inv_shard_map_log_k"])
    assert float(w1["inv_gspmd_losses"][-1]) < float(
        w1["inv_gspmd_losses"][0])


def test_halo_solvers(runs):
    """2D (rows over dof) and 3D (z-planes over dof) halo solves, their
    gradients to κ, f and g, the halo apply and its gradient, and the
    forward-only halo CG."""
    solves = [(k, k) for k in (
        "h2_u", "h2_grad_kl", "h2_grad_ku", "h2_grad_f", "h2_grad_g",
        "h2_cg", "h3_u", "h3_grad_k", "h3_grad_f", "h3_grad_g")]
    _hold(runs, solves, 1e-10, 1e-10)
    _hold(runs, [(k, k) for k in ("h2_apply", "h2_apply_grad", "h3_apply")],
          1e-10, 1e-12)


def test_pipelined_rollout(runs):
    """GPipe over time: final state and cost (forward), and gradients to
    κ, u0 and f_seq through the stage hand-offs."""
    _hold(runs, [("pp_final", "pp_final"), ("pp_cost", "pp_cost")],
          1e-10, 1e-12)
    _hold(runs, [(f"pp_grad_{k}", f"pp_grad_{k}")
                 for k in ("kappa", "u0", "f")], 1e-10, 1e-10)


def test_expert_bank(runs):
    """Routing, the capacity-bounded dispatch and the bank's output, drop
    count and gradients, unsharded and over dp × ep."""
    w1, j = runs["w1"], runs["jax"]
    D, dropped = make_dispatch(w1["moe_ids"], tc.MOE_E, tc.MOE_CAP)
    assert np.array_equal(w1["moe_ids"].numpy(), j["moe_ids"])
    assert np.array_equal(D.numpy(), j["moe_D"])
    assert int(dropped) == int(j["moe_D_dropped"]) > 0
    for world, ranks in runs["ranks"].items():
        for res in ranks:
            assert int(res["moe_dropped"]) == int(j["moe_dropped"]), world
    assert int(w1["moe_dropped"]) == int(j["moe_dropped"])
    _hold(runs, [("moe_y", "moe_y")], 1e-10, 1e-12)
    grads = [k for k in w1 if k.startswith("moe_grad_")]
    assert len(grads) == 7
    _hold(runs, [(k, k) for k in grads], 1e-10, 1e-10)


def test_multihost(runs):
    """Heartbeats over the mesh and the default group, a stalled
    participant (the watchdog returns False within its budget, the late
    all-reduce still lands), and dryrun_multichip on each world."""
    mh = runs["w1"]["multihost"]
    assert mh["ping_mesh"] is True and mh["ping_world"] is True
    for world, ranks in runs["ranks"].items():
        for r, res in enumerate(ranks):
            mh = res["multihost"]
            assert mh["ping_mesh"] is True and mh["ping_world"] is True
            assert mh["late_wait"] is True and mh["sum"] == float(world)
            if r < world - 1:   # the last rank is the straggler
                assert mh["stalled_wait"] is False, (world, r)
                assert mh["stalled_ping"] is False, (world, r)
            assert res["dryrun"] is True
