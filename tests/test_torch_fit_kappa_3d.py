"""The port's 3D box path as a whole — ``fit_kappa`` on ``FEMesh.box`` —
held against the JAX package on the same numpy inputs (f64).

At these sizes the JAX router takes its plain batch-minor step ('xla_bm',
boxes of ≤ 10⁴ nodes) while the port always takes its kernel path, whose
CPU branch is the plain version of K4b: the same function with other
routing, so the two agree to f64 rounding.  The box is non-cubic and
B differs from n_elements and n_nodes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import difffe_tpu.inverse as jinv
from difffe_tpu.mesh import FEMesh as JMesh
from difffe_tpu_torch.inverse import _build_loop_3d, fit_kappa as t_fit
from difffe_tpu_torch.ops.kernels import stencil3d_cg_kernel as tk
from difffe_tpu_torch.solver import solve_poisson_batched as t_solve_b
from torch_parity import as_torch, jax_mesh, port_mesh, rel_err

torch.set_num_threads(1)

PARITY = 1e-8
NX, NY, NZ = 5, 4, 3


def _workload(B=4, seed=6):
    """tests/test_facade_routing.py's 3D fit_kappa workload in f64: shared
    f = 10·sin(πx)sin(πy)sin(πz), κ_true = 1.2 + 0.6·U(0,1) per tet,
    u_data from the fixed-trip batched solve."""
    jm = jax_mesh(JMesh.box, NX, NY, NZ, dtype=jnp.float64)
    tm = port_mesh(jm)
    f = np.broadcast_to(10.0 * np.prod(np.sin(np.pi * np.asarray(jm.nodes)),
                                       axis=1), (B, jm.n_nodes)).copy()
    k_true = 1.2 + 0.6 * np.random.default_rng(seed).random(
        (B, jm.n_elements))
    ud = t_solve_b(tm, as_torch(k_true), as_torch(f), cg_tol=0.0,
                   cg_maxiter=200).numpy()
    return jm, tm, f, ud


def test_fit_kappa_3d_matches_jax():
    jm, tm, f, ud = _workload()
    before = dict(tk.launches)
    k_j, info_j = jinv.fit_kappa(jm, jnp.asarray(f), jnp.asarray(ud),
                                 steps=10)
    k_t, info_t = t_fit(tm, as_torch(f), as_torch(ud), steps=10)
    assert tk.launches == before            # CPU tensors: plain versions
    assert info_j["path"] == "stencil3d_batchminor"
    assert info_t["path"] == "stencil3d_kernel"
    assert set(info_t) == set(info_j)
    assert info_t["iters"] == info_j["iters"] == 32
    assert info_t["warm"] is False and info_j["warm"] is False
    assert isinstance(info_t["loss_history"], torch.Tensor)
    assert info_t["loss_history"].shape == (10,)
    assert k_t.shape == (4, jm.n_elements)
    assert rel_err(k_t, k_j) <= PARITY
    assert rel_err(info_t["loss_history"], info_j["loss_history"]) <= PARITY
    assert abs(info_t["eval_loss"] - info_j["eval_loss"]) <= \
        PARITY * info_j["eval_loss"]
    assert info_t["eval_loss"] < float(info_t["loss_history"][0])


def test_fit_kappa_3d_overrides_single_scenario():
    """iters, lr, warm and kappa0 overrides on a single (n_nodes,)
    scenario, without the eval solve."""
    jm, tm, f, ud = _workload(B=1, seed=7)
    k0 = 1.0 + 0.1 * np.arange(jm.n_elements) / jm.n_elements
    kw = dict(steps=5, iters=12, warm=True, lr=3.0, eval_final=False)
    k_j, info_j = jinv.fit_kappa(jm, jnp.asarray(f[0]), jnp.asarray(ud[0]),
                                 kappa0=jnp.asarray(k0), **kw)
    k_t, info_t = t_fit(tm, as_torch(f[0]), as_torch(ud[0]),
                        kappa0=as_torch(k0), **kw)
    assert k_t.shape == (1, jm.n_elements)
    assert info_t["eval_loss"] is None and info_j["eval_loss"] is None
    assert info_t["iters"] == 12 and info_t["warm"] is True
    assert rel_err(k_t, k_j) <= PARITY
    assert rel_err(info_t["loss_history"], info_j["loss_history"]) <= PARITY


def test_fit_kappa_3d_default_lr_is_batch_invariant():
    """The 3D loss is a mean over the batch, so the default lr folds B in
    (lr = 100·B/256); the same scenarios replicated 8× follow the B = 4
    trajectory (tests/test_facade_routing.py's B-invariance check)."""
    _, tm, f, ud = _workload(seed=11)
    k4, info4 = t_fit(tm, as_torch(f), as_torch(ud), steps=12)
    k32, info32 = t_fit(tm, as_torch(np.tile(f, (8, 1))),
                        as_torch(np.tile(ud, (8, 1))), steps=12)
    assert info4["eval_loss"] < float(info4["loss_history"][0])
    assert rel_err(k32[:4], k4) <= 1e-10 and rel_err(k32[28:], k4) <= 1e-10
    assert info32["eval_loss"] == pytest.approx(info4["eval_loss"],
                                                rel=1e-10)


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_plain_loop_matches_jax_and_kernel_loop(warm):
    """The loop's plain branch ('xla_bm', the JAX router's choice at small
    boxes) against JAX's, and the port's kernel branch against it."""
    jm, tm, f, ud = _workload(B=2, seed=8)
    shape = (2, NZ + 1, NY + 1, NX + 1)
    args = (np.ones((2, jm.n_elements)), f.reshape(shape),
            np.zeros(shape[1:]), ud.reshape(shape))
    cfg = (16, warm, 2.0, 4)
    jk, jh = jinv._build_loop_3d(jm.grid, *cfg, "xla_bm")(
        *[jnp.asarray(a) for a in args])
    tk_, th = _build_loop_3d(tm.grid, *cfg, "xla_bm")(
        *[as_torch(a) for a in args])
    kk, kh = _build_loop_3d(tm.grid, *cfg, "kernel")(
        *[as_torch(a) for a in args])
    for t, j in ((tk_, jk), (th, jh), (kk, jk), (kh, jh)):
        assert tuple(t.shape) == tuple(j.shape)
        assert rel_err(t, j) <= PARITY
