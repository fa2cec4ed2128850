"""The port's 2D structured-grid path as a whole — the rectangle routes of
the facade and ``fit_kappa`` on ``FEMesh.rectangle`` — held against the
JAX package on the same numpy inputs (f64; the JAX Pallas kernels run in
interpret mode)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import difffe_tpu.inverse as jinv
from difffe_tpu.mesh import FEMesh as JMesh
from difffe_tpu.solver import solve_poisson as j_solve
from difffe_tpu.solver import solve_poisson_batched as j_solve_b
from difffe_tpu_torch.inverse import _build_loop_2d, fit_kappa as t_fit
from difffe_tpu_torch.mesh import FEMesh as TMesh
from difffe_tpu_torch.ops.kernels import stencil_cg_kernel as tk
from difffe_tpu_torch.solver import solve_poisson as t_solve
from difffe_tpu_torch.solver import solve_poisson_batched as t_solve_b
from torch_parity import as_torch, jax_mesh, port_grid, port_mesh, rel_err

torch.set_num_threads(1)

PARITY = 1e-8


def _workload(n=8, B=4, seed=5):
    """tests/test_facade_routing.py's fit_kappa workload in f64: shared
    f = 10·sin(πx)sin(πy), κ_true = 1.2 + 0.6·U(0,1) per element, u_data
    from the fixed-trip batched solve."""
    jm = jax_mesh(JMesh.rectangle, n, n, dtype=jnp.float64)
    tm = port_mesh(jm)
    x, y = np.asarray(jm.nodes).T
    f = np.broadcast_to(10.0 * np.sin(np.pi * x) * np.sin(np.pi * y),
                        (B, jm.n_nodes)).copy()
    k_true = 1.2 + 0.6 * np.random.default_rng(seed).random(
        (B, jm.n_elements))
    # the observations are data: the port's solve (held to JAX's in
    # test_solve_poisson_batched_2d) spares a kernel compile in interpret
    # mode
    ud = t_solve_b(tm, as_torch(k_true), as_torch(f), cg_tol=0.0,
                   cg_maxiter=200).numpy()
    return jm, tm, f, k_true, ud


def test_fit_kappa_2d_matches_jax():
    jm, tm, f, _, ud = _workload()
    before = dict(tk.launches)
    k_j, info_j = jinv.fit_kappa(jm, jnp.asarray(f), jnp.asarray(ud),
                                 steps=40, block_b=2)
    k_t, info_t = t_fit(tm, as_torch(f), as_torch(ud), steps=40, block_b=2)
    assert tk.launches == before            # CPU tensors: plain versions
    assert info_t["path"] == info_j["path"] == "stencil2d_fused"
    assert set(info_t) == set(info_j)
    assert info_t["iters"] == 32 and info_t["warm"] is True
    assert isinstance(info_t["loss_history"], torch.Tensor)
    assert info_t["loss_history"].shape == (40,)
    assert k_t.shape == (4, jm.n_elements)
    assert rel_err(k_t, k_j) <= PARITY
    assert rel_err(info_t["loss_history"], info_j["loss_history"]) <= PARITY
    assert abs(info_t["eval_loss"] - info_j["eval_loss"]) <= \
        PARITY * info_j["eval_loss"]
    assert info_t["eval_loss"] < 0.5 * float(info_t["loss_history"][0])


def test_fit_kappa_2d_kappa0_single_scenario_no_eval():
    jm, tm, f, _, ud = _workload(n=6, B=2, seed=6)
    k0 = 1.0 + 0.1 * np.arange(jm.n_elements) / jm.n_elements
    kw = dict(steps=6, iters=12, warm=False, lr=20.0, eval_final=False)
    k_j, info_j = jinv.fit_kappa(jm, jnp.asarray(f[0]), jnp.asarray(ud[0]),
                                 kappa0=jnp.asarray(k0), **kw)
    k_t, info_t = t_fit(tm, as_torch(f[0]), as_torch(ud[0]),
                        kappa0=as_torch(k0), **kw)
    assert k_t.shape == (1, jm.n_elements)
    assert info_t["eval_loss"] is None and info_j["eval_loss"] is None
    assert info_t["iters"] == 12 and info_t["warm"] is False
    assert rel_err(k_t, k_j) <= PARITY
    assert rel_err(info_t["loss_history"], info_j["loss_history"]) <= PARITY


@pytest.mark.parametrize("path", ["two_launch", "xla"])
def test_other_loop_branches_match_jax(path):
    """The loop branches the router picks on the TPU for large grids."""
    jm, tm, f, _, ud = _workload(n=6, B=2, seed=7)
    H = W = 7
    jg, tg = jm.grid, tm.grid
    kl = np.ones((2, 6, 6))
    args = (kl, kl, f.reshape(2, H, W), np.zeros((H, W)),
            ud.reshape(2, H, W))
    cfg = (16, True, 1, 30.0, 2.0 / (H * W), 5)
    jkl, jku, jh = jinv._build_loop_2d(jg, path, *cfg)(
        *[jnp.asarray(a) for a in args])
    tkl, tku, th = _build_loop_2d(tg, path, *cfg)(
        *[as_torch(a) for a in args])
    for t, j in ((tkl, jkl), (tku, jku), (th, jh)):
        assert tuple(t.shape) == tuple(j.shape)
        assert rel_err(t, j) <= PARITY


@pytest.mark.parametrize("kappa_kind", ["scalar", "element", "node"])
def test_facade_solve_poisson_2d(kappa_kind):
    jm = jax_mesh(JMesh.rectangle, 6, 5, bc_value=0.4, dtype=jnp.float64)
    tm = port_mesh(jm)
    rng = np.random.default_rng(1)
    kappa = {"scalar": np.float64(1.7),
             "element": 1.0 + rng.random(jm.n_elements),
             "node": 1.0 + rng.random(jm.n_nodes)}[kappa_kind]
    f = rng.standard_normal(jm.n_nodes)
    bc = 0.2 * rng.standard_normal(jm.n_nodes)
    for kw in ({}, {"cg_tol": 0.0, "cg_maxiter": 30}):
        # JAX's 'auto' resolves to 'stencil' on a rectangle
        ju = jax.jit(lambda k, f: j_solve(jm, k, f, **kw))(
            jnp.asarray(kappa), jnp.asarray(f))
        for method in ("auto", "stencil"):
            tu = t_solve(tm, as_torch(kappa), as_torch(f), method=method,
                         **kw)
            assert rel_err(tu, ju) <= PARITY
    ju = jax.jit(lambda k, f, bc: j_solve(jm, k, f, bc_values=bc))(
        jnp.asarray(kappa), jnp.asarray(f), jnp.asarray(bc))
    tu = t_solve(tm, as_torch(kappa), as_torch(f), bc_values=as_torch(bc))
    assert rel_err(tu, ju) <= PARITY


def test_facade_gradients_2d():
    jm = jax_mesh(JMesh.rectangle, 5, 5, dtype=jnp.float64)
    tm = port_mesh(jm)
    rng = np.random.default_rng(2)
    k = 1.0 + rng.random(jm.n_elements)
    f = rng.standard_normal(jm.n_nodes)
    w = rng.standard_normal(jm.n_nodes)

    def jloss(k_, f_):
        return jnp.sum(jnp.asarray(w) * j_solve(jm, k_, f_))

    jgk, jgf = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jnp.asarray(k),
                                                        jnp.asarray(f))
    tk_, tf_ = as_torch(k).requires_grad_(), as_torch(f).requires_grad_()
    (as_torch(w) * t_solve(tm, tk_, tf_)).sum().backward()
    assert rel_err(tk_.grad, jgk) <= PARITY
    assert rel_err(tf_.grad, jgf) <= PARITY


@pytest.mark.parametrize("mode", ["kernel", "tol_gated", "per_scenario_g"])
def test_solve_poisson_batched_2d(mode):
    """The fixed-trip kernel route (value and κ gradient) and the batched
    fallthrough with per-scenario dots, against JAX."""
    jm = jax_mesh(JMesh.rectangle, 6, 6, dtype=jnp.float64)
    tm = port_mesh(jm)
    rng = np.random.default_rng(3)
    B = 3
    k = 1.0 + rng.random((B, jm.n_elements))
    f = rng.standard_normal((B, jm.n_nodes))
    kw = {"cg_tol": 0.0, "cg_maxiter": 40}
    if mode == "tol_gated":
        kw = {"cg_tol": 1e-10, "cg_maxiter": 200}
    bc = None
    if mode == "per_scenario_g":
        bc = 0.3 * rng.standard_normal((B, jm.n_nodes))

    def jloss(k_):
        u = j_solve_b(jm, k_, jnp.asarray(f),
                      bc_values=None if bc is None else jnp.asarray(bc),
                      **kw)
        return jnp.sum(u ** 2), u

    (_, ju), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jnp.asarray(k))
    tk_ = as_torch(k).requires_grad_()
    tu = t_solve_b(tm, tk_, as_torch(f),
                   bc_values=None if bc is None else as_torch(bc), **kw)
    (tu ** 2).sum().backward()
    assert tu.shape == (B, jm.n_nodes)
    assert rel_err(tu, ju) <= PARITY
    assert rel_err(tk_.grad, jg) <= PARITY


def test_unported_2d_routes_raise():
    jm = jax_mesh(JMesh.rectangle, 4, 4, dtype=jnp.float64)
    tm = port_mesh(jm)
    f = torch.ones(tm.n_nodes, dtype=torch.float64)
    eye = torch.eye(2, dtype=torch.float64)
    u_stencil = t_solve(tm, 1.0, f)
    # tensor κ leaves the stencil route for the generic assembly (dense)
    assert rel_err(t_solve(tm, eye, f), u_stencil) <= 1e-12
    with pytest.raises(ValueError, match="tensor-valued"):
        t_solve(tm, eye, f, method="stencil")
    # natural terms take the generalized-mask stencil solver
    # (ops/stencil_natural.py, tests/test_torch_stencil_natural.py)
    assert rel_err(t_solve(tm, 1.0, f, neumann=torch.zeros_like(f)),
                   u_stencil) <= 1e-9
    # a non-factory Dirichlet mask that keeps the grid metadata
    mask = np.asarray(jm.bc_mask).copy()
    mask[6] = 1.0
    pinned = TMesh.from_arrays(np.asarray(jm.nodes), np.asarray(jm.elements),
                               mask, np.zeros_like(mask), device="cpu",
                               grid=port_grid(jm.grid))
    u_dense = t_solve(pinned, 1.0, f, method="dense")
    assert rel_err(t_solve(pinned, 1.0, f), u_dense) <= 1e-9
    uB = t_solve_b(pinned, 1.0, f.expand(2, -1), cg_tol=0.0, cg_maxiter=8)
    assert rel_err(uB, u_dense.expand(2, -1)) <= 1e-9
    # fit_kappa drops the grid of a replaced mask: the generic routes
    _, info = t_fit(pinned, f, f, steps=2)
    assert info["path"] == "generic_adam"
    # with_dirichlet drops the grid: the generic routes (slice E)
    u_pin = t_solve(tm.with_dirichlet([6], 0.1), 1.0, f)
    assert abs(float(u_pin[6]) - 0.1) <= 1e-14
    assert rel_err(u_pin, t_solve(tm.with_dirichlet([6], 0.1), 1.0, f,
                                  method="cg")) <= 1e-9
    # the generic methods solve the stencil route's system
    for method in ("dense", "lu", "cg"):
        assert rel_err(t_solve(tm, 1.0, f, method=method), u_stencil) \
            <= 1e-9
