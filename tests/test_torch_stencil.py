"""Parity of the PyTorch port's 2D structured-grid layer — the rectangle
mesh, the stencil operators, the PCG body and the IFT-differentiated
structured solve — with the JAX package, on the same numpy inputs (f64)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from difffe_tpu.mesh import FEMesh as JMesh
from difffe_tpu.ops import pcg as jpcg
from difffe_tpu.ops import stencil as js
from difffe_tpu.solver import solve_poisson as j_solve
from difffe_tpu_torch.mesh import FEMesh as TMesh
from difffe_tpu_torch.ops import pcg as tpcg
from difffe_tpu_torch.ops import stencil as ts
from difffe_tpu_torch.solver import solve_poisson as t_solve
from torch_parity import as_torch, jax_mesh, port_grid, port_mesh, rel_err

torch.set_num_threads(1)

F64 = torch.float64
EXACT = 1e-12      # same f64 algorithm, other summation order
SOLVE = 1e-9       # CG solves and their gradients


def _grids(n=6, m=5):
    jg = js.StructuredGrid.unit(n, m, (0.0, 1.5), (-0.5, 0.5))
    return jg, port_grid(jg)


def _fields(n=6, m=5, B=None, seed=0):
    """Per-triangle κ (lower, upper), forcing and Dirichlet planes."""
    rng = np.random.default_rng(seed)
    lead = () if B is None else (B,)
    kl = 1.0 + rng.random(lead + (m, n))
    ku = 1.0 + rng.random(lead + (m, n))
    f = rng.standard_normal(lead + (m + 1, n + 1))
    g = 0.3 * rng.standard_normal((m + 1, n + 1))
    return kl, ku, f, g


@pytest.mark.parametrize("args", [
    dict(nx=4, ny=4),
    dict(nx=6, ny=5),
    dict(nx=5, ny=3, x_range=(1e3, 1e3 + 2.0), y_range=(-3.0, -1.5),
         bc_value=0.7),
], ids=["4x4", "6x5", "offset"])
def test_rectangle_matches_jax(args):
    jm = jax_mesh(JMesh.rectangle, dtype=jnp.float64, **args)
    tm = TMesh.rectangle(dtype=F64, device="cpu", **args)
    np.testing.assert_allclose(tm.nodes.numpy(), np.asarray(jm.nodes),
                               rtol=1e-15, atol=1e-15)
    np.testing.assert_array_equal(tm.elements.numpy(),
                                  np.asarray(jm.elements))
    np.testing.assert_array_equal(tm.bc_mask.numpy(), np.asarray(jm.bc_mask))
    np.testing.assert_array_equal(tm.bc_values.numpy(),
                                  np.asarray(jm.bc_values))
    assert tm.grid == port_grid(jm.grid)
    assert (tm.n_nodes, tm.n_elements, tm.dim, tm.n_dirichlet) == \
        (jm.n_nodes, jm.n_elements, jm.dim, jm.n_dirichlet)
    np.testing.assert_array_equal(tm.free_nodes(), jm.free_nodes())
    assert tm.h() == pytest.approx(jm.h(), rel=1e-12)
    assert port_mesh(jm).grid == tm.grid


def test_with_dirichlet_and_from_arrays_grid():
    jm = jax_mesh(JMesh.rectangle, 4, 4, dtype=jnp.float64)
    tm = port_mesh(jm)
    assert tm.grid is not None
    pinned, jpinned = tm.with_dirichlet([6], 0.1), jm.with_dirichlet([6], 0.1)
    assert pinned.grid is None and jpinned.grid is None
    np.testing.assert_array_equal(pinned.bc_values.numpy(),
                                  np.asarray(jpinned.bc_values))
    assert TMesh.from_arrays(np.zeros((2, 1)), np.array([[0, 1]]),
                             np.ones(2), np.zeros(2),
                             device="cpu").grid is None


def test_factories_default_to_the_card():
    """Without ``device`` the factories put the mesh on CUDA; on a host
    without a card that raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default succeeds there")
    for make in (lambda: TMesh.line(30),
                 lambda: TMesh.rectangle(8, 8),
                 lambda: TMesh.box(3, 2, 2),
                 lambda: TMesh.from_arrays(np.zeros((2, 1)),
                                           np.array([[0, 1]]), np.ones(2),
                                           np.zeros(2))):
        with pytest.raises((AssertionError, RuntimeError)):
            make()


@pytest.mark.parametrize("batched", [False, True])
def test_stencil_coefficients(batched):
    jg, tg = _grids()
    kl, ku, _, _ = _fields(B=3 if batched else None)
    ref = ts._stencil_coefficients_reference(tg, as_torch(kl), as_torch(ku))
    got = ts.stencil_coefficients(tg, as_torch(kl), as_torch(ku))
    want, want_ref, (jKl, jKu) = jax.jit(lambda kl, ku: (
        js.stencil_coefficients(jg, kl, ku),
        js._stencil_coefficients_reference(jg, kl, ku),
        js.local_blocks(jg, kl, ku)))(jnp.asarray(kl), jnp.asarray(ku))
    assert got.shape == ref.shape == want.shape
    assert rel_err(got, want) <= EXACT
    assert rel_err(ref, want) <= EXACT
    assert rel_err(ref, want_ref) <= EXACT
    Kl, Ku = ts.local_blocks(tg, as_torch(kl), as_torch(ku))
    assert rel_err(Kl, jKl) <= EXACT and rel_err(Ku, jKu) <= EXACT


def test_stencil_operators():
    jg, tg = _grids()
    B = 3
    kl, ku, f, g = _fields(B=B)
    rng = np.random.default_rng(4)
    u = rng.standard_normal(f.shape)
    lam = rng.standard_normal(f.shape)
    ke = rng.random((B, 2 * 6 * 5))
    C = ts.stencil_coefficients(tg, as_torch(kl), as_torch(ku))

    @jax.jit
    def jax_side(kl, ku, u, f, g, lam, ke):
        jC = js.stencil_coefficients(jg, kl, ku)
        return dict(
            apply=js.stencil_apply(jC, u),
            shifts=[js._shift2d(u, dr, dc) for dr, dc in ts.OFFSETS],
            load=js.load_grid(jg, f),
            kgrad=js.stencil_kappa_grad(jg, lam, u),
            klu=js.kappa_lu_from_elements(jg, ke),
            mask=js.boundary_mask_grid(jg, jnp.float64),
            vjp=js.residual_vjp_manual(jg, (kl[0], ku[0]), f, g, u, lam))

    j = jax_side(*map(jnp.asarray, (kl, ku, u, f, g, lam, ke)))
    assert rel_err(ts.stencil_apply(C, as_torch(u)), j["apply"]) <= EXACT
    for (dr, dc), j_shift in zip(ts.OFFSETS, j["shifts"]):
        assert rel_err(ts._shift2d(as_torch(u), dr, dc) + 1.0,
                       j_shift + 1.0) <= EXACT
    assert rel_err(ts.load_grid(tg, as_torch(f)), j["load"]) <= EXACT
    for a, b in zip(ts.stencil_kappa_grad(tg, as_torch(lam), as_torch(u)),
                    j["kgrad"]):
        assert rel_err(a, b) <= EXACT
    for a, b in zip(ts.kappa_lu_from_elements(tg, as_torch(ke)), j["klu"]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(ts.boundary_mask_grid(tg, F64).numpy(),
                                  np.asarray(j["mask"]))
    # unbatched κ against batched states: cotangents reduce to κ's shape
    got = ts.residual_vjp_manual(tg, (as_torch(kl[0]), as_torch(ku[0])),
                                 as_torch(f), as_torch(g), as_torch(u),
                                 as_torch(lam))
    want = j["vjp"]
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert a.shape == b.shape
        assert rel_err(a, b) <= EXACT


def _pcg_problem(B=3, n=6, seed=1):
    jg, tg = _grids(n, n)
    kl, ku, f, _ = _fields(n, n, B=B, seed=seed)
    jC, jm = jax.jit(lambda kl, ku: (
        js.stencil_coefficients(jg, kl, ku),
        js.boundary_mask_grid(jg, jnp.float64)))(jnp.asarray(kl),
                                                 jnp.asarray(ku))
    tC = ts.stencil_coefficients(tg, as_torch(kl), as_torch(ku))
    tm = ts.boundary_mask_grid(tg, F64)
    # scenario 0 gets a 1e-3 right-hand side: its tol threshold differs
    b = f * np.array([1e-3, 1.0, 3.0][:B])[:, None, None]
    return (lambda v: js._operator(jC, jm, v), jnp.asarray(b),
            lambda v: ts._operator(tC, tm, v), as_torch(b))


@pytest.mark.parametrize("dot", ["global", "batched"])
@pytest.mark.parametrize("mode", ["fixed", "gated", "past_convergence"])
def test_pcg_matches_jax(dot, mode):
    jA, jb, tA, tb = _pcg_problem()
    tol, maxiter = {"fixed": (0.0, 12), "gated": (1e-10, 200),
                    "past_convergence": (0.0, 300)}[mode]
    jdot = None if dot == "global" else jpcg.batched_dot(2)
    tdot = None if dot == "global" else tpcg.batched_dot(2)
    jx, jit_, jr = jax.jit(lambda b: jpcg.pcg(
        jA, b, lambda r: r, jnp.zeros_like(b), tol, maxiter, dot=jdot,
        with_diagnostics=True))(jb)
    tx, tit, tr = tpcg.pcg(tA, tb, lambda r: r, torch.zeros_like(tb), tol,
                           maxiter, dot=tdot, with_diagnostics=True)
    assert torch.isfinite(tx).all()
    assert tit == int(jit_)
    assert rel_err(tx, jx) <= 1e-10
    if mode == "gated":
        assert 0 < tit < maxiter
    if mode != "fixed":
        x_ref = np.stack([np.linalg.solve(_dense(tA, tb.shape[1:], s),
                                          tb[s].numpy().ravel())
                          for s in range(tb.shape[0])])
        assert rel_err(tx.reshape(x_ref.shape), x_ref) <= 1e-6


def _dense(A, shape, s):
    """Scenario s of the batched operator as a dense matrix."""
    n = math.prod(shape)
    eye = torch.eye(n, dtype=F64).reshape((n,) + tuple(shape))
    cols = []
    for e in eye:
        v = torch.zeros((3,) + tuple(shape), dtype=F64)
        v[s] = e
        cols.append(A(v)[s].reshape(-1))
    return torch.stack(cols, dim=1).numpy()


@pytest.mark.parametrize("batched", [False, True])
def test_solve_poisson_structured_value_and_grads(batched):
    jg, tg = _grids()
    kl, ku, f, g = _fields(B=2 if batched else None, seed=3)
    w = np.random.default_rng(5).standard_normal(f.shape)

    def jloss(kl_, ku_, f_, g_):
        u = js.solve_poisson_structured(jg, (kl_, ku_), f_, g_)
        return jnp.sum(jnp.asarray(w) * u), u

    (_, ju), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3), has_aux=True))(
        *map(jnp.asarray, (kl, ku, f, g)))
    targs = [as_torch(a).requires_grad_() for a in (kl, ku, f, g)]
    tu = ts.solve_poisson_structured(tg, tuple(targs[:2]), *targs[2:])
    (as_torch(w) * tu).sum().backward()
    assert rel_err(tu, ju) <= SOLVE
    for t, j in zip(targs, jgrads):
        assert t.grad.shape == j.shape
        assert rel_err(t.grad, j) <= SOLVE


def test_double_backward_matches_jax():
    """Second derivative of a misfit through the 2D facade (the apply_inv
    backward recurses into itself, as the JAX custom VJP does)."""
    jm = jax_mesh(JMesh.rectangle, 6, 6, dtype=jnp.float64)
    tm = port_mesh(jm)
    x, y = np.asarray(jm.nodes).T
    f = 2 * np.pi ** 2 * np.sin(np.pi * x) * np.sin(np.pi * y)
    ud = 0.5 * np.asarray(jax.jit(lambda f: j_solve(jm, 2.0, f))(
        jnp.asarray(f)))

    def jloss(lk):
        u = j_solve(jm, jnp.exp(lk), jnp.asarray(f))
        return jnp.mean((u - ud) ** 2)

    lk = torch.tensor(0.3, dtype=F64, requires_grad=True)
    loss = ((t_solve(tm, torch.exp(lk), as_torch(f)) - as_torch(ud)) ** 2
            ).mean()
    (g1,) = torch.autograd.grad(loss, lk, create_graph=True)
    (g2,) = torch.autograd.grad(g1, lk)
    jg1, jg2 = jax.jit(jax.value_and_grad(jax.grad(jloss)))(0.3)
    assert float(g1.detach()) == pytest.approx(float(jg1), rel=1e-8)
    assert float(g2) == pytest.approx(float(jg2), rel=1e-7)
