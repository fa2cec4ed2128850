"""Parity of the PyTorch port's 3D structured-box layer — the box mesh, the
7-point stencil operators, the IFT-differentiated box solves, the plain
gradient step and the box routes of the facade — with the JAX package, on
the same numpy inputs (f64).  Every grid is non-cubic, so a transposed
axis or a swapped tet table cannot go unseen."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from difffe_tpu.mesh import FEMesh as JMesh
from difffe_tpu.ops import stencil3d as js
from difffe_tpu.solver import solve_poisson as j_solve
from difffe_tpu.solver import solve_poisson_batched as j_solve_b
from difffe_tpu_torch.mesh import FEMesh as TMesh
from difffe_tpu_torch.ops import stencil3d as ts
from difffe_tpu_torch.ops.assembly import element_family
from difffe_tpu_torch.solver import solve_poisson as t_solve
from difffe_tpu_torch.solver import solve_poisson_batched as t_solve_b
from torch_parity import as_torch, jax_mesh, port_grid, port_mesh, rel_err

torch.set_num_threads(1)

F64 = torch.float64
EXACT = 1e-12      # same f64 algorithm, other summation order
SOLVE = 1e-10      # CG solves and their gradients
FACADE = 1e-9      # the facade's routes against JAX's


def _grids(nx=4, ny=3, nz=5):
    jg = js.StructuredGrid3.unit(nx, ny, nz, (0.0, 1.5), (-0.5, 0.5),
                                 (0.0, 2.0))
    return jg, port_grid(jg)


def _fields(nx=4, ny=3, nz=5, B=None, seed=0):
    """Per-tet κ (flat), forcing and Dirichlet boxes."""
    rng = np.random.default_rng(seed)
    lead = () if B is None else (B,)
    k = 1.0 + rng.random(lead + (6 * nx * ny * nz,))
    f = rng.standard_normal(lead + (nz + 1, ny + 1, nx + 1))
    g = 0.3 * rng.standard_normal((nz + 1, ny + 1, nx + 1))
    return k, f, g


@pytest.mark.parametrize("args", [
    dict(nx=3, ny=4, nz=2),
    dict(nx=1, ny=2, nz=3),
    dict(nx=2, ny=3, nz=2, x_range=(1e3, 1e3 + 2.0), y_range=(-3.0, -1.5),
         z_range=(0.5, 1.0), bc_value=0.7),
], ids=["3x4x2", "1x2x3", "offset"])
def test_box_matches_jax(args):
    jm = jax_mesh(JMesh.box, dtype=jnp.float64, **args)
    tm = TMesh.box(dtype=F64, device="cpu", **args)
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
    assert element_family(tm) == "p1_tet"
    assert port_mesh(jm).grid == tm.grid


@pytest.mark.parametrize("kappa_layout", ["flat", "cube"])
@pytest.mark.parametrize("batched", [False, True])
def test_stencil3d_coefficients(batched, kappa_layout):
    jg, tg = _grids()
    k, _, _ = _fields(B=3 if batched else None)
    if kappa_layout == "cube":
        k = k.reshape(k.shape[:-1] + (5, 3, 4, 6))
    got = ts.stencil3d_coefficients(tg, as_torch(k))
    want, jk6, jedges = jax.jit(lambda k: (
        js.stencil3d_coefficients(jg, k), js.kappa_to_cube(jg, k),
        js.edge_coefficients(jg, js.kappa_to_cube(jg, k))))(jnp.asarray(k))
    assert got.shape == want.shape
    assert rel_err(got, want) <= EXACT
    k6 = ts.kappa_to_cube(tg, as_torch(k))
    np.testing.assert_array_equal(k6.numpy(), np.asarray(jk6))
    for a, b in zip(ts.edge_coefficients(tg, k6), jedges):
        assert a.shape == b.shape
        assert rel_err(a, b) <= EXACT


def test_stencil3d_operators():
    jg, tg = _grids()
    B = 3
    k, f, g = _fields(B=B)
    rng = np.random.default_rng(4)
    u = rng.standard_normal(f.shape)
    lam = rng.standard_normal(f.shape)
    C = ts.stencil3d_coefficients(tg, as_torch(k))

    @jax.jit
    def jax_side(k, u, f, lam):
        jC = js.stencil3d_coefficients(jg, k)
        return (js.stencil3d_apply(jC, u),
                [js._shift3d(u, *off) for off in ts.OFFSETS3],
                js.load_box(jg, f), js.stencil3d_kappa_grad(jg, lam, u))

    j_apply, j_shifts, j_load, j_kgrad = jax_side(
        *map(jnp.asarray, (k, u, f, lam)))
    assert rel_err(ts.stencil3d_apply(C, as_torch(u)), j_apply) <= EXACT
    for off, j_shift in zip(ts.OFFSETS3, j_shifts):
        assert rel_err(ts._shift3d(as_torch(u), *off) + 1.0,
                       j_shift + 1.0) <= EXACT
    assert rel_err(ts.load_box(tg, as_torch(f)), j_load) <= EXACT
    assert rel_err(ts.stencil3d_kappa_grad(tg, as_torch(lam), as_torch(u)),
                   j_kgrad) <= EXACT
    np.testing.assert_array_equal(
        ts.boundary_mask_box(tg, F64).numpy(),
        np.asarray(js.boundary_mask_box(jg, jnp.float64)))
    # unbatched κ against batched states: cotangents reduce to κ's shape;
    # a cube-shaped κ keeps its layout
    j_vjp = jax.jit(lambda kk, f, g, u, lam: js.residual_vjp_manual_3d(
        jg, kk, f, g, u, lam))
    for kk in (k[0], k[0].reshape(5, 3, 4, 6), k):
        got = ts.residual_vjp_manual_3d(tg, as_torch(kk), as_torch(f),
                                        as_torch(g), as_torch(u),
                                        as_torch(lam))
        want = j_vjp(*map(jnp.asarray, (kk, f, g, u, lam)))
        for a, b in zip(got, want):
            assert a.shape == b.shape
            assert rel_err(a, b) <= EXACT


@pytest.mark.parametrize("batched", [False, True])
def test_solve_poisson_structured_3d_value_and_grads(batched):
    jg, tg = _grids()
    k, f, g = _fields(B=2 if batched else None, seed=3)
    w = np.random.default_rng(5).standard_normal(f.shape)

    def jloss(k_, f_, g_):
        u = js.solve_poisson_structured_3d(jg, k_, f_, g_)
        return jnp.sum(jnp.asarray(w) * u), u

    (_, ju), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True))(*map(jnp.asarray, (k, f, g)))
    targs = [as_torch(a).requires_grad_() for a in (k, f, g)]
    tu = ts.solve_poisson_structured_3d(tg, *targs)
    (as_torch(w) * tu).sum().backward()
    assert rel_err(tu, ju) <= SOLVE
    for t, j in zip(targs, jgrads):
        assert t.grad.shape == j.shape
        assert rel_err(t.grad, j) <= SOLVE


def test_batched_solve_matches_jax_batch_minor():
    """The batch-leading per-scenario solve against JAX's batch-minor one,
    values and (κ, f, g) gradients, with a shared and a batched g."""
    jg, tg = _grids()
    k, f, g = _fields(B=3, seed=6)
    w = np.random.default_rng(7).standard_normal(f.shape)
    for gg in (g, np.stack([g, 0.5 * g, -g])):
        def jloss(k_, f_, g_):
            u = js.solve_poisson_structured_3d_batched(jg, k_, f_, g_, 0.0,
                                                       40)
            return jnp.sum(jnp.asarray(w) * u), u

        (_, ju), jgrads = jax.jit(jax.value_and_grad(
            jloss, argnums=(0, 1, 2), has_aux=True))(
            *map(jnp.asarray, (k, f, gg)))
        targs = [as_torch(a).requires_grad_() for a in (k, f, gg)]
        tu = ts.solve_poisson_structured_3d_batched(tg, *targs, 0.0, 40)
        (as_torch(w) * tu).sum().backward()
        assert rel_err(tu, ju) <= SOLVE
        for t, j in zip(targs, jgrads):
            assert t.grad.shape == j.shape
            assert rel_err(t.grad, j) <= SOLVE
    solve = ts.choose_3d_path(tg, 3)
    assert rel_err(solve(as_torch(k), as_torch(f), as_torch(g), 0.0, 40),
                   jax.jit(lambda k, f, g: js.choose_3d_path(jg, 128)(
                       k, f, g, 0.0, 40))(jnp.asarray(k), jnp.asarray(f),
                                          jnp.asarray(g))) <= SOLVE
    with pytest.raises(ValueError, match="kappa"):
        ts.solve_poisson_structured_3d_batched(tg, as_torch(k[0]),
                                               as_torch(f), as_torch(g))
    with pytest.raises(ValueError, match="node grid"):
        ts.solve_poisson_structured_3d_batched(tg, as_torch(k),
                                               as_torch(f[0]), as_torch(g))


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_kappa_mse_grad_step_3d_matches_jax(warm):
    """The plain gradient step (the JAX router's 'xla_bm'), its loss,
    κ gradient and threaded state over three SGD steps."""
    jg, tg = _grids()
    k, f, g = _fields(B=3, seed=8)
    ud = 0.05 * np.random.default_rng(9).standard_normal(f.shape)
    jk, tk = jnp.asarray(k), as_torch(k)
    jstate = tstate = None
    jstep = jax.jit(lambda k, st: js.kappa_mse_grad_step_3d(
        jg, k, jnp.asarray(f), jnp.asarray(g), jnp.asarray(ud), 24,
        warm_state=st, return_state=True))
    for _ in range(3):
        jl, jgk, jstate = jstep(jk, jstate if warm else None)
        tl, tgk, tstate = ts.kappa_mse_grad_step_3d(
            tg, tk, as_torch(f), as_torch(g), as_torch(ud), 24,
            warm_state=tstate if warm else None, return_state=True)
        assert tgk.shape == jgk.shape
        assert rel_err(tl, jl) <= SOLVE and rel_err(tgk, jgk) <= SOLVE
        # the port's state is batch-leading, JAX's batch-minor
        for t, j in zip(tstate, jstate):
            assert rel_err(t, jnp.moveaxis(j, -1, 0)) <= SOLVE
        jk, tk = jk - 40.0 * jgk, tk - 40.0 * tgk
    _, gk6 = ts.kappa_mse_grad_step_3d(
        tg, tk.reshape(3, 5, 3, 4, 6), as_torch(f), as_torch(g),
        as_torch(ud), 8)
    assert gk6.shape == (3, 5, 3, 4, 6)


def test_routers():
    """No TPU threshold carries over: the kernel takes every box."""
    for n, B, it in ((4, 4, 32), (16, 256, 32), (32, 128, 100),
                     (64, 32, 100)):
        jg = js.StructuredGrid3.unit(n, n, n)
        tg = port_grid(jg)
        assert ts.choose_3d_grad_step(tg, B, iters=it) == "kernel"
        assert ts.choose_3d_block_b(tg, B, iters=it) == 1
    assert js.choose_3d_grad_step(js.StructuredGrid3.unit(4, 4, 4), 4) == \
        "xla_bm"


def test_double_backward_matches_jax():
    """Second derivative of a misfit through the 3D facade (the
    apply_inv_3d backward recurses into itself, as the JAX custom VJP
    does; tests/test_facade_routing.py's Hessian check)."""
    jm = jax_mesh(JMesh.box, 3, 2, 2, dtype=jnp.float64)
    tm = port_mesh(jm)
    f = np.ones(jm.n_nodes)
    ud = t_solve(tm, 2.0, as_torch(f)).numpy()

    def jloss(lk):
        u = j_solve(jm, jnp.exp(lk), jnp.asarray(f))
        return jnp.mean((u - ud) ** 2)

    lk = torch.tensor(0.3, dtype=F64, requires_grad=True)
    loss = ((t_solve(tm, torch.exp(lk), as_torch(f)) - as_torch(ud)) ** 2
            ).mean()
    (g1,) = torch.autograd.grad(loss, lk, create_graph=True)
    (g2,) = torch.autograd.grad(g1, lk)
    jg1, jg2 = jax.jit(jax.value_and_grad(jax.grad(jloss)))(0.3)
    assert float(g1.detach()) == pytest.approx(float(jg1), rel=1e-6)
    assert float(g2) == pytest.approx(float(jg2), rel=1e-6)


@pytest.mark.parametrize("kappa_kind", ["scalar", "element", "node"])
def test_facade_solve_poisson_3d(kappa_kind):
    jm = jax_mesh(JMesh.box, 3, 2, 4, bc_value=0.4, dtype=jnp.float64)
    tm = port_mesh(jm)
    rng = np.random.default_rng(1)
    kappa = {"scalar": np.float64(1.7),
             "element": 1.0 + rng.random(jm.n_elements),
             "node": 1.0 + rng.random(jm.n_nodes)}[kappa_kind]
    f = rng.standard_normal(jm.n_nodes)
    bc = 0.2 * rng.standard_normal(jm.n_nodes)
    kws = ({}, {"cg_tol": 0.0, "cg_maxiter": 30})

    @jax.jit
    def jax_side(k, f, bc):     # the three JAX references in one compile
        return ([j_solve(jm, k, f, **kw) for kw in kws],
                j_solve(jm, k, f, bc_values=bc))

    jus, ju_bc = jax_side(*map(jnp.asarray, (kappa, f, bc)))
    for kw, ju in zip(kws, jus):
        # JAX's 'auto' resolves to 'stencil' on a box
        for method in ("auto", "stencil"):
            tu = t_solve(tm, as_torch(kappa), as_torch(f), method=method,
                         **kw)
            assert rel_err(tu, ju) <= FACADE
    tu = t_solve(tm, as_torch(kappa), as_torch(f), bc_values=as_torch(bc))
    assert rel_err(tu, ju_bc) <= FACADE


@pytest.mark.parametrize("mode", ["fixed_trip", "tol_gated",
                                  "per_scenario_g", "shared_f",
                                  "batch_minor"])
def test_solve_poisson_batched_3d(mode):
    """The batched box routes, value and κ gradient, against JAX: its
    vmapped per-scenario solves below B = 128 and its batch-minor solve at
    B = 130 (where B is neither n_nodes nor n_elements)."""
    jm = jax_mesh(JMesh.box, 3, 2, 2, dtype=jnp.float64)
    tm = port_mesh(jm)
    rng = np.random.default_rng(3)
    B = 130 if mode == "batch_minor" else 3
    k = 1.0 + rng.random((B, jm.n_elements))
    f = rng.standard_normal((B, jm.n_nodes))
    if mode == "shared_f":
        f = f[0]
    kw = {"cg_tol": 0.0, "cg_maxiter": 40}
    if mode == "tol_gated":
        kw = {"cg_tol": 1e-12, "cg_maxiter": 200}
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
    assert rel_err(tu, ju) <= FACADE
    assert rel_err(tk_.grad, jg) <= FACADE


def test_natural_bcs_on_a_box_raise():
    """The 3D stencil path takes the factory Dirichlet boundary only; the
    port keeps the JAX package's ValueError."""
    jm = jax_mesh(JMesh.box, 3, 2, 2, dtype=jnp.float64)
    tm = port_mesh(jm)
    f = np.ones(jm.n_nodes)
    nm = np.zeros(jm.n_nodes)
    nm[5] = 0.3
    with pytest.raises(ValueError, match="factory"):
        j_solve(jm, 1.0, jnp.asarray(f), method="stencil",
                neumann=jnp.asarray(nm))
    with pytest.raises(ValueError, match="factory"):
        t_solve(tm, 1.0, as_torch(f), method="stencil", neumann=as_torch(nm))
    with pytest.raises(ValueError, match="factory"):
        t_solve_b(tm, 1.0, as_torch(f).expand(2, -1), method="stencil",
                  neumann=as_torch(nm))
    # a non-factory Dirichlet mask that keeps the grid metadata
    mask = np.asarray(jm.bc_mask).copy()
    mask[np.nonzero(mask == 0)[0][0]] = 1.0
    pinned = TMesh.from_arrays(np.asarray(jm.nodes), np.asarray(jm.elements),
                               mask, np.zeros_like(mask), device="cpu",
                               grid=tm.grid)
    with pytest.raises(ValueError, match="factory"):
        t_solve(pinned, 1.0, as_torch(f))
