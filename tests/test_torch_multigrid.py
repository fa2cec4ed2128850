"""Parity of the PyTorch port's geometric multigrid (ops/multigrid.py,
ops/multigrid3.py) with the JAX package, on the same numpy inputs (f64):
the transfers, hierarchies and cycles against JAX's, the batch-leading 3D
MG gradient step against JAX's batch-minor one, and the MG-CG solves and
their gradients against the converged Jacobi-PCG structured solves (the
port's, held to JAX's in tests/test_torch_stencil*.py: one JAX compile
less each).

The JAX modules are imported here, eagerly: ops/multigrid.py builds a
module-level ``jnp.array``, which a first import inside a ``jax.jit``
trace would turn into a leaked tracer."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from difffe_tpu.ops import multigrid as jmg
from difffe_tpu.ops import multigrid3 as jmg3
from difffe_tpu.ops import stencil as jst
from difffe_tpu.ops import stencil3d as js3
from difffe_tpu_torch.ops import multigrid as tmg
from difffe_tpu_torch.ops import multigrid3 as tmg3
from difffe_tpu_torch.ops import pcg as tpcg
from difffe_tpu_torch.ops import stencil as tst
from difffe_tpu_torch.ops import stencil3d as ts3
from torch_parity import as_torch, port_grid, rel_err

torch.set_num_threads(1)

EXACT = 1e-12      # the same f64 operations, other summation order
SOLVE = 1e-9       # an MG-CG solve to 1e-12 against a converged Jacobi one
STEP = 1e-9        # the 3D step's loss, gradient and state against JAX's

N2 = 8             # 2D grid: two levels (8² → 4²)
N3, B3 = 4, 3      # 3D box: two levels (4³ → 2³), three scenarios
# the 3D step's cycle, kept short so the JAX reference compiles quickly
CYCLE = dict(pre=1, post=1, coarse_sweeps=1)
STEP_ITERS = 4


def _problem_2d(seed=0):
    rng = np.random.default_rng(seed)
    kl = 1.0 + rng.random((N2, N2))
    ku = 1.0 + rng.random((N2, N2))
    f = rng.standard_normal((N2 + 1, N2 + 1))
    g = 0.2 * rng.standard_normal((N2 + 1, N2 + 1))
    w = rng.standard_normal((N2 + 1, N2 + 1))
    return kl, ku, f, g, w


def _problem_3d(seed=1):
    rng = np.random.default_rng(seed)
    shape = (N3 + 1,) * 3
    kappa = 1.0 + rng.random((B3, 6 * N3 ** 3))
    f = rng.standard_normal((B3,) + shape)
    g = 0.1 * rng.standard_normal(shape)
    ud = 0.05 * rng.standard_normal((B3,) + shape)
    w = rng.standard_normal(shape)
    return kappa, f, g, ud, w


@pytest.fixture(scope="module")
def jax_ref():
    """Every JAX reference of this module from one jitted function, called
    twice: the second call starts the 3D step from the first call's
    state."""
    jg = jst.StructuredGrid.unit(N2, N2)
    jg3 = js3.StructuredGrid3.unit(N3, N3, N3)
    kl, ku, f, g, w = _problem_2d()
    kappa, f3, g3, ud, w3 = _problem_3d()
    r3 = np.random.default_rng(2).standard_normal((5, 5, 5, B3))
    c3 = np.random.default_rng(3).standard_normal((3, 3, 3, B3))

    def ref(kl, ku, f, kappa, f3, g3, ud, r3, c3, x0, l0):
        out = dict(restrict=jmg.restrict_full_weighting(f),
                   prolong=jmg.prolong_bilinear(f[::2, ::2], f.shape),
                   coarse_kappa=jmg.coarsen_kappa(kl, ku))
        levels = jmg.build_hierarchy(jg, kl, ku)
        out["levels"] = levels
        out["cycles"] = [jmg.v_cycle(levels, f, pre=1, post=1,
                                     coarse_sweeps=2, gamma=gm)
                         for gm in (1, 2)]
        out["restrict3"] = jmg3.restrict_full_weighting_3d(r3)
        out["prolong3"] = jmg3.prolong_trilinear(c3)
        k6bm = jnp.moveaxis(js3.kappa_to_cube(jg3, kappa), 0, -1)
        out["coarse_kappa3"] = jmg3.coarsen_kappa_3d(k6bm)
        out["step"] = jmg3.kappa_mse_grad_step_3d_mg(
            jg3, kappa, f3, g3, ud, STEP_ITERS, warm_state=(x0, l0),
            return_state=True, **CYCLE)
        return out

    fn = jax.jit(ref)
    args = (kl, ku, f, g, w, kappa, f3, g3, ud, w3, r3, c3)
    jargs = (kl, ku, f, kappa, f3, g3, ud, r3, c3)
    # the cold step's state: x0 = m·g broadcast, λ0 = 0 (batch-minor)
    m3 = np.ones((N3 + 1,) * 3)
    m3[1:-1, 1:-1, 1:-1] = 0.0
    x0 = np.broadcast_to((m3 * g3)[..., None], (N3 + 1,) * 3 + (B3,))
    cold = jax.tree_util.tree_map(np.asarray,
                                  fn(*jargs, x0, np.zeros_like(x0)))
    warm = jax.tree_util.tree_map(np.asarray, fn(*jargs, *cold["step"][2]))
    return dict(cold, warm_step=warm["step"], grids=(jg, jg3), args=args)


def test_transfers_2d_match_jax(jax_ref):
    kl, ku, f, *_ = jax_ref["args"]
    tf = as_torch(f)
    assert rel_err(tmg.restrict_full_weighting(tf), jax_ref["restrict"]) \
        <= EXACT
    assert rel_err(tmg.prolong_bilinear(tf[::2, ::2], tf.shape),
                   jax_ref["prolong"]) <= EXACT
    for t, j in zip(tmg.coarsen_kappa(as_torch(kl), as_torch(ku)),
                    jax_ref["coarse_kappa"]):
        assert rel_err(t, j) <= EXACT
    # leading axes are scenarios: a stack transfers each plane alone
    stack = torch.stack([tf, 2.0 * tf])
    assert torch.equal(tmg.restrict_full_weighting(stack)[1],
                       tmg.restrict_full_weighting(2.0 * tf))
    assert torch.equal(tmg.prolong_bilinear(stack[:, ::2, ::2],
                                            tf.shape)[1],
                       tmg.prolong_bilinear(2.0 * tf[::2, ::2], tf.shape))


def test_hierarchy_and_cycles_2d_match_jax(jax_ref):
    kl, ku, f, *_ = jax_ref["args"]
    grid = port_grid(jax_ref["grids"][0])
    levels = tmg.build_hierarchy(grid, as_torch(kl), as_torch(ku))
    assert len(levels) == len(jax_ref["levels"]) == 2
    for tl, jl in zip(levels, jax_ref["levels"]):
        for t, j in zip(tl, jl):
            assert rel_err(t, j) <= EXACT
    for gamma, j in zip((1, 2), jax_ref["cycles"]):
        out = tmg.v_cycle(levels, as_torch(f), pre=1, post=1,
                          coarse_sweeps=2, gamma=gamma)
        assert rel_err(out, j) <= EXACT


def _converged(solve, leaves, w):
    """A solve's value and its gradients to ``leaves`` of <w, u>."""
    u = solve(*leaves)
    grads = torch.autograd.grad((u * w).sum(), leaves)
    return u.detach(), grads


@pytest.mark.parametrize("gamma", [1, 2])
def test_mg_solve_2d_values_and_grads(jax_ref, gamma):
    """The MG-CG solve to 1e-12 and its gradients to κ, f and g against
    the converged Jacobi-PCG solve (ops/stencil.py, held to JAX's in
    tests/test_torch_stencil.py)."""
    kl, ku, f, g, w = jax_ref["args"][:5]
    grid = port_grid(jax_ref["grids"][0])
    leaves = [as_torch(a).requires_grad_() for a in (kl, ku, f, g)]
    u, grads = _converged(lambda kl_, ku_, f_, g_: (
        tmg.solve_poisson_structured_mg(grid, (kl_, ku_), f_, g_, tol=1e-12,
                                        gamma=gamma)), leaves, as_torch(w))
    u_j, grads_j = _converged(lambda kl_, ku_, f_, g_: (
        tst.solve_poisson_structured(grid, (kl_, ku_), f_, g_, 1e-13, 300)),
        leaves, as_torch(w))
    assert rel_err(u, u_j) <= SOLVE
    for t, j in zip(grads, grads_j):
        assert rel_err(t, j) <= SOLVE
    _, iters, rnorm = tmg.mg_diagnostics(grid, (leaves[0].detach(),
                                                leaves[1].detach()),
                                         as_torch(f), as_torch(g), tol=1e-12,
                                         gamma=gamma)
    assert 0 < iters <= 20 and float(rnorm) < 1e-9


def test_mg_solve_2d_batched_is_per_scenario(jax_ref):
    kl, ku, f, g, _ = jax_ref["args"][:5]
    grid = port_grid(jax_ref["grids"][0])
    klB = as_torch(np.stack([kl, 3.0 * kl]))
    kuB = as_torch(np.stack([ku, 0.5 * ku]))
    fB = as_torch(np.stack([f, -2.0 * f]))
    uB = tmg.solve_poisson_structured_mg(grid, (klB, kuB), fB, as_torch(g),
                                         tol=1e-12)
    for i in range(2):
        u1 = tst.solve_poisson_structured(grid, (klB[i], kuB[i]), fB[i],
                                          as_torch(g), 1e-13, 300)
        assert rel_err(uB[i], u1) <= SOLVE
    with pytest.raises(NotImplementedError, match="differentiable once"):
        k = klB.clone().requires_grad_()
        u = tmg.solve_poisson_structured_mg(grid, (k, kuB), fB, as_torch(g))
        torch.autograd.grad(u.sum(), k, create_graph=True)


def test_mg_iterations_nearly_mesh_independent():
    """Jacobi-PCG iteration counts double with the grid side (16² → 32²,
    κ = 1, to 1e-10); the W-cycle's grow by at most 1.6×."""
    its = {}
    for n in (16, 32):
        grid = tst.StructuredGrid.unit(n, n)
        k = torch.ones(n, n, dtype=torch.float64)
        xs = torch.linspace(0.0, 1.0, n + 1, dtype=torch.float64)
        f = torch.outer(torch.sin(np.pi * xs), torch.sin(np.pi * xs))
        u, it_mg, rnorm = tmg.mg_diagnostics(grid, (k, k), f,
                                             torch.zeros_like(f))
        C = tst.stencil_coefficients(grid, k, k)
        m = tst.boundary_mask_grid(grid, torch.float64)
        p = 1.0 - m
        diag = m + p * C[0]
        u_j, it_j, _ = tpcg.pcg(lambda v: tst._operator(C, m, v),
                                p * tst.load_grid(grid, f),
                                lambda r: r / diag, torch.zeros_like(f),
                                1e-10, 1000, with_diagnostics=True)
        assert float(rnorm) < 1e-8 and rel_err(u, u_j) <= 1e-8
        its[n] = (it_mg, it_j)
    assert its[32][0] <= 1.6 * its[16][0], its
    assert its[32][1] >= 1.8 * its[16][1], its


def test_transfers_3d_match_jax(jax_ref):
    """The port's batch-leading transfers against JAX's batch-minor ones."""
    kappa, *_, r3, c3 = jax_ref["args"][5:]
    grid = port_grid(jax_ref["grids"][1])
    lead = np.moveaxis
    assert rel_err(tmg3.restrict_full_weighting_3d(as_torch(lead(r3, -1, 0))),
                   lead(jax_ref["restrict3"], -1, 0)) <= EXACT
    assert rel_err(tmg3.prolong_trilinear(as_torch(lead(c3, -1, 0))),
                   lead(jax_ref["prolong3"], -1, 0)) <= EXACT
    k6 = ts3.kappa_to_cube(grid, as_torch(kappa))
    assert rel_err(tmg3.coarsen_kappa_3d(k6),
                   lead(jax_ref["coarse_kappa3"], -1, 0)) <= EXACT


@pytest.mark.parametrize("layout", ["flat", "cube"])
def test_mg_step_3d_matches_jax_batch_minor(jax_ref, layout):
    """The batch-leading MG gradient step against JAX's batch-minor one:
    loss, κ gradient and state, cold and then warm from the cold state
    (the state round trip, converted between the two layouts)."""
    kappa, f3, g3, ud = jax_ref["args"][5:9]
    grid = port_grid(jax_ref["grids"][1])
    tk = as_torch(kappa)
    if layout == "cube":
        tk = ts3.kappa_to_cube(grid, tk)
    args = (grid, tk, as_torch(f3), as_torch(g3), as_torch(ud), STEP_ITERS)
    loss, gk, state = tmg3.kappa_mse_grad_step_3d_mg(
        *args, return_state=True, **CYCLE)
    j_loss, j_gk, j_state = jax_ref["step"]
    assert abs(float(loss) - float(j_loss)) <= STEP * abs(float(j_loss))
    assert gk.shape == tk.shape
    assert rel_err(gk.reshape(B3, -1), j_gk) <= STEP
    for t, j in zip(state, j_state):
        assert rel_err(t, np.moveaxis(j, -1, 0)) <= STEP
    w_loss, w_gk = tmg3.kappa_mse_grad_step_3d_mg(
        *args, warm_state=state, **CYCLE)
    j_wloss, j_wgk, _ = jax_ref["warm_step"]
    assert abs(float(w_loss) - float(j_wloss)) <= STEP * abs(float(j_wloss))
    assert rel_err(w_gk.reshape(B3, -1), j_wgk) <= STEP


def test_mg_step_3d_converges_to_the_jacobi_step(jax_ref):
    """At convergence-level iteration counts the MG step and the Jacobi
    step give the same loss and κ gradient (the JAX test's check, here at
    the default cycle)."""
    kappa, f3, g3, ud = jax_ref["args"][5:9]
    grid = port_grid(jax_ref["grids"][1])
    args = (grid, as_torch(kappa), as_torch(f3), as_torch(g3), as_torch(ud))
    loss_m, gk_m = tmg3.kappa_mse_grad_step_3d_mg(*args, iters=20)
    loss_j, gk_j = ts3.kappa_mse_grad_step_3d(*args, iters=60)
    assert abs(float(loss_m) - float(loss_j)) <= 1e-10 * float(loss_j)
    assert rel_err(gk_m, gk_j) <= 1e-8
    with pytest.raises(ValueError, match="batched 3D"):
        tmg3.kappa_mse_grad_step_3d_mg(grid, as_torch(kappa[0]),
                                       as_torch(f3), as_torch(g3),
                                       as_torch(ud), 2)


def test_mg_solve_3d_values_and_grads(jax_ref):
    """The 3D MG-CG solve to 1e-12 and its gradients against the
    converged Jacobi-PCG box solve (ops/stencil3d.py, held to JAX's in
    tests/test_torch_stencil3d.py); a batched solve is per scenario."""
    kappa, f3, g3, _, w3 = jax_ref["args"][5:10]
    grid = port_grid(jax_ref["grids"][1])
    leaves = [as_torch(a).requires_grad_() for a in (kappa[0], f3[0], g3)]
    u, grads = _converged(lambda k_, f_, g_: (
        tmg3.solve_poisson_structured_3d_mg(grid, k_, f_, g_, tol=1e-12)),
        leaves, as_torch(w3))
    u_j, grads_j = _converged(lambda k_, f_, g_: (
        ts3.solve_poisson_structured_3d(grid, k_, f_, g_, 1e-13, 300)),
        leaves, as_torch(w3))
    assert rel_err(u, u_j) <= SOLVE
    for t, j in zip(grads, grads_j):
        assert rel_err(t, j) <= SOLVE
    uB, iters, rnorm = tmg3.mg3_diagnostics(grid, as_torch(kappa),
                                            as_torch(f3), as_torch(g3),
                                            tol=1e-12)
    assert uB.shape == (B3,) + grid.node_shape and rnorm.shape == (B3,)
    assert 0 < iters <= 20 and float(rnorm.max()) < 1e-9
    assert rel_err(uB[0], u_j) <= SOLVE
    levels = tmg3.build_hierarchy_bm(grid, ts3.kappa_to_cube(
        grid, as_torch(kappa)))
    assert len(levels) == 2
    b = levels[0][1].new_ones((B3,) + grid.node_shape)
    x = tmg3.pcg_mg_bm(levels, b * (1.0 - levels[0][1]), torch.zeros_like(b),
                       1e-12, 50)
    A = ts3._operator(levels[0][0], levels[0][1], x)
    assert rel_err(A, b * (1.0 - levels[0][1])) <= 1e-10
