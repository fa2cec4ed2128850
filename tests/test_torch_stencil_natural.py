"""Parity of the PyTorch port's natural-BC structured solvers
(ops/stencil_natural.py: the Robin fold, the generalized-mask PCG and its
kernel route on K3a) and of the facade's routes that reach them, with the
JAX package, on the same numpy inputs (f64).  The kernel route runs K3a's
plain version here; JAX's runs its Pallas kernel in interpret mode."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import difffe_tpu.ops.stencil_natural as jnat_mod
import difffe_tpu.solver as jsolver_mod
import difffe_tpu_torch.ops.stencil_natural as tnat_mod
import difffe_tpu_torch.solver as tsolver_mod
from difffe_tpu.mesh import FEMesh as JMesh
from difffe_tpu.ops import stencil as jst
from difffe_tpu.ops.robin import RobinBC as JRobin
from difffe_tpu_torch.ops import stencil_natural as tnat
from difffe_tpu_torch.ops.neumann import boundary_edges, edge_flux_load
from difffe_tpu_torch.ops.robin import RobinBC as TRobin
from difffe_tpu_torch.ops.robin import robin_edges
from difffe_tpu_torch.solver import solve_poisson as t_solve
from difffe_tpu_torch.solver import solve_poisson_batched as t_solve_b
from torch_parity import as_torch, jax_mesh, port_grid, port_mesh, rel_err

torch.set_num_threads(1)

F64 = torch.float64
EXACT = 1e-12      # same f64 algorithm, other summation order
KERNEL = 1e-10     # K3a's plain version against JAX's kernel, 6 iterations
ROUTE = 1e-9       # a converged structured solve against the dense route

NX, NY, B = 6, 5, 3
KB_ITERS = 6       # the kernel route's fixed trip at 8²


def _right(p):
    return abs(p[0] - 1.0) < 1e-12


def _problem(seed=0):
    """A left-Dirichlet rectangle's grids: κ pair, f, g, mask, a batched
    Neumann load, axis-adjacent Robin planes and load (numpy f64)."""
    jg = jst.StructuredGrid.unit(NX, NY)
    H, W = jg.node_shape
    rng = np.random.default_rng(seed)
    kl = 1.0 + rng.random((B, NY, NX))
    ku = 1.0 + rng.random((B, NY, NX))
    f = rng.standard_normal((B, H, W))
    g = 0.2 * rng.standard_normal((H, W))
    m = np.zeros((H, W))
    m[:, 0] = 1.0
    m[2, 3] = 1.0                       # an interior pin
    qn = np.zeros((B, H, W))
    qn[:, :, -1] = rng.standard_normal((B, H))
    Cr = np.zeros((7, H, W))
    Cr[0, :, -1] = 0.4 + rng.random(H)
    Cr[3, :-1, -1] = 0.1
    Cr[4, 1:, -1] = 0.1
    rl = np.zeros((H, W))
    rl[:, -1] = rng.standard_normal(H)
    w = rng.standard_normal((B, H, W))
    return jg, (kl, ku, f, g, m, qn, Cr, rl, w)


def _coo(pairs, vals):
    rows = np.asarray([r for r, _ in pairs])
    cols = np.asarray([c for _, c in pairs])
    return rows, cols, np.asarray(vals, np.float64)


# axis-adjacent (center, ±x, ±y), foldable but diagonal, not foldable
ADJ = [(8, 8), (8, 9), (9, 8), (8, 15), (15, 8)]
DIAG = [(9, 15), (15, 9)]                # offset (+1, −1): plane 5
FAR = [(8, 20)]


@pytest.fixture(scope="module")
def jax_ref():
    """Every JAX reference of this module, from one jitted call."""
    jg, arrays = _problem()
    jg8 = jst.StructuredGrid.unit(8, 8)
    rng = np.random.default_rng(1)
    k8 = 1.0 + rng.random((2, B, 8, 8))
    f8 = rng.standard_normal((B, 9, 9))
    g8 = 0.1 * rng.standard_normal((9, 9))
    m8 = np.zeros((9, 9))
    m8[:, 0] = 1.0
    qn8 = np.zeros((B, 9, 9))
    qn8[:, :, -1] = 1.0
    Cr8 = np.zeros((B, 7, 9, 9))
    Cr8[:, 0, :, -1] = 0.5
    Cr8[:, 3, :-1, -1] = 0.1
    Cr8[:, 4, 1:, -1] = 0.1
    rl8 = np.zeros((9, 9))
    rl8[:, -1] = 0.3
    w8 = rng.standard_normal((B, 9, 9))
    rows, cols, vals = _coo(ADJ + DIAG, np.linspace(0.1, 0.7, 7))
    load = rng.standard_normal((NX + 1) * (NY + 1))

    def ref(kl, ku, f, g, m, qn, Cr, rl, w, k8, f8, g8, qn8, Cr8, rl8, w8,
            vals, load):
        def pcg_loss(kl, ku, f, g, qn, Cr, rl):
            u = jnat_mod.solve_poisson_structured_natural(
                jg, (kl, ku), f, g, m, qn, Cr, rl, 1e-13, 200)
            return jnp.sum(w * u), u

        (_, u_pcg), g_pcg = jax.value_and_grad(
            pcg_loss, argnums=tuple(range(7)), has_aux=True)(
                kl, ku, f, g, qn, Cr, rl)

        def kernel_loss(kl, ku, f, g, qn, Cr, rl):
            u = jnat_mod.solve_structured_pallas_natural(
                jg8, (kl, ku), f, g, m8, qn, Cr, rl, KB_ITERS, 8)
            return jnp.sum(w8 * u), u

        (_, u_kernel), g_kernel = jax.value_and_grad(
            kernel_loss, argnums=tuple(range(7)), has_aux=True)(
                k8[0], k8[1], f8, g8, qn8, Cr8, rl8)
        fold = jnat_mod.fold_robin_planes(jg, rows, cols, vals, load)
        return dict(u_pcg=u_pcg, g_pcg=g_pcg, u_kernel=u_kernel,
                    g_kernel=g_kernel, fold=fold)

    out = jax.jit(ref)(*arrays, k8, f8, g8, qn8, Cr8, rl8, w8, vals, load)
    return dict(jax.tree_util.tree_map(np.asarray, out), grid=jg,
                arrays=arrays, kernel_args=(jg8, k8, f8, g8, m8, qn8, Cr8,
                                            rl8, w8),
                coo=(rows, cols, vals, load))


def test_fold_and_adjacency_match_jax(jax_ref):
    jg = jax_ref["grid"]
    grid = port_grid(jg)
    rows, cols, vals, load = jax_ref["coo"]
    C_r, rgrid = tnat.fold_robin_planes(grid, torch.tensor(rows),
                                        torch.tensor(cols), as_torch(vals),
                                        as_torch(load))
    assert C_r.shape == (7, NY + 1, NX + 1)
    assert rel_err(C_r, jax_ref["fold"][0]) <= EXACT
    assert rel_err(rgrid, jax_ref["fold"][1]) <= EXACT
    for pairs, adjacent in ((ADJ, True), (ADJ + DIAG, False),
                            (ADJ + FAR, False)):
        r, c, _ = _coo(pairs, np.ones(len(pairs)))
        assert tnat.robin_is_axis_adjacent(grid, r, c) is adjacent
        assert jnat_mod.robin_is_axis_adjacent(jg, r, c) is adjacent
    r, c, v = _coo(ADJ + FAR, np.ones(6))
    for fold, gr in ((tnat.fold_robin_planes, grid),
                     (jnat_mod.fold_robin_planes, jg)):
        with pytest.raises(ValueError, match="non-adjacent"):
            fold(gr, r, c, v, np.zeros((NX + 1) * (NY + 1)))
    # batched entries fold per scenario
    Cb, _ = tnat.fold_robin_planes(grid, rows, cols,
                                   as_torch(np.stack([vals, 2 * vals])),
                                   as_torch(load))
    assert rel_err(Cb[1], 2 * jax_ref["fold"][0]) <= EXACT


def test_natural_pcg_values_and_grads_match_jax(jax_ref):
    """The generalized-mask PCG (batched: per-scenario dots, JAX's vmap)
    with a custom mask, Neumann and Robin terms; gradients to κ, f, g, qn,
    the Robin planes and the Robin load."""
    grid = port_grid(jax_ref["grid"])
    kl, ku, f, g, m, qn, Cr, rl, w = jax_ref["arrays"]
    leaves = [as_torch(a).requires_grad_() for a in (kl, ku, f, g, qn, Cr,
                                                     rl)]
    tkl, tku, tf, tg, tqn, tCr, trl = leaves
    u = tnat.solve_poisson_structured_natural(
        grid, (tkl, tku), tf, tg, as_torch(m), tqn, tCr, trl, 1e-13, 200)
    (u * as_torch(w)).sum().backward()
    assert rel_err(u, jax_ref["u_pcg"]) <= ROUTE
    for t, j in zip(leaves, jax_ref["g_pcg"]):
        assert t.grad.shape == j.shape
        assert rel_err(t.grad, j) <= ROUTE
    with pytest.raises(NotImplementedError, match="differentiable once"):
        u2 = tnat.solve_poisson_structured_natural(
            grid, (tkl, tku), tf, tg, as_torch(m), maxiter=4)
        torch.autograd.grad(u2.sum(), tkl, create_graph=True)


def test_kernel_route_plain_matches_jax_kernel(jax_ref):
    """K3a's plain version on the folded natural planes against JAX's
    Pallas kernel (interpret mode), 8², B = 3, 6 iterations: the solve and
    its gradients (K3a's adjoint)."""
    jg8, k8, f8, g8, m8, qn8, Cr8, rl8, w8 = jax_ref["kernel_args"]
    grid = port_grid(jg8)
    leaves = [as_torch(a).requires_grad_()
              for a in (k8[0], k8[1], f8, g8, qn8, Cr8, rl8)]
    tkl, tku, tf, tg, tqn, tCr, trl = leaves
    u = tnat.solve_structured_pallas_natural(
        grid, (tkl, tku), tf, tg, as_torch(m8), tqn, tCr, trl, KB_ITERS, 8)
    (u * as_torch(w8)).sum().backward()
    assert rel_err(u, jax_ref["u_kernel"]) <= KERNEL
    for t, j in zip(leaves, jax_ref["g_kernel"]):
        assert rel_err(t.grad, j) <= KERNEL
    # an unbatched call takes one scenario
    u0 = tnat.solve_structured_pallas_natural(
        grid, (as_torch(k8[0, 0]), as_torch(k8[1, 0])), as_torch(f8[0]),
        as_torch(g8), as_torch(m8), as_torch(qn8[0]), as_torch(Cr8[0]),
        as_torch(rl8), KB_ITERS, 8)
    assert u0.shape == (9, 9)
    assert rel_err(u0, u.detach()[0]) <= EXACT


# --------------------------------------------------------------------------
# The facade's routes
# --------------------------------------------------------------------------

ROUTES = {"natural_pcg": "solve_poisson_structured_natural",
          "natural_kernel": "solve_structured_pallas_natural"}


def _spy(monkeypatch, taken, port):
    """Record which solver each facade call reaches, in either package."""
    nat = tnat_mod if port else jnat_mod
    solver = tsolver_mod if port else jsolver_mod

    def wrap(module, attr, name):
        fn = getattr(module, attr)

        def spied(*a, **k):
            taken.append(name)
            return fn(*a, **k)

        monkeypatch.setattr(module, attr, spied)

    wrap(nat, ROUTES["natural_pcg"], "natural_pcg")
    wrap(nat, ROUTES["natural_kernel"], "natural_kernel")
    wrap(solver, "solve_dense", "dense")


@pytest.fixture(scope="module")
def meshes():
    """(JAX mesh, port mesh) pairs: left-Dirichlet 6² and an interior pin
    on the factory boundary, both keeping the grid."""
    full = jax_mesh(JMesh.rectangle, 6, 6, dtype=jnp.float64)
    left = np.isclose(np.asarray(full.nodes)[:, 0], 0.0).astype(np.float64)
    pin = np.asarray(full.bc_mask).copy()
    pin[24] = 1.0
    pin_values = np.zeros(full.n_nodes)
    pin_values[24] = 0.7
    out = {}
    for name, mask, values in (("left", left, np.zeros(full.n_nodes)),
                               ("pin", pin, pin_values)):
        jm = dataclasses.replace(full, bc_mask=jnp.asarray(mask),
                                 bc_values=jnp.asarray(values))
        out[name] = (jm, port_mesh(jm))
    return out


def _natural(tm, kind, batched):
    """Neumann load or RobinBC of a case, for both packages."""
    right = boundary_edges(tm, predicate=_right)
    rng = np.random.default_rng(4)
    if kind == "neumann":
        q = rng.standard_normal((B, tm.n_nodes) if batched else tm.n_nodes)
        nm = edge_flux_load(tm, right, as_torch(q)).numpy()
        return dict(neumann=nm), dict(neumann=nm)
    if kind in ("robin", "robin_batched"):
        alpha = (1.0 + rng.random((B, 1))) if kind == "robin_batched" \
            else 1.3
        rb = robin_edges(tm, right, alpha,
                         as_torch(rng.standard_normal(tm.n_nodes)))
    else:                                   # a pattern that does not fold
        rb = TRobin(rows=torch.tensor([8, 30]), cols=torch.tensor([30, 8]),
                    vals=torch.tensor([0.5, 0.5], dtype=F64),
                    load=torch.zeros(tm.n_nodes, dtype=F64))
    jr = JRobin(rows=jnp.asarray(rb.rows.numpy(), jnp.int32),
                cols=jnp.asarray(rb.cols.numpy(), jnp.int32),
                vals=jnp.asarray(rb.vals.numpy()),
                load=jnp.asarray(rb.load.numpy()))
    return dict(robin=jr), dict(robin=rb)


# (mesh, natural term, batched, cg kwargs, expected route of both packages)
FIXED = dict(cg_tol=0.0, cg_maxiter=120)
CASES = [
    ("left", "neumann", False, {}, "natural_pcg"),
    ("pin", None, False, {}, "natural_pcg"),
    ("left", "robin", False, {}, "natural_pcg"),
    ("left", "unfoldable", False, {}, "dense"),
    ("left", "neumann", True, FIXED, "natural_kernel"),
    ("pin", None, True, FIXED, "natural_kernel"),
    ("left", "robin_batched", True, FIXED, "natural_kernel"),
    ("left", "neumann", True, {}, "natural_pcg"),
    ("left", "unfoldable", True, FIXED, "dense"),
    ("left", "neumann", "bc", FIXED, "natural_pcg"),
]


@pytest.mark.parametrize("case", CASES, ids=[
    f"{m}-{k}-{'batched' if b is True else b or 'single'}"
    f"{'-fixed' if kw else ''}" for m, k, b, kw, _ in CASES])
def test_facade_routes_match_jax(monkeypatch, meshes, case):
    """Each call takes the route JAX takes (spied while JAX traces the
    call, which compiles nothing) and solves the system the dense route
    solves."""
    mesh_name, kind, batched, kw, expected = case
    jm, tm = meshes[mesh_name]
    rng = np.random.default_rng(7)
    lead = (B,) if batched else ()
    k = 1.0 + rng.random(lead + (tm.n_elements,))
    f = rng.standard_normal(lead + (tm.n_nodes,))
    bc = None
    if batched == "bc":
        bc = np.asarray(jm.bc_values) + 0.1 * rng.standard_normal(
            (B, tm.n_nodes))
    jnat, tnat_kw = _natural(tm, kind, batched) if kind else ({}, {})
    j_fn = jsolver_mod.solve_poisson_batched if batched \
        else jsolver_mod.solve_poisson
    t_fn = t_solve_b if batched else t_solve
    extra = {} if bc is None else dict(bc_values=bc)

    j_taken, t_taken = [], []
    with monkeypatch.context() as mp:
        _spy(mp, j_taken, port=False)
        jax.make_jaxpr(lambda k_, f_: j_fn(jm, k_, f_, **jnat, **extra,
                                           **kw))(k, f)
    with monkeypatch.context() as mp:
        _spy(mp, t_taken, port=True)
        tk = as_torch(k).requires_grad_()
        u = t_fn(tm, tk, as_torch(f), **tnat_kw, **extra, **kw)
    assert j_taken == [expected] and t_taken == [expected]

    tk_d = as_torch(k).requires_grad_()
    u_d = t_fn(tm, tk_d, as_torch(f), method="dense", **tnat_kw, **extra)
    assert u.shape == u_d.shape == lead + (tm.n_nodes,)
    assert rel_err(u, u_d) <= ROUTE
    w = as_torch(rng.standard_normal(u.shape))
    (u * w).sum().backward()
    (u_d * w).sum().backward()
    assert rel_err(tk.grad, tk_d.grad) <= ROUTE


def test_box_refuses_natural_terms_as_jax():
    jm = jax_mesh(JMesh.box, 2, 2, 2, dtype=jnp.float64)
    tm = port_mesh(jm)
    nm = np.zeros(tm.n_nodes)
    with pytest.raises(ValueError, match="factory"):
        t_solve(tm, 1.0, np.ones(tm.n_nodes), method="stencil", neumann=nm)
    with pytest.raises(ValueError, match="factory"):
        jax.make_jaxpr(lambda f_: jsolver_mod.solve_poisson(
            jm, 1.0, f_, method="stencil", neumann=nm))(np.ones(tm.n_nodes))
    # auto leaves the stencil route for dense, in both packages
    u = t_solve(tm, 1.0, np.ones(tm.n_nodes), neumann=nm)
    assert rel_err(u, t_solve(tm, 1.0, np.ones(tm.n_nodes),
                              method="dense")) <= EXACT
