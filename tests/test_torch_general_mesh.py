"""The port's general-mesh assembly and solves against the JAX package on
the same numpy inputs (f64): P1 triangle and tetrahedron geometry, local
and dense stiffness with scalar, per-node and tensor κ, load and lumped
mass, the matrix-free apply and diagonal, the 'dense'/'lu'/'cg' routes of
``solve_poisson[_batched]`` (and 'auto' on meshes without a grid), edge
Neumann loads and edge Robin terms, and the gradients to κ, f and the node
coordinates.

The meshes are a perturbed 8×8 rectangle and a perturbed 4×4×4 box, built
with ``grid=None`` on both sides (``torch_parity.general_meshes``).  Each
JAX reference runs once per module, in one ``jax.jit`` per mesh.  Applies,
dense solves and fixed-trip CG agree within 1e-10 relative, gradients
within 1e-8.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from difffe_tpu.mesh import FEMesh as JMesh
from difffe_tpu.ops import assembly as jasm
from difffe_tpu.ops import cg as jcg
from difffe_tpu.ops import neumann as jneu
# imported eagerly: its module-level constant (_MID_QUAD) would be a tracer
# of the first jit that imported it
from difffe_tpu.ops import p2 as _jp2  # noqa: F401
from difffe_tpu.ops import robin as jrob
from difffe_tpu.solver import solve_poisson as j_solve
from difffe_tpu.solver import solve_poisson_batched as j_solve_b
from difffe_tpu_torch.mesh import FEMesh as TMesh
from difffe_tpu_torch.ops import assembly as tasm
from difffe_tpu_torch.ops import cg as tcg
from difffe_tpu_torch.ops import neumann as tneu
from difffe_tpu_torch.ops import robin as trob
from difffe_tpu_torch.solver import solve_poisson as t_solve
from difffe_tpu_torch.solver import solve_poisson_batched as t_solve_b
from torch_parity import as_torch, general_meshes, jax_mesh, rel_err

torch.set_num_threads(1)

PARITY = 1e-10
GRAD = 1e-8
CG_ITERS = 200
B = 3


@functools.cache
def _case(dim):
    """(JAX mesh, port mesh, numpy inputs) of the perturbed mesh."""
    if dim == 2:
        jm, tm = general_meshes(JMesh.rectangle, 8, 8)
    else:
        jm, tm = general_meshes(JMesh.box, 4, 4, 4)
    rng = np.random.default_rng(dim)
    x = np.asarray(jm.nodes)
    ne, nn = jm.n_elements, jm.n_nodes
    L = rng.standard_normal((ne, dim, dim)) * 0.3
    arr = dict(
        k_el=1.0 + rng.random(ne),
        k_node=1.0 + rng.random(nn),
        A_el=np.eye(dim) + np.einsum("eij,ekj->eik", L, L),
        A_node=np.eye(dim) * (1.0 + rng.random((nn, 1, 1))),
        A_const=np.eye(dim) + 0.2 * np.ones((dim, dim)),
        f=np.sin(np.pi * x[:, 0]) * np.sin(np.pi * x[:, 1]) + 1.0,
        fB=1.0 + rng.random((B, nn)),
        kB=1.0 + rng.random((B, ne)),
        gB=0.1 * rng.standard_normal((B, nn)),
        u=rng.standard_normal((B, nn)),
    )
    if dim == 2:
        edges = jneu.boundary_edges(jm)
        nodes = np.asarray(jm.nodes)
        right = jneu.boundary_edges(jm, lambda p: p[0] > 1.0 - 1e-9)
        top = jneu.boundary_edges(jm, lambda p: p[1] > 1.0 - 1e-9)
        arr.update(edges=edges, right=right, top=top,
                   q=np.cos(np.pi * nodes[:, 1]),
                   alpha=0.5 + rng.random(len(top)),
                   r_nodal=0.3 + 0.1 * nodes[:, 0])
    return jm, tm, arr


def _jmesh_with(jm, nodes):
    return JMesh(nodes, jm.elements, jm.bc_mask, jm.bc_values)


@functools.cache
def _jref(dim):
    """Every JAX reference value of the module for one mesh, from one
    compiled call."""
    jm, _, a = _case(dim)
    j = {k: jnp.asarray(v) for k, v in a.items()
         if k not in ("edges", "right", "top")}
    free = jnp.asarray(1.0 - np.asarray(jm.bc_mask))

    @jax.jit
    def ref(j):
        out = {}
        out["Ke"] = jasm.local_stiffness(jm, j["k_el"])
        out["Ke_node"] = jasm.local_stiffness(jm, j["k_node"])
        out["Ke_A"] = jasm.local_stiffness(jm, j["A_el"])
        out["Ke_A_node"] = jasm.local_stiffness(jm, j["A_node"])
        out["Ke_A_const"] = jasm.local_stiffness(jm, j["A_const"])
        out["K"] = jasm.assemble_stiffness_dense(jm, j["k_node"])
        out["F"] = jasm.assemble_load(jm, j["fB"])
        out["M"] = jasm.assemble_lumped_mass(jm)
        out["Ku"] = jasm.stiffness_apply(jm, j["k_el"], j["u"])
        out["diag"] = jcg.stiffness_diag(jm, j["k_el"])
        for m in ("dense", "lu"):
            out[m] = j_solve(jm, j["k_el"], j["f"], method=m)
            out[m + "_A"] = j_solve(jm, j["A_el"], j["f"], method=m)
        cg = dict(method="cg", cg_tol=0.0, cg_maxiter=CG_ITERS)
        out["cg"] = j_solve(jm, j["k_el"], j["f"], **cg)
        out["auto"] = j_solve(jm, j["k_el"], j["f"])
        for m, kw in (("dense", {}), ("cg", cg)):
            def loss(k, f, nodes, kw=kw):
                u = j_solve(_jmesh_with(jm, nodes), k, f, **{
                    "method": "dense", **kw})
                return jnp.sum(u ** 2 * free)
            out["grad_" + m] = jax.grad(loss, argnums=(0, 1, 2))(
                j["k_el"], j["f"], jm.nodes)
        out["batched"] = j_solve_b(jm, j["kB"], j["fB"],
                                   bc_values=j["gB"], method="dense")
        out["batched_A"] = j_solve_b(jm, jnp.broadcast_to(
            j["A_el"], (B,) + j["A_el"].shape), j["fB"], method="dense")
        mass = out["M"]
        out["shifted"] = jcg.solve_shifted_cg(jm, j["k_el"], mass, 0.01,
                                              out["F"][0], 0.0, 60)
        if dim == 2:
            nm = jneu.edge_flux_load(jm, a["right"], j["q"])
            rb = jrob.robin_edges(jm, a["top"], j["alpha"], j["r_nodal"])
            out["nm"], out["rb_vals"], out["rb_load"] = nm, rb.vals, rb.load
            for m, kw in (("dense", {}), ("lu", {"method": "lu"}),
                          ("cg", cg)):
                out["bc_" + m] = j_solve(jm, j["k_el"], j["f"], neumann=nm,
                                         robin=rb,
                                         **{"method": "dense", **kw})

            def loss_rb(alpha, k):
                rb_ = jrob.robin_edges(jm, a["top"], alpha, j["r_nodal"])
                u = j_solve(jm, k, j["f"], neumann=nm, robin=rb_, **cg)
                return jnp.sum(u ** 2)
            out["grad_rb"] = jax.grad(loss_rb, argnums=(0, 1))(
                j["alpha"], j["k_el"])
        return out

    return jax.tree_util.tree_map(np.asarray, ref(j))


def _t(a, grad=False):
    return as_torch(a).requires_grad_(grad)


@pytest.fixture(params=[2, 3], ids=["tri", "tet"])
def case(request):
    dim = request.param
    jm, tm, a = _case(dim)
    return dim, tm, a, _jref(dim)


def test_meshes_have_no_grid(case):
    dim, tm, _, _ = case
    assert tm.grid is None and tm.dim == dim
    assert tasm.element_family(tm) == ("p1_tri" if dim == 2 else "p1_tet")


@pytest.mark.parametrize("kind", ["Ke", "Ke_node", "Ke_A", "Ke_A_node",
                                  "Ke_A_const"])
def test_local_stiffness(case, kind):
    _, tm, a, ref = case
    k = {"Ke": "k_el", "Ke_node": "k_node", "Ke_A": "A_el",
         "Ke_A_node": "A_node", "Ke_A_const": "A_const"}[kind]
    assert rel_err(tasm.local_stiffness(tm, _t(a[k])), ref[kind]) <= PARITY


def test_dense_load_mass_apply_diag(case):
    _, tm, a, ref = case
    assert rel_err(tasm.assemble_stiffness_dense(tm, _t(a["k_node"])),
                   ref["K"]) <= PARITY
    assert rel_err(tasm.assemble_load(tm, _t(a["fB"])), ref["F"]) <= PARITY
    assert rel_err(tasm.assemble_lumped_mass(tm), ref["M"]) <= PARITY
    assert rel_err(tasm.stiffness_apply(tm, _t(a["k_el"]), _t(a["u"])),
                   ref["Ku"]) <= PARITY
    assert rel_err(tcg.stiffness_diag(tm, _t(a["k_el"])),
                   ref["diag"]) <= PARITY
    # batched κ keeps its leading axis through the element apply
    kB = _t(a["kB"])
    Ku = tasm.stiffness_apply(tm, kB, _t(a["u"]))
    for b in range(B):
        assert rel_err(Ku[b], tasm.stiffness_apply(
            tm, kB[b], _t(a["u"][b]))) <= 1e-14


@pytest.mark.parametrize("method", ["dense", "lu", "cg"])
@pytest.mark.parametrize("kappa", ["field", "tensor"])
def test_solve_routes(case, method, kappa):
    _, tm, a, ref = case
    k = a["k_el"] if kappa == "field" else a["A_el"]
    kw = dict(cg_tol=0.0, cg_maxiter=CG_ITERS) if method == "cg" else {}
    u = t_solve(tm, _t(k), _t(a["f"]), method=method, **kw)
    dense = "dense" if kappa == "field" else "dense_A"
    if method == "cg" and kappa == "tensor":
        # the JAX fixed-trip CG on tensor κ is not compiled here (test
        # cost): CG_ITERS iterations converge it to the dense solution
        assert rel_err(u, ref[dense]) <= 1e-12
    else:
        assert rel_err(u, ref[method if kappa == "field"
                              else method + "_A"]) <= PARITY
    # every route solves the same system
    assert rel_err(u, ref[dense]) <= 1e-8


def test_auto_takes_dense_without_grid(case):
    _, tm, a, ref = case
    u = t_solve(tm, _t(a["k_el"]), _t(a["f"]))
    assert rel_err(u, ref["auto"]) <= PARITY
    assert rel_err(u, ref["dense"]) <= 1e-14


@pytest.mark.parametrize("method", ["dense", "cg"])
def test_gradients_to_kappa_f_and_nodes(case, method):
    _, tm, a, ref = case
    free = 1.0 - tm.bc_mask
    k, f = _t(a["k_el"], True), _t(a["f"], True)
    nodes = tm.nodes.clone().requires_grad_()
    mesh = TMesh(nodes, tm.elements, tm.bc_mask, tm.bc_values)
    kw = dict(cg_tol=0.0, cg_maxiter=CG_ITERS) if method == "cg" else {}
    u = t_solve(mesh, k, f, method=method, **kw)
    (u ** 2 * free).sum().backward()
    gk, gf, gx = ref["grad_" + method]
    assert rel_err(k.grad, gk) <= GRAD
    assert rel_err(f.grad, gf) <= GRAD
    assert rel_err(nodes.grad, gx) <= GRAD
    assert float(nodes.grad.abs().max()) > 1e-10


@pytest.mark.parametrize("method", ["dense", "cg"])
def test_batched_generic_route(case, method):
    _, tm, a, ref = case
    kw = dict(cg_tol=0.0, cg_maxiter=CG_ITERS) if method == "cg" else {}
    u = t_solve_b(tm, _t(a["kB"]), _t(a["fB"]), method=method,
                  bc_values=_t(a["gB"]), **kw)
    assert u.shape == (B, tm.n_nodes)
    # the JAX reference is its dense route ('cg' with CG_ITERS fixed
    # iterations converges to it)
    assert rel_err(u, ref["batched"]) <= (PARITY if method == "dense"
                                          else 1e-12)


def test_batched_tensor_kappa_and_shifted_solve(case):
    _, tm, a, ref = case
    A = _t(a["A_el"]).expand((B,) + a["A_el"].shape)
    u = t_solve_b(tm, A, _t(a["fB"]), method="dense")
    assert rel_err(u, ref["batched_A"]) <= PARITY
    M = tasm.assemble_lumped_mass(tm)
    F = tasm.assemble_load(tm, _t(a["fB"]))[0]
    us = tcg.solve_shifted_cg(tm, _t(a["k_el"]), M, 0.01, F, 0.0, 60)
    assert rel_err(us, ref["shifted"]) <= PARITY


def test_tol_gated_cg_converges_to_dense(case):
    _, tm, a, ref = case
    u = t_solve(tm, _t(a["k_el"]), _t(a["f"]), method="cg")
    assert rel_err(u, ref["dense"]) <= 1e-9
    x, iters, res = tcg.cg_diagnostics(
        tm, _t(a["k_el"]), tasm.assemble_load(tm, _t(a["f"])), 1e-12,
        CG_ITERS)
    assert 0 < iters < CG_ITERS and float(res) <= 1e-12
    assert rel_err(x, ref["dense"]) <= 1e-9


def _tri():
    _, tm, a = _case(2)
    return tm, a, _jref(2)


def test_edge_helpers_match():
    tm, a, ref = _tri()
    np.testing.assert_array_equal(tneu.boundary_edges(tm), a["edges"])
    right = tneu.boundary_edges(tm, lambda p: p[0] > 1.0 - 1e-9)
    np.testing.assert_array_equal(right, a["right"])
    assert len(right) == 8
    assert rel_err(tneu.edge_flux_load(tm, right, _t(a["q"])),
                   ref["nm"]) <= PARITY
    rb = trob.robin_edges(tm, a["top"], _t(a["alpha"]), _t(a["r_nodal"]))
    assert rel_err(rb.vals, ref["rb_vals"]) <= PARITY
    assert rel_err(rb.load, ref["rb_load"]) <= PARITY
    # batched α and r keep their leading axes; edges may come as tensors
    rbB = trob.robin_edges(tm, torch.as_tensor(a["top"]),
                           _t(np.stack([a["alpha"]] * 2)),
                           _t(np.stack([a["r_nodal"]] * 2)))
    assert rbB.vals.shape == (2, 4 * len(a["top"]))
    assert rel_err(rbB.load[1], ref["rb_load"]) <= PARITY


@pytest.mark.parametrize("method", ["dense", "lu", "cg"])
def test_edge_neumann_and_robin_solves(method):
    tm, a, ref = _tri()
    nm = tneu.edge_flux_load(tm, a["right"], _t(a["q"]))
    rb = trob.robin_edges(tm, a["top"], _t(a["alpha"]), _t(a["r_nodal"]))
    kw = dict(cg_tol=0.0, cg_maxiter=CG_ITERS) if method == "cg" else {}
    u = t_solve(tm, _t(a["k_el"]), _t(a["f"]), method=method, neumann=nm,
                robin=rb, **kw)
    assert rel_err(u, ref["bc_" + method]) <= PARITY


def test_robin_gradients_through_cg():
    tm, a, ref = _tri()
    alpha, k = _t(a["alpha"], True), _t(a["k_el"], True)
    nm = tneu.edge_flux_load(tm, a["right"], _t(a["q"]))
    rb = trob.robin_edges(tm, a["top"], alpha, _t(a["r_nodal"]))
    u = t_solve(tm, k, _t(a["f"]), method="cg", cg_tol=0.0,
                cg_maxiter=CG_ITERS, neumann=nm, robin=rb)
    (u ** 2).sum().backward()
    assert rel_err(alpha.grad, ref["grad_rb"][0]) <= GRAD
    assert rel_err(k.grad, ref["grad_rb"][1]) <= GRAD


def test_degenerate_triangle_contributes_nothing():
    nodes = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0], [0.5, 0.5]])
    tm = TMesh.from_arrays(nodes, np.array([[0, 1, 2], [1, 3, 2]]),
                           np.array([1.0, 1.0, 1.0, 0.0]), np.zeros(4),
                           device="cpu")
    x = tm.nodes.clone().requires_grad_()
    mesh = TMesh(x, tm.elements, tm.bc_mask, tm.bc_values)
    Ke = tasm.local_stiffness(mesh, 1.0)
    assert torch.all(Ke[1] == 0) and float(Ke[0].detach().abs().max()) > 0.1
    F = tasm.assemble_load(mesh, torch.ones(4, dtype=torch.float64))
    assert float(F[3].detach()) == 0.0
    (Ke.sum() + F.sum()).backward()
    assert torch.isfinite(x.grad).all()
    tet = TMesh.from_arrays(np.array([[0, 0, 0], [1, 0, 0], [2, 0, 0],
                                      [0, 1, 0.0]]), np.array([[0, 1, 2, 3]]),
                            np.ones(4), np.zeros(4), device="cpu")
    assert torch.all(tasm.local_stiffness(tet, 1.0) == 0)


def test_cg_is_differentiable_once():
    tm, a, _ = _tri()
    k = _t(a["k_el"], True)
    u = t_solve(tm, k, _t(a["f"]), method="cg", cg_tol=0.0, cg_maxiter=20)
    (g,) = torch.autograd.grad((u ** 2).sum(), k, create_graph=False)
    assert torch.isfinite(g).all()
    u = t_solve(tm, k, _t(a["f"]), method="cg", cg_tol=0.0, cg_maxiter=20)
    with pytest.raises(NotImplementedError, match="differentiable once"):
        torch.autograd.grad((u ** 2).sum(), k, create_graph=True)


# ---------------------------------------------------------------------------
# P2 lines and triangles (ops/p2.py), through the same generic routes
# ---------------------------------------------------------------------------


@functools.cache
def _p2_case(family):
    if family == "line":
        jm = jax_mesh(JMesh.line_p2, 6, dtype=jnp.float64)
        tm = TMesh.line_p2(6, dtype=torch.float64, device="cpu")
    else:
        jm = jax_mesh(JMesh.rectangle_p2, 3, 2, dtype=jnp.float64)
        tm = TMesh.rectangle_p2(3, 2, dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(6)
    x = np.asarray(jm.nodes)[:, 0]
    a = dict(k_el=1.0 + rng.random(jm.n_elements),
             k_node=1.0 + rng.random(jm.n_nodes),
             f=np.pi ** 2 * np.sin(np.pi * x) + 1.0,
             fB=1.0 + rng.random((B, jm.n_nodes)),
             kB=1.0 + rng.random((B, jm.n_elements)))

    @jax.jit
    def ref(j):
        out = {"Ke": jasm.local_stiffness(jm, j["k_el"]),
               "K": jasm.assemble_stiffness_dense(jm, j["k_node"]),
               "F": jasm.assemble_load(jm, j["fB"]),
               "M": jasm.assemble_lumped_mass(jm)}
        for m, kw in (("dense", {}), ("lu", {}),
                      ("cg", dict(cg_tol=0.0, cg_maxiter=CG_ITERS))):
            out[m] = j_solve(jm, j["k_el"], j["f"], method=m, **kw)
        out["batched"] = j_solve_b(jm, j["kB"], j["fB"], method="dense")
        out["grad"] = jax.grad(lambda k: jnp.sum(j_solve(
            jm, k, j["f"], method="dense") ** 2))(j["k_el"])
        return out

    jref = jax.tree_util.tree_map(
        np.asarray, ref({k: jnp.asarray(v) for k, v in a.items()}))
    return jm, tm, a, jref


@pytest.mark.parametrize("family", ["line", "tri"])
def test_p2_factories_and_assembly(family):
    jm, tm, a, ref = _p2_case(family)
    # linspace may round the last bit differently in the two packages
    np.testing.assert_allclose(tm.nodes.numpy(), np.asarray(jm.nodes),
                               rtol=0, atol=1e-15)
    for name in ("elements", "bc_mask", "bc_values"):
        np.testing.assert_array_equal(getattr(tm, name).numpy(),
                                      np.asarray(getattr(jm, name)))
    assert tasm.element_family(tm) == f"p2_{family}"
    assert rel_err(tasm.local_stiffness(tm, _t(a["k_el"])), ref["Ke"]) \
        <= PARITY
    assert rel_err(tasm.assemble_stiffness_dense(tm, _t(a["k_node"])),
                   ref["K"]) <= PARITY
    assert rel_err(tasm.assemble_load(tm, _t(a["fB"])), ref["F"]) <= PARITY
    assert rel_err(tasm.assemble_lumped_mass(tm), ref["M"]) <= PARITY


@pytest.mark.parametrize("family", ["line", "tri"])
@pytest.mark.parametrize("method", ["dense", "lu", "cg"])
def test_p2_solves(family, method):
    _, tm, a, ref = _p2_case(family)
    kw = dict(cg_tol=0.0, cg_maxiter=CG_ITERS) if method == "cg" else {}
    u = t_solve(tm, _t(a["k_el"]), _t(a["f"]), method=method, **kw)
    assert rel_err(u, ref[method]) <= PARITY


@pytest.mark.parametrize("family", ["line", "tri"])
def test_p2_batched_and_gradient(family):
    _, tm, a, ref = _p2_case(family)
    u = t_solve_b(tm, _t(a["kB"]), _t(a["fB"]), method="dense")
    assert rel_err(u, ref["batched"]) <= PARITY
    k = _t(a["k_el"], True)
    (t_solve(tm, k, _t(a["f"]), method="dense") ** 2).sum().backward()
    assert rel_err(k.grad, ref["grad"]) <= GRAD
