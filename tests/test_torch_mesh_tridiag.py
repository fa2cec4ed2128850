"""Parity of the PyTorch port's mesh, 1D assembly, PCR tridiagonal oracle
and solver facade with the JAX package, on the same numpy inputs (f64)."""

import ast
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import difffe_tpu_torch
from difffe_tpu.mesh import FEMesh as JMesh
from difffe_tpu.ops import assembly as jasm
from difffe_tpu.ops import tridiag as jtri
from difffe_tpu.solver import solve_poisson as j_solve
from difffe_tpu.solver import solve_poisson_batched as j_solve_b
from difffe_tpu_torch.mesh import FEMesh as TMesh
from difffe_tpu_torch.ops import assembly as tasm
from difffe_tpu_torch.ops import tridiag as ttri
from difffe_tpu_torch.solver import solve_poisson as t_solve
from difffe_tpu_torch.solver import solve_poisson_batched as t_solve_b
from torch_parity import as_torch, jax_mesh, port_mesh, rel_err

torch.set_num_threads(1)

F64 = torch.float64
TIGHT = dict(rtol=1e-12, atol=1e-14)    # same f64 algorithm, other order


def _meshes(n=12, nonuniform=False, bc=(0.4, -0.1)):
    """A JAX line mesh and its port through the numpy converter."""
    jm = jax_mesh(JMesh.line, n, bc_left=bc[0], bc_right=bc[1],
                  dtype=jnp.float64)
    if nonuniform:
        xs = np.asarray(jm.nodes)[:, 0] ** 1.5
        jm = dataclasses.replace(jm, nodes=jnp.asarray(xs[:, None]))
    tm = port_mesh(jm)
    return jm, tm


def test_port_imports_no_jax():
    root = Path(difffe_tpu_torch.__file__).parent
    offenders = []
    for path in sorted(root.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            offenders += [f"{path.name}:{node.lineno} {m}" for m in names
                          if m.split(".")[0] in ("jax", "jaxlib",
                                                 "difffe_tpu")]
    assert not offenders, offenders


@pytest.mark.parametrize("n,bc", [(1, (0.0, 0.0)), (10, (0.0, 0.0)),
                                  (17, (0.4, -0.1)), (8, (None, 1.5)),
                                  (8, (2.0, None))])
def test_line_fields_match(n, bc):
    jm = jax_mesh(JMesh.line, n, x_left=-0.5, x_right=2.0, bc_left=bc[0],
                  bc_right=bc[1], dtype=jnp.float64)
    tm = TMesh.line(n, x_left=-0.5, x_right=2.0, bc_left=bc[0],
                    bc_right=bc[1], dtype=F64, device="cpu")
    np.testing.assert_allclose(tm.nodes.numpy(), np.asarray(jm.nodes),
                               rtol=0, atol=1e-15)
    np.testing.assert_array_equal(tm.elements.numpy(),
                                  np.asarray(jm.elements))
    np.testing.assert_array_equal(tm.bc_mask.numpy(), np.asarray(jm.bc_mask))
    np.testing.assert_array_equal(tm.bc_values.numpy(),
                                  np.asarray(jm.bc_values))
    assert (tm.n_nodes, tm.n_elements, tm.dim, tm.n_dirichlet) == \
        (jm.n_nodes, jm.n_elements, jm.dim, jm.n_dirichlet)
    np.testing.assert_array_equal(tm.free_nodes(), jm.free_nodes())
    assert tm.h() == pytest.approx(jm.h(), rel=1e-14)
    assert tm.dtype == F64 and tm.device == torch.device("cpu")


@pytest.mark.parametrize("nonuniform", [False, True])
def test_from_arrays_converter(nonuniform):
    jm, tm = _meshes(nonuniform=nonuniform)
    for field in ("nodes", "bc_mask", "bc_values"):
        np.testing.assert_array_equal(getattr(tm, field).numpy(),
                                      np.asarray(getattr(jm, field)))
    assert tm.elements.dtype == torch.int64 and tm.dtype == F64
    assert tm.h() == pytest.approx(jm.h(), rel=1e-14)
    m32 = port_mesh(jm, dtype=torch.float32)
    assert m32.dtype == torch.float32 and m32.bc_mask.dtype == torch.float32
    pinned = tm.with_dirichlet([3, 5], 0.25)
    jpinned = jm.with_dirichlet(jnp.asarray([3, 5]), 0.25)
    np.testing.assert_array_equal(pinned.bc_mask.numpy(),
                                  np.asarray(jpinned.bc_mask))
    np.testing.assert_array_equal(pinned.bc_values.numpy(),
                                  np.asarray(jpinned.bc_values))
    assert tm.n_dirichlet == 2               # the original is unchanged


@pytest.mark.parametrize("factory", ["line_p2", "rectangle_p2"])
def test_unported_factories_raise(factory):
    # ported with ops/p2.py (slice E): the same arrays as the JAX factory
    args = (4,) if factory == "line_p2" else (4, 3)
    jm = jax_mesh(getattr(JMesh, factory), *args, dtype=jnp.float64)
    tm = getattr(TMesh, factory)(*args, dtype=F64, device="cpu")
    assert tm.grid is None
    # linspace may round the last bit differently in the two packages
    np.testing.assert_allclose(tm.nodes.numpy(), np.asarray(jm.nodes),
                               rtol=0, atol=1e-15)
    for name in ("elements", "bc_mask", "bc_values"):
        np.testing.assert_array_equal(getattr(tm, name).numpy(),
                                      np.asarray(getattr(jm, name)))


@pytest.mark.parametrize("kind", ["scalar", "element", "node", "batched"])
def test_kappa_on_elements(kind):
    jm, tm = _meshes()
    rng = np.random.default_rng(1)
    k = {"scalar": np.float64(1.7),
         "element": 1 + rng.random(jm.n_elements),
         "node": 1 + rng.random(jm.n_nodes),
         "batched": 1 + rng.random((3, jm.n_elements))}[kind]
    np.testing.assert_allclose(
        tasm.kappa_on_elements(tm, as_torch(k)).numpy(),
        np.asarray(jax.jit(lambda k: jasm.kappa_on_elements(jm, k))(
            jnp.asarray(k))), **TIGHT)


@pytest.mark.parametrize("nonuniform", [False, True])
def test_assemble_load_and_bands(nonuniform):
    jm, tm = _meshes(nonuniform=nonuniform)
    rng = np.random.default_rng(2)
    f = rng.standard_normal((4, jm.n_nodes))
    k = 1 + rng.random((4, jm.n_elements))
    jF, jF0, (jd, je) = jax.jit(lambda f, k: (
        jasm.assemble_load(jm, f), jasm.assemble_load(jm, f[0]),
        jasm.assemble_tridiag_1d(jm, k)))(jnp.asarray(f), jnp.asarray(k))
    for fb, jFb in ((f, jF), (f[0], jF0)):
        np.testing.assert_allclose(
            tasm.assemble_load(tm, as_torch(fb)).numpy(), np.asarray(jFb),
            **TIGHT)
    td, te = tasm.assemble_tridiag_1d(tm, as_torch(k))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **TIGHT)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), **TIGHT)
    assert tasm.element_family(TMesh.from_arrays(
        np.zeros((6, 2)), np.array([[0, 1, 2, 3, 4, 5]]), np.ones(6),
        np.zeros(6), device="cpu")) == "p2_tri"
    with pytest.raises(NotImplementedError, match="unsupported"):
        tasm.element_family(TMesh.from_arrays(
            np.zeros((4, 2)), np.array([[0, 1, 2, 3]]), np.ones(4),
            np.zeros(4), device="cpu"))
    tet = TMesh.from_arrays(np.zeros((4, 3)), np.array([[0, 1, 2, 3]]),
                            np.ones(4), np.zeros(4), device="cpu")
    assert tasm.element_family(tet) == "p1_tet"
    # the generic assembly (slice E): degenerate elements add nothing
    assert torch.all(tasm.assemble_load(tet, np.ones(4)) == 0)
    tri = TMesh.from_arrays(np.zeros((3, 2)), np.array([[0, 1, 2]]),
                            np.ones(3), np.zeros(3), device="cpu")
    assert tasm.element_family(tri) == "p1_tri"
    assert torch.all(tasm.assemble_load(tri, torch.ones(3, dtype=F64)) == 0)
    with pytest.raises(ValueError, match="P1 line"):
        tasm.assemble_tridiag_1d(tri, 1.0)


def _spd_bands(rng, B, n):
    e = -(0.5 + rng.random((B, n - 1)))
    d = 2.5 + rng.random((B, n))
    return d, e, rng.standard_normal((B, n))


def test_tridiag_solve_and_matvec_values():
    rng = np.random.default_rng(3)
    d, e, F = _spd_bands(rng, 5, 23)
    u_t = ttri.tridiag_solve(as_torch(d), as_torch(e), as_torch(F))
    u_j = jax.jit(jtri.tridiag_solve)(jnp.asarray(d), jnp.asarray(e),
                                      jnp.asarray(F))
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), **TIGHT)
    np.testing.assert_allclose(
        ttri.tridiag_matvec(as_torch(d), as_torch(e), u_t).numpy(), F,
        rtol=1e-12, atol=1e-12)


def test_tridiag_solve_grads_match_jax():
    rng = np.random.default_rng(4)
    d, e, F = _spd_bands(rng, 3, 19)
    w = rng.standard_normal((3, 19))

    def jloss(d, e, F):
        return jnp.sum(jnp.asarray(w) * jtri.tridiag_solve(d, e, F) ** 2)

    jg = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
        jnp.asarray(d), jnp.asarray(e), jnp.asarray(F))
    ts = [as_torch(a).requires_grad_() for a in (d, e, F)]
    (as_torch(w) * ttri.tridiag_solve(*ts) ** 2).sum().backward()
    for t, j in zip(ts, jg):
        assert rel_err(t.grad, j) <= 1e-12


def test_solve_poisson_tridiag_bc_elimination():
    jm, tm = _meshes(n=15, nonuniform=True)
    rng = np.random.default_rng(5)
    k = 1 + rng.random((4, jm.n_elements))
    f = rng.standard_normal((4, jm.n_nodes))
    bv = np.zeros((4, jm.n_nodes))
    bv[:, 0] = np.linspace(-1.0, 1.0, 4)
    bv[:, -1] = 0.5
    (jd, je), jF = jax.jit(lambda k, f: (
        jasm.assemble_tridiag_1d(jm, k), jasm.assemble_load(jm, f)))(
        jnp.asarray(k), jnp.asarray(f))
    td, te = tasm.assemble_tridiag_1d(tm, as_torch(k))
    tF = tasm.assemble_load(tm, as_torch(f))
    for bc in (None, bv):
        u_j = jax.jit(lambda d, e, F: jtri.solve_poisson_tridiag(
            jm, d, e, F, bc_values=bc))(jd, je, jF)
        u_t = ttri.solve_poisson_tridiag(tm, td, te, tF, bc_values=bc)
        np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), **TIGHT)
        # the kernel backend (its plain version on the CPU) solves the
        # same eliminated bands
        u_k = ttri.solve_poisson_tridiag(tm, td, te, tF, backend="pallas",
                                         bc_values=bc)
        np.testing.assert_allclose(u_k.numpy(), np.asarray(u_j), **TIGHT)
    with pytest.raises(NotImplementedError, match="slice B"):
        ttri.solve_poisson_tridiag(tm, td, te, tF, backend="spike")


@pytest.mark.parametrize("kappa_kind", ["shared_field", "per_scenario_scalar",
                                        "batched_field", "node_field"])
def test_facade_batched_matches_jax(kappa_kind):
    jm, tm = _meshes(n=20)
    rng = np.random.default_rng(6)
    B = 6
    k = {"shared_field": 1 + rng.random(jm.n_elements),
         "per_scenario_scalar": 1 + rng.random(B),
         "batched_field": 1 + rng.random((B, jm.n_elements)),
         "node_field": 1 + rng.random(jm.n_nodes)}[kappa_kind]
    f = rng.standard_normal((B, jm.n_nodes))
    u_j = jax.jit(lambda k, f: j_solve_b(jm, k, f, method="tridiag"))(
        jnp.asarray(k), jnp.asarray(f))
    u_t = t_solve_b(tm, as_torch(k), as_torch(f), method="tridiag")
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), **TIGHT)


def test_facade_unbatched_and_grads():
    jm, tm = _meshes(n=20, nonuniform=True)
    rng = np.random.default_rng(7)
    k = 1 + rng.random(jm.n_elements)
    f = rng.standard_normal(jm.n_nodes)
    u_j, jg = jax.jit(lambda kk: (
        j_solve(jm, kk, jnp.asarray(f)),
        jax.grad(lambda k2: jnp.sum(j_solve(jm, k2, jnp.asarray(f)) ** 2))(
            kk)))(jnp.asarray(k))
    kt = as_torch(k).requires_grad_()
    u_t = t_solve(tm, kt, as_torch(f))
    np.testing.assert_allclose(u_t.detach().numpy(), np.asarray(u_j),
                               **TIGHT)
    (u_t ** 2).sum().backward()
    np.testing.assert_allclose(kt.grad.numpy(), np.asarray(jg), rtol=1e-11,
                               atol=1e-14)


def test_facade_rules_and_unported_routes():
    jm, tm = _meshes(n=7)                     # n_elements 7, n_nodes 8
    f = torch.ones((7, 8), dtype=F64)
    with pytest.raises(ValueError, match="ambiguous"):
        t_solve_b(tm, torch.ones(7, dtype=F64), f)
    u = t_solve_b(tm, torch.full((7,), 2.0, dtype=F64), f,
                  kappa_batched=True)
    np.testing.assert_allclose(
        u.numpy(), np.asarray(jax.jit(lambda k, f: j_solve_b(
            jm, k, f, kappa_batched=True))(jnp.full((7,), 2.0),
                                           jnp.ones((7, 8)))), **TIGHT)
    u = t_solve(tm, 1.0, f[0])
    for method in ("tridiag_pallas", "dense", "lu", "cg"):
        np.testing.assert_allclose(t_solve(tm, 1.0, f[0], method=method),
                                   u, rtol=1e-12, atol=1e-14)
    with pytest.raises(ValueError, match="structured-grid metadata"):
        t_solve(tm, 1.0, f[0], method="stencil")
    np.testing.assert_allclose(
        t_solve(tm, 1.0, f[0], neumann=torch.zeros(8, dtype=F64)), u,
        rtol=0, atol=0)
    with pytest.raises(ValueError, match="Unknown method"):
        t_solve(tm, 1.0, f[0], method="nope")
    free = TMesh.line(7, bc_left=None, bc_right=None, dtype=F64,
                      device="cpu")
    with pytest.raises(ValueError, match="singular"):
        t_solve(free, 1.0, f[0])
