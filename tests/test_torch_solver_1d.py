"""The port's 1D facade against the JAX package on the same numpy inputs
(f64): ``solve_poisson[_batched]`` for methods tridiag, tridiag_pallas,
dense and lu, ``DifferentiableFESolver``, point Neumann/Robin terms, the
dense assembly and solve operators, gradients to κ, f and the Dirichlet
values, and the named errors of what stays unported.

The reference map's cases (docs/PARITY.md:35-40: coarse and fine
exactness, BCs, sinusoidal convergence, nonzero Dirichlet values) run on
the port for every method.  Solutions and gradients match JAX within
1e-10 relative; the methods agree with each other to 1e-12.  The JAX side
uses small shapes that repeat, because each new shape compiles.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from difffe_tpu.mesh import FEMesh as JMesh
from difffe_tpu.ops import assembly as jasm
from difffe_tpu.ops import neumann as jneu
from difffe_tpu.ops import robin as jrob
from difffe_tpu.ops import solve as jsol
from difffe_tpu.solver import DifferentiableFESolver as JSolver
from difffe_tpu.solver import solve_poisson as j_solve
from difffe_tpu.solver import solve_poisson_batched as j_solve_b
from difffe_tpu_torch.mesh import FEMesh as TMesh
from difffe_tpu_torch.ops import assembly as tasm
from difffe_tpu_torch.ops import neumann as tneu
from difffe_tpu_torch.ops import robin as trob
from difffe_tpu_torch.ops import solve as tsol
from difffe_tpu_torch.solver import DifferentiableFESolver as TSolver
from difffe_tpu_torch.solver import solve_poisson as t_solve
from difffe_tpu_torch.solver import solve_poisson_batched as t_solve_b
from torch_parity import as_torch, jax_mesh, port_mesh, rel_err

torch.set_num_threads(1)

F64 = torch.float64
METHODS = ["tridiag", "tridiag_pallas", "dense", "lu"]
TOL = 1e-10


def _line(n, bc=(0.0, 0.0), **kw):
    return TMesh.line(n, bc_left=bc[0], bc_right=bc[1], dtype=F64,
                      device="cpu", **kw)


def _meshes(n=16, bc=(0.4, -0.1)):
    """A nonuniform JAX line mesh and its port."""
    jm = jax_mesh(JMesh.line, n, bc_left=bc[0], bc_right=bc[1],
                  dtype=jnp.float64)
    xs = np.asarray(jm.nodes)[:, 0] ** 1.3
    jm = dataclasses.replace(jm, nodes=jnp.asarray(xs[:, None]))
    return jm, port_mesh(jm)


@pytest.mark.parametrize("method", METHODS)
def test_reference_exactness_cases(method):
    """docs/PARITY.md:35-39 on the port: −u″ = 1 is exact at n = 10 and
    100, the BCs hold, κ scales the solution, u″ = 0 with u(0) = 1,
    u(1) = 2 gives 1 + x."""
    for n, atol in ((10, 1e-10), (100, 1e-9)):
        mesh = _line(n)
        x = mesh.nodes[:, 0]
        u = t_solve(mesh, 1.0, torch.ones_like(x), method=method)
        torch.testing.assert_close(u, x * (1.0 - x) / 2.0, rtol=0,
                                   atol=atol)
        assert abs(float(u[0])) < 1e-12 and abs(float(u[-1])) < 1e-12
        u2 = t_solve(mesh, 2.0, torch.ones_like(x), method=method)
        torch.testing.assert_close(u2, u / 2.0, rtol=0, atol=1e-12)
    mesh = _line(10, bc=(1.0, 2.0))
    x = mesh.nodes[:, 0]
    torch.testing.assert_close(
        t_solve(mesh, 1.0, torch.zeros_like(x), method=method), 1.0 + x,
        rtol=0, atol=1e-10)


@pytest.mark.parametrize("method", METHODS)
def test_sinusoidal_convergence(method):
    """−u″ = π² sin(πx): the error drops ~4× per mesh doubling."""
    errors = []
    for n in (10, 20, 40, 80):
        mesh = _line(n)
        x = mesh.nodes[:, 0]
        u = t_solve(mesh, 1.0, math.pi ** 2 * torch.sin(math.pi * x),
                    method=method)
        errors.append(float((u - torch.sin(math.pi * x)).abs().max()))
    for a, b in zip(errors, errors[1:]):
        assert a / (b + 1e-15) > 3.0


@pytest.mark.parametrize("method", METHODS)
def test_solutions_and_gradients_match_jax(method):
    """Per-element κ on a nonuniform mesh with nonzero Dirichlet values:
    the unbatched solve and its gradients to κ, f and the Dirichlet values,
    and a batched solve with per-scenario κ, f and Dirichlet values."""
    jm, tm = _meshes()
    rng = np.random.default_rng(3)
    k = 1.0 + rng.random(jm.n_elements)
    f = rng.standard_normal(jm.n_nodes)
    g = np.asarray(jm.bc_values) + 0.3 * np.asarray(jm.bc_mask)
    w = rng.standard_normal(jm.n_nodes)

    def jloss(k, f, g):
        return jnp.sum(jnp.asarray(w) * j_solve(jm, k, f, method=method,
                                                bc_values=g))

    jv, jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2)))(
        jnp.asarray(k), jnp.asarray(f), jnp.asarray(g))
    ts = [as_torch(a).requires_grad_() for a in (k, f, g)]
    tv = (as_torch(w) * t_solve(tm, ts[0], ts[1], method=method,
                                bc_values=ts[2])).sum()
    tv.backward()
    assert abs(float(tv.detach()) - float(jv)) <= TOL * abs(float(jv))
    for t, j in zip(ts, jg):
        assert rel_err(t.grad, j) <= TOL

    B = 3
    kb = 1.0 + rng.random((B, jm.n_elements))
    fb = rng.standard_normal((B, jm.n_nodes))
    gb = np.asarray(jm.bc_values) * np.arange(1, B + 1)[:, None]
    u_j = jax.jit(lambda k, f, g: j_solve_b(jm, k, f, method=method,
                                            bc_values=g))(
        jnp.asarray(kb), jnp.asarray(fb), jnp.asarray(gb))
    u_t = t_solve_b(tm, as_torch(kb), as_torch(fb), method=method,
                    bc_values=as_torch(gb))
    assert u_t.shape == (B, jm.n_nodes) and rel_err(u_t, u_j) <= TOL
    u_t2 = t_solve_b(tm, as_torch(kb[:, 0]), as_torch(fb), method=method)
    u_j2 = jax.jit(lambda k, f: j_solve_b(jm, k, f, method="tridiag"))(
        jnp.asarray(kb[:, 0]), jnp.asarray(fb))
    assert rel_err(u_t2, u_j2) <= TOL


@pytest.mark.parametrize("method", METHODS)
def test_point_neumann_and_robin_match_jax(method):
    """A flux at the free right end, a Robin term at the left end with
    per-scenario α and r, and both together on a one-Dirichlet mesh."""
    jm = jax_mesh(JMesh.line, 14, bc_left=0.5, bc_right=None,
                  dtype=jnp.float64)
    tm = port_mesh(jm)
    jm0 = jax_mesh(JMesh.line, 14, bc_left=None, bc_right=None,
                   dtype=jnp.float64)
    tm0 = port_mesh(jm0)
    n = jm.n_nodes
    rng = np.random.default_rng(4)
    k = 1.0 + rng.random(jm.n_elements)
    f = rng.standard_normal(n)
    jq = jneu.point_flux(jm, n - 1, 0.7)
    tq = tneu.point_flux(tm, n - 1, 0.7)
    assert rel_err(tq, jq) == 0.0
    u_j = jax.jit(lambda k, f, q: j_solve(jm, k, f, method=method,
                                          neumann=q))(
        jnp.asarray(k), jnp.asarray(f), jq)
    u_t = t_solve(tm, as_torch(k), as_torch(f), method=method, neumann=tq)
    assert rel_err(u_t, u_j) <= TOL

    alpha, r = np.array([0.5, 1.0, 2.0]), np.array([0.1, -0.2, 0.3])
    jrb = jrob.robin_point(jm0, 0, jnp.asarray(alpha), jnp.asarray(r))
    trb = trob.robin_point(tm0, 0, as_torch(alpha), as_torch(r))
    assert trb.diagonal_only and trb.vals.shape == (3, 1)
    assert rel_err(trb.load, jrb.load) == 0.0
    fb = rng.standard_normal((3, n))
    nb = np.zeros((3, n))
    nb[:, -1] = [0.2, 0.0, -0.4]
    u_j = jax.jit(lambda k, f, rb, q: j_solve_b(
        jm0, k, f, method=method, robin=rb, neumann=q))(
        jnp.asarray(k), jnp.asarray(fb), jrb, jnp.asarray(nb))
    u_t = t_solve_b(tm0, as_torch(k), as_torch(fb), method=method,
                    robin=trb, neumann=as_torch(nb))
    assert u_t.shape == (3, n) and rel_err(u_t, u_j) <= TOL
    # the per-scenario Robin term alone batches the solve
    u_t1 = t_solve_b(tm0, as_torch(k), as_torch(fb[0]), method=method,
                     robin=trb)
    u_j1 = jax.jit(lambda k, f, rb: j_solve_b(jm0, k, f, method="dense",
                                              robin=rb))(
        jnp.asarray(k), jnp.asarray(fb[0]), jrb)
    assert u_t1.shape == (3, n) and rel_err(u_t1, u_j1) <= TOL


def test_dense_operators_match_jax():
    jm, tm = _meshes(n=9)
    rng = np.random.default_rng(5)
    k = 1.0 + rng.random((2, jm.n_elements))
    u = rng.standard_normal((2, jm.n_nodes))
    F = rng.standard_normal(jm.n_nodes)
    w = rng.standard_normal(jm.n_nodes)

    @jax.jit
    def jax_side(k, u, F, w):
        Kj = jax.vmap(lambda kk: jasm.assemble_stiffness_dense(jm, kk))(k)
        Ke = jasm.local_stiffness(jm, k[0])

        def apply_j(v):
            return jasm.stiffness_apply(jm, k[0], v)

        K_j, F_j = jsol.apply_dirichlet_dense(jm, Kj[0], F)
        grads = [jax.grad(lambda K, F: jnp.sum(w * jf(K, F)),
                          argnums=(0, 1))(K_j, F_j)
                 for jf in (jsol.cholesky_solve, jsol.lu_solve)]
        return (Kj, Ke, jasm.dense_from_local(jm, Ke),
                jasm.element_apply(jm, Ke, u), jasm.assemble_lumped_mass(jm),
                K_j, F_j, jsol.apply_dirichlet_operator(jm, apply_j, F),
                jsol.dirichlet_rhs(jm, apply_j, F), grads)

    (Kj, jKe, jK1, jEu, jM, K_j, F_j, jop, jrhs, jgrads) = jax_side(
        *map(jnp.asarray, (k, u, F, w)))
    Kt = tasm.assemble_stiffness_dense(tm, as_torch(k))
    assert Kt.shape == (2, 10, 10) and rel_err(Kt, Kj) <= 1e-14
    Ke = tasm.local_stiffness(tm, as_torch(k[0]))
    assert rel_err(Ke, jKe) <= 1e-14
    assert rel_err(tasm.dense_from_local(tm, Ke), jK1) <= 1e-14
    assert rel_err(tasm.element_apply(tm, Ke, as_torch(u)), jEu) <= 1e-14
    assert rel_err(tasm.stiffness_apply(tm, as_torch(k), as_torch(u)),
                   np.einsum("bij,bj->bi", np.asarray(Kj), u)) <= 1e-13
    assert rel_err(tasm.assemble_lumped_mass(tm), jM) <= 1e-15
    K_t, F_t = tsol.apply_dirichlet_dense(tm, as_torch(Kj[0]), as_torch(F))
    assert rel_err(K_t, K_j) <= 1e-15 and rel_err(F_t, F_j) <= 1e-14

    def apply_t(v):
        return tasm.stiffness_apply(tm, as_torch(k[0]), v)

    assert rel_err(tsol.apply_dirichlet_operator(tm, apply_t, as_torch(F)),
                   jop) <= 1e-13
    assert rel_err(tsol.dirichlet_rhs(tm, apply_t, as_torch(F)),
                   jrhs) <= 1e-13
    # the factorized solves and their factor-reusing adjoints
    for tf, jg in zip((tsol.cholesky_solve, tsol.lu_solve), jgrads):
        Kq, Fq = K_t.clone().requires_grad_(), F_t.clone().requires_grad_()
        (as_torch(w) * tf(Kq, Fq)).sum().backward()
        assert rel_err(Kq.grad, jg[0]) <= TOL
        assert rel_err(Fq.grad, jg[1]) <= TOL
    with pytest.raises(ValueError, match="Unknown factor"):
        tsol.solve_dense(tm, as_torch(Kj[0]), as_torch(F), factor="qr")


def test_differentiable_fe_solver_matches_jax():
    jm, tm = _meshes(n=12, bc=(0.0, 0.0))
    rng = np.random.default_rng(6)
    f = rng.standard_normal((4, jm.n_nodes))
    js = jax.jit(JSolver(jm, kappa=1.7, method="tridiag_pallas"))
    ts = TSolver(tm, kappa=1.7, method="tridiag_pallas")
    assert float(ts.kappa) == 1.7 and ts.forward == ts.__call__
    assert rel_err(ts(as_torch(f)), js(jnp.asarray(f))) <= TOL
    assert rel_err(ts(as_torch(f[0])), js(jnp.asarray(f[0]))) <= TOL
    dense = TSolver(tm, kappa=1.7, method="dense")
    assert rel_err(dense(as_torch(f)), ts(as_torch(f))) <= 1e-12
    mesh = _line(10)
    x = mesh.nodes[:, 0]
    u = TSolver(mesh)(torch.ones(11, dtype=F64))
    assert u.shape == (11,)
    torch.testing.assert_close(u, x * (1 - x) / 2, rtol=0, atol=1e-12)


def test_named_errors_of_what_stays_unported():
    mesh = _line(6)
    f = torch.ones(7, dtype=F64)
    with pytest.raises(NotImplementedError, match="slice C item 14"):
        t_solve(mesh, 1.0, f, method="cg")
    with pytest.raises(ValueError, match="Unknown method"):
        t_solve(mesh, 1.0, f, method="nope")
    rect = TMesh.rectangle(3, 3, dtype=F64, device="cpu")
    for method in ("dense", "lu"):
        with pytest.raises(NotImplementedError, match="slice E"):
            t_solve(rect, 1.0, torch.ones(16, dtype=F64), method=method)
        with pytest.raises(NotImplementedError, match="slice E"):
            t_solve_b(rect, 1.0, torch.ones(2, 16, dtype=F64),
                      method=method)
    for method in ("tridiag", "tridiag_pallas"):
        with pytest.raises(ValueError, match="requires a 1D mesh"):
            t_solve(rect, 1.0, torch.ones(16, dtype=F64), method=method)
    edge = trob.RobinBC(rows=torch.tensor([0, 1]), cols=torch.tensor([1, 0]),
                        vals=torch.ones(2, dtype=F64),
                        load=torch.zeros(7, dtype=F64))
    with pytest.raises(ValueError, match="diagonal-only"):
        t_solve(mesh, 1.0, f, method="tridiag_pallas", robin=edge)
    for fn, args in ((trob.robin_edges, (rect, None, 1.0, None)),
                     (tneu.edge_flux_load, (rect, None, None)),
                     (tneu.boundary_edges, (rect,))):
        with pytest.raises(NotImplementedError, match="slice C item 14"):
            fn(*args)
    with pytest.raises(NotImplementedError, match="slice B, next PR"):
        TMesh.line_p2(4)
