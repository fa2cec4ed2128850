"""Parity of the PyTorch port's closed-form 1D solves (ops/cf1d.py) with
the JAX package and with the port's own PCR oracle, on the same numpy
inputs (f64)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from difffe_tpu.mesh import FEMesh as JMesh
from difffe_tpu.ops import cf1d as jcf
from difffe_tpu.ops.assembly import assemble_load as j_load
from difffe_tpu_torch.mesh import FEMesh as TMesh
from difffe_tpu_torch.ops import cf1d as tcf
from difffe_tpu_torch.ops.assembly import assemble_load as t_load
from difffe_tpu_torch.solver import solve_poisson_batched as t_solve_b
from torch_parity import as_torch, jax_mesh, port_mesh

torch.set_num_threads(1)

TIGHT = dict(rtol=1e-12, atol=1e-13)    # same f64 algorithm, other order


def _setup(n=20, B=6, nonuniform=False, bc=(0.4, -0.1), seed=0):
    jm = jax_mesh(JMesh.line, n, bc_left=bc[0], bc_right=bc[1],
                  dtype=jnp.float64)
    if nonuniform:
        xs = np.asarray(jm.nodes)[:, 0] ** 1.5
        jm = dataclasses.replace(jm, nodes=jnp.asarray(xs[:, None]))
    tm = port_mesh(jm)
    rng = np.random.default_rng(seed)
    x = np.asarray(jm.nodes)[:, 0]
    f = (np.sin(np.pi * x) + 1.0) * (1 + 0.3 * rng.random((B, 1)))
    ke = 1.0 + rng.random((B, n))
    ud = 0.05 * rng.standard_normal((B, n + 1))
    return jm, tm, f, ke, ud


def test_mesh_supports_cf():
    jm, tm, *_ = _setup()
    assert tcf.mesh_supports_cf(tm) and jcf.mesh_supports_cf(jm)
    for pin in (tm.with_dirichlet([5], 0.0),
                TMesh.line(8, bc_right=None, dtype=torch.float64,
                           device="cpu")):
        assert not tcf.mesh_supports_cf(pin)
    with pytest.raises(ValueError, match="endpoint"):
        tcf.solve_poisson_cf_batched(tm.with_dirichlet([5], 0.0),
                                     torch.ones(1, 20, dtype=torch.float64),
                                     torch.ones(21, dtype=torch.float64))


@pytest.mark.parametrize("nonuniform", [False, True])
@pytest.mark.parametrize("batched_bc", [False, True])
def test_solve_matches_jax_and_oracle(nonuniform, batched_bc):
    jm, tm, f, ke, _ = _setup(nonuniform=nonuniform)
    bv = None
    if batched_bc:
        bv = np.zeros((6, jm.n_nodes))
        bv[:, 0] = np.linspace(-1.0, 1.0, 6)
        bv[:, -1] = 0.5
    u_j = jax.jit(lambda k, f, bv: jcf.solve_poisson_cf_batched(
        jm, k, f, bc_values=bv))(jnp.asarray(ke), jnp.asarray(f),
                                 None if bv is None else jnp.asarray(bv))
    u_t = tcf.solve_poisson_cf_batched(tm, as_torch(ke), as_torch(f),
                                       bc_values=None if bv is None
                                       else as_torch(bv))
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), **TIGHT)
    u_pcr = t_solve_b(tm, as_torch(ke), as_torch(f), method="tridiag",
                      bc_values=None if bv is None else as_torch(bv))
    np.testing.assert_allclose(u_t.numpy(), u_pcr.numpy(), rtol=1e-11,
                               atol=1e-12)


def test_solve_shared_kappa_promoted():
    jm, tm, f, ke, _ = _setup(B=1)
    u_j = jax.jit(lambda k, f: jcf.solve_poisson_cf_batched(jm, k, f))(
        jnp.asarray(ke[0]), jnp.asarray(f[0]))
    u_t = tcf.solve_poisson_cf_batched(tm, as_torch(ke[0]), as_torch(f[0]))
    assert u_t.shape == (1, jm.n_nodes)
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), **TIGHT)


@pytest.mark.parametrize("nonuniform", [False, True])
def test_autograd_gradient_matches_jax(nonuniform):
    jm, tm, f, ke, ud = _setup(nonuniform=nonuniform)

    def jloss(k):
        u = jcf.solve_poisson_cf_batched(jm, k, jnp.asarray(f))
        return jnp.mean((u - ud) ** 2)

    g_j = jax.jit(jax.grad(jloss))(jnp.asarray(ke))
    kt = as_torch(ke).requires_grad_()
    u = tcf.solve_poisson_cf_batched(tm, kt, as_torch(f))
    ((u - as_torch(ud)) ** 2).mean().backward()
    np.testing.assert_allclose(kt.grad.numpy(), np.asarray(g_j), rtol=1e-12,
                               atol=1e-15)


@pytest.mark.parametrize("shared", ["none", "F", "F_and_ud"])
def test_kappa_mse_step_cf_matches_jax(shared):
    jm, tm, f, ke, ud = _setup(nonuniform=True, bc=(0.2, 0.7))
    F_t = t_load(tm, as_torch(f))
    if shared != "none":
        F_t = F_t[0]
    if shared == "F_and_ud":
        ud = ud[0]

    @jax.jit
    def jax_side(k, f, ud):
        F = j_load(jm, f)
        return jcf.kappa_mse_step_cf(jm, k, F if shared == "none" else F[0],
                                     ud)

    lp_j, g_j = jax_side(*map(jnp.asarray, (ke, f, ud)))
    lp_t, g_t = tcf.kappa_mse_step_cf(tm, as_torch(ke), F_t, as_torch(ud))
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), rtol=1e-12)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-12,
                               atol=1e-15)


def test_kappa_mse_step_cf_is_the_autograd_gradient():
    _, tm, f, ke, ud = _setup(n=12, B=4)
    kt = as_torch(ke).requires_grad_()
    scale = 2.0 / 13
    u = t_solve_b(tm, kt, as_torch(f), method="tridiag")
    (scale / 2 * ((u - as_torch(ud)) ** 2).sum()).backward()
    lp, g = tcf.kappa_mse_step_cf(tm, as_torch(ke), t_load(tm, as_torch(f)),
                                  as_torch(ud), scale=scale)
    np.testing.assert_allclose(g.numpy(), kt.grad.numpy(), rtol=1e-10,
                               atol=1e-14)
    loss = ((u - as_torch(ud)) ** 2).sum(-1).detach()
    np.testing.assert_allclose(lp.numpy(), loss.numpy(), rtol=1e-11)
