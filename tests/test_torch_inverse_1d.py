"""The port's 1D inverse problems against the JAX package on the same
numpy inputs (f64): ``recover_kappa_scalar`` (Adam warm-up and the Newton
polish, whose reverse-over-reverse Hessian runs through the PCR oracle's
double backward), ``recover_kappa_field`` (Adam loss histories within
1e-8 relative, ``torch.optim.Adam`` standing in for ``optax.adam``) and
``fit_kappa``'s generic Adam route.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import difffe_tpu.inverse as jinv
from difffe_tpu.mesh import FEMesh as JMesh
from difffe_tpu.ops import tridiag as jtri
from difffe_tpu.solver import solve_poisson as j_solve
from difffe_tpu_torch import inverse as tinv
from difffe_tpu_torch.ops import tridiag as ttri
from difffe_tpu_torch.solver import solve_poisson as t_solve
from difffe_tpu_torch.solver import solve_poisson_batched as t_solve_b
from torch_parity import as_torch, jax_mesh, port_mesh, rel_err

torch.set_num_threads(1)

HIST = 1e-8          # Adam histories, relative


def _scalar_problem(n=30):
    """bench_full.py's scalar-κ setup: four scenarios, one forcing."""
    jm = jax_mesh(JMesh.line, n, dtype=jnp.float64)
    tm = port_mesh(jm)
    x = np.asarray(jm.nodes)[:, 0]
    f = np.broadcast_to(np.sin(np.pi * x) + 1.0, (4, n + 1)).copy()
    k_true = np.array([0.7, 1.3, 2.0, 2.9])
    ud = t_solve_b(tm, as_torch(k_true), as_torch(f),
                   kappa_batched=True).numpy()
    return jm, tm, f, ud, k_true


def test_double_backward_matches_jax():
    """jax.grad of jax.grad through ``tridiag_solve`` and through the
    Cholesky and LU routes: the port's backward passes are
    differentiable."""
    rng = np.random.default_rng(0)
    B, n = 2, 11
    e = -(0.5 + rng.random((B, n - 1)))
    d = 2.5 + rng.random((B, n))
    F, w, v = (rng.standard_normal((B, n)) for _ in range(3))

    def jinner(d, e, F):
        return jnp.sum(jnp.asarray(w) * jtri.tridiag_solve(d, e, F) ** 2)

    def jouter(d, e, F):
        g = jax.grad(jinner, argnums=(0, 1, 2))(d, e, F)
        return jnp.sum(jnp.asarray(v) * g[0]) + jnp.sum(g[1]) + jnp.sum(g[2])

    jg = jax.jit(jax.grad(jouter, argnums=(0, 1, 2)))(
        *map(jnp.asarray, (d, e, F)))
    ts = [as_torch(a).requires_grad_() for a in (d, e, F)]
    inner = (as_torch(w) * ttri.tridiag_solve(*ts) ** 2).sum()
    g = torch.autograd.grad(inner, ts, create_graph=True)
    ((as_torch(v) * g[0]).sum() + g[1].sum() + g[2].sum()).backward()
    for t, j in zip(ts, jg):
        assert rel_err(t.grad, j) <= 1e-10

    # the dense routes, differentiated twice through κ (JAX's Cholesky
    # reads the symmetrized K, so only directions that keep K symmetric
    # compare)
    jm = jax_mesh(JMesh.line, 10, bc_left=0.3, dtype=jnp.float64)
    tm = port_mesh(jm)
    lk, f, ud = (rng.standard_normal(s) for s in ((10,), (11,), (11,)))
    for method in ("dense", "lu"):
        def jl(lk):
            u = j_solve(jm, jnp.exp(lk), jnp.asarray(f), method=method)
            return jnp.mean((u - jnp.asarray(ud)) ** 2)

        jh = jax.jit(jax.grad(lambda lk: jnp.sum(jnp.asarray(v[0, :10])
                                                 * jax.grad(jl)(lk))))(
            jnp.asarray(lk))
        lt = as_torch(lk).requires_grad_()
        u = t_solve(tm, torch.exp(lt), as_torch(f), method=method)
        (g,) = torch.autograd.grad(((u - as_torch(ud)) ** 2).mean(), lt,
                                   create_graph=True)
        (as_torch(v[0, :10]) * g).sum().backward()
        assert rel_err(lt.grad, jh) <= 1e-10


def test_recover_kappa_scalar_matches_jax():
    """The sub-1e-6 gate of bench_full.py, and κ and the final losses as the
    JAX package's."""
    jm, tm, f, ud, k_true = _scalar_problem()
    k_j, l_j = jinv.recover_kappa_scalar(jm, jnp.asarray(f), jnp.asarray(ud),
                                         adam_steps=100, newton_steps=8)
    k_t, l_t = tinv.recover_kappa_scalar(tm, as_torch(f), as_torch(ud),
                                         adam_steps=100, newton_steps=8)
    assert k_t.shape == (4,) and l_t.shape == (4,)
    assert float((k_t - as_torch(k_true)).abs().max()) < 1e-6
    assert rel_err(k_t, k_j) <= 1e-8
    assert float(l_t.max()) < 1e-20 and float(np.max(l_j)) < 1e-20


def test_recover_kappa_scalar_routes():
    """``kappa0`` and the dense route (its Newton step differentiates the
    Cholesky backward); the kernel route is first-order only and raises
    in its Newton step, as the JAX package's does."""
    _, tm, f, ud, k_true = _scalar_problem(n=12)
    f, ud = as_torch(f), as_torch(ud)
    k0 = torch.full((4,), 1.5, dtype=torch.float64)
    k_t, _ = tinv.recover_kappa_scalar(tm, f, ud, kappa0=k0, adam_steps=30,
                                       newton_steps=8)
    k_d, _ = tinv.recover_kappa_scalar(tm, f, ud, kappa0=k0, adam_steps=30,
                                       newton_steps=8, method="dense")
    assert float((k_t - as_torch(k_true)).abs().max()) < 1e-6
    assert rel_err(k_d, k_t) <= 1e-8
    with pytest.raises(NotImplementedError, match="differentiable once"):
        tinv.recover_kappa_scalar(tm, f, ud, adam_steps=2, newton_steps=1,
                                  method="tridiag_pallas")


@pytest.mark.parametrize("share_field,reg", [(False, 0.0), (True, 1e-3)])
def test_recover_kappa_field_matches_jax(share_field, reg):
    jm = jax_mesh(JMesh.line, 16, dtype=jnp.float64)
    tm = port_mesh(jm)
    x = np.asarray(jm.nodes)[:, 0]
    k_true = np.where(np.arange(16) < 8, 1.0, 2.0)
    f = np.stack([np.sin(np.pi * x) + 1.0, np.cos(2 * np.pi * x) + 1.5,
                  4.0 * x * (1 - x)])
    ud = t_solve_b(tm, as_torch(np.stack([k_true] * 3)),
                   as_torch(f)).numpy()
    kw = dict(adam_steps=20, lr=0.05, reg=reg, share_field=share_field)
    k_j, h_j = jinv.recover_kappa_field(jm, jnp.asarray(f), jnp.asarray(ud),
                                        **kw)
    for method in ("auto", "tridiag_pallas"):
        k_t, h_t = tinv.recover_kappa_field(tm, as_torch(f), as_torch(ud),
                                            method=method, **kw)
        assert k_t.shape == ((16,) if share_field else (3, 16))
        assert h_t.shape == (20,)
        assert rel_err(h_t, h_j) <= HIST
        assert rel_err(k_t, k_j) <= 1e-8
        assert float(h_t[-1]) < float(h_t[0])


def test_fit_kappa_generic_adam_route_matches_jax():
    """A line mesh with one Dirichlet end is no closed-form chain: both
    packages take the generic Adam field recovery."""
    jm = jax_mesh(JMesh.line, 12, bc_left=0.2, bc_right=None,
                  dtype=jnp.float64)
    tm = port_mesh(jm)
    x = np.asarray(jm.nodes)[:, 0]
    rng = np.random.default_rng(2)
    f = np.stack([np.sin(np.pi * x) + 1.0, 2.0 + x])
    ud = t_solve_b(tm, as_torch(1.0 + rng.random((2, 12))),
                   as_torch(f)).numpy()
    k_j, info_j = jinv.fit_kappa(jm, jnp.asarray(f), jnp.asarray(ud),
                                 steps=15)
    k_t, info_t = tinv.fit_kappa(tm, as_torch(f), as_torch(ud), steps=15)
    assert info_t["path"] == info_j["path"] == "generic_adam"
    assert set(info_t) == set(info_j)
    assert rel_err(k_t, k_j) <= 1e-8
    assert rel_err(info_t["loss_history"], info_j["loss_history"]) <= HIST
    assert abs(info_t["eval_loss"] - info_j["eval_loss"]) <= \
        HIST * info_j["eval_loss"]
    _, info = tinv.fit_kappa(tm, as_torch(f[0]), as_torch(ud[0]), steps=3,
                             lr=0.1, eval_final=False)
    assert info["eval_loss"] is None and info["loss_history"].shape == (3,)
