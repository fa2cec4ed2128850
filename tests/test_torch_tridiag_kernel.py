"""Kernel K2 (ops/kernels/tridiag_kernel.py) on the CPU, where its wrapper
takes the plain PCR version, held against the JAX package's
``tridiag_solve_pallas`` in interpret mode on the same numpy bands (f64,
values and (d, e, F) gradients at 1e-10 relative).

The JAX kernel cannot take n = 1 (its ``e.reshape(-1, 0)`` divides by
zero), so n = 1 is held against the JAX package's XLA ``tridiag_solve``.
Each JAX shape compiles in interpret mode (seconds), so the JAX results
are computed once per module and shared.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from difffe_tpu.ops import tridiag as jtri
from difffe_tpu.ops.pallas.tridiag_kernel import tridiag_solve_pallas
from difffe_tpu_torch.ops import tridiag as ttri
from difffe_tpu_torch.ops.kernels import tridiag_kernel as tk
from torch_parity import as_torch, rel_err

torch.set_num_threads(1)

TOL = 1e-10          # f64, the JAX K2 tests' tolerance


def spd_bands(n, B=3, seed=0):
    """Strictly diagonally dominant SPD bands, built as
    tests/test_pallas_tridiag.py builds them, with a weight for the loss."""
    rng = np.random.default_rng(seed + n)
    e = -rng.random((B, n - 1)) - 0.1
    d = rng.random((B, n)) + 0.1
    d[:, :-1] -= e
    d[:, 1:] -= e
    return d, e, rng.standard_normal((B, n)), rng.standard_normal((B, n))


@jax.jit
def _jax_vjp(d, e, F, w):
    u, vjp = jax.vjp(tridiag_solve_pallas, d, e, F)
    return u, vjp(w)


@pytest.fixture(scope="module")
def jax_ref():
    """n → the JAX kernel's u and its (d, e, F) cotangents for the weight
    w, layout 'auto' (one interpret-mode compile per n)."""
    cache = {}

    def get(n):
        if n not in cache:
            cache[n] = _jax_vjp(*map(jnp.asarray, spd_bands(n)))
        return cache[n]
    return get


def _port_vjp(n, layout="auto", block_b=64):
    d, e, F, w = (as_torch(a) for a in spd_bands(n))
    ts = [t.clone().requires_grad_() for t in (d, e, F)]
    u = tk.tridiag_solve_kernel(*ts, block_b=block_b, layout=layout)
    u.backward(w)
    return u.detach(), [t.grad for t in ts]


@pytest.mark.parametrize("n", [2, 37, 200, 300])
def test_values_and_grads_match_jax(jax_ref, n):
    u_j, g_j = jax_ref(n)
    u_t, g_t = _port_vjp(n)
    assert rel_err(u_t, u_j) <= TOL
    for a, b in zip(g_t, g_j):
        assert a.shape == b.shape
        assert rel_err(a, b) <= TOL


@pytest.mark.parametrize("layout,n", [("transposed", 300), ("batch", 37),
                                      ("anything-else", 37)])
def test_layouts_match_jax(jax_ref, layout, n):
    """Every layout gives the JAX kernel's values (its 'auto' layout at this
    n: the layouts differ there only in padding); on the port the layout
    changes only the launch shape, so all layouts agree to the bit."""
    u_j, g_j = jax_ref(n)
    for block_b in (1, 64):
        u_t, g_t = _port_vjp(n, layout, block_b)
        assert rel_err(u_t, u_j) <= TOL
        assert rel_err(g_t[1], g_j[1]) <= TOL
        assert torch.equal(u_t, _port_vjp(n)[0])


def test_n1_matches_jax_xla():
    d, e, F, w = spd_bands(1)
    u_j = jtri.tridiag_solve(jnp.asarray(d), jnp.asarray(e), jnp.asarray(F))
    d, e, F = (as_torch(a).requires_grad_() for a in (d, e, F))
    u = tk.tridiag_solve_kernel(d, e, F)
    assert e.shape == (3, 0) and u.shape == (3, 1)
    assert rel_err(u, u_j) <= TOL
    u.backward(as_torch(w))
    assert rel_err(F.grad, as_torch(w) / d.detach()) <= TOL
    assert e.grad.shape == (3, 0)


def test_unbatched_and_shared_bands(jax_ref):
    """Unbatched (n,) systems, and one band pair shared by a batch of F
    (stride-0 rows): values as the JAX kernel on explicitly batched bands,
    gradients of the shared bands summed over the batch."""
    n = 37
    d, e, F, w = spd_bands(n)
    u_j, g_j = jax_ref(n)
    u1 = tk.tridiag_solve_kernel(as_torch(d[0]), as_torch(e[0]),
                                 as_torch(F[0]))
    assert u1.shape == (n,) and rel_err(u1, u_j[0]) <= TOL
    ds, es = (as_torch(a[0]).requires_grad_() for a in (d, e))
    Fs = as_torch(F).requires_grad_()
    u = tk.tridiag_solve_kernel(ds, es, Fs)
    u.backward(as_torch(w))
    d_b = np.broadcast_to(d[0], d.shape)
    e_b = np.broadcast_to(e[0], e.shape)
    uj, (gd, ge, gF) = _jax_vjp(*map(jnp.asarray, (d_b, e_b, F, w)))
    assert rel_err(u, uj) <= TOL
    assert ds.grad.shape == (n,) and rel_err(ds.grad, gd.sum(0)) <= TOL
    assert rel_err(es.grad, ge.sum(0)) <= TOL
    assert rel_err(Fs.grad, gF) <= TOL


def test_second_order_raises_in_both_packages():
    d, e, F, _ = spd_bands(9, B=2)

    def jloss(d):
        return jnp.sum(tridiag_solve_pallas(d, jnp.asarray(e),
                                            jnp.asarray(F)) ** 2)

    with pytest.raises(NotImplementedError):
        jax.grad(lambda d: jnp.sum(jax.grad(jloss)(d)))(jnp.asarray(d))
    dt = as_torch(d).requires_grad_()
    u = tk.tridiag_solve_kernel(dt, as_torch(e), as_torch(F))
    with pytest.raises(NotImplementedError, match="differentiable once"):
        torch.autograd.grad((u ** 2).sum(), dt, create_graph=True)
    (g,) = torch.autograd.grad((u ** 2).sum(), dt)
    assert g.shape == dt.shape and not g.requires_grad


def test_pallas_backend_of_the_band_solver():
    """``solve_poisson_tridiag(backend="pallas")`` goes through the K2
    wrapper on broadcast bands and matches the elementwise route, as does
    ``backend="spike"``."""
    from difffe_tpu_torch.mesh import FEMesh
    from difffe_tpu_torch.ops.assembly import (assemble_load,
                                               assemble_tridiag_1d)

    mesh = FEMesh.line(12, bc_left=0.3, bc_right=-1.0, dtype=torch.float64,
                       device="cpu")
    rng = np.random.default_rng(1)
    k = as_torch(1.0 + rng.random(12)).requires_grad_()
    f = as_torch(rng.standard_normal((4, 13)))
    d, e = assemble_tridiag_1d(mesh, k)
    F = assemble_load(mesh, f)
    u_x = ttri.solve_poisson_tridiag(mesh, d, e, F)
    u_p = ttri.solve_poisson_tridiag(mesh, d, e, F, backend="pallas")
    assert rel_err(u_p, u_x) <= 1e-13
    (g_x,) = torch.autograd.grad(u_x.square().sum(), k, retain_graph=True)
    (g_p,) = torch.autograd.grad(u_p.square().sum(), k, retain_graph=True)
    assert rel_err(g_p, g_x) <= 1e-12
    u_s = ttri.solve_poisson_tridiag(mesh, d, e, F, backend="spike",
                                     chunk=4)
    assert rel_err(u_s, u_x) <= 1e-13
    (g_s,) = torch.autograd.grad(u_s.square().sum(), k)
    assert rel_err(g_s, g_x) <= 1e-12
    with pytest.raises(ValueError, match="unknown tridiagonal backend"):
        ttri.solve_poisson_tridiag(mesh, d, e, F, backend="nope")


def test_launch_shape_and_argument_checks():
    assert tk.scenarios_per_block(129) == 3
    assert tk.scenarios_per_block(129, layout="batch") == 3
    assert tk.scenarios_per_block(129, block_b=2, layout="batch") == 2
    assert tk.scenarios_per_block(300) == 1
    assert tk.scenarios_per_block(2, block_b=8, layout="x") == 8
    with pytest.raises(ValueError, match="block_b"):
        tk.scenarios_per_block(10, block_b=0)
    d = torch.ones(3, 5, dtype=torch.float64)
    with pytest.raises(ValueError, match="tridiagonal systems"):
        tk.tridiag_solve_kernel(d, torch.ones(3, 5, dtype=torch.float64), d)
    before = dict(tk.launches)
    tk.tridiag_solve_kernel(d, -0.1 * d[:, 1:], d)
    assert tk.launches == before          # the CPU takes the plain version
