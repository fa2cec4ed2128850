"""The port's physics losses and neural surrogate against the JAX package
on the same numpy inputs (f64): ``PhysicsLoss``'s three modes and their
gradients, the lifting masks, the MLP carried across by
``mlp_params_from_jax``, and ``train_pde`` / ``train_pde_batched`` loss
histories within 1e-8 relative over a few epochs (``torch.optim.Adam``
standing in for ``optax.adam``); then the three stages of
examples/poisson_1d_demo.py on the port alone, with the demo's gates.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import difffe_tpu.models.neural as jnn
from difffe_tpu.losses import PhysicsLoss as JLoss
from difffe_tpu.mesh import FEMesh as JMesh
from difffe_tpu_torch.losses import PhysicsLoss as TLoss
from difffe_tpu_torch.mesh import FEMesh as TMesh
from difffe_tpu_torch.models import neural as tnn
from difffe_tpu_torch.solver import solve_poisson
from torch_parity import as_torch, jax_mesh, port_mesh, rel_err

torch.set_num_threads(1)

F64 = torch.float64
HIST = 1e-8


@functools.lru_cache(maxsize=None)
def _jax_init_compiled(in_dim, hidden, n_layers):
    return jax.jit(lambda key: jnn.init_mlp(key, in_dim, hidden, n_layers,
                                            dtype=jnp.float64))


def _jax_init(seed, in_dim, hidden, n_layers):
    """The JAX package's initial MLP weights for PRNGKey(seed)."""
    return _jax_init_compiled(in_dim, hidden, n_layers)(
        jax.random.PRNGKey(seed))


def _forcing(x):
    mod = jnp if isinstance(x, jax.Array) else torch
    return mod.sin(math.pi * x) + 1.0


@pytest.mark.parametrize("mode", ["fem_match", "variational", "energy"])
def test_physics_loss_modes_match_jax(mode):
    jm = jax_mesh(JMesh.line, 12, bc_left=0.1, bc_right=-0.3,
                  dtype=jnp.float64)
    tm = port_mesh(jm)
    u = np.random.default_rng(1).standard_normal(jm.n_nodes)
    jl = JLoss(jm, _forcing, mode=mode, kappa=1.5)
    tl = TLoss(tm, _forcing, mode=mode, kappa=1.5)
    if mode == "fem_match":
        jl.u_fem            # the cached target, solved before tracing
    jv, jg = jax.jit(jax.value_and_grad(jl))(jnp.asarray(u))
    ut = as_torch(u).requires_grad_()
    tv = tl(ut)
    tv.backward()
    assert abs(float(tv.detach()) - float(jv)) <= 1e-12 * abs(float(jv))
    assert rel_err(ut.grad, jg) <= 1e-12
    if mode == "fem_match":
        cached = tl.u_fem
        assert tl(ut.detach()) == tv.detach() and tl.u_fem is cached
        assert rel_err(cached, jl.u_fem) <= 1e-12
        assert not cached.requires_grad


def test_physics_loss_validation_and_solver_kappa():
    tm = TMesh.line(8, dtype=F64, device="cpu")
    with pytest.raises(ValueError, match="Unknown mode"):
        TLoss(tm, torch.ones_like, mode="bogus")
    from difffe_tpu_torch.solver import DifferentiableFESolver
    tl = TLoss(tm, torch.ones_like, mode="energy",
               solver=DifferentiableFESolver(tm, kappa=3.0))
    assert float(tl.kappa) == 3.0
    u_fem = solve_poisson(tm, 3.0, torch.ones(9, dtype=F64))
    assert float(TLoss(tm, torch.ones_like, kappa=3.0)(u_fem)) == 0.0
    x = tm.nodes[:, 0]
    from difffe_tpu_torch.losses import variational_fd_loss
    assert float(variational_fd_loss(tm, x * (1 - x), 2 + 0 * x)) < 1e-20
    rect = TMesh.rectangle(2, 2, dtype=F64, device="cpu")
    with pytest.raises(NotImplementedError, match="1D"):
        variational_fd_loss(rect, torch.zeros(9), torch.zeros(9))


@pytest.mark.parametrize("bc", [(0.0, 0.0), (None, 0.0), (None, None)])
def test_masks_match_jax(bc):
    jm = jax_mesh(JMesh.line, 10, x_left=-1.0, x_right=2.0, bc_left=bc[0],
                  bc_right=bc[1], dtype=jnp.float64)
    tm = port_mesh(jm)
    assert rel_err(tnn.boundary_mask(tm), jnn.boundary_mask(jm)) <= 1e-15
    xq = np.linspace(-1.5, 2.5, 7)[:, None]
    assert rel_err(tnn.boundary_mask_at(tm, as_torch(xq)),
                   jnn.boundary_mask_at(jm, jnp.asarray(xq))) <= 1e-15
    jr = jax_mesh(JMesh.rectangle, 3, 2, dtype=jnp.float64)
    tr = port_mesh(jr)
    np.testing.assert_array_equal(tnn.boundary_mask(tr).numpy(),
                                  np.asarray(jnn.boundary_mask(jr)))
    with pytest.raises(NotImplementedError, match="1D"):
        tnn.boundary_mask_at(tr, torch.zeros(2, 2, dtype=F64))


@pytest.mark.parametrize("in_dim", [1, 2])
def test_mlp_forward_matches_jax(in_dim):
    params = _jax_init(3, in_dim, 16, 3)
    net = tnn.mlp_params_from_jax(params)
    assert [tuple(p.shape) for p in net.parameters()] == [
        s for W, b in params for s in (W.shape[::-1], b.shape)]
    assert net.layers[0].weight.dtype == F64
    x = np.random.default_rng(4).standard_normal((9, in_dim))
    jm = (jax_mesh(JMesh.line, 8, dtype=jnp.float64) if in_dim == 1
          else jax_mesh(JMesh.rectangle, 2, 3, dtype=jnp.float64))
    tm = port_mesh(jm)
    mask_j, mask_t = jnn.boundary_mask(jm), tnn.boundary_mask(tm)
    j_apply, j_nodes = jax.jit(lambda p, x, m: (
        jnn.apply_mlp(p, x), jnn.neural_pde_forward(p, jm, m)))(
        params, jnp.asarray(x), mask_j)
    assert rel_err(net(as_torch(x)), j_apply) <= 1e-14
    assert rel_err(tnn.neural_pde_forward(net, tm, mask_t), j_nodes) <= 1e-14
    if in_dim == 1:     # the query-point mask reads the host (no jit)
        assert rel_err(tnn.neural_pde_forward(net, tm, mask_t, as_torch(x)),
                       jnn.neural_pde_forward(params, jm, mask_j,
                                              jnp.asarray(x))) <= 1e-14


def test_init_mlp_bounds_and_seed():
    net = tnn.init_mlp(torch.Generator().manual_seed(0), 1, 32, 2,
                       dtype=F64)
    for layer in net.layers:
        bound = 1.0 / math.sqrt(layer.in_features)
        assert float(layer.weight.detach().abs().max()) <= bound
        assert float(layer.bias.detach().abs().max()) <= bound
    again = tnn.init_mlp(torch.Generator().manual_seed(0), 1, 32, 2,
                         dtype=F64)
    assert all(torch.equal(a, b) for a, b in zip(net.parameters(),
                                                 again.parameters()))


@pytest.mark.parametrize("mode", ["fem_match", "variational", "energy"])
def test_train_pde_matches_jax(mode):
    jm = jax_mesh(JMesh.line, 10, dtype=jnp.float64)
    tm = port_mesh(jm)
    params = _jax_init(0, 1, 12, 2)
    p_j, l_j = jnn.train_pde(params, jm, _forcing, n_epochs=25, lr=1e-2,
                             mode=mode, kappa=1.3)
    start = tnn.mlp_params_from_jax(params)
    p_t, l_t = tnn.train_pde(start, tm, _forcing, n_epochs=25, lr=1e-2,
                             mode=mode, kappa=1.3)
    assert l_t.shape == (25,) and rel_err(l_t, l_j) <= HIST
    for layer, (W, b) in zip(p_t.layers, p_j):
        assert rel_err(layer.weight.T, W) <= HIST
        assert rel_err(layer.bias, b) <= HIST
    # the input network is left as it was
    assert rel_err(start.layers[0].weight.T, params[0][0]) == 0.0
    with pytest.raises(ValueError, match="Unknown mode"):
        tnn.train_pde(start, tm, _forcing, n_epochs=1, mode="bogus")


def test_train_pde_batched_matches_jax():
    """Three networks with per-scenario κ in one batched program, from the
    JAX package's initial weights for its keys."""
    jm = jax_mesh(JMesh.line, 10, dtype=jnp.float64)
    tm = port_mesh(jm)
    B = 3
    x = np.asarray(jm.nodes)[:, 0]
    f = np.linspace(0.5, 2.0, B)[:, None] * np.sin(np.pi * x)
    k = np.array([1.0, 2.0, 4.0])
    keys = jax.random.split(jax.random.PRNGKey(1), B)
    p_j, l_j = jnn.train_pde_batched(keys, jm, jnp.asarray(f), n_epochs=20,
                                     lr=3e-3, hidden_dim=8, n_layers=2,
                                     kappa=jnp.asarray(k))
    init = jax.jit(jax.vmap(lambda key: jnn.init_mlp(key, 1, 8, 2,
                                                     dtype=jnp.float64)))
    inits = [tnn.mlp_params_from_jax([(W[b], bb[b]) for W, bb in
                                      init(keys)]) for b in range(B)]
    p_t, l_t = tnn.train_pde_batched(inits, tm, as_torch(f), n_epochs=20,
                                     lr=3e-3, hidden_dim=8, n_layers=2,
                                     kappa=as_torch(k))
    assert l_t.shape == (B, 20) and rel_err(l_t, l_j) <= HIST
    for (W, b), Wt, bt in zip(p_j, p_t.W, p_t.b):
        assert rel_err(Wt, W) <= HIST and rel_err(bt[:, 0], b) <= HIST
    mask = tnn.boundary_mask(tm)
    u_t = tnn.neural_pde_forward(p_t, tm, mask)
    mask_j = jnn.boundary_mask(jm)
    u_j = jax.jit(jax.vmap(lambda p: jnn.neural_pde_forward(p, jm, mask_j))
                  )(p_j)
    assert u_t.shape == (B, jm.n_nodes) and rel_err(u_t, u_j) <= HIST


def test_train_pde_batched_from_generators():
    """Networks drawn from B generators, with the shared κ default."""
    tm = TMesh.line(10, dtype=F64, device="cpu")
    f = torch.sin(math.pi * tm.nodes[:, 0]) * torch.tensor(
        [[0.5], [1.0], [2.0]], dtype=F64)
    gens = [torch.Generator().manual_seed(s) for s in range(3)]
    p_g, l_g = tnn.train_pde_batched(gens, tm, f, n_epochs=30, lr=3e-3,
                                     hidden_dim=8, n_layers=2)
    assert l_g.shape == (3, 30) and torch.isfinite(l_g).all()
    assert bool((l_g[:, -1] < l_g[:, 0]).all())
    assert p_g.W[0].shape == (3, 1, 8) and p_g.b[0].shape == (3, 1, 8)
    # network b started from generator b's draw: its first loss is the
    # fem_match loss of that network
    first = tnn.init_mlp(torch.Generator().manual_seed(1), 1, 8, 2,
                         dtype=F64)
    u_fem = solve_poisson(tm, 1.0, f[1])
    with torch.no_grad():
        u0 = tnn.neural_pde_forward(first, tm, tnn.boundary_mask(tm))
    assert float(l_g[1, 0]) == pytest.approx(
        float(((u0 - u_fem) ** 2).mean()), rel=1e-12)


def test_neural_pde_class_and_demo_stages(capsys):
    """examples/poisson_1d_demo.py's three stages on the port, with its
    gates, and the NeuralPDE class's Dirichlet values and logging."""
    mesh = TMesh.line(20, dtype=F64, device="cpu")
    x = mesh.nodes[:, 0]
    u_fem = solve_poisson(mesh, 1.0, torch.ones_like(x))
    assert float((u_fem - x * (1.0 - x) / 2.0).abs().max()) <= 1e-13

    model = tnn.NeuralPDE(mesh, hidden_dim=64, n_layers=3,
                          generator=torch.Generator().manual_seed(42))
    assert abs(float(model()[0])) < 1e-10 and model.forward == model.__call__
    losses = model.train_pde(torch.ones_like, n_epochs=3000, lr=1e-3,
                             log_every=1000)
    assert len(losses) == 3000 and losses[-1] < losses[0]
    assert capsys.readouterr().out.count("Epoch") == 3
    with torch.no_grad():
        u_nn = model()
    free = torch.as_tensor(mesh.free_nodes())
    rel = float((u_nn[free] - u_fem[free]).abs().max()
                / u_fem[free].abs().max())
    assert rel < 0.05
    assert abs(float(u_nn[0])) < 1e-10 and abs(float(u_nn[-1])) < 1e-10

    m30 = TMesh.line(30, dtype=F64, device="cpu")
    x30 = m30.nodes[:, 0]
    f_ref = torch.sin(math.pi * x30) + 1.0
    u_data = solve_poisson(m30, 2.0, f_ref)
    k = torch.tensor(1.0, dtype=F64, requires_grad=True)
    opt = torch.optim.Adam([k], lr=0.1, betas=(0.9, 0.999), eps=1e-8)
    for _ in range(200):
        opt.zero_grad()
        ((solve_poisson(m30, k.abs(), f_ref) - u_data) ** 2).mean().backward()
        opt.step()
    assert abs(float(k.abs()) - 2.0) < 1e-4

    rect = TMesh.rectangle(3, 3, dtype=F64, device="cpu")
    u2 = tnn.NeuralPDE(rect, hidden_dim=8, n_layers=2)()
    assert u2.shape == (16,) and float(u2[rect.bc_mask > 0.5].abs().max()) \
        == 0.0
