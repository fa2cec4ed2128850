"""The PyTorch port's main path as a whole: ``fit_kappa`` on a line mesh,
held against the JAX package's ``fit_kappa`` on the same numpy inputs
(f64), plus the bench workload at a small batch.

The JAX shared-forcing route runs its chain kernel in interpret mode with
``cumsum_via="mxu"``, whose split-bf16 prefix sums are not exact.  The
fixture ``jax_vpu_chain`` makes that route use the exact ``"vpu"`` scan,
which the port's scan matches to rounding.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import difffe_tpu.inverse as jinv
import difffe_tpu.ops.pallas.fused_grad_cf_kernel as jk
import difffe_tpu_torch
from difffe_tpu.mesh import FEMesh as JMesh
from difffe_tpu_torch.inverse import fit_kappa as t_fit
from difffe_tpu_torch.mesh import FEMesh as TMesh
from difffe_tpu_torch.ops.assembly import assemble_load as t_load
from difffe_tpu_torch.ops.cf1d import solve_poisson_cf_batched
from difffe_tpu_torch.ops.kernels import fused_grad_cf_kernel as tk
from difffe_tpu_torch.solver import solve_poisson_batched as t_solve_b
from difffe_tpu_torch.utils.profiling import timeit_chained
from torch_parity import as_torch, jax_mesh, port_mesh, rel_err

torch.set_num_threads(1)

PARITY = 1e-9


@pytest.fixture
def jax_vpu_chain(monkeypatch):
    jinv._build_loop_1d.cache_clear()
    monkeypatch.setattr(jk, "kappa_sgd_chain_cf", functools.partial(
        jk.kappa_sgd_chain_cf, cumsum_via="vpu"))
    yield
    jinv._build_loop_1d.cache_clear()


def _problem(n=20, B=12, per_scenario_f=False, seed=0):
    jm = jax_mesh(JMesh.line, n, dtype=jnp.float64)
    tm = port_mesh(jm)
    rng = np.random.default_rng(seed)
    x = np.asarray(jm.nodes)[:, 0]
    f = np.broadcast_to(np.sin(np.pi * x) + 1.0, (B, n + 1)).copy()
    if per_scenario_f:
        f *= 1.0 + 0.3 * rng.random((B, 1))
    ke_true = 1.0 + 2.0 * rng.random((B, n))
    # the observations are data: the port's band solve (held to JAX's in
    # tests/test_torch_mesh_tridiag.py) spares eager JAX compiles
    ud = t_solve_b(tm, as_torch(ke_true), as_torch(f),
                   method="tridiag").numpy()
    return jm, tm, f, ud


@pytest.mark.parametrize("per_scenario_f,steps,path,n_hist", [
    # float64: K1 takes float32 planes only, so the shared forcing takes
    # the torch closed form too, against the JAX chain of one launch of
    # 32 steps and one of 8
    (False, 40, "cf_torch", 40),
    (True, 30, "cf_torch", 30),
])
def test_fit_kappa_matches_jax(jax_vpu_chain, per_scenario_f, steps, path,
                               n_hist):
    jm, tm, f, ud = _problem(per_scenario_f=per_scenario_f)
    k_j, info_j = jinv.fit_kappa(jm, jnp.asarray(f), jnp.asarray(ud),
                                 steps=steps)
    k_t, info_t = t_fit(tm, as_torch(f), as_torch(ud), steps=steps)
    assert info_t["path"] == path
    assert info_j["path"] == ("cf_xla" if per_scenario_f
                              else "cf_chain_pallas")
    assert set(info_t) == set(info_j)
    assert info_t["loss_history"].shape == (n_hist,)
    assert k_t.shape == (12, jm.n_elements)
    assert rel_err(k_t, k_j) <= PARITY
    hist_t = info_t["loss_history"]
    if not per_scenario_f:
        # the chain reports the loss of each launch's last inner step
        hist_t = hist_t[[31, 39]]
    assert rel_err(hist_t, info_j["loss_history"]) <= PARITY
    assert abs(info_t["eval_loss"] - info_j["eval_loss"]) <= \
        PARITY * info_j["eval_loss"]
    hist = info_t["loss_history"]
    assert info_t["eval_loss"] < float(hist[0])
    assert torch.all(hist[1:] < hist[:-1])


def test_fit_kappa_kappa0_single_scenario_and_no_eval(jax_vpu_chain):
    jm, tm, f, ud = _problem(B=3)
    k0 = 1.0 + 0.1 * np.arange(jm.n_elements) / jm.n_elements
    k_j, info_j = jinv.fit_kappa(jm, jnp.asarray(f[0]), jnp.asarray(ud[0]),
                                 steps=7, kappa0=jnp.asarray(k0), lr=10.0,
                                 eval_final=False)
    k_t, info_t = t_fit(tm, as_torch(f[0]), as_torch(ud[0]), steps=7,
                        kappa0=as_torch(k0),
                        lr=10.0, eval_final=False)
    assert k_t.shape == (1, jm.n_elements)
    assert info_t["eval_loss"] is None and info_j["eval_loss"] is None
    assert rel_err(k_t, k_j) <= PARITY


def test_fit_kappa_unported_routes_raise():
    _, tm, f, ud = _problem(B=2)
    # an interior pin is no closed-form chain: the generic Adam route
    _, info = t_fit(tm.with_dirichlet([5], 0.0), as_torch(f), as_torch(ud),
                    steps=2)
    assert info["path"] == "generic_adam"
    # a triangle mesh without a grid: the generic routes (slice E)
    tri = TMesh.from_arrays(np.array([[0., 0.], [1., 0.], [0., 1.],
                                      [0.4, 0.3]]),
                            np.array([[0, 1, 3], [1, 2, 3], [2, 0, 3]]),
                            np.array([1., 1., 1., 0.]), np.zeros(4),
                            device="cpu")
    _, info = t_fit(tri, torch.ones(4), torch.zeros(4), steps=2)
    assert info["path"] == "generic_adam"


def test_bench_workload_small_batch(jax_vpu_chain):
    """bench.py's workload at B = 64: n = 30, one shared forcing, bf16
    observation plane, chain k = 32, lr = 30, scale = 2/n, two launches,
    with its in-run gradient-parity gate against the tridiag oracle."""
    n_el, B, k, lr = 30, 64, 32, 30.0
    jm, tm, f, _ = _problem(n=n_el, B=B)
    n = n_el + 1
    rng = np.random.default_rng(11)
    ke_true = 1.0 + 2.0 * rng.random((B, n_el))
    ud = t_solve_b(tm, as_torch(ke_true), as_torch(f), method="tridiag")
    F = t_load(tm, as_torch(f[0]))
    keT, aux = tk.cf_packed_operands(tm, torch.ones(B, n_el, dtype=F.dtype),
                                     F, ud, block_lanes=512,
                                     operand_dtype=torch.bfloat16)
    # parity gate: the packed step's gradient against autograd through the
    # PCR oracle, both on the bf16-quantized plane
    ud_q = aux["udT"][:n, :B].T.to(F.dtype)
    _, gT = tk.kappa_mse_step_cf_packed(keT, aux, scale=2.0 / n)
    ke = torch.ones(B, n_el, dtype=F.dtype, requires_grad=True)
    u = t_solve_b(tm, ke, as_torch(f), method="tridiag")
    ((u - ud_q) ** 2).mean(-1).sum().backward()
    assert rel_err(tk.cf_unpack(gT, aux), ke.grad) < 1e-4

    jkeT, jaux = jk.cf_packed_operands(
        jm, jnp.ones((B, n_el)), jnp.asarray(F.numpy()),
        jnp.asarray(ud.numpy()), block_lanes=512,
        operand_dtype=jnp.bfloat16)
    jchain = jax.jit(lambda keT: jk.kappa_sgd_chain_cf(keT, jaux, k, lr,
                                                       scale=2.0 / n))
    hist = []
    for _ in range(2):
        lp_t, keT = tk.kappa_sgd_chain_cf(keT, aux, k, lr, scale=2.0 / n)
        lp_j, jkeT = jchain(jkeT)
        assert rel_err(lp_t[0, :B], np.asarray(lp_j)[0, :B]) <= PARITY
        hist.append(float(lp_t[0, :B].mean()) / n)
    assert rel_err(tk.cf_unpack(keT, aux), jk.cf_unpack(jkeT, jaux)) <= PARITY
    kappa = tk.cf_unpack(keT, aux)
    def misfit(k):
        u = solve_poisson_cf_batched(tm, k, as_torch(f))
        return float(((u - ud) ** 2).mean())

    loss0 = misfit(torch.ones(B, n_el, dtype=F.dtype))
    loss = misfit(kappa)
    assert torch.isfinite(kappa).all()
    assert hist[1] < hist[0] and loss < loss0 / 10


def test_lazy_exports():
    from difffe_tpu_torch import inverse, losses, solver
    from difffe_tpu_torch.models import neural

    for name in difffe_tpu_torch.__all__:
        assert callable(getattr(difffe_tpu_torch, name)), name
    assert difffe_tpu_torch.fit_kappa is t_fit
    assert difffe_tpu_torch.recover_kappa_field is inverse.recover_kappa_field
    assert difffe_tpu_torch.recover_kappa_scalar is \
        inverse.recover_kappa_scalar
    assert difffe_tpu_torch.DifferentiableFESolver is \
        solver.DifferentiableFESolver
    assert difffe_tpu_torch.PhysicsLoss is losses.PhysicsLoss
    assert difffe_tpu_torch.NeuralPDE is neural.NeuralPDE
    with pytest.raises(AttributeError):
        difffe_tpu_torch.train_collocation


def test_timeit_chained_refuses_to_time_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the cuda test times it")
    with pytest.raises(RuntimeError, match="CUDA"):
        timeit_chained(lambda c: c + 1, torch.zeros(4), length=2)
