"""The port's control layer against the JAX package on the same numpy
inputs (f64): heat rollouts on every route at θ = 1 and 0.5 with their
gradients to κ, u0 and the forcing, the batched rollout, the MPC planners
and the receding-horizon loop, the tracking cost and actuators, and the
topology-optimization pieces (filter, OC update, compliance and its
gradient, two OC iterations unbatched and batched).

Every JAX reference of a group is computed once a module under one
``jax.jit`` (eager JAX would compile op by op), at small sizes: a 12-element
line, a 6 × 6 rectangle, a few steps.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from difffe_tpu.control import heat as jh
from difffe_tpu.control import mpc as jm
from difffe_tpu.control import topopt as jt
from difffe_tpu.mesh import FEMesh as JMesh
from difffe_tpu_torch.control import heat as th
from difffe_tpu_torch.control import mpc as tm
from difffe_tpu_torch.control import topopt as tt
from torch_parity import as_torch, jax_mesh, port_mesh, rel_err

torch.set_num_threads(1)

H, DT = 3, 2e-3
ROLLOUT_TOL = 1e-10
PLAN_TOL = 1e-8
TOPOPT_TOL = 1e-8
COMPLIANCE_TOL = 1e-10
OC_TOL = 1e-12
B = 3
CENTERS = [0.25, 0.5, 0.75]
KAPPA_B = [0.8, 1.2, 1.6]
MPC = dict(horizon=4, dt=5e-3, lr=0.3, plan_iters=3, control_penalty=1e-3)
TOPOPT = dict(nx=6, ny=6, n_iters=2)


def _line():
    return jax_mesh(JMesh.line, 12, bc_left=0.2, bc_right=-0.1,
                    dtype=jnp.float64)


def _rect():
    return jax_mesh(JMesh.rectangle, 6, 6, dtype=jnp.float64)


@functools.lru_cache(maxsize=None)
def _inputs():
    """Batched rollout inputs on the line (the tridiag and dense routes)
    and on the rectangle (dense and cg): a κ field a scenario (B, ne), u0
    (B, n), f_seq (H, B, n) and the loss weights w (H, B, n)."""
    rng = np.random.default_rng(7)
    out = {}
    for name, mesh in (("line", _line()), ("rect", _rect())):
        n, ne = mesh.n_nodes, mesh.n_elements
        out[name] = (1.0 + rng.random((B, ne)), rng.standard_normal((B, n)),
                     rng.standard_normal((H, B, n)),
                     rng.standard_normal((H, B, n)))
    return out


# port route → (mesh, the JAX route of its reference).  JAX's dense and
# tridiag routes solve the same systems and agree to rounding
# (tests/test_control.py::test_dense_matches_tridiag), as its dense and cg
# routes do on the rectangle (the shifted system converges in far fewer
# than its n_nodes fixed CG iterations), so one JAX rollout a mesh and θ
# is the reference of every port route on that mesh: tracing one costs
# ~1 s here.
ROUTES = {"tridiag": ("line", "tridiag"),
          "tridiag_pallas": ("line", "tridiag"),
          "dense": ("line", "tridiag"),
          "dense_2d": ("rect", "dense"),
          "cg": ("rect", "dense")}


@functools.lru_cache(maxsize=None)
def _jax_rollouts():
    """{"mesh θ": (traj (H, B, n), (∂κ, ∂u0, ∂f_seq) of Σ w⊙traj)}: B
    independent rollouts, ``rollout_batched`` itself at θ = 1 (per-scenario
    κ fields) and the same ``vmap`` of ``rollout`` at θ = 0.5 (which
    ``rollout_batched`` does not take)."""
    meshes = {"line": _line(), "rect": _rect()}
    inp = _inputs()

    def case(mesh, method, theta, w, *args):
        if theta == 1.0:
            def batched(k, u0, fs):
                return jh.rollout_batched(mesh, k, u0, fs, DT, method)
        else:
            batched = jax.vmap(
                lambda k, u0, fs: jh.rollout(mesh, k, u0, fs, DT, method,
                                             theta), in_axes=(0, 0, 1),
                out_axes=1)

        def loss(*a):
            traj = batched(*a)
            return jnp.sum(w * traj), traj
        (_, traj), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                              has_aux=True)(*args)
        return traj, grads

    @jax.jit
    def run():
        out = {}
        for theta in (1.0, 0.5):
            for name, method in sorted(set(ROUTES.values())):
                k, u0, fs, w = inp[name]
                out[f"{name} {theta}"] = case(meshes[name], method, theta, w,
                                              k, u0, fs)
        return out

    return jax.tree_util.tree_map(np.asarray, run())


def _check_rollout(traj, args, jtraj, jgrads):
    assert traj.shape == jtraj.shape
    assert rel_err(traj.detach(), jtraj) <= ROLLOUT_TOL
    for a, g in zip(args, jgrads):
        assert rel_err(a.grad, g) <= ROLLOUT_TOL


@pytest.mark.parametrize("theta", [1.0, 0.5])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_rollout_and_gradients_match_jax(route, theta):
    """Each route (tridiag_pallas: K2's plain version on the CPU) against
    the JAX rollouts on the same mesh, on the batch (scenarios on leading
    axes) and on its first scenario alone: the trajectory and the
    gradients of Σ w⊙traj to κ, u0 and f_seq."""
    name, _ = ROUTES[route]
    jtraj, jgrads = _jax_rollouts()[f"{name} {theta}"]
    tmesh = port_mesh(_rect() if name == "rect" else _line())
    k, u0, fs, w = (as_torch(a) for a in _inputs()[name])
    method = route.replace("_2d", "")
    args = [a.clone().requires_grad_() for a in (k, u0, fs)]
    traj = th.rollout(tmesh, *args, DT, method=method, theta=theta)
    (w * traj).sum().backward()
    _check_rollout(traj, args, jtraj, jgrads)
    args = [a.clone().requires_grad_() for a in (k[0], u0[0], fs[:, 0])]
    traj = th.rollout(tmesh, *args, DT, method=method, theta=theta)
    (w[:, 0] * traj).sum().backward()
    _check_rollout(traj, args, jtraj[:, 0],
                   [g[0] for g in jgrads[:2]] + [jgrads[2][:, 0]])


def test_rollout_batched_matches_jax():
    """``rollout_batched`` with a κ field a scenario against the JAX
    package's; a (B,) κ is one scalar a scenario."""
    jtraj, jgrads = _jax_rollouts()["line 1.0"]
    mesh = port_mesh(_line())
    k, u0, fs, w = (as_torch(a) for a in _inputs()["line"])
    args = [a.clone().requires_grad_() for a in (k, u0, fs)]
    traj = th.rollout_batched(mesh, *args, DT)
    (w * traj).sum().backward()
    _check_rollout(traj, args, jtraj, jgrads)
    kb = torch.tensor([0.8, 1.2, 1.6], dtype=torch.float64)
    assert torch.equal(
        th.rollout_batched(mesh, kb, u0, fs, DT),
        th.rollout(mesh, kb[:, None].expand(B, mesh.n_elements), u0, fs, DT))


def test_auto_route_and_unknown_method():
    line, rect = port_mesh(_line()), port_mesh(_rect())
    assert th.resolve_method(line) == "tridiag"      # the CPU: K2's plain
    assert th.resolve_method(rect) == "dense"
    assert th.resolve_method(line, "cg") == "cg"
    with pytest.raises(ValueError, match="Unknown method"):
        th.rollout(line, 1.0, torch.zeros(line.n_nodes),
                   torch.zeros(1, line.n_nodes), DT, method="bogus")


def _mpc_data(mesh):
    """Target and the batched planner's inputs, from numpy."""
    x = np.asarray(mesh.nodes)[:, 0]
    tgt = np.broadcast_to(0.3 * np.sin(math.pi * x),
                          (MPC["horizon"], x.size))
    rng = np.random.default_rng(3)
    u0b = 0.1 * rng.standard_normal((B, x.size))
    tgtb = tgt[None] * np.array([1.0, 0.5, 0.2])[:, None, None]
    return tgt, u0b, tgtb


@functools.lru_cache(maxsize=None)
def _jax_mpc():
    mesh = _line()
    tgt, u0b, tgtb = _mpc_data(mesh)
    cfg = jm.MPCConfig(**MPC)
    H_, n = tgt.shape

    @jax.jit
    def run():
        act = jm.gaussian_actuators(mesh, CENTERS, 0.1)
        planb = jm.make_planner_batched(mesh, KAPPA_B, act, cfg)
        qb, lossesb = planb(u0b, tgtb, jnp.zeros((B, H_, 3)))
        states, applied = jm.receding_horizon(mesh, 1.0, jnp.zeros(n), act,
                                              tgt, cfg, 2)
        return act, qb, lossesb, states, applied

    return [np.asarray(a) for a in run()]


def test_planners_and_receding_horizon_match_jax():
    """The batched planner (3 scenarios, one κ each, their own targets and
    u0; H = 4, 3 Adam steps), ``make_planner`` on each scenario alone
    (JAX's batched planner ``vmap``s the same plan, so its rows are the
    unbatched planner's references) and two receding-horizon steps: q and
    the losses within 1e-8 (torch's Adam against optax's)."""
    jact, jqb, jlb, jst, jap = _jax_mpc()
    mesh = port_mesh(_line())
    tgt, u0b, tgtb = (as_torch(np.ascontiguousarray(a))
                      for a in _mpc_data(_line()))
    cfg = tm.MPCConfig(**MPC)
    act = tm.gaussian_actuators(mesh, CENTERS, 0.1)
    assert rel_err(act, jact) <= 1e-14
    q0 = torch.zeros(B, MPC["horizon"], 3, dtype=torch.float64)
    qb, lb = tm.make_planner_batched(
        mesh, torch.tensor(KAPPA_B, dtype=torch.float64), act, cfg)(
        u0b, tgtb, q0)
    assert lb.shape == (B, MPC["plan_iters"])
    assert rel_err(qb, jqb) <= PLAN_TOL and rel_err(lb, jlb) <= PLAN_TOL
    for b in range(B):
        q, losses = tm.make_planner(mesh, KAPPA_B[b], act, tgtb[b], cfg)(
            u0b[b], q0[b])
        assert losses.shape == (MPC["plan_iters"],)
        assert rel_err(q, jqb[b]) <= PLAN_TOL
        assert rel_err(losses, jlb[b]) <= PLAN_TOL
    states, applied = tm.receding_horizon(
        mesh, 1.0, torch.zeros(mesh.n_nodes, dtype=torch.float64), act, tgt,
        cfg, 2)
    assert states.shape == (3, mesh.n_nodes) and applied.shape == (2, 3)
    assert rel_err(states, jst) <= PLAN_TOL
    assert rel_err(applied, jap) <= PLAN_TOL


@functools.lru_cache(maxsize=None)
def _jax_small():
    """tracking_cost, 2D actuators, the density filter, oc_update (one
    grid and a vmapped batch of two) on fixed random inputs, and the cone
    kernels (eager: their size is a Python int)."""
    rng = np.random.default_rng(11)
    line, rect = _line(), _rect()
    n = line.n_nodes
    traj = rng.standard_normal((H, n))
    tgt = rng.standard_normal(n)
    ctl = rng.standard_normal((H, 3))
    rho = rng.random((B, 6, 6))
    dc = -rng.random((B, 6, 6))
    dc[0, 0, 0] = 0.3                       # positive: clipped
    centers2 = np.array([[0.3, 0.4], [0.7, 0.6]])
    cfg = jt.TopOptConfig(**TOPOPT)
    kernels = [np.asarray(jt.cone_filter_kernel(r, jnp.float64))
               for r in (1.5, 2.7)]
    mcfg = jm.MPCConfig(**MPC)

    @jax.jit
    def run():
        return (jm.tracking_cost(line, traj, tgt, ctl, mcfg),
                jm.gaussian_actuators(rect, centers2, 0.15),
                jt.density_filter(rho[0], kernels[0]),
                jax.vmap(lambda r: jt.density_filter(r, kernels[1]))(rho),
                jt.oc_update(rho[0], dc[0], cfg),
                jax.vmap(lambda r, d: jt.oc_update(r, d, cfg))(rho, dc))

    out = [np.asarray(a) for a in run()]
    return (traj, tgt, ctl, rho, dc, centers2), kernels, out


def test_cost_actuators_filter_and_oc_update_match_jax():
    (traj, tgt, ctl, rho, dc, centers2), jkernels, jout = _jax_small()
    jcost, jact2, jfilt, jfiltb, joc, jocb = jout
    line, rect = port_mesh(_line()), port_mesh(_rect())
    cost = tm.tracking_cost(line, as_torch(traj), as_torch(tgt),
                            as_torch(ctl), tm.MPCConfig(**MPC))
    assert cost.shape == () and rel_err(cost, jcost) <= 1e-13
    # per scenario, never across the batch
    costs = tm.tracking_cost(line, as_torch(np.stack([traj, 2 * traj])),
                             as_torch(tgt), as_torch(np.stack([ctl, ctl])),
                             tm.MPCConfig(**MPC))
    assert costs.shape == (2,) and rel_err(costs[0], jcost) <= 1e-13
    assert rel_err(tm.gaussian_actuators(rect, centers2, 0.15),
                   jact2) <= 1e-14
    kernels = [tt.cone_filter_kernel(r, torch.float64) for r in (1.5, 2.7)]
    assert [k.shape for k in kernels] == [(3, 3), (5, 5)]   # ⌊radius⌋
    for k, jk in zip(kernels, jkernels):
        assert rel_err(k, jk) <= 1e-15
    rho_t, dc_t = as_torch(rho), as_torch(dc)
    filt = tt.density_filter(rho_t[0], kernels[0])
    assert rel_err(filt, jfilt) <= 1e-14
    assert rel_err(tt.density_filter(rho_t, kernels[1]), jfiltb) <= 1e-14
    assert tt.density_filter(rho_t.float(), kernels[0]).dtype == \
        torch.float32
    cfg = tt.TopOptConfig(**TOPOPT)
    assert tt.oc_bisection_steps(torch.float64) == 25
    assert tt.oc_bisection_steps(torch.float32) == 25
    assert rel_err(tt.oc_update(rho_t[0], dc_t[0], cfg), joc) <= OC_TOL
    assert rel_err(tt.oc_update(rho_t, dc_t, cfg), jocb) <= OC_TOL


@functools.lru_cache(maxsize=None)
def _jax_topopt():
    """Compliance and its gradient at a random ρ, and two OC iterations of
    ``optimize_batched`` (two forcings: row 0 is the unbatched
    ``optimize``'s problem)."""
    mesh = _rect()
    cfg = jt.TopOptConfig(**TOPOPT)
    x = np.asarray(mesh.nodes)[:, 0]
    fb = np.stack([np.ones_like(x), 1.0 + 0.5 * np.sin(math.pi * x)])
    rho = 0.2 + 0.6 * np.random.default_rng(5).random((6, 6))
    kernel = jt.cone_filter_kernel(cfg.filter_radius, jnp.float64)
    c, dc = jax.jit(jax.value_and_grad(
        lambda r: jt.compliance(mesh, r, fb[1], cfg, kernel)))(rho)
    rhos, hists = jt.optimize_batched(mesh, fb, cfg)
    return fb, rho, [np.asarray(a) for a in (c, dc, rhos, hists)]


def test_compliance_and_gradient_match_jax():
    fb, rho, (jc, jdc, _, _) = _jax_topopt()
    mesh = port_mesh(_rect())
    cfg = tt.TopOptConfig(**TOPOPT)
    kernel = tt.cone_filter_kernel(cfg.filter_radius, torch.float64)
    r = as_torch(rho).requires_grad_()
    c = tt.compliance(mesh, r, as_torch(fb[1]), cfg, kernel)
    c.backward()
    assert c.shape == () and rel_err(c.detach(), jc) <= COMPLIANCE_TOL
    assert rel_err(r.grad, jdc) <= COMPLIANCE_TOL
    # scenario axes give one compliance a scenario
    cb = tt.compliance(mesh, as_torch(np.stack([rho, rho])), as_torch(fb),
                       cfg, kernel)
    assert cb.shape == (2,) and rel_err(cb[1], jc) <= COMPLIANCE_TOL


def test_optimize_and_optimize_batched_match_jax():
    """Two OC iterations: ρ and the compliance histories within 1e-8 (the
    batched state solve lets a converged scenario iterate on, where the
    vmapped JAX solve stops it)."""
    fb, _, (_, _, jrhos, jhists) = _jax_topopt()
    mesh = port_mesh(_rect())
    cfg = tt.TopOptConfig(**TOPOPT)
    rho, hist = tt.optimize(mesh, as_torch(fb[0]), cfg)
    assert rho.shape == (6, 6) and hist.shape == (2,)
    assert rel_err(rho, jrhos[0]) <= TOPOPT_TOL
    assert rel_err(hist, jhists[0]) <= TOPOPT_TOL
    rhos, hists = tt.optimize_batched(mesh, as_torch(fb), cfg)
    assert rhos.shape == (2, 6, 6) and hists.shape == (2, 2)
    assert rel_err(rhos, jrhos) <= TOPOPT_TOL
    assert rel_err(hists, jhists) <= TOPOPT_TOL
    assert abs(float(rhos.mean((-2, -1)).max()) - cfg.vol_frac) < 0.02
