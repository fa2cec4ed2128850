"""The port's surrogate models, configs and command line against the JAX
package on the same numpy inputs (f64): the DeepONet forward on carried
weights and three training epochs from them, the collocation mask,
Laplacian and residual, and two blocks of two collocation epochs on the
JAX package's own initial weights and sampled points; then
``ScenarioConfig``, ``MetricsLogger`` and the CLI's commands on tiny
scenarios on the CPU.

Every JAX reference of a group is computed once a module, under one
``jax.jit`` where the JAX function can be traced from outside.
"""

import dataclasses
import functools
import io
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import difffe_tpu.models.collocation as jcol
import difffe_tpu.models.neural as jnn
import difffe_tpu.models.operator as jop
from difffe_tpu.mesh import FEMesh as JMesh
from difffe_tpu.utils import config as jcfg
from difffe_tpu_torch import cli
from difffe_tpu_torch.models import collocation as tcol
from difffe_tpu_torch.models import operator as top
from difffe_tpu_torch.models.neural import mlp_params_from_jax
from difffe_tpu_torch.utils import config as tcfg
from difffe_tpu_torch.utils.metrics import MetricsLogger
from torch_parity import as_torch, jax_mesh, port_mesh, rel_err

torch.set_num_threads(1)

FORWARD_TOL = 1e-12
TRAIN_TOL = 1e-9
LAPLACIAN_TOL = 1e-10
OP = dict(width=8, depth=2, n_basis=5)
COL = dict(hidden_dim=6, n_layers=2, n_points=5, n_epochs=4, lr=3e-3,
           resample_every=2)


def _line():
    return jax_mesh(JMesh.line, 12, bc_left=0.2, bc_right=-0.1,
                    dtype=jnp.float64)


def _forcing(x):
    mod = torch if isinstance(x, torch.Tensor) else jnp
    return (math.pi ** 2) * mod.sin(math.pi * x)


def _to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _jax_operator():
    """The JAX DeepONet's initial weights for PRNGKey(4), its forward on
    fixed features, and ``train_operator`` for 3 epochs from the same key
    (which draws those weights)."""
    mesh = _line()
    rng = np.random.default_rng(2)
    feats = rng.standard_normal((6, 2))
    targets = rng.standard_normal((6, mesh.n_nodes))
    key = jax.random.PRNGKey(4)
    p3, _, losses = jop.train_operator(mesh, feats, targets, n_epochs=3,
                                       lr=1e-2, key=key, **OP)
    # the initial weights train_operator drew, and the forward on them:
    # eager, on the ops train_operator already compiled
    p0 = jop.init_deeponet(key, 2, 1, OP["width"], OP["depth"],
                           OP["n_basis"], jnp.float64)
    u0 = jax.jit(lambda p, m: jop.deeponet_forward(p, mesh, m, feats))(
        p0, jnn.boundary_mask(mesh))
    return feats, targets, _to_numpy(p0), np.asarray(u0), _to_numpy(p3), \
        np.asarray(losses)


def _flat(net):
    return torch.cat([p.detach().reshape(-1) for p in net.parameters()])


def _jax_flat(params):
    """A DeepONetParams' arrays in the port module's parameter order."""
    return torch.cat([p.detach().reshape(-1) for p in
                      top.deeponet_params_from_jax(params).parameters()])


def test_deeponet_forward_and_training_match_jax():
    feats, targets, p0, ju0, p3, jl = _jax_operator()
    mesh = port_mesh(_line())
    net = top.deeponet_params_from_jax(p0)
    mask = top.boundary_mask(mesh)
    u = top.deeponet_forward(net, mesh, mask, as_torch(feats))
    assert u.shape == (6, mesh.n_nodes)
    assert rel_err(u, ju0) <= FORWARD_TOL
    trained, u_fn, losses = top.train_operator(
        mesh, as_torch(feats), as_torch(targets), n_epochs=3, lr=1e-2,
        init=net)
    assert losses.shape == (3,) and rel_err(losses, jl) <= TRAIN_TOL
    assert rel_err(_flat(trained), _jax_flat(p3)) <= TRAIN_TOL
    assert rel_err(_flat(net), _jax_flat(p0)) == 0.0   # trained a copy
    assert u_fn(as_torch(feats)).shape == (6, mesh.n_nodes)


def test_deeponet_init_from_a_generator():
    mesh = port_mesh(_line())
    feats = torch.randn(4, 2, dtype=torch.float64)
    a = top.init_deeponet(torch.Generator().manual_seed(1), 2, 1,
                          dtype=torch.float64, **OP)
    b = top.init_deeponet(torch.Generator().manual_seed(1), 2, 1,
                          dtype=torch.float64, **OP)
    assert torch.equal(_flat(a), _flat(b))
    assert a.branch.layers[-1].weight.shape == (OP["n_basis"], OP["width"])
    assert not a.branch.layers[-1].bias.any()
    u = top.deeponet_forward(a, mesh, top.boundary_mask(mesh), feats)
    # the lifting mask holds the Dirichlet nodes at zero for any scenario
    assert u.shape == (4, mesh.n_nodes) and not u[:, [0, -1]].any()


def _numpy_mlp(in_dim, rng, hidden=5, n_layers=2):
    """MLP weights [(W (d_in, d_out), b)] in the JAX package's layout."""
    dims = [in_dim] + [hidden] * n_layers + [1]
    return [(rng.uniform(-1, 1, (a, b)) / math.sqrt(a), rng.uniform(-1, 1, b))
            for a, b in zip(dims[:-1], dims[1:])]


@functools.lru_cache(maxsize=None)
def _jax_collocation():
    """The JAX package's mask, Laplacian and residuals for a 1D and a 2D
    network, and ``train_collocation`` for 2 blocks × 2 epochs with the
    initial weights and point blocks it draws from PRNGKey(9)."""
    line = _line()
    rect = jax_mesh(JMesh.rectangle, 6, 6, dtype=jnp.float64)
    key = jax.random.PRNGKey(9)
    xs1 = np.linspace(0.05, 0.95, 7)[:, None]
    rng = np.random.default_rng(4)
    xs2 = rng.random((5, 2))
    n_blocks = COL["n_epochs"] // COL["resample_every"]

    p1, p2 = _numpy_mlp(1, rng), _numpy_mlp(2, rng)
    params, _, losses = jcol.train_collocation(line, _forcing, key=key,
                                               **COL)
    # the initial weights and the point blocks train_collocation drew: its
    # own draws repeated, eagerly on the ops it already compiled
    k_init, k_pts = jax.random.split(key)
    init = jnn.init_mlp(k_init, 1, COL["hidden_dim"], COL["n_layers"],
                        jnp.float64)

    @jax.jit
    def run():
        phi1, phi2 = jcol.smooth_mask_fn(line), jcol.smooth_mask_fn(rect)
        blocks = jnp.stack([
            jcol.sample_collocation_points(line, kb, COL["n_points"])
            for kb in jax.random.split(k_pts, n_blocks)])
        return dict(
            p1=p1, p2=p2, phi1=jax.vmap(phi1)(xs1), phi2=jax.vmap(phi2)(xs2),
            lap1=jax.vmap(lambda x: jcol.laplacian(p1, phi1, x))(xs1),
            lap2=jax.vmap(lambda x: jcol.laplacian(p2, phi2, x))(xs2),
            res1=jcol.collocation_residual(p1, phi1, xs1, _forcing, 1.3),
            res2=jcol.collocation_residual(
                p2, phi2, xs2, lambda x: jnp.sum(x, axis=1), 0.7),
            blocks=blocks)

    ref = _to_numpy(run())
    ref["init"] = _to_numpy(init)
    return xs1, xs2, ref, _to_numpy(params), np.asarray(losses)


def test_collocation_mask_laplacian_and_residual_match_jax():
    xs1, xs2, ref, _, _ = _jax_collocation()
    line = port_mesh(_line())
    rect = port_mesh(jax_mesh(JMesh.rectangle, 6, 6, dtype=jnp.float64))
    phi1, phi2 = tcol.smooth_mask_fn(line), tcol.smooth_mask_fn(rect)
    net1, net2 = mlp_params_from_jax(ref["p1"]), mlp_params_from_jax(ref["p2"])
    x1, x2 = as_torch(xs1), as_torch(xs2)
    assert rel_err(phi1(x1), ref["phi1"]) <= 1e-15
    assert rel_err(phi2(x2), ref["phi2"]) <= 1e-15
    assert float(phi2(torch.tensor([0.5, 0.5], dtype=torch.float64))) == 1.0
    assert float(phi2(torch.tensor([0.0, 0.3], dtype=torch.float64))) == 0.0
    lap1 = torch.stack([tcol.laplacian(net1, phi1, x) for x in x1])
    assert rel_err(lap1, ref["lap1"]) <= LAPLACIAN_TOL
    assert rel_err(tcol._laplacians(net2, phi2, x2),
                   ref["lap2"]) <= LAPLACIAN_TOL
    assert rel_err(tcol.collocation_residual(net1, phi1, x1, _forcing, 1.3),
                   ref["res1"]) <= LAPLACIAN_TOL
    assert rel_err(tcol.collocation_residual(
        net2, phi2, x2, lambda x: x.sum(1), 0.7),
        ref["res2"]) <= LAPLACIAN_TOL


def test_collocation_training_on_jax_points_matches_jax():
    """Two blocks of two Adam epochs through the Hessian trace, from the
    JAX package's initial weights on its sampled points: the losses and
    the trained weights within 1e-9."""
    _, _, ref, jparams, jlosses = _jax_collocation()
    mesh = port_mesh(_line())
    net = mlp_params_from_jax(ref["init"])
    losses = tcol.train_collocation_on_points(
        net, mesh, _forcing, as_torch(ref["blocks"]), 1.0, COL["lr"],
        COL["resample_every"])
    assert losses.shape == (COL["n_epochs"],)
    assert rel_err(losses, jlosses) <= TRAIN_TOL
    assert rel_err(_flat(net), _flat(mlp_params_from_jax(jparams))) \
        <= TRAIN_TOL


def test_train_collocation_samples_from_a_generator():
    mesh = port_mesh(_line())
    kw = dict(COL, generator=torch.Generator().manual_seed(3))
    params, u_fn, losses = tcol.train_collocation(mesh, _forcing, **kw)
    again = tcol.train_collocation(
        mesh, _forcing, **dict(kw, generator=torch.Generator().manual_seed(3)))
    assert losses.shape == (COL["n_epochs"],)
    assert torch.equal(losses, again[2])
    pts = tcol.sample_collocation_points(
        mesh, torch.Generator().manual_seed(0), 50)
    assert pts.shape == (50, 1)
    assert float(pts.min()) >= 0.0 and float(pts.max()) <= 1.0
    u = u_fn(torch.tensor([[0.0], [0.5], [1.0]], dtype=torch.float64))
    assert u.shape == (3,) and float(u[0]) == 0.0 and float(u[2]) == 0.0


def test_scenario_configs_match_jax_and_round_trip():
    assert list(tcfg.BASELINE_CONFIGS) == list(jcfg.BASELINE_CONFIGS)
    for name, cfg in tcfg.BASELINE_CONFIGS.items():
        assert cfg.to_json() == jcfg.BASELINE_CONFIGS[name].to_json()
        assert tcfg.ScenarioConfig.from_dict(json.loads(cfg.to_json())) == cfg
    cfg = tcfg.ScenarioConfig.from_dict({"name": "x", "dim": 2,
                                         "cg_iters": 64})
    assert cfg.dim == 2 and cfg.extra == {"cg_iters": 64}
    assert cfg.to_json() == jcfg.ScenarioConfig.from_dict(
        {"name": "x", "dim": 2, "cg_iters": 64}).to_json()


def test_metrics_logger(tmp_path):
    stream = io.StringIO()
    m = MetricsLogger(stream=stream)
    m.log(0, loss=torch.tensor(0.5), note="a")
    m.log(1, loss=0.25)
    assert m.last("loss") == 0.25 and m.last("note") == "a"
    lines = [json.loads(s) for s in stream.getvalue().splitlines()]
    assert [r["loss"] for r in lines] == [0.5, 0.25]
    path = tmp_path / "sub" / "m.jsonl"
    m2 = MetricsLogger(path=str(path))
    m2.log(3, rate=2)
    m2.close()
    assert json.loads(path.read_text())["rate"] == 2.0
    assert [r["step"] for r in m.history] == [0, 1]


def _tiny(monkeypatch, name, **kw):
    monkeypatch.setitem(tcfg.BASELINE_CONFIGS, name, dataclasses.replace(
        tcfg.BASELINE_CONFIGS[name], **kw))


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_list_and_not_yet_ported(capsys, monkeypatch, tmp_path):
    """``list``, and the commands that were not yet ported, ``export`` and
    ``serve``, in process: as tests/test_utils.py drives the JAX CLI, κ = 2
    halves u and a malformed line gets an error reply while serving goes
    on; a gradient artifact answers loss and grad."""
    assert cli.main(["list"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert [line.split()[0] for line in out] == list(tcfg.BASELINE_CONFIGS)

    def serve(art, *lines):
        monkeypatch.setattr("sys.stdin", io.StringIO("\n".join(lines)))
        assert cli.main(["serve", art, "--device", "cpu"]) == 0
        return [json.loads(s) for s in capsys.readouterr().out.splitlines()]

    art, grad_art = str(tmp_path / "solver.pt2"), str(tmp_path / "grad.pt2")
    for path, extra in ((art, []), (grad_art, ["--grad"])):
        assert cli.main(["export", path, "--dim", "1", "--elements", "8",
                         "--batch", "2", "--device", "cpu", *extra]) == 0
        r = _last_json(capsys)
        assert r["artifact"] == path and r["bytes"] > 100
        assert r["grad"] == bool(extra)
    ones = [[1.0] * 9] * 2
    resp, err = serve(art, json.dumps({"kappa": [1.0, 2.0], "f": ones}),
                      "{not json")
    u = np.asarray(resp["u"])
    assert u.shape == (2, 9)
    np.testing.assert_allclose(u[1], u[0] / 2.0, atol=1e-6)
    assert "error" in err
    (g,) = serve(grad_art, json.dumps({"kappa": [0.0, 0.0], "f": ones,
                                       "u_data": (0.5 * u).tolist()}))
    assert g["loss"] > 0 and len(g["grad"]) == 2
    # u(κ) = u(1)/κ overshoots the halved data: raising κ lowers the loss
    assert all(x < 0 for x in g["grad"])


def test_cli_run_on_the_cpu(monkeypatch, capsys):
    """``run`` on tiny overrides of three scenarios, with the JAX CLI's
    result keys."""
    _tiny(monkeypatch, "topopt_2d", n_elements=6)
    assert cli.main(["run", "topopt_2d", "--steps", "2",
                     "--device", "cpu"]) == 0
    r = _last_json(capsys)
    assert set(r) == {"scenario", "compliance_initial", "compliance_final",
                      "volume"}
    assert r["compliance_final"] < r["compliance_initial"]
    assert abs(r["volume"] - 0.4) < 0.02
    _tiny(monkeypatch, "heat_mpc_1d", n_elements=8, horizon=4)
    assert cli.main(["run", "heat_mpc_1d", "--steps", "2",
                     "--device", "cpu"]) == 0
    r = _last_json(capsys)
    assert set(r) == {"scenario", "tracking_error"}
    assert math.isfinite(r["tracking_error"])
    _tiny(monkeypatch, "batched_inverse_1d", n_elements=8)
    assert cli.main(["run", "batched_inverse_1d", "--batch", "3",
                     "--steps", "5", "--device", "cpu"]) == 0
    r = _last_json(capsys)
    assert set(r) == {"scenario", "batch", "kappa_max_error", "final_loss"}
    assert r["batch"] == 3
