"""The port's edge-ELL path against the JAX package on the same numpy
inputs (f64): the gather tables of ``build_ell``, the applies, kernel K8's
plain version (the masked batch-minor operator, and with unit weights the
row gather-sum of the TPU probe P1), the unbatched and batch-minor ELL
solves with their gradients to κ, F and the Dirichlet values,
``fit_kappa``'s two generic routes ('generic_ell_batchminor' at B = 128,
'generic_adam' below), and the routing of ``fit_kappa`` on line meshes
that the CUDA K1 kernel does not take.

Meshes: a perturbed 8×8 rectangle and a perturbed 4×4×4 box with
``grid=None`` on both sides (``torch_parity.general_meshes``).  Each JAX
reference runs once per module, in one ``jax.jit`` per mesh.  Index tables
are equal; weights, applies and fixed-trip solves agree within 1e-10
relative, gradients within 1e-8, and ``fit_kappa``'s κ and loss history
within 1e-8.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import difffe_tpu.inverse as jinv
from difffe_tpu.mesh import FEMesh as JMesh
from difffe_tpu.ops import assembly as jasm
from difffe_tpu.ops import unstructured as jun
from difffe_tpu_torch.inverse import fit_kappa as t_fit
from difffe_tpu_torch.mesh import FEMesh as TMesh
from difffe_tpu_torch.ops import assembly as tasm
from difffe_tpu_torch.ops import cg as tcg
from difffe_tpu_torch.ops import pcg as tpcg
from difffe_tpu_torch.ops import unstructured as tun
from difffe_tpu_torch.ops.kernels import ell_kernel as k8
from difffe_tpu_torch.ops.kernels import fused_grad_cf_kernel as k1
from difffe_tpu_torch.solver import solve_poisson_batched as t_solve_b
from torch_parity import as_torch, general_meshes, jax_mesh, rel_err

torch.set_num_threads(1)

PARITY = 1e-10
GRAD = 1e-8
FIT = 1e-8
ITERS = 60
B = 4


@functools.cache
def _case(dim):
    if dim == 2:
        jm, tm = general_meshes(JMesh.rectangle, 8, 8, seed=5)
    else:
        jm, tm = general_meshes(JMesh.box, 4, 4, 4, seed=5)
    rng = np.random.default_rng(10 + dim)
    ne, nn = jm.n_elements, jm.n_nodes
    x = np.asarray(jm.nodes)
    f = np.sin(np.pi * x[:, 0]) * np.sin(np.pi * x[:, 1]) * 19.7
    arr = dict(
        k_el=1.0 + rng.random(ne), k_node=1.0 + rng.random(nn),
        kB=1.0 + rng.random((B, ne)), kB_node=1.0 + rng.random((B, nn)),
        ks=1.0 + 0.1 * np.arange(B), u=rng.standard_normal((B, nn)),
        FB=np.asarray(jasm.assemble_load(jm, jnp.asarray(
            f * (1.0 + 0.2 * rng.random((B, 1)))))),
        m=(rng.random(nn) < 0.3).astype(np.float64),
        ud=0.01 * rng.standard_normal((B, nn)),
    )
    return jm, tm, arr


@functools.cache
def _jref(dim):
    """The JAX tables and every reference value of one mesh."""
    jm, _, a = _case(dim)
    ell = jun.build_ell(jm)
    j = {k: jnp.asarray(v) for k, v in a.items()}

    @jax.jit
    def ref(j):
        out = {}
        out["Ku"] = jun.ell_apply(jm, ell, j["k_el"], j["u"])
        out["Ku_node"] = jun.ell_apply(jm, ell, j["k_node"], j["u"])
        out["diag"] = jun.ell_diag(jm, ell, j["k_el"])
        W, d = jun.ell_weights_bm(jm, ell, j["kB"].T)
        m = j["m"][:, None]
        v = j["u"].T
        out["masked"] = m * v + (1 - m) * jun.ell_apply_bm(
            ell, W, d, (1 - m) * v)
        out["W_bm"], out["diag_bm"] = W, d
        out["Ku_bm"] = jun.ell_apply_bm(ell, W, d, v)
        solve = functools.partial(jun.solve_poisson_cg_ell, jm, ell)
        out["ell"] = solve(j["k_el"], j["FB"][0], 0.0, ITERS)

        def loss_ell(k, F, g):
            mesh = JMesh(jm.nodes, jm.elements, jm.bc_mask, g)
            u = jun.solve_poisson_cg_ell(mesh, ell, k, F, 0.0, ITERS)
            return jnp.sum((u - j["ud"][0]) ** 2)
        out["grad_ell"] = jax.grad(loss_ell, argnums=(0, 1, 2))(
            j["k_el"], j["FB"][0], jm.bc_values + 0.1)

        solveB = functools.partial(jun.solve_poisson_cg_ell_batched, jm, ell)
        out["bm"] = solveB(j["kB"], j["FB"], 0.0, ITERS)
        out["bm_node"] = solveB(j["kB_node"], j["FB"], 0.0, ITERS)
        out["bm_scalar"] = solveB(j["ks"], j["FB"], 0.0, ITERS)

        def loss_bm(k, F, g):
            mesh = JMesh(jm.nodes, jm.elements, jm.bc_mask, g)
            u = jun.solve_poisson_cg_ell_batched(mesh, ell, k, F, 0.0, ITERS)
            return jnp.mean((u - j["ud"]) ** 2)
        g0 = jm.bc_values + 0.1 * jm.bc_mask * jm.nodes[:, 0]
        out["grad_bm"] = jax.grad(loss_bm, argnums=(0, 1, 2))(
            j["kB"], j["FB"], g0)
        out["bm_g"] = jun.solve_poisson_cg_ell_batched(
            JMesh(jm.nodes, jm.elements, jm.bc_mask, g0), ell, j["kB"],
            j["FB"], 0.0, ITERS)
        return out

    return ell, jax.tree_util.tree_map(np.asarray, ref(j))


@pytest.fixture(params=[2, 3], ids=["tri", "tet"])
def case(request):
    jm, tm, a = _case(request.param)
    jell, ref = _jref(request.param)
    return jm, tm, a, jell, ref


def _t(a, grad=False):
    return as_torch(a).requires_grad_(grad)


def test_tables_equal_jax(case):
    _, tm, _, jell, _ = case
    ell = tun.build_ell(tm)
    assert ell.nbr.dtype == torch.int32 and ell.nbr.device == tm.device
    for name in ("nbr", "edge_elem", "inc_elem"):
        np.testing.assert_array_equal(getattr(ell, name).numpy(),
                                      np.asarray(getattr(jell, name)))
    for name in ("edge_w", "wdiag"):
        assert rel_err(getattr(ell, name), getattr(jell, name)) <= 1e-14


def test_apply_and_diag(case):
    _, tm, a, _, ref = case
    ell = tun.build_ell(tm)
    k, u = _t(a["k_el"]), _t(a["u"])
    assert rel_err(tun.ell_apply(tm, ell, k, u), ref["Ku"]) <= PARITY
    assert rel_err(tun.ell_apply(tm, ell, _t(a["k_node"]), u),
                   ref["Ku_node"]) <= PARITY
    assert rel_err(tun.ell_diag(tm, ell, k), ref["diag"]) <= PARITY
    # the gather-only operator is the element operator
    assert rel_err(tun.ell_apply(tm, ell, k, u),
                   tasm.stiffness_apply(tm, k, u)) <= 1e-12
    assert rel_err(tun.ell_diag(tm, ell, k),
                   tcg.stiffness_diag(tm, k)) <= 1e-12


def test_k8_plain_is_the_masked_operator(case):
    _, tm, a, _, ref = case
    ell = tun.build_ell(tm)
    W, d = tun.ell_weights_bm(tm, ell, _t(a["kB"]).T)
    assert rel_err(W, ref["W_bm"]) <= PARITY
    assert rel_err(d, ref["diag_bm"]) <= PARITY
    before = dict(k8.launches)
    y = k8.ell_apply(ell.nbr, W, d, _t(a["u"]).T.contiguous(), _t(a["m"]))
    assert k8.launches == before           # CPU tensors: the plain version
    assert rel_err(y, ref["masked"]) <= PARITY
    # m ≡ 0: the unmasked batch-minor apply
    y0 = k8.ell_apply(ell.nbr, W, d, _t(a["u"]).T.contiguous(),
                      torch.zeros(tm.n_nodes, dtype=torch.float64))
    assert rel_err(y0, ref["Ku_bm"]) <= PARITY
    assert rel_err(tun.ell_apply_bm(ell, W, d, _t(a["u"]).T),
                   ref["Ku_bm"]) <= PARITY


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_k8_plain_is_p1_gather_sum(dtype):
    """P1's shapes: u (256, 8), idx (256, 8) int32, out = Σ_d u[idx]."""
    rng = np.random.default_rng(3)
    u = rng.standard_normal((256, 8)).astype(dtype)
    idx = rng.integers(0, 256, (256, 8)).astype(np.int32)
    want = u[idx].sum(axis=1)
    t = torch.from_numpy
    y = k8.ell_apply(t(idx), torch.ones(256, 8, 8, dtype=t(u).dtype),
                     torch.zeros(256, 8, dtype=t(u).dtype), t(u),
                     torch.zeros(256, dtype=t(u).dtype))
    tol = 1e-6 if dtype == np.float32 else 1e-14
    assert rel_err(y, want) <= tol


def test_k8_wrapper_checks_shapes():
    nbr = torch.zeros(4, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="n, B"):
        k8.ell_apply(nbr, torch.zeros(4, 2, 3), torch.zeros(4, 3),
                     torch.zeros(5, 3), torch.zeros(4))
    with pytest.raises(ValueError, match="CPU .plain. or CUDA"):
        k8.ell_apply(nbr.to("meta"), torch.zeros(4, 2, 3, device="meta"),
                     torch.zeros(4, 3, device="meta"),
                     torch.zeros(4, 3, device="meta"),
                     torch.zeros(4, device="meta"))


def _today_bm_pcg(nbr, W, diag, m, b, tol, maxiter):
    """The batch-minor PCG the batched ELL solve ran before K8s, restated:
    ops/pcg.pcg from 0 with per-scenario dots, one K8 application (its
    plain version on CPU tensors) an operator application."""
    mc = m[:, None]
    p = 1.0 - mc
    diagA = mc + p * diag
    Minv = 1.0 / torch.where(diagA.abs() > 1e-30, diagA,
                             torch.ones_like(diagA))
    return tpcg.pcg(lambda v: k8.ell_apply(nbr, W, diag, v.contiguous(), m),
                    b, lambda r: Minv * r, torch.zeros_like(b), tol, maxiter,
                    dot=lambda u, v: (u * v).sum(dim=0, keepdim=True))


@pytest.mark.parametrize("tol", [0.0, 1e-4], ids=["fixed", "gated"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ell_cg_plain_is_the_per_iteration_pcg(case, dtype, tol):
    """K8s's plain version (what the CPU runs) equals the PCG it replaced
    bit for bit, with a zero right-hand side (frozen from the start) among
    the scenarios; that scenario's solution is 0, with no NaN."""
    _, tm, a, _, _ = case
    ell = tun.build_ell(tm)
    W, d = (t.to(dtype) for t in tun.ell_weights_bm(tm, ell, _t(a["kB"]).T))
    m = tm.bc_mask.to(dtype)
    b = (1.0 - m[:, None]) * _t(a["FB"]).T.to(dtype)
    b[:, 2] = 0.0
    b = b.contiguous()
    before = dict(k8.launches)
    x = k8.ell_cg(ell.nbr, W, d, m, b, tol, ITERS)
    assert k8.launches == before           # CPU tensors: the plain version
    want = _today_bm_pcg(ell.nbr, W, d, m, b, tol, ITERS)
    assert x.dtype == dtype and torch.equal(x, want)
    assert torch.equal(k8.ell_cg_plain(ell.nbr, W, d, m, b, tol, ITERS), want)
    assert torch.isfinite(x).all() and not x[:, 2].any()


def test_unbatched_solve_and_gradients(case):
    jm, tm, a, _, ref = case
    ell = tun.build_ell(tm)
    u = tun.solve_poisson_cg_ell(tm, ell, _t(a["k_el"]), _t(a["FB"][0]),
                                 0.0, ITERS)
    assert rel_err(u, ref["ell"]) <= PARITY
    k, F = _t(a["k_el"], True), _t(a["FB"][0], True)
    g = (tm.bc_values + 0.1).requires_grad_()
    mesh = TMesh(tm.nodes, tm.elements, tm.bc_mask, g)
    u = tun.solve_poisson_cg_ell(mesh, ell, k, F, 0.0, ITERS)
    ((u - _t(a["ud"][0])) ** 2).sum().backward()
    for got, want in zip((k.grad, F.grad, g.grad), ref["grad_ell"]):
        assert rel_err(got, want) <= GRAD


@pytest.mark.parametrize("kappa", ["kB", "kB_node", "ks"])
def test_batched_solve(case, kappa):
    _, tm, a, _, ref = case
    ell = tun.build_ell(tm)
    u = tun.solve_poisson_cg_ell_batched(tm, ell, _t(a[kappa]),
                                         _t(a["FB"]), 0.0, ITERS)
    key = {"kB": "bm", "kB_node": "bm_node", "ks": "bm_scalar"}[kappa]
    assert u.shape == (B, tm.n_nodes)
    assert rel_err(u, ref[key]) <= PARITY
    if kappa == "kB":     # batch-minor ≡ batch-leading on each scenario
        u1 = tun.solve_poisson_cg_ell(tm, ell, _t(a["kB"][1]),
                                      _t(a["FB"][1]), 0.0, ITERS)
        assert rel_err(u[1], u1) <= 1e-12


def test_batched_gradients(case):
    _, tm, a, _, ref = case
    ell = tun.build_ell(tm)
    k, F = _t(a["kB"], True), _t(a["FB"], True)
    g0 = tm.bc_values + 0.1 * tm.bc_mask * tm.nodes[:, 0]
    g = g0.clone().requires_grad_()
    mesh = TMesh(tm.nodes, tm.elements, tm.bc_mask, g)
    u = tun.solve_poisson_cg_ell_batched(mesh, ell, k, F, 0.0, ITERS)
    assert rel_err(u, ref["bm_g"]) <= PARITY
    ((u - _t(a["ud"])) ** 2).mean().backward()
    for got, want in zip((k.grad, F.grad, g.grad), ref["grad_bm"]):
        assert rel_err(got, want) <= GRAD


def test_batched_refusals(case):
    _, tm, a, _, _ = case
    ell = tun.build_ell(tm)
    FB = _t(a["FB"])
    with pytest.raises(ValueError, match="B, n_nodes"):
        tun.solve_poisson_cg_ell_batched(tm, ell, _t(a["kB"]), FB[0], 0.0, 4)
    Fn = FB[:1].expand(tm.n_elements, -1)
    with pytest.raises(ValueError, match="ambiguous"):
        tun.solve_poisson_cg_ell_batched(
            tm, ell, torch.ones(tm.n_elements, dtype=torch.float64), Fn,
            0.0, 4)
    k = _t(a["kB"], True)
    u = tun.solve_poisson_cg_ell_batched(tm, ell, k, FB, 0.0, 8)
    with pytest.raises(NotImplementedError, match="differentiable once"):
        torch.autograd.grad(u.sum(), k, create_graph=True)


# ---------------------------------------------------------------------------
# fit_kappa's generic routes
# ---------------------------------------------------------------------------


@functools.cache
def _fit_problem(Bf):
    jm, tm = general_meshes(JMesh.rectangle, 6, 6, seed=2)
    rng = np.random.default_rng(4)
    x = np.asarray(jm.nodes)
    f = np.broadcast_to(2 * np.pi ** 2 * np.sin(np.pi * x[:, 0])
                        * np.sin(np.pi * x[:, 1]), (Bf, jm.n_nodes)).copy()
    kt = 1.0 + rng.random((Bf, jm.n_elements))
    ud = t_solve_b(tm, as_torch(kt), as_torch(f), method="dense").numpy()
    return jm, tm, f, ud


@pytest.mark.parametrize("Bf,path", [(128, "generic_ell_batchminor"),
                                     (3, "generic_adam")])
def test_fit_kappa_generic_routes(Bf, path):
    jm, tm, f, ud = _fit_problem(Bf)
    kw = dict(steps=3, iters=16) if Bf >= 128 else dict(steps=3)
    k_j, info_j = jinv.fit_kappa(jm, jnp.asarray(f), jnp.asarray(ud), **kw)
    k_t, info_t = t_fit(tm, as_torch(f), as_torch(ud), **kw)
    assert info_t["path"] == info_j["path"] == path
    assert set(info_t) == set(info_j)
    assert info_t["iters"] == info_j["iters"]
    assert k_t.shape == (Bf, jm.n_elements)
    assert rel_err(k_t, k_j) <= FIT
    assert rel_err(info_t["loss_history"], info_j["loss_history"]) <= FIT
    assert abs(info_t["eval_loss"] - info_j["eval_loss"]) <= \
        FIT * info_j["eval_loss"]
    hist = info_t["loss_history"]
    assert torch.all(hist[1:] < hist[:-1])


def test_fit_kappa_replaced_mask_takes_generic_route():
    jm = jax_mesh(JMesh.rectangle, 4, 4, dtype=jnp.float64)
    tm = TMesh.rectangle(4, 4, dtype=torch.float64, device="cpu")
    mask = tm.bc_mask.clone()
    mask[6] = 1.0
    pinned = TMesh(tm.nodes, tm.elements, mask, tm.bc_values, grid=tm.grid)
    f = torch.ones(2, tm.n_nodes, dtype=torch.float64)
    ud = t_solve_b(pinned, 1.3, f, method="dense")
    kappa, info = t_fit(pinned, f, ud, steps=2)
    assert info["path"] == "generic_adam"
    assert kappa.shape == (2, jm.n_elements)
    assert info["eval_loss"] < float(info["loss_history"][0])


# ---------------------------------------------------------------------------
# Line meshes K1 does not take: the torch closed form, decided up front
# ---------------------------------------------------------------------------


def _line_problem(n, dtype, B=8):
    mesh = TMesh.line(n, dtype=dtype, device="cpu")
    rng = np.random.default_rng(n)
    x = mesh.nodes[:, 0]
    f = (torch.sin(torch.pi * x) + 1.0).expand(B, n + 1)
    kt = torch.as_tensor(1.0 + 2.0 * rng.random((B, n)), dtype=dtype)
    ud = t_solve_b(mesh, kt, f, method="tridiag")
    return mesh, f, ud


def test_k1_routing_by_rows_and_dtype(monkeypatch):
    mesh, f, ud = _line_problem(30, torch.float32)
    k_chain, info_chain = t_fit(mesh, f, ud, steps=20)
    assert info_chain["path"] == "cf_chain_kernel"
    # more rows than the kernel takes: the torch closed form, same result
    monkeypatch.setattr(k1, "MAX_ROWS", 24)
    assert not k1.chain_takes(mesh)
    k_cf, info_cf = t_fit(mesh, f, ud, steps=20)
    assert info_cf["path"] == "cf_torch"
    assert info_cf["loss_history"].shape == (20,)
    # the chain reports its last inner step's loss: step 19
    assert rel_err(info_cf["loss_history"][-1],
                   info_chain["loss_history"][-1]) <= 1e-5
    assert rel_err(k_cf, k_chain) <= 1e-5
    assert abs(info_cf["eval_loss"] - info_chain["eval_loss"]) <= \
        1e-4 * info_chain["eval_loss"]
    monkeypatch.undo()
    # another dtype: the torch closed form as well
    m64, f64, ud64 = _line_problem(30, torch.float64)
    assert k1.chain_takes(mesh) and not k1.chain_takes(m64)
    k64, info64 = t_fit(m64, f64, ud64, steps=20)
    assert info64["path"] == "cf_torch"
    assert rel_err(k64, k_chain) <= 1e-5
    hist = info64["loss_history"]
    assert torch.all(hist[1:] < hist[:-1])
