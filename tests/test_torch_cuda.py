"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA card and skips without one.  The file imports
no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import math

import pytest
import torch

from difffe_tpu_torch import production
from difffe_tpu_torch.inverse import fit_kappa
from difffe_tpu_torch.mesh import FEMesh
from difffe_tpu_torch.ops.assembly import assemble_load
from difffe_tpu_torch.ops.kernels import fused_grad_cf_kernel as tk
from difffe_tpu_torch.ops.kernels import fused_grad_kernel as k5
from difffe_tpu_torch.ops.kernels import fused_grad_mxu_kernel as k7
from difffe_tpu_torch.ops.kernels import fused_grad_thomas_kernel as k6
from difffe_tpu_torch.ops.kernels import stencil3d_cg_kernel as k4
from difffe_tpu_torch.ops.kernels import stencil_cg_kernel as sk
from difffe_tpu_torch.ops.kernels import ell_kernel as k8
from difffe_tpu_torch.ops.kernels import tridiag_kernel as k2
from difffe_tpu_torch.ops import unstructured as tun
from difffe_tpu_torch.ops import tridiag as ttri
from difffe_tpu_torch.ops.stencil import StructuredGrid, residual_vjp_manual
from difffe_tpu_torch.ops.stencil3d import (StructuredGrid3,
                                            residual_vjp_manual_3d)
from difffe_tpu_torch.probes import k7_ablation as k7ab
from difffe_tpu_torch.solver import solve_poisson_batched
from difffe_tpu_torch.utils.profiling import timeit_chained
from torch_parity import perturbed_nodes, rel_err

pytestmark = pytest.mark.cuda

STEP_TOL = 1e-5     # f32 running sums vs torch.cumsum, one step
CHAIN_TOL = 1e-4    # the same over a 32-step chain


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the K1-K7 kernels have no CPU mode")
    return torch.device("cuda")


def _operands(dev, n, B, ud_mode):
    mesh = FEMesh.line(n, bc_left=0.3, bc_right=-0.2, dtype=torch.float32,
                       device=dev)
    g = torch.Generator(device=dev).manual_seed(n * 7919 + B)
    fv = torch.sin(torch.pi * mesh.nodes[:, 0]) + 1.0
    ke_true = 1.0 + 2.0 * torch.rand(B, n, generator=g, device=dev)
    ud = solve_poisson_batched(mesh, ke_true, fv, method="tridiag")
    if ud_mode == "shared":
        ud = ud[0]
    ke0 = 1.0 + 0.3 * torch.rand(B, n, generator=g, device=dev)
    return tk.cf_packed_operands(
        mesh, ke0, assemble_load(mesh, fv), ud,
        operand_dtype=torch.bfloat16 if ud_mode == "bf16" else None)


@pytest.mark.parametrize("n", [10, 30, 60, 100, 128])
@pytest.mark.parametrize("ud_mode", ["shared", "f32", "bf16"])
def test_kernel_matches_plain(cuda, n, ud_mode):
    """The K1 body of n's row bucket (n = 10, 30: NB = 32; 60: 64; 100:
    128; 128: 256) against the plain version; padded lanes inert."""
    keT, aux = _operands(cuda, n, 1000, ud_mode)
    B, scale = aux["B"], 2.0 / (n + 1)
    args = (aux["udT"], aux["cols"], B, scale, aux["u_l"], aux["u_r"])
    before = dict(tk.launches)
    lp_k, g_k = tk.kappa_mse_step_cf_packed(keT, aux, scale=scale)
    lc_k, k_k = tk.kappa_sgd_chain_cf(keT, aux, 32, 30.0, scale=scale)
    lp_p, g_p = tk._cf_step_plain(keT, *args)
    lc_p, k_p = tk._cf_chain_plain(keT, *args, 32, 30.0)
    torch.cuda.synchronize()
    assert tk.launches["step"] == before["step"] + 1
    assert tk.launches["chain"] == before["chain"] + 1
    assert rel_err(g_k[:, :B], g_p[:, :B]) <= STEP_TOL
    assert rel_err(lp_k[:, :B], lp_p[:, :B]) <= STEP_TOL
    assert rel_err(k_k[:, :B], k_p[:, :B]) <= CHAIN_TOL
    assert rel_err(lc_k[:, :B], lc_p[:, :B]) <= CHAIN_TOL
    assert torch.all(g_k[:, B:] == 0) and torch.all(lp_k[:, B:] == 0)
    assert torch.all(lc_k[:, B:] == 0)
    assert torch.equal(k_k[:, B:], keT[:, B:])


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    keT, aux = _operands(cuda, 30, 64, "f32")
    with pytest.raises(TypeError, match="float32"):
        tk.kappa_mse_step_cf_packed(keT.double(), aux)
    with pytest.raises(ValueError, match="contiguous"):
        tk.kappa_sgd_chain_cf(keT.t().contiguous().t(), aux, 2, 30.0)
    big = FEMesh.line(300, dtype=torch.float32, device=cuda)
    keT2, aux2 = tk.cf_packed_operands(
        big, torch.ones(4, 300, device=cuda), torch.ones(301, device=cuda),
        torch.zeros(4, 301, device=cuda))
    with pytest.raises(ValueError, match="at most 256"):
        tk.kappa_sgd_chain_cf(keT2, aux2, 2, 30.0)


def test_fit_kappa_launches_the_chain_kernel(cuda):
    mesh = FEMesh.line(30, dtype=torch.float32, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    B = 4096
    f = (torch.sin(torch.pi * mesh.nodes[:, 0]) + 1.0).expand(B, 31)
    ud = solve_poisson_batched(
        mesh, 1.0 + 2.0 * torch.rand(B, 30, generator=g, device=cuda), f,
        method="tridiag")
    before = tk.launches["chain"]
    kappa, info = fit_kappa(mesh, f, ud, steps=128)
    assert info["path"] == "cf_chain_kernel"
    assert tk.launches["chain"] == before + 4
    assert torch.isfinite(kappa).all()
    hist = info["loss_history"]
    assert torch.all(hist[1:] < hist[:-1])


def test_timeit_chained_times_the_card(cuda):
    t = timeit_chained(lambda x: x * 1.0001, torch.ones(1024, device=cuda),
                       length=4, repeats=2)
    assert t.min_s > 0 and t.iters == 8


# ---------------------------------------------------------------------------
# K3a / K3b: whole-CG stencil kernels.  f32 CG amplifies summation-order
# differences, so the kernel is held against the plain version run in f64
# on the card: its error may be at most twice the f32 plain version's error
# against the same f64 run, plus 1e-6.
# ---------------------------------------------------------------------------


def _within_rule(kernel, plain32, plain64, slack=1e-6):
    ek, ep = rel_err(kernel, plain64), rel_err(plain32, plain64)
    return ek <= 2.0 * ep + slack, (ek, ep)


def _k3_problem(dev, n, B, g_nonzero, seed):
    """f64 κ planes, forcing, Dirichlet values and observations."""
    grid = StructuredGrid.unit(n, n)
    gen = torch.Generator(device=dev).manual_seed(seed)
    f64 = dict(dtype=torch.float64, device=dev)
    kl = 1.2 + 0.6 * torch.rand(B, n, n, generator=gen, **f64)
    ku = 1.2 + 0.6 * torch.rand(B, n, n, generator=gen, **f64)
    xs = torch.linspace(0.0, 1.0, n + 1, **f64)
    Y, X = torch.meshgrid(xs, xs, indexing="ij")
    bump = torch.sin(math.pi * X) * torch.sin(math.pi * Y)
    f = 10.0 * bump * (1.0 + 0.2 * torch.rand(B, 1, 1, generator=gen, **f64))
    g = 0.3 * X + 0.1 * Y if g_nonzero else torch.zeros_like(X)
    ud = 0.05 * bump * (1.0 + torch.rand(B, 1, 1, generator=gen, **f64))
    return grid, (kl, ku, f, g, ud)


def _k3b_steps(grid, arrays, dtype, cg2, iters, steps, lr=30.0):
    """``steps`` SGD steps on κ, the first cold and the rest warm-started,
    each through ``cg2`` (the K3b wrapper or its plain version)."""
    kl, ku, f, g, ud = (a.to(dtype).contiguous() for a in arrays)
    H, W = grid.node_shape
    scale = 2.0 / (H * W)
    out, state = [], None
    for _ in range(steps):
        C, D, b, Minv, x0, _ = sk._prepare(grid, (kl, ku), f, g)
        x0, lam0 = state if state else (x0, torch.zeros_like(b))
        x, lam = cg2(D, b, Minv, x0, lam0, ud, scale, iters)
        (gl, gu), _, _ = residual_vjp_manual(grid, (kl, ku), f, g, x, lam,
                                             C=C)
        out.append({"x": x, "lam": lam, "grad": torch.stack([gl, gu])})
        state = (x, lam)
        kl, ku = kl - lr * gl, ku - lr * gu
    return out


def _forced(launch, plan):
    """A K3b/K4b wrapper pinned to ``plan`` (a cluster size or a route the
    plan would not pick for the shape)."""
    return lambda *args: launch(*args, plan=plan)


def _k3b_plans(n):
    """Every K3b plan the card can run at an n² grid: each cluster size
    whose block fits, then the workspace route."""
    nodes, limit = (n + 1) ** 2, sk.smem_optin(torch.cuda.current_device())
    plans = []
    for c in sk.CLUSTER_SIZES:
        try:
            plans.append(sk.cluster_layout(nodes, 5, 4, c, limit))
        except ValueError:
            pass
    return plans + [sk.workspace_plan(nodes)]


_K3B_CASES = ([(8, 7, None), (64, 16, None)]
              + [(64, 16, c) for c in (1, 2, 4, 8, 16, "workspace")]
              + [(256, 2, None)])


@pytest.mark.parametrize(
    "n,B,forced", _K3B_CASES,
    ids=[f"{n}x{n}_B{B}" + ("" if c is None else f"_C{c}" if c != "workspace"
                            else "_workspace") for n, B, c in _K3B_CASES])
@pytest.mark.parametrize("g_nonzero", [False, True], ids=["g0", "g"])
def test_k3b_matches_plain_cold_and_warm(cuda, n, B, forced, g_nonzero):
    """K3b on the plan's route, and at 64² on every cluster size that fits
    and the workspace route, by the rule; 256² takes 16-block clusters; a
    second run repeats the first bit for bit."""
    grid, arrays = _k3_problem(cuda, n, B, g_nonzero, seed=n + B)
    plan = sk.cluster_plan((n + 1) ** 2, 5, 4, sk.smem_optin(cuda.index or 0))
    if forced is not None:
        plan = {p.cluster or "workspace": p for p in _k3b_plans(n)}[forced]
    if n == 256:
        assert (plan.route, plan.cluster) == ("cluster", 16)
    count = "cg2" if plan.route == "cluster" else "cg2_workspace"
    cg2 = _forced(sk._launch_cg2, plan)
    before = sk.launches[count]
    kern = _k3b_steps(grid, arrays, torch.float32, cg2, 32, 4)
    again = _k3b_steps(grid, arrays, torch.float32, cg2, 32, 4)
    p32 = _k3b_steps(grid, arrays, torch.float32, sk._cg2_plain, 32, 4)
    p64 = _k3b_steps(grid, arrays, torch.float64, sk._cg2_plain, 32, 4)
    torch.cuda.synchronize()
    assert sk.launches[count] == before + 8
    for step, (k, a, p, q) in enumerate(zip(kern, again, p32, p64)):
        for key in ("x", "lam", "grad"):
            assert torch.isfinite(k[key]).all()
            assert torch.equal(k[key], a[key]), (step, key)
            ok, errs = _within_rule(k[key], p[key], q[key])
            assert ok, (step, key, errs)


@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
def test_k3b_freezes_in_every_block_alike(cuda, cluster):
    """At 8² CG reaches its noise floor long before 256 iterations: every
    rank takes the same freeze decision (16 ranks of 6 nodes leave two
    empty), so 256 and 400 iterations give the same bits, within the rule
    of the plain version's frozen state."""
    grid, arrays = _k3_problem(cuda, 8, 5, True, seed=11)
    plan = sk.cluster_layout(81, 5, 4, cluster,
                             sk.smem_optin(cuda.index or 0))
    cg2 = _forced(sk._launch_cg2, plan)
    kern = _k3b_steps(grid, arrays, torch.float32, cg2, 256, 1)[0]
    longer = _k3b_steps(grid, arrays, torch.float32, cg2, 400, 1)[0]
    p32 = _k3b_steps(grid, arrays, torch.float32, sk._cg2_plain, 256, 1)[0]
    p64 = _k3b_steps(grid, arrays, torch.float64, sk._cg2_plain, 256, 1)[0]
    torch.cuda.synchronize()
    for key in ("x", "lam", "grad"):
        assert torch.equal(kern[key], longer[key]), key
        ok, errs = _within_rule(kern[key], p32[key], p64[key])
        assert ok, (key, errs)


@pytest.mark.parametrize("n,B,iters", [(8, 7, 64), (64, 16, 256),
                                       (256, 2, 128)],
                         ids=["8x8_B7", "64x64_B16", "256x256_B2"])
def test_k3a_matches_plain(cuda, n, B, iters):
    grid, arrays = _k3_problem(cuda, n, B, True, seed=3 * n + B)
    out = {}
    for name, dt, cg in (("kernel", torch.float32, sk._cg),
                         ("f32", torch.float32, sk._cg_plain),
                         ("f64", torch.float64, sk._cg_plain)):
        kl, ku, f, g, ud = (a.to(dt).contiguous() for a in arrays)
        _, D, b, Minv, x0, _ = sk._prepare(grid, (kl, ku), f, g)
        # a forward solve from m·g and an adjoint-style solve from 0
        out[name] = (cg(D, b, Minv, x0, iters),
                     cg(D, ud, Minv, torch.zeros_like(ud), iters))
    # no atomics: a second launch repeats the first bit for bit
    kl, ku, f, g, _ = (a.float().contiguous() for a in arrays)
    _, D, b, Minv, x0, _ = sk._prepare(grid, (kl, ku), f, g)
    again = sk._cg(D, b, Minv, x0, iters)
    torch.cuda.synchronize()
    assert torch.equal(again, out["kernel"][0])
    for i in range(2):
        assert torch.isfinite(out["kernel"][i]).all()
        ok, errs = _within_rule(out["kernel"][i], out["f32"][i],
                                out["f64"][i])
        assert ok, (i, errs)


_K3A_ROUTES = [(8, 7, 1), (8, 7, "workspace"), (64, 16, 1),
               (64, 16, "workspace"), (256, 2, 16), (256, 2, "workspace"),
               (288, 1, None)]


@pytest.mark.parametrize(
    "n,B,forced", _K3A_ROUTES,
    ids=[f"{n}x{n}_" + (f"C{c}" if isinstance(c, int) else str(c))
         for n, B, c in _K3A_ROUTES])
def test_k3a_matches_plain_on_every_route(cuda, n, B, forced):
    """K3a on K3b's plan (C = 1 at 8² and 64², 16 at 256², the workspace
    route past 285²) and on the workspace route forced: by the rule, cold
    (from m·g and from 0) and warm (from the cold solve's x), each route's
    launch counted as its own."""
    grid, arrays = _k3_problem(cuda, n, B, True, seed=7 * n + B)
    nodes = (n + 1) ** 2
    plan = sk.cluster_plan(nodes, 5, 4, sk.smem_optin(cuda.index or 0))
    if forced == "workspace":
        plan = sk.workspace_plan(nodes)
    else:
        assert plan.cluster == (forced or 0), plan
    count = "cg" if plan.route == "cluster" else "cg_workspace"
    cg = _forced(sk._launch_cg, plan)
    kl, ku, f, g, ud = (a.float().contiguous() for a in arrays)
    _, D, b, Minv, x0, _ = sk._prepare(grid, (kl, ku), f, g)
    before = sk.launches[count]
    warm = cg(D, b, Minv, x0, 16)
    out = {"kernel": (cg(D, b, Minv, x0, 96),
                      cg(D, ud, Minv, torch.zeros_like(ud), 96),
                      cg(D, b, Minv, warm, 96))}
    torch.cuda.synchronize()
    assert sk.launches[count] == before + 4
    assert torch.equal(cg(D, b, Minv, warm, 96), out["kernel"][2])
    for name, dt in (("f32", torch.float32), ("f64", torch.float64)):
        kl, ku, f, g, ud = (a.to(dt).contiguous() for a in arrays)
        _, D, b, Minv, x0, _ = sk._prepare(grid, (kl, ku), f, g)
        out[name] = (sk._cg_plain(D, b, Minv, x0, 96),
                     sk._cg_plain(D, ud, Minv, torch.zeros_like(ud), 96),
                     sk._cg_plain(D, b, Minv, warm.to(dt), 96))
    for i in range(3):
        assert torch.isfinite(out["kernel"][i]).all()
        ok, errs = _within_rule(out["kernel"][i], out["f32"][i],
                                out["f64"][i])
        assert ok, (i, errs)


def test_k3_wrappers_reject_what_the_kernels_do_not_take(cuda):
    grid, arrays = _k3_problem(cuda, 8, 3, False, seed=0)
    kl, ku, f, g, ud = (a.float().contiguous() for a in arrays)
    _, D, b, Minv, x0, _ = sk._prepare(grid, (kl, ku), f, g)
    with pytest.raises(TypeError, match="float32"):
        sk._cg(D.double(), b.double(), Minv.double(), x0.double(), 4)
    with pytest.raises(ValueError, match="contiguous"):
        sk._cg(D, b.transpose(1, 2), Minv, x0, 4)
    with pytest.raises(ValueError, match="block_b"):
        sk._cg2(D, b, Minv, x0, x0, ud, 1.0, 4, block_b=0)
    with pytest.raises(ValueError, match="B, H, W"):
        sk._cg(D, b[:2], Minv, x0, 4)


def test_factories_default_to_the_card(cuda):
    assert FEMesh.line(30).device.type == "cuda"
    assert FEMesh.rectangle(8, 8).device.type == "cuda"
    assert FEMesh.box(3, 2, 2).device.type == "cuda"


def test_2d_routes_launch_k3(cuda):
    mesh = FEMesh.rectangle(8, 8, dtype=torch.float32)
    B = 8
    gen = torch.Generator(device=cuda).manual_seed(1)
    x, y = mesh.nodes.T
    f = (10.0 * torch.sin(math.pi * x) * torch.sin(math.pi * y)).expand(
        B, mesh.n_nodes)
    k_true = 1.2 + 0.6 * torch.rand(B, mesh.n_elements, generator=gen,
                                    device=cuda)
    before = dict(sk.launches)
    ud = solve_poisson_batched(mesh, k_true, f, cg_tol=0.0, cg_maxiter=200)
    assert sk.launches["cg"] == before["cg"] + 1
    k = torch.ones(B, mesh.n_elements, device=cuda, requires_grad=True)
    (solve_poisson_batched(mesh, k, f, cg_tol=0.0, cg_maxiter=64) ** 2
     ).sum().backward()
    assert sk.launches["cg"] == before["cg"] + 3      # forward and adjoint
    assert torch.isfinite(k.grad).all()
    kappa, info = fit_kappa(mesh, f, ud, steps=40, block_b=2)
    assert info["path"] == "stencil2d_fused"
    assert sk.launches["cg2"] == before["cg2"] + 40
    assert torch.isfinite(kappa).all()
    assert info["eval_loss"] < 0.5 * float(info["loss_history"][0])


# ---------------------------------------------------------------------------
# K3a on the natural route (ops/stencil_natural.py): generalized-mask and
# natural-BC planes, held by the K3 rule above.
# ---------------------------------------------------------------------------


def _natural_planes(dev, n, B, variant, seed):
    """f64 (kl, ku, f, g, m, qn, C_r, rload) of an n² grid: "natural"
    (Dirichlet on the left edge only, a per-scenario Neumann flux on the
    right edge, an axis-adjacent Robin edge on top) or "pins" (the factory
    boundary and two interior pins)."""
    grid, (kl, ku, f, g, _) = _k3_problem(dev, n, B, True, seed)
    opts = dict(dtype=torch.float64, device=dev)
    m = torch.zeros(n + 1, n + 1, **opts)
    qn = C_r = rload = None
    if variant == "natural":
        h = 1.0 / n
        m[:, 0] = 1.0
        qn = torch.zeros(B, n + 1, n + 1, **opts)
        qn[:, :, -1] = h * torch.linspace(1.0, 2.0, B, **opts)[:, None]
        C_r = torch.zeros(7, n + 1, n + 1, **opts)
        C_r[0, -1, :] = 4.0 * h / 6.0
        C_r[0, -1, [0, -1]] = 2.0 * h / 6.0
        C_r[1, -1, :-1] = h / 6.0
        C_r[2, -1, 1:] = h / 6.0
        rload = torch.zeros(n + 1, n + 1, **opts)
        rload[-1, :] = 0.5 * h
    else:
        m[[0, -1], :] = 1.0
        m[:, [0, -1]] = 1.0
        m[n // 2, n // 2] = m[n // 4, 3 * n // 4] = 1.0
    return grid, (kl, ku, f, g, m, qn, C_r, rload)


@pytest.mark.parametrize("n,B", [(8, 7), (64, 16), (256, 2)],
                         ids=["8x8_B7", "64x64_B16", "256x256_B2"])
@pytest.mark.parametrize("variant", ["natural", "pins"])
def test_k3a_natural_planes_match_plain(cuda, n, B, variant):
    """K3a on the folded natural and custom-mask planes by the rule, on
    the route its plan names, a second launch equal bit for bit."""
    from difffe_tpu_torch.ops import stencil_natural as nat

    grid, arrays = _natural_planes(cuda, n, B, variant, seed=5 * n + B)
    plan = sk.cluster_plan((n + 1) ** 2, 5, 4, sk.smem_optin(cuda.index or 0))
    count = "cg" if plan.route == "cluster" else "cg_workspace"
    before = dict(sk.launches)
    out = {}
    for name, dt, cg in (("kernel", torch.float32, sk._cg),
                         ("f32", torch.float32, sk._cg_plain),
                         ("f64", torch.float64, sk._cg_plain)):
        kl, ku, f, g, m, qn, C_r, rl = (None if a is None else a.to(dt)
                                        for a in arrays)
        _, D, b, Minv, x0, _ = nat._prep_nat_pallas(grid, (kl, ku), f, g, m,
                                                    qn, C_r, rl)
        rhs = ((1.0 - m) * f).contiguous()
        out[name] = (cg(D, b, Minv, x0, 128),
                     cg(D, rhs, Minv, torch.zeros_like(rhs), 128))
        if name == "kernel":
            again = cg(D, b, Minv, x0, 128)
    torch.cuda.synchronize()
    assert sk.launches[count] == before[count] + 3
    assert torch.equal(again, out["kernel"][0])
    for i in range(2):
        assert torch.isfinite(out["kernel"][i]).all()
        ok, errs = _within_rule(out["kernel"][i], out["f32"][i],
                                out["f64"][i])
        assert ok, (i, errs)


def test_natural_facade_route_launches_k3a(cuda):
    """solve_poisson_batched with a custom mask, a batched Neumann load and
    a Robin edge, fixed trip: one K3a launch forward and one for the
    gradient, on the route the plan names; the answer is the dense
    route's."""
    import dataclasses

    from difffe_tpu_torch.ops.neumann import boundary_edges, edge_flux_load
    from difffe_tpu_torch.ops.robin import robin_edges

    full = FEMesh.rectangle(8, 8, dtype=torch.float32)
    left = (full.nodes[:, 0].abs() < 1e-6).float()
    mesh = dataclasses.replace(full, bc_mask=left,
                               bc_values=torch.zeros_like(left))
    B, nn = 6, mesh.n_nodes
    gen = torch.Generator(device=cuda).manual_seed(2)
    right = boundary_edges(mesh, predicate=lambda p: abs(p[0] - 1.0) < 1e-6)
    top = boundary_edges(mesh, predicate=lambda p: abs(p[1] - 1.0) < 1e-6)
    nm = edge_flux_load(mesh, right, torch.rand(B, nn, generator=gen,
                                                device=cuda))
    rb = robin_edges(mesh, top, 2.0, torch.ones(nn, device=cuda))
    f = torch.rand(B, nn, generator=gen, device=cuda)
    k = (1.0 + torch.rand(B, mesh.n_elements, generator=gen, device=cuda)
         ).requires_grad_()
    plan = sk.cluster_plan(81, 5, 4, sk.smem_optin(cuda.index or 0))
    count = "cg" if plan.route == "cluster" else "cg_workspace"
    before = dict(sk.launches)
    u = solve_poisson_batched(mesh, k, f, neumann=nm, robin=rb, cg_tol=0.0,
                              cg_maxiter=128)
    (u ** 2).sum().backward()
    torch.cuda.synchronize()
    assert {key: sk.launches[key] - before[key] for key in sk.launches} == \
        {key: 2 if key == count else 0 for key in sk.launches}
    kd = k.detach().double().requires_grad_()
    u_d = solve_poisson_batched(
        dataclasses.replace(mesh, nodes=mesh.nodes.double(),
                            bc_mask=left.double(),
                            bc_values=torch.zeros_like(left.double())),
        kd, f.double(), method="dense", neumann=nm.double(),
        robin=dataclasses.replace(rb, vals=rb.vals.double(),
                                  load=rb.load.double()))
    (u_d ** 2).sum().backward()
    assert rel_err(u, u_d) <= 1e-5
    assert rel_err(k.grad, kd.grad) <= 1e-4


@pytest.mark.parametrize("n,B,chunk", [(4096, 64, 64), (1000, 7, 32)])
def test_spike_f64_matches_pcr(cuda, n, B, chunk):
    from difffe_tpu_torch.ops.spike import tridiag_solve_spike

    gen = torch.Generator(device=cuda).manual_seed(n + B)
    f64 = dict(dtype=torch.float64, device=cuda)
    e = -torch.rand(B, n - 1, generator=gen, **f64) - 0.1
    d = torch.rand(B, n, generator=gen, **f64) + 0.1
    d[:, :-1] -= e
    d[:, 1:] -= e
    F = torch.randn(B, n, generator=gen, **f64)
    w = torch.randn(B, n, generator=gen, **f64)
    grads = []
    for solve in (lambda *t: tridiag_solve_spike(*t, chunk),
                  ttri.tridiag_solve):
        ts = [t.clone().requires_grad_() for t in (d, e, F)]
        u = solve(*ts)
        u.backward(w)
        grads.append([u.detach()] + [t.grad for t in ts])
    for a, b in zip(*grads):
        assert rel_err(a, b) <= 1e-12


# ---------------------------------------------------------------------------
# K4a / K4b: whole-CG 3D stencil kernels, held by the K3 rule above.  The
# (12, 9, 6) box is non-cubic; 32³ takes the global-workspace route.
# ---------------------------------------------------------------------------


def _k4_problem(dev, n, B, g_nonzero, seed):
    """f64 per-tet κ, forcing, Dirichlet values and observations."""
    nx, ny, nz = n
    grid = StructuredGrid3.unit(nx, ny, nz)
    gen = torch.Generator(device=dev).manual_seed(seed)
    f64 = dict(dtype=torch.float64, device=dev)
    k = 1.2 + 0.6 * torch.rand(B, grid.n_elements, generator=gen, **f64)
    Z, Y, X = torch.meshgrid(*(torch.linspace(0.0, 1.0, m + 1, **f64)
                               for m in (nz, ny, nx)), indexing="ij")
    bump = torch.sin(math.pi * X) * torch.sin(math.pi * Y) * torch.sin(
        math.pi * Z)
    f = 10.0 * bump * (1.0 + 0.2 * torch.rand(B, 1, 1, 1, generator=gen,
                                              **f64))
    g = 0.3 * X + 0.1 * Y - 0.2 * Z if g_nonzero else torch.zeros_like(X)
    ud = 0.05 * bump * (1.0 + torch.rand(B, 1, 1, 1, generator=gen, **f64))
    return grid, (k, f, g, ud)


def _k4b_steps(grid, arrays, dtype, cg3_2, iters, steps, operand_dtype=None):
    """``steps`` SGD steps on κ, the first cold and the rest warm-started,
    each through ``cg3_2`` (the K4b wrapper or its plain version).  With
    bf16 storage every run takes the planes the f32 run stores, so the f64
    reference solves the same operator, and κ stays put (κs that differ in
    their last bits could round a plane to another bf16 value)."""
    k, f, g, ud = (a.to(dtype).contiguous() for a in arrays)
    out, state = [], None
    for _ in range(steps):
        C, D, b, Minv, x0, _ = k4._prepare3(grid, k, f, g)
        if operand_dtype is not None:
            _, D, _, Minv, _, _ = k4._prepare3(
                grid, k.float(), f.float(), g.float(),
                operand_dtype=operand_dtype)
        x0, lam0 = state if state else (x0, torch.zeros_like(b))
        x, lam = cg3_2(D, b, Minv, x0, lam0, ud, 2.0 / b.numel(), iters)
        gk, _, _ = residual_vjp_manual_3d(grid, k, f, g, x, lam, C=C)
        out.append({"x": x, "lam": lam, "grad": gk})
        state = (x, lam)
        if operand_dtype is None:
            k = k - 20.0 * gk
    return out


_K4B_CASES = ([((12, 9, 6), 7, bf16, c) for bf16 in (False, True)
               for c in (None, 1, 2, 4, 8, 16)]
              + [((32, 32, 32), 3, False, None),
                 ((48, 48, 48), 2, False, None)])


@pytest.mark.parametrize(
    "n,B,bf16,forced", _K4B_CASES,
    ids=[("x".join(map(str, n)) if n[0] == 12 else f"{n[0]}cube")
         + f"_B{B}" + ("_bf16" if bf16 else "")
         + ("" if c is None else f"_C{c}") for n, B, bf16, c in _K4B_CASES])
@pytest.mark.parametrize("g_nonzero", [False, True], ids=["g0", "g"])
def test_k4b_matches_plain_cold_and_warm(cuda, n, B, bf16, forced,
                                         g_nonzero):
    """K4b on the plan's route, and at 12×9×6 on every cluster size, by
    the rule; 32³ takes the cluster route, 48³ the workspace route; a
    second run repeats the first bit for bit."""
    grid, arrays = _k4_problem(cuda, n, B, g_nonzero, seed=sum(n) + B)
    od = torch.bfloat16 if bf16 else None
    nodes, item = math.prod(m + 1 for m in n), 2 if bf16 else 4
    limit = sk.smem_optin(cuda.index or 0)
    plan = (sk.cluster_plan(nodes, 7, item, limit) if forced is None
            else sk.cluster_layout(nodes, 7, item, forced, limit))
    if n[0] >= 32:
        assert plan.route == ("cluster" if n[0] == 32 else "workspace")
    count = "cg3_2" if plan.route == "cluster" else "cg3_2_workspace"
    cg3_2 = _forced(k4._launch_cg3_2, plan)
    before = k4.launches[count]
    kern = _k4b_steps(grid, arrays, torch.float32, cg3_2, 48, 3, od)
    again = _k4b_steps(grid, arrays, torch.float32, cg3_2, 48, 3, od)
    p32 = _k4b_steps(grid, arrays, torch.float32, k4._cg3_2_plain, 48, 3, od)
    p64 = _k4b_steps(grid, arrays, torch.float64, k4._cg3_2_plain, 48, 3, od)
    torch.cuda.synchronize()
    assert k4.launches[count] == before + 6
    for step, (k, a, p, q) in enumerate(zip(kern, again, p32, p64)):
        for key in ("x", "lam", "grad"):
            assert torch.isfinite(k[key]).all()
            assert torch.equal(k[key], a[key]), (step, key)
            ok, errs = _within_rule(k[key], p[key], q[key])
            assert ok, (step, key, errs)


@pytest.mark.parametrize("n,B,iters", [((12, 9, 6), 7, 200),
                                       ((32, 32, 32), 3, 128)],
                         ids=["12x9x6_B7", "32cube_B3"])
def test_k4a_matches_plain(cuda, n, B, iters):
    grid, arrays = _k4_problem(cuda, n, B, True, seed=3 * sum(n) + B)
    out = {}
    for name, dt, cg in (("kernel", torch.float32, k4._cg3),
                         ("f32", torch.float32, k4._cg3_plain),
                         ("f64", torch.float64, k4._cg3_plain)):
        k, f, g, ud = (a.to(dt).contiguous() for a in arrays)
        _, D, b, Minv, x0, _ = k4._prepare3(grid, k, f, g)
        out[name] = (cg(D, b, Minv, x0, iters),
                     cg(D, ud, Minv, torch.zeros_like(ud), iters))
    # no atomics: a second launch repeats the first bit for bit
    k, f, g, _ = (a.float().contiguous() for a in arrays)
    _, D, b, Minv, x0, _ = k4._prepare3(grid, k, f, g)
    again = k4._cg3(D, b, Minv, x0, iters)
    torch.cuda.synchronize()
    assert torch.equal(again, out["kernel"][0])
    for i in range(2):
        assert torch.isfinite(out["kernel"][i]).all()
        ok, errs = _within_rule(out["kernel"][i], out["f32"][i],
                                out["f64"][i])
        assert ok, (i, errs)


@pytest.mark.parametrize("n,B,forced", [((12, 9, 6), 7, c) for c in
                                         (1, 2, 4, 8, 16, "workspace")]
                         + [((32, 32, 32), 3, c) for c in
                            (8, 16, "workspace")],
                         ids=[f"12x9x6_C{c}" for c in (1, 2, 4, 8, 16)]
                         + ["12x9x6_workspace"]
                         + [f"32cube_C{c}" for c in (8, 16)]
                         + ["32cube_workspace"])
def test_k4a_matches_plain_on_every_route(cuda, n, B, forced):
    """K4a forced to each cluster size that fits and to the workspace
    route (the first design): by the rule from x0 = m·g and from 0, and
    each route's launch counted as its own."""
    grid, arrays = _k4_problem(cuda, n, B, True, seed=5 * sum(n) + B)
    nodes = math.prod(m + 1 for m in n)
    plan = (sk.workspace_plan(nodes) if forced == "workspace" else
            sk.cluster_layout(nodes, 7, 4, forced,
                              sk.smem_optin(cuda.index or 0)))
    count = "cg3" if plan.route == "cluster" else "cg3_workspace"
    cg3 = _forced(k4._launch_cg3, plan)
    out = {}
    before = k4.launches[count]
    for name, dt, cg in (("kernel", torch.float32, cg3),
                         ("f32", torch.float32, k4._cg3_plain),
                         ("f64", torch.float64, k4._cg3_plain)):
        k, f, g, ud = (a.to(dt).contiguous() for a in arrays)
        _, D, b, Minv, x0, _ = k4._prepare3(grid, k, f, g)
        out[name] = (cg(D, b, Minv, x0, 200),
                     cg(D, ud, Minv, torch.zeros_like(ud), 200))
    torch.cuda.synchronize()
    assert k4.launches[count] == before + 2
    for i in range(2):
        assert torch.isfinite(out["kernel"][i]).all()
        ok, errs = _within_rule(out["kernel"][i], out["f32"][i],
                                out["f64"][i])
        assert ok, (i, errs)


def test_k4_wrappers_reject_what_the_kernels_do_not_take(cuda):
    grid, arrays = _k4_problem(cuda, (4, 3, 2), 3, False, seed=0)
    k, f, g, ud = (a.float().contiguous() for a in arrays)
    _, D, b, Minv, x0, _ = k4._prepare3(grid, k, f, g)
    with pytest.raises(TypeError, match="float32"):
        k4._cg3(D.double(), b.double(), Minv.double(), x0.double(), 4)
    with pytest.raises(TypeError, match="bfloat16"):
        k4._cg3(D.bfloat16(), b, Minv, x0, 4)
    with pytest.raises(ValueError, match="contiguous"):
        k4._cg3(D, b.transpose(2, 3), Minv, x0, 4)
    with pytest.raises(ValueError, match="block_b"):
        k4._cg3_2(D, b, Minv, x0, x0, ud, 1.0, 4, block_b=0)
    with pytest.raises(ValueError, match="B, Dz, H, W"):
        k4._cg3(D, b[:2], Minv, x0, 4)


def test_3d_routes_launch_k4(cuda):
    mesh = FEMesh.box(8, 8, 8, dtype=torch.float32)
    B = 8
    gen = torch.Generator(device=cuda).manual_seed(2)
    x, y, z = mesh.nodes.T
    f = (10.0 * torch.sin(math.pi * x) * torch.sin(math.pi * y)
         * torch.sin(math.pi * z)).expand(B, mesh.n_nodes)
    k_true = 1.2 + 0.6 * torch.rand(B, mesh.n_elements, generator=gen,
                                    device=cuda)
    before = dict(k4.launches)
    ud = solve_poisson_batched(mesh, k_true, f, cg_tol=0.0, cg_maxiter=200)
    assert k4.launches["cg3"] == before["cg3"] + 1    # the cluster route
    k = torch.ones(B, mesh.n_elements, device=cuda, requires_grad=True)
    (solve_poisson_batched(mesh, k, f, cg_tol=0.0, cg_maxiter=64) ** 2
     ).sum().backward()
    assert k4.launches["cg3"] == before["cg3"] + 3      # forward and adjoint
    assert torch.isfinite(k.grad).all()
    # the default lr (100·B/256) barely moves an 8³ misfit in 40 steps
    kappa, info = fit_kappa(mesh, f, ud, steps=40, lr=5000.0)
    assert info["path"] == "stencil3d_kernel"
    assert info["iters"] == 32 and info["warm"] is False
    assert k4.launches["cg3_2"] == before["cg3_2"] + 40
    assert k4.launches["cg3"] == before["cg3"] + 4      # the eval solve
    assert k4.launches["cg3_workspace"] == before["cg3_workspace"]
    assert k4.launches["cg3_2_workspace"] == before["cg3_2_workspace"]
    assert torch.isfinite(kappa).all()
    assert info["eval_loss"] < float(info["loss_history"][0])


# ---------------------------------------------------------------------------
# K2: batched PCR tridiagonal solve.  f64 within 1e-10 of the plain version
# (the same PCR arithmetic); f32 by the rule of the K3 tests.
# ---------------------------------------------------------------------------


def _k2_bands(dev, n, B, seed):
    """Strictly diagonally dominant SPD bands (f64), a right-hand side and
    a loss weight."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    f64 = dict(dtype=torch.float64, device=dev)
    e = -torch.rand(B, n - 1, generator=gen, **f64) - 0.1
    d = torch.rand(B, n, generator=gen, **f64) + 0.1
    d[:, :-1] -= e
    d[:, 1:] -= e
    return (d, e, torch.randn(B, n, generator=gen, **f64),
            torch.randn(B, n, generator=gen, **f64))


def _k2_solve(solve, d, e, F, w, **kw):
    ts = [t.clone().requires_grad_() for t in (d, e, F)]
    u = solve(*ts, **kw)
    u.backward(w)
    return [u.detach()] + [t.grad for t in ts]


@pytest.mark.parametrize("n", [1, 2, 31, 129, 257, 4097])
@pytest.mark.parametrize("shared", [False, True], ids=["batched", "shared"])
def test_k2_matches_plain(cuda, n, shared):
    """Each route that takes n (k2_plan: the warp route up to 256 rows, the
    block route) against the plain version, bit for bit on u."""
    d, e, F, w = _k2_bands(cuda, n, 7, seed=n)
    if shared:
        d, e = d[0], e[0]
    routes = ("warp", "block") if n <= k2.WARP_MAX_ROWS else ("block",)
    before = dict(k2.launches)
    q = _k2_solve(ttri.tridiag_solve, d, e, F, w)
    for dt in (torch.float64, torch.float32):
        args = [t.to(dt) for t in (d, e, F, w)]
        p = _k2_solve(ttri.tridiag_solve, *args)
        for route in routes:
            k = _k2_solve(k2.tridiag_solve_kernel, *args, plan=route)
            assert torch.equal(k[0], p[0]), route
            for a, b, c in zip(k, p, q):
                assert a.shape == c.shape and torch.isfinite(a).all()
                if dt == torch.float64:
                    assert rel_err(a, c) <= 1e-10
                else:
                    ok, errs = _within_rule(a, b, c)
                    assert ok, errs
            for layout, bb in (("transposed", 64), ("batch", 1),
                               ("batch", 64), ("other", 3)):
                u = k2.tridiag_solve_kernel(*args[:3], block_b=bb,
                                            layout=layout, plan=route)
                assert torch.equal(u, k[0]), (route, layout, bb)
    torch.cuda.synchronize()
    for route, key in (("warp", "pcr"), ("block", "pcr_block")):
        runs = 2 * (2 + 4) if route in routes else 0
        assert k2.launches[key] == before[key] + runs, route


def test_k2_unbatched_and_leading_axes(cuda):
    d, e, F, _ = _k2_bands(cuda, 40, 6, seed=1)
    u1 = k2.tridiag_solve_kernel(d[0], e[0], F[0])
    assert u1.shape == (40,)
    assert rel_err(u1, ttri.tridiag_solve(d[0], e[0], F[0])) <= 1e-12
    u = k2.tridiag_solve_kernel(d.reshape(2, 3, 40), e.reshape(2, 3, 39),
                                F.reshape(2, 3, 40))
    assert u.shape == (2, 3, 40)
    assert rel_err(u.reshape(6, 40), ttri.tridiag_solve(d, e, F)) <= 1e-12
    Ft = F.t().contiguous().t()                  # non-contiguous rows
    assert rel_err(k2.tridiag_solve_kernel(d, e, Ft),
                   ttri.tridiag_solve(d, e, F)) <= 1e-12


def test_k2_route_and_its_gradient(cuda):
    mesh = FEMesh.line(128, bc_left=0.2, bc_right=-0.4,
                       dtype=torch.float64, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(2)
    k = (1.2 + 0.6 * torch.rand(16, 128, generator=gen, device=cuda,
                                dtype=torch.float64)).requires_grad_()
    f = torch.randn(16, 129, generator=gen, device=cuda, dtype=torch.float64)
    before = dict(k2.launches)
    u = solve_poisson_batched(mesh, k, f, method="tridiag_pallas")
    (g,) = torch.autograd.grad(u.square().sum(), k)
    # 16 systems: below WARP_MIN_BATCH, the plan's route is the block route
    assert k2.launches["pcr_block"] == before["pcr_block"] + 2
    assert k2.launches["pcr"] == before["pcr"]
    u_x = solve_poisson_batched(mesh, k, f, method="tridiag")
    (g_x,) = torch.autograd.grad(u_x.square().sum(), k)
    assert rel_err(u, u_x) <= 1e-10 and rel_err(g, g_x) <= 1e-10


def test_k2_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    d = torch.ones(2, 5, device=cuda)
    with pytest.raises(TypeError, match="float32 or float64"):
        k2.tridiag_solve_kernel(d.half(), d[:, 1:].half(), d.half())
    with pytest.raises(ValueError, match="dtype"):
        k2.tridiag_solve_kernel(d.double(), -0.1 * d[:, 1:], d)
    n = 9000
    big = torch.ones(1, n, device=cuda, dtype=torch.float64)
    with pytest.raises(ValueError, match="shared"):
        k2.tridiag_solve_kernel(4 * big, -big[:, 1:], big)
    # the warp route holds at most WARP_MAX_ROWS rows a system
    m = k2.WARP_MAX_ROWS + 1
    over = torch.ones(3, m, device=cuda)
    with pytest.raises(ValueError, match="warp route holds at most"):
        k2.tridiag_solve_kernel(4 * over, -over[:, 1:], over, plan="warp")


def test_second_order_refusals_on_the_card(cuda):
    """K3a's and K4a's routes refuse a graph of their backward, as K2's."""
    f32 = dict(dtype=torch.float32, device=cuda)    # the kernels' dtype
    grid = StructuredGrid.unit(6, 6)
    kl = (1.0 + torch.rand(2, 6, 6, **f32)).requires_grad_()
    u = sk.solve_structured_kernel(grid, (kl, kl), torch.ones(2, 7, 7, **f32),
                                   torch.zeros(7, 7, **f32), iters=8)
    misfit = u.sum() + kl.square().sum()
    with pytest.raises(NotImplementedError, match="differentiable once"):
        torch.autograd.grad(misfit, kl, create_graph=True)
    grid3 = StructuredGrid3.unit(3, 3, 3)
    k = (1.0 + torch.rand(2, grid3.n_elements, **f32)).requires_grad_()
    u = k4.solve_structured_kernel_3d(grid3, k, torch.ones(2, 4, 4, 4, **f32),
                                      torch.zeros(4, 4, 4, **f32), iters=4)
    misfit = u.sum() + k.square().sum()
    with pytest.raises(NotImplementedError, match="differentiable once"):
        torch.autograd.grad(misfit, k, create_graph=True)
    (g,) = torch.autograd.grad(misfit, k)
    assert torch.isfinite(g).all()


# ---------------------------------------------------------------------------
# K5a, K5b, K6, K7: the fused 1D grad steps, against their plain versions:
# f32 by the rule of the K3 tests, f64 within 1e-10 relative.
# ---------------------------------------------------------------------------

FUSED = ("k5a", "k5b", "k6", "k7")


def _fused_inputs(dev, ne, B, seed, bc, bf16, shared_f):
    """f32 meshes and operands as the kernels store them, and the f64
    mesh: log κ, per-element κ, load F (shared (n,) or (B, n)) and
    observations of a random κ field, f32 or bf16 storage."""
    f64 = dict(dtype=torch.float64, device=dev)
    mesh64 = FEMesh.line(ne, bc_left=bc[0], bc_right=bc[1],
                         dtype=torch.float64, device=dev)
    mesh32 = FEMesh.line(ne, bc_left=bc[0], bc_right=bc[1],
                         dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = mesh64.nodes[:, 0]
    f = (torch.sin(math.pi * x) + 1.0) * (
        1.0 + 0.2 * torch.rand(B, 1, generator=gen, **f64))
    ud = solve_poisson_batched(
        mesh64, 1.0 + torch.rand(B, ne, generator=gen, **f64), f,
        method="tridiag").float()
    F = assemble_load(mesh64, f).float()
    F = F[0] if shared_f else F
    lk = (0.3 * torch.randn(B, generator=gen, **f64)).float()
    ke = (1.0 + torch.rand(B, ne, generator=gen, **f64)).float()
    if bf16:
        ud = ud.bfloat16()
        F = F if shared_f else F.bfloat16()
    return mesh32, mesh64, lk, ke, F, ud


def _fused_run(name, mesh, plain_meshes, lk, ke, F, ud, version=2,
               refine=3, plan=None):
    """The kernel's outputs on ``mesh`` and the plain version's on each of
    ``plain_meshes`` (operands widened to each mesh's dtype), and the
    rule's slack.  K7's plain version rounds its products as the kernel's
    route does (``plan``, or the one ``k7_plan`` picks for ``mesh``)."""
    B, n = ud.shape
    scale = 2.0 / (B * n)
    op = torch.bfloat16 if ud.dtype == torch.bfloat16 else None
    products = "exact"
    if name == "k7" and (plan or k7.k7_plan(mesh.dtype, n, version)) == "tc":
        products = k7.TC_PRODUCTS[version]

    def to(t, m):
        return t if t.dtype == torch.bfloat16 else t.to(m.dtype)

    if name in ("k5a", "k7"):
        kap = lk
        if name == "k5a":
            kern = k5.fused_kappa_mse_step(mesh, lk, F, ud)
        else:
            kern = k7.fused_kappa_mse_step_mxu(mesh, lk, F, ud,
                                               operand_dtype=op,
                                               version=version, refine=refine,
                                               plan=plan)

        def plain(m, a, F_, u_):
            cols = k5.scalar_columns(m)
            if name == "k5a":
                return k5._k5a_plain(a, F_, u_, cols, scale)
            return k7._k7_plain(a, F_, u_, cols, k7.mxu_inverse(m), scale,
                                version, refine, products)
    else:
        kap = ke
        fn, pl = ((k5.fused_kappa_mse_step_general_pcr, k5._k5b_plain)
                  if name == "k5b" else
                  (k6.fused_kappa_mse_step_general, k6._k6_plain))
        kern = fn(mesh, ke, F, ud, operand_dtype=op)

        def plain(m, a, F_, u_):
            return pl(a, F_, u_, *k5.general_constants(m), scale)

    return kern, [plain(m, kap.to(m.dtype), to(F, m), to(ud, m))
                  for m in plain_meshes], k7.rule_slack(products, n)


def _launch_count(name):
    """Launches of ``name``'s kernel (K7's on both routes)."""
    if name == "k7":
        return k7.launches["k7"] + k7.launches["k7_fma"]
    return {"k5a": k5, "k5b": k5, "k6": k6}[name].launches[name]


@pytest.mark.parametrize("ne", [1, 12, 30, 128])
@pytest.mark.parametrize("name", FUSED)
def test_fused_step_matches_plain(cuda, name, ne):
    """Each storage (f32 and, but for K5a, bf16) and F (streamed and
    shared) in f32 by the rule, then the f64 kernel within 1e-10."""
    ne = min(ne, k7.MXU_MAX_NODES - 1) if name == "k7" else ne
    bc = (0.3, -0.2) if ne in (12, 128) else (0.0, 0.0)
    before = _launch_count(name)
    runs = 0
    for bf16 in ((False,) if name == "k5a" else (False, True)):
        for shared_f in (False, True):
            mesh32, mesh64, lk, ke, F, ud = _fused_inputs(
                cuda, ne, 1000, ne + 7 * runs, bc, bf16, shared_f)
            kern, (p32, p64), slack = _fused_run(
                name, mesh32, (mesh32, mesh64), lk, ke, F, ud)
            runs += 1
            for a, b, c in zip(kern, p32, p64):
                assert a.shape == c.shape and a.dtype == torch.float32
                ok, errs = _within_rule(a, b, c, slack)
                assert ok, (bf16, shared_f, errs)
            kern64, (q64,), _ = _fused_run(name, mesh64, (mesh64,),
                                           lk.double(), ke.double(),
                                           F.double(), ud.double())
            runs += 1
            for a, c in zip(kern64, q64):
                assert rel_err(a, c) <= 1e-10
    torch.cuda.synchronize()
    assert _launch_count(name) == before + runs


@pytest.mark.parametrize("plan", ["tc", "fma"])
@pytest.mark.parametrize("version,refine", [(1, 3), (2, 3), (3, 0), (3, 2),
                                            (3, 3)])
def test_k7_versions_match_plain(cuda, version, refine, plan):
    """Each body on each route, against the plain version with that
    route's products, by the rule."""
    mesh32, mesh64, lk, ke, F, ud = _fused_inputs(cuda, 30, 1000, 3,
                                                  (0.3, -0.2), True, True)
    before = dict(k7.launches)
    kern, (p32, p64), slack = _fused_run("k7", mesh32, (mesh32, mesh64), lk,
                                         ke, F, ud, version, refine, plan)
    torch.cuda.synchronize()
    key = "k7" if plan == "tc" else "k7_fma"
    assert k7.launches[key] == before[key] + 1
    for a, b, c in zip(kern, p32, p64):
        ok, errs = _within_rule(a, b, c, slack)
        assert ok, errs


_K7_TC_GRID = [(n, B) for n in (2, 13, 31, 32) for B in (7, 1000, 2 ** 20)]


@pytest.mark.parametrize("n,B", _K7_TC_GRID,
                         ids=[f"n{n}_B{B}" for n, B in _K7_TC_GRID])
def test_k7_tc_grid_matches_plain(cuda, n, B):
    """K7's "tc" route over its grid: shared and streamed F, f32 and bf16
    storage, versions 1-3 with refine 0, 2 and 3 (at B = 2^20 the
    production body and the bench row's), each by the rule against the
    plain version with the route's products and two launches equal bit
    for bit."""
    bodies = [(1, 0), (2, 0), (3, 0), (3, 2), (3, 3)]
    combos = [(s, b) for s in (False, True) for b in (False, True)]
    if B == 2 ** 20:
        bodies, combos = [(2, 0), (3, 2)], [(False, False), (True, True)]
    before = k7.launches["k7"]
    runs = 0
    for shared_f, bf16 in combos:
        mesh32, mesh64, lk, ke, F, ud = _fused_inputs(
            cuda, n - 1, B, n + B + 2 * shared_f + bf16, (0.3, -0.2), bf16,
            shared_f)
        for version, refine in bodies:
            kern, (p32, p64), slack = _fused_run(
                "k7", mesh32, (mesh32, mesh64), lk, ke, F, ud, version,
                refine, "tc")
            again, _, _ = _fused_run("k7", mesh32, (), lk, ke, F, ud,
                                     version, refine, "tc")
            runs += 2
            for a, b, c, d in zip(kern, p32, p64, again):
                assert a.shape == (B,) and torch.equal(a, d)
                ok, errs = _within_rule(a, b, c, slack)
                assert ok, (shared_f, bf16, version, refine, errs)
    torch.cuda.synchronize()
    assert k7.launches["k7"] == before + runs


def test_fused_steps_without_a_shared_memory_fit(cuda):
    """n = 2001 in f64: K5b keeps its sweep factors and K6 its rows in a
    global workspace."""
    mesh = FEMesh.line(2000, bc_left=0.3, bc_right=-0.2, dtype=torch.float64,
                       device=cuda)
    _, _, lk, ke, F, ud = _fused_inputs(cuda, 2000, 5, 1, (0.3, -0.2), False,
                                        False)
    for name in ("k5b", "k6"):
        kern, (q,), _ = _fused_run(name, mesh, (mesh,), lk.double(),
                                   ke.double(), F.double(), ud.double())
        for a, c in zip(kern, q):
            assert rel_err(a, c) <= 1e-10, name


def test_k7_routes_large_meshes_to_k5a(cuda):
    mesh = FEMesh.line(150, dtype=torch.float32, device=cuda)
    _, _, lk, _, F, ud = _fused_inputs(cuda, 150, 64, 2, (0.0, 0.0), False,
                                       False)
    before = (k5.launches["k5a"], _launch_count("k7"))
    lp, gk = k7.fused_kappa_mse_step_mxu(mesh, lk, F, ud, version=3)
    assert (k5.launches["k5a"], _launch_count("k7")) == (before[0] + 1,
                                                         before[1])
    assert torch.isfinite(gk).all() and lp.shape == (64,)


def test_fused_wrappers_reject_what_the_kernels_do_not_take(cuda):
    mesh = FEMesh.line(10, dtype=torch.float32, device=cuda)
    ke = torch.ones(4, 10, device=cuda)
    with pytest.raises(TypeError, match="float16"):
        k6.fused_kappa_mse_step_general(mesh, ke, torch.ones(11, device=cuda),
                                        torch.ones(4, 11, device=cuda),
                                        operand_dtype=torch.float16)
    half = FEMesh.line(10, dtype=torch.float16, device=cuda)
    with pytest.raises(TypeError, match="float32 or float64"):
        k7.fused_kappa_mse_step_mxu(half, torch.zeros(4, device=cuda),
                                    torch.ones(11, device=cuda),
                                    torch.ones(4, 11, device=cuda))


_K5_ROUTE_GRID = [(n, B) for n in (2, 13, 31, 32, k5.K5_WARP_MAX_ROWS)
                  for B in (7, 1000, 4096)]


def _k5_step(name, mesh, kap, F, ud, plan):
    op = torch.bfloat16 if ud.dtype == torch.bfloat16 else None
    if name == "k5a":
        return k5.fused_kappa_mse_step(mesh, kap, F, ud, plan=plan)
    return k5.fused_kappa_mse_step_general_pcr(mesh, kap, F, ud,
                                               operand_dtype=op, plan=plan)


def _k5_plain(name, mesh, kap, F, ud):
    B, n = ud.shape
    args = [t if t.dtype == torch.bfloat16 else t.to(mesh.dtype)
            for t in (kap, F, ud)]
    if name == "k5a":
        return k5._k5a_plain(*args, k5.scalar_columns(mesh), 2.0 / (B * n))
    return k5._k5b_plain(*args, *k5.general_constants(mesh), 2.0 / (B * n))


@pytest.mark.parametrize("n,B", _K5_ROUTE_GRID,
                         ids=[f"n{n}_B{B}" for n, B in _K5_ROUTE_GRID])
def test_k5_warp_route_matches_block_route(cuda, n, B):
    """K5's warp route against the plain version (f32 by the rule, f64
    within 1e-10), and against its block route: K5b's gradient (no sum)
    bit for bit, the sums (the loss, K5a's gradient) by the rule, which
    the block route meets too.  K5a and K5b, streamed and shared F, f32,
    bf16 storage (K5b) and f64."""
    before = dict(k5.route_launches)
    runs = 0
    for name in ("k5a", "k5b"):
        for bf16 in ((False,) if name == "k5a" else (False, True)):
            for shared_f in (False, True):
                mesh32, mesh64, lk, ke, F, ud = _fused_inputs(
                    cuda, n - 1, B, n + B + 2 * shared_f + bf16, (0.3, -0.2),
                    bf16, shared_f)
                kap = lk if name == "k5a" else ke
                tag = (name, bf16, shared_f)
                warp = _k5_step(name, mesh32, kap, F, ud, "warp")
                block = _k5_step(name, mesh32, kap, F, ud, "block")
                p32 = _k5_plain(name, mesh32, kap, F, ud)
                p64 = _k5_plain(name, mesh64, kap, F, ud)
                for a, b, c, d in zip(warp, block, p32, p64):
                    for route in (a, b):
                        ok, errs = _within_rule(route, c, d)
                        assert ok, (tag, errs)
                wide = [t.double() for t in (kap, F, ud)]
                warp64 = _k5_step(name, mesh64, *wide, "warp")
                block64 = _k5_step(name, mesh64, *wide, "block")
                for a, b, c in zip(warp64, block64,
                                   _k5_plain(name, mesh64, *wide)):
                    assert rel_err(a, c) <= 1e-10, tag
                    assert rel_err(b, c) <= 1e-10, tag
                if name == "k5b":
                    assert torch.equal(warp[1], block[1]), tag
                    assert torch.equal(warp64[1], block64[1]), tag
                runs += 2
    torch.cuda.synchronize()
    assert k5.route_launches == {"warp": before["warp"] + runs,
                                 "block": before["block"] + runs}


def test_k5_plan_on_the_card(cuda):
    """The plan's route runs unforced, and a forced warp route past
    K5_WARP_MAX_ROWS raises."""
    for n, B, route in ((31, 7, "warp"), (128, 4096, "warp"),
                        (129, 4096, "block")):
        mesh32, _, lk, _, F, ud = _fused_inputs(cuda, n - 1, B, 4, (0.0, 0.0),
                                                False, False)
        before = dict(k5.route_launches)
        k5.fused_kappa_mse_step(mesh32, lk, F, ud)
        torch.cuda.synchronize()
        assert k5.route_launches[route] == before[route] + 1
    with pytest.raises(ValueError, match="warp route holds at most"):
        k5.fused_kappa_mse_step(mesh32, lk, F, ud, plan="warp")


_K6_ROUTE_GRID = [(n, B) for n in (2, 13, 31, 32) for B in (7, 1000, 4099)]


def _k6_step(mesh, ke, F, ud, plan):
    op = torch.bfloat16 if ud.dtype == torch.bfloat16 else None
    return k6.fused_kappa_mse_step_general(mesh, ke, F, ud, operand_dtype=op,
                                           plan=plan)


def _k6_plain(mesh, ke, F, ud):
    B, n = ud.shape
    args = [t if t.dtype == torch.bfloat16 else t.to(mesh.dtype)
            for t in (ke, F, ud)]
    return k6._k6_plain(*args, *k5.general_constants(mesh), 2.0 / (B * n))


@pytest.mark.parametrize("n,B", _K6_ROUTE_GRID,
                         ids=[f"n{n}_B{B}" for n, B in _K6_ROUTE_GRID])
def test_k6_reg_route_matches_block_route(cuda, n, B):
    """K6's reg route equals its block route bit for bit (loss and
    gradient) and meets the plain version by the rule: shared and
    streamed F, f32 and bf16 storage, zero, nonzero and one-sided
    Dirichlet values, and a strided κ view."""
    before = dict(k6.route_launches)
    runs = 0
    for bc in ((0.0, 0.0), (0.3, -0.2), (0.3, None)):
        for bf16 in (False, True):
            for shared_f in (False, True):
                mesh32, mesh64, _, ke, F, ud = _fused_inputs(
                    cuda, n - 1, B, n + B + 2 * shared_f + bf16, bc, bf16,
                    shared_f)
                tag = (bc, bf16, shared_f)
                reg = _k6_step(mesh32, ke, F, ud, "reg")
                block = _k6_step(mesh32, ke, F, ud, "block")
                runs += 1
                p32 = _k6_plain(mesh32, ke, F, ud)
                p64 = _k6_plain(mesh64, ke, F, ud)
                for a, b, c, d in zip(reg, block, p32, p64):
                    assert a.shape == b.shape and torch.equal(a, b), tag
                    ok, errs = _within_rule(a, c, d)
                    assert ok, (tag, errs)
    # κ as a strided view: every other column of a wider tensor
    mesh32, _, _, ke, F, ud = _fused_inputs(cuda, n - 1, B, 5, (0.3, -0.2),
                                            False, False)
    wide = torch.zeros(B, 2 * (n - 1), device=cuda)
    wide[:, ::2] = ke
    view = wide[:, ::2]
    assert not view.is_contiguous()
    for a, b in zip(_k6_step(mesh32, view, F, ud, "reg"),
                    _k6_step(mesh32, ke, F, ud, "block")):
        assert torch.equal(a, b)
    runs += 1
    torch.cuda.synchronize()
    assert k6.route_launches == {"reg": before["reg"] + runs,
                                 "block": before["block"] + runs}


def test_k6_plan_on_the_card(cuda):
    """The plan's route runs unforced, and a forced reg route that cannot
    take the shape raises."""
    for n, dtype, route in ((31, torch.float32, "reg"),
                            (32, torch.float32, "reg"),
                            (33, torch.float32, "block"),
                            (13, torch.float64, "block")):
        mesh32, mesh64, _, ke, F, ud = _fused_inputs(cuda, n - 1, 7, 4,
                                                     (0.0, 0.0), False, False)
        mesh = mesh32 if dtype == torch.float32 else mesh64
        before = dict(k6.route_launches)
        k6.fused_kappa_mse_step_general(mesh, ke.to(dtype), F.to(dtype),
                                        ud.to(dtype))
        torch.cuda.synchronize()
        assert k6.route_launches[route] == before[route] + 1, (n, dtype)
        if route == "block":
            with pytest.raises(ValueError, match="reg route takes"):
                k6.fused_kappa_mse_step_general(mesh, ke.to(dtype),
                                                F.to(dtype), ud.to(dtype),
                                                plan="reg")
    with pytest.raises(ValueError, match="'reg' or 'block'"):
        k6.fused_kappa_mse_step_general(mesh32, ke, F, ud, plan="warp")


def test_production_loop_runs_on_k7(cuda):
    """The production loop, 40 steps at B = 2048: one K7 launch a step, all
    on the "tc" route, and the final κ within 1e-3 of the same loop on the
    plain version."""
    mesh = production.production_mesh()
    assert mesh.device.type == "cuda"
    k_true = 1.0 + 2.0 * torch.rand(
        2048, generator=torch.Generator(device=cuda).manual_seed(0),
        device=cuda)
    F, ud = production.production_data(mesh, k_true)
    before = dict(k7.launches)
    lk, losses = production.sgd_loop(mesh, F, ud, steps=40)
    torch.cuda.synchronize()
    assert k7.launches == {"k7": before["k7"] + 40,
                           "k7_fma": before["k7_fma"]}
    cols, W = k5.scalar_columns(mesh), k7.mxu_inverse(mesh)

    def plain(m, lk_, F_, ud_, scale, block_lanes, version):
        return k7._k7_plain(lk_, F_, ud_, cols, W, scale, version, 3)

    lk_p, losses_p = production.sgd_loop(mesh, F, ud, steps=40, step=plain)
    assert float(losses[-1]) < 1e-2 * float(losses[0])
    assert rel_err(torch.exp(lk), torch.exp(lk_p)) <= 1e-3


# ---------------------------------------------------------------------------
# K8: the masked edge-ELL operator of the general-mesh CG (P1's gather-sum
# at unit weights).  f32 by the rule of the whole-CG kernels, f64 within
# 1e-12 of the plain version run on the card.
# ---------------------------------------------------------------------------


def _general_mesh(dev, cells, dtype=torch.float64, seed=0):
    """A factory rectangle or box with its interior nodes moved by
    U(±0.3h), as a mesh without a grid."""
    base = (FEMesh.rectangle(*cells, dtype=torch.float64, device="cpu")
            if len(cells) == 2 else
            FEMesh.box(*cells, dtype=torch.float64, device="cpu"))
    nodes = perturbed_nodes(base.nodes.numpy(), base.bc_mask.numpy(), cells,
                            seed=seed)
    return FEMesh.from_arrays(nodes, base.elements.numpy(),
                              base.bc_mask.numpy(), base.bc_values.numpy(),
                              device=dev, dtype=dtype)


def _k8_operands(dev, case, B):
    g = torch.Generator(device=dev).manual_seed(B)
    if case == "p1":
        n, D = 256, 8
        nbr = torch.randint(0, n, (n, D), generator=g, device=dev,
                            dtype=torch.int32)
        W = torch.ones(n, D, B, dtype=torch.float64, device=dev)
        diag = torch.zeros(n, B, dtype=torch.float64, device=dev)
        m = torch.zeros(n, dtype=torch.float64, device=dev)
    else:
        mesh = _general_mesh(dev, (16, 16) if case != "tet" else (6, 6, 6))
        ell = tun.build_ell(mesh)
        ke = 1.0 + torch.rand(mesh.n_elements, B, generator=g, device=dev,
                              dtype=torch.float64)
        W, diag = tun.ell_weights_bm(mesh, ell, ke)
        nbr, m = ell.nbr, mesh.bc_mask
        if case == "mask":
            m = (torch.rand(mesh.n_nodes, generator=g, device=dev) < 0.3
                 ).double()
    v = torch.randn(nbr.shape[0], B, generator=g, device=dev,
                    dtype=torch.float64)
    return nbr, W, diag, v, m


@pytest.mark.parametrize("case,B", [("p1", 8), ("tri", 64), ("tet", 32),
                                    ("mask", 7)])
def test_k8_matches_plain(cuda, case, B):
    nbr, W, diag, v, m = _k8_operands(cuda, case, B)
    before = k8.launches["ell_apply"]
    y64 = k8.ell_apply(nbr, W, diag, v, m)
    p64 = k8.ell_apply_plain(nbr, W, diag, v, m)
    args32 = [t.float() for t in (W, diag, v, m)]
    y32 = k8.ell_apply(nbr, *args32)
    p32 = k8.ell_apply_plain(nbr, *args32)
    torch.cuda.synchronize()
    assert k8.launches["ell_apply"] == before + 2
    assert rel_err(y64, p64) <= 1e-12
    ok, errs = _within_rule(y32, p32, p64)
    assert ok, errs
    if case == "p1":
        assert rel_err(y64, v[nbr.long()].sum(dim=1)) <= 1e-12


@pytest.mark.parametrize("case", ["tri", "tet", "mask"])
@pytest.mark.parametrize("B", [7, 130, 256])
def test_k8_vec4_body_matches_scalar(cuda, case, B):
    """K8's bodies: the four-scenario body where B % 4 == 0 and the planes
    are aligned, equal to the scalar body (the first design) bit for bit;
    the scalar body for B = 7 and 130 and for a plane off the 16-byte
    boundary; each against the plain version (f32 by the rule, f64 within
    1e-12)."""
    nbr, W, diag, v, m = _k8_operands(cuda, case, B)
    before = dict(k8.body_launches)
    bodies = ("vec4", "scalar") if B % 4 == 0 else ("scalar",)
    p64 = k8.ell_apply_plain(nbr, W, diag, v, m)
    for dt in (torch.float64, torch.float32):
        args = [t.to(dt) for t in (W, diag, v, m)]
        y = {body: k8.ell_apply(nbr, *args, body=body) for body in bodies}
        assert torch.equal(k8.ell_apply(nbr, *args), y[bodies[0]])
        for body in bodies:
            assert torch.equal(y[body], y["scalar"]), body
        if dt == torch.float64:
            assert rel_err(y["scalar"], p64) <= 1e-12
        else:
            ok, errs = _within_rule(y["scalar"],
                                    k8.ell_apply_plain(nbr, *args), p64)
            assert ok, errs
        if B % 4:
            with pytest.raises(ValueError, match="vec4 body takes"):
                k8.ell_apply(nbr, *args, body="vec4")
        else:     # v one value into its storage: off the 16-byte boundary
            off = torch.empty(v.numel() + 1, dtype=dt, device=cuda)[1:]
            off = off.view_as(v).copy_(args[2])
            assert torch.equal(k8.ell_apply(nbr, args[0], args[1], off,
                                            args[3]), y["scalar"])
            with pytest.raises(ValueError, match="vec4 body takes"):
                k8.ell_apply(nbr, args[0], args[1], off, args[3],
                             body="vec4")
    torch.cuda.synchronize()
    # a dtype: the forced bodies, the plan's and (B % 4 == 0) the
    # unaligned plane's
    assert k8.body_launches == {
        "vec4": before["vec4"] + (4 if B % 4 == 0 else 0),
        "scalar": before["scalar"] + 4}


def test_k8_rejects_what_it_does_not_take(cuda):
    nbr, W, diag, v, m = _k8_operands(cuda, "p1", 8)
    with pytest.raises(ValueError, match="int32"):
        k8.ell_apply(nbr.long(), W, diag, v, m)
    with pytest.raises(ValueError, match="contiguous"):
        k8.ell_apply(nbr, W, diag, v.t().contiguous().t(), m)
    with pytest.raises(ValueError, match="dtype"):
        k8.ell_apply(nbr, W.float(), diag, v, m)
    with pytest.raises(TypeError, match="float32 or float64"):
        k8.ell_apply(nbr, W.half(), diag.half(), v.half(), m.half())


# ---------------------------------------------------------------------------
# K8s: the whole edge-ELL solve, one thread-block cluster a scenario,
# against its plain version by the rule above at every cluster size.
# ---------------------------------------------------------------------------

_ELL_MESHES = {"tri8": (8, 8), "tri64": (64, 64), "tet16": (16, 16, 16),
               "tri256": (256, 256)}


def _ell_problem(dev, case, B):
    """f64 K8s operands on a perturbed mesh: its tables, W and diag of
    per-element κ = 1 + U(0, 1), the mask and a masked right-hand side
    whose middle scenario (B > 1) is 0."""
    cells = _ELL_MESHES[case]
    mesh = _general_mesh(dev, cells, seed=len(cells))
    ell = tun.build_ell(mesh)
    g = torch.Generator(device=dev).manual_seed(B)
    f64 = dict(dtype=torch.float64, device=dev)
    ke = 1.0 + torch.rand(mesh.n_elements, B, generator=g, **f64)
    W, diag = tun.ell_weights_bm(mesh, ell, ke)
    m = mesh.bc_mask
    b = (1.0 - m[:, None]) * torch.rand(mesh.n_nodes, B, generator=g, **f64)
    if B > 1:
        b[:, B // 2] = 0.0
    return ell.nbr, W, diag, m, b.contiguous()


def _ell_plans(nodes, Dn):
    """Every K8s plan that fits: each cluster size."""
    limit = sk.smem_optin(torch.cuda.current_device())
    plans = []
    for c in sk.CLUSTER_SIZES:
        try:
            plans.append(k8.ell_cluster_layout(nodes, Dn, c, limit))
        except ValueError:
            pass
    return plans


_ELL_CASES = [(c, B) for c in _ELL_MESHES for B in (1, 7, 256)]


@pytest.mark.parametrize("case,B", _ELL_CASES,
                         ids=[f"{c}_B{B}" for c, B in _ELL_CASES])
def test_k8s_matches_plain_at_every_cluster_size(cuda, case, B):
    """128 iterations: every plan by the rule, a second launch equal bit
    for bit, the zero scenario 0 without NaN; the default plan is the
    fewest blocks that fit."""
    nbr, W, diag, m, b = _ell_problem(cuda, case, B)
    n, Dn = nbr.shape
    iters = 128
    p64 = k8.ell_cg_plain(nbr, W, diag, m, b, 0.0, iters)
    a32 = [t.float().contiguous() for t in (W, diag, m, b)]
    p32 = k8.ell_cg_plain(nbr, *a32, 0.0, iters)
    plans = _ell_plans(n, Dn)
    default = k8.ell_cluster_plan(n, Dn, 4, sk.smem_optin(cuda.index or 0))
    assert default == plans[0]
    by_plan = {}
    for plan in plans:
        before = k8.launches["ell_cg"]
        x = k8.ell_cg(nbr, *a32, 0.0, iters, plan=plan)
        again = k8.ell_cg(nbr, *a32, 0.0, iters, plan=plan)
        torch.cuda.synchronize()
        assert k8.launches["ell_cg"] == before + 2
        assert torch.equal(x, again), plan
        ok, errs = _within_rule(x, p32, p64)
        assert ok, (plan, errs)
        if B > 1:
            assert not x[:, B // 2].any()
        by_plan[plan] = x
    assert torch.equal(k8.ell_cg(nbr, *a32, 0.0, iters), by_plan[default])


def test_k8s_routes_and_refusals(cuda):
    """float64 and tol-gated solves take the per-iteration route (K8 once
    an application); a forced cluster plan refuses them."""
    nbr, W, diag, m, b = _ell_problem(cuda, "tri8", 7)
    a32 = [t.float().contiguous() for t in (W, diag, m, b)]
    before = dict(k8.launches)
    x64 = k8.ell_cg(nbr, W, diag, m, b, 0.0, 16)
    assert k8.launches["ell_apply"] == before["ell_apply"] + 17
    assert k8.launches["ell_cg"] == before["ell_cg"]
    assert rel_err(x64, k8.ell_cg_plain(nbr, W, diag, m, b, 0.0, 16)) \
        <= 1e-12
    k8.ell_cg(nbr, *a32, 1e-3, 16)
    assert k8.launches["ell_cg"] == before["ell_cg"]
    plan = k8.ell_cluster_plan(nbr.shape[0], nbr.shape[1], 4,
                               sk.smem_optin(cuda.index or 0))
    with pytest.raises(TypeError, match="float32"):
        k8.ell_cg(nbr, W, diag, m, b, 0.0, 16, plan=plan)
    with pytest.raises(ValueError, match="fixed-trip"):
        k8.ell_cg(nbr, *a32, 1e-3, 16, plan=plan)
    with pytest.raises(ValueError, match="cluster plan"):
        k8.ell_cg(nbr, *a32, 0.0, 16,
                  plan=k8.ell_cluster_layout(nbr.shape[0] + 1, nbr.shape[1],
                                             1, sk.smem_optin(0)))
    with pytest.raises(ValueError, match="contiguous"):
        k8.ell_cg(nbr, a32[0], a32[1], a32[2],
                  a32[3].t().contiguous().t(), 0.0, 16, plan=plan)


def test_ell_gradient_on_k8s_against_the_per_iteration_route(cuda,
                                                              monkeypatch):
    """The f32 batched ELL solve and its κ gradient on K8s (the default)
    and on the per-iteration route, each by the rule against the f64 plain
    run; the per-iteration f32 run stands for the plain f32 run."""
    iters, B = 64, 32
    ref64, _ = _ell_solve_grad("cpu", torch.float64, iters, B)
    k8s, launched = _ell_solve_grad(cuda, torch.float32, iters, B)
    assert launched == {"ell_apply": 1, "ell_cg": 2}
    monkeypatch.setattr(tun, "_ell_cg", lambda *a: k8.ell_cg(
        *a, plan=k8.per_iteration_plan(a[0].shape[0])))
    per_it, launched = _ell_solve_grad(cuda, torch.float32, iters, B)
    assert launched == {"ell_apply": 2 * iters + 3, "ell_cg": 0}
    for a, p32, p64 in zip(k8s, per_it, ref64):
        ok, errs = _within_rule(a, p32, p64)
        assert ok, errs


def _ell_solve_grad(dev, dtype, iters, B):
    """u and the κ gradient of the batched ELL solve's MSE on a perturbed
    12² mesh, and the K8 and K8s launches it made."""
    mesh = _general_mesh(dev, (12, 12), dtype=dtype, seed=1)
    ell = tun.build_ell(mesh)
    g = torch.Generator().manual_seed(3)

    def rand(*shape):
        return torch.rand(*shape, generator=g, dtype=torch.float64).to(
            dev, dtype)

    k = (1.0 + rand(B, mesh.n_elements)).requires_grad_()
    F, ud = 0.01 * rand(B, mesh.n_nodes), 0.01 * rand(B, mesh.n_nodes)
    before = dict(k8.launches)
    u = tun.solve_poisson_cg_ell_batched(mesh, ell, k, F, 0.0, iters)
    ((u - ud) ** 2).mean().backward()
    if dev != "cpu":
        torch.cuda.synchronize()
    return (u.detach().cpu(), k.grad.cpu()), \
        {key: k8.launches[key] - before[key] for key in before}


def test_ell_batched_gradient_on_k8(cuda):
    """The batched ELL solve and its κ gradient on the card against the
    same solve on CPU tensors (the plain version): f64 on the
    per-iteration route (K8 forward and adjoint, 2·iters + 3 launches)
    within 1e-10; f32 on K8s (one K8 launch for the right-hand side, one
    K8s launch a solve) by the rule, with the plain f32 and f64 runs on
    the CPU."""
    iters, B = 64, 32
    ref64, _ = _ell_solve_grad("cpu", torch.float64, iters, B)
    ref32, _ = _ell_solve_grad("cpu", torch.float32, iters, B)
    for dtype in (torch.float64, torch.float32):
        got, launched = _ell_solve_grad(cuda, dtype, iters, B)
        assert launched == ({"ell_apply": 2 * iters + 3, "ell_cg": 0}
                            if dtype == torch.float64 else
                            {"ell_apply": 1, "ell_cg": 2})
        for a, p32, p64 in zip(got, ref32, ref64):
            if dtype == torch.float64:
                assert rel_err(a, p64) <= 1e-10
            else:
                ok, errs = _within_rule(a, p32, p64)
                assert ok, errs


def test_fit_kappa_on_line_meshes_k1_does_not_take(cuda):
    """F1: more than MAX_ROWS nodes in f32, and float64, take the torch
    closed form; no K1 launch, a falling loss."""
    for n, dtype in ((300, torch.float32), (30, torch.float64)):
        mesh = FEMesh.line(n, dtype=dtype, device=cuda)
        g = torch.Generator(device=cuda).manual_seed(n)
        B = 256
        f = (torch.sin(torch.pi * mesh.nodes[:, 0]) + 1.0).expand(B, n + 1)
        ud = solve_poisson_batched(
            mesh, 1.0 + 2.0 * torch.rand(B, n, generator=g, device=cuda,
                                         dtype=dtype), f, method="tridiag")
        before = dict(tk.launches)
        kappa, info = fit_kappa(mesh, f, ud, steps=40)
        assert info["path"] == "cf_torch"
        assert tk.launches == before
        hist = info["loss_history"]
        assert torch.isfinite(kappa).all() and kappa.dtype == dtype
        assert torch.all(hist[1:] < hist[:-1])
        assert info["eval_loss"] < float(hist[0])


def test_fit_kappa_ell_route_launches_k8(cuda):
    mesh = _general_mesh(cuda, (8, 8), dtype=torch.float32, seed=2)
    B, steps, iters = 128, 4, 16
    g = torch.Generator(device=cuda).manual_seed(0)
    x = mesh.nodes
    f = (2 * math.pi ** 2 * torch.sin(math.pi * x[:, 0])
         * torch.sin(math.pi * x[:, 1])).expand(B, -1)
    ell = tun.build_ell(mesh)
    kt = 1.0 + torch.rand(B, mesh.n_elements, generator=g, device=cuda)
    ud = tun.solve_poisson_cg_ell_batched(mesh, ell, kt,
                                          assemble_load(mesh, f), 0.0, 256)
    before = dict(k8.launches)
    kappa, info = fit_kappa(mesh, f, ud, steps=steps, iters=iters)
    torch.cuda.synchronize()
    assert info["path"] == "generic_ell_batchminor"
    # a step: K8 for the right-hand side, K8s forward and adjoint; the
    # eval solve: one of each
    assert k8.launches["ell_apply"] == before["ell_apply"] + steps + 1
    assert k8.launches["ell_cg"] == before["ell_cg"] + 2 * steps + 1
    assert torch.isfinite(kappa).all()
    assert info["eval_loss"] < float(info["loss_history"][0])


# ---------------------------------------------------------------------------
# K7's ablations B-F and A1 (probes/k7_ablation.py, the port of the TPU
# probe P2): each kernel against its plain version, f32 by the rule above
# and f64 within 1e-10 where built (D, E, F, A1); F and A1 equal to A (K7
# version 1) bit for bit.  Shared F, as P2's workload.
# ---------------------------------------------------------------------------


def _ablation_plain(variant, mesh, lk, F, ud, scale):
    def to(t):
        return t if t.dtype == torch.bfloat16 else t.to(mesh.dtype)

    return k7ab.plain_step(variant, lk.to(mesh.dtype), F.to(mesh.dtype),
                           to(ud), k5.scalar_columns(mesh),
                           k7.mxu_inverse(mesh), scale)


def _ablation_launches(variant):
    """Launches of ``variant``'s kernel (tcA's are K7's on its tc route)."""
    return (k7.launches["k7"] if variant == "tcA"
            else k7ab.launches[variant])


@pytest.mark.parametrize("B", [7, 1000])
@pytest.mark.parametrize("ne", [12, 30])
@pytest.mark.parametrize("variant", ["B", "C", "D", "E", "F", "A1", "tcA",
                                     "tcB", "tcC", "tcD", "tcE", "tcF"])
def test_k7_ablation_matches_plain(cuda, variant, ne, B):
    """f32 by the rule (C with its bf16 slack), f64 within 1e-10.  At
    B = 7 each kernel also equals its own run on 1000 scenarios bit for
    bit (a scenario's result depends on its own row alone), and the rule
    is applied to 12 seeded 7-scenario launches taken together: K7 itself
    misses it on 6 of 160 single 7-scenario cases on an H100, a maximum
    over 7 being too small a sample.  The tc set (float32 only) is held
    against plain versions with its products' rounding."""
    before = _ablation_launches(variant)
    runs = 0
    for bc, bf16 in (((0.0, 0.0), True), ((0.3, -0.2), False)):
        mesh32, mesh64, lk, _, F, ud = _fused_inputs(cuda, ne, 1000,
                                                     11 + runs, bc, bf16, True)
        scale = 2.0 / (1000 * (ne + 1))
        kern = k7ab.ablation_step(variant, mesh32, lk, F, ud, scale)
        runs += 1
        if B == 7:
            part = k7ab.ablation_step(variant, mesh32, lk[:7], F, ud[:7],
                                      scale)
            runs += 1
            for a, b in zip(part, kern):
                assert a.shape == (7,) and torch.equal(a, b[:7])
            lk, ud = lk[:7], ud[:7]
            outs = ([], [], [])
            for seed in range(12):
                _, _, lk7, _, F7, ud7 = _fused_inputs(cuda, ne, 7, 100 + seed,
                                                      bc, bf16, True)
                runs += 1
                for out, res in zip(outs, (
                        k7ab.ablation_step(variant, mesh32, lk7, F7, ud7,
                                           scale),
                        _ablation_plain(variant, mesh32, lk7, F7, ud7, scale),
                        _ablation_plain(variant, mesh64, lk7, F7,
                                        ud7.double(), scale))):
                    out.append(res)
            kern, p32, p64 = ([torch.cat(c) for c in zip(*out)]
                              for out in outs)
        else:
            p32 = _ablation_plain(variant, mesh32, lk, F, ud, scale)
            p64 = _ablation_plain(variant, mesh64, lk, F, ud.double(), scale)
        for a, b, c in zip(kern, p32, p64):
            assert a.shape == b.shape and a.dtype == torch.float32
            ok, errs = _within_rule(a, b, c, k7ab.rule_slack(variant, ne + 1))
            assert ok, (bc, bf16, errs)
        if variant in ("D", "E", "F", "A1"):
            k64 = k7ab.ablation_step(variant, mesh64, lk.double(),
                                     F.double(), ud.double(), scale)
            q64 = _ablation_plain(variant, mesh64, lk, F, ud.double(), scale)
            runs += 1
            for a, c in zip(k64, q64):
                assert a.shape == (B,) and rel_err(a, c) <= 1e-10
    torch.cuda.synchronize()
    assert _ablation_launches(variant) == before + runs


@pytest.mark.parametrize("ne", [12, 30])
def test_k7_tc_set_equals_k7_bitwise(cuda, ne):
    """tcA is K7's "tc" route at version 1 and tcF, two tiles a warp,
    gives its bits: f32 and bf16 u_data, batches that leave a ragged
    last tile of either."""
    for B in (1000, 4099):
        for bf16 in (False, True):
            mesh32, _, lk, _, F, ud = _fused_inputs(cuda, ne, B, 6 + B,
                                                    (0.3, -0.2), bf16, True)
            args = (mesh32, lk, F, ud, 1e-3)
            op = torch.bfloat16 if bf16 else None
            k = k7.fused_kappa_mse_step_mxu(mesh32, lk, F, ud, scale=1e-3,
                                            operand_dtype=op, version=1,
                                            refine=0, plan="tc")
            before = k7ab.launches["tcF"]
            for v in ("tcA", "tcF"):
                for x, y in zip(k7ab.ablation_step(v, *args), k):
                    assert torch.equal(x, y), (v, B, bf16)
            assert k7ab.launches["tcF"] == before + 1


@pytest.mark.parametrize("ne", [12, 30])
def test_k7_ablation_f_and_a1_equal_k7_bitwise(cuda, ne):
    for dtype in (torch.float32, torch.float64):
        for bf16 in (False, True):
            mesh32, mesh64, lk, _, F, ud = _fused_inputs(
                cuda, ne, 1000, 5, (0.3, -0.2), bf16, True)
            mesh = mesh32 if dtype == torch.float32 else mesh64
            ud = ud if bf16 else ud.to(dtype)
            args = (mesh, lk.to(dtype), F.to(dtype), ud, 1e-3)
            before = k7.launches["k7_fma"]
            a = k7ab.ablation_step("A", *args)      # K7's "fma" route
            assert k7.launches["k7_fma"] == before + 1
            for v in ("F", "A1"):
                for x, y in zip(k7ab.ablation_step(v, *args), a):
                    assert torch.equal(x, y), (v, dtype, bf16)


def test_k7_ablation_rejects_what_the_kernels_do_not_take(cuda):
    mesh = FEMesh.line(12, dtype=torch.float64, device=cuda)
    args = (torch.zeros(4, device=cuda, dtype=torch.float64),
            torch.ones(13, device=cuda, dtype=torch.float64),
            torch.ones(4, 13, device=cuda, dtype=torch.float64), 0.1)
    for variant in ("B", "C", "tcA", "tcB", "tcC", "tcD", "tcE", "tcF"):
        with pytest.raises(TypeError, match="float32"):
            k7ab.ablation_step(variant, mesh, *args)
    with pytest.raises(TypeError, match="float16"):
        k7ab.ablation_step("D", mesh, args[0], args[1], args[2].half(), 0.1)


def _mpc_rollout(dev, dtype, method, B, H=50):
    """The heat rollout of the planner at BASELINE.json config 3's width
    (FEMesh.line(64), one κ a scenario) and the q-gradient of its tracking
    cost."""
    from difffe_tpu_torch.control import (MPCConfig, gaussian_actuators,
                                          rollout, tracking_cost)

    mesh = FEMesh.line(64, dtype=dtype, device=dev)
    g = torch.Generator(device=dev).manual_seed(B)
    q = (0.5 * torch.randn(B, H, 3, generator=g, dtype=torch.float64,
                           device=dev)).to(dtype).requires_grad_()
    kappa = torch.linspace(0.8, 1.6, B, dtype=dtype, device=dev)
    act = gaussian_actuators(mesh, [0.25, 0.5, 0.75], 0.1)
    target = 0.3 * torch.sin(torch.pi * mesh.nodes[:, 0])
    traj = rollout(mesh, kappa[:, None].expand(B, 64),
                   torch.zeros(B, mesh.n_nodes, dtype=dtype, device=dev),
                   (q @ act).transpose(0, 1), 2e-3, method=method)
    cfg = MPCConfig(horizon=H, dt=2e-3, control_penalty=1e-6)
    tracking_cost(mesh, traj.transpose(0, 1), target, q,
                  cfg).sum().backward()
    return traj.detach(), q.grad


def test_heat_rollout_on_k2_matches_plain(cuda):
    """The rollout's auto route on the card is K2 (warp route at B =
    4096): its trajectory and the cost's q-gradient by the rule of phase
    7 against the 'tridiag' route (the plain PCR sweeps)."""
    from difffe_tpu_torch.control.heat import resolve_method

    B = 4096
    assert resolve_method(FEMesh.line(64, device=cuda)) == "tridiag_pallas"
    before = dict(k2.launches)
    kern = _mpc_rollout(cuda, torch.float32, "auto", B)
    torch.cuda.synchronize()
    assert k2.launches["pcr"] == before["pcr"] + 2 * 50
    assert k2.launches["pcr_block"] == before["pcr_block"]
    p32 = _mpc_rollout(cuda, torch.float32, "tridiag", B)
    p64 = _mpc_rollout(cuda, torch.float64, "tridiag", B)
    for k, a, b in zip(kern, p32, p64):
        ok, errs = _within_rule(k, a, b)
        assert ok, errs


def test_batched_planner_launches_k2_on_the_warp_route(cuda):
    """Every forward and adjoint step of a batched plan is one K2 launch,
    all on the warp route from 2048 scenarios, and the cost falls."""
    from difffe_tpu_torch.control import (MPCConfig, gaussian_actuators,
                                          make_planner_batched)

    B, H, iters = 4096, 8, 3
    mesh = FEMesh.line(64, device=cuda)
    act = gaussian_actuators(mesh, [0.25, 0.5, 0.75], 0.1)
    cfg = MPCConfig(horizon=H, dt=2e-3, lr=0.3, plan_iters=iters,
                    control_penalty=1e-6)
    target = (0.3 * torch.sin(torch.pi * mesh.nodes[:, 0])).expand(
        B, H, mesh.n_nodes)
    plan = make_planner_batched(mesh, torch.linspace(0.8, 1.6, B,
                                                     device=cuda), act, cfg)
    before = dict(k2.launches)
    q, losses = plan(torch.zeros(B, mesh.n_nodes, device=cuda), target,
                     torch.zeros(B, H, 3, device=cuda))
    torch.cuda.synchronize()
    assert k2.launches["pcr"] == before["pcr"] + 2 * H * iters
    assert k2.launches["pcr_block"] == before["pcr_block"]
    assert losses.shape == (B, iters) and q.shape == (B, H, 3)
    assert bool((losses[:, -1] < losses[:, 0]).all())


@pytest.fixture
def nccl_mesh(cuda):
    """A (1, 1) mesh on the NCCL group of this one card."""
    import torch.distributed as dist

    from difffe_tpu_torch.parallel import make_device_mesh, multihost

    multihost.initialize(device="cuda", timeout_s=60.0)
    try:
        yield make_device_mesh()
    finally:
        dist.destroy_process_group()


def test_parallel_nccl_ping_and_sharded_step(nccl_mesh):
    """HealthCheck over NCCL, and three sharded Adam steps on K2 (two
    launches each) equal to recover_kappa_field's."""
    from difffe_tpu_torch.inverse import recover_kappa_field
    from difffe_tpu_torch.parallel import (make_inversion_step,
                                           make_inversion_step_shard_map,
                                           multihost)

    hc = multihost.HealthCheck(60.0)
    assert hc.ping(nccl_mesh) and hc.ping()
    mesh = FEMesh.line(64, dtype=torch.float32, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(5)
    k_true = 1.0 + torch.rand(64, 64, generator=g, device="cuda")
    f = 1.0 + torch.rand(64, 65, generator=g, device="cuda")
    u_data = solve_poisson_batched(mesh, k_true, f, method="tridiag")
    results = []
    for init_fn, step in (
            make_inversion_step(mesh, nccl_mesh, lr=0.05,
                                method="tridiag_pallas")[:2],
            make_inversion_step_shard_map(mesh, nccl_mesh, lr=0.05,
                                          method="tridiag_pallas")):
        log_k, opt = init_fn(torch.zeros(64, 64))
        before = dict(k2.launches)
        losses = [step(log_k, opt, f, u_data)[2] for _ in range(3)]
        assert k2.launches["pcr_block"] - before["pcr_block"] == 6
        results.append((log_k.detach().clone(), torch.stack(losses)))
    _, hist = recover_kappa_field(mesh, f, u_data, adam_steps=3, lr=0.05,
                                  method="tridiag_pallas")
    assert torch.equal(results[0][0], results[1][0])
    assert rel_err(results[0][1], hist) <= 1e-6


def test_parallel_halo_and_pipeline_on_the_card(nccl_mesh):
    """The halo solver (2D) and the pipelined rollout at world size 1 on
    the card against the one-process solve and rollout."""
    from difffe_tpu_torch.control.heat import rollout_batched
    from difffe_tpu_torch.ops.pcg import batched_dot
    from difffe_tpu_torch.ops.stencil import solve_poisson_structured
    from difffe_tpu_torch.parallel import make_halo_solver, pipelined_rollout

    grid = StructuredGrid.unit(16, 16)
    g = torch.Generator(device="cuda").manual_seed(6)
    kl = (1.0 + torch.rand(4, 16, 16, generator=g, device="cuda")
          ).requires_grad_()
    ku = 1.0 + torch.rand(4, 16, 16, generator=g, device="cuda")
    fh = torch.rand((4,) + grid.node_shape, generator=g, device="cuda")
    gh = torch.zeros(grid.node_shape, device="cuda")
    u = make_halo_solver(nccl_mesh, grid, maxiter=64)((kl, ku), fh, gh)
    (gk,) = torch.autograd.grad((u * u).sum(), (kl,))
    u_ref = solve_poisson_structured(grid, (kl, ku), fh, gh, maxiter=64,
                                     dot=batched_dot(2))
    (gk_ref,) = torch.autograd.grad((u_ref * u_ref).sum(), (kl,))
    assert rel_err(u, u_ref) <= 1e-6 and rel_err(gk, gk_ref) <= 1e-6

    mesh = FEMesh.line(16, dtype=torch.float32, device="cuda")
    kappa = (0.8 + torch.rand(16, generator=g, device="cuda")
             ).requires_grad_()
    u0 = torch.rand(64, 17, generator=g, device="cuda")
    f_seq = torch.rand(8, 64, 17, generator=g, device="cuda")
    before = dict(k2.launches)
    u_fin, cost = pipelined_rollout(nccl_mesh, mesh, kappa, u0, f_seq, 0.01,
                                    n_micro=4,
                                    cost_fn=lambda v: (v * v).sum())
    (gp,) = torch.autograd.grad(cost, (kappa,))
    assert k2.launches["pcr_block"] - before["pcr_block"] == 2 * 4 * 8
    traj = rollout_batched(mesh, kappa, u0, f_seq, 0.01)
    cost_ref = (traj * traj).sum()
    (gp_ref,) = torch.autograd.grad(cost_ref, (kappa,))
    assert rel_err(u_fin, traj[-1]) <= 1e-5
    assert rel_err(cost, cost_ref) <= 1e-5 and rel_err(gp, gp_ref) <= 1e-5
