"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA card and skips without one.  The file imports
no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import math

import pytest
import torch

from difffe_tpu_torch.inverse import fit_kappa
from difffe_tpu_torch.mesh import FEMesh
from difffe_tpu_torch.ops.assembly import assemble_load
from difffe_tpu_torch.ops.kernels import fused_grad_cf_kernel as tk
from difffe_tpu_torch.ops.kernels import stencil3d_cg_kernel as k4
from difffe_tpu_torch.ops.kernels import stencil_cg_kernel as sk
from difffe_tpu_torch.ops.kernels import tridiag_kernel as k2
from difffe_tpu_torch.ops import tridiag as ttri
from difffe_tpu_torch.ops.stencil import StructuredGrid, residual_vjp_manual
from difffe_tpu_torch.ops.stencil3d import (StructuredGrid3,
                                            residual_vjp_manual_3d)
from difffe_tpu_torch.solver import solve_poisson_batched
from difffe_tpu_torch.utils.profiling import timeit_chained
from torch_parity import rel_err

pytestmark = pytest.mark.cuda

STEP_TOL = 1e-5     # f32 running sums vs torch.cumsum, one step
CHAIN_TOL = 1e-4    # the same over a 32-step chain


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the K1, K2, K3 and K4 kernels have "
                    "no CPU mode")
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


@pytest.mark.parametrize("n", [10, 30, 128])
@pytest.mark.parametrize("ud_mode", ["shared", "f32", "bf16"])
def test_kernel_matches_plain(cuda, n, ud_mode):
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


def _within_rule(kernel, plain32, plain64):
    ek, ep = rel_err(kernel, plain64), rel_err(plain32, plain64)
    return ek <= 2.0 * ep + 1e-6, (ek, ep)


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


@pytest.mark.parametrize("n,B", [(8, 7), (64, 16), (256, 2)],
                         ids=["8x8_B7", "64x64_B16", "256x256_B2"])
@pytest.mark.parametrize("g_nonzero", [False, True], ids=["g0", "g"])
def test_k3b_matches_plain_cold_and_warm(cuda, n, B, g_nonzero):
    grid, arrays = _k3_problem(cuda, n, B, g_nonzero, seed=n + B)
    before = sk.launches["cg2"]
    kern = _k3b_steps(grid, arrays, torch.float32, sk._cg2, 32, 4)
    p32 = _k3b_steps(grid, arrays, torch.float32, sk._cg2_plain, 32, 4)
    p64 = _k3b_steps(grid, arrays, torch.float64, sk._cg2_plain, 32, 4)
    torch.cuda.synchronize()
    assert sk.launches["cg2"] == before + 4
    for step, (k, p, q) in enumerate(zip(kern, p32, p64)):
        for key in ("x", "lam", "grad"):
            assert torch.isfinite(k[key]).all()
            ok, errs = _within_rule(k[key], p[key], q[key])
            assert ok, (step, key, errs)


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
    torch.cuda.synchronize()
    for i in range(2):
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


@pytest.mark.parametrize("n,B,bf16", [((12, 9, 6), 7, False),
                                      ((12, 9, 6), 7, True),
                                      ((32, 32, 32), 3, False)],
                         ids=["12x9x6_B7", "12x9x6_B7_bf16", "32cube_B3"])
@pytest.mark.parametrize("g_nonzero", [False, True], ids=["g0", "g"])
def test_k4b_matches_plain_cold_and_warm(cuda, n, B, bf16, g_nonzero):
    grid, arrays = _k4_problem(cuda, n, B, g_nonzero, seed=sum(n) + B)
    od = torch.bfloat16 if bf16 else None
    before = k4.launches["cg3_2"]
    kern = _k4b_steps(grid, arrays, torch.float32, k4._cg3_2, 48, 3, od)
    p32 = _k4b_steps(grid, arrays, torch.float32, k4._cg3_2_plain, 48, 3, od)
    p64 = _k4b_steps(grid, arrays, torch.float64, k4._cg3_2_plain, 48, 3, od)
    torch.cuda.synchronize()
    assert k4.launches["cg3_2"] == before + 3
    for step, (k, p, q) in enumerate(zip(kern, p32, p64)):
        for key in ("x", "lam", "grad"):
            assert torch.isfinite(k[key]).all()
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
    assert k4.launches["cg3"] == before["cg3"] + 1
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
    d, e, F, w = _k2_bands(cuda, n, 7, seed=n)
    if shared:
        d, e = d[0], e[0]
    before = k2.launches["pcr"]
    q = _k2_solve(ttri.tridiag_solve, d, e, F, w)
    for dt in (torch.float64, torch.float32):
        args = [t.to(dt) for t in (d, e, F, w)]
        k = _k2_solve(k2.tridiag_solve_kernel, *args)
        p = _k2_solve(ttri.tridiag_solve, *args)
        for a, b, c in zip(k, p, q):
            assert a.shape == c.shape and torch.isfinite(a).all()
            if dt == torch.float64:
                assert rel_err(a, c) <= 1e-10
            else:
                ok, errs = _within_rule(a, b, c)
                assert ok, errs
        for layout, bb in (("transposed", 64), ("batch", 1), ("batch", 64),
                           ("other", 3)):
            u = k2.tridiag_solve_kernel(*args[:3], block_b=bb, layout=layout)
            assert torch.equal(u, k[0]), (layout, bb)
    torch.cuda.synchronize()
    assert k2.launches["pcr"] == before + 2 * (2 + 4)


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
    before = k2.launches["pcr"]
    u = solve_poisson_batched(mesh, k, f, method="tridiag_pallas")
    (g,) = torch.autograd.grad(u.square().sum(), k)
    assert k2.launches["pcr"] == before + 2
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
