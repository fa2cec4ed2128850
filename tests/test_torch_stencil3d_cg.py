"""Parity of the plain versions of kernels K4a/K4b (the CPU path of
``ops/kernels/stencil3d_cg_kernel.py``) with the JAX package's Pallas
whole-CG 3D kernels, run in interpret mode on the same numpy inputs (f64),
on a non-cubic (nx, ny, nz) = (4, 3, 5) box with B = 3 scenarios.  The
JAX side runs under ``jax.jit``, each function compiled once per launch
shape and shared by the cases (eager calls compile every op)."""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from difffe_tpu.ops.pallas import stencil3d_cg_kernel as jk
from difffe_tpu.ops.stencil3d import StructuredGrid3 as JGrid3
from difffe_tpu_torch.ops.kernels import stencil3d_cg_kernel as tk
from torch_parity import as_torch, port_grid, rel_err

torch.set_num_threads(1)

PARITY = 1e-10
ITERS = 16
# bf16 coefficient storage: both packages round the same f64 planes to
# bf16 and upcast them at use, so the stored operators agree; what remains
# is CG rounding on a ~4e-3-perturbed operator
BF16 = 1e-3
NX, NY, NZ = 4, 3, 5


@functools.cache
def _jgrid():
    return JGrid3.unit(NX, NY, NZ, (0.0, 1.0), (0.0, 0.75), (0.0, 1.25))


def _problem(B=3, seed=0, g_nonzero=False):
    """Per-tet κ, forcing, Dirichlet values and observations as numpy
    f64 (B = None: one unbatched scenario)."""
    rng = np.random.default_rng(seed)
    jg = _jgrid()
    zs, ys, xs = (np.linspace(0.0, 1.0, n + 1) for n in (NZ, NY, NX))
    Z, Y, X = np.meshgrid(zs, ys, xs, indexing="ij")
    bump = np.sin(math.pi * X) * np.sin(math.pi * Y) * np.sin(math.pi * Z)
    lead = () if B is None else (B,)
    k = 1.2 + 0.6 * rng.random(lead + (jg.n_elements,))
    f = 10.0 * bump * (1.0 + 0.2 * rng.random(lead + (1, 1, 1)))
    g = 0.3 * X + 0.1 * Y - 0.2 * Z if g_nonzero else np.zeros_like(X)
    ud = 0.05 * bump * (1.0 + rng.random(lead + (1, 1, 1)))
    return jg, port_grid(jg), k, f, g, ud


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _t(*arrays, grad=False):
    return [as_torch(a).requires_grad_(grad) for a in arrays]


@functools.cache
def _jsolve_value_and_grad(block_b):
    """(Σ w·u, u) and its (κ, f, g) gradients through JAX's K4a route."""
    def jloss(k_, f_, g_, w_):
        u = jk.solve_structured_pallas_3d(_jgrid(), k_, f_, g_, ITERS,
                                          block_b)
        return jnp.sum(w_ * u), u
    return jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                      has_aux=True))


@functools.cache
def _jfused_step():
    """JAX's K4b step with its state, cold (state None) or warm."""
    return jax.jit(lambda k_, f_, g_, ud_, state:
                   jk.fused_kappa_mse_step_3d_pallas(
                       _jgrid(), k_, f_, g_, ud_, iters=ITERS,
                       warm_state=state, return_state=True))


def _unfold(jx, B):
    """JAX's padded (Bp, Dz, HWp) kernel plane → (B, Dz, H, W)."""
    Dz, H, W = NZ + 1, NY + 1, NX + 1
    return jx[:B, :, :H * W].reshape(B, Dz, H, W)


@pytest.mark.parametrize("block_b", [1, 2])
@pytest.mark.parametrize("g_nonzero", [False, True], ids=["g0", "g"])
def test_solve_structured_kernel_3d_value_and_grad(block_b, g_nonzero):
    """Value and (κ, f, g) gradients of a weighted sum of u through K4a's
    plain version, against JAX's custom VJP through its kernel."""
    _, tg, k, f, g, _ = _problem(seed=1, g_nonzero=g_nonzero)
    w = np.random.default_rng(2).standard_normal(f.shape)
    (_, ju), jgrads = _jsolve_value_and_grad(block_b)(*_j(k, f, g, w))
    targs = _t(k, f, g, grad=True)
    tu = tk.solve_structured_kernel_3d(tg, *targs, iters=ITERS,
                                       block_b=block_b)
    (as_torch(w) * tu).sum().backward()
    assert rel_err(tu, ju) <= PARITY
    for t, j in zip(targs, jgrads):
        assert t.grad.shape == j.shape
        assert rel_err(t.grad, j) <= PARITY


def test_solve_structured_kernel_3d_unbatched():
    jg, tg, k, f, g, _ = _problem(B=None, seed=4, g_nonzero=True)
    ju = jax.jit(lambda k_, f_, g_: jk.solve_structured_pallas_3d(
        jg, k_, f_, g_, 40, 1))(*_j(k, f, g))
    tu = tk.solve_structured_kernel_3d(tg, *_t(k, f, g), iters=40)
    assert tu.shape == ju.shape == (NZ + 1, NY + 1, NX + 1)
    assert rel_err(tu, ju) <= PARITY


def test_prepare3_and_fold_match_jax():
    jg, tg, k, f, g, _ = _problem(seed=5, g_nonzero=True)
    C, D, b, Minv, x0, B = tk._prepare3(tg, *_t(k, f, g))
    jC, jD, jb, jM, jx0, jB, HW = jax.jit(
        lambda k_, f_, g_: jk._prepare3(jg, k_, f_, g_))(*_j(k, f, g))
    jB, HW = int(jB), int(HW)
    assert B == jB == 3 and HW == (NY + 1) * (NX + 1)
    assert rel_err(C, jC) <= PARITY
    assert D.shape == (7, 3, NZ + 1, NY + 1, NX + 1)
    assert rel_err(D, np.stack([_unfold(jD[i], 3) for i in range(7)])) \
        <= PARITY
    for t, j in ((b, jb), (Minv, jM), (x0, jx0)):
        assert rel_err(t, _unfold(j, 3)) <= PARITY
    m = np.ones((NZ + 1, NY + 1, NX + 1))
    m[1:-1, 1:-1, 1:-1] = 0.0
    assert rel_err(tk._fold_bc_planes_3d(C, as_torch(m)),
                   jax.jit(jk._fold_bc_planes_3d)(jC, jnp.asarray(m))) \
        <= PARITY


@pytest.mark.parametrize("g_nonzero", [False, True], ids=["g0", "g"])
def test_fused_step_cold_then_warm(g_nonzero):
    """A cold K4b step, then the state threaded through two warm steps
    with SGD updates of κ between them; loss parts, ∂κ, u and the state
    against JAX's at every step."""
    _, tg, k, f, g, ud = _problem(seed=6, g_nonzero=g_nonzero)
    jkap, tkap = jnp.asarray(k), as_torch(k)
    jstate = tstate = None
    for _ in range(3):
        jlp, jgk, ju, jstate = _jfused_step()(jkap, *_j(f, g, ud), jstate)
        tlp, tgk, tu, tstate = tk.fused_kappa_mse_step_3d_kernel(
            tg, tkap, *_t(f, g, ud), iters=ITERS, warm_state=tstate,
            return_state=True)
        for t, j in ((tlp, jlp), (tgk, jgk), (tu, ju)):
            assert tuple(t.shape) == tuple(j.shape)
            assert rel_err(t, j) <= PARITY
        # the port's state is the unpadded (x, λ) pair
        for t, j in zip(tstate, jstate):
            assert rel_err(t, _unfold(j, 3)) <= PARITY
        jkap, tkap = jkap - 50.0 * jgk, tkap - 50.0 * tgk


def test_fused_step_unbatched_and_default_scale():
    jg, tg, k, f, g, ud = _problem(B=None, seed=7, g_nonzero=True)
    jlp, jgk, ju = jax.jit(lambda k_, f_, g_, ud_:
                           jk.fused_kappa_mse_step_3d_pallas(
                               jg, k_, f_, g_, ud_, iters=24))(
        *_j(k, f, g, 0.9 * ud))
    tlp, tgk, tu = tk.fused_kappa_mse_step_3d_kernel(
        tg, *_t(k, f, g, 0.9 * ud), iters=24)
    assert tu.shape == ju.shape == (NZ + 1, NY + 1, NX + 1)
    assert tgk.shape == jgk.shape == (jg.n_elements,)
    for t, j in ((tlp, jlp), (tgk, jgk), (tu, ju)):
        assert rel_err(t, j) <= PARITY


def test_bf16_coefficient_storage_matches_jax():
    """operand_dtype=bfloat16 against JAX's bf16 route
    (tests/test_pallas_stencil3d.py's TestBf16Coefficients): the solve,
    its κ gradient and the fused step."""
    jg, tg, k, f, g, ud = _problem(seed=8)
    w = np.random.default_rng(9).standard_normal(f.shape)

    def jloss(k_, f_, g_):
        u = jk.solve_structured_pallas_3d(jg, k_, f_, g_, 32, 1,
                                          jnp.bfloat16)
        return jnp.sum(jnp.asarray(w) * u), u

    (_, ju), jgk = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        *_j(k, f, g))
    tkap = as_torch(k).requires_grad_()
    tu = tk.solve_structured_kernel_3d(tg, tkap, *_t(f, g), iters=32,
                                       operand_dtype=torch.bfloat16)
    (as_torch(w) * tu).sum().backward()
    assert tu.dtype == torch.float64
    assert rel_err(tu, ju) <= BF16
    assert rel_err(tkap.grad, jgk) <= BF16
    jlp, jgk2, _ = jax.jit(lambda k_, f_, g_, ud_:
                           jk.fused_kappa_mse_step_3d_pallas(
                               jg, k_, f_, g_, ud_, iters=32,
                               operand_dtype=jnp.bfloat16))(
        *_j(k, f, g, ud))
    tlp, tgk2, _ = tk.fused_kappa_mse_step_3d_kernel(
        tg, *_t(k, f, g, ud), iters=32, operand_dtype=torch.bfloat16)
    assert rel_err(tlp, jlp) <= BF16 and rel_err(tgk2, jgk2) <= BF16
    _, D, _, Minv, _, _ = tk._prepare3(tg, *_t(k, f, g),
                                       operand_dtype=torch.bfloat16)
    assert D.dtype == Minv.dtype == torch.bfloat16


def test_chain_matches_sequential_solves():
    """K4b's chained forward + cotangent + adjoint equals two sequential
    K4a solves from the same warm state, and a warm step from a converged
    state reproduces a cold deep step's gradient."""
    _, tg, k, f, g, ud = _problem(seed=10, g_nonzero=True)
    kap, ff, gg, uu = _t(k, f, g, ud)
    _, D, b, Minv, x0, B = tk._prepare3(tg, kap, ff, gg)
    scale = 2.0 / b.numel()
    _, _, _, (xs, ls) = tk.fused_kappa_mse_step_3d_kernel(
        tg, kap, ff, gg, uu, iters=8, return_state=True)
    x, lam = tk._cg3_2(D, b, Minv, xs, ls, uu, scale, 12)
    x_seq = tk._cg3(D, b, Minv, xs, 12)
    lam_seq = tk._cg3(D, scale * (x_seq - uu), Minv, ls, 12)
    assert torch.equal(x, x_seq) and torch.equal(lam, lam_seq)
    lp, gk, u, state = tk.fused_kappa_mse_step_3d_kernel(
        tg, kap, ff, gg, uu, iters=120, return_state=True)
    lp2, gk2, u2 = tk.fused_kappa_mse_step_3d_kernel(
        tg, kap, ff, gg, uu, iters=4, warm_state=state)
    assert rel_err(gk2, gk) <= 1e-9 and rel_err(u2, u) <= 1e-9


def test_block_b_checks_and_no_launch_on_cpu():
    _, tg, k, f, g, ud = _problem(seed=11)
    with pytest.raises(ValueError, match="block_b"):
        tk.fused_kappa_mse_step_3d_kernel(tg, *_t(k, f, g, ud), block_b=0)
    with pytest.raises(ValueError, match="block_b"):
        tk.solve_structured_kernel_3d(tg, *_t(k, f, g), block_b=0)
    before = dict(tk.launches)
    tk.fused_kappa_mse_step_3d_kernel(tg, *_t(k, f, g, ud), iters=4)
    tk.solve_structured_kernel_3d(tg, *_t(k, f, g), iters=4)
    assert tk.launches == before        # the plain CPU path launches none


def test_second_order_raises_in_both_packages():
    """A Hessian product through K4a's route, the misfit linear in u with a
    second κ path (as tests/test_torch_stencil_cg.py): both packages
    refuse a second derivative instead of dropping λ's dependence on κ."""
    jg, tg, k, f, g, _ = _problem(B=2, seed=12)
    w = np.random.default_rng(13).standard_normal(f.shape)

    def jmisfit(k_):
        u = jk.solve_structured_pallas_3d(jg, k_, *_j(f, g), 4, 1)
        return jnp.sum(jnp.asarray(w) * u) + jnp.sum(k_ ** 2)

    with pytest.raises(NotImplementedError):
        jax.jit(jax.grad(lambda k_: jnp.sum(jax.grad(jmisfit)(k_))))(
            jnp.asarray(k))
    tkap = as_torch(k).requires_grad_()
    u = tk.solve_structured_kernel_3d(tg, tkap, *_t(f, g), iters=4)
    misfit = (as_torch(w) * u).sum() + (tkap ** 2).sum()
    with pytest.raises(NotImplementedError, match="differentiable once"):
        torch.autograd.grad(misfit, tkap, create_graph=True)
    (gk,) = torch.autograd.grad(misfit, tkap)
    assert gk.shape == tkap.shape and not gk.requires_grad
