"""Parity of the plain versions of kernels K3a/K3b (the CPU path of
``ops/kernels/stencil_cg_kernel.py``) with the JAX package's Pallas
whole-CG kernels, run in interpret mode on the same numpy inputs (f64),
at the grids of tests/test_pallas_stencil.py."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from difffe_tpu.ops.pallas import stencil_cg_kernel as jk
from difffe_tpu.ops.stencil import StructuredGrid as JGrid
from difffe_tpu_torch.ops.kernels import stencil_cg_kernel as tk
from torch_parity import as_torch, port_grid, rel_err

torch.set_num_threads(1)

PARITY = 1e-9


def _problem(n, B=None, seed=0, g_nonzero=False):
    """κ_lower, forcing, Dirichlet values and observations as numpy f64."""
    rng = np.random.default_rng(seed)
    xs = np.linspace(0.0, 1.0, n + 1)
    X, Y = np.meshgrid(xs, xs)
    f = 2 * math.pi ** 2 * np.sin(math.pi * X) * np.sin(math.pi * Y)
    lead = () if B is None else (B,)
    kl = 1.0 + rng.random(lead + (n, n))
    if B is not None:
        f = f * (1.0 + 0.2 * rng.random((B, 1, 1)))
    g = 0.3 * X + 0.1 * Y if g_nonzero else np.zeros_like(X)
    ud = 0.05 * np.sin(math.pi * X) * np.sin(math.pi * Y) * (
        1.0 + rng.random(lead + (1, 1)))
    jg = JGrid.unit(n, n)
    return jg, port_grid(jg), kl, f, g, ud


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _t(*arrays, grad=False):
    return [as_torch(a).requires_grad_(grad) for a in arrays]


@pytest.mark.parametrize("block_b", [1, 2])
def test_solve_structured_kernel_value_and_grad(block_b):
    jg, tg, kl, f, g, _ = _problem(8, B=5, seed=1)
    ku = 1.5 * kl
    w = np.random.default_rng(2).standard_normal(f.shape)
    iters = 60

    def jloss(kl_, ku_, f_, g_):
        u = jk.solve_structured_pallas(jg, (kl_, ku_), f_, g_, iters, block_b)
        return jnp.sum(jnp.asarray(w) * u), u

    (_, ju), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3), has_aux=True))(*_j(kl, ku, f, g))
    targs = _t(kl, ku, f, g, grad=True)
    tu = tk.solve_structured_kernel(tg, tuple(targs[:2]), *targs[2:],
                                    iters=iters, block_b=block_b)
    (as_torch(w) * tu).sum().backward()
    assert rel_err(tu, ju) <= PARITY
    for t, j in zip(targs, jgrads):
        assert t.grad.shape == j.shape
        assert rel_err(t.grad, j) <= PARITY


def test_solve_structured_kernel_unbatched():
    jg, tg, kl, f, g, _ = _problem(6, seed=4, g_nonzero=True)
    ju = jax.jit(lambda klu, f, g: jk.solve_structured_pallas(
        jg, klu, f, g, 40, 1))(_j(kl, kl), *_j(f, g))
    tu = tk.solve_structured_kernel(tg, _t(kl, kl), *_t(f, g), iters=40,
                                    block_b=1)
    assert tu.shape == ju.shape
    assert rel_err(tu, ju) <= PARITY


def test_prepare_and_fold_match_jax():
    jg, tg, kl, f, g, _ = _problem(6, B=3, seed=5, g_nonzero=True)
    C, D, b, Minv, x0, B = tk._prepare(tg, _t(kl, 2 * kl), *_t(f, g))
    jC, jD, jb, jM, jx0, jB, W = jk._prepare(jg, _j(kl, 2 * kl), *_j(f, g))
    assert B == jB == 3 and W == 7
    assert rel_err(C, jC) <= PARITY
    for t, j in ((D, jD[:, :, :, :W]), (b, jb[:, :, :W]),
                 (Minv, jM[:, :, :W]), (x0, jx0[:, :, :W])):
        assert tuple(t.shape) == tuple(j.shape)
        assert rel_err(t, j) <= PARITY
    m = np.zeros((7, 7))
    m[0, :] = m[-1, :] = m[:, 0] = m[:, -1] = 1.0
    folded = tk._fold_bc_planes(C, as_torch(m))
    assert folded.shape == (7, 3, 7, 7)
    assert rel_err(folded, jk._fold_bc_planes(jC, jnp.asarray(m))) <= PARITY


@pytest.mark.parametrize("two_launch", [False, True],
                         ids=["fused", "two_launch"])
def test_grad_step_cold_then_warm(two_launch):
    """Cold step, then the state threaded through three warm steps with
    SGD updates of κ between them; every return against JAX's."""
    jg, tg, kl, f, g, ud = _problem(8, B=3, seed=6, g_nonzero=True)
    jstep_ = (jk.kappa_mse_step_2d_two_launch if two_launch
              else jk.fused_kappa_mse_step_2d)
    tstep = (tk.kappa_mse_step_2d_two_launch if two_launch
             else tk.fused_kappa_mse_step_2d)
    jkl, jku, tkl, tku = *_j(kl, kl), *_t(kl, kl)
    jstate = tstate = None
    jstep = jax.jit(lambda klu, st: jstep_(
        jg, klu, *_j(f, g, ud), iters=24, block_b=1, warm_state=st,
        return_state=True))
    for _ in range(4):
        jlp, (jgl, jgu), ju, jstate = jstep((jkl, jku), jstate)
        tlp, (tgl, tgu), tu, tstate = tstep(
            tg, (tkl, tku), *_t(f, g, ud), iters=24, block_b=1,
            warm_state=tstate, return_state=True)
        for t, j in ((tlp, jlp), (tgl, jgl), (tgu, jgu), (tu, ju)):
            assert tuple(t.shape) == tuple(j.shape)
            assert rel_err(t, j) <= PARITY
        # the port's state is the unpadded (x, λ) pair
        assert rel_err(tstate[0], jstate[0][:, :, :9]) <= PARITY
        assert rel_err(tstate[1], jstate[1][:, :, :9]) <= PARITY
        jkl, jku = jkl - 30.0 * jgl, jku - 30.0 * jgu
        tkl, tku = tkl - 30.0 * tgl, tku - 30.0 * tgu


def test_fused_step_unbatched_nonzero_g_and_default_scale():
    jg, tg, kl, f, g, ud = _problem(8, seed=7, g_nonzero=True)
    jlp, (jgl, jgu), ju = jax.jit(lambda klu, f, g, ud: (
        jk.fused_kappa_mse_step_2d(jg, klu, f, g, ud, iters=40,
                                   block_b=1)))(_j(kl, 2 * kl),
                                                *_j(f, g, 0.9 * ud))
    tlp, (tgl, tgu), tu = tk.fused_kappa_mse_step_2d(
        tg, _t(kl, 2 * kl), *_t(f, g, 0.9 * ud), iters=40, block_b=1)
    assert tu.shape == ju.shape == (9, 9)
    assert tgl.shape == jgl.shape == (8, 8)
    for t, j in ((tlp, jlp), (tgl, jgl), (tgu, jgu), (tu, ju)):
        assert rel_err(t, j) <= PARITY


def test_fused_and_two_launch_states_interchange():
    jg, tg, kl, f, g, ud = _problem(8, B=2, seed=8)
    args = (tg, _t(kl, kl), *_t(f, g, ud))
    lp_f, _, _, st_f = tk.fused_kappa_mse_step_2d(*args, iters=48,
                                                  return_state=True)
    lp_t, _, _, st_t = tk.kappa_mse_step_2d_two_launch(*args, iters=48,
                                                       return_state=True)
    assert rel_err(lp_t, lp_f) <= 1e-12
    lp_w, _, _ = tk.kappa_mse_step_2d_two_launch(*args, iters=4,
                                                 warm_state=st_f)
    lp_w2, _, _ = tk.fused_kappa_mse_step_2d(*args, iters=4,
                                             warm_state=st_t)
    assert rel_err(lp_w, lp_f) <= 1e-6 and rel_err(lp_w2, lp_f) <= 1e-6


def test_choose_2d_path_and_block_b():
    """The CUDA kernel takes every grid (shared memory or a workspace), so
    the router answers 'fused' where the TPU's VMEM budget split paths."""
    for n, bb in ((8, 8), (64, 8), (256, 1), (512, 1), (1024, 4)):
        assert tk.choose_2d_path(port_grid(JGrid.unit(n, n)), bb) == \
            "fused"
    assert jk.choose_2d_path(JGrid.unit(512, 512), 1) == "two_launch"
    _, tg, kl, f, g, ud = _problem(6, B=2, seed=9)
    with pytest.raises(ValueError, match="block_b"):
        tk.fused_kappa_mse_step_2d(tg, _t(kl, kl), *_t(f, g, ud),
                                   block_b=0)
    with pytest.raises(ValueError, match="block_b"):
        tk.choose_2d_path(tg, 0)
    before = dict(tk.launches)
    tk.fused_kappa_mse_step_2d(tg, _t(kl, kl), *_t(f, g, ud), iters=4)
    assert tk.launches == before        # the plain CPU path launches none
