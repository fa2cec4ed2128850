"""Parity of the PyTorch port's SPIKE tridiagonal solver (ops/spike.py) and
mixed-precision solves (ops/precision.py) with the JAX package, on the
same numpy inputs.  SPIKE is held to JAX's SPIKE in f64.  The bf16 solves'
inner passes round differently in the two packages (torch rounds every
bf16 operation, XLA may keep f32 between fused ones), so they are held to
JAX's f64 solves at the tolerances stated below, as the JAX package's own
tests hold its bf16 solves."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from difffe_tpu.mesh import FEMesh as JMesh
from difffe_tpu.ops import assembly as jasm
from difffe_tpu.ops import spike as jspike
from difffe_tpu.ops import stencil as jst
from difffe_tpu.ops import tridiag as jtri
from difffe_tpu_torch.ops import assembly as tasm
from difffe_tpu_torch.ops import precision as tprec
from difffe_tpu_torch.ops import spike as tspike
from difffe_tpu_torch.ops import tridiag as ttri
from torch_parity import as_torch, jax_mesh, port_grid, port_mesh, rel_err

torch.set_num_threads(1)

SPIKE_TOL = 1e-12      # SPIKE in f64 against JAX's SPIKE and PCR
REFINED_1D = 1e-6      # bf16 PCR + 3 f32 passes at n = 16 against f64
BF16_2D = 1e-5         # 8²: 16 bf16 CG iterations × (1 + 3) passes
GRAD_BF16 = 2e-5       # the bf16 solve's κ gradient

N, CHUNK = 13, 4       # n not a multiple of the chunk
LEAD = (2, 3)          # leading batch axes


def _bands(lead, n, seed):
    """Diagonally dominant symmetric bands (d, e) and a right-hand side."""
    rng = np.random.default_rng(seed)
    e = -rng.random(lead + (n - 1,)) - 0.1
    d = rng.random(lead + (n,)) + 0.1
    d[..., :-1] -= e
    d[..., 1:] -= e
    return d, e, rng.standard_normal(lead + (n,))


def _fem_bands_1d(n=16, kappa=1.37):
    """The JAX test's BC-eliminated 1D band at κ = 1.37 (not
    bf16-representable after assembly), numpy f64."""
    x = np.linspace(0.0, 1.0, n + 1)
    h = 1.0 / n
    d = np.full(n + 1, 2.0 * kappa / h)
    d[[0, -1]] = 1.0
    e = np.full(n, -kappa / h)
    e[[0, -1]] = 0.0
    F = h * (np.sin(np.pi * x) + 1.0)
    F[[0, -1]] = 0.0
    return d, e, F


def _grid_problem():
    jg = jst.StructuredGrid.unit(8, 8)
    rng = np.random.default_rng(5)
    kl = 1.0 + rng.random((8, 8))
    ku = 1.0 + rng.random((8, 8))
    f = 1.0 + rng.random((9, 9))
    yy, xx = np.meshgrid(np.linspace(0, 1, 9), np.linspace(0, 1, 9),
                         indexing="ij")
    g = 0.3 * (xx + yy)
    w = rng.standard_normal((9, 9))
    return jg, kl, ku, f, g, w


@pytest.fixture(scope="module")
def jax_ref():
    """Every JAX reference of this module, from one jitted call."""
    d, e, F = _bands(LEAD, N, 0)
    w = np.random.default_rng(1).standard_normal(LEAD + (N,))
    jm = jax_mesh(JMesh.line, 12, bc_left=0.3, bc_right=-0.2,
                  dtype=jnp.float64)
    k = 1.0 + np.random.default_rng(2).random(12)
    fm = np.random.default_rng(3).standard_normal((4, 13))
    d1, e1, F1 = _fem_bands_1d()
    jg, kl, ku, f, g, wg = _grid_problem()

    def ref(d, e, F, w, k, fm, d1, e1, F1, kl, ku, f, g, wg):
        def spike_loss(d, e, F):
            u = jspike.tridiag_solve_spike(d, e, F, CHUNK)
            return jnp.sum(w * u), u

        (_, u_spike), g_spike = jax.value_and_grad(
            spike_loss, argnums=(0, 1, 2), has_aux=True)(d, e, F)
        u_pcr = jtri.tridiag_solve(d, e, F)
        jd, je = jasm.assemble_tridiag_1d(jm, k)
        jF = jasm.assemble_load(jm, fm)
        u_backend = jtri.solve_poisson_tridiag(jm, jd, je, jF,
                                               backend="spike", chunk=CHUNK)

        def oracle_loss(d, e, F):
            u = jtri.tridiag_solve(d, e, F)
            return jnp.sum(u * F), u

        (_, u_or), g_or = jax.value_and_grad(
            oracle_loss, argnums=(0, 1, 2), has_aux=True)(d1, e1, F1)

        def grid_loss(kl, ku):
            u = jst.solve_poisson_structured(jg, (kl, ku), f, g, 1e-13, 400)
            return jnp.sum(wg * u), u

        (_, u_grid), g_grid = jax.value_and_grad(
            grid_loss, argnums=(0, 1), has_aux=True)(kl, ku)
        return dict(u_spike=u_spike, g_spike=g_spike, u_pcr=u_pcr,
                    u_backend=u_backend, u_or=u_or, g_or=g_or,
                    u_grid=u_grid, g_grid=g_grid)

    out = jax.jit(ref)(d, e, F, w, k, fm, d1, e1, F1, kl, ku, f, g, wg)
    return dict(jax.tree_util.tree_map(np.asarray, out), bands=(d, e, F, w),
                mesh=(jm, k, fm), grid=(jg, kl, ku, f, g, wg))


def test_spike_values_and_grads_match_jax(jax_ref):
    d, e, F, w = jax_ref["bands"]
    td, te, tF = (as_torch(a).requires_grad_() for a in (d, e, F))
    u = tspike.tridiag_solve_spike(td, te, tF, CHUNK)
    (as_torch(w) * u).sum().backward()
    assert u.shape == LEAD + (N,)
    assert rel_err(u, jax_ref["u_spike"]) <= SPIKE_TOL
    assert rel_err(u, jax_ref["u_pcr"]) <= SPIKE_TOL
    for t, j in zip((td, te, tF), jax_ref["g_spike"]):
        assert rel_err(t.grad, j) <= SPIKE_TOL


@pytest.mark.parametrize("chunk", [1, 4, 13, 32])
def test_spike_chunks_and_shared_bands(jax_ref, chunk):
    """Any chunk (one row, a divisor of nothing, all rows, more than all)
    solves the same system; a band shared by the batch broadcasts."""
    d, e, F, _ = jax_ref["bands"]
    u = tspike.tridiag_solve_spike(as_torch(d), as_torch(e), as_torch(F),
                                   chunk)
    assert rel_err(u, jax_ref["u_pcr"]) <= SPIKE_TOL
    shared = tspike.tridiag_solve_spike(as_torch(d[0, 0]), as_torch(e[0, 0]),
                                        as_torch(F), chunk)
    assert rel_err(shared, ttri.tridiag_solve(as_torch(d[0, 0]),
                                              as_torch(e[0, 0]),
                                              as_torch(F))) <= SPIKE_TOL


def test_spike_double_backward_matches_pcr(jax_ref):
    """The backward is written in differentiable ops: a Hessian-vector
    product through SPIKE equals the PCR oracle's."""
    d, e, F, w = jax_ref["bands"]
    hv = []
    for solve in (lambda d_, F_: tspike.tridiag_solve_spike(
            d_, as_torch(e), F_, CHUNK),
                  lambda d_, F_: ttri.tridiag_solve(d_, as_torch(e), F_)):
        td, tF = as_torch(d).requires_grad_(), as_torch(F).requires_grad_()
        (gF,) = torch.autograd.grad((solve(td, tF) ** 2).sum(), tF,
                                    create_graph=True)
        (hd,) = torch.autograd.grad((gF * as_torch(w)).sum(), td)
        hv.append(hd)
    assert rel_err(hv[0], hv[1]) <= SPIKE_TOL


def test_spike_backend_of_the_band_solver(jax_ref):
    jm, k, fm = jax_ref["mesh"]
    tm = port_mesh(jm)
    td, te = tasm.assemble_tridiag_1d(tm, as_torch(k))
    tF = tasm.assemble_load(tm, as_torch(fm))
    u = ttri.solve_poisson_tridiag(tm, td, te, tF, backend="spike",
                                   chunk=CHUNK)
    assert u.shape == (4, 13)
    assert rel_err(u, jax_ref["u_backend"]) <= SPIKE_TOL
    assert rel_err(u, ttri.solve_poisson_tridiag(tm, td, te, tF)) \
        <= SPIKE_TOL
    with pytest.raises(ValueError, match="unknown tridiagonal backend"):
        ttri.solve_poisson_tridiag(tm, td, te, tF, backend="spkie")


def test_refine_generic_converges():
    """A crude low-precision 'solver' (bf16 diagonal inverse) converges
    under refinement on a diagonally dominant system (the JAX test's)."""
    rng = np.random.default_rng(0)
    A = np.eye(32) * 4.0 + 0.1 * rng.standard_normal((32, 32))
    A = torch.tensor((A + A.T) / 2, dtype=torch.float32)
    b = torch.tensor(rng.standard_normal(32), dtype=torch.float32)
    x = tprec.refine(lambda r: r.to(torch.bfloat16) / 4.0, lambda v: A @ v,
                     b, iters=40)
    assert x.dtype == torch.float32
    assert float((A @ x - b).abs().max()) < 1e-4


def test_refined_1d_values_and_grads(jax_ref):
    """n = 16 (cond ≈ 26): 3 passes against the f64 oracle (JAX's PCR
    solve), values and all three band gradients."""
    d, e, F = (torch.tensor(a, dtype=torch.float32, requires_grad=True)
               for a in _fem_bands_1d())
    u = tprec.tridiag_solve_refined(d, e, F, 3)
    (u * F).sum().backward()
    assert u.dtype == torch.float32
    assert rel_err(u, jax_ref["u_or"]) <= REFINED_1D
    for t, j in zip((d, e, F), jax_ref["g_or"]):
        assert rel_err(t.grad, j) <= REFINED_1D


def test_refined_1d_batched_and_contracting():
    """Leading batch axes broadcast, and each pass contracts the error."""
    d, e, F = (torch.tensor(a, dtype=torch.float32)
               for a in _fem_bands_1d())
    FB = torch.stack([F, 2.0 * F, -F])
    u64 = ttri.tridiag_solve(d.double(), e.double(), FB.double())
    errs = [rel_err(tprec.tridiag_solve_refined(d, e, FB, it), u64)
            for it in (0, 1, 3)]
    assert errs[0] > errs[1] > errs[2]
    assert errs[2] <= REFINED_1D


def test_bf16_2d_values_and_grads(jax_ref):
    """8², 16 bf16 CG iterations a pass, 1 + 3 passes: the refined solve
    and its κ gradient against the f64 oracle (JAX's structured solve)."""
    jg, kl, ku, f, g, wg = jax_ref["grid"]
    grid = port_grid(jg)
    f32 = torch.float32
    tkl, tku = (torch.tensor(a, dtype=f32, requires_grad=True)
                for a in (kl, ku))
    u = tprec.solve_poisson_structured_bf16(
        grid, (tkl, tku), torch.tensor(f, dtype=f32),
        torch.tensor(g, dtype=f32), 16, 3)
    (u * torch.tensor(wg, dtype=f32)).sum().backward()
    assert u.dtype == f32
    assert rel_err(u, jax_ref["u_grid"]) <= BF16_2D
    for t, j in zip((tkl, tku), jax_ref["g_grid"]):
        assert rel_err(t.grad, j) <= GRAD_BF16
    with pytest.raises(NotImplementedError, match="differentiable once"):
        tkl2 = torch.tensor(kl, dtype=f32, requires_grad=True)
        u2 = tprec.solve_poisson_structured_bf16(
            grid, (tkl2, torch.tensor(ku, dtype=f32)),
            torch.tensor(f, dtype=f32), torch.tensor(g, dtype=f32), 4, 0)
        torch.autograd.grad(u2.sum(), tkl2, create_graph=True)


def test_bf16_2d_batched_is_per_scenario(jax_ref):
    """A batched call solves each scenario as the unbatched call does (the
    f32-accumulated dots are per scenario)."""
    jg, kl, ku, f, g, _ = jax_ref["grid"]
    grid = port_grid(jg)
    f32 = torch.float32
    klB = torch.tensor(np.stack([kl, 2.0 * kl]), dtype=f32)
    kuB = torch.tensor(np.stack([ku, 0.5 * ku]), dtype=f32)
    fB = torch.tensor(np.stack([f, -f]), dtype=f32)
    tg = torch.tensor(g, dtype=f32)
    uB = tprec.solve_poisson_structured_bf16(grid, (klB, kuB), fB, tg, 16, 3)
    for i in range(2):
        u1 = tprec.solve_poisson_structured_bf16(grid, (klB[i], kuB[i]),
                                                 fB[i], tg, 16, 3)
        assert rel_err(uB[i], u1) <= BF16_2D


def test_ops_exports_match_jax():
    import difffe_tpu.ops as jops
    import difffe_tpu_torch.ops as tops

    assert tops.__all__ == jops.__all__
    for name in tops.__all__:
        assert callable(getattr(tops, name)), name
