"""Parity of the plain versions of kernels K5a (``fused_kappa_mse_step``) and
K7 (``fused_kappa_mse_step_mxu``) — the CPU path of
``ops/kernels/fused_grad_kernel.py`` and ``fused_grad_mxu_kernel.py`` —
with the JAX package, on the same numpy inputs, and of the production
κ-recovery loop (``difffe_tpu_torch/production.py``) with
examples/production_training_demo.py's loop on the JAX wrapper.

The JAX Pallas kernels run in interpret mode once, at 12 elements, in one
``jax.jit`` (a module fixture); the larger meshes are held against the JAX
package's XLA path, ``jax.value_and_grad`` through
``solve_poisson_batched(method="tridiag")``, as tests/test_fused_grad.py
does.  The cases mirror that file's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from difffe_tpu.mesh import FEMesh as JMesh
from difffe_tpu.ops.assembly import assemble_load as jassemble_load
from difffe_tpu.ops.pallas import fused_grad_kernel as jk5
from difffe_tpu.ops.pallas import fused_grad_mxu_kernel as jk7
from difffe_tpu.solver import solve_poisson_batched as jsolve_batched
from difffe_tpu_torch import production
from difffe_tpu_torch.mesh import FEMesh
from difffe_tpu_torch.ops.assembly import assemble_load
from difffe_tpu_torch.ops.kernels import fused_grad_kernel as k5
from difffe_tpu_torch.ops.kernels import fused_grad_mxu_kernel as k7
from torch_parity import as_torch, jax_mesh, rel_err

torch.set_num_threads(1)

PARITY = 1e-10      # f64 port against f64 JAX
# The JAX K7 bodies ask their products for preferred_element_type=float32,
# so even under x64 each product is rounded to float32 (measured 1.8e-8
# against the f64 port); the f64 port is held to the XLA path at PARITY
K7_JAX_KERNEL = 1e-6
BC = (0.7, -0.4)    # nonzero Dirichlet values


def _data(ne, B, seed, bc=(0.0, 0.0)):
    """Per-scenario forcing f (B, n), observations u_data (B, n) and
    log κ (B,), numpy f64."""
    rng = np.random.default_rng(seed)
    x = np.linspace(0.0, 1.0, ne + 1)
    f = (np.sin(np.pi * x) + 1.0) * (1.0 + 0.2 * rng.random((B, 1)))
    ud = (bc[0] + (bc[1] - bc[0]) * x + 0.05 * np.sin(np.pi * x)
          * (1.0 + rng.random((B, 1))))
    return f, ud, 0.3 * rng.standard_normal(B)


def _meshes(ne, bc=(0.0, 0.0), dtype=torch.float64):
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    return (jax_mesh(JMesh.line, ne, bc_left=bc[0], bc_right=bc[1],
                     dtype=jdt),
            FEMesh.line(ne, bc_left=bc[0], bc_right=bc[1], dtype=dtype,
                        device="cpu"))


def _xla_reference(jm):
    """(mean loss, ∂/∂log κ) through the JAX tridiag route, jitted."""
    def loss(lk, f, ud):
        u = jsolve_batched(jm, jnp.exp(lk), f, method="tridiag",
                           kappa_batched=True)
        return jnp.mean((u - ud) ** 2)
    return jax.jit(jax.value_and_grad(loss))


def _port_inputs(tm, f, ud, log_k, dtype=torch.float64):
    F = assemble_load(tm, torch.tensor(f, dtype=dtype))
    return (torch.tensor(log_k, dtype=dtype), F,
            torch.tensor(ud, dtype=dtype))


@pytest.fixture(scope="module")
def jax_kernels():
    """K5a and K7 (versions 1-3, shared F, bf16 u_data) of the JAX package
    in interpret mode, f64, 12 elements, nonzero Dirichlet, B = 7; and K7
    version 3 in f32 (refine 2 and 3) on the same data."""
    jm, tm = _meshes(12, BC)
    jm32, tm32 = _meshes(12, BC, torch.float32)
    f, ud, lk = _data(12, 7, seed=0, bc=BC)

    def run(f, ud, lk):
        F = jassemble_load(jm, f)
        out = {"k5a": jk5.fused_kappa_mse_step(jm, lk, F, ud,
                                               block_lanes=128)}
        for v in (1, 2, 3):
            out[f"v{v}"] = jk7.fused_kappa_mse_step_mxu(
                jm, lk, F, ud, block_lanes=128, version=v, refine=2)
        out["shared"] = jk7.fused_kappa_mse_step_mxu(
            jm, lk, F[0], ud, block_lanes=128)
        out["bf16"] = jk7.fused_kappa_mse_step_mxu(
            jm, lk, F[0], ud, block_lanes=128, operand_dtype=jnp.bfloat16)
        f32 = [a.astype(jnp.float32) for a in (f, ud, lk)]
        F32 = jassemble_load(jm32, f32[0])
        for r in (2, 3):
            out[f"v3_f32_r{r}"] = jk7.fused_kappa_mse_step_mxu(
                jm32, f32[2], F32, f32[1], block_lanes=128, version=3,
                refine=r)
        return out

    ref = jax.jit(run)(*map(jnp.asarray, (f, ud, lk)))
    return (tm, _port_inputs(tm, f, ud, lk), ref,
            (tm32, _port_inputs(tm32, f, ud, lk, torch.float32)))


@pytest.fixture(scope="module")
def xla_refs():
    """f64 XLA references at the sizes of tests/test_fused_grad.py (13
    elements with nonzero Dirichlet values)."""
    out = {}
    for ne, B, bc in ((30, 16, (0.0, 0.0)), (13, 7, BC), (100, 4, (0.0, 0.0))):
        jm, tm = _meshes(ne, bc)
        f, ud, lk = _data(ne, B, seed=ne, bc=bc)
        loss, grad = _xla_reference(jm)(*map(jnp.asarray, (lk, f, ud)))
        out[ne] = (tm, _port_inputs(tm, f, ud, lk), loss, grad)
    return out


def test_k5a_matches_jax_kernel(jax_kernels):
    tm, (lk, F, ud), ref, _ = jax_kernels
    lp, gk = k5.fused_kappa_mse_step(tm, lk, F, ud)
    assert lp.shape == gk.shape == (7,)
    assert rel_err(lp, ref["k5a"][0]) <= PARITY
    assert rel_err(gk, ref["k5a"][1]) <= PARITY


@pytest.mark.parametrize("case", ["v1", "v2", "v3", "shared", "bf16"])
def test_k7_matches_jax_kernel(jax_kernels, case):
    tm, (lk, F, ud), ref, _ = jax_kernels
    kw = {"v1": dict(version=1, refine=2), "v2": dict(version=2),
          "v3": dict(version=3, refine=2), "shared": {},
          "bf16": dict(operand_dtype=torch.bfloat16)}[case]
    Fx = F[0] if case in ("shared", "bf16") else F
    lp, gk = k7.fused_kappa_mse_step_mxu(tm, lk, Fx, ud, **kw)
    assert lp.dtype == gk.dtype == torch.float64
    assert rel_err(lp, ref[case][0]) <= K7_JAX_KERNEL
    assert rel_err(gk, ref[case][1]) <= K7_JAX_KERNEL


@pytest.mark.parametrize("refine", [2, 3])
def test_k7_v3_f32_matches_jax_kernel(jax_kernels, refine):
    """f32 version 3 against the JAX kernel's f32 version 3, at the JAX
    tests' kernel-against-kernel tolerance: the port forms each refinement
    residual in float64, the JAX body in float32, and the two agree to
    within float32 rounding."""
    _, _, ref, (tm, (lk, F, ud)) = jax_kernels
    lp, gk = k7.fused_kappa_mse_step_mxu(tm, lk, F, ud, version=3,
                                         refine=refine)
    assert lp.dtype == gk.dtype == torch.float32
    assert rel_err(lp, ref[f"v3_f32_r{refine}"][0]) < 1e-4
    assert rel_err(gk, ref[f"v3_f32_r{refine}"][1]) < 1e-4


@pytest.mark.parametrize("step", ["k5a", "k7v1", "k7v2", "k7v3"])
@pytest.mark.parametrize("ne", [30, 13, 100])
def test_matches_xla_f64(xla_refs, ne, step):
    """Loss and gradient against autograd through the JAX tridiag route in
    f64 (13 elements: nonzero Dirichlet values)."""
    tm, (lk, F, ud), loss, grad = xla_refs[ne]
    if step == "k5a":
        lp, gk = k5.fused_kappa_mse_step(tm, lk, F, ud)
    else:
        lp, gk = k7.fused_kappa_mse_step_mxu(tm, lk, F, ud,
                                             version=int(step[-1]))
    B, n = ud.shape
    assert rel_err(lp.sum() / (B * n), loss) <= PARITY
    assert rel_err(gk, grad) <= PARITY


def _f32_case(B=16, seed=1):
    """f32 meshes, forcing, observations of κ_true = 1 + 2·U(0, 1) (the
    port's tridiag solve), log κ and κ_true, as tests/test_fused_grad.py
    builds them."""
    jm, tm = _meshes(30, dtype=torch.float32)
    rng = np.random.default_rng(seed)
    k_true = 1.0 + 2.0 * rng.random(B)
    _, ud = production.production_data(
        tm, torch.tensor(k_true, dtype=torch.float32))
    f = np.broadcast_to(np.sin(np.pi * np.linspace(0.0, 1.0, 31)) + 1.0,
                        (B, 31))
    return jm, tm, f, ud.numpy(), 0.3 * rng.standard_normal(B), k_true


def test_f32_against_xla_and_bf16_storage():
    """f32, tests/test_fused_grad.py's tolerances: both steps against the
    XLA path; bf16-stored u_data against the XLA path fed the same
    quantized data; bf16 storage equals the f32 step on the quantized
    data bit for bit."""
    jm, tm, f, u, lk, _ = _f32_case()
    ref = _xla_reference(jm)
    args = [jnp.asarray(a, jnp.float32) for a in (lk, f, u)]
    loss, grad = ref(*args)
    lk_t, F, ud = _port_inputs(tm, f, u, lk, torch.float32)
    for step, gtol in ((k5.fused_kappa_mse_step, 1e-3),
                       (k7.fused_kappa_mse_step_mxu, 2e-3)):
        lp, gk = step(tm, lk_t, F, ud)
        np.testing.assert_allclose(float(lp.sum() / ud.numel()),
                                   float(loss), rtol=1e-3)
        np.testing.assert_allclose(gk.numpy(), np.asarray(grad),
                                   rtol=gtol, atol=1e-8)
    udq = ud.to(torch.bfloat16)
    loss_q, grad_q = ref(args[0], args[1], jnp.asarray(udq.float().numpy()))
    lp, gk = k7.fused_kappa_mse_step_mxu(tm, lk_t, F[0], ud,
                                         operand_dtype=torch.bfloat16)
    np.testing.assert_allclose(float(lp.sum() / ud.numel()), float(loss_q),
                               rtol=1e-3)
    np.testing.assert_allclose(gk.numpy(), np.asarray(grad_q), rtol=1e-3,
                               atol=1e-8)
    lp2, gk2 = k7.fused_kappa_mse_step_mxu(tm, lk_t, F[0], udq.float())
    assert torch.equal(lp, lp2) and torch.equal(gk, gk2)
    assert rel_err(gk, grad) < 2e-3     # the data quantization stays small


@pytest.mark.parametrize("step", ["k5a", "k7"])
def test_shared_f_equals_the_plane(step):
    _, tm, f, u, lk, _ = _f32_case(seed=3)
    lk_t, F, ud = _port_inputs(tm, f, u, lk, torch.float32)
    fn = (k5.fused_kappa_mse_step if step == "k5a"
          else k7.fused_kappa_mse_step_mxu)
    lp_p, gk_p = fn(tm, lk_t, F, ud)
    lp_s, gk_s = fn(tm, lk_t, F[0], ud)
    np.testing.assert_allclose(lp_s.numpy(), lp_p.numpy(), rtol=1e-6)
    np.testing.assert_allclose(gk_s.numpy(), gk_p.numpy(), rtol=1e-6,
                               atol=1e-10)


@pytest.mark.parametrize("version", [2, 3])
def test_k7_version_agrees_with_v1(version):
    mesh = FEMesh.line(30, dtype=torch.float32, device="cpu")
    k = 1.0 + 2.0 * torch.rand(2048, generator=torch.Generator()
                               .manual_seed(0))
    F, ud = production.production_data(mesh, k)
    lk = 0.5 * torch.log(k)
    l1, g1 = k7.fused_kappa_mse_step_mxu(mesh, lk, F[0], ud, version=1)
    l2, g2 = k7.fused_kappa_mse_step_mxu(mesh, lk, F[0], ud,
                                         version=version)
    assert rel_err(g2, g1) < 1e-4 and rel_err(l2, l1) < 1e-4


def test_k7_agrees_with_k5a():
    _, tm, f, u, lk, _ = _f32_case(B=32, seed=5)
    lk_t, F, ud = _port_inputs(tm, f, u, lk, torch.float32)
    lp1, g1 = k5.fused_kappa_mse_step(tm, lk_t, F, ud)
    lp2, g2 = k7.fused_kappa_mse_step_mxu(tm, lk_t, F, ud)
    np.testing.assert_allclose(lp2.numpy(), lp1.numpy(), rtol=1e-3)
    np.testing.assert_allclose(g2.numpy(), g1.numpy(), rtol=2e-3, atol=1e-8)


def test_large_mesh_routes_to_k5a(monkeypatch):
    """Above MXU_MAX_NODES the wrapper hands the step to K5a, as the JAX
    wrapper does (operand_dtype ignored there)."""
    mesh = FEMesh.line(200, dtype=torch.float64, device="cpu")
    assert mesh.n_nodes > k7.MXU_MAX_NODES
    f, ud, lk = _data(200, 4, seed=7)
    lk, F, ud = _port_inputs(mesh, f, ud, lk)
    calls = []
    orig = k5.fused_kappa_mse_step

    def spy(*a, **kw):
        calls.append(kw)
        return orig(*a, **kw)

    monkeypatch.setattr(k5, "fused_kappa_mse_step", spy)
    lp, gk = k7.fused_kappa_mse_step_mxu(mesh, lk, F, ud, version=3,
                                         operand_dtype=torch.bfloat16)
    assert len(calls) == 1
    lp5, gk5 = orig(mesh, lk, F, ud)
    assert torch.equal(lp, lp5) and torch.equal(gk, gk5)


def test_recovery_convergence():
    """150 Adam steps through K5a recover κ (tests/test_fused_grad.py)."""
    _, tm, f, u, _, k_true = _f32_case(B=8, seed=11)
    _, F, ud = _port_inputs(tm, f, u, np.zeros(8), torch.float32)
    lk = torch.zeros(8, requires_grad=True)
    opt = torch.optim.Adam([lk], lr=0.1)
    for _ in range(150):
        _, g = k5.fused_kappa_mse_step(tm, lk.detach(), F, ud)
        lk.grad = g
        opt.step()
    np.testing.assert_allclose(torch.exp(lk.detach()).numpy(), k_true,
                               rtol=2e-3)


def test_production_loop_matches_jax():
    """The production loop at B = 64 for 20 steps, step for step against
    the demo's loop (jit + lax.scan) on the JAX wrapper, same κ_true."""
    B, steps = 64, 20
    k_true = 1.0 + 2.0 * np.random.default_rng(0).random(B)
    jm = jax_mesh(JMesh.line, 30, dtype=jnp.float32)
    mesh = production.production_mesh("cpu")

    def jrun(k):
        x = jm.nodes[:, 0]
        f = jnp.broadcast_to(jnp.sin(jnp.pi * x) + 1.0, (B, jm.n_nodes))
        ud = jsolve_batched(jm, k, f, method="tridiag", kappa_batched=True)
        F = jassemble_load(jm, f)

        def step(lk, _):
            lp, g = jk7.fused_kappa_mse_step_mxu(
                jm, lk, F, ud, scale=2.0 / jm.n_nodes, block_lanes=128)
            return lk - 40.0 * g, lp.mean()
        lk, losses = jax.lax.scan(step, jnp.zeros(B, jnp.float32), None,
                                  length=steps)
        return F, ud, lk, losses

    jF, jud, jlk, jlosses = jax.jit(jrun)(jnp.asarray(k_true, jnp.float32))
    F, ud = production.production_data(
        mesh, torch.tensor(k_true, dtype=torch.float32))
    # the two f32 tridiagonal solves round differently (condition ~ n²)
    assert rel_err(F, jF) <= 1e-6 and rel_err(ud, jud) <= 1e-4
    # the loops run on the same data
    lk, losses = production.sgd_loop(mesh, as_torch(jF), as_torch(jud),
                                     steps)
    assert losses.shape == (steps,)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses),
                               rtol=1e-4)
    assert rel_err(lk, jlk) <= 1e-4


def test_production_loop_recovers_kappa():
    """The demo's 300 steps at B = 64: the loss falls 10³× and more."""
    mesh = production.production_mesh("cpu")
    k_true = 1.0 + 2.0 * torch.rand(64, generator=torch.Generator()
                                    .manual_seed(1))
    F, ud = production.production_data(mesh, k_true)
    lk, losses = production.sgd_loop(mesh, F, ud)
    assert losses.shape == (production.STEPS,)
    assert float(losses[-1]) * 1e3 <= float(losses[0])
    assert float((torch.exp(lk) - k_true).abs().max()) < 0.2


def test_arguments_constants_and_no_launch_on_cpu():
    mesh = FEMesh.line(12, dtype=torch.float64, device="cpu")
    f, ud, lk = _data(12, 5, seed=13)
    lk, F, ud = _port_inputs(mesh, f, ud, lk)
    with pytest.raises(ValueError, match="version"):
        k7.fused_kappa_mse_step_mxu(mesh, lk, F, ud, version=4)
    with pytest.raises(ValueError, match="refine"):
        k7.fused_kappa_mse_step_mxu(mesh, lk, F, ud, version=3, refine=-1)
    with pytest.raises(ValueError, match="block_lanes"):
        k5.fused_kappa_mse_step(mesh, lk, F, ud, block_lanes=0)
    with pytest.raises(ValueError, match="u_data"):
        k5.fused_kappa_mse_step(mesh, lk, F, ud[:, :-1])
    with pytest.raises(ValueError, match="F must be"):
        k7.fused_kappa_mse_step_mxu(mesh, lk, F[:3], ud)
    # the default scale is the mean over the batch: 2 / (B n)
    lp, gk = k5.fused_kappa_mse_step(mesh, lk, F, ud)
    lp2, gk2 = k5.fused_kappa_mse_step(mesh, lk, F, ud, scale=2.0 / ud.numel())
    assert torch.equal(gk, gk2) and torch.equal(lp, lp2)
    # mesh constants are built once per mesh; the outputs hold no graph
    assert k5.scalar_columns(mesh) is k5.scalar_columns(mesh)
    assert k7.mxu_inverse(mesh) is k7.mxu_inverse(mesh)
    before = (dict(k5.launches), dict(k7.launches))
    lp, gk = k7.fused_kappa_mse_step_mxu(mesh, lk.requires_grad_(), F, ud)
    assert not lp.requires_grad and not gk.requires_grad
    assert (k5.launches, k7.launches) == before   # the CPU launches none
