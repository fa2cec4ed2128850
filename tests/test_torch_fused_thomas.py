"""Parity of the plain versions of the per-element-κ fused grad steps —
kernel K6 (``fused_grad_thomas_kernel.fused_kappa_mse_step_general``,
Thomas) and kernel K5b (``fused_grad_kernel.
fused_kappa_mse_step_general_pcr``, PCR) — with the JAX package, on the
same numpy inputs.  Both run one suite through the ``impl`` parameter, as
tests/test_fused_thomas.py does.

The JAX Pallas kernels run in interpret mode once, at 5 elements (K6's
unrolled Thomas costs the most to trace), in one ``jax.jit``; the larger
meshes are held against the JAX package's XLA path, ``jax.value_and_grad``
through ``solve_poisson_batched(method="tridiag")``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from difffe_tpu.mesh import FEMesh as JMesh
from difffe_tpu.ops.assembly import assemble_load as jassemble_load
from difffe_tpu.ops.pallas import fused_grad_kernel as jk5
from difffe_tpu.ops.pallas import fused_grad_thomas_kernel as jk6
from difffe_tpu.solver import solve_poisson_batched as jsolve_batched
from difffe_tpu_torch.mesh import FEMesh
from difffe_tpu_torch.ops.assembly import assemble_load
from difffe_tpu_torch.ops.kernels import fused_grad_kernel as k5
from difffe_tpu_torch.ops.kernels import fused_grad_thomas_kernel as k6
from difffe_tpu_torch.solver import solve_poisson_batched
from torch_parity import jax_mesh, rel_err

torch.set_num_threads(1)

PARITY = 1e-10      # f64 port against f64 JAX
BC = (0.7, -0.4)    # nonzero Dirichlet values
LR_RECOVERY = 1e3     # 2e3 diverges at this mesh
IMPLS = {"thomas": k6.fused_kappa_mse_step_general,
         "pcr": k5.fused_kappa_mse_step_general_pcr}


@pytest.fixture(params=sorted(IMPLS))
def impl(request):
    return request.param


def _data(ne, B, seed):
    """Per-element κ (B, ne), forcing f (B, n) and observations (B, n),
    numpy f64 (random forcing and observations, as the JAX suite's
    nonzero-Dirichlet case)."""
    rng = np.random.default_rng(seed)
    return (1.0 + rng.random((B, ne)), rng.standard_normal((B, ne + 1)),
            rng.standard_normal((B, ne + 1)))


def _meshes(ne, bc=(0.0, 0.0), dtype=torch.float64):
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    return (jax_mesh(JMesh.line, ne, bc_left=bc[0], bc_right=bc[1],
                     dtype=jdt),
            FEMesh.line(ne, bc_left=bc[0], bc_right=bc[1], dtype=dtype,
                        device="cpu"))


def _port(tm, ke, f, ud, dtype=torch.float64):
    return (torch.tensor(ke, dtype=dtype),
            assemble_load(tm, torch.tensor(f, dtype=dtype)),
            torch.tensor(ud, dtype=dtype))


def _xla_reference(jm):
    """(mean loss, ∂/∂κ_e) through the JAX tridiag route, jitted."""
    def loss(ke, f, ud):
        u = jsolve_batched(jm, ke, f, method="tridiag")
        return jnp.mean((u - ud) ** 2)
    return jax.jit(jax.value_and_grad(loss))


@pytest.fixture(scope="module")
def jax_kernels():
    """K6 and K5b (streamed and shared F, bf16 storage) of the JAX
    package in interpret mode, f64, 5 elements, nonzero Dirichlet, B = 7."""
    jm, tm = _meshes(5, BC)
    ke, f, ud = _data(5, 7, seed=0)

    def run(ke, f, ud):
        F = jassemble_load(jm, f)
        gen = jk5.fused_kappa_mse_step_general_pcr
        return {"thomas": jk6.fused_kappa_mse_step_general(
                    jm, ke, F, ud, block_lanes=128),
                "pcr": gen(jm, ke, F, ud, block_lanes=128),
                "shared": gen(jm, ke, F[0], ud, block_lanes=128),
                "bf16": gen(jm, ke, F, ud, block_lanes=128,
                            operand_dtype=jnp.bfloat16)}

    ref = jax.jit(run)(*map(jnp.asarray, (ke, f, ud)))
    return tm, _port(tm, ke, f, ud), ref


@pytest.fixture(scope="module")
def xla_refs():
    """f64 XLA references at the sizes of tests/test_fused_thomas.py (13
    elements with nonzero Dirichlet values)."""
    out = {}
    for ne, B, bc in ((30, 16, (0.0, 0.0)), (13, 7, BC), (100, 4, (0.0, 0.0))):
        jm, tm = _meshes(ne, bc)
        ke, f, ud = _data(ne, B, seed=ne)
        loss, grad = _xla_reference(jm)(*map(jnp.asarray, (ke, f, ud)))
        out[ne] = (tm, _port(tm, ke, f, ud), loss, grad)
    return out


def test_matches_jax_kernel(jax_kernels, impl):
    tm, (ke, F, ud), ref = jax_kernels
    lp, gk = IMPLS[impl](tm, ke, F, ud)
    assert lp.shape == (7,) and gk.shape == (7, 5)
    assert rel_err(lp, ref[impl][0]) <= PARITY
    assert rel_err(gk, ref[impl][1]) <= PARITY


@pytest.mark.parametrize("case", ["shared", "bf16"])
def test_shared_f_and_bf16_match_jax_kernel(jax_kernels, case):
    """Shared F (read in place) and bf16 storage of the streamed planes:
    both packages quantize the same f64 data the same way."""
    tm, (ke, F, ud), ref = jax_kernels
    for fn in IMPLS.values():
        if case == "shared":
            lp, gk = fn(tm, ke, F[0], ud)
        else:
            lp, gk = fn(tm, ke, F, ud, operand_dtype=torch.bfloat16)
        assert rel_err(lp, ref[case][0]) <= PARITY
        assert rel_err(gk, ref[case][1]) <= PARITY


@pytest.mark.parametrize("ne", [30, 13, 100])
def test_matches_xla_f64(xla_refs, impl, ne):
    tm, (ke, F, ud), loss, grad = xla_refs[ne]
    lp, gk = IMPLS[impl](tm, ke, F, ud)
    B, n = ud.shape
    assert gk.shape == (B, ne)
    assert rel_err(lp.sum() / (B * n), loss) <= PARITY
    assert rel_err(gk, grad) <= PARITY


@pytest.fixture(scope="module")
def xla_f32():
    """An f32 XLA reference at 24 elements with nonzero Dirichlet values."""
    jm, tm = _meshes(24, BC, dtype=torch.float32)
    ke, f, ud = _data(24, 5, seed=3)
    loss, grad = _xla_reference(jm)(
        *(jnp.asarray(a, jnp.float32) for a in (ke, f, ud)))
    return tm, (ke, f, ud), loss, grad


def test_f32_against_xla(xla_f32, impl):
    """f32 at tests/test_fused_thomas.py's tolerances, nonzero Dirichlet."""
    tm, (ke, f, ud), loss, grad = xla_f32
    lp, gk = IMPLS[impl](tm, *_port(tm, ke, f, ud, torch.float32))
    np.testing.assert_allclose(float(lp.sum() / ud.size), float(loss),
                               rtol=1e-3)
    np.testing.assert_allclose(gk.numpy(), np.asarray(grad), rtol=1e-3,
                               atol=1e-7)


def test_bf16_storage_is_the_quantized_data(impl):
    """bf16 storage equals the f32 step fed the bf16-quantized F and
    u_data bit for bit, and stays in the bf16 class of the f32 step."""
    tm = FEMesh.line(30, dtype=torch.float32, device="cpu")
    ke, F, ud = _port(tm, *_data(30, 8, seed=6), dtype=torch.float32)
    fn = IMPLS[impl]
    lp16, gk16 = fn(tm, ke, F, ud, operand_dtype=torch.bfloat16)
    lpq, gkq = fn(tm, ke, F.bfloat16().float(), ud.bfloat16().float())
    assert torch.equal(lp16, lpq) and torch.equal(gk16, gkq)
    _, gk32 = fn(tm, ke, F, ud)
    assert rel_err(gk16, gk32) < 3e-2


def test_scalar_kappa_consistency_with_k5a(impl):
    """A constant per-element field gives K5a's answer (chain rule:
    ∂log κ = κ · Σ_e ∂κ_e)."""
    tm = FEMesh.line(30, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(9)
    log_k = torch.tensor(0.2 * rng.standard_normal(8), dtype=torch.float32)
    F = assemble_load(tm, torch.ones(8, 31))
    ud = torch.tensor(rng.standard_normal((8, 31)), dtype=torch.float32)
    lp_s, gk_s = k5.fused_kappa_mse_step(tm, log_k, F, ud)
    ke = torch.exp(log_k)[:, None].expand(8, 30)
    lp_g, gk_g = IMPLS[impl](tm, ke, F, ud)
    np.testing.assert_allclose(lp_g.numpy(), lp_s.numpy(), rtol=1e-4)
    np.testing.assert_allclose((torch.exp(log_k) * gk_g.sum(1)).numpy(),
                               gk_s.numpy(), rtol=1e-3, atol=1e-7)


def test_shared_f_matches_per_scenario(impl):
    tm = FEMesh.line(30, dtype=torch.float32, device="cpu")
    ke, _, ud = _port(tm, *_data(30, 8, seed=11), dtype=torch.float32)
    F1 = assemble_load(tm, torch.sin(torch.pi * tm.nodes[:, 0]) + 1.0)
    lp_s, gk_s = IMPLS[impl](tm, ke, F1, ud)
    lp_b, gk_b = IMPLS[impl](tm, ke, F1.expand(8, 31), ud)
    np.testing.assert_allclose(lp_s.numpy(), lp_b.numpy(), rtol=1e-6)
    np.testing.assert_allclose(gk_s.numpy(), gk_b.numpy(), rtol=1e-5,
                               atol=1e-9)


def test_thomas_and_pcr_agree_f64():
    tm = FEMesh.line(40, bc_left=0.5, bc_right=None, dtype=torch.float64,
                     device="cpu")
    ke, F, ud = _port(tm, *_data(40, 6, seed=12))
    for a, b in zip(IMPLS["thomas"](tm, ke, F, ud),
                    IMPLS["pcr"](tm, ke, F, ud)):
        assert rel_err(a, b) <= PARITY


def test_short_recovery(impl):
    """SGD on per-element κ through the step lowers each scenario's misfit
    of observations made at κ_true 10× and more in 60 steps."""
    tm = FEMesh.line(12, dtype=torch.float64, device="cpu")
    k_true = torch.tensor(1.0 + np.random.default_rng(14).random((4, 12)))
    f = (torch.sin(torch.pi * tm.nodes[:, 0]) + 1.0).expand(4, 13)
    u_data = solve_poisson_batched(tm, k_true, f, method="tridiag")
    F = assemble_load(tm, f)
    ke = torch.full((4, 12), 1.5, dtype=torch.float64)
    first, _ = IMPLS[impl](tm, ke, F, u_data, scale=2.0 / 13)
    for _ in range(60):
        lp, gk = IMPLS[impl](tm, ke, F, u_data, scale=2.0 / 13)
        ke = ke - LR_RECOVERY * gk
    assert bool(torch.all(lp * 10 <= first))


def test_arguments_and_no_launch_on_cpu(impl):
    tm = FEMesh.line(8, dtype=torch.float32, device="cpu")
    nodes = tm.nodes.clone()
    nodes[3, 0] += 0.02
    bad = dataclasses.replace(tm, nodes=nodes)
    with pytest.raises(ValueError, match="uniform"):
        IMPLS[impl](bad, torch.ones(2, 8), torch.ones(9),
                    torch.ones(2, 9))
    with pytest.raises(ValueError, match="n_elements"):
        IMPLS[impl](tm, torch.ones(2, 9), torch.ones(9), torch.ones(2, 9))
    with pytest.raises(ValueError, match="block_lanes"):
        IMPLS[impl](tm, torch.ones(2, 8), torch.ones(9), torch.ones(2, 9),
                    block_lanes=0)
    before = (dict(k5.launches), dict(k6.launches))
    ke = torch.ones(2, 8, requires_grad=True)
    lp, gk = IMPLS[impl](tm, ke, torch.ones(9), torch.ones(2, 9))
    assert not lp.requires_grad and not gk.requires_grad
    assert (k5.launches, k6.launches) == before   # the CPU launches none
