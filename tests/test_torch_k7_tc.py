"""K7's routes and its "tc" route's plain version, on the CPU.

``fused_grad_mxu_kernel.k7_plan`` picks K7's route from the dtype and n:
"tc" (tensor-core products, float32, n ≤ 32), "fma" (the first design:
float64, and 32 < n ≤ 136) or "k5a" above.  The card holds the "tc"
route against ``_k7_plain`` with its products' operands rounded as the
tensor cores take them (``products="tf32x3"`` for versions 1-2, "bf16"
for version 3; "tf32", one TF32 pass, emulates version 3's measured
alternative, which no kernel runs); here those plain versions are held
against the exact one.  No JAX, no card.
"""

import numpy as np
import pytest
import torch

from difffe_tpu_torch.mesh import FEMesh
from difffe_tpu_torch.ops.assembly import assemble_load
from difffe_tpu_torch.ops.kernels import fused_grad_kernel as k5
from difffe_tpu_torch.ops.kernels import fused_grad_mxu_kernel as k7
from difffe_tpu_torch.ops.kernels.fused_grad_kernel import scalar_columns
from difffe_tpu_torch.ops.tridiag import _shift_down, _shift_up
from difffe_tpu_torch.solver import solve_poisson_batched
from torch_parity import rel_err

torch.set_num_threads(1)

B = 64
BODIES = [(1, 0), (2, 0), (3, 0), (3, 1), (3, 2), (3, 3)]


def _case(n, bc=(0.3, -0.2), seed=0):
    """The f32 mesh's (8, n) block and W, and f32 operands from a seed: log
    κ, a streamed F of a perturbed sin(πx) + 1 and observations of a
    random per-element κ field."""
    rng = np.random.default_rng(seed + n)
    m64 = FEMesh.line(n - 1, bc_left=bc[0], bc_right=bc[1],
                      dtype=torch.float64, device="cpu")
    m32 = FEMesh.line(n - 1, bc_left=bc[0], bc_right=bc[1],
                      dtype=torch.float32, device="cpu")
    x = m64.nodes[:, 0].numpy()
    f = torch.tensor((np.sin(np.pi * x) + 1.0)
                     * (1.0 + 0.2 * rng.random((B, 1))))
    ud = solve_poisson_batched(m64, torch.tensor(1.0 + rng.random((B, n - 1))),
                               f, method="tridiag")
    lk = torch.tensor(0.3 * rng.standard_normal(B))
    F = assemble_load(m64, f)
    return (m32, scalar_columns(m32), k7.mxu_inverse(m32), lk.float(),
            F.float(), ud.float())


@pytest.mark.parametrize("dtype,n,want", [
    (torch.float32, 2, "tc"), (torch.float32, 31, "tc"),
    (torch.float32, 32, "tc"), (torch.float32, 33, "fma"),
    (torch.float32, 136, "fma"), (torch.float32, 137, "k5a"),
    (torch.float64, 13, "fma"), (torch.float64, 31, "fma"),
    (torch.float64, 136, "fma"), (torch.float64, 137, "k5a")],
    ids=lambda v: str(v).replace("torch.", ""))
def test_plan_routes(dtype, n, want):
    for version in (1, 2, 3):
        assert k7.k7_plan(dtype, n, version) == want


def test_plan_and_wrapper_refuse_what_they_do_not_take():
    with pytest.raises(ValueError, match="version"):
        k7.k7_plan(torch.float32, 31, 4)
    m32, _, _, lk, F, ud = _case(13)
    with pytest.raises(ValueError, match="plan"):
        k7.fused_kappa_mse_step_mxu(m32, lk, F, ud, plan="mma")
    with pytest.raises(ValueError, match="products"):
        k7._k7_plain(lk, F, ud, scalar_columns(m32), k7.mxu_inverse(m32),
                     0.1, 2, 0, products="fp8")


def test_cpu_takes_the_exact_plain_version_whatever_the_plan():
    """A forced plan and ``block_lanes`` change nothing on the CPU, and
    n = 137 goes to K5a's plain version."""
    m32, cols, W, lk, F, ud = _case(31)
    want = k7._k7_plain(lk, F, ud, cols, W, 2.0 / (B * 31), 3, 2)
    before = dict(k7.launches), dict(k5.launches)
    for plan in (None, "tc", "fma"):
        for lanes in (7, 1024):
            got = k7.fused_kappa_mse_step_mxu(m32, lk, F, ud, version=3,
                                              refine=2, plan=plan,
                                              block_lanes=lanes)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
    big, _, _, lk1, F1, ud1 = _case(137)
    got = k7.fused_kappa_mse_step_mxu(big, lk1, F1, ud1, plan="tc")
    ref = k5.fused_kappa_mse_step(big, lk1, F1, ud1, scale=2.0 / (B * 137))
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert (dict(k7.launches), dict(k5.launches)) == before


@pytest.mark.parametrize("version,refine", BODIES)
def test_exact_products_are_the_default_and_unchanged(version, refine):
    """``products="exact"`` is the default, and it is W y with torch's
    matmul: the solve restated here gives the same bits."""
    m32, cols, W, lk, F, ud = _case(13)
    scale = 2.0 / (B * 13)
    got = k7._k7_plain(lk, F, ud, cols, W, scale, version, refine)
    assert all(torch.equal(a, b) for a, b in zip(
        got, k7._k7_plain(lk, F, ud, cols, W, scale, version, refine,
                          products="exact")))
    if version == 1:
        return
    m, p, d0, a0, c0, _, _, rhs0 = cols
    kinv = 1.0 / torch.exp(lk)[:, None]

    def solve(y):
        u = y @ W.T
        for _ in range(refine if version == 3 else 0):
            u64 = u.double()
            t1 = ((m + d0).double() * u64
                  + a0.double() * _shift_up(u64, 1, 0.0)
                  + c0.double() * _shift_down(u64, 1, 0.0))
            u = u + (y.double() - t1).float() @ W.T
        return u

    pf = p * F
    diff = solve(rhs0 + kinv * pf) - ud
    lam = solve((m + p * kinv) * diff)
    assert torch.equal(got[0], (diff * diff).sum(-1))
    assert torch.equal(got[1], -scale * (lam * pf).sum(-1))


def test_rounding_helpers():
    """cvt.rna.tf32: to nearest, ties away from zero, 13 low bits cleared;
    the 3xTF32 split keeps x to 2^-21; bf16 to nearest even."""
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -12,
                      -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12])
    assert torch.equal(k7._tf32(x), torch.tensor(
        [1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0]))
    y = torch.randn(1000, generator=torch.Generator().manual_seed(1))
    hi, lo = k7._split(y)
    assert torch.equal(k7._tf32(hi), hi) and torch.equal(k7._tf32(lo), lo)
    assert float(((hi + lo - y) / y).abs().max()) <= 2.0 ** -21
    assert torch.equal(k7._bf16(y), y.bfloat16().float())


# 3xTF32 keeps ~21 bits of each operand (lo·lo dropped): a step within a few
# f32 roundings of the exact one (measured ≤ 1.1e-6 on these cases).
TF32X3_TOL = 4e-6
# one bf16 or TF32 pass rounds each operand to 8 or 11 bits, which the
# system's conditioning amplifies: measured ≤ 5.1e-3 (bf16), 8.1e-4 (TF32)
ONE_PASS_TOL = {"bf16": 1e-2, "tf32": 2e-3}
# version 3's refinement: each pass shrinks the error at least 4x while it
# is above 1e-6, and 3 passes bring bf16 products under 1e-5 (the card's
# oracle gate is 1e-4); measured 1.2e-6 at n = 31
REFINED_TOL = 1e-5


@pytest.mark.parametrize("bc", [(0.0, 0.0), (0.3, -0.2)], ids=["g0", "g"])
@pytest.mark.parametrize("n", [13, 31])
def test_tensor_core_products_against_exact(n, bc):
    m32, cols, W, lk, F, ud = _case(n, bc)
    scale = 2.0 / (B * n)
    errs = {}
    for version, refine in BODIES:
        exact = k7._k7_plain(lk, F, ud, cols, W, scale, version, refine)
        for products in ("tf32x3", "tf32", "bf16"):
            got = k7._k7_plain(lk, F, ud, cols, W, scale, version, refine,
                               products)
            errs[products, version, refine] = e = max(
                rel_err(a, b) for a, b in zip(got, exact))
            if products == "tf32x3":
                assert e <= TF32X3_TOL, (version, refine, e)
            elif refine == 0:
                assert e <= ONE_PASS_TOL[products], (products, version, e)
    for products in ("tf32", "bf16"):
        for r in range(3):
            a, b = errs[products, 3, r], errs[products, 3, r + 1]
            assert b <= max(a / 4.0, 1e-6), (products, r, a, b)
        assert errs[products, 3, 3] <= REFINED_TOL
