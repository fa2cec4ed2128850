"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA card and skips without one.  The file imports
no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import pytest
import torch

from difffe_tpu_torch.inverse import fit_kappa
from difffe_tpu_torch.mesh import FEMesh
from difffe_tpu_torch.ops.assembly import assemble_load
from difffe_tpu_torch.ops.kernels import fused_grad_cf_kernel as tk
from difffe_tpu_torch.solver import solve_poisson_batched
from difffe_tpu_torch.utils.profiling import timeit_chained
from torch_parity import rel_err

pytestmark = pytest.mark.cuda

STEP_TOL = 1e-5     # f32 running sums vs torch.cumsum, one step
CHAIN_TOL = 1e-4    # the same over a 32-step chain


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the K1 kernel has no CPU mode")
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
