"""K1's and K2's routes, and K1's per-row constants, on the CPU.

``fused_grad_cf_kernel.k1_plan(N)`` gives the lanes a scenario L of K1's
body by row bucket NB.  The kernel takes its per-row constants as
``k1_rows(cols)``, an (NB, 3)
block {h, P, shared u_data}, and derives the node and interior masks
from the row and n; here that block and those masks are held against
``cols`` itself.
``tridiag_kernel.k2_plan(n, dtype, batch)`` picks K2's route: the warp
route up to ``WARP_MAX_ROWS`` rows from ``WARP_MIN_BATCH`` systems on, the
block route otherwise.  The kernels run only on the card
(tests/test_torch_cuda.py); no JAX here.
"""

import numpy as np
import pytest
import torch

from difffe_tpu_torch.mesh import FEMesh
from difffe_tpu_torch.ops.assembly import assemble_load
from difffe_tpu_torch.ops.kernels import fused_grad_cf_kernel as tk
from difffe_tpu_torch.ops.kernels import tridiag_kernel as k2

torch.set_num_threads(1)


@pytest.mark.parametrize("N,nb,L", [(8, 32, 1), (32, 32, 1), (40, 64, 4),
                                    (64, 64, 4), (72, 128, 8),
                                    (128, 128, 8), (136, 256, 16),
                                    (256, 256, 16)])
def test_k1_plan_routes_by_bucket(N, nb, L):
    assert tk.k1_bucket(N) == nb
    assert tk.k1_plan(N) == tk.K1_LANES[nb] == L
    # every lane holds the same whole number of rows, a warp whole
    # scenarios, and bf16 u_data packs in pairs
    assert nb % L == 0 and 32 % L == 0 and (nb // L) % 2 == 0


def test_k1_plan_refuses_what_no_body_takes():
    for N in (0, tk.MAX_ROWS + 1):
        with pytest.raises(ValueError, match="packed rows"):
            tk.k1_plan(N)


@pytest.mark.parametrize("n_el", [2, 9, 30, 63, 128, 255])
@pytest.mark.parametrize("shared", [False, True], ids=["streamed", "shared"])
def test_k1_rows_against_cols(n_el, shared):
    mesh = FEMesh.line(n_el, bc_left=0.3, bc_right=-0.2, dtype=torch.float32,
                       device="cpu")
    n = mesh.n_nodes
    rng = np.random.default_rng(n_el)
    F = assemble_load(mesh, torch.as_tensor(
        rng.uniform(0.5, 1.5, n), dtype=torch.float32))
    B = 3
    ud = torch.as_tensor(rng.standard_normal((B, n)), dtype=torch.float32)
    keT, aux = tk.cf_packed_operands(
        mesh, torch.ones(B, n_el), F, ud[0] if shared else ud)
    cols = aux["cols"]
    N = keT.shape[0]
    rows = tk.k1_rows(cols)
    nb = tk.k1_bucket(N)
    assert rows.shape == (nb, 3) and rows.dtype == torch.float32
    assert rows.is_contiguous()
    assert torch.equal(rows[:N, 0], cols[:, tk._COL_HS])
    assert torch.equal(rows[:N, 1], cols[:, tk._COL_PF])
    assert torch.equal(rows[:N, 2], cols[:, tk._COL_UD])
    assert torch.all(rows[N:] == 0)
    if shared:
        assert torch.equal(rows[:n, 2], ud[0])
    # the masks the kernel derives from the row i and n
    i = torch.arange(N)
    assert torch.equal(cols[:, tk._COL_NM], (i < n).float())
    assert torch.equal(cols[:, tk._COL_IM], ((i >= 1) & (i <= n - 2)).float())
    # the dropped gradient column is h again, and h is 0 from row n - 1 on,
    # which lets the kernel leave rows >= n - 1 out of the interior mask
    assert torch.equal(cols[:, tk._COL_HK], cols[:, tk._COL_HS])
    assert torch.all(rows[n - 1:, 0] == 0)
    assert aux["n"] == n


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k2_plan_routes_by_n_and_dtype(dtype):
    big, small = k2.WARP_MIN_BATCH, k2.WARP_MIN_BATCH - 1
    for n in (1, 2, 31, 32, 33, 129, k2.WARP_MAX_ROWS):
        assert k2.k2_plan(n, dtype, big) == "warp"
        assert k2.k2_plan(n, dtype, 65536) == "warp"
        assert k2.k2_plan(n, dtype, small) == "block"
        assert k2.k2_plan(n, dtype, 1024) == "block"
        assert k2.k2_plan(n, dtype, big, "block") == "block"
        assert k2.k2_plan(n, dtype, 1, "warp") == "warp"
    for n in (k2.WARP_MAX_ROWS + 1, 4097, 8192):
        assert k2.k2_plan(n, dtype, big) == "block"
        assert k2.k2_plan(n, dtype, 1) == "block"


def test_k2_warp_route_refuses_what_it_cannot_hold():
    with pytest.raises(ValueError, match="warp route holds at most"):
        k2.k2_plan(k2.WARP_MAX_ROWS + 1, torch.float32, 65536, "warp")
    with pytest.raises(ValueError, match="'warp' or 'block'"):
        k2.k2_plan(31, torch.float32, 65536, "lanes")
    with pytest.raises(TypeError, match="float32 or float64"):
        k2.k2_plan(31, torch.float16, 65536)
    with pytest.raises(ValueError, match="n >= 1"):
        k2.k2_plan(0, torch.float64, 65536)
