"""K5's routes and K8's bodies, on the CPU.

``fused_grad_kernel.k5_plan(n, dtype)`` picks K5's route: the warp route
(one warp a scenario) up to ``K5_WARP_MAX_ROWS`` nodes, the block route
above.
``ell_kernel.k8_body(n, Dn, B, ptrs)`` picks K8's body: four scenarios a
thread with 16-byte accesses where B % 4 == 0 and every plane starts on a
16-byte boundary, the scalar body otherwise.  The kernels run only on the
card (tests/test_torch_cuda.py); on CPU tensors the wrappers take the
plain versions whatever the plan.  No JAX here.
"""

import numpy as np
import pytest
import torch

from difffe_tpu_torch.mesh import FEMesh
from difffe_tpu_torch.ops.kernels import ell_kernel as k8
from difffe_tpu_torch.ops.kernels import fused_grad_kernel as k5

torch.set_num_threads(1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k5_plan_routes_by_n(dtype):
    for n in (2, 13, 31, 32, 33, 64, 65, 97, k5.K5_WARP_MAX_ROWS):
        assert k5.k5_plan(n, dtype) == "warp"
        assert k5.k5_plan(n, dtype, "block") == "block"
        assert k5.k5_plan(n, dtype, "warp") == "warp"
    for n in (k5.K5_WARP_MAX_ROWS + 1, 257, 2001):
        assert k5.k5_plan(n, dtype) == "block"
        assert k5.k5_plan(n, dtype, "block") == "block"


def test_k5_warp_route_refuses_what_it_cannot_hold():
    with pytest.raises(ValueError, match="warp route holds at most"):
        k5.k5_plan(k5.K5_WARP_MAX_ROWS + 1, torch.float32, "warp")
    with pytest.raises(ValueError, match="'warp' or 'block'"):
        k5.k5_plan(31, torch.float32, "lanes")
    with pytest.raises(TypeError, match="float32 or float64"):
        k5.k5_plan(31, torch.bfloat16)
    with pytest.raises(ValueError, match="n >= 2"):
        k5.k5_plan(1, torch.float64)


@pytest.mark.parametrize("plan", [None, "warp", "block"])
def test_k5_wrappers_take_the_plain_version_on_the_cpu(plan):
    """A plan changes nothing on CPU tensors: both steps give the plain
    version's bits."""
    mesh = FEMesh.line(12, bc_left=0.3, bc_right=-0.2, dtype=torch.float64,
                       device="cpu")
    rng = np.random.default_rng(5)
    B, n = 3, mesh.n_nodes
    lk = torch.as_tensor(0.3 * rng.standard_normal(B))
    ke = torch.as_tensor(1.0 + rng.uniform(size=(B, n - 1)))
    F = torch.as_tensor(rng.uniform(0.5, 1.5, (B, n)))
    ud = torch.as_tensor(rng.standard_normal((B, n)))
    scale = 2.0 / (B * n)
    got = k5.fused_kappa_mse_step(mesh, lk, F, ud, plan=plan)
    want = k5._k5a_plain(lk, F, ud, k5.scalar_columns(mesh), scale)
    got_b = k5.fused_kappa_mse_step_general_pcr(mesh, ke, F, ud, plan=plan)
    cols, inv_h = k5.general_constants(mesh)
    want_b = k5._k5b_plain(ke, F, ud, cols, inv_h, scale)
    for a, b in zip(got + got_b, want + want_b):
        assert torch.equal(a, b)


@pytest.mark.parametrize("B,body", [(4, "vec4"), (256, "vec4"),
                                    (128, "vec4"), (7, "scalar"),
                                    (130, "scalar"), (2, "scalar")])
def test_k8_body_by_batch(B, body):
    assert k8.k8_body(4225, 6, B, (0, 4096, 1 << 20, 16 * 7)) == body
    assert k8.k8_body(4225, 6, B, (0, 4096, 1 << 20, 16 * 7),
                      "scalar") == "scalar"


def test_k8_body_by_alignment_and_size():
    aligned = (0, 16, 32, 4096)
    assert k8.k8_body(100, 6, 256, aligned) == "vec4"
    for off in (4, 8, 12):
        for k in range(4):
            ptrs = tuple(p + off if i == k else p
                         for i, p in enumerate(aligned))
            assert k8.k8_body(100, 6, 256, ptrs) == "scalar"
    # 32-bit indices: fewer than 2^31 values of W (and of v, Dn = 0)
    assert k8.k8_body(2 ** 20, 8, 252, aligned) == "vec4"
    assert k8.k8_body(2 ** 20, 8, 256, aligned) == "scalar"
    assert k8.k8_body(2 ** 23, 0, 252, aligned) == "vec4"
    assert k8.k8_body(2 ** 23, 0, 256, aligned) == "scalar"
    # a plane that starts one value into its storage is off the boundary
    v = torch.empty(10 * 256 + 1)[1:].view(10, 256)
    assert v.is_contiguous() and v.data_ptr() % 16 == 4
    assert k8.k8_body(10, 6, 256, (0, 0, v.data_ptr(), 0)) == "scalar"


def test_k8_forced_bodies_refused_where_they_cannot_run():
    with pytest.raises(ValueError, match="vec4 body takes"):
        k8.k8_body(100, 6, 130, (0, 0, 0, 0), "vec4")
    with pytest.raises(ValueError, match="vec4 body takes"):
        k8.k8_body(100, 6, 256, (0, 8, 0, 0), "vec4")
    with pytest.raises(ValueError, match="'vec4' or 'scalar'"):
        k8.k8_body(100, 6, 256, (0, 0, 0, 0), "float4")


@pytest.mark.parametrize("body", [None, "vec4", "scalar"])
def test_k8_wrapper_takes_the_plain_version_on_the_cpu(body):
    rng = np.random.default_rng(8)
    n, D, B = 40, 5, 8
    nbr = torch.as_tensor(rng.integers(0, n, (n, D)), dtype=torch.int32)
    W = torch.as_tensor(rng.uniform(size=(n, D, B)))
    diag = torch.as_tensor(rng.uniform(size=(n, B)))
    v = torch.as_tensor(rng.standard_normal((n, B)))
    m = torch.as_tensor((rng.uniform(size=n) < 0.3).astype(np.float64))
    assert torch.equal(k8.ell_apply(nbr, W, diag, v, m, body=body),
                       k8.ell_apply_plain(nbr, W, diag, v, m))
