"""K6's routes and the tc set of K7's ablation probe, on the CPU.

``fused_grad_thomas_kernel.k6_plan(n, dtype)`` picks K6's route: the reg
route (a float32 scenario's rows in registers) up to ``K6_REG_MAX_NODES``
nodes, the block route (the first design) otherwise.  The tc set of
``probes/k7_ablation.py`` ablates K7's "tc" route; each variant's plain
version is its math with the products rounded as its tensor cores take
them.  The kernels run only on the card (tests/test_torch_cuda.py); on
CPU tensors the wrappers take the plain versions whatever the plan.  No
JAX here.
"""

import numpy as np
import pytest
import torch

from difffe_tpu_torch.mesh import FEMesh
from difffe_tpu_torch.ops.kernels import fused_grad_kernel as k5
from difffe_tpu_torch.ops.kernels import fused_grad_mxu_kernel as k7
from difffe_tpu_torch.ops.kernels import fused_grad_thomas_kernel as k6
from difffe_tpu_torch.probes import k7_ablation as ab

torch.set_num_threads(1)


def test_k6_plan_routes_by_n_and_dtype():
    for n in (2, 13, 31, k6.K6_REG_MAX_NODES):
        assert k6.k6_plan(n, torch.float32) == "reg"
        assert k6.k6_plan(n, torch.float32, "reg") == "reg"
        assert k6.k6_plan(n, torch.float32, "block") == "block"
        assert k6.k6_plan(n, torch.float64) == "block"
    for n in (k6.K6_REG_MAX_NODES + 1, 64, 2001):
        assert k6.k6_plan(n, torch.float32) == "block"
        assert k6.k6_plan(n, torch.float32, "block") == "block"


def test_k6_forced_routes_refused_where_they_cannot_run():
    with pytest.raises(ValueError, match="reg route takes float32"):
        k6.k6_plan(k6.K6_REG_MAX_NODES + 1, torch.float32, "reg")
    with pytest.raises(ValueError, match="reg route takes float32"):
        k6.k6_plan(13, torch.float64, "reg")
    with pytest.raises(ValueError, match="'reg' or 'block'"):
        k6.k6_plan(31, torch.float32, "warp")
    with pytest.raises(TypeError, match="float32 or float64"):
        k6.k6_plan(31, torch.bfloat16)
    with pytest.raises(ValueError, match="n >= 2"):
        k6.k6_plan(1, torch.float32)


@pytest.mark.parametrize("plan", [None, "reg", "block"])
def test_k6_wrapper_takes_the_plain_version_on_the_cpu(plan):
    """A plan changes nothing on CPU tensors: the plain version's bits, no
    launch counted."""
    mesh = FEMesh.line(12, bc_left=0.3, bc_right=None, dtype=torch.float32,
                       device="cpu")
    rng = np.random.default_rng(6)
    B, n = 5, mesh.n_nodes
    f32 = dict(dtype=torch.float32)
    ke = torch.as_tensor(1.0 + rng.uniform(size=(B, n - 1)), **f32)
    F = torch.as_tensor(rng.uniform(0.5, 1.5, n), **f32)
    ud = torch.as_tensor(rng.standard_normal((B, n)), **f32)
    before = dict(k6.route_launches), dict(k6.launches)
    got = k6.fused_kappa_mse_step_general(mesh, ke, F, ud, plan=plan)
    cols, inv_h = k5.general_constants(mesh)
    want = k6._k6_plain(ke, F, ud, cols, inv_h, 2.0 / (B * n))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert (dict(k6.route_launches), dict(k6.launches)) == before


def test_tc_set_registry():
    assert ab.TC_VARIANTS == ("tcA", "tcB", "tcC", "tcD", "tcE", "tcF")
    assert ab.ALL_VARIANTS == ab.VARIANTS + ab.TC_VARIANTS
    assert {v: ab.math_and_products(v) for v in ab.TC_VARIANTS} == {
        "tcA": ("A", "tf32x3"), "tcB": ("A", "tf32"), "tcC": ("A", "bf16"),
        "tcD": ("D", "tf32x3"), "tcE": ("E", "tf32x3"),
        "tcF": ("A", "tf32x3")}
    assert ab.math_and_products("B") == ("B", "tf32x3")
    assert ab.math_and_products("C") == ("C", "bf16")
    assert ab.math_and_products("A1") == ("A1", "exact")
    # tcA is K7's own launch, counted there; the others are the probe's
    assert set(ab.launches) == set(ab.ALL_VARIANTS) - {"A", "tcA"}
    assert sorted(ab._CODES.values()) == list(range(1, 12))
    for p in {p for _, p in ab.TC_SET.values()}:
        assert p in k7.PRODUCTS
    with pytest.raises(ValueError, match="variant must be one of"):
        ab.math_and_products("tcG")


def test_tc_rule_slack():
    n = 31
    assert ab.rule_slack("tcB", n) == 1e-6 + 2.0 ** -11 / n
    for v in ("tcC", "C"):
        assert ab.rule_slack(v, n) == 1e-6 + 2.0 ** -8 / n
    for v in ("tcA", "tcD", "tcE", "tcF", "A", "B", "D"):
        assert ab.rule_slack(v, n) == 1e-6


@pytest.fixture(scope="module")
def staged():
    mesh = FEMesh.line(12, bc_left=0.3, bc_right=-0.2, dtype=torch.float32,
                       device="cpu")
    st = ab.stage(mesh, 64, torch.Generator().manual_seed(3))
    lk = 0.2 * torch.randn(64, generator=torch.Generator().manual_seed(4))
    cols, W = k5.scalar_columns(mesh), k7.mxu_inverse(mesh)
    return mesh, st, lk, cols, W


def _plain(v, staged):
    _, st, lk, cols, W = staged
    return ab.plain_step(v, lk, st.F, st.u_data, cols, W, st.scale)


def test_tc_plain_versions_are_k7_with_their_products(staged):
    """tcA and tcF are K7's plain version with 3xTF32 products, tcB and
    tcC with one TF32 or bf16 pass."""
    _, st, lk, cols, W = staged
    for v, products in (("tcA", "tf32x3"), ("tcF", "tf32x3"),
                        ("tcB", "tf32"), ("tcC", "bf16")):
        want = k7._k7_plain(lk, st.F, st.u_data, cols, W, st.scale, 1, 0,
                            products)
        for a, b in zip(_plain(v, staged), want):
            assert torch.equal(a, b), v


def test_tc_d_and_e_are_d_and_e_under_tca_rounding(staged):
    """tcD and tcE keep tcA's forward solve (its loss, bit for bit) and
    change the adjoint side as D and E do: their gradients are D's and E's
    up to the 3xTF32 rounding of u (f32 accuracy)."""
    loss_a = _plain("tcA", staged)[0]
    for v, p2 in (("tcD", "D"), ("tcE", "E")):
        loss, grad = _plain(v, staged)
        assert torch.equal(loss, loss_a)
        ref = _plain(p2, staged)[1]
        assert float((grad - ref).abs().max() / ref.abs().max()) <= 1e-5
        assert not torch.equal(grad, _plain("tcA", staged)[1])


@pytest.mark.parametrize("variant", ab.TC_VARIANTS)
def test_tc_ablation_step_on_cpu_takes_the_plain_version(staged, variant):
    mesh, st, lk, cols, W = staged
    before = dict(ab.launches), dict(k7.launches)
    got = ab.ablation_step(variant, mesh, lk, st.F, st.u_data, st.scale)
    for a, b in zip(got, _plain(variant, staged)):
        assert torch.equal(a, b)
    assert (dict(ab.launches), dict(k7.launches)) == before
