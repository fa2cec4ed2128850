"""Parity of the plain versions of K7's ablations
(``difffe_tpu_torch/probes/k7_ablation.py``, the port of the TPU probe
``scripts/probe_mxu_kernel.py``) with the probe's own kernel bodies.

The probe script is loaded from its path and left as it is.  Its
``make_kernel`` / ``make_kernel_packed`` bodies run under
``pl.pallas_call(interpret=True)`` with ``run_variant``'s BlockSpecs, one
``jax.jit`` per variant, computed once for the module, at a small size:
``FEMesh.line(13)`` (14 nodes, N = 16 rows) staged as the probe's ``main``
stages it, L = 128 lanes, B = 256 scenarios.  The staged operands cross to
the port through ``operands_from_jax``."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from difffe_tpu.mesh import FEMesh as JMesh
from difffe_tpu.ops.assembly import assemble_load as jassemble_load
from difffe_tpu.ops.assembly import assemble_tridiag_1d as jtridiag_1d
from difffe_tpu.ops.tridiag import tridiag_matvec as jmatvec
from difffe_tpu.solver import solve_poisson_batched as jsolve_batched
from difffe_tpu_torch.mesh import FEMesh
from difffe_tpu_torch.ops.kernels import fused_grad_mxu_kernel as k7
from difffe_tpu_torch.ops.kernels.fused_grad_kernel import scalar_columns
from difffe_tpu_torch.probes import k7_ablation as ab
from torch_parity import jax_mesh, rel_err

torch.set_num_threads(1)

PROBE = Path(__file__).resolve().parents[1] / "scripts" / "probe_mxu_kernel.py"
N_ELEM, L, B = 13, 128, 256
# f32 against f32: the probe's bodies sum each product and the row sums in
# XLA's order, the plain versions in PyTorch's (measured at most 6.8e-7,
# B's gradient); the gradient's contraction t0 + T1 u cancels about two
# digits of u's rounding, which other data can bring closer to 1e-5
F32 = 1e-5
# C rounds both operands of each product to bf16 (8 significant bits)
# where XLA:CPU, which ignores precision=, multiplies in f32 (measured
# 2.3e-3 on the loss and 3.2e-3 on the gradient)
BF16 = 1e-2
# tcB rounds both operands of each product to TF32 (11 significant bits)
# where XLA:CPU multiplies in f32: 2^-3 of C's rounding (measured 3.0e-4
# on the loss and 2.9e-4 on the gradient)
TF32 = 2e-3


def _load_probe():
    spec = importlib.util.spec_from_file_location("probe_mxu_kernel", PROBE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stage(probe):
    """``main``'s staging (scripts/probe_mxu_kernel.py:188-256) at
    N_ELEM elements and B scenarios, κ_true and log κ from numpy; the
    JAX part in one jit, the inverse on the host as ``main`` takes it."""
    mesh = jax_mesh(JMesh.line, n_elements=N_ELEM, dtype=jnp.float32)
    n = mesh.n_nodes
    N = probe._round_up(max(n, 16), 16)
    rng = np.random.default_rng(7)
    k_true = jnp.asarray(1.0 + 2.0 * rng.random(B), jnp.float32)
    lk = jnp.asarray(0.3 * rng.standard_normal((1, B)), jnp.float32)

    @jax.jit
    def staged(k_true):
        dtype = jnp.float32
        fv = jnp.sin(jnp.pi * mesh.nodes[:, 0]) + 1.0
        f = jnp.broadcast_to(fv, (B, n))
        u_data = jsolve_batched(mesh, k_true, f, method="tridiag",
                                kappa_batched=True)
        udq = u_data.astype(jnp.bfloat16).astype(jnp.float32)
        d_unit, e_unit = jtridiag_1d(mesh, jnp.ones((), dtype))
        m = mesh.bc_mask
        p = 1.0 - m
        mg = m * mesh.bc_values
        e_elim = p[:-1] * p[1:] * e_unit
        zero1 = jnp.zeros((1,), dtype)
        a0 = jnp.concatenate([zero1, e_elim])
        c0 = jnp.concatenate([e_elim, zero1])
        d0 = p * d_unit
        t0v = p * jmatvec(d_unit, e_unit, mg)
        cols = jnp.zeros((N, 128), dtype)
        cols = cols.at[:, probe._COL_M].set(1.0).at[:n, probe._COL_M].set(m)
        cols = cols.at[:n, probe._COL_P].set(p)
        cols = cols.at[:n, probe._COL_D0].set(d0)
        cols = cols.at[:n, probe._COL_A0].set(a0)
        cols = cols.at[:n, probe._COL_C0].set(c0)
        cols = cols.at[:n, probe._COL_MG].set(mg)
        cols = cols.at[:n, probe._COL_T0].set(t0v)
        cols = cols.at[:n, probe._COL_F].set(jassemble_load(mesh, fv))
        udT = jnp.zeros((N, B), dtype).at[:n].set(udq.T).astype(jnp.bfloat16)
        return cols, m + d0, e_elim, udT

    cols, diag, e_elim, udT = staged(k_true)
    A = (np.diag(np.asarray(diag, np.float64))
         + np.diag(np.asarray(e_elim, np.float64), 1)
         + np.diag(np.asarray(e_elim, np.float64), -1))
    Wfull = np.eye(N, dtype=np.float64)
    Wfull[:n, :n] = np.linalg.inv(A)
    W = jnp.zeros((N, probe._round_up(N, 128)), jnp.float32).at[:, :N].set(
        jnp.asarray(Wfull, jnp.float32))
    pack = max(1, 128 // N)
    Wp = np.zeros((pack * N, pack * N), np.float64)
    for i in range(pack):
        Wp[i * N:(i + 1) * N, i * N:(i + 1) * N] = Wfull
    return dict(n=n, N=N, lk=lk, cols=cols, W=W,
                Wpacked=jnp.asarray(Wp, jnp.float32), udT=udT,
                scale=2.0 / (B * n))


def _p2_outputs(probe, s):
    """Each variant's (loss (B,), grad (B,)) from the probe's bodies in
    interpret mode, with ``run_variant``'s specs (:146-171)."""
    N = s["N"]
    row = pl.BlockSpec((1, L), lambda i: (0, i), memory_space=pltpu.VMEM)
    plane = pl.BlockSpec((N, L), lambda i: (0, i), memory_space=pltpu.VMEM)
    shared = pl.BlockSpec((N, 128), lambda i: (0, 0),
                          memory_space=pltpu.VMEM)
    out = {}
    for v in ("A", "B", "C", "D", "E", "F"):
        if v == "F":
            wop = s["Wpacked"]
            kern = probe.make_kernel_packed(N, s["scale"],
                                            pack=wop.shape[0] // N)
        else:
            wop = s["W"]
            kern = probe.make_kernel(v, N, s["scale"])
        wspec = pl.BlockSpec(wop.shape, lambda i: (0, 0),
                             memory_space=pltpu.VMEM)
        call = jax.jit(pl.pallas_call(
            kern,
            out_shape=(jax.ShapeDtypeStruct((1, B), jnp.float32),
                       jax.ShapeDtypeStruct((1, B), jnp.float32)),
            grid=(B // L,),
            in_specs=[row, plane, shared, wspec],
            out_specs=(row, row),
            interpret=True))
        loss, grad = call(s["lk"], s["udT"], s["cols"], wop)
        out[v] = (np.asarray(loss)[0], np.asarray(grad)[0])
    return out


@pytest.fixture(scope="module")
def p2():
    """(the port's operands, P2's outputs by variant) at the test size."""
    probe = _load_probe()
    s = _stage(probe)
    cols, W, ud, F = ab.operands_from_jax(s["cols"], s["W"], s["Wpacked"],
                                          s["udT"], s["n"])
    lk = torch.from_numpy(np.asarray(s["lk"])[0].copy())
    return (lk, F, ud, cols, W, s["scale"]), _p2_outputs(probe, s)


def _plain(variant, ops):
    lk, F, ud, cols, W, scale = ops
    return ab.plain_step(variant, lk, F, ud, cols, W, scale)


@pytest.mark.parametrize("variant", ["A", "D", "E", "F"])
def test_plain_matches_p2_body_f32(p2, variant):
    ops, ref = p2
    for got, want in zip(_plain(variant, ops), ref[variant]):
        assert got.dtype == torch.float32 and got.shape == (B,)
        assert rel_err(got, want) <= F32


def test_b_plain_matches_p2_body(p2):
    """XLA:CPU ignores ``precision=``, so P2's B computes A's numbers; the
    3xTF32 split products keep about f32 accuracy."""
    ops, ref = p2
    for a, b in zip(ref["B"], ref["A"]):
        np.testing.assert_array_equal(a, b)
    for got, want in zip(_plain("B", ops), ref["B"]):
        assert rel_err(got, want) <= F32


def test_c_plain_is_bf16_and_within_its_tolerance(p2):
    """C's plain version rounds to bf16 where XLA:CPU does not: it differs
    from A by more than f32 rounding, and from P2's C by at most BF16."""
    ops, ref = p2
    for a, b in zip(ref["C"], ref["A"]):
        np.testing.assert_array_equal(a, b)
    plain_a = _plain("A", ops)
    for got, want, a in zip(_plain("C", ops), ref["C"], plain_a):
        assert rel_err(got, want) <= BF16
        assert rel_err(got, a) > 100 * F32


@pytest.mark.parametrize("variant,body", [("tcA", "A"), ("tcF", "F"),
                                          ("tcB", "B"), ("tcC", "C"),
                                          ("tcD", "D"), ("tcE", "E")])
def test_tc_plain_matches_p2_body(p2, variant, body):
    """Each variant of the tc set (K7's "tc" route ablated) against the P2
    body it ablates alike, at that body's tolerance; tcB's one TF32 pass
    at TF32."""
    ops, ref = p2
    tol = {"tcB": TF32, "tcC": BF16}.get(variant, F32)
    for got, want in zip(_plain(variant, ops), ref[body]):
        assert got.dtype == torch.float32 and got.shape == (B,)
        assert rel_err(got, want) <= tol


def test_a_plain_is_k7_version_1(p2):
    ops, _ = p2
    lk, F, ud, cols, W, scale = ops
    for got, want in zip(_plain("A", ops),
                         k7._k7_plain(lk, F, ud, cols, W, scale, 1, 0)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("variant", ["F", "A1"])
def test_plain_equals_a(p2, variant):
    ops, _ = p2
    for got, want in zip(_plain(variant, ops), _plain("A", ops)):
        assert torch.equal(got, want)


def test_d_and_e_change_only_the_gradient(p2):
    """D and E change the adjoint side only: their losses are A's."""
    ops, _ = p2
    loss_a = _plain("A", ops)[0]
    for v in ("D", "E"):
        loss, grad = _plain(v, ops)
        assert torch.equal(loss, loss_a)
        assert rel_err(grad, _plain("A", ops)[1]) > 1e-2


def test_operands_from_jax_match_the_port_mesh(p2):
    """The carried-across block and W are the port's own mesh constants
    (f32 assembly in each framework: a few ulps)."""
    (_, _, ud, cols, W, _), _ = p2
    mesh = FEMesh.line(N_ELEM, dtype=torch.float32, device="cpu")
    assert cols.shape == (8, N_ELEM + 1) and ud.dtype == torch.bfloat16
    assert rel_err(cols, scalar_columns(mesh)) <= 1e-6
    assert rel_err(W, k7.mxu_inverse(mesh)) <= 1e-6


def test_operands_from_jax_rejects_a_wrong_packing(p2):
    s = np.zeros((16, 128), np.float32)
    W = np.eye(16, 128, dtype=np.float32)
    with pytest.raises(ValueError, match="diagonal"):
        ab.operands_from_jax(s, W, np.eye(128, dtype=np.float32) * 2, s, 14)


@pytest.mark.parametrize("variant", ab.VARIANTS)
def test_ablation_step_on_cpu_takes_the_plain_version(variant):
    mesh = FEMesh.line(12, bc_left=0.3, bc_right=-0.2, dtype=torch.float32,
                       device="cpu")
    st = ab.stage(mesh, 64, torch.Generator().manual_seed(3))
    lk = 0.2 * torch.randn(64, generator=torch.Generator().manual_seed(4))
    before = dict(ab.launches), dict(k7.launches)
    got = ab.ablation_step(variant, mesh, lk, st.F, st.u_data, st.scale)
    want = ab.plain_step(variant, lk, st.F, st.u_data, scalar_columns(mesh),
                         k7.mxu_inverse(mesh), st.scale)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert (dict(ab.launches), dict(k7.launches)) == before


def test_ablation_step_rejects_what_it_does_not_take():
    mesh = FEMesh.line(12, dtype=torch.float32, device="cpu")
    args = (torch.zeros(4), torch.ones(13), torch.ones(4, 13), 0.1)
    with pytest.raises(ValueError, match="variant"):
        ab.ablation_step("G", mesh, *args)
    with pytest.raises(ValueError, match="variant"):
        ab.plain_step("a", args[0], args[1], args[2], None, None, 0.1)
    with pytest.raises(ValueError, match="F \\(n,\\)"):
        ab.ablation_step("B", mesh, args[0], torch.ones(4, 13), args[2], 0.1)
    big = FEMesh.line(40, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="at most 32"):
        ab.ablation_step("F", big, args[0], torch.ones(41),
                         torch.ones(4, 41), 0.1)


def test_probe_workload_on_the_cpu():
    """P2's staging and oracle at B = 512: A, B and F pass bench.py's 1e-4
    gradient gate against the PCR oracle on the bf16-quantized data."""
    mesh = FEMesh.line(ab.N_ELEM, dtype=torch.float32, device="cpu")
    st = ab.stage(mesh, 512, torch.Generator().manual_seed(0))
    assert st.u_data.dtype == torch.bfloat16 and st.scale == 2.0 / (512 * 31)
    g_ref = ab.oracle_grad(mesh, st)
    for v in ("A", "A1", "B", "F"):
        assert ab.parity(v, mesh, st, g_ref) <= 1e-4
    assert ab.parity("C", mesh, st, g_ref) > 1e-4
