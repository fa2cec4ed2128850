"""Kernel K1 of the PyTorch port (ops/kernels/fused_grad_cf_kernel.py).

On the CPU the wrappers run the plain PyTorch versions; these are held
against the JAX Pallas kernels run as the JAX package's own tests run them
(interpret mode).  With ``cumsum_via="vpu"`` both sides compute exact f64
prefix sums, so they agree to rounding (≤ 1e-10 relative); the JAX
``"mxu"`` prefix sums carry bf16 split error (≤ 1e-4).  Padded lanes are
compared nowhere: the port leaves them at loss 0, gradient 0, κ′ = κ,
where the JAX kernel updates them against a zero observation plane.

The CUDA kernel itself is checked against the plain version on the card
by tests/test_torch_cuda.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from difffe_tpu.mesh import FEMesh as JMesh
from difffe_tpu.ops.assembly import assemble_load as j_load
from difffe_tpu.ops.pallas import fused_grad_cf_kernel as jk
from difffe_tpu_torch.ops.kernels import _build
from difffe_tpu_torch.ops.kernels import fused_grad_cf_kernel as tk
from difffe_tpu_torch.solver import solve_poisson_batched as t_solve_b
from torch_parity import as_torch, port_mesh, rel_err

torch.set_num_threads(1)

BL = 128        # block_lanes on both sides: the same Bp, one JAX grid step
EXACT = 1e-10   # vpu prefix sums on both sides, f64


def _setup(n=20, B=40, seed=0, ud_mode="stream"):
    """Nonuniform mesh, nonzero Dirichlet values, κ near the data's κ."""
    jm = JMesh.line(n, bc_left=0.3, bc_right=-0.2, dtype=jnp.float64)
    xs = np.asarray(jm.nodes)[:, 0] ** 1.3
    jm = dataclasses.replace(jm, nodes=jnp.asarray(xs[:, None]))
    tm = port_mesh(jm)
    rng = np.random.default_rng(seed)
    fv = np.sin(np.pi * xs) + 1.0
    ke_true = 1.0 + 2.0 * rng.random((B, n))
    ud = t_solve_b(tm, as_torch(ke_true), as_torch(fv),
                   method="tridiag").numpy()
    if ud_mode == "shared":
        ud = ud[0]
    elif ud_mode == "bf16":        # the same bf16-representable values
        ud = as_torch(ud).to(torch.bfloat16).to(torch.float64).numpy()
    ke0 = 1.0 + 0.3 * rng.random((B, n))
    F = np.asarray(j_load(jm, jnp.asarray(fv)))
    return jm, tm, F, ud, ke0


def _operands(ud_mode, **kw):
    jm, tm, F, ud, ke0 = _setup(ud_mode=ud_mode, **kw)
    bf16 = ud_mode == "bf16"
    jkeT, jaux = jk.cf_packed_operands(
        jm, jnp.asarray(ke0), jnp.asarray(F), jnp.asarray(ud),
        block_lanes=BL, operand_dtype=jnp.bfloat16 if bf16 else None)
    tkeT, taux = tk.cf_packed_operands(
        tm, as_torch(ke0), as_torch(F), as_torch(ud), block_lanes=BL,
        operand_dtype=torch.bfloat16 if bf16 else None)
    return (jkeT, jaux), (tkeT, taux), ke0.shape[0]


@pytest.mark.parametrize("ud_mode", ["shared", "stream", "bf16"])
def test_packed_layout_matches_jax(ud_mode):
    (jkeT, jaux), (tkeT, taux), B = _operands(ud_mode)
    np.testing.assert_array_equal(tkeT.numpy(), np.asarray(jkeT))
    np.testing.assert_allclose(taux["cols"].numpy(),
                               np.asarray(jaux["cols"])[:, :tk._N_COLS],
                               rtol=1e-15, atol=1e-15)
    if ud_mode == "shared":
        assert taux["udT"] is None and jaux["udT"] is None
    else:
        assert taux["udT"].dtype == (torch.bfloat16 if ud_mode == "bf16"
                                     else torch.float64)
        np.testing.assert_array_equal(
            taux["udT"].to(torch.float64).numpy(),
            np.asarray(jaux["udT"].astype(jnp.float64)))
    for key in ("B", "ne", "n", "u_l", "u_r", "block_lanes"):
        assert taux[key] == jaux[key], key
    np.testing.assert_array_equal(tk.cf_unpack(tkeT, taux).numpy(),
                                  np.asarray(jk.cf_unpack(jkeT, jaux)))


@pytest.mark.parametrize("ud_mode", ["shared", "stream", "bf16"])
def test_step_matches_jax_kernel(ud_mode):
    """K1a (shared u_data) and K1b (streamed f64 / bf16 plane)."""
    jm, tm, F, ud, ke0 = _setup(ud_mode=ud_mode)
    bf16 = ud_mode == "bf16"
    lp_j, g_j = jk.fused_kappa_mse_step_general_cf(
        jm, jnp.asarray(ke0), jnp.asarray(F), jnp.asarray(ud),
        block_lanes=BL, cumsum_via="vpu",
        operand_dtype=jnp.bfloat16 if bf16 else None)
    lp_t, g_t = tk.fused_kappa_mse_step_general_cf(
        tm, as_torch(ke0), as_torch(F), as_torch(ud), block_lanes=BL,
        cumsum_via="vpu",
        operand_dtype=torch.bfloat16 if bf16 else None)
    assert g_t.shape == ke0.shape and lp_t.shape == (ke0.shape[0],)
    assert rel_err(lp_t, lp_j) <= EXACT
    assert rel_err(g_t, g_j) <= EXACT


def test_step_matches_jax_mxu_class():
    """The JAX "mxu" prefix sums carry split-bf16 error; the port's scan is
    exact for either setting."""
    jm, tm, F, ud, ke0 = _setup()
    _, g_j = jk.fused_kappa_mse_step_general_cf(
        jm, jnp.asarray(ke0), jnp.asarray(F), jnp.asarray(ud),
        block_lanes=BL, cumsum_via="mxu")
    _, g_t = tk.fused_kappa_mse_step_general_cf(
        tm, as_torch(ke0), as_torch(F), as_torch(ud), block_lanes=BL,
        cumsum_via="mxu")
    assert rel_err(g_t, g_j) <= 1e-4


@pytest.mark.parametrize("ud_mode", ["shared", "stream", "bf16"])
def test_chain_matches_jax_kernel(ud_mode):
    """K1c (shared u_data) and K1d (streamed plane), valid lanes only."""
    (jkeT, jaux), (tkeT, taux), B = _operands(ud_mode)
    lp_j, k_j = jk.kappa_sgd_chain_cf(jkeT, jaux, 6, 30.0, scale=0.1,
                                      cumsum_via="vpu")
    lp_t, k_t = tk.kappa_sgd_chain_cf(tkeT, taux, 6, 30.0, scale=0.1,
                                      cumsum_via="vpu")
    assert rel_err(lp_t[0, :B], np.asarray(lp_j)[0, :B]) <= EXACT
    assert rel_err(tk.cf_unpack(k_t, taux),
                jk.cf_unpack(k_j, jaux)) <= EXACT


@pytest.mark.parametrize("ud_mode", ["shared", "stream"])
def test_chain_equals_sequential_packed_steps(ud_mode):
    _, (keT, aux), B = _operands(ud_mode)
    lr, k = 30.0, 5
    lp_c, keT_chain = tk.kappa_sgd_chain_cf(keT, aux, k, lr)
    keT_seq = keT
    for _ in range(k):
        lp_s, gT = tk.kappa_mse_step_cf_packed(keT_seq, aux)
        keT_seq = keT_seq - lr * gT
    np.testing.assert_allclose(keT_chain.numpy(), keT_seq.numpy(),
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(lp_c.numpy(), lp_s.numpy(), rtol=1e-12)


def test_step_is_the_oracle_gradient():
    """The packed step's gradient is d/dκ of scale/2·Σ(u − u_data)² with u
    from the PCR oracle (the bench parity gate, in f64)."""
    jm, tm, F, ud, ke0 = _setup(ud_mode="bf16")
    n = tm.n_nodes
    keT, aux = tk.cf_packed_operands(tm, as_torch(ke0), as_torch(F),
                                     as_torch(ud), block_lanes=BL,
                                     operand_dtype=torch.bfloat16)
    _, gT = tk.kappa_mse_step_cf_packed(keT, aux, scale=2.0 / n)
    kt = as_torch(ke0).requires_grad_()
    fv = torch.sin(torch.pi * tm.nodes[:, 0]) + 1.0
    u = t_solve_b(tm, kt, fv, method="tridiag")
    ((u - as_torch(ud)) ** 2).mean(-1).sum().backward()
    assert rel_err(tk.cf_unpack(gT, aux), kt.grad) <= 1e-12


def test_padded_lanes_and_rows_are_inert():
    _, (keT, aux), B = _operands("stream", B=40)
    keT = keT.clone()
    keT[:, B:] = 0.5                     # garbage in the padding lanes
    lp, gT = tk.kappa_mse_step_cf_packed(keT, aux)
    lp_c, keT2 = tk.kappa_sgd_chain_cf(keT, aux, 4, 30.0)
    assert torch.all(lp[:, B:] == 0) and torch.all(gT[:, B:] == 0)
    assert torch.all(lp_c[:, B:] == 0)
    assert torch.equal(keT2[:, B:], keT[:, B:])
    ne = aux["ne"]
    assert torch.all(gT[ne:] == 0) and torch.equal(keT2[ne:], keT[ne:])
    assert torch.isfinite(keT2).all()


def test_guards():
    jm, tm, F, ud, ke0 = _setup()
    keT, aux = tk.cf_packed_operands(tm, as_torch(ke0), as_torch(F),
                                     as_torch(ud), block_lanes=BL)
    for n_inner in (0, -1):
        with pytest.raises(ValueError, match="n_inner >= 1"):
            tk.kappa_sgd_chain_cf(keT, aux, n_inner, 30.0)
    with pytest.raises(ValueError, match="cumsum_via"):
        tk.kappa_mse_step_cf_packed(keT, aux, cumsum_via="tensor")
    with pytest.raises(ValueError, match="shared"):
        tk.cf_packed_operands(tm, as_torch(ke0), as_torch(np.stack([F, F])),
                              as_torch(ud))
    with pytest.raises(ValueError, match="endpoint"):
        tk.cf_packed_operands(tm.with_dirichlet([4], 0.0), as_torch(ke0),
                              as_torch(F), as_torch(ud))
    # a tensor on neither the CPU nor a CUDA card raises before any build
    with pytest.raises(ValueError, match="device meta"):
        tk.kappa_sgd_chain_cf(keT.to("meta"), aux, 2, 30.0)


def test_build_names_library_by_source_hash(monkeypatch, tmp_path):
    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("libdifffe_") and path.suffix == ".so"
    assert path == _build.library_path()
    assert "fused_grad_cf.cu" in [s.name for s in _build.sources()]
    for flag in ("arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                 "-shared", "-fPIC"):
        assert flag in _build.NVCC_FLAGS + _build.LINK_FLAGS
    (tmp_path / "fused_grad_cf.cu").write_text(
        _build.sources()[0].read_text() + "\n// edited\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert _build.library_path() != path      # an edit rebuilds


def test_build_without_nvcc_raises(monkeypatch):
    import torch.utils.cpp_extension as ext

    monkeypatch.setattr(ext, "CUDA_HOME", None)
    monkeypatch.setenv("PATH", "")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
