"""The port's AOT export (difffe_tpu_torch/utils/export.py) against the JAX
package's (difffe_tpu/utils/export.py) on the same numpy inputs, in f64 on
the CPU.

The JAX artifacts are built once a module (each export lowers and each
call compiles).  The port's solver and gradient-step artifacts match them,
and JAX ``value_and_grad``, within 1e-12 relative; the 2D artifact equals
the port's live route bit for bit, with the same CG iterations.  The
kernels with a custom op (K2, K1) are nodes of the exported graph and pass
``torch.library.opcheck``; every other kernel launch refuses to be traced.
"""

import dataclasses
import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from difffe_tpu.mesh import FEMesh as JMesh
from difffe_tpu.solver import solve_poisson_batched as j_solve_b
from difffe_tpu.utils import export as jexp
from difffe_tpu_torch.mesh import FEMesh as TMesh
from difffe_tpu_torch.ops import stencil as tst
from difffe_tpu_torch.ops.kernels import _build
from difffe_tpu_torch.ops.kernels import ell_kernel as k8
from difffe_tpu_torch.ops.kernels import fused_grad_cf_kernel as k1
from difffe_tpu_torch.ops.kernels import fused_grad_kernel as k5
from difffe_tpu_torch.ops.kernels import fused_grad_mxu_kernel as k7
from difffe_tpu_torch.ops.kernels import fused_grad_thomas_kernel as k6
from difffe_tpu_torch.ops.kernels import stencil3d_cg_kernel as k4
from difffe_tpu_torch.ops.kernels import stencil_cg_kernel as k3
from difffe_tpu_torch.ops.kernels import tridiag_kernel as k2
from difffe_tpu_torch.probes import k7_ablation as p2
from difffe_tpu_torch.solver import solve_poisson_batched as t_solve_b
from difffe_tpu_torch.utils import export as texp
from torch_parity import as_torch, jax_mesh, port_mesh, rel_err

B = 3
TOL = 1e-12
CASES = {"line": (JMesh.line, (12,), ()),
         "line_bc": (JMesh.line, (12,), (("bc_left", 1.0),
                                         ("bc_right", -0.5))),
         "rect": (JMesh.rectangle, (4, 4), ())}


def _jmesh(case):
    factory, args, kw = CASES[case]
    return jax_mesh(factory, *args, **dict(kw))


def _inputs(n_nodes, seed=0):
    rng = np.random.default_rng(seed)
    log_k = rng.uniform(-0.5, 0.5, B)
    f = rng.uniform(0.5, 1.5, (B, n_nodes))
    u_data = rng.uniform(0.0, 0.05, (B, n_nodes))
    return log_k, f, u_data


@functools.lru_cache(maxsize=None)
def _jax_solve(case):
    """u from the JAX solver artifact."""
    jm = _jmesh(case)
    log_k, f, _ = _inputs(jm.n_nodes)
    return np.asarray(jexp.load_exported(jexp.export_batched_solver(jm, B))(
        jnp.exp(log_k), f))


@functools.lru_cache(maxsize=None)
def _jax_grads(case):
    """(loss, grad) from the JAX gradient artifact and from
    value_and_grad."""
    jm = _jmesh(case)
    log_k, f, ud = _inputs(jm.n_nodes)
    loss, grad = jexp.load_exported(jexp.export_gradient_step(jm, B))(
        log_k, f, ud)

    def live(lk):
        u_ = j_solve_b(jm, jnp.exp(lk), f, kappa_batched=True)
        return jnp.mean((u_ - ud) ** 2)

    ref = jax.jit(jax.value_and_grad(live))(log_k)
    return ((float(loss), np.asarray(grad)),
            (float(ref[0]), np.asarray(ref[1])))


@functools.lru_cache(maxsize=None)
def _port_solver(case):
    """The port's solver artifact (traced for the CPU, named explicitly)."""
    return texp.export_batched_solver(port_mesh(_jmesh(case)), B,
                                      platforms=["cpu"])


@pytest.mark.parametrize("case", ["line", "rect"])
def test_solver_artifact_matches_jax(case):
    tm = port_mesh(_jmesh(case))
    log_k, f, _ = _inputs(tm.n_nodes)
    kappa, f = as_torch(np.exp(log_k)), as_torch(f)
    solve, specs = texp.load_exported_with_avals(_port_solver(case))
    assert [(s.shape, s.dtype) for s in specs] == [
        ((B,), torch.float64), ((B, tm.n_nodes), torch.float64)]
    u = solve(kappa, f)
    assert rel_err(u, _jax_solve(case)) <= TOL
    assert torch.equal(u, t_solve_b(tm, kappa, f, kappa_batched=True))


@pytest.mark.parametrize("case", ["line_bc", "rect"])
def test_gradient_artifact_matches_jax(case):
    """The explicit adjoint against the JAX artifact and value_and_grad;
    on the 2D stencil route also the live autograd route's bits and its
    forward and adjoint CG iterations."""
    tm = port_mesh(_jmesh(case))
    log_k, f, ud = map(as_torch, _inputs(tm.n_nodes))
    step = texp.load_exported(texp.export_gradient_step(tm, B))
    tst.gated_iters.clear()
    loss, grad = step(log_k, f, ud)
    iters = list(tst.gated_iters)
    for jl, jg in _jax_grads(case):
        assert abs(float(loss) - jl) <= TOL * abs(jl)
        assert rel_err(grad, jg) <= TOL
    x = log_k.clone().requires_grad_(True)
    tst.gated_iters.clear()
    live = ((t_solve_b(tm, x.exp(), f, kappa_batched=True) - ud) ** 2).mean()
    live.backward()
    assert torch.equal(loss, live.detach())
    if case == "rect":
        assert torch.equal(grad, x.grad)
        assert iters == list(tst.gated_iters) and len(iters) == 2
    else:
        assert rel_err(grad, x.grad) <= TOL


def test_blob_survives_disk_round_trip(tmp_path):
    blob = _port_solver("line")
    path = tmp_path / "solver.pt2"
    path.write_bytes(blob)
    n = _jmesh("line").n_nodes
    u = texp.load_exported(path.read_bytes())(
        torch.ones(B, dtype=torch.float64),
        torch.ones(B, n, dtype=torch.float64))
    assert torch.isfinite(u).all() and u.shape == (B, n)


def _targets(blob):
    ep = texp._load(blob)[0]
    return [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]


def test_kernel_ops_are_nodes_of_the_graph():
    """K2 (one node a solve, two a gradient step), K1's chain and step, and
    the tol-gated stencil CG are single nodes of the exported graphs; the
    K2 artifact gives the live route's bits."""
    tm = TMesh.line(10, dtype=torch.float64, device="cpu")
    solver = texp.export_batched_solver(tm, 2, method="tridiag_pallas")
    grad = texp.export_gradient_step(tm, 2, method="tridiag_pallas")
    assert _targets(solver).count("difffe.tridiag_pcr.default") == 1
    assert _targets(grad).count("difffe.tridiag_pcr.default") == 2
    kappa = torch.tensor([1.0, 2.5], dtype=torch.float64)
    f = torch.rand(2, tm.n_nodes, dtype=torch.float64)
    assert torch.equal(texp.load_exported(solver)(kappa, f), t_solve_b(
        tm, kappa, f, method="tridiag_pallas", kappa_batched=True))
    assert _targets(_port_solver("rect")).count(
        "difffe.stencil_cg_gated.default") == 1

    keT, aux = _k1_operands(streamed=True)
    chain = texp.export_fn(
        lambda k, u: k1.kappa_sgd_chain_cf(k, dict(aux, udT=u), 4, 30.0),
        keT, aux["udT"])
    assert _targets(chain).count("difffe.cf_chain.default") == 1
    lp, k_out = texp.load_exported(chain)(keT, aux["udT"])
    lp_live, k_live = k1.kappa_sgd_chain_cf(keT, aux, 4, 30.0)
    assert torch.equal(lp, lp_live) and torch.equal(k_out, k_live)
    step = texp.export_fn(lambda k: k1.kappa_mse_step_cf_packed(k, aux),
                          keT)
    assert _targets(step).count("difffe.cf_step.default") == 1


def _k1_operands(streamed):
    tm = TMesh.line(10, bc_left=0.3, bc_right=-0.2, dtype=torch.float64,
                    device="cpu")
    g = torch.Generator().manual_seed(1)
    ke = 1.0 + torch.rand(4, tm.n_elements, generator=g, dtype=torch.float64)
    ud = torch.rand(4, tm.n_nodes, generator=g, dtype=torch.float64) * 0.1
    F = torch.full((tm.n_nodes,), 0.1, dtype=torch.float64)
    return k1.cf_packed_operands(tm, ke, F, ud if streamed else ud[0],
                                 block_lanes=8)


@pytest.mark.parametrize("bands", ["batched", "shared"])
def test_opcheck_k2(bands):
    g = torch.Generator().manual_seed(2)
    n, rows = 9, 4
    d = 4.0 + torch.rand(rows, n, generator=g, dtype=torch.float64)
    e = -torch.rand(rows, n - 1, generator=g, dtype=torch.float64)
    F = torch.rand(rows, n, generator=g, dtype=torch.float64)
    if bands == "shared":      # stride-0 rows, as _rows passes them
        d, e = d[:1].expand(rows, n), e[:1].expand(rows, n - 1)
        assert d.stride(0) == 0 and e.stride(0) == 0
    torch.library.opcheck(k2.tridiag_pcr, (d, e, F, 4, None))


@pytest.mark.parametrize("op", ["step", "chain"])
def test_opcheck_k1(op):
    keT, aux = _k1_operands(streamed=op == "chain")
    args = (keT, aux["udT"], aux["cols"], aux["B"], aux["n"], 0.05,
            aux["u_l"], aux["u_r"])
    if op == "step":
        torch.library.opcheck(k1._cf_step, args)
    else:
        torch.library.opcheck(k1._cf_chain, args + (3, 30.0))


# every launch through ctypes that has no custom op, by the kernel its
# guard names
LAUNCHES = {"K3a": k3._launch_cg, "K3b": k3._launch_cg2,
            "K4a": k4._launch_cg3, "K4b": k4._launch_cg3_2,
            "K5a": k5._launch_pcr, "K6": k6._launch, "K7": k7._launch,
            "K7 ": k7._launch_tc, "K8": k8.ell_apply,
            "K8s": k8._launch_ell_cg, "P2": p2._launch}


@pytest.mark.parametrize("kernel", sorted(LAUNCHES))
def test_launches_refuse_tracing(kernel):
    """Called with fake CUDA tensors (what torch.export traces a card's
    program with; no card needed), each launch raises the guard's error
    before it touches a pointer."""
    fn = LAUNCHES[kernel]
    with FakeTensorMode():
        t = torch.empty(4, 8, device="cuda")
        kw = {name: t for name, p in inspect.signature(fn).parameters.items()
              if p.default is inspect.Parameter.empty}
        kw.update({k: v for k, v in (("general", False), ("variant", "B"),
                                     ("mesh", None)) if k in kw})
        with pytest.raises(NotImplementedError,
                           match=f"{kernel.strip()} .*ROADMAP"):
            fn(**kw)
    _build.refuse_traced(kernel, torch.zeros(2), None)     # real: passes


def test_platforms():
    tm = TMesh.line(6, dtype=torch.float64, device="cpu")
    blob = _port_solver("line")
    _, specs = texp.load_exported_with_avals(blob, device="cpu")
    assert specs[0].device == torch.device("cpu")
    with pytest.raises(ValueError, match="unknown platform 'tpu'"):
        texp.export_batched_solver(tm, 2, platforms=["tpu"])
    with pytest.raises(ValueError, match="first"):
        texp.export_fn(lambda x: 2 * x, torch.ones(2),
                       platforms=["gpu", "cpu"])
    with pytest.raises(ValueError, match=r"runs on \['cpu'\], not on cuda"):
        texp.load_exported(blob, device="cuda")
    with pytest.raises(NotImplementedError, match="stencil route"):
        texp.export_gradient_step(tm, 2, method="dense")
    # a rectangle whose mask is not the factory one takes the natural route
    rect = port_mesh(_jmesh("rect"))
    pinned = dataclasses.replace(rect, bc_mask=torch.ones_like(rect.bc_mask))
    with pytest.raises(NotImplementedError, match="stencil route"):
        texp.export_gradient_step(pinned, 2)
