"""The port's AOT export (difffe_tpu_torch/utils/export.py) against the JAX
package's (difffe_tpu/utils/export.py) on the same numpy inputs, in f64 on
the CPU.

Every route the facade takes is exported: the band routes of a line
('tridiag', 'tridiag_pallas'), 'dense', 'lu' and 'cg' on a line and on a
perturbed triangulation with ``grid=None``, the 2D stencil route with the
factory mask and with a pinned interior node (the natural route), P2
meshes on 'auto' (dense) and the 3D box on 'auto' (the stencil route).
The JAX artifacts are built once a module (each export lowers and each
call compiles).  The port's solver and gradient-step artifacts match them,
and JAX ``value_and_grad`` (on the cases this file held against it
before, and on the P2 rectangle), within ``TOL`` = 1e-12 relative on every
route: on the tol-gated CG routes both packages stop at a relative
residual of 1e-12 (the f64 default), and at these sizes (n ≤ 64,
cond(A) ≲ 1e2) the solution and the adjoint stay within 1e-12 of the
exact ones, so the CG routes need no looser bound.  The P2 rectangle's
JAX reference is its jitted solve and ``value_and_grad``: ``jax.export``
of that mesh raises "Too many leaves for PyTreeDef" in this JAX version.

Each solver artifact gives the port's live route's bits, each gradient
artifact the live autograd route's within ``TOL`` (the 2D factory route's
bits), with the live route's CG iterations on the tol-gated routes.  Every
kernel and every tol-gated loop is a ``torch.library`` op: each passes
``torch.library.opcheck`` at a small shape and is one node of an exported
graph that replays the live call's bits; only the probes' launches refuse
to be traced.
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

import difffe_tpu.ops.p2  # noqa: F401  its constants, made outside a jit
from difffe_tpu.mesh import FEMesh as JMesh
from difffe_tpu.solver import solve_poisson_batched as j_solve_b
from difffe_tpu.utils import export as jexp
from difffe_tpu_torch.mesh import FEMesh as TMesh
from difffe_tpu_torch.ops import cg as tcg
from difffe_tpu_torch.ops import pcg as tpcg
from difffe_tpu_torch.ops import stencil as tst
from difffe_tpu_torch.ops import stencil3d as tst3
from difffe_tpu_torch.ops import stencil_natural as tsn
from difffe_tpu_torch.ops import unstructured as tun
from difffe_tpu_torch.ops.kernels import _build
from difffe_tpu_torch.ops.kernels import ell_kernel as k8
from difffe_tpu_torch.ops.kernels import fused_grad_cf_kernel as k1
from difffe_tpu_torch.ops.kernels import fused_grad_kernel as k5
from difffe_tpu_torch.ops.kernels import fused_grad_mxu_kernel as k7
from difffe_tpu_torch.ops.kernels import fused_grad_thomas_kernel as k6
from difffe_tpu_torch.ops.kernels import stencil3d_cg_kernel as k4
from difffe_tpu_torch.ops.kernels import stencil_cg_kernel as k3
from difffe_tpu_torch.ops.kernels import tridiag_kernel as k2
from difffe_tpu_torch.probes import k5_warp_variants as k5v
from difffe_tpu_torch.probes import k7_ablation as p2
from difffe_tpu_torch.solver import solve_poisson_batched as t_solve_b
from difffe_tpu_torch.utils import export as texp
from torch_parity import (as_torch, general_meshes, jax_mesh, port_mesh,
                          rel_err)

torch.set_num_threads(1)

B = 3
TOL = 1e-12
# the meshes: (factory, args, kwargs); "pinned" adds a Dirichlet node with
# a nonzero value inside the rectangle (the natural route), "tri" is the
# perturbed triangulation with grid=None
MESHES = {"line": (JMesh.line, (12,), ()),
          "line_bc": (JMesh.line, (12,), (("bc_left", 1.0),
                                          ("bc_right", -0.5))),
          "rect": (JMesh.rectangle, (4, 4), ()),
          "pinned": (JMesh.rectangle, (4, 4), ()),
          "tri": (JMesh.rectangle, (4, 4), ()),
          "p2": (JMesh.rectangle_p2, (3, 3), ()),
          "line_p2": (JMesh.line_p2, (6,), ()),
          "box": (JMesh.box, (3, 3, 3), ())}
# the cases: name → (mesh, method, the JAX reference's method); a route
# that computes the same function as another is held against that one's
# JAX artifact: 'tridiag_pallas' against 'tridiag', 'lu' against 'dense'
CASES = {"line": ("line", "auto", "auto"),
         "line_bc": ("line_bc", "auto", "auto"),
         "rect": ("rect", "auto", "auto"),
         "line_pallas": ("line_bc", "tridiag_pallas", "auto"),
         "line_dense": ("line_bc", "dense", "dense"),
         "line_lu": ("line_bc", "lu", "dense"),
         "line_cg": ("line_bc", "cg", "cg"),
         "pinned": ("pinned", "auto", "auto"),
         "tri_dense": ("tri", "auto", "auto"),
         "tri_lu": ("tri", "lu", "auto"), "tri_cg": ("tri", "cg", "cg"),
         "p2": ("p2", "auto", "auto"), "line_p2": ("line_p2", "auto", "auto"),
         "box": ("box", "auto", "auto")}
# the solver artifact is checked on "line", the gradient one on "line_bc"
SOLVER_CASES = sorted(set(CASES) - {"line_bc"})
GRAD_CASES = sorted(set(CASES) - {"line"})
# the op each route holds as one node a solve (two a gradient step): K2,
# or the route's tol-gated loop (iterations counted by the ops)
ROUTE_OPS = {"line_pallas": "tridiag_pcr", "rect": "stencil_cg_gated",
             "pinned": "stencil_natural_cg_gated",
             "line_cg": "element_cg_gated", "tri_cg": "element_cg_gated",
             "box": "stencil3d_cg_gated"}
GATED = set(ROUTE_OPS) - {"line_pallas"}


def _count(module, op):
    """How many nodes of a loaded artifact call ``difffe::<op>``."""
    return [str(n.target) for n in module.graph.nodes
            if n.op == "call_function"].count(f"difffe.{op}.default")


@functools.lru_cache(maxsize=None)
def _jmesh(name):
    factory, args, kw = MESHES[name]
    if name == "tri":
        return general_meshes(factory, *args)[0]
    jm = jax_mesh(factory, *args, **dict(kw))
    if name == "pinned":
        node = 2 * (args[0] + 1) + 2           # an interior node
        jm = dataclasses.replace(jm, bc_mask=jm.bc_mask.at[node].set(1.0),
                                 bc_values=jm.bc_values.at[node].set(0.25))
    return jm


@functools.lru_cache(maxsize=None)
def _tmesh(name):
    return port_mesh(_jmesh(name))


def _inputs(n_nodes, seed=0):
    rng = np.random.default_rng(seed)
    log_k = rng.uniform(-0.5, 0.5, B)
    f = rng.uniform(0.5, 1.5, (B, n_nodes))
    u_data = rng.uniform(0.0, 0.05, (B, n_nodes))
    return log_k, f, u_data


def _jax_live(jm, method, log_k, f, ud):
    """(loss, grad) by value_and_grad of JAX's jitted facade."""
    def loss(lk):
        u_ = j_solve_b(jm, jnp.exp(lk), f, method=method, kappa_batched=True)
        return jnp.mean((u_ - ud) ** 2)

    ref = jax.jit(jax.value_and_grad(loss))(log_k)
    return float(ref[0]), np.asarray(ref[1])


@functools.lru_cache(maxsize=None)
def _jax_refs(mesh_name, method):
    """(u, [(loss, grad), ...]) of the JAX artifacts, where ``jax.export``
    takes the mesh, and of value_and_grad on the P2 rectangle (which has
    no artifact) and on the factory line and rectangle."""
    jm = _jmesh(mesh_name)
    log_k, f, ud = _inputs(jm.n_nodes)
    refs = []
    if mesh_name in ("p2", "line_bc", "rect") and method == "auto":
        refs.append(_jax_live(jm, method, log_k, f, ud))
    if mesh_name == "p2":
        u = jax.jit(lambda k: j_solve_b(jm, k, f, method=method,
                                        kappa_batched=True))(jnp.exp(log_k))
    else:
        u = np.asarray(jexp.load_exported(jexp.export_batched_solver(
            jm, B, method=method))(jnp.exp(log_k), f))
        loss, grad = jexp.load_exported(jexp.export_gradient_step(
            jm, B, method=method))(log_k, f, ud)
        refs.append((float(loss), np.asarray(grad)))
    return np.asarray(u), refs


def _refs(case):
    mesh_name, _, jax_method = CASES[case]
    return _jax_refs(mesh_name, jax_method)


@functools.lru_cache(maxsize=None)
def _port_solver(case):
    """The port's solver artifact (traced for the CPU, named explicitly)."""
    mesh_name, method, _ = CASES[case]
    return texp.export_batched_solver(_tmesh(mesh_name), B, method=method,
                                      platforms=["cpu"])


@functools.lru_cache(maxsize=None)
def _port_grad(case):
    mesh_name, method, _ = CASES[case]
    return texp.export_gradient_step(_tmesh(mesh_name), B, method=method)


@pytest.mark.parametrize("case", SOLVER_CASES)
def test_solver_artifact_matches_jax(case):
    mesh_name, method, _ = CASES[case]
    tm = _tmesh(mesh_name)
    log_k, f, _ = _inputs(tm.n_nodes)
    kappa, f = as_torch(np.exp(log_k)), as_torch(f)
    solve, specs = texp.load_exported_with_avals(_port_solver(case))
    assert [(s.shape, s.dtype) for s in specs] == [
        ((B,), torch.float64), ((B, tm.n_nodes), torch.float64)]
    if case in ROUTE_OPS:
        assert _count(solve, ROUTE_OPS[case]) == 1
    tpcg.gated_iters.clear()
    u = solve(kappa, f)
    iters = list(tpcg.gated_iters)
    assert rel_err(u, _refs(case)[0]) <= TOL
    tpcg.gated_iters.clear()
    assert torch.equal(u, t_solve_b(tm, kappa, f, method=method,
                                    kappa_batched=True))
    assert iters == list(tpcg.gated_iters)
    assert (len(iters) == 1) == (case in GATED)


@pytest.mark.parametrize("case", GRAD_CASES)
def test_gradient_artifact_matches_jax(case):
    """The explicit adjoint against the JAX artifact and value_and_grad,
    and against the live autograd route: its loss's bits, its gradient
    within TOL (on the 2D factory stencil route its bits) and its forward
    and adjoint CG iterations."""
    mesh_name, method, _ = CASES[case]
    tm = _tmesh(mesh_name)
    log_k, f, ud = map(as_torch, _inputs(tm.n_nodes))
    step = texp.load_exported(_port_grad(case))
    if case in ROUTE_OPS:
        assert _count(step, ROUTE_OPS[case]) == 2
    tpcg.gated_iters.clear()
    loss, grad = step(log_k, f, ud)
    iters = list(tpcg.gated_iters)
    for jl, jg in _refs(case)[1]:
        assert abs(float(loss) - jl) <= TOL * abs(jl)
        assert rel_err(grad, jg) <= TOL
    x = log_k.clone().requires_grad_(True)
    tpcg.gated_iters.clear()
    live = ((t_solve_b(tm, x.exp(), f, method=method, kappa_batched=True)
             - ud) ** 2).mean()
    live.backward()
    assert torch.equal(loss, live.detach())
    assert rel_err(grad, x.grad) <= TOL
    if case == "rect":
        assert torch.equal(grad, x.grad)
    assert iters == list(tpcg.gated_iters)
    assert len(iters) == (2 if case in GATED else 0)


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
    """K2 (one node a solve, two a gradient step) and K1's chain and step
    are single nodes of the exported graphs; the K2 artifact gives the
    live route's bits.  Each route's kernel or tol-gated loop is one node
    a solve and two a gradient step (the artifact tests count them)."""
    tm = TMesh.line(10, dtype=torch.float64, device="cpu")
    solver = texp.export_batched_solver(tm, 2, method="tridiag_pallas")
    grad = texp.export_gradient_step(tm, 2, method="tridiag_pallas")
    assert _targets(solver).count("difffe.tridiag_pcr.default") == 1
    assert _targets(grad).count("difffe.tridiag_pcr.default") == 2
    kappa = torch.tensor([1.0, 2.5], dtype=torch.float64)
    f = torch.rand(2, tm.n_nodes, dtype=torch.float64)
    assert torch.equal(texp.load_exported(solver)(kappa, f), t_solve_b(
        tm, kappa, f, method="tridiag_pallas", kappa_batched=True))

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


# --- every other kernel and every tol-gated loop as an op -----------------

def _rng(seed):
    return torch.Generator().manual_seed(seed)


def _k3_operands():
    grid = tst.StructuredGrid.unit(4, 3)
    g = _rng(3)
    kl = 1.0 + torch.rand(2, 3, 4, generator=g, dtype=torch.float64)
    ku = 1.0 + torch.rand(2, 3, 4, generator=g, dtype=torch.float64)
    f = torch.rand(2, 4, 5, generator=g, dtype=torch.float64)
    gb = 0.1 * torch.rand(4, 5, generator=g, dtype=torch.float64)
    _, D, b, Minv, x0, _ = k3._prepare(grid, (kl, ku), f, gb)
    ud = 0.01 * torch.rand(2, 4, 5, generator=g, dtype=torch.float64)
    return grid, (kl, ku), D, b, Minv, x0, ud


def _k4_operands():
    grid = tst3.StructuredGrid3.unit(3, 2, 2)
    g = _rng(4)
    kap = 1.0 + torch.rand(2, grid.n_elements, generator=g,
                           dtype=torch.float64)
    f = torch.rand((2,) + grid.node_shape, generator=g, dtype=torch.float64)
    gb = 0.1 * torch.rand(grid.node_shape, generator=g, dtype=torch.float64)
    _, D, b, Minv, x0, _ = k4._prepare3(grid, kap, f, gb)
    ud = 0.01 * torch.rand(b.shape, generator=g, dtype=torch.float64)
    return grid, kap, D, b, Minv, x0, ud


def _line_operands():
    mesh = TMesh.line(9, bc_left=0.3, bc_right=-0.2, dtype=torch.float64,
                      device="cpu")
    g = _rng(5)
    n = mesh.n_nodes
    lk = 0.3 * torch.randn(3, generator=g, dtype=torch.float64)
    ke = 1.0 + torch.rand(3, n - 1, generator=g, dtype=torch.float64)
    F = 0.5 + torch.rand(3, n, generator=g, dtype=torch.float64)
    ud = torch.randn(3, n, generator=g, dtype=torch.float64)
    return mesh, lk, ke, F, ud, 2.0 / (3 * n)


def _ell_operands():
    mesh = general_meshes(JMesh.rectangle, 3, 3)[1]
    ell = tun.build_ell(mesh)
    g = _rng(8)
    keB = 1.0 + torch.rand(mesh.n_elements, 4, generator=g,
                           dtype=torch.float64)
    W, diag = tun.ell_weights_bm(mesh, ell, keB)
    v = torch.rand(mesh.n_nodes, 4, generator=g, dtype=torch.float64)
    return ell.nbr, W, diag, v, mesh.bc_mask.contiguous()


def _tri_operands():
    mesh = general_meshes(JMesh.rectangle, 3, 3)[1]
    g = _rng(9)
    ke = 1.0 + torch.rand(2, mesh.n_elements, generator=g,
                          dtype=torch.float64)
    op = tcg.element_operator(mesh, ke)
    Minv = tcg.jacobi(mesh, tcg.stiffness_diag(mesh, ke))
    b = torch.rand(2, mesh.n_nodes, generator=g, dtype=torch.float64)
    return op, Minv, b


def _case_k3a():
    _, _, D, b, Minv, x0, _ = _k3_operands()
    return (lambda *t: k3._launch_cg(*t, 6)), (D, b, Minv, x0), \
        k3.stencil_cg, (D, b, Minv, x0, 6, None)


def _case_k3b():
    _, _, D, b, Minv, x0, ud = _k3_operands()
    lam0 = torch.zeros_like(b)
    return (lambda *t: k3._launch_cg2(*t, 0.05, 6)), \
        (D, b, Minv, x0, lam0, ud), k3.stencil_cg2, \
        (D, b, Minv, x0, lam0, ud, 0.05, 6, None)


def _case_k3a_twice():
    """The 2D step on two K3a launches (kappa_mse_step_2d_two_launch)."""
    grid, (kl, ku), _, _, _, _, ud = _k3_operands()
    f = torch.rand(2, 4, 5, generator=_rng(6), dtype=torch.float64)
    g = torch.zeros(4, 5, dtype=torch.float64)
    _, D, b, Minv, x0, _ = k3._prepare(grid, (kl, ku), f, g)
    return (lambda l, u, f_, d: k3.kappa_mse_step_2d_two_launch(
        grid, (l, u), f_, g, d, iters=6)), (kl, ku, f, ud), k3.stencil_cg, \
        (D, b, Minv, x0, 6, None)


def _case_k4a():
    _, _, D, b, Minv, x0, _ = _k4_operands()
    return (lambda *t: k4._launch_cg3(*t, 6)), (D, b, Minv, x0), \
        k4.stencil3d_cg, (D, b, Minv, x0, 6, None)


def _case_k4b():
    _, _, D, b, Minv, x0, ud = _k4_operands()
    lam0 = torch.zeros_like(b)
    return (lambda *t: k4._launch_cg3_2(*t, 0.05, 6)), \
        (D, b, Minv, x0, lam0, ud), k4.stencil3d_cg2, \
        (D, b, Minv, x0, lam0, ud, 0.05, 6, None)


def _case_k5(general):
    mesh, lk, ke, F, ud, scale = _line_operands()
    if general:
        cols, inv_h = k5.general_constants(mesh)
        kap = ke
    else:
        cols, inv_h, kap = k5.scalar_columns(mesh), 0.0, lk
    return (lambda k, f, u: k5._launch_pcr(general, k, f, u, cols, scale,
                                           inv_h, 512)), (kap, F, ud), \
        k5.fused_pcr, (kap, F, ud, cols, int(general), scale, inv_h, 512,
                       None)


def _case_k6():
    mesh, _, ke, F, ud, scale = _line_operands()
    cols, inv_h = k5.general_constants(mesh)
    return (lambda k, f, u: k6._launch(mesh, k, f, u, cols, inv_h, scale,
                                       512, None)), (ke, F, ud), \
        k6.fused_thomas, (ke, F, ud, cols, k6._host_rows(mesh), inv_h,
                          scale, 512, None)


def _case_k7(plan):
    mesh, lk, _, F, ud, scale = _line_operands()
    cols, W = k5.scalar_columns(mesh), k7.mxu_inverse(mesh)
    if plan == "tc":
        fn = (lambda k, f, u: k7._launch_tc(k, f, u, cols, W, scale, 3, 2))
        args = (lk, F, ud, cols, W, scale, 3, 2, 1, "tc")
    else:
        fn = (lambda k, f, u: k7._launch(k, f, u, cols, W, scale, 2, 0, 64))
        args = (lk, F, ud, cols, W, scale, 2, 0, 64, "fma")
    return fn, (lk, F, ud), k7.fused_mxu, args


def _case_k8():
    nbr, W, diag, v, m = _ell_operands()
    return (lambda *t: k8.ell_apply(nbr, *t)), (W, diag, v, m), k8.k8_op, \
        (nbr, W, diag, v, m, None)


def _case_k8s(tol):
    nbr, W, diag, v, m = _ell_operands()
    maxiter = 8 if tol == 0.0 else 60
    return (lambda *t: k8.ell_cg(nbr, *t, tol, maxiter)), (W, diag, m, v), \
        k8.ell_cg_op, (nbr, W, diag, m, v, tol, maxiter, None)


def _case_gated2d():
    grid, (kl, ku), _, b, _, _, _ = _k3_operands()
    dot = tpcg.batched_dot(2)
    return (lambda l, u, r: tst.apply_inv(grid, (l, u), r, 1e-10, 40, dot)), \
        (kl, ku, b), tst.stencil_cg_gated, \
        (kl, ku, b, grid.nx, grid.ny, grid.hx, grid.hy, 1e-10, 40, 2)


def _case_gated3d():
    grid, kap, _, b, _, _, _ = _k4_operands()
    dot = tpcg.batched_dot(3)
    return (lambda k, r: tst3.apply_inv_3d(grid, k, r, 1e-10, 40, dot)), \
        (kap, b), tst3.stencil3d_cg_gated, \
        (kap, b, grid.nx, grid.ny, grid.nz, grid.hx, grid.hy, grid.hz,
         1e-10, 40, 3)


def _case_gated_natural():
    grid, (kl, ku), _, b, _, _, _ = _k3_operands()
    C = tst.stencil_coefficients(grid, kl, ku)
    m = tst.boundary_mask_grid(grid, torch.float64)
    m[1, 2] = 1.0
    x0 = torch.zeros_like(b)
    return (lambda c, r: tsn._pcg_nat(grid, c, None, m, r, x0, 1e-10, 40)), \
        (C, b), tsn.stencil_natural_cg_gated, (C, None, m, b, x0, 1e-10, 40)


def _case_gated_element():
    op, Minv, b = _tri_operands()
    x0 = torch.zeros_like(b)
    return (lambda k, r: tcg.solve_element(op._replace(Ke=k), r, Minv, x0,
                                           1e-10, 40)), (op.Ke, b), \
        tcg.element_cg_gated, (op.Ke, op.elements, op.m, b, Minv, x0, None,
                               None, None, None, None, 0, 1e-10, 40)


# each production kernel launch and each tol-gated loop: (the public call
# on example tensors, those tensors, the op, its arguments for opcheck)
OP_CASES = {"K3a": _case_k3a, "K3a twice": _case_k3a_twice,
            "K3b": _case_k3b, "K4a": _case_k4a,
            "K4b": _case_k4b, "K5a": lambda: _case_k5(False),
            "K5b": lambda: _case_k5(True), "K6": _case_k6,
            "K7 tc": lambda: _case_k7("tc"), "K7 fma": lambda: _case_k7("fma"),
            "K8": _case_k8, "K8s": lambda: _case_k8s(0.0),
            "K8s gated": lambda: _case_k8s(1e-10),
            "gated 2D": _case_gated2d, "gated 3D": _case_gated3d,
            "gated natural": _case_gated_natural,
            "gated element": _case_gated_element}


@pytest.mark.parametrize("kernel", sorted(OP_CASES))
def test_launch_is_one_op_node(kernel):
    """Each op passes opcheck; an exported CPU function of its public
    launch holds it as one node (the two-launch 2D step two) and replays
    the live call's bits."""
    fn, tensors, op, args = OP_CASES[kernel]()
    torch.library.opcheck(op, args)
    blob = texp.export_fn(fn, *tensors)
    assert _targets(blob).count(str(op)) == (2 if kernel == "K3a twice"
                                             else 1)
    want = _leaves(fn(*tensors))
    got = _leaves(texp.load_exported(blob)(*tensors))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _leaves(x):
    """The tensors of a nested tuple of outputs, in order."""
    if isinstance(x, (tuple, list)):
        return [t for y in x for t in _leaves(y)]
    return [x]


# the probes' launches, which refuse export by design
LAUNCHES = {"P2": p2._launch, "K5 variants": k5v.launch}


@pytest.mark.parametrize("kernel", sorted(LAUNCHES))
def test_launches_refuse_tracing(kernel):
    """Called with fake CUDA tensors (what torch.export traces a card's
    program with; no card needed), each probe launch raises the guard's
    error before it touches a pointer."""
    fn = LAUNCHES[kernel]
    with FakeTensorMode():
        t = torch.empty(4, 8, device="cuda")
        kw = {name: t for name, p in inspect.signature(fn).parameters.items()
              if p.default is inspect.Parameter.empty}
        kw.update({k: v for k, v in (("variant", "B"), ("general", False),
                                     ("fn", None), ("mesh", None))
                   if k in kw})
        with pytest.raises(NotImplementedError, match="probe's kernel"):
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
    # 'dense' on a line and a rectangle whose mask is not the factory one
    # (the natural route) export, and match the JAX artifacts
    for case in ("line_dense", "pinned"):
        log_k, f, ud = map(as_torch, _inputs(_tmesh(CASES[case][0]).n_nodes))
        loss, grad = texp.load_exported(_port_grad(case))(log_k, f, ud)
        jl, jg = _refs(case)[1][-1]
        assert abs(float(loss) - jl) <= TOL * abs(jl)
        assert rel_err(grad, jg) <= TOL
