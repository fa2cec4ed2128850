"""Kernels K3a/K3b: whole-CG Jacobi-PCG on structured 2D grids.

PyTorch counterpart of ``difffe_tpu/ops/pallas/stencil_cg_kernel.py``.
The Dirichlet elimination is folded into the stencil outside the kernel
(D_k = p·C_k·shift(p) + diag(m)), so the kernel's operator is a plain
5-point stencil apply on (B, H, W) planes; planes 5/6 of the 7-point
layout are identically zero for isotropic per-triangle κ and never enter.

Each solve has two implementations behind one wrapper:

* the CUDA kernels in ``csrc/stencil_cg.cu``, launched for CUDA tensors:
  K3a (one solve) and K3b (two) on the route :func:`cluster_plan` picks
  from the shape, one thread-block cluster per scenario with the whole CG
  in shared memory, or past the cluster's reach the first design (one
  thread block per scenario, CG vectors in shared memory or a global
  workspace);
* the plain PyTorch versions below (the same per-scenario fixed-trip PCG
  with the same freeze rule), taken only for CPU tensors, and the
  reference the kernels are checked against.

Each kernel is one ``torch.library`` op, live and traced
(``_build.kernel_op``): ``difffe::stencil_cg`` (K3a) and
``difffe::stencil_cg2`` (K3b), the kernel on CUDA tensors (its route
planned from the shape on the card at call time; ``cluster`` forces one:
0 the workspace route, c > 0 the cluster route at c blocks), the plain
version on CPU tensors, so an exported program holds each launch as one
node.

Names mapped from the JAX module: ``_cg_pallas`` → :func:`_cg` (K3a),
``_cg2_pallas`` → :func:`_cg2` (K3b), ``solve_structured_pallas`` →
:func:`solve_structured_kernel`.  Nothing is padded: the TPU padded W to
128 lanes and B to ``block_b``; here the planes are (B, H, W) as they
are.  ``block_b`` stays in every signature for the JAX callers' sake: the
CUDA kernel runs one scenario per thread block whatever its value, so it
changes neither results nor launches (it must be ≥ 1).

The warm state of :func:`fused_kappa_mse_step_2d` and
:func:`kappa_mse_step_2d_two_launch` is an opaque ``(x, λ)`` pair of
(B, H, W) planes — the last forward and adjoint solutions — to be handed
back unchanged as ``warm_state``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from ._build import kernel_op
from ..stencil import (
    OFFSETS,
    StructuredGrid,
    _shift2d,
    boundary_mask_grid,
    load_grid,
    residual_vjp_manual,
    stencil_apply,
    stencil_coefficients,
)

#: Kernel launches made by the wrappers, by kernel and route: "cg" K3a and
#: "cg2" K3b on the cluster route, "cg_workspace" and "cg2_workspace" on
#: the workspace route.
launches = {"cg": 0, "cg_workspace": 0, "cg2": 0, "cg2_workspace": 0}


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU path and reference)
# ---------------------------------------------------------------------------


def _apply5(D, v):
    out = D[0] * v
    for k, (dr, dc) in enumerate(OFFSETS[1:5], start=1):
        out = out + D[k] * _shift2d(v, dr, dc)
    return out


def _cg_plain(D, b, Minv, x, iters):
    """Plain version of K3a: ``iters`` fixed PCG iterations per scenario
    on (B, H, W) planes, from x; returns x."""
    def dot(u, v):
        return (u * v).sum(dim=(-2, -1), keepdim=True)

    r = b - _apply5(D, x)
    z = Minv * r
    p = z
    rz = dot(r, z)
    eps = torch.finfo(b.dtype).eps
    floor = (4.0 * eps) ** 2 * rz.clamp_min(1e-30)
    zero = torch.zeros_like(rz)
    for _ in range(iters):
        live = rz > floor
        Ap = _apply5(D, p)
        pAp = dot(p, Ap)
        alpha = torch.where(live & (pAp != 0),
                            rz / torch.where(pAp != 0, pAp, 1.0), zero)
        x = x + alpha * p
        r = r - alpha * Ap
        z = Minv * r
        rz_new = dot(r, z)
        beta = torch.where(live & (rz_new > floor) & (rz != 0),
                           rz_new / torch.where(rz != 0, rz, 1.0), zero)
        p = z + beta * p
        rz = rz_new
    return x


def _cg2_plain(D, b, Minv, x0, lam0, ud, scale, iters):
    """Plain version of K3b: (x, λ), each (B, H, W)."""
    x = _cg_plain(D, b, Minv, x0, iters)
    lam = _cg_plain(D, scale * (x - ud), Minv, lam0, iters)
    return x, lam


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------


def _check_cuda_planes(D, planes) -> tuple:
    """Validate what the kernels take; returns (B, H, W)."""
    if not D.is_cuda:
        raise ValueError(f"K3 runs on CPU (plain) or CUDA tensors, got "
                         f"device {D.device}")
    if D.ndim != 4 or D.shape[0] != 5:
        raise ValueError(f"D must be the (5, B, H, W) folded planes, got "
                         f"{tuple(D.shape)}")
    _, B, H, W = D.shape
    if H * W > 2 ** 28:
        raise ValueError(f"grid of {H}×{W} nodes is too large for K3")
    for t in (D, *planes):
        if t.dtype != torch.float32:
            raise TypeError(f"the CUDA K3 kernels take float32 planes, got "
                            f"{t.dtype}")
        if t.device != D.device or not t.is_contiguous():
            raise ValueError(f"K3 planes must be contiguous and on "
                             f"{D.device}")
    for t in planes:
        if tuple(t.shape) != (B, H, W):
            raise ValueError(f"K3 planes must be (B, H, W) = "
                             f"{(B, H, W)}, got {tuple(t.shape)}")
    return B, H, W


def _workspace(lib, B, H, W, device):
    per = lib.difffe_stencil_cg_work(H, W)
    if per == 0:
        return None
    return torch.empty(B * per, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# The cluster plan (K3a and K3b here, K4a and K4b in stencil3d_cg_kernel.py)
# ---------------------------------------------------------------------------

#: Blocks a cluster may have on the cluster route (16 is non-portable).
CLUSTER_SIZES = (1, 2, 4, 8, 16)
#: Nodes one thread of a cluster-route block holds at most, and threads a
#: block has at most (csrc/cg_cluster.cuh's kNodesPerThread and
#: kClusterMaxThreads: a thread keeps x, r and Ap in registers).
NODES_PER_THREAD = 8
MAX_THREADS = 640
# static shared memory of a cluster-route block (cg_cluster.cuh's
# kClusterStaticBytes): two 32-float reduction buffers, two 16-float tables
# of published partials, two 8-byte mbarriers
_CLUSTER_STATIC_BYTES = 4 * (2 * 32 + 2 * 16) + 2 * 8
# shared bytes a node on the cluster route beside its planes: p (two
# buffers) and r in f32
_VEC_BYTES = 12
# the hardware keeps 1 KB of an SM's shared memory for each resident block,
# and an SM holds a block's opt-in limit plus that 1 KB (H100: 233 472 =
# 232 448 + 1024 bytes)
_SMEM_RESERVED = 1024


@dataclasses.dataclass(frozen=True)
class ClusterPlan:
    """How K3b, K4a, K4b or K8s runs one shape.

    ``route`` is ``"cluster"`` (``csrc/cg_cluster.cuh``: a cluster of
    ``cluster`` blocks of ``threads`` threads a scenario, rank k owning
    nodes ``[k·chunk, min(nodes, (k+1)·chunk))`` with their planes, M⁻¹ and
    CG vectors in ``block_bytes`` of shared memory, ``blocks_per_sm`` such
    blocks to an SM), ``"workspace"`` (K3b/K4a/K4b: ``csrc/cg_common.cuh``'s
    one block a scenario, the CG vectors in a global workspace) or
    ``"per_iteration"`` (K8s: one K8 launch an operator application);
    ``cluster`` is 0 off the cluster route."""
    route: str
    nodes: int
    cluster: int
    chunk: int
    block_bytes: int
    blocks_per_sm: int
    threads: int

    def ranges(self) -> list:
        """Each rank's node range [lo, hi), in rank order."""
        return [(min(self.nodes, k * self.chunk),
                 min(self.nodes, (k + 1) * self.chunk))
                for k in range(self.cluster)]


def cluster_layout(nodes: int, planes: int, itemsize: int, cluster: int,
                   smem_limit: int) -> ClusterPlan:
    """The cluster route at ``cluster`` blocks a scenario for ``nodes``
    nodes, ``planes`` coefficient planes plus M⁻¹ of ``itemsize`` bytes,
    on a card whose blocks may opt in to ``smem_limit`` bytes of shared
    memory.  A block takes up to 640 threads (the kernel's bound, which
    leaves a thread 96 registers) when one block fills an SM's shared
    memory, else up to 320 (so that two fit an SM's 64k registers), and as
    few as hold its nodes at the same count a thread, at most
    ``NODES_PER_THREAD``.  Raises if a block does not fit."""
    if cluster not in CLUSTER_SIZES:
        raise ValueError(f"cluster size {cluster} is not one of "
                         f"{CLUSTER_SIZES}")
    chunk = -(-nodes // cluster)
    block = (chunk * (_VEC_BYTES + (planes + 1) * itemsize)
             + _CLUSTER_STATIC_BYTES)
    per_sm = (smem_limit + _SMEM_RESERVED) // (block + _SMEM_RESERVED)
    per_thread = -(-chunk // (MAX_THREADS if per_sm == 1
                              else MAX_THREADS // 2))
    if block > smem_limit or per_thread > NODES_PER_THREAD:
        raise ValueError(f"{nodes} nodes in clusters of {cluster}: "
                         f"{block} bytes a block exceed the card's "
                         f"{smem_limit}, or {per_thread} nodes a thread "
                         f"exceed {NODES_PER_THREAD}")
    threads = 32 * -(-chunk // (32 * per_thread))
    return ClusterPlan("cluster", nodes, cluster, chunk, block, per_sm,
                       threads)


def cluster_plan(nodes: int, planes: int, itemsize: int,
                 smem_limit: int) -> ClusterPlan:
    """K3a's, K3b's, K4a's and K4b's route for a shape, from the shape
    alone (a one-solve and a two-solve kernel hold the same bytes a
    block).

    The rule: the smallest cluster size whose block fits the card's
    shared memory and its threads' registers; failing that (more than 16
    blocks' worth: past 16 · 8 · 640 = 81 920 nodes, grids past 285²
    and boxes past 42³), the workspace route.  The card
    chose it: at 32³ f32 C = 8 (one block an SM) beat C = 16 (two blocks
    an SM), and at 64² C = 1 beat C = 2 (PERF.md §5 has the times).
    ``planes`` is 5 (K3b) or 7 (K4b), ``itemsize`` that of the stored
    planes (4, or 2 for K4b's bf16 route)."""
    for c in CLUSTER_SIZES:
        try:
            return cluster_layout(nodes, planes, itemsize, c, smem_limit)
        except ValueError:
            continue
    return workspace_plan(nodes)


def workspace_plan(nodes: int) -> ClusterPlan:
    """The workspace route: cg_common.cuh's one block a scenario."""
    return ClusterPlan("workspace", nodes, 0, nodes, 0, 0, 0)


@functools.lru_cache(maxsize=None)
def smem_optin(device_index: int) -> int:
    """Shared memory a block may opt in to on the card, asked once a
    device."""
    from ._build import load_library

    with torch.cuda.device(device_index):
        return int(load_library().difffe_smem_optin())


_SCHEDULABLE = set()


def check_schedulable(query, key, plan: ClusterPlan, device) -> None:
    """Ask the card once per shape, cluster size and device whether it can
    hold a cluster of ``plan`` (``query(cluster, threads)`` is the kernel's
    ``cudaOccupancyMaxActiveClusters``); raise if it cannot."""
    key = (device.index, key, plan.cluster, plan.threads)
    if key in _SCHEDULABLE:
        return
    with torch.cuda.device(device):
        active = query(plan.cluster, plan.threads)
    if active <= 0:
        raise RuntimeError(
            f"the card cannot schedule a cluster of {plan.cluster} blocks of "
            f"{plan.threads} threads with {plan.block_bytes} bytes of shared "
            f"memory each (cudaOccupancyMaxActiveClusters: {active})")
    _SCHEDULABLE.add(key)


def forced_cluster(plan: Optional[ClusterPlan]):
    """A forced plan as the ops take it: None (the plan's own choice), 0
    (the workspace route) or the cluster size."""
    return None if plan is None else plan.cluster


def _plan_cg2(D, H, W, cluster):
    """K3a's and K3b's plan (their blocks hold the same bytes), or the one
    ``cluster`` forces."""
    smem = smem_optin(D.device.index)
    if cluster is None:
        return cluster_plan(H * W, 5, 4, smem)
    if cluster == 0:
        return workspace_plan(H * W)
    return cluster_layout(H * W, 5, 4, cluster, smem)


def _cuda_cg(D, b, Minv, x0, iters, cluster):
    """K3a on CUDA tensors, the op's CUDA implementation."""
    from ._build import load_library

    B, H, W = _check_cuda_planes(D, (b, Minv, x0))
    out = torch.empty_like(b)
    if B == 0:
        return out
    lib = load_library()
    plan = _plan_cg2(D, H, W, cluster)
    work = None
    if plan.route == "cluster":
        check_schedulable(
            lambda c, t: lib.difffe_stencil_cg_clusters(H, W, c, t),
            ("cg", H, W), plan, D.device)
    else:
        work = _workspace(lib, B, H, W, D.device)
    with torch.cuda.device(D.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.difffe_stencil_cg(
            D.data_ptr(), b.data_ptr(), Minv.data_ptr(), x0.data_ptr(),
            out.data_ptr(), None if work is None else work.data_ptr(),
            B, H, W, int(iters), plan.cluster, plan.threads, stream)
    if rc != 0:
        raise RuntimeError(f"K3a stencil_cg launch failed ({plan.route} "
                           f"route, cluster {plan.cluster}): CUDA error {rc}")
    launches["cg" if plan.route == "cluster" else "cg_workspace"] += 1
    return out


def _cuda_cg2(D, b, Minv, x0, lam0, ud, scale, iters, cluster):
    """K3b on CUDA tensors, the op's CUDA implementation."""
    from ._build import load_library

    B, H, W = _check_cuda_planes(D, (b, Minv, x0, lam0, ud))
    x = torch.empty_like(b)
    lam = torch.empty_like(b)
    if B == 0:
        return x, lam
    lib = load_library()
    plan = _plan_cg2(D, H, W, cluster)
    work = None
    if plan.route == "cluster":
        check_schedulable(
            lambda c, t: lib.difffe_stencil_cg2_clusters(H, W, c, t),
            ("cg2", H, W), plan, D.device)
    else:
        work = _workspace(lib, B, H, W, D.device)
    with torch.cuda.device(D.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.difffe_stencil_cg2(
            D.data_ptr(), b.data_ptr(), Minv.data_ptr(), x0.data_ptr(),
            lam0.data_ptr(), ud.data_ptr(), x.data_ptr(), lam.data_ptr(),
            None if work is None else work.data_ptr(),
            B, H, W, int(iters), float(scale), plan.cluster, plan.threads,
            stream)
    if rc != 0:
        raise RuntimeError(f"K3b stencil_cg2 launch failed ({plan.route} "
                           f"route, cluster {plan.cluster}): CUDA error {rc}")
    launches["cg2" if plan.route == "cluster" else "cg2_workspace"] += 1
    return x, lam


def _fresh(x, like):
    """An op's output never aliases its input (zero iterations return the
    start)."""
    return x.clone() if x is like else x


#: K3a as the op ``difffe::stencil_cg(D, b, Minv, x0, iters, cluster)``
stencil_cg = kernel_op(
    "stencil_cg", "(Tensor D, Tensor b, Tensor Minv, Tensor x0, int iters, "
                  "int? cluster) -> Tensor",
    lambda D, b, Minv, x0, iters, cluster: _fresh(
        _cg_plain(D, b, Minv, x0, iters), x0),
    _cuda_cg, lambda D, b, *_: torch.empty_like(b))


def _cg2_cpu(D, b, Minv, x0, lam0, ud, scale, iters, cluster):
    x, lam = _cg2_plain(D, b, Minv, x0, lam0, ud, scale, iters)
    return _fresh(x, x0), _fresh(lam, lam0)


#: K3b as the op ``difffe::stencil_cg2(D, b, Minv, x0, lam0, ud, scale,
#: iters, cluster)`` → (x, λ)
stencil_cg2 = kernel_op(
    "stencil_cg2", "(Tensor D, Tensor b, Tensor Minv, Tensor x0, "
                   "Tensor lam0, Tensor ud, float scale, int iters, "
                   "int? cluster) -> (Tensor, Tensor)",
    _cg2_cpu, _cuda_cg2,
    lambda D, b, *_: (torch.empty_like(b), torch.empty_like(b)))


def _launch_cg(D, b, Minv, x0, iters, plan: Optional[ClusterPlan] = None):
    """K3a through ``difffe::stencil_cg``, on ``plan``'s route (default
    :func:`cluster_plan`'s for the shape, K3b's; the tests and
    chip_smoke.py pass another to compare routes and cluster sizes)."""
    return stencil_cg(D, b, Minv, x0, int(iters), forced_cluster(plan))


def _launch_cg2(D, b, Minv, x0, lam0, ud, scale, iters,
                plan: Optional[ClusterPlan] = None):
    """K3b through ``difffe::stencil_cg2``, on ``plan``'s route (default
    :func:`cluster_plan`'s for the shape; the tests and chip_smoke.py pass
    another to compare routes and cluster sizes)."""
    return stencil_cg2(D, b, Minv, x0, lam0, ud, float(scale), int(iters),
                       forced_cluster(plan))


def _check_block_b(block_b):
    if int(block_b) < 1:
        raise ValueError(f"block_b must be >= 1, got {block_b}")


def _check_device(D):
    if D.device.type not in ("cpu", "cuda"):
        raise ValueError(f"K3 runs on CPU (plain) or CUDA tensors, got "
                         f"device {D.device}")


def _cg(D, b, Minv, x0, iters: int, block_b: int = 1):
    """K3a: ``iters`` fixed PCG iterations per scenario.

    D: (5, B, H, W) folded planes; b/Minv/x0: (B, H, W).  Plain version on
    CPU tensors, the kernel on CUDA."""
    _check_block_b(block_b)
    _check_device(D)
    return _launch_cg(D, b, Minv, x0, iters)


def _cg2(D, b, Minv, x0, lam0, ud, scale: float, iters: int,
         block_b: int = 8):
    """K3b: forward solve from x0, ḡ = scale·(x − u_data), adjoint solve
    from λ0.  Returns (x, λ).  Plain version on CPU tensors, the kernel on
    CUDA."""
    _check_block_b(block_b)
    _check_device(D)
    return _launch_cg2(D, b, Minv, x0, lam0, ud, scale, iters)


# ---------------------------------------------------------------------------
# Operand preparation
# ---------------------------------------------------------------------------


def _fold_bc_planes(C, m):
    """Fold the BC elimination into the stencil: A(v) = m⊙v + p⊙K(p⊙v) is
    itself a stencil with planes D_0 = m + p·C_0·p and
    D_k = p·C_k·shift(p, off_k).  Folds as many planes as C has (…, k,
    H, W) → (k, …, H, W)."""
    p = 1.0 - m
    planes = [m + p * C[..., 0, :, :] * p]
    for k in range(1, C.shape[-3]):
        dr, dc = OFFSETS[k]
        planes.append(p * C[..., k, :, :] * _shift2d(p, dr, dc))
    return torch.stack(planes, dim=0)


def _prepare(grid: StructuredGrid, kappa_lu, f, g):
    """Kernel inputs: (C (B', 7, H, W), D (5, B, H, W), b, M⁻¹, x0, B),
    the last three (B, H, W), all contiguous.  The backward pass reuses
    C, D and M⁻¹, so it never re-assembles."""
    kl, ku = kappa_lu
    C = stencil_coefficients(grid, kl, ku)
    if C.ndim == 3:
        C = C[None]
    if f.ndim == 2:
        f = f[None]
    B = max(C.shape[0], f.shape[0])
    H, W = grid.node_shape
    m = boundary_mask_grid(grid, f.dtype, f.device)
    p = 1.0 - m
    F = load_grid(grid, f)
    mg = m * g
    b = (mg + p * (F - stencil_apply(C, mg))).expand(B, H, W).contiguous()
    diagA = m + p * C[:, 0]
    Minv = (1.0 / torch.where(diagA.abs() > 1e-30, diagA, 1.0)).expand(
        B, H, W).contiguous()
    x0 = mg.expand(B, H, W).contiguous()
    D = _fold_bc_planes(C[:, :5].expand(B, 5, H, W), m).contiguous()
    return C, D, b, Minv, x0, B


# ---------------------------------------------------------------------------
# Differentiable solve
# ---------------------------------------------------------------------------


class _SolveStructuredKernel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, grid, iters, block_b, kl, ku, f, g):
        C, D, b, Minv, x0, B = _prepare(grid, (kl, ku), f, g)
        x = _cg(D, b, Minv, x0, iters, block_b)
        unbatched = f.ndim == 2 and x.shape[0] == 1
        u = x[0] if unbatched else x
        ctx.cfg = (grid, iters, block_b, B)
        ctx.prepared = (C, D, Minv)
        ctx.save_for_backward(kl, ku, f, g, u)
        return u

    @staticmethod
    def backward(ctx, gbar):
        # first order only, as the JAX custom VJP: refuse a graph of this
        # backward (create_graph) outright, since one that skipped λ's
        # dependence on κ would give wrong second derivatives without a word
        if torch.is_grad_enabled():
            raise NotImplementedError(
                "the K3a route (solve_structured_kernel) is differentiable "
                "once: its backward takes no create_graph; use "
                "solve_poisson_structured for higher derivatives")
        grid, iters, block_b, B = ctx.cfg
        C, D, Minv = ctx.prepared
        kl, ku, f, g, u = ctx.saved_tensors
        # adjoint solve through the same kernel: A λ = ḡ (A symmetric, zero
        # initial guess) on the forward's prepared planes
        H, W = grid.node_shape
        gb = gbar if gbar.ndim == 3 else gbar[None]
        gb = gb.expand(B, H, W).contiguous()
        lam = _cg(D, gb, Minv, torch.zeros_like(gb), iters, block_b)
        if gbar.ndim == 2:
            lam = lam[0]
        Cr = C[0] if (C.shape[0] == 1 and gbar.ndim == 2) else C
        (gl, gu), gf, gg = residual_vjp_manual(grid, (kl, ku), f, g, u, lam,
                                               C=Cr)
        return None, None, None, gl, gu, gf, gg


def solve_structured_kernel(grid: StructuredGrid, kappa_lu, f: torch.Tensor,
                            g: torch.Tensor, iters: int = 128,
                            block_b: int = 8) -> torch.Tensor:
    """Batched structured-grid Poisson solve on the whole-CG kernel K3a.

    kappa_lu: (κ_lower, κ_upper) with shapes (ny, nx) or (B, ny, nx);
    f: (ny+1, nx+1) or (B, ny+1, nx+1); g: (ny+1, nx+1) Dirichlet values.
    Runs exactly ``iters`` PCG iterations per scenario (converged scenarios
    are NaN-safe).  Differentiable wrt κ, f and g: the backward runs one
    adjoint solve through K3a on the forward's prepared planes.
    """
    kl, ku = kappa_lu
    return _SolveStructuredKernel.apply(grid, int(iters), block_b, kl, ku,
                                        f, g)


# ---------------------------------------------------------------------------
# Gradient steps: one launch (K3b) or two (K3a twice)
# ---------------------------------------------------------------------------


def _grad_step(two_launch, grid, kappa_lu, f, g, u_data, scale, iters,
               block_b, warm_state, return_state):
    kl, ku = kappa_lu
    batched = kl.ndim == 3 or f.ndim == 3
    with torch.no_grad():
        C, D, b, Minv, x0, B = _prepare(grid, kappa_lu, f, g)
        H, W = grid.node_shape
        if scale is None:
            scale = 2.0 / (B * H * W)
        ud = (u_data if u_data.ndim == 3 else u_data[None]).expand(B, H, W)
        if warm_state is not None:
            x0, lam0 = warm_state
        else:
            lam0 = torch.zeros_like(b)
        if two_launch:
            x = _cg(D, b, Minv, x0, iters, block_b)
            gbar = (scale * (x - ud)).contiguous()
            lam = _cg(D, gbar, Minv, lam0, iters, block_b)
        else:
            x, lam = _cg2(D, b, Minv, x0, lam0, ud.contiguous(),
                          float(scale), iters, block_b)
        state = (x, lam)
        u = x
        diff = u - ud
        loss_parts = (diff * diff).sum(dim=(1, 2))
        if not batched and u.shape[0] == 1:
            u, lam = u[0], lam[0]
            C = C[0] if C.shape[0] == 1 else C
        grads = residual_vjp_manual(grid, kappa_lu, f, g, u, lam, C=C)
    if return_state:
        return loss_parts, grads[0], u, state
    return loss_parts, grads[0], u


def fused_kappa_mse_step_2d(grid: StructuredGrid, kappa_lu, f: torch.Tensor,
                            g: torch.Tensor, u_data: torch.Tensor,
                            scale: Optional[float] = None,
                            iters: int = 128, block_b: int = 8,
                            warm_state=None, return_state: bool = False):
    """Whole 2D κ-field MSE gradient step in one K3b launch.

    For loss = scale/2 · Σ_{b,ij} (u_b − u_data_b)²_{ij} with
    u_b = A(κ_b)⁻¹ b(f, g, κ_b) (default ``scale = 2/(B·H·W)``, the mean),
    returns ``(loss_parts (B,), (∂κ_lower, ∂κ_upper), u)`` [+ the warm
    state when ``return_state``].  Both CG solves (forward and IFT adjoint)
    run in one launch; κ cotangents come from the closed-form residual
    VJP.  Not differentiable: it is the gradient step.

    ``warm_state`` (a previous call's state) starts both solves from the
    previous (u, λ) instead of (m·g, 0); the state is the opaque (x, λ)
    pair of (B, H, W) planes.
    """
    return _grad_step(False, grid, kappa_lu, f, g, u_data, scale, iters,
                      block_b, warm_state, return_state)


def choose_2d_path(grid: StructuredGrid, block_b: int = 1,
                   itemsize: int = 4) -> str:
    """Pick the grad-step implementation for this grid: 'fused' (one K3b
    launch), 'two_launch' (two K3a launches) or 'xla' (the plain-tensor
    solve of ops/stencil.py).

    Always 'fused' on the card: K3b keeps a scenario's whole CG in a
    thread-block cluster's shared memory and registers up to 81 920
    nodes (285²) and runs the first design, CG vectors in a global
    workspace, beyond
    (:func:`cluster_plan`), so it takes every grid a (B, H, W) float32
    plane can hold (the TPU's VMEM budget, which split the paths there,
    has no counterpart).  ``block_b`` and
    ``itemsize`` keep the JAX signature and do not change the answer.
    """
    _check_block_b(block_b)
    return "fused"


def kappa_mse_step_2d_two_launch(grid: StructuredGrid, kappa_lu,
                                 f: torch.Tensor, g: torch.Tensor,
                                 u_data: torch.Tensor,
                                 scale: Optional[float] = None,
                                 iters: int = 128, block_b: int = 1,
                                 warm_state=None,
                                 return_state: bool = False):
    """``fused_kappa_mse_step_2d`` semantics via two K3a launches over the
    same prepared planes; identical outputs and warm-state contract."""
    return _grad_step(True, grid, kappa_lu, f, g, u_data, scale, iters,
                      block_b, warm_state, return_state)
