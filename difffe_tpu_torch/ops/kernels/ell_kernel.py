"""Kernels K8 and K8s: the masked edge-ELL operator, one application or
a whole CG solve a launch, in the batch-minor layout.

The general-mesh CG of ops/unstructured.py solves, for each of B
scenarios, with the Dirichlet-eliminated operator

    y[i,b] = m_i·v[i,b] + p_i·(diag[i,b]·p_i·v[i,b]
                               + Σ_d W[i,d,b]·p_j·v[j,b]),   j = nbr[i,d]

and p = 1 − m: the K̃v = m⊙v + P·K(P·v) of ``_ell_bm_impl`` in
``difffe_tpu/ops/unstructured.py``, on the Jacobi PCG of
``difffe_tpu/ops/pcg.py``.  The operator's core is the row gather-sum
Σ_d u[idx[i,d], :] of the TPU probe kernel ``try_kernel`` in
``scripts/probe_mosaic_gather.py`` (P1), which Mosaic could not lower, so
the TPU package left this operator to XLA's gathers; with W ≡ 1, diag ≡ 0
and m ≡ 0 the function of K8 is exactly P1's.

Shapes: nbr (n, Dn) int32, W (n, Dn, B), diag (n, B), v (n, B), m (n,)
(FEMesh's 0/1 ``bc_mask``); padding slots carry W = 0 at index 0.

Two wrappers, each with a plain PyTorch version, taken only for CPU
tensors and the reference the kernel is checked against:

* :func:`ell_apply`, kernel K8 (``csrc/ell_apply.cu``): one operator
  application, float32 or float64, on one of two bodies that give the
  same bits (:func:`k8_body` picks one from B and the planes' alignment):
  ``"vec4"``, four adjacent scenarios a thread with 16-byte loads and
  stores, where B % 4 == 0 and the planes sit on 16-byte boundaries;
  ``"scalar"``, the first design, one thread per (i, b), otherwise;
* :func:`ell_cg`, kernel K8s (``csrc/ell_cg.cu``): a whole fixed-trip
  Jacobi-PCG solve from 0 in one launch, one thread-block cluster a
  scenario with its W slots, diagonal, M⁻¹ and CG state on the chip
  (``csrc/cg_cluster.cuh``).  Its route comes from the dtype, ``tol``
  and the shape alone (:func:`ell_cluster_plan`): float32, ``tol == 0``
  and a shape the plan admits take K8s; float64, tol-gated solves and
  shapes past the plan's reach take the per-iteration route, the plain
  version's PCG with one K8 launch an operator application.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..pcg import pcg
from .stencil_cg_kernel import (CLUSTER_SIZES, ClusterPlan,
                                check_schedulable, cluster_layout,
                                smem_optin)

#: Kernel launches made by the wrappers: "ell_apply" K8, "ell_cg" K8s.
launches = {"ell_apply": 0, "ell_cg": 0}
#: K8's launches by body (each also counted as "ell_apply" above).
body_launches = {"vec4": 0, "scalar": 0}
#: K8's bodies: "vec4" four scenarios a thread, "scalar" the first design.
K8_BODIES = ("vec4", "scalar")
# The four-scenario body's 32-bit indices: fewer values of W (and of v).
_VEC4_MAX_VALUES = 2 ** 31
#: The most neighbour slots K8s takes (csrc/ell_cg.cu's kEllMaxSlots: its
#: apply is unrolled to 8 or 16 slots).
ELL_MAX_SLOTS = 16


def ell_apply_plain(nbr, W, diag, v, m):
    """Plain version of K8: diag·pv + (W·pv[nbr]).sum(1) under the mask."""
    mc = m[:, None]
    p = 1.0 - mc
    pv = p * v
    return mc * v + p * (diag * pv + (W * pv[nbr]).sum(dim=1))


def _check(nbr, W, diag, v, m, what="K8",
           dtypes=(torch.float32, torch.float64)):
    n, B = v.shape
    Dn = nbr.shape[1]
    if v.dtype not in dtypes:
        names = " or ".join(str(d).split(".")[1] for d in dtypes)
        raise TypeError(f"the CUDA {what} kernel takes {names}, got "
                        f"{v.dtype}")
    for name, t, shape in (("W", W, (n, Dn, B)), ("diag", diag, (n, B)),
                           ("m", m, (n,))):
        if t.dtype != v.dtype or t.device != v.device:
            raise ValueError(f"{what}: {name} must share v's dtype and "
                             f"device")
        if tuple(t.shape) != shape:
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
    if nbr.dtype != torch.int32 or nbr.device != v.device:
        raise ValueError(f"{what}: nbr must be int32 on v's device")
    for name, t in (("nbr", nbr), ("W", W), ("diag", diag), ("v", v),
                    ("m", m)):
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def k8_body(n: int, Dn: int, B: int, ptrs, body=None) -> str:
    """K8's body for n nodes, Dn slots and B scenarios whose planes (W,
    diag, v, y) start at the addresses ``ptrs``: ``"vec4"`` where B % 4 ==
    0, every address is a multiple of 16 and W (and v) hold fewer than
    2^31 values, ``"scalar"`` otherwise.  ``body`` forces either (tests
    and chip_smoke.py) and is refused where the four-scenario body cannot
    take the shape."""
    fits = (B % 4 == 0 and n * max(Dn, 1) * B < _VEC4_MAX_VALUES
            and all(p % 16 == 0 for p in ptrs))
    if body is None:
        return "vec4" if fits else "scalar"
    if body not in K8_BODIES:
        raise ValueError(f"K8 body must be 'vec4' or 'scalar', got {body!r}")
    if body == "vec4" and not fits:
        raise ValueError(f"K8's vec4 body takes B % 4 == 0, 16-byte-aligned "
                         f"planes and fewer than 2^31 values of W; got "
                         f"n = {n}, Dn = {Dn}, B = {B}")
    return body


def ell_apply(nbr: torch.Tensor, W: torch.Tensor, diag: torch.Tensor,
              v: torch.Tensor, m: torch.Tensor, body=None) -> torch.Tensor:
    """The masked operator y (n, B) of the module note: the plain version
    on CPU tensors, kernel K8 on CUDA tensors, on the body :func:`k8_body`
    picks (``body`` forces one)."""
    if v.ndim != 2 or nbr.ndim != 2 or nbr.shape[0] != v.shape[0]:
        raise ValueError(f"K8 takes v (n, B) and nbr (n, Dn), got "
                         f"{tuple(v.shape)} and {tuple(nbr.shape)}")
    if v.device.type == "cpu":
        return ell_apply_plain(nbr, W, diag, v, m)
    if not v.is_cuda:
        raise ValueError(f"K8 runs on CPU (plain) or CUDA tensors, got "
                         f"device {v.device}")
    from ._build import load_library

    _check(nbr, W, diag, v, m)
    n, B = v.shape
    y = torch.empty_like(v)
    planes = (W.data_ptr(), diag.data_ptr(), v.data_ptr(), y.data_ptr())
    body = k8_body(n, nbr.shape[1], B, planes, body)
    fn = load_library().difffe_ell_apply
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(nbr.data_ptr(), W.data_ptr(), diag.data_ptr(), v.data_ptr(),
                m.data_ptr(), y.data_ptr(), n, nbr.shape[1], B,
                int(body == "vec4"), int(v.dtype == torch.float64), stream)
    if rc != 0:
        raise RuntimeError(f"K8 ell_apply launch failed: CUDA error {rc}")
    launches["ell_apply"] += 1
    body_launches[body] += 1
    return y


# ---------------------------------------------------------------------------
# K8s: the whole solve
# ---------------------------------------------------------------------------


def _dot_nodes(u, v):
    """Per-scenario inner product of (n, B) batch-minor CG state."""
    return (u * v).sum(dim=0, keepdim=True)


def _pcg_bm(apply, nbr, W, diag, m, b, tol, maxiter):
    """PCG from 0 on the eliminated operator ``apply`` (K8 or its plain
    version) for the right-hand side b (n, B), per-scenario dots."""
    mc = m[:, None]
    p = 1.0 - mc
    diagA = mc + p * diag
    Minv = 1.0 / torch.where(diagA.abs() > 1e-30, diagA,
                             torch.ones_like(diagA))
    return pcg(lambda v: apply(nbr, W, diag, v.contiguous(), m), b,
               lambda r: Minv * r, torch.zeros_like(b), tol, maxiter,
               dot=_dot_nodes)


def ell_cg_plain(nbr, W, diag, m, b, tol, maxiter):
    """Plain version of K8s: ``ops/pcg.pcg`` from 0 with per-scenario dots
    on K8's plain version, M⁻¹ = 1 / (m + p·diag) (1 where that is below
    1e-30 in magnitude): with ``tol = 0`` exactly ``maxiter`` iterations,
    the noise-floor freeze and 0/0 → 0 of the kernel."""
    return _pcg_bm(ell_apply_plain, nbr, W, diag, m, b, tol, maxiter)


def per_iteration_plan(nodes: int) -> ClusterPlan:
    """The per-iteration route: one K8 launch an operator application."""
    return ClusterPlan("per_iteration", nodes, 0, nodes, 0, 0, 0)


def ell_cluster_layout(nodes: int, Dn: int, cluster: int,
                       smem_limit: int) -> ClusterPlan:
    """K8s at ``cluster`` blocks a scenario: a block holds p (two buffers)
    and r, the Dn W slots, m + p·diag and M⁻¹ of its nodes in f32,
    chunk·(12 + (Dn + 2)·4) bytes.  Threads as ``cluster_layout``; raises
    if a block does not fit or Dn exceeds ``ELL_MAX_SLOTS``."""
    if not 1 <= Dn <= ELL_MAX_SLOTS:
        raise ValueError(f"K8s takes 1 to {ELL_MAX_SLOTS} neighbour slots, "
                         f"got {Dn}")
    return cluster_layout(nodes, Dn + 1, 4, cluster, smem_limit)


def ell_cluster_plan(nodes: int, Dn: int, itemsize: int, smem_limit: int,
                     tol: float = 0.0) -> ClusterPlan:
    """K8s's route for ``nodes`` nodes and ``Dn`` slots, from the dtype's
    ``itemsize``, ``tol`` and the shape alone.

    The rule: float32 (itemsize 4) fixed-trip (``tol == 0``) solves take
    the cluster route at the smallest cluster size whose block fits the
    card's shared memory and its threads' registers; float64, tol-gated
    solves, more than ``ELL_MAX_SLOTS`` slots and shapes past 16 blocks'
    worth take the per-iteration route.  The card chose it (chip_smoke
    phase 23 times every cluster size, PERF.md §5): at 64² (Dn = 6) and on
    the 16³ tet box (Dn = 14) each doubling of C made a solve slower, since
    every extra rank adds a cross-SM dot and remote reads to an
    iteration."""
    if itemsize == 4 and tol == 0.0 and Dn <= ELL_MAX_SLOTS:
        for c in CLUSTER_SIZES:
            try:
                return ell_cluster_layout(nodes, Dn, c, smem_limit)
            except ValueError:
                continue
    return per_iteration_plan(nodes)


def _launch_ell_cg(nbr, W, diag, m, b, iters, plan: ClusterPlan):
    from ._build import load_library

    _check(nbr, W, diag, b, m, "K8s", (torch.float32,))
    n, B = b.shape
    Dn = nbr.shape[1]
    if plan.route != "cluster" or plan.nodes != n:
        raise ValueError(f"K8s takes a cluster plan for {n} nodes, got "
                         f"{plan}")
    x = torch.empty_like(b)
    if B == 0:
        return x
    lib = load_library()
    check_schedulable(lambda c, t: lib.difffe_ell_cg_clusters(n, Dn, c, t),
                      ("ell_cg", n, Dn), plan, b.device)
    # the kernel reads a node's indices as 16-byte loads of a row padded to
    # 8 or 16 slots
    nbrP = torch.nn.functional.pad(nbr, (0, (8 if Dn <= 8 else 16) - Dn))
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.difffe_ell_cg(nbrP.data_ptr(), W.data_ptr(),
                               diag.data_ptr(), m.data_ptr(), b.data_ptr(),
                               x.data_ptr(), n, Dn, B, int(iters),
                               plan.cluster, plan.threads, stream)
    if rc != 0:
        raise RuntimeError(f"K8s ell_cg launch failed (cluster "
                           f"{plan.cluster}): CUDA error {rc}")
    launches["ell_cg"] += 1
    return x


def ell_cg(nbr: torch.Tensor, W: torch.Tensor, diag: torch.Tensor,
           m: torch.Tensor, b: torch.Tensor, tol: float, maxiter: int,
           plan: Optional[ClusterPlan] = None) -> torch.Tensor:
    """x (n, B): the Jacobi-PCG solve from 0 of the masked operator for the
    right-hand side b (n, B), ``maxiter`` iterations (``tol == 0``) or
    fewer (tol-gated).  The plain version on CPU tensors; on CUDA tensors
    the route of ``plan`` (default :func:`ell_cluster_plan`'s for b's dtype,
    ``tol`` and the shape; the tests and chip_smoke.py pass another to
    compare routes and cluster sizes): one K8s launch, or the per-iteration
    route on K8."""
    if b.ndim != 2 or nbr.ndim != 2 or nbr.shape[0] != b.shape[0]:
        raise ValueError(f"K8s takes b (n, B) and nbr (n, Dn), got "
                         f"{tuple(b.shape)} and {tuple(nbr.shape)}")
    if b.device.type == "cpu":
        return ell_cg_plain(nbr, W, diag, m, b, tol, maxiter)
    if not b.is_cuda:
        raise ValueError(f"K8s runs on CPU (plain) or CUDA tensors, got "
                         f"device {b.device}")
    plan = plan or ell_cluster_plan(b.shape[0], nbr.shape[1],
                                    b.element_size(),
                                    smem_optin(b.device.index), tol)
    if plan.route == "per_iteration":
        return _pcg_bm(ell_apply, nbr, W, diag, m, b, tol, maxiter)
    if tol != 0.0:
        raise ValueError(f"K8s runs fixed-trip solves (tol = 0), got tol = "
                         f"{tol}")
    return _launch_ell_cg(nbr, W, diag, m, b, maxiter, plan)
