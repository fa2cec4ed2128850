"""Gather-only (edge-ELL) matrix-free operator for arbitrary P1 meshes.

PyTorch counterpart of ``difffe_tpu/ops/unstructured.py``.  The element
operator of ops/assembly.py (gather, local blocks, scatter-add) is laid
out again node by node in pull form, over fixed-width gather tables:

    (K u)[i] = diag_i(κ)·u_i + Σ_d W[i,d](κ)·u[nbr[i,d]]

``nbr[i,:]`` holds node i's mesh neighbours in ascending order (padded
with index 0 to the largest degree Dn), and κ is folded into the tables
once per solve:

    W[i,d]  = Σ_t κ[edge_elem[i,d,t]]·edge_w[i,d,t]   (the elements sharing
              edge (i, nbr[i,d]))
    diag_i  = Σ_t κ[inc_elem[i,t]]·wdiag[i,t]

so a CG iteration is one gather and one multiply-add over Dn, with no
scatter; padding slots carry zero weights.  The per-element κ gradient
needs one scatter per gradient step (the transpose of the κ fold), not
per iteration.  The tables are built on the host, once per mesh, in the
JAX package's order entry for entry, and live on ``mesh.device``.

:func:`solve_poisson_cg_ell` (batch-leading, any leading axes) is plain
torch on every device.  :func:`solve_poisson_cg_ell_batched` keeps the
batch as the minor axis, (n, B), and runs each forward and adjoint CG
solve of the Dirichlet-eliminated operator m⊙v + P·K(P·v) through
``ell_kernel.ell_cg`` (its plain version on CPU tensors): on the card a
float32 fixed-trip solve is one launch of kernel K8s, and float64 or
tol-gated solves take one launch of kernel K8 an operator application.
The right-hand side F − K(m·g) is one more K8 launch, so a float32
gradient step makes one K8 and two K8s launches.  Its backward writes
the residual map's VJP out by hand as torch ops: λ times the gathered
solution, then the scatter through ``edge_elem`` / ``inc_elem``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..mesh import FEMesh
from .assembly import kappa_on_elements, local_stiffness
from .cg import _IFTSolve, jacobi
from .kernels.ell_kernel import ell_apply as _k8, ell_apply_plain
from .kernels.ell_kernel import ell_cg as _ell_cg
from .solve import apply_dirichlet_operator, dirichlet_rhs


class ELL(NamedTuple):
    """Static gather tables for one mesh (module note), on its device."""
    nbr: torch.Tensor         # (n, Dn) int32, neighbour ids, 0-padded
    edge_elem: torch.Tensor   # (n, Dn, T) int32, elements on edge (i, nbr)
    edge_w: torch.Tensor      # (n, Dn, T) unit-κ off-diagonal weights
    inc_elem: torch.Tensor    # (n, Di) int32, elements incident to node i
    wdiag: torch.Tensor       # (n, Di) unit-κ diagonal weights


def _slots(keys: np.ndarray, n: int):
    """For sorted keys, each entry's position within its key's run and the
    longest run."""
    counts = np.bincount(keys, minlength=n)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    return np.arange(keys.size) - starts[keys], int(counts.max(initial=0))


def build_ell(mesh: FEMesh) -> ELL:
    """Build the gather tables on the host, once per mesh (unit κ: one
    table serves every κ and scenario).

    The order is the JAX package's: neighbours ascending, and the elements
    of an edge and of a node in ascending element order."""
    elems = mesh.elements.cpu().numpy()
    ne, k = elems.shape
    n = mesh.n_nodes
    ones = torch.ones(ne, dtype=mesh.dtype, device=mesh.device)
    G = local_stiffness(mesh, ones).detach().cpu().numpy()   # (ne, k, k)

    # diagonal: the (element, local index) pairs of each node
    node = elems.reshape(-1)
    order = np.argsort(node, kind="stable")       # element order kept
    inc_node = node[order]
    inc_e = order // k
    inc_p = order % k
    t_inc, Di = _slots(inc_node, n)
    inc_elem = np.zeros((n, Di), np.int32)
    wdiag = np.zeros((n, Di), G.dtype)
    inc_elem[inc_node, t_inc] = inc_e
    wdiag[inc_node, t_inc] = G[inc_e, inc_p, inc_p]

    # off-diagonal: every (i, j, e) with i ≠ j in element e
    e, p, q = np.meshgrid(np.arange(ne), np.arange(k), np.arange(k),
                          indexing="ij")
    off = p != q
    e, p, q = e[off], p[off], q[off]
    i, j = elems[e, p], elems[e, q]
    order = np.lexsort((e, j, i))
    i, j, e, p, q = i[order], j[order], e[order], p[order], q[order]
    new_pair = np.ones(i.size, bool)
    new_pair[1:] = (i[1:] != i[:-1]) | (j[1:] != j[:-1])
    pair = np.cumsum(new_pair) - 1
    pair_start = np.flatnonzero(new_pair)
    t = np.arange(i.size) - pair_start[pair]
    # d: the rank of j among node i's neighbours
    first_pair_of_i = pair[np.searchsorted(i, i, side="left")]
    d = pair - first_pair_of_i
    Dn = int(d.max(initial=-1)) + 1
    T = int(t.max(initial=0)) + 1
    nbr = np.zeros((n, max(Dn, 1)), np.int32)
    edge_elem = np.zeros((n, max(Dn, 1), T), np.int32)
    edge_w = np.zeros((n, max(Dn, 1), T), G.dtype)
    nbr[i, d] = j
    edge_elem[i, d, t] = e
    edge_w[i, d, t] = G[e, p, q]

    def dev(a, dtype=None):
        return torch.as_tensor(a, dtype=dtype, device=mesh.device)

    return ELL(dev(nbr), dev(edge_elem), dev(edge_w, mesh.dtype),
               dev(inc_elem), dev(wdiag, mesh.dtype))


def ell_weights(mesh: FEMesh, ell: ELL, kappa):
    """Fold κ into the tables once per solve → (W (…, n, Dn), diag
    (…, n))."""
    ke = kappa_on_elements(mesh, kappa)
    W = (ke[..., ell.edge_elem] * ell.edge_w).sum(dim=-1)
    diag = (ke[..., ell.inc_elem] * ell.wdiag).sum(dim=-1)
    return W, diag


def ell_apply_w(ell: ELL, W: torch.Tensor, diag: torch.Tensor,
                u: torch.Tensor) -> torch.Tensor:
    """K·u from folded weights: one (…, n, Dn) gather and one multiply-add
    over Dn."""
    return diag * u + (W * u[..., ell.nbr]).sum(dim=-1)


def ell_apply(mesh: FEMesh, ell: ELL, kappa, u: torch.Tensor) -> torch.Tensor:
    """K·u by gathers only, u (…, n) → (…, n); equal to
    ``stiffness_apply`` with the same κ."""
    W, diag = ell_weights(mesh, ell, kappa)
    return ell_apply_w(ell, W, diag, u)


def ell_diag(mesh: FEMesh, ell: ELL, kappa) -> torch.Tensor:
    """diag(K) for the Jacobi preconditioner, by gathers only."""
    ke = kappa_on_elements(mesh, kappa)
    return (ke[..., ell.inc_elem] * ell.wdiag).sum(dim=-1)


def _ell_system(mesh: FEMesh, ell: ELL):
    def system(bc_values, kappa, F):
        ms = dataclasses.replace(mesh, bc_values=bc_values)
        W, diag = ell_weights(ms, ell, kappa)    # once, not per iteration

        def applyK(w):
            return ell_apply_w(ell, W, diag, w)

        b = dirichlet_rhs(ms, applyK, F)
        return (lambda v: apply_dirichlet_operator(ms, applyK, v), b,
                jacobi(ms, diag), (ms.bc_mask * ms.bc_values).expand(
                    b.shape))
    return system


def solve_poisson_cg_ell(mesh: FEMesh, ell: ELL, kappa, F,
                         tol: float = 0.0,
                         maxiter: Optional[int] = None) -> torch.Tensor:
    """Matrix-free Jacobi-PCG Poisson solve on the gather-only operator:
    the semantics, implicit adjoint and fixed-trip ``tol=0`` mode of
    ops/cg.py's ``solve_poisson_cg``, F (…, n_nodes) assembled.  Plain
    torch on every device (the batch-minor solve below carries the card
    path).  Differentiable once wrt κ, F and the Dirichlet values (the
    geometry is baked into the tables: use ``solve_poisson_cg`` for
    ∂/∂nodes)."""
    maxiter = mesh.n_nodes if maxiter is None else maxiter
    opts = dict(dtype=mesh.dtype, device=mesh.device)
    return _IFTSolve.apply(_ell_system(mesh, ell), tol, maxiter,
                           mesh.bc_values, torch.as_tensor(kappa, **opts),
                           torch.as_tensor(F, **opts))


# ---------------------------------------------------------------------------
# Batch-minor batched solve: state (n, B), solves on kernels K8s and K8
# ---------------------------------------------------------------------------


def ell_weights_bm(mesh: FEMesh, ell: ELL, keB: torch.Tensor):
    """κ (ne, B) batch-minor → folded (W (n, Dn, B), diag (n, B))."""
    W = (keB[ell.edge_elem] * ell.edge_w[..., None]).sum(dim=-2)
    diag = (keB[ell.inc_elem] * ell.wdiag[..., None]).sum(dim=-2)
    return W.contiguous(), diag.contiguous()


def ell_apply_bm(ell: ELL, W: torch.Tensor, diag: torch.Tensor,
                 u: torch.Tensor) -> torch.Tensor:
    """K·u of batch-minor state, u (n, B) → (n, B), unmasked: K8's plain
    version with no mask."""
    return ell_apply_plain(ell.nbr, W, diag, u, u.new_zeros(u.shape[0]))


def _ell_bm_prep(mesh: FEMesh, kappa, F):
    """(κ (ne, B), F (n, B)) batch-minor views of the caller's κ and
    F (B, n_nodes)."""
    opts = dict(dtype=mesh.dtype, device=mesh.device)
    kappa = torch.as_tensor(kappa, **opts)
    F = torch.as_tensor(F, **opts)
    if F.ndim != 2:
        raise ValueError(f"batched ELL solve expects F (B, n_nodes); got "
                         f"{tuple(F.shape)}")
    B, ne = F.shape[0], mesh.n_elements
    if kappa.ndim == 1 and kappa.shape[0] == B:
        if B in (ne, mesh.n_nodes):
            raise ValueError(
                f"ambiguous 1-D kappa of length {B}: could be per-scenario "
                f"scalars (B={B}) or a shared field (n_elements={ne}, "
                f"n_nodes={mesh.n_nodes}) — pass kappa as (B, n_elements) "
                f"explicitly")
        keB = kappa[None, :].expand(ne, B)
    else:
        keB = kappa_on_elements(mesh, kappa).expand(B, ne).T
    return keB, F.T


class _EllBatchedSolve(torch.autograd.Function):
    """u (n, B) of the batch-minor fixed-trip or tol-gated PCG on
    ``ell_cg``'s route (one K8s launch, or one K8 launch an operator
    application), after one K8 launch for the right-hand side; backward:
    the adjoint PCG on the same route, then the residual map's VJP written
    out (module note)."""

    @staticmethod
    def forward(ctx, keB, Fbm, g, mesh, ell, tol, maxiter):
        W, diag = ell_weights_bm(mesh, ell, keB)
        m = mesh.bc_mask.contiguous()
        mg = (m * g)[:, None]
        # F arrives as a transposed view: one copy, so the CG state derived
        # from it is (n, B) in place for every elementwise op and K8 launch
        Fbm = Fbm.contiguous()
        # right-hand side P(F − K(m·g)): one more K8 launch, unmasked
        Kmg = _k8(ell.nbr, W, diag, mg.expand(Fbm.shape).contiguous(),
                  torch.zeros_like(m))
        u = mg + _ell_cg(ell.nbr, W, diag, m,
                         (1.0 - m[:, None]) * (Fbm - Kmg), tol, maxiter)
        ctx.cfg = (mesh, ell, tol, maxiter)
        ctx.save_for_backward(u, W, diag, g)
        return u

    @staticmethod
    def backward(ctx, gbar):
        if torch.is_grad_enabled():
            raise NotImplementedError(
                "the batched ELL solve is differentiable once: its "
                "backward takes no create_graph")
        mesh, ell, tol, maxiter = ctx.cfg
        u, W, diag, g = ctx.saved_tensors
        m = mesh.bc_mask.contiguous()
        mc = m[:, None]
        p = 1.0 - mc
        lam = _ell_cg(ell.nbr, W, diag, m, gbar.contiguous(), tol, maxiter)
        pl = p * lam
        g_ke = g_F = g_g = None
        if ctx.needs_input_grad[0]:
            # R ∋ −p·(diag·w + Σ_d W·w[nbr]) with w = m·g + p·u: λᵀ∂R is
            # the outer product of −pλ with the gathered w, then the
            # transpose of the κ fold (one scatter each)
            w = mc * g[:, None] + p * u
            B = u.shape[1]
            gW = -(pl[:, None, :] * w[ell.nbr])             # (n, Dn, B)
            gdiag = -(pl * w)                               # (n, B)
            g_ke = u.new_zeros((mesh.n_elements, B))
            g_ke.index_add_(0, ell.edge_elem.reshape(-1).long(),
                            (gW[:, :, None, :]
                             * ell.edge_w[..., None]).reshape(-1, B))
            g_ke.index_add_(0, ell.inc_elem.reshape(-1).long(),
                            (gdiag[:, None, :]
                             * ell.wdiag[..., None]).reshape(-1, B))
        if ctx.needs_input_grad[1]:
            g_F = pl
        if ctx.needs_input_grad[2]:
            # R = m·(g − u) + p·(F − K(m·g + p·u)), K symmetric
            Kpl = _k8(ell.nbr, W, diag, pl.contiguous(), torch.zeros_like(m))
            g_g = (mc * (lam - Kpl)).sum(dim=1)
        return g_ke, g_F, g_g, None, None, None, None


def solve_poisson_cg_ell_batched(mesh: FEMesh, ell: ELL, kappa, F,
                                 tol: float = 0.0,
                                 maxiter: Optional[int] = None
                                 ) -> torch.Tensor:
    """Batched edge-ELL solve with the batch as the minor axis.

    kappa: (B, n_elements) or (B, n_nodes) per-scenario fields, (B,)
    scalars, or one shared field; F: (B, n_nodes) assembled loads.
    Returns u (B, n_nodes), the same as :func:`solve_poisson_cg_ell` on
    each scenario.  On the card a float32 fixed-trip (``tol = 0``) forward
    or adjoint solve is one K8s launch; float64 and tol-gated solves launch
    K8 once an operator application.  Differentiable once wrt κ, F and the
    Dirichlet values."""
    maxiter = mesh.n_nodes if maxiter is None else maxiter
    keB, Fbm = _ell_bm_prep(mesh, kappa, F)
    u = _EllBatchedSolve.apply(keB, Fbm, mesh.bc_values, mesh, ell, tol,
                               maxiter)
    return u.T
