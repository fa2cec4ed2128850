"""Robin (third-kind) boundary conditions κ∂u/∂n + αu = r.

PyTorch counterpart of ``difffe_tpu/ops/robin.py``.  The Robin boundary
adds ∮αuv ds to the stiffness and ∮rv ds to the load, kept as a COO
triplet (rows, cols, vals) plus a load vector; α and r stay
differentiable and may carry leading scenario-batch axes.  The 1D point
form is diagonal-only, so it folds into the tridiagonal routes
(``robin_diag``) as well as the dense ones (``robin_matrix_dense``); the
2D edge form is symmetric and feeds the dense routes and the matrix-free
CG (``robin_apply``, ``robin_diag``).
"""

from __future__ import annotations

import dataclasses

import torch

from ..mesh import FEMesh
from .neumann import edge_index


@dataclasses.dataclass(frozen=True)
class RobinBC:
    """COO boundary-stiffness triplet and boundary load.

    rows, cols : (K,) int64 node indices.
    vals : (…, K) entries of ∮αN_iN_j ds.
    load : (…, n_nodes) ∮rN_i ds.
    diagonal_only : set by the constructors (rows == cols everywhere).
    """

    rows: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor
    load: torch.Tensor
    diagonal_only: bool = False


def robin_point(mesh: FEMesh, node: int, alpha, r) -> RobinBC:
    """1D Robin at a boundary node: K[node, node] += α, F[node] += r.
    ``alpha`` / ``r`` may carry leading batch dims, which ``vals`` and
    ``load`` keep."""
    opts = dict(dtype=mesh.dtype, device=mesh.device)
    alpha = torch.as_tensor(alpha, **opts)
    r = torch.as_tensor(r, **opts)
    lead = torch.broadcast_shapes(alpha.shape, r.shape)
    idx = torch.tensor([node], device=mesh.device)
    load = torch.zeros(lead + (mesh.n_nodes,), **opts).index_add(
        -1, idx, r.expand(lead)[..., None])
    return RobinBC(rows=idx, cols=idx.clone(),
                   vals=alpha.expand(lead)[..., None], load=load,
                   diagonal_only=True)


def robin_edges(mesh: FEMesh, edges, alpha, r_nodal) -> RobinBC:
    """2D Robin over boundary edges (i, j): per P1 edge of length L the
    boundary mass α·L/6·[[2,1],[1,2]] and the consistent load
    L/6·[2r_i + r_j, r_i + 2r_j].  ``alpha``: scalar, per-edge (E,), or
    batched (…, E) / (…, 1); ``r_nodal``: (…, n_nodes)."""
    opts = dict(dtype=mesh.dtype, device=mesh.device)
    edges = edge_index(mesh, edges)
    E = edges.shape[0]
    alpha = torch.as_tensor(alpha, **opts)
    alpha = alpha.expand((E,) if alpha.ndim == 0
                         else alpha.shape[:-1] + (E,))
    r_nodal = torch.as_tensor(r_nodal, **opts)
    i, j = edges[:, 0], edges[:, 1]
    L = torch.linalg.vector_norm(mesh.nodes[j] - mesh.nodes[i], dim=-1)
    m_diag = alpha * L / 3.0      # 2·L/6
    m_off = alpha * L / 6.0
    rows = torch.cat([i, j, i, j])
    cols = torch.cat([i, j, j, i])
    vals = torch.cat([m_diag, m_diag, m_off, m_off], dim=-1)
    ri, rj = r_nodal[..., i], r_nodal[..., j]
    lead = torch.broadcast_shapes(alpha.shape[:-1], r_nodal.shape[:-1])
    load = torch.zeros(lead + (mesh.n_nodes,), **opts)
    load = load.index_add(-1, i, (L / 6.0 * (2.0 * ri + rj)).expand(
        lead + (E,)))
    load = load.index_add(-1, j, (L / 6.0 * (ri + 2.0 * rj)).expand(
        lead + (E,)))
    return RobinBC(rows=rows, cols=cols,
                   vals=vals.expand(lead + vals.shape[-1:]), load=load)


def robin_matrix_dense(mesh: FEMesh, rb: RobinBC) -> torch.Tensor:
    """Dense (…, n, n) boundary-stiffness contribution."""
    n = mesh.n_nodes
    K = rb.vals.new_zeros(rb.vals.shape[:-1] + (n * n,))
    K = K.index_add(-1, rb.rows * n + rb.cols, rb.vals)
    return K.reshape(rb.vals.shape[:-1] + (n, n))


def robin_apply(rb: RobinBC, u: torch.Tensor) -> torch.Tensor:
    """Matrix-free boundary-stiffness apply."""
    v = rb.vals * u[..., rb.cols]
    out = v.new_zeros(v.shape[:-1] + u.shape[-1:])
    return out.index_add(-1, rb.rows, v)


def robin_diag(mesh: FEMesh, rb: RobinBC) -> torch.Tensor:
    """Diagonal of the boundary stiffness, (…, n_nodes) for batched
    ``vals``."""
    mask = (rb.rows == rb.cols).to(mesh.dtype)
    out = rb.vals.new_zeros(rb.vals.shape[:-1] + (mesh.n_nodes,))
    return out.index_add(-1, rb.rows, mask * rb.vals)
