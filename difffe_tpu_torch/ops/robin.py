"""Robin (third-kind) boundary conditions κ∂u/∂n + αu = r: the 1D point
form.

PyTorch counterpart of the point part of ``difffe_tpu/ops/robin.py``.  The
Robin boundary adds ∮αuv ds to the stiffness and ∮rv ds to the load, kept
as a COO triplet (rows, cols, vals) plus a load vector; α and r stay
differentiable and may carry leading scenario-batch axes.  The 1D point
form is diagonal-only, so it folds into the tridiagonal routes
(``robin_diag``) as well as the dense ones (``robin_matrix_dense``).  The
2D edge form (``robin_edges``) raises ``NotImplementedError`` naming the
slice that ports it.
"""

from __future__ import annotations

import dataclasses

import torch

from ..mesh import FEMesh


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
    raise NotImplementedError(
        "2D edge Robin terms are not ported yet (slice C item 14: the "
        "generalized-mask stencil solver; general meshes: slice E)")


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
