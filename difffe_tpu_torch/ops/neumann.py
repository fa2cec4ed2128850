"""Neumann (natural, flux) boundary conditions.

PyTorch counterpart of ``difffe_tpu/ops/neumann.py``.  Natural BCs enter
only the load vector: the helpers build the boundary term as a dense
(…, n_nodes) vector added to F before Dirichlet elimination (terms on
Dirichlet nodes are inert).  They are differentiable wrt the flux values
and the node coordinates, and batch over leading axes of ``q``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..mesh import FEMesh


def point_flux(mesh: FEMesh, node: int, q) -> torch.Tensor:
    """1D natural BC: κu′·v picked up at a boundary node → F[node] += q."""
    out = torch.zeros(mesh.n_nodes, dtype=mesh.dtype, device=mesh.device)
    q = torch.as_tensor(q, dtype=mesh.dtype, device=mesh.device)
    return out.index_add(0, torch.tensor([node], device=mesh.device),
                         q.reshape(1))


def edge_index(mesh: FEMesh, edges) -> torch.Tensor:
    """Edges (E, 2) from numpy or torch as an int64 tensor on the mesh's
    device."""
    if not isinstance(edges, torch.Tensor):
        edges = torch.from_numpy(np.asarray(edges))
    return edges.to(device=mesh.device, dtype=torch.int64)


def edge_flux_load(mesh: FEMesh, edges, q) -> torch.Tensor:
    """2D natural BC: ∮ g_N v ds over boundary edges (E, 2) by the
    trapezoidal edge rule F_i += len_e/2·q_i, F_j += len_e/2·q_j, for nodal
    flux values q (..., n_nodes)."""
    edges = edge_index(mesh, edges)
    q = torch.as_tensor(q, dtype=mesh.dtype, device=mesh.device)
    i, j = edges[:, 0], edges[:, 1]
    length = torch.linalg.vector_norm(mesh.nodes[j] - mesh.nodes[i], dim=-1)
    out = q.new_zeros(q.shape[:-1] + (mesh.n_nodes,))
    out = out.index_add(-1, i, length / 2.0 * q[..., i])
    return out.index_add(-1, j, length / 2.0 * q[..., j])


def boundary_edges(mesh: FEMesh, predicate=None) -> np.ndarray:
    """Boundary edges of a triangle mesh, sorted, as an (E, 2) numpy int
    array (host-side, once per mesh): the edges that belong to one element
    only, optionally kept where ``predicate`` holds at both endpoints."""
    elements = mesh.elements.cpu().numpy()
    if elements.shape[1] == 6:          # P2 triangle: vertices first
        elements = elements[:, :3]
    edges = np.concatenate([elements[:, [0, 1]], elements[:, [1, 2]],
                            elements[:, [2, 0]]])
    edges = np.sort(edges, axis=1)
    uniq, counts = np.unique(edges, axis=0, return_counts=True)
    bnd = uniq[counts == 1]
    if predicate is not None:
        nodes = mesh.nodes.detach().cpu().numpy()
        keep = [predicate(nodes[i]) and predicate(nodes[j]) for i, j in bnd]
        bnd = bnd[np.asarray(keep, dtype=bool)]
    return bnd
