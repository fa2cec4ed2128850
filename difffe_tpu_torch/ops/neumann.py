"""Neumann (natural, flux) boundary conditions: the 1D point form.

PyTorch counterpart of ``point_flux`` in ``difffe_tpu/ops/neumann.py``.
Natural BCs enter only the load vector: the helper builds the boundary
term as a dense (n_nodes,) vector added to F before Dirichlet elimination.
The 2D edge helpers (``edge_flux_load``, ``boundary_edges``) raise
``NotImplementedError`` naming the slice that ports them.
"""

from __future__ import annotations

import torch

from ..mesh import FEMesh

_EDGES = ("2D natural BCs are not ported yet (slice C item 14: the "
          "generalized-mask stencil solver; general meshes: slice E)")


def point_flux(mesh: FEMesh, node: int, q) -> torch.Tensor:
    """1D natural BC: κu′·v picked up at a boundary node → F[node] += q."""
    out = torch.zeros(mesh.n_nodes, dtype=mesh.dtype, device=mesh.device)
    q = torch.as_tensor(q, dtype=mesh.dtype, device=mesh.device)
    return out.index_add(0, torch.tensor([node], device=mesh.device),
                         q.reshape(1))


def edge_flux_load(mesh: FEMesh, edges, q):
    raise NotImplementedError(_EDGES)


def boundary_edges(mesh: FEMesh, predicate=None):
    raise NotImplementedError(_EDGES)
