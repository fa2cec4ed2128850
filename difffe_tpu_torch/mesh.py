"""Finite element mesh as a dataclass of tensors.

PyTorch counterpart of ``difffe_tpu/mesh.py``.  Dirichlet BCs are dense
per-node tensors (``bc_mask`` ∈ {0,1}, ``bc_values``), so every op keeps
static shapes.  All tensors of a mesh live on one ``device``; float fields
share one ``dtype`` and ``elements`` is int64 (torch's index type).

``FEMesh.from_arrays`` builds a mesh from numpy arrays — the converter the
parity tests use to hand the JAX package's meshes (including nonuniform
ones) to this package unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


def default_dtype() -> torch.dtype:
    """torch's default float dtype (float32 unless the caller changed it)."""
    return torch.get_default_dtype()


@dataclasses.dataclass(frozen=True)
class FEMesh:
    """A finite element mesh with nodes, elements, and Dirichlet BCs.

    Attributes
    ----------
    nodes : (n_nodes, dim) float tensor — physical node coordinates.
    elements : (n_elements, nodes_per_element) int64 — connectivity.
    bc_mask : (n_nodes,) float tensor — 1.0 on Dirichlet nodes, else 0.0.
    bc_values : (n_nodes,) float tensor — prescribed Dirichlet values
        (only read where ``bc_mask == 1``).
    """

    nodes: torch.Tensor
    elements: torch.Tensor
    bc_mask: torch.Tensor
    bc_values: torch.Tensor

    # ---------------------------------------------------------------- queries

    @property
    def n_nodes(self) -> int:
        return self.nodes.shape[0]

    @property
    def n_elements(self) -> int:
        return self.elements.shape[0]

    @property
    def dim(self) -> int:
        return self.nodes.shape[1]

    @property
    def dtype(self) -> torch.dtype:
        return self.nodes.dtype

    @property
    def device(self) -> torch.device:
        return self.nodes.device

    @property
    def n_dirichlet(self) -> int:
        """Number of Dirichlet-constrained nodes."""
        return int((self.bc_mask > 0.5).sum().item())

    def free_nodes(self) -> np.ndarray:
        """Indices of unconstrained nodes, as a host numpy array."""
        return np.nonzero(self.bc_mask.cpu().numpy() < 0.5)[0]

    def h(self) -> float:
        """Characteristic element size = minimum element length (1D)."""
        if self.dim != 1:
            raise NotImplementedError(
                "FEMesh.h for 2D/3D meshes is not ported yet (slices C/D)")
        x = self.nodes[:, 0]
        d = (x[self.elements[:, 1]] - x[self.elements[:, 0]]).abs()
        return float(d.min())

    def __repr__(self) -> str:
        return (f"FEMesh(dim={self.dim}, n_nodes={self.n_nodes}, "
                f"n_elements={self.n_elements}, "
                f"n_dirichlet={self.n_dirichlet}, device={self.device})")

    # -------------------------------------------------------------- factories

    @classmethod
    def from_arrays(cls, nodes, elements, bc_mask, bc_values,
                    device=None, dtype: Optional[torch.dtype] = None
                    ) -> "FEMesh":
        """Build a mesh from numpy arrays (or anything ``np.asarray`` takes).

        ``dtype`` defaults to the dtype of ``nodes`` when it is a float
        array, else to :func:`default_dtype`.
        """
        nodes = np.asarray(nodes)
        if dtype is None:
            dtype = (torch.from_numpy(np.empty(0, nodes.dtype)).dtype
                     if nodes.dtype.kind == "f" else default_dtype())
        nodes = nodes.reshape(nodes.shape[0], -1)

        def as_float(a):
            return torch.tensor(np.asarray(a), dtype=dtype, device=device)

        return cls(
            nodes=as_float(nodes),
            elements=torch.tensor(np.asarray(elements, np.int64),
                                  device=device),
            bc_mask=as_float(bc_mask),
            bc_values=as_float(bc_values),
        )

    @classmethod
    def line(cls, n_elements: int = 10, x_left: float = 0.0,
             x_right: float = 1.0, bc_left: Optional[float] = 0.0,
             bc_right: Optional[float] = 0.0,
             dtype: Optional[torch.dtype] = None, device=None) -> "FEMesh":
        """Uniform 1D mesh on [x_left, x_right]: n_elements+1 nodes,
        Dirichlet at each end whose value is not None."""
        dtype = dtype or default_dtype()
        n = n_elements + 1
        x = torch.linspace(x_left, x_right, n, dtype=dtype, device=device)
        idx = torch.arange(n_elements, device=device)
        elements = torch.stack([idx, idx + 1], dim=1)
        bc_mask = torch.zeros(n, dtype=dtype, device=device)
        bc_values = torch.zeros(n, dtype=dtype, device=device)
        if bc_left is not None:
            bc_mask[0] = 1.0
            bc_values[0] = bc_left
        if bc_right is not None:
            bc_mask[n - 1] = 1.0
            bc_values[n - 1] = bc_right
        return cls(nodes=x[:, None], elements=elements, bc_mask=bc_mask,
                   bc_values=bc_values)

    @classmethod
    def rectangle(cls, *args, **kwargs) -> "FEMesh":
        raise NotImplementedError(
            "FEMesh.rectangle is not ported yet (slice C: 2D structured "
            "grids)")

    @classmethod
    def box(cls, *args, **kwargs) -> "FEMesh":
        raise NotImplementedError(
            "FEMesh.box is not ported yet (slice D: 3D boxes)")

    # ------------------------------------------------------------------ misc

    def with_dirichlet(self, node_indices, values) -> "FEMesh":
        """Return a copy with additional/overridden Dirichlet constraints."""
        idx = torch.as_tensor(node_indices, dtype=torch.int64,
                              device=self.device).reshape(-1)
        vals = torch.as_tensor(values, dtype=self.dtype,
                               device=self.device).expand(idx.shape)
        bc_mask = self.bc_mask.clone()
        bc_values = self.bc_values.clone()
        bc_mask[idx] = 1.0
        bc_values[idx] = vals
        return dataclasses.replace(self, bc_mask=bc_mask,
                                   bc_values=bc_values)
