"""Finite element mesh as a dataclass of tensors.

PyTorch counterpart of ``difffe_tpu/mesh.py``.  Dirichlet BCs are dense
per-node tensors (``bc_mask`` ∈ {0,1}, ``bc_values``), so every op keeps
static shapes.  All tensors of a mesh live on one ``device``; float fields
share one ``dtype`` and ``elements`` is int64 (torch's index type).

The factories put a mesh on the CUDA card unless the caller passes
``device`` (``device="cpu"`` for the CPU): there is no fallback, so
without a card the default raises torch's own error.

``FEMesh.from_arrays`` builds a mesh from numpy arrays — the converter the
parity tests use to hand the JAX package's meshes (including nonuniform
ones) to this package unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


def default_dtype() -> torch.dtype:
    """torch's default float dtype (float32 unless the caller changed it)."""
    return torch.get_default_dtype()


def _device(device) -> torch.device:
    """The factories' device: the CUDA card unless one is named."""
    return torch.device("cuda" if device is None else device)


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
    grid : ``ops.stencil.StructuredGrid`` of a ``rectangle`` mesh,
        ``ops.stencil3d.StructuredGrid3`` of a ``box`` mesh, else
        None.  When present, ``solve_poisson(method="auto")`` and
        ``fit_kappa`` take the structured stencil routes;
        ``with_dirichlet`` drops it, as in the JAX package.
    """

    nodes: torch.Tensor
    elements: torch.Tensor
    bc_mask: torch.Tensor
    bc_values: torch.Tensor
    grid: Optional[object] = None
    # what kernel wrappers derive from the mesh, built at their first call
    # (ops/kernels/fused_grad_kernel.mesh_constants); a mesh made by
    # dataclasses.replace starts empty
    derived: dict = dataclasses.field(default_factory=dict, init=False,
                                      repr=False, compare=False)

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

    def dirichlet_items(self):
        """(node_index, value) pairs of the Dirichlet nodes, as Python
        numbers: the reference's BC dict."""
        mask = self.bc_mask.cpu().numpy()
        idx = np.nonzero(mask > 0.5)[0]
        vals = self.bc_values.cpu().numpy()[idx]
        return list(zip(idx.tolist(), vals.tolist()))

    def h(self) -> float:
        """Characteristic element size: the minimum element length in 1D,
        the minimum edge length over all vertex pairs of every element in
        2D/3D."""
        if self.dim == 1:
            x = self.nodes[:, 0]
            d = (x[self.elements[:, 1]] - x[self.elements[:, 0]]).abs()
            return float(d.min())
        p = self.nodes[self.elements]              # (ne, k, dim)
        k = p.shape[1]
        lengths = [torch.linalg.vector_norm(p[:, b] - p[:, a], dim=-1)
                   for a in range(k) for b in range(a + 1, k)]
        return float(torch.stack(lengths).min())

    def __repr__(self) -> str:
        return (f"FEMesh(dim={self.dim}, n_nodes={self.n_nodes}, "
                f"n_elements={self.n_elements}, "
                f"n_dirichlet={self.n_dirichlet}, device={self.device})")

    # -------------------------------------------------------------- factories

    @classmethod
    def from_arrays(cls, nodes, elements, bc_mask, bc_values,
                    device=None, dtype: Optional[torch.dtype] = None,
                    grid=None) -> "FEMesh":
        """Build a mesh from numpy arrays (or anything ``np.asarray`` takes).

        ``dtype`` defaults to the dtype of ``nodes`` when it is a float
        array, else to :func:`default_dtype`; ``device`` to the CUDA card.
        ``grid`` is the structured-grid metadata to attach, if any.
        """
        device = _device(device)
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
            grid=grid,
        )

    @classmethod
    def line(cls, n_elements: int = 10, x_left: float = 0.0,
             x_right: float = 1.0, bc_left: Optional[float] = 0.0,
             bc_right: Optional[float] = 0.0,
             dtype: Optional[torch.dtype] = None, device=None) -> "FEMesh":
        """Uniform 1D mesh on [x_left, x_right]: n_elements+1 nodes,
        Dirichlet at each end whose value is not None."""
        dtype = dtype or default_dtype()
        device = _device(device)
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
    def rectangle(cls, nx: int = 4, ny: int = 4,
                  x_range: Tuple[float, float] = (0.0, 1.0),
                  y_range: Tuple[float, float] = (0.0, 1.0),
                  bc_value: float = 0.0,
                  dtype: Optional[torch.dtype] = None,
                  device=None) -> "FEMesh":
        """Uniform 2D triangulated grid, Dirichlet on all four edges.

        Node id = row·(nx+1) + col; quad (a, b, c, d) → triangles (a, b, d)
        and (b, c, d), interleaved [lower_0, upper_0, lower_1, …].  The
        boundary is found by index, not by coordinates.
        """
        from .ops.stencil import StructuredGrid

        dtype = dtype or default_dtype()
        device = _device(device)
        xs = torch.linspace(x_range[0], x_range[1], nx + 1, dtype=dtype,
                            device=device)
        ys = torch.linspace(y_range[0], y_range[1], ny + 1, dtype=dtype,
                            device=device)
        yy, xx = torch.meshgrid(ys, xs, indexing="ij")     # (ny+1, nx+1)
        nodes = torch.stack([xx.reshape(-1), yy.reshape(-1)], dim=1)
        i = torch.arange(ny, device=device)[:, None]
        j = torch.arange(nx, device=device)[None, :]
        a = (i * (nx + 1) + j).reshape(-1)
        b = (i * (nx + 1) + j + 1).reshape(-1)
        c = ((i + 1) * (nx + 1) + j + 1).reshape(-1)
        d = ((i + 1) * (nx + 1) + j).reshape(-1)
        lower = torch.stack([a, b, d], dim=1)
        upper = torch.stack([b, c, d], dim=1)
        elements = torch.stack([lower, upper], dim=1).reshape(-1, 3)
        rows = torch.arange(ny + 1, device=device)[:, None]
        cols = torch.arange(nx + 1, device=device)[None, :]
        on_bnd = ((rows == 0) | (rows == ny) | (cols == 0)
                  | (cols == nx)).reshape(-1)
        bc_mask = on_bnd.to(dtype)
        return cls(nodes=nodes, elements=elements, bc_mask=bc_mask,
                   bc_values=bc_mask * bc_value,
                   grid=StructuredGrid.unit(nx, ny, x_range, y_range))

    @classmethod
    def box(cls, nx: int = 4, ny: int = 4, nz: int = 4,
            x_range: Tuple[float, float] = (0.0, 1.0),
            y_range: Tuple[float, float] = (0.0, 1.0),
            z_range: Tuple[float, float] = (0.0, 1.0),
            bc_value: float = 0.0, dtype: Optional[torch.dtype] = None,
            device=None) -> "FEMesh":
        """Uniform 3D box mesh of P1 tetrahedra, Dirichlet on all six faces.

        Node id = (iz·(ny+1) + iy)·(nx+1) + ix (x fastest).  Each cube is
        split into the six Kuhn tetrahedra sharing its main diagonal
        c000–c111, one per monotone lattice path, interleaved per cube
        [cube0 tet0..5, cube1 tet0..5, …].  The boundary is found by index.
        """
        from .ops.stencil3d import StructuredGrid3

        dtype = dtype or default_dtype()
        device = _device(device)

        def axis(r, n):
            return torch.linspace(r[0], r[1], n + 1, dtype=dtype,
                                  device=device)

        zz, yy, xx = torch.meshgrid(axis(z_range, nz), axis(y_range, ny),
                                    axis(x_range, nx), indexing="ij")
        nodes = torch.stack([xx.reshape(-1), yy.reshape(-1),
                             zz.reshape(-1)], dim=1)
        i = torch.arange(nx, device=device)[None, None, :]
        j = torch.arange(ny, device=device)[None, :, None]
        k = torch.arange(nz, device=device)[:, None, None]

        def corner(di, dj, dk):
            return (((k + dk) * (ny + 1) + (j + dj)) * (nx + 1)
                    + (i + di)).reshape(-1)

        # six monotone paths 000→111; each tet = {000, step1, step2, 111}
        paths = (((1, 0, 0), (1, 1, 0)), ((1, 0, 0), (1, 0, 1)),
                 ((0, 1, 0), (1, 1, 0)), ((0, 1, 0), (0, 1, 1)),
                 ((0, 0, 1), (1, 0, 1)), ((0, 0, 1), (0, 1, 1)))
        tets = [torch.stack([corner(0, 0, 0), corner(*p1), corner(*p2),
                             corner(1, 1, 1)], dim=1) for p1, p2 in paths]
        elements = torch.stack(tets, dim=1).reshape(-1, 4)
        m = torch.ones((nz + 1, ny + 1, nx + 1), dtype=dtype, device=device)
        m[1:-1, 1:-1, 1:-1] = 0.0
        bc_mask = m.reshape(-1)
        return cls(nodes=nodes, elements=elements, bc_mask=bc_mask,
                   bc_values=bc_mask * bc_value,
                   grid=StructuredGrid3.unit(nx, ny, nz, x_range, y_range,
                                             z_range))

    @classmethod
    def line_p2(cls, n_elements: int = 10, **kw) -> "FEMesh":
        """Quadratic (P2) 1D mesh: 2N+1 nodes, elements (2i, 2i+1, 2i+2);
        the keywords of :meth:`line`.  See ops/p2.py."""
        from .ops.p2 import line_p2
        return line_p2(n_elements, **kw)

    @classmethod
    def rectangle_p2(cls, nx: int = 4, ny: int = 4, **kw) -> "FEMesh":
        """Quadratic (P2) 2D triangulated grid (6-node triangles, no grid
        metadata); the keywords of :meth:`rectangle`.  See ops/p2.py."""
        from .ops.p2 import rectangle_p2
        return rectangle_p2(nx, ny, **kw)

    # ------------------------------------------------------------------ misc

    def astype(self, dtype: torch.dtype) -> "FEMesh":
        """Cast all float fields to ``dtype`` on the mesh's device
        (``elements`` stay int64; ``grid`` is kept)."""
        return FEMesh(nodes=self.nodes.to(dtype),
                      elements=self.elements,
                      bc_mask=self.bc_mask.to(dtype),
                      bc_values=self.bc_values.to(dtype),
                      grid=self.grid)

    def with_dirichlet(self, node_indices, values) -> "FEMesh":
        """Return a copy with additional/overridden Dirichlet constraints.

        The copy has no ``grid``: custom constraints break the full-boundary
        Dirichlet assumption of the structured stencil routes."""
        idx = torch.as_tensor(node_indices, dtype=torch.int64,
                              device=self.device).reshape(-1)
        vals = torch.as_tensor(values, dtype=self.dtype,
                               device=self.device).expand(idx.shape)
        bc_mask = self.bc_mask.clone()
        bc_values = self.bc_values.clone()
        bc_mask[idx] = 1.0
        bc_values[idx] = vals
        return dataclasses.replace(self, bc_mask=bc_mask,
                                   bc_values=bc_values, grid=None)
