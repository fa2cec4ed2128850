"""Helpers shared by the parity tests of the PyTorch port
(tests/test_torch_*.py): numpy/JAX arrays in, torch tensors out."""

import numpy as np
import torch

from difffe_tpu_torch.mesh import FEMesh
from difffe_tpu_torch.ops.stencil import StructuredGrid
from difffe_tpu_torch.ops.stencil3d import StructuredGrid3


def as_torch(a) -> torch.Tensor:
    """A torch copy of any array ``np.asarray`` takes (dtype kept)."""
    return torch.tensor(np.asarray(a))


def _f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().double().cpu().numpy()
    return np.asarray(x, np.float64)


def rel_err(a, b) -> float:
    """max|a − b| / max|b| in float64, for torch, numpy or JAX arrays (0
    for two empty arrays)."""
    a, b = _f64(a), _f64(b)
    if a.size == 0 and b.size == 0:
        return 0.0
    return float(np.abs(a - b).max() / np.abs(b).max())


def jax_mesh(factory, *args, **kw):
    """A ``difffe_tpu`` mesh from one compiled call of ``factory`` (e.g.
    ``JMesh.box``): the factories' eager ops would each compile on first
    use, which costs seconds per mesh shape."""
    import jax

    return jax.jit(lambda: factory(*args, **kw))()


def port_grid(jax_grid):
    """The port's StructuredGrid or StructuredGrid3 for a ``difffe_tpu``
    2D or 3D grid (None stays None)."""
    if jax_grid is None:
        return None
    if hasattr(jax_grid, "nz"):
        return StructuredGrid3(jax_grid.nx, jax_grid.ny, jax_grid.nz,
                               jax_grid.hx, jax_grid.hy, jax_grid.hz)
    return StructuredGrid(jax_grid.nx, jax_grid.ny, jax_grid.hx, jax_grid.hy)


def port_mesh(jax_mesh, **kw) -> FEMesh:
    """The port's FEMesh holding the same arrays and grid metadata as a
    ``difffe_tpu`` mesh, on the CPU unless ``device`` is given."""
    kw.setdefault("device", "cpu")
    return FEMesh.from_arrays(np.asarray(jax_mesh.nodes),
                              np.asarray(jax_mesh.elements),
                              np.asarray(jax_mesh.bc_mask),
                              np.asarray(jax_mesh.bc_values),
                              grid=port_grid(jax_mesh.grid), **kw)
