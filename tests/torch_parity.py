"""Helpers shared by the parity tests of the PyTorch port
(tests/test_torch_*.py): numpy/JAX arrays in, torch tensors out."""

import functools

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
    for two empty arrays, and for two equal ones, zeros included)."""
    a, b = _f64(a), _f64(b)
    if a.size == 0 and b.size == 0:
        return 0.0
    d = float(np.abs(a - b).max())
    return 0.0 if d == 0.0 else d / float(np.abs(b).max())


def jax_mesh(factory, *args, **kw):
    """A ``difffe_tpu`` mesh from one compiled call of ``factory`` (e.g.
    ``JMesh.box``): the factories' eager ops would each compile on first
    use, which costs seconds per mesh shape.  Built once a process for each
    factory and arguments (the meshes are frozen), so the tests that share
    a mesh share its compile."""
    return _jax_mesh(factory, args, tuple(sorted(kw.items())))


@functools.lru_cache(maxsize=None)
def _jax_mesh(factory, args, kw):
    import jax

    return jax.jit(lambda: factory(*args, **dict(kw)))()


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


def perturbed_nodes(nodes, bc_mask, cells, jitter=0.3, seed=0):
    """Node coordinates (numpy f64) of a unit rectangle or box with its
    interior nodes moved by U(±jitter·h) along each axis, h = 1/cells."""
    nodes = np.array(nodes, np.float64)
    inner = np.asarray(bc_mask) < 0.5
    rng = np.random.default_rng(seed)
    h = 1.0 / np.asarray(cells, np.float64)
    nodes[inner] += rng.uniform(-jitter, jitter, nodes[inner].shape) * h
    return nodes


def general_meshes(factory, *cells, jitter=0.3, seed=0, dtype=None):
    """(JAX mesh, port mesh) of a ``difffe_tpu`` factory mesh
    (``JMesh.rectangle`` / ``JMesh.box``) whose interior nodes are moved
    (``perturbed_nodes``), built with ``grid=None`` on both sides:
    ``dataclasses.replace(mesh, nodes=...)`` would keep the grid, and the
    stencil routes would ignore the moved nodes."""
    import jax.numpy as jnp

    jm = jax_mesh(factory, *cells, dtype=dtype or jnp.float64)
    nodes = perturbed_nodes(np.asarray(jm.nodes), np.asarray(jm.bc_mask),
                            cells, jitter, seed)
    jg = type(jm)(jnp.asarray(nodes, jm.dtype), jm.elements, jm.bc_mask,
                  jm.bc_values)
    assert jg.grid is None
    return jg, port_mesh(jg)
