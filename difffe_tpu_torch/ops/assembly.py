"""P1 line-element assembly and the κ rules the stencil routes share.

PyTorch counterpart of the 1D subset of ``difffe_tpu/ops/assembly.py``
plus its element-family and κ-normalization rules for P1 triangles and
tetrahedra: load, bands, local stiffness, the dense stiffness (its banded
fast form for P1 lines), the matrix-free applies and the lumped mass.  The
JAX scatter-adds become ``index_add`` (load, dense matrix, applies) and
pad-and-add (bands); leading batch axes of κ, f and u are kept where the
JAX package ``vmap``s.  Semantics kept: the trapezoidal nodal load
F_i += h_e/2·f_i and the local stiffness κ_e/h_e·[[1,-1],[-1,1]].  P1
triangles and tetrahedra are recognised (the structured routes of
ops/stencil.py and ops/stencil3d.py assemble them in stencil form); their
generic assembly and P2 raise ``NotImplementedError`` naming the slice
that ports them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F_

from ..mesh import FEMesh

_FAMILIES = {(1, 2): "p1_line", (2, 3): "p1_tri", (3, 4): "p1_tet"}
_UNPORTED_FAMILIES = {
    (1, 3): "P2 line elements are not ported yet (slice B, next PR: "
            "ops/p2.py)",
    (2, 6): "P2 triangle elements are not ported yet (slice E)",
}


def element_family(mesh: FEMesh) -> str:
    """'p1_line' | 'p1_tri' | 'p1_tet' from (dim, nodes/elem); the other
    families of the JAX package raise ``NotImplementedError`` naming their
    slice."""
    key = (mesh.dim, mesh.elements.shape[1])
    if key in _FAMILIES:
        return _FAMILIES[key]
    if key in _UNPORTED_FAMILIES:
        raise NotImplementedError(_UNPORTED_FAMILIES[key])
    raise NotImplementedError(
        f"unsupported element family: dim={key[0]}, nodes/elem={key[1]}")


def kappa_on_elements(mesh: FEMesh, kappa) -> torch.Tensor:
    """Normalize κ to per-element values ``(..., n_elements)``.

    Accepts a scalar, per-element ``(..., n_elements)``, or per-node
    ``(..., n_nodes)`` (averaged over each element's nodes).
    """
    kappa = torch.as_tensor(kappa, dtype=mesh.dtype, device=mesh.device)
    if is_tensor_kappa(mesh, kappa):
        raise ValueError(
            "tensor-valued kappa reached a scalar-diffusion path; tensor "
            "diffusivity needs the generic P1 assembly (method='dense'/"
            "'lu'/'cg'), not ported yet (slice E: ops/assembly.py)")
    ne, nn = mesh.n_elements, mesh.n_nodes
    if kappa.ndim == 0:
        return kappa.expand(ne)
    if kappa.shape[-1] == ne:
        return kappa
    if kappa.shape[-1] == nn:
        return kappa[..., mesh.elements].mean(dim=-1)
    raise ValueError(
        f"kappa shape {tuple(kappa.shape)} matches neither "
        f"n_elements={ne} nor n_nodes={nn}")


def is_tensor_kappa(mesh: FEMesh, kappa) -> bool:
    """True when κ is a dim×dim diffusion tensor: any shape with trailing
    dims (d, d) on a 2D/3D mesh."""
    shape = tuple(torch.as_tensor(kappa).shape)
    d = mesh.dim
    return d in (2, 3) and len(shape) >= 2 and shape[-2:] == (d, d)


def _require_line(mesh: FEMesh):
    if element_family(mesh) != "p1_line":
        raise NotImplementedError(
            "generic P1 triangle and tetrahedron assembly is not ported yet "
            "(slice E: ops/assembly.py); FEMesh.rectangle and FEMesh.box "
            "meshes assemble in stencil form (ops/stencil.py, "
            "ops/stencil3d.py)")


def element_geometry_1d(mesh: FEMesh) -> torch.Tensor:
    """Element lengths h_e = x_j − x_i (signed)."""
    x = mesh.nodes[:, 0]
    return x[mesh.elements[:, 1]] - x[mesh.elements[:, 0]]


def assemble_load(mesh: FEMesh, f) -> torch.Tensor:
    """Trapezoidal nodal load F_i += h_e/2·f_i from forcing ``f``
    (..., n_nodes); leading batch axes are kept."""
    _require_line(mesh)
    f = torch.as_tensor(f, dtype=mesh.dtype, device=mesh.device)
    h = element_geometry_1d(mesh)
    i, j = mesh.elements[:, 0], mesh.elements[:, 1]
    F = f.new_zeros(f.shape[:-1] + (mesh.n_nodes,))
    F = F.index_add(-1, i, h / 2.0 * f[..., i])
    return F.index_add(-1, j, h / 2.0 * f[..., j])


def dense_from_local(mesh: FEMesh, Ke: torch.Tensor) -> torch.Tensor:
    """Scatter per-element blocks (…, ne, k, k) into dense (…, n, n)."""
    n = mesh.n_nodes
    k = Ke.shape[-1]
    elems = mesh.elements
    rows = elems.repeat_interleave(k, dim=1).reshape(-1)
    cols = elems.repeat(1, k).reshape(-1)
    lead = Ke.shape[:-3]
    K = Ke.new_zeros(lead + (n * n,))
    K = K.index_add(-1, rows * n + cols, Ke.reshape(lead + (-1,)))
    return K.reshape(lead + (n, n))


def local_stiffness(mesh: FEMesh, kappa) -> torch.Tensor:
    """Per-element stiffness blocks (…, n_elements, 2, 2) of P1 lines."""
    _require_line(mesh)
    ke = kappa_on_elements(mesh, kappa) / element_geometry_1d(mesh)
    S = torch.tensor([[1.0, -1.0], [-1.0, 1.0]], dtype=mesh.dtype,
                     device=mesh.device)
    return ke[..., None, None] * S


def assemble_stiffness_dense(mesh: FEMesh, kappa) -> torch.Tensor:
    """Dense stiffness matrix (…, n_nodes, n_nodes), no BCs applied; the
    banded fast form of the generic scatter for P1 lines."""
    _require_line(mesh)
    n = mesh.n_nodes
    ke = kappa_on_elements(mesh, kappa) / element_geometry_1d(mesh)
    i, j = mesh.elements[:, 0], mesh.elements[:, 1]
    K = ke.new_zeros(ke.shape[:-1] + (n * n,))
    K = K.index_add(-1, i * n + i, ke).index_add(-1, j * n + j, ke)
    K = K.index_add(-1, i * n + j, -ke).index_add(-1, j * n + i, -ke)
    return K.reshape(ke.shape[:-1] + (n, n))


def assemble_lumped_mass(mesh: FEMesh) -> torch.Tensor:
    """Row-sum lumped mass entries (n_nodes,): ``assemble_load(mesh, 1)``."""
    return assemble_load(mesh, torch.ones(mesh.n_nodes, dtype=mesh.dtype,
                                          device=mesh.device))


def element_apply(mesh: FEMesh, Ke: torch.Tensor,
                  u: torch.Tensor) -> torch.Tensor:
    """Matrix-free K·u from per-element blocks Ke (ne, k, k): gather the
    element values of u (…, n_nodes), apply the blocks, scatter-add."""
    elems = mesh.elements
    kue = torch.einsum("epq,...eq->...ep", Ke, u[..., elems])
    out = torch.zeros_like(u)
    for p in range(elems.shape[1]):
        out = out.index_add(-1, elems[:, p], kue[..., p])
    return out


def stiffness_apply(mesh: FEMesh, kappa, u: torch.Tensor) -> torch.Tensor:
    """Matrix-free K(κ)·u for P1 lines, batched over leading axes."""
    _require_line(mesh)
    ke = kappa_on_elements(mesh, kappa) / element_geometry_1d(mesh)
    i, j = mesh.elements[:, 0], mesh.elements[:, 1]
    du = ke * (u[..., i] - u[..., j])
    out = du.new_zeros(du.shape[:-1] + (mesh.n_nodes,))
    return out.index_add(-1, i, du).index_add(-1, j, -du)


def assemble_tridiag_1d(mesh: FEMesh, kappa):
    """Stiffness of a chain mesh (elements (i, i+1)) as bands ``(d, e)``:
    d (..., n) on the diagonal, e (..., n−1) on both off-diagonals."""
    _require_line(mesh)
    ke = kappa_on_elements(mesh, kappa) / element_geometry_1d(mesh)
    d = F_.pad(ke, (0, 1)) + F_.pad(ke, (1, 0))
    return d, -ke
