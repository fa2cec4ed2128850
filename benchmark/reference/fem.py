"""Plain P1 finite elements on the structured meshes, in plain PyTorch.

The reference that decides ``correct``.  It imports nothing of the
program and is written from the problem's definition:

* the mesh: the unit square cut into nx × ny quads, each split along the
  diagonal from (x+h, y) to (x, y+h) into a lower triangle (a, b, d) and an
  upper one (b, c, d); the unit cube cut into nx × ny × nz cubes, each
  split into the six Kuhn tetrahedra of the monotone paths 000 → 111 (axis
  orders xyz, xzy, yxz, yzx, zxy, zyx).  Nodes are numbered x fastest,
  elements cell by cell (x fastest) with a cell's elements in the order
  above, and κ is one value an element in that order;
* the P1 stiffness K(κ) = Σ_e κ_e · vol_e · ∇φ ∇φᵀ, from each element's
  vertex coordinates; since all elements of one type are translates of
  each other, K is applied as a stencil whose planes are sums of
  zero-padded κ fields, one plane a coupling offset;
* the load: the centroid rule, F_p += vol_e / (d+1) · mean of f over e;
* Dirichlet values g on every boundary node, eliminated as
  A v = m·v + p·K(p·v), b = m·g + p·(F − K(m·g)) with m the boundary mask
  and p = 1 − m;
* Jacobi-preconditioned CG with a fixed number of iterations, per
  scenario or over the whole batch, and the fixed-trip freeze: a scenario
  whose r·z falls below (4ε)² of its first stops moving (α = β = 0);
* the κ gradient of ½·s·Σ(u − u_data)² by the adjoint: A λ = s·(u − u_data),
  ∂/∂κ_e = −(p·λ)_eᵀ (vol_e ∇φ∇φᵀ) (m·g + p·u)_e.

Every function takes the dtype of its inputs, so the same code computes in
float64 (the reference) and in bfloat16 (the control).
"""

from __future__ import annotations

import itertools
import math

import torch


class Grid:
    """A structured unit-box mesh with ``cells`` = (nx, ny) or (nx, ny, nz)
    cells; arrays are laid out (..., [nz+1,] ny+1, nx+1)."""

    def __init__(self, cells):
        self.cells = tuple(int(c) for c in cells)
        self.dim = len(self.cells)
        self.h = tuple(1.0 / c for c in self.cells)
        # array axes run z, y, x: reversed axis order
        self.cell_shape = tuple(reversed(self.cells))
        self.node_shape = tuple(c + 1 for c in self.cell_shape)
        self.n_nodes = math.prod(self.node_shape)
        self.types = _element_types(self.dim)
        self.n_elements = len(self.types) * math.prod(self.cells)
        self.blocks = [_local_stiffness(verts, self.h) for verts in self.types]

    def kappa_types(self, kappa):
        """(B, n_elements) → (B, T, *cell_shape): one field a type."""
        B = kappa.shape[0]
        k = kappa.reshape((B,) + self.cell_shape + (len(self.types),))
        return k.movedim(-1, 1)

    def elements_of(self, kappa_t):
        """The inverse of :meth:`kappa_types`."""
        return kappa_t.movedim(1, -1).reshape(kappa_t.shape[0], -1)

    def centroids(self, dtype=torch.float64, device=None):
        """(n_elements, dim) element centroids, in element order."""
        axes = [torch.arange(c, dtype=dtype, device=device) for c in
                self.cell_shape]
        corner = torch.stack(torch.meshgrid(*axes, indexing="ij")[::-1],
                             dim=-1)                      # (..., dim) x, y
        mean = torch.tensor([[sum(v[a] for v in verts) / len(verts)
                              for a in range(self.dim)]
                             for verts in self.types], dtype=dtype,
                            device=device)                # (T, dim)
        h = torch.tensor(self.h, dtype=dtype, device=device)
        pts = (corner[..., None, :] + mean) * h
        return pts.reshape(-1, self.dim)

    def nodes(self, dtype=torch.float64, device=None):
        """(n_nodes, dim) node coordinates, x fastest."""
        axes = [torch.linspace(0.0, 1.0, n, dtype=dtype, device=device)
                for n in self.node_shape]
        return torch.stack(torch.meshgrid(*axes, indexing="ij")[::-1],
                           dim=-1).reshape(-1, self.dim)

    def element_nodes(self):
        """(n_elements, dim+1) node ids of each element (for tests)."""
        strides = [1]
        for n in reversed(self.node_shape[1:]):
            strides.insert(0, strides[0] * n)
        strides = strides[::-1]                           # x, y, z strides
        out = []
        for cell in itertools.product(*(range(c) for c in self.cell_shape)):
            xyz = cell[::-1]
            for verts in self.types:
                out.append([sum((xyz[a] + v[a]) * strides[a]
                                for a in range(self.dim)) for v in verts])
        return torch.tensor(out)

    def boundary_mask(self, dtype, device):
        m = torch.ones(self.node_shape, dtype=dtype, device=device)
        m[(slice(1, -1),) * self.dim] = 0.0
        return m


def _element_types(dim):
    """Vertex offsets (x, y[, z]) of each element of a cell, in order."""
    if dim == 2:
        a, b, c, d = (0, 0), (1, 0), (1, 1), (0, 1)
        return ((a, b, d), (b, c, d))
    types = []
    for order in itertools.permutations(range(3)):
        v = [0, 0, 0]
        verts = [tuple(v)]
        for axis in order:
            v[axis] = 1
            verts.append(tuple(v))
        types.append(tuple(verts))
    return tuple(types)


def _local_stiffness(verts, h):
    """vol · ∇φ ∇φᵀ of the element with these vertex offsets (float64, on
    the CPU), with the entries that vanish in exact arithmetic (the right
    angles' couplings) set to 0."""
    X = torch.tensor(verts, dtype=torch.float64) * torch.tensor(
        h, dtype=torch.float64)
    T = (X[1:] - X[0]).T                                  # (dim, dim)
    G = torch.linalg.inv(T)                               # rows: ∇φ_1..d
    grads = torch.cat([-G.sum(0, keepdim=True), G], dim=0)
    vol = abs(float(torch.linalg.det(T))) / math.factorial(len(h))
    K = vol * grads @ grads.T
    K[K.abs() < 1e-12 * K.abs().max()] = 0.0
    return K, vol


def _offset(v):
    """An (x, y, z) vertex offset as array-axis offsets (z, y, x)."""
    return tuple(reversed(v))


def _embed(q, off):
    """A cell field (..., *cells) placed at node offset ``off`` (array axes)
    on the node grid, zero elsewhere."""
    pad = []
    for o in reversed(off):
        pad += [o, 1 - o]
    return torch.nn.functional.pad(q, pad)


def _cell_view(u, off):
    """The cell-shaped view of a node field at node offset ``off``."""
    dim = len(off)
    sl = tuple(slice(o, o + n - 1) for o, n in zip(off, u.shape[-dim:]))
    return u[(Ellipsis,) + sl]


class Operator:
    """K(κ) as planes, the eliminated operator A, its Jacobi M⁻¹ and the
    right-hand side, for a batch of κ fields (B, n_elements)."""

    def __init__(self, grid: Grid, kappa):
        self.grid = grid
        dt, dev = kappa.dtype, kappa.device
        kt = grid.kappa_types(kappa)
        planes = {}
        for t, verts in enumerate(grid.types):
            K, _ = grid.blocks[t]
            for p, vp in enumerate(verts):
                for q, vq in enumerate(verts):
                    if K[p, q] == 0.0:
                        continue
                    off = _offset(tuple(b - a for a, b in zip(vp, vq)))
                    add = float(K[p, q]) * _embed(kt[:, t], _offset(vp))
                    planes[off] = planes[off] + add if off in planes else add
        self.planes = planes
        self.m = grid.boundary_mask(dt, dev)
        self.p = 1.0 - self.m
        diag = self.m + self.p * planes[(0,) * grid.dim]
        self.minv = 1.0 / diag

    def stiffness(self, v):
        """K·v with zero outside the grid."""
        dim = self.grid.dim
        out = self.planes[(0,) * dim] * v
        for off, plane in self.planes.items():
            if not any(off):
                continue
            dst = tuple(slice(max(0, -o), n - max(0, o))
                        for o, n in zip(off, v.shape[-dim:]))
            src = tuple(slice(max(0, o), n - max(0, -o))
                        for o, n in zip(off, v.shape[-dim:]))
            out[(Ellipsis,) + dst] += plane[(Ellipsis,) + dst] * v[
                (Ellipsis,) + src]
        return out

    def apply(self, v):
        """A·v, the Dirichlet-eliminated operator."""
        return self.m * v + self.p * self.stiffness(self.p * v)

    def rhs(self, F, g):
        mg = self.m * g
        return mg + self.p * (F - self.stiffness(mg.expand_as(F).clone()))


def load(grid: Grid, f):
    """Centroid-rule load (B, *node_shape) of a nodal forcing of that
    shape."""
    F = torch.zeros_like(f)
    for verts in grid.types:
        _, vol = grid.blocks[grid.types.index(verts)]
        mean = sum(_cell_view(f, _offset(v)) for v in verts) / len(verts)
        share = vol / len(verts) * mean
        for v in verts:
            F = F + _embed(share, _offset(v))
    return F


def pcg(op: Operator, b, x0, iters: int, per_scenario: bool = True):
    """``iters`` Jacobi-PCG iterations from x0 with the fixed-trip freeze.

    ``per_scenario``: one α and β a scenario; else one over the batch."""
    dims = tuple(range(1, b.ndim)) if per_scenario else tuple(range(b.ndim))

    def dot(u, v):
        return (u * v).sum(dim=dims, keepdim=True)

    x = x0
    r = b - op.apply(x)
    z = op.minv * r
    p = z
    rz = dot(r, z)
    eps = torch.finfo(b.dtype).eps
    floor = (4.0 * eps) ** 2 * rz.clamp_min(1e-30)
    zero = torch.zeros_like(rz)
    for _ in range(iters):
        live = rz > floor
        Ap = op.apply(p)
        pAp = dot(p, Ap)
        alpha = torch.where(live & (pAp != 0),
                            rz / torch.where(pAp != 0, pAp, 1.0), zero)
        x = x + alpha * p
        r = r - alpha * Ap
        z = op.minv * r
        rz_new = dot(r, z)
        beta = torch.where(live & (rz_new > floor) & (rz != 0),
                           rz_new / torch.where(rz != 0, rz, 1.0), zero)
        p = z + beta * p
        rz = rz_new
    return x


def solve(grid: Grid, kappa, f, g, iters: int, per_scenario: bool = True):
    """u (B, n_nodes) of ``iters`` cold PCG iterations; κ (B, n_elements),
    f (B, n_nodes), g a scalar boundary value."""
    B = f.shape[0]
    op = Operator(grid, kappa)
    fg = f.reshape((B,) + grid.node_shape)
    b = op.rhs(load(grid, fg), g)
    x0 = (op.m * g).expand_as(b).contiguous()
    return pcg(op, b, x0, iters, per_scenario).reshape(B, -1)


def kappa_gradient(grid: Grid, lam, w):
    """∂(λᵀK(κ)w)/∂κ per element (B, n_elements) of node fields λ and w."""
    out = []
    for t, verts in enumerate(grid.types):
        K, _ = grid.blocks[t]
        acc = 0.0
        for p, vp in enumerate(verts):
            for q, vq in enumerate(verts):
                if K[p, q] != 0.0:
                    acc = acc + float(K[p, q]) * _cell_view(
                        lam, _offset(vp)) * _cell_view(w, _offset(vq))
        out.append(acc)
    return grid.elements_of(torch.stack(out, dim=1))


def fit(grid: Grid, f, u_data, g, *, steps: int, cg_iters: int, warm: bool,
        lr: float, objective: str, eval_iters: int, eval_per_scenario: bool,
        kappa0: float = 1.0):
    """The SGD κ inversion: returns (κ (B, n_elements), loss history
    (steps,), eval loss).

    Each step: u from ``cg_iters`` PCG iterations (from the last step's u
    when ``warm``, else cold), λ from as many on A λ = s·(u − u_data)
    (from the last λ when ``warm``, else 0), κ ← κ − lr · ∂κ.  ``objective``
    'scenario_mean' takes s = 2/n_nodes (each scenario's own mean misfit),
    'batch_mean' s = 2/(B·n_nodes).  The history is the mean of
    (u − u_data)² over batch and nodes at each step's u; the eval loss that
    mean after one cold solve of ``eval_iters`` iterations at the final κ.
    """
    B = f.shape[0]
    shape = (B,) + grid.node_shape
    fg, ug = f.reshape(shape), u_data.reshape(shape)
    n = grid.n_nodes
    s = 2.0 / n if objective == "scenario_mean" else 2.0 / (B * n)
    kappa = torch.full((B, grid.n_elements), kappa0, dtype=f.dtype,
                       device=f.device)
    Fg = load(grid, fg)
    x = lam = None
    history = []
    for _ in range(steps):
        op = Operator(grid, kappa)
        b = op.rhs(Fg, g)
        mg = (op.m * g).expand(shape)
        x0 = x if (warm and x is not None) else mg.contiguous()
        l0 = lam if (warm and lam is not None) else torch.zeros_like(b)
        x = pcg(op, b, x0, cg_iters)
        d = x - ug
        lam = pcg(op, s * d, l0, cg_iters)
        history.append((d * d).mean())
        w = op.m * g + op.p * x
        kappa = kappa + lr * kappa_gradient(grid, op.p * lam, w)
    u = solve(grid, kappa, f, g, eval_iters, eval_per_scenario)
    eval_loss = ((u - u_data) ** 2).mean()
    return kappa, torch.stack(history), eval_loss
