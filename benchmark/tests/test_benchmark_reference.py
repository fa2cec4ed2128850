"""The plain reference (benchmark/reference/fem.py) at tiny sizes: against
a dense assembly and solve of its own, against finite differences, and
its mesh against the program's factories."""

import pytest
import torch

from benchmark.reference import fem

f64 = torch.float64


def _dense(grid, kappa):
    """K (B, n, n) by a plain loop over the elements and their blocks."""
    B = kappa.shape[0]
    K = torch.zeros(B, grid.n_nodes, grid.n_nodes, dtype=f64)
    elems = grid.element_nodes()
    T = len(grid.types)
    for e, nodes in enumerate(elems.tolist()):
        blk, _ = grid.blocks[e % T]
        for p, i in enumerate(nodes):
            for q, j in enumerate(nodes):
                K[:, i, j] += kappa[:, e] * blk[p, q]
    return K


def _eliminated(grid, K):
    m = grid.boundary_mask(f64, "cpu").reshape(-1)
    p = 1.0 - m
    return torch.diag_embed(m.expand(K.shape[0], -1)) + (
        p[:, None] * K * p[None, :])


@pytest.mark.parametrize("cells", [(3, 4), (2, 3, 2)])
def test_stencil_operator_is_the_dense_assembly(cells):
    grid = fem.Grid(cells)
    gen = torch.Generator().manual_seed(1)
    kappa = 0.5 + torch.rand(2, grid.n_elements, generator=gen, dtype=f64)
    op = fem.Operator(grid, kappa)
    v = torch.randn((2,) + grid.node_shape, generator=gen, dtype=f64)
    K = _dense(grid, kappa)
    want = (K @ v.reshape(2, -1, 1)).reshape(v.shape)
    assert torch.allclose(op.stiffness(v), want, atol=1e-13)
    A = _eliminated(grid, K)
    assert torch.allclose(op.apply(v).reshape(2, -1),
                          (A @ v.reshape(2, -1, 1))[..., 0], atol=1e-13)
    # zero row sums and symmetry: a P1 stiffness
    assert float(K.sum(-1).abs().max()) < 1e-12
    assert torch.allclose(K, K.transpose(1, 2))


@pytest.mark.parametrize("cells", [(4, 4), (3, 3, 3)])
def test_converged_pcg_is_the_dense_solve(cells):
    grid = fem.Grid(cells)
    gen = torch.Generator().manual_seed(2)
    kappa = 0.5 + torch.rand(3, grid.n_elements, generator=gen, dtype=f64)
    f = 1.0 + torch.rand(3, grid.n_nodes, generator=gen, dtype=f64)
    u = fem.solve(grid, kappa, f, 0.0, 4 * grid.n_nodes)
    A = _eliminated(grid, _dense(grid, kappa))
    m = grid.boundary_mask(f64, "cpu").reshape(-1)
    F = fem.load(grid, f.reshape((3,) + grid.node_shape)).reshape(3, -1)
    want = torch.linalg.solve(A, ((1.0 - m) * F)[..., None])[..., 0]
    assert float((u - want).abs().max()) < 1e-12 * float(want.abs().max())
    # the load's total is the integral of f's interpolant: area = 1
    assert abs(float(fem.load(grid, torch.ones((1,) + grid.node_shape,
                                                dtype=f64)).sum()) - 1.0) \
        < 1e-12


@pytest.mark.parametrize("cells", [(3, 3), (2, 2, 2)])
def test_kappa_gradient_matches_finite_differences(cells):
    grid = fem.Grid(cells)
    gen = torch.Generator().manual_seed(3)
    kappa = 0.5 + torch.rand(1, grid.n_elements, generator=gen, dtype=f64)
    f = 1.0 + torch.rand(1, grid.n_nodes, generator=gen, dtype=f64)
    ud = torch.rand(1, grid.n_nodes, generator=gen, dtype=f64) * 0.01
    iters = 4 * grid.n_nodes

    def loss(k):
        u = fem.solve(grid, k, f, 0.0, iters)
        return 0.5 * float(((u - ud) ** 2).sum())

    op = fem.Operator(grid, kappa)
    u = fem.solve(grid, kappa, f, 0.0, iters).reshape((1,) + grid.node_shape)
    d = u - ud.reshape(u.shape)
    lam = fem.pcg(op, op.p * d, torch.zeros_like(d), iters)
    grad = -fem.kappa_gradient(grid, op.p * lam, op.p * u)
    for e in (0, grid.n_elements // 2, grid.n_elements - 1):
        step = torch.zeros_like(kappa)
        step[0, e] = 1e-6
        fd = (loss(kappa + step) - loss(kappa - step)) / 2e-6
        assert abs(fd - float(grad[0, e])) <= 1e-6 * max(1e-8, abs(fd)) + 1e-12


@pytest.mark.parametrize("cells", [(4, 3), (3, 2, 4)])
def test_mesh_numbering_is_the_program_s(cells):
    mesh_mod = pytest.importorskip("difffe_tpu_torch.mesh")
    grid = fem.Grid(cells)
    factory = (mesh_mod.FEMesh.rectangle if len(cells) == 2
               else mesh_mod.FEMesh.box)
    mesh = factory(*cells, dtype=f64, device="cpu")
    assert torch.equal(grid.element_nodes(), mesh.elements.cpu())
    assert torch.allclose(grid.nodes(), mesh.nodes)
    assert torch.allclose(grid.centroids(), mesh.nodes[mesh.elements].mean(1))
    assert torch.equal(grid.boundary_mask(f64, "cpu").reshape(-1),
                       mesh.bc_mask)


def test_reference_imports_nothing_of_the_program():
    import ast
    import pathlib

    for path in pathlib.Path(fem.__file__).parent.glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] in ("torch", "math", "itertools",
                                           "__future__"), (path, n)
