"""The port's native meshtool (difffe_tpu_torch/native/) against the JAX
package's (difffe_tpu/native/) on the same arrays, on both of the port's
paths: the C++ library it builds from its own source into
difffe_tpu_torch/_build/, and its numpy versions.  Integer outputs are
equal; the triangle quality within 1e-12.
"""

import contextlib
import functools
import shutil

import numpy as np
import pytest
import torch

from difffe_tpu import native as jnat
from difffe_tpu.mesh import FEMesh as JMesh
from difffe_tpu_torch import native as tnat
from difffe_tpu_torch.native import meshtool as tmt
from difffe_tpu_torch.solver import solve_poisson
from torch_parity import jax_mesh, port_mesh

torch.set_num_threads(1)


@contextlib.contextmanager
def _path(which):
    """Run the port's meshtool on ``which``: "native" or "numpy"."""
    if which == "native":
        assert tnat.backend() == "native"
        yield
        return
    saved = tmt._lib, tmt._tried
    tmt._lib, tmt._tried = None, True
    try:
        assert tnat.backend() == "numpy"
        yield
    finally:
        tmt._lib, tmt._tried = saved


# the native path where g++ is on PATH, the numpy one always
PATHS = (["native"] if shutil.which("g++") else []) + ["numpy"]


@functools.lru_cache(maxsize=None)
def _arrays(name):
    """(nodes, elements, n_nodes) of a rectangle, or of the same rectangle
    with its nodes renumbered at random (what RCM is for)."""
    jm = jax_mesh(JMesh.rectangle, 5, 3) if name == "rect" else \
        jax_mesh(JMesh.rectangle, 8, 8)
    nodes, elements = np.asarray(jm.nodes), np.asarray(jm.elements)
    n = nodes.shape[0]
    if name == "shuffled":
        perm = np.random.default_rng(0).permutation(n).astype(np.int32)
        inv = np.zeros_like(perm)
        inv[perm] = np.arange(n, dtype=np.int32)
        nodes, elements = nodes[perm], inv[elements]
    return nodes, elements, n


def test_backend_builds_the_ports_own_source():
    """With g++ the library is built from difffe_tpu_torch/native/ into
    difffe_tpu_torch/_build/, never beside the source."""
    want = "native" if shutil.which("g++") else "numpy"
    assert tnat.backend() == want
    path = tmt.library_path()
    assert path.parent.name == "_build"
    assert path.parent.parent.name == "difffe_tpu_torch"
    assert path.is_file() == (want == "native")
    assert not list(tmt._SOURCE.parent.glob("*.so"))


@pytest.mark.parametrize("name", ["rect", "shuffled"])
@pytest.mark.parametrize("path", PATHS)
def test_graph_functions_match_jax(path, name):
    nodes, elements, n = _arrays(name)
    rp_j, ci_j = jnat.build_adjacency(elements, n)
    perm_j = jnat.rcm_order(rp_j, ci_j)
    with _path(path):
        rp, ci = tnat.build_adjacency(elements, n)
        np.testing.assert_array_equal(rp, rp_j)
        for v in range(n):       # each row's neighbours, in any order
            np.testing.assert_array_equal(np.sort(ci[rp[v]:rp[v + 1]]),
                                          np.sort(ci_j[rp[v]:rp[v + 1]]))
        perm = tnat.rcm_order(rp_j, ci_j)
        np.testing.assert_array_equal(perm, perm_j)
        assert sorted(perm.tolist()) == list(range(n))
        for p in (None, perm_j):
            assert tnat.graph_bandwidth(rp_j, ci_j, p) == \
                jnat.graph_bandwidth(rp_j, ci_j, p)
        np.testing.assert_array_equal(
            tnat.boundary_nodes_tri(elements, n),
            jnat.boundary_nodes_tri(elements, n))
        np.testing.assert_allclose(tnat.tri_quality(nodes, elements),
                                   jnat.tri_quality(nodes, elements),
                                   rtol=1e-12, atol=1e-12)
    if name == "shuffled":
        assert tnat.graph_bandwidth(rp_j, ci_j, perm_j) < \
            tnat.graph_bandwidth(rp_j, ci_j)


@pytest.mark.parametrize("path", PATHS)
def test_reorder_mesh_matches_jax(path):
    """The port's reorder_mesh takes and returns its FEMesh (on its
    device), with the JAX function's arrays, and the solve maps back."""
    jm = jax_mesh(JMesh.rectangle, 6, 6)
    tm = port_mesh(jm)
    j_re, j_perm = jnat.reorder_mesh(jm)
    with _path(path):
        t_re, t_perm = tnat.reorder_mesh(tm)
    np.testing.assert_array_equal(t_perm, j_perm)
    assert t_re.device == tm.device and t_re.grid is None
    for a, b in ((t_re.nodes, j_re.nodes), (t_re.elements, j_re.elements),
                 (t_re.bc_mask, j_re.bc_mask),
                 (t_re.bc_values, j_re.bc_values)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    f = torch.sin(torch.arange(tm.n_nodes, dtype=tm.dtype))
    u = solve_poisson(tm, 1.0, f, method="dense")
    p = torch.as_tensor(t_perm.astype(np.int64))
    u_re = solve_poisson(t_re, 1.0, f[p], method="dense")
    torch.testing.assert_close(u_re, u[p], rtol=0.0, atol=1e-12)
