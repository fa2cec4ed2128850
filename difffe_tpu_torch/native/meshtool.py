"""ctypes bindings for the native meshtool (C++), with numpy versions.

PyTorch counterpart of ``difffe_tpu/native/meshtool.py``.  The first call
builds ``meshtool.cpp`` with ``g++`` into ``difffe_tpu_torch/_build/``
(``libmeshtool_<hash>.so``, named by a hash of the source and the flags,
so an edit rebuilds and an unchanged tree reuses the library) and loads
it; where there is no compiler, or the build fails, every function runs
its plain numpy version, which computes the same arrays.  ``backend()``
reports which path is active: ``"native"`` or ``"numpy"``.  Host code: the
arrays are numpy's, and :func:`reorder_mesh` takes and returns the port's
``FEMesh`` on its device.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_SOURCE = Path(__file__).resolve().with_name("meshtool.cpp")
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    h.update(_SOURCE.read_bytes())
    return _BUILD_DIR / f"libmeshtool_{h.hexdigest()[:16]}.so"


def _build() -> Optional[Path]:
    """Compile the source unless its library exists; None without g++ or
    when the build fails."""
    out = library_path()
    if out.is_file():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        return None
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    try:
        subprocess.run([cxx, *_FLAGS, str(_SOURCE), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)        # atomic: concurrent builds agree
    except (OSError, subprocess.SubprocessError):
        return None
    finally:
        tmp.unlink(missing_ok=True)
    return out


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    path = _build()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None

    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f64p = ctypes.POINTER(ctypes.c_double)

    lib.build_adjacency.restype = ctypes.c_int64
    lib.build_adjacency.argtypes = [i32p, ctypes.c_int64, ctypes.c_int32,
                                    ctypes.c_int64, i64p, i32p,
                                    ctypes.c_int64]
    lib.rcm_order.restype = None
    lib.rcm_order.argtypes = [i64p, i32p, ctypes.c_int64, i32p]
    lib.graph_bandwidth.restype = ctypes.c_int64
    lib.graph_bandwidth.argtypes = [i64p, i32p, ctypes.c_int64, i32p]
    lib.boundary_nodes_tri.restype = None
    lib.boundary_nodes_tri.argtypes = [i32p, ctypes.c_int64, ctypes.c_int64,
                                       u8p]
    lib.tri_quality.restype = None
    lib.tri_quality.argtypes = [f64p, i32p, ctypes.c_int64, f64p]
    _lib = lib
    return _lib


def backend() -> str:
    """``"native"`` where the C++ library loads, else ``"numpy"``."""
    return "native" if _load() is not None else "numpy"


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


# --------------------------------------------------------------------------
# API
# --------------------------------------------------------------------------

def build_adjacency(elements: np.ndarray, n_nodes: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """CSR node adjacency (row_ptr int64 (n+1,), col_idx int32)."""
    elements = np.ascontiguousarray(elements, dtype=np.int32)
    ne, npe = elements.shape
    lib = _load()
    if lib is not None:
        row_ptr = np.zeros(n_nodes + 1, dtype=np.int64)
        total = lib.build_adjacency(_ptr(elements, ctypes.c_int32), ne, npe,
                                    n_nodes, _ptr(row_ptr, ctypes.c_int64),
                                    None, 0)
        col_idx = np.zeros(max(total, 1), dtype=np.int32)
        lib.build_adjacency(_ptr(elements, ctypes.c_int32), ne, npe,
                            n_nodes, _ptr(row_ptr, ctypes.c_int64),
                            _ptr(col_idx, ctypes.c_int32), total)
        return row_ptr, col_idx[:total]
    src = np.repeat(elements, npe, axis=1).ravel()
    dst = np.tile(elements, (1, npe)).ravel()
    keep = src != dst
    pairs = np.unique(np.stack([src[keep], dst[keep]], axis=1), axis=0)
    row_ptr = np.zeros(n_nodes + 1, dtype=np.int64)
    np.add.at(row_ptr, pairs[:, 0] + 1, 1)
    row_ptr = np.cumsum(row_ptr)
    return row_ptr, pairs[:, 1].astype(np.int32)


def rcm_order(row_ptr: np.ndarray, col_idx: np.ndarray) -> np.ndarray:
    """Reverse Cuthill-McKee permutation: perm[i] = old index at new pos i."""
    n = len(row_ptr) - 1
    lib = _load()
    if lib is not None:
        row_ptr = np.ascontiguousarray(row_ptr, dtype=np.int64)
        col_idx = np.ascontiguousarray(col_idx, dtype=np.int32)
        perm = np.zeros(n, dtype=np.int32)
        lib.rcm_order(_ptr(row_ptr, ctypes.c_int64),
                      _ptr(col_idx, ctypes.c_int32), n,
                      _ptr(perm, ctypes.c_int32))
        return perm
    # breadth-first by degree from the lowest-degree unvisited node
    degree = np.diff(row_ptr)
    visited = np.zeros(n, dtype=bool)
    order = []
    while len(order) < n:
        seeds = np.nonzero(~visited)[0]
        start = seeds[np.argmin(degree[seeds])]
        queue = [int(start)]
        visited[start] = True
        while queue:
            v = queue.pop(0)
            order.append(v)
            nbrs = col_idx[row_ptr[v]:row_ptr[v + 1]]
            nbrs = [int(w) for w in nbrs if not visited[w]]
            for w in sorted(nbrs, key=lambda w: degree[w]):
                visited[w] = True
                queue.append(w)
    return np.array(order[::-1], dtype=np.int32)


def graph_bandwidth(row_ptr: np.ndarray, col_idx: np.ndarray,
                    perm: Optional[np.ndarray] = None) -> int:
    """Matrix bandwidth of the adjacency under optional reordering."""
    n = len(row_ptr) - 1
    inv = None
    if perm is not None:
        inv = np.zeros(n, dtype=np.int32)
        inv[perm] = np.arange(n, dtype=np.int32)
    lib = _load()
    if lib is not None:
        row_ptr = np.ascontiguousarray(row_ptr, dtype=np.int64)
        col_idx = np.ascontiguousarray(col_idx, dtype=np.int32)
        ip = _ptr(inv, ctypes.c_int32) if inv is not None else None
        return int(lib.graph_bandwidth(_ptr(row_ptr, ctypes.c_int64),
                                       _ptr(col_idx, ctypes.c_int32), n, ip))
    bw = 0
    for v in range(n):
        pv = inv[v] if inv is not None else v
        for w in col_idx[row_ptr[v]:row_ptr[v + 1]]:
            pw = inv[w] if inv is not None else int(w)
            bw = max(bw, abs(int(pv) - int(pw)))
    return bw


def boundary_nodes_tri(elements: np.ndarray, n_nodes: int) -> np.ndarray:
    """Boolean mask of nodes on boundary edges of a triangle mesh."""
    elements = np.ascontiguousarray(elements, dtype=np.int32)
    lib = _load()
    if lib is not None:
        mask = np.zeros(n_nodes, dtype=np.uint8)
        lib.boundary_nodes_tri(_ptr(elements, ctypes.c_int32),
                               elements.shape[0], n_nodes,
                               _ptr(mask, ctypes.c_uint8))
        return mask.astype(bool)
    edges = np.concatenate([elements[:, [0, 1]], elements[:, [1, 2]],
                            elements[:, [2, 0]]])
    edges = np.sort(edges, axis=1)
    uniq, counts = np.unique(edges, axis=0, return_counts=True)
    mask = np.zeros(n_nodes, dtype=bool)
    mask[uniq[counts == 1].ravel()] = True
    return mask


def tri_quality(nodes: np.ndarray, elements: np.ndarray) -> np.ndarray:
    """Per-triangle [area, min_angle_rad, aspect_ratio] (n_elements, 3)."""
    nodes = np.ascontiguousarray(nodes, dtype=np.float64)
    elements = np.ascontiguousarray(elements, dtype=np.int32)
    lib = _load()
    if lib is not None:
        out = np.zeros((elements.shape[0], 3), dtype=np.float64)
        lib.tri_quality(_ptr(nodes, ctypes.c_double),
                        _ptr(elements, ctypes.c_int32), elements.shape[0],
                        _ptr(out, ctypes.c_double))
        return out
    p = nodes[elements]                       # (ne, 3, 2)
    a = p[:, 1] - p[:, 0]
    b = p[:, 2] - p[:, 1]
    c = p[:, 0] - p[:, 2]
    la, lb, lc = (np.linalg.norm(v, axis=1) for v in (a, b, c))
    area = 0.5 * np.abs(a[:, 0] * (-c[:, 1]) - a[:, 1] * (-c[:, 0]))

    def ang(opp, s1, s2):
        cosv = np.clip((s1 ** 2 + s2 ** 2 - opp ** 2) / (2 * s1 * s2), -1, 1)
        return np.arccos(cosv)

    mins = np.minimum(np.minimum(ang(lb, la, lc), ang(lc, la, lb)),
                      ang(la, lb, lc))
    lmax = np.maximum(np.maximum(la, lb), lc)
    lmin = np.minimum(np.minimum(la, lb), lc)
    aspect = np.where(lmin > 0, lmax / lmin, np.inf)
    return np.stack([area, mins, aspect], axis=1)


def reorder_mesh(mesh):
    """Return (reordered FEMesh, perm): RCM-renumbered nodes for bandwidth
    and locality, on the mesh's device, with no grid (the numbering is no
    longer the grid's).  Solutions map back via u_old = u_new[inv_perm]."""
    import torch

    from ..mesh import FEMesh

    elements = mesh.elements.detach().cpu().numpy()
    row_ptr, col_idx = build_adjacency(elements, mesh.n_nodes)
    perm = rcm_order(row_ptr, col_idx)
    inv = np.zeros_like(perm)
    inv[perm] = np.arange(len(perm), dtype=np.int32)
    p = torch.as_tensor(perm.astype(np.int64), device=mesh.device)
    new_mesh = FEMesh(
        nodes=mesh.nodes[p], elements=torch.as_tensor(
            inv[elements].astype(np.int64), device=mesh.device),
        bc_mask=mesh.bc_mask[p], bc_values=mesh.bc_values[p])
    return new_mesh, perm
