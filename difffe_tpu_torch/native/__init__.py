"""Native (C++) host components: mesh preprocessing via ctypes with numpy
versions (meshtool.py / meshtool.cpp)."""

from .meshtool import (
    backend,
    boundary_nodes_tri,
    build_adjacency,
    graph_bandwidth,
    rcm_order,
    reorder_mesh,
    tri_quality,
)

__all__ = [
    "backend",
    "boundary_nodes_tri",
    "build_adjacency",
    "graph_bandwidth",
    "rcm_order",
    "reorder_mesh",
    "tri_quality",
]
