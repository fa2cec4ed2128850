"""The yardstick's frozen numbers: the card's published peaks and the work
of the CG kernels, kept here so that no change to the program moves them.

Peaks: NVIDIA's H100 SXM data sheet (dense, no sparsity, at the full
700 W), as ``chip_smoke.py`` (``PEAK_FLOPS``, ``PEAK_BYTES``) and
``difffe_tpu_torch/utils/profiling.CHIP_PEAKS`` ("h100_sxm") hold them.

Work: one Jacobi-PCG iteration a node, counted from the iteration's
arithmetic as ``chip_smoke.py`` counts it (``K3_OPS_PER_NODE_ITER``,
``K4_OPS_PER_NODE_ITER``): on a 2D grid the 5-point apply 9 (5 products,
4 sums), two dots 4, the x, r and p updates 6, the Jacobi scaling 1: 20;
on a 3D box the 7-point apply 13 and the same 11: 24.  Bytes: each value
an op reads or writes, once (``chip_smoke.py``'s counts): K3a reads the 5
folded planes, b, M⁻¹ and x0 and writes x, 9 values a node; K3b adds λ0
and u_data and writes λ, 12; K4a and K4b 11 and 14 with 7 planes.
"""

PEAK_F32_FLOPS = 67e12          # float32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12        # HBM3
ITEM_BYTES = 4                  # float32

#: operations of one PCG iteration a node, by the mesh's dimension
CG_OPS_PER_NODE_ITER = {2: 20, 3: 24}

#: the program's CG ops: name → (solves a call, position of ``iters`` and
#: of ``b`` among the op's arguments, node axes of ``b`` after the batch,
#: values a node read or written once)
CG_OPS = {
    "difffe::stencil_cg": (1, 4, 1, 2, 9),
    "difffe::stencil_cg2": (2, 7, 1, 2, 12),
    "difffe::stencil3d_cg": (1, 4, 1, 3, 11),
    "difffe::stencil3d_cg2": (2, 7, 1, 3, 14),
}


def cg_operations(dim: int, nodes: int, iterations: int) -> float:
    """Operations of ``iterations`` PCG iterations on ``nodes`` nodes (all
    scenarios of a batch together)."""
    return float(CG_OPS_PER_NODE_ITER[dim]) * nodes * iterations


def least_seconds(operations: float, nbytes: float) -> float:
    """The least time the card could take: operations at the float32 peak
    or bytes at the HBM peak, whichever is longer."""
    return max(operations / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES)


def op_call_work(name: str, concrete_inputs, input_dims):
    """(operations, bytes) of one call of a CG op, from its arguments as
    the profiler records them (``Concrete Inputs``, ``Input Dims``); None
    for an op this table does not hold or a record without them."""
    if name not in CG_OPS:
        return None
    solves, at_iters, at_b, node_axes, values = CG_OPS[name]
    try:
        iters = int(concrete_inputs[at_iters])
        dims = [int(d) for d in input_dims[at_b]]
    except (IndexError, TypeError, ValueError):
        return None
    if len(dims) != node_axes + 1:
        return None
    nodes = 1
    for d in dims:
        nodes *= d
    return (solves * cg_operations(node_axes, nodes, iters),
            float(values) * nodes * ITEM_BYTES)
