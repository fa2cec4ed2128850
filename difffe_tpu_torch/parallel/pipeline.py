"""Pipeline parallelism over the TIME axis: GPipe-style heat-rollout chunks
on ``torch.distributed``.

PyTorch counterpart of ``difffe_tpu/parallel/pipeline.py``.  The horizon
H is split into P contiguous chunks, one a rank of the ``axis`` mesh
dimension (a stage); the scenario batch is split into M microbatches that
stream through the stages.  At outer step s, stage d advances microbatch
s − d through its Hc = H/P steps — the classic schedule with bubble
fraction (P − 1)/(M + P − 1) — and hands the state to stage d + 1 with the
package's exchange (point-to-point sends; the last stage sends nothing,
stage 0 receives nothing, and nothing is sent at depth 1).  The chunk
stepper is the port's backward-Euler step, ``control.heat
.heat_step_tridiag`` on its ``resolve_method`` route: on the card every
solve is kernel K2, a launch a step forward and one a step backward.

As the JAX program, every stage runs every outer step and masks the
steps that are not its own: the ranks build the same autograd graph,
which keeps their collectives paired in the backward pass.  The whole
pipeline is differentiable to κ, u0 and f_seq through the hand-offs.
Inputs are whole on every rank; the outputs — the last stage's finals and
the sum of every stage's cost — are all-reduced over the stages (and the
finals gathered, the costs summed, over a dp dimension that splits the
microbatches), so they are whole on every rank too.  Gradients follow the
package's convention (parallel/_collectives.py): a rank's gradients of
κ, u0 and f_seq are its stage's partials, whose sum over the mesh is the
gradient.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from ..control.heat import heat_step_tridiag, heat_system_tridiag
from ..mesh import FEMesh
from ..ops.assembly import assemble_lumped_mass
from ._collectives import all_gather, all_reduce, exchange, rank_slice


def pipelined_rollout(
    dmesh,
    mesh: FEMesh,
    kappa,
    u0,
    f_seq,
    dt: float,
    n_micro: Optional[int] = None,
    axis: str = "dof",
    cost_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
):
    """Pipeline the backward-Euler heat rollout over ``axis`` of ``dmesh``.

    mesh: 1D chain FEMesh (tridiagonal stepper); kappa: scalar or
    per-element; u0: (B, n); f_seq: (H, B, n) nodal forcing per step, all
    whole on every rank.  H must divide by the pipeline depth P, B by
    ``n_micro`` (default: one microbatch a stage).  Another mesh dimension
    of size > 1 that divides the microbatch splits its scenarios.

    Returns ``u_final (B, n)`` — the state after all H steps — or
    ``(u_final, cost)`` when ``cost_fn`` (per-step ``u (Bm, n) → scalar``)
    is given; the cost is the sum over all steps and microbatches.
    """
    group = dmesh.get_group(axis)
    Pn, d = dist.get_world_size(group), dist.get_rank(group)
    dtype, dev = mesh.dtype, mesh.device
    u0 = torch.as_tensor(u0, dtype=dtype, device=dev)
    f_seq = torch.as_tensor(f_seq, dtype=dtype, device=dev)
    H, B, n = f_seq.shape
    M = n_micro if n_micro is not None else Pn
    if H % Pn:
        raise ValueError(f"horizon {H} not divisible by pipeline depth {Pn}")
    if B % M:
        raise ValueError(f"batch {B} not divisible by n_micro {M}")
    Hc, Bm = H // Pn, B // M

    M_lump = assemble_lumped_mass(mesh)
    bands = heat_system_tridiag(
        mesh, torch.as_tensor(kappa, dtype=dtype, device=dev), dt)

    # (H, B, n) → this stage's window (Hc, M, Bm, n)
    f_loc = f_seq.reshape(Pn, Hc, M, Bm, n)[d]
    u0_m = u0.reshape(M, Bm, n)
    dp_group = next(
        (g for g in (dmesh.get_group(a) for a in dmesh.mesh_dim_names
                     if a != axis)
         if dist.get_world_size(g) > 1 and Bm % dist.get_world_size(g) == 0),
        None)
    if dp_group is not None:
        f_loc = rank_slice(f_loc, dp_group, 2)
        u0_m = rank_slice(u0_m, dp_group, 1)

    def chunk(u, f_chunk):
        """Advance one microbatch through this stage's Hc steps."""
        cost = u.new_zeros(())
        for t in range(Hc):
            u = heat_step_tridiag(mesh, bands, M_lump, u, f_chunk[t], dt)
            if cost_fn is not None:
                cost = cost + cost_fn(u)
        return u, cost

    # rank-dependent choices are 0/1 weights (w·a + (1 − w)·b is a or b
    # exactly), so every rank builds the same graph
    cur = torch.zeros_like(u0_m[0])
    finals = [torch.zeros_like(cur) for _ in range(M)]
    cost_total = cur.new_zeros(())
    S = M + Pn - 1
    for s in range(S):
        m = min(max(s - d, 0), M - 1)
        valid = float(0 <= s - d <= M - 1)
        w = float(d == 0 and s < M)      # stage 0 injects microbatch s
        cur = w * u0_m[min(s, M - 1)] + (1.0 - w) * cur
        new, cost = chunk(cur, f_loc[:, m])
        cost_total = cost_total + valid * cost
        done = valid * float(d == Pn - 1)  # the last stage keeps finals
        finals[m] = done * new + (1.0 - done) * finals[m]
        if s < S - 1:                     # hand the state to stage d + 1
            cur, _ = exchange(group, None, valid * new)

    finals = all_reduce(torch.stack(finals), group)
    cost_total = all_reduce(cost_total, group)
    if dp_group is not None:
        finals = all_gather(finals, dp_group, dim=1)
        cost_total = all_reduce(cost_total, dp_group)
    u_final = finals.reshape(B, n)
    if cost_fn is not None:
        return u_final, cost_total
    return u_final
