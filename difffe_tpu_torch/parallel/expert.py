"""Expert parallelism: a sharded bank of per-regime surrogate experts on
``torch.distributed``.

PyTorch counterpart of ``difffe_tpu/parallel/expert.py``.  The experts
are operator surrogates (``models.neural.MLP``s): PDE scenarios live in
distinct κ-regimes, each regime gets its own expert, and the bank is
split over the ``ep_axis`` mesh dimension while scenarios stay on
``dp_axis``.

GShard-style dispatch with static shapes:

  1. route:    expert id per scenario from a κ-statistic bucketing;
  2. dispatch: one-hot (B, E, C) tensor D; expert inputs are the einsum
               ``ecd = Σ_b D[b,e,c] · X[b,d]``;
  3. apply:    one ``torch.func.vmap`` over the stacked expert parameters
               (``mlp_bank`` builds them and the ``functional_call``);
  4. combine:  the transpose einsum back to (B, d).

Gradients flow to the expert parameters and through the combine back to
the inputs; the router is a hard assignment and contributes none.
Capacity: each expert takes at most C scenarios, in batch order; the rest
are dropped (zero rows, and a ``dropped`` count).

With ``dmesh``, X is this rank's dp shard of the scenarios (whole over
the ep group, as JAX's ``P(dp, None)``), and the capacity slots are those
of the whole batch: a scenario's place in its expert's queue counts the
scenarios of every earlier dp shard, so the drops are the unsharded
call's.  Each ep rank owns E/P experts and dispatches 1/P of its shard's
rows: the dispatched rows travel to their experts' ranks by
``all_to_all_single``, the expert outputs come back by the same exchange
(the transpose), and an all-gather over the ep group returns Y whole
there.  Gradients follow the package's convention
(parallel/_collectives.py): a rank's gradients of the bank and of X are
partials whose sum over the mesh is the gradient.
"""

from __future__ import annotations

import copy
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F_
from torch.utils._pytree import tree_leaves, tree_map

from ._collectives import all_gather, all_to_all, rank_slice


def route_by_bucket(values: torch.Tensor,
                    boundaries: torch.Tensor) -> torch.Tensor:
    """Expert ids (B,) int32 from bucketing ``values`` (B,) at
    ``boundaries`` (E-1,) sorted ascending — e.g. mean-log-κ quantiles per
    regime."""
    return torch.searchsorted(boundaries.contiguous(),
                              values.contiguous()).to(torch.int32)


def _positions(expert_ids, n_experts, offset=None):
    """Each scenario's 0-based place in its expert's queue (−1 in the
    other experts' columns), (B, E) int32; ``offset`` (E,) counts earlier
    scenarios."""
    onehot = F_.one_hot(expert_ids.long(), n_experts).to(torch.int32)
    pos = torch.cumsum(onehot, dim=0, dtype=torch.int32)
    if offset is not None:
        pos = pos + offset
    return pos * onehot - 1, onehot


def _dispatch(pos, capacity):
    keep = (pos >= 0) & (pos < capacity)
    D = (F_.one_hot(pos.clamp(0, capacity - 1).long(), capacity)
         .to(torch.float32) * keep[..., None].to(torch.float32))
    return D, keep


def make_dispatch(expert_ids: torch.Tensor, n_experts: int,
                  capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatch tensor D (B, E, C) float32 and the number of dropped
    scenarios (int32).

    D[b, e, c] = 1 iff scenario b is the c-th scenario routed to expert e
    and c < capacity.  Scenarios past an expert's capacity are dropped
    (row of zeros → combine returns zeros for them).
    """
    pos, _ = _positions(expert_ids, n_experts)
    D, keep = _dispatch(pos, capacity)
    # keep-count in int32: a float32 sum is integer-exact only to 2^24
    dropped = expert_ids.shape[0] - keep.to(torch.int32).sum(
        dtype=torch.int32)
    return D, dropped


def mlp_bank(nets: Sequence[torch.nn.Module]):
    """(params_stacked, apply_fn) of a bank of same-shaped
    ``models.neural.MLP`` experts for :func:`moe_apply`: their parameters
    stacked on a leading expert axis (``torch.func.stack_module_state``)
    and ``apply_fn(params, x (C, d_in)) → (C, d_out)``, one net's forward
    as a ``torch.func.functional_call``."""
    from torch.func import functional_call, stack_module_state

    params, _ = stack_module_state(list(nets))
    base = copy.deepcopy(nets[0]).to("meta")
    base.squeeze = False

    def apply_fn(p, x):
        return functional_call(base, p, (x,))

    return params, apply_fn


def moe_apply(
    params_stacked,
    X: torch.Tensor,
    expert_ids: torch.Tensor,
    apply_fn: Callable,
    capacity: Optional[int] = None,
    dmesh=None,
    ep_axis: str = "dof",
    dp_axis: str = "dp",
):
    """Apply the expert bank: X (B, d_in) → (Y (B, d_out), dropped).

    params_stacked: a nest of tensors with a leading E axis on every leaf
    (one expert a slice; ``mlp_bank``).  apply_fn(params, x_batch) →
    y_batch is the single-expert forward.  capacity defaults to 2·B/E of
    the whole batch.  With ``dmesh``: X and expert_ids are this rank's dp
    shard, Y comes back as the same shard, and ``dropped`` counts the
    whole batch (module note); E and the shard's rows must divide by the
    ep size.  Dropped scenarios return zero rows.
    """
    from torch.func import vmap

    E = tree_leaves(params_stacked)[0].shape[0]
    if dmesh is None:
        B = X.shape[0]
        C = capacity if capacity is not None else max(1, (2 * B) // E)
        D, dropped = make_dispatch(expert_ids, E, C)
        D = D.to(X.dtype)
        Xe = torch.einsum("bec,bd->ecd", D, X)          # (E, C, d_in)
        Ye = vmap(apply_fn)(params_stacked, Xe)          # (E, C, d_out)
        return torch.einsum("bec,ecd->bd", D, Ye), dropped

    dp, ep = dmesh.get_group(dp_axis), dmesh.get_group(ep_axis)
    P_ep, j = dist.get_world_size(ep), dist.get_rank(ep)
    if E % P_ep:
        raise ValueError(f"{E} experts are not divisible by the {P_ep} "
                         f"ranks of mesh axis {ep_axis!r}")
    Eb = E // P_ep
    B = X.shape[0] * dist.get_world_size(dp)
    C = capacity if capacity is not None else max(1, (2 * B) // E)

    # places in the queues of the whole batch: the counts of earlier dp
    # shards come first
    counts = F_.one_hot(expert_ids.long(), E).to(torch.int64).sum(0)
    every = [torch.empty_like(counts) for _ in range(dist.get_world_size(dp))]
    dist.all_gather(every, counts, group=dp)
    offset = sum(every[:dist.get_rank(dp)], torch.zeros_like(counts))
    pos, _ = _positions(expert_ids, E, offset.to(torch.int32))
    D, keep = _dispatch(pos, C)
    dropped = (expert_ids.shape[0] - keep.to(torch.int32).sum()).to(
        torch.int32)
    dist.all_reduce(dropped, group=dp)

    # this ep rank's rows go to every expert's rank and come back
    D = rank_slice(D.to(X.dtype), ep, 0)                 # (Bc, E, C)
    Xe = torch.einsum("bec,bd->ecd", D, rank_slice(X, ep, 0))
    Xe = all_to_all(Xe, ep).reshape((P_ep, Eb) + Xe.shape[1:]).sum(0)
    mine = tree_map(lambda p: p[j * Eb:(j + 1) * Eb], params_stacked)
    Ye = vmap(apply_fn)(mine, Xe)                        # (Eb, C, d_out)
    Ye = all_to_all(Ye.expand((P_ep,) + Ye.shape).reshape(
        (E,) + Ye.shape[1:]), ep)                        # (E, C, d_out)
    Y = torch.einsum("bec,ecd->bd", D, Ye)
    return all_gather(Y, ep, dim=0), dropped
