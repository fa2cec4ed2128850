"""Device meshes and the scenario-sharded κ-inversion step on
``torch.distributed``.

PyTorch counterpart of ``difffe_tpu/parallel/sharding.py``.  A mesh is a
``torch.distributed`` ``DeviceMesh`` with dimensions ``("dp", "dof")``
over the ranks of the default process group (parallel/multihost.py); a
dimension's process group is ``mesh.get_group("dof")``.

Where JAX places global arrays with a ``NamedSharding`` and lets GSPMD
insert the collectives, the port is explicit SPMD: every rank runs the
same program on its own shard, and the collectives are written out
(parallel/_collectives.py, whose cotangent convention every function of
this package follows).  :class:`Sharding` is a small dataclass, the mesh
and a ``PartitionSpec``-like tuple (a mesh dimension name or None for
each tensor dimension); :meth:`Sharding.local` cuts a rank's shard out of
a whole tensor by its mesh coordinate.

* **dp — scenario-batch parallelism**: the B axis of (log κ, f, u_data)
  is split over ``"dp"``; each rank solves its scenarios, and only the
  loss's sum of squares and count are all-reduced.
* **dof — DOF sharding**: f and u_data split over ``"dof"`` along their
  node axis.  JAX gets this from GSPMD; the port all-gathers f within the
  dof group before the solve (the all-gather's backward reduce-scatters)
  and keeps the rank's own node columns of u after it (u_data needs no
  gather: only the rank's own columns are compared).  Every rank of a
  dof group holds its dp shard's log κ whole, so their gradients are
  summed over the group before the update.  The step's result equals the
  unsharded step's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..inverse import _adam
from ..mesh import FEMesh
from ..solver import solve_poisson_batched
from ._collectives import all_gather, all_reduce, rank_slice


def make_device_mesh(
    n_devices: Optional[int] = None,
    mesh_shape: Optional[Tuple[int, int]] = None,
    axis_names: Tuple[str, str] = ("dp", "dof"),
    devices: Optional[str] = None,
):
    """Build a 2D (dp × dof) ``DeviceMesh`` over every rank of the default
    process group (``multihost.initialize`` makes it; without one this
    raises).

    Default: all ranks on the dp (scenario) axis, dof = 1.  ``n_devices``,
    where given, must equal the group's size.  ``devices``: the mesh's
    device type, ``"cuda"`` or ``"cpu"`` (default: the group's backend's,
    NCCL → cuda, gloo → cpu).
    """
    if not dist.is_initialized():
        raise RuntimeError(
            "make_device_mesh needs an initialized process group: call "
            "difffe_tpu_torch.parallel.multihost.initialize() first")
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"n_devices {n_devices} != the {n} ranks of the "
                         f"process group")
    if mesh_shape is None:
        mesh_shape = (n, 1)
    if math.prod(mesh_shape) != n:
        raise ValueError(f"mesh_shape {mesh_shape} != {n} devices")
    if devices is None:
        devices = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(devices, tuple(mesh_shape),
                            mesh_dim_names=tuple(axis_names))


@dataclasses.dataclass(frozen=True)
class Sharding:
    """How a tensor lies on ``mesh``: ``spec[i]`` names the mesh dimension
    that tensor dimension i is split over, or None (replicated); trailing
    dimensions past ``spec`` are replicated (JAX's ``NamedSharding``)."""

    mesh: object
    spec: Tuple[Optional[str], ...]

    def local(self, x) -> torch.Tensor:
        """This rank's shard of the whole tensor ``x``, on the mesh's
        device (each split dimension must divide by its mesh size)."""
        x = torch.as_tensor(x)
        for dim, axis in enumerate(self.spec):
            if axis is not None:
                x = rank_slice(x, self.mesh.get_group(axis), dim)
        return x.to(self.mesh.device_type)


def batch_sharding(mesh) -> Sharding:
    """Scenario-batched array (B, ...): B over dp, trailing axes replicated."""
    return Sharding(mesh, ("dp",))


def batch_dof_sharding(mesh) -> Sharding:
    """(B, n_dof) array: B over dp, DOFs over dof."""
    return Sharding(mesh, ("dp", "dof"))


def replicated(mesh) -> Sharding:
    return Sharding(mesh, ())


def shard_batch(mesh, *arrays, shard_dof: bool = False):
    """Each rank's shards of scenario-batched arrays (whole on input)."""
    sh = batch_dof_sharding(mesh) if shard_dof else batch_sharding(mesh)
    out = tuple(sh.local(a) for a in arrays)
    return out[0] if len(out) == 1 else out


# --------------------------------------------------------------------------
# Flagship distributed training step: batched κ-field inversion
# --------------------------------------------------------------------------

def _inversion_step(fe_mesh: FEMesh, device_mesh, lr: float, method: str,
                    shard_dof: bool):
    """(init_fn, step_fn) of the explicit-SPMD Adam step that
    make_inversion_step and make_inversion_step_shard_map return."""
    groups = [device_mesh.get_group(a) for a in device_mesh.mesh_dim_names]
    dof = device_mesh.get_group("dof")
    n_ranks = device_mesh.size()
    state_sh = batch_sharding(device_mesh)

    def init_fn(log_k0):
        log_k = state_sh.local(torch.as_tensor(log_k0, dtype=fe_mesh.dtype))
        log_k = log_k.detach().clone().requires_grad_()
        return log_k, _adam([log_k], lr)

    def step_fn(log_k, opt_state, f, u_data):
        if opt_state.param_groups[0]["params"][0] is not log_k:
            raise ValueError("opt_state must be the optimizer init_fn "
                             "returned with this log_k")
        opt_state.zero_grad(set_to_none=True)
        if shard_dof:
            f = all_gather(f, dof, dim=-1)
        u = solve_poisson_batched(fe_mesh, torch.exp(log_k), f,
                                  method=method, kappa_batched=True)
        if shard_dof:
            u = rank_slice(u, dof, -1)
        total = ((u - u_data) ** 2).sum()
        count = u.new_full((), float(u.numel()))
        for group in groups:
            total = all_reduce(total, group)
            dist.all_reduce(count, group=group)
        loss = total / count
        # every rank holds the loss whole: each seeds 1/N of its
        # cotangent, which the all-reduces' backward sums to 1
        torch.autograd.backward(loss, loss.new_tensor(1.0 / n_ranks))
        if dist.get_world_size(dof) > 1:
            dist.all_reduce(log_k.grad, group=dof)
        opt_state.step()
        return log_k, opt_state, loss.detach()

    return init_fn, step_fn


def make_inversion_step(
    fe_mesh: FEMesh,
    device_mesh,
    lr: float = 0.1,
    method: str = "auto",
    shard_dof: bool = False,
):
    """Build (init_fn, step_fn, data_sharding) for scenario-batched κ
    recovery.

    Each scenario b learns log κ_b minimizing MSE(u(exp(log κ_b), f_b),
    u_data_b).  ``init_fn(log_k0)`` takes the whole (B, …) initial state
    and returns this rank's dp shard (a leaf tensor) and its Adam
    optimizer (``optax.adam``'s defaults); ``step_fn(log_k, opt_state, f,
    u_data)`` takes the rank's shards of f and u_data (``data_sharding
    .local`` cuts them) and returns ``(log_k, opt_state, loss)``, log_k
    updated in place and the loss (mean over every scenario and node)
    whole on every rank.  One step is one batched forward and one adjoint
    solve of the rank's scenarios (``solve_poisson_batched(method=...)``;
    on a line mesh ``"tridiag_pallas"`` puts both on kernel K2) and the
    Adam update.  ``shard_dof``: f and u_data split over dof too (module
    note); the result equals the unsharded step's.  This is BASELINE
    config 2 ('1024 κ/forcing scenarios, 128-element mesh, adjoint
    gradients').
    """
    init_fn, step_fn = _inversion_step(fe_mesh, device_mesh, lr, method,
                                       shard_dof)
    data_sh = batch_dof_sharding(device_mesh) if shard_dof \
        else batch_sharding(device_mesh)
    return init_fn, step_fn, data_sh


def make_inversion_step_shard_map(
    fe_mesh: FEMesh,
    device_mesh,
    lr: float = 0.1,
    method: str = "auto",
):
    """``make_inversion_step``'s step as (init_fn, step): f and u_data
    split over dp alone.  The loss is the sum of squares all-reduced over
    the mesh through a differentiable all-reduce, divided by the
    all-reduced count, as the JAX ``shard_map`` variant's explicit
    ``psum``; per-scenario gradients need no other traffic."""
    return _inversion_step(fe_mesh, device_mesh, lr, method, False)
