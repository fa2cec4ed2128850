"""Multi-process initialization, failure detection and scaling measurement
on ``torch.distributed``.

PyTorch counterpart of ``difffe_tpu/parallel/multihost.py``.
:func:`initialize` makes the default process group — NCCL on the card,
gloo when the caller asks for the CPU — that :func:`sharding.make_device_mesh`
builds its mesh on; a heartbeat (:class:`HealthCheck`) and a deadline on
any wait (:func:`timed_block_until_ready`) let a supervisor abort a hung
run and restart it from its latest checkpoint (utils/checkpoint.py).

Nothing here falls back on its own: without a card ``initialize()``
raises instead of starting a CPU group, and without a coordinator it
makes a world of one process, which is all a machine with one card can
run (NCCL refuses two ranks on one GPU).
"""

from __future__ import annotations

import dataclasses
import datetime
import threading
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_leaves


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               device: str = "cuda", timeout_s: float = 60.0) -> None:
    """Initialize the default process group of this process.

    ``coordinator_address``: where the ranks meet — ``"host:port"`` or
    ``"tcp://host:port"`` (a TCP store on rank 0's host) or
    ``"file:///path"`` (a file store on a file system every rank sees);
    then ``num_processes`` and ``process_id`` are the world size and this
    process's rank.  Without one: a group of this process alone.
    ``device``: ``"cuda"`` (NCCL; rank r uses card r mod the card count)
    or ``"cpu"`` (gloo).  The rendezvous and every collective of the group
    give up after ``timeout_s`` seconds.  A second call returns at once
    when its world size agrees with the group's, and raises otherwise.
    """
    if dist.is_initialized():
        if num_processes not in (None, dist.get_world_size()):
            raise RuntimeError(
                f"a process group of {dist.get_world_size()} ranks is "
                f"already initialized, not one of {num_processes}")
        return
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize: no CUDA card is available; "
                               "pass device='cpu' for a gloo group")
        backend = "nccl"
    elif device == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"device must be 'cuda' or 'cpu', not {device!r}")
    if coordinator_address is None:
        if num_processes not in (None, 1) or process_id not in (None, 0):
            raise ValueError("a group of more than one process needs a "
                             "coordinator_address")
        rank, world = 0, 1
        where = {"store": dist.HashStore()}
    else:
        if num_processes is None or process_id is None:
            raise ValueError("coordinator_address needs num_processes and "
                             "process_id")
        rank, world = process_id, num_processes
        where = {"init_method": coordinator_address
                 if "://" in coordinator_address
                 else f"tcp://{coordinator_address}"}
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s),
                            **where)


def is_primary() -> bool:
    """True on rank 0, and in a process without a group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _device_type() -> str:
    """The device type the default group's backend works on."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _wait(x) -> None:
    """Wait for every ``torch.distributed`` work handle among the leaves of
    ``x``, then for the card if a leaf is a CUDA tensor."""
    cards = set()
    for leaf in tree_leaves(x):
        if isinstance(leaf, dist.Work):
            leaf.wait()
        elif isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            cards.add(leaf.device)
    for device in cards:
        torch.cuda.synchronize(device)


def timed_block_until_ready(x, timeout_s: float) -> bool:
    """Wait for ``x`` at most ``timeout_s`` seconds; True iff it completed.

    ``x`` holds CUDA tensors (waited on by ``torch.cuda.synchronize``) and
    ``torch.distributed`` work handles (``async_op=True``; waited on by
    ``Work.wait``), in any nest of lists, tuples and dicts; CPU tensors
    are ready when they exist.  The wait runs on a daemon thread that the
    caller joins with a deadline: if it never finishes, the thread is
    abandoned and the caller gets False within the budget.  An error
    while waiting (a failed collective, a device fault) also returns
    False."""
    done = threading.Event()
    state = {"ok": False}

    def _watch():
        try:
            _wait(x)
            state["ok"] = True
        except Exception:  # a failed wait is a failed participant
            state["ok"] = False
        finally:
            done.set()

    threading.Thread(target=_watch, daemon=True,
                     name="timed_block_until_ready").start()
    if not done.wait(timeout_s):
        return False
    return state["ok"]


@dataclasses.dataclass
class HealthCheck:
    """Cross-rank liveness probe: a real all-reduce with a wall-clock
    budget.

    ``ping`` has each rank contribute its flattened mesh index + 1 and
    all-reduces it over every dimension group of the mesh in turn (the
    whole default group without a mesh), so the collective meets every
    participant: a hung or dead rank stalls it and ``ping`` returns False
    within ``timeout_s``.  The expected sum 1 + 2 + … + n also checks that
    each rank's distinct contribution arrived."""

    timeout_s: float = 60.0

    def ping(self, device_mesh=None) -> bool:
        if device_mesh is None:
            groups = [dist.group.WORLD]
            idx, n, device = dist.get_rank(), dist.get_world_size(), \
                _device_type()
        else:
            groups = [device_mesh.get_group(name)
                      for name in device_mesh.mesh_dim_names]
            idx, stride = 0, 1
            for c, s in zip(reversed(device_mesh.get_coordinate()),
                            reversed(device_mesh.shape)):
                idx += c * stride
                stride *= s
            n, device = device_mesh.size(), device_mesh.device_type
        total = torch.tensor(idx + 1, dtype=torch.int64, device=device)
        t0 = time.time()
        for group in groups:
            work = dist.all_reduce(total, group=group, async_op=True)
            left = self.timeout_s - (time.time() - t0)
            if left <= 0 or not timed_block_until_ready((work, total), left):
                return False  # hung or failed collective
        return int(total) == n * (n + 1) // 2 and \
            time.time() - t0 < self.timeout_s


def scaling_efficiency(step_fn: Callable, make_args: Callable[[int], tuple],
                       device_counts, iters: int = 10):
    """Weak-scaling efficiency of ``step_fn`` across device counts.

    ``make_args(n_devices)`` builds per-run inputs whose batch scales with
    n.  Returns {n: (throughput, efficiency vs linear from smallest n)}.
    """
    from ..utils.profiling import timeit_torch
    results = {}
    base = None
    for n in device_counts:
        args = make_args(n)
        timing = timeit_torch(step_fn, *args, iters=iters)
        thr = n / timing.mean_s  # device-steps per second
        if base is None:
            base = thr / n
        results[n] = (thr, thr / (base * n))
    return results
