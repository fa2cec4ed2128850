"""The production κ-recovery loop: a large batch of independent scalar-κ
recovery problems, one fused grad-step launch (kernel K7) per SGD step.

PyTorch counterpart of ``examples/production_training_demo.py``: on
``FEMesh.line(30)`` in float32, κ_true = 1 + 2·U(0, 1) per scenario, the
forcing f = sin(πx) + 1 for every scenario, u_data from the batched
tridiagonal solve, and the assembled load F = assemble_load(mesh, f)
streamed as a (B, n) plane.  Each step is one call of
``fused_kappa_mse_step_mxu`` (version 2) with scale = 2/n, which makes the
objective each scenario's own mean squared misfit, then
log κ ← log κ − 40·∂log κ.

The JAX demo chains the steps in one jitted ``lax.scan``; here the loop is
plain Python: each step enqueues its kernel and three elementwise ops on
the card and waits for nothing, and the mesh-derived constants are built at
the first step only.

Run:  python -m difffe_tpu_torch.production [batch] [steps]
"""

from __future__ import annotations

import math
import sys
import time
from typing import Callable

import torch

from .mesh import FEMesh
from .ops.assembly import assemble_load
from .ops.kernels.fused_grad_mxu_kernel import fused_kappa_mse_step_mxu
from .solver import solve_poisson_batched

N_ELEMENTS = 30
BATCH = 262144
STEPS = 300
LR = 40.0


def production_mesh(device=None) -> FEMesh:
    return FEMesh.line(N_ELEMENTS, dtype=torch.float32, device=device)


def production_data(mesh: FEMesh, k_true: torch.Tensor):
    """The demo's (F, u_data) for per-scenario κ_true (B,): the load plane
    (B, n) of f = sin(πx) + 1 and the solutions of the batched solve."""
    x = mesh.nodes[:, 0]
    f = (torch.sin(math.pi * x) + 1.0).expand(k_true.shape[0], mesh.n_nodes)
    with torch.no_grad():
        u_data = solve_poisson_batched(mesh, k_true, f, method="tridiag",
                                       kappa_batched=True)
    return assemble_load(mesh, f), u_data


def sgd_loop(mesh: FEMesh, F: torch.Tensor, u_data: torch.Tensor,
             steps: int = STEPS, step: Callable = fused_kappa_mse_step_mxu):
    """``steps`` SGD steps on log κ from zero, each one call of ``step``
    (the K7 wrapper's signature).  Returns (log κ (B,), the mean loss part
    of every step (steps,))."""
    B = u_data.shape[0]
    lanes = 1024 if B % 1024 == 0 else 128
    scale = 2.0 / mesh.n_nodes
    lk = torch.zeros(B, dtype=mesh.dtype, device=mesh.device)
    losses = []
    for _ in range(steps):
        loss_parts, g = step(mesh, lk, F, u_data, scale=scale,
                             block_lanes=lanes, version=2)
        lk = lk - LR * g
        losses.append(loss_parts.mean())
    return lk, torch.stack(losses)


def main(batch: int = BATCH, steps: int = STEPS):
    mesh = production_mesh()
    gen = torch.Generator(device=mesh.device).manual_seed(0)
    k_true = 1.0 + 2.0 * torch.rand(batch, generator=gen, device=mesh.device)
    F, u_data = production_data(mesh, k_true)
    sgd_loop(mesh, F, u_data, steps)              # first run builds
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lk, losses = sgd_loop(mesh, F, u_data, steps)
    err = float((torch.exp(lk) - k_true).abs().max())
    dt = time.perf_counter() - t0
    print(f"{batch} scenarios x {steps} fused grad steps on "
          f"{torch.cuda.get_device_name(mesh.device)}: "
          f"{dt:.3f} s ({batch * steps / dt:,.0f} grad-solves/s)")
    print(f"loss {float(losses[0]):.3e} -> {float(losses[-1]):.3e}")
    print(f"max |kappa - kappa_true| after {steps} SGD steps: {err:.2e}")


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:3]))
