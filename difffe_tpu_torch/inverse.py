"""Per-element κ-field inversion: ``fit_kappa``, 1D route.

PyTorch counterpart of ``fit_kappa`` in ``difffe_tpu/inverse.py``.  On a
``FEMesh.line`` mesh (Dirichlet at both ends) the loop is SGD on κ with
exact closed-form solves:

* shared forcing → the K1 chain (ops/kernels/fused_grad_cf_kernel.py), 32
  SGD steps per launch with κ held on the chip
  (``info["path"] == "cf_chain_kernel"``);
* per-scenario forcings → the torch closed form of ops/cf1d.py
  (``info["path"] == "cf_torch"``).

Every other route of the JAX dispatcher raises ``NotImplementedError``
naming the slice that ports it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .mesh import FEMesh


def fit_kappa(mesh: FEMesh, f, u_data, steps: int = 100,
              lr: Optional[float] = None, kappa0=None,
              iters: Optional[int] = None, warm: Optional[bool] = None,
              block_b: int = 8, eval_final: bool = True
              ) -> Tuple[torch.Tensor, dict]:
    """Per-element κ-field inversion on the fastest path the mesh fits.

    f, u_data : (B, n_nodes) batched forcings and observations (a single
        (n_nodes,) scenario is promoted to B = 1).
    steps : SGD steps.  lr : SGD learning rate (1D default 30.0 with the
        per-scenario scale 2/n).  kappa0 : starting κ, broadcast to
        (B, n_elements); default 1.
    iters, warm, block_b : read by the 2D/3D routes only (not ported).
    eval_final : run one exact solve at the final κ and report the mean
        squared misfit as ``info["eval_loss"]``.

    Returns ``(kappa (B, n_elements), info)`` with info keys ``path``,
    ``iters``, ``warm``, ``loss_history`` and ``eval_loss``.
    """
    f = torch.as_tensor(f, dtype=mesh.dtype, device=mesh.device)
    u_data = torch.as_tensor(u_data, dtype=mesh.dtype, device=mesh.device)
    if f.ndim == 1:
        f, u_data = f[None], u_data[None]

    if mesh.dim == 1:
        from .ops.cf1d import mesh_supports_cf
        if mesh_supports_cf(mesh):
            return _fit_kappa_1d(mesh, f, u_data, steps, lr, kappa0,
                                 eval_final)
        raise NotImplementedError(
            "fit_kappa on a 1D mesh without two-end Dirichlet takes the "
            "generic Adam route (recover_kappa_field), not ported yet "
            "(slice B; general meshes: slice E)")
    if mesh.dim == 2:
        raise NotImplementedError(
            "fit_kappa on 2D meshes is not ported yet (slice C: structured "
            "grids; slice E: general meshes)")
    raise NotImplementedError(
        "fit_kappa on 3D meshes is not ported yet (slice D: boxes; "
        "slice E: general meshes)")


def _build_loop_1d(keT, aux, n_full, k, rem, lr, scale):
    """The chain-kernel SGD loop: n_full launches of k steps plus one
    remainder launch of rem steps.  Loss history is per launch (the
    kernel reports its last inner step's loss)."""
    from .ops.kernels.fused_grad_cf_kernel import kappa_sgd_chain_cf

    B, n = aux["B"], aux["n"]
    hist = []
    for n_inner in [k] * n_full + ([rem] if rem else []):
        lp, keT = kappa_sgd_chain_cf(keT, aux, n_inner, lr, scale=scale)
        hist.append(lp[0, :B].mean() / n)
    return keT, torch.stack(hist)


def _fit_kappa_1d(mesh, f, u_data, steps, lr, kappa0, eval_final):
    """1D per-element inversion on exact closed-form solves."""
    from .ops.assembly import assemble_load
    from .ops.cf1d import kappa_mse_step_cf, solve_poisson_cf_batched
    from .ops.kernels.fused_grad_cf_kernel import (cf_packed_operands,
                                                   cf_unpack)

    B = f.shape[0]
    ne = mesh.n_elements
    n = mesh.n_nodes
    lr = 30.0 if lr is None else float(lr)
    scale = 2.0 / n
    if kappa0 is None:
        ke0 = torch.ones((B, ne), dtype=mesh.dtype, device=mesh.device)
    else:
        ke0 = torch.as_tensor(kappa0, dtype=mesh.dtype,
                              device=mesh.device).expand(B, ne)

    f_shared = B == 1 or bool((f == f[:1]).all().item())
    if f_shared:
        Fs = assemble_load(mesh, f[0])
        bl = 2048 if B >= 2048 else 512
        keT, aux = cf_packed_operands(mesh, ke0, Fs, u_data, block_lanes=bl)
        k = min(32, steps)
        keT, hist = _build_loop_1d(keT, aux, steps // k, k, steps % k, lr,
                                   scale)
        kappa = cf_unpack(keT, aux)
        path = "cf_chain_kernel"
    else:
        FB = assemble_load(mesh, f)
        kappa, hist = ke0, []
        for _ in range(steps):
            lp, g = kappa_mse_step_cf(mesh, kappa, FB, u_data, scale=scale)
            kappa = kappa - lr * g
            hist.append(lp.mean() / n)
        hist = torch.stack(hist)
        path = "cf_torch"

    info = {"path": path, "iters": None, "warm": None,
            "loss_history": hist, "eval_loss": None}
    if eval_final:
        u = solve_poisson_cf_batched(mesh, kappa, f)
        info["eval_loss"] = float(((u - u_data) ** 2).mean())
    return kappa, info
