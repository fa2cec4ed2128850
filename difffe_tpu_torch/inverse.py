"""Inverse problems: scalar and field κ recovery, and ``fit_kappa``'s 1D,
2D-grid and 3D-box routes.

PyTorch counterpart of ``difffe_tpu/inverse.py``.

``recover_kappa_scalar`` (Adam warm-up then a safeguarded per-scenario
Newton polish on log κ) and ``recover_kappa_field`` (Adam on per-element
log κ) run their steps as Python loops over the facade's differentiable
solves; ``torch.optim.Adam`` with optax's defaults (β = 0.9/0.999,
ε = 1e-8, the same bias correction) stands in for ``optax.adam``.  The
loss history stays on the device until the loop ends.

On a ``FEMesh.line`` mesh (Dirichlet at both ends) ``fit_kappa``'s loop is
SGD on κ with exact closed-form solves:

* shared forcing on a float32 mesh of at most ``MAX_ROWS`` (256) nodes →
  the K1 chain (ops/kernels/fused_grad_cf_kernel.py), 32 SGD steps per
  launch with κ held on the chip (``info["path"] == "cf_chain_kernel"``);
* per-scenario forcings, and the meshes K1 does not take (more nodes,
  another dtype) → the torch closed form of ops/cf1d.py
  (``info["path"] == "cf_torch"``), decided from the mesh on every
  device.

On a ``FEMesh.rectangle`` mesh with its factory boundary the loop is SGD
on the per-triangle κ planes, one fixed-trip warm-started gradient step
per SGD step, each step one K3b launch (ops/kernels/stencil_cg_kernel.py,
``info["path"] == "stencil2d_fused"``).

On a ``FEMesh.box`` mesh with its factory boundary the loop is SGD on the
per-tet κ field, one fixed-trip cold gradient step per SGD step, each step
one K4b launch (ops/kernels/stencil3d_cg_kernel.py,
``info["path"] == "stencil3d_kernel"``); the final eval solve is one K4a
launch.

Any other 2D/3D mesh (no grid, or a replaced Dirichlet mask) with
B ≥ 128 scenarios takes Adam on log κ through the batch-minor edge-ELL CG
(ops/unstructured.py: in float32 each forward and adjoint solve one launch
of kernel K8s and the right-hand side one of K8, in float64 one K8 launch
a CG iteration; ``info["path"] == "generic_ell_batchminor"``).  Any other
mesh
takes the generic Adam field recovery (``recover_kappa_field``,
``info["path"] == "generic_adam"``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from .mesh import FEMesh
from .solver import solve_poisson_batched


def fit_kappa(mesh: FEMesh, f, u_data, steps: int = 100,
              lr: Optional[float] = None, kappa0=None,
              iters: Optional[int] = None, warm: Optional[bool] = None,
              block_b: int = 8, eval_final: bool = True
              ) -> Tuple[torch.Tensor, dict]:
    """Per-element κ-field inversion on the fastest path the mesh fits.

    f, u_data : (B, n_nodes) batched forcings and observations (a single
        (n_nodes,) scenario is promoted to B = 1).
    steps : optimizer steps.  lr : SGD learning rate (1D and 2D default
        30.0 with a per-scenario scale; 3D default 100·B/256, its loss
        being a mean over the batch); Adam's on the generic routes
        (default 0.05).  kappa0 : starting κ, broadcast to (B, n_elements);
        default 1.
    iters, warm : override the per-step CG iteration count (2D default
        32/8/4 by grid side ≤64/≤128/larger, 3D 32/100 by box side
        ≤16/larger, the edge-ELL route 128) and warm-start policy (default
        True in 2D, False in 3D).  block_b : passed to the 2D kernels (see
        ops/kernels/stencil_cg_kernel.py; 1 above 64² grids).
    eval_final : run one exact solve at the final κ and report the mean
        squared misfit as ``info["eval_loss"]``.

    Returns ``(kappa (B, n_elements), info)`` with info keys ``path``,
    ``iters``, ``warm``, ``loss_history`` and ``eval_loss``.
    """
    f = torch.as_tensor(f, dtype=mesh.dtype, device=mesh.device)
    u_data = torch.as_tensor(u_data, dtype=mesh.dtype, device=mesh.device)
    if f.ndim == 1:
        f, u_data = f[None], u_data[None]
    grid = mesh.grid
    if grid is not None:
        # the structured loops assume the factory full-boundary Dirichlet
        # mask; a replaced mask takes the generic routes, whose solves
        # then assemble the mesh as it is
        from .solver import _mask_is_factory
        if not _mask_is_factory(mesh):
            grid = None
            mesh = dataclasses.replace(mesh, grid=None)

    if mesh.dim == 1:
        from .ops.cf1d import mesh_supports_cf
        if mesh_supports_cf(mesh):
            return _fit_kappa_1d(mesh, f, u_data, steps, lr, kappa0,
                                 eval_final)
        return _fit_kappa_generic(mesh, f, u_data, steps, lr, eval_final)
    if grid is None:
        if f.shape[0] >= 128:
            # the batch-minor edge-ELL CG once the batch fills the minor
            # axis (the JAX package's measured boundary)
            return _fit_kappa_ell(mesh, f, u_data, steps, lr, kappa0, iters,
                                  eval_final)
        return _fit_kappa_generic(mesh, f, u_data, steps, lr, eval_final)
    if mesh.dim == 2:
        return _fit_kappa_2d(mesh, grid, f, u_data, steps, lr, kappa0,
                             iters, warm, block_b, eval_final)
    return _fit_kappa_3d(mesh, grid, f, u_data, steps, lr, kappa0, iters,
                         warm, eval_final)


def _build_loop_2d(grid, path, iters, warm, block_b, lr, scale, steps):
    """The 2D SGD inversion loop for one static configuration.

    ``path`` 'fused' / 'two_launch': a cold first gradient step, then
    ``steps − 1`` steps warm-started from the previous (u, λ) when
    ``warm``; 'xla': ``steps`` steps of autograd through
    ``solve_poisson_structured``.  The returned function maps
    (κ_lower, κ_upper, f, g, u_data) planes to (κ_lower, κ_upper,
    loss_history) with the history in MSE units, kept on the device."""
    from .ops.kernels.stencil_cg_kernel import (
        fused_kappa_mse_step_2d, kappa_mse_step_2d_two_launch)
    from .ops.stencil import solve_poisson_structured

    if path in ("fused", "two_launch"):
        step_fn = (fused_kappa_mse_step_2d if path == "fused"
                   else kappa_mse_step_2d_two_launch)

        def loop(kl, ku, fg, g0, ug):
            state, hist = None, []
            for _ in range(max(steps, 1)):
                lp, (gl, gu), _, state = step_fn(
                    grid, (kl, ku), fg, g0, ug, iters=iters,
                    block_b=block_b, scale=scale,
                    warm_state=state if warm else None, return_state=True)
                kl, ku = kl - lr * gl, ku - lr * gu
                hist.append((scale / 2.0) * lp.mean())
            return kl, ku, torch.stack(hist)
        return loop

    def loop(kl, ku, fg, g0, ug):
        B = fg.shape[0]
        hist = []
        for _ in range(steps):
            klu = (kl.detach().requires_grad_(),
                   ku.detach().requires_grad_())
            with torch.enable_grad():
                u = solve_poisson_structured(grid, klu, fg, g0, 0.0, iters)
                d = u - ug
                # per-scenario cotangent scale; history in MSE units
                loss = (scale / 2.0) * (d * d).sum()
                gl, gu = torch.autograd.grad(loss, klu)
            kl, ku = kl - lr * gl, ku - lr * gu
            hist.append(loss.detach() / B)
        return kl, ku, torch.stack(hist)
    return loop


def _build_eval_2d(grid, maxiter):
    """The converged check: MSE of one global-dot fixed-trip solve."""
    from .ops.stencil import solve_poisson_structured

    def ev(kl, ku, fg, g0, ug):
        with torch.no_grad():
            u = solve_poisson_structured(grid, (kl, ku), fg, g0, 0.0,
                                         maxiter)
            return ((u - ug) ** 2).mean()
    return ev


def _fit_kappa_2d(mesh, grid, f, u_data, steps, lr, kappa0, iters, warm,
                  block_b, eval_final):
    """2D per-triangle inversion on the structured grid."""
    from .ops.kernels.stencil_cg_kernel import choose_2d_path
    from .ops.stencil import kappa_lu_from_elements

    B = f.shape[0]
    H, W = grid.node_shape
    if iters is None:
        # per-step warm iteration policy of the JAX package, gated there
        # on the converged eval loss (an accuracy result, kept as is)
        n_side = max(grid.nx, grid.ny)
        iters = 32 if n_side <= 64 else (8 if n_side <= 128 else 4)
    if max(grid.nx, grid.ny) > 64 and block_b > 1:
        block_b = 1
    warm = True if warm is None else warm
    lr = 30.0 if lr is None else lr
    # per-scenario-mean cotangent scale: gradient magnitude independent of B
    scale = 2.0 / (H * W)
    fg = f.reshape(B, H, W)
    ug = u_data.reshape(B, H, W)
    g0 = mesh.bc_values.reshape(H, W)
    if kappa0 is None:
        kl0 = torch.ones((B, grid.ny, grid.nx), dtype=mesh.dtype,
                         device=mesh.device)
        ku0 = kl0
    else:
        kl0, ku0 = kappa_lu_from_elements(grid, torch.as_tensor(
            kappa0, dtype=mesh.dtype, device=mesh.device).expand(
                B, mesh.n_elements))

    path = choose_2d_path(grid, block_b=block_b,
                          itemsize=mesh.dtype.itemsize)
    if path == "two_launch":
        block_b = 1
    loop = _build_loop_2d(grid, path, iters, warm, block_b, float(lr),
                          float(scale), steps)
    kl, ku, losses = loop(kl0, ku0, fg, g0, ug)
    kappa = torch.stack([kl, ku], dim=-1).reshape(B, mesh.n_elements)
    info = {"path": f"stencil2d_{path}", "iters": iters, "warm": warm,
            "loss_history": losses, "eval_loss": None}
    if eval_final:
        ev = _build_eval_2d(grid, max(4 * iters, 256))
        info["eval_loss"] = float(ev(kl, ku, fg, g0, ug))
    return kappa, info


def _build_loop_3d(grid, iters, warm, lr, steps, path, block_b=1):
    """The 3D SGD inversion loop for one static configuration.

    ``path`` 'kernel': each step one K4b launch (plain version on CPU
    tensors); 'xla_bm': the plain step ``kappa_mse_grad_step_3d``.  The
    first step is cold, the others warm-started from the previous (u, λ)
    when ``warm``.  The returned function maps (κ (B, ne), f, g, u_data
    boxes) to (κ, loss_history) with the history in MSE units (mean over
    batch and nodes), kept on the device."""
    from .ops.kernels.stencil3d_cg_kernel import \
        fused_kappa_mse_step_3d_kernel
    from .ops.stencil3d import kappa_mse_grad_step_3d

    n_nodes = math.prod(grid.node_shape)

    def step(k, fg, g0, ug, state):
        if path == "kernel":
            lp, gk, _, state = fused_kappa_mse_step_3d_kernel(
                grid, k, fg, g0, ug, iters=iters, block_b=block_b,
                scale=2.0 / (fg.shape[0] * n_nodes), warm_state=state,
                return_state=True)
            return lp.mean() / n_nodes, gk, state
        return kappa_mse_grad_step_3d(grid, k, fg, g0, ug, iters,
                                      warm_state=state, return_state=True)

    def loop(k, fg, g0, ug):
        state, hist = None, []
        for _ in range(max(steps, 1)):
            loss, gk, state = step(k, fg, g0, ug, state)
            state = state if warm else None
            k = k - lr * gk
            hist.append(loss)
        return k, torch.stack(hist)
    return loop


def _build_eval_3d(grid, maxiter):
    """The converged check: MSE of one fixed-trip cold solve with
    per-scenario dots, one K4a launch (plain version on CPU tensors)."""
    from .ops.kernels.stencil3d_cg_kernel import solve_structured_kernel_3d

    def ev(kappa, fg, g0, ug):
        with torch.no_grad():
            u = solve_structured_kernel_3d(grid, kappa, fg, g0, maxiter)
            return ((u - ug) ** 2).mean()
    return ev


def _fit_kappa_3d(mesh, grid, f, u_data, steps, lr, kappa0, iters, warm,
                  eval_final):
    """3D per-tet inversion on the structured box."""
    from .ops.stencil3d import choose_3d_block_b, choose_3d_grad_step

    B = f.shape[0]
    if iters is None:
        # the JAX package's κ-error-safe policy, graded by box side (an
        # accuracy result measured against κ error, kept as is)
        iters = 32 if max(grid.nx, grid.ny, grid.nz) <= 16 else 100
    warm = False if warm is None else warm
    if lr is None:
        # the loss is a mean over the batch, so the κ gradient scales as
        # 1/B; the default keeps the effective step B-invariant
        lr = 100.0 * (B / 256.0)
    shape = (B,) + grid.node_shape
    fg = f.reshape(shape)
    ug = u_data.reshape(shape)
    g0 = mesh.bc_values.reshape(grid.node_shape)
    if kappa0 is None:
        k0 = torch.ones((B, mesh.n_elements), dtype=mesh.dtype,
                        device=mesh.device)
    else:
        k0 = torch.as_tensor(kappa0, dtype=mesh.dtype,
                             device=mesh.device).expand(B, mesh.n_elements)
    path = choose_3d_grad_step(grid, B, iters=iters)
    bb = choose_3d_block_b(grid, B, iters=iters)
    loop = _build_loop_3d(grid, iters, warm, float(lr), steps, path, bb)
    kappa, losses = loop(k0, fg, g0, ug)
    name = "stencil3d_kernel" if path == "kernel" else "stencil3d_plain"
    info = {"path": name, "iters": iters, "warm": warm,
            "loss_history": losses, "eval_loss": None}
    if eval_final:
        ev = _build_eval_3d(grid, max(4 * iters, 256))
        info["eval_loss"] = float(ev(kappa, fg, g0, ug))
    return kappa, info


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
    from .ops.kernels.fused_grad_cf_kernel import (chain_takes,
                                                   cf_packed_operands,
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
    # K1 takes float32 planes of at most MAX_ROWS rows; every other line
    # mesh takes the torch closed form, whatever the device
    if f_shared and chain_takes(mesh):
        Fs = assemble_load(mesh, f[0])
        bl = 2048 if B >= 2048 else 512
        keT, aux = cf_packed_operands(mesh, ke0, Fs, u_data, block_lanes=bl)
        k = min(32, steps)
        keT, hist = _build_loop_1d(keT, aux, steps // k, k, steps % k, lr,
                                   scale)
        kappa = cf_unpack(keT, aux)
        path = "cf_chain_kernel"
    else:
        FB = assemble_load(mesh, f[0] if f_shared else f)
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


def _adam(params, lr: float) -> torch.optim.Adam:
    """``optax.adam(lr)``: β = (0.9, 0.999), ε = 1e-8, bias-corrected."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def _adam_loop(params, loss_fn, n_epochs: int, lr: float) -> torch.Tensor:
    """``n_epochs`` Adam steps on the tensors ``params``; the per-epoch
    losses (taken before each update; a loss of several independent values,
    one a scenario, is summed for the backward pass), stacked on the device
    along the last axis."""
    opt = _adam(list(params), lr)
    losses = []
    for _ in range(n_epochs):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn()
        loss.sum().backward()
        opt.step()
        losses.append(loss.detach())
    return torch.stack(losses, dim=-1)


def recover_kappa_scalar(mesh: FEMesh, f, u_data, kappa0=None,
                         adam_steps: int = 100, newton_steps: int = 6,
                         lr: float = 0.1, method: str = "auto"
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Recover per-scenario scalar κ from observed solutions.

    f, u_data: (B, n_nodes); returns (κ (B,), per-scenario final losses).
    Parameterized as log κ.  Adam warm-up gets near the basin; a
    per-scenario scalar Newton step (safeguarded, clipped to ±0.5 in
    log κ) polishes to < 1e-6.  The loss separates over scenarios, so the
    Hessian is diagonal and H·1, a reverse-over-reverse product, gives the
    per-scenario second derivatives: ``method`` must be twice
    differentiable ('auto'/'tridiag' through the PCR oracle, 'dense',
    'lu'; the kernel route 'tridiag_pallas' is first-order only and
    raises, as in the JAX package).
    """
    f = torch.as_tensor(f, dtype=mesh.dtype, device=mesh.device)
    u_data = torch.as_tensor(u_data, dtype=mesh.dtype, device=mesh.device)
    B = f.shape[0]
    log_k = (torch.zeros(B, dtype=mesh.dtype, device=mesh.device)
             if kappa0 is None else torch.log(torch.as_tensor(
                 kappa0, dtype=mesh.dtype, device=mesh.device)).clone())

    def per_scenario_loss(lk):
        u = solve_poisson_batched(mesh, torch.exp(lk), f, method=method,
                                  kappa_batched=True)
        return ((u - u_data) ** 2).mean(dim=-1)

    log_k.requires_grad_()
    opt = _adam([log_k], lr)
    for _ in range(adam_steps):
        opt.zero_grad(set_to_none=True)
        per_scenario_loss(log_k).sum().backward()
        opt.step()

    lk = log_k.detach()
    for _ in range(newton_steps):
        v = lk.clone().requires_grad_()
        (g,) = torch.autograd.grad(per_scenario_loss(v).sum(), v,
                                   create_graph=True)
        (hdiag,) = torch.autograd.grad(g.sum(), v)
        g = g.detach()
        pos = hdiag > 0
        step = torch.where(pos, g / torch.where(pos, hdiag, 1.0),
                           torch.sign(g) * 0.1)
        lk = lk - step.clamp(-0.5, 0.5)
    with torch.no_grad():
        return torch.exp(lk), per_scenario_loss(lk)


def recover_kappa_field(mesh: FEMesh, f, u_data, adam_steps: int = 500,
                        lr: float = 0.05, method: str = "auto",
                        reg: float = 0.0, share_field: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Recover per-element κ fields: f, u_data (B, n_nodes); returns
    (κ, loss history (adam_steps,)).

    ``share_field=False``: each scenario recovers its own field (B,
    n_elements) from its own forcing (identifiable only up to an
    unobserved boundary-flux constant); ``share_field=True``: one field
    (n_elements,) explains every forcing.  ``reg`` adds the Tikhonov
    smoothing reg·mean((Δ log κ)²).  Each Adam step is one batched forward
    solve and its adjoint: on ``method="tridiag_pallas"`` two K2 launches.
    """
    f = torch.as_tensor(f, dtype=mesh.dtype, device=mesh.device)
    u_data = torch.as_tensor(u_data, dtype=mesh.dtype, device=mesh.device)
    B, ne = f.shape[0], mesh.n_elements
    shape = (ne,) if share_field else (B, ne)
    log_k = torch.zeros(shape, dtype=mesh.dtype, device=mesh.device,
                        requires_grad=True)

    def loss_fn(lk):
        kappa = torch.exp(lk).expand(B, ne)
        u = solve_poisson_batched(mesh, kappa, f, method=method)
        data = ((u - u_data) ** 2).mean()
        if reg > 0:
            return data + reg * (torch.diff(lk, dim=-1) ** 2).mean()
        return data

    opt = _adam([log_k], lr)
    hist = []
    for _ in range(adam_steps):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(log_k)
        loss.backward()
        opt.step()
        hist.append(loss.detach())
    hist = torch.stack(hist) if hist else log_k.new_zeros(0)
    return torch.exp(log_k.detach()), hist


def _fit_kappa_ell(mesh, f, u_data, steps, lr, kappa0, iters, eval_final):
    """Adam on log κ (optax's defaults, lr 0.05) through the fixed-trip
    batch-minor edge-ELL CG (``iters`` 128 a solve); the converged check
    runs max(2·iters, 256) iterations."""
    from .ops.assembly import assemble_load
    from .ops.unstructured import build_ell, solve_poisson_cg_ell_batched

    B, ne = f.shape[0], mesh.n_elements
    iters = 128 if iters is None else iters
    lr = 0.05 if lr is None else lr
    ell = build_ell(mesh)
    FB = assemble_load(mesh, f)
    if kappa0 is None:
        log_k = torch.zeros((B, ne), dtype=mesh.dtype, device=mesh.device)
    else:
        log_k = torch.log(torch.as_tensor(
            kappa0, dtype=mesh.dtype, device=mesh.device).expand(B, ne))
    log_k = log_k.clone().requires_grad_()
    opt = _adam([log_k], lr)
    hist = []
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        u = solve_poisson_cg_ell_batched(mesh, ell, torch.exp(log_k), FB,
                                         0.0, iters)
        loss = ((u - u_data) ** 2).mean()
        loss.backward()
        opt.step()
        hist.append(loss.detach())
    hist = torch.stack(hist) if hist else log_k.new_zeros(0)
    kappa = torch.exp(log_k.detach())
    info = {"path": "generic_ell_batchminor", "iters": iters, "warm": None,
            "loss_history": hist, "eval_loss": None}
    if eval_final:
        with torch.no_grad():
            u = solve_poisson_cg_ell_batched(mesh, ell, kappa, FB, 0.0,
                                             max(2 * iters, 256))
            info["eval_loss"] = float(((u - u_data) ** 2).mean())
    return kappa, info


def _fit_kappa_generic(mesh, f, u_data, steps, lr, eval_final):
    """The generic Adam field recovery (``info["path"] ==
    "generic_adam"``): line meshes the closed-form chain does not take,
    and 2D/3D meshes without a grid at B < 128."""
    kappa, hist = recover_kappa_field(mesh, f, u_data, adam_steps=steps,
                                      lr=lr if lr is not None else 0.05)
    info = {"path": "generic_adam", "iters": None, "warm": None,
            "loss_history": hist, "eval_loss": None}
    if eval_final:
        with torch.no_grad():
            u = solve_poisson_batched(mesh, kappa, f)
            info["eval_loss"] = float(((u - u_data) ** 2).mean())
    return kappa, info
