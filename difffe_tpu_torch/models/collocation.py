"""Mesh-free collocation (PINN) training with exact residuals.

PyTorch counterpart of ``difffe_tpu/models/collocation.py``.  The
strong-form residual −κΔu − f is evaluated from the network's own
derivatives at arbitrary collocation points, so training is mesh-free and
the residual is exact for the network.  u(x) = φ(x)·net(x) with an
analytic lifting mask φ (smooth, exactly zero on the bounding box's
boundary), so Dirichlet BCs hold at every point.

The JAX package takes the Laplacian as the trace of ``jax.hessian``
``vmap``ped over the points.  Here Δ(φ·net) = φΔnet + 2∇φ·∇net + netΔφ
over the whole batch of points: the network's value, gradient and
Laplacian carried forward through its tanh layers, the mask's taken by
autograd once a point block, and training backpropagates through it to
the weights.  The epoch is host-bound on the card, so its cost is its
operation count: at chip_smoke phase 30's 2D defaults on H100 hosts an
epoch took 23.6 ms of host time with ``torch.func``'s
``vmap(hessian(...))`` over a functional call of the :class:`MLP`, 17.2
ms with nested ``torch.autograd.grad`` and 7.0-12.6 ms this way (in
separate runs, on hosts whose speed differs up to 2×).

``jax.random`` draws cannot be reproduced in torch, so
``train_collocation`` samples its point blocks from a CPU
``torch.Generator`` and hands them to ``train_collocation_on_points``,
which trains on given blocks (the JAX schedule: one block every
``resample_every`` epochs, the Adam state carried across blocks).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ..inverse import _adam
from ..mesh import FEMesh
from .neural import MLP, init_mlp


def smooth_mask_fn(mesh: FEMesh) -> Callable[[torch.Tensor], torch.Tensor]:
    """Analytic boundary-vanishing mask of the mesh's bounding box:
    φ(x) = Π_d (x_d − lo_d)(hi_d − x_d) / ((hi_d − lo_d)/2)², x (…, dim) →
    (…)."""
    lo = mesh.nodes.min(dim=0).values
    hi = mesh.nodes.max(dim=0).values
    norm = (((hi - lo) / 2.0) ** 2).prod()

    def phi(x: torch.Tensor) -> torch.Tensor:
        return ((x - lo) * (hi - x)).prod(-1) / norm

    return phi


def network_solution(params: MLP, phi, x: torch.Tensor) -> torch.Tensor:
    """u(x) = φ(x)·net(x) at points x (…, dim)."""
    return phi(x) * params(x)


def _mlp_taylor(net: MLP, x: torch.Tensor):
    """(n, ∇n, Δn) of the tanh MLP at points x (N, dim), by carrying each
    layer's Jacobian J (N, width, dim) and Laplacian L (N, width) forward
    with its values: through a linear layer both map by W; through tanh,
    with t = tanh(z) and s = 1 − t², J ← s·J and L ← s·L − 2ts·|J|²."""
    N, dim = x.shape
    h = x
    J = torch.eye(dim, dtype=x.dtype, device=x.device).expand(N, dim, dim)
    L = torch.zeros_like(x)
    for i, layer in enumerate(net.layers):
        z = layer(h)
        Jz = torch.matmul(layer.weight, J)
        Lz = L @ layer.weight.T
        if i == len(net.layers) - 1:
            return z[:, 0], Jz[:, 0, :], Lz[:, 0]
        h = torch.tanh(z)
        s = 1.0 - h * h
        J = s[..., None] * Jz
        L = s * Lz - 2.0 * h * s * (Jz * Jz).sum(-1)


def _mask_taylor(phi, xs: torch.Tensor):
    """(φ, ∇φ, Δφ) of the lifting mask at points xs (N, dim) by autograd:
    φ holds no weights, so a training loop computes these once a block."""
    x = xs.detach().requires_grad_(True)
    with torch.enable_grad():
        m = phi(x)
        (dm,) = torch.autograd.grad(m.sum(), x, create_graph=True)
        lap = sum(torch.autograd.grad(dm[:, k].sum(), x,
                                      retain_graph=True)[0][:, k]
                  for k in range(x.shape[1]))
    return m.detach(), dm.detach(), lap


def _laplacians(params: MLP, phi, xs: torch.Tensor,
                mask=None) -> torch.Tensor:
    """Δu at each point of xs (N, dim), differentiable wrt the weights:
    Δ(φn) = φΔn + 2∇φ·∇n + nΔφ, the network's terms carried forward
    through its layers (``_mlp_taylor``), the mask's (``_mask_taylor``,
    or ``mask`` where the caller computed them for these points)."""
    m, dm, lm = _mask_taylor(phi, xs) if mask is None else mask
    n, dn, ln = _mlp_taylor(params, xs)
    return m * ln + 2.0 * (dm * dn).sum(-1) + n * lm


def laplacian(params: MLP, phi, x: torch.Tensor) -> torch.Tensor:
    """Δu at a single point x (dim,) via the Hessian trace."""
    return _laplacians(params, phi, x[None])[0]


def _forcing_at(forcing_fn, xs: torch.Tensor) -> torch.Tensor:
    return forcing_fn(xs[:, 0] if xs.shape[1] == 1 else xs)


def collocation_residual(params: MLP, phi, xs: torch.Tensor, forcing_fn,
                         kappa) -> torch.Tensor:
    """Strong-form residuals −κΔu(x_i) − f(x_i) at points xs (N, dim)."""
    return -kappa * _laplacians(params, phi, xs) - _forcing_at(forcing_fn,
                                                              xs)


def sample_collocation_points(mesh: FEMesh, generator: torch.Generator,
                              n_points: int) -> torch.Tensor:
    """Uniform samples (n_points, dim) of the mesh's bounding box drawn
    from ``generator`` (a CPU generator)."""
    lo = mesh.nodes.min(dim=0).values
    hi = mesh.nodes.max(dim=0).values
    u = torch.rand((n_points, mesh.dim), generator=generator,
                   dtype=mesh.dtype)
    return lo + u.to(mesh.device) * (hi - lo)


def train_collocation_on_points(params: MLP, mesh: FEMesh, forcing_fn,
                                blocks: torch.Tensor, kappa=1.0,
                                lr: float = 1e-3, resample_every: int = 100
                                ) -> torch.Tensor:
    """Train ``params`` in place on the point blocks (n_blocks, N, dim),
    ``resample_every`` Adam epochs on each, the optimizer state carried
    from block to block; returns the per-epoch losses (n_blocks ×
    resample_every,), each taken before its update."""
    phi = smooth_mask_fn(mesh)
    opt = _adam(list(params.parameters()), lr)
    losses = []
    for xs in blocks:
        # what depends on the points alone, once a block
        mask, f = _mask_taylor(phi, xs), _forcing_at(forcing_fn, xs)
        for _ in range(resample_every):
            opt.zero_grad(set_to_none=True)
            r = -kappa * _laplacians(params, phi, xs, mask) - f
            loss = (r ** 2).mean()
            loss.backward()
            opt.step()
            losses.append(loss.detach())
    return torch.stack(losses)


def train_collocation(mesh: FEMesh, forcing_fn, kappa=1.0,
                      hidden_dim: int = 64, n_layers: int = 3,
                      n_points: int = 256, n_epochs: int = 2000,
                      lr: float = 1e-3,
                      generator: Optional[torch.Generator] = None,
                      resample_every: int = 100
                      ) -> Tuple[MLP, Callable[[torch.Tensor], torch.Tensor],
                                 torch.Tensor]:
    """Train a PINN on the strong-form residual; returns (the MLP,
    ``u_fn(x (N, dim)) → (N,)``, losses).  The initial weights and then
    max(1, n_epochs // resample_every) blocks of ``n_points`` uniform
    points are drawn from ``generator`` (a CPU generator, default seed 0),
    one block every ``resample_every`` epochs."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    params = init_mlp(generator, mesh.dim, hidden_dim, n_layers,
                      dtype=mesh.dtype, device=mesh.device)
    n_blocks = max(1, n_epochs // resample_every)
    blocks = torch.stack([sample_collocation_points(mesh, generator,
                                                    n_points)
                          for _ in range(n_blocks)])
    losses = train_collocation_on_points(params, mesh, forcing_fn, blocks,
                                         kappa, lr, resample_every)
    phi = smooth_mask_fn(mesh)

    def u_fn(x_pts: torch.Tensor) -> torch.Tensor:
        """The trained solution at (N, dim) points."""
        with torch.no_grad():
            return network_solution(params, phi, torch.as_tensor(
                x_pts, dtype=mesh.dtype, device=mesh.device))

    return params, u_fn, losses
