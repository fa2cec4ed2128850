"""Operator-learning surrogate: one network across the scenario family.

PyTorch counterpart of ``difffe_tpu/models/operator.py``.  A DeepONet-style
model

    u(x; s) = φ(x) · Σ_k  branch_k(s) · trunk_k(x) + bias

where ``s`` is a per-scenario feature vector (κ parameters, forcing
coefficients, BC amplitudes…), ``branch``/``trunk`` are MLPs with an
n_basis-wide linear head, and φ is the boundary-vanishing lifting mask
(``neural.boundary_mask``), so Dirichlet BCs hold for every scenario by
construction.  One trained model amortizes the whole family: inference for
a new scenario is one forward pass and no solve.

The JAX ``DeepONetParams`` pytree becomes the :class:`DeepONet` module
(``deeponet_params_from_jax`` carries JAX weights across); initial weights
come from an explicit CPU ``torch.Generator`` (not the JAX package's
numbers, which come from ``jax.random``).  Training is full-batch Adam
(optax's defaults) as a Python loop whose losses stay on the device.
"""

from __future__ import annotations

import copy
import math
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..inverse import _adam_loop
from ..mesh import FEMesh
from .neural import MLP, boundary_mask, init_mlp, mlp_params_from_jax


class DeepONet(nn.Module):
    """Branch s (…, ds) → (…, n_basis), trunk x (…, dim) → (…, n_basis),
    and a scalar bias."""

    def __init__(self, branch: MLP, trunk: MLP, bias: torch.Tensor):
        super().__init__()
        self.branch = branch
        self.trunk = trunk
        self.bias = nn.Parameter(bias)


def _init_head(generator: torch.Generator, in_dim: int, width: int,
               depth: int, n_basis: int, dtype) -> MLP:
    """An MLP in_dim→[width, tanh]×depth→n_basis with ``init_mlp``'s
    hidden layers and an n_basis-wide linear head: weights uniform
    ±1/√width, bias zero."""
    net = init_mlp(generator, in_dim, width, depth, dtype=dtype)
    head = nn.Linear(width, n_basis, dtype=dtype)
    with torch.no_grad():
        bound = 1.0 / math.sqrt(width)
        head.weight.uniform_(-bound, bound, generator=generator)
        head.bias.zero_()
    net.layers[-1] = head
    net.squeeze = False
    return net


def init_deeponet(generator: torch.Generator, feat_dim: int, dim: int,
                  width: int = 64, depth: int = 3, n_basis: int = 32,
                  dtype=torch.float32, device=None) -> DeepONet:
    """A DeepONet drawn from ``generator`` (a CPU generator), on
    ``device``."""
    net = DeepONet(
        _init_head(generator, feat_dim, width, depth, n_basis, dtype),
        _init_head(generator, dim, width, depth, n_basis, dtype),
        torch.zeros((), dtype=dtype))
    return net.to(device) if device is not None else net


def deeponet_params_from_jax(params, dtype=None, device=None) -> DeepONet:
    """The port's DeepONet holding a JAX ``DeepONetParams`` (branch, trunk,
    bias) of numpy or JAX arrays."""
    branch, trunk, bias = params
    bias = torch.tensor(np.asarray(bias))
    return DeepONet(
        mlp_params_from_jax(branch, dtype, device, squeeze=False),
        mlp_params_from_jax(trunk, dtype, device, squeeze=False),
        bias.to(dtype=dtype or bias.dtype, device=device))


def deeponet_forward(params: DeepONet, mesh: FEMesh, mask: torch.Tensor,
                     feats: torch.Tensor) -> torch.Tensor:
    """u for a batch of scenarios at the mesh nodes: feats (B, ds) →
    (B, n)."""
    b = params.branch(feats)                       # (B, n_basis)
    t = params.trunk(mesh.nodes)                   # (n, n_basis)
    return mask * (b @ t.T + params.bias)


def train_operator(mesh: FEMesh, feats, u_targets, n_epochs: int = 3000,
                   lr: float = 1e-3, width: int = 64, depth: int = 3,
                   n_basis: int = 32,
                   init: Optional[Union[torch.Generator, DeepONet]] = None
                   ) -> Tuple[DeepONet, Callable[[torch.Tensor],
                                                 torch.Tensor],
                              torch.Tensor]:
    """Fit the operator on (feats (B, ds), u_targets (B, n)) pairs.

    ``init``: a CPU generator drawing the initial weights (default seed 0)
    or an initial :class:`DeepONet` (trained on a copy).  Returns (the
    trained DeepONet, ``u_fn(feats) → (B', n)`` for new scenarios, losses
    (n_epochs,)).
    """
    feats = torch.as_tensor(feats, dtype=mesh.dtype, device=mesh.device)
    u_targets = torch.as_tensor(u_targets, dtype=mesh.dtype,
                                device=mesh.device)
    mask = boundary_mask(mesh)
    if isinstance(init, DeepONet):
        params = copy.deepcopy(init).to(mesh.device)
    else:
        params = init_deeponet(
            init if init is not None else torch.Generator().manual_seed(0),
            feats.shape[1], mesh.dim, width, depth, n_basis, mesh.dtype,
            mesh.device)

    def loss_fn():
        u = deeponet_forward(params, mesh, mask, feats)
        return ((u - u_targets) ** 2).mean()

    losses = _adam_loop(params.parameters(), loss_fn, n_epochs, lr)

    def u_fn(new_feats) -> torch.Tensor:
        with torch.no_grad():
            return deeponet_forward(params, mesh, mask, torch.as_tensor(
                new_feats, dtype=mesh.dtype, device=mesh.device))

    return params, u_fn, losses
