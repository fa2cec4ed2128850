"""Neural PDE surrogate: an MLP with hard Dirichlet enforcement.

PyTorch counterpart of ``difffe_tpu/models/neural.py``: a
dim→[hidden, tanh]×L→1 MLP whose output is multiplied by a lifting mask
that vanishes on the Dirichlet nodes (1D: the polynomial (x−a)(b−x) over
the span of the Dirichlet nodes, normalized; 2D: the binary 0-on-boundary
indicator), trained with Adam against a physics loss.

The JAX parameter pytree ``[(W (d_in, d_out), b (d_out,)), …]`` becomes
an :class:`MLP` module of ``nn.Linear`` layers (weight (d_out, d_in));
:func:`mlp_params_from_jax` carries JAX weights across, and the JAX
``apply_mlp(params, x)`` is the module's call ``params(x)``.  Initial weights
are uniform ±1/√fan_in drawn from an explicit ``torch.Generator`` on the
CPU, then moved to the mesh's device, so a seed gives the same network on
every device (not the JAX package's numbers: those come from
``jax.random``).  The JAX ``lax.scan`` training loops are Python loops
over Adam steps whose losses stay on the device until the loop ends;
``train_pde_batched`` trains B networks as one batched program on stacked
weights (``torch.baddbmm``), as the JAX package ``vmap``s them.
"""

from __future__ import annotations

import copy
import math
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..inverse import _adam_loop
from ..losses import energy_loss, fem_match_loss, variational_fd_loss
from ..mesh import FEMesh
from ..solver import solve_poisson, solve_poisson_batched


class MLP(nn.Module):
    """dims[0]→[hidden, tanh]×…→dims[-1]; ``forward`` maps x (…, in_dim)
    to the raw scalar field (…), or with ``squeeze`` false to the linear
    head's (…, dims[-1]) outputs (the DeepONet heads of
    models/operator.py)."""

    def __init__(self, dims: Sequence[int], dtype=None, device=None,
                 squeeze: bool = True):
        super().__init__()
        self.layers = nn.ModuleList(
            nn.Linear(a, b, dtype=dtype, device=device)
            for a, b in zip(dims[:-1], dims[1:]))
        self.squeeze = squeeze

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for layer in self.layers[:-1]:
            h = torch.tanh(layer(h))
        out = self.layers[-1](h)
        return out[..., 0] if self.squeeze else out


class BatchedMLP(nn.Module):
    """B independent MLPs on stacked weights W (B, d_in, d_out) and
    b (B, 1, d_out): ``forward`` maps x (N, in_dim) to (B, N)."""

    def __init__(self, nets: Sequence[MLP]):
        super().__init__()
        n_layers = len(nets[0].layers)
        self.W = nn.ParameterList(
            torch.stack([net.layers[k].weight.detach().T for net in nets])
            for k in range(n_layers))
        self.b = nn.ParameterList(
            torch.stack([net.layers[k].bias.detach()[None] for net in nets])
            for k in range(n_layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.expand((self.W[0].shape[0],) + x.shape)
        for W, b in zip(self.W[:-1], self.b[:-1]):
            h = torch.tanh(torch.baddbmm(b, h, W))
        return torch.baddbmm(self.b[-1], h, self.W[-1])[..., 0]


def init_mlp(generator: torch.Generator, in_dim: int, hidden_dim: int,
             n_layers: int, dtype=torch.float32, device=None) -> MLP:
    """A dim→[hidden, tanh]×n_layers→1 MLP with torch-Linear-style uniform
    ±1/√fan_in weights and biases drawn from ``generator`` (a CPU
    generator), on ``device``."""
    dims = [in_dim] + [hidden_dim] * n_layers + [1]
    net = MLP(dims, dtype=dtype)
    with torch.no_grad():
        for layer in net.layers:
            bound = 1.0 / math.sqrt(layer.in_features)
            layer.weight.uniform_(-bound, bound, generator=generator)
            layer.bias.uniform_(-bound, bound, generator=generator)
    return net.to(device) if device is not None else net


def mlp_params_from_jax(params, dtype=None, device=None,
                        squeeze: bool = True) -> MLP:
    """The port's MLP holding the JAX package's parameters ``[(W (d_in,
    d_out), b (d_out,)), …]`` (numpy or JAX arrays): each nn.Linear weight
    is Wᵀ.  ``squeeze`` as in :class:`MLP`."""
    Ws = [np.asarray(W) for W, _ in params]
    dims = [Ws[0].shape[0]] + [W.shape[1] for W in Ws]
    dtype = dtype or torch.from_numpy(np.empty(0, Ws[0].dtype)).dtype
    net = MLP(dims, dtype=dtype, device=device, squeeze=squeeze)
    with torch.no_grad():
        for layer, (W, b) in zip(net.layers, params):
            layer.weight.copy_(torch.from_numpy(np.array(W).T))
            layer.bias.copy_(torch.from_numpy(np.array(b)))
    return net


def _mask_span(mesh: FEMesh):
    """(a, b, norm) of the 1D polynomial mask, or None with < 2 Dirichlet
    nodes."""
    x = mesh.nodes[:, 0]
    bc_idx = torch.nonzero(mesh.bc_mask > 0.5)[:, 0]
    if bc_idx.numel() < 2:
        return None
    a, b = x[bc_idx[0]], x[bc_idx[-1]]
    norm = ((x - a) * (b - x)).abs().max() + 1e-12
    return a, b, norm


def boundary_mask(mesh: FEMesh) -> torch.Tensor:
    """Lifting mask φ (n_nodes,), zero on Dirichlet nodes."""
    if mesh.dim == 1:
        x = mesh.nodes[:, 0]
        span = _mask_span(mesh)
        if span is None:
            return torch.ones_like(x)
        a, b, norm = span
        return (x - a) * (b - x) / norm
    return 1.0 - mesh.bc_mask


def boundary_mask_at(mesh: FEMesh, x: torch.Tensor) -> torch.Tensor:
    """The 1D lifting mask at query points x (N, 1); the 2D mask is a nodal
    indicator and has no off-node form."""
    if mesh.dim != 1:
        raise NotImplementedError(
            "off-node mask evaluation is only defined for 1D meshes (the 2D "
            "mask is a nodal indicator)")
    span = _mask_span(mesh)
    if span is None:
        return torch.ones(x.shape[:-1], dtype=mesh.dtype, device=x.device)
    a, b, norm = span
    xq = x[..., 0]
    return (xq - a) * (b - xq) / norm


def neural_pde_forward(params: nn.Module, mesh: FEMesh, mask: torch.Tensor,
                       x: Optional[torch.Tensor] = None) -> torch.Tensor:
    """u(x) = φ(x)·net(x): at the mesh nodes with the precomputed nodal
    mask when x is None, else with the mask evaluated at x.  A
    :class:`BatchedMLP` gives (B, n) fields."""
    if x is None:
        return mask * params(mesh.nodes)
    return boundary_mask_at(mesh, x) * params(x)


def train_pde(params: MLP, mesh: FEMesh,
              forcing_fn: Callable[[torch.Tensor], torch.Tensor],
              n_epochs: int = 2000, lr: float = 1e-3,
              mode: str = "fem_match", kappa=1.0
              ) -> Tuple[MLP, torch.Tensor]:
    """Train a copy of the surrogate; returns (trained MLP, per-epoch
    losses (n_epochs,)).  The ``fem_match`` target is solved once."""
    mask = boundary_mask(mesh)
    coords = mesh.nodes[:, 0] if mesh.dim == 1 else mesh.nodes
    f = forcing_fn(coords)
    if mode == "fem_match":
        with torch.no_grad():
            u_fem = solve_poisson(mesh, kappa, f)

        def loss_of(u):
            return fem_match_loss(mesh, u, u_fem)
    elif mode == "variational":
        def loss_of(u):
            return variational_fd_loss(mesh, u, f)
    elif mode == "energy":
        def loss_of(u):
            return energy_loss(mesh, kappa, u, f)
    else:
        raise ValueError(f"Unknown mode: {mode!r}")
    params = copy.deepcopy(params)
    losses = _adam_loop(
        params.parameters(),
        lambda: loss_of(neural_pde_forward(params, mesh, mask)), n_epochs, lr)
    return params, losses


def train_pde_batched(inits: Sequence[Union[torch.Generator, MLP]],
                      mesh: FEMesh, f_batch, n_epochs: int = 2000,
                      lr: float = 1e-3, hidden_dim: int = 32,
                      n_layers: int = 3, kappa=1.0,
                      kappa_batched: Optional[bool] = None
                      ) -> Tuple[BatchedMLP, torch.Tensor]:
    """Train B independent surrogates, one per forcing f_batch[b], as one
    batched program.

    ``inits``: B CPU generators, each drawing one network's initial
    weights (as the JAX package's ``keys``), or B initial :class:`MLP`\\ s.
    κ may be per scenario ((B, …); ``kappa_batched`` as in
    ``solve_poisson_batched``).  Returns (the trained :class:`BatchedMLP`,
    losses (B, n_epochs)).
    """
    f_batch = torch.as_tensor(f_batch, dtype=mesh.dtype, device=mesh.device)
    mask = boundary_mask(mesh)
    with torch.no_grad():
        u_fem = solve_poisson_batched(mesh, kappa, f_batch,
                                      kappa_batched=kappa_batched)
    nets = [init if isinstance(init, MLP) else
            init_mlp(init, mesh.dim, hidden_dim, n_layers, dtype=mesh.dtype)
            for init in inits]
    params = BatchedMLP([net.to(mesh.device) for net in nets])

    def loss_fn():
        u = neural_pde_forward(params, mesh, mask)
        return ((u - u_fem) ** 2).mean(dim=-1)

    return params, _adam_loop(params.parameters(), loss_fn, n_epochs, lr)


class NeuralPDE:
    """``model = NeuralPDE(mesh); model.train_pde(forcing_fn)``, the
    reference's class shape.  Holds the :class:`MLP` as ``params``."""

    def __init__(self, mesh: FEMesh, hidden_dim: int = 32, n_layers: int = 3,
                 generator: Optional[torch.Generator] = None):
        self.mesh = mesh
        self.dim = mesh.dim
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.params = init_mlp(generator, mesh.dim, hidden_dim, n_layers,
                               dtype=mesh.dtype, device=mesh.device)
        self._mask = boundary_mask(mesh)

    def __call__(self, x: Optional[torch.Tensor] = None) -> torch.Tensor:
        return neural_pde_forward(self.params, self.mesh, self._mask, x)

    forward = __call__

    def train_pde(self, forcing_fn: Callable[[torch.Tensor], torch.Tensor],
                  n_epochs: int = 2000, lr: float = 1e-3,
                  mode: str = "fem_match", verbose: bool = True,
                  log_every: int = 200, kappa=1.0) -> List[float]:
        """Train in place; returns the per-epoch losses as a list."""
        self.params, losses = train_pde(self.params, self.mesh, forcing_fn,
                                        n_epochs=n_epochs, lr=lr, mode=mode,
                                        kappa=kappa)
        losses_list = losses.tolist()
        if verbose:
            for e in range(log_every - 1, n_epochs, log_every):
                print(f"  Epoch {e + 1:5d}  loss = {losses_list[e]:.3e}")
        return losses_list
