"""Models: neural PDE surrogates (node-based, mesh-free collocation and the
DeepONet operator surrogate).  The JAX package's ``apply_mlp(params, x)``
is the :class:`MLP` module's call ``params(x)``."""

from .collocation import train_collocation
from .neural import MLP, NeuralPDE, boundary_mask, init_mlp, train_pde

__all__ = [
    "train_collocation",
    "NeuralPDE",
    "MLP",
    "boundary_mask",
    "init_mlp",
    "train_pde",
]
