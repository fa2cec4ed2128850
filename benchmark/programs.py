"""What the traffic drives: the program under test (the PyTorch and CUDA
port) or, for the control, the reference put in its place.

Both give the same two calls:

* ``job(f, u_data, steps)`` → (κ (B, n_elements), loss history (steps,),
  eval loss): one κ inversion from κ = 1;
* ``solve(kappa, f, maxiter)`` → u (B, n_nodes): one fixed-trip batched
  solve.
"""

from __future__ import annotations

import torch

from .reference import fem

DTYPES = {"float32": torch.float32, "float64": torch.float64}


class Port:
    """``difffe_tpu_torch`` on the configuration's mesh, called as a user
    calls it: ``inverse.fit_kappa`` with its defaults and
    ``solver.solve_poisson_batched`` with a fixed trip."""

    def __init__(self, config: dict, device):
        from difffe_tpu_torch.inverse import fit_kappa
        from difffe_tpu_torch.mesh import FEMesh
        from difffe_tpu_torch.solver import solve_poisson_batched

        factory = getattr(FEMesh, config["mesh"]["factory"])
        self.mesh = factory(*config["mesh"]["cells"],
                            bc_value=float(config["boundary"]["value"]),
                            dtype=DTYPES[config["dtype"]], device=device)
        self._fit, self._solve = fit_kappa, solve_poisson_batched

    def job(self, f, u_data, steps):
        kappa, info = self._fit(self.mesh, f, u_data, steps=steps)
        return kappa, info["loss_history"], info["eval_loss"]

    def solve(self, kappa, f, maxiter):
        return self._solve(self.mesh, kappa, f, cg_tol=0.0,
                           cg_maxiter=maxiter)


class Reference:
    """The plain reference in ``dtype`` on the same problem: the control
    when ``dtype`` is below the configuration's."""

    def __init__(self, config: dict, cell: dict, dtype):
        self.grid = fem.Grid(config["mesh"]["cells"])
        self.g = float(config["boundary"]["value"])
        self.cell, self.dtype = cell, dtype

    def job(self, f, u_data, steps):
        kappa, hist, ev = fem.fit(self.grid, f.to(self.dtype),
                                  u_data.to(self.dtype), self.g,
                                  steps=steps, **self.cell["job"])
        return kappa.float(), hist.float(), float(ev)

    def solve(self, kappa, f, maxiter):
        return fem.solve(self.grid, kappa.to(self.dtype), f.to(self.dtype),
                         self.g, maxiter).float()
