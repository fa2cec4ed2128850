"""The cells' inputs, made on the device from the seed.

Each scenario's κ field and forcing is a smooth random field: a sum of
``modes`` cosines with integer wave vectors up to ``max_wavenumber`` a
axis, random phases and normal amplitudes, evaluated at the element
centroids (κ, as exp of the sum) or at the nodes (f, as amplitude times
1 + the sum).  A pool of such batches is made once a run; the traffic uses
its entries in turn.  The same seed gives the same tensors.

The reference's float64 observations are timed on their own: the harness
leaves their seconds out of ``setup_s``.
"""

from __future__ import annotations

import math
import time

import torch

from .reference import fem


def smooth(gen, batch, points, spec):
    """(batch, n) sums of cosines at ``points`` (n, dim), float32."""
    dev, (n, dim) = points.device, points.shape
    m = int(spec["modes"])
    amp = torch.randn(batch, m, generator=gen, device=dev) / math.sqrt(m)
    k = torch.randint(0, int(spec["max_wavenumber"]) + 1, (batch, m, dim),
                      generator=gen, device=dev).to(torch.float32)
    phase = 2.0 * math.pi * torch.rand(batch, m, 1, generator=gen,
                                       device=dev)
    out = torch.zeros(batch, n, device=dev)
    for j in range(m):        # one (batch, n) plane a mode, not (batch, m, n)
        arg = 2.0 * math.pi * (k[:, j] @ points.T) + phase[:, j]
        out += amp[:, j, None] * torch.cos(arg)
    return float(spec["sigma"]) * out


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def pool(grid: fem.Grid, cell: dict, config: dict, seed: int, device,
         observations: bool):
    """(batches, reference seconds): ``cell['pool']`` input batches, dicts
    of κ_true (B, n_elements) and f (B, n_nodes), float32, and with
    ``observations`` u_data (B, n_nodes), the reference's float64 solve at
    κ_true, rounded to float32; and the seconds those solves took."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    B = int(cell["batch"])
    cents = grid.centroids(torch.float32, device)
    nodes = grid.nodes(torch.float32, device)
    g = float(config["boundary"]["value"])
    out, reference_s = [], 0.0
    for _ in range(int(cell["pool"])):
        kappa = torch.exp(smooth(gen, B, cents, cell["kappa_true"]))
        f = float(cell["forcing"]["amplitude"]) * (
            1.0 + smooth(gen, B, nodes, cell["forcing"]))
        entry = {"kappa_true": kappa, "f": f}
        if observations:
            _sync(device)
            t = time.perf_counter()
            u = fem.solve(grid, kappa.double(), f.double(), g,
                          int(config["data_iters"]))
            entry["u_data"] = u.to(torch.float32)
            del u
            _sync(device)
            reference_s += time.perf_counter() - t
        out.append(entry)
    return out, reference_s
