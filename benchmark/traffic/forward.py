"""Traffic kind ``forward``: one caller in a closed loop of fixed-trip
batched solves.

A call is ``solve_poisson_batched(mesh, κ (B, n_elements), f (B, n_nodes),
cg_tol=0.0, cg_maxiter=maxiter)`` on the pool's input batches in turn; the
caller waits for u before the next call.  ``solves_per_s`` is batch ×
calls over the window; ``solve_ms_p95`` the 95th percentile over all calls
of a call's time from its start until u is ready, read from CUDA events on
the stream around the call (the card's clock; on the CPU the host's).
The host's own time in the call, until it returns, is kept for the
per-layer metric ``host_ms_per_call.forward``.

``correct``: u of ``sample`` calls, drawn from the seed among all calls of
the window, against the reference's float64 solve of the same input with
the same iterations (max abs gap over max abs u).
"""

from __future__ import annotations

import math
import random
import statistics
import time

from .. import inputs
from ..reference import fem

END_TO_END = ("solves_per_s", "solve_ms_p95")


class State:
    def __init__(self, ctx):
        self.ctx, self.cell, self.config = ctx, ctx.cell, ctx.config
        self.grid = fem.Grid(self.config["mesh"]["cells"])
        self.pool, self.reference_s = inputs.pool(
            self.grid, self.cell, self.config, ctx.seed, ctx.device,
            observations=False)
        self.program = ctx.program
        self.samples = []           # (pool index, u)
        self.host_s = []            # host time of each untraced call

    def call(self, k):
        p = self.pool[k % len(self.pool)]
        return self.program.solve(p["kappa_true"], p["f"],
                                  int(self.cell["maxiter"]))


def setup(ctx) -> State:
    return State(ctx)


def unit_work(state: State) -> dict:
    nodes = state.grid.n_nodes * state.cell["batch"]
    return {"steps": 1, "cg_node_iterations": nodes * state.cell["maxiter"],
            "dim": state.grid.dim}


def warm(state: State) -> None:
    for k in range(len(state.pool)):
        state.call(k)
    state.ctx.synchronize()


def _p95(values):
    """The 95th percentile, by statistics.quantiles' exclusive method."""
    if len(values) < 2:
        return values[0]
    return statistics.quantiles(values, n=20)[-1]


def window(state: State, seconds: float, tracer) -> dict:
    rng = random.Random(state.ctx.seed)
    keep = int(state.cell["sample"])
    clock = state.ctx.event_clock()
    lat = []
    t0 = time.perf_counter()
    deadline = t0 + seconds
    k = 0
    while True:
        with tracer.unit() as traced:
            start = clock.mark()
            h0 = time.perf_counter()
            u = state.call(k)
            h1 = time.perf_counter()
            end = clock.mark()
            clock.wait(end)
        lat.append(clock.seconds(start, end))
        if not traced:
            state.host_s.append(h1 - h0)
        item = (k % len(state.pool), u)
        if k < keep:
            state.samples.append(item)
        else:
            j = rng.randrange(k + 1)
            if j < keep:
                state.samples[j] = item
        k += 1
        if time.perf_counter() >= deadline:
            break
    t1 = time.perf_counter()
    B = state.cell["batch"]
    return {"metrics": {"solves_per_s": k * B / (t1 - t0),
                        "solve_ms_p95": 1e3 * _p95(lat)},
            "attempted": k, "failed": 0, "seconds": t1 - t0,
            "note": f"{k} calls in {t1 - t0:.3f} s; solve_ms_p95 over "
                    f"{len(lat)} calls, median "
                    f"{1e3 * statistics.median(lat):.4f} ms"}


def release(state: State) -> None:
    state.program = None


def check(state: State) -> dict:
    worst = 0.0
    g = float(state.config["boundary"]["value"])
    refs = {}
    for idx, u in state.samples:
        if idx not in refs:
            p = state.pool[idx]
            refs[idx] = fem.solve(state.grid, p["kappa_true"].double(),
                                  p["f"].double(), g,
                                  int(state.cell["maxiter"]))
        ur = refs[idx]
        v = float((u.double() - ur).abs().max() / ur.abs().max())
        if math.isnan(v) or v > worst:
            worst = v
    return {"u": worst}
