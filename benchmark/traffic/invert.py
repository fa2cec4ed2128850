"""Traffic kind ``invert``: closed-loop κ inversion jobs, back to back.

A job is one inversion of a batch of ``batch`` scenarios from κ = 1 over
``steps`` SGD steps with its final eval solve (``Port.job``: the user's
``fit_kappa(mesh, f, u_data, steps=steps)``).  Jobs take the pool's input
batches in turn and run while the window has time left, each to its end;
``grad_solves_per_s`` is batch × steps of every job over the time from the
first job's start to the last one's end.

``correct``: the answers of ``sample`` jobs, drawn from the seed among all
jobs of the window, against the reference's float64 inversion of the same
input (``fem.fit`` with the cell's ``job`` semantics): the change of κ from
1 (max abs gap over max abs change), the loss history (largest gap a step
over the reference's loss) and the eval loss (gap over the reference's).
"""

from __future__ import annotations

import math
import random
import time

from .. import inputs
from ..reference import fem

END_TO_END = ("grad_solves_per_s",)


class State:
    def __init__(self, ctx):
        self.ctx, self.cell, self.config = ctx, ctx.cell, ctx.config
        self.grid = fem.Grid(self.config["mesh"]["cells"])
        self.pool, self.reference_s = inputs.pool(
            self.grid, self.cell, self.config, ctx.seed, ctx.device,
            observations=True)
        self.program = ctx.program
        self.samples = []           # (pool index, κ, history, eval loss)

    def job(self, k, steps=None):
        p = self.pool[k % len(self.pool)]
        return self.program.job(p["f"], p["u_data"],
                                int(steps or self.cell["steps"]))


def setup(ctx) -> State:
    return State(ctx)


def unit_work(state: State) -> dict:
    """What one job does: its SGD steps and the CG operations of every
    solve it runs (two a step and the eval solve)."""
    job, nodes = state.cell["job"], state.grid.n_nodes * state.cell["batch"]
    iters = 2 * state.cell["steps"] * job["cg_iters"] + job["eval_iters"]
    return {"steps": state.cell["steps"], "cg_node_iterations":
            nodes * iters, "dim": state.grid.dim}


def warm(state: State) -> None:
    """A two-step job: every kernel and shape of a job (the steps' and the
    eval's), at a fiftieth of its time."""
    state.job(0, steps=2)
    state.ctx.synchronize()


def window(state: State, seconds: float, tracer) -> dict:
    rng = random.Random(state.ctx.seed)
    keep = int(state.cell["sample"])
    t0 = time.perf_counter()
    deadline = t0 + seconds
    k = 0
    while True:
        with tracer.unit():
            kappa, hist, ev = state.job(k)
        # reservoir sampling: each job of the window equally likely
        item = (k % len(state.pool), kappa, hist, ev)
        if k < keep:
            state.samples.append(item)
        else:
            j = rng.randrange(k + 1)
            if j < keep:
                state.samples[j] = item
        k += 1
        if time.perf_counter() >= deadline:
            break
    state.ctx.synchronize()
    t1 = time.perf_counter()
    done = k * state.cell["batch"] * state.cell["steps"]
    return {"metrics": {"grad_solves_per_s": done / (t1 - t0)},
            "attempted": k, "failed": 0, "seconds": t1 - t0,
            "note": f"{k} jobs in {t1 - t0:.3f} s"}


def release(state: State) -> None:
    state.program = None


def check(state: State) -> dict:
    """The readings of the sampled jobs against the float64 reference."""
    worst = {"kappa_change": 0.0, "loss_history": 0.0, "eval_loss": 0.0}
    g = float(state.config["boundary"]["value"])
    for idx, kappa, hist, ev in state.samples:
        p = state.pool[idx]
        kr, hr, er = fem.fit(state.grid, p["f"].double(),
                             p["u_data"].double(), g,
                             steps=int(state.cell["steps"]),
                             **state.cell["job"])
        dk = kr - 1.0
        got = {
            "kappa_change": float((kappa.double() - 1.0 - dk).abs().max()
                                  / dk.abs().max()),
            "loss_history": float(((hist.double() - hr).abs() / hr).max()),
            "eval_loss": abs(float(ev) - float(er)) / float(er),
        }
        for name, v in got.items():
            if math.isnan(v) or v > worst[name]:    # a NaN stays and fails
                worst[name] = v
        del kr, hr
    return worst
