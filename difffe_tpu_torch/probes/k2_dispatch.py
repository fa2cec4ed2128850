"""Host cost of K2's ways to launch, and of the loops that launch it most.

The batched MPC planner makes 6000 K2 calls a plan and the closed loop
6000 a step, each a few µs of device time, so the host's cost a call sets
their speed.  On the card, at the planner's shape (``FEMesh.line(64)``:
65 rows, B = 4096, float32, K2's warp route, bands shared by every
scenario), this probe times the host µs a call of

* ``launch``: ``tridiag_kernel._launch``, the ctypes launch alone;
* ``op``: the tree's op ``difffe::tridiag_pcr``;
* ``library`` and ``custom_op``: the same launch registered under a
  probe-local name as a plain ``torch.library.Library`` op and through
  ``torch.library.custom_op``, the two ways to make an op of it;
* ``public``: ``tridiag_solve_kernel``, with autograd recording
  (``public_grad``) and without;

in turns, a few hundred calls each, then the plan of chip_smoke.py's
phase 28 (``make_planner_batched`` at config 3's width, three chained
plans after a first) and two steps of its ``receding_horizon`` (B = 1, the
block route).  :func:`op_ways` gives the same split for K7's "tc" route at
the production loop's shape (``FEMesh.line(30)``, B = 262 144) and for K8
at chip_smoke.py's phase 22 shape (a perturbed 64² triangulation,
B = 256): the bare launch (the op's CUDA implementation), the op, and the
public call; chip_smoke.py's phase 36 times them with :func:`host_us`.  A way that a tree lacks (a tree from before the custom op)
is left out, so the probe runs on an older checkout too: copy it into that
tree's ``difffe_tpu_torch/probes/`` and run it from that tree's root.

    python -m difffe_tpu_torch.probes.k2_dispatch [--tag NAME]

prints one JSON line and writes ``chiprun_out/k2_dispatch_<tag>.json``.
"""

from __future__ import annotations

import argparse
import inspect
import json
import math
import os
import statistics
import subprocess
import time

import torch

N_MPC, BATCH_MPC = 64, 4096          # config 3: FEMesh.line(64), B = 4096
MPC_H, MPC_DT = 50, 2e-3
MPC_ITERS, MPC_LR, MPC_PENALTY = 60, 0.3, 1e-6
MPC_CENTERS, MPC_WIDTH = (0.25, 0.5, 0.75), 0.1
RH_STEPS = 2
CALLS, ROUNDS = 300, 7


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not available"


def launch_ways(tk, d, e, F):
    """name → a call of K2 on the (B, n) rows d, e (shared) and F."""
    B, n = F.shape
    spb = tk.scenarios_per_block(n)
    d2, e2 = d.expand(B, n), e.expand(B, n - 1)
    if len(inspect.signature(tk._launch).parameters) != 5:
        # the launch before the op: (d, e, F, lead, n, spb, plan)
        return {"launch": lambda: tk._launch(d, e, F, (B,), n, spb, None),
                **public_ways(tk, d, e, F)}
    schema = "(Tensor d, Tensor e, Tensor F, int spb, str? plan) -> Tensor"
    lib = torch.library.Library("difffe_k2probe", "FRAGMENT")
    lib.define("pcr" + schema)
    lib.impl("pcr", tk._launch, "CUDA")
    wrapped = torch.library.custom_op(
        "difffe_k2probe::pcr_custom_op", tk._launch, mutates_args=(),
        device_types="cuda", schema=schema)
    ways = {"launch": lambda: tk._launch(d2, e2, F, spb, None),
            "library": lambda: torch.ops.difffe_k2probe.pcr.default(
                d2, e2, F, spb, None),
            "custom_op": lambda: wrapped(d2, e2, F, spb, None),
            "_keep": (lib, wrapped)}
    if hasattr(tk, "tridiag_pcr"):
        ways["op"] = lambda: tk.tridiag_pcr(d2, e2, F, spb, None)
    return {**ways, **public_ways(tk, d, e, F)}


def op_ways(dev, gen) -> dict:
    """kernel → (name → a call): K7 on the "tc" route at the production
    loop's shape and K8 at phase 22's, each as the bare launch, the op and
    the public call, on random operands from ``gen``."""
    from difffe_tpu_torch import production
    from difffe_tpu_torch.mesh import FEMesh
    from difffe_tpu_torch.ops.kernels import ell_kernel as k8
    from difffe_tpu_torch.ops.kernels import fused_grad_kernel as k5
    from difffe_tpu_torch.ops.kernels import fused_grad_mxu_kernel as k7
    from difffe_tpu_torch.ops.unstructured import build_ell, ell_weights_bm

    mesh = production.production_mesh(dev)
    B, n = production.BATCH, mesh.n_nodes
    lk = 0.1 * torch.randn(B, generator=gen, device=dev)
    F = torch.rand(B, n, generator=gen, device=dev)
    ud = torch.rand(B, n, generator=gen, device=dev)
    cols, W = k5.scalar_columns(mesh), k7.mxu_inverse(mesh)
    scale = 2.0 / (B * n)
    k7_ways = {
        "launch": lambda: k7._cuda_tc(lk, F, ud, cols, W, scale, 2, 0),
        "op": lambda: k7.fused_mxu(lk, F, ud, cols, W, scale, 2, 0, 1024,
                                   "tc"),
        "public": lambda: k7.fused_kappa_mse_step_mxu(
            mesh, lk, F, ud, scale=scale, version=2, refine=0)}

    base = FEMesh.rectangle(64, 64, dtype=torch.float64, device="cpu")
    nodes = base.nodes.clone()
    inner = base.bc_mask < 0.5
    nodes[inner] += (torch.rand(nodes[inner].shape, dtype=torch.float64)
                     - 0.5) * 0.6 / 64
    tri = FEMesh.from_arrays(nodes.numpy(), base.elements.numpy(),
                             base.bc_mask.numpy(), base.bc_values.numpy(),
                             device=dev, dtype=torch.float32)
    ell = build_ell(tri)
    Bg = 256
    keB = 1.0 + torch.rand(tri.n_elements, Bg, generator=gen, device=dev)
    Wl, diag = ell_weights_bm(tri, ell, keB)
    v = torch.rand(tri.n_nodes, Bg, generator=gen, device=dev)
    m = tri.bc_mask.contiguous()
    k8_ways = {
        "launch": lambda: k8._launch_k8(ell.nbr, Wl, diag, v, m),
        "op": lambda: k8.k8_op(ell.nbr, Wl, diag, v, m, None),
        "public": lambda: k8.ell_apply(ell.nbr, Wl, diag, v, m)}
    for ways in (k7_ways, k8_ways):
        ref = ways["launch"]()
        for k in ("op", "public"):
            got = ways[k]()
            for a, b in zip(ref if isinstance(ref, tuple) else (ref,),
                            got if isinstance(got, tuple) else (got,)):
                if not torch.equal(a, b):
                    raise AssertionError(f"{k} differs from the launch")
    return {"K7 tc": k7_ways, "K8": k8_ways,
            "shapes": {"K7 tc": [B, n],
                       "K8": [tri.n_nodes, int(ell.nbr.shape[1]), Bg]}}


def public_ways(tk, d, e, F):
    Fg = F.clone().requires_grad_(True)
    return {"public": lambda: tk.tridiag_solve_kernel(d, e, F),
            "public_grad": lambda: tk.tridiag_solve_kernel(d, e, Fg)}


def host_us(ways) -> dict:
    """Median host µs a call of each way over ROUNDS rounds taken in
    turns; each round issues CALLS calls unsynchronized, then waits."""
    names = [k for k in ways if not k.startswith("_")]
    for k in names:
        for _ in range(20):
            ways[k]()
    torch.cuda.synchronize()
    times = {k: [] for k in names}
    for _ in range(ROUNDS):
        for k in names:
            fn = ways[k]
            t0 = time.perf_counter()
            for _ in range(CALLS):
                fn()
            times[k].append((time.perf_counter() - t0) / CALLS * 1e6)
            torch.cuda.synchronize()
    return {k: statistics.median(v) for k, v in times.items()}


def plan_and_loop(dev) -> dict:
    from difffe_tpu_torch.control import (MPCConfig, gaussian_actuators,
                                          make_planner_batched,
                                          receding_horizon)
    from difffe_tpu_torch.mesh import FEMesh

    mesh = FEMesh.line(N_MPC, dtype=torch.float32, device=dev)
    x = mesh.nodes[:, 0]
    kappa = torch.linspace(0.8, 1.6, BATCH_MPC, device=dev)
    amp = torch.linspace(0.1, 0.4, BATCH_MPC, device=dev)
    targets = (amp[:, None] * torch.sin(math.pi * x))[:, None, :].expand(
        BATCH_MPC, MPC_H, mesh.n_nodes)
    act = gaussian_actuators(mesh, MPC_CENTERS, MPC_WIDTH)
    cfg = MPCConfig(horizon=MPC_H, dt=MPC_DT, lr=MPC_LR,
                    plan_iters=MPC_ITERS, control_penalty=MPC_PENALTY)
    plan = make_planner_batched(mesh, kappa, act, cfg)
    u0 = torch.zeros(BATCH_MPC, mesh.n_nodes, device=dev)
    q = torch.zeros(BATCH_MPC, MPC_H, len(MPC_CENTERS), device=dev)
    q, _ = plan(u0, targets, q)
    plans = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        q, _ = plan(u0, targets, q)
        torch.cuda.synchronize()
        plans.append(time.perf_counter() - t0)
    target = (0.3 * torch.sin(math.pi * x)).expand(MPC_H, mesh.n_nodes)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    receding_horizon(mesh, 1.0, torch.zeros_like(x), act, target, cfg,
                     RH_STEPS)
    torch.cuda.synchronize()
    return {"plan_s": plans,
            "rh_step_s": (time.perf_counter() - t0) / RH_STEPS}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="k2_dispatch")
    p.add_argument("--tag", default="tree")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k2_dispatch times K2 on a CUDA card; none here")
    from difffe_tpu_torch.ops.kernels import tridiag_kernel as tk

    dev = torch.device("cuda")
    n, B = N_MPC + 1, BATCH_MPC
    d = torch.full((1, n), 2.0, device=dev)
    e = torch.full((1, n - 1), -1.0, device=dev)
    F = torch.rand(B, n, device=dev)
    ways = launch_ways(tk, d, e, F)
    ref = tk.tridiag_solve_kernel(d, e, F)
    for k in ("op", "library", "custom_op"):
        if k in ways and not torch.equal(ways[k](), ref):
            raise AssertionError(f"K2 through {k} differs from the public "
                                 f"call")
    out = {"tag": args.tag, "card": _card(), "shape": [B, n],
           "host_us": host_us(ways), **plan_and_loop(dev)}
    line = json.dumps(out)
    print(line)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", f"k2_dispatch_{args.tag}.json"),
              "w") as fh:
        fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
