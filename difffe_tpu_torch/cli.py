"""Command-line entry point: run any BASELINE scenario end to end.

    python -m difffe_tpu_torch.cli list
    python -m difffe_tpu_torch.cli run heat_mpc_1d
    python -m difffe_tpu_torch.cli run topopt_2d
    python -m difffe_tpu_torch.cli run batched_inverse_1d --batch 2048
    python -m difffe_tpu_torch.cli bench batched_inverse_1d
    python -m difffe_tpu_torch.cli invert --dim 2
    python -m difffe_tpu_torch.cli export solver.pt2 --dim 1 --batch 256
    python -m difffe_tpu_torch.cli serve solver.pt2 < requests.jsonl

PyTorch counterpart of ``difffe_tpu/cli.py``: the same commands, scenarios
and result keys, over the port's functional API, the config system
(utils/config.py), the metrics stream (utils/metrics.py) and the chained
timing harness (utils/profiling.py).  Everything runs on the CUDA card
unless ``--device cpu`` is given (``bench`` measures the card and refuses
the CPU).  As in the JAX CLI, ``run heat_mpc_1d`` runs one unbatched
receding-horizon loop whatever the config's batch, and ``bench`` times the
1D κ-recovery step for every 1D scenario, ``heat_mpc_1d`` included.
``export`` writes an AOT solver artifact (utils/export.py; ``--grad`` the
forward + adjoint gradient step) for the device it runs on, and ``serve``
answers JSON-line requests on stdin with it, one JSON line each on stdout.
On the card a 1D artifact solves on kernel K2 (``method="tridiag_pallas"``)
where the JAX CLI's takes the plain sweeps; on the CPU it takes the sweeps.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time

import torch


def _dtype(cfg) -> torch.dtype:
    return torch.float64 if cfg.dtype == "f64" else torch.float32


def _mesh_for(cfg, device):
    from .mesh import FEMesh
    if cfg.dim == 1:
        return FEMesh.line(n_elements=cfg.n_elements, dtype=_dtype(cfg),
                           device=device)
    return FEMesh.rectangle(nx=cfg.n_elements, ny=cfg.n_elements,
                            dtype=_dtype(cfg), device=device)


def _uniform(shape, seed, dtype, device):
    """U[0, 1) of ``shape`` drawn from a CPU generator seeded with
    ``seed``, on ``device``."""
    g = torch.Generator().manual_seed(seed)
    return torch.rand(shape, generator=g, dtype=dtype).to(device)


def _kappa_recovery(cfg, mesh):
    """The batched scalar-κ recovery workload: (κ_true (B,), f (B, n),
    u_data (B, n), the per-scenario loss of log κ)."""
    from .solver import solve_poisson_batched

    B = cfg.batch
    x = mesh.nodes[:, 0]
    k_true = 1.0 + 2.0 * _uniform((B,), cfg.seed, mesh.dtype, mesh.device)
    f = (torch.sin(math.pi * x) + 1.0).expand(B, mesh.n_nodes)
    with torch.no_grad():
        u_data = solve_poisson_batched(mesh, k_true, f, method=cfg.method,
                                       kappa_batched=True)

    def loss_fn(log_k):
        u = solve_poisson_batched(mesh, log_k.exp(), f, method=cfg.method,
                                  kappa_batched=True)
        return ((u - u_data) ** 2).mean()

    return k_true, loss_fn


def run_scenario(cfg, device="cuda", log=print):
    """Dispatch one scenario; returns a result dict."""
    from .inverse import _adam
    from .utils.metrics import MetricsLogger

    mesh = _mesh_for(cfg, device)
    metrics = MetricsLogger(stream=None)

    if cfg.horizon > 0:
        # time-dependent MPC scenario
        from .control import MPCConfig, gaussian_actuators, receding_horizon
        x = mesh.nodes[:, 0]
        target_field = 0.3 * torch.sin(math.pi * x)
        mcfg = MPCConfig(horizon=cfg.horizon, dt=cfg.dt, lr=0.3,
                         plan_iters=cfg.n_opt_steps, control_penalty=1e-6)
        target = target_field.expand(cfg.horizon, mesh.n_nodes)
        act = gaussian_actuators(mesh, [0.25, 0.5, 0.75], width=0.1)
        states, _ = receding_horizon(
            mesh, 1.0, torch.zeros_like(x), act, target, mcfg,
            n_mpc_steps=10)
        free = torch.as_tensor(mesh.free_nodes(), device=mesh.device)
        err = float((states[-1][free] - target_field[free]).abs().max())
        result = {"scenario": cfg.name, "tracking_error": err}

    elif cfg.name == "topopt_2d":
        from .control import TopOptConfig, optimize
        tcfg = TopOptConfig(nx=cfg.n_elements, ny=cfg.n_elements,
                            n_iters=cfg.n_opt_steps)
        f = torch.ones(mesh.n_nodes, dtype=mesh.dtype, device=mesh.device)
        rho, hist = optimize(mesh, f, tcfg)
        result = {"scenario": cfg.name,
                  "compliance_initial": float(hist[0]),
                  "compliance_final": float(hist[-1]),
                  "volume": float(rho.mean())}

    else:
        # (batched) κ-recovery inverse problem
        k_true, loss_fn = _kappa_recovery(cfg, mesh)
        log_k = torch.zeros(cfg.batch, dtype=mesh.dtype, device=mesh.device,
                            requires_grad=True)
        opt = _adam([log_k], cfg.lr)
        for i in range(cfg.n_opt_steps):
            opt.zero_grad(set_to_none=True)
            loss = loss_fn(log_k)
            loss.backward()
            opt.step()
            if i % max(1, cfg.n_opt_steps // 5) == 0:
                metrics.log(i, loss=float(loss.detach()))
        err = float((log_k.detach().exp() - k_true).abs().max())
        result = {"scenario": cfg.name, "batch": cfg.batch,
                  "kappa_max_error": err, "final_loss": float(loss.detach())}

    log(json.dumps(result))
    return result


def _grad_step(loss_fn, lr=1e-3):
    """A data-chained step for ``timeit_chained``: x ↦ x − lr·∇loss(x), one
    forward and one adjoint solve."""
    def step(x):
        x = x.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(loss_fn(x), x)
        return (x - lr * g).detach()
    return step


def bench_scenario(cfg, device="cuda", log=print):
    """Throughput of one forward + adjoint step for the scenario's
    workload, timed by ``timeit_chained`` on the card."""
    from .utils.profiling import timeit_chained

    if cfg.dim == 2:
        # config-4 shape: batched per-triangle κ-field inversion on the
        # structured-grid stencil solver (fixed-iteration PCG, one
        # independent solve a scenario)
        from .ops.pcg import batched_dot
        from .ops.stencil import StructuredGrid, solve_poisson_structured
        dtype = _dtype(cfg)
        n, B = cfg.n_elements, cfg.batch
        grid = StructuredGrid.unit(n, n)
        xs = torch.linspace(0, 1, n + 1, dtype=dtype, device=device)
        X, Y = torch.meshgrid(xs, xs, indexing="xy")
        fB = (torch.sin(math.pi * X) * torch.sin(math.pi * Y)).expand(
            B, n + 1, n + 1)
        klB = 1.0 + _uniform((B, n, n), cfg.seed, dtype, device)
        g0 = torch.zeros((n + 1, n + 1), dtype=dtype, device=device)
        iters = cfg.extra.get("cg_iters", 128)
        dot = batched_dot(2)

        def solve(kl):
            return solve_poisson_structured(grid, (kl, kl), fB, g0, 0.0,
                                            iters, dot)

        with torch.no_grad():
            u_data = solve(klB)
        timing = timeit_chained(_grad_step(
            lambda kl: ((solve(kl) - u_data) ** 2).mean()), klB, length=10)
        result = {"scenario": cfg.name, "batch": B, "grid": f"{n}x{n}",
                  "cg_iters": iters,
                  "grad_solves_per_s": round(timing.throughput(B), 1),
                  "step_ms": round(timing.mean_ms, 3)}
        log(json.dumps(result))
        return result

    mesh = _mesh_for(cfg, device)
    _, loss_fn = _kappa_recovery(cfg, mesh)
    timing = timeit_chained(
        _grad_step(loss_fn),
        torch.zeros(cfg.batch, dtype=mesh.dtype, device=mesh.device),
        length=20)
    result = {"scenario": cfg.name, "batch": cfg.batch,
              "grad_solves_per_s": round(timing.throughput(cfg.batch), 1),
              "step_ms": round(timing.mean_ms, 3)}
    log(json.dumps(result))
    return result


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def invert_cmd(args):
    """Production κ-field inversion on the routed fast paths
    (``fit_kappa``).

    Synthesizes the probe workload (random per-element κ_true, sinusoidal
    forcing, converged u_data), runs ``fit_kappa`` with its default policy
    (once to build the kernels, then timed), and reports throughput, the
    converged eval loss and the κ error.
    """
    import numpy as np

    from .inverse import fit_kappa
    from .mesh import FEMesh
    from .solver import solve_poisson_batched

    dev = args.device
    n = args.elements if args.elements is not None \
        else {1: 30, 2: 64, 3: 16}[args.dim]
    B, steps = args.batch, args.steps
    f32 = torch.float32
    if args.dim == 1:
        mesh = FEMesh.line(n_elements=n, dtype=f32, device=dev)
    elif args.dim == 2:
        mesh = FEMesh.rectangle(nx=n, ny=n, dtype=f32, device=dev)
    else:
        mesh = FEMesh.box(nx=n, ny=n, nz=n, dtype=f32, device=dev)
    if args.unstructured:
        # arbitrary connectivity: interior nodes randomly perturbed, so
        # fit_kappa routes to the edge-ELL path at B >= 128; grid=None is
        # required, since a kept grid would route to the stencil solvers
        # and ignore the moved nodes
        if args.dim != 2:
            raise SystemExit("--unstructured supports --dim 2")
        nodes = mesh.nodes.cpu().numpy().copy()
        rng = np.random.RandomState(args.seed)
        interior = mesh.bc_mask.cpu().numpy() < 0.5
        h = 1.0 / n
        nodes[interior] += rng.uniform(-0.3 * h, 0.3 * h,
                                       nodes[interior].shape)
        mesh = dataclasses.replace(mesh, nodes=torch.as_tensor(
            nodes, dtype=mesh.dtype, device=mesh.device), grid=None)
    f = (args.dim * math.pi ** 2) * torch.sin(math.pi * mesh.nodes).prod(1)
    fB = f.expand(B, mesh.n_nodes)
    k_true = 1.2 + 0.6 * _uniform((B, mesh.n_elements), args.seed, f32, dev)
    with torch.no_grad():
        if args.dim == 1:
            # exact band solve: the 1D observation generator
            u_data = solve_poisson_batched(mesh, k_true, fB,
                                           method="tridiag")
        else:
            u_data = solve_poisson_batched(mesh, k_true, fB, cg_tol=0.0,
                                           cg_maxiter=300)
    kw = dict(steps=steps, lr=args.lr, iters=args.iters, eval_final=True)
    fit_kappa(mesh, fB, u_data, **kw)                  # builds the kernels
    _sync(dev)
    t0 = time.perf_counter()
    kappa, info = fit_kappa(mesh, fB, u_data, **kw)
    _sync(dev)
    dt = time.perf_counter() - t0
    kerr = float((kappa - k_true).abs().max() / k_true.max())
    print(json.dumps({
        "dim": args.dim, "elements": n, "batch": B, "steps": steps,
        "path": info["path"], "iters": info["iters"], "warm": info["warm"],
        "grad_solves_per_s": round(B * steps / dt, 1),
        "final_loop_loss": float(info["loss_history"][-1]),
        "eval_loss": info["eval_loss"],
        "kappa_rel_err": kerr,
    }))
    return 0


def export_cmd(args):
    """Build an AOT solver artifact for a mesh/batch and write it to disk."""
    from .mesh import FEMesh
    from .utils.export import export_batched_solver, export_gradient_step

    mesh = FEMesh.line(n_elements=args.elements, device=args.device) \
        if args.dim == 1 else FEMesh.rectangle(nx=args.elements,
                                               ny=args.elements,
                                               device=args.device)
    build = export_gradient_step if args.grad else export_batched_solver
    # a line on the card carries K2, as control/heat.py's "auto" does; the
    # solver's "auto" is the plain sweeps, which the CPU keeps
    method = ("tridiag_pallas" if args.dim == 1
              and mesh.device.type == "cuda" else "auto")
    blob = build(mesh, batch=args.batch, method=method)
    with open(args.out, "wb") as fh:
        fh.write(blob)
    print(json.dumps({"artifact": args.out, "bytes": len(blob),
                      "dim": args.dim, "elements": args.elements,
                      "batch": args.batch, "grad": bool(args.grad)}))
    return 0


def request_args(req: dict, specs) -> tuple:
    """A request's arrays as the artifact's inputs: κ and f, and u_data for
    a gradient artifact, cast to the dtypes and device it was traced with
    (``load_exported_with_avals``)."""
    keys = ("kappa", "f", "u_data") if "u_data" in req else ("kappa", "f")
    return tuple(torch.as_tensor(req[k], dtype=s.dtype, device=s.device)
                 for k, s in zip(keys, specs))


def reply(out) -> dict:
    """The response to one request: {"u": …} or {"loss": …, "grad": …}."""
    if isinstance(out, (tuple, list)):
        loss, grad = out
        return {"loss": float(loss), "grad": grad.tolist()}
    return {"u": out.tolist()}


def serve_cmd(args):
    """Serve an exported artifact: JSON lines on stdin → JSON lines on stdout.

    Request:  {"kappa": [...B], "f": [[...n]...B]}   (and "u_data" for grad
    artifacts).  Response: {"u": [[...]]} or {"loss": .., "grad": [...]}.
    """
    from .utils.export import load_exported_with_avals

    with open(args.artifact, "rb") as fh:
        fn, specs = load_exported_with_avals(fh.read(), args.device)
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        try:
            with torch.no_grad():
                out = fn(*request_args(json.loads(line), specs))
            print(json.dumps(reply(out)), flush=True)
        except Exception as e:  # malformed request: report, keep serving
            print(json.dumps({"error": f"{type(e).__name__}: {e}"}),
                  flush=True)
    return 0


def main(argv=None):
    from .utils.config import BASELINE_CONFIGS

    parser = argparse.ArgumentParser(prog="difffe_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    sub.add_parser("list", help="list scenarios")
    for cmd in ("run", "bench"):
        p = sub.add_parser(cmd)
        p.add_argument("scenario", choices=sorted(BASELINE_CONFIGS))
        p.add_argument("--batch", type=int)
        p.add_argument("--steps", type=int)
        p.add_argument("--method")
        p.add_argument("--device", default="cuda",
                       help="torch device (default: the CUDA card)")
    pi_ = sub.add_parser("invert", help="κ-field inversion on the routed "
                                        "fast paths (fit_kappa)")
    pi_.add_argument("--dim", type=int, default=2, choices=[1, 2, 3])
    pi_.add_argument("--elements", type=int, default=None,
                     help="per side (default: 30 for 1D, 64 for 2D, "
                          "16 for 3D)")
    pi_.add_argument("--batch", type=int, default=256)
    pi_.add_argument("--steps", type=int, default=100)
    pi_.add_argument("--lr", type=float, default=None)
    pi_.add_argument("--iters", type=int, default=None)
    pi_.add_argument("--seed", type=int, default=0)
    pi_.add_argument("--unstructured", action="store_true",
                     help="perturb interior nodes (irregular "
                          "triangulation): routes to the edge-ELL "
                          "inversion at B>=128")
    pi_.add_argument("--device", default="cuda",
                     help="torch device (default: the CUDA card)")
    pe = sub.add_parser("export", help="build an AOT solver artifact")
    pe.add_argument("out")
    pe.add_argument("--dim", type=int, default=1, choices=[1, 2])
    pe.add_argument("--elements", type=int, default=64)
    pe.add_argument("--batch", type=int, default=256)
    pe.add_argument("--grad", action="store_true",
                    help="export the fwd+adjoint gradient step")
    pe.add_argument("--device", default="cuda",
                    help="torch device (default: the CUDA card)")
    ps = sub.add_parser("serve", help="serve an artifact over stdin/stdout")
    ps.add_argument("artifact")
    ps.add_argument("--device", default="cuda",
                    help="torch device (default: the CUDA card)")
    args = parser.parse_args(argv)

    if args.cmd == "list":
        for name, cfg in BASELINE_CONFIGS.items():
            print(f"{name:24s} {cfg.to_json()}")
        return 0
    if args.cmd == "invert":
        return invert_cmd(args)
    if args.cmd == "export":
        return export_cmd(args)
    if args.cmd == "serve":
        return serve_cmd(args)

    cfg = BASELINE_CONFIGS[args.scenario]
    overrides = {}
    if args.batch:
        overrides["batch"] = args.batch
    if args.steps:
        overrides["n_opt_steps"] = args.steps
    if args.method:
        overrides["method"] = args.method
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)

    if args.cmd == "run":
        run_scenario(cfg, args.device)
    else:
        bench_scenario(cfg, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
