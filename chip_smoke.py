#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``difffe_tpu_torch``) on one CUDA card.

Drives the port's four paths through their public entry points, in phases;
any failure raises, so the run exits non-zero and never prints the final
``ok`` line:

1. versions, the card's name and power limit (refuses to run without a
   card);
2. build the CUDA kernels from ``difffe_tpu_torch/csrc/``;

The 1D path (per-element κ on a line mesh, bench.py's workload: n = 30
elements, B = 2^21 scenarios, one shared forcing), kernel K1:

3. each K1 variant (step/chain × shared/f32/bf16 u_data) against its plain
   PyTorch version, n ∈ {10, 30, 128}, B ∈ {1000, 2^21};
4. ``fit_kappa`` through the public entry point, 128 steps = 4 chain
   launches, with loss checks;
5. bench.py's parity gate: the step kernel's gradient against autograd
   through the PCR tridiagonal oracle on the bf16-quantized plane;
6. chained timing of the chain and step kernels and their plain versions,
   with the streamed bf16 u_data plane (K1d, K1b) and with shared u_data
   (K1c, K1a).

The 2D path (κ-field inversion on ``FEMesh.rectangle(64, 64)``, the
structured-grid config of BASELINE.json, B = 4096 scenarios), kernels K3a
(whole-CG solve) and K3b (forward + MSE cotangent + adjoint CG):

7. K3a and K3b against their plain versions on the card at 8² (B = 7),
   64² (B = 4096) and 256² (B = 64), cold and warm, zero and nonzero
   Dirichlet values.  f32 CG amplifies summation-order differences, so the
   kernel is held against the plain version run in f64 on the card: its
   relative max error on x, λ and the κ gradient may be at most twice the
   f32 plain version's error against the same f64 run, plus 1e-6;
8. the main path: u_data from the fixed-trip batched solve (K3a),
   ``fit_kappa`` for 100 steps at lr = 300 (one K3b launch each; the
   converged misfit must fall below half the first step's), and the κ
   gradient of Σu² through the fixed-trip batched solve (K3a forward and
   adjoint) held against the plain version by the rule of phase 7;
9. chained timing of K3b and K3a against their plain versions, host time of
   ``fit_kappa`` and a ``torch.profiler`` split of one call.

The 3D path (κ-field inversion on ``FEMesh.box(32, 32, 32)``, B = 128
scenarios, the README's 32³ configuration at the κ-safe 100 iterations),
kernels K4a (whole-CG solve) and K4b (forward + MSE cotangent + adjoint CG):

10. K4a and K4b against their plain versions on the card at (nx, ny, nz) =
    (4, 4, 4) B = 5, (12, 9, 6) B = 7, 16³ B = 256 (CG vectors in shared
    memory) and 32³ B = 128 (global workspace), cold and warm, zero and
    nonzero Dirichlet values, and at 16³ with bf16 coefficient storage, by
    the rule of phase 7;
11. the main path: u_data from the fixed-trip batched solve (one K4a
    launch), ``fit_kappa`` with its default policy (100 steps of one K4b
    launch, 100 cold iterations each, then one K4a eval launch) at
    lr = 1e7 (the converged misfit must fall below the first step's), and
    the κ gradient of Σu²
    through the fixed-trip batched solve (K4a forward and adjoint) held by
    the rule of phase 7;
12. chained timing of K4b and K4a against their plain versions, host time
    of ``fit_kappa`` (at its default lr, whose misfit it logs) with and
    without its eval solve, and a ``torch.profiler`` split of one call.

The 1D facade path (BASELINE.json config 2: per-element κ recovery on
``FEMesh.line(128)``, 1024 κ/forcing scenarios, adjoint gradients), kernel
K2 (batched PCR tridiagonal solve, ``method="tridiag_pallas"``):

13. K2 against its plain version (the PCR oracle) on the card, n ∈ {1, 2,
    31, 129, 257, 4097}, B ∈ {1, 7, 1024, 65 536} (65 536 for n ≤ 257),
    f32 and f64, random diagonally dominant and Dirichlet-eliminated FEM
    bands, batched and shared bands, u and the three band gradients: f64
    within 1e-10 relative (at n = 4097 on FEM bands also a normwise
    backward error ≤ 1e-11), f32 by the rule of phase 7; every layout
    equal to 'auto' bit for bit;
14. the main path: u_data from ``solve_poisson_batched(method=
    "tridiag_pallas")``, ``recover_kappa_field`` for 200 Adam steps
    (1 + 2 × 200 K2 launches; the misfit must fall 1e3×); then, in f64,
    ``recover_kappa_scalar`` (κ error < 1e-6), the three stages of
    examples/poisson_1d_demo.py (FEM error ≤ 1e-13, ``NeuralPDE`` within
    5% after 3000 epochs, κ = 2 within 1e-4) and
    ``DifferentiableFESolver(method="tridiag_pallas")`` against
    ``method="dense"`` (≤ 1e-10);
15. the κ gradient of the batched MSE through K2 forward and adjoint
    against the 'tridiag' route (f32 by the rule of phase 7, f64 ≤ 1e-10);
16. chained timing of K2 (forward, and forward + backward) at n = 129,
    B = 65 536 against the plain version and ``torch.linalg.solve`` on the
    densified systems (B = 8192, scaled), host time of
    ``recover_kappa_field`` at B = 1024 and 65 536, and a
    ``torch.profiler`` split of one call.

Each path's launch counts are set to 0 just before its main-path phases
(4-5, 8, 11, 14) and read just after; comparisons and timing do not
count.  The
third-to-last line is one JSON object describing each kernel, with its
bound: the larger of the bytes it must move over 3.35 TB/s and its
operations over 67 TFLOP/s (H100 SXM, fp32 outside the tensor cores).  The
second-to-last line is the card's name and power limit; the last line is
the ``ok`` JSON.

Run: ``python3 chip_smoke.py`` from the repository root.
"""

import json
import math
import subprocess
import sys
import time
from pathlib import Path

N_ELEMENTS = 30
BATCH = 2 ** 21
CHAIN_K = 32
STEPS = 128
LR = 30.0
BLOCK_LANES = 2048
STEP_TOL = 1e-5          # kernel vs plain, f32, single step
CHAIN_TOL = 1e-4         # kernel vs plain, f32, 32-step chain
GATE_TOL = 1e-4          # bench.py's gradient-parity gate
CU_SOURCE = "difffe_tpu_torch/csrc/fused_grad_cf.cu"
JAX_KERNEL = "difffe_tpu/ops/pallas/fused_grad_cf_kernel.py"

N_2D = 64                # config 4's grid, 64 × 64 quads
BATCH_2D = 4096
STEPS_2D = 100
K3A_ITERS = 256          # the u_data solve and K3a's timed workload
K3B_ITERS = 32           # fit_kappa's per-step iterations at 64²
GRAD_ITERS = 128         # the fixed-trip solve the κ gradient runs through
# fit_kappa's 2D default lr (30) lowers the 64² misfit only ~10% in 100
# steps, in the JAX reference as in the port (CPU runs at B = 2); ten times
# that halves it within the run, which the phase 8 gate asks
LR_2D = 300.0
K3_CASES = ((8, 7), (N_2D, BATCH_2D), (256, 64))   # phase 7: (n, B)
K3_SOURCE = "difffe_tpu_torch/csrc/stencil_cg.cu"
JAX_K3 = "difffe_tpu/ops/pallas/stencil_cg_kernel.py"

PEAK_FLOPS = 67e12       # H100 SXM fp32 outside the tensor cores
PEAK_BYTES = 3.35e12     # H100 SXM HBM3
# K1 operations per element row per SGD step, counted from the three
# passes of cf_kernel in csrc/fused_grad_cf.cu (a division counts as one):
# 5 (S, T totals) + 21 (u, d, loss, P^λ, running sums) + 10 (gradient and
# the update)
K1_OPS_PER_ROW_STEP = 36
# K3 operations per node per CG iteration (stencil_cg_kernel.py:210):
# 5-point apply 9, two dots 4, x/r/p updates 6, Jacobi 1
K3_OPS_PER_NODE_ITER = 20

N_3D = 32                # the README's 32³ box
BATCH_3D = 128
STEPS_3D = 100           # fit_kappa's default
K4B_ITERS = 100          # fit_kappa's κ-safe default above 16 a side
K4A_ITERS = 400          # the u_data solve and K4a's timed workload
# fit_kappa's 3D default lr (100·B/256 = 50 here) hardly moves the 32³
# misfit in 100 steps (phase 12 logs it), so the gate that the misfit
# falls needs a larger step; 1e7 stays well inside κ_true's range
LR_3D = 1e7
# phase 10: (nx, ny, nz, B); the non-cubic grids catch a transposed axis
K4_CASES = ((4, 4, 4, 5), (12, 9, 6, 7), (16, 16, 16, 256),
            (N_3D, N_3D, N_3D, BATCH_3D))
K4_SOURCE = "difffe_tpu_torch/csrc/stencil3d_cg.cu"
JAX_K4 = "difffe_tpu/ops/pallas/stencil3d_cg_kernel.py"
# K4 operations per node per CG iteration (stencil3d_cg_kernel.py:159):
# 7-point apply 13, two dots 4, x/r/p updates 6, Jacobi 1
K4_OPS_PER_NODE_ITER = 24

N_1D = 128               # BASELINE.json config 2: 128 elements, 129 nodes
BATCH_1D = 1024          # its 1024 κ/forcing scenarios
STEPS_1D = 200           # Adam steps of recover_kappa_field
LR_1D = 0.05
K2_NS = (1, 2, 31, 129, 257, 4097)      # phase 13: system sizes
K2_BS = (1, 7, 1024, 65536)             # 65 536 only for n <= 257
BATCH_K2 = 65536         # phase 16: scripts/probe_tridiag.py's batch at n=129
BATCH_LIB = 8192         # torch.linalg.solve on the densified systems
K2_SOURCE = "difffe_tpu_torch/csrc/tridiag_pcr.cu"
JAX_K2 = "difffe_tpu/ops/pallas/tridiag_kernel.py"
# K2 operations per row and PCR sweep, counted from csrc/tridiag_pcr.cu:
# alpha, gamma (a negation and a division each) 4, a', c' 2, b', r' 8; one
# division per row after the last sweep
K2_OPS_PER_ROW_SWEEP = 14


def log(*args):
    print(*args, flush=True)


def rel_err(a, b):
    if a.numel() == 0 and b.numel() == 0:
        return 0.0
    return float((a - b).abs().max() / b.abs().max())


def bound(ops, nbytes):
    """(bound_ms, bound_by) of a function doing ``ops`` operations that
    must move ``nbytes`` bytes."""
    t_ops, t_bytes = ops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def kernel_entry(name, source, replaces, launches, max_abs, ms, plain_ms,
                 ops, nbytes, library_ms=None):
    b_ms, b_by = bound(ops, nbytes)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms}


def timed_pair(kernel_fn, plain_fn, x0, length):
    """Best chained ms per call of each, timed plain, kernel, kernel,
    plain."""
    from difffe_tpu_torch.utils.profiling import timeit_chained

    best = {"kernel": float("inf"), "plain": float("inf")}
    for which in ("plain", "kernel", "kernel", "plain"):
        fn = kernel_fn if which == "kernel" else plain_fn
        t = timeit_chained(fn, x0, length=length, repeats=2)
        best[which] = min(best[which], t.min_s * 1e3)
    return best


def run_1d(torch, dev, card):
    """Phases 3-6; returns the K1 entries of the kernels line."""
    from difffe_tpu_torch import fit_kappa
    from difffe_tpu_torch.mesh import FEMesh
    from difffe_tpu_torch.ops.assembly import assemble_load
    from difffe_tpu_torch.ops.cf1d import solve_poisson_cf_batched
    from difffe_tpu_torch.ops.kernels import fused_grad_cf_kernel as tk
    from difffe_tpu_torch.solver import solve_poisson_batched

    def problem(n, B, seed):
        mesh = FEMesh.line(n, dtype=torch.float32, device=dev)
        g = torch.Generator(device=dev).manual_seed(seed)
        fv = torch.sin(torch.pi * mesh.nodes[:, 0]) + 1.0
        ke_true = 1.0 + 2.0 * torch.rand(B, n, generator=g, device=dev)
        with torch.no_grad():
            ud = solve_poisson_batched(mesh, ke_true, fv.expand(B, n + 1),
                                       method="tridiag")
        return mesh, fv, ud, g

    # -- phase 3: every K1 variant against its plain version
    t0 = time.perf_counter()
    max_abs = {"step": 0.0, "chain": 0.0}
    for n in (10, 30, 128):
        for B in (1000, BATCH):
            mesh, fv, ud, g = problem(n, B, seed=n + B)
            F = assemble_load(mesh, fv)
            ke0 = 1.0 + 0.3 * torch.rand(B, n, generator=g, device=dev)
            scale = 2.0 / (n + 1)
            for mode in ("shared", "f32", "bf16"):
                keT, aux = tk.cf_packed_operands(
                    mesh, ke0, F, ud[0] if mode == "shared" else ud,
                    operand_dtype=torch.bfloat16 if mode == "bf16" else None)
                args = (aux["udT"], aux["cols"], B, scale, aux["u_l"],
                        aux["u_r"])
                lp_k, g_k = tk.kappa_mse_step_cf_packed(keT, aux, scale)
                lp_p, g_p = tk._cf_step_plain(keT, *args)
                lc_k, k_k = tk.kappa_sgd_chain_cf(keT, aux, CHAIN_K, LR,
                                                  scale)
                lc_p, k_p = tk._cf_chain_plain(keT, *args, CHAIN_K, LR)
                torch.cuda.synchronize()
                errs = {
                    "step_grad": rel_err(g_k[:, :B], g_p[:, :B]),
                    "step_loss": rel_err(lp_k[:, :B], lp_p[:, :B]),
                    "chain_kappa": rel_err(k_k[:, :B], k_p[:, :B]),
                    "chain_loss": rel_err(lc_k[:, :B], lc_p[:, :B]),
                }
                log(f"phase 3 n={n} B={B} ud={mode}: " + " ".join(
                    f"{k}={v:.2e}" for k, v in errs.items()))
                if max(errs["step_grad"], errs["step_loss"]) > STEP_TOL:
                    raise AssertionError(f"step kernel disagrees: {errs}")
                if max(errs["chain_kappa"], errs["chain_loss"]) > CHAIN_TOL:
                    raise AssertionError(f"chain kernel disagrees: {errs}")
                if not (torch.all(g_k[:, B:] == 0)
                        and torch.equal(k_k[:, B:], keT[:, B:])):
                    raise AssertionError("padded lanes were written")
                max_abs["step"] = max(max_abs["step"], float(
                    (g_k[:, :B] - g_p[:, :B]).abs().max()))
                max_abs["chain"] = max(max_abs["chain"], float(
                    (k_k[:, :B] - k_p[:, :B]).abs().max()))
            del mesh, ud, ke0, keT, aux, lp_k, g_k, lp_p, g_p, lc_k, k_k
            del lc_p, k_p, args
            torch.cuda.empty_cache()
    log(f"phase 3 kernel vs plain: {time.perf_counter() - t0:.1f} s")

    # -- phases 4-5: the main path, with launch counts
    mesh, fv, u_data, _ = problem(N_ELEMENTS, BATCH, seed=0)
    n = mesh.n_nodes
    f = fv.expand(BATCH, n)
    loss_start = float(((solve_poisson_cf_batched(
        mesh, torch.ones(BATCH, N_ELEMENTS, device=dev), f) - u_data) ** 2
    ).mean())
    for k in tk.launches:
        tk.launches[k] = 0
    t0 = time.perf_counter()
    kappa, info = fit_kappa(mesh, f, u_data, steps=STEPS)
    torch.cuda.synchronize()
    hist = [float(v) for v in info["loss_history"]]
    log(f"phase 4 fit_kappa: path={info['path']} "
        f"launches={tk.launches['chain']} loss(kappa=1)={loss_start:.6e} "
        f"loss_history={hist} eval_loss={info['eval_loss']:.6e} "
        f"drop={loss_start / info['eval_loss']:.2f}x "
        f"({time.perf_counter() - t0:.2f} s)")
    if info["path"] != "cf_chain_kernel":
        raise AssertionError(f"fit_kappa took path {info['path']}")
    if tk.launches["chain"] != STEPS // CHAIN_K:
        raise AssertionError(f"chain launches {tk.launches['chain']}")
    if not bool(torch.isfinite(kappa).all()):
        raise AssertionError("fit_kappa returned non-finite kappa")
    if kappa.shape != (BATCH, N_ELEMENTS):
        raise AssertionError(f"kappa shape {tuple(kappa.shape)}")
    if not info["eval_loss"] * 10 <= loss_start:
        raise AssertionError("eval_loss is not 10x below the start loss")
    if not all(b < a for a, b in zip(hist, hist[1:])):
        raise AssertionError("loss_history does not fall at every launch")
    if not hist[0] >= 3 * hist[-1]:
        raise AssertionError("loss_history fell less than 3x")
    del kappa, info
    torch.cuda.empty_cache()

    # phase 5: bench.py's parity gate on the bf16 observation plane
    ke0 = torch.ones(BATCH, N_ELEMENTS, device=dev)
    keT0, aux = tk.cf_packed_operands(mesh, ke0, assemble_load(mesh, fv),
                                      u_data, block_lanes=BLOCK_LANES,
                                      operand_dtype=torch.bfloat16)
    scale = 2.0 / n
    _, gT = tk.kappa_mse_step_cf_packed(keT0, aux, scale=scale)
    ud_q = aux["udT"][:n, :BATCH].T.float()
    ke = ke0.clone().requires_grad_()
    u = solve_poisson_batched(mesh, ke, f, method="tridiag")
    ((u - ud_q) ** 2).mean(dim=-1).sum().backward()
    gate = rel_err(tk.cf_unpack(gT, aux), ke.grad)
    log(f"phase 5 parity gate: rel={gate:.3e} (limit {GATE_TOL})")
    if not gate < GATE_TOL:
        raise AssertionError(f"bench parity gate failed: {gate:.3e}")
    main_path = dict(tk.launches)
    log(f"1D main-path launches: {main_path}")
    for k, v in main_path.items():
        if v < 1:
            raise AssertionError(f"kernel {k} was not launched by the path")
    del u, ke, ud_q, gT
    torch.cuda.empty_cache()

    # -- phase 6: chained timing at the bench workload
    udT, cols, B, u_l, u_r = (aux["udT"], aux["cols"], aux["B"], aux["u_l"],
                              aux["u_r"])
    _, aux_s = tk.cf_packed_operands(mesh, ke0, assemble_load(mesh, fv),
                                     u_data[0], block_lanes=BLOCK_LANES)
    cols_s = aux_s["cols"]
    runs = {
        "chain": (lambda k: tk.kappa_sgd_chain_cf(k, aux, CHAIN_K, LR,
                                                  scale)[1],
                  lambda k: tk._cf_chain_plain(k, udT, cols, B, scale, u_l,
                                               u_r, CHAIN_K, LR)[1]),
        "step": (lambda k: k - LR * tk.kappa_mse_step_cf_packed(
                     k, aux, scale)[1],
                 lambda k: k - LR * tk._cf_step_plain(
                     k, udT, cols, B, scale, u_l, u_r)[1]),
        "chain_shared": (
            lambda k: tk.kappa_sgd_chain_cf(k, aux_s, CHAIN_K, LR,
                                            scale)[1],
            lambda k: tk._cf_chain_plain(k, None, cols_s, B, scale, u_l,
                                         u_r, CHAIN_K, LR)[1]),
        "step_shared": (
            lambda k: k - LR * tk.kappa_mse_step_cf_packed(
                k, aux_s, scale)[1],
            lambda k: k - LR * tk._cf_step_plain(
                k, None, cols_s, B, scale, u_l, u_r)[1]),
    }
    ms = {}
    for name, (kernel_fn, plain_fn) in runs.items():
        ms[name] = best = timed_pair(kernel_fn, plain_fn, keT0,
                                     STEPS // CHAIN_K)
        steps = CHAIN_K if name.startswith("chain") else 1
        log(f"phase 6 {name}: kernel {best['kernel']:.4f} ms/launch, plain "
            f"{best['plain']:.4f} ms/launch, {steps} SGD step(s)/launch; "
            f"kernel {BATCH * steps / best['kernel'] * 1e3:.6e} "
            f"grad-solves/s, plain "
            f"{BATCH * steps / best['plain'] * 1e3:.6e} grad-solves/s "
            f"[{card}]")
    # with shared u_data only κ moves (κ in, κ′ out, the 4 B loss row)
    for name in ("chain_shared", "step_shared"):
        steps = CHAIN_K if name.startswith("chain") else 1
        b_ms, b_by = bound(K1_OPS_PER_ROW_STEP * n * BATCH * steps,
                           BATCH * (2 * N_ELEMENTS * 4 + 4))
        log(f"phase 6 {name}: bound {b_ms:.4f} ms ({b_by}) [{card}]")

    # Both timed functions map κ to κ′ and must read κ (f32) and the bf16
    # u_data plane once and write κ′ once (the loss row: 4 B a scenario).
    nbytes = BATCH * (2 * N_ELEMENTS * 4 + n * udT.element_size() + 4)
    return [
        kernel_entry("cf_chain", CU_SOURCE, f"{JAX_KERNEL}:445",
                     main_path["chain"], max_abs["chain"],
                     ms["chain"]["kernel"], ms["chain"]["plain"],
                     K1_OPS_PER_ROW_STEP * n * BATCH * CHAIN_K, nbytes),
        kernel_entry("cf_step", CU_SOURCE, f"{JAX_KERNEL}:132",
                     main_path["step"], max_abs["step"],
                     ms["step"]["kernel"], ms["step"]["plain"],
                     K1_OPS_PER_ROW_STEP * n * BATCH, nbytes),
    ]


def check_rule(name, kernel, plain32, plain64, what):
    """The tolerance rule of phase 7: the kernel's relative max error
    against the f64 plain run may be at most twice the f32 plain run's,
    plus 1e-6.  Returns both errors."""
    import torch

    if not bool(torch.isfinite(kernel).all()):
        raise AssertionError(f"{what}: {name} is not finite")
    ek, ep = rel_err(kernel, plain64), rel_err(plain32, plain64)
    if not ek <= 2.0 * ep + 1e-6:
        raise AssertionError(f"{what}: {name} error {ek:.3e} exceeds "
                             f"2 x {ep:.3e} + 1e-6")
    return ek, ep


def profile_split(torch, fn, label, card, what="fit_kappa"):
    """Device time by kernel name of one call of ``fn`` under
    torch.profiler; logs the busy time, the window and the top rows."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    # a user annotation (torch.optim's "Optimizer.step#Adam.step") also
    # shows as a device range over the kernels it spans: count kernels only
    spans = {e.name for e in prof.events()
             if getattr(e, "is_user_annotation", False)}
    rows = [(e.key, e.count, e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.key not in spans]
    rows.sort(key=lambda r: -r[2])
    busy = sum(r[2] for r in rows)
    log(f"{label} profile of one {what} call: {busy:.1f} ms of device "
        f"time in a {window * 1e3:.1f} ms window, device idle "
        f"{100 * max(0.0, 1 - busy / (window * 1e3)):.1f}% [{card}]")
    for key, count, t in rows[:12]:
        log(f"  {t:9.2f} ms {100 * t / busy:5.1f}% x{count:<5d} {key[:90]}")


def run_2d(torch, dev, card):
    """Phases 7-9; returns the K3 entries of the kernels line."""
    from difffe_tpu_torch import fit_kappa
    from difffe_tpu_torch.mesh import FEMesh
    from difffe_tpu_torch.ops.kernels import stencil_cg_kernel as sk
    from difffe_tpu_torch.ops.stencil import (StructuredGrid,
                                              kappa_lu_from_elements,
                                              residual_vjp_manual)
    from difffe_tpu_torch.solver import solve_poisson_batched

    f64 = torch.float64
    max_abs = {"cg": 0.0, "cg2": 0.0}

    def problem(n, B, g_nonzero, seed):
        grid = StructuredGrid.unit(n, n)
        gen = torch.Generator(device=dev).manual_seed(seed)
        opts = dict(dtype=f64, device=dev)
        kl = 1.2 + 0.6 * torch.rand(B, n, n, generator=gen, **opts)
        ku = 1.2 + 0.6 * torch.rand(B, n, n, generator=gen, **opts)
        xs = torch.linspace(0.0, 1.0, n + 1, **opts)
        Y, X = torch.meshgrid(xs, xs, indexing="ij")
        bump = torch.sin(math.pi * X) * torch.sin(math.pi * Y)
        f = 10.0 * bump * (1.0 + 0.2 * torch.rand(B, 1, 1, generator=gen,
                                                  **opts))
        g = 0.3 * X + 0.1 * Y if g_nonzero else torch.zeros_like(X)
        ud = 0.05 * bump * (1.0 + torch.rand(B, 1, 1, generator=gen,
                                             **opts))
        return grid, (kl, ku, f, g, ud)

    def k3b_steps(grid, arrays, dtype, cg2, steps=4):
        """A cold SGD step, then warm ones, each through ``cg2``."""
        kl, ku, f, g, ud = (a.to(dtype).contiguous() for a in arrays)
        H, W = grid.node_shape
        out, state = [], None
        for _ in range(steps):
            C, D, b, Minv, x0, _ = sk._prepare(grid, (kl, ku), f, g)
            x0, lam0 = state if state else (x0, torch.zeros_like(b))
            x, lam = cg2(D, b, Minv, x0, lam0, ud, 2.0 / (H * W), K3B_ITERS)
            (gl, gu), _, _ = residual_vjp_manual(grid, (kl, ku), f, g, x,
                                                 lam, C=C)
            out.append({"x": x, "lam": lam, "grad": torch.stack([gl, gu])})
            state = (x, lam)
            kl, ku = kl - LR * gl, ku - LR * gu
        return out

    # -- phase 7: K3a and K3b against their plain versions
    t0 = time.perf_counter()
    for n, B in K3_CASES:
        for g_nonzero in (False, True):
            grid, arrays = problem(n, B, g_nonzero, seed=n + B + g_nonzero)
            runs = [k3b_steps(grid, arrays, dt, cg2) for dt, cg2 in (
                (torch.float32, sk._cg2), (torch.float32, sk._cg2_plain),
                (f64, sk._cg2_plain))]
            worst = {}
            for step, (k, p, q) in enumerate(zip(*runs)):
                for key in ("x", "lam", "grad"):
                    ek, ep = check_rule("K3b", k[key], p[key], q[key],
                                   f"n={n} B={B} step {step} {key}")
                    worst[key] = max(worst.get(key, (0, 0)), (ek, ep))
                    max_abs["cg2"] = max(max_abs["cg2"], float(
                        (k[key] - q[key]).abs().max()))
            log(f"phase 7 K3b n={n} B={B} g={'nonzero' if g_nonzero else 0}"
                f" cold+3 warm: worst (kernel, f32 plain) rel err vs f64: "
                + " ".join(f"{k}=({a:.2e}, {b:.2e})"
                           for k, (a, b) in worst.items()))
            del runs
            sols = {}
            for name, dt, cg in (("kernel", torch.float32, sk._cg),
                                 ("f32", torch.float32, sk._cg_plain),
                                 ("f64", f64, sk._cg_plain)):
                kl, ku, f, g, ud = (a.to(dt).contiguous() for a in arrays)
                _, D, b, Minv, x0, _ = sk._prepare(grid, (kl, ku), f, g)
                sols[name] = (cg(D, b, Minv, x0, K3A_ITERS),
                              cg(D, ud, Minv, torch.zeros_like(ud),
                                 K3A_ITERS))
            errs = [check_rule("K3a", sols["kernel"][i], sols["f32"][i],
                          sols["f64"][i], f"n={n} B={B} solve {i}")
                    for i in range(2)]
            for i in range(2):
                max_abs["cg"] = max(max_abs["cg"], float(
                    (sols["kernel"][i] - sols["f64"][i]).abs().max()))
            log(f"phase 7 K3a n={n} B={B} g={'nonzero' if g_nonzero else 0}"
                f" {K3A_ITERS} iters: (kernel, f32 plain) rel err vs f64: "
                f"solve {errs[0][0]:.2e}, {errs[0][1]:.2e}; adjoint-style "
                f"{errs[1][0]:.2e}, {errs[1][1]:.2e}")
            del sols, arrays
            torch.cuda.empty_cache()
    log(f"phase 7 kernel vs plain: {time.perf_counter() - t0:.1f} s")

    # -- phase 8: the 2D main path, with launch counts
    mesh = FEMesh.rectangle(N_2D, N_2D, dtype=torch.float32)
    if mesh.device.type != dev.type:
        raise AssertionError(f"the mesh factory put the mesh on "
                             f"{mesh.device}")
    grid, ne, nn = mesh.grid, mesh.n_elements, mesh.n_nodes
    H, W = grid.node_shape
    gen = torch.Generator(device=dev).manual_seed(0)
    x, y = mesh.nodes.T
    f = (10.0 * torch.sin(math.pi * x) * torch.sin(math.pi * y)).expand(
        BATCH_2D, nn)
    k_true = 1.2 + 0.6 * torch.rand(BATCH_2D, ne, generator=gen, device=dev)
    for k in sk.launches:
        sk.launches[k] = 0
    t0 = time.perf_counter()
    with torch.no_grad():
        u_data = solve_poisson_batched(mesh, k_true, f, cg_tol=0.0,
                                       cg_maxiter=K3A_ITERS)
    kappa, info = fit_kappa(mesh, f, u_data, steps=STEPS_2D, lr=LR_2D)
    hist = info["loss_history"]
    ke = torch.ones(BATCH_2D, ne, device=dev, requires_grad=True)
    (solve_poisson_batched(mesh, ke, f, cg_tol=0.0, cg_maxiter=GRAD_ITERS)
     ** 2).sum().backward()
    torch.cuda.synchronize()
    main_path = dict(sk.launches)
    log(f"phase 8 fit_kappa: path={info['path']} iters={info['iters']} "
        f"warm={info['warm']} loss_history[0]={float(hist[0]):.6e} "
        f"loss_history[-1]={float(hist[-1]):.6e} "
        f"eval_loss={info['eval_loss']:.6e} "
        f"({time.perf_counter() - t0:.2f} s with u_data and the gradient)")
    log(f"2D main-path launches: {main_path}")
    if info["path"] != "stencil2d_fused":
        raise AssertionError(f"fit_kappa took path {info['path']}")
    if info["iters"] != K3B_ITERS or info["warm"] is not True:
        raise AssertionError(f"iteration policy {info['iters']}, "
                             f"warm={info['warm']}")
    if main_path["cg2"] != STEPS_2D:
        raise AssertionError(f"K3b launches {main_path['cg2']}")
    if main_path["cg"] < 1:
        raise AssertionError("K3a was not launched by the path")
    if kappa.shape != (BATCH_2D, ne) or not bool(
            torch.isfinite(kappa).all()):
        raise AssertionError("fit_kappa's kappa is not finite of shape "
                             f"{(BATCH_2D, ne)}")
    if not info["eval_loss"] < 0.5 * float(hist[0]):
        raise AssertionError("eval_loss is not below half the first loss")

    def grad_plain(dtype):
        kl, ku = kappa_lu_from_elements(
            grid, torch.ones(BATCH_2D, ne, dtype=dtype, device=dev))
        fg = f.to(dtype).reshape(BATCH_2D, H, W)
        g0 = mesh.bc_values.to(dtype).reshape(H, W)
        C, D, b, Minv, x0, _ = sk._prepare(grid, (kl, ku), fg, g0)
        u = sk._cg_plain(D, b, Minv, x0, GRAD_ITERS)
        lam = sk._cg_plain(D, 2.0 * u, Minv, torch.zeros_like(u),
                           GRAD_ITERS)
        (gl, gu), _, _ = residual_vjp_manual(grid, (kl, ku), fg, g0, u, lam,
                                             C=C)
        return torch.stack([gl, gu], dim=-1).reshape(BATCH_2D, ne)

    ek, ep = check_rule("K3a gradient", ke.grad, grad_plain(torch.float32),
                   grad_plain(f64), "phase 8 κ gradient")
    log(f"phase 8 κ gradient of Σu² through K3a (forward + adjoint, "
        f"{GRAD_ITERS} iters): rel err vs f64 plain {ek:.3e}, f32 plain "
        f"{ep:.3e}")
    del ke, kappa, info
    torch.cuda.empty_cache()

    # -- phase 9: timing at the main path's workload
    kl, ku = kappa_lu_from_elements(grid, k_true)
    fg = f.reshape(BATCH_2D, H, W)
    g0 = mesh.bc_values.reshape(H, W)
    ud = u_data.reshape(BATCH_2D, H, W).contiguous()
    _, D, b, Minv, x0, _ = sk._prepare(grid, (kl, ku), fg, g0)
    scale = 2.0 / (H * W)
    state0 = (x0, torch.zeros_like(b))
    ms = {
        "cg2": timed_pair(
            lambda s: sk._cg2(D, b, Minv, *s, ud, scale, K3B_ITERS),
            lambda s: sk._cg2_plain(D, b, Minv, *s, ud, scale, K3B_ITERS),
            state0, 3),
        "cg": timed_pair(
            lambda v: sk._cg(D, b, Minv, v, K3A_ITERS),
            lambda v: sk._cg_plain(D, b, Minv, v, K3A_ITERS), x0, 2),
    }
    for name, iters, solves in (("cg2", K3B_ITERS, 2), ("cg", K3A_ITERS, 1)):
        best = ms[name]
        log(f"phase 9 {name}: kernel {best['kernel']:.4f} ms/launch, plain "
            f"{best['plain']:.4f} ms/launch ({N_2D}², B={BATCH_2D}, "
            f"{solves} x {iters} iters; kernel "
            f"{BATCH_2D / best['kernel'] * 1e3:.6e} scenarios/s) [{card}]")

    def fit(**kw):
        return fit_kappa(mesh, f, u_data, steps=STEPS_2D, lr=LR_2D, **kw)

    fit()
    for eval_final in (True, False):
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fit(eval_final=eval_final)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        log(f"phase 9 fit_kappa host time, {STEPS_2D} steps, "
            f"eval_final={eval_final}: " + ", ".join(f"{t:.4f}" for t in
                                                    times)
            + f" s; {BATCH_2D * STEPS_2D / min(times):.6e} grad-solves/s "
            f"[{card}]")

    profile_split(torch, fit, "phase 9", card)

    n_nodes = BATCH_2D * H * W
    return [
        kernel_entry("stencil_cg", K3_SOURCE, f"{JAX_K3}:191",
                     main_path["cg"], max_abs["cg"], ms["cg"]["kernel"],
                     ms["cg"]["plain"],
                     K3_OPS_PER_NODE_ITER * n_nodes * K3A_ITERS,
                     9 * n_nodes * 4),
        kernel_entry("stencil_cg2", K3_SOURCE, f"{JAX_K3}:412",
                     main_path["cg2"], max_abs["cg2"], ms["cg2"]["kernel"],
                     ms["cg2"]["plain"],
                     K3_OPS_PER_NODE_ITER * n_nodes * K3B_ITERS * 2,
                     12 * n_nodes * 4),
    ]


def run_3d(torch, dev, card):
    """Phases 10-12; returns the K4 entries of the kernels line."""
    from difffe_tpu_torch import fit_kappa
    from difffe_tpu_torch.mesh import FEMesh
    from difffe_tpu_torch.ops.kernels import stencil3d_cg_kernel as tk
    from difffe_tpu_torch.ops.stencil3d import (StructuredGrid3,
                                                residual_vjp_manual_3d)
    from difffe_tpu_torch.solver import solve_poisson_batched

    f64 = torch.float64
    bf16 = torch.bfloat16
    max_abs = {"cg3": 0.0, "cg3_2": 0.0}

    def problem(nx, ny, nz, B, g_nonzero, seed):
        grid = StructuredGrid3.unit(nx, ny, nz)
        gen = torch.Generator(device=dev).manual_seed(seed)
        opts = dict(dtype=f64, device=dev)
        k = 1.2 + 0.6 * torch.rand(B, grid.n_elements, generator=gen, **opts)
        Z, Y, X = torch.meshgrid(*(torch.linspace(0.0, 1.0, n + 1, **opts)
                                   for n in (nz, ny, nx)), indexing="ij")
        bump = (torch.sin(math.pi * X) * torch.sin(math.pi * Y)
                * torch.sin(math.pi * Z))
        f = 10.0 * bump * (1.0 + 0.2 * torch.rand(B, 1, 1, 1, generator=gen,
                                                  **opts))
        g = 0.3 * X + 0.1 * Y - 0.2 * Z if g_nonzero else torch.zeros_like(X)
        ud = 0.05 * bump * (1.0 + torch.rand(B, 1, 1, 1, generator=gen,
                                             **opts))
        return grid, (k, f, g, ud)

    def operands(grid, k, f, g, operand_dtype):
        """K4's operands in k's dtype.  With bf16 storage every run takes
        the planes the f32 run stores, so all three share one operator."""
        C, D, b, Minv, x0, _ = tk._prepare3(grid, k, f, g)
        if operand_dtype is not None:
            _, D, _, Minv, _, _ = tk._prepare3(
                grid, k.float(), f.float(), g.float(),
                operand_dtype=operand_dtype)
        return C, D, b, Minv, x0

    def k4b_steps(grid, arrays, dtype, cg3_2, operand_dtype, steps=3):
        """A cold SGD step, then warm ones, each through ``cg3_2``.  With
        bf16 storage κ stays put: κs that differ in their last bits between
        the runs could round a plane to another bf16 value."""
        k, f, g, ud = (a.to(dtype).contiguous() for a in arrays)
        out, state = [], None
        lr = 0.0 if operand_dtype else 100.0 * k.shape[0] / 256.0
        for _ in range(steps):
            C, D, b, Minv, x0 = operands(grid, k, f, g, operand_dtype)
            x0, lam0 = state if state else (x0, torch.zeros_like(b))
            x, lam = cg3_2(D, b, Minv, x0, lam0, ud, 2.0 / b.numel(),
                           K4B_ITERS)
            gk, _, _ = residual_vjp_manual_3d(grid, k, f, g, x, lam, C=C)
            out.append({"x": x, "lam": lam, "grad": gk})
            state = (x, lam)
            k = k - lr * gk
        return out

    # -- phase 10: K4a and K4b against their plain versions
    t0 = time.perf_counter()
    for nx, ny, nz, B in K4_CASES:
        storages = (None, bf16) if nx == 16 else (None,)
        for g_nonzero in (False, True):
            grid, arrays = problem(nx, ny, nz, B, g_nonzero,
                                   seed=nx * ny * nz + B + g_nonzero)
            for od in storages:
                tag = (f"{nx}x{ny}x{nz} B={B} "
                       f"g={'nonzero' if g_nonzero else 0}"
                       f"{' bf16' if od else ''}")
                runs = [k4b_steps(grid, arrays, dt, cg, od) for dt, cg in (
                    (torch.float32, tk._cg3_2),
                    (torch.float32, tk._cg3_2_plain),
                    (f64, tk._cg3_2_plain))]
                worst = {}
                for step, (kk, p, q) in enumerate(zip(*runs)):
                    for key in ("x", "lam", "grad"):
                        ek, ep = check_rule("K4b", kk[key], p[key], q[key],
                                            f"{tag} step {step} {key}")
                        worst[key] = max(worst.get(key, (0, 0)), (ek, ep))
                        if od is None:      # the main path's f32 storage
                            max_abs["cg3_2"] = max(max_abs["cg3_2"], float(
                                (kk[key] - q[key]).abs().max()))
                log(f"phase 10 K4b {tag} cold+2 warm: worst (kernel, f32 "
                    f"plain) rel err vs f64: " + " ".join(
                        f"{k}=({a:.2e}, {b:.2e})"
                        for k, (a, b) in worst.items()))
                del runs
                sols = {}
                for name, dt, cg in (("kernel", torch.float32, tk._cg3),
                                     ("f32", torch.float32, tk._cg3_plain),
                                     ("f64", f64, tk._cg3_plain)):
                    k, f, g, ud = (a.to(dt).contiguous() for a in arrays)
                    _, D, b, Minv, x0 = operands(grid, k, f, g, od)
                    sols[name] = (cg(D, b, Minv, x0, K4A_ITERS),
                                  cg(D, ud, Minv, torch.zeros_like(ud),
                                     K4A_ITERS))
                errs = [check_rule("K4a", sols["kernel"][i], sols["f32"][i],
                                   sols["f64"][i], f"{tag} solve {i}")
                        for i in range(2)]
                if od is None:
                    max_abs["cg3"] = max(max_abs["cg3"], *(float(
                        (sols["kernel"][i] - sols["f64"][i]).abs().max())
                        for i in range(2)))
                log(f"phase 10 K4a {tag} {K4A_ITERS} iters: (kernel, f32 "
                    f"plain) rel err vs f64: solve {errs[0][0]:.2e}, "
                    f"{errs[0][1]:.2e}; adjoint-style {errs[1][0]:.2e}, "
                    f"{errs[1][1]:.2e}")
                del sols
            del arrays
            torch.cuda.empty_cache()
    log(f"phase 10 kernel vs plain: {time.perf_counter() - t0:.1f} s")

    # -- phase 11: the 3D main path, with launch counts
    mesh = FEMesh.box(N_3D, N_3D, N_3D, dtype=torch.float32)
    if mesh.device.type != dev.type:
        raise AssertionError(f"the mesh factory put the mesh on "
                             f"{mesh.device}")
    grid, ne, nn = mesh.grid, mesh.n_elements, mesh.n_nodes
    shape = (BATCH_3D,) + grid.node_shape
    gen = torch.Generator(device=dev).manual_seed(0)
    x, y, z = mesh.nodes.T
    f = (10.0 * torch.sin(math.pi * x) * torch.sin(math.pi * y)
         * torch.sin(math.pi * z)).expand(BATCH_3D, nn)
    k_true = 1.2 + 0.6 * torch.rand(BATCH_3D, ne, generator=gen, device=dev)
    for k in tk.launches:
        tk.launches[k] = 0
    t0 = time.perf_counter()
    with torch.no_grad():
        u_data = solve_poisson_batched(mesh, k_true, f, cg_tol=0.0,
                                       cg_maxiter=K4A_ITERS)
    kappa, info = fit_kappa(mesh, f, u_data, lr=LR_3D)
    hist = info["loss_history"]
    ke = torch.ones(BATCH_3D, ne, device=dev, requires_grad=True)
    (solve_poisson_batched(mesh, ke, f, cg_tol=0.0, cg_maxiter=GRAD_ITERS)
     ** 2).sum().backward()
    torch.cuda.synchronize()
    main_path = dict(tk.launches)
    log(f"phase 11 fit_kappa: path={info['path']} iters={info['iters']} "
        f"warm={info['warm']} loss_history[0]={float(hist[0]):.6e} "
        f"loss_history[-1]={float(hist[-1]):.6e} "
        f"eval_loss={info['eval_loss']:.6e} "
        f"({time.perf_counter() - t0:.2f} s with u_data and the gradient)")
    log(f"3D main-path launches: {main_path}")
    if info["path"] != "stencil3d_kernel":
        raise AssertionError(f"fit_kappa took path {info['path']}")
    if info["iters"] != K4B_ITERS or info["warm"] is not False:
        raise AssertionError(f"iteration policy {info['iters']}, "
                             f"warm={info['warm']}")
    # u_data, the eval solve, the gradient's forward and adjoint
    if main_path != {"cg3": 4, "cg3_2": STEPS_3D}:
        raise AssertionError(f"K4 launches {main_path}")
    if not bool(torch.isfinite(hist).all()):
        raise AssertionError("fit_kappa's loss history is not finite")
    if kappa.shape != (BATCH_3D, ne) or not bool(
            torch.isfinite(kappa).all()):
        raise AssertionError("fit_kappa's kappa is not finite of shape "
                             f"{(BATCH_3D, ne)}")
    if not info["eval_loss"] < float(hist[0]):
        raise AssertionError("eval_loss is not below the first loss")

    def grad_plain(dtype):
        k = torch.ones(BATCH_3D, ne, dtype=dtype, device=dev)
        fg = f.to(dtype).reshape(shape)
        g0 = mesh.bc_values.to(dtype).reshape(grid.node_shape)
        C, D, b, Minv, x0, _ = tk._prepare3(grid, k, fg, g0)
        u = tk._cg3_plain(D, b, Minv, x0, GRAD_ITERS)
        lam = tk._cg3_plain(D, 2.0 * u, Minv, torch.zeros_like(u),
                            GRAD_ITERS)
        gk, _, _ = residual_vjp_manual_3d(grid, k, fg, g0, u, lam, C=C)
        return gk

    ek, ep = check_rule("K4a gradient", ke.grad, grad_plain(torch.float32),
                        grad_plain(f64), "phase 11 κ gradient")
    log(f"phase 11 κ gradient of Σu² through K4a (forward + adjoint, "
        f"{GRAD_ITERS} iters): rel err vs f64 plain {ek:.3e}, f32 plain "
        f"{ep:.3e}")
    del ke, kappa, info
    torch.cuda.empty_cache()

    # -- phase 12: timing at the main path's workload
    fg = f.reshape(shape)
    g0 = mesh.bc_values.reshape(grid.node_shape)
    ud = u_data.reshape(shape).contiguous()
    _, D, b, Minv, x0, _ = tk._prepare3(grid, k_true, fg, g0)
    scale = 2.0 / b.numel()
    state0 = (x0, torch.zeros_like(b))
    ms = {
        "cg3_2": timed_pair(
            lambda s: tk._cg3_2(D, b, Minv, *s, ud, scale, K4B_ITERS),
            lambda s: tk._cg3_2_plain(D, b, Minv, *s, ud, scale, K4B_ITERS),
            state0, 2),
        "cg3": timed_pair(
            lambda v: tk._cg3(D, b, Minv, v, K4A_ITERS),
            lambda v: tk._cg3_plain(D, b, Minv, v, K4A_ITERS), x0, 2),
    }
    for name, iters, solves in (("cg3_2", K4B_ITERS, 2),
                                ("cg3", K4A_ITERS, 1)):
        best = ms[name]
        log(f"phase 12 {name}: kernel {best['kernel']:.4f} ms/launch, plain "
            f"{best['plain']:.4f} ms/launch ({N_3D}³, B={BATCH_3D}, "
            f"{solves} x {iters} iters; kernel "
            f"{BATCH_3D / best['kernel'] * 1e3:.6e} scenarios/s) [{card}]")
    del D, b, Minv, x0, state0
    torch.cuda.empty_cache()
    # the shared-memory route at the README's other 3D size: 16³, B = 256,
    # 32 iterations (fit_kappa's policy at ≤ 16 a side)
    grid16, (k, f16, g16, ud16) = problem(16, 16, 16, 256, False, seed=16)
    k, f16, g16, ud16 = (a.float().contiguous() for a in (k, f16, g16, ud16))
    _, D, b, Minv, x0, _ = tk._prepare3(grid16, k, f16, g16)
    best = timed_pair(
        lambda s: tk._cg3_2(D, b, Minv, *s, ud16, 2.0 / b.numel(), 32),
        lambda s: tk._cg3_2_plain(D, b, Minv, *s, ud16, 2.0 / b.numel(), 32),
        (x0, torch.zeros_like(b)), 3)
    b_ms, _ = bound(K4_OPS_PER_NODE_ITER * b.numel() * 64,
                    14 * b.numel() * 4)
    log(f"phase 12 cg3_2 at 16³: kernel {best['kernel']:.4f} ms/launch, "
        f"plain {best['plain']:.4f} ms/launch (B=256, 2 x 32 iters; bound "
        f"{b_ms:.4f} ms) [{card}]")
    del D, b, Minv, x0, k, f16, g16, ud16
    torch.cuda.empty_cache()

    for eval_final in (True, False):
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, info = fit_kappa(mesh, f, u_data, eval_final=eval_final)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        if eval_final:
            log(f"phase 12 fit_kappa at the default lr: loss_history[0]="
                f"{float(info['loss_history'][0]):.6e} loss_history[-1]="
                f"{float(info['loss_history'][-1]):.6e} eval_loss="
                f"{info['eval_loss']:.6e}")
        log(f"phase 12 fit_kappa host time, {STEPS_3D} steps, "
            f"eval_final={eval_final}: " + ", ".join(f"{t:.4f}" for t in
                                                    times)
            + f" s; {BATCH_3D * STEPS_3D / min(times):.6e} grad-solves/s "
            f"[{card}]")
    profile_split(torch, lambda: fit_kappa(mesh, f, u_data), "phase 12",
                  card)

    n_nodes = BATCH_3D * nn
    return [
        kernel_entry("stencil3d_cg", K4_SOURCE, f"{JAX_K4}:153",
                     main_path["cg3"], max_abs["cg3"], ms["cg3"]["kernel"],
                     ms["cg3"]["plain"],
                     K4_OPS_PER_NODE_ITER * n_nodes * K4A_ITERS,
                     11 * n_nodes * 4),
        kernel_entry("stencil3d_cg2", K4_SOURCE, f"{JAX_K4}:368",
                     main_path["cg3_2"], max_abs["cg3_2"],
                     ms["cg3_2"]["kernel"], ms["cg3_2"]["plain"],
                     K4_OPS_PER_NODE_ITER * n_nodes * K4B_ITERS * 2,
                     14 * n_nodes * 4),
    ]


def k2_bands(torch, kind, n, B, gen, dev):
    """f64 bands (d (B, n), e (B, n−1)) of ``kind``: 'random', strictly
    diagonally dominant SPD as tests/test_pallas_tridiag.py:15-22 builds
    them, or 'fem', the Dirichlet-eliminated bands of FEMesh.line(n − 1)
    with random per-element κ in [1.2, 1.8]."""
    from difffe_tpu_torch.mesh import FEMesh
    from difffe_tpu_torch.ops.assembly import assemble_tridiag_1d

    opts = dict(dtype=torch.float64, device=dev)
    if kind == "random":
        e = -torch.rand(B, n - 1, generator=gen, **opts) - 0.1
        d = torch.rand(B, n, generator=gen, **opts) + 0.1
        d[:, :-1] -= e
        d[:, 1:] -= e
        return d, e
    mesh = FEMesh.line(n - 1, dtype=torch.float64, device=dev)
    k = 1.2 + 0.6 * torch.rand(B, n - 1, generator=gen, **opts)
    d, e = assemble_tridiag_1d(mesh, k)
    m = mesh.bc_mask
    p = 1.0 - m
    return p * d + m, p[:-1] * p[1:] * e


def run_facade_1d(torch, dev, card):
    """Phases 13-16; returns the K2 entry of the kernels line."""
    from difffe_tpu_torch import (DifferentiableFESolver, NeuralPDE,
                                  recover_kappa_field, recover_kappa_scalar)
    from difffe_tpu_torch.mesh import FEMesh
    from difffe_tpu_torch.ops import tridiag as ttri
    from difffe_tpu_torch.ops.kernels import tridiag_kernel as tk
    from difffe_tpu_torch.solver import solve_poisson, solve_poisson_batched

    f32, f64 = torch.float32, torch.float64
    gen = torch.Generator(device=dev).manual_seed(13)

    def solve_and_grads(solve, d, e, F, w):
        """u and the (d, e, F) gradients of <w, u> through ``solve``."""
        ts = [t.clone().requires_grad_() for t in (d, e, F)]
        u = solve(*ts)
        u.backward(w)
        return [u.detach()] + [t.grad for t in ts]

    def residual(d, e, u, F):
        return float((ttri.tridiag_matvec(d, e, u) - F).abs().max()
                     / F.abs().max())

    # -- phase 13: K2 against its plain version
    t0 = time.perf_counter()
    names = ("u", "d", "e", "F")
    max_abs = 0.0
    for kind in ("random", "fem"):
        for n in K2_NS:
            for B in (b for b in K2_BS if b < BATCH_K2 or n <= 257):
                d64, e64 = k2_bands(torch, kind, n, B, gen, dev)
                F64 = torch.randn(B, n, generator=gen, dtype=f64, device=dev)
                w64 = torch.randn(B, n, generator=gen, dtype=f64, device=dev)
                for shared in ((False, True) if B > 1 else (False,)):
                    dd, ee = (d64[0], e64[0]) if shared else (d64, e64)
                    for dt in (f32, f64):
                        args = [t.to(dt) for t in (dd, ee, F64, w64)]
                        k = solve_and_grads(tk.tridiag_solve_kernel, *args)
                        p = solve_and_grads(ttri.tridiag_solve, *args)
                        q = solve_and_grads(ttri.tridiag_solve,
                                            *(a.double() for a in args))
                        tag = (f"{kind} n={n} B={B} "
                               f"{'shared' if shared else 'batched'} {dt}")
                        errs = [rel_err(a, c) for a, c in zip(k, q)]
                        if dt == f32:
                            for name, a, b, c in zip(names, k, p, q):
                                check_rule("K2", a, b, c, f"{tag} {name}")
                            if n == N_1D + 1:
                                max_abs = max(max_abs, *(float(
                                    (a - c).abs().max()) for a, c in zip(k, q)))
                        elif not max(errs) <= 1e-10:
                            raise AssertionError(f"{tag}: rel err {errs}")
                        elif kind == "fem" and n > 257:
                            # ‖Tu − F‖/‖F‖ exceeds 1e-12 for the f64 plain
                            # PCR (and for dense LU) at this condition, so
                            # the gate is the normwise backward error
                            dq, eq, Fq, wq = args
                            Bd, Be = dq.expand(B, n), eq.expand(B, n - 1)
                            for what, sol, rhs, ref in (
                                    ("u", k[0], Fq, q[0]),
                                    ("λ", k[3], wq, q[3])):
                                r_k = residual(Bd, Be, sol, rhs)
                                r_p = residual(Bd, Be, ref, rhs)
                                bw = r_k * float(rhs.abs().max()) / (
                                    float(Bd.abs().max() + 2 * Be.abs().max())
                                    * float(sol.abs().max())
                                    + float(rhs.abs().max()))
                                log(f"phase 13 {tag} {what}: ‖Tx − b‖/‖b‖ "
                                    f"kernel {r_k:.2e} plain {r_p:.2e}; "
                                    f"backward error {bw:.2e}; rel err vs "
                                    f"plain " + " ".join(
                                        f"{m}={v:.2e}"
                                        for m, v in zip(names, errs)))
                                if not bw <= 1e-11:
                                    raise AssertionError(
                                        f"{tag} {what}: backward error {bw}")
                        # layout and block_b only set the launch shape
                        for layout, bb in (("transposed", 64), ("batch", 1),
                                           ("batch", 64)):
                            u_l = tk.tridiag_solve_kernel(*args[:3], bb,
                                                          layout)
                            if not torch.equal(u_l, k[0]):
                                raise AssertionError(
                                    f"{tag}: layout {layout} block_b {bb} "
                                    f"changed the result")
                del d64, e64, F64, w64, k, p, q, args
            log(f"phase 13 {kind} n={n}: every B, batched and shared bands, "
                f"f32 and f64, u and the three band gradients within the "
                f"gates; every layout equal to 'auto' bit for bit")
            torch.cuda.empty_cache()
    log(f"phase 13 kernel vs plain: {time.perf_counter() - t0:.1f} s "
        f"(max abs err at n={N_1D + 1} f32 vs f64 plain: {max_abs:.3e})")

    # -- phase 14: the main path, BASELINE.json config 2
    mesh = FEMesh.line(N_1D, dtype=f32)
    if mesh.device.type != dev.type:
        raise AssertionError(f"the mesh factory put the mesh on "
                             f"{mesh.device}")
    g0 = torch.Generator(device=dev).manual_seed(0)
    x = mesh.nodes[:, 0]
    k_true = 1.2 + 0.6 * torch.rand(BATCH_1D, N_1D, generator=g0, device=dev)
    kk = 1.0 + (torch.arange(BATCH_1D, device=dev) % 4)
    f = torch.sin(kk[:, None] * math.pi * x) + 1.5
    for key in tk.launches:
        tk.launches[key] = 0
    t0 = time.perf_counter()
    with torch.no_grad():
        u_data = solve_poisson_batched(mesh, k_true, f,
                                       method="tridiag_pallas")
    kappa, hist = recover_kappa_field(mesh, f, u_data, adam_steps=STEPS_1D,
                                      lr=LR_1D, method="tridiag_pallas")
    torch.cuda.synchronize()
    main_path = dict(tk.launches)
    h0, h1 = float(hist[0]), float(hist[-1])
    log(f"phase 14 recover_kappa_field: n={N_1D} B={BATCH_1D} "
        f"{STEPS_1D} Adam steps lr={LR_1D}: loss {h0:.6e} -> {h1:.6e} "
        f"({h0 / h1:.1f}x) ({time.perf_counter() - t0:.2f} s with u_data)")
    log(f"1D facade main-path launches: {main_path}")
    if main_path["pcr"] != 1 + 2 * STEPS_1D:
        raise AssertionError(f"K2 launches {main_path}")
    if kappa.shape != (BATCH_1D, N_1D) or not bool(
            torch.isfinite(kappa).all()):
        raise AssertionError("recover_kappa_field's kappa is not finite of "
                             f"shape {(BATCH_1D, N_1D)}")
    if not h1 < 1e-3 * h0:
        raise AssertionError("the misfit fell less than 1e3x")

    # recover_kappa_scalar, f64, bench_full.py's gate (the PCR oracle route)
    m30 = FEMesh.line(30, dtype=f64)
    x30 = m30.nodes[:, 0]
    fB = (torch.sin(math.pi * x30) + 1.0).expand(4, m30.n_nodes)
    kt = torch.tensor([0.7, 1.3, 2.0, 2.9], dtype=f64, device=dev)
    ud = solve_poisson_batched(m30, kt, fB, kappa_batched=True)
    kr, _ = recover_kappa_scalar(m30, fB, ud, adam_steps=100,
                                 newton_steps=8)
    err = float((kr - kt).abs().max())
    log(f"phase 14 recover_kappa_scalar f64 n=30 B=4: max kappa error "
        f"{err:.3e}")
    if not err < 1e-6:
        raise AssertionError(f"scalar kappa error {err:.3e}")

    # examples/poisson_1d_demo.py's three stages, f64
    m20 = FEMesh.line(20, dtype=f64)
    x20 = m20.nodes[:, 0]
    u_fem = solve_poisson(m20, 1.0, torch.ones_like(x20))
    e1 = float((u_fem - x20 * (1.0 - x20) / 2.0).abs().max())
    model = NeuralPDE(m20, hidden_dim=64, n_layers=3,
                      generator=torch.Generator().manual_seed(42))
    t0 = time.perf_counter()
    losses = model.train_pde(torch.ones_like, n_epochs=3000, lr=1e-3,
                             verbose=False)
    t_nn = time.perf_counter() - t0
    free = torch.as_tensor(m20.free_nodes(), device=dev)
    with torch.no_grad():
        u_nn = model()
    e2 = float((u_nn[free] - u_fem[free]).abs().max()
               / u_fem[free].abs().max())
    f30 = torch.sin(math.pi * x30) + 1.0
    u30 = solve_poisson(m30, 2.0, f30)
    k = torch.tensor(1.0, dtype=f64, device=dev, requires_grad=True)
    opt = torch.optim.Adam([k], lr=0.1, betas=(0.9, 0.999), eps=1e-8)
    for _ in range(200):
        opt.zero_grad()
        ((solve_poisson(m30, k.abs(), f30) - u30) ** 2).mean().backward()
        opt.step()
    e3 = abs(float(k.detach().abs()) - 2.0)
    log(f"phase 14 demo: FEM max error {e1:.2e}; NeuralPDE 3000 epochs "
        f"({t_nn:.1f} s) final loss {losses[-1]:.2e}, max relative error on "
        f"free nodes {e2:.3e}; recovered kappa "
        f"{float(k.detach().abs()):.6f}")
    if not (e1 <= 1e-13 and e2 < 0.05 and e3 < 1e-4):
        raise AssertionError(f"demo gates: {e1:.2e} {e2:.3e} {e3:.2e}")
    fb = torch.randn(5, m20.n_nodes, generator=gen, dtype=f64, device=dev)
    u_k = DifferentiableFESolver(m20, 1.7, method="tridiag_pallas")(fb)
    u_d = DifferentiableFESolver(m20, 1.7, method="dense")(fb)
    e4 = rel_err(u_k, u_d)
    log(f"phase 14 DifferentiableFESolver tridiag_pallas vs dense, f64: "
        f"rel err {e4:.2e}")
    if not e4 <= 1e-10:
        raise AssertionError(f"DifferentiableFESolver disagrees: {e4:.2e}")
    del kappa, hist, model
    torch.cuda.empty_cache()

    # -- phase 15: the κ gradient through the route, K2 forward and adjoint
    def kappa_grad(method, dt):
        m = FEMesh.line(N_1D, dtype=dt)
        ke = torch.ones(BATCH_1D, N_1D, dtype=dt, device=dev,
                        requires_grad=True)
        u = solve_poisson_batched(m, ke, f.to(dt), method=method)
        ((u - u_data.to(dt)) ** 2).mean().backward()
        return ke.grad

    ek, ep = check_rule("K2 gradient", kappa_grad("tridiag_pallas", f32),
                        kappa_grad("tridiag", f32), kappa_grad("tridiag", f64),
                        "phase 15 κ gradient")
    e64 = rel_err(kappa_grad("tridiag_pallas", f64),
                  kappa_grad("tridiag", f64))
    log(f"phase 15 κ gradient of the batched MSE through K2 (forward + "
        f"adjoint): f32 rel err vs f64 plain {ek:.3e} (f32 plain {ep:.3e}); "
        f"f64 rel err vs f64 plain {e64:.3e}")
    if not e64 <= 1e-10:
        raise AssertionError(f"f64 κ gradient disagrees: {e64:.3e}")

    # -- phase 16: timing at n = 129, f32
    n = N_1D + 1
    dB, eB = k2_bands(torch, "fem", n, BATCH_K2, gen, dev)
    dB, eB = dB.float(), eB.float()
    F0 = torch.randn(BATCH_K2, n, generator=gen, device=dev)

    def fwd_bwd(solve):
        def step(c):
            dd = dB.detach().requires_grad_()
            (gd,) = torch.autograd.grad(solve(dd, eB, c), dd,
                                        grad_outputs=c)
            return gd
        return step

    ms = {
        "fwd": timed_pair(lambda c: tk.tridiag_solve_kernel(dB, eB, c),
                          lambda c: ttri.tridiag_solve(dB, eB, c), F0, 4),
        "fwd_bwd": timed_pair(fwd_bwd(tk.tridiag_solve_kernel),
                              fwd_bwd(ttri.tridiag_solve), F0, 4),
    }
    T = (torch.diag_embed(dB[:BATCH_LIB]) + torch.diag_embed(eB[:BATCH_LIB], 1)
         + torch.diag_embed(eB[:BATCH_LIB], -1))
    t_lib = timeit_chained_min(
        lambda c: torch.linalg.solve(T, c[..., None])[..., 0],
        F0[:BATCH_LIB].contiguous())
    library_ms = t_lib * BATCH_K2 / BATCH_LIB
    steps = math.ceil(math.log2(n))
    ops = BATCH_K2 * n * (K2_OPS_PER_ROW_SWEEP * steps + 1)
    nbytes = (4 * n - 1) * BATCH_K2 * 4
    b_ms, b_by = bound(ops, nbytes)
    for name, what in (("fwd", "forward solve"),
                       ("fwd_bwd", "forward + backward (2 K2 launches)")):
        best = ms[name]
        log(f"phase 16 K2 {what}: kernel {best['kernel']:.4f} ms, plain "
            f"{best['plain']:.4f} ms (n={n}, B={BATCH_K2}, f32) [{card}]")
    log(f"phase 16 K2 bound {b_ms:.4f} ms ({b_by}); kernel "
        f"{nbytes / ms['fwd']['kernel'] / 1e6:.1f} GB/s of the "
        f"{PEAK_BYTES / 1e12:.2f} TB/s peak; torch.linalg.solve on the "
        f"densified systems {t_lib:.4f} ms at B={BATCH_LIB}, "
        f"{library_ms:.4f} ms scaled to B={BATCH_K2} [{card}]")
    del T, dB, eB, F0
    torch.cuda.empty_cache()

    for B in (BATCH_1D, BATCH_K2):
        mB = FEMesh.line(N_1D, dtype=f32)
        fb = f[torch.arange(B, device=dev) % BATCH_1D]
        with torch.no_grad():
            ub = solve_poisson_batched(
                mB, k_true[torch.arange(B, device=dev) % BATCH_1D], fb,
                method="tridiag_pallas")
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            recover_kappa_field(mB, fb, ub, adam_steps=STEPS_1D, lr=LR_1D,
                                method="tridiag_pallas")
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        log(f"phase 16 recover_kappa_field host time, {STEPS_1D} steps, "
            f"B={B}: " + ", ".join(f"{t:.4f}" for t in times)
            + f" s; {B * STEPS_1D / min(times):.6e} grad-solves/s [{card}]")
    profile_split(
        torch, lambda: recover_kappa_field(
            mesh, f, u_data, adam_steps=STEPS_1D, lr=LR_1D,
            method="tridiag_pallas"),
        "phase 16", card, what=f"recover_kappa_field (B={BATCH_1D})")

    return kernel_entry("tridiag_pcr", K2_SOURCE,
                        f"{JAX_K2}:80 (_pcr_pallas_padded), :161 "
                        f"(_pcr_pallas_T)", main_path["pcr"], max_abs,
                        ms["fwd"]["kernel"], ms["fwd"]["plain"], ops, nbytes,
                        library_ms)


def timeit_chained_min(fn, x0, length=4):
    """Best chained ms per call of one function."""
    from difffe_tpu_torch.utils.profiling import timeit_chained

    return timeit_chained(fn, x0, length=length, repeats=3).min_s * 1e3


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA card is available")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from difffe_tpu_torch.ops.kernels import _build

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- phase 1: what runs where
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0].strip()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    log(f"card: {card}")

    # -- phase 2: build
    t0 = time.perf_counter()
    lib = _build.load_library()
    log(f"phase 2 build: {_build.library_path().name} in "
        f"{time.perf_counter() - t0:.1f} s ({lib._name})")

    t0 = time.perf_counter()
    kernels = run_1d(torch, dev, card)
    log(f"1D path, phases 3-6: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    kernels += run_2d(torch, dev, card)
    log(f"2D path, phases 7-9: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    kernels += run_3d(torch, dev, card)
    log(f"3D path, phases 10-12: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    kernels.append(run_facade_1d(torch, dev, card))
    log(f"1D facade path, phases 13-16: {time.perf_counter() - t0:.1f} s")

    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
