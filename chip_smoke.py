#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``difffe_tpu_torch``) on one CUDA card.

Drives the port's main path, per-element-κ inversion on a 1D line mesh,
at the workload of ``bench.py`` (n = 30 elements, B = 2^21 scenarios, one
shared forcing), in phases; any failure raises, so the run exits non-zero
and never prints the final ``ok`` line:

1. versions, the card's name and power limit (refuses to run without a
   card);
2. build the CUDA kernels from ``difffe_tpu_torch/csrc/``;
3. each K1 variant (step/chain × shared/f32/bf16 u_data) against its plain
   PyTorch version, n ∈ {10, 30, 128}, B ∈ {1000, 2^21};
4. ``fit_kappa`` through the public entry point, 128 steps = 4 chain
   launches, with loss checks;
5. bench.py's parity gate: the step kernel's gradient against autograd
   through the PCR tridiagonal oracle on the bf16-quantized plane;
6. chained timing of the chain and step kernels and their plain versions
   at the bench workload.

The launch counts of phases 4-5 (the main path) are read from the kernel
wrappers; phases 3 and 6 do not count.  The second-to-last line is one
JSON object describing each kernel; the last line is the ``ok`` JSON.

Run: ``python3 chip_smoke.py`` from the repository root.
"""

import json
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


def log(*args):
    print(*args, flush=True)


def rel_err(a, b):
    return float((a - b).abs().max() / b.abs().max())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA card is available")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from difffe_tpu_torch import fit_kappa
    from difffe_tpu_torch.mesh import FEMesh
    from difffe_tpu_torch.ops.assembly import assemble_load
    from difffe_tpu_torch.ops.cf1d import solve_poisson_cf_batched
    from difffe_tpu_torch.ops.kernels import _build
    from difffe_tpu_torch.ops.kernels import fused_grad_cf_kernel as tk
    from difffe_tpu_torch.solver import solve_poisson_batched
    from difffe_tpu_torch.utils.profiling import timeit_chained

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
    log(f"main-path launches: {main_path}")
    for k, v in main_path.items():
        if v < 1:
            raise AssertionError(f"kernel {k} was not launched by the path")
    del u, ke, ud_q, gT
    torch.cuda.empty_cache()

    # -- phase 6: chained timing at the bench workload (plain, kernel,
    # kernel, plain; best of each)
    udT, cols, B, u_l, u_r = (aux["udT"], aux["cols"], aux["B"], aux["u_l"],
                              aux["u_r"])
    runs = {
        "chain": (lambda k: tk.kappa_sgd_chain_cf(k, aux, CHAIN_K, LR,
                                                  scale)[1],
                  lambda k: tk._cf_chain_plain(k, udT, cols, B, scale, u_l,
                                               u_r, CHAIN_K, LR)[1]),
        "step": (lambda k: k - LR * tk.kappa_mse_step_cf_packed(
                     k, aux, scale)[1],
                 lambda k: k - LR * tk._cf_step_plain(
                     k, udT, cols, B, scale, u_l, u_r)[1]),
    }
    ms = {}
    for name, (kernel_fn, plain_fn) in runs.items():
        best = {"kernel": float("inf"), "plain": float("inf")}
        for which in ("plain", "kernel", "kernel", "plain"):
            fn = kernel_fn if which == "kernel" else plain_fn
            t = timeit_chained(fn, keT0, length=STEPS // CHAIN_K, repeats=3)
            best[which] = min(best[which], t.min_s * 1e3)
        ms[name] = best
        steps = CHAIN_K if name == "chain" else 1
        log(f"phase 6 {name}: kernel {best['kernel']:.4f} ms/launch, plain "
            f"{best['plain']:.4f} ms/launch, {steps} SGD step(s)/launch; "
            f"kernel {BATCH * steps / best['kernel'] * 1e3:.6e} "
            f"grad-solves/s, plain "
            f"{BATCH * steps / best['plain'] * 1e3:.6e} grad-solves/s "
            f"[{card}]")

    kernels = [
        {"name": "cf_chain", "route": "cuda", "source": CU_SOURCE,
         "replaces": f"{JAX_KERNEL}:445", "launches": main_path["chain"],
         "max_abs_err": max_abs["chain"], "ms": ms["chain"]["kernel"],
         "plain_ms": ms["chain"]["plain"]},
        {"name": "cf_step", "route": "cuda", "source": CU_SOURCE,
         "replaces": f"{JAX_KERNEL}:132", "launches": main_path["step"],
         "max_abs_err": max_abs["step"], "ms": ms["step"]["kernel"],
         "plain_ms": ms["step"]["plain"]},
    ]
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
