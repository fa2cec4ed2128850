"""Probe: what binds kernel K7 on the card, by timing ablations of it.

PyTorch counterpart of the TPU probe ``scripts/probe_mxu_kernel.py`` (P2):
the scalar-κ dense-inverse grad step of K7 version 1 (one shared load F,
u_data stored in bf16), each variant changing one thing:

* A — the baseline: K7 itself (``csrc/fused_grad_mxu.cu``, version 1,
  refine 0), through ``fused_kappa_mse_step_mxu``; P2's ``make_kernel("A")``,
  two products at HIGHEST precision.
* B — both products as 3xTF32 split products on the tensor cores (each
  operand a = hi + lo rounded to TF32, hi·hi + hi·lo + lo·hi in f32);
  P2's HIGH precision, the TPU's 3-pass bf16 products.
* C — both products as single-pass bf16 tensor-core products with f32
  accumulation; P2's DEFAULT precision.
* D — one product: λ = (m + p/κ) ⊙ (u − u_data); wrong math, timing only;
  P2's D (the adjoint product dropped).
* E — no shifts: ∂log κ from Σ λ ⊙ (t₀ + d₀ ⊙ u); wrong math, timing only;
  P2's E.
* F — the same math as A, mapped onto the SM another way: register-blocked
  rows, one shared-memory load per four multiply-adds (K7 makes two per
  one).  P2's F packed W block-diagonally to fill the TPU's 128 × 128
  matrix unit, which on the card would only quadruple the multiply-adds:
  the question it asked, whether the mapping of the same math onto the
  compute units sets the pace, is this mapping here.  Its outputs equal
  A's bit for bit.
* A1 — no P2 variant: D and E's kernel with nothing ablated.  K7 picks its
  body at run time and D and E are compiled for theirs, so A1, A's design
  compiled for version 1 alone (equal to A bit for bit), is the baseline
  D and E are read against.

B-F and A1 are kernels of ``csrc/k7_ablation.cu``, launched by
:func:`ablation_step` for CUDA tensors; for CPU tensors it takes their
plain PyTorch versions (:func:`plain_step`).  P2's workload: ``FEMesh.line(30)``
(31 nodes), B = 2^21, one κ per scenario, f = sin(πx) + 1 shared, bf16
u_data, 30 chained steps log κ ← log κ − 0.3·∂log κ timed best of 3, and
each variant's gradient on an 8192-scenario slice against autograd through
the PCR tridiagonal oracle on the same bf16-quantized data.

Run on a machine with a CUDA card:
    python -m difffe_tpu_torch.probes.k7_ablation [batch]
It prints P2's line for each variant (M solves/s and parity rel), then the
card's name and power limit, and writes chiprun_out/k7_ablation.json.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from ..mesh import FEMesh
from ..ops.assembly import assemble_load
from ..ops.kernels import fused_grad_mxu_kernel as k7
from ..ops.kernels.fused_grad_kernel import (check_cuda, rows_view,
                                             scalar_columns, storage_code)
from ..ops.tridiag import _shift_down, _shift_up
from ..solver import solve_poisson_batched
from ..utils.profiling import timeit_chained

VARIANTS = ("A", "A1", "B", "C", "F", "D", "E")   # P2's order, A1 after A
N_ELEM = 30
BATCH = 2 ** 21
STEPS = 30
LR = 0.3
SLICE = 8192
MAX_NODES = 32           # the kernels pad n to 16 or 32

#: Kernel launches made by :func:`ablation_step`, by variant; A's are K7's
#: (``fused_grad_mxu_kernel.launches["k7"]``).
launches = {v: 0 for v in VARIANTS if v != "A"}
_CODES = {"B": 1, "C": 2, "D": 3, "E": 4, "F": 5, "A1": 6}

# P2's columns of its staged (N, 128) block (difffe_tpu's
# ops/pallas/fused_grad_kernel.py:50-56 and fused_grad_mxu_kernel.py:60)
_COL_M, _COL_P, _COL_D0, _COL_A0, _COL_C0, _COL_MG, _COL_T0, _COL_F = range(8)


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU path and reference)
# ---------------------------------------------------------------------------


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` rounds the float32
    value: to nearest, ties away from zero, the 13 low bits cleared; in
    ``x``'s dtype."""
    b = x.float().contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32).to(x.dtype)


def _split(x: torch.Tensor):
    """x = hi + lo as variant B splits a product's operand."""
    hi = _tf32(x)
    return hi, _tf32((x.float() - hi.float()).to(x.dtype))


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16 (to nearest even) through float32."""
    return x.float().bfloat16().to(x.dtype)


def _product(variant: str, y: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """W y for each row y of (B, n): B's three split products (lo·hi first,
    as the kernel accumulates them), C's bf16 operands, else exact."""
    if variant == "B":
        (yh, yl), (wh, wl) = _split(y), _split(W)
        return yl @ wh.T + yh @ wl.T + yh @ wh.T
    if variant == "C":
        return _bf16(y) @ _bf16(W).T
    return y @ W.T


def plain_step(variant: str, log_k, F, ud, cols, W, scale: float):
    """Plain version of ``variant`` on (B, n) rows with the shared load F
    (n,): (loss (B,), ∂log κ (B,)).  A, A1 and F are K7's plain version,
    version 1 without refinement."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got "
                         f"{variant!r}")
    if variant in ("A", "A1", "F"):
        return k7._k7_plain(log_k, F, ud, cols, W, scale, 1, 0)
    m, p, d0, a0, c0, mg, t0, _ = cols
    dtype = cols.dtype
    f, ud = F.to(dtype), ud.to(dtype)
    kappa = torch.exp(log_k)[:, None]
    dinv = m + p * (1.0 / kappa)
    r = mg + p * f - kappa * t0
    u = _product(variant, dinv * r, W)
    diff = u - ud
    lam = dinv * diff if variant == "D" else _product(variant, dinv * diff, W)
    if variant == "E":
        term = t0 + d0 * u
    else:
        term = (t0 + a0 * _shift_up(u, 1, 0.0) + d0 * u
                + c0 * _shift_down(u, 1, 0.0))
    gk = -(lam * term).sum(-1)
    return (diff * diff).sum(-1), (scale * kappa[:, 0]) * gk


def rule_slack(variant: str, n: int) -> float:
    """The additive term of phase 7's rule (chip_smoke.py) for
    ``variant``'s f32 kernel at n nodes: 1e-6, and for C also one bf16
    rounding step of one of the n operands of a product, 2^-8/n.  C's
    kernel and its plain version round the adjoint product's right-hand
    side (m + p/κ)(u − u_data) to bf16 from values that differ by the
    first product's f32 summation, so an element near a rounding boundary
    can round up in one and down in the other (measured on the card: 1 of
    160 cases at B = 1000 missed the rule with 1e-6 alone)."""
    return 1e-6 + (2.0 ** -8 / n if variant == "C" else 0.0)


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------


def _launch(variant: str, log_k, F, ud, cols, W, scale: float):
    """One launch of ``variant``'s kernel."""
    from ..ops.kernels._build import load_library

    dtype, dev = log_k.dtype, log_k.device
    what = f"K7 ablation {variant}"
    check_cuda(dtype, dev, what, F, ud, cols, W)
    if dtype == torch.float64 and variant in ("B", "C"):
        raise TypeError(f"{what}: tensor-core products take float32")
    B, n = log_k.shape[0], ud.shape[-1]
    lk, sL = rows_view(log_k[:, None], 1)
    ud, sU = rows_view(ud, n)
    u_code = storage_code(ud, dtype, "u_data")
    F = F.contiguous()
    loss = torch.empty(B, dtype=dtype, device=dev)
    grad = torch.empty(B, dtype=dtype, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.difffe_k7_ablation(
            _CODES[variant], lk.data_ptr(), sL, F.data_ptr(), ud.data_ptr(),
            sU, u_code, cols.data_ptr(), W.data_ptr(), loss.data_ptr(),
            grad.data_ptr(), B, n, float(scale),
            int(dtype == torch.float64), stream)
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc}")
    launches[variant] += 1
    return loss, grad


def ablation_step(variant: str, mesh, log_k, F, u_data, scale: float):
    """One grad step of ``variant`` on ``mesh`` (a line mesh of at most
    ``MAX_NODES`` nodes): log κ (B,), the shared load F (n,), u_data (B, n)
    in the mesh dtype or bf16; returns (loss (B,), ∂log κ (B,)) of the
    objective scale/2 · Σ_b ‖u_b − u_data_b‖².  CUDA tensors launch the
    variant's kernel (A: K7) or raise; CPU tensors take the plain
    version."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got "
                         f"{variant!r}")
    n, dtype = mesh.n_nodes, mesh.dtype
    B = log_k.shape[0]
    if n > MAX_NODES:
        raise ValueError(f"the K7 ablations take at most {MAX_NODES} nodes, "
                         f"got {n}")
    if tuple(F.shape) != (n,) or tuple(u_data.shape) != (B, n) \
            or tuple(log_k.shape) != (B,):
        raise ValueError(f"K7 ablation: log κ (B,), F (n,) and u_data (B, n) "
                         f"with n = {n}, got {tuple(log_k.shape)}, "
                         f"{tuple(F.shape)}, {tuple(u_data.shape)}")
    log_k, F = log_k.to(dtype), F.to(dtype)
    if variant == "A":
        op = torch.bfloat16 if u_data.dtype == torch.bfloat16 else None
        return k7.fused_kappa_mse_step_mxu(mesh, log_k, F, u_data,
                                           scale=scale, operand_dtype=op,
                                           version=1, refine=0)
    cols, W = scalar_columns(mesh), k7.mxu_inverse(mesh)
    with torch.no_grad():
        if log_k.device.type == "cpu":
            return plain_step(variant, log_k, F, u_data, cols, W, scale)
        return _launch(variant, log_k, F, u_data, cols, W, scale)


# ---------------------------------------------------------------------------
# P2's staging, parity and timing
# ---------------------------------------------------------------------------


def operands_from_jax(cols, W, Wpacked, udT, n: int):
    """P2's staged operands, as ``main`` of scripts/probe_mxu_kernel.py
    builds them (numpy or JAX arrays): ``cols`` (N, 128) in its ``_COL_*``
    layout, ``W`` (N, Wc) with ``Wpacked`` (its block-diagonal copies) and
    ``udT`` (N, B) in bf16, N ≥ n padded rows.  Returns the port's
    operands: the (8, n) unit-κ block (m, p, d0, a0, c0, mg, t0, mg − t0),
    W (n, n), u_data (B, n) in bf16 and the shared load F (n,)."""
    cols = np.asarray(cols, np.float32)
    W = np.asarray(W, np.float32)
    N = cols.shape[0]
    Wp = np.asarray(Wpacked, np.float32)
    pack = Wp.shape[0] // N
    if not np.array_equal(Wp, np.kron(np.eye(pack, dtype=np.float32),
                                      W[:, :N])):
        raise ValueError("Wpacked is not W repeated down the diagonal")
    rows = [cols[:n, c] for c in (_COL_M, _COL_P, _COL_D0, _COL_A0, _COL_C0,
                                  _COL_MG, _COL_T0)]
    block = np.stack(rows + [rows[5] - rows[6]])
    ud = np.asarray(udT)
    if ud.dtype.itemsize != 2:
        raise TypeError(f"udT must be stored in bf16, got {ud.dtype}")
    bits = np.ascontiguousarray(ud[:n].T).view(np.int16)
    return (torch.from_numpy(block), torch.from_numpy(W[:n, :n].copy()),
            torch.from_numpy(bits).view(torch.bfloat16),
            torch.from_numpy(cols[:n, _COL_F].copy()))


@dataclasses.dataclass
class Staged:
    """P2's workload on a mesh: log κ (B,) at 0, the shared load F (n,),
    the nodal forcing f (n,), u_data (B, n) in bf16, scale = 2/(B·n)."""

    log_k: torch.Tensor
    F: torch.Tensor
    f: torch.Tensor
    u_data: torch.Tensor
    scale: float


def stage(mesh, B: int, generator: torch.Generator) -> Staged:
    """``main``'s staging on the port: f = sin(πx) + 1 shared, κ_true =
    1 + 2·U(0, 1) per scenario from ``generator``, u_data from the batched
    tridiagonal solve quantized to bf16."""
    n, dtype, dev = mesh.n_nodes, mesh.dtype, mesh.device
    f = torch.sin(math.pi * mesh.nodes[:, 0]) + 1.0
    k_true = 1.0 + 2.0 * torch.rand(B, generator=generator, dtype=dtype,
                                    device=dev)
    with torch.no_grad():
        u = solve_poisson_batched(mesh, k_true, f.expand(B, n),
                                  method="tridiag", kappa_batched=True)
    return Staged(torch.zeros(B, dtype=dtype, device=dev),
                  assemble_load(mesh, f), f, u.bfloat16(), 2.0 / (B * n))


def oracle_grad(mesh, st: Staged) -> torch.Tensor:
    """P2's reference: ∂/∂log κ of scale/2 · Σ (u − u_data)² on the first
    ``SLICE`` scenarios (at most B), by autograd through the PCR
    tridiagonal solve on the same bf16-quantized u_data."""
    count = min(SLICE, st.log_k.shape[0])
    lk = st.log_k[:count].detach().clone().requires_grad_()
    u = solve_poisson_batched(mesh, torch.exp(lk),
                              st.f.expand(count, mesh.n_nodes),
                              method="tridiag", kappa_batched=True)
    loss = ((u - st.u_data[:count].to(mesh.dtype)) ** 2).sum() \
        * (st.scale / 2.0)
    (g,) = torch.autograd.grad(loss, lk)
    return g


def parity(variant: str, mesh, st: Staged, g_ref: torch.Tensor) -> float:
    """max |∂log κ − g_ref| / max |g_ref| of one step on the slice."""
    count = g_ref.shape[0]
    _, g = ablation_step(variant, mesh, st.log_k[:count], st.F,
                         st.u_data[:count], st.scale)
    return float((g - g_ref).abs().max() / g_ref.abs().max())


def run_variant(variant: str, mesh, st: Staged, plain: bool = False) -> float:
    """P2's timing of ``variant`` (its plain version with ``plain``):
    ``STEPS`` chained steps log κ ← log κ − 0.3·∂log κ, best of 3 after a
    warm-up (``timeit_chained``: CUDA events, one synchronize); ms a
    step."""
    if plain:
        cols, W = scalar_columns(mesh), k7.mxu_inverse(mesh)

        def grad(lk):
            return plain_step(variant, lk, st.F, st.u_data, cols, W,
                              st.scale)[1]
    else:
        def grad(lk):
            return ablation_step(variant, mesh, lk, st.F, st.u_data,
                                 st.scale)[1]
    t = timeit_chained(lambda lk: lk.add(grad(lk), alpha=-LR), st.log_k,
                       length=STEPS, repeats=3)
    return t.min_s * 1e3


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main(batch: int = BATCH):
    if not torch.cuda.is_available():
        raise SystemExit("the probe needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    mesh = FEMesh.line(N_ELEM, dtype=torch.float32, device=dev)
    st = stage(mesh, batch, torch.Generator(device=dev).manual_seed(0))
    g_ref = oracle_grad(mesh, st)
    rows = []
    for v in VARIANTS:
        ms = run_variant(v, mesh, st)
        rel = parity(v, mesh, st, g_ref)
        rows.append({"variant": v, "ms": ms, "msolves_s": batch / ms / 1e3,
                     "parity_rel": rel})
        print(f"variant {v}: {batch / ms / 1e3:8.1f} M solves/s   parity "
              f"rel {rel:.2e}   ({ms:.4f} ms a step)", flush=True)
    card = card_name()
    print(card)
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / "k7_ablation.json").write_text(json.dumps(
        {"card": card, "batch": batch, "n_nodes": mesh.n_nodes,
         "steps": STEPS, "variants": rows}, indent=1))


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:2]))
