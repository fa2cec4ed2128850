"""Probe: K7 version 3 with its refinement residual in float32, as the TPU
body forms it, against the package's float64 residual.

The package's K7 (``csrc/fused_grad_mxu.cu`` and its plain version) forms
each residual y − T̃₁u of version 3 in float64 and rounds it once.  This
probe builds a variant of that source whose residual is formed in the
compute type, with a matching plain version, and holds both variants to the
rule of chip_smoke.py's phases 7 and 17 over several seeds and batch sizes:
the kernel's relative max error against the float64 plain version may be at
most twice the float32 plain version's, plus 1e-6.  Version 2 (no
residual) runs beside them as the baseline of the kernel's summation order
against cuBLAS's.  For each (variant, body, B, quantity) it prints how
often the rule fails, and the median and extremes of kernel error / plain
error: a spread that is even about 1 is rounding noise, one that leans
towards the kernel is a fault of the kernel.

Run on a machine with a CUDA card:
    python -m difffe_tpu_torch.probes.k7_residual [seeds]
It writes every case to chiprun_out/k7_residual.json.
"""

from __future__ import annotations

import ctypes
import json
import math
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from ..mesh import FEMesh
from ..ops.assembly import assemble_load
from ..ops.kernels import _build
from ..ops.kernels import fused_grad_mxu_kernel as k7
from ..ops.kernels.fused_grad_kernel import scalar_columns
from ..ops.tridiag import _shift_down, _shift_up
from ..solver import solve_poisson_batched

# the package's residual, and the TPU body's: y - T1 u in the compute type
_WIDE = """        const double t1 = add(
            add(mul(wide(add(cm[i], cd0[i])), wide(out[i * P + t])),
                mul(wide(ca0[i]), wide(nb(out, i - 1)))),
            mul(wide(cc0[i]), wide(nb(out, i + 1))));
        R[i * P + t] = static_cast<T>(sub(wide(y[i * P + t]), t1));"""
_NARROW = """        const T t1 = add(add(mul(add(cm[i], cd0[i]), out[i * P + t]),
                             mul(ca0[i], nb(out, i - 1))),
                         mul(cc0[i], nb(out, i + 1)));
        R[i * P + t] = sub(y[i * P + t], t1);"""

NS = (13, 31, 136)
BS = (7, 1000, 65536)
BODIES = ((2, 0), (3, 2), (3, 3))


def narrow_library() -> ctypes.CDLL:
    """The K7 source with the float32 residual, built on its own."""
    src = (_build.CSRC / "fused_grad_mxu.cu").read_text()
    if src.count(_WIDE) != 1:
        raise RuntimeError("the residual block of fused_grad_mxu.cu moved")
    out = _build.BUILD_DIR / "probe_k7_residual"
    out.mkdir(parents=True, exist_ok=True)
    (out / "fused_grad_mxu.cu").write_text(src.replace(_WIDE, _NARROW))
    (out / "fused_step_common.cuh").write_text(
        (_build.CSRC / "fused_step_common.cuh").read_text())
    lib = out / "libk7_narrow.so"
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS,
                    *_build.LINK_FLAGS, "-o", str(lib),
                    str(out / "fused_grad_mxu.cu")], check=True,
                   capture_output=True)
    dll = ctypes.CDLL(str(lib))
    dll.difffe_fused_mxu.argtypes = _build._SIGNATURES["difffe_fused_mxu"]
    dll.difffe_fused_mxu.restype = ctypes.c_int
    return dll


def narrow_plain(log_k, F, ud, cols, W, scale, refine):
    """Version 3 of K7's plain version with the residual in the compute
    type."""
    m, p, d0, a0, c0, mg, t0, rhs0 = cols
    kinv = 1.0 / torch.exp(log_k)[:, None]

    def solve(y):
        u = y @ W.T
        for _ in range(refine):
            T1u = ((m + d0) * u + a0 * _shift_up(u, 1, 0.0)
                   + c0 * _shift_down(u, 1, 0.0))
            u = u + (y - T1u) @ W.T
        return u

    pf = p * F.to(cols.dtype)
    u = solve(rhs0 + kinv * pf)
    diff = u - ud.to(cols.dtype)
    lam = solve((m + p * kinv) * diff)
    return (diff * diff).sum(-1), -scale * (lam * pf).sum(-1)


def operands(n, B, gen, bc, shared_f, dev):
    """Phase 17's operands: the load of a perturbed sin(πx) + 1, the
    observations of a random κ field, log κ ~ 0.3·N(0, 1); float64."""
    f64 = dict(dtype=torch.float64, device=dev)
    m64 = FEMesh.line(n - 1, bc_left=bc[0], bc_right=bc[1],
                      dtype=torch.float64, device=dev)
    x = m64.nodes[:, 0]
    f = (torch.sin(math.pi * x) + 1.0) * (
        1.0 + 0.2 * torch.rand(B, 1, generator=gen, **f64))
    with torch.no_grad():
        ud = solve_poisson_batched(
            m64, 1.0 + torch.rand(B, n - 1, generator=gen, **f64), f,
            method="tridiag")
    F = assemble_load(m64, f)
    lk = 0.3 * torch.randn(B, generator=gen, **f64)
    return lk, (F[0] if shared_f else F), ud


def rel(a, b) -> float:
    d = float((a.double() - b.double()).abs().max())
    return 0.0 if d == 0.0 else d / float(b.double().abs().max())


def main(seeds: int = 8):
    if not torch.cuda.is_available():
        raise SystemExit("the probe needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    narrow = narrow_library()
    cases = []
    for seed in range(seeds):
        gen = torch.Generator(device=dev).manual_seed(seed)
        for n in NS:
            bc_all = ((0.0, 0.0), (0.3, -0.2))
            meshes = {(bc, dt): FEMesh.line(n - 1, bc_left=bc[0],
                                            bc_right=bc[1], dtype=dt,
                                            device=dev)
                      for bc in bc_all
                      for dt in (torch.float32, torch.float64)}
            for B in BS:
                for bc in bc_all:
                    m32, m64 = (meshes[bc, torch.float32],
                                meshes[bc, torch.float64])
                    c32, W32 = scalar_columns(m32), k7.mxu_inverse(m32)
                    c64, W64 = scalar_columns(m64), k7.mxu_inverse(m64)
                    for shared_f in (False, True):
                        lk, F, ud = operands(n, B, gen, bc, shared_f, dev)
                        a32 = (lk.float(), F.float(), ud.float())
                        Fb = F.expand(B, n) if F.ndim == 1 else F
                        scale = 2.0 / (B * n)
                        for version, refine in BODIES:
                            p64 = k7._k7_plain(lk, Fb, ud, c64, W64, scale,
                                               version, refine)
                            wide_k = k7._launch(*a32, c32, W32, scale,
                                                version, refine, 1024)
                            wide_p = k7._k7_plain(a32[0], a32[1].expand(
                                B, n), a32[2], c32, W32, scale, version,
                                refine)
                            runs = {"float64 residual": (wide_k, wide_p)}
                            if version == 3:
                                real = _build.load_library
                                _build.load_library = lambda: narrow
                                try:
                                    nk = k7._launch(*a32, c32, W32, scale,
                                                    version, refine, 1024)
                                finally:
                                    _build.load_library = real
                                runs["float32 residual"] = (nk, narrow_plain(
                                    a32[0], a32[1].expand(B, n), a32[2],
                                    c32, W32, scale, refine))
                            for variant, (kk, pp) in runs.items():
                                for q, a, b, c in zip(("loss", "grad"), kk,
                                                      pp, p64):
                                    ek, ep = rel(a, c), rel(b, c)
                                    cases.append(dict(
                                        seed=seed, n=n, B=B, bc=bc,
                                        shared_f=shared_f, version=version,
                                        refine=refine, variant=variant,
                                        quantity=q, kernel_err=ek,
                                        plain_err=ep,
                                        ok=ek <= 2.0 * ep + 1e-6))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}; {seeds} seeds x n {NS} x B {BS} x 2 "
          f"boundary conditions x (streamed, shared) F, float32 storage")
    groups = {}
    for c in cases:
        key = (c["variant"], c["version"], c["refine"], c["B"], c["quantity"])
        groups.setdefault(key, []).append(c)
    for key in sorted(groups):
        g = groups[key]
        ratios = sorted(c["kernel_err"] / c["plain_err"] for c in g
                        if c["plain_err"] > 0)
        print(f"{key[0]:>16} v{key[1]} r{key[2]} B={key[3]:>6} {key[4]}: "
              f"rule fails {sum(not c['ok'] for c in g)}/{len(g)}; kernel/"
              f"plain error median {statistics.median(ratios):.3f} min "
              f"{ratios[0]:.3f} max {ratios[-1]:.3f}; max kernel "
              f"{max(c['kernel_err'] for c in g):.3e} plain "
              f"{max(c['plain_err'] for c in g):.3e}")
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / "k7_residual.json").write_text(json.dumps(
        {"card": card.strip(), "cases": cases}))


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:2]))
