"""Probe: what two choices of K5's warp route are worth on the card.

The package's warp route (``fused_pcr_warp_kernel`` in
``csrc/fused_grad_pcr.cu``) keeps a zero dividend out of the IEEE division
(``quot0``) and sums each scenario by a butterfly over the lanes
(``warp_sums``).  This probe builds that source four times:

* ``"package"``: as it is;
* ``"ieee"``: every division through ``quot``, zero dividends included, so
  a warp runs the division's slow path whenever one of its lanes has one
  (rows i < s and i >= n - s have a = 0 or c = 0 in every sweep);
* ``"row_order"``: the sums in row order, (((0 + x_0) + x_1) + ...), as
  the block route takes them: one shuffle a row, lane 0 taking row rho of
  the loss terms from lane rho % 32 while lane 1 takes row rho - 1 of
  K5a's contraction terms from the lane before;
* ``"ieee_row_order"``: both, the warp route as first written,

and times the four in turns at chip_smoke.py's K5 workloads (n = 31: K5a
at B = 2^20 with streamed F, K5b at B = 2^21 with shared F, f32 and bf16
u_data): CUDA events over 20 launches, the best of three rounds.  It checks
that "ieee" gives the package's bits, that the row-order variants' sums
give the block route's bits, and that K5b's gradient (no sum) is the same
on every variant.

Run on a machine with a CUDA card:
    python -m difffe_tpu_torch.probes.k5_warp_variants
It prints one line a workload and writes chiprun_out/k5_warp_variants.json.
"""

from __future__ import annotations

import ctypes
import json
import math
import subprocess
from pathlib import Path

import torch

from ..mesh import FEMesh
from ..ops.assembly import assemble_load
from ..ops.kernels import _build
from ..ops.kernels import fused_grad_kernel as k5
from ..solver import solve_poisson_batched

_QUOT0 = """  const bool z = x == T(0) && b != T(0) && isfinite(b);
  const T q = quot(z ? T(1) : x, b);
  return z ? mul(x, b) : q;
"""
_IEEE = """  return quot(x, b);
"""
_BUTTERFLY = """  T acc1 = T(0), acc2 = T(0);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (32 * k + lane < n) {
      acc1 = add(acc1, t1[k]);
      if (kTwo) acc2 = add(acc2, t2[k]);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    acc1 = add(acc1, __shfl_xor_sync(kFull, acc1, o));
    if (kTwo) acc2 = add(acc2, __shfl_xor_sync(kFull, acc2, o));
  }
  s1 = acc1;
  s2 = acc2;
"""
_ROW_ORDER = """  T acc1 = T(0), acc2 = T(0);
  const int rounds = kTwo ? n + 1 : n;
#pragma unroll
  for (int k = 0; k <= K; ++k) {
    const T cur1 = k < K ? t1[k] : T(0);
    const T cur2 = k < K ? t2[k] : T(0);
    const T prev2 = k > 0 ? t2[k - 1] : T(0);
    for (int q = 0; q < 32; ++q) {
      const int rho = 32 * k + q;
      if (rho >= rounds) break;
      T give = cur1;
      int src = q;
      if (kTwo) {
        if (lane != q) give = q > 0 ? cur2 : prev2;
        if (lane == 1) src = (q + 31) & 31;
      }
      const T v = __shfl_sync(kFull, give, src);
      if (rho < n) acc1 = add(acc1, v);
      if (kTwo && rho >= 1) acc2 = add(acc2, v);
    }
  }
  s1 = acc1;
  s2 = acc2;
"""
VARIANTS = {"package": (), "ieee": ((_QUOT0, _IEEE),),
            "row_order": ((_BUTTERFLY, _ROW_ORDER),),
            "ieee_row_order": ((_QUOT0, _IEEE), (_BUTTERFLY, _ROW_ORDER))}
N = 31
B_K5A, B_K5B = 2 ** 20, 2 ** 21
OUT = Path("chiprun_out") / "k5_warp_variants.json"


def build_variants() -> dict:
    """Each variant's warp entry, built from the edited source on its
    own (one nvcc each, all started together)."""
    src = (_build.CSRC / "fused_grad_pcr.cu").read_text()
    root = _build.BUILD_DIR / "probe_k5_warp"
    cmds, libs = [], {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the block to replace moved in "
                                   f"fused_grad_pcr.cu")
            text = text.replace(old, new)
        out = root / name
        out.mkdir(parents=True, exist_ok=True)
        (out / "fused_grad_pcr.cu").write_text(text)
        (out / "fused_step_common.cuh").write_text(
            (_build.CSRC / "fused_step_common.cuh").read_text())
        libs[name] = out / "libk5.so"
        cmds.append([_build.find_nvcc(), *_build.NVCC_FLAGS,
                     *_build.LINK_FLAGS, "-o", str(libs[name]),
                     str(out / "fused_grad_pcr.cu")])
    _build._run_all(cmds, [])
    entries = {}
    for name, path in libs.items():
        fn = ctypes.CDLL(str(path)).difffe_fused_pcr_warp
        fn.argtypes = _build._SIGNATURES["difffe_fused_pcr_warp"]
        fn.restype = ctypes.c_int
        entries[name] = fn
    return entries


def workloads(dev):
    """chip_smoke.py's phase-19 K5 workloads on FEMesh.line(30), f32."""
    mesh = FEMesh.line(N - 1, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(19)
    fv = torch.sin(math.pi * mesh.nodes[:, 0]) + 1.0
    fB = fv.expand(B_K5B, N)
    with torch.no_grad():
        k_true = 1.0 + 2.0 * torch.rand(B_K5B, generator=gen, device=dev)
        ud_a = solve_poisson_batched(mesh, k_true[:B_K5A], fB[:B_K5A],
                                     method="tridiag", kappa_batched=True)
        ke_true = 1.0 + torch.rand(B_K5B, N - 1, generator=gen, device=dev)
        ud_b = solve_poisson_batched(mesh, ke_true, fB, method="tridiag")
    ke0 = 1.0 + 0.3 * torch.rand(B_K5B, N - 1, generator=gen, device=dev)
    lk0 = torch.zeros(B_K5A, device=dev)
    F1 = assemble_load(mesh, fB[:B_K5A]).contiguous()
    Fs = assemble_load(mesh, fv)
    return mesh, {"k5a": (False, lk0, F1, ud_a.contiguous()),
                  "k5b_f32": (True, ke0, Fs, ud_b),
                  "k5b_bf16": (True, ke0, Fs, ud_b.bfloat16())}


def launch(fn, mesh, general, kap, F, ud):
    """One warp-route step through ``fn``: (loss, gradient)."""
    B = kap.shape[0]
    cols, inv_h = (k5.general_constants(mesh) if general
                   else (k5.scalar_columns(mesh), 0.0))
    loss = torch.empty(B, device=kap.device)
    grad = torch.empty((B, N - 1) if general else (B,), device=kap.device)
    rc = fn(int(general), kap.data_ptr(), kap.stride(0) if general else 1,
            F.data_ptr(), 0 if F.ndim == 1 else F.stride(0),
            int(F.dtype == torch.bfloat16), ud.data_ptr(), ud.stride(0),
            int(ud.dtype == torch.bfloat16), cols.data_ptr(),
            loss.data_ptr(), grad.data_ptr(), B, N, float(inv_h),
            2.0 / N, 0, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"launch failed: CUDA error {rc}")
    return loss, grad


def launch_ms(fn, args, reps=20) -> float:
    for _ in range(3):
        launch(fn, *args)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        launch(fn, *args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("k5_warp_variants: no CUDA card is available")
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    entries = build_variants()
    mesh, work = workloads(dev)
    record = {"card": card, "n": N, "workloads": {}}
    for what, (general, kap, F, ud) in work.items():
        args = (mesh, general, kap, F, ud)
        out = {v: launch(fn, *args) for v, fn in entries.items()}
        step = (k5.fused_kappa_mse_step_general_pcr if general
                else k5.fused_kappa_mse_step)
        op = {"operand_dtype": torch.bfloat16} if ud.dtype == \
            torch.bfloat16 else {}
        block = step(mesh, kap, F, ud, scale=2.0 / N, plan="block", **op)
        for a, b in ((out["ieee"], out["package"]),
                     (out["ieee_row_order"], out["row_order"]),
                     (out["row_order"], block)):
            if not all(torch.equal(x, y) for x, y in zip(a, b)):
                raise AssertionError(f"{what}: variants differ in bits")
        if general and not all(torch.equal(o[1], block[1])
                               for o in out.values()):
            raise AssertionError(f"{what}: K5b's gradients differ")
        diff = max(float((x - y).abs().max() / y.abs().max())
                   for x, y in zip(out["package"], block))
        best = {v: float("inf") for v in entries}
        order = list(entries) + list(entries)[::-1] + list(entries)
        for v in order:
            best[v] = min(best[v], launch_ms(entries[v], args))
        record["workloads"][what] = {"batch": kap.shape[0], "ms": best,
                                     "package_vs_block_rel": diff}
        print(f"{what} (n={N}, B={kap.shape[0]}): "
              + ", ".join(f"{v} {t:.4f} ms" for v, t in best.items())
              + f"; the package's sums vs the block route's: rel {diff:.3e}"
              f" [{card}]", flush=True)
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
