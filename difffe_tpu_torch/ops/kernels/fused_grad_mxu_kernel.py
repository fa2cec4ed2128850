"""Kernel K7: the scalar-κ 1D grad step as two dense products with W = Ã⁻¹.

PyTorch counterpart of ``difffe_tpu/ops/pallas/fused_grad_mxu_kernel.py``.
For one scalar κ per scenario the Dirichlet-eliminated system factors
exactly as T̃(κ) = D_κ Ã with D_κ = diag(m + κ·p) and Ã = T̃(κ = 1), so with
W = Ã⁻¹ computed once per mesh (in float64 on the host, then cast)

    u = W (D_κ⁻¹ r),   λ = W (D_κ⁻¹ ḡ)        (T̃ symmetric)

and the step is elementwise work around two (n × n)·(n × B) products.  The
bodies of the JAX module are kept as ``version``:

* 1 — explicit right-hand side and the four-term κ contraction;
* 2 — the folded right-hand side D_κ⁻¹r = (m g − t₀) + κ⁻¹ p F, and
  ∂log κ = −scale · Σ λ ⊙ p F;
* 3 — version 2 with ``refine`` tridiagonal residual passes per solve,
  u ← u + W (y − T̃₁ u), each residual formed in float64 and rounded once
  (mixed-precision refinement), so the passes converge to the solution of
  the float32 system; a float32 residual, as the TPU body forms it, would
  add rounding noise of the size it removes
  (``difffe_tpu_torch/probes/k7_residual.py`` measures both on the card).
  On the "tc" route, as on the TPU, the passes repair single-pass bf16
  products; on the CPU and the "fma" route every product is exact or full
  precision, and they repair the rounding of W.

The CUDA kernel (``csrc/fused_grad_mxu.cu``) has two routes, which
:func:`k7_plan` picks from the dtype and n:

* ``"tc"`` (float32, n ≤ 32, padded to 16 or 32 rows): the products on the
  tensor cores, one warp a tile of 16 scenarios (``csrc/mma_frag.cuh``):
  3xTF32 for versions 1-2, the counterpart of the TPU's ``HIGHEST``
  multi-pass products; single-pass bf16 for version 3, the TPU's
  ``DEFAULT`` products, which its float64-residual refinement passes
  repair;
* ``"fma"`` (float64, and 32 < n ≤ ``MXU_MAX_NODES``): the first design,
  W in shared memory and one scenario a thread, each product a running sum
  of full-precision fused multiply-adds.

The plain PyTorch version below, taken only for CPU tensors, uses
``torch.matmul`` with exact products; ``products="tf32x3"`` or ``"bf16"``
round the products' operands as the ``"tc"`` route's tensor cores do, and
that is the version the card holds the route against.  ``"tf32"`` (one
TF32 pass) emulates version 3's measured alternative, which no kernel
runs (PERF.md §5 has its error by refinement pass).
Meshes above ``MXU_MAX_NODES`` nodes go to kernel K5a
(``fused_grad_kernel.fused_kappa_mse_step``), as in the JAX module.  The
TPU's probe-only ablation switches (``_V2_PRECISION``,
``_V2_SKIP_MATMUL``) are not carried over: K7's ablations, the port of the
TPU probe ``scripts/probe_mxu_kernel.py``, are kernels of their own
(``difffe_tpu_torch/probes/k7_ablation.py``, ``csrc/k7_ablation.cu``).
The step is one ``torch.library`` op, ``difffe::fused_mxu``, live and
traced (``_build.kernel_op``): the kernel on CUDA tensors, its route
planned from the shape at call time (``plan`` forces "tc" or "fma"), the
plain version with exact products on CPU tensors.
Not differentiable: it is the gradient step.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import fused_grad_kernel as _k5
from ._build import kernel_op
from ..tridiag import _shift_down, _shift_up
from .fused_grad_kernel import (_as_dtype, _check_block_lanes,
                                _check_planes, _plane, check_cuda,
                                mesh_constants, rows_view, scalar_columns,
                                storage_code)

# Largest mesh the dense-inverse path takes before routing to K5a (the JAX
# module's cutoff: its matmul parity was validated up to N ≈ 136, and W
# grows as n²).
MXU_MAX_NODES = 136

#: Nodes the "tc" route takes (W^T padded to 16 or 32 rows and columns).
TC_MAX_NODES = 32
#: The "tc" route's products by version (``csrc/mma_frag.cuh``).
TC_PRODUCTS = {1: "tf32x3", 2: "tf32x3", 3: "bf16"}
#: How the plain version forms its products: exactly, or with the operands
#: rounded as the tensor cores take them.
PRODUCTS = ("exact", "tf32x3", "tf32", "bf16")

#: Kernel launches made by the wrapper, by route: "k7" on the "tc" route,
#: "k7_fma" on the "fma" route.
launches = {"k7": 0, "k7_fma": 0}


def k7_plan(dtype, n: int, version: int) -> str:
    """The route of a K7 step, from the shape alone: ``"tc"`` for float32
    with n ≤ ``TC_MAX_NODES``, ``"fma"`` for float64 and for
    32 < n ≤ ``MXU_MAX_NODES``, and ``"k5a"`` (kernel K5a, as the JAX
    module routes) above.  ``version`` is part of the key because the card
    decides the route of each body (PERF.md §5 has the times)."""
    if version not in (1, 2, 3):
        raise ValueError(f"version must be 1, 2 or 3, got {version}")
    if n > MXU_MAX_NODES:
        return "k5a"
    return "tc" if dtype == torch.float32 and n <= TC_MAX_NODES else "fma"


def _inverse(mesh) -> torch.Tensor:
    """W = Ã⁻¹ of the unit-κ eliminated system, inverted in float64 on the
    host and cast to the mesh dtype, on the mesh's device."""
    m, _, d0, _, c0 = scalar_columns(mesh)[:5].cpu().numpy().astype(
        np.float64)
    e = c0[:-1]
    A = np.diag(m + d0) + np.diag(e, 1) + np.diag(e, -1)
    return torch.as_tensor(np.linalg.inv(A), dtype=mesh.dtype,
                           device=mesh.device).contiguous()


def mxu_inverse(mesh) -> torch.Tensor:
    """Cached :func:`_inverse` of ``mesh``."""
    return mesh_constants(mesh, "mxu_inverse", _inverse)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` rounds the float32
    value: to nearest, ties away from zero, the 13 low bits cleared; in
    ``x``'s dtype."""
    b = x.float().contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32).to(x.dtype)


def _split(x: torch.Tensor):
    """x = hi + lo as a 3xTF32 product splits its operand."""
    hi = _tf32(x)
    return hi, _tf32((x.float() - hi.float()).to(x.dtype))


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16 (to nearest even) through float32."""
    return x.float().bfloat16().to(x.dtype)


def _product(products: str, y: torch.Tensor, W: torch.Tensor):
    """W y for each row y of (B, n) with the operands rounded as
    ``products`` says: 3xTF32's three split products (lo·hi first, as the
    tensor cores accumulate them), one TF32 or bf16 pass, or exact."""
    if products == "tf32x3":
        (yh, yl), (wh, wl) = _split(y), _split(W)
        return yl @ wh.T + yh @ wl.T + yh @ wh.T
    if products == "tf32":
        return _tf32(y) @ _tf32(W).T
    if products == "bf16":
        return _bf16(y) @ _bf16(W).T
    return y @ W.T


def rule_slack(products: str, n: int) -> float:
    """The additive term of phase 7's rule (chip_smoke.py) for a float32
    step whose products are ``products`` at n nodes: 1e-6, and for
    single-pass products also one rounding step of one of the n operands
    of a product, 2^-8/n for bf16 and 2^-11/n for TF32.  The kernel and
    its plain version round a product's right-hand side from values that
    differ by an earlier f32 summation, so an element near a rounding
    boundary can round up in one and down in the other (measured on the
    card for K7's ablation C: 1 of 160 cases at B = 1000 missed the rule
    with 1e-6 alone)."""
    step = {"bf16": 2.0 ** -8, "tf32": 2.0 ** -11}.get(products, 0.0)
    return 1e-6 + step / n


def _k7_plain(log_k, F, ud, cols, W, scale: float, version: int,
              refine: int, products: str = "exact"):
    """Plain version of K7 on (B, n) rows: (loss (B,), ∂log κ (B,)).
    ``products`` (:data:`PRODUCTS`) rounds the operands of every product
    with W as the "tc" route's tensor cores do; "exact" is the CPU path's
    and the "fma" route's."""
    if products not in PRODUCTS:
        raise ValueError(f"products must be one of {PRODUCTS}, got "
                         f"{products!r}")
    m, p, d0, a0, c0, mg, t0, rhs0 = cols
    dtype = cols.dtype
    f, ud = F.to(dtype), ud.to(dtype)
    kappa = torch.exp(log_k)[:, None]
    kinv = 1.0 / kappa
    dinv = m + p * kinv

    def solve(y):
        u = _product(products, y, W)
        if version == 3:
            md, a0d, c0d = (m + d0).double(), a0.double(), c0.double()
            for _ in range(refine):
                # the residual y − T̃₁u in float64, rounded once
                u64 = u.double()
                T1u = (md * u64 + a0d * _shift_up(u64, 1, 0.0)
                       + c0d * _shift_down(u64, 1, 0.0))
                u = u + _product(products, (y.double() - T1u).to(dtype), W)
        return u

    if version == 1:
        r = mg + p * f - kappa * t0
        u = solve(dinv * r)
        diff = u - ud
        lam = solve(dinv * diff)
        u_im1, u_ip1 = _shift_up(u, 1, 0.0), _shift_down(u, 1, 0.0)
        gk = -(lam * (t0 + a0 * u_im1 + d0 * u + c0 * u_ip1)).sum(-1)
        return (diff * diff).sum(-1), (scale * kappa[:, 0]) * gk
    pf = p * f
    u = solve(rhs0 + kinv * pf)
    diff = u - ud
    lam = solve(dinv * diff)
    return (diff * diff).sum(-1), -scale * (lam * pf).sum(-1)


def _cuda_fma(log_k, F, ud, cols, W, scale: float, version: int,
              refine: int, block_lanes: int):
    """K7 on the "fma" route."""
    from ._build import load_library

    dtype, dev = log_k.dtype, log_k.device
    check_cuda(dtype, dev, "K7", F, ud, cols, W)
    B, n = log_k.shape[0], ud.shape[-1]
    lk, sL = rows_view(log_k[:, None], 1)
    F, sF = rows_view(F, n)
    ud, sU = rows_view(ud, n)
    f_code = storage_code(F, dtype, "F")
    u_code = storage_code(ud, dtype, "u_data")
    loss = torch.empty(B, dtype=dtype, device=dev)
    grad = torch.empty(B, dtype=dtype, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.difffe_fused_mxu(
            lk.data_ptr(), sL, F.data_ptr(), sF, f_code, ud.data_ptr(), sU,
            u_code, cols.data_ptr(), W.data_ptr(), loss.data_ptr(),
            grad.data_ptr(), B, n, block_lanes, version, refine,
            float(scale), int(dtype == torch.float64), stream)
    if rc != 0:
        raise RuntimeError(f"K7 fused_mxu launch failed: CUDA error {rc}")
    launches["k7_fma"] += 1
    return loss, grad


def _cuda_tc(log_k, F, ud, cols, W, scale: float, version: int,
             refine: int):
    """K7 on the "tc" route (float32, n ≤ 32), with the version's products
    (:data:`TC_PRODUCTS`)."""
    from ._build import load_library

    dtype, dev = log_k.dtype, log_k.device
    check_cuda(dtype, dev, "K7", F, ud, cols, W)
    B, n = log_k.shape[0], ud.shape[-1]
    if dtype != torch.float32 or n > TC_MAX_NODES:
        raise TypeError(f"K7's tc route takes float32 and at most "
                        f"{TC_MAX_NODES} nodes, got {dtype} and {n}")
    lk, sL = rows_view(log_k[:, None], 1)
    F, sF = rows_view(F, n)
    ud, sU = rows_view(ud, n)
    f_code = storage_code(F, dtype, "F")
    u_code = storage_code(ud, dtype, "u_data")
    loss = torch.empty(B, dtype=dtype, device=dev)
    grad = torch.empty(B, dtype=dtype, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.difffe_fused_mxu_tc(
            lk.data_ptr(), sL, F.data_ptr(), sF, f_code, ud.data_ptr(), sU,
            u_code, cols.data_ptr(), W.data_ptr(), loss.data_ptr(),
            grad.data_ptr(), B, n, version, refine, float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"K7 fused_mxu launch failed (tc route): CUDA "
                           f"error {rc}")
    launches["k7"] += 1
    return loss, grad


def _cuda_mxu(log_k, F, ud, cols, W, scale, version, refine, block_lanes,
              plan):
    """K7 on CUDA tensors, the op's CUDA implementation: the route of
    :func:`k7_plan` at call time, or ``plan`` ("tc" or "fma")."""
    route = plan or k7_plan(log_k.dtype, ud.shape[-1], version)
    if route == "tc":
        return _cuda_tc(log_k, F, ud, cols, W, scale, version, refine)
    if route != "fma":
        raise ValueError(f"K7 runs the 'tc' or 'fma' route, got {route!r} "
                         f"(meshes above {MXU_MAX_NODES} nodes take K5a)")
    return _cuda_fma(log_k, F, ud, cols, W, scale, version, refine,
                     block_lanes)


def _mxu_cpu(log_k, F, ud, cols, W, scale, version, refine, block_lanes,
             plan):
    B, n = log_k.shape[0], ud.shape[-1]
    return _k7_plain(log_k, F, ud.expand(B, n), cols, W, scale, version,
                     refine)


#: K7 as the op ``difffe::fused_mxu(log_k, F, ud, cols, W, scale, version,
#: refine, block_lanes, plan)`` → (loss_parts, ∂log κ)
fused_mxu = kernel_op(
    "fused_mxu", "(Tensor log_k, Tensor F, Tensor ud, Tensor cols, "
                 "Tensor W, float scale, int version, int refine, "
                 "int block_lanes, str? plan) -> (Tensor, Tensor)",
    _mxu_cpu, _cuda_mxu,
    lambda log_k, *_: (torch.empty_like(log_k), torch.empty_like(log_k)))


def _launch(log_k, F, ud, cols, W, scale: float, version: int, refine: int,
            block_lanes: int):
    """K7 on the "fma" route, through ``difffe::fused_mxu``."""
    return fused_mxu(log_k, F, ud, cols, W, float(scale), int(version),
                     int(refine), int(block_lanes), "fma")


def _launch_tc(log_k, F, ud, cols, W, scale: float, version: int,
               refine: int):
    """K7 on the "tc" route, through ``difffe::fused_mxu``."""
    return fused_mxu(log_k, F, ud, cols, W, float(scale), int(version),
                     int(refine), 1, "tc")


def fused_kappa_mse_step_mxu(mesh, log_k, F, u_data,
                             scale: Optional[float] = None,
                             block_lanes: int = 1024,
                             operand_dtype=None, version: int = 2,
                             refine: int = 3, plan: Optional[str] = None):
    """Dense-inverse variant of ``fused_kappa_mse_step`` — per-scenario
    scalar κ only (kernel K7).

    Same contract and return values as
    ``fused_grad_kernel.fused_kappa_mse_step``: (loss_parts (B,),
    ∂log κ (B,)) for the objective scale/2 · Σ_b ‖u_b − u_data_b‖², with
    ``scale`` defaulting to 2/(B·n).  ``F`` of shape (n,) is one load
    shared by the batch (read in place, never streamed per scenario);
    ``operand_dtype=torch.bfloat16`` stores the streamed u_data (and a
    per-scenario F) in bf16, with float32 compute — compare against a
    reference fed the same quantized data.  ``version`` 1/2/3 and
    ``refine`` select the body (module note).  Meshes above
    ``MXU_MAX_NODES`` nodes route to K5a, which ignores ``operand_dtype``.
    On the card the step runs on :func:`k7_plan`'s route, or, up to
    ``MXU_MAX_NODES`` nodes, on ``plan`` ("tc" or "fma") where given (the
    tests and chip_smoke.py force each route); ``block_lanes`` caps the
    scenarios a block holds on the "fma" route and changes no result.
    CPU tensors take the plain version with exact products whatever the
    plan.
    """
    if version not in (1, 2, 3):
        raise ValueError(f"version must be 1, 2 or 3, got {version}")
    if int(refine) < 0:
        raise ValueError(f"refine must be >= 0, got {refine}")
    if plan not in (None, "tc", "fma"):
        raise ValueError(f"plan must be 'tc' or 'fma', got {plan!r}")
    dtype, dev = mesh.dtype, mesh.device
    log_k = _as_dtype(log_k, dtype, dev)
    B, n = log_k.shape[0], mesh.n_nodes
    if scale is None:
        scale = 2.0 / (B * n)
    route = k7_plan(dtype, n, version)
    if route == "k5a":
        return _k5.fused_kappa_mse_step(mesh, log_k, F, u_data, scale=scale)
    store = dtype if operand_dtype is None else operand_dtype
    F = torch.as_tensor(F, device=dev)
    F = F.to(dtype) if F.ndim == 1 else _plane(F, dtype, store, dev)
    u_data = _plane(u_data, dtype, store, dev)
    _check_planes(B, n, F, u_data, tuple(log_k.shape), "K7")
    block_lanes = _check_block_lanes(block_lanes)
    cols, W = scalar_columns(mesh), mxu_inverse(mesh)
    with torch.no_grad():
        return fused_mxu(log_k, F, u_data, cols, W, float(scale), version,
                         int(refine), block_lanes, plan)
