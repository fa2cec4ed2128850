"""Kernel K6: the fused per-element-κ 1D grad step by Thomas elimination.

PyTorch counterpart of ``difffe_tpu/ops/pallas/fused_grad_thomas_kernel.py``.
The contract is K5b's (``fused_grad_kernel.fused_kappa_mse_step_general_pcr``):
κ_e (B, n_elements), F (B, n) or shared (n,), u_data (B, n) → (loss_parts
(B,), ∂κ (B, n_elements)), on a uniform mesh.  The two solves, forward and
adjoint, share ONE factorization: the sweep factors (c′_i, 1/b′_i) are
computed once and each solve is forward and back substitution.

The CUDA kernel (``csrc/fused_grad_thomas.cu``) runs one scenario per
thread on one of two routes, which :func:`k6_plan` picks from n and the
dtype:

* ``"reg"`` (float32, n ≤ ``K6_REG_MAX_NODES``): the rows in registers
  (the body compiled for a 16- or 32-row bucket, every row loop
  unrolled), the mesh's rows in the kernel's parameters, each warp's 32
  scenarios staged by 16-byte ``cp.async`` into its own shared memory,
  double buffered, on a persistent grid;
* ``"block"`` otherwise (float64, longer meshes): the first design, a
  block's scenarios transposed through shared memory (or a global
  workspace past its fit).

Both make the same operations in the same order, so they give the same
bits; launches count as "k6", and by route in ``route_launches``.  The
plain PyTorch version below runs the same row recurrences on (B,) vectors
and is taken only for CPU tensors.  The TPU's (N, 8, B/8) packing and its
SMEM constant columns have no counterpart: the kernel reads the caller's
(B, n) rows.  ``block_lanes`` caps the scenarios a thread block holds on
the block route.  The step is one ``torch.library`` op,
``difffe::fused_thomas``, live and traced (``_build.kernel_op``): the
kernel on CUDA tensors, its route planned from the shape at call time
(``plan`` forces one), the plain version on CPU tensors; the reg route's
mesh rows reach it as a host tensor.  Not differentiable: it is the
gradient step, and its outputs never require grad.
"""

from __future__ import annotations

from typing import Optional

import torch

from ._build import kernel_op
from .fused_grad_kernel import (_as_dtype, _check_block_lanes, _check_planes,
                                _plane, check_cuda, general_constants,
                                mesh_constants, rows_view, storage_code)

#: Kernel launches made by the wrapper (both routes).
launches = {"k6": 0}
#: The same launches by route.
route_launches = {"reg": 0, "block": 0}
#: Largest mesh the reg route takes: its larger row bucket, 32 rows, where
#: the factors and rows of a float32 scenario fit a thread's registers
#: without spilling at three blocks an SM (PERF.md §5).
K6_REG_MAX_NODES = 32


def k6_plan(n: int, dtype: torch.dtype, plan: Optional[str] = None) -> str:
    """K6's route for meshes of n nodes in ``dtype``: ``"reg"`` for float32
    with n ≤ ``K6_REG_MAX_NODES``, ``"block"`` otherwise; ``plan`` forces
    either and is refused where the reg route cannot take the shape."""
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the CUDA K6 kernel computes in float32 or "
                        f"float64, got {dtype}")
    if n < 2:
        raise ValueError(f"K6 needs n >= 2 nodes, got {n}")
    reg = dtype == torch.float32 and n <= K6_REG_MAX_NODES
    if plan is None:
        return "reg" if reg else "block"
    if plan not in ("reg", "block"):
        raise ValueError(f"K6 plan must be 'reg' or 'block', got {plan!r}")
    if plan == "reg" and not reg:
        raise ValueError(f"K6's reg route takes float32 and at most "
                         f"{K6_REG_MAX_NODES} nodes, got {dtype} and "
                         f"n = {n}")
    return plan


def _host_rows(mesh) -> torch.Tensor:
    """The (3, n) rows (m, p, m g) in host memory, cached per mesh: the reg
    route passes them in its kernel's parameters."""
    return mesh_constants(mesh, "k6_host_rows",
                          lambda m: general_constants(m)[0].cpu()
                          .contiguous())


def _k6_plain(kappa_e, F, ud, cols, inv_h: float, scale: float):
    """Plain version of K6: Thomas on (B,) rows → (loss (B,), ∂κ (B, ne))."""
    m, p, mg = (c.unbind() for c in cols[:3])
    B, n = ud.shape
    dtype = kappa_e.dtype
    zero = kappa_e.new_zeros(B)

    def ke(i):
        return kappa_e[:, i] if i < n - 1 else zero

    def f(i):
        return F[i] if F.ndim == 1 else F[:, i].to(dtype)

    def a_row(i):               # a_i = e_{i−1} = −κ_{i−1}/h · p_{i−1} p_i
        return ke(i - 1) * (-inv_h * p[i - 1] * p[i])

    def r_row(i):
        ke_prev = ke(i - 1) if i > 0 else zero
        mg_next = mg[i + 1] if i < n - 1 else 0.0
        mg_prev = mg[i - 1] if i > 0 else 0.0
        Kmg = ((ke_prev + ke(i)) * mg[i] - ke(i) * mg_next
               - ke_prev * mg_prev) * inv_h
        return mg[i] + p[i] * (f(i) - Kmg)

    # the factorization: cp_i = c′_i, bi_i = 1/b′_i
    bi = [1.0 / (m[0] + p[0] * ke(0) * inv_h)]
    cp = []
    for i in range(1, n):
        d_i = m[i] + p[i] * (ke(i - 1) + ke(i)) * inv_h
        cp.append(a_row(i) * bi[i - 1])
        bi.append(1.0 / (d_i - a_row(i) * cp[i - 1]))

    def solve(rhs):
        y = [rhs(0) * bi[0]]
        for i in range(1, n):
            y.append((rhs(i) - a_row(i) * y[i - 1]) * bi[i])
        for i in range(n - 2, -1, -1):
            y[i] = y[i] - cp[i] * y[i + 1]
        return y

    u = solve(r_row)
    loss = zero
    for i in range(n):
        d = u[i] - ud[:, i].to(dtype)
        loss = loss + d * d
    lam = solve(lambda i: scale * (u[i] - ud[:, i].to(dtype)))
    grad = [-inv_h * (p[e] * lam[e] - p[e + 1] * lam[e + 1])
            * ((mg[e] + p[e] * u[e]) - (mg[e + 1] + p[e + 1] * u[e + 1]))
            for e in range(n - 1)]
    return loss, torch.stack(grad, dim=1)


def _cuda_thomas(kappa_e, F, ud, cols, host_rows, inv_h: float,
                 scale: float, block_lanes: int, plan: Optional[str]):
    """K6 on CUDA tensors, the op's CUDA implementation; ``host_rows`` is
    the (3, n) rows (m, p, m g) in host memory, which the reg route passes
    in its kernel's parameters."""
    from ._build import load_library

    dtype, dev = kappa_e.dtype, kappa_e.device
    check_cuda(dtype, dev, "K6", F, ud, cols)
    B, n = kappa_e.shape[0], ud.shape[-1]
    route = k6_plan(n, dtype, plan)
    kap, sK = rows_view(kappa_e, n - 1)
    F, sF = rows_view(F, n)
    ud, sU = rows_view(ud, n)
    f_code = storage_code(F, dtype, "F")
    u_code = storage_code(ud, dtype, "u_data")
    loss = torch.empty(B, dtype=dtype, device=dev)
    grad = torch.empty((B, n - 1), dtype=dtype, device=dev)
    lib = load_library()
    is_double = int(dtype == torch.float64)
    operands = (kap.data_ptr(), sK, F.data_ptr(), sF, f_code, ud.data_ptr(),
                sU, u_code)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if route == "reg":
            if host_rows.device.type != "cpu":     # an artifact moved
                host_rows = host_rows.cpu()
            rc = lib.difffe_fused_thomas_reg(
                *operands, host_rows.contiguous().data_ptr(),
                loss.data_ptr(),
                grad.data_ptr(), B, n, float(inv_h), float(scale), stream)
        else:
            words = lib.difffe_thomas_workspace(B, n, block_lanes, is_double)
            ws = (torch.empty(words, dtype=dtype, device=dev) if words > 0
                  else None)
            rc = lib.difffe_fused_thomas(
                *operands, cols.data_ptr(), loss.data_ptr(), grad.data_ptr(),
                None if ws is None else ws.data_ptr(), B, n, block_lanes,
                float(inv_h), float(scale), is_double, stream)
    if rc != 0:
        raise RuntimeError(f"K6 fused_thomas launch failed ({route} route): "
                           f"CUDA error {rc}")
    launches["k6"] += 1
    route_launches[route] += 1
    return loss, grad


def _thomas_cpu(kappa_e, F, ud, cols, host_rows, inv_h, scale, block_lanes,
                plan):
    B, n = kappa_e.shape[0], ud.shape[-1]
    return _k6_plain(kappa_e, F.expand(B, n) if F.ndim == 2 else F,
                     ud.expand(B, n), cols, inv_h, scale)


#: K6 as the op ``difffe::fused_thomas(kappa_e, F, ud, cols, host_rows,
#: inv_h, scale, block_lanes, plan)`` → (loss_parts, grad)
fused_thomas = kernel_op(
    "fused_thomas", "(Tensor kappa_e, Tensor F, Tensor ud, Tensor cols, "
                    "Tensor host_rows, float inv_h, float scale, "
                    "int block_lanes, str? plan) -> (Tensor, Tensor)",
    _thomas_cpu, _cuda_thomas,
    lambda kappa_e, *_: (kappa_e.new_empty(kappa_e.shape[0]),
                         torch.empty_like(kappa_e)))


def _launch(mesh, kappa_e, F, ud, cols, inv_h: float, scale: float,
            block_lanes: int, plan: Optional[str]):
    """K6 through ``difffe::fused_thomas``."""
    return fused_thomas(kappa_e, F, ud, cols, _host_rows(mesh), float(inv_h),
                        float(scale), int(block_lanes), plan)


def fused_kappa_mse_step_general(mesh, kappa_e, F, u_data,
                                 scale: Optional[float] = None,
                                 block_lanes: int = 512,
                                 operand_dtype=None,
                                 plan: Optional[str] = None):
    """Fused loss-partials + ∂κ for per-element-κ 1D inversion (kernel K6).

    For every scenario b with per-element field κ_b (n_elements,):
    assemble T(κ_b), solve, MSE against u_data, adjoint through the SAME
    Thomas factorization, per-element gradient in closed form:

        loss_parts[b] = Σ_i (u_b − u_data_b)_i²
        grad[b]       = ∂/∂κ_b of  scale/2 · Σ_b loss_parts[b]

    κ_e: (B, n_elements); F: (B, n) or shared (n,) assembled load;
    u_data: (B, n).  Returns (loss_parts (B,), grad (B, n_elements)).
    ``operand_dtype=torch.bfloat16`` stores the streamed F and u_data
    planes in bf16 (a shared F stays in the mesh dtype); κ and all solve
    state stay in the mesh dtype.  Requires a uniform mesh.  On the card
    the step runs on :func:`k6_plan`'s route, or on ``plan`` ("reg" or
    "block") where given, which raises where the route cannot take the
    shape; ``block_lanes`` caps the scenarios a block holds on the block
    route and changes no result.  CPU tensors take the plain version
    whatever the plan.  Not differentiable: it is the gradient step.
    """
    dtype, dev = mesh.dtype, mesh.device
    cols, inv_h = general_constants(mesh)
    kappa_e = _as_dtype(kappa_e, dtype, dev)
    B, n = kappa_e.shape[0], mesh.n_nodes
    if tuple(kappa_e.shape) != (B, mesh.n_elements):
        raise ValueError(f"K6: κ_e must be (B, n_elements), got "
                         f"{tuple(kappa_e.shape)}")
    store = dtype if operand_dtype is None else operand_dtype
    F = torch.as_tensor(F, device=dev)
    F = F.to(dtype) if F.ndim == 1 else _plane(F, dtype, store, dev)
    u_data = _plane(u_data, dtype, store, dev)
    _check_planes(B, n, F, u_data, tuple(kappa_e.shape), "K6")
    block_lanes = _check_block_lanes(block_lanes)
    if scale is None:
        scale = 2.0 / (B * n)
    with torch.no_grad():
        return _launch(mesh, kappa_e, F, u_data, cols, inv_h, scale,
                       block_lanes, plan)
