"""Kernels K5a and K5b: the whole 1D κ-recovery gradient step, fused, by
parallel cyclic reduction.

PyTorch counterpart of ``difffe_tpu/ops/pallas/fused_grad_kernel.py``.  Per
scenario b, with T(κ) the Dirichlet-eliminated 1D P1 stiffness system and
F̃(κ) its eliminated load,

    solve T u = F̃;   ℓ_b = Σ_i (u − u_data)_i²;
    solve T λ = scale·(u − u_data);   ∂κ = λᵀ(∂F̃/∂κ − ∂T/∂κ · u)

in one launch: band assembly, forward PCR, the loss partials, the adjoint
solve by replaying the forward sweeps' (α, γ) factors (they depend on T
only), and the κ contraction.

* K5a, :func:`fused_kappa_mse_step`: one scalar log κ per scenario; the
  bands are κ times the unit-κ pattern rows of the mesh (below);
  returns (loss_parts (B,), ∂log κ (B,)).
* K5b, :func:`fused_kappa_mse_step_general_pcr`: per-element κ (B,
  n_elements) on a uniform mesh, bands assembled from κ in the kernel;
  returns (loss_parts (B,), ∂κ (B, n_elements)).

Each has two implementations behind one wrapper: the CUDA kernel in
``csrc/fused_grad_pcr.cu``, launched for CUDA tensors, and the plain
PyTorch version below, taken only for CPU tensors and the reference the
kernel is checked against.  The kernel has two routes; ``k5_plan(n,
dtype)`` picks one:

* ``"warp"`` for n ≤ ``K5_WARP_MAX_ROWS`` (128): one warp a scenario, its
  rows striped over the lanes' registers with every sweep's factors,
  neighbours by shuffles, no shared memory and no block barrier, each sum
  a butterfly over the lanes.  On an H100 it led the block route at every
  point chip_smoke.py's phase 20 measures (n = 31, 33, 64, 96, 128 by
  B = 7 to 65 536), so the batch does not enter the plan;
* ``"block"`` otherwise, up to one block's shared memory (n ≤ 8192): a
  thread block holds ``spb`` whole scenarios and runs the sweeps in shared
  memory, the factors beside them or in a global workspace, each sum in
  row order (the first design).

Every row value (u, λ, K5b's gradient) has the same bits on both routes;
the per-scenario sums (the loss, K5a's gradient) differ by rounding.

Both count their launches as "k5a" or "k5b" (``route_launches`` splits
them by route).  Operands stay in the caller's layout: (B, n) row-major
planes, a shared load (n,) read with batch stride 0; nothing is padded or
transposed per call.  The TPU's ``block_lanes`` (its lane block) caps the
scenarios a thread block holds on the block route.  The mesh-derived
constant columns are built once per mesh and dtype
(:func:`mesh_constants`).

Neither step is differentiable: each *is* a gradient step, and its outputs
never require grad.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..tridiag import _shift_down, _shift_up

#: Kernel launches made by the wrappers, by kernel (both routes).
launches = {"k5a": 0, "k5b": 0}
#: The same launches by route.
route_launches = {"warp": 0, "block": 0}
#: Largest system the warp route takes (4 register slots of 32 rows).
K5_WARP_MAX_ROWS = 128

# The (8, n) scalar-κ constants block, rows (csrc/fused_grad_pcr.cu and
# csrc/fused_grad_mxu.cu read the same layout): the Dirichlet mask m;
# p = 1 − m; d0 = p ⊙ the unit-κ diagonal; a0 and c0, the sub- and
# super-diagonal unit-κ patterns (row i couples to i − 1 and i + 1);
# mg = m ⊙ g, the Dirichlet data; t0 = p ⊙ T_unit(m ⊙ g), the κ-linear
# elimination term; rhs0 = mg − t0 (K7's folded right-hand side).  The
# per-element-κ block is (3, n): m, p, mg.

# Rows a K5 thread block aims at (spb · n), as K2.
_ROWS = 512

def mesh_constants(mesh, name: str, build):
    """``build(mesh)``, computed once per mesh and ``name`` and kept on the
    mesh (``FEMesh.derived``), so a loop of steps copies nothing to the
    card after its first call.  The mesh's tensors must not be edited in
    place after."""
    if name not in mesh.derived:
        mesh.derived[name] = build(mesh)
    return mesh.derived[name]


def _sweeps(n: int) -> int:
    return max(1, math.ceil(math.log2(n)))


def k5_plan(n: int, dtype: torch.dtype, plan=None) -> str:
    """K5's route for systems of n nodes in ``dtype``: ``"warp"`` for n ≤
    ``K5_WARP_MAX_ROWS``, ``"block"`` otherwise; ``plan`` forces either
    and is refused where the warp route cannot hold the system."""
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the CUDA K5 kernel computes in float32 or "
                        f"float64, got {dtype}")
    if n < 2:
        raise ValueError(f"K5 needs n >= 2 nodes, got {n}")
    if plan is None:
        return "warp" if n <= K5_WARP_MAX_ROWS else "block"
    if plan not in ("warp", "block"):
        raise ValueError(f"K5 plan must be 'warp' or 'block', got {plan!r}")
    if plan == "warp" and n > K5_WARP_MAX_ROWS:
        raise ValueError(f"K5's warp route holds at most {K5_WARP_MAX_ROWS} "
                         f"nodes a system, got n = {n}")
    return plan


def _scalar_columns(mesh) -> torch.Tensor:
    """The (8, n) unit-κ constants block of K5a and K7 (layout above)."""
    from ..assembly import assemble_tridiag_1d
    from ..tridiag import tridiag_matvec

    dtype = mesh.dtype
    d_unit, e_unit = assemble_tridiag_1d(
        mesh, torch.ones((), dtype=dtype, device=mesh.device))
    m = mesh.bc_mask
    p = 1.0 - m
    mg = m * mesh.bc_values
    e_elim = p[:-1] * p[1:] * e_unit
    zero1 = torch.zeros(1, dtype=dtype, device=mesh.device)
    a0 = torch.cat([zero1, e_elim])
    c0 = torch.cat([e_elim, zero1])
    d0 = p * d_unit
    t0 = p * tridiag_matvec(d_unit, e_unit, mg)
    return torch.stack([m, p, d0, a0, c0, mg, t0, mg - t0]).contiguous()


def scalar_columns(mesh) -> torch.Tensor:
    """Cached :func:`_scalar_columns` of ``mesh``."""
    return mesh_constants(mesh, "scalar_columns", _scalar_columns)


def _general_constants(mesh):
    h_all = np.diff(mesh.nodes[:, 0].detach().cpu().numpy().astype(
        np.float64))
    h = float(np.mean(h_all))
    uniform = bool(np.allclose(h_all, h, rtol=1e-4))
    m = mesh.bc_mask
    cols = torch.stack([m, 1.0 - m, m * mesh.bc_values]).contiguous()
    return cols, 1.0 / h, uniform


def general_constants(mesh):
    """(cols (3, n): m, p, m ⊙ g; 1/h) of a uniform line mesh, cached; a
    mesh whose element widths differ by more than 1e-4 relative raises
    ``ValueError``, as the JAX kernels do."""
    cols, inv_h, uniform = mesh_constants(mesh, "general_constants",
                                          _general_constants)
    if not uniform:
        raise ValueError("fused general-κ kernel requires a uniform mesh")
    return cols, inv_h


def _check_block_lanes(block_lanes: int) -> int:
    if int(block_lanes) < 1:
        raise ValueError(f"block_lanes must be >= 1, got {block_lanes}")
    return int(block_lanes)


def _as_dtype(x, dtype, device) -> torch.Tensor:
    return torch.as_tensor(x, device=device).to(dtype)


def _plane(x, dtype, store, device) -> torch.Tensor:
    """A streamed (B, n) plane as the kernel stores it: cast to the mesh
    dtype, then to ``store`` (the JAX wrappers' order), with no copy when
    it already has that dtype."""
    x = torch.as_tensor(x, device=device)
    if x.dtype == store:
        return x
    return x.to(dtype).to(store)


def _check_planes(B: int, n: int, F, u_data, kappa_shape, what: str):
    if F.shape not in ((n,), (1, n), (B, n)):
        raise ValueError(f"{what}: F must be (n,) or (B, n) with n = {n}, "
                         f"B = {B}, got {tuple(F.shape)}")
    if tuple(u_data.shape) not in ((B, n), (1, n)):
        raise ValueError(f"{what}: u_data must be (B, n) = {(B, n)}, got "
                         f"{tuple(u_data.shape)}")
    if B < 1:
        raise ValueError(f"{what}: κ of shape {kappa_shape} holds no "
                         f"scenario")


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU path and reference)
# ---------------------------------------------------------------------------


def _pcr_forward(a, b, c, r, steps: int):
    """Forward PCR keeping each sweep's (α, γ): (u, final b, factors)."""
    factors = []
    s = 1
    for _ in range(steps):
        b_up, b_dn = _shift_up(b, s, 1.0), _shift_down(b, s, 1.0)
        alpha = -a / b_up
        gamma = -c / b_dn
        a_up, c_dn = _shift_up(a, s, 0.0), _shift_down(c, s, 0.0)
        c_up, a_dn = _shift_up(c, s, 0.0), _shift_down(a, s, 0.0)
        r_up, r_dn = _shift_up(r, s, 0.0), _shift_down(r, s, 0.0)
        b = b + alpha * c_up + gamma * a_dn
        r = r + alpha * r_up + gamma * r_dn
        a = alpha * a_up
        c = gamma * c_dn
        factors.append((alpha, gamma))
        s *= 2
    return r / b, b, factors


def _pcr_replay(r, b, factors):
    """The same reduction on another right-hand side: T⁻¹r."""
    s = 1
    for alpha, gamma in factors:
        r = r + alpha * _shift_up(r, s, 0.0) + gamma * _shift_down(r, s, 0.0)
        s *= 2
    return r / b


def _k5a_plain(log_k, F, ud, cols, scale: float):
    """Plain version of K5a on (B, n) rows: (loss (B,), ∂log κ (B,))."""
    m, p, d0, a0, c0, mg, t0 = cols[:7]
    kappa = torch.exp(log_k)[:, None]
    b = m + kappa * d0
    a = kappa * a0
    c = kappa * c0
    r = mg + p * F - kappa * t0
    u, b, factors = _pcr_forward(a, b, c, r, _sweeps(ud.shape[-1]))
    diff = u - ud
    loss = (diff * diff).sum(-1)
    lam = _pcr_replay(scale * diff, b, factors)
    u_im1, u_ip1 = _shift_up(u, 1, 0.0), _shift_down(u, 1, 0.0)
    gk = -(lam * (t0 + a0 * u_im1 + d0 * u + c0 * u_ip1)).sum(-1)
    return loss, kappa[:, 0] * gk


def _k5b_plain(kappa_e, F, ud, cols, inv_h: float, scale: float):
    """Plain version of K5b: (loss (B,), ∂κ (B, n_elements)).  Element row
    i couples nodes (i, i+1); node row n−1 carries no element (κ = 0)."""
    m, p, mg = cols[:3]
    dtype = kappa_e.dtype
    ke = torch.nn.functional.pad(kappa_e, (0, 1))
    ke_prev = _shift_up(ke, 1, 0.0)
    p_next = _shift_down(p, 1, 0.0)
    b = m + p * (ke_prev + ke) * inv_h
    e = -ke * inv_h * p * p_next                # edge i: rows i ↔ i+1
    a = _shift_up(e, 1, 0.0)                    # row i ← i−1
    mg_next, mg_prev = _shift_down(mg, 1, 0.0), _shift_up(mg, 1, 0.0)
    Kmg = ((ke_prev + ke) * mg - ke * mg_next - ke_prev * mg_prev) * inv_h
    r = mg + p * (F.to(dtype) - Kmg)
    u, b, factors = _pcr_forward(a, b, e, r, _sweeps(ud.shape[-1]))
    diff = u - ud.to(dtype)
    loss = (diff * diff).sum(-1)
    lam = _pcr_replay(scale * diff, b, factors)
    # ∂κ_e = −(1/h)(pλ_e − pλ_{e+1})(w_e − w_{e+1}), w = m ⊙ g + p ⊙ u
    w = mg + p * u
    pl = p * lam
    g = -inv_h * (pl - _shift_down(pl, 1, 0.0)) * (w - _shift_down(w, 1, 0.0))
    return loss, g[..., :-1]


# ---------------------------------------------------------------------------
# CUDA kernel wrapper
# ---------------------------------------------------------------------------

def storage_code(x: torch.Tensor, dtype, what: str) -> int:
    """0 when ``x`` is stored in the compute ``dtype``, 1 for bfloat16."""
    if x.dtype == dtype:
        return 0
    if x.dtype == torch.bfloat16:
        return 1
    raise TypeError(f"{what} is stored as {x.dtype}; the kernels take "
                    f"{dtype} or bfloat16")


def rows_view(x: torch.Tensor, k: int):
    """(x with unit stride along its last axis, batch stride): a (k,) or
    (1, k) operand shared by every scenario is read with stride 0."""
    if x.stride(-1) != 1 and k > 1:
        x = x.contiguous()
    if x.ndim == 1 or x.shape[0] == 1:
        return x, 0
    return x, x.stride(0)


def check_cuda(dtype, device, what: str, *tensors):
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the CUDA {what} kernel computes in float32 or "
                        f"float64, got {dtype}")
    for t in tensors:
        if t.device != device:
            raise ValueError(f"{what}: operands on {t.device} and {device}")


def _launch_pcr(general: bool, kap, F, ud, cols, scale: float, inv_h: float,
                block_lanes: int, plan=None):
    from ._build import load_library

    name = "k5b" if general else "k5a"
    dtype, dev = kap.dtype, kap.device
    check_cuda(dtype, dev, name.upper(), F, ud, cols)
    B, n = kap.shape[0], ud.shape[-1]
    route = k5_plan(n, dtype, plan)
    kap, sK = rows_view(kap if general else kap[:, None],
                        kap.shape[-1] if general else 1)
    F, sF = rows_view(F, n)
    ud, sU = rows_view(ud, n)
    f_code = storage_code(F, dtype, "F")
    u_code = storage_code(ud, dtype, "u_data")
    loss = torch.empty(B, dtype=dtype, device=dev)
    grad = torch.empty((B, n - 1) if general else (B,), dtype=dtype,
                       device=dev)
    lib = load_library()
    is_double = int(dtype == torch.float64)
    operands = (int(general), kap.data_ptr(), sK, F.data_ptr(), sF, f_code,
                ud.data_ptr(), sU, u_code, cols.data_ptr(), loss.data_ptr(),
                grad.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if route == "warp":
            rc = lib.difffe_fused_pcr_warp(*operands, B, n, float(inv_h),
                                           float(scale), is_double, stream)
        else:
            spb = max(1, min(block_lanes, _ROWS // n))   # scenarios a block
            words = lib.difffe_fused_pcr_workspace(B, n, spb, is_double)
            if words < 0:
                raise ValueError(f"{name.upper()} holds a whole system in "
                                 f"one block's shared memory: n = {n} rows "
                                 f"do not fit for {dtype}")
            ws = (torch.empty(words, dtype=dtype, device=dev) if words > 0
                  else None)
            rc = lib.difffe_fused_pcr(
                *operands, None if ws is None else ws.data_ptr(), B, n, spb,
                _sweeps(n), float(inv_h), float(scale), is_double, stream)
    if rc != 0:
        raise RuntimeError(f"{name.upper()} fused_pcr launch failed on the "
                           f"{route} route: CUDA error {rc}")
    launches[name] += 1
    route_launches[route] += 1
    return loss, grad


# ---------------------------------------------------------------------------
# Public API (same names and signatures as the JAX module)
# ---------------------------------------------------------------------------


def fused_kappa_mse_step(mesh, log_k, F, u_data,
                         scale: Optional[float] = None,
                         block_lanes: int = 512, plan=None):
    """Fused loss-partials + ∂log κ for per-scenario-scalar-κ recovery
    (kernel K5a).

    For every scenario b, with T(κ_b) the Dirichlet-eliminated 1D P1
    stiffness system (κ_b = exp(log_k[b]) scaling the whole mesh) and
    u_b = T(κ_b)⁻¹ F̃_b:

        loss_parts[b] = Σ_i (u_b − u_data_b)_i²
        grad[b]       = ∂/∂log_k[b] of  scale/2 · Σ_b loss_parts[b]

    so ``scale = 2 / (B · n_nodes)`` (the default) gives the mean MSE.
    ``log_k`` (B,); ``F`` the assembled load (B, n) or shared (n,), before
    elimination; ``u_data`` (B, n).  Returns ``(loss_parts (B,),
    grad_log_k (B,))``.  Not differentiable: it is the gradient step.
    On the card ``plan`` forces a route (:func:`k5_plan`; tests and
    chip_smoke.py); CPU tensors take the plain version whatever the plan.
    """
    dtype, dev = mesh.dtype, mesh.device
    log_k = _as_dtype(log_k, dtype, dev)
    F = _as_dtype(F, dtype, dev)
    u_data = _as_dtype(u_data, dtype, dev)
    B, n = log_k.shape[0], mesh.n_nodes
    _check_planes(B, n, F, u_data, tuple(log_k.shape), "K5a")
    block_lanes = _check_block_lanes(block_lanes)
    if scale is None:
        scale = 2.0 / (B * n)
    cols = scalar_columns(mesh)
    with torch.no_grad():
        if log_k.device.type == "cpu":
            return _k5a_plain(log_k, F, u_data.expand(B, n), cols,
                              float(scale))
        return _launch_pcr(False, log_k, F, u_data, cols, scale, 0.0,
                           block_lanes, plan)


def fused_kappa_mse_step_general_pcr(mesh, kappa_e, F, u_data,
                                     scale: Optional[float] = None,
                                     block_lanes: int = 512,
                                     operand_dtype=None, plan=None):
    """Fused loss-partials + ∂κ for per-element-κ 1D inversion, PCR form
    (kernel K5b).

    κ_e (B, n_elements), F (B, n) or shared (n,), u_data (B, n) →
    (loss_parts (B,), ∂κ (B, n_elements)) for the objective
    scale/2 · Σ_b loss_parts[b].  ``operand_dtype=torch.bfloat16`` stores
    the streamed F and u_data planes in bf16 (a shared F stays in the mesh
    dtype); κ and every solve value stay in the mesh dtype.  Requires a
    uniform mesh (one 1/h).  Not differentiable: it is the gradient step.
    ``plan`` as :func:`fused_kappa_mse_step`'s.
    """
    dtype, dev = mesh.dtype, mesh.device
    cols, inv_h = general_constants(mesh)
    kappa_e = _as_dtype(kappa_e, dtype, dev)
    B, n = kappa_e.shape[0], mesh.n_nodes
    if tuple(kappa_e.shape) != (B, mesh.n_elements):
        raise ValueError(f"K5b: κ_e must be (B, n_elements), got "
                         f"{tuple(kappa_e.shape)}")
    store = dtype if operand_dtype is None else operand_dtype
    F = torch.as_tensor(F, device=dev)
    F = F.to(dtype) if F.ndim == 1 else _plane(F, dtype, store, dev)
    u_data = _plane(u_data, dtype, store, dev)
    _check_planes(B, n, F, u_data, tuple(kappa_e.shape), "K5b")
    block_lanes = _check_block_lanes(block_lanes)
    if scale is None:
        scale = 2.0 / (B * n)
    with torch.no_grad():
        if kappa_e.device.type == "cpu":
            return _k5b_plain(kappa_e, F, u_data.expand(B, n), cols, inv_h,
                              float(scale))
        return _launch_pcr(True, kappa_e, F, u_data, cols, scale, inv_h,
                           block_lanes, plan)
