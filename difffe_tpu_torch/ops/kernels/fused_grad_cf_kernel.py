"""Kernel K1: closed-form per-element-κ 1D grad step and SGD chain.

PyTorch counterpart of ``difffe_tpu/ops/pallas/fused_grad_cf_kernel.py``.
The chain factorization (ops/cf1d.py) turns the per-element-κ tridiagonal
solve into prefix sums and a rank-1 correction:

    s = h_e/κ_e;  S = cumsum(s);  T = cumsum(s·P)        (P from F)
    w₁ = (u_R − u_L + T_tot)/S_tot;   u = u_L + shift(w₁S − T)
    adjoint: same closed form with RHS scale·(u − u_data)
    ∂κ_e = −(h_e/κ_e²)·w_e·w_e^λ                          (elementwise)

Layout: element/DOF rows by scenario columns, κ packed as an (N, Bp) plane
(N = n_nodes rounded up to 8, Bp = B rounded up to ``block_lanes``) with an
(N, 6) block of per-row constants.  Padding rows carry h_e = 0, so prefix
totals are unaffected and their gradient is 0.

Each operation has two implementations behind one wrapper:

* the CUDA kernel in ``csrc/fused_grad_cf.cu``, launched for CUDA tensors:
  L lanes a scenario, each holding NB/L rows in registers with running f32
  sums and a shuffle scan across the L lanes, the per-row constants in
  ``__constant__`` memory (``k1_rows``: h, P and the shared u_data, copied
  on the stream before each launch).  ``k1_plan(N)`` gives L by row bucket
  NB (32, 64, 128, 256), as measured on the card;
* the plain PyTorch version below (``torch.cumsum`` on the plane), taken
  only for CPU tensors, and the reference the kernel is checked against.

``cumsum_via`` keeps the JAX signature: on the TPU it picked roll-adds
("vpu") or a split-bf16 matmul ("mxu"); here both values select the same
exact scan.  Lanes b ≥ B are padding: loss 0, gradient 0, κ′ = κ (the
JAX kernel instead updates them against a zero observation plane).

The kernel takes float32 planes with at most ``MAX_ROWS`` rows; u_data may
be streamed as float32 or bfloat16.  Scope: Dirichlet at exactly the two
chain ends with shared values, shared assembled load F.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F_

# Column indices in the packed (N, 6) constants block the plain version
# reads; the kernel takes its first three columns (k1_rows).
_COL_HS = 0      # element width h_e on element rows, 0 on pads
_COL_PF = 1      # P_e = Σ_{i<e} F_i from the shared load (element rows)
_COL_UD = 2      # shared u_data on node rows (shared-ud mode)
_COL_NM = 3      # 1 on node rows 0..n−1, 0 on pads
_COL_IM = 4      # 1 on interior node rows 1..n−2, 0 elsewhere
_COL_HK = 5      # h_e again, read by the gradient
_N_COLS = 6

#: Largest padded row count N the CUDA kernel takes (its biggest bucket).
MAX_ROWS = 256

#: Kernel launches made by the wrappers, by kernel ("step", "chain").
launches = {"step": 0, "chain": 0}

#: Row buckets NB of the kernel and the lanes a scenario of each bucket's
#: body: one lane (all 32 rows) at NB = 32, 16 rows a lane above.
K1_LANES = {32: 1, 64: 4, 128: 8, 256: 16}


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def packed_rows(n_nodes: int) -> int:
    """Rows N of the packed planes for a mesh of ``n_nodes`` nodes."""
    return _round_up(max(n_nodes, 8), 8)


def k1_bucket(N: int) -> int:
    """The row bucket NB (32, 64, 128 or 256) of N packed rows."""
    if not 1 <= N <= MAX_ROWS:
        raise ValueError(f"K1 takes 1 to {MAX_ROWS} packed rows, got {N}")
    return next(nb for nb in K1_LANES if N <= nb)


def k1_plan(N: int) -> int:
    """Lanes a scenario of K1's body for N packed rows."""
    return K1_LANES[k1_bucket(N)]


def k1_rows(cols: torch.Tensor) -> torch.Tensor:
    """The per-row constants as the lanes design takes them: an (NB, 3)
    float32 block {h, P, shared u_data} from ``cols`` (its columns HS, PF
    and UD), zero on rows N..NB-1.  The masks NM and IM are not in it (the
    kernel derives them from the row and n), nor HK (a copy of HS)."""
    N = cols.shape[0]
    return F_.pad(cols[:, _COL_HS:_COL_UD + 1],
                  (0, 0, 0, k1_bucket(N) - N)).contiguous()


def chain_takes(mesh) -> bool:
    """True when the CUDA K1 kernel takes this mesh's planes: float32 and
    at most ``MAX_ROWS`` packed rows (the kernel's documented limits;
    ``fit_kappa`` routes every other line mesh to the torch closed form)."""
    return (mesh.dtype == torch.float32
            and packed_rows(mesh.n_nodes) <= MAX_ROWS)


def _check_via(cumsum_via: str):
    if cumsum_via not in ("mxu", "vpu"):
        raise ValueError(f"cumsum_via must be 'mxu' or 'vpu', got "
                         f"{cumsum_via!r}")


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU path and reference)
# ---------------------------------------------------------------------------


def _cf_body(ke, ud, cols, scale, u_l, u_r):
    """One closed-form grad step on (N, L) planes → (loss (1, L), g (N, L))."""
    hs = cols[:, _COL_HS:_COL_HS + 1]
    pf = cols[:, _COL_PF:_COL_PF + 1]
    nm = cols[:, _COL_NM:_COL_NM + 1]
    im = cols[:, _COL_IM:_COL_IM + 1]
    hk = cols[:, _COL_HK:_COL_HK + 1]
    inv = 1.0 / ke
    s = hs * inv
    sp = s * pf
    S = torch.cumsum(s, dim=0)
    T = torch.cumsum(sp, dim=0)
    s_tot = s.sum(dim=0, keepdim=True)
    t_tot = sp.sum(dim=0, keepdim=True)
    w1 = ((u_r - u_l) + t_tot) / s_tot
    u = u_l + F_.pad((w1 * S - T)[:-1], (0, 0, 1, 0))
    d = (u - ud) * nm
    loss = (d * d).sum(dim=0, keepdim=True)
    pl = torch.cumsum(scale * d * im, dim=0)        # P^λ on element rows
    wl1 = (s * pl).sum(dim=0, keepdim=True) / s_tot
    g = -(hk * inv * inv) * (w1 - pf) * (wl1 - pl)
    return loss, g


def _valid_ud(keT, udT, cols, B):
    if udT is None:
        return cols[:, _COL_UD:_COL_UD + 1]
    return udT[:, :B].to(keT.dtype)


def _cf_step_plain(keT, udT, cols, B, scale, u_l, u_r):
    """Plain version of the step kernel: (loss (1, Bp), gradT (N, Bp))."""
    loss, g = _cf_body(keT[:, :B], _valid_ud(keT, udT, cols, B), cols,
                       scale, u_l, u_r)
    lp = keT.new_zeros((1, keT.shape[1]))
    gT = torch.zeros_like(keT)
    lp[:, :B] = loss
    gT[:, :B] = g
    return lp, gT


def _cf_chain_plain(keT, udT, cols, B, scale, u_l, u_r, n_inner, lr):
    """Plain version of the chain kernel: (loss (1, Bp) of the last inner
    step, keT′ (N, Bp))."""
    ud = _valid_ud(keT, udT, cols, B)
    ke = keT[:, :B]
    for _ in range(n_inner):
        loss, g = _cf_body(ke, ud, cols, scale, u_l, u_r)
        ke = ke - lr * g
    lp = keT.new_zeros((1, keT.shape[1]))
    out = keT.clone()
    lp[:, :B] = loss
    out[:, :B] = ke
    return lp, out


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------


def _check_cuda_operands(keT, udT, cols, B) -> int:
    """Validate what the kernel takes; returns its u_data kind
    (0 shared, 1 float32 plane, 2 bfloat16 plane)."""
    if not keT.is_cuda:
        raise ValueError(f"K1 runs on CPU (plain) or CUDA tensors, got "
                         f"device {keT.device}")
    if keT.dtype != torch.float32:
        raise TypeError(f"the CUDA K1 kernel takes float32 κ, got "
                        f"{keT.dtype}")
    if keT.ndim != 2 or not keT.is_contiguous():
        raise ValueError("keT must be a contiguous (N, Bp) plane")
    N, Bp = keT.shape
    if N > MAX_ROWS:
        raise ValueError(
            f"the CUDA K1 kernel takes at most {MAX_ROWS} padded rows "
            f"(n_nodes ≤ {MAX_ROWS}), got N={N}")
    if not 0 < B <= Bp:
        raise ValueError(f"valid lanes B={B} outside (0, Bp={Bp}]")
    if (cols.device != keT.device or cols.dtype != torch.float32
            or tuple(cols.shape) != (N, _N_COLS)
            or not cols.is_contiguous()):
        raise ValueError(f"cols must be a contiguous float32 (N, {_N_COLS}) "
                         f"block on {keT.device}")
    if udT is None:
        return 0
    if (udT.device != keT.device or tuple(udT.shape) != (N, Bp)
            or not udT.is_contiguous()):
        raise ValueError(f"udT must be a contiguous (N, Bp) plane on "
                         f"{keT.device}")
    if udT.dtype == torch.float32:
        return 1
    if udT.dtype == torch.bfloat16:
        return 2
    raise TypeError(f"the CUDA K1 kernel streams float32 or bfloat16 "
                    f"u_data, got {udT.dtype}")


def _launch(name, keT, udT, cols, B, n, scale, u_l, u_r, chain_args=()):
    from ._build import load_library

    ud_kind = _check_cuda_operands(keT, udT, cols, B)
    N, Bp = keT.shape
    if not 2 <= n <= N:
        raise ValueError(f"K1 needs 2 <= n <= N nodes, got n={n}, N={N}")
    lanes = k1_plan(N)
    rows = k1_rows(cols)
    loss = torch.empty((1, Bp), dtype=torch.float32, device=keT.device)
    out = torch.empty_like(keT)
    fn = getattr(load_library(), f"difffe_cf_{name}")
    with torch.cuda.device(keT.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(keT.data_ptr(), None if udT is None else udT.data_ptr(),
                ud_kind, rows.data_ptr(), loss.data_ptr(), out.data_ptr(), N,
                int(n), Bp, int(B), float(scale), float(u_l), float(u_r),
                *chain_args, lanes, stream)
    if rc != 0:
        raise RuntimeError(f"K1 {name} kernel launch failed: CUDA error {rc}")
    launches[name] += 1
    return loss, out


def _cf_step(keT, udT, cols, B, n, scale, u_l, u_r):
    """One grad step: plain version on CPU tensors, the kernel on CUDA."""
    if keT.device.type == "cpu":
        return _cf_step_plain(keT, udT, cols, B, scale, u_l, u_r)
    return _launch("step", keT, udT, cols, B, n, scale, u_l, u_r)


def _cf_chain(keT, udT, cols, B, n, scale, u_l, u_r, n_inner, lr):
    """n_inner SGD steps: plain version on CPU tensors, the kernel on CUDA."""
    if keT.device.type == "cpu":
        return _cf_chain_plain(keT, udT, cols, B, scale, u_l, u_r,
                               n_inner, lr)
    return _launch("chain", keT, udT, cols, B, n, scale, u_l, u_r,
                   (int(n_inner), float(lr)))


# ---------------------------------------------------------------------------
# Public API (same names and signatures as the JAX module)
# ---------------------------------------------------------------------------


def _cf_constants(mesh, F, dtype, N: int) -> torch.Tensor:
    """The (N, 6) block of per-row constants, on the mesh's device."""
    from ..cf1d import _element_widths

    n = mesh.n_nodes
    ne = mesh.n_elements
    hs = _element_widths(mesh)
    Fv = torch.as_tensor(F).detach().cpu().numpy().astype(np.float64)
    Fv = Fv.reshape(-1)
    # P_e = Σ_{i<e} F_i over interior rows: inclusive cumsum of the
    # interior-masked node loads, read at element row e−1
    f_int = Fv.copy()
    f_int[0] = 0.0
    f_int[-1] = 0.0
    pf = np.cumsum(f_int)[:ne]

    cols = np.zeros((N, _N_COLS), np.float64)
    cols[:ne, _COL_HS] = hs
    cols[:ne, _COL_PF] = pf
    cols[:n, _COL_NM] = 1.0
    cols[1:n - 1, _COL_IM] = 1.0
    cols[:ne, _COL_HK] = hs
    return torch.as_tensor(cols, dtype=dtype, device=mesh.device)


def _check_supported(mesh, F):
    from ..cf1d import mesh_supports_cf

    if not mesh_supports_cf(mesh):
        raise ValueError(
            "closed-form kernel needs Dirichlet at exactly the two "
            "endpoint nodes (FEMesh.line factory meshes)")
    if torch.as_tensor(F).ndim != 1:
        raise ValueError(
            "closed-form kernel needs a shared (unbatched) load F — "
            "use ops.cf1d.kappa_mse_step_cf for per-scenario loads")


def cf_packed_operands(mesh, kappa_e, F, u_data, block_lanes: int = 512,
                       operand_dtype: Optional[torch.dtype] = None):
    """Pack κ into the kernel's transposed (N, Bp) layout.

    Returns (keT, aux).  aux holds the constants block ``cols``, the
    per-scenario u_data plane ``udT`` when u_data is (B, n) (``None`` when
    it is shared; ``operand_dtype=torch.bfloat16`` stores it half-width),
    and the sizes and boundary values.  Thread keT through the optimizer
    loop and unpack once at the end with ``cf_unpack(keT, aux)``.
    """
    _check_supported(mesh, F)
    dtype, dev = mesh.dtype, mesh.device
    kappa_e = torch.as_tensor(kappa_e, dtype=dtype, device=dev)
    B, ne = kappa_e.shape
    n = mesh.n_nodes
    N = packed_rows(n)
    Bp = _round_up(max(B, block_lanes), block_lanes)
    cols = _cf_constants(mesh, F, dtype, N)
    u_data = torch.as_tensor(u_data, device=dev)
    udT = None
    if u_data.ndim == 1:
        cols[:n, _COL_UD] = u_data.to(dtype)
    else:
        op_dtype = dtype if operand_dtype is None else operand_dtype
        udT = torch.zeros((N, Bp), dtype=op_dtype, device=dev)
        udT[:n, :B] = u_data.to(op_dtype).T
    keT = torch.ones((N, Bp), dtype=dtype, device=dev)
    keT[:ne, :B] = kappa_e.T
    bv = mesh.bc_values.detach().cpu().numpy()
    aux = dict(cols=cols, udT=udT, B=B, ne=ne, n=n, u_l=float(bv[0]),
               u_r=float(bv[-1]), block_lanes=block_lanes)
    return keT, aux


def kappa_mse_step_cf_packed(keT, aux: dict, scale: Optional[float] = None,
                             cumsum_via: str = "mxu"):
    """Gradient step on packed (N, Bp) state: returns
    (loss_parts (1, Bp), gradT (N, Bp)), zero in padded lanes."""
    _check_via(cumsum_via)
    if scale is None:
        scale = 2.0 / (aux["B"] * aux["n"])
    return _cf_step(keT, aux["udT"], aux["cols"], aux["B"], aux["n"], scale,
                    aux["u_l"], aux["u_r"])


def kappa_sgd_chain_cf(keT, aux: dict, n_inner: int, lr: float,
                       scale: Optional[float] = None,
                       cumsum_via: str = "mxu"):
    """n_inner SGD steps per launch with κ held on the chip.

    Returns (loss_parts (1, Bp) from the LAST inner step, keT′); equal, to
    rounding, to n_inner calls of ``kappa_mse_step_cf_packed`` with the
    same lr.
    """
    if int(n_inner) < 1:
        raise ValueError("kappa_sgd_chain_cf needs n_inner >= 1")
    _check_via(cumsum_via)
    if scale is None:
        scale = 2.0 / (aux["B"] * aux["n"])
    return _cf_chain(keT, aux["udT"], aux["cols"], aux["B"], aux["n"], scale,
                     aux["u_l"], aux["u_r"], int(n_inner), float(lr))


def cf_unpack(keT, aux: dict) -> torch.Tensor:
    return keT[:aux["ne"], :aux["B"]].T


def fused_kappa_mse_step_general_cf(mesh, kappa_e, F, u_data,
                                    scale: Optional[float] = None,
                                    block_lanes: int = 512,
                                    cumsum_via: str = "mxu",
                                    operand_dtype=None):
    """Loss partials and ∂κ for per-element-κ 1D inversion, one launch.

    κ_e (B, n_elements); F shared assembled load (n,); u_data (B, n) or
    shared (n,).  Returns (loss_parts (B,), grad (B, n_elements)) for

        loss_parts[b] = Σ_i (u_b − u_data_b)_i²
        grad          = ∂/∂κ of  scale/2 · Σ_b loss_parts

    ``scale`` defaults to 2/(B·n).  ``operand_dtype=torch.bfloat16``
    stores a streamed u_data plane in bf16.
    """
    keT, aux = cf_packed_operands(mesh, kappa_e, F, u_data,
                                  block_lanes=block_lanes,
                                  operand_dtype=operand_dtype)
    lp, gT = kappa_mse_step_cf_packed(keT, aux, scale=scale,
                                      cumsum_via=cumsum_via)
    return lp[0, :aux["B"]], cf_unpack(gT, aux)
