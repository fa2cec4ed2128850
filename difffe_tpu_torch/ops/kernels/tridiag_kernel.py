"""Kernel K2: batched symmetric tridiagonal solve by parallel cyclic
reduction.

PyTorch counterpart of ``difffe_tpu/ops/pallas/tridiag_kernel.py``.  The
JAX module has two Pallas kernels for one function, u = T⁻¹F for B
independent symmetric tridiagonal systems: ``_pcr_pallas_padded`` (batch
layout, n padded to 128 lanes) and ``_pcr_pallas_T`` (transposed layout,
n on sublanes, the batch on lanes).  Here one CUDA source
(``csrc/tridiag_pcr.cu``) serves both, with two routes that give the same
bits; ``k2_plan(n, dtype, batch)`` picks one:

* ``"warp"`` for n ≤ ``WARP_MAX_ROWS`` (256) and at least
  ``WARP_MIN_BATCH`` systems: one warp a scenario, its rows striped over
  the lanes' registers, neighbours by shuffles, no shared memory and no
  block barrier (launches counted as ``"pcr"``);
* ``"block"`` otherwise, up to one block's 8192 rows: a thread block holds
  ``spb`` whole scenarios in shared memory and runs the PCR sweeps there
  (the first design; launches counted as ``"pcr_block"``).  With fewer
  than ~16 scenarios' warps an SM the warp route's five slots a lane
  (n = 129) are latency-bound, and one thread a row wins.

Nothing is padded.  ``layout`` and ``block_b`` keep the JAX signature and
only set the block route's ``spb``, the launch shape:

* ``"transposed"`` (and ``"auto"`` with n ≤ 256): ``spb = max(1, 512 // n)``
  scenarios fill a block of up to 512 rows, as the TPU filled its lanes;
* ``"batch"`` (``"auto"`` with n > 256, and any other value, as the JAX
  ``_impl`` reads it): ``spb = max(1, min(block_b, 512 // n))``.

Each scenario's arithmetic is the same whatever ``spb`` is, so every layout
gives the same bits.

The solve is one ``torch.library`` custom op, ``difffe::tridiag_pcr``
(d, e, F as (B, n) rows, ``spb``, ``plan``), with two implementations: the
kernel, registered for CUDA tensors, and the plain version (the PCR oracle
of ops/tridiag.py on explicitly batched bands), registered for CPU tensors
and the reference the kernel is checked against.  Its fake implementation
gives the (B, n) output, so ``torch.export`` traces a solve as one node and
an exported program runs the kernel on the card (utils/export.py).  Name
mapped from the JAX module: ``tridiag_solve_pallas`` →
:func:`tridiag_solve_kernel`.
"""

from __future__ import annotations

import math

import torch

from ..tridiag import _tridiag_solve_impl
from ._build import kernel_op

#: Kernel launches made by the wrapper: "pcr" on the warp route, "pcr_block"
#: on the block route.
launches = {"pcr": 0, "pcr_block": 0}

_ROWS = 512          # rows a block aims at (spb * n)
#: Largest system the warp route takes (8 register slots of 32 rows).
WARP_MAX_ROWS = 256
#: Fewest systems the warp route takes unforced: on an H100 at n = 129 the
#: block route was faster up to B = 1024 (0.0094 against 0.0115 ms) and
#: the warp route from B = 2048 on (chip_smoke.py phase 16).
WARP_MIN_BATCH = 2048


def k2_plan(n: int, dtype: torch.dtype, batch: int, plan=None) -> str:
    """K2's route for ``batch`` systems of n rows of ``dtype``: ``"warp"``
    for n ≤ ``WARP_MAX_ROWS`` and batch ≥ ``WARP_MIN_BATCH``, ``"block"``
    otherwise; ``plan`` forces either and is refused where the warp route
    cannot hold the system."""
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the CUDA K2 kernel takes float32 or float64 "
                        f"bands, got {dtype}")
    if n < 1:
        raise ValueError(f"K2 needs n >= 1 rows, got {n}")
    if plan is None:
        return ("warp" if n <= WARP_MAX_ROWS and batch >= WARP_MIN_BATCH
                else "block")
    if plan not in ("warp", "block"):
        raise ValueError(f"K2 plan must be 'warp' or 'block', got {plan!r}")
    if plan == "warp" and n > WARP_MAX_ROWS:
        raise ValueError(f"K2's warp route holds at most {WARP_MAX_ROWS} "
                         f"rows a system, got n = {n}")
    return plan


def _pcr_plain(d, e, F):
    """Plain version of K2: PCR on bands broadcast to F's batch shape."""
    return _tridiag_solve_impl(d, e, F)


def scenarios_per_block(n: int, block_b: int = 64,
                        layout: str = "auto") -> int:
    """The launch shape ``spb`` of K2 for systems of size n (module
    note)."""
    if int(block_b) < 1:
        raise ValueError(f"block_b must be >= 1, got {block_b}")
    fill = max(1, _ROWS // n)
    if layout == "transposed" or (layout == "auto" and n <= 256):
        return fill
    return max(1, min(int(block_b), fill))


def _rows(t: torch.Tensor, lead, k: int) -> torch.Tensor:
    """t as (prod(lead), k) rows with unit stride along k; a band shared by
    every scenario stays a stride-0 view."""
    t2 = t.expand(tuple(lead) + (k,)).reshape(math.prod(lead), k)
    if k > 1 and t2.stride(-1) != 1:
        t2 = t2.contiguous()
    return t2


def _batch_stride(t: torch.Tensor) -> int:
    return 0 if t.shape[0] == 1 else t.stride(0)


def _launch(d2, e2, F2, spb, plan=None):
    """The kernel on (B, n) rows of bands and right-hand sides (stride-0
    rows of a shared band read in place)."""
    from ._build import load_library

    for t in (d2, e2):
        if t.device != F2.device or t.dtype != F2.dtype:
            raise ValueError("K2 bands must share F's device and dtype")
    B, n = F2.shape
    route = k2_plan(n, F2.dtype, B, plan)
    u = torch.empty((B, n), dtype=F2.dtype, device=F2.device)
    if B == 0:
        return u
    lib = load_library()
    bands = (d2.data_ptr(), _batch_stride(d2), e2.data_ptr(),
             _batch_stride(e2), F2.data_ptr(), _batch_stride(F2),
             u.data_ptr(), B, n)
    is_double = int(F2.dtype == torch.float64)
    with torch.cuda.device(F2.device):
        stream = torch.cuda.current_stream().cuda_stream
        if route == "warp":
            rc = lib.difffe_tridiag_pcr_warp(*bands, is_double, stream)
        else:
            cap = lib.difffe_tridiag_pcr_max_rows(F2.element_size())
            if n > cap:
                raise ValueError(
                    f"K2 holds a whole system in one block's shared "
                    f"memory: n = {n} exceeds {cap} rows for {F2.dtype}")
            rc = lib.difffe_tridiag_pcr(*bands, spb, is_double, stream)
    if rc != 0:
        raise RuntimeError(f"K2 tridiag_pcr ({route} route) launch failed: "
                           f"CUDA error {rc}")
    launches["pcr" if route == "warp" else "pcr_block"] += 1
    return u


def _like_F(d, e, F, spb, plan):
    return F.new_empty(F.shape)


#: K2 as the op ``difffe::tridiag_pcr(d, e, F, spb, plan)``: u = T⁻¹F for
#: (B, n) rows d, F and (B, n−1) rows e; the plain version on CPU tensors,
#: the kernel on CUDA tensors (``plan`` forces its route, ``spb`` is the
#: block route's scenarios a block)
tridiag_pcr = kernel_op(
    "tridiag_pcr", "(Tensor d, Tensor e, Tensor F, int spb, str? plan) "
                   "-> Tensor",
    lambda d, e, F, spb, plan: _pcr_plain(d, e, F), _launch, _like_F)


def _solve(d, e, F, block_b, layout, plan=None):
    """u = T⁻¹F over the broadcast leading axes of d, e and F, through
    ``difffe::tridiag_pcr``: the plain version on CPU tensors, the kernel
    on CUDA (``plan`` forces its route)."""
    n = F.shape[-1]
    if n < 1 or d.shape[-1] != n or e.shape[-1] != n - 1:
        raise ValueError(f"bands of shapes d {tuple(d.shape)}, e "
                         f"{tuple(e.shape)}, F {tuple(F.shape)} do not form "
                         f"tridiagonal systems")
    lead = F.shape[:-1]
    if d.shape[:-1] != lead or e.shape[:-1] != lead:
        lead = torch.broadcast_shapes(d.shape[:-1], e.shape[:-1], lead)
    spb = scenarios_per_block(n, block_b, layout)
    if F.device.type not in ("cpu", "cuda"):
        raise ValueError(f"K2 runs on CPU (plain) or CUDA tensors, got "
                         f"device {F.device}")
    u = tridiag_pcr(_rows(d, lead, n), _rows(e, lead, n - 1),
                    _rows(F, lead, n), spb, plan)
    return u.reshape(lead + (n,))


class _TridiagSolveKernel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, d, e, F, block_b, layout, plan):
        u = _solve(d, e, F, block_b, layout, plan)
        ctx.save_for_backward(d, e, u)
        ctx.cfg = (block_b, layout, plan, d.shape, e.shape, F.shape)
        return u

    @staticmethod
    def backward(ctx, g):
        # first order only, as the JAX custom_vjp, whose second derivative
        # raises: refuse a graph of this backward (create_graph) outright,
        # since a graph that skipped λ's dependence on d and e would give
        # wrong second derivatives without a word
        if torch.is_grad_enabled():
            raise NotImplementedError(
                "the K2 route (tridiag_solve_kernel, method='tridiag_pallas')"
                " is differentiable once: its backward takes no "
                "create_graph; use method='tridiag' for higher derivatives")
        # one more kernel solve for λ = T⁻¹ḡ (T symmetric), then the band
        # gradients in torch
        block_b, layout, plan, d_shape, e_shape, F_shape = ctx.cfg
        d, e, u = ctx.saved_tensors
        lam = _solve(d, e, g, block_b, layout, plan)
        # the band gradients only where asked (a time loop over one system
        # asks for λ alone)
        need_d, need_e = ctx.needs_input_grad[:2]
        grad_d = (-lam * u).sum_to_size(d_shape) if need_d else None
        grad_e = -(lam[..., :-1] * u[..., 1:] + lam[..., 1:] * u[..., :-1]
                   ).sum_to_size(e_shape) if need_e else None
        return grad_d, grad_e, lam.sum_to_size(F_shape), None, None, None


def tridiag_solve_kernel(d: torch.Tensor, e: torch.Tensor, F: torch.Tensor,
                         block_b: int = 64, layout: str = "auto",
                         plan=None) -> torch.Tensor:
    """Solve T u = F for batched symmetric tridiagonal T = tridiag(e, d, e)
    on kernel K2.

    d: (…, n) diagonals, e: (…, n−1) off-diagonals, F: (…, n) right-hand
    sides; the leading axes broadcast (a band shared by every scenario is
    read in place), and unbatched (n,) inputs are accepted.  ``block_b``
    and ``layout`` set the launch shape only (module note); ``plan``
    ("warp" or "block") forces a route on the card (``k2_plan``).
    Differentiable once wrt d, e and F: the backward runs one more K2 solve
    and raises ``NotImplementedError`` under ``create_graph``.
    """
    return _TridiagSolveKernel.apply(d, e, F, block_b, layout, plan)
