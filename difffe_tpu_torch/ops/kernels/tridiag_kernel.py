"""Kernel K2: batched symmetric tridiagonal solve by parallel cyclic
reduction.

PyTorch counterpart of ``difffe_tpu/ops/pallas/tridiag_kernel.py``.  The
JAX module has two Pallas kernels for one function, u = T⁻¹F for B
independent symmetric tridiagonal systems: ``_pcr_pallas_padded`` (batch
layout, n padded to 128 lanes) and ``_pcr_pallas_T`` (transposed layout,
n on sublanes, the batch on lanes).  Here one CUDA kernel
(``csrc/tridiag_pcr.cu``) serves both: a thread block holds ``spb`` whole
scenarios in shared memory and runs the PCR sweeps there, with nothing
padded.  ``layout`` and ``block_b`` keep the JAX signature and only set
``spb``, the launch shape:

* ``"transposed"`` (and ``"auto"`` with n ≤ 256): ``spb = max(1, 512 // n)``
  scenarios fill a block of up to 512 rows, as the TPU filled its lanes;
* ``"batch"`` (``"auto"`` with n > 256, and any other value, as the JAX
  ``_impl`` reads it): ``spb = max(1, min(block_b, 512 // n))``.

Each scenario's arithmetic is the same whatever ``spb`` is, so every layout
gives the same bits.

The solve has two implementations behind one wrapper: the kernel, launched
for CUDA tensors, and the plain version (the PCR oracle of ops/tridiag.py
on explicitly batched bands), taken only for CPU tensors and the reference
the kernel is checked against.  Name mapped from the JAX module:
``tridiag_solve_pallas`` → :func:`tridiag_solve_kernel`.
"""

from __future__ import annotations

import math

import torch

from ..tridiag import _tridiag_solve_impl

#: Kernel launches made by the wrapper.
launches = {"pcr": 0}

_ROWS = 512          # rows a block aims at (spb * n)


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


def _launch(d, e, F, lead, n, spb):
    from ._build import load_library

    for t in (d, e):
        if t.device != F.device or t.dtype != F.dtype:
            raise ValueError("K2 bands must share F's device and dtype")
    if F.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the CUDA K2 kernel takes float32 or float64 "
                        f"bands, got {F.dtype}")
    d2, e2, F2 = _rows(d, lead, n), _rows(e, lead, n - 1), _rows(F, lead, n)
    B = F2.shape[0]
    u = torch.empty((B, n), dtype=F.dtype, device=F.device)
    if B == 0:
        return u
    lib = load_library()
    with torch.cuda.device(F.device):
        cap = lib.difffe_tridiag_pcr_max_rows(F.element_size())
        if n > cap:
            raise ValueError(f"K2 holds a whole system in one block's shared "
                             f"memory: n = {n} exceeds {cap} rows for "
                             f"{F.dtype}")
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.difffe_tridiag_pcr(
            d2.data_ptr(), _batch_stride(d2), e2.data_ptr(),
            _batch_stride(e2), F2.data_ptr(), _batch_stride(F2), u.data_ptr(),
            B, n, spb, int(F.dtype == torch.float64), stream)
    if rc != 0:
        raise RuntimeError(f"K2 tridiag_pcr launch failed: CUDA error {rc}")
    launches["pcr"] += 1
    return u


def _solve(d, e, F, block_b, layout):
    """u = T⁻¹F over the broadcast leading axes of d, e and F.  Plain
    version on CPU tensors, the kernel on CUDA."""
    n = F.shape[-1]
    if n < 1 or d.shape[-1] != n or e.shape[-1] != n - 1:
        raise ValueError(f"bands of shapes d {tuple(d.shape)}, e "
                         f"{tuple(e.shape)}, F {tuple(F.shape)} do not form "
                         f"tridiagonal systems")
    lead = torch.broadcast_shapes(d.shape[:-1], e.shape[:-1], F.shape[:-1])
    spb = scenarios_per_block(n, block_b, layout)
    if F.device.type == "cpu":
        return _pcr_plain(d.expand(lead + (n,)), e.expand(lead + (n - 1,)),
                          F.expand(lead + (n,)))
    if not F.is_cuda:
        raise ValueError(f"K2 runs on CPU (plain) or CUDA tensors, got "
                         f"device {F.device}")
    return _launch(d, e, F, lead, n, spb).reshape(lead + (n,))


class _TridiagSolveKernel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, d, e, F, block_b, layout):
        u = _solve(d, e, F, block_b, layout)
        ctx.save_for_backward(d, e, u)
        ctx.cfg = (block_b, layout, d.shape, e.shape, F.shape)
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
        block_b, layout, d_shape, e_shape, F_shape = ctx.cfg
        d, e, u = ctx.saved_tensors
        lam = _solve(d, e, g, block_b, layout)
        grad_d = -lam * u
        grad_e = -(lam[..., :-1] * u[..., 1:] + lam[..., 1:] * u[..., :-1])
        return (grad_d.sum_to_size(d_shape), grad_e.sum_to_size(e_shape),
                lam.sum_to_size(F_shape), None, None)


def tridiag_solve_kernel(d: torch.Tensor, e: torch.Tensor, F: torch.Tensor,
                         block_b: int = 64,
                         layout: str = "auto") -> torch.Tensor:
    """Solve T u = F for batched symmetric tridiagonal T = tridiag(e, d, e)
    on kernel K2.

    d: (…, n) diagonals, e: (…, n−1) off-diagonals, F: (…, n) right-hand
    sides; the leading axes broadcast (a band shared by every scenario is
    read in place), and unbatched (n,) inputs are accepted.  ``block_b``
    and ``layout`` set the launch shape only (module note).
    Differentiable once wrt d, e and F: the backward runs one more K2 solve
    and raises ``NotImplementedError`` under ``create_graph``.
    """
    return _TridiagSolveKernel.apply(d, e, F, block_b, layout)
