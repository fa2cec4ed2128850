"""SPIKE (partitioned) tridiagonal solver for large 1D systems.

PyTorch counterpart of ``difffe_tpu/ops/spike.py``.  PCR (ops/tridiag.py)
is depth-O(log n) but work-O(n log n); SPIKE partitions each system into
C chunks of length L = n/C:

1. per-chunk Thomas solves (sequential in L, vectorized over batch ×
   chunks × 3 right-hand sides: F and the two coupling columns);
2. a reduced 2C×2C pentadiagonal interface system (a batched dense solve);
3. a rank-2 reconstruction per chunk.

Total work O(n) with depth L + O(1).  ``tridiag_solve_spike`` is a
``torch.autograd.Function`` with the other band solvers' symmetric
adjoint; its backward is written in differentiable torch ops, so double
backward composes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F_


def _thomas_multi(dl, d, du, rhs):
    """Vectorized Thomas for many independent tridiagonal systems.

    dl, d, du: (..., L) sub/main/super diagonals (dl[..., 0] and
    du[..., -1] ignored); rhs: (..., L, K) right-hand sides.  Sequential
    only in L; everything else vectorized.
    """
    L = d.shape[-1]
    # forward elimination: w_i = dl_i / dhat_{i-1};
    # dhat_i = d_i − w_i du_{i-1}; rhat_i = r_i − w_i rhat_{i-1}
    dhat = [d[..., 0]]
    rhat = [rhs[..., 0, :]]
    for i in range(1, L):
        w = dl[..., i] / dhat[-1]
        dhat.append(d[..., i] - w * du[..., i - 1])
        rhat.append(rhs[..., i, :] - w[..., None] * rhat[-1])
    # back substitution: x_i = (rhat_i − du_i x_{i+1}) / dhat_i
    xs = [rhat[-1] / dhat[-1][..., None]]
    for i in range(L - 2, -1, -1):
        xs.append((rhat[i] - du[..., i, None] * xs[-1])
                  / dhat[i][..., None])
    return torch.stack(xs[::-1], dim=-2)          # (..., L, K)


def _solve_reduced(M, rhs):
    """Batched solve of the small reduced system.

    The JAX module solves it by an f32 LU plus two f64 refinement sweeps
    when the input is f64, because XLA's LU has no f64 on the TPU.  On the
    card (and the CPU) ``torch.linalg.solve`` factorizes in f64, so only
    its direct branch is ported."""
    return torch.linalg.solve(M, rhs[..., None])[..., 0]


def _spike_impl(d, e, F, chunk):
    """d: (B, n), e: (B, n−1), F: (B, n); n % chunk == 0."""
    B, n = d.shape
    L = chunk
    C = n // L
    dc = d.reshape(B, C, L)
    # global sub/super diagonal split into intra-chunk and coupling parts:
    # ec[..., :L−1] intra, ec[..., L−1] couples chunk i to chunk i+1
    ec = F_.pad(e, (0, 1)).reshape(B, C, L)
    intra = ec[..., :L - 1]
    couple = ec[..., L - 1]                        # (B, C), last col zero
    dl = F_.pad(intra, (1, 0))
    du = F_.pad(intra, (0, 1))
    bL = F_.pad(couple[:, :-1], (1, 0))            # coupling to the left
    bR = couple                                    # coupling to the right

    # 3 RHS per chunk: F, the unit first-entry and the unit last-entry
    # columns
    unit = torch.zeros(L, 2, dtype=d.dtype, device=d.device)
    unit[0, 0] = 1.0
    unit[L - 1, 1] = 1.0
    rhs = torch.cat([F.reshape(B, C, L, 1), unit.expand(B, C, L, 2)],
                    dim=-1)
    sol = _thomas_multi(dl, dc, du, rhs)           # (B, C, L, 3)
    y, w, v = sol[..., 0], sol[..., 1], sol[..., 2]

    # reduced system in z = (t_0, s_0, …, t_{C−1}, s_{C−1}), t_i = x_i[0],
    # s_i = x_i[L−1]:
    #   t_i + bL_i w_i[0]  s_{i−1} + bR_i v_i[0]  t_{i+1} = y_i[0]
    #   s_i + bL_i w_i[−1] s_{i−1} + bR_i v_i[−1] t_{i+1} = y_i[−1]
    ci = torch.arange(C, device=d.device)
    rows_t, rows_s = 2 * ci, 2 * ci + 1
    M = torch.eye(2 * C, dtype=d.dtype, device=d.device).repeat(B, 1, 1)
    # s_{i−1} sits in column 2i−1 (i ≥ 1), t_{i+1} in column 2i+2 (i < C−1)
    M[:, rows_t[1:], 2 * ci[1:] - 1] = bL[:, 1:] * w[:, 1:, 0]
    M[:, rows_s[1:], 2 * ci[1:] - 1] = bL[:, 1:] * w[:, 1:, L - 1]
    M[:, rows_t[:-1], 2 * ci[:-1] + 2] = bR[:, :-1] * v[:, :-1, 0]
    M[:, rows_s[:-1], 2 * ci[:-1] + 2] = bR[:, :-1] * v[:, :-1, L - 1]

    rhs_red = torch.stack([y[..., 0], y[..., L - 1]], dim=-1).reshape(
        B, 2 * C)
    z = _solve_reduced(M, rhs_red).reshape(B, C, 2)
    t, s = z[..., 0], z[..., 1]
    s_prev = F_.pad(s[:, :-1], (1, 0))
    t_next = F_.pad(t[:, 1:], (0, 1))
    x = (y - (bL * s_prev)[..., None] * w
         - (bR * t_next)[..., None] * v)           # (B, C, L)
    return x.reshape(B, n)


def _pad_to_chunks(d, e, F, chunk):
    """Pad n up to a chunk multiple with decoupled identity rows; returns
    the padded bands and the true n."""
    n = d.shape[-1]
    n_pad = (-n) % chunk
    if n_pad == 0:
        return d, e, F, n
    return (F_.pad(d, (0, n_pad), value=1.0), F_.pad(e, (0, n_pad)),
            F_.pad(F, (0, n_pad)), n)


def _solve(d, e, F, chunk):
    shape = torch.broadcast_shapes(d.shape, F.shape)
    lead, n = shape[:-1], shape[-1]
    d2, F2 = (a.expand(shape).reshape(-1, n) for a in (d, F))
    e2 = e.expand(lead + e.shape[-1:]).reshape(-1, n - 1)
    dp, ep, Fp, n_true = _pad_to_chunks(d2, e2, F2, chunk)
    u = _spike_impl(dp, ep, Fp, chunk)[:, :n_true]
    return u.reshape(shape)


class _SpikeSolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, chunk, d, e, F):
        u = _solve(d, e, F, chunk)
        ctx.chunk = chunk
        ctx.shapes = (d.shape, e.shape, F.shape)
        ctx.save_for_backward(d, e, u)
        return u

    @staticmethod
    def backward(ctx, g):
        d, e, u = ctx.saved_tensors
        d_shape, e_shape, F_shape = ctx.shapes
        lam = _solve(d, e, g, ctx.chunk)           # T symmetric ⇒ Tλ = ḡ
        grad_d = -lam * u
        grad_e = -(lam[..., :-1] * u[..., 1:] + lam[..., 1:] * u[..., :-1])
        return (None, grad_d.sum_to_size(d_shape),
                grad_e.sum_to_size(e_shape), lam.sum_to_size(F_shape))


def tridiag_solve_spike(d: torch.Tensor, e: torch.Tensor, F: torch.Tensor,
                        chunk: int = 64) -> torch.Tensor:
    """Solve T u = F (symmetric tridiagonal) by the SPIKE partitioning.

    d: (..., n), e: (..., n−1), F: (..., n), leading batch axes broadcast;
    best for n ≳ 512, where PCR's O(n log n) work dominates."""
    return _SpikeSolve.apply(int(chunk), d, e, F)
