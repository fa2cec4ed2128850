"""Kernel K8: the masked edge-ELL operator in the batch-minor layout.

The general-mesh CG of ops/unstructured.py applies, every iteration,

    y[i,b] = m_i·v[i,b] + p_i·(diag[i,b]·p_i·v[i,b]
                               + Σ_d W[i,d,b]·p_j·v[j,b]),   j = nbr[i,d]

with p = 1 − m: the Dirichlet-eliminated K̃v = m⊙v + P·K(P·v) of
``_ell_bm_impl`` in ``difffe_tpu/ops/unstructured.py``, in one launch.  Its
core is the row gather-sum Σ_d u[idx[i,d], :] of the TPU probe kernel
``try_kernel`` in ``scripts/probe_mosaic_gather.py`` (P1), which Mosaic
could not lower, so the TPU package left this operator to XLA's gathers;
with W ≡ 1, diag ≡ 0 and m ≡ 0 the function here is exactly P1's.

Shapes: nbr (n, Dn) int32, W (n, Dn, B), diag (n, B), v (n, B), m (n,),
float32 or float64; padding slots carry W = 0 at index 0.

Two implementations behind one wrapper, :func:`ell_apply`:

* the CUDA kernel in ``csrc/ell_apply.cu`` (one thread per (i, b), the
  batch fastest, so the gather reads whole contiguous rows), launched for
  CUDA tensors;
* the plain PyTorch version below, taken only for CPU tensors, and the
  reference the kernel is checked against.
"""

from __future__ import annotations

import torch

#: Kernel launches made by the wrapper.
launches = {"ell_apply": 0}


def ell_apply_plain(nbr, W, diag, v, m):
    """Plain version of K8: diag·pv + (W·pv[nbr]).sum(1) under the mask."""
    mc = m[:, None]
    p = 1.0 - mc
    pv = p * v
    return mc * v + p * (diag * pv + (W * pv[nbr]).sum(dim=1))


def _check(nbr, W, diag, v, m):
    n, B = v.shape
    Dn = nbr.shape[1]
    if v.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the CUDA K8 kernel takes float32 or float64, got "
                        f"{v.dtype}")
    for name, t, shape in (("W", W, (n, Dn, B)), ("diag", diag, (n, B)),
                           ("m", m, (n,))):
        if t.dtype != v.dtype or t.device != v.device:
            raise ValueError(f"K8: {name} must share v's dtype and device")
        if tuple(t.shape) != shape:
            raise ValueError(f"K8: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
    if nbr.dtype != torch.int32 or nbr.device != v.device:
        raise ValueError("K8: nbr must be int32 on v's device")
    for name, t in (("nbr", nbr), ("W", W), ("diag", diag), ("v", v),
                    ("m", m)):
        if not t.is_contiguous():
            raise ValueError(f"K8: {name} must be contiguous")


def ell_apply(nbr: torch.Tensor, W: torch.Tensor, diag: torch.Tensor,
              v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """The masked operator y (n, B) of the module note: the plain version
    on CPU tensors, kernel K8 on CUDA tensors."""
    if v.ndim != 2 or nbr.ndim != 2 or nbr.shape[0] != v.shape[0]:
        raise ValueError(f"K8 takes v (n, B) and nbr (n, Dn), got "
                         f"{tuple(v.shape)} and {tuple(nbr.shape)}")
    if v.device.type == "cpu":
        return ell_apply_plain(nbr, W, diag, v, m)
    if not v.is_cuda:
        raise ValueError(f"K8 runs on CPU (plain) or CUDA tensors, got "
                         f"device {v.device}")
    from ._build import load_library

    _check(nbr, W, diag, v, m)
    n, B = v.shape
    y = torch.empty_like(v)
    fn = load_library().difffe_ell_apply
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(nbr.data_ptr(), W.data_ptr(), diag.data_ptr(), v.data_ptr(),
                m.data_ptr(), y.data_ptr(), n, nbr.shape[1], B,
                int(v.dtype == torch.float64), stream)
    if rc != 0:
        raise RuntimeError(f"K8 ell_apply launch failed: CUDA error {rc}")
    launches["ell_apply"] += 1
    return y
