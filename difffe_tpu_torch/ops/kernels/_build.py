"""Build the package's CUDA sources with nvcc and load them with ctypes.

``load_library()`` compiles every ``difffe_tpu_torch/csrc/*.cu`` into one
shared library with a plain C interface, on first use, into
``difffe_tpu_torch/_build/libdifffe_<hash>.so``: one ``nvcc -c`` per
source, all started together, then one link.  The name carries a hash of
the sources and the flags, so an edit rebuilds and an unchanged tree
reuses the library.  The compilers' output (``-Xptxas -v``: registers,
shared memory and spills of every kernel) is kept beside it as
``libdifffe_<hash>.log``.  The library includes no PyTorch header, which
keeps the build to seconds; tensors cross as raw pointers.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = ("-shared",)

_P, _I, _F, _L, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_longlong, ctypes.c_double
# C entry points: name -> argtypes (every pointer and the stream as void*)
_SIGNATURES = {
    "difffe_cf_step": [_P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F,
                       _I, _P],
    "difffe_cf_chain": [_P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F,
                        _I, _F, _I, _P],
    "difffe_stencil_cg_work": [_I, _I],
    "difffe_stencil_cg": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                          _P],
    "difffe_stencil_cg_clusters": [_I, _I, _I, _I],
    "difffe_stencil_cg2": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                           _I, _F, _I, _I, _P],
    "difffe_stencil_cg2_clusters": [_I, _I, _I, _I],
    "difffe_smem_optin": [],
    "difffe_stencil3d_cg_work": [_I, _I, _I],
    "difffe_stencil3d_cg": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                            _I, _I, _P],
    "difffe_stencil3d_cg_clusters": [_I, _I, _I, _I, _I, _I],
    "difffe_stencil3d_cg2": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                             _I, _I, _F, _I, _I, _I, _P],
    "difffe_stencil3d_cg2_clusters": [_I, _I, _I, _I, _I, _I],
    "difffe_tridiag_pcr_max_rows": [_I],
    "difffe_tridiag_pcr": [_P, _L, _P, _L, _P, _L, _P, _I, _I, _I, _I, _P],
    "difffe_tridiag_pcr_warp": [_P, _L, _P, _L, _P, _L, _P, _I, _I, _I, _P],
    "difffe_fused_pcr_workspace": [_I, _I, _I, _I],
    "difffe_fused_pcr": [_I, _P, _L, _P, _L, _I, _P, _L, _I, _P, _P, _P, _P,
                         _I, _I, _I, _I, _D, _D, _I, _P],
    "difffe_fused_pcr_warp": [_I, _P, _L, _P, _L, _I, _P, _L, _I, _P, _P, _P,
                              _I, _I, _D, _D, _I, _P],
    "difffe_thomas_workspace": [_I, _I, _I, _I],
    "difffe_fused_thomas": [_P, _L, _P, _L, _I, _P, _L, _I, _P, _P, _P, _P,
                            _I, _I, _I, _D, _D, _I, _P],
    "difffe_fused_thomas_reg": [_P, _L, _P, _L, _I, _P, _L, _I, _P, _P, _P,
                                _I, _I, _D, _D, _P],
    "difffe_fused_mxu": [_P, _L, _P, _L, _I, _P, _L, _I, _P, _P, _P, _P, _I,
                         _I, _I, _I, _I, _D, _I, _P],
    "difffe_fused_mxu_tc": [_P, _L, _P, _L, _I, _P, _L, _I, _P, _P, _P, _P,
                            _I, _I, _I, _I, _D, _P],
    "difffe_ell_apply": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "difffe_ell_cg": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "difffe_ell_cg_clusters": [_I, _I, _I, _I],
    "difffe_k7_ablation": [_I, _P, _L, _P, _P, _L, _I, _P, _P, _P, _P, _I,
                           _I, _D, _I, _P],
}
# entry points that return a count, not a CUDA error code
_RESTYPES = {"difffe_fused_pcr_workspace": _L,
             "difffe_thomas_workspace": _L}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libdifffe_{h.hexdigest()[:16]}.so"


def find_nvcc() -> str:
    """nvcc from the toolkit PyTorch finds (CUDA_HOME, CUDA_PATH, PATH or
    the default install location)."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").is_file():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels of difffe_tpu_torch are built from source at first use")


def _run_all(commands: list[list[str]], log: list[str]):
    """Run the commands together; raise with the output of any failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in commands]
    failed = []
    for cmd, proc in zip(commands, procs):
        out, _ = proc.communicate()
        log.append(f"$ {' '.join(cmd)}\n{out}")
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)} ({proc.returncode}):\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def build() -> Path:
    """Compile the sources unless the library for them already exists."""
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    cu = [s for s in sources() if s.suffix == ".cu"]
    objs = [BUILD_DIR / f"{tag}.{s.stem}.o" for s in cu]
    tmp = out.with_name(f"{tag}.tmp.so")
    log: list[str] = []
    try:
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)]
                  for s, o in zip(cu, objs)], log)
        _run_all([[nvcc, *NVCC_FLAGS, *LINK_FLAGS, "-o", str(tmp),
                   *map(str, objs)]], log)
        out.with_suffix(".log").write_text("\n".join(log))
        os.replace(tmp, out)        # atomic: concurrent builds agree
    finally:
        tmp.unlink(missing_ok=True)
        for o in objs:
            o.unlink(missing_ok=True)
    return out


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernels; argtypes set for each entry."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _RESTYPES.get(name, ctypes.c_int)
    return lib


_OPS = []       # the package's torch.library fragment, made at first use


def kernel_op(name: str, schema: str, plain, launch, fake):
    """Register a kernel as the op ``difffe::<name>`` and return it
    (``torch.ops.difffe.<name>.default``): ``launch`` is its CUDA
    implementation, ``plain`` (the plain version) its CPU one and ``fake``
    gives the outputs' shapes to ``torch.export``'s trace, so an exported
    program holds the kernel as one node.  A plain ``torch.library``
    registration: ``torch.library.custom_op`` would add a Python autograd
    layer to every launch, which costs the host-bound loops on K2 several
    times as much (probes/k2_dispatch.py times both)."""
    import torch

    if not _OPS:
        _OPS.append(torch.library.Library("difffe", "FRAGMENT"))
    lib = _OPS[0]
    lib.define(name + schema)
    lib.impl(name, plain, "CPU")
    lib.impl(name, launch, "CUDA")
    torch.library.register_fake(f"difffe::{name}", fake, lib=lib)
    return getattr(torch.ops.difffe, name).default


def refuse_traced(kernel: str, *tensors) -> None:
    """Raise ``NotImplementedError`` when a launch of ``kernel`` is traced.

    ``torch.export`` traces with fake tensors, which hold no memory: a
    kernel launched through ctypes on ``data_ptr()`` cannot run in the
    trace, and only an op (:func:`kernel_op`) can be held by an exported
    program.  Every production kernel is such an op; the probes' kernels
    (P2, probes/k7_ablation.py, and K5's warp variants,
    probes/k5_warp_variants.py) are on no path a user exports and call
    this before they launch instead; nothing falls back to the plain
    version."""
    from torch._subclasses.fake_tensor import is_fake

    if any(t is not None and is_fake(t) for t in tensors):
        raise NotImplementedError(
            f"{kernel} is a probe's kernel, not a torch.library op, so "
            f"torch.export cannot carry it (ROADMAP.md: the probes refuse "
            f"export by design)")
