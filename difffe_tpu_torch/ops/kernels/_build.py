"""Build the package's CUDA sources with nvcc and load them with ctypes.

``load_library()`` compiles every ``difffe_tpu_torch/csrc/*.cu`` into one
shared library with a plain C interface, on first use, into
``difffe_tpu_torch/_build/libdifffe_<hash>.so``.  The name carries a hash
of the sources and the flags, so an edit rebuilds and an unchanged tree
reuses the library.  The library includes no PyTorch header, which keeps
the build to seconds; tensors cross as raw pointers.
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
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points: name -> argtypes (every pointer and the stream as void*)
_SIGNATURES = {
    "difffe_cf_step": [_P, _P, _I, _P, _P, _P, _I, _I, _I, _F, _F, _F, _P],
    "difffe_cf_chain": [_P, _P, _I, _P, _P, _P, _I, _I, _I, _F, _F, _F,
                        _I, _F, _P],
}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
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


def nvcc_command(out: Path) -> list[str]:
    cu = [str(s) for s in sources() if s.suffix == ".cu"]
    return [find_nvcc(), *NVCC_FLAGS, "-o", str(out), *cu]


def build() -> Path:
    """Compile the sources unless the library for them already exists."""
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run(nvcc_command(tmp), capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)            # atomic: concurrent builds agree
    return out


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernels; argtypes set for each entry."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
