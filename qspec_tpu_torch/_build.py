"""Build and bind the port's CUDA kernels.

All sources under ``csrc/`` are compiled by ONE ``nvcc`` call for ``sm_90a``
into a shared library with a plain ``extern "C"`` interface, loaded with
``ctypes``. Nothing includes PyTorch's headers, so the build takes seconds.
The library lands in ``_build/<hash>/libqspec_kernels.so``, keyed by a hash of
the sources and flags, and is built at the first kernel launch of a process.

Every exported function takes device pointers, ints and the CUDA stream, and
returns ``cudaGetLastError()`` after its launch; :func:`check` turns a
nonzero code into an exception. A build or launch failure raises: there is no
fallback to the plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
SOURCES = ("w4a16.cu", "w4a4.cu", "rmsnorm.cu", "paged_attention.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
SIGNATURES = {
    "qspec_w4a16": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "qspec_w4a4": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    "qspec_rmsnorm": (_P, _P, _P, _I, _I, _F, _P),
    "qspec_rmsnorm_quant": (_P, _P, _P, _I, _I, _F, _F, _F, _P),
    "qspec_paged_attention": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                              _F, _P),
}

_lib = None
# seconds the nvcc call took (0.0 when the library was already built) and
# the per-kernel `-Xptxas -v` summary of that build
build_info: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


def _ptxas_summary(log: str) -> dict:
    """{kernel: 'regs=R smem=B spill=S'} from nvcc's -Xptxas -v output."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            out.setdefault(fn, {})["spill_stores"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            d = out.setdefault(fn, {})
            d["regs"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            d["smem"] = int(s.group(1)) if s else 0
    return out


def library_path() -> Path:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / h.hexdigest()[:16] / "libqspec_kernels.so"


def build() -> Path:
    """Compile the sources if this hash has no library yet; return its path."""
    path = library_path()
    if path.exists():
        build_info.setdefault("seconds", 0.0)
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(CSRC / s) for s in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}"
                           f"\n{proc.stdout}")
    os.replace(tmp, path)
    build_info["seconds"] = seconds
    build_info["ptxas"] = _ptxas_summary(proc.stderr + proc.stdout)
    return path


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, args in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        handle.qspec_error_string.argtypes = (ctypes.c_int,)
        handle.qspec_error_string.restype = ctypes.c_char_p
        _lib = handle
    return _lib


def check(name: str, code: int) -> None:
    if code != 0:
        msg = lib().qspec_error_string(code).decode()
        raise RuntimeError(f"{name} launch failed: {msg} (cudaError {code})")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require(cond: bool, what: str) -> None:
    """Reject inputs a kernel does not take (raise, never fall back)."""
    if not cond:
        raise ValueError(what)


def cuda_args_ok(*tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        require(t.is_cuda and t.device == dev, "all tensors on one CUDA device")
        require(t.is_contiguous(), "contiguous tensors")
        require(t.data_ptr() % 16 == 0, "16-byte aligned tensors")
