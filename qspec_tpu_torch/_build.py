"""Build and bind the port's CUDA kernels.

Each source under ``csrc/`` is compiled for ``sm_90a`` by an ``nvcc`` process
of its own (``paged_attention.cu`` by six, one per KV entry type and one per
MLA head dim: see ``VARIANTS``), all started together, and one more ``nvcc`` call links the
objects into a shared library with a plain ``extern "C"`` interface, loaded
with ``ctypes``. Nothing includes PyTorch's headers, so the build takes
seconds; its wall time is that of the slowest object.
The library lands in ``_build/<hash>/libqspec_kernels.so``, keyed by a hash of
the sources and flags, and is built at the first kernel launch of a process.

Every exported function takes device pointers, ints and the CUDA stream, and
returns ``cudaGetLastError()`` after its launch; :func:`check` turns a
nonzero code into an exception. A build or launch failure raises: there is no
fallback to the plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import functools
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
SOURCES = ("w4.cu", "w4a16_g.cu", "w8a16.cu", "rmsnorm.cu", "paged_attention.cu")
# the sources compiled more than once, each time with other macros (one
# object each): the attention kernel once per KV entry type, its slowest
# source split four ways, and its MLA kernel once per latent head dim (384,
# 640), each over the four entry types
VARIANTS = {"paged_attention.cu": (*(f"-DQSPEC_ATTN_KV={k}" for k in range(4)),
                                   "-DQSPEC_ATTN_MLA=384", "-DQSPEC_ATTN_MLA=640")}
# seconds the build may take before it is abandoned (a hung compiler would
# otherwise hang the first kernel launch)
NVCC_TIMEOUT_S = 300
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
SIGNATURES = {
    "qspec_w4a16": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "qspec_w4a16_g": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "qspec_w4a4": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "qspec_w8a16": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "qspec_w8a16_fp8": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "qspec_rmsnorm": (_P, _P, _P, _P, _P, _I, _I, _F, _P),
    "qspec_rmsnorm_quant": (_P, _P, _P, _P, _P, _I, _I, _F, _F, _F, _P),
    "qspec_norm_launch_floor": (_I, _I, _P),
    "qspec_paged_attention": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _I, _I, _I,
                              _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _I, _P,
                              _I, _P, _I, _P),
}

_lib = None
# seconds the build took (0.0 when the library was already built), each
# source's compile seconds and the per-kernel `-Xptxas -v` summary
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


def units() -> dict:
    """Every object of the build: name -> (source, its extra flags)."""
    out = {}
    for s in SOURCES:
        for flag in VARIANTS.get(s, ("",)):
            name = f"{s}[{flag.rsplit('=', 1)[1]}]" if flag else s
            out[name] = (s, (flag,) if flag else ())
    return out


def library_path() -> Path:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(repr(sorted(VARIANTS.items())).encode())
    return BUILD_DIR / h.hexdigest()[:16] / "libqspec_kernels.so"


def _run_all(cmds: dict, deadline: float) -> dict:
    """Run the commands of ``cmds`` (name -> argv) together; name ->
    (seconds, combined output). Raises on a failure or past ``deadline``
    (time.perf_counter), killing what still runs."""
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
             for name, cmd in cmds.items()}
    out = {}
    try:
        for name, proc in procs.items():
            try:
                log, _ = proc.communicate(timeout=max(deadline - time.perf_counter(), 0))
            except subprocess.TimeoutExpired as e:
                raise RuntimeError(f"nvcc did not finish in {NVCC_TIMEOUT_S} s "
                                   f"({name})") from e
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {name} ({proc.returncode}):\n{log}")
            out[name] = (time.perf_counter() - t0, log)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


def build() -> Path:
    """Compile the sources if this hash has no library yet; return its path."""
    path = library_path()
    if path.exists():
        build_info.setdefault("seconds", 0.0)
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    objs = {u: path.with_name(re.sub(r"\W", "_", u) + f".{tag}.o") for u in units()}
    tmp = path.with_name(f"{path.name}.{tag}")
    nvcc = _nvcc()
    t0 = time.perf_counter()
    deadline = t0 + NVCC_TIMEOUT_S
    try:
        compiled = _run_all({u: [nvcc, *NVCC_FLAGS, *f, "-c", "-o", str(objs[u]), str(CSRC / s)]
                             for u, (s, f) in units().items()}, deadline)
        _run_all({"link": [nvcc, *ARCH, "-shared", "-o", str(tmp),
                           *(str(o) for o in objs.values())]}, deadline)
        os.replace(tmp, path)
    finally:
        for o in (*objs.values(), tmp):
            o.unlink(missing_ok=True)
    build_info["seconds"] = time.perf_counter() - t0
    build_info["compile_seconds"] = {s: round(t, 2) for s, (t, _) in compiled.items()}
    build_info["ptxas"] = _ptxas_summary("\n".join(log for _, log in compiled.values()))
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


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The number of SMs of ``device``'s card."""
    return torch.cuda.get_device_properties(device).multi_processor_count


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
