"""RMSNorm and the fused RMSNorm -> per-token quantization: plain PyTorch
versions and the wrappers of their CUDA kernel.

Port of ``qspec_tpu/ops/rmsnorm_quant.py``. QuaRot norms are weightless (the
gammas are folded into the rotated weights offline):

* ``rmsnorm``: y = x * rsqrt(mean(x^2) + eps) [* gamma], bf16 out; the
  verify-side and final norms.
* ``rmsnorm_quant``: the same y, then scale = max(absmax(y), 1e-8) / qmax
  (7 for 4 bits, 127 for 8) and q = clip(round(y / scale)); the draft-side
  input of ``matmul_w4a4``.

Both run ``csrc/rmsnorm.cu`` (one template, two epilogues) for CUDA tensors at
every M; the JAX package uses jnp below M = 64, a TPU launch-cost choice that
does not carry over.
"""

from __future__ import annotations

from typing import Optional

import torch

from qspec_tpu_torch import _build
from qspec_tpu_torch.ops.quant import QuantizedActivation


def rmsnorm_ref(x: torch.Tensor, gamma: Optional[torch.Tensor] = None,
                eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    if gamma is not None:
        y = y * gamma.to(torch.float32)
    return y.to(x.dtype)


def rmsnorm_quant_ref(x: torch.Tensor, gamma: Optional[torch.Tensor] = None,
                      eps: float = 1e-5, bits: int = 4) -> QuantizedActivation:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    if gamma is not None:
        y = y * gamma.to(torch.float32)
    qmax = 7.0 if bits == 4 else 127.0
    qmin = -8.0 if bits == 4 else -128.0
    absmax = y.abs().amax(dim=-1, keepdim=True)
    scale = absmax.clamp_min(1e-8) / qmax
    q = torch.clamp(torch.round(y / scale), qmin, qmax).to(torch.int8)
    return QuantizedActivation(q, scale)


def _check_rows(x: torch.Tensor, name: str):
    _build.require(x.dtype == torch.bfloat16 and x.dim() == 2,
                   f"{name}: x bf16 [M, H]")
    m, h = x.shape
    _build.require(h % 8 == 0, f"{name}: H must be a multiple of 8, got {h}")
    return m, h


def rmsnorm(x: torch.Tensor, gamma: Optional[torch.Tensor] = None,
            eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm (optionally gamma-scaled). x: [M, H] bf16."""
    if not x.is_cuda:
        return rmsnorm_ref(x, gamma, eps=eps)
    m, h = _check_rows(x, "rmsnorm")
    out = torch.empty_like(x)
    if m:
        ts = (x, out) if gamma is None else (x, gamma, out)
        _build.cuda_args_ok(*ts)
        if gamma is not None:
            _build.require(gamma.dtype == torch.bfloat16 and tuple(gamma.shape) == (h,),
                           "rmsnorm: gamma bf16 [H]")
        _build.check("rmsnorm", _build.lib().qspec_rmsnorm(
            x.data_ptr(), None if gamma is None else gamma.data_ptr(),
            out.data_ptr(), m, h, eps, _build.stream_of(x)))
        rmsnorm.launches += 1
    return out


rmsnorm.launches = 0


def rmsnorm_quant(x: torch.Tensor, eps: float = 1e-5,
                  bits: int = 4) -> QuantizedActivation:
    """Weightless fused rmsnorm + per-token symmetric quant. x: [M, H] bf16
    -> (int8 [M, H], f32 scales [M, 1])."""
    if not x.is_cuda:
        return rmsnorm_quant_ref(x, eps=eps, bits=bits)
    m, h = _check_rows(x, "rmsnorm_quant")
    _build.require(bits in (4, 8), "rmsnorm_quant: bits 4 or 8")
    q = torch.empty((m, h), dtype=torch.int8, device=x.device)
    scales = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    if m:
        _build.cuda_args_ok(x, q, scales)
        qmax, qmin = (7.0, -8.0) if bits == 4 else (127.0, -128.0)
        _build.check("rmsnorm_quant", _build.lib().qspec_rmsnorm_quant(
            x.data_ptr(), q.data_ptr(), scales.data_ptr(), m, h, eps, qmax,
            qmin, _build.stream_of(x)))
        rmsnorm_quant.launches += 1
    return QuantizedActivation(q, scales)


rmsnorm_quant.launches = 0
