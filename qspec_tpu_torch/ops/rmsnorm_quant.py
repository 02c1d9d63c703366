"""RMSNorm and the fused RMSNorm -> per-token quantization, each optionally
after the residual add: plain PyTorch versions and the wrappers of their
CUDA kernel.

Port of ``qspec_tpu/ops/rmsnorm_quant.py``. QuaRot norms are weightless (the
gammas are folded into the rotated weights offline):

* ``rmsnorm``: y = x * rsqrt(mean(x^2) + eps) [* gamma], bf16 out; the
  verify-side and final norms.
* ``rmsnorm_quant``: the same y, then scale = max(absmax(y), 1e-8) / qmax
  (7 for 4 bits, 127 for 8) and q = clip(round(y / scale)); the draft-side
  input of ``matmul_w4a4``.

With ``residual``, both first form h = x + residual (torch's bf16 add: one
f32 add rounded to bf16), normalize h and return it beside the result: the
decoder's residual add before each norm, in the norm's own pass. The JAX
package gets the same fusion from XLA on its jnp path (M <= 64).

Both run ``csrc/rmsnorm.cu`` (one template over {quant, gamma, residual})
for CUDA tensors at every M; the JAX package uses jnp below M = 64, a TPU
launch-cost choice that does not carry over.
"""

from __future__ import annotations

from typing import Optional

import torch

from qspec_tpu_torch import _build
from qspec_tpu_torch.ops.quant import QuantizedActivation

# the kernel's widest row: 8 vectors of 8 bf16 a thread, 256 threads
MAX_HIDDEN = 16384


def _add(x: torch.Tensor, residual: Optional[torch.Tensor]) -> torch.Tensor:
    return x if residual is None else x + residual


def rmsnorm_ref(x: torch.Tensor, gamma: Optional[torch.Tensor] = None,
                eps: float = 1e-5, residual: Optional[torch.Tensor] = None):
    """Plain RMSNorm; with ``residual``: (normed, h), h = x + residual."""
    h = _add(x, residual)
    xf = h.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    if gamma is not None:
        y = y * gamma.to(torch.float32)
    out = y.to(x.dtype)
    return out if residual is None else (out, h)


def rmsnorm_quant_ref(x: torch.Tensor, gamma: Optional[torch.Tensor] = None,
                      eps: float = 1e-5, bits: int = 4,
                      residual: Optional[torch.Tensor] = None):
    """Plain RMSNorm -> per-token quant; with ``residual``:
    (QuantizedActivation, h), h = x + residual."""
    h = _add(x, residual)
    xf = h.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    if gamma is not None:
        y = y * gamma.to(torch.float32)
    qmax = 7.0 if bits == 4 else 127.0
    qmin = -8.0 if bits == 4 else -128.0
    absmax = y.abs().amax(dim=-1, keepdim=True)
    scale = absmax.clamp_min(1e-8) / qmax
    q = torch.clamp(torch.round(y / scale), qmin, qmax).to(torch.int8)
    out = QuantizedActivation(q, scale)
    return out if residual is None else (out, h)


def _check_rows(x: torch.Tensor, residual: Optional[torch.Tensor], name: str):
    _build.require(x.dtype == torch.bfloat16 and x.dim() == 2,
                   f"{name}: x bf16 [M, H]")
    m, h = x.shape
    _build.require(h % 8 == 0 and h <= MAX_HIDDEN,
                   f"{name}: H must be a multiple of 8 up to {MAX_HIDDEN}, got {h}")
    if residual is not None:
        _build.require(residual.dtype == torch.bfloat16 and residual.shape == x.shape,
                       f"{name}: residual bf16 [M, H] like x")
    return m, h


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def rmsnorm(x: torch.Tensor, gamma: Optional[torch.Tensor] = None,
            eps: float = 1e-5, residual: Optional[torch.Tensor] = None):
    """RMSNorm (optionally gamma-scaled). x: [M, H] bf16 -> bf16 [M, H];
    with ``residual`` [M, H] bf16: (normed, h), h = x + residual (a new
    tensor), the normed rows those of h."""
    if not x.is_cuda:
        return rmsnorm_ref(x, gamma, eps=eps, residual=residual)
    m, h = _check_rows(x, residual, "rmsnorm")
    out = torch.empty_like(x)
    hs = None if residual is None else torch.empty_like(x)
    if m:
        _build.cuda_args_ok(*(t for t in (x, residual, gamma, out, hs) if t is not None))
        if gamma is not None:
            _build.require(gamma.dtype == torch.bfloat16 and tuple(gamma.shape) == (h,),
                           "rmsnorm: gamma bf16 [H]")
        _build.check("rmsnorm", _build.lib().qspec_rmsnorm(
            x.data_ptr(), _ptr(residual), _ptr(gamma), out.data_ptr(), _ptr(hs), m, h,
            eps, _build.stream_of(x)))
        rmsnorm.launches += 1
        rmsnorm.fused_launches += residual is not None
        rmsnorm.gamma_launches += gamma is not None
    return out if residual is None else (out, hs)


rmsnorm.launches = 0
rmsnorm.fused_launches = 0     # those of them with the residual add
rmsnorm.gamma_launches = 0     # those of them with a gamma


def rmsnorm_quant(x: torch.Tensor, eps: float = 1e-5, bits: int = 4,
                  residual: Optional[torch.Tensor] = None):
    """Weightless fused rmsnorm + per-token symmetric quant. x: [M, H] bf16
    -> (int8 [M, H], f32 scales [M, 1]); with ``residual`` [M, H] bf16:
    (that, h), h = x + residual (a new tensor), the quantized rows h's."""
    if not x.is_cuda:
        return rmsnorm_quant_ref(x, eps=eps, bits=bits, residual=residual)
    m, h = _check_rows(x, residual, "rmsnorm_quant")
    _build.require(bits in (4, 8), "rmsnorm_quant: bits 4 or 8")
    q = torch.empty((m, h), dtype=torch.int8, device=x.device)
    scales = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    hs = None if residual is None else torch.empty_like(x)
    if m:
        _build.cuda_args_ok(*(t for t in (x, residual, q, scales, hs) if t is not None))
        qmax, qmin = (7.0, -8.0) if bits == 4 else (127.0, -128.0)
        _build.check("rmsnorm_quant", _build.lib().qspec_rmsnorm_quant(
            x.data_ptr(), _ptr(residual), q.data_ptr(), scales.data_ptr(), _ptr(hs), m, h,
            eps, qmax, qmin, _build.stream_of(x)))
        rmsnorm_quant.launches += 1
        rmsnorm_quant.fused_launches += residual is not None
    out = QuantizedActivation(q, scales)
    return out if residual is None else (out, hs)


rmsnorm_quant.launches = 0
rmsnorm_quant.fused_launches = 0     # those of them with the residual add
