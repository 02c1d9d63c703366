"""The two packed-int4 GEMMs of QSpec: plain PyTorch versions and the wrappers
of their CUDA kernels.

Port of ``qspec_tpu/ops/linear_kernels.py``. One packed-int4 weight buffer
(see packing.py) serves both:

* ``matmul_w4a16``: the verify GEMM, bf16 activations x int4 weights with
  f32 accumulation (kernel ``csrc/w4a16.cu``). At prefill widths it takes
  the dequantize-once branch of ``_w4a16_bigm`` (``linear_kernels.py:294``
  in the JAX package, threshold ``:349``): the weight planes are unpacked
  once with torch ops and multiplied with ``torch.mm`` (bf16 operands, f32
  result), as the JAX package leaves that case to XLA.
* ``matmul_w4a4``: the draft GEMM, int8 activations (int4 range for w4a4,
  full for w4a8) x int4 weights with exact int32 accumulation and a
  per-token x per-channel scale epilogue (kernel ``csrc/w4a4.cu``).

A wrapper runs the plain version only for tensors on the CPU. For CUDA
tensors it launches its kernel or raises; each launch adds one to the
wrapper's ``launches`` count. With ``layer_idx`` the weights are the
layer-stacked ``[L, K//8, N]`` / ``[L, N]`` arrays and the kernel reads layer
``layer_idx`` in place (a pointer offset, no copy).
"""

from __future__ import annotations

from typing import Optional

import torch

from qspec_tpu_torch import _build
from qspec_tpu_torch.ops.packing import (unpack_int4, unpack_int4_high,
                                         unpack_int4_low)

# activation bytes above which matmul_w4a16 takes the dequantize-once branch
# (the JAX package's single-VMEM-tile limit, kept so both take it at the
# same widths)
BIGM_BYTES = 5 * 1024 * 1024


def matmul_w4a16_ref(x: torch.Tensor, w_packed: torch.Tensor,
                     w_scales: torch.Tensor, bias: Optional[torch.Tensor] = None,
                     *, out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain version: x [M, K] bf16, w_packed int32 [K//8, N], scales [N]."""
    w = unpack_int4(w_packed).to(torch.float32)
    out = x.to(torch.bfloat16).to(torch.float32) @ w
    out = out * w_scales.to(torch.float32)[None, :]
    if bias is not None:
        out = out + bias.to(torch.float32)[None, :]
    return out.to(out_dtype)


def matmul_w4a4_ref(x_q: torch.Tensor, x_scales: torch.Tensor,
                    w_packed: torch.Tensor, w_scales: torch.Tensor,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: x_q int8 [M, K], x_scales [M] or [M, 1],
    w_packed int32 [K//8, N], w_scales [N] -> bf16 [M, N]. The integer sums
    are exact in float64 (|sum| < 2^53)."""
    w = unpack_int4(w_packed).to(torch.float64)
    acc = x_q.to(torch.float64) @ w
    out = acc.to(torch.float32) * x_scales.reshape(-1, 1).to(torch.float32)
    out = out * w_scales.to(torch.float32)[None, :]
    if bias is not None:
        out = out + bias.to(torch.float32)[None, :]
    return out.to(torch.bfloat16)


def _layer(w_packed, w_scales, layer_idx):
    if layer_idx is None:
        return w_packed, w_scales
    return w_packed[layer_idx], w_scales[layer_idx]


def _check_w4(k: int, w: torch.Tensor, s: torch.Tensor, name: str) -> int:
    _build.require(w.dtype == torch.int32 and w.dim() == 2 and w.shape[0] * 8 == k,
                   f"{name}: packed weights int32 [K//8, N] with K={k}")
    n = w.shape[1]
    _build.require(s.dtype == torch.float32 and tuple(s.shape) == (n,),
                   f"{name}: weight scales f32 [N]")
    _build.require(k % 32 == 0, f"{name}: K must be a multiple of 32, got {k}")
    return n


def _w4a16_bigm(x, w_packed, w_scales, out_dtype):
    """Prefill-width branch (mirrors the JAX package's _w4a16_bigm): decode
    the two nibble planes once to bf16 integers, two bf16 GEMMs with f32
    results (the halves pairing maps onto two contiguous products), then the
    per-channel scale."""
    lo = unpack_int4_low(w_packed).to(torch.bfloat16)
    hi = unpack_int4_high(w_packed).to(torch.bfloat16)
    kh = lo.shape[0]
    xb = x.to(torch.bfloat16)
    acc = (torch.mm(xb[:, :kh], lo, out_dtype=torch.float32)
           + torch.mm(xb[:, kh:], hi, out_dtype=torch.float32))
    return (acc * w_scales.to(torch.float32)[None, :]).to(out_dtype)


def matmul_w4a16(x: torch.Tensor, w_packed: torch.Tensor, w_scales: torch.Tensor,
                 bias: Optional[torch.Tensor] = None, *, out_dtype=torch.bfloat16,
                 layer_idx: Optional[int] = None) -> torch.Tensor:
    """x [M, K] bf16 @ packed-int4 w [K//8, N] -> [M, N] out_dtype."""
    w, s = _layer(w_packed, w_scales, layer_idx)
    if not x.is_cuda:
        return matmul_w4a16_ref(x, w, s, bias, out_dtype=out_dtype)
    m, k = x.shape
    if max(-(-m // 16) * 16, 16) * 2 * k > BIGM_BYTES:
        out = _w4a16_bigm(x, w, s, out_dtype)
    else:
        n = _check_w4(k, w, s, "matmul_w4a16")
        _build.require(x.dtype == torch.bfloat16, "matmul_w4a16: x bf16")
        _build.require(out_dtype in (torch.bfloat16, torch.float32),
                       "matmul_w4a16: out_dtype bf16 or f32")
        out = torch.empty((m, n), dtype=out_dtype, device=x.device)
        if m:
            _build.cuda_args_ok(x, w, s, out)
            _build.check("matmul_w4a16", _build.lib().qspec_w4a16(
                x.data_ptr(), w.data_ptr(), s.data_ptr(), out.data_ptr(),
                m, k, n, int(out_dtype == torch.float32), _build.stream_of(x)))
            matmul_w4a16.launches += 1
    if bias is not None:
        out = out + bias[None, :].to(out.dtype)
    return out


matmul_w4a16.launches = 0


def matmul_w4a4(x_q: torch.Tensor, x_scales: torch.Tensor, w_packed: torch.Tensor,
                w_scales: torch.Tensor, bias: Optional[torch.Tensor] = None,
                *, layer_idx: Optional[int] = None) -> torch.Tensor:
    """Quantized activations x_q int8 [M, K] (scales [M] or [M, 1]) @
    packed-int4 w [K//8, N] -> bf16 [M, N]."""
    w, s = _layer(w_packed, w_scales, layer_idx)
    if not x_q.is_cuda:
        return matmul_w4a4_ref(x_q, x_scales, w, s, bias)
    m, k = x_q.shape
    n = _check_w4(k, w, s, "matmul_w4a4")
    sx = x_scales.reshape(-1)
    _build.require(x_q.dtype == torch.int8, "matmul_w4a4: x_q int8")
    _build.require(sx.dtype == torch.float32 and sx.shape[0] == m,
                   "matmul_w4a4: x_scales f32 [M] or [M, 1]")
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x_q.device)
    if m:
        _build.cuda_args_ok(x_q, sx, w, s, out)
        _build.check("matmul_w4a4", _build.lib().qspec_w4a4(
            x_q.data_ptr(), sx.data_ptr(), w.data_ptr(), s.data_ptr(),
            out.data_ptr(), m, k, n, _build.stream_of(x_q)))
        matmul_w4a4.launches += 1
    if bias is not None:
        out = out + bias[None, :].to(out.dtype)
    return out


matmul_w4a4.launches = 0
