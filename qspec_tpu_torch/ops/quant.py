"""Per-token symmetric activation quantization (torch ops).

Port of ``qspec_tpu/ops/quant.py``:
  - int4: scale = max(absmax, 1e-8) / 7, values rounded half to even and
    clamped to [-8, 7];
  - int8: scale = max(absmax, 1e-8) / 127, clamped to [-128, 127].
The values stay int8 (int4 range for w4a4): the draft GEMM widens packed
weights to s8 and multiplies s8 x s8, so packing activations would only add
work.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class QuantizedActivation(NamedTuple):
    values: torch.Tensor  # int8 [..., hidden] (int4 range for w4a4)
    scales: torch.Tensor  # f32 [..., 1]


def _sym_quant(x: torch.Tensor, qmax: float, qmin: float) -> QuantizedActivation:
    xf = x.to(torch.float32)
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    scale = absmax.clamp_min(1e-8) / qmax
    q = torch.clamp(torch.round(xf / scale), qmin, qmax).to(torch.int8)
    return QuantizedActivation(q, scale)


def sym_quant_int4(x: torch.Tensor) -> QuantizedActivation:
    """Per-token symmetric int4 quantization (absmax / 7)."""
    return _sym_quant(x, 7.0, -8.0)


def sym_quant_int8(x: torch.Tensor) -> QuantizedActivation:
    """Per-token symmetric int8 quantization (absmax / 127)."""
    return _sym_quant(x, 127.0, -128.0)


def sym_dequant(q: QuantizedActivation, dtype=torch.bfloat16) -> torch.Tensor:
    return (q.values.to(torch.float32) * q.scales).to(dtype)
