"""Packed-int4 weight representation (the interchange format of both packages).

A quantized linear layer's weight is stored once as int4 values packed into
int32 words, plus one f32 scale per output channel. The W4A4 draft GEMM and
the W4A16 verify GEMM both read this one buffer.

Layout ``[in // 8, out]`` int32, "SWAR" words: byte b (little-endian) of word
row s is packed row r = 4*s + b, whose low nibble holds w[r] and high nibble
w[r + in//2] (halves pairing), both stored excess-8 (v + 8, range [0, 15]).
This is the layout of ``qspec_tpu/ops/packing.py:pack_int4``; the CUDA GEMMs
(``csrc/w4a16.cu``, ``csrc/w4a4.cu``) decode it in registers as it is, so no
repacking happens at load.
"""

from __future__ import annotations

import numpy as np
import torch


def pack_int4(w: torch.Tensor) -> torch.Tensor:
    """Pack int4 values (range [-8, 7]) along axis 0: [in, out] -> int32
    [in // 8, out] (see the module docstring for the layout)."""
    if w.shape[0] % 8 != 0:
        raise ValueError(f"in-dim must be divisible by 8, got {tuple(w.shape)}")
    half = w.shape[0] // 2
    w = w.to(torch.int32)
    lo = (w[:half] + 8) & 0x0F
    hi = (w[half:] + 8) & 0x0F
    byte = (hi << 4) | lo                      # [in//2, out] values 0..255
    b0, b1, b2, b3 = byte[0::4], byte[1::4], byte[2::4], byte[3::4]
    # b3 << 24 may exceed int32 range: build in int64, then wrap to int32
    word = (b0.to(torch.int64) | (b1.to(torch.int64) << 8)
            | (b2.to(torch.int64) << 16) | (b3.to(torch.int64) << 24))
    return torch.where(word >= 2 ** 31, word - 2 ** 32, word).to(torch.int32)


def _planes(packed: torch.Tensor, shift0: int) -> torch.Tensor:
    u = packed.to(torch.int64) & 0xFFFFFFFF
    vals = [((u >> (8 * b + shift0)) & 0x0F) - 8 for b in range(4)]
    out = torch.stack(vals, dim=-2)            # [..., in//8, 4, out]
    shape = packed.shape[:-2] + (packed.shape[-2] * 4, packed.shape[-1])
    return out.reshape(shape).to(torch.int8)


def unpack_int4_low(packed: torch.Tensor) -> torch.Tensor:
    """Low-nibble plane as int8: in-positions [0, in//2).
    int32 [..., in//8, out] -> [..., in//2, out]."""
    return _planes(packed, 0)


def unpack_int4_high(packed: torch.Tensor) -> torch.Tensor:
    """High-nibble plane as int8: in-positions [in//2, in)."""
    return _planes(packed, 4)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: int32 [..., in//8, out] -> int8 [..., in, out]."""
    return torch.cat([unpack_int4_low(packed), unpack_int4_high(packed)], dim=-2)


def pack_int4_np(w: np.ndarray) -> np.ndarray:
    """NumPy twin of :func:`pack_int4`."""
    if w.shape[0] % 8 != 0:
        raise ValueError(f"in-dim must be divisible by 8, got {w.shape}")
    half = w.shape[0] // 2
    w = w.astype(np.int64)
    lo = (w[:half] + 8) & 0x0F
    hi = (w[half:] + 8) & 0x0F
    byte = (hi << 4) | lo
    word = (byte[0::4] | (byte[1::4] << 8) | (byte[2::4] << 16)
            | (byte[3::4] << 24))
    return word.astype(np.uint32).view(np.int32)


def quantize_weight_int4(w: np.ndarray):
    """Symmetric per-output-channel int4 quantization of a float [in, out]
    weight: scale = max(absmax, 1e-8) / 7, values clamped to [-8, 7].
    Returns (packed int32 [in//8, out], scales f32 [out])."""
    absmax = np.abs(w).max(axis=0, keepdims=True)
    scale = np.maximum(absmax, 1e-8) / 7.0
    q = np.clip(np.rint(w / scale), -8, 7).astype(np.int8)
    return pack_int4_np(q), scale.squeeze(0).astype(np.float32)


def quantize_weight_int4_torch(w: torch.Tensor):
    """:func:`quantize_weight_int4` on a tensor, on its own device (used to
    make random packed weights on the card without a host round trip)."""
    absmax = w.abs().amax(dim=0, keepdim=True)
    scale = absmax.clamp_min(1e-8) / 7.0
    q = torch.clamp(torch.round(w / scale), -8, 7)
    return pack_int4(q), scale.squeeze(0).to(torch.float32)
