"""Rotary position embedding, neox or gptj style, over all of a head or
the first ``rotary_dim`` dims of it.

Port of ``qspec_tpu/ops/rotary.py`` (plain rope, llama3-style scaling and
Phi-3's longrope; the half-split (neox) and interleaved (gptj) pairings;
partial rotary; the JAX package leaves rope to XLA, so it stays torch ops
here). A dynamic NTK scaling (InternLM2) changes the base only past its
original window, so inside it the cache is the plain one; a cache past that
window raises. Any other rope scaling raises: the JAX package returns the
unscaled cache for it (ROADMAP §3).
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch


@functools.lru_cache(maxsize=8)
def _cos_sin_cache(head_dim: int, max_positions: int, base: float,
                   scaling_factor: Optional[float]) -> np.ndarray:
    inv_freq = 1.0 / (base ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))
    t = np.arange(max_positions, dtype=np.float64)
    if scaling_factor is not None:
        t = t / scaling_factor
    freqs = np.outer(t, inv_freq)
    return np.stack([np.cos(freqs), np.sin(freqs)], axis=0).astype(np.float32)


def make_rope_cache(head_dim: int, max_positions: int = 8192, base: float = 500000.0,
                    scaling_factor: Optional[float] = None,
                    rope_scaling: Optional[dict] = None,
                    device=None) -> torch.Tensor:
    """[2, max_positions, head_dim//2] float32 (cos, sin); llama3-style
    rope scaling (low/high frequency factors) and Phi-3's longrope ("su"),
    as in the JAX package; "dynamic" (NTK) inside its
    ``original_max_position_embeddings``, where it is the plain cache."""
    cache = _cos_sin_cache(head_dim, max_positions, base, scaling_factor)
    if rope_scaling and rope_scaling.get("rope_type", rope_scaling.get("type")) == "llama3":
        factor = rope_scaling["factor"]
        low = rope_scaling["low_freq_factor"]
        high = rope_scaling["high_freq_factor"]
        orig_ctx = rope_scaling["original_max_position_embeddings"]
        inv_freq = 1.0 / (base ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))
        wavelen = 2 * np.pi / inv_freq
        new_inv = np.where(wavelen > orig_ctx / low, inv_freq / factor, inv_freq)
        smooth = (orig_ctx / wavelen - low) / (high - low)
        mid = (1 - smooth) / factor * inv_freq + smooth * inv_freq
        is_mid = (wavelen <= orig_ctx / low) & (wavelen >= orig_ctx / high)
        new_inv = np.where(is_mid, mid, new_inv)
        t = np.arange(max_positions, dtype=np.float64)
        freqs = np.outer(t, new_inv)
        cache = np.stack([np.cos(freqs), np.sin(freqs)], axis=0).astype(np.float32)
    elif rope_scaling and rope_scaling.get(
            "rope_type", rope_scaling.get("type")) in ("longrope", "su"):
        # per-dim inv_freq divisors, the short ones for positions inside the
        # original window and the long ones past it (chosen by position),
        # and the sqrt-log attention factor folded into cos and sin
        orig_ctx = rope_scaling.get("original_max_position_embeddings", max_positions)
        short = np.asarray(rope_scaling["short_factor"], np.float64)
        long = np.asarray(rope_scaling["long_factor"], np.float64)
        inv_freq = 1.0 / (base ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))
        scale = max_positions / orig_ctx
        mscale = 1.0 if scale <= 1.0 else np.sqrt(1.0 + np.log(scale) / np.log(orig_ctx))
        t = np.arange(max_positions, dtype=np.float64)
        freqs = np.where((t >= orig_ctx)[:, None], np.outer(t, inv_freq / long),
                         np.outer(t, inv_freq / short))
        cache = (np.stack([np.cos(freqs), np.sin(freqs)], axis=0) * mscale).astype(np.float32)
    elif rope_scaling and rope_scaling.get("rope_type", rope_scaling.get("type")) == "dynamic":
        window = rope_scaling.get("original_max_position_embeddings")
        if window is None or max_positions > window:
            raise NotImplementedError(
                f"dynamic NTK rope over {max_positions} positions, past its window of "
                f"{window}: the base grows with the sequence past the window, which the "
                "port does not serve (inside it the rope is the plain one)")
    elif rope_scaling:
        raise NotImplementedError(f"rope_scaling {rope_scaling!r} is not ported")
    return torch.as_tensor(np.ascontiguousarray(cache), device=device)


def apply_rope(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor,
               cache: torch.Tensor, style: str = "neox"):
    """Rotary rotation. q: [T, Hq, D], k: [T, Hk, D], positions: [T].

    The rotated width is the cache's, 2 * cache.shape[-1]; the dims past it
    pass through unrotated (partial rotary: GPT-NeoX / Pythia, Phi, GPT-J,
    StableLM, GLM, Qwen v1's rotary_pct).

    style: "neox" rotates half-split pairs (x_i, x_{i+rd/2}); "gptj"
    rotates interleaved pairs (x_{2i}, x_{2i+1}) (GPT-J, Cohere, GLM,
    Helium). ``ModelConfig`` refuses any other ``rope_style``."""
    pos = positions.to(torch.int64)
    cos = cache[0][pos][:, None, :]  # [T, 1, rd/2]
    sin = cache[1][pos][:, None, :]
    rd = 2 * cache.shape[-1]

    def rot(x):
        xf = x.to(torch.float32)
        xr, xp = xf[..., :rd], xf[..., rd:]
        if style == "gptj":
            x1, x2 = xr[..., 0::2], xr[..., 1::2]
            out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                              dim=-1).reshape(xr.shape)
        else:
            half = rd // 2
            x1, x2 = xr[..., :half], xr[..., half:]
            out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
        if rd < x.shape[-1]:
            out = torch.cat([out, xp], dim=-1)
        return out.to(x.dtype)

    return rot(q), rot(k)
