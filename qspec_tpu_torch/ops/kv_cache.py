"""Paged KV cache on the card.

Port of ``qspec_tpu/ops/kv_cache.py``. The cache is ONE tensor for all
layers:

    kv_pages : [num_layers, num_pages, 2, num_kv_heads, page_size, head_dim]

with K at index 0 and V at index 1 of the third axis: one page holds K and V
of every kv head, head-major, so the attention kernel reads a (page, head)
K or V slice as one contiguous [page_size, head_dim] block. Page 0 is the
null page: block tables are padded with 0 and padding tokens write there.

Entry types (``KV_DTYPES``), as in the JAX package:

- "bfloat16": the new K/V as they are;
- "int8": per-(k/v, head, token) absmax scale, kept in
  ``kv_scales`` [L, P, 2, Hkv, S] f32; values round(x / s), s = absmax / 127;
- "fp8_e4m3": the same scales with s = absmax / 448 (e4m3's largest
  normal), values cast to float8_e4m3fn (the cast rounds);
- "fp8_e5m2": a scale-free cast of the bf16 values, no ``kv_scales``.

The quantization is per token, so a token's stored bytes depend only on its
own K/V: no reduction runs across tokens, and what a sequence sees in the
cache does not depend on what else is in the batch. It is torch ops, as the
JAX package leaves it to XLA; the attention kernel reads the 8-bit pages and
their scales directly.

Unlike the JAX package, whose writes are functional (donated under jit),
``update_layer`` writes the cache tensors in place with ``index_put_`` and
returns the same cache object.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

KV_DTYPES = ("bfloat16", "int8", "fp8_e4m3", "fp8_e5m2")


def kv_entry_dtype(dtype: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "int8": torch.int8,
            "fp8_e4m3": torch.float8_e4m3fn,
            "fp8_e5m2": torch.float8_e5m2}[dtype]


def kv_entry_bytes(dtype: str) -> int:
    return 2 if dtype == "bfloat16" else 1


def kv_has_scales(dtype: str) -> bool:
    return dtype in ("int8", "fp8_e4m3")


class KVCacheConfig(NamedTuple):
    num_layers: int
    num_kv_heads: int
    head_dim: int
    num_pages: int
    page_size: int = 16
    dtype: str = "bfloat16"  # one of KV_DTYPES


class PagedKVCache(NamedTuple):
    kv_pages: torch.Tensor  # [L, P, 2, Hkv, page, D]; [.., 0, ..]=K, 1=V
    kv_scales: Optional[torch.Tensor] = None  # [L, P, 2, Hkv, page] f32 (int8, e4m3)

    @property
    def page_size(self) -> int:
        return self.kv_pages.shape[4]

    @property
    def num_pages(self) -> int:
        return self.kv_pages.shape[1]

    @property
    def num_layers(self) -> int:
        return self.kv_pages.shape[0]

    @property
    def num_kv_heads(self) -> int:
        return self.kv_pages.shape[3]


def allocate(cfg: KVCacheConfig, device) -> PagedKVCache:
    if cfg.dtype not in KV_DTYPES:
        raise ValueError(f"kv_cache_dtype={cfg.dtype!r} not in {KV_DTYPES}")
    shape = (cfg.num_layers, cfg.num_pages, 2, cfg.num_kv_heads, cfg.page_size,
             cfg.head_dim)
    pages = torch.zeros(shape, dtype=kv_entry_dtype(cfg.dtype), device=device)
    if kv_has_scales(cfg.dtype):
        return PagedKVCache(pages, torch.zeros(shape[:-1], dtype=torch.float32,
                                               device=device))
    return PagedKVCache(pages)


def kv_cache_bytes(cfg: KVCacheConfig) -> int:
    """Device bytes of one pool: the entries plus, for int8 / e4m3, one f32
    scale per (layer, page, k/v, head, token)."""
    tokens = 2 * cfg.num_layers * cfg.num_pages * cfg.page_size * cfg.num_kv_heads
    base = tokens * cfg.head_dim * kv_entry_bytes(cfg.dtype)
    if kv_has_scales(cfg.dtype):
        base += tokens * 4
    return base


def update_layer(cache: PagedKVCache, layer: int, k_new: torch.Tensor,
                 v_new: torch.Tensor, slot_mapping: torch.Tensor) -> PagedKVCache:
    """Scatter new tokens into one layer's pages, in place, quantizing them
    to the cache's entry type.

    k_new/v_new: [T, Hkv, D]; slot_mapping: [T] flat slot =
    page_id * page_size + offset. Padding tokens map to slot 0 (the null
    page). Row (kv, h) of token t lands at flat row
    layer*P*2*Hkv*S + page*2*Hkv*S + kv*Hkv*S + h*S + offset of the
    [L*P*2*Hkv*S, D] view (and at the same index of the flat scales), all
    written by one index_put_ per tensor.
    """
    L, P, _, H, S, D = cache.kv_pages.shape
    if k_new.shape[-1] != D:
        # the cache's head dim is 128-padded (ModelConfig.cache_head_dim);
        # zero lanes never change a QK dot, a V sum or a row's absmax
        pad = D - k_new.shape[-1]
        k_new = torch.nn.functional.pad(k_new, (0, pad))
        v_new = torch.nn.functional.pad(v_new, (0, pad))
    slot = slot_mapping.to(torch.int64)
    page = slot // S
    off = slot % S
    kv_idx = torch.arange(2, device=slot.device)[None, :, None]
    h_idx = torch.arange(H, device=slot.device)[None, None, :]
    rows = (layer * (P * 2 * H * S) + page[:, None, None] * (2 * H * S)
            + kv_idx * (H * S) + h_idx * S + off[:, None, None]).reshape(-1)
    kv_new = torch.stack([k_new, v_new], dim=1)          # [T, 2, H, D]
    dtype = cache.kv_pages.dtype
    if cache.kv_scales is not None:
        qmax = 127.0 if dtype == torch.int8 else 448.0   # e4m3's largest normal
        kv32 = kv_new.to(torch.float32)
        s = kv32.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) / qmax
        scaled = kv32 / s
        if dtype == torch.int8:
            q = torch.clamp(torch.round(scaled), -128, 127).to(torch.int8)
        else:                       # fp8_e4m3: the cast itself rounds
            q = scaled.to(dtype)
        cache.kv_scales.view(-1).index_put_((rows,), s.reshape(-1))
    else:                           # bf16, or fp8_e5m2's scale-free cast
        q = kv_new.to(dtype)
    # the entries are scattered as bytes (index_put_ of the fp8 types is not
    # implemented on every device); uint8 views share the cache's storage
    width = D * q.element_size()
    flat = cache.kv_pages.view(torch.uint8).view(L * P * 2 * H * S, width)
    flat.index_put_((rows,), q.reshape(-1, D).view(torch.uint8))
    return cache


def gather_layer(cache: PagedKVCache, layer: int, block_tables: torch.Tensor):
    """Dense bf16 view of one layer's KV for a batch (plain attention path),
    dequantized if the cache is 8-bit. block_tables [B, pages_per_seq] ->
    (k, v), each [B, Hkv, pages_per_seq * page_size, D]."""
    bt = block_tables.to(torch.int64)
    kv = cache.kv_pages[layer][bt]                       # [B, PPS, 2, H, S, D]
    B, PPS, _, H, S, D = kv.shape
    kv = kv.permute(2, 0, 3, 1, 4, 5).reshape(2, B, H, PPS * S, D)
    if cache.kv_scales is not None:
        sc = cache.kv_scales[layer][bt].permute(2, 0, 3, 1, 4).reshape(2, B, H, PPS * S, 1)
        kv = (kv.to(torch.float32) * sc).to(torch.bfloat16)
    elif kv.dtype != torch.bfloat16:                     # fp8_e5m2
        kv = kv.to(torch.bfloat16)
    return kv[0], kv[1]
