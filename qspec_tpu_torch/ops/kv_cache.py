"""Paged KV cache on the card.

Port of ``qspec_tpu/ops/kv_cache.py`` (bf16 entries). The cache is ONE tensor
for all layers:

    kv_pages : [num_layers, num_pages, 2, num_kv_heads, page_size, head_dim]

with K at index 0 and V at index 1 of the third axis: one page holds K and V
of every kv head, head-major, so the attention kernel reads a (page, head)
K or V slice as one contiguous [page_size, head_dim] block. Page 0 is the
null page: block tables are padded with 0 and padding tokens write there.

Unlike the JAX package, whose writes are functional (donated under jit),
``update_layer`` writes the cache tensor in place with ``index_put_`` and
returns the same cache object.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

KV_DTYPES = ("bfloat16",)


class KVCacheConfig(NamedTuple):
    num_layers: int
    num_kv_heads: int
    head_dim: int
    num_pages: int
    page_size: int = 16
    dtype: str = "bfloat16"  # one of KV_DTYPES


class PagedKVCache(NamedTuple):
    kv_pages: torch.Tensor  # [L, P, 2, Hkv, page, D]; [.., 0, ..]=K, 1=V

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
        raise NotImplementedError(
            f"kv_cache_dtype={cfg.dtype!r} is not ported yet (bf16 only)")
    shape = (cfg.num_layers, cfg.num_pages, 2, cfg.num_kv_heads, cfg.page_size,
             cfg.head_dim)
    return PagedKVCache(torch.zeros(shape, dtype=torch.bfloat16, device=device))


def update_layer(cache: PagedKVCache, layer: int, k_new: torch.Tensor,
                 v_new: torch.Tensor, slot_mapping: torch.Tensor) -> PagedKVCache:
    """Scatter new tokens into one layer's pages, in place.

    k_new/v_new: [T, Hkv, D]; slot_mapping: [T] flat slot =
    page_id * page_size + offset. Padding tokens map to slot 0 (the null
    page). Row (kv, h) of token t lands at flat row
    layer*P*2*Hkv*S + page*2*Hkv*S + kv*Hkv*S + h*S + offset of the
    [L*P*2*Hkv*S, D] view, all written by one index_put_.
    """
    L, P, _, H, S, D = cache.kv_pages.shape
    if k_new.shape[-1] != D:
        # the cache's head dim is 128-padded (ModelConfig.cache_head_dim);
        # zero lanes never change a QK dot or a V sum
        pad = D - k_new.shape[-1]
        k_new = torch.nn.functional.pad(k_new, (0, pad))
        v_new = torch.nn.functional.pad(v_new, (0, pad))
    flat = cache.kv_pages.view(L * P * 2 * H * S, D)
    slot = slot_mapping.to(torch.int64)
    page = slot // S
    off = slot % S
    kv_idx = torch.arange(2, device=slot.device)[None, :, None]
    h_idx = torch.arange(H, device=slot.device)[None, None, :]
    rows = (layer * (P * 2 * H * S) + page[:, None, None] * (2 * H * S)
            + kv_idx * (H * S) + h_idx * S + off[:, None, None])
    kv_new = torch.stack([k_new, v_new], dim=1).to(cache.kv_pages.dtype)
    flat.index_put_((rows.reshape(-1),), kv_new.reshape(-1, D))
    return cache


def gather_layer(cache: PagedKVCache, layer: int, block_tables: torch.Tensor):
    """Dense view of one layer's KV for a batch (plain attention path).
    block_tables [B, pages_per_seq] -> (k, v), each
    [B, Hkv, pages_per_seq * page_size, D]."""
    kv = cache.kv_pages[layer][block_tables.to(torch.int64)]  # [B, PPS, 2, H, S, D]
    B, PPS, _, H, S, D = kv.shape
    kv = kv.permute(2, 0, 3, 1, 4, 5).reshape(2, B, H, PPS * S, D)
    return kv[0], kv[1]
