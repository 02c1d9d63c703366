"""Paged-KV page allocator with prefix caching.

The port's copy of qspec_tpu/core/block_manager.py (imports rewritten; the
optional native hash replaced by Python's). Analogue of the reference's block manager + allocators
(vllm/core/block_manager.py:20 SelfAttnBlockSpaceManager,
vllm/core/block/prefix_caching_block.py). Pages index into the single
[L, Hkv, P, page, D] HBM arrays (ops/kv_cache.py); page 0 is reserved as the
null page for padding, so the allocator hands out ids [1, num_pages).

Prefix caching: full pages of prompt tokens are content-hashed (chained hash
of token ids, as prefix_caching_block.py does) and reusable pages are
ref-counted; eviction is LRU over pages with refcount 0. Because the QSpec
draft and target caches share page geometry, one allocation serves both — a
page id means the same slot range in either cache.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional

from qspec_tpu_torch.core.sequence import Sequence


@dataclass
class PageMeta:
    ref_count: int = 0
    content_hash: Optional[int] = None
    last_use: float = 0.0


class PageAllocator:
    """Free-list + refcount + content-hash reuse over [1, num_pages)."""

    def __init__(self, num_pages: int, page_size: int, enable_prefix_caching: bool = True):
        self.num_pages = num_pages
        self.page_size = page_size
        self.enable_prefix_caching = enable_prefix_caching
        self._free: List[int] = list(range(num_pages - 1, 0, -1))  # pop() -> low ids first
        self._meta: Dict[int, PageMeta] = {i: PageMeta() for i in range(1, num_pages)}
        # content hash -> page id (complete, immutable pages only)
        self._hash_to_page: Dict[int, int] = {}
        # pages with refcount 0 still holding reusable content (eviction pool)
        self._evictable: OrderedDict[int, None] = OrderedDict()

    # -- stats ------------------------------------------------------------
    @property
    def num_free(self) -> int:
        return len(self._free) + len(self._evictable)

    # -- core alloc/free --------------------------------------------------
    def _pop_free(self) -> int:
        if self._free:
            return self._free.pop()
        if not self._evictable:
            raise RuntimeError("page pool exhausted (caller must check num_free)")
        # evict LRU reusable page
        page_id, _ = self._evictable.popitem(last=False)
        meta = self._meta[page_id]
        if meta.content_hash is not None:
            self._hash_to_page.pop(meta.content_hash, None)
        meta.content_hash = None
        return page_id

    def allocate_page(self) -> int:
        page_id = self._pop_free()
        meta = self._meta[page_id]
        meta.ref_count = 1
        meta.last_use = time.monotonic()
        return page_id

    def free_page(self, page_id: int) -> None:
        meta = self._meta[page_id]
        meta.ref_count -= 1
        assert meta.ref_count >= 0, f"double free of page {page_id}"
        if meta.ref_count == 0:
            meta.last_use = time.monotonic()
            if self.enable_prefix_caching and meta.content_hash is not None:
                self._evictable[page_id] = None
            else:
                meta.content_hash = None
                self._free.append(page_id)

    def share_page(self, page_id: int) -> int:
        meta = self._meta[page_id]
        if meta.ref_count == 0:
            self._evictable.pop(page_id, None)
        meta.ref_count += 1
        meta.last_use = time.monotonic()
        return page_id

    # -- prefix caching ---------------------------------------------------
    @staticmethod
    def chain_hash(prev_hash: Optional[int], tokens: tuple) -> int:
        return hash((prev_hash, tokens))

    def lookup_cached(self, content_hash: int) -> Optional[int]:
        if not self.enable_prefix_caching:
            return None
        return self._hash_to_page.get(content_hash)

    def register_content(self, page_id: int, content_hash: int) -> None:
        if not self.enable_prefix_caching:
            return
        meta = self._meta[page_id]
        meta.content_hash = content_hash
        existing = self._hash_to_page.get(content_hash)
        if existing is None:
            self._hash_to_page[content_hash] = page_id


class BlockManager:
    """Sequence-level paging API (reference block_manager.py:20 interface:
    can_allocate/allocate/append_slots/free, plus prefix-cache hit length)."""

    def __init__(self, num_pages: int, page_size: int, enable_prefix_caching: bool = True):
        self.allocator = PageAllocator(num_pages, page_size, enable_prefix_caching)
        self.page_size = page_size

    def pages_needed(self, num_tokens: int) -> int:
        return -(-num_tokens // self.page_size)

    def can_allocate(self, seq: Sequence, lookahead: int = 0) -> bool:
        need = self.pages_needed(seq.num_tokens + lookahead) - len(seq.page_ids)
        return self.allocator.num_free >= need

    def allocate_prompt(self, seq: Sequence, lookahead: int = 0) -> int:
        """Allocate pages for the whole prompt (+lookahead); returns the
        number of leading prompt tokens served from the prefix cache.

        Freshly-allocated full pages are NOT registered into the prefix
        cache here — their KV has not been computed yet, and serving them to
        a concurrent same-prefix request would hand out garbage KV. Their
        hashes are stashed on the sequence and registered by
        ``mark_computed`` once prefill has actually written them (the
        reference marks blocks computed after execution,
        vllm/core/block/prefix_caching_block.py)."""
        assert not seq.page_ids
        tokens = tuple(seq.prompt_token_ids)
        n_full = len(tokens) // self.page_size
        cached_tokens = 0
        prev_hash: Optional[int] = None
        reused = True
        # embeds-fed prompts hold placeholder token ids: their pages must
        # neither hit nor feed the token-content-keyed prefix cache
        # (reference: prompt_embeds requests bypass prefix caching)
        cacheable = getattr(seq, "prompt_embeds", None) is None
        seq.pending_page_hashes = []
        for i in range(n_full):
            chunk = tokens[i * self.page_size:(i + 1) * self.page_size]
            prev_hash = PageAllocator.chain_hash(prev_hash, chunk)
            hit = (self.allocator.lookup_cached(prev_hash)
                   if reused and cacheable else None)
            if hit is not None:
                seq.page_ids.append(self.allocator.share_page(hit))
                cached_tokens += self.page_size
            else:
                reused = False
                pid = self.allocator.allocate_page()
                if cacheable:
                    seq.pending_page_hashes.append((i, prev_hash))
                seq.page_ids.append(pid)
        # tail / lookahead pages (mutable, never hashed)
        total = self.pages_needed(seq.num_tokens + lookahead)
        while len(seq.page_ids) < total:
            seq.page_ids.append(self.allocator.allocate_page())
        # never serve the *entire* prefill from cache: for a fresh prompt the
        # last token must be recomputed to produce logits (reference caps
        # cached_tokens at prompt_len - 1). A resumed sequence with preserved
        # outputs has more tokens to compute anyway.
        if not seq.output_token_ids and cached_tokens >= seq.prompt_len:
            cached_tokens = (seq.prompt_len - 1) // self.page_size * self.page_size
        return cached_tokens

    def mark_computed(self, seq: Sequence) -> None:
        """Publish content hashes for pages whose KV prefill has written
        (page fully covered by seq.num_computed_tokens)."""
        if not seq.pending_page_hashes:
            return
        done = seq.num_computed_tokens // self.page_size
        remaining = []
        for page_idx, h in seq.pending_page_hashes:
            if page_idx < done:
                self.allocator.register_content(seq.page_ids[page_idx], h)
            else:
                remaining.append((page_idx, h))
        seq.pending_page_hashes = remaining

    def append_slots(self, seq: Sequence, lookahead: int = 1) -> bool:
        """Ensure pages exist for num_tokens + lookahead new tokens.

        Transactional: on failure the sequence keeps exactly its prior
        pages (a partial append used to strand pages on sequences that were
        then preempted, leaking them into the waiting queue)."""
        total = self.pages_needed(seq.num_tokens + lookahead)
        need = total - len(seq.page_ids)
        if need > self.allocator.num_free:
            return False
        for _ in range(need):
            seq.page_ids.append(self.allocator.allocate_page())
        return True

    def free(self, seq: Sequence) -> None:
        for pid in seq.page_ids:
            self.allocator.free_page(pid)
        seq.page_ids = []
        seq.pending_page_hashes = []

    @property
    def num_free_pages(self) -> int:
        return self.allocator.num_free
