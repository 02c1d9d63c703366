"""Host-RAM parking lot for swap-mode preemption.

Port of ``qspec_tpu/core/swap.py``. A preempted sequence's KV pages are
gathered from the card into host tensors (``ModelRunner.gather_pages``) and
parked here; on resume they are scattered back into freshly allocated pages
(``ModelRunner.write_pages``). The capacity is ``CacheConfig.swap_space_gb``:
when the pool is full the scheduler falls back to recompute preemption.
"""

from __future__ import annotations

from typing import Dict


class HostSwapPool:
    """seq_id -> parked KV payload, with a byte budget.

    A payload is whatever the engine hands in (the target cache's pages,
    the draft cache's or its ring's, the 8-bit scales); the pool accounts
    bytes by page count, ``page_bytes`` each."""

    def __init__(self, max_bytes: int, page_bytes: int):
        self.max_bytes = int(max_bytes)
        self.page_bytes = max(1, int(page_bytes))
        self._entries: Dict[int, tuple] = {}   # seq_id -> (n_pages, payload)
        self.used_pages = 0
        # counters surfaced into the engine's stats
        self.num_swap_outs = 0
        self.num_swap_ins = 0

    @property
    def used_bytes(self) -> int:
        return self.used_pages * self.page_bytes

    def can_reserve(self, n_pages: int) -> bool:
        return (self.used_pages + n_pages) * self.page_bytes <= self.max_bytes

    def put(self, seq_id: int, n_pages: int, payload) -> None:
        if seq_id in self._entries:
            raise ValueError(f"sequence {seq_id} is already swapped out")
        self._entries[seq_id] = (n_pages, payload)
        self.used_pages += n_pages
        self.num_swap_outs += 1

    def has(self, seq_id: int) -> bool:
        return seq_id in self._entries

    def pop(self, seq_id: int):
        n_pages, payload = self._entries.pop(seq_id)
        self.used_pages -= n_pages
        self.num_swap_ins += 1
        return payload

    def discard(self, seq_id: int) -> None:
        if seq_id in self._entries:
            n_pages, _ = self._entries.pop(seq_id)
            self.used_pages -= n_pages
