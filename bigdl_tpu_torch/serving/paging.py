"""Host-side page bookkeeping for the paged KV cache (the port's own copy
of bigdl_tpu/serving/paging.py, which it may not import).

A compiled tick only ever sees a block table (an (S, M) int32 tensor)
and the page pool (:mod:`bigdl_tpu_torch.ops.paged_kv`).  Everything
stateful (the free list, which slot owns which physical page) lives
here on the host, in plain Python, under one thread.

The decode engine's defaults, read from the environment as the JAX
package reads them:

* ``BIGDL_TPU_KV_PAGE``: tokens per page (default 16);
* ``BIGDL_TPU_KV_DTYPE``: ``int8`` quantizes the pool (default: the
  model's compute type);
* ``BIGDL_TPU_PAGE_ZERO``: ``1`` zeroes freed pages through the
  ``page_reset`` program (hygiene only: the length mask hides stale
  bytes);
* ``BIGDL_TPU_DRAFT_K``: draft tokens per speculative round (default 3).
"""
from __future__ import annotations

import os
from collections import deque
from typing import List, Optional

import numpy as np


def page_size_default() -> int:
    return int(os.environ.get("BIGDL_TPU_KV_PAGE", "16"))


def kv_dtype_default() -> Optional[str]:
    v = os.environ.get("BIGDL_TPU_KV_DTYPE", "").strip().lower()
    return v or None


def draft_k_default() -> int:
    return int(os.environ.get("BIGDL_TPU_DRAFT_K", "3"))


def page_zero_enabled() -> bool:
    return os.environ.get("BIGDL_TPU_PAGE_ZERO", "0") == "1"


def default_num_pages(slots: int, max_len: int, page_size: int) -> int:
    """Worst-case pool (every slot at max_len) + the trash page — the
    conservative default; callers shrink it to trade HBM for eviction
    risk."""
    per_slot = -(-max_len // page_size)
    return slots * per_slot + 1


class OutOfPagesError(RuntimeError):
    """The pool has no free page and no evictable donor."""


class PageAllocator:
    """Free-list allocator over physical pages 1..P-1 (0 is the trash
    page, :mod:`bigdl_tpu_torch.ops.paged_kv`).  ``table`` is the live
    (S, M) block table handed to every tick; unmapped entries stay 0 so
    stray reads and redirected writes land on trash."""

    def __init__(self, num_pages: int, page_size: int, slots: int,
                 max_len: int):
        if num_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is reserved)")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.slots = int(slots)
        self.max_len = int(max_len)
        self.pages_per_slot = -(-self.max_len // self.page_size)
        self.table = np.zeros((self.slots, self.pages_per_slot),
                              np.int32)
        self._free: deque = deque(range(1, self.num_pages))
        self._owned: List[List[int]] = [[] for _ in range(self.slots)]

    # ------------------------------------------------------------ stats
    @property
    def pages_in_use(self) -> int:
        return (self.num_pages - 1) - len(self._free)

    @property
    def pages_free(self) -> int:
        return len(self._free)

    def owned(self, slot: int) -> int:
        return len(self._owned[slot])

    # ------------------------------------------------------- allocation
    def needed(self, slot: int, tokens: int) -> int:
        """How many new pages ``slot`` needs to hold ``tokens``."""
        want = min(-(-max(tokens, 0) // self.page_size),
                   self.pages_per_slot)
        return max(0, want - len(self._owned[slot]))

    def ensure(self, slot: int, tokens: int) -> bool:
        """Grow ``slot``'s mapping to cover ``tokens`` logical tokens.
        Returns False (mapping unchanged) when the free list is short —
        the engine then evicts a donor slot and retries."""
        need = self.needed(slot, tokens)
        if need > len(self._free):
            return False
        own = self._owned[slot]
        for _ in range(need):
            phys = self._free.popleft()
            self.table[slot, len(own)] = phys
            own.append(phys)
        return True

    def release(self, slot: int) -> List[int]:
        """Free every page ``slot`` owns (retirement / eviction);
        returns the freed physical page ids (for optional zeroing)."""
        freed = self._owned[slot]
        self._owned[slot] = []
        self.table[slot, :] = 0
        self._free.extend(freed)
        return freed
