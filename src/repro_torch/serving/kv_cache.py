"""Ref-counted paged KV allocator (host control plane).

Pages are the serving analogue of DRAM rows: shared-prefix pages are
allocated once and ref-counted across requests; per-request tail pages are
private. The device-side pools live as (L, P, Hkv, page, d) arrays owned by
the engine; this allocator only manages page indices.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple


class PagedAllocator:
    def __init__(self, n_pages: int, page_size: int):
        self.n_pages = n_pages
        self.page_size = page_size
        self.free: List[int] = list(range(n_pages - 1, -1, -1))
        self.refcount = [0] * n_pages
        self.prefix_pages: Dict[int, List[int]] = {}   # prefix_id -> pages

    # -- raw pages ---------------------------------------------------------
    def alloc_page(self) -> Optional[int]:
        if not self.free:
            return None
        p = self.free.pop()
        self.refcount[p] = 1
        return p

    def ref(self, page: int) -> None:
        assert self.refcount[page] > 0
        self.refcount[page] += 1

    def unref(self, page: int) -> None:
        assert self.refcount[page] > 0
        self.refcount[page] -= 1
        if self.refcount[page] == 0:
            self.free.append(page)

    @property
    def n_free(self) -> int:
        return len(self.free)

    # -- sequences ---------------------------------------------------------
    def pages_needed(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    def alloc_seq(self, total_len: int, prefix_id: Optional[int] = None,
                  prefix_len: int = 0) -> Optional[Tuple[List[int], int]]:
        """Allocate pages for a sequence; shared-prefix pages are reused.

        Returns (pages, n_shared_pages) or None if out of pages.
        """
        shared: List[int] = []
        n_full_shared = 0
        if prefix_id is not None and prefix_len >= self.page_size:
            n_full_shared = prefix_len // self.page_size
            existing = self.prefix_pages.get(prefix_id)
            if existing is not None and len(existing) >= n_full_shared:
                shared = existing[:n_full_shared]
                for p in shared:
                    self.ref(p)
            else:
                # rebuilding (longer prefix): release the old pin first
                if existing is not None:
                    del self.prefix_pages[prefix_id]
                    for p in existing:
                        self.unref(p)
                shared = []
                for _ in range(n_full_shared):
                    p = self.alloc_page()
                    if p is None:
                        for q in shared:
                            self.unref(q)
                        return None
                    shared.append(p)
                # pin the prefix (one standing ref held by the table)
                for p in shared:
                    self.ref(p)
                self.prefix_pages[prefix_id] = shared
        n_priv = self.pages_needed(total_len) - len(shared)
        priv: List[int] = []
        for _ in range(max(n_priv, 0)):
            p = self.alloc_page()
            if p is None:
                for q in priv:
                    self.unref(q)
                for q in shared:
                    self.unref(q)
                return None
            priv.append(p)
        return shared + priv, len(shared)

    def extend_seq(self, pages: List[int], old_len: int, new_len: int
                   ) -> bool:
        """Grow a sequence; allocates new tail pages as needed."""
        need = self.pages_needed(new_len) - len(pages)
        for _ in range(max(need, 0)):
            p = self.alloc_page()
            if p is None:
                return False
            pages.append(p)
        return True

    def free_seq(self, pages: List[int]) -> None:
        for p in pages:
            self.unref(p)

    def utilization(self) -> float:
        return 1.0 - len(self.free) / self.n_pages
