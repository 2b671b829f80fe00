"""Page allocator and admission scheduler of the serving engine.

A pure-Python copy of the behaviour of ``flashattention_tpu/runtime/
native.py`` (:81-230), whose C++ core (``csrc/fa_runtime.cc``) is bound in a
later slice: a LIFO free list that reuses the most recently freed page
first, and FCFS admission under a page budget and a batch cap.
"""

from __future__ import annotations

from collections import deque

__all__ = ["PageAllocator", "Scheduler"]


class PageAllocator:
    """Free-list page allocator: pages 0, 1, 2, ... first, then LIFO reuse."""

    def __init__(self, num_pages: int):
        self.num_pages = num_pages
        self._free = list(range(num_pages - 1, -1, -1))

    def num_free(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> list[int] | None:
        """Allocate n pages; None if insufficient (no partial allocation)."""
        if n == 0:
            return []
        if len(self._free) < n:
            return None
        pages, self._free = self._free[-n:][::-1], self._free[:-n]
        return pages

    def free(self, pages: list[int]) -> None:
        self._free.extend(pages)


class Scheduler:
    """FCFS continuous-batching admission scheduler."""

    def __init__(self, max_batch: int, page_size: int, *, reserve_worst_case: bool = False):
        self.max_batch = max_batch
        self.page_size = page_size
        self.reserve_worst_case = reserve_worst_case
        self._waiting: deque = deque()
        self._running: dict[int, tuple[int, int]] = {}

    def add_request(self, req_id: int, prompt_len: int, max_new_tokens: int) -> None:
        self._waiting.append((req_id, prompt_len, max_new_tokens))

    def num_waiting(self) -> int:
        return len(self._waiting)

    def num_running(self) -> int:
        return len(self._running)

    def admit(self, free_pages: int, max_out: int | None = None) -> list[int]:
        """FCFS-admit waiting requests that fit the page budget + batch."""
        max_out = self.max_batch if max_out is None else max_out
        admitted = []
        budget = free_pages
        if self.reserve_worst_case:
            # Reservations survive across admit() calls: subtract the decode
            # headroom (worst-case span minus the prompt pages already
            # allocated) of every running request.
            for prompt_len, max_new in self._running.values():
                span_pages = -(-(prompt_len + max_new) // self.page_size)
                prompt_pages = -(-prompt_len // self.page_size)
                budget -= span_pages - prompt_pages
        while (
            self._waiting
            and len(admitted) < max_out
            and len(self._running) < self.max_batch
        ):
            req_id, prompt_len, max_new = self._waiting[0]
            span = prompt_len + max_new if self.reserve_worst_case else prompt_len
            need = -(-span // self.page_size)
            if need > budget:
                break
            budget -= need
            admitted.append(req_id)
            self._running[req_id] = (prompt_len, max_new)
            self._waiting.popleft()
        return admitted

    def finish(self, req_id: int) -> None:
        self._running.pop(req_id, None)

    def cancel(self, req_id: int) -> bool:
        """Drop a request wherever it sits (waiting or running); True if
        found.  Page cleanup for running requests is the caller's job."""
        if req_id in self._running:
            del self._running[req_id]
            return True
        for i, (rid, *_rest) in enumerate(self._waiting):
            if rid == req_id:
                del self._waiting[i]
                return True
        return False
