"""Page allocator and admission scheduler of the serving engine, on the C++
runtime core.

Counterpart of ``flashattention_tpu/runtime/native.py``: ctypes bindings of
``flashattention_tpu_torch/csrc/fa_runtime.cc`` (the JAX package's
``csrc/fa_runtime.cc``, :51-183), a LIFO free list that hands out the most
recently freed page first, and FCFS admission under a page budget and a
batch cap.  :func:`library` compiles the core with ``g++ -O2 -std=c++17
-fPIC -shared`` at first use into ``build/torch_runtime/`` (the file name
carries a hash of the source and flags, so an edit rebuilds it) and loads
it.

``PageAllocator(n)`` and ``Scheduler(max_batch, page_size)`` run on the
core; with ``native=False`` they are the pure-Python copies
(:class:`PlainPageAllocator`, :class:`PlainScheduler`), the core's plain
version.  Where the JAX binding falls back to its Python copy when the
build fails, these raise :class:`NativeBuildError`, naming the compiler's
error: no fallback hides what runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
import weakref
from collections import deque

__all__ = [
    "NativeBuildError", "PageAllocator", "PlainPageAllocator", "PlainScheduler", "Scheduler",
    "build", "library",
]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "fa_runtime.cc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_runtime")
CXX = "g++"
FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")

_lock = threading.Lock()
_lib = None

_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
# entry -> (restype, argtypes)
_API = {
    "fa_alloc_create": (_P, [_I32]),
    "fa_alloc_destroy": (None, [_P]),
    "fa_alloc_num_free": (_I32, [_P]),
    "fa_alloc_pages": (_I32, [_P, _I32, ctypes.POINTER(_I32)]),
    "fa_alloc_free_pages": (None, [_P, ctypes.POINTER(_I32), _I32]),
    "fa_sched_create": (_P, [_I32, _I32, _I32]),
    "fa_sched_destroy": (None, [_P]),
    "fa_sched_add_request": (None, [_P, _I64, _I32, _I32]),
    "fa_sched_num_waiting": (_I32, [_P]),
    "fa_sched_num_running": (_I32, [_P]),
    "fa_sched_admit": (_I32, [_P, _I32, ctypes.POINTER(_I64), _I32]),
    "fa_sched_finish": (None, [_P, _I64]),
    "fa_sched_cancel": (_I32, [_P, _I64]),
}


class NativeBuildError(RuntimeError):
    """The C++ runtime core did not compile (the message holds the
    compiler's error)."""


def _so_path() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    with open(SOURCE, "rb") as fh:
        h.update(fh.read())
    return os.path.join(BUILD_DIR, f"fa_runtime-{h.hexdigest()[:16]}.so")


def build() -> dict:
    """Compile the core with ``CXX`` unless its library is there already;
    returns ``{"path", "seconds", "cached"}``.  Concurrent builds (test
    workers) each write a file of their own and rename it into place.
    Raises :class:`NativeBuildError` when the compiler fails or is
    missing."""
    so = _so_path()
    if os.path.exists(so):
        return {"path": so, "seconds": 0.0, "cached": True}
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([CXX, *FLAGS, "-o", tmp, SOURCE], capture_output=True, text=True)
    except OSError as e:
        raise NativeBuildError(f"{CXX} could not run to build {SOURCE}: {e}") from e
    if proc.returncode != 0:
        raise NativeBuildError(f"{CXX} failed to build {SOURCE}:\n{proc.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    return {"path": so, "seconds": time.perf_counter() - t0, "cached": False}


def library() -> ctypes.CDLL:
    """The loaded core, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build()["path"])
            for name, (restype, argtypes) in _API.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
            _lib = lib
        return _lib


class PageAllocator:
    """Free-list page allocator on the C++ core: pages 0, 1, 2, ... first,
    then LIFO reuse.  ``native=False`` gives :class:`PlainPageAllocator`."""

    native = True

    def __new__(cls, num_pages: int, *, native: bool | None = None):
        if native is False:
            return PlainPageAllocator(num_pages)
        return super().__new__(cls)

    def __init__(self, num_pages: int, *, native: bool | None = None):
        self.num_pages = num_pages
        self._lib = lib = library()
        self._h = lib.fa_alloc_create(num_pages)
        # Runs when the allocator is collected, or at exit while the
        # library is still loaded.
        weakref.finalize(self, lib.fa_alloc_destroy, self._h)

    def num_free(self) -> int:
        return self._lib.fa_alloc_num_free(self._h)

    def alloc(self, n: int) -> list[int] | None:
        """Allocate n pages; None if insufficient (no partial allocation)."""
        if n == 0:
            return []
        out = (_I32 * n)()
        if self._lib.fa_alloc_pages(self._h, n, out) != 0:
            return None
        return list(out)

    def free(self, pages: list[int]) -> None:
        if pages:
            self._lib.fa_alloc_free_pages(self._h, (_I32 * len(pages))(*pages), len(pages))


class Scheduler:
    """FCFS continuous-batching admission scheduler on the C++ core.
    ``native=False`` gives :class:`PlainScheduler`."""

    native = True

    def __new__(cls, max_batch: int, page_size: int, *, reserve_worst_case: bool = False,
                native: bool | None = None):
        if native is False:
            return PlainScheduler(max_batch, page_size, reserve_worst_case=reserve_worst_case)
        return super().__new__(cls)

    def __init__(self, max_batch: int, page_size: int, *, reserve_worst_case: bool = False,
                 native: bool | None = None):
        self.max_batch = max_batch
        self.page_size = page_size
        self.reserve_worst_case = reserve_worst_case
        self._lib = lib = library()
        self._h = lib.fa_sched_create(max_batch, page_size, int(reserve_worst_case))
        weakref.finalize(self, lib.fa_sched_destroy, self._h)

    def add_request(self, req_id: int, prompt_len: int, max_new_tokens: int) -> None:
        self._lib.fa_sched_add_request(self._h, req_id, prompt_len, max_new_tokens)

    def num_waiting(self) -> int:
        return self._lib.fa_sched_num_waiting(self._h)

    def num_running(self) -> int:
        return self._lib.fa_sched_num_running(self._h)

    def admit(self, free_pages: int, max_out: int | None = None) -> list[int]:
        """FCFS-admit waiting requests that fit the page budget + batch."""
        max_out = self.max_batch if max_out is None else max_out
        out = (_I64 * max_out)()
        n = self._lib.fa_sched_admit(self._h, free_pages, out, max_out)
        return list(out[:n])

    def finish(self, req_id: int) -> None:
        self._lib.fa_sched_finish(self._h, req_id)

    def cancel(self, req_id: int) -> bool:
        """Drop a request wherever it sits (waiting or running); True if
        found.  Page cleanup for running requests is the caller's job."""
        return bool(self._lib.fa_sched_cancel(self._h, req_id))


class PlainPageAllocator:
    """The allocator in pure Python (the core's plain version)."""

    native = False

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


class PlainScheduler:
    """The scheduler in pure Python (the core's plain version)."""

    native = False

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
