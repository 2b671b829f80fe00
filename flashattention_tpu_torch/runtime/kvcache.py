"""Paged KV-cache manager: the only stateful object in the serving stack.

Counterpart of ``flashattention_tpu/runtime/kvcache.py``.  The physical pool
of each layer is head-major, ``(L, num_pages, KVH, page_size, d)`` on the
device, with one logical page table per sequence shared by all layers.  Pages
come from the C++ runtime core's allocator (``runtime/native.py``); the
refcounts, the chain-hashed prefix index and its LRU parking are plain
Python.  All of it matches the JAX package's.

Writes update the pools in place (the JAX package donates them to jitted
scatters and keeps the returned arrays).  Rows are written exactly, with no
bucket padding: eager PyTorch has no recompiles to bound, so the dropped
out-of-range padding rows of the JAX scatter never exist here.

An ``"int8"`` or ``"fp8"`` cache stores 8-bit payloads and a float32 scale
per row and head in pools ``(L, num_pages, KVH, page_size)`` (initialised to
ones); :meth:`PagedKVCache.append` quantizes each row on write, per token, as
the JAX cache does.
"""

from __future__ import annotations

import dataclasses
import hashlib

import torch

from flashattention_tpu_torch.ops.quant import byte_view, quantize_rows
from flashattention_tpu_torch.runtime.native import PageAllocator
from flashattention_tpu_torch.utils.device import resolve_device

__all__ = ["CacheConfig", "PagedKVCache"]

_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "int8": torch.int8,
    "fp8": torch.float8_e4m3fn,
}


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    num_layers: int
    num_kv_heads: int
    head_dim: int
    page_size: int = 256
    num_pages: int = 1024
    dtype: str = "bfloat16"  # payload dtype: bfloat16 | float32 | int8 | fp8

    def __post_init__(self):
        if self.dtype not in _DTYPES:
            raise ValueError(f"unknown cache dtype {self.dtype!r}")

    @property
    def quantized(self) -> bool:
        return self.dtype in ("int8", "fp8")

    @property
    def payload_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


@dataclasses.dataclass
class _Seq:
    length: int
    pages: list


def _bucket(n: int, lo: int = 1) -> int:
    """Round counts up to a power of two >= lo."""
    b = lo
    while b < n:
        b *= 2
    return b


class PagedKVCache:
    """Physical page pools + per-sequence page tables + allocator."""

    def __init__(self, config: CacheConfig, *, device=None):
        self.config = c = config
        self.device = resolve_device(device)
        shape = (c.num_layers, c.num_pages, c.num_kv_heads, c.page_size, c.head_dim)
        # Zero bytes (an fp8 zero is the byte 0): no fp8 fill kernel needed.
        zeros = dict(dtype=torch.uint8 if c.dtype == "fp8" else c.payload_dtype, device=self.device)
        self.k_pages = torch.zeros(shape, **zeros).view(c.payload_dtype)
        self.v_pages = torch.zeros(shape, **zeros).view(c.payload_dtype)
        self.k_scales = self.v_scales = None
        if c.quantized:
            self.k_scales = torch.ones(shape[:-1], dtype=torch.float32, device=self.device)
            self.v_scales = torch.ones(shape[:-1], dtype=torch.float32, device=self.device)
        self.allocator = PageAllocator(c.num_pages)
        self._seqs: dict[int, _Seq] = {}
        # Prefix caching: full prompt pages are content-addressed by a chain
        # hash (key_i = H(key_{i-1}, tokens of page i)); only FULL pages are
        # shared, so shared pages are immutable.
        self._refs: dict[int, int] = {}  # page -> refcount (absent == 1-owner)
        self._prefix_index: dict[bytes, int] = {}  # chain key -> page
        self._page_keys: dict[int, list] = {}  # page -> keys it backs
        # Prefix-indexed pages whose last owner released them park here
        # (insertion order == LRU order) and are reclaimed only when the
        # allocator proper runs dry.
        self._cached_free: dict[int, None] = {}

    # ── sequence lifecycle ────────────────────────────────────────────────

    def has(self, seq_id: int) -> bool:
        return seq_id in self._seqs

    def length(self, seq_id: int) -> int:
        return self._seqs[seq_id].length

    def pages(self, seq_id: int) -> list:
        return list(self._seqs[seq_id].pages)

    def num_free_pages(self) -> int:
        return self.allocator.num_free() + len(self._cached_free)

    def can_append(self, seq_id: int, num_tokens: int) -> bool:
        """Whether ``num_tokens`` more tokens of ``seq_id`` (a new sequence
        if it has none) fit in the free pages, parked prefix pages counted
        as free (kvcache.py:158)."""
        return self._pages_needed(seq_id, num_tokens) <= self.num_free_pages()

    def _pages_needed(self, seq_id: int, num_tokens: int) -> int:
        cur = self._seqs[seq_id].length if seq_id in self._seqs else 0
        ps = self.config.page_size
        return -(-(cur + num_tokens) // ps) - (-(-cur // ps))

    def free_sequence(self, seq_id: int) -> None:
        seq = self._seqs.pop(seq_id, None)
        if seq is not None:
            self._release(seq.pages)

    # ── prefix caching ────────────────────────────────────────────────────

    def _release(self, pages: list) -> None:
        """Decref-aware free: a page leaving its last owner parks in the
        prefix LRU if it backs index entries, else returns to the allocator."""
        really_free = []
        for pg in pages:
            n = self._refs.get(pg, 1) - 1
            if n > 0:
                self._refs[pg] = n
                continue
            self._refs.pop(pg, None)
            if pg in self._page_keys:
                self._cached_free[pg] = None
                continue
            really_free.append(pg)
        if really_free:
            self.allocator.free(really_free)

    def _drop_cached(self, pg: int) -> None:
        del self._cached_free[pg]
        for key in self._page_keys.pop(pg, ()):
            if self._prefix_index.get(key) == pg:
                del self._prefix_index[key]

    def _alloc(self, need: int) -> list | None:
        """Allocate, evicting LRU parked prefix pages only when the allocator
        proper can't satisfy the request."""
        short = need - self.allocator.num_free()
        if short > 0:
            if short > len(self._cached_free):
                return None
            victims = list(self._cached_free)[:short]
            for pg in victims:
                self._drop_cached(pg)
            self.allocator.free(victims)
        return self.allocator.alloc(need)

    @staticmethod
    def _chain_keys(tokens, page_size):
        """SHA-256 chain digest per FULL page of ``tokens``."""
        keys, prev = [], b""
        for i in range(len(tokens) // page_size):
            h = hashlib.sha256(prev)
            h.update(b"".join(
                int(t).to_bytes(8, "little", signed=True)
                for t in tokens[i * page_size : (i + 1) * page_size]
            ))
            prev = h.digest()
            keys.append(prev)
        return keys

    def match_prefix(self, tokens) -> tuple[int, list]:
        """Longest shared full-page prefix of ``tokens`` already resident:
        (n_tokens, page_ids), n_tokens a page multiple <= len(tokens) - 1."""
        ps = self.config.page_size
        n, pages = 0, []
        for key in self._chain_keys(tokens, ps):
            pg = self._prefix_index.get(key)
            if pg is None or n + ps > len(tokens) - 1:
                break
            pages.append(pg)
            n += ps
        return n, pages

    def adopt_prefix(self, seq_id: int, pages: list, n_tokens: int) -> None:
        """Start ``seq_id`` sharing ``pages`` (refcounted) as its first
        ``n_tokens`` of context."""
        if seq_id in self._seqs:
            raise ValueError(f"sequence {seq_id} already exists")
        for pg in pages:
            if pg in self._cached_free:
                del self._cached_free[pg]  # revive: the adopter is sole owner
            else:
                self._refs[pg] = self._refs.get(pg, 1) + 1
        self._seqs[seq_id] = _Seq(n_tokens, list(pages))

    def register_prefix(self, seq_id: int, tokens) -> None:
        """Publish ``seq_id``'s full prompt pages into the prefix index."""
        seq = self._seqs.get(seq_id)
        if seq is None:
            return
        ps = self.config.page_size
        for i, key in enumerate(self._chain_keys(tokens, ps)):
            if i >= len(seq.pages) or (i + 1) * ps > seq.length:
                break
            if key not in self._prefix_index:
                pg = seq.pages[i]
                self._prefix_index[key] = pg
                self._page_keys.setdefault(pg, []).append(key)

    # ── writes ────────────────────────────────────────────────────────────

    def append(self, seq_id: int, k: torch.Tensor, v: torch.Tensor) -> None:
        """Append T tokens of K/V, ``(L, T, KVH, d)`` in any float dtype, for
        one sequence, writing the pools in place (quantized per row and head
        for an int8/fp8 cache).  Raises MemoryError when out of pages."""
        c = self.config
        l, t, kvh, d = k.shape
        if (l, kvh, d) != (c.num_layers, c.num_kv_heads, c.head_dim):
            raise ValueError(f"K/V rows {tuple(k.shape)} do not fit the cache {c}")
        seq = self._seqs.setdefault(seq_id, _Seq(0, []))
        need = self._pages_needed(seq_id, t)
        if need:
            got = self._alloc(need)
            if got is None:
                raise MemoryError(
                    f"KV cache out of pages: need {need}, free {self.num_free_pages()}"
                )
            seq.pages.extend(got)
        ps = c.page_size
        positions = range(seq.length, seq.length + t)
        page_ids = torch.tensor([seq.pages[p // ps] for p in positions], device=self.device)
        slot_ids = torch.tensor([p % ps for p in positions], device=self.device)
        # Advanced indices split by the KVH slice put T first: (T, L, KVH, d).
        for pool, scales, rows in ((self.k_pages, self.k_scales, k), (self.v_pages, self.v_scales, v)):
            rows = rows.transpose(0, 1)
            if c.quantized:
                rows, sc = quantize_rows(rows, c.dtype)
                scales[:, page_ids, :, slot_ids] = sc
            byte_view(pool)[:, page_ids, :, slot_ids, :] = byte_view(rows.to(c.payload_dtype))
        seq.length += t

    def trim(self, seq_id: int, new_length: int) -> None:
        """Shrink a sequence to ``new_length`` tokens, freeing whole pages
        past the new end."""
        seq = self._seqs[seq_id]
        if new_length > seq.length:
            raise ValueError(f"trim to {new_length} > current {seq.length}")
        keep = -(-new_length // self.config.page_size)
        if len(seq.pages) > keep:
            self._release(seq.pages[keep:])
            seq.pages = seq.pages[:keep]
        seq.length = new_length

    def reserve_slot(self, seq_id: int) -> tuple[int, int]:
        """Reserve the (page, slot) for one new token and bump the length.

        The decode path writes the token's K/V inside
        ``models.transformer.decode_step``; the host only keeps the books.
        Raises MemoryError on OOM."""
        c = self.config
        seq = self._seqs.setdefault(seq_id, _Seq(0, []))
        if seq.length == len(seq.pages) * c.page_size:
            got = self._alloc(1)
            if got is None:
                raise MemoryError("KV cache out of pages")
            seq.pages.extend(got)
        page = seq.pages[seq.length // c.page_size]
        slot = seq.length % c.page_size
        seq.length += 1
        return page, slot

    # ── reads ─────────────────────────────────────────────────────────────

    def batch_view(self, seq_ids: list[int], pages_per_seq: int):
        """(lengths, page_indices) int32 tensors on the device for a decode
        batch.  Unknown/finished seq ids get length 0 and page row 0."""
        lengths, table = [], []
        for sid in seq_ids:
            seq = self._seqs.get(sid)
            if seq is None:
                lengths.append(0)
                table.append([0] * pages_per_seq)
                continue
            if len(seq.pages) > pages_per_seq:
                raise ValueError(
                    f"sequence {sid} uses {len(seq.pages)} pages > view "
                    f"pages_per_seq={pages_per_seq}"
                )
            lengths.append(seq.length)
            table.append(seq.pages + [0] * (pages_per_seq - len(seq.pages)))
        return (
            torch.tensor(lengths, dtype=torch.int32, device=self.device),
            torch.tensor(table, dtype=torch.int32, device=self.device),
        )

    def layer_pages(self, layer: int):
        """``(k_pages, v_pages, k_scales, v_scales)`` of one layer, as
        ``ops.decode.paged_attention`` takes them (kvcache.py:397): views of
        the pools, the scales None for an unquantized cache."""
        if self.config.quantized:
            return (self.k_pages[layer], self.v_pages[layer],
                    self.k_scales[layer], self.v_scales[layer])
        return self.k_pages[layer], self.v_pages[layer], None, None
