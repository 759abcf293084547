"""Block-paged mixed-precision KV cache (the port of
``repro.serving.paged_kvcache`` for attention stacks).

Per attention layer, two page pools shared by all requests:

* **hi pool** — ``k_hi / v_hi``: ``(NH, bs, kv, hd)`` int8, the first
  ``num_hi`` logical tokens of every sequence at 8 bits (§B.2);
* **lo pool** — ``k_lo / v_lo``: ``(NL, bs, kv, hd/2)`` uint8, two int4
  nibbles per byte;
* ``*_scale / *_zp`` — ``(N?, bs, kv)`` f16 per-token parameters paged with
  their codes.

An unquantized cache is one bf16 pool, ``k / v``: ``(NL, bs, kv, hd)``,
addressed through the lo tables (no hi region).

Page 0 of each pool is the **null page**: never allocated; block tables
hold 0 for unmapped blocks and masked / pad writes land there, so every
reader masks by length.  Block ids are shared across layers.  Unlike the
reference, the writers update the pools **in place** (``index_put_``): a
serving step never needs the old pools, and copying them per layer would
double the cache's traffic.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import heapq
import zlib
from typing import List, Optional

import numpy as np
import torch

from repro_torch.serving import kvcache as KV


@dataclasses.dataclass(frozen=True)
class PagedCacheConfig:
    """Pool geometry.  ``quant`` carries the precision split."""

    block_size: int = 16          # tokens per page
    num_lo_blocks: int = 64       # lo-pool pages (page 0 = null)
    num_hi_blocks: int = 16       # hi-pool pages (page 0 = null)
    max_blocks_per_seq: int = 16  # lo-table width
    quant: KV.KVCacheConfig = KV.KVCacheConfig()

    def __post_init__(self):
        if self.quant.quantized and self.quant.num_hi % self.block_size:
            raise ValueError(
                f"num_hi={self.quant.num_hi} must be a multiple of "
                f"block_size={self.block_size} (pages are single-precision)")

    @property
    def hi_blocks_per_seq(self) -> int:
        return self.num_hi // self.block_size

    @property
    def num_hi(self) -> int:
        return self.quant.num_hi if self.quant.quantized else 0


def init_pools(kv_heads: int, head_dim: int, cfg: PagedCacheConfig,
               device=None) -> dict:
    """Zero page pools for one attention layer."""
    bs, nh, nl = cfg.block_size, cfg.num_hi_blocks, cfg.num_lo_blocks

    def z(n, *tail, dtype):
        return torch.zeros((n, bs, kv_heads, *tail), dtype=dtype,
                           device=device)

    if not cfg.quant.quantized:
        return {"k": z(nl, head_dim, dtype=torch.bfloat16),
                "v": z(nl, head_dim, dtype=torch.bfloat16)}
    pools = {"k_hi": z(nh, head_dim, dtype=torch.int8),
             "v_hi": z(nh, head_dim, dtype=torch.int8),
             "k_lo": z(nl, head_dim // 2, dtype=torch.uint8),
             "v_lo": z(nl, head_dim // 2, dtype=torch.uint8)}
    for name in ("k", "v"):
        for region, n in (("hi", nh), ("lo", nl)):
            for suffix in ("scale", "zp"):
                pools[f"{name}_{region}_{suffix}"] = z(n, dtype=torch.float16)
    return pools


def pool_bytes(entry: dict) -> int:
    return sum(t.numel() * t.element_size() for t in entry.values())


# ---------------------------------------------------------------------------
# host-side page allocator (ref-counted, hash-addressed prefix store)
# ---------------------------------------------------------------------------


class OutOfBlocks(Exception):
    """Raised by the allocator; the scheduler turns it into preemption."""


class SwapCorruption(Exception):
    """A swapped-out page set failed its checksum at swap-in."""


_PREFIX_ROOT = b""


def _prefix_digest(parent: bytes, tokens: np.ndarray) -> bytes:
    """Chain hash of one page of prompt tokens: ``H(parent || tokens)``."""
    h = hashlib.sha256(parent)
    h.update(np.ascontiguousarray(tokens, np.int32).tobytes())
    return h.digest()


@dataclasses.dataclass
class PrefixMatch:
    """A prefix-cache hit: tokens [0, matched) are covered by ``hi_pages``
    / ``lo_pages`` (refs acquired); ``cow`` names the partially covered
    page (``(pool, index)``) the caller must copy before writing."""

    matched: int
    hi_pages: List[int]
    lo_pages: List[int]
    cow: Optional[tuple] = None


@dataclasses.dataclass
class _CacheEntry:
    pool: str
    page: int
    tokens: np.ndarray
    parent: bytes


class BlockAllocator:
    """Ref-counted page store over the hi and lo pools, with a prefix cache
    of chain-hashed prompt pages (vLLM-style).  Pages are handed out
    lowest-first so identical request streams get identical placements;
    page 0 is never allocated.  A cached page whose refs drop to zero parks
    in a per-pool LRU and is evicted only when the free list is empty.

    ``fault`` is the fault-injection hook (`serving/faults.py`): a zero-arg
    callable; while it returns True, ``can_allocate`` refuses any non-empty
    request and every allocation raises :class:`OutOfBlocks`, so injected
    exhaustion runs through the scheduler's real preemption path."""

    def __init__(self, cfg: PagedCacheConfig, fault=None):
        self.cfg = cfg
        self.fault = fault
        self._free = {"hi": list(range(1, cfg.num_hi_blocks)),
                      "lo": list(range(1, cfg.num_lo_blocks))}
        self._free_set = {p: set(v) for p, v in self._free.items()}
        self._num_blocks = {"hi": cfg.num_hi_blocks, "lo": cfg.num_lo_blocks}
        self._ref = {"hi": {}, "lo": {}}
        self._cache: dict = {}                       # digest -> _CacheEntry
        self._by_page: dict = {}                     # (pool, page) -> digest
        self._children: dict = {}                    # digest -> set(digest)
        self._evict = {"hi": collections.OrderedDict(),
                       "lo": collections.OrderedDict()}
        self.cache_evictions = 0

    def free_counts(self) -> tuple[int, int]:
        return len(self._free["hi"]), len(self._free["lo"])

    def available_counts(self) -> tuple[int, int]:
        """(hi, lo) pages an allocation could obtain: free + evictable."""
        return (len(self._free["hi"]) + len(self._evict["hi"]),
                len(self._free["lo"]) + len(self._evict["lo"]))

    def capacity(self) -> tuple[int, int]:
        """(hi, lo) allocatable pages — pool sizes minus the null page."""
        return (max(self._num_blocks["hi"] - 1, 0),
                max(self._num_blocks["lo"] - 1, 0))

    def all_free(self) -> bool:
        return self.available_counts() == self.capacity()

    def _fault_active(self) -> bool:
        return self.fault is not None and self.fault()

    def can_allocate(self, n_hi: int, n_lo: int) -> bool:
        if (n_hi > 0 or n_lo > 0) and self._fault_active():
            return False
        avail_hi, avail_lo = self.available_counts()
        return n_hi <= avail_hi and n_lo <= avail_lo

    def _evict_lru(self, pool: str) -> None:
        page, _ = self._evict[pool].popitem(last=False)
        self._drop_cache_entry(pool, page)
        del self._ref[pool][page]
        heapq.heappush(self._free[pool], page)
        self._free_set[pool].add(page)
        self.cache_evictions += 1

    def _drop_cache_entry(self, pool: str, page: int) -> None:
        digest = self._by_page.pop((pool, page))
        entry = self._cache.pop(digest)
        kids = self._children.get(entry.parent)
        if kids is not None:
            kids.discard(digest)
            if not kids:
                del self._children[entry.parent]

    def _alloc(self, pool: str) -> int:
        heap = self._free[pool]
        if self._fault_active():
            raise OutOfBlocks(f"{pool} pool exhausted")
        if not heap and self._evict[pool]:
            self._evict_lru(pool)
        if not heap:
            raise OutOfBlocks(f"{pool} pool exhausted")
        i = heapq.heappop(heap)
        self._free_set[pool].remove(i)
        self._ref[pool][i] = 1
        return i

    def alloc_hi(self) -> int:
        return self._alloc("hi")

    def alloc_lo(self) -> int:
        return self._alloc("lo")

    def ref_count(self, pool: str, page: int) -> int:
        return self._ref[pool].get(int(page), 0)

    def acquire(self, hi_ids, lo_ids) -> None:
        """Add one holder to each page (a prefix hit sharing them)."""
        for pool, ids in (("hi", hi_ids), ("lo", lo_ids)):
            for i in ids:
                i = int(i)
                refs = self._ref[pool]
                if refs.get(i) is None:
                    raise ValueError(
                        f"cannot acquire {pool} page {i}: not allocated")
                if refs[i] == 0:
                    self._evict[pool].pop(i, None)
                refs[i] += 1

    def release(self, hi_ids, lo_ids) -> None:
        """Drop one holder from each page; at zero a cached page parks in
        the LRU with its content, any other returns to the free list."""
        for pool, ids in (("hi", hi_ids), ("lo", lo_ids)):
            for i in ids:
                i = int(i)
                if not 0 < i < self._num_blocks[pool]:
                    raise ValueError(
                        f"cannot free {pool} page {i}: outside the "
                        f"allocatable range [1, {self._num_blocks[pool]})")
                refs = self._ref[pool]
                if i in self._free_set[pool] or refs.get(i, 0) <= 0:
                    raise ValueError(f"double free of {pool} page {i}")
                refs[i] -= 1
                if refs[i] > 0:
                    continue
                if (pool, i) in self._by_page:
                    self._evict[pool][i] = None
                    self._evict[pool].move_to_end(i)
                else:
                    del refs[i]
                    heapq.heappush(self._free[pool], i)
                    self._free_set[pool].add(i)

    free = release

    def _page_for_index(self, g: int, hi_pages, lo_pages) -> tuple[str, int]:
        hps = self.cfg.hi_blocks_per_seq
        if g < hps:
            return "hi", int(hi_pages[g])
        return "lo", int(lo_pages[g - hps])

    def register_prefix(self, prompt: np.ndarray, upto: int,
                        hi_pages, lo_pages) -> int:
        """Register every fully materialized prompt page in [0, upto).
        Returns the number of new registrations."""
        bs = self.cfg.block_size
        n_full = min(int(upto), int(len(prompt))) // bs
        parent, new = _PREFIX_ROOT, 0
        for g in range(n_full):
            toks = np.asarray(prompt[g * bs:(g + 1) * bs], np.int32)
            digest = _prefix_digest(parent, toks)
            if digest not in self._cache:
                pool, page = self._page_for_index(g, hi_pages, lo_pages)
                if (pool, page) not in self._by_page:
                    self._cache[digest] = _CacheEntry(pool, page,
                                                      toks.copy(), parent)
                    self._by_page[(pool, page)] = digest
                    self._children.setdefault(parent, set()).add(digest)
                    new += 1
            parent = digest
        return new

    def _walk_prefix(self, prompt: np.ndarray, limit: int) -> tuple:
        """Longest cached coverage of ``prompt[:limit]``: full pages along
        the chain, then at most one partially matching child page."""
        bs = self.cfg.block_size
        limit = min(int(limit), int(len(prompt)))
        parent, pages, full = _PREFIX_ROOT, [], 0
        while (full + 1) * bs <= limit:
            toks = np.asarray(prompt[full * bs:(full + 1) * bs], np.int32)
            digest = _prefix_digest(parent, toks)
            entry = self._cache.get(digest)
            if entry is None:
                break
            pages.append((entry.pool, entry.page))
            parent = digest
            full += 1
        matched = full * bs
        rest = np.asarray(prompt[matched:limit], np.int32)
        best_extra, best = 0, None
        for digest in sorted(self._children.get(parent, ()),
                             key=lambda d: (self._cache[d].pool,
                                            self._cache[d].page)):
            entry = self._cache[digest]
            n = min(len(rest), len(entry.tokens))
            eq = entry.tokens[:n] == rest[:n]
            extra = int(n if eq.all() else np.argmin(eq))
            if extra > best_extra:
                best_extra, best = extra, (entry.pool, entry.page)
        if best is not None:
            pages.append(best)
            matched += best_extra
        return matched, pages

    def peek_prefix(self, prompt: np.ndarray, limit: int,
                    quantum: int) -> int:
        raw, _ = self._walk_prefix(prompt, limit)
        return min(raw, int(limit)) // quantum * quantum

    def lookup_prefix(self, prompt: np.ndarray, limit: int,
                      quantum: int) -> Optional[PrefixMatch]:
        """Longest cached prefix aligned down to ``quantum`` and capped at
        ``limit``; acquires a reference on every returned page.  A match
        ending mid-page flags that page for copy-on-write (shortened to a
        page boundary when no page is free for the copy)."""
        bs = self.cfg.block_size
        raw, pages = self._walk_prefix(prompt, limit)
        matched = min(raw, int(limit)) // quantum * quantum
        while matched > 0 and matched % bs and not (
                self.can_allocate(1, 0)
                if pages[(matched - 1) // bs][0] == "hi"
                else self.can_allocate(0, 1)):
            matched = (matched - 1) // quantum * quantum
        if matched <= 0:
            return None
        n_pages = -(-matched // bs)
        hi_pages = [p for pool, p in pages[:n_pages] if pool == "hi"]
        lo_pages = [p for pool, p in pages[:n_pages] if pool == "lo"]
        cow = None
        if matched % bs:
            pool, _ = pages[n_pages - 1]
            cow = (pool, (len(hi_pages) if pool == "hi" else len(lo_pages))
                   - 1)
        self.acquire(hi_pages, lo_pages)
        return PrefixMatch(matched=matched, hi_pages=hi_pages,
                           lo_pages=lo_pages, cow=cow)

    def flush_cache(self) -> int:
        """Drop every prefix-cache registration: zero-ref (evictable) pages
        return to the free list; pages still referenced by live requests
        only lose their registration (they free normally on release).
        Returns the number of registrations dropped (the fault hook for
        eviction storms)."""
        dropped = len(self._cache)
        for pool in ("hi", "lo"):
            while self._evict[pool]:
                self._evict_lru(pool)
        for (pool, page) in list(self._by_page):
            self._drop_cache_entry(pool, page)
        return dropped

    def cache_stats(self) -> dict:
        """Live prefix-cache occupancy for the engine's gauges."""
        shared = sum(1 for refs in self._ref.values()
                     for r in refs.values() if r >= 2)
        pinned_sink = sum(1 for (pool, page) in self._by_page
                          if pool == "hi"
                          and self._ref["hi"].get(page, 0) >= 1)
        return {"cached_pages": len(self._by_page),
                "evictable_pages": sum(len(v) for v in self._evict.values()),
                "kv_pages_shared": shared,
                "sink_pages_pinned": pinned_sink,
                "cache_evictions": self.cache_evictions}


def token_page_index(pos: int, cfg: PagedCacheConfig) -> tuple:
    """Logical position -> (is_hi, page index within the table, offset)."""
    bs = cfg.block_size
    if pos < cfg.num_hi:
        return True, pos // bs, pos % bs
    rel = pos - cfg.num_hi
    return False, rel // bs, rel % bs


def pages_needed(pos: int, cfg: PagedCacheConfig) -> tuple[int, int]:
    """(hi, lo) page counts that hold logical positions [0, pos)."""
    bs = cfg.block_size
    hi_tokens = min(pos, cfg.num_hi)
    return -(-hi_tokens // bs), -(-(pos - hi_tokens) // bs)


# ---------------------------------------------------------------------------
# device-side write / read
# ---------------------------------------------------------------------------


def _quant_token(t: torch.Tensor, bits: int) -> tuple:
    """Per-token quant of `kvcache.quant_tokens` plus the storage form:
    signed int8 at 8 bits, packed nibbles otherwise."""
    q, sc, zp = KV.quant_tokens(t, bits)
    if bits == 8:
        q, zp = KV.to_signed8(q, zp)
        return q, sc, zp
    return KV.pack_nibbles(q), sc, zp


def write_ragged(entry: dict, k: torch.Tensor, v: torch.Tensor,
                 pages: torch.Tensor, offsets: torch.Tensor,
                 is_hi: torch.Tensor, cfg: PagedCacheConfig) -> dict:
    """Scatter the step's flattened token stream ``k / v``: (T, kv, hd)
    into the pools in place; pad / inactive entries arrive with ``pages ==
    0`` (the null page).  Scale and zero point are computed in f32 and
    stored as f16."""
    pg_hi = torch.where(is_hi, pages, 0).long()
    pg_lo = torch.where(is_hi, 0, pages).long()
    offs = offsets.long()
    if not cfg.quant.quantized:
        for name, t in (("k", k), ("v", v)):
            entry[name][pg_lo, offs] = t.to(entry[name].dtype)
        return entry
    for name, t in (("k", k), ("v", v)):
        q8, sc8, zp8 = _quant_token(t, 8)
        q4, sc4, zp4 = _quant_token(t, cfg.quant.lo_bits)
        entry[f"{name}_hi"][pg_hi, offs] = q8
        entry[f"{name}_lo"][pg_lo, offs] = q4
        for suffix, hi_val, lo_val in (("scale", sc8, sc4), ("zp", zp8, zp4)):
            entry[f"{name}_hi_{suffix}"][pg_hi, offs] = hi_val.half()
            entry[f"{name}_lo_{suffix}"][pg_lo, offs] = lo_val.half()
    return entry


def write_tokens(entry: dict, k_new: torch.Tensor, v_new: torch.Tensor,
                 pages, offsets, is_hi, cfg: PagedCacheConfig) -> dict:
    """Decode path: one new (S, 1, kv, hd) token per slot."""
    return write_ragged(entry, k_new[:, 0], v_new[:, 0], pages, offsets,
                        is_hi, cfg)


def write_chunk(entry: dict, k: torch.Tensor, v: torch.Tensor,
                pages, offsets, is_hi, cfg: PagedCacheConfig) -> dict:
    """Two-call prefill path: one slot's (1, C, kv, hd) K/V chunk; pad
    tokens past the chunk's valid length arrive with ``pages == 0``."""
    return write_ragged(entry, k[0], v[0], pages, offsets, is_hi, cfg)


def gather_segments(entry: dict, hi_table: torch.Tensor,
                    lo_table: torch.Tensor, cfg: PagedCacheConfig,
                    dtype=torch.bfloat16) -> list:
    """Block tables -> dense dequantized segments ``[(k_hi, v_hi, 0),
    (k_lo, v_lo, num_hi)]`` shaped (S, n·bs, kv, hd) for the plain
    attention path (``[(k, v, 0)]`` for an unquantized cache)."""
    s = lo_table.shape[0]

    def dense(key, table):
        g = entry[key][table.long()]
        return g.reshape(s, g.shape[1] * g.shape[2], *g.shape[3:])

    if not cfg.quant.quantized:
        return [(dense("k", lo_table).to(dtype),
                 dense("v", lo_table).to(dtype), 0)]
    regions = (("hi", hi_table, 0), ("lo", lo_table, cfg.num_hi))
    if hi_table.shape[1] == 0:
        regions = regions[1:]
    segs = []
    for region, table, offset in regions:
        pair = []
        for name in ("k", "v"):
            codes = dense(f"{name}_{region}", table)
            vals = codes.float() if region == "hi" \
                else KV.unpack_nibbles(codes)
            pair.append(KV.dequant_tokens(
                vals, dense(f"{name}_{region}_scale", table),
                dense(f"{name}_{region}_zp", table), dtype))
        segs.append((pair[0], pair[1], offset))
    return segs


# ---------------------------------------------------------------------------
# page swap (host <-> device) and copy-on-write
# ---------------------------------------------------------------------------

CRC_KEY = "__crc__"


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes())


def _pool_of(name: str) -> str:
    return "lo" if "_lo" in name or name in ("k", "v") else "hi"


def extract_pages(pools: list, hi_ids: list, lo_ids: list) -> dict:
    """Copy a request's pages of every layer to host memory (swap-out),
    with a CRC32 per array that :func:`insert_pages` verifies."""
    ids = {"hi": torch.as_tensor(hi_ids, dtype=torch.long),
           "lo": torch.as_tensor(lo_ids, dtype=torch.long)}
    swapped = {}
    for i, entry in enumerate(pools):
        swapped[i] = {name: t[ids[_pool_of(name)].to(t.device)].cpu().numpy()
                      for name, t in entry.items()}
    swapped[CRC_KEY] = {i: {n: _crc(a) for n, a in layer.items()}
                        for i, layer in swapped.items()}
    return swapped


def verify_swapped(swapped: dict) -> None:
    """Check every saved array against the checksums
    :func:`extract_pages` recorded; raise :class:`SwapCorruption` on the
    first mismatch.  A swap dict without checksums passes unverified."""
    crcs = swapped.get(CRC_KEY)
    if crcs is None:
        return
    for i, layer in swapped.items():
        if i == CRC_KEY:
            continue
        for name, arr in layer.items():
            if _crc(np.asarray(arr)) != crcs[i][name]:
                raise SwapCorruption(
                    f"swap-in checksum mismatch at {i}/{name}: the host "
                    f"copy was corrupted while the request was preempted — "
                    f"refusing to restore it")


def insert_pages(pools: list, swapped: dict, hi_ids: list,
                 lo_ids: list) -> list:
    """Swap-in at (possibly different) page ids, in place.  Checksums are
    verified first (:func:`verify_swapped`): on a mismatch nothing is
    written."""
    verify_swapped(swapped)
    ids = {"hi": torch.as_tensor(hi_ids, dtype=torch.long),
           "lo": torch.as_tensor(lo_ids, dtype=torch.long)}
    for i, entry in enumerate(pools):
        for name, t in entry.items():
            sel = ids[_pool_of(name)]
            if sel.numel():
                t[sel.to(t.device)] = torch.from_numpy(
                    swapped[i][name]).to(t.device)
    return pools


def copy_page(pools: list, pool: str, src: int, dst: int) -> list:
    """Copy-on-write: duplicate one physical page (codes + scale/zp) of
    ``pool`` from ``src`` to ``dst`` in every layer, in place."""
    for entry in pools:
        for name, t in entry.items():
            if _pool_of(name) == pool:
                t[dst] = t[src]
    return pools


def swapped_bytes(swapped: dict) -> int:
    return sum(int(a.nbytes) for i, layer in swapped.items()
               if i != CRC_KEY for a in layer.values())
