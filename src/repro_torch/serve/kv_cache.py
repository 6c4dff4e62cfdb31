"""KV caches of the port (``repro.serve.kv_cache``): ``PagedKVCache`` and
``DenseKVCache``.

A vLLM-style page pool for pure-attention decoder stacks: per layer, k/v
live in a shared ``(num_pages, page_size, KV, D)`` pool (stacked over
layers), and each request owns a row of the page table. Page 0 is the
reserved trash page: padded table entries point at it, so scatter and
gather with padded tables need no branches. ``int8`` pools keep bf16
scale pages ``(N, P, KV)`` that the kernels read through the same table.

On top sits prefix caching: refcounted pages, a chain-hash index of full
prompt pages (a hit certifies the whole prefix), copy-on-write forks, an
LRU pool of unreferenced cached pages and CRC stamps of published pages.
The host bookkeeping is the reference's line for line; only the pools are
torch tensors on the engine's device, updated in place.

``DenseKVCache`` is the dense backend: one (n_blocks, max_batch, W, KV, D)
k/v cache per sublayer, a ring when a sliding window makes W smaller than
the serve window (an encoder-decoder's ring and cross k/v per layer). The
reference's mesh placement is not ported.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.models import api
from repro_torch.models.blocks import ModelContext, init_cache
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import tree_items

_CHAIN_SEED = 0xA5A5A5A5

CopyFn = Callable[[Dict[str, Any], int, int], Dict[str, Any]]


def _as_bytes(t: torch.Tensor) -> bytes:
    """Host bytes of a tensor (bf16 through its int16 bit pattern)."""
    t = t.detach().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.cpu().numpy().tobytes()


@dataclasses.dataclass
class PagedKVCache:
    """Host allocator + device page pool."""

    cfg: ModelConfig
    ctx: ModelContext
    num_pages: int
    page_size: int
    max_batch: int
    max_pages_per_seq: int

    def __post_init__(self) -> None:
        spec = api.paged_state_spec(
            self.cfg, self.num_pages, self.page_size, self.max_batch,
            self.max_pages_per_seq, self.ctx)
        dev = self.ctx.device
        self.pages: Dict[str, Dict[str, torch.Tensor]] = {
            sl: {name: torch.zeros(s.shape, dtype=s.dtype, device=dev)
                 for name, s in sub.items()}
            for sl, sub in spec["pages"].items()}
        # page 0 is the trash page: never allocated
        self._free: List[int] = list(range(self.num_pages - 1, 0, -1))
        # host mirror of the table; pushed to the device when it changes
        self._table = np.zeros((self.max_batch, self.max_pages_per_seq),
                               np.int32)
        self._pushed: Optional[np.ndarray] = None
        self._table_dev: Optional[torch.Tensor] = None
        # token-position frontier per slot: page indices < frontier have
        # been allocated at some point (monotonic per lease); SWA trimming
        # punches holes in the table, so ``grow`` extends past it.
        self._frontier = np.zeros(self.max_batch, np.int64)
        # prefix-cache bookkeeping: _ref[p] live table references;
        # _index chain hash -> (page id, block tokens), verified on hit;
        # _published page id -> chain hash; _evictable LRU-ordered
        # published pages with refcount 0.
        self._ref = np.zeros(self.num_pages, np.int32)
        self._index: Dict[int, Tuple[int, Tuple[int, ...]]] = {}
        self._published: Dict[int, int] = {}
        self._evictable: Dict[int, None] = {}
        # integrity: CRC stamps of published pages (immutable once
        # published) and chain hashes barred from the index forever.
        self.integrity_checks = False
        self._page_crc: Dict[int, int] = {}
        self._quarantined: Set[int] = set()
        self.counters = {"prefix_lookups": 0, "prefix_hit_tokens": 0,
                         "pages_shared": 0, "pages_forked": 0,
                         "pages_evicted": 0, "pages_published": 0,
                         "pages_allocated": 0, "pages_quarantined": 0}

    # ---------------------------------------------------------- allocation

    def free_page_count(self) -> int:
        """Pages allocatable right now (free list + evictable cached)."""
        return len(self._free) + len(self._evictable)

    def pages_for(self, tokens: int) -> int:
        return -(-tokens // self.page_size)

    def slot_pages(self, slot: int) -> List[int]:
        return [int(p) for p in self._table[slot] if p != 0]

    def _evict_lru(self) -> Optional[int]:
        if not self._evictable:
            return None
        pid = next(iter(self._evictable))  # oldest recency
        self._unpublish(pid)
        self.counters["pages_evicted"] += 1
        return pid

    def _unpublish(self, pid: int) -> None:
        h = self._published.pop(pid)
        entry = self._index.get(h)
        if entry is not None and entry[0] == pid:
            del self._index[h]
        self._evictable.pop(pid, None)
        self._page_crc.pop(pid, None)

    def _touch(self, pid: int) -> None:
        if pid in self._evictable:
            del self._evictable[pid]
            self._evictable[pid] = None

    def _alloc_page(self) -> Optional[int]:
        pid = self._free.pop() if self._free else self._evict_lru()
        if pid is not None:
            self._ref[pid] = 1
            self.counters["pages_allocated"] += 1
        return pid

    def _drop_ref(self, pid: int) -> None:
        self._ref[pid] -= 1
        if self._ref[pid] < 0:
            raise RuntimeError(f"page {pid} refcount below zero")
        if self._ref[pid] == 0:
            if pid in self._published:
                self._evictable[pid] = None  # stays cached, LRU-evictable
            else:
                self._free.append(pid)

    def grow(self, slot: int, target_tokens: int) -> bool:
        """Ensure the slot owns pages covering ``target_tokens``; False
        (no change) when the pool cannot satisfy the request."""
        have = int(self._frontier[slot])
        need = self.pages_for(target_tokens) - have
        if need <= 0:
            return True
        if (need > self.free_page_count()
                or have + need > self.max_pages_per_seq):
            return False
        for i in range(need):
            self._table[slot, have + i] = self._alloc_page()
        self._frontier[slot] = have + need
        return True

    def trim(self, slot: int, keep_from_token: int) -> int:
        """Release pages wholly behind ``keep_from_token`` (the sliding-
        window lower bound); the frontier is untouched. Returns the number
        of references released."""
        first_keep = max(0, keep_from_token) // self.page_size
        freed = 0
        for i in range(min(first_keep, int(self._frontier[slot]))):
            page = int(self._table[slot, i])
            if page != 0:
                self._drop_ref(page)
                self._table[slot, i] = 0
                freed += 1
        return freed

    def release(self, slot: int) -> None:
        for pid in self.slot_pages(slot)[::-1]:
            self._drop_ref(pid)
        self._table[slot] = 0
        self._frontier[slot] = 0

    def table_device(self) -> torch.Tensor:
        """The (B, M) int32 table on the device, pushed only when the
        host table changed since the last push."""
        if self._pushed is None or not np.array_equal(self._pushed,
                                                      self._table):
            self._pushed = self._table.copy()
            self._table_dev = torch.from_numpy(self._pushed).to(
                self.ctx.device)
        return self._table_dev

    def table_row(self, slot: int) -> torch.Tensor:
        """The slot's row as a (1, M) device tensor."""
        return self.table_device()[slot:slot + 1]

    # ------------------------------------------------------- prefix cache

    def _prefix_blocks(self, tokens: np.ndarray
                       ) -> List[Tuple[int, Tuple[int, ...]]]:
        """(chain hash, block tokens) for every full page of ``tokens``."""
        n_full = len(tokens) // self.page_size
        out: List[Tuple[int, Tuple[int, ...]]] = []
        h = _CHAIN_SEED
        for i in range(n_full):
            blk = tuple(int(t) for t in
                        tokens[i * self.page_size:(i + 1) * self.page_size])
            h = hash((h,) + blk)
            out.append((h, blk))
        return out

    def prefix_hashes(self, tokens: np.ndarray) -> List[int]:
        return [h for h, _ in self._prefix_blocks(tokens)]

    def lookup_prefix(self, tokens: np.ndarray) -> Tuple[int, List[int]]:
        """Longest indexed chain covering a *strict* prefix of ``tokens``
        (one token is always left to prefill: its logits seed decoding),
        verified against the stored block tokens and refreshed to most-
        recently-used. Returns (cached token count, page ids)."""
        self.counters["prefix_lookups"] += 1
        pids: List[int] = []
        for h, blk in self._prefix_blocks(tokens):
            entry = self._index.get(h)
            if entry is None or entry[1] != blk:
                break
            pids.append(entry[0])
        while pids and len(pids) * self.page_size >= len(tokens):
            pids.pop()
        for pid in pids:
            self._touch(pid)
        cached = len(pids) * self.page_size
        self.counters["prefix_hit_tokens"] += cached
        return cached, pids

    def adopt_prefix(self, slot: int, pids: List[int]) -> None:
        """Map cached pages into an empty slot's row (share, no copy)."""
        if int(self._frontier[slot]) != 0 or self.slot_pages(slot):
            raise RuntimeError(f"slot {slot} is not empty")
        for i, pid in enumerate(pids):
            self._table[slot, i] = pid
            self._ref[pid] += 1
            self._evictable.pop(pid, None)  # referenced again
        self._frontier[slot] = len(pids)
        self.counters["pages_shared"] += len(pids)

    def abort_adoption(self, slot: int, cached: int,
                       pids: List[int]) -> None:
        """Roll back a lookup_prefix + adopt_prefix pair when admission
        fails afterwards, counters included."""
        self.release(slot)
        self.counters["prefix_lookups"] -= 1
        self.counters["prefix_hit_tokens"] -= cached
        self.counters["pages_shared"] -= len(pids)

    def register_prefix(self, slot: int, tokens: np.ndarray) -> int:
        """Publish the slot's full-page prefix KV into the index; stops at
        the first table hole or quarantined hash. Returns the number of
        newly published pages."""
        n = 0
        for i, (h, blk) in enumerate(self._prefix_blocks(tokens)):
            pid = int(self._table[slot, i])
            if pid == 0 or h in self._quarantined:
                break
            if h in self._index:
                continue  # identical content already published
            self._published[pid] = h
            self._index[h] = (pid, blk)
            if self.integrity_checks:
                self._page_crc[pid] = self._page_bytes_crc(pid)
            n += 1
        self.counters["pages_published"] += n
        return n

    def fork(self, slot: int, page_idx: int, copy_fn: CopyFn) -> bool:
        """Copy-on-write: give ``table[slot, page_idx]`` a private copy of
        its page (``copy_fn(pages, src, dst)``). False when no page can
        be allocated."""
        src = int(self._table[slot, page_idx])
        if src == 0:
            raise RuntimeError("fork of the trash page")
        new = self._alloc_page()
        if new is None:
            return False
        self.pages = copy_fn(self.pages, src, new)
        self._table[slot, page_idx] = new
        self._drop_ref(src)
        self.counters["pages_forked"] += 1
        return True

    def ensure_private(self, slot: int, from_token: int,
                       copy_fn: CopyFn) -> bool:
        """CoW guard before a write phase: fork any shared or published
        page covering positions >= ``from_token``."""
        first = max(0, from_token) // self.page_size
        for i in range(first, int(self._frontier[slot])):
            pid = int(self._table[slot, i])
            if pid == 0:
                continue
            if self._ref[pid] > 1 or pid in self._published:
                if not self.fork(slot, i, copy_fn):
                    return False
        return True

    # ---------------------------------------------------------- integrity

    def _page_bytes_crc(self, pid: int) -> int:
        """CRC32 over the page's bytes across every pool leaf (k, v and
        int8 scale pages), in sorted path order."""
        crc = 0
        for _, leaf in tree_items(self.pages):
            crc = zlib.crc32(_as_bytes(leaf[:, pid]), crc)
        return crc

    def corruptible_pages(self) -> List[int]:
        return sorted(self._page_crc)

    def corrupt_page(self, pid: int) -> None:
        """Flip the page's content in place: every element changes
        (x -> 1 - x for x <= 0, else -x)."""
        for _, leaf in tree_items(self.pages):
            page = leaf[:, pid]
            leaf[:, pid] = torch.where(page <= 0, 1 - page, -page)

    def verify_integrity(self) -> List[Tuple[int, int]]:
        """Re-hash every stamped page and quarantine mismatches. Returns
        the detected (page id, chain hash) pairs."""
        bad: List[Tuple[int, int]] = []
        for pid, crc in list(self._page_crc.items()):
            if self._page_bytes_crc(pid) == crc:
                continue
            h = self._published[pid]
            self._quarantined.add(h)
            self._unpublish(pid)
            if self._ref[pid] == 0:
                self._free.append(pid)
            self.counters["pages_quarantined"] += 1
            bad.append((pid, h))
        return bad

    def slots_referencing(self, pid: int) -> List[int]:
        return [s for s in range(self.max_batch)
                if pid in self._table[s]]

    # ---------------------------------------------------------- accounting

    def per_token_bytes(self) -> int:
        """Device bytes held per cached token across all layers (k + v
        pages plus int8 scale pages)."""
        total = sum(leaf.element_size() * leaf.numel()
                    for _, leaf in tree_items(self.pages))
        return total // (self.num_pages * self.page_size)

    def dedup_stats(self) -> Dict[str, int]:
        shared = int(self.counters["pages_shared"])
        unique = int(self.counters["pages_allocated"])
        return {"pages_shared": shared, "pages_unique": unique,
                "bytes_saved": shared * self.page_size *
                self.per_token_bytes()}


@dataclasses.dataclass
class DenseKVCache:
    """Per-slot dense caches of the whole batch: attention rings and the
    recurrent states of Mamba and RWKV sublayers."""

    cfg: ModelConfig
    ctx: ModelContext
    window: int
    max_batch: int

    def __post_init__(self) -> None:
        spec = api.cache_spec(self.cfg, self.max_batch, self.window,
                              self.ctx)
        self.cache: Dict[str, Any] = {
            "blocks": init_cache(spec["blocks"], self.ctx.device)}

    def state(self, pos: torch.Tensor) -> Dict[str, Any]:
        """The decode state: the caches (updated in place) and ``pos``."""
        cache = dict(self.cache)
        cache["pos"] = pos
        return cache

    def write_prefill(self, slot: int, prefill_cache: Dict[str, Any]
                      ) -> None:
        """Copy a 1-request prefill cache into batch row ``slot``, in
        place (the reference's jitted ``write_dense``). Every leaf is
        (n_layers, B, ...) with the batch second: k/v, the states conv,
        ssm, tok, wkv and cm_tok, and an encoder-decoder's cross k/v
        alike."""
        rows = dict(tree_items(prefill_cache["blocks"]))
        for path, arr in tree_items(self.cache["blocks"]):
            arr[:, slot] = rows[path][:, 0]
