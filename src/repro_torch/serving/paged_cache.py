"""Block-table page allocator for the paged KV cache, with
content-addressed prefix caching and copy-on-write page sharing.

The port's copy of the reference's ``repro.serving.paged_cache``.  The
allocator is host-side numpy and copies over line for line, so that its
state (tables, free list, refcounts, hash index, stats) matches the
reference's step for step; the two pool helpers at the end work on the
port's stacked torch pools in place.

The paged layout stores every sequence's KV tokens in fixed-size *pages*
of a pool shared by all slots (``(num_pages, page, Hkv, D)`` per attention
layer).  A host-side :class:`PageAllocator` owns the mapping:

  * a free list of physical page ids — released pages are reused
    immediately (LIFO keeps recently-touched pages warm);
  * a (slots, pages_per_seq) block table of physical page ids, the device
    copy of which the paged-attention kernels read
    (``kernels/paged_attention.py``);
  * capacity-aware admission: :meth:`can_admit` answers whether a request
    (prompt + generation budget) fits in the free pool *and* in one
    slot's table.

Page 0 is reserved as the **null page**: unallocated block-table entries
point at it, so inactive slots read/write only garbage that belongs to no
sequence.  The allocator never hands out page 0.

Prefix caching (block granularity): every *full* prompt block can be
registered in a hash→page index keyed on the block's token content
chained with its prefix hash.  Admission calls :meth:`plan` /
:meth:`alloc` with the prompt tokens: hash-hit blocks are shared
(refcounted, no prefill for those tokens); a shared page is never written
— :meth:`cow_write` and ``plan.cow_last`` give a slot a private copy
(copy-on-write); a registered page whose refcount drops to 0 parks in an
LRU evictable set, still indexed, and is evicted (oldest first) only
under pressure.
"""
from __future__ import annotations

import dataclasses
import zlib
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

NULL_PAGE = 0


def pages_for(tokens: int, page_size: int) -> int:
    return -(-tokens // page_size)


def block_hashes(token_ids: np.ndarray, page_size: int) -> List[int]:
    """Chained content hashes of the *full* blocks of a token sequence.

    ``h_i = crc32(h_{i-1} || tokens[i*page : (i+1)*page])`` — chaining
    makes the hash position-dependent, so block content is only shared
    between sequences whose entire prefix up to that block matches.
    The trailing partial block (if any) is never hashed.
    """
    toks = np.asarray(token_ids, np.int64)
    out: List[int] = []
    h = 0
    for i in range(len(toks) // page_size):
        blk = toks[i * page_size : (i + 1) * page_size]
        h = zlib.crc32(blk.tobytes(), h)
        out.append(h)
    return out


@dataclasses.dataclass
class PrefixPlan:
    """Admission plan: which cached pages to share and what remains."""

    shared: List[int]          # physical pages to share, in block order
    cow_last: bool             # whole prompt hit: privatize the last page
    n_new: int                 # fresh pages to pop (incl. the COW copy)
    cached_tokens: int         # tokens whose KV is reused (skip prefill)
    cost: int                  # pages consumed from free ∪ evictable
    looked_up: bool = False    # a prompt was hashed against the index


class PageAllocator:
    def __init__(self, num_pages: int, page_size: int, slots: int, max_len: int,
                 prefix_cache: bool = False):
        if num_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is the null page)")
        self.num_pages = num_pages
        self.page_size = page_size
        self.slots = slots
        self.pages_per_seq = pages_for(max_len, page_size)
        self.capacity = self.pages_per_seq * page_size
        self.prefix_cache = prefix_cache
        # LIFO free list over pages 1..num_pages-1 (0 = null page)
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._owned: List[List[int]] = [[] for _ in range(slots)]
        self._tokens: List[int] = [0] * slots
        self._ref = np.zeros((num_pages,), np.int64)
        # hash index: bijection _page_of[h] == p  <=>  _hash_of[p] == h.
        # _block_of holds the registered page's actual block tokens — a
        # hit is only honored when the content matches, so a crc32
        # collision degrades to a miss instead of serving wrong KV.
        self._page_of: Dict[int, int] = {}
        self._hash_of: Dict[int, int] = {}
        self._block_of: Dict[int, Tuple[int, ...]] = {}
        # ref==0 pages still in the index, oldest-released first (LRU)
        self._evictable: "OrderedDict[int, None]" = OrderedDict()
        self.table = np.full((slots, self.pages_per_seq), NULL_PAGE, np.int32)
        self.stats = {"lookups": 0, "hit_tokens": 0, "evictions": 0,
                      "cow_copies": 0}

    # ------------------------------------------------------------- query
    @property
    def free_pages(self) -> int:
        """Pages an admission may consume: truly free + evictable cached."""
        return len(self._free) + len(self._evictable)

    def owned(self, slot: int) -> List[int]:
        return list(self._owned[slot])

    def ref(self, page: int) -> int:
        return int(self._ref[page])

    def is_registered(self, page: int) -> bool:
        return page in self._hash_of

    def can_admit(self, tokens: int, plan: Optional[PrefixPlan] = None) -> bool:
        """True iff `tokens` fit in one slot's table and the free pool.

        With a :class:`PrefixPlan`, shared pages with live references cost
        nothing and only ``plan.cost`` fresh/evictable pages are needed.
        """
        need = pages_for(tokens, self.page_size)
        if need > self.pages_per_seq:
            return False
        cost = plan.cost if plan is not None else need
        return cost <= self.free_pages

    def releasable(self, slot: int) -> int:
        """Pages admission would get back if `slot` released right now:
        every owned page whose only live reference is this slot (it would
        land on the free list, or park registered in the evictable set —
        either way it counts toward :attr:`free_pages`).  Shared pages
        with other live referents stay mapped and free nothing.  The
        engine's preempt-and-requeue policy prechecks this before
        evicting a victim, so it never frees pages it cannot use."""
        return sum(1 for p in self._owned[slot] if self._ref[p] == 1)

    def fits_slot(self, tokens: int) -> bool:
        """True iff `tokens` can EVER fit (ignores current free pool)."""
        need = pages_for(tokens, self.page_size)
        return need <= self.pages_per_seq and need <= self.num_pages - 1

    # ------------------------------------------------------ prefix cache
    def match_prefix(self, prompt: np.ndarray) -> List[int]:
        """Longest chain of cached pages covering full blocks of `prompt`."""
        pages: List[int] = []
        if not self.prefix_cache:
            return pages
        for i, h in enumerate(block_hashes(prompt, self.page_size)):
            p = self._page_of.get(h)
            if p is None:
                break
            blk = tuple(
                int(t) for t in
                prompt[i * self.page_size : (i + 1) * self.page_size]
            )
            if self._block_of.get(p) != blk:   # crc32 collision: miss
                break
            pages.append(p)
        return pages

    def plan(self, tokens: int, prompt: Optional[np.ndarray]) -> PrefixPlan:
        """Admission plan for a request of `tokens` total budget whose
        prompt is `prompt` (hash lookup source).  ``cached_tokens`` counts
        the prompt prefix whose KV can be reused; when the *entire* prompt
        is cached, the last page is planned as a copy-on-write private
        copy so the engine can recompute the final token for its logits
        without mutating the shared page."""
        need = pages_for(tokens, self.page_size)
        if prompt is None or not self.prefix_cache:
            return PrefixPlan([], False, need, 0, need)
        shared = self.match_prefix(prompt)[:need]
        cached = len(shared) * self.page_size
        cow_last = False
        if shared and cached >= len(prompt):
            # full hit: keep the last token for recompute (logits) — its
            # page becomes a private COW copy at alloc time
            cow_last = True
            cached = len(prompt) - 1
        # pages popped from free∪evictable: fresh tail pages + the COW
        # copy; reviving an evictable shared page also consumes from the
        # evictable side of the pool
        n_new = need - len(shared) + (1 if cow_last else 0)
        revive = sum(1 for p in set(shared) if p in self._evictable)
        return PrefixPlan(shared, cow_last, n_new, cached, n_new + revive,
                          looked_up=True)

    def register(self, slot: int, prompt: np.ndarray) -> int:
        """Index `slot`'s pages holding full blocks of `prompt` for future
        sharing.  Already-indexed hashes are left pointing at their
        existing page (first writer wins).  Returns #pages registered."""
        if not self.prefix_cache:
            return 0
        n = 0
        for i, h in enumerate(block_hashes(prompt, self.page_size)):
            if i >= len(self._owned[slot]):
                break
            page = self._owned[slot][i]
            if h in self._page_of or page in self._hash_of:
                continue
            self._page_of[h] = page
            self._hash_of[page] = h
            self._block_of[page] = tuple(
                int(t) for t in
                prompt[i * self.page_size : (i + 1) * self.page_size]
            )
            n += 1
        return n

    # ------------------------------------------------------------- mutate
    def _pop_page(self) -> int:
        """Pop a writable page: free list first, then evict the oldest
        unreferenced cached page (dropping its hash entry)."""
        if self._free:
            return self._free.pop()
        if not self._evictable:
            raise RuntimeError("out of pages")
        page, _ = self._evictable.popitem(last=False)
        h = self._hash_of.pop(page)
        del self._page_of[h]
        del self._block_of[page]
        self.stats["evictions"] += 1
        return page

    def _take_shared(self, page: int) -> None:
        """Add one reference to a cached page (reviving it if parked)."""
        if self._ref[page] == 0:
            # must be parked in the evictable set; revive it
            del self._evictable[page]
        self._ref[page] += 1

    def alloc(self, slot: int, tokens: int,
              plan: Optional[PrefixPlan] = None) -> np.ndarray:
        """Reserve pages for `tokens` tokens in `slot`; returns page ids.

        With a `plan`, cached pages are shared (refcount bumped) and only
        the remainder is popped fresh.  ``plan.cow_last`` replaces the
        final shared page with a private copy — the engine must copy the
        page content on device (see :attr:`last_cow`)."""
        if self._owned[slot]:
            raise RuntimeError(f"slot {slot} already holds pages")
        need = pages_for(tokens, self.page_size)
        if need > self.pages_per_seq:
            raise ValueError(
                f"{tokens} tokens need {need} pages > pages_per_seq "
                f"{self.pages_per_seq} — request overflows the slot"
            )
        if plan is None:
            plan = PrefixPlan([], False, need, 0, need)
        if not self.can_admit(tokens, plan):
            raise RuntimeError(
                f"out of pages: need {plan.cost}, free {self.free_pages}"
            )
        # stats live here, not in plan(): a blocked queue head re-plans
        # every engine step and would inflate the reuse numbers
        if plan.looked_up:
            self.stats["lookups"] += 1
            self.stats["hit_tokens"] += plan.cached_tokens
        pages: List[int] = []
        self.last_cow: Optional[Tuple[int, int]] = None
        # share the hash-hit prefix first so reviving cannot race with
        # eviction in _pop_page
        for i, p in enumerate(plan.shared):
            if plan.cow_last and i == len(plan.shared) - 1:
                break
            self._take_shared(p)
            pages.append(p)
        if plan.cow_last:
            src = plan.shared[-1]
            dst = self._pop_page()
            self._ref[dst] = 1
            pages.append(dst)
            self.last_cow = (src, dst)
            self.stats["cow_copies"] += 1
        while len(pages) < need:
            p = self._pop_page()
            self._ref[p] = 1
            pages.append(p)
        self._owned[slot] = pages
        self._tokens[slot] = tokens
        self.table[slot, :need] = pages
        self.table[slot, need:] = NULL_PAGE
        return np.asarray(pages, np.int32)

    def append(self, slot: int, n: int = 1) -> None:
        """Extend `slot`'s reservation by `n` tokens (lazy growth)."""
        if not self._owned[slot]:
            raise RuntimeError(f"slot {slot} holds no pages")
        tokens = self._tokens[slot] + n
        need = pages_for(tokens, self.page_size)
        have = len(self._owned[slot])
        if need > self.pages_per_seq:
            raise ValueError(f"append overflows slot {slot} ({tokens} tokens)")
        if need - have > self.free_pages:
            raise RuntimeError("out of pages on append")
        for j in range(have, need):
            page = self._pop_page()
            self._ref[page] = 1
            self._owned[slot].append(page)
            self.table[slot, j] = page
        self._tokens[slot] = tokens

    def cow_write(self, slot: int, idx: int) -> Optional[Tuple[int, int]]:
        """Make `slot`'s idx-th page privately writable.

        * shared page (ref > 1): pop a fresh page, remap the slot to it and
          drop one reference from the original — returns ``(src, dst)`` so
          the caller can copy the page content on device.  The shared page
          itself is NEVER written.
        * exclusively-owned but hash-registered page: writing would corrupt
          the cached content for future sharers, so the page is unregistered
          in place (no copy needed) — returns ``None``.
        * private unregistered page: no-op, returns ``None``.
        """
        page = self._owned[slot][idx]
        if self._ref[page] > 1:
            dst = self._pop_page()
            self._ref[dst] = 1
            self._ref[page] -= 1
            self._owned[slot][idx] = dst
            self.table[slot, idx] = dst
            self.stats["cow_copies"] += 1
            return (page, dst)
        if page in self._hash_of:
            h = self._hash_of.pop(page)
            del self._page_of[h]
            del self._block_of[page]
        return None

    def release(self, slot: int) -> int:
        """Drop `slot`'s references; returns how many pages it held.

        A page whose refcount reaches 0 returns to the free list — unless
        it is hash-registered, in which case it parks in the evictable LRU
        set, still indexed for future prefix hits."""
        pages = self._owned[slot]
        for p in pages:
            if self._ref[p] <= 0:  # pragma: no cover - guard
                raise RuntimeError("double free detected")
            self._ref[p] -= 1
            if self._ref[p] == 0:
                if p in self._hash_of:
                    self._evictable[p] = None  # most-recently released last
                else:
                    self._free.append(p)
        n = len(pages)
        self._owned[slot] = []
        self._tokens[slot] = 0
        self.table[slot, :] = NULL_PAGE
        return n

    def drop_cache(self) -> int:
        """Evict every unreferenced cached page (flush); returns count."""
        n = len(self._evictable)
        while self._evictable:
            page, _ = self._evictable.popitem(last=False)
            h = self._hash_of.pop(page)
            del self._page_of[h]
            del self._block_of[page]
            self._free.append(page)
        return n

    # ------------------------------------------------------------- checks
    def check_invariants(self) -> None:
        """Refcounts equal live references; no page both free and mapped;
        the hash index never points at a freed page; no page leaks."""
        free = set(self._free)
        assert len(free) == len(self._free), "duplicate pages in free list"
        assert NULL_PAGE not in free, "null page entered the free list"
        evictable = set(self._evictable)
        assert not free & evictable, "page both free and evictable"
        # refcount == number of slot references holding the page
        counts = np.zeros((self.num_pages,), np.int64)
        for slot, pages in enumerate(self._owned):
            need = pages_for(self._tokens[slot], self.page_size)
            assert len(pages) == need, (slot, len(pages), need)
            for p in pages:
                counts[p] += 1
        assert np.array_equal(counts, self._ref), "refcount drift"
        owned = {p for pages in self._owned for p in pages}
        assert not free & owned, "page both free and owned"
        assert not evictable & owned, "page both evictable and owned"
        # hash index bijection, and never into the free list
        assert len(self._page_of) == len(self._hash_of)
        assert set(self._block_of) == set(self._hash_of), \
            "registered block content out of sync with the index"
        for h, p in self._page_of.items():
            assert self._hash_of.get(p) == h, "hash index not a bijection"
            assert p not in free, "hash index points at a freed page"
            assert p != NULL_PAGE
            if self._ref[p] == 0:
                assert p in evictable, "unreferenced cached page not parked"
        for p in evictable:
            assert p in self._hash_of, "evictable page missing from index"
            assert self._ref[p] == 0, "evictable page still referenced"
        # conservation: every non-null page is free, evictable, or owned
        assert len(free) + len(evictable) + len(owned) == self.num_pages - 1, \
            "page leak"
        # block-table rows mirror ownership
        for slot, pages in enumerate(self._owned):
            assert list(self.table[slot, : len(pages)]) == pages
            assert all(
                p == NULL_PAGE for p in self.table[slot, len(pages):]
            )


# --------------------------------------------------------------------- #
# the port's stacked pools: prefill insertion and copy-on-write copies
# --------------------------------------------------------------------- #
def _pools(cache_layers: Dict) -> List[torch.Tensor]:
    attn = cache_layers["sub0"]["attn"]
    return [attn["k_pool"], attn["v_pool"]]


def pad_dim(x: torch.Tensor, axis: int, target: int) -> torch.Tensor:
    """Zero-pad `axis` of x up to length `target` (no-op if already there)."""
    if x.shape[axis] >= target:
        return x
    shape = list(x.shape)
    shape[axis] = target - x.shape[axis]
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


@torch.no_grad()
def write_slot_paged(cache_layers: Dict, one_layers: Dict, page_ids: torch.Tensor) -> Dict:
    """Insert a batch-1 prefilled cache into the paged pools, in place.

    The attention ``k``/``v`` leaves (``(layers, 1, W, Hkv, D)``) are cut
    into page tiles and written to ``k_pool``/``v_pool`` (``(layers, P,
    page, Hkv, D)``) at `page_ids`.  `page_ids` may be padded with the null
    page — those tiles land on page 0 and are never read.  The port's
    stacks are attention-only, so there are no other leaves to place (the
    reference's also writes SSM state and cross-attention K/V into the
    slot's batch row)."""
    n_pages = page_ids.shape[0]
    src = one_layers["sub0"]["attn"]
    ids = page_ids.long()
    for pool, leaf in zip(_pools(cache_layers), (src["k"], src["v"])):
        u, _, W = leaf.shape[:3]
        page = pool.shape[2]
        rows = n_pages * page
        tiles = pad_dim(leaf[:, 0], 1, max(rows, W))[:, :rows]
        pool[:, ids] = tiles.reshape(u, n_pages, page, *leaf.shape[3:]).to(pool.dtype)
    return cache_layers


@torch.no_grad()
def copy_pages(cache_layers: Dict, src: torch.Tensor, dst: torch.Tensor) -> Dict:
    """Copy pool pages ``src`` -> ``dst`` in every layer, in place
    (copy-on-write).  `src`/`dst` are (n,) physical page ids."""
    for pool in _pools(cache_layers):
        pool[:, dst.long()] = pool[:, src.long()]
    return cache_layers
