"""Paged KV cache: fixed-size page pool + page-table scatter/gather.

The continuous-batching engine keeps one resident serving state per
accuracy tier, the pool.  Attention-cache leaves are stored as pages of
``page_size`` token positions, and every request holds a page table (a
vector of physical page ids) instead of a whole-``max_len`` slot.

Layout: paged leaves are ``(repeats, n_pages + 1, page_size, ...)``.
Physical page ``n_pages`` is the null page: table entries past a
request's allocation point at it, and decode scatters for inactive pool
rows land in it, so garbage never reaches a live page.  A leaf's trailing
axes are whatever its block caches: ``(KH, hd)`` for GQA's k / v, one
axis for MLA's latent ``ckv`` / ``kpe``.  Sequence-free leaves (an SSD
block's conv tail and state) stay per-slot (``(repeats, n_slots, ...)``);
:func:`paged_layout` records which phases page.

Host-side accounting: :class:`SlotAllocator` for decode rows and
:class:`PageAllocator` for KV pages (a request's full worst-case need is
reserved at admission, physical pages are taken as its write frontier
advances).

Device-side: :func:`gather_state` builds the dense view ``decode_step``
consumes (a fresh tensor per leaf), and :func:`scatter_token`,
:func:`scatter_chunk`, :func:`write_state` and :func:`zero_pages` write
into the pool IN PLACE (``index_put_`` / ``index_fill_``) and return it.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import List, Optional

import torch

from repro_torch.models import transformer


class ServingError(RuntimeError):
    """A serving-layer error with a one-line message."""


@dataclasses.dataclass
class SlotAllocator:
    """Fixed-size slot pool; allocation is lowest-free-slot-first."""

    n_slots: int

    def __post_init__(self):
        if self.n_slots < 1:
            raise ServingError(
                f"slot pool needs at least 1 slot, got {self.n_slots}")
        self._owner: dict = {}

    @property
    def n_free(self) -> int:
        return self.n_slots - len(self._owner)

    @property
    def owners(self) -> dict:
        """slot -> request id for every occupied slot (a copy)."""
        return dict(self._owner)

    def alloc(self, request_id: str) -> int:
        for slot in range(self.n_slots):
            if slot not in self._owner:
                self._owner[slot] = request_id
                return slot
        raise ServingError(
            f"KV pool exhausted: all {self.n_slots} slots in use "
            f"(admitting {request_id!r}); retire a request or grow the pool")

    def free(self, slot: int) -> None:
        if slot not in self._owner:
            raise ServingError(f"slot {slot} is not allocated")
        del self._owner[slot]

    def owner(self, slot: int) -> Optional[str]:
        return self._owner.get(slot)


@dataclasses.dataclass
class PageAllocator:
    """Reservation-based page accounting (host-side, deterministic).

    ``reserve(rid, n)`` claims capacity for a request's full worst-case
    need at admission; ``take_page(rid)`` turns one unit of it into a
    physical page id.  ``sum(held) <= sum(reserved) <= n_pages`` holds
    throughout, so exhaustion is an admission-time decision only.  Pages
    are handed out lowest-id-first from a sorted free list.
    """

    n_pages: int

    def __post_init__(self):
        if self.n_pages < 1:
            raise ServingError(
                f"page pool needs at least 1 page, got {self.n_pages}")
        self._free: List[int] = list(range(self.n_pages))
        self._reserved: dict = {}   # rid -> reserved page count
        self._held: dict = {}       # rid -> physical pages taken

    @property
    def n_free_pages(self) -> int:
        return len(self._free)

    @property
    def n_unreserved(self) -> int:
        return self.n_pages - sum(self._reserved.values())

    @property
    def owners(self) -> dict:
        """page -> request id for every physically held page (a copy)."""
        return {p: rid for rid, pages in self._held.items() for p in pages}

    def can_reserve(self, n: int) -> bool:
        return 1 <= n <= self.n_unreserved

    def reserve(self, request_id: str, n: int) -> None:
        if n < 1:
            raise ServingError(f"request {request_id!r}: page reservation "
                               f"must be >= 1, got {n}")
        if request_id in self._reserved:
            raise ServingError(
                f"request {request_id!r} already holds a page reservation")
        if n > self.n_unreserved:
            raise ServingError(
                f"page pool exhausted: {request_id!r} needs {n} pages but "
                f"only {self.n_unreserved} of {self.n_pages} are unreserved")
        self._reserved[request_id] = n
        self._held[request_id] = []

    def take_page(self, request_id: str) -> int:
        held = self._held.get(request_id)
        if held is None:
            raise ServingError(
                f"request {request_id!r} has no page reservation")
        if len(held) >= self._reserved[request_id]:
            raise ServingError(
                f"request {request_id!r} exceeded its reservation of "
                f"{self._reserved[request_id]} pages")
        if not self._free:  # unreachable while the invariant holds
            raise ServingError("page pool invariant violated: reservation "
                               "honored but no physical page is free")
        page = self._free.pop(0)
        held.append(page)
        return page

    def release(self, request_id: str) -> List[int]:
        """Drop the reservation; returns the physical pages it held (the
        caller re-zeroes them before reuse, see :func:`zero_pages`)."""
        if request_id not in self._reserved:
            raise ServingError(
                f"request {request_id!r} has no page reservation")
        pages = self._held.pop(request_id)
        del self._reserved[request_id]
        for p in pages:
            bisect.insort(self._free, p)
        return pages


# ---------------------------------------------------------------------------
# pool scatter/gather (paged transformer serving state)
# ---------------------------------------------------------------------------

def pages_for(n_positions: int, page_size: int) -> int:
    """Pages needed to hold ``n_positions`` cache rows."""
    return -(-int(n_positions) // int(page_size))


def paged_layout(cfg):
    """Per segment, the frozenset of pattern indices whose cache carries a
    sequence axis (every attention kind); SSM states stay per-slot."""
    return tuple(
        frozenset(pi for pi, spec in enumerate(pattern)
                  if spec.kind != "ssm" and spec.attn != "none")
        for _, pattern in cfg.segments)


def paged_pool_init(cfg, n_slots: int, n_pages: int, page_size: int,
                    dtype=torch.bfloat16, device=None):
    """The resident paged pool for ``cfg``: attention-cache leaves become
    ``(repeats, n_pages + 1, page_size, ...)`` (index ``n_pages`` is the
    null page), sequence-free leaves (SSD conv tail and state) stay
    per-slot ``(repeats, n_slots, ...)``."""
    if cfg.encoder_layers:
        raise ServingError(
            f"{cfg.arch_id}: encoder-decoder archs are not servable by the "
            f"token-only paged pool (requests carry no encoder inputs)")
    if page_size < 1:
        raise ServingError(f"page_size must be >= 1, got {page_size}")
    if n_pages < 1:
        raise ServingError(f"page pool needs at least 1 page, got {n_pages}")
    transformer.check_supported(cfg)
    layers = []
    for paged, (repeats, pattern) in zip(paged_layout(cfg), cfg.segments):
        layers.append({
            pi: (transformer.block_cache(cfg, spec, repeats, n_pages + 1,
                                         page_size, dtype, device)
                 if pi in paged else
                 transformer.block_cache(cfg, spec, repeats, n_slots, 1,
                                         dtype, device))
            for pi, spec in enumerate(pattern)})
    return {"layers": layers}


def _each(pool, layout, dense, paged_fn, slot_fn):
    """Call ``paged_fn(pool_leaf, dense_leaf)`` on paged phases and
    ``slot_fn`` on per-slot phases, leaf by leaf (``dense`` may be None)."""
    for si, seg in enumerate(pool["layers"]):
        for pi, leaves in seg.items():
            fn = paged_fn if pi in layout[si] else slot_fn
            for name, leaf in leaves.items():
                fn(leaf, None if dense is None
                   else dense["layers"][si][pi][name])


def gather_state(pool, layout, tables: torch.Tensor):
    """Dense decode view: for page tables ``(rows, max_pages)`` the paged
    leaves become ``(repeats, rows, max_pages * page_size, ...)``, a fresh
    tensor each (decode_step may update it in place).  Null-page entries
    contribute zeros.  Per-slot leaves are handed over as they are."""
    tables = tables.to(torch.long)

    def g(leaf):
        x = leaf[:, tables]  # (repeats, rows, max_pages, page_size, ...)
        s = x.shape
        return x.reshape(s[0], s[1], s[2] * s[3], *s[4:])

    return {"layers": [
        {pi: ({n: g(l) for n, l in seg[pi].items()} if pi in layout[si]
              else dict(seg[pi]))
         for pi in seg}
        for si, seg in enumerate(pool["layers"])
    ]}


def scatter_token(pool, layout, dense, tables, pos, page_size: int):
    """Write one decode step back, in place: for every row, the cache row
    at ``pos[row]`` of the dense state lands in page
    ``tables[row, pos // page_size]`` at offset ``pos % page_size``.
    Inactive rows carry null tables, so their rows land in the null page.
    Per-slot leaves take the new dense leaves wholesale (nothing to do
    when the step updated the pool's own leaves in place)."""
    tables = tables.to(torch.long)
    pos = pos.to(device=tables.device, dtype=torch.long)
    rows = torch.arange(tables.shape[0], device=tables.device)
    pidx = tables[rows, pos // page_size]
    off = pos % page_size

    def upd(pl, dl):
        pl[:, pidx, off] = dl[:, rows, pos].to(pl.dtype)

    _each(pool, layout, dense, upd,
          lambda pl, dl: None if dl is pl else pl.copy_(dl))
    return pool


def scatter_chunk(pool, layout, dense, table_row, start: int, length: int,
                  page_size: int):
    """Write one prefill chunk back (batch-1 path), in place: dense
    positions ``[start, start + length)`` land through ``table_row``
    (``(max_pages,)``).  Per-slot leaves are left alone (chunked prefill
    is for fully paged layouts)."""
    table_row = table_row.to(torch.long)
    pvec = int(start) + torch.arange(length, device=table_row.device)
    pidx = table_row[pvec // page_size]
    off = pvec % page_size

    def upd(pl, dl):
        pl[:, pidx, off] = dl[:, 0, int(start):int(start) + length].to(pl.dtype)

    _each(pool, layout, dense, upd, lambda pl, dl: None)
    return pool


def write_state(pool, layout, state, slot: int, table_row, page_size: int):
    """Install a whole prefilled batch-1 state, in place: paged leaves
    scatter every buffered position ``[0, L_buf)`` through ``table_row``;
    per-slot leaves write row ``slot``."""
    table_row = table_row.to(torch.long)

    def upd(pl, dl):
        pvec = torch.arange(dl.shape[2], device=table_row.device)
        pl[:, table_row[pvec // page_size], pvec % page_size] = \
            dl[:, 0].to(pl.dtype)

    def srow(pl, dl):
        pl[:, slot] = dl[:, 0].to(pl.dtype)

    _each(pool, layout, state, upd, srow)
    return pool


def zero_pages(pool, layout, pages):
    """Re-zero freed pages in place so the next occupant starts from the
    all-zeros state a fresh pool would give it."""
    def z(pl, _):
        idx = torch.as_tensor(list(pages), dtype=torch.long, device=pl.device)
        pl.index_fill_(1, idx, 0)

    _each(pool, layout, None, z, lambda pl, dl: None)
    return pool
