"""Continuous-batching serving engine with accuracy-tiered SLAs.

One engine serves many concurrent requests over ONE set of resident
weights.  Each accuracy tier (``premium`` exact, ``bulk`` segmented, ...)
owns a **lane**: a paged KV pool (:mod:`repro_torch.serving.kvcache`) and a
:class:`TransformerRunner` whose config carries that tier's numerics.  Per
engine step:

1. **admit**: a request is admitted when a decode row AND its full
   worst-case page reservation (``prompt + max_new - 1`` positions) are
   both available; admission is head-of-line in scheduler order;
2. **prefill**: every admitted-but-unprefilled prompt advances ONE
   ``prefill_chunk``-sized chunk (its last chunk lands the first token);
   a lane whose runner is not ``chunked`` (per-slot recurrent state, as
   in an SSD stack) prefills the whole prompt at once instead;
3. **decode**: every lane with active requests runs ONE ``decode_step``
   over its whole pool: gather through the per-row page tables, step,
   scatter the new cache rows back (inactive rows land in the null page);
4. **retire**: requests reaching ``max_new_tokens``/EOS free their row
   and pages the same step; freed pages are re-zeroed before reuse.

Greedy argmax happens outside the model call, as in ``Session.generate``,
so a request's tokens are comparable with a solo generate of its prompt.

Each step, each runner call and the runner's wait for its token are
spans of :mod:`repro_torch.serving.trace` (``serve.step``,
``serve.prefill``, ``serve.decode``, ``serve.sync``).

The engine is model-agnostic behind the :class:`ModelRunner` duck type.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.numerics import torch_dtype
from repro_torch.kernels import decode_attention
from repro_torch.models import transformer
from repro_torch.serving import kvcache, trace
from repro_torch.serving.kvcache import (PageAllocator, ServingError,
                                         SlotAllocator, pages_for)
from repro_torch.serving.scheduler import (DEFAULT_TIERS, MonotonicClock,
                                           Request, Scheduler, TierSpec)

__all__ = ["Engine", "Event", "ModelRunner", "TransformerRunner",
           "TierStats"]


class ModelRunner:
    """What a lane needs from a model (duck-typed; this class is the
    documentation).

    Sizing: ``n_slots`` decode rows, ``max_len`` the per-request position
    cap, ``page_size`` tokens per KV page, ``n_pages`` physical pages
    (page id ``n_pages`` is the null page) and ``prefill_chunk`` tokens
    per prefill chunk.  Page tables are int vectors of physical page ids,
    null-filled past the request's allocation; ``tables`` in
    :meth:`decode` stacks one per row, ``(n_slots, max_pages)``.

    ``chunked`` says which prefill the engine calls: True,
    :meth:`prefill_chunk_step` chunk by chunk; False (a model with
    per-slot recurrent state, which a chunk cannot re-enter),
    :meth:`prefill_full` once for the whole prompt.
    """

    n_slots: int
    max_len: int
    page_size: int
    n_pages: int
    prefill_chunk: int
    chunked: bool = True

    @property
    def max_pages(self) -> int:
        """Longest page table a single request can need."""
        return pages_for(self.max_len, self.page_size)

    def pages_for(self, n_positions: int) -> int:
        return pages_for(n_positions, self.page_size)

    def prefill_chunk_step(self, prompt, start: int, end: int, table_row):
        """Prefill prompt positions ``[start, end)`` into the pages of
        ``table_row``; returns the first generated token when ``end``
        completes the prompt, else None."""
        raise NotImplementedError

    def prefill_full(self, slot: int, prompt, table_row):
        """Prefill the whole prompt at batch 1 into decode row ``slot`` and
        the pages of ``table_row`` (covering ``pages_for(len(prompt))``
        full pages); returns the first generated token."""
        raise NotImplementedError

    def decode(self, tokens, pos, tables):
        """Advance the WHOLE pool one step from per-row last tokens and
        absolute positions (``(n_slots,)``) through per-row page tables;
        returns the per-row next tokens."""
        raise NotImplementedError

    def zero_pages(self, pages) -> None:
        """Re-zero freed physical pages before they can be reused."""
        raise NotImplementedError


class TransformerRunner(ModelRunner):
    """The real lane runner: a resident paged pool on ``device`` and the
    model's ``decode_step`` under the lane's config.

    PyTorch runs eagerly, so nothing is compiled per shape (the JAX
    package's per-chunk-shape jit cache has no counterpart).  A decode
    step is ``decode_step`` over a dense view gathered through the page
    tables, over all rows.  A prompt is prefilled chunk by chunk the same
    way when every cache leaf is paged; a per-slot (recurrent) leaf makes
    the runner not ``chunked``, and a prompt is then prefilled whole
    (``prefill``, then ``write_state`` into its row).
    """

    #: Default tokens per KV page.
    PAGE_SIZE = 16
    #: Default tokens prefilled per engine step per request.
    PREFILL_CHUNK = 32

    def __init__(self, cfg, params, n_slots: int, max_len: int, *,
                 page_size: Optional[int] = None,
                 pages: Optional[int] = None,
                 prefill_chunk: Optional[int] = None, device=None):
        if cfg.encoder_layers:
            raise ServingError(
                f"{cfg.arch_id}: encoder-decoder archs are not servable by "
                f"the token-only engine (requests carry no encoder inputs)")
        self.device = resolve_device(device)
        if params["embed"].device != self.device:
            raise ServingError(
                f"params live on {params['embed'].device} but the runner "
                f"serves on {self.device}")
        self.cfg = cfg
        self.params = params
        self.n_slots = n_slots
        self.max_len = max_len
        self.page_size = int(page_size or self.PAGE_SIZE)
        self.prefill_chunk = int(prefill_chunk or self.PREFILL_CHUNK)
        if self.page_size < 1:
            raise ServingError(
                f"page_size must be >= 1, got {self.page_size}")
        if self.prefill_chunk < 1:
            raise ServingError(
                f"prefill_chunk must be >= 1, got {self.prefill_chunk}")
        # default pool: capacity parity with whole-max_len slots
        self.n_pages = int(pages if pages is not None
                           else n_slots * self.max_pages)
        self._layout = kvcache.paged_layout(cfg)
        self.pool = kvcache.paged_pool_init(
            cfg, n_slots, self.n_pages, self.page_size,
            dtype=torch_dtype(cfg.dtype), device=self.device)
        # a chunk re-enters decode_step, which only sequence-axis (paged)
        # caches support; any per-slot recurrent leaf forces whole-prompt
        # prefill
        self.chunked = all(pi in self._layout[si]
                           for si, seg in enumerate(self.pool["layers"])
                           for pi in seg)

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int64), device=self.device)

    @torch.inference_mode()
    def prefill_chunk_step(self, prompt, start: int, end: int, table_row):
        prompt = np.asarray(prompt, np.int64)
        start, end = int(start), int(end)
        trow = self._tensor(table_row)
        dense = kvcache.gather_state(self.pool, self._layout, trow[None])
        tok = self._tensor(prompt[start:end])[None]
        logits, dense = transformer.decode_step(
            self.params, self.cfg, {"token": tok}, dense, start)
        kvcache.scatter_chunk(self.pool, self._layout, dense, trow, start,
                              end - start, self.page_size)
        if end == prompt.shape[0]:
            with trace.span("serve.sync"):
                return int(logits[0, -1].argmax())
        return None

    @torch.inference_mode()
    def prefill_full(self, slot: int, prompt, table_row):
        prompt = np.asarray(prompt, np.int64)
        # buffer exactly the pages the prompt occupies: write_state
        # scatters every buffered position through the table
        ml = self.pages_for(prompt.shape[0]) * self.page_size
        logits, state = transformer.prefill(
            self.params, self.cfg, {"tokens": self._tensor(prompt)[None]},
            max_len=ml)
        kvcache.write_state(self.pool, self._layout, state, slot,
                            self._tensor(table_row), self.page_size)
        with trace.span("serve.sync"):
            return int(logits[0, -1].argmax())

    @torch.inference_mode()
    def decode(self, tokens, pos, tables):
        tables = self._tensor(tables)
        pos = self._tensor(pos)
        dense = kvcache.gather_state(self.pool, self._layout, tables)
        if any(self._layout):
            # every row attends the whole view gathered through its table
            trace.count(ctx_attended=tables.numel() * self.page_size)
        fused_before = decode_attention.decode_core.launches
        logits, dense = transformer.decode_step(
            self.params, self.cfg, {"token": self._tensor(tokens)[:, None]},
            dense, pos)
        # the layers whose attention core took the fused kernel
        trace.count(attn_kernel_layers=decode_attention.decode_core.launches
                    - fused_before)
        kvcache.scatter_token(self.pool, self._layout, dense, tables, pos,
                              self.page_size)
        with trace.span("serve.sync"):
            return logits[:, -1].argmax(dim=-1).cpu().numpy().astype(np.int32)

    def zero_pages(self, pages) -> None:
        if len(pages) == 0:
            return
        kvcache.zero_pages(self.pool, self._layout, pages)


@dataclasses.dataclass(frozen=True)
class Event:
    """One streaming event: ``admit`` (row + page reservation granted),
    ``token`` (one generated token, the prefill token included) or
    ``finish``."""

    kind: str
    request_id: str
    tier: str
    step: int
    time: float
    token: Optional[int] = None


@dataclasses.dataclass
class TierStats:
    n_finished: int = 0
    n_tokens: int = 0
    n_decode_steps: int = 0
    occupancy_sum: int = 0      # active requests summed over decode steps
    n_prefill_chunks: int = 0   # prefill calls (chunks, or whole prompts)
    pages_reserved_sum: int = 0  # reserved pages summed over retired requests
    # steps that ran prefill chunks WHILE this lane also decoded — the
    # interleave chunked prefill exists to provide
    n_interleave_steps: int = 0
    # steps where active decoders stalled with no decode batch (must stay
    # 0: chunked prefill never preempts a lane's decode)
    n_decode_stall_steps: int = 0
    # host wall-clock seconds in the runner's decode / prefill calls (the
    # durations of their serve.decode / serve.prefill spans); each call
    # ends by copying its tokens to the host, so device work is in
    decode_s: float = 0.0
    prefill_s: float = 0.0

    @property
    def mean_occupancy(self) -> float:
        return (self.occupancy_sum / self.n_decode_steps
                if self.n_decode_steps else 0.0)

    @property
    def pages_per_request(self) -> float:
        """Mean KV pages reserved per retired request — the paged pool's
        footprint metric (a whole-``max_len`` slot design pins
        ``max_pages`` for every request)."""
        return (self.pages_reserved_sum / self.n_finished
                if self.n_finished else 0.0)


@dataclasses.dataclass
class _Lane:
    spec: TierSpec
    runner: ModelRunner
    alloc: SlotAllocator        # decode rows (cheap, no KV storage)
    pages: PageAllocator        # KV pages (the real capacity)
    active: dict                # slot -> Request (decoding)
    prefilling: dict            # slot -> Request (admitted, prompt pending)
    stats: TierStats


class Engine:
    """The continuous-batching serving engine (see module docstring)."""

    def __init__(self, runners: Mapping[str, ModelRunner],
                 tiers: Optional[Sequence[TierSpec]] = None,
                 *, clock=None, aging: Optional[float] = None):
        tiers = tuple(tiers) if tiers is not None else tuple(
            TierSpec(name, priority=i)
            for i, name in enumerate(runners))
        by_name = {t.name: t for t in tiers}
        if set(by_name) != set(runners):
            raise ServingError(
                f"tier specs {sorted(by_name)} do not match runners "
                f"{sorted(runners)}")
        self.clock = clock if clock is not None else MonotonicClock()
        self.scheduler = Scheduler(tuple(by_name), aging=aging)
        self._lanes = {
            name: _Lane(spec=by_name[name], runner=runner,
                        alloc=SlotAllocator(runner.n_slots),
                        pages=PageAllocator(runner.n_pages),
                        active={}, prefilling={}, stats=TierStats())
            for name, runner in runners.items()
        }
        self._step = 0
        self._n_submitted = 0
        self._inflight: dict = {}  # request_id -> Request (queued or active)

    # -- construction -------------------------------------------------------

    @classmethod
    def from_session(cls, session, tiers: Sequence[TierSpec] = DEFAULT_TIERS,
                     *, slots: int = 4, max_len: int = 64,
                     page_size: Optional[int] = None,
                     pages: Optional[int] = None,
                     prefill_chunk: Optional[int] = None, clock=None,
                     aging: Optional[float] = None) -> "Engine":
        """Build real lanes over a :class:`repro_torch.session.Session`:
        one :class:`TransformerRunner` per tier on the session's device,
        every tier's config sharing the session's resident params (tier
        policies go through the same coercion as ``Session(policy=...)``).

        ``page_size`` (default :data:`TransformerRunner.PAGE_SIZE`) sets
        the KV page granularity and ``pages`` the per-tier physical pool
        (default: ``slots * ceil(max_len / page_size)``); ``prefill_chunk``
        (default :data:`TransformerRunner.PREFILL_CHUNK`) bounds the prompt
        tokens prefilled per engine step."""
        runners = {}
        for spec in tiers:
            tier_sess = session.replace(policy=spec.policy)
            runners[spec.name] = TransformerRunner(
                tier_sess.config, session.params, slots, max_len,
                page_size=page_size, pages=pages,
                prefill_chunk=prefill_chunk, device=session.device)
        return cls(runners, tiers, clock=clock, aging=aging)

    # -- submission ---------------------------------------------------------

    @property
    def tiers(self) -> tuple:
        return tuple(self._lanes)

    def lane_stats(self) -> dict:
        return {name: lane.stats for name, lane in self._lanes.items()}

    def submit(self, prompt, tier: Optional[str] = None,
               max_new_tokens: int = 16, *, request_id: Optional[str] = None,
               priority: Optional[int] = None, on_token=None,
               eos_id: Optional[int] = None) -> Request:
        """Queue one request; returns the live :class:`Request` handle
        (its ``tokens``/``done`` fields update as the engine steps).

        ``eos_id`` retires the request as soon as it emits that token
        (the EOS is landed as the final token); its row and KV pages free
        the same step, so a waiting request can join the next admit pass.
        Early stopping never perturbs co-batched rows: their decode
        steps are the same with or without it.
        """
        if tier is None:
            tier = next(iter(self._lanes))
        lane = self._lanes.get(tier)
        if lane is None:
            raise ServingError(f"unknown tier {tier!r}; engine serves "
                               f"{sorted(self._lanes)}")
        rid = request_id or f"r{self._n_submitted}"
        if rid in self._inflight:
            raise ServingError(
                f"request id {rid!r} is already in flight (tier "
                f"{self._inflight[rid].tier!r}); ids must be unique until "
                f"the request finishes")
        req = Request(
            id=rid,
            prompt=prompt,
            max_new_tokens=max_new_tokens,
            tier=tier,
            priority=(priority if priority is not None
                      else lane.spec.priority),
            on_token=on_token,
            eos_id=eos_id,
        )
        self._n_submitted += 1
        need = req.prompt.shape[0] + req.max_new_tokens - 1
        if need > lane.runner.max_len:
            raise ServingError(
                f"request {req.id!r} needs {need} cache positions "
                f"(prompt {req.prompt.shape[0]} + {req.max_new_tokens} new) "
                f"but tier {tier!r} pools max_len={lane.runner.max_len}")
        if lane.runner.pages_for(need) > lane.runner.n_pages:
            raise ServingError(
                f"request {req.id!r} needs {lane.runner.pages_for(need)} KV "
                f"pages ({need} positions / page_size "
                f"{lane.runner.page_size}) but tier {tier!r} pools "
                f"{lane.runner.n_pages} pages")
        self._inflight[rid] = req
        return self.scheduler.submit(req, self.clock.now())

    # -- the serving loop ---------------------------------------------------

    def _emit(self, events, req, kind, token=None):
        now = self.clock.now()
        events.append(Event(kind=kind, request_id=req.id, tier=req.tier,
                            step=self._step, time=now, token=token))
        if kind == "token" and req.on_token is not None:
            req.on_token(req, token, req.complete)

    def _land_token(self, events, lane, req, token: int):
        req.tokens.append(int(token))
        lane.stats.n_tokens += 1
        self._emit(events, req, "token", token=int(token))
        # retire on the max-token cap OR the request's EOS stop token
        if req.complete:
            req.finish_time = self.clock.now()
            req.finish_step = self._step
            lane.alloc.free(req.slot)
            del lane.active[req.slot]
            freed = lane.pages.release(req.id)
            lane.runner.zero_pages(freed)
            req.pages = []
            lane.stats.pages_reserved_sum += req.n_reserved_pages
            self._inflight.pop(req.id, None)
            lane.stats.n_finished += 1
            self._emit(events, req, "finish")

    def _grow_pages(self, lane, req, n_positions: int):
        """Take physical pages (lazily, within the admission reservation)
        until ``req``'s table covers ``n_positions`` positions."""
        while len(req.pages) * lane.runner.page_size < n_positions:
            req.pages.append(lane.pages.take_page(req.id))

    def _table_row(self, runner, req):
        row = np.full(runner.max_pages, runner.n_pages, np.int32)
        row[:len(req.pages)] = req.pages
        return row

    def _prefill_one(self, events, lane, req):
        """Advance one request's prefill by one chunk (or the whole prompt
        when the runner is not chunked); lands the first token when the
        prompt completes."""
        runner = lane.runner
        L = req.prompt.shape[0]
        start = req.prefill_pos
        if runner.chunked:
            end = min(start + runner.prefill_chunk, L)
            self._grow_pages(lane, req, end)
        else:
            # the runner buffers pages_for(L) full pages: cover them all
            end = L
            self._grow_pages(lane, req, runner.pages_for(L) * runner.page_size)
        with trace.span("serve.prefill", tier=req.tier) as sp:
            row = self._table_row(runner, req)
            if runner.chunked:
                token = runner.prefill_chunk_step(req.prompt, start, end, row)
            else:
                token = runner.prefill_full(req.slot, req.prompt, row)
        lane.stats.prefill_s += sp.t1 - sp.t0
        req.prefill_pos = end
        lane.stats.n_prefill_chunks += 1
        if token is None:
            return
        del lane.prefilling[req.slot]
        req.pos = L
        lane.active[req.slot] = req
        self._land_token(events, lane, req, token)

    def _decode(self, events, lane):
        """One decode call over the lane's whole pool; lands every live
        row's token and retires the requests it completes."""
        runner = lane.runner
        n = runner.n_slots
        tokens = np.zeros(n, np.int32)
        pos = np.zeros(n, np.int32)
        tables = np.full((n, runner.max_pages), runner.n_pages, np.int32)
        used = 0
        for slot, req in lane.active.items():
            # this step writes cache position req.pos — make sure a
            # physical page covers it (always within the reservation)
            self._grow_pages(lane, req, req.pos + 1)
            tokens[slot] = req.tokens[-1]
            pos[slot] = req.pos
            tables[slot, :len(req.pages)] = req.pages
            used += req.pos + 1
        # the runner adds the positions it attends (ctx_attended)
        with trace.span("serve.decode", tier=lane.spec.name,
                        ctx_used=used) as sp:
            nxt = runner.decode(tokens, pos, tables)
        lane.stats.decode_s += sp.t1 - sp.t0
        lane.stats.n_decode_steps += 1
        lane.stats.occupancy_sum += len(lane.active)
        # iterate a snapshot: retirement mutates lane.active
        for slot, req in sorted(lane.active.items()):
            req.pos += 1
            self._land_token(events, lane, req, nxt[slot])

    def step(self) -> list:
        """One engine step: admit -> advance prefills one chunk -> decode
        every lane -> retire.  Returns the step's events."""
        self._step += 1
        with trace.span("serve.step"):
            events = []
            now = self.clock.now()
            ran_chunks = {}
            # decoders live BEFORE this step's prefill work: the interleave
            # / stall accounting is about what chunked prefill does to them
            had_active = {name: bool(lane.active)
                          for name, lane in self._lanes.items()}
            for name, lane in self._lanes.items():
                # admit while a row AND the head request's full page
                # reservation fit — head-of-line, so a big request is never
                # starved by smaller queue-jumpers behind it
                while lane.alloc.n_free and self.scheduler.pending(name):
                    head = self.scheduler.peek_next(name, now)
                    need = head.prompt.shape[0] + head.max_new_tokens - 1
                    n_need = lane.runner.pages_for(need)
                    if not lane.pages.can_reserve(n_need):
                        break
                    req = self.scheduler.pop_next(name, now)
                    lane.pages.reserve(req.id, n_need)
                    req.n_reserved_pages = n_need
                    req.slot = lane.alloc.alloc(req.id)
                    req.admit_time = now
                    req.admit_step = self._step
                    lane.prefilling[req.slot] = req
                    self._emit(events, req, "admit")
                # one prefill chunk per pending prompt, in admission order
                ran_chunks[name] = len(lane.prefilling)
                for req in [lane.prefilling[s] for s in list(lane.prefilling)]:
                    self._prefill_one(events, lane, req)
            for name, lane in self._lanes.items():
                if not lane.active:
                    # a lane whose decoders got no decode batch this step
                    # has stalled: structurally impossible here (prefill
                    # chunks never preempt decode)
                    if had_active[name]:
                        lane.stats.n_decode_stall_steps += 1
                    continue
                if ran_chunks[name] and had_active[name]:
                    lane.stats.n_interleave_steps += 1
                self._decode(events, lane)
            return events

    @property
    def idle(self) -> bool:
        return (self.scheduler.pending() == 0
                and all(not l.active and not l.prefilling
                        for l in self._lanes.values()))

    def run(self, max_steps: int = 100_000) -> dict:
        """Step until every queued request has finished; returns
        ``lane_stats()``.  ``max_steps`` bounds the drain (a structured
        :class:`ServingError` instead of a hang)."""
        steps = 0
        while not self.idle:
            if steps >= max_steps:
                raise ServingError(
                    f"engine did not drain within {max_steps} steps "
                    f"({self.scheduler.pending()} queued, "
                    f"{sum(len(l.active) + len(l.prefilling) for l in self._lanes.values())} "
                    f"active)")
            self.step()
            steps += 1
        return self.lane_stats()
