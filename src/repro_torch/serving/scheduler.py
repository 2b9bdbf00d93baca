"""Request queue + admission scheduler with accuracy-tiered SLAs.

The paper's accuracy knob becomes a *traffic* knob here: every request
carries a traffic class, every class maps to an accuracy **tier** (a
preset, config or per-layer policy served on the same
resident weights), and admission into a tier's KV-slot pool is ordered by
``(effective priority, arrival order)``:

- priority 0 admits first; ties break by arrival sequence (FIFO);
- **aging** guarantees starvation-freedom under a flood of high-priority
  arrivals: a request that has waited longer than ``aging`` clock units
  is treated as priority 0, so FIFO order among aged requests bounds
  every admitted request's wait by the pool's service rate.

Time comes from an injected clock so the engine is deterministic under
test: :class:`FakeClock` is advanced manually by a scripted test;
:class:`MonotonicClock` is the production default.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence

import numpy as np

from repro_torch.serving.kvcache import ServingError


# ---------------------------------------------------------------------------
# clocks
# ---------------------------------------------------------------------------

class MonotonicClock:
    """Production clock: ``time.monotonic`` seconds."""

    def now(self) -> float:
        return time.monotonic()


class FakeClock:
    """Deterministic manually-advanced clock for the scheduler test rig."""

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ServingError(f"FakeClock cannot go backwards (dt={dt})")
        self._t += dt
        return self._t


# ---------------------------------------------------------------------------
# tiers (traffic class -> accuracy policy)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TierSpec:
    """One accuracy tier: a named traffic class served under ``policy``
    (a preset name, a NumericsConfig, a NumericsPolicy or a policy JSON
    path, as ``repro_torch.session`` accepts) at admission ``priority``
    (0 = admits first)."""

    name: str
    policy: object = "exact"
    priority: int = 0


#: The default SLA ladder: premium traffic decodes exact, standard under
#: the 3-pass segmented multiplier (AC-like), bulk under 1-pass
#: (ACL-like) — all three on the same resident weights.
DEFAULT_TIERS: tuple = (
    TierSpec("premium", "exact", priority=0),
    TierSpec("standard", "segmented3", priority=1),
    TierSpec("bulk", "segmented1", priority=2),
)


# ---------------------------------------------------------------------------
# requests
# ---------------------------------------------------------------------------

@dataclasses.dataclass(eq=False)
class Request:
    """One generation request plus its mutable serving progress.

    The spec half (id/prompt/max_new_tokens/tier/priority) is set at
    submission; the progress half (tokens/slot/…) is owned by the engine.
    ``tokens`` accumulates the greedy continuation — for a request served
    solo it is bit-identical to ``Session.generate`` of the same prompt
    under the tier's policy.

    ``eq=False``: requests compare by identity.  The auto-generated
    ``__eq__`` would compare the ``np.ndarray`` prompt field, so two
    queued requests sharing an id made ``Scheduler.pop_next``'s
    ``q.remove(best)`` raise "truth value of an array is ambiguous"
    (duplicate in-flight ids are additionally rejected at
    ``Engine.submit``).
    """

    id: str
    prompt: np.ndarray          # (prompt_len,) int32
    max_new_tokens: int
    tier: str
    priority: int = 0
    on_token: Optional[Callable] = None  # on_token(request, token, done)
    eos_id: Optional[int] = None  # stop token: retire on emitting it
    # -- engine-owned progress ---------------------------------------------
    seq: int = -1               # global arrival sequence number
    arrival_time: float = 0.0
    admit_time: Optional[float] = None
    finish_time: Optional[float] = None
    admit_step: Optional[int] = None
    finish_step: Optional[int] = None
    slot: Optional[int] = None
    pos: int = 0                # next absolute decode position
    tokens: List[int] = dataclasses.field(default_factory=list)
    # -- paged-KV progress (engine-owned) ----------------------------------
    prefill_pos: int = 0        # prompt positions prefilled so far
    pages: List[int] = dataclasses.field(default_factory=list)
    n_reserved_pages: int = 0   # full worst-case reservation at admission

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size == 0:
            raise ServingError(f"request {self.id!r} has an empty prompt")
        if self.max_new_tokens < 1:
            raise ServingError(
                f"request {self.id!r}: max_new_tokens must be >= 1, got "
                f"{self.max_new_tokens}")

    @property
    def done(self) -> bool:
        return self.finish_time is not None

    @property
    def complete(self) -> bool:
        """True once the landed tokens satisfy the stop condition: the
        ``max_new_tokens`` cap, or the ``eos_id`` stop token (the EOS
        itself is the last landed token)."""
        if len(self.tokens) >= self.max_new_tokens:
            return True
        return (self.eos_id is not None and len(self.tokens) > 0
                and self.tokens[-1] == self.eos_id)

    def result(self) -> np.ndarray:
        """The generated continuation, (n,) int32 — ``max_new_tokens``
        long, or shorter when ``eos_id`` stopped it (EOS included)."""
        if not self.done:
            raise ServingError(f"request {self.id!r} is not finished "
                               f"({len(self.tokens)}/{self.max_new_tokens} "
                               f"tokens)")
        return np.asarray(self.tokens, np.int32)


# ---------------------------------------------------------------------------
# the scheduler
# ---------------------------------------------------------------------------

class Scheduler:
    """Per-tier admission queues ordered by (effective priority, arrival).

    ``aging`` (clock units; ``None`` disables) is the starvation bound:
    once ``now - arrival_time >= aging`` a request's effective priority
    becomes 0, so it can no longer be overtaken by fresh high-priority
    arrivals of the same tier.
    """

    def __init__(self, tiers: Sequence[str], aging: Optional[float] = None):
        if not tiers:
            raise ServingError("scheduler needs at least one tier")
        self._queues: dict[str, list[Request]] = {t: [] for t in tiers}
        self.aging = aging
        self._seq = 0

    @property
    def tiers(self) -> tuple:
        return tuple(self._queues)

    def submit(self, req: Request, now: float) -> Request:
        if req.tier not in self._queues:
            raise ServingError(
                f"unknown tier {req.tier!r} for request {req.id!r}; "
                f"expected one of {sorted(self._queues)}")
        req.seq = self._seq
        self._seq += 1
        req.arrival_time = now
        self._queues[req.tier].append(req)
        return req

    def pending(self, tier: Optional[str] = None) -> int:
        if tier is not None:
            return len(self._queues[tier])
        return sum(len(q) for q in self._queues.values())

    def effective_priority(self, req: Request, now: float) -> int:
        if self.aging is not None and now - req.arrival_time >= self.aging:
            return 0
        return req.priority

    def peek_next(self, tier: str, now: float) -> Optional[Request]:
        """The request :meth:`pop_next` would return, without removing it.
        Admission peeks first so a head request whose page reservation
        does not fit yet BLOCKS the queue (head-of-line) instead of being
        popped-and-requeued, which would forfeit its FIFO position."""
        q = self._queues[tier]
        if not q:
            return None
        return min(q, key=lambda r: (self.effective_priority(r, now), r.seq))

    def pop_next(self, tier: str, now: float) -> Optional[Request]:
        """The next request to admit for ``tier`` (or None): lowest
        effective priority first, FIFO (arrival seq) within a priority."""
        best = self.peek_next(tier, now)
        if best is not None:
            self._queues[tier].remove(best)
        return best
