"""Continuous-batching scheduler (``repro.launch.scheduler`` counterpart).

Host-side orchestration of the decode loop: a fixed pool of slots, a FIFO
request queue, prefill on admission, a position per slot, and retirement
on completion.  The device work stays in the step functions
(:func:`repro_torch.launch.steps.make_prefill_step` /
:func:`~repro_torch.launch.steps.make_decode_step`, bound to their params by
the caller); this module keeps only the host's bookkeeping.

Each admitted request is prefilled alone into its slot's own serving state,
and each active slot then takes one decode step a tick.  Sampling is greedy:
the argmax of the last logits row, taken on the logits' device; only the
chosen token id comes back to the host.  The numerics (a preset or a
per-layer policy) are fixed by the step functions' config while requests
stream through, as a CiM multiplier's configuration is set per model, not
per request.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch._device import resolve_device


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray                  # (prompt_len,) token ids
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    # filled by the scheduler
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass
class SlotState:
    request: Optional[Request] = None
    pos: int = 0                        # next write position in the cache

    @property
    def free(self) -> bool:
        return self.request is None


def _greedy(logits: torch.Tensor) -> int:
    """The argmax of the last row of ``logits (1, S, V)``, on its device."""
    return int(logits[0, -1].argmax())


class ContinuousBatcher:
    """Schedules requests through ``(prefill_fn, decode_fn)`` over slots.

    ``prefill_fn(tokens (1, L) int64) -> (logits (1, 1, V), state)`` and
    ``decode_fn(token (1, 1) int64, state, pos: int) -> (logits, state)``;
    token tensors are made on ``device`` (``cuda`` unless ``"cpu"``).  A
    slot's state is its own, so every slot decodes at its own position.
    """

    def __init__(self, n_slots: int, prefill_fn: Callable, decode_fn: Callable,
                 max_len: int, device=None):
        self.slots = [SlotState() for _ in range(n_slots)]
        self.queue: deque[Request] = deque()
        self.prefill_fn = prefill_fn
        self.decode_fn = decode_fn
        self.max_len = max_len
        self.device = resolve_device(device)
        self.states: Dict[int, object] = {}   # slot -> its serving state
        self.completed: List[Request] = []

    def submit(self, req: Request):
        self.queue.append(req)

    def _admit(self):
        for i, slot in enumerate(self.slots):
            if slot.free and self.queue:
                req = self.queue.popleft()
                prompt = torch.as_tensor(np.asarray(req.prompt, np.int64),
                                         device=self.device)
                logits, state = self.prefill_fn(prompt[None, :])
                req.generated.append(_greedy(logits))
                slot.request = req
                slot.pos = len(req.prompt)
                self.states[i] = state

    def _retire(self, i: int):
        slot = self.slots[i]
        slot.request.done = True
        self.completed.append(slot.request)
        slot.request = None
        self.states.pop(i, None)

    def step(self):
        """One scheduler tick: admit, decode every active slot, retire."""
        self._admit()
        for i, slot in enumerate(self.slots):
            if slot.free:
                continue
            req = slot.request
            last = req.generated[-1]
            if (len(req.generated) >= req.max_new_tokens
                    or (req.eos_id is not None and last == req.eos_id)
                    or slot.pos + 1 >= self.max_len):
                self._retire(i)
                continue
            tok = torch.tensor([[last]], dtype=torch.int64, device=self.device)
            logits, self.states[i] = self.decode_fn(tok, self.states[i],
                                                    slot.pos)
            req.generated.append(_greedy(logits))
            slot.pos += 1

    def run_to_completion(self, max_ticks: int = 10_000):
        ticks = 0
        while (self.queue or any(not s.free for s in self.slots)) \
                and ticks < max_ticks:
            self.step()
            ticks += 1
        return self.completed, ticks

    @property
    def utilization(self) -> float:
        busy = sum(0 if s.free else 1 for s in self.slots)
        return busy / len(self.slots)
