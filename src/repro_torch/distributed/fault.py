"""Fault tolerance: straggler watchdog, heartbeat registry, restart policy
(``repro.distributed.fault`` counterpart, the same host-side logic).

On one card the training loop records its steps as worker 0; there is no
process group to ask.

Components:
  StepWatchdog      — per-step wall-time EWMA; flags stragglers (> k*median)
  HeartbeatRegistry — worker liveness with timeout -> dead-set
  RestartPolicy     — bounded restarts with exponential backoff
  plan_elastic_mesh — choose the largest (data', model) mesh that fits the
                      surviving device count (model kept — weights reshard
                      over data only, so no weight redistribution)
"""
from __future__ import annotations

import dataclasses
import time
from collections import defaultdict, deque
from typing import Dict, List, Optional, Tuple


class StepWatchdog:
    """Tracks per-worker step durations; flags stragglers."""

    def __init__(self, threshold: float = 2.0, window: int = 16):
        self.threshold = threshold
        self.durations: Dict[int, deque] = defaultdict(lambda: deque(maxlen=window))

    def record(self, worker: int, duration_s: float):
        self.durations[worker].append(duration_s)

    def _avg(self, worker: int) -> Optional[float]:
        d = self.durations[worker]
        return sum(d) / len(d) if d else None

    def stragglers(self) -> List[int]:
        avgs = {w: self._avg(w) for w in self.durations if self._avg(w) is not None}
        if len(avgs) < 2:
            return []
        med = sorted(avgs.values())[len(avgs) // 2]
        return sorted(w for w, a in avgs.items() if a > self.threshold * med)


class HeartbeatRegistry:
    def __init__(self, timeout_s: float = 60.0, clock=time.monotonic):
        self.timeout_s = timeout_s
        self._clock = clock
        self._last: Dict[int, float] = {}

    def beat(self, worker: int):
        self._last[worker] = self._clock()

    def dead(self) -> List[int]:
        now = self._clock()
        return sorted(w for w, t in self._last.items() if now - t > self.timeout_s)

    def alive(self) -> List[int]:
        now = self._clock()
        return sorted(w for w, t in self._last.items() if now - t <= self.timeout_s)


@dataclasses.dataclass
class RestartPolicy:
    max_restarts: int = 5
    backoff_base_s: float = 5.0
    backoff_cap_s: float = 300.0
    restarts: int = 0

    def next_delay(self) -> Optional[float]:
        """None = give up; otherwise seconds to wait before restarting."""
        if self.restarts >= self.max_restarts:
            return None
        delay = min(self.backoff_base_s * (2 ** self.restarts), self.backoff_cap_s)
        self.restarts += 1
        return delay

    def reset(self):
        self.restarts = 0


def plan_elastic_mesh(n_alive_chips: int, model_parallel: int) -> Tuple[int, int]:
    """Largest (data, model) mesh with the fixed model-parallel degree.

    Keeping ``model`` fixed means weight shards stay valid; only the data
    axis shrinks, so resuming = restore the checkpoint (its leaves are
    stored unsharded) under the new data axis.
    """
    if n_alive_chips < model_parallel:
        raise ValueError(
            f"cannot keep model_parallel={model_parallel} with {n_alive_chips} chips")
    data = n_alive_chips // model_parallel
    # batch divisibility prefers powers of two on the data axis
    while data & (data - 1):
        data -= 1
    return data, model_parallel


def should_restart_from(ckpt_dir: str) -> Optional[int]:
    """Restart protocol: resume from the newest committed checkpoint."""
    from repro_torch.checkpoint.io import latest_step

    return latest_step(ckpt_dir)
