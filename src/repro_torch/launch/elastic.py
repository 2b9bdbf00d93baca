"""Elastic restart orchestration (``repro.launch.elastic`` counterpart):
heartbeats, mesh planning, the latest checkpoint and the restart policy
tied into one recovery routine.

When a worker dies mid-run, the coordinator re-plans the (data, model)
mesh over the survivors, finds the newest committed checkpoint
(:mod:`repro_torch.checkpoint.io`, whose leaves are stored unsharded) and
hands a :class:`RecoveryPlan` to a relaunch callback, so a long training
or serving job keeps its state.  The relaunch itself is the callback's
business (tests fake it, and the clock).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

from repro_torch.checkpoint import io as ckpt_io
from repro_torch.distributed.fault import (HeartbeatRegistry, RestartPolicy,
                                           plan_elastic_mesh)


@dataclasses.dataclass
class RecoveryPlan:
    resume_step: int
    data_parallel: int
    model_parallel: int
    lost_workers: list
    restart_delay_s: float


class ElasticCoordinator:
    """Decides when and how to restart a damaged job."""

    def __init__(self, ckpt_dir: str, chips_per_worker: int,
                 model_parallel: int, heartbeat_timeout_s: float = 60.0,
                 policy: Optional[RestartPolicy] = None,
                 clock=time.monotonic):
        self.ckpt_dir = ckpt_dir
        self.chips_per_worker = chips_per_worker
        self.model_parallel = model_parallel
        self.heartbeats = HeartbeatRegistry(heartbeat_timeout_s, clock=clock)
        self.policy = policy or RestartPolicy()
        self.n_workers_seen = 0

    def beat(self, worker: int):
        self.heartbeats.beat(worker)
        self.n_workers_seen = max(self.n_workers_seen, worker + 1)

    def check(self) -> Optional[RecoveryPlan]:
        """None when healthy; otherwise a recovery plan (raises once the
        restart budget is spent)."""
        dead = self.heartbeats.dead()
        if not dead:
            return None
        delay = self.policy.next_delay()
        if delay is None:
            raise RuntimeError(
                f"restart budget exhausted with dead workers {dead}")
        alive = len(self.heartbeats.alive())
        data, model = plan_elastic_mesh(alive * self.chips_per_worker,
                                        self.model_parallel)
        step = ckpt_io.latest_step(self.ckpt_dir) or 0
        return RecoveryPlan(resume_step=step, data_parallel=data,
                            model_parallel=model, lost_workers=dead,
                            restart_delay_s=delay)

    def recover(self, plan: RecoveryPlan,
                relaunch: Callable[[RecoveryPlan], None]):
        """Execute a plan (sleeping is the caller's business)."""
        relaunch(plan)
        # healthy again: reset the backoff for the next incident
        self.policy.reset()
