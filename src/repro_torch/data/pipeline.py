"""Host data pipeline (``repro.data.pipeline`` counterpart): a
depth-bounded background prefetch of host batches, and an iterator of
device batches from a ``step -> host batch`` function.

On CUDA a batch is copied from pinned host memory without blocking, on
the current stream, so the copy of step ``k + 1`` overlaps the compute of
step ``k``.  One process feeds one card; there is no sharding to do.
"""
from __future__ import annotations

import collections
import threading
from typing import Callable, Iterator

import numpy as np
import torch


class Prefetcher:
    """Background-thread prefetch of host batches (depth-bounded)."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._it = it
        self._q = collections.deque()
        self._depth = depth
        self._lock = threading.Condition()
        self._done = False
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        try:
            for item in self._it:
                with self._lock:
                    while len(self._q) >= self._depth:
                        self._lock.wait(0.1)
                    self._q.append(item)
                    self._lock.notify_all()
        finally:
            with self._lock:
                self._done = True
                self._lock.notify_all()

    def __iter__(self):
        return self

    def __next__(self):
        with self._lock:
            while not self._q and not self._done:
                self._lock.wait(0.1)
            if self._q:
                item = self._q.popleft()
                self._lock.notify_all()
                return item
        raise StopIteration


def _tensors(host: dict, pin: bool) -> dict:
    out = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in host.items()}
    return {k: t.pin_memory() for k, t in out.items()} if pin else out


def sharded_batches(make_batch: Callable[[int], dict], start_step: int = 0,
                    device=None, prefetch: int = 2):
    """Iterator of ``(step, batch)`` from a ``step -> host batch of numpy
    arrays`` function, from ``start_step`` on.  Batches are made (and
    pinned, for CUDA) in a background thread and copied to ``device`` as
    they are taken; with ``device=None`` the host arrays come back."""
    pin = device is not None and torch.device(device).type == "cuda"

    def gen():
        step = start_step
        while True:
            host = make_batch(step)
            yield step, (host if device is None else _tensors(host, pin))
            step += 1

    for step, batch in Prefetcher(gen(), depth=prefetch):
        if device is not None:
            batch = {k: t.to(device, non_blocking=pin)
                     for k, t in batch.items()}
        yield step, batch
