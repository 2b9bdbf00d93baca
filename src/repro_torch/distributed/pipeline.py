"""GPipe-style pipeline parallelism over a ``pipe`` mesh axis
(``repro.distributed.pipeline`` counterpart).

Layers split into ``S`` stages along ``pipe``; ``M`` microbatches stream
through in ``M + S - 1`` steps, each stage handing its output to the next
by a ring :func:`~repro_torch.distributed.collectives.ppermute`.  Bubble
fraction = (S - 1) / (M + S - 1).

The reference's final broadcast, ``ppermute(outputs, axis, [(0, i) for i
in range(S)])``, is refused by JAX for every S >= 2 (a permutation's
sources must be unique); this module does what its docstring and test
say: the outputs equal the stages applied in sequence, on every rank
(a broadcast from stage 0).
"""
from __future__ import annotations

import torch

from repro_torch import tree as tree_util

from .collectives import axis_index, broadcast, ppermute, shard_map
from .sharding import P


def pipeline_apply(mesh, stage_fn, params_stacked, x_microbatches,
                   axis: str = "pipe"):
    """Run ``stage_fn(stage_params, x) -> x`` as an S-stage GPipe pipeline.

    ``params_stacked``: a tree of tensors with leading dim S (the rank at
    stage ``s`` runs slice ``s``).  ``x_microbatches``: (M, mb, ...), the
    same on every rank.  Returns the (M, mb, ...) outputs on every rank.
    """
    S = mesh.shape[axis]
    M = x_microbatches.shape[0]

    def per_stage(params, xs):
        params = tree_util.map(lambda a: a[0], params)
        stage = axis_index(mesh, axis)
        buf = torch.zeros_like(xs[0])
        outputs = [None] * M
        ring = [(i, (i + 1) % S) for i in range(S)]
        for t in range(M + S - 1):
            # stage 0 injects microbatch t; the others take what arrived
            x_in = xs[min(t, M - 1)] if stage == 0 else buf
            y = stage_fn(params, x_in)
            # the last stage's output wraps round to stage 0, which
            # collects the finished microbatch t - (S - 1)
            buf = ppermute(y, mesh, axis, ring)
            if t >= S - 1:
                outputs[t - (S - 1)] = buf
        out = torch.stack(outputs)
        return broadcast(out, mesh, axis, 0) if S > 1 else out

    return shard_map(per_stage, mesh, (P(axis), P()), P())(
        params_stacked, x_microbatches)


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    return (n_stages - 1) / (n_microbatches + n_stages - 1)
