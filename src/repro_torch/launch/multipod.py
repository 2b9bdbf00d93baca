"""Cross-pod gradient reduction with an optional int8 hop between pods
(``repro.launch.multipod`` counterpart).

At 2+ pods the gradients are reduced in two levels: a mean within each
pod over ``data`` (the fast links), then a mean across pods over ``pod``
(the slow hop), which ``compress`` sends as blockwise int8 with error
feedback (:mod:`repro_torch.optim.compression`): the quantization sits
between the two levels, where no sharding annotation can put it.

Each rank passes its own gradients and gets the reduced ones back; the
reference's ``shard_map`` over ``P()`` specs gives every device the same
array, so the two packages agree where the ranks' inputs are equal.
"""
from __future__ import annotations

from repro_torch import tree as tree_util
from repro_torch.distributed.collectives import pmean
from repro_torch.optim.compression import (compress_with_feedback,
                                           init_error_feedback)


def hierarchical_grad_reduce(mesh, grads, errors=None, compress=False):
    """Mean of ``grads`` (a tree of tensors) over the mesh's ``pod`` and
    ``data`` axes.  With ``compress`` on a mesh with pods: the mean over
    ``data``, then :func:`compress_with_feedback` against ``errors``
    (zeros when None), then the mean over ``pod``.  Returns (reduced
    grads, new error feedback); ``errors`` unchanged without
    compression."""
    axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
    if not compress or "pod" not in mesh.shape:
        return tree_util.map(lambda g: pmean(g, mesh, axes), grads), errors
    if errors is None:
        errors = init_error_feedback(grads)

    def one(g, e):
        if "data" in mesh.shape:
            g = pmean(g, mesh, "data")
        gq, new_e = compress_with_feedback(g, e)
        return pmean(gq, mesh, "pod"), new_e

    pairs = [one(g, e) for g, e in zip(tree_util.leaves(grads),
                                        tree_util.leaves(errors))]
    return (tree_util.unflatten(grads, [g for g, _ in pairs]),
            tree_util.unflatten(grads, [e for _, e in pairs]))
