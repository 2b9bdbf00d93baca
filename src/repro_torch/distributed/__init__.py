"""Fault tolerance (``repro.distributed.fault`` counterpart), sharding
rules, the collectives and ``shard_map`` over a mesh with ranks, and the
GPipe pipeline."""
from . import fault
