"""Fault tolerance (``repro.distributed.fault`` counterpart)."""
from . import fault
