"""Fault-tolerant checkpointing in the JAX package's layout."""
from . import io
