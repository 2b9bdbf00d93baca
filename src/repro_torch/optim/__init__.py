"""Optimizers (``repro.optim`` counterpart): AdamW with dtype-configurable
moments, Adafactor, schedules, clipping, int8 gradient compression with
error feedback."""
from . import adafactor, adamw, compression
from .adamw import AdamWConfig, OptState
