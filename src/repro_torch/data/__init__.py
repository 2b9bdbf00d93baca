"""Deterministic synthetic data (``repro.data`` counterpart)."""
