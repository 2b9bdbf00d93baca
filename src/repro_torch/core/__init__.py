"""Numerics core: ambient scopes, the numerics-aware matmul, float formats,
the bit-level multipliers (AFPM and baselines), their registry and metrics."""
