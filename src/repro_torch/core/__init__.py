"""Numerics core: ambient scopes and the numerics-aware matmul."""
