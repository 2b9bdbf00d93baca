"""Benchmarks of the port (``benchmarks/`` counterparts); they run on the
card unless the caller passes ``device="cpu"``."""
