"""Kernel substrate: plain PyTorch versions (``ref``), the hand-written
Hopper kernels with their wrappers, and backend dispatch."""
