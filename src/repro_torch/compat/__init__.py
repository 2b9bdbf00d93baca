"""Weight interop for the port: the JAX package's parameter trees in this
slice (the safetensors reader and ``from_pretrained`` come later)."""
from repro_torch.compat.jax_params import params_from_numpy

__all__ = ["params_from_numpy"]
