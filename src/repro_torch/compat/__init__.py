"""Weight interop for the port: the JAX package's parameter trees
(:mod:`~repro_torch.compat.jax_params`), and pretrained checkpoints
(a safetensors reader and writer, the state-dict mapping DSL, and the
resnet18 converter behind ``Session.from_pretrained``)."""
from repro_torch.compat.converters import (Converter, LoadedCheckpoint,
                                           converter_for, export_pretrained,
                                           families, load_pretrained,
                                           register_converter)
from repro_torch.compat.jax_params import params_from_numpy, resnet_from_numpy
from repro_torch.compat.safetensors_io import (INDEX_SUFFIX, load_checkpoint,
                                               read_safetensors,
                                               read_torch_checkpoint,
                                               write_safetensors,
                                               write_sharded_checkpoint)
from repro_torch.compat.state_dict import (CompatError, Leaf, MapRule,
                                           Mapping, flatten_tree, tree_paths,
                                           unflatten_tree)

__all__ = [
    "CompatError", "Converter", "INDEX_SUFFIX", "Leaf", "LoadedCheckpoint",
    "MapRule", "Mapping", "converter_for", "export_pretrained", "families",
    "flatten_tree", "load_checkpoint", "load_pretrained", "params_from_numpy",
    "read_safetensors", "read_torch_checkpoint", "register_converter",
    "resnet_from_numpy", "tree_paths", "unflatten_tree", "write_safetensors",
    "write_sharded_checkpoint",
]
