"""The models: port of ``repro.models`` (the dense, moe and llava
transformers, rwkv6, zamba2 and whisper), serving and training, with
``params_from_numpy`` / ``params_to_numpy`` to carry a JAX-layout param tree
across and ``jax_leaves`` to read a port tree as the JAX package's."""
from repro_torch.models.base import (ModelBundle, ParamTree, Spec,
                                     cross_entropy, init_from_specs,
                                     jax_leaves)
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.models.registry import forward_reference, get_model

__all__ = ["ModelBundle", "ParamTree", "Spec", "cross_entropy",
           "forward_reference", "get_model", "init_from_specs",
           "jax_leaves", "params_from_numpy", "params_to_numpy"]
