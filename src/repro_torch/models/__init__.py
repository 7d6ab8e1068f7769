"""The models' serving path: port of ``repro.models`` (the dense, moe and
llava transformers, rwkv6, zamba2 and whisper), with ``params_from_numpy``
to carry a JAX-layout param tree across."""
from repro_torch.models.base import (ModelBundle, ParamTree, Spec,
                                     init_from_specs)
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.registry import forward_reference, get_model

__all__ = ["ModelBundle", "ParamTree", "Spec", "forward_reference",
           "get_model", "init_from_specs", "params_from_numpy"]
