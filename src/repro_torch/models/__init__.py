"""Model zoo of the port: the dense family."""
from .transformer import (ModelDims, FwdOptions, model_dims, forward,
                          layer_params)
from .attention import (attention, causal_attention_parts,
                        dense_attention, merge_attention_parts)
from . import layers

__all__ = ["ModelDims", "FwdOptions", "model_dims", "forward",
           "layer_params", "attention", "causal_attention_parts",
           "dense_attention", "merge_attention_parts", "layers"]
