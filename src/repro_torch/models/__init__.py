"""Model zoo of the port: the dense and moe families."""
from .transformer import (FAMILIES, ModelDims, FwdOptions, model_dims,
                          forward, layer_params)
from .attention import (attention, causal_attention_parts,
                        dense_attention, merge_attention_parts)
from .moe import moe_decode, moe_layer
from . import layers

__all__ = ["FAMILIES", "ModelDims", "FwdOptions", "model_dims", "forward",
           "layer_params", "moe_decode", "moe_layer", "attention",
           "causal_attention_parts", "dense_attention",
           "merge_attention_parts", "layers"]
