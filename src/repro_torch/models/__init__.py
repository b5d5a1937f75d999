"""Model zoo of the port: the dense family."""
from .transformer import (ModelDims, FwdOptions, model_dims, forward,
                          layer_params)
from .attention import attention, dense_attention
from . import layers

__all__ = ["ModelDims", "FwdOptions", "model_dims", "forward",
           "layer_params", "attention", "dense_attention", "layers"]
