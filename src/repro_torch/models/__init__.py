"""Model zoo of the port: the dense, moe, vlm, audio, ssm and hybrid
families."""
from .transformer import (FAMILIES, RECURRENT_FAMILIES, ModelDims,
                          FwdOptions, model_dims, forward, layer_params,
                          hybrid_ffn_select, n_attn_layers)
from .attention import (attention, causal_attention_parts,
                        dense_attention, flash_attention_jax,
                        merge_attention_parts, pick_chunk)
from .moe import moe_decode, moe_layer
from .ssm import (MambaCache, MambaDims, init_mamba_cache, mamba_decode_step,
                  mamba_dims, mamba_forward, ssd_chunked)
from . import layers

__all__ = ["FAMILIES", "RECURRENT_FAMILIES", "ModelDims", "FwdOptions",
           "model_dims", "forward", "layer_params", "hybrid_ffn_select",
           "n_attn_layers", "MambaCache", "MambaDims", "init_mamba_cache",
           "mamba_decode_step", "mamba_dims", "mamba_forward",
           "ssd_chunked", "moe_decode", "moe_layer", "attention",
           "causal_attention_parts", "dense_attention",
           "flash_attention_jax", "merge_attention_parts", "pick_chunk",
           "layers"]
