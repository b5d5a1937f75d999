"""paligemma-3b [arXiv:2407.07726; hf] — SigLIP + gemma backbone.

The SigLIP vision tower is a stub: a request carries (256, d_model)
precomputed patch embeddings (``Request.frontend``), which the backbone
projects (``frontend_proj``) and prepends to the token stream; their K/V
occupy the first four KV blocks of the sequence."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,          # MQA
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    frontend="vision",
    frontend_tokens=256,
    tie_embeddings=True,     # gemma ties embeddings
    source="arXiv:2407.07726; hf",
)
