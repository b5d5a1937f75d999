"""mamba2-130m [arXiv:2405.21060; unverified] — SSD (state-space duality).

Attention-free: the Utopia hybrid KV translation is inapplicable (there
is no block indirection to translate — the SSM state is a fixed-size
tensor a row), so the engine serves it with no KV pool and no RSW
launch."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    num_heads=0,             # attention-free
    num_kv_heads=0,
    d_ff=0,                  # no separate MLP in mamba2 blocks
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    tie_embeddings=True,
    supports_long_context=True,
    utopia_applicable=False,
    source="arXiv:2405.21060; unverified",
)
