"""granite-8b [arXiv:2405.04324; hf] — llama-arch code model."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-8b",
    family="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=49152,
    source="arXiv:2405.04324; hf",
)
