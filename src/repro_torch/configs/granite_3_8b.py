"""granite-3-8b [hf:ibm-granite/granite-3.0-2b-base; hf] — dense GQA."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-3-8b",
    family="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=12800,
    vocab_size=49155,
    rope_theta=1e4,
    source="hf:ibm-granite/granite-3.0-2b-base; hf",
)
