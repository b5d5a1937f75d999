"""qwen2.5-14b [hf:Qwen/Qwen2.5-0.5B; hf] — dense GQA with QKV bias."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-14b",
    family="dense",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=13824,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1e6,
    train_microbatches=2,
    source="hf:Qwen/Qwen2.5-0.5B; hf",
)
