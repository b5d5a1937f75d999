"""qwen2-72b [arXiv:2407.10671; hf] — dense GQA with QKV bias (largest dense)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-72b",
    family="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1e6,
    optimizer="adafactor",   # 72B optimizer state must stay factored at 256 chips
    train_microbatches=4,
    source="arXiv:2407.10671; hf",
)
