"""qwen3-moe-30b-a3b [hf:Qwen/Qwen3-30B-A3B; hf] — 128-expert top-8 MoE."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,            # Qwen3 uses decoupled 128-dim heads
    d_ff=768,                # per-expert ffn dim
    vocab_size=151936,
    moe_num_experts=128,
    moe_top_k=8,
    moe_every=1,             # every layer is MoE
    rope_theta=1e6,
    train_microbatches=2,
    source="hf:Qwen/Qwen3-30B-A3B; hf",
)
