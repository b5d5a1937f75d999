"""jamba-1.5-large-398b [arXiv:2403.19887; hf] — Mamba+attn 1:7, MoE 16e top-2.

72 layers = 9 groups of 8 (7 mamba + 1 attention); MoE every other layer.
The SSM sublayers keep O(1) state a row; the one attention layer of a
group reads the paged, hybrid-translated KV pool."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    moe_num_experts=16,
    moe_top_k=2,
    moe_every=2,
    moe_offset=1,
    attn_every=8,            # 1 attention layer per 8 (1:7 interleave)
    ssm_state=16,
    ssm_head_dim=64,
    ssm_expand=2,
    supports_long_context=True,
    optimizer="adafactor",   # 398B total params: factored second moment
    train_microbatches=4,
    source="arXiv:2403.19887; hf",
)
