"""llama4-scout-17b-a16e [hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

MoE 16 experts top-1; the early-fusion multimodal frontend is out of scope
for the LM cells (text backbone only, per the assignment)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    moe_num_experts=16,
    moe_top_k=1,
    moe_every=1,
    rope_theta=5e5,
    train_microbatches=2,
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
)
