"""whisper-medium [arXiv:2212.04356; unverified] — enc-dec, conv frontend stub.

24 encoder + 24 decoder layers.  The conv/log-mel frontend is a stub: a
request carries (1500, d_model) precomputed frame embeddings
(``Request.frontend``) that the encoder reads.  The decoder keeps a paged
self-attention KV cache and, per batch slot, the fixed cross-attention
K/V of its encoder output (``cross_k``/``cross_v``)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium",
    family="audio",
    num_layers=24,           # decoder layers
    encoder_layers=24,
    is_encoder_decoder=True,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,         # full MHA
    d_ff=4096,
    vocab_size=51865,
    qkv_bias=True,
    frontend="audio",
    frontend_tokens=1500,
    source="arXiv:2212.04356; unverified",
)
