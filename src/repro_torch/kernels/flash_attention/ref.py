"""Plain torch version of the flash-attention kernel: dense attention."""
from repro_torch.models.attention import dense_attention


def flash_attention_ref(q, k, v, *, causal: bool = True, q_offset=None):
    return dense_attention(q, k, v, causal=causal,
                           q_offset=0 if q_offset is None else q_offset)
