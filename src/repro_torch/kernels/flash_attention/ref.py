"""Plain torch version of the flash-attention kernel: dense attention."""
from repro_torch.models.attention import dense_attention


def flash_attention_ref(q, k, v, *, causal: bool = True):
    return dense_attention(q, k, v, causal=causal)
