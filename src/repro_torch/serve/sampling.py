"""Per-slot token sampling: SamplingParams -> next-token ids, on the device.

The port of ``repro.serve.sampling`` (``prng_key_data``,
``apply_top_k_top_p``, ``sample_tokens``).  The engine scatters each
request's fields into per-batch-slot tensors of the decode state
(``samp_temp`` / ``samp_topk`` / ``samp_topp`` / ``samp_key``) at
admission, and both the serve step and the prefill steps turn logits into
token ids with :func:`sample_tokens`, so the engine still copies token ids,
never ``(B, V)`` logits, to the host.

Determinism: a request's key is ``PRNGKey(seed)`` (default seed = its
``seq_id``) and every sampled position folds the key with its absolute
context position, so a token is a function of ``(seed, position,
logits)`` only: independent of the admission schedule, chunking, batch
slot and batch neighbours.  Greedy rows (``temperature == 0``) take the
exact ``argmax``.

The random bits are JAX's: a torch threefry2x32 that reproduces
``jax.random.PRNGKey``, ``fold_in`` and ``bits`` as the JAX package runs
them (threefry2x32 with ``jax_threefry_partitionable=True``, the default
of the installed jax, and 64-bit types off, so a seed is taken modulo
2^32).  uint32 arithmetic runs in int64 under a 32-bit mask, so the same
code runs on the CPU and on the card.

Mask semantics: temperature scaling first, then top-k, then top-p over
the renormalized top-k distribution.  Both filters are thresholds on the
scaled logits (a value tying the cut-off survives), and the top-1 token
always survives.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

# temperature floor for the scale divide on greedy rows (their sampled
# branch is discarded by the final where; the clamp only avoids inf/nan)
TEMP_EPS = 1e-6
MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
_F32_TINY = float(np.finfo(np.float32).tiny)


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Immutable per-request sampling configuration.

    temperature == 0 selects greedy argmax (the default).  ``top_k <= 0``
    disables the top-k filter; ``top_p = 1`` disables the nucleus
    filter.  ``seed=None`` derives the request's stream from its
    ``seq_id``.
    """
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: Optional[int] = None

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, got "
                             f"{self.temperature}")
        if not 0 < self.top_p <= 1:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")

    @property
    def is_greedy(self) -> bool:
        return self.temperature == 0


GREEDY = SamplingParams()


# ------------------------------------------------------------- threefry

def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & MASK32


def threefry2x32(k0, k1, x0, x1):
    """The threefry2x32 block cipher (20 rounds) on int64 tensors holding
    uint32 values: key ``(k0, k1)`` (broadcastable to the counts), counts
    ``(x0, x1)``.  Returns the two output words, int64 in [0, 2^32)."""
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def prng_key_data(params: SamplingParams, seq_id: int) -> np.ndarray:
    """Host-side (2,) uint32 key data for a request's sampling stream:
    ``jax.random.PRNGKey(seed)``'s, where the seed is taken modulo 2^32
    (64-bit types off) and the high word is 0."""
    seed = params.seed if params.seed is not None else seq_id
    return np.asarray([0, int(seed) & MASK32], np.uint32)


def fold_in(keys: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``jax.random.fold_in`` per row: ``keys (B, 2)`` and ``data (B,)``
    (any integer dtype) -> ``(B, 2)`` int64 key data."""
    k = keys.to(torch.int64)
    d = data.to(torch.int64) & MASK32
    y0, y1 = threefry2x32(k[:, 0], k[:, 1], torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=1)


def random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)`` per row (the partitionable
    threefry: element i hashes the counter pair (0, i) and xors the two
    output words): ``keys (B, 2)`` -> ``(B, n)`` int64 in [0, 2^32)."""
    k = keys.to(torch.int64)
    i = torch.arange(n, dtype=torch.int64, device=keys.device)[None, :]
    y0, y1 = threefry2x32(k[:, :1], k[:, 1:], torch.zeros_like(i), i)
    return y0 ^ y1


def uniform(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), float32, minval=tiny, maxval=1)``
    per row, the draw under ``jax.random.gumbel``: the top 23 bits become
    the mantissa of a float in [1, 2), minus 1; then JAX's
    ``max(minval, f * (maxval - minval) + minval)``, where maxval - minval
    rounds to 1 in float32."""
    bits = (random_bits(keys, n) >> 9) | 0x3F800000
    f = bits.to(torch.int32).view(torch.float32) - 1.0
    return (f + _F32_TINY).clamp(min=_F32_TINY)


def gumbel(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,), float32)`` per row."""
    return -torch.log(-torch.log(uniform(keys, n)))


# --------------------------------------------------------------- masking

def apply_top_k_top_p(logits: torch.Tensor, top_k: torch.Tensor,
                      top_p: torch.Tensor) -> torch.Tensor:
    """Mask ``logits (B, V)`` to the per-row top-k / top-p support.

    ``top_k (B,)`` int (<= 0 disables), ``top_p (B,)`` float32.  Returns
    logits with excluded entries at ``-inf``.  The cut-off is a VALUE, so
    ties with the k-th / nucleus boundary logit are kept; the top-1 token
    always survives."""
    V = logits.shape[-1]
    neg = float("-inf")
    desc = torch.sort(logits, dim=-1, descending=True).values
    k = torch.where(top_k > 0, top_k.clamp(1, V), V).to(torch.int64)
    rank = torch.arange(V, device=logits.device)[None, :]
    in_k = rank < k[:, None]
    # top-p over the renormalized top-k'd distribution: the nucleus is
    # the shortest descending prefix whose mass reaches top_p
    desc_k = torch.where(in_k, desc, neg)
    probs = torch.softmax(desc_k, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # the rank < k clause re-asserts the top-k cut: the zero-probability
    # tail has cum - probs == 1, which rounding would let past top_p == 1
    keep = ((cum - probs) < top_p[:, None]) & in_k
    last = (keep.sum(dim=-1) - 1).clamp(min=0)
    thr = torch.gather(desc_k, 1, last[:, None])
    return torch.where(logits >= thr, logits, neg)


def sample_tokens(logits: torch.Tensor, temperature: torch.Tensor,
                  top_k: torch.Tensor, top_p: torch.Tensor,
                  keys: torch.Tensor, steps: torch.Tensor) -> torch.Tensor:
    """Per-slot next-token ids ``(B,) int32`` from ``logits (B, V)``.

    ``keys (B, 2)`` are the per-slot key data; ``steps (B,)`` the absolute
    context position each row samples at, folded into its key.  Rows with
    ``temperature <= 0`` return the exact argmax; everything is computed
    branch-free, so mixed greedy/sampled batches share one path."""
    greedy = logits.argmax(dim=-1).to(torch.int32)
    scaled = logits.float() / temperature.clamp(min=TEMP_EPS)[:, None]
    masked = apply_top_k_top_p(scaled, top_k, top_p)
    # gumbel-max: argmax(logits + G) ~ Categorical(softmax(logits)); the
    # -inf masked entries can never win
    noise = gumbel(fold_in(keys, steps), logits.shape[-1])
    sampled = (masked + noise).argmax(dim=-1).to(torch.int32)
    return torch.where(temperature > 0, sampled, greedy)


# ------------------------------------- speculative-decode verification

def sample_tokens_q(logits: torch.Tensor, temperature: torch.Tensor,
                    top_k: torch.Tensor, top_p: torch.Tensor,
                    keys: torch.Tensor, steps: torch.Tensor) -> torch.Tensor:
    """Multi-position sampler: ``logits (B, Q, V)`` -> ``(B, Q) int32``.

    Position ``i`` of row ``b`` draws with the key :func:`sample_tokens`
    folds after ``steps[b, i]`` context tokens, so each draw is the token
    the non-speculative stream emits at that position for the same
    logits.  ``temperature``/``top_k``/``top_p``/``keys`` are per row and
    shared by the row's positions; ``steps`` is ``(B, Q)``."""
    B, Q, V = logits.shape

    def rep(a):
        return a.repeat_interleave(Q, dim=0)

    flat = sample_tokens(logits.reshape(B * Q, V), rep(temperature),
                         rep(top_k), rep(top_p), rep(keys),
                         steps.reshape(B * Q))
    return flat.reshape(B, Q)


def verify_draft_tokens(target_tokens: torch.Tensor, drafts: torch.Tensor):
    """Draft acceptance: ``target_tokens (B, K+1)`` (the target's token at
    each window position: the argmax, or :func:`sample_tokens_q`'s draw)
    against ``drafts (B, K)``.

    Returns ``(accepted_tokens (B, K+1) int32, n_emit (B,) int32)``: a
    step emits ``accepted_tokens[b, :n_emit[b]]``, every leading draft
    that matched the target's token plus the target's own token at the
    first mismatch (or after the last draft), so ``1 <= n_emit <= K+1``.
    For a sampled row the position-folded draw is a maximal coupling of
    rejection sampling against the point-mass drafter: each emitted token
    is the draw the non-speculative stream makes at its position."""
    accept = (target_tokens[:, :-1] == drafts).to(torch.int32)
    keep = torch.cumprod(accept, dim=1)          # leading-accept prefix
    n_emit = (keep.sum(dim=1) + 1).to(torch.int32)
    return target_tokens.to(torch.int32), n_emit
