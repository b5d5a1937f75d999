"""Architecture + run configuration system.

``ArchConfig`` is the single source of truth for a model family instance.
``resolve(cfg, tp)`` derives the mesh-padded dims (head/vocab padding for a
given tensor-parallel degree) — padding is *explicit and reported* so the
roofline's useful-FLOPs ratio (MODEL_FLOPS / HLO_FLOPs) exposes the waste.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | vlm | audio | hybrid | ssm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    # --- MoE ---
    moe_num_experts: int = 0
    moe_top_k: int = 0
    moe_every: int = 1           # MoE on layers where (layer % moe_every == moe_offset)
    moe_offset: int = 0
    moe_capacity_factor: float = 1.25
    # --- hybrid / SSM (mamba2) ---
    attn_every: int = 0          # jamba: one attn layer per this many (0 = all attn)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 64
    # --- modality frontends (STUBS: input_specs provides embeddings) ---
    frontend: str = "none"       # none | vision | audio
    frontend_tokens: int = 0     # 256 patches / 1500 frames
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    # --- technique & runtime knobs ---
    utopia_applicable: bool = True
    supports_long_context: bool = False  # run the long_500k cell?
    kv_block_size: int = 64
    optimizer: str = "adamw"     # adamw | adafactor (huge models)
    remat: bool = True
    zero_shard_params: bool = True   # FSDP params over the data axis
    train_microbatches: int = 1      # gradient accumulation (activation mem)
    source: str = ""             # provenance tag from the assignment

    def __post_init__(self):
        if self.family not in ("dense", "moe", "vlm", "audio", "hybrid", "ssm"):
            raise ValueError(f"unknown family {self.family}")

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    def moe_on_layer(self, layer: int) -> bool:
        if self.moe_num_experts == 0:
            return False
        return layer % self.moe_every == self.moe_offset

    def attn_on_layer(self, layer: int) -> bool:
        if self.family == "ssm":
            return False
        if self.attn_every <= 1:
            return True
        return layer % self.attn_every == (self.attn_every - 1)

    # ---------------------------------------------------------- accounting
    def param_count(self) -> int:
        """Analytic parameter count (used by roofline MODEL_FLOPS)."""
        d, hd = self.d_model, self.resolved_head_dim
        nq, nkv = self.num_heads, self.num_kv_heads
        attn = d * hd * nq + 2 * d * hd * nkv + nq * hd * d  # q,k,v,o
        if self.qkv_bias:
            attn += hd * (nq + 2 * nkv)
        dense_mlp = 3 * d * self.d_ff                         # swiglu
        moe_mlp = self.moe_num_experts * 3 * d * self.d_ff \
            + d * self.moe_num_experts                        # experts + router
        d_inner = self.ssm_expand * d
        nheads_ssm = max(1, d_inner // self.ssm_head_dim)
        ssm = (d * (2 * d_inner + 2 * self.ssm_state + nheads_ssm)
               + d_inner * self.ssm_conv_width + 2 * nheads_ssm
               + d_inner * d)
        total = 0
        layers = self.num_layers
        for l in range(layers):
            is_attn = self.attn_on_layer(l)
            total += attn if is_attn else ssm
            if self.family == "ssm":
                total += 0  # mamba2 has no separate MLP
            elif self.moe_on_layer(l):
                total += moe_mlp
            else:
                total += dense_mlp
            total += 2 * d                                    # norms
        if self.is_encoder_decoder:
            enc = self.encoder_layers * (attn + dense_mlp + 2 * d)
            xattn = self.num_layers * (attn + d)              # cross-attn
            total += enc + xattn
        total += self.vocab_size * d                          # embed
        if not self.tie_embeddings:
            total += self.vocab_size * d                      # lm head
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k experts only)."""
        if self.moe_num_experts == 0:
            return self.param_count()
        d = self.d_model
        inactive_experts = self.moe_num_experts - self.moe_top_k
        n_moe_layers = sum(self.moe_on_layer(l) for l in range(self.num_layers))
        return self.param_count() - n_moe_layers * inactive_experts * 3 * d * self.d_ff


@dataclasses.dataclass(frozen=True)
class ResolvedDims:
    """Mesh-padded dims for a given TP degree."""
    num_heads: int
    num_kv_heads: int
    vocab_size: int
    d_ff: int
    pad_heads: int      # extra (wasted) q heads
    pad_vocab: int

    @property
    def any_padding(self) -> bool:
        return self.pad_heads > 0 or self.pad_vocab > 0


def resolve(cfg: ArchConfig, tp: int, vocab_align: int = 128) -> ResolvedDims:
    """Pad head/vocab/ff dims to TP divisibility.

    * q heads       -> multiple of tp (replicated KV when kv % tp != 0)
    * vocab         -> multiple of lcm(tp, vocab_align)
    * d_ff          -> multiple of tp (all assigned archs already divide)
    """
    nh = _round_up(cfg.num_heads, tp)
    nkv = cfg.num_kv_heads if cfg.num_kv_heads % tp == 0 else cfg.num_kv_heads
    va = tp * vocab_align // __import__("math").gcd(tp, vocab_align)
    vs = _round_up(cfg.vocab_size, va)
    ff = _round_up(cfg.d_ff, tp) if cfg.d_ff else cfg.d_ff
    return ResolvedDims(num_heads=nh, num_kv_heads=nkv, vocab_size=vs,
                        d_ff=ff, pad_heads=nh - cfg.num_heads,
                        pad_vocab=vs - cfg.vocab_size)


# ---------------------------------------------------------------------------
# Input-shape cells (assignment)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode


SHAPES: Tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", 4096, 256, "train"),
    ShapeCell("prefill_32k", 32768, 32, "prefill"),
    ShapeCell("decode_32k", 32768, 128, "decode"),
    ShapeCell("long_500k", 524288, 1, "decode"),
)


def shape_cell(name: str) -> ShapeCell:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


def cell_applicable(cfg: ArchConfig, shape: ShapeCell) -> Tuple[bool, str]:
    """Which (arch x shape) cells run; mirrors the assignment's skip rules."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, ("long_500k needs sub-quadratic attention; "
                       f"{cfg.name} is pure full-attention (skip per pool rules)")
    return True, ""


def reduced(cfg: ArchConfig) -> ArchConfig:
    """Smoke-test reduction: same family/topology, tiny dims."""
    return dataclasses.replace(
        cfg,
        num_layers=max(2, min(4, cfg.num_layers)),
        encoder_layers=2 if cfg.is_encoder_decoder else 0,
        d_model=64,
        num_heads=4,
        num_kv_heads=min(max(1, cfg.num_kv_heads // max(1, cfg.num_heads // 4)), 4),
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        moe_num_experts=min(cfg.moe_num_experts, 8),
        moe_top_k=min(cfg.moe_top_k, 2),
        moe_capacity_factor=8.0,   # no token drops in smoke tests (exact
                                   # prefill/decode/forward consistency)
        frontend_tokens=8 if cfg.frontend != "none" else 0,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_head_dim=16 if cfg.ssm_state else 64,
        ssm_chunk=8,
        attn_every=min(cfg.attn_every, 2) if cfg.attn_every else 0,
        kv_block_size=8,
    )
