"""Architecture + shape configuration schema (the port's own copy of
``repro.configs.base``, which it may not import).

Every assigned architecture is described by an ``ArchConfig``; every assigned
input shape by a ``ShapeSpec``.  The (arch x shape) product defines the
dry-run / roofline cells.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Shapes
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Architectures
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: Optional[int] = None  # default d_model // n_heads
    mlp_act: str = "swiglu"  # swiglu | sq_relu | gelu
    qkv_bias: bool = False
    mlp_bias: bool = False
    norm: str = "rmsnorm"  # rmsnorm | layernorm | layernorm_nobias
    parallel_block: bool = False  # command-r style parallel attn + ffn
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    rope_pct: float = 1.0  # fraction of head_dim rotated (stablelm: 0.25)
    mrope_sections: Optional[Tuple[int, int, int]] = None  # qwen2-vl M-RoPE

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25

    # --- SSM (mamba1) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: Optional[int] = None  # default ceil(d_model / 16)

    # --- hybrid (recurrentgemma): cycle of block kinds, e.g. 1 attn : 2 rglru
    block_pattern: Tuple[str, ...] = ()  # () => all "attn" (or "ssm" for ssm)
    local_window: int = 0  # sliding-window size for local attention blocks
    rnn_width: int = 0  # RG-LRU width (defaults to d_model)

    # --- encoder/decoder (whisper) ---
    encoder_decoder: bool = False
    n_enc_layers: int = 0
    enc_seq_len: int = 1_500  # stub frontend: precomputed frame embeddings

    # --- vlm ---
    vision_stub: bool = False

    # --- training knobs (per-arch defaults; overridable) ---
    remat: str = "full"  # full | save_attn | none
    microbatch: int = 1  # gradient-accumulation steps for train_4k
    optimizer: str = "adamw"  # adamw | momentum_bf16 (memory-lean for 1T)
    subquadratic: bool = False  # supports long_500k decode
    # prefill sharding strategy (EXPERIMENTS.md §Perf iteration 4): True =>
    # sequence-parallel prefill (weights replicated over `model`, sequence
    # sharded) instead of tensor parallelism — cheaper collectives for long
    # prompts on dense-attention archs.
    seq_parallel_prefill: bool = False
    # keep FSDP (data-axis) weight sharding at SERVE time (EXPERIMENTS.md
    # §Perf iteration 6): False => weights are model-sharded only for
    # prefill/decode, eliminating per-step weight all-gathers (FSDP is a
    # training optimization; it is a serving anti-pattern).  True only for
    # MoE archs whose expert weights cannot fit model-sharded HBM.
    serve_fsdp: bool = False

    # citation / provenance
    source: str = ""

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.ssm_state and self.ssm_dt_rank is None:
            object.__setattr__(self, "ssm_dt_rank", -(-self.d_model // 16))
        if self.block_pattern and not self.rnn_width:
            object.__setattr__(self, "rnn_width", self.d_model)

    # ------------------------------------------------------------------
    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_ssm(self) -> bool:
        return self.ssm_state > 0 and not self.block_pattern

    @property
    def is_hybrid(self) -> bool:
        return bool(self.block_pattern)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_rep(self) -> int:
        return self.n_heads // self.n_kv_heads

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kind for the decoder stack."""
        if self.block_pattern:
            pat = self.block_pattern
            return tuple(pat[i % len(pat)] for i in range(self.n_layers))
        if self.ssm_state:
            return ("ssm",) * self.n_layers
        return ("attn",) * self.n_layers

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Analytic parameter count (embedding + stack + head)."""
        D, F, V = self.d_model, self.d_ff, self.vocab_size
        H, KV, Dh = self.n_heads, self.n_kv_heads, self.head_dim
        total = V * D  # embedding
        if not self.tie_embeddings:
            total += V * D  # lm head
        kinds = self.layer_kinds()
        for kind in kinds:
            total += 2 * D  # norms (approx; parallel block has 1)
            if kind == "attn":
                total += D * (H * Dh) + 2 * D * (KV * Dh) + (H * Dh) * D
                if self.qkv_bias:
                    total += (H + 2 * KV) * Dh
            elif kind == "ssm":
                di, N, R = self.d_inner, self.ssm_state, self.ssm_dt_rank
                total += D * 2 * di + di * self.ssm_conv  # in_proj + conv
                total += di * (R + 2 * N) + R * di + di  # x_proj, dt_proj
                total += di * N + di  # A_log, D
                total += di * D  # out_proj
            elif kind == "rglru":
                W = self.rnn_width
                total += 2 * D * W + W * D  # gate/in proj + out proj
                total += W * self.ssm_conv + 2 * W  # conv + lru params (approx)
            if kind != "ssm":  # ssm blocks have no separate FFN
                if self.is_moe:
                    n_mat = 3 if self.mlp_act == "swiglu" else 2
                    total += self.n_experts * n_mat * D * F
                    total += D * self.n_experts  # router
                else:
                    n_mat = 3 if self.mlp_act == "swiglu" else 2
                    total += n_mat * D * F
        if self.encoder_decoder:
            for _ in range(self.n_enc_layers):
                total += D * (H * Dh) * 2 + 2 * D * (KV * Dh) + 2 * D
                n_mat = 3 if self.mlp_act == "swiglu" else 2
                total += n_mat * D * F
            # decoder cross-attention
            total += self.n_layers * (D * (H * Dh) + 2 * D * (KV * Dh) + (H * Dh) * D + D)
        return total

    def active_param_count(self) -> int:
        """Active (per-token) parameters — differs from total for MoE."""
        if not self.is_moe:
            return self.param_count()
        D, F = self.d_model, self.d_ff
        n_mat = 3 if self.mlp_act == "swiglu" else 2
        inactive = self.n_layers * (self.n_experts - self.top_k) * n_mat * D * F
        return self.param_count() - inactive


def cell_supported(arch: ArchConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Whether an (arch x shape) cell runs, and why not if it doesn't."""
    if shape.name == "long_500k" and not arch.subquadratic:
        return False, (
            "long_500k needs sub-quadratic token mixing; "
            f"{arch.name} is full-attention (skip per assignment rule)"
        )
    return True, ""
