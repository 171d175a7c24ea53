"""Model/shape configuration system + registry (port of repro.configs.base;
torch dtypes in place of jnp ones)."""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | hybrid | audio | vlm | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads

    # attention features
    qkv_bias: bool = False
    use_rope: bool = True
    rope_theta: float = 10000.0
    sliding_window: int = 0        # gemma2 local layers
    local_every: int = 0           # window on layers with i % local_every == 0
    logit_softcap: float = 0.0
    attn_softcap: float = 0.0
    query_scale: float = 0.0       # 0 -> head_dim**-0.5
    post_norm: bool = False        # gemma2 pre+post norms
    embed_scale: float = 1.0       # gemma: sqrt(d_model)

    # MoE
    n_experts: int = 0
    n_experts_active: int = 0
    moe_every: int = 1             # layer i is MoE if i % moe_every == moe_offset
    moe_offset: int = 0
    dense_residual: bool = False   # arctic: dense MLP in parallel with MoE
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # layer pattern
    layer_pattern: str = "dense"   # dense | jamba | xlstm | encdec
    attn_every: int = 0            # jamba: attention if i % attn_every == attn_offset
    attn_offset: int = 4

    # mamba (jamba)
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    mamba_chunk: int = 128

    # enc-dec (whisper)
    n_enc_layers: int = 0

    # frontend stubs
    frontend: str = "none"         # none | audio | vision
    n_frontend_tokens: int = 0     # internvl: patch embeddings prepended

    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    dtype: object = torch.bfloat16
    attn_chunk: int = 512
    decode_chunk: int = 2048
    remat: bool = True
    vocab_round: int = 256

    source: str = ""               # provenance note

    @property
    def head_dim_(self):
        return self.head_dim or self.d_model // self.n_heads

    @property
    def vocab_padded(self):
        r = self.vocab_round
        return -(-self.vocab_size // r) * r

    @property
    def n_experts_padded(self):
        if not self.n_experts:
            return 0
        return -(-self.n_experts // 16) * 16 if self.n_experts % 16 else self.n_experts

    @property
    def mamba_d_inner(self):
        return self.mamba_expand * self.d_model

    @property
    def mamba_dt_rank(self):
        return -(-self.d_model // 16)

    @property
    def is_encdec(self):
        return self.layer_pattern == "encdec"

    def n_params(self) -> int:
        """Analytic parameter count (for 6*N*D model-FLOPs accounting)."""
        d, hd = self.d_model, self.head_dim_
        v = self.vocab_padded
        attn = d * self.n_heads * hd * 2 + d * self.n_kv_heads * hd * 2
        dense_ffn = 3 * d * self.d_ff
        n = v * d * (1 if self.tie_embeddings else 2)
        if self.layer_pattern == "xlstm":
            per_m = 4 * d * self.n_heads * hd + d * 2 * self.n_heads + \
                self.n_heads * hd * d
            per_s = 4 * d * self.n_heads * hd + self.n_heads * hd * hd + \
                self.n_heads * hd * d
            return n + (self.n_layers // 2) * (per_m + per_s)
        if self.layer_pattern == "jamba":
            di = self.mamba_d_inner
            mamba = d * 2 * di + di * (self.mamba_dt_rank + 2 * self.mamba_d_state) \
                + self.mamba_dt_rank * di + di * d + 4 * di
            n_attn = self.n_layers // self.attn_every
            n_moe = self.n_layers // self.moe_every
            moe = self.n_experts * 3 * d * self.d_ff + d * self.n_experts
            n += n_attn * attn + (self.n_layers - n_attn) * mamba
            n += n_moe * moe + (self.n_layers - n_moe) * dense_ffn
            return n
        layers = self.n_layers + self.n_enc_layers
        if self.n_experts:
            moe = self.n_experts * 3 * d * self.d_ff + d * self.n_experts
            per = attn + moe + (dense_ffn if self.dense_residual else 0)
            return n + layers * per
        per = attn + dense_ffn
        if self.is_encdec:
            per_dec = attn * 2 + dense_ffn  # + cross-attention
            return n + self.n_enc_layers * per + self.n_layers * per_dec
        return n + layers * per

    def n_active_params(self) -> int:
        """Active params per token (MoE: only top-k experts count)."""
        if not self.n_experts:
            return self.n_params()
        full = self.n_params()
        d = self.d_model
        n_moe = self.n_layers // self.moe_every
        dead = n_moe * (self.n_experts - self.n_experts_active) * 3 * d * self.d_ff
        return full - dead


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# archs allowed to run long_500k (sub-quadratic / bounded attention;
# DESIGN.md Sec. 5) — everything else documents a skip.
LONG_CONTEXT_OK = {"gemma2-2b", "jamba-v0.1-52b", "xlstm-125m"}

_REGISTRY = {}


def register(cfg: ModelConfig):
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    from . import archs  # noqa: F401  (populates the registry)
    return _REGISTRY[name]


def list_archs():
    from . import archs  # noqa: F401
    return sorted(_REGISTRY)


def cell_is_skipped(arch: str, shape: str) -> Optional[str]:
    """Return a skip reason for an (arch, shape) cell, or None if it runs."""
    cfg = get_config(arch)
    if shape == "long_500k" and arch not in LONG_CONTEXT_OK:
        return "pure full-attention arch: 500k decode excluded per assignment"
    return None


def smoke_config(name: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    cfg = get_config(name)
    repl = dict(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=503, attn_chunk=32, decode_chunk=32,
        dtype=torch.float32, vocab_round=64,
    )
    if cfg.n_experts:
        repl.update(n_experts=8, n_experts_active=2)
    if cfg.layer_pattern == "jamba":
        repl.update(n_layers=8, attn_every=8, moe_every=2)
    if cfg.layer_pattern == "xlstm":
        repl.update(n_layers=2, n_kv_heads=4)
    if cfg.is_encdec:
        repl.update(n_enc_layers=2, n_kv_heads=4)
    if cfg.n_kv_heads == cfg.n_heads:
        repl.update(n_kv_heads=4)
    if cfg.frontend == "vision":
        repl.update(n_frontend_tokens=4)
    return dataclasses.replace(cfg, **repl)
