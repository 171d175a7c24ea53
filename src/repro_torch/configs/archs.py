"""The 10 architectures of the JAX package's registry, field for field.

The port runs every one on every path the reference gives it: the
decoder-only attention stacks paged and static, jamba and xlstm through
the static engine, whisper and internvl through ``Model.loss`` /
``prefill`` / ``decode_step`` with their frontends' inputs.
"""
from .base import ModelConfig, register

GEMMA2_2B = register(ModelConfig(
    name="gemma2-2b", family="dense", n_layers=26, d_model=2304, n_heads=8,
    n_kv_heads=4, head_dim=256, d_ff=9216, vocab_size=256000,
    sliding_window=4096, local_every=2, logit_softcap=30.0, attn_softcap=50.0,
    post_norm=True, embed_scale=2304 ** 0.5, tie_embeddings=True,
    source="arXiv:2408.00118; hf",
))

QWEN15_05B = register(ModelConfig(
    name="qwen1.5-0.5b", family="dense", n_layers=24, d_model=1024,
    n_heads=16, n_kv_heads=16, d_ff=2816, vocab_size=151936, qkv_bias=True,
    rope_theta=1_000_000.0, tie_embeddings=True,
    source="hf:Qwen/Qwen1.5-0.5B; hf",
))

INTERNLM2_18B = register(ModelConfig(
    name="internlm2-1.8b", family="dense", n_layers=24, d_model=2048,
    n_heads=16, n_kv_heads=8, d_ff=8192, vocab_size=92544,
    rope_theta=1_000_000.0, tie_embeddings=False,
    source="arXiv:2403.17297; hf",
))

GRANITE3_2B = register(ModelConfig(
    name="granite-3-2b", family="dense", n_layers=40, d_model=2048,
    n_heads=32, n_kv_heads=8, d_ff=8192, vocab_size=49155,
    tie_embeddings=True, source="hf:ibm-granite/granite-3.0-2b-base; hf",
))

GRANITE_MOE_3B = register(ModelConfig(
    name="granite-moe-3b-a800m", family="moe", n_layers=32, d_model=1536,
    n_heads=24, n_kv_heads=8, d_ff=512, vocab_size=49155, n_experts=40,
    n_experts_active=8, tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf",
))

ARCTIC_480B = register(ModelConfig(
    name="arctic-480b", family="moe", n_layers=35, d_model=7168, n_heads=56,
    n_kv_heads=8, d_ff=4864, vocab_size=32000, n_experts=128,
    n_experts_active=2, dense_residual=True, tie_embeddings=False,
    source="hf:Snowflake/snowflake-arctic-base; hf",
))

JAMBA_52B = register(ModelConfig(
    name="jamba-v0.1-52b", family="hybrid", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab_size=65536, n_experts=16,
    n_experts_active=2, moe_every=2, moe_offset=1, layer_pattern="jamba",
    attn_every=8, attn_offset=4, use_rope=False, tie_embeddings=False,
    source="arXiv:2403.19887; hf",
))

WHISPER_LARGE_V3 = register(ModelConfig(
    name="whisper-large-v3", family="audio", n_layers=32, n_enc_layers=32,
    d_model=1280, n_heads=20, n_kv_heads=20, d_ff=5120, vocab_size=51866,
    layer_pattern="encdec", use_rope=False, frontend="audio",
    tie_embeddings=True, source="arXiv:2212.04356; unverified",
))

INTERNVL2_76B = register(ModelConfig(
    name="internvl2-76b", family="vlm", n_layers=80, d_model=8192,
    n_heads=64, n_kv_heads=8, d_ff=28672, vocab_size=128256,
    rope_theta=500_000.0, frontend="vision", n_frontend_tokens=1024,
    tie_embeddings=False, source="arXiv:2404.16821; unverified",
))

XLSTM_125M = register(ModelConfig(
    name="xlstm-125m", family="ssm", n_layers=12, d_model=768, n_heads=4,
    n_kv_heads=4, head_dim=192, d_ff=0, vocab_size=50304,
    layer_pattern="xlstm", use_rope=False, tie_embeddings=True,
    source="arXiv:2405.04517; unverified",
))

ALL = [GEMMA2_2B, QWEN15_05B, INTERNLM2_18B, GRANITE3_2B, GRANITE_MOE_3B,
       ARCTIC_480B, JAMBA_52B, WHISPER_LARGE_V3, INTERNVL2_76B, XLSTM_125M]
