"""Operations and bytes of the served work, from the configuration's shapes.

The peaks are NVIDIA's data sheet for one H100 SXM (dense bf16 on the
tensor cores, HBM3 bandwidth; the same numbers as
src/repro_torch/launch/mesh.py at commit 82f904d). A kernel's least time
is the larger of its operations over the peak rate and its bytes over
the bandwidth, with each input byte read once and each output byte
written once, for the rows and contexts the benchmark's dispatches held
(never the kernel's own launches), so a share reads the same whatever
implements the work.

Packed weights (the 4-bit MSB format the kernels read): half a byte a
code and a f32 codebook of 8 scales for every 64 codes.
"""
from __future__ import annotations

PEAK_FLOPS = 989.4e12       # bf16 dense FLOP/s, H100 SXM
HBM_BYTES_S = 3.35e12       # HBM3 bytes/s, H100 SXM
ACT = 2                     # bytes of a bf16 activation


def least_seconds(flops, nbytes):
    return max(flops / PEAK_FLOPS, nbytes / HBM_BYTES_S)


def packed_bytes(k, n):
    """Bytes of one packed (K, N) weight: codes and scales."""
    return k * n // 2 + (k * n // 64) * 8 * 4


def shapes(cfg):
    """The (K, N) of each projection of one layer, and the widths."""
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    h, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = d // h
    attn = [(d, h * hd), (d, kv * hd), (d, kv * hd), (h * hd, d)]
    mlp = [] if cfg.get("num_local_experts") else [(d, f), (d, f), (f, d)]
    return dict(d=d, f=f, h=h, kv=kv, hd=hd, attn=attn, mlp=mlp,
                layers=cfg["num_hidden_layers"],
                vocab=cfg["vocab_size"])


def dense_matmul(cfg, rows):
    """Kernel A on the layers' dense projections for ``rows`` positions
    in one forward: (flops, bytes)."""
    s = shapes(cfg)
    fl = by = 0
    for k, n in s["attn"] + s["mlp"]:
        fl += 2 * rows * k * n
        by += packed_bytes(k, n) + rows * (k + n) * ACT
    return fl * s["layers"], by * s["layers"]


def unembed(cfg, rows, vocab_padded):
    """The unembedding of ``rows`` hidden rows (f32 in, f32 logits out)."""
    d = cfg["hidden_size"]
    return (2 * rows * d * vocab_padded,
            packed_bytes(d, vocab_padded) + rows * (d + vocab_padded) * 4)


def paged_attention(cfg, contexts):
    """Kernel B over decode rows whose contexts (keys visible, the
    position itself included) are ``contexts``: each row reads its own
    sequence's K and V once, plus its q and output, in every layer."""
    s = shapes(cfg)
    ctx = sum(contexts)
    npos = len(contexts)
    fl = 4 * ctx * s["h"] * s["hd"]
    by = ctx * 2 * s["kv"] * s["hd"] * ACT + npos * 2 * s["h"] * s["hd"] * ACT
    return fl * s["layers"], by * s["layers"]


def paged_attention_prefill(cfg, segments):
    """Kernel B over a packed prefill wave of ``segments``, each (c0, c1):
    positions c0 .. c1 - 1 of one sequence, position p attending keys 0
    .. p. The least work reads each segment's c1 keys' K and V once
    (its positions share them) and each position's q and output once;
    every (query, key) pair costs 4 * head_dim operations a head."""
    s = shapes(cfg)
    pairs = sum((c1 * (c1 + 1) - c0 * (c0 + 1)) // 2 for c0, c1 in segments)
    npos = sum(c1 - c0 for c0, c1 in segments)
    keys = sum(c1 for _, c1 in segments)
    fl = 4 * pairs * s["h"] * s["hd"]
    by = keys * 2 * s["kv"] * s["hd"] * ACT + npos * 2 * s["h"] * s["hd"] * ACT
    return fl * s["layers"], by * s["layers"]


def experts(cfg, rows):
    """Kernel A's expert batch in one forward of ``rows`` tokens, each
    routed to ``num_experts_per_tok`` of ``num_local_experts``: the
    routed choices' gate, up and down products (bf16 rows in and out)
    and each expert that gets a token read once, taking as many experts
    as uniform routing gets a token on average, E (1 - (1 - k / E) **
    rows) (all 40 of granite's at 64 rows but for 6e-7 of one)."""
    s = shapes(cfg)
    e, k = cfg["num_local_experts"], cfg["num_experts_per_tok"]
    d, f = s["d"], s["f"]
    fl = 2 * rows * k * 3 * d * f
    touched = e * (1.0 - (1.0 - k / e) ** rows)
    by = touched * (2 * packed_bytes(d, f) + packed_bytes(f, d)) \
        + rows * k * 2 * (d + f) * ACT
    return fl * s["layers"], by * s["layers"]


def model_flops(cfg, contexts, logit_rows, vocab_padded):
    """Model FLOPs of a forward over positions with ``contexts``: every
    active projection (top-k experts only) and attention, plus the
    unembedding of ``logit_rows`` rows."""
    s = shapes(cfg)
    per = sum(2 * k * n for k, n in s["attn"] + s["mlp"])
    if cfg.get("num_local_experts"):
        per += 2 * cfg["num_experts_per_tok"] * 3 * s["d"] * s["f"]
        per += 2 * s["d"] * cfg["num_local_experts"]
    fl = per * s["layers"] * len(contexts)
    fl += 4 * sum(contexts) * s["h"] * s["hd"] * s["layers"]
    return fl + 2 * logit_rows * s["d"] * vocab_padded
