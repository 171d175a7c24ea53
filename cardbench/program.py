"""What the harness takes from the program under test, ``repro_torch``.

The port is imported from the checkout's ``src/``; nothing here or in the
drivers imports the JAX package. The benchmark hands the port its own raw
weights (``weights.make``) and reads back only outputs, host counters and
the packed leaves it is to be judged on.
"""
from __future__ import annotations

import importlib
import sys
import time

from .manifest import ROOT


def port():
    """The ``repro_torch`` package from ``src/`` of this checkout."""
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    return importlib.import_module("repro_torch")


def build_kernels(device):
    """nvcc builds of the port's kernels into its fixed build directory
    inside the checkout (a no-op once built there). Returns seconds."""
    if device.type != "cuda":
        return 0.0
    from repro_torch.kernels import _build
    t0 = time.monotonic()
    _build.build_all()
    return time.monotonic() - t0


def model_config(torch, cfg):
    """The port's ``ModelConfig`` for a configuration file's keys."""
    from repro_torch.configs.base import ModelConfig
    port_kw = dict(cfg.get("port", {}))
    family = port_kw.pop("family")
    dtype = getattr(torch, port_kw.pop("dtype", "bfloat16"))
    for key in ("residual_multiplier", "logits_scaling"):
        if cfg.get(key, 1.0) != 1.0:
            raise ValueError(f"{cfg['name']}: the port has no {key}")
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    kw = dict(
        name=cfg["name"], family=family, n_layers=cfg["num_hidden_layers"],
        d_model=d, n_heads=h, n_kv_heads=cfg["num_key_value_heads"],
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        rope_theta=float(cfg["rope_theta"]),
        tie_embeddings=bool(cfg["tie_word_embeddings"]),
        norm_eps=float(cfg["rms_norm_eps"]), dtype=dtype,
        embed_scale=float(cfg.get("embedding_multiplier", 1.0)),
        source=cfg["source"], **port_kw)
    scale = cfg.get("attention_multiplier")
    if scale is not None and abs(scale - (d // h) ** -0.5) > 1e-12:
        kw["query_scale"] = float(scale)
    if cfg.get("num_local_experts"):
        kw.update(n_experts=cfg["num_local_experts"],
                  n_experts_active=cfg["num_experts_per_tok"])
    return ModelConfig(**kw)


def quantize(cfg, raw_flat, device):
    """The port's block-wise MSB of the raw weights (its exact DP, solved
    on ``device``): a nested tree with ``QTensor`` leaves."""
    from repro_torch.core.policy import QuantPolicy, quantize_params
    from .weights import nest
    q = cfg["quant"]
    tree, _ = quantize_params(
        nest(raw_flat), QuantPolicy(bits=q["bits"], block=q["block"],
                                    solver=q["solver"]), device=device)
    return tree


def packed_leaves(params):
    """{path: (packed, scales, n, kblocked)} of every packed leaf of the
    program's serving params."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}/{k}" if path else k)
        elif hasattr(node, "packed") and hasattr(node, "kblocked"):
            out[path] = (node.packed, node.scales, node.n, node.kblocked)

    walk(params, "")
    return out
