"""A cell cut to a size the CPU runs in a second: the same drivers, the
port's plain kernel versions, every width shrunk (2 layers, d 64, 4
heads of 16, 2 KV heads, vocab 503; MoE: 8 experts, top-2, dropless),
f32."""
from __future__ import annotations

import copy
import time

from cardbench import manifest, run

SEED = 2 ** 33 + 17


def shrink(cfg, traffic):
    cfg = copy.deepcopy(cfg)
    cfg.update(hidden_size=64, intermediate_size=128, num_attention_heads=4,
               num_key_value_heads=2, num_hidden_layers=2, vocab_size=503)
    cfg["port"] = dict(cfg["port"], vocab_round=64, dtype="float32")
    if "attention_multiplier" in cfg:
        cfg["attention_multiplier"] = 16 ** -0.5
    if "num_local_experts" in cfg:
        cfg.update(num_local_experts=8, num_experts_per_tok=2)
        # dropless, as the cell: 8 experts pad to 16, 16 / top-2 slots
        cfg["port"] = dict(cfg["port"], capacity_factor=8.0)
    cfg["engine"] = dict(cfg["engine"], page_size=4, prefill_chunk=16)
    tr = dict(traffic)
    if tr["driver"] == "closed_loop":
        tr.update(sessions=4, pool=16, max_context=80, check_requests=3,
                  prompt=dict(median=12, sigma=0.5, min=4, max=40),
                  output=dict(median=10, sigma=0.5, min=2, max=30))
    else:
        tr.update(batch=2, seq=33, pool=2, check_batches=2)
    return cfg, tr


def resolved(workload):
    """A cell of BENCHMARK.json, shrunk."""
    res = manifest.resolve(workload)
    res["config"], res["traffic"] = shrink(res["config"], res["traffic"])
    return res


def run_smoke(res, seconds=0.4, trace=0, control=False, seed=SEED):
    return run.run_cell(res["cell"]["name"], seed, seconds, trace,
                        device="cpu", control=control,
                        t_start=time.monotonic(), resolved=res)
