"""Warm-up: capture every reachable dispatch shape at load time.

Port of ``repro.serve.warmup``. The engine's data plane is a finite set of
dispatch shapes, fully determined by its config (DESIGN.md Sec. 16):

  * packed prefill — one per bucket in ``prefill_buckets`` (or the single
    ``(1, prefill_chunk)`` chunk when packing is off)
  * decode — one per power-of-two batch bucket up to ``max_batch``,
    through the fused horizon when ``decode_horizon > 1`` and the plain
    step otherwise

``enumerate_traces`` lists that set; ``warm_engine`` runs one **all-pad
dummy dispatch** per entry through the engine's dispatch set
(``serve/graphs.py``), which on the card captures the entry as a CUDA graph
(the port of the reference's jit compile) and replays it; on a
tensor-parallel mesh it runs the entry once on every rank, eagerly. Dummy inputs
carry ``q_pos = -1`` / ``seg_ids = -1`` / ``slots = -1`` / ``kv_lens = 0``
with the scratch block table, so every KV write lands on the reserved
scratch page (and hot row 0 of the quantized pools) and the dispatch is
semantically a no-op.

After ``warm_engine`` returns, a serving run that stays inside the
config's shape envelope captures nothing — the property the probe
(``graphs.jit_trace_count``) lets tests and the
``msb_traces_compiled_total`` metric assert. The overload brownout ladder
(``serve.overload``) preserves this: its horizon cap is a dynamic clamp on
the per-sequence budget and its wave cap only selects a smaller, already
captured bucket.
"""
from __future__ import annotations

import time
from typing import Dict, List, Tuple

from .graphs import jit_trace_count, pad_inputs


def enumerate_traces(engine) -> List[Tuple[str, int]]:
    """The reachable (kind, size) dispatch set for ``engine``'s config.

    Kinds: ``prefill_packed`` (size = bucket token length), ``prefill``
    (size = prefill_chunk; only reachable with packing off), ``decode`` /
    ``decode_horizon`` (size = batch bucket).
    """
    entries: List[Tuple[str, int]] = []
    if engine.prefill_buckets:
        entries += [("prefill_packed", b) for b in engine.prefill_buckets]
    else:
        entries.append(("prefill", engine.prefill_chunk))
    kind = "decode_horizon" if engine.decode_horizon > 1 else "decode"
    b = 1
    while True:
        entries.append((kind, b))
        if b >= engine.max_batch:
            break
        b *= 2
    return entries


def _warm_one(engine, kind: str, size: int):
    """One all-pad dummy dispatch of the given shape; blocks on its outputs
    so the capture is paid here, not on the first request."""
    slots, inputs = pad_inputs(kind, size, engine.max_batch)
    for out in engine.graphs.run(kind, size, inputs,
                                 engine.cache.table_rows(slots)):
        out.cpu()


def warm_engine(engine) -> Dict[str, object]:
    """Warm every reachable dispatch of ``engine``; returns a report dict:
    ``seconds`` (wall time), ``entries`` (shapes warmed), ``traces`` (probe
    delta: captures; 0 when every entry was already captured), ``shapes``
    (the enumerated list), and, of the dispatch set, ``capture_seconds`` and
    ``instantiate_seconds`` (summed over the engine's captures so far),
    ``graph_bytes`` (its graph pool; ``None`` on the CPU), ``graphs`` (the
    CUDA graphs it holds) and ``eager`` (why dispatches run eagerly — on
    the CPU, or a tensor-parallel mesh, whose collectives a graph cannot
    hold — or None)."""
    t0 = time.monotonic()
    n0 = jit_trace_count()
    entries = enumerate_traces(engine)
    for kind, size in entries:
        _warm_one(engine, kind, size)
    graphs = engine.graphs
    return {"seconds": time.monotonic() - t0, "entries": len(entries),
            "traces": jit_trace_count() - n0, "shapes": entries,
            "capture_seconds": graphs.capture_seconds,
            "instantiate_seconds": graphs.instantiate_seconds,
            "graph_bytes": graphs.pool_bytes(), "graphs": graphs.n_graphs,
            "eager": graphs.eager_reason}
