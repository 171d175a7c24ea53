"""A closed loop of sessions over ``ContinuousEngine``.

Each session keeps one request in flight: when its answer finishes, it
submits the next request of the seed's order through the pool of sizes
(``traffic_gen``). Set-up builds the kernels, draws the weights, runs the
port's quantization, builds the engine (``max_batch`` = sessions, a page
pool that holds every session's longest context, so nothing is
preempted), captures the engine's dispatch shapes (``warmup()``) and
ramps: every session submits its first request (``traffic_gen.ramp``:
drawn in proportion to answer length and cut to a fraction of it, as a
steady state finds its sessions), each finished answer is followed by
its session's next request, and the window opens once as many requests
have finished as there are sessions: the first prompts' burst of
prefill has been worked off and the loop runs as it will in the
window.

The window steps the engine (``step()``, then ``stream_updates()``),
timing each step on the host clock; every step ends with the host
reading its tokens back, so it is synchronous with the card. End-to-end:
``output_tok_s`` (tokens delivered in the window / its seconds),
``ttft_p95_ms`` (submit to the return of the step that delivered the
first token, over requests submitted in the window; one still waiting
at the close counts its wait so far) and ``tpot_p95_ms`` ((last token -
first token) / (tokens - 1), over requests finished in the window).

The check, once the window has closed and the peak memory is read: the
program's packed weights against the reference's own quantization of the
raw weights (bytes of codes and codebook entries that differ; limit 0),
then a sample of finished requests drawn from the seed, the longest
among them: the reference runs over each prompt with its served tokens,
and the widest gap by which a served token's logit lies below the
reference's best is held to the cell's limit.
"""
from __future__ import annotations

import time

import numpy as np

from .. import common, program, traffic_gen
from ..reference import check as ref_check
from ..reference import model as ref_model


def _engine(ctx, setup):
    cfg, tr = ctx.config, ctx.traffic
    kw = dict(cfg["engine"])
    kw.update(ctx.data.get("engine", {}))
    s, ps, ctx_max = tr["sessions"], kw["page_size"], tr["max_context"]
    from repro_torch.serve import ContinuousEngine
    return ContinuousEngine(
        setup.model, setup.qtree, max_batch=s, page_size=ps,
        num_pages=s * (-(-ctx_max // ps)) + 1, max_seq=ctx_max,
        prefill_chunk=kw["prefill_chunk"],
        decode_horizon=kw["decode_horizon"], kv_bits=kw["kv_bits"],
        prefix_cache=kw["prefix_cache"], device=ctx.device)


class Loop:
    """The sessions' requests and their timestamps."""

    def __init__(self, ctx, engine):
        self.ctx, self.engine = ctx, engine
        tr = ctx.traffic
        self.prompt_len, self.out_len = traffic_gen.size_pool(tr)
        self.order = traffic_gen.order(tr)
        self.vocab = ctx.config["vocab_size"]
        self.next_index = self.submitted = 0
        self.req = {}        # rid -> dict(prompt, n, t_sub, t_first, ...)
        self.live = {}       # rid -> the engine's Sequence
        self.attempted = self.failed = 0

    def submit(self, now, k=None, fraction=None):
        """Submit pool entry ``k`` (the next in the offered order when
        None), its answer cut to ``fraction`` of its length if given."""
        i = self.submitted
        self.submitted += 1
        if k is None:
            k = self.order[self.next_index % len(self.order)]
            self.next_index += 1
        k = int(k)
        n_out = int(self.out_len[k])
        if fraction is not None:
            n_out = max(1, int(round(n_out * fraction)))
        prompt = traffic_gen.tokens(self.ctx.seed, i, self.prompt_len[k],
                                    self.vocab)
        try:
            rid = self.engine.submit(prompt, n_out)
        except ValueError:
            self.failed += 1
            return None
        self.req[rid] = dict(prompt=prompt, n=n_out, t_sub=now, t_first=None,
                             t_last=None, toks=[], t_done=None)
        self.live[rid] = self.engine._seqs[rid]
        return rid

    def positions(self):
        return {rid: seq.cache_len for rid, seq in self.live.items()}

    def drain(self, now):
        """Apply ``stream_updates()``; returns (tokens, finished rids)."""
        n, done = 0, []
        for rid, (toks, fin) in self.engine.stream_updates().items():
            r = self.req[rid]
            if toks:
                if r["t_first"] is None:
                    r["t_first"] = now
                r["t_last"] = now
                r["toks"].extend(toks)
                n += len(toks)
            if fin:
                r["t_done"] = now
                self.live.pop(rid, None)
                done.append(rid)
        return n, done


def _rows(before, after):
    """(c0, c1) position ranges the step computed, per row."""
    return [(before[rid], c1) for rid, c1 in after.items()
            if rid in before and c1 > before[rid]]


def run(ctx):
    torch, dev, tr = ctx.torch, ctx.device, ctx.traffic
    setup = common.Setup(ctx)
    engine = _engine(ctx, setup)
    setup.qtree = None
    warm = engine.warmup()
    trace = common.Slice(ctx, start=0.4 * ctx.seconds,
                         length=min(3.0, 0.25 * ctx.seconds))
    loop = Loop(ctx, engine)
    s = tr["sessions"]
    t = time.perf_counter()
    for k, fraction in zip(*traffic_gen.ramp(tr)):
        loop.submit(t, k=k, fraction=float(fraction))
    finished = 0
    while finished < s:
        engine.step()
        now = time.perf_counter()
        _, done = loop.drain(now)
        finished += len(done)
        for _ in done:
            loop.submit(now)
    from repro_torch.serve.graphs import jit_trace_count
    work0, captures0 = engine.stats()["work_positions"], jit_trace_count()
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
    t_open = time.perf_counter()
    setup_s = time.monotonic() - ctx.t_start
    steps, tokens_in_window, useful = [], 0, 0
    while True:
        traced = trace.tick(lambda: time.perf_counter() - t_open)
        before = loop.positions()
        t0 = time.perf_counter()
        with trace.span("bench.step"):
            engine.step()
        t1 = time.perf_counter()
        kind = engine.last_step_kind
        rows = _rows(before, loop.positions())
        with trace.span("bench.drain"):
            n, done = loop.drain(t1)
        with trace.span("bench.submit"):
            for _ in done:
                loop.submit(time.perf_counter())
        tokens_in_window += n
        useful += sum(c1 - c0 for c0, c1 in rows)
        steps.append(dict(kind=kind, dt=t1 - t0, rows=rows, traced=traced))
        if t1 - t_open >= ctx.seconds:
            t_close = t1
            break
    summary = trace.close()
    window_s = t_close - t_open
    work = engine.stats()["work_positions"] - work0
    captures = jit_trace_count() - captures0
    peak = common.memory_peak(torch, dev)

    ttft, tpot, halves = [], [], ([], [])
    half = t_open + 0.5 * window_s
    for r in loop.req.values():
        if r["t_sub"] >= t_open:
            loop.attempted += 1
            first = r["t_first"] if r["t_first"] is not None else t_close
            ttft.append(first - r["t_sub"])
            halves[r["t_sub"] >= half].append(first - r["t_sub"])
        if r["t_done"] is not None and r["t_done"] >= t_open and \
                len(r["toks"]) >= 2:
            tpot.append((r["t_last"] - r["t_first"]) / (len(r["toks"]) - 1))
    metrics = {"output_tok_s": tokens_in_window / window_s,
               "ttft_p95_ms": 1e3 * common.p95(ttft),
               "tpot_p95_ms": 1e3 * common.p95(tpot),
               "setup_s": setup_s}

    # the check: the window has closed and the peak is read
    finished = [rid for rid, r in loop.req.items()
                if r["t_done"] is not None and r["t_done"] >= t_open]
    sample = _sample(loop, finished, ctx)
    prog_leaves = program.packed_leaves(engine.params)
    engine.close(check=False)
    del engine, loop.engine
    common.free(torch, dev)
    t_ref = time.monotonic()
    mism, missing, W = ref_check.quantize_and_compare(
        setup.raw, prog_leaves, ctx.config["quant"]["bits"],
        ctx.config["quant"]["block"])
    del prog_leaves
    setup.raw = None
    common.free(torch, dev)
    gap, cgap = 0.0, 0.0
    for rid in sample:
        r = loop.req[rid]
        g, c = ref_model.widest_gap(
            W, ctx.config, torch.as_tensor(r["prompt"], device=dev),
            torch.as_tensor(np.asarray(r["toks"], np.int32), device=dev),
            control=ctx.control)
        gap = max(gap, g)
        if c is not None:
            cgap = max(cgap, c)
    ref_s = time.monotonic() - t_ref
    lim = ctx.data["limits"]
    checks = [dict(name="codes_mismatch", value=mism + missing, limit=0),
              dict(name="logit_gap", value=gap, limit=lim["logit_gap"])]
    served = sum(len(loop.req[rid]["toks"]) for rid in sample)
    record = dict(kind="serve", config=ctx.config, summary=summary,
                  vocab_padded=setup.vocab_padded, steps=steps,
                  useful_positions=useful, work_positions=work)
    notes = dict(build_s=setup.build_s, weights_s=setup.weights_s,
                 quantize_s=setup.quantize_s, warmup_s=warm["seconds"],
                 graphs=warm.get("graphs"), captures_in_window=captures,
                 window_s=window_s,
                 steps=len(steps), requests_finished=len(finished),
                 ttft_n=len(ttft), tpot_n=len(tpot),
                 ttft_p95_ms_halves=[1e3 * common.p95(h or [0.0])
                                     for h in halves],
                 checked_requests=len(sample), checked_tokens=served,
                 reference_s=ref_s)
    if summary is not None:
        notes["traced_steps"] = sum(st["traced"] for st in steps)
        notes["step_spans"] = len(summary["by_step"])
        notes["device_s_outside_steps"] = summary["outside_steps_s"]
    if ctx.control:
        notes["control_logit_gap"] = cgap
    return dict(metrics=metrics, attempted=loop.attempted,
                failed=loop.failed, checks=checks, record=record,
                memory_peak=peak, window_s=window_s, notes=notes)


def _sample(loop, finished, ctx):
    """The requests the check reads: the longest finished one and others
    drawn from the seed."""
    if not finished:
        return []
    size = {rid: len(loop.req[rid]["prompt"]) + len(loop.req[rid]["toks"])
            for rid in finished}
    longest = max(finished, key=lambda rid: (size[rid], rid))
    rest = sorted(rid for rid in finished if rid != longest)
    rng = np.random.default_rng([int(ctx.seed) % (1 << 63), 3])
    k = min(len(rest), ctx.traffic["check_requests"] - 1)
    pick = rng.choice(len(rest), size=k, replace=False) if k else []
    return [longest] + [rest[i] for i in sorted(pick)]
