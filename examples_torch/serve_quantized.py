"""Serve a model with MSB 4-bit weights and compare against full precision.

    PYTHONPATH=src python examples_torch/serve_quantized.py [--device cpu]

The PyTorch port of ``examples/serve_quantized.py``; it runs on the card
unless ``--device cpu`` is given. It inits and briefly trains a small LM
(the smoke gemma2: sliding window and softcaps live), quantizes it on load
with the framework policy, and serves the same batched requests from the
fp and the 4-bit ``ServeEngine``, reporting agreement and the compression.
The same 4-bit model then serves a staggered request stream through the
continuous-batching engine (paged KV cache, chunked prefill; DESIGN.md
Sec. 8) with ``execution="packed"``: weights rewritten once at load into
the kernel storage layout (two 4-bit codes per byte; DESIGN.md Sec. 9)
that kernel A reads. Its greedy tokens must be the static engine's. On
the CPU both engines run the plain versions and the tokens are identical;
on the card the static prefill runs kernel D and the continuous engine
kernel B, which round differently, so a divergence is allowed only at a
near tie: the top-2 logit gap at the first divergent token below 1e-2.
"""
import argparse
import dataclasses

import numpy as np
import torch

NEAR_TIE = 1e-2       # top-2 logit gap below which two argmaxes may differ


def build_model():
    from repro_torch.configs import smoke_config
    from repro_torch.models import Model

    cfg = smoke_config("gemma2-2b")   # sliding-window + softcap features live
    cfg = dataclasses.replace(cfg, vocab_size=128, vocab_round=128,
                              d_model=128)
    return Model(cfg)


def make_data():
    from repro_torch.data import MarkovStream
    return MarkovStream(128, 48, 8, seed=11)


def train(model, data, device, state=None):
    """50 AdamW steps (lr 3e-3, 5 warm-up steps) from ``state`` (None:
    seed 0 on ``device``); returns the params."""
    from repro_torch.train import AdamW, OptConfig, train_loop

    opt = AdamW(OptConfig(lr=3e-3, warmup_steps=5, total_steps=60))
    state, _ = train_loop(model, opt, iter(data), steps=50, state=state,
                          generator=torch.Generator(
                              device=device).manual_seed(0),
                          device=device, log_every=25)
    return state["params"]


def quantize(params, device):
    from repro_torch.core import QuantPolicy, param_bits, quantize_params

    qparams, report = quantize_params(
        params, QuantPolicy(bits=4, block=64, solver="dp", min_size=2048),
        device=device)
    print(f"[serve] quantized {len(report)} tensors; "
          f"{param_bits(params) / 8e6:.2f} MB -> "
          f"{param_bits(qparams) / 8e6:.2f} MB")
    return qparams


def static_serve(model, params, qparams, data, device):
    """fp against 4-bit ``ServeEngine``: greedy agreement and held-out
    NLL. Returns (report, the 4-bit engine, prompts)."""
    from repro_torch.serve import ServeEngine

    prompts = data.batch(999)["tokens"][:4, :12]
    eng_fp = ServeEngine(model, params, max_seq=96, device=device)
    eng_q = ServeEngine(model, qparams, max_seq=96, device=device)
    out_fp = np.asarray(eng_fp.generate(prompts, n_tokens=24))
    out_q = np.asarray(eng_q.generate(prompts, n_tokens=24))
    agree = (out_fp == out_q).mean()
    print(f"[serve] greedy-token agreement fp vs msb-4bit: {agree:.1%}")
    toks = data.batch(1234)["tokens"]
    nll_fp, nll_q = eng_fp.score(toks), eng_q.score(toks)
    print(f"[serve] held-out NLL: fp {nll_fp:.4f} | "
          f"4-bit {nll_q:.4f} | floor {data.entropy():.4f}")
    return ({"agreement": float(agree), "nll_fp": float(nll_fp),
             "nll_q": float(nll_q), "static_tokens": out_q}, eng_q, prompts)


def continuous_serve(model, qparams, prompts, device, arrivals=(0, 2, 4, 6)):
    """The prompts through ``ContinuousEngine`` (packed, page size 8),
    request i submitted at step ``arrivals[i]``; returns (tokens by
    request, engine)."""
    from repro_torch.serve import ContinuousEngine

    ce = ContinuousEngine(model, qparams, max_batch=4, page_size=8,
                          num_pages=64, max_seq=40, prefill_chunk=8,
                          execution="packed", device=device)
    done, i, t = {}, 0, 0
    while i < len(arrivals) or ce.scheduler.has_work:
        while i < len(arrivals) and arrivals[i] <= t:
            ce.submit(np.asarray(prompts[i]), 24)
            i += 1
        ce.step()
        done.update(ce.collect())
        t += 1
    ce.close()
    return done, ce


def top2_gap(model, params, tokens, device):
    """The top-2 gap of the next-token logits after ``tokens`` (one static
    prefill)."""
    tok = torch.as_tensor(np.asarray(tokens)[None], dtype=torch.int32,
                          device=device)
    with torch.no_grad():
        logits, _ = model.prefill(params, {"tokens": tok})
    top = logits[0].float().topk(2).values
    return float(top[0] - top[1])


def divergences(model, params, prompts, static, continuous, device):
    """[(request, first divergent step, top-2 gap there)] of the
    continuous engine's tokens against the static engine's."""
    out = []
    for i, row in enumerate(static):
        if np.array_equal(continuous[i], row):
            continue
        j = int(np.argmax(continuous[i] != row))
        ctx = np.concatenate([np.asarray(prompts[i]), row[:j]])
        out.append((i, j, top2_gap(model, params, ctx, device)))
    return out


def main(argv=None):
    from repro_torch.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    model = build_model()
    data = make_data()
    params = train(model, data, dev)
    qparams = quantize(params, dev)
    report, eng_q, prompts = static_serve(model, params, qparams, data, dev)
    out_q = report["static_tokens"]

    # continuous batching: the same 4 requests arrive staggered; outputs
    # must match the static engine's greedy tokens row for row
    done, ce = continuous_serve(model, qparams, prompts, dev)
    match = all((done[i] == out_q[i]).all() for i in range(4))
    print(f"[serve] continuous-batching vs static (4-bit, staggered "
          f"arrivals): token-identical={match} "
          f"steps={ce.n_steps} preemptions={ce.scheduler.n_preemptions}")
    div = divergences(model, eng_q.params, prompts, out_q, done, dev)
    for i, j, gap in div:
        print(f"[serve] request {i} diverges at token {j}: top-2 logit gap "
              f"{gap:.3g} (near tie below {NEAR_TIE})")
        assert gap < NEAR_TIE, (
            f"request {i} diverges at token {j} with top-2 gap {gap}")
    return dict(report, continuous_tokens=done, token_identical=match,
                divergences=div, steps=ce.n_steps,
                preemptions=ce.scheduler.n_preemptions)


if __name__ == "__main__":
    main()
