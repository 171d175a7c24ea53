"""End-to-end driver: train an LM -> MSB-quantize -> serve batched requests.

    PYTHONPATH=src python examples_torch/train_quantize_serve.py --device cpu
    PYTHONPATH=src python examples_torch/train_quantize_serve.py \
        --preset 100m --steps 300

The PyTorch port of ``examples/train_quantize_serve.py``; it runs on the
card unless ``--device cpu`` is given. The default preset trains a small
Markov-chain LM; the ``100m`` preset is the reference's configuration for
real hardware (qwen-style, 12 layers, d=768, 12 heads of 64, vocab 32000,
tied, B=32 x 1024; computed in bf16 on f32 params). Fault tolerance is
live: the run checkpoints every 25 steps, auto-resumes if re-launched on
the same ``--ckpt-dir``, and drains cleanly on SIGTERM/SIGINT
(``PreemptionHandler``).
"""
import argparse
import dataclasses
import functools
import math
import os
import tempfile
import time

import numpy as np
import torch


def build_model(preset):
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models import Model

    if preset == "tiny":
        cfg = smoke_config("qwen1.5-0.5b")
        cfg = dataclasses.replace(cfg, vocab_size=128, vocab_round=128,
                                  d_model=128, n_layers=2)
        batch, seq = 8, 64
    elif preset == "100m":
        cfg = dataclasses.replace(
            get_config("qwen1.5-0.5b"), n_layers=12, d_model=768, n_heads=12,
            n_kv_heads=12, d_ff=2048, vocab_size=32000, head_dim=64)
        batch, seq = 32, 1024
    else:
        raise SystemExit(f"unknown preset {preset}")
    return Model(cfg), batch, seq


@functools.lru_cache(maxsize=1)
def make_data(vocab, seq, batch, device):
    """``MarkovStream(seed=7)`` and its entropy, built once a process: the
    chain is a pure function of its seed, and a 32000-token vocab's tables
    take tens of seconds to draw."""
    from repro_torch.data import MarkovStream

    data = MarkovStream(vocab, seq, batch, seed=7)
    return data, chain_entropy(data, device)


def chain_entropy(data, device):
    """Per-token entropy of the chain (nats), the loss floor: the
    reference's ``MarkovStream.entropy()`` (row 0 of the transition
    matrix to the 64th power, the stationary distribution, against each
    row's entropy), with the power taken as 64 vector products in f64 on
    ``device``: squaring a 32000 x 32000 matrix six times is hours on a
    host."""
    trans = torch.from_numpy(data.trans).to(device)
    stat = torch.zeros(trans.shape[0], dtype=torch.float64, device=device)
    stat[0] = 1.0
    for _ in range(64):
        stat = stat @ trans
    h_rows = torch.cat([-(t * torch.log(t + 1e-12)).sum(dim=1)
                        for t in trans.split(4096)])     # rows in blocks
    return float((stat * h_rows).sum())


def train(model, data, steps, ckpt_dir, device, state=None, generator=None):
    """``steps`` steps of AdamW (lr 3e-3, 10 warm-up steps) from ``state``
    (None: from ``generator``), checkpointing every 25 into ``ckpt_dir``
    (resuming from its latest step); returns (state, report)."""
    from repro_torch.data import Prefetcher
    from repro_torch.train import (AdamW, Checkpointer, OptConfig,
                                   PreemptionHandler, StragglerMonitor,
                                   train_loop)

    opt = AdamW(OptConfig(lr=3e-3, warmup_steps=10, total_steps=steps))
    ck = Checkpointer(ckpt_dir, keep=2)
    resumed = ck.steps()[-1] if ck.steps() else None
    handler = PreemptionHandler()
    mon = StragglerMonitor()
    losses, gnorms = {}, {}

    def on_step(step, metrics):
        losses[step] = float(metrics["loss"])
        gnorms[step] = float(metrics["grad_norm"])

    prefetch = Prefetcher(iter(data))
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    try:
        state, _ = train_loop(
            model, opt, prefetch, steps=steps, state=state,
            generator=generator, device=device, checkpointer=ck,
            checkpoint_every=25, straggler_monitor=mon,
            should_stop=handler.should_stop, log_every=10, on_step=on_step)
        ck.wait()
    finally:
        prefetch.close()
        handler.restore()
    print(f"[e2e] trained; median step {mon.median * 1e3:.1f} ms; "
          f"stragglers flagged: {len(mon.flagged)}")
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)
    return state, {"resumed_from": resumed, "losses": losses,
                   "grad_norms": gnorms, "median_step_s": mon.median,
                   "peak_bytes": peak}


def policy():
    """The reference program's policy (4-bit, block 64, exact DP, leaves
    of 4096 elements and more), with qwen's q/k/v biases excluded by name
    as well. The reference's ``exclude`` names ``bias``, but these leaves
    are ``bq``/``bk``/``bv``: stacked over 12 layers of d=768 they are
    2-D and 9216 elements, so the reference quantizes them, and its
    ``dense`` cannot add a ``QTensor`` bias (ROADMAP §3)."""
    from repro_torch.core import QuantPolicy
    base = QuantPolicy(bits=4, block=64, solver="dp", min_size=4096)
    return dataclasses.replace(base, exclude=base.exclude + r"|.*/b[qkv]$")


def quantize(params, device):
    from repro_torch.core import param_bits, quantize_params

    bits_fp = param_bits(params)
    qparams, report = quantize_params(params, policy(), device=device)
    print(f"[e2e] MSB-quantized {len(report)} tensors: "
          f"{bits_fp / 8e6:.1f} MB -> {param_bits(qparams) / 8e6:.1f} MB")
    return qparams


def held_out_nll(model, params, batch, device):
    """``Model.loss`` of ``batch`` (numpy arrays) under ``params``."""
    with torch.no_grad():
        loss, _ = model.loss(params, {k: torch.as_tensor(v, device=device)
                                      for k, v in batch.items()})
    return float(loss)


def serve(model, qparams, prompts, max_seq, device):
    """16 tokens at temperature 0.7 for each prompt, from ``qparams``."""
    from repro_torch.serve import ServeEngine

    engine = ServeEngine(model, qparams, max_seq=max_seq, device=device)
    return engine.generate(prompts, n_tokens=16, temperature=0.7,
                           generator=torch.Generator(
                               device=device).manual_seed(0))


def main(argv=None):
    from repro_torch.device import resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="tiny", choices=["tiny", "100m"])
    ap.add_argument("--steps", type=int, default=80)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                      "msb_e2e_ckpt"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    model, batch, seq = build_model(args.preset)
    cfg = model.cfg
    t0 = time.perf_counter()
    data, floor = make_data(cfg.vocab_size, seq, batch, dev)
    print(f"[e2e] {args.preset}: {cfg.n_layers}L d={cfg.d_model} "
          f"vocab={cfg.vocab_size}; chain entropy "
          f"{floor:.3f} nats (loss floor; chain built in "
          f"{time.perf_counter() - t0:.1f} s)")

    state, report = train(model, data, args.steps, args.ckpt_dir, dev,
                          generator=torch.Generator(device=dev).manual_seed(0))
    params = state["params"]
    qparams = quantize(params, dev)

    eval_batch = data.batch(10_000)
    nll_fp = held_out_nll(model, params, eval_batch, dev)
    nll_q = held_out_nll(model, qparams, eval_batch, dev)
    print(f"[e2e] held-out NLL: fp {nll_fp:.4f} | msb-4bit {nll_q:.4f} "
          f"(floor {floor:.4f})")

    prompts = np.stack([data.batch(20_000)["tokens"][0][:16]] * 4)
    out = serve(model, qparams, prompts, seq + 32, dev)
    print(f"[e2e] served {out.shape[0]} requests x {out.shape[1]} tokens "
          f"from the 4-bit model: {np.asarray(out[0])[:8]}...")
    median = report["median_step_s"]
    return dict(report, preset=args.preset, steps=args.steps,
                steps_run=len(report["losses"]), floor=floor,
                ln_vocab=math.log(cfg.vocab_size), nll_fp=nll_fp,
                nll_q=nll_q, tokens=np.asarray(out),
                tokens_per_s=batch * seq / median if median else None,
                n_layers=cfg.n_layers)


if __name__ == "__main__":
    main()
