"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
        --shape train_4k --steps 100 [--smoke] [--device cpu] \
        [--ckpt-dir DIR] [--checkpoint-every N] [--lr LR]

Port of ``repro.launch.train`` on one device: ``--smoke`` takes the reduced
config and a batch of at most 8 x 64 tokens; data is the reference's
``MarkovStream`` (seed 0) through a ``Prefetcher``; AdamW with int8
moments above 100e9 params, f32 below; periodic checkpoints, auto-resume,
SIGTERM drain and straggler monitoring are on. Runs on the card unless
``--device cpu``. ``--mesh host`` is the one device; the production
meshes (``single``, ``multi``) are tensor/pipeline parallelism, ROADMAP
item 11.
"""
import argparse

import torch

from ..configs import SHAPES, get_config, smoke_config
from ..data import MarkovStream, Prefetcher
from ..device import resolve_device
from ..models import Model
from ..train import (AdamW, Checkpointer, OptConfig, PreemptionHandler,
                     StragglerMonitor, train_loop)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--mesh", default="host",
                    choices=["host", "single", "multi"])
    ap.add_argument("--ckpt-dir", default="/tmp/repro_train_ckpt")
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    if args.mesh != "host":
        raise NotImplementedError(
            f"--mesh {args.mesh}: production meshes are ROADMAP item 11")

    dev = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    shape = SHAPES[args.shape]
    model = Model(cfg)
    batch = min(shape.global_batch, 8) if args.smoke else shape.global_batch
    seq = min(shape.seq_len, 64) if args.smoke else shape.seq_len
    data = Prefetcher(iter(MarkovStream(cfg.vocab_size, seq, batch, seed=0)))

    opt = AdamW(OptConfig(
        lr=args.lr, total_steps=args.steps,
        moment_dtype="int8" if cfg.n_params() > 100e9 else "f32"))
    handler = PreemptionHandler()
    mon = StragglerMonitor()
    try:
        state, metrics = train_loop(
            model, opt, data, steps=args.steps,
            generator=torch.Generator(device=dev).manual_seed(0),
            device=dev, checkpointer=Checkpointer(args.ckpt_dir),
            checkpoint_every=args.checkpoint_every,
            straggler_monitor=mon, should_stop=handler.should_stop)
    finally:
        data.close()
        handler.restore()
    print(f"[launch.train] done; final loss {float(metrics['loss']):.4f}, "
          f"median step {mon.median * 1e3:.1f} ms")
    return state, metrics


if __name__ == "__main__":
    main()
