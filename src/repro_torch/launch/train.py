"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
        --shape train_4k --steps 100 [--smoke] [--device cpu] \
        [--mesh host|single|multi] [--ckpt-dir DIR] \
        [--checkpoint-every N] [--lr LR]

Port of ``repro.launch.train``: ``--smoke`` takes the reduced config and a
batch of at most 8 x 64 tokens; data is the reference's ``MarkovStream``
(seed 0) through a ``Prefetcher``; AdamW with int8 moments above 100e9
params, f32 below; periodic checkpoints, auto-resume, SIGTERM drain and
straggler monitoring are on. The step runs GSPMD-style on a process mesh
(``launch.mesh``): ``--mesh host`` the reference's host mesh over every
card (one card trains on it alone, without a mesh; with ``--device cpu``,
``CPU_RANKS`` ranks on the CPU), ``single`` / ``multi`` the production
meshes, which need 256 / 512 cards and refuse with fewer. Runs on the
cards unless ``--device cpu``.
"""
import argparse

import torch

from ..configs import SHAPES, get_config, smoke_config
from ..data import MarkovStream, Prefetcher
from ..device import resolve_device
from ..models import Model
from ..parallel import from_mesh, gather
from ..train import (AdamW, Checkpointer, OptConfig, PreemptionHandler,
                     StragglerMonitor, train_loop)
from .mesh import make_host_mesh, make_production_mesh

CPU_RANKS = 2     # ranks of the host mesh under --device cpu


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

    dev = resolve_device(args.device)
    mesh = None
    if args.mesh == "host":
        if dev.type == "cpu":
            mesh = make_host_mesh(devices=["cpu"] * CPU_RANKS)
        elif torch.cuda.device_count() > 1:
            mesh = make_host_mesh()
    else:
        mesh = make_production_mesh(multi_pod=args.mesh == "multi")
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    shape = SHAPES[args.shape]
    model = Model(cfg)
    batch = min(shape.global_batch, 8) if args.smoke else shape.global_batch
    seq = min(shape.seq_len, 64) if args.smoke else shape.seq_len
    data = Prefetcher(iter(MarkovStream(cfg.vocab_size, seq, batch, seed=0)))

    opt = AdamW(OptConfig(
        lr=args.lr, total_steps=args.steps,
        moment_dtype="int8" if cfg.n_params() > 100e9 else "f32"))
    # a mesh's state is made on the host and placed on its ranks
    gen_dev = dev if mesh is None else "cpu"
    handler = PreemptionHandler()
    mon = StragglerMonitor()
    try:
        state, metrics = train_loop(
            model, opt, data, steps=args.steps,
            generator=torch.Generator(device=gen_dev).manual_seed(0),
            device=dev, parallel=None if mesh is None else from_mesh(mesh),
            checkpointer=Checkpointer(args.ckpt_dir),
            checkpoint_every=args.checkpoint_every,
            straggler_monitor=mon, should_stop=handler.should_stop)
        if mesh is not None:
            state = gather(state)
    finally:
        data.close()
        handler.restore()
        if mesh is not None:
            mesh.close()
    print(f"[launch.train] done; final loss {float(metrics['loss']):.4f}, "
          f"median step {mon.median * 1e3:.1f} ms")
    return state, metrics


if __name__ == "__main__":
    main()
