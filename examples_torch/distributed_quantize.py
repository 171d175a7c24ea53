"""Distributed MSB quantization: mesh-sharded solver, zero communication.

    PYTHONPATH=src python examples_torch/distributed_quantize.py [--device cpu]

The PyTorch port of ``examples/distributed_quantize.py``; it runs on the
card unless ``--device cpu`` is given. Quantization is embarrassingly
parallel across 64-element blocks, so on a mesh each rank solves exactly
the blocks of its local weight shard. The mesh is the port's process
mesh (``launch.mesh.make_host_mesh``: one process a rank, every rank on
the card when there are fewer cards than ranks). Torch has no compiled
module to inspect for collectives, so each rank counts every call its
mesh groups (``parallel/sharding.py:GlooGroup``) receive while it solves,
by the collectives ``launch/dryrun.py:RecordingGroup`` records; the count
must be 0. This is how arctic-480b's ~7.3e9 blocks get quantized in one
pass across a cluster instead of weeks on a CPU (DESIGN.md Sec. 2).
"""
import argparse
import dataclasses
import time

import numpy as np
import torch

# the collectives of a mesh group (``sharding.GlooGroup``'s methods)
COLLECTIVES = ("all_gather", "psum", "pmax", "reduce_scatter", "all_to_all",
               "permute")


class CountingGroup:
    """A mesh group that counts each collective it is asked for in
    ``counts`` (by op) before passing it on to ``group``."""

    def __init__(self, group, counts):
        self.group, self.counts = group, counts

    def size(self):
        return self.group.size()

    def __getattr__(self, name):
        fn = getattr(self.group, name)
        if name not in COLLECTIVES:
            return fn

        def counted(*args, **kwargs):
            self.counts[name] = self.counts.get(name, 0) + 1
            return fn(*args, **kwargs)
        return counted


def rank_solve(ctx, w):
    """A rank's solve of its shard ``w`` (a CPU tensor) on its device,
    every one of its mesh groups counting the collectives it receives:
    (codes, scales, {op: calls}, solve seconds), on the CPU."""
    from repro_torch.core import quantize_blockwise

    counts = {}
    saved = ctx.tp, ctx.par
    if ctx.tp.group is not None:
        ctx.tp = dataclasses.replace(
            ctx.tp, group=CountingGroup(ctx.tp.group, counts))
    if ctx.par is not None and ctx.par.groups:
        ctx.par = dataclasses.replace(ctx.par, groups={
            k: CountingGroup(g, counts) for k, g in ctx.par.groups.items()})
    try:
        ws = w.to(ctx.device)
        _sync(ctx.device)
        t0 = time.perf_counter()
        q = quantize_blockwise(ws, bits=4, block=64, solver="dp")
        _sync(ctx.device)
        secs = time.perf_counter() - t0
    finally:
        ctx.tp, ctx.par = saved
    return q.codes.cpu(), q.scales.cpu(), counts, secs


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def shard(w, shape):
    """Row-major blocks of ``w`` over a (rows, cols) mesh, rank order."""
    r, c = shape
    bh, bw = w.shape[0] // r, w.shape[1] // c
    return [w[i * bh:(i + 1) * bh, j * bw:(j + 1) * bw].contiguous()
            for i in range(r) for j in range(c)]


def solve(mesh, w, shape):
    """Every rank's ``rank_solve`` of its block of ``w``, in rank order."""
    return mesh.gather(rank_solve,
                       per_rank=[(s,) for s in shard(torch.from_numpy(w),
                                                     shape)])


def rank_devices(device, n):
    """Card r for rank r where there are enough cards, else every rank on
    ``device`` (a card by its index)."""
    if device.type != "cuda":
        return [str(device)] * n
    if torch.cuda.device_count() >= n:
        return [f"cuda:{r}" for r in range(n)]
    index = torch.cuda.current_device() if device.index is None else \
        device.index
    return [f"cuda:{index}"] * n


def main(argv=None):
    from repro_torch.core import QTensor, dequantize, reconstruction_mse
    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import make_host_mesh

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mesh", type=int, nargs=2, default=(4, 2),
                    metavar=("DATA", "MODEL"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    shape = tuple(args.mesh)
    n = shape[0] * shape[1]

    rng = np.random.default_rng(0)
    w = rng.standard_t(4, size=(512, 1024)).astype(np.float32) * 0.02
    mesh = make_host_mesh(shape, ("data", "model"),
                          devices=rank_devices(dev, n))
    try:
        print(f"weight {w.shape} sharded over {dict(mesh.shape)}")
        solve(mesh, w, shape)                      # warm: builds, first use
        t0 = time.perf_counter()
        outs = solve(mesh, w, shape)
        t = time.perf_counter() - t0
    finally:
        mesh.close()

    colls = [(op, k) for _, _, counts, _ in outs for op, k in counts.items()]
    n_colls = sum(k for _, k in colls)
    print(f"quantized {w.size / 1e6:.2f}M weights in {t * 1e3:.0f} ms "
          f"across {n} ranks ({w.size / 64 / t:.0f} blocks/s; scales "
          "linearly with devices)")
    print(f"collectives in the solve: {n_colls} "
          f"({'NONE - embarrassingly parallel' if not colls else colls[:5]})")
    assert n_colls == 0, f"the solve called collectives: {colls}"
    print(f"codes sharding: {shape} blocks of {outs[0][0].shape}, "
          "rank-major")

    # verify: pair each shard's codes with its scales (shard-major order)
    g = outs[0][1].shape[-1]
    q = QTensor(torch.cat([c.reshape(-1, 64) for c, _, _, _ in outs]),
                torch.cat([s.reshape(-1, g) for _, s, _, _ in outs]),
                4, 64, torch.float32)
    w_sm = torch.cat([s.reshape(-1, 64)
                      for s in shard(torch.from_numpy(w), shape)])
    mse = float(reconstruction_mse(w_sm, dequantize(q)))
    print(f"reconstruction MSE: {mse:.4f} "
          f"(exact per-block optimum of the paper's objective)")
    return {"mesh": shape, "collectives": n_colls, "seconds": t,
            "blocks_per_s": w.size / 64 / t, "mse": mse, "weight": w,
            "codes": [c for c, _, _, _ in outs],
            "scales": [s for _, s, _, _ in outs],
            "rank_seconds": [s for _, _, _, s in outs]}


if __name__ == "__main__":
    main()
