"""Serving launcher: init (or restore) -> MSB-quantize-on-load -> static
serve.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \
        [--smoke] [--device cpu] [--bits 4] [--ckpt-dir DIR] \
        [--requests 4 --tokens 16]

Port of ``repro.launch.serve``: random params from a seed, or with
``--ckpt-dir`` the ``params`` of the latest checkpoint there (the
reference's format: one written by ``launch/train.py`` of either package),
then 4-bit block-64 exact-DP quantization (unless ``--no-quant``), and
``ServeEngine`` (packed execution) generating with temperature 0.8 from
random prompts. Runs on the card unless ``--device cpu``.
"""
import argparse

import numpy as np
import torch

from ..configs import get_config, smoke_config
from ..core import QuantPolicy, param_bits, quantize_params
from ..device import resolve_device
from ..models import Model
from ..serve import ServeEngine
from ..train import Checkpointer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--bits", type=int, default=4)
    ap.add_argument("--no-quant", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    if args.ckpt_dir:
        restored = Checkpointer(args.ckpt_dir).restore_latest(
            like={"params": params})
        if restored is not None:
            params = restored[0]["params"]
            print(f"[launch.serve] restored step {restored[1]}")
    if not args.no_quant:
        bits_before = param_bits(params)
        params, report = quantize_params(params, QuantPolicy(
            bits=args.bits, block=64, solver="dp", min_size=4096),
            device=dev)
        print(f"[launch.serve] MSB-{args.bits}b quantized {len(report)} "
              f"tensors: {bits_before / 8e6:.1f} -> "
              f"{param_bits(params) / 8e6:.1f} MB")

    engine = ServeEngine(model, params, max_seq=args.max_seq, device=dev)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (args.requests, 8))
    out = engine.generate(prompts, n_tokens=args.tokens, temperature=0.8)
    for i, row in enumerate(out):
        print(f"[launch.serve] request {i}: {row.tolist()}")


if __name__ == "__main__":
    main()
