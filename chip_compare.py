"""Kernel and static-prefill times of one copy of the port, for same-call
comparisons of two trees on one NVIDIA H100.

    python3 chip_compare.py --src _local/parent/src --tag parent
    python3 chip_compare.py --src src --tag change

Runs this tree's ``chip_smoke.py`` phases 3 and 4 (kernel A at decode,
packed-prefill and M=4096 shapes and the f32 unembedding; kernel B at the
decode shape and a 512-token packed-prefill wave; each against its plain
version, kernel and library yardsticks as medians of 20 cold launches) on
the ``repro_torch`` package under ``--src``, then internlm2-1.8b at full
width (random weights from seed 0, 4-bit DP quantization on the card):
four timed ``Model.prefill`` calls of B=8 prompts of 512 tokens, one
``ServeEngine.score`` of (8, 513) tokens, and ``chip_smoke.py``'s
decode-step profile of ``ContinuousEngine`` (B=8, decode_horizon 1, phase
7's prompts) at kv16 and kv4, each engine warmed into CUDA graphs first
(``warmup()``). Every line carries ``--tag``; the
card's name and power limit are printed beside the prefill rates. Compare
two trees by running both from one command, in the order parent, change,
change, parent (one process each: a process imports one package). Needs
one CUDA device; imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True,
                    help="directory holding the repro_torch package")
    ap.add_argument("--tag", required=True, help="label of every line")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    sys.path.insert(0, os.path.abspath(args.src))   # ahead of this tree's
    import torch
    if not torch.cuda.is_available():
        cs.fail("chip_compare.py needs one CUDA device")
    import repro_torch
    cs.log(f"==== {args.tag}: repro_torch from "
           f"{os.path.dirname(repro_torch.__file__)} | {cs.smi_line()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    cs.phase_build()
    timer = cs.Timer(torch, device)
    cs.phase_msb_matmul(torch, timer, device)
    cs.phase_paged_attention(torch, timer, device)
    del timer

    from repro_torch.configs import get_config
    from repro_torch.core import QuantPolicy, pack_params, quantize_params
    from repro_torch.models import Model
    from repro_torch.serve import ServeEngine
    cfg = get_config("internlm2-1.8b")
    model = Model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    qparams, _ = quantize_params(params, QuantPolicy(bits=4, block=64,
                                                     solver="dp"))
    del params
    packed, _ = pack_params(qparams)
    del qparams
    prompts = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (8, 512)).astype(np.int32)
    eng = ServeEngine(model, packed, max_seq=1024)
    eng.generate(prompts[:, :16], 2)           # lazy set-up, untimed
    tokens = torch.from_numpy(prompts).to(device)
    rates = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.prefill(eng.params, {"tokens": tokens})
        torch.cuda.synchronize()
        rates.append(prompts.size / (time.perf_counter() - t0))
        del logits, cache
    cs.log(f"  {args.tag} static prefill B=8 P=512 tok/s: "
           + ", ".join(f"{r:.1f}" for r in rates) + f" | {cs.smi_line()}")
    scored = np.concatenate([prompts, prompts[:, :1]], axis=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nll = eng.score(scored)
    torch.cuda.synchronize()
    cs.log(f"  {args.tag} score (8, 513): NLL {nll:.6f} in "
           f"{time.perf_counter() - t0:.3f} s")
    del eng

    from repro_torch.serve import ContinuousEngine
    serve_prompts = cs.serve_prompts(cfg)
    for bits in (16, 4):
        cont = ContinuousEngine(model, packed, kv_bits=bits,
                                **cs.SERVE_ENGINE)
        cs.log(f"  {args.tag} kv{bits} decode step (graphs):")
        cs.profile_decode(torch, cont, serve_prompts, 32)


if __name__ == "__main__":
    main()
