"""Quickstart: MSB dynamic-grouping quantization in five minutes.

    PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]

The PyTorch port of ``examples/quickstart.py``; it runs on the card unless
``--device cpu`` is given. It quantizes a synthetic LLM-like weight matrix
with the framework's solvers and the baselines the paper compares
against, and prints the reconstruction-MSE / storage table (the paper's
Table 2 layout), with each row's time. The exact DP, RTN, NF4, HQQ and
GPTQ run on the given device; the paper's CPU solver (WGM) runs per block
in numpy on the host, whatever the device.
"""
import argparse
import time

import numpy as np
import torch


def make_weight(rows=512, cols=2048):
    """The reference's heavy-tailed weight: student-t (df 4), std 0.02."""
    rng = np.random.default_rng(0)
    w = rng.standard_t(4, size=(rows, cols)).astype(np.float32)
    w *= 0.02 / w.std()
    return w


def table(w, device):
    """[(name, bits per weight, seconds, MSE)] of every method on ``w``
    (numpy) placed on ``device``."""
    from repro_torch.core import (baselines, dequantize, quantize_blockwise,
                                  quantize_pertensor, reconstruction_mse,
                                  storage_bits_per_weight)

    wt = torch.from_numpy(w).to(device)
    rows = []

    def add(name, fn, bits_eff=None):
        _sync(device)
        t0 = time.perf_counter()
        out = fn()
        _sync(device)
        t = time.perf_counter() - t0
        if hasattr(out, "codes"):
            mse = float(reconstruction_mse(wt, dequantize(out)))
            bits = storage_bits_per_weight(out)
        else:
            mse = float(reconstruction_mse(wt, out))
            bits = bits_eff
        rows.append((name, bits, t, mse))

    # --- 4-bit block-wise (the paper's primary setting) ---
    add("MSB-DP  (exact, batched)", lambda: quantize_blockwise(
        wt, 4, solver="dp"))
    add("MSB-WGM (paper Alg.3, CPU)", lambda: quantize_blockwise(
        wt, 4, solver="wgm"))
    add("RTN 4b/64", lambda: baselines.rtn_quantize(wt, 4, 64), 6.0)
    add("NF4 (BnB)", lambda: baselines.nf4_quantize(wt, 4, 64), 4.5)
    add("HQQ 4b/64", lambda: baselines.hqq_quantize(wt, 4, 64), 8.25)
    add("GPTQ 4b/64 (synthetic calib)", lambda: baselines.gptq_quantize(
        wt, 4, 64), 4.5)

    # --- 6-bit per-tensor ---
    add("MSB-WDP 6b per-tensor", lambda: quantize_pertensor(
        wt, 6, solver="wdp"))
    add("RTN 6b per-tensor", lambda: baselines.rtn_quantize(wt, 6, -1), 6.0)
    return rows


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    from repro_torch.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shape", type=int, nargs=2, default=(512, 2048),
                    metavar=("ROWS", "COLS"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    w = make_weight(*args.shape)
    print(f"weight: {w.shape}, heavy-tailed (student-t df=4), std 0.02, "
          f"on {dev}\n")
    rows = table(w, dev)

    print(f"{'method':32s} {'bits/wt':>8s} {'time':>8s} {'MSE':>12s}")
    for name, bits, t, mse in rows:
        b = f"{bits:.2f}" if bits else "-"
        print(f"{name:32s} {b:>8s} {t:7.2f}s {mse:12.5f}")

    print("\nMSB-DP is the exact optimum of the paper's objective: batched "
          "over blocks it runs in milliseconds on the card where the "
          "paper's CPU oracle needed hours (Table 4).")
    return {"rows": rows, "shape": tuple(w.shape)}


if __name__ == "__main__":
    main()
