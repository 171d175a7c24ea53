"""Timed variants of kernel A's expert batch on one GPU: what binds it.

    python3 chip_experts_variants.py

Builds copies of ``src/repro_torch/csrc/msb_matmul.cu`` with one tile or
one piece of the cluster kernel's work changed (``chip_unembed_variants
.build``: one nvcc per copy, all started together, into the git-ignored
``src/repro_torch/_build/variants/``), and times each against the source as
built on the same inputs, medians of 20 cold-L2 launches
(``chip_smoke.Timer``), at granite-moe-3b-a800m's gate/up expert batch (48
experts, 1536 x 512) at a decode step (C=8) and a 512-token wave (C=112)
and jamba-v0.1-52b's at a decode step (16 experts, 4096 x 14336, C=8):

* as built; the parent's design through the same entry (``cluster`` 0:
  ``msb_matmul``'s 16 x 64 tile per expert, its splits through an f32
  scratch and ``split_reduce_kernel``);
* at 16 rows: 64 columns on 4 warps (4 blocks an SM) for 128 on 8; one
  item a cluster for persistent clusters;
* with the products, the decode or the loads taken out of the cluster
  kernel (their results are wrong; only their times count).

Every variant that keeps the arithmetic is checked bit for bit against the
source as built. Prints one line per shape with the card's name and power
limit. Needs one CUDA device; imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import ctypes
import os
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

T16 = "using ExpertTile16 = ExpertTile<Tile<16, 128, 1, 8, 4, 2>, true>;"
# name: (edits, the 16-row tile's (bm, bn, persist) when it changes)
VARIANTS = {
    "as built": ([], None),
    "16 x 64 on 4 warps": (
        [(T16, "using ExpertTile16 = ExpertTile<Tile<16, 64, 1, 4, 4, 4>, true>;")],
        (16, 64, True)),
    "one item a cluster": (
        [(T16, "using ExpertTile16 = ExpertTile<Tile<16, 128, 1, 8, 4, 2>, false>;")],
        (16, 128, False)),
    "no products": (
        [("        for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], af[mt], "
          "bfr[nt][0], bfr[nt][1]);",
          "        for (int nt = 0; nt < NT; ++nt) acc[mt][nt][0] += "
          "__uint_as_float(af[mt][0] ^ bfr[nt][0] ^ af[mt][3] ^ bfr[nt][1]);")],
        None),
    "no decode": (
        [("      if (s + 1 < item_steps || e_next < E) st.decode((t + 1) % STAGES, "
          "(t + 1) & 1);\n", "")], None),
    "no loads": (
        [("      copies.issue(smem, t_ld % STAGES, K, N);\n", "")], None),
}
WRONG = ("no products", "no decode", "no loads")
# (name, experts, routed of them, top-k, K, N, capacity C, tokens)
SHAPES = [("granite-moe decode C=8", 48, 40, 8, 1536, 512, 8, 8),
          ("granite-moe wave C=112", 48, 40, 8, 1536, 512, 112, 512),
          ("jamba decode C=8", 16, 16, 2, 4096, 14336, 8, 8)]


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_experts_variants.py needs one CUDA device")
    import chip_smoke as cs
    import chip_unembed_variants as uv
    from repro_torch.kernels.msb_matmul import ops
    device = torch.device("cuda", 0)
    libs = uv.build({k: v[0] for k, v in VARIANTS.items()}, tag="experts")
    timer = cs.Timer(torch, device)
    gen = torch.Generator(device=device).manual_seed(3)
    stream = torch.cuda.current_stream().cuda_stream
    print(f"[experts variants] {cs.smi_line()}", flush=True)
    for label, e, n_real, topk, k, n, c, tokens in SHAPES:
        counts = cs.expert_counts(torch, gen, tokens, topk, n_real, e, c,
                                  device)
        packed = torch.randint(0, 256, (e, k, n // 2), generator=gen,
                               device=device, dtype=torch.int32).to(
                                   torch.uint8)
        scales = torch.sort(torch.rand((e, k, n // 64, 8), generator=gen,
                                       device=device) * 0.05,
                            dim=-1).values.contiguous()
        x = torch.randn((e, c, k), generator=gen, device=device).to(
            torch.bfloat16)
        times, ref = {}, None
        for name in ("parent design",) + tuple(VARIANTS):
            lib = libs["as built" if name == "parent design" else name]
            fn = getattr(lib, "msb_matmul_experts")
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 12 + \
                [ctypes.c_void_p]
            out = torch.empty((e, c, n), dtype=torch.bfloat16, device=device)
            part = None
            if name == "parent design":
                p = ops.plan(c, k, n)
                part = torch.empty((e, p.grid_splits, c, n),
                                   dtype=torch.float32, device=device)
                tile = (p.bm, p.bn, 0, 0, p.grid_splits)
            else:
                p = ops.experts_plan(c, k, n)
                over = VARIANTS[name][1]
                bm, bn, persist = over if over and p.bm == 16 else \
                    (p.bm, p.bn, p.persist)
                tile = (bm, bn, p.cluster, int(persist), 0)
            bm, bn, cluster, persist, grid_splits = tile
            args = (x.data_ptr(), packed.data_ptr(), scales.data_ptr(),
                    counts.data_ptr(), out.data_ptr(),
                    None if part is None else part.data_ptr(), e, c, k, n,
                    p.splits, grid_splits, bm, bn, cluster, persist, 0, 1,
                    stream)
            if fn(*args):
                sys.exit(f"{label} {name}: launch refused")
            torch.cuda.synchronize()
            if name not in WRONG:
                ref = out.clone() if ref is None else ref
                if not torch.equal(out, ref):
                    sys.exit(f"{label} {name}: bits differ from the parent's")
            times[name], _ = timer.stats(lambda: fn(*args))
        print(f"  {label} (K={k}, N={n}, {int((counts > 0).sum())} of {e} "
              "routed): " + " | ".join(f"{name} {t:.4f} ms"
                                       for name, t in times.items()),
              flush=True)
        del packed, scales, x
    print(f"[experts variants] ok | {cs.smi_line()}", flush=True)


if __name__ == "__main__":
    main()
