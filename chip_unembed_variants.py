"""Timed variants of the unembedding kernels on one GPU: where the time goes.

    python3 chip_unembed_variants.py

Builds copies of ``src/repro_torch/csrc/msb_matmul.cu`` with one piece of a
kernel's work taken out (their results are wrong; only their times count)
into the git-ignored ``src/repro_torch/_build/variants/``, one nvcc per
copy, all started together, and times each against the unchanged source on
the same random tables, medians of 20 cold-L2 launches (``chip_smoke
.Timer``):

* the f32 SIMT kernel ``msb_matmul`` (the unembedding's kernel before
  ``msb_unembed``) at internlm2-1.8b's k-blocked table, M=8: as built; its
  codebook lookup made free of bank conflicts (``cb[kk]`` for ``cb[nn]``);
  its K cut into 4 splits on separate blocks (the K plan of ``ops.plan``
  gives 1); with the products taken out (loads, decode and barriers only);
* ``msb_unembed`` at internlm2's k-blocked and gemma2-2b's tied table, M =
  1 and 8: as built; x from registers instead of shared memory ("no x
  loads"); weights from the code bits instead of the decode tables ("no
  table lookups"); one FMA a weight instead of M ("no products").

Prints one line per case with the card's name and power limit. Needs one
CUDA device; imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

SRC = os.path.join(ROOT, "src", "repro_torch", "csrc", "msb_matmul.cu")
OUT = os.path.join(ROOT, "src", "repro_torch", "_build", "variants")

# (old text, new text) edits of each variant; every old text must occur
EDITS = {
    "as built": [],
    "conflict-free lookup": [
        ("const float mag = KBLOCKED ? cb[nn][nib & 7] : cb[kk][nib & 7];",
         "const float mag = cb[kk][nib & 7];")],
    "no products (old)": [
        ("        acc[i] = fmaf(xs[rgrp + i * (SIMT_THREADS / SIMT_BN)][kk], w, "
         "acc[i]);",
         "        acc[i] += w;")],
    "no x loads": [
        ("load_x<MT>(xb + (qq * 8 + j) * MT, xv);",
         "for (int m_ = 0; m_ < MT; ++m_) xv[m_] = (float)(m_ + j);"),
        ("load_x<MT>(xb + r * MT, xv);",
         "for (int m_ = 0; m_ < MT; ++m_) xv[m_] = (float)(m_ + r);")],
    "no table lookups": [
        ("w[r][j] = tab[r * TAB + ((cw[r][qq] >> (4 * j)) & 15) * 32];",
         "w[r][j] = __uint_as_float((((cw[r][qq] >> (4 * j)) & 15) << 19) | "
         "0x3f800000u);"),
        ("const float w0 = tab[(cb & 15) * 32], w1 = tab[TAB + (cb >> 4) * 32];",
         "const float w0 = __uint_as_float(((cb & 15) << 19) | 0x3f800000u), "
         "w1 = __uint_as_float(((cb >> 4) << 19) | 0x3f800000u);")],
    "no products": [
        ("for (int m = 0; m < MT; ++m) acc[r * MT + m] = fmaf(w[r][j], xv[m], "
         "acc[r * MT + m]);",
         "acc[r * MT] = fmaf(w[r][j], xv[j % MT], acc[r * MT]);"),
        ("""      for (int m = 0; m < MT; ++m) {
        acc[m] = fmaf(w0, xv[m], acc[m]);
        acc[MT + m] = fmaf(w1, xv[m], acc[MT + m]);
      }""", """      {
        acc[0] = fmaf(w0, xv[r % MT], acc[0]);
        acc[MT] = fmaf(w1, xv[r % MT], acc[MT]);
      }""")],
}
OLD = ("as built", "conflict-free lookup", "no products (old)")
NEW = ("as built", "no x loads", "no table lookups", "no products")


def build(variants=None, tag="v"):
    """{variant: the C library} of ``variants`` ({name: [(old text, new
    text)]}, ``EDITS`` by default), every copy built in parallel."""
    from repro_torch.kernels import _build
    os.makedirs(OUT, exist_ok=True)
    text, procs = open(SRC).read(), {}
    for i, (name, edits) in enumerate((variants or EDITS).items()):
        src = text
        for old, new in edits:
            if src.count(old) != 1:
                sys.exit(f"{name}: the edited text was not found once")
            src = src.replace(old, new)
        cu = os.path.join(OUT, f"{tag}{i}.cu")
        open(cu, "w").write(src)
        lib = os.path.join(OUT, f"{tag}{i}.so")
        cmd = [_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-o", lib, cu]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"{name}: nvcc exited {proc.returncode}\n{log}")
        libs[name] = ctypes.CDLL(lib)
    return libs


def entry(lib, name, n_ints):
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p] * (6 if name == "msb_matmul" else 4) + \
        [ctypes.c_int] * n_ints + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_unembed_variants.py needs one CUDA device")
    import chip_smoke as cs
    from repro_torch.kernels.msb_matmul import ops
    device = torch.device("cuda", 0)
    libs = build()
    timer = cs.Timer(torch, device)
    gen = torch.Generator(device=device).manual_seed(2)
    stream = torch.cuda.current_stream().cuda_stream
    print(f"[variants] {cs.smi_line()}", flush=True)

    # the old f32 SIMT kernel at internlm2's k-blocked table, M=8
    k, n, m = 2048, 92672, 8
    packed, scales = cs.rand_packed(torch, gen, k, n, True, device)
    x = torch.randn((m, k), generator=gen, device=device)
    out = torch.empty((m, n), device=device)
    times = {}
    for name in OLD + ("4 K splits",):
        lib = libs["as built" if name == "4 K splits" else name]
        splits = 4 if name == "4 K splits" else ops.k_splits(k, n)
        part = torch.empty((splits, m, n), device=device)
        fn = entry(lib, "msb_matmul", 8)
        args = (x.data_ptr(), packed.data_ptr(), scales.data_ptr(), None,
                out.data_ptr(), part.data_ptr(), m, k, n, splits, splits, 8,
                1, 0, stream)
        if fn(*args):
            sys.exit(f"msb_matmul {name}: launch refused")
        times[name], _ = timer.stats(lambda: fn(*args))
    print("  msb_matmul f32 SIMT, internlm2 k-blocked M=8: " + " | ".join(
        f"{name} {t:.4f} ms" for name, t in times.items()), flush=True)
    del packed, scales

    # msb_unembed at internlm2's and gemma2's tables, M = 1 and 8
    for table, v, d, kb, dt in cs.UNEMBED_TABLES[:2]:
        packed, scales = cs.rand_packed(torch, gen, d if kb else v,
                                        v if kb else d, kb, device)
        x = torch.randn((8, d), generator=gen, device=device)
        for m in (1, 8):
            xm, out = x[:m].contiguous(), torch.empty((m, v), device=device)
            p = ops.unembed_plan(m, d, v, kb)
            times = {}
            for name in NEW:
                fn = entry(libs[name], "msb_unembed", 8)
                args = (xm.data_ptr(), packed.data_ptr(), scales.data_ptr(),
                        out.data_ptr(), m, d, d, v, int(kb),
                        int(not kb and dt == "bfloat16"), p.mt, p.slices,
                        stream)
                if fn(*args):
                    sys.exit(f"msb_unembed {name}: launch refused")
                times[name], _ = timer.stats(lambda: fn(*args))
            print(f"  msb_unembed {table} {'k-blocked' if kb else 'tied'} "
                  f"M={m}: " + " | ".join(f"{name} {t:.4f} ms"
                                          for name, t in times.items()),
                  flush=True)
        del packed, scales
    print("[variants] ok", flush=True)


if __name__ == "__main__":
    main()
