"""Mutation check of the windowed checks of ``chip_smoke.py`` on one GPU.

    python3 chip_window_mutant.py

Copies ``src/`` and ``chip_smoke.py`` into ``_local/window_mutant/`` and
breaks the copy's kernels B and C on purpose: the head of a row's first
page below its window start is no longer masked (the window start rounded
down to its page). Then runs ``chip_smoke.window_cases`` (gemma2's
attention with windows 4100 and 4096, kv16, kv8 and kv4) on the checkout,
where every case must pass, and on the copy, where every case must fail.
Each run prints its checks' largest absolute error and worst row error
relative to the row's largest value. Exits 0 only if both hold.
"""
from __future__ import annotations

import ast
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
COPY = os.path.join(ROOT, "_local", "window_mutant")
MASKED = "  const int lo = start - base;"
UNMASKED = "  const int lo = 0;"

RUN = """
import sys
import torch
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
device = torch.device("cuda", 0)
cs.phase_build()
timer = cs.Timer(torch, device)
gen = torch.Generator(device=device).manual_seed(3)
failed = []
for bits in (16, 8, 4):
    try:
        cs.window_cases(torch, timer, device, gen, bits)
    except SystemExit:
        failed.append(bits)
print("FAILED_BITS", failed, flush=True)
"""


def make_copy():
    shutil.rmtree(COPY, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "src"), os.path.join(COPY, "src"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), COPY)
    cu = os.path.join(COPY, "src", "repro_torch", "csrc",
                      "paged_attention.cu")
    text = open(cu).read()
    if text.count(MASKED) != 1:
        sys.exit(f"{cu}: the masked-head line was not found once")
    open(cu, "w").write(text.replace(MASKED, UNMASKED))


def failed_bits(root):
    out = subprocess.run([sys.executable, "-c", RUN, root],
                         capture_output=True, text=True)
    sys.stdout.write(out.stdout)
    sys.stdout.write(out.stderr)
    lines = [l for l in out.stdout.splitlines()
             if l.startswith("FAILED_BITS")]
    if out.returncode != 0 or not lines:
        sys.exit(f"{root}: the run did not finish (exit {out.returncode})")
    return ast.literal_eval(lines[-1].split(" ", 1)[1])


def main():
    make_copy()
    print("== checkout", flush=True)
    tree = failed_bits(ROOT)
    print("== copy with the first page's head unmasked", flush=True)
    mutant = failed_bits(COPY)
    shutil.rmtree(COPY, ignore_errors=True)
    print(f"checkout failed at kv_bits {tree}, mutant at {mutant}")
    if tree or sorted(mutant) != [4, 8, 16]:
        sys.exit("the windowed checks do not tell the kernels apart")
    print("ok: the checkout passes and the mutant fails at every kv_bits")


if __name__ == "__main__":
    main()
