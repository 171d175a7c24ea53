"""Where the time of ``examples_torch/train_quantize_serve.py --preset 100m``
goes, on one card.

    python3 chip_e2e_profile.py

Runs from a checkout (it imports ``src/repro_torch`` and the program by
path, nothing of JAX) and needs one CUDA device. Prints, one line each:
the host's draw of the Markov chain's normals alone, the whole
``MarkovStream`` build and the entropy on the card; one batch; the train
step with its batches made beforehand and with the program's
``Prefetcher`` drawing them on its thread meanwhile (the two contend for
the GIL); then one step under ``torch.profiler``: its wall, the device's
busy share and its ten longest kernels
(``chip_smoke.device_breakdown``), and the 10 ops with the most host
time. Numbers from one call are comparable only with each other.
"""
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402


def main():
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this needs a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cs.phase_env(torch)
    cs.phase_build()
    prog = cs.load_program("train_quantize_serve")
    from repro_torch.data import MarkovStream, Prefetcher
    from repro_torch.train import AdamW, OptConfig, init_state, \
        make_train_step
    model, b, s = prog.build_model("100m")
    v = model.cfg.vocab_size
    t0 = time.perf_counter()
    np.random.default_rng(7).standard_normal((v, v))
    t1 = time.perf_counter()
    data = MarkovStream(v, s, b, seed=7)
    t2 = time.perf_counter()
    floor = prog.chain_entropy(data, dev)
    t3 = time.perf_counter()
    cs.log(f"[chain] normals alone {t1 - t0:.1f} s; MarkovStream "
           f"{t2 - t1:.1f} s; entropy on the card {t3 - t2:.1f} s "
           f"({floor:.4f} nats)")
    t = time.perf_counter()
    data.batch(0)
    cs.log(f"[batch] B={b} x {s}: {time.perf_counter() - t:.3f} s")

    opt = AdamW(OptConfig(lr=3e-3, warmup_steps=10, total_steps=40))
    state = init_state(model, opt, torch.Generator(device=dev).manual_seed(0),
                       dev)
    step = make_train_step(model, opt)
    batches = [data.batch(i) for i in range(6)]

    def run(batch):
        nonlocal state
        t = time.perf_counter()
        state, m = step(state, batch)
        float(m["loss"])
        return (time.perf_counter() - t) * 1e3

    for batch in batches[:2]:
        run(batch)
    ready = [run(batch) for batch in batches[2:]]
    pf = Prefetcher(iter(data))
    fed = []
    for _ in range(5):
        t = time.perf_counter()
        run(next(pf))
        fed.append((time.perf_counter() - t) * 1e3)
    pf.close()
    cs.log(f"[step] batches ready {[round(x, 1) for x in ready]} ms; with "
           f"the prefetcher {[round(x, 1) for x in fed]} ms; peak "
           f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = run(batches[0])
    cs.device_breakdown(prof, wall, 1, "[profile] one 100m step")
    for e in sorted(prof.key_averages(),
                    key=lambda e: -e.cpu_time_total)[:10]:
        cs.log(f"  host {e.cpu_time_total / 1e3:9.2f} ms {e.count:6d}x "
               f"{e.key[:100]}")


if __name__ == "__main__":
    main()
