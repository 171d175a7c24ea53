"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Runs from a checkout of the repository (it imports ``src/repro_torch`` and
nothing of JAX or of the JAX package) and needs one CUDA device. Phases,
one line each (details indented), any failure exits non-zero:

1. env    — card name and power limit, CUDA and nvcc versions
2. build  — nvcc builds the kernel sources of ``src/repro_torch/csrc`` in
   parallel (msb_matmul; paged_attention, which holds kernels B and C;
   flash_attention)
3. msb_matmul vs its plain version at the main path's shapes (decode M,
   packed-prefill M, the static prefill's M=4096, the f32 unembedding;
   gemma2-2b's projections at M = 8 and 4096, qwen1.5-0.5b's biased q
   projection), with times; rows bit-identical at M = 1, 8, 17, 512 and
   4096; jamba's dt_proj (K=256) at M = 8 and 2048; its expert batch at
   granite-moe's shapes (48 experts, C = 8 and 112, counts with zeros)
   and jamba's (16 experts, 4096 x 14336 both ways, C = 8), every expert
   bit-identical to msb_matmul on it alone (one cluster launch a call: its
   tile, cluster size and ptxas registers printed); internlm2's projections as
   one rank of a tp = 2 mesh holds them (k/v N 512, attention wo K 1024,
   gate/up N 4096, the MLP's wo K 4096) at M = 1, 8 and 512, rows at 1, 8
   and 17 bitwise those at 512; the unembedding's kernel
   (``msb_unembed``) at internlm2's (whole, and one rank's half at
   tp = 2) and jamba's k-blocked tables and
   gemma2's and qwen1.5-0.5b's tied tables (all of ``UNEMBED_TABLES``)
   at M = 1, 2, 4, 8 and 64, every row tile, with its plain version,
   ``torch.matmul`` on the pre-dequantized f32 table and its bound; rows
   at M < 64 bit-identical to the same rows at M = 64
4. paged_attention_decode (split-KV) vs its plain version on full-width
   bf16 pools and at a 512-token packed-prefill wave, and with gemma2's
   sliding window (d=256, KV=4, softcap 50, rows to 8192 keys, windows
   4096 and 4100), and at one tp = 2 rank's 8 heads over 4 KV heads;
   every row bit-identical alone and in the batch
5. paged_attention_decode_quant (split-KV) vs its plain version on
   full-width 8- and 4-bit quantized pools, with and without the window,
   and at kv4 on one tp = 2 rank's heads; every row bit-identical alone
   and in the batch
6. flash_attention_fwd vs its plain version at the static path's prefill
   shape and at long, ragged, windowed + softcapped, segmented (bf16: the
   tensor-core kernel), f32 (the SIMT kernel), gemma2's (head_dim 256,
   window 4096, softcap 50, S=4608) and whisper's (head_dim 64, not
   causal: the encoder over 1500 frames, and the cross-attention of 64
   queries onto them) shapes; pad rows exactly 0, cross-segment
   isolation bit for bit; at every shape D with its log-sum-exp output:
   the output bitwise as without it, lse against the plain version's.
   Then gradients through ``models.attention.flash_attention`` (D under
   its autograd Function, the plain-torch backward) against autograd
   through the plain version at internlm2's train shape (B=2, S=4096),
   gemma2's windowed d=256 prefill and whisper's encoder and
   cross-attention; D+lse, the backward and SDPA forward+backward timed
   at the train shape. Then D with ``q_offset`` (context parallelism: a
   rank's rows against the whole K/V) at internlm2's CP shape (S = 3072
   over three ranks, bf16 and f32; phase 17's B=4 x 768 over three, f32)
   and gemma2's windowed d=256 one (S = 4608 over three): every rank's rows against the plain version, with
   the lse, and bitwise the same rows of the q_offset 0 launch over the
   whole sequence; times, bound and SDPA with the same boolean mask
7. serve  — internlm2-1.8b at full width: init, 4-bit DP quantization on
   the card, pack, ContinuousEngine at decode_horizon 8 and 1 over kv16
   pools, each engine's dispatch set captured as CUDA graphs by warmup()
   first (report printed; no capture after it); the kernels' launch
   counters are zeroed just before the horizon-8 run and those of its path
   (A, the unembedding's kernel, B) must be non-zero after it. Before the timed runs, graph replay is held
   against the same dispatches run eagerly (one packed-prefill bucket, one
   decode-horizon batch): outputs and pools bit-identical, pool addresses
   unchanged. Decode-step and prefill-wave profiles over graph replays
8. serve kv8/kv4 — the same packed weights and requests over MSB-quantized
   KV pools (kv_bits 8, then 4) at decode_horizon 8 and 1, warmed and
   checked as in phase 7, counters zeroed before each horizon-8 run;
   commit cost and a kv4 decode-step profile
9. serve static — the same packed weights through ServeEngine: generate
   (prefill on flash_attention_fwd, then ring decode) and score, counters
   zeroed before each; greedy tokens against ContinuousEngine's
10. kernel path vs plain path — smoke internlm2 served on the card and on
   the CPU from the same weights, at kv_bits 16, 8 and 4, and through the
   static engine
11. front door — phase 7's packed weights behind ``APIServer`` over an
   ``EngineSupervisor`` with ``warmup=True``, at kv16, at kv16 with one
   step hung until the watchdog rebuilds the engine, and at kv4: /healthz
   goes from warming to ok, phase 7's prompts (streaming and not, 32
   tokens, temperature 0) come back over HTTP with the tokens of the
   direct horizon-8 run (at kv4, the requests whose prefill chunks all
   ended on a page boundary or at the prompt's end in both runs; after the
   hang, up to near ties), /metrics shows no capture after warm-up but the
   re-warm's, clean shutdown with a page audit
12. quantizer — full-width internlm2-1.8b cut to ``QUANT_LAYERS`` of its
   24 layers (random bf16 weights, seed 0) quantized on the card by MSB
   4b/64 with dp, kmeans, wdp, dp + refine
   and dp + double quantization (each packed: kernel A in ``score``), MSB
   6-bit per-tensor with wdp and kmeans (served unpacked), and the RTN,
   NF4, HQQ 4b/64 and RTN 6-bit per-tensor baselines (dense trees); per
   method: quantize seconds and peak memory, relative reconstruction
   error, bits per weight, ``ServeEngine.score`` NLL on (8, 513) tokens
   and its gap to the unquantized model, the next-token logit gap, and
   the launch counters of that ``score`` (kernel D once a layer; kernel A
   on packed trees only). The error order must hold (DP at or below kmeans,
   DP+DQ, RTN, NF4 and HQQ; wdp and refine equal to DP within 1e-6;
   per-tensor wdp below per-tensor RTN). The card's solvers are held
   against their CPU run on 4096 blocks of layer 0's ``wq`` (dp, kmeans,
   wdp) and on the whole matrix per tensor; the paper's numpy solvers run
   on 256 of those blocks on the host (none may beat DP); GPTQ runs once
   on one full-width matrix
13. families — gemma2-2b and granite-moe-3b-a800m at full width, cut to
   ``FAMILY_LAYERS`` layers (random weights, seed 0; 4b/64 DP on the
   card, packed), each freed before the
   next: gemma2 through ContinuousEngine at kv16 and kv4 (one request of
   4500 tokens, past its 4096-token window) and ServeEngine on 2 x 4608
   tokens (kernel D with the window) then score; granite-moe at kv16
   (kernel A's expert batch) and through ServeEngine; every engine as in
   phase 7 (graph replay bitwise against eager, warmed H=8 and H=1, no
   capture after warm-up, H=8 tokens against H=1, launch counters: the
   tied table's unembedding on its kernel) with a decode-step profile; granite-moe also at its own capacity with uneven
   new-token counts, kv16 and kv4, H=8 against H=1 reported, not held;
   then the smoke configs of gemma2, granite-moe, qwen1.5-0.5b and
   arctic-480b served on the card and on the CPU (granite-moe at kv8/kv4
   and its own capacity with uneven counts: reported, not held), and
   internlm2's without RoPE (sinusoids in the paged steps) at kv16/8/4
14. state stacks — the stacks with per-sequence state at full width
   (random weights, seed 0, each drawn, 4b/64 DP quantized and packed
   leaf by leaf on the card, freed before the next): xlstm-125m (12
   layers) and jamba-v0.1-52b cut to one 8-layer period (7 mamba, 1
   attention, 4 MoE layers) through ServeEngine (prefill, 32 greedy
   tokens, score) with decode-step profiles; whisper-large-v3 (32 + 32
   layers, 1500 frames) and internvl2-76b cut to 2 layers (1024 patch
   embeddings) through Model.prefill, greedy decode_steps and
   Model.loss; kernel D's launches held exactly (whisper 96, jamba 1,
   internvl 2, xlstm 0), A and the unembedding's kernel non-zero, the
   expert batch for jamba; then the four smoke configs on the card and
   on the CPU
15. train — (a) three ``make_train_step`` steps of the internlm2,
   gemma2, granite-moe, jamba, xlstm and whisper smoke configs on the
   card and on the CPU from the same params and batches (loss and grad
   norm within 1e-4 relative); (b) internlm2-1.8b at full width through
   ``train_loop`` (random weights, seed 0; TokenStream B=4 x 4096; f32
   params and moments; remat): finite losses, the first within 1 nat of
   ln(vocab), exactly 48 D launches a step and none of B or C, step ms,
   tokens/s, peak memory, a profiled step, forward+backward and AdamW
   apart (``wq``'s gradient present and non-zero), then two steps with
   int8 moments and their peak; (c) a smoke run saved at step 2 (async,
   from CUDA tensors), restored onto the card and run on to step 4,
   against two uninterrupted runs; (d) ``launch.train --smoke --steps
   30`` ends below its first loss and ``launch.serve --ckpt-dir``
   restores its last step
16. tp — run after phase 11, on phase 7's packed weights: a
   tensor-parallel mesh of two ranks on the one card
   (``make_tp_mesh(2, devices=["cuda:0", "cuda:0"])``: a worker process,
   gloo collectives staged through the host, every dispatch eager);
   internlm2-1.8b through ContinuousEngine at kv16 and kv4, H=8 and H=1
   (warm-up reports 0 graphs), tokens against phases 7-8's tp = 1 runs
   (identical, or first divergence at a top-2 gap < 1e-2), each rank's A,
   unembedding and B (kv16) or C (kv4) launched; ServeEngine generate and
   score of phase 9's inputs with exactly 24 D launches a prefill on each
   rank, tokens against phase 9's, NLL within 1e-3 relative;
   granite-moe-3b-a800m cut to 4 layers, its heads and 48 experts
   sharded (24 a rank), each rank's expert batch launched, tokens
   against its tp = 1 run; eager step times and each rank's peak memory
17. gspmd — GSPMD-style training on a process mesh of four ranks on the
   one card (``make_host_mesh((2, 2), devices=["cuda:0"] * 4)``: data 2,
   model 2; ZeRO-3 over data, heads and the MLP's channels over model,
   the residual stream in rows between blocks): internlm2-1.8b at full
   width cut to ``GSPMD["layers"]`` layers, f32, B=8 x 512, the loss and
   two ``make_train_step`` steps against the same on one device on the
   card (loss and grad norm within 1e-4 relative), each rank's D launches
   exact, its peak memory; then a (1, 3) mesh, where 8 KV heads do not
   divide three ranks: the context-parallel loss (K/V gathered, D at
   every rank's ``q_offset``) against one device's
18. gspmd serve — GSPMD serving on the same (2, 2) mesh of four ranks on
   the one card: internlm2-1.8b at full width cut to
   ``GSPMD_SERVE["layers"]`` layers (4b/64 DP, packed);
   ``ContinuousEngine(parallel=)`` at kv16 and kv4, H=8 and H=1 (the
   planner's slices over ``model``, KV heads over ``model``, each data
   rank the whole step, eager as phase 16's), tokens against one
   device (near-tie rule; kv4 reported, H=8 = H=1 held), logits within
   ``TP_LOGIT_TOL``; ``ServeEngine(parallel=)`` generate and score at
   B=8 x 512 (rows over data, the ``kv_seq`` ring over model, decode
   through the flash-decode combine) and one B=1 x 1024 prompt (the ring
   over the whole mesh), tokens against one device, score within 1e-4;
   every rank's A, unembedding, B, C and D launches held exactly to what
   its dispatches count; then ``ServeEngine(parallel=)`` on a dense bf16
   tree of ``GSPMD_SERVE["dense_layers"]`` layers, which the resolver
   cuts (ZeRO-3 over data, heads over model): every rank's D once a layer
   at its rows and 8 of 16 heads, the K/V re-cut to ``kv_seq``, the
   weights gathered each decode step, tokens against one device
19. head_dim — (a) whisper-large-v3 at full width cut to
   ``HEADDIM["enc_layers"]`` encoder and ``HEADDIM["layers"]`` decoder
   layers (random weights, seed 0, 4-bit block-64 DP, packed) on a (1, 8)
   mesh of eight ranks on the one card: 20 KV heads, a 67-entry ring and
   1500 encoder rows divide 8 ways nowhere, so every K/V cache leaf is
   cut over ``head_dim`` (8 dims a rank); B=2 prompts of 63 tokens over
   1500 frames, the cache grown to 67 entries, 4 greedy ``decode_step``s
   under the context (partial scores summed over the ranks' slices of d,
   the output's slices gathered): tokens against one device (identical,
   or the first divergence at a top-2 gap < 1e-2), logits within
   ``TP_LOGIT_TOL[16]``, each rank's A and D launches exactly one
   device's (every rank projects and attends whole), ms a decode step
   and peak GB a rank as checks; (b) a CPU check, not a card one: the
   dry-run's two test cells run in this process on fake CPU tensors
   (``launch/dryrun.run_cell``:
   internlm2-1.8b ``decode_32k --quantized`` and whisper-large-v3
   ``decode_32k`` on the single-pod mesh), their records printed
20. programs — the five programs of ``examples_torch`` on the card, each
   loaded by path and called as ``main([..., "--device", "cuda"])`` with
   the launch counters zeroed just before it: ``serve_api --self-check``
   and ``--self-check --chaos`` (crashes at step and apply, OOM at alloc,
   through captured graphs; the device memory in use may not grow by
   more than one incarnation's graph pool), ``train_quantize_serve
   --preset 100m --steps 40`` and its relaunch with ``--steps 50`` on
   the same directory (resumed from step 25, finite losses that fall,
   D exactly twice a layer a step and once a layer in each held-out NLL
   and the serve's prefill; step ms, tok/s, peak GB), ``serve_quantized``
   (continuous against static tokens up to near ties),
   ``distributed_quantize`` (eight ranks on the card, 0 collectives, each
   rank bitwise the single-device solve of its shard) and ``quickstart``
   on a (128, 2048) weight (DP's MSE at or below every other 4b/64 row);
   meanwhile ``serve_api.py --port`` runs as a process of its own:
   ``/healthz`` from warming to ok, one request answered, SIGTERM, exit 0

Windowed B/C cases (phases 4-5) and D at d=256 and without the causal
mask (phase 6) also hold every output row within ``ROW_REL_TOL`` of its
own largest value, since rows over ~1500-4096 keys have values near
0.03.

The second-to-last line is the kernel table as JSON (kernel A at the
decode shape, at M=4096 and as the expert batch at granite-moe's and
jamba's shapes; the unembedding's kernel at internlm2's k-blocked and
gemma2's tied table, M=8; B and C without and, at kv16 and kv4, with the
window; D at the static prefill, at gemma2's windowed d=256 prefill,
at whisper's encoder and cross-attention, and with its lse at
internlm2's train shape, launched by phase 15's full-width run, the row
also carrying the backward's and SDPA forward+backward's times; and the
tp = 2 rows: A at internlm2's five shard shapes, the unembedding on a
rank's half of the table, B and C kv4 at a rank's heads; D with
``q_offset`` at the f32 shape phase 17's (1, 3) run launches it at,
B=4, 256 of 768 rows a rank; phase 18's rows: A, the unembedding, B
and C kv4 at the tp = 2 shard shapes its model shards run, D at a (2, 2)
rank's prefill, at the B=1 x 1024 prompt and at a rank's 8 heads of the
dense tree, with the four ranks' launches; phase 19's rows: A at
whisper's M=2 decode shape, the unembedding's kernel at M=2 on whisper's
tied table and D at its encoder, with the eight ranks' launches; phase
20's rows: A at the 100m preset's gate/up projection and the
unembedding's kernel on its tied f32 table at M=4, D with its lse at its
train shape, B at serve_api's page size 4 and serve_quantized's 8,
each with its kernel's launches in every program); the last line
is ``{"ok": true, "device": {...}}``. Times come from CUDA events; a weight
stream is timed cold (L2 flushed before every launch), as decode meets it.
Phases 3-6 report the median of 20 launches (the mean beside it) for the
kernel and its library yardstick; the build prints ptxas's registers,
shared memory and spills for every kernel.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # dense bf16 / f32 SIMT


def log(msg):
    print(msg, flush=True)


def fail(msg):
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else \
        f"nvidia-smi failed: {out.stderr.strip()}"


# ---------------------------------------------------------------------------
# timing helpers
# ---------------------------------------------------------------------------

class Timer:
    """Mean milliseconds of ``fn()`` over ``reps`` launches, each timed with
    CUDA events; ``cold`` flushes L2 (a 128 MB write) before every launch."""

    SLEEP_CYCLES = 2_000_000     # ~1 ms at the H100's clocks

    def __init__(self, torch, device):
        self.torch = torch
        self.flush = torch.empty(32 << 20, dtype=torch.float32, device=device)

    def __call__(self, fn, reps=10, cold=True, warmup=2):
        return float(np.mean(self.times(fn, reps, cold, warmup)))

    def times(self, fn, reps=10, cold=True, warmup=2):
        """Milliseconds of each of ``reps`` timed launches. A short device
        sleep is queued before the start event, so the host has queued the
        whole call before the device reaches it: the events bracket device
        work only, not the wrapper's Python time."""
        torch = self.torch
        for _ in range(warmup):
            fn()
        out = []
        for _ in range(reps):
            if cold:
                self.flush.zero_()
            torch.cuda._sleep(self.SLEEP_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end))
        return out

    def stats(self, fn, reps=20, cold=True):
        """(median, mean) milliseconds over ``reps`` launches: the median
        for the tables (robust to one noisy launch), the mean beside it."""
        t = self.times(fn, reps, cold)
        return float(np.median(t)), float(np.mean(t))


def bound(nbytes, flops, dtype_name):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_env(torch):
    log(f"[env] {smi_line()}")
    nvcc = subprocess.run(["bash", "-lc", "nvcc --version || "
                           "/usr/local/cuda/bin/nvcc --version"],
                          capture_output=True, text=True).stdout
    nvcc_line = [l for l in nvcc.splitlines() if "release" in l]
    log(f"  torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}"
        f" | nvcc: {nvcc_line[0].strip() if nvcc_line else 'not found'}")


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    secs = _build.build_all()
    wall = time.perf_counter() - t0
    log(f"[build] {wall:.2f} s wall for {len(secs)} sources, in parallel: "
        + ", ".join(f"{k} {v:.2f} s" for k, v in secs.items()))
    for name in _build.KERNELS:
        for r in _build.ptxas_report(name):
            log(f"  ptxas {name}: {r['kernel']}: {r['registers']} "
                f"registers, {r['smem']} B static smem, {r['stack']} B stack,"
                f" spills {r['spill_stores']} B stored / {r['spill_loads']} B "
                "loaded")


def rand_packed(torch, gen, k, n, kblocked, device):
    """Random packed codes and sorted positive f32 codebooks."""
    packed = torch.randint(0, 256, (k, n // 2), generator=gen,
                           device=device, dtype=torch.int32).to(torch.uint8)
    shape = (k // 64, n, 8) if kblocked else (k, n // 64, 8)
    scales = torch.rand(shape, generator=gen, device=device)
    scales = torch.sort(scales * 0.05, dim=-1).values.contiguous()
    return packed, scales


def phase_msb_matmul(torch, timer, device):
    """Kernel A against its plain version at the main path's shapes: decode
    and packed-prefill M (1-512) at every projection shape and the f32
    k-blocked unembedding, the static prefill's M=4096 at the three
    projection shapes, and every projection of phase 14's stacks at its
    decode and prefill M (the plain version timed with 2 reps at M of
    2048 and more). Kernel
    and library (``torch.matmul`` on the pre-dequantized weights) are
    medians of 20 cold launches. Also checks, bit for bit, that rows do
    not depend on M: each M=4096 product's first rows equal the same rows
    computed at M = 1, 8, 17 and 512."""
    from repro_torch.kernels.msb_matmul import ops, ref
    gen = torch.Generator(device=device).manual_seed(1)
    bf16 = torch.bfloat16
    cases = [(k, n, False, bf16, (1, 8, 128, 512) + (
        (4096,) if n != 1024 else ())) for k, n in
        ((2048, 2048), (2048, 1024), (2048, 8192), (8192, 2048))]
    cases.append((2048, 92672, True, torch.float32, (1, 8, 128, 512)))
    # gemma2-2b's projections (q, k/v, gate/up, down, o) at decode and
    # static-prefill M, and qwen1.5-0.5b's q projection with its fused bias
    cases += [(k, n, False, bf16, (8, 4096)) for k, n in
              ((2304, 2048), (2304, 1024), (2304, 9216), (9216, 2304),
               (2048, 2304))]
    cases.append((1024, 1024, False, bf16, (8,)))
    # jamba-v0.1-52b's dt_proj: K=256, four k-blocks (decode, the prefill)
    cases.append((256, 8192, False, bf16, (8, 2048)))
    # phase 14's stacks, each projection at its decode M (the batch) and
    # its prefill M (the batch's rows): jamba's mamba in/out, attention q,
    # k/v and dense MLP (B=4, 4 x 512); whisper's attention and MLP (B=4,
    # the decoder's 4 x 64, the encoder's 4 x 1500; K=1280 is 20
    # k-blocks; phase 19's B=2: 2, 2 x 63 and 2 x 1500); xlstm's sLSTM
    # w_in and its 768-wide projections (B=8,
    # 8 x 512); internvl's q/o, k/v and MLP (B=2, 2 x 1088)
    cases += [(k, n, False, bf16, (4, 2048)) for k, n in
              ((4096, 8192), (8192, 4096), (4096, 4096), (4096, 1024),
               (4096, 14336), (14336, 4096))]
    cases += [(k, n, False, bf16, (2, 4, 126, 256, 3000, 6000)) for k, n in
              ((1280, 1280), (1280, 5120), (5120, 1280))]
    cases += [(k, n, False, bf16, (8, 4096)) for k, n in
              ((768, 3072), (768, 768))]
    cases += [(k, n, False, bf16, (2, 2176)) for k, n in
              ((8192, 8192), (8192, 1024), (8192, 28672), (28672, 8192))]
    # internlm2-1.8b's projections as one rank of a tp = 2 mesh holds them
    # (phase 16): k/v N 512, attention wo K 1024, gate/up N 4096, the MLP's
    # wo K 4096 (q's 2048 x 1024 is above), decode, packed-prefill M
    cases += [(k, n, False, bf16, TP2_M) for k, n in TP2_SHAPES[1:]]
    # phase 20's 100m preset (qwen-style, d=768): q/k/v/o (q, k, v with
    # their bias), gate/up, down at its serve's decode M (4 prompts) and
    # prefill M (4 x 16)
    cases += [(k, n, False, bf16, E2E_M) for k, n in E2E_SHAPES]
    biased = {(2048, 1024, 8), (1024, 1024, 8), (768, 768, 4)}
    rows, worst = [], 0.0
    for k, n, kb, xdt, ms_ in cases:
        packed, scales = rand_packed(torch, gen, k, n, kb, device)
        w = ref.dequant_ref(packed, scales, kblocked=kb).to(xdt)
        for m in ms_:
            x = torch.randn((m, k), generator=gen, device=device).to(xdt)
            bias = (torch.randn((n,), generator=gen, device=device)
                    if (k, n, m) in biased else None)
            y = ops.msb_matmul(x, packed, scales, bias, kblocked=kb)
            y_ref = ref.msb_matmul_ref(x, packed, scales, bias, kblocked=kb)
            torch.cuda.synchronize()
            err = (y.float() - y_ref.float()).abs().max().item()
            scale = y_ref.float().abs().max().item()
            tol = (1e-2 if xdt == torch.bfloat16 else 1e-5) * scale
            if not err <= tol:
                fail(f"msb_matmul M={m} K={k} N={n} kblocked={kb}: max err "
                     f"{err} > {tol}")
            worst = max(worst, err / max(scale, 1e-30))
            if m == 4096 or (ms_ == TP2_M and m == 512):
                for mm in (1, 8, 17, 512):
                    if mm >= m:
                        continue
                    alone = ops.msb_matmul(x[:mm].contiguous(), packed, scales)
                    if not torch.equal(alone, y[:mm]):
                        fail(f"msb_matmul K={k} N={n}: rows at M={mm} differ "
                             f"from the same rows at M={m}")
            ms, ms_mean = timer.stats(lambda: ops.msb_matmul(
                x, packed, scales, bias, kblocked=kb))
            plain = timer(lambda: ref.msb_matmul_ref(x, packed, scales, bias,
                                                     kblocked=kb),
                          reps=2 if m >= 2048 else 3, warmup=1)
            lib, _ = timer.stats(lambda: torch.matmul(x, w))
            xb = x.element_size()
            nbytes = (m * k * xb + k * n // 2 + scales.numel() * 4
                      + m * n * xb + (n * 4 if bias is not None else 0))
            b_ms, b_by = bound(nbytes, 2.0 * m * k * n, str(xdt)[6:])
            row = dict(shape=f"M={m} K={k} N={n} "
                       f"{'k-blocked f32' if kb else 'n-blocked bf16'}"
                       f"{' +bias' if bias is not None else ''}",
                       m=m, k=k, n=n, max_abs_err=err, ms=ms, plain_ms=plain,
                       library_ms=lib, bound_ms=b_ms, bound_by=b_by)
            rows.append(row)
            log(f"  msb_matmul {row['shape']}: err {err:.3g} (tol {tol:.3g}) "
                f"kernel {ms:.4f} ms median of 20 (mean {ms_mean:.4f}) | "
                f"plain {plain:.4f} | library {lib:.4f} | bound {b_ms:.4f} "
                f"({b_by}), {100 * b_ms / ms:.1f} % of it reached")
        del packed, scales, w
    rows += msb_matmul_experts_cases(torch, timer, device, gen)
    log(f"[msb_matmul] {len(rows)} shapes agree with the plain version "
        f"(worst err/max|ref| {worst:.3g}); rows at M = 1, 8, 17, 512 "
        "bit-identical to the same rows at M=4096 (at the tp = 2 shard "
        "shapes rows at M = 1, 8, 17 to those at M=512); every expert of "
        "the expert batch bit-identical to msb_matmul on it alone")
    return rows


# internlm2-1.8b's projections at tp = 2, (K, N) of one rank's slice: q,
# k/v, attention wo, gate/up, the MLP's wo; and the M they are checked at
TP2_SHAPES = [(2048, 1024), (2048, 512), (1024, 2048), (2048, 4096),
              (4096, 2048)]
TP2_M = (1, 8, 512)
# the 100m preset's projections (K, N): attention, gate/up, down; the M
# its serve runs them at
E2E_SHAPES = [(768, 768), (768, 2048), (2048, 768)]
E2E_M = (4, 64)

# the unembedding's tables: (name, V, D, k-blocked, table dtype) —
# internlm2-1.8b's, jamba-v0.1-52b's and internvl2-76b's untied tables,
# gemma2-2b's, qwen1.5-0.5b's, xlstm-125m's and whisper-large-v3's tied
# ones, one rank's half of internlm2's at tp = 2 (92672 / 2 columns), and
# the tied f32 table of phase 20's 100m preset
UNEMBED_TABLES = [("internlm2", 92672, 2048, True, "float32"),
                  ("internlm2_tp2", 46336, 2048, True, "float32"),
                  ("jamba", 65536, 4096, True, "float32"),
                  ("internvl", 128256, 8192, True, "float32"),
                  ("gemma2", 256000, 2304, False, "bfloat16"),
                  ("qwen", 151936, 1024, False, "bfloat16"),
                  ("xlstm", 50432, 768, False, "bfloat16"),
                  ("whisper", 51968, 1280, False, "bfloat16"),
                  ("e2e_100m", 32000, 768, False, "float32")]


def phase_msb_unembed(torch, timer, device):
    """The unembedding's kernel against its plain version at the tables
    the engines serve (``UNEMBED_TABLES``), M = 1, 2, 4, 8 and 64 (every
    row tile ``unembed_plan`` takes: 1, 2, 4 and 8), each within 1e-5 of
    the plain result's largest value; rows at M < 64 bit-identical to the
    same rows at M = 64. Kernel and library
    (``torch.matmul`` of x against the pre-dequantized f32 table,
    transposed for the tied layout) are medians of 20 cold launches; the
    plain version 2 launches."""
    from repro_torch.core.quantize import PackedQTensor
    from repro_torch.kernels.msb_matmul import ops, ref
    gen = torch.Generator(device=device).manual_seed(2)
    rows = []
    for name, v, d, kb, dt in UNEMBED_TABLES:
        packed, scales = rand_packed(torch, gen, d if kb else v,
                                     v if kb else d, kb, device)
        pq = PackedQTensor(packed, scales, 4, 64, getattr(torch, dt),
                           v if kb else d, kblocked=kb)
        w = pq.dequantize().to(torch.float32)      # (D, V) or (V, D)
        wt = w if kb else w.t()
        x = torch.randn((64, d), generator=gen, device=device)
        y64 = ops.msb_unembed(x, pq)
        for m in (1, 2, 4, 8, 64):
            xm = x[:m].contiguous()
            y = ops.msb_unembed(xm, pq)
            y_ref = ref.msb_unembed_ref(xm, pq)
            torch.cuda.synchronize()
            err = (y - y_ref).abs().max().item()
            tol = 1e-5 * y_ref.abs().max().item()
            if not err <= tol:
                fail(f"msb_unembed {name} M={m}: max err {err} > {tol}")
            if not torch.equal(y, y64[:m]):
                fail(f"msb_unembed {name}: rows at M={m} differ from the "
                     "same rows at M=64")
            ms, ms_mean = timer.stats(lambda: ops.msb_unembed(xm, pq))
            plain = timer(lambda: ref.msb_unembed_ref(xm, pq), reps=2,
                          warmup=1)
            lib, _ = timer.stats(lambda: torch.matmul(xm, wt))
            nbytes = d * v // 2 + d // 64 * v * 8 * 4 + m * d * 4 + m * v * 4
            b_ms, b_by = bound(nbytes, 2.0 * m * d * v, "float32")
            row = dict(shape=f"{name} M={m} D={d} V={v} "
                       f"{'k-blocked' if kb else 'tied'} {dt} table",
                       table=name, m=m, max_abs_err=err, ms=ms,
                       plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                       bound_by=b_by)
            rows.append(row)
            log(f"  msb_unembed {row['shape']}: err {err:.3g} (tol "
                f"{tol:.3g}) kernel {ms:.4f} ms median of 20 (mean "
                f"{ms_mean:.4f}) | plain {plain:.4f} | library "
                f"(torch.matmul, f32 table) {lib:.4f} | bound {b_ms:.4f} "
                f"({b_by}), {100 * b_ms / ms:.1f} % of it reached")
        del packed, scales, pq, w, wt, x, y64
        torch.cuda.empty_cache()
    log(f"[msb_unembed] {len(rows)} shapes agree with the plain version "
        "(1e-5 of its largest value); rows at M = 1, 2, 4 and 8 "
        "bit-identical to the same rows at M=64")
    return rows


def expert_counts(torch, gen, tokens, k, n_real, e_total, capacity, device):
    """Routed tokens per expert as top-k routing of ``tokens`` random
    tokens over ``n_real`` of ``e_total`` experts gives them (each token
    k distinct experts), capped at ``capacity``: int32 (e_total,), zeros
    included (padded experts always)."""
    logits = torch.rand((tokens, n_real), generator=gen, device=device)
    idx = torch.topk(logits, k, dim=-1).indices.reshape(-1)
    counts = torch.zeros(e_total, dtype=torch.int32, device=device)
    counts.index_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))
    return torch.clamp(counts, max=capacity)


# the expert batch's shapes: (model, padded experts, routed experts, top-k,
# d_model, d_ff, [(capacity C, tokens)]) — granite-moe-3b-a800m at a decode
# step and a 512-token packed-prefill wave, jamba-v0.1-52b at a B=8 decode
EXPERT_SHAPES = [("granite-moe", 48, 40, 8, 1536, 512, ((8, 8), (112, 512))),
                 ("jamba", 16, 16, 2, 4096, 14336, ((8, 8),))]


def msb_matmul_experts_cases(torch, timer, device, gen):
    """Kernel A's expert batch at ``EXPERT_SHAPES``: the gate/up direction
    (K=d_model, N=d_ff) and the down direction (K=d_ff, N=d_model), routed
    counts with zeros (granite-moe: 48 padded experts of which 40 route,
    top-8; capacity 8 at a decode step, 112 at a 512-token wave; jamba: 16
    experts, top-2, a B=8 decode step at capacity 8). Every expert bit for
    bit ``msb_matmul`` on it alone; against the plain version (a loop of
    ``msb_matmul_ref``) within 1e-2 relative. Library: a loop of
    ``torch.matmul`` over the routed experts' pre-dequantized weights.
    Bound: the routed experts' x and weights read once, every expert's
    output written once. Prints each launch's tile, cluster and ptxas
    registers (``expert_launch``)."""
    from repro_torch.kernels.msb_matmul import ops, ref
    rows = []
    for model, e, n_real, topk, dm, df, waves in EXPERT_SHAPES:
        for c, tokens in waves:
            rows += expert_shape_cases(torch, timer, device, gen, model, e,
                                       n_real, topk, dm, df, c, tokens, ops,
                                       ref)
    return rows


def expert_launch(ops, c, k, n):
    """How the expert batch launches at (C, K, N): the cluster kernel's
    tile, cluster and splits a block, with ptxas's registers and spills
    for that kernel (from this process's build), or the tile of
    ``msb_matmul``'s kernel it runs past 128 rows (and in a package older
    than the cluster kernel, as ``chip_compare.py`` runs a parent)."""
    from repro_torch.kernels import _build
    if not hasattr(ops, "experts_plan"):
        p = ops.plan(c, k, n)
        return (f"msb_matmul's {p.bm} x {p.bn} tile, {p.grid_splits} "
                "splits on separate blocks (this package has no cluster "
                "kernel)")
    p = ops.experts_plan(c, k, n)
    if not isinstance(p, ops.ExpertPlan):
        return (f"msb_matmul's {p.bm} x {p.bn} tile, {p.splits} splits "
                "walked by one block")
    tag = f"TileILi{p.bm}ELi{p.bn}E"
    ptx = [r for r in _build.ptxas_report("msb_matmul")
           if "msb_experts_kernel" in r["kernel"] and tag in r["kernel"]
           and "ELb0E" in r["kernel"]]
    regs = (f"{ptx[0]['registers']} registers, spills "
            f"{ptx[0]['spill_stores']} B stored / {ptx[0]['spill_loads']} B "
            "loaded" if ptx else "no ptxas report in this process")
    return (f"cluster kernel, tile {p.bm} x {p.bn}, clusters of {p.cluster} "
            f"blocks, {p.walk} of {p.splits} K splits a block, "
            f"{'persistent clusters' if p.persist else 'one item a cluster'}, "
            f"{p.smem} B shared; {regs}")


def expert_shape_cases(torch, timer, device, gen, model, e, n_real, topk,
                       dm, df, c, tokens, ops, ref):
    """Both directions of one model's expert batch at capacity ``c``."""
    rows = []
    counts = expert_counts(torch, gen, tokens, topk, n_real, e, c, device)
    live = [i for i in range(e) if int(counts[i]) > 0]
    for k, n in ((dm, df), (df, dm)):
        log(f"  msb_matmul_experts {model} C={c} K={k} N={n}: "
            f"{expert_launch(ops, c, k, n)}")
        packed = torch.randint(0, 256, (e, k, n // 2), generator=gen,
                               device=device, dtype=torch.int32).to(
                                   torch.uint8)
        scales = torch.sort(torch.rand((e, k, n // 64, 8), generator=gen,
                                       device=device) * 0.05,
                            dim=-1).values.contiguous()
        x = torch.randn((e, c, k), generator=gen, device=device).to(
            torch.bfloat16)
        y = ops.msb_matmul_experts(x, packed, scales, counts)
        y_ref = ref.msb_matmul_experts_ref(x, packed, scales, counts)
        torch.cuda.synchronize()
        err = (y.float() - y_ref.float()).abs().max().item()
        scale = y_ref.float().abs().max().item()
        if not err <= 1e-2 * scale:
            fail(f"msb_matmul_experts {model} C={c} K={k} N={n}: max err "
                 f"{err}")
        for i in range(e):
            if i not in live:
                if y[i].abs().max().item() != 0.0:
                    fail(f"msb_matmul_experts: expert {i} with count 0 "
                         "is not exactly 0")
            elif not torch.equal(y[i], ops.msb_matmul(
                    x[i].contiguous(), packed[i], scales[i])):
                fail(f"msb_matmul_experts C={c} K={k} N={n}: expert {i}"
                     " differs from msb_matmul on it alone")
        ws = {i: ref.dequant_ref(packed[i], scales[i]).to(torch.bfloat16)
              for i in live}
        ms, ms_mean = timer.stats(lambda: ops.msb_matmul_experts(
            x, packed, scales, counts))
        plain = timer(lambda: ref.msb_matmul_experts_ref(
            x, packed, scales, counts), reps=2, warmup=1)
        lib, _ = timer.stats(lambda: [torch.matmul(x[i], ws[i])
                                      for i in live])
        del ws
        # unrouted experts' x and weights are never read; their zero
        # outputs are written
        nbytes = (len(live) * (c * k * 2 + k * n // 2 + k * n // 8 * 4)
                  + e * c * n * 2 + e * 4)
        b_ms, b_by = bound(nbytes, 2.0 * c * k * n * len(live),
                           "bfloat16")
        row = dict(shape=f"{model} experts E={e} ({len(live)} routed) "
                   f"C={c} K={k} N={n} n-blocked bf16", experts=True,
                   model=model, m=c, k=k, n=n, max_abs_err=err, ms=ms,
                   plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                   bound_by=b_by)
        rows.append(row)
        log(f"  msb_matmul_experts {row['shape']}: err {err:.3g} kernel "
            f"{ms:.4f} ms median of 20 (mean {ms_mean:.4f}) | plain "
            f"{plain:.4f} | library (torch.matmul loop over routed "
            f"experts) {lib:.4f} | bound {b_ms:.4f} ({b_by}), "
            f"{100 * b_ms / ms:.1f} % of it reached")
        del packed, scales, x
    return rows


def kv16_pools(torch, gen, lens, device, h=16, kv=8, d=128, ps=16,
               width=None, dtype=None):
    """Random pools (bf16 unless ``dtype``), block tables ``width`` pages
    wide (default: the longest row's), each row on its own pages, and
    queries of the same dtype."""
    dtype = dtype or torch.bfloat16
    b = len(lens)
    width = width or max(1, -(-max(lens) // ps))
    n_pages = 1 + b * width
    k_pool = torch.randn((n_pages, ps, kv, d), generator=gen,
                         device=device).to(dtype)
    v_pool = torch.randn((n_pages, ps, kv, d), generator=gen,
                         device=device).to(dtype)
    perm = torch.randperm(n_pages - 1, generator=gen, device=device) + 1
    bt = perm[:b * width].reshape(b, width).to(torch.int32)
    kv_lens = torch.tensor(lens, dtype=torch.int32, device=device)
    q = torch.randn((b, h, d), generator=gen, device=device).to(dtype)
    return q, k_pool, v_pool, bt, kv_lens


def phase_paged_attention(torch, timer, device):
    """Kernel B against its plain version on full-width bf16 pools (one
    row of 2048 keys; the decode shape, rows of 0-2048 keys), at one tp = 2
    rank's heads and on the f32 pools of phase 20's smoke engines (page
    sizes 4 and 8, d=16), every row bit-identical alone and in the batch,
    then the 512-token packed-prefill wave kv16 prefill launches. Kernel
    and SDPA: medians of 20."""
    from repro_torch.kernels.paged_attention import ops, ref
    gen = torch.Generator(device=device).manual_seed(2)
    decode = [0, 1, 17, 100, 513, 1000, 1999, 2048]
    bf16, f32 = torch.bfloat16, torch.float32
    rows = []
    # (heads, KV heads, head_dim, page size, dtype, lens): the decode
    # shape, one rank's heads at tp = 2 (phase 16), and phase 20's
    # serve_api engine (smoke internlm2, f32, page size 4, max_seq 128)
    # and serve_quantized's (smoke gemma2, page size 8, max_seq 40)
    for h, kv, d, ps, dt, lens in (
            (16, 8, 128, 16, bf16, [2048]), (16, 8, 128, 16, bf16, decode),
            (8, 4, 128, 16, bf16, decode),
            (4, 2, 16, 4, f32, [0, 1, 5, 17, 33, 64, 100, 128]),
            (4, 2, 16, 8, f32, [1, 9, 12, 20, 36, 40])):
        b = len(lens)
        q, k_pool, v_pool, bt, kv_lens = kv16_pools(
            torch, gen, lens, device, h=h, kv=kv, d=d, ps=ps, dtype=dt)
        for softcap in (0.0, 30.0):
            out = ops.paged_attention_decode(q, k_pool, v_pool, bt, kv_lens,
                                             softcap=softcap)
            out_ref = ref.paged_attention_decode_ref(q, k_pool, v_pool, bt,
                                                     kv_lens, softcap=softcap)
            torch.cuda.synchronize()
            err = (out.float() - out_ref.float()).abs().max().item()
            if not err <= 2e-2:
                fail(f"paged_attention B={b} lens={lens} softcap={softcap}: "
                     f"max err {err} > 2e-2")
            zero = [i for i, n in enumerate(lens) if n == 0]
            if zero and out[zero].abs().max().item() != 0.0:
                fail("paged_attention: zero-length rows are not exactly 0")
        # a row's bits do not depend on the rest of the batch
        for i, n in enumerate(lens):
            w = max(1, -(-n // ps))
            alone = ops.paged_attention_decode(
                q[i:i + 1].contiguous(), k_pool, v_pool,
                bt[i:i + 1, :w].contiguous(), kv_lens[i:i + 1].contiguous(),
                softcap=30.0)
            if not torch.equal(alone[0], out[i]):
                fail(f"paged_attention: the row of {n} keys differs alone "
                     "and in the batch")
        ms, ms_mean = timer.stats(lambda: ops.paged_attention_decode(
            q, k_pool, v_pool, bt, kv_lens))
        plain = timer(lambda: ref.paged_attention_decode_ref(
            q, k_pool, v_pool, bt, kv_lens), reps=3)
        # library yardstick: one SDPA call on the pre-gathered cache
        s = max(lens)
        kg = k_pool[bt.long()].reshape(b, -1, kv, d)[:, :s].transpose(1, 2)
        vg = v_pool[bt.long()].reshape(b, -1, kv, d)[:, :s].transpose(1, 2)
        kg, vg = kg.contiguous(), vg.contiguous()
        mask = (torch.arange(s, device=device)[None, :]
                < kv_lens[:, None])[:, None, None, :]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib, lib_mean = timer.stats(lambda: sdpa(
            q[:, :, None], kg, vg, attn_mask=mask, enable_gqa=True))
        del kg, vg
        tokens = sum(lens)
        el = q.element_size()
        nbytes = (2 * tokens * kv * d * el + q.numel() * 2 * el
                  + sum(-(-n // ps) for n in lens) * 4 + b * 4)
        b_ms, b_by = bound(nbytes, 4.0 * tokens * h * d, str(dt)[6:])
        row = dict(shape=f"B={b} H={h} KV={kv} d={d} ps={ps} "
                   f"{str(dt)[6:]} kv_lens={lens}", max_abs_err=err, ms=ms,
                   plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                   bound_by=b_by, tp2=(h, kv) == (8, 4), ps4=ps == 4,
                   ps8=ps == 8)
        rows.append(row)
        log(f"  paged_attention {row['shape']}: err {err:.3g} kernel "
            f"{ms:.4f} ms median of 20 (mean {ms_mean:.4f}) | plain "
            f"{plain:.4f} | library (SDPA, pre-gathered) {lib:.4f} median "
            f"(mean {lib_mean:.4f}) | bound {b_ms:.4f} ({b_by}), "
            f"{100 * b_ms / ms:.1f} % of it reached")
    # the packed-prefill wave: pools of three segments, tables 64 pages
    q, k_pool, v_pool, bt, _ = kv16_pools(torch, gen, [128, 384, 256],
                                          device, width=64)
    packed_prefill_case(torch, timer, device, gen, ops, ref, 16,
                        (k_pool, v_pool), bt, 16)
    del q, k_pool, v_pool
    rows += window_cases(torch, timer, device, gen, 16)
    log(f"[paged_attention] {len(rows)} cases agree with the plain version "
        "(tol 2e-2 abs; with a window also every row within 1e-2 of its "
        "largest value; zero-length rows exactly 0; every row bit-identical "
        "alone and in the batch, with and without a window); packed-prefill "
        "wave checked")
    return rows


# gemma2-2b's attention (8 heads, 4 KV heads, head_dim 256, softcap 50) over
# rows up to 8192 keys, for kernels B and C with its 4096-token window
WINDOW_LENS = [0, 1, 17, 4095, 4097, 4200, 6000, 8192]
# Windowed cases hold each output row (one head of one query) within this
# share of its own largest |value|: a row over ~4096 keys has values near
# 0.03, so an absolute tolerance fit for the short rows' O(1) values would
# pass a window off by a page there. One bf16 ulp of the row's largest
# value is at most 2**-7 of it.
ROW_REL_TOL = 1e-2


def row_rel_err(torch, out, ref):
    """Worst over rows (the last axis) of max |out - ref| / max |ref|; a
    row whose reference is all 0 must be 0 (else the ratio is inf)."""
    o, r = out.float(), ref.float()
    err, top = (o - r).abs().amax(-1), r.abs().amax(-1)
    ratio = torch.where(top > 0, err / torch.clamp(top, min=1e-30),
                        torch.where(err > 0, float("inf"), 0.0))
    return ratio.max().item()


def window_cases(torch, timer, device, gen, bits):
    """Kernel B (bits 16) or C (8, 4) with a sliding window, as gemma2's
    local layers decode: each row's first visible key ``kv_len - window``
    (windows 4096 and 4100, not a multiple of the page size; most starts
    fall mid-page), d=256, KV=4, H=8, softcap 50, rows of 0-8192 keys.
    Against the plain version given the same starts (tol 2e-2 abs, and
    every row within ``ROW_REL_TOL`` of its largest value), pad
    rows exactly 0, every row bit-identical alone (a block table only as
    wide as it needs) and in the batch. Timed at window 4096 (median of
    20); library: SDPA with the window's mask on the pre-gathered (C:
    pre-dequantized) cache; bound: the visible keys' bytes."""
    from repro_torch.core.quantize import KVQuantSpec
    from repro_torch.kernels.paged_attention import ops, ref
    h, kv, d, ps, softcap = 8, 4, 256, 16, 50.0
    lens, b = WINDOW_LENS, len(WINDOW_LENS)
    width = max(lens) // ps
    q = torch.randn((b, h, d), generator=gen, device=device).to(
        torch.bfloat16)
    perm = torch.randperm(b * width, generator=gen, device=device) + 1
    bt = perm.reshape(b, width).to(torch.int32)
    kv_lens = torch.tensor(lens, dtype=torch.int32, device=device)
    if bits == 16:
        pools = [torch.randn((1 + b * width, ps, kv, d), generator=gen,
                             device=device).to(torch.bfloat16)
                 for _ in "kv"]
        tail, kw, name = (), {}, "paged_attention kv16"
        run, plain = ops.paged_attention_decode, ref.paged_attention_decode_ref
    else:
        pools, spec = rand_quant_pools(torch, gen, bits, 1 + b * width, b + 1,
                                       ps, kv, d, device)
        tail = (torch.arange(1, b + 1, dtype=torch.int32, device=device),)
        kw, name = dict(kv_bits=bits), f"paged_attention_quant kv{bits}"
        run = ops.paged_attention_decode_quant
        plain = ref.paged_attention_decode_quant_ref
    rows = []
    for window in (4100, 4096):
        starts = torch.clamp(kv_lens - window, min=0)
        args = (q, *pools, bt, kv_lens, *tail)
        kw_w = dict(kw, kv_start=starts, softcap=softcap)
        out = run(*args, **kw_w)
        out_ref = plain(*args, **kw_w)
        torch.cuda.synchronize()
        err = (out.float() - out_ref.float()).abs().max().item()
        rel = row_rel_err(torch, out, out_ref)
        if not (err <= 2e-2 and rel <= ROW_REL_TOL):
            fail(f"{name} window {window}: max err {err} (tol 2e-2), worst "
                 f"row err / max|row| {rel} (tol {ROW_REL_TOL})")
        log(f"  {name} window {window}: max err {err:.3g}, worst row err "
            f"/ max|row| {rel:.3g} (tol {ROW_REL_TOL})")
        if out[0].abs().max().item() != 0.0:
            fail(f"{name} window {window}: the zero-length row is not 0")
        for i, n in enumerate(lens):
            w = max(1, -(-n // ps))
            alone = run(q[i:i + 1].contiguous(), *pools,
                        bt[i:i + 1, :w].contiguous(),
                        kv_lens[i:i + 1].contiguous(),
                        *(t[i:i + 1].contiguous() for t in tail),
                        **dict(kw, kv_start=starts[i:i + 1].contiguous(),
                               softcap=softcap))
            if not torch.equal(alone[0], out[i]):
                fail(f"{name} window {window}: the row of {n} keys differs "
                     "alone and in the batch")
    # timed at gemma2's window
    ms, ms_mean = timer.stats(lambda: run(*args, **kw_w))
    plain_ms = timer(lambda: plain(*args, **kw_w), reps=3)
    s = max(lens)
    if bits == 16:
        kg = pools[0][bt.long()].reshape(b, -1, kv, d)[:, :s]
        vg = pools[1][bt.long()].reshape(b, -1, kv, d)[:, :s]
    else:
        n_full = kv_lens // ps
        kg = ref.quant_gather(pools[0], pools[1], pools[4], bt, n_full,
                              tail[0], bits)[:, :s]
        vg = ref.quant_gather(pools[2], pools[3], pools[5], bt, n_full,
                              tail[0], bits)[:, :s]
    kg, vg = kg.transpose(1, 2).contiguous(), vg.transpose(1, 2).contiguous()
    kpos = torch.arange(s, device=device)[None, :]
    mask = ((kpos < kv_lens[:, None]) & (kpos >= starts[:, None]))[
        :, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib, lib_mean = timer.stats(lambda: sdpa(
        q[:, :, None], kg, vg, attn_mask=mask, enable_gqa=True))
    del kg, vg
    visible = [n - int(st) for n, st in zip(lens, starts.tolist())]
    nbytes = q.numel() * 2 * 2 + b * 4 * 3
    for n, st in zip(lens, starts.tolist()):
        pages = -(-n // ps) - st // ps if n else 0
        nbytes += pages * 4
        if bits == 16:
            nbytes += 2 * kv * (n - st) * d * 2
        else:
            committed = max(0, (n // ps) * ps - st)
            dc = spec.codes_tail[-1]
            sb = 4 if bits == 8 else 2
            groups = -(-committed // spec.tokens_per_block)
            nbytes += 2 * kv * (committed * dc + groups * spec.n_levels * sb
                                + (n - st - committed) * d * 2)
    b_ms, b_by = bound(nbytes, 4.0 * sum(visible) * h * d, "bfloat16")
    row = dict(bits=bits, window=True, shape=f"window 4096 B={b} "
               f"H={h} KV={kv} d={d} ps={ps} softcap 50 bf16 kv_lens={lens}",
               max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib,
               bound_ms=b_ms, bound_by=b_by)
    rows.append(row)
    log(f"  {name} {row['shape']}: err {err:.3g} kernel {ms:.4f} ms median "
        f"of 20 (mean {ms_mean:.4f}) | plain {plain_ms:.4f} | library (SDPA "
        f"with the window's mask, pre-gathered) {lib:.4f} median (mean "
        f"{lib_mean:.4f}) | bound {b_ms:.4f} ({b_by}), "
        f"{100 * b_ms / ms:.1f} % of it reached; windows 4100 and 4096 "
        "checked, rows bit-identical alone")
    del pools
    return rows


def rand_quant_pools(torch, gen, bits, n_pages, n_hot, ps, kv, d, device):
    """Random codes and codebooks of quantized pools in the layout of
    ``KVQuantSpec`` (sorted positive bf16 codebooks at 4 bits, positive
    f32 absmax at 8), and random bf16 hot rows."""
    from repro_torch.core.quantize import KVQuantSpec
    spec = KVQuantSpec(bits, ps, kv, d)
    out = []
    for _ in ("k", "v"):
        codes = torch.randint(0, 256, (n_pages,) + spec.codes_tail,
                              generator=gen, device=device,
                              dtype=torch.int32).to(torch.uint8)
        codes = codes.view(spec.code_dtype)
        if bits == 8:
            codes = torch.clamp(codes, min=-127)
        sc = torch.rand((n_pages,) + spec.scales_tail, generator=gen,
                        device=device) * 3.0
        sc = torch.sort(sc, dim=-1).values.to(spec.scale_dtype)
        out += [codes.contiguous(), sc.contiguous()]
    for _ in ("k", "v"):
        out.append(torch.randn((n_hot, ps, kv, d), generator=gen,
                               device=device).to(torch.bfloat16))
    return out, spec


def phase_paged_attention_quant(torch, timer, device):
    from repro_torch.kernels.paged_attention import ops, ref
    gen = torch.Generator(device=device).manual_seed(3)
    d, ps = 128, 16
    lens = [0, 1, 17, 100, 513, 1000, 1999, 2048]
    b = len(lens)
    max_pages = 2048 // ps
    n_pages = 1 + b * max_pages
    rows = []
    # (bits, heads, KV heads): the decode shape at kv8 and kv4, and one
    # rank's heads at tp = 2 (phase 16) at kv4
    for bits, h, kv in ((8, 16, 8), (4, 16, 8), (4, 8, 4)):
        (kc, ks, vc, vs, kh, vh), spec = rand_quant_pools(
            torch, gen, bits, n_pages, b + 1, ps, kv, d, device)
        perm = torch.randperm(n_pages - 1, generator=gen, device=device) + 1
        bt = perm[:b * max_pages].reshape(b, max_pages).to(torch.int32)
        kv_lens = torch.tensor(lens, dtype=torch.int32, device=device)
        hot_rows = torch.arange(1, b + 1, dtype=torch.int32, device=device)
        q = torch.randn((b, h, d), generator=gen,
                        device=device).to(torch.bfloat16)
        args = (q, kc, ks, vc, vs, kh, vh, bt, kv_lens, hot_rows)
        err = 0.0
        for softcap in (0.0, 30.0):
            out = ops.paged_attention_decode_quant(*args, kv_bits=bits,
                                                   softcap=softcap)
            out_ref = ref.paged_attention_decode_quant_ref(
                *args, kv_bits=bits, softcap=softcap)
            torch.cuda.synchronize()
            e = (out.float() - out_ref.float()).abs().max().item()
            if not e <= 2e-2:
                fail(f"paged_attention_quant kv{bits} lens={lens} softcap="
                     f"{softcap}: max err {e} > 2e-2")
            if out[0].abs().max().item() != 0.0:
                fail("paged_attention_quant: zero-length rows are not "
                     "exactly 0")
            err = max(err, e)
        # a row's bits do not depend on the rest of the batch (split
        # boundaries by page index alone): each row alone, with a block
        # table only as wide as it needs, equals its row in the batch
        for i, n in enumerate(lens):
            w = max(1, -(-n // ps))
            alone = ops.paged_attention_decode_quant(
                q[i:i + 1].contiguous(), kc, ks, vc, vs, kh, vh,
                bt[i:i + 1, :w].contiguous(), kv_lens[i:i + 1].contiguous(),
                hot_rows[i:i + 1].contiguous(), kv_bits=bits,
                softcap=30.0)
            if not torch.equal(alone[0], out[i]):
                fail(f"paged_attention_quant kv{bits}: the row of {n} keys "
                     "differs alone and in the batch")
        ms, ms_mean = timer.stats(lambda: ops.paged_attention_decode_quant(
            *args, kv_bits=bits))
        plain = timer(lambda: ref.paged_attention_decode_quant_ref(
            *args, kv_bits=bits), reps=3)
        # library yardstick: one SDPA call on a pre-dequantized, pre-gathered
        # cache (the dequant and gather are not timed)
        s = max(lens)
        n_full = kv_lens // ps
        kg = ref.quant_gather(kc, ks, kh, bt, n_full, hot_rows, bits)
        vg = ref.quant_gather(vc, vs, vh, bt, n_full, hot_rows, bits)
        kg = kg[:, :s].transpose(1, 2).contiguous()
        vg = vg[:, :s].transpose(1, 2).contiguous()
        mask = (torch.arange(s, device=device)[None, :]
                < kv_lens[:, None])[:, None, None, :]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib, lib_mean = timer.stats(lambda: sdpa(
            q[:, :, None], kg, vg, attn_mask=mask, enable_gqa=True))
        del kg, vg
        # bytes the function needs: committed positions as codes (+ one
        # codebook row per touched group), frontier positions from the bf16
        # hot rows, q, out, the used block-table entries and the lengths
        dc = spec.codes_tail[-1]
        sb = 4 if bits == 8 else 2
        nbytes = q.numel() * 2 * 2 + b * 4 * 2
        for n in lens:
            committed = min(n, (n // ps) * ps)
            groups = -(-committed // spec.tokens_per_block)
            nbytes += 2 * kv * (committed * dc + groups * spec.n_levels * sb
                                + (n - committed) * d * 2)
            nbytes += -(-n // ps) * 4
        b_ms, b_by = bound(nbytes, 4.0 * sum(lens) * h * d, "bfloat16")
        row = dict(bits=bits, shape=f"kv{bits} B={b} H={h} KV={kv} d={d} "
                   f"ps={ps} bf16 hot kv_lens={lens}", max_abs_err=err,
                   ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                   bound_by=b_by, tp2=kv == 4)
        rows.append(row)
        log(f"  paged_attention_quant {row['shape']}: err {err:.3g} kernel "
            f"{ms:.4f} ms median of 20 (mean {ms_mean:.4f}) | plain "
            f"{plain:.4f} | library (SDPA, pre-dequantized pre-gathered) "
            f"{lib:.4f} median (mean {lib_mean:.4f}) | bound {b_ms:.4f} "
            f"({b_by}), {100 * b_ms / ms:.1f} % of it reached")
        if kv == 8:
            packed_prefill_case(torch, timer, device, gen, ops, ref, bits,
                                (kc, ks, vc, vs, kh, vh), bt, ps)
        del args, kc, ks, vc, vs, kh, vh
    for bits in (8, 4):
        rows += window_cases(torch, timer, device, gen, bits)
    log(f"[paged_attention_quant] {len(rows)} cases agree with the plain "
        "version (tol 2e-2 abs; with a window also every row within 1e-2 "
        "of its largest value; zero-length rows exactly 0; every row "
        "bit-identical alone and in the batch, with and without a window)")
    return rows


def packed_prefill_case(torch, timer, device, gen, ops, ref, bits, pools,
                        bt, ps, width=64):
    """Kernel B (bits 16) or C (8, 4) as packed prefill launches it: a
    512-token wave of three segments (positions 0-127 of a new prompt,
    256-383 of one being continued, 0-255), one row per token with its
    causal bound (and, quantized, its segment's frontier page), block-table
    rows ``width`` pages wide (the serving phases' max_seq 1024). Checked
    against the plain version and timed (median of 20); the grid and the
    f32 scratch it needs are logged."""
    h, d = 16, 128
    chunks = [(0, 128), (256, 384), (0, 256)]
    seg = np.concatenate([np.full(e - s0, i) for i, (s0, e) in
                          enumerate(chunks)])
    pos = np.concatenate([np.arange(s0, e) for s0, e in chunks])
    frontier = np.array([e // ps for _, e in chunks])[seg]
    tseg = torch.from_numpy(seg).to(device)
    ints = [torch.from_numpy(a.astype(np.int32)).to(device)
            for a in (pos + 1, seg + 1, frontier)]
    q = torch.randn((len(pos), h, d), generator=gen,
                    device=device).to(torch.bfloat16)
    rows = bt[:len(chunks), :width][tseg].contiguous()
    if bits == 16:
        args = (q, *pools, rows, ints[0])
        run = lambda: ops.paged_attention_decode(*args)      # noqa: E731
        out_ref = ref.paged_attention_decode_ref(*args)
        name = "paged_attention kv16"
    else:
        args = (q, *pools, rows, ints[0], ints[1])
        run = lambda: ops.paged_attention_decode_quant(      # noqa: E731
            *args, kv_bits=bits, n_full=ints[2])
        out_ref = ref.paged_attention_decode_quant_ref(*args, kv_bits=bits,
                                                       n_full=ints[2])
        name = f"paged_attention_quant kv{bits}"
    out = run()
    e = (out.float() - out_ref.float()).abs().max().item()
    if not e <= 2e-2:
        fail(f"{name} packed prefill: max err {e} > 2e-2")
    ms, ms_mean = timer.stats(run)
    ns = ops.n_splits(width)
    log(f"  {name} packed prefill T={len(pos)} H={h} d={d} table {width} "
        f"pages: err {e:.3g} kernel {ms:.4f} ms median of 20 (mean "
        f"{ms_mean:.4f}); grid {len(pos)}x{h}x{ns}, scratch "
        f"{len(pos) * h * ns * (d + 2) * 4 / 1e6:.1f} MB")


def visible_pairs(sq, skv, causal, window, segs=None):
    """(query, key) pairs the mask lets through, summed over batch rows:
    the work that this run's inputs need."""
    qpos, kpos = np.arange(sq)[:, None], np.arange(skv)[None, :]
    mask = np.ones((sq, skv), bool)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    if segs is None:
        return int(mask.sum())
    return int(sum((mask & (row[:, None] == row[None, :])
                    & (row[:, None] >= 0)).sum() for row in segs))


def segments(b, s):
    """Three contiguous segments per row of different lengths, then 37 pad
    positions (-1)."""
    segs = np.full((b, s), -1, np.int32)
    for i in range(b):
        cuts = [0, 200 + 40 * i, 600 - 30 * i, s - 37]
        for j in range(3):
            segs[i, cuts[j]:cuts[j + 1]] = j
    return segs


def check_lse(torch, ops, name, q, k, v, sg, kw, out, lse_ref):
    """Kernel D with its log-sum-exp output: the output bitwise the same
    as without it, and each row's lse within 1e-5 of the largest |lse|
    (f32) or 1e-3 absolute (bf16 inputs) of the plain version's; rows that
    see no key (pads) equal it exactly."""
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    out2 = ops.flash_attention_fwd(q, k, v, *sg, lse=lse, **kw)
    if not torch.equal(out2, out):
        fail(f"flash_attention {name}: the output changed when lse was "
             "asked for")
    live = lse_ref > -1e30
    if not torch.equal(lse[~live], lse_ref[~live]):
        fail(f"flash_attention {name}: lse of rows that see no key")
    err = (lse - lse_ref)[live].abs().max().item()
    tol = (1e-3 if q.dtype == torch.bfloat16 else
           1e-5 * lse_ref[live].abs().max().item())
    if not err <= tol:
        fail(f"flash_attention {name}: lse err {err} > {tol}")
    log(f"  flash_attention {name} with lse: output bitwise, lse err "
        f"{err:.3g} (tol {tol:.3g})")


def phase_flash_attention(torch, timer, device):
    from repro_torch.kernels.flash_attention import ops, ref
    gen = torch.Generator(device=device).manual_seed(5)
    bf16, f32 = torch.bfloat16, torch.float32
    sdpa = torch.nn.functional.scaled_dot_product_attention
    cases = [  # name, B, H, KV, Sq, Skv, d, dtype, causal, window,
        # softcap, segs
        ("prefill B=8 S=512", 8, 16, 8, 512, 512, 128, bf16, True, 0, 0.0,
         False),
        ("B=1 S=2048", 1, 16, 8, 2048, 2048, 128, bf16, True, 0, 0.0, False),
        ("ragged B=8 S=300", 8, 16, 8, 300, 300, 128, bf16, True, 0, 0.0,
         False),
        ("window 512 softcap 50 B=1 S=2048", 1, 16, 8, 2048, 2048, 128,
         bf16, True, 512, 50.0, False),
        ("3 segments + pads B=2 S=1024", 2, 16, 8, 1024, 1024, 128, bf16,
         True, 0, 0.0, True),
        ("f32 d=16 B=2 S=300", 2, 4, 2, 300, 300, 16, f32, True, 0, 0.0,
         False),
        # gemma2-2b's static prefill: head_dim 256, window 4096, softcap 50
        ("gemma2 window 4096 softcap 50 B=2 S=4608", 2, 8, 4, 4608, 4608,
         256, bf16, True, 4096, 50.0, False),
        # whisper-large-v3 (head_dim 64): the encoder over 1500 frames, and
        # the decoder's 64-token prompt's cross-attention onto them; the
        # last key tile holds 28 of 64 rows
        ("whisper encoder B=4 S=1500", 4, 20, 20, 1500, 1500, 64, bf16,
         False, 0, 0.0, False),
        ("whisper cross B=4 Sq=64 Skv=1500", 4, 20, 20, 64, 1500, 64, bf16,
         False, 0, 0.0, False),
        # phase 14's causal prefills: whisper's decoder (64 tokens),
        # internvl2-76b's (1024 patches + 64 tokens), jamba's attention layer
        ("whisper decoder B=4 S=64", 4, 20, 20, 64, 64, 64, bf16, True, 0,
         0.0, False),
        ("internvl B=2 S=1088", 2, 64, 8, 1088, 1088, 128, bf16, True, 0,
         0.0, False),
        ("jamba B=4 S=512", 4, 32, 8, 512, 512, 128, bf16, True, 0, 0.0,
         False),
        # phase 18's GSPMD prefills (packed weights whole on every rank):
        # a (2, 2) rank's 4 of 8 rows, and the B=1 1024-token prompt every
        # rank attends whole
        ("gspmd rank B=4 S=512", 4, 16, 8, 512, 512, 128, bf16, True, 0,
         0.0, False),
        ("gspmd B=1 S=1024", 1, 16, 8, 1024, 1024, 128, bf16, True, 0, 0.0,
         False),
        # and its dense tree's: a (2, 2) rank's 4 rows, 8 of 16 heads
        ("gspmd dense rank B=4 S=256", 4, 8, 4, 256, 256, 128, bf16, True, 0,
         0.0, False),
        # phase 19's whisper on every (1, 8) rank (whole heads): the
        # encoder, the decoder's 63-token prompt and its cross-attention
        ("headdim whisper encoder B=2 S=1500", 2, 20, 20, 1500, 1500, 64,
         bf16, False, 0, 0.0, False),
        ("headdim whisper decoder B=2 S=63", 2, 20, 20, 63, 63, 64, bf16,
         True, 0, 0.0, False),
        ("headdim whisper cross B=2 Sq=63 Skv=1500", 2, 20, 20, 63, 1500, 64,
         bf16, False, 0, 0.0, False),
    ]
    rows = []
    for name, b, h, kv, sq, s, d, dt, causal, window, softcap, seg in cases:
        q = torch.randn((b, h, sq, d), generator=gen, device=device).to(dt)
        k = torch.randn((b, kv, s, d), generator=gen, device=device).to(dt)
        v = torch.randn((b, kv, s, d), generator=gen, device=device).to(dt)
        kw = dict(causal=causal, window=window, softcap=softcap)
        segs_np = segments(b, s) if seg else None
        sg = (() if segs_np is None else
              (torch.from_numpy(segs_np).to(device),) * 2)
        out = ops.flash_attention_fwd(q, k, v, *sg, **kw)
        plain = (ref.flash_attention_segmented_ref if seg
                 else ref.flash_attention_ref)
        out_ref, lse_ref = plain(q, k, v, *sg, with_lse=True, **kw)
        torch.cuda.synchronize()
        err = (out.float() - out_ref.float()).abs().max().item()
        tol = 2e-2 if dt == bf16 else 1e-5
        if not err <= tol:
            fail(f"flash_attention {name}: max err {err} > {tol}")
        check_lse(torch, ops, name, q, k, v, sg, kw, out, lse_ref)
        del lse_ref
        if d == 256 or not causal:   # rows over ~1500-4096 keys: hold
            # each row to its own scale
            rel = row_rel_err(torch, out, out_ref)
            log(f"  flash_attention {name}: worst row err / max|row| "
                f"{rel:.3g} (tol {ROW_REL_TOL})")
            if not rel <= ROW_REL_TOL:
                fail(f"flash_attention {name}: worst row err / max|row| "
                     f"{rel} > {ROW_REL_TOL}")
        if seg:
            pads = torch.from_numpy(segs_np == -1).to(device)
            if out.transpose(1, 2)[pads].abs().max().item() != 0.0:
                fail("flash_attention: pad rows are not exactly 0")
            other = torch.from_numpy(segs_np != 1).to(device)[:, None, :,
                                                              None]
            k2 = torch.where(other, torch.randn_like(k) * 10, k)
            v2 = torch.where(other, torch.randn_like(v) * 10, v)
            out2 = ops.flash_attention_fwd(q, k2, v2, *sg, **kw)
            mine = torch.from_numpy(segs_np == 1).to(device)
            if not torch.equal(out2.transpose(1, 2)[mine],
                               out.transpose(1, 2)[mine]):
                fail("flash_attention: another segment's K/V changed a "
                     "segment's rows")
            del k2, v2, out2
        ms, ms_mean = timer.stats(lambda: ops.flash_attention_fwd(
            q, k, v, *sg, **kw))
        plain_ms = timer(lambda: plain(q, k, v, *sg, **kw), reps=3)
        lib = lib_mean = None
        if not (seg or window or softcap):   # one PyTorch call computes it
            lib, lib_mean = timer.stats(lambda: sdpa(
                q, k, v, is_causal=causal, enable_gqa=True))
        pairs = visible_pairs(sq, s, causal, window, segs_np)
        if segs_np is None:
            pairs *= b
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        nbytes += 0 if segs_np is None else 2 * segs_np.nbytes
        b_ms, b_by = bound(nbytes, 4.0 * pairs * h * d, str(dt)[6:])
        row = dict(shape=f"{name} H={h} KV={kv} d={d} {str(dt)[6:]} "
                   f"{'causal' if causal else 'full'}", name=name,
                   max_abs_err=err,
                   ms=ms, plain_ms=plain_ms, library_ms=lib, bound_ms=b_ms,
                   bound_by=b_by)
        rows.append(row)
        lib_txt = ("n/a" if lib is None else
                   f"{lib:.4f} median (mean {lib_mean:.4f})")
        log(f"  flash_attention {row['shape']}: err {err:.3g} (tol {tol}) "
            f"kernel {ms:.4f} ms median of 20 (mean {ms_mean:.4f}) | plain "
            f"{plain_ms:.4f} | library {lib_txt} | bound {b_ms:.4f} "
            f"({b_by}), {100 * b_ms / ms:.1f} % of it reached")
        del q, k, v, out, out_ref
    log(f"[flash_attention] {len(rows)} shapes agree with the plain version"
        " (tol 2e-2 abs bf16, 1e-5 f32; at d=256 and non-causal also every "
        "row within 1e-2 of its largest value; pad rows exactly 0; segment "
        "isolation bitwise; with lse: output bitwise, lse 1e-3 bf16 / 1e-5 "
        "f32)")
    return rows


OFFSET_CASES = [  # name, B, H, KV, S (whole), ranks, d, dtype, window, softcap
    # internlm2-1.8b's context-parallel shape: S = 3072 over three ranks,
    # each rank's 1024 query rows against the whole K/V at q_offset
    # 0, 1024, 2048 (bf16 tensor cores; f32 SIMT)
    ("internlm2 CP S=3072/3", 2, 16, 8, 3072, 3, 128, "bfloat16", 0, 0.0),
    ("internlm2 CP S=3072/3 f32", 2, 16, 8, 3072, 3, 128, "float32", 0,
     0.0),
    # phase 17's (1, 3) context-parallel shape (GSPMD's cp_batch x
    # cp_seq, f32: the SIMT kernel), the row of the kernels line
    ("internlm2 CP S=768/3 f32 phase 17", 4, 16, 8, 768, 3, 128,
     "float32", 0, 0.0),
    # gemma2-2b's d=256, window 4096, softcap 50 over S = 4608 in three
    ("gemma2 CP window 4096 S=4608/3", 1, 8, 4, 4608, 3, 256, "bfloat16",
     4096, 50.0),
]


def visible_pairs_offset(sq, skv, off, window):
    """Causal (query, key) pairs of ``sq`` rows at positions ``off`` ..
    ``off + sq - 1`` against ``skv`` keys."""
    qpos = off + np.arange(sq)[:, None]
    kpos = np.arange(skv)[None, :]
    mask = kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    return int(mask.sum())


def phase_flash_offset(torch, timer, device):
    """Phase 6, context parallelism: kernel D with ``q_offset`` (a rank's
    rows against the whole K/V) against its plain version, and bitwise
    against the same rows of the whole sequence's launch at q_offset 0
    (offsets are multiples of the 64-row tile, so each row walks the same
    key tiles); with the lse at every offset. Times (median of 20), the
    bound of the visible pairs and SDPA with the same boolean mask."""
    from repro_torch.kernels.flash_attention import ops, ref
    gen = torch.Generator(device=device).manual_seed(11)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    for name, b, h, kv, s, n, d, dt_name, window, softcap in OFFSET_CASES:
        dt = getattr(torch, dt_name)
        q = torch.randn((b, h, s, d), generator=gen, device=device).to(dt)
        k = torch.randn((b, kv, s, d), generator=gen, device=device).to(dt)
        v = torch.randn((b, kv, s, d), generator=gen, device=device).to(dt)
        kw = dict(causal=True, window=window, softcap=softcap)
        whole = ops.flash_attention_fwd(q, k, v, **kw)
        sq = s // n
        err = 0.0
        for r in range(n):
            off = r * sq
            qr = q[:, :, off:off + sq]
            out = ops.flash_attention_fwd(qr, k, v, q_offset=off, **kw)
            if not torch.equal(out, whole[:, :, off:off + sq]):
                fail(f"flash_attention {name}: rank {r}'s rows at q_offset "
                     f"{off} differ from the whole launch's")
            out_ref, lse_ref = ref.flash_attention_ref(
                qr, k, v, with_lse=True, q_offset=off, **kw)
            e = (out.float() - out_ref.float()).abs().max().item()
            tol = 2e-2 if dt == torch.bfloat16 else 1e-5
            if not e <= tol:
                fail(f"flash_attention {name} q_offset {off}: err {e} > "
                     f"{tol}")
            err = max(err, e)
            lse = torch.empty(qr.shape[:3], dtype=torch.float32,
                              device=device)
            out2 = ops.flash_attention_fwd(qr, k, v, q_offset=off, lse=lse,
                                           **kw)
            lse_tol = (1e-3 if dt == torch.bfloat16 else
                       1e-5 * lse_ref.abs().max().item())
            lse_err = (lse - lse_ref).abs().max().item()
            if not torch.equal(out2, out) or not lse_err <= lse_tol:
                fail(f"flash_attention {name} q_offset {off}: lse err "
                     f"{lse_err} > {lse_tol} or output changed with lse")
            del out_ref, lse_ref, out2, lse
        off = (n - 1) * sq          # the last rank: the most keys
        qr = q[:, :, off:off + sq]
        ms, ms_mean = timer.stats(lambda: ops.flash_attention_fwd(
            qr, k, v, q_offset=off, **kw))
        plain_ms = timer(lambda: ref.flash_attention_ref(
            qr, k, v, q_offset=off, **kw), reps=3)
        lib = None
        if not softcap:      # SDPA has no softcap
            qpos = off + torch.arange(sq, device=device)[:, None]
            kpos = torch.arange(s, device=device)[None, :]
            mask = kpos <= qpos
            if window > 0:
                mask &= kpos > qpos - window
            lib, _ = timer.stats(lambda: sdpa(qr, k, v, attn_mask=mask,
                                              enable_gqa=True))
        pairs = b * visible_pairs_offset(sq, s, off, window)
        nbytes = (2 * qr.numel() + k.numel() + v.numel()) * qr.element_size()
        b_ms, b_by = bound(nbytes, 4.0 * pairs * h * d, dt_name)
        row = dict(shape=f"{name} rank {n - 1} q_offset {off} H={h} KV={kv}"
                   f" d={d} {dt_name}", name=name, max_abs_err=err, ms=ms,
                   plain_ms=plain_ms, library_ms=lib, bound_ms=b_ms,
                   bound_by=b_by)
        rows.append(row)
        log(f"  flash_attention q_offset {row['shape']}: err {err:.3g}, "
            f"rows bitwise the whole launch's at every offset, lse held; "
            f"kernel {ms:.4f} ms median of 20 (mean {ms_mean:.4f}) | plain "
            f"{plain_ms:.4f} | SDPA with the mask "
            f"{'n/a' if lib is None else f'{lib:.4f}'} | bound {b_ms:.4f} "
            f"({b_by}), {100 * b_ms / ms:.1f} % of it reached")
        del q, k, v, whole, qr
    log(f"[flash_attention q_offset] {len(rows)} shapes: every rank's rows "
        "agree with the plain version and bitwise with the whole launch")
    return rows


GRAD_CASES = [  # name, B, H, KV, Sq, Skv, d, causal, window, softcap
    ("internlm2 train B=2 S=4096", 2, 16, 8, 4096, 4096, 128, True, 0, 0.0),
    ("gemma2 window 4096 softcap 50 B=1 S=4608", 1, 8, 4, 4608, 4608, 256,
     True, 4096, 50.0),
    ("whisper encoder B=2 S=1500", 2, 20, 20, 1500, 1500, 64, False, 0,
     0.0),
    ("whisper cross B=2 Sq=64 Skv=1500", 2, 20, 20, 64, 1500, 64, False, 0,
     0.0),
    # phase 20's 100m preset (qwen-style, 12 heads of 64, bf16)
    ("e2e 100m train B=32 S=1024", 32, 12, 12, 1024, 1024, 64, True, 0, 0.0),
]
# the cases timed (D+lse, the backward, SDPA): the train shapes
TIMED_GRAD = ("internlm2 train B=2 S=4096", "e2e 100m train B=32 S=1024")


def phase_flash_grad(torch, timer, device):
    """Phase 6, training: gradients through ``models.attention.
    flash_attention`` (kernel D with its lse under the autograd Function,
    ``flash_attention_bwd`` backward) against autograd through the plain
    version on the same bf16 inputs on the card, at internlm2's train
    shape, gemma2's windowed softcapped d=256 prefill and whisper's
    encoder and cross-attention, and phase 20's 100m preset: dq/dk/dv
    within 2e-2 of each tensor's largest |value|, none missing or all
    zero. At the train shapes (``TIMED_GRAD``): D+lse, the backward alone
    and SDPA forward+backward timed (median of 5). Returns their rows by
    name."""
    from repro_torch.kernels.flash_attention import ops, ref
    from repro_torch.models.attention import (flash_attention,
                                              flash_attention_bwd)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device=device).manual_seed(6)
    bf16 = torch.bfloat16
    rows = {}
    for name, b, h, kv, sq, skv, d, causal, window, softcap in GRAD_CASES:
        def leaf(shape):
            return torch.randn(shape, generator=gen, device=device).to(
                bf16).requires_grad_(True)
        q, k, v = leaf((b, sq, h, d)), leaf((b, skv, kv, d)), leaf(
            (b, skv, kv, d))
        dout = torch.randn((b, sq, h, d), generator=gen, device=device).to(
            bf16)
        kw = dict(causal=causal, window=window, softcap=softcap)
        before = ops.flash_attention_fwd.launches
        flash_attention(q, k, v, **kw).backward(dout)
        if ops.flash_attention_fwd.launches != before + 1:
            fail(f"flash grad {name}: kernel D not launched once")
        got = [t.grad for t in (q, k, v)]
        for t in (q, k, v):
            t.grad = None
        ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), **kw).transpose(
            1, 2).backward(dout)
        errs = []
        for g, t, what in zip(got, (q, k, v), "qkv"):
            if g is None or g.abs().max().item() == 0:
                fail(f"flash grad {name}: d{what} missing or all zero")
            want = t.grad.float()
            rel = (g.float() - want).abs().max().item() / \
                want.abs().max().item()
            if not rel <= 2e-2:
                fail(f"flash grad {name}: d{what} err / max {rel} > 2e-2")
            errs.append(rel)
        log(f"  flash grad {name} H={h} KV={kv} d={d}: dq/dk/dv err / max "
            f"{errs[0]:.3g} {errs[1]:.3g} {errs[2]:.3g} (tol 2e-2)")
        if name in TIMED_GRAD:
            qh, kh, vh = (t.detach().transpose(1, 2) for t in (q, k, v))
            lse = torch.empty((b, h, sq), device=device)
            ms, _ = timer.stats(lambda: ops.flash_attention_fwd(
                qh, kh, vh, lse=lse, **kw), reps=5)
            out = ops.flash_attention_fwd(qh, kh, vh, lse=lse, **kw)
            doh = dout.transpose(1, 2)
            bwd_ms, _ = timer.stats(lambda: flash_attention_bwd(
                qh, kh, vh, out, lse, doh, **kw), reps=5)
            qs, ks, vs = (t.detach().transpose(1, 2).requires_grad_(True)
                          for t in (q, k, v))

            def sdpa_fb():
                sdpa(qs, ks, vs, is_causal=causal, enable_gqa=True
                     ).backward(doh)
            lib_ms, _ = timer.stats(sdpa_fb, reps=5)
            lib_fwd, _ = timer.stats(lambda: sdpa(
                qh, kh, vh, is_causal=causal, enable_gqa=True), reps=5)
            plain_ms = timer(lambda: ref.flash_attention_ref(
                qh, kh, vh, **kw), reps=2)
            pairs = b * visible_pairs(sq, skv, causal, window)
            nbytes = (2 * q.numel() + k.numel() + v.numel()) * 2 + \
                4 * b * h * sq
            b_ms, b_by = bound(nbytes, 4.0 * pairs * h * d, "bfloat16")
            # the backward reads q, k, v, out, dout and lse once and writes
            # dq, dk, dv: 5 products of the visible pairs (s, dp, dq, dk,
            # dv), 2 operations each, on bf16 inputs
            bwd_bytes = (4 * q.numel() + 4 * k.numel()) * 2 + 4 * b * h * sq
            bb_ms, bb_by = bound(bwd_bytes, 10.0 * pairs * h * d,
                                 "bfloat16")
            rows[name] = dict(
                shape=f"{name} H={h} KV={kv} d={d} bf16 causal", name=name,
                max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                library_ms=lib_fwd, bound_ms=b_ms, bound_by=b_by,
                bwd_ms=bwd_ms, bwd_bound_ms=bb_ms, sdpa_fwd_bwd_ms=lib_ms)
            log(f"  D+lse at {name}: {ms:.4f} ms median of 5 | "
                f"plain {plain_ms:.4f} | bound {b_ms:.4f} ({b_by}), "
                f"{100 * b_ms / ms:.1f} % of it | SDPA forward "
                f"{lib_fwd:.4f} ms | backward "
                f"(flash_attention_bwd, plain torch f32) {bwd_ms:.4f} ms, "
                f"bound {bb_ms:.4f} ({bb_by}) | SDPA forward+backward "
                f"{lib_ms:.4f} ms")
            del qh, kh, vh, lse, out, qs, ks, vs
        del q, k, v, dout, got
    torch.cuda.empty_cache()
    log("[flash grad] kernel D under its autograd Function: gradients agree "
        f"with autograd through the plain version at {len(GRAD_CASES)} "
        "shapes (tol 2e-2 of each tensor's largest)")
    return rows


def next_logits(torch, model, params, tokens, device, ps=16, kv_bits=16,
                parallel=None):
    """Last-position logits of one plain prefill of ``tokens`` on fresh
    pools at ``kv_bits`` (for the near-tie gap of a divergence); with
    ``parallel`` on one rank's shard of a mesh."""
    n = len(tokens)
    pages = -(-n // ps)
    pools = model.init_paged_pools(pages + 1, ps, kv_bits=kv_bits,
                                   max_seqs=1, device=device,
                                   parallel=parallel)
    bt = torch.arange(1, pages + 1, dtype=torch.int32, device=device)[None]
    tok = torch.tensor(np.asarray(tokens)[None], dtype=torch.int32,
                       device=device)
    q_pos = torch.arange(n, dtype=torch.int32, device=device)[None]
    kv = torch.tensor([n], dtype=torch.int32, device=device)
    slots = torch.zeros(1, dtype=torch.int32, device=device)
    logits, _ = model.paged_step(params, pools, tok, q_pos, kv, bt,
                                 kv_bits=kv_bits, slots=slots,
                                 parallel=parallel)
    return logits[0].float().cpu()


def top2_gap(logits):
    top = logits.topk(2).values
    return float(top[0] - top[1])


def compare_tokens(torch, name, a, b, prompts, model, params, device,
                   kv_bits=16, hold=True):
    """Fail unless outputs agree, or diverge only at a near tie (top-2
    logit gap < 1e-2 at the first divergent step, on pools of
    ``kv_bits``). ``hold=False`` reports the divergences and passes."""
    for rid in sorted(a):
        if np.array_equal(a[rid], b[rid]):
            continue
        i = int(np.argmax(a[rid] != b[rid]))
        ctx = np.concatenate([prompts[rid], a[rid][:i]])
        gap = top2_gap(next_logits(torch, model, params, ctx, device,
                                   kv_bits=kv_bits))
        log(f"  {name}: request {rid} diverges at step {i} "
            f"({a[rid][i]} vs {b[rid][i]}), top-2 logit gap {gap:.3g}")
        if hold and not gap < 1e-2:
            fail(f"{name}: request {rid} diverges at step {i} with top-2 "
                 f"gap {gap} >= 1e-2")
    if hold:
        log(f"  {name}: tokens identical or near-tie only")


def record_chunks(engine, prompts):
    """Have ``engine`` record each request's packed-prefill chunks:
    returns {prompt index: [(start, length), ...]}, filled as it serves."""
    index = {np.asarray(p, np.int32).tobytes(): i
             for i, p in enumerate(prompts)}
    chunks = {}
    run = engine._run_prefill_packed

    def spy(segs, bucket):
        for seq, start, n in segs:
            i = index.get(np.asarray(seq.req.prompt, np.int32).tobytes())
            chunks.setdefault(i, []).append((int(start), int(n)))
        return run(segs, bucket)

    engine._run_prefill_packed = spy
    return chunks


def schedule_free(chunks, prompts, ps):
    """Prompt indices whose kv8/kv4 tokens do not depend on how requests
    were batched: every prefill chunk ends on a page boundary or at the
    prompt's end, and a prefix adopted from the prompt sharing it (the
    first two) came from a request that qualifies too. Quantized pools are
    read from their codes for every page a row has filled and from the hot
    row for the page it is on, so a chunk that ends mid-page reads that
    page exact where another wave reads it quantized, in the reference as
    in the port (tests/test_torch_schedule.py)."""
    whole = {i for i, c in chunks.items() if i is not None and all(
        (s + n) % ps == 0 or s + n == len(prompts[i]) for s, n in c)}
    return {i for i in whole
            if chunks[i][0][0] == 0 or {0, 1} <= whole}


def run_engine(engine, prompts, first_alone, max_new):
    """Submit ``prompts[0]`` alone, step until its prompt is cached (so the
    prompt sharing its prefix can hit), then the rest; run to the end.
    ``max_new``: new tokens of every request, or a list, one per prompt.
    Returns (outputs, prefill seconds, decode seconds)."""
    import torch
    times = {"prefill": 0.0, "decode": 0.0}
    news = ([max_new] * len(prompts) if isinstance(max_new, int)
            else list(max_new))
    rid0 = engine.submit(prompts[0], news[0])
    out = {}

    def step():
        t0 = time.perf_counter()
        worked = engine.step()
        torch.cuda.synchronize()
        kind = ("decode" if engine.last_step_kind == "decode" else "prefill")
        times[kind] += time.perf_counter() - t0
        out.update(engine.collect())
        return worked

    if first_alone:
        while engine._seqs[rid0].state != "decode" and step():
            pass
    for p, n in zip(prompts[1:], news[1:]):
        engine.submit(p, n)
    while engine.has_work and step():
        pass
    out.update(engine.collect())
    return out, times["prefill"], times["decode"]


# the continuous engine of phases 7, 8 and 11
SERVE_ENGINE = dict(max_batch=8, page_size=16, num_pages=1024,
                    prefill_chunk=128, max_seq=1024)


def serve_prompts(cfg, last=256):
    """Phase 7's 8 prompts (seed 0): 64-384 tokens, the first two sharing
    a 256-token prefix. Two end mid-page (300 and 200 tokens, pages of 16),
    so the direct runs' packed-prefill waves also cut prompts mid-page.
    ``last`` sets the last prompt's length (phase 13: one past gemma2's
    4096-token window)."""
    rng = np.random.default_rng(0)
    shared = rng.integers(0, cfg.vocab_size, 256)
    lens = [320, 300, 64, 384, 128, 200, 96, last]
    prompts = [np.concatenate([shared, rng.integers(0, cfg.vocab_size,
                                                    n - 256)])
               for n in lens[:2]]
    prompts += [rng.integers(0, cfg.vocab_size, n) for n in lens[2:]]
    return [p.astype(np.int32) for p in prompts]


def phase_serve(torch, device):
    from repro_torch.configs import get_config
    from repro_torch.core import QuantPolicy, pack_params, quantize_params
    from repro_torch.models import Model
    from repro_torch.serve import ContinuousEngine
    cfg = get_config("internlm2-1.8b")
    model = Model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    t0 = time.perf_counter()
    qparams, report = quantize_params(
        params, QuantPolicy(bits=4, block=64, solver="dp"))
    torch.cuda.synchronize()
    t_quant = time.perf_counter() - t0
    del params
    packed, _ = pack_params(qparams)
    del qparams
    torch.cuda.synchronize()
    pbytes = 0
    for path, leaf in _leaves(packed):
        pbytes += sum(t.numel() * t.element_size() for t in _tensors(leaf))
    log(f"[serve] internlm2-1.8b full width ({cfg.n_layers} layers, d "
        f"{cfg.d_model}, vocab {cfg.vocab_padded}): init {t_init:.2f} s, "
        f"DP quantize of {len(report)} tensors on the card {t_quant:.2f} s, "
        f"packed params {pbytes / 1e9:.3f} GB")
    prompts = serve_prompts(cfg)
    max_new = 32
    engine_kw = SERVE_ENGINE
    results, counts, kv_bytes, chunks = serve_horizons(
        model, packed, prompts, engine_kw, max_new, 16,
        ("msb_matmul", "msb_unembed", "paged_attention_decode"))
    log(f"  kv16 pools: {kv_bytes / 1e9:.3f} GB")
    direct = {16: results[8]}
    direct_chunks = {16: chunks}
    compare_tokens(torch, "H=8 vs H=1", results[8], results[1], prompts,
                   model, packed, device)
    profile_decode(torch, ContinuousEngine(model, packed, **engine_kw),
                   prompts, max_new)
    profile_prefill(torch, ContinuousEngine(model, packed, **engine_kw),
                    prompts, max_new)
    log(f"  device memory: {torch.cuda.memory_allocated() / 1e9:.3f} GB in "
        f"use, peak {torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    log("[serve] ok: all requests 32 tokens, prefix hit, clean page audit")
    return counts, dict(model=model, packed=packed, prompts=prompts,
                        engine_kw=engine_kw, max_new=max_new, direct=direct,
                        direct_chunks=direct_chunks)


def pool_bytes(pools):
    return sum(t.numel() * t.element_size() for _, t in _leaves(pools))


def _wrappers():
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.msb_matmul import ops as mm_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops
    return {"msb_matmul": mm_ops.msb_matmul,
            "msb_matmul_experts": mm_ops.msb_matmul_experts,
            "msb_unembed": mm_ops.msb_unembed,
            "paged_attention_decode": pa_ops.paged_attention_decode,
            "paged_attention_decode_quant":
                pa_ops.paged_attention_decode_quant,
            "flash_attention_fwd": fa_ops.flash_attention_fwd}


def zero_launch_counters():
    for fn in _wrappers().values():
        fn.launches = 0


def read_launch_counters():
    return {name: fn.launches for name, fn in _wrappers().items()}


def warm(torch, eng, name):
    """``eng.warmup()`` with its report on one line: entries, wall seconds,
    the captured forwards' Python seconds, instantiation seconds, and the
    bytes of the engine's graph pool."""
    torch.cuda.synchronize()
    rep = eng.warmup()
    torch.cuda.synchronize()
    if rep["traces"] != rep["entries"]:
        fail(f"{name}: warmup captured {rep['traces']} of {rep['entries']} "
             "entries")
    log(f"  {name} warmup: {rep['entries']} graphs {rep['shapes']} in "
        f"{rep['seconds']:.2f} s (capture {rep['capture_seconds']:.2f} s, "
        f"instantiate {rep['instantiate_seconds']:.2f} s), graph pool "
        f"{rep['graph_bytes'] / 1e9:.3f} GB")
    return rep


def _clone(tree):
    return {k: _clone(v) for k, v in tree.items()} if isinstance(
        tree, dict) else tree.clone()


def check_graphs(torch, model, packed, prompts, engine_kw, kv_bits):
    """Graph replay against the same dispatch run eagerly. An untimed
    decode_horizon-8 engine serves three prompts, capturing lazily; the
    first packed-prefill and the first decode-horizon dispatch of the
    largest size each reaches are recorded (host inputs, block-table rows, the pools before, the outputs, the pools
    after). Each is run again eagerly through ``Model.paged_*``
    (``DispatchGraphs.forward``) on a copy of the pools before it: logits
    or tokens and every pool leaf must be bit-identical outside scratch page
    0 and hot row 0, which pad rows write in any order. No pool leaf may
    move during the run."""
    from repro_torch.serve import ContinuousEngine
    eng = ContinuousEngine(model, packed, decode_horizon=8, kv_bits=kv_bits,
                           **engine_kw)
    ptrs = [t.data_ptr() for _, t in _leaves(eng.cache.pools)]
    graphs, run, recs = eng.graphs, eng.graphs.run, {}

    def spy(kind, size, inputs, bt):
        keep = size > recs.get(kind, {}).get("size", 0)
        if keep:
            recs[kind] = dict(size=size, bt=bt.clone(),
                              inputs={n: a.copy() for n, a in inputs.items()},
                              before=_clone(eng.cache.pools))
        outs = run(kind, size, inputs, bt)
        if keep:
            recs[kind].update(outs=[o.clone() for o in outs],
                              after=_clone(eng.cache.pools))
        return outs

    graphs.run = spy
    for p in prompts[:3]:
        eng.submit(p, 16)
    eng.run()
    del graphs.run
    if set(recs) != {"prefill_packed", "decode_horizon"}:
        fail(f"kv{kv_bits} graph check: dispatched {sorted(recs)}")
    if [t.data_ptr() for _, t in _leaves(eng.cache.pools)] != ptrs:
        fail(f"kv{kv_bits}: a pool leaf moved during the run")
    notes = []
    for kind, rec in sorted(recs.items()):
        pools = _clone(rec["before"])
        x = {n: torch.from_numpy(a).cuda() for n, a in rec["inputs"].items()}
        outs, _ = graphs.forward(kind, x, rec["bt"], pools)
        for got, want in zip(rec["outs"], outs):
            if not torch.equal(got, want):
                fail(f"kv{kv_bits} {kind}: graph replay output differs from "
                     "the eager dispatch")
        after = dict(_leaves(rec["after"]))
        scratch = True
        for path, leaf in _leaves(pools):
            if not torch.equal(after[path][:, 1:], leaf[:, 1:]):
                fail(f"kv{kv_bits} {kind}: pool {path} differs between "
                     "graph replay and the eager dispatch")
            scratch &= torch.equal(after[path][:, :1], leaf[:, :1])
        notes.append(f"{kind} {rec['size']} ({len(after)} leaves; scratch "
                     f"{'identical too' if scratch else 'differs'})")
        del pools, rec["before"], rec["after"]
    eng.close()
    log(f"  kv{kv_bits} graph replay vs eager: outputs and pools "
        f"bit-identical for {', '.join(notes)}; pool addresses unchanged")


def serve_horizons(model, packed, prompts, engine_kw, max_new, kv_bits,
                   path_kernels):
    """The graph check, then all ``prompts`` at decode_horizon 8 and 1 (the
    first alone until its prompt is cached, so the second hits the prefix
    cache), each engine warmed first; no capture may follow its warmup.
    Launch counters are zeroed just before the H=8 run and read just after;
    ``path_kernels`` must all have launched. Returns ({horizon: outputs},
    H=8 launch counts, pool bytes, the H=8 run's prefill chunks by prompt).
    Each run's line gives its peak device memory."""
    import torch
    from repro_torch.serve import ContinuousEngine, jit_trace_count
    check_graphs(torch, model, packed, prompts, engine_kw, kv_bits)
    results = {}
    for horizon in (8, 1):
        eng = ContinuousEngine(model, packed, decode_horizon=horizon,
                               kv_bits=kv_bits, **engine_kw)
        name = f"kv{kv_bits} H={horizon}"
        warm(torch, eng, name)
        n0 = jit_trace_count()
        torch.cuda.reset_peak_memory_stats()
        if horizon == 8:
            chunks = record_chunks(eng, prompts)
            zero_launch_counters()
        t0 = time.perf_counter()
        out, t_pre, t_dec = run_engine(eng, prompts, True, max_new)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        if jit_trace_count() != n0:
            fail(f"serve {name}: {jit_trace_count() - n0} captures after "
                 "warmup")
        if horizon == 8:
            counts = read_launch_counters()
            kv_bytes = pool_bytes(eng.cache.pools)
        if sorted(out) != list(range(len(prompts))) or any(
                len(t) != max_new for t in out.values()):
            fail(f"serve {name}: not every request returned {max_new} "
                 "tokens")
        hits = eng.n_prefix_hits
        saved = eng.n_prefix_positions_saved
        eng.close()
        eng.cache.check_invariants(expect_idle=True)
        if hits < 1:
            fail(f"serve {name}: no prefix-cache hit")
        pre_tok = sum(len(p) for p in prompts) - saved
        dec_tok = len(prompts) * (max_new - 1)
        log(f"  {name}: {wall:.2f} s wall, prefill {pre_tok} tokens in "
            f"{t_pre:.3f} s = {pre_tok / t_pre:.1f} tok/s, decode {dec_tok} "
            f"tokens in {t_dec:.3f} s = {dec_tok / t_dec:.1f} tok/s, prefix "
            f"hits {hits} ({saved} positions saved), decode dispatches "
            f"{eng.n_decode_steps}, peak device memory {peak / 1e9:.3f} GB, "
            "captures after warmup 0")
        results[horizon] = out
        del eng
    log(f"  kv{kv_bits} launches in the H=8 run: {counts}")
    if not all(counts[k] > 0 for k in path_kernels):
        fail(f"serve kv{kv_bits}: a kernel of the path never launched: "
             f"{counts}")
    return results, counts, kv_bytes, chunks


def phase_serve_quant(torch, device, ctx):
    """Phase 6's packed weights and requests over quantized KV pools."""
    from repro_torch.core.quantize import KVQuantSpec, kv_native_page_bytes
    from repro_torch.serve import ContinuousEngine
    model, packed, prompts = ctx["model"], ctx["packed"], ctx["prompts"]
    engine_kw, max_new = ctx["engine_kw"], ctx["max_new"]
    cfg = model.cfg
    ps, kv, hd = engine_kw["page_size"], cfg.n_kv_heads, cfg.head_dim_
    native = kv_native_page_bytes(ps, kv, hd, cfg.dtype)
    counts = {}
    for bits in (8, 4):
        spec = KVQuantSpec(bits, ps, kv, hd)
        results, counts[bits], kv_bytes, chunks = serve_horizons(
            model, packed, prompts, engine_kw, max_new, bits,
            ("msb_matmul", "msb_unembed", "paged_attention_decode_quant"))
        ctx["direct"][bits] = results[8]
        ctx["direct_chunks"][bits] = chunks
        log(f"  kv{bits} pools: {kv_bytes / 1e9:.3f} GB; per page per K-or-V "
            f"per layer {spec.page_bytes()} B against {native} B native "
            f"({native / spec.page_bytes():.2f}x)")
        if bits == 4:
            for rid in results[8]:
                if not np.array_equal(results[8][rid], results[1][rid]):
                    fail(f"kv4: request {rid} differs between H=8 and H=1: "
                         f"{results[8][rid]} vs {results[1][rid]}")
            log("  kv4 H=8 vs H=1: tokens identical")
        else:
            compare_tokens(torch, f"kv{bits} H=8 vs H=1", results[8],
                           results[1], prompts, model, packed, device)
    time_commit(torch, device, model, engine_kw)
    profile_decode(torch, ContinuousEngine(model, packed, kv_bits=4,
                                           **engine_kw), prompts, max_new)
    log("[serve kv8/kv4] ok: all requests 32 tokens, prefix hits, clean page "
        "audits, kernel C launched")
    return counts


def phase_serve_static(torch, device, ctx):
    """Phase 7's packed weights through the static engine: B=8 prompts of
    512 tokens, 32 greedy tokens, then ``score`` on (8, 513) tokens; the
    same prompts through ContinuousEngine must give the same tokens."""
    from repro_torch.serve import ContinuousEngine, ServeEngine
    model, packed = ctx["model"], ctx["packed"]
    cfg = model.cfg
    b, p, n = 8, 512, 32
    rng = np.random.default_rng(5)
    prompts = rng.integers(0, cfg.vocab_size, (b, p)).astype(np.int32)
    eng = ServeEngine(model, packed, max_seq=1024)
    eng.generate(prompts[:, :16], 2)           # lazy set-up, untimed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counters()
    t0 = time.perf_counter()
    toks = eng.generate(prompts, n)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_launch_counters()
    peak = torch.cuda.max_memory_allocated()
    log(f"  generate launches: {counts}")
    if not (counts["flash_attention_fwd"] > 0 and counts["msb_matmul"] > 0
            and counts["msb_unembed"] > 0):
        fail(f"serve static: a kernel of the path never launched: {counts}")
    if toks.shape != (b, n) or not ((toks >= 0) & (toks < cfg.vocab_size)
                                    ).all():
        fail(f"serve static: tokens of shape {toks.shape} or out of range")
    t0 = time.perf_counter()
    logits, cache = model.prefill(eng.params, {"tokens": torch.from_numpy(
        prompts).to(device)})
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    ring = sum(t.numel() * t.element_size()
               for _, t in _leaves(eng._grow_cache(cache, p)))
    del logits, cache
    t_dec = wall - t_pre
    log(f"  ServeEngine B={b} P={p}: generate {n} tokens {wall:.3f} s wall; "
        f"prefill {b * p} tokens in {t_pre:.3f} s = {b * p / t_pre:.1f} "
        f"tok/s (timed alone); decode {b * n} tokens in {t_dec:.3f} s = "
        f"{b * n / t_dec:.1f} tok/s (generate wall minus prefill)")
    log(f"  ring cache {ring / 1e9:.3f} GB; device memory "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB in use, peak "
        f"{peak / 1e9:.3f} GB during generate")
    scored = np.concatenate([prompts, toks[:, :1]], axis=1)
    zero_launch_counters()
    t0 = time.perf_counter()
    nll = eng.score(scored)
    torch.cuda.synchronize()
    t_score = time.perf_counter() - t0
    score_counts = read_launch_counters()
    log(f"  score of {scored.shape}: NLL {nll:.6f} in {t_score:.3f} s, "
        f"launches {score_counts}")
    if not (np.isfinite(nll) and score_counts["flash_attention_fwd"] > 0):
        fail(f"serve static: score {nll}, launches {score_counts}")
    ctx["static"] = dict(prompts=prompts, toks=toks, scored=scored, nll=nll)
    cont = ContinuousEngine(model, packed, decode_horizon=8, **ctx[
        "engine_kw"])
    for row in prompts:
        cont.submit(row, n)
    out = cont.run()
    cont.close()
    compare_tokens(torch, "static vs continuous", {i: toks[i] for i in
                                                   range(b)}, out,
                   list(prompts), model, packed, device)
    profile_static(torch, eng, prompts)
    log("[serve static] ok: kernel D carried prefill and score, tokens "
        "agree with the continuous engine")
    return counts


def time_commit(torch, device, model, engine_kw, b=8, reps=10):
    """Wall ms of one layer's quantized write (hot write + commit-quantize
    of one candidate page per row, as a B=8 decode step does it), times the
    layer count: the commit's cost per decode step."""
    from repro_torch.models.attention import paged_write_quant
    cfg = model.cfg
    ps = engine_kw["page_size"]
    pools = model.init_paged_pools(64, ps, kv_bits=4, max_seqs=b,
                                   device=device)
    cache = {k: v[0] for k, v in pools["layers"]["s0"]["attn"].items()}
    gen = torch.Generator(device=device).manual_seed(4)
    kv, hd = cfg.n_kv_heads, cfg.head_dim_
    k = torch.randn((b, 1, kv, hd), generator=gen, device=device).to(
        cfg.dtype)
    bt = torch.arange(1, 1 + b * 4, dtype=torch.int32,
                      device=device).reshape(b, 4)
    lens = torch.full((b,), 2 * ps, dtype=torch.int32, device=device)
    q_pos = (lens - 1)[:, None]
    slots = torch.arange(b, dtype=torch.int32, device=device)
    for _ in range(2):
        paged_write_quant(cache, k, k, bt, q_pos, lens, slots, 4)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        paged_write_quant(cache, k, k, bt, q_pos, lens, slots, 4)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / reps * 1e3
    peak = (torch.cuda.max_memory_allocated() - base) / 1e6
    log(f"  kv4 commit (B={b} decode, one layer): {ms:.3f} ms wall, x "
        f"{cfg.n_layers} layers = {ms * cfg.n_layers:.2f} ms per decode step;"
        f" peak extra memory {peak:.1f} MB")
    del pools, cache


def device_breakdown(prof, wall, n_steps, what):
    """Device time by kernel from a profiler run over ``n_steps`` steps of
    ``wall`` ms each: the busy share of the wall time, the device kernels
    a step, the host time spent launching CUDA graphs, and the top ten.
    Returns (busy ms, kernels) a step."""
    by_name, graph_launch, kernels = {}, 0.0, 0
    for evt in prof.key_averages():
        dev = getattr(evt, "self_device_time_total",
                      getattr(evt, "self_cuda_time_total", 0))
        if dev > 0 and evt.device_type.name == "CUDA":
            by_name[evt.key] = by_name.get(evt.key, 0.0) + dev / 1e3
            kernels += evt.count
        if evt.key == "cudaGraphLaunch":
            graph_launch += evt.self_cpu_time_total / 1e3
    busy = sum(by_name.values()) / n_steps
    log(f"  {what}: wall {wall:.2f} ms/step, device busy {busy:.2f} ms/step "
        f"({100 * busy / wall:.1f}%, idle {100 * (1 - busy / wall):.1f}%), "
        f"{kernels / n_steps:.0f} kernels/step; host in cudaGraphLaunch "
        f"{graph_launch / n_steps:.2f} ms/step")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    for name, ms in ranked[:10]:
        log(f"    {ms / n_steps:8.3f} ms/step  {name[:90]}")
    for name, ms in ranked[10:]:     # the port's attention kernels, always
        if "paged_attention" in name or "flash_attention" in name:
            log(f"    {ms / n_steps:8.3f} ms/step  {name[:90]} (outside the "
                "top ten)")
    experts = sum(ms for name, ms in by_name.items()
                  if "msb_experts_kernel" in name) / n_steps
    if experts > 0:
        log(f"    expert batch (msb_experts_kernel): {experts:.3f} ms/step, "
            f"{100 * experts / busy:.1f}% of the busy time")
    return busy, kernels / n_steps


def profile_decode(torch, engine, prompts, max_new, n_steps=4):
    """Where a full-batch decode step's time goes, once all 8 requests
    decode: the wall time of ``n_steps`` H=1 decode steps unprofiled, then
    torch.profiler over ``n_steps`` more (graph replays: the engine is
    warmed first). Prints device time by kernel, the device-busy share of
    the profiled steps' wall time, and both wall times per step (the
    profiler's tracing slows each graph launch)."""
    from torch.profiler import ProfilerActivity, profile
    engine.warmup()
    for p in prompts:
        engine.submit(p, max_new)
    while engine.scheduler.waiting or any(
            s.state != "decode" for s in engine.scheduler.running):
        engine.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        engine.step()
    torch.cuda.synchronize()
    log(f"  decode step unprofiled (B=8, H=1, {n_steps} steps): wall "
        f"{(time.perf_counter() - t0) / n_steps * 1e3:.2f} ms/step")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            engine.step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n_steps * 1e3
    device_breakdown(prof, wall, n_steps,
                     f"decode step profile (B=8, H=1, {n_steps} steps)")
    while engine.has_work:
        engine.step()
    engine.close()


def profile_prefill(torch, engine, prompts, max_new, n_steps=1):
    """Where a continuous prefill wave's time goes: torch.profiler over the
    engine's first ``n_steps`` steps on all ``prompts`` (one packed wave of
    up to prefill_chunk tokens a prompt; a graph replay: the engine is
    warmed first), then the rest run out unprofiled."""
    from torch.profiler import ProfilerActivity, profile
    engine.warmup()
    for p in prompts:
        engine.submit(p, max_new)
    torch.cuda.synchronize()
    kinds = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            engine.step()
            kinds.append(engine.last_step_kind)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n_steps * 1e3
    device_breakdown(prof, wall, n_steps,
                     f"prefill step profile ({n_steps} steps: {kinds})")
    while engine.has_work:
        engine.step()
    engine.close()


def profile_static(torch, engine, prompts, n_steps=4, prefill=True):
    """Where the static engine's time goes: torch.profiler over one
    prefill of ``prompts`` (unless not ``prefill``: a prefill of a
    recurrent stack is ~1e5 small launches, whose trace takes the
    profiler longer to digest than the run) and then over ``n_steps``
    ring decode steps."""
    from torch.profiler import ProfilerActivity, profile
    model, params = engine.model, engine.params
    tokens = torch.from_numpy(prompts).to(engine.device)
    b, p = prompts.shape
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    if prefill:
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            logits, cache = model.prefill(params, {"tokens": tokens})
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        device_breakdown(prof, wall, 1,
                         f"static prefill profile (B={b}, P={p})")
    else:
        logits, cache = model.prefill(params, {"tokens": tokens})
    cache = engine._grow_cache(cache, p)
    cur = torch.full((b,), p, dtype=torch.int32, device=engine.device)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    logits, cache = model.decode_step(params, cache, tok, cur)
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(n_steps):
            tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
            logits, cache = model.decode_step(params, cache, tok, cur + 1 + i)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n_steps * 1e3
    device_breakdown(prof, wall, n_steps,
                     f"static decode step profile (B={b}, {n_steps} steps)")


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}" if path else k)
    else:
        yield path, tree


def _tensors(leaf):
    import torch
    if isinstance(leaf, torch.Tensor):
        return [leaf]
    return [leaf.packed if hasattr(leaf, "packed") else leaf.codes,
            leaf.scales]


def phase_paths(torch):
    paths_check(torch, "internlm2-1.8b", (16, 8, 4))
    log("[paths] smoke internlm2 on the kernel path (cuda) and the plain "
        "path (cpu) at kv_bits 16, 8 and 4 and through the static engine: "
        "greedy tokens agree")


def paths_check(torch, arch, bits_list, report=False, **repl):
    """``arch``'s smoke config (fp32; ``repl`` replaces config fields)
    served on the card and on the CPU from the same quantized weights, by
    ContinuousEngine at each of ``bits_list`` and by ServeEngine (generate
    and score): greedy tokens agree up to near ties, score within 1e-4
    relative. ``report``: ContinuousEngine only, with uneven new-token
    counts (rows finish mid-horizon); the requests whose tokens differ are
    logged, not held."""
    import dataclasses
    from repro_torch.configs import smoke_config
    from repro_torch.core import QuantPolicy, quantize_params
    from repro_torch.models import Model
    from repro_torch.serve import ContinuousEngine
    cfg = dataclasses.replace(smoke_config(arch), **repl)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    qparams, _ = quantize_params(params, QuantPolicy(min_size=1024),
                                 device="cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 9, 17, 30)]
    from repro_torch.core import pack_params
    packed_cpu, _ = pack_params(qparams, device="cpu")
    for bits in bits_list:
        outs = {}
        for dev in ("cuda", "cpu"):
            eng = ContinuousEngine(model, qparams, max_batch=4, page_size=4,
                                   num_pages=96, max_seq=64, decode_horizon=4,
                                   kv_bits=bits, device=dev)
            for p, n in zip(prompts, (16, 11, 13, 9) if report else
                            (16,) * len(prompts)):
                eng.submit(p, n)
            outs[dev] = eng.run()
            eng.close()
        if report:
            log(f"  {arch} kv{bits} {repl or 'own config'}, new tokens 16, "
                "11, 13, 9 (report only): cuda vs cpu requests differing "
                f"{first_divergences(outs['cuda'], outs['cpu'])}")
            continue
        compare_tokens(torch, f"{arch} kv{bits} cuda vs cpu", outs["cuda"],
                       outs["cpu"], prompts, model, packed_cpu, "cpu")
    if report:
        return
    from repro_torch.serve import ServeEngine
    static = rng.integers(0, cfg.vocab_size, (4, 19)).astype(np.int32)
    outs, nll = {}, {}
    for dev in ("cuda", "cpu"):
        eng = ServeEngine(model, qparams, max_seq=64, device=dev)
        toks = eng.generate(static, 16)
        outs[dev] = {i: toks[i] for i in range(len(static))}
        nll[dev] = eng.score(np.concatenate([static, toks], axis=1))
    compare_tokens(torch, f"{arch} static cuda vs cpu", outs["cuda"],
                   outs["cpu"], list(static), model, packed_cpu, "cpu")
    rel = abs(nll["cuda"] - nll["cpu"]) / abs(nll["cpu"])
    log(f"  {arch} static score cuda {nll['cuda']:.7f} vs cpu "
        f"{nll['cpu']:.7f} (rel {rel:.3g}, tol 1e-4: f32 sums in another "
        "order)")
    if not rel <= 1e-4:
        fail(f"{arch}: static score differs between cuda and cpu: rel {rel}")


def http_call(host, port, method, path, payload=None, timeout=600):
    """One request on its own connection: (status, headers, body)."""
    import http.client
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        body = None if payload is None else json.dumps(payload).encode()
        conn.request(method, path, body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def completion_tokens(status, body, stream):
    """Token ids of a /v1/completions answer (SSE frames when streamed)."""
    if status != 200:
        fail(f"front door: HTTP {status}: {body[:300]!r}")
    if not stream:
        return json.loads(body)["choices"][0]["token_ids"]
    frames = [f for f in body.decode().split("\n\n") if f]
    if frames[-1] != "data: [DONE]":
        fail(f"front door: stream did not end with [DONE]: {frames[-1]!r}")
    return [t for f in frames[:-1]
            for t in json.loads(f[len("data: "):])["choices"][0]["token_ids"]]


def traces_metric(host, port):
    status, _, body = http_call(host, port, "GET", "/metrics")
    for line in body.decode().splitlines():
        if line.startswith("msb_traces_compiled_total "):
            return float(line.split()[1])
    fail(f"front door: /metrics has no msb_traces_compiled_total "
         f"(HTTP {status})")


def serve_http(torch, ctx, bits, faults=None):
    """Phase 7's prompts through ``APIServer`` on 127.0.0.1 over an
    ``EngineSupervisor`` (watchdog on; a 1 s floor when ``faults`` are
    injected) whose engine is warmed at start (``warmup=True``): /healthz
    is polled from warming to ok, then every prompt is sent at once, odd
    ones streamed, 32 tokens at temperature 0; a 503 (recovering or
    warming) is retried. Returns the answers, each engine incarnation's
    prefill chunks by prompt, the health states seen, the capture counts
    /metrics showed after warm-up and at the end, and the supervisor with
    its first step worker. Shuts down with the supervisor's page audit."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.serve import APIServer, ContinuousEngine, \
        EngineSupervisor
    model, packed, prompts = ctx["model"], ctx["packed"], ctx["prompts"]
    engine_kw, max_new = ctx["engine_kw"], ctx["max_new"]
    chunks = []

    def factory():
        eng = ContinuousEngine(model, packed, decode_horizon=8,
                               kv_bits=bits, faults=faults, **engine_kw)
        chunks.append(record_chunks(eng, prompts))
        return eng

    sup = EngineSupervisor(factory, **({} if faults is None
                                       else dict(watchdog_floor_s=1.0)))
    first_worker = sup._worker
    srv = APIServer(sup, warmup=True)
    t0 = time.perf_counter()
    host, port = srv.serve_background()
    seen = []
    try:
        while True:
            status, _, body = http_call(host, port, "GET", "/healthz")
            state = json.loads(body)["status"]
            if not seen or seen[-1] != state:
                seen.append(state)
            if state == "ok":
                break
            if state != "warming" or time.perf_counter() - t0 > 600:
                fail(f"front door kv{bits}: /healthz {seen}")
            time.sleep(0.05)
        t_ready = time.perf_counter() - t0
        if seen[0] != "warming":
            fail(f"front door kv{bits}: /healthz never read warming: {seen}")
        traces = traces_metric(host, port)

        def client(i):
            stream = i % 2 == 1
            while True:
                status, _, body = http_call(
                    host, port, "POST", "/v1/completions",
                    {"prompt": prompts[i].tolist(), "max_tokens": max_new,
                     "temperature": 0.0, "stream": stream})
                if status != 503 or time.perf_counter() - t0 > 900:
                    return completion_tokens(status, body, stream)
                time.sleep(0.1)

        t1 = time.perf_counter()
        with ThreadPoolExecutor(len(prompts)) as pool:
            answers = list(pool.map(client, range(len(prompts))))
        t_serve = time.perf_counter() - t1
        if faults is not None:          # the hung step has returned
            first_worker._thread.join(60)
            if first_worker._thread.is_alive():
                fail(f"front door kv{bits}: the abandoned step never ended")
        after = traces_metric(host, port)
    finally:
        srv.close()
    sup.close(check=True)
    return dict(answers=answers, chunks=chunks, seen=seen, t_ready=t_ready,
                t_serve=t_serve, traces=traces, after=after, sup=sup,
                first_worker=first_worker)


def phase_front_door(torch, ctx):
    """Phase 7's packed weights behind the HTTP front door (``serve_http``)
    three times, each held against phase 7-8's direct horizon-8 run:
    kv16, where every answer must carry the direct run's tokens and
    /metrics' capture count must not move after warm-up; kv16 again with
    one step hung 8 s (injected stall), which the watchdog abandons: the
    supervisor rebuilds and re-warms the engine and replays the requests,
    the hung step ends refused by its closed engine, the only captures
    after warm-up are the re-warm's, and the replayed answers agree with
    the direct run up to near ties (a replay prefills generated tokens
    that the direct run decoded); and kv4, where the requests whose tokens
    cannot depend on the batching in either run (``schedule_free``) must
    carry the direct run's tokens and the capture count must not move."""
    from repro_torch.serve import FaultEvent, FaultPlan
    model, packed, prompts = ctx["model"], ctx["packed"], ctx["prompts"]
    ps, max_new = ctx["engine_kw"]["page_size"], ctx["max_new"]
    device = torch.device("cuda")

    def report(name, r, note):
        log(f"  {name}: /healthz {' -> '.join(r['seen'])} in "
            f"{r['t_ready']:.2f} s; {len(prompts)} requests "
            f"({len(prompts) // 2} streamed) x {max_new} tokens in "
            f"{r['t_serve']:.2f} s, {note}; msb_traces_compiled_total "
            f"{r['traces']:.0f} -> {r['after']:.0f}; "
            f"{r['sup'].n_restarts} restarts; clean shutdown")

    direct = ctx["direct"][16]
    r = serve_http(torch, ctx, 16)
    for i, toks in enumerate(r["answers"]):
        if toks != direct[i].tolist():
            fail(f"front door kv16: request {i} over HTTP {toks} != "
                 f"direct {direct[i].tolist()}")
    if r["after"] != r["traces"]:
        fail(f"front door kv16: {r['after'] - r['traces']:.0f} captures "
             "after warm-up")
    report("kv16", r, "tokens identical to the direct H=8 run")

    plan = FaultPlan([FaultEvent("step", 4, "stall", stall_s=8.0)])
    r = serve_http(torch, ctx, 16, faults=plan)
    sup, zombie = r["sup"], r["first_worker"].result
    if not (plan.exhausted and sup.n_watchdog_trips == 1
            and sup.n_restarts == 1):
        fail(f"front door kv16 hang: fired {plan.fired}, "
             f"{sup.n_watchdog_trips} watchdog trips, {sup.n_restarts} "
             "restarts")
    if not (zombie and zombie[0] == "err"
            and "closed engine" in str(zombie[1])):
        fail(f"front door kv16 hang: the abandoned step ended {zombie}")
    rewarm = sup.engine.warmup_entries
    if r["after"] != r["traces"] + rewarm:
        fail(f"front door kv16 hang: {r['after'] - r['traces']:.0f} "
             f"captures after warm-up, the re-warm's {rewarm} expected")
    compare_tokens(torch, "kv16 after a hang vs direct",
                   {i: np.asarray(t) for i, t in enumerate(r["answers"])},
                   direct, prompts, model, packed, device)
    same = sum(t == direct[i].tolist() for i, t in enumerate(r["answers"]))
    report("kv16, step 4 hung 8 s", r,
           f"{same} of {len(prompts)} identical to the direct H=8 run; "
           f"watchdog trip, rebuild and re-warm ({rewarm} captures, "
           f"recovery {sup.recovery_log[0]:.2f} s), "
           f"{sup.n_replayed_tokens} tokens replayed; the hung step "
           "refused by its closed engine")

    direct = ctx["direct"][4]
    r = serve_http(torch, ctx, 4)
    sound = sorted(schedule_free(ctx["direct_chunks"][4], prompts, ps)
                   & schedule_free(r["chunks"][0], prompts, ps))
    if not sound:
        fail("front door kv4: no request's chunks were page-whole in both "
             "runs")
    for i in sound:
        if r["answers"][i] != direct[i].tolist():
            fail(f"front door kv4: request {i} over HTTP {r['answers'][i]} "
                 f"!= direct {direct[i].tolist()}")
    for i, toks in enumerate(r["answers"]):
        if len(toks) != max_new:
            fail(f"front door kv4: request {i} returned {len(toks)} tokens")
    if r["after"] != r["traces"]:
        fail(f"front door kv4: {r['after'] - r['traces']:.0f} captures "
             "after warm-up")
    report("kv4", r, f"requests {sound} identical to the direct H=8 run "
           "(the others had a prefill chunk end mid-page in one of the "
           "runs, where kv4 tokens depend on the batching)")
    log("[front door] ok: kv16, kv16 through a hang, and kv4 served over "
        "HTTP through captured graphs")


# ---------------------------------------------------------------------------
# phase 16: tensor-parallel serving, two ranks on one card
# ---------------------------------------------------------------------------

def rank_launches(ctx, zero=False):
    """On a mesh rank: its process's launch counters, then zeroed when
    ``zero`` (``TPMesh.gather`` runs it on every rank)."""
    counts = read_launch_counters()
    if zero:
        zero_launch_counters()
    return counts


def rank_peak(ctx, reset=False):
    """On a mesh rank: the peak device memory its process allocated (GB),
    then the peak reset when ``reset``."""
    import torch
    if ctx.device.type != "cuda":
        return 0.0
    peak = torch.cuda.max_memory_allocated(ctx.device) / 1e9
    if reset:
        torch.cuda.reset_peak_memory_stats(ctx.device)
    return peak


def rank_next_logits(ctx, key, tokens, kv_bits):
    """On a mesh rank: ``next_logits`` on its shard of the engine installed
    under ``key``, over fresh rank-local pools."""
    import torch
    st = ctx.states[key]
    return next_logits(torch, st.model, st.params, tokens, ctx.device,
                       kv_bits=kv_bits, parallel=st.parallel)


# the largest |logit| difference of a tp = 2 prefill from tp = 1's, as a
# share of tp = 1's largest |logit|, that phase 16 accepts: the bf16 sum
# of the ranks' partial products rounds twice where one device rounds
# once, and a 4-bit KV page amplifies that (a smoke config in bf16 on the
# CPU: ~1.6e-2 at kv16, ~6.2e-2 at kv4; these bounds are 3x and 2.5x that)
TP_LOGIT_TOL = {16: 5e-2, 4: 1.5e-1}


def tp_logit_gaps(torch, device, mesh, eng, model, packed, prompts, bits,
                  tag="tp=2"):
    """Each prompt's next-token logits through the tp = 2 engine's ranks
    against one device's: the largest |difference| over finite logits, as
    a share of the largest |logit|. Held to ``TP_LOGIT_TOL``."""
    rel = []
    for p in prompts:
        a = mesh.run(rank_next_logits, eng.graphs.key, p, bits)
        b = next_logits(torch, model, packed, p, device, kv_bits=bits)
        fin = torch.isfinite(b)
        rel.append(float((a[fin] - b[fin]).abs().max() / b[fin].abs().max()))
    log(f"  {tag} kv{bits}: next-token logits of each prompt against one "
        f"device: largest |difference| / largest |logit| "
        f"{[f'{r:.3g}' for r in rel]} (bound {TP_LOGIT_TOL[bits]})")
    if not max(rel) <= TP_LOGIT_TOL[bits]:
        fail(f"{tag} kv{bits}: next-token logits differ from one device's "
             f"by {max(rel)} of their largest")


def rank_experts(ctx, key):
    """On a mesh rank: the experts its shard of an engine's first MoE layer
    holds (the expert dim of ``wg``'s packed codes)."""
    return int(ctx.states[key].params["dec"]["s0"]["moe"]["wg"]
               .packed.shape[-3])


def tp_counts_ok(name, per_rank, kernels, fa=None):
    """Each rank launched every kernel of ``kernels``, and kernel D exactly
    ``fa`` times where given."""
    for r, counts in enumerate(per_rank):
        if not all(counts[k] > 0 for k in kernels) or (
                fa is not None and counts["flash_attention_fwd"] != fa):
            fail(f"{name}: rank {r} launches {counts}, want {kernels} > 0"
                 + (f" and flash_attention_fwd {fa}" if fa is not None
                    else ""))
    log(f"  {name} launches by rank: {per_rank}")


def tp_continuous(torch, device, mesh, model, packed, prompts, engine_kw,
                  max_new, bits, horizon, kernels, warm):
    """One tp = 2 ``ContinuousEngine`` run of ``prompts`` (the first alone
    until its prompt is cached), warmed first (eagerly: no graph); the
    ranks' counters zeroed just before and read after it, their peaks
    reset before; ``warm``: warmed first (eagerly, no graph); at H=8 the
    first prompts' next-token logits are held against one device's
    (``tp_logit_gaps``). Returns (outputs, per-rank launches)."""
    from repro_torch.serve import ContinuousEngine
    name = f"tp=2 kv{bits} H={horizon}"
    eng = ContinuousEngine(model, packed, decode_horizon=horizon,
                           kv_bits=bits, mesh=mesh, **engine_kw)
    rep = eng.warmup() if warm else None
    if warm and (rep["graphs"] != 0 or not rep["eager"]
                 or rep["entries"] != len(rep["shapes"])):
        fail(f"{name}: warmup report {rep}")
    mesh.gather(rank_launches, True)
    mesh.gather(rank_peak, True)
    t0 = time.perf_counter()
    out, t_pre, t_dec = run_engine(eng, prompts, True, max_new)
    wall = time.perf_counter() - t0
    counts = mesh.gather(rank_launches)
    peaks = mesh.gather(rank_peak)
    if sorted(out) != list(range(len(prompts))) or any(
            len(t) != max_new for t in out.values()):
        fail(f"{name}: not every request returned {max_new} tokens")
    steps = eng.n_decode_steps
    if horizon == 8:
        tp_logit_gaps(torch, device, mesh, eng, model, packed, prompts[:4],
                      bits)
    eng.close()
    eng.cache.check_invariants(expect_idle=True)
    warmed = (f"warm-up {rep['entries']} entries in {rep['seconds']:.2f} s,"
              f" 0 graphs ({rep['eager']}); " if warm else "")
    log(f"  {name}: {warmed}{wall:.2f} s wall, prefill "
        f"{t_pre:.3f} s, decode {t_dec:.3f} s in {steps} eager dispatches "
        f"= {1e3 * t_dec / max(steps, 1):.2f} ms a dispatch "
        f"({1e3 * t_dec / max(steps * horizon, 1):.2f} ms a decode step); "
        f"peak device memory by rank {[f'{p:.3f}' for p in peaks]} GB")
    tp_counts_ok(name, counts, kernels)
    return out, counts


TP_NEW = 16        # phase 16's new tokens a request: the first 16 of
                   # phases 7-8's 32 (eager dispatches on a shared card)


def phase_tp(torch, device, ctx):
    """Phase 16: tensor-parallel serving over two ranks on one card
    (``make_tp_mesh(2, devices=["cuda:0", "cuda:0"])``; gloo collectives
    staged through the host, every dispatch eager), on phase 7's packed
    internlm2-1.8b at full width: ContinuousEngine at kv16 and kv4, H=8
    and H=1, ``TP_NEW`` tokens a request against the first of the tp = 1
    runs of phases 7-8 (identical, or first divergence at a top-2 gap
    < 1e-2 of a prefill at the same kv_bits), each rank's A, unembedding
    and B (kv16) or C (kv4) launched; ServeEngine generate and score of
    phase 9's inputs, exactly 24 D launches a prefill on each rank, tokens
    against phase 9's and the NLL within 1e-3 relative; granite-moe-3b-
    a800m cut to 4 layers at kv16 H=8 against its tp = 1 run, each rank's
    expert batch launched over its 24 of 48 experts. Times are eager
    checks, not speed figures. Returns the per-rank launch counts."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_tp_mesh
    from repro_torch.serve import ContinuousEngine, ServeEngine
    t_phase = time.perf_counter()
    model, packed, prompts = ctx["model"], ctx["packed"], ctx["prompts"]
    engine_kw = ctx["engine_kw"]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mesh = make_tp_mesh(2, devices=[device, device])
    log(f"[tp] mesh of 2 ranks on {device} up in "
        f"{time.perf_counter() - t0:.2f} s")
    out = {}
    try:
        a_path = ("msb_matmul", "msb_unembed")
        for bits, kernel in ((16, "paged_attention_decode"),
                             (4, "paged_attention_decode_quant")):
            res = {}
            for horizon in (8, 1):
                res[horizon], counts = tp_continuous(
                    torch, device, mesh, model, packed, prompts, engine_kw,
                    TP_NEW, bits, horizon, a_path + (kernel,),
                    warm=bits == 16 and horizon == 8)
                if horizon == 8:
                    out[bits] = counts
                ref = {rid: t[:TP_NEW]
                       for rid, t in ctx["direct"][bits].items()}
                same = sum(np.array_equal(res[horizon][r], ref[r])
                           for r in ref)
                log(f"  tp=2 kv{bits} H={horizon}: {same} of {len(ref)} "
                    f"requests' first {TP_NEW} tokens identical to tp=1's")
                # kv16: the near-tie rule. kv4: reported; the 4-bit pages
                # move tp = 2's logits past near ties (TP_LOGIT_TOL)
                compare_tokens(torch, f"tp=2 kv{bits} H={horizon} vs tp=1 "
                               "H=8", res[horizon], ref, prompts, model,
                               packed, device, kv_bits=bits,
                               hold=bits == 16)
            if bits == 4:
                for rid in res[8]:
                    if not np.array_equal(res[8][rid], res[1][rid]):
                        fail(f"tp=2 kv4: request {rid} differs between H=8 "
                             f"and H=1: {res[8][rid]} vs {res[1][rid]}")
                log("  tp=2 kv4 H=8 vs H=1: tokens identical")
        st = ctx["static"]
        eng = ServeEngine(model, packed, max_seq=1024, mesh=mesh)
        log(f"  tp_report: {eng.tp_report}")
        mesh.gather(rank_launches, True)
        t0 = time.perf_counter()
        toks = eng.generate(st["prompts"], TP_NEW)
        t_gen = time.perf_counter() - t0
        out["static"] = mesh.gather(rank_launches, True)
        tp_counts_ok("tp=2 static generate", out["static"], a_path, fa=24)
        t0 = time.perf_counter()
        nll = eng.score(st["scored"])
        t_score = time.perf_counter() - t0
        tp_counts_ok("tp=2 score", mesh.gather(rank_launches, True),
                     ("msb_matmul",), fa=24)
        eng.close()
        rel = abs(nll - st["nll"]) / abs(st["nll"])
        log(f"  tp=2 ServeEngine B={st['prompts'].shape[0]} P="
            f"{st['prompts'].shape[1]}: generate {toks.shape[1]} tokens "
            f"{t_gen:.3f} s eager; score {t_score:.3f} s, NLL {nll:.6f} "
            f"against tp=1 {st['nll']:.6f} (relative {rel:.3g})")
        if not rel < 1e-3:
            fail(f"tp=2 score {nll} vs tp=1 {st['nll']}: relative {rel}")
        compare_tokens(torch, "tp=2 static vs tp=1 static",
                       {i: toks[i] for i in range(len(toks))},
                       {i: st["toks"][i, :TP_NEW] for i in range(len(toks))},
                       list(st["prompts"]), model, packed, device)
        cfg = dataclasses.replace(get_config("granite-moe-3b-a800m"),
                                  n_layers=4)
        mmodel, mpacked = build_leafwise(torch, cfg, device)
        mprompts = serve_prompts(cfg)
        base = ContinuousEngine(mmodel, mpacked, decode_horizon=8,
                                device=device, **engine_kw)
        ref, _, _ = run_engine(base, mprompts, True, 33)
        base.close()
        del base
        eng = ContinuousEngine(mmodel, mpacked, decode_horizon=8, mesh=mesh,
                               **engine_kw)
        experts = mesh.gather(rank_experts, eng.graphs.key)
        mesh.gather(rank_launches, True)
        res, _, t_dec = run_engine(eng, mprompts, True, 33)
        out["moe"] = mesh.gather(rank_launches)
        eng.close()
        log(f"  tp=2 granite-moe (4 of 32 layers): tp_report "
            f"{eng.tp_report}; resident experts by rank {experts} of "
            f"{cfg.n_experts_padded}; decode {t_dec:.3f} s eager")
        if experts != [cfg.n_experts_padded // 2] * 2:
            fail(f"tp=2 granite-moe: resident experts {experts}")
        tp_counts_ok("tp=2 granite-moe kv16 H=8", out["moe"],
                     a_path + ("msb_matmul_experts",
                               "paged_attention_decode"))
        compare_tokens(torch, "tp=2 granite-moe vs tp=1", res, ref,
                       mprompts, mmodel, mpacked, device)
        del mmodel, mpacked
    finally:
        mesh.close()
    torch.cuda.empty_cache()
    log(f"[tp] ok in {time.perf_counter() - t_phase:.1f} s: internlm2-1.8b "
        "at tp = 2 (kv16, kv4; H=8, H=1; static generate and score) and "
        "granite-moe's experts sharded; tokens against tp = 1 (kv4: "
        "logits within bound, H=8 = H=1), every rank's kernels launched, "
        "no process left")
    return out


# ---------------------------------------------------------------------------
# phase 12: the paper's quantizer at full width
# ---------------------------------------------------------------------------

def _get(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def _replace_leaves(tree, paths, fn, path=""):
    """A new tree with ``fn(leaf)`` at ``paths``; other leaves shared."""
    if isinstance(tree, dict):
        return {k: _replace_leaves(v, paths, fn, f"{path}/{k}" if path else k)
                for k, v in tree.items()}
    return fn(tree) if path in paths else tree


def _slices(leaf):
    """Leading-dim slices of a stacked leaf (QTensor or tensor), else the
    leaf itself: per-layer pieces bound the f32 temporaries."""
    from repro_torch.core import map_tensors
    shape = leaf.shape
    if len(shape) < 3:
        return [leaf]
    return [map_tensors(lambda t, i=i: t[i], leaf) for i in range(shape[0])]


def _dense_f32(torch, leaf):
    import dataclasses
    from repro_torch.core import QTensor, dequantize
    if isinstance(leaf, QTensor):
        return dequantize(dataclasses.replace(leaf, dtype=torch.float32))
    return leaf.to(torch.float32)


def quant_error(torch, params, tree, paths):
    """sum ||W - W_hat||^2 / sum ||W||^2 over ``paths`` (f64 sums, per
    layer slice), W_hat dequantized in f32."""
    num = den = 0.0
    for path in paths:
        for w, q in zip(_slices(_get(params, path)),
                        _slices(_get(tree, path))):
            w = w.to(torch.float32)
            d = w - _dense_f32(torch, q)
            num += float(torch.sum(d * d, dtype=torch.float64))
            den += float(torch.sum(w * w, dtype=torch.float64))
    return num / den


def storage_bits(tree, paths, bits_of):
    """Bits per weight over ``paths``, weighted by element count."""
    n = [float(np.prod(_get(tree, p).shape)) for p in paths]
    return sum(bits_of(_get(tree, p)) * k for p, k in zip(paths, n)) / sum(n)


def _baseline(torch, fn, per_tensor):
    """A baseline on one leaf, returned dense in the leaf's dtype: per layer
    slice of a stacked leaf (one scale set per layer for per-tensor RTN,
    as MSB's per-tensor codebooks), and in row chunks when block-wise
    (blocks never straddle rows) to bound the f32 temporaries."""
    rows = 1 << 14

    def one(w):
        if per_tensor or w.shape[0] <= rows:
            return fn(w).to(w.dtype)
        return torch.cat([fn(w[i:i + rows]).to(w.dtype)
                          for i in range(0, w.shape[0], rows)])

    def apply(leaf):
        if leaf.dim() >= 3:
            return torch.stack([one(w) for w in leaf])
        return one(leaf)
    return apply


def quantizer_methods(torch, device):
    """(name, build(params, paths) -> tree, packed?, bits of a leaf) for
    every method of phase 12, solving on ``device``."""
    from repro_torch.core import (QuantPolicy, baselines, quantize_blockwise,
                                  quantize_params, storage_bits_per_weight)

    def policy(**kw):
        return lambda params, paths: quantize_params(
            params, QuantPolicy(**kw), device=device)[0]

    def refine(params, paths):
        return _replace_leaves(params, paths, lambda w: quantize_blockwise(
            w, bits=4, block=64, solver="dp", refine=True))

    def dense(fn, per_tensor=False):
        return lambda params, paths: _replace_leaves(
            params, paths, _baseline(torch, fn, per_tensor))

    def fixed(bits):
        return lambda leaf: bits

    # The dense baselines' bits per weight, metadata included, by their
    # formats: RTN one 16-bit absmax scale a 64-block, NF4 bitsandbytes'
    # f32 absmax a block, HQQ a 16-bit scale and zero a block; per-tensor
    # RTN one scale a layer slice.
    msb = storage_bits_per_weight
    return [
        ("msb_dp_4b64", policy(solver="dp"), True, msb),
        ("msb_kmeans_4b64", policy(solver="kmeans"), True, msb),
        ("msb_wdp_4b64", policy(solver="wdp"), True, msb),
        ("msb_dp_refine_4b64", refine, True, msb),
        ("msb_dp_dq_4b64", policy(solver="dp", double_quant=True), True,
         lambda q: msb(q, double_quant=True)),
        ("msb_wdp_6b_tensor", policy(bits=6, block=-1, solver="wdp"), False,
         msb),
        ("msb_kmeans_6b_tensor", policy(bits=6, block=-1, solver="kmeans"),
         False, msb),
        ("rtn_4b64", dense(lambda w: baselines.rtn_quantize(w, 4, 64)),
         False, fixed(4 + 16 / 64)),
        ("nf4_4b64", dense(lambda w: baselines.nf4_quantize(w, 4, 64)),
         False, fixed(4 + 32 / 64)),
        ("hqq_4b64", dense(lambda w: baselines.hqq_quantize(w, 4, 64)),
         False, fixed(4 + 32 / 64)),
        ("rtn_6b_tensor", dense(lambda w: baselines.rtn_quantize(w, 6, -1),
                                per_tensor=True), False, fixed(6.0)),
    ]


def score_tree(torch, model, tree, scored, ref_logits, device):
    """NLL of ``scored`` through ``ServeEngine.score`` with the launch
    counters of that call, and the mean |next-token logits - ref_logits|
    over the real vocabulary (a plain prefill of the first 512 tokens)."""
    from repro_torch.serve import ServeEngine
    eng = ServeEngine(model, tree, max_seq=1024, device=device)
    vocab = model.cfg.vocab_size
    logits, _ = model.prefill(eng.params, {"tokens": torch.from_numpy(
        scored[:, :-1]).to(device)})
    logits = logits[:, :vocab].float()
    gap = (None if ref_logits is None else
           float(torch.mean(torch.abs(logits - ref_logits))))
    zero_launch_counters()
    nll = eng.score(scored)
    torch.cuda.synchronize()
    return nll, gap, read_launch_counters(), logits


def _levels(q, rows):
    """Level ids (rows, -1) of a QTensor's codes (code 0, an exact zero,
    reads level 0)."""
    import torch
    return torch.clamp(torch.abs(q.codes.reshape(rows, -1).long()) - 1,
                       min=0)


def _row_sse(torch, blocks, levels, scales):
    """Per-row ||w - sign(w) scales[level]||^2 (exact zeros cost 0)."""
    w = blocks.double()
    w_hat = torch.sign(w) * torch.gather(scales.double(), 1, levels.long())
    return torch.sum((w - w_hat) ** 2, dim=1)


def check_card_vs_cpu(torch, name, blocks, card, cpu):
    """Levels and scales identical per row, or a near tie: the row's SSE
    within 1e-6 relative."""
    lc, sc = (t.cpu() for t in card)
    lp, sp = cpu
    same = (lc == lp).all(1) & (sc == sp).all(1)
    b = blocks.cpu().float()
    if not bool(same.all()):
        e_card = _row_sse(torch, b[~same], lc[~same], sc[~same])
        e_cpu = _row_sse(torch, b[~same], lp[~same], sp[~same])
        if not bool((torch.abs(e_card - e_cpu) <= 1e-6 * e_cpu).all()):
            fail(f"quantizer {name}: card and CPU solvers disagree beyond "
                 "a near tie")
    log(f"  card vs CPU {name}: {int(same.sum())} of {len(same)} rows "
        "identical, the rest within a near tie")


def qtensor_matmul_check(torch, w, device):
    """A solver's 4b/64 QTensor straight through kernel A
    (``qtensor_matmul``, no ``pack_params``): it launches on the card,
    agrees with the plain version of the same packing within 1e-2 of
    max|ref| (bf16 output), and a second call packs nothing again."""
    from repro_torch.core import quantize_blockwise
    from repro_torch.kernels.msb_matmul import ops, ref
    q = quantize_blockwise(w, solver="dp")
    x = torch.randn((8, w.shape[0]), generator=torch.Generator(
        device=device).manual_seed(3), device=device).to(torch.bfloat16)
    launches = ops.msb_matmul.launches
    y = ops.qtensor_matmul(x, q)
    pq = ops._cached_pack(q)
    y2 = ops.qtensor_matmul(x, q)
    if ops._cached_pack(q) is not pq or not torch.equal(y, y2):
        fail("qtensor_matmul packed the same QTensor again")
    y_ref = ref.msb_matmul_ref(x, pq.packed, pq.scales)
    err = float((y.float() - y_ref.float()).abs().max())
    tol = 1e-2 * float(y_ref.float().abs().max())
    launched = ops.msb_matmul.launches - launches
    if launched != 2:
        fail(f"qtensor_matmul launched kernel A {launched} times, want 2")
    if not err <= tol:
        fail(f"qtensor_matmul: max err {err} > {tol}")
    log(f"  qtensor_matmul on a DP 4b/64 {tuple(w.shape)} QTensor, M=8: "
        f"err {err:.3g} (tol {tol:.3g}), kernel A launched {launched} times "
        "in 2 calls, packed once")


def quantizer_solver_checks(torch, params, device):
    """The card's solvers against their plain CPU run of the same code
    (no kernel carries them); ``qtensor_matmul`` on a solver's output; the
    paper's numpy solvers on the host; GPTQ on one full-width matrix."""
    from repro_torch.core import (baselines, quantize_blockwise,
                                  quantize_pertensor, solve_blocks)
    wq = params["dec"]["s0"]["attn"]["wq"][0]
    blocks = wq.reshape(-1, 64)[:4096].to(torch.float32)
    for method in ("dp", "kmeans", "wdp"):
        card = solve_blocks(blocks, 8, method=method)
        cpu = solve_blocks(blocks.cpu(), 8, method=method)
        check_card_vs_cpu(torch, f"{method} 4096 blocks", blocks, card, cpu)
    qtensor_matmul_check(torch, wq, device)
    t0 = time.perf_counter()
    qc = quantize_pertensor(wq)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    qp = quantize_pertensor(wq.cpu())
    flat = wq.reshape(1, -1).to(torch.float32)
    check_card_vs_cpu(torch, f"wdp 6-bit per-tensor {tuple(wq.shape)} "
                      f"({t_card:.3f} s on the card)", flat,
                      (_levels(qc, 1), qc.scales), (_levels(qp, 1),
                                                    qp.scales))
    # zero-free blocks: an exact zero reconstructs exactly, which the
    # interval objective the DP minimizes does not model
    small = blocks[:256]
    small = small[(small != 0).all(1)]
    rows = small.shape[0]
    dp = quantize_blockwise(small, solver="dp")
    e_dp = _row_sse(torch, small, _levels(dp, rows), dp.scales.reshape(
        rows, 8))
    for solver in ("wgm", "gg", "dg", "wgm_lo"):
        t0 = time.perf_counter()
        q = quantize_blockwise(small, solver=solver)
        t = time.perf_counter() - t0
        e = _row_sse(torch, small, _levels(q, rows), q.scales.reshape(
            rows, 8))
        if not bool((e >= e_dp * (1 - 1e-5)).all()):
            fail(f"quantizer {solver}: a heuristic beat the exact DP")
        log(f"  numpy {solver} on {rows} blocks (host): {t:.2f} s, SSE "
            f"{float(e.sum()):.6f} >= DP {float(e_dp.sum()):.6f}")
    w = wq.t().contiguous()
    t0 = time.perf_counter()
    g = baselines.gptq_quantize(w, 4, 64)
    torch.cuda.synchronize()
    t = time.perf_counter() - t0
    w32 = w.to(torch.float32)
    rel = float(torch.sum((g - w32) ** 2) / torch.sum(w32 ** 2))
    rtn = baselines.rtn_quantize(w, 4, 64)
    rel_rtn = float(torch.sum((rtn - w32) ** 2) / torch.sum(w32 ** 2))
    if not (np.isfinite(rel) and g.shape == w.shape):
        fail(f"quantizer gptq: relative error {rel}")
    log(f"  gptq 4b/64 on {tuple(w.shape)} (float64 on the card): {t:.2f} "
        f"s, weight rel err {rel:.6f} (RTN {rel_rtn:.6f}; GPTQ minimizes "
        "the output error on its calibration, not this)")


def phase_quantizer(torch, device):
    """12. quantizer — the paper's granularities and solvers on full-width
    internlm2-1.8b cut to ``QUANT_LAYERS`` of its 24 layers (random bf16
    weights, seed 0), each quantized model scored through
    ``ServeEngine`` against the unquantized one."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.core import QuantPolicy
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config("internlm2-1.8b"),
                              n_layers=QUANT_LAYERS)
    model = Model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0),
                        device=device)
    paths = [p for p, leaf in _leaves(params)
             if QuantPolicy().selects(p, leaf)]
    n_w = sum(int(np.prod(_get(params, p).shape)) for p in paths)
    scored = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (8, 513)).astype(np.int32)
    nll_ref, _, counts, ref_logits = score_tree(torch, model, params, scored,
                                                None, device)
    log(f"[quantizer] {cfg.name} full width ({cfg.n_layers} of 24 layers, d "
        f"{cfg.d_model}, d_ff {cfg.d_ff}, vocab {cfg.vocab_padded}, "
        f"{cfg.dtype}); {len(paths)} leaves, {n_w / 1e9:.3f} G weights "
        f"quantized; unquantized score of {scored.shape}: NLL {nll_ref:.6f}, "
        f"launches {counts}")
    results = {}
    for name, build, packed, bits_of in quantizer_methods(torch, device):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tree = build(params, paths)
        torch.cuda.synchronize()
        t_q = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 1e9
        err = quant_error(torch, params, tree, paths)
        bits = storage_bits(tree, paths, bits_of)
        nll, gap, counts, _ = score_tree(torch, model, tree, scored,
                                         ref_logits, device)
        del tree
        results[name] = err
        log(f"  {name}: quantize {t_q:.2f} s (peak {peak:.2f} GB), rel err "
            f"{err:.6f}, {bits:.4f} bits/weight, NLL {nll:.6f} (gap "
            f"{nll - nll_ref:+.6f}), logit gap {gap:.6f}, launches {counts}")
        if not all(np.isfinite(x) for x in (err, bits, nll, gap)):
            fail(f"quantizer {name}: a non-finite value")
        if counts["flash_attention_fwd"] != cfg.n_layers:
            fail(f"quantizer {name}: kernel D launched "
                 f"{counts['flash_attention_fwd']} times in score, want "
                 f"{cfg.n_layers}")
        if packed != (counts["msb_matmul"] > 0):
            fail(f"quantizer {name}: kernel A launched "
                 f"{counts['msb_matmul']} times in score (packed: {packed})")
    dp = results["msb_dp_4b64"]
    for other in ("msb_kmeans_4b64", "msb_dp_dq_4b64", "rtn_4b64",
                  "nf4_4b64", "hqq_4b64"):
        if dp > results[other]:
            fail(f"quantizer: MSB-DP's error {dp} above {other}'s "
                 f"{results[other]}")
    for same in ("msb_wdp_4b64", "msb_dp_refine_4b64"):
        if abs(results[same] - dp) > 1e-6 * dp:
            fail(f"quantizer: {same}'s error {results[same]} is not DP's "
                 f"{dp}")
    if not results["msb_wdp_6b_tensor"] < results["rtn_6b_tensor"]:
        fail("quantizer: 6-bit per-tensor WDP not below RTN")
    quantizer_solver_checks(torch, params, device)
    del params
    log(f"[quantizer] ok: {time.perf_counter() - t_phase:.1f} s; error "
        "order DP <= kmeans, DP+DQ, RTN, NF4, HQQ at 4b/64, WDP and refine "
        "equal to DP, per-tensor WDP < RTN at 6 bits")


# ---------------------------------------------------------------------------
# phase 13: the model families at full width
# ---------------------------------------------------------------------------

# the continuous engine of phase 13: phase 7's, its block tables wide
# enough for a request past gemma2's 4096-token window
FAMILY_ENGINE = dict(SERVE_ENGINE, max_seq=4736)
# phase 13's depth (gemma2 26, granite-moe 32 layers) and phase 12's
# (internlm2 24), cut to keep the smoke within its time limit on a busy
# host: widths, windows (on even layers) and the expert count stay.
# Phases 12 and 13 gave phase 20 its time: 8 layers each until then
FAMILY_LAYERS = 2
QUANT_LAYERS = 2
LONG_PROMPT = 4500           # one of phase 13's gemma2 requests
STATIC_PROMPT = 4608         # gemma2's static prefill: D with the window


def build_leafwise(torch, cfg, device):
    """``cfg`` with random weights from seed 0 on the card, each leaf
    drawn, 4-bit block-64 DP quantized on the card and packed before the
    next is drawn (``init_leaves``), so the f32 tree never exists whole
    (jamba's cut 13.3B weights would be 53 GB in f32). Same numbers as
    ``Model.init`` from that seed. Returns (model, packed params)."""
    from repro_torch.core import QuantPolicy, pack_params, quantize_params
    from repro_torch.models import Model
    from repro_torch.models.transformer import _nest, init_leaves
    policy = QuantPolicy(bits=4, block=64, solver="dp")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flat, t_init, t_quant, n_quant = {}, 0.0, 0.0, 0
    leaves = init_leaves(cfg, torch.Generator(device=device).manual_seed(0),
                         device)
    while True:
        t0 = time.perf_counter()
        item = next(leaves, None)
        torch.cuda.synchronize()
        t_init += time.perf_counter() - t0
        if item is None:
            break
        path, leaf = item
        del item
        t0 = time.perf_counter()
        q, report = quantize_params(_nest({path: leaf}), policy,
                                    device=device)
        del leaf
        node, _ = pack_params(q, device=device)
        del q
        for part in path.split("/"):
            node = node[part]
        flat[path] = node
        torch.cuda.synchronize()
        t_quant += time.perf_counter() - t0
        n_quant += len(report)
    packed = _nest(flat)
    pbytes = sum(t.numel() * t.element_size() for _, leaf in _leaves(packed)
                 for t in _tensors(leaf))
    log(f"  {cfg.name} ({cfg.n_layers} layers"
        + (f" + {cfg.n_enc_layers} encoder" if cfg.is_encdec else "")
        + f", d {cfg.d_model}, {cfg.n_heads} heads, {cfg.n_kv_heads} KV "
        f"heads, head_dim {cfg.head_dim_}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_padded}"
        + (f", {cfg.n_experts} experts top-{cfg.n_experts_active}"
           if cfg.n_experts else "")
        + f"): init {t_init:.3f} s, DP quantize + pack of {n_quant} tensors "
        f"on the card {t_quant:.2f} s, packed params {pbytes / 1e9:.3f} GB, "
        f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.3f} "
        "GB")
    return Model(cfg), packed


def check_counts(name, counts, fa, experts, unembed=True):
    """Kernel D launched exactly ``fa`` times; A at least once, and the
    unembedding's kernel where ``unembed`` (the logits of prefill and
    decode; the loss's cross-entropy multiplies the dequantized table, as
    the reference's does); the expert batch iff ``experts``."""
    if not (counts["flash_attention_fwd"] == fa and counts["msb_matmul"] > 0
            and (counts["msb_unembed"] > 0) == unembed
            and (counts["msb_matmul_experts"] > 0) == experts):
        fail(f"{name}: launches {counts}, want flash_attention_fwd {fa}, "
             f"msb_matmul > 0, msb_unembed {'> 0' if unembed else '0'}, "
             f"msb_matmul_experts {'> 0' if experts else '0'}")


def timed(torch, fn):
    """(fn(), wall seconds, launch counts), counters zeroed just before."""
    torch.cuda.synchronize()
    zero_launch_counters()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, read_launch_counters()


def state_static(torch, model, packed, b, p, n, fa, device):
    """``ServeEngine`` on ``b`` random prompts of ``p`` tokens (seed 7):
    the prefill alone, then ``generate`` of ``n`` greedy tokens and
    ``score`` of the prompts and the first token, counters zeroed before
    each. Kernel D launches ``fa`` times in each (prefill and the loss
    forward; the ring decode runs no kernel D). Returns (engine, prompts,
    the generate's counts)."""
    from repro_torch.serve import ServeEngine
    cfg = model.cfg
    prompts = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (b, p)).astype(np.int32)
    eng = ServeEngine(model, packed, max_seq=p + n, device=device)
    eng.generate(prompts[:, :16], 2)           # lazy set-up, untimed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tokens = torch.from_numpy(prompts).to(device)
    (logits, _), t_pre, pre_counts = timed(
        torch, lambda: model.prefill(eng.params, {"tokens": tokens}))
    check_counts(f"{cfg.name} prefill", pre_counts, fa, bool(cfg.n_experts))
    if not torch.isfinite(logits[:, :cfg.vocab_size]).all():
        fail(f"{cfg.name}: prefill logits not finite")
    toks, wall, counts = timed(torch, lambda: eng.generate(prompts, n))
    check_counts(f"{cfg.name} generate", counts, fa, bool(cfg.n_experts))
    if toks.shape != (b, n) or not ((toks >= 0) & (toks < cfg.vocab_size)
                                    ).all():
        fail(f"{cfg.name}: tokens of shape {toks.shape} or out of range")
    peak = torch.cuda.max_memory_allocated()
    nll, t_score, score_counts = timed(torch, lambda: eng.score(
        np.concatenate([prompts, toks[:, :1]], axis=1)))
    check_counts(f"{cfg.name} score", score_counts, fa, bool(cfg.n_experts),
                 unembed=False)
    if not np.isfinite(nll):
        fail(f"{cfg.name}: score {nll}")
    dec = wall - t_pre
    log(f"  {cfg.name} ServeEngine B={b} P={p}: prefill {t_pre:.3f} s "
        f"({b * p / t_pre:.1f} tok/s), launches {pre_counts}; generate {n} "
        f"tokens {wall:.3f} s wall, decode {dec:.3f} s ({b * n / dec:.1f} "
        f"tok/s), launches {counts}; peak device memory {peak / 1e9:.3f} "
        f"GB; score of ({b}, {p + 1}) NLL {nll:.6f} in {t_score:.3f} s, "
        f"launches {score_counts}")
    return eng, prompts, counts


# new tokens per request of the report-only runs: rows finish mid-horizon,
# so a finished row's no-op iterations write the scratch page, which an
# MoE wave's pads read where an expert can overflow (ROADMAP §3)
UNEVEN_NEW = [32, 27, 30, 21, 33, 25, 29, 31]


def first_divergences(a, b):
    """{request: first step whose greedy token differs} over requests
    whose outputs differ between two runs."""
    return {r: int(np.argmax(a[r] != b[r])) for r in sorted(a)
            if not np.array_equal(a[r], b[r])}


def report_horizons(torch, model, packed, prompts, bits):
    """Report only: ``prompts`` with ``UNEVEN_NEW`` tokens through warmed
    H=8 and H=1 engines at the config's own capacity factor; every
    request must finish with its count and nothing may be captured after
    warm-up, but the requests whose tokens differ between the horizons are
    logged, not held."""
    from repro_torch.serve import ContinuousEngine, jit_trace_count
    res = {}
    for horizon in (8, 1):
        eng = ContinuousEngine(model, packed, decode_horizon=horizon,
                               kv_bits=bits, **FAMILY_ENGINE)
        name = f"kv{bits} H={horizon} uneven"
        warm(torch, eng, name)
        n0 = jit_trace_count()
        res[horizon], _, _ = run_engine(eng, prompts, True, UNEVEN_NEW)
        if jit_trace_count() != n0:
            fail(f"{name}: {jit_trace_count() - n0} captures after warmup")
        if [len(res[horizon].get(i, ())) for i in range(len(prompts))] != \
                UNEVEN_NEW:
            fail(f"{name}: a request did not return its token count")
        eng.close()
        del eng
    cfg = model.cfg
    log(f"  {cfg.name} kv{bits} capacity_factor {cfg.capacity_factor}, new "
        f"tokens {UNEVEN_NEW} (report only): H=8 vs H=1 requests differing "
        f"at steps {first_divergences(res[8], res[1])}")


def serve_family(torch, device, model, packed, prompts, bits_list,
                 path_kernels, max_new=32):
    """Phase 7's checks for one family at each kv_bits: graph replay
    bitwise against eager, H=8 and H=1 engines warmed (no capture after),
    counters zeroed before the H=8 run, tokens H=8 against H=1 (near ties
    only). ``path_kernels`` must launch, and kernel B (kv16) or C (kv8,
    kv4) with them. Returns {kv_bits: H=8 launch counts}."""
    counts = {}
    for bits in bits_list:
        attention = ("paged_attention_decode" if bits == 16
                     else "paged_attention_decode_quant")
        results, counts[bits], kv_bytes, _ = serve_horizons(
            model, packed, prompts, FAMILY_ENGINE, max_new, bits,
            path_kernels + (attention,))
        log(f"  {model.cfg.name} kv{bits} pools: {kv_bytes / 1e9:.3f} GB")
        compare_tokens(torch, f"{model.cfg.name} kv{bits} H=8 vs H=1",
                       results[8], results[1], prompts, model, packed, device)
    return counts


def phase_families(torch, device):
    """Phase 13: the model families the paged engine serves, at full
    width with random weights (seed 0), cut in depth to ``FAMILY_LAYERS``
    layers, each quantized (4b/64 DP) and packed on the card and freed
    before the next:
    * gemma2-2b (of 26 layers, head_dim 256, window 4096 on its even
      layers, softcaps 50 and 30, post-norm, tied 256000-row table):
      ContinuousEngine at kv16 and kv4 with phase 7's prompts but the last
      4500 tokens long, so the window binds in B, C and the packed
      prefill; decode-step profiles at kv16 and kv4; ServeEngine on 2
      prompts of 4608 tokens (D with the window), then score;
    * granite-moe-3b-a800m (of 32 layers, 40 experts padded to 48,
      top-8):
      ContinuousEngine at kv16 (the expert batch of kernel A on every MoE
      layer), then at kv16 and kv4 with uneven new-token counts at its own
      capacity (``report_horizons``: H=8 against H=1 reported, not held),
      its decode-step profile, ServeEngine generate and score;
    then the smoke configs of gemma2 (window 6, binding), granite-moe,
    qwen1.5-0.5b (qkv bias) and arctic-480b (MoE beside a dense MLP)
    served on the card and on the CPU from the same weights. Returns the
    launch counts the kernel line reads."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.serve import ContinuousEngine
    out = {}
    t0 = time.perf_counter()
    model, packed = build_leafwise(torch, dataclasses.replace(
        get_config("gemma2-2b"), n_layers=FAMILY_LAYERS), device)
    prompts = serve_prompts(model.cfg, last=LONG_PROMPT)
    out["gemma2"] = serve_family(torch, device, model, packed, prompts,
                                 (16, 4), ("msb_matmul", "msb_unembed"))
    short = serve_prompts(model.cfg)
    for bits in (16, 4):
        log(f"  gemma2-2b kv{bits}:")
        profile_decode(torch, ContinuousEngine(model, packed, kv_bits=bits,
                                               **FAMILY_ENGINE), short, 32)
    out["gemma2_static"] = state_static(torch, model, packed, 2,
                                        STATIC_PROMPT, 8,
                                        model.cfg.n_layers, device)[2]
    log(f"  device memory: {torch.cuda.memory_allocated() / 1e9:.3f} GB in "
        f"use, peak {torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    del model, packed
    torch.cuda.empty_cache()
    log(f"  gemma2-2b done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    model, packed = build_leafwise(torch, dataclasses.replace(
        get_config("granite-moe-3b-a800m"), n_layers=FAMILY_LAYERS), device)
    prompts = serve_prompts(model.cfg)
    # 33 new tokens: 32 decoded, whole horizons of 8, so no row finishes
    # mid-horizon. A finished row's no-op iterations write the scratch
    # page, which an MoE wave's pads read (ROADMAP §3): H=8 and H=1 would
    # then see other scratch bytes in a later wave
    out["moe"] = serve_family(torch, device, model, packed, prompts, (16,),
                              ("msb_matmul", "msb_matmul_experts",
                               "msb_unembed"),
                              max_new=33)
    for bits in (16, 4):
        report_horizons(torch, model, packed, prompts, bits)
    log("  granite-moe-3b-a800m kv16:")
    profile_decode(torch, ContinuousEngine(model, packed, **FAMILY_ENGINE),
                   prompts, 32)
    out["moe_static"] = state_static(torch, model, packed, 8, 512, 32,
                                     model.cfg.n_layers, device)[2]
    log(f"  device memory: {torch.cuda.memory_allocated() / 1e9:.3f} GB in "
        f"use, peak {torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    del model, packed
    torch.cuda.empty_cache()
    log(f"  granite-moe-3b-a800m done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    paths_check(torch, "gemma2-2b", (16, 4), sliding_window=6)
    paths_check(torch, "granite-moe-3b-a800m", (16,))
    # kv4 MoE with a capacity no expert can overflow: its pads read the
    # scratch page, which the quantized commit writes through duplicate
    # indices in another order on the card than on the CPU (ROADMAP §3)
    paths_check(torch, "granite-moe-3b-a800m", (4,), capacity_factor=8.0)
    # and at its own capacity with uneven lengths: reported, not held
    paths_check(torch, "granite-moe-3b-a800m", (8, 4), report=True)
    paths_check(torch, "qwen1.5-0.5b", (16, 4))
    paths_check(torch, "arctic-480b", (16,))
    # an attention stack without RoPE: the paged steps add sinusoids
    paths_check(torch, "internlm2-1.8b", (16, 8, 4), use_rope=False)
    log(f"  smoke configs on card and CPU in {time.perf_counter() - t0:.1f}"
        " s")
    log("[families] ok: gemma2-2b (kv16, kv4; window binding) and "
        "granite-moe-3b-a800m (kv16) served at full width, warmed, replay "
        "bitwise against eager, no capture after warm-up, H=8 tokens against"
        " H=1; static generate and score; smoke gemma2, granite-moe, qwen, "
        "arctic and internlm2 without RoPE (kv16/8/4) agree between card and"
        " CPU")
    return out


# ---------------------------------------------------------------------------
# phase 14: the stacks with per-sequence state
# ---------------------------------------------------------------------------

def recurrence_costs(torch, cfg, params, b, device, n=4):
    """Each recurrent layer kind of ``cfg`` alone (layer 0's mamba, sLSTM
    or mLSTM block: its projections and its plain-PyTorch recurrence):
    the wall ms of a ``STATE_PROMPT``-position prefill of ``b`` rows,
    then wall ms, device-busy ms and device kernels of one decode step
    from that state (torch.profiler over ``n`` steps)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.quantize import map_tensors
    from repro_torch.models import ssm, xlstm
    from repro_torch.models.transformer import layer_plan
    fns = {"mamba": ssm.mamba_layer, "slstm": xlstm.slstm_layer,
           "mlstm": xlstm.mlstm_layer}
    gen = torch.Generator(device=device).manual_seed(11)
    seen = set()
    for slot, (mixer, _) in enumerate(layer_plan(cfg)):
        if mixer not in fns or mixer in seen:
            continue
        seen.add(mixer)
        fn = fns[mixer]
        lp = map_tensors(lambda t: t[0], params["dec"][f"s{slot}"][mixer])
        x = torch.randn((b, STATE_PROMPT, cfg.d_model), generator=gen,
                        device=device).to(cfg.dtype)
        x1 = x[:, :1].contiguous()
        fn(lp, x[:, :16], cfg)                          # untimed set-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, state = fn(lp, x, cfg)
        torch.cuda.synchronize()
        t_pre = (time.perf_counter() - t0) * 1e3
        fn(lp, x1, cfg, state)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                fn(lp, x1, cfg, state)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / n * 1e3
        log(f"  {cfg.name} one {mixer} layer, plain torch: prefill of "
            f"{b} x {STATE_PROMPT} {t_pre:.2f} ms")
        device_breakdown(prof, wall, n, f"one {mixer} layer's decode step "
                         f"(B={b})")


def frontend_batch(torch, cfg, b, p, device, gen):
    """Random prompts of ``p`` tokens (seed 7) and the frontend's inputs
    from ``gen``: whisper's audio frames (b, 1500, d_model), internvl's
    ``n_frontend_tokens`` patch embeddings, in ``cfg.dtype``."""
    batch = {"tokens": torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (b, p)).astype(np.int32)).to(device)}
    if cfg.is_encdec:
        batch["frames"] = torch.randn((b, WHISPER_FRAMES, cfg.d_model),
                                      generator=gen, device=device).to(
                                          cfg.dtype)
    if cfg.frontend == "vision":
        batch["patch_embeds"] = torch.randn(
            (b, cfg.n_frontend_tokens, cfg.d_model), generator=gen,
            device=device).to(cfg.dtype)
    return batch


def grown_prefill(torch, model, params, batch, max_seq):
    """``Model.prefill`` of ``batch`` and its cache grown to ``max_seq``
    (``ServeEngine._grow_cache``: attention K/V only). Returns (logits,
    cache, the next position (B,))."""
    from repro_torch.serve import ServeEngine
    logits, cache = model.prefill(params, batch)
    s0 = cache["pos"].shape[1] if "pos" in cache else batch[
        "tokens"].shape[1]
    cache = ServeEngine(model, {}, max_seq=max_seq,
                        device=logits.device)._grow_cache(cache, s0)
    cur = torch.full((logits.shape[0],), s0, dtype=torch.int32,
                     device=logits.device)
    return logits, cache, cur


def decode_greedy(torch, model, params, logits, cache, cur, n,
                  keep_logits=False):
    """``n`` greedy ``decode_step``s from ``logits`` and ``cache`` (the
    reference's stepwise generate: sample, decode, advance), on the
    device with no sync until the tokens are read. Returns (tokens (B, n)
    numpy, the logits each token was drawn from on the CPU where
    ``keep_logits``, else [])."""
    toks, seen = [], []
    for _ in range(n):
        if keep_logits:
            seen.append(logits.float().cpu())
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        toks.append(tok)
        logits, cache = model.decode_step(params, cache, tok[:, None], cur)
        cur = cur + 1
    return torch.stack(toks, 1).cpu().numpy(), seen


def frontend_static(torch, model, packed, b, p, n, fa, device):
    """``Model.prefill`` of ``b`` prompts of ``p`` tokens with the
    frontend's inputs, ``n`` greedy ``decode_step``s from its grown cache
    (timed alone), then ``Model.loss`` on the same batch; counters zeroed
    before each; kernel D launches ``fa`` times in the prefill and in the
    loss, never in a decode step. Whisper's encoder also runs alone, its
    D launches counted. Returns (the prefill's counts, the encoder's
    counts or None)."""
    cfg = model.cfg
    batch = frontend_batch(torch, cfg, b, p, device,
                           torch.Generator(device=device).manual_seed(8))
    extra = cfg.n_frontend_tokens if cfg.frontend == "vision" else 0
    warm = {k: v[:, :16] for k, v in batch.items()}    # untimed set-up
    decode_greedy(torch, model, packed,
                  *grown_prefill(torch, model, packed, warm, 48), 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    (logits, cache, cur), t_pre, pre_counts = timed(
        torch, lambda: grown_prefill(torch, model, packed, batch,
                                     p + extra + n))
    check_counts(f"{cfg.name} prefill", pre_counts, fa, False)
    if not torch.isfinite(logits[:, :cfg.vocab_size]).all():
        fail(f"{cfg.name}: prefill logits not finite")
    (toks, _), t_dec, counts = timed(torch, lambda: decode_greedy(
        torch, model, packed, logits, cache, cur, n))
    check_counts(f"{cfg.name} decode", counts, 0, False)
    if not ((toks >= 0) & (toks < cfg.vocab_size)).all():
        fail(f"{cfg.name}: greedy tokens out of range")
    peak = torch.cuda.max_memory_allocated()
    del logits, cache
    enc_counts = None
    if cfg.is_encdec:
        _, _, enc_counts = timed(torch, lambda: model._encoder(packed,
                                                               batch))
        if enc_counts["flash_attention_fwd"] != cfg.n_enc_layers:
            fail(f"{cfg.name}: the encoder alone launched D "
                 f"{enc_counts['flash_attention_fwd']} times, want "
                 f"{cfg.n_enc_layers}")
    labels = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab_size, (b, p + extra)).astype(np.int32)).to(device)
    (loss, _), t_loss, loss_counts = timed(
        torch, lambda: model.loss(packed, dict(batch, labels=labels)))
    check_counts(f"{cfg.name} loss", loss_counts, fa, False, unembed=False)
    if not torch.isfinite(loss):
        fail(f"{cfg.name}: loss {float(loss)}")
    log(f"  {cfg.name} B={b} P={p}"
        + (f" + {extra} patches" if extra else "")
        + (f" + {WHISPER_FRAMES} frames" if cfg.is_encdec else "")
        + f": prefill {t_pre:.3f} s ({b * (p + extra) / t_pre:.1f} tok/s), "
        f"launches {pre_counts}"
        + (f" (the encoder alone {enc_counts['flash_attention_fwd']} D)"
           if enc_counts else "")
        + f"; {n} greedy decode_steps {t_dec:.3f} s ({b * n / t_dec:.1f} "
        f"tok/s), launches {counts}; peak device memory {peak / 1e9:.3f} "
        f"GB; loss {float(loss):.6f} in {t_loss:.3f} s, launches "
        f"{loss_counts}")
    return pre_counts, enc_counts


def state_paths_check(torch, arch):
    """``arch``'s smoke config (fp32) on the card and on the CPU from the
    same quantized weights (4-bit block-64 DP, min_size 1024): prefill and
    16 greedy decode steps of 4 prompts of 19 tokens (with whisper's 24
    frames or internvl's patch embeddings); jamba and xlstm also through
    ``ServeEngine.generate`` (its tokens those of the stepwise loop on the
    same device) and ``score``, whisper and internvl through
    ``Model.loss``. Greedy tokens agree or first diverge at a top-2 logit
    gap < 1e-2 (the CPU's logits at that step); the loss within 1e-4
    relative."""
    from repro_torch.configs import smoke_config
    from repro_torch.core import QuantPolicy, quantize_params
    from repro_torch.models import Model
    from repro_torch.serve import ServeEngine
    cfg = smoke_config(arch)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    qparams, _ = quantize_params(params, QuantPolicy(min_size=1024),
                                 device="cpu")
    batch = frontend_batch(torch, cfg, 4, 19, "cpu",
                           torch.Generator().manual_seed(1))
    if cfg.is_encdec:
        batch["frames"] = batch["frames"][:, :24]
    extra = cfg.n_frontend_tokens if cfg.frontend == "vision" else 0
    labels = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (4, 19 + extra)).astype(np.int32))
    served = not (cfg.is_encdec or extra)       # jamba, xlstm
    toks, seen, loss = {}, {}, {}
    card, cpu = "cuda", "cpu"
    for dev in (card, cpu):
        eng = ServeEngine(model, qparams, max_seq=64, device=dev)
        b_dev = {k: v.to(dev) for k, v in batch.items()}
        toks[dev], seen[dev] = decode_greedy(
            torch, model, eng.params,
            *grown_prefill(torch, model, eng.params, b_dev, 64), 16,
            keep_logits=True)
        if served:
            gen = eng.generate(batch["tokens"].numpy(), 16)
            if not np.array_equal(gen, toks[dev]):
                fail(f"{arch} {dev}: ServeEngine.generate differs from the "
                     "stepwise loop")
            loss[dev] = eng.score(np.concatenate(
                [batch["tokens"].numpy(), gen], axis=1))
        else:
            loss[dev] = float(model.loss(eng.params, dict(
                b_dev, labels=labels.to(dev)))[0])
    for r in range(4):
        a, c = toks[card][r], toks[cpu][r]
        if np.array_equal(a, c):
            continue
        i = int(np.argmax(a != c))
        gap = top2_gap(seen[cpu][i][r, :cfg.vocab_size])
        log(f"  {arch} cuda vs cpu: row {r} diverges at step {i} ({a[i]} vs "
            f"{c[i]}), top-2 logit gap {gap:.3g}")
        if not gap < 1e-2:
            fail(f"{arch}: cuda vs cpu diverge at step {i} of row {r} with "
                 f"top-2 gap {gap} >= 1e-2")
    rel = abs(loss[card] - loss[cpu]) / abs(loss[cpu])
    log(f"  {arch} smoke cuda vs cpu: greedy tokens identical or near-tie "
        f"only; {'score' if served else 'loss'} cuda {loss[card]:.7f} vs "
        f"cpu {loss[cpu]:.7f} (rel {rel:.3g}, tol 1e-4)")
    if not rel <= 1e-4:
        fail(f"{arch}: loss differs between cuda and cpu: rel {rel}")


WHISPER_FRAMES = 1500        # whisper's encoder: 30 s of audio frames
STATE_PROMPT = 512           # jamba's and xlstm's static prompts


def phase_state_stacks(torch, device):
    """Phase 14: the stacks with per-sequence state, at full width with
    random weights from seed 0, each drawn, quantized (4b/64 DP) and
    packed leaf by leaf on the card (``build_leafwise``) and freed before
    the next:
    * xlstm-125m, full size (12 layers, sLSTM / mLSTM, no attention):
      ``ServeEngine`` B=8 x 512, 32 greedy tokens, ``score`` (8, 513);
      kernel D 0 times;
    * jamba-v0.1-52b at full width cut to one period of 8 layers (7 mamba,
      1 attention; 4 MoE layers of 16 experts, 4 dense MLPs): its 32
      layers (52B weights, ~52 GB packed) do not fit one card beside the
      engine. ``ServeEngine`` B=4 x 512, 32 tokens, ``score`` (4, 513);
      D once a prefill, the expert batch on every MoE layer;
    * whisper-large-v3, full size (32 + 32 layers): 1500 frames and
      64-token prompts, B=4; ``Model.prefill``, 32 greedy ``decode_step``s,
      ``Model.loss``; D 96 times a prefill (32 encoder, 32 decoder, 32
      cross-attention);
    * internvl2-76b at full width cut to 2 layers: 1024 patch embeddings
      and 64 tokens, B=2; prefill, 16 decode steps, loss; D twice.
    Decode-step profiles of jamba and xlstm; then the smoke configs of
    all four on the card and on the CPU (``state_paths_check``). Returns
    {name: launch counts of its main run (the prefill's for whisper and
    internvl)}, and under "whisper-encoder" the launch counts of
    whisper's encoder run alone."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import layer_plan, n_periods
    out = {}
    runs = [("xlstm-125m", {}), ("jamba-v0.1-52b", dict(n_layers=8)),
            ("whisper-large-v3", {}), ("internvl2-76b", dict(n_layers=2))]
    for arch, repl in runs:
        t0 = time.perf_counter()
        model, packed = build_leafwise(
            torch, dataclasses.replace(get_config(arch), **repl), device)
        cfg = model.cfg
        if cfg.is_encdec:
            out[arch], out["whisper-encoder"] = frontend_static(
                torch, model, packed, 4, 64, 32,
                cfg.n_enc_layers + 2 * cfg.n_layers, device)
        elif cfg.frontend == "vision":
            out[arch], _ = frontend_static(torch, model, packed, 2, 64, 16,
                                           cfg.n_layers, device)
        else:
            b = 4 if cfg.n_experts else 8
            fa = n_periods(cfg) * sum(m == "attn" for m, _ in
                                      layer_plan(cfg))
            eng, prompts, out[arch] = state_static(
                torch, model, packed, b, STATE_PROMPT, 32, fa, device)
            log(f"  {arch}:")
            profile_static(torch, eng, prompts, prefill=False)
            recurrence_costs(torch, cfg, eng.params, b, device)
            del eng
        del model, packed
        torch.cuda.empty_cache()
        log(f"  {arch} done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for arch, _ in runs:
        state_paths_check(torch, arch)
    log(f"  smoke configs on card and CPU in {time.perf_counter() - t0:.1f}"
        " s")
    log("[state stacks] ok: xlstm-125m, jamba-v0.1-52b (one period), "
        "whisper-large-v3 and internvl2-76b (2 layers) at full width, "
        "launch counts exact; smoke configs agree between card and CPU")
    return out


# ---------------------------------------------------------------------------
# phase 15: training
# ---------------------------------------------------------------------------

TRAIN_ARCHS = ["internlm2-1.8b", "gemma2-2b", "granite-moe-3b-a800m",
               "jamba-v0.1-52b", "xlstm-125m", "whisper-large-v3"]
FULL_TRAIN = dict(batch=4, seq=4096, steps=5)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.detach().to(device)


def smoke_batches(cfg, n, start=0, b=2, s=16):
    """``n`` seeded batches of ``TokenStream`` (whisper: with 16 frames a
    row) from batch ``start`` on."""
    from repro_torch.data import TokenStream
    stream = TokenStream(cfg.vocab_size, s, b, seed=0)
    out = []
    for i in range(start, start + n):
        batch = stream.batch(i)
        if cfg.is_encdec:
            batch["frames"] = np.random.default_rng(i).standard_normal(
                (b, 16, cfg.d_model)).astype(np.float32)
        out.append(batch)
    return out


def smoke_state(torch, model, opt, device):
    """The seeded smoke train state (drawn on the CPU), on ``device``."""
    from repro_torch.train import init_state
    return _to(init_state(model, opt, torch.Generator().manual_seed(0),
                          "cpu"), device)


def smoke_opt():
    from repro_torch.train import AdamW, OptConfig
    return AdamW(OptConfig(lr=1e-3, warmup_steps=1, total_steps=10))


def train_smoke_card_vs_cpu(torch, device):
    """(a): three ``make_train_step`` steps of each smoke config in
    ``TRAIN_ARCHS`` on the card and on the CPU from the same params and
    batches: loss and grad norm within 1e-4 relative each step."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import Model
    from repro_torch.train import make_train_step
    for arch in TRAIN_ARCHS:
        t0 = time.perf_counter()
        model = Model(smoke_config(arch))
        batches = smoke_batches(model.cfg, 3)
        res = {}
        for dev in (device, "cpu"):
            opt = smoke_opt()
            state, step = smoke_state(torch, model, opt, dev), \
                make_train_step(model, opt)
            res[str(dev)] = []
            for batch in batches:
                state, m = step(state, batch)
                res[str(dev)].append((float(m["loss"]),
                                      float(m["grad_norm"])))
        card, cpu = res[str(device)], res["cpu"]
        worst = max(abs(a - b) / abs(b) for rc, rp in zip(card, cpu)
                    for a, b in zip(rc, rp))
        log(f"  {arch} smoke, 3 steps: loss card "
            f"{[round(r[0], 6) for r in card]} cpu "
            f"{[round(r[0], 6) for r in cpu]}; grad norm card "
            f"{[round(r[1], 5) for r in card]}; worst rel {worst:.3g} "
            f"(tol 1e-4), {time.perf_counter() - t0:.1f} s")
        if not worst <= 1e-4:
            fail(f"train {arch}: card and CPU steps differ by {worst}")


def train_full_width(torch, device):
    """(b): internlm2-1.8b at full width through ``train_loop``: f32
    params and moments, remat, TokenStream batches of ``FULL_TRAIN``.
    Holds every loss finite, the first within 1 nat of ln(vocab), 48 D
    launches a step (24 layers, forward and remat recompute) and none of
    B or C; reports step ms, tokens/s and the peak memory, then one
    profiled step, forward+backward and the optimizer apart (``wq``'s
    gradient must be there and non-zero), and two steps with int8
    moments and their peak."""
    import math
    import statistics
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.models import Model
    from repro_torch.train import (AdamW, OptConfig, StragglerMonitor,
                                   init_state, make_train_step, train_loop)
    b, s, n = FULL_TRAIN["batch"], FULL_TRAIN["seq"], FULL_TRAIN["steps"]
    cfg = get_config("internlm2-1.8b")
    model = Model(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    opt = AdamW(OptConfig(lr=3e-4, warmup_steps=2, total_steps=100))
    state = init_state(model, opt, torch.Generator(
        device=device).manual_seed(0), device)
    stream = TokenStream(cfg.vocab_size, s, b, seed=0)
    losses = []

    def log_fn(line):
        log(f"  {line}")
        if line.startswith("[train] step"):
            losses.append(float(line.split(" loss ")[1].split()[0]))

    mon = StragglerMonitor()
    zero_launch_counters()
    t0 = time.perf_counter()
    state, _ = train_loop(model, opt, iter(stream), steps=n, state=state,
                          straggler_monitor=mon, log_every=1, log_fn=log_fn)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_launch_counters()
    peak = torch.cuda.max_memory_allocated() / 1e9
    if counts["flash_attention_fwd"] != 2 * cfg.n_layers * n:
        fail(f"full-width train: {counts['flash_attention_fwd']} D launches "
             f"in {n} steps, not {2 * cfg.n_layers * n}")
    if counts["paged_attention_decode"] or \
            counts["paged_attention_decode_quant"]:
        fail("full-width train: a paged kernel launched")
    if not all(math.isfinite(x) for x in losses) or len(losses) != n:
        fail(f"full-width train: losses {losses}")
    if not abs(losses[0] - math.log(cfg.vocab_size)) <= 1.0:
        fail(f"full-width train: first loss {losses[0]} not within 1 nat "
             f"of ln({cfg.vocab_size})")
    times = [t * 1e3 for t in mon.times]
    step_ms = statistics.median(times[1:])
    log(f"  internlm2-1.8b full width, B={b} x S={s} ({b * s} tokens a "
        f"step), f32 params and moments, remat: {n} steps in {wall:.1f} s;"
        f" step ms {[round(t, 1) for t in times]}, median after the first "
        f"{step_ms:.1f} ms, {b * s / step_ms * 1e3:.0f} tokens/s; D "
        f"launches {counts['flash_attention_fwd']} "
        f"({counts['flash_attention_fwd'] // n} a step); peak "
        f"{peak:.3f} GB")
    step = make_train_step(model, opt)
    batch = stream.batch(n)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        pwall = (time.perf_counter() - t0) * 1e3
    busy, _ = device_breakdown(prof, pwall, 1,
                               "full-width train step profile")
    params = state["params"]
    for _, p in _leaves(params):      # a step leaves them not requiring grad
        p.requires_grad_(True)
    tb = {k: torch.as_tensor(v).to(device) for k, v in
          stream.batch(n + 1).items()}
    zero_launch_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, _ = model.loss(params, tb)
    loss.backward()
    torch.cuda.synchronize()
    fb_ms = (time.perf_counter() - t0) * 1e3
    wq = params["dec"]["s0"]["attn"]["wq"]
    if wq.grad is None or wq.grad.abs().max().item() == 0:
        fail("full-width train: wq has no gradient from attention")
    if read_launch_counters()["flash_attention_fwd"] != 2 * cfg.n_layers:
        fail("full-width train: forward+backward did not launch D 48 times")
    from repro_torch.train.train_loop import _grads
    g = _grads(params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    opt.update(g, state["opt"], params)
    torch.cuda.synchronize()
    opt_ms = (time.perf_counter() - t0) * 1e3
    log(f"  one step apart: forward+backward {fb_ms:.1f} ms (wq grad max "
        f"{wq.grad.abs().max().item():.3g}), AdamW f32 update {opt_ms:.1f} "
        f"ms; profiled step {pwall:.1f} ms, device busy {busy:.1f} ms")
    del g
    for _, p in _leaves(params):
        p.grad = None
    del state["opt"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    opt8 = AdamW(OptConfig(lr=3e-4, warmup_steps=2, total_steps=100,
                           moment_dtype="int8"))
    state8 = {"params": params, "opt": opt8.init(params)}
    mon8 = StragglerMonitor()
    losses.clear()
    state8, _ = train_loop(model, opt8, iter(stream), steps=2, state=state8,
                           straggler_monitor=mon8, log_every=1,
                           log_fn=log_fn)
    peak8 = torch.cuda.max_memory_allocated() / 1e9
    if not all(math.isfinite(x) for x in losses):
        fail(f"full-width train, int8 moments: losses {losses}")
    log(f"  int8 moments: 2 steps {[round(t * 1e3, 1) for t in mon8.times]}"
        f" ms, peak {peak8:.3f} GB against {peak:.3f} GB with f32 moments")
    del state8, params, state
    torch.cuda.empty_cache()
    return dict(step_ms=step_ms, tokens_per_s=b * s / step_ms * 1e3,
                peak_gb=peak, peak_int8_gb=peak8,
                d_launches=counts["flash_attention_fwd"], fb_ms=fb_ms,
                opt_ms=opt_ms)


def train_checkpoint_round_trip(torch, device, tmp):
    """(c): the smoke internlm2 run of 4 steps on the card, twice
    uninterrupted (their spread: what the card's nondeterministic ops
    leave), and once saved at step 2 (async, from CUDA tensors), restored
    onto the card by a new ``train_loop`` and run on to step 4: every
    leaf of params and moments within 10x the spread of the uninterrupted
    runs, and bitwise where they are bitwise."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import Model
    from repro_torch.train import Checkpointer, train_loop
    model = Model(smoke_config("internlm2-1.8b"))

    def run(steps, start=0, ck=None):
        opt = smoke_opt()
        return train_loop(model, opt, iter(smoke_batches(model.cfg, steps -
                                                          start, start)),
                          steps=steps,
                          state=smoke_state(torch, model, opt, device),
                          checkpointer=ck, checkpoint_every=2,
                          log_every=0)[0]

    a, a2 = dict(_leaves(run(4))), dict(_leaves(run(4)))
    ck = Checkpointer(os.path.join(tmp, "ck"))
    run(2, ck=ck)
    if ck.steps() != [2]:
        fail(f"checkpoint round trip: steps on disk {ck.steps()}")
    r = dict(_leaves(run(4, start=2, ck=Checkpointer(os.path.join(tmp,
                                                                "ck")))))
    spread = max((a[k].float() - a2[k].float()).abs().max().item()
                 for k in a)
    diff = max((a[k].float() - r[k].float()).abs().max().item() for k in a)
    differing = [k for k in a if not torch.equal(a[k], a2[k])]
    log(f"  checkpoint round trip (smoke internlm2, saved at 2, restored on "
        f"the card, on to 4): max |resumed - uninterrupted| {diff:.3g}; two "
        f"uninterrupted runs differ by {spread:.3g} in {len(differing)} of "
        f"{len(a)} leaves {differing[:6]}")
    if not (diff <= 10 * spread if spread > 0 else diff == 0):
        fail(f"checkpoint round trip: resumed run differs by {diff} "
             f"(uninterrupted runs by {spread})")


def train_launchers(torch, tmp):
    """(d): ``launch.train --smoke --steps 30`` on the card, checkpoints
    every 10 steps: its final loss below its first; then ``launch.serve
    --smoke --ckpt-dir`` restores step 30 and serves. Each launcher's
    ``main`` runs in this process, its output captured (phase 20 runs a
    program as a process of its own)."""
    import contextlib
    import io
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train
    ck = os.path.join(tmp, "launch")
    t0 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launch_train.main(["--arch", "internlm2-1.8b", "--smoke", "--steps",
                           "30", "--ckpt-dir", ck, "--checkpoint-every",
                           "10"])
    lines = out.getvalue().splitlines()
    first = float(lines[0].split(" loss ")[1].split()[0])
    final = float(lines[-1].split("final loss ")[1].split(",")[0])
    log(f"  launch.train --smoke --steps 30: first loss {first:.4f}, final "
        f"{final:.4f}; {lines[-1]} ({time.perf_counter() - t0:.1f} s)")
    if not final < first:
        fail(f"launch.train: final loss {final} not below first {first}")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launch_serve.main(["--arch", "internlm2-1.8b", "--smoke",
                           "--ckpt-dir", ck])
    lines = out.getvalue().splitlines()
    if "[launch.serve] restored step 30" not in lines:
        fail(f"launch.serve --ckpt-dir: {lines[-10:]}")
    log(f"  launch.serve --ckpt-dir: {lines[0]}; {len(lines) - 2} requests "
        "served")


def phase_train(torch, device):
    """Phase 15: training (a)-(d). Returns (a)'s full-width numbers."""
    import tempfile
    t0 = time.perf_counter()
    train_smoke_card_vs_cpu(torch, device)
    full = train_full_width(torch, device)
    with tempfile.TemporaryDirectory() as tmp:
        train_checkpoint_round_trip(torch, device, tmp)
        train_launchers(torch, tmp)
    log(f"[train] ok in {time.perf_counter() - t0:.1f} s: smoke configs "
        "agree between card and CPU; internlm2-1.8b at full width, 48 D "
        "launches a step, finite losses; checkpoint round trip; the "
        "launcher's loss falls and serve restores its checkpoint")
    return full


# ---------------------------------------------------------------------------
# phase 17: GSPMD-style training on a process mesh, four ranks on one card
# ---------------------------------------------------------------------------

# internlm2-1.8b at full width, cut to 2 of its 24 layers, f32
GSPMD = {"layers": 2, "batch": 8, "seq": 512, "steps": 2,
         "cp_batch": 4, "cp_seq": 768}


def rank_cp_loss(ctx, model, params, batch):
    """On a rank of the (1, 3) mesh: the loss on its blocks with every
    ``flash_attention`` call's ``q_offset`` recorded and the launch
    counters zeroed first: (loss, offsets, counters)."""
    import torch
    from repro_torch.models import layers
    zero_launch_counters()
    offsets, inner = [], layers.flash_attention

    def record(*args, **kw):
        offsets.append(kw.get("q_offset", 0))
        return inner(*args, **kw)

    layers.flash_attention = record
    try:
        with torch.no_grad():
            dev = ctx.device
            loss, _ = model.loss(params.local(ctx),
                                 {k: v.to(dev) for k, v in batch.items()},
                                 ctx.par)
    finally:
        layers.flash_attention = inner
    return float(loss), offsets, read_launch_counters()


def gspmd_batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int64)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def phase_gspmd(torch, device):
    """Phase 17: GSPMD-style training on one card. A (data 2, model 2)
    process mesh, four ranks on ``cuda:0`` (gloo collectives staged
    through the host): internlm2-1.8b at full width, cut to
    ``GSPMD["layers"]`` layers, f32, B=8 x 512: ``Model.loss`` and two
    ``make_train_step`` steps against the same on one device on the card
    (loss and grad norm within 1e-4 relative), each rank's D launches
    exact (a layer once in the loss, twice a step: forward and remat),
    its peak memory, step times; then a (1, 3) mesh, where 8 KV heads do
    not divide three ranks and S = 768 runs context-parallel: every
    rank's D launches at its ``q_offset``, the loss against one
    device's."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import Model
    from repro_torch.parallel import sharding as shd
    from repro_torch.train import AdamW, OptConfig, init_state, \
        make_train_step
    from repro_torch.train.train_loop import place_state
    t0 = time.perf_counter()
    n_layers = GSPMD["layers"]
    cfg = dataclasses.replace(get_config("internlm2-1.8b"),
                              n_layers=n_layers, dtype=torch.float32)
    model = Model(cfg)
    opt = AdamW(OptConfig(lr=3e-4, warmup_steps=1, total_steps=100))
    state = init_state(model, opt, torch.Generator().manual_seed(0), "cpu")
    batches = [gspmd_batch(cfg, GSPMD["batch"], GSPMD["seq"], i)
               for i in range(GSPMD["steps"] + 1)]

    def on_card(tree):
        if isinstance(tree, dict):
            return {k: on_card(v) for k, v in tree.items()}
        return tree.to(device, copy=True)

    def card_batch(bt):
        return {k: torch.from_numpy(v).to(device) for k, v in bt.items()}

    one = on_card(state)
    with torch.no_grad():
        loss1 = float(model.loss(one["params"], card_batch(batches[0]))[0])
    step1 = make_train_step(model, opt)
    ref, t_one = [], []
    for bt in batches[1:]:
        t = time.perf_counter()
        one, m = step1(one, card_batch(bt))
        ref.append((float(m["loss"]), float(m["grad_norm"])))
        t_one.append(time.perf_counter() - t)
    del one, step1
    torch.cuda.empty_cache()

    mesh = make_host_mesh((2, 2), devices=[str(device)] * 4)
    try:
        ctx = shd.from_mesh(mesh)
        placed = place_state(model, opt, state, mesh)
        mesh.gather(rank_launches, True)
        mesh.gather(rank_peak, True)
        loss4 = float(model.loss(placed["params"], batches[0], ctx)[0])
        d_loss = [c["flash_attention_fwd"]
                  for c in mesh.gather(rank_launches, True)]
        if abs(loss4 / loss1 - 1) > 1e-4:
            fail(f"gspmd (2, 2) loss {loss4} vs one device {loss1}")
        if d_loss != [n_layers] * 4:
            fail(f"gspmd (2, 2) loss: D launches {d_loss}, want "
                 f"{n_layers} a rank")
        step4 = make_train_step(model, opt, ctx)
        t_four = []
        for i, bt in enumerate(batches[1:]):
            t = time.perf_counter()
            _, m = step4(placed, bt)
            t_four.append(time.perf_counter() - t)
            got = (float(m["loss"]), float(m["grad_norm"]))
            for what, a, b in zip(("loss", "grad norm"), got, ref[i]):
                if abs(a / b - 1) > 1e-4:
                    fail(f"gspmd (2, 2) step {i + 1} {what} {a} vs one "
                         f"device {b}")
            log(f"  gspmd (2, 2) step {i + 1}: loss {got[0]:.6f} (one "
                f"device {ref[i][0]:.6f}), grad norm {got[1]:.6f} "
                f"({ref[i][1]:.6f}); {t_four[-1]:.2f} s (one device "
                f"{t_one[i]:.2f} s)")
        d_steps = [c["flash_attention_fwd"]
                   for c in mesh.gather(rank_launches, True)]
        want = 2 * n_layers * GSPMD["steps"]
        if d_steps != [want] * 4:
            fail(f"gspmd (2, 2) steps: D launches {d_steps}, want {want} a "
                 "rank")
        peaks = mesh.gather(rank_peak, True)
        log(f"  gspmd (2, 2): loss {loss4:.6f} vs one device {loss1:.6f}; "
            f"D launches a rank {d_loss} in the loss, {d_steps} in "
            f"{GSPMD['steps']} steps; peak GB a rank "
            + ", ".join(f"{p:.2f}" for p in peaks))
        placed.drop()
    finally:
        mesh.close()

    b, s = GSPMD["cp_batch"], GSPMD["cp_seq"]
    cp_batch = gspmd_batch(cfg, b, s, 7)
    with torch.no_grad():
        cp1 = float(model.loss(on_card(state["params"]),
                               card_batch(cp_batch))[0])
    torch.cuda.empty_cache()
    mesh = make_host_mesh((1, 3), devices=[str(device)] * 3)
    try:
        ctx = shd.from_mesh(mesh)
        placed = shd.device_put(state["params"], shd.tree_shardings(
            ctx, model.param_axes(), model.param_shapes()), mesh)
        t = time.perf_counter()
        outs = mesh.gather(rank_cp_loss, model, shd._plain(placed),
                           per_rank=shd.batch_blocks(ctx, cp_batch))
        t_cp = time.perf_counter() - t
        placed.drop()
    finally:
        mesh.close()
    cp_launches = []
    for r, (loss, offsets, counts) in enumerate(outs):
        want = [r * (s // 3)] * n_layers
        if offsets != want or counts["flash_attention_fwd"] != n_layers:
            fail(f"gspmd (1, 3) rank {r}: q_offsets {offsets} (want {want}),"
                 f" D launches {counts['flash_attention_fwd']}")
        if abs(loss / cp1 - 1) > 1e-4:
            fail(f"gspmd (1, 3) rank {r}: loss {loss} vs one device {cp1}")
        cp_launches.append(counts["flash_attention_fwd"])
    log(f"  gspmd (1, 3) context-parallel B={b} x {s}: loss {outs[0][0]:.6f}"
        f" vs one device {cp1:.6f}; each rank {n_layers} D launches at "
        f"q_offset 0, {s // 3}, {2 * s // 3}; {t_cp:.2f} s")
    log(f"[gspmd] internlm2-1.8b full width, {n_layers} layers, f32: (2, 2) "
        f"loss and {GSPMD['steps']} steps within 1e-4 of one device, (1, 3)"
        f" context-parallel loss too; {time.perf_counter() - t0:.1f} s")
    return {"cp_launches": sum(cp_launches),
            "d_launches": d_loss + d_steps}


GSPMD_SERVE = {"layers": 4, "new": 16, "batch": 8, "prompt": 512,
               "long": 1024, "max_seq": 1280,
               # (d): the dense bf16 tree the resolver cuts
               "dense_layers": 2, "dense_prompt": 256, "dense_new": 4}
A_PER_LAYER = 7    # internlm2's packed projections: wq, wk, wv, wo, wg,
                   # wi and the MLP's wo, each one kernel A launch a step


def gspmd_counts_ok(name, per_rank, want):
    """Every rank launched exactly ``want`` ({kernel: launches})."""
    for r, counts in enumerate(per_rank):
        got = {k: counts[k] for k in want}
        if got != want:
            fail(f"{name}: rank {r} launches {got}, want {want}")
    log(f"  {name}: every rank launched exactly {want}")


def rank_d_shapes(ctx, start=False):
    """On a mesh rank: from now on (``start``) record the (q, k) shapes of
    every kernel D call the model's attention makes (head-major (B, H, S,
    d)); else stop and return them. The recorder calls the wrapper
    itself, so the launch counts are untouched."""
    from repro_torch.models import attention
    fn = attention.flash_attention_fwd
    if start:
        def record(q, k, v, *args, **kw):
            record.shapes.append((tuple(q.shape), tuple(k.shape)))
            return fn(q, k, v, *args, **kw)
        record.shapes, record.inner = [], fn
        attention.flash_attention_fwd = record
        return None
    attention.flash_attention_fwd = fn.inner
    return fn.shapes


def paged_want(eng, before, horizon, bits, n_layers):
    """The launches each rank of a ``ContinuousEngine(parallel=)`` makes
    over the dispatches since ``before`` (prefill dispatches, decode
    dispatches): every step runs each layer's projections on kernel A,
    its attention on B (kv16) or C (kv4), the unembedding once; a decode
    dispatch is ``horizon`` steps."""
    steps = (eng.n_prefill_dispatches - before[0]
             + horizon * (eng.n_decode_steps - before[1]))
    att = ("paged_attention_decode" if bits == 16
           else "paged_attention_decode_quant")
    return {"msb_matmul": A_PER_LAYER * n_layers * steps,
            "msb_unembed": steps, att: n_layers * steps,
            "flash_attention_fwd": 0}


def phase_gspmd_serve(torch, device):
    """Phase 18: GSPMD serving on a (data 2, model 2) process mesh of four
    ranks on the one card (gloo staged through the host, every dispatch
    eager), internlm2-1.8b at full width cut to ``GSPMD_SERVE["layers"]``
    layers (random weights, seed 0, 4-bit block-64 DP, packed on the
    card). (a) ``ContinuousEngine(parallel=ctx)`` (the planner's slices
    over ``model``, KV heads over ``model``, each data rank the whole
    step) at kv16 and kv4, H=8 and H=1, on phase 7's prompts, 16 new
    tokens: tokens against the same engine on one device (identical, or
    the first divergence at a top-2 gap < 1e-2; kv4 reported, H=8 = H=1
    held), next-token logits within ``TP_LOGIT_TOL``, each rank's A, the
    unembedding's kernel and B or C launched exactly as its dispatches
    count. (b) ``ServeEngine(parallel=ctx)`` at B=8 x 512 (rows over
    data, the ring over model; packed leaves whole on every rank):
    exactly one D a layer a rank in the prefill, decode through the
    ``kv_seq`` combine, tokens against one device, ``score`` within 1e-4
    relative. (c) one B=1 prompt of 1024 tokens, the ring over the whole
    mesh: each rank's A, unembedding and D launches exact, tokens against
    one device. (d) a dense bf16 tree of ``GSPMD_SERVE["dense_layers"]``
    layers, which the resolver cuts (ZeRO-3 over data, heads over model):
    each rank's D at its 4 rows and 8 of 16 heads in the prefill, the K/V
    re-cut from heads to ``kv_seq``, the weights gathered every decode
    step, tokens against one device. Seconds and peak GB a rank are
    checks, not rates. Returns the per-rank launches."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel import sharding as shd
    from repro_torch.serve import ContinuousEngine, ServeEngine
    t_phase = time.perf_counter()
    n_layers, new = GSPMD_SERVE["layers"], GSPMD_SERVE["new"]
    cfg = dataclasses.replace(get_config("internlm2-1.8b"), n_layers=n_layers)
    model, packed = build_leafwise(torch, cfg, device)
    prompts = serve_prompts(cfg)
    rng = np.random.default_rng(18)
    b, p = GSPMD_SERVE["batch"], GSPMD_SERVE["prompt"]
    st_prompts = rng.integers(0, cfg.vocab_size, (b, p)).astype(np.int32)
    scored = rng.integers(0, cfg.vocab_size, (b, p + 1)).astype(np.int32)
    long_prompt = rng.integers(0, cfg.vocab_size,
                               (1, GSPMD_SERVE["long"])).astype(np.int32)
    max_seq = GSPMD_SERVE["max_seq"]
    # one device on the card: the references
    t0 = time.perf_counter()
    ref = {}
    for bits in (16, 4):
        eng = ContinuousEngine(model, packed, decode_horizon=8, kv_bits=bits,
                               device=device, **SERVE_ENGINE)
        ref[bits], _, _ = run_engine(eng, prompts, True, new)
        eng.close()
    one = ServeEngine(model, packed, max_seq=max_seq, device=device)
    st_toks = one.generate(st_prompts, new)
    st_nll = one.score(scored)
    long_toks = one.generate(long_prompt, new)
    del one
    torch.cuda.empty_cache()
    log(f"[gspmd serve] internlm2-1.8b full width, {n_layers} of 24 layers, "
        f"packed 4b/64 DP; one-device references in "
        f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    mesh = make_host_mesh((2, 2), devices=[str(device)] * 4)
    log(f"  (2, 2) mesh of 4 ranks on {device} up in "
        f"{time.perf_counter() - t0:.2f} s")
    out = {}
    try:
        ctx = shd.from_mesh(mesh)
        # (a) the continuous engine
        for bits in (16, 4):
            res = {}
            for horizon in (8, 1):
                name = f"gspmd (2, 2) kv{bits} H={horizon}"
                t0 = time.perf_counter()
                eng = ContinuousEngine(model, packed, decode_horizon=horizon,
                                       kv_bits=bits, parallel=ctx,
                                       **SERVE_ENGINE)
                mesh.gather(rank_launches, True)
                mesh.gather(rank_peak, True)
                before = (eng.n_prefill_dispatches, eng.n_decode_steps)
                res[horizon], t_pre, t_dec = run_engine(eng, prompts, True,
                                                        new)
                counts = mesh.gather(rank_launches, True)
                peaks = mesh.gather(rank_peak)
                want = paged_want(eng, before, horizon, bits, n_layers)
                if horizon == 8:
                    out[bits] = counts
                    tp_logit_gaps(torch, device, mesh, eng, model, packed,
                                  prompts[:4], bits, tag="gspmd (2, 2)")
                eng.close()
                eng.cache.check_invariants(expect_idle=True)
                n_dec = eng.n_decode_steps - before[1]
                log(f"  {name}: {time.perf_counter() - t0:.2f} s wall, "
                    f"prefill {t_pre:.3f} s, decode {t_dec:.3f} s in "
                    f"{n_dec} eager dispatches ({1e3 * t_dec / max(n_dec * horizon, 1):.2f} ms a "
                    f"decode step); peak GB by rank "
                    f"{[f'{x:.3f}' for x in peaks]}")
                gspmd_counts_ok(name, counts, want)
                compare_tokens(torch, f"{name} vs one device", res[horizon],
                               ref[bits], prompts, model, packed, device,
                               kv_bits=bits, hold=bits == 16)
            if bits == 4:
                for rid in res[8]:
                    if not np.array_equal(res[8][rid], res[1][rid]):
                        fail(f"gspmd kv4: request {rid} differs between "
                             f"H=8 and H=1: {res[8][rid]} vs {res[1][rid]}")
                log("  gspmd (2, 2) kv4 H=8 vs H=1: tokens identical")
        # (b) the static engine, B=8: rows over data, the ring over model
        eng = ServeEngine(model, packed, max_seq=max_seq, parallel=ctx)
        mesh.gather(rank_launches, True)
        mesh.gather(rank_peak, True)
        t0 = time.perf_counter()
        toks = eng.generate(st_prompts, new)
        t_gen = time.perf_counter() - t0
        out["static"] = mesh.gather(rank_launches, True)
        gspmd_counts_ok(f"gspmd (2, 2) ServeEngine B={b} P={p} generate",
                        out["static"], {
                            "flash_attention_fwd": n_layers,
                            "msb_matmul": A_PER_LAYER * n_layers * (1 + new),
                            "msb_unembed": 1 + new,
                            "paged_attention_decode": 0})
        t0 = time.perf_counter()
        nll = eng.score(scored)
        t_score = time.perf_counter() - t0
        gspmd_counts_ok("gspmd (2, 2) score", mesh.gather(rank_launches,
                                                          True),
                        {"flash_attention_fwd": n_layers,
                         "msb_matmul": A_PER_LAYER * n_layers})
        rel = abs(nll - st_nll) / abs(st_nll)
        log(f"  gspmd (2, 2) ServeEngine B={b} P={p}: generate {new} tokens "
            f"{t_gen:.3f} s eager; score {t_score:.3f} s, NLL {nll:.6f} "
            f"against one device {st_nll:.6f} (relative {rel:.3g})")
        if not rel < 1e-4:
            fail(f"gspmd score {nll} vs one device {st_nll}: relative {rel}")
        compare_tokens(torch, "gspmd (2, 2) static vs one device",
                       {i: toks[i] for i in range(b)},
                       {i: st_toks[i] for i in range(b)}, list(st_prompts),
                       model, packed, device)
        # (c) one 1024-token prompt: kv_seq over the whole mesh (the
        # counts zeroed again: (b)'s near-tie check ran on rank 0's process)
        mesh.gather(rank_launches, True)
        t0 = time.perf_counter()
        toks = eng.generate(long_prompt, new)
        t_long = time.perf_counter() - t0
        out["long"] = mesh.gather(rank_launches, True)
        peaks = mesh.gather(rank_peak)
        gspmd_counts_ok("gspmd (2, 2) ServeEngine B=1 P=1024 generate",
                        out["long"], {
                            "flash_attention_fwd": n_layers,
                            "msb_matmul": A_PER_LAYER * n_layers * (1 + new),
                            "msb_unembed": 1 + new,
                            "paged_attention_decode": 0})
        compare_tokens(torch, "gspmd (2, 2) B=1 x 1024 vs one device",
                       {0: toks[0]}, {0: long_toks[0]}, list(long_prompt),
                       model, packed, device)
        log(f"  gspmd (2, 2) ServeEngine B=1 P={GSPMD_SERVE['long']}: "
            f"generate {new} tokens {t_long:.3f} s eager; peak GB by rank "
            f"(static runs) {[f'{x:.3f}' for x in peaks]}")
        eng.close()
        del packed
        torch.cuda.empty_cache()
        out["dense"] = gspmd_dense(torch, device, mesh, ctx, cfg)
    finally:
        mesh.close()
    del model
    torch.cuda.empty_cache()
    log(f"[gspmd serve] ok in {time.perf_counter() - t_phase:.1f} s: "
        f"internlm2-1.8b ({n_layers} layers) on (2, 2): ContinuousEngine "
        "kv16/kv4 H=8/H=1 and ServeEngine B=8 and B=1 x 1024 against one "
        f"device; the dense tree ({GSPMD_SERVE['dense_layers']} layers) "
        "too; every rank's launches exact, no process left")
    return out


def gspmd_dense(torch, device, mesh, ctx, cfg):
    """Phase 18 (d): ``ServeEngine(parallel=ctx)`` on a dense bf16 tree of
    ``cfg`` cut to ``GSPMD_SERVE["dense_layers"]`` layers (random, seed
    0), which the resolver places ZeRO-3 over data and heads over model:
    B=8 x ``dense_prompt``, every rank's D once a layer at its 4 rows and
    8 of 16 heads (4 of 8 KV heads), no other kernel, tokens against one
    device under the near-tie rule. Returns the per-rank launches."""
    import dataclasses
    from repro_torch.core import map_tensors
    from repro_torch.models import Model
    from repro_torch.serve import ServeEngine
    n_layers = GSPMD_SERVE["dense_layers"]
    b, p = GSPMD_SERVE["batch"], GSPMD_SERVE["dense_prompt"]
    new = GSPMD_SERVE["dense_new"]
    model = Model(dataclasses.replace(cfg, n_layers=n_layers))
    dense = map_tensors(
        lambda t: t.to(cfg.dtype) if t.is_floating_point() else t,
        model.init(torch.Generator(device=device).manual_seed(0), device))
    prompts = np.random.default_rng(19).integers(
        0, cfg.vocab_size, (b, p)).astype(np.int32)
    want = ServeEngine(model, dense, max_seq=p + new,
                       device=device).generate(prompts, new)
    t0 = time.perf_counter()
    eng = ServeEngine(model, dense, max_seq=p + new, parallel=ctx)
    t_place = time.perf_counter() - t0
    mesh.gather(rank_launches, True)
    mesh.gather(rank_peak, True)
    mesh.gather(rank_d_shapes, True)
    t0 = time.perf_counter()
    toks = eng.generate(prompts, new)
    t_gen = time.perf_counter() - t0
    shapes = mesh.gather(rank_d_shapes)
    counts = mesh.gather(rank_launches, True)
    peaks = mesh.gather(rank_peak)
    eng.close()
    name = f"gspmd (2, 2) dense ServeEngine B={b} P={p} generate"
    gspmd_counts_ok(name, counts, {
        "flash_attention_fwd": n_layers, "msb_matmul": 0, "msb_unembed": 0,
        "paged_attention_decode": 0})
    hd = cfg.head_dim_
    at = ((b // 2, cfg.n_heads // 2, p, hd), (b // 2, cfg.n_kv_heads // 2,
                                               p, hd))
    for r, got in enumerate(shapes):
        if got != [at] * n_layers:
            fail(f"{name}: rank {r} launched D at (q, k) {got}, want "
                 f"{[at] * n_layers}")
    log(f"  {name}: every rank's D at (q, k) {at}, its rows and heads")
    compare_tokens(torch, f"{name} vs one device",
                   {i: toks[i] for i in range(b)},
                   {i: want[i] for i in range(b)}, list(prompts), model,
                   dense, device)
    log(f"  gspmd (2, 2) dense bf16, {n_layers} layers: placed in "
        f"{t_place:.2f} s, generate {new} tokens {t_gen:.3f} s eager (the "
        f"K/V re-cut to kv_seq, the weights gathered each step); peak GB "
        f"by rank {[f'{x:.3f}' for x in peaks]}")
    del dense, eng
    torch.cuda.empty_cache()
    return counts


HEADDIM = {"enc_layers": 2, "layers": 2, "batch": 2, "prompt": 63,
           "max_seq": 67, "new": 4, "mesh": (1, 8)}


def rank_headdim_decode(ctx, model, key, gb, max_seq, n, batch):
    """On a mesh rank: ``Model.prefill`` of its rows of ``batch`` (the
    whole batch: the data axis is 1), the cache grown to ``max_seq``
    (``grow_cache_spmd``), then ``n`` greedy ``decode_step``s under the
    rank's context. Returns (tokens (B, n), the logits each was drawn
    from on the CPU, ms a decode step, each K/V leaf's block shape)."""
    import torch
    from repro_torch.serve.engine import grow_cache_spmd
    par, dev = ctx.par, ctx.device
    params = ctx.states[key]
    batch = {k: v.to(dev) for k, v in batch.items()}
    logits, cache = model.prefill(params, batch, par, global_batch=gb)
    cache, layout = grow_cache_spmd(model, cache, par,
                                    model.cache_layout(batch, gb), max_seq)
    cur = torch.full((logits.shape[0],), batch["tokens"].shape[1],
                     dtype=torch.int32, device=dev)
    toks, seen = [], []
    sync = torch.cuda.synchronize if dev.type == "cuda" else lambda _: None
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(n):
        seen.append(logits.float())
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        toks.append(tok)
        logits, cache = model.decode_step(params, cache, tok[:, None], cur,
                                          par, layout=layout)
        cur = cur + 1
    sync(dev)
    ms = 1e3 * (time.perf_counter() - t0) / n
    blocks = {path: tuple(t.shape) for path, t in _leaves(cache)
              if path.endswith(("/k", "/v"))}
    return (torch.stack(toks, 1).cpu().numpy(), [x.cpu() for x in seen], ms,
            blocks)


def phase_headdim(torch, device):
    """Phase 19: a decode cache cut over ``head_dim`` on the card, and
    the dry-run. (a) whisper-large-v3 at full width cut to
    ``HEADDIM["enc_layers"]`` + ``HEADDIM["layers"]`` layers (random
    weights, seed 0, 4-bit block-64 DP, packed) on a (1, 8) mesh of eight
    ranks on the one card: neither 20 KV heads, nor the 67-entry ring,
    nor 1500 encoder rows divide 8 ways, so the self-attention ring and
    the cross-attention K/V are both cut over ``head_dim``. Prefill of
    B=2 x 63 tokens over 1500 frames, the cache grown to 67 entries, 4
    greedy ``decode_step``s: tokens against one device's (identical, or
    the first divergence at a top-2 gap < 1e-2), the logits each token
    was drawn from within ``TP_LOGIT_TOL[16]`` up to a divergence, every
    rank's A and D launches exactly one device's (packed leaves are whole
    on every rank, and every rank projects and attends whole; the counts
    zeroed just before each run). Seconds, ms a decode step and peak GB a
    rank are checks: eight contexts share one card. (b) a CPU check, not
    a card one: the dry-run's two test cells (which
    ``tests/test_torch_dryrun.py`` also runs) in this process on fake CPU
    tensors, no kernel launches: internlm2-1.8b ``decode_32k
    --quantized`` and whisper-large-v3 ``decode_32k`` on the single-pod
    mesh; their records printed. Returns the ranks' launches of (a)."""
    import dataclasses
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel import sharding as shd
    t_phase = time.perf_counter()
    hd = HEADDIM
    cfg = dataclasses.replace(get_config("whisper-large-v3"),
                              n_layers=hd["layers"],
                              n_enc_layers=hd["enc_layers"])
    model, packed = build_leafwise(torch, cfg, device)
    b, p, n = hd["batch"], hd["prompt"], hd["new"]
    batch = frontend_batch(torch, cfg, b, p, device,
                           torch.Generator(device=device).manual_seed(19))
    # one device on the card: the reference run and its launches
    zero_launch_counters()
    logits, cache, cur = grown_prefill(torch, model, packed, batch,
                                       hd["max_seq"])
    one_toks, one_seen = decode_greedy(torch, model, packed, logits, cache,
                                       cur, n, keep_logits=True)
    one = read_launch_counters()
    del logits, cache
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mesh = make_host_mesh(hd["mesh"], devices=[str(device)] * 8)
    log(f"[head_dim] (1, 8) mesh of 8 ranks on {device} up in "
        f"{time.perf_counter() - t0:.2f} s")
    try:
        ctx = shd.from_mesh(mesh)
        layout = model.cache_layout(batch, b)
        specs = model.cache_specs(ctx, dataclasses.replace(
            layout, seq=hd["max_seq"]))
        cut = {path: sp for path, sp in _leaves(specs)
               if path.endswith(("/k", "/v"))}
        if not cut or any(sp != (None, None, None, None, "model")
                          for sp in cut.values()):
            fail(f"head_dim: the K/V leaves are not cut over head_dim: "
                 f"{cut}")
        placed = shd.device_put(packed, model.param_shardings(ctx, packed),
                                mesh)
        cpu_batch = {k: v.cpu() for k, v in batch.items()}
        mesh.gather(rank_launches, True)
        mesh.gather(rank_peak, True)
        t0 = time.perf_counter()
        res = mesh.gather(rank_headdim_decode, model, placed.key, b,
                          hd["max_seq"], n,
                          per_rank=shd.batch_blocks(ctx, cpu_batch,
                                                    strict=False))
        t_run = time.perf_counter() - t0
        counts = mesh.gather(rank_launches, True)
        peaks = mesh.gather(rank_peak)
        placed.drop()
    finally:
        mesh.close()
    for r, (toks, _, _, blocks) in enumerate(res):
        if not np.array_equal(toks, res[0][0]):
            fail(f"head_dim: rank {r}'s tokens {toks} differ from rank 0's")
        if any(shp[-1] != cfg.head_dim_ // 8 for shp in blocks.values()):
            fail(f"head_dim: rank {r}'s K/V blocks {blocks} do not hold "
                 f"{cfg.head_dim_ // 8} dims")
    toks, seen, _, blocks = res[0]
    want = {k: one[k] for k in ("msb_matmul", "msb_unembed",
                                "flash_attention_fwd")}
    for r, c in enumerate(counts):
        got = {k: c[k] for k in want}
        if got != want or not all(v > 0 for v in got.values()):
            fail(f"head_dim: rank {r} launches {got}, one device {want}")
    split = first_divergences({i: toks[i] for i in range(b)},
                              {i: one_toks[i] for i in range(b)})
    for i in range(b):
        j = split.get(i)
        upto = n if j is None else j + 1
        for step in range(upto):
            a, ref = seen[step][i], one_seen[step][i]
            fin = torch.isfinite(ref)
            rel = float((a[fin] - ref[fin]).abs().max()
                        / ref[fin].abs().max())
            if not rel <= TP_LOGIT_TOL[16]:
                fail(f"head_dim: row {i} step {step} logits differ from one "
                     f"device's by {rel} of their largest")
        if j is not None:
            gap = top2_gap(one_seen[j][i])
            log(f"  row {i}: first divergence at step {j}, top-2 gap "
                f"{gap:.3g}")
            if not gap < 1e-2:
                fail(f"head_dim: row {i} diverges at step {j} from one "
                     f"device's tokens at a top-2 gap of {gap}")
    log(f"  (1, 8) whisper-large-v3 ({hd['enc_layers']} + {hd['layers']} "
        f"layers, packed) B={b} x {p} tokens over {WHISPER_FRAMES} frames, "
        f"ring {hd['max_seq']}: every K/V leaf (None, None, None, None, "
        f"'model'), rank 0's blocks {sorted(set(blocks.values()))}; "
        f"prefill + grow + {n} decode steps {t_run:.2f} s; ms a decode step "
        f"by rank {[f'{x[2]:.1f}' for x in res]}; peak GB by rank "
        f"{[f'{x:.3f}' for x in peaks]}; A launches by rank "
        f"{[c['msb_matmul'] for c in counts]}, D by rank "
        f"{[c['flash_attention_fwd'] for c in counts]} (one device: A "
        f"{one['msb_matmul']}, D {one['flash_attention_fwd']}); tokens "
        f"{'identical' if not split else split}")
    del packed, model
    torch.cuda.empty_cache()
    # (b) the dry-run's two test cells, in this process: a CPU check (fake
    # CPU tensors, nothing runs on the card)
    with tempfile.TemporaryDirectory() as tmp:
        for arch, quantized in (("internlm2-1.8b", True),
                                ("whisper-large-v3", False)):
            t0 = time.perf_counter()
            rec = dryrun.run_cell(arch, "decode_32k", quantized=quantized,
                                  out_dir=tmp, verbose=False)
            mem = rec["memory_analysis"]
            if not all(isinstance(v, int) for v in mem.values()):
                fail(f"dry-run {arch}: memory_analysis {mem}")
            log(f"  dry-run {arch} decode_32k"
                f"{' --quantized' if quantized else ''} single pod (a CPU "
                f"check, {time.perf_counter() - t0:.1f} s; the roofline "
                f"modelled for the H100 SXM5 datasheet, not measured): "
                f"{json.dumps(rec)}")
    log(f"[head_dim] ok in {time.perf_counter() - t_phase:.1f} s")
    return counts


# ---------------------------------------------------------------------------
# phase 20: the example programs
# ---------------------------------------------------------------------------

PROGRAMS_DIR = os.path.join(ROOT, "examples_torch")
E2E_STEPS = (40, 50)          # the 100m preset's run, then its relaunch
SERVER_GRACE_S = 30.0         # APIServer.run's drain grace


def load_program(name):
    """``examples_torch/<name>.py`` loaded by path under its own name, its
    directory on ``sys.path``: a mesh's spawned ranks import the functions
    the program sends them by that name."""
    import importlib.util
    if name in sys.modules:
        return sys.modules[name]
    if PROGRAMS_DIR not in sys.path:
        sys.path.insert(0, PROGRAMS_DIR)
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(PROGRAMS_DIR, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def run_program(torch, name, argv):
    """``main(argv)`` of a program, the launch counters zeroed just before
    it and read just after: (its result, the launches, seconds)."""
    mod = load_program(name)
    torch.cuda.synchronize()
    zero_launch_counters()
    t0 = time.perf_counter()
    out = mod.main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = read_launch_counters()
    log(f"  {name} {' '.join(argv)}: {secs:.1f} s; launches "
        + ", ".join(f"{k} {v}" for k, v in counts.items() if v))
    return out, counts, secs


class HealthWatch:
    """Polls ``/healthz`` of ``port`` every 50 ms on a thread and keeps
    the statuses it saw, in order, each once ("down" before the socket
    binds, then the body's ``status``)."""

    def __init__(self, port):
        import threading
        self.port, self.seen = port, []
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        while not self._stop.is_set():
            try:
                status, _, body = http_call("127.0.0.1", self.port, "GET",
                                            "/healthz", timeout=5)
                state = json.loads(body).get("status", str(status))
            except (OSError, ValueError):
                state = "down"
            if not self.seen or self.seen[-1] != state:
                self.seen.append(state)
            self._stop.wait(0.05)

    def stop(self):
        self._stop.set()
        self._t.join(5)


def start_server():
    """``examples_torch/serve_api.py --port <free port>`` as a process on
    the card, its output to a temp file, a ``HealthWatch`` on it."""
    import socket
    import tempfile
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = tempfile.TemporaryFile(mode="w+")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.Popen(
        [sys.executable, os.path.join(PROGRAMS_DIR, "serve_api.py"),
         "--port", str(port)], env=env, stdout=out,
        stderr=subprocess.STDOUT, cwd=ROOT)
    return proc, port, HealthWatch(port), out


def finish_server(proc, port, watch, out, timeout=300.0):
    """Wait for the server's ``/healthz`` to read ok, answer one request,
    then SIGTERM: it must drain and exit 0 within the drain grace."""
    import signal
    t0 = time.perf_counter()
    try:
        while "ok" not in watch.seen:
            if proc.poll() is not None:
                fail(f"serve_api server exited with {proc.returncode} "
                     "before /healthz read ok")
            if time.perf_counter() - t0 > timeout:
                fail(f"serve_api server: /healthz never ok ({watch.seen})")
            time.sleep(0.05)
        status, _, body = http_call("127.0.0.1", port, "POST",
                                    "/v1/completions",
                                    {"prompt": list(range(1, 10)),
                                     "max_tokens": 16}, timeout=120)
        toks = completion_tokens(status, body, False)
        if len(toks) != 16:
            fail(f"serve_api server answered {len(toks)} tokens of 16")
        watch.stop()
        proc.send_signal(signal.SIGTERM)
        t1 = time.perf_counter()
        try:
            rc = proc.wait(timeout=SERVER_GRACE_S + 10)
        except subprocess.TimeoutExpired:
            fail("serve_api server did not exit within the drain grace")
        out.seek(0)
        tail = out.read().strip().splitlines()[-4:]
        if rc != 0:
            fail(f"serve_api server exited {rc} after SIGTERM: {tail}")
        log(f"  serve_api server on port {port}: /healthz {watch.seen}; one "
            f"request of 16 tokens answered; SIGTERM -> exit 0 in "
            f"{time.perf_counter() - t1:.2f} s; last lines {tail}")
        return {"healthz": watch.seen, "exit_s": time.perf_counter() - t1}
    finally:
        watch.stop()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        out.close()


def phase_programs(torch, device):
    """Phase 20: the five programs of ``examples_torch`` on the card, each
    loaded by path and called as ``main([..., "--device", "cuda"])``, the
    launch counters zeroed just before each; the HTTP server as a process
    of its own. The 100m preset's Markov chain (the program's
    ``make_data``, built once a process) is drawn on a thread meanwhile:
    its host draw takes ~25 s. Returns {program: launches} and the
    numbers of each program."""
    import shutil
    import tempfile
    import threading
    from repro_torch.device import resolve_device
    t_phase = time.perf_counter()
    dev = ["--device", "cuda"]
    counts, res = {}, {}
    server = start_server()        # warms while the programs run
    e2e = load_program("train_quantize_serve")
    model, batch, seq = e2e.build_model("100m")
    chain = {}

    def draw():
        try:
            t0 = time.perf_counter()
            e2e.make_data(model.cfg.vocab_size, seq, batch,
                          resolve_device("cuda"))
            chain["seconds"] = time.perf_counter() - t0
        except BaseException as exc:          # re-raised on the main thread
            chain["error"] = exc

    drawer = threading.Thread(target=draw, daemon=True)
    drawer.start()
    try:
        # serve_api: the self-check, then the chaos self-check
        out, counts["serve_api"], _ = run_program(
            torch, "serve_api", ["--self-check"] + dev)
        res["self_check"] = out
        out, c, _ = run_program(torch, "serve_api",
                                ["--self-check", "--chaos"] + dev)
        counts["serve_api"] = {k: v + c[k] for k, v in
                               counts["serve_api"].items()}
        res["chaos"] = check_chaos(out)

        out, counts["serve_quantized"], _ = run_program(
            torch, "serve_quantized", dev)
        if not (counts["serve_quantized"]["paged_attention_decode"] and
                counts["serve_quantized"]["flash_attention_fwd"] and
                counts["serve_quantized"]["msb_matmul"]):
            fail("serve_quantized: a kernel of its path was not launched")
        log(f"  serve_quantized: agreement {out['agreement']:.3f}, "
            f"continuous = static: {out['token_identical']}, divergences "
            f"(request, token, top-2 gap) {out['divergences']}")
        res["serve_quantized"] = out

        out, counts["distributed_quantize"], _ = run_program(
            torch, "distributed_quantize", dev)
        check_distributed(torch, out, device)
        res["distributed"] = out

        # a quarter of the reference's 512 rows: the paper's CPU solver
        # (WGM, numpy on the host) takes 10-16 s at the full shape
        out, counts["quickstart"], _ = run_program(
            torch, "quickstart", ["--shape", "128", "2048"] + dev)
        rows = out["rows"]
        dp = rows[0][3]
        if not all(dp <= r[3] for r in rows[1:6]):
            fail(f"quickstart: DP's MSE {dp} above another 4b/64 row: "
                 f"{rows}")
        log("  quickstart: " + "; ".join(
            f"{n.split(' (')[0]} {t:.2f} s MSE {m:.5f}"
            for n, _, t, m in rows))
        res["quickstart"] = out

        # train -> quantize -> serve at the 100m preset, then a relaunch
        t0 = time.perf_counter()
        drawer.join()
        if "error" in chain:
            raise chain["error"]
        log(f"  the 100m preset's chain drawn in {chain['seconds']:.1f} s "
            f"on a thread; waited {time.perf_counter() - t0:.1f} s for it")
        ckpt = tempfile.mkdtemp(prefix="msb_e2e_")
        try:
            runs = []
            for steps in E2E_STEPS:
                runs.append(run_program(
                    torch, "train_quantize_serve",
                    ["--preset", "100m", "--steps", str(steps),
                     "--ckpt-dir", ckpt] + dev))
        finally:
            shutil.rmtree(ckpt, ignore_errors=True)
        if e2e.make_data.cache_info().hits < len(E2E_STEPS):
            fail("e2e: a run drew the chain again")
        res["e2e"] = check_e2e(runs)
        counts["train_quantize_serve"] = runs[0][1]

        res["server"] = finish_server(*server)
    finally:
        if server[0].poll() is None:
            server[0].kill()
            server[0].wait()
    for name in ("serve_api", "train_quantize_serve", "serve_quantized"):
        if not counts[name]["msb_matmul"]:
            fail(f"{name}: kernel A not launched")
    if not counts["serve_api"]["paged_attention_decode"]:
        fail("serve_api: kernel B not launched")
    res["seconds"] = time.perf_counter() - t_phase
    log(f"[programs] five programs of examples_torch on the card in "
        f"{res['seconds']:.1f} s: the server drained and exited 0 on "
        "SIGTERM, the self-check and the chaos self-check (crashes at step "
        "and apply, OOM at alloc, with graphs) passed, the 100m preset "
        "trained, resumed, quantized and served, the (4, 2) quantize made "
        "0 collectives")
    return counts, res


def check_chaos(out):
    """The chaos run fired faults at step, apply and alloc, and the device
    memory in use grew by at most one incarnation's graph pool (the last
    crash's traceback may hold one), never by one a restart."""
    growth = out["memory_at_end"] - out["memory_after_warmup"]
    log(f"  chaos: {out['restarts']} restarts, "
        f"{out['replayed_tokens']} tokens replayed, "
        f"{out['warmup_traces']} captures in "
        f"{out['warmup_seconds']:.2f} s; faults {out['faults_fired']}; "
        f"device memory {out['memory_after_warmup'] / 1e6:.1f} MB after "
        f"the first warm-up, {out['memory_at_end'] / 1e6:.1f} MB at the "
        f"end, an incarnation's graph pool {out['graph_bytes'] / 1e6:.1f} MB")
    sites = {s for s, _ in out["faults_fired"]}
    if not {"step", "apply", "alloc"} <= sites:
        fail(f"chaos: faults fired only at {sites}")
    if growth > out["graph_bytes"] + (16 << 20):
        fail(f"chaos: device memory grew {growth} B over "
             f"{out['restarts']} restarts (graph pool {out['graph_bytes']} "
             "B): abandoned incarnations keep memory")
    return out


def check_e2e(runs):
    """The 100m preset's two runs: every loss finite and the loss falling,
    the relaunch resumed from step 25, kernel D launched exactly twice a
    layer a step (the forward and its remat recompute) and once a layer
    in each held-out NLL and in the prefill of ``generate``."""
    (first, c1, s1), (again, c2, s2) = runs
    if again["resumed_from"] != 25:
        fail(f"e2e relaunch resumed from {again['resumed_from']}, not 25")
    for out, counts in ((first, c1), (again, c2)):
        losses = [out["losses"][k] for k in sorted(out["losses"])]
        if not all(np.isfinite(losses)):
            fail(f"e2e: a loss is not finite: {losses}")
        if not (np.isfinite(out["nll_fp"]) and np.isfinite(out["nll_q"])):
            fail(f"e2e: held-out NLL fp {out['nll_fp']} 4-bit "
                 f"{out['nll_q']}")
        n_layers = out["n_layers"]
        want = out["steps_run"] * 2 * n_layers + 3 * n_layers
        if counts["flash_attention_fwd"] != want:
            fail(f"e2e: {counts['flash_attention_fwd']} D launches, want "
                 f"{want} ({out['steps_run']} steps x 2 x {n_layers} "
                 f"layers + 3 x {n_layers})")
        if not (counts["msb_matmul"] and counts["msb_unembed"]):
            fail("e2e: the 4-bit serve launched no A or no unembedding")
    losses = [first["losses"][k] for k in sorted(first["losses"])]
    if not losses[-1] < losses[0]:
        fail(f"e2e: the loss did not fall: {losses[0]} -> {losses[-1]}")
    log(f"  e2e 100m: first loss {losses[0]:.4f} (ln V "
        f"{first['ln_vocab']:.4f}), step {E2E_STEPS[0]} loss "
        f"{losses[-1]:.4f}; relaunch resumed from step 25, last loss "
        f"{again['losses'][max(again['losses'])]:.4f}; median step "
        f"{first['median_step_s'] * 1e3:.1f} ms "
        f"({first['tokens_per_s']:.0f} tok/s; relaunch "
        f"{again['median_step_s'] * 1e3:.1f} ms), peak "
        f"{first['peak_bytes'] / 1e9:.2f} GB; held-out NLL fp "
        f"{first['nll_fp']:.4f}, 4-bit {first['nll_q']:.4f} (floor "
        f"{first['floor']:.4f}); {s1:.1f} s and {s2:.1f} s; D "
        f"{c1['flash_attention_fwd']} and {c2['flash_attention_fwd']}")
    return {"first_loss": losses[0], "ln_vocab": first["ln_vocab"],
            "median_step_ms": first["median_step_s"] * 1e3,
            "relaunch_median_step_ms": again["median_step_s"] * 1e3,
            "tokens_per_s": first["tokens_per_s"],
            "peak_gb": first["peak_bytes"] / 1e9, "nll_fp": first["nll_fp"],
            "nll_q": first["nll_q"], "seconds": (s1, s2),
            "d_launches": c1["flash_attention_fwd"]}


def check_distributed(torch, out, device):
    """Each rank's codes and scales bitwise the single-device
    ``quantize_blockwise`` of its shard on the card; no collective."""
    from repro_torch.core import quantize_blockwise
    if out["collectives"] != 0:
        fail(f"distributed_quantize: {out['collectives']} collectives")
    prog = load_program("distributed_quantize")
    shards = prog.shard(torch.from_numpy(out["weight"]), out["mesh"])
    for r, ws in enumerate(shards):
        q = quantize_blockwise(ws.to(device), bits=4, block=64, solver="dp")
        if not (torch.equal(q.codes.cpu(), out["codes"][r]) and
                torch.equal(q.scales.cpu(), out["scales"][r])):
            fail(f"distributed_quantize: rank {r}'s codes or scales differ "
                 "from the single-device solve of its shard")
    log(f"  distributed_quantize {out['mesh']}: 0 collectives; every "
        f"rank's codes and scales bitwise the single-device solve; "
        f"{out['seconds'] * 1e3:.0f} ms, {out['blocks_per_s']:.0f} blocks/s,"
        f" MSE {out['mse']:.4f}")


def kernel_line(mm_rows, un_rows, pa_rows, paq_rows, fa_rows, counts,
                q_counts, s_counts, f_counts, st_counts, grad_rows, train,
                tp_counts, off_rows, gspmd, gs_counts, hd_counts,
                prog_counts):
    """The kernel table as the JSON line's rows: each kernel at its main
    path's representative shape (A at decode and at M=4096, and its expert
    batch at granite-moe's and jamba's decode; the unembedding's kernel at
    M=8 on
    internlm2's k-blocked and gemma2's tied table; B and C at the decode
    shape and, with
    gemma2's window, at d=256; D at the static prefill, at gemma2's
    d=256 windowed prefill and at whisper's encoder and cross-attention),
    with the launches of the run that serves it (counters zeroed just
    before it). Whisper's rows split its prefill's D launches by shape:
    the encoder's are those of the encoder run alone; the rest are the
    decoder's, whose every layer launches D once causal and once across,
    so the cross row has half of them. The tp = 2 rows (phase 16) are A at
    each of internlm2's shard shapes at M=8, the unembedding's kernel on
    one rank's half of its table, B and C (kv4) at one rank's 8 heads over
    4 KV heads; their launches are both ranks' in the kv16 (kv4 for C)
    H=8 run."""
    src = "src/repro_torch/csrc/"
    mm_src, pa_src = src + "msb_matmul.cu", src + "paged_attention.cu"
    a_tpu = "src/repro/kernels/msb_matmul/msb_matmul.py:117"
    b_tpu = "src/repro/kernels/paged_attention/paged_attention.py:198"
    c_tpu = "src/repro/kernels/paged_attention/paged_attention.py:142"
    d_tpu = "src/repro/kernels/flash_attention/flash_attention.py:92"

    def row(name, source, replaces, launches, r, err):
        return dict(name=name, route="cuda", source=source,
                    replaces=replaces, launches=launches, max_abs_err=err,
                    ms=r["ms"], plain_ms=r["plain_ms"],
                    bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                    library_ms=r["library_ms"], shape=r["shape"])

    def mm_row(m, k, n, experts=False):
        return next(r for r in mm_rows if (r["m"], r["k"], r["n"]) ==
                    (m, k, n) and r.get("experts", False) == experts)

    mm_err = max(r["max_abs_err"] for r in mm_rows)
    un_err = max(r["max_abs_err"] for r in un_rows)

    def un_row(table, m=8):
        return next(r for r in un_rows if (r["table"], r["m"]) == (table, m))

    plain_pa = [r for r in pa_rows if not (r.get("window") or r.get("tp2")
                                           or r.get("ps4") or r.get("ps8"))]
    pa_w = next(r for r in pa_rows if r.get("window"))
    pa_err = max(r["max_abs_err"] for r in pa_rows)
    gem, moe = f_counts["gemma2"], f_counts["moe"]
    fa_w = next(r for r in fa_rows if r["shape"].startswith("gemma2"))
    fa_err = max(r["max_abs_err"] for r in fa_rows)
    rows = [
        row("msb_matmul", mm_src, a_tpu, counts["msb_matmul"],
            mm_row(8, 2048, 8192), mm_err),
        row("msb_matmul_m4096", mm_src, a_tpu, s_counts["msb_matmul"],
            mm_row(4096, 2048, 8192), mm_err),
        row("msb_matmul_experts", mm_src, a_tpu,
            moe[16]["msb_matmul_experts"], mm_row(8, 1536, 512, True),
            mm_err),
        row("msb_matmul_experts_jamba", mm_src, a_tpu,
            st_counts["jamba-v0.1-52b"]["msb_matmul_experts"],
            mm_row(8, 4096, 14336, True), mm_err),
        row("msb_unembed_kblocked", mm_src, a_tpu, counts["msb_unembed"],
            un_row("internlm2"), un_err),
        row("msb_unembed_tied", mm_src, a_tpu, gem[16]["msb_unembed"],
            un_row("gemma2"), un_err),
        row("paged_attention_decode", pa_src, b_tpu,
            counts["paged_attention_decode"], plain_pa[-1], pa_err),
        row("paged_attention_decode_window", pa_src, b_tpu,
            gem[16]["paged_attention_decode"], pa_w, pa_err),
    ]
    for r in paq_rows:
        if r.get("tp2"):
            continue
        if r.get("window"):
            if r["bits"] == 4:
                rows.append(row("paged_attention_decode_quant_kv4_window",
                                pa_src, c_tpu,
                                gem[4]["paged_attention_decode_quant"], r,
                                r["max_abs_err"]))
            continue
        rows.append(row(f"paged_attention_decode_quant_kv{r['bits']}",
                        pa_src, c_tpu,
                        q_counts[r["bits"]]["paged_attention_decode_quant"],
                        r, r["max_abs_err"]))
    rows += [
        row("flash_attention_fwd", src + "flash_attention.cu", d_tpu,
            s_counts["flash_attention_fwd"], fa_rows[0], fa_err),
        row("flash_attention_fwd_d256_window", src + "flash_attention.cu",
            d_tpu, f_counts["gemma2_static"]["flash_attention_fwd"], fa_w,
            fa_err),
    ]
    enc = st_counts["whisper-encoder"]["flash_attention_fwd"]
    dec = st_counts["whisper-large-v3"]["flash_attention_fwd"] - enc
    for name, case, launches in (("encoder", "whisper encoder", enc),
                                 ("cross", "whisper cross", dec // 2)):
        rows.append(row(f"flash_attention_fwd_whisper_{name}",
                        src + "flash_attention.cu", d_tpu, launches,
                        next(r for r in fa_rows
                             if r["name"].startswith(case)), fa_err))
    # D with its lse at internlm2's train shape, launched by phase 15's
    # full-width run; the row also carries the backward's time (plain
    # torch, not a kernel) and SDPA's forward+backward
    grad_row = grad_rows[TIMED_GRAD[0]]
    rows.append(dict(row("flash_attention_fwd_lse_train",
                         src + "flash_attention.cu", d_tpu,
                         train["d_launches"], grad_row,
                         grad_row["max_abs_err"]),
                     bwd_ms=grad_row["bwd_ms"],
                     bwd_bound_ms=grad_row["bwd_bound_ms"],
                     sdpa_fwd_bwd_ms=grad_row["sdpa_fwd_bwd_ms"]))
    # context parallelism: D with q_offset at the shape phase 17's (1, 3)
    # run launches it on every rank (f32, the SIMT kernel; the last
    # rank's rows)
    rows.append(row("flash_attention_fwd_q_offset",
                    src + "flash_attention.cu", d_tpu, gspmd["cp_launches"],
                    next(r for r in off_rows
                         if r["name"].endswith("phase 17")),
                    max(r["max_abs_err"] for r in off_rows)))
    # tensor parallelism: both ranks' launches in phase 16's H=8 runs
    def tp_launches(bits, name):
        return sum(c[name] for c in tp_counts[bits])

    for (k, n), leaf in zip(TP2_SHAPES, ("wq", "wk_wv", "attn_wo", "wg_wi",
                                          "mlp_wo")):
        rows.append(row(f"msb_matmul_tp2_{leaf}", mm_src, a_tpu,
                        tp_launches(16, "msb_matmul"), mm_row(8, k, n),
                        mm_err))
    rows.append(row("msb_unembed_kblocked_tp2", mm_src, a_tpu,
                    tp_launches(16, "msb_unembed"), un_row("internlm2_tp2"),
                    un_err))
    rows.append(row("paged_attention_decode_tp2", pa_src, b_tpu,
                    tp_launches(16, "paged_attention_decode"),
                    next(r for r in pa_rows if r.get("tp2")), pa_err))
    paq_tp = next(r for r in paq_rows if r.get("tp2"))
    rows.append(row("paged_attention_decode_quant_kv4_tp2", pa_src, c_tpu,
                    tp_launches(4, "paged_attention_decode_quant"), paq_tp,
                    paq_tp["max_abs_err"]))
    # GSPMD serving (phase 18): the four ranks' launches. The continuous
    # engine's model_shard runs the tp = 2 shard shapes (A at the wq
    # slice, the unembedding on half the table, B and C at a rank's
    # heads); the static engine D at a (2, 2) rank's prefill, at the
    # B=1 x 1024 prompt and at a rank's heads of the dense tree
    def gs_launches(key, name):
        return sum(c[name] for c in gs_counts[key])

    def gs_row(name, key, kernel, r, err, source=mm_src, replaces=a_tpu):
        return dict(row(name, source, replaces, gs_launches(key, kernel), r,
                        err),
                    launches_by_rank=[c[kernel] for c in gs_counts[key]])

    rows += [
        gs_row("msb_matmul_gspmd", 16, "msb_matmul",
               mm_row(8, *TP2_SHAPES[0]), mm_err),
        gs_row("msb_unembed_kblocked_gspmd", 16, "msb_unembed",
               un_row("internlm2_tp2"), un_err),
        gs_row("paged_attention_decode_gspmd", 16, "paged_attention_decode",
               next(r for r in pa_rows if r.get("tp2")), pa_err, pa_src,
               b_tpu),
        gs_row("paged_attention_decode_quant_kv4_gspmd", 4,
               "paged_attention_decode_quant", paq_tp,
               paq_tp["max_abs_err"], pa_src, c_tpu),
        gs_row("flash_attention_fwd_gspmd_rank", "static",
               "flash_attention_fwd",
               next(r for r in fa_rows if r["name"] == "gspmd rank B=4 S=512"),
               fa_err, src + "flash_attention.cu", d_tpu),
        gs_row("flash_attention_fwd_gspmd_b1", "long", "flash_attention_fwd",
               next(r for r in fa_rows if r["name"] == "gspmd B=1 S=1024"),
               fa_err, src + "flash_attention.cu", d_tpu),
        gs_row("flash_attention_fwd_gspmd_dense", "dense",
               "flash_attention_fwd",
               next(r for r in fa_rows
                    if r["name"] == "gspmd dense rank B=4 S=256"),
               fa_err, src + "flash_attention.cu", d_tpu),
    ]
    # the head_dim cut (phase 19): the eight ranks' launches. Every rank
    # runs A at whisper's decode shape (M=2) among others, the
    # unembedding's kernel at M=2 on whisper's tied table (row tile 2),
    # and D at the encoder over 1500 frames among others
    def hd_row(name, kernel, r, err, source=mm_src, replaces=a_tpu):
        launches = [c[kernel] for c in hd_counts]
        return dict(row(name, source, replaces, sum(launches), r, err),
                    launches_by_rank=launches)

    rows += [
        hd_row("msb_matmul_headdim", "msb_matmul", mm_row(2, 1280, 1280),
               mm_err),
        hd_row("msb_unembed_headdim", "msb_unembed", un_row("whisper", 2),
               un_err),
        hd_row("flash_attention_fwd_headdim_encoder", "flash_attention_fwd",
               next(r for r in fa_rows
                    if r["name"] == "headdim whisper encoder B=2 S=1500"),
               fa_err, src + "flash_attention.cu", d_tpu),
    ]
    # phase 20's programs: A at the 100m preset's gate/up projection and
    # its tied f32 table at its serve's M=4, D with its lse at its train
    # shape (the launches: its first run's), B at serve_api's page size 4
    # (the self-check's and the chaos run's) and serve_quantized's 8; each
    # row also carries the launches of its kernel in every program that
    # launched it
    e2e = prog_counts["train_quantize_serve"]

    def prog_row(name, kernel, launches, r, err, source=mm_src,
                 replaces=a_tpu):
        return dict(row(name, source, replaces, launches, r, err),
                    launches_by_program={p: c[kernel] for p, c in
                                         prog_counts.items() if c[kernel]})

    fa_e2e = grad_rows[TIMED_GRAD[1]]
    rows += [
        prog_row("msb_matmul_e2e_100m", "msb_matmul", e2e["msb_matmul"],
                 mm_row(4, 768, 2048), mm_err),
        prog_row("msb_unembed_tied_e2e_100m", "msb_unembed",
                 e2e["msb_unembed"], un_row("e2e_100m", 4), un_err),
        dict(prog_row("flash_attention_fwd_lse_e2e_100m",
                      "flash_attention_fwd", e2e["flash_attention_fwd"],
                      fa_e2e, fa_e2e["max_abs_err"],
                      src + "flash_attention.cu", d_tpu),
             bwd_ms=fa_e2e["bwd_ms"], bwd_bound_ms=fa_e2e["bwd_bound_ms"],
             sdpa_fwd_bwd_ms=fa_e2e["sdpa_fwd_bwd_ms"]),
        prog_row("paged_attention_decode_ps4", "paged_attention_decode",
                 prog_counts["serve_api"]["paged_attention_decode"],
                 next(r for r in pa_rows if r.get("ps4")), pa_err, pa_src,
                 b_tpu),
        prog_row("paged_attention_decode_ps8", "paged_attention_decode",
                 prog_counts["serve_quantized"]["paged_attention_decode"],
                 next(r for r in pa_rows if r.get("ps8")), pa_err, pa_src,
                 b_tpu),
    ]
    for r in rows:
        if not r["launches"] > 0:
            fail(f"{r['name']}: no launch on its path")
    return rows


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs one "
             "CUDA device")
    import repro_torch  # noqa: F401  (fails outside a checkout)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    t_start = time.perf_counter()
    laps = []

    def lap(name):
        """The seconds since the last lap, under ``name``."""
        t = time.perf_counter()
        laps.append((name, t - (laps[-1][2] if laps else t_start), t))

    phase_env(torch)
    phase_build()
    lap("1-2 env, build")
    timer = Timer(torch, device)
    mm_rows = phase_msb_matmul(torch, timer, device)
    un_rows = phase_msb_unembed(torch, timer, device)
    lap("3 msb_matmul, msb_unembed")
    pa_rows = phase_paged_attention(torch, timer, device)
    lap("4 paged_attention")
    paq_rows = phase_paged_attention_quant(torch, timer, device)
    lap("5 paged_attention_quant")
    fa_rows = phase_flash_attention(torch, timer, device)
    off_rows = phase_flash_offset(torch, timer, device)
    grad_rows = phase_flash_grad(torch, timer, device)
    lap("6 flash_attention")
    del timer
    counts, ctx = phase_serve(torch, device)
    lap("7 serve")
    q_counts = phase_serve_quant(torch, device, ctx)
    lap("8 serve kv8/kv4")
    s_counts = phase_serve_static(torch, device, ctx)
    lap("9 serve static")
    phase_paths(torch)
    lap("10 paths")
    phase_front_door(torch, ctx)
    lap("11 front door")
    tp_counts = phase_tp(torch, device, ctx)
    lap("16 tp")
    del ctx
    phase_quantizer(torch, device)
    lap("12 quantizer")
    f_counts = phase_families(torch, device)
    lap("13 families")
    st_counts = phase_state_stacks(torch, device)
    lap("14 state stacks")
    train = phase_train(torch, device)
    lap("15 train")
    gspmd = phase_gspmd(torch, device)
    lap("17 gspmd")
    gs_counts = phase_gspmd_serve(torch, device)
    lap("18 gspmd serve")
    hd_counts = phase_headdim(torch, device)
    lap("19 head_dim")
    prog_counts, _ = phase_programs(torch, device)
    lap("20 programs")
    log("[phases] " + "; ".join(f"{n} {d:.1f} s" for n, d, _ in laps))
    kernels = kernel_line(mm_rows, un_rows, pa_rows, paq_rows, fa_rows,
                          counts, q_counts, s_counts, f_counts, st_counts,
                          grad_rows, train, tp_counts, off_rows, gspmd,
                          gs_counts, hd_counts, prog_counts)
    log(f"[done] {time.perf_counter() - t_start:.1f} s total")
    print(smi_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
