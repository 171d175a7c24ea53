"""Static-batch serving engine (prefill -> ring-buffer decode), and the
execution-mode resolution the serving engines share.

Port of ``repro.serve.engine``. ``execution="packed"`` (the default)
rewrites QTensor leaves once at load into kernel-layout ``PackedQTensor``s,
so every forward streams 4-bit codes through the msb_matmul kernel;
``execution="simulated"`` keeps the QTensors and dequantizes them per call,
the paper's simulation (Sec. 4.1). ``ServeEngine`` runs a fixed batch in
lockstep: one prefill (every attention on the flash-attention kernel) and
then one ring decode step per token; ``score`` is the held-out NLL
through the loss forward. It serves every decoder-only stack, those with
per-sequence state too (jamba's mamba layers, xlstm), which paging does
not. Production traffic goes through ``ContinuousEngine``; both give the
same greedy tokens in either mode.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core.quantize import map_tensors
from ..device import resolve_device


def resolve_execution(execution, params, device):
    """Resolve ``execution`` (``None`` = ``"packed"``) and place ``params``
    on ``device``. ``"packed"`` packs the QTensor leaves into kernel layout
    once (``core.policy.pack_params``); ``"simulated"`` moves the tree as it
    is, so ``dense`` and the embedding dequantize QTensors per call and
    multiply with ``torch.matmul``, where the reference multiplies outside
    any kernel (``jnp.einsum``). Attention runs its kernels either way.
    Returns (execution, params)."""
    if execution is None:
        execution = "packed"
    if execution == "packed":
        from ..core.policy import pack_params
        params, _ = pack_params(params, device=device)
    elif execution == "simulated":
        params = map_tensors(lambda t: t.to(device), params)
    else:
        raise ValueError(f"execution must be 'packed' or 'simulated', "
                         f"got {execution!r}")
    return execution, params


@dataclasses.dataclass
class ServeEngine:
    """Static-batch serving engine on ``device`` (``None`` = the card).

    Contract: ``generate(prompts, n)`` runs one prefill and n lockstep
    decode steps and returns the argmax token sequence of the model (or,
    with ``temperature > 0``, samples drawn with the given generator).
    ``params`` may mix dense tensors and MSB ``QTensor`` leaves; they are
    packed once at load (``execution="packed"``) or dequantized per call
    (``"simulated"``), and the caller's tree is not modified. ``mesh=``
    and ``parallel=`` (tensor parallelism) are ROADMAP item 11.
    """
    model: object
    params: object
    max_seq: int
    execution: Optional[str] = None    # "packed" | "simulated"; None=packed
    device: object = None              # None = the card
    parallel: object = None
    mesh: object = None

    def __post_init__(self):
        if self.mesh is not None or self.parallel is not None:
            raise NotImplementedError(
                "mesh=/parallel=: tensor-parallel serving is ROADMAP item 11")
        self.device = resolve_device(self.device)
        self.execution, self.params = resolve_execution(
            self.execution, self.params, self.device)

    def _grow_cache(self, cache, prompt_len):
        """Move prefill caches (length P) into ``max_seq`` ring buffers.
        Only attention's K/V leaves grow, found by their path (``attn/k``,
        ``attn/v``), as the reference finds them: recurrent state keeps its
        shape, and whisper's ``xattn`` K/V is the static encoder's, every
        row of which decode attends. Where the reference pads each K/V
        leaf, this allocates the rings once (zeros) and copies the prefill
        K/V into their first P rows; the position table, where the cache
        has one, is -1 (empty) past P."""
        s = self.max_seq

        def grow(node, path=()):
            if isinstance(node, dict):
                return {k: grow(v, path + (k,)) for k, v in node.items()}
            if path[-2:] not in (("attn", "k"), ("attn", "v")):
                return node
            ring = node.new_zeros(node.shape[:2] + (s,) + node.shape[3:])
            ring[:, :, :prompt_len] = node
            return ring

        new = {"layers": grow(cache["layers"])}
        if "pos" in cache:
            pos = torch.full((cache["pos"].shape[0], s), -1,
                             dtype=torch.int32, device=cache["pos"].device)
            pos[:, :prompt_len] = cache["pos"]
            new["pos"] = pos
        return new

    def generate(self, prompts, n_tokens, temperature=0.0, generator=None):
        """prompts: (B, P) int. Returns (B, n_tokens) int32 numpy tokens.

        A Python loop of ``Model.decode_step`` with sampling on the device —
        greedy argmax, or with ``temperature > 0`` a categorical sample
        (Gumbel-max with noise from ``generator``, a ``torch.Generator`` on
        the engine's device; default seed 0) — in the reference's order:
        sample, decode, advance. Nothing is read back until the loop ends."""
        prompts = torch.as_tensor(np.asarray(prompts), dtype=torch.int32,
                                  device=self.device)
        b, p = prompts.shape
        assert p + n_tokens <= self.max_seq
        logits, cache = self.model.prefill(self.params, {"tokens": prompts})
        cache = self._grow_cache(cache, p)
        if temperature > 0 and generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        cur = torch.full((b,), p, dtype=torch.int32, device=self.device)
        out = []
        for _ in range(int(n_tokens)):
            if temperature > 0:
                u = torch.rand(logits.shape, generator=generator,
                               device=self.device)
                gumbel = -torch.log(-torch.log(u))
                tok = torch.argmax(logits / temperature + gumbel, dim=-1)
            else:
                tok = torch.argmax(logits, dim=-1)
            tok = tok.to(torch.int32)
            out.append(tok)
            logits, cache = self.model.decode_step(self.params, cache,
                                                   tok[:, None], cur)
            cur = cur + 1
        if not out:
            return np.zeros((b, 0), np.int32)
        return torch.stack(out, dim=1).cpu().numpy()

    def score(self, tokens):
        """Mean next-token NLL (with the z-loss, as the reference's loss) of
        ``tokens`` (B, S) under the model."""
        tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.int32,
                                 device=self.device)
        batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
        loss, _ = self.model.loss(self.params, batch)
        return float(loss)
