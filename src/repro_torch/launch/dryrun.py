"""Multi-pod dry-run of the port: one rank's step of every (arch x shape
x mesh) cell, counted op by op on fake tensors, with the H100 roofline.

Port of ``repro.launch.dryrun``. The reference AOT-compiles each cell's
entry point on the 16x16 or 2x16x16 production mesh and reads
``memory_analysis()`` and loop-aware costs out of the compiled HLO. No
process here holds 256 or 512 ranks, and torch has no HLO, so a cell runs
rank 0's blocks of the real entry point:

* the mesh is a ``sharding.MeshShape`` (16, 16) ("data", "model") or
  (2, 16, 16) ("pod", "data", "model") with no workers, and rank 0's
  ``ParallelContext`` has coords (0, ...) and a ``RecordingGroup`` for
  every set of mesh axes in place of a ``sharding.GlooGroup``: each
  collective is counted where it is called, and nothing is sent;
* every param, optimizer, batch and cache leaf is rank 0's block
  (``resolve_spec`` / ``local_shape``) as a fake tensor
  (``FakeTensorMode``: shape and dtype, no storage);
* the entry point runs under ``op_cost.CostMode``: ``make_train_step``'s
  rank step, ``Model.prefill(global_batch=)`` or
  ``Model.decode_step(layout=)``.

Rank 0 stands for every rank: the blocks are alike in shape on each.
The fake tensors are CPU tensors, so the kernels' wrappers take their
plain versions, as the reference's dry-run compiles its jnp path: no
kernel launches, and no real tensor goes through this path. It runs on
the CPU in seconds a cell.

The record has the reference's keys. ``compile_s`` is the trace time:
the wall time of the fake run. ``memory_analysis`` is read from the
blocks: argument bytes (params or train state, batch, cache), output
bytes (what the entry point returns), alias bytes (outputs that are
arguments updated in place: the train state, the decode cache, which the
reference donates), and temp bytes, the peak of bytes live beyond the
arguments less the outputs made anew, so that ``peak_bytes_per_dev`` is
argument + output + temp - alias as in the reference. The roofline
(``launch/roofline.py``) is modelled from NVIDIA's H100 SXM5 datasheet
figures, not measured.

Where the port differs from the reference's cell:

* quantized leaves are placed whole on every rank (``Model.
  param_specs``; the reference cuts their codes by the param's axes);
* whisper's decode cache holds ``WHISPER_ENC_ROWS`` encoder rows of
  cross-attention K/V, what ``prefill`` leaves from 30 s of audio; the
  reference's stand-in sizes them at S. On the single-pod mesh neither
  1500 rows nor 20 KV heads divide 16 ways, so that K/V is cut over
  ``head_dim``.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma2-2b --shape train_4k
  python -m repro_torch.launch.dryrun --all --skip-existing
  python -m repro_torch.launch.dryrun --arch arctic-480b \\
      --shape decode_32k --quantized   # MSB int8-code weights
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from ..configs import SHAPES, cell_is_skipped, get_config, list_archs
from ..core.quantize import QTensor
from ..models import Model
from ..models.model import CacheLayout
from ..parallel import sharding as shd
from ..train import AdamW, OptConfig, make_train_step
from . import op_cost, roofline

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "artifacts", "dryrun_torch")
HARDWARE = ("NVIDIA H100 SXM5 80GB, 700 W: datasheet figures "
            "(launch/mesh.py), modelled, not measured")
WHISPER_ENC_ROWS = 1500

# embed/unembed excluded in *simulation* mode: row-gather doesn't benefit
# from a full-table dequant (the reference's rule)
_QUANT_EXCLUDE = ("norm", "bias", "router", "conv_w", "dt_bias", "a_log",
                  "d_skip", "f_bias", "w_rec", "embed")


class RecordingGroup:
    """The dry-run's stand-in for a ``sharding.GlooGroup`` of ``n``
    ranks, with its methods: each collective appends (op, the result's
    bytes, ``n``) to ``log`` and returns a stand-in of the result's shape
    (``new_empty`` on the input's device: a fake tensor under
    ``FakeTensorMode``), so the op is counted as the collective it is
    (``op_cost``), not as the host staging a gloo group runs. Nothing is
    sent."""

    def __init__(self, n, log):
        self.n, self.log = int(n), log

    def size(self):
        return self.n

    def _record(self, op, x, grow=None, cut=None):
        """``op``'s result on ``x``: dim ``grow`` n times longer, dim
        ``cut`` n times shorter, where the op changes the shape."""
        shape = list(x.shape)
        if cut is not None:
            shape[cut] //= self.n
        if grow is not None:
            shape[grow] *= self.n
        out = x.new_empty(shape)
        self.log.append((op, out.numel() * out.element_size(), self.n))
        return out

    def all_gather(self, x, dim):
        return self._record("all-gather", x, grow=dim)

    def psum(self, x):
        return self._record("all-reduce", x)

    def pmax(self, x):
        return self._record("all-reduce", x)

    def reduce_scatter(self, x, dim):
        return self._record("reduce-scatter", x, cut=dim)

    def all_to_all(self, x, split_dim, concat_dim):
        return self._record("all-to-all", x, grow=concat_dim, cut=split_dim)

    def permute(self, x, shift):
        return self._record("collective-permute", x)


def _bf16(shapes):
    """The params' dtypes for prefill and decode: leaves of two or more
    dims in bf16, the rest in f32."""
    return shd._map(lambda shp: torch.bfloat16 if len(shp) >= 2
                    else torch.float32, shapes)


def quantize_shapes(blocks, shapes, bits=4, block=64):
    """Weight leaves of a params tree of (fake) blocks as ``QTensor``
    stand-ins of the whole leaf (the port places quantized leaves whole
    on every rank): int8 codes of the leaf's global shape and bf16
    scales (..., n_blocks, 2^(bits-1)); excluded and ragged leaves keep
    their blocks."""
    def walk(tree, shape, path=()):
        if isinstance(tree, dict):
            return {k: walk(v, shape[k], path + (k,))
                    for k, v in tree.items()}
        pstr = "/".join(path)
        if (len(shape) < 2 or shape[-1] % block
                or any(x in pstr for x in _QUANT_EXCLUDE)):
            return tree
        codes = torch.empty(shape, dtype=torch.int8)
        scales = torch.empty((*shape[:-1], shape[-1] // block,
                              2 ** (bits - 1)), dtype=torch.bfloat16)
        return QTensor(codes, scales, bits, block, torch.bfloat16)
    return walk(blocks, shapes)


def dry_context(multi_pod=False):
    """Rank 0's context on the production mesh, with recording groups:
    (the context, the log its collectives append to)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    ctx = shd.from_mesh(shd.MeshShape(shape, axes))
    ctx = shd.ParallelContext(ctx.mesh, ctx.dp_axes, ctx.tp_axis,
                              ctx.fsdp_axis, coords=(0,) * len(shape),
                              groups={}, device=torch.device("cpu"))
    log = []
    ctx.groups.update(shd.make_groups(
        ctx, lambda prefix, rank, size: RecordingGroup(size, log)))
    return ctx, log


def _blocks(ctx, axes, shapes, dtypes):
    """Rank 0's fake block of every leaf (``resolve_spec``)."""
    def one(ax, shp, dt):
        shp = tuple(shp)
        spec = shd.resolve_spec(ax, shp, ctx)
        return torch.empty(shd.local_shape(shp, spec, ctx), dtype=dt)
    return shd.tree_map_axes(one, axes, shapes, dtypes)


def _moment_dtypes(opt, shapes):
    """The dtype of every optimizer-state leaf, nested as ``init``
    builds it: int8 moments' m {"q" int8, "s" bf16}, v {"q" uint8,
    "s" f32}."""
    def one(q, s):
        return lambda shape: ({"q": q, "s": s} if opt._quantize_shape(
            tuple(shape)) else torch.float32)
    return {"m": shd._map(one(torch.int8, torch.bfloat16), shapes),
            "v": shd._map(one(torch.uint8, torch.float32), shapes),
            "step": torch.int32}


def _nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _memory(args, out, peak_new):
    """The record's ``memory_analysis`` of a call on ``args`` that
    returned ``out`` (``op_cost.Cost.peak_bytes`` ``peak_new``)."""
    ins = op_cost.leaf_tensors(args)
    outs = op_cost.leaf_tensors([out])
    arg_st = {id(t.untyped_storage()) for t in ins}
    arg, output = _nbytes(ins), _nbytes(outs)
    alias = _nbytes(t for t in outs if id(t.untyped_storage()) in arg_st)
    temp = max(0, peak_new - (output - alias))
    return {"argument_bytes_per_dev": arg,
            "output_bytes_per_dev": output,
            "temp_bytes_per_dev": temp,
            "alias_bytes_per_dev": alias,
            "peak_bytes_per_dev": arg + output + temp - alias}


def _cell(model, cfg, shape, ctx, log, quantized):
    """Rank 0's entry point on fake blocks under ``CostMode``: (the
    call's arguments, its result, the ``op_cost.Cost``, model FLOPs,
    decode's encoder rows)."""
    n_act, b, s = cfg.n_active_params(), shape.global_batch, shape.seq_len
    pshapes, paxes = model.param_shapes(), model.param_axes()
    specs, axes = model.input_specs(shape)
    shapes = shd._map(lambda t: tuple(t.shape), specs)
    enc = None
    if shape.kind == "decode":
        enc = WHISPER_ENC_ROWS if cfg.is_encdec else None
        layout = CacheLayout(b, s, enc)
        shapes["cache"] = model.cache_shapes(layout)
    batch = _blocks(ctx, axes, shapes, shd._map(lambda t: t.dtype, specs))
    if shape.kind == "train":
        big = cfg.n_params() > 100e9
        opt = AdamW(OptConfig(moment_dtype="int8" if big else "f32"))
        pdt = torch.bfloat16 if big else torch.float32
        params = _blocks(ctx, paxes, pshapes,
                         shd.tree_map_axes(lambda _ax: pdt, paxes))
        moments = _blocks(ctx, opt.moment_axes(paxes, pshapes),
                          opt.moment_shapes(pshapes),
                          _moment_dtypes(opt, pshapes))
        args = ({"params": params, "opt": moments}, batch)
        out, cost = op_cost.count(make_train_step(model, opt, ctx), *args,
                                  log=log)
        return args, out, cost, 6.0 * n_act * b * s, enc
    params = _blocks(ctx, paxes, pshapes, _bf16(pshapes))
    if shape.kind == "prefill":
        args = (params, batch)
        out, cost = op_cost.count(
            lambda p, bt: model.prefill(p, bt, ctx, global_batch=b), *args,
            log=log)
        return args, out, cost, 2.0 * n_act * b * s, enc
    if quantized:
        params = quantize_shapes(params, pshapes)
    args = (params, batch["cache"], batch["tokens"], batch["cur_pos"])
    out, cost = op_cost.count(
        lambda p, c, t, pos: model.decode_step(p, c, t, pos, ctx,
                                               layout=layout), *args,
        log=log)
    return args, out, cost, 2.0 * n_act * b, enc


def run_cell(arch, shape_name, multi_pod=False, quantized=False,
             out_dir=ARTIFACT_DIR, verbose=True):
    """Trace one cell and write its record to ``out_dir``; returns it."""
    mesh_name = "multi_pod_2x16x16" if multi_pod else "single_pod_16x16"
    tag = f"{arch}__{shape_name}__{mesh_name}" + ("__msb4" if quantized
                                                  else "")
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, tag + ".json")

    skip = cell_is_skipped(arch, shape_name)
    if skip:
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
               "skipped": skip}
        with open(out_path, "w") as f:
            json.dump(rec, f, indent=1)
        if verbose:
            print(f"[dryrun] {tag}: SKIP ({skip})")
        return rec

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    model = Model(cfg)
    ctx, log = dry_context(multi_pod)
    t0 = time.time()
    with FakeTensorMode():
        args, out, cost, model_flops, enc = _cell(model, cfg, shape, ctx,
                                                  log, quantized)
        mem = _memory(args, out, cost.peak_bytes)
    rl = roofline.build(cost, model_flops, ctx.n_devices)
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "quantized": quantized, "chips": ctx.n_devices,
        "n_params": cfg.n_params(), "n_active_params": cfg.n_active_params(),
        "compile_s": time.time() - t0,
        "memory_analysis": mem,
        "roofline": rl.to_dict(),
        "hardware": HARDWARE,
        "notes": {
            "compile_s": "the trace time: wall time of rank 0's fake run",
            "xla_flops_per_chip": "null: torch has no compiler cost "
                                  "analysis to cross-check",
            "bytes_per_chip": "every op an HBM round trip (no fusion): an "
                              "upper bound on a fused program's",
        },
    }
    if enc is not None:
        rec["enc_seq"] = enc
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=1)
    if verbose:
        peak = mem["peak_bytes_per_dev"] / 2**30
        print(f"[dryrun] {tag}: OK trace={rec['compile_s']:.1f}s "
              f"peak={peak:.2f}GiB/dev "
              f"terms(c/m/n)={rl.compute_s:.4f}/{rl.memory_s:.4f}/"
              f"{rl.collective_s:.4f}s bound={rl.bottleneck} "
              f"frac={rl.roofline_fraction:.3f}")
        print(f"  memory_analysis: {mem}")
        print(f"  op_cost: flops={cost.flops:.3e} bytes={cost.bytes:.3e} "
              f"wire={cost.wire_bytes:.3e}")
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--quantized", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--out", default=ARTIFACT_DIR)
    args = ap.parse_args()

    if args.all:
        cells = [(a, s, mp) for a in list_archs() for s in SHAPES
                 for mp in (False, True)]
    else:
        meshes = (False, True) if args.both_meshes else (args.multi_pod,)
        cells = [(args.arch, args.shape, mp) for mp in meshes]

    failures = []
    for arch, shape, mp in cells:
        mesh_name = "multi_pod_2x16x16" if mp else "single_pod_16x16"
        tag = f"{arch}__{shape}__{mesh_name}" + ("__msb4" if args.quantized
                                                 else "")
        if args.skip_existing and os.path.exists(
                os.path.join(args.out, tag + ".json")):
            print(f"[dryrun] {tag}: cached")
            continue
        try:
            run_cell(arch, shape, multi_pod=mp, quantized=args.quantized,
                     out_dir=args.out)
        except Exception as e:  # noqa: BLE001 — report all failures at end
            failures.append((tag, repr(e)))
            print(f"[dryrun] {tag}: FAIL {e}")
            traceback.print_exc()
    if failures:
        print(f"\n[dryrun] {len(failures)} FAILURES:")
        for tag, err in failures:
            print(f"  {tag}: {err[:200]}")
        raise SystemExit(1)
    print("\n[dryrun] all cells OK")


if __name__ == "__main__":
    main()
