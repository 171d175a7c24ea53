"""The port's dry-run: ``Model.input_specs`` against the reference's, the
op-by-op cost model (``launch/op_cost.py``) against analytic counts, the
recorded collectives' wire factors, the H100 roofline terms, and whole
cells written by ``launch/dryrun.run_cell`` on the single-pod mesh.

Ports ``tests/test_roofline.py``'s three cases: a Python loop of L
matmuls counted at exactly 2·L·n³ (eager torch has no while loop to
undercount), a psum of 1024 f32 over 8 ranks at wire 2·4096·7/8 with the
other collectives' factors, and the three terms with the card's
datasheet figures."""
import dataclasses
import json

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_config
from repro.launch.roofline import Roofline as JRoofline
from repro.models import Model as JModel
from repro_torch.configs import SHAPES, get_config, list_archs, smoke_config
from repro_torch.launch import dryrun, mesh, op_cost, roofline
from repro_torch.models import Model
from repro_torch.parallel import sharding as shd

J_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "int32": torch.int32}


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


@pytest.mark.parametrize("shape", sorted(J_SHAPES))
@pytest.mark.parametrize("arch", list_archs())
def test_input_specs_match_reference(arch, shape):
    """Leaves, shapes, dtypes and logical axes, from ShapeDtypeStructs
    (nothing compiled)."""
    j_specs, j_axes = JModel(j_config(arch)).input_specs(J_SHAPES[shape])
    t_specs, t_axes = Model(get_config(arch)).input_specs(SHAPES[shape])
    want = dict(_leaves(j_specs))
    got = dict(_leaves(t_specs))
    assert got.keys() == want.keys()
    for path, sds in want.items():
        t = got[path]
        assert t.device.type == "meta", path
        assert tuple(t.shape) == tuple(sds.shape), path
        assert t.dtype == J_DTYPES[str(sds.dtype)], path
    is_axes = lambda x: isinstance(x, tuple)   # noqa: E731
    assert dict(_leaves(t_axes)) == {
        p: tuple(a) for p, a in _leaves(j_axes) if is_axes(a)}


def test_loop_of_matmuls_counted_exactly():
    """L matmuls of n x n in a Python loop: 2·L·n³ FLOPs, and every
    operand and result once (f32)."""
    L, n = 16, 64
    x = torch.randn(n, n)
    ws = torch.randn(L, n, n)

    def f(x, ws):
        for i in range(L):
            x = x @ ws[i]
        return x
    _, cost = op_cost.count(f, x, ws)
    assert cost.flops == 2.0 * L * n ** 3
    assert cost.bytes == L * 3 * n * n * 4


def _recording_ctx(n, log):
    ctx = shd.ParallelContext(shd.MeshShape((n,), ("data",)), ("data",),
                              fsdp_axis=None, coords=(0,), groups={})
    ctx.groups[("data",)] = dryrun.RecordingGroup(n, log)
    return ctx


def test_collectives_counted_with_wire_factors():
    """A psum of 1024 f32 over 8 ranks is one all-reduce of wire
    2·4096·7/8, whether called raw or through its autograd Function; the
    other collectives follow roofline.py's table, and each stand-in has
    the result's shape."""
    log = []
    ctx = _recording_ctx(8, log)
    x = torch.randn(1024)
    out, cost = op_cost.count(lambda t: shd.psum(t, ctx, "data"), x,
                              log=log)
    assert tuple(out.shape) == (1024,)
    assert cost.coll == {"all-reduce": {"count": 1, "result_bytes": 4096,
                                        "wire_bytes": 2 * 4096 * 7 / 8}}
    assert cost.wire_bytes == pytest.approx(2 * 4096 * 7 / 8)
    log.clear()
    y = torch.randn(8, 128)

    def every(t):
        return (shd.raw_all_gather(ctx, t, "data", 1),
                shd.raw_reduce_scatter(ctx, t, "data", 0),
                shd.raw_all_to_all(ctx, t, "data", 0, 1),
                shd.raw_permute(ctx, t, "data", 1),
                shd.raw_pmax(ctx, t, "data"))
    outs, cost = op_cost.count(every, y, log=log)
    assert [tuple(o.shape) for o in outs] == [(8, 1024), (1, 128),
                                             (1, 1024), (8, 128), (8, 128)]
    size = 8 * 128 * 4
    assert cost.coll["all-gather"]["wire_bytes"] == 8 * size * 7 / 8
    assert cost.coll["reduce-scatter"]["wire_bytes"] == size / 8 * 7
    assert cost.coll["all-to-all"]["wire_bytes"] == size * 7 / 8
    assert cost.coll["collective-permute"]["wire_bytes"] == size
    assert cost.coll["all-reduce"]["wire_bytes"] == 2 * size * 7 / 8
    assert all(r["count"] == 1 for r in cost.coll.values())


def test_roofline_terms_and_bottleneck():
    """The three terms with the H100 SXM5's datasheet figures, and the
    reference's record keys (its ``xla_*`` cross-checks null here)."""
    assert (mesh.PEAK_FLOPS_BF16, mesh.HBM_BW, mesh.ICI_BW) == \
        (989.4e12, 3.35e12, 450e9)
    rl = roofline.Roofline(flops_per_chip=989.4e12,
                           bytes_per_chip=3.35e12 * 2,
                           wire_bytes_per_chip=450e9 * 0.5, collectives={},
                           model_flops_total=989.4e12 * 256, chips=256)
    assert rl.compute_s == pytest.approx(1.0)
    assert rl.memory_s == pytest.approx(2.0)
    assert rl.collective_s == pytest.approx(0.5)
    assert rl.bottleneck == "memory"
    assert rl.roofline_fraction == pytest.approx(0.5)
    assert rl.useful_flops_ratio == pytest.approx(1.0)
    want = JRoofline(1.0, 1.0, 1.0, {}, 1.0, 1).to_dict()
    got = rl.to_dict()
    assert got.keys() == want.keys()
    assert got["xla_flops_per_chip"] is None
    assert got["xla_bytes_per_chip"] is None


def test_fake_tensors_count_what_real_ones_do():
    """A smoke internlm2 loss: the same FLOPs and bytes on fake tensors as
    on real CPU ones."""
    model = Model(smoke_config("internlm2-1.8b"))
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, 503, (2, 16)).astype(
        np.int32)) for k in ("tokens", "labels")}
    _, real = op_cost.count(model.loss, params, batch)
    with FakeTensorMode() as mode:
        fp = shd._map(mode.from_tensor, params)
        fb = {k: mode.from_tensor(v) for k, v in batch.items()}
        _, fake = op_cost.count(model.loss, fp, fb)
    assert fake.flops == real.flops > 0
    assert fake.bytes == real.bytes > 0


def test_full_width_prefill_near_2nd():
    """internlm2-1.8b at full width, prefill of 2 x 256 on fake tensors:
    within 0.2 of 2ND (the logits are the last position's only)."""
    cfg = get_config("internlm2-1.8b")
    model = Model(cfg)
    with FakeTensorMode():
        params = shd._map(torch.empty, model.param_shapes())
        batch = {"tokens": torch.empty(2, 256, dtype=torch.int32)}
        _, cost = op_cost.count(model.prefill, params, batch)
    ratio = cost.flops / (2.0 * cfg.n_params() * 2 * 256)
    assert abs(ratio - 1.0) < 0.2, ratio


REF_KEYS = {"arch", "shape", "mesh", "quantized", "chips", "n_params",
            "n_active_params", "compile_s", "memory_analysis", "roofline"}
MEM_KEYS = {"argument_bytes_per_dev", "output_bytes_per_dev",
            "temp_bytes_per_dev", "alias_bytes_per_dev",
            "peak_bytes_per_dev"}


@pytest.mark.parametrize("arch,quantized", [("internlm2-1.8b", True),
                                            ("whisper-large-v3", False)])
def test_run_cell_writes_a_complete_record(arch, quantized, tmp_path):
    """decode_32k on the single-pod mesh. whisper's cross-attention K/V
    (1500 rows, 20 KV heads) is cut over head_dim on 16 model ranks."""
    rec = dryrun.run_cell(arch, "decode_32k", quantized=quantized,
                          out_dir=str(tmp_path), verbose=False)
    tag = f"{arch}__decode_32k__single_pod_16x16" + ("__msb4" if quantized
                                                      else "")
    assert json.loads((tmp_path / f"{tag}.json").read_text()) == rec
    assert REF_KEYS <= rec.keys() and rec["chips"] == 256
    mem = rec["memory_analysis"]
    assert mem.keys() == MEM_KEYS
    assert all(isinstance(v, int) and v >= 0 for v in mem.values())
    assert mem["alias_bytes_per_dev"] > 0          # the cache, in place
    assert mem["peak_bytes_per_dev"] == (
        mem["argument_bytes_per_dev"] + mem["output_bytes_per_dev"]
        + mem["temp_bytes_per_dev"] - mem["alias_bytes_per_dev"])
    rl = rec["roofline"]
    assert rl["flops_per_chip"] > 0 and rl["bytes_per_chip"] > 0
    assert rl["bottleneck"] in ("compute", "memory", "collective")
    assert rl["model_flops_total"] == 2.0 * rec["n_active_params"] * 128
    assert "all-gather" in rl["collectives"]
    if arch == "whisper-large-v3":
        ctx, _ = dryrun.dry_context()
        model = Model(get_config(arch))
        layout = dataclasses.replace(model.cache_layout(
            {"tokens": torch.empty(128, 1), "frames": torch.empty(128, 1500,
                                                                   1)}),
            seq=32768)
        spec = model.cache_specs(ctx, layout)["layers"]["s0"]["xattn"]["k"]
        assert spec == (None, "data", None, None, "model")
        assert rec["enc_seq"] == 1500
        # all-reduces a layer: the ring's combine (pmax, psum), the cross
        # attention's partial scores over head_dim, the MLP's row-parallel
        # psum
        assert rl["collectives"]["all-reduce"]["count"] == 4 * 32
