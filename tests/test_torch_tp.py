"""Tensor-parallel packed serving of the PyTorch port (DESIGN.md Sec. 10)
on the CPU, held against the JAX package.

The port runs one process a rank (``repro_torch.parallel.spmd``): the
meshes here are CPU ranks (``make_tp_mesh(tp, devices=["cpu"] * tp)``),
one a tp size for the module, every rank at one intra-op thread. The
reference runs ``shard_map`` over forced host devices (tests/conftest.py).
Both serve the reference's quantized smoke params (vocab 64, f32; made
from a seed as tests/test_tp.py makes them).

Held: the planner (shard marks, padded widths, report, and each rank's
slices byte for byte the reference's global arrays cut by its
PartitionSpecs) at tp = 2, 3, 4; padding that preserves values,
``tp_localize``, tp = 1 as the identity; ``ContinuousEngine`` greedy
tokens at tp = 2 and 4, packed and simulated, identical to the port's
tp = 1 and to ``repro.serve.ContinuousEngine(mesh=make_tp_mesh(tp))``;
weight-sharded heads, MoE experts at tp = 4, preemption on a head-sharded
pool, a fork's pool copy; ``ServeEngine`` ``generate`` identical and
``score`` within 1e-5 relative; a worker that raises makes the controller
raise and leaves no process behind; the refusals.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as j_core
from repro.configs import smoke_config as j_smoke
from repro.launch.mesh import make_tp_mesh as j_make_tp_mesh
from repro.models import Model as JModel
from repro.serve import ContinuousEngine as JEngine
from repro.serve import ServeEngine as JServe
from repro_torch.configs import smoke_config as t_smoke
from repro_torch.convert import from_reference
from repro_torch.core import (PackedQTensor, QTensor, pack_params,
                              tp_localize, tp_partition_params, tp_shard)
from repro_torch.launch.mesh import make_tp_mesh
from repro_torch.models import Model
from repro_torch.parallel.spmd import RankError
from repro_torch.serve import ContinuousEngine, ServeEngine

import test_torch_tp_ranks as torch_tp_ranks

ENGINE = dict(max_batch=4, page_size=4, max_seq=32, prefill_chunk=8)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(arch="internlm2-1.8b", **over):
    """(reference model, its quantized params, the port's model, the same
    params in the port): tests/test_tp.py's ``_quantized``."""
    cfg = dataclasses.replace(j_smoke(arch), vocab_size=64, vocab_round=64,
                              **over)
    jm = JModel(cfg)
    params = jax.tree_util.tree_map(lambda p: p.astype(jnp.float32),
                                    jm.init(jax.random.PRNGKey(0)))
    policy = j_core.QuantPolicy(bits=4, block=64, solver="kmeans",
                                min_size=1024)
    qparams, _ = jax.jit(lambda p: j_core.quantize_params(p, policy))(params)
    tcfg = dataclasses.replace(t_smoke(arch), vocab_size=64, vocab_round=64,
                               **over)
    return jm, qparams, Model(tcfg), from_reference(qparams, "cpu")


@pytest.fixture(scope="module")
def dense(_one_thread):
    return _setup()


@pytest.fixture(scope="module")
def moe(_one_thread):
    return _setup("granite-moe-3b-a800m")


@pytest.fixture(scope="module")
def wide(_one_thread):
    """Heads wide enough for whole 64-blocks a rank at tp = 2: the planner
    shards attention's weights (tests/test_tp.py's ``wide_head_model``)."""
    return _setup(n_heads=2, n_kv_heads=2, head_dim=64)


@pytest.fixture(scope="module")
def meshes(_one_thread):
    made = {tp: make_tp_mesh(tp, devices=["cpu"] * tp) for tp in (2, 4)}
    yield made
    for mesh in made.values():
        mesh.close()


def _requests(seed=1, n=4):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 64, (int(rng.integers(4, 12)),)).astype(np.int32),
             int(rng.integers(4, 10))) for _ in range(n)]


def _serve(model, params, execution, mesh=None, num_pages=64, seed=1,
           **kw):
    eng = ContinuousEngine(model, params, execution=execution, mesh=mesh,
                           num_pages=num_pages, device="cpu", **ENGINE, **kw)
    for r in _requests(seed):
        eng.submit(*r)
    out = eng.run()
    eng.close()
    return eng, out


def _serve_ref(jm, qparams, execution, tp, num_pages=64, seed=1):
    eng = JEngine(jm, qparams, execution=execution,
                  mesh=j_make_tp_mesh(tp), num_pages=num_pages, **ENGINE)
    for r in _requests(seed):
        eng.submit(*r)
    return eng, eng.run()


def _assert_identical(a, b):
    assert a.keys() == b.keys()
    for rid in a:
        np.testing.assert_array_equal(np.asarray(a[rid]), np.asarray(b[rid]))


# ---------------------------------------------------------------------------
# planner
# ---------------------------------------------------------------------------

def _spec_dim(spec):
    """The dim a reference PartitionSpec shards, or None."""
    for i, axis in enumerate(tuple(spec)):
        if axis is not None:
            return i
    return None


def _tensors(leaf):
    if isinstance(leaf, (PackedQTensor, QTensor)) or hasattr(leaf, "scales"):
        first = "packed" if hasattr(leaf, "packed") else "codes"
        return {first: getattr(leaf, first), "scales": leaf.scales}
    return {"": leaf}


def _walk(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, f"{path}/{k}" if path else k)
    else:
        yield path, tree


def _ref_tree(qparams, packed):
    return j_core.pack_params(qparams)[0] if packed else qparams


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("tp", [2, 3, 4])
def test_planner_matches_reference(dense, moe, wide, tp, packed):
    """Marks, padded widths, the report and every rank's slices byte for
    byte the reference's global arrays cut by its PartitionSpecs, for the
    dense, MoE and wide-head trees."""
    for jm, jq, tm, _ in (dense, moe, wide):
        jtree = _ref_tree(jq, packed)
        ttree = from_reference(jtree, "cpu")
        jnew, jspecs, jrep = j_core.tp_partition_params(jtree, tp, cfg=jm.cfg)
        tnew, tspecs, trep = tp_partition_params(ttree, tp, cfg=tm.cfg)
        assert trep == jrep
        jleaves = dict(_walk(jnew))
        jspec_leaves = dict(_walk(jspecs))
        shards = [tp_shard(tnew, tspecs, r, tp) for r in range(tp)]
        for path, tleaf in _walk(tnew):
            jleaf = jleaves[path]
            assert getattr(tleaf, "shard", None) == getattr(jleaf, "shard",
                                                            None), path
            if isinstance(tleaf, PackedQTensor):
                assert (tleaf.n, tleaf.n_pad) == (jleaf.n, jleaf.n_pad), path
            tparts, jparts = _tensors(tleaf), _tensors(jleaf)
            jspec = _tensors(jspec_leaves[path])
            for name, whole in jparts.items():
                whole = np.asarray(whole)
                assert tuple(tparts[name].shape) == whole.shape, path
                dim = _spec_dim(jspec[name])
                for r in range(tp):
                    mine = _tensors(dict(_walk(shards[r]))[path])[name]
                    assert mine.is_contiguous()
                    want = whole if dim is None else np.split(
                        whole, tp, axis=dim)[r]
                    got = mine.numpy() if mine.dtype != torch.bfloat16 else \
                        mine.float().numpy()
                    assert got.shape == want.shape, (path, name, r)
                    assert got.tobytes() == np.ascontiguousarray(
                        want.astype(got.dtype)).tobytes(), (path, name, r)


def test_planner_padding_is_value_preserving(dense):
    """d_ff 128 at tp = 4 pads the hidden width to 256 with exact zeros on
    both sides of the SwiGLU; the untied unembedding shards along vocab."""
    _, _, tm, tq = dense
    tree, _, report = tp_partition_params(tq, 4, cfg=tm.cfg)
    mlp = tree["dec"]["s0"]["mlp"]
    assert (mlp["wg"].shard, mlp["wi"].shard, mlp["wo"].shard) == \
        ("n", "n", "k")
    assert mlp["wg"].codes.shape[-1] == 256 and \
        mlp["wo"].codes.shape[-2] == 256
    assert tree["unembed"].shard == "v" and "unembed" in report
    wg0 = tq["dec"]["s0"]["mlp"]["wg"].dequantize()
    wg1 = mlp["wg"].dequantize()
    assert torch.equal(wg1[..., :wg0.shape[-1]], wg0)
    assert not wg1[..., wg0.shape[-1]:].any()
    assert not mlp["wo"].dequantize()[:, wg0.shape[-1]:].any()
    packed, _ = pack_params(tq, device="cpu")
    ptree, _, _ = tp_partition_params(packed, 4, cfg=tm.cfg)
    pw0 = packed["dec"]["s0"]["mlp"]["wo"].dequantize()
    pw1 = ptree["dec"]["s0"]["mlp"]["wo"].dequantize()
    assert torch.equal(pw1[:, :pw0.shape[1]], pw0)
    assert not pw1[:, pw0.shape[1]:].any()


@pytest.mark.parametrize("tp", [3, 4])
def test_planner_localize(dense, tp):
    """A rank's n-sharded packed slice keeps the global padded width in
    aux; ``tp_localize`` rebinds n to the slice's (d_ff 128 pads to 64 *
    tp, one block a rank); k-sharded leaves keep theirs."""
    _, _, tm, tq = dense
    packed, _ = pack_params(tq, device="cpu")
    tree, specs, _ = tp_partition_params(packed, tp, cfg=tm.cfg)
    wg = tree["dec"]["s0"]["mlp"]["wg"]
    assert wg.n == wg.n_pad == 64 * tp and wg.shard == "n"
    local = tp_localize(tp_shard(tree, specs, 1, tp))
    assert local["dec"]["s0"]["mlp"]["wg"].n == 64
    assert local["dec"]["s0"]["mlp"]["wo"].n == \
        tree["dec"]["s0"]["mlp"]["wo"].n


def test_planner_tp1_is_identity(dense):
    _, _, tm, tq = dense
    tree, specs, report = tp_partition_params(tq, 1, cfg=tm.cfg)
    assert report == {}
    for (pa, a), (pb, b) in zip(_walk(tree), _walk(tq)):
        assert pa == pb and a is b
    assert tp_shard(tree, specs, 0, 1)["embed"].codes is tq["embed"].codes


# ---------------------------------------------------------------------------
# engines: greedy tokens at tp > 1 are those of tp = 1 and the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("execution", ["simulated", "packed"])
@pytest.mark.parametrize("tp", [2, 4])
def test_continuous_tp_token_identity(dense, meshes, execution, tp):
    """tp = 2 head-shards the paged pools (kv 2); tp = 4 replicates
    attention with padded MLP shards and vocab-sharded logits. Both give
    the tp = 1 tokens and the reference's at the same tp, with its
    report."""
    jm, jq, tm, tq = dense
    _, base = _serve(tm, tq, execution)
    eng, out = _serve(tm, tq, execution, meshes[tp])
    jeng, ref = _serve_ref(jm, jq, execution, tp)
    _assert_identical(base, out)
    _assert_identical(out, ref)
    assert eng.tp_report == jeng.tp_report and eng.tp_report


@pytest.mark.parametrize("kv_bits", [8, 4])
@pytest.mark.parametrize("horizon", [1, 4])
def test_continuous_tp_quantized_pools(dense, meshes, kv_bits, horizon):
    """kv8/kv4 pools split by head (the codec's groups never cross heads)
    and the decode horizon: tokens those of tp = 1 at the same kv_bits."""
    _, _, tm, tq = dense
    kw = dict(kv_bits=kv_bits, decode_horizon=horizon)
    _, base = _serve(tm, tq, "packed", **kw)
    eng, out = _serve(tm, tq, "packed", meshes[2], **kw)
    _assert_identical(base, out)
    eng.cache.check_invariants(expect_idle=True)


def test_weight_sharded_attention_heads(wide, meshes):
    """64-block-aligned head widths a rank: QKV column-sharded, wo
    row-sharded (psum), the pools and the static caches a rank's heads."""
    jm, jq, tm, tq = wide
    for execution in ("simulated", "packed"):
        _, base = _serve(tm, tq, execution)
        eng, out = _serve(tm, tq, execution, meshes[2])
        assert eng.tp_report.get("dec/s0/attn") == "heads"
        assert eng.cache.pools["layers"]["s0"]["attn"]["k"].shape[3] == 1
        _assert_identical(base, out)
    _, ref = _serve_ref(jm, jq, "packed", 2)
    _assert_identical(out, ref)
    prompts = np.arange(8, dtype=np.int32).reshape(2, 4)
    e1 = ServeEngine(tm, tq, max_seq=32, device="cpu")
    e2 = ServeEngine(tm, tq, max_seq=32, device="cpu", mesh=meshes[2])
    np.testing.assert_array_equal(e1.generate(prompts, 6),
                                  e2.generate(prompts, 6))
    e2.close()


def test_moe_experts_under_tp(moe, meshes):
    """16 padded experts shard 4 ways; routing is replicated, so the
    tokens are those of tp = 1 and of the reference at tp = 4."""
    jm, jq, tm, tq = moe
    for execution in ("simulated", "packed"):
        _, base = _serve(tm, tq, execution, seed=2)
        eng, out = _serve(tm, tq, execution, meshes[4], seed=2)
        assert eng.tp_report.get("dec/s0/moe") == "experts"
        _assert_identical(base, out)
    _, ref = _serve_ref(jm, jq, "packed", 4, seed=2)
    _assert_identical(out, ref)


def test_preemption_on_sharded_cache(dense, meshes):
    """A pool too small for the burst forces preemption by recompute;
    re-prefill through the head-sharded pools gives the un-preempted
    tp = 1 tokens, and the pages come back."""
    _, _, tm, tq = dense
    _, base = _serve(tm, tq, "simulated", num_pages=64, seed=2)
    eng, out = _serve(tm, tq, "simulated", meshes[2], num_pages=8, seed=2)
    assert eng.scheduler.n_preemptions > 0
    _assert_identical(base, out)
    eng.cache.check_invariants(expect_idle=True)


def test_fork_copies_every_rank_pools(dense, meshes):
    """A fork's partial-page copy runs on every rank: the children replay
    the parent's greedy continuation, at kv16 (page copy) and kv4 (hot
    row copy)."""
    _, _, tm, tq = dense
    prompt = np.arange(1, 7, dtype=np.int32)       # ends mid-page
    for kv_bits in (16, 4):
        eng = ContinuousEngine(tm, tq, mesh=meshes[2], device="cpu",
                               kv_bits=kv_bits, num_pages=64, **ENGINE)
        rid = eng.submit(prompt, 8)
        while len(eng._seqs[rid].generated) < 2:
            eng.step()
        kids = eng.fork_request(rid, n=2)
        assert eng.n_forks == 2
        out = eng.run()
        parent = out[rid]
        for kid in kids:
            np.testing.assert_array_equal(out[kid][:6], parent[2:])
        eng.close()


def test_serve_engine_tp(dense, meshes):
    """``ServeEngine`` at tp = 2: ``generate`` gives the tp = 1 tokens
    (greedy and sampled from one seed) and the reference's at tp = 2;
    ``score`` is within 1e-5 relative of tp = 1 and of the reference."""
    jm, jq, tm, tq = dense
    prompts = np.arange(8, dtype=np.int32).reshape(2, 4)
    tokens = np.arange(16, dtype=np.int32).reshape(2, 8) % 64
    for execution in ("simulated", "packed"):
        ref = JServe(jm, jq, max_seq=32, execution=execution,
                     mesh=j_make_tp_mesh(2))
        want = np.asarray(ref.generate(jnp.asarray(prompts), n_tokens=6))
        ref_score = float(ref.score(jnp.asarray(tokens)))
        e1 = ServeEngine(tm, tq, max_seq=32, device="cpu",
                         execution=execution)
        e2 = ServeEngine(tm, tq, max_seq=32, device="cpu",
                         execution=execution, mesh=meshes[2])
        assert e2.tp_report == ref.tp_report
        got = e2.generate(prompts, 6)
        np.testing.assert_array_equal(e1.generate(prompts, 6), got)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            e1.generate(prompts, 6, temperature=0.8,
                        generator=torch.Generator().manual_seed(3)),
            e2.generate(prompts, 6, temperature=0.8,
                        generator=torch.Generator().manual_seed(3)))
        s1, s2 = e1.score(tokens), e2.score(tokens)
        assert abs(s2 - s1) <= 1e-5 * abs(s1)
        assert abs(s2 - ref_score) <= 1e-5 * abs(ref_score)
        e2.close()
        with pytest.raises(RuntimeError, match="closed"):
            e2.score(tokens)


# ---------------------------------------------------------------------------
# the mesh: failures, refusals
# ---------------------------------------------------------------------------

def test_worker_error_raises_and_leaves_no_process():
    """A worker whose function raises: the controller raises its error,
    every worker is gone, and the mesh refuses later calls."""
    mesh = make_tp_mesh(2, devices=["cpu", "cpu"])
    procs = list(mesh._procs)
    assert mesh.gather(torch_tp_ranks.psum_ranks) == [3.0, 3.0]
    with pytest.raises(RankError, match="rank 1 fails on purpose"):
        mesh.run(torch_tp_ranks.raise_on_rank_1)
    assert not any(p.is_alive() for p in procs)
    with pytest.raises(RankError, match="broken"):
        mesh.run(torch_tp_ranks.psum_ranks)
    mesh.close()


def test_mesh_refusals(dense):
    _, _, tm, tq = dense
    with pytest.raises(TypeError, match="make_tp_mesh"):
        ContinuousEngine(tm, tq, mesh=object(), device="cpu")
    with pytest.raises(TypeError, match="ParallelContext"):
        ContinuousEngine(tm, tq, parallel=object(), device="cpu")
    with pytest.raises(ValueError, match="needs 2 devices"):
        make_tp_mesh(2, devices=["cpu"])
