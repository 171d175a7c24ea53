"""The port's MoE layer (``repro_torch.models.moe``) and kernel A's expert
batch on the CPU, against ``repro.models.moe`` and ``repro.kernels.
msb_matmul.ref``: capacity, routing (gates, experts, positions in the
reference's flat (k, T) order, kept choices, the load-balancing loss),
dispatch, combine and the whole layer over dense, ``QTensor`` and packed
expert trees (plain version of the expert batch), a capacity overflow
that drops the same choices, the pad-token capacity difference, and the
expert batch's plain version against a loop of ``msb_matmul_ref``. fp32,
inputs from numpy seeds; the kernel itself is held against its plain
version on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.core import pack_params as j_pack
from repro.kernels.msb_matmul.ref import msb_matmul_ref as j_mm_ref
from repro.models import moe as jmoe
from repro.models import transformer as jtr
from repro_torch.configs import smoke_config as t_smoke
from repro_torch.convert import from_reference
from repro_torch.kernels.msb_matmul import ops as mm_ops
from repro_torch.kernels.msb_matmul import ref as mm_ref
from repro_torch.models import moe as tmoe

ARCHS = ["granite-moe-3b-a800m", "arctic-480b"]


def _cfgs(arch, **kw):
    return (dataclasses.replace(j_smoke(arch), **kw),
            dataclasses.replace(t_smoke(arch), **kw))


@functools.lru_cache(maxsize=None)
def _moe_params(arch, tree):
    """Layer 0's ``moe`` subtree of the reference's params as ``tree``
    (dense, quantized, packed), as the reference's and as the port's."""
    params = jtr.init_params(j_smoke(arch), jax.random.PRNGKey(3))
    jp = jax.tree_util.tree_map(lambda a: a[0], params["dec"]["s0"]["moe"])
    if tree != "dense":
        import torch_families_setup as fam
        jp = fam._quantize(jp)          # quantize_params, jitted per leaf
        if tree == "packed":
            jp, _ = j_pack(jp)
    return jp, from_reference(jp, "cpu")


def _j_moe(jp, x, cfg):
    """The reference's layer, jitted (its lax.map over quantized experts
    is slow op by op)."""
    return jax.jit(jmoe.moe_layer, static_argnums=2)(jp, jnp.asarray(x), cfg)


@pytest.mark.parametrize("tokens,k,e,cf", [(1, 2, 16, 1.25), (8, 8, 48, 1.25),
                                           (512, 8, 48, 1.25),
                                           (37, 2, 128, 1.0), (4096, 2, 16,
                                                               2.0)])
def test_capacity_matches_reference(tokens, k, e, cf):
    assert tmoe._capacity(tokens, k, e, cf) == jmoe._capacity(tokens, k, e,
                                                              cf)


@pytest.mark.parametrize("n_real,e_total,k,t,capacity", [
    (8, 16, 2, 24, 8), (40, 48, 8, 64, 8), (6, 8, 3, 40, 8)])
def test_route_dispatch_combine_match_reference(n_real, e_total, k, t,
                                                capacity):
    """Gates (1e-5: the router's f32 dot and softmax sum in another order
    than XLA's), experts, positions and kept choices identical, aux 1e-5;
    the dispatch buffer and the flat slots identical; the combine of random
    expert outputs 1e-5. (40 experts, 64 tokens, top-8, capacity 8 drops
    choices.)"""
    rng = np.random.default_rng(n_real + t)
    x = rng.standard_normal((t, 32)).astype(np.float32)
    w = rng.standard_normal((32, e_total)).astype(np.float32)
    jr = jmoe._route(jnp.asarray(x), jnp.asarray(w), e_total, n_real, k,
                     capacity)
    tr = tmoe._route(torch.from_numpy(x), torch.from_numpy(w), e_total,
                     n_real, k, capacity)
    np.testing.assert_allclose(tr[0].numpy(), np.asarray(jr[0]), rtol=0,
                               atol=1e-5)
    for a, b in zip(tr[1:4], jr[1:4]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(float(tr[4]), float(jr[4]), rtol=1e-5)
    if n_real == 40:
        assert not np.asarray(jr[3]).all()          # the case drops choices
    jbuf, jslot = jmoe._dispatch(jnp.asarray(x), *jr[:4], e_total, capacity)
    tbuf, tslot = tmoe._dispatch(torch.from_numpy(x), *tr[:4], e_total,
                                 capacity)
    np.testing.assert_array_equal(tslot.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(tbuf[:-1].numpy(), np.asarray(jbuf)[:-1])
    ye = rng.standard_normal((e_total * capacity, 32)).astype(np.float32)
    jy = jmoe._combine(jnp.asarray(ye), jslot, jr[0], jr[3], t, k, 32)
    ty = tmoe._combine(torch.from_numpy(ye), tslot, tr[0], tr[3], t, k, 32)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("tree", ["dense", "qtensor", "packed"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_layer_matches_reference(arch, tree):
    """``moe_layer`` over the reference's layer-0 experts (dense, MSB
    ``QTensor`` and packed trees): outputs within 1e-5, aux 1e-5."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _moe_params(arch, tree)
    x = np.random.default_rng(4).standard_normal(
        (2, 9, jcfg.d_model)).astype(np.float32)
    jy, jaux = _j_moe(jp, x, jcfg)
    ty, taux = tmoe.moe_layer(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)


@pytest.mark.parametrize("arch,tokens,reach", [
    ("granite-moe-3b-a800m", 8, False),      # decode at B = 8
    ("granite-moe-3b-a800m", 512, True),     # a packed-prefill wave
    ("arctic-480b", 8, False), ("arctic-480b", 512, True),
    ("granite-3-2b", 512, False)])           # no MoE layer
def test_pads_reach_tokens_only_where_an_expert_can_overflow(arch, tokens,
                                                             reach):
    """Pads take the reference's mean of V (``mean_pads``) only in paged
    dispatches whose MoE capacity is below their token count; at decode
    with B <= 8 every expert has room for every token."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as ttr
    cfg = get_config(arch)
    assert ttr._pads_reach_tokens(cfg, ttr.layer_plan(cfg), tokens) == reach


def test_capacity_overflow_drops_the_same_choices():
    """capacity_factor 0.25 on 24 tokens: capacity 8 slots for 48 choices
    over 8 real experts; the same choices are dropped (their expert term is
    0) and the layer's output equals the reference's."""
    arch = "granite-moe-3b-a800m"
    jcfg, tcfg = _cfgs(arch, capacity_factor=0.25)
    jp, tp = _moe_params(arch, "packed")
    x = np.random.default_rng(5).standard_normal(
        (1, 24, jcfg.d_model)).astype(np.float32)
    cap = jmoe._capacity(24, jcfg.n_experts_active, jcfg.n_experts_padded,
                         0.25)
    jr = jmoe._route(jnp.asarray(x[0]), jp["router"],
                     jcfg.n_experts_padded, jcfg.n_experts,
                     jcfg.n_experts_active, cap)
    tr = tmoe._route(torch.from_numpy(x[0]), tp["router"],
                     tcfg.n_experts_padded, tcfg.n_experts,
                     tcfg.n_experts_active, cap)
    keep = np.asarray(jr[3])
    assert (~keep).sum() > 0
    np.testing.assert_array_equal(tr[3].numpy(), keep)
    jy, _ = _j_moe(jp, x, jcfg)
    ty, _ = tmoe.moe_layer(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=1e-5)


def test_pad_tokens_take_capacity_in_both():
    """The difference ROADMAP §3 records: every token of a dispatch routes
    and takes capacity, pads included, so adding tokens (a packed-prefill
    wave's pads or other segments) changes the capacity and which choices
    are dropped, and with it the output of the first tokens. The port
    moves exactly as the reference does."""
    arch = "granite-moe-3b-a800m"
    jcfg, tcfg = _cfgs(arch, capacity_factor=0.5)
    jp, tp = _moe_params(arch, "packed")
    rng = np.random.default_rng(6)
    x = rng.standard_normal((1, 16, jcfg.d_model)).astype(np.float32)
    pads = np.repeat(rng.standard_normal((1, 1, jcfg.d_model)).astype(
        np.float32), 40, axis=1)          # one embedding repeated, as pads
    wave = np.concatenate([x, pads], axis=1)
    outs = {}
    for name, inp in (("alone", x), ("wave", wave)):
        jy, _ = _j_moe(jp, inp, jcfg)
        ty, _ = tmoe.moe_layer(tp, torch.from_numpy(inp), tcfg)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0,
                                   atol=1e-5)
        outs[name] = np.asarray(jy)[0, :16]
    assert np.abs(outs["alone"] - outs["wave"]).max() > 1e-3


@pytest.mark.parametrize("kblocked", [False, True])
@pytest.mark.parametrize("m", [1, 8, 24])
def test_expert_batch_plain_matches_loop_of_oracle(m, kblocked):
    """The expert batch's plain version (the CPU path of
    ``msb_matmul_experts``) equals a loop of the reference's
    ``msb_matmul_ref`` over the experts (1e-5 relative), with experts of
    count 0 exactly 0 whatever their x; ``packed_matmul_experts`` slices
    the N padding."""
    rng = np.random.default_rng(m + 7 * kblocked)
    e, k, n = 5, 128, 192
    packed = rng.integers(0, 256, (e, k, n // 2)).astype(np.uint8)
    shape = (e, k // 64, n, 8) if kblocked else (e, k, n // 64, 8)
    scales = np.sort(rng.random(shape).astype(np.float32) * 0.1, axis=-1)
    x = rng.standard_normal((e, m, k)).astype(np.float32)
    counts = np.array([m, 0, 1, 0, m], np.int32)
    y = mm_ops.msb_matmul_experts(
        torch.from_numpy(x), torch.from_numpy(packed),
        torch.from_numpy(scales), torch.from_numpy(counts),
        kblocked=kblocked).numpy()
    assert y.shape == (e, m, n)
    for i in range(e):
        if counts[i] == 0:
            assert (y[i] == 0).all()
            continue
        want = np.asarray(j_mm_ref(jnp.asarray(x[i]), jnp.asarray(packed[i]),
                                   jnp.asarray(scales[i]),
                                   kblocked=kblocked))
        np.testing.assert_allclose(y[i], want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
        alone = mm_ref.msb_matmul_ref(torch.from_numpy(x[i]),
                                      torch.from_numpy(packed[i]),
                                      torch.from_numpy(scales[i]),
                                      kblocked=kblocked).numpy()
        np.testing.assert_array_equal(y[i], alone)
    if kblocked:
        return
    from repro_torch.core.quantize import PackedQTensor
    pq = PackedQTensor(torch.from_numpy(packed), torch.from_numpy(scales), 4,
                       64, torch.float32, n - 64)
    ys = mm_ops.packed_matmul_experts(torch.from_numpy(x), pq,
                                      torch.from_numpy(counts))
    np.testing.assert_array_equal(ys.numpy(), y[..., :n - 64])


def test_expert_batch_counts_no_launch_on_the_cpu():
    before = mm_ops.msb_matmul_experts.launches
    mm_ops.msb_matmul_experts(torch.ones(2, 1, 64),
                              torch.zeros(2, 64, 32, dtype=torch.uint8),
                              torch.ones(2, 64, 1, 8),
                              torch.tensor([1, 0], dtype=torch.int32))
    assert mm_ops.msb_matmul_experts.launches == before


def _wave(bits):
    """A packed-prefill wave of arctic's smoke config: segments of 11 and 7
    tokens and 6 pads; seg 0's row past its three pages is the scratch
    page, as the engine's tables are."""
    import torch_families_setup as fam
    rng = np.random.default_rng(60 + bits)
    t = 24
    tokens, seg, pos = (np.zeros(t, np.int32), np.full(t, -1, np.int32),
                        np.full(t, -1, np.int32))
    tokens[:18] = rng.integers(0, fam.VOCAB, 18)
    seg[:11], seg[11:18] = 0, 1
    pos[:11], pos[11:18] = np.arange(11), np.arange(7)
    return [np.asarray(a, np.int32) for a in (
        tokens, seg, pos, [11, 7, 0], [[1, 2, 3, 0, 0], [6, 7, 8, 0, 0],
                                       [0] * 5], [0, 2, -1], [10, 17, 0],
        [0, 11, 0])]


def _prefill(which, m, params, pools, args, bits):
    if which == "reference":
        fn = jax.jit(m.paged_prefill_packed, static_argnames="kv_bits")
        lg, pools = fn(params, pools, *map(jnp.asarray, args), kv_bits=bits)
        return np.asarray(lg)[:2], pools
    lg, pools = m.paged_prefill_packed(params, from_reference(pools, "cpu"),
                                       *map(torch.from_numpy, args),
                                       kv_bits=bits)
    return lg.numpy()[:2], pools


def _with_capacity(m, cf):
    return type(m)(dataclasses.replace(m.cfg, capacity_factor=cf))


def test_moe_pads_read_the_scratch_page():
    """The difference ROADMAP §3 records for MoE: a pad token sees no key,
    and the reference gives it the mean of V over its block-table row,
    whose unallocated entries are the scratch page 0. Pads route and take
    capacity, so where an expert overflows (capacity_factor 0.5) the real
    tokens' logits of a kv16 packed-prefill wave move when only the
    scratch page's bytes change, in the reference and in the port alike;
    with a capacity no expert can overflow they do not move at all."""
    import torch_families_setup as fam
    jm0, tm0, trees = fam.setup("arctic-480b")
    jp, tp = trees["packed"]
    args = _wave(16)
    for cf, moves in ((0.5, True), (8.0, False)):
        for which, m, params in (("reference", jm0, jp), ("port", tm0, tp)):
            m = _with_capacity(m, cf)
            out = []
            for scratch in (0.0, 0.5):
                pools = jax.tree_util.tree_map(
                    lambda a: a.at[:, 0].set(scratch),
                    jm0.init_paged_pools(12, fam.PS))
                out.append(_prefill(which, m, params, pools, args, 16)[0])
            moved = np.abs(out[0] - out[1]).max()
            assert (moved > 1e-3) if moves else moved == 0.0, (which, cf)


def test_moe_quantized_commit_writes_other_scratch_bytes():
    """Why MoE tokens at kv_bits 8|4 can differ from the reference's in
    waves where an expert overflows: the reference quantizes every commit
    candidate and scatters the ones that complete no page onto scratch
    page 0 (the last one stays), the port only the few that can complete
    a page, so page 0's codes differ after the same wave, and pads read
    them. Where no expert can overflow the real logits agree (1e-4)."""
    import torch_families_setup as fam
    jm0, tm0, trees = fam.setup("arctic-480b")
    jp, tp = trees["packed"]
    args = _wave(8)
    cf = jm0.cfg.n_experts_padded / jm0.cfg.n_experts_active
    outs = {}
    for which, m, params in (("reference", jm0, jp), ("port", tm0, tp)):
        pools = jm0.init_paged_pools(12, fam.PS, kv_bits=8, max_seqs=3)
        outs[which] = _prefill(which, _with_capacity(m, cf), params, pools,
                               args, 8)
    np.testing.assert_allclose(outs["port"][0], outs["reference"][0], rtol=0,
                               atol=1e-4)
    j_codes = np.asarray(outs["reference"][1]["layers"]["s0"]["attn"][
        "k_codes"])[:, 0]
    t_codes = outs["port"][1]["layers"]["s0"]["attn"]["k_codes"][:, 0]
    assert not np.array_equal(t_codes.numpy(), j_codes)
