"""Kernel A's launch plan (``ops.plan``) on the CPU.

The kernel (``csrc/msb_matmul.cu``) sums an output element split by split:
each split's k16 steps in ascending order into a zeroed accumulator, the
splits in ascending order into a running f32 total from 0, then the bias.
Its tile may depend on M; where the splits run (on separate blocks, summed
by a second pass, or inside one block) may too. The K plan may not: that
is what makes an output row's bits the same at every M, which
``tests/test_torch_cuda.py`` checks bit for bit on the card. Here the plan
is checked for every M the main path and the tests use, and the expert
batch's plan (``ops.experts_plan``) for every MoE architecture's shapes.
"""
import pytest

from repro_torch.configs import get_config, list_archs
from repro_torch.kernels.msb_matmul import ops as mm_ops

MS = (1, 8, 16, 17, 64, 128, 129, 512, 1024, 4096)
# internlm2-1.8b's projections and unembedding, the smoke model's, and the
# card tests' odd widths
SHAPES = [(2048, 2048), (2048, 1024), (2048, 8192), (8192, 2048),
          (2048, 92672), (64, 64), (64, 128), (128, 512), (256, 320),
          (512, 448)]


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("k,n", SHAPES)
def test_k_plan_does_not_depend_on_m(k, n, bf16):
    plans = [mm_ops.plan(m, k, n, bf16) for m in MS]
    assert {(p.splits, p.k_per_split) for p in plans} == {
        (mm_ops.k_splits(k, n), k // mm_ops.k_splits(k, n))}


@pytest.mark.parametrize("k,n", SHAPES)
def test_splits_tile_k_exactly(k, n):
    for m in MS:
        p = mm_ops.plan(m, k, n)
        assert p.splits * p.k_per_split == k
        assert p.k_per_split % 64 == 0 and p.k_per_split >= 64
        assert p.splits == 1 or p.k_per_split >= 4 * 64


@pytest.mark.parametrize("m", MS)
def test_tiles_and_where_the_splits_run(m):
    """bf16: 16 x 64 tiles with the splits on separate blocks up to
    M=128 (decode and short prefill waves: the weight stream spread over
    the SMs), then 128 x 128 tiles, one block walking all of K (no
    (splits, M, N) scratch). f32 (the SIMT kernel): 8- or 32-row tiles,
    splits always on separate blocks."""
    p = mm_ops.plan(m, 2048, 2048)
    assert p.splits == 8
    if m <= mm_ops.SMALL_M:
        assert (p.bm, p.bn, p.grid_splits) == (16, 64, p.splits)
    else:
        assert (p.bm, p.bn, p.grid_splits) == (128, 128, 1)
    f = mm_ops.plan(m, 2048, 2048, bf16=False)
    assert (f.bm, f.bn, f.grid_splits) == (8 if m <= 8 else 32, 64, 8)



# the expert batch (``ops.experts_plan``): every MoE arch's expert shapes
# (d_model -> d_ff and back; a tp = 2 rank holds half the experts, each
# whole, so the same shapes) at decode, short-wave and full-wave capacities
MOE_ARCHS = [a for a in list_archs() if get_config(a).n_experts]
EXPERT_C = (8, 16, 112, 128)


def _expert_shape(arch, direction):
    cfg = get_config(arch)
    return ((cfg.d_model, cfg.d_ff) if direction == "gate_up"
            else (cfg.d_ff, cfg.d_model))


def test_moe_archs_are_the_expected_ones():
    assert MOE_ARCHS == ["arctic-480b", "granite-moe-3b-a800m",
                         "jamba-v0.1-52b"]


@pytest.mark.parametrize("c", EXPERT_C)
@pytest.mark.parametrize("direction", ["gate_up", "down"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_expert_plan_keeps_the_k_plan_and_fits_a_cluster(arch, direction, c):
    """At C <= 128 bf16 rows the expert batch is one cluster launch: the K
    plan is ``k_splits(K, N)`` (so every expert's rows are
    ``msb_matmul``'s bits), the splits sit on a cluster of at most 8
    blocks, each walking ``walk`` of them, one tile holds all C rows, and
    the block's shared memory fits."""
    k, n = _expert_shape(arch, direction)
    p = mm_ops.experts_plan(c, k, n)
    assert isinstance(p, mm_ops.ExpertPlan)
    s = mm_ops.k_splits(k, n)
    assert (p.splits, p.k_per_split) == (s, k // s)
    assert p.cluster <= 8 and p.cluster * p.walk == p.splits
    assert p.walk == 1      # these shapes have at most 8 splits
    assert p.bm >= c and p.bm - c < 64 and n % p.bn == 0
    bm, bn, _, stages, persist = next(t for t in mm_ops.EXPERT_TILES
                                      if t[:2] == (p.bm, p.bn))
    assert p.persist == persist == (c <= 64)
    assert p.smem == mm_ops.experts_smem(bm, bn, stages, p.walk,
                                         persist) <= 232448


@pytest.mark.parametrize("c", EXPERT_C)
def test_expert_plan_walks_splits_past_the_cluster(c):
    """A narrow shape (K=8192, N=64: 32 splits): clusters of 8 blocks,
    each walking 4 consecutive splits and keeping their sums apart, still
    within a block's shared memory at every C."""
    p = mm_ops.experts_plan(c, 8192, 64)
    assert (p.splits, p.cluster, p.walk, p.bn) == (32, 8, 4, 64)
    assert p.smem <= 232448


@pytest.mark.parametrize("direction", ["gate_up", "down"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_expert_plan_past_128_rows_takes_the_large_tile(arch, direction):
    """Past 128 rows an expert (a static prefill) the batch runs
    ``msb_matmul``'s 128 x 128 tile walking all of K, and f32 x the SIMT
    kernel: ``plan``'s launch for one expert."""
    k, n = _expert_shape(arch, direction)
    for c in (129, 320, 1024):
        p = mm_ops.experts_plan(c, k, n)
        assert p == mm_ops.plan(c, k, n)
        assert (p.bm, p.bn, p.grid_splits) == (128, 128, 1)
    assert mm_ops.experts_plan(8, k, n, bf16=False) == \
        mm_ops.plan(8, k, n, bf16=False)
