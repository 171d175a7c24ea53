"""Kernel A's launch plan (``ops.plan``) on the CPU.

The kernel (``csrc/msb_matmul.cu``) sums an output element split by split:
each split's k16 steps in ascending order into a zeroed accumulator, the
splits in ascending order into a running f32 total from 0, then the bias.
Its tile may depend on M; where the splits run (on separate blocks, summed
by a second pass, or inside one block) may too. The K plan may not: that
is what makes an output row's bits the same at every M, which
``tests/test_torch_cuda.py`` checks bit for bit on the card. Here the plan
is checked for every M the main path and the tests use.
"""
import pytest

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

