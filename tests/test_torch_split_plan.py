"""Kernel C's split-KV plan and its merge of partials, on the CPU.

The kernel (``csrc/paged_attention.cu``) cuts each row into splits of
``PAGES_PER_SPLIT`` pages; its grid gives a row ``ops.n_splits(width)``
blocks, and block z walks splits z, z + n_splits, ... in order. It merges
the blocks' partials (running max, sum, unnormalised accumulator) by the
log-sum-exp rule. The kernel runs only on the card, where
``tests/test_torch_cuda.py`` holds it against its plain version at lengths
on the split edges and past ``SPLIT_BLOCKS`` splits. Here ``block_pages``
and ``merge_blocks`` are oracles of that plan and merge in plain Python:
the wrapper's grid size with the kernel's mapping covers every page of
every row exactly once, and the merged partials equal the plain version
of the kernel and the JAX package's oracle. With a sliding window, a
row's walk starts on the page that holds its first visible position
``kv_start`` and its splits are counted from there: the window cases hold
that plan (every page from the window's first page covered once, no split
before it) and its merge against the plain versions and the reference's
windowed attention. fp32 throughout; inputs from numpy seeds.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention.ref import \
    paged_attention_decode_quant_ref as j_paq_ref
from repro.models import attention as j_attn
from repro_torch.configs import archs, smoke_config
from repro_torch.core.quantize import kv_quantize_pages
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.paged_attention import ref as pa_ref

PS, KV, H, D = 4, 2, 4, 16
PPS = pa_ops.PAGES_PER_SPLIT
NB = pa_ops.SPLIT_BLOCKS
SPLIT = PPS * PS                    # tokens a split covers
MAX_PAGES = (NB + 2) * PPS + 3      # past the most blocks a row gets
# 0, 1, ps-1, ps, a split's edges, several splits, NB splits and one more
# (block 0 walks two), the whole table
LENS = [0, 1, PS - 1, PS, SPLIT - 1, SPLIT, SPLIT + 1, 2 * SPLIT - PS,
        2 * SPLIT, 2 * SPLIT + 3, NB * SPLIT, NB * SPLIT + 1,
        MAX_PAGES * PS]


def block_pages(kv_len, page_size, blocks, pages_per_split=PPS, kv_start=0):
    """The pages each of a row's ``blocks`` blocks walks, in order, as
    kernel C maps them: block z takes splits z, z + blocks, ... of the
    row's pages from ``kv_start``'s page below ``ceil(kv_len /
    page_size)``, splits counted from that first page; a block whose first
    split starts past them is empty, and so is every block of a row that
    sees no key (``kv_start >= kv_len``)."""
    first = int(kv_start) // page_size
    n = -(-int(kv_len) // page_size) - first
    if kv_start >= kv_len:
        n = 0
    return [[first + j for s in range(z, -(-n // pages_per_split), blocks)
             for j in range(s * pages_per_split,
                            min((s + 1) * pages_per_split, n))]
            for z in range(blocks)]


def combine_n_own(kv_len, kv_start, page_size, blocks,
                  pages_per_split=PPS):
    """The blocks the combine kernel merges: the walk's splits from the
    window's first page, at most the grid, none for a row with no key."""
    if kv_start >= kv_len:
        return 0
    span = pages_per_split * page_size
    length = kv_len - (kv_start - kv_start % page_size)
    return min(-(-length // span), blocks)


def merge_blocks(part_m, part_l, part_acc, n_own):
    """The combine kernel in plain torch: merge one row's per-block
    partials (running max ``part_m`` and sum ``part_l`` (S,), unnormalised
    accumulator ``part_acc`` (S, d), f32) over its first ``n_own`` blocks
    by the log-sum-exp rule, in block order, and normalise. Returns (d,)
    f32; 0 when the row has no block."""
    if n_own == 0:
        return torch.zeros(part_acc.shape[-1], dtype=torch.float32)
    m, lv, acc = part_m[:n_own], part_l[:n_own], part_acc[:n_own]
    f = torch.exp(m - torch.amax(m))
    l = torch.zeros((), dtype=torch.float32)
    out = torch.zeros(acc.shape[-1], dtype=torch.float32)
    for s in range(n_own):
        l = l + f[s] * lv[s]
        out = out + f[s] * acc[s]
    return out / torch.clamp(l, min=1e-30)


@pytest.mark.parametrize("max_pages", [1, PPS - 1, PPS, PPS + 1, 3 * PPS,
                                       NB * PPS, MAX_PAGES])
def test_split_plan_covers_every_page_once(max_pages):
    """Every page below ceil(kv_len / ps) lies in exactly one block, in
    order within the block; blocks past the row's pages are empty; split
    boundaries are multiples of PAGES_PER_SPLIT; the grid never exceeds
    SPLIT_BLOCKS, whatever the table's width."""
    ns = pa_ops.n_splits(max_pages)
    assert ns == min(-(-max_pages // PPS), NB)
    for kv_len in range(0, max_pages * PS + 1):
        plan = block_pages(kv_len, PS, ns)
        used = -(-kv_len // PS)
        assert sorted(j for pages in plan for j in pages) == \
            list(range(used))
        for z, pages in enumerate(plan):
            assert pages == sorted(pages)
            assert all(j // PPS % ns == z for j in pages)
            assert (not pages) == (z * PPS >= used)


def test_split_plan_does_not_depend_on_the_batch():
    """A row's blocks are the same in a grid sized for a longer row."""
    for kv_len in LENS:
        own = block_pages(kv_len, PS, pa_ops.n_splits(-(-kv_len // PS)))
        wide = block_pages(kv_len, PS, pa_ops.n_splits(4 * MAX_PAGES))
        assert wide[:len(own)] == own
        assert not any(wide[len(own):])


def _pools(rng, bits, n_pages, n_hot):
    out = []
    for _ in ("k", "v"):
        full = rng.standard_normal((n_pages, PS, KV, D)).astype(np.float32)
        out += list(kv_quantize_pages(torch.from_numpy(full), bits))
    for _ in ("k", "v"):
        out.append(torch.from_numpy(
            rng.standard_normal((n_hot, PS, KV, D)).astype(np.float32)))
    return out


def _block_partials(q, k, v, kv_len, plan, scale, softcap, kv_start=0):
    """Per-block (m, l, acc) of one row over gathered K/V (S, KV, D), the
    kernel's partials over the visible positions ``kv_start <= t <
    kv_len`` of its pages: scores in f32, then the scale and softcap; m
    the block's max, p = exp(s - m), l = sum p, acc = p @ V."""
    rep = H // KV
    ns = len(plan)
    m = torch.full((H, ns), -float("inf"))
    l = torch.zeros((H, ns))
    acc = torch.zeros((H, ns, D))
    for s, pages in enumerate(plan):
        tok = [t for j in pages for t in range(max(j * PS, kv_start),
                                                min((j + 1) * PS, kv_len))]
        if not tok:
            continue
        kk = k[tok].repeat_interleave(rep, dim=1)        # (n, H, D)
        vv = v[tok].repeat_interleave(rep, dim=1)
        sc = torch.einsum("hd,nhd->hn", q, kk) * scale
        if softcap > 0:
            sc = softcap * torch.tanh(sc / softcap)
        mx = sc.amax(dim=-1)
        p = torch.exp(sc - mx[:, None])
        m[:, s], l[:, s] = mx, p.sum(dim=-1)
        acc[:, s] = torch.einsum("hn,nhd->hd", p, vv)
    return m, l, acc


@pytest.mark.parametrize("softcap,scale", [(0.0, None), (30.0, 0.3)])
@pytest.mark.parametrize("frontier", ["decode", "packed"])
@pytest.mark.parametrize("bits", [8, 4])
def test_merged_partials_equal_plain_and_oracle(bits, frontier, softcap,
                                                scale):
    """Partials of each block merged by ``merge_blocks`` (the combine
    kernel's log-sum-exp rule in block order) equal the plain version of
    kernel C within 1e-6 and, in decode, the JAX oracle within 1e-5;
    zero-length rows exactly 0. ``packed``: packed prefill's inputs, where
    a token's causal bound lies before its segment's frontier page
    (``n_full`` past ``kv_len // ps``), and rows whose frontier lies before
    their bound (``n_full < kv_len // ps``)."""
    rng = np.random.default_rng(40 + bits + (frontier == "packed"))
    n_pages = 1 + len(LENS) * MAX_PAGES
    kc, ks, vc, vs, kh, vh = _pools(rng, bits, n_pages, len(LENS) + 1)
    bt = torch.from_numpy((1 + rng.permutation(n_pages - 1)[
        :len(LENS) * MAX_PAGES]).reshape(len(LENS), MAX_PAGES).astype(
            np.int32))
    kv_lens = torch.tensor(LENS, dtype=torch.int32)
    n_full = kv_lens // PS
    if frontier == "packed":
        n_full = torch.tensor([min(n + 2, MAX_PAGES - 1) if i % 2 else
                               max(n - 2, 0) for i, n in enumerate(
                                   n_full.tolist())], dtype=torch.int32)
    hot_rows = torch.arange(1, len(LENS) + 1, dtype=torch.int32)
    q = torch.from_numpy(rng.standard_normal((len(LENS), H, D)).astype(
        np.float32))
    sc = scale if scale is not None else D ** -0.5
    k = pa_ref.quant_gather(kc, ks, kh, bt, n_full, hot_rows, bits)
    v = pa_ref.quant_gather(vc, vs, vh, bt, n_full, hot_rows, bits)
    ns = pa_ops.n_splits(MAX_PAGES)
    out = torch.zeros((len(LENS), H, D))
    for b, kv_len in enumerate(LENS):
        plan = block_pages(kv_len, PS, ns)
        m, l, acc = _block_partials(q[b], k[b], v[b], kv_len, plan, sc,
                                    softcap)
        n_own = sum(bool(pages) for pages in plan)
        for h in range(H):
            out[b, h] = merge_blocks(m[h], l[h], acc[h], n_own)
    plain = pa_ref.paged_attention_decode_quant_ref(
        q, kc, ks, vc, vs, kh, vh, bt, kv_lens, hot_rows, kv_bits=bits,
        n_full=n_full, softcap=softcap, scale=scale)
    torch.testing.assert_close(out, plain, rtol=0, atol=1e-6)
    assert (out[0] == 0).all()
    if frontier == "packed":      # the oracle takes no separate frontier
        return
    oracle = j_paq_ref(
        *(jnp.asarray(t.numpy()) for t in (q, kc, ks.float(), vc, vs.float(),
                                          kh, vh, bt, kv_lens, hot_rows)),
        kv_bits=bits, softcap=softcap, scale=scale)
    live = kv_lens > 0        # the oracle returns the mean of V for pad rows
    np.testing.assert_allclose(out[live].numpy(),
                               np.asarray(oracle)[live.numpy()], rtol=0,
                               atol=1e-5)


def test_merge_of_no_split_is_exactly_zero():
    m = torch.full((3,), -float("inf"))
    out = merge_blocks(m, torch.zeros(3), torch.zeros(3, D), 0)
    assert out.shape == (D,) and (out == 0).all()


@pytest.mark.parametrize("kv_bits", [16, 8, 4])
def test_lane_slices_take_every_attention_head_dim(kv_bits):
    """Kernels B (kv16) and C share the walk's head_dim rule, a power of
    two in [16, 512] (to 1024 at 4 bits): every registered arch with
    KV-cache attention, and every smoke config, passes it; xlstm's 192
    (its mLSTM heads, no KV cache) and other widths raise."""
    served = [c for c in archs.ALL if c.layer_pattern != "xlstm"]
    for cfg in served + [smoke_config(c.name) for c in served]:
        e = pa_ops.lane_elems(kv_bits, cfg.head_dim_)
        assert cfg.head_dim_ % e == 0 and (cfg.head_dim_ // e) <= 32
    for d in (8, 24, 48, 192) + ((1024,) if kv_bits != 4 else (2048,)):
        with pytest.raises(ValueError, match="head_dim"):
            pa_ops.lane_elems(kv_bits, d)


WINDOWS = [1, 3, PS, 6, SPLIT + 3, 2 * SPLIT]


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("max_pages", [PPS + 1, NB * PPS, MAX_PAGES])
def test_window_split_plan_covers_pages_once_from_the_window(max_pages,
                                                              window):
    """A decode row at ``kv_len`` with a window starts at ``kv_start =
    max(0, kv_len - window)``: every page from ``kv_start``'s page below
    ceil(kv_len / ps) lies in exactly one block, in order; no block holds
    a page before the window's first; the non-empty blocks are the first
    ones and the combine merges exactly them. Without a window (window
    past the row) the plan is the one without ``kv_start``."""
    ns = pa_ops.n_splits(max_pages)
    for kv_len in range(0, max_pages * PS + 1):
        start = max(0, kv_len - window)
        plan = block_pages(kv_len, PS, ns, kv_start=start)
        first, used = start // PS, -(-kv_len // PS)
        want = list(range(first, used)) if kv_len else []
        assert sorted(j for pages in plan for j in pages) == want
        assert all(pages == sorted(pages) and all(j >= first for j in pages)
                   for pages in plan)
        n_own = sum(bool(pages) for pages in plan)
        assert all(plan[:n_own]) and not any(plan[n_own:])
        assert n_own == combine_n_own(kv_len, start, PS, ns)
        if start == 0:
            assert plan == block_pages(kv_len, PS, ns)


@pytest.mark.parametrize("window", [6, SPLIT + 3, 2 * SPLIT])
@pytest.mark.parametrize("bits", [16, 8, 4])
def test_window_merged_partials_equal_plain_and_oracle(bits, window):
    """Decode rows with a window (not a multiple of the page size, or
    whole splits): each block's partials over its visible positions,
    merged by ``merge_blocks`` over ``combine_n_own`` blocks, equal the
    plain version of kernel B (kv16) or C given ``kv_start`` within 1e-6,
    and the reference's windowed attention (``repro.models.attention.
    paged_attention`` / ``paged_attention_quant``) within 1e-5; pad rows
    exactly 0. Window starts fall mid-page on most rows."""
    rng = np.random.default_rng(70 + bits + window)
    n_pages = 1 + len(LENS) * MAX_PAGES
    n_rows = len(LENS)
    bt = torch.from_numpy((1 + rng.permutation(n_pages - 1)[
        :n_rows * MAX_PAGES]).reshape(n_rows, MAX_PAGES).astype(np.int32))
    kv_lens = torch.tensor(LENS, dtype=torch.int32)
    starts = torch.clamp(kv_lens - window, min=0)
    q = torch.from_numpy(rng.standard_normal((n_rows, H, D)).astype(
        np.float32))
    if bits == 16:
        k_pool, v_pool = (torch.from_numpy(rng.standard_normal(
            (n_pages, PS, KV, D)).astype(np.float32)) for _ in "kv")
        k = k_pool[bt.long()].reshape(n_rows, -1, KV, D)
        v = v_pool[bt.long()].reshape(n_rows, -1, KV, D)
        plain = pa_ref.paged_attention_decode_ref(q, k_pool, v_pool, bt,
                                                  kv_lens, kv_start=starts)
        oracle = j_attn.paged_attention(
            *(jnp.asarray(t.numpy()) for t in (q[:, None], k_pool, v_pool,
                                               bt, (kv_lens - 1)[:, None],
                                               kv_lens)), window=window)
    else:
        kc, ks, vc, vs, kh, vh = _pools(rng, bits, n_pages, n_rows + 1)
        hot_rows = torch.arange(1, n_rows + 1, dtype=torch.int32)
        n_full = kv_lens // PS
        k = pa_ref.quant_gather(kc, ks, kh, bt, n_full, hot_rows, bits)
        v = pa_ref.quant_gather(vc, vs, vh, bt, n_full, hot_rows, bits)
        plain = pa_ref.paged_attention_decode_quant_ref(
            q, kc, ks, vc, vs, kh, vh, bt, kv_lens, hot_rows, kv_bits=bits,
            kv_start=starts)
        cache = {name: jnp.asarray(t.float().numpy() if t.dtype ==
                                   torch.bfloat16 else t.numpy())
                 for name, t in (("k_codes", kc), ("k_scales", ks),
                                 ("v_codes", vc), ("v_scales", vs),
                                 ("k_hot", kh), ("v_hot", vh))}
        oracle = j_attn.paged_attention_quant(
            jnp.asarray(q[:, None].numpy()), cache, jnp.asarray(bt.numpy()),
            jnp.asarray((kv_lens - 1)[:, None].numpy()),
            jnp.asarray(kv_lens.numpy()),
            jnp.asarray((hot_rows - 1).numpy()), bits, window=window)
    ns = pa_ops.n_splits(MAX_PAGES)
    out = torch.zeros((n_rows, H, D))
    for b, kv_len in enumerate(LENS):
        start = int(starts[b])
        plan = block_pages(kv_len, PS, ns, kv_start=start)
        m, l, acc = _block_partials(q[b], k[b], v[b], kv_len, plan,
                                    D ** -0.5, 0.0, kv_start=start)
        n_own = combine_n_own(kv_len, start, PS, ns)
        assert torch.isfinite(m[:, :n_own]).all()   # no partial max is -inf
        for h in range(H):
            out[b, h] = merge_blocks(m[h], l[h], acc[h], n_own)
    torch.testing.assert_close(out, plain, rtol=0, atol=1e-6)
    assert (out[0] == 0).all()
    live = kv_lens > 0
    np.testing.assert_allclose(out[live].numpy(),
                               np.asarray(oracle)[:, 0][live.numpy()],
                               rtol=0, atol=1e-5)
