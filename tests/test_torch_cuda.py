"""The port's hand-written kernels against their plain versions on the
card, and the continuous engine's dispatch graphs (serve/graphs.py) against
the same dispatches run eagerly. Marked ``cuda``: they skip where there is
no CUDA device. This file imports no JAX, so it also runs where only the
port is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.core import QuantPolicy, quantize_params
from repro_torch.core.quantize import (KVQuantSpec, PackedQTensor,
                                       kv_quantize_pages)
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.msb_matmul import ops as mm_ops
from repro_torch.kernels.msb_matmul import ref as mm_ref
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.paged_attention import ref as pa_ref
from repro_torch.models import Model
from repro_torch.serve import ContinuousEngine, jit_trace_count
from repro_torch.serve.graphs import pad_inputs


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _weights(rng, k, n, kblocked, device):
    packed = rng.integers(0, 256, (k, n // 2)).astype(np.uint8)
    shape = (k // 64, n, 8) if kblocked else (k, n // 64, 8)
    scales = np.sort(rng.random(shape).astype(np.float32) * 0.1, axis=-1)
    return (torch.from_numpy(packed).to(device),
            torch.from_numpy(scales).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("kblocked", [False, True])
def test_msb_matmul_kernel_matches_plain(cuda, kblocked):
    rng = np.random.default_rng(11)
    p, s = _weights(rng, 256, 320, kblocked, cuda)
    bias = torch.from_numpy(rng.standard_normal(320).astype(np.float32)).to(
        cuda)
    for m in (1, 3, 8, 40):
        x = torch.from_numpy(rng.standard_normal((m, 256)).astype(
            np.float32)).to(cuda)
        for b in (None, bias):
            y = mm_ops.msb_matmul(x, p, s, b, kblocked=kblocked)
            y_ref = mm_ref.msb_matmul_ref(x, p, s, b, kblocked=kblocked)
            torch.testing.assert_close(y, y_ref, rtol=0,
                                       atol=1e-5 * y_ref.abs().max().item())


@pytest.mark.cuda
def test_msb_matmul_rows_do_not_depend_on_batch(cuda):
    """An output row's reduction order is the same at every M, so decode
    buckets give bit-identical rows (bf16, as the model runs it)."""
    rng = np.random.default_rng(13)
    p, s = _weights(rng, 2048, 1024, False, cuda)
    x = torch.from_numpy(rng.standard_normal((8, 2048)).astype(
        np.float32)).to(cuda).to(torch.bfloat16)
    y8 = mm_ops.msb_matmul(x, p, s)
    for m in (1, 2, 4):
        assert torch.equal(mm_ops.msb_matmul(x[:m].contiguous(), p, s), y8[:m])


M_ALL = (1, 2, 4, 8, 16, 17, 64, 512, 4096)


@pytest.mark.cuda
@pytest.mark.parametrize("kblocked", [False, True])
@pytest.mark.parametrize("k,n", [(2048, 1024), (8192, 2048), (256, 320)])
def test_msb_matmul_rows_do_not_depend_on_m(cuda, k, n, kblocked):
    """bf16 on the tensor cores: every row of an M=4096 product is
    bit-identical to the same row computed at M = 1 ... 512, through both
    tiles of the launch plan (16-row tiles with K splits on separate
    blocks, 128-row tiles walking all of K), with and without bias. N=320
    is not a multiple of the 128-column tile."""
    rng = np.random.default_rng(40 + k + kblocked)
    p, s = _weights(rng, k, n, kblocked, cuda)
    bias = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(
        cuda)
    x = torch.from_numpy(rng.standard_normal((4096, k)).astype(
        np.float32)).to(cuda).to(torch.bfloat16)
    assert len({mm_ops.plan(m, k, n).bm for m in M_ALL}) == 2
    for b in (None, bias):
        y = mm_ops.msb_matmul(x, p, s, b, kblocked=kblocked)
        for m in M_ALL[:-1]:
            ym = mm_ops.msb_matmul(x[-m:].contiguous(), p, s, b,
                                   kblocked=kblocked)
            assert torch.equal(ym, y[-m:]), f"M={m}"


@pytest.mark.cuda
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("kblocked", [False, True])
@pytest.mark.parametrize("m", [1, 8, 17, 130, 600, 4096])
def test_msb_matmul_tensor_cores_match_plain(cuda, m, kblocked, bias):
    """bf16 x against the plain version at M up to 4096, n- and k-blocked,
    with and without bias; N=448 leaves a half tile at the edge of the
    128-column tiles. Tolerance 1e-2 * max|ref|: the same bf16 weights and
    products, f32 sums in another order, bf16 output."""
    rng = np.random.default_rng(50 + m + 2 * kblocked + bias)
    k, n = 512, 448
    p, s = _weights(rng, k, n, kblocked, cuda)
    b = (torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(cuda)
         if bias else None)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(
        cuda).to(torch.bfloat16)
    before = mm_ops.msb_matmul.launches
    y = mm_ops.msb_matmul(x, p, s, b, kblocked=kblocked)
    assert mm_ops.msb_matmul.launches == before + 1
    y_ref = mm_ref.msb_matmul_ref(x, p, s, b, kblocked=kblocked)
    assert y.dtype == torch.bfloat16 and y.shape == (m, n)
    torch.testing.assert_close(y.float(), y_ref.float(), rtol=0,
                               atol=1e-2 * y_ref.float().abs().max().item())


def _unembed_table(rng, v, d, kblocked, dtype, device):
    """Random codes and sorted codebooks of a (V, D) unembedding table in
    storage layout: tied (V, D/2) n-blocked, or k-blocked (D, V/2)."""
    if kblocked:
        packed = rng.integers(0, 256, (d, v // 2)).astype(np.uint8)
        scales = rng.random((d // 64, v, 8)).astype(np.float32)
    else:
        packed = rng.integers(0, 256, (v, d // 2)).astype(np.uint8)
        scales = rng.random((v, d // 64, 8)).astype(np.float32)
    scales = np.sort(scales * 0.1, axis=-1)
    return PackedQTensor(torch.from_numpy(packed).to(device),
                         torch.from_numpy(scales).to(device), 4, 64, dtype,
                         v if kblocked else d, kblocked=kblocked)


UNEMBED_TABLES = {  # name: (V, D, kblocked, table dtype)
    "kblocked": (4160, 512, True, torch.float32),      # 2 K slices
    "tied_f32": (4100, 512, False, torch.float32),     # 256.25 row strips
    "tied_bf16": (1000, 2304, False, torch.bfloat16),  # gemma2's width,
}                                                      # 4 slices of 9


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(UNEMBED_TABLES))
def test_unembed_kernel_matches_plain_and_rows_do_not_depend_on_m(cuda,
                                                                  name):
    """The unembedding's kernel against its plain version (1e-5 of the
    largest logit: f32 products summed in another order) at M = 1, 2, 3,
    4, 8, 17 and 64 (every row tile: 1, 2, 4, 8), both layouts, the tied
    one with f32 and bf16 codebooks; every row bit-identical to the same
    row at M=64."""
    v, d, kb, dtype = UNEMBED_TABLES[name]
    rng = np.random.default_rng(v)
    pq = _unembed_table(rng, v, d, kb, dtype, cuda)
    x = torch.from_numpy(rng.standard_normal((64, d)).astype(
        np.float32)).to(cuda)
    full = mm_ops.msb_unembed(x, pq)
    for m in (1, 2, 3, 4, 8, 17, 64):
        before = mm_ops.msb_unembed.launches
        y = mm_ops.msb_unembed(x[:m], pq)
        assert mm_ops.msb_unembed.launches == before + 1
        want = mm_ref.msb_unembed_ref(x[:m], pq)
        assert y.shape == want.shape == (m, v)
        torch.testing.assert_close(y, want, rtol=0,
                                   atol=1e-5 * want.abs().max().item())
        assert torch.equal(y, full[:m]), f"rows at M={m} differ from M=64"


@pytest.mark.cuda
def test_unembed_kernel_in_a_captured_graph(cuda):
    """The entry launches inside a CUDA graph (no host sync, outputs from
    the graph's pool); a replay on new inputs gives the eager launch's
    bits."""
    rng = np.random.default_rng(5)
    pq = _unembed_table(rng, 1000, 2304, False, torch.bfloat16, cuda)

    def hidden():
        return torch.from_numpy(rng.standard_normal((8, 2304)).astype(
            np.float32)).to(cuda)

    x = hidden()
    eager = mm_ops.msb_unembed(x, pq)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = mm_ops.msb_unembed(x, pq)
    x.copy_(hidden())
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, mm_ops.msb_unembed(x, pq))
    assert not torch.equal(out, eager)


@pytest.mark.cuda
def test_paged_attention_kernel_matches_plain(cuda):
    rng = np.random.default_rng(12)
    lens = [1, 7, 0, 24, 13]
    kp = rng.standard_normal((24, 4, 2, 16)).astype(np.float32)
    vp = rng.standard_normal((24, 4, 2, 16)).astype(np.float32)
    bt = np.stack([rng.permutation(np.arange(1, 24))[:6]
                   for _ in lens]).astype(np.int32)
    q = rng.standard_normal((len(lens), 4, 16)).astype(np.float32)
    args = [torch.from_numpy(a).to(cuda)
            for a in (q, kp, vp, bt, np.asarray(lens, np.int32))]
    for softcap, scale in ((0.0, None), (30.0, 0.3)):
        out = pa_ops.paged_attention_decode(*args, softcap=softcap,
                                            scale=scale)
        ref = pa_ref.paged_attention_decode_ref(*args, softcap=softcap,
                                                scale=scale)
        torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)
        assert (out[2] == 0).all()


def _kv16_case(rng, dtype, lens, device, ps=16, kv=8, h=16, d=128,
               width=None):
    """Random full-width kv16 pools and a batch of rows with ``lens``
    keys, each on its own pages; block tables ``width`` pages wide
    (default: enough for the longest row)."""
    width = width or max(1, -(-max(lens) // ps))
    n_pages = 1 + len(lens) * width
    kp, vp = (torch.from_numpy(rng.standard_normal(
        (n_pages, ps, kv, d)).astype(np.float32)).to(device=device,
                                                     dtype=dtype)
        for _ in "kv")
    bt = (1 + rng.permutation(n_pages - 1)).reshape(len(lens), width)
    q = torch.from_numpy(rng.standard_normal((len(lens), h, d)).astype(
        np.float32)).to(device=device, dtype=dtype)
    ints = [torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(
        device) for a in (bt, lens)]
    return q, kp, vp, ints[0], ints[1]


@pytest.mark.cuda
@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_rows_do_not_depend_on_batch(cuda, dtype, softcap):
    """Kernel B on the split walk: a row run alone (with a block table only
    as wide as it needs, so a smaller grid) gives the same bits as inside a
    batch of mixed lengths up to past 16 splits (4100 keys), and the batch
    agrees with the plain version (1e-5 in f32, f32 sums in another order;
    2e-2 in bf16, bf16 outputs). Zero-length rows are exactly 0."""
    rng = np.random.default_rng(60 + int(softcap))
    lens = [0, 1, 15, 16, 17, 300, 2048, 4100]
    q, kp, vp, bt, kv_lens = _kv16_case(rng, dtype, lens, cuda)
    before = pa_ops.paged_attention_decode.launches
    out = pa_ops.paged_attention_decode(q, kp, vp, bt, kv_lens,
                                        softcap=softcap)
    assert pa_ops.paged_attention_decode.launches == before + 1
    ref = pa_ref.paged_attention_decode_ref(q, kp, vp, bt, kv_lens,
                                            softcap=softcap)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=tol)
    assert (out[0] == 0).all()
    for i, n in enumerate(lens):
        width = max(1, -(-n // 16))
        alone = pa_ops.paged_attention_decode(
            q[i:i + 1].contiguous(), kp, vp, bt[i:i + 1, :width].contiguous(),
            kv_lens[i:i + 1].contiguous(), softcap=softcap)
        assert torch.equal(alone[0], out[i]), f"row of {n} keys"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_split_edges(cuda, dtype):
    """Kernel B at lengths on and around the split edges (128 keys a split
    at page size 16), across several splits and past SPLIT_BLOCKS splits
    (a block walks two or three), with scale and softcap, against the
    plain version."""
    rng = np.random.default_rng(62)
    edge = pa_ops.PAGES_PER_SPLIT * 16
    nb = pa_ops.SPLIT_BLOCKS
    lens = [edge - 1, edge, edge + 1, 2 * edge, 2 * edge + 16, 3 * edge - 1,
            5 * edge + 7, 1, nb * edge, nb * edge + 1, 2 * nb * edge + 5]
    args = _kv16_case(rng, dtype, lens, cuda)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for softcap, scale in ((0.0, None), (30.0, 0.3)):
        out = pa_ops.paged_attention_decode(*args, softcap=softcap,
                                            scale=scale)
        ref = pa_ref.paged_attention_decode_ref(*args, softcap=softcap,
                                                scale=scale)
        torch.testing.assert_close(out.float(), ref.float(), rtol=0,
                                   atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_packed_prefill_causal_bounds(cuda, dtype):
    """Kernel B as kv16 packed prefill launches it: one row per prompt
    token, its segment's block-table row, kv_len = min(q_pos + 1, kv_len).
    Agrees with the plain version, and new keys and values past a row's
    causal bound (the rest of its segment) leave the row's bits as they
    were."""
    rng = np.random.default_rng(63)
    ps, width = 16, 64
    chunks = [(0, 128), (256, 384), (0, 256)]
    seg = np.concatenate([np.full(e - s0, i) for i, (s0, e) in
                          enumerate(chunks)])
    pos = np.concatenate([np.arange(s0, e) for s0, e in chunks])
    q, kp, vp, bt, _ = _kv16_case(rng, dtype, [e for _, e in chunks], cuda,
                                  width=width)
    q = torch.from_numpy(rng.standard_normal((len(pos), 16, 128)).astype(
        np.float32)).to(device=cuda, dtype=dtype)
    ends = np.array([e for _, e in chunks])[seg]
    bound = np.minimum(pos + 1, ends).astype(np.int32)
    rows = bt[torch.from_numpy(seg).to(cuda)].contiguous()
    kv_lens = torch.from_numpy(bound).to(cuda)
    out = pa_ops.paged_attention_decode(q, kp, vp, rows, kv_lens)
    ref = pa_ref.paged_attention_decode_ref(q, kp, vp, rows, kv_lens)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=tol)
    # rewrite every position of segment 1 past 300 (its bound rows 256-299
    # must not move; rows 300-383 see the new keys)
    s1 = bt[1].long()
    kp2, vp2 = kp.clone(), vp.clone()
    tail = torch.arange(300, 384, device=cuda)
    kp2[s1[tail // ps], tail % ps] = 7.0
    vp2[s1[tail // ps], tail % ps] = -7.0
    out2 = pa_ops.paged_attention_decode(q, kp2, vp2, rows, kv_lens)
    keep = torch.from_numpy(~((seg == 1) & (pos >= 300))).to(cuda)
    assert torch.equal(out2[keep], out[keep])
    assert not torch.equal(out2[~keep], out[~keep])


def _quant_pools(rng, bits, n_pages, n_hot, ps, kv, d, dtype, device):
    """Codes/scales of random pages (quantized on the CPU) and random hot
    rows, on ``device``; hot rows in ``dtype``."""
    out = []
    for _ in ("k", "v"):
        full = rng.standard_normal((n_pages, ps, kv, d)).astype(np.float32)
        codes, scales = kv_quantize_pages(torch.from_numpy(full), bits)
        out += [codes.to(device), scales.to(device)]
    for _ in ("k", "v"):
        hot = rng.standard_normal((n_hot, ps, kv, d)).astype(np.float32)
        out.append(torch.from_numpy(hot).to(device=device, dtype=dtype))
    kc, ks, vc, vs, kh, vh = out
    return kc, ks, vc, vs, kh, vh


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_quant_kernel_matches_plain(cuda, bits, dtype):
    """Kernel C against its plain version: committed pages from codes,
    frontier page from the hot row, zero-length and pad rows, softcap, and
    rows whose frontier lies past their causal bound (packed prefill).
    Tolerance: 1e-5 in f32 (same dequantized values, f32 sums in another
    order); 2e-2 in bf16 (the plain version rounds p to bf16 before P@V,
    the kernel keeps it in f32, as kernel B does)."""
    rng = np.random.default_rng(14 + bits)
    ps, kv, h, d, mp = 4, 2, 4, 16, 6
    lens = [1, 7, 0, 24, 13, 8, 5]
    n_full = [0, 1, 0, 6, 3, 2, 5]      # row 6: frontier past its bound
    hot_rows = [1, 2, 0, 3, 4, 5, 6]
    pools = _quant_pools(rng, bits, 48, 8, ps, kv, d, dtype, cuda)
    bt = np.stack([rng.permutation(np.arange(1, 48))[:mp]
                   for _ in lens]).astype(np.int32)
    q = torch.from_numpy(rng.standard_normal((len(lens), h, d)).astype(
        np.float32)).to(device=cuda, dtype=dtype)
    ints = [torch.tensor(a, dtype=torch.int32, device=cuda)
            for a in (bt, lens, hot_rows, n_full)]
    args = (q, *pools, ints[0], ints[1], ints[2])
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for softcap, scale in ((0.0, None), (30.0, 0.3)):
        before = pa_ops.paged_attention_decode_quant.launches
        out = pa_ops.paged_attention_decode_quant(
            *args, kv_bits=bits, n_full=ints[3], softcap=softcap,
            scale=scale)
        assert pa_ops.paged_attention_decode_quant.launches == before + 1
        ref = pa_ref.paged_attention_decode_quant_ref(
            *args, kv_bits=bits, n_full=ints[3], softcap=softcap,
            scale=scale)
        torch.testing.assert_close(out.float(), ref.float(), rtol=0,
                                   atol=tol)
        assert (out[2] == 0).all()
    # the default frontier is kv_lens // page_size
    out = pa_ops.paged_attention_decode_quant(*args, kv_bits=bits)
    ref = pa_ref.paged_attention_decode_quant_ref(*args, kv_bits=bits)
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=tol)


def _rand_quant_pools(rng, bits, n_pages, n_hot, ps, kv, d, dtype, device):
    """Random codes and codebooks in the layout of ``KVQuantSpec`` (int8
    codes in [-127, 127] with positive f32 absmax at 8 bits, packed
    nibbles with sorted positive bf16 codebooks at 4), made directly
    instead of quantized (the DP is slow at full width), and random hot
    rows in ``dtype``."""
    spec = KVQuantSpec(bits, ps, kv, d)
    out = []
    for _ in ("k", "v"):
        codes = rng.integers(0, 256, (n_pages,) + spec.codes_tail,
                             dtype=np.uint8)
        if bits == 8:
            codes = np.maximum(codes.view(np.int8), -127)
        sc = np.sort(rng.random((n_pages,) + spec.scales_tail,
                                dtype=np.float32) * 3, axis=-1)
        out += [torch.from_numpy(codes).to(device),
                torch.from_numpy(sc).to(device=device,
                                        dtype=spec.scale_dtype)]
    for _ in ("k", "v"):
        hot = rng.standard_normal((n_hot, ps, kv, d)).astype(np.float32)
        out.append(torch.from_numpy(hot).to(device=device, dtype=dtype))
    return out


def _quant_case(rng, bits, dtype, lens, device, ps=16, kv=8, h=16, d=128,
                n_full=None, width=None):
    """Random full-width pools and a batch of rows with ``lens`` keys, each
    on its own pages; block tables ``width`` pages wide (default: enough
    for the longest row)."""
    width = width or max(1, -(-max(lens) // ps))
    n_pages = 1 + len(lens) * width
    pools = _rand_quant_pools(rng, bits, n_pages, len(lens) + 1, ps, kv, d,
                              dtype, device)
    bt = (1 + rng.permutation(n_pages - 1)).reshape(len(lens), width)
    q = torch.from_numpy(rng.standard_normal((len(lens), h, d)).astype(
        np.float32)).to(device=device, dtype=dtype)
    kv_lens = np.asarray(lens, np.int32)
    n_full = kv_lens // ps if n_full is None else np.asarray(n_full, np.int32)
    ints = [torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(
        device) for a in (bt, kv_lens, np.arange(1, len(lens) + 1), n_full)]
    return (q, *pools, ints[0], ints[1], ints[2]), ints[3]


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_quant_rows_do_not_depend_on_batch(cuda, bits,
                                                           dtype):
    """Kernel C's split boundaries depend on the page index alone: a row run
    alone (with a block table only as wide as it needs, so a smaller grid)
    gives the same bits as inside a batch of mixed lengths, and the batch
    agrees with the plain version."""
    rng = np.random.default_rng(30 + bits)
    lens = [0, 1, 15, 16, 17, 300, 2048, 4100]
    args, n_full = _quant_case(rng, bits, dtype, lens, cuda)
    out = pa_ops.paged_attention_decode_quant(*args, kv_bits=bits,
                                              n_full=n_full)
    ref = pa_ref.paged_attention_decode_quant_ref(*args, kv_bits=bits,
                                                  n_full=n_full)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=tol)
    assert (out[0] == 0).all()
    q, kc, ks, vc, vs, kh, vh, bt, kv_lens, hot_rows = args
    for i, n in enumerate(lens):
        width = max(1, -(-n // 16))
        alone = pa_ops.paged_attention_decode_quant(
            q[i:i + 1].contiguous(), kc, ks, vc, vs, kh, vh,
            bt[i:i + 1, :width].contiguous(), kv_lens[i:i + 1].contiguous(),
            hot_rows[i:i + 1].contiguous(), kv_bits=bits,
            n_full=n_full[i:i + 1].contiguous())
        assert torch.equal(alone[0], out[i]), f"row of {n} keys"


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
def test_paged_attention_quant_split_edges(cuda, bits):
    """Lengths on and around the split edges (128 keys a split at page
    size 16), across several splits and past SPLIT_BLOCKS splits (a block
    walks two or three), against the plain version."""
    rng = np.random.default_rng(32 + bits)
    edge = pa_ops.PAGES_PER_SPLIT * 16
    nb = pa_ops.SPLIT_BLOCKS
    lens = [edge - 1, edge, edge + 1, 2 * edge, 2 * edge + 16, 3 * edge - 1,
            5 * edge + 7, 1, nb * edge, nb * edge + 1, 2 * nb * edge + 5]
    args, n_full = _quant_case(rng, bits, torch.bfloat16, lens, cuda)
    for softcap, scale in ((0.0, None), (30.0, 0.3)):
        out = pa_ops.paged_attention_decode_quant(
            *args, kv_bits=bits, n_full=n_full, softcap=softcap, scale=scale)
        ref = pa_ref.paged_attention_decode_quant_ref(
            *args, kv_bits=bits, n_full=n_full, softcap=softcap, scale=scale)
        torch.testing.assert_close(out.float(), ref.float(), rtol=0,
                                   atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_quant_packed_prefill_frontiers(cuda, bits, dtype):
    """Rows whose frontier page is not ``kv_len // ps``: past the causal
    bound (each prompt token of a packed prefill against its segment's
    frontier) and before it (``n_full < kv_len // ps``, the pages between
    read from their codes, as the plain version reads them)."""
    rng = np.random.default_rng(34 + bits)
    lens = [5, 40, 130, 300, 17, 256, 1000, 16]
    n_full = [3, 4, 10, 30, 0, 10, 61, 0]
    args, nf = _quant_case(rng, bits, dtype, lens, cuda, n_full=n_full,
                           width=64)
    out = pa_ops.paged_attention_decode_quant(*args, kv_bits=bits, n_full=nf)
    ref = pa_ref.paged_attention_decode_quant_ref(*args, kv_bits=bits,
                                                  n_full=nf)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=tol)


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    p, s = _weights(np.random.default_rng(0), 128, 128, False, cuda)
    x = torch.zeros(2, 128, device=cuda)
    with pytest.raises(TypeError):
        mm_ops.msb_matmul(x.half(), p, s)
    with pytest.raises(ValueError):
        mm_ops.msb_matmul(x, p, s.to(torch.bfloat16))
    with pytest.raises(ValueError):
        mm_ops.msb_matmul(x[:, ::2], p[:64], s[:64])
    q = torch.zeros(1, 4, 16, device=cuda)
    pool = torch.zeros(4, 4, 2, 16, device=cuda)
    bt = torch.ones(1, 2, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        pa_ops.paged_attention_decode(q, pool, pool, bt,
                                      torch.ones(1, dtype=torch.int32,
                                                 device=cuda))
    one32 = torch.ones(1, dtype=torch.int32, device=cuda)
    for d in (48, 1024):                   # B: a power of two in [16, 512]
        qd = torch.zeros(1, 4, d, device=cuda)
        pd = torch.zeros(4, 4, 2, d, device=cuda)
        with pytest.raises(ValueError, match="head_dim"):
            pa_ops.paged_attention_decode(qd, pd, pd, bt.to(torch.int32),
                                          one32)
    shifted = torch.zeros(pool.numel() + 1, device=cuda)[1:].view(pool.shape)
    with pytest.raises(ValueError, match="16-byte"):
        pa_ops.paged_attention_decode(q, shifted, pool, bt.to(torch.int32),
                                      one32)
    xb = torch.zeros(2, 128, device=cuda, dtype=torch.bfloat16)
    odd = torch.zeros(2 * 128 + 1, device=cuda,
                      dtype=torch.bfloat16)[1:].view(2, 128)
    with pytest.raises(ValueError, match="16-byte"):   # A: cp.async rows
        mm_ops.msb_matmul(odd, p, s)
    assert mm_ops.msb_matmul(xb, p, s).shape == (2, 128)
    kc, ks, vc, vs, kh, vh = _quant_pools(np.random.default_rng(0), 4, 4, 2,
                                          4, 2, 16, torch.float32, cuda)
    one = torch.ones(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):        # 4-bit pools read as 8-bit
        pa_ops.paged_attention_decode_quant(q, kc, ks, vc, vs, kh, vh,
                                            bt.to(torch.int32), one, one,
                                            kv_bits=8)
    bt32 = bt.to(torch.int32)
    for bits in (8, 4):                    # head_dim 48: 3 lanes a row
        q48 = torch.zeros(1, 4, 48, device=cuda)
        pools = _quant_pools(np.random.default_rng(1), bits, 4, 2, 4, 2, 48,
                             torch.float32, cuda)
        with pytest.raises(ValueError, match="head_dim"):
            pa_ops.paged_attention_decode_quant(q48, *pools, bt32, one, one,
                                                kv_bits=bits)
    kc, ks, vc, vs, kh, vh = _quant_pools(np.random.default_rng(2), 8, 4, 2,
                                          4, 2, 16, torch.float32, cuda)
    shifted = torch.zeros(kh.numel() + 1, device=cuda)[1:].view(kh.shape)
    with pytest.raises(ValueError, match="16-byte"):
        pa_ops.paged_attention_decode_quant(q, kc, ks, vc, vs, shifted, vh,
                                            bt32, one, one, kv_bits=8)


def _segments(b, s):
    """Three contiguous segments per row, then pad positions (-1)."""
    segs = np.full((b, s), -1, np.int32)
    for i in range(b):
        cuts = [0, 13 + 5 * i, 70 + 7 * i, s - 9 - i]
        for j in range(3):
            segs[i, cuts[j]:cuts[j + 1]] = j
    return segs


FLASH_CASES = {   # causal, window, softcap, H, KV, Sq, Skv, d
    "causal-s100-d16": (True, 0, 0.0, 4, 2, 100, 100, 16),
    "causal-rep4-s300-d128": (True, 0, 0.0, 8, 2, 300, 300, 128),
    "noncausal-s70x130-d64": (False, 0, 0.0, 4, 4, 70, 130, 64),
    "window50-softcap30-s257-d128": (True, 50, 30.0, 4, 2, 257, 257, 128),
    "causal-s64-d256": (True, 0, 0.0, 2, 1, 64, 64, 256),
    "noncausal-s100x190-d256": (False, 0, 0.0, 4, 2, 100, 190, 256),
    "window40-softcap50-s150-d64": (True, 40, 50.0, 4, 1, 150, 150, 64),
    "causal-s200x330-d128": (True, 0, 0.0, 4, 2, 200, 330, 128),
    # whisper's cross-attention: a 64-token prompt onto 1500 encoder rows,
    # the last key tile 28 rows of 64
    "noncausal-s64x1500-d64": (False, 0, 0.0, 20, 20, 64, 1500, 64),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_attention_kernel_matches_plain(cuda, case, dtype):
    """Kernel D against its plain version on the same inputs. Tolerance:
    1e-5 in f32 (f32 sums in another order); 2e-2 in bf16 (bf16 outputs,
    and a p rounded to bf16 on both sides may round the other way when the
    f32 values it came from differ in the last bit)."""
    causal, window, softcap, h, kv, sq, skv, d = FLASH_CASES[case]
    rng = np.random.default_rng(21)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(device=cuda, dtype=dtype)
        for shape in ((2, h, sq, d), (2, kv, skv, d), (2, kv, skv, d)))
    kw = dict(causal=causal, window=window, softcap=softcap)
    before = fa_ops.flash_attention_fwd.launches
    out = fa_ops.flash_attention_fwd(q, k, v, **kw)
    assert fa_ops.flash_attention_fwd.launches == before + 1
    ref = fa_ref.flash_attention_ref(q, k, v, **kw)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=tol)
    # (B, S, H, d) activations passed as head-major strided views
    qt = q.transpose(1, 2).contiguous().transpose(1, 2)
    out2 = fa_ops.flash_attention_fwd(qt, k, v, **kw)
    assert torch.equal(out2, out)


@pytest.mark.cuda
@pytest.mark.parametrize("use_kernel", [None, True])
def test_public_dispatchers_launch_the_kernels(cuda, use_kernel):
    """The reference's dispatchers on CUDA tensors: ``paged_attention``
    launches B, ``paged_attention_kv_quant`` C, ``attention`` D, one
    launch each, bitwise the direct calls; ``use_kernel=False`` raises
    ValueError and launches nothing (no plain version on the card)."""
    from repro_torch.kernels.flash_attention import attention
    from repro_torch.kernels.paged_attention import (
        paged_attention, paged_attention_kv_quant)
    rng = np.random.default_rng(26)
    dt = torch.bfloat16
    q, kp, vp, bt, lens = _kv16_case(rng, dt, [1, 40, 0, 130], cuda)
    cases = []
    cases.append((pa_ops.paged_attention_decode,
                  lambda **f: paged_attention(q, kp, vp, bt, lens, **f),
                  lambda: pa_ops.paged_attention_decode(q, kp, vp, bt,
                                                        lens)))
    for bits in (8, 4):
        args, _ = _quant_case(rng, bits, dt, [1, 40, 0, 130], cuda)
        cases.append((
            pa_ops.paged_attention_decode_quant,
            lambda args=args, bits=bits, **f: paged_attention_kv_quant(
                *args, kv_bits=bits, **f),
            lambda args=args, bits=bits: pa_ops.paged_attention_decode_quant(
                *args, kv_bits=bits)))
    fq, fk, fv = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(device=cuda, dtype=dt)
        for shape in ((2, 8, 96, 64), (2, 2, 96, 64), (2, 2, 96, 64)))
    cases.append((fa_ops.flash_attention_fwd,
                  lambda **f: attention(fq, fk, fv, window=17, **f),
                  lambda: fa_ops.flash_attention_fwd(fq, fk, fv,
                                                     window=17)))
    for wrapper, public, direct in cases:
        before = wrapper.launches
        out = public(use_kernel=use_kernel)
        assert wrapper.launches == before + 1
        assert torch.equal(out, direct())
        before = wrapper.launches
        with pytest.raises(ValueError, match="use_kernel=False"):
            public(use_kernel=False)
        assert wrapper.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_segments(cuda, dtype, d):
    """Segments: agrees with the plain full softmax, pad rows exactly 0,
    and new K/V for every other segment leave a segment's rows
    bit-identical on the card (S = 200, not a multiple of the 64 tile)."""
    rng = np.random.default_rng(22)
    b, h, kv, s = 2, 4, 2, 200
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(device=cuda, dtype=dtype)
        for shape in ((b, h, s, d), (b, kv, s, d), (b, kv, s, d)))
    segs = torch.from_numpy(_segments(b, s)).to(cuda)
    out = fa_ops.flash_attention_fwd(q, k, v, segs, segs)
    ref = fa_ref.flash_attention_segmented_ref(q, k, v, segs, segs)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=tol)
    pads = (segs == -1)[:, None, :, None].expand_as(out)
    assert (out[pads] == 0).all()
    other = (segs != 1)[:, None, :, None]
    k2 = torch.where(other, torch.randn_like(k) * 10, k)
    v2 = torch.where(other, torch.randn_like(v) * 10, v)
    out2 = fa_ops.flash_attention_fwd(q, k2, v2, segs, segs)
    mine = (segs == 1)[:, None, :, None].expand_as(out)
    assert torch.equal(out2[mine], out[mine])


@pytest.mark.cuda
def test_flash_attention_wrapper_refuses(cuda):
    q = torch.zeros(1, 2, 8, 24, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        fa_ops.flash_attention_fwd(q, q[:, :1], q[:, :1])
    q = torch.zeros(1, 2, 8, 16, device=cuda)
    with pytest.raises(TypeError):
        fa_ops.flash_attention_fwd(q.half(), q[:, :1].half(), q[:, :1].half())
    with pytest.raises(ValueError, match="int32"):
        seg = torch.zeros(1, 8, dtype=torch.int64, device=cuda)
        fa_ops.flash_attention_fwd(q, q[:, :1], q[:, :1], seg, seg)
    # bf16 (tensor cores): 16-byte aligned pointers and row strides only
    qb = torch.zeros(1, 2, 8, 16, device=cuda, dtype=torch.bfloat16)
    kb = qb[:, :1]
    shifted = torch.zeros(qb.numel() + 1, device=cuda,
                          dtype=torch.bfloat16)[1:].view(qb.shape)
    with pytest.raises(ValueError, match="16-byte"):
        fa_ops.flash_attention_fwd(shifted, kb, kb)
    wide = torch.zeros(1, 8, 2, 20, device=cuda, dtype=torch.bfloat16)
    strided = wide[..., :16].transpose(1, 2)      # row stride 40 elements
    with pytest.raises(ValueError, match="16-byte"):
        fa_ops.flash_attention_fwd(strided, kb, kb)
    q264 = torch.zeros(1, 2, 8, 264, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        fa_ops.flash_attention_fwd(q264, q264[:, :1], q264[:, :1])


# ---------------------------------------------------------------------------
# the continuous engine's dispatch graphs
# ---------------------------------------------------------------------------

# internlm2-1.8b's depth at smoke width, bf16; head_dim 32 makes the K and V
# projections 64 wide, so all seven a layer quantize and pack
GRAPH_LAYERS = 24
GRAPH_ENGINE = dict(max_batch=4, page_size=4, num_pages=160, max_seq=64,
                    prefill_chunk=8)


@pytest.fixture(scope="module")
def graph_model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs)")
    cfg = dataclasses.replace(smoke_config("internlm2-1.8b"),
                              n_layers=GRAPH_LAYERS, head_dim=32,
                              dtype=torch.bfloat16)
    model = Model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    qparams, _ = quantize_params(params, QuantPolicy(min_size=1024))
    return model, qparams


def _graph_prompts(vocab):
    rng = np.random.default_rng(21)
    return [rng.integers(0, vocab, int(n)).astype(np.int32)
            for n in (5, 13, 9, 17)]


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _pool_leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _pool_leaves(v, f"{path}/{k}")
    else:
        yield path, tree


def _record_first_dispatches(eng):
    """Serve the prompts through ``eng`` and record the first dispatch of
    each kind: its host inputs, block-table rows, the pools before it,
    its outputs and the pools after it."""
    graphs, run, recs = eng.graphs, eng.graphs.run, {}

    def spy(kind, size, inputs, bt):
        first = kind not in recs
        if first:
            recs[kind] = dict(size=size, bt=bt.clone(),
                              inputs={n: a.copy() for n, a in inputs.items()},
                              before=_clone(eng.cache.pools))
        outs = run(kind, size, inputs, bt)
        if first:
            recs[kind].update(outs=[o.clone() for o in outs],
                              after=_clone(eng.cache.pools))
        return outs

    graphs.run = spy
    try:
        for p in _graph_prompts(eng.model.cfg.vocab_size):
            eng.submit(p, 12)
        out = eng.run()
    finally:
        del graphs.run
    return recs, out


@pytest.mark.cuda
@pytest.mark.parametrize("horizon", [1, 8])
@pytest.mark.parametrize("bits", [16, 8, 4])
def test_graph_replay_is_bitwise_eager(graph_model, bits, horizon):
    """Each kind's first dispatch replays a captured graph; the same
    dispatch run eagerly (``DispatchGraphs.forward``) on a copy of the
    pools before it gives the same outputs and the same pools, bit for
    bit, outside the scratch page and hot row (which pad rows write in
    any order)."""
    model, qparams = graph_model
    eng = ContinuousEngine(model, qparams, decode_horizon=horizon,
                           kv_bits=bits, **GRAPH_ENGINE)
    recs, out = _record_first_dispatches(eng)
    kinds = {"prefill_packed", "decode" if horizon == 1 else
             "decode_horizon"}
    assert set(recs) == kinds and len(out) == 4
    for kind, rec in recs.items():
        pools = _clone(rec["before"])
        x = {n: torch.from_numpy(a).cuda() for n, a in rec["inputs"].items()}
        outs, _ = eng.graphs.forward(kind, x, rec["bt"], pools)
        for got, want in zip(rec["outs"], outs):
            assert torch.equal(got, want), f"{kind}: outputs differ"
        after = dict(_pool_leaves(rec["after"]))
        for path, leaf in _pool_leaves(pools):
            assert torch.equal(after[path][:, 1:], leaf[:, 1:]), \
                f"{kind}: pool {path} differs"
    eng.close(check=True)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [16, 4])
def test_warmup_captures_everything_and_pools_stay_put(graph_model, bits):
    """warmup() captures every reachable key; a serving run after it
    captures nothing, and no pool leaf moves (graphs bind addresses). The
    tokens equal an engine's that captured lazily."""
    model, qparams = graph_model
    eng = ContinuousEngine(model, qparams, decode_horizon=8, kv_bits=bits,
                           **GRAPH_ENGINE)
    ptrs = {p: t.data_ptr() for p, t in _pool_leaves(eng.cache.pools)}
    report = eng.warmup()
    assert report["traces"] == report["entries"] == 6
    assert report["graph_bytes"] > 0
    n0 = jit_trace_count()
    rids = [eng.submit(p, 12) for p in _graph_prompts(model.cfg.vocab_size)]
    out = eng.run()
    assert jit_trace_count() == n0, "a capture after warmup()"
    assert {p: t.data_ptr() for p, t in _pool_leaves(eng.cache.pools)} == ptrs
    eng.close(check=True)
    lazy = ContinuousEngine(model, qparams, decode_horizon=8, kv_bits=bits,
                            **GRAPH_ENGINE)
    lrids = [lazy.submit(p, 12)
             for p in _graph_prompts(model.cfg.vocab_size)]
    lout = lazy.run()
    for a, b in zip(rids, lrids):
        np.testing.assert_array_equal(out[a], lout[b])
    lazy.close(check=True)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [16, 8])
def test_replays_count_the_eager_launches(graph_model, bits):
    """A replay adds the launches of the forwards it holds: kernel A 7 a
    layer (168 a forward at 24 layers) and the unembedding's kernel once,
    B or C one a layer (24); a capture itself counts none."""
    model, qparams = graph_model
    per_a, per_attn = 7 * GRAPH_LAYERS, GRAPH_LAYERS
    attn = ("paged_attention_decode" if bits == 16
            else "paged_attention_decode_quant")
    eng = ContinuousEngine(model, qparams, decode_horizon=8, kv_bits=bits,
                           **GRAPH_ENGINE)
    eng.warmup()
    for kind, size in eng.graphs.keys:
        h = 8 if kind == "decode_horizon" else 1
        counts = eng.graphs.graph_launches(kind, size)
        assert counts["msb_matmul"] == h * per_a, (kind, counts)
        assert counts["msb_unembed"] == h, (kind, counts)
        assert counts[attn] == h * per_attn, (kind, counts)
        assert sum(counts.values()) == h * (per_a + 1 + per_attn)
    before = (mm_ops.msb_matmul.launches, mm_ops.msb_unembed.launches,
              getattr(pa_ops, attn).launches)
    slots, inputs = pad_inputs("decode_horizon", 4, eng.max_batch)
    eng.graphs.run("decode_horizon", 4, inputs, eng.cache.table_rows(slots))
    assert (mm_ops.msb_matmul.launches - before[0],
            mm_ops.msb_unembed.launches - before[1],
            getattr(pa_ops, attn).launches - before[2]) == \
        (8 * per_a, 8, 8 * per_attn)
    eng.close()


def _next_logits(model, params, tokens, ps=4):
    """Last-position logits of one eager prefill of ``tokens`` on fresh
    kv16 pools."""
    n, dev = len(tokens), torch.device("cuda")
    pages = -(-n // ps)
    pools = model.init_paged_pools(pages + 1, ps, device=dev)
    bt = torch.arange(1, pages + 1, dtype=torch.int32, device=dev)[None]
    tok = torch.tensor(np.asarray(tokens)[None], dtype=torch.int32,
                       device=dev)
    q_pos = torch.arange(n, dtype=torch.int32, device=dev)[None]
    kv = torch.tensor([n], dtype=torch.int32, device=dev)
    logits, _ = model.paged_step(params, pools, tok, q_pos, kv, bt)
    return logits[0].float().cpu()


@pytest.mark.cuda
def test_simulated_engine_serves_through_graphs(graph_model):
    """execution="simulated" on the card: the QTensor tree is dequantized
    per call and multiplied by torch.matmul inside the captured graphs.
    warmup() captures every key, a serving run after it captures nothing,
    and the greedy tokens equal the packed engine's at kv16, or part from
    them only at a near tie (top-2 logit gap < 1e-2 where they first
    differ: the products are summed in another order than kernel A's)."""
    model, qparams = graph_model
    prompts = _graph_prompts(model.cfg.vocab_size)
    outs, sim_params = {}, None
    for execution in ("simulated", "packed"):
        eng = ContinuousEngine(model, qparams, execution=execution,
                               decode_horizon=8, **GRAPH_ENGINE)
        report = eng.warmup()
        assert report["traces"] == report["entries"] == 6
        assert report["graph_bytes"] > 0
        n0 = jit_trace_count()
        rids = [eng.submit(p, 12) for p in prompts]
        out = eng.run()
        assert jit_trace_count() == n0, f"{execution}: capture after warmup"
        outs[execution] = [out[r] for r in rids]
        if execution == "simulated":
            sim_params = eng.params
        eng.close(check=True)
    for p, a, b in zip(prompts, outs["simulated"], outs["packed"]):
        assert len(a) == len(b) == 12
        if np.array_equal(a, b):
            continue
        i = int(np.argmax(a != b))
        top = _next_logits(model, sim_params,
                           np.concatenate([p, a[:i]])).topk(2).values
        assert float(top[0] - top[1]) < 1e-2, (i, a, b)


def _solver_blocks():
    """Ties, exact zeros, heavy tails and plain normal rows."""
    rng = np.random.default_rng(21)
    b = rng.standard_normal((300, 64)).astype(np.float32)
    b[:20] = np.round(b[:20] * 4) / 4
    b[20:30, :16] = 0.0
    b[30:40] = rng.standard_t(2, (10, 64))
    return torch.from_numpy(b)


def _assert_same_or_near_tie(blocks, card, cpu):
    """Per row: levels and scales identical, or the SSE within 1e-6.
    ``card`` and ``cpu`` are (levels, scales) pairs of (rows, -1)."""
    lc, sc = (t.cpu() for t in card)
    lp, sp = cpu
    same = (lc == lp).all(1) & (sc == sp).all(1)

    def sse(lv, s):
        w = blocks.double()
        return ((w - torch.sign(w) * torch.gather(s.double(), 1, lv.long()))
                ** 2).sum(1)
    e_card, e_cpu = sse(lc, sc), sse(lp, sp)
    assert ((e_card - e_cpu).abs() <= 1e-6 * e_cpu)[~same].all()
    assert same.float().mean() >= 0.95


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["dp", "kmeans", "wdp"])
def test_solvers_on_the_card_match_their_cpu_run(cuda, method):
    from repro_torch.core import solve_blocks
    blocks = _solver_blocks()
    card = solve_blocks(blocks.to(cuda), 8, method=method, chunk=128)
    cpu = solve_blocks(blocks, 8, method=method, chunk=128)
    _assert_same_or_near_tie(blocks, card, cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["wdp", "kmeans"])
def test_pertensor_and_choose_k_on_the_card_match_cpu(cuda, solver):
    from repro_torch.core import quantize_pertensor, solve_flat
    w = torch.from_numpy(np.random.default_rng(22).standard_t(
        4, (128, 2048)).astype(np.float32))
    qc, qp = (quantize_pertensor(x, 6, solver=solver) for x in
              (w.to(cuda), w))

    def levels(q):
        return torch.clamp(q.codes.reshape(1, -1).long().abs() - 1, min=0)
    _assert_same_or_near_tie(w.reshape(1, -1), (levels(qc), qc.scales),
                             (levels(qp), qp.scales))
    blocks = _solver_blocks()
    for row in blocks[::30]:
        card = solve_flat(row.to(cuda), 8, lam=2.0, choose_k=True)
        cpu = solve_flat(row, 8, lam=2.0, choose_k=True)
        _assert_same_or_near_tie(row[None], (card[0][None], card[1][None]),
                                 (cpu[0][None], cpu[1][None]))


@pytest.mark.cuda
def test_qtensor_matmul_runs_kernel_a_on_a_solver_output(cuda):
    from repro_torch.core import quantize_blockwise
    rng = np.random.default_rng(23)
    w = torch.from_numpy(rng.standard_normal((256, 320)).astype(
        np.float32)).to(cuda)
    q = quantize_blockwise(w, solver="kmeans")
    x = torch.from_numpy(rng.standard_normal((5, 256)).astype(
        np.float32)).to(cuda)
    before = mm_ops.msb_matmul.launches
    y = mm_ops.qtensor_matmul(x, q)
    pq = mm_ops._cached_pack(q)
    y_ref = mm_ref.msb_matmul_ref(x, pq.packed, pq.scales)[:, :320]
    assert mm_ops.msb_matmul.launches == before + 1
    torch.testing.assert_close(y, y_ref, rtol=0,
                               atol=1e-5 * y_ref.abs().max().item())


# ---------------------------------------------------------------------------
# the model families: kernel A's expert batch, B and C with a window
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [1, 8, 112, 200])
def test_msb_matmul_experts_is_msb_matmul_per_expert(cuda, m, dtype):
    """Each expert's rows of the expert batch are bit for bit
    ``msb_matmul`` on that expert alone; experts with count 0 are exactly
    0; the batch counts one launch and agrees with its plain version."""
    rng = np.random.default_rng(30 + m)
    e, k, n = 6, 512, 256
    packed = torch.from_numpy(rng.integers(0, 256, (e, k, n // 2)).astype(
        np.uint8)).to(cuda)
    scales = torch.from_numpy(np.sort(rng.random((e, k, n // 64, 8)).astype(
        np.float32) * 0.1, axis=-1)).to(cuda)
    x = torch.from_numpy(rng.standard_normal((e, m, k)).astype(
        np.float32)).to(cuda).to(dtype)
    counts = torch.tensor([m, 0, 1, 0, 3, m], dtype=torch.int32,
                          device=cuda)
    before = mm_ops.msb_matmul_experts.launches
    y = mm_ops.msb_matmul_experts(x, packed, scales, counts)
    assert mm_ops.msb_matmul_experts.launches == before + 1
    for i in range(e):
        if int(counts[i]) == 0:
            assert (y[i] == 0).all()
        else:
            alone = mm_ops.msb_matmul(x[i].contiguous(), packed[i], scales[i])
            assert torch.equal(y[i], alone), f"expert {i}"
    want = mm_ref.msb_matmul_experts_ref(x, packed, scales, counts)
    tol = (1e-2 if dtype == torch.bfloat16 else 1e-5) * \
        want.float().abs().max().item()
    torch.testing.assert_close(y.float(), want.float(), rtol=0, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("direction", ["gate_up", "down"])
def test_msb_matmul_experts_at_jamba_shape(cuda, direction):
    """The expert batch at jamba-v0.1-52b's shape (16 experts, d_model
    4096, d_ff 14336; a B=8 decode step top-2 at capacity 8, three experts
    unrouted): each routed expert bit for bit ``msb_matmul`` on it alone,
    the others exactly 0, and within 1e-2 of the plain version's largest
    value (bf16)."""
    rng = np.random.default_rng(41)
    e, c = 16, 8
    k, n = (4096, 14336) if direction == "gate_up" else (14336, 4096)
    packed = torch.from_numpy(rng.integers(0, 256, (e, k, n // 2),
                                           dtype=np.uint8)).to(cuda)
    scales = torch.from_numpy(np.sort(rng.random((e, k, n // 64, 8)).astype(
        np.float32) * 0.05, axis=-1)).to(cuda)
    x = torch.from_numpy(rng.standard_normal((e, c, k)).astype(
        np.float32)).to(cuda).to(torch.bfloat16)
    counts = torch.tensor([1, 2, 0, 1, 1, 2, 1, 0, 1, 1, 2, 1, 0, 1, 1, 1],
                          dtype=torch.int32, device=cuda)
    assert int(counts.sum()) == 16                 # 8 tokens, top-2
    y = mm_ops.msb_matmul_experts(x, packed, scales, counts)
    for i in range(e):
        if int(counts[i]) == 0:
            assert (y[i] == 0).all()
        else:
            alone = mm_ops.msb_matmul(x[i].contiguous(), packed[i], scales[i])
            assert torch.equal(y[i], alone), f"expert {i}"
    want = mm_ref.msb_matmul_experts_ref(x, packed, scales, counts)
    torch.testing.assert_close(
        y.float(), want.float(), rtol=0,
        atol=1e-2 * want.float().abs().max().item())


def _routed_counts(rng, tokens, topk, n_real, e, c):
    """int32 (e,) routed tokens per expert as top-``topk`` routing of
    ``tokens`` tokens over the first ``n_real`` experts gives them, capped
    at capacity ``c``; the first routed expert filled to ``c``, so counts
    have zeros (unrouted and padded experts), partial and full experts."""
    logits = rng.random((tokens, n_real))
    idx = np.argsort(-logits, axis=1)[:, :topk].reshape(-1)
    counts = np.minimum(np.bincount(idx, minlength=e), c).astype(np.int32)
    counts[np.flatnonzero(counts)[0]] = c
    return counts


# the expert batch on the cluster kernel: (E, K, N, C, tokens, top-k,
# routed experts) — granite-moe-3b-a800m's 48 padded experts both ways at
# a decode step (C=8), a 128-token wave (C=32) and a 512-token wave
# (C=112), a tp = 2 rank's 24 of them, and a narrow shape with 32 K
# splits (clusters of 8, each block walking 4 splits)
EXPERT_CASES = {
    "granite_up_c8": (48, 1536, 512, 8, 8, 8, 40),
    "granite_up_c32": (48, 1536, 512, 32, 128, 8, 40),
    "granite_down_c8": (48, 512, 1536, 8, 8, 8, 40),
    "granite_up_c112": (48, 1536, 512, 112, 512, 8, 40),
    "granite_down_c112": (48, 512, 1536, 112, 512, 8, 40),
    "tp2_rank_c112": (24, 1536, 512, 112, 512, 8, 16),
    "narrow_c8": (6, 8192, 64, 8, 8, 2, 4),
    "narrow_c112": (6, 8192, 64, 112, 200, 2, 4),
}


def _expert_batch(case, device):
    e, k, n, c, tokens, topk, n_real = EXPERT_CASES[case]
    rng = np.random.default_rng(sorted(EXPERT_CASES).index(case))
    packed = torch.from_numpy(rng.integers(0, 256, (e, k, n // 2),
                                           dtype=np.uint8)).to(device)
    scales = torch.from_numpy(np.sort(rng.random((e, k, n // 64, 8)).astype(
        np.float32) * 0.05, axis=-1)).to(device)
    # random rows everywhere, past each expert's count too
    x = torch.from_numpy(rng.standard_normal((e, c, k)).astype(
        np.float32)).to(device).to(torch.bfloat16)
    counts = torch.from_numpy(_routed_counts(rng, tokens, topk, n_real, e,
                                             c)).to(device)
    return x, packed, scales, counts


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(EXPERT_CASES))
def test_msb_matmul_experts_cluster_is_msb_matmul_per_expert(cuda, case):
    """The expert batch's cluster launch at granite-moe's shapes, a tp = 2
    rank's 24 experts and a shape with 32 K splits, persistent clusters (C
    up to 64) and one item a cluster (C=112): one launch, each
    routed expert (rows past its count included) ``torch.equal`` to
    ``msb_matmul`` on it alone, each unrouted expert exactly 0, and within
    1e-2 of the plain version's largest value."""
    x, packed, scales, counts = _expert_batch(case, cuda)
    e, c, k = x.shape
    p = mm_ops.experts_plan(c, k, packed.shape[-1] * 2)
    assert isinstance(p, mm_ops.ExpertPlan)
    assert p.walk == (4 if case.startswith("narrow") else 1)
    assert (counts == 0).any() and (counts == c).any()
    before = mm_ops.msb_matmul_experts.launches
    y = mm_ops.msb_matmul_experts(x, packed, scales, counts)
    assert mm_ops.msb_matmul_experts.launches == before + 1
    for i in range(e):
        if int(counts[i]) == 0:
            assert (y[i] == 0).all(), f"expert {i}"
        else:
            alone = mm_ops.msb_matmul(x[i].contiguous(), packed[i], scales[i])
            assert torch.equal(y[i], alone), f"expert {i}"
    want = mm_ref.msb_matmul_experts_ref(x, packed, scales, counts)
    torch.testing.assert_close(
        y.float(), want.float(), rtol=0,
        atol=1e-2 * want.float().abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["granite_up_c32", "granite_up_c112"])
def test_msb_matmul_experts_in_a_captured_graph(cuda, case):
    """The expert batch captured in a CUDA graph (C=32: persistent
    clusters, captured before any eager launch of its tile; C=112: one
    item a cluster): a replay after new ``counts`` (and x) are copied in
    gives the eager launch's bits, the experts unrouted now exactly 0."""
    x, packed, scales, counts = _expert_batch(case, cuda)
    assert (counts[:40] > 0).all()
    e, c, k = x.shape
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = mm_ops.msb_matmul_experts(x, packed, scales, counts)
    graph.replay()
    torch.cuda.synchronize()
    y0 = out.clone()
    assert torch.equal(y0, mm_ops.msb_matmul_experts(x, packed, scales,
                                                     counts))
    rng = np.random.default_rng(99)
    # a new routing over the first 20 experts: 20 of the 40 go unrouted
    counts.copy_(torch.from_numpy(_routed_counts(rng, 2 * c, 8, 20, e, c)))
    x.copy_(torch.from_numpy(rng.standard_normal(tuple(x.shape)).astype(
        np.float32)).to(torch.bfloat16))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, mm_ops.msb_matmul_experts(x, packed, scales,
                                                      counts))
    assert not torch.equal(out, y0)
    assert (out[counts == 0] == 0).all()


@pytest.mark.cuda
def test_msb_matmul_experts_is_one_kernel(cuda):
    """One expert-batch call at a 512-token wave (C=112) runs one kernel on
    the device, the cluster kernel: no ``split_reduce_kernel`` and no other
    launch (the wrapper allocates only its output)."""
    from torch.profiler import ProfilerActivity, profile
    x, packed, scales, counts = _expert_batch("granite_up_c112", cuda)
    mm_ops.msb_matmul_experts(x, packed, scales, counts)     # built, warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        mm_ops.msb_matmul_experts(x, packed, scales, counts)
        torch.cuda.synchronize()
    kernels = [evt.key for evt in prof.key_averages()
               if evt.device_type.name == "CUDA" and evt.count > 0
               and getattr(evt, "self_device_time_total",
                           getattr(evt, "self_cuda_time_total", 0)) > 0]
    assert len(kernels) == 1 and "msb_experts_kernel" in kernels[0], kernels
    assert not any("split_reduce" in name for name in kernels)


WINDOW_LENS = [0, 1, 17, 100, 300, 517, 1029, 2048]


@pytest.mark.cuda
@pytest.mark.parametrize("window", [6, 100, 260])
@pytest.mark.parametrize("bits", [16, 8, 4])
def test_paged_attention_window_rows_alone_and_plain(cuda, bits, window):
    """B (kv16) and C with a per-row window start (decode: kv_len -
    window, mid-page for most rows) at d=256, KV=4, softcap 50: every row
    agrees with the plain version and is bit for bit the same alone, with
    a block table only as wide as it needs."""
    rng = np.random.default_rng(40 + bits + window)
    ps, kv, h, d = 16, 4, 8, 256
    if bits == 16:
        q, k_pool, v_pool, bt, lens = _kv16_case(
            rng, torch.bfloat16, WINDOW_LENS, cuda, ps=ps, kv=kv, h=h, d=d)
        pools = (k_pool, v_pool)
        run, plain = pa_ops.paged_attention_decode, \
            pa_ref.paged_attention_decode_ref
        tail, kw = (), {}
    else:
        args, _ = _quant_case(rng, bits, torch.bfloat16, WINDOW_LENS, cuda,
                              ps=ps, kv=kv, h=h, d=d)
        q, pools, bt, lens, hot_rows = (args[0], args[1:7], args[7],
                                        args[8], args[9])
        run, plain = pa_ops.paged_attention_decode_quant, \
            pa_ref.paged_attention_decode_quant_ref
        tail, kw = (hot_rows,), dict(kv_bits=bits)
    starts = torch.clamp(lens - window, min=0)
    out = run(q, *pools, bt, lens, *tail, kv_start=starts, softcap=50.0,
              **kw)
    want = plain(q, *pools, bt, lens, *tail, kv_start=starts, softcap=50.0,
                 **kw)
    torch.testing.assert_close(out.float(), want.float(), rtol=0, atol=2e-2)
    assert (out[0] == 0).all()
    for i, n in enumerate(WINDOW_LENS):
        w = max(1, -(-n // ps))
        alone = run(q[i:i + 1].contiguous(), *pools,
                    bt[i:i + 1, :w].contiguous(), lens[i:i + 1].contiguous(),
                    *(t[i:i + 1].contiguous() for t in tail),
                    kv_start=starts[i:i + 1].contiguous(), softcap=50.0,
                    **kw)
        assert torch.equal(alone[0], out[i]), f"row of {n} keys"


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["gemma2-2b", "granite-moe-3b-a800m"])
@pytest.mark.parametrize("bits", [16, 4])
def test_family_engines_warm_and_match_the_cpu(cuda, arch, bits):
    """Smoke gemma2 (window 6, binding) and granite-moe served through
    warmed dispatch graphs: no capture after warmup(), the expert batch
    counted on the MoE path, tokens equal to the same engine on the CPU
    (fp32 smoke params: near ties aside, which this seed has none of).
    MoE runs with a capacity no expert can overflow: the scratch page its
    pads read is written through duplicate indices, in another order on
    the card than on the CPU (ROADMAP §3)."""
    cfg = smoke_config(arch)
    if cfg.sliding_window:
        cfg = dataclasses.replace(cfg, sliding_window=6)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=(
            cfg.n_experts_padded / cfg.n_experts_active))
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    qparams, _ = quantize_params(params, QuantPolicy(min_size=1024),
                                 device="cpu")
    outs = {}
    for dev in ("cuda", "cpu"):
        eng = ContinuousEngine(model, qparams, decode_horizon=8, kv_bits=bits,
                               device=dev, **GRAPH_ENGINE)
        if dev == "cuda":
            eng.warmup()
            n0 = jit_trace_count()
            before = mm_ops.msb_matmul_experts.launches
        for p in _graph_prompts(cfg.vocab_size):
            eng.submit(p, 12)
        outs[dev] = eng.run()
        if dev == "cuda":
            assert jit_trace_count() == n0, "a capture after warmup()"
            moe = mm_ops.msb_matmul_experts.launches - before
            assert (moe > 0) == bool(cfg.n_experts)
        eng.close()
    for rid in outs["cpu"]:
        np.testing.assert_array_equal(outs["cuda"][rid], outs["cpu"][rid])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_attention_kernel_lse(cuda, case, dtype):
    """Kernel D's per-row log-sum-exp against its plain version's (1e-5
    f32, 1e-3 absolute from bf16 inputs), and the output bitwise the same
    with and without it."""
    causal, window, softcap, h, kv, sq, skv, d = FLASH_CASES[case]
    rng = np.random.default_rng(23)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(device=cuda, dtype=dtype)
        for shape in ((2, h, sq, d), (2, kv, skv, d), (2, kv, skv, d)))
    kw = dict(causal=causal, window=window, softcap=softcap)
    lse = torch.empty((2, h, sq), device=cuda)
    out = fa_ops.flash_attention_fwd(q, k, v, lse=lse, **kw)
    assert torch.equal(out, fa_ops.flash_attention_fwd(q, k, v, **kw))
    _, lse_ref = fa_ref.flash_attention_ref(q, k, v, with_lse=True, **kw)
    tol = 1e-5 * lse_ref.abs().max().item() if dtype == torch.float32 \
        else 1e-3
    torch.testing.assert_close(lse, lse_ref, rtol=0, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_attention_grads_on_the_card(cuda, case, dtype):
    """Gradients through ``models.attention.flash_attention`` (kernel D
    under its autograd Function) against autograd through the plain
    version on the same inputs: dq/dk/dv within 1e-4 (f32) or 2e-2 (bf16)
    of each tensor's largest |value|, and none missing or all zero."""
    from repro_torch.models.attention import flash_attention
    causal, window, softcap, h, kv, sq, skv, d = FLASH_CASES[case]
    rng = np.random.default_rng(24)

    def leaf(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(device=cuda, dtype=dtype).requires_grad_(True)

    q, k, v = leaf((2, sq, h, d)), leaf((2, skv, kv, d)), leaf((2, skv, kv,
                                                                d))
    dout = torch.randn(2, sq, h, d, device=cuda, dtype=dtype)
    kw = dict(causal=causal, window=window, softcap=softcap)
    before = fa_ops.flash_attention_fwd.launches
    flash_attention(q, k, v, **kw).backward(dout)
    assert fa_ops.flash_attention_fwd.launches == before + 1
    got = [t.grad for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    fa_ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), **kw).transpose(
        1, 2).backward(dout)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for g, t in zip(got, (q, k, v)):
        assert g is not None and g.abs().max().item() > 0
        want = t.grad.float()
        err = (g.float() - want).abs().max().item()
        assert err <= tol * want.abs().max().item(), err


@pytest.mark.cuda
def test_flash_attention_raw_launch_refuses_grad(cuda):
    """The raw launch would drop the gradient: it refuses q, k or v that
    require grad while grad mode is on, and runs under ``no_grad``."""
    q = torch.randn(1, 2, 8, 16, device=cuda, requires_grad=True)
    k = torch.randn(1, 1, 8, 16, device=cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        fa_ops.flash_attention_fwd(q, k, k)
    with torch.no_grad():
        out = fa_ops.flash_attention_fwd(q, k, k)
    assert out.grad_fn is None


# -- tensor parallelism: kernels at internlm2-1.8b's tp = 2 shard shapes ------

TP2_SHARDS = {  # leaf: (K, N) of one rank's slice
    "wq": (2048, 1024), "wk_wv": (2048, 512), "attn_wo": (1024, 2048),
    "wg_wi": (2048, 4096), "mlp_wo": (4096, 2048)}


@pytest.mark.cuda
@pytest.mark.parametrize("leaf", sorted(TP2_SHARDS))
def test_msb_matmul_at_tp2_shard_shapes(cuda, leaf):
    """Kernel A at each shard shape (bf16 x, M = 1, 8 and 512) against its
    plain version (1e-2 of the largest output), rows at M = 1 and 8
    bitwise the same rows at M = 512; a rank's slice cut from a whole
    column-sharded weight (``tp_shard``: a contiguous copy) runs too."""
    from repro_torch.core.policy import tp_shard
    k, n = TP2_SHARDS[leaf]
    rng = np.random.default_rng(k + n)
    p, s = _weights(rng, k, n, False, cuda)
    x = torch.from_numpy(rng.standard_normal((512, k)).astype(
        np.float32)).to(cuda).to(torch.bfloat16)
    full = mm_ops.msb_matmul(x, p, s)
    for m in (1, 8, 512):
        y = mm_ops.msb_matmul(x[:m].contiguous(), p, s)
        want = mm_ref.msb_matmul_ref(x[:m], p, s).float()
        torch.testing.assert_close(y.float(), want, rtol=0,
                                   atol=1e-2 * want.abs().max().item())
        assert torch.equal(y, full[:m]), f"rows at M={m}"
    pw, sw = _weights(rng, k, 2 * n, False, cuda)
    whole = PackedQTensor(pw, sw, 4, 64, torch.float32, 2 * n, shard="n")
    spec = PackedQTensor(1, 1, 4, 64, torch.float32, 2 * n)
    half = tp_shard({"w": whole}, {"w": spec}, 1, 2)["w"]
    y = mm_ops.msb_matmul(x[:8].contiguous(), half.packed, half.scales)
    want = mm_ref.msb_matmul_ref(x[:8], pw, sw).float()[:, n:]
    torch.testing.assert_close(y.float(), want, rtol=0,
                               atol=1e-2 * want.abs().max().item())


@pytest.mark.cuda
def test_unembed_on_the_tp2_vocab_shard(cuda):
    """``msb_unembed`` on one rank's half of internlm2-1.8b's k-blocked
    table (2048 x 46336 of 92672): within 1e-5 of the largest logit of its
    plain version, rows at M = 1 and 8 bitwise those at M = 64."""
    rng = np.random.default_rng(46336)
    pq = _unembed_table(rng, 46336, 2048, True, torch.float32, cuda)
    x = torch.from_numpy(rng.standard_normal((64, 2048)).astype(
        np.float32)).to(cuda)
    full = mm_ops.msb_unembed(x, pq)
    for m in (1, 8, 64):
        y = mm_ops.msb_unembed(x[:m], pq)
        want = mm_ref.msb_unembed_ref(x[:m], pq)
        torch.testing.assert_close(y, want, rtol=0,
                                   atol=1e-5 * want.abs().max().item())
        assert torch.equal(y, full[:m])


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [16, 8, 4])
def test_paged_attention_at_tp2_heads(cuda, bits):
    """B (kv16) and C (kv8/kv4) on one rank's heads at tp = 2: 8 query
    heads over 4 KV heads, bf16, rows alone bitwise in the batch, the
    batch within 2e-2 of the plain version."""
    rng = np.random.default_rng(70 + bits)
    lens = [0, 1, 17, 300, 2048, 4100]
    kw = dict(kv=4, h=8)
    if bits == 16:
        q, kp, vp, bt, kv_lens = _kv16_case(rng, torch.bfloat16, lens, cuda,
                                            **kw)
        out = pa_ops.paged_attention_decode(q, kp, vp, bt, kv_lens)
        ref = pa_ref.paged_attention_decode_ref(q, kp, vp, bt, kv_lens)

        def alone(i, width):
            return pa_ops.paged_attention_decode(
                q[i:i + 1].contiguous(), kp, vp,
                bt[i:i + 1, :width].contiguous(),
                kv_lens[i:i + 1].contiguous())
    else:
        args, n_full = _quant_case(rng, bits, torch.bfloat16, lens, cuda,
                                   **kw)
        out = pa_ops.paged_attention_decode_quant(*args, kv_bits=bits,
                                                  n_full=n_full)
        ref = pa_ref.paged_attention_decode_quant_ref(*args, kv_bits=bits,
                                                      n_full=n_full)
        q, kc, ks, vc, vs, kh, vh, bt, kv_lens, hot_rows = args

        def alone(i, width):
            return pa_ops.paged_attention_decode_quant(
                q[i:i + 1].contiguous(), kc, ks, vc, vs, kh, vh,
                bt[i:i + 1, :width].contiguous(),
                kv_lens[i:i + 1].contiguous(),
                hot_rows[i:i + 1].contiguous(), kv_bits=bits,
                n_full=n_full[i:i + 1].contiguous())
    assert out.shape == (len(lens), 8, 128)
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=2e-2)
    for i, n in enumerate(lens):
        assert torch.equal(alone(i, max(1, -(-n // 16)))[0], out[i])


@pytest.mark.cuda
def test_two_ranks_on_one_card_gloo_collectives(cuda):
    """A two-rank gloo world, both ranks on cuda:0: ``psum`` and
    ``all_gather`` of f32 and bf16 CUDA tensors equal the local sum (in
    rank order) and concatenation, bitwise, on both ranks."""
    import test_torch_tp_ranks as torch_tp_ranks
    from repro_torch.launch.mesh import make_tp_mesh
    mesh = make_tp_mesh(2, devices=["cuda:0", "cuda:0"])
    try:
        res = mesh.gather(torch_tp_ranks.card_collectives)
    finally:
        mesh.close()
    for key in res[0]:
        xs = [r[key][0] for r in res]
        want_sum = (xs[0].to(cuda) + xs[1].to(cuda)).cpu()
        want_cat = torch.cat(xs, dim=-1)
        for r in res:
            assert torch.equal(r[key][1], want_sum), key
            assert torch.equal(r[key][2], want_cat), key


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 100])
def test_flash_attention_q_offset_on_the_card(cuda, dtype, window):
    """Kernel D with ``q_offset`` (a context-parallel rank's rows against
    the whole K/V): against its plain version at every rank's offset, and
    bitwise the same rows of the whole sequence's launch at q_offset 0
    (offsets on the 64-row tile); the lse against the plain version's."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    b, h, kv, s, d, n = 2, 4, 2, 384, 64, 3
    q, k, v = (torch.randn((b, hh, s, d), generator=gen, device=cuda).to(
        dtype) for hh in (h, kv, kv))
    kw = dict(causal=True, window=window)
    whole = fa_ops.flash_attention_fwd(q, k, v, **kw)
    sq = s // n
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    for r in range(n):
        qr = q[:, :, r * sq:(r + 1) * sq]
        lse = torch.empty(qr.shape[:3], dtype=torch.float32, device=cuda)
        out = fa_ops.flash_attention_fwd(qr, k, v, q_offset=r * sq, lse=lse,
                                         **kw)
        assert torch.equal(out, whole[:, :, r * sq:(r + 1) * sq])
        want, want_lse = fa_ref.flash_attention_ref(
            qr, k, v, with_lse=True, q_offset=r * sq, **kw)
        assert (out.float() - want.float()).abs().max().item() <= tol
        assert (lse - want_lse).abs().max().item() <= (
            1e-3 if dtype == torch.bfloat16 else 1e-5 * want_lse.abs().max())


@pytest.mark.cuda
def test_gspmd_loss_on_one_card(cuda):
    """internlm2's smoke config on a (1, 2) process mesh, both ranks on
    cuda:0, f32: the sharded loss (heads over ``model``) and one
    ``make_train_step`` step's loss and grad norm within 1e-4 relative of
    the one-device run on the card."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel import sharding as shd
    from repro_torch.train import AdamW, OptConfig, init_state, \
        make_train_step
    from repro_torch.train.train_loop import place_state
    cfg = smoke_config("internlm2-1.8b")
    model = Model(cfg)
    opt = AdamW(OptConfig(warmup_steps=1))
    state = init_state(model, opt, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, cfg.vocab_size, (4, 64))
             for k in ("tokens", "labels")}
    on = lambda t: ({k: on(v) for k, v in t.items()}    # noqa: E731
                    if isinstance(t, dict) else t.to(cuda, copy=True))
    card = {k: torch.from_numpy(v).to(cuda) for k, v in batch.items()}
    with torch.no_grad():
        want_loss = float(model.loss(on(state["params"]), card)[0])
    _, want = make_train_step(model, opt)(on(state), card)
    mesh = make_host_mesh((1, 2), devices=["cuda:0", "cuda:0"])
    try:
        ctx = shd.from_mesh(mesh)
        placed = place_state(model, opt, state, mesh)
        loss = float(model.loss(placed["params"], batch, ctx)[0])
        _, got = make_train_step(model, opt, ctx)(placed, batch)
    finally:
        mesh.close()
    assert abs(loss / want_loss - 1) <= 1e-4
    for k in ("loss", "grad_norm"):
        assert abs(float(got[k]) / float(want[k]) - 1) <= 1e-4, k


@pytest.mark.cuda
def test_gspmd_serving_on_one_card(cuda):
    """internlm2's smoke config, 4b/64 quantized, on a (2, 2) process mesh
    of four ranks on cuda:0: ``ContinuousEngine(parallel=)`` (kv16, H=4)
    and ``ServeEngine(parallel=)`` ``generate`` give the tokens of the
    same engines on one device on the card, and every rank launched A,
    the unembedding's kernel and B (continuous) or D (static). On the
    dense tree, which the resolver cuts (ZeRO-3 over data, heads over
    model), ``ServeEngine(parallel=)`` gives one device's tokens too, each
    rank launching D once a layer and no other kernel."""
    import test_torch_gspmd_ranks as ranks
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel import sharding as shd
    from repro_torch.serve import ServeEngine
    cfg = smoke_config("internlm2-1.8b")
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    qp, _ = quantize_params(params, QuantPolicy(bits=4, block=64,
                                                solver="kmeans",
                                                min_size=1024), device="cpu")
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(0, cfg.vocab_size, n).astype(np.int32), 8)
            for n in (5, 12, 9, 16)]
    prompts = rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
    kw = dict(max_batch=4, page_size=4, num_pages=64, max_seq=64,
              prefill_chunk=8, decode_horizon=4)

    def serve(**extra):
        eng = ContinuousEngine(model, qp, **kw, **extra)
        for r in reqs:
            eng.submit(*r)
        out = eng.run()
        eng.close()
        return out

    want = serve(device=cuda)
    want_static = ServeEngine(model, qp, max_seq=64,
                              device=cuda).generate(prompts, 8)
    want_dense = ServeEngine(model, params, max_seq=64,
                             device=cuda).generate(prompts, 8)
    mesh = make_host_mesh((2, 2), devices=["cuda:0"] * 4)
    try:
        ctx = shd.from_mesh(mesh)
        mesh.gather(ranks.launches, True)
        got = serve(parallel=ctx)
        paged = mesh.gather(ranks.launches, True)
        eng = ServeEngine(model, qp, max_seq=64, parallel=ctx)
        got_static = eng.generate(prompts, 8)
        static = mesh.gather(ranks.launches, True)
        eng.close()
        eng = ServeEngine(model, params, max_seq=64, parallel=ctx)
        mesh.gather(ranks.launches, True)
        got_dense = eng.generate(prompts, 8)
        dense_counts = mesh.gather(ranks.launches, True)
        eng.close()
    finally:
        mesh.close()
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    np.testing.assert_array_equal(got_static, want_static)
    for counts in paged:
        assert counts["msb_matmul"] > 0 and counts["msb_unembed"] > 0
        assert counts["paged_attention_decode"] > 0
    for counts in static:
        assert counts["msb_matmul"] > 0 and counts["msb_unembed"] > 0
        assert counts["flash_attention_fwd"] == cfg.n_layers
    np.testing.assert_array_equal(got_dense, want_dense)
    for counts in dense_counts:
        assert counts["flash_attention_fwd"] == cfg.n_layers
        assert counts["msb_matmul"] == counts["msb_unembed"] == 0
