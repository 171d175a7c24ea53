"""The port's hand-written kernels against their plain versions on the
card. Marked ``cuda``: they skip where there is no CUDA device. This file
imports no JAX, so it also runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.quantize import kv_quantize_pages
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.msb_matmul import ops as mm_ops
from repro_torch.kernels.msb_matmul import ref as mm_ref
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.paged_attention import ref as pa_ref


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
    kc, ks, vc, vs, kh, vh = _quant_pools(np.random.default_rng(0), 4, 4, 2,
                                          4, 2, 16, torch.float32, cuda)
    one = torch.ones(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):        # 4-bit pools read as 8-bit
        pa_ops.paged_attention_decode_quant(q, kc, ks, vc, vs, kh, vh,
                                            bt.to(torch.int32), one, one,
                                            kv_bits=8)


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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_segments(cuda, dtype):
    """Segments: agrees with the plain full softmax, pad rows exactly 0,
    and new K/V for every other segment leave a segment's rows
    bit-identical on the card."""
    rng = np.random.default_rng(22)
    b, h, kv, s, d = 2, 4, 2, 200, 128
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
