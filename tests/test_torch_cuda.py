"""The port's hand-written kernels against their plain versions on the
card. Marked ``cuda``: they skip where there is no CUDA device. This file
imports no JAX, so it also runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

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
