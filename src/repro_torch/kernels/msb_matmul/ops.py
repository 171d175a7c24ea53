"""Wrapper of the msb_matmul kernel and the packed-weight matmul on it.

``msb_matmul`` dispatches on the tensor's device and nothing else: a CPU
tensor takes the plain version (``ref.msb_matmul_ref``), a CUDA tensor
launches the hand-written kernel (``csrc/msb_matmul.cu``) or raises.
``msb_matmul.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from ...core.quantize import PACK_BLOCK, PACK_LEVELS, PackedQTensor
from .ref import msb_matmul_ref


def k_splits(k, n):
    """K splits of the kernel: enough blocks to fill the card for narrow N,
    at least 4 K steps per split. Depends on (K, N) only, never on M, so an
    output row's reduction order is the same at every batch size."""
    nblk, ksteps, s = n // PACK_BLOCK, k // PACK_BLOCK, 1
    while nblk * s < 256 and ksteps % (2 * s) == 0 and ksteps // (2 * s) >= 4:
        s *= 2
    return s


def _lib():
    lib = _build.load("msb_matmul")
    fn = lib.msb_matmul
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, vp]
        fn.restype = ci
    return fn


def _launch(x, packed, scales, bias, kblocked):
    m, k = x.shape
    n = packed.shape[1] * 2
    dev = x.device
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"msb_matmul: x must be bf16 or f32, got {x.dtype}")
    if packed.dtype != torch.uint8 or packed.dim() != 2 or packed.shape[0] != k:
        raise ValueError(f"msb_matmul: packed must be uint8 (K={k}, N/2), "
                         f"got {packed.dtype} {tuple(packed.shape)}")
    if k % PACK_BLOCK or n % PACK_BLOCK:
        raise ValueError(f"msb_matmul: K={k} and N={n} must be multiples "
                         f"of {PACK_BLOCK}")
    want = ((k // PACK_BLOCK, n, PACK_LEVELS) if kblocked
            else (k, n // PACK_BLOCK, PACK_LEVELS))
    if scales.dtype != torch.float32 or tuple(scales.shape) != want:
        raise ValueError(f"msb_matmul: scales must be f32 {want}, got "
                         f"{scales.dtype} {tuple(scales.shape)}")
    if bias is not None and (bias.dtype != torch.float32
                             or tuple(bias.shape) != (n,)):
        raise ValueError(f"msb_matmul: bias must be f32 ({n},)")
    ts = [t for t in (x, packed, scales, bias) if t is not None]
    if any(t.device != dev for t in ts):
        raise ValueError("msb_matmul: all tensors must be on one device")
    if any(not t.is_contiguous() for t in ts):
        raise ValueError("msb_matmul: tensors must be contiguous")
    if packed.data_ptr() % 8:
        raise ValueError("msb_matmul: packed must be 8-byte aligned")
    out = torch.empty((m, n), dtype=x.dtype, device=dev)
    if m == 0:
        return out
    splits = k_splits(k, n)
    partial = (torch.empty((splits, m, n), dtype=torch.float32, device=dev)
               if splits > 1 else None)
    err = _lib()(x.data_ptr(), packed.data_ptr(), scales.data_ptr(),
                 None if bias is None else bias.data_ptr(), out.data_ptr(),
                 None if partial is None else partial.data_ptr(), m, k, n,
                 splits, int(kblocked), int(x.dtype == torch.bfloat16),
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "msb_matmul")
    msb_matmul.launches += 1
    return out


def msb_matmul(x, packed, scales, bias=None, *, kblocked=False):
    """y = x @ dequant(W) (+ bias). x (M, K) bf16/f32; packed uint8
    (K, N/2); scales f32 (K, N/64, 8) n-blocked or (K/64, N, 8) k-blocked;
    bias optional f32 (N,). Returns (M, N) in x's type, N the padded
    storage width. CPU tensors take the plain version; CUDA tensors the
    kernel."""
    if x.is_cuda:
        return _launch(x, packed, scales, bias, kblocked)
    return msb_matmul_ref(x, packed, scales, bias, kblocked=kblocked)


msb_matmul.launches = 0


def packed_matmul(x, pq: PackedQTensor, bias=None):
    """y = x @ dequant(pq) (+ bias). x: (..., K); returns (..., pq.n) in
    x's type. ``pq`` must be 2-D storage (a layer slice of stacked params).
    The bias is fused into the kernel; N-padding is sliced off here."""
    if pq.packed.dim() != 2:
        raise ValueError(f"packed_matmul wants 2-D storage, got "
                         f"{tuple(pq.packed.shape)}; slice stacked params "
                         "first")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    if bias is not None:
        bias = bias.reshape(-1).to(torch.float32)
        if bias.shape[0] != pq.n_pad:
            bias = torch.nn.functional.pad(bias, (0, pq.n_pad - bias.shape[0]))
        bias = bias.contiguous()
    y = msb_matmul(x2, pq.packed, pq.scales, bias, kblocked=pq.kblocked)
    return y[:, :pq.n].reshape(*lead, pq.n)
