"""Wrapper of the paged-attention decode kernel.

``paged_attention_decode`` dispatches on the tensor's device and nothing
else: a CPU tensor takes the plain version
(``ref.paged_attention_decode_ref``), a CUDA tensor launches the
hand-written kernel (``csrc/paged_attention.cu``) or raises.
``paged_attention_decode.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import paged_attention_decode_ref

_SMEM_MAX = 227 * 1024        # dynamic shared memory a block can use
_THREADS, _ACC_MAX = 128, 8   # must match csrc/paged_attention.cu


def smem_bytes(rep, d, ps):
    return 4 * (rep * d + 2 * ps * d + rep * ps + 3 * rep)


def _lib():
    fn = _build.load("paged_attention").paged_attention_decode
    if fn.argtypes is None:
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, cf, cf,
                       ci, vp]
        fn.restype = ci
    return fn


def _launch(q, k_pool, v_pool, block_tables, kv_lens, softcap, scale):
    b, h, d = q.shape
    if k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError("paged_attention_decode: pools must both be "
                         "(n_pages, page_size, KV, d)")
    _, ps, kv, dk = k_pool.shape
    if dk != d or h % kv:
        raise ValueError(f"paged_attention_decode: q {tuple(q.shape)} does "
                         f"not fit pools {tuple(k_pool.shape)}")
    if q.dtype not in (torch.bfloat16, torch.float32) or \
            k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError("paged_attention_decode: q and pools must share one "
                        "type, bf16 or f32")
    if block_tables.dtype != torch.int32 or block_tables.dim() != 2 or \
            block_tables.shape[0] != b:
        raise ValueError("paged_attention_decode: block_tables must be "
                         f"int32 ({b}, max_pages)")
    if kv_lens.dtype != torch.int32 or tuple(kv_lens.shape) != (b,):
        raise ValueError(f"paged_attention_decode: kv_lens must be int32 "
                         f"({b},)")
    rep = h // kv
    if rep * d > _THREADS * _ACC_MAX:
        raise ValueError(f"paged_attention_decode: rep*d={rep * d} exceeds "
                         f"{_THREADS * _ACC_MAX}")
    if smem_bytes(rep, d, ps) > _SMEM_MAX:
        raise ValueError("paged_attention_decode: page too large for shared "
                         "memory")
    ts = (q, k_pool, v_pool, block_tables, kv_lens)
    if any(t.device != q.device for t in ts):
        raise ValueError("paged_attention_decode: all tensors must be on one "
                         "device")
    if any(not t.is_contiguous() for t in ts):
        raise ValueError("paged_attention_decode: tensors must be contiguous")
    out = torch.empty_like(q)
    if b == 0:
        return out
    scale = float(scale if scale is not None else d ** -0.5)
    err = _lib()(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 block_tables.data_ptr(), kv_lens.data_ptr(), out.data_ptr(),
                 b, h, kv, d, ps, block_tables.shape[1], scale, float(softcap),
                 int(q.dtype == torch.bfloat16),
                 torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "paged_attention_decode")
    paged_attention_decode.launches += 1
    return out


def paged_attention_decode(q, k_pool, v_pool, block_tables, kv_lens, *,
                           softcap=0.0, scale=None):
    """Decode attention, one query token per row. q: (B, H, d); pools:
    (n_pages, page_size, KV, d); block_tables: (B, max_pages) int32;
    kv_lens: (B,) int32 — row b attends to positions ``< kv_lens[b]``
    (every block-table entry below ``ceil(kv_len / page_size)`` must be a
    valid page). Returns (B, H, d); rows with kv_len 0 are exactly 0. No
    sliding window: ROADMAP item 10 (gemma2) adds it."""
    if q.is_cuda:
        return _launch(q, k_pool, v_pool, block_tables, kv_lens, softcap,
                       scale)
    return paged_attention_decode_ref(q, k_pool, v_pool, block_tables,
                                      kv_lens, softcap=softcap, scale=scale)


paged_attention_decode.launches = 0
