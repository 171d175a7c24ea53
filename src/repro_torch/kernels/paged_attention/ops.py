"""Wrappers of the paged-attention decode kernels.

``paged_attention_decode`` (kv16 pools, kernel B) and
``paged_attention_decode_quant`` (MSB-quantized pools, kernel C) dispatch
on the tensor's device and nothing else: a CPU tensor takes the plain
version (``ref.py``), a CUDA tensor launches the hand-written kernel (the
two entry points of ``csrc/paged_attention.cu``) or raises. Both run one
split-KV walk and its merge, so each takes head_dim a power of two in
[16, 512] and 16-byte aligned pools. Each wrapper's ``.launches`` counts
its kernel's launches: one a call, though each runs as two CUDA kernels
(the split-KV walk, then the merge of its partials). Both take a sliding
window as ``kv_start``, each row's first visible position (int32 (B,) on
the device; ``None`` = 0).
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build, check_use_kernel
from ...core.quantize import KVQuantSpec
from .ref import paged_attention_decode_quant_ref, paged_attention_decode_ref

PAGES_PER_SPLIT = 8           # pages of a split (128 tokens at page_size 16)
SPLIT_BLOCKS = 16             # most blocks a row gets; as in the source


def n_splits(max_pages):
    """Blocks of the split grid per (row, query head): enough splits to
    cover a block-table row of ``max_pages`` pages, at most
    ``SPLIT_BLOCKS``; block z then walks splits z, z + n_splits, ... of its
    row. The width of the table is known on the host, so no device sync is
    needed; blocks past a row's own pages exit at once. The scratch is
    (B, H, n_splits) times d + 2 floats, so at most B * H * 16 * (d + 2) *
    4 bytes however wide the table is."""
    return max(1, min(-(-int(max_pages) // PAGES_PER_SPLIT), SPLIT_BLOCKS))


def lane_elems(kv_bits, d, what="paged_attention_decode"):
    """Elements of one lane's slice of a token row in the split walk: 16
    (kv16 values, or 16 bytes of 8-bit codes), 32 at 4 bits (16 bytes of
    nibbles), 16 at 4 bits when ``d % 32 != 0``. Raises unless ``d`` splits
    into a power-of-two count (<= 32) of them, i.e. unless ``d`` is a power
    of two in [16, 512] ([16, 1024] at 4 bits)."""
    e = 32 if kv_bits == 4 and d % 32 == 0 else 16
    lanes = d // e
    if d % e or lanes > 32 or lanes & (lanes - 1):
        raise ValueError(f"{what}: head_dim {d} must be a power of two in "
                         f"[16, {32 * e}] (d / {e} lanes per token row at "
                         f"kv_bits={kv_bits})")
    return e


def _split_scratch(b, h, d, max_pages, device):
    """n_splits and the f32 partials (2, B, H, n_splits), (B, H, n_splits,
    d) of one split launch."""
    ns = n_splits(max_pages)
    return (ns, torch.empty((2, b, h, ns), dtype=torch.float32, device=device),
            torch.empty((b, h, ns, d), dtype=torch.float32, device=device))


def _lib():
    fn = _build.load("paged_attention").paged_attention_decode
    if fn.argtypes is None:
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [vp] * 9 + [ci] * 8 + [cf, cf, ci, vp]
        fn.restype = ci
    return fn


def _starts(kv_start, kv_lens):
    """Each row's first visible position: ``kv_start``, or zeros."""
    return torch.zeros_like(kv_lens) if kv_start is None else kv_start


def _launch(q, k_pool, v_pool, block_tables, kv_lens, kv_start, softcap,
            scale):
    what = "paged_attention_decode"
    b, h, d = q.shape
    if k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(f"{what}: pools must both be (n_pages, page_size, "
                         "KV, d)")
    _, ps, kv, dk = k_pool.shape
    if dk != d or h % kv:
        raise ValueError(f"{what}: q {tuple(q.shape)} does not fit pools "
                         f"{tuple(k_pool.shape)}")
    if q.dtype not in (torch.bfloat16, torch.float32) or \
            k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(f"{what}: q and pools must share one type, bf16 or "
                        "f32")
    if block_tables.dtype != torch.int32 or block_tables.dim() != 2 or \
            block_tables.shape[0] != b:
        raise ValueError(f"{what}: block_tables must be int32 ({b}, "
                         "max_pages)")
    for name, t in (("kv_lens", kv_lens), ("kv_start", kv_start)):
        if t.dtype != torch.int32 or tuple(t.shape) != (b,):
            raise ValueError(f"{what}: {name} must be int32 ({b},)")
    lane_elems(16, d, what)
    ts = (q, k_pool, v_pool, block_tables, kv_lens, kv_start)
    if any(t.device != q.device for t in ts):
        raise ValueError(f"{what}: all tensors must be on one device")
    if any(not t.is_contiguous() for t in ts):
        raise ValueError(f"{what}: tensors must be contiguous")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError(f"{what}: pools must start on a 16-byte boundary")
    out = torch.empty_like(q)
    if b == 0:
        return out
    max_pages = block_tables.shape[1]
    ns, part_ml, part_acc = _split_scratch(b, h, d, max_pages, q.device)
    scale = float(scale if scale is not None else d ** -0.5)
    err = _lib()(*(t.data_ptr() for t in ts), part_ml.data_ptr(),
                 part_acc.data_ptr(), out.data_ptr(), b, h, kv, d, ps,
                 max_pages, ns, PAGES_PER_SPLIT, scale, float(softcap),
                 int(q.dtype == torch.bfloat16),
                 torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, what)
    paged_attention_decode.launches += 1
    return out


def paged_attention_decode(q, k_pool, v_pool, block_tables, kv_lens, *,
                           kv_start=None, softcap=0.0, scale=None):
    """Decode attention, one query token per row. q: (B, H, d); pools:
    (n_pages, page_size, KV, d); block_tables: (B, max_pages) int32;
    kv_lens: (B,) int32 — row b attends to positions ``kv_start[b] <= t <
    kv_lens[b]`` (``kv_start`` int32 (B,), ``None`` = 0; every block-table
    entry from page ``kv_start // page_size`` below ``ceil(kv_len /
    page_size)`` must be a valid page). Returns (B, H, d); rows that see
    no key (kv_len 0) are exactly 0."""
    kv_start = _starts(kv_start, kv_lens)
    if q.is_cuda:
        return _launch(q, k_pool, v_pool, block_tables, kv_lens, kv_start,
                       softcap, scale)
    return paged_attention_decode_ref(q, k_pool, v_pool, block_tables,
                                      kv_lens, kv_start=kv_start,
                                      softcap=softcap, scale=scale)


paged_attention_decode.launches = 0


def _lib_quant():
    fn = _build.load("paged_attention").paged_attention_decode_quant
    if fn.argtypes is None:
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [vp] * 15 + [ci] * 10 + [cf, cf, ci, ci, vp]
        fn.restype = ci
    return fn


def _launch_quant(q, k_codes, k_scales, v_codes, v_scales, k_hot, v_hot,
                  block_tables, kv_lens, hot_rows, kv_bits, n_full, kv_start,
                  softcap, scale):
    what = "paged_attention_decode_quant"
    b, h, d = q.shape
    if k_hot.dim() != 4 or k_hot.shape != v_hot.shape:
        raise ValueError(f"{what}: hot pools must both be (n_hot, page_size, "
                         "KV, d)")
    _, ps, kv, dk = k_hot.shape
    if dk != d or h % kv:
        raise ValueError(f"{what}: q {tuple(q.shape)} does not fit hot pools "
                         f"{tuple(k_hot.shape)}")
    spec = KVQuantSpec(int(kv_bits), ps, kv, d)
    n_pages = k_codes.shape[0]
    for name, t, tail, dt in (
            ("k_codes", k_codes, spec.codes_tail, spec.code_dtype),
            ("v_codes", v_codes, spec.codes_tail, spec.code_dtype),
            ("k_scales", k_scales, spec.scales_tail, spec.scale_dtype),
            ("v_scales", v_scales, spec.scales_tail, spec.scale_dtype)):
        if tuple(t.shape) != (n_pages,) + tail or t.dtype != dt:
            raise ValueError(f"{what}: {name} must be {dt} "
                             f"{(n_pages,) + tail} at kv_bits={kv_bits}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if q.dtype not in (torch.bfloat16, torch.float32) or \
            k_hot.dtype != q.dtype or v_hot.dtype != q.dtype:
        raise TypeError(f"{what}: q and hot pools must share one type, bf16 "
                        "or f32")
    if block_tables.dtype != torch.int32 or block_tables.dim() != 2 or \
            block_tables.shape[0] != b:
        raise ValueError(f"{what}: block_tables must be int32 ({b}, "
                         "max_pages)")
    for name, t in (("kv_lens", kv_lens), ("kv_start", kv_start),
                    ("n_full", n_full), ("hot_rows", hot_rows)):
        if t.dtype != torch.int32 or tuple(t.shape) != (b,):
            raise ValueError(f"{what}: {name} must be int32 ({b},)")
    lane_elems(int(kv_bits), d, what)
    ts = (q, k_codes, k_scales, v_codes, v_scales, k_hot, v_hot,
          block_tables, kv_lens, kv_start, n_full, hot_rows)
    if any(t.device != q.device for t in ts):
        raise ValueError(f"{what}: all tensors must be on one device")
    if any(not t.is_contiguous() for t in ts):
        raise ValueError(f"{what}: tensors must be contiguous")
    if any(t.data_ptr() % 16 for t in ts[1:7]):
        raise ValueError(f"{what}: code, scale and hot pools must start on "
                         "a 16-byte boundary")
    out = torch.empty_like(q)
    if b == 0:
        return out
    max_pages = block_tables.shape[1]
    ns, part_ml, part_acc = _split_scratch(b, h, d, max_pages, q.device)
    scale = float(scale if scale is not None else d ** -0.5)
    err = _lib_quant()(
        *(t.data_ptr() for t in ts), part_ml.data_ptr(), part_acc.data_ptr(),
        out.data_ptr(), b, h, kv, d, ps, max_pages, spec.tokens_per_block,
        spec.n_blocks, ns, PAGES_PER_SPLIT, scale, float(softcap),
        int(kv_bits), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, what)
    paged_attention_decode_quant.launches += 1
    return out


def paged_attention_decode_quant(q, k_codes, k_scales, v_codes, v_scales,
                                 k_hot, v_hot, block_tables, kv_lens,
                                 hot_rows, *, kv_bits, n_full=None,
                                 kv_start=None, softcap=0.0, scale=None):
    """Decode attention over MSB-quantized pools, one query token per row.
    q: (B, H, d); k/v_codes (n_pages, ps, KV, d or d/2) int8|uint8;
    k/v_scales (n_pages, KV, n_blocks, 1|8) f32|bf16; k/v_hot (n_hot, ps,
    KV, d) in q's type; block_tables (B, max_pages) int32; kv_lens (B,)
    int32 — row b attends to positions ``< kv_lens[b]``; hot_rows (B,)
    int32 hot row of each row's frontier page; n_full (B,) int32 pages
    read from the codes (default ``kv_lens // ps``; page ``n_full[b]`` is
    the hot one); ``kv_start`` as in ``paged_attention_decode``. Returns
    (B, H, d); rows that see no key (kv_len 0) are exactly 0."""
    if n_full is None:
        n_full = torch.div(kv_lens, k_hot.shape[1], rounding_mode="floor")
    kv_start = _starts(kv_start, kv_lens)
    if q.is_cuda:
        return _launch_quant(q, k_codes, k_scales, v_codes, v_scales, k_hot,
                             v_hot, block_tables, kv_lens, hot_rows, kv_bits,
                             n_full, kv_start, softcap, scale)
    return paged_attention_decode_quant_ref(
        q, k_codes, k_scales, v_codes, v_scales, k_hot, v_hot, block_tables,
        kv_lens, hot_rows, kv_bits=kv_bits, n_full=n_full, kv_start=kv_start,
        softcap=softcap, scale=scale)


paged_attention_decode_quant.launches = 0


def paged_attention(q, k_pool, v_pool, block_tables, kv_lens, *, softcap=0.0,
                    scale=None, use_kernel=None):
    """The reference's dispatcher of kernel B, an alias of
    ``paged_attention_decode`` (``use_kernel``: ``check_use_kernel``)."""
    check_use_kernel(q, use_kernel, "paged_attention")
    return paged_attention_decode(q, k_pool, v_pool, block_tables, kv_lens,
                                  softcap=softcap, scale=scale)


def paged_attention_kv_quant(q, k_codes, k_scales, v_codes, v_scales, k_hot,
                             v_hot, block_tables, kv_lens, hot_rows, *,
                             kv_bits, softcap=0.0, scale=None,
                             use_kernel=None):
    """The reference's dispatcher of kernel C (fused-dequant decode over
    MSB-quantized pools, kv_bits 8|4), an alias of
    ``paged_attention_decode_quant`` and its argument layout
    (``use_kernel``: ``check_use_kernel``)."""
    check_use_kernel(q, use_kernel, "paged_attention_kv_quant")
    return paged_attention_decode_quant(
        q, k_codes, k_scales, v_codes, v_scales, k_hot, v_hot, block_tables,
        kv_lens, hot_rows, kv_bits=kv_bits, softcap=softcap, scale=scale)
