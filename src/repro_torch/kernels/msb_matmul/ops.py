"""Wrapper of the msb_matmul kernel and the packed-weight matmul on it.

``msb_matmul`` dispatches on the tensor's device and nothing else: a CPU
tensor takes the plain version (``ref.msb_matmul_ref``), a CUDA tensor
launches the hand-written kernel (``csrc/msb_matmul.cu``: bf16 x on the
tensor cores, f32 x on SIMT f32 FMA) or raises. ``plan`` is its launch
plan, ``msb_matmul.launches`` counts kernel launches.
``msb_matmul_experts`` runs a batch of MoE experts in one launch, with
device-side routed-token counts (its own ``.launches``): at up to 128 bf16
rows an expert a kernel of the same source launched as thread block
clusters (``experts_plan``), else the same kernel as ``msb_matmul``;
``packed_matmul_experts`` runs it on a layer's stacked expert weights.
``msb_unembed`` is the unembedding: logits in f32 from a packed table of
either layout (the untied k-blocked ``unembed``, or a tied n-blocked
``embed`` read as its transpose) through a weight-streaming kernel of the
same source (its own ``.launches``; ``unembed_plan`` is its launch plan).

``qtensor_matmul`` / ``to_kernel_layout`` take a raw 4-bit/64 ``QTensor``
(a solver's output, without ``pack_params``); the packing is memoized on
the concrete codes/scales buffers.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import _build
from ...core.quantize import (PACK_BLOCK, PACK_LEVELS, PackedQTensor,
                              QTensor, pack_codes_int4, pack_qtensor)
from .ref import (BLOCK, LEVELS, msb_matmul_experts_ref, msb_matmul_ref,
                  msb_unembed_ref)


def k_splits(k, n):
    """K splits of the kernel: enough blocks to fill the card for narrow N,
    at least 4 K steps per split. Depends on (K, N) only, never on M, so an
    output row's reduction order is the same at every batch size."""
    nblk, ksteps, s = n // PACK_BLOCK, k // PACK_BLOCK, 1
    while nblk * s < 256 and ksteps % (2 * s) == 0 and ksteps // (2 * s) >= 4:
        s *= 2
    return s


class Plan(NamedTuple):
    """One launch: output tiles of ``bm`` x ``bn``; K cut into ``splits``
    runs of ``k_per_split`` (summed in ascending order); ``grid_splits``
    is ``splits`` when each split runs on its own blocks (then summed by a
    second pass over an f32 (splits, M, N) scratch), 1 when one block walks
    all of K and sums the splits itself."""
    bm: int
    bn: int
    splits: int
    k_per_split: int
    grid_splits: int


SMALL_M = 128     # bf16 up to here: 16 x 64 tiles, splits on separate
                  # blocks; past it 128 x 128 tiles walking all of K


def plan(m, k, n, bf16=True):
    """The kernel's launch plan for x (M, K) @ W (K, N). The tile may
    depend on M; the K plan (``splits``, ``k_per_split``) depends on
    (K, N) only, so an output row's bits are the same at every M."""
    splits = k_splits(k, n)
    if not bf16:       # f32 SIMT kernel: splits always on separate blocks
        return Plan(8 if m <= 8 else 32, 64, splits, k // splits, splits)
    if m <= SMALL_M:
        return Plan(16, 64, splits, k // splits, splits)
    return Plan(128, 128, splits, k // splits, 1)


SMEM_LIMIT = 232448   # shared bytes a block may opt into (H100)
MAX_CLUSTER = 8       # the portable thread block cluster size


class ExpertPlan(NamedTuple):
    """The expert batch's launch at C <= 128 bf16 rows an expert: a tile
    of ``bm`` (>= C) x ``bn``; K cut into ``splits`` runs of
    ``k_per_split`` (``k_splits``'s plan); the splits of an item (one
    expert's N tile) run on the ``cluster`` blocks of one thread block
    cluster, each walking ``walk`` consecutive splits and keeping each
    split's f32 sum in shared memory (``smem`` bytes a block); the blocks
    add them in ascending order through distributed shared memory.
    ``persist``: as many clusters as the card holds, each taking routed
    items in turn, its loads running on into the next item; else one
    cluster an item."""
    bm: int
    bn: int
    splits: int
    k_per_split: int
    cluster: int
    walk: int
    persist: bool
    smem: int


# the expert batch's tiles, by the rows they hold: (bm, bn, warps, stages,
# persistent clusters); csrc/msb_matmul.cu's ExpertTile* (the first that
# holds C, divides N and fits its split sums in shared memory). At 128 rows
# two sets of sum tiles would leave one block an SM: one item a cluster.
EXPERT_TILES = ((16, 128, 8, 4, True), (32, 64, 4, 4, True),
                (64, 64, 4, 4, True), (128, 128, 8, 3, False),
                (128, 64, 8, 3, False))


def experts_smem(bm, bn, stages, walk, persist):
    """Shared bytes of an expert-batch block (the kernel computes the
    same): ``stages`` of x (bm x 64 bf16, rows padded to 72), packed bytes
    and codebooks, two decoded bf16 W tiles (64 x bn + 8), then f32 sum
    tiles (bm x bn + 8): two sets of ``walk`` when ``persist``, else all
    but the last split's, which lies over the drained ring."""
    ring = stages * (bm * 72 * 2 + 64 * bn // 2 + bn * 32) + 2 * 64 * (bn + 8) * 2
    tile = bm * (bn + 8) * 4
    if persist:
        return ring + 2 * walk * tile
    return max(ring, tile) + (walk - 1) * tile


def experts_plan(m, k, n, bf16=True):
    """The expert batch's launch plan for x (E, M, K) @ W (E, K, N): an
    ``ExpertPlan`` for bf16 at M <= 128 (one block holds all of an
    expert's rows; its K splits summed in a cluster), else ``plan``'s for
    one expert (f32: the SIMT kernel; M > 128: 128 x 128 tiles walking all
    of K). The K plan is ``k_splits(K, N)`` either way, so every expert's
    rows are bit for bit ``msb_matmul``'s."""
    if not bf16 or m > SMALL_M:
        return plan(m, k, n, bf16)
    splits = k_splits(k, n)
    cluster = min(splits, MAX_CLUSTER)
    walk = splits // cluster
    for bm, bn, _, stages, persist in EXPERT_TILES:
        smem = experts_smem(bm, bn, stages, walk, persist)
        if bm >= m and n % bn == 0 and smem <= SMEM_LIMIT:
            return ExpertPlan(bm, bn, splits, k // splits, cluster, walk,
                              persist, smem)
    raise ValueError(f"msb_matmul_experts: K={k}, N={n} at M={m} needs "
                     f"{walk} split sums a block, more than its shared "
                     "memory holds")


_ARGS = {"msb_matmul": (6, 8), "msb_matmul_experts": (6, 12),
         "msb_unembed": (4, 8)}    # (leading pointers, ints), then the stream


def _lib(name="msb_matmul"):
    fn = getattr(_build.load("msb_matmul"), name)
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        ptrs, ints = _ARGS[name]
        fn.argtypes = [vp] * ptrs + [ci] * ints + [vp]
        fn.restype = ci
    return fn


def _check(what, x, packed, scales, bias, kblocked, lead=()):
    """Checks what the kernel takes: x (*lead, M, K) bf16/f32, packed
    uint8 (*lead, K, N/2), scales f32 (*lead, K, N/64, 8) n-blocked or
    (*lead, K/64, N, 8) k-blocked, bias f32 (N,), one device, contiguous,
    16-byte aligned. Returns (M, K, N)."""
    m, k = x.shape[-2:]
    n = packed.shape[-1] * 2
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{what}: x must be bf16 or f32, got {x.dtype}")
    if packed.dtype != torch.uint8 or tuple(packed.shape[:-1]) != lead + (k,):
        raise ValueError(f"{what}: packed must be uint8 {lead + (k,)} + "
                         f"(N/2,), got {packed.dtype} {tuple(packed.shape)}")
    if k % PACK_BLOCK or n % PACK_BLOCK:
        raise ValueError(f"{what}: K={k} and N={n} must be multiples "
                         f"of {PACK_BLOCK}")
    want = lead + ((k // PACK_BLOCK, n, PACK_LEVELS) if kblocked
                   else (k, n // PACK_BLOCK, PACK_LEVELS))
    if scales.dtype != torch.float32 or tuple(scales.shape) != want:
        raise ValueError(f"{what}: scales must be f32 {want}, got "
                         f"{scales.dtype} {tuple(scales.shape)}")
    if bias is not None and (bias.dtype != torch.float32
                             or tuple(bias.shape) != (n,)):
        raise ValueError(f"{what}: bias must be f32 ({n},)")
    ts = [t for t in (x, packed, scales, bias) if t is not None]
    if any(t.device != x.device for t in ts):
        raise ValueError(f"{what}: all tensors must be on one device")
    if any(not t.is_contiguous() for t in ts):
        raise ValueError(f"{what}: tensors must be contiguous")
    if any(t.data_ptr() % 16 for t in (x, packed, scales)):
        raise ValueError(f"{what}: x, packed and scales must start on a "
                         "16-byte boundary")
    return m, k, n


def _launch(x, packed, scales, bias, kblocked):
    m, k, n = _check("msb_matmul", x, packed, scales, bias, kblocked)
    dev = x.device
    out = torch.empty((m, n), dtype=x.dtype, device=dev)
    if m == 0:
        return out
    bf16 = x.dtype == torch.bfloat16
    p = plan(m, k, n, bf16)
    partial = (torch.empty((p.grid_splits, m, n), dtype=torch.float32,
                           device=dev) if p.grid_splits > 1 else None)
    err = _lib()(x.data_ptr(), packed.data_ptr(), scales.data_ptr(),
                 None if bias is None else bias.data_ptr(), out.data_ptr(),
                 None if partial is None else partial.data_ptr(), m, k, n,
                 p.splits, p.grid_splits, p.bm, int(kblocked), int(bf16),
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


def _launch_experts(x, packed, scales, counts, kblocked):
    what = "msb_matmul_experts"
    e = x.shape[0]
    m, k, n = _check(what, x, packed, scales, None, kblocked, lead=(e,))
    if counts.dtype != torch.int32 or tuple(counts.shape) != (e,) or \
            counts.device != x.device or not counts.is_contiguous():
        raise ValueError(f"{what}: counts must be int32 ({e},) on x's "
                         "device")
    dev = x.device
    out = torch.empty((e, m, n), dtype=x.dtype, device=dev)
    if m == 0 or e == 0:
        return out
    bf16 = x.dtype == torch.bfloat16
    p = experts_plan(m, k, n, bf16)
    partial = None
    if isinstance(p, ExpertPlan):   # one cluster launch, no workspace
        grid_splits, cluster, persist = 0, p.cluster, int(p.persist)
    else:
        grid_splits, cluster, persist = p.grid_splits, 0, 0
        zs = p.grid_splits if bf16 else p.splits
        if zs > 1:
            partial = torch.empty((e, zs, m, n), dtype=torch.float32,
                                  device=dev)
    err = _lib(what)(x.data_ptr(), packed.data_ptr(), scales.data_ptr(),
                     counts.data_ptr(), out.data_ptr(),
                     None if partial is None else partial.data_ptr(), e, m,
                     k, n, p.splits, grid_splits, p.bm, p.bn, cluster,
                     persist, int(kblocked), int(bf16),
                     torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, what)
    msb_matmul_experts.launches += 1
    return out


def msb_matmul_experts(x, packed, scales, counts, *, kblocked=False):
    """The expert batch of kernel A: y[e] = x[e] @ dequant(W[e]) for x (E,
    M, K), packed (E, K, N/2), scales (E, ...) as ``msb_matmul``'s, and
    ``counts`` (E,) int32 routed tokens per expert on x's device; y[e] is
    exactly 0 where counts[e] == 0 (no weight read), else bit for bit
    ``msb_matmul(x[e], packed[e], scales[e])``. One launch, no host sync.
    Returns (E, M, N). CPU tensors take the plain version."""
    if x.is_cuda:
        return _launch_experts(x, packed, scales, counts, kblocked)
    return msb_matmul_experts_ref(x, packed, scales, counts,
                                  kblocked=kblocked)


msb_matmul_experts.launches = 0


def packed_matmul(x, pq: PackedQTensor, bias=None, psum=None):
    """y = x @ dequant(pq) (+ bias). x: (..., K); returns (..., pq.n) in
    x's type. ``pq`` must be 2-D storage (a layer slice of stacked params).
    N-padding is sliced off here.

    Tensor parallelism: a rank's slice of an N- (column-) sharded weight
    needs nothing (its ``n`` rebound by ``core.policy.tp_localize``); the
    output is the rank's slice of features. For a K- (row-) sharded weight
    the rank's product is partial: ``psum`` (a ``parallel.TPShard``) sums
    it over the ranks. The bias is fused into the kernel only without
    ``psum``; with it the order is the reference's: the kernel, in x's
    type, the sum, then the bias."""
    if pq.packed.dim() != 2:
        raise ValueError(f"packed_matmul wants 2-D storage, got "
                         f"{tuple(pq.packed.shape)}; slice stacked params "
                         "first")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    fused = None
    if bias is not None and psum is None:
        fused = bias.reshape(-1).to(torch.float32)
        if fused.shape[0] != pq.n_pad:
            fused = torch.nn.functional.pad(fused,
                                            (0, pq.n_pad - fused.shape[0]))
        fused = fused.contiguous()
    y = msb_matmul(x2, pq.packed, pq.scales, fused, kblocked=pq.kblocked)
    y = y[:, :pq.n].reshape(*lead, pq.n)
    if psum is not None:
        y = psum.psum(y)
        if bias is not None:
            y = y + bias.to(y.dtype)
    return y


def packed_matmul_experts(x, pq: PackedQTensor, counts):
    """y[e] = x[e] @ dequant(pq[e]) for x (E, C, K) and a layer's stacked
    expert weights (``pq.packed`` (E, K, N/2)); zeros for experts with
    ``counts`` 0. Returns (E, C, pq.n) in x's type."""
    if pq.packed.dim() != 3:
        raise ValueError(f"packed_matmul_experts wants (E, K, N/2) storage, "
                         f"got {tuple(pq.packed.shape)}")
    y = msb_matmul_experts(x.contiguous(), pq.packed, pq.scales,
                           counts.to(torch.int32).contiguous(),
                           kblocked=pq.kblocked)
    return y[..., :pq.n]


# -- the unembedding --------------------------------------------------------

UNEMBED_WARPS = 16        # warps of a block: K slices x output strips
UNEMBED_OUTPUTS = {True: 64, False: 16}   # outputs a warp owns: k-blocked
                                          # columns, tied table rows
UNEMBED_RING = 16 * 3 * 64 * 32           # k-blocked: the warps' code rings
UNEMBED_TARGET_WARPS = 2 * 132 * 16       # two waves of 16-warp blocks


class UnembedPlan(NamedTuple):
    """One launch of the unembedding kernel: ``mt`` rows of x a block
    (grid rows ceil(M / mt)); ``slices`` K splits, run by warps of one
    block and added in ascending order; ``smem`` bytes of shared memory."""
    mt: int
    slices: int
    smem: int


def unembed_smem(mt, kp, slices, kblocked):
    """Shared bytes of a launch: the warps' decode tables (16 signed
    entries a codebook, 2 codebooks a lane), the k-blocked code ring, then
    x's ``mt`` rows of ``kp`` (tied: padded 4 floats a k-block, 1 at mt 1)
    or, after the K loop, the slices' sums (the kernel computes the
    same)."""
    tables = UNEMBED_WARPS * 2 * 16 * 32 * 4
    ring = UNEMBED_RING if kblocked else 0
    pad = 0 if kblocked else (1 if mt == 1 else 4)
    x = (mt * kp + kp // PACK_BLOCK * pad) * 4
    red = (slices - 1) * (UNEMBED_WARPS // slices) * 32 * 2 * mt * 4
    return tables + ring + max(x, red)


def unembed_slices(kp, n, kblocked):
    """K splits of the unembedding kernel for a table of ``n`` outputs and
    reduction width ``kp``: doubled from 1 while the grid has fewer than
    two waves of 16-warp blocks on 132 SMs, up to 16 and as long as every
    slice keeps at least 4 of the 64-row k-blocks. A function of (kp, n,
    layout) only, never of M, so an output row's sum order is the same at
    every batch size."""
    kblocks = kp // PACK_BLOCK
    warps = -(-n // UNEMBED_OUTPUTS[kblocked])
    s = 1
    while (warps * s < UNEMBED_TARGET_WARPS and 2 * s <= UNEMBED_WARPS
           and kblocks % (2 * s) == 0 and kblocks // (2 * s) >= 4):
        s *= 2
    return s


def unembed_plan(m, kp, n, kblocked):
    """The unembedding kernel's launch plan for x (M, K) against a table
    of ``n`` outputs and packed reduction width ``kp``: ``mt`` is M up to
    8 (rounded up to 1, 2, 4 or 8), halved while the shared memory would
    not fit; ``slices`` depends on (kp, n, layout) only."""
    slices = unembed_slices(kp, n, kblocked)
    mt = 1 if m <= 1 else 2 if m == 2 else 4 if m <= 4 else 8
    while mt > 1 and unembed_smem(mt, kp, slices, kblocked) > SMEM_LIMIT:
        mt //= 2
    smem = unembed_smem(mt, kp, slices, kblocked)
    if smem > SMEM_LIMIT:
        raise ValueError(f"msb_unembed: a reduction width of {kp} needs "
                         f"{smem} B of shared memory, more than a block has")
    return UnembedPlan(mt, slices, smem)


def _check_unembed(x, pq: PackedQTensor):
    """Checks what the unembedding kernel takes: x (M, K) f32, a 2-D
    4-bit/64 table on x's device, contiguous, 16-byte aligned; a tied
    table of dtype f32 or bf16 (its weights are rounded to it). Returns
    (M, K, Kp, N)."""
    what = "msb_unembed"
    packed, scales = pq.packed, pq.scales
    if x.dtype != torch.float32 or x.dim() != 2:
        raise TypeError(f"{what}: x must be f32 (M, K), got {x.dtype} "
                        f"{tuple(x.shape)}")
    if packed.dim() != 2 or packed.dtype != torch.uint8 or \
            pq.bits != 4 or pq.block != PACK_BLOCK:
        raise ValueError(f"{what}: the table must be 2-D 4-bit block-"
                         f"{PACK_BLOCK} storage, got {pq.bits}-bit block "
                         f"{pq.block}, packed {tuple(packed.shape)}")
    m, k = x.shape
    if pq.kblocked:
        kp, n = packed.shape[0], packed.shape[1] * 2
        want = (kp // PACK_BLOCK, n, PACK_LEVELS)
        ok = k == kp and kp % PACK_BLOCK == 0 and n % PACK_BLOCK == 0
    else:
        n, kp = packed.shape[0], packed.shape[1] * 2
        want = (n, kp // PACK_BLOCK, PACK_LEVELS)
        ok = k == pq.n and kp % PACK_BLOCK == 0
        if pq.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"{what}: a tied table dequantizes to f32 or "
                            f"bf16, got {pq.dtype}")
    if not ok:
        raise ValueError(f"{what}: x (M, {k}) does not fit the table "
                         f"{tuple(packed.shape)} "
                         f"({'k-blocked' if pq.kblocked else 'tied'})")
    if scales.dtype != torch.float32 or tuple(scales.shape) != want:
        raise ValueError(f"{what}: scales must be f32 {want}, got "
                         f"{scales.dtype} {tuple(scales.shape)}")
    ts = (x, packed, scales)
    if any(t.device != x.device for t in ts):
        raise ValueError(f"{what}: all tensors must be on one device")
    if any(not t.is_contiguous() for t in ts):
        raise ValueError(f"{what}: tensors must be contiguous")
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError(f"{what}: x, packed and scales must start on a "
                         "16-byte boundary")
    return m, k, kp, n


def _launch_unembed(x, pq: PackedQTensor):
    m, k, kp, n = _check_unembed(x, pq)
    dev = x.device
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if m == 0:
        return out
    p = unembed_plan(m, kp, n, pq.kblocked)
    round_bf16 = not pq.kblocked and pq.dtype == torch.bfloat16
    err = _lib("msb_unembed")(
        x.data_ptr(), pq.packed.data_ptr(), pq.scales.data_ptr(),
        out.data_ptr(), m, k, kp, n, int(pq.kblocked), int(round_bf16),
        p.mt, p.slices, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "msb_unembed")
    msb_unembed.launches += 1
    return out


def msb_unembed(x, pq: PackedQTensor):
    """Logits in f32 of hidden states x (M, D) against a packed
    unembedding table of either layout: the untied k-blocked ``unembed``
    (packed (D, V/2)) or a tied n-blocked ``embed`` (packed (V, D/2)), read
    in place as its transpose. Returns (M, V). CPU tensors take the plain
    version (``ref.msb_unembed_ref``: k-blocked ``msb_matmul_ref``, tied
    ``x @ dequant(table).t()``); CUDA tensors launch the kernel or raise."""
    if not x.is_cuda:
        return msb_unembed_ref(x, pq)
    y = _launch_unembed(x.to(torch.float32).contiguous(), pq)
    return y[:, :pq.n] if pq.kblocked else y


msb_unembed.launches = 0


# -- QTensor conveniences (tests / benchmarks) -------------------------------

def to_kernel_layout(q: QTensor):
    """QTensor (codes (K, N), scales (K, N/64, 8)) -> (packed, scales3d)."""
    if q.bits != 4 or q.block != PACK_BLOCK:
        raise ValueError("the kernel supports 4-bit block-64 QTensors, got "
                         f"{q.bits}-bit block {q.block}")
    k, n = q.codes.shape
    packed = pack_codes_int4(q.codes).reshape(k, n // 2)
    scales = q.scales.reshape(k, n // PACK_BLOCK, PACK_LEVELS)
    return packed, scales


_PACK_CACHE = {}


def _cached_pack(q: QTensor) -> PackedQTensor:
    """Memoize packing on the concrete buffers so repeated calls don't
    re-run the layout pass."""
    key = (id(q.codes), id(q.scales))
    hit = _PACK_CACHE.get(key)
    # retain BOTH buffers and identity-check both: an id() can be recycled
    # after gc, and a stale hit would silently pack the wrong scales
    if hit is None or hit[0] is not q.codes or hit[1] is not q.scales:
        if len(_PACK_CACHE) > 256:
            _PACK_CACHE.clear()
        hit = (q.codes, q.scales, pack_qtensor(q))
        _PACK_CACHE[key] = hit
    return hit[2]


def qtensor_matmul(x, q: QTensor):
    """y = x @ dequant(q). x: (..., K). Packs on first use (memoized);
    runs the kernel on CUDA tensors, its plain version on CPU ones."""
    return packed_matmul(x, _cached_pack(q))
