"""Kernels: kernel A (``msb_matmul``: every dense projection, and the
unembedding's kernel) against its roofline in the traced slice. Work:
each forward's projections at its live rows (packed weights read once a
forward, bf16 rows in and out) and the unembedding of its logits rows
(f32 in and out); device time: the kernels whose names hold one of
``PATTERNS``, a rename of which silences this metric."""
from cardbench import cost, readers

PATTERNS = ("msb_matmul_tc_kernel", "msb_matmul_f32_kernel",
            "split_reduce_kernel", "unembed_kblocked_kernel",
            "unembed_tied_kernel")


def read(rec):
    cfg, vp = rec["config"], rec["vocab_padded"]
    return readers.roofline(
        rec, PATTERNS, lambda ctx, lr, segs: [
            cost.dense_matmul(cfg, len(ctx)), cost.unembed(cfg, lr, vp)])
