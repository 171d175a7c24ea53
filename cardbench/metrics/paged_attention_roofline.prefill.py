"""Kernels: kernel B against its roofline in the traced slice's prefill
steps, where the packed waves run it one query row a prompt token. Work:
each segment's K and V read once (its positions share them), each
position's q and output once, 4 * head_dim operations a (query, key)
pair and head; device time: the kernels whose names hold one of
``PATTERNS`` inside the prefill steps' spans. A prefill that no longer
runs B reads nothing here."""
from cardbench import cost, readers

PATTERNS = ("paged_attention_split_kernel", "paged_attention_combine_kernel")


def read(rec):
    cfg = rec["config"]
    return readers.roofline(
        rec, PATTERNS,
        lambda ctx, lr, segs: [cost.paged_attention_prefill(cfg, segs)],
        kind="prefill")
