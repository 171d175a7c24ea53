"""Kernels: kernel B (``paged_attention``: the split-KV walk and its
combine) against its roofline in the traced slice's decode steps. Work:
each decode row reads its own context's K and V once a forward, plus its
q and output, in every layer; device time: the kernels whose names hold
one of ``PATTERNS`` inside the decode steps' spans."""
from cardbench import cost, readers

PATTERNS = ("paged_attention_split_kernel", "paged_attention_combine_kernel")


def read(rec):
    cfg = rec["config"]
    return readers.roofline(
        rec, PATTERNS, lambda ctx, lr, segs: [cost.paged_attention(cfg, ctx)],
        kind="decode")
