"""Device: share of the traced slice in which the card ran nothing
(kernels, copies and fills counted busy)."""
from cardbench import readers


def read(rec):
    return readers.idle_share(rec) if rec["kind"] == "serve" else None
