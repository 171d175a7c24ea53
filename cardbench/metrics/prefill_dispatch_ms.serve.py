"""Model step: host wall milliseconds of a prefill dispatch (a packed
wave or a chunk), averaged over the window's steps outside the traced
slice."""
from cardbench import readers


def read(rec):
    return readers.dispatch_ms(rec, "prefill")
