"""Model step: host wall milliseconds of a decode dispatch (the
benchmark's span around ``engine.step()`` when ``last_step_kind`` is a
decode), averaged over the window's steps outside the traced slice."""
from cardbench import readers


def read(rec):
    return readers.dispatch_ms(rec, "decode")
