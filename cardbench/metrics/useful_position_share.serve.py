"""Scheduler: positions that carried a prompt token or produced an output
token, as a share of the positions the engine's dispatches held, padding
included (``ContinuousEngine.stats()['work_positions']``), over the
window."""


def read(rec):
    if rec["kind"] != "serve" or rec["work_positions"] <= 0:
        return None
    return 100.0 * rec["useful_positions"] / rec["work_positions"]
