"""Graphs: host milliseconds spent in ``cudaGraphLaunch`` per engine step
in the traced slice (torch.profiler's CUDA runtime events)."""
from cardbench import readers


def read(rec):
    summ = rec.get("summary")
    if summ is None or rec["kind"] != "serve":
        return None
    n = len(readers.traced(rec))
    if n == 0 or summ["graph_launches"] == 0:
        return None
    return 1e3 * summ["graph_launch_s"] / n
