"""Run one cell of the port's benchmark once.

    python3 -m cardbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Set-up (kernel build on a checkout's first
run, weights from the seed, the port's quantization, the engine and its
warm-up) counts as ``setup_s``; then the cell's driver measures for
``--seconds`` and checks its outputs against the plain reference. With
``--trace 0`` the result line carries the cell's end-to-end metrics; with
``--trace 1`` a slice of the window runs under torch.profiler and the
line carries the per-layer metrics, ``busy_s``/``window_s`` and a
``breakdown``. The last line of standard output is the result's JSON;
the numbers compared, each beside its limit, end standard error and the
result's line (``checks``).

Exits 2 without a result when there is no CUDA device or fewer than the
cell asks for, 3 when the port cannot be imported from ``src/``, 4 when
the JAX package or JAX is loaded in this process once the window has
closed.
"""
from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from . import manifest  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Context:
    torch: object
    device: object
    seed: int
    seconds: float
    trace: bool
    config: dict
    traffic: dict
    data: dict
    t_start: float
    control: bool = False


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules():
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(workload, seed, seconds, trace, device=None, control=False,
             t_start=None, resolved=None):
    """One run of ``workload``; returns the result dict (its JSON line)."""
    import torch
    res = resolved or manifest.resolve(workload)
    dev = torch.device(device or "cuda")
    ctx = Context(torch=torch, device=dev, seed=int(seed),
                  seconds=float(seconds), trace=bool(trace),
                  config=res["config"], traffic=res["traffic"],
                  data=res["data"], control=control,
                  t_start=T_START if t_start is None else t_start)
    out = res["driver"].run(ctx)
    correct = all(c["value"] <= c["limit"] for c in out["checks"])
    if trace:
        rec = out["record"]
        metrics = {}
        for m in res["per_layer"]:
            v = manifest.reader(m["name"])(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out["metrics"][m["name"]],
                               "unit": m["unit"]}
                   for m in res["end_to_end"] if m["name"] in out["metrics"]}
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "cpu"),
        "count": res["cell"]["chips"],
        "memory_peak_bytes": out["memory_peak"]}
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics,
              "device": device_info}
    summary = out["record"].get("summary")
    if trace and summary is not None:
        from .trace import breakdown
        device_info["busy_s"] = summary["busy_s"]
        device_info["window_s"] = summary["window_s"]
        result["breakdown"] = breakdown(summary)
    result["notes"] = out["notes"]
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                        for c in out["checks"]}
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    res = manifest.resolve(args.workload)
    import torch
    chips = res["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"cardbench: the cell needs {chips} CUDA device(s); "
            f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    try:
        from .program import port
        port()
    except ImportError as exc:
        log(f"cardbench: cannot import the port from src/: {exc}")
        return 3
    result = run_cell(args.workload, args.seed, args.seconds, args.trace,
                      resolved=res)
    bad = forbidden_modules()
    if bad:
        log(f"cardbench: loaded in this process: {', '.join(bad)}")
        return 4
    for k, v in result["notes"].items():
        log(f"  {k}: {v}")
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
