"""The readings the correctness limits are set from, at a cell's own size.

    python3 -m cardbench.control --workload <cell> --seeds 1,2,3 \
        --seconds 10 [--override '{"traffic": {...}, "engine": {...}}'] \
        [--out <file>.jsonl]

Runs the cell once per seed in this one process (set-up each time, a
short window at the cell's own load), then the check with the
lower-precision control beside it: the reference with every product's
operands rounded to float8 e4m3 (``reference/model.py``), read at the
same positions of the same prompts and tokens: the gap of the token the
control puts first. Prints, per seed, the program's numbers and the control's. The
benchmark's own runs never run the control. ``--override`` changes the
mix or the engine for a witness run.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from . import manifest, run


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--override", default="{}")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    over = json.loads(args.override)
    for seed in [int(s) for s in args.seeds.split(",")]:
        res = manifest.resolve(args.workload)
        res["traffic"] = dict(res["traffic"], **over.get("traffic", {}))
        res["config"] = dict(res["config"])
        res["config"]["engine"] = dict(res["config"]["engine"],
                                       **over.get("engine", {}))
        t0 = time.monotonic()
        out = run.run_cell(args.workload, seed, args.seconds, 0,
                           control=True, t_start=t0, resolved=res)
        line = {"workload": args.workload, "seed": seed, "override": over,
                "correct": out["correct"], "checks": out["checks"],
                "notes": out["notes"],
                "metrics": {k: v["value"] for k, v in out["metrics"].items()}}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
        del out
        import gc
        import torch
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
