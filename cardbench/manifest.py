"""Finds everything a cell needs by the names in ``BENCHMARK.json``.

A cell (one ``workloads`` entry) names a configuration and a traffic mix.
The configuration is the file its ``configs`` entry names; the mix is
``traffic/<traffic>.json``, which names its driver,
``drivers/<driver>.py``; ``cells/<workload>.json`` holds the cell's own
data (the limits its correctness check holds, and any engine setting
that differs from the configuration's); each per-layer metric is a
reader, ``metrics/<metric>.py``, with a ``read(record)`` function.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent


def load_manifest():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def metrics_of(manifest, workload):
    """(end-to-end metrics, per-layer metrics) the cell reports: those
    that list it, and those without a list whose end-to-end metric it
    reports."""
    e2e = [m for m in manifest["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    names = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"]
             if (workload in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return e2e, layer


def resolve(workload, manifest=None):
    """Everything the named cell needs: its entry, configuration, mix,
    cell data, driver module and metrics."""
    manifest = manifest or load_manifest()
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    cfg = json.loads((ROOT / configs[cell["config"]]["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json")
                         .read_text())
    data = json.loads((HERE / "cells" / f"{workload}.json").read_text())
    driver = importlib.import_module(f"cardbench.drivers.{traffic['driver']}")
    e2e, layer = metrics_of(manifest, workload)
    return dict(cell=cell, config=cfg, traffic=traffic, data=data,
                driver=driver, end_to_end=e2e, per_layer=layer)


def reader(metric_name):
    """The ``read`` function of ``metrics/<metric_name>.py``."""
    path = HERE / "metrics" / f"{metric_name}.py"
    spec = importlib.util.spec_from_file_location(
        "cardbench_metric_" + metric_name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
