"""Every cell of BENCHMARK.json resolves its configuration, traffic mix,
driver, cell data and per-layer readers by name, and the manifest keeps
to the rules on names, keys and sizes."""
import json
import re

import pytest

from cardbench import manifest

M = manifest.load_manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in M["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_cell_resolves_by_name(workload):
    res = manifest.resolve(workload, M)
    assert callable(res["driver"].run)
    assert res["config"]["name"] == res["cell"]["config"]
    assert res["data"]["limits"]
    names = {m["name"] for m in res["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert res["per_layer"]
    for m in res["per_layer"]:
        assert callable(manifest.reader(m["name"]))
        assert m["moves"] in names


def test_manifest_keys_and_names():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert M["paths"] == ["cardbench"] and 1 <= M["run_seconds"] <= 51
    metrics = M["end_to_end"] + M["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in M["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in M["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        if "_roofline." in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for group in ("configs", "workloads"):
        names = [x["name"] for x in M[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert len(json.dumps(M)) < 64 * 1024


@pytest.mark.parametrize("config", [c["name"] for c in M["configs"]])
def test_config_file_lists_its_cuts(config):
    entry = next(c for c in M["configs"] if c["name"] == config)
    cfg = json.loads((manifest.ROOT / entry["file"]).read_text())
    assert entry["file"].startswith("cardbench/")
    assert cfg["source"].startswith(entry["source"])
    assert cfg["reduced"] == entry["reduced"]
    for key in entry["reduced"]:
        assert not key.endswith(("_dim", "_rank", "_size"))
        assert key in cfg
