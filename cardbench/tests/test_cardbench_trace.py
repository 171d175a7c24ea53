"""The profiler's events read back (``trace.summarize``) and the per-layer
readers over a traced record built by hand: busy time is the union of
the device's activity inside the slice, each idle gap is labelled by the
innermost host span at its midpoint, and every reader returns a number
where the record holds its work and nothing where it holds none."""
import json

import pytest

from cardbench import manifest, trace

# (name, is_device, start_us, end_us)
EVENTS = [
    ("bench.window", False, 0.0, 1000.0),
    ("bench.step", False, 0.0, 600.0),
    ("cudaGraphLaunch", False, 10.0, 110.0),
    ("cudaStreamSynchronize", False, 300.0, 590.0),
    ("bench.drain", False, 600.0, 700.0),
    ("bench.submit", False, 700.0, 1000.0),
    ("msb_matmul_tc_kernel<64>", True, 100.0, 300.0),
    ("paged_attention_split_kernel", True, 250.0, 400.0),   # overlaps A
    ("msb_matmul_tc_kernel<64>", True, 500.0, 550.0),
    ("split_reduce_kernel", True, 900.0, 1100.0),            # cut at 1000
]


def test_summary_busy_idle_and_labels():
    s = trace.summarize(EVENTS)
    assert s["window_s"] == pytest.approx(1e-3)
    # busy: [100, 400] + [500, 550] + [900, 1000]
    assert s["busy_s"] == pytest.approx(450e-6)
    assert s["by_name"]["msb_matmul_tc_kernel<64>"] == pytest.approx(250e-6)
    assert s["by_name"]["split_reduce_kernel"] == pytest.approx(100e-6)
    # gaps [0, 100] in the launch, [400, 500] in the sync, [550, 900]
    # whose midpoint 725 is in the submit span
    assert s["idle"] == pytest.approx({
        "dispatch: cudaGraphLaunch": 100e-6,
        "sync: wait for the device": 100e-6,
        "submit": 350e-6})
    assert s["graph_launch_s"] == pytest.approx(100e-6)
    assert s["graph_launches"] == 1
    b = trace.breakdown(s)
    assert b["device_ops"][0] == ["msb_matmul_tc_kernel<64>",
                                  pytest.approx(250e-6)]
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_device_time_by_step_span():
    ev = EVENTS + [("bench.step", False, 700.0, 950.0)]
    s = trace.summarize(ev)
    # A's first launch and B (midpoint 325) in the first span; A's
    # second in it too; the reduce (cut to 900..1000, midpoint 950) in
    # the second
    assert s["by_step"][0] == pytest.approx({
        "msb_matmul_tc_kernel<64>": 250e-6,
        "paged_attention_split_kernel": 150e-6})
    assert s["by_step"][1] == pytest.approx({"split_reduce_kernel": 100e-6})
    assert s["outside_steps_s"] == 0.0
    assert trace.summarize(EVENTS)["outside_steps_s"] == pytest.approx(
        100e-6)


def test_no_window_no_summary():
    assert trace.summarize([e for e in EVENTS if e[0] != "bench.window"]) \
        is None


def _record(summary, config="internlm2-1.8b"):
    cfg = json.loads((manifest.HERE / "configs" / f"{config}.json")
                     .read_text())
    steps = [dict(kind="decode_horizon", rows=[(300, 308)] * 64, dt=0.1,
                  traced=True),
             dict(kind="prefill_packed", rows=[(0, 128)] * 4, dt=0.03,
                  traced=True),
             dict(kind="decode_horizon", rows=[(308, 316)] * 64, dt=0.1,
                  traced=False),
             dict(kind="prefill_packed", rows=[(0, 128)] * 4, dt=0.03,
                  traced=False)]
    return dict(kind="serve", config=cfg, summary=summary,
                vocab_padded=92672, steps=steps, useful_positions=900,
                work_positions=1000)


def _summary():
    decode = {"msb_matmul_tc_kernel<64>": 0.2, "msb_experts_kernel": 0.2,
              "paged_attention_split_kernel": 0.15}
    prefill = {"msb_matmul_tc_kernel<64>": 0.1,
               "paged_attention_split_kernel": 0.05}
    return {"window_s": 1.0, "busy_s": 0.7, "idle": {},
            "graph_launch_s": 0.05, "graph_launches": 2,
            "by_name": {"msb_matmul_tc_kernel<64>": 0.3,
                        "msb_experts_kernel": 0.2,
                        "paged_attention_split_kernel": 0.2},
            "by_step": [decode, prefill], "outside_steps_s": 0.0}


METRICS = [(m["name"], w) for m in manifest.load_manifest()["per_layer"]
           for w in m["workloads"][:1]]


def _config(workload):
    return next(w["config"] for w in manifest.load_manifest()["workloads"]
                if w["name"] == workload)


@pytest.mark.parametrize("name,workload", METRICS)
def test_serve_readers_read_a_traced_record(name, workload):
    v = manifest.reader(name)(_record(_summary(), _config(workload)))
    assert isinstance(v, float) and v > 0
    if "_roofline." in name or "share" in name or name.startswith("mfu"):
        assert v <= 100.0
    if name.startswith("useful_position_share"):
        assert v == pytest.approx(90.0)
    if name.startswith("decode_dispatch_ms"):
        assert v == pytest.approx(100.0)
    if name.startswith("graph_launch_host_ms"):
        assert v == pytest.approx(25.0)


@pytest.mark.parametrize("name,workload", METRICS)
def test_serve_readers_without_a_trace(name, workload):
    v = manifest.reader(name)(_record(None, _config(workload)))
    if name.endswith("dispatch_ms.serve") or \
            name.startswith("useful_position_share"):
        assert v is not None     # host spans and counters need no trace
    else:
        assert v is None


def test_step_rooflines_read_their_own_steps():
    """B's decode share reads the decode span's B time against decode
    work, its prefill share the prefill span's; where the prefill spans
    hold no B (a wave moved to another kernel) the prefill share is
    silent, and spans that do not line up with the traced steps give
    nothing."""
    from cardbench import cost
    dec = manifest.reader("paged_attention_roofline.decode")
    pre = manifest.reader("paged_attention_roofline.prefill")
    rec = _record(_summary())
    cfg = rec["config"]
    least = sum(cost.least_seconds(*cost.paged_attention(
        cfg, [300 + j + 1] * 64)) for j in range(8))
    assert dec(rec) == pytest.approx(100 * least / 0.15)
    least = cost.least_seconds(*cost.paged_attention_prefill(
        cfg, [(0, 128)] * 4))
    assert pre(rec) == pytest.approx(100 * least / 0.05)
    summ = _summary()
    del summ["by_step"][1]["paged_attention_split_kernel"]
    assert pre(_record(summ)) is None and dec(_record(summ)) is not None
    summ["by_step"] = summ["by_step"][:1]
    assert dec(_record(summ)) is None
