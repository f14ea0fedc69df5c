"""The readers of the program's own spans (``hfbench/spans.py`` and the
five metrics that read it), on hand-built summaries with known spans, and
on a traced run of the harness at a small size on the CPU.
"""

import json
import time
from pathlib import Path

import pytest
import torch

from hfbench import harness, spans
from hfbench.metrics import (entry_self_ms, host_reads_per_call,
                             launch_host_ms, prep_host_ms, route_host_ms)

ROOT = Path(__file__).resolve().parents[2]
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
READERS = {"route_host_ms": route_host_ms,
           "host_reads_per_call": host_reads_per_call,
           "entry_self_ms": entry_self_ms,
           "prep_host_ms": prep_host_ms,
           "launch_host_ms": launch_host_ms}


@pytest.fixture(autouse=True)
def _no_guard(monkeypatch):
    """Other tests of this directory load JAX into the test process."""
    monkeypatch.setattr(harness.guard, "check", lambda when: None)


def _call(t0, entry, read=True):
    """One call of 1,000 µs from ``t0``: forward 100–900, route 100–300
    (a host read 200–250 inside it), prep 350–650, launch 700–800."""
    host = [(t0, t0 + 1000.0, f"hfbench.call#{entry}"),
            (t0 + 100.0, t0 + 900.0, "pyrayhf.forward"),
            (t0 + 100.0, t0 + 300.0, "pyrayhf.route"),
            (t0 + 350.0, t0 + 650.0, "pyrayhf.prep"),
            (t0 + 360.0, t0 + 380.0, "aten::cat"),
            (t0 + 700.0, t0 + 800.0, "pyrayhf.launch")]
    if read:
        host.append((t0 + 200.0, t0 + 250.0, "pyrayhf.host_read"))
    return (t0, t0 + 1000.0, entry), host


def _summary(*reads):
    calls, host = [], []
    for k, read in enumerate(reads):
        c, h = _call(2000.0 * k, k, read)
        calls.append(c)
        host += h
    return {"calls": calls, "device": [], "host": sorted(host),
            "window": (calls[0][0], calls[-1][1])}


def test_readers_on_known_spans():
    s = _summary(True, False)
    assert route_host_ms.read(s) == pytest.approx(0.2)
    assert prep_host_ms.read(s) == pytest.approx(0.3)
    assert launch_host_ms.read(s) == pytest.approx(0.1)
    # forward 800 µs less route, prep and launch (the read lies in route)
    assert entry_self_ms.read(s) == pytest.approx(0.2)
    assert host_reads_per_call.read(s) == pytest.approx(0.5)
    parts = sum(READERS[k].read(s) for k in ("route_host_ms", "prep_host_ms",
                                             "launch_host_ms",
                                             "entry_self_ms"))
    assert parts == pytest.approx(0.8)


def test_calls_without_a_read_read_zero_reads():
    assert host_reads_per_call.read(_summary(False, False)) == 0


def test_a_span_belongs_to_the_call_holding_its_start():
    s = _summary(True, True)
    # a span of the profiler's start-up, before the first traced call
    s["host"] = sorted(s["host"] + [(-500.0, -100.0, "pyrayhf.route")])
    assert route_host_ms.read(s) == pytest.approx(0.2)
    assert [len(c) for c in spans.per_call(s)] == [5, 5]


@pytest.mark.parametrize("name", sorted(READERS))
def test_no_program_spans_read_none(name):
    s = _summary(True, True)
    s["host"] = [h for h in s["host"] if h[2] != "pyrayhf.forward"]
    assert READERS[name].read(s) is None
    s["host"] = [h for h in s["host"] if not h[2].startswith("pyrayhf.")]
    assert READERS[name].read(s) is None


def test_the_five_metrics_are_in_the_benchmark():
    got = {m["name"]: m for m in MAN["per_layer"] if m["name"] in READERS}
    assert set(got) == set(READERS)
    for m in got.values():
        assert m["source"] == "device_trace" and m["moves"] == "calls_per_s"
        assert m["workloads"] == ["vh_o200.global", "vh_o200.single"]


def test_traced_cpu_run_reports_the_span_metrics():
    cell = harness.load_cell("vh_o200.single")
    # a small call, so that the window holds more than the calls the
    # summary leaves out (the profiler's first call on the CPU takes ~1 s)
    cell.cfg = dict(cell.cfg, n_points=64,
                    freq_mhz=dict(cell.cfg["freq_mhz"], count=16))
    cell.traffic = dict(cell.traffic, pool_calls=6, check_rows=6)
    r = harness.run(cell, 2 ** 34 + 11, 2.5, True, torch.device("cpu"),
                    time.perf_counter())
    assert r["correct"] is True
    for name in READERS:
        assert r["metrics"][name]["value"] is not None, name
    # CPU tensors: the plain path reads nothing from a card
    assert r["metrics"]["host_reads_per_call"]["value"] == 0
    assert r["metrics"]["route_host_ms"]["value"] > 0
