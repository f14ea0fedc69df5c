"""The harness's data path on the CPU: manifests found by name, inputs
from the seed, the window's arithmetic, the trace reduction, the result
line, and ``correct`` coming out false under each fault a cell can have.

The runs here skip the harness's look for a card (``run.py`` makes it)
and drive the rest of a run at a small size on the CPU, where the
operator's ``auto`` engine runs its plain PyTorch path.
"""

import importlib
import json
import math
import time
from pathlib import Path

import pytest
import torch

from hfbench import harness, inputs, timeline
from hfbench.metrics import device_idle_pct, host_ms_per_call

ROOT = Path(__file__).resolve().parents[2]
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _no_guard(monkeypatch):
    """The reference's tests load JAX into this test process; the guard
    has tests of its own (``test_hfbench_imports.py``) and a run's own
    process holds no JAX."""
    monkeypatch.setattr(harness.guard, "check", lambda when: None)


@pytest.mark.parametrize("w", [w["name"] for w in MAN["workloads"]])
def test_cells_found_by_name(w):
    cell = harness.load_cell(w)
    for k in ("call", "make_pool", "compare", "work", "counters", "setup"):
        assert callable(getattr(cell.entry, k))
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    assert set(cell.cfg["limits"]) == {"max_dvh_km"}


@pytest.mark.parametrize("m", MAN["per_layer"], ids=lambda m: m["name"])
def test_metric_readers_found_by_name(m):
    mod = importlib.import_module(f"hfbench.metrics.{m['name']}")
    assert callable(mod.read)
    assert m["moves"] in {e["name"] for e in MAN["end_to_end"]}


def test_configs_name_their_files():
    for c in MAN["configs"]:
        assert (ROOT / c["file"]).is_file()
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]


def test_inputs_follow_the_seed():
    t = {"profiles_per_call": 6, "pool_calls": 2, "sites": "random",
         "e_layer_share": 0.25}
    alt = torch.linspace(80.0, 699.0, 620, dtype=torch.float64)
    a = inputs.profiles(t, 2 ** 40 + 3, alt, CPU)
    b = inputs.profiles(t, 2 ** 40 + 3, alt, CPU)
    c = inputs.profiles(t, 2 ** 40 + 4, alt, CPU)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not any(torch.equal(x, y) for x, y in zip(a, c))


def test_every_seed_gets_the_same_peak_densities():
    alt = torch.linspace(80.0, 699.0, 620, dtype=torch.float64)
    peaks = []
    for seed in (1, 2 ** 35):
        g = inputs.generator(seed, CPU)
        den = inputs.chapman_profiles(g, 64, alt, 0.0)
        peaks.append(torch.sort(den.amax(1)).values)
    # the grid's 1 km nodes sample each peak within 0.1% of NmF2
    assert torch.allclose(peaks[0], peaks[1], rtol=2e-3)


def test_global_sites_are_the_2p5_degree_grid():
    lat, lon = inputs.global_sites(73, 144, CPU)
    assert lat.numel() == 10512
    assert float(lat[0]) == -90.0 and float(lat[-1]) == 90.0
    assert float(lon[1] - lon[0]) == 2.5


def test_dipole_field_is_steepest_at_the_poles():
    alt = torch.tensor([80.0, 400.0], dtype=torch.float64)
    lat = torch.tensor([inputs.POLE_LAT_DEG, 0.0], dtype=torch.float64)
    lon = torch.tensor([inputs.POLE_LON_DEG, inputs.POLE_LON_DEG + 180.0],
                       dtype=torch.float64)
    bmag, psi = inputs.dipole(lat, lon, alt)
    assert float(psi[0, 0]) == pytest.approx(0.0, abs=1e-9)
    assert float(bmag[0, 0]) > float(bmag[0, 1]) > 0
    assert 0.0 < float(psi[1, 0]) < 90.0


class FakeClock:
    """A clock that each call advances by its duration."""

    def __init__(self, durations):
        self.t = 0.0
        self.d = iter(durations)

    def __call__(self):
        return self.t

    def call(self, i):
        self.t += next(self.d)
        return i


@pytest.mark.parametrize("stall", [0.0, 0.5])
def test_window_arithmetic(stall):
    # 200 calls of 10 ms, one of them stalled by ``stall`` seconds
    d = [0.01] * 200
    d[100] += stall
    clk = FakeClock(d)
    spans, last = harness.closed_loop(clk.call, [0, 1], 1.995 + stall,
                                      lambda: None, clock=clk)
    assert len(spans) == 200 and set(last) == {0, 1}
    assert harness.calls_per_s(spans) == pytest.approx(
        200 / (2.0 + stall))


def test_stalls_move_rate_and_tail():
    def loop(stalls):
        d = [0.01] * 200
        for k in stalls:
            d[k] += 0.1
        clk = FakeClock(d)
        spans, _ = harness.closed_loop(clk.call, [0], sum(d) - 0.005,
                                       lambda: None, clock=clk)
        return harness.calls_per_s(spans), harness.latency_ms(spans, 0.95)

    r0, p0 = loop([])
    r1, p1 = loop(range(0, 200, 10))
    assert r1 < 0.6 * r0 and p1 > 5 * p0


def _trace(stall_us, skew_us=0.0):
    """Two calls of 1 ms on the card each; a host stall of ``stall_us``
    inside the second, before its kernel; the card's clock ``skew_us``
    ahead of the host's."""
    k = "void ionogram_kernel<double, 1>(Params)"
    calls = [(0.0, 1000.0, 0), (2000.0, 3000.0 + stall_us, 1)]
    device = [(100.0 + skew_us, 900.0 + skew_us, k, "kernel", 50.0),
              (2100.0 + stall_us + skew_us, 2900.0 + stall_us + skew_us,
               k, "kernel", 2050.0 + stall_us)]
    host = [(0.0, 1000.0, "hfbench.call#0"), (2000.0, 3000.0 + stall_us,
                                              "hfbench.call#1"),
            (2010.0, 2090.0 + stall_us, "aten::copy_")]
    return {"calls": calls, "device": device, "host": host,
            "window": (0.0, 3000.0 + stall_us)}


def test_trace_reduction_shows_a_stall():
    base, slow = _trace(0.0), _trace(5000.0)
    assert host_ms_per_call.read(slow) - host_ms_per_call.read(base) == \
        pytest.approx(2.5)
    assert device_idle_pct.read(slow) > device_idle_pct.read(base)
    gaps = dict(timeline.idle_gaps(slow))
    # the gap from the first kernel's end to the second's start, named by
    # the host event running at its middle
    assert gaps["aten::copy_"] == pytest.approx(6200e-6)
    ops = timeline.device_ops(base)
    assert ops == [["ionogram_kernel<double, 1>", pytest.approx(1600e-6)]]


def test_device_events_follow_their_launch():
    """A card clock 300 µs ahead moves no kernel out of its call."""
    a, b = _trace(0.0), _trace(0.0, skew_us=300.0)
    for m in (host_ms_per_call, device_idle_pct):
        assert m.read(a) == pytest.approx(m.read(b))


def test_union_and_cover():
    assert timeline.union([(0, 2), (1, 3), (5, 6)]) == [(0, 3), (5, 6)]
    assert timeline.covered([(0, 2), (1, 3), (5, 6)], 1, 5.5) == 2.5


def _small_cell(name, trace_rows=None):
    cell = harness.load_cell(name)
    t = dict(cell.traffic)
    if t["sites"] == "global":
        t.update(profiles_per_call=24, grid=[4, 6], pool_calls=2,
                 check_rows=24)
    else:
        t.update(pool_calls=6, check_rows=6)
    cell.traffic = t
    return cell


@pytest.mark.parametrize("w", [w["name"] for w in MAN["workloads"]])
def test_result_line(w):
    cell = _small_cell(w)
    r = harness.run(cell, 2 ** 34 + 5, 0.3, False, CPU, time.perf_counter())
    assert list(r) == ["correct", "attempted", "failed", "metrics",
                       "device", "checks"]
    assert r["correct"] is True and r["attempted"] > 0 and r["failed"] == 0
    assert set(r["metrics"]) == {m["name"] for m in cell.end_to_end}
    for k in ("platform", "kind", "count", "memory_peak_bytes"):
        assert k in r["device"]
    assert all(set(v) == {"value", "limit"} for v in r["checks"].values())
    json.dumps(r)


def test_traced_run_on_the_cpu_keeps_correct():
    cell = _small_cell(MAN["workloads"][-1]["name"])
    r = harness.run(cell, 2 ** 34 + 6, 0.5, True, CPU, time.perf_counter())
    assert r["correct"] is True and list(r)[-1] == "checks"


def _altered(i, out):
    """Every row's first finite answer moved by 1e-2 km."""
    out = out.clone()
    k = torch.argmax((~torch.isnan(out)).to(torch.int8), dim=1)
    out[torch.arange(out.shape[0]), k] += 1e-2
    return out


def _half_left_out(i, out):
    """Half of the batch's rows never computed (NaN); with one row a
    call, every second call's."""
    out = out.clone()
    B = out.shape[0]
    if B > 1:
        out[B // 2:] = math.nan
    elif i % 2:
        out[:] = math.nan
    return out


def _escape_flipped(i, out):
    """The highest reflecting frequency of every row reported escaped."""
    out = out.clone()
    fin = ~torch.isnan(out)
    k = fin.shape[1] - 1 - torch.argmax(fin.flip(1).to(torch.int8), dim=1)
    out[torch.arange(out.shape[0]), k] = math.nan
    return out


@pytest.mark.parametrize("fault", [_altered, _half_left_out,
                                   _escape_flipped])
@pytest.mark.parametrize("w", [w["name"] for w in MAN["workloads"]])
def test_faults_make_correct_false(w, fault):
    cell = _small_cell(w)
    r = harness.run(cell, 2 ** 34 + 7, 0.3, False, CPU, time.perf_counter(),
                    fault=fault)
    assert r["correct"] is False
