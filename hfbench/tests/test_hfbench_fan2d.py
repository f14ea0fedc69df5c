"""The 2-D oblique cell ``fan2d_cart.link1500`` found by name, its pool
and work from the seed, the comparison's parting rule and the faults it
catches, the float32 control of its limits, the readers of the oblique
path's spans on hand-built summaries and a traced CPU run, and the imports
of its modules: neither JAX nor the JAX package, and the reference nothing
of the program.
"""

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from hfbench import calibrate_fan, harness, slices
from hfbench.entries import oblique_fan as e
from hfbench.metrics import (fan_fields_ms, fan_pack_ms,
                             oblique_host_reads_per_call)

ROOT = Path(__file__).resolve().parents[2]
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
CPU = torch.device("cpu")
CELL = "fan2d_cart.link1500"
READERS = {"fan_fields_ms": fan_fields_ms, "fan_pack_ms": fan_pack_ms,
           "oblique_host_reads_per_call": oblique_host_reads_per_call}


@pytest.fixture(autouse=True)
def _no_guard(monkeypatch):
    """Other tests of this directory load JAX into the test process."""
    monkeypatch.setattr(harness.guard, "check", lambda when: None)


def _toy(cfg):
    """The configuration at a size a CPU test holds: a 61 × 40 slice,
    4 frequencies × 16 elevations, 200 steps of 20 km."""
    return dict(cfg, z_km=dict(first=0.0, last=600.0, count=61),
                x_km=dict(first=0.0, last=3900.0, count=40),
                freq_mhz=dict(first=4.0, last=16.0, count=4),
                elev_deg=dict(first=5.0, last=85.0, count=16),
                step_km=20.0)


def test_cell_loads_its_configuration_traffic_and_metrics():
    cell = harness.load_cell(CELL)
    cfg, t = cell.cfg, cell.traffic
    assert cell.chips == 1 and cell.entry is e
    assert (cfg["engine"], cfg["dtype"], cfg["mode"], cfg["geometry"]) == (
        "auto", "float64", "O", "cartesian")
    assert cfg["z_km"] == {"first": 0.0, "last": 620.0, "count": 621}
    assert cfg["x_km"] == {"first": 0.0, "last": 3995.0, "count": 800}
    assert cfg["freq_mhz"] == {"first": 4.0, "last": 30.0, "count": 64}
    assert cfg["elev_deg"] == {"first": 5.0, "last": 85.0, "count": 128}
    assert e.n_steps(cfg) == 2000 and cfg["reduced"] == []
    assert set(cfg["limits"]) == {"max_drange_km", "max_ddelay_us"}
    assert all(isinstance(v, float) and v > 0
               for v in cfg["limits"].values())
    assert (t["profiles_per_call"], t["pool_calls"], t["check_rows"],
            t["ground_range_km"], t["e_layer_slices"]) == (1, 16, 2,
                                                           1500.0, 4)
    names = [m["name"] for m in cell.per_layer]
    assert names == [m["name"] for m in MAN["per_layer"]
                     if CELL in m.get("workloads", [CELL])]
    assert set(READERS) <= set(names) and len(names) == 9
    assert {m["name"] for m in cell.end_to_end} == {
        "calls_per_s", "peak_mem_gib", "setup_s"}


def test_pool_follows_the_seed():
    cfg = _toy(harness.load_cell(CELL).cfg)
    t = dict(harness.load_cell(CELL).traffic, pool_calls=3,
             e_layer_slices=1)
    a, b, c = (e.make_pool(cfg, t, s, CPU)
               for s in (2 ** 40 + 3, 2 ** 40 + 3, 2 ** 40 + 4))
    for x, y, z in zip(a.calls, b.calls, c.calls):
        assert all(torch.equal(p, q) for p, q in zip(x, y))
        assert not torch.equal(x[0], z[0])
    assert a.calls[0][0].shape == (61, 40)
    assert a.calls[0][0].dtype == torch.float64
    f32 = e.make_pool(cfg, t, 2 ** 40 + 3, CPU, dtype="float32")
    assert f32.calls[0][0].dtype == torch.float32
    assert torch.equal(f32.ref_calls[0][0], a.ref_calls[0][0])


def test_every_seed_gets_the_same_peak_densities():
    """The 2·n ends of n slices take the midpoints of 2·n log strata of
    NmF2, in another order for every seed."""
    z = torch.linspace(0.0, 600.0, 601, dtype=torch.float64)
    x = torch.linspace(0.0, 3900.0, 2, dtype=torch.float64)
    peaks = [torch.sort(slices.slices(8, 0, s, z, x, CPU)[0].amax(1)
                        .reshape(-1)).values for s in (1, 2 ** 35)]
    # the grid's 1 km nodes sample each peak within 0.1% of NmF2
    assert torch.allclose(peaks[0], peaks[1], rtol=2e-3)


def test_work_is_about_the_same_from_seed_to_seed():
    """Bytes are fixed by the shapes; the operations follow the slices'
    peaks, which every seed draws from the same strata: the pool's total
    stays within 10% from seed to seed."""
    cell = harness.load_cell(CELL)
    cfg = _toy(cell.cfg)
    tot = []
    for seed in (1, 2 ** 35):
        pool = e.make_pool(cfg, cell.traffic, seed, CPU)
        w = [e.work(cfg, pool, i, 8) for i in range(16)]
        assert {b for _, b in w} == {8 * (3 * 61 * 40 + 61 + 4 + 16
                                          + 5 * 4 * 16)}
        assert e.work(cfg, pool, 0, 4)[1] * 2 == w[0][1]
        tot.append(sum(a for a, _ in w))
        steps = pool.ref_out[0]["steps_taken"]
        assert w[0][0] == int(steps.sum()) * e.ref.OPS_STEP > 0
    assert abs(tot[0] - tot[1]) < 0.1 * max(tot)


def _fake_pool(ranges, delays):
    """A pool whose reference results are given: entry 0's ranges [F, E]
    and homed (low, high) delays [2, F]."""
    pool = e.Pool(None, None, None, 0.0, [None], [None])
    pool.ref_out[0] = {"ground_range_km": ranges,
                       "delay_low_sec": delays[0],
                       "delay_high_sec": delays[1]}
    return pool


def test_compare_parts_a_ray_landed_on_one_side_only():
    nan = math.nan
    rng = torch.tensor([[1500.0, 1200.0, nan, nan]], dtype=torch.float64)
    dl = torch.tensor([[5e-3], [6e-3]], dtype=torch.float64)
    pool = _fake_pool(rng, dl)
    cfg = {"limits": {"max_drange_km": 1e-3, "max_ddelay_us": 1e-3}}
    f64 = dict(dtype=torch.float64)
    out = {"fan_range_km": torch.tensor([[1500.0 + 1e-4, nan, 900.0, nan]],
                                        **f64),
           "delay_low_sec": torch.tensor([5e-3 + 2e-12], **f64),
           "delay_high_sec": torch.tensor([nan], **f64)}
    rows = {0: torch.tensor([0])}
    checks, parted = e.compare(cfg, pool, {0: out}, rows)
    # the ray landed in the reference only counts its whole 1200 km, the
    # one landed in the program only its 900 km; both NaN count 0
    assert checks["max_drange_km"] == (pytest.approx(1200.0), 1e-3)
    assert parted == 2
    # the high delay NaN in the program counts the reference's 6 ms
    assert checks["max_ddelay_us"][0] == pytest.approx(6e3)
    out.update(fan_range_km=rng.clone(), delay_high_sec=dl[1].clone())
    checks, parted = e.compare(cfg, pool, {0: out}, rows)
    assert parted == 0 and checks["max_drange_km"][0] == 0.0
    assert checks["max_ddelay_us"][0] == pytest.approx(2e-6, rel=1e-3)


def _summary(reads_inside=1, spans=True):
    """Two traced calls of 10,000 µs: oblique 100–9,900, fields 200–
    2,000 (two kernels launched inside, 300 and 200 µs), pack 2,100–
    2,500 (one kernel, 150 µs), launch 2,600–2,800 (the fan kernel,
    5,000 µs) and a read in it, homing 8,000–9,000 (one kernel, 50 µs);
    a read outside the oblique span at 9,950 µs."""
    calls, host, device = [], [], []
    for k in range(2):
        t0 = 20_000.0 * k
        calls.append((t0, t0 + 10_000.0, k))
        host += [(t0, t0 + 10_000.0, f"hfbench.call#{k}"),
                 (t0 + 9_950.0, t0 + 9_960.0, "pyrayhf.host_read")]
        if spans:
            host += [(t0 + 100.0, t0 + 9_900.0, "pyrayhf.oblique"),
                     (t0 + 200.0, t0 + 2_000.0, "pyrayhf.fan_fields"),
                     (t0 + 2_100.0, t0 + 2_500.0, "pyrayhf.fan_pack"),
                     (t0 + 2_600.0, t0 + 2_800.0, "pyrayhf.fan_launch"),
                     (t0 + 8_000.0, t0 + 9_000.0, "pyrayhf.homing")]
            host += [(t0 + 2_700.0 + j, t0 + 2_701.0 + j,
                      "pyrayhf.host_read") for j in range(reads_inside)]
        for launch, start, dur, name in (
                (300.0, 2_000.0, 300.0, "elementwise"),
                (1_900.0, 2_300.0, 200.0, "elementwise"),
                (2_200.0, 2_600.0, 150.0, "cat"),
                (2_750.0, 2_800.0, 5_000.0, "fan2d_kernel<double>"),
                (8_500.0, 8_500.0 + 5_000.0, 50.0, "where")):
            device.append((t0 + start, t0 + start + dur, name, "kernel",
                           t0 + launch))
    return {"calls": calls, "device": sorted(device), "host": sorted(host),
            "window": (0.0, 30_000.0)}


def test_readers_on_known_spans():
    s = _summary(reads_inside=1)
    assert fan_fields_ms.read(s) == pytest.approx(0.5)
    assert fan_pack_ms.read(s) == pytest.approx(0.15)
    # the read after the oblique span is not the entry's
    assert oblique_host_reads_per_call.read(s) == pytest.approx(1.0)
    assert oblique_host_reads_per_call.read(_summary(0)) == 0


def test_readers_without_the_spans_or_the_card():
    for m in READERS.values():
        assert m.read(_summary(spans=False)) is None
    s = dict(_summary(), device=[])
    assert fan_fields_ms.read(s) is None and fan_pack_ms.read(s) is None
    assert oblique_host_reads_per_call.read(s) == pytest.approx(1.0)


def test_traced_cpu_run_is_correct_and_reads_no_host_read():
    cell = harness.load_cell(CELL)
    cell.cfg = dict(cell.cfg, z_km=dict(first=0.0, last=600.0, count=41),
                    x_km=dict(first=0.0, last=3800.0, count=20),
                    freq_mhz=dict(first=4.0, last=12.0, count=2),
                    elev_deg=dict(first=5.0, last=60.0, count=6),
                    step_km=100.0, s_max_km=1500.0)
    cell.traffic = dict(cell.traffic, pool_calls=3, e_layer_slices=1,
                        ground_range_km=600.0)
    # small calls and a window that holds more traced calls than the
    # summary leaves out (the profiler's start-up lands in those)
    r = harness.run(cell, 2 ** 34 + 13, 4.0, True, CPU, time.perf_counter())
    assert r["correct"] is True
    assert r["metrics"]["oblique_host_reads_per_call"]["value"] == 0
    assert set(r["checks"]) == {"max_drange_km", "max_ddelay_us"}


def _small_cell():
    """The cell at a size a CPU test holds: a 41 × 20 slice, 2 frequencies
    × 12 elevations, 50 steps, a 600 km link that both frequencies reach,
    3 slices of which one has an E layer."""
    cell = harness.load_cell(CELL)
    cell.cfg = dict(cell.cfg, z_km=dict(first=0.0, last=600.0, count=41),
                    x_km=dict(first=0.0, last=3800.0, count=20),
                    freq_mhz=dict(first=4.0, last=12.0, count=2),
                    elev_deg=dict(first=5.0, last=60.0, count=12),
                    step_km=30.0, s_max_km=1500.0)
    cell.traffic = dict(cell.traffic, pool_calls=3, e_layer_slices=1,
                        ground_range_km=600.0)
    return cell


def test_result_line():
    cell = _small_cell()
    r = harness.run(cell, 2 ** 34 + 5, 0.3, False, CPU, time.perf_counter())
    assert list(r) == ["correct", "attempted", "failed", "metrics",
                       "device", "checks"]
    assert r["correct"] is True and r["attempted"] > 0 and r["failed"] == 0
    assert set(r["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(set(v) == {"value", "limit"} for v in r["checks"].values())
    json.dumps(r)


def _altered(i, out):
    """Every frequency's first landed ray moved by 1e-2 km."""
    rng = out["fan_range_km"].clone()
    k = torch.argmax((~torch.isnan(rng)).to(torch.int8), dim=1)
    rng[torch.arange(rng.shape[0]), k] += 1e-2
    return dict(out, fan_range_km=rng)


def _half_left_out(i, out):
    """The upper half of the frequencies never traced (NaN)."""
    rng = out["fan_range_km"].clone()
    rng[rng.shape[0] // 2:] = math.nan
    return dict(out, fan_range_km=rng)


def _landing_lost(i, out):
    """The highest landed elevation of every frequency reported lost."""
    rng = out["fan_range_km"].clone()
    fin = ~torch.isnan(rng)
    k = fin.shape[1] - 1 - torch.argmax(fin.flip(1).to(torch.int8), dim=1)
    rng[torch.arange(rng.shape[0]), k] = math.nan
    return dict(out, fan_range_km=rng)


@pytest.mark.parametrize("fault", [_altered, _half_left_out,
                                   _landing_lost])
def test_faults_make_correct_false(fault):
    """A fault in the fan of ranges alone, the homed delays left as they
    are, parts the program from the reference."""
    r = harness.run(_small_cell(), 2 ** 34 + 7, 0.3, False, CPU,
                    time.perf_counter(), fault=fault)
    assert r["correct"] is False


@pytest.mark.parametrize("seed", [2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13])
def test_float32_fails_and_float64_passes(seed):
    """The control of ``correct``: the program in float32, the nearest
    precision below the configuration's float64, fails the cell's limits
    and the program in float64 meets them, through the fan kernel's plain
    PyTorch version (``engine="pallas"`` on CPU tensors) on 2 of 3
    slices. ``hfbench/calibrate_fan.py`` reads the same on the card at the
    cell's own size."""
    cell = harness.load_cell(CELL)
    cfg = dict(_toy(cell.cfg), engine="pallas")
    t = dict(cell.traffic, pool_calls=3, e_layer_slices=1)
    lim = cfg["limits"]
    r64, r32 = (calibrate_fan.readings(e, cfg, t, seed, dt, CPU)["checks"]
                for dt in ("float64", "float32"))
    assert all(r64[k] <= lim[k] for k in lim), r64
    assert any(r32[k] > lim[k] for k in lim), r32


def _fresh(code):
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)


def test_oblique_reference_imports_nothing_of_the_program():
    r = _fresh("import sys\n"
               "from hfbench.reference import oblique_fan\n"
               "print(sorted({m.split('.')[0] for m in sys.modules}\n"
               "      & {'jax', 'jaxlib', 'pyrayhf_tpu',\n"
               "         'pyrayhf_tpu_torch'}))\n")
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


def test_oblique_modules_load_neither_jax_nor_the_jax_package():
    """The oblique cell's entry, generator, reference, span readers and
    calibration, with the program's entry called on the CPU at a toy
    size and compared, in a fresh process."""
    r = _fresh(
        "import json, sys, torch\n"
        "from hfbench import calibrate_fan, oblique_spans, slices\n"
        "from hfbench.entries import oblique_fan as e\n"
        "from hfbench.metrics import (fan_fields_ms, fan_pack_ms,\n"
        "    oblique_host_reads_per_call)\n"
        "cfg = json.load(open('hfbench/configs/fan2d_cart.json'))\n"
        "cfg.update(z_km=dict(first=0.0, last=600.0, count=21),\n"
        "           x_km=dict(first=0.0, last=3800.0, count=8),\n"
        "           freq_mhz=dict(first=5.0, last=8.0, count=2),\n"
        "           elev_deg=dict(first=5.0, last=60.0, count=6),\n"
        "           step_km=100.0, s_max_km=1500.0)\n"
        "t = dict(json.load(open('hfbench/traffic/link1500.json')),\n"
        "         pool_calls=1, e_layer_slices=0)\n"
        "pool = e.make_pool(cfg, t, 1, torch.device('cpu'))\n"
        "out = e.call(cfg, pool, 0)\n"
        "e.compare(cfg, pool, {0: out}, {0: torch.tensor([0])})\n"
        "from hfbench import guard\n"
        "print(guard.forbidden_loaded(),\n"
        "      'pyrayhf_tpu_torch' in sys.modules)\n")
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["[]", "True"]
