"""The X-mode cell ``vh_x20k.batch32`` found by name, and the kernels'
share of the roofline (``kernel_roofline``) on hand-built summaries."""

import json
from pathlib import Path

import pytest

from hfbench import harness
from hfbench.entries import vertical_forward as e
from hfbench.metrics import kernel_roofline, operator_roofline

ROOT = Path(__file__).resolve().parents[2]
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_x20k_cell_loads_its_configuration_traffic_and_metrics():
    cell = harness.load_cell("vh_x20k.batch32")
    assert cell.chips == 1
    assert (cell.cfg["mode"], cell.cfg["n_points"], cell.cfg["dtype"],
            cell.cfg["engine"]) == ("X", 20000, "float64", "auto")
    assert cell.cfg["freq_mhz"] == {"first": 0.1, "step": 0.1, "count": 174}
    assert cell.cfg["alt_km"] == {"first": 80.0, "last": 699.0,
                                  "count": 620}
    assert cell.cfg["reduced"] == []
    assert (cell.traffic["profiles_per_call"], cell.traffic["pool_calls"],
            cell.traffic["sites"]) == (32, 32, "random")
    names = [m["name"] for m in cell.per_layer]
    assert len(names) == 11 and names == [m["name"]
                                          for m in MAN["per_layer"]]
    assert "kernel_roofline" in names
    assert {m["name"] for m in cell.end_to_end} == {
        "calls_per_s", "peak_mem_gib", "setup_s"}


def _summary(kernels, work=(34e6, 3.35e3)):
    """Two calls of 1,000 µs, each running ``kernels`` [(name, µs)] one
    after another on the card."""
    calls, device = [], []
    for k in range(2):
        s = 10_000.0 * k
        calls.append((s, s + 1000.0, 0))
        t = s + 100.0
        for name, d in kernels:
            device.append((t, t + d, name, "kernel", s + 50.0))
            t += d
    return {"calls": calls, "device": device, "host": [],
            "window": (0.0, 11000.0), "work": {0: work},
            "program_kernels": e.PROGRAM_KERNELS,
            "peak_ops_per_s": 34e12, "peak_bytes_per_s": 3.35e12}


@pytest.mark.parametrize("kernel", ["void gather_kernel<double, -1, true>",
                                    "ionogram_kernel<double, 1, true, true>"])
def test_kernel_roofline_is_the_operators_with_only_program_kernels(kernel):
    s = _summary([(kernel, 400.0)])
    # 34e6 operations at 34 TFLOP/s: 1 µs a call against 400 µs of kernel
    assert kernel_roofline.read(s) == pytest.approx(100 * 1.0 / 400)
    assert kernel_roofline.read(s) == pytest.approx(operator_roofline.read(s))


def test_kernel_roofline_leaves_the_prep_out():
    s = _summary([("segment_table_pack<double>", 100.0),
                  ("gather_kernel<double, -1, true>", 400.0),
                  ("at::native::reduce_kernel", 20.0)])
    assert operator_roofline.read(s) == pytest.approx(100 * 1.0 / 520)
    assert kernel_roofline.read(s) == pytest.approx(100 * 1.0 / 400)
    assert kernel_roofline.read(s) > operator_roofline.read(s)


def test_kernel_roofline_reads_none_without_a_program_kernel():
    assert kernel_roofline.read(_summary([("segment_table_pack<double>",
                                           100.0)])) is None
    s = _summary([])
    assert kernel_roofline.read(s) is None
