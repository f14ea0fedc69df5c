"""The operator's work count and its roofline share.

The count depends only on (B, F, P, N, mode, reflecting pairs) and the
precision's peak, never on the engine or the kernels that serve a call.
"""

import json
from pathlib import Path

import pytest
import torch

from hfbench.entries import vertical_forward as e
from hfbench.metrics import operator_roofline
from hfbench.reference import vertical_forward as ref

BENCH = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def _cell(mode, B=3, pool_calls=2):
    cfg = json.loads((BENCH / "configs" / "vh_o200.json").read_text())
    cfg["mode"] = mode
    t = json.loads((BENCH / "traffic" / "single.json").read_text())
    t.update(profiles_per_call=B, pool_calls=pool_calls)
    return cfg, t


@pytest.mark.parametrize("mode", ["O", "X"])
def test_work_is_the_operator_count(mode):
    cfg, t = _cell(mode)
    pool = e.make_pool(cfg, t, 2 ** 33 + 1, CPU)
    B, N = pool.calls[0][0].shape
    F, P = pool.freq.numel(), cfg["n_points"]
    for i in range(t["pool_calls"]):
        valid = int(ref.reflecting_pairs(
            pool.freq64, *pool.ref_calls[i], pool.alt64,
            1.0 if mode == "O" else -1.0).sum())
        assert valid > 0
        ops, nbytes = e.work(cfg, pool, i, 8)
        assert ops == (valid * P * e.OPS_POINT[mode]
                       + B * F * N * e.OPS_NODE[mode])
        assert nbytes == 8 * (3 * B * N + N + F + B * F)
        assert e.work(cfg, pool, i, 4) == (ops, nbytes // 2)


def test_work_ignores_the_engine():
    cfg, t = _cell("O")
    pool = e.make_pool(cfg, t, 7, CPU)
    counts = {eng: e.work(dict(cfg, engine=eng), pool, 0, 8)
              for eng in ("auto", "pallas", "pallas_gather", "parity")}
    assert len(set(counts.values())) == 1


def _summary(kernel_names, busy_us, work=(34e6, 3.35e3)):
    """Two calls of 1,000 µs whose device work is ``busy_us`` split over
    kernels of the given names."""
    calls, device = [], []
    for k in range(2):
        s = 10_000.0 * k
        calls.append((s, s + 1000.0, 0))
        t = s + 100.0
        for name in kernel_names:
            d = busy_us / len(kernel_names)
            device.append((t, t + d, name, "kernel", s + 50.0))
            t += d
    return {"calls": calls, "device": device, "host": [],
            "window": (0.0, 11000.0), "work": {0: work},
            "program_kernels": e.PROGRAM_KERNELS,
            "peak_ops_per_s": 34e12, "peak_bytes_per_s": 3.35e12}


def test_roofline_is_the_same_whichever_kernels_run():
    one = operator_roofline.read(_summary(["ionogram_kernel<double>"], 400))
    two = operator_roofline.read(_summary(
        ["at::native::cummax", "gather_kernel<double>", "mxu"], 400))
    # 34e6 operations at 34 TFLOP/s: 1 µs each call against 400 µs busy
    assert one == pytest.approx(two) == pytest.approx(100 * 1.0 / 400)


def test_roofline_takes_the_larger_bound_and_the_dtype_peak():
    s = _summary(["k"], 10, work=(34e6, 3.35e7))      # bytes bound: 10 µs
    assert operator_roofline.read(s) == pytest.approx(100.0)
    s["peak_ops_per_s"] = 67e12                       # f32: ops bound halves
    s["work"] = {0: (67e6, 0)}
    assert operator_roofline.read(s) == pytest.approx(10.0)


def test_peaks_table_names_both_precisions():
    peaks = json.loads((BENCH / "peaks.json").read_text())
    assert peaks["ops_per_s"] == {"float64": 34e12, "float32": 67e12}
    assert peaks["bytes_per_s"] == 3.35e12
