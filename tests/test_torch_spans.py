"""The program's spans (``pyrayhf_tpu_torch.profiling.span``) on the CPU.

With the profiler off a span is one shared no-op; with it on, a call of
``vertical_forward_operator_batch`` records ``pyrayhf.forward`` around its
``pyrayhf.route`` and, on the kernel engines, ``pyrayhf.prep``, and a call
of ``synthesize_oblique_ionogram_2d`` records ``pyrayhf.oblique`` around
``pyrayhf.fan_fields``, ``pyrayhf.fan_pack``, ``pyrayhf.fan_launch`` and
``pyrayhf.homing``. None moves a bit of the output, under ``torch.func``
transforms too. The port is held against itself here, at a toy size (B =
2, 48 nodes, 8 frequencies; a 41 × 20 slice); the card's spans
(``pyrayhf.launch``, ``pyrayhf.host_read``, the fan kernel's launch) are
checked in ``tests/test_torch_gpu_kernels.py``.
"""

import contextlib
import re
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from pyrayhf_tpu_torch import profiling
from pyrayhf_tpu_torch.forward import vertical_forward_operator_batch

from _torch_threads import one_torch_thread  # noqa: F401

PERF_MD = Path(__file__).resolve().parents[1] / "PERF.md"
CPU_ONLY = [torch.profiler.ProfilerActivity.CPU]


def _inputs(B=2, n_alt=48):
    alt = np.linspace(100.0, 500.0, n_alt)
    peak = np.array([[280.0], [320.0]])[:B]
    den = 1.2e12 * np.exp(-((alt - peak) / 60.0) ** 2)
    freq = np.arange(1.0, 9.0)
    return [torch.as_tensor(a, dtype=torch.float64)
            for a in (freq, den, np.full_like(den, 5e-5),
                      np.full_like(den, 60.0), alt)]


def _bits(t):
    return t.detach().contiguous().view(torch.int64)


def _traced(fn):
    """``fn()`` under a CPU profiler: (its output, the profiler's events)."""
    with torch.profiler.profile(activities=CPU_ONLY) as prof:
        out = fn()
    return out, prof.events()


def test_span_is_the_shared_noop_with_the_profiler_off():
    assert not torch._C._autograd._profiler_enabled()
    a, b = profiling.span("pyrayhf.forward"), profiling.span("pyrayhf.prep")
    assert a is b and isinstance(a, contextlib.nullcontext)
    with torch.profiler.profile(activities=CPU_ONLY):
        assert profiling.span("pyrayhf.forward") is not a


@pytest.mark.parametrize("engine", ["pallas_gather", "auto"])
def test_outputs_bit_identical_with_the_profiler_on_and_off(engine):
    xs = _inputs()

    def call():
        return vertical_forward_operator_batch(*xs, mode="O", n_points=64,
                                               engine=engine)

    off = call()
    on, _ = _traced(call)
    assert torch.isfinite(off).any()
    assert torch.equal(_bits(on), _bits(off))


@pytest.mark.parametrize("mode", ["O", "X"])
def test_spans_of_one_cpu_gather_call(mode):
    """A call through the gather engine (kernel 1's or kernel 2's plain
    version on CPU tensors) records the route, then the prep, inside the
    forward span; the launch span is the card's."""
    from pyrayhf_tpu_torch import pallas_vh
    xs = _inputs()
    pallas_vh.reset_counters()
    out, events = _traced(lambda: vertical_forward_operator_batch(
        *xs, mode=mode, n_points=64, engine="pallas_gather"))
    kind = "gather_osolve" if mode == "O" else "gather_xsolve"
    assert pallas_vh.PLAIN_CALLS[kind] == 1
    assert torch.isfinite(out).any()
    ours = [e for e in events if e.name.startswith("pyrayhf.")]
    names = sorted(e.name for e in ours)
    # the plain version runs on CPU tensors: no launch, no read from a card
    assert names == ["pyrayhf.forward", "pyrayhf.prep", "pyrayhf.route"]
    rng = {e.name: (e.time_range.start, e.time_range.end) for e in ours}
    lo, hi = rng["pyrayhf.forward"]
    for k in ("pyrayhf.route", "pyrayhf.prep"):
        assert lo <= rng[k][0] <= rng[k][1] <= hi
    assert rng["pyrayhf.route"][1] <= rng["pyrayhf.prep"][0]


@pytest.mark.parametrize("transform", ["vmap", "jacrev"])
def test_transforms_through_the_gather_entry_with_the_profiler_on(transform):
    freq, den, bmag, bpsi, alt = _inputs()

    def vh(d, b, p):
        return vertical_forward_operator_batch(freq, d, b, p, alt, mode="O",
                                               n_points=64,
                                               engine="pallas_gather")

    if transform == "vmap":
        stack = [torch.stack([x, 0.9 * x]) for x in (den, bmag, bpsi)]

        def run():
            return torch.func.vmap(vh)(*stack)
    else:
        def run():
            return torch.func.jacrev(lambda p: vh(den, bmag, p))(bpsi)

    off = run()
    with torch.profiler.profile(activities=CPU_ONLY):
        on = run()
    assert torch.isfinite(off).any()
    assert torch.equal(_bits(on), _bits(off))


def _oblique_call(engine):
    """A toy 2-D oblique ionogram on CPU tensors: a 41 × 20 Chapman slice
    with a horizontal gradient, 2 frequencies × 12 elevations, 50 steps;
    the 600 km link homes at both."""
    from pyrayhf_tpu_torch.oblique import synthesize_oblique_ionogram_2d
    z, x = np.linspace(0.0, 600.0, 41), np.linspace(0.0, 3800.0, 20)
    h = (z[:, None] - 280.0) / 50.0
    ne = (1e12 * (1.0 + 0.2 * x[None, :] / x[-1])
          * np.exp(0.5 * (1.0 - h - np.exp(-h))))
    t = [torch.as_tensor(a, dtype=torch.float64)
         for a in (ne, np.full_like(ne, 4.5e-5), np.full_like(ne, 60.0))]
    return synthesize_oblique_ionogram_2d(
        np.array([5e6, 8e6]), 600.0, x, z, *t, n_elev=12, step_km=30.0,
        s_max_km=1500.0, engine=engine)


@pytest.mark.parametrize("engine", ["pallas", "xla"])
def test_oblique_outputs_bit_identical_with_the_profiler_on_and_off(engine):
    off = _oblique_call(engine)
    on, _ = _traced(lambda: _oblique_call(engine))
    assert torch.isfinite(off["delay_low_sec"]).any()
    assert set(on) == set(off)
    for k in off:
        assert torch.equal(_bits(on[k]), _bits(off[k])), k


def test_spans_of_one_cpu_oblique_call():
    """The 2-D oblique ionogram through the fan kernel's plain version:
    the fields, the tables, the fan (the plain version stands in for the
    launch) and the homing, one span each and in that order, inside
    ``pyrayhf.oblique``; CPU tensors read nothing from a card."""
    from pyrayhf_tpu_torch import pallas_ray
    pallas_ray.reset_counters()
    out, events = _traced(lambda: _oblique_call("pallas"))
    assert pallas_ray.PLAIN_CALLS["fan_2d"] == 1
    assert torch.isfinite(out["fan_range_km"]).any()
    ours = [e for e in events if e.name.startswith("pyrayhf.")]
    inner = ("pyrayhf.fan_fields", "pyrayhf.fan_pack", "pyrayhf.fan_launch",
             "pyrayhf.homing")
    assert sorted(e.name for e in ours) == sorted(
        ("pyrayhf.oblique",) + inner)
    rng = {e.name: (e.time_range.start, e.time_range.end) for e in ours}
    lo, hi = rng["pyrayhf.oblique"]
    for k in inner:
        assert lo <= rng[k][0] <= rng[k][1] <= hi
    for a, b in zip(inner, inner[1:]):
        assert rng[a][1] <= rng[b][0]


def test_cpu_fan_tables_record_the_fields_then_the_tables_once():
    """``pallas_ray.fan_tables`` on CPU tensors (its plain version, the
    table the oblique call's kernel engine reads) records
    ``pyrayhf.fan_fields`` and then ``pyrayhf.fan_pack``, once each, and
    its table is bit for bit the one it makes with the profiler off."""
    from pyrayhf_tpu_torch import pallas_ray
    z, x = np.linspace(0.0, 600.0, 41), np.linspace(0.0, 3800.0, 20)
    h = (z[:, None] - 280.0) / 50.0
    ne = 1e12 * np.exp(0.5 * (1.0 - h - np.exp(-h))) * np.ones((1, 20))
    t = [torch.as_tensor(a, dtype=torch.float64)
         for a in (np.array([5e6, 8e6]), ne, np.full_like(ne, 4.5e-5),
                   np.full_like(ne, 60.0), 1e7 * np.exp(-(z - 70.0) / 8.0))]
    geo = pallas_ray.fan_geometry(z, x, "cartesian")
    off = pallas_ray.fan_tables(geo, *t, "O")
    on, events = _traced(lambda: pallas_ray.fan_tables(geo, *t, "O"))
    assert torch.equal(_bits(torch.nan_to_num(on)),
                       _bits(torch.nan_to_num(off)))
    ours = sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in events if e.name.startswith("pyrayhf."))
    assert [n for *_, n in ours] == ["pyrayhf.fan_fields",
                                     "pyrayhf.fan_pack"]
    assert ours[0][1] <= ours[1][0]


def test_spans_are_the_ones_perf_md_documents():
    text = PERF_MD.read_text()
    layers = text[text.index("## 3."):text.index("## 4.")]
    assert set(re.findall(r"`(pyrayhf\.[a-z_]+)`", layers)) == set(
        profiling.SPANS)
    assert len(profiling.SPANS) == len(set(profiling.SPANS))


def test_each_trace_capture_gets_its_own_directory():
    xs = _inputs(B=1)
    dirs = []
    try:
        for _ in range(2):
            with profiling.trace() as d:
                dirs.append(d)
                vertical_forward_operator_batch(*xs, n_points=64,
                                                engine="pallas_gather")
        assert dirs[0] != dirs[1]
        for d in dirs:
            assert Path(d).name.startswith("pyrayhf_trace-")
            assert any(Path(d).iterdir())
    finally:
        for d in dirs:
            shutil.rmtree(d, ignore_errors=True)
