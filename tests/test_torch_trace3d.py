"""PyTorch port vs the JAX package: the fixed-ψ 3-D tracers.

Inputs: a Chapman volume (NmF2 6e11 m⁻³ at 250 km, 45 km scale) on
100 altitudes × 12 latitudes × 12 longitudes with a north-south ramp and
an east–west ridge (the volume of ``tools/bench_fan_3d.py``, smaller), on
uniform axes and on non-uniform altitude and longitude axes (the binary-
search locate). Against ``pyrayhf_tpu.trace3d`` (CPU, float64) at
rtol 1e-9 (the JAX package's own fan-versus-single tolerance,
``tests/test_trace3d.py``) with identical NaN masks and status; the grid
gradients of the field, which cancel to ~1e-16 where μ is flat, with an
absolute floor of 1e-12 of their largest value (``tests/test_trace3d.py``
allows the same between its own builders).

The adaptive ray: the port's DP45 and the JAX package's part where a
1-ulp difference of the RHS's transcendental functions moves the step
controller (the JAX function parts from itself as much between jit and
``jax.disable_jit``), so it is held to the JAX function on a 300-km arc
that enters the layer.
"""

import numpy as np
import pytest
import torch

import pyrayhf_tpu.trace3d as J
import pyrayhf_tpu_torch.trace3d as T
from pyrayhf_tpu_torch import io as TIO

from _torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-9
CPU = "cpu"
F0 = 8e6
LINK = (45.0, 0.0, 38.0, 2.0)            # tx lat, lon, rx lat, lon
HOME = dict(n_elev=16, n_az=5, step_km=4.0, s_max_km=2000.0)


def _volume(uniform):
    u = np.linspace(0.0, 1.0, 100)
    alt = 60.0 + 440.0 * (u if uniform else u ** 1.3)
    lat = np.linspace(30.0, 50.0, 12)
    lon = np.linspace(-10.0, 10.0, 12)
    if not uniform:
        lon = -10.0 + 20.0 * np.linspace(0.0, 1.0, 12) ** 1.2
    h = (alt[:, None, None] - 250.0) / 45.0
    nmf2 = (6.0e11 * (1.0 + 0.2 * (lat[None, :, None] - 40.0) / 20.0)
            * (1.0 + 0.4 * np.exp(-((lon[None, None, :] - 3.0) / 4.0)
                                  ** 2)))
    ne = nmf2 * np.exp(0.5 * (1.0 - h - np.exp(-h)))
    return (alt, lat, lon, ne, np.full(ne.shape, 4.8e-5),
            np.full(ne.shape, 25.0))


def _close(port, ref, name="", floor=0.0):
    ref = np.asarray(ref)
    out = port.detach().cpu().numpy() if isinstance(port, torch.Tensor) \
        else np.asarray(port)
    assert out.shape == ref.shape, name
    if ref.dtype == bool:
        np.testing.assert_array_equal(out, ref, err_msg=name)
        return
    np.testing.assert_array_equal(np.isnan(out), np.isnan(ref),
                                  err_msg=name)
    fin = np.isfinite(ref)
    np.testing.assert_allclose(out[fin], ref[fin], rtol=RTOL, err_msg=name,
                               atol=floor * np.abs(ref[fin]).max(initial=0))


def _same(port, ref):
    assert set(port) == set(ref) | ({"status"} & set(port))
    for k, v in ref.items():
        if k == "status":
            assert port[k] == v
        elif k in ("alt", "lat", "lon", "ecef"):
            # paths: compared on the landing scale (1e-9 of R_E)
            _close(port[k], v, k, floor=1e-9)
        else:
            _close(port[k], v, k)


@pytest.fixture(scope="module", params=[True, False],
                ids=["uniform", "nonuniform"])
def case(request):
    vol = _volume(request.param)
    return (vol, J.build_field_3d(*vol, F0, "O"),
            T.build_field_3d(*vol, F0, "O", device=CPU))


def test_build_field_3d(case):
    _, fj, ft = case
    for k, v in fj.items():
        _close(ft[k], v, k, floor=1e-12)


def test_build_field_3d_batch():
    vol = _volume(True)
    f0s = np.array([5e6, 7e6, 9e6])
    fj = J.build_field_3d_batch(*vol, f0s, mode="X")
    ft = T.build_field_3d_batch(*vol, f0s, mode="X", device=CPU)
    for k, v in fj.items():
        _close(ft[k], v, k, floor=1e-12)
    with pytest.raises(ValueError, match="chunk the"):
        T.build_field_3d_batch(*vol, f0s, hbm_budget_bytes=1024,
                               device=CPU)
    with pytest.raises(ValueError, match="ascending"):
        T.build_field_3d(vol[0][::-1], *vol[1:], F0, device=CPU)


def test_trilinear(case):
    (alt, lat, lon, ne, _, _), _, _ = case
    rng = np.random.default_rng(2)
    q = (rng.uniform(40.0, 520.0, 200), rng.uniform(28.0, 52.0, 200),
         rng.uniform(-12.0, 12.0, 200))
    q[0][:3] = np.nan
    _close(T.trilinear(*q, alt, lat, lon, ne, device=CPU),
           J.trilinear(*q, alt, lat, lon, ne), "trilinear")
    _close(T.trilinear(*q, alt, lat, lon, ne, fill_value=-1.0, device=CPU),
           J.trilinear(*q, alt, lat, lon, ne, fill_value=-1.0), "fill")


def test_field_from_numpy(case):
    """The JAX builder's tables, carried into the port, trace as the
    port's own."""
    _, fj, ft = case
    moved = TIO.field_from_numpy({k: np.asarray(v) for k, v in fj.items()},
                                 device=CPU)
    a = T.trace_ray_3d(moved, 40.0, 0.0, 30.0, 15.0, step_km=4.0,
                       s_max_km=1500.0)
    b = T.trace_ray_3d(ft, 40.0, 0.0, 30.0, 15.0, step_km=4.0,
                       s_max_km=1500.0)
    for k in ("group_delay_sec", "ground_range_km", "cross_track_km"):
        _close(a[k], b[k].numpy(), k)


@pytest.mark.parametrize("ray", [(25.0, 20.0, 1), (40.0, 95.0, 1),
                                 (20.0, 160.0, 2), (85.0, 0.0, 1)])
def test_trace_ray_3d(case, ray):
    _, fj, ft = case
    el, az, hops = ray
    kw = dict(step_km=4.0, s_max_km=2000.0, n_hops=hops)
    _same(T.trace_ray_3d(ft, 40.0, 0.0, el, az, **kw),
          J.trace_ray_3d(fj, 40.0, 0.0, el, az, **kw))


def test_trace_ray_3d_adaptive(case):
    _, fj, ft = case
    kw = dict(step_km=4.0, s_max_km=300.0, rtol=1e-7, atol=1e-9,
              max_step_km=10.0)
    port = T.trace_ray_3d(ft, 40.0, 0.0, 25.0, 20.0, **kw)
    _same(port, J.trace_ray_3d(fj, 40.0, 0.0, 25.0, 20.0, **kw))
    assert float(port["apex_alt_km"]) > 120.0       # it reached the layer


@pytest.fixture(scope="module")
def fans(case):
    _, fj, ft = case
    els, azs = np.array([10.0, 25.0, 45.0, 85.0]), np.array([10.0, 20.0,
                                                             30.0])
    kw = dict(step_km=4.0, s_max_km=2000.0)
    return (T.trace_rays_3d(ft, 40.0, 0.0, els, azs, **kw),
            J.trace_rays_3d(fj, 40.0, 0.0, els, azs, **kw),
            T.trace_rays_3d(ft, 40.0, 0.0, els, azs, early_exit=False,
                            **kw))


def test_trace_rays_3d(fans):
    port, ref, _ = fans
    _same({k: v for k, v in port.items()},
          {k: v for k, v in ref.items()})
    assert np.isfinite(np.asarray(ref["ground_range_km"])).any()
    assert np.isnan(np.asarray(ref["ground_range_km"])).any()


def test_trace_rays_3d_early_exit_is_exact(fans):
    port, _, full = fans
    for k in port:
        assert torch.equal(torch.nan_to_num(port[k]),
                           torch.nan_to_num(full[k])), k


def test_home_ray_3d(case):
    _, fj, ft = case
    port = T.home_ray_3d(ft, *LINK, **HOME)
    ref = J.home_ray_3d(fj, *LINK, **HOME)
    assert np.isfinite(float(ref["delay_low_sec"]))
    for k, v in ref.items():
        _close(port[k], v, k)


def test_synthesize_oblique_ionogram_3d(case):
    vol, _, _ = case
    f0s = np.array([5e6, 8e6, 12e6, 25e6])
    ref = J.synthesize_oblique_ionogram_3d(f0s, *LINK, *vol, **HOME)
    d = np.asarray(ref["delay_low_sec"])
    assert np.isfinite(d).any() and np.isnan(d).any()
    for chunk in (None, 3):
        port = T.synthesize_oblique_ionogram_3d(f0s, *LINK, *vol,
                                                freq_chunk=chunk,
                                                device=CPU, **HOME)
        assert set(port) == set(ref)
        for k, v in ref.items():
            _close(port[k], v, k)
