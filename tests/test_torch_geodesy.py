"""PyTorch port vs the JAX package and the reference oracle: geodesy.

The ``obl2vert_*``, ``earth_radius*``, ``gcd`` and ``azimuth`` goldens of
``tests/goldens/reference_goldens.npz`` at ``tests/test_geodesy.py:38-54``'s
rtol 1e-13; every public function against ``pyrayhf_tpu.geodesy`` (CPU,
float64) on seeded random inputs at rtol 1e-12, NaN masks identical.
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import pyrayhf_tpu.geodesy as JG
import pyrayhf_tpu_torch.geodesy as TG
from pyrayhf_tpu_torch.constants import R_E

from _torch_threads import one_torch_thread  # noqa: F401


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def test_goldens():
    g = dict(np.load("tests/goldens/reference_goldens.npz"))
    f_v, h_v = TG.oblique_to_vertical(600.0, np.array([900.0, 1100.0,
                                                       1500.0]),
                                      np.array([5.0, 10.0, 15.0]),
                                      device="cpu")
    assert_allclose(_np(f_v), g["obl2vert_fv"], rtol=1e-13)
    assert_allclose(_np(h_v), g["obl2vert_hv"], rtol=1e-13)
    assert_allclose(_np(TG.earth_radius_at_latitude(
        g["earth_radius_lats"], device="cpu")), g["earth_radius"],
        rtol=1e-13)
    lon0, lat0 = np.array([10.0, -150.0]), np.array([45.0, 4.5])
    lon1, lat1 = np.array([30.0, -140.0]), np.array([50.0, 10.0])
    assert_allclose(_np(TG.calculate_gcd(lon0, lat0, lon1, lat1,
                                         device="cpu")), g["gcd"],
                    rtol=1e-13)
    assert_allclose(_np(TG.azimuth_between_points(lon0, lat0, lon1, lat1,
                                                  device="cpu")),
                    g["azimuth"], rtol=1e-13)


def _random(n=257, seed=2024):
    rng = np.random.default_rng(seed)
    return dict(lat0=rng.uniform(-89.0, 89.0, n),
                lon0=rng.uniform(-540.0, 540.0, n),
                lat1=rng.uniform(-89.0, 89.0, n),
                lon1=rng.uniform(-180.0, 180.0, n),
                d=rng.uniform(10.0, 15000.0, n),
                az=rng.uniform(-360.0, 720.0, n),
                p=rng.uniform(1000.0, 4000.0, n),
                D=rng.uniform(100.0, 900.0, n),
                f=rng.uniform(2.0, 30.0, n))


CASES = {
    "great_circle_point": lambda m, r: m.great_circle_point(
        r["lat0"], r["lon0"], r["d"], r["az"]),
    "oblique_to_vertical": lambda m, r: m.oblique_to_vertical(
        r["D"], r["p"], r["f"]),
    "earth_radius_at_latitude": lambda m, r: m.earth_radius_at_latitude(
        r["lat0"]),
    "calculate_gcd": lambda m, r: m.calculate_gcd(
        r["lon0"], r["lat0"], r["lon1"], r["lat1"]),
    "azimuth_between_points": lambda m, r: m.azimuth_between_points(
        r["lon0"], r["lat0"], r["lon1"], r["lat1"]),
    "vertical_to_magnetic_angle": lambda m, r:
        m.vertical_to_magnetic_angle(r["lat0"]),
    "adjust_longitude_to180": lambda m, r: m.adjust_longitude(r["lon0"]),
    "adjust_longitude_to360": lambda m, r: m.adjust_longitude(r["lon0"],
                                                              "to360"),
}


@pytest.mark.parametrize("name", list(CASES))
def test_matches_jax(name):
    r = _random()
    ref = CASES[name](JG, r)
    port = CASES[name](TG, {k: torch.from_numpy(v) for k, v in r.items()})
    ref = ref if isinstance(ref, tuple) else (ref,)
    port = port if isinstance(port, tuple) else (port,)
    for a, b in zip(ref, port):
        a, b = np.asarray(a), _np(b)
        assert b.dtype == np.float64 and a.shape == b.shape
        assert np.array_equal(np.isnan(a), np.isnan(b))
        m = np.isfinite(a)
        assert_allclose(b[m], a[m], rtol=1e-12, atol=1e-12)


def test_wrap_edges_and_round_trip():
    """Half-open [-180, 180) wrap, and the destination point goes back to
    its distance and azimuth."""
    assert_allclose(_np(TG.adjust_longitude([-190.0, 190.0, 180.0, 0.0],
                                            device="cpu")),
                    [170.0, -170.0, -180.0, 0.0])
    with pytest.raises(ValueError):
        TG.adjust_longitude([0.0], "to90", device="cpu")
    d = np.array([500.0, 1500.0, 3000.0])
    rlat, rlon = TG.great_circle_point(40.0, -100.0, d, 63.0, device="cpu")
    o = np.full(3, -100.0), np.full(3, 40.0)
    gcd = _np(TG.calculate_gcd(*o, rlon, rlat))
    assert_allclose(np.deg2rad(gcd) * R_E, d, rtol=1e-10)
    assert_allclose(_np(TG.azimuth_between_points(*o, rlon, rlat)),
                    np.full(3, 63.0), rtol=1e-8)
