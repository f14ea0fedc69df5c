"""PyTorch port vs the JAX package: the IGRF field model and its tables.

Inputs: seeded random (lat, lon, alt) points, geocentric and geodetic; the
vendored IGRF-13 2020 table, its secular variation (2020 and later) and
the DGRF back-catalogue (2015, 1950). Against ``pyrayhf_tpu.igrf`` (CPU,
float64) at rtol 1e-12 (the east component, which passes through zero,
with an absolute floor of 1e-12 of the field's magnitude). The coefficient
tables are copies of the JAX package's and must equal them exactly.
"""

import numpy as np
import pytest
import torch

import pyrayhf_tpu.igrf as JI
import pyrayhf_tpu.igrf13_table as JT
import pyrayhf_tpu.igrf_history as JH
import pyrayhf_tpu_torch.igrf as TI
import pyrayhf_tpu_torch.igrf13_table as TT
import pyrayhf_tpu_torch.igrf_history as TH

from _torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-12
CPU = "cpu"


@pytest.fixture(scope="module")
def points():
    rng = np.random.default_rng(11)
    return (rng.uniform(-89.0, 89.0, 40), rng.uniform(-180.0, 180.0, 40),
            rng.uniform(0.0, 1000.0, 40))


def _close(port, ref):
    ref = np.asarray(ref)
    out = port.numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=RTOL,
                               atol=1e-12 * np.abs(ref).max())


def test_tables_are_copies():
    for name in ("G2020", "H2020", "GSV", "HSV"):
        np.testing.assert_array_equal(getattr(TT, name), getattr(JT, name))
    for epoch in (1900.0, 1952.5, 2003.0, 2019.9, 2020.0, 2024.5):
        a, b = TT.coefficients_at_epoch(epoch), JT.coefficients_at_epoch(
            epoch)
        np.testing.assert_array_equal(a["g"], b["g"])
        np.testing.assert_array_equal(a["h"], b["h"])
    np.testing.assert_array_equal(TH.EPOCHS, JH.EPOCHS)
    with pytest.raises(ValueError):
        TT.coefficients_at_epoch(1899.0)


@pytest.mark.parametrize("nmax", [3, 13])
def test_schmidt_legendre(nmax):
    theta = np.linspace(0.05, np.pi - 0.05, 23)
    for p, j in zip(TI.schmidt_legendre(nmax, theta, device=CPU),
                    JI.schmidt_legendre(nmax, theta)):
        _close(p, j)


@pytest.mark.parametrize("geodetic", [False, True])
def test_igrf_field(points, geodetic):
    lat, lon, alt = points
    for p, j in zip(TI.igrf_field(lat, lon, alt, geodetic=geodetic,
                                  device=CPU),
                    JI.igrf_field(lat, lon, alt, geodetic=geodetic)):
        _close(p, j)


def test_igrf_field_broadcast_and_dipole(points):
    lat, lon, alt = points
    grid = (lat[None, :8, None], lon[None, None, :5], alt[:3, None, None])
    for p, j in zip(TI.igrf_field(*grid, device=CPU), JI.igrf_field(*grid)):
        _close(p, j)
    for p, j in zip(TI.dipole_field(lat, lon, alt, device=CPU),
                    JI.dipole_field(lat, lon, alt)):
        _close(p, j)


@pytest.mark.parametrize("year", [2020, 2015, 1950])
def test_calculate_magnetic_field(points, year):
    lat, lon, alt = points
    mag, psi = TI.calculate_magnetic_field(year, 6, 15, lat[:9], lon[:9],
                                           alt, device=CPU)
    jm, jp = JI.calculate_magnetic_field(year, 6, 15, lat[:9], lon[:9], alt)
    assert mag.shape == (alt.size, 9)
    _close(mag, jm)
    _close(psi, jp)
    for k in ("g", "h"):
        np.testing.assert_array_equal(
            TI.coefficients_for_date(year, 6, 15)[k],
            JI.coefficients_for_date(year, 6, 15)[k])


def test_load_igrf_coefficients(tmp_path):
    """The synthetic file of ``tests/test_igrf.py``: both loaders agree,
    and the port's field from it equals the JAX package's."""
    p = tmp_path / "mini_coeffs.txt"
    p.write_text(
        "# comment\n"
        "c/s deg ord 2015.0 2020.0 SV\n"
        "g/h n m 2015.0 2020.0 2020-25\n"
        "g 1 0 -29441.0 -29404.8 5.7\n"
        "g 1 1 -1501.0 -1450.9 7.4\n"
        "h 1 1 4795.0 4652.5 -25.9\n")
    for epoch in (2017.5, 2022.0):
        a = TI.load_igrf_coefficients(p, epoch=epoch)
        b = JI.load_igrf_coefficients(p, epoch=epoch)
        np.testing.assert_array_equal(a["g"], b["g"])
        np.testing.assert_array_equal(a["h"], b["h"])
    c = TI.load_igrf_coefficients(p, epoch=2017.5)
    np.testing.assert_allclose(c["g"][1, 0], (-29441.0 - 29404.8) / 2,
                               rtol=1e-12)
    with pytest.raises(ValueError, match="precedes"):
        TI.load_igrf_coefficients(p, epoch=1990.0)
    bad = tmp_path / "bad.txt"
    bad.write_text("g 1 0 1.0 2.0 0.1\n")
    with pytest.raises(ValueError, match="g/h"):
        TI.load_igrf_coefficients(bad)
    lat, lon, alt = [10.0, -35.0], [20.0, 140.0], [100.0, 400.0]
    for q, j in zip(TI.igrf_field(lat, lon, alt, coeffs=c, device=CPU),
                    JI.igrf_field(lat, lon, alt, coeffs=c)):
        _close(q, j)


def test_tensor_inputs_keep_device_and_dtype():
    lat = torch.tensor([10.0, 50.0], dtype=torch.float32)
    out = TI.igrf_field(lat, 0.0, 300.0)
    assert all(t.dtype == torch.float32 and t.device.type == "cpu"
               for t in out)
    np.testing.assert_allclose(
        out[3].double().numpy(),
        np.asarray(JI.igrf_field(np.array([10.0, 50.0]), 0.0, 300.0)[3]),
        rtol=1e-5)
