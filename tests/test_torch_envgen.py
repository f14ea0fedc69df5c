"""PyTorch port vs the JAX package: the input generators and the CCIR map
evaluation.

Inputs: seeded locations, dates at solar maximum and minimum, day and
night; the 1-D, 2-D and 3-D generators on small grids; synthetic CCIR/URSI
coefficients (a constant term plus seeded noise, as
``tests/test_ccir.py`` builds them) written in the standard file layout.
Against ``pyrayhf_tpu.envgen``/``pyrayhf_tpu.ccir`` (CPU, float64) at
rtol 1e-10; the generators' dicts hold numpy arrays, as the JAX
functions'.
"""

import numpy as np
import pytest
import torch

import pyrayhf_tpu.ccir as JC
import pyrayhf_tpu.envgen as JE
import pyrayhf_tpu_torch.ccir as TC
import pyrayhf_tpu_torch.envgen as TE
from pyrayhf_tpu_torch import io as TIO

from _torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-10
CPU = "cpu"
ALT = np.arange(80.0, 700.0, 10.0)


def _close(port, ref, floor=0.0):
    ref = np.asarray(ref)
    out = port.cpu().numpy() if isinstance(port, torch.Tensor) else port
    assert np.shape(out) == ref.shape
    np.testing.assert_array_equal(np.isnan(out), np.isnan(ref))
    np.testing.assert_allclose(out, ref, rtol=RTOL,
                               atol=floor * np.nanmax(np.abs(ref)))


def _layers(port, ref):
    for P, R in zip(port, ref):
        assert set(P) == set(R)
        for k in R:
            _close(P[k], R[k])


@pytest.fixture(scope="module")
def maps():
    rng = np.random.default_rng(5)
    f2 = 0.05 * rng.normal(size=JC.F2_SHAPE)
    f2[:, 0, 0] = (6.0, 10.0)
    fm3 = 0.01 * rng.normal(size=JC.FM3_SHAPE)
    fm3[:, 0, 0] = (3.1, 2.9)
    return {"F2": f2, "FM3": fm3}


@pytest.mark.parametrize("when", [(2020, 6, 15, 17.0, 140.0),
                                  (2019, 12, 21, 3.0, 68.0),
                                  (2014, 3, 1, 22.5, 210.0)])
def test_climatology_parameters(when):
    y, m, d, ut, f107 = when
    lat = np.linspace(-70.0, 70.0, 9)
    lon = np.linspace(-175.0, 175.0, 9)
    _close(TE.solar_zenith_angle(y, m, d, ut, lat, lon, device=CPU),
           JE.solar_zenith_angle(y, m, d, ut, lat, lon))
    _close(TE.modip_deg(y, m, d, lat, lon, device=CPU),
           JE.modip_deg(y, m, d, lat, lon))
    _layers(TE.climatology_parameters(y, m, d, ut, lat, lon, f107,
                                      device=CPU),
            JE.climatology_parameters(y, m, d, ut, lat, lon, f107))


def test_climatology_with_ccir_maps(maps):
    lat = np.linspace(-60.0, 60.0, 7)
    lon = np.linspace(-150.0, 150.0, 7)
    ref = JE.climatology_parameters(2020, 6, 15, 12.0, lat, lon, 120.0,
                                    ccir_maps=maps)
    _layers(TE.climatology_parameters(2020, 6, 15, 12.0, lat, lon, 120.0,
                                      ccir_maps=maps, device=CPU), ref)
    # foF2-only maps: hmF2 stays the analytic one
    f2_only = {"F2": maps["F2"]}
    _layers(TE.climatology_parameters(2020, 6, 15, 12.0, lat, lon, 120.0,
                                      ccir_maps=f2_only, device=CPU),
            JE.climatology_parameters(2020, 6, 15, 12.0, lat, lon, 120.0,
                                      ccir_maps=f2_only))


def test_ccir_functions(maps, tmp_path):
    rng = np.random.default_rng(3)
    modip, lat, lon = (rng.uniform(-60, 60, 6), rng.uniform(-60, 60, 6),
                       rng.uniform(-180, 180, 6))
    for blocks in (JC.QF, JC.QM):
        _close(TC.ccir_geographic_basis(modip, lat, lon, blocks=blocks,
                                        device=CPU),
               JC.ccir_geographic_basis(modip, lat, lon, blocks=blocks))
    _close(TC.ccir_time_basis(np.array([0.0, 7.5, 23.0]), 6, device=CPU),
           JC.ccir_time_basis(np.array([0.0, 7.5, 23.0]), 6))
    for key in ("F2", "FM3"):
        _close(TC.eval_ccir_map(maps[key], modip, lat, lon, 9.0,
                                np.array([0.0, 40.0, 80.0, 120.0, 160.0,
                                          10.0]), device=CPU),
               JC.eval_ccir_map(maps[key], modip, lat, lon, 9.0,
                                np.array([0.0, 40.0, 80.0, 120.0, 160.0,
                                          10.0])))
    R = np.array([0.0, 25.0, 100.0, 180.0])
    _close(TC.f107_from_r12(R, device=CPU), JC.f107_from_r12(R))
    F = np.array([60.0, 70.0, 150.0, 250.0])
    _close(TC.r12_from_f107(F, device=CPU), JC.r12_from_f107(F))
    M = np.array([2.5, 3.0, 3.4])
    _close(TC.hmf2_from_m3000(M, device=CPU), JC.hmf2_from_m3000(M))
    _close(TC.hmf2_from_m3000(M, [9.0, 5.0, 3.0], [3.0, 3.5, 2.0],
                              device=CPU),
           JC.hmf2_from_m3000(M, [9.0, 5.0, 3.0], [3.0, 3.5, 2.0]))
    with pytest.raises(ValueError):
        TC.eval_ccir_map(np.zeros((2, 50, 13)), 0.0, 0.0, 0.0, 0.0, 0.0,
                         device=CPU)
    # the loader, on the standard Fortran layout of tests/test_ccir.py
    flat = np.concatenate([maps["F2"].transpose(2, 1, 0).ravel(order="F"),
                           maps["FM3"].transpose(2, 1, 0).ravel(order="F")])
    p = tmp_path / "ccir11.asc"
    with open(p, "w") as fh:
        for i in range(0, flat.size, 4):
            fh.write(" ".join(f"{v: .16E}" for v in flat[i:i + 4]) + "\n")
    got, ref = TC.load_ccir_asc(p), JC.load_ccir_asc(p)
    for k in ("F2", "FM3"):
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]))
    bad = tmp_path / "short.asc"
    bad.write_text("1.0 2.0 3.0\n")
    with pytest.raises(ValueError):
        TC.load_ccir_asc(bad)


def test_generate_input_1d(tmp_path):
    path = tmp_path / "in1d.p"
    out = TE.generate_input_1D(2020, 6, 15, 17.0, 38.0, -77.0, ALT, 140.0,
                               save_path=str(path), device=CPU)
    ref = JE.generate_input_1D(2020, 6, 15, 17.0, 38.0, -77.0, ALT, 140.0)
    for k in ("alt", "den", "bmag", "bpsi"):
        assert isinstance(out[k], np.ndarray)
        _close(out[k], ref[k])
    _layers((out["F2"], out["F1"], out["E"]),
            (ref["F2"], ref["F1"], ref["E"]))
    back = TIO.load_input(str(path))
    np.testing.assert_array_equal(back["den"], out["den"])


def test_generate_input_2d():
    out = TE.generate_input_2D(2020, 3, 21, 12.0, 10.0, 20.0, 100.0, ALT,
                               1500.0, 60.0, 160.0, device=CPU)
    ref = JE.generate_input_2D(2020, 3, 21, 12.0, 10.0, 20.0, 100.0, ALT,
                               1500.0, 60.0, 160.0)
    for k in ("xgrid", "zgrid", "xlat", "xlon", "den", "bmag", "bpsi"):
        _close(out[k], ref[k])
    _layers((out["F2"], out["F1"], out["E"]),
            (ref["F2"], ref["F1"], ref["E"]))


def test_generate_input_3d():
    lat, lon = np.linspace(10.0, 45.0, 6), np.linspace(-90.0, -50.0, 5)
    out = TE.generate_input_3D(2020, 6, 15, 17.0, lat, lon, ALT, 140.0,
                               device=CPU)
    ref = JE.generate_input_3D(2020, 6, 15, 17.0, lat, lon, ALT, 140.0)
    for k in ("alt", "lat", "lon", "den", "bmag", "bpsi"):
        assert out[k].shape == np.asarray(ref[k]).shape
        _close(out[k], ref[k])
    _layers((out["F2"], out["F1"], out["E"]),
            (ref["F2"], ref["F1"], ref["E"]))


def test_find_mean_gradient_error():
    args = ([-77.0, -10.0, 30.0], [38.0, 5.0, -20.0], [-70.0, 0.0, 35.0],
            [30.0, 20.0, -35.0], 2020, 6, 15, 17.0, 140.0)
    err, mid = TE.find_mean_gradient_error(*args, nelem=20, device=CPU)
    jerr, jmid = JE.find_mean_gradient_error(*args, nelem=20)
    _close(err, jerr, floor=1e-12)
    _close(mid["fo"], jmid["fo"])
