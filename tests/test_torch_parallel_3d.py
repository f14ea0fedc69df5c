"""PyTorch port vs the JAX package: the elevation-sharded 3-D fans.

The JAX package's own sharded 3-D tests need the reference Day pickle and
skip without it; these build a small Chapman volume from numpy (120
altitudes × 9 latitudes × 9 longitudes) and trace an 8-elevation ×
2-azimuth fan at 8 MHz, 4-km steps over 1,500 km, on a 4×2 mesh: the
tests' 8 virtual CPU devices for JAX, ``[torch.device("cpu")] * 8`` for the
port. The fixed-ψ fan is sharded over the 'batch' axis (2 elevations a
shard), the anisotropic one over the 'freq' axis (4 a shard: each shard
pays the whole fan's host time a step, ~20 ms here). Tolerances: the
fixed-ψ fan against the port's unsharded fan rtol 1e-12, atol 1e-12 (each
shard integrates its rays as the whole fan does); the anisotropic fan
against the port's unsharded fan rtol 1e-9, atol 1e-9 (the JAX test's
bound); both against the JAX sharded fans rtol 1e-9 (the port's 3-D
tracer tolerance, ``tests/test_torch_trace3d.py``; paths with a floor of
1e-9 of their scale), NaN masks identical throughout.
"""

import numpy as np
import pytest
import torch
import jax

import pyrayhf_tpu.parallel as JP
import pyrayhf_tpu.trace3d as J3
import pyrayhf_tpu.trace3d_aniso as JA
import pyrayhf_tpu_torch.parallel as TP
import pyrayhf_tpu_torch.trace3d as T3
import pyrayhf_tpu_torch.trace3d_aniso as TA

from _torch_threads import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
F0 = 8e6
ELS = np.linspace(20.0, 55.0, 8)
AZS = np.array([170.0, 190.0])
FAN = dict(step_km=4.0, s_max_km=1500.0)
PATHS = ("alt", "lat", "lon", "ecef", "u")


@pytest.fixture(scope="module")
def mesh8():
    if jax.device_count() < 8:
        pytest.skip("needs 8 virtual devices")
    return JP.ionogram_mesh(jax.devices()[:8], batch_axis=4)


@pytest.fixture(scope="module")
def tmesh():
    return TP.ionogram_mesh([CPU] * 8, batch_axis=4)


def _volume():
    alt = np.linspace(60.0, 500.0, 120)
    lat = np.linspace(20.0, 50.0, 9)
    lon = np.linspace(-85.0, -55.0, 9)
    h = (alt[:, None, None] - 250.0) / 45.0
    nmf2 = 6.0e11 * (1.0 + 0.2 * (lat[None, :, None] - 35.0) / 15.0) \
        * np.ones((1, 1, lon.size))
    ne = nmf2 * np.exp(0.5 * (1.0 - h - np.exp(-h)))
    return alt, lat, lon, ne


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _close(port, ref, rtol, atol=0.0, keys=None):
    """Every key of ``ref`` (or ``keys``): identical NaN masks and booleans,
    finite values within rtol (paths with a floor of rtol of their scale)
    plus ``atol``."""
    for k in keys or ref:
        a, b = _np(port[k]), _np(ref[k])
        assert a.shape == b.shape, k
        if b.dtype == bool or not np.issubdtype(b.dtype, np.floating):
            np.testing.assert_array_equal(a, b, err_msg=k)
            continue
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=k)
        m = np.isfinite(b)
        floor = rtol * np.abs(b[m]).max(initial=0.0) if k in PATHS else 0.0
        np.testing.assert_allclose(a[m], b[m], rtol=rtol, atol=atol + floor,
                                   err_msg=k)


def _check_sharded(sh, un, jx, rtol_un, atol_un):
    assert sh["ground_range_km"].shape == (ELS.size, AZS.size)
    assert set(sh) == set(un)
    assert sh["alt"].shape == un["alt"].shape     # n_steps rows each
    assert np.isfinite(_np(sh["ground_range_km"])).sum() >= 8
    _close(sh, un, rtol_un, atol_un)
    _close(sh, {k: v for k, v in jx.items() if k in sh}, 1e-9)


def test_trace_fan_3d_sharded_matches(mesh8, tmesh):
    alt, lat, lon, ne = _volume()
    babs, bpsi = np.full(ne.shape, 4.5e-5), np.full(ne.shape, 30.0)
    fld = T3.build_field_3d(alt, lat, lon, ne, babs, bpsi, F0, device=CPU)
    sh = TP.trace_fan_3d_sharded(fld, 35.0, -70.0, ELS, AZS, tmesh, **FAN)
    un = T3.trace_rays_3d(fld, 35.0, -70.0, ELS, AZS, **FAN)
    jx = JP.trace_fan_3d_sharded(
        J3.build_field_3d(alt, lat, lon, ne, babs, bpsi, F0, "O"), 35.0,
        -70.0, ELS, AZS, mesh8, **FAN)
    _check_sharded(sh, un, jx, 1e-12, 1e-12)


def test_trace_fan_3d_aniso_sharded_matches(mesh8, tmesh):
    alt, lat, lon, ne = _volume()
    b = [np.full(ne.shape, v) for v in (2.5e-5, 3.0e-6, -3.5e-5)]
    fld = TA.build_field_3d_aniso(alt, lat, lon, ne, *b, device=CPU)
    sh = TP.trace_fan_3d_aniso_sharded(fld, 35.0, -70.0, ELS, AZS, F0,
                                       tmesh, axis="freq", mode="O", **FAN)
    un = TA.trace_rays_3d_anisotropic(fld, 35.0, -70.0, ELS, AZS, F0,
                                      mode="O", **FAN)
    jx = JP.trace_fan_3d_aniso_sharded(
        JA.build_field_3d_aniso(alt, lat, lon, ne, *b), 35.0, -70.0, ELS,
        AZS, F0, mesh8, axis="freq", mode="O", **FAN)
    _check_sharded(sh, un, jx, 1e-9, 1e-9)


def test_fan_sharding_copies_the_field_once_per_device(tmesh):
    """Eight shards on one device share the caller's tables; an elevation
    count the axis does not divide raises."""
    alt, lat, lon, ne = _volume()
    fld = T3.build_field_3d(alt, lat, lon, ne, 4.5e-5, 30.0, F0, device=CPU)
    seen = []
    orig = T3._trace3d_fan_core

    def spy(field, *a, **k):
        seen.append(field["mu"].data_ptr())
        return orig(field, *a, **k)

    one_dev = TP.ionogram_mesh([CPU] * 8)
    T3._trace3d_fan_core = spy
    try:
        TP.trace_fan_3d_sharded(fld, 35.0, -70.0, ELS, AZS, one_dev,
                                step_km=50.0, s_max_km=200.0)
    finally:
        T3._trace3d_fan_core = orig
    assert seen == [fld["mu"].data_ptr()] * 8
    with pytest.raises(ValueError, match="elevation count .6. must be"):
        TP.trace_fan_3d_sharded(fld, 35.0, -70.0, ELS[:6], AZS, tmesh,
                                **FAN)
