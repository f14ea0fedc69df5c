"""PyTorch port vs the JAX package: the anisotropic 3-D tracers.

Inputs: the grid of ``tests/test_trace3d_aniso.py`` reduced to 55
altitudes (60–600 km) × 11 latitudes (20–60°) × 11 longitudes (±20°), its
parabolic layer (1e12 m⁻³ at 300 km, 120 km half-width) under the IGRF
field of :func:`igrf_volume`, traced at 8 MHz with 16-km steps (the fan
has the homing's 8 × 3 shape, so the JAX package compiles it once).
Against
``pyrayhf_tpu.trace3d_aniso`` (CPU, float64): the Appleton–Hartree n² and
its mask exactly; the tracers, the homing and the ionogram at rtol 1e-9
with identical NaN masks and status. The field-table gradient is
``tests/test_torch_trace3d_aniso_grad.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyrayhf_tpu.trace3d_aniso as J
import pyrayhf_tpu_torch.trace3d_aniso as T

from _torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-9
CPU = "cpu"
F0 = 8e6
STEP = 16.0
SMAX = 1600.0
LINK = (36.0, 0.0, 31.0, 0.5)
HOME = dict(n_elev=8, n_az=3, az_span_deg=4.0, step_km=STEP,
            s_max_km=SMAX)


@pytest.fixture(scope="module")
def grids():
    alt = np.linspace(60.0, 600.0, 55)
    lat = np.linspace(20.0, 60.0, 11)
    lon = np.linspace(-20.0, 20.0, 11)
    ne1 = 1.0e12 * np.maximum(0.0, 1.0 - ((alt - 300.0) / 120.0) ** 2)
    Ne = np.broadcast_to(ne1[:, None, None],
                         (alt.size, lat.size, lon.size)).copy()
    return alt, lat, lon, Ne


@pytest.fixture(scope="module")
def fields(grids):
    alt, lat, lon, Ne = grids
    bj = [np.asarray(b) for b in J.igrf_volume(alt, lat, lon)]
    bt = T.igrf_volume(alt, lat, lon, device=CPU)
    return (bj, bt, J.build_field_3d_aniso(alt, lat, lon, Ne, *bj),
            T.build_field_3d_aniso(alt, lat, lon, Ne, *bt))


def _close(port, ref, name="", rtol=RTOL, floor=0.0):
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
    np.testing.assert_allclose(out[fin], ref[fin], rtol=rtol, err_msg=name,
                               atol=floor * np.abs(ref[fin]).max(initial=0))


def _same(port, ref):
    for k, v in ref.items():
        if k == "status":
            assert port[k] == v
        elif k in ("alt", "lat", "lon", "ecef", "u"):
            _close(port[k], v, k, floor=1e-9)
        else:
            _close(port[k], v, k)


@pytest.mark.parametrize("mode_mult", [1.0, -1.0], ids=["O", "X"])
def test_ah_n2(mode_mult):
    X = np.concatenate([np.linspace(0.0, 1.3, 27), [1.0, 0.5]])[:, None,
                                                                None]
    Y = np.array([0.0, 0.2, 0.7, 1.0, 1.4])[None, :, None]
    cos2 = np.array([0.0, 0.1, 0.5, 0.9, 1.0])[None, None, :]
    n2, valid = T._ah_n2(*(torch.from_numpy(np.broadcast_to(a, (29, 5, 5))
                                            .copy()) for a in (X, Y, cos2)),
                         mode_mult)
    jn2, jvalid = J._ah_n2(jnp.asarray(X), jnp.asarray(Y), jnp.asarray(cos2),
                           mode_mult)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    _close(n2, jn2, "n2", rtol=1e-14)
    assert valid.any() and not valid.all()


def test_tables(fields):
    bj, bt, fj, ft = fields
    for a, b in zip(bt, bj):
        _close(a, b, "B", floor=1e-12)
    for a, b in zip(ft["tables"], fj["tables"]):
        _close(a, b, "tables", floor=1e-12)
    _close(ft["nu"], fj["nu"], "nu")


def test_trace_ray_3d_anisotropic(fields):
    """One X-mode ray (the fan and the homing run O)."""
    _, _, fj, ft = fields
    kw = dict(mode="X", step_km=STEP, s_max_km=SMAX, early_exit=True)
    ref = J.trace_ray_3d_anisotropic(fj, 30.0, 0.0, 25.0, 10.0, F0, **kw)
    assert ref["status"] == "ground"
    _same(T.trace_ray_3d_anisotropic(ft, 30.0, 0.0, 25.0, 10.0, F0, **kw),
          ref)


def test_trace_rays_3d_anisotropic(fields):
    _, _, fj, ft = fields
    els = np.linspace(10.0, 85.0, HOME["n_elev"])
    azs = np.array([-10.0, 0.0, 15.0])
    kw = dict(step_km=STEP, s_max_km=SMAX)
    ref = J.trace_rays_3d_anisotropic(fj, 30.0, 0.0, els, azs, F0, **kw)
    port = T.trace_rays_3d_anisotropic(ft, 30.0, 0.0, els, azs, F0, **kw)
    _same(port, ref)
    rng = np.asarray(ref["ground_range_km"])
    assert np.isfinite(rng).any() and np.isnan(rng).any()


def test_home_and_ionogram(fields):
    """The homing at one frequency and the two-frequency ionogram (one
    frequency above the link MUF); the ionogram's first row is the
    homing."""
    _, _, fj, ft = fields
    ref = J.home_ray_3d_anisotropic(fj, *LINK, F0, **HOME)
    port = T.home_ray_3d_anisotropic(ft, *LINK, F0, **HOME)
    assert np.isfinite(float(ref["delay_low_sec"]))
    for k, v in ref.items():
        _close(port[k], v, k)
    f0s = np.array([F0, 25e6])
    ref = J.synthesize_oblique_ionogram_3d_anisotropic(f0s, *LINK, fj,
                                                       **HOME)
    ion = T.synthesize_oblique_ionogram_3d_anisotropic(f0s, *LINK, ft,
                                                       **HOME)
    assert set(ion) == set(ref)
    for k, v in ref.items():
        _close(ion[k], v, k)
    assert np.isnan(np.asarray(ref["delay_low_sec"])[1])
    _close(ion["delay_low_sec"][0], port["delay_low_sec"].numpy(), "row")
