"""PyTorch port vs the JAX package: the fixed-step gradient-ODE tracers.

Inputs are made with numpy from a seed and fed to both packages in f64:
the tilted Chapman slice of ``tests/test_pallas_ray.py`` with an
evanescent region. Tolerance: rtol 1e-8, atol 1e-10 with equal NaN
positions — the JAX package's own bound between its two fan engines
(``tests/test_pallas_ray.py:58``); integer outputs (status, alive) equal.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import pyrayhf_tpu.fields as JF
import pyrayhf_tpu.gradient as JG
import pyrayhf_tpu_torch.fields as TF
import pyrayhf_tpu_torch.gradient as TG
from pyrayhf_tpu_torch import pallas_ray as TR

from _torch_threads import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-8, 1e-10


def _scene(nz=101, nx=17):
    z = np.linspace(0.0, 400.0, nz)
    x = np.linspace(0.0, 2000.0, nx)
    h = (z[:, None] - 250.0) / 45.0
    ne = 8.0e11 * (1.0 + 0.15 * (x[None, :] / x[-1] - 0.5)) * np.exp(
        0.5 * (1.0 - h - np.exp(-h)))
    X = ne * 8.97866275 ** 2 / 6e6 ** 2            # 6 MHz, unmagnetised
    mu = np.where(X < 1.0, np.sqrt(np.clip(1.0 - X, 0.0, None)), np.nan)
    mup = np.where(np.isfinite(mu), 1.0 / mu, np.nan)
    return z, x, mu, mup


def _close(port, ref):
    port = port.numpy() if isinstance(port, torch.Tensor) else port
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    if ref.dtype == bool or np.issubdtype(ref.dtype, np.integer):
        assert np.array_equal(port, ref)
    else:
        assert np.allclose(port, ref, rtol=RTOL, atol=ATOL, equal_nan=True)


@pytest.mark.parametrize("geometry,n_hops", [("cartesian", 1),
                                             ("cartesian", 2),
                                             ("spherical", 1),
                                             ("spherical", 2)])
def test_trace_rays_match_jax(geometry, n_hops):
    z, x, mu, mup = _scene()
    elevs = np.linspace(6.0, 70.0, 20)
    kw = dict(s_max_km=2500.0, step_km=10.0, n_hops=n_hops)
    if geometry == "cartesian":
        kw.update(z_ground_km=0.0, z_max_km=400.0, x_min_km=0.0,
                  x_max_km=2000.0)
        jn = JF.build_refractive_index_interpolator_cartesian(z, x, mu)
        tn = TF.build_refractive_index_interpolator_cartesian(
            z, x, torch.from_numpy(mu))
        jt, tt = (JG.trace_rays_cartesian_gradient,
                  TG.trace_rays_cartesian_gradient)
    else:
        kw.update(r_max_km=6371.0 + 400.0, phi_min=0.0,
                  phi_max=2000.0 / 6371.0)
        jn = JF.build_refractive_index_interpolator_spherical(z, x, mu)
        tn = TF.build_refractive_index_interpolator_spherical(
            z, x, torch.from_numpy(mu))
        jt, tt = (JG.trace_rays_spherical_gradient,
                  TG.trace_rays_spherical_gradient)
    jm = JF.build_mup_function(mup, x, z, geometry=geometry)
    tm = TF.build_mup_function(torch.from_numpy(mup), x, z,
                               geometry=geometry)
    ref = jt(jn, jm, 0.0, 0.0, jnp.asarray(elevs), **kw)
    port = tt(tn, tm, 0.0, 0.0, torch.from_numpy(elevs), **kw)
    assert set(ref) <= set(port)
    for k in ref:
        _close(port[k], ref[k])
    status = port["status_code"].numpy()
    assert (status == 1).any() and (status != 1).any()


def _packed(geometry="cartesian"):
    z, x, mu, mup = _scene()
    geo = TR.fan_geometry(z, x, geometry)
    f = torch.from_numpy(np.stack([mu, 0.9 * mu + 0.1]))
    m = torch.from_numpy(np.stack([mup, mup]))
    tab = TR.pack_tables(geo, f, m, 0.01 * m)
    return geo, tab, torch.linspace(5.0, 75.0, 24, dtype=torch.float64)


@pytest.mark.parametrize("geometry", ["cartesian", "spherical"])
def test_frozen_ray_adds_zero(geometry):
    """What lets the CUDA kernel stop a ray when it freezes: every later
    step of a frozen ray leaves its state, status and sums exactly as
    they are. Segments that start frozen have zero length, and running a
    fan for more steps changes no ray that froze within the first run."""
    geo, tab, elevs = _packed(geometry)
    ds = torch.tensor(10.0, dtype=torch.float64)
    short = TR.plain_fan(geo, tab, elevs, ds, n_steps=150)
    long_ = TR.plain_fan(geo, tab, elevs, ds, n_steps=400)
    frozen = short["steps_taken"] < 150
    assert frozen.sum() > 10 and (~frozen).any()
    for k in TR.OUTPUTS:
        assert torch.equal(torch.nan_to_num(short[k][frozen]),
                           torch.nan_to_num(long_[k][frozen])), k
    # the segments themselves: zero length wherever the step began frozen
    rec = TR.table_views(geo, tab)[0]
    mu = TF.RefractiveField(geo.z, geo.x, rec[..., 0], geometry=geometry,
                            grads=(rec[..., 1], rec[..., 2]))
    el = elevs.expand(2, -1)
    if geometry == "cartesian":
        def nag(x, z):
            n, d0, d1 = mu.value_and_grad(z, x)
            return n, d1, d0
        out = TG._cart_gradient_core(nag, lambda x, z: mu.value(z, x), 0.0,
                                     0.0, el, ds, 400, 0.0, 400.0, 0.0,
                                     2000.0)
        a, b = out["x"], out["z"]
    else:
        def nag(phi, r):
            return mu.value_and_grad(r, phi)
        out = TG._sph_gradient_core(nag, lambda x, z: mu.value(z, x), 0.0,
                                    0.0, el, ds, 400, 6371.0, 0.0, 6771.0,
                                    0.0, 2000.0 / 6371.0)
        a, b = out["r"], out["phi"]
    dead = ~out["alive"][..., :-1]
    assert dead.any()
    assert (torch.diff(a, dim=-1)[dead] == 0).all()
    assert (torch.diff(b, dim=-1)[dead] == 0).all()


def test_integrate_stops_when_all_frozen(monkeypatch):
    """The step loop's stop once every ray is frozen changes no output."""
    geo, tab, elevs = _packed()
    ds = torch.tensor(10.0, dtype=torch.float64)
    stopped = TR.plain_fan(geo, tab, elevs, ds, n_steps=600)
    monkeypatch.setattr(TG, "_FROZEN_CHECK", 10 ** 9)
    full = TR.plain_fan(geo, tab, elevs, ds, n_steps=600)
    assert (stopped["steps_taken"] < 600).all()
    for k in TR.OUTPUTS:
        assert torch.equal(torch.nan_to_num(stopped[k]),
                           torch.nan_to_num(full[k])), k
