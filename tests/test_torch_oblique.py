"""PyTorch port vs the JAX package: the 2-D oblique-ionogram slice.

The port's fan (both engines, on CPU tensors: the plain gradient-ODE fan
and the kernel wrapper's plain version) against the JAX fan's ``xla``
engine and its ``pallas`` engine in interpret mode, on the small scene of
``tests/test_pallas_ray.py`` (101×17, F=2, E=24, 250–400 steps); then
every key of ``synthesize_oblique_ionogram_2d``. Inputs are numpy from a
seed; f64. Tolerance: rtol 1e-8, atol 1e-10 with equal NaN positions,
the JAX package's own bound between its two engines
(``tests/test_pallas_ray.py:58``).
"""

import functools

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import pyrayhf_tpu.oblique as JO
import pyrayhf_tpu_torch.oblique as TO
from pyrayhf_tpu_torch import pallas_ray as TR

from _torch_threads import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-8, 1e-10
NAMES = ("range", "delay", "absorb", "path", "phase", "elevs")


def _scene(nz=101, nx=17, tilt=0.15):
    z = np.linspace(0.0, 400.0, nz)
    x = np.linspace(0.0, 2000.0, nx)
    h = (z[:, None] - 250.0) / 45.0
    nmf2 = 8.0e11 * (1.0 + tilt * (x[None, :] / x[-1] - 0.5))
    ne = nmf2 * np.exp(0.5 * (1.0 - h - np.exp(-h)))
    babs = np.full((nz, nx), 4.5e-5)
    bpsi = np.full((nz, nx), np.deg2rad(30.0))
    nu_z = 1e7 * np.exp(-(z - 70.0) / 8.0)
    return z, x, ne, babs, bpsi, nu_z


# (geometry, mode, n_hops, n_steps)
FANS = {"cartesian": ("cartesian", "O", 1, 250),
        "spherical": ("spherical", "O", 1, 250),
        "x_2hop": ("cartesian", "X", 2, 400)}
ARGS = (np.array([5.0e6, 9.0e6]), np.array([8.0, 60.0]))


@functools.lru_cache(maxsize=None)
def _jax_fan(case, engine):
    geometry, mode, n_hops, n_steps = FANS[case]
    z, x, ne, babs, bpsi, nu_z = _scene()
    fan = JO._fan_2d_fn(z, x, mode, geometry, 24, n_steps, n_hops,
                        engine=engine)
    out = fan(*(jnp.asarray(a) for a in (*ARGS, ne, babs, bpsi, nu_z)),
              jnp.asarray(10.0))
    return [np.asarray(o) for o in out]


def _port_fan(case, engine):
    geometry, mode, n_hops, n_steps = FANS[case]
    z, x, ne, babs, bpsi, nu_z = _scene()
    fan = TO._fan_2d_fn(z, x, mode, geometry, 24, n_steps, n_hops,
                        engine=engine)
    return [o.numpy() for o in fan(*ARGS, ne, babs, bpsi, nu_z, 10.0,
                                   device="cpu")]


@pytest.mark.parametrize("case", list(FANS))
@pytest.mark.parametrize("engine", ["xla", "pallas"])
def test_fan_matches_jax_engines(case, engine):
    """Each port engine against both JAX engines."""
    TR.reset_counters()
    got = _port_fan(case, engine)
    assert TR.LAUNCHES["fan_2d"] == 0
    assert TR.PLAIN_CALLS["fan_2d"] == (engine == "pallas")
    for jax_engine in ("xla", "pallas"):
        ref = _jax_fan(case, jax_engine)
        for name, r, g in zip(NAMES, ref, got):
            assert g.shape == r.shape, name
            assert np.allclose(r, g, rtol=RTOL, atol=ATOL, equal_nan=True), (
                jax_engine, name)
    assert np.isfinite(got[0]).any() and np.isnan(got[0]).any()


def test_two_hop_fan_bounces():
    """The bounce branch fires: the 2-hop X fan differs from 1-hop."""
    z, x, ne, babs, bpsi, nu_z = _scene()
    one = TO._fan_2d_fn(z, x, "X", "cartesian", 24, 400, 1, engine="xla")(
        *ARGS, ne, babs, bpsi, nu_z, 10.0, device="cpu")
    two = _port_fan("x_2hop", "xla")
    assert not np.allclose(one[0].numpy(), two[0], equal_nan=True)


# (geometry, n_hops, ground, first altitude row: 0 = grid from the ground,
# 20 = from 80 km, extended by the free-space ladder)
SYNTH = {"cartesian": ("cartesian", 1, None, 0),
         "spherical_2hop_ground": ("spherical", 2, "medium", 0),
         "ladder_2hop_ground": ("cartesian", 2, "sea", 20)}


def _synth_kw(case):
    geometry, n_hops, ground, k = SYNTH[case]
    z, x, ne, babs, bpsi, nu_z = _scene()
    return dict(f0s_hz=np.array([6.0e6, 8.0e6]),
                ground_range_km=800.0 * n_hops, x_grid_km=x,
                z_grid_km=z[k:], Ne2d=ne[k:], Babs2d=babs[k:],
                bpsi2d=bpsi[k:], n_elev=24, elev_min_deg=8.0,
                elev_max_deg=60.0, step_km=10.0, s_max_km=2500.0,
                nu=nu_z[k:], geometry=geometry, n_hops=n_hops,
                ground=ground)


@pytest.mark.parametrize("case", list(SYNTH))
@pytest.mark.parametrize("engine", ["xla", "pallas"])
def test_synthesize_2d_matches_jax(case, engine):
    kw = _synth_kw(case)
    ref = JO.synthesize_oblique_ionogram_2d(engine=engine, **kw)
    got = TO.synthesize_oblique_ionogram_2d(engine=engine, device="cpu",
                                            **kw)
    assert set(got) == set(ref)
    for k in ref:
        r, g = np.asarray(ref[k]), got[k].numpy()
        assert g.shape == r.shape, k
        assert np.allclose(r, g, rtol=RTOL, atol=ATOL, equal_nan=True), k
    assert np.isfinite(got["delay_low_sec"].numpy()).any()
    if kw["ground"] is not None:
        assert (got["ground_loss_low_db"][torch.isfinite(
            got["ground_loss_low_db"])] > 0).all()


def test_auto_on_cpu_tensors_takes_the_plain_gradient_fan():
    kw = _synth_kw("cartesian")
    TR.reset_counters()
    auto = TO.synthesize_oblique_ionogram_2d(device="cpu", **kw)
    assert TR.LAUNCHES["fan_2d"] == 0 and TR.PLAIN_CALLS["fan_2d"] == 0
    xla = TO.synthesize_oblique_ionogram_2d(engine="xla", device="cpu", **kw)
    for k in auto:
        assert torch.equal(torch.nan_to_num(auto[k]),
                           torch.nan_to_num(xla[k])), k


def test_engine_routing():
    """The JAX package's routing, its errors, and no table-size gate."""
    z, x = _scene()[:2]
    big_z, big_x = np.linspace(0.0, 620.0, 621), np.linspace(0, 3995, 800)
    assert TO._resolve_fan_engine("auto", z, x, "cuda") == "pallas"
    assert TO._resolve_fan_engine("auto", big_z, big_x, "cuda") == "pallas"
    assert TO._resolve_fan_engine("auto", z, x, "cpu") == "xla"
    z_nu = np.concatenate([np.linspace(0, 100, 20),
                           np.geomspace(110, 400, 30)])
    assert TO._resolve_fan_engine("auto", z_nu, x, "cuda") == "xla"
    for mod in (JO, TO):
        with pytest.raises(ValueError, match="uniform"):
            mod._fan_2d_fn(z_nu, x, "O", "cartesian", 8, 50, 1,
                           engine="pallas")
        with pytest.raises(ValueError, match="engine"):
            mod._fan_2d_fn(x, x, "O", "cartesian", 8, 50, 1,
                           engine="mosaic")
    kw = _synth_kw("cartesian")
    with pytest.raises(ValueError, match="geometry"):
        TO.synthesize_oblique_ionogram_2d(**{**kw, "geometry": "polar"},
                                          device="cpu")
    # a start that the spacing does not divide gets one ground node: the
    # grid is then non-uniform, and the kernel engine refuses it (as JAX)
    kw = {**_synth_kw("cartesian"), "z_grid_km": z[10:] + 1.0}
    kw.update(Ne2d=kw["Ne2d"][10:], Babs2d=kw["Babs2d"][10:],
              bpsi2d=kw["bpsi2d"][10:], nu=kw["nu"][10:])
    for mod, extra in ((JO, {}), (TO, {"device": "cpu"})):
        with pytest.raises(ValueError, match="uniform"):
            mod.synthesize_oblique_ionogram_2d(engine="pallas", **kw,
                                               **extra)


def test_crossings_match_jax():
    """Low/high crossings with escapes, layer-transition jumps and the
    light-time filter, batched over frequencies."""
    rng = np.random.default_rng(41)
    E = 40
    elev = np.linspace(5.0, 80.0, E)
    rng_e = 2500.0 * np.cos(np.deg2rad(elev))[None, :] * rng.uniform(
        0.8, 1.2, (6, 1)) + rng.normal(0.0, 20.0, (6, E))
    rng_e[1, 25:] = np.nan
    rng_e[2, 10] += 500.0
    delay = 0.01 * rng.uniform(0.5, 1.0, (6, E))
    chans = (delay, rng.normal(size=(6, E)))
    lo_j, hi_j = [], []
    for i in range(6):
        lo, hi = JO._crossings(jnp.asarray(rng_e[i]),
                               tuple(jnp.asarray(c[i]) for c in chans),
                               jnp.asarray(elev), 1200.0, 200.0, 0.004)
        lo_j.append([np.asarray(v) for v in lo])
        hi_j.append([np.asarray(v) for v in hi])
    lo_t, hi_t = TO._crossings(torch.from_numpy(rng_e),
                               tuple(torch.from_numpy(c) for c in chans),
                               torch.from_numpy(elev), 1200.0, 200.0, 0.004)
    for got, ref in ((lo_t, lo_j), (hi_t, hi_j)):
        for j, g in enumerate(got):
            r = np.array([row[j] for row in ref])
            assert np.allclose(g.numpy(), r, rtol=1e-12, atol=0,
                               equal_nan=True)
    assert torch.isfinite(lo_t[0]).any() and torch.isnan(lo_t[0]).any()


def _two_node_kw():
    """A range-independent slice written with a 2-node x axis: a Gaussian
    F layer (1e12 m^-3 at 300 km) on 121 uniform heights, 80-680 km."""
    x = np.array([-100.0, 3000.0])
    z = np.linspace(80.0, 680.0, 121)
    ne = np.repeat(1e12 * np.exp(-((z - 300.0) / 50.0) ** 2)[:, None], 2, 1)
    return dict(f0s_hz=np.array([5.0e6, 7.0e6]), ground_range_km=1000.0,
                x_grid_km=x, z_grid_km=z, Ne2d=ne,
                Babs2d=np.full(ne.shape, 4.5e-5),
                bpsi2d=np.full(ne.shape, np.deg2rad(30.0)), n_elev=16,
                s_max_km=1500.0)


@pytest.mark.parametrize("engine", ["xla", "pallas"])
def test_synthesize_2d_on_a_two_node_x_axis_matches_jax(engine):
    """Every key as the JAX package gives it, on each engine (the kernel
    engine through its plain version here): the x gradient is the clamped
    edge stencil's exact 0 of a field constant in x."""
    kw = _two_node_kw()
    ref = JO.synthesize_oblique_ionogram_2d(engine=engine, **kw)
    TR.reset_counters()
    got = TO.synthesize_oblique_ionogram_2d(engine=engine, device="cpu",
                                            **kw)
    assert TR.PLAIN_CALLS["fan_2d"] == (engine == "pallas")
    assert set(got) == set(ref)
    for k in ref:
        r, g = np.asarray(ref[k]), got[k].numpy()
        assert g.shape == r.shape, k
        assert np.allclose(r, g, rtol=RTOL, atol=ATOL, equal_nan=True), k
    assert np.isfinite(got["delay_low_sec"].numpy()).any()
