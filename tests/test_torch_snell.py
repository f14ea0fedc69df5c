"""PyTorch port vs the JAX package: the Snell tracers and the 1-D link
ionogram.

The same seeded inputs go through ``pyrayhf_tpu.snell`` /
``pyrayhf_tpu.oblique.synthesize_oblique_ionogram`` (CPU, float64) and
their ports on CPU tensors: the Gaussian profile of
``tests/test_tracers.py:26`` (from the ground) and a Chapman F2 + E profile
that starts at 80 km (the ground node is prepended). NaN masks must be
identical; finite values agree to rtol 1e-10 (tracers) and 1e-9 (the link
ionogram, whose crossings interpolate the fan).
"""

import dataclasses

import numpy as np
import pytest
import torch

import pyrayhf_tpu.oblique as JO
import pyrayhf_tpu.snell as JS
import pyrayhf_tpu_torch.oblique as TO
import pyrayhf_tpu_torch.snell as TS
from pyrayhf_tpu.config import SnellConfig as JSnellConfig
from pyrayhf_tpu_torch.config import SnellConfig

from _torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-10


def _gauss():
    alt = np.linspace(0, 600, 200)
    Ne = 1e12 * np.exp(-(alt - 250.0) ** 2 / (2 * 60.0 ** 2))
    return alt, Ne, np.full_like(alt, 4e-5), np.full_like(alt, 45.0)


def _chapman(seed=3):
    rng = np.random.default_rng(seed)
    alt = np.linspace(80.0, 600.0, 157)
    h = (alt - rng.uniform(280.0, 340.0)) / rng.uniform(40.0, 60.0)
    he = (alt - 110.0) / 8.0
    Ne = (rng.uniform(5e11, 1.5e12) * np.exp(0.5 * (1 - h - np.exp(-h)))
          + 8e10 * np.exp(0.5 * (1 - he - np.exp(-he))))
    bmag = 5e-5 * (6451.0 / (6371.0 + alt)) ** 3
    return alt, Ne, bmag, np.full_like(alt, rng.uniform(20.0, 70.0))


PROFILES = {"gauss": _gauss, "chapman": _chapman}


def _close(port, ref, rtol=RTOL, what=""):
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(
        port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    assert np.array_equal(np.isnan(port), np.isnan(ref)), what
    m = np.isfinite(ref)
    np.testing.assert_allclose(port[m], ref[m], rtol=rtol, atol=0,
                               err_msg=what)


def _tracers(geometry, single):
    name = ("trace_ray" if single else "trace_rays") + f"_{geometry}_snells"
    return getattr(JS, name), getattr(TS, name)


@pytest.mark.parametrize("profile", list(PROFILES))
@pytest.mark.parametrize("geometry", ["cartesian", "spherical"])
@pytest.mark.parametrize("mode", ["O", "X"])
def test_fans_match_jax(profile, geometry, mode):
    """[F, E] fans: every key, paths included."""
    alt, Ne, B, psi = PROFILES[profile]()
    f0s = np.array([3e6, 6e6, 9.5e6, 13e6, 30e6])
    els = np.linspace(5.0, 85.0, 17)
    jf, tf = _tracers(geometry, False)
    ref = jf(f0s, els, alt, Ne, B, psi, mode)
    port = tf(f0s, els, alt, Ne, B, psi, mode, device="cpu")
    assert set(port) == set(ref)
    for k in ref:
        _close(port[k], ref[k], what=k)
    rng = port["ground_range_km"].numpy()
    assert np.isfinite(rng).any() and np.isnan(rng).any()


@pytest.mark.parametrize("geometry", ["cartesian", "spherical"])
@pytest.mark.parametrize("mode", ["O", "X"])
def test_single_rays_match_jax(geometry, mode):
    alt, Ne, B, psi = _chapman()
    jf, tf = _tracers(geometry, True)
    for f0, el in ((5e6, 30.0), (9e6, 60.0), (12e6, 15.0)):
        ref = jf(f0, el, alt, Ne, B, psi, mode)
        port = tf(f0, el, alt, Ne, B, psi, mode, device="cpu")
        assert set(port) == set(ref)
        for k in ref:
            assert port[k].shape == np.shape(ref[k]), k
            _close(port[k], ref[k], what=f"{f0} {el} {k}")


@pytest.mark.parametrize("geometry", ["cartesian", "spherical"])
def test_invalid_ray_is_all_nan(geometry):
    """No turning point (above the critical frequency at 89°): every
    metric and the whole path NaN, in both packages."""
    alt, Ne, B, psi = _gauss()
    jf, tf = _tracers(geometry, True)
    port = tf(30e6, 89.0, alt, Ne, B, psi, "O", device="cpu")
    ref = jf(30e6, 89.0, alt, Ne, B, psi, "O")
    for k in port:
        assert torch.isnan(port[k]).all(), k
        assert np.isnan(np.asarray(ref[k])).all(), k


def test_ground_node_prepended():
    """A profile from 80 km: the ground node is prepended, so the path
    starts and ends at 0 km with alt[0] as its second node, and the
    absorption (free-space legs below alt[0]) equals the JAX package's."""
    alt, Ne, B, psi = _chapman()
    port = TS.trace_ray_spherical_snells(6e6, 25.0, alt, Ne, B, psi, "O",
                                         device="cpu")
    z = port["z"].numpy()
    assert z[0] == 0.0 and z[-1] == 0.0 and z[1] == alt[0]
    ref = JS.trace_ray_spherical_snells(6e6, 25.0, alt, Ne, B, psi, "O")
    _close(port["absorption_db"], ref["absorption_db"])


@pytest.mark.parametrize("geometry", ["cartesian", "spherical"])
def test_chunked_fan_equals_unchunked(monkeypatch, geometry):
    """The fan in chunks of one (profile, frequency) row — a byte budget
    too small for one row — equals the unchunked fan bit for bit."""
    alt, Ne, B, psi = _chapman()
    f0s = np.array([4e6, 7e6, 10e6, 14e6])
    els = np.linspace(5.0, 85.0, 21)
    tf = _tracers(geometry, False)[1]
    whole = tf(f0s, els, alt, Ne, B, psi, "X", device="cpu")
    assert TS.fan_chunk_rows(4, 21, alt.size + 1, 8,
                             geometry == "spherical") == 4
    monkeypatch.setattr(TS, "_FAN_BYTES", 1)
    assert TS.fan_chunk_rows(4, 21, alt.size + 1, 8,
                             geometry == "spherical") == 1
    chunked = tf(f0s, els, alt, Ne, B, psi, "X", device="cpu")
    for k in whole:
        assert torch.equal(torch.nan_to_num(whole[k], nan=-1.0),
                           torch.nan_to_num(chunked[k], nan=-1.0)), k


def test_profile_batch_equals_single_profiles():
    """The fan of a [G, N] profile stack (the oblique inversion's batched
    Jacobian and brute grid) equals G separate fans bit for bit."""
    alt, Ne, B, psi = _chapman()
    scale = np.array([0.6, 1.0, 1.3])
    f0s, els = np.array([5e6, 9e6]), np.linspace(10.0, 80.0, 9)
    t = [torch.from_numpy(np.asarray(a, dtype=np.float64))
         for a in (f0s, els, alt, Ne, B, psi)]
    nu = TS.collision_frequency(t[2])
    batch = TS._snell_fan(t[0], t[1], t[2], t[3] * torch.from_numpy(
        scale)[:, None], t[4], t[5], nu, 1.0, re=6371.0)
    for g, s in enumerate(scale):
        one = TS._snell_fan(t[0], t[1], t[2], t[3] * s, t[4], t[5], nu, 1.0,
                            re=6371.0)
        for k in one:
            assert torch.equal(torch.nan_to_num(batch[k][g], nan=-1.0),
                               torch.nan_to_num(one[k], nan=-1.0)), k


def test_snell_config_from_jax_config():
    """A SnellConfig built from dataclasses.asdict of the JAX one supplies
    mode and R_E as the JAX one does."""
    jcfg = JSnellConfig(mode="X", R_E_km=6371e9)
    cfg = SnellConfig(**dataclasses.asdict(jcfg))
    alt, Ne, B, psi = _gauss()
    ref = JS.trace_ray_spherical_snells(10e6, 50.0, alt, Ne, B, psi,
                                        config=jcfg)
    port = TS.trace_ray_spherical_snells(10e6, 50.0, alt, Ne, B, psi,
                                         config=cfg, device="cpu")
    explicit = TS.trace_ray_spherical_snells(10e6, 50.0, alt, Ne, B, psi,
                                             "X", R_E=6371e9, device="cpu")
    for k in ref:
        _close(port[k], ref[k], what=k)
        assert torch.equal(torch.nan_to_num(port[k]),
                           torch.nan_to_num(explicit[k])), k


@pytest.mark.parametrize("geometry", ["cartesian", "spherical"])
@pytest.mark.parametrize("n_hops,ground", [(1, None), (2, None),
                                           (2, "medium")])
def test_oblique_ionogram_matches_jax(geometry, n_hops, ground):
    """synthesize_oblique_ionogram: every output key, rtol 1e-9."""
    alt, Ne, B, psi = _chapman()
    f0s = np.arange(3e6, 22e6, 1e6)
    kw = dict(geometry=geometry, n_elev=96, n_hops=n_hops, ground=ground)
    ref = JO.synthesize_oblique_ionogram(f0s, 1200.0, alt, Ne, B, psi,
                                         **kw)
    port = TO.synthesize_oblique_ionogram(f0s, 1200.0, alt, Ne, B, psi,
                                          device="cpu", **kw)
    assert set(port) == set(ref)
    for k in ref:
        _close(port[k], ref[k], rtol=1e-9, what=k)
    dl = port["delay_low_sec"].numpy()
    assert np.isfinite(dl).any() and np.isnan(dl).any()     # a MUF nose


def test_spherical_f32_rays_stay_finite():
    """In float32 the apex floor holds: no landed ray has an infinite
    range, and the f32 fan lands where the f64 fan does."""
    alt, Ne, B, psi = _chapman()
    f0s = np.array([5e6, 9e6, 13e6, 17e6])
    els = np.linspace(5.0, 85.0, 96)
    out = {}
    for dt in (torch.float32, torch.float64):
        t = [torch.as_tensor(a, dtype=dt) for a in (f0s, els, alt, Ne, B,
                                                     psi)]
        out[dt] = TS.trace_rays_spherical_snells(*t, "O")["ground_range_km"]
    assert not torch.isinf(out[torch.float32]).any()
    assert torch.equal(torch.isfinite(out[torch.float32]),
                       torch.isfinite(out[torch.float64]))
    fin = torch.isfinite(out[torch.float64])
    assert torch.allclose(out[torch.float32][fin].double(),
                          out[torch.float64][fin], rtol=1e-3)


@pytest.mark.parametrize("mode", ["O", "X"])
def test_cartesian_f32_grazing_fan_keeps_to_f64(mode):
    """The Cartesian apex floor (``pe + 1e-8``, below float32's resolution
    for p near 1) does not part grazing f32 rays from the JAX package's
    f64 fan: the same rays land, none at an infinite range, within 2e-4
    above 0.25° of elevation. At 0.05° the f32 error grows to a few
    percent from p = μ0·sin(90° − el) itself (1 − p² ≈ 8e-7 is carried by
    a few float32 ulps); the spherical floor's p·(1 + 4ε) changes that by
    less than it, so the floor stays the JAX package's."""
    alt, Ne, B, psi = _chapman()
    f0s = np.array([5e6, 9e6, 13e6, 17e6])
    els = np.array([0.05, 0.1, 0.3, 1.0, 2.0, 5.0, 15.0, 45.0])
    port = TS.trace_rays_cartesian_snells(
        *[torch.as_tensor(a, dtype=torch.float32)
          for a in (f0s, els, alt, Ne, B, psi)], mode)["ground_range_km"]
    ref = np.asarray(JS.trace_rays_cartesian_snells(
        f0s, els, alt, Ne, B, psi, mode)["ground_range_km"])
    port = port.double().numpy()
    assert not np.isinf(port).any()
    np.testing.assert_array_equal(np.isnan(port), np.isnan(ref))
    rel = np.abs(port - ref) / np.abs(ref)
    assert np.isfinite(ref[:, els > 0.25]).sum() > 20
    assert np.nanmax(rel[:, els > 0.25]) < 2e-4
    assert np.nanmax(rel) < 0.05
