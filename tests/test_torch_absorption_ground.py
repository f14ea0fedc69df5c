"""PyTorch port vs the JAX package: absorption and ground reflection.

Inputs are made with numpy from a seed and fed to both packages in f64.
Tolerance: rtol 1e-12 with identical NaN masks (the same expressions in
the same order); the vertical absorption integral, a sum over 2,000 grid
points, at rtol 1e-10.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from numpy.testing import assert_allclose

import pyrayhf_tpu.absorption as JA
import pyrayhf_tpu.ground as JG
import pyrayhf_tpu.magnetoionic as JM
import pyrayhf_tpu_torch.absorption as TA
import pyrayhf_tpu_torch.ground as TG

from _torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-12


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


def _same(port, ref, rtol=RTOL):
    port = port.detach().numpy()
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    assert np.array_equal(np.isnan(port), np.isnan(ref))
    m = np.isfinite(ref)
    assert m.any()
    assert_allclose(port[m], ref[m], rtol=rtol, atol=0)


def test_collision_frequency_matches_jax():
    alt = np.linspace(0.0, 700.0, 141)
    _same(TA.collision_frequency(_t(alt)), JA.collision_frequency(alt))
    _same(TA.collision_frequency(alt, nu0=1e10, scale_km=9.0, device="cpu"),
          JA.collision_frequency(alt, nu0=1e10, scale_km=9.0))


@pytest.mark.parametrize("mode", ["O", "X"])
def test_absorption_coefficient_matches_jax(mode):
    """Samples on both sides of reflection: NaN μ gives NaN κ."""
    rng = np.random.default_rng(31)
    n = 2000
    ne = 10.0 ** rng.uniform(8.0, 12.3, n)
    nu = 10.0 ** rng.uniform(3.0, 7.0, n)
    f = rng.uniform(2e6, 20e6, n)
    b = rng.uniform(2e-5, 6e-5, n)
    psi = rng.uniform(0.0, 90.0, n)
    X, Y = JM.find_X(ne, f), JM.find_Y(f, b)
    mu, _ = JM.find_mu_mup(X, Y, psi, mode)
    mu = np.asarray(mu)
    assert np.isnan(mu).any() and np.isfinite(mu).any()
    args = (ne, nu, f, b, psi, mu)
    _same(TA.absorption_coefficient(*map(_t, args), mode=mode),
          JA.absorption_coefficient(*map(jnp.asarray, args), mode=mode))


@pytest.mark.parametrize("mode", ["O", "X"])
def test_vertical_absorption_operator_matches_jax(mode):
    alt = np.linspace(60.0, 500.0, 221)
    den = 1.2e12 * np.exp(-((alt - 280.0) / 60.0) ** 2) + 1e9 * np.exp(
        -((alt - 100.0) / 10.0) ** 2)
    bmag, bpsi = np.full_like(alt, 4.8e-5), np.full_like(alt, 35.0)
    freqs = np.array([1.5, 3.0, 5.0, 8.0, 9.8, 12.0])
    args = (freqs, den, bmag, bpsi, alt)
    ref = JA.vertical_absorption_operator(*args, mode=mode)
    port = TA.vertical_absorption_operator(*map(_t, args), mode=mode)
    assert np.isnan(np.asarray(ref)).any()           # above foF2 escapes
    _same(port, ref, rtol=1e-10)
    nu = 3e6 * np.exp(-(alt - 70.0) / 7.0)
    _same(TA.vertical_absorption_operator(*args, mode=mode, nu=nu,
                                          n_points=300, device="cpu"),
          JA.vertical_absorption_operator(*args, mode=mode, nu=nu,
                                          n_points=300), rtol=1e-10)


def _angles():
    rng = np.random.default_rng(32)
    f = rng.uniform(2e6, 30e6, 400)
    g = rng.uniform(0.5, 89.5, 400)
    g[:3] = [0.0, 45.0, 90.0]
    return f, g


@pytest.mark.parametrize("ground", ["sea", "wet", "medium", "dry",
                                    (8.0, 3e-3)])
def test_fresnel_and_ground_loss_match_jax(ground):
    f, g = _angles()
    eps_r, sigma = TG.resolve_ground(ground)
    assert (eps_r, sigma) == JG.resolve_ground(ground)
    for p, r in zip(TG.fresnel_coefficients_real(_t(f), _t(g), eps_r, sigma),
                    JG.fresnel_coefficients_real(f, g, eps_r, sigma)):
        _same(p, r)
    rv, rh = TG.fresnel_coefficients(_t(f), _t(g), eps_r, sigma)
    jv, jh = JG.fresnel_coefficients(f, g, eps_r, sigma)
    assert_allclose(rv.numpy(), jv, rtol=RTOL)
    assert_allclose(rh.numpy(), jh, rtol=RTOL)
    for pol in ("circular", "vertical", "horizontal"):
        _same(TG.ground_reflection_loss_db(_t(f), _t(g), ground, pol),
              JG.ground_reflection_loss_db(f, g, ground, pol))


def test_ground_errors_and_presets():
    assert TG.GROUND_PRESETS == JG.GROUND_PRESETS
    with pytest.raises(ValueError, match="unknown ground preset"):
        TG.resolve_ground("swamp")
    with pytest.raises(ValueError, match="polarization"):
        TG.ground_reflection_loss_db(_t([5e6]), _t([10.0]),
                                     polarization="elliptic")


def test_hypot_matches_jnp_hypot():
    """The split-real √ uses jnp.hypot's own formula (zeros, infinities,
    a spread of magnitudes); XLA may contract to FMAs, so to a few ulp."""
    rng = np.random.default_rng(33)
    a = rng.normal(size=300) * 10.0 ** rng.uniform(-5, 5, 300)
    b = rng.normal(size=300) * 10.0 ** rng.uniform(-5, 5, 300)
    a[:4], b[:4] = [0.0, 0.0, np.inf, 3.0], [0.0, -2.0, 1.0, -np.inf]
    port, ref = TG._hypot(_t(a), _t(b)).numpy(), np.asarray(jnp.hypot(a, b))
    assert np.array_equal(np.isinf(port), np.isinf(ref))
    assert_allclose(port, ref, rtol=1e-15, atol=0)
