"""PyTorch port vs the JAX package: constants and the magnetoionic core.

Inputs are made with numpy from a seed and fed to both packages in f64.
Tolerance: rtol 1e-12 against JAX (the same expressions in the same
order; only last-ulp differences between the two libraries' sin/cos
remain), and the goldens at the tolerance of ``tests/test_magnetoionic.py``.
The random lattice keeps |1 − X| ≥ 1e-3: nearer the reflection point μ'
amplifies a 1-ulp sin/cos difference by ~1/|1 − X| (measured 8.8e-12 at
1 − X = 5e-6), a conditioning effect, not a port difference; the goldens
cover that region.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from numpy.testing import assert_allclose

import pyrayhf_tpu.magnetoionic as J
import pyrayhf_tpu_torch.magnetoionic as T
from pyrayhf_tpu.constants import constants as jax_constants
from pyrayhf_tpu_torch.constants import constants as torch_constants

from _torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-12


def _lattice(seed=11, n=3000):
    """Random (X, Y, ψ) with X on both sides of 1 (|1 − X| ≥ 1e-3),
    unmagnetised samples and ψ at the 0°/90° edges."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(0.0, 1.3, n)
    X = np.where(np.abs(1.0 - X) < 1e-3, X + 2e-3, X)
    Y = rng.uniform(0.0, 0.6, n)
    Y[:40] = 0.0
    psi = rng.uniform(0.0, 90.0, n)
    psi[::97] = 90.0
    psi[::89] = 0.0
    return X, Y, psi


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float64))


def _assert_same(port, ref, rtol=RTOL):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else port
    ref = np.asarray(ref)
    assert np.array_equal(np.isnan(port), np.isnan(ref))
    m = np.isfinite(ref)
    assert np.array_equal(np.isfinite(port), m)
    assert_allclose(port[m], ref[m], rtol=rtol, atol=0)


def test_constants_match_jax():
    assert torch_constants() == jax_constants()


def test_plasma_functions_match_jax():
    rng = np.random.default_rng(5)
    den = rng.uniform(0.0, 3e12, 64)
    f = rng.uniform(1e5, 3e7, 64)
    b = rng.uniform(2e-5, 7e-5, 64)
    _assert_same(T.den2freq(_t(den)), J.den2freq(den))
    _assert_same(T.freq2den(_t(f)), J.freq2den(f))
    _assert_same(T.find_X(_t(den), _t(f)), J.find_X(den, f))
    _assert_same(T.find_Y(_t(f), _t(b)), J.find_Y(f, b))


@pytest.mark.parametrize("mode", ["O", "X"])
@pytest.mark.parametrize("arithmetic", ["stable", "reference"])
def test_find_mu_mup_matches_jax(mode, arithmetic):
    X, Y, psi = _lattice()
    mu_j, mup_j = J.find_mu_mup(X, Y, psi, mode, arithmetic=arithmetic)
    mu_t, mup_t = T.find_mu_mup(_t(X), _t(Y), _t(psi), mode,
                                arithmetic=arithmetic)
    _assert_same(mu_t, mu_j)
    _assert_same(mup_t, mup_j)


def test_find_mu_mup_unmagnetised_branch_matches_jax():
    X = np.array([0.1, 0.2, 0.999, 1.0, 1.2])
    zero = np.zeros_like(X)
    mu_j, mup_j = J.find_mu_mup(X, zero, zero, "O")
    mu_t, mup_t = T.find_mu_mup(_t(X), _t(zero), _t(zero), "O")
    _assert_same(mu_t, mu_j)
    _assert_same(mup_t, mup_j)


@pytest.mark.parametrize("mode", ["O", "X"])
def test_find_mu_mup_lattice_goldens(goldens, mode):
    """The 1855-point reference lattice, at test_magnetoionic's tolerance."""
    X = goldens["mu_lattice_X_in"]
    Y = goldens["mu_lattice_Y_in"]
    psi = goldens["mu_lattice_psi_in"]
    # X == 1 with ψ == 90° exactly: the reference's denominator is ±1 ulp
    # of zero there (arithmetic noise), excluded as in test_magnetoionic
    keep = ~((X == 1.0) & (psi == 90.0) & (Y > 0))
    mu, mup = T.find_mu_mup(_t(X), _t(Y), _t(psi), mode)
    mu, mup = mu.numpy()[keep], mup.numpy()[keep]
    ref_mu = goldens[f"mu_lattice_{mode}"][keep]
    ref_mup = goldens[f"mup_lattice_{mode}"][keep]
    assert np.array_equal(np.isnan(mu), np.isnan(ref_mu))
    m = np.isfinite(ref_mu)
    assert_allclose(mu[m], ref_mu[m], rtol=1e-13)
    m2 = np.isfinite(ref_mup)
    assert np.array_equal(np.isfinite(mup), m2)
    assert_allclose(mup[m2], ref_mup[m2], rtol=1e-12)


@pytest.mark.parametrize("mode", ["O", "X"])
def test_find_mu_mup_masked_matches_jax(mode):
    X, Y, psi = _lattice(seed=12)
    mu_j, mup_j, ok_j = J.find_mu_mup_masked(X, Y, psi, mode)
    mu_t, mup_t, ok_t = T.find_mu_mup_masked(_t(X), _t(Y), _t(psi), mode)
    assert np.array_equal(ok_t.numpy(), np.asarray(ok_j))
    ok = np.asarray(ok_j)
    assert_allclose(mu_t.numpy()[ok], np.asarray(mu_j)[ok], rtol=RTOL)
    assert_allclose(mup_t.numpy()[ok], np.asarray(mup_j)[ok], rtol=RTOL)


@pytest.mark.parametrize("mode", ["O", "X"])
def test_masked_gradient_matches_jax(mode):
    """Autograd through valid entries equals jax.grad, NaNs included.

    A sample with Y == 0 inside a magnetised batch takes the magnetised
    branch with β = sqrt(0), whose derivative times a zero cotangent is
    NaN — in the JAX package as in the port (ROADMAP Queue 3). Every other
    gradient is finite. rtol 1e-9: the two backward passes sum the same
    terms in another order.
    """
    X, Y, psi = _lattice(seed=13, n=400)

    def loss_j(x):
        _, mup, ok = J.find_mu_mup_masked(x, Y, psi, mode)
        return jnp.sum(jnp.where(ok, mup, 0.0))

    g_j = np.asarray(jax.grad(loss_j)(jnp.asarray(X)))
    x = _t(X).requires_grad_(True)
    _, mup, ok = T.find_mu_mup_masked(x, _t(Y), _t(psi), mode)
    g_t = torch.autograd.grad(torch.where(ok, mup, 0.0).sum(), x)[0].numpy()
    finite = np.isfinite(g_j)
    assert np.array_equal(np.isfinite(g_t), finite)
    assert np.array_equal(finite, Y != 0.0)
    assert_allclose(g_t[finite], g_j[finite], rtol=1e-9,
                    atol=1e-12 * np.abs(g_j[finite]).max())


def test_dtype_and_device_follow_inputs():
    X, Y, psi = (torch.tensor(v, dtype=torch.float32)
                 for v in ([0.3, 0.9], [0.1, 0.2], [30.0, 60.0]))
    mu, mup = T.find_mu_mup(X, Y, psi, "X")
    assert mu.dtype == mup.dtype == torch.float32
    # array-likes are host data created on the tensors' device and dtype
    mu2, _ = T.find_mu_mup(X, Y, 45.0, "O")
    assert mu2.dtype == torch.float32 and mu2.device == X.device


def test_mode_and_arithmetic_errors():
    with pytest.raises(ValueError, match="Mode must be O or X"):
        T.mode_multiplier("Z")
    with pytest.raises(ValueError, match="arithmetic"):
        T.find_mu_mup(_t([0.5]), _t([0.1]), _t([30.0]), "O",
                      arithmetic="fast")
