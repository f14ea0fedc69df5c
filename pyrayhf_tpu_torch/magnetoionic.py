"""Appleton–Hartree magnetoionic core, branch-free, in PyTorch.

Port of ``pyrayhf_tpu.magnetoionic``: the same expressions in the same
order, with ``torch.where`` in place of ``jnp.where``. NaN conventions match
the reference exactly:

  - ``under_sqrt < 0``  → μ = NaN (evanescent / ray escapes),
  - ``μ > 1``           → NaN (non-physical),
  - unmagnetised branch (max|Y| < y_tol): μ = sqrt(1-X) for X < 1 else NaN,
    μ' = 1/μ where μ > 0 else NaN.

The masked variant sanitises every dangerous denominator with a double
``where``, so autograd through valid entries never sees a 0·NaN cotangent
(``torch.where``, like ``jnp.where``, backpropagates into both branches).
Powers are written as the products ``lax.integer_pow`` forms (x³ = x·x²,
x⁴ = x²·x²), so float64 results agree with the JAX package to the last
few ulps.
"""

import math

import torch

from ._util import as_tensors
from .constants import CP, G_P

__all__ = [
    "den2freq", "freq2den", "find_X", "find_Y",
    "find_mu_mup", "find_mu_mup_masked", "mode_multiplier",
]

_NAN = float("nan")
_DEG2RAD = math.pi / 180.0


def _sq(x):
    return x * x


def den2freq(density):
    """Plasma density [m^-3] → plasma frequency [Hz]. (ref library.py:75-97)"""
    (density,) = as_tensors(density)
    return torch.sqrt(density) * CP


def freq2den(frequency):
    """Plasma frequency [Hz] → density [m^-3]. (ref library.py:100-117)"""
    (frequency,) = as_tensors(frequency)
    return _sq(frequency / CP)


def find_X(n_e, f):
    """X = (f_N / f)^2, squared plasma-to-wave ratio. (ref :120-137)"""
    n_e, f = as_tensors(n_e, f)
    return _sq(den2freq(n_e)) / _sq(f)


def find_Y(f, b):
    """Y = f_ce / f, the gyro-to-wave frequency ratio. (ref :140-158)"""
    f, b = as_tensors(f, b)
    return G_P * b / f


def mode_multiplier(mode):
    """Map mode string 'O'/'X' to the ±1 Appleton–Hartree branch multiplier."""
    if mode == "O":
        return 1.0
    if mode == "X":
        return -1.0
    raise ValueError("Mode must be O or X")


def _iso_mu_mup(X):
    """Unmagnetised cold-plasma indices: μ = sqrt(1-X), μ' = 1/μ."""
    mu2 = 1.0 - X
    valid = mu2 > 0.0
    mu = torch.where(valid, torch.sqrt(torch.where(valid, mu2, 1.0)), _NAN)
    pos = torch.isfinite(mu) & (mu > 0.0)
    mup = torch.where(pos, 1.0 / torch.where(pos, mu, 1.0), _NAN)
    return mu, mup


def _magnetized_mu_mup(X, Y, bpsi_deg, mode_mult, sanitize, naive_o=False):
    """Appleton–Hartree μ and analytic group index μ' (magnetised branch).

    ``sanitize=False`` lets singular denominators produce inf/NaN exactly
    as NumPy would (bit-parity mode); ``sanitize=True`` guards each one by
    a double ``where`` (gradient mode). ``naive_o=True`` evaluates the
    O-mode branch with the reference's expression sequence instead of the
    cancellation-free rewrite (see ``pyrayhf_tpu.magnetoionic``).
    """
    psi = bpsi_deg * _DEG2RAD
    sinp = torch.sin(psi)
    cosp = torch.cos(psi)
    YT = Y * sinp
    YL = Y * cosp
    Xm1 = 1.0 - X

    alpha = 0.25 * _sq(_sq(YT)) + _sq(YL) * _sq(Xm1)
    beta = torch.sqrt(alpha)

    if mode_mult > 0 and not naive_o:
        # cancellation-free O-mode rewrite:
        #   β - ½YT² = YL²(1-X)² / (β + ½YT²) ≡ s,  D = (1-X) + s,
        #   under = ((1-X)² + s) / ((1-X) + s)
        bsum = beta + 0.5 * _sq(YT)
        b_ok0 = bsum > 0.0
        bsum_safe = torch.where(b_ok0, bsum, 1.0)
        s = torch.where(b_ok0, _sq(YL) * _sq(Xm1) / bsum_safe, 0.0)
        # at Xm1 == 0 exactly reproduce the naive form's ±ulp residue
        D_naive = Xm1 - 0.5 * _sq(YT) + mode_mult * beta
        D = torch.where(Xm1 == 0.0, D_naive, Xm1 + s)
        d_ok = D != 0.0
        D_safe = torch.where(d_ok, D, 1.0)
        under = torch.where(Xm1 == 0.0,
                            1.0 - X * Xm1 / D_safe,
                            (_sq(Xm1) + s) / D_safe)
        under = torch.where(d_ok, under, _NAN)
    else:
        D = Xm1 - 0.5 * _sq(YT) + mode_mult * beta
        d_ok = D != 0.0
        D_safe = torch.where(d_ok, D, 1.0) if sanitize else D
        under = 1.0 - X * Xm1 / D_safe

    u_ok = (under >= 0.0) & d_ok
    if sanitize:
        mu = torch.where(u_ok, torch.sqrt(torch.where(u_ok, under, 1.0)),
                         _NAN)
    else:
        # replicate: under_sqrt[under_sqrt < 0] = nan; mu = sqrt(under_sqrt)
        mu = torch.sqrt(torch.where(under < 0.0, _NAN, under))
    mu = torch.where(mu > 1.0, _NAN, mu)

    # Analytic derivatives for μ' = μ - (2X ∂μ/∂X + Y ∂μ/∂Y).
    b_ok = beta > 0.0
    beta_safe = torch.where(b_ok, beta, 1.0) if sanitize else beta
    dbetadX = -_sq(YL) * Xm1 / beta_safe
    dDdX = -1.0 + mode_mult * dbetadX
    dalphadY = YT * _sq(YT) * sinp + 2.0 * YL * _sq(Xm1) * cosp
    dbetadY = 0.5 * dalphadY / beta_safe
    dDdY = -YT * sinp + mode_mult * dbetadY

    m_ok = u_ok & b_ok & (mu > 0.0)
    mu_safe = torch.where(m_ok, mu, 1.0) if sanitize else mu
    dmudY = (X * Xm1 * dDdY) / (2.0 * mu_safe * _sq(D_safe))
    dmudX = (1.0 / (2.0 * mu_safe * D_safe)) * (
        2.0 * X - 1.0 + X * Xm1 / D_safe * dDdX)
    mup = mu - (2.0 * X * dmudX + Y * dmudY)

    valid = m_ok & torch.isfinite(mup)
    return mu, mup, valid


def _nanmax_abs_below(Y, y_tol, batch_dims=0):
    """``jnp.nanmax(jnp.abs(Y)) < y_tol`` (no sync) for each index of the
    first ``batch_dims`` axes, reduced over the others and kept as size-1
    axes so that it broadcasts against ``Y``: what ``jax.vmap`` over those
    axes decides. ``batch_dims=0`` decides once over the whole array."""
    a = torch.abs(Y).flatten(batch_dims)
    nan = torch.isnan(a)
    m = torch.where(nan, -math.inf, a).amax(dim=-1)
    # all-NaN input: nanmax is NaN and the comparison is False
    below = (m < y_tol) & ~nan.all(dim=-1)
    return below.reshape(below.shape + (1,) * (Y.ndim - batch_dims))


def find_mu_mup(X, Y, bpsi, mode="O", *, y_tol=1e-12, arithmetic="stable"):
    """Phase (μ) and group (μ') refractive indices, reference-parity NaNs.

    ``X``, ``Y``, ``bpsi`` [deg] are broadcastable; ``mode`` ∈ {'O','X'}.
    ``arithmetic="stable"`` (default) evaluates the O-mode branch with the
    cancellation-free factorisation; ``"reference"`` replicates the
    reference's expression sequence, rounding error included. The
    unmagnetised branch is decided once over the whole input.
    """
    return _find_mu_mup(X, Y, bpsi, mode, 0, y_tol=y_tol,
                        arithmetic=arithmetic)


def _find_mu_mup(X, Y, bpsi, mode, batch_dims, *, y_tol=1e-12,
                 arithmetic="stable"):
    """:func:`find_mu_mup` with the unmagnetised branch decided for each
    index of the first ``batch_dims`` axes (of the broadcast shape): the
    JAX package's ``vmap`` of the one-profile call over those axes."""
    if arithmetic not in ("stable", "reference"):
        raise ValueError("arithmetic must be 'stable' or 'reference'")
    mm = mode_multiplier(mode)
    X, Y, bpsi = torch.broadcast_tensors(*as_tensors(X, Y, bpsi))

    iso_mu, iso_mup = _iso_mu_mup(X)
    mag_mu, mag_mup, _ = _magnetized_mu_mup(
        X, Y, bpsi, mm, sanitize=False,
        naive_o=(arithmetic == "reference"))

    unmag = _nanmax_abs_below(Y, y_tol, batch_dims)
    mu = torch.where(unmag, iso_mu, mag_mu)
    mup = torch.where(unmag, iso_mup, mag_mup)
    return mu, mup


def find_mu_mup_masked(X, Y, bpsi, mode="O", *, y_tol=1e-12):
    """Gradient-safe variant: (μ, μ', valid) with finite entries everywhere.

    Invalid entries carry placeholder finite values and ``valid=False``;
    downstream code masks with ``torch.where(valid, ..., 0)``. The
    unmagnetised branch is decided once over the whole input.
    """
    return _find_mu_mup_masked(X, Y, bpsi, mode, 0, y_tol=y_tol)


def _find_mu_mup_masked(X, Y, bpsi, mode, batch_dims, *, y_tol=1e-12):
    """:func:`find_mu_mup_masked` with the unmagnetised branch decided for
    each index of the first ``batch_dims`` axes (see :func:`_find_mu_mup`).
    """
    mm = mode_multiplier(mode)
    X, Y, bpsi = torch.broadcast_tensors(*as_tensors(X, Y, bpsi))

    mag_mu, mag_mup, mag_valid = _magnetized_mu_mup(X, Y, bpsi, mm,
                                                    sanitize=True)

    mu2 = 1.0 - X
    iso_valid = mu2 > 0.0
    iso_mu = torch.sqrt(torch.where(iso_valid, mu2, 1.0))
    iso_mup = 1.0 / torch.where(iso_valid, iso_mu, 1.0)

    unmag = _nanmax_abs_below(Y, y_tol, batch_dims)
    valid = torch.where(unmag, iso_valid, mag_valid)
    mu = torch.where(unmag, iso_mu, torch.where(mag_valid, mag_mu, 1.0))
    mup = torch.where(unmag, iso_mup, torch.where(mag_valid, mag_mup, 0.0))
    return mu, mup, valid
