"""Faraday rotation on transionospheric paths.

Port of ``pyrayhf_tpu.faraday``: the plane of polarisation of a linearly
polarised wave crossing the ionosphere rotates by half the accumulated
phase difference of the two magnetoionic modes,

    Ω(f) = (π f / c) ∫ (μ_O − μ_X) ds        [rad, one-way],

with the exact Appleton–Hartree phase indices of
:func:`pyrayhf_tpu_torch.magnetoionic.find_mu_mup` (not the
quasi-longitudinal expansion): one broadcast [N_freq, N_alt] evaluation per
mode and a trapezoid sum.
"""

import math

import torch

from ._util import profile_tensors
from .constants import C_KM_S
from .magnetoionic import find_mu_mup, find_X, find_Y

__all__ = ["faraday_rotation_vertical"]


def faraday_rotation_vertical(freq_Hz, den, bmag, bpsi, alt_km, device=None):
    """One-way Faraday rotation [rad] for a vertical transionospheric path.

    Parameters follow the forward operator: ``den`` [m⁻³], ``bmag`` [T],
    ``bpsi`` [deg, angle between the vertical ray and B], ``alt_km`` on a
    monotone grid, ``freq_Hz`` scalar or [N_freq]. A frequency below the
    X-mode penetration frequency of the profile gives NaN (an evanescent
    sample anywhere on the column: the plain trapezoid, not a NaN-sum).
    Differentiable by autograd. Host data goes to the CUDA card unless
    ``device`` says otherwise (``device="cpu"``).
    """
    freq, den, bmag, bpsi, alt = profile_tensors(freq_Hz, den, bmag, bpsi,
                                                 alt_km, device=device)
    f = freq.reshape(-1)[:, None]
    X = find_X(den[None, :], f)
    Y = find_Y(f, bmag[None, :])
    psi = bpsi[None, :].expand_as(X)
    mu_o, _ = find_mu_mup(X, Y, psi, "O")
    mu_x, _ = find_mu_mup(X, Y, psi, "X")
    dmu = mu_o - mu_x
    dh = torch.diff(alt)
    integral = torch.sum(0.5 * (dmu[:, :-1] + dmu[:, 1:]) * dh[None, :],
                         dim=1)
    out = math.pi * f[:, 0] / C_KM_S * integral
    return out[0] if freq.ndim == 0 else out
