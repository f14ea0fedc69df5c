"""HF collisional absorption (D/E-region): coefficients and integrals.

Port of ``pyrayhf_tpu.absorption``: the quasi-longitudinal (QL) absorption
model on top of the μ fields the tracers evaluate,

    κ [Np/m] = ωp²·ν / (2·c·μ·((ω ± ωL)² + ν²))       (+ O-mode, − X-mode)

with ωp² = (2π·CP)²·Ne, ωL = 2π·G_P·B·|cos ψ| and ν the effective
electron–neutral collision frequency (Davies, *Ionospheric Radio*, eq.
7.20). Expressions and their order follow the JAX module, so float64
results agree to the last few ulps.

:func:`vertical_absorption_operator` integrates κ on the forward
operator's per-frequency stretched reflection grid; the oblique tracers
accumulate κ at path midpoints.
"""

import math

import torch

from ._util import as_tensors, profile_tensors
from .constants import C_KM_S, CP, G_P
from .grid import interp, regrid_core
from .magnetoionic import find_mu_mup, find_X, find_Y, mode_multiplier

__all__ = ["collision_frequency", "absorption_coefficient",
           "vertical_absorption_operator"]

# Np → dB
_DB_PER_NP = 8.685889638065037

# ν(h) = NU0 · exp(−h/H), NU0 = 1.86e11 s⁻¹, H = 1/0.15 km: the classic
# single-exponential fit to mid-latitude D/E-region effective collision
# frequencies (Davies 1990, fig. 3.8).
_NU0_DEFAULT = 1.86e11
_H_DEFAULT = 1.0 / 0.15

_DEG2RAD = math.pi / 180.0


def collision_frequency(alt_km, nu0=_NU0_DEFAULT, scale_km=_H_DEFAULT,
                        device=None):
    """Effective electron–neutral collision frequency ν(h) [s⁻¹].

    ``nu0 · exp(−alt/scale_km)``. Host arrays go to the CUDA card unless
    ``device`` says otherwise (``device="cpu"``).
    """
    (alt_km,) = as_tensors(alt_km, device=device)
    return nu0 * torch.exp(-alt_km / scale_km)


def absorption_coefficient(ne_m3, nu_hz, f_hz, babs_t, bpsi_deg, mu,
                           mode="O", device=None):
    """QL absorption coefficient κ [dB/km] (Davies eq. 7.20).

    ``mu`` is the real phase refractive index along the path (from
    :func:`pyrayhf_tpu_torch.magnetoionic.find_mu_mup`); NaN μ
    (evanescent) propagates to NaN κ. Arguments broadcast.
    """
    mm = mode_multiplier(mode)
    ne_m3, nu_hz, f_hz, babs_t, bpsi_deg, mu = as_tensors(
        ne_m3, nu_hz, f_hz, babs_t, bpsi_deg, mu, device=device)
    omega = 2.0 * math.pi * f_hz
    omega_p2 = (2.0 * math.pi * CP) ** 2 * ne_m3
    psi = bpsi_deg * _DEG2RAD
    omega_l = 2.0 * math.pi * G_P * babs_t * torch.abs(torch.cos(psi))
    c_m_s = C_KM_S * 1e3
    mu_s = torch.where(mu > 0.0, mu, float("nan"))
    w = omega + mm * omega_l
    kappa_np_m = omega_p2 * nu_hz / (
        2.0 * c_m_s * mu_s * (w * w + nu_hz * nu_hz))
    return kappa_np_m * 1e3 * _DB_PER_NP


def vertical_absorption_operator(freq_MHz, den, bmag, bpsi, alt, mode="O",
                                 n_points=2000, nu=None, device=None):
    """Two-way vertical-incidence absorption L(f) [dB] per frequency.

    Same arguments as :func:`pyrayhf_tpu_torch.forward
    .vertical_forward_operator` and the same per-frequency stretched
    reflection grid (:func:`pyrayhf_tpu_torch.grid.regrid_core`), which
    resolves the integrable κ ∝ 1/μ peak at reflection. ``nu``: ν [s⁻¹]
    on ``alt`` (default :func:`collision_frequency`). Returns [N_freq] dB;
    NaN above foF2 (escaped rays). Host arrays go to the CUDA card unless
    ``device`` says otherwise.
    """
    freq_MHz, den, bmag, bpsi, alt = profile_tensors(freq_MHz, den, bmag,
                                                     bpsi, alt, device=device)
    nu = (collision_frequency(alt) if nu is None
          else as_tensors(nu, alt, dtype=alt.dtype)[0])
    mode_mult = mode_multiplier(mode)
    rg = regrid_core(freq_MHz * 1e6, den, bmag, bpsi, alt,
                     mode_mult=mode_mult, n_points=n_points)
    aX = find_X(rg["den"], rg["freq"])
    aY = find_Y(rg["freq"], rg["bmag"])
    mu, _ = find_mu_mup(aX, aY, rg["bpsi"], mode)
    # ν resampled onto the per-frequency reflection grid (jnp.interp)
    F = rg["alt"].shape[0]
    nu_rg = interp(rg["alt"], alt.expand(F, -1), nu.expand(F, -1))
    kappa = absorption_coefficient(rg["den"], nu_rg, rg["freq"],
                                   rg["bmag"], rg["bpsi"], mu, mode)
    fin = torch.isfinite(kappa)
    one_way = torch.nansum(torch.where(fin, kappa * rg["dist"], 0.0), dim=1)
    # escaped rays (all-NaN μ row) → NaN, matching find_vh semantics
    valid = torch.any(fin & (rg["dist"] > 0.0), dim=1)
    return torch.where(valid, 2.0 * one_way, float("nan"))
