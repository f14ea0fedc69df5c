"""Ground electrical properties and Fresnel reflection.

Port of ``pyrayhf_tpu.ground``: the flat-ground Fresnel coefficients of a
homogeneous lossy earth,

    ε_c = ε_r − j·σ/(ω ε₀)
    R_h = (sinψ − √(ε_c − cos²ψ)) / (sinψ + √(ε_c − cos²ψ))
    R_v = (ε_c·sinψ − √(ε_c − cos²ψ)) / (ε_c·sinψ + √(ε_c − cos²ψ))

with ψ the grazing angle, and the per-bounce loss in dB. The complex
algebra stays in split real arithmetic, as in the JAX module, so the two
packages round alike; :func:`fresnel_coefficients` assembles complex
tensors from it. Presets follow the ITU-R P.527 ground classes.
"""

import math

import torch

from ._util import as_tensors

__all__ = ["GROUND_PRESETS", "fresnel_coefficients",
           "fresnel_coefficients_real", "ground_reflection_loss_db",
           "resolve_ground"]

_EPS0 = 8.8541878128e-12          # vacuum permittivity [F/m]
_DEG2RAD = math.pi / 180.0

# (relative permittivity ε_r, conductivity σ [S/m]) — ITU-R P.527 classes
GROUND_PRESETS = {
    "sea": (70.0, 5.0),
    "wet": (30.0, 1e-2),          # wet ground
    "medium": (15.0, 1e-3),       # medium dry ground
    "dry": (3.0, 1e-4),           # very dry ground
}


def resolve_ground(ground):
    """Preset name or (ε_r, σ) pair → (ε_r, σ [S/m])."""
    if isinstance(ground, str):
        try:
            return GROUND_PRESETS[ground]
        except KeyError:
            raise ValueError(
                f"unknown ground preset {ground!r}; choose from "
                f"{sorted(GROUND_PRESETS)} or pass (eps_r, sigma)")
    eps_r, sigma = ground
    return float(eps_r), float(sigma)


def _hypot(a, b):
    """``jnp.hypot``'s formula: max·sqrt(1 + (min/max)²), 0 at (0, 0)."""
    a, b = torch.abs(a), torch.abs(b)
    inf = torch.isposinf(a) | torch.isposinf(b)
    hi, lo = torch.maximum(a, b), torch.minimum(a, b)
    q = lo / torch.where(hi == 0, 1.0, hi)
    h = torch.where(hi == 0, hi, hi * torch.sqrt(1 + q * q))
    return torch.where(inf, math.inf, h)


def _csqrt(a, b):
    """Principal √(a + jb) in split real arithmetic.

    Matches the NumPy branch (Im ≥ 0 on the cut b == 0, a < 0): the
    imaginary sign is −1 only for strictly negative b.
    """
    m = _hypot(a, b)
    re = torch.sqrt(torch.clamp(0.5 * (m + a), min=0.0))
    im = torch.where(b < 0, -1.0, 1.0) * torch.sqrt(
        torch.clamp(0.5 * (m - a), min=0.0))
    return re, im


def _cdiv(nr, ni, dr, di):
    """(nr + j·ni) / (dr + j·di) in split real arithmetic."""
    den = dr * dr + di * di
    return (nr * dr + ni * di) / den, (ni * dr - nr * di) / den


def fresnel_coefficients_real(f_Hz, grazing_deg, eps_r, sigma_S_m,
                              device=None):
    """Fresnel coefficients in split real form.

    Returns ``(rv_re, rv_im, rh_re, rh_im)``: the real and imaginary parts
    of R_v and R_h. Broadcasts over ``f_Hz``/``grazing_deg``;
    differentiable. Host arrays go to the CUDA card unless ``device`` says
    otherwise (``device="cpu"``).
    """
    f, g = as_tensors(f_Hz, grazing_deg, device=device)
    psi = g * _DEG2RAD
    # ε_c = p − j q
    p = eps_r
    q = sigma_S_m / (2.0 * math.pi * f * _EPS0)
    s = torch.sin(psi)
    c = torch.cos(psi)
    # root = √(ε_c − cos²ψ) = √((p − cos²ψ) − j q)
    rr, ri = _csqrt(p - c * c, -q + 0.0 * s)
    # R_h = (s − root)/(s + root)
    rh_re, rh_im = _cdiv(s - rr, -ri, s + rr, ri)
    # R_v = (ε_c s − root)/(ε_c s + root), ε_c s = p s − j q s
    rv_re, rv_im = _cdiv(p * s - rr, -q * s - ri, p * s + rr, -q * s + ri)
    return rv_re, rv_im, rh_re, rh_im


def fresnel_coefficients(f_Hz, grazing_deg, eps_r, sigma_S_m, device=None):
    """Complex Fresnel coefficients (R_v, R_h) at grazing angle ψ [deg].

    Complex tensors assembled from :func:`fresnel_coefficients_real`.
    |R| → 1 for both as ψ → 0 (grazing) and for σ → ∞.
    """
    rv_re, rv_im, rh_re, rh_im = fresnel_coefficients_real(
        f_Hz, grazing_deg, eps_r, sigma_S_m, device=device)
    return torch.complex(rv_re, rv_im), torch.complex(rh_re, rh_im)


def ground_reflection_loss_db(f_Hz, grazing_deg, ground="medium",
                              polarization="circular", device=None):
    """Power loss [dB, ≥ 0] of one specular ground reflection.

    ``ground``: preset name (see :data:`GROUND_PRESETS`) or an
    ``(eps_r, sigma)`` pair. ``polarization``: ``"circular"`` (mean
    reflected power of the two linear components — the HF skywave
    convention), ``"horizontal"`` or ``"vertical"``.
    """
    eps_r, sigma = resolve_ground(ground)
    rv_re, rv_im, rh_re, rh_im = fresnel_coefficients_real(
        f_Hz, grazing_deg, eps_r, sigma, device=device)
    pv = rv_re * rv_re + rv_im * rv_im
    ph = rh_re * rh_re + rh_im * rh_im
    if polarization == "circular":
        p = 0.5 * (pv + ph)
    elif polarization == "vertical":
        p = pv
    elif polarization == "horizontal":
        p = ph
    else:
        raise ValueError(
            "polarization must be 'circular', 'vertical' or 'horizontal'")
    return -10.0 * torch.log10(p)
