"""Vertical-incidence HF Doppler sounding from the differentiable phase
operator.

Port of ``pyrayhf_tpu.doppler``. A time-varying ionosphere shifts the
frequency of a vertically reflected sounding wave by

    f_D = -(f / c) * dP/dt,   P = 2 h_p   (round-trip phase path)

so f_D = -(2 f / c) * dh_p/dt, the time derivative of the phase height
h_p(f). Given the density tendency ``dden_dt`` (and optionally the field
tendencies), one forward-mode tangent (``torch.autograd.forward_ad``)
through the masked regrid + Appleton–Hartree + quadrature gives the exact
Doppler shift of the discretised operator, including the motion of the
reflection height (the regrid's critical-height solve is part of the
differentiated program).
"""

import torch
from torch.autograd import forward_ad as fwAD

from ._util import as_tensors, profile_tensors
from .constants import C_KM_S
from .grid import regrid_core
from .magnetoionic import (_find_mu_mup_masked, find_X, find_Y,
                           mode_multiplier)

__all__ = ["phase_height_and_mask", "doppler_shift_vertical"]

_NAN = float("nan")


def _phase_height(freq_mhz, den, bmag, bpsi, alt, mode_mult, n_points):
    rg = regrid_core(freq_mhz * 1e6, den, bmag, bpsi, alt,
                     mode_mult=mode_mult, n_points=n_points, masked=True)
    aX = find_X(rg["den"], rg["freq"])
    aY = find_Y(rg["freq"], rg["bmag"])
    mode = "O" if mode_mult > 0 else "X"
    # per profile of a [..., N_alt] stack, as the JAX package vmaps it
    mu, _, pt_ok = _find_mu_mup_masked(aX, aY, rg["bpsi"], mode,
                                       aX.ndim - 2)
    # mu -> 0 at the reflection height: bounded integrand, no ceiling
    # needed (contrast the mu' ceiling of forward.vh_and_mask)
    pt_ok = pt_ok & (mu >= 0.0)
    ih = torch.sum(torch.where(pt_ok, mu * rg["dist"], 0.0), dim=-1)
    valid = rg["row_ok"] & (ih != 0.0)
    hp = torch.where(valid, ih, 0.0) + torch.amin(alt, dim=-1, keepdim=True)
    return hp, valid


def phase_height_and_mask(freq_mhz, den, bmag, bpsi, alt, mode_mult=1.0,
                          n_points=200, device=None):
    """Gradient-safe phase-height operator: (h_p, valid), finite everywhere.

    The masked companion to :func:`pyrayhf_tpu_torch.vertical_phase_operator`
    (as :func:`pyrayhf_tpu_torch.vh_and_mask` is to the forward operator):
    escaped rays carry ``valid=False`` and the finite placeholder
    h_p = min(alt), so tangents through a ``torch.where(valid, ...)`` are
    finite. Where ``valid``, h_p equals the parity operator's phase height.
    Host data goes to the CUDA card unless ``device`` says otherwise
    (``device="cpu"``).
    """
    freq_mhz, den, bmag, bpsi, alt = profile_tensors(
        freq_mhz, den, bmag, bpsi, alt, device=device)
    return _phase_height(freq_mhz, den, bmag, bpsi, alt, mode_mult,
                         n_points)


def doppler_shift_vertical(freq, den, dden_dt, bmag, bpsi, alt, mode="O",
                           n_points=200, dbmag_dt=None, dbpsi_dt=None,
                           device=None):
    """Vertical-incidence Doppler shift f_D(f) [Hz] of a sounding sweep.

    ``freq`` [N_freq] sounding frequencies [MHz]; ``den``, ``bmag``,
    ``bpsi``, ``alt`` [N_alt] the profile (as the forward operator);
    ``dden_dt`` [N_alt] the density tendency [m⁻³/s]; ``dbmag_dt``,
    ``dbpsi_dt`` optional field tendencies (default 0).

    Returns a dict: ``doppler_hz`` [N_freq] f_D = -(2 f / c)·dh_p/dt, NaN
    for escaped rays; ``phase_height_km`` h_p(f); ``dhp_dt_km_s`` the
    phase-height rate. For a sharp reflector below which the medium is
    vacuum, h_p = h and f_D = -2 f v / c (the moving mirror). Host data
    goes to the CUDA card unless ``device`` says otherwise
    (``device="cpu"``).
    """
    freq, den, bmag, bpsi, alt = profile_tensors(freq, den, bmag, bpsi, alt,
                                                 device=device)
    zero = torch.zeros_like(den)
    dden, dbmag, dbpsi = (zero if t is None
                          else as_tensors(t, den, dtype=den.dtype)[0]
                          for t in (dden_dt, dbmag_dt, dbpsi_dt))
    fd, hp, dhp = _doppler_core(freq, den, dden, bmag, dbmag, bpsi, dbpsi,
                                alt, mode_multiplier(mode), n_points)
    return {"doppler_hz": fd, "phase_height_km": hp, "dhp_dt_km_s": dhp}


def _doppler_core(freq_mhz, den, dden, bmag, dbmag, bpsi, dbpsi, alt,
                  mode_mult, n_points):
    """(f_D, h_p, dh_p/dt), NaN where escaped, of profiles ``den``/``bmag``/
    ``bpsi`` [..., N_alt] moving at ``dden``/``dbmag``/``dbpsi``: one
    forward-mode tangent through :func:`_phase_height`. Every operand is a
    tensor on one device; a [B, N_alt] stack runs as one batch."""
    with fwAD.dual_level():
        hp, valid = _phase_height(
            freq_mhz, fwAD.make_dual(den, dden), fwAD.make_dual(bmag, dbmag),
            fwAD.make_dual(bpsi, dbpsi), alt, mode_mult, n_points)
        hp, dhp = fwAD.unpack_dual(hp)
        hp = hp.clone()
        dhp = torch.zeros_like(hp) if dhp is None else dhp.clone()
    fd = -(2.0 * (freq_mhz * 1e6) / C_KM_S) * dhp      # [Hz]; dhp in km/s
    return (torch.where(valid, fd, _NAN), torch.where(valid, hp, _NAN),
            torch.where(valid, dhp, _NAN))
