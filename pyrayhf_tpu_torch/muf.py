"""MUF estimation by transmission-curve scaling.

Port of ``pyrayhf_tpu.muf``: take a vertical ionogram h'(f_v), map every
point onto the oblique frequency that the same reflection supports over a
link of length D (the inverse of the reference's curvature-corrected
secant law, ``oblique_to_vertical`` ref ``library.py:2697-2742``), and read
the maximum usable frequency MUF(D) as the largest such frequency.

* :func:`vertical_to_oblique` — the exact algebraic inverse of the secant
  law;
* :func:`muf_from_vertical_ionogram` / :func:`muf_from_profile` — the
  scaling product over the whole trace;
* :func:`muf_map` — a profile batch (e.g. a global grid) in one batched
  forward-operator call and one broadcast scaling. With ``engine="auto"``
  on CUDA tensors on a uniform shared grid the forward operator runs the
  in-kernel-solve gather kernels of ``csrc/ionogram.cu``.

Host data goes to the CUDA card unless ``device`` says otherwise
(``device="cpu"``).
"""

import numpy as np
import torch

from ._util import as_tensors, profile_tensors
from .constants import G_P, R_E

__all__ = ["vertical_to_oblique", "muf_from_vertical_ionogram",
           "muf_from_profile", "muf_map"]


def vertical_to_oblique(freq_vertical_mhz, height_virtual_km, range_km,
                        R_E_km=R_E, device=None):
    """Equivalent oblique frequency and group path for a vertical echo.

    With the mirror at h_eff = h'_v + R_E(1 − cos(D/2R_E)):
    tanφ = (D/2) / h_eff, f_ob = f_v / cosφ, p' = D / sinφ. Returns
    ``(freq_oblique_mhz, group_path_km)``; NaN inputs (escaped vertical
    echoes) propagate.
    """
    fv, hv, D = as_tensors(freq_vertical_mhz, height_virtual_km, range_km,
                           device=device)
    theta = (D / 2.0) / R_E_km
    h_eff = hv + R_E_km * (1.0 - torch.cos(theta))
    phi = torch.arctan2(D / 2.0, h_eff)
    return fv / torch.cos(phi), D / torch.sin(phi)


def muf_from_vertical_ionogram(freq_mhz, vh_km, range_km, R_E_km=R_E,
                               device=None):
    """MUF(D) [MHz] by transmission-curve scaling of a vertical ionogram.

    ``freq_mhz``/``vh_km``: the vertical trace along the last axis (NaN
    above foF2, as the forward operator emits); every finite point maps to
    its oblique frequency over the ``range_km`` link and the MUF is the
    maximum (NaN when no point is finite). Leading dimensions broadcast.
    """
    f_ob, _ = vertical_to_oblique(freq_mhz, vh_km, range_km, R_E_km=R_E_km,
                                  device=device)
    ok = torch.isfinite(f_ob)
    top = torch.amax(torch.where(ok, f_ob, -torch.inf), dim=-1)
    return torch.where(ok.any(dim=-1), top, float("nan"))


def _default_freq_grid(den, bmag, mode):
    """0.1 MHz grid (numpy, float64) whose top clears the profile's own
    critical frequency: max(25 MHz, 1.1× the mode's cutoff — O: foF2; X:
    foF2 + f_ce/2). Reads the densities' maximum on the host once."""
    fo = float(np.sqrt(max(float(torch.nan_to_num(
        torch.as_tensor(den), nan=-np.inf).max()), 0.0)) * 8.97866275 / 1e6)
    top = 1.1 * fo
    if mode != "O":
        b = torch.as_tensor(bmag)
        top += 0.55 * float(torch.nan_to_num(b, nan=-np.inf).max()) \
            * G_P / 1e6
    return np.arange(0.1, max(25.0, top), 0.1)


def _scale(freq_mhz, vh, range_km, R_E_km):
    """MUF per range: vh [..., F] → [D, ...] (or [...] for a scalar
    range)."""
    D, _ = as_tensors(range_km, vh, dtype=vh.dtype)
    Dr = D.reshape(-1, *([1] * vh.ndim))
    muf = muf_from_vertical_ionogram(freq_mhz, vh, Dr, R_E_km=R_E_km)
    return muf[0] if D.ndim == 0 else muf


def muf_from_profile(range_km, den, bmag, bpsi, alt_km, mode="O",
                     n_points=200, freq_mhz=None, R_E_km=R_E, device=None):
    """MUF(D) directly from an electron-density profile.

    Synthesises the vertical ionogram with
    :func:`pyrayhf_tpu_torch.vertical_forward_operator` on ``freq_mhz``
    (default: 0.1 MHz steps up to max(25 MHz, 1.1× the profile's critical
    frequency)) and scales it. ``range_km`` may be an array: the scan over
    link distances is one broadcast ([D] out).
    """
    from .forward import vertical_forward_operator

    if freq_mhz is None:
        freq_mhz = _default_freq_grid(den, bmag, mode)
    freq, den, bmag, bpsi, alt = profile_tensors(freq_mhz, den, bmag, bpsi,
                                                 alt_km, device=device)
    vh = vertical_forward_operator(freq, den, bmag, bpsi, alt, mode=mode,
                                   n_points=n_points)
    return _scale(freq, vh, range_km, R_E_km)


def muf_map(range_km, den, bmag, bpsi, alt_km, mode="O", n_points=200,
            freq_mhz=None, R_E_km=R_E, engine="auto", device=None):
    """MUF(D) over a PROFILE BATCH — e.g. a global grid → a MUF map.

    ``den``/``bmag``/``bpsi``: [B, N_alt] profile stacks; ``alt_km`` a
    shared grid. ``range_km`` scalar or [D]. Returns [B] or [D, B] MUFs:
    one batched forward operator (``engine`` forwarded to
    :func:`pyrayhf_tpu_torch.vertical_forward_operator_batch`) and one
    broadcast transmission-curve scaling.
    """
    from .forward import vertical_forward_operator_batch

    if freq_mhz is None:
        freq_mhz = _default_freq_grid(den, bmag, mode)
    freq, den, bmag, bpsi, alt = profile_tensors(freq_mhz, den, bmag, bpsi,
                                                 alt_km, device=device)
    vh = vertical_forward_operator_batch(freq, den, bmag, bpsi, alt,
                                         mode=mode, n_points=n_points,
                                         engine=engine)
    return _scale(freq, vh, range_km, R_E_km)
