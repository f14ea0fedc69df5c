"""Per-frequency stretched vertical grid and profile regridding, in PyTorch.

Port of ``pyrayhf_tpu.grid`` (reference ``regrid_to_nonuniform_grid``,
PyRayHF ``library.py:324-438``). The profile truncation at ``argmax(n_e)``
is a *flat extension* (entries at/above the peak index clamped to the last
pre-peak value), the reflection-height root solve is one batched
``interp`` over the frequency rows, and ``jnp.interp`` is reproduced
expression for expression (:func:`interp`).

Reference quirks replicated on purpose:

* the ``dh`` kwarg is shadowed — the effective reflection-height backoff is
  always 1e-6 km (ref :378);
* the returned grid distance row ends with a trailing ``dh`` entry
  (ref :415-416);
* NaN queries stay NaN (``np.interp`` semantics; ``jnp.interp`` clamps).

Beyond the JAX module, :func:`regrid_core` takes leading batch dimensions:
a whole [B, N_alt] profile stack regrids at once (the JAX package vmaps it).
"""

import numpy as np
import torch

from ._util import as_tensors
from .magnetoionic import find_X, find_Y, mode_multiplier

__all__ = ["smooth_nonuniform_grid", "regrid_to_nonuniform_grid",
           "regrid_core", "interp"]

# Effective backoff below the reflection height [km] (ref library.py:378).
_DH_BACKOFF = 1e-6


def _linspace01(n_points, dtype, device):
    """``jnp.linspace(0, 1, n)`` bit for bit: i/(n-1), last entry exactly 1."""
    if n_points == 1:
        return torch.zeros(1, dtype=dtype, device=device)
    i = torch.arange(n_points - 1, dtype=dtype, device=device)
    return torch.cat([i / (n_points - 1),
                      torch.ones(1, dtype=dtype, device=device)])


def smooth_nonuniform_grid(start, end, n_points, sharpness,
                           dtype=torch.float64, device=None):
    """Exp-stretched grid multiplier in [start, end], fine near ``end``.

    Parity with ref library.py:296-321.
    """
    u = _linspace01(n_points, dtype, device)
    flipped = 1.0 - u
    factor = ((torch.exp(sharpness * flipped) - 1.0)
              / (np.exp(sharpness) - 1.0))
    return 1.0 - (start + (end - start) * factor)


def _flat_extend(arr, ind_max):
    """Clamp ``arr[..., j]`` for j >= ind_max to ``arr[..., ind_max-1]``.

    ``ind_max`` has ``arr``'s leading shape (a 0-d tensor for 1-D ``arr``).
    """
    idx = torch.arange(arr.shape[-1], device=arr.device)
    last = torch.clamp(ind_max - 1, min=0)[..., None]
    lastv = torch.gather(arr, -1, last.expand(*arr.shape[:-1], 1))
    return torch.where(idx < ind_max[..., None], arr, lastv)


def interp(x, xp, fp):
    """``jnp.interp(x, xp, fp)`` with batched rows.

    ``xp``/``fp``: [..., K] sorted rows; ``x``: [..., M] queries per row.
    Same index, ``dx ≈ 0`` guard and edge clamps as ``jnp.interp``.
    """
    K = xp.shape[-1]
    i = torch.searchsorted(xp.contiguous(), x.contiguous(), right=True)
    i = torch.clamp(i, 1, K - 1)
    xp_i = torch.gather(xp, -1, i)
    xp_im1 = torch.gather(xp, -1, i - 1)
    fp_i = torch.gather(fp, -1, i)
    fp_im1 = torch.gather(fp, -1, i - 1)
    df = fp_i - fp_im1
    dx = xp_i - xp_im1
    delta = x - xp_im1
    epsilon = float(np.spacing(np.finfo(
        np.float64 if xp.dtype == torch.float64 else np.float32).eps))
    dx0 = torch.abs(dx) <= epsilon
    f = torch.where(dx0, fp_im1,
                    fp_im1 + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[..., :1], fp[..., :1], f)
    f = torch.where(x > xp[..., -1:], fp[..., -1:], f)
    return f


def regrid_core(f, n_e, b, bpsi, aalt, mode_mult, n_points, masked=False):
    """Regrid profiles onto per-frequency stretched grids.

    ``f``: [F] wave frequencies [Hz]; ``n_e``, ``b``, ``bpsi``, ``aalt``:
    [..., N_alt] profiles (``aalt`` broadcastable to ``n_e``); ``mode_mult``:
    +1 (O) / -1 (X). Returns a dict of [..., F, n_points] tensors: freq,
    den, bmag, bpsi, dist, alt, crit_height, ind (plus [..., F] ``row_ok``
    when ``masked``) — the reference's keys and shapes (ref :430-438) for
    one [N_alt] profile.
    """
    f, n_e, b, bpsi, aalt = as_tensors(f, n_e, b, bpsi, aalt)
    aalt = aalt.expand_as(n_e)
    F = f.shape[0]
    lead = n_e.shape[:-1]

    multiplier = smooth_nonuniform_grid(0.0, 1.0, n_points, 10.0,
                                        dtype=n_e.dtype, device=n_e.device)

    # Flat-extend the profile at the density peak (== ref truncation :371-375).
    ind_max = torch.argmax(n_e, dim=-1)
    n_e_t = _flat_extend(n_e, ind_max)
    b_t = _flat_extend(b, ind_max)
    bpsi_t = _flat_extend(bpsi, ind_max)
    aalt_t = _flat_extend(aalt, ind_max)

    # X, X+Y on the [..., F, N_alt] tile; monotonic cutoff functions.
    f2 = f[:, None]
    aX = find_X(n_e_t[..., None, :], f2)
    if mode_mult > 0:
        fcrit = torch.cummax(aX, dim=-1).values
    else:
        aY = find_Y(f2, b_t[..., None, :])
        fcrit = torch.cummax(aX + aY, dim=-1).values
    # Flat-extend the cutoff too (trailing ties beyond the peak).
    fcrit = _flat_extend(fcrit, ind_max[..., None].expand(*lead, F))

    # Rows that actually reach the cutoff (fcrit monotone ⇒ last entry).
    valid = fcrit[..., -1] >= 1.0

    # Reflection-height root solve: one interp per frequency row.
    alt_rows = aalt_t[..., None, :].expand(*lead, F, aalt_t.shape[-1])
    one = torch.ones((*lead, F, 1), dtype=n_e.dtype, device=n_e.device)
    crit = interp(one, fcrit, alt_rows)[..., 0]
    if masked:
        # escaped rows get a finite placeholder height (no NaN in any
        # jacobian); callers mask with 'row_ok'
        crit = torch.where(valid, crit, aalt_t[..., -1:]) - _DH_BACKOFF
    else:
        crit = torch.where(valid, crit - _DH_BACKOFF, float("nan"))

    # Stretched altitude grid per frequency and its spacing.
    alt0 = aalt[..., :1, None]
    new_alt = multiplier * (crit[..., None] - alt0) + alt0
    dist = torch.cat(
        [torch.diff(new_alt, dim=-1),
         torch.full((*lead, F, 1), _DH_BACKOFF, dtype=new_alt.dtype,
                    device=new_alt.device)], dim=-1)

    # Resample the flat-extended profile; NaN queries stay NaN.
    alt_ok = torch.isfinite(new_alt)
    q = new_alt.reshape(*lead, F * n_points)

    def _interp(fp):
        r = interp(q, aalt_t, fp).reshape(new_alt.shape)
        return torch.where(alt_ok, r, float("nan"))

    shape = new_alt.shape
    out = {"freq": f[:, None].expand(shape),
           "den": _interp(n_e_t), "bmag": _interp(b_t),
           "bpsi": _interp(bpsi_t), "dist": dist, "alt": new_alt,
           "crit_height": crit[..., None].expand(shape),
           "ind": torch.arange(n_points, device=f.device).expand(shape)}
    if masked:
        out["row_ok"] = valid
    return out


def regrid_to_nonuniform_grid(f, n_e, b, bpsi, aalt, mode="O",
                              n_points=200, dh=1e-6):
    """Reference-compatible wrapper (ref library.py:324-438).

    ``dh`` is accepted but ignored — the reference shadows it to 1e-6 (:378).
    """
    del dh
    return regrid_core(f, n_e, b, bpsi, aalt,
                       mode_mult=mode_multiplier(mode), n_points=n_points)
