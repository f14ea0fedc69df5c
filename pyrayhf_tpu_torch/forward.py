"""Vertical forward operator: ionosonde frequencies → virtual heights.

Port of ``pyrayhf_tpu.forward`` (reference ``vertical_forward_operator``,
PyRayHF ``library.py:459-509``, ``find_vh`` :259-293):

    regrid (cummax + batched interp) → X,Y → Appleton–Hartree μ' → Σ μ'·dh

Entry points: :func:`vertical_forward_operator` (one profile, [N_freq]
out), :func:`vertical_forward_operator_batch` ([B, N_alt] → [B, N_freq],
with the JAX package's engine names), :func:`vh_and_mask` (gradient-safe
masked variant) and :func:`vertical_phase_operator`.
"""

import logging

import numpy as np
import torch

from . import pallas_vh
from ._util import as_tensors, profile_tensors
from .config import resolve
from .grid import regrid_core
from .magnetoionic import (_find_mu_mup, _find_mu_mup_masked, find_X, find_Y,
                           mode_multiplier)
from .profiling import span

__all__ = ["find_vh", "vertical_forward_operator",
           "vertical_forward_operator_batch", "vh_and_mask",
           "vertical_phase_operator"]

# Physical ceiling for the group index at the backed-off reflection sample
# (see find_vh); generous vs the f64 bound ~3e5.
_MUP_CEILING = 1e7

logger = logging.getLogger("pyrayhf_tpu_torch")


def find_vh(X, Y, bpsi, dh, alt_min, mode, arithmetic="stable"):
    """Virtual height as the μ'-weighted vertical quadrature (ref :259-293).

    NaN samples sum to 0 under ``nansum`` and all-NaN rows (escaped rays)
    are mapped back to NaN, exactly like the reference. μ' beyond the 1e7
    ceiling or ≤ 0 is treated as an escape sample (the JAX package's
    documented deviation; f64 results are unaffected).
    """
    return _find_vh(X, Y, bpsi, dh, alt_min, mode, arithmetic, 0)


def _find_vh(X, Y, bpsi, dh, alt_min, mode, arithmetic, batch_dims):
    """:func:`find_vh` with the unmagnetised branch decided for each index
    of the first ``batch_dims`` axes (``magnetoionic._find_mu_mup``)."""
    _, mup = _find_mu_mup(X, Y, bpsi, mode, batch_dims, arithmetic=arithmetic)
    dh, _ = as_tensors(dh, mup, dtype=mup.dtype)
    mup = torch.where((mup > 0.0) & (mup <= _MUP_CEILING), mup, float("nan"))
    ih = torch.nansum(mup * dh, dim=-1)
    ih = torch.where(ih == 0.0, float("nan"), ih)
    return ih + alt_min


def _forward_core(freq_hz, den, bmag, bpsi, alt, mode_mult, n_points,
                  arithmetic="stable"):
    """Fused forward operator on [..., N_alt] profiles → [..., N_freq].

    Each profile is the JAX package's one-profile call (which its batch
    operator vmaps): the unmagnetised branch is decided per profile, over
    the [N_freq, n_points] that call sees."""
    rg = regrid_core(freq_hz, den, bmag, bpsi, alt,
                      mode_mult=mode_mult, n_points=n_points)
    aX = find_X(rg["den"], rg["freq"])
    aY = find_Y(rg["freq"], rg["bmag"])
    mode = "O" if mode_mult > 0 else "X"
    alt_min = torch.amin(alt, dim=-1, keepdim=True)
    return _find_vh(aX, aY, rg["bpsi"], rg["dist"], alt_min, mode,
                    arithmetic, aX.ndim - 2)


def vertical_forward_operator(freq, den, bmag, bpsi, alt,
                              mode=None, n_points=None, arithmetic="stable",
                              config=None, device=None):
    """Reference-parity API: virtual height [km] per frequency [MHz].

    Parameters match ref library.py:459-509 (freq in MHz, den in m^-3,
    bmag in T, bpsi in deg, alt in km; mode 'O'/'X' default 'O'; n_points
    default 200). Mismatched profile shapes are logged, not raised, like
    the reference. ``config`` (an :class:`OperatorConfig`) supplies
    mode/n_points when they are not passed explicitly. Host arrays go to
    the CUDA card unless ``device`` says otherwise (``device="cpu"``);
    tensors keep their device.
    """
    mode = resolve(config, "mode", mode, "O")
    n_points = resolve(config, "n_points", n_points, 200)
    shapes = {tuple(np.shape(a)) for a in (den, bmag, bpsi, alt)}
    if len(shapes) > 1:
        logger.error(
            "Error: freq, den, bmag, bpsi, alt should have same size")
    freq, den, bmag, bpsi, alt = profile_tensors(freq, den, bmag, bpsi, alt,
                                                 device=device)
    return _forward_core(freq * 1e6, den, bmag, bpsi, alt,
                         mode_mult=mode_multiplier(mode), n_points=n_points,
                         arithmetic=arithmetic)


def vertical_forward_operator_batch(freq, den, bmag, bpsi, alt,
                                    mode=None, n_points=None, config=None,
                                    engine="auto", device=None):
    """Batched operator: profiles [B, N_alt] → ionograms [B, N_freq].

    ``alt`` may be [N_alt] (shared grid) or [B, N_alt]. ``engine``:

    * ``"parity"`` — the searchsorted/gather regrid path, numerically
      closest to the reference (any device, any grid);
    * ``"pallas"`` — the sweep-kernel port (shared grid; upper-bound
      index, so any grid spacing);
    * ``"pallas_gather"`` — the gather kernels with the reflection solve
      in the kernel (shared, uniformly spaced grid);
    * ``"xla"`` — the plain PyTorch segment sweep (shared grid; any
      device; the gradient path of the kernels);
    * ``"pallas_mxu"`` — the tensor-core one-hot resample kernel (shared,
      uniformly spaced grid; same result as the host-solve gather);
    * ``"auto"`` (default) — on CUDA tensors with a shared grid:
      ``"pallas_gather"`` when the grid is uniform (f32 and f64 alike),
      else ``"pallas"``; ``"parity"`` on CPU tensors and for per-profile
      [B, N_alt] grids.

    The kernel engines run their hand-written CUDA kernel on CUDA tensors
    and their plain PyTorch version on CPU tensors. Fast engines agree
    with parity to < 1e-6 km in f64. The resolved engine is logged
    (DEBUG, once per distinct choice). Host arrays go to the CUDA card
    unless ``device`` says otherwise (``device="cpu"``); without a card
    and without that request the call raises. The inputs are converted
    once and the kernel engines routed by :func:`pallas_vh.route`, the
    one read of the grid (none on a repeat call with the same unchanged
    CUDA grid and frequency tensors: its launch plan). The call is a
    ``pyrayhf.forward`` span and its routing a ``pyrayhf.route`` span
    (:func:`pyrayhf_tpu_torch.profiling.span`).
    """
    with span("pyrayhf.forward"):
        with span("pyrayhf.route"):
            mode = resolve(config, "mode", mode, "O")
            n_points = resolve(config, "n_points", n_points, 200)
            mm = mode_multiplier(mode)
            freq, den, bmag, bpsi, alt = profile_tensors(
                freq, den, bmag, bpsi, alt, device=device)
            shared_grid = alt.ndim == 1
            if engine in _SHARED_GRID_ENGINES and not shared_grid:
                raise ValueError(
                    f"engine={engine!r} requires a shared 1-D altitude grid "
                    "(per-profile [B, N_alt] grids need engine='parity')")
            if engine not in ("auto", "parity", *_SHARED_GRID_ENGINES):
                raise ValueError("engine must be 'auto', 'parity', 'pallas', "
                                 "'pallas_gather', 'pallas_mxu' or 'xla'")
            cfg = None
            if engine not in ("parity", "xla"):
                cfg = pallas_vh.route(engine, freq, den, alt, mm,
                                      n_points)
            if engine == "auto":
                key = (cfg["engine"] if cfg else "parity", den.device.type,
                       shared_grid)
                if key not in _auto_logged:
                    _auto_logged.add(key)
                    logger.debug("engine='auto' resolved to %r (device=%s, "
                                 "shared_grid=%s)", *key)
        if cfg is not None:
            return pallas_vh.run_engine(cfg, freq, den, bmag, bpsi, alt)
        if engine == "xla":
            return pallas_vh.ionogram_fast_xla(freq, den, bmag, bpsi, alt,
                                               mode_mult=mm,
                                               n_points=n_points)
        if shared_grid:
            alt = alt.expand_as(den)
        return _forward_core(freq * 1e6, den, bmag, bpsi, alt, mode_mult=mm,
                             n_points=n_points)


# engine='auto' resolutions already logged (one DEBUG line per choice)
_auto_logged = set()
# the engines that need one altitude grid for every profile
_SHARED_GRID_ENGINES = ("pallas", "pallas_gather", "pallas_mxu", "xla")


def _phase_core(freq_hz, den, bmag, bpsi, alt, mode_mult, n_points):
    rg = regrid_core(freq_hz, den, bmag, bpsi, alt,
                      mode_mult=mode_mult, n_points=n_points)
    aX = find_X(rg["den"], rg["freq"])
    aY = find_Y(rg["freq"], rg["bmag"])
    mode = "O" if mode_mult > 0 else "X"
    mu, _ = _find_mu_mup(aX, aY, rg["bpsi"], mode, aX.ndim - 2)
    # μ → 0 at the reflection height, so the integrand is bounded; NaN
    # rows are escaped rays
    mu = torch.where(torch.isfinite(mu) & (mu >= 0.0), mu, float("nan"))
    ph = torch.nansum(mu * rg["dist"], dim=-1)
    ph = torch.where(ph == 0.0, float("nan"), ph)
    return ph + torch.amin(alt, dim=-1, keepdim=True)


def vertical_phase_operator(freq, den, bmag, bpsi, alt, mode=None,
                            n_points=None, config=None, device=None):
    """Phase height h_p(f) = alt_min + ∫ μ dh [km] per frequency [MHz].

    Companion to :func:`vertical_forward_operator` (which integrates the
    group index μ'); same regrid discretisation, arguments and NaN-escape
    semantics, so h_p(f) ≤ true reflection height ≤ h'(f). ``device``:
    as for :func:`vertical_forward_operator`.
    """
    mode = resolve(config, "mode", mode, "O")
    n_points = resolve(config, "n_points", n_points, 200)
    freq, den, bmag, bpsi, alt = profile_tensors(freq, den, bmag, bpsi, alt,
                                                 device=device)
    return _phase_core(freq * 1e6, den, bmag, bpsi, alt,
                       mode_mult=mode_multiplier(mode), n_points=n_points)


def vh_and_mask(freq_mhz, den, bmag, bpsi, alt, mode_mult=1.0, n_points=200,
                device=None):
    """Gradient-safe forward operator: (vh, valid) with finite vh everywhere.

    ``vh`` equals the parity operator where ``valid``; escaped rays carry
    ``valid=False`` and vh = alt_min (a finite placeholder). Autograd
    through ``torch.where(valid, vh, 0)`` is finite. [..., N_alt] profiles
    give [..., N_freq], each profile as the JAX package's one-profile call
    (the unmagnetised branch decided per profile). ``device``: as for
    :func:`vertical_forward_operator`.
    """
    freq_mhz, den, bmag, bpsi, alt = profile_tensors(freq_mhz, den, bmag,
                                                     bpsi, alt, device=device)
    rg = regrid_core(freq_mhz * 1e6, den, bmag, bpsi, alt,
                      mode_mult=mode_mult, n_points=n_points, masked=True)
    aX = find_X(rg["den"], rg["freq"])
    aY = find_Y(rg["freq"], rg["bmag"])
    mode = "O" if mode_mult > 0 else "X"
    _, mup, pt_ok = _find_mu_mup_masked(aX, aY, rg["bpsi"], mode,
                                        aX.ndim - 2)
    pt_ok = pt_ok & (mup > 0.0) & (mup <= _MUP_CEILING)
    contrib = torch.where(pt_ok, mup * rg["dist"], 0.0)
    ih = torch.sum(contrib, dim=-1)
    valid = rg["row_ok"] & (ih != 0.0)
    vh = torch.where(valid, ih, 0.0) + torch.amin(alt, dim=-1, keepdim=True)
    return vh, valid
