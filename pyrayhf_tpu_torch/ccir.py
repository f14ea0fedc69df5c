"""CCIR/URSI numerical-map evaluation (Jones & Gallet basis).

Port of ``pyrayhf_tpu.ccir``: the loader is host numpy code (its arrays
become tensors where :func:`eval_ccir_map` evaluates them); the basis
functions and the map evaluation run on tensors, in the JAX module's
order of operations. Host data goes to the CUDA card unless
``device="cpu"``.

The reference's input generators draw foF2 and hmF2 from PyIRI's CCIR
map files (ref ``library.py:2541-2557``: ``foF2_coeff='CCIR'``,
``hmF2_model='SHU2015'`` through ``sh.IRI_density_1day``). Those
coefficient FILES ship with PyIRI/IRI and cannot be vendored here, but
the map *format* and its evaluation basis are published standards
(Jones & Gallet 1962; ITU-R P.1239; the IRI ``GAMMA1`` routine), so the
module implements the full evaluator with **pluggable coefficients**:

* :func:`ccir_geographic_basis` — the mixed modip/latitude/longitude
  Fourier–Legendre geographic functions G_k (76 for foF2, 49 for
  M(3000)F2);
* :func:`ccir_time_basis` — the UT Fourier vector (6 harmonics for
  foF2, 4 for M3000);
* :func:`eval_ccir_map` — coefficient tensor [2, K, MM] → map value,
  with the standard linear solar-activity (R12) mix between the low
  (R12=0) and high (R12=100) coefficient sets;
* :func:`load_ccir_asc` — loader for the standard ``ccirXX.asc`` /
  ``ursiXX.asc`` monthly coefficient files (1976 foF2 + 882 M3000
  whitespace-separated floats);
* :func:`hmf2_from_m3000` — M(3000)F2 → hmF2 (Shimazaki 1955, with the
  optional BSE-1979 ratio correction IRI applies);
* :func:`r12_from_f107` / :func:`f107_from_r12` — the standard
  F10.7↔R12 proxy conversion.

A user with access to IRI/PyIRI coefficient files can pass them to
:func:`pyrayhf_tpu_torch.envgen.climatology_parameters` via ``ccir_maps=`` to
replace the built-in analytic modip climatology with CCIR-grade maps
(see that function's docstring); without files the analytic model
remains the fallback. The evaluation broadcasts over arbitrary batch
shapes and is differentiable.

Ordering contract (identical to IRI's ``GAMMA1``): the K geographic
functions are blocks m = 0..M−1 with sizes ``blocks[m]``; block 0 is
sin(modip)^j for j = 0..blocks[0]−1; block m ≥ 1 contributes
cos^m(lat)·sin(modip)^j·cos(m·lon) and ·sin(m·lon) (cos term first) for
j = 0..blocks[m]−1. K = blocks[0] + 2·sum(blocks[1:]). Per function the
MM time coefficients are [const, sin T, cos T, sin 2T, cos 2T, ...]
with T = (15·UT − 180)°.
"""

import math

import numpy as np
import torch

from ._util import as_tensors

__all__ = ["QF", "QM", "F2_SHAPE", "FM3_SHAPE", "ccir_geographic_basis",
           "ccir_time_basis", "eval_ccir_map", "load_ccir_asc",
           "hmf2_from_m3000", "r12_from_f107", "f107_from_r12"]

# geographic block sizes (number of modip powers per longitude harmonic)
QF = (12, 12, 9, 5, 2, 1, 1, 1, 1)    # foF2: 12 + 2*32 = 76 functions
QM = (7, 8, 6, 3, 2, 1, 1)            # M(3000)F2: 7 + 2*21 = 49 functions

F2_SHAPE = (2, 76, 13)                # (R12 level, G_k, time coeff)
FM3_SHAPE = (2, 49, 9)


def _n_funcs(blocks):
    return blocks[0] + 2 * sum(blocks[1:])


_DEG2RAD = math.pi / 180.0


def ccir_geographic_basis(modip_deg, lat_deg, lon_deg, blocks=QF,
                          device=None):
    """Jones–Gallet geographic functions G_k, stacked on a new last axis.

    ``modip_deg``: modified dip latitude (:func:`pyrayhf_tpu_torch.envgen.
    modip_deg` computes it from the vendored IGRF); ``lat_deg``/
    ``lon_deg``: geographic coordinates. Inputs broadcast; output shape
    is ``broadcast_shape + (K,)`` with K = 76 for the foF2 blocks
    (default) or 49 for ``blocks=QM``.
    """
    mu, lat, lon = (v * _DEG2RAD for v in torch.broadcast_tensors(
        *as_tensors(modip_deg, lat_deg, lon_deg, device=device)))
    s = torch.sin(mu)
    coslat = torch.cos(lat)
    cols = []
    for j in range(blocks[0]):
        cols.append(s ** j)
    for m in range(1, len(blocks)):
        cm = coslat ** m
        c_lon = torch.cos(m * lon)
        s_lon = torch.sin(m * lon)
        for j in range(blocks[m]):
            base = cm * s ** j
            cols.append(base * c_lon)          # cos term first (GAMMA1)
            cols.append(base * s_lon)
    return torch.stack(cols, dim=-1)


def ccir_time_basis(UT_hours, n_harm, device=None):
    """UT Fourier vector [1, sin T, cos T, ..., sin nT, cos nT].

    T = (15·UT − 180)° — the maps are UT-based; local-time structure
    comes from the longitude terms of the geographic basis. Output shape
    ``UT.shape + (2*n_harm + 1,)``.
    """
    (ut,) = as_tensors(UT_hours, device=device)
    T = (15.0 * ut - 180.0) * _DEG2RAD
    cols = [torch.ones_like(T)]
    for k in range(1, n_harm + 1):
        cols.append(torch.sin(k * T))          # sin first (GAMMA1 layout)
        cols.append(torch.cos(k * T))
    return torch.stack(cols, dim=-1)


def eval_ccir_map(coeffs, modip_deg, lat_deg, lon_deg, UT_hours, R12,
                  blocks=None, device=None):
    """Evaluate one monthly CCIR map at (modip, lat, lon, UT, R12).

    ``coeffs``: [2, K, MM] — the two solar-activity coefficient sets
    (R12 = 0 and R12 = 100) from :func:`load_ccir_asc`; K selects the
    basis (76 → foF2 blocks, 49 → M3000 blocks) unless ``blocks`` is
    given explicitly. MM must be odd (1 + 2·n_harm). The standard linear
    activity mix ``U = U0·(1 − R12/100) + U100·(R12/100)`` is applied;
    R12 may itself be an array broadcasting with the coordinates.
    Returns the map value with the broadcast shape of the inputs.
    """
    coeffs, modip_deg, lat_deg, lon_deg, UT_hours, R12 = as_tensors(
        coeffs, modip_deg, lat_deg, lon_deg, UT_hours, R12, device=device)
    if coeffs.ndim != 3 or coeffs.shape[0] != 2:
        raise ValueError(f"coeffs must be [2, K, MM]; got {coeffs.shape}")
    K, MM = coeffs.shape[1], coeffs.shape[2]
    if MM % 2 != 1:
        raise ValueError(f"MM must be odd (1 + 2 harmonics); got {MM}")
    if blocks is None:
        if K == _n_funcs(QF):
            blocks = QF
        elif K == _n_funcs(QM):
            blocks = QM
        else:
            raise ValueError(
                f"K={K} matches neither the foF2 (76) nor M3000 (49) "
                "basis; pass blocks= explicitly")
    elif _n_funcs(blocks) != K:
        raise ValueError(f"blocks {blocks} imply K={_n_funcs(blocks)}, "
                         f"coeffs have K={K}")
    frac = torch.clamp(R12 / 100.0, min=0.0)
    U = coeffs[0] * (1.0 - frac[..., None, None]) \
        + coeffs[1] * frac[..., None, None]      # [..., K, MM]
    tvec = ccir_time_basis(UT_hours, (MM - 1) // 2)          # [..., MM]
    gvec = ccir_geographic_basis(modip_deg, lat_deg, lon_deg,
                                 blocks=blocks)              # [..., K]
    # time-collapse each geographic function, then contract the basis
    xsin = (U * tvec[..., None, :]).sum(-1)
    return (xsin * gvec).sum(-1)


def load_ccir_asc(path):
    """Read a standard monthly ``ccirXX.asc`` / ``ursiXX.asc`` file.

    The file is 2858 whitespace-separated floats: 1976 foF2 coefficients
    (reshaped Fortran-order to [13, 76, 2] → stored [2, 76, 13]) followed
    by 882 M(3000)F2 coefficients ([9, 49, 2] → [2, 49, 9]) — the layout
    IRI's ``READCOH``/PyIRI read with the time index fastest. ``XX`` is
    month + 10 in the IRI convention (the caller picks the month's file).
    Returns ``{"F2": [2, 76, 13], "FM3": [2, 49, 9]}`` (float64 numpy
    arrays) ready for :func:`eval_ccir_map`.
    """
    # not np.loadtxt: the standard files wrap a fixed count of values per
    # line with a ragged final line, which loadtxt rejects
    with open(path) as fh:
        vals = np.array(fh.read().split(), dtype=float)
    n_f2 = int(np.prod(F2_SHAPE))
    n_fm3 = int(np.prod(FM3_SHAPE))
    if vals.size != n_f2 + n_fm3:
        raise ValueError(
            f"{path}: expected {n_f2} + {n_fm3} = {n_f2 + n_fm3} values, "
            f"got {vals.size}")
    # Fortran layout F2(13, 76, 2): time coefficient fastest, activity
    # level slowest → transpose to [level, function, time]
    f2 = vals[:n_f2].reshape(F2_SHAPE[::-1], order="F").transpose(2, 1, 0)
    fm3 = vals[n_f2:].reshape(FM3_SHAPE[::-1],
                              order="F").transpose(2, 1, 0)
    return {"F2": f2, "FM3": fm3}


def hmf2_from_m3000(M3000, foF2=None, foE=None, device=None):
    """hmF2 [km] from the M(3000)F2 propagation factor.

    Shimazaki (1955): hmF2 = 1490/M − 176. When ``foF2`` and ``foE``
    are both given, applies the Bilitza–Sharma–Eyfrig (BSE-1979)
    correction IRI uses: hmF2 = 1490/(M + ΔM) − 176 with
    ΔM = 0.253/(foF2/foE − 1.215) − 0.012 (ratio floored at 1.7 as in
    IRI to keep the correction bounded at night).
    """
    if foF2 is None or foE is None:
        (M,) = as_tensors(M3000, device=device)
        return 1490.0 / M - 176.0
    M, foF2, foE = as_tensors(M3000, foF2, foE, device=device)
    ratio = torch.clamp(foF2 / foE, min=1.7)
    dM = 0.253 / (ratio - 1.215) - 0.012
    return 1490.0 / (M + dM) - 176.0


def f107_from_r12(R12, device=None):
    """Covington proxy: F10.7 = 63.7 + 0.728·R12 + 8.9e-4·R12²."""
    (R,) = as_tensors(R12, device=device)
    return 63.7 + 0.728 * R + 8.9e-4 * R * R


def r12_from_f107(F107, device=None):
    """Inverse of :func:`f107_from_r12` (positive quadratic root).

    Clipped below at R12 = 0 (F10.7 < 63.7 has no sunspot equivalent).
    """
    (F,) = as_tensors(F107, device=device)
    F = torch.clamp(F, min=63.7)
    a, b, c = 8.9e-4, 0.728, 63.7 - F
    return (-b + torch.sqrt(b * b - 4.0 * a * c)) / (2.0 * a)
