"""Geomagnetic field models for ray-tracing inputs.

Port of ``pyrayhf_tpu.igrf`` (the reference takes |B| and the inclination
from PyIRI's IGRF-13, ``calculate_magnetic_field`` ref
``library.py:2390-2439``):

* :func:`schmidt_legendre` + :func:`igrf_field`: the spherical-harmonic
  field of any degree on broadcast (lat, lon, alt) tensors, with optional
  geodetic (WGS84) input coordinates. The default coefficients are the
  IGRF-13 epoch-2020 degree-13 table (:mod:`.igrf13_table`); a standard
  ``igrf13coeffs.txt`` file loads with :func:`load_igrf_coefficients`, and
  :data:`IGRF13_2020_N3` is its degree-3 subset;
* :func:`calculate_magnetic_field`: (|B| [T], ψ = 90 − |inclination|
  [deg]) on an (alt × location) grid in one broadcast evaluation; the date
  selects the coefficient epoch (:func:`coefficients_for_date`).

The recursions and sums run in the JAX module's order. The coefficient
tables are host numpy data (their parsing and epoch interpolation are the
JAX module's, on the host); the evaluation runs where the inputs are: the
CUDA card for host data unless ``device="cpu"``.
"""

import datetime
import math

import numpy as np
import torch

from . import igrf13_table
from ._util import as_tensors
from .constants import R_E

__all__ = ["IGRF13_2020_N3", "load_igrf_coefficients", "igrf_field",
           "calculate_magnetic_field", "coefficients_for_date",
           "dipole_field", "schmidt_legendre"]

_DEG2RAD = math.pi / 180.0
_RAD2DEG = 180.0 / math.pi


def coefficients_for_date(year, month, day):
    """Coefficient table {g, h} (numpy) at the decimal epoch of a date.

    The one date → epoch → table resolution shared by
    :func:`calculate_magnetic_field` and the climatology's modip
    (:func:`pyrayhf_tpu_torch.envgen.modip_deg`).
    """
    d = datetime.date(int(year), int(month), int(day))
    ystart = datetime.date(d.year, 1, 1)
    ylen = (datetime.date(d.year + 1, 1, 1) - ystart).days
    return igrf13_table.coefficients_at_epoch(
        d.year + (d - ystart).days / ylen)


# IGRF-13 main-field coefficients, epoch 2020.0, degrees 1..3 [nT]
# (g[n][m], h[n][m]); the dominant dipole + quadrupole + octupole terms.
IGRF13_2020_N3 = {
    "g": np.array([
        [0.0, 0.0, 0.0, 0.0],
        [-29404.8, -1450.9, 0.0, 0.0],
        [-2499.6, 2982.0, 1677.0, 0.0],
        [1363.2, -2381.2, 1236.2, 525.7],
    ]),
    "h": np.array([
        [0.0, 0.0, 0.0, 0.0],
        [0.0, 4652.5, 0.0, 0.0],
        [0.0, -2991.6, -734.6, 0.0],
        [0.0, -82.1, 241.9, -543.4],
    ]),
}


def load_igrf_coefficients(path, epoch=2020.0):
    """Parse a standard ``igrf13coeffs.txt`` table into {g, h} arrays.

    Linear interpolation between the two nearest epochs (or secular
    variation extrapolation past the last epoch column). Epochs before the
    first table year are rejected. Host parsing, as in the JAX module.
    """
    rows = []
    header = None
    with open(path) as f:
        for line in f:
            if line.startswith(("#", "c/s")) or not line.strip():
                continue
            parts = line.split()
            if parts[0] in ("g", "h"):
                rows.append(parts)
            elif parts[0] == "g/h":
                header = parts
    if header is None:
        raise ValueError(
            f"{path}: no 'g/h' header row — not an igrf13coeffs.txt-format "
            "file")
    years = [float(y) for y in header[3:-1]]
    if epoch < years[0]:
        raise ValueError(
            f"epoch {epoch} precedes the table's first year {years[0]}")
    nmax = max(int(r[1]) for r in rows)
    g = np.zeros((nmax + 1, nmax + 1))
    h = np.zeros((nmax + 1, nmax + 1))
    for r in rows:
        n, m = int(r[1]), int(r[2])
        vals = [float(v) for v in r[3:-1]]
        sv = float(r[-1])
        if epoch >= years[-1]:
            val = vals[-1] + sv * (epoch - years[-1])
        else:
            val = np.interp(epoch, years, vals)
        if r[0] == "g":
            g[n, m] = val
        else:
            h[n, m] = val
    return {"g": g, "h": h}


def _legendre(nmax, theta):
    """(P, dP): lists [n][m] of tensors (None above the diagonal)."""
    ct = torch.cos(theta)
    st = torch.clamp(torch.sin(theta), min=1e-12)
    P = [[None] * (nmax + 1) for _ in range(nmax + 1)]
    dP = [[None] * (nmax + 1) for _ in range(nmax + 1)]
    P[0][0] = torch.ones_like(theta)
    dP[0][0] = torch.zeros_like(theta)
    # Schmidt semi-normalised recursions:
    #   P_n^n = sqrt((2n-1)/(2n)) st P_{n-1}^{n-1}            (n > 1)
    #   P_n^m = ((2n-1) ct P_{n-1}^m
    #            - sqrt((n-1)^2 - m^2) P_{n-2}^m) / sqrt(n^2 - m^2)
    for n in range(1, nmax + 1):
        for m in range(0, n + 1):
            if n == m:
                fac = math.sqrt(1.0 - 1.0 / (2.0 * m)) if m > 1 else 1.0
                P[n][m] = fac * st * P[n - 1][m - 1]
                dP[n][m] = fac * (st * dP[n - 1][m - 1]
                                  + ct * P[n - 1][m - 1])
            else:
                norm = math.sqrt(float(n * n - m * m))
                a = (2.0 * n - 1.0) / norm
                b = math.sqrt(float((n - 1) ** 2 - m * m)) / norm
                prev2 = P[n - 2][m] if n >= 2 and m <= n - 2 else 0.0
                dprev2 = dP[n - 2][m] if n >= 2 and m <= n - 2 else 0.0
                P[n][m] = a * ct * P[n - 1][m] - b * prev2
                dP[n][m] = (a * (ct * dP[n - 1][m] - st * P[n - 1][m])
                            - b * dprev2)
    return P, dP, st


def schmidt_legendre(nmax, theta, device=None):
    """Schmidt semi-normalised associated Legendre P_n^m(cosθ) and dP/dθ.

    Returns (P, dP) of shape [..., nmax+1, nmax+1] (zero above the
    diagonal), by the recursion of the JAX module.
    """
    (theta,) = as_tensors(theta, device=device)
    P, dP, _ = _legendre(int(nmax), theta)
    zero = torch.zeros_like(theta)

    def stack(L):
        return torch.stack([torch.stack([v if v is not None else zero
                                         for v in row], -1) for row in L],
                           -2)

    return stack(P), stack(dP)


def _host_coeffs(coeffs):
    if coeffs is None:
        coeffs = {"g": igrf13_table.G2020, "h": igrf13_table.H2020}

    def host(a):
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu().numpy()
        return np.asarray(a, dtype=np.float64)

    return host(coeffs["g"]), host(coeffs["h"])


def igrf_field(lat_deg, lon_deg, alt_km, coeffs=None, geodetic=False,
               device=None):
    """Geomagnetic field at (lat, lon, alt).

    Returns (B_north, B_east, B_down, |B|, inclination_deg) in nT and
    degrees, broadcast over the inputs. ``coeffs`` (numpy {g, h}) defaults
    to the IGRF-13 epoch-2020 degree-13 table. ``geodetic=True`` takes
    WGS84 geodetic latitude / altitude above the spheroid (``igrf13syn``'s
    convention, and the reference's PyIRI inputs) and returns components in
    the local geodetic frame; otherwise (lat, alt) are geocentric with
    r = R_E + alt. Host data goes to the card unless ``device="cpu"``.
    """
    g, h = _host_coeffs(coeffs)
    nmax = g.shape[0] - 1
    lat, lon, alt_km = torch.broadcast_tensors(
        *as_tensors(lat_deg, lon_deg, alt_km, device=device))
    lat = lat * _DEG2RAD
    lon = lon * _DEG2RAD
    if geodetic:
        # igrf13syn WGS84 geodetic -> geocentric conversion:
        # (st0, ct0) = (sin, cos) of the geodetic colatitude
        a2, b2 = 40680631.6, 40408296.0
        st0 = torch.cos(lat)
        ct0 = torch.sin(lat)
        one = a2 * st0 * st0
        two = b2 * ct0 * ct0
        three = one + two
        rho = torch.sqrt(three)
        r = torch.sqrt(alt_km * (alt_km + 2.0 * rho)
                       + (a2 * one + b2 * two) / three)
        cd = (alt_km + rho) / r
        sd = (a2 - b2) / rho * ct0 * st0 / r
        theta = torch.arccos(torch.clamp(ct0 * cd - st0 * sd, -1.0, 1.0))
    else:
        theta = math.pi / 2.0 - lat        # geocentric colatitude
        r = R_E + alt_km
    a_over_r = 6371.2 / r                  # IGRF reference radius

    P, dP, st = _legendre(nmax, theta)
    Br = torch.zeros_like(theta)
    Bt = torch.zeros_like(theta)
    Bp = torch.zeros_like(theta)
    for n in range(1, nmax + 1):
        rad = a_over_r ** (n + 2)
        for m in range(0, n + 1):
            cml = torch.cos(m * lon)
            sml = torch.sin(m * lon)
            gnm, hnm = float(g[n, m]), float(h[n, m])
            gh_c = gnm * cml + hnm * sml
            gh_s = gnm * sml - hnm * cml
            Br = Br + (n + 1) * rad * gh_c * P[n][m]
            Bt = Bt - rad * gh_c * dP[n][m]
            Bp = Bp + m * rad * gh_s * P[n][m] / st
    B_north = -Bt
    B_east = Bp
    B_down = -Br
    if geodetic:
        # rotate (north, down) from the geocentric to the geodetic frame
        bn = B_north * cd + B_down * sd
        B_down = B_down * cd - B_north * sd
        B_north = bn
    Bmag = torch.sqrt(B_north ** 2 + B_east ** 2 + B_down ** 2)
    Bh = torch.sqrt(B_north ** 2 + B_east ** 2)
    inc = torch.arctan2(B_down, Bh) * _RAD2DEG
    return B_north, B_east, B_down, Bmag, inc


def dipole_field(lat_deg, lon_deg, alt_km, device=None):
    """Centered tilted dipole only (degree-1 truncation of IGRF-13 2020)."""
    c = {"g": IGRF13_2020_N3["g"][:2, :2], "h": IGRF13_2020_N3["h"][:2, :2]}
    return igrf_field(lat_deg, lon_deg, alt_km, coeffs=c, device=device)


def calculate_magnetic_field(year, month, day, lat, lon, aalt, coeffs=None,
                             device=None):
    """API-parity with the reference (ref library.py:2390-2439).

    Returns (mag [N_alt, N_loc] in **Tesla**, psi [N_alt, N_loc] in degrees
    from vertical) in one broadcast evaluation. The date selects the
    coefficient epoch (>= 2020 by the IGRF-13 secular variation, 1900-2020
    by the DGRF back-catalogue of :mod:`.igrf_history`); ``coeffs`` from
    :func:`load_igrf_coefficients` overrides it. Inputs are geodetic, like
    the reference's PyIRI call.
    """
    if coeffs is None:
        coeffs = coefficients_for_date(year, month, day)
    lat, lon, aalt = (torch.atleast_1d(t) for t in
                      as_tensors(lat, lon, aalt, device=device))
    _, _, _, Bmag, inc = igrf_field(lat[None, :], lon[None, :],
                                    aalt[:, None], coeffs=coeffs,
                                    geodetic=True)
    psi = 90.0 - torch.abs(inc)
    return Bmag / 1e9, psi
