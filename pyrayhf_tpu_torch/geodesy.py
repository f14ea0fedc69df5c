"""Geodesy and oblique↔vertical ionogram utilities.

Port of ``pyrayhf_tpu.geodesy`` (reference ``library.py``:
``great_circle_point`` :2340-2387, ``oblique_to_vertical`` :2697-2742,
``earth_radius_at_latitude`` :2745-2772, ``calculate_gcd`` :2775-2830,
``azimuth_between_points`` :2833-2863, ``vertical_to_magnetic_angle``
:441-456). Longitudes wrap to [-180, 180) by an explicit modulo, as in the
JAX module. Degrees convert by one multiplication with π/180 (or 180/π), and
the modulo is the floating remainder with the divisor's sign, both as JAX
computes them, so float64 results agree to the last few ulps.

Host data goes to the CUDA card unless ``device`` says otherwise
(``device="cpu"``); tensors keep their device.
"""

import math

import torch

from ._util import as_tensors
from .constants import R_E

__all__ = ["great_circle_point", "oblique_to_vertical",
           "earth_radius_at_latitude", "calculate_gcd",
           "azimuth_between_points", "vertical_to_magnetic_angle",
           "adjust_longitude"]

_DEG2RAD = math.pi / 180.0
_RAD2DEG = 180.0 / math.pi


def _mod(a, b):
    """``jnp.remainder``: the truncated remainder moved to b's sign."""
    r = torch.fmod(a, b)
    return torch.where((r != 0) & ((r < 0) != (b < 0)), r + b, r)


def vertical_to_magnetic_angle(inclination_deg, device=None):
    """ψ = 90 − |inclination| [deg] (ref :441-456)."""
    (inc,) = as_tensors(inclination_deg, device=device)
    return 90.0 - torch.abs(inc)


def adjust_longitude(lon, mode="to180", device=None):
    """Wrap longitudes to [-180, 180) ('to180') or [0, 360) ('to360')."""
    (lon,) = as_tensors(lon, device=device)
    if mode == "to180":
        return _mod(lon + 180.0, 360.0) - 180.0
    if mode == "to360":
        return _mod(lon, 360.0)
    raise ValueError("mode must be 'to180' or 'to360'")


def great_circle_point(tlat, tlon, gcd, az, device=None):
    """Destination lat/lon from origin, distance [km] and azimuth [deg].

    Spherical Earth (ref :2340-2387).
    """
    tlat, tlon, gcd, az = as_tensors(tlat, tlon, gcd, az, device=device)
    s = gcd / R_E
    tlat_r = tlat * _DEG2RAD
    tlon_r = tlon * _DEG2RAD
    az_r = az * _DEG2RAD
    rlat_r = torch.arcsin(torch.sin(tlat_r) * torch.cos(s)
                          + torch.cos(tlat_r) * torch.sin(s)
                          * torch.cos(az_r))
    rlon_r = tlon_r + torch.arctan2(
        torch.sin(az_r) * torch.sin(s) * torch.cos(tlat_r),
        torch.cos(s) - torch.sin(tlat_r) * torch.sin(rlat_r))
    return rlat_r * _RAD2DEG, adjust_longitude(rlon_r * _RAD2DEG, "to180")


def oblique_to_vertical(range_km, group_path_km, freq_oblique_mhz,
                        R_E_km=R_E, device=None):
    """Secant-law oblique→vertical equivalence with curvature correction.

    (ref :2697-2742) Returns (freq_vertical_mhz, height_virtual_km).
    """
    D, p, f_o = as_tensors(range_km, group_path_km, freq_oblique_mhz,
                           device=device)
    theta = (D / 2.0) / R_E_km
    curvature_correction = R_E_km * (1.0 - torch.cos(theta))
    phi = torch.arcsin(D / p)
    height_virtual_km = 0.5 * p * torch.cos(phi) - curvature_correction
    freq_vertical_mhz = f_o * torch.cos(phi)
    return freq_vertical_mhz, height_virtual_km


def earth_radius_at_latitude(latitude, device=None):
    """Oblate-spheroid Earth radius [km] at geodetic latitude
    (ref :2745-2772)."""
    (lat,) = as_tensors(latitude, device=device)
    lat = lat * _DEG2RAD
    a = 6378.137
    b = 6356.7523142
    c, s = torch.cos(lat), torch.sin(lat)
    num = (a ** 2 * c) ** 2 + (b ** 2 * s) ** 2
    den = (a * c) ** 2 + (b * s) ** 2
    return torch.sqrt(num / den)


def calculate_gcd(lon0, lat0, lon1, lat1, device=None):
    """Great-circle distance in degrees (ref :2775-2830)."""
    lon0, lat0, lon1, lat1 = as_tensors(lon0, lat0, lon1, lat1,
                                        device=device)
    coslt1 = torch.cos(lat1 * _DEG2RAD)
    sinlt1 = torch.sin(lat1 * _DEG2RAD)
    coslt0 = torch.cos(lat0 * _DEG2RAD)
    sinlt0 = torch.sin(lat0 * _DEG2RAD)
    cosl0l1 = torch.cos((lon1 - lon0) * _DEG2RAD)
    cosc = sinlt0 * sinlt1 + coslt0 * coslt1 * cosl0l1
    cosc = torch.clamp(cosc, -1.0, 1.0)
    return torch.arccos(cosc) * _RAD2DEG


def azimuth_between_points(lon1_deg, lat1_deg, lon2_deg, lat2_deg,
                           device=None):
    """Forward azimuth [deg, 0..360) from point 1 to 2 (ref :2833-2863)."""
    lon1, lat1, lon2, lat2 = (
        v * _DEG2RAD for v in as_tensors(lon1_deg, lat1_deg, lon2_deg,
                                         lat2_deg, device=device))
    dlon = lon2 - lon1
    x = torch.sin(dlon) * torch.cos(lat2)
    y = (torch.cos(lat1) * torch.sin(lat2)
         - torch.sin(lat1) * torch.cos(lat2) * torch.cos(dlon))
    return _mod(torch.arctan2(x, y) * _RAD2DEG + 360.0, 360.0)
