"""Seeded ionospheric profiles: the benchmark's traffic generator.

A profile is a Chapman F2 layer, plus a Chapman E layer below it on a
fixed share of the profiles, with |B| and ψ of a centred dipole at the
profile's site. PyIRI, which the upstream examples draw their densities
from, is not available here, so the layer parameters are drawn from the
seed in the ranges of mid-latitude F2 climatology.

Every seed gets the same set of peak densities (one per stratum of
log10 NmF2, in another order) and the same number of E layers, so the
work of a run, which follows the peak density (the pairs that reflect),
is the same from seed to seed. All draws are made on the target device
with one ``torch.Generator`` in a few large calls.
"""

import math

import torch

# centred dipole of IGRF-13 at 2020.0: geomagnetic north pole and the
# equatorial field at the surface, B0 = sqrt(g10² + g11² + h11²)
POLE_LAT_DEG, POLE_LON_DEG = 80.65, -72.68
B0_T = 2.9717e-5
R_E_KM = 6371.2

NMF2_RANGE = (1e11, 3e12)          # m^-3
HMF2_RANGE = (220.0, 380.0)        # km
HF2_RANGE = (40.0, 70.0)           # km, scale height
E_PEAK_SHARE = (0.6, 1.2)          # NmE / (0.15 NmF2)
HME_RANGE = (105.0, 120.0)         # km
HE_KM = 8.0


def generator(seed, device):
    """A ``torch.Generator`` on ``device`` seeded with ``seed`` (any whole
    number that fits in 64 bits)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & ((1 << 64) - 1))
    return g


def _uniform(g, n, lo, hi, device):
    return lo + (hi - lo) * torch.rand(n, generator=g, device=device,
                                       dtype=torch.float64)


def global_sites(n_lat, n_lon, device):
    """(lat, lon) in degrees of a regular n_lat × n_lon grid, poles
    included (73 × 144 is the 2.5° grid), latitude-major."""
    lat = torch.linspace(-90.0, 90.0, n_lat, dtype=torch.float64,
                         device=device)
    lon = torch.arange(n_lon, dtype=torch.float64, device=device) * (
        360.0 / n_lon)
    return (lat[:, None].expand(n_lat, n_lon).reshape(-1),
            lon[None, :].expand(n_lat, n_lon).reshape(-1))


def random_sites(g, n, device):
    """(lat, lon) in degrees of ``n`` sites uniform on the sphere."""
    lat = torch.rad2deg(torch.asin(_uniform(g, n, -1.0, 1.0, device)))
    return lat, _uniform(g, n, 0.0, 360.0, device)


def dipole(lat_deg, lon_deg, alt_km):
    """|B| [T] and ψ [deg] of the centred dipole, [n, N_alt] each.

    ψ is the angle between the field and the vertical, 90° − |I|, with
    the inclination tan I = 2 tan(geomagnetic latitude); |B| falls as
    r⁻³ with height.
    """
    phi = torch.deg2rad(lat_deg)
    dlon = torch.deg2rad(lon_deg - POLE_LON_DEG)
    php = math.radians(POLE_LAT_DEG)
    s = (torch.sin(phi) * math.sin(php)
         + torch.cos(phi) * math.cos(php) * torch.cos(dlon))
    s = torch.clamp(s, -1.0, 1.0)
    lam = torch.asin(s)
    incl = torch.atan(2.0 * torch.tan(lam))
    psi = 90.0 - torch.rad2deg(torch.abs(incl))
    r = (R_E_KM / (R_E_KM + alt_km)) ** 3
    bmag = B0_T * torch.sqrt(1.0 + 3.0 * s * s)[:, None] * r[None, :]
    return bmag, psi[:, None].expand(-1, alt_km.shape[0]).contiguous()


def chapman_profiles(g, n, alt_km, e_share):
    """Electron density [n, N_alt] in m^-3.

    log10 NmF2 takes one value per stratum of ``n`` equal strata of
    ``NMF2_RANGE`` (their midpoints), in an order drawn from the seed;
    exactly round(e_share · n) profiles, drawn from the seed, carry an E
    layer.
    """
    dev = alt_km.device
    lo, hi = (math.log10(v) for v in NMF2_RANGE)
    order = torch.randperm(n, generator=g, device=dev).to(torch.float64)
    nm = 10.0 ** (lo + (hi - lo) * (order + 0.5) / n)
    hm = _uniform(g, n, *HMF2_RANGE, dev)
    H = _uniform(g, n, *HF2_RANGE, dev)
    z = (alt_km[None, :] - hm[:, None]) / H[:, None]
    den = nm[:, None] * torch.exp(0.5 * (1.0 - z - torch.exp(-z)))
    n_e = int(round(e_share * n))
    with_e = torch.randperm(n, generator=g, device=dev)[:n_e]
    nme = _uniform(g, n_e, *E_PEAK_SHARE, dev) * 0.15 * nm[with_e]
    ze = (alt_km[None, :] - _uniform(g, n_e, *HME_RANGE, dev)[:, None]) / HE_KM
    den[with_e] += nme[:, None] * torch.exp(0.5 * (1.0 - ze - torch.exp(-ze)))
    return den


def profiles(traffic, seed, alt_km, device):
    """(den, bmag, bpsi) [rows, N_alt] in float64 for ``traffic``: its
    ``profiles_per_call`` × ``pool_calls`` rows, call-major.

    ``sites`` is ``"global"`` (the ``grid`` of lat × lon, the same sites
    in every call) or ``"random"`` (sites uniform on the sphere).
    """
    B, calls = traffic["profiles_per_call"], traffic["pool_calls"]
    g = generator(seed, device)
    alt = torch.as_tensor(alt_km, dtype=torch.float64, device=device)
    if traffic["sites"] == "global":
        lat, lon = global_sites(*traffic["grid"], device)
        if lat.numel() != B:
            raise ValueError(f"a {traffic['grid']} grid has {lat.numel()} "
                             f"sites, the traffic {B} profiles a call")
        lat, lon = lat.repeat(calls), lon.repeat(calls)
    elif traffic["sites"] == "random":
        lat, lon = random_sites(g, B * calls, device)
    else:
        raise ValueError(f"unknown sites {traffic['sites']!r}")
    den = chapman_profiles(g, B * calls, alt, traffic["e_layer_share"])
    bmag, bpsi = dipole(lat, lon, alt)
    return den, bmag, bpsi
