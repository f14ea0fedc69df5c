"""Seeded 2-D slices: the oblique cells' traffic generator.

A slice is an altitude × ground-range plane along one great circle, from a
site (the link's transmitter, at range 0) along an azimuth, both drawn
from the seed. Its density is a Chapman F2 layer whose log10 NmF2, hmF2
and scale height vary linearly along the path between two seeded ends,
plus a Chapman E layer on a fixed number of the slices; |B| and ψ are
those of the centred dipole of :mod:`hfbench.inputs` at every (altitude,
range) node of the great circle.

Every seed gets the same set of peak densities: the 2·n ends of n slices
take one value each of 2·n equal strata of log10 NmF2 (their midpoints),
in an order drawn from the seed, so the work of a run, which follows the
peak densities (the rays that come down and how far they travel), is
about the same from seed to seed. All draws are made on the target device
with one ``torch.Generator`` in a few large calls.
"""

import math

import torch

from . import inputs


def great_circle(lat_deg, lon_deg, az_deg, dist_km):
    """(lat, lon) in degrees [n, M] of the points ``dist_km`` [M] along
    the great circle from each site (``lat_deg``, ``lon_deg`` [n]) at
    azimuth ``az_deg`` [n] (clockwise from north), on the sphere of
    radius ``inputs.R_E_KM``."""
    phi = torch.deg2rad(lat_deg)[:, None]
    az = torch.deg2rad(az_deg)[:, None]
    d = (dist_km / inputs.R_E_KM)[None, :]
    s = torch.sin(phi) * torch.cos(d) + torch.cos(phi) * torch.sin(d) * \
        torch.cos(az)
    lat2 = torch.asin(torch.clamp(s, -1.0, 1.0))
    dlon = torch.atan2(torch.sin(az) * torch.sin(d) * torch.cos(phi),
                       torch.cos(d) - torch.sin(phi) * torch.sin(lat2))
    return torch.rad2deg(lat2), lon_deg[:, None] + torch.rad2deg(dlon)


def _chapman(z_km, nm, hm, H):
    """nm · exp(½(1 − u − e^{−u})), u = (z − hm)/H: [n, nz, nx] from
    parameters [n, 1, nx] (or [n, 1, 1]) on the altitudes ``z_km`` [nz]."""
    u = (z_km[None, :, None] - hm) / H
    return nm * torch.exp(0.5 * (1.0 - u - torch.exp(-u)))


def slices(n, e_slices, seed, z_km, x_km, device):
    """(den [m^-3], bmag [T], bpsi [deg]) [n, nz, nx] in float64: ``n``
    slices on the altitude grid ``z_km`` [nz] and ground-range grid
    ``x_km`` [nx], ``e_slices`` of them with an E layer."""
    g = inputs.generator(seed, device)
    kw = dict(dtype=torch.float64, device=device)
    z = torch.as_tensor(z_km, **kw)
    x = torch.as_tensor(x_km, **kw)
    nx = x.numel()
    lat, lon = inputs.random_sites(g, n, device)
    az = inputs._uniform(g, n, 0.0, 360.0, device)
    # the 2n ends: log10 NmF2 by strata, hmF2 and H uniform
    lo, hi = (math.log10(v) for v in inputs.NMF2_RANGE)
    order = torch.randperm(2 * n, generator=g, device=device).to(**kw)
    log_nm = (lo + (hi - lo) * (order + 0.5) / (2 * n)).view(n, 2)
    hm = inputs._uniform(g, 2 * n, *inputs.HMF2_RANGE, device).view(n, 2)
    H = inputs._uniform(g, 2 * n, *inputs.HF2_RANGE, device).view(n, 2)
    w = (x - x[0]) / (x[-1] - x[0])                  # 0 → 1 along the path

    def along(ends):
        return (ends[:, :1] + (ends[:, 1:] - ends[:, :1]) * w[None, :]
                )[:, None, :]                        # [n, 1, nx]

    nm = 10.0 ** along(log_nm)
    den = _chapman(z, nm, along(hm), along(H))
    with_e = torch.randperm(n, generator=g, device=device)[:e_slices]
    share = inputs._uniform(g, e_slices, *inputs.E_PEAK_SHARE, device)
    hme = inputs._uniform(g, e_slices, *inputs.HME_RANGE, device)
    den[with_e] += _chapman(z, share[:, None, None] * 0.15 * nm[with_e],
                            hme[:, None, None], inputs.HE_KM)
    plat, plon = great_circle(lat, lon, az, x)           # [n, nx]
    bmag, bpsi = inputs.dipole(plat.reshape(-1), plon.reshape(-1), z)
    # [n·nx, nz] → [n, nz, nx]
    bmag, bpsi = (a.view(n, nx, -1).transpose(1, 2).contiguous()
                  for a in (bmag, bpsi))
    return den, bmag, bpsi
