"""Ionosphere/geomagnetic input generation (environment models).

Port of ``pyrayhf_tpu.envgen`` (the reference's ``generate_input_1D/2D``,
ref ``library.py:2458-2694``, call PyIRI): the great-circle and grid
geometry of the reference with the JAX module's analytic climatology for
the layer parameters —

* foE from the Davies (1990) solar-zenith relation, foF1 from the DuCharme
  relation with an F1-presence probability;
* foF2/hmF2 from the modified-dip-latitude (modip) model of the JAX module
  (equatorial-anomaly crests, the daytime dip-equator trough, the
  post-sunset enhancement, the night depression and the winter anomaly),
  or from CCIR/URSI maps (:mod:`.ccir`) when ``ccir_maps`` are passed;
* |B| and ψ from the spherical-harmonic IGRF (:mod:`.igrf`).

The profiles come from the port's parametric EDP builder (:mod:`.edp`).
Every location of a call evaluates in one broadcast, on the CUDA card
unless ``device="cpu"``. The generators return the JAX functions' dicts
of numpy arrays, and ``save_path`` writes the pickle that
:func:`pyrayhf_tpu_torch.io.load_input` reads.
"""

import math

import torch

from . import edp
from ._util import as_tensors, clip, resolve_device
from .geodesy import (_mod, azimuth_between_points, calculate_gcd,
                      earth_radius_at_latitude, great_circle_point)
from .igrf import calculate_magnetic_field
from .io import save_to_file

__all__ = ["solar_zenith_angle", "climatology_parameters", "modip_deg",
           "generate_input_1D", "generate_input_2D", "generate_input_3D",
           "find_mean_gradient_error"]

_DEG2RAD = math.pi / 180.0
_RAD2DEG = 180.0 / math.pi


def _day_of_year(year, month, day):
    days = [31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31]
    leap = (year % 4 == 0 and year % 100 != 0) or year % 400 == 0
    if leap:
        days[1] = 29
    return sum(days[:month - 1]) + day


def solar_zenith_angle(year, month, day, UT, lat, lon, device=None):
    """Solar zenith angle χ [deg] (standard declination/hour-angle formula)."""
    doy = _day_of_year(year, month, day)
    decl = 23.44 * _DEG2RAD * math.sin(2.0 * math.pi * (284.0 + doy) / 365.0)
    lat, lon = as_tensors(lat, lon, device=device)
    lat_r = lat * _DEG2RAD
    lst = _mod(UT + lon / 15.0, 24.0)
    hour_angle = ((lst - 12.0) * 15.0) * _DEG2RAD
    cos_chi = (torch.sin(lat_r) * math.sin(decl)
               + torch.cos(lat_r) * math.cos(decl) * torch.cos(hour_angle))
    return torch.arccos(clip(cos_chi, -1.0, 1.0)) * _RAD2DEG


def modip_deg(year, month, day, lat, lon, coeffs=None, device=None):
    """Modified dip latitude μ [deg]: tan μ = I / √(cos φ).

    ``I`` is the IGRF magnetic inclination (radians) at 300 km; φ is the
    geographic latitude.
    """
    from .igrf import coefficients_for_date, igrf_field
    if coeffs is None:
        coeffs = coefficients_for_date(year, month, day)
    lat, lon = as_tensors(lat, lon, device=device)
    _, _, _, _, inc = igrf_field(lat, lon, 300.0, coeffs=coeffs,
                                 geodetic=True)
    I = inc * _DEG2RAD
    coslat = clip(torch.cos(lat * _DEG2RAD), 1e-9, 1.0)
    return torch.arctan2(I, torch.sqrt(coslat)) * _RAD2DEG


def climatology_parameters(year, month, day, UT, lat, lon, F107,
                           coeffs=None, ccir_maps=None, device=None):
    """Analytic layer-parameter climatology at the given locations.

    Returns (F2, F1, E) dicts of tensors broadcast over lat/lon, with the
    keys of the reference's PyIRI dicts (Nm, fo, hm, B_bot, B_top, B0, B1,
    P, solzen...), as the JAX function. ``coeffs`` overrides the IGRF
    epoch table of the modip. ``ccir_maps``: a month's CCIR/URSI
    coefficients (``{"F2": [2, 76, 13], "FM3": [2, 49, 9]}``, from
    :func:`pyrayhf_tpu_torch.ccir.load_ccir_asc`); when given, foF2 comes
    from the map (R12 from F107 by the Covington proxy) and hmF2 from the
    map M(3000)F2 by the BSE-1979 relation.
    """
    lat, lon = as_tensors(lat, lon, device=device)
    F107 = float(F107)
    chi = solar_zenith_angle(year, month, day, UT, lat, lon)
    cos_chi = torch.cos(chi * _DEG2RAD)
    cos_eff = clip(cos_chi, 0.0, 1.0)

    # E layer: Davies (1990) foE relation with the night floor of the JAX
    # module (foE = 0.70 MHz)
    foE = 0.9 * ((180.0 + 1.44 * F107)
                 * torch.clamp(cos_eff, min=1e-4)) ** 0.25
    foE = torch.clamp(foE, min=0.7)
    E = {"Nm": edp.NM_PER_MHZ2 * foE ** 2, "fo": foE,
         "hm": torch.full_like(foE, 110.0),
         "B_bot": torch.full_like(foE, 5.0),
         "B_top": torch.full_like(foE, 7.0), "solzen": chi}

    # F1 layer: DuCharme foF1 + daytime presence probability
    foF1 = (4.3 + 0.01 * F107) * cos_eff ** 0.2
    P = clip(cos_eff * 1.2, 0.0, 1.0) * (chi < 89.0)
    F1 = {"Nm": edp.NM_PER_MHZ2 * foF1 ** 2, "fo": foF1, "P": P,
          "hm": torch.full_like(foF1, 180.0),
          "B_bot": torch.full_like(foF1, 50.0)}

    # F2 layer: the modip model of the JAX module (crest, trough,
    # post-sunset enhancement, night depression, high-modip decay)
    m = modip_deg(year, month, day, lat, lon, coeffs=coeffs)
    am = torch.abs(m)
    s = (min(max(F107, 70.0), 200.0) - 70.0) / 130.0
    lst = _mod(UT + lon / 15.0, 24.0)
    crest = torch.exp(-((am - 16.0) / 8.0) ** 2)
    daygate = cos_eff ** 0.5
    G = (1.0 + 0.22 * crest - 0.12 * torch.exp(-(m / 7.0) ** 2) * daygate) \
        * (1.0 - 0.25 * clip((am - 35.0) / 35.0, 0.0, 1.0) * daygate)
    dt_pss = _mod(lst - 22.5 + 12.0, 24.0) - 12.0
    pss = torch.exp(-(dt_pss / 3.0) ** 2) * torch.exp(-(m / 20.0) ** 2)
    T = 0.55 + 0.35 * daygate + 0.787 * pss
    dep = 1.0 - 0.42 * clip((am - 25.0) / 30.0, 0.0, 1.0) \
        * (1.0 - cos_eff ** 0.3)
    # winter anomaly: daytime mid-modip foF2 enhanced in the winter
    # hemisphere, scaling with solar activity
    doy = _day_of_year(year, month, day)
    seas = math.sin(2.0 * math.pi * (doy - 81.0) / 365.25)  # +1 ≈ N summer
    wgate = clip(-torch.sign(m) * seas, 0.0, 1.0)           # winter hemi
    midlat = (clip((am - 22.0) / 15.0, 0.0, 1.0)
              * clip((65.0 - am) / 15.0, 0.0, 1.0))
    winter = 1.0 + 0.6 * s * daygate * midlat * wgate
    K = 6.274 * (1.0 + 1.15 * s)
    foF2 = K * G * T * dep * winter
    foF2 = torch.maximum(foF2, 1.1 * foE + 0.5)
    if ccir_maps is not None:
        from . import ccir as _ccir
        R12 = _ccir.r12_from_f107(F107, device=lat.device).to(lat.dtype)
        foF2_map = _ccir.eval_ccir_map(ccir_maps["F2"], m, lat, lon,
                                       float(UT), R12)
        foF2 = torch.maximum(foF2_map, 1.1 * foE + 0.5)
    # hmF2: daytime low-modip uplift over an activity-scaled base
    hmF2 = 241.44 + 40.0 * s + 80.54 * cos_eff ** 0.8 \
        * torch.exp(-(m / 25.0) ** 2)
    M3000_map = None
    if ccir_maps is not None and "FM3" in ccir_maps:
        from . import ccir as _ccir
        R12 = _ccir.r12_from_f107(F107, device=lat.device).to(lat.dtype)
        M3000_map = _ccir.eval_ccir_map(ccir_maps["FM3"], m, lat, lon,
                                        float(UT), R12)
        hmF2 = _ccir.hmf2_from_m3000(M3000_map, foF2, foE)
    # bottomside thicker by day
    B_bot = 42.04 + 17.11 * cos_eff ** 0.8
    B_top = 43.57 + 1.83 * (1.0 - cos_eff)
    B0 = 108.06 + 144.35 * cos_eff ** 1.2
    B1 = 2.728 - 1.231 * cos_eff ** 1.2
    M3000 = (2.694 - 0.434 * cos_eff if M3000_map is None
             else torch.broadcast_to(M3000_map, hmF2.shape))
    F2 = {"Nm": edp.NM_PER_MHZ2 * foF2 ** 2, "fo": foF2, "hm": hmF2,
          "B_bot": B_bot, "B_top": B_top,
          "B0": B0, "B1": B1, "M3000": M3000}
    return F2, F1, E


def _edp_from_params(F2, F1, E, aalt):
    """EDPs [P, N_alt] of a batch of parameter sets (flattened), one
    broadcast of the 1-level builder."""
    def col(v):
        return v.reshape(-1, 1)

    nm, hm, bb, bt = (col(F2[k]) for k in ("Nm", "hm", "B_bot", "B_top"))
    p, nmE, hmE = col(F1["P"]), col(E["Nm"]), col(E["hm"])
    NmF1, _, hmF1, _ = edp.derive_dependent_F1_parameters(p, nm, hm, bb, hmE)
    return edp.reconstruct_density_1level(
        {"Nm": nm, "hm": hm, "B_bot": bb, "B_top": bt},
        {"Nm": NmF1, "hm": hmF1},
        {"Nm": nmE, "hm": hmE, "B_bot": 5.0, "B_top": 7.0}, aalt)


def _host(layer, shape=None):
    return {k: (v.cpu().numpy() if shape is None
                else v.cpu().numpy().reshape(shape))
            for k, v in layer.items()}


def generate_input_1D(year, month, day, UT, tlat, tlon, aalt, F107,
                      save_path="", coeffs=None, device=None):
    """1-D ray-tracing input at a site (API-parity, ref :2590-2694).

    Returns the reference's dict layout (numpy arrays): alt/den/bmag/bpsi
    + layer dicts + metadata.
    """
    dev = resolve_device(device)
    (aalt,) = as_tensors(aalt, device=dev)
    bmag, bpsi = calculate_magnetic_field(year, month, day, [float(tlat)],
                                          [float(tlon)], aalt, coeffs=coeffs,
                                          device=dev)
    F2, F1, E = climatology_parameters(year, month, day, UT, [float(tlat)],
                                       [float(tlon)], F107, coeffs=coeffs,
                                       device=dev)
    den = _edp_from_params(F2, F1, E, aalt)[0]
    out = {"alt": aalt.cpu().numpy(), "den": den.cpu().numpy(),
           "bmag": bmag[:, 0].cpu().numpy(), "bpsi": bpsi[:, 0].cpu().numpy(),
           "F2": _host(F2), "F1": _host(F1), "E": _host(E),
           "year": year, "month": month, "day": day, "UT": UT,
           "F107": F107, "tlat": tlat, "tlon": tlon}
    if save_path:
        save_to_file(out, save_path)
    return out


def generate_input_2D(year, month, day, UT, tlat, tlon, dx, aalt, gcd, az,
                      F107, save_path="", coeffs=None, device=None):
    """2-D great-circle-slice input grid (API-parity, ref :2458-2587)."""
    dev = resolve_device(device)
    (aalt,) = as_tensors(aalt, device=dev)
    n_x = int(gcd / dx)
    from .oblique import _linspace
    lims, _ = as_tensors([0.0, float(gcd)], aalt)
    xgrid = _linspace(lims[0], lims[1], n_x)
    xlat, xlon = great_circle_point(tlat, tlon, xgrid, az)
    bmag, bpsi = calculate_magnetic_field(year, month, day, xlat, xlon,
                                          aalt, coeffs=coeffs)
    F2, F1, E = climatology_parameters(year, month, day, UT, xlat, xlon,
                                       F107, coeffs=coeffs)
    den = _edp_from_params(F2, F1, E, aalt).T          # [N_alt, n_x]
    out = {"xgrid": xgrid.cpu().numpy(), "zgrid": aalt.cpu().numpy(),
           "xlat": xlat.cpu().numpy(), "xlon": xlon.cpu().numpy(),
           "den": den.cpu().numpy(), "bmag": bmag.cpu().numpy(),
           "bpsi": bpsi.cpu().numpy(),
           "F2": _host(F2), "F1": _host(F1), "E": _host(E),
           "year": year, "month": month, "day": day, "UT": UT,
           "F107": F107, "tlat": tlat, "tlon": tlon, "az": az}
    if save_path:
        save_to_file(out, save_path)
    return out


def generate_input_3D(year, month, day, UT, lat_grid, lon_grid, aalt, F107,
                      save_path="", coeffs=None, device=None):
    """3-D ray-tracing input volume on an (alt × lat × lon) grid.

    Beyond the reference (its generators stop at 2-D slices, ref
    ``library.py:2458-2587``): the den/bmag/bpsi volumes
    [N_alt, N_lat, N_lon] that :func:`pyrayhf_tpu_torch.trace3d
    .build_field_3d` takes, evaluated on the flattened lat×lon point set
    in one broadcast.
    """
    dev = resolve_device(device)
    aalt, lat_grid, lon_grid = as_tensors(aalt, lat_grid, lon_grid,
                                          device=dev)
    glat, glon = torch.meshgrid(lat_grid, lon_grid, indexing="ij")
    flat_lat, flat_lon = glat.reshape(-1), glon.reshape(-1)
    shape3 = (aalt.shape[0], lat_grid.shape[0], lon_grid.shape[0])
    bmag, bpsi = calculate_magnetic_field(year, month, day, flat_lat,
                                          flat_lon, aalt, coeffs=coeffs)
    F2, F1, E = climatology_parameters(year, month, day, UT, flat_lat,
                                       flat_lon, F107, coeffs=coeffs)
    den = _edp_from_params(F2, F1, E, aalt).T          # [N_alt, n_pts]
    out = {"alt": aalt.cpu().numpy(), "lat": lat_grid.cpu().numpy(),
           "lon": lon_grid.cpu().numpy(),
           "den": den.cpu().numpy().reshape(shape3),
           "bmag": bmag.cpu().numpy().reshape(shape3),
           "bpsi": bpsi.cpu().numpy().reshape(shape3),
           "F2": _host(F2, shape3[1:]), "F1": _host(F1, shape3[1:]),
           "E": _host(E, shape3[1:]),
           "year": year, "month": month, "day": day, "UT": UT,
           "F107": F107}
    if save_path:
        save_to_file(out, save_path)
    return out


def find_mean_gradient_error(atlon, atlat, arlon, arlat, year, month, day,
                             UT, F107, nelem=50, device=None):
    """Mean % foF2 deviation along each T-R great circle vs its midpoint.

    API-parity with ref :2866-3006 (geometry identical; foF2 from the
    analytic climatology instead of PyIRI). Returns (mean_error [%],
    {"fo": F2_mid}) as tensors.
    """
    atlon, atlat, arlon, arlat = (torch.atleast_1d(t) for t in as_tensors(
        atlon, atlat, arlon, arlat, device=device))
    gcd_deg = calculate_gcd(atlon, atlat, arlon, arlat)
    re = earth_radius_at_latitude(atlat)
    r_loc = (gcd_deg * _DEG2RAD) * re
    az = azimuth_between_points(atlon, atlat, arlon, arlat)

    from .oblique import _linspace
    lims, _ = as_tensors([0.0, 1.0], atlon)
    frac = _linspace(lims[0], lims[1], int(nelem))
    agcd = r_loc[:, None] * frac[None, :]
    alat, alon = great_circle_point(atlat[:, None], atlon[:, None], agcd,
                                    az[:, None])
    mlat, mlon = great_circle_point(atlat[:, None], atlon[:, None],
                                    r_loc[:, None] / 2.0, az[:, None])

    F2, _, _ = climatology_parameters(year, month, day, UT,
                                      alat.reshape(-1), alon.reshape(-1),
                                      F107)
    F2m, _, _ = climatology_parameters(year, month, day, UT,
                                       mlat.reshape(-1), mlon.reshape(-1),
                                       F107)
    fo = F2["fo"].reshape(alat.shape)
    fo_mid = F2m["fo"].reshape(mlat.shape)[:, 0]
    per_err = (fo - fo_mid[:, None]) / fo_mid[:, None] * 100.0
    return per_err.mean(dim=1), {"fo": fo_mid}
