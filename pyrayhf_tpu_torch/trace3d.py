"""3-D magnetoionic ray tracing over (alt, lat, lon) fields.

Port of ``pyrayhf_tpu.trace3d`` (capability beyond the reference, whose
most general tracer is the 2-D great-circle slice, ref
``library.py:2128-2337``): rays through a full electron-density volume
Ne(alt, lat, lon), with the horizontal gradients that deflect them off the
launch great circle.

* μ, μ' and κ are precomputed once per frequency on the (alt, lat, lon)
  grid with the fixed vertical-incidence ψ of each column, as the 2-D
  tracers and the reference do (:func:`build_field_3d`; a frequency stack
  in :func:`build_field_3d_batch`);
* the ray state is Cartesian ECEF [x, y, z, vx, vy, vz] (km, unit v) and
  the RHS is the Haselgrove form dv/ds = (∇μ − (∇μ·v)v)/μ, with ∇μ from
  the grid gradients by the spherical chain rule; μ and the three
  gradient channels come from ONE 8-corner row gather of a packed
  [na·nb·nc, 4] table (:func:`_trilinear_pack`);
* the rays of a fan (and of a whole ionogram sweep, each ray carrying the
  index of its frequency as a frozen 7th channel) advance together in the
  fixed-step RK4 of :func:`pyrayhf_tpu_torch.gradient._integrate_fan`,
  which stops once every ray is frozen; ground bounces mirror about the
  LOCAL vertical.

The cell locate of each axis is decided once per launch on the host, from
host copies of the grids: index arithmetic on a uniform axis, a binary
search otherwise (never a device-to-host read inside the RHS).

Spherical Earth of radius ``R_E``; longitudes must form a contiguous
monotone window. Fields are dicts of tensors; the tracers run where the
field lies. Host data given to the builders goes to the CUDA card unless
``device="cpu"``. Forward-mode AD of the tracers is not supported (no JAX
test or caller uses it).
"""

import functools
import math

import numpy as np
import torch

from ._util import as_tensors, host_f64
from .constants import C_KM_S, R_E
from .fields import grad_axis_ord2, uniform_axis
from .gradient import (_STATUS, _integrate, _integrate_adaptive,
                       _integrate_fan)
from .magnetoionic import find_mu_mup, find_X, find_Y

__all__ = ["build_field_3d", "build_field_3d_batch", "home_ray_3d",
           "synthesize_oblique_ionogram_3d", "trace_ray_3d",
           "trace_rays_3d", "trilinear"]

_DEG2RAD = math.pi / 180.0
_RAD2DEG = 180.0 / math.pi
_NAN = float("nan")
# corner offsets of the flat rows, da major, then db, then dc
_CORNERS = [(da, db, dc) for da in (0, 1) for db in (0, 1) for dc in (0, 1)]


def _uniform_locate_params(grid):
    """(origin, inv_spacing) if the axis ``grid`` is uniform, else None.

    A host decision on a float64 host copy of the grid (the tolerance of
    :func:`pyrayhf_tpu_torch.fields.uniform_axis`, which also accepts
    f32-quantized linspace axes).
    """
    g = host_f64(grid)
    if not uniform_axis(g):
        return None
    return float(g[0]), float((g.size - 1) / (g[-1] - g[0]))


def _locate_params(*grids):
    """:func:`_uniform_locate_params` of each axis: decided once a launch."""
    return tuple(_uniform_locate_params(g) for g in grids)


def _locate(q, grid, n, up):
    """(cell index [int64], fractional offset) of query ``q`` on ``grid``
    [n]. ``up``: the axis' (origin, inv_spacing) when uniform (a NaN
    query then lands in cell 0), else None (binary search)."""
    if up is not None:
        o, inv_d = up
        f = (q - o) * inv_d
        f = torch.where(torch.isnan(f), 0.0, f)
        i_f = torch.clamp(torch.floor(f), 0, n - 2)
        return i_f.to(torch.int64), f - i_f
    i = torch.searchsorted(grid.contiguous(), q.contiguous(), right=True)
    i = torch.clamp(i - 1, 0, n - 2)
    return i, (q - grid[i]) / (grid[i + 1] - grid[i])


def _inside(aq, bq, cq, a_grid, b_grid, c_grid):
    return ((aq >= a_grid[0]) & (aq <= a_grid[-1])
            & (bq >= b_grid[0]) & (bq <= b_grid[-1])
            & (cq >= c_grid[0]) & (cq <= c_grid[-1]))


def trilinear(aq, bq, cq, a_grid, b_grid, c_grid, field, fill_value=_NAN,
              device=None):
    """Trilinear interpolation of ``field[na, nb, nc]`` at (aq, bq, cq).

    Out-of-domain queries return ``fill_value``. Query shapes broadcast.
    Uniform axes take index arithmetic, others a binary search.
    """
    aq, bq, cq, a_grid, b_grid, c_grid, field = as_tensors(
        aq, bq, cq, a_grid, b_grid, c_grid, field, device=device)
    aq, bq, cq = torch.broadcast_tensors(aq, bq, cq)
    na, nb, nc = field.shape
    ups = _locate_params(a_grid, b_grid, c_grid)
    ia, ta = _locate(aq, a_grid, na, ups[0])
    ib, tb = _locate(bq, b_grid, nb, ups[1])
    ic, tc = _locate(cq, c_grid, nc, ups[2])
    out = torch.zeros_like(aq)
    for da, wa in ((0, 1.0 - ta), (1, ta)):
        for db, wb in ((0, 1.0 - tb), (1, tb)):
            for dc, wc in ((0, 1.0 - tc), (1, tc)):
                out = out + wa * wb * wc * field[ia + da, ib + db, ic + dc]
    return torch.where(_inside(aq, bq, cq, a_grid, b_grid, c_grid), out,
                       fill_value)


def _corner_rows(aq, bq, cq, a_grid, b_grid, c_grid, na, nb, nc, ups):
    """(flat corner rows [..., 8] int64, trilinear weights [..., 8],
    inside [...]) of queries [...]; ``ups`` from :func:`_locate_params`."""
    ia, ta = _locate(aq, a_grid, na, ups[0])
    ib, tb = _locate(bq, b_grid, nb, ups[1])
    ic, tc = _locate(cq, c_grid, nc, ups[2])
    base = (ia * nb + ib) * nc + ic
    off = _corner_offsets(nb, nc, base.device)
    wa = torch.stack([1.0 - ta, ta], dim=-1)
    wb = torch.stack([1.0 - tb, tb], dim=-1)
    wc = torch.stack([1.0 - tc, tc], dim=-1)
    w = (wa[..., :, None, None] * wb[..., None, :, None]
         * wc[..., None, None, :]).flatten(-3)
    return (base[..., None] + off, w,
            _inside(aq, bq, cq, a_grid, b_grid, c_grid))


@functools.lru_cache(maxsize=64)
def _corner_offsets(nb, nc, device):
    """The 8 corners' row offsets, made once per (nb, nc, device): a
    tensor built from a list each call is a host-to-device copy, which
    makes the host wait for the card inside every RHS."""
    with torch.inference_mode(False):
        return torch.tensor([(da * nb + db) * nc + dc
                             for da, db, dc in _CORNERS],
                            dtype=torch.int64, device=device)


def _trilinear_pack(aq, bq, cq, a_grid, b_grid, c_grid, pack, ups=None):
    """All-channel trilinear fetch: one (8 corners × C channels) row
    gather per query. ``pack``: channel-stacked volume [na, nb, nc, C].
    Returns (vals [..., C], inside [...]); callers apply their own
    out-of-domain fills."""
    na, nb, nc, C = pack.shape
    if ups is None:
        ups = _locate_params(a_grid, b_grid, c_grid)
    rows, w, inside = _corner_rows(aq, bq, cq, a_grid, b_grid, c_grid,
                                   na, nb, nc, ups)
    blk = pack.reshape(-1, C)[rows]                        # [..., 8, C]
    return (w[..., None] * blk).sum(-2), inside


def _validate_grids_3d(alt_km, lat_deg, lon_deg, Ne, device=None,
                       others=()):
    """Host-side grid validation shared by the 3-D field builders;
    returns (alt, lat, lon, Ne) as tensors of one dtype and device (that
    of any tensor among them or ``others``, else ``device``)."""
    if device is None:
        device = next((t.device for t in (alt_km, lat_deg, lon_deg, Ne)
                       + tuple(others) if isinstance(t, torch.Tensor)),
                      None)
    alt, lat, lon, Ne = as_tensors(alt_km, lat_deg, lon_deg, Ne,
                                   device=device)
    if tuple(Ne.shape) != (alt.numel(), lat.numel(), lon.numel()):
        raise ValueError(
            f"Ne shape {tuple(Ne.shape)} != (N_alt, N_lat, N_lon) = "
            f"({alt.numel()}, {lat.numel()}, {lon.numel()})")
    for name, g in (("alt_km", alt), ("lat_deg", lat), ("lon_deg", lon)):
        if not bool(np.all(np.diff(host_f64(g)) > 0)):
            raise ValueError(
                f"{name} must be strictly ascending (searchsorted-based "
                "trilinear interpolation; flip descending datasets with "
                "[::-1] on the grid and the matching field axis)")
    return alt, lat, lon, Ne


def _field_volumes(Ne, Babs, bpsi, f0_Hz, mode, nu_a, alt, lat_r, lon_r):
    """μ/μ'/κ volume + grid gradients for ONE frequency."""
    from .absorption import absorption_coefficient

    X = find_X(Ne, f0_Hz)
    Y = find_Y(f0_Hz, Babs)
    mu, mup = find_mu_mup(X, Y, bpsi, mode)
    mu = torch.where(torch.isfinite(mu) & (mu > 0.0), mu, _NAN)
    mup = torch.where(torch.isfinite(mup) & (mup > 0.0), mup, _NAN)
    kappa = absorption_coefficient(Ne, nu_a[:, None, None], f0_Hz, Babs,
                                   bpsi, mu, mode)
    kappa = torch.where(torch.isfinite(kappa), kappa, 0.0)
    # gradients per km / per RADIAN of lat / per RADIAN of lon
    return {"mu": mu, "mup": mup, "kappa": kappa,
            "dmu_dalt": grad_axis_ord2(mu, alt, 0),
            "dmu_dlat": grad_axis_ord2(mu, lat_r, 1),
            "dmu_dlon": grad_axis_ord2(mu, lon_r, 2)}


def _field_inputs(alt_km, lat_deg, lon_deg, Ne, Babs, bpsi, nu, device):
    from .absorption import collision_frequency

    alt, lat, lon, Ne = _validate_grids_3d(alt_km, lat_deg, lon_deg, Ne,
                                           device, (Babs, bpsi, nu))
    Babs, bpsi = (torch.broadcast_to(t, Ne.shape) for t in as_tensors(
        Babs, bpsi, Ne, dtype=Ne.dtype)[:2])
    nu_a = (collision_frequency(alt) if nu is None
            else as_tensors(nu, Ne, dtype=Ne.dtype)[0])
    return alt, lat, lon, Ne, Babs, bpsi, nu_a


def build_field_3d(alt_km, lat_deg, lon_deg, Ne, Babs, bpsi, f0_Hz,
                   mode="O", nu=None, device=None):
    """Precompute the μ/μ'/κ volume and its grid gradients for one
    frequency.

    ``Ne``/``Babs``/``bpsi``: [N_alt, N_lat, N_lon] on the ascending grids
    ``alt_km``/``lat_deg``/``lon_deg`` (e.g. from
    :func:`pyrayhf_tpu_torch.envgen.generate_input_3D`). Returns the field
    dict :func:`trace_ray_3d` takes. ψ is the vertical-incidence magnetic
    angle per column, as the 2-D builders (ref ``library.py:1764-1835``).
    ``nu``: ν(alt) [s⁻¹] for the absorption channel (default model).
    """
    alt, lat, lon, Ne, Babs, bpsi, nu_a = _field_inputs(
        alt_km, lat_deg, lon_deg, Ne, Babs, bpsi, nu, device)
    out = _field_volumes(Ne, Babs, bpsi, float(f0_Hz), mode, nu_a, alt,
                         lat * _DEG2RAD, lon * _DEG2RAD)
    out.update(alt=alt, lat=lat, lon=lon)
    return out


def build_field_3d_batch(alt_km, lat_deg, lon_deg, Ne, Babs, bpsi,
                         f0s_hz, mode="O", nu=None,
                         hbm_budget_bytes=8 << 30, device=None):
    """Stacked μ/μ'/κ volumes [F, N_alt, N_lat, N_lon] of a frequency
    batch; the grids stay unbatched.

    The six stacked volumes cost ``6 · F · N_alt · N_lat · N_lon`` values
    of device memory; a request beyond ``hbm_budget_bytes`` raises with
    chunking advice instead of running out of memory. Each frequency is
    :func:`build_field_3d`'s volumes, written into the stack.
    """
    alt, lat, lon, Ne, Babs, bpsi, nu_a = _field_inputs(
        alt_km, lat_deg, lon_deg, Ne, Babs, bpsi, nu, device)
    f0s = np.atleast_1d(host_f64(f0s_hz))
    need = 6 * int(f0s.size) * int(Ne.numel()) * Ne.element_size()
    if need > hbm_budget_bytes:
        raise ValueError(
            f"stacked field volumes need {need / 2**30:.1f} GiB "
            f"(> budget {hbm_budget_bytes / 2**30:.1f} GiB); chunk the "
            f"frequency axis (e.g. synthesize_oblique_ionogram_3d("
            f"freq_chunk=...)) or raise hbm_budget_bytes")
    lat_r, lon_r = lat * _DEG2RAD, lon * _DEG2RAD
    out = None
    for i, f0 in enumerate(f0s):
        one = _field_volumes(Ne, Babs, bpsi, float(f0), mode, nu_a, alt,
                             lat_r, lon_r)
        if out is None:
            out = {k: v.new_empty((f0s.size,) + tuple(v.shape))
                   for k, v in one.items()}
        for k, v in one.items():
            out[k][i] = v
        del one
    out.update(alt=alt, lat=lat, lon=lon)
    return out


def _norm3(p):
    """|p| over the last axis of 3 (squares summed in order)."""
    return torch.sqrt(p[..., 0] * p[..., 0] + p[..., 1] * p[..., 1]
                      + p[..., 2] * p[..., 2])


def _dot3(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] \
        + a[..., 2] * b[..., 2]


def _ecef(lat_rad, lon_rad, r_km):
    cl = torch.cos(lat_rad)
    return r_km * torch.stack([cl * torch.cos(lon_rad),
                               cl * torch.sin(lon_rad),
                               torch.sin(lat_rad)], dim=-1)


def _geodetic(p):
    """ECEF [..., 3] → (r, lat_rad, lon_rad); spherical Earth."""
    r = _norm3(p)
    lat = torch.arcsin(torch.clamp(p[..., 2] / r, -1.0, 1.0))
    lon = torch.arctan2(p[..., 1], p[..., 0])
    return r, lat, lon


def _local_frame(lat, lon):
    """(r̂, ê_north, ê_east) unit vectors [..., 3] at (lat, lon) [rad]."""
    sl, cl = torch.sin(lat), torch.cos(lat)
    so, co = torch.sin(lon), torch.cos(lon)
    rhat = torch.stack([cl * co, cl * so, sl], dim=-1)
    north = torch.stack([-sl * co, -sl * so, cl], dim=-1)
    east = torch.stack([-so, co, torch.zeros_like(so)], dim=-1)
    return rhat, north, east


def _bearing_frame(lat, lon, az):
    """(r̂₀, d̂₀, n̂) at a point for bearing ``az`` [all rad].

    n̂ = d̂₀ × r̂₀ is unit-norm and points to the RIGHT of the bearing
    (east when heading north) — the sign of every cross-track output.
    """
    rhat, north, east = _local_frame(lat, lon)
    az = az[..., None]
    d0 = torch.cos(az) * north + torch.sin(az) * east
    nhat = torch.linalg.cross(d0, torch.broadcast_to(rhat, d0.shape),
                              dim=-1)
    return rhat, d0, nhat / _norm3(nhat)[..., None]


def _ray_funcs(field, z_ground, multi):
    """(rhs_with_freespace, events, reflect) over a field: one frequency
    (state [..., 6]) or a frequency stack (``multi``: state [..., 7], the
    7th channel the frequency index)."""
    alt_g, lat_g, lon_g = field["alt"], field["lat"], field["lon"]
    na, nb, nc = alt_g.numel(), lat_g.numel(), lon_g.numel()
    vol = na * nb * nc
    ups = _locate_params(alt_g, lat_g, lon_g)
    # μ + the three grid-gradient channels ride ONE 8-corner row gather
    table = torch.stack([field["mu"], field["dmu_dalt"], field["dmu_dlat"],
                         field["dmu_dlon"]], dim=-1).reshape(-1, 4)
    extra = 1 if multi else 0

    def rhs(y):
        p, v = y[..., :3], y[..., 3:6]
        r, lat, lon = _geodetic(p)
        alt = r - R_E
        latd, lond = lat * _RAD2DEG, lon * _RAD2DEG
        rows, w, inside = _corner_rows(alt, latd, lond, alt_g, lat_g,
                                       lon_g, na, nb, nc, ups)
        if multi:
            f_idx = torch.round(y[..., 6]).to(torch.int64)
            rows = rows + (f_idx * vol)[..., None]
        vals = (w[..., None] * table[rows]).sum(-2)
        mu = torch.where(inside, vals[..., 0], _NAN)
        g = torch.where(inside[..., None], vals[..., 1:], 0.0)
        rhat, north, east = _local_frame(lat, lon)
        cl = torch.clamp(torch.cos(lat), min=1e-9)
        grad = (g[..., 0:1] * rhat + (g[..., 1] / r)[..., None] * north
                + (g[..., 2] / (r * cl))[..., None] * east)
        ok = (torch.isfinite(mu) & (mu > 0.0)
              & torch.isfinite(grad).all(dim=-1))
        mu_s = torch.where(ok, mu, 1.0)
        gdv = _dot3(grad, v)
        dv = (grad - gdv[..., None] * v) / mu_s[..., None]
        out = torch.cat([v, dv] + ([torch.zeros_like(dv[..., :1])]
                                   if multi else []), dim=-1)
        return torch.where(ok[..., None], out, 0.0)

    # free space below the field's bottom altitude: rays fly straight
    # (∇μ = 0, μ = 1) until they enter the grid
    alt_bot = alt_g[0]

    def rhs_with_freespace(y):
        below = (_norm3(y[..., :3]) - R_E) < alt_bot
        straight = torch.cat([y[..., 3:6],
                              torch.zeros_like(y[..., :3 + extra])], dim=-1)
        return torch.where(below[..., None], straight, rhs(y))

    def events(y):
        r, lat, lon = _geodetic(y[..., :3])
        latd, lond = lat * _RAD2DEG, lon * _RAD2DEG
        return torch.stack([
            r - (R_E + z_ground) - 1e-3,      # ground (index 0)
            (R_E + alt_g[-1]) - r,            # top
            latd - lat_g[0], lat_g[-1] - latd,
            lond - lon_g[0], lon_g[-1] - lond,
        ], dim=-1)

    def reflect(y):
        p, v = y[..., :3], y[..., 3:6]
        rhat = p / _norm3(p)[..., None]
        vr = _dot3(v, rhat)
        v_new = v - 2.0 * torch.clamp(vr, max=0.0)[..., None] * rhat
        return torch.cat([p, v_new, y[..., 6:]], dim=-1)

    return rhs_with_freespace, events, reflect


def _ray_funcs_3d(field, z_ground):
    """(rhs_with_freespace, events, reflect) closures over one field,
    shared by the per-ray and the fan cores."""
    return _ray_funcs(field, z_ground, False)


def _ray_funcs_3d_mf(field_b, z_ground):
    """(rhs, events, reflect) over a FREQUENCY-STACKED fixed-ψ field
    (:func:`build_field_3d_batch`): the state grows a frozen 7th channel,
    the ray's frequency index into the stack (the event backtrack is
    linear, so it is kept exactly), which offsets the corner rows into one
    flat [F·na·nb·nc, 4] table. Step math per ray is that of
    :func:`_ray_funcs_3d` on the matching field slice."""
    return _ray_funcs(field_b, z_ground, True)


def _launch_state_3d(lat0_deg, lon0_deg, elevation_deg, azimuth_deg,
                     z_ground):
    """ECEF [..., 6] launch states of fan rays (elevation/azimuth [...])."""
    lat0 = lat0_deg * _DEG2RAD
    lon0 = lon0_deg * _DEG2RAD
    p0 = _ecef(lat0, lon0, R_E + z_ground + 1e-2)
    rhat0, north0, east0 = _local_frame(lat0, lon0)
    el = (elevation_deg * _DEG2RAD)[..., None]
    az = (azimuth_deg * _DEG2RAD)[..., None]
    v0 = (torch.sin(el) * rhat0
          + torch.cos(el) * (torch.cos(az) * north0
                             + torch.sin(az) * east0))
    return torch.cat([torch.broadcast_to(p0, v0.shape), v0], dim=-1)


def _nanmax(x):
    """``jnp.nanmax`` over the last axis."""
    nan = torch.isnan(x)
    m = torch.where(nan, -math.inf, x).amax(dim=-1)
    return torch.where(nan.all(dim=-1), _NAN, m)


def _landing(lat0, lon0, az, p_end, r_end, status):
    """Landing geometry (spherical): great-circle range and signed
    cross-track of the end point relative to the launch great circle."""
    rhat0 = _local_frame(lat0, lon0)[0]
    rhat_end = p_end / r_end[..., None]
    cosc = torch.clamp(_dot3(rhat0, rhat_end), -1.0, 1.0)
    ground_range = R_E * torch.arccos(cosc)
    _, _, nhat = _bearing_frame(lat0, lon0, az)
    cross_track = R_E * torch.arcsin(
        torch.clamp(_dot3(rhat_end, nhat), -1.0, 1.0))
    landed = status == _STATUS["ground"]
    return (torch.where(landed, ground_range, _NAN),
            torch.where(landed, cross_track, _NAN), landed)


def _path_products_3d(field, lat0_deg, lon0_deg, azimuth_deg, ys, alive,
                      status, mid_tables=None, row_offset=0, paths=True):
    """Path channels, integrals and landing geometry of traced rays.

    ``ys`` [..., n_steps+1, ≥6]; ``azimuth_deg``/``status`` [...].
    ``mid_tables``/``row_offset``: the frequency-batched fan passes the
    three FLAT [F·na·nb·nc] (μ′, μ, κ) tables and each ray's
    ``f_idx · na·nb·nc`` offset [...]. The quadrature reads the 8 corners
    as separate 1-D gathers at the segment midpoints. ``paths=False``
    leaves out the per-step channels (the ionogram keeps only scalars).
    """
    alt_g, lat_g, lon_g = field["alt"], field["lat"], field["lon"]
    alt_bot = alt_g[0]
    lat0 = lat0_deg * _DEG2RAD
    lon0 = lon0_deg * _DEG2RAD
    az = azimuth_deg * _DEG2RAD

    p_path = ys[..., :3]
    r_path, lat_path, lon_path = _geodetic(p_path)
    alt_path = r_path - R_E

    d = torch.diff(p_path, dim=-2)
    dseg = _norm3(d)
    pm = 0.5 * (p_path[..., :-1, :] + p_path[..., 1:, :])
    rm, latm, lonm = _geodetic(pm)
    latd_m, lond_m = latm * _RAD2DEG, lonm * _RAD2DEG
    alt_m = rm - R_E
    # below the grid: free space (μ = μ' = 1, κ = 0)
    below = alt_m < alt_bot
    if mid_tables is None:
        mid_tables = (field["mup"].reshape(-1), field["mu"].reshape(-1),
                      field["kappa"].reshape(-1))
    na, nb, nc = alt_g.numel(), lat_g.numel(), lon_g.numel()
    ups = _locate_params(alt_g, lat_g, lon_g)
    ia, ta = _locate(alt_m, alt_g, na, ups[0])
    ib, tb = _locate(latd_m, lat_g, nb, ups[1])
    ic, tc = _locate(lond_m, lon_g, nc, ups[2])
    if isinstance(row_offset, torch.Tensor):
        row_offset = row_offset[..., None]
    base = row_offset + (ia * nb + ib) * nc + ic
    acc = [torch.zeros_like(ta)] * 3
    for da, db, dc in _CORNERS:
        rows = base + (da * nb + db) * nc + dc
        w = ((ta if da else 1.0 - ta) * (tb if db else 1.0 - tb)
             * (tc if dc else 1.0 - tc))
        acc = [a + w * t[rows] for a, t in zip(acc, mid_tables)]
    in_m = _inside(alt_m, latd_m, lond_m, alt_g, lat_g, lon_g)
    mup_m = torch.where(below, 1.0, torch.where(in_m, acc[0], _NAN))
    mu_m = torch.where(below, 1.0, torch.where(in_m, acc[1], _NAN))
    kap_m = torch.where(below, 0.0, torch.where(in_m, acc[2], 0.0))
    vfin = torch.isfinite(mup_m)
    group_path = torch.nansum(dseg, dim=-1)
    group_delay = torch.nansum(
        torch.where(vfin, mup_m / C_KM_S * dseg, 0.0), dim=-1)
    phase_path = torch.nansum(
        torch.where(torch.isfinite(mu_m), mu_m * dseg, 0.0), dim=-1)
    absorb = torch.nansum(
        torch.where(torch.isfinite(kap_m), kap_m * dseg, 0.0), dim=-1)

    ground_range, cross_track, landed = _landing(
        lat0, lon0, az, p_path[..., -1, :], r_path[..., -1], status)
    out = {}
    if paths:
        out.update({"lat": lat_path * _RAD2DEG, "lon": lon_path * _RAD2DEG,
                    "alt": alt_path, "ecef": p_path, "alive": alive})
    out.update({
        "status_code": status,
        "group_path_km": group_path, "group_delay_sec": group_delay,
        "phase_path_km": phase_path, "absorption_db": absorb,
        "apex_alt_km": _nanmax(alt_path),
        "ground_range_km": ground_range,
        "cross_track_km": cross_track,
        "landing_lat_deg": torch.where(landed,
                                       lat_path[..., -1] * _RAD2DEG, _NAN),
        "landing_lon_deg": torch.where(landed,
                                       lon_path[..., -1] * _RAD2DEG, _NAN),
    })
    return out


def _field_tensor(field):
    """The tensor whose dtype and device a field's launches take."""
    for k in ("mu", "tables"):
        if k in field:
            t = field[k]
            return t[3] if isinstance(t, (tuple, list)) else t
    return field["alt"]


def _like(field, *xs):
    """Launch parameters as tensors in the field's dtype, on its device."""
    t = _field_tensor(field)
    return as_tensors(*xs, t, dtype=t.dtype)[:len(xs)]


def _grad_mode(*ts):
    """Autograd on only where an input carries a gradient: forward-only
    traces write their path into a buffer allocated once."""
    return torch.set_grad_enabled(torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in ts))


def _field_leaves(field):
    out = []
    for v in field.values():
        out.extend(v if isinstance(v, (tuple, list)) else [v])
    return out


def _trace3d_core(field, lat0_deg, lon0_deg, elevation_deg, azimuth_deg,
                  ds, n_steps, z_ground, n_hops=1, adaptive=False,
                  rtol=1e-7, atol=1e-9, s_max=None, h_max=None,
                  early_exit=False):
    rhs_with_freespace, events, reflect = _ray_funcs_3d(field, z_ground)
    y0 = _launch_state_3d(lat0_deg, lon0_deg, elevation_deg, azimuth_deg,
                          z_ground)
    hop_kw = dict(reflect_fn=reflect, max_bounces=n_hops - 1) \
        if n_hops > 1 else {}
    if adaptive:
        ys, alive, status = _integrate_adaptive(
            rhs_with_freespace, y0, n_steps, s_max, ds, rtol, atol, h_max,
            events, v_slice=slice(3, 6), early_exit=early_exit, **hop_kw)
    else:
        ys, alive, status = _integrate(rhs_with_freespace, y0, n_steps, ds,
                                       events, v_slice=slice(3, 6),
                                       early_exit=early_exit, **hop_kw)
    return _path_products_3d(field, lat0_deg, lon0_deg, azimuth_deg, ys,
                             alive, status)


def _fan_rays(els, azs, *lead):
    """Flat (lead..., elevation, azimuth) meshgrid of a fan [R]."""
    grids = torch.meshgrid(*lead, els, azs, indexing="ij")
    return [g.reshape(-1) for g in grids]


def _trace3d_fan_core(field, lat0_deg, lon0_deg, els, azs, ds, n_steps,
                      z_ground, n_hops=1, chunk=125, early_exit=True):
    """The [E, A] fan as one batched integration that stops once every
    ray is frozen (checked every ``chunk`` steps)."""
    rhs_with_freespace, events, reflect = _ray_funcs_3d(field, z_ground)
    elf, azf = _fan_rays(els, azs)
    y0b = _launch_state_3d(lat0_deg, lon0_deg, elf, azf, z_ground)
    hop_kw = dict(reflect_fn=reflect, max_bounces=n_hops - 1) \
        if n_hops > 1 else {}
    if early_exit:
        ys, alive, status = _integrate_fan(rhs_with_freespace, y0b, n_steps,
                                           ds, events, v_slice=slice(3, 6),
                                           chunk=chunk, **hop_kw)
    else:
        ys, alive, status = _integrate(rhs_with_freespace, y0b, n_steps, ds,
                                       events, v_slice=slice(3, 6),
                                       early_exit=False, **hop_kw)
    out = _path_products_3d(field, lat0_deg, lon0_deg, azf, ys, alive,
                            status)
    E, A = els.numel(), azs.numel()
    return {k: v.reshape((E, A) + tuple(v.shape[1:]))
            for k, v in out.items()}


def _ionogram3d_fan_core(field_b, lat0_deg, lon0_deg, els, azs, ds,
                         n_steps, z_ground, n_hops=1, chunk=125):
    """[F, E, A] fixed-ψ sweep fan: every frequency's rays in ONE loop.

    Each ray carries its frequency index into the [F, …] stack as a frozen
    state channel, so the sweep pays for its single longest-lived ray.
    Only per-ray scalars are kept: the path buffer is released once they
    are computed.
    """
    rhs_fs, events, reflect = _ray_funcs_3d_mf(field_b, z_ground)
    F = field_b["mu"].shape[0]
    vol = field_b["mu"][0].numel()
    ff, elf, azf = _fan_rays(els, azs, torch.arange(
        F, dtype=els.dtype, device=els.device))
    y0b = _launch_state_3d(lat0_deg, lon0_deg, elf, azf, z_ground)
    y0b = torch.cat([y0b, ff[:, None]], dim=1)
    hop_kw = dict(reflect_fn=reflect, max_bounces=n_hops - 1) \
        if n_hops > 1 else {}
    ys, alive, status = _integrate_fan(rhs_fs, y0b, n_steps, ds, events,
                                       v_slice=slice(3, 6), chunk=chunk,
                                       **hop_kw)
    mid_tables = (field_b["mup"].reshape(-1), field_b["mu"].reshape(-1),
                  field_b["kappa"].reshape(-1))
    out = _path_products_3d(field_b, lat0_deg, lon0_deg, azf, ys, alive,
                            status, mid_tables=mid_tables,
                            row_offset=torch.round(ff).to(torch.int64) * vol,
                            paths=False)
    del ys, alive
    E, A = els.numel(), azs.numel()
    return {k: v.reshape((F, E, A) + tuple(v.shape[1:]))
            for k, v in out.items()}


def _with_status(out):
    code = int(out.pop("status_code"))
    out["status"] = {v: k for k, v in _STATUS.items()}[code]
    return out


def trace_ray_3d(field, lat0_deg, lon0_deg, elevation_deg, azimuth_deg, *,
                 step_km=1.0, s_max_km=6000.0, z_ground_km=0.0, n_hops=1,
                 rtol=None, atol=None, max_step_km=None, early_exit=True):
    """Trace one ray through a 3-D field (see :func:`build_field_3d`).

    Launches from (``lat0_deg``, ``lon0_deg``) at ``z_ground_km`` toward
    ``azimuth_deg`` (deg east of north) at ``elevation_deg``; fixed-step
    RK4 of ``step_km``. Returns the (lat, lon, alt) path, ``status``
    (ground/domain/length), group/phase path metrics, absorption and the
    landing geometry: ``ground_range_km`` (great circle) and
    ``cross_track_km``, the signed offset from the launch great circle
    (positive to the right of the launch azimuth). ``n_hops``: specular
    bounces about the local vertical. ``rtol``/``atol``: the
    error-controlled Dormand–Prince 5(4) integrator (``step_km`` the
    initial step, ``max_step_km`` the cap; 'attempts' status when the
    budget runs out). ``early_exit``: stop once the ray is frozen (same
    outputs). Tensors lie on the field's device.
    """
    lat0, lon0, el, az, ds, zg = _like(field, lat0_deg, lon0_deg,
                                       elevation_deg, azimuth_deg, step_km,
                                       z_ground_km)
    if rtol is not None or atol is not None:
        n_steps = 2 * int(round(float(s_max_km) / float(step_km)))
        kw = dict(adaptive=True, rtol=1e-7 if rtol is None else float(rtol),
                  atol=1e-9 if atol is None else float(atol),
                  s_max=float(s_max_km),
                  h_max=(math.inf if max_step_km is None
                         else float(max_step_km)))
    else:
        n_steps = int(round(float(s_max_km) / float(step_km)))
        kw = {}
    with _grad_mode(*_field_leaves(field), lat0, lon0, el, az):
        out = _trace3d_core(field, lat0, lon0, el, az, ds, n_steps, zg,
                            n_hops=int(n_hops), early_exit=bool(early_exit),
                            **kw)
    return _with_status(out)


def trace_rays_3d(field, lat0_deg, lon0_deg, elevation_deg, azimuth_deg, *,
                  step_km=1.0, s_max_km=6000.0, z_ground_km=0.0, n_hops=1,
                  early_exit=True):
    """Batched fan: elevation [E] × azimuth [A] → dict of [E, A, ...].

    The whole solid-angle fan advances together; ``early_exit=True``
    (default) stops once every ray has frozen (same results: the rows
    left repeat each ray's final state).
    """
    n_steps = int(round(float(s_max_km) / float(step_km)))
    lat0, lon0, els, azs, ds, zg = _like(field, lat0_deg, lon0_deg,
                                         elevation_deg, azimuth_deg,
                                         step_km, z_ground_km)
    with _grad_mode(*_field_leaves(field), lat0, lon0, els, azs):
        return _trace3d_fan_core(field, lat0, lon0, els.reshape(-1),
                                 azs.reshape(-1), ds, n_steps, zg,
                                 n_hops=int(n_hops),
                                 early_exit=bool(early_exit))


def home_ray_3d(field, tx_lat, tx_lon, rx_lat, rx_lon, *, n_elev=48,
                n_az=9, az_span_deg=8.0, elev_min_deg=5.0,
                elev_max_deg=75.0, step_km=2.0, s_max_km=4000.0,
                n_hops=1, max_range_jump_km=200.0,
                max_miss_jump_km=None):
    """Point-to-point homing THROUGH a 3-D volume, with azimuth correction.

    An (elevation × azimuth) fan around the great-circle bearing traces in
    one batch; each azimuth column is homed in range (low/high rays) and
    the signed landing miss (cross-track relative to the receiver bearing)
    is interpolated to zero across azimuth. Returns ``delay_low/high_sec``,
    ``elev_low/high_deg``, ``azimuth_low/high_deg``,
    ``azimuth_offset_low/high_deg``, ``group_path_*``/``phase_path_*``/
    ``absorption_*`` and the link's bearing and distance; NaN when no fan
    ray closes the link. ``max_range_jump_km`` caps the range
    discontinuity the elevation stage interpolates across,
    ``max_miss_jump_km`` the miss discontinuity of the azimuth stage
    (default 3 × D·Δaz).
    """
    az0, D, els, azs, miss_cap = _home_setup(
        tx_lat, tx_lon, rx_lat, rx_lon, n_elev, n_az, az_span_deg,
        elev_min_deg, elev_max_deg, max_miss_jump_km,
        like=_field_tensor(field))
    out = _home_fan_core(field, tx_lat, tx_lon, az0, D, els, azs,
                         step_km=step_km, s_max_km=s_max_km,
                         n_hops=n_hops,
                         max_range_jump_km=max_range_jump_km,
                         miss_cap=miss_cap)
    out.update({"bearing_deg": az0, "range_km": D,
                "elevations_deg": els, "azimuths_deg": azs})
    return out


def _homed_sweep(fan_all, tx_lat, tx_lon, az0, D, els, azs, step_km,
                 s_max_km, n_hops, max_range_jump_km, miss_cap):
    """Both homing crossing stages over a PRE-TRACED [F, E, A] fan:
    every output gains the leading F axis."""
    return _home_fan_core(None, tx_lat, tx_lon, az0, D, els, azs,
                          step_km=step_km, s_max_km=s_max_km, n_hops=n_hops,
                          max_range_jump_km=max_range_jump_km,
                          miss_cap=miss_cap,
                          fan_fn=lambda *_args: fan_all)


def _home_setup(tx_lat, tx_lon, rx_lat, rx_lon, n_elev, n_az, az_span_deg,
                elev_min_deg, elev_max_deg, max_miss_jump_km, like=None):
    """Validate the fan request; return (az0, D, els, azs, miss_cap).

    Host-side and frequency-independent. ``els``/``azs`` are computed in
    float64 and then take ``like``'s dtype and device (CPU float64 by
    default).
    """
    from .geodesy import azimuth_between_points, calculate_gcd
    from .oblique import _linspace

    if int(n_az) < 3:
        raise ValueError("n_az must be >= 3 (the azimuth root-find needs "
                         "a bracketing fan; use the 2-D homing for a "
                         "fixed great-circle bearing)")
    if int(n_elev) < 4:
        raise ValueError("n_elev must be >= 4")
    cpu = torch.device("cpu")
    az0 = float(azimuth_between_points(tx_lon, tx_lat, rx_lon, rx_lat,
                                       device=cpu))
    D = float(calculate_gcd(tx_lon, tx_lat, rx_lon, rx_lat, device=cpu)
              * _DEG2RAD * R_E)
    lims = torch.tensor([float(elev_min_deg), float(elev_max_deg),
                         -float(az_span_deg), float(az_span_deg)],
                        dtype=torch.float64)
    els = _linspace(lims[0], lims[1], int(n_elev))
    azs = az0 + _linspace(lims[2], lims[3], int(n_az))
    if like is not None:
        els = els.to(dtype=like.dtype, device=like.device)
        azs = azs.to(dtype=like.dtype, device=like.device)
    # the azimuth-stage discontinuity cap lives on the miss channel's own
    # scale: 3× the smooth-family miss spacing between adjacent columns
    if max_miss_jump_km is None:
        daz = 2.0 * float(az_span_deg) / (int(n_az) - 1)
        miss_cap = 3.0 * D * (daz * _DEG2RAD)
    else:
        miss_cap = float(max_miss_jump_km)
    return az0, D, els, azs, miss_cap


def _home_fan_core(field, tx_lat, tx_lon, az0, D, els, azs, *, step_km,
                   s_max_km, n_hops, max_range_jump_km, miss_cap,
                   fan_fn=None, early_exit=True):
    """Homing body: fan trace + elevation & azimuth stages.

    Geometry arguments are Python scalars; a fan with leading dimensions
    (e.g. [F, E, A]) homes every leading entry at once. ``fan_fn(field,
    tx_lat, tx_lon, els, azs)`` overrides the fan tracer (default: the
    fixed-ψ :func:`trace_rays_3d`); the anisotropic homing passes its fan.
    """
    from .oblique import _crossings

    if fan_fn is None:
        fan = trace_rays_3d(field, tx_lat, tx_lon, els, azs,
                            step_km=step_km, s_max_km=s_max_km,
                            n_hops=n_hops, early_exit=early_exit)
    else:
        fan = fan_fn(field, tx_lat, tx_lon, els, azs)
    lat_l = fan["landing_lat_deg"]
    # re-reference every landing to the RECEIVER bearing so "miss" means
    # the same thing in all columns: the signed offset of the landing from
    # the tx→rx great circle
    geo = torch.tensor([float(tx_lat), float(tx_lon), float(az0)],
                       dtype=lat_l.dtype, device=lat_l.device) * _DEG2RAD
    _, _, nhat = _bearing_frame(geo[0], geo[1], geo[2])
    land = _ecef(lat_l * _DEG2RAD, fan["landing_lon_deg"] * _DEG2RAD, 1.0)
    miss = R_E * torch.arcsin(torch.clamp(_dot3(land, nhat), -1.0, 1.0))

    # per-azimuth elevation homing at range D (columns = azimuth)
    chord = 2.0 * R_E * math.sin(0.5 * D / R_E)
    delay_floor = chord / C_KM_S

    def columns(t):
        return t.transpose(-1, -2)                       # [..., A, E]

    chans = tuple(columns(fan[k]) for k in
                  ("group_delay_sec", "phase_path_km", "group_path_km",
                   "absorption_db")) + (columns(miss),)
    lo, hi = _crossings(columns(fan["ground_range_km"]), chans, els, D,
                        float(max_range_jump_km), delay_floor)
    out = {}
    for leg, vals in (("low", lo), ("high", hi)):
        delay, phase, path, absorb, m, elev, _ = vals
        # azimuth stage: the miss channel crosses zero; the guarded
        # crossing finder rejects a ray-family discontinuity (a miss jump
        # beyond the cap) instead of fabricating a solution
        sol, _ = _crossings(m, (delay, phase, path, absorb, elev), azs, 0.0,
                            float(miss_cap), delay_floor)
        s_delay, s_phase, s_path, s_absorb, s_elev, s_az, _ = sol
        out.update({f"delay_{leg}_sec": s_delay,
                    f"phase_path_{leg}_km": s_phase,
                    f"group_path_{leg}_km": s_path,
                    f"absorption_{leg}_db": s_absorb,
                    f"elev_{leg}_deg": s_elev,
                    f"azimuth_{leg}_deg": s_az,
                    f"azimuth_offset_{leg}_deg": s_az - az0})
    return out


def synthesize_oblique_ionogram_3d(f0s_hz, tx_lat, tx_lon, rx_lat, rx_lon,
                                   alt_km, lat_deg, lon_deg, Ne, Babs,
                                   bpsi, mode="O", nu=None, n_elev=48,
                                   n_az=9, az_span_deg=8.0,
                                   elev_min_deg=5.0, elev_max_deg=75.0,
                                   step_km=2.0, s_max_km=4000.0, n_hops=1,
                                   max_range_jump_km=200.0,
                                   max_miss_jump_km=None, freq_chunk=None,
                                   hbm_budget_bytes=8 << 30, device=None):
    """Oblique ionogram for a link THROUGH a 3-D volume.

    The 3-D member of the oblique-ionogram family: low/high-ray delay,
    elevation AND gradient-corrected launch bearing per frequency; fan and
    integration knobs as :func:`home_ray_3d`. The μ/μ'/κ volumes of every
    frequency of a chunk stack to [F, N_alt, N_lat, N_lon]
    (:func:`build_field_3d_batch`); the chunk's whole [F × E × A] ray
    budget integrates as one batched early-exit fan, each ray carrying its
    frequency index (:func:`_ionogram3d_fan_core`); both homing stages then
    run over the traced fan (:func:`_homed_sweep`). ``freq_chunk`` bounds
    the memory held by the stacked volumes: frequencies run in chunks of
    that size (the last padded with its last frequency). Returns stacked
    [N_freq] tensors plus the link geometry; NaN rows above the
    (azimuth-resolved) link MUF. Host data goes to the CUDA card unless
    ``device="cpu"``.
    """
    f0s = np.atleast_1d(host_f64(f0s_hz))
    alt, lat, lon, Ne = _validate_grids_3d(alt_km, lat_deg, lon_deg, Ne,
                                           device, (Babs, bpsi, nu))
    Babs, bpsi = as_tensors(Babs, bpsi, Ne, dtype=Ne.dtype)[:2]
    az0, D, els, azs, miss_cap = _home_setup(
        tx_lat, tx_lon, rx_lat, rx_lon, n_elev, n_az, az_span_deg,
        elev_min_deg, elev_max_deg, max_miss_jump_km, like=Ne)
    lat0, lon0, ds, zg = as_tensors(tx_lat, tx_lon, step_km, 0.0, Ne,
                                    dtype=Ne.dtype)[:4]

    n_steps = int(round(float(s_max_km) / float(step_km)))
    chunk = int(freq_chunk) if freq_chunk else f0s.size
    parts = []
    with _grad_mode(Ne, Babs, bpsi):
        for lo in range(0, f0s.size, chunk):
            sel = f0s[lo:lo + chunk]
            n_real = sel.size
            if n_real < chunk:  # pad with the last frequency
                sel = np.concatenate([sel, np.full(chunk - n_real, sel[-1])])
            field = build_field_3d_batch(alt, lat, lon, Ne, Babs, bpsi, sel,
                                         mode=mode, nu=nu,
                                         hbm_budget_bytes=hbm_budget_bytes)
            fan_all = _ionogram3d_fan_core(field, lat0, lon0, els, azs, ds,
                                           n_steps, zg, n_hops=int(n_hops))
            del field
            row = _homed_sweep(fan_all, float(tx_lat), float(tx_lon), az0,
                               D, els, azs, float(step_km), float(s_max_km),
                               int(n_hops), float(max_range_jump_km),
                               miss_cap)
            parts.append({k: v[:n_real] for k, v in row.items()})
    out = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
    out.update({"bearing_deg": az0, "range_km": D,
                "elevations_deg": els, "azimuths_deg": azs})
    return out
