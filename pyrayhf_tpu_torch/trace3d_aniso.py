"""Anisotropic 3-D magnetoionic ray tracing (full Haselgrove form).

Port of ``pyrayhf_tpu.trace3d_aniso``. The fixed-ψ tracers
(:mod:`pyrayhf_tpu_torch.trace3d`, and the reference's 2-D tracers, ref
``library.py:1764-1835``) trace a scalar μ field evaluated at the
vertical-incidence wave-normal angle. This module integrates Haselgrove's
equations of the full anisotropic dispersion relation instead, with ψ from
the instantaneous wave normal and the local IGRF field vector.

* dispersion scalar ``G(r, u, f) = u·u − n²(r, û, f)``, ``u`` the
  refractive-index vector (|u| = n on the dispersion shell), n² the
  collisionless Appleton–Hartree index at cos ψ = û·B̂(r);
* Hamilton's equations in arc length along the ray, from one gradient of
  G with respect to (r, u, f) (``torch.autograd.grad`` of the batched G:
  each ray's G depends only on its own state, so the gradient of the sum
  is each ray's gradient):

      dr/ds =  G_u / |G_u|,   du/ds = −G_r / |G_u|,
      dt/ds = (u·G_u − f G_f) / (c |G_u|)   (group delay),
      dP/ds = (u·G_u) / |G_u|               (phase path);
* G_r is smoothed as the JAX package's custom-JVP interpolant makes it:
  ∂G/∂(table values) times the trilinearly interpolated 2nd-order
  gradient volumes, through the chain rule of the queries, so the RHS
  sees the same smooth gradient fields the fixed-ψ tracer interpolates.
  To a gradient through the trace, the table values inside the RHS are
  plain trilinear interpolation (JAX differentiates its JVP rule's own
  body there); elsewhere (the shell projection) they go through
  :class:`_InterpSmooth`, the custom JVP as a ``torch.autograd.Function``;
* the fixed-step RK4 integrators of :mod:`.gradient` with a ``renorm_fn``
  that projects |u| back onto the dispersion shell each step.

The gradient inside the RHS keeps its graph only when the caller needs
gradients through the trace (an input that requires grad, with autograd
enabled); a forward-only trace detaches the state at every step. Gradients
of tracer outputs with respect to the field tables (Ne, B) are supported;
with respect to the grid axes they raise. Forward-mode AD is not supported
(no JAX test or caller uses it).
"""

import torch

from ._util import as_tensors, clip
from .constants import C_KM_S, CP, G_P, R_E
from .fields import grad_axis_ord2
from .gradient import _integrate, _integrate_fan
from .trace3d import (_DEG2RAD, _NAN, _RAD2DEG, _corner_rows, _dot3,
                      _ecef, _fan_rays, _field_leaves, _geodetic,
                      _grad_mode, _like, _local_frame, _locate_params,
                      _nanmax, _norm3, _validate_grids_3d, _with_status)

__all__ = ["build_field_3d_aniso", "igrf_volume",
           "trace_ray_3d_anisotropic", "trace_rays_3d_anisotropic",
           "home_ray_3d_anisotropic",
           "synthesize_oblique_ionogram_3d_anisotropic"]


def _ah_n2(X, Y, cos2, mode_mult):
    """Collisionless Appleton–Hartree n² at wave-normal angle ψ.

    ``cos2`` = cos²ψ. The algebra of
    :func:`pyrayhf_tpu_torch.magnetoionic.find_mu_mup` (the
    cancellation-free O branch) as a differentiable n²(X, Y, cos²ψ): every
    singular denominator, and the inputs of the masked lanes, are
    double-``where`` guarded so gradients (and gradients of gradients)
    through valid entries stay finite. Returns (n², valid); n² is a finite
    placeholder where invalid. A vanishing discriminant falls back to the
    unmagnetised 1 − X.
    """
    Xm1 = 1.0 - X
    Y2 = Y * Y
    YT2 = Y2 * (1.0 - cos2)
    YL2 = Y2 * cos2
    alpha = 0.25 * YT2 ** 2 + YL2 * Xm1 ** 2
    mag = alpha > 0.0
    beta = torch.sqrt(torch.where(mag, alpha, 1.0))
    if mode_mult > 0:
        # O-mode: s = YL²(1−X)²/(β + ½YT²),  n² = ((1−X)² + s)/((1−X) + s)
        bsum = beta + 0.5 * YT2
        b_ok = bsum > 0.0
        s = torch.where(b_ok, YL2 * Xm1 ** 2 / torch.where(b_ok, bsum, 1.0),
                        0.0)
        D = Xm1 + s
        d_ok = D != 0.0
        # the masked lanes' inputs are guarded too: second-order AD
        # differentiates the division's backward pass
        Xm1_s = torch.where(d_ok, Xm1, 1.0)
        s_s = torch.where(d_ok, s, 0.0)
        n2_mag = (Xm1_s ** 2 + s_s) / torch.where(d_ok, Xm1_s + s_s, 1.0)
    else:
        D = Xm1 - 0.5 * YT2 - beta
        d_ok = D != 0.0
        X_s = torch.where(d_ok, X, 0.0)
        Xm1_s = torch.where(d_ok, Xm1, 1.0)
        n2_mag = 1.0 - X_s * Xm1_s / torch.where(d_ok, D, 1.0)
    n2_iso = Xm1
    n2 = torch.where(mag, torch.where(d_ok, n2_mag, 2.0), n2_iso)
    # the physicality filter (the reference's μ > 1 → NaN, library.py
    # :244-246) with a rounding-scale headroom of the working dtype: at
    # the layer's bottom edge the exact O-branch value is 1 − O(1e-14)
    # and an f32 quotient may round to 1 + 1 ulp; clamp it onto the shell
    tol = max(16.0 * torch.finfo(n2.dtype).eps, 1e-12)
    valid = (torch.isfinite(n2) & (n2 > 0.0) & (n2 <= 1.0 + tol)
             & torch.where(mag, d_ok, True))
    return torch.where(valid, torch.clamp(n2, max=1.0), 1.0), valid


class _InterpSmooth(torch.autograd.Function):
    """Channel-stacked trilinear value with smoothed spatial derivatives.

    Inputs: queries (aq, bq, cq) [...], the grids, ``fieldC`` [na, nb, nc,
    C] and its 2nd-order grid-gradient volumes gaC/gbC/gcC, and the
    host-decided cell locate of each axis. The value is trilinear
    interpolation of ``fieldC`` (one [8, C] corner row gather per query;
    NaN outside the grid). The backward gives the query points
    Σ_c fetch(g·C)[c]·grad[c] (the gradient volumes interpolated, not the
    derivative of the trilinear weights) and the field table the exact
    transpose of the gather (an ``index_add`` of the weights); the
    gradient volumes get none (they only shape the derivative channel) and
    a grid gradient raises. The backward is written in differentiable ops,
    so a gradient of a trace whose RHS holds this gradient flows through
    it (and through the gradient volumes into the table).
    """

    @staticmethod
    def forward(ctx, aq, bq, cq, a_g, b_g, c_g, fieldC, gaC, gbC, gcC, ups):
        ctx.ups = ups
        ctx.save_for_backward(aq, bq, cq, a_g, b_g, c_g, fieldC, gaC, gbC,
                              gcC)
        return _fetch(aq, bq, cq, a_g, b_g, c_g, fieldC, ups)

    @staticmethod
    def backward(ctx, grad):
        aq, bq, cq, a_g, b_g, c_g, fieldC, gaC, gbC, gcC = ctx.saved_tensors
        need = ctx.needs_input_grad
        if any(need[3:6]):
            raise NotImplementedError(
                "_interp_smooth: differentiation w.r.t. the grid coordinate "
                "axes is not supported (field-table and query-point "
                "gradients are).")
        ups = ctx.ups
        grads = [None] * 11
        for k, vol in ((0, gaC), (1, gbC), (2, gcC)):
            if need[k]:
                grads[k] = (_fetch(aq, bq, cq, a_g, b_g, c_g, vol, ups)
                            * grad).sum(-1)
        if need[6]:
            na, nb, nc, C = fieldC.shape
            rows, w, inside = _corner_rows(aq, bq, cq, a_g, b_g, c_g, na,
                                           nb, nc, ups)
            g_in = torch.where(inside[..., None], grad, 0.0)
            src = w[..., :, None] * g_in[..., None, :]       # [..., 8, C]
            flat = torch.zeros((na * nb * nc, C), dtype=grad.dtype,
                               device=grad.device)
            grads[6] = flat.index_add(0, rows.reshape(-1),
                                      src.reshape(-1, C)).reshape(
                                          fieldC.shape)
        return tuple(grads)


def _fetch(aq, bq, cq, a_g, b_g, c_g, vol, ups):
    """Trilinear values [..., C] of a channel-stacked volume; NaN outside."""
    na, nb, nc, C = vol.shape
    rows, w, inside = _corner_rows(aq, bq, cq, a_g, b_g, c_g, na, nb, nc,
                                   ups)
    vals = (w[..., None] * vol.reshape(-1, C)[rows]).sum(-2)
    return torch.where(inside[..., None], vals, _NAN)


def _interp_smooth(aq, bq, cq, pack, ups=None):
    """:class:`_InterpSmooth` of ``pack`` = (a_grid, b_grid, c_grid,
    fieldC, gaC, gbC, gcC) at queries [...] → [..., C]."""
    if ups is None:
        ups = _locate_params(*pack[:3])
    return _InterpSmooth.apply(aq, bq, cq, *pack, ups)


def _pack(channels, a_g, b_g, c_g):
    """(grids, fieldC, ∂a, ∂b, ∂c) tuple for :func:`_interp_smooth`;
    ``channels`` [na, nb, nc] volumes stacked on a trailing axis."""
    fieldC = torch.stack(channels, dim=-1)
    return (a_g, b_g, c_g, fieldC, grad_axis_ord2(fieldC, a_g, 0),
            grad_axis_ord2(fieldC, b_g, 1), grad_axis_ord2(fieldC, c_g, 2))


def igrf_volume(alt_km, lat_deg, lon_deg, coeffs=None, device=None):
    """IGRF B vector [Tesla] on an (alt, lat, lon) grid.

    Returns (B_north, B_east, B_down), each [N_alt, N_lat, N_lon], the
    inputs of :func:`build_field_3d_aniso`. ``coeffs`` as in
    :func:`pyrayhf_tpu_torch.igrf.igrf_field`.
    """
    from .igrf import igrf_field

    alt, lat, lon = as_tensors(alt_km, lat_deg, lon_deg, device=device)
    bn, be, bd, _, _ = igrf_field(lat[None, :, None], lon[None, None, :],
                                  alt[:, None, None], coeffs=coeffs)
    return bn * 1e-9, be * 1e-9, bd * 1e-9


def build_field_3d_aniso(alt_km, lat_deg, lon_deg, Ne, B_north, B_east,
                         B_down, nu=None, device=None):
    """Precompute the anisotropic tracer's field tables.

    ``Ne`` [m⁻³] and the geomagnetic components ``B_north``/``B_east``/
    ``B_down`` [Tesla, local geodetic frame; :func:`igrf_volume`] on the
    ascending grids, all [N_alt, N_lat, N_lon]. Frequency- and
    mode-independent; B is stored in ECEF components. The tables are
    differentiable inputs (gradients of tracer outputs w.r.t. ``Ne`` or
    the B components flow through the interpolant's value).
    ``nu``: ν(alt) [s⁻¹] for the absorption channel (default model).
    """
    from .absorption import collision_frequency

    alt, lat, lon, Ne = _validate_grids_3d(alt_km, lat_deg, lon_deg, Ne,
                                           device,
                                           (B_north, B_east, B_down, nu))
    bn, be, bd = (torch.broadcast_to(t, Ne.shape) for t in as_tensors(
        B_north, B_east, B_down, Ne, dtype=Ne.dtype)[:3])
    # local geodetic (north, east, down) → ECEF per grid node
    lat2, lon2 = torch.broadcast_tensors((lat * _DEG2RAD)[:, None],
                                         (lon * _DEG2RAD)[None, :])
    rhat, north, east = _local_frame(lat2, lon2)
    b_ecef = (bn[..., None] * north[None] + be[..., None] * east[None]
              - bd[..., None] * rhat[None])
    nu_a = (collision_frequency(alt) if nu is None
            else as_tensors(nu, Ne, dtype=Ne.dtype)[0])
    # one channel-stacked table [na, nb, nc, 4] = (Ne, Bx, By, Bz)
    return {
        "alt": alt, "lat": lat, "lon": lon, "nu": nu_a,
        "tables": _pack([Ne, b_ecef[..., 0], b_ecef[..., 1],
                         b_ecef[..., 2]], alt, lat, lon),
    }


def _g_scalar(p, u, f0, field, mode, mode_mult, ups=None):
    """Dispersion scalar G = u·u − n²(r, û, f) [...] with aux (n², valid,
    κ); ``p``, ``u`` [..., 3], ``f0`` [...]."""
    return _g_terms(p, u, f0, field, mode, mode_mult, ups, True)[:2]


def _g_terms(p, u, f0, field, mode, mode_mult, ups, smooth):
    """(G, (n², valid, κ), queries, table values) of :func:`_g_scalar`.

    ``smooth``: the table values through :func:`_interp_smooth`; else
    plain trilinear interpolation (its derivatives are the weights').
    """
    from .absorption import absorption_coefficient
    from .interp import interp_exact

    alt_g = field["alt"]
    if ups is None:
        ups = _locate_params(*field["tables"][:3])
    r, lat, lon = _geodetic(p)
    alt = r - R_E
    latd, lond = lat * _RAD2DEG, lon * _RAD2DEG
    # below the grid is free space (Ne = 0); fractionally above the top
    # (an RK4 stage before the event backtracks) reads the top edge
    alt_c = clip(alt, alt_g[0], alt_g[-1])
    below = alt < alt_g[0]
    q = (alt_c, latd, lond)
    vals = (_interp_smooth(*q, field["tables"], ups) if smooth
            else _fetch(*q, *field["tables"][:4], ups))
    ne = torch.where(below, 0.0, vals[..., 0])
    bx, by, bz = vals[..., 1], vals[..., 2], vals[..., 3]
    fin = (torch.isfinite(ne) & torch.isfinite(bx) & torch.isfinite(by)
           & torch.isfinite(bz))
    ne = torch.where(fin & (ne > 0.0), ne, torch.where(fin, 0.0, 1.0))
    b2 = bx * bx + by * by + bz * bz
    b_ok = b2 > 0.0
    babs = torch.sqrt(torch.where(b_ok, b2, 1.0))
    # X without find_X's sqrt-then-square: its derivative at ne = 0 (the
    # normal below-layer state) is 0·inf
    X = ne * ((CP / f0) * (CP / f0))
    Y = torch.where(b_ok, G_P * babs / f0, 0.0)
    u2 = _dot3(u, u)
    u_ok = u2 > 0.0
    umag = torch.sqrt(torch.where(u_ok, u2, 1.0))
    cosp = torch.where(u_ok & b_ok,
                       (u[..., 0] * bx + u[..., 1] * by + u[..., 2] * bz)
                       / (umag * babs), 0.0)
    cos2 = clip(cosp * cosp, 0.0, 1.0)
    n2, valid = _ah_n2(X, Y, cos2, mode_mult)
    valid = valid & fin & u_ok
    G = u2 - n2

    # absorption (value-only aux): the QL coefficient at the LOCAL
    # wave-normal angle
    nu = interp_exact(alt, alt_g, field["nu"])
    psi_deg = torch.arccos(clip(torch.abs(cosp), 0.0, 1.0)) * _RAD2DEG
    mu = torch.sqrt(n2)
    kap = absorption_coefficient(ne, nu, f0, babs, psi_deg, mu, mode)
    kap = torch.where(valid & torch.isfinite(kap), kap, 0.0)
    return G, (n2, valid, kap), q, vals


# state layout: y = [p(0:3) km ECEF, u(3:6) refractive-index vector,
#                    t(6) group delay s, P(7) phase path km,
#                    A(8) absorption dB]
_NST = 9


class _GraphRHS(torch.autograd.Function):
    """One RHS evaluation as one node of the trace's graph.

    ``fn(y, f0, tables)`` takes the gradient of G inside; run on detached
    leaf copies of its inputs, that inner gradient walks only this
    evaluation's graph (on the trace's own graph it would walk every step
    before it, which makes a trace quadratic in its steps). The backward
    is the vector-Jacobian product of the evaluation's kept graph.
    """

    @staticmethod
    def forward(ctx, fn, y, f0, *tables):
        with torch.enable_grad():
            ctx.inputs = [t.detach().requires_grad_() for t in
                          (y, f0) + tables]
            ctx.out = fn(ctx.inputs[0], ctx.inputs[1], ctx.inputs[2:])
        return ctx.out.detach()

    @staticmethod
    def backward(ctx, grad):
        need = ctx.needs_input_grad[1:]
        wrt = [t for t, n in zip(ctx.inputs, need) if n]
        got = iter(torch.autograd.grad(ctx.out, wrt, grad,
                                       allow_unused=True))
        return (None,) + tuple(next(got) if n else None for n in need)


def _aniso_funcs(field, mode, z_ground, graph=None):
    """(rhs, renorm, events, reflect) closures over one aniso field.

    ``rhs(y, f0)``/``renorm(y, f0)`` take the wave frequency [...] (the
    per-ray core fixes it, the multi-frequency fan carries it as a frozen
    state channel). ``graph``: keep the graph of each RHS evaluation, for
    gradients through the trace (default: whether autograd is enabled).
    """
    if graph is None:
        graph = torch.is_grad_enabled()
    mode_mult = {"O": 1.0, "X": -1.0}[mode]
    ups = _locate_params(field["alt"], field["lat"], field["lon"])
    grids, tables = field["tables"][:3], field["tables"][3:]

    def g3(p, u, f, tabs=tables, smooth=True):
        fld = dict(field, tables=tuple(grids) + tuple(tabs))
        return _g_terms(p, u, f, fld, mode, mode_mult, ups, smooth)

    def evaluate(y, f0, tabs):
        # ∂G/∂(r, u, f) as the JAX package's value_and_grad takes it: the
        # r-derivative of the table values is the smoothed one (the
        # gradient volumes interpolated), while everything computed here
        # is, to a gradient through the trace, plain trilinear code
        # (JAX differentiates the custom JVP rule's own body at the outer
        # level). So G is built on plain values and G_r is assembled from
        # ∂G/∂values, the interpolated gradient volumes and the chain rule
        # of the queries.
        with torch.enable_grad():
            p, u, f = (t if t.requires_grad else t.detach().requires_grad_()
                       for t in (y[..., :3], y[..., 3:6], f0))
            G, (n2, valid, kap), q, vals = g3(p, u, f, tabs, smooth=False)
            G_v, G_u, G_f = torch.autograd.grad(G.sum(), (vals, u, f),
                                                retain_graph=True,
                                                create_graph=graph)
            coef = [(_fetch(*q, *grids, vol, ups) * G_v).sum(-1)
                    for vol in tabs[1:]]
            G_p, = torch.autograd.grad(q, p, coef, create_graph=graph)
        if not graph:
            p, u, f, kap = p.detach(), u.detach(), f.detach(), kap.detach()
        sig2 = _dot3(G_u, G_u)
        s_ok = sig2 > 1e-24
        sigma = torch.sqrt(torch.where(s_ok, sig2, 1.0))
        ok = (valid & s_ok & torch.isfinite(G_p).all(dim=-1)
              & torch.isfinite(G_u).all(dim=-1) & torch.isfinite(G_f))
        udG = _dot3(u, G_u)
        dp = G_u / sigma[..., None]
        du = -G_p / sigma[..., None]
        dt = (udG - f * G_f) / (C_KM_S * sigma)
        dP = udG / sigma
        vec = torch.cat([dp, du, torch.stack([dt, dP, kap], dim=-1)], dim=-1)
        ok = ok & torch.isfinite(vec).all(dim=-1)
        return torch.where(ok[..., None], vec, 0.0)

    def rhs(y, f0_hz):
        f0 = torch.broadcast_to(f0_hz, y.shape[:-1])
        if graph:
            return _GraphRHS.apply(evaluate, y[..., :_NST], f0, *tables)
        return evaluate(y[..., :_NST], f0, tables)

    def renorm(y, f0_hz):
        # project |u| back onto the dispersion shell: |u| ← n(r, û)
        p, u = y[..., :3], y[..., 3:6]
        umag = _norm3(u)
        u_ok = umag > 0.0
        uhat = u / torch.where(u_ok, umag, 1.0)[..., None]
        _, (n2, valid, _), _, _ = g3(p, uhat, torch.broadcast_to(
            f0_hz, y.shape[:-1]))
        u_new = torch.where((valid & u_ok)[..., None],
                            torch.sqrt(n2)[..., None] * uhat, u)
        return torch.cat([p, u_new, y[..., 6:]], dim=-1)

    alt_g, lat_g, lon_g = field["alt"], field["lat"], field["lon"]

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
        # specular ground bounce: tangential u kept, radial flipped
        p, u = y[..., :3], y[..., 3:6]
        rhat = p / _norm3(p)[..., None]
        ur = _dot3(u, rhat)
        u_new = u - 2.0 * torch.clamp(ur, max=0.0)[..., None] * rhat
        return torch.cat([p, u_new, y[..., 6:]], dim=-1)

    return rhs, renorm, events, reflect


def _aniso_launch_state(lat0_deg, lon0_deg, elevation_deg, azimuth_deg,
                        z_ground):
    """Initial [p, u, t, P, A] states [..., 9] of fan rays: launched in
    free space below the grid with |u| = 1."""
    lat0 = lat0_deg * _DEG2RAD
    lon0 = lon0_deg * _DEG2RAD
    p0 = _ecef(lat0, lon0, R_E + z_ground + 1e-2)
    rhat0, north0, east0 = _local_frame(lat0, lon0)
    el = (elevation_deg * _DEG2RAD)[..., None]
    az = (azimuth_deg * _DEG2RAD)[..., None]
    d0 = (torch.sin(el) * rhat0
          + torch.cos(el) * (torch.cos(az) * north0
                             + torch.sin(az) * east0))
    return torch.cat([torch.broadcast_to(p0, d0.shape), d0,
                      torch.zeros_like(d0)], dim=-1)


def _aniso_path_products(lat0_deg, lon0_deg, azimuth_deg, ys, alive,
                         status, paths=True):
    """Path channels, integrals and landing geometry of traced rays
    (``ys`` [..., n_steps+1, ≥9]); ``paths=False`` keeps only scalars."""
    from .trace3d import _landing

    lat0 = lat0_deg * _DEG2RAD
    lon0 = lon0_deg * _DEG2RAD
    az = azimuth_deg * _DEG2RAD
    p_path = ys[..., :3]
    r_path, lat_path, lon_path = _geodetic(p_path)
    alt_path = r_path - R_E
    dseg = _norm3(torch.diff(p_path, dim=-2))
    ground_range, cross_track, landed = _landing(
        lat0, lon0, az, p_path[..., -1, :], r_path[..., -1], status)
    out = {}
    if paths:
        out.update({"lat": lat_path * _RAD2DEG, "lon": lon_path * _RAD2DEG,
                    "alt": alt_path, "ecef": p_path, "u": ys[..., 3:6],
                    "alive": alive})
    out.update({
        "status_code": status,
        "group_path_km": torch.nansum(dseg, dim=-1),
        "group_delay_sec": ys[..., -1, 6],
        "phase_path_km": ys[..., -1, 7],
        "absorption_db": ys[..., -1, 8],
        "apex_alt_km": _nanmax(alt_path),
        "ground_range_km": ground_range,
        "cross_track_km": cross_track,
        "landing_lat_deg": torch.where(landed,
                                       lat_path[..., -1] * _RAD2DEG, _NAN),
        "landing_lon_deg": torch.where(landed,
                                       lon_path[..., -1] * _RAD2DEG, _NAN),
    })
    return out


def _aniso_core(field, lat0_deg, lon0_deg, elevation_deg, azimuth_deg,
                f0_hz, mode, ds, n_steps, z_ground, n_hops=1,
                early_exit=False, graph=None):
    rhs, renorm, events, reflect = _aniso_funcs(field, mode, z_ground,
                                                graph)
    y0 = _aniso_launch_state(lat0_deg, lon0_deg, elevation_deg,
                             azimuth_deg, z_ground)
    hop_kw = dict(reflect_fn=reflect, max_bounces=n_hops - 1) \
        if n_hops > 1 else {}
    ys, alive, status = _integrate(lambda y: rhs(y, f0_hz), y0, n_steps,
                                   ds, events,
                                   renorm_fn=lambda y: renorm(y, f0_hz),
                                   early_exit=early_exit, **hop_kw)
    return _aniso_path_products(lat0_deg, lon0_deg, azimuth_deg, ys, alive,
                                status)


def _aniso_fan_flat(field, lat0_deg, lon0_deg, elf, azf, f0f, mode, ds,
                    n_steps, z_ground, n_hops, chunk, paths=True,
                    graph=None):
    """Flat [R]-ray anisotropic early-exit fan (shared fan machinery).

    The wave frequency rides as a FROZEN 10th state channel (the event
    backtrack is linear, so it is kept exactly): rays at different
    frequencies integrate together, a whole ionogram sweep in one loop
    that stops at the longest-lived ray. The step math on the 9 physical
    channels is that of the per-ray core.
    """
    rhs, renorm, events, reflect = _aniso_funcs(field, mode, z_ground,
                                                graph)

    def rhs10(y):
        d = rhs(y, y[..., _NST])
        return torch.cat([d, torch.zeros_like(d[..., :1])], dim=-1)

    def renorm10(y):
        return renorm(y, y[..., _NST])

    y0b = _aniso_launch_state(lat0_deg, lon0_deg, elf, azf, z_ground)
    y0b = torch.cat([y0b, f0f[:, None]], dim=1)
    hop_kw = dict(reflect_fn=reflect, max_bounces=n_hops - 1) \
        if n_hops > 1 else {}
    ys, alive, status = _integrate_fan(rhs10, y0b, n_steps, ds, events,
                                       renorm_fn=renorm10, chunk=chunk,
                                       **hop_kw)
    return _aniso_path_products(lat0_deg, lon0_deg, azf, ys[..., :_NST],
                                alive, status, paths=paths)


def _aniso_fan_core(field, lat0_deg, lon0_deg, els, azs, f0_hz, mode, ds,
                    n_steps, z_ground, n_hops=1, chunk=125, graph=None):
    """The [E, A] anisotropic fan as one batched early-exit integration;
    ``f0_hz`` broadcasts against the [E, A] fan."""
    el_g, az_g = torch.meshgrid(els, azs, indexing="ij")
    f0_g = torch.broadcast_to(f0_hz, el_g.shape)
    out = _aniso_fan_flat(field, lat0_deg, lon0_deg, el_g.reshape(-1),
                          az_g.reshape(-1), f0_g.reshape(-1), mode, ds,
                          n_steps, z_ground, n_hops, chunk, graph=graph)
    E, A = el_g.shape
    return {k: v.reshape((E, A) + tuple(v.shape[1:]))
            for k, v in out.items()}


def _aniso_ionogram_fan(field, lat0_deg, lon0_deg, els, azs, f0s, mode,
                        ds, n_steps, z_ground, n_hops=1, chunk=125):
    """[F, E, A] sweep fan: every frequency's rays in ONE early-exit loop;
    only per-ray scalars are kept."""
    ff, elf, azf = _fan_rays(els, azs, f0s)
    out = _aniso_fan_flat(field, lat0_deg, lon0_deg, elf, azf, ff, mode,
                          ds, n_steps, z_ground, n_hops, chunk, paths=False)
    F, E, A = f0s.numel(), els.numel(), azs.numel()
    return {k: v.reshape((F, E, A) + tuple(v.shape[1:]))
            for k, v in out.items()}


def _needs_graph(field, *ts):
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad
        for t in _field_leaves(field) + list(ts))


def trace_ray_3d_anisotropic(field, lat0_deg, lon0_deg, elevation_deg,
                             azimuth_deg, f0_hz, *, mode="O", step_km=1.0,
                             s_max_km=6000.0, z_ground_km=0.0, n_hops=1,
                             early_exit=False):
    """Trace one ray with the full anisotropic dispersion relation.

    ``field`` from :func:`build_field_3d_anisotropic` (frequency- and
    mode-independent); launch geometry as
    :func:`pyrayhf_tpu_torch.trace3d.trace_ray_3d`; ``f0_hz``/``mode``
    select the wave. Returns the fixed-ψ tracer's dict plus ``u``, the
    refractive-index vector along the path (|u| = n; its direction is the
    wave normal). Group delay comes from the dispersion relation's
    frequency derivative, phase path is ∫u·dr, and the absorption is the
    QL coefficient at the local wave-normal angle.

    Differentiable w.r.t. launch geometry, frequency and the field tables
    (``torch.autograd.grad`` of an output); the grid axes are not.
    ``early_exit=True`` stops once the ray is frozen (same outputs).
    """
    n_steps = int(round(float(s_max_km) / float(step_km)))
    lat0, lon0, el, az, f0, ds, zg = _like(field, lat0_deg, lon0_deg,
                                           elevation_deg, azimuth_deg, f0_hz,
                                           step_km, z_ground_km)
    graph = _needs_graph(field, lat0, lon0, el, az, f0)
    with torch.set_grad_enabled(graph):
        out = _aniso_core(field, lat0, lon0, el, az, f0, mode, ds, n_steps,
                          zg, n_hops=int(n_hops),
                          early_exit=bool(early_exit), graph=graph)
    return _with_status(out)


def trace_rays_3d_anisotropic(field, lat0_deg, lon0_deg, elevation_deg,
                              azimuth_deg, f0_hz, *, mode="O",
                              step_km=1.0, s_max_km=6000.0,
                              z_ground_km=0.0, n_hops=1, early_exit=True):
    """Batched anisotropic fan: elevation [E] × azimuth [A] → [E, A, ...].

    ``f0_hz`` may be an array broadcast against the [E, A] fan (the fan
    carries frequency as a frozen state channel, so mixed-frequency fans
    run as one batch). ``early_exit=True`` (default) stops once every ray
    has frozen (same results).
    """
    n_steps = int(round(float(s_max_km) / float(step_km)))
    lat0, lon0, els, azs, f0, ds, zg = _like(field, lat0_deg, lon0_deg,
                                             elevation_deg, azimuth_deg,
                                             f0_hz, step_km, z_ground_km)
    graph = _needs_graph(field, lat0, lon0, els, azs, f0)
    with torch.set_grad_enabled(graph):
        return _aniso_fan_core(
            field, lat0, lon0, els.reshape(-1), azs.reshape(-1), f0, mode,
            ds, n_steps, zg, n_hops=int(n_hops),
            chunk=125 if early_exit else n_steps, graph=graph)


def home_ray_3d_anisotropic(field, tx_lat, tx_lon, rx_lat, rx_lon, f0_hz,
                            *, mode="O", n_elev=48, n_az=9,
                            az_span_deg=8.0, elev_min_deg=5.0,
                            elev_max_deg=75.0, step_km=2.0,
                            s_max_km=4000.0, n_hops=1,
                            max_range_jump_km=200.0,
                            max_miss_jump_km=None):
    """Point-to-point homing on the full anisotropic dispersion surface.

    An (elevation × azimuth) fan of :func:`trace_rays_3d_anisotropic` rays
    around the great-circle bearing, per-azimuth elevation homing in
    range, then the signed landing miss interpolated to zero across
    azimuth (the crossing stages of
    :func:`pyrayhf_tpu_torch.trace3d.home_ray_3d`). Output dict and NaN
    semantics as that function.
    """
    from .trace3d import _field_tensor, _home_fan_core, _home_setup

    az0, D, els, azs, miss_cap = _home_setup(
        tx_lat, tx_lon, rx_lat, rx_lon, n_elev, n_az, az_span_deg,
        elev_min_deg, elev_max_deg, max_miss_jump_km,
        like=_field_tensor(field))

    def fan_fn(fld, tlat, tlon, els_t, azs_t):
        return trace_rays_3d_anisotropic(
            fld, tlat, tlon, els_t, azs_t, f0_hz, mode=mode,
            step_km=step_km, s_max_km=s_max_km, n_hops=n_hops)

    out = _home_fan_core(field, tx_lat, tx_lon, az0, D, els, azs,
                         step_km=step_km, s_max_km=s_max_km,
                         n_hops=n_hops,
                         max_range_jump_km=max_range_jump_km,
                         miss_cap=miss_cap, fan_fn=fan_fn)
    out.update({"bearing_deg": az0, "range_km": D,
                "elevations_deg": els, "azimuths_deg": azs})
    return out


def synthesize_oblique_ionogram_3d_anisotropic(
        f0s_hz, tx_lat, tx_lon, rx_lat, rx_lon, field, *, mode="O",
        n_elev=48, n_az=9, az_span_deg=8.0, elev_min_deg=5.0,
        elev_max_deg=75.0, step_km=2.0, s_max_km=4000.0, n_hops=1,
        max_range_jump_km=200.0, max_miss_jump_km=None):
    """Oblique ionogram on the full anisotropic dispersion surface.

    Per-frequency two-angle homing with the true wave-normal physics. The
    anisotropic ``field`` is frequency- and mode-independent, so the whole
    [N_freq × E × A] ray budget integrates as one batched early-exit fan
    (frequency as a frozen state channel) and both crossing stages run
    over its frequency axis. Returns stacked [N_freq] tensors
    (``delay_low/high_sec``, ``elev_*_deg``, ``azimuth_*_deg``,
    ``azimuth_offset_*_deg``, ``group_path_*``/``phase_path_*``/
    ``absorption_*``) plus ``freq_hz`` and the link geometry; NaN rows
    above the (azimuth-resolved) link MUF.
    """
    from .trace3d import _field_tensor, _home_setup, _homed_sweep

    like = _field_tensor(field)
    az0, D, els, azs, miss_cap = _home_setup(
        tx_lat, tx_lon, rx_lat, rx_lon, n_elev, n_az, az_span_deg,
        elev_min_deg, elev_max_deg, max_miss_jump_km, like=like)
    n_steps = int(round(float(s_max_km) / float(step_km)))
    lat0, lon0, f0s, ds, zg = _like(field, tx_lat, tx_lon, f0s_hz, step_km,
                                    0.0)
    f0s = torch.atleast_1d(f0s)
    with _grad_mode(*_field_leaves(field)):
        fan_all = _aniso_ionogram_fan(field, lat0, lon0, els, azs, f0s,
                                      mode, ds, n_steps, zg,
                                      n_hops=int(n_hops))
        out = _homed_sweep(fan_all, float(tx_lat), float(tx_lon), az0, D,
                           els, azs, float(step_km), float(s_max_km),
                           int(n_hops), float(max_range_jump_km), miss_cap)
    out.update({"freq_hz": f0s, "bearing_deg": az0, "range_km": D,
                "elevations_deg": els, "azimuths_deg": azs})
    return out
