"""Plain PyTorch reference of the 2-D oblique ionogram through a slice.

Written from the upstream equations (PyRayHF ``library.py``):
``find_X``/``find_Y`` and the Appleton–Hartree μ and analytic group index
μ′ (``find_mu_mup``); the gradient fields by ``np.gradient`` with
``edge_order=2``; the Haselgrove ray equations of ``ray_rhs_cartesian``
(:953-1006),

    dx/ds = vx, dz/ds = vz, dv/ds = (∇μ − (∇μ·v) v) / μ;

``trace_ray_cartesian_gradient``'s terminal events (ground, top and the
two lateral bounds of the slice) and its path integrals (:1370-1429):
group path ∫ds, group delay ∫μ′ ds / c, phase path ∫μ ds, and the
quasi-longitudinal absorption ∫κ ds, κ = ωp²ν / (2cμ((ω ± ωL)² + ν²))
(Davies eq. 7.20) with ν(z) = 1.86e11·exp(−0.15 z) s⁻¹; then the homing
of the low and high rays onto a link's ground range.

Departures from the upstream, each the discretisation of the JAX package
that the program ports, so that the reference judges the program by the
values that package gives:

* fixed-step RK4 of ``step_km`` for ``n_steps`` steps (upstream: RK45 at
  rtol 1e-7), the direction renormalised after each step;
* the events tested after each step, the FIRST crossed one in the order
  ground (z − z₀ − 1e-3 km), top, low x, high x winning, with the state
  backtracked linearly to it and frozen there (upstream: the integrator's
  event location); a step that leaves a non-finite state freezes the ray
  on its last finite state;
* the path integrals by the midpoint rule over the steps, each sample
  counted only where it is finite;
* the fields read by bilinear interpolation on the uniform axes (a direct
  cell locate, NaN out of the slice for μ, μ′ and κ, 0 for ∇μ), and the
  right-hand side 0 where μ is not finite or not positive;
* μ and μ′ NaN where the wave does not propagate (under the root < 0,
  μ > 1; μ′ where μ ≤ 0), κ 0 where it is not finite;
* the O-mode quotient in its cancellation-free form, (1−X)² + s over
  (1−X) + s with s = YL²(1−X)²/(β + ½YT²) (the upstream expression loses
  most of its digits near X = 1); the unmagnetised branch where |Y| is
  below 1e-12 over the whole slice and every frequency;
* the homing: a crossing of the target between consecutive elevations
  that both land and whose ranges differ by at most ``max_jump_km``,
  interpolated linearly, and kept only where its delay is at least the
  chord's light time; the LOW ray is the first such crossing, the HIGH
  ray the last.

Everything runs in float64 on the slices' device. The slices of a call
are traced together in groups whose tables stay under ``BLOCK_BYTES``.
It imports nothing of the program and nothing of JAX.
"""

import math

import torch

CP = 8.97866275                  # f_p [Hz] = CP · sqrt(n_e [m^-3])
G_P = 2.799249247e10             # f_ce [Hz] = G_P · |B| [T]
C_KM_S = 299_792.458
DB_PER_NP = 8.685889638065037
NU0 = 1.86e11                    # ν(z) = NU0 · exp(−z / NU_SCALE_KM)
NU_SCALE_KM = 1.0 / 0.15
Y_TOL = 1e-12
GROUND_EPS_KM = 1e-3
BLOCK_BYTES = 32 << 30           # tables of one group of slices
CHECK_EVERY = 64                 # steps between the checks for "all frozen"
STATUS = {"length": 0, "ground": 1, "domain": 2}

# The reference's operations a ray takes a step (each add, multiply,
# division, square root and floor as one; comparisons, selects and the
# reads of the tables not counted):
# a field read: the cell locate 12 (two scaled offsets, floors, clamps
# and fractions), the four weights 6, and 7 a channel;
# a right-hand side: a read of μ, ∂μ/∂z, ∂μ/∂x (12 + 6 + 21) and the
# ray equations 9;
# RK4: 4 right-hand sides, the three stage states 25, the combination 29;
# the direction renormalised 6; the four event values 5; the backtrack
# to a crossed event 14; the midpoint sample: the segment 4, the
# midpoint 4, a read of μ, μ′, κ (12 + 6 + 21) and the four sums 8.
_READ = 12 + 6
_RHS = _READ + 3 * 7 + 9
OPS_STEP = 4 * _RHS + 25 + 29 + 6 + 5 + 14 + (4 + 4 + _READ + 3 * 7 + 8)

__all__ = ["collision_frequency", "fields", "gradient2", "trace",
           "crossings", "oblique_ionogram", "OPS_STEP"]


def collision_frequency(z_km):
    """ν(z) [s⁻¹] of the D/E-region fit."""
    return NU0 * torch.exp(-z_km / NU_SCALE_KM)


def _mu_mup(X, Y, psi_deg, mode_mult):
    """Appleton–Hartree (μ, μ′), NaN where the wave does not propagate."""
    psi = torch.deg2rad(psi_deg)
    sinp, cosp = torch.sin(psi), torch.cos(psi)
    YT, YL = Y * sinp, Y * cosp
    Xm1 = 1.0 - X
    beta = torch.sqrt(0.25 * YT ** 4 + YL ** 2 * Xm1 ** 2)
    if mode_mult > 0:
        bsum = beta + 0.5 * YT ** 2
        s = torch.where(bsum > 0.0, YL ** 2 * Xm1 ** 2
                        / torch.where(bsum > 0.0, bsum, 1.0), 0.0)
        D = torch.where(Xm1 == 0.0, Xm1 - 0.5 * YT ** 2 + beta, Xm1 + s)
        under = torch.where(Xm1 == 0.0, 1.0 - X * Xm1 / D,
                            (Xm1 ** 2 + s) / D)
    else:
        D = Xm1 - 0.5 * YT ** 2 - beta
        under = 1.0 - X * Xm1 / D
    mu = torch.sqrt(under)                       # NaN where under < 0
    mu = torch.where(mu > 1.0, float("nan"), mu)
    dbeta_dX = -YL ** 2 * Xm1 / beta
    dD_dX = -1.0 + mode_mult * dbeta_dX
    dalpha_dY = YT ** 3 * sinp + 2.0 * YL * Xm1 ** 2 * cosp
    dbeta_dY = 0.5 * dalpha_dY / beta
    dD_dY = -YT * sinp + mode_mult * dbeta_dY
    dmu_dY = X * Xm1 * dD_dY / (2.0 * mu * D ** 2)
    dmu_dX = (2.0 * X - 1.0 + X * Xm1 / D * dD_dX) / (2.0 * mu * D)
    mup = mu - (2.0 * X * dmu_dX + Y * dmu_dY)
    return mu, torch.where(mu > 0.0, mup, float("nan"))


def fields(f_hz, den, bmag, bpsi, nu_z, mode_mult, unmagnetised=False):
    """μ, μ′, κ [dB/km] [F, nz, nx] of one slice (``den``, ``bmag``,
    ``bpsi`` [nz, nx], ν ``nu_z`` [nz]) at the frequencies ``f_hz`` [F];
    κ is 0 where it is not finite."""
    f = f_hz[:, None, None]
    X = (torch.sqrt(den) * CP) ** 2 / f ** 2
    Y = G_P * bmag / f
    if unmagnetised:
        mu2 = 1.0 - X
        mu = torch.where(mu2 > 0.0, torch.sqrt(mu2), float("nan"))
        mup = torch.where(mu > 0.0, 1.0 / mu, float("nan"))
    else:
        mu, mup = _mu_mup(X, Y, bpsi, mode_mult)
    w = 2.0 * math.pi * f
    wp2 = (2.0 * math.pi * CP) ** 2 * den
    wl = 2.0 * math.pi * G_P * bmag * torch.abs(torch.cos(torch.deg2rad(
        bpsi)))
    nu = nu_z[:, None]
    wm = w + mode_mult * wl
    kappa = (wp2 * nu / (2.0 * C_KM_S * 1e3 * torch.where(
        mu > 0.0, mu, float("nan")) * (wm * wm + nu * nu))
             * 1e3 * DB_PER_NP)
    return mu, mup, torch.where(torch.isfinite(kappa), kappa, 0.0)


def gradient2(f, h, axis):
    """``np.gradient(f, h, axis=axis, edge_order=2)`` on a uniform axis of
    spacing ``h``: central differences inside, the one-sided second-order
    stencils at the two ends."""
    n = f.shape[axis]

    def sl(a, b):
        return f.narrow(axis, a, b - a)

    inner = (sl(2, n) - sl(0, n - 2)) / (2.0 * h)
    first = (-1.5 / h) * sl(0, 1) + (2.0 / h) * sl(1, 2) + (-0.5 / h) * sl(
        2, 3)
    last = (0.5 / h) * sl(n - 3, n - 2) + (-2.0 / h) * sl(
        n - 2, n - 1) + (1.5 / h) * sl(n - 1, n)
    return torch.cat([first, inner, last], dim=axis)


class _Grid:
    """The uniform axes of the slices, as [2] tensors in the state's (x, z)
    order: origin, inverse spacing, last cell, flat-index stride, bounds;
    the four corners' flat offsets; the spacings for the gradients."""

    def __init__(self, z_km, x_km, device):
        kw = dict(dtype=torch.float64, device=device)
        self.nz, self.nx = len(z_km), len(x_km)
        lo = (float(x_km[0]), float(z_km[0]))
        hi = (float(x_km[-1]), float(z_km[-1]))
        self.hx = (hi[0] - lo[0]) / (self.nx - 1)
        self.hz = (hi[1] - lo[1]) / (self.nz - 1)
        self.lo = torch.tensor(lo, **kw)
        self.hi = torch.tensor(hi, **kw)
        self.inv = torch.tensor([(self.nx - 1) / (hi[0] - lo[0]),
                                 (self.nz - 1) / (hi[1] - lo[1])], **kw)
        self.last = torch.tensor([self.nx - 2, self.nz - 2], **kw)
        self.stride = torch.tensor([1, self.nx], device=device)
        self.corners = torch.tensor([0, 1, self.nx, self.nx + 1],
                                    device=device)
        # event offsets below the state: the ground sits GROUND_EPS_KM up
        self.eps = torch.tensor([0.0, GROUND_EPS_KM], **kw)
        nan = float("nan")
        self.rhs_fill = torch.tensor([nan, 0.0, 0.0], **kw)
        self.mid_fill = torch.tensor([nan, nan, nan], **kw)
        # μ′ over c for the delay; μ and κ as they are
        self.mid_div = torch.tensor([C_KM_S, 1.0, 1.0], **kw)


def _read(g, tab, base, p, fill):
    """Bilinear values [R, 3] of the three channels of ``tab`` [rows, 3]
    at the points ``p`` [R, 2] (x, z), each ray's plane starting at row
    ``base`` [R]; out of the slice each channel takes its ``fill`` [3]."""
    f = (p - g.lo) * g.inv
    f = torch.where(torch.isnan(f), 0.0, f)
    i = torch.minimum(torch.clamp(torch.floor(f), min=0.0), g.last)
    t = f - i
    idx = base + (i.long() * g.stride).sum(-1)
    v = tab[idx[:, None] + g.corners]                       # [R, 4, 3]
    a = 1 - t
    (ax, az), (tx, tz) = a.unbind(-1), t.unbind(-1)
    wv = torch.stack([az * ax, az * tx, tz * ax, tz * tx], -1)[..., None] * v
    val = ((wv[:, 0] + wv[:, 1]) + wv[:, 2]) + wv[:, 3]
    inb = ((p >= g.lo) & (p <= g.hi)).all(-1)
    return torch.where(inb[:, None], val, fill)


def _rhs(g, tabs, base, y):
    """dy/ds of the states ``y`` [R, 4] (x, z, vx, vz)."""
    m = _read(g, tabs["rhs"], base, y[:, :2], g.rhs_fill)
    n, grad, v = m[:, 0], m[:, 1:], y[:, 2:]                # ∇μ (x, z)
    ok = torch.isfinite(n) & (n > 0.0)
    n_s = torch.where(ok, n, 1.0)
    gdv = (grad * v).sum(-1, keepdim=True)
    acc = (grad - gdv * v) / n_s[:, None]
    return torch.where(ok[:, None], torch.cat([v, acc], -1), 0.0)


def _events(g, y):
    """Signed distances to the events [R, 4], positive inside: ground,
    top, low x, high x."""
    p = y[:, :2]
    return torch.cat([(p - g.lo) - g.eps, g.hi - p], -1)[:, [1, 3, 0, 2]]


def _integrate(g, tabs, base, elev_deg, ds, n_steps):
    """The fan of rays [R] launched from (x₀, z₀) at ``elev_deg`` [R]
    through the tables ``tabs``: a dict of [R] ray outputs (ranges,
    delays, paths, absorption, status, steps)."""
    R = elev_deg.numel()
    kw = dict(dtype=torch.float64, device=elev_deg.device)
    el = torch.deg2rad(elev_deg)
    vx, vz = torch.cos(el), torch.sin(el)
    vm = torch.sqrt(vx * vx + vz * vz)
    y = torch.cat([g.lo.expand(R, 2), torch.stack([vx / vm, vz / vm], -1)],
                  -1)
    alive = torch.ones(R, dtype=torch.bool, device=y.device)
    status = torch.full((R,), STATUS["length"], dtype=torch.int64,
                        device=y.device)
    steps = torch.zeros(R, dtype=torch.int64, device=y.device)
    sums = torch.zeros(R, 4, **kw)               # path, delay, phase, κ
    eo = _events(g, y)
    for k in range(n_steps):
        if k % CHECK_EVERY == 0 and not bool(alive.any()):
            break
        k1 = _rhs(g, tabs, base, y)
        k2 = _rhs(g, tabs, base, y + 0.5 * ds * k1)
        k3 = _rhs(g, tabs, base, y + 0.5 * ds * k2)
        k4 = _rhs(g, tabs, base, y + ds * k3)
        yn = y + (ds / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
        v = yn[:, 2:]
        vmag = torch.sqrt((v * v).sum(-1, keepdim=True))
        v = torch.where(vmag > 0, v / torch.where(vmag > 0, vmag, 1.0), v)
        yn = torch.cat([yn[:, :2], v], dim=-1)
        en = _events(g, yn)
        crossed = (en <= 0.0) & (eo > 0.0)
        j = torch.argmax(crossed.to(torch.uint8), dim=-1, keepdim=True)
        a, b = torch.gather(eo, 1, j), torch.gather(en, 1, j)
        t = torch.where(a != b, a / torch.where(a != b, a - b, 1.0), 1.0)
        t = torch.clamp(t, 0.0, 1.0)
        cross = crossed.any(dim=-1) & alive
        y_next = torch.where(alive[:, None], torch.where(
            cross[:, None], y + t * (yn - y), yn), y)
        status = torch.where(cross, torch.where(
            j[:, 0] == 0, STATUS["ground"], STATUS["domain"]), status)
        bad = ~torch.isfinite(y_next).all(dim=-1)
        y_next = torch.where(bad[:, None], y, y_next)
        steps += alive.long()
        alive = alive & ~cross & ~bad
        # the midpoint sample of the segment just taken (0 once frozen)
        d = y_next[:, :2] - y[:, :2]
        seg = torch.hypot(d[:, 0], d[:, 1])
        mid = 0.5 * (y[:, :2] + y_next[:, :2])
        q = (_read(g, tabs["mid"], base, mid, g.mid_fill) / g.mid_div
             ) * seg[:, None]
        sums += torch.cat([seg[:, None],
                           torch.where(torch.isfinite(q), q, 0.0)], -1)
        y, eo = y_next, en
    landed = status == STATUS["ground"]
    return {"ground_range_km": torch.where(landed, y[:, 0], float("nan")),
            "group_path_km": sums[:, 0], "group_delay_sec": sums[:, 1],
            "phase_path_km": sums[:, 2], "absorption_db": sums[:, 3],
            "status_code": status, "steps_taken": steps}


def _fill_tables(g, rhs, mid, f_hz, den, bmag, bpsi, nu_z, mode_mult):
    """One slice's tables [F, nz, nx, 3], filled in place: ``rhs`` (μ,
    ∂μ/∂x, ∂μ/∂z) and ``mid`` (μ′, μ, κ) by node."""
    unmag = bool(G_P * bmag.abs().amax() / f_hz.amin() < Y_TOL)
    for f0 in range(0, f_hz.numel(), 16):
        sl = slice(f0, f0 + 16)
        mu, mup, kap = fields(f_hz[sl], den, bmag, bpsi, nu_z, mode_mult,
                              unmag)
        rhs[sl, ..., 0] = mu
        rhs[sl, ..., 1] = gradient2(mu, g.hx, -1)
        rhs[sl, ..., 2] = gradient2(mu, g.hz, -2)
        mid[sl, ..., 0] = mup
        mid[sl, ..., 1] = mu
        mid[sl, ..., 2] = kap


def trace(f_hz, elev_deg, z_km, x_km, den, bmag, bpsi, mode_mult, step_km,
          n_steps):
    """The [S, F, E] fan of ``S`` slices (``den``, ``bmag`` [T], ``bpsi``
    [deg] each [S, nz, nx] on the uniform host grids ``z_km``, ``x_km``)
    at frequencies ``f_hz`` [F] and launch elevations ``elev_deg`` [E],
    launched from the slice's origin: a dict of [S, F, E] tensors (see
    :func:`_integrate`), with ν of :func:`collision_frequency`."""
    dev = den.device
    g = _Grid(z_km, x_km, dev)
    kw = dict(dtype=torch.float64, device=dev)
    f_hz = torch.as_tensor(f_hz, **kw)
    el = torch.as_tensor(elev_deg, **kw)
    nu = collision_frequency(torch.as_tensor(z_km, **kw))
    S, F, E = den.shape[0], f_hz.numel(), el.numel()
    plane = g.nz * g.nx
    group = max(1, min(S, BLOCK_BYTES // (2 * 3 * 8 * F * plane)))
    group = -(-S // -(-S // group))              # groups of even size
    outs = []
    for s0 in range(0, S, group):
        n = min(S, s0 + group) - s0
        rhs = torch.empty(n, F, g.nz, g.nx, 3, **kw)
        mid = torch.empty(n, F, g.nz, g.nx, 3, **kw)
        for k in range(n):
            _fill_tables(g, rhs[k], mid[k], f_hz,
                         *(a[s0 + k].to(torch.float64)
                           for a in (den, bmag, bpsi)), nu, mode_mult)
        tabs = {"rhs": rhs.view(-1, 3), "mid": mid.view(-1, 3)}
        # ray (slice, frequency, elevation) reads the plane of (slice, f)
        base = (torch.arange(n * F, device=dev) * plane).repeat_interleave(E)
        out = _integrate(g, tabs, base, el.repeat(n * F), float(step_km),
                         int(n_steps))
        del rhs, mid, tabs
        outs.append({k: v.view(n, F, E) for k, v in out.items()})
    return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}


def crossings(range_e, chans, elev_deg, target_km, max_jump_km,
              delay_min_s):
    """(low, high) rays that home on ``target_km``, from the [..., E] fan's
    landing ranges (NaN where a ray does not land): each a tuple of the
    [...] channels ``chans`` (group delay first) interpolated at the
    crossing, then the crossing's elevation; NaN where no crossing is
    physical."""
    d = range_e - target_km
    ok = torch.isfinite(d)
    d0, d1 = d[..., :-1], d[..., 1:]
    cross = (ok[..., :-1] & ok[..., 1:]
             & (torch.abs(range_e[..., 1:] - range_e[..., :-1])
                <= max_jump_km)
             & (torch.sign(d0) * torch.sign(d1) <= 0.0)
             & ((d0 != 0.0) | (d1 != 0.0)))
    t = torch.where(d1 != d0, d0 / torch.where(d1 != d0, d0 - d1, 1.0),
                    0.0)
    t = torch.clamp(t, 0.0, 1.0)
    at = [c[..., :-1] + t * (c[..., 1:] - c[..., :-1])
          for c in (*chans, elev_deg.expand_as(range_e))]
    valid = cross & (at[0] >= delay_min_s)
    any_v = valid.any(dim=-1)
    n = valid.shape[-1]
    k = torch.arange(n, device=valid.device)
    lo = torch.where(valid, k, n).amin(dim=-1, keepdim=True)
    hi = torch.where(valid, k, -1).amax(dim=-1, keepdim=True)

    def pick(i):
        i = torch.clamp(i, 0, n - 1)
        return tuple(torch.where(any_v, torch.gather(a, -1, i)[..., 0],
                                 float("nan")) for a in at)

    return pick(lo), pick(hi)


def oblique_ionogram(f_hz, elev_deg, z_km, x_km, den, bmag, bpsi, mode_mult,
                     step_km, n_steps, target_km, max_jump_km):
    """:func:`trace` of the slices, and the homed low and high rays [S, F]
    of a Cartesian link of ``target_km`` (one hop): ``delay_*_sec``,
    ``absorption_*_db``, ``group_path_*_km``, ``phase_path_*_km`` and
    ``elev_*_deg`` for * in low, high."""
    fan = trace(f_hz, elev_deg, z_km, x_km, den, bmag, bpsi, mode_mult,
                step_km, n_steps)
    el = torch.as_tensor(elev_deg, dtype=torch.float64, device=den.device)
    keys = ("delay_{}_sec", "absorption_{}_db", "group_path_{}_km",
            "phase_path_{}_km", "elev_{}_deg")
    lo, hi = crossings(fan["ground_range_km"],
                       tuple(fan[k] for k in ("group_delay_sec",
                                              "absorption_db",
                                              "group_path_km",
                                              "phase_path_km")),
                       el, target_km, max_jump_km, target_km / C_KM_S)
    for side, vals in (("low", lo), ("high", hi)):
        fan.update({k.format(side): v for k, v in zip(keys, vals)})
    return fan
