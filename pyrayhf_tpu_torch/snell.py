"""Stratified Snell's-law oblique ray tracers (Cartesian + spherical).

Port of ``pyrayhf_tpu.snell`` (reference ``trace_ray_cartesian_snells``
``library.py:1096-1268``, ``trace_ray_spherical_snells`` :1460-1713):

* a whole (frequency × elevation) fan is one set of tensor operations:
  the frequency-dependent preparation (μ, μ', κ and the compaction of the
  valid nodes) runs once per (profile, frequency) row, the rays of every
  elevation broadcast against it;
* invalid/evanescent nodes are compacted with a stable argsort, keeping
  shapes static; beyond the apex, padded nodes repeat the apex (zero-length
  segments), so cumulative sums and path metrics need no masks;
* the spherical apex interval is integrated with a √-substitution that
  removes the 1/√ singularity of dφ/dz, the other intervals with a uniform
  midpoint rule.

The spherical midpoint rule holds [rows, E, n, 64] samples. The JAX package
leaves that to XLA's fusion; here the fan runs in chunks of
(profile, frequency) rows sized so that one chunk's temporaries stay
within :data:`_FAN_BYTES`. The chunk size comes from shapes alone, so no
chunk waits for the card. Rows are independent, so the chunks change no
value. The substitution's samples are formed only on each ray's apex
interval, where the JAX package selects them from every interval: the
selected values are the same.

Outputs are the JAX package's: fixed-size paths (padded with repeated
apex/landing points) and scalar metrics per ray, NaN for an invalid ray
(no turning point / evanescent launch). Host data goes to the CUDA card
unless ``device`` says otherwise (``device="cpu"``); the density's dtype
decides the working dtype.
"""

import math

import torch

from ._util import as_tensors, profile_tensors
from .absorption import absorption_coefficient, collision_frequency
from .config import resolve
from .constants import C_KM_S, R_E
from .ground import _hypot
from .magnetoionic import _find_mu_mup, find_X, find_Y, mode_multiplier

__all__ = ["trace_ray_cartesian_snells", "trace_ray_spherical_snells",
           "trace_rays_cartesian_snells", "trace_rays_spherical_snells"]

_SPH_SUBSTEPS = 64       # midpoint substeps per regular interval
_APEX_SUBSTEPS = 32      # √-substituted substeps on the apex interval
_DEG2RAD = math.pi / 180.0
_NAN = float("nan")
# Temporaries one chunk of fan rows may hold [bytes]; with the counts of
# live tensors below, a row (one profile at one frequency) of E rays on n
# nodes costs E·(n+1)·item·(_SPH_LIVE·_SPH_SUBSTEPS + _NODE_LIVE)
# (spherical) or E·(n+1)·item·_NODE_LIVE (Cartesian).
_FAN_BYTES = 1 << 31
_SPH_LIVE = 6
_NODE_LIVE = 40


def _prepend_ground(alt, *channels):
    """Always materialise a ground node at min(alt[0], 0) (ref :1174-1182).

    If the profile already starts at or below 0 the duplicate node creates
    a zero-length first layer, which contributes nothing anywhere. Each
    channel [..., N] is extended by its first value: the JAX package
    interpolates the channel at the new node, which lies at or below
    alt[0], and that is the first value (clamped, or met exactly).
    """
    out = [torch.cat([torch.clamp(alt[:1], max=0.0), alt])]
    for ch in channels:
        out.append(torch.cat([ch[..., :1], ch], dim=-1))
    return tuple(out)


def _compact_valid(z, mu, mup=None, kappa=None):
    """Stable-sort the valid (finite μ) nodes of each row to the front.

    ``z`` [n] is the shared grid, ``mu`` (and ``mup``/``kappa``) [..., n].
    Returns (z_c, mu_c, mup_c, kappa_c, count): the first ``count`` entries
    of a row are its valid nodes in ascending altitude; the rest are
    +inf/NaN padding; μ' and κ go through the same permutation.
    """
    valid = torch.isfinite(mu)
    order = torch.argsort(torch.where(valid, 0, 1).to(torch.int32), dim=-1,
                          stable=True)
    valid_o = torch.gather(valid, -1, order)
    z_c = torch.where(valid_o, z[order], math.inf)
    mu_c = torch.where(valid_o, torch.gather(mu, -1, order), _NAN)
    mup_c = torch.gather(mup, -1, order) if mup is not None else None
    kappa_c = torch.gather(kappa, -1, order) if kappa is not None else None
    return z_c, mu_c, mup_c, kappa_c, valid.sum(dim=-1)


def _turning_point(z_c, mu_c, count, p, re=None):
    """First crossing of ``w·μ`` through ``p`` per ray (ref :1065-1093,
    :1599); ``w`` is 1 (Cartesian, ``re`` None) or r = re + z (spherical).

    ``z_c``/``mu_c`` [R, n] compacted rows, ``count`` [R], ``p`` [R, E].
    Linear interpolation in the bracketing interval; returns (z_turn,
    i_cross, found), each [R, E]. ``i_cross`` is the first crossing's
    index, 0 when there is none (JAX's argmax of a bool mask).
    """
    n = z_c.shape[-1]
    f = mu_c if re is None else mu_c * (re + z_c)
    pair_ok = (torch.arange(n - 1, device=z_c.device) + 1) < count[:, None]
    pe = p[..., None]
    crossing = (pair_ok[:, None, :] & (f[:, None, :-1] >= pe)
                & (f[:, None, 1:] <= pe))
    found = crossing.any(dim=-1)
    i = torch.argmax(crossing.to(torch.uint8), dim=-1)
    f0, f1 = torch.gather(f, 1, i), torch.gather(f, 1, i + 1)
    t = torch.where(f0 != f1,
                    (f0 - p) / torch.where(f0 != f1, f0 - f1, 1.0), 0.0)
    t = torch.clamp(t, 0.0, 1.0)
    z0 = torch.gather(z_c, 1, i)
    z_turn = z0 + t * (torch.gather(z_c, 1, i + 1) - z0)
    return z_turn, i, found


def _interp_rows(x, xp, fp):
    """``interp_exact`` of each row: x [R, E] on the shared grid xp [n],
    values fp [R, n] (np.interp's exact node hits and edge clamp)."""
    n = xp.shape[0]
    i = torch.searchsorted(xp.contiguous(), x.contiguous(), right=True) - 1
    i = torch.clamp(i, 0, n - 2)
    x0, x1 = xp[i], xp[i + 1]
    f0, f1 = torch.gather(fp, 1, i), torch.gather(fp, 1, i + 1)
    dx = x1 - x0
    t = (x - x0) / torch.where(dx != 0.0, dx, 1.0)
    y = f0 + t * (f1 - f0)
    y = torch.where(x == x1, f1, y)
    y = torch.where(x == x0, f0, y)
    y = torch.where(x <= xp[0], fp[:, :1], y)
    y = torch.where(x >= xp[-1], fp[:, -1:], y)
    return torch.where(torch.isnan(x), _NAN, y)


def _up_leg(prep, alt, i_cross, z_turn, mu_turn):
    """The up-leg node values [R, E, n+1]: nodes 0..i_cross, then the apex
    repeated (z_turn, μ at the apex, μ' and κ interpolated there)."""
    z_c, mu_c, mup_c, kappa_c, _, mup, kappa, _ = prep
    n = z_c.shape[-1]
    k = torch.arange(n + 1, device=z_c.device)
    kk = torch.clamp(k, max=n - 1)
    take = k <= i_cross[..., None]

    def leg(col, apex):
        return torch.where(take, col[:, kk][:, None, :], apex[..., None])

    return (leg(z_c, z_turn), leg(mu_c, mu_turn),
            leg(mup_c, _interp_rows(z_turn, alt, mup)),
            leg(kappa_c, _interp_rows(z_turn, alt, kappa)))


def _mirror(x_up, z_up):
    """Mirror the up-leg about the apex (ref :1233-1237)."""
    x_down = 2.0 * x_up[..., -1:] - x_up.flip(-1)
    x_full = torch.cat([x_up, x_down[..., 1:]], dim=-1)
    z_full = torch.cat([z_up, z_up.flip(-1)[..., 1:]], dim=-1)
    return x_full, z_full


def _seg(up):
    """Segment means along the mirrored path of an up-leg channel."""
    path = torch.cat([up, up.flip(-1)[..., 1:]], dim=-1)
    return 0.5 * (path[..., :-1] + path[..., 1:])


def _metrics(x_full, z_full, ds, mup_seg, ok, kappa_seg=None, mu_seg=None):
    """Path length, group delay, midpoint, ground range (ref :1239-1258).

    The midpoint is the apex of the mirrored path, as in the JAX package
    (exact, where the reference's searchsorted lands within a node).
    """
    group_path = torch.nansum(ds, dim=-1)
    group_delay = torch.nansum(mup_seg / C_KM_S * ds, dim=-1)
    mid_idx = (x_full.shape[-1] - 1) // 2
    x_mid = x_full[..., mid_idx]
    z_mid = z_full[..., mid_idx]
    landed = torch.abs(z_full[..., -1]) <= 1e-3
    ground_range = torch.where(landed, x_full[..., -1], _NAN)
    okp = ok[..., None]
    res = {
        "x": torch.where(okp, x_full, _NAN),
        "z": torch.where(okp, z_full, _NAN),
        "group_path_km": torch.where(ok, group_path, _NAN),
        "group_delay_sec": torch.where(ok, group_delay, _NAN),
        "x_midpoint": torch.where(ok, x_mid, _NAN),
        "z_midpoint": torch.where(ok, z_mid, _NAN),
        "ground_range_km": torch.where(ok, ground_range, _NAN),
        # the reference returns the path midpoint as the apex
        "x_apex_km": torch.where(ok, x_mid, _NAN),
        "z_apex_km": torch.where(ok, z_mid, _NAN),
    }
    if kappa_seg is not None:
        absorb = torch.nansum(torch.where(torch.isfinite(kappa_seg),
                                          kappa_seg * ds, 0.0), dim=-1)
        res["absorption_db"] = torch.where(ok, absorb, _NAN)
    if mu_seg is not None:
        # phase path P = ∫ μ ds (see the JAX module)
        res["phase_path_km"] = torch.where(
            ok, torch.nansum(mu_seg * ds, dim=-1), _NAN)
    return res


def _free_space_ends(kappa_seg):
    """κ of the first and last segment set to 0: the prepended
    ground→alt[0] legs are free space (the clamped extension exists only
    for the reference's μ geometry, ref :1174-1182)."""
    i = torch.arange(kappa_seg.shape[-1], device=kappa_seg.device)
    return torch.where((i == 0) | (i == i[-1]), 0.0, kappa_seg)


def _prep(f0s, alt, ne, babs, bpsi, nu, mode_mult):
    """Frequency-dependent, elevation-independent precomputation.

    ``ne``/``babs``/``bpsi``/``nu`` [G, n] (ground node included), ``f0s``
    [F]. Returns the JAX package's prep tuple with each entry flattened to
    rows of (profile, frequency) pairs: [G·F, n] or [G·F].
    """
    mode = "O" if mode_mult > 0 else "X"
    f = f0s[None, :, None]
    X = find_X(ne[:, None, :], f)
    Y = find_Y(f, babs[:, None, :])
    # per (profile, frequency), as the JAX package vmaps its prep
    mu, mup = _find_mu_mup(X, Y, bpsi[:, None, :].expand_as(X), mode, 2)
    mu = torch.where(torch.isfinite(mu) & (mu > 0.0), mu, _NAN)
    mup = torch.where(torch.isfinite(mup) & (mup > 0.0), mup, _NAN)
    kappa = absorption_coefficient(ne[:, None, :], nu[:, None, :], f,
                                   babs[:, None, :], bpsi[:, None, :], mu,
                                   mode)
    n = alt.shape[0]
    mu, mup, kappa = (v.reshape(-1, n) for v in (mu, mup, kappa))
    z_c, mu_c, mup_c, kappa_c, count = _compact_valid(alt, mu, mup, kappa)
    return z_c, mu_c, mup_c, kappa_c, count, mup, kappa, mu[:, 0]


def _cart_rays(prep, alt, els, re=None):
    """Cartesian rays of each row [R] at each elevation [E] (``re`` is
    unused: the signature is the spherical one)."""
    z_c, mu_c, _, _, count, _, _, mu0 = prep
    s0 = torch.sin((90.0 - els) * _DEG2RAD)
    p = mu0[:, None] * s0[None, :]
    z_turn, i_cross, found = _turning_point(z_c, mu_c, count, p)
    ok = (torch.isfinite(mu0) & (count >= 2))[:, None] & found
    z_up, mu_up, mup_up, kappa_up = _up_leg(prep, alt, i_cross, z_turn, p)

    n = z_c.shape[-1]
    dz = torch.diff(z_up, dim=-1)
    mu_mid = 0.5 * (mu_up[..., :-1] + mu_up[..., 1:])
    # singularity guard on the apex segment (ref :1228)
    apex_seg = torch.arange(n, device=dz.device) == i_cross[..., None]
    pe = p[..., None]
    mu_mid = torch.where(apex_seg, torch.maximum(mu_mid, pe + 1e-8), mu_mid)
    tan_mid = pe / torch.sqrt(torch.clamp(mu_mid * mu_mid - pe * pe,
                                          min=1e-10))
    x_up = torch.cat([torch.zeros_like(dz[..., :1]),
                      torch.cumsum(dz * tan_mid, dim=-1)], dim=-1)

    x_full, z_full = _mirror(x_up, z_up)
    ds = _hypot(torch.diff(x_full, dim=-1), torch.diff(z_full, dim=-1))
    return _metrics(x_full, z_full, ds, _seg(mup_up), ok,
                    _free_space_ends(_seg(kappa_up)), _seg(mu_up))


def _sph_integrand(z_m, mu_m, p, re):
    """dφ/dz = p / (r · sqrt((μ r)² − p²)), the floor keeping it finite.

    The JAX package's floor is p + 1e-8, which float32 cannot hold (p is
    ~6,400 km): there μ r = p, the root is 0 and a ray's range infinite
    (127 of 1,545 landed rays of a 6 × 512 fan, f32, on the card and on
    the CPU alike). So the floor is also at least p·(1 + 4ε) of the dtype;
    in float64 that is below p + 1e-8 for any p < 1e7, and the values are
    the JAX package's.
    """
    r_m = re + z_m
    eps4 = 4.0 * torch.finfo(p.dtype).eps
    mu_r = torch.maximum(mu_m * r_m, torch.maximum(p + 1e-8, p * (1 + eps4)))
    return p / (r_m * torch.sqrt(mu_r * mu_r - p * p))


def _sph_rays(prep, alt, els, re):
    """Spherical rays of each row [R] at each elevation [E]."""
    z_c, mu_c, _, _, count, _, _, mu0 = prep
    theta0 = (90.0 - els) * _DEG2RAD
    r0 = re + alt[0]
    p = (mu0 * r0)[:, None] * torch.sin(theta0)[None, :]
    z_turn, i_cross, found = _turning_point(z_c, mu_c, count, p, re)
    ok = (torch.isfinite(mu0) & (count >= 2))[:, None] & found
    z_up, mu_up, mup_up, kappa_up = _up_leg(prep, alt, i_cross, z_turn,
                                            p / (re + z_turn))

    # dφ/dz = p / (r · sqrt((μ r)² − p²)), μ linear within each interval.
    n = z_c.shape[-1]
    z_a, z_b = z_up[..., :-1], z_up[..., 1:]
    mu_a, mu_b = mu_up[..., :-1], mu_up[..., 1:]
    dz = z_b - z_a
    apex_seg = torch.arange(n, device=dz.device) == i_cross[..., None]
    kw = dict(dtype=dz.dtype, device=dz.device)

    # Regular intervals: uniform midpoint rule with S substeps.
    S = _SPH_SUBSTEPS
    tmid = (torch.arange(S, **kw) + 0.5) / S
    z_m = z_a[..., None] + tmid * dz[..., None]
    mu_m = mu_a[..., None] + (mu_b - mu_a)[..., None] * tmid
    f_m = _sph_integrand(z_m, mu_m, p[..., None, None], re)
    del z_m, mu_m
    dphi_reg = torch.sum(f_m, dim=-1) * dz / S
    del f_m

    # Apex interval: substitute z = z_b − u², u ∈ [0, sqrt(dz)]; the 1/√
    # singularity at z_b cancels analytically. Only each ray's apex
    # interval is sampled.
    def at_apex(v):
        return torch.gather(v, -1, i_cross[..., None])

    za, zb, mua, mub, dza = (at_apex(v) for v in (z_a, z_b, mu_a, mu_b, dz))
    Sa = _APEX_SUBSTEPS
    umax = torch.sqrt(torch.clamp(dza, min=0.0))
    umid = (torch.arange(Sa, **kw) + 0.5) / Sa
    u = umax * umid
    z_mu = zb - u * u
    frac = torch.where(dza != 0.0,
                       (z_mu - za) / torch.where(dza != 0.0, dza, 1.0), 0.0)
    mu_mu = mua + (mub - mua) * frac
    f_u = 2.0 * u * _sph_integrand(z_mu, mu_mu, p[..., None], re)
    dphi_apex = torch.sum(f_u, dim=-1, keepdim=True) * umax / Sa

    dphi = torch.where(apex_seg, dphi_apex, dphi_reg)
    dphi = torch.where(dz > 0.0, dphi, 0.0)
    phi_up = torch.cat([torch.zeros_like(dphi[..., :1]),
                        torch.cumsum(dphi, dim=-1)], dim=-1)

    phi_full, z_full = _mirror(phi_up, z_up)
    x_full = re * phi_full
    r_mid = re + 0.5 * (z_full[..., :-1] + z_full[..., 1:])
    ds = _hypot(r_mid * torch.diff(phi_full, dim=-1),
                torch.diff(z_full, dim=-1))
    return _metrics(x_full, z_full, ds, _seg(mup_up), ok,
                    _free_space_ends(_seg(kappa_up)), _seg(mu_up))


def fan_chunk_rows(n_rows, n_elev, n_nodes, itemsize, spherical):
    """Rows (profile, frequency pairs) per chunk of the fan: as many as
    keep one chunk's temporaries within :data:`_FAN_BYTES`, at least 1."""
    live = _NODE_LIVE + (_SPH_LIVE * _SPH_SUBSTEPS if spherical else 0)
    per_row = n_elev * (n_nodes + 1) * itemsize * live
    return max(1, min(n_rows, _FAN_BYTES // per_row))


def _snell_fan(f0s, els, alt, ne, babs, bpsi, nu, mode_mult, re=None):
    """The (frequency × elevation) fan of every profile.

    ``f0s`` [F], ``els`` [E], ``alt`` [N]; ``ne``/``babs``/``bpsi``/``nu``
    [..., N] or [N] (leading profile dimensions broadcast). ``re`` None
    selects the Cartesian tracer. Returns the metrics [..., F, E] and the
    paths [..., F, E, 2N+3].
    """
    alt, ne, babs, bpsi, nu = _prepend_ground(alt, ne, babs, bpsi, nu)
    lead = torch.broadcast_shapes(ne.shape, babs.shape, bpsi.shape,
                                  nu.shape)[:-1]
    n = alt.shape[0]
    ne, babs, bpsi, nu = (v.expand(*lead, n).reshape(-1, n)
                          for v in (ne, babs, bpsi, nu))
    prep = _prep(f0s, alt, ne, babs, bpsi, nu, mode_mult)
    rays = _cart_rays if re is None else _sph_rays
    R, E = prep[0].shape[0], els.shape[0]
    step = fan_chunk_rows(R, E, n, ne.element_size(), re is not None)
    parts = [rays(tuple(v[r0:r0 + step] for v in prep), alt, els, re)
             for r0 in range(0, R, step)]
    F = f0s.shape[0]
    return {k: torch.cat([pt[k] for pt in parts]).reshape(
        *lead, F, E, *parts[0][k].shape[2:]) for k in parts[0]}


def _fan_inputs(f0_Hz, elevation_deg, alt_km, Ne, Babs, bpsi, nu, device):
    """Tensors in Ne's dtype and device (host data: see the module)."""
    f0, Ne, Babs, bpsi, alt = profile_tensors(f0_Hz, Ne, Babs, bpsi, alt_km,
                                              device=device)
    els, _ = as_tensors(elevation_deg, Ne, dtype=Ne.dtype)
    if nu is None:
        nu = collision_frequency(alt)
    else:
        nu, _ = as_tensors(nu, Ne, dtype=Ne.dtype)
    return f0.reshape(-1), els.reshape(-1), alt, Ne, Babs, bpsi, nu


def _single(fan):
    return {k: v[0, 0] for k, v in fan.items()}


def trace_ray_cartesian_snells(f0_Hz, elevation_deg, alt_km, Ne, Babs, bpsi,
                               mode, nu=None, device=None):
    """Flat-Earth layered Snell trace; API-parity with ref :1096-1268.

    Returns a dict with the reference's keys; ``x``/``z`` are fixed-length
    padded paths (repeated apex/landing nodes carry zero-length segments).
    Beyond the reference, ``absorption_db`` integrates the QL collisional
    loss along the path (``nu``: ν [s⁻¹] on ``alt_km``, defaulting to
    :func:`pyrayhf_tpu_torch.absorption.collision_frequency`) and
    ``phase_path_km`` the phase path ∫μ ds.
    """
    t = _fan_inputs(f0_Hz, elevation_deg, alt_km, Ne, Babs, bpsi, nu,
                    device)
    return _single(_snell_fan(*t, mode_mult=mode_multiplier(mode)))


def trace_ray_spherical_snells(f0_Hz, elevation_deg, alt_km, Ne, Babs, bpsi,
                               mode=None, *, dz_target_km=1.0,
                               apex_boost=200.0, max_substeps=400, R_E=None,
                               nu=None, config=None, device=None):
    """Spherical-Earth layered Snell trace; API-parity with ref :1460-1713.

    ``dz_target_km``/``apex_boost``/``max_substeps`` are accepted for API
    compatibility but unused: the apex interval is integrated with an exact
    √-substitution instead of adaptive substeps. A
    :class:`pyrayhf_tpu_torch.config.SnellConfig` passed as ``config``
    supplies ``mode`` (default 'O') and ``R_E_km`` when not given
    explicitly.
    """
    del dz_target_km, apex_boost, max_substeps
    mode = resolve(config, "mode", mode, "O")
    if R_E is None and config is not None:
        R_E = config.R_E_km
    re = globals()["R_E"] if R_E is None else float(R_E)
    t = _fan_inputs(f0_Hz, elevation_deg, alt_km, Ne, Babs, bpsi, nu,
                    device)
    return _single(_snell_fan(*t, mode_mult=mode_multiplier(mode), re=re))


def trace_rays_cartesian_snells(f0_Hz, elevation_deg, alt_km, Ne, Babs, bpsi,
                                mode, nu=None, device=None):
    """Batched fan: f0 [F], elevation [E] → dict of [F, E, ...] tensors."""
    t = _fan_inputs(f0_Hz, elevation_deg, alt_km, Ne, Babs, bpsi, nu,
                    device)
    return _snell_fan(*t, mode_mult=mode_multiplier(mode))


def trace_rays_spherical_snells(f0_Hz, elevation_deg, alt_km, Ne, Babs, bpsi,
                                mode="O", R_E=None, nu=None, device=None):
    """Batched spherical fan: [F] × [E] → dict of [F, E, ...] tensors."""
    re = globals()["R_E"] if R_E is None else float(R_E)
    t = _fan_inputs(f0_Hz, elevation_deg, alt_km, Ne, Babs, bpsi, nu,
                    device)
    return _snell_fan(*t, mode_mult=mode_multiplier(mode), re=re)
