"""Plain PyTorch reference of PyRayHF's vertical forward operator.

Written from the upstream discretisation (PyRayHF ``library.py``:
``regrid_to_nonuniform_grid``, ``find_mu_mup``, ``find_vh``,
``vertical_forward_operator``), for a stack of profiles on one shared
altitude grid:

1. truncate each profile below its density peak (the nodes from the peak
   up take the value of the node below it);
2. the cutoff function, X (O mode) or X + Y (X mode), made monotone by a
   running maximum; a (profile, frequency) pair reflects where it reaches
   1, found by linear interpolation (``np.interp``), and escapes (NaN)
   where it never does;
3. a stretched grid of ``n_points`` from the grid's first altitude to
   1e-6 km below the reflection height, fine near reflection
   (``1 − (e^{10(1−u)} − 1)/(e^{10} − 1)``), and the profile resampled on
   it by linear interpolation;
4. the Appleton–Hartree group index μ′ on that grid, and
   vh = alt_min + Σ μ′·Δh (NaN samples left out; a pair whose sum is 0
   is NaN).

Two departures from the upstream code, both those of the JAX package the
program ports, so that the reference judges the program by the values
that package gives: the O-mode Appleton–Hartree quotient is evaluated in
its cancellation-free form (the upstream expression loses most of its
digits at 1 − X ~ 1e-9, a few percent of μ′ there), and a sample with μ′
≤ 0 or above 1e7 counts as an escaped sample. The unmagnetised branch
(μ′ = 1/√(1 − X)) is taken for a profile whose |Y| is below 1e-12 at every
node and frequency.

Everything runs in float64, over the reflecting pairs only, in blocks of
about ``BLOCK_POINTS`` grid points, so that P = 20,000 fits beside the
program's state. It imports nothing of the program and nothing of JAX.
"""

import math

import torch

CP = 8.97866275                  # f_p [Hz] = CP · sqrt(n_e [m^-3])
G_P = 2.799249247e10             # f_ce [Hz] = G_P · |B| [T]
DH_BACKOFF_KM = 1e-6             # the grid ends this far below reflection
MUP_CEILING = 1e7
Y_TOL = 1e-12
SHARPNESS = 10.0
BLOCK_POINTS = 1 << 23

__all__ = ["vertical_forward", "reflecting_pairs", "stretched_multiplier",
           "appleton_hartree"]


def stretched_multiplier(n_points, device):
    """The stretched grid's multiplier in [0, 1], fine near 1 (float64)."""
    u = torch.arange(n_points, dtype=torch.float64, device=device)
    u = u / max(n_points - 1, 1)
    u[-1] = 1.0
    factor = (torch.exp(SHARPNESS * (1.0 - u)) - 1.0) / (
        math.exp(SHARPNESS) - 1.0)
    return 1.0 - factor


def _truncate(a, ind_max):
    """Nodes at and above each row's peak index take the node below it."""
    idx = torch.arange(a.shape[-1], device=a.device)
    below = torch.clamp(ind_max - 1, min=0)[:, None]
    return torch.where(idx < ind_max[:, None], a,
                       torch.gather(a, 1, below))


def interp(x, xp, fp):
    """``np.interp`` row by row: ``xp``/``fp`` [R, K] (xp nondecreasing),
    ``x`` [R, M]; values beyond the ends take the end values."""
    K = xp.shape[1]
    i = torch.searchsorted(xp.contiguous(), x.contiguous(), right=True)
    i = torch.clamp(i, 1, K - 1)
    x0, x1 = torch.gather(xp, 1, i - 1), torch.gather(xp, 1, i)
    f0, f1 = torch.gather(fp, 1, i - 1), torch.gather(fp, 1, i)
    dx = x1 - x0
    flat = dx == 0.0
    out = torch.where(flat, f0,
                      f0 + (x - x0) / torch.where(flat, 1.0, dx) * (f1 - f0))
    out = torch.where(x < xp[:, :1], fp[:, :1], out)
    return torch.where(x > xp[:, -1:], fp[:, -1:], out)


def plasma_X(den, f_hz):
    """X = (f_p / f)², f_p = CP·sqrt(n_e)."""
    return (torch.sqrt(den) * CP) ** 2 / f_hz ** 2


def gyro_Y(bmag, f_hz):
    """Y = f_ce / f."""
    return G_P * bmag / f_hz


def appleton_hartree(X, Y, psi_deg, mode_mult):
    """μ′ of the magnetised Appleton–Hartree index, NaN where the wave
    does not propagate (under the root < 0, μ > 1, μ ≤ 0)."""
    psi = torch.deg2rad(psi_deg)
    sinp, cosp = torch.sin(psi), torch.cos(psi)
    YT, YL = Y * sinp, Y * cosp
    Xm1 = 1.0 - X
    beta = torch.sqrt(0.25 * YT ** 4 + YL ** 2 * Xm1 ** 2)
    if mode_mult > 0:
        # (1−X) − ½YT² + β = (1−X) + YL²(1−X)²/(β + ½YT²), and the quotient
        # 1 − X(1−X)/D = ((1−X)² + s)/D, free of cancellation near X = 1
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
    return torch.where(mu > 0.0, mup, float("nan"))


def _isotropic(X):
    mu2 = 1.0 - X
    return torch.where(mu2 > 0.0, 1.0 / torch.sqrt(mu2), float("nan"))


def _profiles(den, bmag, bpsi, alt):
    """Float64 copies truncated at each row's peak, and alt as [B, N]."""
    den, bmag, bpsi = (a.to(torch.float64) for a in (den, bmag, bpsi))
    alt = alt.to(torch.float64).expand_as(den)
    ind_max = torch.argmax(den, dim=1)
    return [_truncate(a, ind_max) for a in (den, bmag, bpsi, alt)]


def _cutoff(den_t, bmag_t, f_hz, mode_mult):
    """The monotone cutoff function [b, F, N] of truncated rows [b, N]."""
    X = plasma_X(den_t[:, None, :], f_hz[None, :, None])
    if mode_mult < 0:
        X = X + gyro_Y(bmag_t[:, None, :], f_hz[None, :, None])
    return torch.cummax(X, dim=2).values


def reflecting_pairs(freq_mhz, den, bmag, bpsi, alt, mode_mult):
    """[B, F] bool: the pairs whose cutoff function reaches 1 (the rest
    escape). Blocks of profiles keep the [b, F, N] cutoff near
    ``BLOCK_POINTS``."""
    den_t, bmag_t, _, _ = _profiles(den, bmag, bpsi, alt)
    f_hz = freq_mhz.to(torch.float64) * 1e6
    B, N = den_t.shape
    rows = max(1, BLOCK_POINTS // (f_hz.numel() * N))
    return torch.cat([_cutoff(den_t[b:b + rows], bmag_t[b:b + rows], f_hz,
                              mode_mult)[:, :, -1] >= 1.0
                      for b in range(0, B, rows)])


def _vh_pairs(mult, f_hz, crit, den_r, bmag_r, bpsi_r, alt_r, unmag,
              alt_min, mode_mult):
    """vh [K] of K reflecting pairs: rows [K, N] of their profiles, the
    frequency [K], the reflection height [K] and whether the profile is
    unmagnetised [K] of each."""
    alt0 = alt_r[:, :1]
    new_alt = mult[None, :] * (crit[:, None] - alt0) + alt0      # [K, P]
    dh = torch.cat([torch.diff(new_alt, dim=1),
                    torch.full_like(new_alt[:, :1], DH_BACKOFF_KM)], dim=1)
    den = interp(new_alt, alt_r, den_r)
    bm = interp(new_alt, alt_r, bmag_r)
    bp = interp(new_alt, alt_r, bpsi_r)
    f = f_hz[:, None]
    X = plasma_X(den, f)
    Y = gyro_Y(bm, f)
    mup = appleton_hartree(X, Y, bp, mode_mult)
    mup = torch.where((mup > 0.0) & (mup <= MUP_CEILING), mup, float("nan"))
    mup = torch.where(unmag[:, None], _isotropic(X), mup)
    ih = torch.nansum(mup * dh, dim=1)
    return torch.where(ih == 0.0, float("nan"), ih + alt_min)


def vertical_forward(freq_mhz, den, bmag, bpsi, alt, mode_mult, n_points,
                     rows=None):
    """vh [len(rows), F] in km (float64; NaN where the ray escapes).

    ``den``, ``bmag`` [T], ``bpsi`` [deg]: [B, N] profiles on the shared
    grid ``alt`` [N] km; ``freq_mhz`` [F]; ``mode_mult`` +1 (O) or −1 (X);
    ``rows`` the profiles to compute (default all).
    """
    dev = den.device
    if rows is None:
        rows = torch.arange(den.shape[0], device=dev)
    den_t, bmag_t, bpsi_t, alt_t = (a[rows] for a in _profiles(
        den, bmag, bpsi, alt))
    alt_min = alt.to(torch.float64).amin()
    f_hz = freq_mhz.to(torch.float64) * 1e6
    mult = stretched_multiplier(n_points, dev)
    B, N = den_t.shape
    F = f_hz.numel()
    out = torch.full((B, F), float("nan"), dtype=torch.float64, device=dev)
    # the unmagnetised branch, decided per profile (see the module doc)
    unmag = gyro_Y(bmag_t.abs().amax(dim=1), f_hz.amin()) < Y_TOL
    per_pair = max(1, BLOCK_POINTS // n_points)
    prow = max(1, BLOCK_POINTS // (F * N))
    for b0 in range(0, B, prow):
        sl = slice(b0, b0 + prow)
        fcrit = _cutoff(den_t[sl], bmag_t[sl], f_hz, mode_mult)
        valid = fcrit[:, :, -1] >= 1.0
        bi, fi = torch.nonzero(valid, as_tuple=True)
        for k0 in range(0, bi.numel(), per_pair):
            b, f = bi[k0:k0 + per_pair], fi[k0:k0 + per_pair]
            one = torch.ones((b.numel(), 1), dtype=torch.float64, device=dev)
            crit = interp(one, fcrit[b, f], alt_t[sl][b])[:, 0] - DH_BACKOFF_KM
            out[b0 + b, f] = _vh_pairs(
                mult, f_hz[f], crit, den_t[sl][b], bmag_t[sl][b],
                bpsi_t[sl][b], alt_t[sl][b], unmag[sl][b], alt_min,
                mode_mult)
    return out
