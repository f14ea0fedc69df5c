"""Non-parametric true-height inversion: ionogram vh(f) → Ne(h), in PyTorch.

Port of ``pyrayhf_tpu.true_height`` (lamination on the full magnetoionic
operator; see the JAX module for the method and its classical caveats):

* the unknowns are the reflection heights ``h_j`` of the observed
  frequencies ``f_1 < … < f_K``, whose densities are known (O: X = 1;
  X: X + Y = 1 with the gyrofrequency at the knot);
* ``vh(f_i)`` depends only on the profile below ``h_i`` and rises with
  ``h_i``, so the knots solve bottom-up, each by a fixed-length bisection
  whose every step evaluates the single-frequency masked operator
  (:func:`pyrayhf_tpu_torch.forward.vh_and_mask`);
* :func:`retrieve_profile_joint` interleaves O and X echoes by knot density
  and can insert a POLAN-style E-valley.

Where the JAX package vmaps over start-gap candidates, (gap, width, depth)
candidates or ionograms, the lamination here runs them as one batch
dimension C; the per-knot mode of the joint solve is known on the host, so
its ``lax.cond`` is a host branch. Under float32 (the dtype of the
inputs) the bisection is capped at 24 steps, where its midpoint stalls.
Host data goes to the CUDA card unless ``device`` says otherwise
(``device="cpu"``).
"""

import numpy as np
import torch

from ._util import as_tensors, host_f64, scalar_like
from .constants import CP, G_P
from .forward import vh_and_mask
from .grid import interp
from .magnetoionic import freq2den, mode_multiplier

__all__ = ["retrieve_profile", "retrieve_profile_batch",
           "retrieve_profile_joint"]

# The lid above a trial knot must keep RISING: the regrid truncates the
# profile PEAK-EXCLUSIVE (ref :371-375), so a flat lid's single argmax node
# gets cut and the cutoff crossing vanishes — a rising wedge leaves many
# super-cutoff nodes in place.
_SEED_FRAC = 0.05       # floor plasma frequency = this × f_1 (start model)


def _check_inputs(f_sorted_hz, b_mag, mode_mult, n_passes, n_bisect, dtype):
    """Host-side validation shared by the entry points.

    Returns the effective ``n_bisect``: capped at 24 when the working dtype
    is float32, where the midpoint update stalls at float resolution.
    """
    if n_passes < 1:
        raise ValueError("n_passes must be >= 1")
    if mode_mult < 0:
        # the X-mode knot relation fN² = f(f − fH) is only meaningful
        # above the gyrofrequency
        f_gyro_max = float(G_P * np.max(host_f64(b_mag)))
        f_min = float(host_f64(f_sorted_hz)[0])
        if f_min <= f_gyro_max:
            raise ValueError(
                f"X-mode true-height inversion needs every frequency "
                f"above the gyrofrequency (min f = {f_min / 1e6:.3f} MHz "
                f"<= max fH = {f_gyro_max / 1e6:.3f} MHz) — drop the "
                f"sub-gyro samples")
    if dtype != torch.float64:
        n_bisect = min(n_bisect, 24)
    return n_bisect


def _maximum(a, b):
    """``jnp.maximum`` of a tensor and a tensor or number."""
    return torch.maximum(a, scalar_like(b, a))


def _minimum(a, b):
    return torch.minimum(a, scalar_like(b, a))


def _retrieve_profile_core(f_sorted_hz, obs_sorted, alt, b_mag, b_psi,
                           mode_mult, n_points, n_bisect, n_passes,
                           start_gap, mm_seq=None, valley_iv=None,
                           valley_w=0.0, valley_d=0.0, valley_ne=0.0):
    """Laminate C problems at once: ``obs_sorted`` [C, K] at the shared
    ascending ``f_sorted_hz`` [K]; ``start_gap``, ``valley_w`` and
    ``valley_d`` are [C] (or numbers). ``mm_seq`` (host array [K] of ±1)
    selects the per-knot mode of the joint solve; None uses ``mode_mult``
    for every knot. Returns (h [C, K], ne [C, K], den_fit [C, N],
    vh_fit [C, K]).
    """
    C, k = obs_sorted.shape
    N = alt.shape[0]
    like = dict(dtype=alt.dtype, device=alt.device)

    def col(v):
        return torch.as_tensor(v, **like).expand(C) if not isinstance(
            v, torch.Tensor) or v.ndim == 0 else v.to(**like)

    start_gap, valley_w, valley_d = col(start_gap), col(valley_w), \
        col(valley_d)
    valley_ne = torch.as_tensor(valley_ne, **like)
    per_knot = mm_seq is not None
    mm_host = (np.asarray(mm_seq, dtype=float) if per_knot
               else np.full(k, float(mode_mult)))
    freq_mhz = f_sorted_hz / 1e6
    alt0, alt_top = alt[0], alt[-1]
    ne_floor = freq2den(_SEED_FRAC * f_sorted_hz[0])
    dmax = torch.max(torch.diff(alt))
    # knot ceiling: keep >= 2 grid nodes above any trial knot so the
    # peak-exclusive flat-extension cannot erase the cutoff crossing on
    # coarse grids; w is the final peak-wedge width for the same reason
    h_ceil = alt_top - 2.0 * dmax
    w = 3.0 * dmax
    bmag_c = b_mag.expand(C, N)
    bpsi_c = b_psi.expand(C, N)
    altr = alt[None, :]

    def vh_one(i, den):
        vh, valid = vh_and_mask(freq_mhz[i:i + 1], den, bmag_c, bpsi_c, alt,
                                mode_mult=mm_host[i], n_points=n_points)
        return torch.where(valid[:, 0], vh[:, 0], torch.inf)

    def knot_density(i, h):
        """Reflection density of knot i at trial heights h [C]."""
        if mm_host[i] > 0:
            return freq2den(f_sorted_hz[i]).expand(C)
        f_hz = f_sorted_hz[i]
        f_gyro = G_P * interp(h, alt, b_mag)
        return freq2den(torch.sqrt(_maximum(f_hz * (f_hz - f_gyro), 0.0)))

    def place_knots(lid_slopes):
        """One lamination pass: every knot bottom-up → (h, ne) [C, K]."""
        den_below = torch.where(altr <= alt0, ne_floor, 0.0).expand(C, N)
        h_prev = alt0.expand(C)
        ne_prev = ne_floor.expand(C)
        hs, nes = [], []
        for i in range(k):
            obs_i = obs_sorted[:, i]
            gap = start_gap if i == 0 else torch.full_like(start_gap,
                                                           torch.inf)
            lid_prev = lid_slopes[:, i]
            # the first knot above the E-valley anchors at the valley exit
            first_above = valley_iv is not None and i == valley_iv + 1
            w_eff = valley_w if first_above else torch.zeros_like(valley_w)

            def candidate(h):
                """Profile [C, N] with the trial knot (h, ne_i) on top of
                den_below, and ne_i [C] (see the JAX module)."""
                ne_i = knot_density(i, h)
                anchor_h0 = torch.maximum(h_prev, h - gap)
                anchor_ne0 = torch.where(anchor_h0 > h_prev, ne_floor,
                                         ne_prev)
                if first_above:
                    anchor_h = torch.minimum(h_prev + w_eff, h - 1e-3)
                    anchor_ne = valley_ne.expand(C)
                else:
                    anchor_h, anchor_ne = anchor_h0, anchor_ne0
                slope = (ne_i - anchor_ne) / _maximum(h - anchor_h, 1e-9)
                seg = anchor_ne[:, None] + (altr - anchor_h[:, None]) \
                    * slope[:, None]
                # floor the lid slope so degenerate knots still rise
                lid_slope = torch.maximum(
                    torch.where(torch.isfinite(lid_prev), lid_prev, slope),
                    ne_i * 1e-6)
                lid = ne_i[:, None] + lid_slope[:, None] * (altr - h[:, None])
                if first_above:
                    # valley span: rise to the E peak over the first 15% of
                    # the width, dip to (1 − D)·ne_V at the midpoint of the
                    # remainder, return to ne_V at the exit
                    ws = _maximum(w_eff, 1e-9)[:, None]
                    hp = h_prev[:, None]
                    h_pk = hp + 0.15 * ws
                    h_bot = hp + 0.575 * ws
                    u = altr - hp
                    rise = ne_prev[:, None] + (valley_ne - ne_prev[:, None]) \
                        * u / (0.15 * ws)
                    vd = valley_d[:, None]
                    down = valley_ne * (1.0 - vd * (altr - h_pk)
                                        / (h_bot - h_pk))
                    frac = (hp + ws - altr) / (ws - 0.575 * ws)
                    up = valley_ne * (1.0 - vd * _minimum(_maximum(frac, 0.0),
                                                          1.0))
                    mid = torch.where(altr <= h_pk, rise,
                                      torch.where(altr <= h_bot, down, up))
                else:
                    mid = ne_floor
                den = torch.where(
                    altr <= h_prev[:, None], den_below,
                    torch.where(altr <= anchor_h[:, None], mid,
                                torch.where(altr <= h[:, None], seg, lid)))
                return den, ne_i

            # vh(h) rises with h and vh >= h, so the observed virtual
            # height bounds the true height from above; the ceiling keeps
            # >= 2 grid nodes above the knot and hi >= lo keeps the bracket
            # proper when a saturated predecessor sits at the ceiling
            lo = h_prev + w_eff + 1e-2
            hi = torch.maximum(
                torch.minimum(torch.maximum(obs_i, lo + 1e-2), h_ceil),
                lo + 1e-2)
            for _ in range(n_bisect):
                mid_h = 0.5 * (lo + hi)
                go_down = vh_one(i, candidate(mid_h)[0]) > obs_i
                lo, hi = (torch.where(go_down, lo, mid_h),
                          torch.where(go_down, mid_h, hi))
            h_i = 0.5 * (lo + hi)
            den_i, ne_i = candidate(h_i)
            # freeze the profile below the new knot for the next knots
            den_below = torch.where(altr <= h_i[:, None], den_i, 0.0)
            h_prev, ne_prev = h_i, ne_i
            hs.append(h_i)
            nes.append(ne_i)
        return torch.stack(hs, dim=1), torch.stack(nes, dim=1)

    lid_slopes = torch.full((C, k), torch.nan, **like)
    for _ in range(n_passes):
        h, ne = place_knots(lid_slopes)
        # refinement passes replace the continuation lid above knot i with
        # this pass's slope toward knot i+1 (the last knot keeps NaN)
        lid_slopes = torch.cat(
            [torch.diff(ne, dim=1) / _maximum(torch.diff(h, dim=1), 1e-9),
             torch.full((C, 1), torch.nan, **like)], dim=1)
        if valley_iv is not None:
            # the lid above the LAST E knot is the valley's rise to the E
            # peak, not the inter-knot slope across the whole valley
            iv = int(valley_iv)
            rise_slope = (valley_ne - ne[:, iv]) / _maximum(0.15 * valley_w,
                                                            1e-9)
            lid_slopes[:, iv] = torch.where(
                valley_w > 1e-6, torch.maximum(rise_slope, ne[:, iv] * 1e-6),
                lid_slopes[:, iv])

    # final profile: start ramp + all knots + a peak wedge wide enough to
    # survive the peak-exclusive truncation, then a descending (unsensed)
    # topside; every node above its predecessor so interp sees sorted xp
    h_peak = torch.maximum(_minimum(h[:, -1] + w, alt_top - 1e-3),
                           h[:, -1] + 1e-3)
    slope_top = torch.maximum((ne[:, -1] - ne[:, -2])
                              / _maximum(h[:, -1] - h[:, -2], 1e-9),
                              ne[:, -1] * 1e-6)
    anchor0 = torch.minimum(_maximum(h[:, 0] - start_gap, alt0 + 1e-3),
                            h[:, 0] - 1e-3)
    if valley_iv is None:
        h_mid, ne_mid = h, ne
    else:
        # splice the valley nodes (E peak, dip bottom, exit) between the
        # last E knot and the first F knot, clipped below the next knot
        iv = int(valley_iv)
        lim = h[:, iv + 1]
        v_pk = torch.minimum(torch.maximum(h[:, iv] + 0.15 * valley_w,
                                           h[:, iv] + 1e-3), lim - 3e-3)
        v_bot = torch.minimum(torch.maximum(h[:, iv] + 0.575 * valley_w,
                                            v_pk + 1e-3), lim - 2e-3)
        v_exit = torch.minimum(torch.maximum(h[:, iv] + valley_w,
                                             v_bot + 1e-3), lim - 1e-3)
        ne_v = valley_ne.expand(C)
        h_mid = torch.cat([h[:, :iv + 1], v_pk[:, None], v_bot[:, None],
                           v_exit[:, None], h[:, iv + 1:]], dim=1)
        ne_mid = torch.cat([ne[:, :iv + 1], ne_v[:, None],
                            (ne_v * (1.0 - valley_d))[:, None],
                            ne_v[:, None], ne[:, iv + 1:]], dim=1)
    h_all = torch.cat([(alt[:1] - 1e-6).expand(C, 1), anchor0[:, None],
                       h_mid, h_peak[:, None],
                       torch.maximum(alt[-1:] + 1e-3,
                                     h_peak[:, None] + 1e-3)], dim=1)
    ne_all = torch.cat([ne_floor.expand(C, 1), ne_floor.expand(C, 1),
                        ne_mid,
                        (ne[:, -1] + slope_top * (h_peak - h[:, -1]))[:, None],
                        ne[:, -1:] * 0.5], dim=1)
    den_fit = interp(alt.expand(C, N), h_all, ne_all)
    if per_knot:
        vh_o, val_o = vh_and_mask(freq_mhz, den_fit, bmag_c, bpsi_c, alt,
                                  mode_mult=1.0, n_points=n_points)
        vh_x, val_x = vh_and_mask(freq_mhz, den_fit, bmag_c, bpsi_c, alt,
                                  mode_mult=-1.0, n_points=n_points)
        mm_t = torch.as_tensor(mm_host, **like)
        vh_fit = torch.where(mm_t > 0,
                             torch.where(val_o, vh_o, torch.nan),
                             torch.where(val_x, vh_x, torch.nan))
    else:
        vh_fit, valid = vh_and_mask(freq_mhz, den_fit, bmag_c, bpsi_c, alt,
                                    mode_mult=mode_mult, n_points=n_points)
        vh_fit = torch.where(valid, vh_fit, torch.nan)
    return h, ne, den_fit, vh_fit


def _rms(vh, obs):
    """sqrt(nanmean((vh − obs)²)) along the last axis."""
    return torch.sqrt(torch.nanmean((vh - obs) ** 2, dim=-1))


def retrieve_profile(f_in, vh_obs, alt, b_mag, b_psi, mode="O",
                     n_points=200, n_bisect=36, n_passes=2,
                     start_gap_km=20.0, device=None):
    """Invert an ionogram into a monotone Ne(h) profile (true height).

    ``f_in`` in MHz, ``vh_obs`` in km; non-finite pairs are dropped.
    Returns a dict: ``h_knots_km`` [K] (reflection height of each observed
    frequency), ``ne_knots_m3`` [K], ``den_fit`` [N_alt] (the fitted
    profile on ``alt``), ``vh_fit`` [K], ``rms_km`` and ``f_sorted_hz``
    [K] (the frequencies fitted, ascending), plus ``start_gap_km``.

    ``n_bisect`` bisection steps resolve each height to (vh_obs − h_prev)
    / 2**n_bisect km; under float32 inputs it is capped at 24.
    ``n_passes`` lamination sweeps (later passes use the previous pass's
    inter-knot slope as the lid above each trial knot). ``start_gap_km``
    is the start model (ionization rises from a small floor over this many
    km below the first reflection); an ARRAY of candidate gaps laminates
    every candidate as one batch and keeps the smallest-rms fit (the result
    then also carries ``rms_by_gap_km``).
    """
    f, obs, alt, b_mag, b_psi = as_tensors(f_in, vh_obs, alt, b_mag, b_psi,
                                           device=device)
    f = f * 1e6
    ok = torch.isfinite(f) & torch.isfinite(obs)
    order = torch.argsort(torch.where(ok, f, torch.inf), stable=True)
    k = int(ok.sum())
    if k < 2:
        raise ValueError("retrieve_profile needs at least 2 finite "
                         "(frequency, virtual height) samples")
    f_sorted = f[order][:k]
    obs_sorted = obs[order][:k]
    mode_mult = mode_multiplier(mode)
    n_bisect = _check_inputs(f_sorted, b_mag, mode_mult, n_passes, n_bisect,
                             f.dtype)

    def run(gaps):
        return _retrieve_profile_core(
            f_sorted, obs_sorted.expand(gaps.shape[0], k), alt, b_mag, b_psi,
            mode_mult, n_points, n_bisect, n_passes, start_gap=gaps)

    h, ne, den_fit, vh_fit, extra = _run_gap_candidates(run, start_gap_km,
                                                        obs_sorted)
    out = {"h_knots_km": h, "ne_knots_m3": ne, "den_fit": den_fit,
           "vh_fit": vh_fit, "rms_km": _rms(vh_fit, obs_sorted),
           "f_sorted_hz": f_sorted}
    out.update(extra)
    return out


def _run_gap_candidates(run, start_gap_km, obs_sorted):
    """Run the lamination for one start gap or a candidate array.

    A candidate array laminates as one batch and the smallest-rms fit
    wins. Returns (h, ne, den_fit, vh_fit, extra-dict).
    """
    like = dict(dtype=obs_sorted.dtype, device=obs_sorted.device)
    if np.ndim(start_gap_km) == 0:
        out = run(torch.full((1,), float(start_gap_km), **like))
        return (*(o[0] for o in out), {"start_gap_km": float(start_gap_km)})
    gaps = torch.as_tensor(np.asarray(start_gap_km, dtype=np.float64),
                           device=like["device"]).to(like["dtype"])
    h_g, ne_g, den_g, vh_g = run(gaps)
    rms_g = _rms(vh_g, obs_sorted[None, :]).cpu().numpy()
    best = int(np.nanargmin(rms_g))
    return (h_g[best], ne_g[best], den_g[best], vh_g[best],
            {"start_gap_km": float(gaps[best]), "rms_by_gap_km": rms_g})


def _run_joint_candidates(run, gaps, widths, depths, obs_sorted):
    """Grid search over (start gap × valley width × valley depth).

    Each argument may be a number or a 1-D candidate array; the whole
    product laminates as one batch and the smallest-rms combination wins.
    """
    g, w, d = (np.atleast_1d(np.asarray(a, dtype=float))
               for a in (gaps, widths, depths))
    G, W, D = np.meshgrid(g, w, d, indexing="ij")
    cand = np.stack([G.ravel(), W.ravel(), D.ravel()], axis=1)
    ct = torch.as_tensor(cand, device=obs_sorted.device).to(obs_sorted.dtype)
    h_g, ne_g, den_g, vh_g = run(ct[:, 0], ct[:, 1], ct[:, 2])
    rms_g = _rms(vh_g, obs_sorted[None, :]).cpu().numpy()
    best = int(np.nanargmin(rms_g))
    return (h_g[best], ne_g[best], den_g[best], vh_g[best],
            {"start_gap_km": float(cand[best, 0]),
             "valley_width_km": float(cand[best, 1]),
             "valley_depth": float(cand[best, 2]),
             "rms_by_candidate_km": rms_g, "candidates": cand})


def _freq2den_np(f_hz):
    """freq2den on the host (numpy), for the ordering of the joint echoes."""
    return np.square(np.asarray(f_hz, dtype=float) / CP)


def retrieve_profile_joint(f_o_in, vh_o, f_x_in, vh_x, alt, b_mag, b_psi,
                           n_points=200, n_bisect=36, n_passes=2,
                           start_gap_km=20.0, valley_f_mhz=None,
                           valley_width_km=0.0, valley_depth=0.0,
                           device=None):
    """Joint O+X true-height inversion with an optional E-valley.

    Each echo, O or X, maps to a known plasma density at its reflection
    height, so interleaving the two traces by knot density keeps the
    triangular lamination (X echoes are ordered with f_H at the observed
    virtual height; the solve uses f_H at the trial knot). An array of
    ``start_gap_km`` candidates is laminated as one batch and the smallest
    joint rms wins. ``valley_f_mhz`` (≈ foE) anchors a triangular valley
    insert above the last echo reflecting at or below that plasma
    frequency, with ``valley_width_km``/``valley_depth`` numbers or
    candidate arrays searched jointly with the gap.

    Args as :func:`retrieve_profile` with the trace split into
    ``(f_o_in [MHz], vh_o)`` and ``(f_x_in [MHz], vh_x)``; either may be
    empty. Returns the :func:`retrieve_profile` dict plus ``mode_knots``
    (+1 = O, −1 = X per fitted echo) and the chosen candidate values (with
    ``rms_by_gap_km``, or ``rms_by_candidate_km`` and ``candidates``).
    """
    f_o = np.atleast_1d(host_f64(f_o_in)) * 1e6
    o_o = np.atleast_1d(host_f64(vh_o))
    f_x = np.atleast_1d(host_f64(f_x_in)) * 1e6
    o_x = np.atleast_1d(host_f64(vh_x))
    ok_o = np.isfinite(f_o) & np.isfinite(o_o)
    ok_x = np.isfinite(f_x) & np.isfinite(o_x)
    f_o, o_o = f_o[ok_o], o_o[ok_o]
    f_x, o_x = f_x[ok_x], o_x[ok_x]
    if f_o.size + f_x.size < 2:
        raise ValueError("retrieve_profile_joint needs at least 2 finite "
                         "(frequency, virtual height) samples across the "
                         "two traces")
    alt_t, bm_t, bp_t = as_tensors(alt, b_mag, b_psi, device=device)
    if f_x.size:
        n_bisect = _check_inputs(np.sort(f_x), b_mag, -1.0, n_passes,
                                 n_bisect, alt_t.dtype)
    else:
        n_bisect = _check_inputs(np.sort(f_o), b_mag, 1.0, n_passes,
                                 n_bisect, alt_t.dtype)

    # interleave by (approximate) knot density — O exact, X with f_H at
    # the observed virtual height (ordering only)
    alt_n, bm_n = host_f64(alt_t), host_f64(bm_t)
    ne_o = _freq2den_np(f_o)
    fH_x = G_P * np.interp(np.clip(o_x, alt_n[0], alt_n[-1]), alt_n, bm_n)
    ne_x = _freq2den_np(np.sqrt(np.maximum(f_x * (f_x - fH_x), 0.0)))
    order = np.argsort(np.concatenate([ne_o, ne_x]))
    like = dict(dtype=alt_t.dtype, device=alt_t.device)
    f_s = torch.as_tensor(np.concatenate([f_o, f_x])[order]).to(**like)
    obs_s = torch.as_tensor(np.concatenate([o_o, o_x])[order]).to(**like)
    mm_s = np.concatenate([np.ones(f_o.size), -np.ones(f_x.size)])[order]

    valley_iv, ne_anchor = None, 0.0
    if valley_f_mhz is not None:
        # last interleaved echo whose (approximate) knot density is at or
        # below the valley-anchor plasma frequency
        ne_anchor = float(_freq2den_np(float(valley_f_mhz) * 1e6))
        ne_interleaved = np.concatenate([ne_o, ne_x])[order]
        valley_iv = int(np.searchsorted(ne_interleaved,
                                        ne_anchor * (1 + 1e-9)) - 1)
        if valley_iv < 0 or valley_iv >= ne_interleaved.size - 1:
            raise ValueError(
                "valley_f_mhz must sit strictly between the lowest and "
                "highest echo plasma frequencies (no E echo below it, or "
                "no F echo above it)")
        if ne_interleaved[valley_iv] > 0.995 * ne_anchor:
            # a shelf at (nearly) a sounded cutoff density gives that echo
            # unbounded group retardation — degenerate by physics
            raise ValueError(
                "valley_f_mhz must exceed the highest E-region echo's "
                "plasma frequency by a finite margin (>~0.25%); got an "
                "echo within 0.5% of the valley anchor density")

    def run(g, vw, vd):
        return _retrieve_profile_core(
            f_s, obs_s.expand(g.shape[0], -1), alt_t, bm_t, bp_t, 0.0,
            n_points, n_bisect, n_passes, start_gap=g, mm_seq=mm_s,
            valley_iv=valley_iv, valley_w=vw, valley_d=vd,
            valley_ne=ne_anchor)

    if valley_iv is None:
        h, ne, den_fit, vh_fit, extra = _run_gap_candidates(
            lambda g: run(g, 0.0, 0.0), start_gap_km, obs_s)
    else:
        h, ne, den_fit, vh_fit, extra = _run_joint_candidates(
            run, start_gap_km, valley_width_km, valley_depth, obs_s)
    out = {"h_knots_km": h, "ne_knots_m3": ne, "den_fit": den_fit,
           "vh_fit": vh_fit, "rms_km": _rms(vh_fit, obs_s),
           "f_sorted_hz": f_s, "mode_knots": mm_s}
    out.update(extra)
    return out


def retrieve_profile_batch(f_in, vh_obs_batch, alt, b_mag, b_psi, mode="O",
                           n_points=200, n_bisect=36, n_passes=2,
                           start_gap_km=20.0, device=None):
    """Batched true-height inversion: ``vh_obs_batch`` [B, K] → stacked
    results (one lamination over the batch).

    All B ionograms share the frequency grid ``f_in`` [MHz] and must be
    all-finite — pre-filter with :func:`retrieve_profile` if traces have
    gaps.
    """
    f, obs, alt, b_mag, b_psi = as_tensors(f_in, vh_obs_batch, alt, b_mag,
                                           b_psi, device=device)
    f = f * 1e6
    obs = torch.atleast_2d(obs)
    if f.shape[0] < 2:
        raise ValueError("retrieve_profile_batch needs at least 2 "
                         "(frequency, virtual height) samples")
    if not bool(torch.isfinite(f).all() & torch.isfinite(obs).all()):
        raise ValueError("retrieve_profile_batch requires all-finite "
                         "frequencies and traces (pre-filter gapped "
                         "traces with retrieve_profile)")
    order = torch.argsort(f, stable=True)
    f_sorted = f[order]
    obs_sorted = obs[:, order]
    mode_mult = mode_multiplier(mode)
    n_bisect = _check_inputs(f_sorted, b_mag, mode_mult, n_passes, n_bisect,
                             f.dtype)
    h, ne, den_fit, vh_fit = _retrieve_profile_core(
        f_sorted, obs_sorted, alt, b_mag, b_psi, mode_mult, n_points,
        n_bisect, n_passes, start_gap=float(start_gap_km))
    return {"h_knots_km": h, "ne_knots_m3": ne, "den_fit": den_fit,
            "vh_fit": vh_fit, "rms_km": _rms(vh_fit, obs_sorted),
            "f_sorted_hz": f_sorted}
