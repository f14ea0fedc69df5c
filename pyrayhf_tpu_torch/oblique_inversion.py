"""Oblique-ionogram inversion: fit the midpoint EDP to link group delays.

Port of ``pyrayhf_tpu.oblique_inversion``. The forward model is the Snell
homing fan of :func:`pyrayhf_tpu_torch.synthesize_oblique_ionogram`, and
the fit is Levenberg–Marquardt on exact Jacobians: forward-mode AD
(``torch.autograd.forward_ad``) through the fan, the crossing
interpolation and the delay channel gives ∂(delay)/∂(NmF2, hmF2, B_bot).

Parameterisation as the vertical retrieval: the F2 layer's (NmF2, hmF2,
B_bot) — or (NmF2, hmF2, B0) for ``bottom_type='B0_B1'`` — log-scaled,
with F1/E parameters held at their priors; NmF2 is fitted by default.

The JAX package runs its Jacobian as one JVP per parameter and its brute
seeding grid under ``vmap``. Here both are one batched fan over a leading
dimension of profiles: the Jacobian's n_par copies of the profile carry the
tangents e_k, and the brute grid's candidates are profiles of one call.
The LM runs a fixed number of steps and damping retries with no host read
inside the loop.
"""

import math

import torch
from torch.autograd import forward_ad as fwAD

from . import edp
from ._util import as_tensors
from .absorption import collision_frequency
from .constants import CP
from .oblique import _homing
from .retrieval import _param, _solve_small

__all__ = ["retrieve_from_oblique"]

# rows where the observation is finite but the model fan never reaches the
# link (above the model's MUF) get a penalty residual [ms], smooth in the
# parameters: scaled by f_obs / f_nose(NmF2, hmF2), a flat-secant MUF
# proxy, so missing rows pull NmF2 up / hmF2 down until the fan covers
# them (a constant fill would have a zero Jacobian)
_PENALTY_MS = 10.0

# soft-clip scale [ms] for the bounded-influence residual rows
_HUBER_MS = 1.0


def _scalar(x, like):
    """Squeeze reference-style (1,1)-shaped parameter arrays to 0-d
    tensors in ``like``'s dtype and device."""
    return _param(x, like).reshape(())


def _oblique_lm(x0, nm0, B_top, Es, P, B1_fix, f0s, obs_ms, obs_hi_ms,
                alt, bmag, bpsi, nu, *, mode, geometry, bottom_type, n_elev,
                n_hops, steps, fit_nm, d_km, elev_min, elev_max, brute_init):
    """``steps`` LM iterations on the oblique residuals of one link.

    Mirrors the JAX package's ``_oblique_lm_core``: a fixed step count,
    4 inner damping retries with accept/reject masks, Cramer solves of the
    normal equations. ``obs_hi_ms`` may be all-NaN (low-ray-only fit).
    Returns (x, delay low [s], delay high [s], EDP, history [steps]).
    """
    obs_ok = torch.isfinite(obs_ms) & torch.isfinite(f0s)
    obs_hi_ok = torch.isfinite(obs_hi_ms) & torch.isfinite(f0s)
    hmE = Es["hm"]

    def edp_of(x):
        """[G, Pn] log-parameters → EDP [G, N]."""
        bb = torch.exp(x[:, 0:1])
        hm = torch.exp(x[:, 1:2])
        nm = torch.exp(x[:, 2:3]) if fit_nm else nm0
        NmF1, _, hmF1, _ = edp.derive_dependent_F1_parameters(
            P, nm, hm, bb, hmE)
        if bottom_type == "B_bot":
            return edp.reconstruct_density_1level(
                {"Nm": nm, "hm": hm, "B_bot": bb, "B_top": B_top},
                {"Nm": NmF1, "hm": hmF1}, Es, alt)
        return edp.reconstruct_density_continuous(
            {"Nm": nm, "hm": hm, "B0": bb, "B1": B1_fix, "B_top": B_top},
            {"P": P, "hm": hmF1}, Es, alt)

    def delays_ms(x):
        out = _homing(f0s, d_km, alt, edp_of(x), bmag, bpsi, nu, mode,
                      geometry, n_elev, elev_min, elev_max, 200.0, n_hops,
                      None)
        return out["delay_low_sec"] * 1e3, out["delay_high_sec"] * 1e3

    def res(x):
        """Residual rows [G, 2F] of the [G, Pn] parameter vectors."""
        d_lo, d_hi = delays_ms(x)
        nm = torch.exp(x[:, 2:3]) if fit_nm else nm0
        hm = torch.exp(x[:, 1:2])
        # flat-secant nose proxy: f_nose = foF2 / cos(phi0), phi0 the
        # zenith angle of the mirror ray at the per-hop midpoint
        fo = CP * torch.sqrt(nm)                              # Hz
        cosphi = hm / torch.sqrt(hm * hm + (0.5 * d_km / n_hops) ** 2)
        pen = _PENALTY_MS * torch.clamp(f0s / (fo / cosphi), min=0.3)

        def rows(obs, d, ok):
            r = torch.where(ok & torch.isfinite(d), obs - d, 0.0)
            return torch.where(ok & ~torch.isfinite(d), pen, r)

        r = torch.cat([rows(obs_ms, d_lo, obs_ok),
                       rows(obs_hi_ms, d_hi, obs_hi_ok)], dim=-1)
        # bounded-influence rows (soft clip at _HUBER_MS): a row whose
        # crossing flips between propagation modes jumps by ~ms; the clip
        # keeps the exact zero at the global minimum
        return r / torch.sqrt(1.0 + (r / _HUBER_MS) ** 2)

    def cost(x):
        return torch.sum(res(x) ** 2, dim=-1)

    kw = dict(dtype=x0.dtype, device=x0.device)
    # physical box for the log-parameters
    lo = torch.stack([torch.tensor(math.log(5.0), **kw),
                      torch.log(hmE + 40.0)]
                     + ([torch.tensor(math.log(1e10), **kw)]
                        if fit_nm else []))
    hi = torch.tensor([math.log(200.0), math.log(550.0)]
                      + ([math.log(5e13)] if fit_nm else []), **kw)

    def box(x):
        return torch.minimum(torch.maximum(x, lo), hi)

    n_par = x0.shape[0]
    eyeP = torch.eye(n_par, **kw)

    def jac(x):
        """[2F, Pn]: the n_par JVP columns in one forward-mode pass over
        n_par copies of the link, copy k carrying the tangent e_k."""
        with fwAD.dual_level():
            r = res(fwAD.make_dual(x.expand(n_par, n_par).clone(), eyeP))
            t = fwAD.unpack_dual(r).tangent
        return t.transpose(0, 1)

    if brute_init:
        # the coarse grid around the prior (the reference's lmfit-brute
        # heritage) as ONE batched fan: the best grid point seeds LM
        mults = [[0.7, 1.0, 1.45], [0.82, 0.91, 1.0, 1.1, 1.21]]
        if fit_nm:
            mults.append([0.5, 0.71, 1.0, 1.41, 2.0, 2.83])
        grids = torch.meshgrid(*[torch.log(torch.tensor(m, **kw))
                                 for m in mults], indexing="ij")
        offs = torch.stack([g.reshape(-1) for g in grids], dim=-1)
        cand = box(x0[None, :] + offs)
        x0 = cand[torch.argmin(cost(cand))]

    x = x0
    c = cost(x[None])[0]
    lam = torch.full((), 1e-2, **kw)
    history = []
    for _ in range(steps):
        J = jac(x)
        JtJ = J.T @ J
        Jtr = J.T @ res(x[None])[0]
        diag = torch.clamp(torch.diagonal(JtJ), min=1e-12)
        x_acc, done = x, torch.zeros((), dtype=torch.bool, device=x.device)
        for _ in range(4):
            A = JtJ + lam * diag * eyeP
            x_new = box(x - _solve_small(A, Jtr))
            c_new = cost(x_new[None])[0]
            ok = ~done & torch.isfinite(c_new) & (c_new < c)
            x_acc = torch.where(ok, x_new, x_acc)
            c = torch.where(ok, c_new, c)
            lam = torch.where(done, lam,
                              torch.where(ok, torch.clamp(lam / 3.0,
                                                          min=1e-10),
                                          torch.clamp(lam * 10.0, max=1e8)))
            done = done | ok
        x = x_acc
        history.append(c)
    d_lo, d_hi = delays_ms(x[None])
    hist = torch.stack(history) if history else x.new_zeros((0,))
    return x, d_lo[0] * 1e-3, d_hi[0] * 1e-3, edp_of(x[None])[0], hist


def retrieve_from_oblique(F2, F1, E, f0s_hz, delay_obs_sec, ground_range_km,
                          alt, b_mag, b_psi, mode="O", geometry="spherical",
                          bottom_type="B_bot", n_elev=192, elev_min_deg=5.0,
                          elev_max_deg=85.0, n_hops=1, steps=12,
                          fit_nm=True, delay_high_obs_sec=None,
                          brute_init=True, device=None):
    """Fit F2-layer parameters to observed oblique group delays.

    Arguments as the JAX function: ``F2``/``F1``/``E`` layer priors (keys
    of :func:`pyrayhf_tpu_torch.model_VH`; F2 supplies the initial
    NmF2/hmF2/B_bot or B0/B1 and the fixed B_top), ``f0s_hz`` [F] sounding
    frequencies [Hz], ``delay_obs_sec`` [F] observed low-ray group delays
    [s] (NaN rows ignored), ``ground_range_km`` the link length, ``alt``,
    ``b_mag``, ``b_psi`` [N] the midpoint grid and field; ``mode``,
    ``geometry``, ``n_elev``, ``elev_min_deg``, ``elev_max_deg``,
    ``n_hops`` go to the homing fan; ``steps`` LM iterations (each one
    Jacobian and ≤ 4 damping retries); ``fit_nm`` fits NmF2 (else held at
    its prior); ``delay_high_obs_sec`` [F] optional observed high-ray
    delays; ``brute_init`` seeds LM from the best point of a coarse grid.

    Returns (delay_fit_sec, delay_high_fit_sec, EDP_fit, F2_fit, history):
    the modelled low- and high-ray delays [s] at the fit, the fitted
    profile on ``alt`` (tensors), the fitted-parameter dict (floats) and
    the squared-residual trace [ms²] per LM step (numpy). The dtype is
    that of the tensor arguments, else float64; host data goes to the
    CUDA card unless ``device`` says otherwise (``device="cpu"``).
    """
    if bottom_type not in ("B_bot", "B0_B1"):
        raise ValueError("bottom_type must be 'B_bot' or 'B0_B1'")
    alt, bmag, bpsi = as_tensors(alt, b_mag, b_psi, device=device)
    f0s, obs, _ = as_tensors(f0s_hz, delay_obs_sec, alt, dtype=alt.dtype)
    f0s, obs_ms = f0s.reshape(-1), obs.reshape(-1) * 1e3
    if delay_high_obs_sec is None:
        obs_hi_ms = torch.full_like(obs_ms, float("nan"))
    else:
        obs_hi_ms = as_tensors(delay_high_obs_sec, alt,
                               dtype=alt.dtype)[0].reshape(-1) * 1e3

    key2 = "B_bot" if bottom_type == "B_bot" else "B0"
    bb0 = _scalar(F2[key2], alt)
    hm0 = _scalar(F2["hm"], alt)
    nm0 = _scalar(F2["Nm"], alt)
    x0 = torch.stack([torch.log(bb0), torch.log(hm0)]
                     + ([torch.log(nm0)] if fit_nm else []))
    B_top = _scalar(F2["B_top"], alt)
    Es = {k: _scalar(E[k], alt) for k in ("Nm", "hm", "B_bot", "B_top")}
    P = _scalar(F1["P"] if "P" in F1 else 0.0, alt)
    B1_fix = _scalar(F2["B1"] if bottom_type == "B0_B1" else 0.0, alt)

    x, delay_fit, delay_hi_fit, EDP_fit, history = _oblique_lm(
        x0, nm0, B_top, Es, P, B1_fix, f0s, obs_ms, obs_hi_ms, alt, bmag,
        bpsi, collision_frequency(alt), mode=mode, geometry=geometry,
        bottom_type=bottom_type, n_elev=int(n_elev), n_hops=int(n_hops),
        steps=int(steps), fit_nm=bool(fit_nm), d_km=float(ground_range_km),
        elev_min=float(elev_min_deg), elev_max=float(elev_max_deg),
        brute_init=bool(brute_init))

    xs = torch.exp(x).tolist()
    F2_fit = dict(F2)
    F2_fit[key2] = xs[0]
    F2_fit["hm"] = xs[1]
    F2_fit["Nm"] = xs[2] if fit_nm else float(nm0)
    return (delay_fit, delay_hi_fit, EDP_fit, F2_fit,
            history.cpu().numpy())
