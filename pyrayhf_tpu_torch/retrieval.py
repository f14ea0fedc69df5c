"""Model interface & electron-density retrieval (ionogram inversion), in PyTorch.

Port of ``pyrayhf_tpu.retrieval`` (reference ``model_VH`` ``library.py:
512-592``, ``residual_VH`` :595-669, ``minimize_parameters`` :672-825),
without lmfit or PyIRI:

* :func:`model_VH` — parametric EDP (:mod:`pyrayhf_tpu_torch.edp`) →
  forward operator;
* :func:`residual_VH` — pure function of a parameter dict (objects with a
  ``.value`` attribute are accepted too);
* :func:`minimize_parameters` — lmfit-brute grid semantics with the whole
  grid as ONE batched forward call on a [G, N_alt] EDP stack; ``powell``
  (scipy on the host around a device cost); ``levenberg-marquardt``;
* :func:`retrieve_gradient` / :func:`retrieve_gradient_batch` —
  Levenberg–Marquardt with exact Jacobian columns by forward-mode AD
  (``torch.autograd.forward_ad``) through :func:`pyrayhf_tpu_torch.pallas_vh
  .ionogram_fast_xla`, per-sample damping with a masked accept, a fixed
  number of steps and no host read inside the loop.

The batch dimension is written out where the JAX package vmaps, and Python
loops replace ``lax.scan``. Host data goes to the CUDA card unless
``device`` says otherwise (``device="cpu"``).
"""

import os

import numpy as np
import torch
from torch.autograd import forward_ad as fwAD

from . import edp
from ._util import as_tensors, host_f64
from .config import resolve
from .constants import CP, G_P
from .forward import _forward_core, vertical_forward_operator
from .magnetoionic import freq2den, mode_multiplier
from .pallas_vh import ionogram_fast_xla

__all__ = ["model_VH", "residual_VH", "minimize_parameters",
           "retrieve_gradient", "retrieve_gradient_batch"]


def _param_value(p):
    """Accept plain numbers or lmfit-style objects with a .value attr."""
    return getattr(p, "value", p)


def _param(x, like):
    """A layer parameter as a tensor in ``like``'s dtype and device.

    Reference-style (1,1)-shaped values become 0-d; a batch of values (e.g.
    a [G, 1] grid of candidates) keeps its shape.
    """
    x = _param_value(x)
    if isinstance(x, torch.Tensor):
        t = x.to(dtype=like.dtype, device=like.device)
    else:
        t = torch.as_tensor(np.asarray(x, dtype=np.float64),
                            device=like.device).to(like.dtype)
    return t.reshape(()) if t.numel() == 1 else t


def _layer_params(E, like):
    return {k: _param(E[k], like) for k in ("Nm", "hm", "B_bot", "B_top")}


def _build_edp(F2, F1, E, alt, bottom_type):
    """Derive the dependent F1 parameters and reconstruct the EDP.

    Mirrors model_VH's PyIRI calls (ref :556-583) with the port's builders.
    Returns (EDP [..., N_alt], F1_updated dict).
    """
    hmE = _param(E["hm"], alt)
    NmF2 = _param(F2["Nm"], alt)
    hmF2 = _param(F2["hm"], alt)
    P = _param(F1["P"] if "P" in F1 else 0.0, alt)
    Es = _layer_params(E, alt)
    key = {"B_bot": "B_bot", "B0_B1": "B0"}.get(bottom_type)
    if key is None:
        raise ValueError("bottom_type must be 'B_bot' or 'B0_B1'")
    B2 = _param(F2[key], alt)
    NmF1, foF1, hmF1, B_F1_bot = edp.derive_dependent_F1_parameters(
        P, NmF2, hmF2, B2, hmE)
    F1u = dict(F1)
    F1u.update(Nm=NmF1, fo=foF1, hm=hmF1, B_bot=B_F1_bot)
    B_top = _param(F2["B_top"], alt)
    if bottom_type == "B_bot":
        EDP = edp.reconstruct_density_1level(
            {"Nm": NmF2, "hm": hmF2, "B_bot": B2, "B_top": B_top},
            {"Nm": NmF1, "hm": hmF1}, Es, alt)
    else:
        EDP = edp.reconstruct_density_continuous(
            {"Nm": NmF2, "hm": hmF2, "B0": B2,
             "B1": _param(F2["B1"], alt), "B_top": B_top},
            {"P": P, "hm": hmF1}, Es, alt)
    return EDP, F1u


def model_VH(F2, F1, E, f_in, alt, b_mag, b_psi, mode="O", n_points=200,
             bottom_type="B_bot", arithmetic="stable", device=None):
    """Virtual heights from layer parameters (ref :512-592).

    Returns (vh [N_freq], EDP [N_alt]). The input ``F1`` dict is not
    mutated. ``arithmetic="reference"`` gives bit-parity μ' near the
    reflection point (see :func:`pyrayhf_tpu_torch.forward
    .vertical_forward_operator`).
    """
    f_in, alt, b_mag, b_psi = as_tensors(f_in, alt, b_mag, b_psi,
                                         device=device)
    EDP, _ = _build_edp(F2, F1, E, alt, bottom_type)
    vh = vertical_forward_operator(f_in, EDP, b_mag, b_psi, alt, mode=mode,
                                   n_points=n_points, arithmetic=arithmetic)
    return vh, EDP


def _fill_escaped(vh):
    """Escaped-ray NaNs → max(nanmean|vh|, 100) along the last axis."""
    fill = torch.nanmean(torch.abs(vh), dim=-1, keepdim=True)
    fill = torch.maximum(fill, torch.full_like(fill, 100.0))
    return torch.where(torch.isnan(vh), fill, vh)


def residual_VH(params, F2_init, F1_init, E_init, f_in, vh_obs, alt,
                b_mag, b_psi, mode="O", n_points=200, bottom_type="B_bot",
                device=None):
    """Observed − modelled virtual heights (ref :595-669).

    ``params``: dict with 'NmF2', 'hmF2' and 'B_bot' (or 'B0'/'B1'); values
    may be numbers, tensors or lmfit-style objects with ``.value``.
    Escaped-ray NaNs in the model are replaced by max(nanmean|vh|, 100)
    like the reference.
    """
    F2 = dict(F2_init)
    F2["Nm"] = _param_value(params["NmF2"])
    F2["hm"] = _param_value(params["hmF2"])
    if bottom_type == "B_bot":
        F2["B_bot"] = _param_value(params["B_bot"])
    elif bottom_type == "B0_B1":
        F2["B0"] = _param_value(params["B0"])
        F2["B1"] = _param_value(params["B1"])
    vh_model, _ = model_VH(F2, F1_init, E_init, f_in, alt, b_mag, b_psi,
                           mode=mode, n_points=n_points,
                           bottom_type=bottom_type, device=device)
    vh_model = _fill_escaped(vh_model)
    vh_obs, _ = as_tensors(vh_obs, vh_model, dtype=vh_model.dtype)
    return (vh_obs - vh_model).reshape(-1)


def _pin_NmF2(f_in, alt, b_mag, old_hmf2, mode):
    """NmF2 from the maximum observed frequency (ref :760-778)."""
    f_max_hz = f_in[-1] * 1e6
    if mode == "O":
        return freq2den(f_max_hz) * 1.0001
    # X-mode: from the X + Y = 1 cutoff using B at hmF2
    ind = torch.argmin(torch.abs(alt - old_hmf2))
    f_c = b_mag[ind] * G_P
    foF2 = torch.sqrt(f_max_hz ** 2 - f_max_hz * f_c)
    return freq2den(foF2) * 1.0001


def minimize_parameters(F2, F1, E, f_in0, vh_obs0, alt, b_mag, b_psi,
                        method=None, percent_sigma=None, step=None,
                        mode=None, n_points=None, bottom_type=None,
                        config=None, device=None):
    """Fit hmF2 and B_bot (or B0) to observed VH (ref :672-825).

    ``method='brute'``: lmfit-brute grid semantics (``arange(min, max,
    step)`` per axis), the whole grid of forward operators as one batched
    call on a [G, N_alt] EDP stack. ``method='powell'``: scipy Powell line
    search within the (old ± sigma) bounds on the host, each cost evaluated
    on the device. ``method='levenberg-marquardt'`` delegates to
    :func:`retrieve_gradient`. Returns (vh_fit, EDP_fit, F2_fit).

    Defaults mirror the reference (method='brute', percent_sigma=20,
    step=1, mode='O', n_points=200, bottom_type='B_bot'); a
    :class:`pyrayhf_tpu_torch.config.RetrievalConfig` passed as ``config``
    supplies any knob not given explicitly.
    """
    method = resolve(config, "method", method, "brute")
    percent_sigma = resolve(config, "percent_sigma", percent_sigma, 20.0)
    step = resolve(config, "step", step, 1.0)
    mode = resolve(config, "mode", mode, "O")
    n_points = resolve(config, "n_points", n_points, 200)
    bottom_type = resolve(config, "bottom_type", bottom_type, "B_bot")
    if method in ("levenberg-marquardt", "leastsq"):
        if bottom_type != "B_bot":
            raise ValueError("levenberg-marquardt retrieval supports B_bot")
        vh_fit, EDP_fit, F2_fit, _ = retrieve_gradient(
            F2, F1, E, f_in0, vh_obs0, alt, b_mag, b_psi, mode=mode,
            n_points=n_points, bottom_type=bottom_type, device=device)
        return vh_fit, EDP_fit, F2_fit
    if method not in ("brute", "powell"):
        raise ValueError(
            "method must be 'brute', 'powell' or 'levenberg-marquardt'")
    if bottom_type == "B_bot" and F2.get("B_bot") is None:
        raise ValueError("B_bot is not provided in F, but bottom_type is "
                         "B_bot")
    if bottom_type == "B0_B1" and (F2.get("B0") is None
                                   or F2.get("B1") is None):
        raise ValueError("B0 and B1 are not provided in F, but bottom_type "
                         "is B0_B1")

    f_in0 = host_f64(f_in0)
    vh_obs0 = host_f64(vh_obs0)
    gi = np.nonzero(np.isfinite(f_in0 + vh_obs0))[0]
    vh_obs, f_in = vh_obs0[gi], f_in0[gi]
    si = np.argsort(f_in)
    vh_obs, f_in = vh_obs[si], f_in[si]

    alt_t, bmag_t, bpsi_t = as_tensors(alt, b_mag, b_psi, device=device)
    f_t, obs_t = as_tensors(f_in, vh_obs, alt_t)[:2]
    old_hmf2 = float(np.squeeze(host_f64(_param_value(F2["hm"]))))
    sigma_hmf2 = old_hmf2 * percent_sigma / 100.0
    key2 = "B_bot" if bottom_type == "B_bot" else "B0"
    old_b = float(np.squeeze(host_f64(_param_value(F2[key2]))))
    sigma_b = old_b * percent_sigma / 100.0

    Nm_new = _pin_NmF2(f_t, alt_t, bmag_t, old_hmf2, mode)
    mm = mode_multiplier(mode)

    def costs(hm, b):
        """Sum of squared residuals for [G] candidate (hm, b) pairs, one
        batched forward call on the [G, N_alt] EDP stack."""
        G = hm.shape[0]
        F2g = dict(F2, Nm=Nm_new, hm=hm[:, None])
        F2g[key2] = b[:, None]
        EDP, _ = _build_edp(F2g, F1, E, alt_t, bottom_type)
        EDP = EDP.expand(G, alt_t.shape[-1])
        vh = _forward_core(f_t * 1e6, EDP, bmag_t.expand_as(EDP),
                           bpsi_t.expand_as(EDP), alt_t.expand_as(EDP),
                           mode_mult=mm, n_points=n_points)
        r = obs_t - _fill_escaped(vh)
        return torch.sum(r * r, dim=-1)

    if method == "powell":
        # the reference forwards method='powell' to lmfit → scipy Powell
        # line search with (old ± sigma) parameter bounds (ref :781-798)
        from scipy.optimize import minimize as _sp_minimize

        def cost_host(z):
            hb = torch.as_tensor(np.asarray(z, dtype=np.float64),
                                 device=alt_t.device).to(alt_t.dtype)
            return float(costs(hb[:1], hb[1:])[0])

        res = _sp_minimize(
            cost_host, x0=np.array([old_hmf2, old_b]), method="Powell",
            bounds=[(old_hmf2 - sigma_hmf2, old_hmf2 + sigma_hmf2),
                    (old_b - sigma_b, old_b + sigma_b)])
        hm_opt, b_opt = float(res.x[0]), float(res.x[1])
    else:
        # lmfit-brute grid semantics: arange(min, max, brute_step) per
        # axis; a sigma smaller than the step would yield an EMPTY grid —
        # fall back to the initial value
        hm_grid = np.arange(old_hmf2 - sigma_hmf2, old_hmf2 + sigma_hmf2,
                            step)
        b_grid = np.arange(old_b - sigma_b, old_b + sigma_b, step)
        if hm_grid.size == 0:
            hm_grid = np.array([old_hmf2])
        if b_grid.size == 0:
            b_grid = np.array([old_b])
        HM, BB = np.meshgrid(hm_grid, b_grid, indexing="ij")
        hm_flat, b_flat = HM.ravel(), BB.ravel()
        cost = costs(*as_tensors(hm_flat, b_flat, alt_t)[:2])
        best = int(torch.argmin(cost))
        hm_opt, b_opt = float(hm_flat[best]), float(b_flat[best])

    shape = np.shape(_param_value(F2["Nm"]))
    F2_fit = dict(F2)
    F2_fit["Nm"] = np.full(shape, float(Nm_new))
    F2_fit["hm"] = np.full(shape, hm_opt)
    F2_fit[key2] = np.full(shape, b_opt)
    vh_fit, EDP_fit = model_VH(F2_fit, dict(F1), dict(E), f_in0, alt_t,
                               bmag_t, bpsi_t, mode=mode, n_points=n_points,
                               bottom_type=bottom_type)
    return vh_fit, EDP_fit, F2_fit


def retrieve_gradient(F2, F1, E, f_in, vh_obs, alt, b_mag, b_psi,
                      mode="O", n_points=200, bottom_type="B_bot",
                      steps=25, learning_rate=None, fit_nm=False,
                      crit_margin=0.995, device=None):
    """Gradient-based retrieval: exact Jacobians through the whole operator.

    Optimises log-scaled (hmF2, B_bot[, NmF2]) — or (hmF2, B0) for
    bottom_type='B0_B1' — with Levenberg–Marquardt on the virtual-height
    residuals: :func:`_lm_batch_core` with a batch of one. ``steps`` is the
    LM iteration budget; ``learning_rate`` is accepted for backwards
    compatibility and ignored. Frequencies above ``crit_margin``·foF2(model)
    are excluded from the fit (|∂vh/∂θ| diverges at the reflection
    singularity).

    Returns (vh_fit, EDP_fit, F2_fit, history) where history is the
    squared-residual trace per LM iteration.
    """
    del learning_rate
    f, obs, alt_t, bmag_t, bpsi_t = as_tensors(f_in, vh_obs, alt, b_mag,
                                               b_psi, device=device)
    obs_ok = torch.isfinite(obs) & torch.isfinite(f)
    hm0 = _param(F2["hm"], alt_t)
    key2 = "B_bot" if bottom_type == "B_bot" else "B0"
    bb0 = _param(F2[key2], alt_t)
    nm0 = (_param(F2["Nm"], alt_t) if fit_nm
           else _pin_NmF2(torch.sort(f[obs_ok]).values, alt_t, bmag_t,
                          float(hm0), mode))
    B_top = _param(F2["B_top"], alt_t)
    Es = _layer_params(E, alt_t)
    P = _param(F1["P"] if "P" in F1 else 0.0, alt_t)
    B1_fix = _param(F2["B1"] if bottom_type == "B0_B1" else 0.0, alt_t)

    _, _, hm_f, bb_f, nm_f, history = _lm_batch_core(
        hm0[None], bb0[None], nm0.reshape(1), B_top, Es, P, B1_fix, f,
        obs[None, :], alt_t, bmag_t, bpsi_t, mode=mode, n_points=n_points,
        bottom_type=bottom_type, steps=steps, fit_nm=fit_nm,
        crit_margin=crit_margin)
    shape = np.shape(_param_value(F2["Nm"]))
    F2_fit = dict(F2)
    F2_fit["Nm"] = np.full(shape, float(nm_f[0] if fit_nm else nm0))
    F2_fit["hm"] = np.full(shape, float(hm_f[0]))
    F2_fit[key2] = np.full(shape, float(bb_f[0]))
    vh_fit, EDP_fit = model_VH(F2_fit, dict(F1), dict(E), f, alt_t, bmag_t,
                               bpsi_t, mode=mode, n_points=n_points,
                               bottom_type=bottom_type)
    return vh_fit, EDP_fit, F2_fit, history[:, 0].cpu().numpy()


def _solve_small(A, b):
    """Batched solve of the tiny LM normal equations, in closed form.

    Cramer's rule for the 2/3-parameter systems, as the JAX package does:
    a singular sample gets det = 1e-300 and so a huge step, which the
    accept test rejects, where ``torch.linalg.solve`` would raise for the
    whole batch (and on CUDA check for it with a host read inside the LM
    loop).
    """
    n = A.shape[-1]
    if n == 2:
        det = A[..., 0, 0] * A[..., 1, 1] - A[..., 0, 1] * A[..., 1, 0]
        det = torch.where(det == 0.0, 1e-300, det)
        x0 = (b[..., 0] * A[..., 1, 1] - b[..., 1] * A[..., 0, 1]) / det
        x1 = (A[..., 0, 0] * b[..., 1] - A[..., 1, 0] * b[..., 0]) / det
        return torch.stack([x0, x1], dim=-1)
    if n == 3:
        c00 = A[..., 1, 1] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 1]
        c01 = A[..., 1, 2] * A[..., 2, 0] - A[..., 1, 0] * A[..., 2, 2]
        c02 = A[..., 1, 0] * A[..., 2, 1] - A[..., 1, 1] * A[..., 2, 0]
        det = (A[..., 0, 0] * c00 + A[..., 0, 1] * c01 + A[..., 0, 2] * c02)
        det = torch.where(det == 0.0, 1e-300, det)
        c10 = A[..., 0, 2] * A[..., 2, 1] - A[..., 0, 1] * A[..., 2, 2]
        c11 = A[..., 0, 0] * A[..., 2, 2] - A[..., 0, 2] * A[..., 2, 0]
        c12 = A[..., 0, 1] * A[..., 2, 0] - A[..., 0, 0] * A[..., 2, 1]
        c20 = A[..., 0, 1] * A[..., 1, 2] - A[..., 0, 2] * A[..., 1, 1]
        c21 = A[..., 0, 2] * A[..., 1, 0] - A[..., 0, 0] * A[..., 1, 2]
        c22 = A[..., 0, 0] * A[..., 1, 1] - A[..., 0, 1] * A[..., 1, 0]
        x0 = (b[..., 0] * c00 + b[..., 1] * c10 + b[..., 2] * c20) / det
        x1 = (b[..., 0] * c01 + b[..., 1] * c11 + b[..., 2] * c21) / det
        x2 = (b[..., 0] * c02 + b[..., 1] * c12 + b[..., 2] * c22) / det
        return torch.stack([x0, x1, x2], dim=-1)
    return torch.linalg.solve(A, b[..., None])[..., 0]


def _lm_batch_core(hm0, bb0, nm0, B_top, Es, P, B1_fix, f, obs, alt_j,
                   bmag_j, bpsi_j, *, mode, n_points, bottom_type, steps,
                   fit_nm, crit_margin):
    """``steps`` parallel LM iterations over [B] ionograms.

    Per-sample damping (λ) with a 4-try masked accept: a rejected sample
    keeps its state and raises λ while its batch-mates proceed. Fixed step
    count and no host read inside the loop. Jacobian columns are
    forward-mode JVPs through :func:`ionogram_fast_xla` (see ``jac_b``).
    Returns (vh_fit [B, F], EDP_fit [B, N], hm [B], bb [B],
    nm [B], history [steps, B]).
    """
    mm = mode_multiplier(mode)
    hmE = Es["hm"]
    B = obs.shape[0]
    bmag_b = bmag_j.expand(B, bmag_j.shape[-1])
    bpsi_b = bpsi_j.expand(B, bpsi_j.shape[-1])

    # parameter vector layout matches retrieve_gradient's sorted-key order
    x0 = torch.stack([torch.log(bb0), torch.log(hm0)]
                     + ([torch.log(nm0)] if fit_nm else []), dim=1)

    def edp_s(x, rep=1):
        """[rep·B, Pn] → (EDP [rep·B, N], nm [rep·B])."""
        bb = torch.exp(x[:, 0:1])
        hm = torch.exp(x[:, 1:2])
        nm = torch.exp(x[:, 2:3]) if fit_nm else nm0.repeat(rep)[:, None]
        NmF1, _, hmF1, _ = edp.derive_dependent_F1_parameters(
            P, nm, hm, bb, hmE)
        if bottom_type == "B_bot":
            EDP = edp.reconstruct_density_1level(
                {"Nm": nm, "hm": hm, "B_bot": bb, "B_top": B_top},
                {"Nm": NmF1, "hm": hmF1}, Es, alt_j)
        else:
            EDP = edp.reconstruct_density_continuous(
                {"Nm": nm, "hm": hm, "B0": bb, "B1": B1_fix,
                 "B_top": B_top}, {"P": P, "hm": hmF1}, Es, alt_j)
        return EDP, nm[:, 0]

    def forward_b(xb, rep=1):
        """[rep·B, Pn] → (vh [rep·B, F] NaN for escaped rays, nm)."""
        dens, nm = edp_s(xb, rep)
        vh = ionogram_fast_xla(f, dens, bmag_b.repeat(rep, 1),
                               bpsi_b.repeat(rep, 1), alt_j, mode_mult=mm,
                               n_points=n_points)
        return vh, nm

    def res_b(xb, rep=1):
        """Residuals [rep·B, F] of ``rep`` stacked copies of the batch."""
        vh, nm = forward_b(xb, rep)
        ob = obs.repeat(rep, 1)
        obs_ok = torch.isfinite(ob) & torch.isfinite(f)[None, :]
        valid = ~torch.isnan(vh)
        fo_model = torch.sqrt(nm) * CP / 1e6                 # MHz
        in_band = obs_ok & (f[None, :] < crit_margin * fo_model[:, None])
        use = valid & in_band
        r = torch.where(use, ob - vh, 0.0)
        return torch.where(in_band & ~valid, 1e3, r)

    n_par = x0.shape[1]
    eyeP = torch.eye(n_par, dtype=x0.dtype, device=x0.device)

    def jac_b(xb):
        """[B, F, Pn]: the n_par JVP columns in one forward-mode pass over
        n_par stacked copies of the batch, copy k carrying the tangent
        e_k (samples are independent, so this is the JAX package's n_par
        separate JVPs)."""
        tangent = eyeP.repeat_interleave(B, dim=0)           # [Pn·B, Pn]
        with fwAD.dual_level():
            r = res_b(fwAD.make_dual(xb.repeat(n_par, 1), tangent), n_par)
            t = fwAD.unpack_dual(r).tangent
        return t.reshape(n_par, B, -1).permute(1, 2, 0)

    x = x0
    cost = torch.sum(res_b(x0) ** 2, dim=1)
    lam = torch.full((B,), 1e-2, dtype=x0.dtype, device=x0.device)
    history = []
    for _ in range(steps):
        J = jac_b(x)                                        # [B, F, Pn]
        JtJ = torch.einsum("bfi,bfj->bij", J, J)
        r = res_b(x)                                        # [B, F]
        Jtr = torch.einsum("bfi,bf->bi", J, r)
        diag = torch.diagonal(JtJ, dim1=1, dim2=2)
        diag = torch.maximum(diag, torch.full_like(diag, 1e-12))
        # inner damping retries: samples that accepted stop updating
        x_acc, done = x, torch.zeros(B, dtype=torch.bool, device=x.device)
        for _ in range(4):
            A = JtJ + (lam[:, None] * diag)[:, :, None] * eyeP[None]
            x_new = x - _solve_small(A, Jtr)
            cost_new = torch.sum(res_b(x_new) ** 2, dim=1)
            ok = ~done & torch.isfinite(cost_new) & (cost_new < cost)
            x_acc = torch.where(ok[:, None], x_new, x_acc)
            cost = torch.where(ok, cost_new, cost)
            lam = torch.where(done, lam,
                              torch.where(ok, torch.clamp(lam / 3.0,
                                                          min=1e-10),
                                          torch.clamp(lam * 10.0, max=1e8)))
            done = done | ok
        x = x_acc
        history.append(cost)

    EDP_fit, nm_fit = edp_s(x)
    vh_fit, _ = forward_b(x)
    return (vh_fit, EDP_fit, torch.exp(x[:, 1]), torch.exp(x[:, 0]), nm_fit,
            torch.stack(history) if history else x.new_zeros((0, B)))


def _working_dtype(dtype):
    """``dtype`` as a torch floating dtype (None → float64); accepts torch
    dtypes, numpy dtypes and their names."""
    if dtype is None:
        return torch.float64
    if isinstance(dtype, torch.dtype):
        return dtype
    return {np.dtype(np.float32): torch.float32,
            np.dtype(np.float64): torch.float64}[np.dtype(dtype)]


def retrieve_gradient_batch(F2, F1, E, f_in, vh_obs, alt, b_mag, b_psi,
                            mode=None, n_points=None, bottom_type=None,
                            steps=None, fit_nm=False, crit_margin=None,
                            chunk_size=64, dtype=None,
                            checkpoint_path=None, config=None,
                            retries=1, retry_cost=10.0, device=None):
    """Batched gradient retrieval: [B, F] ionograms → [B] fits.

    ``vh_obs`` is [B, F]; entries of ``F2`` may be scalars (shared initial
    guess) or [B] arrays (per-sample). ``b_mag``/``b_psi`` may be [N] (one
    magnetic environment for the batch) or [B, N] (per-sample
    environments). ``F1``/``E`` parameters and the altitude grid ``alt``
    are shared. Returns (vh_fit [B, F], EDP_fit [B, N], F2_fit dict of [B]
    numpy arrays, history [steps, B] numpy squared-residual trace).

    ``chunk_size`` splits the batch into separate LM runs of at most that
    many samples (``None`` = one run); checkpoints are written per chunk.
    ``dtype`` selects the working precision (default float64;
    ``torch.float32``, ``np.float32`` or ``"float32"`` for f32).

    ``checkpoint_path`` enables chunk-granular resume: after each completed
    chunk the fitted state is saved with :func:`pyrayhf_tpu_torch.io
    .save_checkpoint` (the JAX package's layout); if the file exists,
    completed chunks are loaded instead of recomputed, reproducing the
    uninterrupted fit exactly, and a file written for another configuration
    raises. The file is removed on success.

    ``retries``: samples whose final cost exceeds ``retry_cost`` are re-run
    up to ``retries`` times from a perturbed initial guess (hmF2 × (1 +
    0.1·attempt), B / the same), keeping whichever fit costs less.

    A :class:`pyrayhf_tpu_torch.config.RetrievalConfig` passed as ``config``
    supplies mode/n_points/bottom_type/steps (``lm_steps``)/``crit_margin``
    when not given explicitly.
    """
    from . import io as _io
    mode = resolve(config, "mode", mode, "O")
    n_points = resolve(config, "n_points", n_points, 200)
    bottom_type = resolve(config, "bottom_type", bottom_type, "B_bot")
    steps = resolve(config, "lm_steps", steps, 25)
    crit_margin = resolve(config, "crit_margin", crit_margin, 0.995)
    dt = _working_dtype(dtype)
    f, obs, alt_j, bmag_j, bpsi_j = as_tensors(f_in, vh_obs, alt, b_mag,
                                               b_psi, dtype=dt,
                                               device=device)
    obs = torch.atleast_2d(obs)
    B = obs.shape[0]

    def _env(a, name):
        if a.ndim == 1:
            return a
        if a.ndim == 2 and a.shape[0] in (1, B):
            return a.expand(B, a.shape[-1])
        raise ValueError(f"{name} must be [N] or [B, N]; got "
                         f"{tuple(a.shape)} for B={B}")

    bmag_j = _env(bmag_j, "b_mag")
    bpsi_j = _env(bpsi_j, "b_psi")

    def _env_take(a, sel):
        """Select batch rows of an environment array (no-op for [N])."""
        return a if a.ndim == 1 else a[sel]

    def per_sample(v):
        a = _param(v, obs).reshape(-1)
        return a.expand(B) if a.shape[0] in (1, B) else a

    hm0 = per_sample(F2["hm"])
    key2 = "B_bot" if bottom_type == "B_bot" else "B0"
    bb0 = per_sample(F2[key2])

    if fit_nm:
        nm0 = per_sample(F2["Nm"])
    else:
        # per-sample NmF2 pin from the highest finite observed frequency
        # (ref :760-778 semantics, vectorised over the batch)
        obs_ok = torch.isfinite(obs) & torch.isfinite(f)[None, :]
        fmax_hz = torch.amax(torch.where(obs_ok, f[None, :], -torch.inf),
                             dim=1) * 1e6
        if mode == "O":
            nm0 = freq2den(fmax_hz) * 1.0001
        else:
            ind = torch.argmin(torch.abs(alt_j[None, :] - hm0[:, None]),
                               dim=1)
            f_c = (bmag_j[ind] if bmag_j.ndim == 1
                   else bmag_j[torch.arange(B, device=ind.device), ind]) * G_P
            nm0 = freq2den(torch.sqrt(fmax_hz ** 2 - fmax_hz * f_c)) * 1.0001

    B_top = _param(F2["B_top"], obs)
    Es = _layer_params(E, obs)
    P = _param(F1["P"] if "P" in F1 else 0.0, obs)
    B1_fix = _param(F2["B1"] if bottom_type == "B0_B1" else 0.0, obs)
    core = dict(mode=mode, n_points=n_points, bottom_type=bottom_type,
                steps=steps, fit_nm=fit_nm, crit_margin=crit_margin)

    slices = ([slice(lo, min(lo + chunk_size, B))
               for lo in range(0, B, chunk_size)] if chunk_size
              else [slice(0, B)])

    ckpt = None
    if checkpoint_path is not None:
        # the FULL configuration must match for chunk reuse to be sound:
        # a resume under different physics would silently mix results
        cfg_now = {"B": B, "steps": steps, "n_chunks": len(slices),
                   "n_points": n_points, "mode_O": int(mode == "O"),
                   "bottom_B_bot": int(bottom_type == "B_bot"),
                   "fit_nm": int(bool(fit_nm)),
                   "crit_margin_e6": int(round(crit_margin * 1e6)),
                   "dtype_itemsize": dt.itemsize}
        if os.path.exists(checkpoint_path):
            ckpt = _io.load_checkpoint(checkpoint_path)
            meta = ckpt["meta"]
            mismatch = [k for k, v in cfg_now.items()
                        if int(meta.get(k, -1)) != int(v)]
            if mismatch:
                raise ValueError(
                    f"checkpoint {checkpoint_path} was written for a "
                    f"different retrieval configuration (mismatched: "
                    f"{mismatch})")
        else:
            ckpt = {"meta": dict(cfg_now, chunks_done=0), "chunks": {}}

    part_keys = ("vh_fit", "EDP_fit", "hm", "bb", "nm", "history")
    parts = []
    for ci, sl in enumerate(slices):
        if ckpt is not None and ci < int(ckpt["meta"]["chunks_done"]):
            c = ckpt["chunks"][str(ci)]
            parts.append(tuple(torch.as_tensor(c[k]).to(obs.device, dt)
                               for k in part_keys))
            continue
        out = _lm_batch_core(
            hm0[sl], bb0[sl], nm0[sl], B_top, Es, P, B1_fix, f, obs[sl],
            alt_j, _env_take(bmag_j, sl), _env_take(bpsi_j, sl), **core)
        parts.append(out)
        if ckpt is not None:
            ckpt["chunks"][str(ci)] = dict(zip(part_keys, out))
            ckpt["meta"]["chunks_done"] = ci + 1
            _io.save_checkpoint(ckpt, checkpoint_path)
    if ckpt is not None and os.path.exists(checkpoint_path):
        os.remove(checkpoint_path)

    # merge the chunk results, then (optionally) retry stalled samples from
    # a perturbed initial guess, keeping the better of the two fits
    vh_c = torch.cat([p[0] for p in parts], dim=0)
    edp_c = torch.cat([p[1] for p in parts], dim=0)
    hist_c = torch.cat([p[5] for p in parts], dim=1)
    hm_c, bb_c, nm_c = (torch.cat([p[i] for p in parts]).cpu().numpy()
                        for i in (2, 3, 4))
    cost_f = hist_c[-1].cpu().numpy()

    hm0_n, bb0_n = hm0.cpu().numpy(), bb0.cpu().numpy()
    for attempt in range(int(retries)):
        bad = np.nonzero(cost_f > retry_cost)[0]
        if bad.size == 0:
            break
        # pad the stalled set to a power of two (the JAX package bounds
        # its compiled batch shapes so; kept for equal results)
        pad_to = 1 << max(int(np.ceil(np.log2(bad.size))), 0)
        idx = np.concatenate([bad, np.full(pad_to - bad.size, bad[0],
                                           dtype=bad.dtype)])
        idx_t = torch.as_tensor(idx, device=obs.device)
        fac = 1.0 + 0.1 * (attempt + 1)
        r = _lm_batch_core(
            torch.as_tensor(hm0_n[idx] * fac, device=obs.device),
            torch.as_tensor(bb0_n[idx] / fac, device=obs.device),
            nm0[idx_t], B_top, Es, P, B1_fix, f, obs[idx_t], alt_j,
            _env_take(bmag_j, idx_t), _env_take(bpsi_j, idx_t), **core)
        r_cost = r[5][-1].cpu().numpy()
        for k, i in enumerate(bad):
            if r_cost[k] < cost_f[i]:
                vh_c[i] = r[0][k]
                edp_c[i] = r[1][k]
                hm_c[i] = float(r[2][k])
                bb_c[i] = float(r[3][k])
                nm_c[i] = float(r[4][k])
                hist_c[:, i] = r[5][:, k]
                cost_f[i] = r_cost[k]

    F2_fit = dict(F2)
    F2_fit["Nm"] = nm_c
    F2_fit["hm"] = hm_c
    F2_fit[key2] = bb_c
    return vh_c, edp_c, F2_fit, hist_c.cpu().numpy()
