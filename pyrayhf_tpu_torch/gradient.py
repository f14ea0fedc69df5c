"""Gradient (ray-ODE) oblique tracers, Cartesian and spherical.

Port of ``pyrayhf_tpu.gradient`` (reference ``trace_ray_cartesian_gradient``
ref ``library.py:1271-1457``, ``trace_ray_spherical_gradient`` ref
:2128-2337): fixed-step RK4 or the error-controlled Dormand–Prince 5(4)
pair with the bilinear-field RHS, rays batched as a tensor dimension (the
JAX package vmaps a per-ray ``lax.scan``; here the scan is a Python loop
over steps that advances every ray at once).

* Terminal events (ground/top/lateral bounds, ref :1009-1031) are per-step
  masks: on the step that crosses a boundary the state is linearly
  backtracked to the FIRST crossed event and frozen thereafter.
* The first ``n_hops − 1`` ground crossings reflect specularly instead.
* A non-finite state freezes the ray on its last finite state.
* The direction is renormalised every step (every accepted attempt).
* The adaptive integrator (``rtol``/``atol`` given) runs attempts: a
  rejected attempt shrinks h and emits an unchanged state; each ray keeps
  its own h, arc length, status and bounces.
* The loops stop early once every ray is frozen, checking that every
  ``_FROZEN_CHECK`` steps (one host read each); a frozen ray never changes
  again, so the rows left are filled with its final state, as the
  full-length loop would emit them.

Ray equations (Haselgrove/Budden):
  Cartesian: dr/ds = v,  dv/ds = (∇μ − (∇μ·v)v)/μ
  Spherical: dr/ds = v_r, dφ/ds = v_φ/r,
             dv_r/ds = (μ_r − (∇μ·v)v_r)/μ + v_φ²/r
             dv_φ/ds = (μ_φ/r − (∇μ·v)v_φ)/μ − v_r v_φ/r

The fixed-step machinery takes the JAX package's ``v_slice`` (the
direction components renormalised every step: 2:4 for the 2-D state, 3:6
for the 3-D ECEF state), ``reflect_fn`` (a position-dependent ground
mirror, e.g. the 3-D local vertical) and ``renorm_fn`` (a per-step state
projection replacing the renormalisation: the anisotropic tracer's
dispersion shell). :func:`_integrate_fan` is the 3-D tracers' batched fan
integrator: :func:`_integrate` over [R, dim] launch states.
"""

import math

import torch

from ._util import as_tensors
from .config import UNSET, resolve
from .constants import C_KM_S, R_E
from .ground import _hypot

__all__ = ["trace_ray_cartesian_gradient", "trace_ray_spherical_gradient",
           "trace_rays_cartesian_gradient", "trace_rays_spherical_gradient"]

_STATUS = {"length": 0, "ground": 1, "domain": 2, "attempts": 3}
_DEG2RAD = math.pi / 180.0
# steps between the host checks for "every ray frozen" (each is one sync)
_FROZEN_CHECK = 32
# the last integration's steps (or attempts) run, of how many, and the
# chunks of _FROZEN_CHECK steps that ran (set by _integrate and
# _integrate_adaptive)
EXIT_STATS = {"steps": 0, "of": 0, "chunks": 0}


def _rk4_step(rhs, y, ds):
    k1 = rhs(y)
    k2 = rhs(y + 0.5 * ds * k1)
    k3 = rhs(y + 0.5 * ds * k2)
    k4 = rhs(y + ds * k3)
    return y + (ds / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)


def _make_step(rhs, ds, event_value, reflect_slot, max_bounces,
               v_slice=slice(2, 4), reflect_fn=None, renorm_fn=None):
    """Batched step function: state [..., dim], masks and counts [...].
    Semantics of ``pyrayhf_tpu.gradient._make_step``, ray by ray.
    ``reflect_fn`` (a mirror ``y → y``) replaces the default reflection
    of component ``reflect_slot``; ``renorm_fn`` (a projection ``y → y``)
    replaces the unit renormalisation of ``v_slice``.
    """
    reflect_fn = _reflector(reflect_slot, reflect_fn)

    def step(y, alive, status, bounces):
        y_new = _rk4_step(rhs, y, ds)
        y_new = (renorm_fn(y_new) if renorm_fn is not None
                 else _renormalised(y_new, v_slice))
        any_cross, j, y_cross, _ = _first_crossing(y, y_new, event_value(y),
                                                   event_value(y_new))
        any_cross = any_cross & alive
        ground_hit = any_cross & (j[..., 0] == 0)
        take_cross = any_cross
        if reflect_fn is not None:
            bounce = ground_hit & (bounces < max_bounces)
            y_cross = torch.where(bounce[..., None], reflect_fn(y_cross),
                                  y_cross)
            bounces = bounces + bounce.to(bounces.dtype)
            any_cross = any_cross & ~bounce
            ground_hit = ground_hit & ~bounce
        y_next = torch.where(alive[..., None],
                             torch.where(take_cross[..., None], y_cross,
                                         y_new), y)
        status = torch.where(
            any_cross,
            torch.where(ground_hit, _STATUS["ground"], _STATUS["domain"]),
            status)
        alive_next = alive & ~any_cross
        # a dead RHS (NaN μ region) also freezes the ray
        bad = ~torch.isfinite(y_next).all(dim=-1)
        y_next = torch.where(bad[..., None], y, y_next)
        alive_next = alive_next & ~bad
        return y_next, alive_next, status, bounces

    return step


def _reflector(reflect_slot, reflect_fn):
    """The ground mirror: ``reflect_fn``, else |component reflect_slot|,
    else None (no bounces)."""
    if reflect_fn is None and reflect_slot is not None:
        return lambda y: _reflect(y, reflect_slot)
    return reflect_fn


def _renormalised(y, v_slice=slice(2, 4)):
    """The state with its direction components ``v_slice`` at unit
    length (the squares summed in component order)."""
    v = y[..., v_slice]
    sq = v[..., :1] * v[..., :1]
    for k in range(1, v.shape[-1]):
        sq = sq + v[..., k:k + 1] * v[..., k:k + 1]
    vmag = torch.sqrt(sq)
    pos = vmag > 0
    v = torch.where(pos, v / torch.where(pos, vmag, 1.0), v)
    return torch.cat([y[..., :v_slice.start], v, y[..., v_slice.stop:]],
                     dim=-1)


def _first_crossing(y, y_new, ev_old, ev_new):
    """The first crossed event per ray: (crossed any, j [..., 1], y backtracked
    linearly to it, t [..., 1]); j is 0 when none crossed."""
    crossed = (ev_new <= 0.0) & (ev_old > 0.0)            # [..., n_ev]
    j = torch.argmax(crossed.to(torch.uint8), dim=-1, keepdim=True)
    eo = torch.gather(ev_old, -1, j)
    en = torch.gather(ev_new, -1, j)
    denom = eo - en
    t = torch.where(denom != 0.0,
                    eo / torch.where(denom != 0.0, denom, 1.0), 1.0)
    t = torch.clamp(t, 0.0, 1.0)
    return crossed.any(dim=-1), j, y + t * (y_new - y), t


def _reflect(y, slot):
    """Specular ground reflection: |component ``slot``|."""
    s = y[..., slot:slot + 1]
    return torch.cat([y[..., :slot], torch.abs(s), y[..., slot + 1:]],
                     dim=-1)


def _run(step, carry, n_steps, early_exit, check_every=_FROZEN_CHECK):
    """Run ``step`` ``n_steps`` times; carry[0] is the state, carry[1] the
    alive mask. Returns (states, alives, final carry); see the module
    docstring for the early exit, checked every ``check_every`` steps.

    The rows are written into buffers allocated once (a list of rows
    stacked at the end would hold the path twice); a state that carries
    an autograd graph is stacked instead, so the backward sees one node.
    """
    y, alive = carry[0], carry[1]
    graph = torch.is_grad_enabled()
    if graph:
        ys, alives = [y], [alive]
    else:
        ys = y.new_empty(y.shape[:-1] + (n_steps + 1, y.shape[-1]))
        alives = alive.new_empty(alive.shape + (n_steps + 1,))
        ys[..., 0, :] = y
        alives[..., 0] = alive
    run = n_steps
    for i in range(n_steps):
        carry = step(*carry)
        if graph:
            ys.append(carry[0])
            alives.append(carry[1])
        else:
            ys[..., i + 1, :] = carry[0]
            alives[..., i + 1] = carry[1]
        if (early_exit and (i + 1) % check_every == 0 and i + 1 < n_steps
                and not bool(carry[1].any())):
            run = i + 1
            if graph:
                rest = n_steps - run
                ys.extend([carry[0]] * rest)
                alives.extend([carry[1]] * rest)
            else:
                ys[..., run + 1:, :] = carry[0][..., None, :]
                alives[..., run + 1:] = carry[1][..., None]
            break
    EXIT_STATS.update(steps=run, of=n_steps,
                      chunks=-(-run // check_every))
    if graph:
        return torch.stack(ys, dim=-2), torch.stack(alives, dim=-1), carry
    return ys, alives, carry


def _integrate(rhs, y0, n_steps, ds, event_value, reflect_slot=None,
               max_bounces=0, early_exit=True, v_slice=slice(2, 4),
               reflect_fn=None, renorm_fn=None, check_every=_FROZEN_CHECK):
    """Fixed-step RK4 with freeze-on-event semantics, rays batched.

    ``y0``: [..., dim] launch states; ``event_value(y)`` → [..., n_ev]
    signed boundary distances (positive inside). ``reflect_slot``: index of
    the vertical velocity component whose first ``max_bounces`` ground
    crossings (event 0) reflect specularly; ``reflect_fn`` a mirror
    ``y → y`` used instead. ``v_slice``/``renorm_fn``: see
    :func:`_make_step`. Returns (ys [..., n_steps+1, dim], alive [...,
    n_steps+1], status [...]) — the scan's outputs. ``early_exit``: stop
    once every ray is frozen (same outputs).
    """
    step = _make_step(rhs, ds, event_value, reflect_slot, max_bounces,
                      v_slice, reflect_fn, renorm_fn)
    lead = y0.shape[:-1]
    alive = torch.ones(lead, dtype=torch.bool, device=y0.device)
    status = torch.full(lead, _STATUS["length"], dtype=torch.int64,
                        device=y0.device)
    bounces = torch.zeros(lead, dtype=torch.int64, device=y0.device)
    ys, alive, (_, _, status, _) = _run(step, (y0, alive, status, bounces),
                                        n_steps, early_exit, check_every)
    return ys, alive, status


def _integrate_fan(rhs, y0b, n_steps, ds, event_value, reflect_slot=None,
                   max_bounces=0, v_slice=slice(2, 4), reflect_fn=None,
                   renorm_fn=None, chunk=125):
    """The 3-D tracers' batched early-exit fan integrator.

    ``y0b``: [R, dim] launch states. The whole fan advances in one loop
    that stops once every ray is frozen, checked every ``chunk`` steps
    (one host read each); the rows left repeat each ray's final state
    with ``alive`` False, as ``pyrayhf_tpu.gradient._integrate_fan`` fills
    its tail. ``chunk`` sets only that cadence: the outputs do not depend
    on it. Returns (ys [R, n_steps+1, dim], alive [R, n_steps+1],
    status [R]).
    """
    chunk = max(1, min(int(chunk), int(n_steps)))
    return _integrate(rhs, y0b, int(n_steps), ds, event_value,
                      reflect_slot=reflect_slot, max_bounces=max_bounces,
                      early_exit=True, v_slice=v_slice,
                      reflect_fn=reflect_fn, renorm_fn=renorm_fn,
                      check_every=chunk)


# Dormand–Prince 5(4) embedded pair (the same tableau scipy's RK45 uses).
_DP_A = (
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
)
_DP_B5 = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
_DP_B4 = (5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200,
          187 / 2100, 1 / 40)


def _dp45_step(rhs, y, h):
    """One Dormand–Prince attempt: (y5, err_vec) for step sizes h [..., 1]."""
    k = [rhs(y)]
    for row in _DP_A:
        acc = torch.zeros_like(y)
        for a, kk in zip(row, k):
            acc = acc + a * kk
        k.append(rhs(y + h * acc))
    y5 = y
    err = torch.zeros_like(y)
    for b5, b4, kk in zip(_DP_B5, _DP_B4, k):
        y5 = y5 + h * b5 * kk
        err = err + h * (b5 - b4) * kk
    return y5, err


def _integrate_adaptive(rhs, y0, n_attempts, s_max, h0, rtol, atol, h_max,
                        event_value, reflect_slot=None, max_bounces=0,
                        early_exit=True, v_slice=slice(2, 4),
                        reflect_fn=None):
    """Error-controlled DP45 with freeze-on-event semantics, rays batched.

    Same output contract as :func:`_integrate`, but each iteration is an
    embedded 5(4) ATTEMPT per ray: rejected attempts shrink h and emit an
    unchanged state (a zero-length path segment); accepted attempts advance
    s and adapt h with the 0.9·err^(−1/5) controller. A ray freezes at
    s ≥ ``s_max``, on its first boundary event (linear backtrack) or when
    an attempt is non-finite even at the minimum step. ``s_max``,
    ``rtol``, ``atol`` and ``h_max`` are numbers; ``h0`` a 0-d tensor.
    A ray still alive after all attempts with s < s_max gets the
    'attempts' status. ``v_slice``/``reflect_fn``: see :func:`_make_step`.
    """
    reflect_fn = _reflector(reflect_slot, reflect_fn)

    def attempt(y, alive, h, s, status, bounces):
        h_try = torch.minimum(h, torch.clamp(s_max - s, min=1e-12))
        y5, err = _dp45_step(rhs, y, h_try[..., None])
        scale = atol + rtol * torch.maximum(torch.abs(y), torch.abs(y5))
        err_norm = torch.amax(torch.abs(err) / scale, dim=-1)
        ok_num = torch.isfinite(y5).all(dim=-1)
        # a non-finite attempt (NaN μ-gradient region; or atol=0 with a
        # zero state component) must SHRINK the step, not take the
        # err == 0 growth branch of the controller
        err_norm = torch.where(torch.isfinite(err_norm) & ok_num, err_norm,
                               math.inf)
        accept = (err_norm <= 1.0) & ok_num
        # err_norm = inf → fac 0 → clipped to the 0.2 shrink floor; the
        # power is taken only where err_norm > 0
        pos = err_norm > 0.0
        fac = torch.where(pos, 0.9 * torch.where(pos, err_norm, 1.0) ** -0.2,
                          5.0)
        h_new = torch.clamp(h_try * torch.clamp(fac, 0.2, 5.0), 1e-9, h_max)
        # non-finite even at the minimum step size: it can never succeed
        dead = ~ok_num & (h_try <= 2e-9)
        y5 = _renormalised(y5, v_slice)

        any_cross, j, y_cross, t = _first_crossing(y, y5, event_value(y),
                                                   event_value(y5))
        any_cross = any_cross & alive & accept
        t = t[..., 0]
        ground_hit = any_cross & (j[..., 0] == 0)
        if reflect_fn is not None:
            bounce = ground_hit & (bounces < max_bounces)
            y_cross = torch.where(bounce[..., None], reflect_fn(y_cross),
                                  y_cross)
            bounces = bounces + bounce.to(bounces.dtype)
            any_cross = any_cross & ~bounce
            ground_hit = ground_hit & ~bounce
            # a bounce advances s only to the crossing
            t_adv = torch.where(bounce, t, torch.where(any_cross, t, 1.0))
        else:
            t_adv = torch.where(any_cross, t, 1.0)
        step_ok = alive & accept
        y_next = torch.where(step_ok[..., None],
                             torch.where(any_cross[..., None], y_cross, y5),
                             y)
        if reflect_fn is not None:
            y_next = torch.where((step_ok & bounce)[..., None], y_cross,
                                 y_next)
        s_next = torch.where(step_ok, s + h_try * t_adv, s)
        status = torch.where(
            any_cross,
            torch.where(ground_hit, _STATUS["ground"], _STATUS["domain"]),
            status)
        alive_next = alive & ~any_cross & (s_next < s_max) & ~dead
        return (y_next, alive_next, torch.where(alive, h_new, h), s_next,
                status, bounces)

    lead = y0.shape[:-1]
    kw = dict(device=y0.device)
    carry = (y0, torch.ones(lead, dtype=torch.bool, **kw),
             torch.zeros(lead, dtype=y0.dtype, **kw) + h0,
             torch.zeros(lead, dtype=y0.dtype, **kw),
             torch.full(lead, _STATUS["length"], dtype=torch.int64, **kw),
             torch.zeros(lead, dtype=torch.int64, **kw))
    ys, alive, (_, alive_fin, _, s_fin, status, _) = _run(
        attempt, carry, n_attempts, early_exit)
    # alive after every attempt with s < s_max: the attempt budget ran out
    exhausted = alive_fin & (s_fin < s_max)
    status = torch.where(exhausted, _STATUS["attempts"], status)
    return ys, alive, status


def _path_metrics(x_path, z_path, ds_seg, mup_mid, status, mu_mid=None):
    """Per-ray metrics along the last axis (nansum semantics)."""
    group_path = torch.nansum(ds_seg, dim=-1)
    valid = torch.isfinite(mup_mid)
    group_delay = torch.nansum(
        torch.where(valid, mup_mid / C_KM_S * ds_seg, 0.0), dim=-1)
    zq = torch.where(torch.isnan(z_path), -math.inf, z_path)
    apex_idx = torch.argmax(zq, dim=-1, keepdim=True)
    x_apex = torch.gather(x_path, -1, apex_idx)[..., 0]
    z_apex = torch.gather(z_path, -1, apex_idx)[..., 0]
    s_cum = torch.cumsum(ds_seg, dim=-1)
    mid_idx = torch.searchsorted(s_cum.contiguous(),
                                 (0.5 * group_path)[..., None].contiguous())
    x_mid = torch.gather(x_path, -1, mid_idx)[..., 0]
    z_mid = torch.gather(z_path, -1, mid_idx)[..., 0]
    landed = status == _STATUS["ground"]
    ground_range = torch.where(landed, x_path[..., -1], float("nan"))
    out = {"group_path_km": group_path, "group_delay_sec": group_delay,
           "x_midpoint": x_mid, "z_midpoint": z_mid,
           "ground_range_km": ground_range,
           "x_apex_km": x_apex, "z_apex_km": z_apex}
    if mu_mid is not None:
        out["phase_path_km"] = torch.nansum(
            torch.where(torch.isfinite(mu_mid), mu_mid * ds_seg, 0.0),
            dim=-1)
    return out


def _absorption(kappa_mid, ds_seg):
    return torch.nansum(
        torch.where(torch.isfinite(kappa_mid), kappa_mid * ds_seg, 0.0),
        dim=-1)


def _launch_direction(elevation_deg, spherical):
    """The launch direction components of the state, in its order:
    (vx, vz) normalised, Cartesian; (v_r, v_φ), spherical."""
    elev = elevation_deg * _DEG2RAD
    if spherical:
        return torch.sin(elev), torch.cos(elev)
    vx, vz = torch.cos(elev), torch.sin(elev)
    vmag = torch.sqrt(vx * vx + vz * vz)
    return vx / vmag, vz / vmag


def _integrator(rhs, y0, n_steps, ds, events, hop, integ):
    """Fixed-step RK4, or DP45 when ``integ`` holds its numbers (rtol,
    atol, s_max, h_max); ``integ["early_exit"]`` (default True) for
    either."""
    early_exit = integ.get("early_exit", True)
    if integ.get("s_max") is not None:
        return _integrate_adaptive(
            rhs, y0, n_steps, integ["s_max"], ds, integ["rtol"],
            integ["atol"], integ["h_max"], events, early_exit=early_exit,
            **hop)
    return _integrate(rhs, y0, n_steps, ds, events, early_exit=early_exit,
                      **hop)


def _cart_gradient_core(n_and_grad, mup_func, x0, z0, elevation_deg, ds,
                        n_steps, z_ground, z_max, x_min, x_max, n_hops=1,
                        kappa_func=None, **integ):
    """Cartesian fan: ``elevation_deg`` [...] → metrics [...].

    ``x0``, ``z0``, ``ds`` and the bounds are 0-d tensors (or Python
    numbers) in the state's dtype; ``n_and_grad(x, z)`` and the metric
    callables take [...]-leading queries (see :mod:`.fields`). Fixed-step
    RK4 of ``ds``, or, with ``rtol``/``atol``/``s_max``/``h_max`` given in
    ``integ``, DP45 attempts from the initial step ``ds``;
    ``early_exit`` (default True): see the module docstring.
    """
    vx, vz = _launch_direction(elevation_deg, False)
    y0 = torch.stack([torch.zeros_like(vx) + x0, torch.zeros_like(vz) + z0,
                      vx, vz], dim=-1)

    def rhs(y):
        x, z, vx, vz = y.unbind(-1)
        n, dndx, dndz = n_and_grad(x, z)
        ok = torch.isfinite(n) & (n > 0.0)
        n_s = torch.where(ok, n, 1.0)
        gdv = dndx * vx + dndz * vz
        d = torch.stack([vx, vz, (dndx - gdv * vx) / n_s,
                         (dndz - gdv * vz) / n_s], dim=-1)
        return torch.where(ok[..., None], d, 0.0)

    def events(y):
        # ground, top, left, right (ref :1370-1373); positive == inside
        x, z = y[..., 0], y[..., 1]
        return torch.stack([z - z_ground - 1e-3, z_max - z, x - x_min,
                            x_max - x], dim=-1)

    hop = dict(reflect_slot=3, max_bounces=n_hops - 1) if n_hops > 1 else {}
    ys, alive, status = _integrator(rhs, y0, n_steps, ds, events, hop,
                                    integ)
    x_path, z_path = ys[..., 0], ys[..., 1]
    dx = torch.diff(x_path, dim=-1)
    dz = torch.diff(z_path, dim=-1)
    ds_seg = _hypot(dx, dz)
    x_m = 0.5 * (x_path[..., :-1] + x_path[..., 1:])
    z_m = 0.5 * (z_path[..., :-1] + z_path[..., 1:])
    mup_mid = mup_func(x_m, z_m)
    fld = getattr(n_and_grad, "field", None)
    mu_mid = (fld.value(z_m, x_m) if fld is not None
              else n_and_grad(x_m, z_m)[0])
    out = _path_metrics(x_path, z_path, ds_seg, mup_mid, status, mu_mid)
    if kappa_func is not None:
        out["absorption_db"] = _absorption(kappa_func(x_m, z_m), ds_seg)
    out.update({"x": x_path, "z": z_path, "vx": ys[..., 2],
                "vz": ys[..., 3], "status_code": status, "alive": alive})
    return out


def _sph_gradient_core(n_and_grad_rphi, mup_func, x0, z0, elevation_deg, ds,
                       n_steps, re, z_ground, r_max, phi_min, phi_max,
                       n_hops=1, kappa_func=None, **integ):
    """Spherical fan in (r, φ, v_r, v_φ); see the Cartesian."""
    r0 = re + z0
    phi0 = x0 / re
    v_r, v_phi = _launch_direction(elevation_deg, True)
    y0 = torch.stack([torch.zeros_like(v_r) + r0,
                      torch.zeros_like(v_r) + phi0, v_r, v_phi], dim=-1)

    def rhs(y):
        r, phi, v_r, v_phi = y.unbind(-1)
        mu, mu_r, mu_phi = n_and_grad_rphi(phi, r)
        ok = torch.isfinite(mu) & (mu > 0.0)
        mu_s = torch.where(ok, mu, 1.0)
        gdv = mu_r * v_r + (mu_phi / r) * v_phi
        d = torch.stack([
            v_r,
            v_phi / r,
            (mu_r - gdv * v_r) / mu_s + v_phi * v_phi / r,
            ((mu_phi / r) - gdv * v_phi) / mu_s - v_r * v_phi / r,
        ], dim=-1)
        return torch.where(ok[..., None], d, 0.0)

    def events(y):
        # ground, top, phi bounds (ref :2239-2243); positive == inside
        r, phi = y[..., 0], y[..., 1]
        return torch.stack([r - (re + z_ground) - 1e-3, r_max - r,
                            phi - phi_min, phi_max - phi], dim=-1)

    hop = dict(reflect_slot=2, max_bounces=n_hops - 1) if n_hops > 1 else {}
    ys, alive, status = _integrator(rhs, y0, n_steps, ds, events, hop,
                                    integ)
    r_path, phi_path = ys[..., 0], ys[..., 1]
    x_path = re * phi_path
    z_path = r_path - re
    dr = torch.diff(r_path, dim=-1)
    dphi = torch.diff(phi_path, dim=-1)
    r_mid = 0.5 * (r_path[..., :-1] + r_path[..., 1:])
    rdphi = r_mid * dphi
    ds_seg = torch.sqrt(dr * dr + rdphi * rdphi)
    x_m = 0.5 * (x_path[..., :-1] + x_path[..., 1:])
    z_m = 0.5 * (z_path[..., :-1] + z_path[..., 1:])
    mup_mid = mup_func(x_m, z_m)
    phi_m = 0.5 * (phi_path[..., :-1] + phi_path[..., 1:])
    fld = getattr(n_and_grad_rphi, "field", None)
    mu_mid = (fld.value(re + z_m, phi_m) if fld is not None
              else n_and_grad_rphi(phi_m, re + z_m)[0])
    out = _path_metrics(x_path, z_path, ds_seg, mup_mid, status, mu_mid)
    if kappa_func is not None:
        out["absorption_db"] = _absorption(kappa_func(x_m, z_m), ds_seg)
    out.update({"x": x_path, "z": z_path, "r": r_path, "phi": phi_path,
                "v_r": ys[..., 2], "v_phi": ys[..., 3],
                "status_code": status, "alive": alive})
    return out


def _like(field_of, *xs):
    """Scalars and host arrays as tensors in the interpolant's dtype and
    device (the field decides; the grids and knobs are host data)."""
    fld = getattr(field_of, "field", None)
    if fld is None:
        return as_tensors(*xs)
    return as_tensors(*xs, fld.field, dtype=fld.field.dtype)[:len(xs)]


def trace_rays_cartesian_gradient(n_and_grad, mup_func, x0_km, z0_km,
                                  elevation_deg, s_max_km=5000.0, *,
                                  step_km=1.0, z_ground_km=0.0,
                                  z_max_km=1000.0, x_min_km=-1e6,
                                  x_max_km=1e6, n_hops=1):
    """Batched Cartesian ODE fan over elevations [E] (ref :1271-1457).

    ``n_and_grad``/``mup_func``: callables from :mod:`.fields`'
    ``build_refractive_index_interpolator_cartesian`` and
    ``build_mup_function``. Returns the
    per-ray metrics [E] and paths [E, n_steps+1], as the JAX function.
    """
    n_steps = int(round(float(s_max_km) / float(step_km)))
    x0, z0, el, ds, zg, zm, xl, xh = _like(
        n_and_grad, x0_km, z0_km, elevation_deg, step_km, z_ground_km,
        z_max_km, x_min_km, x_max_km)
    return _cart_gradient_core(n_and_grad, mup_func, x0, z0, el, ds,
                               n_steps, zg, zm, xl, xh, n_hops=int(n_hops))


def trace_rays_spherical_gradient(n_and_grad_rphi, mup_func, x0_km, z0_km,
                                  elevation_deg, s_max_km=6000.0, *,
                                  R_E=None, z_ground_km=0.0, r_max_km=None,
                                  phi_min=-math.pi, phi_max=math.pi,
                                  step_km=1.0, n_hops=1):
    """Batched spherical ODE fan over elevations [E] (ref :2128-2337)."""
    re = globals()["R_E"] if R_E is None else float(R_E)
    if r_max_km is None:
        r_max_km = re + 1200.0
    n_steps = int(round(float(s_max_km) / float(step_km)))
    x0, z0, el, ds, re_t, zg, rm, pl, ph = _like(
        n_and_grad_rphi, x0_km, z0_km, elevation_deg, step_km, re,
        z_ground_km, r_max_km, phi_min, phi_max)
    return _sph_gradient_core(n_and_grad_rphi, mup_func, x0, z0, el, ds,
                              n_steps, re_t, zg, rm, pl, ph,
                              n_hops=int(n_hops))


def _steps_and_integrator(s_max_km, step_km, rtol, atol, max_step_km,
                          early_exit):
    """(step_km, steps or attempts, integrator kwargs) of a single-ray
    trace: DP45 when rtol or atol is set (twice the fixed-step count of
    attempts, the reference's defaults for the one not given), else RK4 of
    ``step_km`` capped by ``max_step_km``."""
    if rtol is not None or atol is not None:
        n = 2 * int(round(float(s_max_km) / float(step_km)))
        return step_km, n, dict(
            rtol=1e-7 if rtol is None else float(rtol),
            atol=1e-9 if atol is None else float(atol),
            s_max=float(s_max_km),
            h_max=math.inf if max_step_km is None else float(max_step_km),
            early_exit=bool(early_exit))
    if max_step_km is not None:
        step_km = min(step_km, float(max_step_km))
    return (step_km, int(round(float(s_max_km) / float(step_km))),
            dict(early_exit=bool(early_exit)))


def _with_status(out):
    """The status code as the JAX function's string (one host read)."""
    code = int(out.pop("status_code"))
    out["status"] = {v: k for k, v in _STATUS.items()}[code]
    out["t"] = None
    return out


def trace_ray_cartesian_gradient(n_and_grad, mup_func, x0_km, z0_km,
                                 elevation_deg, s_max_km=None, *,
                                 step_km=None, z_ground_km=None,
                                 z_min_km=-1.0, z_max_km=None,
                                 x_min_km=None, x_max_km=None,
                                 rtol=UNSET, atol=UNSET, max_step_km=None,
                                 renormalize_every=None, n_hops=1,
                                 kappa_func=None, config=None,
                                 early_exit=True):
    """2-D Cartesian ray-ODE trace of one ray; API-parity with ref
    :1271-1457 and the JAX function.

    ``n_hops``: the first ``n_hops − 1`` ground contacts reflect
    specularly. ``kappa_func``: an absorption-coefficient interpolant
    κ(x, z) [dB/km]; the result then carries ``absorption_db``. With
    ``rtol``/``atol`` given (the reference's defaults are 1e-7/1e-9) the
    integrator is the embedded Dormand–Prince 5(4) pair (``step_km`` the
    initial step, ``max_step_km`` the cap); with both None, fixed-step RK4
    of ``step_km`` (default 1 km). ``renormalize_every`` and ``z_min_km``
    are accepted for API compatibility. A
    :class:`pyrayhf_tpu_torch.config.GradientTracerConfig` passed as
    ``config`` supplies any knob not given explicitly; an explicit
    ``rtol=None, atol=None`` forces RK4. ``early_exit``: stop the loop once
    the ray is frozen (same outputs). Tensors lie on the field's device.
    """
    s_max_km = resolve(config, "s_max_km", s_max_km, 5000.0)
    step_km = resolve(config, "step_km", step_km, 1.0)
    z_ground_km = resolve(config, "z_ground_km", z_ground_km, 0.0)
    z_max_km = resolve(config, "z_max_km", z_max_km, 1000.0)
    x_min_km = resolve(config, "x_min_km", x_min_km, -1e6)
    x_max_km = resolve(config, "x_max_km", x_max_km, 1e6)
    rtol = resolve(config, "rtol", rtol, UNSET)
    atol = resolve(config, "atol", atol, UNSET)
    del renormalize_every, z_min_km
    if mup_func is None:
        raise ValueError(
            "mup_func must be provided, build it with build_mup_function.")
    step_km, n_steps, kw = _steps_and_integrator(s_max_km, step_km, rtol,
                                                 atol, max_step_km,
                                                 early_exit)
    x0, z0, el, ds, zg, zm, xl, xh = _like(
        n_and_grad, x0_km, z0_km, elevation_deg, step_km, z_ground_km,
        z_max_km, x_min_km, x_max_km)
    return _with_status(_cart_gradient_core(
        n_and_grad, mup_func, x0, z0, el, ds, n_steps, zg, zm, xl, xh,
        n_hops=int(n_hops), kappa_func=kappa_func, **kw))


def trace_ray_spherical_gradient(n_and_grad_rphi, mup_func, x0_km, z0_km,
                                 elevation_deg, s_max_km=None, *,
                                 R_E=None, z_ground_km=None, r_max_km=None,
                                 phi_min=-math.pi, phi_max=math.pi,
                                 step_km=None, rtol=UNSET, atol=UNSET,
                                 max_step_km=2.0, renormalize_every=None,
                                 n_hops=1, kappa_func=None, config=None,
                                 early_exit=True):
    """2-D spherical ray-ODE trace of one ray; API-parity with ref
    :2128-2337 and the JAX function.

    ``n_hops``/``kappa_func``/``rtol``/``atol``/``early_exit``: see
    :func:`trace_ray_cartesian_gradient` (RK4 steps are capped by
    ``max_step_km``, default 2 km). ``config`` supplies the arc budget
    (``s_max_km``), step and ground/tolerance knobs; without one the arc
    budget is 6000 km. Bounds are ``r_max_km`` (default R_E + 1200 km)
    and ``phi_min``/``phi_max``.
    """
    s_max_km = resolve(config, "s_max_km", s_max_km, 6000.0)
    z_ground_km = resolve(config, "z_ground_km", z_ground_km, 0.0)
    step_km = resolve(config, "step_km", step_km, 1.0)
    rtol = resolve(config, "rtol", rtol, UNSET)
    atol = resolve(config, "atol", atol, UNSET)
    del renormalize_every
    if mup_func is None:
        raise ValueError("mup_func must be provided — build it with "
                         "build_mup_function(..., geometry='spherical').")
    re = globals()["R_E"] if R_E is None else float(R_E)
    if r_max_km is None:
        r_max_km = re + 1200.0
    step_km, n_steps, kw = _steps_and_integrator(s_max_km, step_km, rtol,
                                                 atol, max_step_km,
                                                 early_exit)
    x0, z0, el, ds, re_t, zg, rm, pl, ph = _like(
        n_and_grad_rphi, x0_km, z0_km, elevation_deg, step_km, re,
        z_ground_km, r_max_km, phi_min, phi_max)
    return _with_status(_sph_gradient_core(
        n_and_grad_rphi, mup_func, x0, z0, el, ds, n_steps, re_t, zg, rm, pl,
        ph, n_hops=int(n_hops), kappa_func=kappa_func, **kw))
