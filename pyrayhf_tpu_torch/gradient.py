"""Gradient (ray-ODE) oblique tracers, Cartesian and spherical: fixed step.

Port of the fixed-step part of ``pyrayhf_tpu.gradient`` (reference
``trace_ray_cartesian_gradient`` ref ``library.py:1271-1457``,
``trace_ray_spherical_gradient`` ref :2128-2337): RK4 of a fixed step
with the bilinear-field RHS, rays batched as a tensor dimension (the JAX
package vmaps a per-ray ``lax.scan``; here the scan is a Python loop over
steps that advances every ray at once).

* Terminal events (ground/top/lateral bounds, ref :1009-1031) are per-step
  masks: on the step that crosses a boundary the state is linearly
  backtracked to the FIRST crossed event and frozen thereafter.
* The first ``n_hops − 1`` ground crossings reflect specularly instead.
* A non-finite state freezes the ray on its last finite state.
* The direction is renormalised every step.

Ray equations (Haselgrove/Budden):
  Cartesian: dr/ds = v,  dv/ds = (∇μ − (∇μ·v)v)/μ
  Spherical: dr/ds = v_r, dφ/ds = v_φ/r,
             dv_r/ds = (μ_r − (∇μ·v)v_r)/μ + v_φ²/r
             dv_φ/ds = (μ_φ/r − (∇μ·v)v_φ)/μ − v_r v_φ/r

Not ported yet: the adaptive Dormand–Prince integrator, the early-exit
fan integrator and the single-ray ``trace_ray_*_gradient`` wrappers
(ROADMAP Queue 1).
"""

import math

import torch

from ._util import as_tensors
from .constants import C_KM_S, R_E
from .ground import _hypot

__all__ = ["trace_rays_cartesian_gradient", "trace_rays_spherical_gradient"]

_STATUS = {"length": 0, "ground": 1, "domain": 2, "attempts": 3}
_DEG2RAD = math.pi / 180.0
# steps between the host checks for "every ray frozen" (each is one sync)
_FROZEN_CHECK = 32


def _rk4_step(rhs, y, ds):
    k1 = rhs(y)
    k2 = rhs(y + 0.5 * ds * k1)
    k3 = rhs(y + 0.5 * ds * k2)
    k4 = rhs(y + ds * k3)
    return y + (ds / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)


def _make_step(rhs, ds, event_value, reflect_slot, max_bounces):
    """Batched step function: state [..., 4] = (position, direction),
    masks and counts [...]. Semantics of ``pyrayhf_tpu.gradient
    ._make_step``, ray by ray.
    """

    def step(y, alive, status, bounces):
        y_new = _rk4_step(rhs, y, ds)
        # renormalise the direction components
        v = y_new[..., 2:]
        vmag = torch.sqrt(v[..., :1] * v[..., :1] + v[..., 1:] * v[..., 1:])
        pos = vmag > 0
        v = torch.where(pos, v / torch.where(pos, vmag, 1.0), v)
        y_new = torch.cat([y_new[..., :2], v], dim=-1)

        ev_old = event_value(y)
        ev_new = event_value(y_new)
        crossed = (ev_new <= 0.0) & (ev_old > 0.0)            # [..., n_ev]
        any_cross = crossed.any(dim=-1) & alive
        # linear backtrack to the first crossing (argmax of the mask)
        j = torch.argmax(crossed.to(torch.uint8), dim=-1, keepdim=True)
        eo = torch.gather(ev_old, -1, j)
        en = torch.gather(ev_new, -1, j)
        denom = eo - en
        t = torch.where(denom != 0.0,
                        eo / torch.where(denom != 0.0, denom, 1.0), 1.0)
        t = torch.clamp(t, 0.0, 1.0)
        y_cross = y + t * (y_new - y)
        ground_hit = any_cross & (j[..., 0] == 0)
        take_cross = any_cross
        if reflect_slot is not None:
            bounce = ground_hit & (bounces < max_bounces)
            slot = y_cross[..., reflect_slot:reflect_slot + 1]
            y_refl = torch.cat([y_cross[..., :reflect_slot], torch.abs(slot),
                                y_cross[..., reflect_slot + 1:]], dim=-1)
            y_cross = torch.where(bounce[..., None], y_refl, y_cross)
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


def _integrate(rhs, y0, n_steps, ds, event_value, reflect_slot=None,
               max_bounces=0):
    """Fixed-step RK4 with freeze-on-event semantics, rays batched.

    ``y0``: [..., 4] launch states; ``event_value(y)`` → [..., n_ev]
    signed boundary distances (positive inside). ``reflect_slot``: index of
    the vertical velocity component whose first ``max_bounces`` ground
    crossings (event 0) reflect specularly. Returns (ys [..., n_steps+1,
    4], alive [..., n_steps+1], status [...]) — the scan's outputs.

    A frozen ray never changes again (its state, status and bounce count
    are absorbing), so once every ray is frozen the remaining rows are its
    final state with ``alive`` False, exactly what the scan would emit;
    the loop checks for that every few steps and stops.
    """
    step = _make_step(rhs, ds, event_value, reflect_slot, max_bounces)
    lead = y0.shape[:-1]
    alive = torch.ones(lead, dtype=torch.bool, device=y0.device)
    status = torch.full(lead, _STATUS["length"], dtype=torch.int64,
                        device=y0.device)
    bounces = torch.zeros(lead, dtype=torch.int64, device=y0.device)
    ys, alives = [y0], [alive]
    y = y0
    for i in range(n_steps):
        y, alive, status, bounces = step(y, alive, status, bounces)
        ys.append(y)
        alives.append(alive)
        if (i + 1) % _FROZEN_CHECK == 0 and not bool(alive.any()):
            rest = n_steps - i - 1
            ys.extend([y] * rest)
            alives.extend([alive] * rest)
            break
    return (torch.stack(ys, dim=-2), torch.stack(alives, dim=-1), status)


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


def _cart_gradient_core(n_and_grad, mup_func, x0, z0, elevation_deg, ds,
                        n_steps, z_ground, z_max, x_min, x_max, n_hops=1,
                        kappa_func=None):
    """Fixed-step Cartesian fan: ``elevation_deg`` [...] → metrics [...].

    ``x0``, ``z0``, ``ds`` and the bounds are 0-d tensors (or Python
    numbers) in the state's dtype; ``n_and_grad(x, z)`` and the metric
    callables take [...]-leading queries (see :mod:`.fields`).
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
    ys, alive, status = _integrate(rhs, y0, n_steps, ds, events, **hop)
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
                       n_hops=1, kappa_func=None):
    """Fixed-step spherical fan in (r, φ, v_r, v_φ); see the Cartesian."""
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
    ys, alive, status = _integrate(rhs, y0, n_steps, ds, events, **hop)
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
