"""Oblique ionograms: the T→R homing problem, batched.

Port of ``pyrayhf_tpu.oblique``: the whole (frequency × elevation) ray fan
in one batched call, then the low and high rays that home onto a link of
given ground range, vectorised over frequencies —

* :func:`synthesize_oblique_ionogram`: the Snell fan of one stratified
  profile (:mod:`.snell`);
* :func:`synthesize_oblique_ionogram_2d`: the gradient-ODE fan through an
  altitude × ground-range slice.

Conventions (as the JAX module):

* the LOW ray is the first elevation (scanning upward) whose landing range
  crosses the target; the HIGH ray is the last such crossing;
* frequencies whose fan never reaches the target range (above the link
  MUF) return NaN — the nose of the oblique ionogram.

The fan runs on the CUDA fan kernel (``csrc/fan2d.cu``) for CUDA tensors
on uniform grids, its tables written from the slice by
``csrc/fan_tables.cu``
(:func:`pyrayhf_tpu_torch.pallas_ray.fan_from_slice`; under
``torch.func`` transforms the fields go through
:func:`pyrayhf_tpu_torch.pallas_ray.fan_2d_pallas`), and on the plain
gradient-ODE fan of :mod:`.gradient` otherwise (``engine="auto"``). The
Snell fan is plain PyTorch, as it is XLA code in the JAX package.
"""

import math

import numpy as np
import torch

from ._util import as_tensors, host_f64
from .constants import C_KM_S, R_E
from .magnetoionic import mode_multiplier
from .profiling import span

__all__ = ["synthesize_oblique_ionogram",
           "synthesize_oblique_ionogram_2d"]

_DEG2RAD = math.pi / 180.0
_NAN = float("nan")


def _crossings(range_e, chans, elev, target, max_jump, delay_min):
    """Low/high-ray crossings of each [..., E] elevation fan.

    ``range_e``: [..., E] landing ranges (NaN where the ray escapes);
    ``chans``: tuple of [..., E] channels to interpolate at the crossings,
    group delay FIRST (it feeds the physicality filter); ``elev``: [E] deg.
    Sign changes of (range − target) between consecutive valid elevations
    are linearly interpolated. Pairs whose range jumps by more than
    ``max_jump`` (layer transitions) and crossings whose delay is below
    ``delay_min`` (the straight-line light time) are rejected.

    Returns (lo, hi): each a tuple of [...] tensors — the interpolated
    ``chans``, then the crossing elevation [deg] and the pair's slope
    dD/dβ [km/rad]; NaN where no physical crossing exists.
    """
    d = range_e - target
    ok = torch.isfinite(d)
    okpair = ok[..., :-1] & ok[..., 1:]
    continuous = torch.abs(range_e[..., 1:] - range_e[..., :-1]) <= max_jump
    d0, d1 = d[..., :-1], d[..., 1:]
    cross = (okpair & continuous & (torch.sign(d0) * torch.sign(d1) <= 0.0)
             & ((d0 != 0.0) | (d1 != 0.0)))
    # interpolate every pair, then filter on physicality
    t = torch.where(d1 != d0, d0 / torch.where(d1 != d0, d0 - d1, 1.0), 0.0)
    t = torch.clamp(t, 0.0, 1.0)
    el_pair = elev[:-1] + t * (elev[1:] - elev[:-1])
    sl_pair = ((range_e[..., 1:] - range_e[..., :-1])
               / ((elev[1:] - elev[:-1]) * _DEG2RAD))
    pairs = [c[..., :-1] + t * (c[..., 1:] - c[..., :-1]) for c in chans]
    pairs += [el_pair, sl_pair]
    valid = cross & (pairs[0] >= delay_min)
    any_cross = valid.any(dim=-1)
    v8 = valid.to(torch.uint8)
    first = torch.argmax(v8, dim=-1, keepdim=True)
    last = (d.shape[-1] - 2) - torch.argmax(v8.flip(-1), dim=-1, keepdim=True)

    def pick(idx):
        return tuple(torch.where(any_cross, torch.gather(p, -1, idx)[..., 0],
                                 _NAN) for p in pairs)

    return pick(first), pick(last)


def _focusing_gain_db(path_km, slope_km_rad, elev_deg, d_total_km,
                      geometry):
    """Ionospheric focusing gain [dB] relative to free space over the same
    (group) path: G = s² cosβ / (R_E·sin(D/R_E) · |dD/dβ| · sinβ) (flat
    Earth: R_E·sin(D/R_E) → D; Davies, *Ionospheric Radio*, ch. 7)."""
    beta = elev_deg * _DEG2RAD
    spread = (d_total_km if geometry == "cartesian"
              else R_E * math.sin(d_total_km / R_E))
    g = (path_km * path_km * torch.cos(beta)
         / (spread * torch.abs(slope_km_rad) * torch.sin(beta)))
    return 10.0 * torch.log10(g)


def _link_loss_db(f0s_hz, path_km, absorb_db, focus_db, ground_db=0.0):
    """Total one-way link loss [dB]: free-space spreading over the group
    path (32.45 + 20·log₁₀ f[MHz] + 20·log₁₀ d[km]) + absorption + ground
    loss − focusing gain."""
    fspl = (32.45 + 20.0 * torch.log10(f0s_hz / 1e6)
            + 20.0 * torch.log10(path_km))
    return fspl + absorb_db + ground_db - focus_db


def _ground_loss_db(f0s_hz, elev_deg, ground, n_hops):
    """Total loss of the n_hops−1 intermediate specular bounces [dB];
    ``ground=None`` is the perfect reflector (0 dB, NaN where elev is)."""
    if ground is None or n_hops < 2:
        return 0.0 * elev_deg
    from .ground import ground_reflection_loss_db
    return (n_hops - 1) * ground_reflection_loss_db(f0s_hz, elev_deg,
                                                    ground)


def _homing(f0s, ground_range_km, alt, Ne, Babs, bpsi, nu, mode, geometry,
            n_elev, elev_min_deg, elev_max_deg, max_range_jump_km, n_hops,
            ground):
    """:func:`synthesize_oblique_ionogram` on tensors, for profiles
    ``Ne`` [..., N] (leading dimensions batch whole links: every output
    gains them in front)."""
    from .snell import _snell_fan

    if geometry not in ("cartesian", "spherical"):
        raise ValueError("geometry must be 'cartesian' or 'spherical'")
    n_hops = int(n_hops)
    lims, _ = as_tensors([float(elev_min_deg), float(elev_max_deg)], Ne,
                         dtype=Ne.dtype)
    elevs = _linspace(lims[0], lims[1], int(n_elev))
    fan = _snell_fan(f0s, elevs, alt, Ne, Babs, bpsi, nu,
                     mode_multiplier(mode),
                     re=None if geometry == "cartesian" else float(R_E))
    range_fe = fan["ground_range_km"]                     # [..., F, E]
    delay_fe = fan["group_delay_sec"]

    # per-hop target; physical floor: per-hop chord distance / c
    # (μ' ≥ 1 ⇒ no ray is faster)
    D = float(ground_range_km) / n_hops
    chord = (D if geometry == "cartesian"
             else 2.0 * R_E * math.sin(0.5 * D / R_E))
    lo, hi = _crossings(range_fe, (delay_fe, fan["absorption_db"],
                                   fan["group_path_km"],
                                   fan["phase_path_km"]),
                        elevs, D, float(max_range_jump_km), chord / C_KM_S)
    dl_lo, ab_lo, pa_lo, ph_lo, el_lo, sl_lo = lo
    dl_hi, ab_hi, pa_hi, ph_hi, el_hi, sl_hi = hi
    # n identical hops: total path and total dD/dβ both scale by n
    d_tot = float(ground_range_km)
    fg_lo = _focusing_gain_db(n_hops * pa_lo, n_hops * sl_lo, el_lo,
                              d_tot, geometry)
    fg_hi = _focusing_gain_db(n_hops * pa_hi, n_hops * sl_hi, el_hi,
                              d_tot, geometry)
    gl_lo = _ground_loss_db(f0s, el_lo, ground, n_hops)
    gl_hi = _ground_loss_db(f0s, el_hi, ground, n_hops)
    return {"delay_low_sec": n_hops * dl_lo,
            "delay_high_sec": n_hops * dl_hi,
            "elev_low_deg": el_lo, "elev_high_deg": el_hi,
            "absorption_low_db": n_hops * ab_lo,
            "absorption_high_db": n_hops * ab_hi,
            "group_path_low_km": n_hops * pa_lo,
            "group_path_high_km": n_hops * pa_hi,
            "phase_path_low_km": n_hops * ph_lo,
            "phase_path_high_km": n_hops * ph_hi,
            "focusing_gain_low_db": fg_lo,
            "focusing_gain_high_db": fg_hi,
            "ground_loss_low_db": gl_lo,
            "ground_loss_high_db": gl_hi,
            "link_loss_low_db": _link_loss_db(
                f0s, n_hops * pa_lo, n_hops * ab_lo, fg_lo, gl_lo),
            "link_loss_high_db": _link_loss_db(
                f0s, n_hops * pa_hi, n_hops * ab_hi, fg_hi, gl_hi),
            "fan_range_km": range_fe, "fan_delay_sec": delay_fe,
            "elevations_deg": elevs}


def synthesize_oblique_ionogram(f0s_hz, ground_range_km, alt_km, Ne, Babs,
                                bpsi, mode="O", geometry="cartesian",
                                n_elev=512, elev_min_deg=5.0,
                                elev_max_deg=85.0,
                                max_range_jump_km=200.0, n_hops=1,
                                nu=None, ground=None, device=None):
    """Oblique ionogram for a link of length ``ground_range_km``.

    Traces the full (frequency × elevation) Snell fan of the profile
    (``alt_km``, ``Ne``, ``Babs``, ``bpsi``) and returns, per frequency,
    the low- and high-ray group delays [s], launch elevations [deg] and
    path absorptions [dB] that land at the target range (NaN above the
    link MUF). Keys, as the JAX function: ``delay_low_sec``,
    ``delay_high_sec``, ``elev_low_deg``, ``elev_high_deg``,
    ``absorption_low_db``, ``absorption_high_db``,
    ``group_path_low_km``/``..._high_km``,
    ``phase_path_low_km``/``..._high_km``,
    ``focusing_gain_low_db``/``..._high_db`` (the ionospheric focusing term
    of the link budget, see :func:`_focusing_gain_db`),
    ``ground_loss_low_db``/``..._high_db``, ``link_loss_low/high_db`` (the
    one-way budget: free-space spreading over the group path + absorption
    + ground loss − focusing, isotropic antennas) and the raw fan
    (``fan_range_km``, ``fan_delay_sec``, ``elevations_deg``).

    ``geometry``: 'cartesian' (flat Earth) or 'spherical'.
    ``max_range_jump_km`` rejects crossings interpolated across
    layer-transition discontinuities of the fan. ``n_hops``: an n-hop ray
    through this horizontally uniform ionosphere is n identical single hops
    off a specular ground, so each hop homes at ``D/n`` and delay,
    absorption and paths scale by n. ``ground``: electrical ground of the
    n_hops−1 intermediate bounces — ``None`` (perfect reflector, 0 dB), a
    preset name from :data:`pyrayhf_tpu_torch.ground.GROUND_PRESETS` or an
    ``(eps_r, sigma)`` pair. ``nu``: collision-frequency override, see
    :func:`pyrayhf_tpu_torch.absorption.collision_frequency`. Host data
    goes to the CUDA card unless ``device`` says otherwise
    (``device="cpu"``); the density's dtype is the working dtype.
    """
    from .snell import _fan_inputs

    f0s, _, alt, Ne, Babs, bpsi, nu = _fan_inputs(
        f0s_hz, 0.0, alt_km, Ne, Babs, bpsi, nu, device)
    return _homing(f0s, ground_range_km, alt, Ne, Babs, bpsi, nu, mode,
                   geometry, n_elev, elev_min_deg, elev_max_deg,
                   max_range_jump_km, n_hops, ground)


def _resolve_fan_engine(engine, z_np, x_np, device_type="cpu"):
    """Resolve the 2-D fan engine against the tensors' device and grids.

    ``"auto"``: the CUDA fan kernel for CUDA tensors on uniform grids
    (no table-size gate), else the plain gradient-ODE fan (``"xla"``) —
    the JAX package's own routing. ``"pallas"`` forces the kernel wrapper
    (its plain version on CPU tensors); ``"xla"`` the gradient-ODE fan.
    """
    from .pallas_ray import fan_2d_pallas_available

    if engine == "auto":
        if (device_type == "cuda"
                and fan_2d_pallas_available(z_np, x_np, None)):
            return "pallas"
        return "xla"
    if engine == "pallas":
        if not fan_2d_pallas_available(z_np, x_np, None):
            raise ValueError(
                "engine='pallas' requires uniform z/x grids; use "
                "engine='xla' for this geometry")
        return "pallas"
    if engine != "xla":
        raise ValueError("engine must be 'auto', 'xla', or 'pallas'")
    return "xla"


def _linspace(start, stop, num):
    """``jnp.linspace(start, stop, num)`` for 0-d tensors, its arithmetic:
    start·(1 − i/div) + stop·(i/div), the end point exact."""
    if num == 1:
        return start.reshape(1)
    kw = dict(dtype=start.dtype, device=start.device)
    step = torch.arange(num - 1, **kw) / torch.tensor(num - 1, **kw)
    return torch.cat([start * (1 - step) + stop * step, stop.reshape(1)])


def _fan_fields(f0s, Ne2d, Babs2d, bpsi2d, nu_z, mode):
    """μ, μ' and κ [F, N_z, N_x] of every frequency, one broadcast
    Appleton–Hartree evaluation; non-finite κ (evanescent nodes) is 0."""
    from .absorption import absorption_coefficient
    from .magnetoionic import find_mu_mup, find_X, find_Y

    with span("pyrayhf.fan_fields"):
        f = f0s[:, None, None]
        X = find_X(Ne2d[None, :, :], f)
        Y = find_Y(f, Babs2d[None, :, :])
        mu_f, mup_f = find_mu_mup(X, Y, bpsi2d[None, :, :], mode)
        kappa_f = absorption_coefficient(
            Ne2d[None, :, :], nu_z[None, :, None], f, Babs2d[None, :, :],
            bpsi2d[None, :, :], mu_f, mode)
        kappa_f = torch.where(torch.isfinite(kappa_f), kappa_f, 0.0)
        return mu_f, mup_f, kappa_f


def _fan_2d_fn(z_np, x_np, mode, geometry, n_elev, n_steps, n_hops,
               engine="auto"):
    """The [F, E] fan for fixed grids, as a function.

    Returns ``fan(f0s, elev_lims, Ne2d, Babs2d, bpsi2d, nu_z, step_km,
    device=None)`` → (range, delay, absorption, group path, phase path)
    each [F, E], and the elevations [E]. The fields are
    :func:`_fan_fields`; the kernel engine takes its tables straight from
    the slice (:func:`pyrayhf_tpu_torch.pallas_ray.fan_from_slice`; under
    ``torch.func`` it builds the fields, folds ``vmap`` and refuses
    derivatives). Their dtype and device
    are those of ``Ne2d`` (host data: the CUDA card unless ``device``
    says otherwise); ``engine="auto"`` resolves on that device at call
    time, an invalid engine raises here.
    """
    z64, x64 = host_f64(z_np), host_f64(x_np)
    if geometry not in ("cartesian", "spherical"):
        raise ValueError("geometry must be 'cartesian' or 'spherical'")
    if engine != "auto":
        _resolve_fan_engine(engine, z64, x64)

    def fan(f0s, elev_lims, Ne2d, Babs2d, bpsi2d, nu_z, step_km,
            device=None):
        (Ne2d,) = as_tensors(Ne2d, device=device)
        f0s, elev_lims, Babs2d, bpsi2d, nu_z, step_km, _ = as_tensors(
            f0s, elev_lims, Babs2d, bpsi2d, nu_z, step_km, Ne2d,
            dtype=Ne2d.dtype)
        f0s = f0s.reshape(-1)
        eng = _resolve_fan_engine(engine, z64, x64, Ne2d.device.type)
        elevs = _linspace(elev_lims[0], elev_lims[1], int(n_elev))
        if eng == "pallas":
            from .pallas_ray import fan_from_slice
            out = fan_from_slice(z64, x64, f0s, Ne2d, Babs2d, bpsi2d, nu_z,
                                 mode, elevs, step_km, geometry=geometry,
                                 n_steps=n_steps, n_hops=n_hops, x0=0.0,
                                 z0=float(z64[0]))
        else:
            out = _xla_fan(z64, x64, geometry, *_fan_fields(
                f0s, Ne2d, Babs2d, bpsi2d, nu_z, mode), elevs, step_km,
                n_steps, n_hops)
        return (out["ground_range_km"], out["group_delay_sec"],
                out["absorption_db"], out["group_path_km"],
                out["phase_path_km"], elevs)

    return fan


def _xla_fan(z64, x64, geometry, mu_f, mup_f, kappa_f, elevs, step_km,
             n_steps, n_hops):
    """The gradient-ODE fan over [F, nz, nx] fields (engine ``"xla"``):
    interpolators built on the grids, the fixed-step cores of
    :mod:`.gradient` batched over (frequency, elevation)."""
    from .fields import (build_mup_function,
                         build_refractive_index_interpolator_cartesian,
                         build_refractive_index_interpolator_spherical)
    from .gradient import _cart_gradient_core, _sph_gradient_core

    el = elevs.expand(mu_f.shape[0], elevs.shape[0])
    z0, z1, x0, x1 = (float(z64[0]), float(z64[-1]), float(x64[0]),
                      float(x64[-1]))
    if geometry == "cartesian":
        nag = build_refractive_index_interpolator_cartesian(z64, x64, mu_f)
        mupf = build_mup_function(mup_f, x64, z64, geometry="cartesian")
        kapf = build_mup_function(kappa_f, x64, z64, geometry="cartesian")
        return _cart_gradient_core(nag, mupf, 0.0, z0, el, step_km, n_steps,
                                   z0, z1, x0, x1, n_hops=n_hops,
                                   kappa_func=kapf)
    re = float(R_E)
    nag = build_refractive_index_interpolator_spherical(z64, x64, mu_f)
    mupf = build_mup_function(mup_f, x64, z64, geometry="spherical")
    kapf = build_mup_function(kappa_f, x64, z64, geometry="spherical")
    return _sph_gradient_core(nag, mupf, 0.0, z0, el, step_km, n_steps, re,
                              z0, re + z1, x0 / re, x1 / re, n_hops=n_hops,
                              kappa_func=kapf)


def synthesize_oblique_ionogram_2d(f0s_hz, ground_range_km, x_grid_km,
                                   z_grid_km, Ne2d, Babs2d, bpsi2d,
                                   mode="O", geometry="cartesian",
                                   n_elev=128,
                                   elev_min_deg=5.0, elev_max_deg=85.0,
                                   step_km=2.0, s_max_km=4000.0,
                                   max_range_jump_km=200.0, n_hops=1,
                                   nu=None, ground=None, engine="auto",
                                   device=None):
    """Oblique ionogram through a RANGE-DEPENDENT (2-D) ionosphere.

    Traces the gradient-ODE fan of ``n_elev`` elevations per frequency
    through the ``Ne2d``/``Babs2d``/``bpsi2d`` [N_z, N_x] slice on
    (``z_grid_km``, ``x_grid_km``) and homes the low and high rays onto
    ``ground_range_km``. ``geometry``: 'cartesian' (flat Earth) or
    'spherical' (ranges are arc lengths). ``n_hops``: the fan traces
    through ``n_hops − 1`` specular ground reflections and the crossings
    home the full n-hop range. ``nu``: ν(z) [s⁻¹] on ``z_grid_km``
    (default :func:`pyrayhf_tpu_torch.absorption.collision_frequency`).
    ``ground``: Fresnel model of the intermediate bounces (grazing angle ≈
    launch elevation). ``engine``: ``'auto'`` (the CUDA fan kernel for
    CUDA tensors on uniform grids, else the plain gradient-ODE fan),
    ``'xla'`` or ``'pallas'``. Returns the keys of the JAX function.

    The grids are host data. A grid that starts above the ground is
    extended down to 0 km with free space, by a ladder at the same spacing
    when that spacing divides z[0] (the grid stays uniform), else by one
    ground node. The fields keep their device; host data goes to the CUDA
    card unless ``device`` says otherwise (``device="cpu"``).
    """
    with span("pyrayhf.oblique"):
        from .absorption import collision_frequency

        if geometry not in ("cartesian", "spherical"):
            raise ValueError("geometry must be 'cartesian' or 'spherical'")
        z = host_f64(z_grid_km)
        x = host_f64(x_grid_km)
        (Ne2d,) = as_tensors(Ne2d, device=device)
        Babs2d, bpsi2d, _ = as_tensors(Babs2d, bpsi2d, Ne2d,
                                       dtype=Ne2d.dtype)
        nu_z = (collision_frequency(z, device="cpu").numpy() if nu is None
                else host_f64(nu))
        if z[0] > 0.0:
            # free-space extension to the ground (the reference's layered
            # tracer inserts a ground level the same way, ref
            # library.py:1174-1182); a ladder at the grid's own spacing
            # keeps a uniform grid uniform
            dz = np.diff(z)
            k = z[0] / dz[0]
            if (np.allclose(dz, dz[0], rtol=1e-6, atol=0.0)
                    and abs(k - round(k)) < 1e-9 * max(k, 1.0)):
                ladder = z[0] - dz[0] * np.arange(int(round(k)), 0, -1)
                ladder[0] = 0.0                      # exact ground node
            else:
                ladder = np.array([0.0])
            n_ext = ladder.size
            z = np.concatenate([ladder, z])
            Ne2d = torch.cat([Ne2d.new_zeros((n_ext, Ne2d.shape[1])),
                              Ne2d])
            Babs2d = torch.cat([Babs2d[:1].expand(n_ext, -1), Babs2d])
            bpsi2d = torch.cat([bpsi2d[:1].expand(n_ext, -1), bpsi2d])
            # ν keeps its value at z[0] below (κ is 0 there: Ne = 0)
            nu_z = np.concatenate([np.repeat(nu_z[:1], n_ext), nu_z])

        f0s, nu_t, lims, step, _ = as_tensors(
            np.atleast_1d(host_f64(f0s_hz)), nu_z,
            [float(elev_min_deg), float(elev_max_deg)], float(step_km),
            Ne2d, dtype=Ne2d.dtype)
        n_hops = int(n_hops)
        n_steps = int(round(float(s_max_km) / float(step_km)))
        fan = _fan_2d_fn(z, x, mode, geometry, int(n_elev), n_steps,
                         n_hops, engine=engine)
        range_fe, delay_fe, absorb_fe, path_fe, phase_fe, elevs = fan(
            f0s, lims, Ne2d, Babs2d, bpsi2d, nu_t, step)

        return _home_2d(f0s, range_fe, delay_fe, absorb_fe, path_fe,
                        phase_fe, elevs, float(ground_range_km), n_hops,
                        geometry, float(max_range_jump_km), ground)


def _home_2d(f0s, range_fe, delay_fe, absorb_fe, path_fe, phase_fe, elevs,
             D, n_hops, geometry, max_jump, ground):
    """The low and high rays of a 2-D fan that land at ``D`` km, and their
    link budget: the returned dict of
    :func:`synthesize_oblique_ionogram_2d`."""
    with span("pyrayhf.homing"):
        chord_1 = (D / n_hops if geometry == "cartesian"
                   else 2.0 * R_E * math.sin(0.5 * D / n_hops / R_E))
        lo, hi = _crossings(range_fe, (delay_fe, absorb_fe, path_fe,
                                       phase_fe),
                            elevs, D, max_jump, n_hops * chord_1 / C_KM_S)
        dl_lo, ab_lo, pa_lo, ph_lo, el_lo, sl_lo = lo
        dl_hi, ab_hi, pa_hi, ph_hi, el_hi, sl_hi = hi
        # fan ranges and paths are n-hop totals (traced through the
        # bounces); the launch elevation stands in for the arrival elevation
        fg_lo = _focusing_gain_db(pa_lo, sl_lo, el_lo, D, geometry)
        fg_hi = _focusing_gain_db(pa_hi, sl_hi, el_hi, D, geometry)
        gl_lo = _ground_loss_db(f0s, el_lo, ground, n_hops)
        gl_hi = _ground_loss_db(f0s, el_hi, ground, n_hops)
        return {"delay_low_sec": dl_lo, "delay_high_sec": dl_hi,
                "elev_low_deg": el_lo, "elev_high_deg": el_hi,
                "absorption_low_db": ab_lo, "absorption_high_db": ab_hi,
                "group_path_low_km": pa_lo, "group_path_high_km": pa_hi,
                "phase_path_low_km": ph_lo, "phase_path_high_km": ph_hi,
                "focusing_gain_low_db": fg_lo,
                "focusing_gain_high_db": fg_hi,
                "ground_loss_low_db": gl_lo, "ground_loss_high_db": gl_hi,
                "link_loss_low_db": _link_loss_db(f0s, pa_lo, ab_lo, fg_lo,
                                                  gl_lo),
                "link_loss_high_db": _link_loss_db(f0s, pa_hi, ab_hi, fg_hi,
                                                   gl_hi),
                "fan_range_km": range_fe, "fan_delay_sec": delay_fe,
                "elevations_deg": elevs}
