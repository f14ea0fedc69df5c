"""Ray-equation building blocks exposed as public API.

Port of ``pyrayhf_tpu.rays``: the reference's ODE right-hand sides,
terminal-event functions and Snell helpers as module-level functions (ref
``library.py:953-1093, 2020-2125``), on top of the field objects of
:mod:`.fields`. The tracers in :mod:`.gradient` and :mod:`.snell` inline the
same equations; these standalone forms are for users composing their own
integrators. States index their first axis (``y[0]`` is x or r), as in the
JAX module.
"""

import torch

from ._util import as_tensors

__all__ = ["ray_rhs_cartesian", "rhs_spherical", "event_ground",
           "event_z_top", "event_z_bottom", "event_x_left", "event_x_right",
           "tan_from_mu_scalar", "find_turning_point"]


def ray_rhs_cartesian(s, y, n_and_grad):
    """d/ds [x, z, vx, vz] for the 2-D Cartesian ray ODE (ref :953-1006).

    dr/ds = v, dv/ds = (∇μ − (∇μ·v)v)/μ; zero derivative where μ is invalid
    (halts the ray, matching the reference's NaN policy).
    """
    x, z, vx, vz = y[0], y[1], y[2], y[3]
    n, dndx, dndz = n_and_grad(x, z)
    ok = torch.isfinite(n) & (n > 0.0)
    n_s = torch.where(ok, n, 1.0)
    gdv = dndx * vx + dndz * vz
    d = torch.stack([vx, vz, (dndx - gdv * vx) / n_s,
                     (dndz - gdv * vz) / n_s])
    return torch.where(ok, d, torch.zeros_like(d))


def rhs_spherical(s, y, n_and_grad_rphi):
    """d/ds [r, φ, v_r, v_φ] for the spherical ray ODE (ref :2020-2125)."""
    r, phi, v_r, v_phi = y[0], y[1], y[2], y[3]
    mu, mu_r, mu_phi = n_and_grad_rphi(phi, r)
    ok = torch.isfinite(mu) & (mu > 0.0)
    mu_s = torch.where(ok, mu, 1.0)
    gdv = mu_r * v_r + (mu_phi / r) * v_phi
    d = torch.stack([v_r, v_phi / r,
                     (mu_r - gdv * v_r) / mu_s + v_phi * v_phi / r,
                     ((mu_phi / r) - gdv * v_phi) / mu_s - v_r * v_phi / r])
    return torch.where(ok, d, torch.zeros_like(d))


def event_ground(s, y, z_ground_km=0.0):
    """Signed distance above ground (terminal when ≤ 0; ref :1009-1011)."""
    return y[1] - z_ground_km - 1e-3


def event_z_top(s, y, z_max_km):
    """Distance below the domain top (ref :1014-1016)."""
    return z_max_km - y[1]


def event_z_bottom(s, y, z_min_km):
    """Distance above the domain bottom (ref :1019-1021)."""
    return y[1] - z_min_km


def event_x_left(s, y, x_min_km):
    """Distance right of the left boundary (ref :1024-1026)."""
    return y[0] - x_min_km


def event_x_right(s, y, x_max_km):
    """Distance left of the right boundary (ref :1029-1031)."""
    return x_max_km - y[0]


def tan_from_mu_scalar(mu_val, p, eps=1e-10, device=None):
    """tanθ = p / sqrt(μ² − p²) with singularity floor (ref :1034-1062)."""
    mu_val, p = as_tensors(mu_val, p, device=device)
    arg = torch.clamp(mu_val * mu_val - p * p, min=eps)
    return p / torch.sqrt(arg)


def find_turning_point(z, mu, p, device=None):
    """Altitude where μ first crosses the Snell invariant p (ref :1065-1093).

    Vectorised first-crossing search + linear interpolation; NaN when no
    crossing exists.
    """
    z, mu, p = as_tensors(z, mu, p, device=device)
    crossing = (mu[:-1] >= p) & (mu[1:] <= p)
    found = crossing.any()
    # first True (0 when there is none), as argmax of a bool mask in JAX
    i = torch.argmax(crossing.to(torch.uint8))
    mu0, mu1 = mu[i], mu[i + 1]
    t = torch.where(mu0 != mu1,
                    (mu0 - p) / torch.where(mu0 != mu1, mu0 - mu1, 1.0), 0.0)
    z_turn = z[i] + torch.clamp(t, 0.0, 1.0) * (z[i + 1] - z[i])
    return torch.where(found, z_turn, float("nan"))
