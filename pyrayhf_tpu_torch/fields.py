"""2-D refractive-index fields: bilinear interpolation and interpolators.

Port of ``pyrayhf_tpu.fields`` (reference ``RegularGridInterpolator``
machinery, ``build_refractive_index_interpolator_{cartesian,spherical}``,
``build_mup_function``, ``n_and_grad*``; ref ``library.py:828-950,
1716-2017``). Fields are tensors; evaluation is a cell locate plus a
4-corner gather. Gradient fields are the second-order ``np.gradient``
(``edge_order=2``) of the field on its grid, evaluated through the same
bilinear interpolant.

Beyond the JAX module, a field may carry leading batch dimensions
([..., nz, nx], e.g. one slice per frequency); queries then have shape
[..., M...] with the same leading dimensions (the JAX package vmaps).

Out-of-domain queries return ``fill_value`` (NaN for n, 0.0 for gradients
by default), like the reference's ``bounds_error=False`` fills.
"""

import numpy as np
import torch

from ._util import as_tensors, host_f64
from .constants import R_E

__all__ = ["bilinear", "gradient_ord2", "grad_axis_ord2", "uniform_axis",
           "RefractiveField",
           "n_and_grad", "eval_refractive_index_and_grad", "make_n_and_grad",
           "n_and_grad_rphi",
           "build_refractive_index_interpolator_cartesian",
           "build_refractive_index_interpolator_spherical",
           "build_mup_function"]

_NAN = float("nan")


def uniform_axis(c_np):
    """True if the 1-D host axis ``c_np`` is uniformly spaced.

    Picks the direct ``floor((q - o) / d)`` cell locate over a binary
    search. The tolerance has two terms: 1e-6 of the mean spacing, plus 4
    ulp of f32 at the axis' largest magnitude, so that a linspace axis
    quantized to f32 upstream is still uniform (a one-ulp cell-edge wobble
    moves a query's bin by at most one cell, and the weight extrapolates
    continuously from the neighbour). Node deviation from the affine fit
    is tested, not spacing jitter, which cancels.
    """
    c = np.asarray(c_np, dtype=np.float64)
    if c.ndim != 1 or c.size < 2:
        return False
    dbar = (c[-1] - c[0]) / (c.size - 1)
    dev = np.abs(c - (c[0] + dbar * np.arange(c.size)))
    tol = max(1e-6 * abs(dbar),
              4.0 * float(np.finfo(np.float32).eps) * float(
                  np.max(np.abs(c))))
    return bool(np.all(dev <= tol))


def _along(v, axis, ndim):
    """1-D ``v`` shaped to broadcast along ``axis`` of an ``ndim`` tensor."""
    shape = [1] * ndim
    shape[axis] = -1
    return v.reshape(shape)


def grad_axis_ord2(f, c, axis):
    """np.gradient(f, c, axis=axis, edge_order=2) for any-rank ``f``.

    Non-uniform 2nd-order central differences in the interior, one-sided
    2nd order at the edges (ref ``library.py:1805-1812``), expression for
    expression as the JAX module.
    """
    axis = axis % f.dim()
    n = f.shape[axis]
    h = torch.diff(c)
    hs = _along(h[:-1], axis, f.dim())
    hd = _along(h[1:], axis, f.dim())

    def sl(a, b):
        return f.narrow(axis, a, b - a)

    num = (hs * hs * sl(2, n) - (hs * hs - hd * hd) * sl(1, n - 1)
           - hd * hd * sl(0, n - 2))
    interior = num / (hs * hd * (hs + hd))
    # the edge stencils' third node, clamped into range as JAX's indexing
    # clamps it: on a 2-node axis (a range-independent slice) both edges
    # read f0, f1 and h0 only, 1.5·(f1 − f0)/h0, and the interior is empty
    i2, i3 = min(2, n - 1), max(n - 3, 0)
    h0, h1 = h[0], h[min(1, n - 2)]
    a0 = -(2 * h0 + h1) / (h0 * (h0 + h1))
    b0 = (h0 + h1) / (h0 * h1)
    c0 = -h0 / (h1 * (h0 + h1))
    first = a0 * sl(0, 1) + b0 * sl(1, 2) + c0 * sl(i2, i2 + 1)
    hm1, hm2 = h[-1], h[i3]
    am = (2 * hm1 + hm2) / (hm1 * (hm1 + hm2))
    bm = -(hm1 + hm2) / (hm1 * hm2)
    cm = hm1 / (hm2 * (hm1 + hm2))
    last = am * sl(n - 1, n) + bm * sl(n - 2, n - 1) + cm * sl(i3, i3 + 1)
    return torch.cat([first, interior, last], dim=axis)


def gradient_ord2(f, z, x):
    """np.gradient(f, z, x, edge_order=2) on the last two axes.

    ``f``: [..., nz, nx]; ``z``/``x``: 1-D coords (non-uniform allowed).
    Returns (df/dz, df/dx).
    """
    z, x = as_tensors(z, x, f, dtype=f.dtype)[:2]
    return grad_axis_ord2(f, z, -2), grad_axis_ord2(f, x, -1)


def _sum4(w, c):
    """Σ w_k·c_k in the fixed order of ``RefractiveField._corners``."""
    return ((w[0] * c[0] + w[1] * c[1]) + w[2] * c[2]) + w[3] * c[3]


def bilinear(zq, xq, z_grid, x_grid, field, fill_value=_NAN):
    """Bilinear interpolation of ``field[nz, nx]`` at points (zq, xq).

    Out-of-bounds → ``fill_value``. Shapes of zq/xq broadcast; output matches.
    """
    field, z_grid, x_grid = as_tensors(field, z_grid, x_grid)
    zq, xq = torch.broadcast_tensors(*as_tensors(zq, xq, field,
                                                 dtype=field.dtype)[:2])
    nz, nx = field.shape
    iz = torch.clamp(torch.searchsorted(z_grid, zq.contiguous(), right=True)
                     - 1, 0, nz - 2)
    ix = torch.clamp(torch.searchsorted(x_grid, xq.contiguous(), right=True)
                     - 1, 0, nx - 2)
    z0, z1 = z_grid[iz], z_grid[iz + 1]
    x0, x1 = x_grid[ix], x_grid[ix + 1]
    tz = (zq - z0) / (z1 - z0)
    tx = (xq - x0) / (x1 - x0)
    val = ((1 - tz) * (1 - tx) * field[iz, ix]
           + (1 - tz) * tx * field[iz, ix + 1]
           + tz * (1 - tx) * field[iz + 1, ix]
           + tz * tx * field[iz + 1, ix + 1])
    inb = ((zq >= z_grid[0]) & (zq <= z_grid[-1])
           & (xq >= x_grid[0]) & (xq <= x_grid[-1]))
    return torch.where(inb, val, fill_value)


class RefractiveField:
    """Precomputed μ (or μ') field with gradients on a regular 2-D grid.

    ``geometry='cartesian'``: coords are (z [km], x [km]) and gradients are
    (∂/∂z, ∂/∂x). ``geometry='spherical'``: the (z, x) grid is mapped to
    (r = R_E + z, φ = x/R_E) and gradients are (∂/∂r, ∂/∂φ), matching the
    reference's spherical interpolator (ref :1838-1927).

    ``field`` is [..., nz, nx]; the grids are host data (numpy, or tensors
    read once), checked and classified (uniform or not) on the host. Host
    field data goes to the CUDA card unless ``device`` says otherwise.
    ``grads`` (port only): the two gradient fields, when the caller has
    them already; otherwise they are computed at first use.
    """

    def __init__(self, z_grid, x_grid, field, *, geometry="cartesian",
                 R_E_km=None, fill_value_n=_NAN, fill_value_grad=0.0,
                 grads=None, device=None):
        z64 = host_f64(z_grid)
        x64 = host_f64(x_grid)
        (field,) = as_tensors(field, device=device)
        if tuple(field.shape[-2:]) != (z64.size, x64.size):
            raise ValueError(
                f"field must have shape (len(z_grid)={z64.size}, "
                f"len(x_grid)={x64.size}), got {tuple(field.shape)}.")
        if not (np.all(np.diff(z64) > 0) and np.all(np.diff(x64) > 0)):
            raise ValueError("grids must be strictly increasing")
        if geometry not in ("cartesian", "spherical"):
            raise ValueError("geometry must be 'cartesian' or 'spherical'")
        self.geometry = geometry
        re = R_E if R_E_km is None else R_E_km
        self.R_E_km = re
        if geometry == "spherical":
            c0_np = re + z64                                     # r
            c1_np = x64 / re                                     # phi
        else:
            c0_np = z64
            c1_np = x64
        kw = dict(dtype=field.dtype, device=field.device)
        self.c0 = torch.as_tensor(c0_np).to(**kw)
        self.c1 = torch.as_tensor(c1_np).to(**kw)
        self.field = field
        self._grads = grads
        self._stacked = None
        self.fill_value_n = fill_value_n
        self.fill_value_grad = fill_value_grad
        self._uniform = bool(uniform_axis(c0_np) and uniform_axis(c1_np))
        self._o0 = float(c0_np[0])
        self._o1 = float(c1_np[0])
        self._inv_d0 = float((len(c0_np) - 1) / (c0_np[-1] - c0_np[0]))
        self._inv_d1 = float((len(c1_np) - 1) / (c1_np[-1] - c1_np[0]))

    @property
    def grad0(self):
        """d/dz or d/dr."""
        return self._gradients()[0]

    @property
    def grad1(self):
        """d/dx or d/dphi."""
        return self._gradients()[1]

    def _gradients(self):
        if self._grads is None:
            self._grads = gradient_ord2(self.field, self.c0, self.c1)
        return self._grads

    def _stack(self):
        """(field, grad0, grad1) stacked [..., 3, nz, nx], built once, so
        that one gather per corner fetches all three."""
        if self._stacked is None:
            self._stacked = torch.stack([self.field, *self._gradients()],
                                        dim=-3)
        return self._stacked

    def _locate(self, c0q, c1q):
        """Shared cell locate: (iz, ix, tz, tx, inb) for query points."""
        nz, nx = self.field.shape[-2:]
        if self._uniform:
            f0 = (c0q - self._o0) * self._inv_d0
            f1 = (c1q - self._o1) * self._inv_d1
            # NaN queries: park in cell 0 (masked by inb afterwards)
            f0 = torch.where(torch.isnan(f0), 0.0, f0)
            f1 = torch.where(torch.isnan(f1), 0.0, f1)
            # the cell index stays a float (exact) until the flat index
            iz = torch.clamp(torch.floor(f0), 0, nz - 2)
            ix = torch.clamp(torch.floor(f1), 0, nx - 2)
            tz = f0 - iz
            tx = f1 - ix
        else:
            iz = torch.clamp(torch.searchsorted(self.c0, c0q.contiguous(),
                                                right=True) - 1, 0, nz - 2)
            ix = torch.clamp(torch.searchsorted(self.c1, c1q.contiguous(),
                                                right=True) - 1, 0, nx - 2)
            tz = (c0q - self.c0[iz]) / (self.c0[iz + 1] - self.c0[iz])
            tx = (c1q - self.c1[ix]) / (self.c1[ix + 1] - self.c1[ix])
        inb = ((c0q >= self.c0[0]) & (c0q <= self.c0[-1])
               & (c1q >= self.c1[0]) & (c1q <= self.c1[-1]))
        return iz, ix, tz, tx, inb

    def _queries(self, c0q, c1q):
        c0q, c1q = as_tensors(c0q, c1q, self.field, dtype=self.field.dtype)[:2]
        return torch.broadcast_tensors(c0q, c1q)

    def _corners(self, c0q, c1q):
        """Locate + the 4-corner flat indices and weights (this order)."""
        iz, ix, tz, tx, inb = self._locate(c0q, c1q)
        nx = self.field.shape[-1]
        idx = (iz * nx + ix).to(torch.int64)
        idxs = (idx, idx + 1, idx + nx, idx + nx + 1)
        w = ((1 - tz) * (1 - tx), (1 - tz) * tx, tz * (1 - tx), tz * tx)
        return idxs, w, inb

    def _interp(self, tab, c0q, c1q):
        """Bilinear values of the C channels of ``tab`` [..., C, nz, nx]:
        (list of C tensors shaped like the queries, in-domain mask)."""
        c0q, c1q = self._queries(c0q, c1q)
        idxs, w, inb = self._corners(c0q, c1q)
        lead, C = tab.shape[:-3], tab.shape[-3]
        shape = idxs[0].shape
        if tuple(shape[:len(lead)]) != tuple(lead):
            raise ValueError(f"queries {tuple(shape)} must lead with the "
                             f"field's batch shape {tuple(lead)}")
        flat = tab.reshape(*lead, C, -1)
        out = shape[:len(lead)] + (C,) + shape[len(lead):]
        # one gather per corner, all channels at once
        corners = [torch.gather(flat, -1, i.reshape(*lead, 1, -1)
                                .expand(*lead, C, -1)).reshape(out)
                   for i in idxs]
        w = [wk.unsqueeze(len(lead)) for wk in w]
        return _sum4(w, corners).unbind(len(lead)), inb

    def value(self, c0q, c1q):
        (val,), inb = self._interp(self.field.unsqueeze(-3), c0q, c1q)
        return torch.where(inb, val, self.fill_value_n)

    def value_and_grad(self, c0q, c1q):
        """(n, dn/dc0, dn/dc1) at native coordinates (z,x) or (r,φ)."""
        (n, d0, d1), inb = self._interp(self._stack(), c0q, c1q)
        return (torch.where(inb, n, self.fill_value_n),
                torch.where(inb, d0, self.fill_value_grad),
                torch.where(inb, d1, self.fill_value_grad))


def build_refractive_index_interpolator_cartesian(
        z_grid, x_grid, n_field, *, fill_value_n=_NAN,
        fill_value_grad=0.0, bounds_error=False, edge_order=2, device=None):
    """Return callable (x, z) → (n, ∂n/∂x, ∂n/∂z). (ref :1764-1835)

    ``bounds_error``/``edge_order`` accepted for API parity; out-of-domain
    queries always use fill values and gradients are always 2nd order.
    """
    del bounds_error, edge_order
    fld = RefractiveField(z_grid, x_grid, n_field, geometry="cartesian",
                          fill_value_n=fill_value_n,
                          fill_value_grad=fill_value_grad, device=device)

    def n_and_grad(x, z):
        n, dndz, dndx = fld.value_and_grad(z, x)
        return n, dndx, dndz

    n_and_grad.field = fld
    return n_and_grad


def build_refractive_index_interpolator_spherical(
        z_grid, x_grid, n_field, *, fill_value_n=_NAN,
        fill_value_grad=0.0, bounds_error=False, R_E=None, edge_order=2,
        device=None):
    """Return callable (φ, r) → (μ, ∂μ/∂r, ∂μ/∂φ). (ref :1838-1927)"""
    del bounds_error, edge_order
    fld = RefractiveField(z_grid, x_grid, n_field, geometry="spherical",
                          R_E_km=R_E, fill_value_n=fill_value_n,
                          fill_value_grad=fill_value_grad, device=device)

    def n_and_grad_rphi(phi, r):
        return fld.value_and_grad(r, phi)

    n_and_grad_rphi.field = fld
    return n_and_grad_rphi


def build_mup_function(mup_field, x_grid, z_grid, *, geometry="cartesian",
                       R_E=None, bounds_error=False, fill_value=_NAN,
                       device=None):
    """Return callable (x, z) → μ'(x, z) for group-delay integration.

    (ref :1930-2017) For spherical geometry (x, z) are converted to (φ, r)
    internally, like the reference.
    """
    del bounds_error
    fld = RefractiveField(z_grid, x_grid, mup_field, geometry=geometry,
                          R_E_km=R_E, fill_value_n=fill_value, device=device)
    return _mup_function(fld)


def _mup_function(fld):
    """(x, z) → fld.value at native coordinates, for a built field."""
    re = fld.R_E_km
    if fld.geometry == "cartesian":
        def mup_func(x, z):
            return fld.value(z, x)
    else:
        def mup_func(x, z):
            x, z = as_tensors(x, z, fld.field, dtype=fld.field.dtype)[:2]
            return fld.value(re + z, x / re)
    mup_func.field = fld
    return mup_func


def _eval(itp, a, b):
    if isinstance(itp, RefractiveField):
        return itp.value(a, b)
    return itp(a, b)


def eval_refractive_index_and_grad(x, z, n_interp, dn_dx_interp,
                                   dn_dz_interp):
    """(x, z) → (n, ∂n/∂x, ∂n/∂z) from three interpolants (ref :883-936).

    Each interpolant may be a :class:`RefractiveField` (its value is used) or
    any callable ``f(z, x)``; inputs broadcast like the reference.
    """
    x, z = torch.broadcast_tensors(*as_tensors(x, z))
    return (_eval(n_interp, z, x), _eval(dn_dx_interp, z, x),
            _eval(dn_dz_interp, z, x))


def n_and_grad(x, z, n_interp, dn_dx_interp, dn_dz_interp):
    """Alias of :func:`eval_refractive_index_and_grad` (ref :828-880)."""
    return eval_refractive_index_and_grad(x, z, n_interp, dn_dx_interp,
                                          dn_dz_interp)


def make_n_and_grad(n_interp, dn_dx_interp, dn_dz_interp):
    """Bind interpolants into an (x, z) → (n, dndx, dndz) callable
    (ref :939-950)."""
    def fn(x, z):
        return eval_refractive_index_and_grad(x, z, n_interp, dn_dx_interp,
                                              dn_dz_interp)
    return fn


def n_and_grad_rphi(phi, r, n_interp, dn_dr_interp, dn_dphi_interp):
    """(φ, r) → (μ, ∂μ/∂r, ∂μ/∂φ) from three interpolants (ref :1716-1761).

    Interpolants are called with native spherical coordinates (r, φ)."""
    phi, r = torch.broadcast_tensors(*as_tensors(phi, r))
    return (_eval(n_interp, r, phi), _eval(dn_dr_interp, r, phi),
            _eval(dn_dphi_interp, r, phi))
