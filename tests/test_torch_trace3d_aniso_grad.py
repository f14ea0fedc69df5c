"""PyTorch port vs the JAX package: the anisotropic tracer's field-table
gradient.

The gradient of a ray's group delay w.r.t. the Ne table, through the
smoothed interpolant (``torch.autograd.grad`` of the port against
``jax.grad`` of ``pyrayhf_tpu.trace3d_aniso``, CPU, float64), on the grid
and layer of ``tests/test_torch_trace3d_aniso.py`` (one 8-MHz O ray at
25°, 16-km steps over 1,200 km): rtol 1e-6, with an absolute floor of
1e-12 of its largest entry (cells the ray touches only at rounding
level). Most of this file's time is the JAX package's compile of the
reverse-mode trace.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import pyrayhf_tpu.trace3d_aniso as J
import pyrayhf_tpu_torch.trace3d_aniso as T

from _torch_threads import one_torch_thread  # noqa: F401

F0 = 8e6


def test_field_table_gradient():
    """Equal to ``jax.grad``'s; finite and nonzero."""
    alt = np.linspace(60.0, 600.0, 55)
    lat = np.linspace(20.0, 60.0, 11)
    lon = np.linspace(-20.0, 20.0, 11)
    ne1 = 1.0e12 * np.maximum(0.0, 1.0 - ((alt - 300.0) / 120.0) ** 2)
    Ne = np.broadcast_to(ne1[:, None, None],
                         (alt.size, lat.size, lon.size)).copy()
    bj = [np.asarray(b) for b in J.igrf_volume(alt, lat, lon)]
    kw = dict(step_km=16.0, s_max_km=1200.0)

    def delay_of(ne):
        fld = J.build_field_3d_aniso(alt, lat, lon, ne, *bj)
        return J.trace_ray_3d_anisotropic(fld, 30.0, 0.0, 25.0, 0.0, F0,
                                          **kw)["group_delay_sec"]

    gj = np.asarray(jax.grad(delay_of)(jnp.asarray(Ne)))
    ne = torch.tensor(Ne, requires_grad=True)
    fld = T.build_field_3d_aniso(alt, lat, lon, ne, *bj)
    r = T.trace_ray_3d_anisotropic(fld, 30.0, 0.0, 25.0, 0.0, F0, **kw)
    np.testing.assert_allclose(float(r["group_delay_sec"]),
                               float(delay_of(jnp.asarray(Ne))), rtol=1e-9)
    gt, = torch.autograd.grad(r["group_delay_sec"], ne)
    assert torch.isfinite(gt).all() and (gt != 0).any()
    np.testing.assert_allclose(gt.numpy(), gj, rtol=1e-6,
                               atol=1e-12 * np.abs(gj).max())
