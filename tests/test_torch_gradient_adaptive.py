"""PyTorch port vs the JAX package: the single-ray gradient tracers with
the adaptive Dormand–Prince 5(4) integrator, and their early exit.

Inputs: the ``gauss_*`` fields of ``tests/goldens/reference_goldens.npz``
(a Gaussian layer on a 200 × 200 grid, O and X) and the scipy-RK45 oracle
rays ``grad_cart_O``, ``grad_sph_O`` and ``grad_cart_X``, held at the
1.5% of ``tests/test_tracers.py:257-350``. Fixed-step rays, the config
and the ray building blocks are ``tests/test_torch_gradient_single_ray.py``.

Against the JAX package (CPU, float64): the adaptive integrator
makes discrete accept/reject decisions on its error estimate, and XLA's
compiled program rounds the DP45 error sum differently from an
operation-by-operation evaluation (1 ulp at the first attempt); on the
Cartesian rays that graze the layer peak (70° and 80°) a decision flips
near 210 km of arc and the paths part (to 1.3e-5 relative; the spherical
80° ray's midpoint by 1.7e-9). So adaptive rays are held to the compiled
JAX function at rtol 1e-9 on every per-ray metric with the same status and
``alive`` pattern on the golden elevations up to 65° (the direction
components of the path differ there by up to 2.4e-9), with the same status
on all five, and to the JAX function run operation by operation
(``jax.disable_jit``) through the first 240 km of the steep 80° ray,
where the port must equal it to rtol 1e-12 with the same ``alive``
pattern (the operation-by-operation run takes ~0.2 s an attempt, so it
covers the O ray's divergence and no more).
"""

import jax
import numpy as np
import pytest
import torch

import pyrayhf_tpu.fields as JF
import pyrayhf_tpu.gradient as JG
import pyrayhf_tpu_torch.fields as TF
import pyrayhf_tpu_torch.gradient as TG

from _torch_threads import one_torch_thread  # noqa: F401

KEYS = ["group_path_km", "group_delay_sec", "ground_range_km", "x_apex_km",
        "z_apex_km"]
CART = dict(z_max_km=600.0, x_min_km=0.0, x_max_km=1000.0)
SPH = dict(r_max_km=6371.0 + 600.0, phi_min=-0.1, phi_max=1000.0 / 6371.0)
ADAPT = {"cartesian": dict(step_km=5.0, rtol=1e-7, atol=1e-9,
                           max_step_km=5.0),
         "spherical": dict(step_km=2.0, rtol=1e-7, atol=1e-9,
                           max_step_km=2.0)}


@pytest.fixture(scope="module")
def fields(goldens):
    """(JAX, port) interpolator pairs per (geometry, mode)."""
    alt, x = goldens["gauss_alt"], goldens["gauss_x_grid"]
    out = {}
    for geo in ("cartesian", "spherical"):
        for mode, sfx in (("O", ""), ("X", "_X")):
            mu = goldens["gauss_mu_field" + sfx]
            mup = goldens["gauss_mup_field" + sfx]
            build = f"build_refractive_index_interpolator_{geo}"
            out[geo, mode] = (
                (getattr(JF, build)(alt, x, mu),
                 JF.build_mup_function(mup_field=mup, x_grid=x, z_grid=alt,
                                       geometry=geo)),
                (getattr(TF, build)(alt, x, torch.from_numpy(mu)),
                 TF.build_mup_function(torch.from_numpy(mup), x, alt,
                                       geometry=geo)))
    return out


def _trace(pkg, geo, f, el, s_max=4000.0, **kw):
    fn = (JG if pkg == "jax" else TG).__dict__[
        f"trace_ray_{geo}_gradient"]
    bounds = CART if geo == "cartesian" else SPH
    return fn(*f[0 if pkg == "jax" else 1], 0.0, 0.0, float(el), s_max,
              **bounds, **kw)


def _metrics(r):
    return np.array([float(r[k]) for k in KEYS])


def _same(port, ref, rtol, what="", scalars_only=False):
    """The port's outputs equal the JAX function's: status string, alive
    pattern exactly, arrays (or only the per-ray metrics) with equal NaN
    masks at ``rtol``."""
    assert port["status"] == ref["status"], what
    assert port["t"] is None
    assert np.array_equal(port["alive"].numpy(), np.asarray(ref["alive"])), \
        what
    for k in ref:
        if k in ("status", "t", "alive") or (scalars_only
                                             and np.ndim(ref[k])):
            continue
        a, b = np.asarray(ref[k]), port[k].numpy()
        assert a.shape == b.shape, (what, k)
        assert np.array_equal(np.isnan(a), np.isnan(b)), (what, k)
        m = np.isfinite(a)
        np.testing.assert_allclose(b[m], a[m], rtol=rtol, atol=1e-12,
                                   err_msg=f"{what} {k}")


def _vs_oracle(port, ref, tol, what):
    ours = _metrics(port)
    assert np.array_equal(np.isfinite(ours), np.isfinite(ref)), what
    m = np.isfinite(ref)
    rel = np.abs(ours[m] - ref[m]) / np.maximum(np.abs(ref[m]), 1e-9)
    assert rel.max() < tol, (what, rel)


@pytest.mark.parametrize("geo,mode,golden", [
    ("cartesian", "O", "grad_cart_O"), ("spherical", "O", "grad_sph_O"),
    ("cartesian", "X", "grad_cart_X")])
def test_adaptive_rays_match_oracle_and_jax(goldens, fields, geo, mode,
                                            golden):
    f = fields[geo, mode]
    for j, el in enumerate(goldens["snell_elevs"]):
        port = _trace("torch", geo, f, el, **ADAPT[geo])
        _vs_oracle(port, goldens[golden][j], 0.015, (golden, el))
        ref = _trace("jax", geo, f, el, **ADAPT[geo])
        assert port["status"] == ref["status"], (golden, el)
        if el <= 65.0:
            _same(port, ref, 1e-9, (golden, el), scalars_only=True)


def test_adaptive_steep_ray_matches_jax_op_by_op(fields):
    """The 80° ray, whose accept decisions part from the compiled JAX
    program at attempt 47 (209 km of arc), equals the JAX function run
    operation by operation through 240 km."""
    f = fields["cartesian", "O"]
    port = _trace("torch", "cartesian", f, 80.0, s_max=240.0,
                  **ADAPT["cartesian"])
    with jax.disable_jit():
        ref = _trace("jax", "cartesian", f, 80.0, s_max=240.0,
                     **ADAPT["cartesian"])
    _same(port, ref, 1e-12)
    assert port["alive"].numpy().sum() > 47          # past the divergence


@pytest.mark.parametrize("geo,adaptive", [("cartesian", True),
                                          ("spherical", True),
                                          ("spherical", False)])
def test_early_exit_equals_full_loop(fields, geo, adaptive):
    """early_exit=True stops once the ray is frozen and fills the rest
    with its final state: every output equals the full-length loop."""
    f = fields[geo, "O"]
    kw = (dict(ADAPT[geo], step_km=5.0, max_step_km=5.0) if adaptive
          else dict(step_km=5.0, max_step_km=5.0))
    full = _trace("torch", geo, f, 35.0, s_max=1500.0, early_exit=False,
                  **kw)
    assert TG.EXIT_STATS["steps"] == TG.EXIT_STATS["of"]
    early = _trace("torch", geo, f, 35.0, s_max=1500.0, **kw)
    stats = dict(TG.EXIT_STATS)
    assert stats["steps"] < stats["of"]
    assert stats["chunks"] == -(-stats["steps"] // TG._FROZEN_CHECK)
    assert early["status"] == full["status"] == "ground"
    for k, v in full.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(torch.nan_to_num(v, nan=-1.0),
                               torch.nan_to_num(early[k], nan=-1.0)), k


def test_attempt_budget_status(fields):
    """A ray that runs out of attempts before s_max reports 'attempts'."""
    f = fields["cartesian", "O"]
    kw = dict(step_km=100.0, rtol=1e-13, atol=1e-15, max_step_km=100.0)
    port = _trace("torch", "cartesian", f, 35.0, s_max=2000.0, **kw)
    ref = _trace("jax", "cartesian", f, 35.0, s_max=2000.0, **kw)
    assert port["status"] == ref["status"] == "attempts"


def test_adaptive_nan_region_freezes():
    """A NaN μ region shrinks the step and freezes the ray at its edge
    (``tests/test_tracers.py:393``), as in the JAX package."""
    z = np.linspace(0.0, 600.0, 121)
    x = np.linspace(0.0, 1000.0, 41)
    mu = np.ones((z.size, x.size))
    mu[z > 300.0, :] = np.nan
    kw = dict(step_km=5.0, rtol=1e-7, atol=1e-9, max_step_km=50.0,
              z_max_km=600.0, x_min_km=0.0, x_max_km=1000.0)
    port = TG.trace_ray_cartesian_gradient(
        TF.build_refractive_index_interpolator_cartesian(
            z, x, torch.from_numpy(mu)),
        TF.build_mup_function(torch.ones(mu.shape, dtype=torch.float64), x,
                              z, geometry="cartesian"),
        0.0, 10.0, 80.0, 2000.0, **kw)
    zpath = port["z"].numpy()
    assert np.all(np.isfinite(zpath))
    assert zpath.max() < 320.0
    assert not bool(port["alive"][-1])
    ref = JG.trace_ray_cartesian_gradient(
        JF.build_refractive_index_interpolator_cartesian(z, x, mu),
        JF.build_mup_function(mup_field=np.ones_like(mu), x_grid=x,
                              z_grid=z, geometry="cartesian"),
        0.0, 10.0, 80.0, 2000.0, **kw)
    _same(port, ref, 1e-9)
