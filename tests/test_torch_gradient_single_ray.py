"""PyTorch port vs the JAX package: the fixed-step single-ray gradient
tracers, the tracer config and the ray building blocks.

Inputs: the ``gauss_*`` fields of ``tests/goldens/reference_goldens.npz``
(a Gaussian layer on a 200 × 200 grid, O and X) and the scipy-RK45 oracle
rays ``grad_cart_O``, ``grad_sph_O`` and ``grad_cart_X``, held at the 1%
of ``tests/test_tracers.py:152-250``; against the JAX package (CPU,
float64) at rtol 1e-9 with the same status string and ``alive`` pattern.
The adaptive integrator is ``tests/test_torch_gradient_adaptive.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import pyrayhf_tpu.fields as JF
import pyrayhf_tpu.gradient as JG
import pyrayhf_tpu.rays as JR
import pyrayhf_tpu_torch.fields as TF
import pyrayhf_tpu_torch.gradient as TG
import pyrayhf_tpu_torch.rays as TR
from pyrayhf_tpu.config import GradientTracerConfig as JConfig
from pyrayhf_tpu_torch.config import GradientTracerConfig

from _torch_threads import one_torch_thread  # noqa: F401

KEYS = ["group_path_km", "group_delay_sec", "ground_range_km", "x_apex_km",
        "z_apex_km"]
CART = dict(z_max_km=600.0, x_min_km=0.0, x_max_km=1000.0)
SPH = dict(r_max_km=6371.0 + 600.0, phi_min=-0.1, phi_max=1000.0 / 6371.0)



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


def _same(port, ref, rtol, what=""):
    """The port's outputs equal the JAX function's: status string, alive
    pattern exactly, arrays with equal NaN masks at ``rtol``."""
    assert port["status"] == ref["status"], what
    assert port["t"] is None
    assert np.array_equal(port["alive"].numpy(), np.asarray(ref["alive"])), \
        what
    for k in ref:
        if k in ("status", "t", "alive"):
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
def test_fixed_step_rays_match_oracle_and_jax(goldens, fields, geo, mode,
                                              golden):
    f = fields[geo, mode]
    for j, el in enumerate(goldens["snell_elevs"]):
        port = _trace("torch", geo, f, el, step_km=1.0)
        _vs_oracle(port, goldens[golden][j], 0.01, (golden, el))
        _same(port, _trace("jax", geo, f, el, step_km=1.0), 1e-9,
              (golden, el))




def test_gradient_config_from_jax_config(fields):
    """A GradientTracerConfig built from dataclasses.asdict of the JAX one
    supplies every knob: the trace equals the explicit call bit for bit
    and has the JAX status; explicit rtol=None/atol=None forces RK4, held
    to JAX at rtol 1e-9."""
    jcfg = JConfig(step_km=2.0, s_max_km=3000.0, z_max_km=600.0,
                   x_min_km=0.0, x_max_km=1000.0, rtol=1e-7, atol=1e-9)
    cfg = GradientTracerConfig(**dataclasses.asdict(jcfg))
    (jn, jm), (tn, tm) = fields["cartesian", "O"]
    port = TG.trace_ray_cartesian_gradient(tn, tm, 0.0, 0.0, 35.0,
                                           config=cfg)
    explicit = TG.trace_ray_cartesian_gradient(
        tn, tm, 0.0, 0.0, 35.0, 3000.0, step_km=2.0, z_max_km=600.0,
        x_min_km=0.0, x_max_km=1000.0, rtol=1e-7, atol=1e-9)
    for k, v in explicit.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, port[k]), k
    assert port["status"] == JG.trace_ray_cartesian_gradient(
        jn, jm, 0.0, 0.0, 35.0, config=jcfg)["status"] == "ground"
    fixed = TG.trace_ray_cartesian_gradient(tn, tm, 0.0, 0.0, 35.0,
                                            config=cfg, rtol=None, atol=None)
    _same(fixed, JG.trace_ray_cartesian_gradient(
        jn, jm, 0.0, 0.0, 35.0, config=jcfg, rtol=None, atol=None), 1e-9)
    assert abs(float(fixed["group_path_km"])
               - float(port["group_path_km"])) > 1e-9
    (jn, jm), (tn, tm) = fields["spherical", "O"]
    scfg = JConfig(s_max_km=1000.0, step_km=2.0)
    r = TG.trace_ray_spherical_gradient(
        tn, tm, 0.0, 0.0, 35.0,
        config=GradientTracerConfig(**dataclasses.asdict(scfg)), **SPH)
    _same(r, JG.trace_ray_spherical_gradient(jn, jm, 0.0, 0.0, 35.0,
                                             config=scfg, **SPH), 1e-9)
    assert float(r["group_path_km"]) <= 1000.0 + 5.0


def test_requires_mup_func():
    with pytest.raises(ValueError):
        TG.trace_ray_cartesian_gradient(lambda x, z: (1.0, 0.0, 0.0), None,
                                        0.0, 0.0, 45.0)


def test_rays_match_inlined_rhs_and_jax(fields):
    """The standalone RHS forms equal the tracers' inlined RHS
    (``tests/test_tracers.py:351``) and the JAX package's rays."""
    (jn, _), (tn, _) = fields["cartesian", "O"]
    (jns, _), (tns, _) = fields["spherical", "O"]
    rng = np.random.default_rng(11)
    for _ in range(5):
        x, z = rng.uniform(50.0, 900.0), rng.uniform(50.0, 500.0)
        th = rng.uniform(0.1, 1.4)
        y = torch.tensor([x, z, np.cos(th), np.sin(th)], dtype=torch.float64)
        d_pub = TR.ray_rhs_cartesian(0.0, y, tn).numpy()
        n, dndx, dndz = (float(v) for v in tn(y[0], y[1]))
        gdv = dndx * y[2].item() + dndz * y[3].item()
        d_inl = np.array([y[2].item(), y[3].item(),
                          (dndx - gdv * y[2].item()) / n,
                          (dndz - gdv * y[3].item()) / n])
        np.testing.assert_allclose(d_pub, d_inl, rtol=1e-12)
        np.testing.assert_allclose(
            d_pub, np.asarray(JR.ray_rhs_cartesian(0.0, y.numpy(), jn)),
            rtol=1e-12)
        ys = torch.tensor([6371.0 + z, x / 6371.0, np.sin(th), np.cos(th)],
                          dtype=torch.float64)
        np.testing.assert_allclose(
            TR.rhs_spherical(0.0, ys, tns).numpy(),
            np.asarray(JR.rhs_spherical(0.0, ys.numpy(), jns)), rtol=1e-12)
    y = torch.tensor([3.0, 150.0, 0.5, 0.5], dtype=torch.float64)
    for name, arg in (("event_ground", 0.0), ("event_z_top", 600.0),
                      ("event_z_bottom", 10.0), ("event_x_left", -5.0),
                      ("event_x_right", 50.0)):
        assert float(getattr(TR, name)(0.0, y, arg)) == float(
            getattr(JR, name)(0.0, y.numpy(), arg)), name


def test_snell_helpers_match_jax():
    rng = np.random.default_rng(5)
    z = np.linspace(0.0, 400.0, 81)
    mu = np.sqrt(np.clip(1.0 - np.exp(-((z - 250.0) / 60.0) ** 2), 0, 1))
    for p in (0.3, 0.7, 0.95, 1.2):
        a = float(TR.find_turning_point(z, mu, p, device="cpu"))
        b = float(JR.find_turning_point(z, mu, p))
        assert (np.isnan(a) and np.isnan(b)) or abs(a - b) <= 1e-12 * abs(b)
    m, p = rng.uniform(0.2, 1.0, 7), rng.uniform(0.1, 1.0, 7)
    np.testing.assert_allclose(
        TR.tan_from_mu_scalar(m, p, device="cpu").numpy(),
        np.asarray(JR.tan_from_mu_scalar(m, p)), rtol=1e-12)
