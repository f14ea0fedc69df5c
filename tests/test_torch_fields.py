"""PyTorch port vs the JAX package: 2-D refractive-index fields.

Inputs are made with numpy from a seed and fed to both packages in f64.
Tolerance: rtol 1e-12 (atol 1e-12 times the largest magnitude, for values
that cancel to ~0) with identical NaN masks — the same expressions in the
same order, on uniform and non-uniform grids, with out-of-domain and NaN
queries.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from numpy.testing import assert_allclose

import pyrayhf_tpu.fields as JF
import pyrayhf_tpu_torch.fields as TF

from _torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-12


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float64))


def _same(port, ref, rtol=RTOL):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else port
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    assert np.array_equal(np.isnan(port), np.isnan(ref))
    m = np.isfinite(ref)
    scale = np.abs(ref[m]).max() if m.any() else 1.0
    assert_allclose(port[m], ref[m], rtol=rtol, atol=1e-12 * scale)


def _grids(uniform):
    if uniform:
        return np.linspace(0.0, 400.0, 41), np.linspace(0.0, 2000.0, 17)
    rng = np.random.default_rng(5)
    z = np.sort(rng.uniform(0.0, 400.0, 41))
    z[0], z[-1] = 0.0, 400.0
    return z, np.concatenate([np.linspace(0, 500, 6), np.geomspace(600, 2000,
                                                                   11)])


def _field(z, x, nan_region=True):
    rng = np.random.default_rng(6)
    f = (1.0 - 0.8 * np.exp(-((z[:, None] - 250.0) / 60.0) ** 2)
         + 0.05 * rng.normal(size=(z.size, x.size)))
    if nan_region:
        f[28:33, 5:9] = np.nan                  # an evanescent pocket
    return f


def _queries(z, x, n=500):
    rng = np.random.default_rng(7)
    zq = rng.uniform(z[0] - 30.0, z[-1] + 30.0, n)
    xq = rng.uniform(x[0] - 100.0, x[-1] + 100.0, n)
    zq[:20], xq[20:40] = np.nan, np.nan          # NaN queries
    zq[40:45], xq[45:50] = z[0], x[-1]           # exactly on the edges
    zq[50:60] = z[np.arange(10) * 4]             # exactly on nodes
    return zq, xq


def test_uniform_axis_matches_jax():
    rng = np.random.default_rng(8)
    cases = [np.linspace(0.0, 638.75, 512), np.linspace(80.0, 699.0, 620),
             np.linspace(0.0, 620.0, 621).astype(np.float32),
             6371.0 + np.linspace(0.0, 400.0, 101),
             np.linspace(0.0, 1.0, 50) + 1e-5 * rng.normal(size=50),
             np.geomspace(1.0, 100.0, 30), np.array([1.0]), np.zeros((2, 2))]
    for c in cases:
        assert TF.uniform_axis(c) == JF.uniform_axis(c)


@pytest.mark.parametrize("uniform", [True, False])
def test_gradient_ord2_matches_jax_and_numpy(uniform):
    z, x = _grids(uniform)
    f = _field(z, x, nan_region=False)
    gz, gx = TF.gradient_ord2(_t(f), _t(z), _t(x))
    jz, jx = JF.gradient_ord2(jnp.asarray(f), jnp.asarray(z), jnp.asarray(x))
    _same(gz, jz)
    _same(gx, jx)
    nz, nx = np.gradient(f, z, x, edge_order=2)
    assert_allclose(gz.numpy(), nz, rtol=1e-9, atol=1e-12)
    # leading batch dimension: each slice as on its own
    fb = np.stack([f, 2.0 * f + 1.0])
    bz, bx = TF.gradient_ord2(_t(fb), _t(z), _t(x))
    for i in range(2):
        one = TF.gradient_ord2(_t(fb[i]), _t(z), _t(x))
        assert torch.equal(bz[i], one[0]) and torch.equal(bx[i], one[1])


@pytest.mark.parametrize("uniform", [True, False])
@pytest.mark.parametrize("geometry", ["cartesian", "spherical"])
def test_value_and_grad_matches_jax(uniform, geometry):
    """Out-of-domain queries: NaN μ and 0 gradients; NaN queries likewise;
    in-domain NaN corners poison the value as the JAX 0·NaN does."""
    z, x = _grids(uniform)
    f = _field(z, x)
    jfld = JF.RefractiveField(z, x, f, geometry=geometry)
    tfld = TF.RefractiveField(z, x, _t(f), geometry=geometry)
    assert tfld._uniform == jfld._uniform == uniform
    zq, xq = _queries(z, x)
    if geometry == "spherical":
        c0, c1 = 6371.0 + zq, xq / 6371.0
    else:
        c0, c1 = zq, xq
    for p, r in zip(tfld.value_and_grad(_t(c0), _t(c1)),
                    jfld.value_and_grad(jnp.asarray(c0), jnp.asarray(c1))):
        _same(p, r)
    _same(tfld.value(_t(c0), _t(c1)), jfld.value(jnp.asarray(c0),
                                                 jnp.asarray(c1)))
    n, g0, g1 = tfld.value_and_grad(_t(c0), _t(c1))
    out = ~((zq >= z[0]) & (zq <= z[-1]) & (xq >= x[0]) & (xq <= x[-1]))
    assert torch.isnan(n[out]).all() and (g0[out] == 0).all()
    assert torch.isnan(n[~out]).any()            # the evanescent pocket


def test_batched_field_equals_per_slice():
    z, x = _grids(True)
    f = np.stack([_field(z, x), 1.5 * _field(z, x, nan_region=False)])
    zq, xq = _queries(z, x, n=64)
    q = (_t(np.stack([zq, zq[::-1]])), _t(np.stack([xq, xq[::-1]])))
    batched = TF.RefractiveField(z, x, _t(f)).value_and_grad(*q)
    for i in range(2):
        one = TF.RefractiveField(z, x, _t(f[i])).value_and_grad(q[0][i],
                                                                q[1][i])
        for b, o in zip(batched, one):
            assert torch.equal(torch.nan_to_num(b[i]), torch.nan_to_num(o))
    with pytest.raises(ValueError, match="batch shape"):
        TF.RefractiveField(z, x, _t(f)).value(_t(zq), _t(xq))


def test_bilinear_matches_jax():
    z, x = _grids(False)
    f = _field(z, x)
    zq, xq = _queries(z, x)
    _same(TF.bilinear(_t(zq), _t(xq), _t(z), _t(x), _t(f)),
          JF.bilinear(zq, xq, jnp.asarray(z), jnp.asarray(x),
                      jnp.asarray(f)))


@pytest.mark.parametrize("geometry", ["cartesian", "spherical"])
def test_interpolator_factories_match_jax(geometry):
    z, x = _grids(True)
    f = _field(z, x)
    zq, xq = _queries(z, x, n=200)
    if geometry == "cartesian":
        jn = JF.build_refractive_index_interpolator_cartesian(z, x, f)
        tn = TF.build_refractive_index_interpolator_cartesian(z, x, _t(f))
        a, b = xq, zq
    else:
        jn = JF.build_refractive_index_interpolator_spherical(z, x, f)
        tn = TF.build_refractive_index_interpolator_spherical(z, x, _t(f))
        a, b = xq / 6371.0, 6371.0 + zq
    for p, r in zip(tn(_t(a), _t(b)), jn(jnp.asarray(a), jnp.asarray(b))):
        _same(p, r)
    jm = JF.build_mup_function(f, x, z, geometry=geometry)
    tm = TF.build_mup_function(_t(f), x, z, geometry=geometry)
    _same(tm(_t(xq), _t(zq)), jm(jnp.asarray(xq), jnp.asarray(zq)))


def test_n_and_grad_helpers_match_jax():
    z, x = _grids(False)
    f = _field(z, x, nan_region=False)
    gz, gx = np.gradient(f, z, x, edge_order=2)
    jf = [JF.RefractiveField(z, x, a) for a in (f, gx, gz)]
    tf = [TF.RefractiveField(z, x, _t(a)) for a in (f, gx, gz)]
    zq, xq = _queries(z, x, n=100)
    for p, r in zip(TF.n_and_grad(_t(xq), _t(zq), *tf),
                    JF.n_and_grad(xq, zq, *jf)):
        _same(p, r)
    for p, r in zip(TF.make_n_and_grad(*tf)(_t(xq), _t(zq)),
                    JF.make_n_and_grad(*jf)(xq, zq)):
        _same(p, r)
    sf = [TF.RefractiveField(z, x, _t(a), geometry="spherical")
          for a in (f, gz, gx)]
    jsf = [JF.RefractiveField(z, x, a, geometry="spherical")
           for a in (f, gz, gx)]
    phi, r = xq / 6371.0, 6371.0 + zq
    for p, q in zip(TF.n_and_grad_rphi(_t(phi), _t(r), *sf),
                    JF.n_and_grad_rphi(phi, r, *jsf)):
        _same(p, q)


def test_field_validation():
    z, x = _grids(True)
    with pytest.raises(ValueError, match="shape"):
        TF.RefractiveField(z, x, _t(np.zeros((3, 3))))
    with pytest.raises(ValueError, match="increasing"):
        TF.RefractiveField(z[::-1], x, _t(np.zeros((z.size, x.size))))
    with pytest.raises(ValueError, match="geometry"):
        TF.RefractiveField(z, x, _t(np.zeros((z.size, x.size))),
                           geometry="polar")


@pytest.mark.parametrize("axis", [0, 1, 2, -1])
def test_grad_axis_ord2_on_a_two_node_axis_matches_jax(axis):
    """A 2-node axis (a range-independent slice): the edge stencils read
    their out-of-range nodes clamped, as JAX's indexing clamps them, so
    both edges give 1.5·(f1 − f0)/h and the interior is empty."""
    rng = np.random.default_rng(9)
    shape = [5, 4, 3]
    shape[axis] = 2
    f = rng.normal(size=shape)
    c = np.array([-100.0, 3000.0])
    got = TF.grad_axis_ord2(_t(f), _t(c), axis)
    _same(got, JF.grad_axis_ord2(jnp.asarray(f), jnp.asarray(c), axis))
    edge = 1.5 * np.diff(f, axis=axis) / 3100.0
    assert_allclose(got.numpy(), np.concatenate([edge, edge], axis=axis),
                    rtol=1e-12)
