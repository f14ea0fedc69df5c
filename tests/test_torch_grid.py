"""PyTorch port vs the JAX package: stretched grid and profile regridding.

Inputs are made with numpy from a seed and fed to both packages in f64.
Tolerance: per-key ``assert_allclose(rtol=1e-12, atol=1e-9)`` with
identical NaN masks, as ``tests/test_forward.py`` holds the regrid to its
goldens.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from numpy.testing import assert_allclose

import pyrayhf_tpu.grid as J
import pyrayhf_tpu_torch.grid as T

from _torch_threads import one_torch_thread  # noqa: F401


def _profile(seed=3, n_alt=180, e_layer=False):
    alt = np.linspace(90.0, 550.0, n_alt)
    rng = np.random.default_rng(seed)
    den = rng.uniform(1e12, 3e12) * np.exp(
        -(alt - rng.uniform(250.0, 330.0)) ** 2 / (2 * 55.0 ** 2))
    if e_layer:
        den = den + 9e11 * np.exp(-(alt - 110.0) ** 2 / (2 * 10.0 ** 2))
    bmag = np.linspace(3.4e-5, 3.0e-5, n_alt)
    bpsi = np.linspace(60.0, 66.0, n_alt)
    # 0.3 MHz (first-node cutoff in X) .. 25 MHz (escapes)
    freqs_hz = np.concatenate([[0.3], np.arange(1.0, 16.0, 1.5), [25.0]]) * 1e6
    return freqs_hz, den, bmag, bpsi, alt


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float64))


def _assert_regrid_equal(port, ref):
    assert set(port) == set(ref)
    for key in ref:
        p = port[key].numpy()
        r = np.asarray(ref[key])
        assert p.shape == r.shape, key
        if r.dtype == bool or np.issubdtype(r.dtype, np.integer):
            assert np.array_equal(p, r), key
            continue
        assert np.array_equal(np.isnan(p), np.isnan(r)), key
        m = np.isfinite(r)
        assert_allclose(p[m], r[m], rtol=1e-12, atol=1e-9, err_msg=key)


def test_smooth_nonuniform_grid_matches_jax():
    for n, sharp in [(10, 5.0), (200, 10.0), (20000, 10.0)]:
        ref = np.asarray(J.smooth_nonuniform_grid(0.0, 1.0, n, sharp))
        port = T.smooth_nonuniform_grid(0.0, 1.0, n, sharp).numpy()
        assert_allclose(port, ref, rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("mode_mult", [1.0, -1.0])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("e_layer", [False, True])
def test_regrid_core_matches_jax(mode_mult, masked, e_layer):
    f, den, bmag, bpsi, alt = _profile(e_layer=e_layer)
    ref = J.regrid_core(jnp.asarray(f), den, bmag, bpsi, alt,
                        mode_mult=mode_mult, n_points=200, masked=masked)
    port = T.regrid_core(_t(f), _t(den), _t(bmag), _t(bpsi), _t(alt),
                         mode_mult=mode_mult, n_points=200, masked=masked)
    _assert_regrid_equal(port, ref)
    # escaped rows really are NaN (unmasked) / flagged (masked)
    if masked:
        assert not bool(port["row_ok"][-1])
    else:
        assert np.isnan(port["alt"][-1].numpy()).all()


def test_regrid_core_batches_profiles():
    """Leading batch dims: a [B, N_alt] stack regrids like B single calls."""
    profiles = [_profile(seed=s) for s in (3, 4, 5)]
    f = profiles[0][0]
    stack = [np.stack([p[i] for p in profiles]) for i in (1, 2, 3)]
    alt = np.stack([p[4] + 2.0 * i for i, p in enumerate(profiles)])
    batch = T.regrid_core(_t(f), *map(_t, stack), _t(alt), mode_mult=-1.0,
                          n_points=50)
    for b in range(3):
        one = T.regrid_core(_t(f), *(_t(s[b]) for s in stack), _t(alt[b]),
                            mode_mult=-1.0, n_points=50)
        for key in one:
            assert torch.equal(torch.nan_to_num(batch[key][b]),
                               torch.nan_to_num(one[key])), key


def test_regrid_to_nonuniform_grid_quirks():
    """dh is shadowed to 1e-6 and ends each distance row, as in JAX."""
    f, den, bmag, bpsi, alt = _profile()
    a = T.regrid_to_nonuniform_grid(_t(f), _t(den), _t(bmag), _t(bpsi),
                                    _t(alt), mode="O", n_points=64, dh=5.0)
    ref = J.regrid_to_nonuniform_grid(f, den, bmag, bpsi, alt, mode="O",
                                      n_points=64, dh=5.0)
    _assert_regrid_equal(a, ref)
    assert np.all(a["dist"][:, -1].numpy() == 1e-6)


def test_interp_matches_jnp_interp():
    """Repeated nodes (flat extension), edges and exact-node hits."""
    rng = np.random.default_rng(9)
    xp = np.sort(rng.uniform(0.0, 10.0, 40))
    xp[25:] = xp[24]                              # flat-extended tail
    fp = rng.normal(size=40)
    x = np.concatenate([rng.uniform(-1.0, 11.0, 200), xp[:10], [xp[24]]])
    ref = np.asarray(jnp.interp(x, xp, fp))
    port = T.interp(_t(x), _t(xp), _t(fp)).numpy()
    assert_allclose(port, ref, rtol=1e-12, atol=1e-15)
