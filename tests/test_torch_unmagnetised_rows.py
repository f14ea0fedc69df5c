"""PyTorch port vs the JAX package: the unmagnetised branch per profile.

Appleton–Hartree switches to the isotropic indices when max |Y| < 1e-12
over what one call sees (``pyrayhf_tpu/magnetoionic.py:190``). The JAX
package's batched operators are ``jax.vmap`` of one-profile cores, so it
decides per profile; the port runs a stack at once and must decide per
profile too (``magnetoionic._find_mu_mup`` with the leading batch axes).
A direct call of ``find_mu_mup`` still decides over its whole input, as
the JAX function does.

Each batched site gets a mixed stack, every other profile without a field
(|B| = 0), in O and X, f64, against the JAX package (its ``vmap``, or its
one-profile call row by row): identical NaN masks and rtol 1e-10, and each
row of the stack equal to that profile run alone. Port results come first
in each test; the module runs with one torch thread.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from numpy.testing import assert_allclose

import pyrayhf_tpu.doppler as JD
import pyrayhf_tpu.forward as JF
import pyrayhf_tpu.magnetoionic as JM
import pyrayhf_tpu.snell as JS
import pyrayhf_tpu_torch.doppler as TD
import pyrayhf_tpu_torch.forward as TF
import pyrayhf_tpu_torch.magnetoionic as TM
import pyrayhf_tpu_torch.parallel as TP
import pyrayhf_tpu_torch.snell as TS

from _torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-10
MODES = [("O", 1.0), ("X", -1.0)]


def _mixed(B=4, n_alt=180):
    """Gaussian layers (peak 1e11 m⁻³ and up, near 300 km); profiles 0, 2,
    ... without a field, 1, 3, ... at 5e-5 T."""
    alt = np.linspace(90.0, 550.0, n_alt)
    peaks = 1e11 * (1.0 + 0.15 * np.arange(B))
    hm = 300.0 + 8.0 * np.arange(B)
    den = peaks[:, None] * np.exp(-(alt[None, :] - hm[:, None]) ** 2
                                  / (2 * 50.0 ** 2))
    bmag = np.where(np.arange(B)[:, None] % 2 == 1, 5e-5, 0.0) \
        * np.ones((B, n_alt))
    bpsi = np.full((B, n_alt), 60.0)
    freqs = np.array([1.5, 2.0, 2.5, 2.8, 3.0, 3.3])
    return freqs, den, bmag, bpsi, alt


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(port, ref, rtol=RTOL):
    port, ref = _np(port), _np(ref)
    assert port.shape == ref.shape
    np.testing.assert_array_equal(np.isnan(port), np.isnan(ref))
    m = np.isfinite(ref)
    assert m.any()
    assert_allclose(port[m], ref[m], rtol=rtol, atol=0)


def _rows_alone(stack, one):
    """Each row of ``stack`` [B, ...] equals ``one(b)``, its profile alone,
    bit for bit."""
    for b in range(stack.shape[0]):
        alone = _np(one(b))
        np.testing.assert_array_equal(_np(stack)[b], alone.reshape(
            _np(stack)[b].shape))


def test_find_mu_mup_decides_over_its_whole_input():
    """The public functions keep the JAX semantics: one decision over the
    whole array, so a magnetised row makes the Y = 0 row magnetised too."""
    X = np.array([[0.3, 0.6], [0.3, 0.6]])
    Y = np.array([[0.0, 0.0], [0.2, 0.2]])
    psi = np.full_like(X, 40.0)
    for fn_t, fn_j in ((TM.find_mu_mup, JM.find_mu_mup),
                       (TM.find_mu_mup_masked, JM.find_mu_mup_masked)):
        for mode, _ in MODES:
            port = fn_t(_t(X), _t(Y), _t(psi), mode)
            ref = fn_j(jnp.asarray(X), jnp.asarray(Y), jnp.asarray(psi),
                       mode)
            for p, r in zip(port, ref):
                _close(p.double(), np.asarray(r, dtype=np.float64))
    # and the batched helper decides row by row, as a vmap would
    mu, _ = TM._find_mu_mup(_t(X), _t(Y), _t(psi), "X", 1)
    ref = jax.vmap(lambda x, y, p: JM.find_mu_mup(x, y, p, "X"))(
        jnp.asarray(X), jnp.asarray(Y), jnp.asarray(psi))[0]
    _close(mu, ref)
    assert_allclose(_np(mu)[0], np.sqrt(1.0 - X[0]), rtol=1e-15)


@pytest.mark.parametrize("mode,mm", MODES)
def test_parity_batch_operator(mode, mm):
    """``vertical_forward_operator_batch(engine="parity")`` (the ``auto``
    engine on CPU tensors): the JAX package's vmapped operator."""
    freqs, den, bmag, bpsi, alt = _mixed()
    t = [_t(a) for a in (freqs, den, bmag, bpsi, alt)]
    out = TF.vertical_forward_operator_batch(*t, mode=mode, n_points=200,
                                             engine="parity")
    auto = TF.vertical_forward_operator_batch(*t, mode=mode, n_points=200)
    assert torch.equal(torch.nan_to_num(auto), torch.nan_to_num(out))
    _rows_alone(out, lambda b: TF.vertical_forward_operator(
        t[0], t[1][b], t[2][b], t[3][b], t[4], mode=mode, n_points=200))
    ref = JF.vertical_forward_operator_batch(freqs, den, bmag, bpsi, alt,
                                             mode=mode, n_points=200,
                                             engine="parity")
    _close(out, ref)
    # the rows without a field reflect where the isotropic index says
    assert np.isfinite(_np(out)[0, :3]).all()


@pytest.mark.parametrize("mode,mm", MODES)
def test_phase_operator_and_vh_and_mask(mode, mm):
    """The phase operator on a stack, row by row against the JAX
    one-profile call; ``vh_and_mask`` on a stack against its vmap."""
    freqs, den, bmag, bpsi, alt = _mixed()
    t = [_t(a) for a in (freqs, den, bmag, bpsi, alt)]
    ph = TF.vertical_phase_operator(t[0], t[1], t[2], t[3],
                                    t[4].expand_as(t[1]), mode=mode,
                                    n_points=200)
    vh, valid = TF.vh_and_mask(*t[:4], t[4].expand_as(t[1]), mode_mult=mm,
                               n_points=200)
    _rows_alone(vh, lambda b: TF.vh_and_mask(
        t[0], t[1][b], t[2][b], t[3][b], t[4], mode_mult=mm,
        n_points=200)[0])
    for b in range(den.shape[0]):
        _close(ph[b], JF.vertical_phase_operator(
            freqs, den[b], bmag[b], bpsi[b], alt, mode=mode, n_points=200))
    j_vh, j_valid = jax.vmap(lambda d, m, p: JF.vh_and_mask(
        jnp.asarray(freqs), d, m, p, jnp.asarray(alt), mode_mult=mm,
        n_points=200))(jnp.asarray(den), jnp.asarray(bmag),
                       jnp.asarray(bpsi))
    np.testing.assert_array_equal(_np(valid), np.asarray(j_valid))
    _close(vh, j_vh)


@pytest.mark.parametrize("mode,mm", MODES)
def test_doppler_stack_and_sharded(mode, mm):
    """The phase height with its Doppler tangent on a stack
    (``doppler._doppler_core``) and ``doppler_batch_sharded`` on a mesh of
    2 CPU devices, against the JAX package's vmap of its core."""
    freqs, den, bmag, bpsi, alt = _mixed()
    dden = 1e-3 * den * np.linspace(-1.0, 1.0, den.shape[1])
    t = [_t(a) for a in (freqs, den, bmag, bpsi, alt)]
    zero = torch.zeros_like(t[1])
    fd, hp, _ = TD._doppler_core(t[0], t[1], _t(dden), t[2], zero, t[3],
                                 zero, t[4], mm, 200)
    mesh = TP.ionogram_mesh([torch.device("cpu")] * 2)
    sh = TP.doppler_batch_sharded(*t[:2], _t(dden), *t[2:], mesh, mode=mode)
    _rows_alone(fd, lambda b: TD.doppler_shift_vertical(
        t[0], t[1][b], _t(dden[b]), t[2][b], t[3][b], t[4],
        mode=mode)["doppler_hz"])
    z = jnp.zeros_like(jnp.asarray(den[0]))
    j_fd, j_hp, _ = jax.vmap(lambda d, dd, m, p: JD._doppler_core(
        jnp.asarray(freqs), d, dd, m, z, p, z, jnp.asarray(alt),
        mode_mult=mm, n_points=200))(
        jnp.asarray(den), jnp.asarray(dden), jnp.asarray(bmag),
        jnp.asarray(bpsi))
    _close(fd, j_fd)
    _close(hp, j_hp)
    _close(sh["doppler_hz"], j_fd)
    _close(sh["phase_height_km"], j_hp)


@pytest.mark.parametrize("mode,mm", MODES)
def test_snell_fan_stack(mode, mm):
    """The Cartesian Snell fan of a profile stack decides per (profile,
    frequency), as the JAX package's fan vmaps its per-frequency prep;
    held against the JAX fan of each profile."""
    freqs, den, bmag, bpsi, alt = _mixed()
    f0 = freqs[:3] * 1e6
    els = np.array([20.0, 45.0, 70.0])
    t = [_t(a) for a in (f0, els, alt, den, bmag, bpsi)]
    fan = TS.trace_rays_cartesian_snells(*t, mode)
    for b in range(den.shape[0]):
        ref = JS.trace_rays_cartesian_snells(f0, els, alt, den[b], bmag[b],
                                             bpsi[b], mode)
        for k in ("ground_range_km", "group_path_km", "phase_path_km"):
            _close(fan[k][b], ref[k])
