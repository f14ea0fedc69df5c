"""PyTorch port vs the JAX package: MUF, Faraday rotation, Doppler and the
profiling leftovers.

The same seeded profiles go through ``pyrayhf_tpu`` (CPU, float64) and the
port on CPU tensors: a Chapman F2 + E profile and the Gaussian layer of
``tests/test_tracers.py:26`` (the JAX package's own Doppler and Faraday
tests take the Day pickle, which is not in the repo). NaN masks must be
identical; finite values agree to rtol 1e-10. The moving-mirror limit of
``tests/test_doppler.py:39`` is held in the port at its 5%.
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import pyrayhf_tpu as J
import pyrayhf_tpu.muf as JM
import pyrayhf_tpu.profiling as JP
import pyrayhf_tpu_torch as T
import pyrayhf_tpu_torch.muf as TM
import pyrayhf_tpu_torch.profiling as TP
from pyrayhf_tpu_torch.constants import C_KM_S

from _torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-10


def _chapman(scale=1.0):
    alt = np.linspace(80.0, 700.0, 249)
    h = (alt - 310.0) / 48.0
    he = (alt - 110.0) / 9.0
    den = scale * (9e11 * np.exp(0.5 * (1 - h - np.exp(-h)))
                   + 9e10 * np.exp(0.5 * (1 - he - np.exp(-he))))
    bmag = 5.2e-5 * (6451.0 / (6371.0 + alt)) ** 3
    return alt, den, bmag, np.full_like(alt, 38.0)


def _gauss():
    alt = np.linspace(0.0, 600.0, 200)
    den = 1e12 * np.exp(-(alt - 250.0) ** 2 / (2 * 60.0 ** 2))
    return alt, den, np.full_like(alt, 4e-5), np.full_like(alt, 45.0)


PROFILES = {"chapman": _chapman, "gauss": _gauss}


def _close(port, ref, rtol=RTOL, what=""):
    b = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    a = np.asarray(ref)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert np.array_equal(np.isnan(a), np.isnan(b)), what
    m = np.isfinite(a)
    assert_allclose(b[m], a[m], rtol=rtol, atol=0, err_msg=what)


def test_vertical_to_oblique_matches_jax_and_inverts():
    rng = np.random.default_rng(0)
    fv, hv = rng.uniform(2, 12, 32), rng.uniform(90, 450, 32)
    fv[3] = np.nan
    for D in (300.0, 1800.0):
        ref = JM.vertical_to_oblique(fv, hv, D)
        port = TM.vertical_to_oblique(fv, hv, D, device="cpu")
        for a, b in zip(ref, port):
            _close(b, a)
        fv2, hv2 = T.oblique_to_vertical(D, port[1], port[0])
        m = np.isfinite(fv)
        assert_allclose(fv2.numpy()[m], fv[m], rtol=1e-12)
        assert_allclose(hv2.numpy()[m], hv[m], rtol=1e-12)


@pytest.mark.parametrize("profile", list(PROFILES))
@pytest.mark.parametrize("mode", ["O", "X"])
def test_muf_from_profile_matches_jax(profile, mode):
    alt, den, bmag, bpsi = PROFILES[profile]()
    D = np.array([500.0, 1000.0, 2000.0, 3000.0])
    ref = J.muf_from_profile(D, den, bmag, bpsi, alt, mode=mode)
    port = T.muf_from_profile(D, den, bmag, bpsi, alt, mode=mode,
                              device="cpu")
    _close(port, ref)
    assert np.all(np.diff(port.numpy()) > 0)
    _close(T.muf_from_profile(1500.0, den, bmag, bpsi, alt, mode=mode,
                              device="cpu"),
           J.muf_from_profile(1500.0, den, bmag, bpsi, alt, mode=mode))
    assert np.array_equal(TM._default_freq_grid(den, bmag, mode),
                          np.asarray(JM._default_freq_grid(den, bmag, mode)))


@pytest.mark.parametrize("engine", ["parity", "xla", "pallas_gather",
                                    "auto"])
@pytest.mark.parametrize("mode", ["O", "X"])
def test_muf_map_matches_jax(engine, mode):
    """Four profiles, the last too weak to reflect any frequency of the
    list (its map row is NaN); every engine against the JAX parity map
    (the kernel engines run their plain versions on CPU tensors)."""
    alt, den, bmag, bpsi = _chapman()
    scale = np.array([0.4, 1.0, 1.7, 1e-6])
    den_b = scale[:, None] * den[None, :]
    bm = np.broadcast_to(bmag, den_b.shape).copy()
    bp = np.broadcast_to(bpsi, den_b.shape).copy()
    freqs = np.arange(1.0, 14.0, 0.1)
    D = np.array([1000.0, 3000.0])
    ref = J.muf_map(D, den_b, bm, bp, alt, mode=mode, freq_mhz=freqs,
                    engine="parity")
    port = T.muf_map(D, den_b, bm, bp, alt, mode=mode, freq_mhz=freqs,
                     engine=engine, device="cpu")
    _close(port, ref, rtol=RTOL if engine == "parity" else 1e-8)
    assert port.shape == (2, 4) and torch.isnan(port[:, 3]).all()
    _close(T.muf_map(2000.0, den_b, bm, bp, alt, mode=mode, engine=engine,
                     device="cpu"),
           J.muf_map(2000.0, den_b, bm, bp, alt, mode=mode,
                     engine="parity"),
           rtol=RTOL if engine == "parity" else 1e-8)


@pytest.mark.parametrize("profile", list(PROFILES))
def test_faraday_matches_jax(profile):
    import jax
    import jax.numpy as jnp

    alt, den, bmag, bpsi = PROFILES[profile]()
    f = np.array([5e6, 12e6, 40e6, 100e6, 300e6])
    ref = J.faraday_rotation_vertical(f, den, bmag, bpsi, alt)
    port = T.faraday_rotation_vertical(f, den, bmag, bpsi, alt, device="cpu")
    _close(port, ref)
    assert np.isnan(port[0].item()) and np.isfinite(port[2:].numpy()).all()
    one = T.faraday_rotation_vertical(100e6, den, bmag, bpsi, alt,
                                      device="cpu")
    assert one.ndim == 0
    # the density sensitivity by autograd against jax.grad
    d = torch.tensor(den, requires_grad=True)
    T.faraday_rotation_vertical(100e6, d, torch.from_numpy(bmag),
                                torch.from_numpy(bpsi),
                                torch.from_numpy(alt)).backward()
    g = jax.grad(lambda x: J.faraday_rotation_vertical(
        100e6, x, bmag, bpsi, alt))(jnp.asarray(den))
    _close(d.grad, g, rtol=1e-9)


@pytest.mark.parametrize("profile", list(PROFILES))
@pytest.mark.parametrize("mode", ["O", "X"])
def test_doppler_matches_jax(profile, mode):
    """Every output key, with a density tendency (a TID-like relative
    perturbation plus an uplift) and a field tendency."""
    alt, den, bmag, bpsi = PROFILES[profile]()
    rng = np.random.default_rng(17)
    dden = (den * 1e-3 * np.sin(2 * np.pi * (alt - alt[0]) / 150.0)
            - 0.02 * np.gradient(den, alt))
    dbmag = bmag * 1e-6 * rng.standard_normal(alt.size)
    freqs = np.arange(1.5, 16.0, 0.5)
    ref = J.doppler_shift_vertical(freqs, den, dden, bmag, bpsi, alt,
                                   mode=mode, dbmag_dt=dbmag)
    port = T.doppler_shift_vertical(freqs, den, dden, bmag, bpsi, alt,
                                    mode=mode, dbmag_dt=dbmag, device="cpu")
    assert set(port) == set(ref)
    for k in ref:
        _close(port[k], ref[k], what=k)
    fd = port["doppler_hz"].numpy()
    assert np.isfinite(fd).sum() >= 5 and np.isnan(fd).any()
    hp, valid = T.phase_height_and_mask(freqs, den, bmag, bpsi, alt,
                                        mode_mult=1.0 if mode == "O"
                                        else -1.0, device="cpu")
    jhp, jvalid = J.phase_height_and_mask(freqs, den, bmag, bpsi, alt,
                                          mode_mult=1.0 if mode == "O"
                                          else -1.0)
    assert np.array_equal(valid.numpy(), np.asarray(jvalid))
    _close(hp, jhp)
    # where valid, the masked operator is the parity phase operator
    hp_parity = T.vertical_phase_operator(freqs, den, bmag, bpsi, alt,
                                          mode=mode, device="cpu").numpy()
    v = valid.numpy()
    assert_allclose(hp.numpy()[v], hp_parity[v], rtol=1e-10)
    assert np.isnan(hp_parity[~v]).all()


def test_doppler_tangent_is_the_derivative():
    """The forward-mode tangent against a central difference of the port's
    masked phase operator (``tests/test_doppler.py:70``'s bound)."""
    alt, den, bmag, bpsi = _chapman()
    dden = den * 1e-3 * np.sin(2 * np.pi * (alt - alt[0]) / 150.0)
    freqs = np.array([3.0, 5.0, 7.0])
    out = T.doppler_shift_vertical(freqs, den, dden, bmag, bpsi, alt,
                                   n_points=300, device="cpu")
    eps = 1e-3
    hp = [T.phase_height_and_mask(freqs, den + s * eps * dden, bmag, bpsi,
                                  alt, n_points=300, device="cpu")
          for s in (1.0, -1.0)]
    assert bool((hp[0][1] & hp[1][1]).all())
    fd = (-(2.0 * freqs * 1e6 / C_KM_S) * (hp[0][0] - hp[1][0]).numpy()
          / (2 * eps))
    assert_allclose(out["doppler_hz"].numpy(), fd, rtol=2e-4, atol=1e-4)


def test_moving_mirror_doppler():
    """A rigidly uplifting sharp layer: f_D = -2 f v / c
    (``tests/test_doppler.py:39``), and equal to the JAX package's."""
    alt = np.linspace(80.0, 700.0, 600)
    den = np.maximum(4e12 / (1.0 + np.exp(-(alt - 300.0) / 8.0)), 1.0)
    bmag, bpsi = np.full(600, 1e-16), np.zeros(600)
    v = 0.05
    dden = -v * np.gradient(den, alt)
    freqs = np.array([2.0, 4.0, 8.0])
    out = T.doppler_shift_vertical(freqs, den, dden, bmag, bpsi, alt,
                                   mode="O", n_points=400, device="cpu")
    fd = out["doppler_hz"].numpy()
    assert np.isfinite(fd).all()
    assert_allclose(fd, -2.0 * freqs * 1e6 * v / C_KM_S, rtol=5e-2)
    assert_allclose(out["dhp_dt_km_s"].numpy(), v, rtol=5e-2)
    ref = J.doppler_shift_vertical(freqs, den, dden, bmag, bpsi, alt,
                                   mode="O", n_points=400)
    _close(out["doppler_hz"], ref["doppler_hz"])


def test_operator_cost_and_trace(tmp_path):
    assert TP.operator_cost(64, 175, 200, 620) == JP.operator_cost(
        64, 175, 200, 620)
    assert TP.operator_cost(2, 3, 4, 5, 9) == JP.operator_cost(2, 3, 4, 5, 9)
    with TP.trace(str(tmp_path / "tr")) as d:
        T.faraday_rotation_vertical(30e6, *_gauss()[1:], _gauss()[0],
                                    device="cpu")
    assert d == str(tmp_path / "tr")
    assert any((tmp_path / "tr").iterdir())
