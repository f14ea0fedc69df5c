"""PyTorch port vs the JAX package: mesh sharding (synthesis, height
quadrature, the retrieval step, Doppler, the mesh itself).

The JAX functions run on the tests' 8 virtual CPU devices as a 4×2 mesh
(``tests/conftest.py``); the port on ``[torch.device("cpu")] * 8`` as a
4×2 mesh, on the same seeded numpy inputs in f64. Tolerances:

* synthesis: against the JAX sharded call identical NaN masks and
  ≤ 1e-6 km (the port's ``ionogram_fast_xla`` bound,
  ``tests/test_torch_pallas_vh.py``); against the port's unsharded call
  rtol 1e-12 (each block is the same computation on fewer rows);
* height quadrature: identical NaN masks and rtol 1e-10 against the port's
  ``vertical_forward_operator`` and the JAX ``vh_height_sharded`` (the
  partial sums add in another order than one sum);
* the retrieval step: rtol 1e-10 against the JAX step and against
  θ − lr·∇L_total of the unsharded loss;
* Doppler: identical NaN masks and rtol 1e-10 against the JAX call.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from numpy.testing import assert_allclose

import pyrayhf_tpu.parallel as JP
import pyrayhf_tpu_torch as prt
import pyrayhf_tpu_torch.pallas_vh as TV
import pyrayhf_tpu_torch.parallel as TP

from _torch_threads import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
TOL_KM = 1e-6
EIGHT = ["ionogram_mesh", "synthesize_ionograms_sharded",
         "vh_height_sharded", "retrieval_step_sharded",
         "retrieve_gradient_batch_sharded", "trace_fan_3d_sharded",
         "trace_fan_3d_aniso_sharded", "doppler_batch_sharded"]


@pytest.fixture(scope="module")
def mesh8():
    if jax.device_count() < 8:
        pytest.skip("needs 8 virtual devices")
    return JP.ionogram_mesh(jax.devices()[:8], batch_axis=4)


@pytest.fixture(scope="module")
def tmesh():
    return TP.ionogram_mesh([CPU] * 8, batch_axis=4)


def _batch_profiles(B, N=120):
    alt = np.linspace(90.0, 500.0, N)
    rng = np.random.default_rng(0)
    peaks = rng.uniform(1.5e12, 3e12, B)
    hms = rng.uniform(250.0, 350.0, B)
    den = peaks[:, None] * np.exp(-(alt[None, :] - hms[:, None]) ** 2
                                  / (2 * 60.0 ** 2))
    bmag = np.full((B, N), 4e-5)
    bpsi = np.full((B, N), 50.0)
    return alt, den, bmag, bpsi


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _same_nan(a, b):
    np.testing.assert_array_equal(np.isnan(_np(a)), np.isnan(_np(b)))


def test_exports():
    assert TP.__all__ == EIGHT
    assert all(callable(getattr(TP, n)) for n in EIGHT)
    assert set(EIGHT) <= set(TP.mesh.__all__)
    assert prt.parallel is TP


@pytest.mark.parametrize("engine", ["xla", "pallas"])
def test_sharded_synthesis_matches(mesh8, tmesh, engine):
    alt, den, bmag, bpsi = _batch_profiles(8)
    freqs = np.arange(2.0, 10.0, 0.5)          # 16 freqs / 2 freq-shards
    kw = dict(mode="O", n_points=100, engine=engine)
    jx = np.asarray(JP.synthesize_ionograms_sharded(
        freqs, den, bmag, bpsi, alt, mesh8, interpret=engine == "pallas",
        **kw))
    TV.reset_counters()
    out = TP.synthesize_ionograms_sharded(freqs, den, bmag, bpsi, alt,
                                          tmesh, **kw)
    # one call of the block function per (batch, freq) block; on CPU
    # tensors the sweep's plain version is ionogram_fast_xla
    assert TV.PLAIN_CALLS["sweep"] == 8 and sum(TV.LAUNCHES.values()) == 0
    assert out.shape == (8, 16) and out.dtype == torch.float64
    assert out.device.type == "cpu"
    _same_nan(out, jx)
    m = np.isfinite(jx)
    assert np.abs(_np(out)[m] - jx[m]).max() <= TOL_KM
    un = (TV.ionogram_pallas if engine == "pallas" else TV.ionogram_fast_xla)(
        freqs, den, bmag, bpsi, alt, mode_mult=1.0, n_points=100,
        device="cpu")
    _same_nan(out, un)
    assert_allclose(_np(out)[m], _np(un)[m], rtol=1e-12)


def test_sharded_synthesis_takes_tensors_and_float32(tmesh):
    """Tensors keep the density's dtype; X mode; a 1-device mesh is the
    unsharded call. Sharded f32 against unsharded: ≤ 1e-3 km, the f32
    bound for one sum in another order (``chip_smoke.TOL_F32_PLAIN``:
    torch sums a smaller block's rows in another order on the CPU too)."""
    alt, den, bmag, bpsi = _batch_profiles(8)
    freqs = np.arange(2.0, 10.0, 0.5)
    t = [torch.as_tensor(a, dtype=torch.float32)
         for a in (freqs, den, bmag, bpsi, alt)]
    out = TP.synthesize_ionograms_sharded(*t, tmesh, mode="X",
                                          n_points=100)
    assert out.dtype == torch.float32
    one = TP.synthesize_ionograms_sharded(*t, TP.ionogram_mesh([CPU]),
                                          mode="X", n_points=100)
    un = TV.ionogram_fast_xla(*t, mode_mult=-1.0, n_points=100)
    _same_nan(out, un)
    m = torch.isfinite(un)
    assert torch.equal(one[m], un[m])
    assert (out[m] - un[m]).abs().max() <= 1e-3


@pytest.mark.parametrize("axis", ["batch", "freq"])
def test_height_sharded_quadrature_matches(mesh8, tmesh, axis):
    alt, den, bmag, bpsi = _batch_profiles(1)
    freqs = np.arange(2.0, 10.0, 0.5)
    args = (freqs, den[0], bmag[0], bpsi[0], alt)
    ref = prt.vertical_forward_operator(*args, mode="O", n_points=256,
                                        device="cpu")
    vh = TP.vh_height_sharded(*args, tmesh, axis=axis, mode="O",
                              n_points=256)
    jx = np.asarray(JP.vh_height_sharded(*args, mesh8, axis=axis, mode="O",
                                         n_points=256))
    assert vh.shape == (16,)
    _same_nan(vh, ref)
    _same_nan(vh, jx)
    m = np.isfinite(jx)
    assert m.sum() > 8
    assert_allclose(_np(vh)[m], _np(ref)[m], rtol=1e-10)
    assert_allclose(_np(vh)[m], jx[m], rtol=1e-10)


def _retrieval_scene():
    B = 8
    alt = np.linspace(90.0, 500.0, 80)
    bmag = np.full(80, 4e-5)
    bpsi = np.full(80, 50.0)
    E = {"Nm": 5e10, "hm": 110.0, "B_bot": 5.0, "B_top": 7.0}
    aux = {"alt": alt, "bmag": bmag, "bpsi": bpsi, "E": E, "B_top": 40.0}
    freq = np.arange(2.0, 8.0, 0.5)
    rng = np.random.default_rng(4)
    truth = {"hm": rng.uniform(280.0, 320.0, B),
             "bb": rng.uniform(45.0, 55.0, B),
             "nm": rng.uniform(1.8e12, 2.2e12, B)}
    obs = np.stack([_np(_vh_of(*(torch.tensor(truth[k][i])
                                 for k in ("hm", "bb", "nm")), freq, aux))
                    for i in range(B)])
    theta = {"hm": truth["hm"] + 10.0, "bb": truth["bb"] + 4.0,
             "nm": truth["nm"]}
    return theta, obs, freq, aux


def _vh_of(hm, bb, nm, freq, aux, masked=True):
    """One profile's vh through the port (NaN where escaped)."""
    from pyrayhf_tpu_torch import edp
    E, alt = aux["E"], torch.as_tensor(aux["alt"])
    NmF1, _, hmF1, _ = edp.derive_dependent_F1_parameters(0.8, nm, hm, bb,
                                                          E["hm"])
    EDP = edp.reconstruct_density_1level(
        {"Nm": nm, "hm": hm, "B_bot": bb, "B_top": aux["B_top"]},
        {"Nm": NmF1, "hm": hmF1}, E, alt)
    vh, valid = prt.vh_and_mask(freq, EDP, aux["bmag"], aux["bpsi"], alt,
                                mode_mult=1.0, n_points=64)
    return torch.where(valid, vh, torch.nan) if masked else (vh, valid)


def _unsharded_step(theta, obs, freq, aux, lr):
    """θ − lr·∇L_total, L_total summed profile by profile (autograd)."""
    th = {k: torch.as_tensor(v).clone().requires_grad_(True)
          for k, v in theta.items()}
    obs = torch.as_tensor(obs)
    loss = 0.0
    for i in range(obs.shape[0]):
        vh, valid = _vh_of(th["hm"][i], th["bb"][i], th["nm"][i], freq,
                           aux, masked=False)
        r = torch.where(valid & torch.isfinite(obs[i]), obs[i] - vh, 0.0)
        loss = loss + torch.sum(r * r)
    g = torch.autograd.grad(loss, [th["hm"], th["bb"], th["nm"]])
    return ({k: _np(th[k] - lr * gk) for k, gk in zip(("hm", "bb", "nm"), g)},
            float(loss.detach()))


@pytest.mark.parametrize("lr", [1e-9, 1.0])
def test_retrieval_step_sharded_matches(mesh8, tmesh, lr):
    theta, obs, freq, aux = _retrieval_scene()
    # called eagerly, as tests/test_parallel.py calls it: under an outer
    # jax.jit XLA fuses the singular backed-off sample of vh_and_mask
    # differently, and the loss moves by ~5e-7 relative
    aux_j = dict(aux, alt=jnp.asarray(aux["alt"]),
                 bmag=jnp.asarray(aux["bmag"]),
                 bpsi=jnp.asarray(aux["bpsi"]))
    tj, lj = JP.retrieval_step_sharded(
        {k: jnp.asarray(v) for k, v in theta.items()}, jnp.asarray(obs),
        jnp.asarray(freq), aux_j, mesh8, lr=lr)
    tt, lt = TP.retrieval_step_sharded(theta, obs, freq, aux, tmesh, lr=lr)
    tu, lu = _unsharded_step(theta, obs, freq, aux, lr)
    assert lt.shape == () and lt.device.type == "cpu"
    assert_allclose(float(lt), float(lj), rtol=1e-10)
    assert_allclose(float(lt), lu, rtol=1e-10)
    for k in ("hm", "bb", "nm"):
        assert tt[k].shape == (8,)
        assert_allclose(_np(tt[k]), np.asarray(tj[k]), rtol=1e-10)
        assert_allclose(_np(tt[k]), tu[k], rtol=1e-10)
    # the step moves hm and bb (the gradient is not lost in the mesh)
    assert np.all(_np(tt["hm"]) != theta["hm"])


def test_retrieval_step_sharded_descends(tmesh):
    theta, obs, freq, aux = _retrieval_scene()
    _, loss0 = TP.retrieval_step_sharded(theta, obs, freq, aux, tmesh,
                                         lr=0.0)
    theta1, _ = TP.retrieval_step_sharded(theta, obs, freq, aux, tmesh,
                                          lr=1e-9)
    _, loss1 = TP.retrieval_step_sharded(theta1, obs, freq, aux, tmesh,
                                         lr=0.0)
    assert float(loss1) < float(loss0)


def test_ionogram_mesh_validates_batch_axis():
    devices = [CPU] * 8
    with pytest.raises(ValueError, match="divisor"):
        TP.ionogram_mesh(devices, batch_axis=3)
    with pytest.raises(ValueError, match="divisor"):
        TP.ionogram_mesh(devices, batch_axis=0)
    mesh = TP.ionogram_mesh(devices, batch_axis=4)
    assert dict(mesh.shape) == {"batch": 4, "freq": 2}
    assert list(mesh.shape) == ["batch", "freq"]
    assert mesh.axis_names == ("batch", "freq")
    assert mesh.devices.shape == (4, 2)
    assert all(d == CPU for d in mesh.devices.ravel())
    assert dict(TP.ionogram_mesh(["cpu"] * 3).shape) == {"batch": 3,
                                                         "freq": 1}
    with pytest.raises(ValueError, match="non-empty"):
        TP.ionogram_mesh([])


def test_sharded_entry_points_validate(tmesh):
    alt, den, bmag, bpsi = _batch_profiles(8)
    freqs = np.arange(2.0, 10.0, 0.5)
    with pytest.raises(ValueError, match="engine must be 'xla' or 'pallas'"):
        TP.synthesize_ionograms_sharded(freqs, den, bmag, bpsi, alt, tmesh,
                                        engine="mxu")
    with pytest.raises(ValueError, match="Mode must be O or X"):
        TP.synthesize_ionograms_sharded(freqs, den, bmag, bpsi, alt, tmesh,
                                        mode="Z")
    with pytest.raises(ValueError, match="batch size .6. must be divisible"):
        TP.synthesize_ionograms_sharded(freqs, den[:6], bmag[:6], bpsi[:6],
                                        alt, tmesh)
    with pytest.raises(ValueError, match="frequency count .15. must be"):
        TP.synthesize_ionograms_sharded(freqs[:15], den, bmag, bpsi, alt,
                                        tmesh)
    with pytest.raises(ValueError, match="n_points must be divisible"):
        TP.vh_height_sharded(freqs, den[0], bmag[0], bpsi[0], alt, tmesh,
                             n_points=250)
    with pytest.raises(ValueError, match="must be divisible"):
        TP.doppler_batch_sharded(freqs, den[:6], den[:6], bmag[0], bpsi[0],
                                 alt, tmesh)


def test_sharded_pallas_engine_matches_xla(tmesh):
    """engine='pallas' (the sweep kernel per block; its plain version on
    CPU tensors) == 'xla'."""
    B, F, N = 8, 8, 96
    alt = np.linspace(90.0, 550.0, N)
    rng = np.random.default_rng(5)
    hms = rng.uniform(250.0, 330.0, B)
    den = 2e12 * np.exp(-(alt[None, :] - hms[:, None]) ** 2
                        / (2 * 55.0 ** 2))
    bmag = np.full((B, N), 3.2e-5)
    bpsi = np.full((B, N), 65.0)
    freqs = np.arange(2.0, 10.0, 1.0)
    xla = TP.synthesize_ionograms_sharded(freqs, den, bmag, bpsi, alt,
                                          tmesh, n_points=64, engine="xla")
    pal = TP.synthesize_ionograms_sharded(freqs, den, bmag, bpsi, alt,
                                          tmesh, n_points=64,
                                          engine="pallas", interpret=True)
    _same_nan(pal, xla)
    m = torch.isfinite(xla)
    assert m.any() and (pal[m] - xla[m]).abs().max() < 1e-9


def test_doppler_batch_sharded_matches(mesh8, tmesh):
    alt, den, bmag, bpsi = _batch_profiles(8)
    v = 0.02
    dden = np.stack([-v * np.gradient(d, alt) for d in den])
    freqs = np.arange(2.0, 10.0, 0.5)
    jx = JP.doppler_batch_sharded(freqs, den, dden, bmag, bpsi, alt, mesh8,
                                  mode="O", n_points=120)
    out = TP.doppler_batch_sharded(freqs, den, dden, bmag[0], bpsi[0], alt,
                                   tmesh, mode="O", n_points=120)
    fd = _np(out["doppler_hz"])
    assert fd.shape == (8, freqs.size)
    for k in ("doppler_hz", "phase_height_km"):
        ref = np.asarray(jx[k])
        _same_nan(out[k], ref)
        m = np.isfinite(ref)
        assert m.sum() > 60
        assert_allclose(_np(out[k])[m], ref[m], rtol=1e-10)
    # per profile, the port's own unsharded Doppler
    for i in (0, 3, 7):
        single = prt.doppler_shift_vertical(freqs, den[i], dden[i], bmag[i],
                                            bpsi[i], alt, n_points=120,
                                            device="cpu")["doppler_hz"]
        _same_nan(fd[i], single)
        m = np.isfinite(_np(single))
        assert_allclose(fd[i][m], _np(single)[m], rtol=1e-10)
    # uplift red-shifts every reflected frequency across the whole batch
    assert (fd[np.isfinite(fd)] < 0).all()
