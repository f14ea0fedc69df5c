"""PyTorch port vs the JAX package: the vertical forward operator.

Inputs are made with numpy from a seed (the ``_workload`` of
``tests/test_pallas.py``) and fed to both packages in f64. Tolerance:
identical NaN masks and max |Δvh| ≤ 1e-6 km — the JAX package's own
fast-vs-parity bound (``tests/test_pallas.py:36``).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from numpy.testing import assert_allclose

import pyrayhf_tpu.forward as JF
import pyrayhf_tpu.pallas_vh as JV
import pyrayhf_tpu_torch.forward as TF
import pyrayhf_tpu_torch.pallas_vh as TV
from pyrayhf_tpu.config import OperatorConfig as JaxOperatorConfig
from pyrayhf_tpu_torch.config import OperatorConfig

from _torch_threads import one_torch_thread  # noqa: F401

TOL_KM = 1e-6


def _workload(B=4, n_alt=180):
    alt = np.linspace(90.0, 550.0, n_alt)
    rng = np.random.default_rng(3)
    hms = rng.uniform(250.0, 330.0, B)
    peaks = rng.uniform(1e12, 3e12, B)
    den = peaks[:, None] * np.exp(-(alt[None, :] - hms[:, None]) ** 2
                                  / (2 * 55.0 ** 2))
    bmag = np.full((B, n_alt), 3.2e-5)
    bpsi = np.full((B, n_alt), 65.0)
    freqs = np.arange(1.0, 16.0, 0.5)
    return freqs, den, bmag, bpsi, alt


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float64))


def _assert_vh(port, ref, tol=TOL_KM):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else port
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    assert np.array_equal(np.isnan(port), np.isnan(ref))
    m = np.isfinite(ref)
    assert m.any()
    assert np.abs(port[m] - ref[m]).max() <= tol


@pytest.mark.parametrize("mode,arithmetic", [("O", "stable"),
                                             ("O", "reference"),
                                             ("X", "stable")])
def test_vertical_forward_operator_matches_jax(mode, arithmetic):
    freqs, den, bmag, bpsi, alt = _workload(B=1)
    args = (freqs, den[0], bmag[0], bpsi[0], alt)
    ref = JF.vertical_forward_operator(*args, mode=mode, n_points=200,
                                       arithmetic=arithmetic)
    port = TF.vertical_forward_operator(*map(_t, args), mode=mode,
                                        n_points=200, arithmetic=arithmetic)
    _assert_vh(port, ref)


@pytest.mark.parametrize("mode", ["O", "X"])
def test_batch_parity_engine_matches_jax(mode):
    args = _workload()
    ref = JF.vertical_forward_operator_batch(*args, mode=mode, n_points=200,
                                             engine="parity")
    port = TF.vertical_forward_operator_batch(*map(_t, args), mode=mode,
                                              n_points=200, engine="parity")
    _assert_vh(port, ref)


@pytest.mark.parametrize("mode", ["O", "X"])
def test_batch_xla_engine_matches_jax(mode):
    args = _workload()
    ref = JF.vertical_forward_operator_batch(*args, mode=mode, n_points=200,
                                             engine="xla")
    port = TF.vertical_forward_operator_batch(*map(_t, args), mode=mode,
                                              n_points=200, engine="xla")
    _assert_vh(port, ref)


def test_per_profile_grids_match_jax():
    freqs, den, bmag, bpsi, alt = _workload(B=3)
    alt_b = np.stack([alt, alt + 3.0, alt * 1.01])
    ref = JF.vertical_forward_operator_batch(freqs, den, bmag, bpsi, alt_b,
                                             mode="X", n_points=100)
    port = TF.vertical_forward_operator_batch(*map(_t, (freqs, den, bmag,
                                                        bpsi, alt_b)),
                                              mode="X", n_points=100)
    _assert_vh(port, ref)


def test_unmagnetised_profile_matches_jax():
    """B == 0 exercises the isotropic fallbacks of both the parity path
    and the sweep's per-element tile."""
    freqs, den, _, _, alt = _workload(B=2)
    zero = np.zeros_like(den)
    for engine in ("parity", "xla"):
        ref = JF.vertical_forward_operator_batch(freqs, den, zero, zero, alt,
                                                 mode="O", engine=engine)
        port = TF.vertical_forward_operator_batch(
            *map(_t, (freqs, den, zero, zero, alt)), mode="O", engine=engine)
        _assert_vh(port, ref)


@pytest.mark.parametrize("mode_mult", [1.0, -1.0])
def test_vh_and_mask_matches_jax(mode_mult):
    freqs, den, bmag, bpsi, alt = _workload(B=1)
    args = (freqs, den[0], bmag[0], bpsi[0], alt)
    vh_j, ok_j = JF.vh_and_mask(*map(jnp.asarray, args), mode_mult=mode_mult,
                                n_points=200)
    vh_t, ok_t = TF.vh_and_mask(*map(_t, args), mode_mult=mode_mult,
                                n_points=200)
    assert np.array_equal(ok_t.numpy(), np.asarray(ok_j))
    assert np.abs(vh_t.numpy() - np.asarray(vh_j)).max() <= TOL_KM


def test_vh_and_mask_gradient_matches_jax():
    """d Σ where(valid, vh, 0) / d den equals jax.grad (rtol 1e-7, atol
    1e-9·max: the backward passes sum in another order near reflection)."""
    freqs, den, bmag, bpsi, alt = _workload(B=1)
    fixed = (bmag[0], bpsi[0], alt)

    def loss_j(d):
        vh, ok = JF.vh_and_mask(jnp.asarray(freqs), d,
                                *map(jnp.asarray, fixed), mode_mult=1.0)
        return jnp.sum(jnp.where(ok, vh, 0.0))

    g_j = np.asarray(jax.grad(loss_j)(jnp.asarray(den[0])))
    d = _t(den[0]).requires_grad_(True)
    vh, ok = TF.vh_and_mask(_t(freqs), d, *map(_t, fixed), mode_mult=1.0)
    g_t = torch.autograd.grad(torch.where(ok, vh, 0.0).sum(), d)[0].numpy()
    assert np.isfinite(g_t).all()
    assert_allclose(g_t, g_j, rtol=1e-7, atol=1e-9 * np.abs(g_j).max())


@pytest.mark.parametrize("mode", ["O", "X"])
def test_vertical_phase_operator_matches_jax(mode):
    freqs, den, bmag, bpsi, alt = _workload(B=1)
    args = (freqs, den[0], bmag[0], bpsi[0], alt)
    ref = JF.vertical_phase_operator(*args, mode=mode, n_points=200)
    port = TF.vertical_phase_operator(*map(_t, args), mode=mode,
                                      n_points=200)
    _assert_vh(port, ref)


def test_auto_engine_on_cpu_takes_parity():
    args = [_t(a) for a in _workload(B=2)]
    TV.reset_counters()
    auto = TF.vertical_forward_operator_batch(*args, mode="X")
    assert TV.PLAIN_CALLS == dict.fromkeys(TV.KERNELS, 0)
    assert TV.LAUNCHES == dict.fromkeys(TV.KERNELS, 0)
    parity = TF.vertical_forward_operator_batch(*args, mode="X",
                                                engine="parity")
    assert torch.equal(torch.nan_to_num(auto), torch.nan_to_num(parity))


def test_kernel_engines_on_cpu_run_plain_versions():
    """On CPU tensors 'pallas_gather'/'pallas' run their plain versions
    (never a kernel) and agree with JAX parity."""
    args = _workload(B=2)
    for mode in ("O", "X"):
        ref = JF.vertical_forward_operator_batch(*args, mode=mode,
                                                 engine="parity")
        for engine in ("pallas_gather", "pallas"):
            TV.reset_counters()
            port = TF.vertical_forward_operator_batch(*map(_t, args),
                                                      mode=mode,
                                                      engine=engine)
            _assert_vh(port, ref)
            assert sum(TV.PLAIN_CALLS.values()) == 1
            assert sum(TV.LAUNCHES.values()) == 0


def test_route_names_each_engines_kernel():
    """The router on converted CPU tensors: ``auto`` takes parity (None)
    without reading the grid; each kernel engine gets its kernel, and the
    uniform-grid ones 1/Δalt (from the one read) or their error."""
    freqs, den, bmag, bpsi, alt = map(_t, _workload(B=2))
    inv = 1.0 / float(alt[1] - alt[0])

    def kind(engine, mode_mult, **kw):
        cfg = TV.route(engine, freqs, den, alt, mode_mult, 200, **kw)
        assert cfg["mode_mult"] == mode_mult and cfg["n_points"] == 200
        return cfg["kind"], cfg["inv_dalt"]

    assert TV.route("auto", freqs, den, alt, 1.0, 200) is None
    assert TV.route("auto", freqs, den, alt.expand(2, -1), 1.0,
                    200) is None
    assert kind("pallas", 1.0) == ("sweep", None)
    assert kind("pallas_gather", 1.0)[0] == "gather_osolve"
    assert kind("pallas_gather", -1.0)[0] == "gather_xsolve"
    assert kind("pallas_gather", -1.0, x_in_kernel_solve=False) == (
        "gather", pytest.approx(inv, rel=1e-12))
    assert kind("pallas_mxu", -1.0)[0] == "mxu"
    assert set(TV.KINDS) == set(TV.KERNELS) - {"segment_table"}
    alt_nu = alt + 0.01 * torch.linspace(0.0, 5.0, alt.shape[0]) ** 2
    for engine in ("pallas_gather", "pallas_mxu"):
        with pytest.raises(ValueError, match=f"ionogram_{engine} requires"):
            TV.route(engine, freqs, den, alt_nu, 1.0, 200)


def test_engine_errors():
    args = [_t(a) for a in _workload(B=2)]
    alt_nu = args[4] + 0.01 * torch.linspace(0.0, 5.0, args[4].shape[0]) ** 2
    with pytest.raises(ValueError, match="uniform"):
        TF.vertical_forward_operator_batch(*args[:4], alt_nu,
                                           engine="pallas_mxu")
    alt_b = args[4].expand(2, -1)
    with pytest.raises(ValueError, match="shared 1-D altitude grid"):
        TF.vertical_forward_operator_batch(*args[:4], alt_b,
                                           engine="pallas")
    with pytest.raises(ValueError, match="engine must be"):
        TF.vertical_forward_operator_batch(*args, engine="fast")


def test_config_resolution_matches_jax():
    """A config supplies mode/n_points; explicit kwargs win, as in JAX."""
    freqs, den, bmag, bpsi, alt = _workload(B=2)
    targs = [_t(a) for a in (freqs, den, bmag, bpsi, alt)]
    ref = JF.vertical_forward_operator_batch(
        freqs, den, bmag, bpsi, alt,
        config=JaxOperatorConfig(mode="X", n_points=120), engine="parity")
    port = TF.vertical_forward_operator_batch(
        *targs, config=OperatorConfig(mode="X", n_points=120))
    _assert_vh(port, ref)
    explicit = TF.vertical_forward_operator_batch(
        *targs, mode="O", config=OperatorConfig(mode="X", n_points=120))
    assert not torch.equal(torch.nan_to_num(explicit),
                           torch.nan_to_num(port))


def test_dtype_preserved_f32():
    args = [torch.from_numpy(np.asarray(a, dtype=np.float32))
            for a in _workload(B=2)]
    out = TF.vertical_forward_operator_batch(*args, mode="O")
    assert out.dtype == torch.float32 and out.shape == (2, 30)
