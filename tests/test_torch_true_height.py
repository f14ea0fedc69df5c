"""PyTorch port vs the JAX package: the true-height lamination.

Scenes are those of ``tests/test_true_height.py`` (a Chapman layer, its
O and X ionograms from the JAX forward operator, and the E-valley scene),
fed to both packages in f64. Tolerances: knot heights 1e-9 km (both make
the same bisection decisions, so the knots agree to rounding); fitted
profiles 1e-10 of the peak (the steep peak wedge amplifies last-ulp knot
differences); fitted ionograms 1e-6 km (the forward
operator's bound, ``tests/test_torch_forward.py``).
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import pyrayhf_tpu as J
from pyrayhf_tpu.magnetoionic import freq2den

import pyrayhf_tpu_torch.true_height as TT

from _torch_threads import one_torch_thread  # noqa: F401

CPU = "cpu"
TOL_H = 1e-9
TOL_KM = 1e-6


@pytest.fixture(scope="module")
def chapman():
    alt = np.arange(80.0, 600.0, 0.5)
    nm = float(freq2den(9e6))
    z = (alt - 300.0) / 45.0
    den = nm * np.exp(0.5 * (1 - z - np.exp(-z)))
    bmag = np.full_like(alt, 4.5e-5)
    bpsi = np.full_like(alt, 35.0)
    freq = np.linspace(2.0, 8.8, 16)
    vh_o = np.asarray(J.vertical_forward_operator(freq, den, bmag, bpsi, alt,
                                                  mode="O"))
    f_x = freq + 0.63
    vh_x = np.asarray(J.vertical_forward_operator(f_x, den, bmag, bpsi, alt,
                                                  mode="X"))
    assert np.isfinite(vh_o).all() and np.isfinite(vh_x).all()
    return alt, den, bmag, bpsi, freq, vh_o, f_x, vh_x


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_same(got, ref, nm, tol_vh=TOL_KM):
    """Knots, fitted profile, fitted ionogram and rms as the JAX dict."""
    assert_allclose(_np(got["h_knots_km"]), _np(ref["h_knots_km"]),
                    rtol=0, atol=TOL_H)
    assert_allclose(_np(got["ne_knots_m3"]), _np(ref["ne_knots_m3"]),
                    rtol=1e-12)
    assert_allclose(_np(got["den_fit"]), _np(ref["den_fit"]), rtol=0,
                    atol=1e-10 * nm)
    vh_g, vh_r = _np(got["vh_fit"]), _np(ref["vh_fit"])
    assert np.array_equal(np.isnan(vh_g), np.isnan(vh_r))
    m = np.isfinite(vh_r)
    assert_allclose(vh_g[m], vh_r[m], rtol=0, atol=tol_vh)
    assert_allclose(_np(got["rms_km"]), _np(ref["rms_km"]), rtol=0,
                    atol=tol_vh)
    assert_allclose(_np(got["f_sorted_hz"]), _np(ref["f_sorted_hz"]),
                    rtol=1e-15)


@pytest.mark.parametrize("mode", ["O", "X"])
def test_retrieve_profile_matches_jax(chapman, mode):
    """Single-mode lamination of the Chapman ionogram, plus the JAX
    test's recovery bounds (tests/test_true_height.py:39-63)."""
    alt, den, bmag, bpsi, freq, vh_o, f_x, vh_x = chapman
    f, vh = (freq, vh_o) if mode == "O" else (f_x, vh_x)
    ref = J.retrieve_profile(f, vh, alt, bmag, bpsi, mode=mode)
    got = TT.retrieve_profile(f, vh, alt, bmag, bpsi, mode=mode, device=CPU)
    _assert_same(got, ref, den.max())
    assert float(got["rms_km"]) < 0.2
    h, ne = got["h_knots_km"].numpy(), got["ne_knots_m3"].numpy()
    assert np.all(np.diff(h) > 0) and np.all(np.diff(ne) > 0)
    below = alt <= 300.0
    err = h - np.interp(ne, den[below], alt[below])
    assert abs(err[-1]) < (1.0 if mode == "O" else 5.0)
    assert np.max(np.abs(err)) < 25.0


def test_gap_candidates_batch_and_nan_samples_match_jax(chapman):
    """A start-gap candidate array (one batch, smallest rms wins), the
    batch entry point ([B, K] traces, each row as its single fit) and a
    trace with NaN samples (dropped) — each as in the JAX package."""
    alt, den, bmag, bpsi, freq, vh_o, _, _ = chapman
    gaps = np.array([5.0, 20.0, 50.0])
    ref = J.retrieve_profile(freq, vh_o, alt, bmag, bpsi,
                             start_gap_km=gaps)
    got = TT.retrieve_profile(freq, vh_o, alt, bmag, bpsi,
                              start_gap_km=gaps, device=CPU)
    _assert_same(got, ref, den.max())
    assert got["start_gap_km"] == ref["start_gap_km"]
    assert_allclose(got["rms_by_gap_km"], ref["rms_by_gap_km"], rtol=0,
                    atol=TOL_KM)

    batch = np.stack([vh_o, vh_o + 1.0])
    refb = J.retrieve_profile_batch(freq, batch, alt, bmag, bpsi)
    gotb = TT.retrieve_profile_batch(freq, batch, alt, bmag, bpsi,
                                     device=CPU)
    _assert_same(gotb, refb, den.max())
    one = TT.retrieve_profile(freq, vh_o + 1.0, alt, bmag, bpsi, device=CPU)
    assert_allclose(gotb["h_knots_km"][1].numpy(),
                    one["h_knots_km"].numpy(), rtol=0, atol=TOL_H)

    f_aug = np.concatenate([freq, [9.7, 10.4]])
    vh_aug = np.concatenate([vh_o, [np.nan, np.nan]])
    got_nan = TT.retrieve_profile(f_aug, vh_aug, alt, bmag, bpsi,
                                  device=CPU)
    single = TT.retrieve_profile(freq, vh_o, alt, bmag, bpsi, device=CPU)
    assert got_nan["h_knots_km"].shape == (freq.size,)
    assert_allclose(got_nan["h_knots_km"].numpy(),
                    single["h_knots_km"].numpy(), rtol=0, atol=TOL_H)


def test_joint_matches_jax(chapman):
    """Joint O+X lamination over start-gap candidates: the same knots,
    the same chosen gap and candidate rms as the JAX package; with one
    trace empty it reproduces the single-mode lamination exactly."""
    alt, den, bmag, bpsi, freq, vh_o, f_x, vh_x = chapman
    gaps = np.array([5.0, 15.0, 25.0, 50.0])
    ref = J.retrieve_profile_joint(freq, vh_o, f_x, vh_x, alt, bmag, bpsi,
                                   start_gap_km=gaps)
    got = TT.retrieve_profile_joint(freq, vh_o, f_x, vh_x, alt, bmag, bpsi,
                                    start_gap_km=gaps, device=CPU)
    _assert_same(got, ref, den.max())
    np.testing.assert_array_equal(got["mode_knots"],
                                  np.asarray(ref["mode_knots"]))
    assert got["start_gap_km"] == ref["start_gap_km"]
    assert_allclose(got["rms_by_gap_km"], ref["rms_by_gap_km"], rtol=0,
                    atol=TOL_KM)

    out_jx = TT.retrieve_profile_joint([], [], f_x, vh_x, alt, bmag, bpsi,
                                       device=CPU)
    out_x = TT.retrieve_profile(f_x, vh_x, alt, bmag, bpsi, mode="X",
                                device=CPU)
    assert torch.equal(out_jx["h_knots_km"], out_x["h_knots_km"])


@pytest.fixture(scope="module")
def valley_scene():
    """tests/test_true_height.py:238-259: E layer, triangular valley,
    F layer and their exact O/X ionograms."""
    alt = np.linspace(90.0, 400.0, 311)
    ne_E = float(freq2den(3.0e6))
    ne = np.interp(alt, [90, 110, 125, 140, 250, 400],
                   [ne_E * 1e-3, ne_E, ne_E * 0.92, ne_E,
                    float(freq2den(8.0e6)), float(freq2den(8.0e6)) * 0.3])
    bmag = np.full_like(alt, 4.5e-5)
    bpsi = np.full_like(alt, np.deg2rad(35.0))
    f_o = np.array([2.0, 2.3, 2.6, 2.9, 3.3, 3.6, 4.0, 4.6, 5.4, 6.4])
    f_x = np.array([2.2, 2.5, 2.8, 3.1, 3.9, 4.3, 4.9, 5.8, 6.8])
    vh_o = np.asarray(J.vertical_forward_operator(f_o, ne, bmag, bpsi, alt,
                                                  mode="O"))
    vh_x = np.asarray(J.vertical_forward_operator(f_x, ne, bmag, bpsi, alt,
                                                  mode="X"))
    return alt, ne, bmag, bpsi, ne_E, f_o, vh_o, f_x, vh_x


def test_joint_valley_matches_jax(valley_scene):
    """The E-valley insert over a (width × depth) candidate grid: the same
    winning candidate, knots and candidate rms as the JAX package, and a
    clear win over the no-valley candidate (tests/test_true_height.py:
    262-303)."""
    alt, ne, bmag, bpsi, ne_E, f_o, vh_o, f_x, vh_x = valley_scene
    kw = dict(alt=alt, b_mag=bmag, b_psi=bpsi, n_bisect=30, n_passes=3,
              start_gap_km=20.0, valley_f_mhz=3.0,
              valley_width_km=np.array([0.0, 15.0, 30.0, 45.0]),
              valley_depth=np.array([0.0, 0.04, 0.08, 0.12]))
    ref = J.retrieve_profile_joint(f_o, vh_o, f_x, vh_x, **kw)
    got = TT.retrieve_profile_joint(f_o, vh_o, f_x, vh_x, device=CPU, **kw)
    _assert_same(got, ref, ne.max())
    for k in ("valley_width_km", "valley_depth", "start_gap_km"):
        assert got[k] == ref[k], k
    np.testing.assert_array_equal(got["candidates"], ref["candidates"])
    assert_allclose(got["rms_by_candidate_km"], ref["rms_by_candidate_km"],
                    rtol=0, atol=TOL_KM)
    cand, rms = got["candidates"], got["rms_by_candidate_km"]
    no_valley = rms[(cand[:, 1] == 0.0) & (cand[:, 2] == 0.0)].min()
    assert got["valley_width_km"] > 0 and got["valley_depth"] > 0
    assert float(got["rms_km"]) < 0.8 * no_valley


def test_input_guards(chapman, valley_scene):
    alt, den, bmag, bpsi, freq, vh_o, _, _ = chapman
    with pytest.raises(ValueError, match="at least 2"):
        TT.retrieve_profile([5.0], [250.0], alt, bmag, bpsi, device=CPU)
    with pytest.raises(ValueError, match="at least 2"):
        TT.retrieve_profile_batch([5.0], [[250.0]], alt, bmag, bpsi,
                                  device=CPU)
    with pytest.raises(ValueError, match="at least 2"):
        TT.retrieve_profile_joint([5.0], [250.0], [], [], alt, bmag, bpsi,
                                  device=CPU)
    with pytest.raises(ValueError, match="n_passes"):
        TT.retrieve_profile([3.0, 5.0], [150.0, 250.0], alt, bmag, bpsi,
                            n_passes=0, device=CPU)
    with pytest.raises(ValueError, match="all-finite"):
        TT.retrieve_profile_batch([3.0, 5.0], [[150.0, np.nan]], alt, bmag,
                                  bpsi, device=CPU)
    with pytest.raises(ValueError, match="gyrofrequency"):
        TT.retrieve_profile([1.0, 5.0], [120.0, 250.0], alt, bmag, bpsi,
                            mode="X", device=CPU)
    with pytest.raises(ValueError, match="gyrofrequency"):
        TT.retrieve_profile_joint([3.0, 5.0], [150.0, 250.0], [1.0, 4.0],
                                  [150.0, 260.0], alt, bmag, bpsi,
                                  device=CPU)
    v_alt, _, v_bm, v_bp, _, f_o, vh_o2, f_x, vh_x = valley_scene
    kw = dict(alt=v_alt, b_mag=v_bm, b_psi=v_bp, n_bisect=4, n_passes=1,
              device=CPU)
    with pytest.raises(ValueError, match="between the lowest"):
        TT.retrieve_profile_joint(f_o, vh_o2, f_x, vh_x, valley_f_mhz=1.0,
                                  **kw)
    with pytest.raises(ValueError, match="finite margin"):
        TT.retrieve_profile_joint(f_o, vh_o2, f_x, vh_x, valley_f_mhz=2.9,
                                  **kw)


def test_saturated_trace_stays_sorted(chapman):
    """An unreachable spike near foF2 saturates knots at the ceiling; the
    assembly stays sorted and the lower trace still fits (as the JAX
    package)."""
    alt, den, bmag, bpsi, freq, vh_o, _, _ = chapman
    vh_bad = vh_o.copy()
    vh_bad[-3:] = 2000.0
    got = TT.retrieve_profile(freq, vh_bad, alt, bmag, bpsi, device=CPU)
    ref = J.retrieve_profile(freq, vh_bad, alt, bmag, bpsi)
    # the stacked knots 1e-2 km apart below the ceiling make μ' near their
    # reflection ~1e2 times more sensitive: vh_fit within 1e-4 km there
    _assert_same(got, ref, den.max(), tol_vh=1e-4)
    assert np.all(np.diff(got["h_knots_km"].numpy()) > 0)
    assert torch.isfinite(got["den_fit"]).all()


def test_f32_caps_the_bisection(chapman, monkeypatch):
    """The bisection cap follows the working dtype of the inputs (the JAX
    package reads its global x64 flag): float32 tensors get 24 steps per
    knot, float64 the 36 asked for; the f32 result stays f32 and within
    0.1 km of the f64 knots."""
    alt, den, bmag, bpsi, freq, vh_o, _, _ = chapman
    assert TT._check_inputs(freq, bmag, 1.0, 1, 36, torch.float32) == 24
    assert TT._check_inputs(freq, bmag, 1.0, 1, 36, torch.float64) == 36
    calls = []
    real = TT.vh_and_mask
    monkeypatch.setattr(TT, "vh_and_mask",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    sel = slice(0, 16, 5)                            # 4 knots
    out = {}
    for dt in (torch.float32, torch.float64):
        calls.clear()
        args = [torch.as_tensor(a[sel] if a.ndim and a.size == 16 else a,
                                dtype=dt)
                for a in (freq, vh_o, alt, bmag, bpsi)]
        out[dt] = TT.retrieve_profile(*args, n_passes=1, n_bisect=36)
        assert len(calls) == 4 * (24 if dt == torch.float32 else 36) + 1
    assert out[torch.float32]["h_knots_km"].dtype == torch.float32
    assert_allclose(out[torch.float32]["h_knots_km"].double().numpy(),
                    out[torch.float64]["h_knots_km"].numpy(), atol=0.1)
