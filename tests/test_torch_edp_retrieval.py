"""PyTorch port vs the JAX package: the EDP model and the retrievals.

The reference Day/Night pickles are not in the repo, so the scenes are
made here: the golden layer parameters of ``tests/test_edp_retrieval.py``
with seeded perturbations, on a uniform 620-node grid from 80 to 699 km,
fed to both packages in f64. Tolerances: builders and EDPs rtol 1e-12
(the same expressions; transcendental functions may differ by an ulp);
virtual heights and residuals 1e-6 km (the forward operator's bound,
``tests/test_torch_forward.py``: the singular backed-off sample amplifies
last-ulp differences);
the forward-mode JVP rtol 1e-9; LM fits and cost histories rtol 1e-8 (the
same accept/reject decisions; the normal equations sum in another order);
brute fits exactly (the same grid point); Powell's cost at rtol 1e-8.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from numpy.testing import assert_allclose

import pyrayhf_tpu.edp as JE
import pyrayhf_tpu.io as JIO
import pyrayhf_tpu.pallas_vh as JV
import pyrayhf_tpu.retrieval as JR
from pyrayhf_tpu.interp import interp_exact as j_interp_exact

import pyrayhf_tpu_torch.edp as TE
import pyrayhf_tpu_torch.io as TIO
import pyrayhf_tpu_torch.pallas_vh as TV
import pyrayhf_tpu_torch.retrieval as TR
from pyrayhf_tpu_torch.config import RetrievalConfig
from pyrayhf_tpu_torch.interp import interp_exact

from _torch_threads import one_torch_thread  # noqa: F401

CPU = "cpu"
GOLDEN_F2 = {"Nm": np.array([[1.17848165e+12]]),
             "fo": np.array([[9.64625394]]),
             "M3000": np.array([[2.64168819]]),
             "hm": np.array([[365.13828931]]),
             "B_top": np.array([[32.52487907]]),
             "B_bot": np.array([[41.26005561]])}
GOLDEN_F1 = {"Nm": np.array([[7.80902301e+11]]),
             "fo": np.array([[7.93574143]]),
             "P": np.array([[0.91422852]]),
             "hm": np.array([[219.26637887]]),
             "B_bot": np.array([[54.63318944]])}
GOLDEN_E = {"Nm": np.array([[1.2846662e+11]]),
            "fo": np.array([[3.2096443]]),
            "hm": np.array([[110.]]),
            "B_bot": np.array([[5.]]),
            "B_top": np.array([[7.]])}

ALT = np.linspace(80.0, 699.0, 620)
FREQ = np.arange(2.0, 13.51, 1.0)
BMAG = np.full(ALT.size, 3e-5)
BPSI = np.full(ALT.size, 70.0)
# freq2den(13 MHz) × 1.001: the top frequency reflects despite the 1-km
# grid's peak truncation (≤ 1e-3 of the peak), and the NmF2 pin from it
# (× 1.0001, ref :760-768) is within 0.1% of the truth
NM_TRUTH = float((13.0e6 / 8.97866275) ** 2) * 1.001
N_POINTS = 100
RTOL_FIT = 1e-8
TOL_KM = 1e-6


def _scalars(d):
    return {k: float(np.ravel(v)[0]) for k, v in d.items()}


F1 = _scalars(GOLDEN_F1)
E = _scalars(GOLDEN_E)


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float64))


def _truths(seed, B):
    rng = np.random.default_rng(seed)
    return rng.uniform(330.0, 380.0, B), rng.uniform(38.0, 48.0, B)


def _observations(hms, bbs, bmag=BMAG, bpsi=BPSI, mode="O", nm=NM_TRUTH):
    """[B, F] ionograms of the truths (JAX model_VH, f64)."""
    bmag = np.broadcast_to(bmag, (hms.size, ALT.size))
    bpsi = np.broadcast_to(bpsi, (hms.size, ALT.size))
    return np.stack([np.asarray(JR.model_VH(
        {"Nm": nm, "hm": hms[b], "B_bot": bbs[b], "B_top": 40.0}, F1, E,
        FREQ, ALT, bmag[b], bpsi[b], mode=mode, n_points=N_POINTS)[0])
        for b in range(hms.size)])


# ---- edp -------------------------------------------------------------------

def test_edp_layer_builders_match_jax():
    h = np.linspace(60.0, 900.0, 400)
    cases = [
        (JE.epstein_layer, TE.epstein_layer, (1.2e12, 300.0, 40.0, h)),
        (JE.f2_topside, TE.f2_topside, (1.2e12, 300.0, 33.0, h)),
        (JE.f2_bottom_thickness, TE.f2_bottom_thickness,
         (1.2e12, 300.0, 41.0, h)),
        (JE.f2_bottom_b0b1, TE.f2_bottom_b0b1, (1.2e12, 300.0, 90.0, 2.5,
                                                h)),
        (JE.valley_transition, TE.valley_transition, (h, 110.0, 300.0)),
    ]
    for jf, tf, args in cases:
        ref = np.asarray(jf(*args))
        got = tf(*args, device=CPU).numpy()
        assert_allclose(got, ref, rtol=1e-12, atol=1e-300, err_msg=jf.__name__)
    ref = JE.derive_dependent_F1_parameters(0.9, 1.2e12, 350.0, 40.0, 110.0)
    got = TE.derive_dependent_F1_parameters(0.9, 1.2e12, 350.0, 40.0, 110.0,
                                            device=CPU)
    for r, g in zip(ref, got):
        assert_allclose(g.numpy(), np.asarray(r), rtol=1e-12)


@pytest.mark.parametrize("builder", ["1level", "continuous"])
def test_reconstruct_density_matches_jax(builder):
    """Both builders, one profile and a [B, 1] batch of parameters."""
    F2 = _scalars(GOLDEN_F2)
    F2.update(B0=95.0, B1=2.4)
    NmF1, _, hmF1, _ = JE.derive_dependent_F1_parameters(
        F1["P"], F2["Nm"], F2["hm"], F2["B_bot"], E["hm"])
    if builder == "1level":
        jf, tf = JE.reconstruct_density_1level, TE.reconstruct_density_1level
        f1 = {"Nm": float(NmF1), "hm": float(hmF1)}
    else:
        jf = JE.reconstruct_density_continuous
        tf = TE.reconstruct_density_continuous
        f1 = {"P": F1["P"], "hm": float(hmF1)}
    ref = np.asarray(jf(F2, f1, E, ALT))
    assert_allclose(tf(F2, f1, E, ALT, device=CPU).numpy(), ref, rtol=1e-12)
    hms = np.array([[320.0], [365.0], [400.0]])
    F2b = dict(F2, hm=_t(hms))
    refb = np.stack([np.asarray(jf(dict(F2, hm=float(v)), f1, E, ALT))
                     for v in hms[:, 0]])
    assert_allclose(tf(F2b, f1, E, _t(ALT)).numpy(), refb, rtol=1e-12)


def test_edp_f32_stays_finite_where_the_naive_forms_overflow():
    """The sech²/tanh forms keep f32 profiles and their tangents finite
    far from the peak (|x| ~ 80), where cosh² and the exp logistic
    overflow in f32."""
    h = torch.linspace(60.0, 2000.0, 300, dtype=torch.float32)
    hm = torch.tensor(300.0, dtype=torch.float32)
    for fn, args in ((TE.epstein_layer, (1.2e12, hm, 5.0, h)),
                     (TE.valley_transition, (h, 110.0, hm))):
        out, tan = torch.func.jvp(
            lambda m: fn(*[m if a is hm else a for a in args]), (hm,),
            (torch.ones_like(hm),))
        assert out.dtype == torch.float32
        assert torch.isfinite(out).all() and torch.isfinite(tan).all()
    naive = 1.2e12 * 4 * torch.exp(h - hm) / (1 + torch.exp(h - hm)) ** 2
    assert not torch.isfinite(naive).all()


def test_interp_exact_matches_jax():
    xp = np.array([0.0, 1.0, 2.0, 4.0])
    fp = np.array([1.0, np.nan, 3.0, 5.0])
    x = np.array([-1.0, 0.0, 0.5, 1.0, 2.0, 3.0, 4.0, 9.0, np.nan])
    ref = np.asarray(j_interp_exact(x, jnp.asarray(xp), jnp.asarray(fp)))
    got = interp_exact(x, xp, fp, device=CPU).numpy()
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    m = np.isfinite(ref)
    assert_allclose(got[m], ref[m], rtol=0, atol=0)


# ---- model_VH / residual_VH --------------------------------------------------

def test_derive_dependent_f1_golden():
    """Exact on the reference golden point (test_core.py:239-276 inputs)."""
    NmF1, foF1, hmF1, BF1 = TE.derive_dependent_F1_parameters(
        0.91422852, 1.17848165e+12, 365.13828931, 41.26005561, 110.0,
        device=CPU)
    assert_allclose(float(NmF1), 7.80902301e+11, rtol=1e-8)
    assert_allclose(float(foF1), 7.93574143, rtol=1e-7)
    assert_allclose(float(hmF1), 219.26637887, rtol=1e-8)
    assert_allclose(float(BF1), 54.63318944, rtol=1e-8)


@pytest.mark.parametrize("arithmetic", ["reference", "stable"])
def test_model_vh_golden(arithmetic):
    """The reference model_VH golden (rtol 1e-6 with the bit-parity μ',
    1e-5 stable; tests/test_edp_retrieval.py:91-115), and the JAX package's
    values (vh within 1e-6 km, EDP rtol 1e-12)."""
    freq = np.array([3.0, 3.5, 3.7])
    alt = np.array([100.0, 200.0, 300.0])
    args = (GOLDEN_F2, GOLDEN_F1, GOLDEN_E, freq, alt, np.full(3, 5e-5),
            np.full(3, 60.0))
    vh, edp = TR.model_VH(*args, arithmetic=arithmetic, device=CPU)
    assert_allclose(vh.numpy(), [236.22215658, 304.53151596, 334.34853791],
                    rtol=1e-6 if arithmetic == "reference" else 1e-5)
    assert_allclose(edp.numpy(), [5.39526842e+10, 1.77861786e+11,
                                  6.66833260e+11], rtol=1e-6)
    vh_j, edp_j = JR.model_VH(*args, arithmetic=arithmetic)
    assert_allclose(vh.numpy(), np.asarray(vh_j), rtol=0, atol=TOL_KM)
    assert_allclose(edp.numpy(), np.asarray(edp_j), rtol=1e-12)


@pytest.mark.parametrize("bottom_type", ["B_bot", "B0_B1"])
def test_model_vh_on_the_grid_matches_jax(bottom_type):
    F2 = dict(_scalars(GOLDEN_F2), B0=95.0, B1=2.4)
    for mode in ("O", "X"):
        ref = JR.model_VH(F2, F1, E, FREQ, ALT, BMAG, BPSI, mode=mode,
                          n_points=N_POINTS, bottom_type=bottom_type)
        got = TR.model_VH(F2, F1, E, FREQ, ALT, BMAG, BPSI, mode=mode,
                          n_points=N_POINTS, bottom_type=bottom_type,
                          device=CPU)
        assert np.array_equal(np.isnan(got[0].numpy()),
                              np.isnan(np.asarray(ref[0])))
        m = np.isfinite(np.asarray(ref[0]))
        assert_allclose(got[0].numpy()[m], np.asarray(ref[0])[m], rtol=0,
                        atol=TOL_KM)
        assert_allclose(got[1].numpy(), np.asarray(ref[1]), rtol=1e-12)


def test_residual_vh_matches_jax_with_nan_fill():
    """Zero at the truth; escaped rays (20 MHz) filled with
    max(nanmean|vh|, 100) as in the reference (ref :660-665)."""
    freq = np.array([3.0, 3.5, 3.7, 20.0])
    alt = np.array([100.0, 200.0, 300.0])
    bmag, bpsi = np.full(3, 5e-5), np.full(3, 60.0)
    params = {"NmF2": 1.17848165e+12, "hmF2": 365.13828931,
              "B_bot": 41.26005561}
    vh_obs = np.array(JR.model_VH(GOLDEN_F2, GOLDEN_F1, GOLDEN_E, freq, alt,
                                  bmag, bpsi)[0])
    vh_obs[-1] = 400.0
    args = (params, GOLDEN_F2, GOLDEN_F1, GOLDEN_E, freq, vh_obs, alt, bmag,
            bpsi)
    ref = np.asarray(JR.residual_VH(*args))
    got = TR.residual_VH(*args, device=CPU).numpy()
    assert np.isfinite(got).all()
    assert_allclose(got[:3], 0.0, atol=1e-9)
    assert_allclose(got, ref, rtol=0, atol=TOL_KM)


# ---- the LM pieces -------------------------------------------------------------

def test_forward_mode_jvp_of_the_sweep_matches_jax():
    """torch.func.jvp through ionogram_fast_xla equals jax.jvp (rtol 1e-9),
    NaN where the ray escapes, on a tangent along the density."""
    hms, bbs = _truths(1, 3)
    den = np.stack([np.asarray(JR.model_VH(
        {"Nm": NM_TRUTH, "hm": hms[b], "B_bot": bbs[b], "B_top": 40.0}, F1,
        E, FREQ, ALT, BMAG, BPSI)[1]) for b in range(3)])
    u = np.random.default_rng(2).uniform(-1.0, 1.0, den.shape) * den
    fixed = (np.broadcast_to(BMAG, den.shape), np.broadcast_to(BPSI,
                                                               den.shape), ALT)
    for mm in (1.0, -1.0):
        _, t_j = jax.jvp(lambda d: JV.ionogram_fast_xla(
            jnp.asarray(FREQ), d, *map(jnp.asarray, fixed), mode_mult=mm,
            n_points=N_POINTS), (jnp.asarray(den),), (jnp.asarray(u),))
        _, t_t = torch.func.jvp(lambda d: TV.ionogram_fast_xla(
            _t(FREQ), d, *map(_t, fixed), mode_mult=mm, n_points=N_POINTS),
            (_t(den),), (_t(u),))
        t_j, t_t = np.asarray(t_j), t_t.numpy()
        assert np.array_equal(np.isnan(t_t), np.isnan(t_j))
        m = np.isfinite(t_j)
        assert m.sum() > 0.5 * m.size
        assert_allclose(t_t[m], t_j[m], rtol=1e-9,
                        atol=1e-12 * np.abs(t_j[m]).max())


def test_solve_small_matches_jax_including_a_singular_sample():
    rng = np.random.default_rng(4)
    for n in (2, 3):
        M = rng.normal(size=(5, n, n))
        A = np.einsum("bij,bkj->bik", M, M) + 0.1 * np.eye(n)
        A[2] = 0.0                                   # singular sample
        b = rng.normal(size=(5, n))
        ref = np.asarray(JR._solve_small(jnp.asarray(A), jnp.asarray(b)))
        got = TR._solve_small(_t(A), _t(b)).numpy()
        assert_allclose(got, ref, rtol=1e-12)
        assert np.all(np.abs(got[2]) >= 1e290) or np.all(got[2] == 0.0)
        ok = np.arange(5) != 2
        assert_allclose(got[ok], np.linalg.solve(A[ok], b[ok][..., None])[..., 0],
                        rtol=1e-9)


@pytest.fixture(scope="module")
def batch_scene():
    hms, bbs = _truths(3, 4)
    obs = _observations(hms, bbs)
    guess = {"Nm": NM_TRUTH, "hm": hms * 0.97, "B_bot": bbs * 1.05,
             "B_top": 40.0}
    return hms, bbs, obs, guess


def _lm(pkg, scene, **kw):
    hms, bbs, obs, guess = scene
    fn = JR.retrieve_gradient_batch if pkg == "jax" else \
        TR.retrieve_gradient_batch
    extra = {} if pkg == "jax" else {"device": CPU}
    return fn(guess, F1, E, FREQ, obs, ALT, BMAG, BPSI,
              n_points=N_POINTS, **kw, **extra)


def _assert_fits(got, ref, rtol=RTOL_FIT):
    for k in ("hm", "B_bot", "Nm"):
        assert_allclose(np.asarray(got[2][k]), np.asarray(ref[2][k]),
                        rtol=rtol, err_msg=k)
    assert_allclose(np.asarray(got[3]), np.asarray(ref[3]), rtol=rtol)
    vh_g, vh_r = np.asarray(got[0]), np.asarray(ref[0])
    assert np.array_equal(np.isnan(vh_g), np.isnan(vh_r))
    m = np.isfinite(vh_r)
    assert_allclose(vh_g[m], vh_r[m], rtol=rtol)
    assert_allclose(np.asarray(got[1]), np.asarray(ref[1]), rtol=rtol)


def test_retrieve_gradient_batch_matches_jax(batch_scene):
    """B=4, 6 steps, f64: fits, fitted ionograms and EDPs, and the
    per-sample cost history (monotone non-increasing) as the JAX package."""
    kw = dict(steps=6, chunk_size=None, retries=0)
    ref = _lm("jax", batch_scene, **kw)
    got = _lm("torch", batch_scene, **kw)
    _assert_fits(got, ref)
    assert got[3].shape == (6, 4)
    assert np.all(np.diff(got[3], axis=0) <= 0.0)
    assert got[0].dtype == torch.float64


def test_retrieve_gradient_batch_f32(batch_scene):
    """dtype=float32 runs in f32 end to end and follows the f64 fit: the
    JAX package's f64 fits within rtol 1e-3 (the JAX f32 test's scale,
    tests/test_edp_retrieval.py:339-379; an f32 accept decision may flip
    where two costs agree to f32 resolution, so the f32 fits are held to
    f64, not to the JAX package's f32), and a non-increasing cost trace."""
    kw = dict(steps=6, chunk_size=None, retries=0)
    got = _lm("torch", batch_scene, dtype=torch.float32, **kw)
    ref = _lm("jax", batch_scene, **kw)
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.float32
    assert got[2]["hm"].dtype == np.float32
    for k in ("hm", "B_bot", "Nm"):
        assert_allclose(got[2][k], ref[2][k], rtol=1e-3, err_msg=k)
    assert_allclose(got[3], ref[3], rtol=1e-3)
    h = got[3]
    assert np.all(np.diff(h, axis=0) <= 1e-6 * np.maximum(h[:-1], 1.0))


def test_retrieve_gradient_batch_kill_and_resume(batch_scene, tmp_path,
                                                 monkeypatch):
    """A killed batched retrieval resumes from its chunk checkpoint and
    reproduces the uninterrupted fit exactly; a checkpoint written for
    another configuration raises; the JAX package reads the file."""
    kw = dict(steps=3, chunk_size=2, retries=0)
    ref = _lm("torch", batch_scene, **kw)
    ckpt = tmp_path / "lm_state.npz"
    real_core = TR._lm_batch_core
    calls = {"n": 0}

    def dying_core(*a, **k):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("simulated kill")
        return real_core(*a, **k)

    monkeypatch.setattr(TR, "_lm_batch_core", dying_core)
    with pytest.raises(RuntimeError, match="simulated kill"):
        _lm("torch", batch_scene, checkpoint_path=str(ckpt), **kw)
    monkeypatch.setattr(TR, "_lm_batch_core", real_core)
    assert ckpt.exists()
    state = JIO.load_checkpoint(str(ckpt))
    assert int(state["meta"]["chunks_done"]) == 1
    assert state["chunks"]["0"]["hm"].shape == (2,)
    with pytest.raises(ValueError, match="different retrieval"):
        _lm("torch", batch_scene, checkpoint_path=str(ckpt), steps=4,
            chunk_size=2, retries=0)
    res = _lm("torch", batch_scene, checkpoint_path=str(ckpt), **kw)
    assert not ckpt.exists()
    for a, b in zip(ref[:2], res[:2]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    for k in ("hm", "B_bot", "Nm"):
        np.testing.assert_array_equal(ref[2][k], res[2][k])
    np.testing.assert_array_equal(ref[3], res[3])


def test_retrieve_gradient_batch_retry_keeps_better(batch_scene):
    """Forced retries (retry_cost=0) never worsen a fit, and match the
    JAX package's retry pass."""
    kw = dict(steps=3, chunk_size=None)
    base = _lm("torch", batch_scene, retries=0, **kw)
    forced = _lm("torch", batch_scene, retries=1, retry_cost=0.0, **kw)
    assert np.all(forced[3][-1] <= base[3][-1])
    assert np.any(forced[3][-1] < base[3][-1])
    ref = _lm("jax", batch_scene, retries=1, retry_cost=0.0, **kw)
    _assert_fits(forced, ref)


def test_retrieve_gradient_batch_per_sample_environments():
    """[B, N] b_mag/b_psi: each sample's fit equals its own B=1 fit
    (rtol 1e-6, the JAX test's bound) and the JAX package's batch fit;
    the X-mode NmF2 pin reads each sample's own field; a wrong-shaped
    environment raises."""
    hms, bbs = _truths(11, 3)
    bmag = np.linspace(2.4e-5, 4.4e-5, 3)[:, None] * np.ones(ALT.size)
    bpsi = np.linspace(35.0, 80.0, 3)[:, None] * np.ones(ALT.size)
    obs = _observations(hms, bbs, bmag, bpsi)
    guess = {"Nm": NM_TRUTH, "hm": hms * 0.97, "B_bot": bbs * 1.05,
             "B_top": 40.0}
    kw = dict(steps=3, n_points=N_POINTS, retries=0, chunk_size=2)
    got = TR.retrieve_gradient_batch(guess, F1, E, FREQ, obs, ALT, bmag,
                                     bpsi, device=CPU, **kw)
    ref = JR.retrieve_gradient_batch(guess, F1, E, FREQ, obs, ALT, bmag,
                                     bpsi, **kw)
    _assert_fits(got, ref)
    for b in range(3):
        one = TR.retrieve_gradient_batch(
            {"Nm": NM_TRUTH, "hm": hms[b] * 0.97, "B_bot": bbs[b] * 1.05,
             "B_top": 40.0}, F1, E, FREQ, obs[b][None], ALT, bmag[b],
            bpsi[b], device=CPU, **kw)
        assert_allclose(got[2]["hm"][b], one[2]["hm"][0], rtol=1e-6)
        assert_allclose(got[2]["B_bot"][b], one[2]["B_bot"][0], rtol=1e-6)
    x_kw = dict(kw, mode="X", steps=1)
    got_x = TR.retrieve_gradient_batch(guess, F1, E, FREQ, obs, ALT, bmag,
                                       bpsi, device=CPU, **x_kw)
    ref_x = JR.retrieve_gradient_batch(guess, F1, E, FREQ, obs, ALT, bmag,
                                       bpsi, **x_kw)
    assert_allclose(got_x[2]["Nm"], ref_x[2]["Nm"], rtol=1e-12)
    with pytest.raises(ValueError, match=r"\[N\] or \[B, N\]"):
        TR.retrieve_gradient_batch(guess, F1, E, FREQ, obs, ALT, bmag[:2],
                                   bpsi, device=CPU, steps=1)


def test_retrieve_gradient_is_the_batch_core_with_one_sample(batch_scene):
    """retrieve_gradient == retrieve_gradient_batch on a one-ionogram
    batch, bit for bit, and equals the JAX package's fit."""
    hms, bbs, obs, guess = batch_scene
    F2_in = {"Nm": np.array([[NM_TRUTH]]), "hm": np.array([[hms[0] * 0.97]]),
             "B_bot": np.array([[bbs[0] * 1.05]]),
             "B_top": np.array([[40.0]])}
    _, _, fit_s, hist_s = TR.retrieve_gradient(
        F2_in, F1, E, FREQ, obs[0], ALT, BMAG, BPSI, n_points=N_POINTS,
        steps=4, device=CPU)
    _, _, fit_b, hist_b = TR.retrieve_gradient_batch(
        F2_in, F1, E, FREQ, obs[:1], ALT, BMAG, BPSI, n_points=N_POINTS,
        steps=4, retries=0, device=CPU)
    assert fit_s["hm"].shape == (1, 1)
    assert float(fit_s["hm"][0, 0]) == float(fit_b["hm"][0])
    assert float(fit_s["B_bot"][0, 0]) == float(fit_b["B_bot"][0])
    assert np.array_equal(hist_s, hist_b[:, 0])
    _, _, fit_j, hist_j = JR.retrieve_gradient(
        F2_in, F1, E, FREQ, obs[0], ALT, BMAG, BPSI, n_points=N_POINTS,
        steps=4)
    assert_allclose(fit_s["hm"], fit_j["hm"], rtol=RTOL_FIT)
    assert_allclose(hist_s, hist_j, rtol=RTOL_FIT)


# ---- minimize_parameters -------------------------------------------------------

@pytest.fixture(scope="module")
def brute_scene():
    """The JAX package's Powell scene (tests/test_edp_retrieval.py:
    453-479): a 0.5-km grid closes the model family under the NmF2 pin;
    the truth is the golden F2 with hmF2 − 12 km, B_bot + 4 km."""
    alt = np.arange(80.0, 700.0, 0.5)
    freq = np.arange(2.0, 13.51, 0.25)
    bmag, bpsi = np.full(alt.size, 3e-5), np.full(alt.size, 70.0)
    F2 = _scalars(GOLDEN_F2)
    truth = dict(F2, Nm=float((13.5e6 / 8.97866275) ** 2) * 1.0001,
                 hm=F2["hm"] - 12.0, B_bot=F2["B_bot"] + 4.0)
    obs = np.asarray(JR.model_VH(truth, F1, E, freq, alt, bmag, bpsi)[0])
    assert np.isfinite(obs[-1])
    return truth, (F2, F1, E, freq, obs, alt, bmag, bpsi)


def test_minimize_parameters_brute_matches_jax(brute_scene):
    """Brute search over the whole grid (one batched forward call): the
    same grid point as the JAX package, within 2 grid steps of the truth
    (the JAX test's bounds)."""
    truth, args = brute_scene
    kw = dict(percent_sigma=10.0, step=2.0)
    ref = JR.minimize_parameters(*args, **kw)
    got = TR.minimize_parameters(*args, device=CPU, **kw)
    for k in ("hm", "B_bot", "Nm"):
        assert_allclose(got[2][k], ref[2][k], rtol=1e-12, err_msg=k)
    assert abs(float(got[2]["hm"]) - truth["hm"]) <= 4.0
    assert abs(float(got[2]["B_bot"]) - truth["B_bot"]) <= 2.5
    assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=0, atol=TOL_KM)
    assert_allclose(got[1].numpy(), np.asarray(ref[1]), rtol=1e-12)


def test_minimize_parameters_powell(brute_scene):
    """Powell (scipy on the host) minimises the same cost as the JAX
    package's (rtol 1e-8 at the start and at both packages' fits: Σr² of
    residuals that agree to the forward operator's 1e-6 km) and improves
    it from the start within the (old ± sigma) bounds.
    The two fits are not compared: the cost jumps where a near-peak
    frequency starts to escape (its residual becomes the NaN fill), so
    last-ulp differences stop the two line searches at different points
    (in this scene 4 km apart in hmF2, the JAX fit the farther from the
    truth)."""
    truth, args = brute_scene
    F2, _, _, freq, obs, alt, bmag, bpsi = args
    kw = dict(method="powell", percent_sigma=10.0)
    ref = JR.minimize_parameters(*args, **kw)
    got = TR.minimize_parameters(*args, device=CPU, **kw)
    nm = float(got[2]["Nm"])
    assert nm == float(ref[2]["Nm"])

    def cost(pkg, hm, bb):
        p = {"NmF2": nm, "hmF2": hm, "B_bot": bb}
        if pkg == "jax":
            r = np.asarray(JR.residual_VH(p, F2, F1, E, freq, obs, alt, bmag,
                                          bpsi))
        else:
            r = TR.residual_VH(p, F2, F1, E, freq, obs, alt, bmag, bpsi,
                               device=CPU).numpy()
        return float(np.sum(r * r))

    fits = [(F2["hm"], F2["B_bot"])] + [
        (float(f[2]["hm"]), float(f[2]["B_bot"])) for f in (got, ref)]
    for hm, bb in fits:
        assert_allclose(cost("torch", hm, bb), cost("jax", hm, bb),
                        rtol=1e-8)
    assert abs(fits[1][0] - F2["hm"]) <= 0.1 * F2["hm"]
    assert abs(fits[1][1] - F2["B_bot"]) <= 0.1 * F2["B_bot"]
    assert cost("torch", *fits[1]) < cost("torch", *fits[0])


def test_minimize_parameters_options(batch_scene, monkeypatch):
    """A RetrievalConfig supplies the knobs; an empty brute grid falls
    back to the initial value; a missing B_bot raises; the LM method
    delegates to retrieve_gradient."""
    obs = batch_scene[2][0]
    F2 = _scalars(GOLDEN_F2)
    cfg = RetrievalConfig(percent_sigma=0.001, step=5.0, n_points=N_POINTS)
    _, _, fit = TR.minimize_parameters(F2, F1, E, FREQ, obs, ALT, BMAG, BPSI,
                                       config=cfg, device=CPU)
    assert np.isclose(float(fit["hm"]), F2["hm"])
    assert np.isclose(float(fit["B_bot"]), F2["B_bot"])
    with pytest.raises(ValueError, match="B_bot is not provided"):
        TR.minimize_parameters({"Nm": 1e12, "hm": 300.0}, {}, {}, [5.0],
                               [200.0], [100.0, 200.0], np.zeros(2),
                               np.zeros(2), device=CPU)
    calls = []
    monkeypatch.setattr(TR, "retrieve_gradient",
                        lambda *a, **k: calls.append(k) or (1, 2, 3, 4))
    assert TR.minimize_parameters(F2, F1, E, FREQ, obs, ALT, BMAG, BPSI,
                                  method="levenberg-marquardt",
                                  n_points=N_POINTS, device=CPU) == (1, 2, 3)
    assert calls[0]["n_points"] == N_POINTS and calls[0]["mode"] == "O"


def test_checkpoint_roundtrip_is_the_jax_layout(tmp_path):
    """save_checkpoint/load_checkpoint keep dotted keys, write the JAX
    package's layout (each package reads the other's file), and accept
    tensors."""
    state = {"meta": {"chunks_done": 1, "2.5": np.arange(3.0)},
             "chunks": {"0": {"hm": torch.tensor([1.0, 2.0])}}}
    path = str(tmp_path / "c.npz")
    TIO.save_checkpoint(state, path)
    back = JIO.load_checkpoint(path)
    np.testing.assert_array_equal(back["meta"]["2.5"], np.arange(3.0))
    np.testing.assert_array_equal(back["chunks"]["0"]["hm"], [1.0, 2.0])
    JIO.save_checkpoint({"a": {"b.c": np.ones(2)}}, path)
    np.testing.assert_array_equal(TIO.load_checkpoint(path)["a"]["b.c"],
                                  np.ones(2))
