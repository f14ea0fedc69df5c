"""PyTorch port vs the JAX package: the batch-sharded Levenberg–Marquardt
retrieval.

The JAX function runs on the tests' 8 virtual CPU devices as a 4×2 mesh,
the port on ``[torch.device("cpu")] * 8`` as a 4×2 mesh, on the scene of
``tests/test_parallel.py`` (B = 8 Chapman-bottomside ionograms on a
124-node grid from 80 to 695 km, 100 points). The port's LM is per sample: its damping,
accept decisions, fixed step count and retries are each sample's own, so a
shard's fits are the unsharded call's rows. Tolerances: against the
port's unsharded call hmF2 and B_bot rtol 1e-9, vh rtol 1e-8 (the JAX
test's own); against the JAX sharded call rtol 1e-8 (the port's LM
tolerance, ``tests/test_torch_edp_retrieval.py``); a row's fit within a
batch against its fit alone rtol 1e-12.
"""

import numpy as np
import pytest
import torch
import jax
from numpy.testing import assert_allclose

import pyrayhf_tpu.parallel as JP
import pyrayhf_tpu_torch.parallel as TP
from pyrayhf_tpu_torch.magnetoionic import freq2den
from pyrayhf_tpu_torch.retrieval import model_VH, retrieve_gradient_batch

from _torch_threads import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
# the JAX test's grid at 5-km spacing: the port's LM is host-bound on the
# CPU (one torch op per segment and channel of every forward), and a shard
# pays a whole call's host time, so the 1-km grid would take minutes here
DH_KM = 5.0


@pytest.fixture(scope="module")
def mesh8():
    if jax.device_count() < 8:
        pytest.skip("needs 8 virtual devices")
    return JP.ionogram_mesh(jax.devices()[:8], batch_axis=4)


@pytest.fixture(scope="module")
def tmesh():
    return TP.ionogram_mesh([CPU] * 8, batch_axis=4)


@pytest.fixture(scope="module")
def tmesh2():
    """Two shards: the port-only tests pay each shard's host time."""
    return TP.ionogram_mesh([CPU] * 2)


def _scene(B, seed):
    """The JAX test's scene: B truths, their ionograms (the port's
    ``model_VH``) and the first guess 3% low in hmF2, 5% high in B_bot."""
    alt = np.arange(80.0, 700.0, DH_KM)
    bmag = np.full(alt.size, 3e-5)
    bpsi = np.full(alt.size, 70.0)
    E = {"Nm": 1.2e11, "hm": 110.0, "B_bot": 5.0, "B_top": 7.0}
    F1 = {"P": 0.6}
    freq = np.arange(2.0, 13.51, 0.5)
    nm_truth = float(freq2den(torch.tensor(13.5e6))) * 1.0001
    rng = np.random.default_rng(seed)
    hms = rng.uniform(280.0, 350.0, B)
    bbs = rng.uniform(38.0, 55.0, B)
    t = torch.as_tensor
    F2 = {"Nm": nm_truth, "hm": t(hms)[:, None], "B_bot": t(bbs)[:, None],
          "B_top": 40.0}
    obs = model_VH(F2, F1, E, t(freq), *(t(a).expand(B, -1)
                                         for a in (alt, bmag, bpsi)),
                   n_points=100)[0].numpy()
    F2g = {"Nm": nm_truth, "hm": hms * 0.97, "B_bot": bbs * 1.05,
           "B_top": 40.0}
    return F2g, F1, E, freq, obs, alt, bmag, bpsi


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


LM_KW = dict(steps=8, n_points=100)


@pytest.fixture(scope="module")
def unsharded():
    """The scene of B = 8 and the port's unsharded fit of it."""
    args = _scene(8, 11)
    return args, retrieve_gradient_batch(*args, chunk_size=None,
                                         device="cpu", **LM_KW)


def test_batched_lm_sharded_matches(mesh8, tmesh, unsharded):
    args, (vh_u, edp_u, F2_u, hist_u) = unsharded
    vh_s, edp_s, F2_s, hist_s = TP.retrieve_gradient_batch_sharded(
        *args, tmesh, **LM_KW)
    assert vh_s.shape == (8, args[3].size) and edp_s.shape == (8, 124)
    assert hist_s.shape == (8, 8)
    for k in ("hm", "B_bot"):
        assert_allclose(F2_s[k], F2_u[k], rtol=1e-9)
    m = np.isfinite(_np(vh_u))
    np.testing.assert_array_equal(np.isfinite(_np(vh_s)), m)
    assert_allclose(_np(vh_s)[m], _np(vh_u)[m], rtol=1e-8)
    assert_allclose(_np(edp_s), _np(edp_u), rtol=1e-9,
                    atol=1e-12 * float(edp_u.max()))
    assert_allclose(hist_s, hist_u, rtol=1e-9)

    vh_j, _, F2_j, hist_j = JP.retrieve_gradient_batch_sharded(
        *args, mesh8, **LM_KW)
    for k in ("Nm", "hm", "B_bot"):
        assert_allclose(F2_s[k], np.asarray(F2_j[k]), rtol=1e-8)
    mj = np.isfinite(np.asarray(vh_j))
    np.testing.assert_array_equal(np.isfinite(_np(vh_s)), mj)
    assert_allclose(_np(vh_s)[mj], np.asarray(vh_j)[mj], rtol=1e-8)
    assert_allclose(hist_s, np.asarray(hist_j), rtol=1e-8)
    # the JAX test's progress checks
    assert np.all(hist_s[-1] <= hist_s[0])
    assert np.mean(hist_s[-1] < 0.9 * hist_s[0]) >= 0.5


def test_sharded_lm_chunking_composes(tmesh2):
    """chunk_size × sharding: the chunks, each sharded again, equal one
    sharded run; a chunk, or a batch, that the axis does not divide
    raises."""
    args = _scene(16, 7)
    one = TP.retrieve_gradient_batch_sharded(*args, tmesh2, steps=2,
                                             n_points=100)
    two = TP.retrieve_gradient_batch_sharded(*args, tmesh2, steps=2,
                                             n_points=100, chunk_size=8)
    for k in ("hm", "B_bot"):
        assert_allclose(two[2][k], one[2][k], rtol=1e-9)
    m = np.isfinite(_np(one[0]))
    assert_allclose(_np(two[0])[m], _np(one[0])[m], rtol=1e-9)
    assert two[3].shape == one[3].shape == (2, 16)
    with pytest.raises(ValueError, match="divisible"):
        TP.retrieve_gradient_batch_sharded(*args, tmesh2, steps=2,
                                           n_points=100, chunk_size=5)
    with pytest.raises(ValueError, match="divisible"):
        TP.retrieve_gradient_batch_sharded(*args[:4], args[4][:5],
                                           *args[5:], tmesh2, steps=2,
                                           n_points=100)


def test_lm_rows_are_independent(unsharded):
    """What the sharded LM rests on: rows 0-3 of a B = 8 fit equal the fit
    of those 4 alone (per-sample damping, accepts and retries)."""
    (F2g, F1, E, freq, obs, alt, bmag, bpsi), full = unsharded
    F2h = dict(F2g, hm=F2g["hm"][:4], B_bot=F2g["B_bot"][:4])
    half = retrieve_gradient_batch(F2h, F1, E, freq, obs[:4], alt, bmag,
                                   bpsi, chunk_size=None, device="cpu",
                                   **LM_KW)
    for k in ("Nm", "hm", "B_bot"):
        assert_allclose(full[2][k][:4], half[2][k], rtol=1e-12)
    m = np.isfinite(_np(half[0]))
    assert_allclose(_np(full[0][:4])[m], _np(half[0])[m], rtol=1e-12)
    # the cost history sums each row's F squared residuals, which torch
    # reduces in another order for another batch size: 1.4e-12 seen
    assert_allclose(full[3][:, :4], half[3], rtol=1e-10)


def test_per_sample_fields_split_with_the_batch(tmesh2):
    """[B, N] |B| and ψ are cut with the batch; equal to the shared [N]
    field when every row holds it."""
    F2g, F1, E, freq, obs, alt, bmag, bpsi = _scene(8, 11)
    shared = TP.retrieve_gradient_batch_sharded(
        F2g, F1, E, freq, obs, alt, bmag, bpsi, tmesh2, steps=2,
        n_points=100)
    rows = TP.retrieve_gradient_batch_sharded(
        F2g, F1, E, freq, obs, alt, np.tile(bmag, (8, 1)),
        np.tile(bpsi, (8, 1)), tmesh2, steps=2, n_points=100)
    for k in ("hm", "B_bot"):
        assert_allclose(rows[2][k], shared[2][k], rtol=1e-12)
