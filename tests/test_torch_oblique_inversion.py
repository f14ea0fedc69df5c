"""PyTorch port vs the JAX package: ``retrieve_from_oblique``.

The set-up of ``tests/test_oblique_inversion.py`` (a 900 km link,
spherical O-mode homing) at a small size: a 131-node midpoint grid, 6
frequencies, ``n_elev`` 64, 4 LM steps. Observations come from the JAX
package's own synthesis of a known truth. The fitted parameters, the LM
history and the fitted delays and profile agree with the JAX function's
to rtol 1e-6, NaN masks identical; a history entry below 1e-12 ms² (a
residual of rounding size, reached when the fit converges) to 1e-12
absolute.
"""

import jax.numpy as jnp
import numpy as np
import pytest
from numpy.testing import assert_allclose

from pyrayhf_tpu.oblique import synthesize_oblique_ionogram
from pyrayhf_tpu.oblique_inversion import retrieve_from_oblique as jax_fit
from pyrayhf_tpu.retrieval import _build_edp
from pyrayhf_tpu_torch import retrieve_from_oblique

from _torch_threads import one_torch_thread  # noqa: F401

ALT = np.linspace(80.0, 600.0, 131)
F1 = {"P": 0.0}
E = {"Nm": 5e10, "hm": 110.0, "B_bot": 5.0, "B_top": 7.0}
BABS = np.full_like(ALT, 4.5e-5)
BPSI = np.full_like(ALT, 40.0)
D_KM = 900.0
F0S = np.linspace(5e6, 14e6, 6)
TRUTH = {"Nm": 9e11, "hm": 310.0, "B_bot": 48.0, "B_top": 60.0}
KW = dict(mode="O", geometry="spherical", n_elev=64, steps=4)
RTOL = 1e-6


@pytest.fixture(scope="module")
def obs():
    EDPt, _ = _build_edp(TRUTH, F1, E, jnp.asarray(ALT), "B_bot")
    out = synthesize_oblique_ionogram(F0S, D_KM, ALT, np.asarray(EDPt),
                                      BABS, BPSI, geometry="spherical",
                                      n_elev=64)
    lo = np.asarray(out["delay_low_sec"])
    assert 3 <= np.isfinite(lo).sum() < F0S.size      # a MUF nose
    return lo, np.asarray(out["delay_high_sec"])


def _same(port, ref):
    for a, b in zip(ref[:3], port[:3]):
        a, b = np.asarray(a), b.numpy()
        assert np.array_equal(np.isnan(a), np.isnan(b))
        m = np.isfinite(a)
        assert_allclose(b[m], a[m], rtol=RTOL)
    assert set(port[3]) == set(ref[3])
    for k in ref[3]:
        assert port[3][k] == pytest.approx(ref[3][k], rel=RTOL), k
    assert port[4].shape == ref[4].shape == (KW["steps"],)
    assert_allclose(port[4], ref[4], rtol=RTOL, atol=1e-12)


@pytest.mark.parametrize("case", ["fit_nm", "brute_fixed_nm"])
def test_retrieve_from_oblique_matches_jax(obs, case):
    """NmF2, hmF2 and B_bot fitted from low and high rays by LM alone; and
    NmF2 held, LM seeded by the brute grid (its 15 points: the card's
    link phase runs the default 90-point grid with NmF2 fitted)."""
    lo, hi = obs
    if case == "fit_nm":
        init = {"Nm": 6e11, "hm": 270.0, "B_bot": 38.0, "B_top": 60.0}
        kw = dict(KW, delay_high_obs_sec=hi, brute_init=False)
    else:
        init = {"Nm": TRUTH["Nm"], "hm": 280.0, "B_bot": 40.0,
                "B_top": 60.0}
        kw = dict(KW, fit_nm=False)
    ref = jax_fit(init, F1, E, F0S, lo, D_KM, ALT, BABS, BPSI, **kw)
    port = retrieve_from_oblique(init, F1, E, F0S, lo, D_KM, ALT, BABS,
                                 BPSI, device="cpu", **kw)
    _same(port, ref)
    hist = port[4]
    assert hist[-1] <= hist[0]
    if case == "brute_fixed_nm":
        assert port[3]["Nm"] == TRUTH["Nm"]
