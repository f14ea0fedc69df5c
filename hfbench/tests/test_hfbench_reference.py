"""The plain reference against the JAX package's vertical forward operator.

On the CPU in float64, at small sizes: O and X mode, 200 and 20,000 grid
points, on the benchmark's own profiles (Chapman layers, some with an E
layer, dipole |B| and ψ). NaN masks must be identical and finite values
within 1e-6 km, the JAX package's own bound between its kernels and this
operator (``tests/test_pallas.py``).
"""

import numpy as np
import pytest
import torch

from hfbench import inputs
from hfbench.reference import vertical_forward as ref

jax = pytest.importorskip("jax")
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from pyrayhf_tpu.forward import vertical_forward_operator_batch  # noqa: E402

ALT = np.linspace(80.0, 699.0, 620)
FREQ = np.round(np.arange(1, 176) * 0.1, 10)
TRAFFIC = {"profiles_per_call": 5, "pool_calls": 1, "sites": "random",
           "e_layer_share": 0.4}


def _profiles(seed, B):
    t = dict(TRAFFIC, profiles_per_call=B)
    return inputs.profiles(t, seed, ALT, torch.device("cpu"))


@pytest.mark.parametrize("mode,n_points,B,seed", [
    ("O", 200, 5, 2 ** 31 + 1),
    ("X", 200, 5, 2 ** 31 + 2),
    ("O", 20000, 2, 2 ** 31 + 3),
    ("X", 20000, 2, 2 ** 31 + 4),
])
def test_reference_matches_jax(mode, n_points, B, seed):
    den, bmag, bpsi = _profiles(seed, B)
    mm = 1.0 if mode == "O" else -1.0
    got = ref.vertical_forward(torch.tensor(FREQ), den, bmag, bpsi,
                               torch.tensor(ALT), mm, n_points).numpy()
    want = np.asarray(vertical_forward_operator_batch(
        FREQ, den.numpy(), bmag.numpy(), bpsi.numpy(), ALT, mode=mode,
        n_points=n_points))
    assert np.array_equal(np.isnan(got), np.isnan(want))
    m = np.isfinite(want)
    assert m.sum() > 0.3 * m.size
    assert np.abs(got[m] - want[m]).max() < 1e-6


def test_reference_blocks_agree():
    """Blocks of pairs and of profiles change nothing."""
    den, bmag, bpsi = _profiles(2 ** 31 + 5, 4)
    args = (torch.tensor(FREQ[::7]), den, bmag, bpsi, torch.tensor(ALT),
            1.0, 200)
    whole = ref.vertical_forward(*args)
    old = ref.BLOCK_POINTS
    try:
        ref.BLOCK_POINTS = 3000
        small = ref.vertical_forward(*args)
    finally:
        ref.BLOCK_POINTS = old
    assert torch.equal(torch.isnan(whole), torch.isnan(small))
    m = ~torch.isnan(whole)
    assert torch.equal(whole[m], small[m])


def test_reflecting_pairs_hold_the_finite_ones():
    """Every finite pair reflects. A few reflecting pairs are NaN, all at
    the lowest frequencies, near or below the gyrofrequency at the grid's
    first node, where no sample of the stretched grid propagates or, in X
    mode, the cutoff is passed at the first node and Σ μ′·Δh over a grid
    of −1e-6 km may be exactly 0."""
    den, bmag, bpsi = _profiles(2 ** 31 + 6, 4)
    for mm in (1.0, -1.0):
        vh = ref.vertical_forward(torch.tensor(FREQ), den, bmag, bpsi,
                                  torch.tensor(ALT), mm, 200)
        valid = ref.reflecting_pairs(torch.tensor(FREQ), den, bmag, bpsi,
                                     torch.tensor(ALT), mm)
        finite = ~torch.isnan(vh)
        assert not (finite & ~valid).any()
        fi = torch.nonzero(valid & ~finite, as_tuple=True)[1]
        assert (torch.tensor(FREQ)[fi] <= 2.0).all()
