"""The CUDA kernels against their plain versions, on the card.

Marked ``gpu``: they need a CUDA device and ``nvcc`` (the kernels are
built at first use) and skip without a card. Run them on the card with
``python -m pytest tests/test_torch_gpu_kernels.py -q -m gpu``.
Tolerances: f64 identical NaN masks and ≤ 1e-6 km; f32 within 0.1 km of
the f64 plain result (the accuracy contract).
"""

import numpy as np
import pytest
import torch

import pyrayhf_tpu_torch.pallas_vh as TV

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _case(two_peak, n_alt=231):
    alt = np.linspace(90.0, 550.0, n_alt)
    rng = np.random.default_rng(3)
    den = rng.uniform(1e12, 3e12, (4, 1)) * np.exp(
        -(alt - rng.uniform(250.0, 330.0, (4, 1))) ** 2 / (2 * 55.0 ** 2))
    if two_peak:
        den[1::2] += 9e11 * np.exp(-(alt - 110.0) ** 2 / (2 * 10.0 ** 2))
    bmag = np.full_like(den, 3.2e-5)
    bpsi = np.full_like(den, 65.0)
    freqs = np.concatenate([[0.3], np.arange(1.0, 16.0, 0.5), [25.0, 30.0]])
    return freqs, den, bmag, bpsi, alt


@pytest.mark.parametrize("kind,mode_mult", [("gather_osolve", 1.0),
                                            ("gather_xsolve", -1.0),
                                            ("gather", -1.0),
                                            ("sweep", 1.0)])
@pytest.mark.parametrize("n_points", [200, 2000])
@pytest.mark.parametrize("two_peak", [False, True])
def test_kernel_matches_plain(cuda, kind, mode_mult, n_points, two_peak):
    args = _case(two_peak)
    inv = None if kind == "sweep" else TV.uniform_inv_dalt(args[4])

    def run(dtype, kernel):
        t = [torch.as_tensor(a, dtype=dtype, device=cuda) for a in args]
        if kind == "sweep" and not kernel:
            return TV.ionogram_fast_xla(*t, mode_mult=mode_mult,
                                        n_points=n_points)
        a = TV.prepare_kernel_args(kind, *t, mode_mult, n_points, inv)
        return TV.launch_kernel(a) if kernel else TV.plain_ionogram(a)

    ref = run(torch.float64, False).cpu().numpy()
    k64 = run(torch.float64, True).cpu().numpy()
    k32 = run(torch.float32, True).double().cpu().numpy()
    assert np.array_equal(np.isnan(k64), np.isnan(ref))
    m = np.isfinite(ref)
    m[:, 0] = False                        # sub-gyro row: NaN pattern only
    assert np.abs(k64[m] - ref[m]).max() <= 1e-6
    m32 = m & np.isfinite(k32)
    assert np.abs(k32[m32] - ref[m32]).max() <= 0.1


def test_auto_reads_the_grid_once(cuda, monkeypatch):
    """``engine="auto"`` copies ``alt`` to the host once per call: the
    router hands 1/Δalt to the gather, which launches its kernel."""
    from pyrayhf_tpu_torch.forward import vertical_forward_operator_batch
    reads = []
    real = TV.uniform_inv_dalt
    monkeypatch.setattr(TV, "uniform_inv_dalt",
                        lambda alt: reads.append(1) or real(alt))
    args = [torch.as_tensor(a, dtype=torch.float32, device=cuda)
            for a in _case(False)]
    TV.reset_counters()
    vh = vertical_forward_operator_batch(*args, mode="O")
    assert vh.shape == (4, args[0].shape[0]) and vh.device == cuda
    assert len(reads) == 1
    assert TV.LAUNCHES["gather_osolve"] == 1
    assert sum(TV.PLAIN_CALLS.values()) == 0


def test_sweep_kernel_nonuniform_grid(cuda):
    """The binary-search index on a non-uniform grid against the plain
    segment sweep (f64: identical NaN masks, ≤ 1e-6 km)."""
    rng = np.random.default_rng(7)
    alt = np.sort(rng.uniform(90.0, 550.0, 150))
    alt[0], alt[-1] = 90.0, 550.0
    den = 2e12 * np.exp(-(alt - 300.0) ** 2 / (2 * 60.0 ** 2))[None, :]
    args = [torch.as_tensor(a, dtype=torch.float64, device=cuda)
            for a in (np.arange(2.0, 14.0, 1.0), den, np.full_like(den, 3e-5),
                      np.full_like(den, 60.0), alt)]
    TV.reset_counters()
    k = TV.ionogram_pallas(*args, mode_mult=1.0).cpu().numpy()
    assert TV.LAUNCHES["sweep"] == 1 and TV.PLAIN_CALLS["sweep"] == 0
    ref = TV.ionogram_fast_xla(*args, mode_mult=1.0).cpu().numpy()
    assert np.array_equal(np.isnan(k), np.isnan(ref))
    m = np.isfinite(ref)
    assert np.abs(k[m] - ref[m]).max() <= 1e-6
