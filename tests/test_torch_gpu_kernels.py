"""The CUDA kernels against their plain versions, on the card.

Marked ``gpu``: they need a CUDA device and ``nvcc`` (the kernels are
built at first use) and skip without a card. Run them on the card with
``python -m pytest tests/test_torch_gpu_kernels.py -q -m gpu``.
Tolerances: f64 identical NaN masks and ≤ 1e-6 km; f32 within 0.1 km of
the f64 plain result (the accuracy contract) and, on the ionogram
kernels' edge cases, within 1e-3 km of plain f32 with identical masks
(at cutoff frequencies, or 4 f32 ulps of vh where that is more: vh
reaches ~1e7 km at a constant-|B| profile's gyrofrequency);
the mxu kernel against kernel 3 ≤ 1e-9 km in f64, and bit for bit, f32
and f64, where the inputs exercise the edges of its banded products. The
ray-fan kernel: f64 identical status codes and landing masks, rtol 1e-8,
atol 1e-10; f32 identical status codes, landing masks and step counts,
rtol 1e-4, atol 1e-6 (the four path sums add in another order in the
plain version); the kernel's paired f32 division bit for bit the IEEE
one. The segment-table kernel: bit for bit the PyTorch composition it
replaces (NaN at the same places, signed zeros kept), and ``auto``'s vh
bit for bit with either table.
"""

import ctypes
import subprocess
import types

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
    """``engine="auto"`` copies ``alt`` to the host on its first call with a
    grid and keeps the launch plan: the router hands 1/Δalt to the gather,
    which launches its kernel; a repeat call on the same tensors reads
    nothing, and one after an in-place write to ``alt`` reads it again."""
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
    vertical_forward_operator_batch(*args, mode="O")
    assert len(reads) == 1
    args[4].add_(0.0)
    vertical_forward_operator_batch(*args, mode="O")
    assert len(reads) == 2
    assert TV.LAUNCHES["gather_osolve"] == 3
    assert TV.PLANS == {"hit": 1, "miss": 2, "direct": 3}


@pytest.mark.parametrize("engine", ["pallas", "pallas_gather", "pallas_mxu"])
@pytest.mark.parametrize("mode", ["O", "X"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_a_repeat_call_equals_the_first(cuda, engine, mode, dtype):
    """A call that reuses its launch plan gives the first call's output
    bit for bit, as does a call on a fresh copy of the grid."""
    from pyrayhf_tpu_torch.forward import vertical_forward_operator_batch
    args = [torch.as_tensor(a, dtype=dtype, device=cuda)
            for a in _case(True)]

    def call(*xs):
        return vertical_forward_operator_batch(*xs, mode=mode,
                                               engine=engine).view(
            torch.int32 if dtype == torch.float32 else torch.int64)

    TV.reset_counters()
    first = call(*args)
    again = call(*args)
    fresh = call(args[0].clone(), *args[1:4], args[4].clone())
    assert TV.PLANS["hit"] == 1 and TV.PLANS["miss"] == 2
    assert torch.equal(first, again) and torch.equal(first, fresh)


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


def test_numpy_lands_on_the_card(cuda):
    """Host arrays with no device request go to the card, and the
    ``auto`` forward operator then launches its kernel."""
    from pyrayhf_tpu_torch.forward import vertical_forward_operator_batch
    TV.reset_counters()
    vh = vertical_forward_operator_batch(*_case(False), mode="O")
    assert vh.device.type == "cuda" and vh.dtype == torch.float64
    assert TV.LAUNCHES["gather_osolve"] == 1
    assert sum(TV.PLAIN_CALLS.values()) == 0


@pytest.mark.parametrize("mode_mult", [1.0, -1.0])
@pytest.mark.parametrize("n_points", [200, 2000])
@pytest.mark.parametrize("two_peak", [False, True])
def test_mxu_kernel_matches_plain_and_kernel3(cuda, mode_mult, n_points,
                                              two_peak):
    """The tensor-core one-hot kernel against its plain version (f64
    identical NaN masks and ≤ 1e-6 km; f32 within 0.1 km of plain f64) and
    against kernel 3 (``gather``, the same function by a direct load) on
    the same prepared inputs: identical masks, ≤ 1e-9 km in f64."""
    args = _case(two_peak)
    inv = TV.uniform_inv_dalt(args[4])

    def prep(kind, dtype):
        t = [torch.as_tensor(a, dtype=dtype, device=cuda) for a in args]
        return TV.prepare_kernel_args(kind, *t, mode_mult, n_points, inv)

    TV.reset_counters()
    a64 = prep("mxu", torch.float64)
    k64 = TV.launch_mxu(a64).cpu().numpy()
    k32 = TV.launch_mxu(prep("mxu", torch.float32)).double().cpu().numpy()
    assert TV.LAUNCHES["mxu"] == 2
    ref = TV.plain_ionogram(a64).cpu().numpy()
    g64 = TV.launch_kernel(prep("gather", torch.float64)).cpu().numpy()
    assert np.array_equal(np.isnan(k64), np.isnan(ref))
    assert np.array_equal(np.isnan(k64), np.isnan(g64))
    m = np.isfinite(ref)
    m[:, 0] = False                        # sub-gyro row: NaN pattern only
    assert np.abs(k64[m] - ref[m]).max() <= 1e-6
    assert np.abs(k64[m] - g64[m]).max() <= 1e-9
    m32 = m & np.isfinite(k32)
    assert np.abs(k32[m32] - ref[m32]).max() <= 0.1


# ---- csrc/ionogram.cu: escaped pairs, the sweep's cursor, both layouts --

ION_KINDS = [("gather_osolve", 1.0), ("gather_xsolve", -1.0),
             ("gather", 1.0), ("gather", -1.0), ("sweep", 1.0),
             ("sweep", -1.0)]


def _ion_case(case):
    """(freqs MHz, den, |B|, psi, alt, P) of an edge case of the ionogram
    kernels (numpy, seeded)."""
    rng = np.random.default_rng(11)
    alt = np.linspace(90.0, 550.0, 231)
    B = 4
    hm = rng.uniform(250.0, 330.0, (B, 1))
    den = rng.uniform(1e12, 3e12, (B, 1)) * np.exp(
        -(alt - hm) ** 2 / (2 * 55.0 ** 2))
    bmag = np.full_like(den, 3.2e-5)
    bpsi = rng.uniform(0.0, 90.0, (B, 1)) + 0.0 * den
    # 0.1-20 MHz: the lowest frequencies are valid, the rest escape; 0.3
    # and 0.6 MHz lie below the gyrofrequency (X: the first node already
    # past the cutoff, span -1e-6 km)
    freqs = np.concatenate([[0.3, 0.6], np.linspace(1.0, 20.0, 31)])
    P = 200
    if case == "escaped":           # profile 0 reflects nothing
        den[0] = 1e6
    elif case == "strong_field":    # sub-gyro rows up to ~1.5 MHz
        bmag[:] = 5.5e-5
        freqs = np.linspace(0.2, 3.0, 15)
    elif case.startswith("P"):      # P = 2, 37 (no multiple of a warp or
        P = int(case[1:])           # a block), 20,000 at B = 2
        if P > 2000:
            den, bmag, bpsi = den[:2], bmag[:2], bpsi[:2]
    elif case == "F7":              # fewer frequencies than a block's warps
        freqs = np.array([0.3, 2.0, 4.0, 6.0, 8.0, 11.0, 19.0])
    elif case == "F176":            # F no multiple of the group count
        freqs = np.linspace(0.1, 17.6, 176)
    return freqs, den, bmag, np.ascontiguousarray(bpsi), alt, P


def _first_exceeds(freqs, den, bmag, mode_mult):
    f = np.asarray(freqs)[None, :] * 1e6
    s = den[:, :1] * 8.97866275 ** 2 / f ** 2
    if mode_mult < 0:
        s = s + bmag[:, :1] * 2.799249247e10 / f
    return s >= 1.0


def _hold(k64, k32, p64, p32, degenerate):
    """f64 kernel vs plain f64: identical NaN masks, <= 1e-6 km; f32 vs
    plain f32: identical masks, <= 1e-3 km; f32 vs plain f64 <= 0.1 km
    outside the first-node rows, except where plain f32 is over 0.1 km too
    (the f32 limit of the algorithm, ROADMAP Queue 3)."""
    k64, k32, p64, p32 = (x.double().cpu().numpy()
                          for x in (k64, k32, p64, p32))
    for k, p, tol in ((k64, p64, 1e-6), (k32, p32, 1e-3)):
        assert np.array_equal(np.isnan(k), np.isnan(p))
        m = np.isfinite(p)
        assert not m.any() or np.abs(k[m] - p[m]).max() <= tol
    m = np.isfinite(k32) & np.isfinite(p64) & ~degenerate
    over = np.abs(np.where(m, k32 - p64, 0.0)) > 0.1
    excused = np.abs(np.where(m & np.isfinite(p32), p32 - p64, 0.0)) > 0.1
    assert not (over & ~excused).any()


def _ion_run(cuda, kind, mode_mult, args, P, dtype, kernel):
    t = [torch.as_tensor(a, dtype=dtype, device=cuda) for a in args]
    if kind == "sweep" and not kernel:
        return TV.ionogram_fast_xla(*t, mode_mult=mode_mult, n_points=P)
    inv = None if kind == "sweep" else TV.uniform_inv_dalt(t[4])
    a = TV.prepare_kernel_args(kind, *t, mode_mult, P, inv)
    return TV.launch_kernel(a) if kernel else TV.plain_ionogram(a)


@pytest.mark.parametrize("case", ["mix", "escaped", "strong_field", "P2",
                                  "P37", "P20000", "F7", "F176"])
@pytest.mark.parametrize("kind,mode_mult", ION_KINDS)
def test_ionogram_kernel_edge_cases(cuda, kind, mode_mult, case):
    """Every instantiation of csrc/ionogram.cu against its plain version
    where the redesign could go wrong: an all-escaped profile (its pairs
    skip the tail), a mix where only the lowest frequencies are valid,
    sub-gyro first-exceedance rows (valid, span -1e-6 km), P = 2, 37 and
    20,000 (a warp per pair, then a block per pair), F below a block's
    warps and F no multiple of the group count."""
    *args, P = _ion_case(case)
    outs = {(dt, k): _ion_run(cuda, kind, mode_mult, args, P, dt, k)
            for dt in (torch.float64, torch.float32) for k in (True, False)}
    _hold(outs[torch.float64, True], outs[torch.float32, True],
          outs[torch.float64, False], outs[torch.float32, False],
          _first_exceeds(args[0], args[1], args[2], mode_mult))
    k64 = outs[torch.float64, True].cpu().numpy()
    if case == "escaped":
        assert np.isnan(k64[0]).all() and np.isfinite(k64[1:]).any()
    assert np.isfinite(k64).any() and np.isnan(k64).any()


@pytest.mark.parametrize("n_points", [200, 2000, 20000])
@pytest.mark.parametrize("mode_mult", [1.0, -1.0])
def test_sweep_cursor_on_flat_and_repeated_nodes(cuda, mode_mult, n_points):
    """The sweep's cursor on a non-uniform grid with a repeated node (a
    zero-width segment, 1/dalt = 0), a stretch where den, |B| and psi are
    flat, and the flat extension above each peak, against the plain
    segment sweep; a warp per pair at P = 200, a block per pair above."""
    rng = np.random.default_rng(5)
    alt = np.sort(rng.uniform(90.0, 550.0, 300))
    alt[0], alt[-1] = 90.0, 550.0
    alt[120] = alt[119]                                  # repeated node
    B = 3
    hm = np.array([[280.0], [310.0], [330.0]])
    den = np.array([[2.5e12], [1.5e12], [3e12]]) * np.exp(
        -(alt - hm) ** 2 / (2 * 60.0 ** 2))
    den[:, 40:60] = den[:, 40:41]                        # flat stretch
    bmag = np.full((B, alt.size), 4e-5)
    bpsi = np.full((B, alt.size), 55.0)
    bpsi[:, 150:] = 62.0
    freqs = np.concatenate([[0.4], np.linspace(1.0, 18.0, 35)])
    args = (freqs, den, bmag, bpsi, alt)
    outs = {(dt, k): _ion_run(cuda, "sweep", mode_mult, args, n_points, dt,
                              k)
            for dt in (torch.float64, torch.float32) for k in (True, False)}
    _hold(outs[torch.float64, True], outs[torch.float32, True],
          outs[torch.float64, False], outs[torch.float32, False],
          _first_exceeds(freqs, den, bmag, mode_mult))


@pytest.mark.parametrize("kind,mode_mult", [("gather", 1.0), ("gather", -1.0),
                                            ("sweep", 1.0), ("sweep", -1.0)])
@pytest.mark.parametrize("n_points", [200, 20000])
def test_ionogram_kernel_nan_spans(cuda, kind, mode_mult, n_points):
    """Host-solve rows with a NaN span marked valid: the cursor and the
    uniform index put every point in segment 0 with a NaN fraction, so no
    point adds to the sum and vh is NaN; every other pair equals the
    kernel on the untouched rows bit for bit (the same layout)."""
    import dataclasses
    *args, _ = _ion_case("mix")
    for dtype in (torch.float64, torch.float32):
        t = [torch.as_tensor(a, dtype=dtype, device=cuda) for a in args]
        inv = None if kind == "sweep" else TV.uniform_inv_dalt(t[4])
        a = TV.prepare_kernel_args(kind, *t, mode_mult, n_points, inv)
        ref = TV.launch_kernel(a)
        span, valid = a.span.clone(), a.valid.clone()
        span[1, ::3] = float("nan")
        valid[1, ::3] = 1
        k = TV.launch_kernel(dataclasses.replace(a, span=span, valid=valid))
        hit = torch.zeros_like(valid, dtype=torch.bool)
        hit[1, ::3] = True
        assert torch.isnan(k[hit]).all()
        assert torch.equal(torch.isnan(k[~hit]), torch.isnan(ref[~hit]))
        fin = ~hit & ~torch.isnan(ref)
        assert fin.any() and torch.equal(k[fin], ref[fin])


def _bands(i0, tile):
    """(K-step-8 crossings, tiles with all 16 offsets) of the [B, F, P]
    segment indices over tiles of ``tile`` points (the last tile of each
    frequency ragged, padded with -1)."""
    B, F, P = i0.shape
    i0 = torch.cat([i0, i0.new_full((B, F, -P % tile), -1)], 2)
    t = i0.reshape(B, F, -1, tile)
    inp = t >= 0
    col = torch.div(t, 16, rounding_mode="floor")
    lo = torch.where(inp, col, 1 << 30).amin(-1)
    hi = torch.where(inp, col, -1).amax(-1)
    cross = int(((hi >= 0) & (lo // 8 != hi // 8)).sum())
    offs = sum(((t - 16 * col == k) & inp).any(-1).long() for k in range(16))
    return cross, int((offs == 16).sum())


@pytest.mark.parametrize("n_points", [37, 200])
@pytest.mark.parametrize("mode_mult", [1.0, -1.0])
def test_mxu_kernel_equals_kernel3_bitwise_on_band_edges(cuda, n_points,
                                                         mode_mult):
    """The mxu kernel, which multiplies only over the band of the table
    each tile of points selects, equals kernel 3 bit for bit (NaN-aware),
    f32 and f64, on the same prepared inputs, with: tiles whose band
    crosses a K-step boundary (profile 1's spans put segment 128, column 8,
    inside the stretched grid), tiles that select all 16 offsets (a linear
    grid on which profile 1's points step one segment each), P no multiple
    of the tile (37, 200), K1 = 15 (N = 231: no multiple of 8), a profile
    whose every frequency is invalid (2) and NaN spans (3)."""
    import dataclasses
    args = _case(True)
    inv = TV.uniform_inv_dalt(args[4])                 # 1/dalt, dalt = 2 km
    lin = (np.arange(n_points) + 8.5) * (2.0 / 300.0)
    found = {16: [0, 0], 32: [0, 0]}
    for grid in ("stretched", "linear"):
        for dtype in (torch.float32, torch.float64):
            t = [torch.as_tensor(a, dtype=dtype, device=cuda) for a in args]
            a = TV.prepare_kernel_args("mxu", *t, mode_mult, n_points, inv)
            F = a.span.shape[1]
            span, valid = a.span.clone(), a.valid.clone()
            over = dict(span=span, valid=valid)
            if grid == "linear":                       # i0 = p + 8
                span[1] = 300.0
                over.update({k: torch.as_tensor(v, dtype=dtype, device=cuda)
                              for k, v in (("mult", lin), ("omm", 1.0 - lin),
                                           ("dmult", np.append(np.diff(lin),
                                                               0.0)))})
            else:
                span[1] = torch.linspace(250.0, 320.0, F, dtype=dtype)
            valid[1] = 1
            valid[2] = 0
            span[3, ::3] = float("nan")
            valid[3] = 1
            a = dataclasses.replace(a, **over)
            g = dataclasses.replace(
                TV.prepare_kernel_args("gather", *t, mode_mult, n_points,
                                       inv), **over)
            assert a.tab.shape[2] == 15
            i0, _ = TV._uniform_index(span[:, :, None] * (a.mult * inv), 231)
            for tile in (16, 32):
                bands = _bands(torch.where(valid[:, :, None] != 0, i0, -1),
                               tile)
                found[tile] = [u + v for u, v in zip(found[tile], bands)]
            TV.reset_counters()
            k = TV.launch_mxu(a)
            ref = TV.launch_kernel(g)
            assert TV.LAUNCHES["mxu"] == 1 and TV.LAUNCHES["gather"] == 1
            nan = torch.isnan(k)
            assert torch.equal(nan, torch.isnan(ref)), (grid, dtype)
            assert torch.equal(k[~nan], ref[~nan]), (grid, dtype)
            assert nan[2].all() and (~nan[1]).any() and (~nan[0]).any()
    # K-step crossings, tiles with all 16 offsets, for each tile size
    assert all(c > 0 and f > 0 for c, f in found.values()), found


def test_engine_pallas_mxu_launches_on_numpy_input(cuda):
    """numpy input with ``engine="pallas_mxu"`` lands on the card and
    launches the mxu kernel; no plain version runs."""
    from pyrayhf_tpu_torch.forward import vertical_forward_operator_batch
    TV.reset_counters()
    vh = vertical_forward_operator_batch(*_case(True), mode="X",
                                         engine="pallas_mxu")
    assert vh.device.type == "cuda" and vh.dtype == torch.float64
    assert TV.LAUNCHES["mxu"] == 1
    assert sum(TV.PLAIN_CALLS.values()) == 0


def test_lm_retrieval_on_the_card_equals_the_cpu(cuda):
    """A short batched LM retrieval (f64) on the card equals the same call
    on the CPU: the fits within rtol 1e-8 (the same accept decisions; the
    sweep and the normal equations sum in another order)."""
    from pyrayhf_tpu_torch.retrieval import retrieve_gradient_batch
    alt = np.linspace(80.0, 699.0, 310)
    freq = np.arange(2.0, 12.01, 0.5)
    F1 = {"Nm": 7.80902301e+11, "P": 0.91422852, "hm": 219.26637887}
    E = {"Nm": 1.2846662e+11, "hm": 110.0, "B_bot": 5.0, "B_top": 7.0}
    bmag, bpsi = np.full(alt.size, 3e-5), np.full(alt.size, 70.0)
    from pyrayhf_tpu_torch.retrieval import model_VH
    truths = [(340.0, 42.0), (360.0, 47.0)]
    obs = np.stack([model_VH({"Nm": 1.5e12, "hm": h, "B_bot": b,
                              "B_top": 40.0}, F1, E, freq, alt, bmag, bpsi,
                             device="cpu")[0].numpy() for h, b in truths])
    guess = {"Nm": 1.5e12, "hm": np.array([330.0, 350.0]),
             "B_bot": np.array([45.0, 44.0]), "B_top": 40.0}
    fits = [retrieve_gradient_batch(guess, F1, E, freq, obs, alt, bmag,
                                    bpsi, steps=3, retries=0, device=dev)
            for dev in ("cpu", cuda)]
    assert fits[1][0].device.type == "cuda"
    for k in ("hm", "B_bot", "Nm"):
        np.testing.assert_allclose(fits[1][2][k], fits[0][2][k], rtol=1e-8)
    np.testing.assert_allclose(fits[1][3], fits[0][3], rtol=1e-8)


def _fan_case(mode, nz=101, nx=17, freqs=(5e6, 9e6), dtype=torch.float64):
    """tests/test_pallas_ray.py's small scene (on an nz × nx grid): the
    host grids and the [F, nz, nx] μ, μ', κ on the card."""
    from pyrayhf_tpu_torch import oblique
    z = np.linspace(0.0, 400.0, nz)
    x = np.linspace(0.0, 2000.0, nx)
    h = (z[:, None] - 250.0) / 45.0
    ne = 8.0e11 * (1.0 + 0.15 * (x[None, :] / x[-1] - 0.5)) * np.exp(
        0.5 * (1.0 - h - np.exp(-h)))
    nu = 1e7 * np.exp(-(z - 70.0) / 8.0)
    t = [torch.as_tensor(a, dtype=dtype, device="cuda")
         for a in (list(freqs), ne, np.full(ne.shape, 4.5e-5),
                   np.full(ne.shape, np.deg2rad(30.0)), nu)]
    return z, x, oblique._fan_fields(*t, mode)


@pytest.mark.parametrize("geometry,mode,n_hops", [("cartesian", "O", 1),
                                                  ("spherical", "O", 1),
                                                  ("cartesian", "X", 2)])
def test_fan_kernel_matches_plain(cuda, geometry, mode, n_hops):
    """f64: identical status codes, landing masks and step counts; every
    output within rtol 1e-8, atol 1e-10 (tests/test_pallas_ray.py:58)."""
    import pyrayhf_tpu_torch.pallas_ray as TR
    z, x, fields = _fan_case(mode)
    geo = TR.fan_geometry(z, x, geometry)
    tab = TR.pack_tables(geo, *fields)
    elevs = torch.linspace(8.0, 60.0, 160, dtype=torch.float64, device=cuda)
    ds = torch.tensor(10.0, dtype=torch.float64, device=cuda)
    TR.reset_counters()
    k = TR.launch_fan(geo, tab, elevs, ds, n_steps=400, n_hops=n_hops)
    torch.cuda.synchronize()
    p = TR.plain_fan(geo, tab, elevs, ds, n_steps=400, n_hops=n_hops)
    assert TR.LAUNCHES["fan_2d"] == 1
    for key in ("status_code", "steps_taken"):
        assert torch.equal(k[key], p[key]), key
    assert torch.equal(torch.isnan(k["ground_range_km"]),
                       torch.isnan(p["ground_range_km"]))
    for key in TR.OUTPUTS:
        assert torch.allclose(k[key], p[key], rtol=1e-8, atol=1e-10,
                              equal_nan=True), key


# the kernel's two paths: 101 x 17 tables fit a block's shared memory in
# f32 and f64, 401 x 61 in neither
FAN_PATHS = {"shared": (101, 17), "global": (401, 61)}
# (geometry, mode, n_hops, frequencies, E): an E that is no multiple of the
# block, an E below one block, one frequency through a ground bounce
FAN_SHAPES = {"ragged_E100": ("cartesian", "O", 1, (5e6, 9e6), 100),
              "small_E24_sph": ("spherical", "O", 1, (5e6, 9e6), 24),
              "F1_x_2hop": ("cartesian", "X", 2, (7e6,), 70)}


@pytest.mark.parametrize("shape", list(FAN_SHAPES))
@pytest.mark.parametrize("path", list(FAN_PATHS))
def test_fan_kernel_paths_and_edges(cuda, path, shape):
    """Each path of the kernel, at ragged and small shapes, against the
    plain version on the same tables: f64 identical status codes, step
    counts and landing masks, rtol 1e-8, atol 1e-10; f32 identical status
    codes, step counts and landing masks, rtol 1e-4, atol 1e-6."""
    import pyrayhf_tpu_torch.pallas_ray as TR
    geometry, mode, n_hops, freqs, E = FAN_SHAPES[shape]
    for dtype in (torch.float64, torch.float32):
        z, x, fields = _fan_case(mode, *FAN_PATHS[path], freqs, dtype)
        geo = TR.fan_geometry(z, x, geometry)
        assert TR.fan_path(geo, dtype) == path
        tab = TR.pack_tables(geo, *fields)
        elevs = torch.linspace(8.0, 60.0, E, dtype=dtype, device=cuda)
        ds = torch.tensor(10.0, dtype=dtype, device=cuda)
        TR.reset_counters()
        k = TR.launch_fan(geo, tab, elevs, ds, n_steps=400, n_hops=n_hops)
        torch.cuda.synchronize()
        p = TR.plain_fan(geo, tab, elevs, ds, n_steps=400, n_hops=n_hops)
        assert TR.LAUNCHES["fan_2d"] == 1
        assert k["status_code"].shape == (len(freqs), E)
        for key in ("status_code", "steps_taken"):
            assert torch.equal(k[key], p[key]), (dtype, key)
        assert torch.equal(torch.isnan(k["ground_range_km"]),
                           torch.isnan(p["ground_range_km"]))
        assert (k["status_code"] == 1).any()
        # f32: the four path sums add in another order in the plain
        # version (rtol); a landed ray ends 1e-3 km below the ground,
        # where f32 round-off of the backtrack is large relative to z
        # (atol 1e-6, in the outputs' own units: km, s, dB)
        tol = (dict(rtol=1e-8, atol=1e-10) if dtype == torch.float64
               else dict(rtol=1e-4, atol=1e-6))
        for key in TR.OUTPUTS:
            assert torch.allclose(k[key].double(), p[key].double(),
                                  equal_nan=True, **tol), (dtype, key)


def test_fan_launch_refuses_bad_tables(cuda):
    """A table of the wrong length, or one not 16-byte aligned, raises
    before any launch."""
    import pyrayhf_tpu_torch.pallas_ray as TR
    z, x, fields = _fan_case("O")
    geo = TR.fan_geometry(z, x, "cartesian")
    tab = TR.pack_tables(geo, *fields)
    elevs = torch.linspace(8.0, 60.0, 8, dtype=torch.float64, device=cuda)
    ds = torch.tensor(10.0, dtype=torch.float64, device=cuda)
    TR.reset_counters()
    with pytest.raises(ValueError, match="multiple"):
        TR.launch_fan(geo, tab[:-1], elevs, ds, n_steps=5)
    shifted = torch.empty(tab.numel() + 1, dtype=tab.dtype,
                          device=cuda)[1:]
    shifted.copy_(tab)
    with pytest.raises(ValueError, match="aligned"):
        TR.launch_fan(geo, shifted, elevs, ds, n_steps=5)
    assert TR.LAUNCHES["fan_2d"] == 0


# a check kernel built beside csrc/fan2d.cu (it includes it): div2 against
# the IEEE division on random f32 pairs, half of them random bit patterns
# (zeros, denormals, infinities and NaNs included), half with exponents
# near 1, an eighth of the numerators zero
_DIV2_CHECK = r"""
#include <stdint.h>
namespace {
__device__ uint32_t mix(uint64_t x) {
  x ^= x >> 33; x *= 0xff51afd7ed558ccdULL; x ^= x >> 33;
  x *= 0xc4ceb9fe1a85ec53ULL; x ^= x >> 33; return (uint32_t)x;
}
__device__ bool same(float q, float r) {
  return __float_as_uint(q) == __float_as_uint(r) || (isnan(q) && isnan(r));
}
__global__ void div2_check(uint64_t n, uint64_t seed,
                           unsigned long long* bad) {
  unsigned long long nb = 0;
  for (uint64_t i = blockIdx.x * (uint64_t)blockDim.x + threadIdx.x; i < n;
       i += (uint64_t)gridDim.x * blockDim.x) {
    const uint32_t u = mix(2 * i + seed), v = mix(2 * i + 1 + seed);
    float a = __uint_as_float(u), b = __uint_as_float(v);
    if (i & 1) {
      a = __uint_as_float((u & 0x807fffffu) | ((100u + (u >> 27)) << 23));
      b = __uint_as_float((v & 0x807fffffu) | ((100u + (v >> 27)) << 23));
    }
    if ((i & 7) == 2) a = 0.0f * a;
    float q1, q2;
    div2(a, -a, b, q1, q2);
    nb += !(same(q1, a / b) && same(q2, -a / b));
  }
  atomicAdd(bad, nb);
}
}  // namespace
extern "C" int div2_mismatches(unsigned long long n, unsigned long long seed,
                               unsigned long long* out) {
  unsigned long long* d;
  cudaMalloc(&d, sizeof(*d));
  cudaMemset(d, 0, sizeof(*d));
  div2_check<<<528, 256>>>(n, seed, d);
  cudaMemcpy(out, d, sizeof(*d), cudaMemcpyDeviceToHost);
  cudaFree(d);
  return (int)cudaGetLastError();
}
"""


def test_fan_paired_division_is_ieee(cuda, tmp_path):
    """The fan kernel's paired f32 division (div2) gives the IEEE quotient
    bit for bit on 2^29 random pairs, on its fast path and off it."""
    from pyrayhf_tpu_torch import cuda_ext
    src = tmp_path / "div2_check.cu"
    src.write_text(f'#include "{cuda_ext.SRC_DIR / "fan2d.cu"}"\n'
                   + _DIV2_CHECK)
    so = tmp_path / "div2_check.so"
    r = subprocess.run([str(cuda_ext.find_nvcc()), *cuda_ext.NVCC_FLAGS,
                        "-shared", "-o", str(so), str(src)],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-3000:]
    lib = ctypes.CDLL(str(so))
    lib.div2_mismatches.argtypes = [ctypes.c_ulonglong, ctypes.c_ulonglong,
                                    ctypes.POINTER(ctypes.c_ulonglong)]
    for seed in (1, 0x9E3779B97F4A7C15):
        bad = ctypes.c_ulonglong(0)
        assert lib.div2_mismatches(1 << 28, seed, ctypes.byref(bad)) == 0
        assert bad.value == 0, (seed, bad.value)


def test_fan_wrapper_on_the_card(cuda):
    """The wrapper launches on CUDA tensors, refuses gradients and
    interpret mode, and numpy slices land on the card."""
    import pyrayhf_tpu_torch.pallas_ray as TR
    from pyrayhf_tpu_torch import synthesize_oblique_ionogram_2d
    z, x, (mu, mup, kap) = _fan_case("O")
    elevs = torch.linspace(8.0, 60.0, 24, dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="no backward"):
        TR.fan_2d_pallas(z, x, mu.clone().requires_grad_(True), mup, kap,
                         elevs, 10.0, n_steps=10)
    with pytest.raises(ValueError, match="interpret"):
        TR.fan_2d_pallas(z, x, mu, mup, kap, elevs, 10.0, n_steps=10,
                         interpret=True)
    h = (z[:, None] - 250.0) / 45.0
    ne = 8.0e11 * np.exp(0.5 * (1.0 - h - np.exp(-h))) * np.ones((1, 17))
    TR.reset_counters()
    out = synthesize_oblique_ionogram_2d(
        [6e6, 8e6], 800.0, x, z, ne, np.full(ne.shape, 4.5e-5),
        np.full(ne.shape, 30.0), n_elev=24, step_km=10.0, s_max_km=2500.0)
    assert out["fan_range_km"].device.type == "cuda"
    assert TR.LAUNCHES["fan_2d"] == 1 and TR.PLAIN_CALLS["fan_2d"] == 0


def test_oblique_entry_on_the_card_launches_once_and_reads_once(
        cuda, monkeypatch):
    """``synthesize_oblique_ionogram_2d(engine="auto")`` in f64 on CUDA
    tensors at a small slice: one table-kernel and one fan-kernel launch
    and no plain version; its spans, recorded by a stand-in for
    ``profiling.span``, are the tables (their allocation), the fields (the
    table kernel's launch), the launch with the path's one
    ``pyrayhf.host_read`` (the step's read) inside it, and the homing, in
    that order, inside ``pyrayhf.oblique``; the outputs within 1e-8
    relative of the plain version's on the CPU. (No profiler session
    here: one, even CPU-only, this early in the file made the later
    profiled tests of this file lose device events.)"""
    import contextlib

    import pyrayhf_tpu_torch._util as U
    import pyrayhf_tpu_torch.oblique as OB
    import pyrayhf_tpu_torch.pallas_ray as TR
    from pyrayhf_tpu_torch import synthesize_oblique_ionogram_2d
    z, x = np.linspace(0.0, 400.0, 101), np.linspace(0.0, 2000.0, 17)
    h = (z[:, None] - 250.0) / 45.0
    ne = 8.0e11 * (1.0 + 0.15 * (x[None, :] / x[-1] - 0.5)) * np.exp(
        0.5 * (1.0 - h - np.exp(-h)))
    host = [ne, np.full(ne.shape, 4.5e-5), np.full(ne.shape, 30.0)]

    def call(dev):
        t = [torch.as_tensor(a, dtype=torch.float64, device=dev)
             for a in host]
        return synthesize_oblique_ionogram_2d(
            [6e6, 8e6], 800.0, x, z, *t, n_elev=24, step_km=10.0,
            s_max_km=2500.0, engine="auto")

    seen = []

    @contextlib.contextmanager
    def record(name):
        seen.append("+" + name.removeprefix("pyrayhf."))
        yield
        seen.append("-" + name.removeprefix("pyrayhf."))

    for mod in (U, OB, TR):
        monkeypatch.setattr(mod, "span", record)
    TR.reset_counters()
    on = call(cuda)
    torch.cuda.synchronize()
    assert TR.LAUNCHES == {"fan_2d": 1, "fan_tables": 1}
    assert sum(TR.PLAIN_CALLS.values()) == 0
    assert seen == ["+oblique", "+fan_pack", "-fan_pack", "+fan_fields",
                    "-fan_fields", "+fan_launch", "+host_read", "-host_read",
                    "-fan_launch", "+homing", "-homing", "-oblique"]
    monkeypatch.undo()
    cpu = call("cpu")
    assert torch.isfinite(cpu["delay_low_sec"]).any()
    for k in ("fan_range_km", "fan_delay_sec", "delay_low_sec",
              "delay_high_sec", "absorption_low_db"):
        torch.testing.assert_close(on[k].cpu(), cpu[k], rtol=1e-8,
                                   atol=1e-12, equal_nan=True)


def test_fan_kernel_on_a_two_node_x_axis(cuda):
    """An x axis of 2 nodes (one cell across; the JAX package's kernel
    clamps the cell index to it too), on both of the kernel's paths: the
    kernel against the plain version on the same tables, as
    test_fan_kernel_paths_and_edges holds them; rays land."""
    import pyrayhf_tpu_torch.pallas_ray as TR
    for path, nz in (("shared", 137), ("global", 12001)):
        for dtype in (torch.float64, torch.float32):
            z, x, fields = _fan_case("O", nz, 2, (5e6, 7e6), dtype)
            geo = TR.fan_geometry(z, x, "cartesian")
            assert TR.fan_path(geo, dtype) == path
            tab = TR.pack_tables(geo, *fields)
            elevs = torch.linspace(8.0, 60.0, 16, dtype=dtype, device=cuda)
            ds = torch.tensor(10.0, dtype=dtype, device=cuda)
            TR.reset_counters()
            k = TR.launch_fan(geo, tab, elevs, ds, n_steps=400)
            torch.cuda.synchronize()
            p = TR.plain_fan(geo, tab, elevs, ds, n_steps=400)
            assert TR.LAUNCHES["fan_2d"] == 1
            for key in ("status_code", "steps_taken"):
                assert torch.equal(k[key], p[key]), (path, dtype, key)
            assert (k["status_code"] == 1).any()
            tol = (dict(rtol=1e-8, atol=1e-10) if dtype == torch.float64
                   else dict(rtol=1e-4, atol=1e-6))
            for key in TR.OUTPUTS:
                assert torch.allclose(k[key].double(), p[key].double(),
                                      equal_nan=True, **tol), (path, dtype,
                                                               key)


def test_fan_kernel_on_more_frequencies_than_a_grid_row(cuda):
    """65,537 frequencies in one launch (more than a launch grid's y
    extent), f64, against the plain version: identical status codes, step
    counts and landing masks, rtol 1e-8, atol 1e-10."""
    import pyrayhf_tpu_torch.pallas_ray as TR
    F = 65537
    z, x, fields = _fan_case("O", 16, 8, tuple(np.linspace(2e6, 30e6, F)))
    geo = TR.fan_geometry(z, x, "cartesian")
    tab = TR.pack_tables(geo, *fields)
    elevs = torch.tensor([10.0, 60.0], dtype=torch.float64, device=cuda)
    ds = torch.tensor(10.0, dtype=torch.float64, device=cuda)
    TR.reset_counters()
    k = TR.launch_fan(geo, tab, elevs, ds, n_steps=64)
    p = TR.plain_fan(geo, tab, elevs, ds, n_steps=64)
    assert TR.LAUNCHES["fan_2d"] == 1 and k["status_code"].shape == (F, 2)
    for key in ("status_code", "steps_taken"):
        assert torch.equal(k[key], p[key]), key
    assert torch.equal(torch.isnan(k["ground_range_km"]),
                       torch.isnan(p["ground_range_km"]))
    for key in TR.OUTPUTS:
        assert torch.allclose(k[key], p[key], rtol=1e-8, atol=1e-10,
                              equal_nan=True), key


# ---- the fan's tables from the slice (csrc/fan_tables.cu) ---------------

def _bits_equal(a, b):
    """Bit for bit, a NaN counting as one value whatever its payload."""
    ints = torch.int64 if a.dtype == torch.float64 else torch.int32
    na, nb = torch.isnan(a), torch.isnan(b)
    return (torch.equal(na, nb)
            and torch.equal(a.view(ints)[~na], b.view(ints)[~nb]))


def _table_slice(nz, nx, dtype, babs="earth", seed=0):
    """Host grids (0-400 km x 0-2,000 km) and the table kernel's inputs on
    the card: a Chapman layer with a seeded tilt along x and free space on
    the ground row, ψ over the whole circle node by node, ν(z), and 4
    frequencies 2-12 MHz, the last at one node's plasma frequency (X = 1
    exactly there). ``babs``: "earth" (20-60 µT node by node); "zero"
    (|B| = 0); "tiny" (0 but one node at 1e-19 T: |Y| <= 1.4e-15 at every
    frequency); "tiny_one" (the same, the first frequency 1 Hz: |Y| >=
    1e-12 at that frequency and node alone); "nan_some" (0 but one NaN
    node); "all_nan"."""
    rng = np.random.default_rng(seed)
    z, x = np.linspace(0.0, 400.0, nz), np.linspace(0.0, 2000.0, nx)
    h = (z[:, None] - 250.0) / 45.0
    ne = 8e11 * (1 + 0.3 * rng.uniform(-1, 1, (1, nx))) * np.exp(
        0.5 * (1 - h - np.exp(-h)))
    ne[0] = 0.0
    bm = rng.uniform(2e-5, 6e-5, (nz, nx))
    if babs != "earth":
        bm[:] = np.nan if babs == "all_nan" else 0.0
        bm[nz // 2, nx // 2] = np.nan if babs == "nan_some" else (
            1e-19 if babs.startswith("tiny") else bm[0, 0])
    t = [torch.as_tensor(a, dtype=dtype, device="cuda")
         for a in (np.linspace(2e6, 12e6, 4), ne, bm,
                   rng.uniform(-180.0, 180.0, (nz, nx)),
                   1e7 * np.exp(-(z - 70.0) / 8.0))]
    t[0][-1] = (torch.sqrt(t[1]) * 8.97866275)[nz // 2, nx // 3]
    if babs == "tiny_one":
        t[0][0] = 1.0
    return z, x, t


def _tables_both_ways(z, x, t, mode, geometry):
    """(the kernel's table, pack_tables of _fan_fields) on the same inputs,
    with the launch counted once and no plain version."""
    import pyrayhf_tpu_torch.oblique as OB
    import pyrayhf_tpu_torch.pallas_ray as TR
    geo = TR.fan_geometry(z, x, geometry)
    TR.reset_counters()
    got = TR.fan_tables(geo, *t, mode)
    assert TR.LAUNCHES["fan_tables"] == 1
    assert sum(TR.PLAIN_CALLS.values()) == 0
    want = TR.pack_tables(geo, *OB._fan_fields(*t, mode))
    return geo, got, want


# (mode, geometry, nz, nx): tiles of 8 x 32 nodes; grids no multiple of
# them, last tiles one node deep (nz = 8k + 1, nx = 32k + 1, where the
# edge stencils reach two nodes back), 2-node axes, the benchmark's slice
TABLE_GRIDS = [("O", "cartesian", 13, 37), ("X", "spherical", 17, 33),
               ("O", "spherical", 9, 65), ("X", "cartesian", 41, 70),
               ("O", "cartesian", 2, 2), ("X", "cartesian", 2, 40),
               ("O", "spherical", 40, 2), ("O", "cartesian", 621, 800)]


@pytest.mark.parametrize("mode,geometry,nz,nx", TABLE_GRIDS)
def test_fan_tables_equal_the_fields_and_pack_tables(cuda, mode, geometry,
                                                     nz, nx):
    """The table kernel against ``pack_tables(_fan_fields(...))`` on the
    card, bit for bit in f64 and f32 (NaN as one value): every IEEE
    operation in the same order, the Python constants cast as torch casts
    them; the four edges and corners take the one-sided stencils, the
    ground row is evanescent for mode X and free space for O, one node
    sits at X = 1 exactly."""
    import pyrayhf_tpu_torch.pallas_ray as TR
    for dtype in (torch.float64, torch.float32):
        z, x, t = _table_slice(nz, nx, dtype)
        geo, got, want = _tables_both_ways(z, x, t, mode, geometry)
        assert got.shape == want.shape == (5 * 4 * nz * nx,)
        assert got.data_ptr() % 16 == 0
        rec, kap = TR.table_views(geo, got)
        for c in range(4):
            assert _bits_equal(rec[..., c],
                               TR.table_views(geo, want)[0][..., c]), (
                dtype, c)
        assert _bits_equal(kap, TR.table_views(geo, want)[1]), dtype
        nan_mu = torch.isnan(rec[..., 0])
        assert nan_mu.any() and (~nan_mu).any()
        assert (kap[nan_mu] == 0).all() and torch.isfinite(kap).all()
        X = (torch.sqrt(t[1]) * 8.97866275) ** 2 / t[0][-1] ** 2
        assert (X == 1).any()


@pytest.mark.parametrize("babs", ["zero", "tiny", "tiny_one", "nan_some",
                                  "all_nan"])
@pytest.mark.parametrize("mode", ["O", "X"])
def test_fan_tables_decide_the_unmagnetised_branch_as_find_mu_mup(
        cuda, babs, mode):
    """The unmagnetised branch, decided on the card once over every
    (frequency, node) as ``find_mu_mup`` decides it over [F, nz, nx]: |B|
    = 0, or 0 with one node of 1e-19 T, takes it; one frequency of 1 Hz at
    that node keeps the whole slice magnetised; a NaN node is left out; an
    all-NaN |B| does not take it. The table bit for bit the composition's,
    f64 and f32; the magnetised formula at |B| = 0 gives μ' NaN (β = 0),
    the unmagnetised one 1/μ, so the branch shows in μ'."""
    import pyrayhf_tpu_torch.pallas_ray as TR
    unmag = babs in ("zero", "tiny", "nan_some")
    for dtype in (torch.float64, torch.float32):
        z, x, t = _table_slice(19, 45, dtype, babs)
        geo, got, want = _tables_both_ways(z, x, t, mode, "cartesian")
        assert _bits_equal(got, want), (dtype, babs)
        rec = TR.table_views(geo, got)[0]
        mu, mup = rec[..., 0], rec[..., 3]
        lit = torch.isfinite(mu) & (mu > 0)
        if unmag:
            assert lit.any() and torch.isfinite(mup[lit]).all(), dtype
        else:
            assert not torch.isfinite(mup[lit]).all() or not lit.any(), dtype


def test_fan_tables_refuse_what_the_kernel_cannot_take(cuda):
    """Derivatives, a transform, mixed dtypes and wrong shapes raise before
    any launch: the kernel reads raw pointers."""
    import pyrayhf_tpu_torch.pallas_ray as TR
    z, x, t = _table_slice(13, 37, torch.float64)
    geo = TR.fan_geometry(z, x, "cartesian")
    TR.reset_counters()
    with pytest.raises(ValueError, match="no derivative"):
        TR.fan_tables(geo, t[0], t[1].clone().requires_grad_(True), *t[2:],
                      "O")
    with pytest.raises(ValueError, match="no derivative"):
        torch.func.vmap(lambda ne: TR.fan_tables(
            geo, t[0], ne, *t[2:], "O"))(torch.stack([t[1], t[1]]))
    with pytest.raises(ValueError, match="share dtype"):
        TR.fan_tables(geo, t[0].float(), *t[1:], "O")
    with pytest.raises(ValueError, match="bad fan inputs"):
        TR.fan_tables(geo, t[0], t[1][:, :-1], *t[2:], "O")
    with pytest.raises(ValueError, match="Mode"):
        TR.fan_tables(geo, *t, "Z")
    assert TR.LAUNCHES["fan_tables"] == 0


@pytest.mark.parametrize("mode,geometry", [("O", "cartesian"),
                                           ("X", "spherical")])
def test_oblique_entry_takes_the_tables_from_the_slice(
        cuda, monkeypatch, mode, geometry):
    """``synthesize_oblique_ionogram_2d(engine="auto")``, f64, at a reduced
    slice (161 x 120 nodes, 6 frequencies x 48 elevations): one table and
    one fan launch a call, no plain version, and every output bit for bit
    what the route through the [F, nz, nx] fields and ``fan_2d_pallas``
    (the one ``torch.func`` transforms take) gives."""
    import pyrayhf_tpu_torch.pallas_ray as TR
    from pyrayhf_tpu_torch import synthesize_oblique_ionogram_2d
    _, x, t = _table_slice(161, 120, torch.float64)
    z = np.linspace(0.0, 640.0, 161)
    h = (z[:, None] - 300.0) / 50.0
    ne = torch.as_tensor(1e12 * (1.0 + 0.2 * x[None, :] / x[-1]) * np.exp(
        0.5 * (1.0 - h - np.exp(-h))), device=cuda)

    def call():
        return synthesize_oblique_ionogram_2d(
            np.linspace(3e6, 12e6, 6), 1000.0, x, z, ne, t[2], t[3],
            mode=mode, geometry=geometry, n_elev=48, step_km=5.0,
            s_max_km=3000.0, engine="auto")

    TR.reset_counters()
    new = [call() for _ in range(2)][1]
    assert TR.LAUNCHES == {"fan_2d": 2, "fan_tables": 2}
    assert sum(TR.PLAIN_CALLS.values()) == 0
    monkeypatch.setattr(TR, "_transformed", lambda *ts: True)
    TR.reset_counters()
    old = call()
    assert TR.LAUNCHES == {"fan_2d": 1, "fan_tables": 0}
    assert TR.PLAIN_CALLS == {"fan_2d": 0, "fan_tables": 1}
    assert set(new) == set(old)
    for k in old:
        assert _bits_equal(new[k], old[k]), k
    assert torch.isfinite(new["delay_low_sec"]).any()
    assert torch.isfinite(new["fan_range_km"]).any()


def test_oblique_fan_under_vmap_on_the_card_counts_its_plain_tables(cuda):
    """``torch.func.vmap`` of the 2-D fan over two slices on the card: the
    tables are built by their plain version (``_fan_fields`` and
    ``pack_tables``, counted once in ``PLAIN_CALLS["fan_tables"]``), the
    fan kernel runs once over the folded frequencies, and each row is bit
    for bit the unbatched call's (whose tables the table kernel writes);
    an input that requires grad raises before any table or launch."""
    import pyrayhf_tpu_torch.pallas_ray as TR
    from pyrayhf_tpu_torch.oblique import _fan_2d_fn
    z, x, t = _table_slice(41, 70, torch.float64)
    fan = _fan_2d_fn(z, x, "O", "cartesian", 16, 200, 1, engine="auto")
    lims = torch.tensor([5.0, 60.0], dtype=torch.float64, device=cuda)

    def run(ne):
        return torch.stack(fan(t[0], lims, ne, *t[2:], 10.0)[:5])

    stack = torch.stack([t[1], 0.8 * t[1]])
    TR.reset_counters()
    out = torch.func.vmap(run)(stack)
    assert TR.LAUNCHES == {"fan_2d": 1, "fan_tables": 0}
    assert TR.PLAIN_CALLS == {"fan_2d": 0, "fan_tables": 1}
    TR.reset_counters()
    for v in range(2):
        assert _bits_equal(out[v], run(stack[v])), v
    assert TR.LAUNCHES == {"fan_2d": 2, "fan_tables": 2}
    assert torch.isfinite(out).any()
    TR.reset_counters()
    with pytest.raises(ValueError, match="no backward"):
        run(t[1].clone().requires_grad_(True))
    assert sum(TR.LAUNCHES.values()) == sum(TR.PLAIN_CALLS.values()) == 0


# ---- kernels 2 and 3 at the cutoffs (csrc/ionogram.cu gather_kernel) ----

def _razor_freqs(den, bmag, alt, dtype, cuda):
    """Frequencies [Hz] at each profile's node cutoffs fx_j and prefix
    maxima cfx_j times (1 ± n ulp), n ≤ 4, in ``dtype`` (kernel 2's
    bracket meets its exact test there)."""
    t = [torch.as_tensor(x, dtype=dtype, device=cuda)
         for x in (np.array([5.0]), den, bmag, np.full_like(den, 45.0), alt)]
    a = TV.prepare_kernel_args("gather_xsolve", *t, -1.0, 200,
                               TV.uniform_inv_dalt(t[4]))
    fx, cfx = TV.cutoff_frequencies(a), TV.cutoff_table(a)
    nodes = torch.arange(0, fx.shape[1], 11, device=cuda)
    base = torch.cat([fx[:, nodes], cfx[:, nodes]]).flatten()
    base = base[torch.isfinite(base) & (base > 0)]
    fs, up, down = [base], base, base
    for _ in range(4):
        up = torch.nextafter(up, torch.full_like(up, np.inf))
        down = torch.nextafter(down, torch.full_like(down, -np.inf))
        fs += [up, down]
    return a, torch.unique(torch.cat(fs))


@pytest.mark.parametrize("kind", ["gather_xsolve", "gather"])
@pytest.mark.parametrize("n_points", [200, 2000])
def test_gather_kernels_at_cutoff_frequencies(cuda, kind, n_points):
    """Kernels 2 (the cutoff-frequency bracket, then the exact ballot
    scan) and 3 against their plain versions with frequencies on node
    cutoffs ± 4 ulp, on Chapman, E-above-valley, two-peak and constant-|B|
    profiles: f64 identical NaN masks and ≤ 1e-6 km; f32 identical NaN
    masks and ≤ 1e-3 km, or 4 f32 ulps of vh where that is more (at the
    gyrofrequency of a constant-|B| profile vh reaches ~1e7 km); a warp
    per pair at P = 200, a block per pair at P = 2,000."""
    import dataclasses
    *args, _ = _ion_case("mix")
    freqs, den, bmag, bpsi, alt = args
    tp = np.stack([2.5e12 * np.exp(-(alt - 300.0) ** 2 / 6050.0)] * 2)
    tp[1] += 9e11 * np.exp(-(alt - 110.0) ** 2 / 200.0)
    den = np.concatenate([den, tp, den[:1]])
    bmag = np.concatenate([bmag, np.full((2, alt.size), 3.2e-5),
                           np.full((1, alt.size), 4.1e-5)])
    bpsi = np.concatenate([bpsi, bpsi[:3]])
    for dtype in (torch.float64, torch.float32):
        a2, f_hz = _razor_freqs(den, bmag, alt, dtype, cuda)
        t = [torch.as_tensor(x, dtype=dtype, device=cuda)
             for x in (f_hz.cpu().numpy() / 1e6, den, bmag, bpsi, alt)]
        a = TV.prepare_kernel_args(kind, *t, -1.0, n_points,
                                   TV.uniform_inv_dalt(t[4]))
        if kind == "gather_xsolve":
            a = dataclasses.replace(a, freq_hz=f_hz)
        k = TV.launch_kernel(a).double().cpu().numpy()
        p = TV.plain_ionogram(a).double().cpu().numpy()
        assert np.array_equal(np.isnan(k), np.isnan(p))
        m = np.isfinite(p)
        assert m.any() and (~m).any()
        tol = 1e-6 if dtype == torch.float64 else np.maximum(
            1e-3, 4 * np.finfo(np.float32).eps * np.abs(p[m]))
        assert (np.abs(k[m] - p[m]) <= tol).all()


@pytest.mark.parametrize("mode_mult", [1.0, -1.0])
def test_sharded_pallas_launches_once_per_block(cuda, mode_mult):
    """synthesize_ionograms_sharded(engine="pallas") on a 2×2 mesh of the
    one card: one sweep launch per block, no plain version, and the
    unsharded kernel's values bit for bit (both calls take a warp per
    pair here); interpret=True raises on CUDA tensors."""
    from pyrayhf_tpu_torch.parallel import (ionogram_mesh,
                                            synthesize_ionograms_sharded)
    freqs, den, bmag, bpsi, alt = _case(True)
    t = [torch.as_tensor(a, device=cuda) for a in (freqs[:-1], den, bmag,
                                                   bpsi, alt)]
    mesh = ionogram_mesh([cuda] * 4, batch_axis=2)
    mode = "O" if mode_mult > 0 else "X"
    TV.reset_counters()
    out = synthesize_ionograms_sharded(*t, mesh, mode=mode, engine="pallas")
    assert TV.LAUNCHES["sweep"] == 4 and sum(TV.PLAIN_CALLS.values()) == 0
    ref = TV.ionogram_pallas(*t, mode_mult=mode_mult)
    assert torch.equal(torch.isnan(out), torch.isnan(ref))
    m = torch.isfinite(ref)
    assert m.any() and torch.equal(out[m], ref[m])
    with pytest.raises(ValueError, match="interpret=True"):
        synthesize_ionograms_sharded(*t, mesh, engine="pallas",
                                     interpret=True)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_fan_vmap_folds_into_one_launch(cuda, dtype):
    """``torch.func.vmap`` of ``fan_2d_pallas`` over two field stacks: one
    fan launch over the folded [V·F, E] fan, bit for bit the two separate
    launches; forward mode under ``vmap`` still raises."""
    import pyrayhf_tpu_torch.pallas_ray as TR
    z, x, fields = _fan_case("O", dtype=dtype)
    stack = [torch.stack([f, f * s]) for f, s in zip(fields,
                                                      (0.995, 1.01, 1.2))]
    elevs = torch.linspace(8.0, 60.0, 24, dtype=dtype, device=cuda)

    def fan(mu, mup, kap):
        return TR.fan_2d_pallas(z, x, mu, mup, kap, elevs, 10.0,
                                n_steps=250)
    TR.reset_counters()
    out = torch.func.vmap(fan)(*stack)
    assert TR.LAUNCHES["fan_2d"] == 1 and TR.PLAIN_CALLS["fan_2d"] == 0
    for v in range(2):
        one = fan(*(s[v] for s in stack))
        for k in TR.OUTPUTS:
            assert torch.equal(torch.nan_to_num(out[k][v], nan=-7.0),
                               torch.nan_to_num(one[k], nan=-7.0)), k
    assert torch.isfinite(out["ground_range_km"]).any()
    with pytest.raises(ValueError, match="no backward and no forward"):
        torch.func.vmap(lambda m: torch.func.jvp(
            lambda mm: fan(mm, *fields[1:])["ground_range_km"], (m,),
            (torch.ones_like(m),)))(stack[0])


def test_jacfwd_of_jacfwd_through_kernel_2(cuda):
    """``jacfwd`` of ``jacfwd`` through the X gather (kernel 2) in (density
    scale, |B| scale), f64: one launch for the primal, no plain version,
    equal to the plain sweep's at rtol 1e-12; ``jvp`` of ``jvp`` keeps the
    kernel's primal bit for bit."""
    freqs, den, bmag, bpsi, alt = _case(False)
    t = [torch.as_tensor(a, device=cuda) for a in (freqs[1:-2], den[:2],
                                                   bmag[:2], bpsi[:2], alt)]

    def of_q(fn):
        def f(q):
            return fn(t[0], q[0] * t[1], q[1] * t[2], t[3], t[4],
                      mode_mult=-1.0, n_points=200)
        return f
    q0 = torch.ones(2, dtype=torch.float64, device=cuda)
    TV.reset_counters()
    hess = torch.func.jacfwd(torch.func.jacfwd(
        of_q(TV.ionogram_pallas_gather)))(q0)
    assert TV.LAUNCHES["gather_xsolve"] == 1
    assert TV.LAUNCHES["segment_table"] == 1
    assert sum(TV.LAUNCHES.values()) == 2
    assert sum(TV.PLAIN_CALLS.values()) == 0
    ref = torch.func.jacfwd(torch.func.jacfwd(
        of_q(TV.ionogram_fast_xla)))(q0)
    assert torch.equal(torch.isnan(hess), torch.isnan(ref))
    m = torch.isfinite(ref)
    assert m.any()
    assert torch.allclose(hess[m], ref[m], rtol=1e-12,
                          atol=1e-13 * float(ref[m].abs().max()))
    f = of_q(TV.ionogram_pallas_gather)
    plain = f(q0)
    primal = torch.func.jvp(lambda q: torch.func.jvp(f, (q,), (q0,))[0],
                            (q0,), (q0,))[0]
    assert torch.equal(torch.nan_to_num(primal, nan=-1.0),
                       torch.nan_to_num(plain, nan=-1.0))


def test_spans_of_one_auto_call_on_the_card(cuda, tmp_path):
    """One ``engine="auto"`` call, f64, under ``torch.profiler`` (CPU and
    CUDA): one each of the vertical operator's five spans (and none of
    the 2-D oblique path's); the kernel launched
    inside ``pyrayhf.launch`` (its runtime call matched to the
    ``gather_kernel`` device event by correlation id); every other
    device op launched inside ``pyrayhf.route`` or ``pyrayhf.prep``; the
    output bit for bit the call's without the profiler."""
    import json

    from pyrayhf_tpu_torch.forward import vertical_forward_operator_batch
    from pyrayhf_tpu_torch.profiling import SPANS
    vertical = ("pyrayhf.forward", "pyrayhf.route", "pyrayhf.prep",
                "pyrayhf.launch", "pyrayhf.host_read")
    args = [torch.as_tensor(a, dtype=torch.float64, device=cuda)
            for a in _case(False)]
    off = vertical_forward_operator_batch(*args, mode="O")
    # a fresh grid: the call misses its launch plan and reads the grid
    args[0], args[4] = args[0].clone(), args[4].clone()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        on = vertical_forward_operator_batch(*args, mode="O")
        torch.cuda.synchronize()
    assert torch.equal(on.view(torch.int64), off.view(torch.int64))
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"]
    spans = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e["name"] in SPANS:
            spans.setdefault(e["name"], []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    assert {k: len(v) for k, v in spans.items()} == dict.fromkeys(
        vertical, 1)
    launch_at = {e["args"]["correlation"]: float(e["ts"]) for e in events
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in e.get("args", {})}
    device = [e for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]

    def inside(name, t):
        (s, u), = spans[name]
        return s <= t <= u

    kernels = [e for e in device if "gather_kernel" in e["name"]]
    assert len(kernels) == 1
    assert inside("pyrayhf.launch",
                  launch_at[kernels[0]["args"]["correlation"]])
    others = [e for e in device if e is not kernels[0]]
    assert others
    for e in others:
        t = launch_at[e["args"]["correlation"]]
        assert inside("pyrayhf.route", t) or inside("pyrayhf.prep", t), \
            e["name"]
    (r0, r1), = spans["pyrayhf.route"]
    (h0, h1), = spans["pyrayhf.host_read"]
    assert r0 <= h0 <= h1 <= r1


@pytest.mark.parametrize("mode", ["O", "X"])
def test_a_repeat_auto_call_launches_the_table_and_the_kernel(
        cuda, mode, tmp_path):
    """A repeat ``engine="auto"`` call, f64, under ``torch.profiler``: its
    launch plan hit, no ``pyrayhf.host_read`` span, and on the card only
    the segment table and the gather kernel: no copy, no other op."""
    import json

    from pyrayhf_tpu_torch.forward import vertical_forward_operator_batch
    args = [torch.as_tensor(a, dtype=torch.float64, device=cuda)
            for a in _case(False)]
    vertical_forward_operator_batch(*args, mode=mode)
    torch.cuda.synchronize()
    TV.reset_counters()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        vertical_forward_operator_batch(*args, mode=mode)
        torch.cuda.synchronize()
    assert TV.PLANS == {"hit": 1, "miss": 0, "direct": 1}
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"]
    spans = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    assert "pyrayhf.route" in spans and "pyrayhf.host_read" not in spans
    device = sorted(e["name"] for e in events
                    if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    assert len(device) == 2, device
    assert any("segment_table_pack" in k for k in device), device
    assert any("gather_kernel" in k for k in device), device


def _table_profiles(case, dtype, dev):
    """(den, bmag, bpsi, alt) on the card for the segment-table kernel: 620
    nodes (three chunks of the block) unless the case says otherwise."""
    rng = np.random.default_rng(17)
    B, N = {"b1": (1, 620), "n2": (7, 2), "ragged": (37, 620),
            "long": (5, 2000)}.get(case, (6, 620))
    alt = np.linspace(80.0, 699.0, N)
    den = rng.uniform(1e11, 3e12, (B, N))
    bmag = rng.uniform(2e-5, 6e-5, (B, N))
    bpsi = rng.uniform(0.0, 90.0, (B, N))
    if case == "peak_first":
        den[:, 0] = 9e12
    elif case == "peak_last":
        den[:, -1] = 9e12
    elif case == "ties":
        den[0, [7, 300]] = 9e12
        den[1] = 5e11
        den[2, [0, N - 1]] = 9e12
        den[3, [250, 251]] = 9e12
    elif case == "nan":
        den[0, 411] = den[1, 0] = den[2, N - 1] = np.nan
        den[3, [5, 300]] = np.nan
        bmag[0, 3] = np.nan
    elif case == "signed_zeros":
        den = np.where(rng.uniform(size=(B, N)) < 0.5, -0.0, 0.0)
        den[:, -1] = 1.0
        bmag = np.where(rng.uniform(size=(B, N)) < 0.5, -0.0, 0.0)
        alt[5] = alt[4]                        # a zero step: 1/Δalt is 0
    t = [torch.as_tensor(a, dtype=dtype, device=dev)
         for a in (den, bmag, bpsi, alt)]
    if case == "expanded":
        t[2] = t[2][0].expand(B, N)            # one row for every profile
        t[1] = t[1].t().contiguous().t()       # column-major
    return t


def _same_bits(a, b):
    """Equal shapes, NaN at the same places, every other value the same
    bits (so +0 and -0 differ)."""
    ints = torch.int32 if a.dtype == torch.float32 else torch.int64
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    return (a.shape == b.shape and torch.equal(nan_a, nan_b)
            and torch.equal(torch.where(nan_a, 0, a.view(ints)),
                            torch.where(nan_b, 0, b.view(ints))))


@pytest.mark.parametrize("case", ["random", "peak_first", "peak_last",
                                  "ties", "nan", "signed_zeros", "b1", "n2",
                                  "ragged", "expanded", "long"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["gather_osolve", "gather_xsolve"])
def test_segment_table_kernel_is_the_plain_table(cuda, kind, dtype, case):
    """``csrc/segment_table.cu`` against the PyTorch composition it
    replaces, on the card: the same table bit for bit, NaN where it has
    NaN, the row padding zero; one launch counted."""
    prof = _table_profiles(case, dtype, cuda)
    TV.reset_counters()
    tab = TV.launch_segment_table(kind, *prof)
    assert TV.LAUNCHES["segment_table"] == 1
    ref = TV.plain_segment_table(kind, *prof)
    torch.cuda.synchronize()
    assert tab.is_contiguous() and tab.dtype == dtype
    assert _same_bits(tab, ref)
    assert not tab[:, :, prof[0].shape[1]:].any()


@pytest.mark.parametrize("mode", ["O", "X"])
def test_auto_at_the_global_shape_matches_the_torch_prep(cuda, mode,
                                                         monkeypatch):
    """``engine="auto"`` at the benchmark's global shape (10,512 Chapman
    profiles on 620 nodes, 174 frequencies, f64) returns vh bit for bit as
    with the table built by the PyTorch composition; one table launch for
    each launch of kernel 1 or 2."""
    from pyrayhf_tpu_torch.forward import vertical_forward_operator_batch
    rng = np.random.default_rng(20251018)
    B, N = 73 * 144, 620
    alt = np.linspace(80.0, 699.0, N)
    nm = 10.0 ** rng.uniform(11.0, np.log10(3e12), B)
    hm = rng.uniform(220.0, 380.0, B)
    H = rng.uniform(40.0, 70.0, B)
    z = (alt[None, :] - hm[:, None]) / H[:, None]
    den = nm[:, None] * np.exp(0.5 * (1.0 - z - np.exp(-z)))
    b0 = rng.uniform(2.5e-5, 6.5e-5, B)
    bmag = b0[:, None] * ((6371.0 + alt[0]) / (6371.0 + alt[None, :])) ** 3
    bpsi = np.broadcast_to(rng.uniform(0.0, 90.0, B)[:, None], (B, N))
    freqs = np.round(np.arange(1, 175) * 0.1, 10)
    args = [torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64,
                            device=cuda)
            for a in (freqs, den, bmag, bpsi, alt)]
    kind = "gather_osolve" if mode == "O" else "gather_xsolve"
    TV.reset_counters()
    vh = vertical_forward_operator_batch(*args, mode=mode)
    assert TV.LAUNCHES["segment_table"] == TV.LAUNCHES[kind] == 1
    monkeypatch.setattr(TV, "launch_segment_table", TV.plain_segment_table)
    ref = vertical_forward_operator_batch(*args, mode=mode)
    assert TV.LAUNCHES["segment_table"] == 1 and TV.LAUNCHES[kind] == 2
    assert torch.isfinite(vh).any()
    assert _same_bits(vh, ref)


def test_kernel_2_at_the_x20k_cell_shape_matches_parity(cuda):
    """``engine="auto"`` in X mode at the benchmark's ``vh_x20k.batch32``
    shape (32 seeded Chapman profiles under a dipole field on 620 nodes,
    174 frequencies from 0.1 MHz, P = 20,000, f64): one table launch and
    one launch of kernel 2, in its block-per-pair layout, and no plain
    version; identical NaN masks with the parity engine and the benchmark's
    plain reference and ≤ 1e-6 km on every pair, the sub-gyro pairs below
    2 MHz (cutoff exceeded at the first node: alt_min, or NaN where μ' is
    not valid there) included."""
    from hfbench import inputs
    from hfbench.reference import vertical_forward as ref
    from pyrayhf_tpu_torch.forward import vertical_forward_operator_batch
    f64 = torch.float64
    alt = torch.linspace(80.0, 699.0, 620, dtype=f64, device=cuda)
    freq = torch.round(torch.arange(1, 175, dtype=f64, device=cuda)
                       * 0.1 * 1e10) / 1e10
    traffic = {"profiles_per_call": 32, "pool_calls": 1, "sites": "random",
               "e_layer_share": 0.25}
    den, bmag, bpsi = inputs.profiles(traffic, 2 ** 33 + 21, alt, cuda)
    TV.reset_counters()
    vh = vertical_forward_operator_batch(freq, den, bmag, bpsi, alt,
                                         mode="X", n_points=20000)
    assert {k: v for k, v in TV.LAUNCHES.items() if v} == {
        "segment_table": 1, "gather_xsolve": 1}
    assert sum(TV.PLAIN_CALLS.values()) == 0
    a = TV.prepare_kernel_args("gather_xsolve", freq, den, bmag, bpsi, alt,
                               -1.0, 20000, TV.uniform_inv_dalt(alt))
    assert TV.kernel_layout(a).per_block
    par = vertical_forward_operator_batch(freq, den, bmag, bpsi, alt,
                                          mode="X", n_points=20000,
                                          engine="parity")
    want = ref.vertical_forward(freq, den, bmag, bpsi, alt, -1.0, 20000)
    first = _first_exceeds(freq.cpu().numpy(), den.cpu().numpy(),
                           bmag.cpu().numpy(), -1.0)
    assert first[:, freq.cpu().numpy() < 2.0].any()
    vh, par, want = (x.cpu().numpy() for x in (vh, par, want))
    assert np.isfinite(vh[first]).any() and np.isnan(vh[first]).any()
    for other in (par, want):
        assert np.array_equal(np.isnan(vh), np.isnan(other))
        m = np.isfinite(other)
        assert np.abs(vh[m] - other[m]).max() <= 1e-6


def _edited_library(tmp_path, name, old, new):
    """``csrc/ionogram.cu`` with its one ``old`` text replaced by ``new``,
    built alone into ``tmp_path`` and loaded with the package library's
    entry types."""
    from pyrayhf_tpu_torch import cuda_ext
    src = (cuda_ext.SRC_DIR / "ionogram.cu").read_text()
    assert src.count(old) == 1, f"{name}: the edited lines changed"
    path = tmp_path / f"{name}.cu"
    path.write_text(src.replace(old, new))
    so = tmp_path / f"{name}.so"
    r = subprocess.run([str(cuda_ext.find_nvcc()), *cuda_ext.NVCC_FLAGS,
                        "-shared", "-I", str(cuda_ext.SRC_DIR), "-o",
                        str(so), str(path)], capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-4000:]
    real = cuda_ext.load()
    lib = ctypes.CDLL(str(so))
    lib.pyrayhf_ionogram.argtypes = real.pyrayhf_ionogram.argtypes
    lib.pyrayhf_ionogram.restype = real.pyrayhf_ionogram.restype
    return types.SimpleNamespace(
        pyrayhf_ionogram=lib.pyrayhf_ionogram,
        pyrayhf_ionogram_blocks_per_sm=real.pyrayhf_ionogram_blocks_per_sm,
        pyrayhf_error_string=real.pyrayhf_error_string)


def _library_without_the_first_node_repair(tmp_path):
    """``csrc/ionogram.cu`` as it was before first-exceedance pairs were
    given the direct μ' and the absolute frame's span."""
    return _edited_library(tmp_path, "ionogram_before", """  if (first_exceeds) {
    emax = T(-1);
    crit = (alt0 - T(kDH)) - alt0;
  } else {
    crit = (valid ? crit : T(0)) - T(kDH);
  }
""", """  if (first_exceeds) crit = T(0);
  crit = (valid ? crit : T(0)) - T(kDH);
""")


@pytest.mark.parametrize("kind,mode_mult", [("gather_osolve", 1.0),
                                            ("gather_xsolve", -1.0)])
def test_global_shape_is_unchanged_off_first_exceedance_pairs(
        cuda, kind, mode_mult, tmp_path, monkeypatch):
    """Kernels 1 and 2 at the benchmark's global shape (10,512 Chapman
    profiles on 620 nodes, 174 frequencies from 0.1 MHz, P = 200, f64)
    give, bit for bit, what the kernel without the first-node repair gives
    on every pair whose cutoff is not already exceeded at the first node;
    the repair moves only those pairs."""
    from pyrayhf_tpu_torch import cuda_ext
    rng = np.random.default_rng(20251018)
    B, N = 73 * 144, 620
    alt = np.linspace(80.0, 699.0, N)
    nm = 10.0 ** rng.uniform(11.0, np.log10(3e12), B)
    hm = rng.uniform(220.0, 380.0, B)
    H = rng.uniform(40.0, 70.0, B)
    z = (alt[None, :] - hm[:, None]) / H[:, None]
    den = nm[:, None] * np.exp(0.5 * (1.0 - z - np.exp(-z)))
    b0 = rng.uniform(2.5e-5, 6.5e-5, B)
    bmag = b0[:, None] * ((6371.0 + alt[0]) / (6371.0 + alt[None, :])) ** 3
    bpsi = np.broadcast_to(rng.uniform(0.0, 90.0, B)[:, None], (B, N))
    freqs = np.round(np.arange(1, 175) * 0.1, 10)
    args = [torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float64,
                            device=cuda)
            for x in (freqs, den, bmag, bpsi, alt)]
    a = TV.prepare_kernel_args(kind, *args, mode_mult, 200,
                               TV.uniform_inv_dalt(args[4]))
    new = TV.launch_kernel(a)
    before = _library_without_the_first_node_repair(tmp_path)
    monkeypatch.setattr(cuda_ext, "load", lambda: before)
    old = TV.launch_kernel(a)
    torch.cuda.synchronize()
    first = torch.as_tensor(_first_exceeds(freqs, den, bmag, mode_mult),
                            device=cuda)
    assert torch.isfinite(new[~first]).any()
    assert _same_bits(new[~first], old[~first])
    if mode_mult < 0:
        assert first.any()


@pytest.mark.parametrize("kind", ["gather_xsolve", "gather", "mxu", "sweep"])
def test_f32_first_exceedance_pairs_take_the_f64_verdict(cuda, kind):
    """X mode in f32 on 32 seeded Chapman profiles (174 frequencies from
    0.1 MHz, P = 200): on the pairs whose cutoff is already exceeded at
    the first node, each kernel's NaN mask is the f64 kernel's (f32 would
    round μ just above 1 to 1 there; ``first_node_ok`` in kernels 1 and 2,
    the host prep's ``_first_node_valid`` for kernels 3 to 5), its output
    there alt_min within 3 ulp, and the f32 kernel's NaN mask is its plain
    version's on every pair."""
    from hfbench import inputs
    f64 = torch.float64
    alt = torch.linspace(80.0, 699.0, 620, dtype=f64, device=cuda)
    freq = torch.round(torch.arange(1, 175, dtype=f64, device=cuda)
                       * 0.1 * 1e10) / 1e10
    traffic = {"profiles_per_call": 32, "pool_calls": 1, "sites": "random",
               "e_layer_share": 0.25}
    den, bmag, bpsi = inputs.profiles(traffic, 2 ** 33 + 29, alt, cuda)

    def run(dtype, plain=False):
        t = [x.to(dtype) for x in (freq, den, bmag, bpsi, alt)]
        a = TV.prepare_kernel_args(kind, *t, -1.0, 200, None if kind ==
                                   "sweep" else TV.uniform_inv_dalt(t[4]))
        if plain:
            if kind == "sweep":
                return TV.ionogram_fast_xla(*t, mode_mult=-1.0)
            return TV.plain_ionogram(a)
        return (TV.launch_mxu(a) if kind == "mxu" else TV.launch_kernel(a))

    v32, v64, p32 = (run(torch.float32).cpu().numpy(),
                     run(f64).cpu().numpy(),
                     run(torch.float32, True).cpu().numpy())
    first = _first_exceeds(freq.cpu().numpy(), den.cpu().numpy(),
                           bmag.cpu().numpy(), -1.0)
    assert np.isnan(v64[first]).any() and np.isfinite(v64[first]).any()
    assert np.array_equal(np.isnan(v32[first]), np.isnan(v64[first]))
    fin = first & np.isfinite(v64)
    assert np.abs(v32[fin] - v64[fin]).max() <= 3 * 7.7e-6
    assert np.array_equal(np.isnan(v32), np.isnan(p32))


# ---- kernel 1: the O solve's search of the running maximum ---------------

# the linear count kernel 1 made over every node before its search
_SEARCH = """  int lo = 0, hi = N;  // row[j] < thr for j < lo, not for j >= hi
  while (lo < hi) {
    const int s = (hi - lo + 31) >> 5;
    const unsigned m =
        __ballot_sync(kFull, lo + lane * s < hi && row[lo + lane * s] < thr);
    if (m == 0) break;
    const int c = __popc(m);
    hi = min(lo + c * s, hi);
    lo += (c - 1) * s + 1;
  }
  return lo;
"""
_LINEAR_COUNT = """  int cnt = 0;
  for (int j = lane; j < N; j += 32) cnt += row[j] < thr ? 1 : 0;
  return __reduce_add_sync(kFull, cnt);
"""


@pytest.fixture(scope="module")
def linear_count(tmp_path_factory):
    """The package library with kernel 1's count over every node in place
    of its search (an escaped pair writes NaN either way)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    return _edited_library(tmp_path_factory.mktemp("linear_count"),
                           "ionogram_linear_count", _SEARCH, _LINEAR_COUNT)


def _osolve_case(case, dtype, dev):
    """Prepared ``gather_osolve`` args of an edge case of kernel 1's solve,
    on the card."""
    import dataclasses
    rng = np.random.default_rng(19)
    N, B, P = 620, 6, 200
    alt = np.linspace(80.0, 699.0, N)
    hm = rng.uniform(230.0, 360.0, (B, 1))
    H = rng.uniform(40.0, 70.0, (B, 1))
    z = (alt - hm) / H
    den = rng.uniform(1e11, 3e12, (B, 1)) * np.exp(0.5 * (1 - z - np.exp(-z)))
    den[1::2] += 3e11 * np.exp(-(alt - 110.0) ** 2 / 60.0)  # E above a valley
    freqs = np.concatenate([[0.05, 0.1, 0.15], np.arange(0.2, 17.5, 0.2)])
    if case == "nan":                  # dmax NaN from the NaN node on
        den[0, 100] = den[1, 0] = den[2, N - 1] = np.nan
        den[3, [40, 300]] = np.nan
    elif case == "ties":               # flat maxima, repeated nodes
        den = np.floor(8.0 * den / den.max(1, keepdims=True)) * 1.5e11
        den[4, 250:400] = den[4, 250]
        den[5, 1::2] = den[5, 0:-1:2]
    elif case == "escaped":            # profile 0 reflects nothing
        den[0] = 1e6
    elif case == "first":              # a dense bottom: the first node's
        den[2:] += 2e11 * np.exp(-(alt - 80.0) / 5.0)  # cutoff exceeded
    elif case == "n2":
        alt, den = alt[[0, -1]], den[:, [60, 250]]
        N = 2
    elif case == "b1":
        den, B = den[3:4], 1
    elif case in ("global", "block"):  # the benchmark's global profiles
        from hfbench import inputs
        traffic = {"profiles_per_call": 73 * 144, "pool_calls": 1,
                   "sites": "global", "grid": [73, 144],
                   "e_layer_share": 0.25}
        g, gb, gp = inputs.profiles(traffic, 2 ** 33 + 19, alt, dev)
        keep = torch.as_tensor(rng.choice(g.shape[0], 2048 if case ==
                                          "global" else 32, replace=False),
                               device=dev)
        den, bmag, bpsi = (x[keep].cpu().numpy() for x in (g, gb, gp))
        freqs = np.round(np.arange(1, 175) * 0.1, 10)
        P = 200 if case == "global" else 2000
    if case not in ("global", "block"):
        bmag = np.full_like(den, 3.2e-5)
        bpsi = np.broadcast_to(rng.uniform(0.0, 90.0, (B, 1)),
                               den.shape).copy()
    t = [torch.as_tensor(np.ascontiguousarray(x), dtype=dtype, device=dev)
         for x in (freqs, den, bmag, bpsi, alt)]
    a = TV.prepare_kernel_args("gather_osolve", *t, 1.0, P,
                               TV.uniform_inv_dalt(t[4]))
    f_hz = a.freq_hz
    if case == "cutoffs":   # each node's cutoff cp sqrt(dmax_j), ± 4 ulp
        base = (8.97866275 * torch.sqrt(TV._table(a)[:, 8, ::7])).flatten()
        base = base[torch.isfinite(base) & (base > 0)]
        fs, up, down = [base], base, base
        for _ in range(4):
            up = torch.nextafter(up, torch.full_like(up, np.inf))
            down = torch.nextafter(down, torch.full_like(down, -np.inf))
            fs += [up, down]
        f_hz = torch.unique(torch.cat(fs))
    elif case == "f0_nan":
        f_hz = torch.cat([f_hz, torch.tensor([0.0, np.nan, -0.0], dtype=dtype,
                                             device=dev)])
    return dataclasses.replace(a, freq_hz=f_hz.contiguous())


@pytest.mark.parametrize("case", ["cutoffs", "nan", "ties", "escaped",
                                  "first", "f0_nan", "n2", "b1", "global",
                                  "block"])
def test_kernel_1_search_equals_its_linear_count(cuda, linear_count,
                                                 monkeypatch, case):
    """Kernel 1 (``gather_osolve``: the escape test first, then a 32-way
    search of the non-decreasing cummax(den) row) against the same kernel
    counting over every node: bit for bit, NaN at the same pairs, f32 and
    f64, on frequencies at each node's cutoff ± 4 ulp, a NaN node (the
    running maximum NaN from there on), flat and tied maxima, an
    all-escaped profile, first-exceedance pairs, f = 0 and NaN, N = 2,
    B = 1, 2,048 profiles of the benchmark's global grid and 32 of them at
    P = 2,000 (a block per pair); one launch counted a launch. Against the
    plain solve and resample: f64 identical NaN masks and ≤ 1e-6 km, f32
    identical NaN masks and ≤ 1e-3 km, or 4 f32 ulps of vh where that is
    more."""
    from pyrayhf_tpu_torch import cuda_ext
    real = cuda_ext.load
    for dtype in (torch.float64, torch.float32):
        a = _osolve_case(case, dtype, cuda)
        TV.reset_counters()
        new = TV.launch_kernel(a)
        assert TV.LAUNCHES["gather_osolve"] == 1
        assert TV.kernel_layout(a).per_block == (case == "block")
        monkeypatch.setattr(cuda_ext, "load", lambda: linear_count)
        old = TV.launch_kernel(a)
        monkeypatch.setattr(cuda_ext, "load", real)
        assert TV.LAUNCHES["gather_osolve"] == 2
        torch.cuda.synchronize()
        assert _same_bits(new, old)
        k = new.double().cpu().numpy()
        p = TV.plain_ionogram(a).double().cpu().numpy()
        assert np.array_equal(np.isnan(k), np.isnan(p))
        m = np.isfinite(p)
        # at N = 2 the flat extension leaves the profile flat: a valid pair
        # reflects at the first node, where O mode's mu' is not valid
        assert m.any() == (case != "n2")
        tol = 1e-6 if dtype == torch.float64 else np.maximum(
            1e-3, 4 * np.finfo(np.float32).eps * np.abs(p[m]))
        assert (np.abs(k[m] - p[m]) <= tol).all()
        if case == "escaped":
            assert np.isnan(k[0]).all()
