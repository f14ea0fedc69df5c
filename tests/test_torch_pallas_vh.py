"""PyTorch port vs the JAX package: the ionogram kernels' module.

Each kernel's plain PyTorch version (what the wrappers run on CPU tensors)
is held against its Pallas kernel run in interpret mode, exactly as
``tests/test_pallas.py`` runs it. Inputs are made with numpy from a seed
and fed to both packages in f64.

Tolerances: identical NaN masks and max |Δvh| ≤ 1e-6 km (the JAX
package's own bound); the X-mode sub-gyro row (first node already past
the cutoff) is compared on its NaN pattern only, as
``tests/test_pallas.py:286`` masks it. Gradients: rtol 1e-7 with atol
1e-9·max, because the two backward passes sum in another order near
reflection.

A deliberate divergence: on a pair whose cutoff is already exceeded at
the grid's first node (``_first_exceeds``) the port's kernels, plain
versions and sweep give what the JAX package's parity engine and the
upstream give (alt_min, or NaN where μ' is not valid there), where the
JAX package's kernels and sweep give NaN or alt_min + ~1e-6 km. Those
pairs are held to the JAX parity engine.
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


def _two_peak():
    """Plain F layer, and F + E-peak over a valley (cummax-shadowed
    bottomside); 0.3 MHz (X-mode sub-gyro row) and 25-30 MHz (escape)."""
    n_alt = 180
    alt = np.linspace(90.0, 550.0, n_alt)
    f2 = 2.5e12 * np.exp(-(alt - 300.0) ** 2 / (2 * 55.0 ** 2))
    e_layer = 9e11 * np.exp(-(alt - 110.0) ** 2 / (2 * 10.0 ** 2))
    den = np.stack([f2, f2 + e_layer])
    bmag = np.full((2, n_alt), 3.2e-5)
    bpsi = np.full((2, n_alt), 65.0)
    freqs = np.concatenate([[0.3], np.arange(1.0, 16.0, 0.5), [25.0, 30.0]])
    return freqs, den, bmag, bpsi, alt


def _nonuniform():
    rng = np.random.default_rng(7)
    alt = np.sort(rng.uniform(90.0, 550.0, 150))
    alt[0], alt[-1] = 90.0, 550.0
    den = 2e12 * np.exp(-(alt - 300.0) ** 2 / (2 * 60.0 ** 2))[None, :]
    bmag = np.full_like(den, 3e-5)
    bpsi = np.full_like(den, 60.0)
    freqs = np.arange(2.0, 14.0, 1.0)
    return freqs, den, bmag, bpsi, alt


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float64))


def _j(args):
    return [jnp.asarray(a) for a in args]


def _first_exceeds(freqs, den, bmag, mode_mult):
    """[B, F] bool: the pairs whose cutoff function, X (O mode) or X + Y
    (X mode), is already 1 or more at the grid's first node."""
    f = np.asarray(freqs)[None, :] * 1e6
    s = den[:, :1] * TV.CP ** 2 / f ** 2
    if mode_mult < 0:
        s = s + bmag[:, :1] * TV.G_P / f
    return s >= 1.0


def _assert_vh(port, ref, tol=TOL_KM, skip_cols=()):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else port
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    assert np.array_equal(np.isnan(port), np.isnan(ref))
    m = np.isfinite(ref)
    m[:, list(skip_cols)] = False
    assert m.any()
    assert np.abs(port[m] - ref[m]).max() <= tol


def test_stretched_grid_tables_identical():
    for n in (200, 600, 20000):
        for a, b in zip(TV._stretched_grid_tables(n),
                        JV._stretched_grid_tables(n)):
            assert np.array_equal(a, b)


def test_uniform_inv_dalt_matches_jax():
    _, _, _, _, alt = _workload()
    assert TV.uniform_inv_dalt(_t(alt)) == JV.uniform_inv_dalt(alt)
    alt_nu = alt.copy()
    alt_nu[5] += 0.5
    assert TV.uniform_inv_dalt(_t(alt_nu)) is None
    assert TV.uniform_inv_dalt(_t(np.stack([alt, alt]))) is None


@pytest.mark.parametrize("mode_mult", [1.0, -1.0])
def test_prepare_profile_tables_matches_jax(mode_mult):
    freqs, den, bmag, bpsi, alt = _two_peak()
    ref = JV.prepare_profile_tables(jnp.asarray(freqs) * 1e6,
                                    *_j((den, bmag, bpsi, alt)), mode_mult)
    port = TV.prepare_profile_tables(_t(freqs) * 1e6,
                                     *map(_t, (den, bmag, bpsi, alt)),
                                     mode_mult)
    first = _first_exceeds(freqs, den, bmag, mode_mult)
    assert first.any() and not first.all()
    for name, p, r in zip(("seg", "crit", "valid", "slope", "emax"),
                          port, ref):
        r = np.asarray(r)
        p = p.numpy()
        if r.dtype == bool:
            assert np.array_equal(p, r), name
            continue
        if name == "emax":
            # the first-exceedance pairs leave the analytic branch
            assert (p[first] == -1.0).all()
            p, r = p[~first], r[~first]
        assert_allclose(p, r, rtol=1e-12, atol=1e-12, err_msg=name)


@pytest.mark.parametrize("mode_mult", [1.0, -1.0])
def test_mu_mup_stable_tile_matches_jax(mode_mult):
    """Random samples, about half of them on the analytic-margin path
    (eps < 1e-3 and eps ≤ emax). rtol 1e-10: μ' near the cutoff is
    conditioned like 1/ε and the libraries' sin/cos differ by an ulp."""
    rng = np.random.default_rng(21)
    n = 4000
    eps = 10.0 ** rng.uniform(-9, -2, n)
    emax = np.where(rng.uniform(size=n) < 0.7, 2e-3, 0.0)
    Y = rng.uniform(0.05, 0.6, n)
    Y[:50] = 0.0
    X = np.where(rng.uniform(size=n) < 0.5, 1.0 - eps,
                 rng.uniform(0.0, 1.2, n))
    if mode_mult < 0:
        X = np.clip(X - Y, 0.0, None)
    psi = rng.uniform(0.0, 90.0, n)
    args = (X, Y, psi)
    mup_j, ok_j = JV._mu_mup_stable_tile(*_j(args), mode_mult,
                                         jnp.asarray(eps), jnp.asarray(emax))
    mup_t, ok_t = TV._mu_mup_stable_tile(*map(_t, args), mode_mult,
                                         _t(eps), _t(emax))
    assert np.array_equal(ok_t.numpy(), np.asarray(ok_j))
    assert_allclose(mup_t.numpy(), np.asarray(mup_j), rtol=1e-10, atol=0)


@pytest.mark.parametrize("case", ["workload", "two_peak", "unmagnetised"])
def test_gather_osolve_plain_matches_jax_interpret(case):
    args = _workload() if case == "workload" else _two_peak()
    if case == "unmagnetised":
        args = (*args[:2], np.zeros_like(args[2]), np.zeros_like(args[3]),
                args[4])
    ref = JV.ionogram_pallas_gather(*_j(args), mode_mult=1.0, n_points=200,
                                    interpret=True)
    TV.reset_counters()
    port = TV.ionogram_pallas_gather(*map(_t, args), mode_mult=1.0,
                                     n_points=200)
    assert TV.PLAIN_CALLS["gather_osolve"] == 1
    assert sum(TV.LAUNCHES.values()) == 0
    _assert_vh(port, ref)


def test_gather_xsolve_plain_matches_jax_interpret():
    args = _two_peak()
    ref = np.asarray(JV.ionogram_pallas_gather(
        *_j(args), mode_mult=-1.0, n_points=200, interpret=True))
    TV.reset_counters()
    port = TV.ionogram_pallas_gather(*map(_t, args), mode_mult=-1.0,
                                     n_points=200)
    assert TV.PLAIN_CALLS["gather_xsolve"] == 1
    _assert_vh(port, ref, skip_cols=[0])
    assert np.isnan(port[:, -1].numpy()).all()   # above-MUF rows escape


def test_gather_plain_matches_jax_interpret():
    """Solve on the host (``x_in_kernel_solve=False``): JAX's
    ``_kernel_gather`` in interpret mode, X mode (the only mode the JAX
    wrapper routes to it)."""
    args = _two_peak()
    ref = JV.ionogram_pallas_gather(*_j(args), mode_mult=-1.0, n_points=200,
                                    interpret=True, x_in_kernel_solve=False)
    TV.reset_counters()
    port = TV.ionogram_pallas_gather(*map(_t, args), mode_mult=-1.0,
                                     n_points=200, x_in_kernel_solve=False)
    assert TV.PLAIN_CALLS["gather"] == 1
    _assert_vh(port, ref, skip_cols=[0])


def test_gather_plain_o_mode_matches_jax_sweep():
    """The host-solve gather in O mode (reachable in the port through the
    prepared-args API) against the JAX segment sweep."""
    args = _workload()
    ref = JV.ionogram_fast_xla(*_j(args), mode_mult=1.0, n_points=200)
    t = [_t(a) for a in args]
    a = TV.prepare_kernel_args("gather", *t, 1.0, 200,
                               TV.uniform_inv_dalt(t[4]))
    _assert_vh(TV.plain_ionogram(a), ref)


@pytest.mark.parametrize("mode_mult", [1.0, -1.0])
def test_sweep_plain_matches_jax_interpret(mode_mult):
    args = _workload(B=2)
    ref = JV.ionogram_pallas(*_j(args), mode_mult=mode_mult, n_points=200,
                             interpret=True)
    TV.reset_counters()
    port = TV.ionogram_pallas(*map(_t, args), mode_mult=mode_mult,
                              n_points=200)
    assert TV.PLAIN_CALLS["sweep"] == 1
    _assert_vh(port, ref)


def test_sweep_nonuniform_grid_matches_jax_interpret():
    args = _nonuniform()
    ref = JV.ionogram_pallas(*_j(args), mode_mult=1.0, n_points=200,
                             interpret=True)
    port = TV.ionogram_pallas(*map(_t, args), mode_mult=1.0, n_points=200)
    _assert_vh(port, ref)


def test_gather_p600_matches_jax_interpret():
    """P = 600 spans two of the TPU kernel's 512-point chunks (its hoisted
    solve); the port has no chunks."""
    args = _workload(B=2)
    ref = JV.ionogram_pallas_gather(*_j(args), mode_mult=1.0, n_points=600,
                                    interpret=True)
    port = TV.ionogram_pallas_gather(*map(_t, args), mode_mult=1.0,
                                     n_points=600)
    _assert_vh(port, ref)


@pytest.mark.parametrize("mode_mult", [1.0, -1.0])
def test_sweep_gradient_matches_jax_grad(mode_mult):
    """torch.autograd.grad of Σ where(valid, vh, 0) w.r.t. den through
    ionogram_fast_xla equals jax.grad through the JAX one."""
    freqs, den, bmag, bpsi, alt = _two_peak()
    fixed = (bmag, bpsi, alt)

    def loss_j(d):
        vh = JV.ionogram_fast_xla(jnp.asarray(freqs), d, *_j(fixed),
                                  mode_mult=mode_mult, n_points=200)
        return jnp.sum(jnp.where(jnp.isfinite(vh), vh, 0.0))

    g_j = np.asarray(jax.grad(loss_j)(jnp.asarray(den)))
    d = _t(den).requires_grad_(True)
    vh = TV.ionogram_fast_xla(_t(freqs), d, *map(_t, fixed),
                              mode_mult=mode_mult, n_points=200)
    loss = torch.where(torch.isfinite(vh), vh, 0.0).sum()
    g_t = torch.autograd.grad(loss, d)[0].numpy()
    assert np.isfinite(g_t).all() and np.abs(g_t).max() > 0
    assert_allclose(g_t, g_j, rtol=1e-7, atol=1e-9 * np.abs(g_j).max())


def test_wrapper_gradient_is_the_sweeps():
    """The autograd rule of the wrappers: gradients through
    ionogram_pallas_gather equal those through ionogram_fast_xla, for
    every differentiable input."""
    freqs, den, bmag, bpsi, alt = _workload(B=2)

    def grads(fn):
        xs = [_t(a).requires_grad_(True) for a in (den, bmag, bpsi)]
        vh = fn(_t(freqs), *xs, _t(alt), mode_mult=1.0, n_points=200)
        loss = torch.where(torch.isfinite(vh), vh, 0.0).sum()
        return torch.autograd.grad(loss, xs)

    for gw, gs in zip(grads(TV.ionogram_pallas_gather),
                      grads(TV.ionogram_fast_xla)):
        assert torch.isfinite(gw).all()
        assert_allclose(gw.numpy(), gs.numpy(), rtol=1e-10, atol=0)


def test_f32_plain_within_budget_of_f64():
    """f32 plain versions stay within 0.05 km of f64, near-critical rows
    included (the analytic-margin tail; ``tests/test_pallas.py:102``).
    The gather needs a grid uniform in f32 too: 2 km steps are exact."""
    args = _workload(B=2, n_alt=231)
    for fn in (TV.ionogram_pallas_gather, TV.ionogram_pallas):
        for mm in (1.0, -1.0):
            v64 = fn(*map(_t, args), mode_mult=mm)
            v32 = fn(*(torch.from_numpy(np.asarray(a, np.float32))
                       for a in args), mode_mult=mm)
            assert v32.dtype == torch.float32
            m = torch.isfinite(v64) & torch.isfinite(v32)
            assert m.sum() > 40
            assert (v32.double()[m] - v64[m]).abs().max() < 0.05


def test_f32_crossing_above_node_fault_is_the_jax_packages():
    """ROADMAP Queue 3: a Chapman profile (NmF2 4.6e11 m⁻³, hmF2 328 km) on
    the 620-node 80-699 km grid whose 5.6 MHz crossing lies 2.5e-6 of
    cutoff margin above a node. f32 lands 0.55 km from f64 there, in the
    JAX package (its Pallas gather in interpret mode and its sweep) as in
    the port; the neighbouring frequencies stay within 0.1 km. Port f32
    against JAX f32: ≤ 1e-3 km (f32 sums in another order); f64: ≤ 1e-6."""
    alt = np.linspace(80.0, 699.0, 620)
    z = (alt - 328.1417365118308) / 58.5291669478399
    den = 459807214778.7281 * np.exp(0.5 * (1.0 - z - np.exp(-z)))[None, :]
    bmag = 5.126528885003856e-05 * ((6371.0 + alt[0])
                                    / (6371.0 + alt[None, :])) ** 3
    args = (np.array([5.5, 5.6, 5.7]), den, bmag,
            np.full_like(den, 0.37950733828373884), alt)
    out = {}
    for np_dt in (np.float64, np.float32):
        jx = [jnp.asarray(a, np_dt) for a in args]
        tx = [torch.from_numpy(np.asarray(a, np_dt)) for a in args]
        out[np_dt] = (
            [np.asarray(JV.ionogram_pallas_gather(*jx, mode_mult=1.0,
                                                  interpret=True)),
             np.asarray(JV.ionogram_fast_xla(*jx, mode_mult=1.0))],
            [TV.ionogram_pallas_gather(*tx, mode_mult=1.0).numpy(),
             TV.ionogram_pallas(*tx, mode_mult=1.0).numpy()])
    j64 = out[np.float64][0][0]
    for p in out[np.float64][0] + out[np.float64][1]:
        _assert_vh(p, j64)
    for j in out[np.float32][0]:
        err = np.abs(j.astype(np.float64) - j64)[0]
        assert 0.5 < err[1] < 0.6
        assert err[0] < 0.1 and err[2] < 0.1
        for p in out[np.float32][1]:
            _assert_vh(p.astype(np.float64), j.astype(np.float64), tol=1e-3)


def test_gather_requires_uniform_grid():
    freqs, den, bmag, bpsi, alt = _workload(B=2)
    alt_nu = alt.copy()
    alt_nu[1:] += np.linspace(0.0, 5.0, alt.size - 1) ** 2 * 0.01
    with pytest.raises(ValueError, match="uniform"):
        TV.ionogram_pallas_gather(*map(_t, (freqs, den, bmag, bpsi, alt_nu)),
                                  mode_mult=1.0)


def test_wrappers_raise_off_cpu_and_cuda():
    """A wrapper never falls back: tensors on another device raise."""
    args = [_t(a).to("meta") for a in _workload(B=2)]
    with pytest.raises(ValueError, match="no ionogram kernel for device"):
        TV.ionogram_pallas(*args, mode_mult=1.0)


def _pairs_of(lay, F):
    """(group, warp) -> frequencies of ``csrc/ionogram.cu``'s loops: group
    g takes g, g + n_groups, ...; in the warp layout warp w takes the
    group's slots w, w + warps, ..., in the block layout every warp takes
    every slot."""
    out = {}
    for g in range(lay.n_groups):
        for w in range(lay.warps):
            s0, step = (0, 1) if lay.per_block else (w, lay.warps)
            out[g, w] = list(range(g + s0 * lay.n_groups, F,
                                   step * lay.n_groups))
    return out


def test_launch_shape_covers_every_frequency():
    for B, F in [(1, 1), (4, 33), (32, 175), (1024, 175), (10512, 175)]:
        for P in (2, 200, 2000, 20000):
            lay = TV.launch_shape(B, F, P, n_sm=132, blocks_per_sm=2)
            assert 1 <= lay.n_groups <= min(F, 65535)
            assert 4 <= lay.warps and lay.warps * 32 <= 256
            got = sorted(f for v in _pairs_of(lay, F).values() for f in v)
            want = list(range(F)) * (lay.warps if lay.per_block else 1)
            assert got == sorted(want)
        f_group, warps = TV.mxu_launch_shape(B, F, n_sm=132)
        n_groups = -(-F // f_group)
        assert f_group >= 1 and warps * 32 <= 256
        assert (n_groups - 1) * f_group < F <= n_groups * f_group


@pytest.mark.parametrize("blocks_per_sm", [0, 2, 5])
def test_launch_shape_picks_the_layout_by_grid_length(blocks_per_sm):
    """A warp per (profile, frequency) at P = 200 (the gather kernels and
    the non-uniform route), a block per pair at P = 20,000 (X-20k): a
    block per pair once each of its 256 threads has 4 points or more, and
    as many as the pairs each warp the card holds would get; in the warp
    layout the groups give about 8 blocks for each block the SMs hold at
    once (at least one a SM)."""
    short = TV.launch_shape(1024, 175, 200, 132, blocks_per_sm)
    long = TV.launch_shape(32, 175, 20000, 132, blocks_per_sm)
    assert not short.per_block and long.per_block
    assert short.warps == long.warps == 8 and long.n_groups == 175
    # 8 waves of 132 SMs x blocks_per_sm over 1,024 profiles
    assert short.n_groups == {0: 1, 2: 2, 5: 5}[blocks_per_sm]
    # a small batch at P = 200: one frequency per warp at most
    lay = TV.launch_shape(32, 175, 200, 132, blocks_per_sm)
    assert not lay.per_block and lay.n_groups == -(-175 // 8)
    # few pairs: from 4 points a thread
    assert not TV.launch_shape(1, 7, 1023, 132, blocks_per_sm).per_block
    assert TV.launch_shape(1, 7, 1024, 132, blocks_per_sm).per_block
    # 10 pairs for each resident warp: from 2,560 points
    F = 10 * 132 * max(1, blocks_per_sm) * 8
    assert not TV.launch_shape(1, F, 2559, 132, blocks_per_sm).per_block
    assert TV.launch_shape(1, F, 2560, 132, blocks_per_sm).per_block
    # many pairs (4,096 profiles): a warp per pair even at P = 20,000
    assert not TV.launch_shape(4096, 175, 20000, 132, blocks_per_sm).per_block


@pytest.mark.parametrize("B", [1, 32, 1024])
@pytest.mark.parametrize("F", [1, 7, 175, 176])
def test_interleaved_map_assigns_each_frequency_once(B, F):
    """Every frequency goes to exactly one (block, slot): one warp of one
    group in the warp layout, one group (all its warps) in the block
    layout; and a group's frequencies are interleaved, so each group gets
    some of the lowest (the valid) ones."""
    for P in (200, 20000):
        lay = TV.launch_shape(B, F, P, n_sm=132, blocks_per_sm=2)
        owners = {}
        for (g, w), fs in _pairs_of(lay, F).items():
            for f in fs:
                owners.setdefault(f, set()).add(g if lay.per_block
                                                 else (g, w))
        assert sorted(owners) == list(range(F))
        assert all(len(o) == 1 for o in owners.values())
        first = {}
        for f, (o,) in owners.items():
            g = o if lay.per_block else o[0]
            first[g] = min(first.get(g, f), f)
        assert first == {g: g for g in range(lay.n_groups)}


def test_osolve_razor_frequencies_match_host_solve():
    """Frequencies exactly at a node's plasma frequency put X on a rounding
    razor; the count + X-space ±1 correction must pick the crossing the
    dense host solve picks (same heights to 1e-6 km, same NaN mask)."""
    freqs, den, bmag, bpsi, alt = _two_peak()
    cp = 8.97866275
    nodes = [20, 40, 60, 75, 89]
    razor = np.unique(np.concatenate(
        [cp * np.sqrt(den[b, nodes]) / 1e6 for b in range(2)]))
    t = [_t(a) for a in (razor, den, bmag, bpsi, alt)]
    inv = TV.uniform_inv_dalt(t[4])
    fused = TV.plain_ionogram(TV.prepare_kernel_args(
        "gather_osolve", *t, 1.0, 200, inv))
    host = TV.plain_ionogram(TV.prepare_kernel_args("gather", *t, 1.0, 200,
                                                    inv))
    _assert_vh(fused, host.numpy())


def test_shadow_gate_disables_margin_under_e_peak():
    """A frequency whose crossing segment starts in the valley under an E
    peak: the lower node's X is cummax-shadowed (r0 != f0), so emax must be
    0 there (dropping the gate costs ~99 km), and the result must still
    match the JAX segment sweep."""
    freqs, den, bmag, bpsi, alt = _two_peak()
    cp = 8.97866275
    e_peak = den[1, :40].max()
    k0 = 40 + int(np.argmax(den[1, 40:] >= e_peak))   # valley's far side
    thr = np.array([0.25, 0.5, 0.75]) * (den[1, k0] - e_peak) + e_peak
    fr = cp * np.sqrt(thr) / 1e6
    args = (fr, den, bmag, bpsi, alt)
    t = [_t(a) for a in args]
    a = TV.prepare_kernel_args("gather_osolve", *t, 1.0, 200,
                               TV.uniform_inv_dalt(t[4]))
    span, slope, emax, valid = TV._osolve_plain(a)
    assert valid[1].all() and (slope[1] > 0).all()
    assert (emax[1] == 0).all()                 # gated: shadowed lower node
    assert (emax[0] > 0).all()                  # plain F layer: genuine
    ref = JV.ionogram_fast_xla(*_j(args), mode_mult=1.0, n_points=200)
    _assert_vh(TV.plain_ionogram(a), ref)


def test_altitude_frame_is_relative():
    """Shifting the whole grid by 1000 km shifts every vh by 1000 km: the
    solve and resample run relative to alt[0], min(alt) is added last."""
    args = _workload(B=2)
    for fn, kw in ((TV.ionogram_pallas_gather, {}),
                   (TV.ionogram_pallas, {})):
        for mm in (1.0, -1.0):
            base = fn(*map(_t, args), mode_mult=mm, **kw)
            up = fn(*map(_t, args[:4]), _t(args[4] + 1000.0), mode_mult=mm,
                    **kw)
            _assert_vh(up - 1000.0, base.numpy(), tol=1e-9)


# ---- kernel 2's cutoff-frequency bracket (csrc/ionogram.cu) -------------

def _bracket_profiles(kind):
    """(den, |B|, alt) [B, N] of one kind: Chapman F2, an E layer above a
    valley, the two-peak pair, or Chapman with |B| constant in height."""
    rng = np.random.default_rng(17)
    alt = np.linspace(80.0, 699.0, 311)
    B = 6
    hm = rng.uniform(220.0, 380.0, (B, 1))
    H = rng.uniform(40.0, 70.0, (B, 1))
    z = (alt - hm) / H
    den = 10.0 ** rng.uniform(11.0, 12.4, (B, 1)) * np.exp(
        0.5 * (1.0 - z - np.exp(-z)))
    bmag = rng.uniform(2.5e-5, 6.5e-5, (B, 1)) * (
        (6371.0 + alt[0]) / (6371.0 + alt)) ** 3
    if kind == "e_valley":
        ze = (alt - rng.uniform(105.0, 120.0, (B, 1))) / 8.0
        den = den + rng.uniform(0.1, 0.4, (B, 1)) * den.max(1, keepdims=True) \
            * np.exp(0.5 * (1.0 - ze - np.exp(-ze)))
    elif kind == "two_peak":
        f2 = 2.5e12 * np.exp(-(alt - 300.0) ** 2 / (2 * 55.0 ** 2))
        e_layer = 9e11 * np.exp(-(alt - 110.0) ** 2 / (2 * 10.0 ** 2))
        den, bmag = np.stack([f2, f2 + e_layer]), np.full((2, alt.size),
                                                          3.2e-5)
    elif kind == "flat_b":
        bmag = np.repeat(bmag[:, :1], alt.size, axis=1)
    return den, bmag, alt


def _razor_case(kind, dtype):
    """Kernel 2's prepared args (CPU) with frequencies at each profile's
    node cutoffs fx_j and prefix maxima cfx_j times (1 ± n ulp), n ≤ 4,
    and the exact first exceedance k_first [B, F] (N where none) of the
    s = X + Y that ``_xsolve_plain`` tests."""
    import dataclasses
    den, bmag, alt = _bracket_profiles(kind)
    t = [torch.as_tensor(x, dtype=dtype)
         for x in (np.array([5.0]), den, bmag, np.full_like(den, 45.0), alt)]
    a = TV.prepare_kernel_args("gather_xsolve", *t, -1.0, 200,
                               TV.uniform_inv_dalt(t[4]))
    fx, cfx = TV.cutoff_frequencies(a), TV.cutoff_table(a)
    nodes = torch.arange(0, fx.shape[1], 7)
    base = torch.cat([fx[:, nodes], cfx[:, nodes]]).flatten()
    fs, up, down = [base], base, base
    for _ in range(4):
        up = torch.nextafter(up, torch.full_like(up, np.inf))
        down = torch.nextafter(down, torch.full_like(down, -np.inf))
        fs += [up, down]
    a = dataclasses.replace(a, freq_hz=torch.unique(torch.cat(fs)))
    tab, f = TV._table(a), a.freq_hz[None, :, None]
    cp2 = torch.tensor(8.97866275 ** 2, dtype=dtype)
    gp = torch.tensor(2.799249247e10, dtype=dtype)
    s = tab[:, 2][:, None, :] * cp2 * (1.0 / (f * f)) \
        + tab[:, 4][:, None, :] * gp / f
    exceed = s >= 1.0
    N = tab.shape[2]
    k_first = torch.where(exceed.any(2),
                          torch.argmax(exceed.to(torch.uint8), dim=2), N)
    return a, cfx, k_first


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["chapman", "e_valley", "two_peak",
                                  "flat_b"])
def test_cutoff_bracket_never_passes_an_exceedance(kind, dtype):
    """Kernel 2 searches the first exceedance from j_lo, the first node
    with cfx_j ≥ f·(1 − δ): on frequencies at node cutoffs ± 4 ulp, the
    exact first exceedance of ``_xsolve_plain``'s s is never below j_lo
    (f32 and f64, E layers above valleys, two peaks, constant |B|)."""
    a, cfx, k_first = _razor_case(kind, dtype)
    fl = a.freq_hz * (1.0 - TV.XSOLVE_MARGIN[dtype])
    jlo = torch.searchsorted(cfx.contiguous(),
                             fl[None, :].expand(cfx.shape[0], -1)
                             .contiguous())
    valid = k_first < cfx.shape[1]
    assert valid.any() and (~valid).any()
    assert bool((k_first[valid] >= jlo[valid]).all())
    assert bool((k_first[valid] - jlo[valid] < 32).float().mean() > 0.9)
    # the same solve as the two scans
    ref = TV._xsolve_plain(a)
    assert torch.equal(ref[3], valid)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_escaped_pairs_lie_above_the_cutoff_table(dtype):
    """Every escaped pair (no node with s ≥ 1) has f·(1 − δ) > cfx_{N−1},
    so the table alone may declare it escaped, or lies within the margin
    (f ≤ cfx_{N−1}·(1 + δ)), where the kernel scans; none lies below."""
    d = TV.XSOLVE_MARGIN[dtype]
    for kind in ("chapman", "e_valley", "two_peak", "flat_b"):
        a, cfx, k_first = _razor_case(kind, dtype)
        escaped = k_first == cfx.shape[1]
        top = cfx[:, -1:].expand_as(escaped)
        f = a.freq_hz[None, :].expand_as(escaped)
        table = f * (1.0 - d) > top
        margin = f <= top * (1.0 + d)
        assert bool(escaped.any()) and bool((table | margin)[escaped].all())
        assert not bool((f[escaped] < top[escaped] * (1.0 - d)).any())


@pytest.mark.parametrize("kind,mode_mult", [("gather_xsolve", -1.0),
                                            ("gather", -1.0),
                                            ("gather", 1.0)])
def test_padded_rows_keep_the_plain_version(kind, mode_mult):
    """Kernels 1 to 3 take their table with rows padded to 16 bytes
    (``padded_rows``): at N = 181 nodes the f32 rows hold 184 values and
    the f64 rows 182, the pad is zero, the sweep's rows are unpadded, and
    the plain version on the padded table matches the JAX sweep."""
    freqs, den, bmag, bpsi, alt = _workload(B=3, n_alt=181)
    for dtype, ld in ((torch.float32, 184), (torch.float64, 182)):
        t = [torch.as_tensor(x, dtype=dtype)
             for x in (freqs, den, bmag, bpsi, alt)]
        inv = TV.uniform_inv_dalt(t[4])
        a = TV.prepare_kernel_args(kind, *t, mode_mult, 200, inv)
        assert a.tab.shape == (3, 8, ld) and a.n_alt == 181
        assert a.tab.is_contiguous() and not a.tab[:, :, 181:].any()
        assert TV.padded_rows(181, a.tab.element_size()) == ld
        o = TV.prepare_kernel_args("gather_osolve", *t, 1.0, 200, inv)
        assert o.tab.shape == (3, 9, ld) and not o.tab[:, :, 181:].any()
        s = TV.prepare_kernel_args("sweep", *t, 1.0, 200, None)
        assert s.tab.shape == (3, 8, 181)
    ref = JV.ionogram_fast_xla(*_j((freqs, den, bmag, bpsi, alt)),
                               mode_mult=mode_mult, n_points=200)
    _assert_vh(TV.plain_ionogram(a), ref)


def test_sub_gyro_x_rows_differ_between_the_jax_engines_too():
    """X rows whose first node already exceeds the cutoff (sub-gyro
    frequencies over a bottom nearly without plasma, under a |B| that
    falls with height: chip_smoke.py's Chapman profiles): the JAX
    package's own gather kernel (interpret mode) and its sweep give NaN
    there, its parity operator alt[0] on three of these four profiles and
    NaN on the fourth (μ' is not valid there). The port's gather and sweep
    give what the parity operator gives on these rows (the deliberate
    divergence), and what the JAX package's kernels give on every other
    pair."""
    alt = np.linspace(80.0, 550.0, 180)
    rng = np.random.default_rng(20250901)
    B = 4
    nm = 10.0 ** rng.uniform(11.0, np.log10(3e12), B)
    hm = rng.uniform(220.0, 380.0, B)
    H = rng.uniform(40.0, 70.0, B)
    z = (alt[None, :] - hm[:, None]) / H[:, None]
    den = nm[:, None] * np.exp(0.5 * (1.0 - z - np.exp(-z)))
    e = rng.uniform(size=B) < 0.25
    nme = rng.uniform(0.6, 1.2, B) * 0.15 * nm
    ze = (alt[None, :] - rng.uniform(105.0, 120.0, B)[:, None]) / 8.0
    den = den + e[:, None] * nme[:, None] * np.exp(
        0.5 * (1.0 - ze - np.exp(-ze)))
    b0 = rng.uniform(2.5e-5, 6.5e-5, B)
    bmag = b0[:, None] * ((6371.0 + alt[0]) / (6371.0 + alt[None, :])) ** 3
    bpsi = np.broadcast_to(rng.uniform(0.0, 90.0, B)[:, None],
                           den.shape).copy()
    freqs = np.array([0.2, 0.5, 0.8, 1.1, 2.0, 2.5])
    args = (freqs, den, bmag, bpsi, alt)
    t = [_t(a) for a in args]
    port = {"gather": TV.ionogram_pallas_gather(*t, mode_mult=-1.0),
            "sweep": TV.ionogram_pallas(*t, mode_mult=-1.0),
            "parity": TF.vertical_forward_operator_batch(
                *t, mode="X", engine="parity")}
    ref = {"gather": JV.ionogram_pallas_gather(*_j(args), mode_mult=-1.0,
                                               interpret=True),
           "sweep": JV.ionogram_fast_xla(*_j(args), mode_mult=-1.0),
           "parity": JF.vertical_forward_operator_batch(
               *args, mode="X", engine="parity")}
    sub = freqs < 1.2                       # below every profile's f_H
    first = _first_exceeds(freqs, den, bmag, -1.0)
    assert np.array_equal(first, np.broadcast_to(sub, first.shape))
    _assert_vh(port["parity"], ref["parity"])
    par = np.asarray(ref["parity"])
    assert (par[:3, sub] == alt[0]).all() and np.isnan(par[3, sub]).all()
    for k in ("gather", "sweep"):
        # the JAX package's kernel engines: NaN on these rows
        assert np.isnan(np.asarray(ref[k])[:, sub]).all()
        got = port[k].numpy()
        _assert_vh(got[:, ~sub], np.asarray(ref[k])[:, ~sub])
        _assert_vh(got[:, sub], par[:, sub])
        assert (got[:3, sub] == alt[0]).all()
    # above 2 MHz the kernels and parity agree as well (chip_smoke.py
    # compares them at every frequency)
    kern = port["gather"].numpy()
    _assert_vh(kern[:, freqs > 2.0], par[:, freqs > 2.0])


def test_o_mode_first_exceedance_pairs_follow_the_parity_engine():
    """O pairs whose X is already 1 or more at the first node (a dense
    bottom, a frequency below its plasma frequency): every engine of the
    port gives what the JAX package's parity operator gives there (NaN:
    μ' is not valid above the cutoff), and what the JAX package's kernels
    give on every other pair."""
    args = _two_peak()         # 1.7e9 m^-3 at 90 km; the E peak's 1.2e11
    t = [_t(a) for a in args]
    first = _first_exceeds(args[0], args[1], args[2], 1.0)
    assert first[:, 0].all() and first[1].sum() > first[0].sum()
    par = np.asarray(JF.vertical_forward_operator_batch(*args, mode="O",
                                                        engine="parity"))
    kern = np.asarray(JV.ionogram_pallas_gather(*_j(args), mode_mult=1.0,
                                                interpret=True))
    port = {"gather": TV.ionogram_pallas_gather(*t, mode_mult=1.0),
            "host_solve": TV.plain_ionogram(TV.prepare_kernel_args(
                "gather", *t, 1.0, 200, TV.uniform_inv_dalt(t[4]))),
            "sweep": TV.ionogram_pallas(*t, mode_mult=1.0),
            "parity": TF.vertical_forward_operator_batch(
                *t, mode="O", engine="parity")}
    assert np.isnan(par[first]).all()
    for got in port.values():
        got = got.numpy()
        assert np.isnan(got[first]).all()
        _assert_vh(np.where(first, np.nan, got),
                   np.where(first, np.nan, kern))


@pytest.mark.parametrize("mode,mm,cases", [
    ("O", 1.0, ((1274, 12.5), (2919, 8.6), (9339, 10.7))),
    ("X", -1.0, ((7318, 2.8), (7342, 2.2)))])
def test_fast_vs_parity_beyond_1e6_km_is_the_jax_packages(mode, mm, cases):
    """On chip_smoke.py's 10,512-profile global grid (f64) the JAX
    package's gather kernel (interpret mode) and its parity operator part
    by more than 1e-6 km at these (profile, MHz) pairs only, by 1.1e-6 to
    2.1e-6 km. The port equals the JAX package on each engine, except on
    the X pairs, whose cutoff is already exceeded at the first node: there
    the port's kernel gives the parity operator's alt_min (the deliberate
    divergence), and the JAX kernel alt_min plus those 1e-6 km."""
    import chip_smoke as cs

    alt = np.linspace(80.0, 699.0, cs.N_ALT)
    rng = np.random.default_rng(cs.SEED)
    cs.profiles(rng, cs.B_MAIN, alt)
    g = cs.profiles(rng, cs.GLOBAL_GRID[0] * cs.GLOBAL_GRID[1], alt)
    rows = [r for r, _ in cases]
    freqs = np.array([f for _, f in cases])
    den, bmag, bpsi = (np.ascontiguousarray(a[rows]) for a in g)
    args = (freqs, den, bmag, bpsi, alt)
    t = [_t(a) for a in args]
    port_k = TV.ionogram_pallas_gather(*t, mode_mult=mm).numpy()
    port_p = TF.vertical_forward_operator_batch(*t, mode=mode,
                                                engine="parity").numpy()
    jax_k = np.asarray(JV.ionogram_pallas_gather(*_j(args[:4]), alt,
                                                 mode_mult=mm,
                                                 interpret=True))
    jax_p = np.asarray(JF.vertical_forward_operator_batch(
        *args, mode=mode, engine="parity"))
    first = _first_exceeds(freqs, den, bmag, mm)
    assert np.diag(first).all() == (mode == "X")
    assert not first.any() or mode == "X"
    _assert_vh(np.where(first, np.nan, port_k), np.where(first, np.nan,
                                                         jax_k))
    _assert_vh(port_p, jax_p)
    d = np.diag(jax_k - jax_p)
    assert np.all(np.abs(d) > 1e-6) and np.all(np.abs(d) < 3e-6)
    d = np.diag(port_k - port_p)
    if mode == "X":
        assert np.all(np.abs(d) <= 1e-12)
        assert np.array_equal(port_k[first], jax_p[first], equal_nan=True)
        assert np.abs(np.diag(port_k) - alt[0]).max() <= 1e-12
    else:
        assert np.all(np.abs(d) > 1e-6) and np.all(np.abs(d) < 3e-6)


@pytest.mark.parametrize("engine", ["gather_xsolve", "sweep", "auto"])
@pytest.mark.parametrize("n_points", [200, 20000])
def test_x_mode_matches_the_benchmark_reference(engine, n_points):
    """The port's X path on CPU tensors against the benchmark's plain
    reference (``hfbench/reference/vertical_forward.py``, the upstream's
    discretisation, which imports nothing of the port), on two of the
    benchmark's seeded profiles (Chapman layers under a dipole field) from
    0.2 to 12 MHz: the lowest frequencies lie below the gyrofrequency, so
    the cutoff is already exceeded at the first node there. Identical NaN
    masks and ≤ 1e-6 km (the engines read 3e-10 km at most)."""
    from hfbench import inputs
    from hfbench.reference import vertical_forward as ref

    alt = torch.linspace(80.0, 699.0, 620, dtype=torch.float64)
    traffic = {"profiles_per_call": 2, "pool_calls": 1, "sites": "random",
               "e_layer_share": 0.25}
    den, bmag, bpsi = inputs.profiles(traffic, 2 ** 33 + 17, alt,
                                      torch.device("cpu"))
    freq = torch.tensor([0.2, 0.5, 1.0, 1.4, 2.0, 3.5, 5.0, 8.0, 12.0],
                        dtype=torch.float64)
    first = _first_exceeds(freq.numpy(), den.numpy(), bmag.numpy(), -1.0)
    assert first[:, :2].all() and not first[:, 3:].any()
    want = ref.vertical_forward(freq, den, bmag, bpsi, alt, -1.0, n_points)
    args = (freq, den, bmag, bpsi, alt)
    TV.reset_counters()
    if engine == "gather_xsolve":
        got = TV.ionogram_pallas_gather(*args, mode_mult=-1.0,
                                        n_points=n_points)
        assert TV.PLAIN_CALLS["gather_xsolve"] == 1
    elif engine == "sweep":
        got = TV.ionogram_pallas(*args, mode_mult=-1.0, n_points=n_points)
        assert TV.PLAIN_CALLS["sweep"] == 1
    else:
        got = TF.vertical_forward_operator_batch(*args, mode="X",
                                                 n_points=n_points)
    # alt_min on one profile's sub-gyro pairs, NaN (μ' not valid) on the
    # other's
    assert torch.isfinite(want[first]).any() and torch.isnan(
        want[first]).any()
    _assert_vh(got, want.numpy())


@pytest.mark.parametrize("kind", ["gather_xsolve", "gather", "mxu", "sweep"])
def test_f32_first_exceedance_pairs_take_the_f64_verdict(kind):
    """Below the gyrofrequency in X mode the first node's X is nearly 0 and
    μ lies just above 1 there: float64 finds μ' not valid (NaN) where
    float32 rounds μ to 1 (valid). Each plain version in float32 takes
    float64's verdict on these pairs (``_first_node_valid``; the kernels'
    ``first_node_ok``), so its NaN mask there is float64's, on the
    benchmark's seeded profiles, where float32's own verdict parts from
    float64's on some pairs."""
    from hfbench import inputs

    alt = torch.linspace(80.0, 699.0, 620, dtype=torch.float64)
    traffic = {"profiles_per_call": 16, "pool_calls": 1, "sites": "random",
               "e_layer_share": 0.25}
    den, bmag, bpsi = inputs.profiles(traffic, 2 ** 33 + 29, alt,
                                      torch.device("cpu"))
    freq = torch.arange(1, 8, dtype=torch.float64) * 0.1
    first = _first_exceeds(freq.numpy(), den.numpy(), bmag.numpy(), -1.0)
    assert first.any()

    def node0_ok(dtype):
        f = (freq * 1e6).to(dtype)[None, :]
        X = den[:, :1].to(dtype) * (TV.CP * TV.CP) / (f * f)
        Y = bmag[:, :1].to(dtype) * TV.G_P / f
        one = torch.ones_like(X)
        return TV._mu_mup_stable_tile(X, Y, bpsi[:, :1].to(dtype)
                                      .expand_as(X), -1.0, one, -one)[1]

    parted = (node0_ok(torch.float32) != node0_ok(torch.float64)).numpy()
    assert (parted & first).any()

    def run(dtype):
        t = [a.to(dtype) for a in (freq, den, bmag, bpsi, alt)]
        if kind == "sweep":
            return TV.ionogram_fast_xla(*t, mode_mult=-1.0)
        return TV.plain_ionogram(TV.prepare_kernel_args(
            kind, *t, -1.0, 200, TV.uniform_inv_dalt(t[4])))

    v32, v64 = run(torch.float32).numpy(), run(torch.float64).numpy()
    assert np.array_equal(np.isnan(v32[first]), np.isnan(v64[first]))
    assert np.isnan(v64[first & parted]).all()
    # alt_min, within 3 ulp of float32 (μ'·1e-6 km rounds off at 80 km)
    fin = first & ~np.isnan(v64)
    assert np.abs(v32[fin] - v64[fin]).max() <= 3 * 7.7e-6
