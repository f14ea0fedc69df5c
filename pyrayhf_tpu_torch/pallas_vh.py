"""Ionogram synthesis kernels for Hopper: host prep, plain versions, wrappers.

Port of ``pyrayhf_tpu.pallas_vh``. The JAX package computes one
discretisation — flat-extended profile, reflection-height solve, per-
frequency stretched grid, piecewise-linear resample, Appleton–Hartree μ'
with the analytic near-reflection margin, Σ μ'·dh — in four Pallas
kernels whose differences exist to get around TPU gathers. Here all four
are instantiations of ONE templated CUDA kernel (``csrc/ionogram.cu``):

kernel (counter name) ← replaced TPU kernel; its plain PyTorch version:

* ``gather_osolve`` ← ``_kernel_gather_osolve`` (O, solve in the kernel,
  uniform index; an escaped pair reads no node but the top of cummax(den),
  a valid one searches that non-decreasing row for its crossing);
  ``_osolve_plain`` + ``_resample_plain``;
* ``gather_xsolve`` ← ``_kernel_gather_xsolve`` (X, solve in the kernel,
  uniform index; the kernel searches the first exceedance from a bracket
  on the cutoff-frequency table, :func:`cutoff_table`);
  ``_xsolve_plain`` + ``_resample_plain``;
* ``gather`` ← ``_kernel_gather`` (solve on the host, uniform index);
  :func:`prepare_profile_tables` + ``_resample_plain``;
* ``sweep`` ← ``_kernel`` (solve on the host, any grid: the segment of
  each point by a cursor each lane carries along the grid, equal to a
  binary search); :func:`ionogram_fast_xla`.

:func:`launch_shape` picks the launch layout from (B, F, P, the SM count
and the blocks an SM holds): a warp per (profile, frequency) on short
grids, a block per pair on long ones; escaped pairs do no work.

A fifth kernel, ``mxu`` ← ``_kernel_mxu`` (``csrc/ionogram_mxu.cu``),
computes what ``gather`` computes but does the resample as one-hot matrix
products on the tensor cores (``mma.sync``), as the TPU kernel did on its
matrix unit; its plain version ``_resample_mxu_plain`` does the same
products with ``torch.matmul``.

The in-kernel solves' segment table (flat extension, per-node
differences, cummax(den)) is built on the card by one more kernel,
``segment_table`` (``csrc/segment_table.cu``), before each launch of
``gather_osolve`` and ``gather_xsolve``; its plain version is
:func:`plain_segment_table`.

Each kernel is one record of :data:`KINDS` (its table, solve, grid, plain
version and launcher), which the functions here read in place of its
name. :func:`route` turns an engine into a launch config and makes the
one read of the grid; on CUDA tensors it keeps the config as a launch
plan per grid tensor (:class:`PlanStore`), so that a repeat call on an
unchanged grid reads nothing. Each wrapper runs the kernel on CUDA
tensors and the plain version on CPU tensors, and only there; on any
other device it raises. ``LAUNCHES`` counts kernel launches and
``PLAIN_CALLS`` calls of the plain versions, so a run can show which of
the two it went through; ``PLANS`` counts plans reused and made, and
calls run without the autograd Function.

Derivatives: a call that can be asked for none (no input records a
derivative, no transform is open) runs the kernel directly; any other
goes through :class:`_PallasAD` (the counterpart of the JAX
``_pallas_ad`` custom JVP), which runs the kernel forward and takes every
derivative (VJP, JVP, under ``torch.func`` transforms and
``torch.autograd.forward_ad`` alike) through the plain segment sweep
:func:`ionogram_fast_xla`, which evaluates the same discretisation; the
TPU kernels had no derivative kernel either. ``vmap`` of a wrapper over a
profile stack folds into one launch. PyTorch does not differentiate a
Function's jvp rule, so under two or more forward transforms (``jacfwd``
of ``jacfwd``) a wrapper returns the sweep plus :class:`_KernelGap`, the
kernel's value less the sweep's as a constant: every derivative order is
the sweep's, as in JAX, and the value stays the kernel's bit for bit.
"""

import collections
import dataclasses
import functools
import threading
import weakref
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from ._util import clip, host_f64, profile_tensors, scalar_like
from .config import resolve
from .constants import CP, G_P
from .profiling import span

__all__ = ["ionogram_pallas", "ionogram_pallas_gather", "ionogram_pallas_mxu",
           "ionogram_fast_xla", "prepare_profile_tables", "uniform_inv_dalt",
           "LAUNCHES", "PLAIN_CALLS", "PLANS", "reset_counters"]

_DH_BACKOFF = 1e-6
_NAN = float("nan")
_DEG2RAD = np.pi / 180.0

# kernel launches / plain-version calls, by kernel name; "segment_table"
# (csrc/segment_table.cu) builds kernels 1 and 2's table on the card, one
# launch before each of theirs; its plain version, which CPU tensors take,
# is host prep and is not counted
KERNELS = ("gather_osolve", "gather_xsolve", "gather", "sweep", "mxu",
           "segment_table")
LAUNCHES = dict.fromkeys(KERNELS, 0)
PLAIN_CALLS = dict.fromkeys(KERNELS, 0)
# launch plans (:func:`route`, on CUDA grids): "hit" a plan reused, "miss"
# one made anew; "direct" calls run without the autograd Function
# (:func:`run_engine`)
PLANS = dict.fromkeys(("hit", "miss", "direct"), 0)


def reset_counters():
    """Set every launch, plain-call and plan count to 0."""
    for k in KERNELS:
        LAUNCHES[k] = 0
        PLAIN_CALLS[k] = 0
    for k in PLANS:
        PLANS[k] = 0


def uniform_inv_dalt(alt):
    """1/Δalt for a uniformly spaced grid, else None (reads ``alt`` on host)."""
    a = host_f64(alt)
    if a.ndim != 1:
        return None
    d = np.diff(a)
    if d.size and np.allclose(d, d[0], rtol=1e-9, atol=1e-9):
        return float(1.0 / d[0])
    return None


def _flat_extend(den, bmag, bpsi, alt):
    """Flat-extend each profile at its density peak (ref truncation)."""
    B, N = den.shape
    ind_max = torch.argmax(den, dim=1)
    idx = torch.arange(N, device=den.device)
    keep = idx[None, :] < ind_max[:, None]
    last = torch.clamp(ind_max - 1, min=0)[:, None]

    def ext(a):
        return torch.where(keep, a, torch.gather(a, 1, last))

    alt_b = alt.expand(B, N)
    return ext(den), ext(bmag), ext(bpsi), ext(alt_b)


def _pack_segment_table(den_t, bmag_t, bpsi_t, alt_t):
    """Pack the per-segment piecewise-linear table [B, N, 8].

    Segment row j: [alt_j, 1/Δalt_j, den_j, Δden_j, bmag_j, Δbmag_j,
    bpsi_j, Δbpsi_j]; altitudes stored relative to alt[0].
    """
    dalt = torch.diff(alt_t, dim=1)
    inv_dalt = torch.where(dalt > 0,
                           1.0 / torch.where(dalt > 0, dalt, 1.0), 0.0)

    def pad(a):
        return torch.cat([a, a[:, -1:]], dim=1)

    return torch.stack([
        alt_t - alt_t[:, :1],
        pad(inv_dalt),
        den_t, pad(torch.diff(den_t, dim=1)),
        bmag_t, pad(torch.diff(bmag_t, dim=1)),
        bpsi_t, pad(torch.diff(bpsi_t, dim=1)),
    ], dim=2)


def _crossing(f0, f1, a0, a1, r0, first_exceeds, valid, base, alt0):
    """Critical height, slope and analytic-margin bound on the crossing
    segment [a0, a1] where the cutoff function goes f0 → f1 through 1.

    ``alt0`` is the grid's first altitude and ``base`` the same altitude
    in the frame of a0/a1 (``alt0`` in the absolute frame of the host
    prep, 0 in the relative frame the in-kernel solves use). Returns
    (crit, slope, emax) with the JAX package's masking: escaped rows
    collapse to a zero-span grid at ``base``.

    A pair whose cutoff is already exceeded at the first node reflects
    there, on a zero-span grid, and evaluates μ' directly, as the upstream
    does: its vh is alt0 plus μ'·Σ Δh, where Σ Δh is the rounding of the
    back-off in the absolute frame, fl(alt0 − 1e-6) − alt0 + 1e-6 (2.5e-15
    km at 80 km), or NaN where μ' is not valid there
    (:func:`_first_node_valid`). Both frames take the absolute frame's
    crit, ``(alt0 − 1e-6) − (alt0 − base)``; the relative frame's own,
    −1e-6 exactly, would leave a sum that is 0 in exact arithmetic, NaN on
    some pairs by rounding.
    """
    t = torch.where(f1 != f0, (1.0 - f0) / torch.where(f1 != f0, f1 - f0, 1.0),
                    0.0)
    crit = a0 + clip(t, 0.0, 1.0) * (a1 - a0)
    da = a1 - a0
    slope = torch.where((da > 0) & (f1 > f0),
                        (f1 - f0) / torch.where(da > 0, da, 1.0), 0.0)
    # The analytic near-reflection margin is exact only on the crossing
    # segment and only when the cutoff equals the local (non-cummax) value
    # there: a cummax-shadowed lower node (an E-peak above a valley) never
    # reaches 1 at crit. ``emax`` = cutoff margin at the lower node.
    genuine = r0 == f0
    emax = torch.where(genuine, torch.maximum(slope * (crit - a0),
                                              torch.zeros_like(slope)), 0.0)
    # np.interp edge semantics: cutoff already exceeded at the first node.
    # emax < 0 keeps the zero-span grid off the analytic branch: its margin
    # ε = 0 passes ε ≤ 0 and gives μ = 0, so no sample (the JAX package's
    # kernels and sweep give NaN there).
    crit = torch.where(first_exceeds, (alt0 - _DH_BACKOFF) - (alt0 - base),
                       torch.where(valid, crit, base) - _DH_BACKOFF)
    emax = torch.where(first_exceeds, -1.0, emax)
    slope = torch.where(valid, slope, 0.0)
    emax = torch.where(valid, emax, 0.0)
    return crit, slope, emax


def _o_crossing(dmax, den, alt, freq_hz):
    """O mode's crossing segment: :func:`_crossing`'s (f0, f1, a0, a1, r0,
    first_exceeds, valid), [B, F] each.

    ``dmax`` is cummax(den) of the flat-extended profiles ``den`` [B, N],
    ``alt`` [B, N] their altitudes in the caller's frame (absolute in the
    host prep, relative to alt0 in kernel 1's plain solve), ``freq_hz``
    [F]. cummax_j X[b, f, j] equals cummax_j(den)[b, j]·cp²/f² exactly
    (a positive factor is monotone), so the crossing index is a
    density-space count #{j: dmax_j < f²/cp²}, a left search of the
    non-decreasing row; then ±1 steps in X space, two each way, restore
    agreement at rounding razors.
    """
    B, N = dmax.shape
    cp2 = scalar_like(CP * CP, dmax)
    f = freq_hz[None, :]
    inv_f2 = 1.0 / (f * f)

    def Xval(kk):
        return torch.gather(dmax, 1, kk) * cp2 * inv_f2

    k = torch.searchsorted(dmax.contiguous(),
                           ((f * f) / cp2).expand(B, -1).contiguous())
    k = torch.clamp(k, 1, N - 1)
    for _ in range(2):
        k = torch.where((Xval(k - 1) >= 1.0) & (k > 1), k - 1, k)
    for _ in range(2):
        k = torch.where((Xval(k) < 1.0) & (k < N - 1), k + 1, k)
    f0 = Xval(k - 1)
    f1 = Xval(k)
    a0 = torch.gather(alt, 1, k - 1)
    a1 = torch.gather(alt, 1, k)
    r0 = torch.gather(den, 1, k - 1) * cp2 * inv_f2
    first_exceeds = (dmax[:, 0:1] * cp2) * inv_f2 >= 1.0
    valid = ((dmax[:, N - 1:N] * cp2) * inv_f2 >= 1.0).expand_as(f0)
    return f0, f1, a0, a1, r0, first_exceeds, valid


def _first_node_valid(valid, freq_hz, den0, bm0, bpsi0, mode_mult):
    """``valid`` [B, F] with float32's first-exceedance pairs decided in
    float64.

    Such a pair's vh is alt0 where μ' at the first node is valid, NaN
    where it is not (:func:`_crossing`). Below the gyrofrequency in X
    mode, X is nearly 0 there and μ lies just above 1: float64 finds μ'
    not valid where float32 rounds μ to 1 (valid). So float32 takes the
    verdict of μ' on the node's values promoted to float64, as
    ``first_node_ok`` in ``csrc/ionogram.cu`` does after kernels 1 and 2's
    solves; float64 keeps its own. ``den0``, ``bm0`` and ``bpsi0`` are the
    first node's [B] values; the pair exceeds there as the solves find it.
    """
    if den0.dtype != torch.float32:
        return valid
    f = freq_hz[None, :]
    s = den0[:, None] * scalar_like(CP * CP, den0) * (1.0 / (f * f))
    if mode_mult < 0:
        s = s + bm0[:, None] * G_P / f
    f = f.detach().double()
    X = den0.detach().double()[:, None] * (CP * CP) / (f * f)
    Y = bm0.detach().double()[:, None] * G_P / f
    psi = bpsi0.detach().double()[:, None].expand_as(X)
    one = torch.ones_like(X)
    _, ok = _mu_mup_stable_tile(X, Y, psi, mode_mult, one, -one)
    return valid & ((s < 1.0) | ok)


def prepare_profile_tables(freq_hz, den, bmag, bpsi, alt, mode_mult):
    """Host-side preprocessing shared by the solve-outside paths.

    Flat-extends each profile at its density peak, runs the monotone
    cutoff (cummax) and the crossing reflection-height solve, and packs
    the per-segment table. Returns (seg [B, N, 8], crit [B, F] finite,
    valid [B, F] bool, slope [B, F], emax [B, F]); ``slope`` is
    d(fcrit)/dh on the crossing segment (the analytic margin's rate).
    """
    den_t, bmag_t, bpsi_t, alt_t = _flat_extend(den, bmag, bpsi, alt)
    if mode_mult > 0:
        f0, f1, a0, a1, r0, first_exceeds, valid = _o_crossing(
            torch.cummax(den_t, dim=1).values, den_t, alt_t, freq_hz)
    else:
        B, N = den.shape
        F = freq_hz.shape[0]
        inv_f2 = 1.0 / (freq_hz * freq_hz)
        cp2 = scalar_like(CP * CP, den)
        X = den_t[:, None, :] * cp2 * inv_f2[None, :, None]
        Y = bmag_t[:, None, :] * G_P / freq_hz[None, :, None]
        s = X + Y
        fcrit = torch.cummax(s, dim=2).values
        valid = fcrit[:, :, -1] >= 1.0
        # crossing index by counting nodes below the cutoff (monotone rows)
        k = torch.clamp(torch.sum(fcrit < 1.0, dim=2), 1, N - 1)

        def take(a, kk):
            return torch.gather(a, 2, kk[:, :, None])[..., 0]

        f0 = take(fcrit, k - 1)
        f1 = take(fcrit, k)
        alt_bf = alt_t[:, None, :].expand(B, F, N)
        a0 = take(alt_bf, k - 1)
        a1 = take(alt_bf, k)
        r0 = take(s, k - 1)
        first_exceeds = 1.0 <= fcrit[:, :, 0]
    crit, slope, emax = _crossing(f0, f1, a0, a1, r0, first_exceeds, valid,
                                  alt_t[:, 0:1], alt_t[:, 0:1])
    valid = _first_node_valid(valid, freq_hz, den_t[:, 0], bmag_t[:, 0],
                              bpsi_t[:, 0], mode_mult)
    seg = _pack_segment_table(den_t, bmag_t, bpsi_t, alt_t)
    return seg, crit, valid, slope, emax


def _mu_mup_stable_tile(X, Y, psi_deg, mode_mult, eps_crit, eps_max):
    """μ' with the near-reflection small quantity supplied analytically.

    Expression-for-expression port of ``pallas_vh._mu_mup_stable_tile``
    (the CUDA kernel's ``mup_stable`` is the same sequence). ``eps_crit``
    is the cutoff margin (1−X for O-mode, 1−X−Y for X-mode) from the
    crossing-segment geometry, substituted where the sample lies on the
    crossing segment (``eps_crit ≤ eps_max``) and ``eps_crit < 1e-3``.

    Analytic-path factorisations (cancellation-free):
      O:  under = (Xm1² + s)/(Xm1 + s),            s = YL²Xm1²/(β + ½YT²)
      X:  under = Xm1²·ε·(Xm1+Y) / ((Xm1² + s)·D), D = Xm1 − ½YT² − β
    Returns (μ', ok) with μ' = 0 where not ok.
    """
    TH = 1e-3
    use_an = (eps_crit < TH) & (eps_crit <= eps_max)
    psi = psi_deg * _DEG2RAD
    sinp = torch.sin(psi)
    cosp = torch.cos(psi)
    YT = Y * sinp
    YL = Y * cosp

    if mode_mult > 0:
        Xm1 = torch.where(use_an, eps_crit, 1.0 - X)
    else:
        eps_u = torch.where(use_an, eps_crit, 1.0 - X - Y)
        Xm1 = torch.where(use_an, Y + eps_u, 1.0 - X)

    YT2 = YT * YT
    YL2 = YL * YL
    beta = torch.sqrt(0.25 * (YT2 * YT2) + YL2 * (Xm1 * Xm1))
    bsum = beta + 0.5 * YT2
    b_ok = bsum > 0.0
    bsum_safe = torch.where(b_ok, bsum, 1.0)
    s_term = torch.where(b_ok, YL2 * (Xm1 * Xm1) / bsum_safe, 0.0)
    conj = Xm1 * Xm1 + s_term                    # = Xm1² − ½YT² + β exactly

    if mode_mult > 0:
        D = Xm1 + s_term
        d_ok = D != 0.0
        D_safe = torch.where(d_ok, D, 1.0)
        under = conj / D_safe
    else:
        D = Xm1 - 0.5 * YT2 - beta
        d_ok = D != 0.0
        D_safe = torch.where(d_ok, D, 1.0)
        conj_safe = torch.where(conj > 0.0, conj, 1.0)
        under_an = (Xm1 * Xm1) * eps_u * (Xm1 + Y) / (conj_safe * D_safe)
        under = torch.where(use_an, under_an, 1.0 - X * Xm1 / D_safe)
        d_ok = d_ok & (~use_an | (conj > 0.0))

    u_ok = (under >= 0.0) & d_ok
    mu = torch.where(u_ok, torch.sqrt(torch.where(u_ok, under, 1.0)), 1.0)
    mu_le1 = mu <= 1.0

    bb_ok = beta > 0.0
    beta_safe = torch.where(bb_ok, beta, 1.0)

    m_ok = u_ok & bb_ok & (mu > 0.0) & mu_le1
    mu_safe = torch.where(m_ok, mu, 1.0)
    if mode_mult > 0:
        # feed the (discarded) naive derivative branch harmless inputs on
        # analytic lanes: its 1/D⁴-scale cotangents would overflow into
        # inf·0 = NaN (double-where guard)
        Xm1_nv = torch.where(use_an, 1.0, Xm1)
        D_nv = torch.where(use_an, 1.0, D_safe)
        mu_nv = torch.where(use_an, 1.0, mu_safe)
    else:
        Xm1_nv, D_nv, mu_nv = Xm1, D_safe, mu_safe
    dbetadX = -YL2 * Xm1_nv / beta_safe
    dDdX = -1.0 + mode_mult * dbetadX
    dalphadY = YT * YT2 * sinp + 2.0 * YL * (Xm1_nv * Xm1_nv) * cosp
    dbetadY = 0.5 * dalphadY / beta_safe
    dDdY = -YT * sinp + mode_mult * dbetadY
    dmudY = (X * Xm1_nv * dDdY) / (2.0 * mu_nv * (D_nv * D_nv))
    dmudX = (1.0 / (2.0 * mu_nv * D_nv)) * (
        2.0 * X - 1.0 + X * Xm1_nv / D_nv * dDdX)
    if mode_mult > 0:
        # cancellation-free expansions with X ≡ 1 − Xm1 on analytic lanes
        # (c = YL²/(β+½YT²), D = Xm1·(1+c·Xm1)); see the JAX docstring
        cfac = torch.where(b_ok, YL2 / bsum_safe, 0.0)
        onepr = 1.0 + cfac * Xm1
        T_st = (-1.0 + cfac * (1.0 - 2.0 * Xm1)
                - YL2 / beta_safe * (1.0 - Xm1))
        dmudX_st = T_st / (2.0 * mu_safe * (onepr * onepr))
        q_st = cosp - YT * sinp * YL / bsum_safe
        dmudY_st = X * YL * Xm1 * q_st / (2.0 * mu_safe * beta_safe
                                          * (onepr * onepr))
        dmudX = torch.where(use_an, dmudX_st, dmudX)
        dmudY = torch.where(use_an, dmudY_st, dmudY)
    mup = mu - (2.0 * X * dmudX + Y * dmudY)
    ok = m_ok & torch.isfinite(mup)

    # per-element isotropic fallback for unmagnetised samples
    iso_ok = Xm1 > 0.0
    iso_mup = 1.0 / torch.sqrt(torch.where(iso_ok, Xm1, 1.0))
    unmag = torch.abs(Y) < 1e-12
    mup = torch.where(unmag, torch.where(iso_ok, iso_mup, 0.0),
                      torch.where(ok, mup, 0.0))
    ok = (unmag & iso_ok) | (~unmag & ok)
    ok = ok & (mup > 0.0) & (mup <= 1e7)
    return mup, ok


def _stretched_grid_tables(n_points):
    """Static stretched-grid vectors in f64: (mult, 1−mult, Δmult).

    The multiplier and its complement/differences MUST be formed in f64
    before any cast to the working dtype: near the reflection point the
    grid spacing is ~6e-6·span out of mult≈1, i.e. ≲2e-8 relative — below
    f32 eps — so diff/one-minus on an f32 ``mult`` collapses and the
    singular μ′ tail integrates ~0.09 km wrong on the X-mode 20k workload.
    """
    u = np.linspace(0.0, 1.0, n_points)
    factor = (np.exp(10.0 * (1.0 - u)) - 1.0) / (np.exp(10.0) - 1.0)
    mult = 1.0 - factor
    dmult = np.concatenate([np.diff(mult), [0.0]])
    return mult, factor, dmult


def _grid_tensors(n_points, like):
    """(mult, 1−mult, Δmult) as [P] tensors in ``like``'s dtype/device."""
    return _grid_tensors_on(n_points, like.dtype, like.device)


@functools.lru_cache(maxsize=64)
def _grid_tensors_on(n_points, dtype, device):
    # kept per (P, dtype, device), so that a loop of forward calls (the LM
    # retrieval) copies nothing from the host; the one copy to the card
    # goes from pinned memory without waiting for the stream; made outside
    # any torch.func transform, which could wrap the cached copies
    out = []
    with torch._C._DisableFuncTorch():
        for a in _stretched_grid_tables(n_points):
            t = torch.from_numpy(a).to(dtype)
            if device.type == "cuda":
                t = t.pin_memory().to(device, non_blocking=True)
            out.append(t.to(device))
    return tuple(out)


class GridValues(NamedTuple):
    """What a launch reads that derives from the frequencies and the
    altitude grid alone: the frequencies in Hz [F], min(alt) [1] and the
    stretched grid's (mult, 1−mult, Δmult) [P]."""
    freq_hz: torch.Tensor
    alt_min: torch.Tensor
    mult: torch.Tensor
    omm: torch.Tensor
    dmult: torch.Tensor


def grid_values(freq_mhz, alt, n_points, like):
    """The :class:`GridValues` of ``freq_mhz`` [F] MHz and ``alt`` [N] at
    ``n_points``, the stretched grid in ``like``'s dtype and device."""
    return GridValues(freq_mhz * 1e6, torch.amin(alt).reshape(1),
                      *_grid_tensors(n_points, like))


def ionogram_fast_xla(freq_mhz, den, bmag, bpsi, alt, mode_mult=1.0,
                      n_points=200, device=None):
    """Gather-free segment sweep of the fused kernel, in plain PyTorch.

    The public ``"xla"`` engine, the plain version of the sweep kernel and
    the gradient path of every kernel. Same math as the JAX
    ``ionogram_fast_xla``: a loop over the profile's N−1 segments adds
    each saturated hat weight to [B, F, P] accumulators. Runs on any
    device and is differentiable by autograd. Host arrays go to the CUDA
    card unless ``device`` says otherwise (``device="cpu"``).
    """
    PLAIN_CALLS["sweep"] += 1
    return _sweep(*profile_tensors(freq_mhz, den, bmag, bpsi, alt,
                                   device=device), mode_mult, n_points)


def _sweep(freq_mhz, den, bmag, bpsi, alt, mode_mult, n_points):
    """:func:`ionogram_fast_xla` on tensors, uncounted: the derivative
    rule's calls are not a plain version standing in for a kernel."""
    freq_hz = freq_mhz * 1e6
    B, N = den.shape

    seg, crit, valid, slope, emax = prepare_profile_tables(
        freq_hz, den, bmag, bpsi, alt, mode_mult)
    mult, omm, dmult = _grid_tensors(n_points, den)
    span = crit - alt[0]                                     # [B, F]
    # work in altitudes relative to alt0, matching the packed table
    new_alt = span[:, :, None] * mult
    is_last = torch.arange(n_points, device=den.device) == n_points - 1
    dh = torch.where(is_last, _DH_BACKOFF, span[:, :, None] * dmult)

    d = seg[:, 0, 2][:, None, None]
    bm = seg[:, 0, 4][:, None, None]
    bp = seg[:, 0, 6][:, None, None]
    for j in range(N - 1):
        a_j = seg[:, j, 0][:, None, None]
        inv = seg[:, j, 1][:, None, None]
        tt = clip((new_alt - a_j) * inv, 0.0, 1.0)
        d = d + tt * seg[:, j, 3][:, None, None]
        bm = bm + tt * seg[:, j, 5][:, None, None]
        bp = bp + tt * seg[:, j, 7][:, None, None]
    shape = new_alt.shape
    d, bm, bp = d.expand(shape), bm.expand(shape), bp.expand(shape)

    f = freq_hz[None, :, None]
    X = d * (CP * CP) / (f * f)
    Y = bm * G_P / f
    eps = slope[:, :, None] * (span[:, :, None] * omm + _DH_BACKOFF)
    mup, ok = _mu_mup_stable_tile(X, Y, bp, mode_mult, eps,
                                  emax[:, :, None])
    ih = torch.sum(torch.where(ok, mup * dh, 0.0), dim=2)
    min_alt = torch.amin(alt)
    return torch.where(valid & (ih != 0.0), ih + min_alt, _NAN)


# --------------------------------------------------------------------------
# Kernel arguments (host prep) and the plain versions of kernels 1-3
# --------------------------------------------------------------------------

@dataclasses.dataclass
class KernelArgs:
    """Everything one kernel launch reads, prepared on the inputs' device.

    ``tab`` is the channel-major segment table [B, C, ld] (channels as in
    :func:`_pack_segment_table`, plus cummax(den) as channel 8 for the
    O-mode in-kernel solve) over ``n_alt`` altitude nodes; for kernels 1
    to 3 (``gather_osolve``, ``gather_xsolve``, ``gather``) the rows are
    zero-padded to a stride ``ld`` of a multiple of 16 bytes
    (:func:`padded_rows`), which their bulk copies need, else
    ``ld == n_alt``. ``span``/``slope``/
    ``emax``/``valid`` [B, F] are set when the solve runs outside the
    kernel. ``inv_dalt`` selects the arithmetic index (uniform grid);
    None the upper-bound one. For ``kind="mxu"``, ``tab`` is the one-hot
    table [B, 128, K1] of :func:`_mxu_table`.
    """
    kind: str
    mode_mult: float
    tab: torch.Tensor
    freq_hz: torch.Tensor
    mult: torch.Tensor
    omm: torch.Tensor
    dmult: torch.Tensor
    alt_min: torch.Tensor
    inv_dalt: Optional[float]
    span: Optional[torch.Tensor] = None
    slope: Optional[torch.Tensor] = None
    emax: Optional[torch.Tensor] = None
    valid: Optional[torch.Tensor] = None
    n_alt: Optional[int] = None


def padded_rows(n_alt, itemsize):
    """Row stride of kernels 1 to 3's table: ``n_alt`` rounded up to a
    multiple of 16 bytes (the TMA bulk copy's unit)."""
    per = 16 // itemsize
    return -(-n_alt // per) * per


def _rows(tab, padded):
    """``tab`` [B, C, N], contiguous, its rows zero-padded to a multiple of
    16 bytes where ``padded``."""
    if not padded:
        return tab.contiguous()
    N = tab.shape[2]
    pad = padded_rows(N, tab.element_size()) - N
    return torch.nn.functional.pad(tab, (0, pad)).contiguous()


def plain_segment_table(kind, den, bmag, bpsi, alt):
    """The segment table of kernels 1 and 2 in PyTorch ops, on any device:
    the plain version of ``csrc/segment_table.cu``.

    :func:`_pack_segment_table`'s channels of the flat-extended profiles,
    channel-major [B, C, ld] with rows zero-padded (:func:`_rows`), C the
    kind's channels (:data:`KINDS`): 9 with cummax(den) as channel 8
    (``gather_osolve``), else 8.
    """
    k = KINDS[kind]
    den_t, bmag_t, bpsi_t, alt_t = _flat_extend(den, bmag, bpsi, alt)
    seg = _pack_segment_table(den_t, bmag_t, bpsi_t, alt_t)
    chans = [seg.transpose(1, 2)]
    if k.channels > 8:
        chans.append(torch.cummax(den_t, dim=1).values[:, None, :])
    return _rows(torch.cat(chans, dim=1), k.padded)


def launch_segment_table(kind, den, bmag, bpsi, alt):
    """Launch ``csrc/segment_table.cu``: :func:`plain_segment_table`'s
    table, bit for bit, in one pass on the card.

    ``den``, ``bmag``, ``bpsi`` [B, N] and ``alt`` [N] CUDA tensors of one
    dtype; a row expanded over the batch (row stride 0) is read as it is,
    other layouts without unit stride along N are made contiguous.
    Launches on the current stream and raises on any CUDA error the launch
    reports.
    """
    from . import cuda_ext

    dtype, dev = den.dtype, den.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"unsupported dtype {dtype}")
    if kind not in KINDS or not KINDS[kind].solve:
        raise ValueError(f"no segment-table kernel for {kind!r}")
    if den.dim() != 2:
        raise ValueError(f"den must be [B, N], got {tuple(den.shape)}")
    B, N = den.shape
    if (bmag.shape != den.shape or bpsi.shape != den.shape
            or alt.shape != (N,) or N < 2 or B == 0):
        raise ValueError(f"bad profile shapes den {tuple(den.shape)}, bmag "
                         f"{tuple(bmag.shape)}, bpsi {tuple(bpsi.shape)}, "
                         f"alt {tuple(alt.shape)}")
    for t in (bmag, bpsi, alt):
        if t.dtype != dtype or t.device != dev:
            raise ValueError("profile tensors must share dtype and device")
    rows = [x if x.stride(1) == 1 else x.contiguous()
            for x in (den, bmag, bpsi)]
    alt = alt if alt.stride(0) == 1 else alt.contiguous()
    C = KINDS[kind].channels
    ld = padded_rows(N, den.element_size())
    tab = torch.empty((B, C, ld), dtype=dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = cuda_ext.load().pyrayhf_segment_table(
            0 if dtype == torch.float32 else 1,
            *(v for x in rows for v in (x.data_ptr(), x.stride(0))),
            alt.data_ptr(), B, N, C, ld, tab.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"segment table kernel launch failed: "
                           f"{cuda_ext.error_string(err)} ({err})")
    LAUNCHES["segment_table"] += 1
    return tab


def prepare_kernel_args(kind, freq_mhz, den, bmag, bpsi, alt, mode_mult,
                        n_points, inv_dalt, grid=None):
    """Host prep for one of the four kernels (torch ops on den's device;
    kernels 1 and 2's table by ``csrc/segment_table.cu`` on the card).
    ``grid`` is :func:`grid_values` of ``freq_mhz`` and ``alt`` where the
    caller holds them (a launch plan, :func:`route`); None computes them."""
    if grid is None:
        grid = grid_values(freq_mhz, alt, n_points, den)
    common = dict(kind=kind, mode_mult=mode_mult, inv_dalt=inv_dalt,
                  n_alt=den.shape[1], **grid._asdict())
    k = KINDS[kind]
    if k.solve:
        table = (launch_segment_table if den.device.type == "cuda"
                 else plain_segment_table)
        return KernelArgs(tab=table(kind, den, bmag, bpsi, alt), **common)
    seg, crit, valid, slope, emax = prepare_profile_tables(
        grid.freq_hz, den, bmag, bpsi, alt, mode_mult)
    tab = (_mxu_table(seg) if k.one_hot
           else _rows(seg.transpose(1, 2), k.padded))
    return KernelArgs(tab=tab,
                      span=(crit - alt[0]).contiguous(),
                      slope=slope.contiguous(), emax=emax.contiguous(),
                      valid=valid.to(torch.uint8).contiguous(), **common)


def _table(a):
    """The segment table of prepared args without its row padding."""
    return a.tab[:, :, :a.n_alt]


def _osolve_plain(a):
    """O-mode in-kernel solve (``_osolve_tile``) on the table, [B, F] each:
    :func:`_o_crossing` on the table's cummax(den) row, crossing geometry
    in the relative-altitude frame."""
    tab = _table(a)
    f0, f1, a0, a1, r0, first_exceeds, valid = _o_crossing(
        tab[:, 8], tab[:, 2], tab[:, 0], a.freq_hz)
    span, slope, emax = _crossing(f0, f1, a0, a1, r0, first_exceeds, valid,
                                  0.0, a.alt_min)
    return span, slope, emax, valid


def _xsolve_plain(a):
    """X-mode in-kernel solve (``_xsolve_tile``) on the table, [B, F] each.

    The crossing is the first exceedance of the raw s = X+Y; f0/f1 are
    prefix maxima of the same s values, r0 the raw s at k−1.
    """
    tab, f = _table(a), a.freq_hz[None, :, None]
    B, _, N = tab.shape
    alt_rel, den, bm = tab[:, 0], tab[:, 2], tab[:, 4]
    cp2 = scalar_like(CP * CP, tab)
    gp = scalar_like(G_P, tab)
    inv_f2 = 1.0 / (f * f)
    # same op ORDER as the dense path: X = (den·cp²)/f², Y = (|B|·g_p)/f
    s = den[:, None, :] * cp2 * inv_f2 + bm[:, None, :] * gp / f  # [B,F,N]
    exceed = s >= 1.0
    first = torch.argmax(exceed.to(torch.uint8), dim=2)
    k_first = torch.where(exceed.any(dim=2), first, N)
    valid = k_first < N
    k = torch.clamp(k_first, 1, N - 1)[:, :, None]
    f0 = torch.gather(torch.cummax(s, dim=2).values, 2, k - 1)[..., 0]
    s_k = torch.gather(s, 2, k)[..., 0]
    f1 = torch.maximum(f0, s_k)
    r0 = torch.gather(s, 2, k - 1)[..., 0]
    a0 = torch.gather(alt_rel, 1, k[..., 0] - 1)
    a1 = torch.gather(alt_rel, 1, k[..., 0])
    span, slope, emax = _crossing(f0, f1, a0, a1, r0, exceed[:, :, 0],
                                  valid, 0.0, a.alt_min)
    return span, slope, emax, valid


# the relative margin in f of kernel 2's cutoff-frequency bracket
# (derived in csrc/ionogram.cu, ``Margin``)
XSOLVE_MARGIN = {torch.float32: 1e-5, torch.float64: 1e-12}


def cutoff_frequencies(a):
    """fx_j = (f_H + sqrt(f_H² + 4 f_p²)) / 2 [B, N] on prepared args, the
    frequency at which s_j = X_j + Y_j = 1 (f_H = |B|·g_p, f_p² =
    den·cp²), in kernel 2's operation order; +inf at nodes with den or |B|
    negative or NaN."""
    tab = _table(a)
    den, bm = tab[:, 2], tab[:, 4]
    fh = bm * scalar_like(G_P, tab)
    fx = (fh + torch.sqrt(fh * fh + 4.0 * (den * scalar_like(CP * CP, tab)))
          ) * 0.5
    return torch.where((den >= 0) & (bm >= 0), fx, float("inf"))


def cutoff_table(a):
    """Kernel 2's cutoff-frequency table [B, N]: the prefix maximum cfx_j
    of :func:`cutoff_frequencies`.

    The kernel's X solve skips the nodes below the first j with cfx_j ≥
    f·(1 − δ) (no s_j there reaches 1) and declares a pair escaped when
    there is none (δ = :data:`XSOLVE_MARGIN`).
    """
    return torch.cummax(cutoff_frequencies(a), dim=1).values


def _uniform_index(pos, n_alt):
    """Segment index and fraction on a uniform grid: ``i0 = clamp(floor(
    pos), 0, N−2)`` (int64) and ``frac = clip(pos − i0, 0, 1)``."""
    i0 = torch.clamp(torch.floor(pos), 0, n_alt - 2)
    return i0.to(torch.int64), clip(pos - i0, 0.0, 1.0)


def _quad_sum(a, sp, d, bm, bp, slope, emax):
    """The kernels' tail on resampled [b, F, P] rows: μ' + Σ μ'·dh → [b, F].

    ``sp`` is span [b, F, 1]; ``slope``/``emax`` are [b, F].
    """
    P = a.mult.shape[0]
    f = a.freq_hz[None, :, None]
    is_last = torch.arange(P, device=d.device) == P - 1
    dh = torch.where(is_last, _DH_BACKOFF, sp * a.dmult)
    X = d * (CP * CP) / (f * f)
    Y = bm * G_P / f
    eps = slope[:, :, None] * (sp * a.omm + _DH_BACKOFF)
    mup, ok = _mu_mup_stable_tile(X, Y, bp, a.mode_mult, eps,
                                  emax[:, :, None])
    return torch.sum(torch.where(ok, mup * dh, 0.0), dim=2)


def _resample_plain(a, span, slope, emax):
    """Gather resample + μ' + Σ μ'·dh on the uniform grid → ih [B, F].

    The index is ``floor(span·mult/Δalt)`` clamped to [0, N−2], as in the
    gather kernels. Profiles are processed in chunks so that the [b, F, P]
    workspace stays near 2**25 elements.
    """
    tab = _table(a)
    B, _, N = tab.shape
    F, P = a.freq_hz.shape[0], a.mult.shape[0]
    mi = a.mult * a.inv_dalt
    step = max(1, (1 << 25) // max(1, F * P))
    out = []
    for b0 in range(0, B, step):
        sl = slice(b0, b0 + step)
        sp = span[sl][:, :, None]
        i0, frac = _uniform_index(sp * mi, N)                # [b, F, P]
        idx = i0.reshape(i0.shape[0], F * P)

        def gat(c):
            return torch.gather(tab[sl, c], 1, idx).reshape(i0.shape)

        d = gat(2) + frac * gat(3)
        bm = gat(4) + frac * gat(5)
        bp = gat(6) + frac * gat(7)
        out.append(_quad_sum(a, sp, d, bm, bp, slope[sl], emax[sl]))
    return torch.cat(out, dim=0)


_K2 = 16        # segment offsets per one-hot column of the mxu table


def _mxu_table(seg):
    """Segment table [B, N, 8] → the mxu kernel's one-hot table [B, 128, K1].

    Rows are padded with zeros to K1·K2 (K1 = ⌈N/16⌉, K2 = 16), then laid
    out so that ``T[b, q, a] = seg[b, a·16 + q//8, q%8]``: column ``a``
    holds the 16 segment rows a·16 … a·16+15, 8 channels each (the TPU
    kernel's pre-transposed [K2·8, K1] operand).
    """
    B, N, C = seg.shape
    K1 = -(-N // _K2)
    pad = seg.new_zeros((B, K1 * _K2 - N, C))
    return (torch.cat([seg, pad], dim=1).reshape(B, K1, _K2 * C)
            .transpose(1, 2).contiguous())


def _resample_mxu_plain(a, span, slope, emax):
    """Factorised one-hot resample + μ' + Σ μ'·dh → ih [B, F].

    The mxu kernel's own way, as ``pallas_vh._kernel_mxu`` does it: with
    ``i0 = a·16 + bb``, ``U = T[b]·onehot(a)`` ([128, K1]·[K1, F·P],
    ``torch.matmul``), the rows of U outside the bb-th 8-row group masked
    to zero, then the [8, 128] fold to the 8 channels of segment ``i0``.
    Every product sums one 1·T term with zeros, so the rows are exact (on
    the card, with TF32 matmul off). Profiles are processed in chunks so
    that the [b, 128, F·P] products stay near 2**25 elements.
    """
    tab = a.tab
    B, R, K1 = tab.shape
    F, P = a.freq_hz.shape[0], a.mult.shape[0]
    dev, dtype = tab.device, tab.dtype
    mi = a.mult * a.inv_dalt
    iota_a = torch.arange(K1, device=dev)[:, None]            # [K1, 1]
    row_b = torch.arange(R, device=dev)[:, None] // 8          # [R, 1]
    fold = (torch.arange(R, device=dev)[None, :] % 8
            == torch.arange(8, device=dev)[:, None]).to(dtype)  # [8, R]
    step = max(1, (1 << 25) // max(1, R * F * P))
    out = []
    for b0 in range(0, B, step):
        sl = slice(b0, b0 + step)
        sp = span[sl][:, :, None]
        i0, frac = _uniform_index(sp * mi, a.n_alt)          # [b, F, P]
        nb = i0.shape[0]
        i0 = i0.reshape(nb, 1, F * P)
        ai = torch.div(i0, _K2, rounding_mode="floor")
        bi = i0 - ai * _K2
        onehot = (iota_a == ai).to(dtype)                     # [b, K1, FP]
        U = torch.matmul(tab[sl], onehot)                     # [b, R, FP]
        w = (row_b == bi).to(dtype)
        out8 = torch.matmul(fold, w * U).reshape(nb, 8, F, P)
        d = out8[:, 2] + frac * out8[:, 3]
        bm = out8[:, 4] + frac * out8[:, 5]
        bp = out8[:, 6] + frac * out8[:, 7]
        out.append(_quad_sum(a, sp, d, bm, bp, slope[sl], emax[sl]))
    return torch.cat(out, dim=0)


def _host_solve(a):
    """The host prep's solve as prepared args carry it (kernels 3 and 5)."""
    return a.span, a.slope, a.emax, a.valid != 0


def plain_ionogram(a):
    """The plain PyTorch version of kernel ``a.kind`` on prepared args.

    Computes exactly what the kernel computes, in the kernel's own way
    (its solve, its index, its μ' tail), on any device.
    """
    PLAIN_CALLS[a.kind] += 1
    k = KINDS[a.kind]
    if k.plain_solve is None:
        raise ValueError(f"no prepared-args plain version for {a.kind!r} "
                         "(the sweep's plain version is ionogram_fast_xla)")
    span, slope, emax, valid = k.plain_solve(a)
    if k.solve:
        # after the solve, as kernels 1 and 2 take it (first_node_ok)
        tab = _table(a)
        valid = _first_node_valid(valid, a.freq_hz, tab[:, 2, 0],
                                  tab[:, 4, 0], tab[:, 6, 0], a.mode_mult)
    ih = k.plain_resample(a, span, slope, emax)
    return torch.where(valid & (ih != 0.0), ih + a.alt_min, _NAN)


# --------------------------------------------------------------------------
# Kernel launch
# --------------------------------------------------------------------------

_WARPS = 8                      # warps per block (256 threads)
_MAX_GROUPS = 65535             # the launch grid's y extent
# a block per (profile, frequency) once each of its threads has this many
# points, and as many as each warp the card holds at once would have pairs
# in the warp layout (the crossover timed by tools/ionogram_attribution.py)
_BLOCK_STRIDES = 4
# warp layout: blocks per resident block of the card, so that the block
# scheduler evens out profiles with more or fewer valid frequencies
_WAVES = 8


class Layout(NamedTuple):
    """How ``csrc/ionogram.cu`` is launched: a [B, n_groups] grid of blocks
    of ``warps`` warps; group g takes frequencies g, g + n_groups, ...;
    ``per_block`` puts a whole block on each (profile, frequency), else a
    warp."""
    n_groups: int
    warps: int
    per_block: bool


def launch_shape(B, F, P, n_sm, blocks_per_sm):
    """The :class:`Layout` of a [B, F] launch of ``csrc/ionogram.cu`` at P
    grid points on ``n_sm`` SMs, each of which holds ``blocks_per_sm``
    blocks of the kernel at once.

    Blocks of 8 warps. A block per pair, one frequency per group, once
    each of the block's threads has at least ``_BLOCK_STRIDES`` points and
    at least as many points as each warp the card holds would have pairs
    in the warp layout: then a warp per pair would leave the card part
    idle while its last warps end, and a block per pair pays back its own
    table load and solve. Else a warp per pair, with the frequencies split
    into as many groups as give about ``_WAVES`` blocks for each block the
    card holds at once, and never fewer than one frequency per warp: more
    blocks even out the work, each loads the table once more.
    """
    slots = n_sm * max(1, blocks_per_sm)
    pairs_per_warp = B * F / (slots * _WARPS)
    if P >= 32 * _WARPS * max(_BLOCK_STRIDES, pairs_per_warp):
        return Layout(min(F, _MAX_GROUPS), _WARPS, True)
    n_groups = max(1, min(round(_WAVES * slots / B), -(-F // _WARPS),
                          _MAX_GROUPS))
    return Layout(n_groups, _WARPS, False)


def mxu_launch_shape(B, F, n_sm):
    """(frequencies per block, warps per block) of a [B, F] launch of
    ``csrc/ionogram_mxu.cu``: one block per (profile, contiguous frequency
    group); groups are split only as far as needed to put about four
    blocks on every SM."""
    n_groups = max(1, min(-(-F // _WARPS), -(-4 * n_sm // B)))
    return -(-F // n_groups), _WARPS


@functools.lru_cache(maxsize=64)
def blocks_per_sm(device_index, dtype_code, mode, solve, uniform, C, N, ld):
    """Blocks of ``_WARPS`` warps of one ``csrc/ionogram.cu`` instantiation
    that one SM of CUDA device ``device_index`` holds at once with a
    [C, N] table of row stride ``ld``: the CUDA occupancy calculator, from
    the registers the compiler allotted and the block's shared memory."""
    from . import cuda_ext
    lib = cuda_ext.load()
    with torch.cuda.device(device_index):
        n = lib.pyrayhf_ionogram_blocks_per_sm(
            dtype_code, mode, int(solve), int(uniform), C, N, ld, _WARPS)
    if n < 0:
        raise RuntimeError(f"ionogram kernel occupancy: "
                           f"{cuda_ext.error_string(-n)} ({-n})")
    return n


def kernel_layout(a):
    """The :class:`Layout` :func:`launch_kernel` launches prepared args
    ``a`` in, on the card ``a`` lies on."""
    B, C, ld = a.tab.shape
    F, P = a.freq_hz.shape[0], a.mult.shape[0]
    dev = a.tab.device
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    k = KINDS[a.kind]
    bps = blocks_per_sm(dev.index, int(a.tab.dtype == torch.float64),
                        1 if a.mode_mult > 0 else -1, k.solve, k.uniform, C,
                        a.n_alt, ld)
    return launch_shape(B, F, P, n_sm, bps)


def ionogram_smem_bytes(kind, C, N, ld, itemsize):
    """Dynamic shared memory of one ``csrc/ionogram.cu`` block. Kernel 4:
    the [C, N] table and 8 warp sums. Kernels 1 to 3: 128 bytes of
    barrier, flag and sums, the 8 channels at row stride ``ld`` and, for
    the in-kernel solves, a 9th row (kernel 1's cummax(den), kernel 2's
    cutoff table)."""
    k = KINDS[kind]
    if not k.uniform:
        return itemsize * (C * N + 8)
    return 128 + itemsize * (8 + k.solve) * ld


def launch_kernel(a):
    """Launch ``csrc/ionogram.cu`` for prepared args; returns vh [B, F].

    Checks device, dtype and contiguity, launches on the current stream in
    :func:`kernel_layout`'s layout, and raises on any CUDA error the launch
    reports.
    """
    from . import cuda_ext

    tab = a.tab
    dtype, dev = tab.dtype, tab.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"unsupported dtype {dtype}")
    k = KINDS[a.kind]
    if k.uniform and a.inv_dalt is None:
        raise ValueError(f"kernel {a.kind!r} needs a uniform grid")
    B, C, ld = tab.shape
    N = a.n_alt
    F, P = a.freq_hz.shape[0], a.mult.shape[0]
    if N < 2 or F == 0 or B == 0:
        raise ValueError(f"degenerate launch B={B} F={F} N={N}")
    need = [tab, a.freq_hz, a.mult, a.omm, a.dmult, a.alt_min]
    if not k.solve:
        need += [a.span, a.slope, a.emax]
    for t in need:
        if t.dtype != dtype or t.device != dev or not t.is_contiguous():
            raise ValueError("kernel operands must share dtype and device "
                             "and be contiguous")
    smem = ionogram_smem_bytes(a.kind, C, N, ld, tab.element_size())
    if smem > cuda_ext.MAX_SMEM_BYTES:
        raise ValueError(f"profile table of {smem} bytes exceeds the "
                         f"{cuda_ext.MAX_SMEM_BYTES}-byte shared memory of "
                         "one block (N_alt too large)")
    out = torch.empty((B, F), dtype=dtype, device=dev)
    code = 0 if dtype == torch.float32 else 1
    mode = 1 if a.mode_mult > 0 else -1

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        lay = kernel_layout(a)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = cuda_ext.load().pyrayhf_ionogram(
            code, mode, int(k.solve), int(k.uniform),
            ptr(tab), C, B, N, ld, ptr(a.mult), ptr(a.omm), ptr(a.dmult), P,
            ptr(a.freq_hz), F, lay.n_groups, lay.warps, int(lay.per_block),
            ptr(a.span), ptr(a.slope), ptr(a.emax), ptr(a.valid),
            ptr(a.alt_min), float(a.inv_dalt or 0.0), ptr(out), stream)
    if err != 0:
        raise RuntimeError(f"ionogram kernel launch failed: "
                           f"{cuda_ext.error_string(err)} ({err})")
    LAUNCHES[a.kind] += 1
    return out


def mxu_smem_bytes(K1, itemsize, warps=_WARPS):
    """Dynamic shared memory of one ``csrc/ionogram_mxu.cu`` block: the
    [128, K1P + 4] table (three TF32 parts in f32, one plane in f64,
    K1P = K1 rounded up to 8) and 6 × 32 values of scratch per warp."""
    K1P = -(-K1 // 8) * 8
    parts = 3 if itemsize == 4 else 1
    return itemsize * (parts * 8 * _K2 * (K1P + 4) + warps * 6 * 32)


def launch_mxu(a):
    """Launch ``csrc/ionogram_mxu.cu`` for prepared mxu args; returns vh
    [B, F].

    Checks device, dtype, contiguity and the shared memory of one block,
    launches on the current stream, and raises on any CUDA error the launch
    reports.
    """
    from . import cuda_ext

    tab = a.tab
    dtype, dev = tab.dtype, tab.device
    if not KINDS[a.kind].one_hot:
        raise ValueError(f"launch_mxu needs mxu args, got {a.kind!r}")
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"unsupported dtype {dtype}")
    if a.inv_dalt is None:
        raise ValueError("the mxu kernel needs a uniform grid")
    B, R, K1 = tab.shape
    N = a.n_alt
    F, P = a.freq_hz.shape[0], a.mult.shape[0]
    if R != 8 * _K2 or K1 != -(-N // _K2) or N < 2 or F == 0 or B == 0:
        raise ValueError(f"bad mxu table {tuple(tab.shape)} for N={N}, "
                         f"B={B}, F={F}")
    for t in (tab, a.freq_hz, a.mult, a.omm, a.dmult, a.alt_min, a.span,
              a.slope, a.emax):
        if t.dtype != dtype or t.device != dev or not t.is_contiguous():
            raise ValueError("kernel operands must share dtype and device "
                             "and be contiguous")
    smem = mxu_smem_bytes(K1, tab.element_size())
    if smem > cuda_ext.MAX_SMEM_BYTES:
        raise ValueError(f"mxu table of {smem} bytes exceeds the "
                         f"{cuda_ext.MAX_SMEM_BYTES}-byte shared memory of "
                         "one block (N_alt too large)")
    out = torch.empty((B, F), dtype=dtype, device=dev)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    f_group, warps = mxu_launch_shape(B, F, n_sm)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = cuda_ext.load().pyrayhf_ionogram_mxu(
            0 if dtype == torch.float32 else 1,
            1 if a.mode_mult > 0 else -1, tab.data_ptr(), B, N, K1,
            a.mult.data_ptr(), a.omm.data_ptr(), a.dmult.data_ptr(), P,
            a.freq_hz.data_ptr(), F, f_group, warps, a.span.data_ptr(),
            a.slope.data_ptr(), a.emax.data_ptr(), a.valid.data_ptr(),
            a.alt_min.data_ptr(), float(a.inv_dalt), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"mxu ionogram kernel launch failed: "
                           f"{cuda_ext.error_string(err)} ({err})")
    LAUNCHES[a.kind] += 1
    return out


class Kind(NamedTuple):
    """What this module needs to know of one ionogram kernel: the record
    every function here reads in place of the kernel's name."""
    channels: int       # rows of its segment table (9: cummax(den) as 8)
    padded: bool        # table rows padded to 16 bytes (its bulk copies)
    solve: bool         # reflection solve in the kernel (the C entry's flag)
    uniform: bool       # needs a uniform grid: the arithmetic index (ditto)
    one_hot: bool       # table in the mxu kernel's one-hot layout
    # prepared args -> (span, slope, emax, valid) [B, F]; None for the
    # sweep, whose plain version is ionogram_fast_xla on the inputs
    plain_solve: Optional[Callable]
    plain_resample: Optional[Callable]  # (args, span, slope, emax) -> ih
    launch: Callable                    # prepared args -> vh on the card


# channels, padded, solve, uniform, one_hot, plain solve and resample, launch
KINDS = {
    "gather_osolve": Kind(9, True, True, True, False, _osolve_plain,
                          _resample_plain, launch_kernel),
    "gather_xsolve": Kind(8, True, True, True, False, _xsolve_plain,
                          _resample_plain, launch_kernel),
    "gather": Kind(8, True, False, True, False, _host_solve,
                   _resample_plain, launch_kernel),
    "sweep": Kind(8, False, False, False, False, None, None, launch_kernel),
    "mxu": Kind(8, False, False, True, True, _host_solve,
                _resample_mxu_plain, launch_mxu),
}


def _keepable(t):
    """Whether tensor ``t`` has a version counter of its own: not an
    inference tensor, nor one a ``torch.func`` transform wraps (those read
    version 0 whatever is written)."""
    return not (t.is_inference()
                or torch._C._functorch.is_functorch_wrapped_tensor(t))


def _stamp(t):
    """What a plan made from tensor ``t`` needs unchanged."""
    return t._version, t.data_ptr(), t.shape, t.stride()


class PlanStore:
    """Launch plans kept per pair of grid tensors (``alt``, ``freq``) and a
    key, at most ``size`` of them, the least recently used dropped first.

    A plan is handed back only while both tensors are the very objects it
    was kept for, each with the version counter, data pointer, shape and
    strides it had then. The tensors are held by weak reference: an
    ``id`` reused after garbage collection never matches, and a tensor
    that is collected takes its plans with it. Any in-place write made
    through PyTorch, to the tensor or to a view of it, bumps the version
    counter, so the next lookup misses. A tensor without a version counter
    of its own (an inference tensor, or one a ``torch.func`` transform
    wraps) is never kept. As with autograd's saved tensors, a write that
    does not go through PyTorch (DLPack, a raw pointer, a numpy array
    sharing a CPU tensor's memory) is not seen. Safe to share between
    threads.
    """

    def __init__(self, size=16):
        self.size = size
        self._plans = collections.OrderedDict()
        self._lock = threading.Lock()
        # (key, weak reference) of collected tensors: a weak reference's
        # callback runs wherever the collector does, so it only queues
        self._dead = []

    def __len__(self):
        with self._lock:
            self._purge()
            return len(self._plans)

    def _purge(self):
        while self._dead:
            at, ref = self._dead.pop()
            entry = self._plans.get(at)
            if entry is not None and any(r is ref for r in entry[0]):
                del self._plans[at]

    def get(self, alt, freq, key):
        """The plan kept for (``alt``, ``freq``, ``key``), or None."""
        at = (id(alt), id(freq), key)
        with self._lock:
            self._purge()
            entry = self._plans.get(at)
            if entry is None:
                return None
            (ref_a, ref_f), stamps, plan = entry
            if (ref_a() is not alt or ref_f() is not freq
                    or stamps != (_stamp(alt), _stamp(freq))):
                return None
            self._plans.move_to_end(at)
            return plan

    def put(self, alt, freq, key, plan):
        """Keep ``plan`` for (``alt``, ``freq``, ``key``) where both tensors
        can be kept (:func:`_keepable`); returns whether it was kept."""
        if not (_keepable(alt) and _keepable(freq)):
            return False
        at = (id(alt), id(freq), key)
        dead = self._dead

        def forget(ref):
            dead.append((at, ref))

        entry = ((weakref.ref(alt, forget), weakref.ref(freq, forget)),
                 (_stamp(alt), _stamp(freq)), plan)
        with self._lock:
            self._purge()
            self._plans[at] = entry
            self._plans.move_to_end(at)
            while len(self._plans) > self.size:
                self._plans.popitem(last=False)
        return True


# the launch plans of route on CUDA grids
_PLAN_STORE = PlanStore()


def route(engine, freq, den, alt, mode_mult, n_points,
          x_in_kernel_solve=True, interpret=False):
    """The launch config of a kernel engine on converted tensors (``freq``,
    ``den`` and ``alt`` as :func:`profile_tensors` gives them), or None
    where ``engine="auto"`` takes the parity path.

    The package's one read of the grid (:func:`uniform_inv_dalt`; on the
    card a host sync) is made here, at most once a call. ``"auto"``: the
    parity path on CPU tensors and for per-profile [B, N] grids, the
    gather for a uniform shared grid on the card, the sweep for any other
    shared grid. ``"pallas_gather"`` (the in-kernel solves; with
    ``x_in_kernel_solve=False`` X mode solves on the host) and
    ``"pallas_mxu"`` need a uniform grid and raise without one;
    ``"pallas"`` is the sweep and reads nothing. Returns the ``cfg`` of
    :func:`run_engine`: dict(engine, kind, mode_mult, n_points, inv_dalt,
    interpret, grid), ``grid`` the :class:`GridValues` of ``freq`` and
    ``alt`` or None.

    On CUDA tensors the config is a launch plan, kept in a
    :class:`PlanStore` per (``alt``, ``freq``, engine, mode, ``n_points``,
    ``x_in_kernel_solve``, ``interpret``, dtype, device) with its
    :class:`GridValues`: a repeat call on the same unchanged tensors reads
    nothing from the card and launches nothing here (``PLANS["hit"]``).
    CPU grids are read on every call (a view, no sync) and keep no plan.
    """
    if engine == "auto" and (den.device.type != "cuda" or alt.ndim != 1):
        return None
    planned = den.device.type == "cuda"
    if planned:
        key = (engine, mode_mult, n_points, x_in_kernel_solve,
               bool(interpret), den.dtype, den.device)
        cfg = _PLAN_STORE.get(alt, freq, key)
        if cfg is not None:
            PLANS["hit"] += 1
            return cfg
        PLANS["miss"] += 1
    inv_dalt = None if engine == "pallas" else uniform_inv_dalt(alt)
    if engine == "auto":
        engine = "pallas_gather" if inv_dalt is not None else "pallas"
    elif inv_dalt is None and engine != "pallas":
        raise ValueError(f"ionogram_{engine} requires a uniformly spaced "
                         "altitude grid (use ionogram_pallas)")
    kind = {"pallas": "sweep", "pallas_mxu": "mxu"}.get(engine)
    if kind is None:
        kind = ("gather_osolve" if mode_mult > 0 else
                "gather_xsolve" if x_in_kernel_solve else "gather")
    cfg = dict(engine=engine, kind=kind, mode_mult=mode_mult,
               n_points=n_points, inv_dalt=inv_dalt,
               interpret=bool(interpret), grid=None)
    if planned and _PLAN_STORE.put(alt, freq, key, cfg):
        # made outside autograd, inference mode and any torch.func
        # transform: a plan outlives the call
        with (torch.no_grad(), torch.inference_mode(False),
              torch._C._DisableFuncTorch()):
            cfg["grid"] = grid_values(freq, alt, n_points, den)
    return cfg


# --------------------------------------------------------------------------
# Public wrappers and the autograd rule
# --------------------------------------------------------------------------

def _run(cfg, freq_mhz, den, bmag, bpsi, alt):
    """Kernel on CUDA tensors, plain version on CPU tensors, else raise.
    The prep and the launch are ``pyrayhf.prep`` and ``pyrayhf.launch``
    spans (:func:`profiling.span`)."""
    dev = den.device.type
    if dev not in ("cuda", "cpu"):
        raise ValueError(f"no ionogram kernel for device {den.device}")
    if dev == "cuda" and cfg["interpret"]:
        raise ValueError("interpret=True has no meaning for a CUDA kernel; "
                         "pass CPU tensors to run the plain version")
    kind, mm, P = cfg["kind"], cfg["mode_mult"], cfg["n_points"]
    k = KINDS[kind]
    if dev == "cpu" and k.plain_solve is None:
        return ionogram_fast_xla(freq_mhz, den, bmag, bpsi, alt,
                                 mode_mult=mm, n_points=P)
    with span("pyrayhf.prep"):
        a = prepare_kernel_args(kind, freq_mhz, den, bmag, bpsi, alt, mm, P,
                                cfg["inv_dalt"], cfg["grid"])
    if dev == "cpu":
        return plain_ionogram(a)
    with span("pyrayhf.launch"):
        return k.launch(a)


def _sweep_of(cfg, xs, at):
    """:func:`ionogram_fast_xla` under ``cfg`` as a function of the inputs
    at positions ``at`` of ``xs`` (freq, den, bmag, bpsi, alt), the others
    held fixed."""
    def f(*w):
        args = list(xs)
        for i, x in zip(at, w):
            args[i] = x
        return _sweep(*args, cfg["mode_mult"], cfg["n_points"])
    return f


def _jvp_nesting():
    """How many ``torch.func`` forward transforms (jvp, jacfwd) are open:
    0 inside a Function's jvp rule means ``torch.autograd.forward_ad``."""
    from torch._functorch import eager_transforms
    return eager_transforms.JVP_NESTING


class _PallasAD(torch.autograd.Function):
    """Kernel forward; derivatives through :func:`ionogram_fast_xla`.

    Counterpart of the JAX ``_pallas_ad`` custom JVP: the sweep evaluates
    the same discretisation, so its derivatives are the kernel's to their
    forward agreement. Every mode is covered: ``backward`` is the sweep's
    ``torch.func.vjp`` (so ``torch.func.grad``/``jacrev``/``hessian`` and
    double backward compose), ``jvp`` its ``torch.func.jvp`` beside the
    kernel's primal (``torch.autograd.forward_ad``, ``torch.func.jvp``,
    ``jacfwd``), and ``vmap`` a hand-written batching rule (the forward
    hands raw pointers to the CUDA library, so no rule can be generated).
    """

    @staticmethod
    def forward(cfg, freq_mhz, den, bmag, bpsi, alt):
        return _run(cfg, freq_mhz, den, bmag, bpsi, alt)

    @staticmethod
    def setup_context(ctx, inputs, output):
        cfg, *xs = inputs
        ctx.cfg = cfg
        ctx.save_for_backward(*xs)
        ctx.save_for_forward(*xs)

    @staticmethod
    def backward(ctx, g):
        needs = ctx.needs_input_grad[1:]
        at = [i for i, n in enumerate(needs) if n]
        xs = ctx.saved_tensors
        if not at:
            return (None,) * 6
        _, vjp = torch.func.vjp(_sweep_of(ctx.cfg, xs, at),
                                *[xs[i] for i in at])
        got = dict(zip(at, vjp(g)))
        return (None, *[got.get(i) for i in range(5)])

    @staticmethod
    def jvp(ctx, _cfg_t, *tangents):
        # a None tangent is a zero one, as JAX instantiates SymbolicZero
        xs = ctx.saved_tensors
        ts = tuple(torch.zeros_like(x) if t is None else t
                   for x, t in zip(xs, tangents))
        f = _sweep_of(ctx.cfg, xs, range(5))
        # one torch.func forward level at most: run_engine sends two or more to
        # _KernelGap, as PyTorch does not differentiate a Function's jvp
        if _jvp_nesting() == 1:
            return torch.func.jvp(f, xs, ts)[1]
        # torch.autograd.forward_ad: its one dual level is open, so
        # torch.func.jvp cannot open another; make duals on it instead
        fwad = torch.autograd.forward_ad
        with fwad._set_fwd_grad_enabled(True):
            out = f(*[fwad.make_dual(x.detach(), t) for x, t in zip(xs, ts)])
            return fwad.unpack_dual(out).tangent

    @staticmethod
    def vmap(info, in_dims, cfg, *xs):
        """Batching rule. With only den/bmag/bpsi batched (the common case:
        ``vmap`` over profile stacks, ``jacfwd``'s tangents never reach the
        forward), the vmapped dim is folded into the profile axis and ONE
        ``apply`` (one kernel launch) computes [V·B, F]. A batched ``freq``
        or ``alt`` runs one ``apply`` per slice and stacks them: as correct
        as JAX's batching of the custom JVP, and V launches slower."""
        return _fold_profiles(_PallasAD.apply, info, in_dims[1:], cfg, (),
                              xs)


class _KernelGap(torch.autograd.Function):
    """The kernel's value less the sweep's, a constant to every transform.

    Under two or more forward transforms (``jacfwd`` of ``jacfwd``, ``jvp``
    of ``jvp``), :func:`run_engine` returns ``S + (K − S)``: ``S`` the sweep
    run through the transforms, so every derivative order is the sweep's,
    as the JAX custom JVP gives, and ``K − S`` this Function, computed on
    the innermost primals with no derivative. Where K and S lie within a
    factor of 2 of each other (two virtual heights of one discretisation,
    ~1e-9 apart), K − S is exact (Sterbenz) and S + (K − S) is K bit for
    bit: the primal stays the kernel's. Where S is NaN the gap is K itself.
    """

    @staticmethod
    def forward(cfg, s, freq_mhz, den, bmag, bpsi, alt):
        k = _run(cfg, freq_mhz, den, bmag, bpsi, alt)
        return torch.where(torch.isnan(s), k, k - s)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output)

    # a torch.func level calls these even for a non-differentiable output
    @staticmethod
    def backward(ctx, g):
        return (None,) * 7

    @staticmethod
    def jvp(ctx, *tangents):
        return None

    @staticmethod
    def vmap(info, in_dims, cfg, s, *xs):
        """The same fold as :meth:`_PallasAD.vmap`: one launch for a stack
        of profiles, ``s`` folded with them."""
        return _fold_profiles(_KernelGap.apply, info, in_dims[2:], cfg,
                              ((s, in_dims[1]),), xs)


def _fold_profiles(apply, info, dims, cfg, lead, xs):
    """A batching rule for ``apply(cfg, *lead, freq, den, bmag, bpsi,
    alt)``: ``dims`` the batched dims of the five inputs, ``lead`` (tensor,
    dim) pairs batched like the output [B, F]. With freq and alt unbatched
    the mapped dim is folded into the profile axis (one call), else one call
    per slice."""
    V = info.batch_size

    def at0(x, d):
        return x.movedim(d, 0) if d is not None else x.expand(V, *x.shape)

    if dims[0] is None and dims[4] is None:
        prof = [at0(x, d) for x, d in zip(xs[1:4], dims[1:4])]
        B = prof[0].shape[1]
        flat = [p.reshape(V * B, *p.shape[2:]) for p in prof]
        head = [at0(t, d).reshape(V * B, -1) for t, d in lead]
        out = apply(cfg, *head, xs[0], *flat, xs[4])
        return out.reshape(V, B, -1), 0

    def pick(x, d, v):
        return x if d is None else x.select(d, v)
    outs = [apply(cfg, *[pick(t, d, v) for t, d in lead],
                  *[pick(x, d, v) for x, d in zip(xs, dims)])
            for v in range(V)]
    return torch.stack(outs), 0


def _no_derivative(xs):
    """Whether no derivative of a call on tensors ``xs`` can be asked for:
    no ``torch.func`` transform is open, no input carries a
    ``torch.autograd.forward_ad`` tangent, and autograd records none of
    them (grad mode off, or none requires grad)."""
    if torch._C._functorch.maybe_current_level() is not None:
        return False
    if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
        return False
    return fwAD._current_level < 0 or all(
        fwAD.unpack_dual(x).tangent is None for x in xs)


def run_engine(cfg, freq_mhz, den, bmag, bpsi, alt):
    """A kernel engine's value on the converted tensors :func:`route` made
    ``cfg`` for: the kernel alone where no derivative can be asked for
    (:func:`_no_derivative`, counted in ``PLANS["direct"]``), else
    :class:`_PallasAD`, or under two or more ``torch.func`` forward
    transforms the sweep plus :class:`_KernelGap`."""
    if _no_derivative((freq_mhz, den, bmag, bpsi, alt)):
        PLANS["direct"] += 1
        return _run(cfg, freq_mhz, den, bmag, bpsi, alt)
    if _jvp_nesting() < 2:
        return _PallasAD.apply(cfg, freq_mhz, den, bmag, bpsi, alt)
    s = _sweep(freq_mhz, den, bmag, bpsi, alt, cfg["mode_mult"],
               cfg["n_points"])
    gap = _KernelGap.apply(cfg, s, freq_mhz, den, bmag, bpsi, alt)
    return torch.where(torch.isnan(s), gap, s + gap)


def _entry(engine, xs, mode_mult, n_points, config, interpret, device,
           x_in_kernel_solve=True):
    """A wrapper's call: ``xs`` (freq, den, bmag, bpsi, alt) converted once,
    routed (:func:`route`) and run (:func:`run_engine`)."""
    if mode_mult is None:
        mode_mult = 1.0 if resolve(config, "mode", None, "O") == "O" else -1.0
    xs = profile_tensors(*xs, device=device)
    cfg = route(engine, xs[0], xs[1], xs[4], mode_mult,
                resolve(config, "n_points", n_points, 200), x_in_kernel_solve,
                interpret)
    return run_engine(cfg, *xs)


def ionogram_pallas_gather(freq_mhz, den, bmag, bpsi, alt, mode_mult=None,
                           n_points=None, p_chunk=None, interpret=False,
                           f_tile=None, b_tile=4, config=None,
                           x_in_kernel_solve=True, device=None):
    """Gather-kernel ionogram synthesis: [B, N_alt] profiles → [B, F] vh.

    The main-path engine (``engine="pallas_gather"``, and ``"auto"`` on
    CUDA tensors with a uniform shared grid). With ``x_in_kernel_solve``
    (default) the reflection-height solve runs inside the kernel for both
    modes (kernels ``gather_osolve``/``gather_xsolve``); with False the X
    mode solves on the host first (:func:`prepare_profile_tables`, kernel
    ``gather``), as the JAX option does. O mode always solves in-kernel.
    Requires a uniformly spaced shared altitude grid (raises otherwise).
    ``p_chunk``, ``f_tile`` and ``b_tile`` are the TPU kernel's tiling
    knobs, accepted for signature compatibility and unused.
    Differentiable through :class:`_PallasAD`. Host arrays go to the CUDA
    card unless ``device`` says otherwise (``device="cpu"``).
    """
    return _entry("pallas_gather", (freq_mhz, den, bmag, bpsi, alt),
                  mode_mult, n_points, config, interpret, device,
                  x_in_kernel_solve)


def ionogram_pallas(freq_mhz, den, bmag, bpsi, alt, mode_mult=None,
                    n_points=None, p_chunk=None, interpret=False, f_tile=32,
                    b_tile=4, config=None, device=None):
    """Sweep-kernel ionogram synthesis: [B, N_alt] profiles → [B, F] vh.

    Same discretisation as :func:`pyrayhf_tpu_torch.forward
    .vertical_forward_operator_batch`, for any shared altitude grid
    (uniform or not): the kernel finds each point's segment by an
    upper-bound search (a cursor per lane), the plain version (CPU
    tensors) is :func:`ionogram_fast_xla`.
    ``config`` supplies mode (as ±1 mode_mult) and n_points when not
    explicit. ``p_chunk``, ``f_tile`` and ``b_tile`` are accepted for
    signature compatibility and unused. Differentiable through
    :class:`_PallasAD`. Host arrays go to the CUDA card unless ``device``
    says otherwise (``device="cpu"``).
    """
    return _entry("pallas", (freq_mhz, den, bmag, bpsi, alt), mode_mult,
                  n_points, config, interpret, device)


def ionogram_pallas_mxu(freq_mhz, den, bmag, bpsi, alt, mode_mult=None,
                        n_points=None, p_chunk=None, interpret=False,
                        f_tile=32, b_tile=4, config=None, device=None):
    """Tensor-core one-hot ionogram synthesis: [B, N_alt] → [B, F] vh.

    ``engine="pallas_mxu"``. Same discretisation and result as the host-
    solve gather (:func:`ionogram_pallas_gather` with
    ``x_in_kernel_solve=False``), but the resample of each grid point's
    segment row runs as factorised one-hot matrix products on the tensor
    cores (``csrc/ionogram_mxu.cu``, kernel ``mxu``), the counterpart of the
    JAX package's MXU kernel; on CPU tensors its plain version does the
    same products with ``torch.matmul``. Requires a uniformly spaced shared
    altitude grid (raises otherwise). ``config`` supplies mode (as ±1
    mode_mult) and n_points when not explicit; ``p_chunk``, ``f_tile`` and
    ``b_tile`` are the TPU kernel's tiling knobs, accepted and unused.
    Differentiable through :class:`_PallasAD`. Host arrays go to the CUDA
    card unless ``device`` says otherwise (``device="cpu"``).
    """
    return _entry("pallas_mxu", (freq_mhz, den, bmag, bpsi, alt),
                  mode_mult, n_points, config, interpret, device)
