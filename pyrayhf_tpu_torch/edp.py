"""Differentiable parametric electron-density-profile (EDP) model, in PyTorch.

Port of ``pyrayhf_tpu.edp`` (the PyIRI-equivalent builders behind
``model_VH`` and the retrievals; see the JAX module and DEVNOTES.md for how
they were reconstructed and what is exact):

* topside (h ≥ hmF2): NeQuick-style semi-Epstein with height-dependent
  scale H = B_top·(1 + 12.5Δh/(100·B_top + 0.125Δh));
* E-layer bottomside: Epstein with B_E_bot; Nm = 1.24e10·fo²;
* the E-valley/F2 transition, the F1 ledge (1-level builder) and the
  Chebyshev F1 bump (continuous builder) with the JAX module's constants.

The layers are written as Nm·sech²(x/2) (with x clipped to ±80), the B0/B1
bottomside as 2e⁻ˣ/(1+e⁻²ˣ) and the logistic as a tanh: every intermediate
stays bounded, so the forms agree with the naive ones in f64 and keep
``retrieve_gradient_batch(dtype=float32)`` finite, where cosh² and the exp
logistic overflow (and their tangents turn NaN) on any f32 device.

Every function takes tensors or numbers and broadcasts like the JAX
module; a batch of parameters is a leading dimension ([B, 1] parameters
against an [N] grid give [B, N] profiles). Host data (numbers, numpy
arrays) goes to the CUDA card unless ``device`` says otherwise
(``device="cpu"``); the dtype is that of the tensor arguments, else f64.
"""

import math

import torch

from ._util import as_tensors, clip

__all__ = ["epstein_layer", "f2_topside", "f2_bottom_thickness",
           "f2_bottom_b0b1", "valley_transition",
           "derive_dependent_F1_parameters",
           "reconstruct_density_1level", "reconstruct_density_continuous",
           "NM_PER_MHZ2"]

# PyIRI's peak-density <-> critical-frequency constant: Nm = 1.24e10 * fo^2.
NM_PER_MHZ2 = 1.24e10

# derive_dependent_F1_parameters calibration (exact on the reference golden
# point: P=0.91422852, NmF2=1.17848165e12, hmF2=365.13828931,
# B_bot=41.26005561, hmE=110 -> NmF1=7.80902301e11, hmF1=219.26637887,
# B_F1_bot=54.63318944):
_NMF1_COEF = 0.7248015487541687       # NmF1 = c * P * NmF2
_HMF1_COEF = (219.26637887 - 110.0) / (365.13828931 - 110.0) / 0.91422852

# F1-ledge thickness fractions for the 1-level builder (solved from the
# same golden's EDP values at 200 and 300 km).
_LEDGE_LOW_FRAC = 6.106902159665104 / (219.26637887 - 110.0)
_LEDGE_HIGH_FRAC = 3.5103602982247035 / (365.13828931 - 219.26637887)

# Continuous-builder F1 bump (multiplies the F2 bottomside): Chebyshev-12
# fit of the residual shape of the shipped Day profile, amplitude ∝ P,
# support v ∈ [0.10, 1] with v = (h−hmE)/(hmF1−hmE).
_CBUMP_V_LO = 0.10
_CBUMP_CHEB = (
    0.1538343022111969, -0.0665188719251236, -0.14116250906212763,
    0.07028525127306248, -0.017306140222515882, -0.0014365697859544666,
    0.003876284973544997, -0.0021934817204394682, 0.0007320868464723587,
    -0.0001085695963291886, -2.5000567108947152e-05, 1.447593980083738e-05,
    1.014127279844814e-05)


def epstein_layer(Nm, hm, B, h, device=None):
    """Symmetric Epstein layer 4·Nm·u/(1+u)² = Nm·sech²(x/2), u = e^x."""
    Nm, hm, B, h = as_tensors(Nm, hm, B, h, device=device)
    x = clip((h - hm) / B, -80.0, 80.0)
    c = torch.cosh(0.5 * x)               # ≤ cosh(40) ≈ 1.2e17
    return Nm / (c * c)


def f2_topside(NmF2, hmF2, B_top, h, device=None):
    """NeQuick-style F2 topside with growing scale height (exact PyIRI)."""
    NmF2, hmF2, B_top, h = as_tensors(NmF2, hmF2, B_top, h, device=device)
    dh = h - hmF2
    g, r = 0.125, 100.0
    H = B_top * (1.0 + r * g * dh / (r * B_top + g * dh))
    x = clip(dh / H, -80.0, 80.0)
    c = torch.cosh(0.5 * x)               # sech² form: see epstein_layer
    return NmF2 / (c * c)


def f2_bottom_thickness(NmF2, hmF2, B_bot, h, device=None):
    """F2 bottomside as a single-thickness Epstein (B_bot formalism)."""
    return epstein_layer(NmF2, hmF2, B_bot, h, device=device)


def f2_bottom_b0b1(NmF2, hmF2, B0, B1, h, device=None):
    """IRI B0/B1 bottomside: Nm·exp(−x^B1)/cosh(x), x = (hmF2−h)/B0.

    Exact match to the PyIRI continuous-builder F2 shape.
    """
    NmF2, hmF2, B0, B1, h = as_tensors(NmF2, hmF2, B0, B1, h, device=device)
    d = hmF2 - h
    x = torch.maximum(d, torch.zeros_like(d)) / B0
    x_safe = torch.maximum(x, torch.full_like(x, 1e-30))
    # 1/cosh(x) = 2e^(-x)/(1+e^(-2x)): every factor ≤ 1 for x ≥ 0
    sech = 2.0 * torch.exp(-x) / (1.0 + torch.exp(-2.0 * x))
    return NmF2 * torch.exp(-x_safe ** B1) * sech


def _sig(t):
    """The logistic as 0.5·(1 + tanh(t/2)) (bounded intermediates)."""
    if isinstance(t, torch.Tensor):
        return 0.5 * (1.0 + torch.tanh(0.5 * t))
    return 0.5 * (1.0 + math.tanh(0.5 * t))


def valley_transition(h, hmE, hmF2, device=None):
    """E-valley → F2 transition T2: 0 at/below hmE, → 1 at hmF2.

    Rescaled logistic with scale = centre-offset = (hmF2−hmE)/10.
    """
    h, hmE, hmF2 = as_tensors(h, hmE, hmF2, device=device)
    delta = (hmF2 - hmE) / 10.0
    s = _sig((h - hmE - delta) / delta)
    s0 = _sig(-1.0)     # a Python number: never promotes f32
    s1 = _sig((hmF2 - hmE - delta) / delta)
    t2 = (s - s0) / (s1 - s0)
    return torch.where(h <= hmE, 0.0, clip(t2, 0.0, 1.0))


def derive_dependent_F1_parameters(P, NmF2, hmF2, B_F2_bot, hmE,
                                   device=None):
    """F1 parameters from F2/E (ref model_VH → PyIRI, library.py:556-559).

    Calibrated reconstruction (exact on the reference golden point):
      NmF1 = c1·P·NmF2, foF1 = sqrt(NmF1/1.24e10),
      hmF1 = hmE + c2·P·(hmF2−hmE), B_F1_bot = (hmF1−hmE)/2.
    ``B_F2_bot`` is accepted for signature parity (unused here).
    """
    del B_F2_bot
    P, NmF2, hmF2, hmE = as_tensors(P, NmF2, hmF2, hmE, device=device)
    NmF1 = _NMF1_COEF * P * NmF2
    foF1 = torch.sqrt(NmF1 / NM_PER_MHZ2)
    hmF1 = hmE + _HMF1_COEF * P * (hmF2 - hmE)
    B_F1_bot = (hmF1 - hmE) / 2.0
    return NmF1, foF1, hmF1, B_F1_bot


def _e_layer(NmE, hmE, B_E_bot, B_E_top, h):
    BE = torch.where(h <= hmE, B_E_bot, B_E_top)
    return epstein_layer(NmE, hmE, BE, h)


def _asym_ledge(h, hmF1, B_low, B_high):
    """Asymmetric unit bump peaked at hmF1 (the 1-level F1 ledge shape)."""
    B = torch.where(h <= hmF1, B_low, B_high)
    x = clip((h - hmF1) / B, -80.0, 80.0)
    c = torch.cosh(0.5 * x)               # sech² form: see epstein_layer
    return 1.0 / (c * c)


def reconstruct_density_1level(F2, F1, E, alt, device=None):
    """EDP from layer parameters, B_bot formalism (ref PyIRI
    ``edp_update.reconstruct_density_from_parameters_1level``).

    ``F2``: Nm, hm, B_bot, B_top; ``F1``: Nm, hm (from
    :func:`derive_dependent_F1_parameters`); ``E``: Nm, hm, B_bot, B_top.
    NeQuick topside above hmF2; below, E-Epstein + T2·F2-bottom-Epstein +
    an F1 ledge anchored so EDP(hmF1) == NmF1.
    """
    (h, NmF2, hmF2, B_bot, B_top, NmF1, hmF1, NmE, hmE, BEb,
     BEt) = as_tensors(alt, F2["Nm"], F2["hm"], F2["B_bot"], F2["B_top"],
                       F1["Nm"], F1["hm"], E["Nm"], E["hm"], E["B_bot"],
                       E["B_top"], device=device)
    top = f2_topside(NmF2, hmF2, B_top, h)
    f2b = f2_bottom_thickness(NmF2, hmF2, B_bot, h)
    t2 = valley_transition(h, hmE, hmF2)
    e_l = _e_layer(NmE, hmE, BEb, BEt, h)

    # ledge amplitude anchors the profile through (hmF1, NmF1)
    f2b_at_f1 = f2_bottom_thickness(NmF2, hmF2, B_bot, hmF1)
    t2_at_f1 = valley_transition(hmF1, hmE, hmF2)
    e_at_f1 = _e_layer(NmE, hmE, BEb, BEt, hmF1)
    amp = NmF1 - e_at_f1 - t2_at_f1 * f2b_at_f1
    amp = torch.maximum(amp, torch.zeros_like(amp))
    B_low = _LEDGE_LOW_FRAC * (hmF1 - hmE)
    gap = hmF2 - hmF1
    B_high = _LEDGE_HIGH_FRAC * torch.maximum(gap, torch.ones_like(gap))
    ledge = amp * _asym_ledge(h, hmF1, B_low, B_high)
    # the ledge exists only between hmE and hmF2
    ledge = torch.where((h > hmE) & (h < hmF2), ledge, 0.0)

    bottom = e_l + t2 * f2b + ledge
    return torch.where(h >= hmF2, top, bottom)


def reconstruct_density_continuous(F2, F1, E, alt, device=None):
    """EDP from layer parameters, B0/B1 formalism (ref PyIRI
    ``sh_library.EDP_builder_continuous``; used by model_VH with
    bottom_type='B0_B1', ref library.py:571-583).

    ``F2`` must carry B0, B1 (and B_top for the topside). The F1 ledge is a
    P-weighted bump multiplying the F2 bottomside (zero when P → 0).
    """
    (h, NmF2, hmF2, B0, B1, B_top, P, hmF1, NmE, hmE, BEb,
     BEt) = as_tensors(alt, F2["Nm"], F2["hm"], F2["B0"], F2["B1"],
                       F2["B_top"], F1.get("P", 0.0), F1["hm"], E["Nm"],
                       E["hm"], E["B_bot"], E["B_top"], device=device)
    top = f2_topside(NmF2, hmF2, B_top, h)
    f2b = f2_bottom_b0b1(NmF2, hmF2, B0, B1, h)
    t2 = valley_transition(h, hmE, hmF2)
    e_l = _e_layer(NmE, hmE, BEb, BEt, h)

    d = hmF1 - hmE
    span = torch.maximum(d, torch.ones_like(d))
    v = (h - hmE) / span
    # Clenshaw evaluation of the fitted Chebyshev shape on t ∈ [-1, 1]
    t = 2.0 * (clip(v, _CBUMP_V_LO, 1.0) - _CBUMP_V_LO) \
        / (1.0 - _CBUMP_V_LO) - 1.0
    b1 = torch.zeros_like(t)
    b2 = torch.zeros_like(t)
    for ck in _CBUMP_CHEB[:0:-1]:
        b1, b2 = 2.0 * t * b1 - b2 + ck, b1
    shape = t * b1 - b2 + _CBUMP_CHEB[0]   # fitted need/P at the Day point
    bump = P * shape
    bump = torch.maximum(bump, torch.zeros_like(bump))
    bump = torch.where((v > _CBUMP_V_LO) & (h < hmF1), bump, 0.0)

    bottom = e_l + (t2 + bump) * f2b
    return torch.where(h >= hmF2, top, bottom)
