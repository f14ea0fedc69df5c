"""Entry: ``pyrayhf_tpu_torch.forward.vertical_forward_operator_batch``.

The window drives the batch operator as a user calls it, with the engine
the configuration names (``auto``), on profiles made on the card from the
seed (``hfbench.inputs``), the frequencies and the shared altitude grid
of the configuration. Its output stays on the card.

Besides the call this file gives the harness the pool of inputs, the
comparison with the plain reference (``hfbench.reference``) that decides
``correct``, and the operator's work for the roofline.
"""

import dataclasses

import torch

from .. import inputs
from ..reference import vertical_forward as ref

# the program's own CUDA kernels, by the names the profiler gives them
# (csrc/ionogram.cu, csrc/ionogram_mxu.cu); every other device operation
# of a call is host prep
PROGRAM_KERNELS = ("ionogram_kernel", "gather_kernel", "ionogram_mxu_kernel")

# Operations per grid point of a reflecting pair, counted from the
# reference's arithmetic (each add, multiply, division, square root, sine,
# cosine and floor as one; constants per pair folded): the grid point and
# its Δh 3, the uniform-grid index and fraction 3, three channels
# resampled 6, X and Y 2, ψ to sin/cos 3, YT, YL and their squares 4,
# 1 − X and its square 2, β 5, the O-mode quotient 6 (X mode 3), μ 1,
# ∂β/∂X and ∂D/∂X 3, ∂α/∂Y, ∂β/∂Y, ∂D/∂Y 10, ∂μ/∂Y 6, ∂μ/∂X 7, μ′ 4,
# and μ′·Δh into the sum 2.
OPS_POINT = {"O": 67, "X": 64}
# the reflection solve, per altitude node and (profile, frequency) pair:
# O mode a comparison of the running peak density against f²/cp²; X mode
# X + Y (two products, a sum), the running maximum and the comparison
OPS_NODE = {"O": 1, "X": 5}


@dataclasses.dataclass
class Pool:
    """The inputs of a run: ``calls[i]`` is pool entry i's (den, bmag,
    bpsi) [B, N] as the program gets them, ``ref_calls[i]`` the same in
    float64 for the reference; ``freq`` [F] MHz and ``alt`` [N] km as the
    program gets them, ``freq64``/``alt64`` in float64."""
    freq: torch.Tensor
    alt: torch.Tensor
    calls: list
    freq64: torch.Tensor
    alt64: torch.Tensor
    ref_calls: list


def grid(cfg, device):
    """(freq [F] MHz, alt [N] km) of the configuration in float64."""
    f, a = cfg["freq_mhz"], cfg["alt_km"]
    k = torch.arange(f["count"], dtype=torch.float64, device=device)
    freq = torch.round((f["first"] + k * f["step"]) * 1e10) / 1e10
    alt = torch.linspace(a["first"], a["last"], a["count"],
                         dtype=torch.float64, device=device)
    return freq, alt


def setup(cfg, device):
    """Build (first run in a checkout) and load the program's CUDA
    library. Returns the seconds ``nvcc`` took (0 when it was built)."""
    if device.type != "cuda":
        return 0.0
    from pyrayhf_tpu_torch import cuda_ext
    _, seconds = cuda_ext.build()
    cuda_ext.load()
    return seconds


def make_pool(cfg, traffic, seed, device, dtype=None):
    """The run's inputs from ``seed``, made on ``device`` (see
    :class:`Pool`); the program's copies in ``dtype`` (default the
    configuration's)."""
    dtype = getattr(torch, dtype or cfg["dtype"])
    freq, alt = grid(cfg, device)
    den, bmag, bpsi = inputs.profiles(traffic, seed, alt, device)
    B = traffic["profiles_per_call"]
    ref_calls = [tuple(a[i * B:(i + 1) * B] for a in (den, bmag, bpsi))
                 for i in range(traffic["pool_calls"])]
    calls = [tuple(a.to(dtype) for a in c) for c in ref_calls]
    return Pool(freq.to(dtype), alt.to(dtype), calls, freq, alt, ref_calls)


def call(cfg, pool, i):
    """One call of the operator on pool entry ``i``: vh [B, F] on the
    inputs' device."""
    from pyrayhf_tpu_torch.forward import vertical_forward_operator_batch
    den, bmag, bpsi = pool.calls[i]
    return vertical_forward_operator_batch(
        pool.freq, den, bmag, bpsi, pool.alt, mode=cfg["mode"],
        n_points=cfg["n_points"], engine=cfg["engine"])


def counters():
    """The program's kernel launches and plain-version calls by kernel."""
    from pyrayhf_tpu_torch import pallas_vh
    return {"launches": dict(pallas_vh.LAUNCHES),
            "plain_calls": dict(pallas_vh.PLAIN_CALLS)}


def _mode_mult(cfg):
    return 1.0 if cfg["mode"] == "O" else -1.0


def work(cfg, pool, i, itemsize):
    """(operations, bytes) of the operator on pool entry ``i``.

    Operations: the reflecting pairs the reference finds × n_points ×
    ``OPS_POINT``, plus the reflection solve, ``OPS_NODE`` per node and
    pair. Bytes: the inputs read once and the [B, F] output written once,
    ``itemsize`` × (3·B·N + N + F + B·F).
    """
    den, bmag, bpsi = pool.ref_calls[i]
    B, N = den.shape
    F = pool.freq64.numel()
    valid = int(ref.reflecting_pairs(pool.freq64, den, bmag, bpsi,
                                     pool.alt64, _mode_mult(cfg)).sum())
    ops = (valid * cfg["n_points"] * OPS_POINT[cfg["mode"]]
           + B * F * N * OPS_NODE[cfg["mode"]])
    return ops, itemsize * (3 * B * N + N + F + B * F)


def compare(cfg, pool, outputs, rows):
    """The numbers that decide ``correct``, each as (value, limit), and
    the count of pairs escaped on one side only.

    ``outputs[i]`` is the program's last vh of pool entry i; ``rows``
    maps entry i to the rows of it to compare. The reference recomputes
    those rows from the float64 inputs. ``max_dvh_km`` is the widest gap
    |Δvh| over the compared pairs; a pair that escapes (NaN) on one side
    only counts as a gap of the other side's whole virtual height.
    """
    idx = sorted(rows)
    den, bmag, bpsi = (torch.cat([pool.ref_calls[i][k][rows[i]] for i in idx])
                       for k in range(3))
    got = torch.cat([outputs[i][rows[i]] for i in idx]).to(torch.float64)
    want = ref.vertical_forward(pool.freq64, den, bmag, bpsi, pool.alt64,
                                _mode_mult(cfg), cfg["n_points"])
    nan_w, nan_g = torch.isnan(want), torch.isnan(got)
    gap = torch.where(nan_w | nan_g,
                      torch.nan_to_num(want) + torch.nan_to_num(got),
                      (got - want).abs())
    gap = torch.where(nan_w & nan_g, 0.0, gap)
    return ({"max_dvh_km": (float(gap.max()), cfg["limits"]["max_dvh_km"])},
            int((nan_w != nan_g).sum()))
