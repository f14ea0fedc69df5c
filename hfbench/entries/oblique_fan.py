"""Entry: ``pyrayhf_tpu_torch.oblique.synthesize_oblique_ionogram_2d``.

The window drives the 2-D oblique ionogram as a user calls it: one link a
call, the frequencies and the grids as host numpy arrays, the slice
(density, |B|, ψ) as tensors on the card made from the seed
(``hfbench.slices``), the engine the configuration names (``auto``), the
collision frequency the entry's default. Its output dict stays on the
card.

Besides the call this file gives the harness the pool of inputs, the
comparison with the plain reference (``hfbench.reference.oblique_fan``)
that decides ``correct``, and the fan's work for the roofline.
"""

import dataclasses

import numpy as np
import torch

from .. import slices
from ..reference import oblique_fan as ref
from .vertical_forward import setup  # noqa: F401  (the harness's setup)

# the program's own CUDA kernel, by the name the profiler gives it
# (csrc/fan2d.cu); every other device operation of a call is fields,
# tables or homing
PROGRAM_KERNELS = ("fan2d_kernel",)


@dataclasses.dataclass
class Pool:
    """The inputs of a run: ``calls[i]`` is pool entry i's slice (den,
    bmag, bpsi) [nz, nx] as the program gets them, ``ref_calls[i]`` the
    same in float64 for the reference; the host grids ``z_km`` [nz],
    ``x_km`` [nx], ``f0s_hz`` [F], the link's ``range_km``, and
    ``ref_out``: the reference's results by entry, made once."""
    f0s_hz: np.ndarray
    z_km: np.ndarray
    x_km: np.ndarray
    range_km: float
    calls: list
    ref_calls: list
    ref_out: dict = dataclasses.field(default_factory=dict)


def _axis(a):
    return np.linspace(a["first"], a["last"], a["count"])


def n_steps(cfg):
    """The fan's RK4 steps: the path budget over the step."""
    return int(round(cfg["s_max_km"] / cfg["step_km"]))


def elevations(cfg):
    """The fan's launch elevations [E] (deg), as the entry spaces them:
    first·(1 − k/(E−1)) + last·k/(E−1), the last one exact."""
    e = cfg["elev_deg"]
    k = np.arange(e["count"] - 1) / (e["count"] - 1)
    return np.append(e["first"] * (1 - k) + e["last"] * k, e["last"])


def make_pool(cfg, traffic, seed, device, dtype=None):
    """The run's inputs from ``seed``, made on ``device`` (see
    :class:`Pool`); the program's copies in ``dtype`` (default the
    configuration's)."""
    dtype = getattr(torch, dtype or cfg["dtype"])
    z, x = _axis(cfg["z_km"]), _axis(cfg["x_km"])
    den, bmag, bpsi = slices.slices(traffic["pool_calls"],
                                    traffic["e_layer_slices"], seed, z, x,
                                    device)
    ref_calls = list(zip(den, bmag, bpsi))
    calls = [tuple(a.to(dtype) for a in c) for c in ref_calls]
    return Pool(_axis(cfg["freq_mhz"]) * 1e6, z, x,
                float(traffic["ground_range_km"]), calls, ref_calls)


def call(cfg, pool, i):
    """One link's oblique ionogram on pool entry ``i``: the entry's output
    dict ([F] homed values, the [F, E] fan) on the inputs' device."""
    from pyrayhf_tpu_torch.oblique import synthesize_oblique_ionogram_2d
    den, bmag, bpsi = pool.calls[i]
    e = cfg["elev_deg"]
    return synthesize_oblique_ionogram_2d(
        pool.f0s_hz, pool.range_km, pool.x_km, pool.z_km, den, bmag, bpsi,
        mode=cfg["mode"], geometry=cfg["geometry"], n_elev=e["count"],
        elev_min_deg=e["first"], elev_max_deg=e["last"],
        step_km=cfg["step_km"], s_max_km=cfg["s_max_km"],
        max_range_jump_km=cfg["max_range_jump_km"], engine=cfg["engine"])


def counters():
    """The program's fan-kernel launches and plain-version calls."""
    from pyrayhf_tpu_torch import pallas_ray
    return {"launches": dict(pallas_ray.LAUNCHES),
            "plain_calls": dict(pallas_ray.PLAIN_CALLS)}


def reference(cfg, pool, entries):
    """The reference's fan and homed delays of pool ``entries``, each a
    dict of [F, E] and [F] float64 tensors, computed together for those
    not made yet and kept on the pool."""
    todo = sorted(set(entries) - set(pool.ref_out))
    if todo:
        den, bmag, bpsi = (torch.stack([pool.ref_calls[i][k] for i in todo])
                           for k in range(3))
        out = ref.oblique_ionogram(
            pool.f0s_hz, elevations(cfg), pool.z_km, pool.x_km, den, bmag,
            bpsi, 1.0 if cfg["mode"] == "O" else -1.0, cfg["step_km"],
            n_steps(cfg), pool.range_km, cfg["max_range_jump_km"])
        for k, i in enumerate(todo):
            pool.ref_out[i] = {n: v[k] for n, v in out.items()}
    return {i: pool.ref_out[i] for i in entries}


def work(cfg, pool, i, itemsize):
    """(operations, bytes) of the fan of pool entry ``i``.

    Operations: the steps each ray takes in the reference ×
    ``reference.OPS_STEP`` (the reference of every pool entry is computed
    on the first call and kept). Bytes: the inputs read once and the
    outputs written once, ``itemsize`` × (3·nz·nx + nz + F + E + 5·F·E):
    the slice, ν, the frequencies, the elevations, and the fan's five
    sums.
    """
    out = reference(cfg, pool, range(len(pool.ref_calls)))[i]
    nz, nx = pool.z_km.size, pool.x_km.size
    F, E = out["steps_taken"].shape
    return (int(out["steps_taken"].sum()) * ref.OPS_STEP,
            itemsize * (3 * nz * nx + nz + F + E + 5 * F * E))


def _gap(got, want):
    """|got − want|, a value NaN on one side only counting as the other
    side's whole value, 0 where both are NaN."""
    nan_g, nan_w = torch.isnan(got), torch.isnan(want)
    gap = torch.where(nan_g | nan_w,
                      torch.nan_to_num(got).abs()
                      + torch.nan_to_num(want).abs(), (got - want).abs())
    return torch.where(nan_g & nan_w, 0.0, gap)


def compare(cfg, pool, outputs, rows):
    """The numbers that decide ``correct``, each as (value, limit), and
    the count of rays landed on one side only.

    ``outputs[i]`` is the program's last output of pool entry i; ``rows``
    maps the entries to compare to their one row (the slice). The
    reference recomputes those slices from the float64 inputs.
    ``max_drange_km``: the widest |Δ ground range| over all their rays, a
    ray landed on one side only counting as the other side's whole range.
    ``max_ddelay_us``: the widest |Δ| of the homed low- and high-ray group
    delays, a delay NaN on one side only counting as the other side's
    whole delay.
    """
    idx = sorted(rows)
    want = reference(cfg, pool, idx)
    rng_g = torch.stack([outputs[i]["fan_range_km"] for i in idx]).double()
    rng_w = torch.stack([want[i]["ground_range_km"] for i in idx])
    dl_g = torch.stack([torch.stack([outputs[i]["delay_low_sec"],
                                     outputs[i]["delay_high_sec"]])
                        for i in idx]).double()
    dl_w = torch.stack([torch.stack([want[i]["delay_low_sec"],
                                     want[i]["delay_high_sec"]])
                        for i in idx])
    lim = cfg["limits"]
    parted = int((torch.isnan(rng_g) != torch.isnan(rng_w)).sum())
    return ({"max_drange_km": (float(_gap(rng_g, rng_w).max()),
                               lim["max_drange_km"]),
             "max_ddelay_us": (float(_gap(dl_g, dl_w).max()) * 1e6,
                               lim["max_ddelay_us"])}, parted)
