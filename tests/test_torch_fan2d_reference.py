"""The 2-D oblique ionogram in float64 on CPU tensors against the
benchmark's plain reference (``hfbench/reference/oblique_fan.py``, written
from the upstream equations with the JAX package's discretisation and
nothing of the port), at a toy size: two seeded slices of 81 × 40 nodes
(one with an E layer), 4 frequencies × 24 elevations, 300 RK4 steps of
10 km, an 800 km link that each slice reaches at its lowest frequency.

``engine="xla"`` runs the gradient-ODE fan of :mod:`.gradient`,
``engine="pallas"`` the fan kernel's plain version on the packed tables.

Tolerances: rtol 1e-11 on every ray and homed value, with an atol of
1e-11 of each quantity's scale (km, s, dB). The reference integrates the
same discretisation in another order of operations (np.gradient's
uniform stencils against the port's general ones, the path sums added
step by step against the port's sums over the whole path), so float64
results part by rounding grown over 300 steps: up to 8e-15 relative
here. 1e-11 leaves that three orders of room and is far below any change
of the method (a changed stencil, step or event rule moves a ray by 1e-4
relative or more). Statuses, landing masks, NaN masks of the homed values and the
steps each ray takes are equal.
"""

import numpy as np
import pytest
import torch

from hfbench import slices
from hfbench.reference import oblique_fan as ref
from pyrayhf_tpu_torch import oblique, pallas_ray
from pyrayhf_tpu_torch.absorption import collision_frequency
from pyrayhf_tpu_torch.gradient import _STATUS

from _torch_threads import one_torch_thread  # noqa: F401

Z = np.linspace(0.0, 600.0, 81)
X = np.linspace(0.0, 3900.0, 40)
F0S = np.linspace(4e6, 12e6, 4)
E, STEP, S_MAX, LINK, JUMP = 24, 10.0, 3000.0, 800.0, 200.0
N_STEPS = int(round(S_MAX / STEP))
EL = (5.0, 60.0)
RTOL = 1e-11
ATOL = {"ground_range_km": 1e-11, "group_path_km": 1e-11,
        "phase_path_km": 1e-11, "absorption_db": 1e-11,
        "group_delay_sec": 1e-11 / 3e5}
HOMED = {"delay": ("delay_{}_sec", 1e-11 / 3e5),
         "absorption": ("absorption_{}_db", 1e-11),
         "group_path": ("group_path_{}_km", 1e-11),
         "phase_path": ("phase_path_{}_km", 1e-11),
         "elev": ("elev_{}_deg", 1e-11)}


@pytest.fixture(scope="module")
def scene():
    return slices.slices(2, 1, 2 ** 33 + 21, Z, X, torch.device("cpu"))


def _elevations():
    k = np.arange(E - 1) / (E - 1)
    return np.append(EL[0] * (1 - k) + EL[1] * k, EL[1])


@pytest.fixture(scope="module")
def want(scene):
    return ref.oblique_ionogram(F0S, _elevations(), Z, X, *scene, 1.0,
                                STEP, N_STEPS, LINK, JUMP)


@pytest.fixture(scope="module", params=["xla", "pallas"])
def got(request, scene):
    """The entry's outputs and the fan's per-ray outputs of each slice
    with one engine."""
    engine = request.param
    entry, fan = [], []
    for den, bmag, bpsi in zip(*scene):
        entry.append(oblique.synthesize_oblique_ionogram_2d(
            F0S, LINK, X, Z, den, bmag, bpsi, n_elev=E,
            elev_min_deg=EL[0], elev_max_deg=EL[1], step_km=STEP,
            s_max_km=S_MAX, max_range_jump_km=JUMP, engine=engine))
        f0s = torch.as_tensor(F0S, dtype=torch.float64)
        nu = collision_frequency(Z, device="cpu")
        flds = oblique._fan_fields(f0s, den, bmag, bpsi, nu, "O")
        el = entry[-1]["elevations_deg"]
        ds = torch.tensor(STEP, dtype=torch.float64)
        if engine == "pallas":
            out = pallas_ray.fan_2d_pallas(Z, X, *flds, el, ds,
                                           n_steps=N_STEPS)
        else:
            out = oblique._xla_fan(Z, X, "cartesian", *flds, el, ds,
                                   N_STEPS, 1)
            out["steps_taken"] = out["alive"][..., :-1].sum(-1)
        fan.append(out)
    return engine, entry, fan


def _close(a, b, atol):
    a, b = a.double(), b.double()
    assert torch.equal(torch.isnan(a), torch.isnan(b))
    torch.testing.assert_close(a, b, rtol=RTOL, atol=atol, equal_nan=True)


def test_the_toy_link_is_reached(want):
    """Each slice homes a low ray at its lowest frequency, the second
    slice's higher frequencies lie above its MUF (NaN), and the fan holds
    rays that land, leave the slice and run out of path, so each rule is
    exercised."""
    homed = torch.isfinite(want["delay_low_sec"])
    assert homed[:, 0].all() and not homed.all()
    codes = set(want["status_code"].unique().tolist())
    assert codes == set(_STATUS.values()) - {_STATUS["attempts"]}


def test_entry_fan_matches_the_reference(got, want):
    _, entry, _ = got
    for s, out in enumerate(entry):
        _close(out["fan_range_km"], want["ground_range_km"][s],
               ATOL["ground_range_km"])
        _close(out["fan_delay_sec"], want["group_delay_sec"][s],
               ATOL["group_delay_sec"])


@pytest.mark.parametrize("side", ["low", "high"])
@pytest.mark.parametrize("what", sorted(HOMED))
def test_homed_outputs_match_the_reference(got, want, what, side):
    _, entry, _ = got
    key, atol = HOMED[what]
    for s, out in enumerate(entry):
        _close(out[key.format(side)], want[key.format(side)][s], atol)


@pytest.mark.parametrize("what", ["absorption_db", "group_path_km",
                                  "phase_path_km"])
def test_ray_sums_match_the_reference(got, want, what):
    _, _, fan = got
    for s, out in enumerate(fan):
        _close(out[what], want[what][s], ATOL[what])


def test_statuses_and_steps_match_the_reference(got, want):
    """The same event decides every ray, after as many steps: the steps
    the benchmark counts for the fan's work are the program's."""
    _, _, fan = got
    for s, out in enumerate(fan):
        assert torch.equal(out["status_code"].long(),
                           want["status_code"][s])
        assert torch.equal(out["steps_taken"].long(),
                           want["steps_taken"][s])
