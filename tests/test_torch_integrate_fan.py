"""PyTorch port vs the JAX package: the generalised fixed-step integrator
and the batched early-exit fan integrator ``_integrate_fan``.

The RHS is a rational lens (μ = 1/(1 + k|p − c|²), only +, −, ×, ÷ and
sqrt), so a ray's arithmetic rounds the same whether it runs alone or in a
batch: the fan equals the per-ray ``_integrate`` bit for bit, for 6-, 7-
and 10-channel states, with a position-dependent mirror (``reflect_fn``),
with a state projection (``renorm_fn``) and for two check cadences
(``chunk``). The 2-D fixed-step step is held bit for bit against a copy of
the step as it was before it took ``v_slice``/``reflect_fn``/``renorm_fn``.
Against the JAX ``_integrate_fan`` (CPU, float64): rtol 1e-12, identical
``alive`` and status.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyrayhf_tpu.gradient as JG
import pyrayhf_tpu_torch.gradient as TG

from _torch_threads import one_torch_thread  # noqa: F401

C = (0.0, 0.0, -500.0)
K = 0.02
N_STEPS = 400
DS = 0.125


def _lens_rhs(stack, zeros):
    """RHS of the ray equations in a stratified μ = 1/(1 + K z²), which
    turns low rays back to the ground, for states [..., ≥6] (position,
    unit direction, frozen extra channels)."""
    def rhs(y):
        z = y[..., 2]
        v = [y[..., 3 + k] for k in range(3)]
        mu = 1.0 / (1.0 + K * z * z)
        g = [zeros(z), zeros(z), -2.0 * K * z * mu * mu]
        gdv = g[0] * v[0] + g[1] * v[1] + g[2] * v[2]
        dv = [(g[k] - gdv * v[k]) / mu for k in range(3)]
        extra = [zeros(z)] * (y.shape[-1] - 6)
        return stack(v + dv + extra)
    return rhs


def _events(stack):
    def events(y):
        # ground (z > 0), top, |x| and |y| bounds
        return stack([y[..., 2] - 1e-3, 14.0 - y[..., 2], y[..., 0] + 40.0,
                      40.0 - y[..., 0], y[..., 1] + 40.0, 40.0 - y[..., 1]])
    return events


def _reflect_t(y):
    # mirror the direction about the normal (p − C)/|p − C| of a sphere
    # centred at C (a position-dependent "local vertical")
    d = y[..., :3] - torch.tensor(C, dtype=y.dtype)
    n = d / torch.sqrt((d * d).sum(-1, keepdim=True))
    vn = torch.clamp((y[..., 3:6] * n).sum(-1, keepdim=True), max=0.0)
    return torch.cat([y[..., :3], y[..., 3:6] - 2.0 * vn * n, y[..., 6:]], -1)


def _reflect_j(y):
    d = y[..., :3] - jnp.asarray(C)
    n = d / jnp.sqrt((d * d).sum(-1, keepdims=True))
    vn = jnp.minimum((y[..., 3:6] * n).sum(-1, keepdims=True), 0.0)
    return jnp.concatenate([y[..., :3], y[..., 3:6] - 2.0 * vn * n,
                            y[..., 6:]], -1)


def _renorm_t(y):
    # project the direction onto |v| = 1 + 0.01·x (a shell, not a unit
    # sphere, as the anisotropic tracer's dispersion shell)
    v = y[..., 3:6]
    vm = torch.sqrt((v * v).sum(-1, keepdim=True))
    return torch.cat([y[..., :3], v / vm * (1.0 + 0.01 * y[..., :1]),
                      y[..., 6:]], -1)


def _renorm_j(y):
    v = y[..., 3:6]
    vm = jnp.sqrt((v * v).sum(-1, keepdims=True))
    return jnp.concatenate([y[..., :3], v / vm * (1.0 + 0.01 * y[..., :1]),
                            y[..., 6:]], -1)


def _launch(dim, n=12):
    """[n, dim] launch states: a fan of elevations and azimuths from the
    ground, extra channels holding a per-ray constant."""
    el = np.deg2rad(np.linspace(15.0, 80.0, n // 3).repeat(3))
    az = np.deg2rad(np.tile([0.0, 35.0, 70.0], n // 3))
    v = np.stack([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az),
                  np.sin(el)], 1)
    p = np.tile([0.5, -0.25, 0.01], (n, 1))
    extra = np.arange(n)[:, None] * np.ones((1, dim - 6))
    return np.concatenate([p, v, extra], 1)


CASES = {
    "6ch": dict(dim=6),
    "7ch": dict(dim=7),
    "10ch": dict(dim=10),
    "6ch_reflect": dict(dim=6, hops=2),
    "10ch_renorm": dict(dim=10, renorm=True),
    "7ch_reflect_renorm": dict(dim=7, hops=2, renorm=True),
}


def _port_kw(case):
    kw = dict(v_slice=slice(3, 6))
    if case.get("hops"):
        kw.update(reflect_fn=_reflect_t, max_bounces=case["hops"] - 1)
    if case.get("renorm"):
        kw["renorm_fn"] = _renorm_t
    return kw


def _ds():
    return torch.tensor(DS, dtype=torch.float64)


def _port_fan(case, chunk):
    y0 = torch.from_numpy(_launch(case["dim"]))
    rhs = _lens_rhs(lambda xs: torch.stack(xs, -1), torch.zeros_like)
    return TG._integrate_fan(rhs, y0, N_STEPS, _ds(),
                             _events(lambda xs: torch.stack(xs, -1)),
                             chunk=chunk, **_port_kw(case))


@pytest.fixture(scope="module")
def fans():
    return {(name, chunk): _port_fan(case, chunk)
            for name, case in CASES.items() for chunk in (7, 125)}


@pytest.fixture(scope="module")
def jax_fans():
    out = {}
    for name, case in CASES.items():
        kw = dict(v_slice=slice(3, 6))
        if case.get("hops"):
            kw.update(reflect_fn=_reflect_j, max_bounces=case["hops"] - 1)
        if case.get("renorm"):
            kw["renorm_fn"] = _renorm_j
        rhs = _lens_rhs(lambda xs: jnp.stack(xs, -1), jnp.zeros_like)
        out[name] = JG._integrate_fan(
            rhs, jnp.asarray(_launch(case["dim"])), N_STEPS, DS,
            _events(lambda xs: jnp.stack(xs, -1)), chunk=25, **kw)
    return out


@pytest.mark.parametrize("chunk", [7, 125])
@pytest.mark.parametrize("name", list(CASES))
def test_fan_equals_per_ray_integrate(fans, name, chunk):
    """Each fan ray is the per-ray ``_integrate`` of its launch state, bit
    for bit (states, alive, status)."""
    case = CASES[name]
    ys, alive, status = fans[name, chunk]
    y0 = torch.from_numpy(_launch(case["dim"]))
    rhs = _lens_rhs(lambda xs: torch.stack(xs, -1), torch.zeros_like)
    for r in (0, 5, 11):
        y1, a1, s1 = TG._integrate(rhs, y0[r], N_STEPS, _ds(),
                                   _events(lambda xs: torch.stack(xs, -1)),
                                   **_port_kw(case))
        assert torch.equal(ys[r], y1) and torch.equal(alive[r], a1)
        assert int(status[r]) == int(s1)


@pytest.mark.parametrize("name", list(CASES))
def test_fan_does_not_depend_on_chunk(fans, name):
    """``chunk`` sets only the cadence of the early-exit check."""
    a, b = fans[name, 7], fans[name, 125]
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("name", list(CASES))
def test_fan_matches_jax(fans, jax_fans, name):
    """Against the JAX ``_integrate_fan`` at rtol 1e-12."""
    ys, alive, status = fans[name, 125]
    jy, ja, js = (np.asarray(v) for v in jax_fans[name])
    assert ys.shape == jy.shape
    np.testing.assert_array_equal(alive.numpy(), ja)
    np.testing.assert_array_equal(status.numpy(), js)
    np.testing.assert_allclose(ys.numpy(), jy, rtol=1e-12, atol=1e-12)
    # the fan really exits early and really bounces where asked
    assert not alive[:, -1].any()
    if CASES[name].get("hops"):
        assert (status.numpy() == JG._STATUS["ground"]).any()


def test_early_exit_stats():
    """The early exit stops at a multiple of ``chunk`` after the last ray
    froze and reports it in ``EXIT_STATS``."""
    ys, alive, _ = _port_fan(CASES["6ch"], 16)
    last = int(alive.any(0).nonzero().max())
    steps = TG.EXIT_STATS["steps"]
    assert steps % 16 == 0 and last <= steps < last + 16 < N_STEPS


def _old_2d_step(rhs, ds, event_value):
    """The 2-D fixed-step step of the port before ``v_slice``,
    ``reflect_fn`` and ``renorm_fn`` (no bounces)."""
    def renormalised(y):
        v = y[..., 2:]
        vmag = torch.sqrt(v[..., :1] * v[..., :1] + v[..., 1:] * v[..., 1:])
        pos = vmag > 0
        v = torch.where(pos, v / torch.where(pos, vmag, 1.0), v)
        return torch.cat([y[..., :2], v], dim=-1)

    def step(y, alive, status, bounces):
        y_new = renormalised(TG._rk4_step(rhs, y, ds))
        any_cross, j, y_cross, _ = TG._first_crossing(
            y, y_new, event_value(y), event_value(y_new))
        any_cross = any_cross & alive
        ground_hit = any_cross & (j[..., 0] == 0)
        y_next = torch.where(alive[..., None],
                             torch.where(any_cross[..., None], y_cross,
                                         y_new), y)
        status = torch.where(any_cross, torch.where(ground_hit, 1, 2),
                             status)
        alive_next = alive & ~any_cross
        bad = ~torch.isfinite(y_next).all(dim=-1)
        y_next = torch.where(bad[..., None], y, y_next)
        return y_next, alive_next & ~bad, status, bounces
    return step


@pytest.mark.parametrize("grad", [False, True])
def test_2d_integrate_unchanged(grad):
    """The generalised ``_integrate`` on a 2-D state [x, z, vx, vz] equals
    the step as it was before, bit for bit, with autograd on (rows
    stacked) and off (rows written into one buffer)."""
    def rhs(y):
        x, z, vx, vz = y.unbind(-1)
        n = 1.0 / (1.0 + 0.001 * (z - 8.0) * (z - 8.0) + 0.0001 * x)
        dndz = -0.002 * (z - 8.0) * n * n
        dndx = -0.0001 * n * n
        gdv = dndx * vx + dndz * vz
        return torch.stack([vx, vz, (dndx - gdv * vx) / n,
                            (dndz - gdv * vz) / n], -1)

    def events(y):
        return torch.stack([y[..., 1] - 1e-3, 20.0 - y[..., 1],
                            y[..., 0] + 1.0, 40.0 - y[..., 0]], -1)

    el = torch.deg2rad(torch.linspace(10.0, 80.0, 9, dtype=torch.float64))
    y0 = torch.stack([torch.zeros_like(el), torch.zeros_like(el),
                      torch.cos(el), torch.sin(el)], -1)
    ds = torch.tensor(0.25, dtype=torch.float64)
    with torch.set_grad_enabled(grad):
        ys, alive, status = TG._integrate(rhs, y0, 200, ds, events)
    step = _old_2d_step(rhs, ds, events)
    carry = (y0, torch.ones(9, dtype=torch.bool),
             torch.zeros(9, dtype=torch.int64),
             torch.zeros(9, dtype=torch.int64))
    rows, alives = [y0], [carry[1]]
    for _ in range(200):
        carry = step(*carry)
        rows.append(carry[0])
        alives.append(carry[1])
    assert torch.equal(ys, torch.stack(rows, -2))
    assert torch.equal(alive, torch.stack(alives, -1))
    assert torch.equal(status, carry[2])
