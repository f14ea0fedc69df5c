"""PyTorch port vs the JAX package: differentiation through the kernels.

The JAX package differentiates every kernel engine in both modes through
one custom JVP whose tangent runs the plain sweep (``_pallas_ad``,
``pallas_vh.py:1330-1360``), so a kernel entry's derivatives there are
those of ``ionogram_fast_xla`` (``tests/test_pallas.py`` holds
``jacfwd(kernel) == jacrev(kernel) == jacfwd(ionogram_fast_xla)`` at rtol
1e-10). The port's counterpart is ``pallas_vh._PallasAD``. Each kernel
entry point of the port (on CPU tensors: its plain version) is held, under
every ``torch.func`` transform and ``torch.autograd.forward_ad``, against
the JAX package's derivative of the same scalar or ionogram, in f64, on
``tests/test_pallas.py``'s profiles (B = 2, 180 nodes; 12 frequencies).
The JAX references come from one compiled jvp and one vjp of the sweep
per mode (jacfwd and jacrev of the scalar by the chain rule through them,
the Hessian from ``jax.hessian``): each XLA compile takes seconds. One
entry is also held against JAX's ``jacfwd`` through its own kernel entry
(interpret mode), as the JAX test runs it.

Forward over forward (``jacfwd`` of ``jacfwd``, ``jvp`` of ``jvp``) runs
the sweep through the transforms plus the kernel's constant gap
(``pallas_vh.run_engine``); it is held against ``jax.jacfwd(jax.jacfwd(·))``
of the sweep, one compile per mode, on one profile of 60 nodes at three
frequencies, and once through the JAX gather kernel in interpret mode.

Tolerances: rtol 1e-10 on first derivatives, 1e-8 on the Hessian and the
second derivatives, all with identical NaN masks (X mode: reverse mode
w.r.t. ψ is NaN in both packages); the ``vmap`` rule folds the mapped
axis into the profile axis, so it is held to the per-slice loop bit for
bit, and the primal of every transform to the call without AD.
"""

import functools

import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD
import jax
import jax.numpy as jnp
from numpy.testing import assert_allclose

import pyrayhf_tpu.pallas_vh as JV
import pyrayhf_tpu_torch.pallas_vh as TV
import pyrayhf_tpu_torch.pallas_ray as TR
import pyrayhf_tpu_torch.parallel as TP
from pyrayhf_tpu_torch.forward import vertical_forward_operator_batch

from _torch_threads import one_torch_thread  # noqa: F401

RTOL, RTOL_HESS = 1e-10, 1e-8
P0 = (1.0, 0.0)                    # (density scale, ψ offset [deg])


def _workload(B=2, n_alt=180):
    """``tests/test_pallas.py``'s profiles, at 12 frequencies."""
    alt = np.linspace(90.0, 550.0, n_alt)
    rng = np.random.default_rng(3)
    hms = rng.uniform(250.0, 330.0, B)
    peaks = rng.uniform(1e12, 3e12, B)
    den = peaks[:, None] * np.exp(-(alt[None, :] - hms[:, None]) ** 2
                                  / (2 * 55.0 ** 2))
    bmag = np.full((B, n_alt), 3.2e-5)
    bpsi = np.full((B, n_alt), 65.0)
    freqs = np.arange(1.0, 16.0, 1.25)
    return freqs, den, bmag, bpsi, alt


W = _workload()
_RNG = np.random.default_rng(12)
# a seeded (den, |B|, ψ) direction
TANS = (W[1] * _RNG.uniform(-1.0, 1.0, W[1].shape),
        W[2] * _RNG.uniform(-0.2, 0.2, W[2].shape),
        _RNG.uniform(-3.0, 3.0, W[3].shape))


def _vfo_gather(freq, den, bmag, bpsi, alt, mode_mult, n_points):
    return vertical_forward_operator_batch(
        freq, den, bmag, bpsi, alt, mode="O" if mode_mult > 0 else "X",
        n_points=n_points, engine="pallas_gather")


def _gather_host(*args, **kw):
    return TV.ionogram_pallas_gather(*args, x_in_kernel_solve=False, **kw)


# name: (port entry, mode_mult, the kernel the port's entry reaches)
ENTRIES = {
    "pallas_X": (TV.ionogram_pallas, -1.0, "sweep"),
    "mxu_O": (TV.ionogram_pallas_mxu, 1.0, "mxu"),
    "gather_O": (TV.ionogram_pallas_gather, 1.0, "gather_osolve"),
    "gather_X": (TV.ionogram_pallas_gather, -1.0, "gather_xsolve"),
    "gather_host_X": (_gather_host, -1.0, "gather"),
    "vfo_gather_O": (_vfo_gather, 1.0, "gather_osolve"),
}


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


def _port(name, freq, den, bmag, bpsi, alt):
    fn, mm, _ = ENTRIES[name]
    return fn(freq, den, bmag, bpsi, alt, mode_mult=mm, n_points=200)


def _port_scalar(name):
    """The port's sum of finite virtual heights, of p = (density scale,
    ψ offset)."""
    t = [_t(a) for a in W]

    def f(p):
        vh = _port(name, t[0], p[0] * t[1], t[2], t[3] + p[1], t[4])
        return torch.where(torch.isfinite(vh), vh, 0.0).sum()
    return f


def _jax_scalar(fn, mode_mult, **kw):
    """The JAX package's sum of finite virtual heights of ``fn`` (an
    ionogram function), of p = (density scale, ψ offset)."""
    j = [jnp.asarray(a) for a in W[:4]]

    def f(p):
        # the grid stays host data: the JAX kernel entries read it there
        vh = fn(j[0], p[0] * j[1], j[2], j[3] + p[1], W[4],
                mode_mult=mode_mult, n_points=200, **kw)
        return jnp.sum(jnp.where(jnp.isfinite(vh), vh, 0.0))
    return f


@functools.lru_cache(maxsize=None)
def _jax_lin(mode_mult):
    """The JAX sweep in mode ``mode_mult`` at :data:`W`: (vh, a compiled
    jvp taking (den, |B|, ψ) tangents, the vjp of the ionogram)."""
    j = [jnp.asarray(a) for a in W]

    def f(d, b, p):
        return JV.ionogram_fast_xla(j[0], d, b, p, j[4],
                                    mode_mult=mode_mult, n_points=200)
    jvp = jax.jit(lambda *t: jax.jvp(f, tuple(j[1:4]), t))
    vh, vjp = jax.vjp(f, *j[1:4])
    return np.asarray(vh), jvp, vjp


@functools.lru_cache(maxsize=None)
def _jax_ref(mode_mult, what):
    """The JAX package's derivative ``what`` in mode ``mode_mult``: of the
    scalar (:func:`_jax_scalar`) for jacfwd/jacrev/hessian, the (vh,
    tangent) pair along :data:`TANS` for jvp. Its kernel entries
    differentiate as the sweep; jacfwd and jacrev are the chain rule's
    through the sweep's jvp and vjp."""
    vh, jvp, vjp = _jax_lin(mode_mult)
    fin = np.isfinite(vh)
    zero = np.zeros_like(W[1])
    if what == "jvp":
        return tuple(np.asarray(o) for o in jvp(*TANS))
    if what == "jacfwd":
        cols = [np.asarray(jvp(*t)[1]) for t in ((W[1], zero, zero),
                                                  (zero, zero, zero + 1.0))]
        return np.array([np.sum(np.where(fin, c, 0.0)) for c in cols])
    if what == "jacrev":
        g_den, _, g_psi = (np.asarray(g) for g in vjp(fin.astype(float)))
        return np.array([np.sum(g_den * W[1]), np.sum(g_psi)])
    return np.asarray(jax.hessian(_jax_scalar(JV.ionogram_fast_xla,
                                              mode_mult))(jnp.array(P0)))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(port, ref, rtol=RTOL):
    """Identical NaN masks; ``rtol`` on the finite values, with an atol of
    1e-13 of the largest for the values that are zero to rounding."""
    port, ref = _np(port), _np(ref)
    assert port.shape == ref.shape
    np.testing.assert_array_equal(np.isnan(port), np.isnan(ref))
    m = np.isfinite(ref)
    assert_allclose(port[m], ref[m], rtol=rtol,
                    atol=1e-13 * np.abs(ref[m]).max(initial=0.0))


@pytest.mark.parametrize("name", list(ENTRIES))
def test_forward_mode_jacfwd_matches_jacrev(name):
    """Port of ``test_pallas_forward_mode_jacfwd_matches_jacrev``:
    ``torch.func.jacfwd``, ``jacrev`` and ``grad`` through every kernel
    entry point equal the JAX package's jacfwd and jacrev; in O mode the
    two modes agree, as the JAX test holds."""
    _, mm, kind = ENTRIES[name]
    port = _port_scalar(name)
    p0 = torch.tensor(P0, dtype=torch.float64)
    TV.reset_counters()
    d_fwd = torch.func.jacfwd(port)(p0)
    d_rev = torch.func.jacrev(port)(p0)
    d_grad = torch.func.grad(port)(p0)
    # the primal through the entry's kernel, the derivatives through the
    # sweep (uncounted: not a plain version standing in for a kernel)
    assert TV.PLAIN_CALLS[kind] == 3 and sum(TV.PLAIN_CALLS.values()) == 3
    assert np.all(_jax_ref(mm, "jacfwd") != 0.0)
    _close(d_fwd, _jax_ref(mm, "jacfwd"))
    _close(d_rev, _jax_ref(mm, "jacrev"))
    _close(d_grad, _jax_ref(mm, "jacrev"))
    if mm > 0:
        _close(d_rev, d_fwd)
    else:
        # X mode: reverse mode w.r.t. ψ is NaN in both packages (the naive
        # derivative branch's 0·inf), forward mode finite
        assert np.isnan(_np(d_rev)[1]) and np.isfinite(_np(d_fwd)).all()


def test_jacfwd_through_the_jax_kernel_entry():
    """The port's jacfwd equals JAX's jacfwd through the JAX kernel entry
    itself (the gather kernel in interpret mode), as the JAX test runs
    it."""
    d = torch.func.jacfwd(_port_scalar("gather_O"))(
        torch.tensor(P0, dtype=torch.float64))
    ref = jax.jacfwd(_jax_scalar(JV.ionogram_pallas_gather, 1.0,
                                 interpret=True))(jnp.array(P0))
    _close(d, ref)


@pytest.mark.parametrize("name", list(ENTRIES))
def test_forward_ad_duals_match_jax_jvp(name):
    """``torch.autograd.forward_ad`` and ``torch.func.jvp`` along a seeded
    (den, |B|, ψ) direction equal ``jax.jvp``; the primal is the entry's
    own (kernel) value, bit for bit."""
    mm = ENTRIES[name][1]
    t = [_t(a) for a in W]
    plain = _port(name, *t)
    with fwAD.dual_level():
        duals = [fwAD.make_dual(x, _t(d)) for x, d in zip(t[1:4], TANS)]
        primal, tangent = fwAD.unpack_dual(_port(name, t[0], *duals, t[4]))
        primal, tangent = primal.clone(), tangent.clone()
    f_primal, f_tangent = torch.func.jvp(
        lambda d, b, p: _port(name, t[0], d, b, p, t[4]), tuple(t[1:4]),
        tuple(_t(d) for d in TANS))
    assert torch.equal(torch.nan_to_num(primal), torch.nan_to_num(plain))
    assert torch.equal(torch.nan_to_num(f_primal), torch.nan_to_num(plain))
    j_vh, j_tangent = _jax_ref(mm, "jvp")
    _close(plain, j_vh, rtol=1e-8)
    assert np.isfinite(j_tangent).any()
    _close(tangent, j_tangent)
    _close(f_tangent, j_tangent)


@pytest.mark.parametrize("name", list(ENTRIES))
def test_hessian_matches_jax(name):
    """``torch.func.hessian`` (jacfwd of jacrev) equals ``jax.hessian``,
    NaN row included; in O mode (finite, symmetric) double backward equals
    it too."""
    mm = ENTRIES[name][1]
    port = _port_scalar(name)
    p0 = torch.tensor(P0, dtype=torch.float64)
    ref = _jax_ref(mm, "hessian")
    _close(torch.func.hessian(port)(p0), ref, rtol=RTOL_HESS)
    if mm > 0:
        p = p0.clone().requires_grad_(True)
        (g,) = torch.autograd.grad(port(p), p, create_graph=True)
        rows = torch.stack([torch.autograd.grad(g[i], p,
                                                retain_graph=True)[0]
                            for i in range(2)])
        assert np.isfinite(ref).all()
        _close(rows, ref, rtol=RTOL_HESS)


# forward over forward: one profile on 60 nodes at three frequencies (3.5,
# 7.25 and 11 MHz: the last escapes in O mode, reflects in X), as functions
# of q = (density scale, |B| scale)
W2 = (W[0][[2, 5, 8]], *_workload(B=1, n_alt=60)[1:])
Q0 = (1.0, 1.0)
U2, V2 = (0.7, -1.3), (1.1, 0.4)    # two directions in q


def _sharded(freq, den, bmag, bpsi, alt, mode_mult, n_points):
    """``synthesize_ionograms_sharded(engine="pallas")`` on a 1 x 3 mesh of
    CPU devices: the sweep kernel (its plain version) once per block."""
    mesh = TP.ionogram_mesh([torch.device("cpu")] * 3, batch_axis=1)
    return TP.synthesize_ionograms_sharded(
        freq, den, bmag, bpsi, alt, mesh, mode="O" if mode_mult > 0 else "X",
        n_points=n_points, engine="pallas")


# name: (port entry, mode_mult, kernel, its calls per primal)
SECOND = {**{k: (*v, 1) for k, v in ENTRIES.items()},
          "sharded_O": (_sharded, 1.0, "sweep", 3)}


def _port_q(name):
    """The port's ionogram [1, 3] at :data:`W2`, of q."""
    fn, mm, _, _ = SECOND[name]
    t = [_t(a) for a in W2]

    def f(q):
        return fn(t[0], q[0] * t[1], q[1] * t[2], t[3], t[4], mode_mult=mm,
                  n_points=200)
    return f


@functools.lru_cache(maxsize=None)
def _jax_second(mode_mult):
    """(vh, jacfwd, jacfwd of jacfwd) of the JAX sweep's ionogram at
    :data:`W2` in q at :data:`Q0`, compiled once per mode: the JAX package
    takes every derivative order of a kernel entry from the sweep."""
    j = [jnp.asarray(a) for a in W2]

    def g(q):
        return JV.ionogram_fast_xla(j[0], q[0] * j[1], q[1] * j[2], j[3],
                                    j[4], mode_mult=mode_mult, n_points=200)
    fn = jax.jit(lambda q: (g(q), jax.jacfwd(g)(q),
                            jax.jacfwd(jax.jacfwd(g))(q)))
    return tuple(np.asarray(o) for o in fn(jnp.array(Q0)))


def _q(v):
    return torch.tensor(v, dtype=torch.float64)


@pytest.mark.parametrize("name", list(SECOND))
def test_jacfwd_of_jacfwd_matches_jax(name):
    """``torch.func.jacfwd(torch.func.jacfwd(·))`` through every kernel
    entry equals ``jax.jacfwd(jax.jacfwd(·))`` [1, 3, 2, 2]; the primal
    runs the entry's kernel (its plain version here) once per block and no
    other plain version."""
    _, mm, kind, calls = SECOND[name]
    TV.reset_counters()
    hess = torch.func.jacfwd(torch.func.jacfwd(_port_q(name)))(_q(Q0))
    assert TV.PLAIN_CALLS[kind] == calls
    assert sum(TV.PLAIN_CALLS.values()) == calls
    ref = _jax_second(mm)[2]
    assert np.isfinite(ref).any() and np.any(ref != 0.0)
    _close(hess, ref, rtol=RTOL_HESS)


@pytest.mark.parametrize("name", list(SECOND))
def test_jvp_of_jvp_keeps_the_kernel_primal(name):
    """``torch.func.jvp`` of ``torch.func.jvp``: the primal is the entry's
    own value bit for bit, the tangents are JAX's J·u, J·v and uᵀ·H·v."""
    _, mm, _, _ = SECOND[name]
    f = _port_q(name)
    plain = f(_q(Q0))

    def inner(q):
        return torch.func.jvp(f, (q,), (_q(U2),))
    (primal, t_u), (t_v, t_uv) = torch.func.jvp(inner, (_q(Q0),),
                                                (_q(V2),))
    assert torch.equal(torch.nan_to_num(primal, nan=-1.0),
                       torch.nan_to_num(plain, nan=-1.0))
    vh, jac, hess = _jax_second(mm)
    u, v = np.asarray(U2), np.asarray(V2)
    _close(primal, vh, rtol=1e-8)
    _close(t_u, jac @ u)
    _close(t_v, jac @ v)
    _close(t_uv, np.einsum("bfij,i,j->bf", hess, u, v), rtol=RTOL_HESS)


def test_forward_over_forward_raises():
    """Forward over forward through a kernel entry, which raised
    NotImplementedError before the sweep-plus-gap composition: jacfwd of
    jacfwd of the port's O gather equals JAX's through its own kernel entry
    (the gather kernel in interpret mode), as the JAX test would run it."""
    j = [jnp.asarray(a) for a in W2[:4]]

    def g(q):
        return JV.ionogram_pallas_gather(j[0], q[0] * j[1], q[1] * j[2],
                                         j[3], W2[4], mode_mult=1.0,
                                         n_points=200, interpret=True)
    hess = torch.func.jacfwd(torch.func.jacfwd(_port_q("gather_O")))(_q(Q0))
    ref = jax.jit(jax.jacfwd(jax.jacfwd(g)))(jnp.array(Q0))
    assert np.isfinite(np.asarray(ref)).all()
    _close(hess, ref, rtol=RTOL_HESS)


def test_vmap_of_jacfwd_of_jacfwd_folds_into_one_call():
    """``vmap`` of ``jacfwd`` of ``jacfwd`` over a stack of density scales:
    one kernel call (its plain version) for the stack, bit for bit the
    per-slice loop."""
    t = [_t(a) for a in W2]
    scales = _t([1.0, 0.8, 1.25])

    def hess_at(s):
        def f(q):
            return TV.ionogram_pallas_gather(
                t[0], s * q[0] * t[1], q[1] * t[2], t[3], t[4],
                mode_mult=-1.0, n_points=200)
        return torch.func.jacfwd(torch.func.jacfwd(f))(_q(Q0))
    TV.reset_counters()
    out = torch.func.vmap(hess_at)(scales)
    assert TV.PLAIN_CALLS["gather_xsolve"] == 1
    assert sum(TV.PLAIN_CALLS.values()) == 1
    loop = torch.stack([hess_at(s) for s in scales])
    assert torch.equal(torch.nan_to_num(out, nan=-1.0),
                       torch.nan_to_num(loop, nan=-1.0))


def test_forward_ad_inside_jvp_is_the_sweeps():
    """``torch.autograd.forward_ad`` inside a ``torch.func.jvp``: PyTorch
    keeps both on one dual level (a nested ``dual_level`` raises), so a
    dual made on a constant there is PyTorch's to interpret. Through a
    kernel entry the outputs are those of the plain sweep (``engine=
    "xla"``) bit for bit, with the kernel's primal."""
    t = [_t(a) for a in W2]
    tb = t[2] * 0.1

    def run(fn):
        def g(d):
            b = fwAD.make_dual(t[2], tb)
            out = fwAD.unpack_dual(fn(t[0], d, b, t[3], t[4],
                                      mode_mult=-1.0, n_points=200))
            return out.primal, out.tangent
        (primal, tangent), d_outs = torch.func.jvp(g, (t[1],),
                                                   (t[1] * 0.3,))
        return primal, (tangent, *d_outs)
    primal, got = run(TV.ionogram_pallas_gather)
    plain = TV.ionogram_pallas_gather(*t, mode_mult=-1.0, n_points=200)
    assert torch.equal(torch.nan_to_num(primal, nan=-1.0),
                       torch.nan_to_num(plain, nan=-1.0))
    for a, b in zip(got, run(TV.ionogram_fast_xla)[1]):
        assert torch.equal(torch.nan_to_num(a, nan=-1.0),
                           torch.nan_to_num(b, nan=-1.0))


@pytest.mark.parametrize("name", list(ENTRIES))
def test_vmap_folds_into_one_call(name):
    """``torch.func.vmap`` over a [V, B, N] stack: one kernel call (its
    plain version here) on the [V·B, N] fold, bit for bit the per-slice
    loop; a mapped frequency axis runs one call per slice."""
    freq, den, bmag, bpsi, alt = (_t(a) for a in W)
    scale = _t([1.0, 1.1, 0.9])[:, None, None]
    stack = (den * scale, bmag * scale, bpsi + 10.0 * scale)
    kind = ENTRIES[name][2]
    TV.reset_counters()
    out = torch.func.vmap(lambda d, b, p: _port(name, freq, d, b, p, alt))(
        *stack)
    assert TV.PLAIN_CALLS[kind] == 1 and sum(TV.PLAIN_CALLS.values()) == 1
    loop = torch.stack([_port(name, freq, *(s[v] for s in stack), alt)
                        for v in range(3)])
    assert torch.equal(torch.nan_to_num(out, nan=-1.0),
                       torch.nan_to_num(loop, nan=-1.0))
    fr = torch.stack([freq, freq + 0.25])
    TV.reset_counters()
    out_f = torch.func.vmap(lambda f: _port(name, f, den, bmag, bpsi, alt))(fr)
    assert sum(TV.PLAIN_CALLS.values()) == 2
    loop_f = torch.stack([_port(name, f, den, bmag, bpsi, alt) for f in fr])
    assert torch.equal(torch.nan_to_num(out_f, nan=-1.0),
                       torch.nan_to_num(loop_f, nan=-1.0))


@pytest.mark.parametrize("entry", ["batch_operator", "sharded"])
def test_jvp_through_batch_operator_and_sharded_synthesis(entry):
    """``torch.func.jvp`` through ``vertical_forward_operator_batch(engine=
    "pallas_gather")`` and through ``synthesize_ionograms_sharded(engine=
    "pallas")`` on a 2 × 2 mesh of CPU devices (the sweep kernel once per
    block) equals ``jax.jvp``, O mode."""
    t = [_t(a) for a in W]
    if entry == "batch_operator":
        def fn(d, b, p):
            return vertical_forward_operator_batch(
                t[0], d, b, p, t[4], mode="O", n_points=200,
                engine="pallas_gather")
    else:
        mesh = TP.ionogram_mesh([torch.device("cpu")] * 4, batch_axis=2)

        def fn(d, b, p):
            return TP.synthesize_ionograms_sharded(
                t[0], d, b, p, t[4], mesh, mode="O", n_points=200,
                engine="pallas")
    TV.reset_counters()
    vh, tangent = torch.func.jvp(fn, tuple(t[1:4]),
                                 tuple(_t(d) for d in TANS))
    kind = "sweep" if entry == "sharded" else "gather_osolve"
    assert TV.PLAIN_CALLS[kind] == (4 if entry == "sharded" else 1)
    j_vh, j_tangent = _jax_ref(1.0, "jvp")
    _close(vh, j_vh, rtol=1e-8)
    _close(tangent, j_tangent)


def test_fan_kernel_refuses_forward_mode():
    """The fan kernel has no derivative rule (nor has the JAX
    ``_fan_kernel``): a forward-mode dual or a field under a ``torch.func``
    derivative transform raises instead of coming out with a zero tangent
    (``vmap`` alone has a rule: tests/test_torch_pallas_ray.py)."""
    z, x = np.linspace(0.0, 400.0, 41), np.linspace(0.0, 1000.0, 11)
    mu = torch.full((2, 41, 11), 0.9, dtype=torch.float64)
    mup = torch.full_like(mu, 1.1)
    kappa = torch.zeros_like(mu)
    els = torch.tensor([10.0, 30.0], dtype=torch.float64)

    def fan(m):
        return TR.fan_2d_pallas(z, x, m, mup, kappa, els, 10.0,
                                n_steps=5)["ground_range_km"]
    assert fan(mu).shape == (2, 2)
    with fwAD.dual_level():
        with pytest.raises(ValueError, match="no backward and no forward"):
            fan(fwAD.make_dual(mu, torch.ones_like(mu)))
    with pytest.raises(ValueError, match="no backward and no forward"):
        torch.func.jvp(fan, (mu,), (torch.ones_like(mu),))
    with pytest.raises(ValueError, match="no backward and no forward"):
        fan(mu.clone().requires_grad_(True))
