"""PyTorch port vs the JAX package: the ray-fan kernel's module.

The kernel's plain PyTorch version (what ``fan_2d_pallas`` runs on CPU
tensors) is held against the JAX ``fan_2d_pallas`` in interpret mode, as
``tests/test_pallas_ray.py`` runs it, on the same numpy fields: that
test's small scene (101×17 uniform grid, F=2, E=24), Cartesian and
spherical, and X mode through a ground bounce; ``torch.func.vmap`` of the
wrapper over two field stacks against ``jax.vmap`` of the JAX fan.
Tolerance: rtol 1e-8, atol 1e-10 with equal NaN positions
(``tests/test_pallas_ray.py:58``).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import pyrayhf_tpu.magnetoionic as JM
import pyrayhf_tpu.absorption as JA
import pyrayhf_tpu.pallas_ray as JR
import pyrayhf_tpu_torch.pallas_ray as TR

from _torch_threads import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-8, 1e-10
JAX_KEYS = ("ground_range_km", "group_delay_sec", "absorption_db",
            "group_path_km", "phase_path_km", "status_code", "x_final_km",
            "z_final_km")


def _scene(nz=101, nx=17, tilt=0.15):
    """tests/test_pallas_ray.py's uniform-grid tilted Chapman slice."""
    z = np.linspace(0.0, 400.0, nz)
    x = np.linspace(0.0, 2000.0, nx)
    h = (z[:, None] - 250.0) / 45.0
    nmf2 = 8.0e11 * (1.0 + tilt * (x[None, :] / x[-1] - 0.5))
    ne = nmf2 * np.exp(0.5 * (1.0 - h - np.exp(-h)))
    babs = np.full((nz, nx), 4.5e-5)
    bpsi = np.full((nz, nx), np.deg2rad(30.0))
    nu_z = 1e7 * np.exp(-(z - 70.0) / 8.0)
    return z, x, ne, babs, bpsi, nu_z


def _fields(mode, f0s=(5.0e6, 9.0e6)):
    """[F, nz, nx] μ, μ', κ in numpy f64, as the fan makes them."""
    z, x, ne, babs, bpsi, nu_z = _scene()
    f = np.asarray(f0s)[:, None, None]
    X = JM.find_X(ne[None], f)
    Y = JM.find_Y(f, babs[None])
    mu, mup = JM.find_mu_mup(X, Y, bpsi[None], mode)
    kap = JA.absorption_coefficient(ne[None], nu_z[None, :, None], f,
                                    babs[None], bpsi[None], mu, mode)
    kap = np.where(np.isfinite(kap), kap, 0.0)
    return z, x, np.array(mu), np.array(mup), kap


CASES = {"cartesian": ("cartesian", "O", 1, 250),
         "spherical": ("spherical", "O", 1, 250),
         "x_2hop": ("cartesian", "X", 2, 400)}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_fan_matches_jax_interpret(case):
    geometry, mode, n_hops, n_steps = CASES[case]
    z, x, mu, mup, kap = _fields(mode)
    elevs = np.linspace(8.0, 60.0, 24)
    ref = JR.fan_2d_pallas(z, x, jnp.asarray(mu), jnp.asarray(mup),
                           jnp.asarray(kap), jnp.asarray(elevs), 10.0,
                           geometry=geometry, n_steps=n_steps,
                           n_hops=n_hops, interpret=True)
    TR.reset_counters()
    port = TR.fan_2d_pallas(z, x, torch.from_numpy(mu),
                            torch.from_numpy(mup), torch.from_numpy(kap),
                            torch.from_numpy(elevs), 10.0,
                            geometry=geometry, n_steps=n_steps,
                            n_hops=n_hops)
    assert TR.PLAIN_CALLS["fan_2d"] == 1 and TR.LAUNCHES["fan_2d"] == 0
    for k in JAX_KEYS:
        p, r = port[k].numpy(), np.asarray(ref[k])
        assert p.shape == r.shape == (2, 24), k
        assert np.allclose(p, r, rtol=RTOL, atol=ATOL, equal_nan=True), k
    land = np.isfinite(port["ground_range_km"].numpy())
    assert land.any() and (~land).any()
    st = port["status_code"].numpy()
    assert np.array_equal(land, st == 1)
    assert (port["steps_taken"] <= n_steps).all()


def test_fan_wrapper_raises():
    """No backward, no meaning for interpret on a card, no other device,
    no non-uniform grid — and never a quiet fallback."""
    z, x, mu, mup, kap = _fields("O")
    args = [torch.from_numpy(a) for a in (mu, mup, kap)]
    elevs = torch.linspace(8.0, 60.0, 4, dtype=torch.float64)
    with pytest.raises(ValueError, match="no backward"):
        TR.fan_2d_pallas(z, x, args[0].clone().requires_grad_(True),
                         *args[1:], elevs, 10.0, n_steps=5)
    with pytest.raises(ValueError, match="no fan kernel for device"):
        TR.fan_2d_pallas(z, x, *[a.to("meta") for a in args], elevs, 10.0,
                         n_steps=5)
    z_nu = np.concatenate([z[:50], z[50:] + np.linspace(0.0, 3.0, 51)])
    with pytest.raises(ValueError, match="uniform"):
        TR.fan_2d_pallas(z_nu, x, *args, elevs, 10.0, n_steps=5)
    with pytest.raises(ValueError, match="CUDA tensors"):
        geo = TR.fan_geometry(z, x, "cartesian")
        TR.launch_fan(geo, TR.pack_tables(geo, *args), elevs,
                      torch.tensor(10.0, dtype=torch.float64), n_steps=5)


def test_no_table_size_gate():
    """The 621×800 field of the reference tutorials: refused by the TPU
    engine's VMEM gate, admitted here (only uniformity is required)."""
    z, x = np.linspace(0.0, 620.0, 621), np.linspace(0.0, 3995.0, 800)
    assert not JR.fan_2d_pallas_available(z, x, 128)
    assert TR.fan_2d_pallas_available(z, x, 128)
    geo = TR.fan_geometry(z, x, "spherical")
    assert (geo.nz, geo.nx) == (621, 800)
    assert geo.ground == 6371.0 and geo.hi == 3995.0 / 6371.0


def _equal(a, b):
    return torch.equal(torch.nan_to_num(a, nan=-7.0),
                       torch.nan_to_num(b, nan=-7.0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("geometry", ["cartesian", "spherical"])
def test_pack_tables_layout(geometry, dtype):
    """Node-major: [F, nz, nx, 4] records (μ, ∂μ/∂c0, ∂μ/∂c1, μ'), then
    κ [F, nz, nx], in one flat 16-byte-aligned tensor. The gradients are
    ``gradient_ord2`` on the native axes rebuilt as o + i/inv_d, exactly
    the port's and within round-off the JAX host side's."""
    import pyrayhf_tpu.fields as JF
    from pyrayhf_tpu_torch.fields import gradient_ord2
    z, x, mu, mup, kap = _fields("O")
    geo = TR.fan_geometry(z, x, geometry)
    mu_t, mup_t, kap_t = (torch.from_numpy(a).to(dtype)
                          for a in (mu, mup, kap))
    tab = TR.pack_tables(geo, mu_t, mup_t, kap_t)
    assert tab.shape == (5 * 2 * 101 * 17,) and tab.dtype == dtype
    assert tab.is_contiguous() and tab.data_ptr() % 16 == 0
    rec, kap_v = TR.table_views(geo, tab)
    assert rec.shape == (2, 101, 17, 4) and kap_v.shape == (2, 101, 17)
    assert rec.data_ptr() == tab.data_ptr()
    assert kap_v.data_ptr() == tab.data_ptr() + 2 * 101 * 17 * 4 * \
        tab.element_size()
    kw = dict(dtype=dtype)
    c0 = (torch.tensor(geo.o0, **kw) + torch.arange(geo.nz, **kw)
          / torch.tensor(geo.inv_d0, **kw))
    c1 = (torch.tensor(geo.o1, **kw) + torch.arange(geo.nx, **kw)
          / torch.tensor(geo.inv_d1, **kw))
    g0, g1 = gradient_ord2(mu_t, c0, c1)
    for c, want in enumerate((mu_t, g0, g1, mup_t)):
        assert _equal(rec[..., c], want), c
    assert torch.equal(kap_v, kap_t)
    assert torch.isnan(rec[..., 1]).any() and torch.isfinite(g0).any()
    # the JAX host side's gradients on its axes (pallas_ray.py:384-388)
    jd = np.float32 if dtype == torch.float32 else np.float64
    jc0 = jnp.asarray(geo.o0, jd) + jnp.arange(geo.nz, dtype=jd) / \
        jnp.asarray(geo.inv_d0, jd)
    jc1 = jnp.asarray(geo.o1, jd) + jnp.arange(geo.nx, dtype=jd) / \
        jnp.asarray(geo.inv_d1, jd)
    rtol = 1e-5 if dtype == torch.float32 else 1e-12
    for f in range(2):
        jg = JF.gradient_ord2(jnp.asarray(mu[f], jd), jc0, jc1)
        for c in (1, 2):
            j = np.asarray(jg[c - 1], np.float64)
            scale = np.nanmax(np.abs(j))
            assert np.allclose(rec[f, ..., c].double().numpy(), j, rtol=rtol,
                               atol=rtol * scale, equal_nan=True), (f, c)


def test_table_views_refuses_other_tensors():
    """Only a flat tensor of whole frequencies' tables is taken apart."""
    z, x, mu, mup, kap = _fields("O")
    geo = TR.fan_geometry(z, x, "cartesian")
    tab = TR.pack_tables(geo, *[torch.from_numpy(a) for a in (mu, mup, kap)])
    assert TR.table_views(geo, tab[: 5 * 101 * 17])[0].shape == \
        (1, 101, 17, 4)
    for bad in (tab[:-1], tab.view(2, -1), tab[:0]):
        with pytest.raises(ValueError, match="tables must be"):
            TR.table_views(geo, bad)


@pytest.mark.parametrize("nz,nx,dtype,path", [
    (512, 32, torch.float32, "shared"),      # the typical slice: 203 KB
    (512, 32, torch.float64, "global"),
    (621, 800, torch.float32, "global"),     # the tutorials' 621 × 800 field
    (101, 17, torch.float64, "shared"),
    (586, 32, torch.float32, "shared"),      # 3·586·33·4 = 232,056 B
    (587, 32, torch.float32, "global"),      # 232,452 B > 232,448 B
])
def test_fan_path_by_table_size(nz, nx, dtype, path):
    """The shared-memory path where one frequency's μ, ∂μ/∂c0, ∂μ/∂c1,
    rows of odd stride nx | 1, fit a block's 227 KB; else global."""
    geo = TR.fan_geometry(np.linspace(0.0, 600.0, nz),
                          np.linspace(0.0, 4000.0, nx), "cartesian")
    assert TR.fan_path(geo, dtype) == path


# vmap: V = 2 field stacks of the scene (the second a perturbed copy), F = 2,
# E = 8, 120 steps
VMAP_ELEVS = np.linspace(8.0, 60.0, 8)


def _vmap_stack(mode="O"):
    z, x, mu, mup, kap = _fields(mode)
    return z, x, [np.stack([a, a * s]) for a, s in ((mu, 0.995), (mup, 1.01),
                                                     (kap, 1.2))]


def _port_fan(z, x, elevs=VMAP_ELEVS):
    def fan(mu, mup, kap):
        return TR.fan_2d_pallas(z, x, mu, mup, kap, torch.as_tensor(elevs),
                                10.0, n_steps=120)
    return fan


def test_vmap_matches_jax_vmap():
    """``torch.func.vmap`` of ``fan_2d_pallas`` over V = 2 field stacks is
    ``jax.vmap`` of the JAX fan (interpret mode, batched by ``pallas_call``'s
    rule): rtol 1e-8, atol 1e-10, equal NaN positions and landings."""
    z, x, stack = _vmap_stack()
    TR.reset_counters()
    port = torch.func.vmap(_port_fan(z, x))(*map(torch.from_numpy, stack))
    assert TR.PLAIN_CALLS["fan_2d"] == 1
    ref = jax.vmap(lambda mu, mup, kap: JR.fan_2d_pallas(
        z, x, mu, mup, kap, jnp.asarray(VMAP_ELEVS), 10.0, n_steps=120,
        interpret=True))(*map(jnp.asarray, stack))
    for k in JAX_KEYS:
        p, r = port[k].numpy(), np.asarray(ref[k])
        assert p.shape == r.shape == (2, 2, 8), k
        assert np.allclose(p, r, rtol=RTOL, atol=ATOL, equal_nan=True), k
    land = np.isfinite(port["ground_range_km"].numpy())
    assert land.any() and (~land).any()
    assert np.array_equal(land, port["status_code"].numpy() == 1)


def test_vmap_folds_into_one_launch():
    """Only the fields batched: one call (the plain version here) over the
    [V·F, E] fold, bit for bit the per-slice loop; a batched ``elevs`` runs
    one call per slice; forward mode under ``vmap`` still raises."""
    z, x, stack = _vmap_stack("X")
    t = [torch.from_numpy(a) for a in stack]
    fan = _port_fan(z, x)
    TR.reset_counters()
    out = torch.func.vmap(fan, in_dims=(0, None, 0))(t[0], t[1][0], t[2])
    assert TR.PLAIN_CALLS["fan_2d"] == 1
    for v in range(2):
        one = fan(t[0][v], t[1][0], t[2][v])
        assert all(_equal(out[k][v], one[k]) for k in TR.OUTPUTS)
    els = torch.stack([torch.as_tensor(VMAP_ELEVS), torch.as_tensor(
        VMAP_ELEVS) + 1.5])
    TR.reset_counters()
    out_e = torch.func.vmap(lambda e: _port_fan(z, x, e)(
        t[0][0], t[1][0], t[2][0]))(els)
    assert TR.PLAIN_CALLS["fan_2d"] == 2
    for v in range(2):
        one = _port_fan(z, x, els[v])(t[0][0], t[1][0], t[2][0])
        assert all(_equal(out_e[k][v], one[k]) for k in TR.OUTPUTS)
    with pytest.raises(ValueError, match="no backward and no forward"):
        torch.func.vmap(lambda m: torch.func.jvp(
            lambda mm: fan(mm, t[1][0], t[2][0])["ground_range_km"], (m,),
            (torch.ones_like(m),)))(t[0])


# ---- the tables straight from the slice (fan_tables) ----------------------

def _slice_tensors():
    """The scene's slice as CPU tensors: (f0s, Ne, |B|, ψ [deg], ν)."""
    z, x, ne, babs, bpsi, nu_z = _scene()
    return z, x, [torch.as_tensor(a) for a in (
        np.array([5.0e6, 9.0e6]), ne, babs, np.rad2deg(bpsi) + 0.0 * ne,
        nu_z)]


def _bits(t):
    return torch.nan_to_num(t, nan=-7.0).view(torch.int64)


@pytest.mark.parametrize("mode", ["O", "X"])
@pytest.mark.parametrize("geometry", ["cartesian", "spherical"])
def test_fan_tables_plain_is_the_fields_and_pack_tables(mode, geometry):
    """On CPU tensors ``fan_tables`` is ``pack_tables`` of ``_fan_fields``,
    bit for bit, counted as one plain call and no launch."""
    from pyrayhf_tpu_torch import oblique
    z, x, t = _slice_tensors()
    geo = TR.fan_geometry(z, x, geometry)
    TR.reset_counters()
    tab = TR.fan_tables(geo, *t, mode)
    assert TR.PLAIN_CALLS == {"fan_2d": 0, "fan_tables": 1}
    assert sum(TR.LAUNCHES.values()) == 0
    want = TR.pack_tables(geo, *oblique._fan_fields(*t, mode))
    assert tab.shape == want.shape == (5 * 2 * 101 * 17,)
    assert torch.equal(_bits(tab), _bits(want))
    assert torch.isnan(TR.table_views(geo, tab)[0][..., 0]).any()


def test_launch_fan_tables_needs_cuda_tensors():
    """The kernel's launcher refuses CPU tensors (``fan_tables`` takes the
    plain version for them) and counts nothing."""
    z, x, t = _slice_tensors()
    geo = TR.fan_geometry(z, x, "cartesian")
    TR.reset_counters()
    with pytest.raises(ValueError, match="CUDA tensors"):
        TR.launch_fan_tables(geo, *t, "O")
    with pytest.raises(ValueError, match="Mode"):
        TR.launch_fan_tables(geo, *t, "Q")
    assert sum(TR.LAUNCHES.values()) == sum(TR.PLAIN_CALLS.values()) == 0


def _synthesis(engine, **kw):
    from pyrayhf_tpu_torch.oblique import synthesize_oblique_ionogram_2d
    z, x, t = _slice_tensors()
    return synthesize_oblique_ionogram_2d(
        t[0].numpy(), 900.0, x, z, *t[1:4], n_elev=16, step_km=10.0,
        s_max_km=2000.0, engine=engine, **kw)


@pytest.mark.parametrize("mode,geometry", [("O", "cartesian"),
                                           ("X", "spherical")])
def test_oblique_2d_on_the_cpu_keeps_its_outputs(monkeypatch, mode,
                                                 geometry):
    """``engine="pallas"`` on CPU tensors takes the tables from
    ``fan_tables`` (its plain version) and gives, bit for bit, what the
    route through ``fan_2d_pallas`` gives; nothing is launched, and either
    route counts its table build once. ``engine="auto"`` stays on the
    gradient-ODE fan there."""
    wrapped = []

    def spy(*a, **kw):
        wrapped.append(1)
        return fan_2d_pallas(*a, **kw)

    fan_2d_pallas = TR.fan_2d_pallas
    monkeypatch.setattr(TR, "fan_2d_pallas", spy)
    TR.reset_counters()
    new = _synthesis("pallas", mode=mode, geometry=geometry)
    assert TR.PLAIN_CALLS == {"fan_2d": 1, "fan_tables": 1} and not wrapped
    monkeypatch.setattr(TR, "_transformed", lambda *ts: True)
    TR.reset_counters()
    old = _synthesis("pallas", mode=mode, geometry=geometry)
    assert TR.PLAIN_CALLS == {"fan_2d": 1, "fan_tables": 1}
    assert wrapped == [1]
    monkeypatch.undo()
    assert set(new) == set(old)
    for k in old:
        assert torch.equal(_bits(new[k]), _bits(old[k])), k
    assert torch.isfinite(new["fan_range_km"]).any()
    TR.reset_counters()
    _synthesis("auto", mode=mode, geometry=geometry)
    assert sum(TR.PLAIN_CALLS.values()) == sum(TR.LAUNCHES.values()) == 0


def test_fan_route_under_vmap_and_derivatives():
    """Under ``torch.func.vmap`` the 2-D fan keeps the route through the
    [F, nz, nx] fields and ``fan_2d_pallas``: one folded call over both
    slices (``_FanKernel``), bit for bit the separate calls, its table
    build counted once in ``PLAIN_CALLS["fan_tables"]``; an input that
    requires grad raises ``fan_2d_pallas``' error before any table is
    built."""
    from pyrayhf_tpu_torch.oblique import _fan_2d_fn
    z, x, t = _slice_tensors()
    fan = _fan_2d_fn(z, x, "O", "cartesian", 8, 120, 1, engine="pallas")
    lims = torch.tensor([8.0, 60.0], dtype=torch.float64)

    def run(ne):
        return fan(t[0], lims, ne, t[2], t[3], t[4], 10.0)[0]

    stack = torch.stack([t[1], 0.9 * t[1]])
    TR.reset_counters()
    out = torch.func.vmap(run)(stack)
    assert TR.PLAIN_CALLS == {"fan_2d": 1, "fan_tables": 1}
    for v in range(2):
        assert torch.equal(_bits(out[v]), _bits(run(stack[v])))
    assert torch.isfinite(out).any()
    TR.reset_counters()
    with pytest.raises(ValueError, match="no backward"):
        run(t[1].clone().requires_grad_(True))
    assert TR.PLAIN_CALLS == {"fan_2d": 0, "fan_tables": 0}
