"""Where the port's entry points put host data.

Host array-likes (numpy arrays, lists, Python numbers) go to the CUDA card
unless the caller asks for the CPU with ``device="cpu"``; tensors keep
their device. Without a card, and without that request, an entry point
raises with a message naming ``device="cpu"``: it never carries on
quietly on the CPU. These tests hide any card (``torch.cuda.is_available``
returns False), so they run the same everywhere.
"""

import numpy as np
import pytest
import torch

import pyrayhf_tpu_torch as prt
from pyrayhf_tpu_torch import io as TIO
from pyrayhf_tpu_torch import parallel as TP

from _torch_threads import one_torch_thread  # noqa: F401


def _profile(B=None):
    alt = np.linspace(90.0, 550.0, 120)
    den = 2e12 * np.exp(-((alt - 300.0) / 55.0) ** 2)
    if B:
        den = np.stack([den * (1.0 + 0.1 * b) for b in range(B)])
    return (np.arange(2.0, 12.0, 1.0), den, np.full_like(den, 3.2e-5),
            np.full_like(den, 65.0), alt)


def _slice():
    z = np.linspace(0.0, 400.0, 41)
    x = np.linspace(0.0, 2000.0, 9)
    h = (z[:, None] - 250.0) / 45.0
    ne = 8e11 * np.exp(0.5 * (1.0 - h - np.exp(-h))) * np.ones((1, 9))
    return dict(f0s_hz=[6e6], ground_range_km=800.0, x_grid_km=x,
                z_grid_km=z, Ne2d=ne, Babs2d=np.full(ne.shape, 4.5e-5),
                bpsi2d=np.full(ne.shape, 30.0), n_elev=6, step_km=20.0,
                s_max_km=400.0)


def _gradient_ray(**kw):
    z = np.linspace(0.0, 400.0, 41)
    x = np.linspace(0.0, 2000.0, 9)
    mu = np.sqrt(np.clip(1.0 - 0.8 * np.exp(-((z[:, None] - 250.0) / 45.0)
                                            ** 2), 0.0, None)) * np.ones(9)
    nag = prt.build_refractive_index_interpolator_cartesian(z, x, mu, **kw)
    mupf = prt.build_mup_function(1.0 / mu, x, z, **kw)
    return prt.trace_ray_cartesian_gradient(
        nag, mupf, 0.0, 0.0, 40.0, 600.0, step_km=20.0, rtol=1e-6,
        max_step_km=20.0, z_max_km=400.0)["group_path_km"]


def _link(**kw):
    freqs, den, bmag, bpsi, alt = _profile()
    return dict(f0s_hz=[5e6, 8e6], ground_range_km=600.0, alt_km=alt,
                Ne=den, Babs=bmag, bpsi=bpsi, n_elev=16, **kw)


def _volume():
    alt = np.linspace(60.0, 400.0, 18)
    lat = np.linspace(30.0, 40.0, 4)
    lon = np.linspace(-5.0, 5.0, 4)
    ne = 5e11 * np.exp(-((alt - 250.0) / 60.0) ** 2)[:, None, None] \
        * np.ones((1, 4, 4))
    return alt, lat, lon, ne


def _field_3d(**kw):
    alt, lat, lon, ne = _volume()
    return prt.build_field_3d(alt, lat, lon, ne, np.full(ne.shape, 4.5e-5),
                              np.full(ne.shape, 30.0), 6e6, **kw)


def _field_aniso(**kw):
    alt, lat, lon, ne = _volume()
    return prt.build_field_3d_aniso(alt, lat, lon, ne, 2e-5, 1e-6, 4e-5,
                                    **kw)


FAN_3D = dict(n_elev=4, n_az=3, step_km=50.0, s_max_km=600.0)
LINK_3D = (38.0, 0.0, 33.0, 0.0)

ENTRY_POINTS = {
    "vertical_forward_operator": lambda **kw: prt.vertical_forward_operator(
        *_profile(), **kw),
    "vertical_forward_operator_batch":
        lambda **kw: prt.vertical_forward_operator_batch(*_profile(2), **kw),
    "vertical_phase_operator": lambda **kw: prt.vertical_phase_operator(
        *_profile(), **kw),
    "vh_and_mask": lambda **kw: prt.vh_and_mask(*_profile(), **kw)[0],
    "ionogram_pallas": lambda **kw: prt.ionogram_pallas(
        *_profile(2), mode_mult=1.0, **kw),
    "ionogram_pallas_gather": lambda **kw: prt.ionogram_pallas_gather(
        *_profile(2), mode_mult=-1.0, **kw),
    "ionogram_fast_xla": lambda **kw: prt.ionogram_fast_xla(
        *_profile(2), **kw),
    "profiles_to_torch": lambda **kw: TIO.profiles_to_torch(
        dict(zip(("den", "bmag", "bpsi", "alt"), _profile()[1:])),
        **kw)["den"],
    "vertical_absorption_operator":
        lambda **kw: prt.vertical_absorption_operator(*_profile(), **kw),
    "collision_frequency": lambda **kw: prt.collision_frequency(
        [70.0, 90.0], **kw),
    "ground_reflection_loss_db": lambda **kw: prt.ground_reflection_loss_db(
        [5e6, 9e6], [10.0, 30.0], **kw),
    "synthesize_oblique_ionogram_2d":
        lambda **kw: prt.synthesize_oblique_ionogram_2d(
            **_slice(), **kw)["fan_range_km"],
    "synthesize_oblique_ionogram":
        lambda **kw: prt.synthesize_oblique_ionogram(
            **_link(**kw))["delay_low_sec"],
    "trace_rays_spherical_snells":
        lambda **kw: prt.trace_rays_spherical_snells(
            [6e6], [20.0, 40.0], *_profile()[4:], *_profile()[1:4],
            **kw)["group_path_km"],
    "trace_ray_cartesian_snells":
        lambda **kw: prt.trace_ray_cartesian_snells(
            6e6, 30.0, *_profile()[4:], *_profile()[1:4], "X",
            **kw)["ground_range_km"],
    "trace_ray_cartesian_gradient": _gradient_ray,
    "muf_from_profile": lambda **kw: prt.muf_from_profile(
        [800.0, 1600.0], *_profile()[1:], **kw),
    "muf_map": lambda **kw: prt.muf_map(1000.0, *_profile(2)[1:], **kw),
    "vertical_to_oblique": lambda **kw: prt.vertical_to_oblique(
        [3.0, 5.0], [250.0, 300.0], 1200.0, **kw)[0],
    "faraday_rotation_vertical": lambda **kw: prt.faraday_rotation_vertical(
        [30e6, 60e6], *_profile()[1:], **kw),
    "doppler_shift_vertical": lambda **kw: prt.doppler_shift_vertical(
        [3.0, 5.0], _profile()[1], 1e-3 * _profile()[1], *_profile()[2:],
        **kw)["doppler_hz"],
    "phase_height_and_mask": lambda **kw: prt.phase_height_and_mask(
        *_profile(), **kw)[0],
    "retrieve_from_oblique": lambda **kw: prt.retrieve_from_oblique(
        {"Nm": 2e12, "hm": 300.0, "B_bot": 40.0, "B_top": 60.0}, {"P": 0.0},
        {"Nm": 5e10, "hm": 110.0, "B_bot": 5.0, "B_top": 7.0}, [6e6, 9e6],
        [3.2e-3, 3.4e-3], 700.0, *_profile()[4:], *_profile()[2:4],
        n_elev=8, steps=1, brute_init=False, **kw)[0],
    "great_circle_point": lambda **kw: prt.great_circle_point(
        40.0, -100.0, [500.0, 900.0], 63.0, **kw)[0],
    "calculate_gcd": lambda **kw: prt.calculate_gcd(10.0, 45.0, 30.0, 50.0,
                                                    **kw),
    "find_turning_point": lambda **kw: prt.find_turning_point(
        [0.0, 100.0, 200.0], [1.0, 0.8, 0.4], 0.6, **kw),
    "calculate_magnetic_field": lambda **kw: prt.calculate_magnetic_field(
        2020, 6, 15, [30.0, 40.0], [0.0, 10.0], [100.0, 300.0], **kw)[0],
    "igrf_field": lambda **kw: prt.igrf.igrf_field(
        [30.0, 40.0], 10.0, 300.0, geodetic=True, **kw)[3],
    "climatology_parameters": lambda **kw: prt.envgen.climatology_parameters(
        2020, 6, 15, 12.0, [30.0, -20.0], [0.0, 100.0], 150.0,
        **kw)[0]["fo"],
    "find_mean_gradient_error": lambda **kw: prt.find_mean_gradient_error(
        -77.0, 38.0, -70.0, 30.0, 2020, 6, 15, 17.0, 140.0, nelem=5,
        **kw)[0],
    "eval_ccir_map": lambda **kw: prt.ccir.eval_ccir_map(
        np.ones((2, 49, 9)), 20.0, 30.0, 40.0, 9.0, 50.0, **kw),
    "trilinear": lambda **kw: prt.trace3d.trilinear(
        [100.0, 200.0], 35.0, 0.0, *_volume(), **kw),
    "build_field_3d": lambda **kw: _field_3d(**kw)["dmu_dalt"],
    "build_field_3d_batch": lambda **kw: prt.trace3d.build_field_3d_batch(
        *_volume(), 4.5e-5, 30.0, [5e6, 6e6], **kw)["mu"],
    "trace_ray_3d": lambda **kw: prt.trace_ray_3d(
        _field_3d(**kw), 35.0, 0.0, 30.0, 10.0, step_km=50.0,
        s_max_km=600.0)["group_path_km"],
    "trace_rays_3d": lambda **kw: prt.trace_rays_3d(
        _field_3d(**kw), 35.0, 0.0, [20.0, 40.0], [0.0, 90.0], step_km=50.0,
        s_max_km=600.0)["ground_range_km"],
    "home_ray_3d": lambda **kw: prt.home_ray_3d(
        _field_3d(**kw), *LINK_3D, **FAN_3D)["delay_low_sec"],
    "synthesize_oblique_ionogram_3d":
        lambda **kw: prt.synthesize_oblique_ionogram_3d(
            [5e6, 7e6], *LINK_3D, *_volume(), 4.5e-5, 30.0, **FAN_3D,
            **kw)["delay_low_sec"],
    "igrf_volume": lambda **kw: prt.igrf_volume(*_volume()[:3], **kw)[0],
    "build_field_3d_aniso": lambda **kw: _field_aniso(**kw)["tables"][3],
    "trace_ray_3d_anisotropic": lambda **kw: prt.trace_ray_3d_anisotropic(
        _field_aniso(**kw), 35.0, 0.0, 30.0, 0.0, 6e6, step_km=50.0,
        s_max_km=300.0)["group_delay_sec"],
    "trace_rays_3d_anisotropic": lambda **kw: prt.trace_rays_3d_anisotropic(
        _field_aniso(**kw), 35.0, 0.0, [20.0, 40.0], [0.0], 6e6,
        step_km=50.0, s_max_km=300.0)["group_delay_sec"],
    "home_ray_3d_anisotropic": lambda **kw: prt.home_ray_3d_anisotropic(
        _field_aniso(**kw), *LINK_3D, 6e6, **FAN_3D)["delay_low_sec"],
    "synthesize_oblique_ionogram_3d_anisotropic":
        lambda **kw: prt.synthesize_oblique_ionogram_3d_anisotropic(
            [5e6, 7e6], *LINK_3D, _field_aniso(**kw),
            **FAN_3D)["delay_low_sec"],
}

# the input generators return the JAX functions' dicts of numpy arrays;
# they compute where the caller asks
GENERATORS = {
    "generate_input_1D": lambda **kw: prt.generate_input_1D(
        2020, 6, 15, 17.0, 38.0, -77.0, [100.0, 300.0], 140.0, **kw)["den"],
    "generate_input_2D": lambda **kw: prt.generate_input_2D(
        2020, 6, 15, 17.0, 38.0, -77.0, 200.0, [100.0, 300.0], 600.0, 30.0,
        140.0, **kw)["den"],
    "generate_input_3D": lambda **kw: prt.generate_input_3D(
        2020, 6, 15, 17.0, [30.0, 40.0], [0.0, 5.0, 10.0], [100.0, 300.0],
        140.0, **kw)["den"],
}


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_host_data_without_a_card_raises(no_card, name):
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ENTRY_POINTS[name]()


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_host_data_goes_where_the_caller_asks(no_card, name):
    out = ENTRY_POINTS[name](device="cpu")
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    assert out.dtype == torch.float64


@pytest.mark.parametrize("name", list(GENERATORS))
def test_generators_compute_where_the_caller_asks(no_card, name):
    with pytest.raises(RuntimeError, match='device="cpu"'):
        GENERATORS[name]()
    out = GENERATORS[name](device="cpu")
    assert isinstance(out, np.ndarray) and np.isfinite(out).all()


def test_tensors_keep_their_device(no_card):
    """CPU tensors need no request; an explicit device that contradicts
    them raises instead of moving them."""
    t = [torch.from_numpy(np.asarray(a)) for a in _profile()]
    assert prt.vertical_forward_operator(*t).device.type == "cpu"
    with pytest.raises(ValueError, match="tensor inputs lie"):
        prt.vertical_forward_operator(*t, device="cuda")
    # a tensor among host arrays decides where the host arrays go
    freqs, den, bmag, bpsi, alt = _profile(2)
    vh = prt.vertical_forward_operator_batch(freqs, den, bmag, bpsi,
                                             torch.from_numpy(alt))
    assert vh.device.type == "cpu"
    # a 3-D field built from CPU tensors traces on the CPU
    alt, lat, lon, ne = _volume()
    fld = prt.build_field_3d(alt, lat, lon, torch.from_numpy(ne), 4.5e-5,
                             30.0, 6e6)
    assert fld["mu"].device.type == "cpu"
    ray = prt.trace_rays_3d(fld, 35.0, 0.0, [30.0], [0.0], step_km=50.0,
                            s_max_km=600.0)
    assert ray["group_path_km"].device.type == "cpu"


# the sharded entry points take the mesh as their device: host data goes to
# the mesh's devices, and a mesh of CPU devices computes on the CPU
def _mesh_lm(mesh):
    freqs, den, bmag, bpsi, alt = _profile(2)
    return TP.retrieve_gradient_batch_sharded(
        {"Nm": 2.2e12, "hm": 300.0, "B_bot": 50.0, "B_top": 40.0}, {"P": 0.0},
        {"Nm": 5e10, "hm": 110.0, "B_bot": 5.0, "B_top": 7.0}, freqs,
        prt.vertical_forward_operator_batch(*_profile(2), device="cpu"),
        alt, bmag[0], bpsi[0], mesh, steps=1, n_points=50)[0]


MESH_ENTRY_POINTS = {
    "synthesize_ionograms_sharded xla":
        lambda mesh: TP.synthesize_ionograms_sharded(*_profile(8), mesh,
                                                     n_points=50),
    "synthesize_ionograms_sharded pallas":
        lambda mesh: TP.synthesize_ionograms_sharded(
            *_profile(8), mesh, n_points=50, engine="pallas"),
    "vh_height_sharded": lambda mesh: TP.vh_height_sharded(
        *_profile(), mesh, n_points=64),
    "retrieval_step_sharded": lambda mesh: TP.retrieval_step_sharded(
        {"hm": [300.0, 310.0], "bb": [50.0, 45.0], "nm": [2e12, 2.1e12]},
        np.full((2, 10), 250.0), _profile()[0],
        {"alt": _profile()[4], "bmag": _profile()[2], "bpsi": _profile()[3],
         "E": {"Nm": 5e10, "hm": 110.0, "B_bot": 5.0, "B_top": 7.0},
         "B_top": 40.0}, mesh)[1],
    "retrieve_gradient_batch_sharded": _mesh_lm,
    "trace_fan_3d_sharded": lambda mesh: TP.trace_fan_3d_sharded(
        _field_3d(device="cpu"), 35.0, 0.0, [20.0, 40.0], [0.0],
        mesh, step_km=50.0, s_max_km=600.0)["ground_range_km"],
    "trace_fan_3d_aniso_sharded": lambda mesh: TP.trace_fan_3d_aniso_sharded(
        _field_aniso(device="cpu"), 35.0, 0.0, [20.0, 40.0], [0.0], 6e6,
        mesh, step_km=50.0, s_max_km=300.0)["group_delay_sec"],
    "doppler_batch_sharded": lambda mesh: TP.doppler_batch_sharded(
        *_profile(2)[:2], 1e-3 * _profile(2)[1], *_profile(2)[2:], mesh,
        n_points=50)["doppler_hz"],
}


def test_mesh_without_a_card_raises(no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TP.ionogram_mesh()
    mesh = TP.ionogram_mesh([torch.device("cpu")] * 8, batch_axis=4)
    assert all(d.type == "cpu" for d in mesh.devices.ravel())


@pytest.mark.parametrize("name", list(MESH_ENTRY_POINTS))
def test_host_data_goes_to_the_mesh(no_card, name):
    mesh = TP.ionogram_mesh([torch.device("cpu")] * 2)
    out = MESH_ENTRY_POINTS[name](mesh)
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    assert out.dtype == torch.float64


def test_fan_availability_takes_the_jax_signature():
    """``fan_2d_pallas_available(z_np, x_np, n_elev)``, as the JAX package
    calls it: ``n_elev`` is accepted and unused (the card has no VMEM
    gate), so only uniform grids decide, on host grids and tensors."""
    from pyrayhf_tpu_torch.pallas_ray import fan_2d_pallas_available

    z, x = np.linspace(0.0, 620.0, 621), np.linspace(0.0, 3995.0, 800)
    for n_elev in (1, 128, 4096):
        assert fan_2d_pallas_available(z, x, n_elev)
        assert fan_2d_pallas_available(torch.from_numpy(z), x, n_elev)
    z_nu = z.copy()
    z_nu[5] += 0.3
    assert not fan_2d_pallas_available(z_nu, x, 128)
    with pytest.raises(TypeError):
        fan_2d_pallas_available(z, x)
