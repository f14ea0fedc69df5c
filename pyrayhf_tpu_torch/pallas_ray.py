"""2-D gradient-ray fan kernel for Hopper: host prep, plain version, wrapper.

Port of ``pyrayhf_tpu.pallas_ray``. The TPU kernel (``_fan_kernel``)
integrates a whole [F, E] (frequency × elevation) fan of gradient-ODE rays
with fixed-step RK4 inside one Pallas program, its field tables resident
in VMEM. Here it is ``csrc/fan2d.cu``: one CUDA thread per ray, blocks of
``_BLOCK`` rays of one frequency, the tables node-major in device memory
(one (μ, ∂μ/∂c0, ∂μ/∂c1, μ') record per node, then a κ plane); where one
frequency's (μ, ∂μ/∂c0, ∂μ/∂c1) fit in shared memory, each block stages
them there (:func:`fan_path`).

* :func:`pack_tables` builds those tables from the [F, nz, nx] fields, the
  gradients taken on the uniform axes rebuilt from origin and spacing, as
  the JAX host side does;
* :func:`fan_tables` builds them straight from the slice (Ne, |B|, ψ, ν):
  on CUDA tensors ``csrc/fan_tables.cu`` (:func:`launch_fan_tables`)
  writes them with no [F, nz, nx] field in device memory, on CPU tensors
  :func:`pack_tables` of the oblique fields;
* :func:`plain_fan` is the kernel's plain PyTorch version: the batched
  fixed-step fan of :mod:`.gradient` over the same packed tables;
* :func:`launch_fan` launches the kernel, :func:`run_fan` runs it (or
  its plain version on CPU tensors) on packed tables;
* :func:`fan_2d_pallas` (the JAX signature) runs the kernel on CUDA
  tensors and the plain version on CPU tensors, and raises otherwise;
* :func:`fan_from_slice` runs it from the slice: :func:`fan_tables` then
  :func:`run_fan`, or under ``torch.func`` the fields through
  :func:`fan_2d_pallas`.

``LAUNCHES`` and ``PLAIN_CALLS`` count kernel launches and plain calls.
The kernel has no backward (the TPU kernel had no autodiff rule either):
inputs that require grad or carry a tangent raise; ``engine="xla"`` of the
oblique fan is differentiable through autograd. ``torch.func.vmap`` over
stacks of fields folds into one launch, as ``pallas_call``'s batching
rule batches the TPU kernel. Unlike the TPU engine, no table-size
gate applies: a table set that does not fit the card's memory raises the
allocator's ``torch.cuda.OutOfMemoryError``.
"""

import ctypes
import dataclasses
import math

import numpy as np
import torch

from . import cuda_ext
from ._util import host_f64, host_float
from .constants import R_E
from .fields import RefractiveField, _mup_function, gradient_ord2, \
    uniform_axis
from .profiling import span

__all__ = ["fan_2d_pallas", "fan_2d_pallas_available", "plain_fan",
           "launch_fan", "run_fan", "pack_tables", "fan_tables",
           "launch_fan_tables", "fan_from_slice", "table_views", "fan_path", "fan_geometry",
           "OUTPUTS", "LAUNCHES", "PLAIN_CALLS", "reset_counters"]

# "fan_tables" (csrc/fan_tables.cu) writes the fan kernel's tables from
# the slice on the card; its plain version is pack_tables of the fields
KERNELS = ("fan_2d", "fan_tables")
LAUNCHES = dict.fromkeys(KERNELS, 0)
PLAIN_CALLS = dict.fromkeys(KERNELS, 0)

# the kernel's output rows, in order; ``steps_taken`` (port only) counts
# the steps each ray integrated before it froze
OUTPUTS = ("ground_range_km", "group_delay_sec", "absorption_db",
           "group_path_km", "phase_path_km", "status_code", "x_final_km",
           "z_final_km", "steps_taken")
_CHANNELS = 5                    # μ, ∂μ/∂c0, ∂μ/∂c1, μ', κ
_RECORD = 4                      # μ, ∂μ/∂c0, ∂μ/∂c1, μ' per node
_BLOCK = 64                      # rays (threads) per block, csrc kBlock


def reset_counters():
    """Set every launch and plain-call count to 0."""
    for k in KERNELS:
        LAUNCHES[k] = 0
        PLAIN_CALLS[k] = 0


@dataclasses.dataclass(frozen=True)
class FanGeometry:
    """Host-side description of a uniform fan domain (all float64).

    Native field coordinates c0/c1 are (z, x) [km] for ``cartesian`` and
    (r, φ) = (R_E + z, x/R_E) for ``spherical``; ``o``/``inv_d`` give the
    direct cell locate, ``lo``/``hi`` the domain test. The four event
    offsets are those of the gradient cores: ground, top, low and high
    bound in the state's own coordinates.
    """
    geometry: str
    z: np.ndarray
    x: np.ndarray
    nz: int
    nx: int
    o0: float
    inv_d0: float
    o1: float
    inv_d1: float
    c0_lo: float
    c0_hi: float
    c1_lo: float
    c1_hi: float
    ground: float        # z_ground, or R_E + z_ground
    top: float           # z_max, or R_E + z_max
    lo: float            # x_min, or x_min / R_E
    hi: float            # x_max, or x_max / R_E
    re: float


def fan_2d_pallas_available(z_np, x_np, n_elev):
    """True when the kernel can run this geometry: uniform z and x grids
    (the locate is index arithmetic). ``n_elev`` is the JAX signature's
    and unused: the card has no VMEM budget to check, so no table-size
    gate applies."""
    return uniform_axis(host_f64(z_np)) and uniform_axis(host_f64(x_np))


def fan_geometry(z_np, x_np, geometry):
    """:class:`FanGeometry` of the grids; raises on non-uniform grids.

    Domain bounds follow the 2-D oblique fan: ground at z[0], top at
    z[-1], lateral bounds at x[0] and x[-1].
    """
    if geometry not in ("cartesian", "spherical"):
        raise ValueError("geometry must be 'cartesian' or 'spherical'")
    z64, x64 = host_f64(z_np), host_f64(x_np)
    if not fan_2d_pallas_available(z64, x64, None):
        raise ValueError("the fan kernel requires uniform z/x grids; use "
                         "engine='xla' for this geometry")
    re = float(R_E)
    if geometry == "cartesian":
        c0, c1 = z64, x64
        ev = (float(z64[0]), float(z64[-1]), float(x64[0]), float(x64[-1]))
    else:
        c0, c1 = re + z64, x64 / re
        ev = (re + float(z64[0]), re + float(z64[-1]), float(x64[0]) / re,
              float(x64[-1]) / re)
    nz, nx = len(z64), len(x64)
    return FanGeometry(
        geometry, z64, x64, nz, nx,
        float(c0[0]), float((nz - 1) / (c0[-1] - c0[0])),
        float(c1[0]), float((nx - 1) / (c1[-1] - c1[0])),
        float(c0[0]), float(c0[-1]), float(c1[0]), float(c1[-1]),
        *ev, re)


def pack_tables(geo, mu_f, mup_f, kappa_f):
    """[F, nz, nx] fields → the kernel's node-major tables, one flat tensor.

    The first F·nz·nx·4 elements are one record per node, [F, nz, nx, 4]:
    (μ, ∂μ/∂c0, ∂μ/∂c1, μ'), 16 bytes in f32; then κ, [F, nz, nx].
    :func:`table_views` gives the two parts. The gradient channels are
    ``gradient_ord2`` of μ on the uniform native axes rebuilt as
    o + i/inv_d in the working dtype, as the JAX host side builds them.
    """
    with span("pyrayhf.fan_pack"):
        kw = dict(dtype=mu_f.dtype, device=mu_f.device)
        c0_ax = (torch.tensor(geo.o0, **kw) + torch.arange(geo.nz, **kw)
                 / torch.tensor(geo.inv_d0, **kw))
        c1_ax = (torch.tensor(geo.o1, **kw) + torch.arange(geo.nx, **kw)
                 / torch.tensor(geo.inv_d1, **kw))
        g0, g1 = gradient_ord2(mu_f, c0_ax, c1_ax)
        tab = torch.empty(_CHANNELS * mu_f.numel(), **kw)
        rec, kap = table_views(geo, tab)
        torch.stack([mu_f, g0, g1, mup_f], dim=-1, out=rec)
        kap.copy_(kappa_f)
        return tab


def fan_tables(geo, f0s, Ne2d, Babs2d, bpsi2d, nu_z, mode):
    """The kernel's tables straight from the slice: ``pack_tables(geo,
    *oblique._fan_fields(f0s, Ne2d, Babs2d, bpsi2d, nu_z, mode))``.

    ``f0s`` [F] (Hz), ``Ne2d``, ``Babs2d``, ``bpsi2d`` [nz, nx] (ψ in
    degrees) and ``nu_z`` [nz] of one dtype and device. CUDA tensors take
    :func:`launch_fan_tables` (the same tensor bit for bit), CPU tensors
    that composition, counted in ``PLAIN_CALLS["fan_tables"]``.
    """
    if Ne2d.device.type == "cuda":
        return launch_fan_tables(geo, f0s, Ne2d, Babs2d, bpsi2d, nu_z, mode)
    from .oblique import _fan_fields
    PLAIN_CALLS["fan_tables"] += 1
    return pack_tables(geo, *_fan_fields(f0s, Ne2d, Babs2d, bpsi2d, nu_z,
                                         mode))


def _fan_table_scalars(geo):
    """The 13 doubles of ``csrc/fan_tables.cu``'s C entry: the axes, then
    the constants as ``magnetoionic`` and ``absorption_coefficient`` form
    them in Python before a tensor sees them, then ``find_mu_mup``'s
    y_tol."""
    from .absorption import _DB_PER_NP
    from .constants import C_KM_S, CP, G_P
    from .magnetoionic import find_mu_mup
    y_tol = find_mu_mup.__kwdefaults__["y_tol"]
    return (ctypes.c_double * 13)(
        geo.o0, geo.inv_d0, geo.o1, geo.inv_d1, CP, G_P, math.pi / 180.0,
        2.0 * math.pi, (2.0 * math.pi * CP) ** 2, 2.0 * math.pi * G_P,
        2.0 * (C_KM_S * 1e3), _DB_PER_NP, y_tol)


def launch_fan_tables(geo, f0s, Ne2d, Babs2d, bpsi2d, nu_z, mode):
    """Launch ``csrc/fan_tables.cu``: :func:`fan_tables`' tensor in one
    pass on the card, after a flag kernel that decides the unmagnetised
    branch over every (frequency, node) as ``find_mu_mup`` does.

    Checks device, dtype and shapes (the kernel reads raw pointers, so no
    ``torch.func`` transform and no derivative either), launches on the
    current stream and raises on any CUDA error the launch reports. The
    allocation is the ``pyrayhf.fan_pack`` span, the launch the
    ``pyrayhf.fan_fields`` span.
    """
    from .magnetoionic import mode_multiplier

    x_mode = mode_multiplier(mode) < 0
    ins = (f0s, Ne2d, Babs2d, bpsi2d, nu_z)
    dtype, dev = Ne2d.dtype, Ne2d.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"unsupported dtype {dtype}")
    if any(t.dtype != dtype or t.device != dev for t in ins):
        raise ValueError("the slice, ν and the frequencies must share dtype "
                         "and device")
    if _transformed(*ins):
        raise ValueError("the table kernel has no derivative and no "
                         "batching rule; use oblique._fan_fields and "
                         "pack_tables under transforms")
    shape = (geo.nz, geo.nx)
    if (any(t.shape != shape for t in (Ne2d, Babs2d, bpsi2d))
            or nu_z.shape != (geo.nz,) or f0s.dim() != 1
            or f0s.numel() == 0 or geo.nz < 2 or geo.nx < 2):
        raise ValueError(f"bad fan inputs for a {geo.nz}x{geo.nx} grid: "
                         f"{[tuple(t.shape) for t in ins]}")
    f0s, Ne2d, Babs2d, bpsi2d, nu_z = (t.contiguous() for t in ins)
    F = f0s.numel()
    with span("pyrayhf.fan_pack"):
        tab = torch.empty(_CHANNELS * F * geo.nz * geo.nx, dtype=dtype,
                          device=dev)
    with span("pyrayhf.fan_fields"):
        flag = torch.empty(1, dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = cuda_ext.load().pyrayhf_fan_tables(
                0 if dtype == torch.float32 else 1, int(x_mode),
                Ne2d.data_ptr(), Babs2d.data_ptr(), bpsi2d.data_ptr(),
                nu_z.data_ptr(), f0s.data_ptr(), F, geo.nz, geo.nx,
                _fan_table_scalars(geo), flag.data_ptr(), tab.data_ptr(),
                stream)
    if err != 0:
        raise RuntimeError(f"fan table kernel launch failed: "
                           f"{cuda_ext.error_string(err)} ({err})")
    LAUNCHES["fan_tables"] += 1
    return tab


def table_views(geo, tab):
    """The two parts of :func:`pack_tables`' tensor, as views: the records
    [F, nz, nx, 4] (μ, ∂μ/∂c0, ∂μ/∂c1, μ' along the last axis) and κ
    [F, nz, nx]."""
    plane = geo.nz * geo.nx
    if (tab.dim() != 1 or tab.numel() == 0
            or tab.numel() % (_CHANNELS * plane)):
        raise ValueError(f"tables must be 1-D with a multiple of "
                         f"{_CHANNELS}·{geo.nz}·{geo.nx} elements, got "
                         f"{tuple(tab.shape)}")
    F = tab.numel() // (_CHANNELS * plane)
    n_rec = F * plane * _RECORD
    return (tab[:n_rec].view(F, geo.nz, geo.nx, _RECORD),
            tab[n_rec:].view(F, geo.nz, geo.nx))


def fan_path(geo, dtype):
    """The kernel's path for these tables: ``"shared"`` where one
    frequency's (μ, ∂μ/∂c0, ∂μ/∂c1) fit in a block's shared memory (each
    block stages them there, in rows of an odd stride nx | 1), else
    ``"global"`` (read from the records)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return ("shared" if 3 * geo.nz * (geo.nx | 1) * itemsize
            <= cuda_ext.MAX_SMEM_BYTES else "global")


def plain_fan(geo, tab, elevs, ds, *, n_steps, n_hops=1, x0=0.0, z0=None,
              paths=False):
    """The kernel's plain PyTorch version on the packed tables.

    The batched fixed-step fan of :mod:`.gradient` (its integrator and
    metrics), with fields read from the channels of ``tab`` (see
    :func:`pack_tables`) through the uniform locate. ``elevs`` [E] deg,
    ``ds`` a 0-d tensor (km). Returns
    the dict of :data:`OUTPUTS`, each [F, E], on any device; with
    ``paths`` also ``c0_path`` and ``c1_path`` [F, E, n_steps + 1], the
    rays' step points in the tables' native coordinates.
    """
    from .gradient import _cart_gradient_core, _sph_gradient_core
    PLAIN_CALLS["fan_2d"] += 1
    z0 = float(geo.z[0]) if z0 is None else float(z0)
    rec, kap = table_views(geo, tab)
    F, E = rec.shape[0], elevs.shape[0]
    # each channel copied out of the records once, so that the per-step
    # gathers read contiguous planes
    ch = [rec[..., c].contiguous() for c in range(_RECORD)]

    def field(f, grads=None):
        return RefractiveField(geo.z, geo.x, f, geometry=geo.geometry,
                               grads=grads)

    mu = field(ch[0], grads=(ch[1], ch[2]))
    mupf = _mup_function(field(ch[3]))
    kapf = _mup_function(field(kap))
    el = elevs.expand(F, E)
    x0 = float(x0)
    if geo.geometry == "cartesian":
        def nag(x, z):
            n, dndz, dndx = mu.value_and_grad(z, x)
            return n, dndx, dndz
        nag.field = mu
        out = _cart_gradient_core(nag, mupf, x0, z0, el, ds, n_steps,
                                  geo.ground, geo.top, geo.lo, geo.hi,
                                  n_hops=n_hops, kappa_func=kapf)
        x_fin, z_fin = out["x"][..., -1], out["z"][..., -1]
        c0, c1 = out["z"], out["x"]
    else:
        def nag(phi, r):
            return mu.value_and_grad(r, phi)
        nag.field = mu
        out = _sph_gradient_core(nag, mupf, x0, z0, el, ds, n_steps, geo.re,
                                 float(geo.z[0]), geo.top, geo.lo, geo.hi,
                                 n_hops=n_hops, kappa_func=kapf)
        x_fin = geo.re * out["phi"][..., -1]
        z_fin = out["r"][..., -1] - geo.re
        c0, c1 = out["r"], out["phi"]
    dt = tab.dtype
    res = {"ground_range_km": out["ground_range_km"],
           "group_delay_sec": out["group_delay_sec"],
           "absorption_db": out["absorption_db"],
           "group_path_km": out["group_path_km"],
           "phase_path_km": out["phase_path_km"],
           "status_code": out["status_code"].to(dt),
           "x_final_km": x_fin, "z_final_km": z_fin,
           "steps_taken": out["alive"][..., :-1].sum(-1).to(dt)}
    if paths:
        res.update(c0_path=c0, c1_path=c1)
    return res


def launch_fan(geo, tab, elevs, ds, *, n_steps, n_hops=1, x0=0.0, z0=None):
    """Launch ``csrc/fan2d.cu`` on prepared tables; returns the output dict.

    Checks device, dtype, shape, contiguity and alignment, picks the path
    by table size (:func:`fan_path`), launches on the current stream and
    raises on any CUDA error the launch reports.
    """
    with span("pyrayhf.fan_launch"):
        from .gradient import _launch_direction

        dtype, dev = tab.dtype, tab.device
        if dev.type != "cuda":
            raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
        if dtype not in (torch.float32, torch.float64):
            raise TypeError(f"unsupported dtype {dtype}")
        F = table_views(geo, tab)[1].shape[0]
        E = elevs.shape[0]
        if not tab.is_contiguous() or tab.data_ptr() % 16:
            raise ValueError("tables must be contiguous and 16-byte aligned, "
                             "as pack_tables makes them")
        if (elevs.dtype != dtype or elevs.device != dev or elevs.dim() != 1
                or not elevs.is_contiguous()):
            raise ValueError("elevations must be a contiguous 1-D tensor in "
                             "the tables' dtype and device")
        if F == 0 or E == 0 or geo.nz < 2 or geo.nx < 2 or n_steps < 0:
            raise ValueError(f"degenerate launch F={F} E={E} nz={geo.nz} "
                             f"nx={geo.nx} n_steps={n_steps}")
        z0 = float(geo.z[0]) if z0 is None else float(z0)
        sph = geo.geometry == "spherical"
        # the launch state, formed as the plain version's cores form it: the
        # position in float64 on the host, the direction by the same torch ops
        a0, b0 = (geo.re + z0, float(x0) / geo.re) if sph else (float(x0), z0)
        va0, vb0 = (v.contiguous() for v in _launch_direction(elevs, sph))
        scalars = (ctypes.c_double * 16)(
            host_float(ds), a0, b0, geo.o0, geo.inv_d0, geo.o1, geo.inv_d1,
            geo.c0_lo, geo.c0_hi, geo.c1_lo, geo.c1_hi,
            geo.ground, geo.top, geo.lo, geo.hi, geo.re)
        out = torch.empty((len(OUTPUTS), F, E), dtype=dtype, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = cuda_ext.load().pyrayhf_fan2d(
                0 if dtype == torch.float32 else 1, int(sph),
                int(fan_path(geo, dtype) == "shared"),
                tab.data_ptr(), F, geo.nz, geo.nx, va0.data_ptr(),
                vb0.data_ptr(), E, int(n_steps), int(n_hops) - 1, scalars,
                out.data_ptr(), _BLOCK, stream)
        if err != 0:
            raise RuntimeError(f"fan kernel launch failed: "
                               f"{cuda_ext.error_string(err)} ({err})")
        LAUNCHES["fan_2d"] += 1
        return dict(zip(OUTPUTS, out.unbind(0)))


def _differentiated(t):
    """True when autograd, ``torch.autograd.forward_ad`` or a ``torch.func``
    derivative transform (grad, jvp and the jac* built on them) follows
    ``t``: the kernel reads raw pointers, so its result would carry no
    derivative (a zero tangent, silently). A ``vmap`` level alone does
    not: :class:`_FanKernel` has a batching rule."""
    if not isinstance(t, torch.Tensor):
        return False
    if t.requires_grad or (torch.autograd.forward_ad.unpack_dual(t).tangent
                           is not None):
        return True
    ft = torch._C._functorch
    while ft.is_functorch_wrapped_tensor(t):
        if not ft.is_batchedtensor(t):
            return True
        t = ft.get_unwrapped(t)
    return False


def _transformed(*ts):
    """True under a ``torch.func`` transform or where a derivative follows
    one of ``ts`` (:func:`_differentiated`): a kernel that reads raw
    pointers would drop it."""
    return (torch._C._are_functorch_transforms_active()
            or any(_differentiated(t) for t in ts))


def _refuse_derivatives(*ts):
    """Raise where a derivative follows one of ``ts``: the fan kernel has
    none (a ``vmap`` level alone passes)."""
    if any(_differentiated(t) for t in ts):
        raise ValueError("the fan kernel has no backward and no forward-"
                         "mode rule; use engine='xla' of the oblique fan "
                         "for derivatives")


def fan_2d_pallas(z_np, x_np, mu_f, mup_f, kappa_f, elevs, ds, *,
                  geometry="cartesian", n_steps, n_hops=1, x0=0.0,
                  z0=None, interpret=False):
    """Trace an [F, E] gradient-ODE ray fan with the fan kernel.

    ``z_np``/``x_np``: uniform host grids (km); ``mu_f``/``mup_f``/
    ``kappa_f``: [F, nz, nx] fields; ``elevs``: [E] launch elevations
    (deg); ``ds``: step (km). Returns a dict of [F, E] tensors (see
    :data:`OUTPUTS`). Runs the CUDA kernel on CUDA tensors and
    :func:`plain_fan` on CPU tensors (``interpret`` has no meaning for a
    CUDA kernel and raises there); any other device raises. Under
    ``torch.func.vmap`` (:class:`_FanKernel`) a stack of field sets runs as
    one launch over the folded frequency axis; derivatives raise.
    """
    dev = mu_f.device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"no fan kernel for device {dev}")
    if dev.type == "cuda" and interpret:
        raise ValueError("interpret=True has no meaning for a CUDA kernel; "
                         "pass CPU tensors to run the plain version")
    transformed = _transformed(mu_f, mup_f, kappa_f, elevs, ds)
    if transformed:
        _refuse_derivatives(mu_f, mup_f, kappa_f, elevs, ds)
    dtype = mu_f.dtype
    args = (fan_geometry(z_np, x_np, geometry),
            dict(n_steps=int(n_steps), n_hops=int(n_hops), x0=x0, z0=z0),
            mu_f, mup_f.to(dtype), kappa_f.to(dtype),
            torch.as_tensor(elevs).to(dtype=dtype, device=dev),
            torch.as_tensor(ds).to(dtype=dtype, device=dev))
    if transformed:
        return dict(zip(OUTPUTS, _FanKernel.apply(*args).unbind(0)))
    return _fan(*args)


def fan_from_slice(z_np, x_np, f0s, Ne2d, Babs2d, bpsi2d, nu_z, mode, elevs,
                   ds, *, geometry="cartesian", n_steps, n_hops=1, x0=0.0,
                   z0=None):
    """The [F, E] fan of one slice (``Ne2d``, ``Babs2d``, ``bpsi2d`` [nz,
    nx], ψ in degrees, ``nu_z`` [nz]) at the frequencies ``f0s`` [F], the
    grids and keywords as :func:`fan_2d_pallas`'s: :func:`fan_tables` then
    :func:`run_fan`, so no [F, nz, nx] field reaches device memory on CUDA
    tensors. Under a ``torch.func`` transform (:func:`_transformed`)
    derivatives raise before any field is built, and ``vmap`` takes
    ``oblique._fan_fields`` through :func:`fan_2d_pallas`'s fold: the plain
    table build on any device, counted in ``PLAIN_CALLS["fan_tables"]``.
    """
    from .oblique import _fan_fields
    ins = (f0s, Ne2d, Babs2d, bpsi2d, nu_z, elevs, ds)
    kw = dict(n_steps=n_steps, n_hops=n_hops, x0=x0, z0=z0)
    if _transformed(*ins):
        _refuse_derivatives(*ins)
        PLAIN_CALLS["fan_tables"] += 1
        return fan_2d_pallas(z_np, x_np, *_fan_fields(
            f0s, Ne2d, Babs2d, bpsi2d, nu_z, mode), elevs, ds,
            geometry=geometry, **kw)
    geo = fan_geometry(z_np, x_np, geometry)
    return run_fan(geo, fan_tables(geo, f0s, Ne2d, Babs2d, bpsi2d, nu_z,
                                   mode), elevs, ds, **kw)


def _fan(geo, kw, mu_f, mup_f, kappa_f, elevs, ds):
    """Pack the tables and run the fan on them (:func:`run_fan`)."""
    return run_fan(geo, pack_tables(geo, mu_f, mup_f, kappa_f), elevs, ds,
                   **kw)


def run_fan(geo, tab, elevs, ds, **kw):
    """The fan on packed tables: the kernel on CUDA tensors, its plain
    version on CPU tensors (there the ``pyrayhf.fan_launch`` span holds
    it). ``kw``: :func:`launch_fan`'s keywords."""
    elevs = elevs.contiguous()
    if tab.device.type == "cuda":
        return launch_fan(geo, tab, elevs, ds, **kw)
    with span("pyrayhf.fan_launch"):
        return plain_fan(geo, tab, elevs, ds, **kw)


class _FanKernel(torch.autograd.Function):
    """:func:`fan_2d_pallas` under ``torch.func.vmap``: the output rows
    [len(OUTPUTS), F, E] of one kernel launch (its plain version on CPU
    tensors), with a batching rule and no derivative, as the JAX kernel is
    batched by ``pallas_call``'s rule and has no derivative either."""

    @staticmethod
    def forward(*args):
        out = _fan(*args)
        return torch.stack([out[k] for k in OUTPUTS])

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, geo, kw, *xs):
        """With only the fields batched, the mapped dim folds into the
        frequency axis (each ray is independent, the kernel's path depends
        on one frequency's table): ONE launch over [V·F, E]. A batched
        ``elevs`` or ``ds`` runs one launch per slice."""
        V = info.batch_size
        dims = in_dims[2:]
        if dims[3] is None and dims[4] is None:
            fields = [x.movedim(d, 0) if d is not None
                      else x.expand(V, *x.shape)
                      for x, d in zip(xs[:3], dims[:3])]
            F = fields[0].shape[1]
            flat = [f.reshape(V * F, *f.shape[2:]) for f in fields]
            rows = _FanKernel.apply(geo, kw, *flat, *xs[3:])
            return rows.reshape(rows.shape[0], V, F, -1), 1
        outs = [_FanKernel.apply(geo, kw, *[x if d is None else x.select(d, v)
                                            for x, d in zip(xs, dims)])
                for v in range(V)]
        return torch.stack(outs), 0
