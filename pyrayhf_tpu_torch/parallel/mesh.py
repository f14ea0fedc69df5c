"""Device-mesh sharding of the virtual-height engine, in PyTorch.

Port of ``pyrayhf_tpu.parallel.mesh``. The JAX package shards over a
``jax.sharding.Mesh`` with ``shard_map`` and GSPMD. Here the mesh is a
(batch, freq) grid of ``torch.device``s in one process (:class:`IonogramMesh`),
and a sharded call runs its shards one after another:

* each operand is cut along its mesh axis into equal pieces (an uneven cut
  raises ``ValueError``), by position in the mesh: a device may repeat, so
  ``[torch.device("cuda:0")] * 8`` is a 4×2 mesh on one card and
  ``[torch.device("cpu")] * 8`` one on the CPU;
* each piece moves to its shard's device (a no-op where it lies there);
* the per-shard function runs;
* the shards' results are gathered onto the mesh's first device with
  ``torch.cat`` in mesh order (along ``freq`` within a batch row, then along
  ``batch``), one global result as the JAX functions return one global
  array; a ``psum`` moves each shard's partial there and adds them in shard
  order.

Host data (numpy arrays, lists, numbers) goes to the mesh's devices: the
mesh is the explicit device. Where the JAX package replicates a shard's
work over the axis a function does not shard, it runs once here, on the
devices at the first index of that axis.

``synthesize_ionograms_sharded(engine="pallas")`` launches the sweep kernel
(``csrc/ionogram.cu``) once per (batch, freq) block on CUDA tensors; the
other functions are plain torch, as they are plain XLA in the JAX package.
The batched functions decide the unmagnetised branch of the Appleton–
Hartree index (|Y| < 1e-12 everywhere) per profile, as the JAX package's
``vmap`` does; :func:`vh_height_sharded` decides it per height shard, as
each JAX ``shard_map`` shard does.
"""

import collections

import numpy as np
import torch

from .._util import as_tensors, profile_tensors
from ..doppler import _doppler_core
from ..forward import vh_and_mask
from ..magnetoionic import find_mu_mup_masked, find_X, find_Y, mode_multiplier
from ..pallas_vh import ionogram_fast_xla, ionogram_pallas

__all__ = ["IonogramMesh", "ionogram_mesh", "synthesize_ionograms_sharded",
           "vh_height_sharded", "retrieval_step_sharded",
           "retrieve_gradient_batch_sharded", "trace_fan_3d_sharded",
           "trace_fan_3d_aniso_sharded", "doppler_batch_sharded"]

_NAN = float("nan")


class IonogramMesh:
    """A (batch, freq) grid of torch devices.

    ``devices`` is a numpy object array [batch, freq] of ``torch.device``;
    ``shape`` maps each axis name to its size, in order, so that
    ``mesh.shape[axis]`` and ``dict(mesh.shape)`` read as on a
    ``jax.sharding.Mesh``.
    """

    axis_names = ("batch", "freq")

    def __init__(self, devices):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != 2 or devices.size == 0:
            raise ValueError("a mesh needs a non-empty [batch, freq] array "
                             f"of devices, got shape {devices.shape}")
        self.devices = devices
        self.shape = collections.OrderedDict(zip(self.axis_names,
                                                 devices.shape))

    @property
    def first(self):
        """The device the gathered results land on."""
        return self.devices[0, 0]

    def axis_devices(self, axis):
        """The devices of ``axis``'s shards, in order, at the first index
        of the other axis."""
        if axis not in self.shape:
            raise ValueError(f"no mesh axis {axis!r}; the axes are "
                             f"{self.axis_names}")
        return list(self.devices[:, 0] if axis == "batch"
                    else self.devices[0, :])


def _put(x, dev):
    """``x`` on ``dev`` (the same tensor where it lies there already); a
    copy to a card does not wait for the host."""
    return x.to(dev, non_blocking=dev.type == "cuda")


def _per_device(x):
    """``on(dev)``: ``x`` on ``dev``, copied once per distinct device."""
    copies = {}

    def on(dev):
        if dev not in copies:
            copies[dev] = _put(x, dev)
        return copies[dev]
    return on


def _split(x, n, what, dim=0):
    """``x`` cut along ``dim`` into ``n`` equal pieces."""
    size = x.shape[dim]
    if size % n:
        raise ValueError(f"{what} ({size}) must be divisible by the mesh "
                         f"axis size ({n})")
    return x.split(size // n, dim=dim)


def _host_device(mesh, *xs):
    """Where host data lands: beside the tensor arguments if there are any
    (each shard's piece then moves to its device), else on the mesh's
    first device."""
    return None if any(isinstance(x, torch.Tensor) for x in xs) \
        else mesh.first


def _psum(parts, first):
    """The shards' partials added in shard order on ``first``."""
    total = _put(parts[0], first)
    for p in parts[1:]:
        total = total + _put(p, first)
    return total


def _cat(parts, first, dim=0):
    return torch.cat([_put(p, first) for p in parts], dim=dim)


def ionogram_mesh(devices=None, batch_axis=None):
    """Build a (batch, freq) mesh over the given devices.

    ``devices``: torch devices (or their names), in mesh order; a device
    may repeat. Default: every visible CUDA card; without one this raises.
    ``batch_axis`` defaults to every device on 'batch' and 1 on 'freq';
    else it must divide the device count.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: a mesh defaults to every visible card. "
                'Pass devices=[torch.device("cpu")] * n for a mesh on the '
                "CPU.")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in devices]
    n = len(devs)
    if batch_axis is None:
        batch_axis = n
        freq_axis = 1
    else:
        if batch_axis <= 0 or n % batch_axis:
            raise ValueError(
                f"batch_axis={batch_axis} must be a positive divisor of "
                f"the device count ({n}); an uneven split would drop "
                "devices from the mesh")
        freq_axis = n // batch_axis
    grid = np.empty(n, dtype=object)
    grid[:] = devs
    return IonogramMesh(grid.reshape(batch_axis, freq_axis))


def synthesize_ionograms_sharded(freq, den, bmag, bpsi, alt, mesh,
                                 mode="O", n_points=200, engine="xla",
                                 interpret=False):
    """Batched ionogram synthesis sharded over a (batch, freq) mesh.

    ``den``/``bmag``/``bpsi``: [B, N_alt] profile stacks (B divisible by the
    'batch' axis), ``alt``: [N_alt] shared grid, ``freq``: [F] MHz (F
    divisible by the 'freq' axis). Returns [B, F] virtual heights on the
    mesh's first device.

    Each (batch, freq) block runs on its device: ``engine="xla"`` (default)
    through :func:`pyrayhf_tpu_torch.pallas_vh.ionogram_fast_xla`,
    ``engine="pallas"`` through :func:`pyrayhf_tpu_torch.pallas_vh
    .ionogram_pallas`, one launch of the sweep kernel per block on CUDA
    tensors (its plain version on CPU tensors, where ``interpret`` is
    accepted; on CUDA tensors ``interpret=True`` raises). Operands take the
    density's dtype.
    """
    mm = mode_multiplier(mode)
    if engine == "pallas":
        def run(*a):
            return ionogram_pallas(*a, mode_mult=mm, n_points=n_points,
                                   interpret=interpret)
    elif engine == "xla":
        def run(*a):
            return ionogram_fast_xla(*a, mode_mult=mm, n_points=n_points)
    else:
        raise ValueError("engine must be 'xla' or 'pallas'")
    freq, den, bmag, bpsi, alt = profile_tensors(
        freq, den, bmag, bpsi, alt,
        device=_host_device(mesh, freq, den, bmag, bpsi, alt))
    if den.ndim != 2 or bmag.shape != den.shape or bpsi.shape != den.shape:
        raise ValueError("den, bmag and bpsi must be [B, N_alt] stacks of "
                         f"one shape, got {tuple(den.shape)}, "
                         f"{tuple(bmag.shape)}, {tuple(bpsi.shape)}")
    freqs = _split(freq, mesh.shape["freq"], "frequency count")
    profs = zip(*(_split(t, mesh.shape["batch"], "batch size")
                  for t in (den, bmag, bpsi)))
    alt_on = _per_device(alt)
    rows = []
    for i, prof in enumerate(profs):
        row = []
        for j, fr in enumerate(freqs):
            dev = mesh.devices[i, j]
            row.append(run(_put(fr, dev), *(_put(t, dev) for t in prof),
                           alt_on(dev)))
        rows.append(_cat(row, mesh.first, dim=1))
    return torch.cat(rows, dim=0)


def vh_height_sharded(freq_mhz, den, bmag, bpsi, alt, mesh, axis="batch",
                      mode="O", n_points=256):
    """Height-sharded quadrature: each shard of ``axis`` integrates a slice
    of the stretched grid and the partial sums add (the JAX ``psum``).

    The profile is regridded once on the mesh's first device
    (:func:`pyrayhf_tpu_torch.grid.regrid_core`, masked); its [F, n_points]
    tiles are cut along height. ``n_points`` must be divisible by the axis
    size. Returns [F] virtual heights, NaN where the ray escapes.
    """
    from ..grid import regrid_core

    mm = mode_multiplier(mode)
    n_dev = mesh.shape[axis]
    if n_points % n_dev:
        raise ValueError("n_points must be divisible by the mesh axis size")
    first = mesh.first
    freq_mhz, den, bmag, bpsi, alt = (_put(t, first) for t in profile_tensors(
        freq_mhz, den, bmag, bpsi, alt,
        device=_host_device(mesh, freq_mhz, den, bmag, bpsi, alt)))
    rg = regrid_core(freq_mhz * 1e6, den, bmag, bpsi, alt, mode_mult=mm,
                     n_points=n_points, masked=True)
    mode_str = "O" if mm > 0 else "X"
    tiles = zip(*(_split(rg[k], n_dev, "n_points", dim=-1)
                  for k in ("den", "bmag", "bpsi", "dist", "freq")))
    parts = []
    for dev, tile in zip(mesh.axis_devices(axis), tiles):
        den_t, bmag_t, bpsi_t, dist_t, freq_t = (_put(t, dev) for t in tile)
        aX = find_X(den_t, freq_t)
        aY = find_Y(freq_t, bmag_t)
        _, mup, ok = find_mu_mup_masked(aX, aY, bpsi_t, mode_str)
        parts.append(torch.sum(torch.where(ok, mup * dist_t, 0.0), dim=-1))
    ih = _psum(parts, first)
    return torch.where(rg["row_ok"] & (ih != 0.0), ih + torch.amin(alt),
                       _NAN)


def _step_loss(hm, bb, nm, obs, freq, alt, bmag, bpsi, E, B_top,
               n_points):
    """Σ r² over a shard's [b] profiles: each profile's EDP (F1 from
    P = 0.8) through :func:`pyrayhf_tpu_torch.forward.vh_and_mask`, its
    residuals to ``obs`` [b, F] where both are valid, as one batch."""
    from .. import edp

    NmF1, _, hmF1, _ = edp.derive_dependent_F1_parameters(
        0.8, nm[:, None], hm[:, None], bb[:, None], E["hm"])
    EDP = edp.reconstruct_density_1level(
        {"Nm": nm[:, None], "hm": hm[:, None], "B_bot": bb[:, None],
         "B_top": B_top}, {"Nm": NmF1, "hm": hmF1}, E, alt)
    b = hm.shape[0]
    vh, valid = vh_and_mask(freq, EDP, bmag.expand(b, -1),
                            bpsi.expand(b, -1), alt, mode_mult=1.0,
                            n_points=n_points)
    use = valid & torch.isfinite(obs)
    r = torch.where(use, obs - vh, 0.0)
    return torch.sum(r * r)


def retrieval_step_sharded(theta, obs, freq, den_aux, mesh, lr=1e-2,
                           n_points=64):
    """One gradient step of a batched retrieval, the profiles sharded over
    the 'batch' axis.

    ``theta``: {'hm': [B], 'bb': [B], 'nm': [B]} per-profile layer params;
    ``obs``: [B, F] observed virtual heights; ``den_aux``: dict with 'alt'
    [N], 'bmag' [N], 'bpsi' [N], 'E' layer dict and 'B_top' scalar. Each
    shard's step is its parameters minus ``lr`` times the gradient of its
    own loss (the total loss's gradient there: no other shard's loss
    depends on them). Returns (theta_next, loss): [B] tensors and the total
    Σ r² as a 0-d tensor, on the mesh's first device.
    """
    hm, bb, nm, obs = as_tensors(
        theta["hm"], theta["bb"], theta["nm"], obs,
        device=_host_device(mesh, theta["hm"], theta["bb"], theta["nm"],
                            obs))
    aux = as_tensors(freq, den_aux["alt"], den_aux["bmag"], den_aux["bpsi"],
                     dtype=hm.dtype,
                     device=_host_device(mesh, freq, den_aux["alt"],
                                         den_aux["bmag"], den_aux["bpsi"]))
    aux_on = [_per_device(t) for t in aux]
    n_dev = mesh.shape["batch"]
    shards = zip(*(_split(t, n_dev, "batch size")
                   for t in (hm, bb, nm, obs)))
    new, losses = [], []
    for dev, (h, b, m, o) in zip(mesh.axis_devices("batch"), shards):
        params = [_put(t, dev).detach().requires_grad_(True)
                  for t in (h, b, m)]
        with torch.enable_grad():
            loss = _step_loss(*params, _put(o, dev),
                              *(on(dev) for on in aux_on), den_aux["E"],
                              den_aux["B_top"], n_points)
            grads = torch.autograd.grad(loss, params)
        new.append([(p - lr * g).detach() for p, g in zip(params, grads)])
        losses.append(loss.detach())
    first = mesh.first
    theta_next = {k: _cat([s[i] for s in new], first)
                  for i, k in enumerate(("hm", "bb", "nm"))}
    return theta_next, _psum(losses, first)


def retrieve_gradient_batch_sharded(F2, F1, E, f_in, vh_obs, alt, b_mag,
                                    b_psi, mesh, mode="O", n_points=200,
                                    bottom_type="B_bot", steps=25,
                                    fit_nm=False, crit_margin=0.995,
                                    chunk_size=None):
    """Batched LM retrieval with the [B, F] ionograms sharded over the
    'batch' axis.

    Each shard runs :func:`pyrayhf_tpu_torch.retrieval
    .retrieve_gradient_batch` (``chunk_size=None``) on its device. The LM is
    per sample (its damping, accept decisions, fixed step count and retries
    are each sample's own), so the gathered fits are the unsharded call's.
    B must be divisible by the axis size. Per-sample [B, N] ``b_mag``/
    ``b_psi`` are cut with the batch; shared [N] ones go whole to every
    shard. ``chunk_size`` splits the batch into runs that are each sharded
    again; every chunk, a ragged last one included, must be divisible by
    the axis size. Returns (vh_fit [B, F], EDP_fit [B, N] on the mesh's
    first device, F2_fit dict with [B] numpy arrays, history [steps, B]
    numpy), as the unsharded call.
    """
    from ..retrieval import retrieve_gradient_batch

    dev0 = _host_device(mesh, f_in, vh_obs, alt, b_mag, b_psi)
    f, obs, alt, b_mag, b_psi = as_tensors(f_in, vh_obs, alt, b_mag, b_psi,
                                           device=dev0)
    obs = torch.atleast_2d(obs)
    B = obs.shape[0]
    ax = mesh.shape["batch"]
    if B % ax:
        raise ValueError("B must be divisible by the 'batch' axis size")

    def _env_part(a, sel):
        return a if a.ndim == 1 else a[sel]

    F2 = dict(F2)
    keys = ["hm", "B_bot" if bottom_type == "B_bot" else "B0"]
    if fit_nm:
        keys.append("Nm")
    for k in keys:
        (v,) = as_tensors(F2[k], obs, dtype=obs.dtype)[:1]
        F2[k] = torch.broadcast_to(v.reshape(-1), (B,))

    if chunk_size is None or int(chunk_size) >= B:
        bounds = [(0, B)]
    else:
        cs = int(chunk_size)
        if cs % ax or (B % cs) % ax:
            raise ValueError(
                "chunk_size (and any ragged final chunk) must be divisible "
                f"by the 'batch' axis size {ax} (got chunk_size={cs}, B={B})")
        bounds = [(s, min(s + cs, B)) for s in range(0, B, cs)]

    f_on, alt_on = _per_device(f), _per_device(alt)
    parts = []
    for lo, hi in bounds:
        step = (hi - lo) // ax
        for k, dev in enumerate(mesh.axis_devices("batch")):
            sl = slice(lo + k * step, lo + (k + 1) * step)
            F2_s = dict(F2)
            for key in keys:
                F2_s[key] = _put(F2[key][sl], dev)
            parts.append(retrieve_gradient_batch(
                F2_s, F1, E, f_on(dev), _put(obs[sl], dev), alt_on(dev),
                _put(_env_part(b_mag, sl), dev),
                _put(_env_part(b_psi, sl), dev), mode=mode,
                n_points=n_points, bottom_type=bottom_type, steps=steps,
                fit_nm=fit_nm, crit_margin=crit_margin, chunk_size=None))
    first = mesh.first
    vh = _cat([p[0] for p in parts], first)
    edp = _cat([p[1] for p in parts], first)
    hist = np.concatenate([p[3] for p in parts], axis=1)
    key2 = "B_bot" if bottom_type == "B_bot" else "B0"
    F2_fit = dict(parts[0][2])
    for k in ("Nm", "hm", key2):
        F2_fit[k] = np.concatenate(
            [np.asarray(p[2][k]).reshape(-1) for p in parts])
    return vh, edp, F2_fit, hist


def _field_on(field, dev):
    """A 3-D field dict with its tensors on ``dev``."""
    def put(v):
        if isinstance(v, torch.Tensor):
            return _put(v, dev)
        if isinstance(v, (tuple, list)):
            return type(v)(put(x) for x in v)
        return v
    return {k: put(v) for k, v in field.items()}


def _fan_sharded(field, els, mesh, axis, trace):
    """``trace(field_on_dev, dev, els_k)`` for each elevation shard of
    ``axis``, with the field copied once per distinct device; every output
    leaf [e, A, ...] concatenated along E on the mesh's first device."""
    n_dev = mesh.shape[axis]
    if els.numel() % n_dev:
        raise ValueError(
            f"elevation count ({els.numel()}) must be divisible by the "
            f"'{axis}' mesh axis size ({n_dev})")
    fields, outs = {}, []
    for dev, els_k in zip(mesh.axis_devices(axis),
                          els.split(els.numel() // n_dev)):
        if dev not in fields:
            fields[dev] = _field_on(field, dev)
        outs.append(trace(fields[dev], dev, _put(els_k, dev)))
    out = {}
    for k in outs[0]:
        shapes = {tuple(o[k].shape[1:]) for o in outs}
        if len(shapes) > 1:
            raise RuntimeError(f"the shards' {k!r} differ in shape beyond "
                               f"the elevation axis: {sorted(shapes)}")
        out[k] = _cat([o[k] for o in outs], mesh.first)
    return out


def trace_fan_3d_sharded(field, lat0_deg, lon0_deg, elevation_deg,
                         azimuth_deg, mesh, axis="batch", *, step_km=2.0,
                         s_max_km=3000.0, z_ground_km=0.0, n_hops=1):
    """3-D (elevation × azimuth) fan with the elevation axis sharded.

    Each shard traces its elevation slice against the full azimuth set on
    the batched early-exit fan of :func:`pyrayhf_tpu_torch.trace3d
    .trace_rays_3d`, which stops once ITS rays are frozen (the rows left
    repeat each ray's final state, so every shard keeps ``n_steps`` rows).
    The field's tensors are copied once per distinct device of the axis.
    Returns the unsharded fan's dict of [E, A, ...] tensors.
    """
    from ..trace3d import (_field_leaves, _grad_mode, _like,
                           _trace3d_fan_core)

    n_steps = int(round(float(s_max_km) / float(step_km)))
    lat0, lon0, els, azs, ds, zg = _like(field, lat0_deg, lon0_deg,
                                         elevation_deg, azimuth_deg,
                                         step_km, z_ground_km)

    def trace(fld, dev, els_k):
        with _grad_mode(*_field_leaves(field), lat0, lon0, els, azs):
            return _trace3d_fan_core(
                fld, _put(lat0, dev), _put(lon0, dev), els_k,
                _put(azs.reshape(-1), dev), _put(ds, dev), n_steps,
                _put(zg, dev), n_hops=int(n_hops))

    return _fan_sharded(field, els.reshape(-1), mesh, axis, trace)


def trace_fan_3d_aniso_sharded(field, lat0_deg, lon0_deg, elevation_deg,
                               azimuth_deg, f0_hz, mesh, axis="batch", *,
                               mode="O", step_km=1.0, s_max_km=6000.0,
                               z_ground_km=0.0, n_hops=1):
    """Anisotropic 3-D fan with the elevation axis sharded over the mesh.

    The full-Haselgrove counterpart of :func:`trace_fan_3d_sharded`: each
    shard traces its elevation slice through the shared (frequency- and
    mode-independent) field of :func:`pyrayhf_tpu_torch.trace3d_aniso
    .build_field_3d_aniso` on the early-exit fan of
    :func:`pyrayhf_tpu_torch.trace3d_aniso.trace_rays_3d_anisotropic`.
    Returns its dict of [E, A, ...] tensors.
    """
    from ..trace3d_aniso import _aniso_fan_core, _needs_graph
    from ..trace3d import _like

    n_steps = int(round(float(s_max_km) / float(step_km)))
    lat0, lon0, els, azs, f0, ds, zg = _like(field, lat0_deg, lon0_deg,
                                             elevation_deg, azimuth_deg,
                                             f0_hz, step_km, z_ground_km)
    graph = _needs_graph(field, lat0, lon0, els, azs, f0)

    def trace(fld, dev, els_k):
        with torch.set_grad_enabled(graph):
            return _aniso_fan_core(
                fld, _put(lat0, dev), _put(lon0, dev), els_k,
                _put(azs.reshape(-1), dev), _put(f0, dev), mode,
                _put(ds, dev), n_steps, _put(zg, dev), n_hops=int(n_hops),
                graph=graph)

    return _fan_sharded(field, els.reshape(-1), mesh, axis, trace)


def doppler_batch_sharded(freq, den, dden_dt, bmag, bpsi, alt, mesh,
                          axis="batch", mode="O", n_points=200):
    """Batched vertical-incidence Doppler with the profile batch sharded.

    ``den``/``dden_dt`` are [B, N]; ``bmag``/``bpsi`` may be [N] (shared)
    or [B, N] (per-cell IGRF); ``alt`` is shared. Each shard runs one
    forward-mode tangent (the field's tendencies zero) through the phase
    operator of :func:`pyrayhf_tpu_torch.doppler.doppler_shift_vertical` on
    its [b, N] stack at once. Returns {"doppler_hz", "phase_height_km"} as
    [B, F] tensors on the mesh's first device, NaN where the ray escapes.
    """
    freq, den, bmag, bpsi, alt = profile_tensors(
        freq, den, bmag, bpsi, alt,
        device=_host_device(mesh, freq, den, dden_dt, bmag, bpsi, alt))
    den = torch.atleast_2d(den)
    (dden,) = as_tensors(dden_dt, den, dtype=den.dtype)[:1]
    dden, bmag, bpsi = (torch.broadcast_to(t, den.shape)
                        for t in (dden, bmag, bpsi))
    B = den.shape[0]
    n_dev = mesh.shape[axis]
    if B % n_dev:
        raise ValueError(
            f"batch size ({B}) must be divisible by the '{axis}' mesh "
            f"axis size ({n_dev})")
    mm = mode_multiplier(mode)
    freq_on, alt_on = _per_device(freq), _per_device(alt)
    shards = zip(*(t.split(B // n_dev) for t in (den, dden, bmag, bpsi)))
    fds, hps = [], []
    for dev, shard in zip(mesh.axis_devices(axis), shards):
        d, dd, bm, bp = (_put(t, dev).contiguous() for t in shard)
        zero = torch.zeros_like(d)
        fd, hp, _ = _doppler_core(freq_on(dev), d, dd, bm, zero, bp, zero,
                                  alt_on(dev), mm, n_points)
        fds.append(fd)
        hps.append(hp)
    return {"doppler_hz": _cat(fds, mesh.first),
            "phase_height_km": _cat(hps, mesh.first)}
