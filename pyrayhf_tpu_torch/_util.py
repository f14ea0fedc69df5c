"""Tensor plumbing shared by the port's modules."""

import functools

import numpy as np
import torch

from .profiling import span


def resolve_device(device=None):
    """Where host data (numpy arrays, lists, Python numbers) lands.

    ``device`` if given; else the CUDA card. Without a card, and without an
    explicit request for the CPU, this raises: an entry point never carries
    on quietly on the CPU.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: host data goes to the card by default. Pass "
            'device="cpu" (or CPU tensors) to run on the CPU.')
    return torch.device("cuda")


def as_tensors(*xs, dtype=None, device=None):
    """Convert arguments to floating tensors of one dtype on one device.

    The device is that of the tensor arguments; when there are none, it is
    :func:`resolve_device` of ``device`` (the card unless the caller asks
    for the CPU). Tensors on different devices, or on another device than
    an explicit ``device``, raise rather than being moved. Array-likes
    (numpy arrays, lists, Python numbers) are host data and are created on
    that device. The dtype is ``dtype`` if given, else the promotion of the
    floating tensor arguments, else float64 (what the JAX package computes
    in under x64).
    """
    tensors = [x for x in xs if isinstance(x, torch.Tensor)]
    devices = {t.device for t in tensors}
    if len(devices) > 1:
        raise ValueError("inputs lie on different devices: "
                         f"{sorted(map(str, devices))}")
    if tensors:
        dev = tensors[0].device
        if device is not None and torch.device(device).type != dev.type:
            raise ValueError(f"device={device!r} but the tensor inputs lie "
                             f"on {dev}")
    else:
        dev = resolve_device(device)
    if dtype is None:
        dtype = torch.float64
        floats = [t.dtype for t in tensors if t.is_floating_point()]
        if floats:
            dtype = floats[0]
            for d in floats[1:]:
                dtype = torch.promote_types(dtype, d)
    return [x.to(dtype) if isinstance(x, torch.Tensor)
            else torch.as_tensor(_host_array(x), device=dev).to(dtype)
            for x in xs]


def _host_array(x):
    """``x`` as a float64 numpy array torch can take (a view with negative
    strides, e.g. a grid flipped with ``[::-1]``, is copied)."""
    a = np.asarray(x, dtype=np.float64)
    return a.copy() if any(s < 0 for s in a.strides) else a


def profile_tensors(freq_mhz, den, bmag, bpsi, alt, device=None):
    """(freq_mhz, den, bmag, bpsi, alt) as tensors in den's dtype and device.

    Like the JAX package, every operand is cast to the density's dtype.
    Host data goes where :func:`as_tensors` puts it.
    """
    if not isinstance(den, torch.Tensor):
        # the device of any tensor argument decides where den lands
        like = [x for x in (freq_mhz, bmag, bpsi, alt)
                if isinstance(x, torch.Tensor)]
        (den,) = as_tensors(den, dtype=torch.float64,
                            device=like[0].device if like else device)
    else:
        (den,) = as_tensors(den, device=device)
    freq_mhz, bmag, bpsi, alt, _ = as_tensors(freq_mhz, bmag, bpsi, alt, den,
                                              dtype=den.dtype)
    return freq_mhz, den, bmag, bpsi, alt


def scalar_like(v, like):
    """``v`` as a 0-d tensor in ``like``'s dtype and device.

    A number becomes a cached tensor filled on the device: building it with
    ``torch.as_tensor`` would copy from host memory, and on the card that
    copy waits for the stream, a host sync inside every loop that calls it.
    """
    if isinstance(v, torch.Tensor):
        return v.to(dtype=like.dtype, device=like.device)
    return _scalar(float(v), like.dtype, like.device)


@functools.lru_cache(maxsize=1024)
def _scalar(v, dtype, device):
    # made outside any torch.func transform: a tensor made inside one may
    # be wrapped at its level, and the cache would hand it to later calls
    with torch.inference_mode(False), torch._C._DisableFuncTorch():
        return torch.full((), v, dtype=dtype, device=device)


def clip(x, lo, hi):
    """``jnp.clip`` semantics: min(max(x, lo), hi), NaN-propagating.

    Built from ``torch.maximum``/``torch.minimum`` so that, like JAX, the
    gradient at a tie is split between the two arguments.
    """
    return torch.minimum(torch.maximum(x, scalar_like(lo, x)),
                         scalar_like(hi, x))


def host_f64(a):
    """A 1-D host grid as a float64 numpy array (tensors are copied).

    A plain tensor is read with ``torch.func`` transforms set aside, which
    refuse every host read inside them; a tensor a transform wraps (a grid
    being differentiated or batched) has no values to read and raises.
    A read from a device (a host sync) is a ``pyrayhf.host_read`` span.
    """
    if isinstance(a, torch.Tensor):
        with torch._C._DisableFuncTorch():
            a = a.detach()
            if a.device.type != "cpu":
                with span("pyrayhf.host_read"):
                    a = a.cpu()
            a = a.double().numpy()
    return np.asarray(a, dtype=np.float64)


def host_float(t):
    """A 0-d tensor's value as a Python float; a read from a device (a
    host sync) is a ``pyrayhf.host_read`` span."""
    if isinstance(t, torch.Tensor) and t.device.type != "cpu":
        with span("pyrayhf.host_read"):
            return float(t)
    return float(t)
