"""Tensor plumbing shared by the port's modules."""

import numpy as np
import torch


def as_tensors(*xs, dtype=None):
    """Convert arguments to floating tensors of one dtype on one device.

    The device is that of the tensor arguments (CPU when there are none);
    tensors on different devices raise rather than being moved. Array-likes
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
    device = tensors[0].device if tensors else torch.device("cpu")
    if dtype is None:
        dtype = torch.float64
        floats = [t.dtype for t in tensors if t.is_floating_point()]
        if floats:
            dtype = floats[0]
            for d in floats[1:]:
                dtype = torch.promote_types(dtype, d)
    return [x.to(dtype) if isinstance(x, torch.Tensor)
            else torch.as_tensor(np.asarray(x, dtype=np.float64),
                                 device=device).to(dtype) for x in xs]


def profile_tensors(freq_mhz, den, bmag, bpsi, alt):
    """(freq_mhz, den, bmag, bpsi, alt) as tensors in den's dtype and device.

    Like the JAX package, every operand is cast to the density's dtype.
    """
    (den,) = as_tensors(den)
    freq_mhz, bmag, bpsi, alt, _ = as_tensors(freq_mhz, bmag, bpsi, alt, den,
                                              dtype=den.dtype)
    return freq_mhz, den, bmag, bpsi, alt


def clip(x, lo, hi):
    """``jnp.clip`` semantics: min(max(x, lo), hi), NaN-propagating.

    Built from ``torch.maximum``/``torch.minimum`` so that, like JAX, the
    gradient at a tie is split between the two arguments.
    """
    lo_t = torch.as_tensor(lo, dtype=x.dtype, device=x.device)
    hi_t = torch.as_tensor(hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo_t), hi_t)
