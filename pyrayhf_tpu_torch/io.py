"""IO: reference-compatible pickle files, checkpoints, the JAX package's state.

:func:`save_to_file` / :func:`load_input` and :func:`save_checkpoint` /
:func:`load_checkpoint` are the pure-Python functions of
``pyrayhf_tpu.io`` (byte-compatible with the reference's ``.p`` files;
the same flat-npz checkpoint layout, so either package resumes the
other's file). :func:`profiles_to_torch` carries the JAX side's state
across: the
reference-format profile dict of numpy arrays and an ``OperatorConfig``
become the port's tensors and config, so both packages compute the same
thing. :func:`field_from_numpy` does the same for a 3-D field dict.
"""

import dataclasses
import os
import pickle

import numpy as np
import torch

from ._util import resolve_device
from .config import OperatorConfig

__all__ = ["save_to_file", "load_input", "save_checkpoint",
           "load_checkpoint", "profiles_to_torch", "field_from_numpy",
           "PROFILE_KEYS"]

# the array-valued keys of a reference-format profile dict
PROFILE_KEYS = ("den", "bmag", "bpsi", "alt")


def save_to_file(output, file_path):
    """Pickle a dict to ``file_path`` (API-parity, ref :2442-2455)."""
    with open(file_path, "wb") as f:
        pickle.dump(output, f)


def load_input(file_path):
    """Load a reference-format ``.p`` input dict (e.g. the tutorial files)."""
    with open(file_path, "rb") as f:
        return pickle.load(f)


# Key separator for flattened nested dicts. A unit separator (0x1f) cannot
# appear in sane keys — '.'-joining silently mis-nests keys that themselves
# contain dots (e.g. a frequency label '2.5').
_SEP = "\x1f"

# Sentinel key marking the U+001F-separated format: its presence, not the
# key contents, decides how load_checkpoint splits.
_FMT_MARKER = "__fmt_v2__"


def _flatten(prefix, obj, out):
    if isinstance(obj, dict):
        for k, v in obj.items():
            if _SEP in str(k):
                raise ValueError(f"checkpoint key {k!r} contains the "
                                 "reserved separator U+001F")
            _flatten(f"{prefix}{_SEP}{k}" if prefix else str(k), v, out)
    elif isinstance(obj, torch.Tensor):
        out[prefix] = obj.detach().cpu().numpy()
    else:
        out[prefix] = np.asarray(obj)


def save_checkpoint(state, file_path):
    """Persist a nested dict of arrays (or tensors) to a flat .npz file.

    The write is atomic (temp file + ``os.replace``): a kill landing
    mid-save leaves the previous checkpoint intact rather than a truncated
    zip.
    """
    flat = {}
    _flatten("", state, flat)
    flat[_FMT_MARKER] = np.asarray(2)
    tmp = f"{file_path}.tmp.{os.getpid()}"
    try:
        np.savez_compressed(tmp, **flat)
        # numpy appends .npz when the name lacks it
        if not os.path.exists(tmp) and os.path.exists(tmp + ".npz"):
            tmp = tmp + ".npz"
        os.replace(tmp, file_path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_checkpoint(file_path):
    """Inverse of :func:`save_checkpoint`: rebuilds the nested dict of
    numpy arrays.

    Marked files (``__fmt_v2__``) split only on U+001F; unmarked files
    with U+001F in some key are the marker-less format of an earlier
    release; unmarked files without it are the original '.'-separated
    flatten, split on '.' as a best effort.
    """
    data = np.load(file_path, allow_pickle=False)
    if _FMT_MARKER in data.files or any(_SEP in k for k in data.files):
        sep = _SEP
    else:
        sep = "."
    out = {}
    for key in data.files:
        if key == _FMT_MARKER:
            continue
        parts = key.split(sep)
        d = out
        for part in parts[:-1]:
            d = d.setdefault(part, {})
        d[parts[-1]] = data[key]
    return out


def profiles_to_torch(inp, device=None, dtype=torch.float64, config=None):
    """Reference-format profile dict (+ config) → the port's tensors/config.

    ``inp``: dict holding ``den``, ``bmag``, ``bpsi`` and ``alt`` as array-
    likes (other keys are copied unchanged). Returns a new dict whose
    profile keys are ``dtype`` tensors on ``device``: the CUDA card unless
    the caller asks for the CPU (``device="cpu"``); without a card and
    without that request it raises. When ``config`` is
    given (the JAX package's ``OperatorConfig`` or any object with the
    same fields), the result also holds the port's :class:`OperatorConfig`
    with the same field values under ``"config"``.
    """
    missing = [k for k in PROFILE_KEYS if k not in inp]
    if missing:
        raise KeyError(f"profile dict lacks {missing}")
    out = dict(inp)
    device = resolve_device(device)
    for k in PROFILE_KEYS:
        out[k] = torch.as_tensor(np.asarray(inp[k], dtype=np.float64),
                                 device=device).to(dtype)
    if config is not None:
        names = [f.name for f in dataclasses.fields(OperatorConfig)]
        out["config"] = OperatorConfig(
            **{n: getattr(config, n) for n in names})
    return out


def field_from_numpy(field, device=None, dtype=torch.float64):
    """A 3-D field dict of arrays (e.g. the JAX package's
    ``build_field_3d`` or ``build_field_3d_aniso`` output, as numpy) →
    the port's dict of ``dtype`` tensors on ``device`` (the CUDA card
    unless the caller asks for the CPU). Tuples of arrays (the anisotropic
    ``tables``) become tuples of tensors.
    """
    device = resolve_device(device)

    def conv(v):
        if isinstance(v, (tuple, list)):
            return tuple(conv(x) for x in v)
        return torch.as_tensor(np.asarray(v, dtype=np.float64),
                               device=device).to(dtype)

    return {k: conv(v) for k, v in field.items()}
