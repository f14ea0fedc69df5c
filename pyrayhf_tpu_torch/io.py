"""IO: reference-compatible pickle files and the JAX package's state.

:func:`save_to_file` / :func:`load_input` are the pure-Python functions of
``pyrayhf_tpu.io`` (byte-compatible with the reference's ``.p`` files).
:func:`profiles_to_torch` carries the JAX side's state across: the
reference-format profile dict of numpy arrays and an ``OperatorConfig``
become the port's tensors and config, so both packages compute the same
thing.
"""

import dataclasses
import pickle

import numpy as np
import torch

from ._util import resolve_device
from .config import OperatorConfig

__all__ = ["save_to_file", "load_input", "profiles_to_torch",
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
