"""1-D linear interpolation with np.interp-exact node semantics.

Port of ``pyrayhf_tpu.interp``. ``jnp.interp`` (and :func:`pyrayhf_tpu_torch
.grid.interp`) evaluates ``fp[i] + t·(fp[i+1]-fp[i])`` even at t == 0, so a
query landing exactly on a grid node next to a NaN neighbour returns NaN
(0·NaN). ``np.interp`` short-circuits exact hits and returns ``fp[i]``; the
reference's tracers lean on that (path nodes land exactly on profile
altitudes while μ' carries NaN evanescent gaps, ref ``library.py:1244,
1686``), so this branch-free variant matches it.
"""

import torch

from ._util import as_tensors

__all__ = ["interp_exact"]


def interp_exact(x, xp, fp, device=None):
    """np.interp-compatible linear interpolation (exact-node hits, edge clamp).

    ``x``: any shape; ``xp`` ascending 1-D; ``fp`` 1-D same length. NaN
    queries return NaN. Host arrays go to the CUDA card unless ``device``
    says otherwise (``device="cpu"``).
    """
    x, xp, fp = as_tensors(x, xp, fp, device=device)
    n = xp.shape[0]
    i = torch.searchsorted(xp.contiguous(), x.contiguous(), right=True) - 1
    i = torch.clamp(i, 0, n - 2)
    x0 = xp[i]
    x1 = xp[i + 1]
    f0 = fp[i]
    f1 = fp[i + 1]
    dx = x1 - x0
    t = (x - x0) / torch.where(dx != 0.0, dx, 1.0)
    y = f0 + t * (f1 - f0)
    y = torch.where(x == x1, f1, y)
    y = torch.where(x == x0, f0, y)
    y = torch.where(x <= xp[0], fp[0], y)
    y = torch.where(x >= xp[-1], fp[-1], y)
    return torch.where(torch.isnan(x), float("nan"), y)
