"""Frozen configurations (a copy of ``pyrayhf_tpu.config``'s).

The port cannot import the JAX package's module (its package ``__init__``
imports jax), so the parts the ported slices use are copied here
unchanged: :class:`OperatorConfig`, :class:`RetrievalConfig` and
:func:`resolve`. Resolution order: an explicitly passed kwarg wins over
the config field, which wins over the built-in default.
"""

import dataclasses

__all__ = ["OperatorConfig", "RetrievalConfig", "UNSET", "resolve"]


class _Unset:
    """Sentinel distinct from None, for kwargs where None is meaningful."""

    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self):
        return "UNSET"


UNSET = _Unset()


def resolve(config, name, explicit, default):
    """Explicit kwarg > config field > built-in default.

    ``None`` counts as "not passed" for most knobs; kwargs whose ``None``
    value is itself meaningful use the :data:`UNSET` sentinel as their
    function-signature default and are resolved explicitly here.
    """
    if explicit is not None and explicit is not UNSET:
        return explicit
    if explicit is None and default is UNSET:
        # None was passed explicitly for an UNSET-defaulted kwarg: honor it.
        return None
    if config is not None:
        return getattr(config, name)
    return None if default is UNSET else default


@dataclasses.dataclass(frozen=True)
class OperatorConfig:
    """vertical_forward_operator / ionogram_pallas knobs (ref :459-509)."""
    mode: str = "O"
    n_points: int = 200
    sharpness: float = 10.0          # stretched-grid exponent (ref :363)
    dh_backoff_km: float = 1e-6      # reflection backoff (ref :378)
    p_chunk: int = 512               # TPU point-axis chunk (accepted, unused)


@dataclasses.dataclass(frozen=True)
class RetrievalConfig:
    """minimize_parameters / retrieve_gradient knobs (ref :672-717)."""
    method: str = "brute"
    percent_sigma: float = 20.0
    step: float = 1.0
    mode: str = "O"
    n_points: int = 200
    bottom_type: str = "B_bot"
    lm_steps: int = 25
    crit_margin: float = 0.995
