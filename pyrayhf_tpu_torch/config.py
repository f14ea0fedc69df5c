"""Frozen configurations (a copy of ``pyrayhf_tpu.config``'s).

The port cannot import the JAX package's module (its package ``__init__``
imports jax), so the parts the ported slices use are copied here
unchanged: :class:`OperatorConfig`, :class:`SnellConfig`,
:class:`GradientTracerConfig`, :class:`RetrievalConfig` and
:func:`resolve`. Resolution order: an explicitly passed kwarg wins over
the config field, which wins over the built-in default.
"""

import dataclasses
from typing import Optional

__all__ = ["OperatorConfig", "SnellConfig", "GradientTracerConfig",
           "RetrievalConfig", "UNSET", "resolve"]


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
class SnellConfig:
    """Layered Snell tracer knobs (ref :1096, :1460-1473).

    ``dz_target_km``/``apex_boost``/``max_substeps`` mirror the reference's
    spherical-tracer signature; the implementation integrates the apex with
    an exact √-substitution, so they are accepted-but-unused there.
    """
    mode: str = "O"
    dz_target_km: float = 1.0
    apex_boost: float = 200.0
    max_substeps: int = 400
    R_E_km: float = 6371.0


@dataclasses.dataclass(frozen=True)
class GradientTracerConfig:
    """Ray-ODE tracer knobs (ref :1278-1291, :2135-2145).

    ``rtol``/``atol`` of None select fixed-step RK4; setting either turns
    on the error-controlled Dormand–Prince 5(4) integrator.
    """
    step_km: float = 1.0
    s_max_km: float = 5000.0
    z_ground_km: float = 0.0
    z_max_km: float = 1000.0
    x_min_km: float = -1e6
    x_max_km: float = 1e6
    rtol: Optional[float] = None
    atol: Optional[float] = None


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
