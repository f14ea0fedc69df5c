"""Physical constants for magnetoionic virtual-height calculations.

Same values as ``pyrayhf_tpu.constants`` (PyRayHF ``library.py:40-72``), so
that every derived quantity is bit-comparable with the JAX package in
float64.
"""

# Plasma-frequency constant: f_p [Hz] = CP * sqrt(n_e [m^-3]).
CP = 8.97866275

# Electron gyrofrequency constant [Hz/T]: f_ce = G_P * B.
G_P = 2.799249247e10

# Mean Earth radius [km].
R_E = 6371.0

# Speed of light [km/s].
C_KM_S = 299_792.458


def constants():
    """Return (CP, G_P, R_E, C_KM_S) — API-compatible with the reference."""
    return CP, G_P, R_E, C_KM_S
