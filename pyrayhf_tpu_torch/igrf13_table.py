"""IGRF-13 coefficient table: epoch 2020.0 main field + secular variation.

A copy of ``pyrayhf_tpu.igrf13_table`` (numpy only): the port keeps its
own so that it imports nothing of the JAX package.

13th-generation International Geomagnetic Reference Field (Alken et al.,
Earth Planets Space 2021), as published by IAGA Working Group V-MOD in
``igrf13coeffs.txt``. Vendored here because the environment has no network
and PyIRI (the reference's IGRF provider, ref ``library.py:2425-2432``) is
not installable.

* ``G2020`` / ``H2020``: main-field Gauss coefficients g_n^m / h_n^m at
  epoch 2020.0, degrees 1..13, Schmidt semi-normalised, in nT. Layout:
  ``G2020[n][m]`` (row n padded with zeros beyond m=n).
* ``GSV`` / ``HSV``: predictive secular variation 2020-2025 in nT/yr,
  degrees 1..8 (zero above, per the IGRF convention).

Validation (no-network): evaluated against the reference's shipped PyIRI
IGRF-13 output (the ``bmag``/``bpsi`` arrays of
``docs/tutorials/Example_Input_{Day,Night}.p``, epoch 2025.67 at two
locations x 620 altitudes) — see ``tests/test_igrf.py``.
"""

import numpy as np

NMAX = 13

# epoch 2020.0 main field [nT]; G2020[n][m]
G2020 = np.zeros((NMAX + 1, NMAX + 1))
H2020 = np.zeros((NMAX + 1, NMAX + 1))
GSV = np.zeros((NMAX + 1, NMAX + 1))
HSV = np.zeros((NMAX + 1, NMAX + 1))

# (n, m, g, h, g_sv, h_sv); h/h_sv are None for m == 0
_ROWS = [
    (1, 0, -29404.8, None, 5.7, None),
    (1, 1, -1450.9, 4652.5, 7.4, -25.9),
    (2, 0, -2499.6, None, -11.0, None),
    (2, 1, 2982.0, -2991.6, -7.0, -30.2),
    (2, 2, 1677.0, -734.6, -2.1, -22.4),
    (3, 0, 1363.2, None, 2.2, None),
    (3, 1, -2381.2, -82.1, -5.9, 6.0),
    (3, 2, 1236.2, 241.9, 3.1, -1.1),
    (3, 3, 525.7, -543.4, -12.0, 0.5),
    (4, 0, 903.0, None, -1.2, None),
    (4, 1, 809.5, 281.9, -1.6, -0.1),
    (4, 2, 86.3, -158.4, -5.9, 6.5),
    (4, 3, -309.4, 199.7, 5.2, 3.6),
    (4, 4, 48.0, -349.7, -5.1, -5.0),
    (5, 0, -234.3, None, -0.3, None),
    (5, 1, 363.2, 47.7, 0.5, 0.0),
    (5, 2, 187.8, 208.3, -0.6, 2.5),
    (5, 3, -140.7, -121.2, 0.2, -0.6),
    (5, 4, -151.2, 32.3, 1.3, 3.0),
    (5, 5, 13.5, 98.9, 0.9, 0.3),
    (6, 0, 66.0, None, -0.5, None),
    (6, 1, 65.5, -19.1, -0.3, 0.0),
    (6, 2, 72.9, 25.1, 0.4, -1.6),
    (6, 3, -121.5, 52.8, 1.3, -1.3),
    (6, 4, -36.2, -64.5, -1.4, 0.8),
    (6, 5, 13.5, 8.9, 0.0, 0.0),
    (6, 6, -64.7, 68.1, 0.9, 1.0),
    (7, 0, 80.6, None, -0.1, None),
    (7, 1, -76.7, -51.5, -0.2, 0.6),
    (7, 2, -8.2, -16.9, 0.0, 0.6),
    (7, 3, 56.5, 2.2, 0.7, -0.8),
    (7, 4, 15.8, 23.5, 0.1, -0.2),
    (7, 5, 6.4, -2.2, -0.5, -1.1),
    (7, 6, -7.2, -27.2, -0.8, 0.1),
    (7, 7, 9.8, -1.8, 0.8, 0.3),
    (8, 0, 23.7, None, 0.0, None),
    (8, 1, 9.7, 8.4, 0.1, -0.2),
    (8, 2, -17.6, -15.3, -0.1, 0.6),
    (8, 3, -0.5, 12.8, 0.4, -0.2),
    (8, 4, -21.1, -11.7, -0.1, 0.5),
    (8, 5, 15.3, 14.9, 0.4, -0.3),
    (8, 6, 13.7, 3.6, 0.3, -0.4),
    (8, 7, -16.5, -6.9, -0.1, 0.5),
    (8, 8, -0.3, 2.8, 0.4, 0.0),
    (9, 0, 5.0, None, 0.0, None),
    (9, 1, 8.4, -23.4, 0.0, 0.0),
    (9, 2, 2.9, 11.0, 0.0, 0.0),
    (9, 3, -1.5, 9.8, 0.0, 0.0),
    (9, 4, -1.1, -5.1, 0.0, 0.0),
    (9, 5, -13.2, -6.3, 0.0, 0.0),
    (9, 6, 1.1, 7.8, 0.0, 0.0),
    (9, 7, 8.8, 0.4, 0.0, 0.0),
    (9, 8, -9.3, -1.4, 0.0, 0.0),
    (9, 9, -11.9, 9.6, 0.0, 0.0),
    (10, 0, -1.9, None, 0.0, None),
    (10, 1, -6.2, 3.4, 0.0, 0.0),
    (10, 2, -0.1, -0.2, 0.0, 0.0),
    (10, 3, 1.7, 3.6, 0.0, 0.0),
    (10, 4, -0.9, 4.8, 0.0, 0.0),
    (10, 5, 0.7, -8.6, 0.0, 0.0),
    (10, 6, -0.9, -0.1, 0.0, 0.0),
    (10, 7, 1.9, -4.3, 0.0, 0.0),
    (10, 8, 1.4, -3.4, 0.0, 0.0),
    (10, 9, -2.4, -0.1, 0.0, 0.0),
    (10, 10, -3.8, -8.8, 0.0, 0.0),
    (11, 0, 3.0, None, 0.0, None),
    (11, 1, -1.4, 0.0, 0.0, 0.0),
    (11, 2, -2.5, 2.5, 0.0, 0.0),
    (11, 3, 2.3, -0.6, 0.0, 0.0),
    (11, 4, -0.9, -0.4, 0.0, 0.0),
    (11, 5, 0.3, 0.6, 0.0, 0.0),
    (11, 6, -0.7, -0.2, 0.0, 0.0),
    (11, 7, -0.1, -1.7, 0.0, 0.0),
    (11, 8, 1.4, -1.6, 0.0, 0.0),
    (11, 9, -0.6, -3.0, 0.0, 0.0),
    (11, 10, 0.2, -2.0, 0.0, 0.0),
    (11, 11, 3.1, -2.6, 0.0, 0.0),
    (12, 0, -2.0, None, 0.0, None),
    (12, 1, -0.1, -1.2, 0.0, 0.0),
    (12, 2, 0.5, 0.5, 0.0, 0.0),
    (12, 3, 1.3, 1.4, 0.0, 0.0),
    (12, 4, -1.2, -1.8, 0.0, 0.0),
    (12, 5, 0.7, 0.1, 0.0, 0.0),
    (12, 6, 0.3, 0.8, 0.0, 0.0),
    (12, 7, 0.5, -0.2, 0.0, 0.0),
    (12, 8, -0.3, 0.6, 0.0, 0.0),
    (12, 9, -0.5, 0.2, 0.0, 0.0),
    (12, 10, 0.1, -0.9, 0.0, 0.0),
    (12, 11, -1.1, 0.0, 0.0, 0.0),
    (12, 12, -0.3, 0.5, 0.0, 0.0),
    (13, 0, 0.1, None, 0.0, None),
    (13, 1, -0.9, -0.9, 0.0, 0.0),
    (13, 2, 0.5, 0.4, 0.0, 0.0),
    (13, 3, 0.7, 1.6, 0.0, 0.0),
    (13, 4, -0.3, -0.5, 0.0, 0.0),
    (13, 5, 0.8, -1.2, 0.0, 0.0),
    (13, 6, 0.0, -0.1, 0.0, 0.0),
    (13, 7, 0.8, 0.3, 0.0, 0.0),
    (13, 8, 0.0, -0.1, 0.0, 0.0),
    (13, 9, 0.4, 0.5, 0.0, 0.0),
    (13, 10, 0.1, 0.5, 0.0, 0.0),
    (13, 11, 0.5, -0.4, 0.0, 0.0),
    (13, 12, -0.5, -0.4, 0.0, 0.0),
    (13, 13, -0.4, -0.6, 0.0, 0.0),
]

for _n, _m, _g, _h, _gsv, _hsv in _ROWS:
    G2020[_n, _m] = _g
    GSV[_n, _m] = _gsv
    if _h is not None:
        H2020[_n, _m] = _h
        HSV[_n, _m] = _hsv


def coefficients_at_epoch(epoch):
    """Main-field {g, h} at a decimal-year ``epoch``.

    * ``epoch >= 2020.0``: the 2020.0 main field plus the IGRF-13
      predictive secular variation (nominally 2020-2025, commonly
      extended a few years until the next generation);
    * ``1900.0 <= epoch < 2020.0``: the vendored DGRF back-catalogue
      (:mod:`pyrayhf_tpu_torch.igrf_history` — tiered fidelity, see its
      docstring), piecewise-linear between 5-year epochs and continuous
      with the 2020.0 table;
    * earlier epochs raise (the IGRF itself starts at 1900).
    """
    epoch = float(epoch)
    if epoch < 2020.0:
        from .igrf_history import coefficients_at_epoch_historical
        return coefficients_at_epoch_historical(epoch)
    dt = epoch - 2020.0
    return {"g": G2020 + dt * GSV, "h": H2020 + dt * HSV}
