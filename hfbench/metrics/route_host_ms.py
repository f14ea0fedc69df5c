"""Routing's host time a call: the summed ``pyrayhf.route`` spans
(argument resolution, tensor conversion, the ``engine="auto"`` choice with
its read of the altitude grid), averaged over the traced calls (ms)."""

from ..spans import mean_ms


def read(s):
    return mean_ms(s, "route")
