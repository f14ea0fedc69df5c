"""The kernel launch's host time a call: the summed ``pyrayhf.launch``
spans (the checks, the launch layout, the library call), averaged over
the traced calls (ms)."""

from ..spans import mean_ms


def read(s):
    return mean_ms(s, "launch")
