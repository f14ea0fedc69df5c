"""Device time of the 2-D fan's fields a call: the operations launched
inside ``pyrayhf.fan_fields`` (the broadcast Appleton–Hartree μ, μ′ and κ
of every frequency over the slice), their summed durations averaged over
the traced calls (ms)."""

from ..oblique_spans import device_ms


def read(s):
    return device_ms(s, "fan_fields")
