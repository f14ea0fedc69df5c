"""Device time of the fan kernel's tables a call: the operations launched
inside ``pyrayhf.fan_pack`` (the gradients of μ and the node-major
records), their summed durations averaged over the traced calls (ms)."""

from ..oblique_spans import device_ms


def read(s):
    return device_ms(s, "fan_pack")
