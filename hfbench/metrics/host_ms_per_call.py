"""Host time of a call: its wall time less the time in which the card ran
anything inside it, averaged over the traced calls (ms). It is what the
entry, the routing (with its host read of the altitude grid) and the
launches cost beyond the device's own work."""

from ..timeline import covered, per_call_device


def read(s):
    if not s["calls"] or not s["device"]:
        return None
    host = [(c[1] - c[0]) - covered(dev)
            for c, dev in per_call_device(s)]
    return sum(host) / len(host) * 1e-3
