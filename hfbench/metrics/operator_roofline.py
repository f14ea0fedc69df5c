"""The operator's share of its roofline (%): the least time the card
could take for the traced calls' work, max(operations / peak rate,
bytes / peak bandwidth) summed over the calls, over the time in which
the card ran anything inside them.

The work is the operator's (the entry's ``work``), not a kernel's, so it
stays the same whichever engine serves the call and whatever moves
between the host prep and a kernel."""

from ..timeline import covered, per_call_device


def read(s):
    if not s["calls"] or not s["device"]:
        return None
    least = busy = 0.0
    for c, dev in per_call_device(s):
        ops, nbytes = s["work"][c[2]]
        least += max(ops / s["peak_ops_per_s"],
                     nbytes / s["peak_bytes_per_s"]) * 1e6
        busy += covered(dev)
    return 100.0 * least / busy if busy > 0 else None
