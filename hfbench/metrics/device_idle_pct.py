"""Share of the traced window in which the card ran nothing (%)."""

from ..timeline import busy_us


def read(s):
    if not s["calls"] or not s["device"]:
        return None
    lo, hi = s["window"]
    return 100.0 * (1.0 - busy_us(s) / (hi - lo))
