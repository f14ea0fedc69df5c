"""The 2-D oblique ionogram's spans in a traced run's summary
(``timeline``).

The program marks the layers of ``synthesize_oblique_ionogram_2d`` with
``record_function`` spans named ``pyrayhf.*``: ``oblique`` (the whole
call), ``fan_fields``, ``fan_pack``, ``fan_launch``, ``homing``, and a
``host_read`` span for each device-to-host read. A span belongs to the
traced call whose interval holds its start; a device operation belongs to
a span whose interval holds its launch, as ``timeline.per_call_device``
gives operations to calls. A trace without a ``pyrayhf.oblique`` span
inside a traced call (a program without the spans) gives None.
"""

import bisect

from .timeline import per_call_device

PREFIX = "pyrayhf."
OBLIQUE = PREFIX + "oblique"


def per_call(s):
    """[[(start, end, name)] of the ``pyrayhf.*`` spans starting inside
    each traced call], or None when no call holds a ``pyrayhf.oblique``."""
    ours = [h for h in s["host"] if h[2].startswith(PREFIX)]
    starts = [h[0] for h in ours]
    out = []
    for c in s["calls"]:
        i = bisect.bisect_left(starts, c[0])
        j = bisect.bisect_right(starts, c[1])
        out.append(ours[i:j])
    if not any(h[2] == OBLIQUE for spans in out for h in spans):
        return None
    return out


def _inside(spans, t):
    return any(b <= t <= e for b, e, _ in spans)


def mean_count_inside(s, name):
    """``pyrayhf.<name>`` spans starting inside a ``pyrayhf.oblique`` span
    a traced call, averaged (0 where a call has none)."""
    calls = per_call(s)
    if calls is None:
        return None
    n = 0
    for c in calls:
        outer = [h for h in c if h[2] == OBLIQUE]
        n += sum(h[2] == PREFIX + name and _inside(outer, h[0]) for h in c)
    return n / len(calls)


def device_ms(s, name):
    """Summed device time of the operations launched inside the
    ``pyrayhf.<name>`` spans a traced call, averaged over the calls (ms);
    None without device events."""
    calls = per_call(s)
    if calls is None or not s["device"]:
        return None
    tot = 0.0
    for spans, (_, dev) in zip(calls, per_call_device(s)):
        mine = [h for h in spans if h[2] == PREFIX + name]
        tot += sum(t - b for b, t, *_, at in dev if _inside(mine, at))
    return tot / len(calls) * 1e-3
