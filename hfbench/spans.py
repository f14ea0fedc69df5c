"""The program's own spans in a traced run's summary (``timeline``).

The program marks the layers of its vertical forward operator with
``record_function`` spans named ``pyrayhf.*`` (``forward``, ``route``,
``prep``, ``launch``, ``host_read``), which land in the summary's
``host`` events beside the harness's call spans. A span belongs to the
traced call whose interval holds its start. A trace without a
``pyrayhf.forward`` span inside a traced call (a program without the
spans) gives None.
"""

import bisect

from .timeline import covered

PREFIX = "pyrayhf."
FORWARD = PREFIX + "forward"


def per_call(s):
    """[[(start, end, name)] of the ``pyrayhf.*`` spans starting inside
    each traced call], or None when no call holds a ``pyrayhf.forward``."""
    ours = [h for h in s["host"] if h[2].startswith(PREFIX)]
    starts = [h[0] for h in ours]
    out = []
    for c in s["calls"]:
        i = bisect.bisect_left(starts, c[0])
        j = bisect.bisect_right(starts, c[1])
        out.append(ours[i:j])
    if not any(h[2] == FORWARD for spans in out for h in spans):
        return None
    return out


def mean_count(s, name):
    """Spans named ``pyrayhf.<name>`` a traced call, averaged (0 where a
    call has none)."""
    calls = per_call(s)
    if calls is None:
        return None
    return sum(sum(h[2] == PREFIX + name for h in c) for c in calls
               ) / len(calls)


def mean_ms(s, name):
    """Summed durations of the ``pyrayhf.<name>`` spans a traced call,
    averaged over the calls (ms)."""
    calls = per_call(s)
    if calls is None:
        return None
    return sum(t - b for c in calls for b, t, n in c if n == PREFIX + name
               ) / len(calls) * 1e-3


def self_ms(s, name):
    """The ``pyrayhf.<name>`` spans' time a traced call less the part the
    other ``pyrayhf.*`` spans inside them cover, averaged (ms)."""
    calls = per_call(s)
    if calls is None:
        return None
    tot = 0.0
    for c in calls:
        inner = [h for h in c if h[2] != PREFIX + name]
        for b, t, n in c:
            if n == PREFIX + name:
                tot += (t - b) - covered(inner, b, t)
    return tot / len(calls) * 1e-3
