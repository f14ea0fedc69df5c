"""Reduction of a ``torch.profiler`` Chrome trace to the run's summary.

The harness marks each traced call with a ``record_function`` span named
``CALL_SPAN#<pool entry>``. From the exported trace this module keeps:

* ``calls``: [(start, end, entry)] of those spans (host side), µs;
* ``device``: [(start, end, name, cat, launch)] of every kernel, copy and
  memset on the card, µs, with the host time of the runtime call that
  launched it (matched by the profiler's correlation id; its own start
  where none is found): the card's and the host's clocks are aligned
  only to within some µs, so events are given to calls by their launch;
* ``host``: [(start, end, name)] of host operations, runtime calls and
  spans, for naming what the host did while the card was idle;
* ``window``: (first call's start, last call's end).

The first ``skip`` calls of the trace are left out: the profiler's own
start-up lands in them.
"""

import bisect
import json

CALL_SPAN = "hfbench.call"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")


def read_chrome(path, skip=10):
    """The summary of the Chrome trace at ``path`` (see the module doc)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    calls, device, host, launch = [], [], [], {}
    for e in events:
        if e.get("ph") != "X":
            continue
        s = float(e["ts"])
        t = s + float(e.get("dur", 0.0))
        cat, name = e.get("cat", ""), e.get("name", "")
        corr = (e.get("args") or {}).get("correlation")
        if cat == "user_annotation" and name.startswith(CALL_SPAN + "#"):
            calls.append((s, t, int(name.split("#", 1)[1])))
        if cat in DEVICE_CATS:
            device.append((s, t, name, cat, corr))
        elif cat in HOST_CATS:
            host.append((s, t, name))
            if cat in ("cuda_runtime", "cuda_driver") and corr is not None:
                launch[corr] = s
    calls.sort()
    calls = calls[skip:]
    device = sorted((s, t, n, c, launch.get(k, s)) for s, t, n, c, k in device)
    host.sort()
    window = (calls[0][0], calls[-1][1]) if calls else None
    return {"calls": calls, "device": device, "host": host,
            "window": window}


def union(intervals, lo=None, hi=None):
    """Disjoint sorted [(start, end)] covering ``intervals`` clipped to
    [lo, hi]."""
    out = []
    for s, t, *_ in sorted(intervals):
        if lo is not None:
            s = max(s, lo)
        if hi is not None:
            t = min(t, hi)
        if t <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return [tuple(x) for x in out]


def covered(intervals, lo=None, hi=None):
    """µs of [lo, hi] (default: all) that ``intervals`` cover."""
    return sum(t - s for s, t in union(intervals, lo, hi))


def per_call_device(summary):
    """[(call, [device events launched inside it])] for each call."""
    dev = sorted(summary["device"], key=lambda d: d[4])
    launches = [d[4] for d in dev]
    out = []
    for c in summary["calls"]:
        i = bisect.bisect_left(launches, c[0])
        j = bisect.bisect_right(launches, c[1])
        out.append((c, dev[i:j]))
    return out


def traced_device(summary):
    """The device events launched inside the traced calls."""
    return [d for _, dev in per_call_device(summary) for d in dev]


def busy_us(summary):
    """µs in which the card ran what the traced calls launched."""
    return covered(traced_device(summary))


def short_name(name, width=120):
    """A kernel's name without its return type and parameter list."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::",
                                              "")
    depth = 0
    for k, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and k > 0 and name[k - 1] != " ":
            name = name[:k]
            break
    return name[:width]


def device_ops(summary, top=10):
    """[[name, seconds]] of the device operations that took most time in
    the window, most first."""
    tot = {}
    for s, t, name, *_ in traced_device(summary):
        k = short_name(name)
        tot[k] = tot.get(k, 0.0) + (t - s) * 1e-6
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])
            [:top]]


def _innermost(host, starts, at):
    """Name of the host event that started last among those covering
    ``at`` (nested events: the innermost), or None."""
    i = bisect.bisect_right(starts, at)
    for j in range(i - 1, max(-1, i - 400), -1):
        if host[j][1] >= at:
            return host[j][2]
    return None


def idle_gaps(summary, top=10):
    """[[what the host was doing, seconds]] over the gaps in which the
    card ran nothing, most first. A gap is named by the innermost host
    event running at its middle; "python" when none was."""
    lo, hi = summary["window"]
    busy = union(traced_device(summary), lo, hi)
    edges = [lo] + [x for b in busy for x in b] + [hi]
    host = summary["host"]
    starts = [h[0] for h in host]
    tot = {}
    for s, t in zip(edges[::2], edges[1::2]):
        if t <= s:
            continue
        k = _innermost(host, starts, 0.5 * (s + t)) or "python"
        if k.startswith(CALL_SPAN + "#"):
            k = CALL_SPAN
        tot[k] = tot.get(k, 0.0) + (t - s) * 1e-6
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])
            [:top]]
