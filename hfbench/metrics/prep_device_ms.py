"""Device time of the operations ``prep_kernels_per_call`` counts, per
traced call (ms, their summed durations)."""

from .prep_kernels_per_call import prep_ops


def read(s):
    if not s["calls"] or not s["device"]:
        return None
    ops = prep_ops(s)
    return sum(t - b for _, d in ops for b, t, *_ in d) / len(ops) * 1e-3
