"""Device operations a call runs besides the program's own CUDA kernels
(the host prep's torch kernels, copies and memsets), averaged over the
traced calls: an exact count where every call runs the same path."""

from ..timeline import per_call_device


def prep_ops(s):
    """[(call, [device events of the call that are not program kernels])]"""
    own = s["program_kernels"]
    return [(c, [d for d in dev if not any(k in d[2] for k in own)])
            for c, dev in per_call_device(s)]


def read(s):
    if not s["calls"] or not s["device"]:
        return None
    ops = prep_ops(s)
    return sum(len(d) for _, d in ops) / len(ops)
