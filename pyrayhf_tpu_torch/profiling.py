"""Timing on the card with CUDA events.

:func:`time_launch` times ``fn(*args)`` on the current CUDA stream: warm-up
launches first, then one pair of ``torch.cuda.Event`` records around each
timed launch, one synchronise at the end, and the median. It measures
device time between the events, so host work that delays the next launch
shows only when the device waits for it. There is no fallback: without a
card it raises.
"""

import statistics

import torch

__all__ = ["time_launch", "vh_evals_per_s"]


def time_launch(fn, *args, iters=10, warmup=3):
    """Median milliseconds of ``iters`` launches of ``fn(*args)``.

    Returns (median_ms, [ms per launch]).
    """
    if not torch.cuda.is_available():
        raise RuntimeError("time_launch needs a CUDA device")
    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    ms = [s.elapsed_time(e) for s, e in pairs]
    return statistics.median(ms), ms


def vh_evals_per_s(B, F, ms):
    """(frequency, profile) virtual-height evaluations per second."""
    return B * F / (ms * 1e-3)
