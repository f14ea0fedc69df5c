"""Timing, cost model, spans and device traces (port of
``pyrayhf_tpu.profiling``).

:func:`time_launch` times ``fn(*args)`` on the current CUDA stream: warm-up
launches first, then one pair of ``torch.cuda.Event`` records around each
timed launch, one synchronise at the end, and the median. It measures
device time between the events, so host work that delays the next launch
shows only when the device waits for it. There is no fallback: without a
card it raises.

:func:`operator_cost` is the JAX package's analytic flop/byte model of the
forward operator, and :func:`trace` captures a ``torch.profiler`` trace of
the card (and the host) into a TensorBoard directory.

:func:`span` marks a layer of a main path (the names in ``SPANS``) as a
``record_function`` event while a torch profiler records, so the spans
land in its trace beside the kernels and copies they launch, on the same
clock. The vertical forward operator's:

* ``pyrayhf.forward``: the whole of ``vertical_forward_operator_batch``;
* ``pyrayhf.route``: its routing, before the engine runs (argument
  resolution, tensor conversion, the ``engine="auto"`` choice);
* ``pyrayhf.prep``: ``pallas_vh.prepare_kernel_args``;
* ``pyrayhf.launch``: ``pallas_vh.launch_kernel``/``launch_mxu``;

the 2-D oblique ionogram's:

* ``pyrayhf.oblique``: the whole of
  ``oblique.synthesize_oblique_ionogram_2d``;
* ``pyrayhf.fan_fields``: ``oblique._fan_fields``, the broadcast
  Appleton–Hartree fields of every frequency;
* ``pyrayhf.fan_pack``: ``pallas_ray.pack_tables``;
* ``pyrayhf.fan_launch``: ``pallas_ray.launch_fan``, its checks to the
  library call (on CPU tensors the kernel's plain version in its
  place);
* ``pyrayhf.homing``: the low/high-ray crossings and the loss terms
  after them;

and both paths':

* ``pyrayhf.host_read``: one device-to-host read (a host sync) of
  ``_util.host_f64`` or ``_util.host_float``, one span per read.

With no profiler recording a span is one check and a shared no-op
context: no allocation, no op dispatch.
"""

import contextlib
import statistics
import tempfile

import torch

__all__ = ["time_launch", "vh_evals_per_s", "operator_cost", "trace",
           "span", "SPANS"]

SPANS = ("pyrayhf.forward", "pyrayhf.route", "pyrayhf.prep",
         "pyrayhf.launch", "pyrayhf.host_read", "pyrayhf.oblique",
         "pyrayhf.fan_fields", "pyrayhf.fan_pack", "pyrayhf.fan_launch",
         "pyrayhf.homing")
_NO_SPAN = contextlib.nullcontext()


def span(name):
    """A context marking ``name`` in the trace of a recording torch
    profiler (``torch.profiler.record_function``); otherwise a shared
    no-op context."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


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


def operator_cost(B, F, n_points, n_alt, flops_per_point=70):
    """Analytic cost model of the fused ionogram operator.

    Returns a dict with flops, sweep element-visits, and minimal device
    bytes — the roofline inputs for one [B, F, n_points] launch over
    [B, n_alt] profiles (the JAX package's formula, f32 tables).
    """
    points = B * F * n_points
    return {
        "ah_flops": points * flops_per_point,
        "sweep_visits": points * n_alt,
        "hbm_bytes_min": 4 * (B * n_alt * 8 + B * F * 2),
        "points": points,
    }


@contextlib.contextmanager
def trace(log_dir=None):
    """Capture a ``torch.profiler`` trace (CPU, and CUDA when there is a
    card) into ``log_dir`` (default: a new directory under the temporary
    directory for each capture), in TensorBoard's format. Yields
    ``log_dir``. The capture holds the ``pyrayhf.*`` spans (``SPANS``)
    of the calls made inside it.
    """
    if log_dir is None:
        log_dir = tempfile.mkdtemp(prefix="pyrayhf_trace-")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                log_dir)):
        yield log_dir
