"""The program's own kernels' share of the operator's roofline (%): the
least time the card could take for the traced calls' work, counted as
``operator_roofline`` counts it, over the time in which the card ran the
program's own CUDA kernels (``PROGRAM_KERNELS``) inside those calls.

The host prep's device operations (the segment-table kernel among them)
are left out of the time, so this reads how near the kernel that does the
quadrature comes to the bound, where ``operator_roofline`` reads the
whole call's device work against it."""

from . import operator_roofline


def read(s):
    own = s["program_kernels"]
    return operator_roofline.read(dict(s, device=[
        d for d in s["device"] if any(k in d[2] for k in own)]))
