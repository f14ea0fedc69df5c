"""Device-to-host reads (host syncs) of the 2-D oblique ionogram a call:
the ``pyrayhf.host_read`` spans inside ``pyrayhf.oblique``, averaged over
the traced calls; 0 where the calls make none."""

from ..oblique_spans import mean_count_inside


def read(s):
    return mean_count_inside(s, "host_read")
