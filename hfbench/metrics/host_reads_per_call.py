"""Device-to-host reads a call (host syncs): the ``pyrayhf.host_read``
spans, averaged over the traced calls; 0 where the calls make none."""

from ..spans import mean_count


def read(s):
    return mean_count(s, "host_read")
