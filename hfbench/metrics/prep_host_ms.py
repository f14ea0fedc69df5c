"""The host prep's host time a call: the summed ``pyrayhf.prep`` spans
(``prepare_kernel_args``, issuing the prep's device ops), averaged over
the traced calls (ms). Beside ``prep_device_ms`` it says whether the prep
is bound by the host or by the card."""

from ..spans import mean_ms


def read(s):
    return mean_ms(s, "prep")
