"""The entry's own host time a call: the ``pyrayhf.forward`` span less
the part its inner ``pyrayhf.*`` spans cover (the engine's entry, the
autograd Function's dispatch), averaged over the traced calls (ms)."""

from ..spans import self_ms


def read(s):
    return self_ms(s, "forward")
