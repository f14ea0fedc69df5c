"""The import guard: no JAX and no JAX package in a benchmark process.

Module names are compared by their top-level name (the part before the
first dot), whole: ``pyrayhf_tpu_torch`` is the program and passes,
``pyrayhf_tpu`` is the JAX package and does not.
"""

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "pyrayhf_tpu")


def forbidden_loaded(modules=None):
    """Sorted top-level names in ``modules`` (default ``sys.modules``)
    that are forbidden."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names}
                  & set(FORBIDDEN))


def check(when):
    """Exit with code 3, naming what was found on standard error, if a
    forbidden module is loaded."""
    found = forbidden_loaded()
    if found:
        print(f"hfbench: forbidden modules loaded {when}: "
              f"{', '.join(found)}", file=sys.stderr, flush=True)
        raise SystemExit(3)
