"""Run one cell of the benchmark and print its result line.

    python3 hfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cell's CUDA cards. The
last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
also ``breakdown``, and last ``checks``: each number compared with its
limit); the checks are also the last lines of standard error. Without
enough CUDA devices, or with JAX or the JAX package loaded, it exits with
another code than 0 and prints no result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
if sys.path and Path(sys.path[0] or ".").resolve() == HERE:
    sys.path[0] = str(HERE.parent)
else:
    sys.path.insert(0, str(HERE.parent))

from hfbench import guard, harness  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    guard.check("at the start")
    import torch
    cell = harness.load_cell(a.workload)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"hfbench: {a.workload} needs {cell.chips} CUDA device(s), "
              f"torch sees {have}", file=sys.stderr)
        return 2
    result = harness.run(cell, a.seed, a.seconds, bool(a.trace),
                         torch.device("cuda:0"), T0)
    guard.check("before the result")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
