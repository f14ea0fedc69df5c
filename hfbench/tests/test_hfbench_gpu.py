"""Each cell on the card, briefly, as the benchmark runs it (a process of
``hfbench/run.py`` each): a measured and a traced run, correct, with every
metric the cell names and shares of the roofline below 100%. Skips
without a CUDA device.

    python -m pytest hfbench/tests -q -m gpu
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())


def _run(w, seed, seconds, trace):
    r = subprocess.run([sys.executable, "hfbench/run.py", "--workload", w,
                        "--seed", str(seed), "--seconds", str(seconds),
                        "--trace", str(trace)], cwd=ROOT,
                       capture_output=True, text=True, timeout=360)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.splitlines()[-1])


@pytest.mark.gpu
@pytest.mark.parametrize("w", [w["name"] for w in MAN["workloads"]])
def test_cell_on_the_card(w):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    names = {kind: {m["name"] for m in MAN[kind]
                    if w in m.get("workloads", [w])}
             for kind in ("end_to_end", "per_layer")}
    r = _run(w, 2 ** 32 + 9, 2, 0)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == names["end_to_end"]
    r = _run(w, 2 ** 32 + 10, 4, 1)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == names["per_layer"]
    assert r["metrics"]["operator_roofline"]["value"] <= 100.0
    assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
